"""Where the blend forward kernel (K1) and its plain version part ways, over
many full-width views, on one NVIDIA GPU.

Both compose a pixel's transmittance T in another order (the kernel per
pair and per 64-pair unit, the plain version per 64-pair chunk), so T
differs by a few ulp, and a threshold decision taken where T lies within
those ulps of 1e-4 or 0.5 can go either way.  This script renders the
phase-3 scene of chip_smoke.py from ``--views`` seeded cameras, times and
opacity perturbations, holds the kernel's state rows against the plain
version's with ``compare_states`` (d2dgs_torch/ops/cuda/blend.py) and
counts every pixel that differs by its kind there:
  * ``done``: one terminated and the other did not;
  * ``median``: the median depth or weight differs (the T > 0.5 choice);
  * ``trip_moved``: both terminated, one pair apart, the side that
    blended the extra pair ending within 1e-5 of the cutoff (the T < 1e-4
    choice taken at the neighbouring pair);
  * ``other``: anything else outside the tolerances of compare_states:
    a fault, not a threshold.
For the first ``trip_moved`` and ``other`` pixels of each view it prints
both sides' T, done flag and counts.  Run from the repository root:

    python3 tools/blend_fwd_flips.py [--views 24]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KINDS = ("done", "median", "trip_moved", "other")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=24)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("blend_fwd_flips: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from d2dgs_torch.config import RasterConfig
    from d2dgs_torch.data.cameras import orbit_camera
    from d2dgs_torch.models.deform import deform_gaussians
    from d2dgs_torch.models.gaussians import apply_deform
    from d2dgs_torch.ops.cuda.blend import blend_fwd, compare_states
    from d2dgs_torch.ops.tiled_raster import (ROW_N_BLEND, ROW_N_EVAL,
                                              ROW_T, blend_tiles_plain)
    from d2dgs_torch.utils.sh import sh_to_rgb
    dev = torch.device("cuda")
    cfg = RasterConfig()
    gauss, nodes, deform_cfg = cs.full_scene(dev)
    opacity0 = gauss.opacity.clone()
    totals = {k: 0 for k in KINDS}
    pixels = 0
    with torch.no_grad():
        for v in range(args.views):
            gen = torch.Generator(device=dev).manual_seed(100 + v)
            gauss.opacity.copy_(opacity0 + torch.randn(
                opacity0.shape, generator=gen, device=dev))
            t = (v % 8) / 8.0
            cam = orbit_camera(0.3 + 0.25 * (v // 8), 0.25, 4.0, fov=0.69,
                               H=800, W=800, time=t, device=dev)
            d = deform_gaussians(nodes, deform_cfg, gauss, cam.time)
            means, scales, quats, opac, sh = apply_deform(
                gauss, d["d_xyz"], d["d_rotation"], d["d_scaling"])
            dirs = means - cam.cam_center[None, :]
            dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, -1,
                                               keepdim=True) + 1e-20)
            colors = sh_to_rgb(gauss.active_sh_degree, sh, dirs)
            fs, b, gx = cs.splat_inputs(means, scales, quats, opac, colors,
                                        gauss.alive, cam, cfg)
            kargs = (fs, b.pair_rank, b.tile_start, b.tile_count, gx)
            sk = blend_fwd(*kargs)
            sp = blend_tiles_plain(*kargs, chunk=cfg.chunk)
            kinds = compare_states(sk, sp)["masks"]
            counts = {k: int(m.sum()) for k, m in kinds.items()}
            pixels += sk.shape[0] * sk.shape[2]
            for k, c in counts.items():
                totals[k] += c
            print(f"view {v} (t={t}): pairs {int(b.num_pairs)}, "
                  + json.dumps(counts), flush=True)
            for k in ("trip_moved", "other"):
                for tile, pix in torch.nonzero(kinds[k]).tolist()[:5]:
                    row = lambda s: [float(s[tile, ROW_T, pix]),
                                     float(s[tile, 1, pix]),
                                     int(s[tile, ROW_N_EVAL, pix]),
                                     int(s[tile, ROW_N_BLEND, pix])]
                    print(f"  {k} tile {tile} pixel {pix}: kernel (T, done, "
                          f"evaluated, blended) {row(sk)}, plain {row(sp)}",
                          flush=True)
    print(json.dumps({"views": args.views, "pixels": pixels, **totals}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
