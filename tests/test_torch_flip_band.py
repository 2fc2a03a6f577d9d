"""The threshold band that judges a blend kernel's flipped pixels
(``compare_states`` with the plain walk's threshold-test rows, and
``chip_smoke.check_states``, which phase 9 uses on the hash step): a
flip whose plain T lies at its threshold passes, one far from it fails;
and the threshold-test rows of ``blend_tiles_plain(decisions=True)``
leave its state rows as they are."""
import sys
from pathlib import Path

import pytest
import torch

from d2dgs_torch.config import RasterConfig, T_CUTOFF
from d2dgs_torch.data.cameras import orbit_camera
from d2dgs_torch.data.synthetic import blend_test_scene
from d2dgs_torch.ops.binning import bin_gaussians
from d2dgs_torch.ops.cuda.blend import BAND_ULPS, ULP_CUTOFF, compare_states
from d2dgs_torch.ops.projection import preprocess, tile_grid
from d2dgs_torch.ops.tiled_raster import (DEC_MED, DEC_MED_AFTER, DEC_N_MED,
                                          DEC_TRIP, NDEC, NSTATE, PIX,
                                          ROW_DONE, ROW_MED_D, ROW_N_BLEND,
                                          ROW_N_EVAL, ROW_T,
                                          blend_tiles_plain, pack_features)

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_BLEND = 34.0           # the reference's blended pairs at the flip


def _flips(kind: str, at_threshold: bool, n: int = 1, tiles: int = 2):
    """Kernel and reference state rows [tiles, NSTATE, PIX] and the
    reference's threshold-test rows with ``n`` pixels flipped of ``kind``
    (trip: the kernel blended the pair the reference tripped on;
    trip_back: the reference blended the pair the kernel tripped on;
    median; done), the reference's T at the decision on its threshold or
    far from it."""
    ref = torch.zeros((tiles, NSTATE, PIX))
    ref[:, ROW_T] = 0.5
    dec = torch.full((tiles, NDEC, PIX), float("nan"))
    out = ref.clone()
    px = torch.arange(n)
    # far: outside the band; the reference that blended the extra pair
    # ends within 1e-5 of T_CUTOFF (relative) by the trip_moved rule, so
    # its far T is 9e-6 above (~124 ulps; its band is 2 x 35 ulps)
    far = {"trip": 0.5 * T_CUTOFF, "trip_back": T_CUTOFF * (1 + 9e-6),
           "median": 0.7}
    if kind in ("trip", "trip_back"):
        for s in (out, ref):
            s[0, ROW_DONE, px] = 1.0
            s[0, ROW_N_EVAL, px] = 129.0
        extra = 1.0 if kind == "trip" else -1.0
        ref[0, ROW_N_BLEND, px] = N_BLEND
        out[0, ROW_N_BLEND, px] = N_BLEND + extra
        # the side that blended the extra pair ends just above the cutoff
        more = out if kind == "trip" else ref
        more[0, ROW_T, px] = T_CUTOFF * (1 + 1e-6)
        (ref if kind == "trip" else out)[0, ROW_T, px] = 1.5e-4
        t_dec = T_CUTOFF if at_threshold else far[kind]
        if kind == "trip":
            dec[0, DEC_TRIP, px] = t_dec
        else:
            ref[0, ROW_T, px] = t_dec
    elif kind == "median":
        out[0, ROW_MED_D, px], ref[0, ROW_MED_D, px] = 1.5, 2.5
        dec[0, DEC_MED, px] = 0.5 if at_threshold else far[kind]
        dec[0, DEC_MED_AFTER, px] = 0.3
        dec[0, DEC_N_MED, px] = 3.0
    else:
        out[0, ROW_DONE, px] = 1.0
    return out, ref, dec


@pytest.mark.parametrize("kind", ["trip", "trip_back", "median"])
def test_band_passes_a_flip_at_its_threshold_not_one_far_from_it(kind):
    """A flip whose reference T lies on its threshold (T_CUTOFF, or 0.5
    for the median) is in the band; one whose T lies far from it is a
    flip of the same kind outside the band."""
    kinds = {"trip": "trip_moved", "trip_back": "trip_moved",
             "median": "median"}
    for at_threshold in (True, False):
        res = compare_states(*_flips(kind, at_threshold))
        assert res["flips"][kinds[kind]] == res["flipped"] == 1
        assert res["bad_outside_flips"] == 0
        assert (res["in_band"], res["outside_band"]) == (
            (1, 0) if at_threshold else (0, 1))
        assert (res["band_max_share"] <= 1.0) == at_threshold
    # the band's width: BAND_ULPS ulps per pair blended up to the trip
    out, ref, dec = _flips("trip", True)
    width = BAND_ULPS * (N_BLEND + 1.0) * ULP_CUTOFF
    for off, inside in ((0.9 * width, True), (1.1 * width, False)):
        dec[0, DEC_TRIP, 0] = T_CUTOFF - off
        assert compare_states(out, ref, dec)["in_band"] == int(inside)


def test_check_states_judges_flips_by_the_band():
    """chip_smoke.check_states with the threshold-test rows: flips at
    their thresholds pass at any count (here above MAX_FLIP_SHARE of the
    pixels, which fails without the rows); one flip far from its
    threshold fails, and so does one done flip."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    tiles = 80                 # the cap: 1e-4 of 20,480 pixels, 2 flips
    many = int(chip_smoke.MAX_FLIP_SHARE * tiles * PIX) + 1
    for kind in ("trip", "trip_back", "median"):
        out, ref, dec = _flips(kind, True, n=many, tiles=tiles)
        res = chip_smoke.check_states("test", kind, out, ref, 0, dec)
        assert res["in_band"] == res["flipped"] == many
        assert res["outside_band"] == 0
        with pytest.raises(AssertionError):
            chip_smoke.check_states("test", kind, out, ref, 0)
        out, ref, dec = _flips(kind, False, tiles=tiles)
        with pytest.raises(AssertionError):
            chip_smoke.check_states("test", kind, out, ref, 0, dec)
    out, ref, dec = _flips("done", True, tiles=tiles)
    with pytest.raises(AssertionError):
        chip_smoke.check_states("test", "done", out, ref, 0, dec)
    # without the rows one done flip stays under the count cap
    assert chip_smoke.check_states("test", "done", out, ref, 0)[
        "flipped"] == 1


@pytest.mark.parametrize("kind", ["pallas", "opaque", "packed"])
def test_threshold_rows_leave_the_state_rows_unchanged(kind):
    """blend_tiles_plain with ``decisions`` returns the same state rows
    bitwise, and threshold-test rows that fit them: T after the trip
    below the cutoff (and above 1% of the final T) exactly at the done
    pixels, T before the median pair above 0.5 and at most 1, the pairs
    up to the median at most the blended pairs."""
    cam = orbit_camera(0.4, 0.3, 3.0, fov=0.8, H=48, W=64, device="cpu")
    means, scales, quats, opac, colors = map(torch.as_tensor,
                                             blend_test_scene(kind))
    gx, gy = tile_grid(cam.H, cam.W)
    prep = preprocess(means, scales, quats, cam)
    op = torch.where(prep.valid, opac, 0.0)
    b = bin_gaussians(prep, gx, gy, RasterConfig(), opacity=op)
    fs = pack_features(prep.T, prep.center, prep.normal, colors,
                       op)[b.order.long()].contiguous()
    args = (fs, b.pair_rank, b.tile_start, b.tile_count, gx)
    rows, dec = blend_tiles_plain(*args, decisions=True)
    assert torch.equal(rows, blend_tiles_plain(*args))
    done = rows[:, ROW_DONE] == 1.0
    trip = dec[:, DEC_TRIP]
    assert torch.equal(~trip.isnan(), done)
    assert bool((trip[done] < T_CUTOFF).all())
    assert bool((trip[done] >= 0.01 * rows[:, ROW_T][done]).all())
    med = ~dec[:, DEC_MED].isnan()
    assert bool(med.any())
    assert bool(((dec[:, DEC_MED][med] > 0.5)
                 & (dec[:, DEC_MED][med] <= 1.0)).all())
    assert bool((dec[:, DEC_MED_AFTER][med] < dec[:, DEC_MED][med]).all())
    assert bool((dec[:, DEC_N_MED] <= rows[:, ROW_N_BLEND]).all())
    if kind != "pallas":
        assert bool(done.any())
