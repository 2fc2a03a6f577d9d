// The 3DGS (conic) tile blend of the optical-flow loss (Hopper, sm_90a):
// K5, `raster3d_fwd_launch`, the forward, and K6, `raster3d_bwd_launch`,
// its VJP.
//
// They replace the blend of `rasterize_3dgs` in d2dgs_tpu/ops/raster3d.py
// (lines 140-225: `chunk_step`, a nested `lax.scan` over 64-pair chunks
// and the pairs inside them, which XLA compiles into one program, and its
// backward, which XLA derives); the JAX package has no Pallas kernel
// here.  The original D-2DGS runs this blend as CUDA too (the bundled
// diff-gaussian-rasterization, `renderCUDA` / its backward).  The plain
// PyTorch version is `blend3d_plain` in d2dgs_torch/ops/raster3d.py, and
// the autograd VJP through it is K6's; `blend3d_segments_plain` and
// `blend3d_bwd_segments_plain` (d2dgs_torch/ops/cuda/raster3d.py) emulate
// this file's algorithm on the CPU.
//
// Inputs, per Gaussian in the original index space: conic [N, 3] (the
// inverse 2D covariance a, b, c), centre [N, 2] in pixels, colours
// [N, C], view depth [N], opacity [N] (0 for an invalid splat); the
// depth-ordered pair list `pair_gid` [B] (int32 Gaussian ids) with the
// tiles' `tile_start` / `tile_count` [T] (int32); `cap`, the most pairs a
// tile blends.  Outputs, per tile and pixel: T [T, 256], the colour sums
// [T, 256, C] and the depth sum [T, 256].  The caller adds `T * bg` and
// lays the tiles out as an image.
//
// What bounded the per-tile walk this replaces: one CTA walked each tile,
// so the busiest tile (3,966 pairs on an 800x800 flow view, against a
// median of a few hundred) outlasted the others while most SMs idled,
// and every pixel evaluated every pair up to its termination (36.9M
// evaluations for 2.74M blends).  A pixel's walk is serial only through
// its transmittance T, and T entering a pair is the product of (1 - alpha)
// over the earlier kept pairs, which needs no walk.  So, as K1
// (blend_fwd.cu) does:
//  * pass A (`r3d_pass_a`), one CTA per UNIT = 64 pairs of a tile: per
//    pixel, the product of (1 - alpha) over the unit's kept pairs (no
//    termination) and the kept pairs as bits.  A pixel refuses a pair
//    before expf when its power proves alpha < 1/255 (`cull_power`), and
//    a warp skips the pairs that outward-rounded interval arithmetic on
//    its 16x2 pixels proves refused at all 32 of them (`warp_refuses`).
//    Neither changes the kept set.  A warp stops once each of its pixels'
//    product is at or below T_CUTOFF (its words past the stop have every
//    bit set, so pass B evaluates every pair there);
//  * pass B (`r3d_pass_b`), one CTA per (tile, SEG = 256-pair segment):
//    each pixel starts from T_in, the ordered product of its tile's
//    earlier units' products, and walks only the kept pairs, with T
//    absolute, so its termination test reads the true T.  It computes the
//    alpha of the next LOOK kept pairs into registers first (they do not
//    depend on T), then composes them in order: T is the only serial
//    chain.  A pixel with T_in at or below the cutoff walks nothing;
//  * the fold: a tile of one segment (most tiles) writes its state
//    straight from pass B.  Otherwise each item stores its partial state
//    (NPART rows per pixel, in slots of multi-segment tiles only) and the
//    tile's last item to finish (an atomic ticket) adds the partial colour
//    and depth sums in segment order (pass B's T is absolute, so its sums
//    are too), takes T from the last segment folded, and stops at the
//    first segment that reports done (after a trip, rounding can leave the
//    next T_in just above the cutoff, so T_in alone is not trusted).  When
//    a walk ends alive but the next T_in lies at or below the cutoff
//    (rounding the other way), the fold walks that segment on for the
//    pixel from its running T, as the sequential walk would.
// T entering a segment is thus composed unit by unit and differs from one
// sequential walk's by a few ulp; a tile of one segment starts from 1 and
// keeps the plain walk's T bit for bit.  Only a pixel whose T lies within
// those ulps of 1e-4 can blend one pair more or less than the plain walk
// (the threshold band, `compare_blend3d` in ops/cuda/raster3d.py).
//
// K6 (`r3d_bwd`), one CTA per (tile, segment) work item of the same
// lists, as K2 (blend_bwd.cu) does.  The suffix sum that chains a
// pixel's backward walk has a closed form at a segment boundary e in the
// forward's checkpoint there and its final state:
//   R_e = gT T_f + g_c . (C_f - C_e) + g_d (D_f - D_e),
// so with K5's checkpoints at every SEG-th pair (training mode) each item
// takes its post-state T from the checkpoint at its segment's end (the
// final T for the tile's last segment) and walks back to the segment's
// start, rebuilding each pre-blend T by a division (factors >= 0.01, as
// the reference's backward does).  An item whose segment starts at or
// past the tile's walk length (its slowest pixel's last blended pair + 1)
// exits at once; pass A's per-warp cull applies (a refused pair has no
// gradient).  The 10 gradients of a pair are summed over the warp by a
// reduce-scatter (12 shuffles, after which 10 lanes each hold one sum and
// add it with one atomicAdd), skipped where no pixel of the warp blended
// the pair.  The outputs must be zeroed by the caller; atomics sum in an
// order that varies from run to run.
//
// Staging: K5 packs each view's features once into rows of NROW = 12
// floats (conic 3, centre 2, colour 3, depth, opacity, the cull power,
// pad; `r3d_pack_rows`), which K6 reads again in training mode, so that a
// pair's row is three 16-byte loads, which every CTA copies with
// cp.async into shared memory: pass B
// and K6 issue their segment's rows as NBATCH groups of BATCH pairs and
// walk a batch while the later ones are still in flight.  This blend has no
// matrix product, so wgmma and TMA tiles do not apply: a tile's pairs are
// a gather of rows through `pair_gid`, not a strided tile.
//
// What bounds it now: instruction issue in pass A (its interval tests and
// the evaluations they leave) and pass B's slowest 256-pair items; in K6
// the re-walk's per-pair arithmetic and atomics over ~1,000 items.  Bytes
// are small: the Gaussian rows, the pair list, the per-pixel rows and the
// passes' scratch (each unit's products and bits, the partial states, the
// checkpoints), written and read once.
//
// The work items (max(1, ceil(count / SEG)) per tile) and units
// (ceil(count / UNIT)) are listed on the card by a one-CTA layout kernel
// from min(tile_count, cap), so nothing is read back: the wrapper sizes
// the grids and the scratch from bounds it knows on the host (the pair
// count B), and CTAs past the real lists leave at once.  Training mode
// (`ckpt` not null) writes, at every SEG-th pair b of a tile, each pixel's
// T, colour sums and depth sum after pairs [0, b) into checkpoint
// item_start[t] - t + b / SEG - 1 of `ckpt` [B / SEG, NCK, PIX], and the
// pairs each pixel walked up to its last blended one (`n_walk`).  On
// request `work` [T, 2, PIX] receives each pixel's evaluated (up to and
// with its termination) and blended pair counts, as a sequential walk
// counts them whatever the culls skipped, and `stats` pass A's own
// pair-pixel evaluations and its (pair, warp) tests and refusals (K6: its
// tests and refusals); `unit_ns` / `item_ns` the %globaltimer stamps at
// the start and end of each unit and item.
//
// Built with -fmad=false (d2dgs_torch/ops/cuda/build.py), so every
// operation rounds as the plain version's PyTorch op does.  C: the
// kernels are built for C = 3 colour channels, the flow path's
// (d2dgs_torch/render/renderer.py: the uv flow and the motion mask); the
// launchers refuse any other C.

#include <cuda_runtime.h>

#include "work_layout.cuh"    // SEG, UNIT, Layout, fwd_layout, stamp

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;      // threads per CTA
constexpr int C3 = 3;                 // colour channels the kernels take
// a packed row: conic (a, b, c), centre (x, y), colour 3, depth, opacity,
// the cull power (cull_power), pad
constexpr int NROW = 12;
constexpr int R_CON = 0, R_CEN = 3, R_COL = 5, R_DEPTH = 8, R_OPAC = 9,
              R_CUT = 10;
// pass A's rows per work item, [item, NCAND, PIX]: each unit's product of
// (1 - alpha), then SEG / 32 words of kept-pair bits
constexpr int NCAND = UNITS + SEG / 32;
constexpr int BATCH = 64;             // pairs per cp.async group
constexpr int NBATCH = SEG / BATCH;
constexpr int LOOK = 4;               // kept pairs pass B evaluates ahead
// an item's partial state, rows of [slot, NPART, PIX]: T at the walk's end
// or trip, the colour and depth sums, flags (int: n_eval | n_blend << 9 |
// done << 18 | pre << 19), last blended pair + 1 (int, segment-local)
constexpr int NPART = 7;
constexpr int P_FLAGS = 5, P_LAST = 6;
constexpr int NCK = 5;                // checkpoint rows: T, colour 3, depth
// gradients of a pair: conic 3, centre 2, colour 3, depth, opacity
constexpr int NG = 10;
constexpr float ALPHA_CLIP = 0.99f;
constexpr float ALPHA_CUTOFF = 1.0f / 255.0f;
constexpr float T_CUTOFF = 1e-4f;
// the cull's margin in the power (the log of alpha): far above the
// rounding it covers (cull_power)
constexpr float CULL_MARGIN = 1e-3f;
// the launchers' code for a colour count they are not built for
constexpr int ERR_CHANNELS = -1;

// 16 bytes from device memory into shared memory, asynchronously
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` of this thread's cp.async groups are in
// flight (0 <= pending < NBATCH).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// The power below which a pair of opacity `op` is refused: op exp(power)
// >= 1/255 needs power >= -ln(255 op).  The margin CULL_MARGIN covers the
// rounding of logf, of 255 op, of expf (2 ulp), of op * E and of the
// float 1/255 (together below 1e-5 for any opacity) by far, so a pixel
// whose computed power lies below this alpha is refused by pair_alpha's
// own test too.  +inf for op = 0 (refused everywhere), NaN for a negative
// or NaN op (never culled).
__device__ __forceinline__ float cull_power(float op) {
  return -logf(255.0f * op) - CULL_MARGIN;
}

// One CTA per 256 Gaussians: each view's rows, packed once for every CTA
// of the launch to copy by 16-byte loads.
__global__ void __launch_bounds__(PIX)
    r3d_pack_rows(const float* __restrict__ conic,
              const float* __restrict__ center,
              const float* __restrict__ colors,
              const float* __restrict__ depth,
              const float* __restrict__ opac, int n,
              float* __restrict__ rows) {
  const int i = blockIdx.x * PIX + threadIdx.x;
  if (i >= n) return;
  const size_t g = (size_t)i;
  float4* out = reinterpret_cast<float4*>(rows + g * NROW);
  out[0] = make_float4(conic[g * 3], conic[g * 3 + 1], conic[g * 3 + 2],
                       center[g * 2]);
  out[1] = make_float4(center[g * 2 + 1], colors[g * C3],
                       colors[g * C3 + 1], colors[g * C3 + 2]);
  out[2] = make_float4(depth[g], opac[g], cull_power(opac[g]), 0.0f);
}

// A staged row into registers, by 16-byte loads (the compiler drops the
// loads of fields the caller does not read).
__device__ __forceinline__ void load_row(const float* s, float (&f)[NROW]) {
  const float4* v = reinterpret_cast<const float4*>(s);
#pragma unroll
  for (int i = 0; i < NROW / 4; ++i) {
    const float4 x = v[i];
    f[4 * i] = x.x;
    f[4 * i + 1] = x.y;
    f[4 * i + 2] = x.z;
    f[4 * i + 3] = x.w;
  }
}

// The pair's alpha at the pixel sample (px, py), with the intermediates
// the VJP reads.
// Parity trap (samples at pixel corners): px, py are the integer pixel
// coordinates, as the plain version's `_tile_pixels(...) - 0.5`
// (3DGS measures from pixel corners); the surfel blend samples centres.
// Parity trap (alpha): min(ALPHA_CLIP, op * exp(power)), zeroed where
// power > 0 or alpha < ALPHA_CUTOFF; the power is composed in the plain
// version's order (ops/raster3d.py `_blend_chunk`: -0.5 * (a dx^2 +
// c dy^2) - (b dx) dy), and exp is expf, not __expf, as torch.exp.
// The cull (power below f[R_CUT]) refuses only pairs whose alpha is below
// the cutoff, so the kept set and the values of kept pairs do not change.
__device__ __forceinline__ float pair_alpha(const float* f, float px,
                                            float py, float& dx, float& dy,
                                            float& E, float& raw) {
  dx = px - f[R_CEN];
  dy = py - f[R_CEN + 1];
  const float power = -0.5f * (f[R_CON] * (dx * dx)
                               + f[R_CON + 2] * (dy * dy))
                      - (f[R_CON + 1] * dx) * dy;
  E = 0.0f;
  raw = 0.0f;
  if (power < f[R_CUT]) return 0.0f;
  E = expf(power);
  raw = f[R_OPAC] * E;
  const float a = fminf(raw, ALPHA_CLIP);
  return (power <= 0.0f && a >= ALPHA_CUTOFF) ? a : 0.0f;
}

// Outward-rounded bounds of fl(s x) for x in [lo, hi]: the least value,
// and the largest.
__device__ __forceinline__ float mul_lo(float s, float lo, float hi) {
  return s >= 0.0f ? __fmul_rd(s, lo) : __fmul_rd(s, hi);
}

__device__ __forceinline__ float mul_hi(float s, float lo, float hi) {
  return s >= 0.0f ? __fmul_ru(s, hi) : __fmul_ru(s, lo);
}

// The least value of fl(x x) for x in [lo, hi], and the largest.
__device__ __forceinline__ float sq_lo(float lo, float hi) {
  const float m = fminf(fabsf(lo), fabsf(hi));
  return lo <= 0.0f && hi >= 0.0f ? 0.0f : __fmul_rd(m, m);
}

__device__ __forceinline__ float sq_hi(float lo, float hi) {
  const float m = fmaxf(fabsf(lo), fabsf(hi));
  return __fmul_ru(m, m);
}

// Whether pair_alpha refuses staged pair f by its cull at every pixel
// px in [x0, x0 + 15], py in [y0, y0 + 1] (a warp's two pixel rows): the
// power it computes there lies below an upper bound that this function
// takes by outward rounding, operation by operation in the same order,
// and that bound lies below the pair's cull power.  A non-finite input or
// bound refuses nothing.
__device__ bool warp_refuses(const float* f, float x0, float y0) {
  const float a = f[R_CON], b = f[R_CON + 1], c = f[R_CON + 2];
  const float cx = f[R_CEN], cy = f[R_CEN + 1];
  if (!(isfinite(a) && isfinite(b) && isfinite(c) && isfinite(cx)
        && isfinite(cy)))
    return false;
  const float dx_lo = __fsub_rd(x0, cx), dx_hi = __fsub_ru(x0 + 15.0f, cx);
  const float dy_lo = __fsub_rd(y0, cy), dy_hi = __fsub_ru(y0 + 1.0f, cy);
  // the least a (dx dx) + c (dy dy), so the largest -0.5 times it
  const float q_lo =
      __fadd_rd(mul_lo(a, sq_lo(dx_lo, dx_hi), sq_hi(dx_lo, dx_hi)),
                mul_lo(c, sq_lo(dy_lo, dy_hi), sq_hi(dy_lo, dy_hi)));
  const float p1_hi = __fmul_ru(-0.5f, q_lo);
  // the least (b dx) dy: a corner of the box of b dx and dy
  const float bx_lo = mul_lo(b, dx_lo, dx_hi);
  const float bx_hi = mul_hi(b, dx_lo, dx_hi);
  const float p2_lo = fminf(
      fminf(__fmul_rd(bx_lo, dy_lo), __fmul_rd(bx_lo, dy_hi)),
      fminf(__fmul_rd(bx_hi, dy_lo), __fmul_rd(bx_hi, dy_hi)));
  const float power_hi = __fsub_ru(p1_hi, p2_lo);
  return isfinite(power_hi) && power_hi < f[R_CUT];
}

// The place of tile t's pixels: px = x0 + tid % TILE, py = y0 + tid / TILE.
__device__ __forceinline__ float tile_x0(int tile, int grid_x) {
  return (float)((tile % grid_x) * TILE);
}

__device__ __forceinline__ float tile_y0(int tile, int grid_x) {
  return (float)((tile / grid_x) * TILE);
}

// Pass A, one CTA per UNIT pairs of a tile: per pixel, the product of
// (1 - alpha) over the unit's kept pairs, and the kept pairs as bits (pass
// B evaluates only those), into the rows of its segment's work item.  The
// CTA first marks, per warp (two rows of the tile) and pair, whether
// warp_refuses proves the pair refused at all of the warp's pixels; each
// warp evaluates only the other pairs.  A warp stops once each of its
// pixels' product is at or below T_CUTOFF (the pixel's T is too, whatever
// it enters with); its words past the stop have every bit set, so pass B
// evaluates every pair there.  `stats` (optional): pair-pixel evaluations,
// (pair, warp) tests, refusals.
__global__ void __launch_bounds__(PIX)
    r3d_pass_a(const float* __restrict__ rows,
               const int* __restrict__ pair_gid,
               const int* __restrict__ tile_start,
               const int* __restrict__ tile_count, int cap, int grid_x,
               Layout lay, float* __restrict__ cand,
               unsigned long long* __restrict__ stats,
               long long* __restrict__ unit_ns, int n_timed) {
  __shared__ __align__(16) float s_rows[UNIT * NROW];
  __shared__ unsigned s_eval[PIX / 32][UNIT / 32];   // [warp][word]: pairs
  const int unit = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  long long t_start = 0;
  if (unit_ns != nullptr && tid == 0) t_start = global_ns();
  if (unit >= *lay.unit_total()) return;
  const int tile = lay.units()[2 * unit];
  const int k = lay.units()[2 * unit + 1];
  const int nb = min(UNIT, min(tile_count[tile], cap) - k * UNIT);
  const int start = tile_start[tile] + k * UNIT;
  if (tid < 3 * nb) {
    const int r = tid / 3;
    const int q = tid - 3 * r;
    cp_async16(s_rows + r * NROW + 4 * q,
               rows + (size_t)pair_gid[start + r] * NROW + 4 * q);
  }
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();
  const float x0 = tile_x0(tile, grid_x);
  const float y0 = tile_y0(tile, grid_x);
  const float px = x0 + (float)(tid % TILE);
  const float py = y0 + (float)(tid / TILE);
  // the pairs each warp evaluates: thread tid tests pair tid % UNIT for
  // the warps (tid / UNIT) + 4 i
  unsigned long long tested = 0, refused = 0;
  for (int w = tid / UNIT; w < PIX / 32; w += PIX / UNIT) {
    const int j = tid % UNIT;
    const bool in = j < nb;
    const unsigned ev = __ballot_sync(
        FULL_MASK, in && !warp_refuses(s_rows + j * NROW, x0,
                                       y0 + (float)(2 * w)));
    const unsigned all = __ballot_sync(FULL_MASK, in);
    if (lane == 0) {
      s_eval[w][j / 32] = ev;
      tested += __popc(all);
      refused += __popc(all & ~ev);
    }
  }
  __syncthreads();
  float* out = cand + (size_t)(lay.item_start()[tile] + k / UNITS) * NCAND
      * PIX + tid;
  float prod = 1.0f;
  int walked = 0;
  for (int h = 0; h * 32 < nb; ++h) {
    unsigned bits = FULL_MASK;
    if (__any_sync(FULL_MASK, prod > T_CUTOFF)) {   // warp-uniform
      bits = 0u;
      unsigned ev = s_eval[warp][h];
      walked += __popc(ev);
      while (ev != 0u) {
        const int b = __ffs(ev) - 1;
        ev &= ev - 1u;
        float f[NROW], dx, dy, E, raw;
        load_row(s_rows + (h * 32 + b) * NROW, f);
        const float a = pair_alpha(f, px, py, dx, dy, E, raw);
        if (a > 0.0f) {
          prod *= 1.0f - a;
          bits |= 1u << b;
        }
      }
    }
    out[(UNITS + (k % UNITS) * (UNIT / 32) + h) * PIX] = __uint_as_float(bits);
  }
  out[(k % UNITS) * PIX] = prod;
  if (stats != nullptr && lane == 0) {
    atomicAdd(stats, (unsigned long long)walked * 32);
    atomicAdd(stats + 1, tested);
    atomicAdd(stats + 2, refused);
  }
  stamp(unit_ns, unit, n_timed, t_start, tid);
}

// Pass B: each item walks its segment's kept pairs from T_in; a tile of
// one item writes its state, the last item of a multi-segment tile folds
// the partials.
__global__ void __launch_bounds__(PIX)
    r3d_pass_b(const float* __restrict__ rows,
               const int* __restrict__ pair_gid,
               const int* __restrict__ tile_start,
               const int* __restrict__ tile_count, int cap, int grid_x,
               Layout lay, const float* __restrict__ cand,
               float* __restrict__ part, float* __restrict__ T_out,
               float* __restrict__ C_out, float* __restrict__ D_out,
               int* __restrict__ n_walk, float* __restrict__ ckpt,
               int* __restrict__ work, long long* __restrict__ item_ns,
               int n_timed) {
  __shared__ __align__(16) float s_rows[SEG * NROW];
  __shared__ unsigned s_mask[SEG / 32 * PIX];
  __shared__ int s_fold;
  const int item = blockIdx.x;
  const int tid = threadIdx.x;
  long long t_start = 0;
  if (item_ns != nullptr && tid == 0) t_start = global_ns();
  if (item >= lay.total()) return;
  const int tile = lay.items()[2 * item];
  const int seg = lay.items()[2 * item + 1];
  const int count = min(tile_count[tile], cap);
  const int n_seg = segments_of(count);
  const int start = tile_start[tile];
  const int p0 = seg * SEG;
  const int nb = max(0, min(SEG, count - p0));
  const float px = tile_x0(tile, grid_x) + (float)(tid % TILE);
  const float py = tile_y0(tile, grid_x) + (float)(tid / TILE);

  // T entering the segment: the ordered product of the earlier units'
  const float* cand0 = cand + (size_t)(item - seg) * NCAND * PIX + tid;
  float T = 1.0f;
  for (int q = 0; q < seg * UNITS; ++q)
    T *= cand0[((q / UNITS) * NCAND + q % UNITS) * PIX];
  const float T_in = T;
  // terminated in an earlier segment (the walk tests T > T_CUTOFF)
  const bool pre = !(T_in > T_CUTOFF);
  bool done = false;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, D = 0.0f;
  int n_eval = 0, n_blend = 0, last = -1, trip = -1;

  if (nb > 0 && __syncthreads_or(!pre)) {   // CTA-uniform
    const int n_words = (nb + 31) / 32;
    const float* mask = cand + ((size_t)item * NCAND + UNITS) * PIX;
    for (int k = tid; k < n_words * PIX; k += PIX)
      s_mask[k] = __float_as_uint(mask[k]);
    // the segment's rows, BATCH pairs to a cp.async group
    for (int b = 0; b < NBATCH; ++b) {
      const int r = b * BATCH + tid / 3;
      if (tid < 3 * BATCH && r < nb) {
        const int q = tid % 3;
        cp_async16(s_rows + r * NROW + 4 * q,
                   rows + (size_t)pair_gid[start + p0 + r] * NROW + 4 * q);
      }
      cp_async_commit();
    }
    unsigned bits = 0u;
    int word = 0;
    for (int b = 0; b < NBATCH && b * BATCH < nb; ++b) {   // CTA-uniform
      cp_async_wait(NBATCH - 1 - b);
      __syncthreads();
      const int w_end = min(2 * b + 2, n_words);
      while (!pre && !done) {
        // the next LOOK kept pairs of the batch and their alphas, which do
        // not depend on T
        int js[LOOK];
        float al[LOOK];
#pragma unroll
        for (int i = 0; i < LOOK; ++i) {
          while (bits == 0u && word < w_end) bits = s_mask[PIX * word++ + tid];
          js[i] = -1;
          al[i] = 0.0f;
          if (bits != 0u) {
            js[i] = (word - 1) * 32 + __ffs(bits) - 1;
            bits &= bits - 1u;
            float f[NROW], dx, dy, E, raw;
            load_row(s_rows + js[i] * NROW, f);
            al[i] = pair_alpha(f, px, py, dx, dy, E, raw);
          }
        }
        // then composed in order: T is the only serial chain
        // Parity trap (termination): the JAX walk tests T > T_CUTOFF
        // *before* a pair and then blends it (d2dgs_tpu/ops/raster3d.py:
        // 203-210: live = T_c > T_CUTOFF; w = a T_c; T *= 1 - a), so the
        // pair that takes T to the cutoff or below is blended.  The
        // reference's renderCUDA tests T (1 - a) < 1e-4 and stops before
        // blending it; the port follows the JAX package.
#pragma unroll
        for (int i = 0; i < LOOK; ++i) {
          if (js[i] >= 0 && !done && al[i] > 0.0f) {
            const float* f = s_rows + js[i] * NROW;
            const float w = al[i] * T;
            c0 = c0 + w * f[R_COL];
            c1 = c1 + w * f[R_COL + 1];
            c2 = c2 + w * f[R_COL + 2];
            D = D + w * f[R_DEPTH];
            T = T * (1.0f - al[i]);
            last = js[i];
            ++n_blend;
            if (!(T > T_CUTOFF)) {
              done = true;
              trip = js[i];
            }
          }
        }
        if (js[LOOK - 1] < 0) break;
      }
    }
    // evaluated: up to and with the trip, else the whole segment
    n_eval = pre ? 0 : done ? trip + 1 : nb;
  }

  const size_t p = (size_t)tile * PIX + tid;
  if (n_seg == 1) {                  // the tile's only item: final state
    T_out[p] = T;
    C_out[p * C3] = c0;
    C_out[p * C3 + 1] = c1;
    C_out[p * C3 + 2] = c2;
    D_out[p] = D;
    if (n_walk != nullptr) n_walk[p] = last + 1;
    if (work != nullptr) {
      work[(size_t)tile * 2 * PIX + tid] = n_eval;
      work[(size_t)tile * 2 * PIX + PIX + tid] = n_blend;
    }
    stamp(item_ns, item, n_timed, t_start, tid);
    return;
  }

  const int slot0 = lay.slot_start()[tile];
  float* mine = part + (size_t)(slot0 + seg) * NPART * PIX + tid;
  const float prow[NPART] = {
      T, c0, c1, c2, D,
      __int_as_float(n_eval | n_blend << 9 | (int)done << 18
                     | (int)pre << 19),
      __int_as_float(last + 1)};
#pragma unroll
  for (int r = 0; r < NPART; ++r) mine[r * PIX] = prow[r];
  __threadfence();
  __syncthreads();
  if (tid == 0) s_fold = atomicAdd(lay.arrivals() + tile, 1) == n_seg - 1;
  __syncthreads();
  if (!s_fold) {                     // CTA-uniform
    stamp(item_ns, item, n_timed, t_start, tid);
    return;
  }
  __threadfence();

  // the fold, in segment order, by the tile's last item to finish
  float rT = 1.0f, r0 = 0.0f, r1 = 0.0f, r2 = 0.0f, rD = 0.0f;
  bool rdone = false;
  int rn_eval = 0, rn_blend = 0, rlast = -1;
  const int ck0 = lay.item_start()[tile] - tile;   // the tile's checkpoints
  for (int q = 0; q < n_seg; ++q) {
    if (!rdone) {
      const float* pq = part + (size_t)(slot0 + q) * NPART * PIX + tid;
      const int flags = __float_as_int(__ldcg(pq + P_FLAGS * PIX));
      if (flags >> 19 & 1) {
        // entered at or below the cutoff although the walk before it
        // ended alive (rT > T_CUTOFF): walk on from rT, as the sequential
        // walk would (its first blended pair takes T below the cutoff)
        const int q_nb = min(SEG, count - q * SEG);
        int j = 0;
        for (; j < q_nb && rT > T_CUTOFF; ++j) {
          const float* f =
              rows + (size_t)pair_gid[start + q * SEG + j] * NROW;
          float dx, dy, E, raw;
          const float a = pair_alpha(f, px, py, dx, dy, E, raw);
          if (a > 0.0f) {
            const float w = a * rT;
            r0 = r0 + w * f[R_COL];
            r1 = r1 + w * f[R_COL + 1];
            r2 = r2 + w * f[R_COL + 2];
            rD = rD + w * f[R_DEPTH];
            rT = rT * (1.0f - a);
            rlast = q * SEG + j;
            ++rn_blend;
          }
        }
        rn_eval += j;
        rdone = !(rT > T_CUTOFF);
      } else {
        r0 += __ldcg(pq + 1 * PIX);
        r1 += __ldcg(pq + 2 * PIX);
        r2 += __ldcg(pq + 3 * PIX);
        rD += __ldcg(pq + 4 * PIX);
        rT = __ldcg(pq);
        rdone = flags >> 18 & 1;
        rn_eval += flags & 511;
        rn_blend += flags >> 9 & 511;
        const int l = __float_as_int(__ldcg(pq + P_LAST * PIX));
        if (l > 0) rlast = q * SEG + l - 1;
      }
    }
    if (ckpt != nullptr && q < n_seg - 1) {
      // the accumulators after pairs [0, (q+1) SEG): K6's post-state for
      // the segment that ends there
      float* ck = ckpt + (size_t)(ck0 + q) * NCK * PIX + tid;
      ck[0] = rT;
      ck[PIX] = r0;
      ck[2 * PIX] = r1;
      ck[3 * PIX] = r2;
      ck[4 * PIX] = rD;
    }
  }
  T_out[p] = rT;
  C_out[p * C3] = r0;
  C_out[p * C3 + 1] = r1;
  C_out[p * C3 + 2] = r2;
  D_out[p] = rD;
  if (n_walk != nullptr) n_walk[p] = rlast + 1;
  if (work != nullptr) {
    work[(size_t)tile * 2 * PIX + tid] = rn_eval;
    work[(size_t)tile * 2 * PIX + PIX + tid] = rn_blend;
  }
  stamp(item_ns, item, n_timed, t_start, tid);
}

// One step of the warp's reduce-scatter: of the K values v[0..K) (the
// same gradients in every lane), the lane whose ``hi`` bit is set keeps
// the upper H (zero past K) and its partner o lanes away the lower H,
// each adding the partner's share.
template <int K, int H>
__device__ __forceinline__ void halve(float (&v)[NG], bool hi, int o) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo_v = v[i];
    const float hi_v = i + H < K ? v[i + H] : 0.0f;
    const float keep = hi ? hi_v : lo_v;
    v[i] = keep + __shfl_xor_sync(FULL_MASK, hi ? lo_v : hi_v, o);
  }
}

// Sums the NG gradients of every lane over the warp in 12 shuffles (not
// the 50 of one butterfly per gradient): afterwards v[0] of lane l holds
// the warp sum of gradient warp_grad(l), and 10 lanes add theirs to the
// output at once.
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[NG],
                                                    int lane) {
  halve<10, 5>(v, lane & 16, 16);
  halve<5, 3>(v, lane & 8, 8);
  halve<3, 2>(v, lane & 4, 4);
  halve<2, 1>(v, lane & 2, 2);
  v[0] += __shfl_xor_sync(FULL_MASK, v[0], 1);
}

// The gradient whose sum even lane l holds after warp_reduce_scatter, or
// -1 (odd lanes, which hold the same sums, and the lanes of padding).
__device__ __forceinline__ int warp_grad(int lane) {
  const int p4 = (lane >> 1) & 1;                 // of 2
  const int p3 = 2 * ((lane >> 2) & 1) + p4;      // of 3
  const int p2 = 3 * ((lane >> 3) & 1) + p3;      // of 5
  const int p1 = 5 * ((lane >> 4) & 1) + p2;      // of 10
  return (lane & 1) == 0 && p3 < 3 && p2 < 5 ? p1 : -1;
}

// K6: one CTA per work item (tile, segment) of K5's lists.
__global__ void __launch_bounds__(PIX)
    r3d_bwd(const float* __restrict__ rows,
               const int* __restrict__ pair_gid,
               const int* __restrict__ tile_start, int grid_x, Layout lay,
               const float* __restrict__ ckpt,
               const float* __restrict__ T_fin,
               const float* __restrict__ C_fin,
               const float* __restrict__ D_fin,
               const int* __restrict__ n_walk,
               const float* __restrict__ gT, const float* __restrict__ gC,
               const float* __restrict__ gD, float* __restrict__ d_conic,
               float* __restrict__ d_center, float* __restrict__ d_colors,
               float* __restrict__ d_depth, float* __restrict__ d_opac,
               unsigned long long* __restrict__ stats,
               long long* __restrict__ item_ns, int n_timed) {
  __shared__ __align__(16) float s_rows[SEG * NROW];
  __shared__ int s_gid[SEG];
  __shared__ unsigned s_eval[PIX / 32][SEG / 32];   // [warp][word]: pairs
  __shared__ int s_walk;
  const int item = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  long long t_start = 0;
  if (item_ns != nullptr && tid == 0) t_start = global_ns();
  if (item >= lay.total()) return;
  const int tile = lay.items()[2 * item];
  const int seg = lay.items()[2 * item + 1];
  const size_t p = (size_t)tile * PIX + tid;
  const int n = n_walk[p];
  if (tid == 0) s_walk = 0;
  __syncthreads();
  if (n > 0) atomicMax(&s_walk, n);
  __syncthreads();
  const int tile_walk = s_walk;    // pairs up to the slowest pixel's last
  const int s0 = seg * SEG;        // the segment: pairs [s0, s1)
  if (s0 < tile_walk) {            // CTA-uniform
    const int s1 = min(s0 + SEG, tile_walk);
    const int nb = s1 - s0;
    if (tid < nb) s_gid[tid] = pair_gid[tile_start[tile] + s0 + tid];
    __syncthreads();
    for (int b = 0; b < NBATCH; ++b) {
      const int r = b * BATCH + tid / 3;
      if (tid < 3 * BATCH && r < nb) {
        const int q = tid % 3;
        cp_async16(s_rows + r * NROW + 4 * q,
                   rows + (size_t)s_gid[r] * NROW + 4 * q);
      }
      cp_async_commit();
    }
    // meanwhile the post-state and the suffix sum: R_i, the sum over the
    // blended pairs j > i of w_j g_j plus the final T's term gT T_n, whose
    // value at the segment's end has a closed form in the checkpoint
    // there; the adjoint of alpha_i is T_i g_i - R_i / (1 - alpha_i)
    float T = T_fin[p];
    const float g0 = gC[p * C3], g1 = gC[p * C3 + 1], g2 = gC[p * C3 + 2];
    const float g_dep = gD[p];
    float Rsum = gT[p] * T;
    if (s1 < tile_walk) {          // CTA-uniform: a checkpoint ends it
      const float* ck = ckpt + (size_t)(lay.item_start()[tile] - tile + seg)
          * NCK * PIX + tid;
      Rsum = Rsum + (g0 * (C_fin[p * C3] - ck[PIX])
                     + g1 * (C_fin[p * C3 + 1] - ck[2 * PIX])
                     + g2 * (C_fin[p * C3 + 2] - ck[3 * PIX])
                     + g_dep * (D_fin[p] - ck[4 * PIX]));
      T = ck[0];
    }
    const float px = tile_x0(tile, grid_x) + (float)(tid % TILE);
    const float py = tile_y0(tile, grid_x) + (float)(tid / TILE);
    cp_async_wait(0);
    __syncthreads();
    // the per-warp cull of pass A: thread tid tests pair tid for every warp
    unsigned long long tested = 0, refused = 0;
    for (int w = 0; w < PIX / 32; ++w) {
      const bool in = tid < nb;
      const unsigned ev = __ballot_sync(
          FULL_MASK, in && !warp_refuses(s_rows + tid * NROW,
                                         tile_x0(tile, grid_x),
                                         tile_y0(tile, grid_x)
                                         + (float)(2 * w)));
      const unsigned all = __ballot_sync(FULL_MASK, in);
      if (lane == 0) {
        s_eval[w][warp] = ev;
        tested += __popc(all);
        refused += __popc(all & ~ev);
      }
    }
    __syncthreads();
    // each lane's gradient after the reduce-scatter, and where it goes
    const int gi = warp_grad(lane);
    float* dst = gi < 0 ? nullptr : gi < 3 ? d_conic + gi : gi < 5
        ? d_center + (gi - 3) : gi < 8 ? d_colors + (gi - 5) : gi == 8
        ? d_depth : d_opac;
    const int stride = gi < 3 ? 3 : gi < 5 ? 2 : gi < 8 ? C3 : 1;
    // pairs the warp's furthest pixel walked (warp-uniform)
    const int hi = min(nb, __reduce_max_sync(FULL_MASK, n) - s0);
    for (int h = (hi - 1) >> 5; hi > 0 && h >= 0; --h) {
      unsigned ev = s_eval[warp][h];
      const int top = hi - 32 * h;
      if (top < 32) ev &= (1u << top) - 1u;
      while (ev != 0u) {              // back to front, warp-uniform
        const int b = 31 - __clz(ev);
        ev &= ~(1u << b);
        const int j = h * 32 + b;
        float g[NG];
#pragma unroll
        for (int k = 0; k < NG; ++k) g[k] = 0.0f;
        bool mine = false;
        if (s0 + j < n) {
          float f[NROW], dx, dy, E, raw;
          load_row(s_rows + j * NROW, f);
          const float a = pair_alpha(f, px, py, dx, dy, E, raw);
          if (a > 0.0f) {
            mine = true;
            const float om = 1.0f - a;
            const float Ti = T / om;         // T before this pair
            const float w = a * Ti;
            const float gw = g0 * f[R_COL] + g1 * f[R_COL + 1]
                + g2 * f[R_COL + 2] + g_dep * f[R_DEPTH];   // d loss / d w
            g[5] = w * g0;
            g[6] = w * g1;
            g[7] = w * g2;
            g[8] = w * g_dep;
            const float ga = Ti * gw - Rsum / om;
            Rsum = Rsum + w * gw;
            T = Ti;
            // Parity trap (gradients through the clip and the cut): the
            // clip's gradient is zero where it clips (torch's clamp_max
            // passes it where raw <= ALPHA_CLIP), and a pair below the
            // cutoff (a == 0) has none
            const float graw = raw <= ALPHA_CLIP ? ga : 0.0f;
            g[9] = graw * E;
            const float gp = graw * f[R_OPAC] * E;   // d loss / d power
            g[0] = -0.5f * gp * (dx * dx);
            g[1] = -gp * dx * dy;
            g[2] = -0.5f * gp * (dy * dy);
            // d = pixel - centre: the centre takes minus d power / d d
            g[3] = gp * (f[R_CON] * dx + f[R_CON + 1] * dy);
            g[4] = gp * (f[R_CON + 2] * dy + f[R_CON + 1] * dx);
          }
        }
        if (__ballot_sync(FULL_MASK, mine) != 0u) {
          warp_reduce_scatter(g, lane);
          if (dst != nullptr)
            atomicAdd(dst + (size_t)s_gid[j] * stride, g[0]);
        }
      }
    }
    if (stats != nullptr && lane == 0) {
      atomicAdd(stats, tested);
      atomicAdd(stats + 1, refused);
    }
  }
  stamp(item_ns, item, n_timed, t_start, tid);
}

int pack(const float* conic, const float* center, const float* colors,
         const float* depth, const float* opac, int n_gauss, float* rows,
         cudaStream_t stream) {
  if (n_gauss <= 0) return 0;
  r3d_pack_rows<<<(n_gauss + PIX - 1) / PIX, PIX, 0, stream>>>(
      conic, center, colors, depth, opac, n_gauss, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int raster3d_fwd_launch(
    const float* conic, const float* center, const float* colors,
    const float* depth, const float* opac, const int* pair_gid,
    const int* tile_start, const int* tile_count, int num_tiles, int grid_x,
    int cap, int channels, int n_gauss, int max_items, int max_units,
    float* rows, int* layout, float* cand, float* part, float* T_out,
    float* C_out, float* D_out, int* n_walk, float* ckpt, int* work,
    unsigned long long* stats, long long* unit_ns, int n_units_timed,
    long long* item_ns, int n_items_timed, void* stream) {
  if (channels != C3) return ERR_CHANNELS;
  if (num_tiles <= 0 || max_items <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  int err = pack(conic, center, colors, depth, opac, n_gauss, rows, s);
  if (err != 0) return err;
  const Layout lay{layout, num_tiles, max_items};
  // Parity trap (tile_cap): `cap` is floor(tile_cap / chunk) * chunk (at
  // least one chunk), the pairs the JAX scan walks of a tile (`walk_cap`
  // in ops/cuda/raster3d.py), not tile_count itself
  fwd_layout<<<1, LAYOUT_THREADS, 0, s>>>(tile_count, cap, num_tiles,
                                          max_units, lay);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (max_units > 0) {
    r3d_pass_a<<<max_units, PIX, 0, s>>>(rows, pair_gid, tile_start,
                                         tile_count, cap, grid_x, lay, cand,
                                         stats, unit_ns, n_units_timed);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  r3d_pass_b<<<max_items, PIX, 0, s>>>(
      rows, pair_gid, tile_start, tile_count, cap, grid_x, lay, cand, part,
      T_out, C_out, D_out, n_walk, ckpt, work, item_ns, n_items_timed);
  return (int)cudaGetLastError();
}

// `rows` and `layout` are the ones K5 wrote for the same inputs in
// training mode.
extern "C" int raster3d_bwd_launch(
    const float* rows, const int* pair_gid, const int* tile_start,
    int num_tiles, int grid_x, int channels, int max_items, int* layout,
    const float* ckpt, const float* T_fin, const float* C_fin,
    const float* D_fin, const int* n_walk, const float* gT, const float* gC,
    const float* gD, float* d_conic, float* d_center, float* d_colors,
    float* d_depth, float* d_opac, unsigned long long* stats,
    long long* item_ns, int n_items_timed, void* stream) {
  if (channels != C3) return ERR_CHANNELS;
  if (num_tiles <= 0 || max_items <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  r3d_bwd<<<max_items, PIX, 0, s>>>(
      rows, pair_gid, tile_start, grid_x, Layout{layout, num_tiles,
                                                 max_items},
      ckpt, T_fin, C_fin, D_fin, n_walk, gT, gC, gD, d_conic, d_center,
      d_colors, d_depth, d_opac, stats, item_ns, n_items_timed);
  return (int)cudaGetLastError();
}

extern "C" const char* raster3d_error_string(int code) {
  if (code == ERR_CHANNELS)
    return "raster3d kernels are built for C = 3 colour channels only";
  return cudaGetErrorString((cudaError_t)code);
}
