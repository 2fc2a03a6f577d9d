// Forward surfel blend over depth-sorted per-tile pair lists (Hopper, sm_90a).
//
// Two entry points share one set of kernel templates over where a tile's
// rows come from (the row policy):
//  * K1, `blend_fwd_launch`, replaces the TPU kernel `_fwd_wq_kernel` of
//    d2dgs_tpu/ops/pallas/blend_tpu.py (with its launcher `_fwd_wq_call` and
//    the work queue `build_work_queue` that fed it): tile t's i-th pair is
//    the sorted feature row `feats[pair_rank[tile_start[t] + i]]`
//    (`RankedRows`); the plain PyTorch version is `blend_tiles_plain` in
//    d2dgs_torch/ops/tiled_raster.py.  An optional `gtile` [T] (null: the
//    identity) gives each output slot's place in the image grid, as the
//    TPU kernel's `gtile_ref` does, for a slab of tiles taken from a
//    larger grid (the sharded render, d2dgs_torch/parallel/gauss_shard.py);
//    only the pixel coordinates read it;
//  * K3, `blend_dense_fwd_launch`, replaces `_fwd_kernel` (launcher
//    `_fwd_call`, the dense (tile, chunk) grid fed by `build_gdata`): tile
//    t's i-th pair is row `gdata[t, i]` of the dense [T, tile_cap, 18]
//    buffer (`DenseRows`), contiguous, with no rank indirection; the plain
//    PyTorch version is `blend_dense_plain` in
//    d2dgs_torch/ops/cuda/blend_dense.py.
// Both compute the same per-tile state rows as the TPU kernels'
// `_chunk_step`, with the same arithmetic, so the two routes make the same
// alpha, near-plane and cutoff decisions bit for bit.
//
// What bounded the per-tile walk this replaces: its slowest tile.  The
// tiles are very unequal (on an 800x800 view 2,034 of 2,500 hold no pair
// and the busiest ~2,900), and one CTA walked each tile, so the launch
// lasted as long as one CTA: 679 of a 684 us launch on a tile of 1,524
// pairs (PERF.md).  A pixel's walk is serial only through its
// transmittance T, and T entering a pair is the product of (1 - alpha)
// over the earlier kept pairs, which needs no walk.  So:
//  * pass A (`fwd_pass_a`), one CTA per UNIT = 64 pairs of a tile: per
//    pixel, the product of (1 - alpha) over the unit's kept pairs (no
//    termination) and the kept pairs as bits.  A pixel refuses a pair
//    before the division and the exp where both rho2d and rho3d exceed
//    the radius at which its alpha falls below 1/255 (cull_radius, with a
//    margin far above the rounding), and a warp skips the pairs that
//    outward-rounded interval arithmetic proves refused at all of its 32
//    pixels (warp_refuses: two thirds of the (pair, warp) combinations on
//    an 800x800 view).  Neither changes the kept set.  A warp stops once
//    each of its pixels' product is below T_CUTOFF;
//  * pass B (`fwd_pass_b`), one CTA per (tile, SEG = 256-pair segment):
//    each pixel starts from T_in, the ordered product of the tile's
//    earlier units' products, and walks only the pairs pass A kept, with
//    the sequential arithmetic below, T absolute (so the termination, the
//    median test T > 0.5 and the distortion's m^2 (1 - T) read the true
//    T) and dist1/dist2 local.  A pixel with T_in < T_CUTOFF terminated
//    in an earlier segment: it walks nothing;
//  * the fold: a tile of one segment (most tiles) writes its state
//    straight from pass B.  Otherwise each item stores its partial state
//    (NPART rows per pixel, in slots of multi-segment tiles only) and the
//    tile's last item to finish (an atomic ticket) folds them in segment
//    order: the sums add, the distortion gains dist2_pre * sum(w) -
//    2 dist1_pre * sum(w m) (exact in real arithmetic), T and done come
//    from the last segment folded, the median and the last blended pair
//    from the last segment that has one, and the fold stops at the first
//    segment that reports done (after a trip, rounding can leave the next
//    T_in just above the cutoff, so T_in alone is not trusted).  When a
//    walk ends alive but the next T_in lies below the cutoff (rounding the
//    other way), the fold re-evaluates that segment's pairs for the pixel
//    up to its first kept pair, which trips it, as the sequential walk
//    would.
// T entering a segment is thus composed unit by unit, as the reference
// composes it chunk by chunk (`_chunk_step`'s in-chunk cumulative product
// scaled by the carried T); it differs from one sequential walk's by a
// few ulp.  Only a termination or a median choice of a pixel whose T lies
// within those ulps of 1e-4 or 0.5 can differ from the plain version.
//
// What bounds it now: instruction issue in pass A (its interval tests and
// the evaluations they leave, ~33M pair-pixel evaluations on the view
// above against the 47M a sequential walk makes before its terminations,
// ~90M without the tests) and pass B's slowest 256-pair items (pass B
// evaluates only kept pairs).  Bytes are small: the feature rows, the pair
// ranks (K1), the 16 state rows, and the passes' scratch (each unit's
// products and bits, the partial states), written and read once.
//
// Per CTA of either pass, as the per-tile walk did per tile: one thread
// per pixel with its accumulators in registers; the pairs' feature rows
// staged in shared memory by the whole CTA (each row read from device
// memory once per CTA, not once per pixel) in rows of SROW floats read by
// 16-byte loads.  The work items (max(1, ceil(count / SEG)) per tile) and
// units (ceil(count / UNIT)) are listed on the card by a one-CTA layout
// kernel from the counts, so serving reads nothing back: the wrapper sizes
// the grids and the scratch from bounds it knows on the host (the pair
// count, or a training layout), and CTAs past the real lists leave at once.
//
// Built with -fmad=false: the ray-splat response then rounds every
// operation exactly as the plain version's PyTorch ops do, so both make the
// same alpha-cutoff, near-plane and low-pass decisions.  With contraction
// on, the cancellation in the cross products moved alpha across the 1/255
// cutoff at ~0.1% of the pixels of an 800x800 view.
//
// Rules kept from `_chunk_step`: alpha clipped at 0.99, pairs below alpha
// 1/255 or in front of the near plane 0.2 skipped; the Gaussian whose blend
// would push T below 1e-4 is dropped and the pixel is done; the median depth
// is the last blended Gaussian whose pre-blend T is above 0.5; the
// distortion uses the mapped depth m and the running dist1/dist2 sums.
//
// Rows 14 and 15 count the pairs each pixel evaluated (up to and with its
// termination) and blended, as a sequential walk counts them; they size
// the operation count of the kernel's bound.  Pass A's evaluations are
// extra work, counted apart (optional ``n_pass_a``).
//
// Training mode (``records`` not null, the kTrain instance): per pixel, the
// position in the tile's pair list of the last blended pair and of the
// median pair (-1 when there is none), [T, NREC, PIX] int32, and at every
// SEG-th pair b = 256, 512, ... of the tile, the NCKPT running
// accumulators after pairs [0, b) (the fold's state, the walk's own T)
// into checkpoint ckpt_off[t] + b/256 - 1 of ``ckpt`` [n_bound, NCKPT,
// PIX] (the wrapper sizes it and the offsets from the counts).  The
// backward kernels (blend_bwd.cu) start each 256-pair segment's walk from
// them.  Serving passes null and compiles to the instance that writes
// nothing extra.  Optional ``unit_ns`` [U, 2] and ``item_ns`` [I, 2]
// receive the %globaltimer stamps at the start and end of pass A's units
// and of pass B's work items.

#include <climits>

#include <cuda_runtime.h>

#include "work_layout.cuh"    // SEG, UNIT, Layout, fwd_layout, stamp

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;   // threads per CTA
constexpr int NFEAT = 18;          // Tmat(9) center(2) normal(3) color(3) opacity(1)
constexpr int SROW = 20;           // a staged row: NFEAT floats, 16-byte aligned
constexpr int R_CULL = NFEAT;      // pass A's rows: the pair's cull radius
constexpr int NSTATE = 16;
constexpr int NREC = 2;            // training records: last, median
// training checkpoints: T, dist1, dist2, colour(3), depth, normal(3),
// distortion (state rows 0 and 2-11) at every SEG-th pair
constexpr int NCKPT = 11;
// pass A's rows per work item, [item, NCAND, PIX]: each unit's product of
// (1 - alpha), then SEG / 32 words of candidate-pair bits
constexpr int NCAND = UNITS + SEG / 32;

// An item's partial state, rows of [slot, NPART, PIX]: rows 2-13 are the
// segment's own (local) state rows 2-13 (dist1, dist2, colour, depth,
// normal, distortion, median depth and weight).
constexpr int P_T = 0;       // T at the walk's end or trip
constexpr int P_SUM_W = 1;   // the segment's blended weight, T_in - T
constexpr int P_FLAGS = 14;  // int: n_eval | n_blend << 9 | done << 18 | pre << 19
constexpr int P_POS = 15;    // int: (last + 1) | (med + 1) << 16, segment-local
constexpr int NPART = 16;

constexpr float FILTER_INV_SQUARE = 2.0f;
constexpr float ALPHA_CLIP = 0.99f;
constexpr float ALPHA_CUTOFF = 1.0f / 255.0f;
constexpr float T_CUTOFF = 1e-4f;
constexpr float NEAR_PLANE = 0.2f;
constexpr float FAR_PLANE = 100.0f;
constexpr float FAR_X_NEAR = 20.0f;        // FAR_PLANE * NEAR_PLANE
constexpr float FAR_MINUS_NEAR = 99.8f;    // FAR_PLANE - NEAR_PLANE

// The place in the image grid of output slot `tile`: the slot itself, or
// gtile[tile] where a launch blends a slab of tiles taken from a larger
// grid (the sharded render's interleaved tiles, the TPU kernel's
// `gtile_ref`).  Only the pixel coordinates read it.
__device__ __forceinline__ int grid_tile(const int* gtile, int tile) {
  return gtile != nullptr ? gtile[tile] : tile;
}

// Row policies: `base(t)` once per tile, then `row(base, i)` is the index
// in `feats` of the tile's i-th pair in depth order; `count(t)` its pairs.
struct RankedRows {            // K1: sorted features through pair ranks
  const int* pair_rank;    // [B]
  const int* tile_start;   // [T]
  const int* tile_count;   // [T], clamped at tile_cap
  __device__ int base(int t) const { return tile_start[t]; }
  __device__ int count(int t) const { return tile_count[t]; }
  __device__ int row(int b, int i) const { return pair_rank[b + i]; }
};

struct DenseRows {             // K3: the tile's own slab [tile_cap, NFEAT]
  const int* counts;       // [T] = min(tile_count, tile_cap)
  int cap;                 // tile_cap
  __device__ int base(int t) const { return t * cap; }
  __device__ int count(int t) const { return counts[t]; }
  __device__ int row(int b, int i) const { return b + i; }
};

// The response of pair f at pixel (px, py) (_resp, forward.cu:336-402):
// its alpha and depth, and whether it is kept (p_z != 0, not in front of
// the near plane, alpha at least 1/255).  With kCull, f[R_CULL] holds the
// pair's cull radius (cull_radius) and a pixel whose rho2d and rho3d
// both exceed it is refused before the division and the exp: its alpha
// would be below 1/255.  The values of a kept pair do not change.
template <bool kCull = false>
__device__ __forceinline__ bool pair_alpha(const float* f, float px,
                                           float py, float& alpha,
                                           float& depth) {
  const float kx = px * f[6] - f[0];
  const float ky = px * f[7] - f[1];
  const float kz = px * f[8] - f[2];
  const float lx = py * f[6] - f[3];
  const float ly = py * f[7] - f[4];
  const float lz = py * f[8] - f[5];
  const float p_x = ky * lz - kz * ly;
  const float p_y = kz * lx - kx * lz;
  const float p_z = kx * ly - ky * lx;
  if (p_z == 0.0f) return false;
  const float dx = f[9] - px;
  const float dy = f[10] - py;
  const float rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy);
  // rho3d = (p_x^2 + p_y^2) / p_z^2 up to a few ulp: the 1e-4 margin
  // covers them
  if (kCull && rho2d > f[R_CULL]
      && p_x * p_x + p_y * p_y > f[R_CULL] * 1.0001f * (p_z * p_z))
    return false;
  const float inv_pz = 1.0f / p_z;
  const float sx = p_x * inv_pz;
  const float sy = p_y * inv_pz;
  const float rho3d = sx * sx + sy * sy;
  const bool use3d = rho3d <= rho2d;
  depth = use3d ? sx * f[6] + sy * f[7] + f[8] : f[8];
  alpha = fminf(ALPHA_CLIP, f[17] * expf(-0.5f * fminf(rho3d, rho2d)));
  return depth >= NEAR_PLANE && alpha >= ALPHA_CUTOFF;
}

// A bound on rho = min(rho3d, rho2d) for a kept pair of opacity o:
// o exp(-rho / 2) >= 1/255 needs rho <= 2 ln(255 o); the 1e-3 margin
// covers the rounding of expf and of this logf by far (negative or -inf
// when o < 1/255: never kept).
__device__ __forceinline__ float cull_radius(float opacity) {
  return 2.0f * logf(255.0f * opacity) + 1e-3f;
}

// An interval [lo, hi] of float values, and outward-rounded operations on
// intervals: each result holds every value the round-to-nearest operation
// gives on members of its operands.
struct Iv {
  float lo, hi;
};

// fl(fl(a c) - d) for a in [a0, a1]
__device__ __forceinline__ Iv iv_affine(float a0, float a1, float c,
                                        float d) {
  const float m0 = c >= 0.f ? __fmul_rd(a0, c) : __fmul_rd(a1, c);
  const float m1 = c >= 0.f ? __fmul_ru(a1, c) : __fmul_ru(a0, c);
  return {__fsub_rd(m0, d), __fsub_ru(m1, d)};
}

__device__ __forceinline__ Iv iv_mul(Iv a, Iv b) {
  return {fminf(fminf(__fmul_rd(a.lo, b.lo), __fmul_rd(a.lo, b.hi)),
                fminf(__fmul_rd(a.hi, b.lo), __fmul_rd(a.hi, b.hi))),
          fmaxf(fmaxf(__fmul_ru(a.lo, b.lo), __fmul_ru(a.lo, b.hi)),
                fmaxf(__fmul_ru(a.hi, b.lo), __fmul_ru(a.hi, b.hi)))};
}

__device__ __forceinline__ Iv iv_sub(Iv a, Iv b) {
  return {__fsub_rd(a.lo, b.hi), __fsub_ru(a.hi, b.lo)};
}

__device__ __forceinline__ Iv iv_sq(Iv a) {
  const float m = fminf(fabsf(a.lo), fabsf(a.hi));
  const float big = fmaxf(fabsf(a.lo), fabsf(a.hi));
  return {a.lo <= 0.f && a.hi >= 0.f ? 0.f : __fmul_rd(m, m),
          __fmul_ru(big, big)};
}

__device__ __forceinline__ bool iv_finite(Iv a) {
  return isfinite(a.lo) && isfinite(a.hi);
}

// Whether pair_alpha<true> refuses staged pair f at every pixel px in
// [x0, x0 + 15], py in [y0, y0 + 1] (pixel centres): the values it
// computes there lie in intervals that this function encloses by
// outward rounding, operation by operation in the same order, and the
// refusal holds at both ends of every interval.  Non-finite enclosures
// refuse nothing (fminf and fmaxf would drop a NaN).
__device__ bool warp_refuses(const float* f, float x0, float y0) {
  const float x1 = x0 + 15.0f;
  const float y1 = y0 + 1.0f;
  const Iv kx = iv_affine(x0, x1, f[6], f[0]);
  const Iv ky = iv_affine(x0, x1, f[7], f[1]);
  const Iv kz = iv_affine(x0, x1, f[8], f[2]);
  const Iv lx = iv_affine(y0, y1, f[6], f[3]);
  const Iv ly = iv_affine(y0, y1, f[7], f[4]);
  const Iv lz = iv_affine(y0, y1, f[8], f[5]);
  if (!(iv_finite(kx) && iv_finite(ky) && iv_finite(kz) && iv_finite(lx)
        && iv_finite(ly) && iv_finite(lz)))
    return false;
  const Iv p_x = iv_sub(iv_mul(ky, lz), iv_mul(kz, ly));
  const Iv p_y = iv_sub(iv_mul(kz, lx), iv_mul(kx, lz));
  const Iv p_z = iv_sub(iv_mul(kx, ly), iv_mul(ky, lx));
  if (!(iv_finite(p_x) && iv_finite(p_y) && iv_finite(p_z))) return false;
  const Iv dx = iv_affine(x0, x1, -1.0f, -f[9]);    // f[9] - px
  const Iv dy = iv_affine(y0, y1, -1.0f, -f[10]);
  const float rho2d_lo =
      FILTER_INV_SQUARE * __fadd_rd(iv_sq(dx).lo, iv_sq(dy).lo);
  const float lhs_lo = __fadd_rd(iv_sq(p_x).lo, iv_sq(p_y).lo);
  const float r = f[R_CULL] * 1.0001f;
  const Iv pz2 = iv_sq(p_z);
  const float rhs_hi = r >= 0.f ? __fmul_ru(r, pz2.hi) : __fmul_ru(r, pz2.lo);
  return rho2d_lo > f[R_CULL] && lhs_lo > rhs_hi;
}

// Stages pairs [p0, p0 + nb) of the tile whose rows start at `start` into
// shared memory rows of SROW floats, with the whole CTA (with kCull, each
// row's cull radius too); rows nb .. n_pad - 1 are zero (a pair that no
// pixel keeps: its p_z is 0).
template <class Rows, bool kCull = false>
__device__ __forceinline__ void stage(const float* __restrict__ feats,
                                      const Rows& rows_of, int start, int p0,
                                      int nb, int n_pad, int* s_row,
                                      float* s_feat, int tid) {
  if (tid < nb) s_row[tid] = rows_of.row(start, p0 + tid);
  __syncthreads();
  if (kCull && tid < nb)
    s_feat[tid * SROW + R_CULL] =
        cull_radius(feats[(size_t)s_row[tid] * NFEAT + 17]);
  for (int k = tid; k < nb * NFEAT; k += PIX) {
    const int r = k / NFEAT;
    s_feat[r * SROW + k - r * NFEAT] =
        feats[(size_t)s_row[r] * NFEAT + (k - r * NFEAT)];
  }
  for (int k = nb * SROW + tid; k < n_pad * SROW; k += PIX) s_feat[k] = 0.f;
  __syncthreads();
}

// A staged row into registers, by 16-byte loads (the compiler drops the
// loads of fields the caller does not read).
__device__ __forceinline__ void load_row(const float* s, float (&f)[SROW]) {
  const float4* v = reinterpret_cast<const float4*>(s);
#pragma unroll
  for (int i = 0; i < SROW / 4; ++i) {
    const float4 x = v[i];
    f[4 * i] = x.x;
    f[4 * i + 1] = x.y;
    f[4 * i + 2] = x.z;
    f[4 * i + 3] = x.w;
  }
}

// Pass A, one CTA per UNIT pairs of a tile: per pixel, the product of
// (1 - alpha) over the unit's kept pairs, and the kept pairs as bits (pass
// B evaluates only those), into the rows of its segment's work item.  The
// CTA first marks, per warp (two rows of the tile) and pair, whether
// warp_refuses proves the pair kept at none of the warp's pixels; each
// warp evaluates only the other pairs.  A warp stops once each of its
// pixels' product is below T_CUTOFF (the pixel trips in this unit whatever
// it enters with); its words past the stop have every bit set, so pass B
// evaluates every pair there.
template <class Rows>
__global__ void __launch_bounds__(PIX)
fwd_pass_a(const float* __restrict__ feats, Rows rows_of, int grid_x,
           const int* __restrict__ gtile, Layout lay,
           float* __restrict__ cand,
           unsigned long long* __restrict__ n_pass_a,
           long long* __restrict__ unit_ns, int n_timed) {
  __shared__ int s_row[UNIT];
  __shared__ __align__(16) float s_feat[UNIT * SROW];
  __shared__ unsigned s_eval[PIX / 32][UNIT / 32];   // [warp][word]: pairs
  const int unit = blockIdx.x;
  const int tid = threadIdx.x;
  long long t_start = 0;
  if (unit_ns != nullptr && tid == 0) t_start = global_ns();
  if (unit >= *lay.unit_total()) return;
  const int tile = lay.units()[2 * unit];
  const int k = lay.units()[2 * unit + 1];
  const int nb = min(UNIT, rows_of.count(tile) - k * UNIT);
  stage<Rows, true>(feats, rows_of, rows_of.base(tile), k * UNIT, nb,
                    (nb + 31) / 32 * 32, s_row, s_feat, tid);
  const int gt = grid_tile(gtile, tile);
  const float x0 = (float)((gt % grid_x) * TILE) + 0.5f;
  const float y0 = (float)((gt / grid_x) * TILE) + 0.5f;
  const float px = x0 + (float)(tid % TILE);
  const float py = y0 + (float)(tid / TILE);
  // the pairs each warp evaluates: thread tid tests pair tid % UNIT for
  // the warps (tid / UNIT) + 4 i
  const int warp = tid >> 5;
  for (int w = tid / UNIT; w < PIX / 32; w += PIX / UNIT) {
    const int j = tid % UNIT;
    const unsigned ev = __ballot_sync(
        FULL_MASK, j < nb && !warp_refuses(s_feat + j * SROW, x0,
                                           y0 + (float)(2 * w)));
    if ((tid & 31) == 0) s_eval[w][j / 32] = ev;
  }
  __syncthreads();
  float* out = cand + (size_t)(lay.item_start()[tile] + k / UNITS) * NCAND
      * PIX + tid;
  float prod = 1.0f;
  int walked = 0;
  for (int h = 0; h * 32 < nb; ++h) {
    unsigned bits = FULL_MASK;
    if (!__all_sync(FULL_MASK, prod < T_CUTOFF)) {   // warp-uniform
      bits = 0u;
      unsigned ev = s_eval[warp][h];
      walked += __popc(ev);
      while (ev != 0u) {
        const int b = __ffs(ev) - 1;
        ev &= ev - 1u;
        float f[SROW], alpha, depth;
        load_row(s_feat + (h * 32 + b) * SROW, f);
        if (pair_alpha<true>(f, px, py, alpha, depth)) {
          prod *= 1.0f - alpha;
          bits |= 1u << b;
        }
      }
    }
    out[(UNITS + (k % UNITS) * (UNIT / 32) + h) * PIX] = __uint_as_float(bits);
  }
  out[(k % UNITS) * PIX] = prod;
  if (n_pass_a != nullptr && (tid & 31) == 0)
    atomicAdd(n_pass_a, (unsigned long long)walked * 32);
  stamp(unit_ns, unit, n_timed, t_start, tid);
}

// The first kept pair of pairs [p0, p0 + nb) at a pixel, or nb: the fold's
// rare re-evaluation of a segment that a pixel enters alive below the
// cutoff.
template <class Rows>
__device__ int first_kept(const float* __restrict__ feats,
                          const Rows& rows_of, int start, int p0, int nb,
                          float px, float py) {
  for (int j = 0; j < nb; ++j) {
    float alpha, depth;
    if (pair_alpha(feats + (size_t)rows_of.row(start, p0 + j) * NFEAT, px,
                   py, alpha, depth))
      return j;
  }
  return nb;
}

// Pass B: each item walks its segment from T_in; a tile of one item writes
// its state, the last item of a multi-segment tile folds the partials.
template <class Rows, bool kTrain>
__global__ void __launch_bounds__(PIX)
fwd_pass_b(const float* __restrict__ feats, Rows rows_of, int grid_x,
           const int* __restrict__ gtile, Layout lay,
           const float* __restrict__ cand,
           float* __restrict__ part,
           float* __restrict__ state,            // [T, NSTATE, PIX]
           int* __restrict__ records,            // [T, NREC, PIX]
           float* __restrict__ ckpt,             // [n_bound, NCKPT, PIX]
           const int* __restrict__ ckpt_off,     // [T]
           long long* __restrict__ item_ns, int n_timed) {
  __shared__ int s_row[SEG];
  __shared__ __align__(16) float s_feat[SEG * SROW];
  __shared__ unsigned s_mask[SEG / 32 * PIX];
  __shared__ int s_fold;
  const int item = blockIdx.x;
  const int tid = threadIdx.x;
  long long t_start = 0;
  if (item_ns != nullptr && tid == 0) t_start = global_ns();
  if (item >= lay.total()) return;
  const int tile = lay.items()[2 * item];
  const int seg = lay.items()[2 * item + 1];
  const int count = rows_of.count(tile);
  const int n_seg = segments_of(count);
  const int start = rows_of.base(tile);
  const int p0 = seg * SEG;
  const int nb = max(0, min(SEG, count - p0));
  const int gt = grid_tile(gtile, tile);
  const float px = (float)((gt % grid_x) * TILE + (tid % TILE)) + 0.5f;
  const float py = (float)((gt / grid_x) * TILE + (tid / TILE)) + 0.5f;
  const int slot0 = n_seg > 1 ? lay.slot_start()[tile] : 0;

  // T entering the segment: the ordered product of the earlier units'
  const float* cand0 = cand + (size_t)(item - seg) * NCAND * PIX + tid;
  float T = 1.0f;
  for (int q = 0; q < seg * UNITS; ++q)
    T *= cand0[((q / UNITS) * NCAND + q % UNITS) * PIX];
  const float T_in = T;
  const bool pre = T_in < T_CUTOFF;    // terminated in an earlier segment
  bool done = false;
  float dist1 = 0.f, dist2 = 0.f, distortion = 0.f;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, n0 = 0.f, n1 = 0.f, n2 = 0.f;
  float depth_acc = 0.f, med_d = 0.f, med_w = 0.f;
  int n_eval = 0, n_blend = 0;
  int last = -1, med = -1;         // positions in the segment

  if (nb > 0 && __syncthreads_or(!pre)) {   // CTA-uniform
    // pass A's candidates, the pairs it kept: words of each pixel's bits
    const int n_words = (nb + 31) / 32;
    const float* mask = cand + ((size_t)item * NCAND + UNITS) * PIX;
    for (int k = tid; k < n_words * PIX; k += PIX)
      s_mask[k] = __float_as_uint(mask[k]);
    stage(feats, rows_of, start, p0, nb, nb, s_row, s_feat, tid);
    if (!pre) {
      unsigned bits = 0u;
      int word = 0, j = 0;
      while (true) {
        while (bits == 0u && word < n_words)
          bits = s_mask[PIX * word++ + tid];
        if (bits == 0u) break;
        j = (word - 1) * 32 + __ffs(bits) - 1;
        bits &= bits - 1u;
        float f[SROW], alpha, depth;
        load_row(s_feat + j * SROW, f);
        if (!pair_alpha(f, px, py, alpha, depth)) continue;
        // front-to-back compositing (_chunk_step)
        const float T_after = T * (1.0f - alpha);
        if (T_after < T_CUTOFF) {  // the tripping Gaussian is dropped
          done = true;
          break;
        }
        const float w = alpha * T;
        c0 += w * f[14];
        c1 += w * f[15];
        c2 += w * f[16];
        n0 += w * f[11];
        n1 += w * f[12];
        n2 += w * f[13];
        depth_acc += w * depth;
        const float safe_d = depth != 0.0f ? depth : 1.0f;
        const float m =
            (FAR_PLANE * depth - FAR_X_NEAR) / (FAR_MINUS_NEAR * safe_d);
        const float err = m * m * (1.0f - T) + dist2 - 2.0f * m * dist1;
        distortion += err * w;
        dist1 += w * m;
        dist2 += w * m * m;
        if (T > 0.5f) {  // median depth: last blended with pre-blend T > 0.5
          med_d = depth;
          med_w = w;
          med = j;
        }
        last = j;
        ++n_blend;
        T = T_after;
      }
      // evaluated: up to and with the trip, else the whole segment
      n_eval = done ? j + 1 : nb;
    }
  }

  if (n_seg == 1) {                  // the tile's only item: final state
    float* out = state + (size_t)tile * NSTATE * PIX + tid;
    const float rows[NSTATE] = {T, done ? 1.0f : 0.0f, dist1, dist2,
                                c0, c1, c2, depth_acc, n0, n1, n2,
                                distortion, med_d, med_w,
                                (float)n_eval, (float)n_blend};
#pragma unroll
    for (int r = 0; r < NSTATE; ++r) out[r * PIX] = rows[r];
    if (kTrain) {
      int* rec = records + (size_t)tile * NREC * PIX + tid;
      rec[0] = last;
      rec[PIX] = med;
    }
    stamp(item_ns, item, n_timed, t_start, tid);
    return;
  }

  float* mine = part + (size_t)(slot0 + seg) * NPART * PIX + tid;
  const float rows[NPART] = {
      T, T_in - T, dist1, dist2, c0, c1, c2, depth_acc, n0, n1, n2,
      distortion, med_d, med_w,
      __int_as_float(n_eval | n_blend << 9 | (int)done << 18
                     | (int)pre << 19),
      __int_as_float((last + 1) | (med + 1) << 16)};
#pragma unroll
  for (int r = 0; r < NPART; ++r) mine[r * PIX] = rows[r];
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
  float rT = 1.0f, rd1 = 0.f, rd2 = 0.f, rdist = 0.f;
  float rc0 = 0.f, rc1 = 0.f, rc2 = 0.f, rn0 = 0.f, rn1 = 0.f, rn2 = 0.f;
  float rdepth = 0.f, rmed_d = 0.f, rmed_w = 0.f;
  bool rdone = false;
  int rn_eval = 0, rn_blend = 0, rlast = -1, rmed = -1;
  for (int q = 0; q < n_seg; ++q) {
    if (!rdone) {
      const float* pq = part + (size_t)(slot0 + q) * NPART * PIX + tid;
      const int flags = __float_as_int(__ldcg(pq + P_FLAGS * PIX));
      if (flags >> 19 & 1) {
        // entered below the cutoff although the walk before ended alive:
        // its first kept pair trips it
        const int q_nb = min(SEG, count - q * SEG);
        const int f = first_kept(feats, rows_of, start, q * SEG, q_nb, px,
                                 py);
        rn_eval += f < q_nb ? f + 1 : q_nb;
        rdone = f < q_nb;
      } else {
        const float sum_w = __ldcg(pq + P_SUM_W * PIX);
        const float qd1 = __ldcg(pq + 2 * PIX);
        rdist = rdist + (__ldcg(pq + 11 * PIX) + rd2 * sum_w
                         - 2.0f * rd1 * qd1);
        rd1 += qd1;
        rd2 += __ldcg(pq + 3 * PIX);
        rc0 += __ldcg(pq + 4 * PIX);
        rc1 += __ldcg(pq + 5 * PIX);
        rc2 += __ldcg(pq + 6 * PIX);
        rdepth += __ldcg(pq + 7 * PIX);
        rn0 += __ldcg(pq + 8 * PIX);
        rn1 += __ldcg(pq + 9 * PIX);
        rn2 += __ldcg(pq + 10 * PIX);
        rT = __ldcg(pq + P_T * PIX);
        rdone = flags >> 18 & 1;
        rn_eval += flags & 511;
        rn_blend += flags >> 9 & 511;
        const int pos = __float_as_int(__ldcg(pq + P_POS * PIX));
        if (pos >> 16) {
          rmed_d = __ldcg(pq + 12 * PIX);
          rmed_w = __ldcg(pq + 13 * PIX);
          rmed = q * SEG + (pos >> 16) - 1;
        }
        if (pos & 0xffff) rlast = q * SEG + (pos & 0xffff) - 1;
      }
    }
    if (kTrain && q < n_seg - 1) {
      // the accumulators after pairs [0, (q+1) SEG): the backward's
      // post-state for the segment that ends there
      float* ck = ckpt + (size_t)(ckpt_off[tile] + q) * NCKPT * PIX + tid;
      const float ck_rows[NCKPT] = {rT, rd1, rd2, rc0, rc1, rc2, rdepth,
                                    rn0, rn1, rn2, rdist};
#pragma unroll
      for (int r = 0; r < NCKPT; ++r) ck[r * PIX] = ck_rows[r];
    }
  }
  float* out = state + (size_t)tile * NSTATE * PIX + tid;
  const float out_rows[NSTATE] = {rT, rdone ? 1.0f : 0.0f, rd1, rd2,
                                  rc0, rc1, rc2, rdepth, rn0, rn1, rn2,
                                  rdist, rmed_d, rmed_w,
                                  (float)rn_eval, (float)rn_blend};
#pragma unroll
  for (int r = 0; r < NSTATE; ++r) out[r * PIX] = out_rows[r];
  if (kTrain) {
    int* rec = records + (size_t)tile * NREC * PIX + tid;
    rec[0] = rlast;
    rec[PIX] = rmed;
  }
  stamp(item_ns, item, n_timed, t_start, tid);
}

template <class Rows>
int launch(const float* feats, Rows rows, const int* counts, int num_tiles,
           int grid_x, const int* gtile, int max_items, int max_units,
           float* state,
           int* records, float* ckpt, const int* ckpt_off, int* layout,
           float* cand, float* part, unsigned long long* n_pass_a,
           long long* unit_ns, int n_units_timed, long long* item_ns,
           int n_items_timed, cudaStream_t stream) {
  if (num_tiles <= 0 || max_items <= 0) return 0;
  const Layout lay{layout, num_tiles, max_items};
  // the counts are clamped at tile_cap by the caller
  fwd_layout<<<1, LAYOUT_THREADS, 0, stream>>>(counts, INT_MAX, num_tiles,
                                               max_units, lay);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (max_units > 0) {
    fwd_pass_a<Rows><<<max_units, PIX, 0, stream>>>(
        feats, rows, grid_x, gtile, lay, cand, n_pass_a, unit_ns,
        n_units_timed);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (records != nullptr)
    fwd_pass_b<Rows, true><<<max_items, PIX, 0, stream>>>(
        feats, rows, grid_x, gtile, lay, cand, part, state, records, ckpt,
        ckpt_off, item_ns, n_items_timed);
  else
    fwd_pass_b<Rows, false><<<max_items, PIX, 0, stream>>>(
        feats, rows, grid_x, gtile, lay, cand, part, state, nullptr,
        nullptr, nullptr, item_ns, n_items_timed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int blend_fwd_launch(const float* feats, const int* pair_rank,
                                const int* tile_start, const int* tile_count,
                                int num_tiles, int grid_x, const int* gtile,
                                int max_items, int max_units, float* state,
                                int* records, float* ckpt,
                                const int* ckpt_off, int* layout,
                                float* cand, float* part,
                                unsigned long long* n_pass_a,
                                long long* unit_ns, int n_units_timed,
                                long long* item_ns, int n_items_timed,
                                void* stream) {
  return launch(feats, RankedRows{pair_rank, tile_start, tile_count},
                tile_count, num_tiles, grid_x, gtile, max_items, max_units,
                state, records, ckpt, ckpt_off, layout, cand, part, n_pass_a,
                unit_ns, n_units_timed, item_ns, n_items_timed,
                (cudaStream_t)stream);
}

extern "C" int blend_dense_fwd_launch(const float* gdata, const int* counts,
                                      int tile_cap, int num_tiles, int grid_x,
                                      int max_items, int max_units,
                                      float* state, int* records, float* ckpt,
                                      const int* ckpt_off, int* layout,
                                      float* cand, float* part,
                                      unsigned long long* n_pass_a,
                                      long long* unit_ns, int n_units_timed,
                                      long long* item_ns, int n_items_timed,
                                      void* stream) {
  return launch(gdata, DenseRows{counts, tile_cap}, counts, num_tiles,
                grid_x, nullptr, max_items, max_units, state, records, ckpt,
                ckpt_off, layout, cand, part, n_pass_a, unit_ns,
                n_units_timed, item_ns, n_items_timed, (cudaStream_t)stream);
}

extern "C" const char* blend_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
