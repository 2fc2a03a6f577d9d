// Forward surfel blend over depth-sorted per-tile pair lists (Hopper, sm_90a).
//
// Two entry points share one kernel template over where a tile's rows come
// from (the row policy):
//  * K1, `blend_fwd_launch`, replaces the TPU kernel `_fwd_wq_kernel` of
//    d2dgs_tpu/ops/pallas/blend_tpu.py (with its launcher `_fwd_wq_call` and
//    the work queue `build_work_queue` that fed it): tile t's i-th pair is
//    the sorted feature row `feats[pair_rank[tile_start[t] + i]]`
//    (`RankedRows`); the plain PyTorch version is `blend_tiles_plain` in
//    d2dgs_torch/ops/tiled_raster.py;
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
// What bounds it on this card: its busiest tile.  Each (pair, pixel)
// evaluation is ~50 float32 operations (ray-splat intersection, low-pass
// filter, exp) plus ~35 more when the pair is blended, against 72 bytes of
// features per pair that are shared by the tile's 256 pixels, so the
// kernel sits far above the card's float32 ridge point (67 TFLOP/s over
// 3.35 TB/s, about 20 operations per byte).  Its bytes are the feature
// rows, the pair ranks (K1) and the 16 state rows written per pixel.  But
// the tiles are very unequal (on an 800x800 view most hold no pair and the
// busiest ~2,900), and one CTA walks each tile in order, so the launch
// lasts as long as the busiest tile's walk; the backward kernels split
// theirs at the checkpoints below, a forward split needs each segment's
// incoming state first (a prefix pass, not done here).
//
// What the design does about it:
//  * one CTA per 16x16 tile, one thread per pixel: all 14 accumulators live
//    in registers for the whole walk and are written once, coalesced;
//  * the CTA walks its own rows [0, count) of the tile, so neither the TPU
//    work queue nor the TPU's per-chunk carries are needed;
//  * batches of 256 pair feature rows are staged in shared memory by the
//    whole CTA (each row read from device memory once per tile, not once
//    per pixel; neighbouring threads read neighbouring words of a row);
//  * each pixel composites sequentially and stops at its termination; the
//    CTA leaves the walk once every pixel is done (__syncthreads_count).
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
// Rows 14 and 15 count the pairs each pixel evaluated and blended; they
// size the operation count of the kernel's bound.
//
// Training mode (``records`` not null, the kTrain instance): per pixel, the
// position in the tile's pair list of the last blended pair and of the
// median pair (-1 when there is none), [T, NREC, PIX] int32, and at every
// BATCH-th pair b = 256, 512, ... that the CTA reaches, the NCKPT running
// accumulators after pairs [0, b) into checkpoint ckpt_off[t] + b/256 - 1
// of ``ckpt`` [n_bound, NCKPT, PIX] (the wrapper sizes it and the offsets
// from the counts).  The backward kernels (blend_bwd.cu) start each
// 256-pair segment's walk from them.  Serving passes null and compiles to
// the instance that writes nothing extra.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;   // threads per CTA
constexpr int NFEAT = 18;          // Tmat(9) center(2) normal(3) color(3) opacity(1)
constexpr int NSTATE = 16;
constexpr int NREC = 2;            // training records: last, median
constexpr int BATCH = 256;         // pairs staged per shared-memory batch
// training checkpoints: T, dist1, dist2, colour(3), depth, normal(3),
// distortion (state rows 0 and 2-11) at every BATCH-th pair
constexpr int NCKPT = 11;

constexpr float FILTER_INV_SQUARE = 2.0f;
constexpr float ALPHA_CLIP = 0.99f;
constexpr float ALPHA_CUTOFF = 1.0f / 255.0f;
constexpr float T_CUTOFF = 1e-4f;
constexpr float NEAR_PLANE = 0.2f;
constexpr float FAR_PLANE = 100.0f;
constexpr float FAR_X_NEAR = 20.0f;        // FAR_PLANE * NEAR_PLANE
constexpr float FAR_MINUS_NEAR = 99.8f;    // FAR_PLANE - NEAR_PLANE

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

template <class Rows, bool kTrain>
__global__ void __launch_bounds__(PIX)
blend_fwd_kernel(const float* __restrict__ feats,      // rows of NFEAT
                 Rows rows_of,
                 int grid_x,
                 float* __restrict__ state,            // [T, NSTATE, PIX]
                 int* __restrict__ records,            // [T, NREC, PIX]
                 float* __restrict__ ckpt,             // [n_bound, NCKPT, PIX]
                 const int* __restrict__ ckpt_off)     // [T]
{
  __shared__ int s_row[BATCH];
  __shared__ float s_feat[BATCH * NFEAT];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = (float)((tile % grid_x) * TILE + (tid % TILE)) + 0.5f;
  const float py = (float)((tile / grid_x) * TILE + (tid / TILE)) + 0.5f;
  const int start = rows_of.base(tile);
  const int count = rows_of.count(tile);

  float T = 1.0f;
  bool done = false;
  float dist1 = 0.f, dist2 = 0.f, distortion = 0.f;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, n0 = 0.f, n1 = 0.f, n2 = 0.f;
  float depth_acc = 0.f, med_d = 0.f, med_w = 0.f;
  int n_eval = 0, n_blend = 0;
  int last = -1, med = -1;         // positions in the tile's pair list

  for (int b0 = 0; b0 < count; b0 += BATCH) {
    // CTA-wide exit once every pixel is done; also the barrier that
    // protects the shared batch of the previous iteration
    if (__syncthreads_count(!done) == 0) break;
    if (kTrain && b0 > 0) {
      // the accumulators after pairs [0, b0): the backward's post-state
      // for the segment that ends here
      float* ck = ckpt + (size_t)(ckpt_off[tile] + b0 / BATCH - 1) * NCKPT
          * PIX + tid;
      const float rows[NCKPT] = {T, dist1, dist2, c0, c1, c2, depth_acc,
                                 n0, n1, n2, distortion};
#pragma unroll
      for (int r = 0; r < NCKPT; ++r) ck[r * PIX] = rows[r];
    }
    const int nb = min(BATCH, count - b0);
    if (tid < nb) s_row[tid] = rows_of.row(start, b0 + tid);
    __syncthreads();
    for (int k = tid; k < nb * NFEAT; k += PIX) {
      const int r = k / NFEAT;
      s_feat[k] = feats[(size_t)s_row[r] * NFEAT + (k - r * NFEAT)];
    }
    __syncthreads();
    if (done) continue;

    for (int j = 0; j < nb; ++j) {
      const float* f = s_feat + j * NFEAT;
      ++n_eval;
      // ray-splat intersection (_resp, forward.cu:336-402)
      const float kx = px * f[6] - f[0];
      const float ky = px * f[7] - f[1];
      const float kz = px * f[8] - f[2];
      const float lx = py * f[6] - f[3];
      const float ly = py * f[7] - f[4];
      const float lz = py * f[8] - f[5];
      const float p_x = ky * lz - kz * ly;
      const float p_y = kz * lx - kx * lz;
      const float p_z = kx * ly - ky * lx;
      if (p_z == 0.0f) continue;
      const float inv_pz = 1.0f / p_z;
      const float sx = p_x * inv_pz;
      const float sy = p_y * inv_pz;
      const float rho3d = sx * sx + sy * sy;
      const float dx = f[9] - px;
      const float dy = f[10] - py;
      const float rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy);
      const bool use3d = rho3d <= rho2d;
      const float depth = use3d ? sx * f[6] + sy * f[7] + f[8] : f[8];
      const float alpha =
          fminf(ALPHA_CLIP, f[17] * expf(-0.5f * fminf(rho3d, rho2d)));
      if (!(depth >= NEAR_PLANE) || !(alpha >= ALPHA_CUTOFF)) continue;

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
        med = b0 + j;
      }
      last = b0 + j;
      ++n_blend;
      T = T_after;
    }
  }

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
}

}  // namespace

extern "C" int blend_fwd_launch(const float* feats, const int* pair_rank,
                                const int* tile_start, const int* tile_count,
                                int num_tiles, int grid_x, float* state,
                                int* records, float* ckpt,
                                const int* ckpt_off, void* stream) {
  if (num_tiles <= 0) return 0;
  const RankedRows rows{pair_rank, tile_start, tile_count};
  if (records != nullptr)
    blend_fwd_kernel<RankedRows, true><<<num_tiles, PIX, 0,
                                          (cudaStream_t)stream>>>(
        feats, rows, grid_x, state, records, ckpt, ckpt_off);
  else
    blend_fwd_kernel<RankedRows, false><<<num_tiles, PIX, 0,
                                           (cudaStream_t)stream>>>(
        feats, rows, grid_x, state, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

extern "C" int blend_dense_fwd_launch(const float* gdata, const int* counts,
                                      int tile_cap, int num_tiles, int grid_x,
                                      float* state, int* records, float* ckpt,
                                      const int* ckpt_off, void* stream) {
  if (num_tiles <= 0) return 0;
  const DenseRows rows{counts, tile_cap};
  if (records != nullptr)
    blend_fwd_kernel<DenseRows, true><<<num_tiles, PIX, 0,
                                         (cudaStream_t)stream>>>(
        gdata, rows, grid_x, state, records, ckpt, ckpt_off);
  else
    blend_fwd_kernel<DenseRows, false><<<num_tiles, PIX, 0,
                                          (cudaStream_t)stream>>>(
        gdata, rows, grid_x, state, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

extern "C" const char* blend_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
