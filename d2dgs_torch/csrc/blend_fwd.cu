// Forward surfel blend over depth-sorted per-tile pair lists (Hopper, sm_90a).
//
// Replaces the TPU kernel `_fwd_wq_kernel` of
// d2dgs_tpu/ops/pallas/blend_tpu.py (with its launcher `_fwd_wq_call` and
// the work queue `build_work_queue` that fed it).  It computes the same
// per-tile state rows as that kernel's `_chunk_step`; the plain PyTorch
// version is `blend_tiles_plain` in d2dgs_torch/ops/tiled_raster.py.
//
// What bounds it on this card: operations.  Each (pair, pixel) evaluation
// is ~50 float32 operations (ray-splat intersection, low-pass filter, exp)
// plus ~35 more when the pair is blended, against 72 bytes of features per
// pair that are shared by the tile's 256 pixels, so the kernel sits far
// above the card's float32 ridge point (67 TFLOP/s over 3.35 TB/s, about
// 20 operations per byte).  Its bytes are the depth-sorted feature rows,
// the pair ranks and the 16 state rows written per pixel.
//
// What the design does about it:
//  * one CTA per 16x16 tile, one thread per pixel: all 14 accumulators live
//    in registers for the whole walk and are written once, coalesced;
//  * the CTA walks its own range [tile_start, tile_start + tile_count) of
//    the sorted pair list, so the TPU work queue is not needed;
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

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;   // threads per CTA
constexpr int NFEAT = 18;          // Tmat(9) center(2) normal(3) color(3) opacity(1)
constexpr int NSTATE = 16;
constexpr int BATCH = 256;         // pairs staged per shared-memory batch

constexpr float FILTER_INV_SQUARE = 2.0f;
constexpr float ALPHA_CLIP = 0.99f;
constexpr float ALPHA_CUTOFF = 1.0f / 255.0f;
constexpr float T_CUTOFF = 1e-4f;
constexpr float NEAR_PLANE = 0.2f;
constexpr float FAR_PLANE = 100.0f;
constexpr float FAR_X_NEAR = 20.0f;        // FAR_PLANE * NEAR_PLANE
constexpr float FAR_MINUS_NEAR = 99.8f;    // FAR_PLANE - NEAR_PLANE

__global__ void __launch_bounds__(PIX)
blend_fwd_kernel(const float* __restrict__ feats,      // [N, NFEAT] depth order
                 const int* __restrict__ pair_rank,    // [B]
                 const int* __restrict__ tile_start,   // [T]
                 const int* __restrict__ tile_count,   // [T]
                 int grid_x,
                 float* __restrict__ state)            // [T, NSTATE, PIX]
{
  __shared__ int s_rank[BATCH];
  __shared__ float s_feat[BATCH * NFEAT];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = (float)((tile % grid_x) * TILE + (tid % TILE)) + 0.5f;
  const float py = (float)((tile / grid_x) * TILE + (tid / TILE)) + 0.5f;
  const int start = tile_start[tile];
  const int count = tile_count[tile];

  float T = 1.0f;
  bool done = false;
  float dist1 = 0.f, dist2 = 0.f, distortion = 0.f;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, n0 = 0.f, n1 = 0.f, n2 = 0.f;
  float depth_acc = 0.f, med_d = 0.f, med_w = 0.f;
  int n_eval = 0, n_blend = 0;

  for (int b0 = 0; b0 < count; b0 += BATCH) {
    // CTA-wide exit once every pixel is done; also the barrier that
    // protects the shared batch of the previous iteration
    if (__syncthreads_count(!done) == 0) break;
    const int nb = min(BATCH, count - b0);
    if (tid < nb) s_rank[tid] = pair_rank[start + b0 + tid];
    __syncthreads();
    for (int k = tid; k < nb * NFEAT; k += PIX) {
      const int r = k / NFEAT;
      s_feat[k] = feats[(size_t)s_rank[r] * NFEAT + (k - r * NFEAT)];
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
      }
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
}

}  // namespace

extern "C" int blend_fwd_launch(const float* feats, const int* pair_rank,
                                const int* tile_start, const int* tile_count,
                                int num_tiles, int grid_x, float* state,
                                void* stream) {
  if (num_tiles <= 0) return 0;
  blend_fwd_kernel<<<num_tiles, PIX, 0, (cudaStream_t)stream>>>(
      feats, pair_rank, tile_start, tile_count, grid_x, state);
  return (int)cudaGetLastError();
}

extern "C" const char* blend_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
