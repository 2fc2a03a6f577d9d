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
// the autograd VJP through it is K6's.
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
// Shape: one CTA per 16x16 tile, one thread per pixel, its accumulators
// in registers.  The tile's pairs are staged PIX at a time in shared
// memory by the whole CTA: each thread gathers one pair's features
// through `pair_gid` (conic 3, centre 2, colour C, depth 1, opacity 1),
// so each Gaussian row is read from device memory once per tile and not
// once per pixel, and torch does no [tiles, chunk] advanced indexing.
//  * K5 walks front to back and stops at the batch where no pixel of the
//    tile is live.  Besides the outputs it writes, for K6, the number of
//    pairs each pixel walked up to its last blended one (`n_walk`), and,
//    on request, each pixel's evaluated and blended pair counts (`work`,
//    [T, 2, 256], which size the bound of chip_smoke.py).
//  * K6 re-walks each pixel's pairs back to front from K5's final T,
//    rebuilding the pre-blend T of each blended pair by a division (as
//    the reference's backward does), and adds each pair's gradient in
//    conic, centre, colour, depth and opacity, summed over a warp's
//    pixels by shuffles, into the per-Gaussian outputs by one atomicAdd
//    per warp and value.  The outputs must be zeroed by the caller.
//
// What bounds it: float32 instruction issue, per evaluated pair-pixel
// (the response: 2 subtractions, the quadratic form, expf, the masks) and
// per blended one; bytes are small (the Gaussian rows, the pair list and
// a few rows per pixel).  This first version is simple and right; it
// does not cull pairs per warp or balance the tiles (one CTA walks a
// whole tile, so the busiest tile bounds a launch).
//
// Built with -fmad=false (d2dgs_torch/ops/cuda/build.py), so every
// operation rounds as the plain version's PyTorch op does.  C: the
// kernels are templates on the colour channels and built for C = 3, the
// flow path's (d2dgs_torch/render/renderer.py: the uv flow and the
// motion mask); the launchers refuse any other C.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;      // threads per CTA, pairs per batch
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float ALPHA_CLIP = 0.99f;
constexpr float ALPHA_CUTOFF = 1.0f / 255.0f;
constexpr float T_CUTOFF = 1e-4f;
// the launchers' code for a colour count they are not built for
constexpr int ERR_CHANNELS = -1;

// A staged pair: conic (a, b, c), centre (x, y), colour C, depth,
// opacity.
template <int C>
struct Row {
  static constexpr int NF = 7 + C;
  static constexpr int CON = 0, CEN = 3, COL = 5, DEPTH = 5 + C,
                       OPAC = 6 + C;
};

template <int C>
__device__ __forceinline__ void stage(float* s, int gid,
                                      const float* __restrict__ conic,
                                      const float* __restrict__ center,
                                      const float* __restrict__ colors,
                                      const float* __restrict__ depth,
                                      const float* __restrict__ opac) {
  using R = Row<C>;
#pragma unroll
  for (int k = 0; k < 3; ++k) s[R::CON + k] = conic[(size_t)gid * 3 + k];
#pragma unroll
  for (int k = 0; k < 2; ++k) s[R::CEN + k] = center[(size_t)gid * 2 + k];
#pragma unroll
  for (int k = 0; k < C; ++k) s[R::COL + k] = colors[(size_t)gid * C + k];
  s[R::DEPTH] = depth[gid];
  s[R::OPAC] = opac[gid];
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
template <int C>
__device__ __forceinline__ float pair_alpha(const float* f, float px,
                                            float py, float& dx, float& dy,
                                            float& E, float& raw) {
  using R = Row<C>;
  dx = px - f[R::CEN];
  dy = py - f[R::CEN + 1];
  const float power = -0.5f * (f[R::CON] * (dx * dx)
                               + f[R::CON + 2] * (dy * dy))
                      - (f[R::CON + 1] * dx) * dy;
  E = expf(power);
  raw = f[R::OPAC] * E;
  const float a = fminf(raw, ALPHA_CLIP);
  return (power <= 0.0f && a >= ALPHA_CUTOFF) ? a : 0.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL_MASK, v, o);
  return v;
}

template <int C>
__global__ void __launch_bounds__(PIX)
    raster3d_fwd(const float* __restrict__ conic,
                 const float* __restrict__ center,
                 const float* __restrict__ colors,
                 const float* __restrict__ depth,
                 const float* __restrict__ opac,
                 const int* __restrict__ pair_gid,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_count, int grid_x, int cap,
                 float* __restrict__ T_out, float* __restrict__ C_out,
                 float* __restrict__ D_out, int* __restrict__ n_walk,
                 int* __restrict__ work) {
  using R = Row<C>;
  __shared__ float s_f[PIX * R::NF];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = (float)((tile % grid_x) * TILE + tid % TILE);
  const float py = (float)((tile / grid_x) * TILE + tid / TILE);
  const int start = tile_start[tile];
  // Parity trap (tile_cap): `cap` is floor(tile_cap / chunk) * chunk (at
  // least one chunk), the pairs the JAX scan walks of a tile
  const int count = min(tile_count[tile], cap);
  float T = 1.0f, D = 0.0f, acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  int walked = 0, n_eval = 0, n_blend = 0;
  for (int b0 = 0; b0 < count; b0 += PIX) {
    // a barrier too: the previous batch's rows are read by every thread
    if (__syncthreads_count(T > T_CUTOFF) == 0) break;
    const int nb = min(PIX, count - b0);
    if (tid < nb)
      stage<C>(s_f + tid * R::NF, pair_gid[start + b0 + tid], conic, center,
               colors, depth, opac);
    __syncthreads();
    // Parity trap (termination): the JAX walk tests T > T_CUTOFF *before*
    // a pair and then blends it (d2dgs_tpu/ops/raster3d.py:203-210: live
    // = T_c > T_CUTOFF; w = a T_c; T *= 1 - a), so the pair that takes T
    // below the cutoff is blended.  The reference's renderCUDA tests
    // T (1 - a) < 1e-4 and stops before blending it; the port follows
    // the JAX package.
    for (int j = 0; j < nb && T > T_CUTOFF; ++j) {
      const float* f = s_f + j * R::NF;
      float dx, dy, E, raw;
      const float a = pair_alpha<C>(f, px, py, dx, dy, E, raw);
      ++n_eval;
      if (a > 0.0f) {
        const float w = a * T;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = acc[c] + w * f[R::COL + c];
        D = D + w * f[R::DEPTH];
        T = T * (1.0f - a);
        walked = b0 + j + 1;
        ++n_blend;
      }
    }
  }
  const size_t p = (size_t)tile * PIX + tid;
  T_out[p] = T;
#pragma unroll
  for (int c = 0; c < C; ++c) C_out[p * C + c] = acc[c];
  D_out[p] = D;
  if (n_walk != nullptr) n_walk[p] = walked;
  if (work != nullptr) {
    work[(size_t)tile * 2 * PIX + tid] = n_eval;
    work[(size_t)tile * 2 * PIX + PIX + tid] = n_blend;
  }
}

template <int C>
__global__ void __launch_bounds__(PIX)
    raster3d_bwd(const float* __restrict__ conic,
                 const float* __restrict__ center,
                 const float* __restrict__ colors,
                 const float* __restrict__ depth,
                 const float* __restrict__ opac,
                 const int* __restrict__ pair_gid,
                 const int* __restrict__ tile_start, int grid_x,
                 const float* __restrict__ T_fin,
                 const int* __restrict__ n_walk,
                 const float* __restrict__ gT, const float* __restrict__ gC,
                 const float* __restrict__ gD, float* __restrict__ d_conic,
                 float* __restrict__ d_center, float* __restrict__ d_colors,
                 float* __restrict__ d_depth, float* __restrict__ d_opac) {
  using R = Row<C>;
  constexpr int NG = R::NF;      // one gradient per staged feature
  __shared__ float s_f[PIX * R::NF];
  __shared__ int s_gid[PIX];
  __shared__ int s_walk;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float px = (float)((tile % grid_x) * TILE + tid % TILE);
  const float py = (float)((tile / grid_x) * TILE + tid / TILE);
  const int start = tile_start[tile];
  const size_t p = (size_t)tile * PIX + tid;
  const int n = n_walk[p];
  float T = T_fin[p];
  float g_col[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g_col[c] = gC[p * C + c];
  const float g_dep = gD[p];
  // R_i = sum over the blended pairs j > i of w_j g_j, plus the final T's
  // term gT T_n; the adjoint of alpha_i is T_i g_i - R_i / (1 - alpha_i)
  float Rsum = gT[p] * T;
  if (tid == 0) s_walk = 0;
  __syncthreads();
  if (n > 0) atomicMax(&s_walk, n);
  __syncthreads();
  const int tile_walk = s_walk;
  for (int b0 = ((tile_walk - 1) / PIX) * PIX; tile_walk > 0 && b0 >= 0;
       b0 -= PIX) {
    __syncthreads();               // the previous batch's rows are read
    const int nb = min(PIX, tile_walk - b0);
    if (tid < nb) {
      const int gid = pair_gid[start + b0 + tid];
      s_gid[tid] = gid;
      stage<C>(s_f + tid * R::NF, gid, conic, center, colors, depth, opac);
    }
    __syncthreads();
    for (int j = nb - 1; j >= 0; --j) {
      const float* f = s_f + j * R::NF;
      float g[NG];
#pragma unroll
      for (int k = 0; k < NG; ++k) g[k] = 0.0f;
      bool mine = false;
      if (b0 + j < n) {
        float dx, dy, E, raw;
        const float a = pair_alpha<C>(f, px, py, dx, dy, E, raw);
        if (a > 0.0f) {
          mine = true;
          const float om = 1.0f - a;
          const float Ti = T / om;         // T before this pair
          const float w = a * Ti;
          float gw = 0.0f;                 // d loss / d w
#pragma unroll
          for (int c = 0; c < C; ++c) {
            gw = gw + g_col[c] * f[R::COL + c];
            g[R::COL + c] = w * g_col[c];
          }
          gw = gw + g_dep * f[R::DEPTH];
          g[R::DEPTH] = w * g_dep;
          const float ga = Ti * gw - Rsum / om;
          Rsum = Rsum + w * gw;
          T = Ti;
          // Parity trap (gradients through the clip and the cut): the
          // clip's gradient is zero where it clips (torch's clamp_max
          // passes it where raw <= ALPHA_CLIP), and a pair below the
          // cutoff (a == 0) has none
          const float graw = raw <= ALPHA_CLIP ? ga : 0.0f;
          g[R::OPAC] = graw * E;
          const float gp = graw * f[R::OPAC] * E;   // d loss / d power
          g[R::CON] = -0.5f * gp * (dx * dx);
          g[R::CON + 1] = -gp * dx * dy;
          g[R::CON + 2] = -0.5f * gp * (dy * dy);
          // d = pixel - centre: the centre takes minus d power / d d
          g[R::CEN] = gp * (f[R::CON] * dx + f[R::CON + 1] * dy);
          g[R::CEN + 1] = gp * (f[R::CON + 2] * dy + f[R::CON + 1] * dx);
        }
      }
      if (__any_sync(FULL_MASK, mine)) {
#pragma unroll
        for (int k = 0; k < NG; ++k) g[k] = warp_sum(g[k]);
        if (lane == 0) {
          const size_t gid = (size_t)s_gid[j];
#pragma unroll
          for (int k = 0; k < 3; ++k)
            atomicAdd(d_conic + gid * 3 + k, g[R::CON + k]);
#pragma unroll
          for (int k = 0; k < 2; ++k)
            atomicAdd(d_center + gid * 2 + k, g[R::CEN + k]);
#pragma unroll
          for (int c = 0; c < C; ++c)
            atomicAdd(d_colors + gid * C + c, g[R::COL + c]);
          atomicAdd(d_depth + gid, g[R::DEPTH]);
          atomicAdd(d_opac + gid, g[R::OPAC]);
        }
      }
    }
  }
}

}  // namespace

extern "C" int raster3d_fwd_launch(const float* conic, const float* center,
                                   const float* colors, const float* depth,
                                   const float* opac, const int* pair_gid,
                                   const int* tile_start,
                                   const int* tile_count, int num_tiles,
                                   int grid_x, int cap, int channels,
                                   float* T_out, float* C_out, float* D_out,
                                   int* n_walk, int* work, void* stream) {
  if (channels != 3) return ERR_CHANNELS;
  if (num_tiles <= 0) return 0;
  raster3d_fwd<3><<<num_tiles, PIX, 0, (cudaStream_t)stream>>>(
      conic, center, colors, depth, opac, pair_gid, tile_start, tile_count,
      grid_x, cap, T_out, C_out, D_out, n_walk, work);
  return (int)cudaGetLastError();
}

extern "C" int raster3d_bwd_launch(const float* conic, const float* center,
                                   const float* colors, const float* depth,
                                   const float* opac, const int* pair_gid,
                                   const int* tile_start, int num_tiles,
                                   int grid_x, int channels,
                                   const float* T_fin, const int* n_walk,
                                   const float* gT, const float* gC,
                                   const float* gD, float* d_conic,
                                   float* d_center, float* d_colors,
                                   float* d_depth, float* d_opac,
                                   void* stream) {
  if (channels != 3) return ERR_CHANNELS;
  if (num_tiles <= 0) return 0;
  raster3d_bwd<3><<<num_tiles, PIX, 0, (cudaStream_t)stream>>>(
      conic, center, colors, depth, opac, pair_gid, tile_start, grid_x,
      T_fin, n_walk, gT, gC, gD, d_conic, d_center, d_colors, d_depth,
      d_opac);
  return (int)cudaGetLastError();
}

extern "C" const char* raster3d_error_string(int code) {
  if (code == ERR_CHANNELS)
    return "raster3d kernels are built for C = 3 colour channels only";
  return cudaGetErrorString((cudaError_t)code);
}
