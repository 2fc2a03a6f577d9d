// Backward of the surfel blend over depth-sorted per-tile pair lists
// (Hopper, sm_90a).
//
// Two entry points share one kernel template over where a tile's rows
// come from (the row policies of blend_fwd.cu):
//  * K2, `blend_bwd_launch`, replaces the TPU kernel `_bwd_wq_kernel` of
//    d2dgs_tpu/ops/pallas/blend_tpu.py (launcher `_bwd_wq_call`), which
//    walks each tile's work-queue chunks in reverse, rebuilds every chunk's
//    pre-state from saved carry rows and applies `_chunk_bwd` and
//    `_resp_manual_vjp`.  Tile t's i-th pair is the sorted row
//    `pair_rank[tile_start[t] + i]`, and its gradient is summed into that
//    row of d_feats [N, NFEAT] over pixels and tiles; the plain PyTorch
//    version is `blend_tiles_plain_vjp` in d2dgs_torch/ops/cuda/blend.py.
//  * K4, `blend_dense_bwd_launch`, replaces `_bwd_kernel` (launcher
//    `_bwd_call`, the VJP of the dense (tile, chunk) grid).  Tile t's i-th
//    pair is row t * tile_cap + i of gdata and of d_gdata [T, tile_cap,
//    NFEAT]; that row belongs to one CTA, so there is no contention across
//    CTAs, and rows no pixel blended (past counts[t] among them) keep the
//    zeros the wrapper wrote.  The cross-tile sum per Gaussian is autograd's
//    transpose of the build_gdata gather, outside the kernel, as XLA's is in
//    the JAX package.  The plain version is `blend_dense_plain_vjp` in
//    d2dgs_torch/ops/cuda/blend_dense.py.
// Both compute per-pair feature gradients with the same arithmetic.
//
// Shape: one CTA per 16x16 tile, one thread per pixel.  The CTA walks its
// own rows back to front, from the last blended pair of its slowest pixel,
// staging 256-pair batches of feature rows in shared memory as the forward
// does.  Each pixel re-evaluates the
// ray-splat response of every pair up to its own last blended pair (the
// same operations in the same order as blend_fwd.cu, so the same alpha and
// the same skip decisions), and for each blended pair:
//   * rebuilds the pre-blend state from the post-blend one, as the CUDA
//     reference's backward does: T_before = T_after / (1 - alpha) (alpha is
//     clipped at 0.99, so the division is bounded), dist1 and dist2 by
//     subtracting the pair's own w*m and w*m^2;
//   * keeps the suffix sums of `_chunk_bwd` as running sums in registers:
//     sum(w) and sum(w*m) of the later pairs (the distortion coupling) and
//     Q, the transmittance adjoint of the later pairs plus the T-output
//     term;
//   * takes the median pair from the forward's record (no re-test of
//     T > 0.5, so the median cannot flip between the passes);
//   * applies the response adjoint of `_resp_manual_vjp` (cross-product
//     and homogeneous-division chain).
// The 18 gradients of a pair are summed over the warp with shuffles and
// added to the pair's output row with one atomicAdd per warp and feature
// (K2: the depth-ordered row, summed over tiles, which replaces the TPU's
// scatter-add transpose of the pair gather; K4: the tile's own row, summed
// over the CTA's 8 warps).  A warp in which no pixel blended the pair skips
// the sum.
//
// What bounds it on this card: operations, as the forward (each evaluated
// pair-pixel repeats the forward's response, each blended one adds ~150
// float32 operations of adjoint); the bytes are the feature rows, the pair
// ranks (K2), the saved rows and cotangents per pixel, and the atomics.  K4
// also has its [T, tile_cap, NFEAT] output, zeroed by the wrapper.  The
// design keeps every running sum in registers and reads each feature row
// from device memory once per tile (256-row shared-memory batches).
//
// The cotangents of the done, final dist1, final dist2 and counter rows
// are taken as zero, as the TPU kernel does (nothing downstream reads
// them).  Built with -fmad=false like the forward, so both passes make
// identical alpha decisions.  Atomics sum in an order that varies from run
// to run.
//
// Optional ``n_reduce`` counts the (warp, pair) sums issued (18 atomics
// each); it sizes the byte count of the kernel's bound.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;   // threads per CTA
constexpr int NFEAT = 18;          // Tmat(9) center(2) normal(3) color(3) opacity(1)
constexpr int NSTATE = 16;
constexpr int NREC = 2;            // forward records: last, median
constexpr int BATCH = 256;         // pairs staged per shared-memory batch
constexpr unsigned FULL_MASK = 0xffffffffu;

constexpr float FILTER_INV_SQUARE = 2.0f;
constexpr float ALPHA_CLIP = 0.99f;
constexpr float ALPHA_CUTOFF = 1.0f / 255.0f;
constexpr float NEAR_PLANE = 0.2f;
constexpr float FAR_PLANE = 100.0f;
constexpr float FAR_X_NEAR = 20.0f;        // FAR_PLANE * NEAR_PLANE
constexpr float FAR_MINUS_NEAR = 99.8f;    // FAR_PLANE - NEAR_PLANE

// Row policies, as in blend_fwd.cu: `base(t)` once per tile, then
// `row(base, i)` is the row of the tile's i-th pair in the feature and
// gradient arrays.
struct RankedRows {            // K2: sorted features through pair ranks
  const int* pair_rank;    // [B]
  const int* tile_start;   // [T]
  __device__ int base(int t) const { return tile_start[t]; }
  __device__ int row(int b, int i) const { return pair_rank[b + i]; }
};

struct DenseRows {             // K4: the tile's own slab [tile_cap, NFEAT]
  int cap;                 // tile_cap
  __device__ int base(int t) const { return t * cap; }
  __device__ int row(int b, int i) const { return b + i; }
};

template <class Rows>
__global__ void __launch_bounds__(PIX)
blend_bwd_kernel(const float* __restrict__ feats,      // rows of NFEAT
                 Rows rows_of,
                 int grid_x,
                 const float* __restrict__ state,      // [T, NSTATE, PIX]
                 const int* __restrict__ records,      // [T, NREC, PIX]
                 const float* __restrict__ g_state,    // [T, NSTATE, PIX]
                 float* __restrict__ d_feats,          // like feats, zeroed
                 unsigned long long* __restrict__ n_reduce)
{
  __shared__ int s_row[BATCH];
  __shared__ float s_feat[BATCH * NFEAT];
  __shared__ int s_walk;
  __shared__ unsigned int s_reduce;

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float px = (float)((tile % grid_x) * TILE + (tid % TILE)) + 0.5f;
  const float py = (float)((tile / grid_x) * TILE + (tid / TILE)) + 0.5f;
  const int start = rows_of.base(tile);
  const int* rec = records + (size_t)tile * NREC * PIX + tid;
  const int last = rec[0];
  const int med = rec[PIX];

  if (tid == 0) {
    s_walk = -1;
    s_reduce = 0u;
  }
  __syncthreads();
  atomicMax(&s_walk, last);
  __syncthreads();
  const int n_walk = s_walk + 1;   // pairs up to the slowest pixel's last
  if (n_walk == 0) return;         // CTA-uniform

  const float* st = state + (size_t)tile * NSTATE * PIX + tid;
  const float* gs = g_state + (size_t)tile * NSTATE * PIX + tid;
  // running post-blend state, rebuilt backwards pair by pair
  float T = st[0], D1 = st[2 * PIX], D2 = st[3 * PIX];
  const float gT = gs[0];
  const float gc0 = gs[4 * PIX], gc1 = gs[5 * PIX], gc2 = gs[6 * PIX];
  const float g_depth = gs[7 * PIX];
  const float gn0 = gs[8 * PIX], gn1 = gs[9 * PIX], gn2 = gs[10 * PIX];
  const float g_dist = gs[11 * PIX];
  const float g_med_d = gs[12 * PIX], g_med_w = gs[13 * PIX];
  // suffix sums over the later blended pairs
  float sum_w = 0.f, sum_wm = 0.f;
  float Q = gT * T;                // transmittance adjoint (T-output term)

  for (int b_end = n_walk; b_end > 0; b_end -= BATCH) {
    const int b0 = max(0, b_end - BATCH);
    const int nb = b_end - b0;
    __syncthreads();               // the previous batch is consumed
    if (tid < nb) s_row[tid] = rows_of.row(start, b0 + tid);
    __syncthreads();
    for (int k = tid; k < nb * NFEAT; k += PIX) {
      const int r = k / NFEAT;
      s_feat[k] = feats[(size_t)s_row[r] * NFEAT + (k - r * NFEAT)];
    }
    __syncthreads();

    for (int j = nb - 1; j >= 0; --j) {
      const float* f = s_feat + j * NFEAT;
      float g[NFEAT];
#pragma unroll
      for (int q = 0; q < NFEAT; ++q) g[q] = 0.f;
      bool blended = false;
      if (b0 + j <= last) {
        // ray-splat intersection, exactly as blend_fwd.cu
        const float kx = px * f[6] - f[0];
        const float ky = px * f[7] - f[1];
        const float kz = px * f[8] - f[2];
        const float lx = py * f[6] - f[3];
        const float ly = py * f[7] - f[4];
        const float lz = py * f[8] - f[5];
        const float p_x = ky * lz - kz * ly;
        const float p_y = kz * lx - kx * lz;
        const float p_z = kx * ly - ky * lx;
        if (p_z != 0.0f) {
          const float inv_pz = 1.0f / p_z;
          const float sx = p_x * inv_pz;
          const float sy = p_y * inv_pz;
          const float rho3d = sx * sx + sy * sy;
          const float dx = f[9] - px;
          const float dy = f[10] - py;
          const float rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy);
          const bool use3d = rho3d <= rho2d;
          const float depth = use3d ? sx * f[6] + sy * f[7] + f[8] : f[8];
          const float E = expf(-0.5f * fminf(rho3d, rho2d));
          const float raw = f[17] * E;
          const float alpha = fminf(ALPHA_CLIP, raw);
          blended = depth >= NEAR_PLANE && alpha >= ALPHA_CUTOFF;
          if (blended) {
            // pre-blend state from the post-blend one
            const float om = 1.0f - alpha;
            const float Tb = T / om;
            const float w = alpha * Tb;
            const float safe_d = depth != 0.0f ? depth : 1.0f;
            const float m =
                (FAR_PLANE * depth - FAR_X_NEAR) / (FAR_MINUS_NEAR * safe_d);
            const float wm = w * m;
            const float D1b = D1 - wm;
            const float D2b = D2 - wm * m;
            const float err = m * m * (1.0f - Tb) + D2b - 2.0f * m * D1b;
            const bool is_med = b0 + j == med;
            // w / m / depth cotangents (_chunk_bwd)
            const float S1 = -2.0f * g_dist * sum_wm;
            const float S2 = g_dist * sum_w;
            const float wbar = gc0 * f[14] + gc1 * f[15] + gc2 * f[16]
                + gn0 * f[11] + gn1 * f[12] + gn2 * f[13] + g_depth * depth
                + g_dist * err + m * S1 + m * m * S2
                + (is_med ? g_med_w : 0.0f);
            const float mbar = w * S1 + 2.0f * wm * S2
                + g_dist * w * (2.0f * m * (1.0f - Tb) - 2.0f * D1b);
            const float dm_dd =
                FAR_X_NEAR / (FAR_MINUS_NEAR * safe_d * safe_d);
            const float dbar = g_depth * w + mbar * dm_dd
                + (is_med ? g_med_d : 0.0f);
            // alpha cotangent: own weight, then every later T_before and
            // the output T through T_before = T_after / (1 - alpha)
            const float abar = wbar * Tb - Q / om;
            // response adjoint (_resp_manual_vjp)
            const float raw_bar = raw < ALPHA_CLIP ? abar : 0.0f;
            const float rho_bar = -0.5f * raw_bar * raw;
            const float r3b = use3d ? rho_bar : 0.0f;
            const float r2b = rho_bar - r3b;
            const float dbm = use3d ? dbar : 0.0f;
            const float sx_bar = dbm * f[6] + 2.0f * r3b * sx;
            const float sy_bar = dbm * f[7] + 2.0f * r3b * sy;
            const float pxb = sx_bar * inv_pz;
            const float pyb = sy_bar * inv_pz;
            const float pzb = -(sx_bar * sx + sy_bar * sy) * inv_pz;
            const float kx_b = pzb * ly - pyb * lz;
            const float ky_b = pxb * lz - pzb * lx;
            const float kz_b = pyb * lx - pxb * ly;
            const float lx_b = pyb * kz - pzb * ky;
            const float ly_b = pzb * kx - pxb * kz;
            const float lz_b = pxb * ky - pyb * kx;
            g[0] = -kx_b;
            g[1] = -ky_b;
            g[2] = -kz_b;
            g[3] = -lx_b;
            g[4] = -ly_b;
            g[5] = -lz_b;
            g[6] = kx_b * px + lx_b * py + dbm * sx;
            g[7] = ky_b * px + ly_b * py + dbm * sy;
            g[8] = kz_b * px + lz_b * py + dbar;
            g[9] = 2.0f * FILTER_INV_SQUARE * r2b * dx;
            g[10] = 2.0f * FILTER_INV_SQUARE * r2b * dy;
            g[11] = w * gn0;
            g[12] = w * gn1;
            g[13] = w * gn2;
            g[14] = w * gc0;
            g[15] = w * gc1;
            g[16] = w * gc2;
            g[17] = raw_bar * E;
            // step the running sums to this pair's pre-blend values
            Q += wbar * w - g_dist * wm * m * Tb;
            sum_w += w;
            sum_wm += wm;
            T = Tb;
            D1 = D1b;
            D2 = D2b;
          }
        }
      }
      // warp sum, then one atomic per feature (warp-uniform branch)
      if (__ballot_sync(FULL_MASK, blended) != 0u) {
#pragma unroll
        for (int q = 0; q < NFEAT; ++q) {
          float v = g[q];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            v += __shfl_down_sync(FULL_MASK, v, o);
          if (lane == 0)
            atomicAdd(d_feats + (size_t)s_row[j] * NFEAT + q, v);
        }
        if (lane == 0 && n_reduce != nullptr) atomicAdd(&s_reduce, 1u);
      }
    }
  }
  if (n_reduce != nullptr) {
    __syncthreads();
    if (tid == 0 && s_reduce != 0u)
      atomicAdd(n_reduce, (unsigned long long)s_reduce);
  }
}

}  // namespace

extern "C" int blend_bwd_launch(const float* feats, const int* pair_rank,
                                const int* tile_start, int num_tiles,
                                int grid_x, const float* state,
                                const int* records, const float* g_state,
                                float* d_feats, unsigned long long* n_reduce,
                                void* stream) {
  if (num_tiles <= 0) return 0;
  blend_bwd_kernel<RankedRows><<<num_tiles, PIX, 0, (cudaStream_t)stream>>>(
      feats, RankedRows{pair_rank, tile_start}, grid_x, state, records,
      g_state, d_feats, n_reduce);
  return (int)cudaGetLastError();
}

extern "C" int blend_dense_bwd_launch(const float* gdata, int tile_cap,
                                      int num_tiles, int grid_x,
                                      const float* state, const int* records,
                                      const float* g_state, float* d_gdata,
                                      unsigned long long* n_reduce,
                                      void* stream) {
  if (num_tiles <= 0) return 0;
  blend_bwd_kernel<DenseRows><<<num_tiles, PIX, 0, (cudaStream_t)stream>>>(
      gdata, DenseRows{tile_cap}, grid_x, state, records, g_state, d_gdata,
      n_reduce);
  return (int)cudaGetLastError();
}

extern "C" const char* blend_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
