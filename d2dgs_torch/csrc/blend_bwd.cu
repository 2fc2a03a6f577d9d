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
//    An optional `gtile` [T] (null: the identity) gives each output slot's
//    place in the image grid, as the TPU kernel's `gtile_ref` does, for a
//    slab of tiles taken from a larger grid (the sharded render's
//    interleaved tiles, d2dgs_torch/parallel/gauss_shard.py); only the
//    pixel coordinates read it.
//  * K4, `blend_dense_bwd_launch`, replaces `_bwd_kernel` (launcher
//    `_bwd_call`, the VJP of the dense (tile, chunk) grid).  Tile t's i-th
//    pair is row t * tile_cap + i of gdata and of d_gdata [T, tile_cap,
//    NFEAT]; that row belongs to one work item, so it is stored without
//    atomics, and rows past the slowest pixel's last blended pair (past
//    counts[t] among them) keep the zeros the wrapper wrote.  The
//    cross-tile sum per Gaussian is autograd's transpose of the build_gdata
//    gather, outside the kernel, as XLA's is in the JAX package.  The plain
//    version is `blend_dense_plain_vjp` in d2dgs_torch/ops/cuda/blend_dense.py.
// Both compute per-pair feature gradients with the same arithmetic.
//
// What bounded the per-tile walk this replaces: one tile.  One CTA walked
// each tile's pairs back to front, so the kernel lasted as long as its
// busiest tile (on an 800x800 view, a tile of ~1,900 pairs walked for
// ~1.9 ms, the whole launch, at ~1 us per pair, while 2,034 of the 2,500
// tiles had nothing to walk).  The suffix sums that chain a pixel's walk
// have a closed form in the forward state at a boundary e and the final
// state (pairs [0, e) blended, then all):
//   sum_w  = T_e - T_f,   sum_wm = D1_f - D1_e,
//   Q_e    = gT T_f + g_c.(C_f - C_e) + g_n.(N_f - N_e)
//            + g_depth (Dep_f - Dep_e)
//            + g_dist [(Dist_f - Dist_e) - (D1_f - D1_e)^2 - T_f (D2_f - D2_e)]
//            + g_med_w W_med [median >= e],
// so with the forward's checkpoints at every SEG-th pair (blend_fwd.cu)
// each SEG-pair segment of a tile walks on its own.
//
// Shape: one CTA per work item (tile, segment s), one thread per pixel.
// The wrapper's item list gives every tile max(1, ceil(count / SEG))
// items, tile by tile (ordering them by the tiles' pair counts moved
// nothing: the items of ~1,000 full segments keep every SM busy); an
// item whose segment starts at or past the tile's walk length (its
// slowest pixel's last blended pair + 1) exits at once.  An item stages
// its <= SEG feature rows in shared memory once, takes its post-state
// from the checkpoint at the segment's end (the final state rows for the
// tile's last segment) and its suffix sums from the closed form, and
// walks back to the segment's start.  Each pixel re-evaluates the ray-splat response
// of every pair up to its own last blended pair (the same operations in
// the same order as blend_fwd.cu, so the same alpha and skip decisions),
// and for each blended pair:
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
// The 18 gradients of a pair are summed over the warp by a reduce-scatter
// (20 shuffles, after which 18 lanes hold one feature's sum each).  In K2
// those 18 lanes add their sums to the pair's depth-ordered row with one
// global atomicAdd each (summed over tiles, which replaces the TPU's
// scatter-add transpose of the pair gather); adding them per item in
// shared memory first was slower (PERF.md).  K4 adds the warp sums of
// its 8 warps in shared memory and stores the item's rows once at the
// end.  A warp in which no pixel blended the pair skips the sum.
//
// What bounds it now: the SMs' issue rate over all items (the work is the
// same as the per-tile walk's, spread over ~1,300 items instead of ~470
// tiles), and a tail of one SEG-pair item.  Bytes are small: the feature
// rows, the pair ranks (K2), per pixel and item the state, checkpoint and
// cotangent rows, and K2's atomics; K4 has no atomics but its
// [T, tile_cap, NFEAT] output, zeroed by the wrapper, which bounds it by
// bytes.
//
// The cotangents of the done, final dist1, final dist2 and counter rows
// are taken as zero, as the TPU kernel does (nothing downstream reads
// them).  Built with -fmad=false like the forward, so both passes make
// identical alpha decisions.  Atomics sum in an order that varies from run
// to run.
//
// Optional ``n_reduce`` counts the (warp, pair) sums issued; it sizes the
// byte count of the kernel's bound.  Optional ``item_ns`` [I, 2] receives
// each item's %globaltimer stamps at its start and end.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;   // threads per CTA
constexpr int NFEAT = 18;          // Tmat(9) center(2) normal(3) color(3) opacity(1)
constexpr int NSTATE = 16;
constexpr int NREC = 2;            // forward records: last, median
constexpr int SEG = 256;           // pairs per segment: blend_fwd.cu's BATCH
constexpr int NCKPT = 11;          // checkpoint rows (blend_fwd.cu)
constexpr unsigned FULL_MASK = 0xffffffffu;

constexpr float FILTER_INV_SQUARE = 2.0f;
constexpr float ALPHA_CLIP = 0.99f;
constexpr float ALPHA_CUTOFF = 1.0f / 255.0f;
constexpr float NEAR_PLANE = 0.2f;
constexpr float FAR_PLANE = 100.0f;
constexpr float FAR_X_NEAR = 20.0f;        // FAR_PLANE * NEAR_PLANE
constexpr float FAR_MINUS_NEAR = 99.8f;    // FAR_PLANE - NEAR_PLANE

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One step of the warp's reduce-scatter: of the K values v[0..K) (the
// same features in every lane), the lane whose ``hi`` bit is set keeps
// the upper H (zero past K) and its partner o lanes away the lower H,
// each adding the partner's share.
template <int K, int H>
__device__ __forceinline__ void halve(float (&v)[NFEAT], bool hi, int o) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo_v = v[i];
    const float hi_v = i + H < K ? v[i + H] : 0.0f;
    const float keep = hi ? hi_v : lo_v;
    v[i] = keep + __shfl_xor_sync(FULL_MASK, hi ? lo_v : hi_v, o);
  }
}

// Sums the NFEAT values of every lane over the warp in 20 shuffles (not
// the 90 of one butterfly per feature): afterwards v[0] of lane l holds
// the warp sum of feature warp_feature(l), and 18 lanes add their
// feature to the output at once.
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[NFEAT],
                                                    int lane) {
  halve<18, 9>(v, lane & 16, 16);
  halve<9, 5>(v, lane & 8, 8);
  halve<5, 3>(v, lane & 4, 4);
  halve<3, 2>(v, lane & 2, 2);
  halve<2, 1>(v, lane & 1, 1);
}

// The feature whose sum lane l holds after warp_reduce_scatter, or -1
// (the lanes that hold padding).
__device__ __forceinline__ int warp_feature(int lane) {
  const int p3 = 2 * ((lane >> 1) & 1) + (lane & 1);      // of 3
  const int p2 = 3 * ((lane >> 2) & 1) + p3;              // of 5
  const int p1 = 5 * ((lane >> 3) & 1) + p2;              // of 9
  return p3 < 3 && p2 < 5 && p1 < 9 ? 9 * ((lane >> 4) & 1) + p1 : -1;
}

// Row policies, as in blend_fwd.cu: `base(t)` once per tile, then
// `row(base, i)` is the row of the tile's i-th pair in the feature and
// gradient arrays.  `kStore`: the rows belong to one tile, so an item
// stores its summed gradients; otherwise it adds them atomically.
struct RankedRows {            // K2: sorted features through pair ranks
  const int* pair_rank;    // [B]
  const int* tile_start;   // [T]
  static constexpr bool kStore = false;
  __device__ int base(int t) const { return tile_start[t]; }
  __device__ int row(int b, int i) const { return pair_rank[b + i]; }
};

struct DenseRows {             // K4: the tile's own slab [tile_cap, NFEAT]
  int cap;                 // tile_cap
  static constexpr bool kStore = true;
  __device__ int base(int t) const { return t * cap; }
  __device__ int row(int b, int i) const { return b + i; }
};

// At least 3 CTAs per SM: left free, ptxas held K4's instantiation to 64
// registers and spilled.
template <class Rows>
__global__ void __launch_bounds__(PIX, 3)
blend_bwd_kernel(const float* __restrict__ feats,      // rows of NFEAT
                 Rows rows_of,
                 int grid_x,
                 const int* __restrict__ gtile,        // [T] or null
                 const int* __restrict__ items,        // [I, 2]
                 const int* __restrict__ ckpt_off,     // [T]
                 const float* __restrict__ ckpt,       // [n_bound, NCKPT, PIX]
                 const float* __restrict__ state,      // [T, NSTATE, PIX]
                 const int* __restrict__ records,      // [T, NREC, PIX]
                 const float* __restrict__ g_state,    // [T, NSTATE, PIX]
                 float* __restrict__ d_feats,          // like feats, zeroed
                 unsigned long long* __restrict__ n_reduce,
                 long long* __restrict__ item_ns)      // [I, 2] or null
{
  __shared__ int s_row[SEG];
  __shared__ float s_feat[SEG * NFEAT];
  __shared__ float s_grad[Rows::kStore ? SEG * NFEAT : 1];
  __shared__ int s_walk;
  __shared__ unsigned int s_reduce;

  const int item = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int feat = warp_feature(lane);
  long long t_start = 0;
  if (item_ns != nullptr && tid == 0) t_start = global_ns();
  const int tile = items[2 * item];
  const int seg = items[2 * item + 1];
  // the slot's place in the image grid (a sharded slab's global tile)
  const int gt = gtile != nullptr ? gtile[tile] : tile;
  const float px = (float)((gt % grid_x) * TILE + (tid % TILE)) + 0.5f;
  const float py = (float)((gt / grid_x) * TILE + (tid / TILE)) + 0.5f;
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
  const int s0 = seg * SEG;        // the segment: pairs [s0, s1)
  const int s1 = min(s0 + SEG, n_walk);
  if (s0 < n_walk) {               // CTA-uniform
    const int nb = s1 - s0;
    const int start = rows_of.base(tile);
    if (tid < nb) s_row[tid] = rows_of.row(start, s0 + tid);
    if (Rows::kStore)
      for (int k = tid; k < nb * NFEAT; k += PIX) s_grad[k] = 0.f;
    __syncthreads();
    for (int k = tid; k < nb * NFEAT; k += PIX) {
      const int r = k / NFEAT;
      s_feat[k] = feats[(size_t)s_row[r] * NFEAT + (k - r * NFEAT)];
    }

    const float* st = state + (size_t)tile * NSTATE * PIX + tid;
    const float* gs = g_state + (size_t)tile * NSTATE * PIX + tid;
    const float gT = gs[0];
    const float gc0 = gs[4 * PIX], gc1 = gs[5 * PIX], gc2 = gs[6 * PIX];
    const float g_depth = gs[7 * PIX];
    const float gn0 = gs[8 * PIX], gn1 = gs[9 * PIX], gn2 = gs[10 * PIX];
    const float g_dist = gs[11 * PIX];
    const float g_med_d = gs[12 * PIX], g_med_w = gs[13 * PIX];
    // running post-blend state, rebuilt backwards pair by pair: the final
    // state for the tile's last segment
    float T = st[0], D1 = st[2 * PIX], D2 = st[3 * PIX];
    // suffix sums over the later blended pairs
    float sum_w = 0.f, sum_wm = 0.f;
    float Q = gT * T;                // transmittance adjoint (T-output term)
    if (s1 < n_walk) {               // CTA-uniform: a checkpoint ends it
      const float* ck = ckpt + (size_t)(ckpt_off[tile] + seg) * NCKPT * PIX
          + tid;
      const float Te = ck[0], D1e = ck[PIX], D2e = ck[2 * PIX];
      sum_w = Te - T;
      sum_wm = D1 - D1e;
      Q += gc0 * (st[4 * PIX] - ck[3 * PIX])
          + gc1 * (st[5 * PIX] - ck[4 * PIX])
          + gc2 * (st[6 * PIX] - ck[5 * PIX])
          + g_depth * (st[7 * PIX] - ck[6 * PIX])
          + gn0 * (st[8 * PIX] - ck[7 * PIX])
          + gn1 * (st[9 * PIX] - ck[8 * PIX])
          + gn2 * (st[10 * PIX] - ck[9 * PIX])
          + g_dist * ((st[11 * PIX] - ck[10 * PIX]) - sum_wm * sum_wm
                      - T * (D2 - D2e))
          + (med >= s1 ? g_med_w * st[13 * PIX] : 0.0f);
      T = Te;
      D1 = D1e;
      D2 = D2e;
    }
    __syncthreads();

    for (int j = nb - 1; j >= 0; --j) {
      const float* f = s_feat + j * NFEAT;
      float g[NFEAT];
#pragma unroll
      for (int q = 0; q < NFEAT; ++q) g[q] = 0.f;
      bool blended = false;
      if (s0 + j <= last) {
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
            const bool is_med = s0 + j == med;
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
      // warp sum, then 18 lanes add one feature each (warp-uniform
      // branch)
      if (__ballot_sync(FULL_MASK, blended) != 0u) {
        warp_reduce_scatter(g, lane);
        if (feat >= 0) {
          if (Rows::kStore)
            atomicAdd(s_grad + j * NFEAT + feat, g[0]);
          else
            atomicAdd(d_feats + (size_t)s_row[j] * NFEAT + feat, g[0]);
        }
        if (lane == 0 && n_reduce != nullptr) atomicAdd(&s_reduce, 1u);
      }
    }
    if (Rows::kStore) {              // the item's rows, contiguous
      __syncthreads();
      float* out = d_feats + (size_t)s_row[0] * NFEAT;
      for (int k = tid; k < nb * NFEAT; k += PIX) out[k] = s_grad[k];
    }
  }
  if (n_reduce != nullptr) {
    __syncthreads();
    if (tid == 0 && s_reduce != 0u)
      atomicAdd(n_reduce, (unsigned long long)s_reduce);
  }
  if (item_ns != nullptr) {
    __syncthreads();
    if (tid == 0) {
      item_ns[2 * item] = t_start;
      item_ns[2 * item + 1] = global_ns();
    }
  }
}

}  // namespace

extern "C" int blend_bwd_launch(const float* feats, const int* pair_rank,
                                const int* tile_start, int num_items,
                                int grid_x, const int* gtile,
                                const int* items, const int* ckpt_off,
                                const float* ckpt,
                                const float* state, const int* records,
                                const float* g_state, float* d_feats,
                                unsigned long long* n_reduce,
                                long long* item_ns, void* stream) {
  if (num_items <= 0) return 0;
  blend_bwd_kernel<RankedRows><<<num_items, PIX, 0, (cudaStream_t)stream>>>(
      feats, RankedRows{pair_rank, tile_start}, grid_x, gtile, items,
      ckpt_off, ckpt, state, records, g_state, d_feats, n_reduce, item_ns);
  return (int)cudaGetLastError();
}

extern "C" int blend_dense_bwd_launch(const float* gdata, int tile_cap,
                                      int num_items, int grid_x,
                                      const int* items,
                                      const int* ckpt_off, const float* ckpt,
                                      const float* state, const int* records,
                                      const float* g_state, float* d_gdata,
                                      unsigned long long* n_reduce,
                                      long long* item_ns, void* stream) {
  if (num_items <= 0) return 0;
  blend_bwd_kernel<DenseRows><<<num_items, PIX, 0, (cudaStream_t)stream>>>(
      gdata, DenseRows{tile_cap}, grid_x, nullptr, items, ckpt_off, ckpt,
      state, records, g_state, d_gdata, n_reduce, item_ns);
  return (int)cudaGetLastError();
}

extern "C" const char* blend_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
