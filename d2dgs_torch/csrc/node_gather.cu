// The backward of the node warp's K-neighbour gather out[n, k, :] =
// table[idx[n, k], :]: grad_table[m] = sum over (n, k) with idx[n, k] = m
// of g[n, k, :] (Hopper, sm_90a).  The forward is aten's indexing.
//
// It replaces no TPU kernel: the JAX package blends the node deltas with a
// dense [N, M] weight matrix (d2dgs_tpu/models/nodes.py), a TPU layout
// choice that the port turned into a K-row gather (d2dgs_torch/models/
// nodes.py, `cal_nn_weight` and `warp`).  Through aten's advanced indexing
// that gather's backward was most of a node training step on the card:
// aten sorts the indices, then one warp walks each run of equal indices
// alone, and the capacity's dead rows, which all sit at one position and
// bind to the same three nodes, make three runs of ~117,000 entries each.
// Their gradient rows are exactly zero.  The plain PyTorch version is
// `scatter_rows_plain` in d2dgs_torch/ops/cuda/node_gather.py.
//
// Two launches, with no sort and no float atomics, so that the same inputs
// give the same bits on every run:
//  (a) `gather_bwd_accumulate`: a grid of B blocks (about two per SM).
//      Block b walks a contiguous slab of the N*K entries in rounds of
//      BATCH: the round's gradient rows are staged in shared memory by
//      coalesced loads, each entry whose row is all zero is dropped (adding
//      +0 changes no sum, so this is exact), and the rest are added into a
//      zero-filled [M, C] float tile in shared memory.  Warp w owns the
//      tile's columns c = w, w + 8, ..., so no two warps write one word;
//      within a warp the lanes that carry the same node are merged first
//      (`__match_any_sync`, then a shuffle tree in lane order), and the
//      lowest lane of each group adds the group's sum, so a pile-up on one
//      node costs one shared-memory add per distinct node per 32 entries.
//      An index outside [0, M) is dropped too: nothing outside the tile is
//      read or written.  The block then stores its tile into partials
//      [B, M, C].
//  (b) `gather_bwd_reduce`: each output word sums its B partials in a
//      fixed order (eight contiguous runs of blocks, then the eight run
//      sums in order).
// Where M*C floats and the staging do not fit the shared memory one block
// may take (227 KB opt-in on the H100), the columns are split across
// blockIdx.y; the split follows from M, C and the device alone.  Where
// even one column of M rows does not fit (M above ~57,000), the plan says
// so and the wrapper refuses the call.
// While `n_rows` is given (the port's trace is on), (a) adds to it the
// entries it accumulated: those in range whose gradient row is not all
// zero.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;        // both backward kernels
constexpr int WARPS = THREADS / 32;
constexpr int BATCH = 256;          // entries staged per round of (a)
constexpr int RUNS = 8;             // (b): runs of blocks per output word
constexpr unsigned FULL = 0xffffffffu;

// shared bytes of (a) for a tile of m rows by cb columns
__host__ __device__ inline long long accumulate_smem(int m, int cb) {
  return ((long long)m * cb + (long long)BATCH * cb) * 4 + BATCH * 4;
}

// The sum of x over the lanes of `peers` (the lanes whose key equals this
// lane's), complete in the group's lowest lane: a binary tree over the
// group's lanes in lane order (Westphal's reduce_peers).  Every lane of
// the warp calls it.
__device__ inline float reduce_peers(unsigned peers, float x, int lane) {
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned higher = peers & (0xfffffffeu << lane);
  while (__any_sync(FULL, higher != 0u)) {
    const int next = __ffs(higher);          // the next remaining peer + 1
    const float t = __shfl_sync(FULL, x, (next - 1) & 31);
    if (next) x += t;
    higher &= ~__ballot_sync(FULL, rank & 1);
    rank >>= 1;
  }
  return x;
}

// (a).  Block (b, y) takes entries [b * per_block, (b + 1) * per_block)
// and columns [y * cb, y * cb + ncol).
__global__ void __launch_bounds__(THREADS)
gather_bwd_accumulate(const float* __restrict__ g,
                      const long long* __restrict__ idx, long long n_entries,
                      int M, int C, int cb, long long per_block,
                      float* __restrict__ partials,
                      unsigned long long* __restrict__ n_rows) {
  extern __shared__ float smem[];
  const int c0 = blockIdx.y * cb, ncol = min(cb, C - c0);
  float* tile = smem;                                  // [M][ncol]
  float* stage = tile + (long long)M * cb;             // [BATCH][ncol]
  int* key = reinterpret_cast<int*>(stage + BATCH * cb);   // [BATCH]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool whole_rows = ncol == C;
  const bool counting = n_rows != nullptr && blockIdx.y == 0;
  for (int i = tid; i < M * ncol; i += THREADS) tile[i] = 0.0f;
  const long long e_begin = blockIdx.x * per_block;
  const long long e_end = min(n_entries, e_begin + per_block);
  unsigned counted = 0;
  for (long long e0 = e_begin; e0 < e_end; e0 += BATCH) {
    const int n = (int)min((long long)BATCH, e_end - e0);
    __syncthreads();            // the last round has read stage and key
    long long m = tid < n ? __ldg(idx + e0 + tid) : -1;
    if (whole_rows) {
      const float* src = g + e0 * C;
#pragma unroll 4
      for (int i = tid; i < n * C; i += THREADS) stage[i] = __ldg(src + i);
    } else {
#pragma unroll 4
      for (int i = tid; i < n * ncol; i += THREADS) {
        const int r = i / ncol;
        stage[i] = __ldg(g + (e0 + r) * C + c0 + (i - r * ncol));
      }
    }
    __syncthreads();
    if (tid < n) {
      bool nonzero = false;
      for (int c = 0; c < ncol; ++c) nonzero |= stage[tid * ncol + c] != 0.0f;
      const bool in_range = m >= 0 && m < M;
      key[tid] = nonzero && in_range ? (int)m : -1;
      if (counting && in_range) {
        if (!whole_rows) {      // the row's other columns, from memory
          const float* row = g + (e0 + tid) * C;
          for (int c = 0; c < C && !nonzero; ++c) nonzero = row[c] != 0.0f;
        }
        counted += nonzero;
      }
    }
    __syncthreads();
    for (int s = 0; s < n; s += 32) {
      const int j = s + lane;
      const int k = j < n ? key[j] : -1;
      if (!__any_sync(FULL, k >= 0)) continue;
      const unsigned peers = __match_any_sync(FULL, k);
      const bool leader = k >= 0 && lane == __ffs(peers) - 1;
      for (int c = warp; c < ncol; c += WARPS) {
        const float v = reduce_peers(peers, k >= 0 ? stage[j * ncol + c]
                                                   : 0.0f, lane);
        if (leader) tile[k * ncol + c] += v;
      }
    }
  }
  __syncthreads();
  float* dst = partials + (long long)blockIdx.x * M * C;
  for (int i = tid; i < M * ncol; i += THREADS) {
    const int r = i / ncol;
    dst[(long long)r * C + c0 + (i - r * ncol)] = tile[i];
  }
  if (counting) {
    const unsigned w = __reduce_add_sync(FULL, counted);
    if (lane == 0 && w) atomicAdd(n_rows, (unsigned long long)w);
  }
}

// (b).  Word i of grad = sum over blocks of partials[b][i]: thread (run r,
// lane) sums run r's blocks in order, then the first warp adds the RUNS
// run sums in order.
__global__ void __launch_bounds__(THREADS)
gather_bwd_reduce(const float* __restrict__ partials, int blocks,
                  long long words, float* __restrict__ grad) {
  __shared__ float run_sum[RUNS][32];
  const int lane = threadIdx.x & 31, run = threadIdx.x >> 5;
  const long long i = blockIdx.x * 32LL + lane;
  const int b0 = (int)((long long)blocks * run / RUNS);
  const int b1 = (int)((long long)blocks * (run + 1) / RUNS);
  float s = 0.0f;
  if (i < words)
    for (int b = b0; b < b1; ++b) s += __ldg(partials + b * words + i);
  run_sum[run][lane] = s;
  __syncthreads();
  if (run == 0 && i < words) {
    float t = run_sum[0][lane];
#pragma unroll
    for (int r = 1; r < RUNS; ++r) t += run_sum[r][lane];
    grad[i] = t;
  }
}

}  // namespace

// plan[0..2] = (B, Y, cb): the grid, and each block's columns; cb = 0
// where one column of M rows does not fit a block.  Returns a CUDA error
// code.
extern "C" int node_gather_bwd_plan(long long n_entries, int M, int C,
                                    int* plan) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  int cb = C;
  if (accumulate_smem(M, C) > optin)
    cb = (int)std::max(0LL, (optin - BATCH * 4LL)
                                / ((M + (long long)BATCH) * 4));
  plan[0] = plan[1] = plan[2] = 0;
  if (cb < 1) return 0;
  const int y = (C + cb - 1) / cb;
  cb = (C + y - 1) / y;             // even column chunks
  long long b = (2LL * sms + y - 1) / y;
  b = std::max(1LL, std::min(b, (n_entries + BATCH - 1) / BATCH));
  plan[0] = (int)b;
  plan[1] = y;
  plan[2] = cb;
  return 0;
}

// partials: [plan[0], M, C] floats, written whole by (a); grad: [M, C].
extern "C" int node_gather_bwd_launch(const float* g, const long long* idx,
                                      long long n_entries, int M, int C,
                                      const int* plan, float* partials,
                                      float* grad, unsigned long long* n_rows,
                                      void* stream) {
  if (n_entries <= 0 || M <= 0 || C <= 0) return 0;
  const int b = plan[0], y = plan[1], cb = plan[2];
  if (cb < 1) return (int)cudaErrorInvalidValue;
  const long long smem = accumulate_smem(M, cb);
  cudaError_t err = cudaFuncSetAttribute(
      gather_bwd_accumulate, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long per_block = (n_entries + b - 1) / b;
  cudaStream_t s = (cudaStream_t)stream;
  gather_bwd_accumulate<<<dim3(b, y), THREADS, smem, s>>>(
      g, idx, n_entries, M, C, cb, per_block, partials, n_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long words = (long long)M * C;
  gather_bwd_reduce<<<(unsigned)((words + 31) / 32), THREADS, 0, s>>>(
      partials, b, words, grad);
  return (int)cudaGetLastError();
}

extern "C" const char* node_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
