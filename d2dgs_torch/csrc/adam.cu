// Adam's update of one parameter group in one launch (Hopper, sm_90a):
// for every leaf (p, g, m, v, lr) of the group and every element,
//   m = m * b1 + (1 - b1) * g
//   v = v * b2 + (1 - b2) * (g * g)
//   p = p - lr * (m / c1) / (sqrt(v / c2) + eps),
// with c1 = 1 - b1^t and c2 = 1 - b2^t at the group's step count t.
//
// It replaces no TPU kernel: the JAX package's Adam (d2dgs_tpu/train/
// optim.py) is plain XLA, fused by the compiler.  The port's plain version,
// `_plain_leaves` in d2dgs_torch/train/optim.py, runs about 14 aten
// launches a leaf and copies b1 and b2 from host memory for the bias
// corrections; on the card a step is bound by the host, so those launches
// and waits were its cost, not the card's time.
//
// The work is bound by memory: each element reads p, g, m, v and writes p,
// m, v, 28 bytes.  Design:
//  - One launch takes up to MAX_LEAVES leaves, their pointers, sizes and
//    learning rates in the kernel's parameter block (`AdamLeaves`, passed by
//    value), so no table is copied to the card and nothing is cached
//    there: densify and prune may reallocate a leaf between two steps.
//    The wrapper splits a longer leaf list into several launches.
//  - Each leaf is cut into tiles of TILE elements; the grid (at most
//    BLOCKS_PER_SM blocks an SM) walks the tiles of all leaves in order,
//    so a block finds a tile's leaf by advancing one index.  A full tile
//    whose leaf's pointers are 16-byte aligned moves as one float4 a
//    thread per array; the rest element by element.  Every load of a tile
//    is issued before its first store.
//  - The step count is read from device memory (the group's 0-d int32
//    count, already advanced), and each thread computes c1 and c2 itself,
//    so the host neither reads nor copies anything.
//  - A missing gradient (a null pointer) counts as zero: the moments
//    still decay and the parameter still moves.
// Every operation rounds as the plain version's aten ops round: each
// product, quotient, square root and sum is its own IEEE float32 operation
// (the `__f*_rn` intrinsics, never contracted into a multiply-add), the
// Python scalars arrive as float32 as aten casts them, and the bias
// corrections use `powf`, as aten's `pow` does on float32 tensors.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

constexpr int MAX_LEAVES = 64;     // leaves a launch (the parameter block)

// The leaf list of one launch (outside the unnamed namespace: the exported
// launcher takes it).  tile_end[k] is the number of tiles of leaves 0..k;
// adam_launch fills it from numel.
struct AdamLeaves {
  float* p[MAX_LEAVES];
  const float* g[MAX_LEAVES];      // null: a missing gradient, read as 0
  float* m[MAX_LEAVES];
  float* v[MAX_LEAVES];
  long long numel[MAX_LEAVES];
  int tile_end[MAX_LEAVES];
  float lr[MAX_LEAVES];
  int n;
};

namespace {

constexpr int THREADS = 256;
constexpr int ILP = 4;             // elements a thread per tile
constexpr int TILE = THREADS * ILP;
constexpr int BLOCKS_PER_SM = 8;

struct Consts {
  float b1, b2, omb1, omb2, eps;   // omb = 1 - b, rounded from a double
};

// 1 - b^t, as `1.0 - torch.pow(torch.tensor(b), t)` computes it
__device__ __forceinline__ float correction(float b, int count) {
  return __fsub_rn(1.0f, powf(b, __int2float_rn(count)));
}

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       float lr, float c1, float c2,
                                       const Consts& s) {
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(s.omb2, __fmul_rn(g, g)));
  const float num = __fmul_rn(lr, __fdiv_rn(m, c1));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), s.eps);
  p = __fsub_rn(p, __fdiv_rn(num, den));
}

__global__ void __launch_bounds__(THREADS)
adam_kernel(const __grid_constant__ AdamLeaves leaves,
            const int* __restrict__ count, const Consts s) {
  const int t = __ldg(count);
  const float c1 = correction(s.b1, t), c2 = correction(s.b2, t);
  const int tiles = leaves.tile_end[leaves.n - 1];
  int k = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    while (leaves.tile_end[k] <= tile) ++k;
    const long long base =
        (long long)(tile - (k ? leaves.tile_end[k - 1] : 0)) * TILE;
    const long long numel = leaves.numel[k];
    float* p = leaves.p[k];
    const float* g = leaves.g[k];
    float* m = leaves.m[k];
    float* v = leaves.v[k];
    const float lr = leaves.lr[k];
    const uintptr_t addr = (uintptr_t)p | (uintptr_t)g | (uintptr_t)m
                           | (uintptr_t)v;
    const bool vec = base + TILE <= numel && (addr & 15u) == 0;
    float rp[ILP], rg[ILP], rm[ILP], rv[ILP];
    if (vec) {              // elements base + 4 * thread + 0..3
      const long long i = (base >> 2) + threadIdx.x;
      const float4 p4 = reinterpret_cast<const float4*>(p)[i];
      const float4 m4 = reinterpret_cast<const float4*>(m)[i];
      const float4 v4 = reinterpret_cast<const float4*>(v)[i];
      const float4 g4 = g ? reinterpret_cast<const float4*>(g)[i]
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      rp[0] = p4.x; rp[1] = p4.y; rp[2] = p4.z; rp[3] = p4.w;
      rm[0] = m4.x; rm[1] = m4.y; rm[2] = m4.z; rm[3] = m4.w;
      rv[0] = v4.x; rv[1] = v4.y; rv[2] = v4.z; rv[3] = v4.w;
      rg[0] = g4.x; rg[1] = g4.y; rg[2] = g4.z; rg[3] = g4.w;
    } else {                // elements base + j * THREADS + thread
#pragma unroll
      for (int j = 0; j < ILP; ++j) {
        const long long i = base + j * THREADS + threadIdx.x;
        const bool in = i < numel;
        rp[j] = in ? p[i] : 0.0f;
        rm[j] = in ? m[i] : 0.0f;
        rv[j] = in ? v[i] : 0.0f;
        rg[j] = in && g ? g[i] : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < ILP; ++j)
      update(rp[j], rg[j], rm[j], rv[j], lr, c1, c2, s);
    if (vec) {
      const long long i = (base >> 2) + threadIdx.x;
      reinterpret_cast<float4*>(p)[i] =
          make_float4(rp[0], rp[1], rp[2], rp[3]);
      reinterpret_cast<float4*>(m)[i] =
          make_float4(rm[0], rm[1], rm[2], rm[3]);
      reinterpret_cast<float4*>(v)[i] =
          make_float4(rv[0], rv[1], rv[2], rv[3]);
    } else {
#pragma unroll
      for (int j = 0; j < ILP; ++j) {
        const long long i = base + j * THREADS + threadIdx.x;
        if (i < numel) {
          p[i] = rp[j];
          m[i] = rm[j];
          v[i] = rv[j];
        }
      }
    }
  }
}

// out[0] = c1, out[1] = c2 at the count in device memory: the kernel's
// bias corrections, for the tests.
__global__ void adam_corrections_kernel(const int* __restrict__ count,
                                        float b1, float b2,
                                        float* __restrict__ out) {
  const int t = *count;
  out[0] = correction(b1, t);
  out[1] = correction(b2, t);
}

}  // namespace

extern "C" int adam_max_leaves() { return MAX_LEAVES; }

extern "C" int adam_leaves_bytes() { return (int)sizeof(AdamLeaves); }

// One launch over leaves->n leaves (1..MAX_LEAVES) at the int32 count in
// device memory.  Returns a CUDA error code.
extern "C" int adam_launch(const AdamLeaves* leaves, const int* count,
                           float b1, float b2, float omb1, float omb2,
                           float eps, void* stream) {
  AdamLeaves list = *leaves;
  if (list.n < 1 || list.n > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  long long tiles = 0;
  for (int k = 0; k < list.n; ++k) {
    if (list.numel[k] < 0) return (int)cudaErrorInvalidValue;
    tiles += (list.numel[k] + TILE - 1) / TILE;
    if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
    list.tile_end[k] = (int)tiles;
  }
  if (tiles == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long most = (long long)sms * BLOCKS_PER_SM;
  const int blocks = (int)(tiles < most ? tiles : most);
  adam_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      list, count, Consts{b1, b2, omb1, omb2, eps});
  return (int)cudaGetLastError();
}

extern "C" int adam_corrections_launch(const int* count, float b1, float b2,
                                       float* out, void* stream) {
  adam_corrections_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(count, b1, b2,
                                                              out);
  return (int)cudaGetLastError();
}

extern "C" const char* adam_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
