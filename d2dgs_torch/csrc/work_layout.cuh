// The work lists of the segment-parallel forward kernels, K1/K3
// (blend_fwd.cu) and K5 (raster3d.cu), built on the card by one CTA.
//
// A tile of c pairs (c = min(tile_count, cap)) has max(1, ceil(c / SEG))
// work items, one per SEG-pair segment, listed tile by tile, and
// ceil(c / UNIT) first-pass units; its items are folded by the last one
// to finish (an atomic ticket), which reads the partial states of the
// tiles of more than one item from their slots.  The wrappers size the
// grids from bounds known on the host (ops/cuda/blend.py forward_work),
// so the kernels read nothing back and CTAs past the real lists leave at
// once.  ops/cuda/build.py hashes this header into each library's path.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int SEG = 256;              // pairs per work item (segment)
constexpr int UNIT = 64;              // pairs per first-pass unit
constexpr int UNITS = SEG / UNIT;     // units per segment
constexpr int LAYOUT_THREADS = 1024;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int segments_of(int count) {
  return max(1, (count + SEG - 1) / SEG);
}

// The layout buffer of one launch, int32: item_start [T + 1] (the last
// entry the item total), slot_start [T] (a multi-segment tile's first
// partial slot), arrivals [T] (the fold's tickets), the unit total,
// items [max_items, 2] (tile, segment) and units [max_units, 2] (tile,
// unit k: pairs [k UNIT, (k + 1) UNIT)).
struct Layout {
  int* base;
  int num_tiles;
  int max_items;
  __device__ int total() const { return base[num_tiles]; }
  __device__ int* item_start() const { return base; }
  __device__ int* slot_start() const { return base + num_tiles + 1; }
  __device__ int* arrivals() const { return base + 2 * num_tiles + 1; }
  __device__ int* unit_total() const { return base + 3 * num_tiles + 1; }
  __device__ int* items() const { return base + 3 * num_tiles + 2; }
  __device__ int* units() const { return items() + 2 * max_items; }
};

// The %globaltimer stamps of unit or item `item` (its start and now) into
// ns[item], where a launch asked for them.
__device__ __forceinline__ void stamp(long long* ns, int item, int n_timed,
                                      long long t_start, int tid) {
  if (ns != nullptr && item < n_timed) {
    __syncthreads();
    if (tid == 0) {
      ns[2 * item] = t_start;
      ns[2 * item + 1] = global_ns();
    }
  }
}

// Block-wide exclusive prefix sum of v over the LAYOUT_THREADS threads.
__device__ int block_exclusive(int v, int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(FULL_MASK, inc, o);
    if (lane >= o) inc += x;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int a0 = s_warp[lane];
    int a = a0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(FULL_MASK, a, o);
      if (lane >= o) a += x;
    }
    s_warp[lane] = a - a0;
  }
  __syncthreads();
  const int res = s_warp[warp] + inc - v;
  __syncthreads();
  return res;
}

// One CTA: the work items of every tile, tile by tile, the partial slots
// of the multi-segment tiles and the first pass's units, from block-wide
// exclusive scans of c = min(counts[t], cap); the fold's tickets are
// zeroed.
__global__ void __launch_bounds__(LAYOUT_THREADS)
fwd_layout(const int* __restrict__ counts, int cap, int num_tiles,
           int max_units, Layout lay) {
  __shared__ int s_warp[LAYOUT_THREADS / 32];
  const int tid = threadIdx.x;
  const int per = (num_tiles + LAYOUT_THREADS - 1) / LAYOUT_THREADS;
  const int t0 = min(tid * per, num_tiles);
  const int t1 = min(t0 + per, num_tiles);
  int n_sum = 0, m_sum = 0, u_sum = 0;
  for (int t = t0; t < t1; ++t) {
    const int c = min(counts[t], cap);
    const int n = segments_of(c);
    n_sum += n;
    m_sum += n > 1 ? n : 0;
    u_sum += (c + UNIT - 1) / UNIT;
  }
  int item = block_exclusive(n_sum, s_warp);
  int slot = block_exclusive(m_sum, s_warp);
  int unit = block_exclusive(u_sum, s_warp);
  int* items = lay.items();
  int* units = lay.units();
  for (int t = t0; t < t1; ++t) {
    const int c = min(counts[t], cap);
    const int n = segments_of(c);
    const int u = (c + UNIT - 1) / UNIT;
    lay.item_start()[t] = item;
    lay.slot_start()[t] = slot;
    lay.arrivals()[t] = 0;
    for (int s = 0; s < n && item + s < lay.max_items; ++s) {
      items[2 * (item + s)] = t;
      items[2 * (item + s) + 1] = s;
    }
    for (int k = 0; k < u && unit + k < max_units; ++k) {
      units[2 * (unit + k)] = t;
      units[2 * (unit + k) + 1] = k;
    }
    item += n;
    slot += n > 1 ? n : 0;
    unit += u;
  }
  if (tid == LAYOUT_THREADS - 1) {
    lay.item_start()[num_tiles] = min(item, lay.max_items);
    *lay.unit_total() = min(unit, max_units);
  }
}

}  // namespace
