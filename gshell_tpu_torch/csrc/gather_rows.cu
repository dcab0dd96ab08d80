// Backward of a row gather out = src[idx]: grad_src[idx[i], :] += g[i, :].
//
// Replaces no TPU kernel: XLA fuses the gathers' transposed scatters.  It
// takes the place of aten's index_put_(accumulate=True) behind autograd's
// IndexBackward0, which sorts the indices and gives each (distinct index,
// channel) pair one thread that adds every duplicate of its index in a
// serial loop: its time is set by the longest run of one index.  The
// port's gathers have runs of 1e5-1e6 on rows whose gradient is exactly
// zero (the extraction's padded slots read one sentinel row, every
// background pixel reads face 0's vertices, and each read is masked after
// the gather).
//
// What bounds it on Hopper: device memory.  It reads each gradient row once
// (m * c * 4 bytes, 2 in bf16) and each index once (m * 8 bytes) and adds the live
// rows into grad_src with f32 atomics, which are L2 operations; the
// caller's zeroed grad_src (n * c * 4 bytes) is written once beforehand.
//
// Design:
//  * One row a lane, 32 consecutive rows a warp, 8 warps a block, a
//    grid-stride loop over a grid sized from m alone.  The lane first tests
//    whether its row is all zeros (x != 0 is false for +0 and -0 only; NaN
//    and Inf rows are live and are added, as aten adds them).  A zero row
//    is skipped: adding +-0 to a sum that starts at +0 changes no bit of it.
//    A warp whose 32 rows are all zero does nothing more.
//  * Duplicates are merged inside the warp before any atomic:
//    __match_any_sync on the destination row groups the live lanes that add
//    into the same row; each lane stages its row in shared memory (16
//    channels a pass, one padded plane per channel), and the group's lowest
//    lane sums the group's rows in lane order and issues one atomicAdd per
//    channel.  A destination that many live rows share costs at most one
//    atomic per channel per warp, not one per row.
//  * Counters: rows seen and rows scattered (live), summed over the block
//    and added once per block to a 64-bit pair the caller owns.
//  * Gradients in f32 or bf16, sums in f32 into an f32 grad_src (the caller
//    rounds a bf16 one once, as aten's opmath sum does).  The order of the
//    additions differs from aten's (within a warp: lane order; across
//    warps: the atomics' order, which changes from run to run); the set of
//    numbers added is the same.
//  * Indices are int64, read with a stride (a column of a face table needs
//    no copy), and trusted to lie in [0, n): the forward gather
//    (index_select) checked the same indices on the device.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 16;       // channels staged a pass
constexpr int kMaxBlocks = 2112; // 132 SMs x 16; the loop covers the rest

__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(const T* __restrict__ g, const int64_t* __restrict__ idx, long long idx_stride,
                        float* __restrict__ out, long long m, int c,
                        unsigned long long* __restrict__ stats) {
  __shared__ float stage[kWarps][kChunk][33];
  __shared__ unsigned counts[kWarps][2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned seen = 0, live_n = 0;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long base = ((long long)blockIdx.x * kWarps + warp) * 32; base < m; base += step) {
    const long long r = base + lane;
    const T* row = g + r * c;
    bool live = false;
    if (r < m) {
      ++seen;
      for (int k = 0; k < c; ++k) live |= as_f32(row[k]) != 0.0f;
    }
    if (__ballot_sync(0xffffffffu, live) == 0u) continue;  // uniform over the warp
    live_n += live;
    const long long dst = live ? idx[r * idx_stride] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, (unsigned long long)dst);
    const bool leader = live && __ffs(peers) - 1 == lane;
    for (int c0 = 0; c0 < c; c0 += kChunk) {
      const int cn = min(kChunk, c - c0);
      if (live)
        for (int k = 0; k < cn; ++k) stage[warp][k][lane] = as_f32(row[c0 + k]);
      __syncwarp();
      if (leader) {
        float* const to = out + dst * c + c0;
        for (int k = 0; k < cn; ++k) {
          float s = 0.0f;
          for (unsigned p = peers; p; p &= p - 1) s += stage[warp][k][__ffs(p) - 1];
          atomicAdd(to + k, s);
        }
      }
      __syncwarp();
    }
  }
  seen = __reduce_add_sync(0xffffffffu, seen);
  live_n = __reduce_add_sync(0xffffffffu, live_n);
  if (lane == 0) {
    counts[warp][0] = seen;
    counts[warp][1] = live_n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long a = 0, b = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += counts[w][0];
      b += counts[w][1];
    }
    atomicAdd(stats, a);
    atomicAdd(stats + 1, b);
  }
}

}  // namespace

// g (m, c) contiguous, f32 (bf16 = 0) or bf16 (bf16 = 1); idx (m,) int64
// in [0, n), idx_stride elements apart; out (n, c) f32, zeroed by the
// caller; stats (2,) int64: rows seen, rows scattered.
extern "C" int gs_scatter_rows(const void* g, int bf16, const void* idx, long long idx_stride, void* out,
                               long long m, int c, void* stats, void* stream) {
  if (m <= 0 || c <= 0) return (int)cudaGetLastError();
  const long long want = (m + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t* ix = (const int64_t*)idx;
  unsigned long long* st = (unsigned long long*)stats;
  if (bf16)
    scatter_rows_kernel<<<blocks, kThreads, 0, s>>>((const __nv_bfloat16*)g, ix, idx_stride, (float*)out, m, c, st);
  else
    scatter_rows_kernel<<<blocks, kThreads, 0, s>>>((const float*)g, ix, idx_stride, (float*)out, m, c, st);
  return (int)cudaGetLastError();
}
