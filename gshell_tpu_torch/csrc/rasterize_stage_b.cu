// Raster stage B: per-tile triangle coverage and depth test.
//
// Replaces the TPU kernel gshell_tpu/ops/rasterize.py::_stage_b_pallas
// (pallas_call at :430), which rasterize_tiled calls after its stage-A
// binning.  Input is the (triangle, tile) pair list sorted by tile, one row
// of 16 floats per pair:
//   [a0 a1 a2 | b0 b1 b2 | c0 c1 c2 | z0 z1 z2 | area2 | tri_id+1 | 0 0]
// plus each tile's segment [tile_start, tile_start + tile_cnt).  Every tile
// walks its whole segment: there is no per-tile triangle cap.
//
// Design: one block per 16x16 tile, one thread per pixel.  The block stages
// chunks of 128 pairs (8 KB) in shared memory; every thread then reads each
// pair as a broadcast and keeps its own (best_z, best_id) under the rule
// "least z, then least id".  Work is bounded by the longest segment of the
// image (tiles run in parallel across the 132 SMs); pair bytes are read once
// per tile from device memory, so the kernel is bound by the per-pixel edge
// arithmetic (about 20 flops per pair per pixel), not by memory.
//
// Numerics: edge values and depth use explicitly rounded products and sums
// (__fmul_rn / __fadd_rn; the library is also built with --fmad=false), in
// the order PyTorch's eager ops use: e = (a*px + b*py) + c, depth =
// ((e0*z0 + e1*z1) + e2*z2) * (1/area2).  The plain PyTorch version then
// gives identical ids, including the top-left tie test e == 0.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kChunk = 128;
constexpr int kPairWidth = 16;
constexpr float kBig = 3.4e38f;

__global__ void stage_b_kernel(const float* __restrict__ pairs,
                               const int* __restrict__ tile_start,
                               const int* __restrict__ tile_cnt,
                               float* __restrict__ best_z_out,
                               int* __restrict__ best_id_out, int tx_n) {
  __shared__ float buf[kChunk * kPairWidth];
  const int t = blockIdx.x;
  const int lin = threadIdx.x;
  const int start = tile_start[t];
  const int cnt = tile_cnt[t];
  const int ty = t / tx_n;
  const int tx = t % tx_n;
  const float py = (float)(ty * kTile + lin / kTile) + 0.5f;
  const float px = (float)(tx * kTile + lin % kTile) + 0.5f;

  float best_z = kBig;
  int best_id = -1;
  for (int base = 0; base < cnt; base += kChunk) {
    const int n = min(kChunk, cnt - base);
    __syncthreads();  // previous chunk fully consumed
    const float* src = pairs + (size_t)(start + base) * kPairWidth;
    for (int k = lin; k < n * kPairWidth; k += kPixels) buf[k] = src[k];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* s = buf + j * kPairWidth;
      const float ar = s[12];
      if (!(fabsf(ar) > 1e-12f)) continue;
      const float s_or = ar > 0.f ? 1.f : -1.f;
      bool cover = true;
      float depth_num = 0.f;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float a = s[e], b = s[3 + e], c = s[6 + e], z = s[9 + e];
        const float ev = __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
        const float eo = ev * s_or;  // exact: s_or is +-1
        const float ao = a * s_or;
        const float bo = b * s_or;
        const bool edge_ok = (ao > 0.f) || (ao == 0.f && bo > 0.f);
        cover = cover && ((eo > 0.f) || (eo == 0.f && edge_ok));
        depth_num = __fadd_rn(depth_num, __fmul_rn(ev, z));
      }
      if (!cover) continue;
      const float depth = __fmul_rn(depth_num, __fdiv_rn(1.f, ar));
      if (!(depth >= -1.f && depth <= 1.f)) continue;
      const int id = (int)s[13] - 1;
      if (depth < best_z || (depth == best_z && id < best_id)) {
        best_z = depth;
        best_id = id;
      }
    }
  }
  best_z_out[(size_t)t * kPixels + lin] = best_z;
  best_id_out[(size_t)t * kPixels + lin] = best_id;
}

}  // namespace

// best_z (n_tiles, 256) f32; best_id (n_tiles, 256) i32, -1 = miss.
extern "C" int gs_stage_b(const void* pairs, const void* tile_start,
                          const void* tile_cnt, void* best_z, void* best_id,
                          int n_tiles, int tx_n, void* stream) {
  if (n_tiles > 0) {
    stage_b_kernel<<<n_tiles, kPixels, 0, (cudaStream_t)stream>>>(
        (const float*)pairs, (const int*)tile_start, (const int*)tile_cnt,
        (float*)best_z, (int*)best_id, tx_n);
  }
  return (int)cudaGetLastError();
}
