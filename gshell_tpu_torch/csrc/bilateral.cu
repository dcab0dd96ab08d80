// Bilateral denoiser stencil: (2r+1)^2 taps per pixel.
//
// Replaces the TPU kernel gshell_tpu/ops/denoiser.py::_accumulate_pallas
// (pallas_call at :202).  Per tap t of centre pixel c:
//   w = exp(-d^2 * inv2var) * clip(<n_t, n_c>, eps, 1)^128
//       * exp(-|z_t - z_c| / max(dz * d, eps))
// with dz read at the centre (forward) or at the tap (denom_from_tap = 1:
// the transposed stencil that the backward runs).  Taps outside the image
// have weight 0.  Outputs acc_col = sum col_t * w (H, W, 3), acc_w = sum w
// (H, W, 1).
//
// Design: one thread per output pixel in 16x16 blocks.  The block first
// copies its (16+2r)^2 halo of the 8 input channels (col 3, nrm 3, z, dz)
// into dynamic shared memory — 46 KB at r = 11 — so each tap is a shared
// memory read and device memory is read about (38/16)^2 = 5.6 times per
// pixel instead of 529 times.  What bounds the kernel is arithmetic: two
// expf, one sqrtf, one division and ~30 flops per tap, 529 taps per pixel.
// ^128 is 7 squarings, as on the TPU.  The tap order is row-major (fy, fx),
// as in the plain version, so sums round alike.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kChannels = 8;
constexpr float kEps = 1.1920929e-7f;

__global__ void bilateral_kernel(const float* __restrict__ col,
                                 const float* __restrict__ nrm,
                                 const float* __restrict__ zdz,
                                 float* __restrict__ acc_col,
                                 float* __restrict__ acc_w, int h, int w,
                                 int r, float inv2var, int from_tap) {
  extern __shared__ float sm[];
  const int hw = kBlock + 2 * r;
  const int plane = hw * hw;
  const int x0 = blockIdx.x * kBlock - r;
  const int y0 = blockIdx.y * kBlock - r;
  const int tid = threadIdx.y * kBlock + threadIdx.x;
  for (int k = tid; k < plane; k += kBlock * kBlock) {
    const int gy = y0 + k / hw;
    const int gx = x0 + k % hw;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const size_t p = in ? (size_t)gy * w + gx : 0;
    sm[0 * plane + k] = in ? col[p * 3 + 0] : 0.f;
    sm[1 * plane + k] = in ? col[p * 3 + 1] : 0.f;
    sm[2 * plane + k] = in ? col[p * 3 + 2] : 0.f;
    sm[3 * plane + k] = in ? nrm[p * 3 + 0] : 0.f;
    sm[4 * plane + k] = in ? nrm[p * 3 + 1] : 0.f;
    sm[5 * plane + k] = in ? nrm[p * 3 + 2] : 0.f;
    sm[6 * plane + k] = in ? zdz[p * 2 + 0] : 0.f;
    sm[7 * plane + k] = in ? zdz[p * 2 + 1] : 0.f;
  }
  __syncthreads();

  const int px = blockIdx.x * kBlock + threadIdx.x;
  const int py = blockIdx.y * kBlock + threadIdx.y;
  if (px >= w || py >= h) return;
  const int cl = (threadIdx.y + r) * hw + threadIdx.x + r;
  const float cn0 = sm[3 * plane + cl];
  const float cn1 = sm[4 * plane + cl];
  const float cn2 = sm[5 * plane + cl];
  const float cz = sm[6 * plane + cl];
  const float cdz = sm[7 * plane + cl];

  float a0 = 0.f, a1 = 0.f, a2 = 0.f, aw = 0.f;
  for (int fy = -r; fy <= r; ++fy) {
    if (py + fy < 0 || py + fy >= h) continue;
    for (int fx = -r; fx <= r; ++fx) {
      if (px + fx < 0 || px + fx >= w) continue;
      const int tl = cl + fy * hw + fx;
      const float dist_sqr = (float)(fx * fx + fy * fy);
      const float w_xy = expf(-dist_sqr * inv2var);
      float d = sm[3 * plane + tl] * cn0 + sm[4 * plane + tl] * cn1;
      d = d + sm[5 * plane + tl] * cn2;
      d = fminf(fmaxf(d, kEps), 1.f);
#pragma unroll
      for (int i = 0; i < 7; ++i) d = d * d;
      const float dz = from_tap ? sm[7 * plane + tl] : cdz;
      const float w_d =
          expf(-(fabsf(sm[6 * plane + tl] - cz) / fmaxf(dz * sqrtf(dist_sqr), kEps)));
      const float wgt = w_xy * d * w_d;
      a0 = a0 + sm[0 * plane + tl] * wgt;
      a1 = a1 + sm[1 * plane + tl] * wgt;
      a2 = a2 + sm[2 * plane + tl] * wgt;
      aw = aw + wgt;
    }
  }
  const size_t p = (size_t)py * w + px;
  acc_col[p * 3 + 0] = a0;
  acc_col[p * 3 + 1] = a1;
  acc_col[p * 3 + 2] = a2;
  acc_w[p] = aw;
}

}  // namespace

extern "C" int gs_bilateral(const void* col, const void* nrm, const void* zdz,
                            void* acc_col, void* acc_w, int h, int w, int r,
                            float inv2var, int denom_from_tap, void* stream) {
  const int hw = kBlock + 2 * r;
  const size_t smem = (size_t)kChannels * hw * hw * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bilateral_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (h > 0 && w > 0) {
    dim3 grid((w + kBlock - 1) / kBlock, (h + kBlock - 1) / kBlock);
    dim3 block(kBlock, kBlock);
    bilateral_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        (const float*)col, (const float*)nrm, (const float*)zdz,
        (float*)acc_col, (float*)acc_w, h, w, r, inv2var, denom_from_tap);
  }
  return (int)cudaGetLastError();
}
