// Bilateral denoiser stencil: (2r+1)^2 taps per pixel, C colour channels.
//
// Replaces the TPU kernel gshell_tpu/ops/denoiser.py::_accumulate_pallas
// (pallas_call at :202).  Per tap t of centre pixel c:
//   w = exp(-d^2 * inv2var) * clip(<n_t, n_c>, eps, 1)^128
//       * exp(-|z_t - z_c| / max(dz * d, eps))
// with dz read at the centre (forward) or at the tap (FROM_TAP: the
// transposed stencil that the backward runs).  Taps outside the image have
// weight 0.  Outputs acc_col = sum col_t * w (H, W, C), acc_w = sum w
// (H, W, 1).  C is 3 (one colour) or 6 (diffuse and specular, which share
// their guides, so each weight is computed once for both).
//
// What bounds it on Hopper: FP32 issue.  About 21 + 2 (C + 1) FP32
// instructions and 2 MUFU operations (ex2, rcp) per in-image tap, with no
// fast math: expf and the division stay IEEE so that the result equals the
// plain PyTorch version bit for bit (^128 turns one ulp of the normal dot
// product into ~128 ulp of weight), so each compiles to several
// instructions (a reciprocal or exp2 on the special-function unit, then a
// Newton step or a range reduction) where the count above has one.  Tensor
// cores do not apply: each weight
// is a nonlinear function of its own pixel's guides, so there is no matrix
// product to hand them.
//
// Design:
//  * Offset table.  exp(-d^2 * inv2var) and sqrt(d^2) depend only on the tap
//    offset (fy, fx); each block tabulates them once in shared memory with
//    the same expf / sqrtf on the same inputs, and every lane of a warp reads
//    one entry at a time (a broadcast).
//  * Register tiling.  A thread owns P = 2 horizontally adjacent pixels of a
//    32x16 tile (256 threads).  Along a tap row it walks the 2r + P halo
//    positions once; each position's guides and colours are read from
//    shared memory once and applied to every one of its P pixels for which
//    it is a tap.  Each pixel still sums its taps in row-major (fy, fx)
//    order, as the plain version does.  P stays 2: the halo planes cap a
//    block at two per SM, and P = 4 would halve the warps left to hide the
//    latency of each tap's dependent chain.
//  * Halo.  The (32 + 2r) x (16 + 2r) halo of the tap planes (normal, z,
//    dz when FROM_TAP, C colours) is copied with 4-byte cp.async, zero-filled
//    outside the image, into planes of odd pitch (no bank conflicts for the
//    P-strided lanes).  A zero-filled tap has normal 0, so its weight is
//    eps^128 = 0 exactly and it adds +0 to every sum, as the plain version's
//    masked tap does: no per-tap bounds test, and a tap row wholly outside
//    the image is skipped.
//  * No slow division.  A zero |z_t - z_c| (background, where the guides
//    are 0) sends the IEEE division down its slow path; adding 1e-30 to it
//    keeps the fast path and the same bits (see tap_step).  A rendered view
//    is mostly background, so without it most taps took the slow path.
//  * Specialization on C, on FROM_TAP and on r = 11 (the renderer's radius):
//    with r fixed every shared-memory offset is an immediate.  Other radii
//    take a variant that reads r at run time.  The shared-memory attribute
//    is set once per process and device, for the largest size seen.
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kPix = 2;  // pixels a thread owns along a row
constexpr float kEps = 1.1920929e-7f;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// One thread's P pixels: centre guides, accumulators, and the offset-table
// entries (w_xy, dist) of their current taps (pixel p's is pixel p-1's of
// the previous halo position, so each entry is read once per row).
template <int C, int P>
struct Centres {
  float n0[P], n1[P], n2[P], z[P], dz[P];
  float acc[P][C + 1];
  float2 t[P];
};

// Halo position j of a tap row: its values serve the thread's pixels
// p in [lo, hi] as tap fx + r = j - p.  lo and hi are constants once the
// callers' loops unroll, so the middle of the row runs without predicates.
template <int C, int P, bool FROM_TAP, int PLANE>
__device__ __forceinline__ void tap_step(Centres<C, P>& s, const float* row, const float2* trow,
                                         int plane_rt, int j, int lo, int hi) {
  constexpr int kCol = FROM_TAP ? 5 : 4;
  const int plane = PLANE > 0 ? PLANE : plane_rt;
  const float tn0 = row[0 * plane + j];
  const float tn1 = row[1 * plane + j];
  const float tn2 = row[2 * plane + j];
  const float tz = row[3 * plane + j];
  const float tdz = FROM_TAP ? row[4 * plane + j] : 0.f;
  float tc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) tc[c] = row[(kCol + c) * plane + j];
#pragma unroll
  for (int p = P - 1; p > 0; --p) s.t[p] = s.t[p - 1];
  if (lo == 0) s.t[0] = trow[j];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p < lo || p > hi) continue;
    const float2 t = s.t[p];
    float d = tn0 * s.n0[p] + tn1 * s.n1[p];
    d = d + tn2 * s.n2[p];
    d = fminf(fmaxf(d, kEps), 1.f);
#pragma unroll
    for (int i = 0; i < 7; ++i) d = d * d;
    const float dz = FROM_TAP ? tdz : s.dz[p];
    // 1e-30 is added to |z_t - z_c|: a zero dividend sends the IEEE
    // division down its slow path (background taps have z_t = z_c = 0).
    // Exact: the sum differs from |z_t - z_c| only below 2^-75, where with
    // a divisor >= eps both quotients are <= 2.3e-16, and expf(-v) == 1
    // for every float v in [0, 1e-15] (test_torch_cuda.py checks all of
    // them).  A NaN or inf |z_t - z_c| stays NaN or inf.
    const float w_d = expf(-((fabsf(tz - s.z[p]) + 1e-30f) / fmaxf(dz * t.y, kEps)));
    const float wgt = t.x * d * w_d;
#pragma unroll
    for (int c = 0; c < C; ++c) s.acc[p][c] = s.acc[p][c] + tc[c] * wgt;
    s.acc[p][C] = s.acc[p][C] + wgt;
  }
}

// R > 0: the radius is a compile-time constant (the renderer's r = 11), so
// every shared-memory offset is an immediate; R == 0: r is read at run time.
template <int C, int P, bool FROM_TAP, int R>
__global__ void __launch_bounds__((kTileW / P) * kTileH)
    bilateral_kernel(const float* __restrict__ col, const float* __restrict__ nrm,
                     const float* __restrict__ zdz, float* __restrict__ acc_col,
                     float* __restrict__ acc_w, int h, int w, int r_rt, float inv2var) {
  constexpr int kTX = kTileW / P;
  constexpr int kThreads = kTX * kTileH;
  // planes: n0 n1 n2 z [dz] c0 .. c(C-1)
  constexpr int kCol = FROM_TAP ? 5 : 4;
  constexpr int kPlane = R > 0 ? ((kTileW + 2 * R) | 1) * (kTileH + 2 * R) : 0;
  extern __shared__ float2 smem[];
  const int r = R > 0 ? R : r_rt;
  const int n = 2 * r + 1;
  const int hw = kTileW + 2 * r;
  const int hh = kTileH + 2 * r;
  const int pitch = hw | 1;
  const int plane = pitch * hh;
  float2* tab = smem;  // (w_xy, dist) per tap offset, row-major
  float* sm = reinterpret_cast<float*>(smem + n * n);
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileW - r;
  const int y0 = blockIdx.y * kTileH - r;

  for (int k = tid; k < hw * hh; k += kThreads) {
    const int hy = k / hw;
    const int hx = k - hy * hw;
    const int gy = y0 + hy;
    const int gx = x0 + hx;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const size_t p = in ? (size_t)gy * w + gx : 0;
    float* d = sm + hy * pitch + hx;
    cp_async4(d + 0 * plane, nrm + p * 3 + 0, in);
    cp_async4(d + 1 * plane, nrm + p * 3 + 1, in);
    cp_async4(d + 2 * plane, nrm + p * 3 + 2, in);
    cp_async4(d + 3 * plane, zdz + p * 2 + 0, in);
    if (FROM_TAP) cp_async4(d + 4 * plane, zdz + p * 2 + 1, in);
#pragma unroll
    for (int c = 0; c < C; ++c) cp_async4(d + (kCol + c) * plane, col + p * C + c, in);
  }
  for (int k = tid; k < n * n; k += kThreads) {
    const int fy = k / n - r;
    const int fx = k % n - r;
    const float dist_sqr = (float)(fx * fx + fy * fy);
    tab[k] = make_float2(expf(-dist_sqr * inv2var), sqrtf(dist_sqr));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int px0 = blockIdx.x * kTileW + tx * P;
  const int py = blockIdx.y * kTileH + ty;
  Centres<C, P> s;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int cl = (ty + r) * pitch + tx * P + p + r;
    s.n0[p] = sm[0 * plane + cl];
    s.n1[p] = sm[1 * plane + cl];
    s.n2[p] = sm[2 * plane + cl];
    s.z[p] = sm[3 * plane + cl];
    const bool in = py < h && px0 + p < w;
    s.dz[p] = (!FROM_TAP && in) ? zdz[((size_t)py * w + px0 + p) * 2 + 1] : 0.f;
#pragma unroll
    for (int c = 0; c <= C; ++c) s.acc[p][c] = 0.f;
  }

  // Per tap row, halo positions j = 0 .. n + P - 2; pixel p takes j - p as
  // its fx + r, so each pixel still sums its taps in row-major order.
#pragma unroll 1
  for (int fy = 0; fy < n; ++fy) {
    // a tap row outside the image adds +0 to every sum: skip it
    if ((unsigned)(py + fy - r) >= (unsigned)h) continue;
    const float* row = sm + (ty + fy) * pitch + tx * P;
    const float2* trow = tab + fy * n;
#pragma unroll
    for (int j = 0; j < P - 1; ++j) tap_step<C, P, FROM_TAP, kPlane>(s, row, trow, plane, j, 0, j);
#pragma unroll 2
    for (int j = P - 1; j < n; ++j) tap_step<C, P, FROM_TAP, kPlane>(s, row, trow, plane, j, 0, P - 1);
#pragma unroll
    for (int i = 1; i < P; ++i) tap_step<C, P, FROM_TAP, kPlane>(s, row, trow, plane, n - 1 + i, i, P - 1);
  }

  if (py >= h) return;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (px0 + p >= w) continue;
    const size_t o = (size_t)py * w + px0 + p;
#pragma unroll
    for (int c = 0; c < C; ++c) acc_col[o * C + c] = s.acc[p][c];
    acc_w[o] = s.acc[p][C];
  }
}

template <int C, int P, bool FROM_TAP, int R>
int launch(const void* col, const void* nrm, const void* zdz, void* acc_col, void* acc_w,
           int h, int w, int r, float inv2var, cudaStream_t stream) {
  constexpr int kPlanes = (FROM_TAP ? 5 : 4) + C;
  static size_t attr_bytes[64] = {};  // per device: the attribute set so far
  const int n = 2 * r + 1;
  const size_t smem = (size_t)n * n * sizeof(float2) +
                      (size_t)kPlanes * ((kTileW + 2 * r) | 1) * (kTileH + 2 * r) * sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > attr_bytes[dev]) {
    err = cudaFuncSetAttribute(bilateral_kernel<C, P, FROM_TAP, R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_bytes[dev] = smem;
  }
  dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  bilateral_kernel<C, P, FROM_TAP, R><<<grid, (kTileW / P) * kTileH, smem, stream>>>(
      (const float*)col, (const float*)nrm, (const float*)zdz, (float*)acc_col,
      (float*)acc_w, h, w, r, inv2var);
  return (int)cudaGetLastError();
}

template <int C, int P, bool FROM_TAP>
int launch_r(const void* col, const void* nrm, const void* zdz, void* acc_col, void* acc_w,
             int h, int w, int r, float inv2var, cudaStream_t s) {
  if (r == 11) return launch<C, P, FROM_TAP, 11>(col, nrm, zdz, acc_col, acc_w, h, w, r, inv2var, s);
  return launch<C, P, FROM_TAP, 0>(col, nrm, zdz, acc_col, acc_w, h, w, r, inv2var, s);
}

template <int P>
int dispatch(const void* col, const void* nrm, const void* zdz, void* acc_col, void* acc_w,
             int h, int w, int c, int r, float inv2var, int from_tap, cudaStream_t s) {
  if (c == 3 && !from_tap) return launch_r<3, P, false>(col, nrm, zdz, acc_col, acc_w, h, w, r, inv2var, s);
  if (c == 3 && from_tap) return launch_r<3, P, true>(col, nrm, zdz, acc_col, acc_w, h, w, r, inv2var, s);
  if (c == 6 && !from_tap) return launch_r<6, P, false>(col, nrm, zdz, acc_col, acc_w, h, w, r, inv2var, s);
  if (c == 6 && from_tap) return launch_r<6, P, true>(col, nrm, zdz, acc_col, acc_w, h, w, r, inv2var, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// col (H, W, C) with C in {3, 6}, nrm (H, W, 3), zdz (H, W, 2); acc_col
// (H, W, C), acc_w (H, W, 1); all f32, contiguous.
extern "C" int gs_bilateral(const void* col, const void* nrm, const void* zdz,
                            void* acc_col, void* acc_w, int h, int w, int c, int r,
                            float inv2var, int denom_from_tap, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaGetLastError();
  if (r < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch<kPix>(col, nrm, zdz, acc_col, acc_w, h, w, c, r, inv2var, denom_from_tap, s);
}
