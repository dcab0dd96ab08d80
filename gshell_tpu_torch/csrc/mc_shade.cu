// The MC shade's sample walk (ops/shade.py env_shade): per pixel row, n²
// samples of light importance sampling from a rotated pool and of BSDF
// importance sampling, MIS-combined, shadow-tested against the swept shadow
// field or by marching the SDF grid; forward, and the reverse of one block
// of samples.
//
// Replaces no TPU kernel: the JAX package scans the samples in XLA.  It
// takes the place of the eager walk (_MCAccumulate over _ShadeWalk.block),
// hundreds of small aten launches a block whose (k, P, ·) f32 temporaries
// each go to and from device memory, and whose reverse re-walks every block
// under autograd.
//
// What bounds it on Hopper: the f32 arithmetic of the samples (no tensor
// cores; at least ~400 FP32 instructions and ~60 divisions, roots and
// transcendentals a sample forward, ~1,000 and ~100 in reverse with the
// sample's forward repeated: tools/mc_shade_ops.cpp), then reading the
// draws u (12 bytes a sample).  The texel and pool entries it reads are
// small and cached.
//
// Design:
//  * One thread a pixel row; it walks the samples in registers.  The
//    per-row part of the arithmetic (the shading frame, the stretched view
//    direction, the specular colour, the Smith term of wo) is computed once
//    a row, and in reverse its cotangent is summed over the samples and
//    carried back to the six per-row inputs once a block.
//  * Rows whose mask is 0 are skipped: env_shade multiplies them by 0 on
//    the way out, so their value and every cotangent they send are 0.  The
//    compacted shade puts the foreground first, so whole warps at the tail
//    exit at once.  Counters: rows shaded and rows skipped, per warp.
//  * No per-sample state is kept between the passes: the reverse repeats
//    each sample's forward (the shadow lookups or marches included: they
//    are a pure function of the same detached ray).
//  * The reverse runs one launch per block of mc_block samples, as the
//    eager re-walk sums them.  The pool's cotangent (f32) goes out with
//    atomics: within a sample, neighbouring rows hit neighbouring pool
//    entries.  The light texel's cotangent keeps the eager rounding points:
//    each row's rounded to the light's dtype (the `.float()`'s backward),
//    the rows of a block summed in f32 (the gather's backward: lanes of a
//    warp that hit one texel are merged with __match_any_sync before one
//    atomic a channel, as csrc/gather_rows.cu does) into an f32 scratch,
//    then rounded once and added to the total in the light's dtype, block
//    after block (mc_light_round).
//  * Built with --fmad=false: the arithmetic rounds as aten's elementwise
//    kernels do (mc_shade.cuh), so sample directions and texel choices
//    agree with the eager walk's but for rare ties.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mc_shade.cuh"

namespace {

using mc::Args;
using mc::Bf16x4;
using mc::Fetch;

constexpr int kThreads = 128;
constexpr int kRowCols = 18;  // mc::Args::rows
constexpr int kGradCols = 12; // gn 3, kd 3, metallic, wo 3, alpha, p_diffuse
constexpr unsigned kFull = 0xffffffffu;

template <bool DIFF, typename LT>
__global__ void __launch_bounds__(kThreads) mc_shade_fwd_kernel(const Args a) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool in = p < a.P;
  const float* row = a.rows + p * kRowCols;
  const bool live = in && row[17] != 0.0f;
  const unsigned b_in = __ballot_sync(kFull, in), b_live = __ballot_sync(kFull, live);
  if ((threadIdx.x & 31) == 0 && b_in) {
    atomicAdd(a.stats, (unsigned long long)__popc(b_live));
    atomicAdd(a.stats + 1, (unsigned long long)__popc(b_in & ~b_live));
  }
  if (!in) return;
  const int n2 = a.n * a.n;
  float* out = a.out + p * 6;
  if (!live) {
    for (int c = 0; c < 6; ++c) out[c] = 0.0f;
    return;
  }
  const mc::Leaves lv = mc::leaves_of(row);
  mc::Row r;
  mc::row_forward<DIFF>(r, lv);
  const mc::Consts k = mc::consts_of(a);
  const mc::Vis vis = mc::vis_of(a, {row[12], row[13], row[14]});
  const Fetch<LT> fetch{reinterpret_cast<const LT*>(a.light)};
  const float rot0 = row[15], rot1 = row[16];
  float tot[6];
  for (int j0 = 0; j0 < n2; j0 += a.k) {
    float blk[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int s = j0; s < j0 + a.k; ++s) {
      float pool[7], u[3];
      long long entry;
      mc::sample_inputs(a, p, s, pool, u, entry);
      mc::Sample sm;
      mc::sample_fwd<DIFF>(r, k, pool, u[0], u[1], u[2], (float)(s % a.n), (float)(s / a.n), rot0, rot1, fetch,
                           vis, sm);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        blk[c] += sm.e1.d[c] + sm.e2.d[c];
        blk[3 + c] += sm.e1.s[c] + sm.e2.s[c];
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) tot[c] = j0 == 0 ? blk[c] : tot[c] + blk[c];
  }
  for (int c = 0; c < 6; ++c) out[c] = tot[c];
}

template <bool DIFF, typename LT>
__global__ void __launch_bounds__(kThreads) mc_shade_bwd_kernel(const Args a) {
  __shared__ float stage[kThreads / 32][4][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool in = p < a.P;
  const float* row = a.rows + p * kRowCols;
  float g[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  bool live = in && row[17] != 0.0f;
  if (live) {
    bool any = false;
    for (int c = 0; c < 6; ++c) {
      g[c] = a.g[p * 6 + c];
      any |= g[c] != 0.0f;
    }
    live = any;  // a zero cotangent row sends zeros
  }
  if (__ballot_sync(kFull, live) == 0u) return;  // uniform over the warp

  mc::Leaves lv;
  mc::Row r;
  mc::RowAdj A;
  mc::clear(A);
  if (live) {
    lv = mc::leaves_of(row);
    mc::row_forward<DIFF>(r, lv);
  }
  const mc::Consts k = mc::consts_of(a);
  const mc::Vis vis = mc::vis_of(a, {live ? row[12] : 0.0f, live ? row[13] : 0.0f, live ? row[14] : 0.0f});
  const Fetch<LT> fetch{reinterpret_cast<const LT*>(a.light)};
  const float rot0 = live ? row[15] : 0.0f, rot1 = live ? row[16] : 0.0f;
  for (int s = a.j0; s < a.j0 + a.k; ++s) {
    float a_tex[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int64_t tidx = -1;
    if (live) {
      float pool[7], u[3], a_pool[7];
      long long entry;
      mc::sample_inputs(a, p, s, pool, u, entry);
      mc::Sample sm;
      mc::sample_fwd<DIFF>(r, k, pool, u[0], u[1], u[2], (float)(s % a.n), (float)(s / a.n), rot0, rot1, fetch,
                           vis, sm);
      mc::sample_bwd<DIFF>(r, k, sm, g, A, a_pool, a_tex);
      tidx = sm.ll.tidx;
      if (a.g_pool) {
        float* to = a.g_pool + ((long long)s * a.n_pool + entry) * 7;
#pragma unroll
        for (int q = 0; q < 7; ++q)
          if (a_pool[q] != 0.0f) atomicAdd(to + q, a_pool[q]);
      }
    }
    if (a.scratch) {
      bool send = false;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a_tex[q] = Fetch<LT>::round(a_tex[q]);
        send |= a_tex[q] != 0.0f;
      }
      send = send && live;
      const unsigned long long key = send ? (unsigned long long)tidx : ~0ull;
      const unsigned peers = __match_any_sync(kFull, key);
      const bool leader = send && __ffs(peers) - 1 == lane;
#pragma unroll
      for (int q = 0; q < 4; ++q) stage[warp][q][lane] = a_tex[q];
      __syncwarp();
      if (leader) {
        float* to = a.scratch + tidx * 4;
        for (int q = 0; q < 4; ++q) {
          float sum = 0.0f;
          for (unsigned m = peers; m; m &= m - 1) sum += stage[warp][q][__ffs(m) - 1];
          if (sum != 0.0f) atomicAdd(to + q, sum);
        }
      }
      __syncwarp();
    }
  }
  if (!live) return;
  mc::V3 g_gn, g_kd, g_wo;
  float g_m, g_alpha, g_pd;
  mc::row_backward<DIFF>(r, lv, A, g_gn, g_kd, g_m, g_wo, g_alpha, g_pd);
  const float add[kGradCols] = {g_gn.x, g_gn.y, g_gn.z, g_kd.x, g_kd.y, g_kd.z, g_m,
                                g_wo.x, g_wo.y, g_wo.z, g_alpha, g_pd};
  float* o = a.g_rows + p * kGradCols;
#pragma unroll
  for (int q = 0; q < kGradCols; ++q) o[q] = o[q] + add[q];
}

// A block's light cotangent: scratch rounded to the light's dtype, added to
// the total in that dtype; scratch left zero.
template <typename LT>
__global__ void __launch_bounds__(256) mc_light_round_kernel(float* scratch, void* total, long long m) {
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < m; i += (long long)gridDim.x * 256) {
    const float s = scratch[i];
    if (s == 0.0f) continue;
    scratch[i] = 0.0f;
    if constexpr (sizeof(LT) == sizeof(float)) {
      float* t = reinterpret_cast<float*>(total);
      t[i] = t[i] + s;
    } else {
      uint16_t* t = reinterpret_cast<uint16_t*>(total);
      t[i] = mc::f32_to_bf16_bits(mc::bf16_bits_to_f32(t[i]) + Fetch<LT>::round(s));
    }
  }
}

template <typename LT>
void launch_fwd(const Args& a, unsigned blocks, cudaStream_t s) {
  if (a.diffuse_only)
    mc_shade_fwd_kernel<true, LT><<<blocks, kThreads, 0, s>>>(a);
  else
    mc_shade_fwd_kernel<false, LT><<<blocks, kThreads, 0, s>>>(a);
}

template <typename LT>
void launch_bwd(const Args& a, unsigned blocks, cudaStream_t s) {
  if (a.diffuse_only)
    mc_shade_bwd_kernel<true, LT><<<blocks, kThreads, 0, s>>>(a);
  else
    mc_shade_bwd_kernel<false, LT><<<blocks, kThreads, 0, s>>>(a);
  if (a.scratch) {
    const long long m = (long long)a.lh * a.lw * 4;
    const long long want = (m + 255) / 256;
    mc_light_round_kernel<LT><<<(unsigned)(want < 1056 ? want : 1056), 256, 0, s>>>(a.scratch, a.g_light, m);
  }
}

}  // namespace

// The walk's forward: out (P, 6) and the counters.
extern "C" int gs_mc_shade_fwd(const Args* a, void* stream) {
  if (a->P <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((a->P + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (a->light_bf16)
    launch_fwd<Bf16x4>(*a, blocks, s);
  else
    launch_fwd<float>(*a, blocks, s);
  return (int)cudaGetLastError();
}

// The reverse of samples [j0, j0 + k): row cotangents added to g_rows, the
// pool's to g_pool, the light's to g_light after its rounding.
extern "C" int gs_mc_shade_bwd(const Args* a, void* stream) {
  if (a->P <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((a->P + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (a->light_bf16)
    launch_bwd<Bf16x4>(*a, blocks, s);
  else
    launch_bwd<float>(*a, blocks, s);
  return (int)cudaGetLastError();
}
