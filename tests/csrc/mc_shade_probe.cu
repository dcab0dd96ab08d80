// A probe of the MC shade's forward (gshell_tpu_torch/csrc/mc_shade.cuh),
// built only by tests/test_torch_mc_shade.py: each sample's light texel and
// lobe as the kernel chooses them, and its two shadow tests, so that the
// tests can count the samples on which they differ from the eager walk's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mc_shade.cuh"

namespace {

constexpr int kThreads = 128;

// tex (n², P): 2 · texel + (1 if the BSDF sample took the cosine lobe), -1
// on rows with mask 0; vis (n², P, 2): the light and the BSDF sample's
// shadow tests.
template <bool DIFF, typename LT>
__global__ void __launch_bounds__(kThreads) mc_shade_probe_kernel(const mc::Args a, int* tex, float* vis_out) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= a.P) return;
  const float* row = a.rows + p * 18;
  const int n2 = a.n * a.n;
  if (row[17] == 0.0f) {
    for (int s = 0; s < n2; ++s) tex[(long long)s * a.P + p] = -1;
    return;
  }
  const mc::Leaves lv = mc::leaves_of(row);
  mc::Row r;
  mc::row_forward<DIFF>(r, lv);
  const mc::Consts k = mc::consts_of(a);
  const mc::Vis vis = mc::vis_of(a, {row[12], row[13], row[14]});
  const mc::Fetch<LT> fetch{reinterpret_cast<const LT*>(a.light)};
  for (int s = 0; s < n2; ++s) {
    float pool[7], u[3];
    long long entry;
    mc::sample_inputs(a, p, s, pool, u, entry);
    mc::Sample sm;
    mc::sample_fwd<DIFF>(r, k, pool, u[0], u[1], u[2], (float)(s % a.n), (float)(s / a.n), row[15], row[16], fetch,
                         vis, sm);
    const long long at = (long long)s * a.P + p;
    tex[at] = (int)(sm.ll.tidx * 2 + (DIFF || sm.take_d ? 1 : 0));
    vis_out[at * 2] = vis(sm.L);
    vis_out[at * 2 + 1] = vis(sm.dir2);
  }
}

template <typename LT>
void launch(const mc::Args& a, int* tex, float* vis, cudaStream_t s) {
  const unsigned blocks = (unsigned)((a.P + kThreads - 1) / kThreads);
  if (a.diffuse_only)
    mc_shade_probe_kernel<true, LT><<<blocks, kThreads, 0, s>>>(a, tex, vis);
  else
    mc_shade_probe_kernel<false, LT><<<blocks, kThreads, 0, s>>>(a, tex, vis);
}

}  // namespace

extern "C" int gs_mc_shade_probe(const mc::Args* a, int* tex, float* vis, void* stream) {
  if (a->P <= 0) return (int)cudaGetLastError();
  if (a->light_bf16)
    launch<mc::Bf16x4>(*a, tex, vis, (cudaStream_t)stream);
  else
    launch<float>(*a, tex, vis, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
