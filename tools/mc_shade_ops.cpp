// The least arithmetic of the MC shade's sample walk (csrc/mc_shade.cuh),
// counted by running the header's own arithmetic on the host with a float
// that counts each operation it takes part in.  chip_smoke.py's bound of
// the kernel pair reads these counts (MC_OPS there).
//
//   g++ -std=c++20 -O1 -ffp-contract=off -I gshell_tpu_torch/csrc \
//       tools/mc_shade_ops.cpp -o mc_shade_ops && ./mc_shade_ops
//
// Counted as one FP32 instruction: an add, a subtraction, a product, an
// FMA, fmodf (of a non-negative number by 1).  Counted as one operation of
// the special-function units and nothing else: a division (its
// reciprocal), sqrtf, sinf, cosf, acosf, atan2f, powf.  Not counted:
// comparisons, selects, minima and maxima, negation, fabsf, rounding to an
// integer, conversions, loads.  Each is the least the work takes, so the
// bound is a floor.
//
// A row's shared part (row_forward; in reverse row_forward and
// row_backward) is counted once a row.  A sample is counted along the
// branches it takes, less the sample of the lobe it does not take (the
// walk computes both, as the eager walk does).  Inputs are drawn as
// chip_smoke.py's mc_shade_inputs draws them: rows facing a camera at z =
// 2.5, roughness from 0.1, a shadow field over the box.  Printed: a JSON
// object of the mean counts a row and a sample, by bsdf and lobe.
#include <math.h>
#include <stdint.h>

#include <cstdio>
#include <random>
#include <type_traits>
#include <vector>

namespace {
struct Ops {
  long long fp32 = 0, mufu = 0;
};
Ops ops;
}  // namespace

struct CF {
  float v;
  CF() = default;
  template <class T, class = std::enable_if_t<std::is_arithmetic_v<T>>>
  constexpr CF(T x) : v(static_cast<float>(x)) {}
  template <class T, class = std::enable_if_t<std::is_arithmetic_v<T>>>
  explicit constexpr operator T() const { return static_cast<T>(v); }
};

#define MC_OP(op, n)                                                          \
  constexpr CF operator op(CF a, CF b) {                                      \
    if (!std::is_constant_evaluated()) ops.n += 1;                             \
    return CF(a.v op b.v);                                                    \
  }                                                                           \
  constexpr CF& operator op##=(CF & a, CF b) { return a = a op b; }
MC_OP(+, fp32)
MC_OP(-, fp32)
MC_OP(*, fp32)
#undef MC_OP
constexpr CF operator/(CF a, CF b) {
  if (!std::is_constant_evaluated()) {
    ops.mufu += 1;
    ops.fp32 += 1;
  }
  return CF(a.v / b.v);
}
constexpr CF& operator/=(CF& a, CF b) { return a = a / b; }
constexpr CF operator-(CF a) { return CF(-a.v); }
#define MC_CMP(op) \
  constexpr bool operator op(CF a, CF b) { return a.v op b.v; }
MC_CMP(<)
MC_CMP(>)
MC_CMP(<=)
MC_CMP(>=)
MC_CMP(==)
MC_CMP(!=)
#undef MC_CMP

#define MC_MUFU1(fn) \
  inline CF fn(CF x) { ++ops.mufu; return CF(::fn(x.v)); }
MC_MUFU1(sqrtf)
MC_MUFU1(sinf)
MC_MUFU1(cosf)
MC_MUFU1(acosf)
#undef MC_MUFU1
inline CF atan2f(CF y, CF x) { ++ops.mufu; return CF(::atan2f(y.v, x.v)); }
inline CF powf(CF x, CF y) { ++ops.mufu; return CF(::powf(x.v, y.v)); }
inline CF fmaf(CF a, CF b, CF c) { ++ops.fp32; return CF(::fmaf(a.v, b.v, c.v)); }
inline CF fmodf(CF x, CF y) { ++ops.fp32; return CF(::fmodf(x.v, y.v)); }
inline CF fabsf(CF x) { return CF(::fabsf(x.v)); }
inline CF rintf(CF x) { return CF(::rintf(x.v)); }
inline CF floorf(CF x) { return CF(::floorf(x.v)); }

#define MC_ARITH_ONLY
#define float CF
#include "mc_shade.cuh"
#undef float

namespace {

struct Count {
  double fp32 = 0, mufu = 0, n = 0;
  void add(const Ops& o) {
    fp32 += o.fp32;
    mufu += o.mufu;
    n += 1;
  }
};

Ops since(const Ops& a) { return {ops.fp32 - a.fp32, ops.mufu - a.mufu}; }

struct FetchH {
  const std::vector<float>* t;
  void operator()(int64_t i, CF out[4]) const {
    for (int q = 0; q < 4; ++q) out[q] = (*t)[i * 4 + q];
  }
};
struct VisH {
  mc::Field f;
  mc::V3 ro;
  CF operator()(mc::V3 d) const { return mc::field_vis(f, ro, d); }
};

mc::V3 unit(std::mt19937& g) {
  std::normal_distribution<float> nd;
  const float x = nd(g), y = nd(g), z = nd(g), l = std::sqrt(x * x + y * y + z * z);
  return {x / l, y / l, z / l};
}

}  // namespace

int main() {
  const int rows = 4096, n = 8, lh = 512, lw = 512, r = 64, ko = 16, words = 3;
  std::mt19937 g(7);
  std::uniform_real_distribution<float> U(0.0f, 1.0f);
  std::vector<float> light((size_t)lh * lw * 4);
  for (auto& x : light) x = 0.25f + 0.5f * U(g);
  std::vector<long long> bits((size_t)ko * ko * (r + 1) * (r + 1) * words, 0);
  mc::Field field{bits.data(), ko, r, words, CF(2.0 * 1.4 * std::sqrt(3.0) / r), {}, {}};
  for (int c = 0; c < 3; ++c) {
    field.amin[c] = CF(-0.7);
    field.ascale[c] = CF(1.0 / 1.4);
  }
  mc::Consts k;
  k.inv_n2 = CF(1.0 / (n * n));
  k.strata = CF(1.0 / n);
  k.ss = CF(1.0);
  k.omss = CF(0.0);
  k.hw = CF((double)lh * lw);
  k.n = n;
  k.lh = lh;
  k.lw = lw;
  const FetchH fetch{&light};
  // [bsdf pbr / diffuse][forward / reverse]: the row part; the samples by lobe (cosine, GGX)
  Count row[2][2], smp[2][2][2];
  for (int diff = 0; diff < 2; ++diff) {
    for (int p = 0; p < rows; ++p) {
      const float px = (U(g) - 0.5f) * 0.8f, py = (U(g) - 0.5f) * 0.8f, pz = (U(g) - 0.5f) * 0.8f;
      mc::V3 nr = unit(g);
      const float vx = -px, vy = -py, vz = 2.5f - pz, vl = std::sqrt(vx * vx + vy * vy + vz * vz);
      if (float(nr.x) * vx + float(nr.y) * vy + float(nr.z) * vz < 0.0f) nr = {-nr.x, -nr.y, -nr.z};
      mc::Leaves lv;
      lv.gn = nr;
      lv.kd = {U(g), U(g), U(g)};
      lv.m = U(g);
      lv.wo = {vx / vl, vy / vl, vz / vl};
      const float rough = 0.1f + 0.9f * U(g);
      lv.alpha = rough * rough;
      lv.pd = diff ? 1.0f : U(g);
      const mc::V3 ro = {px + 1e-3f * float(nr.x), py + 1e-3f * float(nr.y), pz + 1e-3f * float(nr.z)};
      const VisH vis{field, ro};
      const float rot0 = U(g), rot1 = U(g);
      for (int pass = 0; pass < 2; ++pass) {
        Ops t0 = ops;
        mc::Row rw;
        if (diff)
          mc::row_forward<true>(rw, lv);
        else
          mc::row_forward<false>(rw, lv);
        mc::RowAdj A;
        mc::clear(A);
        const Ops row_fwd = since(t0);
        Ops bwd_rows{};
        for (int s = 0; s < n * n; ++s) {
          CF pool[7];
          const mc::V3 L = unit(g);
          pool[0] = L.x;
          pool[1] = L.y;
          pool[2] = L.z;
          pool[3] = 0.05f + U(g);
          for (int q = 4; q < 7; ++q) pool[q] = 0.25f + 0.5f * U(g);
          const float u0 = U(g), u1 = U(g), u2 = U(g);
          const CF bu = fmodf((CF((float)(s % n)) + u0) * k.strata + rot0, 1.0f);
          const CF bv = fmodf((CF((float)(s / n)) + u1) * k.strata + rot1, 1.0f);
          // the lobe not taken: its sample's cost, counted alone
          Ops c0 = ops;
          mc::CosSample cs;
          mc::cos_sample_fwd(rw, bu, bv, cs);
          const Ops cos_cost = since(c0);
          c0 = ops;
          mc::GgxSample gs;
          if (!diff) mc::ggx_sample_fwd(rw, bu, bv, gs);
          const Ops ggx_cost = since(c0);
          const bool take_d = diff || u2 < float(lv.pd);
          const Ops spare = diff ? Ops{} : (take_d ? ggx_cost : cos_cost);
          Ops s0 = ops;
          mc::Sample sm;
          const CF g6[6] = {U(g), U(g), U(g), U(g), U(g), U(g)};
          CF a_pool[7], a_tex[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (diff) {
            mc::sample_fwd<true>(rw, k, pool, u0, u1, u2, (float)(s % n), (float)(s / n), rot0, rot1, fetch, vis, sm);
            if (pass) mc::sample_bwd<true>(rw, k, sm, g6, A, a_pool, a_tex);
          } else {
            mc::sample_fwd<false>(rw, k, pool, u0, u1, u2, (float)(s % n), (float)(s / n), rot0, rot1, fetch, vis, sm);
            if (pass) mc::sample_bwd<false>(rw, k, sm, g6, A, a_pool, a_tex);
          }
          Ops d = since(s0);
          d.fp32 -= spare.fp32;
          d.mufu -= spare.mufu;
          smp[diff][pass][take_d ? 0 : 1].add(d);
        }
        if (pass) {
          Ops b0 = ops;
          mc::V3 g_gn, g_kd, g_wo;
          CF g_m, g_alpha, g_pd;
          if (diff)
            mc::row_backward<true>(rw, lv, A, g_gn, g_kd, g_m, g_wo, g_alpha, g_pd);
          else
            mc::row_backward<false>(rw, lv, A, g_gn, g_kd, g_m, g_wo, g_alpha, g_pd);
          bwd_rows = since(b0);
        }
        row[diff][pass].add({row_fwd.fp32 + bwd_rows.fp32, row_fwd.mufu + bwd_rows.mufu});
      }
    }
  }
  auto mean = [](const Count& c, bool mufu) { return c.n ? (mufu ? c.mufu : c.fp32) / c.n : 0.0; };
  std::printf("{");
  const char* bsdf[2] = {"pbr", "diffuse"};
  const char* pass[2] = {"fwd", "bwd"};
  for (int d = 0; d < 2; ++d)
    for (int p = 0; p < 2; ++p) {
      std::printf("%s\"%s_%s\": {\"row\": [%.1f, %.1f], \"cosine\": [%.1f, %.1f], \"ggx\": [%.1f, %.1f]}",
                  d || p ? ", " : "", bsdf[d], pass[p], mean(row[d][p], false), mean(row[d][p], true),
                  mean(smp[d][p][0], false), mean(smp[d][p][0], true), mean(smp[d][p][1], false),
                  mean(smp[d][p][1], true));
    }
  std::printf("}\n");
  return 0;
}
