// The per-pixel arithmetic of the MC shade's sample walk (ops/shade.py
// _ShadeWalk.block), forward and reverse, for one pixel row and one sample
// at a time, then what the kernels share to read their inputs.  Included by
// mc_shade.cu and by the card tests' probe; the arithmetic is plain C++
// apart from the function qualifiers, so a host compiler can build it too
// (with MC_ARITH_ONLY defined, the input glue is left out).
//
// Every formula mirrors the eager walk op for op, so that its products,
// sums and clamps round where PyTorch's elementwise kernels round (the
// library is built with --fmad=false):
//  * a Python float meets an f32 tensor as an f32 constant, so constants
//    are written (float)<double>;
//  * a tensor divided by a Python float is multiplied by the f32
//    reciprocal on the card (aten's div_true_kernel_cuda), `1.0 / t` is
//    t.reciprocal();
//  * torch.sum over a last axis of 3 runs two threads a row on the card,
//    so x·y sums as (x0 y0 + x2 y2) + x1 y1 (sum3);
//  * torch.linalg.cross is one kernel built with FMA contraction (msub).
// (Each read on an NVIDIA H100 with PyTorch 2.11: equal on every one of
// 2^20 random rows.)
// The reverse pass follows autograd's derivative formulas where their
// rounding reaches the bf16 light texel's cotangent (mis, pdf, radiance),
// and the chain rule elsewhere.
#pragma once

#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define MC_FN __host__ __device__ __forceinline__
#else
#define MC_FN inline
#endif

namespace mc {

constexpr double kPiD = 3.14159265358979323846;
constexpr float kPi = (float)kPiD;
constexpr float kInvPi = 1.0f / kPi;                       // x / math.pi
constexpr float kTwoPi = (float)(2.0 * kPiD);              // 2.0 * math.pi
constexpr float kInvTwoPi = 1.0f / kTwoPi;                 // x / (2.0 * math.pi)
constexpr float kTwoPi2 = (float)(2.0 * kPiD * kPiD);      // 2.0 * math.pi * math.pi
constexpr float kEps4 = (float)1e-4;
constexpr float kOneMinusEps4 = (float)(1.0 - 1e-4);
constexpr float kEps6 = (float)1e-6;
constexpr float kEps12 = (float)1e-12;
constexpr float kVhMax = (float)0.9999;
constexpr float kYLo = (float)(-1.0 + 1e-6);
constexpr float kYHi = (float)(1.0 - 1e-6);
constexpr float kMinAlpha = (float)(0.08 * 0.08);          // min_roughness ** 2
constexpr float kF0 = (float)0.04;

struct V3 {
  float x, y, z;
};

MC_FN V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
MC_FN V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
MC_FN V3 mul(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
MC_FN V3 divs(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
MC_FN void acc(V3& a, V3 b) { a.x += b.x; a.y += b.y; a.z += b.z; }
MC_FN void acc(V3& a, V3 b, float s) { a.x += b.x * s; a.y += b.y * s; a.z += b.z * s; }

// aten's reduction over a last axis of 3: two threads a row, the first
// summing elements 0 and 2, then a shuffle adds the second's.
MC_FN float sum3(float a, float b, float c) { return (a + c) + b; }
MC_FN float dot(V3 a, V3 b) { return sum3(a.x * b.x, a.y * b.y, a.z * b.z); }

// a*b - c*d as aten's cross kernel (built with FMA contraction) rounds it.
MC_FN float msub(float a, float b, float c, float d) { return fmaf(a, b, -(c * d)); }
MC_FN V3 cross(V3 a, V3 b) {
  return {msub(a.y, b.z, a.z, b.y), msub(a.z, b.x, a.x, b.z), msub(a.x, b.y, a.y, b.x)};
}
MC_FN V3 cross_plain(V3 a, V3 b) {  // the derivative's cross products (no rounding to match)
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// torch.clamp: NaN passes; the derivative flows where lo <= x (<= hi).
MC_FN float clamp_min(float x, float lo) { return x < lo ? lo : x; }
MC_FN float clamp(float x, float lo, float hi) { return x < lo ? lo : (x > hi ? hi : x); }
MC_FN bool in_min(float x, float lo) { return x >= lo; }
MC_FN bool in_range(float x, float lo, float hi) { return x >= lo && x <= hi; }

// safe_normalize: x / sqrt(max(x·x, 1e-12)).
struct Nrm {
  V3 y;
  float len;
  bool open;  // x·x >= 1e-12: the length's derivative flows
};
MC_FN Nrm normalize(V3 x) {
  const float d = dot(x, x);
  const float len = sqrtf(clamp_min(d, kEps12));
  return {divs(x, len), len, in_min(d, kEps12)};
}
MC_FN V3 normalize_bwd(const Nrm& n, V3 a_y) {
  if (!n.open) return divs(a_y, n.len);
  const float k = a_y.x * n.y.x + a_y.y * n.y.y + a_y.z * n.y.z;
  return divs(sub(a_y, mul(n.y, k)), n.len);
}

// build_orthonormal_basis (Frisvad, branchless in the eager version).
struct Onb {
  V3 t, b;
  float sign, a, bb;
};
MC_FN Onb onb(V3 n) {
  Onb o;
  o.sign = n.z >= 0.0f ? 1.0f : -1.0f;
  o.a = (1.0f / (o.sign + n.z)) * -1.0f;
  o.bb = (n.x * n.y) * o.a;
  o.t = {1.0f + ((o.sign * n.x) * n.x) * o.a, o.sign * o.bb, -o.sign * n.x};
  o.b = {o.bb, o.sign + (n.y * n.y) * o.a, -n.y};
  return o;
}
MC_FN V3 onb_bwd(const Onb& o, V3 n, V3 a_t, V3 a_b) {
  const float a_bb = o.sign * a_t.y + a_b.x;
  const float a_a = a_t.x * ((o.sign * n.x) * n.x) + a_b.y * (n.y * n.y) + a_bb * (n.x * n.y);
  V3 a_n;
  a_n.x = a_t.x * (2.0f * o.sign * n.x * o.a) - a_t.z * o.sign + a_bb * (n.y * o.a);
  a_n.y = a_b.y * (2.0f * n.y * o.a) - a_b.z + a_bb * (n.x * o.a);
  a_n.z = a_a * (o.a * o.a);
  return a_n;
}

// ---------------------------------------------------------------------------
// Per-row state: what every sample of a pixel row shares.
// ---------------------------------------------------------------------------

struct Consts {
  float inv_n2;  // 1.0 / n²
  float strata;  // 1.0 / n
  float ss, omss;  // shadow_scale, 1.0 - shadow_scale
  float hw;      // texels in the light (H · W)
  int n, lh, lw;
};

struct Leaves {
  V3 gn, kd, wo;
  float m, alpha, pd;
};

struct Row {
  V3 gn, wo;
  float alpha, pd, pspec;
  Nrm w;         // safe_normalize(gn): the frame's normal
  Onb f;         // its tangents
  // specular (bsdf "pbr")
  V3 sc;         // specular colour 0.04 (1 - m) + kd m
  float a2s;     // clamp(alpha, 0.08², 1)²: pbr_specular's
  float a2p;     // alpha²: the VNDF pdf's
  float wodn;    // wo·gn
  float lam_o;   // Smith lambda of wo
  V3 wolr;       // wo in the frame
  float g1;      // VNDF's G1(wo)
  Nrm wol;       // safe_normalize(wolr)
  Nrm vh;        // the stretched view direction
  bool t1_open;  // vh.z < 0.9999
  Nrm t1n;
  V3 t1, t2;
  float s;       // 0.5 (1 + vh.z)
};

struct LambdaGgx {
  float ct, ct2, tan2, sq, out;
};
MC_FN LambdaGgx lambda_ggx(float a2, float cos_theta) {
  LambdaGgx l;
  l.ct = clamp(cos_theta, kEps4, kOneMinusEps4);
  l.ct2 = l.ct * l.ct;
  l.tan2 = (1.0f - l.ct2) / l.ct2;
  l.sq = sqrtf(1.0f + a2 * l.tan2);
  l.out = 0.5f * (l.sq - 1.0f);
  return l;
}
// d/d(a2), d/d(cos_theta) of lambda_ggx, times a_out.
MC_FN void lambda_ggx_bwd(const LambdaGgx& l, float a2, float cos_theta, float a_out, float& a_a2,
                          float& a_cos) {
  const float a_in = (0.5f * a_out) / (2.0f * l.sq);
  a_a2 += a_in * l.tan2;
  const float a_tan2 = a_in * a2;
  const float a_ct2 = -a_tan2 / (l.ct2 * l.ct2);
  if (in_range(cos_theta, kEps4, kOneMinusEps4)) a_cos += a_ct2 * 2.0f * l.ct;
}

struct G1Ggx {
  float ct2, num, den, tan2, sq, g, out;
};
MC_FN G1Ggx g1_ggx(float a2, float c) {
  G1Ggx r;
  r.ct2 = c * c;
  r.num = clamp_min(1.0f - r.ct2, 0.0f);
  r.den = clamp_min(r.ct2, kEps12);
  r.tan2 = r.num / r.den;
  r.sq = sqrtf(1.0f + a2 * r.tan2);
  r.g = (1.0f / (1.0f + r.sq)) * 2.0f;
  r.out = c > 0.0f ? r.g : 0.0f;
  return r;
}
MC_FN void g1_ggx_bwd(const G1Ggx& r, float a2, float c, float a_out, float& a_a2, float& a_c) {
  if (!(c > 0.0f)) return;
  const float a_sq = -a_out * (r.g / (1.0f + r.sq));
  const float a_in = a_sq / (2.0f * r.sq);
  a_a2 += a_in * r.tan2;
  const float a_tan2 = a_in * a2;
  float a_ct2 = 0.0f;
  if (in_min(1.0f - r.ct2, 0.0f)) a_ct2 -= a_tan2 / r.den;
  if (in_min(r.ct2, kEps12)) a_ct2 -= a_tan2 * r.tan2 / r.den;
  a_c += a_ct2 * 2.0f * c;
}

template <bool DIFF>
MC_FN void row_forward(Row& r, const Leaves& v) {
  r.gn = v.gn;
  r.wo = v.wo;
  r.alpha = v.alpha;
  r.pd = v.pd;
  r.pspec = 1.0f - v.pd;
  r.w = normalize(v.gn);
  r.f = onb(r.w.y);
  if (DIFF) return;
  const float om = 1.0f - v.m;
  r.sc = {kF0 * om + v.kd.x * v.m, kF0 * om + v.kd.y * v.m, kF0 * om + v.kd.z * v.m};
  const float ac = clamp(v.alpha, kMinAlpha, 1.0f);
  r.a2s = ac * ac;
  r.a2p = v.alpha * v.alpha;
  r.wodn = dot(v.wo, v.gn);
  r.lam_o = lambda_ggx(r.a2s, r.wodn).out;
  r.wolr = {dot(v.wo, r.f.t), dot(v.wo, r.f.b), dot(v.wo, r.w.y)};
  r.g1 = g1_ggx(r.a2p, r.wolr.z).out;
  r.wol = normalize(r.wolr);
  r.vh = normalize(V3{v.alpha * r.wol.y.x, v.alpha * r.wol.y.y, r.wol.y.z});
  const V3 vh = r.vh.y;
  r.t1_open = vh.z < kVhMax;
  if (r.t1_open) {
    r.t1n = normalize(cross(V3{0.0f, 0.0f, 1.0f}, vh));
    r.t1 = r.t1n.y;
  } else {
    r.t1 = {1.0f, 0.0f, 0.0f};
  }
  r.t2 = cross(vh, r.t1);
  r.s = 0.5f * (1.0f + vh.z);
}

// Cotangents of the row state, summed over the samples of a block.
struct RowAdj {
  V3 gn, wo, sc, w, t, b, wolr, wol, vh, t1, t2;
  float wodn, lam_o, a2s, a2p, pd, pspec, alpha, g1, s;
};

MC_FN V3 zero3() { return {0.0f, 0.0f, 0.0f}; }
MC_FN void clear(RowAdj& A) {
  A.gn = A.wo = A.sc = A.w = A.t = A.b = A.wolr = A.wol = A.vh = A.t1 = A.t2 = zero3();
  A.wodn = A.lam_o = A.a2s = A.a2p = A.pd = A.pspec = A.alpha = A.g1 = A.s = 0.0f;
}

// The row state's cotangents carried back to the six per-row inputs.
template <bool DIFF>
MC_FN void row_backward(const Row& r, const Leaves& v, RowAdj A, V3& g_gn, V3& g_kd, float& g_m, V3& g_wo,
                        float& g_alpha, float& g_pd) {
  g_kd = zero3();
  g_m = 0.0f;
  g_wo = zero3();
  g_alpha = 0.0f;
  g_pd = 0.0f;
  if (!DIFF) {
    const V3 vh = r.vh.y;
    // s = 0.5 (1 + vh.z)
    A.vh.z += 0.5f * A.s;
    // t2 = vh × t1
    acc(A.vh, cross_plain(r.t1, A.t2));
    acc(A.t1, cross_plain(A.t2, vh));
    // t1 = normalize((0, 0, 1) × vh) = normalize((-vh.y, vh.x, 0))
    if (r.t1_open) {
      const V3 a_c = normalize_bwd(r.t1n, A.t1);
      A.vh.x += a_c.y;
      A.vh.y -= a_c.x;
    }
    // vh = normalize(alpha wol.x, alpha wol.y, wol.z)
    const V3 a_vhr = normalize_bwd(r.vh, A.vh);
    A.alpha += a_vhr.x * r.wol.y.x + a_vhr.y * r.wol.y.y;
    A.wol.x += a_vhr.x * v.alpha;
    A.wol.y += a_vhr.y * v.alpha;
    A.wol.z += a_vhr.z;
    acc(A.wolr, normalize_bwd(r.wol, A.wol));
    // g1 = G1(alpha², wolr.z)
    g1_ggx_bwd(g1_ggx(r.a2p, r.wolr.z), r.a2p, r.wolr.z, A.g1, A.a2p, A.wolr.z);
    // wolr = (wo·t, wo·b, wo·w)
    acc(g_wo, r.f.t, A.wolr.x);
    acc(g_wo, r.f.b, A.wolr.y);
    acc(g_wo, r.w.y, A.wolr.z);
    acc(A.t, v.wo, A.wolr.x);
    acc(A.b, v.wo, A.wolr.y);
    acc(A.w, v.wo, A.wolr.z);
    // lam_o = lambda(a2s, wodn)
    lambda_ggx_bwd(lambda_ggx(r.a2s, r.wodn), r.a2s, r.wodn, A.lam_o, A.a2s, A.wodn);
    acc(g_wo, v.gn, A.wodn);
    acc(A.gn, v.wo, A.wodn);
    // a2s = clamp(alpha, 0.08², 1)², a2p = alpha²
    if (in_range(v.alpha, kMinAlpha, 1.0f)) A.alpha += A.a2s * 2.0f * v.alpha;
    A.alpha += A.a2p * 2.0f * v.alpha;
    // sc = 0.04 (1 - m) + kd m
    g_kd = mul(A.sc, v.m);
    g_m = A.sc.x * (v.kd.x - kF0) + A.sc.y * (v.kd.y - kF0) + A.sc.z * (v.kd.z - kF0);
    A.pd -= A.pspec;
    g_alpha = A.alpha;
    g_pd = A.pd;
  }
  acc(A.w, onb_bwd(r.f, r.w.y, A.t, A.b));
  acc(A.gn, normalize_bwd(r.w, A.w));
  g_gn = A.gn;
  acc(g_wo, A.wo);
}

// ---------------------------------------------------------------------------
// One sample: both strategies, forward and reverse.
// ---------------------------------------------------------------------------

// The GGX-VNDF strategy's pdf of direction wi (ggx_pdf).
struct GgxPdf {
  V3 wi, wil;
  Nrm mh;
  float wodh, c, dd, d, cw, num1, den1, t, den2, pdf, out;
  bool ok;
};
template <bool DIFF>
MC_FN void ggx_pdf_fwd(const Row& r, V3 wi, GgxPdf& g) {
  g.wi = wi;
  g.wil = {dot(wi, r.f.t), dot(wi, r.f.b), dot(wi, r.w.y)};
  g.mh = normalize(add(g.wil, r.wolr));
  g.wodh = dot(g.mh.y, r.wolr);
  g.c = g.mh.y.z;
  g.dd = (g.c * r.a2p - g.c) * g.c + 1.0f;
  g.d = r.a2p / ((g.dd * g.dd) * kPi);
  g.cw = clamp_min(g.wodh, 0.0f);
  g.num1 = (r.g1 * g.d) * g.cw;
  g.den1 = clamp_min(r.wolr.z, kEps6);
  g.t = g.num1 / g.den1;
  g.den2 = clamp_min(4.0f * g.wodh, kEps6);
  g.pdf = g.t / g.den2;
  g.ok = r.wolr.z > 0.0f && g.wil.z > 0.0f;
  g.out = g.ok ? g.pdf : 0.0f;
}
// Adds d(out)/d(wi) · a_out to a_wi and the row state's cotangents to A.
MC_FN void ggx_pdf_bwd(const Row& r, const GgxPdf& g, float a_out, RowAdj& A, V3& a_wi) {
  if (!g.ok) return;
  const float a_t = a_out / g.den2;
  float a_wodh = 0.0f;
  if (in_min(4.0f * g.wodh, kEps6)) a_wodh += (-a_out * g.pdf / g.den2) * 4.0f;
  const float a_num1 = a_t / g.den1;
  if (in_min(r.wolr.z, kEps6)) A.wolr.z += -a_t * g.t / g.den1;
  A.g1 += a_num1 * g.cw * g.d;
  const float a_d = a_num1 * g.cw * r.g1;
  if (in_min(g.wodh, 0.0f)) a_wodh += a_num1 * (r.g1 * g.d);
  // d = a2 / (dd² π), dd = (c a2 - c) c + 1
  A.a2p += a_d / ((g.dd * g.dd) * kPi);
  const float a_dd = -a_d * 2.0f * g.d / g.dd;
  A.a2p += a_dd * g.c * g.c;
  V3 a_mh = mul(r.wolr, a_wodh);
  a_mh.z += a_dd * 2.0f * g.c * (r.a2p - 1.0f);
  acc(A.wolr, g.mh.y, a_wodh);
  const V3 a_hs = normalize_bwd(g.mh, a_mh);
  acc(A.wolr, a_hs);
  // wil = (wi·t, wi·b, wi·w)
  acc(a_wi, r.f.t, a_hs.x);
  acc(a_wi, r.f.b, a_hs.y);
  acc(a_wi, r.w.y, a_hs.z);
  acc(A.t, g.wi, a_hs.x);
  acc(A.b, g.wi, a_hs.y);
  acc(A.w, g.wi, a_hs.z);
}

// eval_sample: the lobes at direction dir, MIS-weighted (d, s).
struct Eval {
  float pc, mis, ndl, diff, v, wgt;
  float Xd[3], Xs[3], d[3], s[3];
  // specular
  Nrm h;
  float wodh, ndh, ctd, dd, D, G, gden, ctf, q, p5, den;
  LambdaGgx lam_i;
  float F[3], w[3];
  bool ff;
};
template <bool DIFF>
MC_FN void eval_fwd(const Row& r, const Consts& k, V3 dir, float psum, float vis, const float col[3], Eval& e) {
  e.pc = clamp_min(psum, kEps4);
  e.mis = (1.0f / e.pc) * 1.0f;
  e.ndl = dot(r.gn, dir);
  e.diff = clamp_min(e.ndl, 0.0f) * kInvPi;
  float spec[3] = {0.0f, 0.0f, 0.0f};
  if (!DIFF) {
    e.h = normalize(add(r.wo, dir));
    e.wodh = dot(r.wo, e.h.y);
    e.ndh = dot(r.gn, e.h.y);
    e.ctd = clamp(e.ndh, kEps4, kOneMinusEps4);
    e.dd = (e.ctd * r.a2s - e.ctd) * e.ctd + 1.0f;
    e.D = r.a2s / ((e.dd * e.dd) * kPi);
    e.lam_i = lambda_ggx(r.a2s, e.ndl);  // wi·n: the same products as n·wi
    e.gden = (1.0f + r.lam_o) + e.lam_i.out;
    e.G = 1.0f / e.gden;
    e.ctf = clamp(e.wodh, kEps4, kOneMinusEps4);
    e.q = 1.0f - e.ctf;
    e.p5 = powf(e.q, 5.0f);
    e.den = clamp_min(r.wodn, kEps4);
    e.ff = r.wodn > kEps4 && e.ndl > kEps4;
    const float sc[3] = {r.sc.x, r.sc.y, r.sc.z};
    for (int c = 0; c < 3; ++c) {
      e.F[c] = sc[c] + (1.0f - sc[c]) * e.p5;
      e.w[c] = (((e.F[c] * e.D) * e.G) * 0.25f) / e.den;
      spec[c] = e.ff ? e.w[c] : 0.0f;
    }
  }
  e.v = vis * k.ss + k.omss;
  e.wgt = (e.mis * k.inv_n2) * e.v;
  for (int c = 0; c < 3; ++c) {
    e.Xd[c] = e.diff * col[c];
    e.d[c] = e.Xd[c] * e.wgt;
    e.Xs[c] = spec[c] * col[c];
    e.s[c] = e.Xs[c] * e.wgt;
  }
}
// From the cotangents gd, gs of (d, s): those of col (a_col, as autograd
// rounds them), of psum (a_psum, likewise) and, added, of dir.
template <bool DIFF>
MC_FN void eval_bwd(const Row& r, const Consts& k, V3 dir, float psum, const float col[3], const Eval& e,
                    const float gd[3], const float gs[3], RowAdj& A, V3& a_dir, float& a_psum, float a_col[3]) {
  float a_wgt = sum3(gd[0] * e.Xd[0], gd[1] * e.Xd[1], gd[2] * e.Xd[2]);
  if (!DIFF) a_wgt = a_wgt + sum3(gs[0] * e.Xs[0], gs[1] * e.Xs[1], gs[2] * e.Xs[2]);
  const float a_mis = (a_wgt * e.v) * k.inv_n2;
  a_psum = in_min(psum, kEps4) ? (-a_mis) * (e.mis * e.mis) : 0.0f;
  float a_diff = 0.0f, a_spec[3];
  for (int c = 0; c < 3; ++c) {
    const float gx = gd[c] * e.wgt;
    a_col[c] = gx * e.diff;
    a_diff += gx * col[c];
    if (!DIFF) {
      const float gy = gs[c] * e.wgt;
      const float spec = e.ff ? e.w[c] : 0.0f;
      a_col[c] = a_col[c] + gy * spec;
      a_spec[c] = gy * col[c];
    }
  }
  float a_ndl = in_min(e.ndl, 0.0f) ? a_diff * kInvPi : 0.0f;
  if (!DIFF && e.ff) {
    const float sc[3] = {r.sc.x, r.sc.y, r.sc.z};
    float a_D = 0.0f, a_G = 0.0f, a_p5 = 0.0f, a_den = 0.0f;
    float a_sc[3];
    for (int c = 0; c < 3; ++c) {
      const float a_w = a_spec[c];
      const float a_num = a_w / e.den;
      a_den -= a_w * e.w[c] / e.den;
      const float a_fdg = a_num * 0.25f;
      const float a_fd = a_fdg * e.G;
      a_G += a_fdg * (e.F[c] * e.D);
      const float a_f = a_fd * e.D;
      a_D += a_fd * e.F[c];
      a_sc[c] = a_f * (1.0f - e.p5);
      a_p5 += a_f * (1.0f - sc[c]);
    }
    A.sc.x += a_sc[0];
    A.sc.y += a_sc[1];
    A.sc.z += a_sc[2];
    if (in_min(r.wodn, kEps4)) A.wodn += a_den;
    // p5 = (1 - clamp(wodh))^5
    const float a_q = a_p5 * (5.0f * powf(e.q, 4.0f));
    const float a_wodh = in_range(e.wodh, kEps4, kOneMinusEps4) ? -a_q : 0.0f;
    // G = 1 / ((1 + lam_o) + lam_i)
    const float a_gden = -a_G * (e.G * e.G);
    A.lam_o += a_gden;
    lambda_ggx_bwd(e.lam_i, r.a2s, e.ndl, a_gden, A.a2s, a_ndl);
    // D = a2s / (dd² π), dd = (ctd a2s - ctd) ctd + 1
    A.a2s += a_D / ((e.dd * e.dd) * kPi);
    const float a_dd = -a_D * 2.0f * e.D / e.dd;
    A.a2s += a_dd * e.ctd * e.ctd;
    const float a_ndh = in_range(e.ndh, kEps4, kOneMinusEps4) ? a_dd * (2.0f * e.ctd * (r.a2s - 1.0f)) : 0.0f;
    // ndh = gn·h, wodh = wo·h, h = normalize(wo + dir)
    acc(A.gn, e.h.y, a_ndh);
    acc(A.wo, e.h.y, a_wodh);
    V3 a_h = mul(r.gn, a_ndh);
    acc(a_h, r.wo, a_wodh);
    const V3 a_hs = normalize_bwd(e.h, a_h);
    acc(A.wo, a_hs);
    acc(a_dir, a_hs);
  }
  // ndl = gn·dir
  acc(A.gn, dir, a_ndl);
  acc(a_dir, r.gn, a_ndl);
}

// The cosine strategy's sample of the frame (cosine_sample).
struct CosSample {
  float x, y, ct, pdf;
  Nrm wi;
};
MC_FN void cos_sample_fwd(const Row& r, float u, float v, CosSample& cs) {
  const float phi = kTwoPi * u;
  cs.ct = sqrtf(clamp(v, 0.0f, 1.0f));
  const float st = sqrtf(clamp(1.0f - v, 0.0f, 1.0f));
  cs.x = cosf(phi) * st;
  cs.y = sinf(phi) * st;
  cs.pdf = clamp_min(cs.ct * kInvPi, kEps6);
  cs.wi = normalize(add(add(mul(r.f.t, cs.x), mul(r.f.b, cs.y)), mul(r.w.y, cs.ct)));
}
MC_FN void cos_sample_bwd(const CosSample& cs, V3 a_wi, RowAdj& A) {
  const V3 a_vec = normalize_bwd(cs.wi, a_wi);
  acc(A.t, a_vec, cs.x);
  acc(A.b, a_vec, cs.y);
  acc(A.w, a_vec, cs.ct);
}

// The GGX-VNDF strategy's sample (ggx_sample, Heitz's visible normals).
struct GgxSample {
  float p1, p2a, sq1, p2, x3, sq, wodh;
  V3 nh, wil;
  Nrm h, wi;
  bool ok;
  V3 out;
};
MC_FN void ggx_sample_fwd(const Row& r, float ux, float uy, GgxSample& g) {
  const float rr = sqrtf(clamp(ux, 0.0f, 1.0f));
  const float phi = kTwoPi * uy;
  g.p1 = rr * cosf(phi);
  g.p2a = rr * sinf(phi);
  g.sq1 = sqrtf(clamp(1.0f - g.p1 * g.p1, 0.0f, 1.0f));
  g.p2 = (1.0f - r.s) * g.sq1 + r.s * g.p2a;
  g.x3 = (1.0f - g.p1 * g.p1) - g.p2 * g.p2;
  g.sq = g.x3 > 0.0f ? sqrtf(g.x3) : 0.0f;
  g.nh = add(add(mul(r.t1, g.p1), mul(r.t2, g.p2)), mul(r.vh.y, g.sq));
  g.h = normalize(V3{r.alpha * g.nh.x, r.alpha * g.nh.y, clamp_min(g.nh.z, 0.0f)});
  g.wodh = dot(r.wol.y, g.h.y);
  g.wil = sub(mul(mul(g.h.y, g.wodh), 2.0f), r.wol.y);
  g.wi = normalize(add(add(mul(r.f.t, g.wil.x), mul(r.f.b, g.wil.y)), mul(r.w.y, g.wil.z)));
  g.ok = r.wol.y.z > 0.0f;
  g.out = g.ok ? g.wi.y : zero3();
}
MC_FN void ggx_sample_bwd(const Row& r, const GgxSample& g, V3 a_out, RowAdj& A) {
  if (!g.ok) return;
  const V3 a_wiw = normalize_bwd(g.wi, a_out);
  acc(A.t, a_wiw, g.wil.x);
  acc(A.b, a_wiw, g.wil.y);
  acc(A.w, a_wiw, g.wil.z);
  const V3 a_wil = {dot(a_wiw, r.f.t), dot(a_wiw, r.f.b), dot(a_wiw, r.w.y)};
  // wil = 2 (h·wol) h - wol
  V3 a_h = mul(a_wil, 2.0f * g.wodh);
  const float a_wodh = 2.0f * dot(a_wil, g.h.y);
  A.wol = sub(A.wol, a_wil);
  acc(A.wol, g.h.y, a_wodh);
  acc(a_h, r.wol.y, a_wodh);
  // h = normalize(alpha nh.x, alpha nh.y, max(nh.z, 0))
  const V3 a_hr = normalize_bwd(g.h, a_h);
  A.alpha += a_hr.x * g.nh.x + a_hr.y * g.nh.y;
  const V3 a_nh = {a_hr.x * r.alpha, a_hr.y * r.alpha, in_min(g.nh.z, 0.0f) ? a_hr.z : 0.0f};
  // nh = (t1 p1 + t2 p2) + vh sq
  acc(A.t1, a_nh, g.p1);
  acc(A.t2, a_nh, g.p2);
  acc(A.vh, a_nh, g.sq);
  float a_p2 = dot(a_nh, r.t2);
  if (g.x3 > 0.0f) a_p2 += (dot(a_nh, r.vh.y) / (2.0f * g.sq)) * (-2.0f * g.p2);
  // p2 = (1 - s) sq1 + s p2a
  A.s += a_p2 * (g.p2a - g.sq1);
}

// The light's texels in the lat-long map.
struct Latlong {
  float cy, vv, sinv, sint, den;
  int64_t tidx;
};
MC_FN void latlong_fwd(const Consts& k, V3 d, Latlong& l) {
  const float uu = atan2f(d.x, -d.z) * kInvTwoPi + 0.5f;
  l.cy = clamp(d.y, kYLo, kYHi);
  l.vv = acosf(l.cy) * kInvPi;
  int64_t lx = (int64_t)(uu * (float)k.lw);
  int64_t ly = (int64_t)(l.vv * (float)k.lh);
  lx = lx < 0 ? 0 : (lx > k.lw - 1 ? k.lw - 1 : lx);
  ly = ly < 0 ? 0 : (ly > k.lh - 1 ? k.lh - 1 : ly);
  l.tidx = ly * k.lw + lx;
  l.sinv = sinf(l.vv * kPi);
  l.sint = clamp_min(l.sinv, kEps4);
  l.den = kTwoPi2 * l.sint;
}

// Everything one sample computes that its reverse pass reads.
struct Sample {
  // strategy 1: light sample from the pool
  V3 L;
  float pl, col1[3], ndl1, cp1, pdfb1;
  bool degen1;
  GgxPdf gp1;
  Eval e1;
  // strategy 2: BSDF sample
  CosSample cs;
  GgxSample gs;
  bool take_d, degen;
  V3 wi, dir2;
  float ndw, cpw, pdf, pdfb2;
  GgxPdf gp2;
  Latlong ll;
  float tex[4], pdfl2;
  Eval e2;
};

// The forward of one sample: s.e1.d + s.e2.d, s.e1.s + s.e2.s.  ``pool``
// is the pool entry (dir, pdf, radiance); ``fetch(i, t)`` reads texel i as
// f32; ``vis(dir)`` is the shadow test along dir (1 = lit).
template <bool DIFF, class Fetch, class Vis>
MC_FN void sample_fwd(const Row& r, const Consts& k, const float pool[7], float u0, float u1, float u2, float sxi,
                      float syi, float rot0, float rot1, Fetch fetch, Vis vis, Sample& s) {
  // strategy 1
  s.L = {pool[0], pool[1], pool[2]};
  s.pl = pool[3];
  s.col1[0] = pool[4];
  s.col1[1] = pool[5];
  s.col1[2] = pool[6];
  s.ndl1 = dot(r.gn, s.L);
  s.cp1 = clamp_min(s.ndl1, 0.0f) * kInvPi;
  if (DIFF) {
    s.pdfb1 = s.cp1;
  } else {
    const float mn = r.wodn < s.ndl1 ? r.wodn : s.ndl1;
    s.degen1 = r.wodn == r.wodn && s.ndl1 == s.ndl1 && mn < kEps6;  // torch.minimum keeps a NaN
    const float dterm = r.pd > kEps6 ? r.pd * s.cp1 : 0.0f;
    ggx_pdf_fwd<DIFF>(r, s.L, s.gp1);
    const float sterm = r.pspec > kEps6 ? r.pspec * s.gp1.out : 0.0f;
    s.pdfb1 = s.degen1 ? 1.0f : dterm + sterm;
  }
  eval_fwd<DIFF>(r, k, s.L, s.pl + s.pdfb1, vis(s.L), s.col1, s.e1);

  // strategy 2
  const float bu = fmodf((sxi + u0) * k.strata + rot0, 1.0f);
  const float bv = fmodf((syi + u1) * k.strata + rot1, 1.0f);
  cos_sample_fwd(r, bu, bv, s.cs);
  float pdfb2;
  if (DIFF) {
    s.dir2 = s.cs.wi.y;
    pdfb2 = clamp_min(s.cs.pdf, kEps6);
  } else {
    ggx_sample_fwd(r, bu, bv, s.gs);
    s.take_d = u2 < r.pd;
    s.wi = s.take_d ? s.cs.wi.y : s.gs.out;
    s.ndw = dot(r.gn, s.wi);
    s.cpw = clamp_min(s.ndw, 0.0f) * kInvPi;
    const float dterm = r.pd > kEps6 ? r.pd * s.cpw : 0.0f;
    ggx_pdf_fwd<DIFF>(r, s.wi, s.gp2);
    const float sterm = r.pspec > kEps6 ? r.pspec * s.gp2.out : 0.0f;
    s.pdf = dterm + sterm;
    s.degen = s.take_d && r.pd < kEps4;
    s.dir2 = s.degen ? r.gn : s.wi;
    pdfb2 = s.degen ? 1.0f : s.pdf;
  }
  s.pdfb2 = pdfb2;
  latlong_fwd(k, s.dir2, s.ll);
  fetch(s.ll.tidx, s.tex);
  s.pdfl2 = (s.tex[3] * k.hw) / s.ll.den;
  eval_fwd<DIFF>(r, k, s.dir2, s.pdfl2 + s.pdfb2, vis(s.dir2), s.tex, s.e2);
}

// The reverse of one sample from the cotangent g (6,) of its (d, s): adds
// to the row state's cotangents A, and gives the pool entry's cotangent
// (7,) and the light texel's (4,), each as autograd rounds it in f32.
template <bool DIFF>
MC_FN void sample_bwd(const Row& r, const Consts& k, const Sample& s, const float g[6], RowAdj& A, float a_pool[7],
                      float a_tex[4]) {
  const float* gd = g;
  const float* gs = g + 3;

  // strategy 2
  V3 a_dir2 = zero3();
  float a_psum2;
  eval_bwd<DIFF>(r, k, s.dir2, s.pdfl2 + s.pdfb2, s.tex, s.e2, gd, gs, A, a_dir2, a_psum2, a_tex);
  // pdfl2 = (tex3 · HW) / (2π² max(sin(vv π), 1e-4)), vv = acos(clamp(dir2.y)) / π
  a_tex[3] = (a_psum2 / s.ll.den) * k.hw;
  const float a_den = -a_psum2 * s.pdfl2 / s.ll.den;
  if (in_min(s.ll.sinv, kEps4)) {
    const float a_vv = (a_den * kTwoPi2) * cosf(s.ll.vv * kPi) * kPi;
    const float a_cy = -(a_vv * kInvPi) / sqrtf(1.0f - s.ll.cy * s.ll.cy);
    if (in_range(s.dir2.y, kYLo, kYHi)) a_dir2.y += a_cy;
  }
  if (DIFF) {
    cos_sample_bwd(s.cs, a_dir2, A);
  } else if (s.degen) {
    acc(A.gn, a_dir2);
  } else {
    // pdf = [pd > 1e-6] pd max(gn·wi, 0)/π + [pspec > 1e-6] pspec ggx_pdf(wi)
    V3 a_wi = a_dir2;
    const float a_pdf = a_psum2;
    if (r.pd > kEps6) {
      A.pd += a_pdf * s.cpw;
      if (in_min(s.ndw, 0.0f)) {
        const float a_ndw = (a_pdf * r.pd) * kInvPi;
        acc(A.gn, s.wi, a_ndw);
        acc(a_wi, r.gn, a_ndw);
      }
    }
    if (r.pspec > kEps6) {
      A.pspec += a_pdf * s.gp2.out;
      ggx_pdf_bwd(r, s.gp2, a_pdf * r.pspec, A, a_wi);
    }
    if (s.take_d)
      cos_sample_bwd(s.cs, a_wi, A);
    else
      ggx_sample_bwd(r, s.gs, a_wi, A);
  }

  // strategy 1
  V3 a_L = zero3();
  float a_psum1;
  eval_bwd<DIFF>(r, k, s.L, s.pl + s.pdfb1, s.col1, s.e1, gd, gs, A, a_L, a_psum1, a_pool + 4);
  a_pool[3] = a_psum1;
  float a_ndl1 = 0.0f;
  if (DIFF) {
    if (in_min(s.ndl1, 0.0f)) a_ndl1 = a_psum1 * kInvPi;
  } else if (!s.degen1) {
    if (r.pd > kEps6) {
      A.pd += a_psum1 * s.cp1;
      if (in_min(s.ndl1, 0.0f)) a_ndl1 = (a_psum1 * r.pd) * kInvPi;
    }
    if (r.pspec > kEps6) {
      A.pspec += a_psum1 * s.gp1.out;
      ggx_pdf_bwd(r, s.gp1, a_psum1 * r.pspec, A, a_L);
    }
  }
  acc(A.gn, s.L, a_ndl1);
  acc(a_L, r.gn, a_ndl1);
  a_pool[0] = a_L.x;
  a_pool[1] = a_L.y;
  a_pool[2] = a_L.z;
}

// The shadow field's lookup (apply_visibility of a ShadowField): 1 where
// the light reaches ro along rd.
struct Field {
  const long long* bits;  // (K · n · n · words,) 32 bits a word
  int ko, r, words;
  float t0;
  float amin[3], ascale[3];
};
MC_FN float field_vis(const Field& f, V3 ro, V3 rd) {
  if (f.bits == nullptr) return 1.0f;
  const float s = clamp_min((fabsf(rd.x) + fabsf(rd.y)) + fabsf(rd.z), kEps12);
  const float px = rd.x / s, py = rd.y / s;
  const float px2 = (1.0f - fabsf(py)) * (px >= 0.0f ? 1.0f : -1.0f);
  const float py2 = (1.0f - fabsf(px)) * (py >= 0.0f ? 1.0f : -1.0f);
  const bool neg = rd.z < 0.0f;
  const float u = (neg ? px2 : px) * 0.5f + 0.5f;
  const float v = (neg ? py2 : py) * 0.5f + 0.5f;
  int64_t iu = (int64_t)(u * (float)f.ko), iv = (int64_t)(v * (float)f.ko);
  iu = iu < 0 ? 0 : (iu > f.ko - 1 ? f.ko - 1 : iu);
  iv = iv < 0 ? 0 : (iv > f.ko - 1 ? f.ko - 1 : iv);
  const int64_t kb = iu * f.ko + iv;
  const float rf = (float)f.r;
  const float q[3] = {(((ro.x + rd.x * f.t0) - f.amin[0]) * f.ascale[0]) * rf,
                      (((ro.y + rd.y * f.t0) - f.amin[1]) * f.ascale[1]) * rf,
                      (((ro.z + rd.z * f.t0) - f.amin[2]) * f.ascale[2]) * rf};
  int64_t qi[3];
  bool inside = true;
  for (int c = 0; c < 3; ++c) {
    inside = inside && q[c] >= 0.0f && q[c] <= rf;
    int64_t v2 = (int64_t)rintf(q[c]);
    qi[c] = v2 < 0 ? 0 : (v2 > f.r ? f.r : v2);
  }
  if (!inside) return 1.0f;
  const int64_t n = f.r + 1;
  const int64_t idx = ((kb * n + qi[0]) * n + qi[1]) * f.words + qi[2] / 32;
  const long long occ = (f.bits[idx] >> (qi[2] % 32)) & 1;
  return 1.0f - (float)occ;
}

// The SDF marcher (apply_visibility of an SdfVisibility, ops/shade.py
// _march and trilinear_sdf): n_steps grid samples at t0 + dt (i + 1/2)
// along the ray, nearest or trilinear; 1 where none exceeds the threshold.
struct March {
  const float* grid;  // (r + 1)³ f32, or null: no marcher
  int r, n_steps, trilinear;
  float t0, dt, thr;
  float hi;  // r - 1e-4 in f32: the trilinear clamp's top
  float amin[3], ascale[3];
};
MC_FN float march_vis(const March& m, V3 ro, V3 rd) {
  const int64_t n = m.r + 1;
  const float rf = (float)m.r;
  float occ = -INFINITY;
  for (int i = 0; i < m.n_steps; ++i) {
    const float t = m.t0 + m.dt * ((float)i + 0.5f);
    const float q[3] = {(((ro.x + rd.x * t) - m.amin[0]) * m.ascale[0]) * rf,
                        (((ro.y + rd.y * t) - m.amin[1]) * m.ascale[1]) * rf,
                        (((ro.z + rd.z * t) - m.amin[2]) * m.ascale[2]) * rf};
    bool inside = true;
    for (int c = 0; c < 3; ++c) inside = inside && q[c] >= 0.0f && q[c] <= rf;
    float s = -1.0f;
    if (inside && !m.trilinear) {
      int64_t qi[3];
      for (int c = 0; c < 3; ++c) {
        const int64_t v = (int64_t)rintf(q[c]);
        qi[c] = v < 0 ? 0 : (v > m.r ? m.r : v);
      }
      s = m.grid[(qi[0] * n + qi[1]) * n + qi[2]];
    } else if (inside) {
      int64_t i0[3], i1[3];
      float w[3];
      for (int c = 0; c < 3; ++c) {
        const float qc = clamp(q[c], 0.0f, m.hi);
        i0[c] = (int64_t)floorf(qc);
        w[c] = qc - (float)i0[c];
        i1[c] = i0[c] + 1 > m.r ? m.r : i0[c] + 1;
      }
      auto g = [&](int64_t x, int64_t y, int64_t z) { return m.grid[(x * n + y) * n + z]; };
      const float ox = 1.0f - w[0], oy = 1.0f - w[1], oz = 1.0f - w[2];
      const float c00 = g(i0[0], i0[1], i0[2]) * oz + g(i0[0], i0[1], i1[2]) * w[2];
      const float c01 = g(i0[0], i1[1], i0[2]) * oz + g(i0[0], i1[1], i1[2]) * w[2];
      const float c10 = g(i1[0], i0[1], i0[2]) * oz + g(i1[0], i0[1], i1[2]) * w[2];
      const float c11 = g(i1[0], i1[1], i0[2]) * oz + g(i1[0], i1[1], i1[2]) * w[2];
      const float c0 = c00 * oy + c01 * w[1];
      const float c1 = c10 * oy + c11 * w[1];
      s = c0 * ox + c1 * w[0];
    }
    occ = occ != occ || s <= occ ? occ : s;  // torch.maximum: a NaN wins
  }
  return occ <= m.thr ? 1.0f : 0.0f;
}

}  // namespace mc

#ifndef MC_ARITH_ONLY
namespace mc {

// Arguments of both passes (a ctypes.Structure in utils/kernels.py).
struct Args {
  const float* rows;  // (P, 18) f32: gn 3, kd 3, metallic, wo 3, alpha, p_diffuse, ro 3, rot 2, mask
  long long P;
  const float* u;         // (n², P, 3) f32: the BSDF strategy's draws
  const long long* c;     // (n²,): the pool's rotation a sample
  const float* pool;      // (n², n_pool, 7) f32: dir, pdf, radiance
  long long n_pool;
  const void* light;      // (lh · lw, 4) bf16 or f32: radiance, selection pdf
  int light_bf16, diffuse_only, n, lh, lw;
  float inv_n2, strata, ss, omss, hw;
  // visibility: the shadow field's bits, or the marcher's grid, or neither
  const long long* field;
  const float* grid;
  int ko, r, words, n_steps, trilinear;
  float t0, dt, thr, hi, amin[3], ascale[3];
  // forward
  float* out;                  // (P, 6): diffuse, specular
  unsigned long long* stats;   // (2,): rows shaded, rows skipped
  // reverse of samples [j0, j0 + k)
  const float* g;              // (P, 6)
  float* g_rows;               // (P, 12), added to
  float* g_pool;               // like pool, added to; or null
  float* scratch;              // (lh · lw · 4) f32, zero on entry and on exit; or null
  void* g_light;               // like light, added to; or null
  int j0, k;
};

MC_FN float bf16_bits_to_f32(uint16_t b) {
  union { uint32_t u; float f; } v;
  v.u = (uint32_t)b << 16;
  return v.f;
}
// Round to nearest even, as c10::BFloat16 does.
MC_FN uint16_t f32_to_bf16_bits(float f) {
  union { uint32_t u; float f; } v;
  v.f = f;
  if (f != f) return 0x7fc0;
  return (uint16_t)((v.u + 0x7fffu + ((v.u >> 16) & 1u)) >> 16);
}

// The light's texel i as f32, and a cotangent rounded to the light's dtype.
template <typename LT>
struct Fetch;
template <>
struct Fetch<float> {
  const float* p;
  MC_FN void operator()(int64_t i, float t[4]) const {
#if defined(__CUDA_ARCH__)
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    t[0] = v.x;
    t[1] = v.y;
    t[2] = v.z;
    t[3] = v.w;
#else
    for (int q = 0; q < 4; ++q) t[q] = p[i * 4 + q];
#endif
  }
  MC_FN static float round(float x) { return x; }
};
struct Bf16x4 {
  uint16_t v[4];
};
template <>
struct Fetch<Bf16x4> {
  const Bf16x4* p;
  MC_FN void operator()(int64_t i, float t[4]) const {
#if defined(__CUDA_ARCH__)
    const uint2 raw = reinterpret_cast<const uint2*>(p)[i];
    t[0] = bf16_bits_to_f32((uint16_t)(raw.x & 0xffffu));
    t[1] = bf16_bits_to_f32((uint16_t)(raw.x >> 16));
    t[2] = bf16_bits_to_f32((uint16_t)(raw.y & 0xffffu));
    t[3] = bf16_bits_to_f32((uint16_t)(raw.y >> 16));
#else
    for (int q = 0; q < 4; ++q) t[q] = bf16_bits_to_f32(p[i].v[q]);
#endif
  }
  MC_FN static float round(float x) { return bf16_bits_to_f32(f32_to_bf16_bits(x)); }
};

// The shadow test along a sample's direction from the row's origin.
struct Vis {
  Field f;
  March m;
  V3 ro;
  MC_FN float operator()(V3 d) const { return m.grid ? march_vis(m, ro, d) : field_vis(f, ro, d); }
};

MC_FN Consts consts_of(const Args& a) {
  Consts k;
  k.inv_n2 = a.inv_n2;
  k.strata = a.strata;
  k.ss = a.ss;
  k.omss = a.omss;
  k.hw = a.hw;
  k.n = a.n;
  k.lh = a.lh;
  k.lw = a.lw;
  return k;
}

MC_FN Vis vis_of(const Args& a, V3 ro) {
  Vis v;
  v.f.bits = a.field;
  v.m.grid = a.grid;
  v.f.ko = a.ko;
  v.f.r = v.m.r = a.r;
  v.f.words = a.words;
  v.f.t0 = v.m.t0 = a.t0;
  v.m.n_steps = a.n_steps;
  v.m.trilinear = a.trilinear;
  v.m.dt = a.dt;
  v.m.thr = a.thr;
  v.m.hi = a.hi;
  for (int i = 0; i < 3; ++i) {
    v.f.amin[i] = v.m.amin[i] = a.amin[i];
    v.f.ascale[i] = v.m.ascale[i] = a.ascale[i];
  }
  v.ro = ro;
  return v;
}

MC_FN Leaves leaves_of(const float* row) {
  Leaves v;
  v.gn = {row[0], row[1], row[2]};
  v.kd = {row[3], row[4], row[5]};
  v.m = row[6];
  v.wo = {row[7], row[8], row[9]};
  v.alpha = row[10];
  v.pd = row[11];
  return v;
}

// One sample's inputs: the pool entry and the three draws.
MC_FN void sample_inputs(const Args& a, long long p, int s, float pool[7], float u[3], long long& entry) {
  entry = ((long long)p + a.c[s]) % a.n_pool;
  const float* e = a.pool + ((long long)s * a.n_pool + entry) * 7;
  for (int q = 0; q < 7; ++q) pool[q] = e[q];
  const float* d = a.u + ((long long)s * a.P + p) * 3;
  u[0] = d[0];
  u[1] = d[1];
  u[2] = d[2];
}

}  // namespace mc
#endif  // MC_ARITH_ONLY
