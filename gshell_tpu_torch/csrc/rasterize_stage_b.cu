// Raster stage B: per-tile triangle coverage and depth test.
//
// Replaces the TPU kernel gshell_tpu/ops/rasterize.py::_stage_b_pallas
// (pallas_call at :430), which rasterize_tiled calls after its stage-A
// binning.  Input is the (triangle, tile) pair list sorted by tile, one row
// of 16 floats per pair:
//   [a0 a1 a2 | b0 b1 b2 | c0 c1 c2 | z0 z1 z2 | area2 | tri_id+1 | 0 0]
// plus each tile's segment [tile_start, tile_start + tile_cnt).  Every pair
// of a segment is tested: there is no per-tile triangle cap.  Per pixel the
// covering pair of least depth wins, and among equal depths the least id.
//
// What bounds it on Hopper: the bytes (the pair list read once, 64 B a
// pair, and z and id written once): the triangles are small, so the pixels
// inside a pair's box, ~25 instructions each, are few.  What takes the
// time is fixed cost per launch and per sub-segment, and each warp testing
// all 32 pixels of its band for every pair that reaches it.  What held the
// one-block-per-tile design back was balance:
// all tiles fit in one wave, so the kernel lasted as long as its most
// crowded (silhouette) tile, walked by one block.
//
// Design (three launches on the caller's stream):
//  * stage_b_schedule, one block per tile, cuts each tile's segment into
//    sub-segments of at most kSub pairs and writes their table on the
//    device (each block sums the sub-segment counts of the tiles before it:
//    no host sync).  The table has room for n_tiles + max_pairs / kSub rows,
//    a bound on sum(ceil(cnt / kSub)).  It also writes the miss result of
//    empty tiles and readies the merge keys of tiles with several
//    sub-segments.
//  * stage_b_kernel: persistent blocks (as many as fit on the card), one
//    thread per pixel of the tile.  A block takes sub-segments from a
//    counter until none is left, so the crowded tiles' pieces spread over
//    the card and no block waits on a whole segment.  A sub-segment's pairs
//    (at most 32, 2 KB) arrive by 1-D bulk copy (TMA), completion on an
//    mbarrier, double-buffered: the next one's pairs load while the current
//    one is tested.
//  * Per-pair constants once.  While folding a chunk, the block computes
//    per pair 1/area2 (the same __fdiv_rn), folds the orientation sign into
//    the edge coefficients and depths (a sign flip is exact, so every
//    product and sum rounds as before), packs the top-left edge flags, and
//    marks the warps (bands of 2 tile rows) the triangle may cover.  Each
//    warp then walks only its live pairs, in order, with 4 float4
//    broadcasts per pair.
//  * Exact merge.  A tile with one sub-segment writes its result directly.
//    Otherwise each block folds its per-pixel winner into a 64-bit key,
//    (order-preserving bits of z) << 32 | id, with atomicMin: least z, then
//    least id.  -0.0 is canonicalized to +0.0 first, since the rule treats
//    them as equal.  stage_b_unpack then turns the keys of those tiles into
//    best_z / best_id (no key: id -1).
//
// Numerics: products and sums are explicitly rounded (__fmul_rn /
// __fadd_rn; the library is also built with --fmad=false), in the order
// PyTorch's eager ops use: e = (a*px + b*py) + c, depth =
// ((e0*z0 + e1*z1) + e2*z2) * (1/area2).  The plain PyTorch version then
// gives identical ids, including the top-left tie test e == 0.
#include <cassert>

#include <cuda_runtime.h>

namespace {

// rasterize.py mirrors these as TILE and STAGE_B_SUB (its CPU model of the
// schedule and the size of the sub-segment table) and checks them against
// gs_stage_b_layout before its first launch.
constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kSub = 32;  // most pairs per sub-segment: one bulk copy (2 KB),
                          // 8 threads (bands) per pair while folding
constexpr int kPairBytes = 64;
constexpr float kBig = 3.4e38f;
constexpr long long kMissKey = 0x7fffffffffffffffLL;

__device__ __forceinline__ long long pack_key(float z, int id) {
  const int bits = __float_as_int(__fadd_rn(z, 0.f));  // -0 + 0 = +0
  const int s = bits ^ ((bits >> 31) & 0x7fffffff);     // signed-int order of z
  return (long long)(((unsigned long long)(unsigned)s << 32) | (unsigned)id);
}

__device__ __forceinline__ void unpack_key(long long key, float* z, int* id) {
  if (key == kMissKey) {
    *z = kBig;
    *id = -1;
    return;
  }
  const int s = (int)(key >> 32);
  *z = __int_as_float(s ^ ((s >> 31) & 0x7fffffff));
  *id = (int)(unsigned)(key & 0xffffffffLL);
}

__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int i = 0; i < kPixels / 32; ++i) s += red[i];
  return s;
}

// One block per tile.  subs[b] = (tile, first pair, pairs, sub-segments of
// the tile) for b < work[0], tiles in order, sub-segments of at most kSub
// pairs.  Each block sums the sub-segment counts of the tiles before it.
__global__ void __launch_bounds__(kPixels)
    stage_b_schedule(const int* __restrict__ tile_start, const int* __restrict__ tile_cnt,
                     int4* __restrict__ subs, int* __restrict__ work,
                     long long* __restrict__ keys, float* __restrict__ best_z,
                     int* __restrict__ best_id, int n_tiles, int max_subs, int grid) {
  __shared__ int red[kPixels / 32];
  const int t = blockIdx.x;
  const int lin = threadIdx.x;
  int before = 0, all = 0;
  for (int u = lin; u < n_tiles; u += kPixels) {
    const int ns = (tile_cnt[u] + kSub - 1) / kSub;
    all += ns;
    if (u < t) before += ns;
  }
  before = block_sum(before, red);
  all = block_sum(all, red);
  if (t == 0 && lin == 0) {
    // max_subs bounds sum(ceil(cnt / kSub)) while the segments lie in the
    // pair buffer; more means tile_cnt and the buffer disagree: fail the
    // launch (the caller's next synchronization raises) rather than drop
    // pairs.  The writes below stay inside the table all the same.
    assert(all <= max_subs);
    work[0] = min(all, max_subs);  // sub-segments
    work[1] = grid;                // the next one no block has taken yet
  }
  const int cnt = tile_cnt[t];
  const int ns = (cnt + kSub - 1) / kSub;
  const int start = tile_start[t];
  for (int k = lin; k < ns && before + k < max_subs; k += kPixels)
    subs[before + k] = make_int4(t, start + k * kSub, min(kSub, cnt - k * kSub), ns);
  const size_t o = (size_t)t * kPixels + lin;
  if (ns == 0) {
    best_z[o] = kBig;
    best_id[o] = -1;
  } else if (ns > 1) {
    keys[o] = kMissKey;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Per-pair constants, computed by the 8 threads of pair p = lin / 8 (one per
// warp band of 2 tile rows, band = lin % 8) and written in place by the
// first of them.  1/area2 is the same __fdiv_rn as before; the orientation
// sign is folded into the edge coefficients and depths (a sign flip is
// exact, so every product and sum rounds as before); the flags hold the
// validity and top-left bits; the band mask says which warps the pair may
// cover.  A band is culled when some edge value, at the band corner where
// it is largest, is below -1e-6 * (|a| x + |b| y + |c|): more than five
// times the rounding error of any pixel's edge value there (3 roundings),
// so every pixel of the band computes that edge value < 0 and is not
// covered.  The pixel test itself is unchanged.
__device__ __forceinline__ void fold_pair_constants(float4* s, int m, int tile_x, int tile_y) {
  const int lin = threadIdx.x;
  const int p = lin >> 3;
  const int band = lin & 7;
  float4 r0, r1, r2, r3;
  bool live = false;
  if (p < m) {
    r0 = s[4 * p], r1 = s[4 * p + 1], r2 = s[4 * p + 2], r3 = s[4 * p + 3];
    const float so = r3.x > 0.f ? 1.f : -1.f;
    const float xlo = (float)(tile_x * kTile) + 0.5f, xhi = xlo + (float)(kTile - 1);
    const float ylo = (float)(tile_y * kTile + 2 * band) + 0.5f, yhi = ylo + 1.f;
    const float a[3] = {r0.x * so, r0.y * so, r0.z * so};
    const float b[3] = {r0.w * so, r1.x * so, r1.y * so};
    const float c[3] = {r1.z * so, r1.w * so, r2.x * so};
    bool culled = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float x = a[k] > 0.f ? xhi : xlo;
      const float y = b[k] > 0.f ? yhi : ylo;
      const float emax = __fadd_rn(__fadd_rn(__fmul_rn(a[k], x), __fmul_rn(b[k], y)), c[k]);
      const float scale = __fadd_rn(__fadd_rn(__fmul_rn(fabsf(a[k]), xhi), __fmul_rn(fabsf(b[k]), yhi)),
                                    fabsf(c[k]));
      culled = culled || emax < -1e-6f * scale;
    }
    live = fabsf(r3.x) > 1e-12f && !culled;
  }
  const unsigned bands = __ballot_sync(0xffffffffu, live);
  if (p >= m || band != 0) return;
  const float ar = r3.x;
  const bool valid = fabsf(ar) > 1e-12f;
  const float so = ar > 0.f ? 1.f : -1.f;
  const float a0 = r0.x * so, a1 = r0.y * so, a2 = r0.z * so;
  const float b0 = r0.w * so, b1 = r1.x * so, b2 = r1.y * so;
  const bool ok0 = (a0 > 0.f) || (a0 == 0.f && b0 > 0.f);
  const bool ok1 = (a1 > 0.f) || (a1 == 0.f && b1 > 0.f);
  const bool ok2 = (a2 > 0.f) || (a2 == 0.f && b2 > 0.f);
  const int flags = (valid ? 1 : 0) | (ok0 ? 2 : 0) | (ok1 ? 4 : 0) | (ok2 ? 8 : 0);
  const int mask = (int)((bands >> (lin & 24)) & 0xffu);
  s[4 * p] = make_float4(a0, a1, a2, b0);
  s[4 * p + 1] = make_float4(b1, b2, r1.z * so, r1.w * so);
  s[4 * p + 2] = make_float4(r2.x * so, r2.y * so, r2.z * so, r2.w * so);
  s[4 * p + 3] = make_float4(valid ? __fdiv_rn(1.f, ar) : 0.f, __int_as_float((int)r3.y - 1),
                             __int_as_float(flags), __int_as_float(mask));
}

// Persistent blocks, one thread per pixel of the tile: block b starts with
// sub-segment b and then takes the next untaken one from the counter
// work[1], so blocks that drew light sub-segments take more; while it tests
// one, the next one's pairs arrive by bulk copy in the other buffer.
__global__ void __launch_bounds__(kPixels)
    stage_b_kernel(const float* __restrict__ pairs, const int4* __restrict__ subs,
                   int* __restrict__ work, long long* __restrict__ keys,
                   float* __restrict__ best_z_out, int* __restrict__ best_id_out, int tx_n) {
  __shared__ alignas(128) float4 buf[2][kSub * 4];
  __shared__ alignas(8) unsigned long long bar[2];
  __shared__ int4 sub_s[2];
  __shared__ int next_s[2];
  const int total = work[0];
  const int lin = threadIdx.x;
  const int lane = lin & 31;
  const int warp = lin >> 5;
  int b = blockIdx.x;
  if (b >= total) return;
  if (lin == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int4 first = subs[b];
    sub_s[0] = first;
    bulk_load(buf[0], pairs + (size_t)first.y * 16, first.z * kPairBytes, &bar[0]);
  }
  __syncthreads();  // barriers initialized before anyone waits on them

#pragma unroll 1
  for (int i = 0; b < total; ++i) {
    const int cur = i & 1;
    const int4 sub = sub_s[cur];
    if (lin == 0) {  // take the next sub-segment and prefetch its pairs
      const int nb = atomicAdd(&work[1], 1);
      next_s[cur] = nb;
      if (nb < total) {
        const int4 next = subs[nb];
        sub_s[cur ^ 1] = next;
        // the generic-proxy writes to buf[cur ^ 1] (two iterations back) are
        // ordered before the bulk copy overwrites them
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_load(buf[cur ^ 1], pairs + (size_t)next.y * 16, next.z * kPairBytes, &bar[cur ^ 1]);
      }
    }
    bar_wait(&bar[cur], (i >> 1) & 1);
    float4* s = buf[cur];
    const int m = sub.z;
    const int t = sub.x;
    const int ty = t / tx_n;
    const int tx = t % tx_n;
    fold_pair_constants(s, m, tx, ty);
    __syncthreads();

    // the pairs this warp's band may cover, in order
    const unsigned live =
        __ballot_sync(0xffffffffu, lane < m && ((__float_as_int(s[4 * lane + 3].w) >> warp) & 1));
    const float py = (float)(ty * kTile + lin / kTile) + 0.5f;
    const float px = (float)(tx * kTile + lin % kTile) + 0.5f;
    float best_z = kBig;
    int best_id = -1;
    for (unsigned rest = live; rest; rest &= rest - 1) {
      const int j = __ffs(rest) - 1;
      const float4 f0 = s[4 * j], f1 = s[4 * j + 1], f2 = s[4 * j + 2], f3 = s[4 * j + 3];
      const int flags = __float_as_int(f3.z);
      // sign-folded edge values: e_k = (a_k px + b_k py) + c_k
      const float e0 = __fadd_rn(__fadd_rn(__fmul_rn(f0.x, px), __fmul_rn(f0.w, py)), f1.z);
      if (!((e0 > 0.f) || (e0 == 0.f && (flags & 2)))) continue;
      const float e1 = __fadd_rn(__fadd_rn(__fmul_rn(f0.y, px), __fmul_rn(f1.x, py)), f1.w);
      const float e2 = __fadd_rn(__fadd_rn(__fmul_rn(f0.z, px), __fmul_rn(f1.y, py)), f2.x);
      if (!(((e1 > 0.f) || (e1 == 0.f && (flags & 4))) &&
            ((e2 > 0.f) || (e2 == 0.f && (flags & 8)))))
        continue;
      float num = __fadd_rn(__fmul_rn(e0, f2.y), __fmul_rn(e1, f2.z));
      num = __fadd_rn(num, __fmul_rn(e2, f2.w));
      const float depth = __fmul_rn(num, f3.x);
      if (!(depth >= -1.f && depth <= 1.f)) continue;
      const int id = __float_as_int(f3.y);
      if (depth < best_z || (depth == best_z && id < best_id)) {
        best_z = depth;
        best_id = id;
      }
    }

    const size_t o = (size_t)t * kPixels + lin;
    if (sub.w == 1) {
      best_z_out[o] = best_z;
      best_id_out[o] = best_id;
    } else if (best_id >= 0) {
      atomicMin(&keys[o], pack_key(best_z, best_id));  // stage_b_unpack reads it
    }
    __syncthreads();  // buf[cur] and sub_s[cur] are free again; next_s[cur] is set
    b = next_s[cur];
  }
}

// One block per tile: tiles with several sub-segments take their merged key.
__global__ void __launch_bounds__(kPixels)
    stage_b_unpack(const int* __restrict__ tile_cnt, const long long* __restrict__ keys,
                   float* __restrict__ best_z, int* __restrict__ best_id) {
  const int t = blockIdx.x;
  if (tile_cnt[t] <= kSub) return;
  const size_t o = (size_t)t * kPixels + threadIdx.x;
  float z;
  int id;
  unpack_key(keys[o], &z, &id);
  best_z[o] = z;
  best_id[o] = id;
}

}  // namespace

// The tile side and the most pairs per sub-segment.
extern "C" void gs_stage_b_layout(int* tile, int* sub) {
  *tile = kTile;
  *sub = kSub;
}

// pairs (max_pairs, 16) f32, 16-byte aligned; tile_start / tile_cnt
// (n_tiles,) i32; scratch: subs (max_subs, 4) i32 with max_subs = n_tiles +
// max_pairs / kSub (a bound on sum(ceil(cnt / kSub))), work (2,) i32, keys
// (n_tiles, 256) i64.
// best_z (n_tiles, 256) f32; best_id (n_tiles, 256) i32, -1 = miss.
extern "C" int gs_stage_b(const void* pairs, const void* tile_start, const void* tile_cnt,
                          void* subs, void* work, void* keys, void* best_z, void* best_id,
                          int n_tiles, int tx_n, int max_subs, void* stream) {
  static_assert(kSub * 8 == kPixels, "one folding thread per (pair, band)");
  if (n_tiles <= 0) return (int)cudaGetLastError();
  // persistent grid: as many blocks as fit on the card at once (per device)
  static int grid_of[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (grid_of[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stage_b_kernel, kPixels, 0);
    if (err != cudaSuccess) return (int)err;
    grid_of[dev] = sms * per_sm;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = max(1, min(grid_of[dev], max_subs));
  stage_b_schedule<<<n_tiles, kPixels, 0, s>>>(
      (const int*)tile_start, (const int*)tile_cnt, (int4*)subs, (int*)work, (long long*)keys,
      (float*)best_z, (int*)best_id, n_tiles, max_subs, grid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stage_b_kernel<<<grid, kPixels, 0, s>>>((const float*)pairs, (const int4*)subs, (int*)work,
                                          (long long*)keys, (float*)best_z, (int*)best_id, tx_n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stage_b_unpack<<<n_tiles, kPixels, 0, s>>>((const int*)tile_cnt, (const long long*)keys,
                                             (float*)best_z, (int*)best_id);
  return (int)cudaGetLastError();
}
