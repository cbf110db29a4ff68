// Instance norm for Hopper (sm_90a), NHWC in and out.
//
// Replaces gan_class_transfer2_tpu/ops/norm.py::_in_kernel (the Pallas TPU
// kernel of the GAN generators' and discriminators' instance norm). For x of
// shape (B, H, W, C) it computes, per (sample, channel), the mean m and the
// variance v over the H·W pixels in float32, r = 1/√(v + 1e-5), and
//   y = ((x − m)·r)·γ + β,
// stored in x's dtype (float32 or bfloat16). γ and β arrive as float32 (the
// parameters' dtype) and are rounded to x's dtype here, as the Pallas wrapper
// rounds them before its call (norm.py:76). The affine is evaluated in the
// order of the two-pass reference (norm.py:41-45), the same function as the
// TPU kernel's x·(γr) + (β − m·γ·r) with fewer roundings on large |m|.
//
// The variance is Welford's, combined by Chan et al.'s pairwise rule, not
// the TPU kernel's one-pass E[x²] − m² (norm.py:51-54): the same quantity
// without the cancellation, so the kernel agrees with the two-pass plain
// version at every shape and mean; it is clamped at 0 as the TPU kernel
// clamps it. Every float operation is an _rn intrinsic (no fast math).
//
// Bound on this card: bytes. x is read and y written, once each, so
// 2·B·H·W·C·sizeof(dtype) bytes; the arithmetic is a few operations per
// element. At the GAN step's batch 16 the big maps (256²×64, 128²×128) hold
// 32–64 (sample, 32-channel) groups, too few for 132 SMs if one block takes a
// group, each 2–8 MB in float32: too much for one SM to stream alone.
//
// Design:
//   * one launch per norm; H·W is split across a thread-block cluster of S
//     blocks (S ≤ 8, portable). The grid is (⌈C/32⌉·S, B), cluster (S, 1, 1):
//     cluster g along x covers the 32 channels of group g of one sample, and
//     its block of rank r the pixels [r·chunk, (r+1)·chunk) ∩ [0, H·W). The
//     wrapper picks the smallest S that puts 7/8 of a wave (116 blocks) on
//     the card: at batch 16, S = 4 for 256²×64 and 2 for 128²×128 (128
//     blocks each; the larger clusters that reach 256 blocks measured slower:
//     each cluster.sync waits for the slowest of S blocks). A block whose
//     chunk is empty (H·W < S) contributes an empty triple;
//   * 256 threads: 16-byte loads along C (4 float32 or 8 bfloat16 channels a
//     thread, TX threads over the 32 channels, TY = 256/TX pixel lanes); a C
//     that is not a multiple of the vector takes a masked scalar tail;
//   * each thread folds each group of up to 8 of its pixels into (count,
//     mean, M2) triples, one per channel; the TY triples of a channel are
//     combined by a tree of Chan combines in shared memory; then, after
//     cluster.sync(), each block combines the S block triples of its channels
//     from the cluster's distributed shared memory in rank order 0, 1, ...,
//     S−1 (the same fixed order in every block, so all S blocks get the same
//     m and r, and two calls give bit-identical y);
//   * pass 2 reads x again, walking the chunk backwards so that the pixels
//     read last in pass 1, the likeliest still in the 50 MB L2, come first.
//     Keeping the chunk in shared memory instead (x read from device memory
//     once) measured slower at every map where it fits (PERF.md, Findings): its
//     64 KB cut the blocks an SM holds, and the kernel is bound by the
//     latency of its loads, not by their bytes.
//
// Height blocks (the spatial path, parallel/spatial_unet.py). A rank that
// holds rows s·h … (s+1)·h − 1 of every image needs statistics over the whole
// image, so a norm takes two launches of kernels of their own around a
// gather (the single launch above is untouched). A group is a sample's 32
// channels, as above.
//   * stats: each group's (count, mean, M2) per channel over the block,
//     float32, written to the rank's slot of an (s, B, C, 3) buffer. Each
//     thread sums d = x − K and d² over its pixels, K the value of the
//     block's first pixel in the same channel (the shift: x − K is exact in
//     bfloat16 and close to the data's spread, so a large mean does not
//     cancel): one subtract, one add and one FFMA an element, no division,
//     with its next 8 pixels' loads in flight during this 8's arithmetic.
//     Its lanes' sums are added by warp shuffles in a fixed order, then its
//     warps' in warp order in shared memory, and the block's sums become
//     (n, K + S₁/n, S₂ − S₁²/n) once. Where a group's pixels need more than
//     one SM (block_plan's cluster S > 1, the large maps), S blocks of a
//     cluster split them and rank 0 combines the S block triples by Chan's
//     rule in rank order through distributed shared memory;
//   * merge and apply: the block's y = ((x − m)·r)·γ + β, with (m, r)
//     merged in the launch from the gathered (s, B, C, 3) triples by Chan's
//     rule in rank order 0 … s−1 (the formulas and the order of
//     ops/norm.merge_block_stats, _rn intrinsics only, so every rank merging
//     the same buffer holds bit-identical statistics), r = 1/√(v + 1e-5);
//     the first block of each group writes (m, r) to a float32 (B, C, 2)
//     array for the backward. No cluster: S blocks split the pixels, each
//     merging its group's triples itself (a few loads);
//   * the small maps (ops/norm.block_plan): a group takes wpg warps (1, 2, 4
//     or 8) and a block of up to 8 warps holds several groups, so a map of 8
//     pixels keeps its lanes busy and launches with no cluster attribute, no
//     cluster.sync() and, where a group is one warp, no __syncthreads.
// Between them ops/norm.py all-gathers the triples over the spatial axis.
//
// Backward (gct2_instance_norm_bwd_*). It replaces no Pallas kernel: the JAX
// package's backward of the instance norm is plain jnp
// (gan_class_transfer2_tpu/ops/norm.py:109-119), and its function here is
// ops/norm._in_bwd's, at the same precision. From x (B, H, W, C), dy (x's
// dtype) and γ (float32) it recomputes, per (sample, channel) over the H·W
// pixels, the statistics in float32 and writes
//   dx = r·(g − mean(g) − x̂·mean(g·x̂)),  g = dy·γ,  x̂ = (x − m)·r,
// in float32 rounded once to x's dtype, and, where asked, dγ = Σ dy·x̂ and
// dβ = Σ dy over (b, h, w), float32.
//   * Bound on this card: bytes. The least it moves is x and dy read once
//     and dx written once (3·N elements); a (sample, group) of the large maps
//     (256²×64, 128²×128 at batch 16) holds 2–8 MB, far past what an SM
//     keeps, so there x and dy are read twice: 5·N.
//   * One pass gives every sum: about K, the sample's first pixel in each
//     channel (the same K in every block of a cluster, so their sums add),
//     each thread sums d = x − K, d², dy and dy·d over its pixels (the
//     height-block stats launch's walk and prefetch, block_plan's cut).
//     Lanes are added by shuffles, warps in warp order, and with a cluster
//     (S > 1) every block adds the S blocks' sums in rank order through
//     distributed shared memory, so all hold the same bits. Then, with
//     t = Σd/n: m = K + t, var = max(Σd² − Σd·t, 0)/n, r = 1/√(var + 1e-5),
//     Σdy·x̂ = r·(Σdy·d − t·Σdy).
//   * The same launch then re-reads its chunk of x and dy, last pixels first
//     (the likeliest still in L2), and writes dx.
//   * dγ and dβ: the cluster's rank 0 writes each (sample, channel)'s
//     (Σdy·x̂, Σdy) to a float32 (B, C, 2) buffer, and a second, small
//     launch adds them in sample order. No floating-point atomics: two calls
//     give the same bits. Without a buffer (γ and β need no gradient) the
//     backward is one launch.
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for a shape or plan it
// refuses).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CHB = 32;        // channels per cluster
constexpr int THREADS = 256;
constexpr int UNROLL = 8;      // pixels in flight per thread (a power of 2)
constexpr int MAX_CLUSTER = 8;
constexpr float EPS = 1e-5f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// a float32 value rounded to T and widened again (γ and β)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Stats {
  float n, mean, m2;  // count, mean, sum of squared deviations
};

// Chan, Golub and LeVeque's pairwise update of two (count, mean, M2) triples.
__device__ __forceinline__ Stats combine(Stats a, Stats b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = __fadd_rn(a.n, b.n);
  const float d = __fsub_rn(b.mean, a.mean);
  const float f = __fdiv_rn(b.n, n);
  Stats o;
  o.n = n;
  o.mean = __fadd_rn(a.mean, __fmul_rn(d, f));
  o.m2 = __fadd_rn(__fadd_rn(a.m2, b.m2), __fmul_rn(__fmul_rn(__fmul_rn(d, d), a.n), f));
  return o;
}

// 16 bytes of x at element offset i, channels c .. c+VEC−1: one vector load
// where the row holds them all and is 16-byte aligned, else masked scalars
// (zero past C)
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* x, size_t i, int c, int C, bool vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec_ok && c + VEC <= C) return *reinterpret_cast<const uint4*>(x + i);
  uint4 u = make_uint4(0, 0, 0, 0);
  T* t = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int v = 0; v < VEC; ++v)
    if (c + v < C) t[v] = x[i + v];
  return u;
}

// y from x: the single launch
template <typename T>
__global__ void __launch_bounds__(THREADS)
instance_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y, int HW, int C,
                     int chunk) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int TX = CHB / VEC;     // threads along the channels
  constexpr int TY = THREADS / TX;  // pixel lanes
  __shared__ float s_n[TY][CHB + 1], s_mean[TY][CHB + 1], s_m2[TY][CHB + 1];
  __shared__ float s_m[CHB], s_r[CHB];

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int group = blockIdx.x / S;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int c = group * CHB + tx * VEC;
  const bool vec_ok = C % VEC == 0;
  const int p_begin = min(rank * chunk, HW), p_end = min(p_begin + chunk, HW);
  const size_t row0 = static_cast<size_t>(blockIdx.y) * HW;  // this sample's first pixel

  // pass 1: each thread's triples over pixels p_begin + ty + k·TY
  Stats st[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) st[v] = {0.f, 0.f, 0.f};
  if (c < C) {
    for (int p0 = p_begin + ty; p0 < p_end; p0 += TY * UNROLL) {
      uint4 raw[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int p = p0 + k * TY;
        raw[k] = p < p_end ? load_vec(x, (row0 + p) * C + c, c, C, vec_ok)
                           : make_uint4(0, 0, 0, 0);
      }
      const int cnt = min(UNROLL, (p_end - p0 + TY - 1) / TY);  // ≥ 1
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float val[UNROLL];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) val[k] = to_float(reinterpret_cast<const T*>(&raw[k])[v]);
        // the group's own triple (two passes over registers); padded lanes hold 0
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) sum = __fadd_rn(sum, val[k]);
        Stats g;
        g.n = static_cast<float>(cnt);
        // a full group's mean by the exact power-of-2 scale, the same value
        g.mean = cnt == UNROLL ? __fmul_rn(sum, 1.f / UNROLL) : __fdiv_rn(sum, g.n);
        g.m2 = 0.f;
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const float d = __fsub_rn(val[k], g.mean);
          if (k < cnt) g.m2 = __fadd_rn(g.m2, __fmul_rn(d, d));
        }
        st[v] = combine(st[v], g);
      }
    }
  }

  // the TY triples of each channel, combined by a tree in shared memory
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    s_n[ty][tx * VEC + v] = st[v].n;
    s_mean[ty][tx * VEC + v] = st[v].mean;
    s_m2[ty][tx * VEC + v] = st[v].m2;
  }
  __syncthreads();
  for (int half = TY / 2; half > 0; half >>= 1) {
    if (ty < half) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int ch = tx * VEC + v;
        const Stats a = {s_n[ty][ch], s_mean[ty][ch], s_m2[ty][ch]};
        const Stats b = {s_n[ty + half][ch], s_mean[ty + half][ch], s_m2[ty + half][ch]};
        const Stats o = combine(a, b);
        s_n[ty][ch] = o.n;
        s_mean[ty][ch] = o.mean;
        s_m2[ty][ch] = o.m2;
      }
    }
    __syncthreads();
  }

  // the cluster's S block triples, read from each block's shared memory in
  // rank order; the second sync keeps every block alive until all have read
  cluster.sync();
  if (threadIdx.x < CHB) {
    const int ch = threadIdx.x;
    Stats t = {0.f, 0.f, 0.f};
    for (int r = 0; r < S; ++r) {
      const float* rn = cluster.map_shared_rank(&s_n[0][0], r);
      const float* rmean = cluster.map_shared_rank(&s_mean[0][0], r);
      const float* rm2 = cluster.map_shared_rank(&s_m2[0][0], r);
      t = combine(t, Stats{rn[ch], rmean[ch], rm2[ch]});
    }
    const float var = t.n > 0.f ? fmaxf(__fdiv_rn(t.m2, t.n), 0.f) : 0.f;
    s_m[ch] = t.mean;
    s_r[ch] = __frcp_rn(__fsqrt_rn(__fadd_rn(var, EPS)));
  }
  cluster.sync();
  if (c >= C || p_begin >= p_end) return;

  // pass 2: y = ((x − m)·r)·γ + β over the same pixels, last group first
  float m[VEC], r[VEC], g[VEC], b[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int cv = min(c + v, C - 1);  // lanes past C are computed, never stored
    m[v] = s_m[tx * VEC + v];
    r[v] = s_r[tx * VEC + v];
    g[v] = round_to(gamma[cv], x);
    b[v] = round_to(beta[cv], x);
  }
  const int len = p_end - p_begin;
  const int iters = ty < len ? (len - ty + TY * UNROLL - 1) / (TY * UNROLL) : 0;
  for (int it = iters - 1; it >= 0; --it) {
    const int p0 = p_begin + ty + it * TY * UNROLL;
    uint4 raw[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int p = p0 + k * TY;
      if (p < p_end) raw[k] = load_vec(x, (row0 + p) * C + c, c, C, vec_ok);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int p = p0 + k * TY;
      if (p >= p_end) continue;
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float xv = to_float(reinterpret_cast<const T*>(&raw[k])[v]);
        from_float(&o[v], __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xv, m[v]), r[v]), g[v]), b[v]));
      }
      T* dst = y + (row0 + p) * C + c;
      if (vec_ok && c + VEC <= C) {
        *reinterpret_cast<uint4*>(dst) = out;
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          if (c + v < C) dst[v] = o[v];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y, int B, int HW, int C,
           int cluster, void* stream) {
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || cluster < 1 || cluster > MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = (HW + cluster - 1) / cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((C + CHB - 1) / CHB) * cluster, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, instance_norm_kernel<T>, static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y), HW, C, chunk);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ height blocks

constexpr int WARPS = THREADS / 32;  // the most warps a height-block thread block holds

// Where a thread of a height-block launch works. Group q = b·NG + g holds
// sample b's 32 channels g·32 … g·32 + 31. A block of wpb warps
// (blockDim.x / 32) holds G = wpb / wpg groups, each taking wpg consecutive
// warps; with S > 1 the S consecutive blocks x·S … x·S + S − 1 split its
// pixels into chunks [rank·chunk, (rank + 1)·chunk) ∩ [0, HW). In a warp,
// lane = ly·TX + tx: tx picks VEC = 16/sizeof(T) channels, ly one of LY =
// VEC pixels; the group's pixel lane pl = wl·LY + ly takes pixels p_begin +
// pl + k·L, L = wpg·LY.
template <typename T>
struct Place {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int TX = CHB / VEC;  // lanes along the channels
  static constexpr int LY = 32 / TX;    // pixel lanes of a warp
  int lane, warp, gi, wl, q, b, g, c, rank, p_begin, p_end, pl, L;
  bool live;
  __device__ Place(int NQ, int HW, int C, int wpg, int S, int chunk) {
    lane = threadIdx.x % 32;
    warp = threadIdx.x / 32;
    gi = warp / wpg;
    wl = warp % wpg;
    const int G = static_cast<int>(blockDim.x / 32) / wpg;
    rank = static_cast<int>(blockIdx.x) % S;
    q = static_cast<int>(blockIdx.x) / S * G + gi;
    live = q < NQ;
    const int NG = (C + CHB - 1) / CHB;
    b = live ? q / NG : 0;
    g = q % NG;
    c = g * CHB + (lane % TX) * VEC;
    p_begin = min(rank * chunk, HW);
    p_end = min(p_begin + chunk, HW);
    pl = wl * LY + lane / TX;
    L = wpg * LY;
  }
};

// UNROLL pixels p0 + u·L of a lane from src (pixel p0, channel c), u·step
// apart; a pixel at or past p_end takes K's bits (d = 0)
template <typename T>
__device__ __forceinline__ void load_group(const T* src, size_t step, int p0, int L, int p_end,
                                           int c, int C, bool vec_ok, uint4 kraw,
                                           uint4 (&raw)[UNROLL]) {
  if (p0 + (UNROLL - 1) * L < p_end) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) raw[u] = load_vec(src + u * step, 0, c, C, vec_ok);
  } else {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      raw[u] = p0 + u * L < p_end ? load_vec(src + u * step, 0, c, C, vec_ok) : kraw;
  }
}

// (n, mean, M2) of n pixels from their sums Σd, Σd² about K
__device__ __forceinline__ Stats from_sums(float n, float s1, float s2, float k) {
  if (n == 0.f) return {0.f, 0.f, 0.f};
  const float t = __fdiv_rn(s1, n);
  return {n, __fadd_rn(k, t), fmaxf(__fsub_rn(s2, __fmul_rn(s1, t)), 0.f)};
}

__device__ __forceinline__ void store_stats(float* o, Stats t) {
  o[0] = t.n;
  o[1] = t.mean;
  o[2] = t.m2;
}

// The block's (count, mean, M2) per (sample, channel) into stats (B, C, 3).
template <typename T, bool CLUSTER>
__global__ void __launch_bounds__(THREADS)
block_stats_kernel(const T* __restrict__ x, float* __restrict__ stats, int NQ, int HW, int C,
                   int wpg, int S, int chunk) {
  using P = Place<T>;
  constexpr int VEC = P::VEC, TX = P::TX;
  __shared__ float sh[WARPS][CHB][3];  // each warp's (Σd, Σd², K) of each channel
  __shared__ float s_blk[3][CHB];      // the block's triples, read by the cluster's rank 0
  const P at(NQ, HW, C, wpg, CLUSTER ? S : 1, chunk);
  const bool vec_ok = C % VEC == 0;
  const size_t row0 = static_cast<size_t>(at.b) * HW;

  float s1[VEC], s2[VEC], k[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) s1[v] = s2[v] = k[v] = 0.f;
  if (at.live && at.c < C && at.p_begin < at.p_end) {
    // K: the block's first pixel; a masked load stands in K's bits (d = 0)
    const uint4 kraw = load_vec(x, (row0 + at.p_begin) * C + at.c, at.c, C, vec_ok);
#pragma unroll
    for (int v = 0; v < VEC; ++v) k[v] = to_float(reinterpret_cast<const T*>(&kraw)[v]);
    // UNROLL pixels a lane in flight, the next UNROLL loaded before this
    // group's arithmetic (8 warps an SM at the large maps cannot hide a
    // load's latency behind each other's arithmetic)
    const size_t step = static_cast<size_t>(at.L) * C;
    const int span = at.L * UNROLL;
    uint4 raw[UNROLL], next[UNROLL];
    load_group(x + (row0 + at.p_begin + at.pl) * C + at.c, step, at.p_begin + at.pl, at.L,
               at.p_end, at.c, C, vec_ok, kraw, raw);
    for (int p0 = at.p_begin + at.pl; p0 < at.p_end; p0 += span) {
      if (p0 + span < at.p_end)
        load_group(x + (row0 + p0 + span) * C + at.c, step, p0 + span, at.L, at.p_end, at.c, C,
                   vec_ok, kraw, next);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float d = __fsub_rn(to_float(reinterpret_cast<const T*>(&raw[u])[v]), k[v]);
          s1[v] = __fadd_rn(s1[v], d);
          s2[v] = __fmaf_rn(d, d, s2[v]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) raw[u] = next[u];
    }
  }
  // the warp's pixel lanes, added by shuffles: lane ly takes ly + off
#pragma unroll
  for (int off = 16; off >= TX; off >>= 1) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      s1[v] = __fadd_rn(s1[v], __shfl_down_sync(0xffffffffu, s1[v], off));
      s2[v] = __fadd_rn(s2[v], __shfl_down_sync(0xffffffffu, s2[v], off));
    }
  }
  if (at.lane < TX) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      sh[at.warp][at.lane * VEC + v][0] = s1[v];
      sh[at.warp][at.lane * VEC + v][1] = s2[v];
      sh[at.warp][at.lane * VEC + v][2] = k[v];
    }
  }
  if (wpg > 1) {
    __syncthreads();
  } else {
    __syncwarp();
  }
  // the group's warps in warp order, a lane a channel; then its triple
  const int w0 = at.gi * wpg, cl = at.lane, ch = at.g * CHB + cl;
  Stats t = {0.f, 0.f, 0.f};
  if (at.wl == 0) {
    float a1 = sh[w0][cl][0], a2 = sh[w0][cl][1];
    for (int w = 1; w < wpg; ++w) {
      a1 = __fadd_rn(a1, sh[w0 + w][cl][0]);
      a2 = __fadd_rn(a2, sh[w0 + w][cl][1]);
    }
    t = from_sums(static_cast<float>(at.p_end - at.p_begin), a1, a2, sh[w0][cl][2]);
  }
  if constexpr (CLUSTER) {
    // one group a block, its triples in warp 0: rank 0 combines the S
    // blocks' in rank order; the second sync keeps every block alive until
    // it has read
    cg::cluster_group cluster = cg::this_cluster();
    if (at.warp == 0) {
      s_blk[0][cl] = t.n;
      s_blk[1][cl] = t.mean;
      s_blk[2][cl] = t.m2;
    }
    cluster.sync();
    if (at.rank == 0 && at.warp == 0) {
      t = {0.f, 0.f, 0.f};
      for (int r = 0; r < S; ++r) {
        const float* o = cluster.map_shared_rank(&s_blk[0][0], r);
        t = combine(t, Stats{o[cl], o[CHB + cl], o[2 * CHB + cl]});
      }
      if (at.live && ch < C) store_stats(stats + (static_cast<size_t>(at.b) * C + ch) * 3, t);
    }
    cluster.sync();
  } else {
    if (at.wl == 0 && at.live && ch < C)
      store_stats(stats + (static_cast<size_t>(at.b) * C + ch) * 3, t);
  }
}

// y = ((x − m)·r)·γ + β of the block, (m, r) merged here from parts (s, B,
// C, 3) in rank order; the group's first block writes (m, r) to mean_r (B, C, 2).
template <typename T>
__global__ void __launch_bounds__(THREADS)
block_apply_kernel(const T* __restrict__ x, const float* __restrict__ parts, int s,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   T* __restrict__ y, float* __restrict__ mean_r, int NQ, int B, int HW, int C,
                   int wpg, int S, int chunk) {
  using P = Place<T>;
  constexpr int VEC = P::VEC, TX = P::TX;
  __shared__ float s_m[WARPS][CHB], s_r[WARPS][CHB];  // by group of the block
  const P at(NQ, HW, C, wpg, S, chunk);
  const bool vec_ok = C % VEC == 0;
  const size_t row0 = static_cast<size_t>(at.b) * HW;

  // Chan's merge in rank order, as ops/norm.merge_block_stats: a lane a channel
  const int ch = at.g * CHB + at.lane;
  if (at.wl == 0 && at.live && ch < C) {
    const size_t bc = static_cast<size_t>(at.b) * C + ch;
    const size_t stride = static_cast<size_t>(B) * C * 3;
    float n = parts[bc * 3], mean = parts[bc * 3 + 1], m2 = parts[bc * 3 + 2];
    for (int r = 1; r < s; ++r) {
      const float* pr = parts + r * stride + bc * 3;
      const float nb = pr[0], mb = pr[1], m2b = pr[2];
      const float tot = __fadd_rn(n, nb);
      const float d = __fsub_rn(mb, mean);
      const float f = __fdiv_rn(nb, tot);
      mean = __fadd_rn(mean, __fmul_rn(d, f));
      m2 = __fadd_rn(__fadd_rn(m2, m2b), __fmul_rn(__fmul_rn(__fmul_rn(d, d), n), f));
      n = tot;
    }
    const float var = fmaxf(__fdiv_rn(m2, n), 0.f);
    const float r = __frcp_rn(__fsqrt_rn(__fadd_rn(var, EPS)));
    s_m[at.gi][at.lane] = mean;
    s_r[at.gi][at.lane] = r;
    if (at.rank == 0) {
      mean_r[bc * 2] = mean;
      mean_r[bc * 2 + 1] = r;
    }
  }
  if (wpg > 1) {
    __syncthreads();
  } else {
    __syncwarp();
  }
  if (!at.live || at.c >= C || at.p_begin >= at.p_end) return;

  const int tx = at.lane % TX;
  float m[VEC], r[VEC], g[VEC], b[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int cv = min(at.c + v, C - 1);  // lanes past C are computed, never stored
    m[v] = s_m[at.gi][tx * VEC + v];
    r[v] = s_r[at.gi][tx * VEC + v];
    g[v] = round_to(gamma[cv], x);
    b[v] = round_to(beta[cv], x);
  }
  // the chunk backwards: what the stats launch read last comes first
  const int len = at.p_end - at.p_begin;
  const int span = at.L * UNROLL;
  const int iters = at.pl < len ? (len - at.pl + span - 1) / span : 0;
  const size_t step = static_cast<size_t>(at.L) * C;
  for (int it = iters - 1; it >= 0; --it) {
    const int p0 = at.p_begin + at.pl + it * span;
    const size_t off0 = (row0 + p0) * C + at.c;
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (p0 + u * at.L < at.p_end) raw[u] = load_vec(x + off0 + u * step, 0, at.c, C, vec_ok);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (p0 + u * at.L >= at.p_end) continue;
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float xv = to_float(reinterpret_cast<const T*>(&raw[u])[v]);
        from_float(&o[v], __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xv, m[v]), r[v]), g[v]), b[v]));
      }
      T* dst = y + off0 + u * step;
      if (vec_ok && at.c + VEC <= C) {
        *reinterpret_cast<uint4*>(dst) = out;
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          if (at.c + v < C) dst[v] = o[v];
      }
    }
  }
}

// The grid of a height-block launch: ⌈NQ / G⌉ · S blocks of wpb warps;
// false for a plan the kernels do not take.
struct Grid {
  int NQ, blocks, chunk;
};

bool block_grid(int B, int HW, int C, int wpg, int wpb, int S, Grid* out) {
  if (B <= 0 || HW <= 0 || C <= 0 || wpg < 1 || wpb < wpg || wpb > WARPS || wpb % wpg ||
      S < 1 || S > MAX_CLUSTER || (S > 1 && wpg != wpb))
    return false;
  const long long nq = static_cast<long long>(B) * ((C + CHB - 1) / CHB);
  const int G = wpb / wpg;
  const long long blocks = (nq + G - 1) / G * S;
  if (nq > (1LL << 30) || blocks > 0x7fffffffLL) return false;
  *out = {static_cast<int>(nq), static_cast<int>(blocks), (HW + S - 1) / S};
  return true;
}

template <typename T>
int launch_block_stats(const void* x, void* stats, int B, int HW, int C, int wpg, int wpb,
                       int S, void* stream) {
  Grid grid;
  if (!block_grid(B, HW, C, wpg, wpb, S, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  float* st = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 1) {
    block_stats_kernel<T, false><<<grid.blocks, wpb * 32, 0, s>>>(xt, st, grid.NQ, HW, C, wpg, 1,
                                                                 grid.chunk);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid.blocks);
  cfg.blockDim = dim3(wpb * 32);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, block_stats_kernel<T, true>, xt, st, grid.NQ,
                                           HW, C, wpg, S, grid.chunk);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_block_apply(const void* x, const void* parts, int s, const void* gamma,
                       const void* beta, void* y, void* mean_r, int B, int HW, int C, int wpg,
                       int wpb, int S, void* stream) {
  Grid grid;
  if (s < 1 || !block_grid(B, HW, C, wpg, wpb, S, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  block_apply_kernel<T><<<grid.blocks, wpb * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(parts), s,
      static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<T*>(y),
      static_cast<float*>(mean_r), grid.NQ, B, HW, C, wpg, S, grid.chunk);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------- backward

constexpr int BWD_UNROLL = 4;  // pixels in flight a lane, of x and of dy each
constexpr int NSUM = 4;        // Σd, Σd², Σdy, Σdy·d

// BWD_UNROLL pixels p0 + u·L of a lane of x and dy (element offset off of
// pixel p0, channel c), u·step apart; a pixel at or past p_end takes K's
// bits in x (d = 0) and zeros in dy
template <typename T>
__device__ __forceinline__ void load_pair(const T* x, const T* dy, size_t off, size_t step, int p0,
                                          int L, int p_end, int c, int C, bool vec_ok, uint4 kraw,
                                          uint4 (&rx)[BWD_UNROLL], uint4 (&rd)[BWD_UNROLL]) {
  if (p0 + (BWD_UNROLL - 1) * L < p_end) {
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      rx[u] = load_vec(x + off + u * step, 0, c, C, vec_ok);
      rd[u] = load_vec(dy + off + u * step, 0, c, C, vec_ok);
    }
  } else {
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      const bool in = p0 + u * L < p_end;
      rx[u] = in ? load_vec(x + off + u * step, 0, c, C, vec_ok) : kraw;
      rd[u] = in ? load_vec(dy + off + u * step, 0, c, C, vec_ok) : make_uint4(0, 0, 0, 0);
    }
  }
}

// dx of the chunk, and (Σdy·x̂, Σdy) per (sample, channel) into parts (B, C,
// 2) unless it is null. Grid and threads as the height-block stats launch
// (Place; S > 1 only with a cluster of S blocks).
template <typename T, bool CLUSTER>
__global__ void __launch_bounds__(THREADS)
instance_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ gamma, T* __restrict__ dx,
                         float* __restrict__ parts, int NQ, int HW, int C, int wpg, int S,
                         int chunk) {
  using P = Place<T>;
  constexpr int VEC = P::VEC, TX = P::TX;
  __shared__ float sh[WARPS][CHB][NSUM + 1];  // each warp's sums of each channel, and K
  __shared__ float s_blk[NSUM][CHB];          // the block's sums, read by the whole cluster
  __shared__ float s_co[WARPS][4][CHB];       // by group of the block: m, r, mean g, mean g·x̂
  const P at(NQ, HW, C, wpg, CLUSTER ? S : 1, chunk);
  const bool vec_ok = C % VEC == 0;
  const size_t row0 = static_cast<size_t>(at.b) * HW;
  const bool work = at.live && at.c < C && at.p_begin < at.p_end;

  float s[NSUM][VEC], k[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    k[v] = 0.f;
#pragma unroll
    for (int i = 0; i < NSUM; ++i) s[i][v] = 0.f;
  }
  if (work) {
    const uint4 kraw = load_vec(x, row0 * C + at.c, at.c, C, vec_ok);  // the sample's pixel 0
#pragma unroll
    for (int v = 0; v < VEC; ++v) k[v] = to_float(reinterpret_cast<const T*>(&kraw)[v]);
    const size_t step = static_cast<size_t>(at.L) * C;
    const int span = at.L * BWD_UNROLL;
    uint4 rx[BWD_UNROLL], rd[BWD_UNROLL], nx[BWD_UNROLL], nd[BWD_UNROLL];
    int p0 = at.p_begin + at.pl;
    load_pair(x, dy, (row0 + p0) * C + at.c, step, p0, at.L, at.p_end, at.c, C, vec_ok, kraw, rx,
              rd);
    for (; p0 < at.p_end; p0 += span) {
      if (p0 + span < at.p_end)
        load_pair(x, dy, (row0 + p0 + span) * C + at.c, step, p0 + span, at.L, at.p_end, at.c, C,
                  vec_ok, kraw, nx, nd);
#pragma unroll
      for (int u = 0; u < BWD_UNROLL; ++u) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float d = __fsub_rn(to_float(reinterpret_cast<const T*>(&rx[u])[v]), k[v]);
          const float g = to_float(reinterpret_cast<const T*>(&rd[u])[v]);
          s[0][v] = __fadd_rn(s[0][v], d);
          s[1][v] = __fmaf_rn(d, d, s[1][v]);
          s[2][v] = __fadd_rn(s[2][v], g);
          s[3][v] = __fmaf_rn(g, d, s[3][v]);
        }
      }
#pragma unroll
      for (int u = 0; u < BWD_UNROLL; ++u) {
        rx[u] = nx[u];
        rd[u] = nd[u];
      }
    }
  }
  // the warp's pixel lanes, added by shuffles: lane ly takes ly + off
#pragma unroll
  for (int off = 16; off >= TX; off >>= 1) {
#pragma unroll
    for (int i = 0; i < NSUM; ++i) {
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        s[i][v] = __fadd_rn(s[i][v], __shfl_down_sync(0xffffffffu, s[i][v], off));
    }
  }
  if (at.lane < TX) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
#pragma unroll
      for (int i = 0; i < NSUM; ++i) sh[at.warp][at.lane * VEC + v][i] = s[i][v];
      sh[at.warp][at.lane * VEC + v][NSUM] = k[v];
    }
  }
  if (wpg > 1) {
    __syncthreads();
  } else {
    __syncwarp();
  }
  // the group's warps in warp order, a lane a channel
  const int w0 = at.gi * wpg, cl = at.lane, ch = at.g * CHB + cl;
  float t[NSUM];
#pragma unroll
  for (int i = 0; i < NSUM; ++i) {
    t[i] = sh[w0][cl][i];
    for (int w = 1; w < wpg; ++w) t[i] = __fadd_rn(t[i], sh[w0 + w][cl][i]);
  }
  if constexpr (CLUSTER) {
    // one group a block: every block adds the S blocks' sums in rank order;
    // the second sync keeps every block alive until all have read
    cg::cluster_group cluster = cg::this_cluster();
    if (at.warp == 0) {
#pragma unroll
      for (int i = 0; i < NSUM; ++i) s_blk[i][cl] = t[i];
    }
    cluster.sync();
    if (at.warp == 0) {
      const float* o = cluster.map_shared_rank(&s_blk[0][0], 0);
#pragma unroll
      for (int i = 0; i < NSUM; ++i) t[i] = o[i * CHB + cl];
      for (int r = 1; r < S; ++r) {
        o = cluster.map_shared_rank(&s_blk[0][0], r);
#pragma unroll
        for (int i = 0; i < NSUM; ++i) t[i] = __fadd_rn(t[i], o[i * CHB + cl]);
      }
    }
    cluster.sync();
  }
  if (at.wl == 0 && at.live && ch < C) {
    const float n = static_cast<float>(HW);
    const float mk = __fdiv_rn(t[0], n);  // m − K
    const float var = __fdiv_rn(fmaxf(__fsub_rn(t[1], __fmul_rn(t[0], mk)), 0.f), n);
    const float r = __frcp_rn(__fsqrt_rn(__fadd_rn(var, EPS)));
    const float sdyx = __fmul_rn(r, __fsub_rn(t[3], __fmul_rn(mk, t[2])));  // Σdy·x̂
    const float gm = gamma[ch];
    s_co[at.gi][0][cl] = __fadd_rn(sh[w0][cl][NSUM], mk);
    s_co[at.gi][1][cl] = r;
    s_co[at.gi][2][cl] = __fdiv_rn(__fmul_rn(t[2], gm), n);
    s_co[at.gi][3][cl] = __fdiv_rn(__fmul_rn(sdyx, gm), n);
    if (parts != nullptr && at.rank == 0) {
      float* o = parts + (static_cast<size_t>(at.b) * C + ch) * 2;
      o[0] = sdyx;
      o[1] = t[2];
    }
  }
  if (wpg > 1) {
    __syncthreads();
  } else {
    __syncwarp();
  }
  if (!work) return;

  const int tx = at.lane % TX;
  float m[VEC], r[VEC], gm[VEC], mg[VEC], mgx[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int cv = tx * VEC + v;  // lanes past C are computed, never stored
    m[v] = s_co[at.gi][0][cv];
    r[v] = s_co[at.gi][1][cv];
    mg[v] = s_co[at.gi][2][cv];
    mgx[v] = s_co[at.gi][3][cv];
    gm[v] = gamma[min(at.c + v, C - 1)];
  }
  // the chunk backwards: what the sums read last comes first
  const int len = at.p_end - at.p_begin;
  const int span = at.L * BWD_UNROLL;
  const int iters = at.pl < len ? (len - at.pl + span - 1) / span : 0;
  const size_t step = static_cast<size_t>(at.L) * C;
  for (int it = iters - 1; it >= 0; --it) {
    const int p0 = at.p_begin + at.pl + it * span;
    const size_t off0 = (row0 + p0) * C + at.c;
    uint4 rx[BWD_UNROLL], rd[BWD_UNROLL];
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      if (p0 + u * at.L < at.p_end) {
        rx[u] = load_vec(x + off0 + u * step, 0, at.c, C, vec_ok);
        rd[u] = load_vec(dy + off0 + u * step, 0, at.c, C, vec_ok);
      }
    }
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      if (p0 + u * at.L >= at.p_end) continue;
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float xh = __fmul_rn(__fsub_rn(to_float(reinterpret_cast<const T*>(&rx[u])[v]), m[v]),
                                   r[v]);
        const float g = __fmul_rn(to_float(reinterpret_cast<const T*>(&rd[u])[v]), gm[v]);
        from_float(&o[v], __fmul_rn(r[v], __fsub_rn(__fsub_rn(g, mg[v]), __fmul_rn(xh, mgx[v]))));
      }
      T* dst = dx + off0 + u * step;
      if (vec_ok && at.c + VEC <= C) {
        *reinterpret_cast<uint4*>(dst) = out;
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          if (at.c + v < C) dst[v] = o[v];
      }
    }
  }
}

// dγ and dβ (C,): each channel's B pairs of parts (B, C, 2) added in sample
// order
__global__ void instance_norm_bwd_affine_kernel(const float* __restrict__ parts,
                                                float* __restrict__ dgamma,
                                                float* __restrict__ dbeta, int B, int C) {
  const int c = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (c >= C) return;
  float dg = 0.f, db = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* p = parts + (static_cast<size_t>(b) * C + c) * 2;
    dg = __fadd_rn(dg, p[0]);
    db = __fadd_rn(db, p[1]);
  }
  dgamma[c] = dg;
  dbeta[c] = db;
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const void* gamma, void* dx, void* parts,
               void* dgamma, void* dbeta, int B, int HW, int C, int wpg, int wpb, int S,
               void* stream) {
  Grid grid;
  if (!block_grid(B, HW, C, wpg, wpb, S, &grid) || (parts == nullptr) != (dgamma == nullptr) ||
      (parts == nullptr) != (dbeta == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const float* g = static_cast<const float*>(gamma);
  T* dxt = static_cast<T*>(dx);
  float* pt = static_cast<float*>(parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 1) {
    instance_norm_bwd_kernel<T, false><<<grid.blocks, wpb * 32, 0, s>>>(
        xt, dyt, g, dxt, pt, grid.NQ, HW, C, wpg, 1, grid.chunk);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid.blocks);
    cfg.blockDim = dim3(wpb * 32);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, instance_norm_bwd_kernel<T, true>, xt, dyt, g,
                                             dxt, pt, grid.NQ, HW, C, wpg, S, grid.chunk);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || parts == nullptr) return static_cast<int>(e);
  instance_norm_bwd_affine_kernel<<<(C + 127) / 128, 128, 0, s>>>(
      pt, static_cast<float*>(dgamma), static_cast<float*>(dbeta), B, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (B, H·W, C) contiguous in x's dtype; gamma, beta: (C,) float32;
// cluster: the blocks S (1 to 8) that split H·W.
extern "C" int gct2_instance_norm_f32(const void* x, const void* gamma, const void* beta,
                                      void* y, int B, int HW, int C, int cluster,
                                      void* stream) {
  return launch<float>(x, gamma, beta, y, B, HW, C, cluster, stream);
}

extern "C" int gct2_instance_norm_bf16(const void* x, const void* gamma, const void* beta,
                                       void* y, int B, int HW, int C, int cluster,
                                       void* stream) {
  return launch<__nv_bfloat16>(x, gamma, beta, y, B, HW, C, cluster, stream);
}

// Height blocks; (wpg, wpb, S) is ops/norm.block_plan's (warps a group,
// warps a block, blocks a group). stats: the block's (count, mean, M2) per
// (sample, channel), float32 (B, C, 3), written; x as above.
extern "C" int gct2_instance_norm_block_stats_f32(const void* x, void* stats, int B, int HW,
                                                  int C, int wpg, int wpb, int S,
                                                  void* stream) {
  return launch_block_stats<float>(x, stats, B, HW, C, wpg, wpb, S, stream);
}

extern "C" int gct2_instance_norm_block_stats_bf16(const void* x, void* stats, int B, int HW,
                                                   int C, int wpg, int wpb, int S,
                                                   void* stream) {
  return launch_block_stats<__nv_bfloat16>(x, stats, B, HW, C, wpg, wpb, S, stream);
}

// parts: every block's triples, float32 (s, B, C, 3), read; y = ((x − m)·r)·γ
// + β from their merge; mean_r: the merged (m, r) per (sample, channel),
// float32 (B, C, 2), written.
extern "C" int gct2_instance_norm_block_apply_f32(const void* x, const void* parts, int s,
                                                  const void* gamma, const void* beta, void* y,
                                                  void* mean_r, int B, int HW, int C, int wpg,
                                                  int wpb, int S, void* stream) {
  return launch_block_apply<float>(x, parts, s, gamma, beta, y, mean_r, B, HW, C, wpg, wpb, S,
                                   stream);
}

extern "C" int gct2_instance_norm_block_apply_bf16(const void* x, const void* parts, int s,
                                                   const void* gamma, const void* beta, void* y,
                                                   void* mean_r, int B, int HW, int C, int wpg,
                                                   int wpb, int S, void* stream) {
  return launch_block_apply<__nv_bfloat16>(x, parts, s, gamma, beta, y, mean_r, B, HW, C, wpg,
                                           wpb, S, stream);
}

// Backward; (wpg, wpb, S) is ops/norm.block_plan's of the whole image. x, dy,
// dx: (B, H·W, C) contiguous in x's dtype; gamma: (C,) float32; parts: float32
// (B, C, 2) scratch, dgamma and dbeta: float32 (C,), written; all three null for
// dx alone (one launch instead of two).
extern "C" int gct2_instance_norm_bwd_f32(const void* x, const void* dy, const void* gamma,
                                          void* dx, void* parts, void* dgamma, void* dbeta,
                                          int B, int HW, int C, int wpg, int wpb, int S,
                                          void* stream) {
  return launch_bwd<float>(x, dy, gamma, dx, parts, dgamma, dbeta, B, HW, C, wpg, wpb, S,
                           stream);
}

extern "C" int gct2_instance_norm_bwd_bf16(const void* x, const void* dy, const void* gamma,
                                           void* dx, void* parts, void* dgamma, void* dbeta,
                                           int B, int HW, int C, int wpg, int wpb, int S,
                                           void* stream) {
  return launch_bwd<__nv_bfloat16>(x, dy, gamma, dx, parts, dgamma, dbeta, B, HW, C, wpg, wpb,
                                   S, stream);
}
