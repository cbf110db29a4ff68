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
// image, so the one launch above splits into two around a gather:
//   * stats: the same pass 1 and cluster combine, and the cluster's rank-0
//     block writes the block's (count, mean, M2) per (sample, channel) to a
//     float32 (B, C, 3) array; no pass 2;
//   * apply: pass 2 alone, from a float32 (B, C, 2) array of (mean, r) that
//     the caller merged from every rank's triples (Chan's rule in rank
//     order, ops/norm.py), over the same cluster split of the block.
// Between them ops/norm.py all-gathers the triples over the spatial axis. The
// single-launch entry points are unchanged: their kernel is MODE 0 of the
// same template, the two new ones MODE 1 and 2.
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

enum Mode { FULL = 0, STATS = 1, APPLY = 2 };

// MODE FULL: y from x. STATS: the block's triples to stats (B, C, 3), no y.
// APPLY: y from x and the given (mean, r) in stats (B, C, 2).
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
instance_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y,
                     float* __restrict__ stats, int HW, int C, int chunk) {
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

  if constexpr (MODE == APPLY) {
    if (threadIdx.x < CHB) {
      const int ch = group * CHB + threadIdx.x;
      const size_t at = (static_cast<size_t>(blockIdx.y) * C + min(ch, C - 1)) * 2;
      s_m[threadIdx.x] = stats[at];
      s_r[threadIdx.x] = stats[at + 1];
    }
    __syncthreads();
  } else {
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
    if constexpr (MODE == STATS) {
      const int cg_ch = group * CHB + ch;
      if (rank == 0 && cg_ch < C) {
        float* o = stats + (static_cast<size_t>(blockIdx.y) * C + cg_ch) * 3;
        o[0] = t.n;
        o[1] = t.mean;
        o[2] = t.m2;
      }
    } else {
      const float var = t.n > 0.f ? fmaxf(__fdiv_rn(t.m2, t.n), 0.f) : 0.f;
      s_m[ch] = t.mean;
      s_r[ch] = __frcp_rn(__fsqrt_rn(__fadd_rn(var, EPS)));
    }
  }
  cluster.sync();
  }
  if constexpr (MODE == STATS) return;
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

template <typename T, int MODE>
int launch(const void* x, const void* gamma, const void* beta, void* y, void* stats, int B,
           int HW, int C, int cluster, void* stream) {
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
      &cfg, instance_norm_kernel<T, MODE>, static_cast<const T*>(x),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<T*>(y),
      static_cast<float*>(stats), HW, C, chunk);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (B, H·W, C) contiguous in x's dtype; gamma, beta: (C,) float32;
// cluster: the blocks S (1 to 8) that split H·W.
extern "C" int gct2_instance_norm_f32(const void* x, const void* gamma, const void* beta,
                                      void* y, int B, int HW, int C, int cluster,
                                      void* stream) {
  return launch<float, FULL>(x, gamma, beta, y, nullptr, B, HW, C, cluster, stream);
}

extern "C" int gct2_instance_norm_bf16(const void* x, const void* gamma, const void* beta,
                                       void* y, int B, int HW, int C, int cluster,
                                       void* stream) {
  return launch<__nv_bfloat16, FULL>(x, gamma, beta, y, nullptr, B, HW, C, cluster, stream);
}

// Height blocks. stats: the block's (count, mean, M2) per (sample, channel),
// float32 (B, C, 3), written; x as above.
extern "C" int gct2_instance_norm_stats_f32(const void* x, void* stats, int B, int HW, int C,
                                            int cluster, void* stream) {
  return launch<float, STATS>(x, nullptr, nullptr, nullptr, stats, B, HW, C, cluster, stream);
}

extern "C" int gct2_instance_norm_stats_bf16(const void* x, void* stats, int B, int HW, int C,
                                             int cluster, void* stream) {
  return launch<__nv_bfloat16, STATS>(x, nullptr, nullptr, nullptr, stats, B, HW, C, cluster,
                                      stream);
}

// mean_r: the merged (mean, r = 1/√(v + 1e-5)) per (sample, channel), float32
// (B, C, 2), read; y = ((x − mean)·r)·γ + β as the single launch computes it.
extern "C" int gct2_instance_norm_apply_f32(const void* x, const void* mean_r,
                                            const void* gamma, const void* beta, void* y,
                                            int B, int HW, int C, int cluster, void* stream) {
  return launch<float, APPLY>(x, gamma, beta, y, const_cast<void*>(mean_r), B, HW, C, cluster,
                              stream);
}

extern "C" int gct2_instance_norm_apply_bf16(const void* x, const void* mean_r,
                                             const void* gamma, const void* beta, void* y,
                                             int B, int HW, int C, int cluster,
                                             void* stream) {
  return launch<__nv_bfloat16, APPLY>(x, gamma, beta, y, const_cast<void*>(mean_r), B, HW, C,
                                      cluster, stream);
}
