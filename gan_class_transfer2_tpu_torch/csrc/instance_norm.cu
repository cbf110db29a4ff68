// Instance norm for Hopper (sm_90a), NHWC in and out.
//
// Replaces gan_class_transfer2_tpu/ops/norm.py::_in_kernel (the Pallas TPU
// kernel of the GAN generators' and discriminators' instance norm). For x of
// shape (B, H, W, C) it computes, per (sample, channel), the mean m and the
// variance v over the H·W pixels in float32, r = 1/√(v + 1e-5), and
//   y = ((x − m)·r)·γ + β,
// stored in x's dtype (float32 or bfloat16). γ and β arrive as float32 (the
// parameters' dtype) and are rounded to x's dtype here, as the Pallas wrapper
// rounds them before its call (norm.py:76). The affine is evaluated in the order of
// the two-pass reference (norm.py:41-45), the same function as the TPU
// kernel's x·(γr) + (β − m·γ·r) with fewer roundings on large |m|.
//
// The variance is Welford's, combined by Chan et al.'s pairwise rule, not
// the TPU kernel's one-pass E[x²] − m² (norm.py:51-54): the same quantity
// without the cancellation, so the kernel agrees with the two-pass plain
// version at every shape; it is clamped at 0 as the TPU kernel clamps it.
// Every float operation is an _rn intrinsic (the build has no fast math).
//
// Bound on this card: bytes. x is read and y written, once each, so
// 2·B·H·W·C·sizeof(dtype) bytes; the arithmetic is a few operations per
// element. Design, simple first:
//   * grid (⌈C/32⌉, B): one block per sample and 32 channels, so no
//     statistics cross blocks and one launch does the whole norm;
//   * 32×32 threads: threadIdx.x is a channel, the contiguous axis, so a
//     warp's load is one run of 32 channels of one pixel (coalesced);
//     threadIdx.y strides over the pixels, 4 loads in flight per thread;
//   * each thread folds each group of up to 4 pixels into its own (count,
//     mean, M2) triple; the 32 triples of a channel are combined in shared
//     memory by a tree of Chan combines;
//   * a second loop over the same pixels writes y. That second read of x is
//     served by the L2 for the smaller maps and by device memory for the
//     256²×64 and 128²×128 ones, whose B·⌈C/32⌉ = 32–64 blocks also leave
//     most of the 132 SMs idle (splitting H·W across a cluster is later work).
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CH = 32;      // channels per block (threadIdx.x)
constexpr int ROWS = 32;    // pixel lanes per block (threadIdx.y)
constexpr int UNROLL = 4;   // loads in flight per thread
constexpr float EPS = 1e-5f;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
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

template <typename T>
__global__ void __launch_bounds__(CH * ROWS)
instance_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y, int HW, int C) {
  __shared__ float s_n[ROWS][CH + 1], s_mean[ROWS][CH + 1], s_m2[ROWS][CH + 1];
  __shared__ float s_m[CH], s_r[CH];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * CH + tx;
  const bool live = c < C;
  const size_t base = static_cast<size_t>(blockIdx.y) * HW * C + c;
  const size_t step = static_cast<size_t>(ROWS) * C;  // ROWS pixels on

  // pass 1: each thread's triple over pixels ty, ty + ROWS, ty + 2·ROWS, ...
  Stats s = {0.f, 0.f, 0.f};
  if (live) {
    const T* xs = x + base + static_cast<size_t>(ty) * C;
    for (int p0 = ty; p0 < HW; p0 += ROWS * UNROLL, xs += UNROLL * step) {
      float v[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) v[k] = p0 + k * ROWS < HW ? load(xs + k * step) : 0.f;
      // the group's own triple (count ≥ 1, two passes over registers)
      const int cnt = min(UNROLL, (HW - p0 + ROWS - 1) / ROWS);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) sum = __fadd_rn(sum, v[k]);  // padded lanes hold 0
      Stats g;
      g.n = static_cast<float>(cnt);
      g.mean = __fdiv_rn(sum, g.n);
      g.m2 = 0.f;
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const float d = __fsub_rn(v[k], g.mean);
        if (k < cnt) g.m2 = __fadd_rn(g.m2, __fmul_rn(d, d));
      }
      s = combine(s, g);
    }
  }

  // the ROWS triples of each channel, combined by a tree in shared memory
  s_n[ty][tx] = s.n;
  s_mean[ty][tx] = s.mean;
  s_m2[ty][tx] = s.m2;
  __syncthreads();
#pragma unroll
  for (int half = ROWS / 2; half > 0; half >>= 1) {
    if (ty < half) {
      const Stats a = {s_n[ty][tx], s_mean[ty][tx], s_m2[ty][tx]};
      const Stats b = {s_n[ty + half][tx], s_mean[ty + half][tx], s_m2[ty + half][tx]};
      const Stats o = combine(a, b);
      s_n[ty][tx] = o.n;
      s_mean[ty][tx] = o.mean;
      s_m2[ty][tx] = o.m2;
    }
    __syncthreads();
  }
  if (ty == 0 && live) {
    const float var = fmaxf(__fdiv_rn(s_m2[0][tx], s_n[0][tx]), 0.f);
    s_m[tx] = s_mean[0][tx];
    s_r[tx] = __frcp_rn(__fsqrt_rn(__fadd_rn(var, EPS)));
  }
  __syncthreads();
  if (!live) return;

  // pass 2: y = ((x − m)·r)·γ + β over the same pixels
  const float m = s_m[tx], r = s_r[tx], g = round_to(gamma[c], x), b = round_to(beta[c], x);
  const T* xs = x + base + static_cast<size_t>(ty) * C;
  T* ys = y + base + static_cast<size_t>(ty) * C;
  for (int p0 = ty; p0 < HW; p0 += ROWS * UNROLL, xs += UNROLL * step, ys += UNROLL * step) {
    float v[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) v[k] = p0 + k * ROWS < HW ? load(xs + k * step) : 0.f;
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (p0 + k * ROWS < HW)
        store(ys + k * step, __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[k], m), r), g), b));
    }
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y, int B, int HW, int C,
           void* stream) {
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + CH - 1) / CH, B), block(CH, ROWS);
  instance_norm_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y), HW, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (B, H·W, C) contiguous in x's dtype; gamma, beta: (C,) float32.
extern "C" int gct2_instance_norm_f32(const void* x, const void* gamma, const void* beta,
                                      void* y, int B, int HW, int C, void* stream) {
  return launch<float>(x, gamma, beta, y, B, HW, C, stream);
}

extern "C" int gct2_instance_norm_bf16(const void* x, const void* gamma, const void* beta,
                                       void* y, int B, int HW, int C, void* stream) {
  return launch<__nv_bfloat16>(x, gamma, beta, y, B, HW, C, stream);
}
