// Fused forward diffusion for Hopper (sm_90a): noised = x·ss[b] + ε·sn[b].
//
// Replaces gan_class_transfer2_tpu/ops/kernels.py::_diffuse_kernel (the Pallas
// TPU kernel of the training step's q(x_t | x_0), reference train.py:231-234).
// ε ~ N(0, 1) is drawn inside the kernel and never written to memory.
//
// The random numbers: Philox4x32-10 keyed by the 64-bit seed (read from device
// memory, so the caller draws it on the card without a host sync), counter
// (element / 4, sample, half, 0). One thread owns four consecutive elements of
// one sample and runs two Philox blocks (half 0, 1); each pair of words (a, b)
// gives one normal by the Box–Muller transform of kernels.py:31-41:
//   u1 = (a >> 8)·2^-24 + 2^-25,  u2 = (b >> 8)·2^-24,  ε = √(−2 ln u1)·cos(2π u2).
// Element 4g + 2·half + j takes words (2j, 2j+1) of block half. The plain
// version in ops/fused_diffusion.py computes the same words in int64 tensors;
// every float operation here is written with the _rn intrinsics (no FMA
// contraction) and the library's IEEE logf/cosf/sqrtf, so the two agree up to
// the rounding of log and cos (the build has no --use_fast_math).
//
// Bound on this card: bytes. x read once and noised written once, 8 bytes per
// element (25.2 MB at batch 16 × 256²×3: 7.5 µs at 3.35 TB/s); the ~60 integer
// and ~20 float operations per element were expected to stay below the
// bandwidth line, but the kernel takes 6–7× that bound on an H100 80GB HBM3 at
// 700 W (chip_smoke.py), for a reason not yet measured. Design:
// 16-byte loads and stores (one float4 per thread), one thread per group of 4,
// grid (groups / 256, B) so the per-sample scales are two broadcast loads.
//
// The entry point launches on the given stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c[0], hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2], hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

__device__ __forceinline__ float normal_from_words(uint32_t a, uint32_t b) {
  const float u1 = __fadd_rn(__fmul_rn(static_cast<float>(a >> 8), 1.0f / 16777216.0f),
                             0.5f / 16777216.0f);
  const float u2 = __fmul_rn(static_cast<float>(b >> 8), 1.0f / 16777216.0f);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.283185307179586f, u2)));
}

__global__ void __launch_bounds__(THREADS)
diffuse_f32_kernel(const float4* __restrict__ x, const float* __restrict__ ss,
                   const float* __restrict__ sn, const long long* __restrict__ seed,
                   float4* __restrict__ out, long long groups) {
  const long long g = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (g >= groups) return;
  const int b = blockIdx.y;
  const unsigned long long s = static_cast<unsigned long long>(*seed);
  const uint32_t k0 = static_cast<uint32_t>(s), k1 = static_cast<uint32_t>(s >> 32);
  float eps[4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t c[4] = {static_cast<uint32_t>(g), static_cast<uint32_t>(b),
                     static_cast<uint32_t>(half), 0u};
    philox4x32_10(c, k0, k1);
    eps[2 * half] = normal_from_words(c[0], c[1]);
    eps[2 * half + 1] = normal_from_words(c[2], c[3]);
  }
  const float a = ss[b], n = sn[b];
  const size_t i = static_cast<size_t>(b) * groups + g;
  const float4 v = x[i];
  float4 o;
  o.x = __fadd_rn(__fmul_rn(v.x, a), __fmul_rn(eps[0], n));
  o.y = __fadd_rn(__fmul_rn(v.y, a), __fmul_rn(eps[1], n));
  o.z = __fadd_rn(__fmul_rn(v.z, a), __fmul_rn(eps[2], n));
  o.w = __fadd_rn(__fmul_rn(v.w, a), __fmul_rn(eps[3], n));
  out[i] = o;
}

}  // namespace

// x, out: (B, N) float32, N % 4 == 0, 16-byte aligned; ss, sn: (B,) float32;
// seed: one int64 on the device.
extern "C" int gct2_diffuse_f32(const void* x, const void* ss, const void* sn, const void* seed,
                                void* out, int B, long long N, void* stream) {
  if (B <= 0 || N <= 0 || N % 4 != 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = N / 4;
  if (groups > 0xFFFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);  // 32-bit counter word
  const dim3 grid(static_cast<unsigned>((groups + THREADS - 1) / THREADS), B);
  diffuse_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float*>(ss),
      static_cast<const float*>(sn), static_cast<const long long*>(seed),
      static_cast<float4*>(out), groups);
  return static_cast<int>(cudaGetLastError());
}
