// Fused forward diffusion for Hopper (sm_90a): noised = x·ss[b] + ε·sn[b],
// with (ss[b], sn[b]) = table[t[b]] = (√ᾱ(t), √(1−ᾱ(t))) gathered in the kernel.
//
// Replaces gan_class_transfer2_tpu/ops/kernels.py::_diffuse_kernel (the Pallas
// TPU kernel of the training step's q(x_t | x_0), reference train.py:231-234).
// ε ~ N(0, 1) is drawn inside the kernel and never written to memory.
//
// The random numbers: Philox4x32-10 keyed by the 64-bit seed (read from device
// memory, so the caller draws it on the card without a host sync), counter
// (group, sample, half, 0) for the float4 group of elements 4·group .. 4·group+3
// of one sample. Each group takes two Philox blocks (half 0, 1); each pair of
// words (a, b) gives one normal by the Box–Muller transform of kernels.py:31-41:
//   u1 = (a >> 8)·2^-24 + 2^-25,  u2 = (b >> 8)·2^-24,  ε = √(−2 ln u1)·cos(2π u2).
// Element 4g + 2·half + j takes words (2j, 2j+1) of block half. The plain
// version in ops/fused_diffusion.py computes the same words in int64 tensors;
// every float operation here is written with the _rn intrinsics (no FMA
// contraction) and the library's IEEE logf/cosf/sqrtf (no --use_fast_math), so
// the kernel equals its plain version on the card bit for bit.
//
// What bounds it on an H100: its instructions, not its bytes. x is read once
// and noised written once, 8 bytes an element (25.2 MB at batch 16 × 256²×3:
// 7.5 µs at 3.35 TB/s), but the kernel takes about the same time with L2 warm
// as cold, and cutting Philox to one XOR or approximating log, cos and sqrt
// (--use_fast_math, 2.8e-5 off the plain version: not usable) each saves 4–7
// µs (tools/kernel_plan_sweep.py, H100 80GB HBM3 at 700 W). Philox is ~23
// integer instructions an element in this build's SASS (a product's hi and lo
// are one IMAD.WIDE), Box–Muller with the IEEE log, sqrt and cos ~50 more. The
// first design (one float4 group a thread, its load started after the Philox
// rounds; in the git history) took 15.9 µs with L2 cold. Design:
//   * a thread owns GROUPS float4 groups of one sample, THREADS apart so that
//     each load and store of a warp is 512 contiguous bytes; it starts their
//     loads first, and their latency passes under the Philox rounds;
//   * Philox runs round by round over the thread's 2·GROUPS blocks: the key
//     schedule is computed once for all of them, and the independent chains
//     fill the multiplier's latency;
//   * grid (groups / (THREADS·GROUPS), B): the block's sample is blockIdx.y,
//     so t[b] and its two scales are one broadcast load each.
// The sweep of the tool's b1-knobs section picked GROUPS = 2 (1, 4 and 8, a
// single 32×32→64 multiply for hi and lo, and a one-wave grid looping over
// the chunks measured no faster).
// A t outside [0, rows) gives NaN outputs: the kernel cannot raise.
//
// Data parallelism (B1s, kernels.py:209 forward_diffuse_fused_sharded): each
// rank runs this kernel on its own block of the batch with the same seed, so
// the counter (group, local sample, half, 0) repeats on every rank. The
// entry point gct2_diffuse_f32_folded takes a 32-bit fold word, XORed into
// the key's low word in the kernel: JAX's seed ^ ((position + 1)·0x9E3779B9)
// with the product wrapped to 32 bits, computed on the host from the rank's
// linear position (no device op, no host sync). The high word is untouched.
// gct2_diffuse_f32 is the same launch with fold 0 (B1, one process).
//
// The entry point launches on the given stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int GROUPS = 2;                 // float4 groups a thread takes
constexpr int BLOCKS = 2 * GROUPS;        // Philox blocks a thread runs
constexpr int CHUNK = THREADS * GROUPS;   // groups a block takes

__device__ __forceinline__ void philox4x32_10(uint32_t (&c)[BLOCKS][4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
#pragma unroll
    for (int i = 0; i < BLOCKS; ++i) {
      const uint32_t lo0 = 0xD2511F53u * c[i][0], hi0 = __umulhi(0xD2511F53u, c[i][0]);
      const uint32_t lo1 = 0xCD9E8D57u * c[i][2], hi1 = __umulhi(0xCD9E8D57u, c[i][2]);
      const uint32_t n0 = hi1 ^ c[i][1] ^ k0, n2 = hi0 ^ c[i][3] ^ k1;
      c[i][0] = n0;
      c[i][1] = lo1;
      c[i][2] = n2;
      c[i][3] = lo0;
    }
  }
}

__device__ __forceinline__ float normal_from_words(uint32_t a, uint32_t b) {
  const float u1 = __fadd_rn(__fmul_rn(static_cast<float>(a >> 8), 1.0f / 16777216.0f),
                             0.5f / 16777216.0f);
  const float u2 = __fmul_rn(static_cast<float>(b >> 8), 1.0f / 16777216.0f);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.283185307179586f, u2)));
}

__device__ __forceinline__ float4 diffuse4(float4 v, float e0, float e1, float e2, float e3,
                                           float ss, float sn) {
  float4 o;
  o.x = __fadd_rn(__fmul_rn(v.x, ss), __fmul_rn(e0, sn));
  o.y = __fadd_rn(__fmul_rn(v.y, ss), __fmul_rn(e1, sn));
  o.z = __fadd_rn(__fmul_rn(v.z, ss), __fmul_rn(e2, sn));
  o.w = __fadd_rn(__fmul_rn(v.w, ss), __fmul_rn(e3, sn));
  return o;
}

__global__ void __launch_bounds__(THREADS)
diffuse_f32_kernel(const float4* __restrict__ x, const int* __restrict__ t,
                   const float* __restrict__ table, int rows,
                   const long long* __restrict__ seed, unsigned int fold,
                   float4* __restrict__ out, long long groups) {
  const int b = blockIdx.y;
  const long long base = static_cast<long long>(blockIdx.x) * CHUNK + threadIdx.x;
  const float4* xb = x + static_cast<size_t>(b) * groups;
  float4* ob = out + static_cast<size_t>(b) * groups;
  // the loads first: their latency passes under the Philox rounds below
  float4 v[GROUPS];
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    const long long g = base + j * THREADS;
    v[j] = g < groups ? xb[g] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int tb = t[b];
  float ss = __int_as_float(0x7fc00000), sn = ss;  // NaN unless t[b] is a row
  if (tb >= 0 && tb < rows) {
    ss = table[2 * tb];
    sn = table[2 * tb + 1];
  }
  const unsigned long long s = static_cast<unsigned long long>(*seed);
  uint32_t c[BLOCKS][4];
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      c[2 * j + half][0] = static_cast<uint32_t>(base + j * THREADS);
      c[2 * j + half][1] = static_cast<uint32_t>(b);
      c[2 * j + half][2] = static_cast<uint32_t>(half);
      c[2 * j + half][3] = 0u;
    }
  }
  philox4x32_10(c, static_cast<uint32_t>(s) ^ fold, static_cast<uint32_t>(s >> 32));
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    const long long g = base + j * THREADS;
    if (g < groups) {
      ob[g] = diffuse4(v[j], normal_from_words(c[2 * j][0], c[2 * j][1]),
                       normal_from_words(c[2 * j][2], c[2 * j][3]),
                       normal_from_words(c[2 * j + 1][0], c[2 * j + 1][1]),
                       normal_from_words(c[2 * j + 1][2], c[2 * j + 1][3]), ss, sn);
    }
  }
}

}  // namespace

// x, out: (B, N) float32, N % 4 == 0, 16-byte aligned; t: (B,) int32 on the
// device; table: (rows, 2) float32, row t = (ss, sn); seed: one int64 on the
// device; fold: XORed into the seed's low word (0: the seed as it is).
extern "C" int gct2_diffuse_f32_folded(const void* x, const void* t, const void* table, int rows,
                                       const void* seed, unsigned int fold, void* out, int B,
                                       long long N, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || N % 4 != 0 || rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = N / 4;
  if (groups > 0xFFFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);  // 32-bit counter word
  const dim3 grid(static_cast<unsigned>((groups + CHUNK - 1) / CHUNK), static_cast<unsigned>(B));
  diffuse_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const int*>(t), static_cast<const float*>(table),
      rows, static_cast<const long long*>(seed), fold, static_cast<float4*>(out), groups);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gct2_diffuse_f32(const void* x, const void* t, const void* table, int rows,
                                const void* seed, void* out, int B, long long N, void* stream) {
  return gct2_diffuse_f32_folded(x, t, table, rows, seed, 0u, out, B, N, stream);
}
