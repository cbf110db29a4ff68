// Fused multi-tensor Adam (Keras form) for Hopper (sm_90a), in place.
//
// Replaces gan_class_transfer2_tpu/ops/adam_kernel.py::_adam_kernel (the Pallas
// TPU kernel behind optimizer="adam_fused"). Per element, float32 math:
//   m' = b1·m + (1−b1)·g,  v' = b2·v + (1−b2)·g·g,  p' = p − s·m' / (√v' + eps)
// with s = lr·√(1−b2^t)/(1−b1^t) read from device memory (computed on the card
// by the wrapper, so no host sync). Moments are float32 or bfloat16 (math in
// float32, stored rounded to nearest even). Every operation is an _rn intrinsic
// in the order of the plain version (ops/adam_kernel.py::adam_plain), so the
// two agree bit for bit: no FMA contraction, IEEE sqrt and division.
//
// Where the Pallas version launches one kernel per leaf and sends leaves whose
// size is not a multiple of 128 to XLA, this is one launch over up to
// MAX_LEAVES leaves: their pointers and sizes travel in the kernel's parameter
// block (a table in constant memory on the card, under the 4 KB limit), with
// the first block index of each leaf; a block finds its leaf by a binary search
// over those and updates CHUNK consecutive elements of it. Small leaves run the
// same code, so no leaf takes another path.
//
// Bound on this card: bytes. g, p, m, v read once and p, m, v written once:
// 28 bytes per parameter with float32 moments (1.17 GB for the 41.7 M-param
// model: 0.35 ms at 3.35 TB/s), 20 with bfloat16 moments; ~10 flops per element.
// Design: 16-byte vector loads and stores where a leaf allows them (size a
// multiple of 4, every pointer 16-byte aligned; 8-byte for bfloat16 moments),
// scalar code otherwise; 256 threads × 4 vectors per block.
//
// Each entry point launches on the given stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 48;  // ops/adam_kernel.py LEAVES_PER_LAUNCH
constexpr int THREADS = 256;
constexpr int VEC = 4;
constexpr long long CHUNK = THREADS * VEC * 4;  // elements per block

struct Leaves {
  float* p[MAX_LEAVES];
  void* m[MAX_LEAVES];
  void* v[MAX_LEAVES];
  const float* g[MAX_LEAVES];
  long long n[MAX_LEAVES];
  int first_block[MAX_LEAVES + 1];
  int vec_ok[MAX_LEAVES];
  int count;
};

struct Coef {
  float b1, b2, omb1, omb2, eps;
};

__device__ __forceinline__ float load_m(const float* a, long long i) { return a[i]; }
__device__ __forceinline__ float load_m(const __nv_bfloat16* a, long long i) {
  return __bfloat162float(a[i]);
}
__device__ __forceinline__ void store_m(float* a, long long i, float x) { a[i] = x; }
__device__ __forceinline__ void store_m(__nv_bfloat16* a, long long i, float x) {
  a[i] = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void adam_elem(float& p, float g, float& m, float& v, float s,
                                          const Coef& c) {
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(__fmul_rn(c.omb2, g), g));
  const float upd = __fdiv_rn(__fmul_rn(s, m), __fadd_rn(__fsqrt_rn(v), c.eps));
  p = __fsub_rn(p, upd);
}

// 4 moments at element i (a multiple of 4) of a vector-aligned leaf
__device__ __forceinline__ void load4(const float* a, long long i, float r[4]) {
  const float4 t = *reinterpret_cast<const float4*>(a + i);
  r[0] = t.x, r[1] = t.y, r[2] = t.z, r[3] = t.w;
}
__device__ __forceinline__ void store4(float* a, long long i, const float r[4]) {
  *reinterpret_cast<float4*>(a + i) = make_float4(r[0], r[1], r[2], r[3]);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* a, long long i, float r[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(a + i);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  r[0] = __low2float(lo), r[1] = __high2float(lo), r[2] = __low2float(hi), r[3] = __high2float(hi);
}
__device__ __forceinline__ void store4(__nv_bfloat16* a, long long i, const float r[4]) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) = __floats2bfloat162_rn(r[0], r[1]);
  *reinterpret_cast<__nv_bfloat162*>(&t.y) = __floats2bfloat162_rn(r[2], r[3]);
  *reinterpret_cast<uint2*>(a + i) = t;
}

template <typename M>
__global__ void __launch_bounds__(THREADS)
adam_kernel(const Leaves L, const float* __restrict__ step_size, const Coef c) {
  const int blk = blockIdx.x;
  int lo = 0, hi = L.count - 1;  // the leaf whose blocks hold blk
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (L.first_block[mid] <= blk) lo = mid; else hi = mid - 1;
  }
  const int leaf = lo;
  const long long n = L.n[leaf];
  const long long start = static_cast<long long>(blk - L.first_block[leaf]) * CHUNK;
  const long long end = start + CHUNK < n ? start + CHUNK : n;
  float* __restrict__ p = L.p[leaf];
  M* __restrict__ m = static_cast<M*>(L.m[leaf]);
  M* __restrict__ v = static_cast<M*>(L.v[leaf]);
  const float* __restrict__ g = L.g[leaf];
  const float s = *step_size;
  if (L.vec_ok[leaf]) {
    for (long long i = start + static_cast<long long>(threadIdx.x) * VEC; i < end;
         i += THREADS * VEC) {
      float pr[4], gr[4], mr[4], vr[4];
      load4(p, i, pr);
      load4(g, i, gr);
      load4(m, i, mr);
      load4(v, i, vr);
#pragma unroll
      for (int e = 0; e < 4; ++e) adam_elem(pr[e], gr[e], mr[e], vr[e], s, c);
      store4(p, i, pr);
      store4(m, i, mr);
      store4(v, i, vr);
    }
  } else {
    for (long long i = start + threadIdx.x; i < end; i += THREADS) {
      float pi = p[i], mi = load_m(m, i), vi = load_m(v, i);
      adam_elem(pi, g[i], mi, vi, s, c);
      p[i] = pi;
      store_m(m, i, mi);
      store_m(v, i, vi);
    }
  }
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// table: n_leaves rows of (p, m, v, g, size) as int64
template <typename M>
int launch(int n_leaves, const long long* table, const void* step_size, Coef c, void* stream) {
  if (n_leaves <= 0 || n_leaves > MAX_LEAVES) return static_cast<int>(cudaErrorInvalidValue);
  Leaves L;
  L.count = n_leaves;
  long long blocks = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const long long* row = table + 5 * i;
    L.p[i] = reinterpret_cast<float*>(row[0]);
    L.m[i] = reinterpret_cast<void*>(row[1]);
    L.v[i] = reinterpret_cast<void*>(row[2]);
    L.g[i] = reinterpret_cast<const float*>(row[3]);
    L.n[i] = row[4];
    if (L.n[i] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    L.first_block[i] = static_cast<int>(blocks);
    L.vec_ok[i] = L.n[i] % VEC == 0 && aligned(L.p[i], 16) && aligned(L.g[i], 16) &&
                  aligned(L.m[i], VEC * sizeof(M)) && aligned(L.v[i], VEC * sizeof(M));
    blocks += (L.n[i] + CHUNK - 1) / CHUNK;
  }
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  L.first_block[n_leaves] = static_cast<int>(blocks);
  adam_kernel<M><<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      L, static_cast<const float*>(step_size), c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gct2_adam_f32m(int n_leaves, const void* table, const void* step_size, float b1,
                              float b2, float omb1, float omb2, float eps, void* stream) {
  return launch<float>(n_leaves, static_cast<const long long*>(table), step_size,
                       Coef{b1, b2, omb1, omb2, eps}, stream);
}

extern "C" int gct2_adam_bf16m(int n_leaves, const void* table, const void* step_size, float b1,
                               float b2, float omb1, float omb2, float eps, void* stream) {
  return launch<__nv_bfloat16>(n_leaves, static_cast<const long long*>(table), step_size,
                               Coef{b1, b2, omb1, omb2, eps}, stream);
}
