// k4/s2 TF-SAME down conv + bias + ReLU for Hopper (sm_90a), NHWC in and out.
//
// Replaces gan_class_transfer2_tpu/ops/pallas_conv.py::_down_kernel (the
// Pallas TPU kernel of the U-Net's DownShuffle, reference train.py:158-169).
// It computes y = relu(conv_k4s2_SAME(x, K) + b) as an implicit GEMM:
//   M = B·(H/2)·(W/2) output pixels, N = O output channels, K = 16·C,
// where row m = (b, oh, ow) of A is the 4×4 window of x at (2·oh−1, 2·ow−1)
// and the weight is the HWIO kernel read as a (16·C, O) matrix, rows ordered
// (di, dj, c). The sum is float32 and y is rounded once to x's dtype. The SAME
// pad, (1, 1) for even inputs, is never written out: out-of-range taps are
// zero-filled as they are loaded (pallas_conv.py:87-88 writes a padded,
// phase-split copy of x instead).
//
// Bound on this card. FLOPs = 2·B·(H/2)·(W/2)·O·16·C; bytes = x + K + y, each
// once. At the four full-width shapes (128²×128→256, 64²×256→512,
// 32²×512→512, 16²×512→512) the FLOPs bound float32 (67 TFLOP/s without
// tensor cores) at any batch, and bfloat16 (989 TFLOP/s) at the first three;
// the 16²→8² layer in bfloat16 is bound by its 8.4 MB weight until B ≈ 16
// (chip_smoke.py computes the bound for each shape it runs). The two small-M
// layers give few output tiles: at batch 4 the 32²→16² and 16²→8² layers have
// M = 1024 and 256, so 128×128 tiles alone would put 32 and 8 blocks on the
// card's 132 SMs.
//
// What the design does about it:
//   * bfloat16 and float16 (one body, down_conv_16): warp-specialised wgmma.
//     Each 128×128 output tile is one block of two consumer warpgroups (64
//     rows each, wgmma.mma_async m64n128k16, float32 accumulators in
//     registers) and one producer warp, which keeps a ring of 4 stages of
//     64-deep K slices (128 bytes of a 16-bit type: one swizzle row) full by
//     TMA, with full/empty mbarriers. Both operands arrive 128-byte
//     swizzled, the layout the wgmma descriptors name.
//       - A by TMA: a 4-D tiled map over x (C, W, H, B) with element strides
//         (1, 2, 2, 1). A tile is a box of TW×TH×TB output pixels (TW·TH·TB =
//         128, chosen by the wrapper); the slice of tap (di, dj) and channels
//         c0..c0+63 is the box at (c0, 2·ow0−1+dj, 2·oh0−1+di, b0), and the
//         hardware's zero fill of out-of-range coordinates is the SAME pad.
//       - The weight by TMA, two boxes of 64 n × 64 k a stage, straight from
//         the (16·C, Opad) matrix: MN-major, which wgmma reads with its
//         transpose-B bit, so the wrapper copies no weight.
//   * float32: kept IEEE float32 (the JAX package runs float32 convs at
//     Precision.HIGHEST), so no tensor cores: 128×128 tiles of 256 threads,
//     8×8 outputs per thread in registers, 8-deep K slices staged by cp.async
//     in a ring of 4 stages (A row-major, read back as float4 along K, so no
//     transposing stores).
//   * Both: split-K for the small-M layers. The wrapper's plan picks `split`
//     from the shape alone so that tiles × split ≥ 132; block z sums the
//     K slices [z·per, (z+1)·per) (whole slices, so a slice never straddles
//     two taps) into a float32 workspace (split, M, Opad), and a second
//     launch sums the split partials in the fixed order z = 0, 1, ..., adds
//     the bias, applies ReLU and rounds once. No atomics: two calls give
//     bit-identical y. With split = 1 the epilogue writes y directly.
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for a shape, plan or
// tensor map it refuses).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

struct Shape {
  int B, H, W, C, O, Opad, H2, W2, M;
  int split, kps;  // K ranges, and K slices in each
  int TW, TH, TB;  // 16-bit types: the output box of one tile (TW·TH·TB = 128)
};

// Address of x[b, 2·oh−1+di, 2·ow−1+dj, c] for GEMM column k = (di·4+dj)·C + c,
// or nullptr where the tap falls in the SAME pad or the row is past M.
template <typename T>
__device__ __forceinline__ const T* tap_ptr(const T* x, const Shape& s, int b, int oh,
                                            int ow, bool ok, int k) {
  const int tap = k / s.C;
  const int c = k - tap * s.C;
  const int ih = 2 * oh - 1 + (tap >> 2);
  const int iw = 2 * ow - 1 + (tap & 3);
  if (!ok || ih < 0 || ih >= s.H || iw < 0 || iw >= s.W) return nullptr;
  return x + ((static_cast<size_t>(b) * s.H + ih) * s.W + iw) * s.C + c;
}

__device__ __forceinline__ void decode_row(const Shape& s, int m, int& b, int& oh, int& ow,
                                           bool& ok) {
  ok = m < s.M;
  const int mm = ok ? m : 0;
  ow = mm % s.W2;
  oh = (mm / s.W2) % s.H2;
  b = mm / (s.W2 * s.H2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const int src_bytes = valid ? 16 : 0;  // 0 source bytes: all 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }
// two neighbouring outputs, p 4-byte aligned
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// ------------------------------------------------------------------ float32

constexpr int F_BM = 128, F_BN = 128, F_BK = 8, F_THREADS = 256, F_STAGES = 4;

__global__ void __launch_bounds__(F_THREADS)
down_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y,
                     float* __restrict__ ws, Shape s, int relu) {
  __shared__ __align__(16) float As[F_STAGES][F_BM][F_BK];  // row-major, as x holds it
  __shared__ __align__(16) float Bs[F_STAGES][F_BK][F_BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * F_BM, n0 = blockIdx.y * F_BN;
  const int k_begin = blockIdx.z * s.kps;

  // loaders, one 16-byte cp.async each per slice: A — one output row, 4
  // consecutive channels; B — one k row, 4 columns
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const int b_k = tid >> 5, b_n = (tid & 31) * 4;
  int ab, aoh, aow;
  bool aok;
  decode_row(s, m0 + a_row, ab, aoh, aow, aok);
  auto issue = [&](int i, int buf) {
    const int k = (k_begin + i) * F_BK;
    const float* p = tap_ptr(x, s, ab, aoh, aow, aok, k + a_k);
    cp_async16(&As[buf][a_row][a_k], p ? p : x, p != nullptr);
    cp_async16(&Bs[buf][b_k][b_n], w + static_cast<size_t>(k + b_k) * s.Opad + n0 + b_n, true);
  };

  // thread (ty, tx) owns rows {ty·4+i, 64+ty·4+i} and columns {tx·4+j, 64+tx·4+j}
  const int tx = tid & 15, ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // ring of F_STAGES slices; one commit group per slice (empty past the end)
#pragma unroll
  for (int i = 0; i < F_STAGES - 1; ++i) {
    if (i < s.kps) issue(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < s.kps; ++i) {
    cp_async_wait<F_STAGES - 2>();  // slice i has landed (this thread's copies)
    __syncthreads();                // ... everyone's; and slice i−1's buffer is free
    if (i + F_STAGES - 1 < s.kps) issue(i + F_STAGES - 1, (i + F_STAGES - 1) % F_STAGES);
    cp_async_commit();
    const int cur = i % F_STAGES;
#pragma unroll
    for (int h = 0; h < F_BK; h += 4) {
      float a[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = r < 4 ? ty * 4 + r : 64 + ty * 4 + r - 4;
        const float4 v = *reinterpret_cast<const float4*>(&As[cur][row][h]);
        a[r][0] = v.x;
        a[r][1] = v.y;
        a[r][2] = v.z;
        a[r][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][h + q][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][h + q][64 + tx * 4]);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(a[r][q], b[j], acc[r][j]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= s.M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = n0 + half * 64 + tx * 4;
      if (s.split > 1) {  // this K range's partial sum, whole Opad columns
        float* part = ws + (static_cast<size_t>(blockIdx.z) * s.M + row) * s.Opad + col;
        *reinterpret_cast<float4*>(part) = make_float4(acc[i][half * 4], acc[i][half * 4 + 1],
                                                       acc[i][half * 4 + 2], acc[i][half * 4 + 3]);
        continue;
      }
      float* out = y + static_cast<size_t>(row) * s.O;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = acc[i][half * 4 + j] + bias[col + j];
        v[j] = relu ? fmaxf(t, 0.f) : t;
      }
      if ((s.O & 3) == 0 && col + 3 < s.O) {
        *reinterpret_cast<float4*>(out + col) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        for (int j = 0; j < 4; ++j)
          if (col + j < s.O) out[col + j] = v[j];
      }
    }
  }
}

// ------------------------------------------------- bfloat16 and float16

constexpr int H_BM = 128, H_BN = 128, H_BK = 64, H_STAGES = 4;
constexpr int H_CONSUMERS = 2;                         // warpgroups, 64 rows each
constexpr int H_THREADS = H_CONSUMERS * 128 + 32;      // + one producer warp
constexpr int H_TILE_BYTES = H_BM * H_BK * 2;          // 16 KB, = H_BN·H_BK·2
// the ring, its barriers, and slack to align the ring to 1024 bytes
constexpr int H_SMEM = 2 * H_STAGES * H_TILE_BYTES + 2 * H_STAGES * 8 + 1024;

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// returns once the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte rows, 128-byte
// swizzled (the TMA maps' CU_TENSOR_MAP_SWIZZLE_128B), layout type 1: start
// address, leading byte offset, stride byte offset 1024 B (between groups of
// 8 rows). A is K-major: a row is 64 k of one m, the leading offset is unused
// (16 B) and the k16 steps of a 64-deep slice advance the start by 32 B. The
// weight is MN-major: a row is 64 n of one k, the leading offset 8 KB steps
// to the next 64 n, and the k16 steps advance the start by 16 rows (2 KB).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// keeps the compiler from moving other writes of the accumulators into the
// asynchronous wgmma pipeline (which would serialise it)
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64×128 float32, 64 registers a thread) += A (64×16, K-major) · B (16×128,
// MN-major: the transpose-B bit); AB the operands' type, "bf16" or "f16"
#define GCT2_WGMMA_M64N128K16(AB)                                                          \
  asm volatile(                                                                            \
      "{\n"                                                                                \
      ".reg .pred p;\n"                                                                    \
      "setp.ne.b32 p, %66, 0;\n" /* scale-d: accumulate into d */                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " "                         \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "   \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
      "%64, %65, p, 1, 1, 0, 1;\n"                                                         \
      "}\n"                                                                                \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),            \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),          \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),                   \
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),                   \
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),                   \
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                   \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),                   \
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),                   \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),                   \
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                   \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),                   \
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),                   \
        "+f"(d[62]), "+f"(d[63])                                                           \
      : "l"(da), "l"(db), "n"(1))

template <typename T>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (std::is_same_v<T, __half>)
    GCT2_WGMMA_M64N128K16("f16");
  else
    GCT2_WGMMA_M64N128K16("bf16");
}

// the body of the 16-bit kernels, T __nv_bfloat16 or __half; the tensor maps
// are the kernel's __grid_constant__ parameters
template <typename T>
__device__ __forceinline__ void down_conv_16(const CUtensorMap* tm_x, const CUtensorMap* tm_w,
                                             const T* __restrict__ bias, T* __restrict__ y,
                                             float* __restrict__ ws, const Shape& s, int relu) {
  extern __shared__ uint8_t smem_raw[];
  // the 128B swizzle pattern repeats every 1024 bytes: align the ring to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sA = smem;                                // [stage][128 rows][128 B]
  uint8_t* sB = smem + H_STAGES * H_TILE_BYTES;      // [stage][2 halves of N][64 k][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * H_STAGES * H_TILE_BYTES);
  uint64_t* empty = full + H_STAGES;

  const int tiles_w = (s.W2 + s.TW - 1) / s.TW, tiles_h = (s.H2 + s.TH - 1) / s.TH;
  const int ow0 = (blockIdx.x % tiles_w) * s.TW;
  const int oh0 = (blockIdx.x / tiles_w % tiles_h) * s.TH;
  const int b0 = blockIdx.x / (tiles_w * tiles_h) * s.TB;
  const int n0 = blockIdx.y * H_BN;
  const int k_begin = blockIdx.z * s.kps;

  if (threadIdx.x == 0) {
    for (int i = 0; i < H_STAGES; ++i) {
      mbar_init(&full[i], 1);                    // the producer's expect_tx
      mbar_init(&empty[i], H_CONSUMERS * 4);     // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= H_CONSUMERS * 128) {
    // ---- producer warp: one thread keeps the ring full by TMA
    if (threadIdx.x == H_CONSUMERS * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < s.kps; ++i) {
        mbar_wait(&empty[stage], phase ^ 1);  // passes at once on the first lap
        const int k = (k_begin + i) * H_BK;
        const int tap = k / s.C, c0 = k - tap * s.C;
        mbar_expect_tx(&full[stage], 2 * H_TILE_BYTES);
        tma_load_4d(sA + stage * H_TILE_BYTES, tm_x, &full[stage], c0,
                    2 * ow0 - 1 + (tap & 3), 2 * oh0 - 1 + (tap >> 2), b0);
        tma_load_2d(sB + stage * H_TILE_BYTES, tm_w, &full[stage], n0, k);
        tma_load_2d(sB + stage * H_TILE_BYTES + H_TILE_BYTES / 2, tm_w, &full[stage], n0 + 64,
                    k);
        if (++stage == H_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: rows wg·64 .. wg·64+63 of the tile
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_operands(acc);
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int i = 0; i < s.kps; ++i) {
    mbar_wait(&full[stage], phase);
    const uint8_t* a = sA + stage * H_TILE_BYTES + wg * 64 * 128;
    const uint8_t* b = sB + stage * H_TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < H_BK / 16; ++kk)
      wgmma_m64n128k16<T>(acc, smem_desc(a + kk * 32, 16),
                       smem_desc(b + kk * 16 * 128, H_TILE_BYTES / 2));
    wgmma_commit();
    wgmma_wait<1>();  // the previous slice's products are done: free its stage
    if (i > 0 && (t & 31) == 0) mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == H_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // epilogue: register i holds row (t/32)·16 + (t%32)/4 + 8·((i/2)%2) of this
  // warpgroup's 64, column 8·(i/4) + 2·(t%4) + i%2 of the tile
  const int lane = t & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wg * 64 + (t >> 5) * 16 + (lane >> 2) + 8 * half;  // row in the tile
    const int ow = ow0 + r % s.TW, oh = oh0 + r / s.TW % s.TH, bb = b0 + r / (s.TW * s.TH);
    if (ow >= s.W2 || oh >= s.H2 || bb >= s.B) continue;
    const int m = (bb * s.H2 + oh) * s.W2 + ow;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (s.split > 1) {
        float* part = ws + (static_cast<size_t>(blockIdx.z) * s.M + m) * s.Opad + col;
        *reinterpret_cast<float2*>(part) = make_float2(v0, v1);
        continue;
      }
      if (col >= s.O) continue;
      float t0 = v0 + to_float(bias[col]);
      float t1 = col + 1 < s.O ? v1 + to_float(bias[col + 1]) : 0.f;
      if (relu) {
        t0 = fmaxf(t0, 0.f);
        t1 = fmaxf(t1, 0.f);
      }
      T* out = y + static_cast<size_t>(m) * s.O + col;
      if ((s.O & 1) == 0) {
        store2(out, t0, t1);
      } else {
        store(out, t0);
        if (col + 1 < s.O) store(out + 1, t1);
      }
    }
  }
}

__global__ void __launch_bounds__(H_THREADS, 1)
down_conv_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w,
                      const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                      float* __restrict__ ws, Shape s, int relu) {
  down_conv_16(&tm_x, &tm_w, bias, y, ws, s, relu);
}

__global__ void __launch_bounds__(H_THREADS, 1)
down_conv_f16_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w, const __half* __restrict__ bias,
                     __half* __restrict__ y, float* __restrict__ ws, Shape s, int relu) {
  down_conv_16(&tm_x, &tm_w, bias, y, ws, s, relu);
}

// ------------------------------------------------- split-K: the fixed-order sum

template <typename T>
__global__ void __launch_bounds__(256)
split_reduce_kernel(const float* __restrict__ ws, const T* __restrict__ bias, T* __restrict__ y,
                    Shape s, int relu) {
  const size_t n = static_cast<size_t>(s.M) * s.O;
  const size_t plane = static_cast<size_t>(s.M) * s.Opad;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t m = i / s.O;
    const int col = static_cast<int>(i - m * s.O);
    const float* p = ws + m * s.Opad + col;
    float acc = p[0];
    for (int z = 1; z < s.split; ++z) acc += p[z * plane];  // z = 0, 1, ...: fixed order
    const float t = acc + to_float(bias[col]);
    store(y + i, relu ? fmaxf(t, 0.f) : t);
  }
}

template <typename T>
int launch_reduce(float* ws, const void* bias, void* y, const Shape& s, int relu,
                  cudaStream_t stream) {
  const size_t n = static_cast<size_t>(s.M) * s.O;
  const int blocks = static_cast<int>((n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16);
  split_reduce_kernel<T><<<blocks, 256, 0, stream>>>(ws, static_cast<const T*>(bias),
                                                     static_cast<T*>(y), s, relu);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, fetched once through the runtime,
// so that the library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

Shape make_shape(int B, int H, int W, int C, int O, int Opad, int split, int TW, int TH,
                 int TB, int bk) {
  const int H2 = H / 2, W2 = W / 2;
  const int slices = bk > 0 ? 16 * C / bk : 0;
  return Shape{B, H, W, C, O, Opad, H2, W2, B * H2 * W2,
               split, split > 0 ? slices / split : 0, TW, TH, TB};
}

// what every path needs: even H and W, C a multiple of the K slice (so a
// slice never straddles two taps), O ≤ Opad, Opad a multiple of 128, and a
// split that divides the K slices, with a workspace when it is above 1
bool shape_ok(const Shape& s, int bk, const void* ws) {
  return s.B > 0 && s.H >= 2 && s.W >= 2 && s.H % 2 == 0 && s.W % 2 == 0 && s.C > 0 &&
         s.C % bk == 0 && s.O > 0 && s.O <= s.Opad && s.Opad % 128 == 0 && s.split >= 1 &&
         (16 * s.C / bk) % s.split == 0 && (s.split == 1 || ws != nullptr);
}

// the 16-bit entry points: T's kernel, whose tensor maps hold elements of type DT
template <typename T, CUtensorMapDataType DT, typename Kernel>
int launch_16(Kernel kernel, const void* x, const void* w, const void* b, void* y, void* ws,
              int B, int H, int W, int C, int O, int Opad, int relu, int split, int tw, int th,
              int tb, void* stream) {
  const Shape s = make_shape(B, H, W, C, O, Opad, split, tw, th, tb, H_BK);
  if (!shape_ok(s, H_BK, ws) || tw < 1 || th < 1 || tb < 1 || tw * th * tb != H_BM ||
      2 * tw > 256 || 2 * th > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorInvalidValue);

  // x as a (C, W, H, B) tensor; a box of 64 channels × TW × TH × TB pixels,
  // every second pixel along W and H: the stride-2 window of one tap
  CUtensorMap tm_x, tm_w;
  const cuuint64_t x_dim[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                               static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t x_stride[3] = {static_cast<cuuint64_t>(C) * 2,
                                  static_cast<cuuint64_t>(W) * C * 2,
                                  static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t x_box[4] = {H_BK, static_cast<cuuint32_t>(2 * tw),
                               static_cast<cuuint32_t>(2 * th), static_cast<cuuint32_t>(tb)};
  const cuuint32_t x_step[4] = {1, 2, 2, 1};
  CUresult r = encode(&tm_x, DT, 4, const_cast<void*>(x), x_dim, x_stride, x_box, x_step,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  // the (16·C, Opad) weight, row-major: boxes of 64 n × 64 k, two per stage
  const cuuint64_t w_dim[2] = {static_cast<cuuint64_t>(Opad), static_cast<cuuint64_t>(16) * C};
  const cuuint64_t w_stride[1] = {static_cast<cuuint64_t>(Opad) * 2};
  const cuuint32_t w_box[2] = {64, H_BK};
  const cuuint32_t w_step[2] = {1, 1};
  r = encode(&tm_w, DT, 2, const_cast<void*>(w), w_dim, w_stride, w_box, w_step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);

  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, H_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const int tiles_m = ((s.W2 + tw - 1) / tw) * ((s.H2 + th - 1) / th) * ((B + tb - 1) / tb);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles_m, s.Opad / H_BN, s.split);
  kernel<<<grid, H_THREADS, H_SMEM, st>>>(tm_x, tm_w, static_cast<const T*>(b),
                                          static_cast<T*>(y), static_cast<float*>(ws), s, relu);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || s.split == 1) return err;
  return launch_reduce<T>(static_cast<float*>(ws), b, y, s, relu, st);
}

}  // namespace

// x (B, H, W, C), y (B, H/2, W/2, O): NHWC, contiguous; w the (16·C, Opad)
// weight, row-major. float32: tw, th and tb must be 0 (tiles are 128
// consecutive output pixels); bfloat16 and float16: (tw, th, tb) is the output
// box of one tile. ws: split × M × Opad float32, or null when split is 1.
extern "C" int gct2_down_conv_f32(const void* x, const void* w, const void* b, void* y,
                                  void* ws, int B, int H, int W, int C, int O, int Opad,
                                  int relu, int split, int tw, int th, int tb, void* stream) {
  const Shape s = make_shape(B, H, W, C, O, Opad, split, 0, 0, 0, F_BK);
  if (!shape_ok(s, F_BK, ws) || tw != 0 || th != 0 || tb != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((s.M + F_BM - 1) / F_BM, s.Opad / F_BN, s.split);
  down_conv_f32_kernel<<<grid, F_THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(y), static_cast<float*>(ws), s, relu);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || s.split == 1) return err;
  return launch_reduce<float>(static_cast<float*>(ws), b, y, s, relu, st);
}

extern "C" int gct2_down_conv_bf16(const void* x, const void* w, const void* b, void* y,
                                   void* ws, int B, int H, int W, int C, int O, int Opad,
                                   int relu, int split, int tw, int th, int tb, void* stream) {
  return launch_16<__nv_bfloat16, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16>(
      down_conv_bf16_kernel, x, w, b, y, ws, B, H, W, C, O, Opad, relu, split, tw, th, tb,
      stream);
}

extern "C" int gct2_down_conv_f16(const void* x, const void* w, const void* b, void* y,
                                  void* ws, int B, int H, int W, int C, int O, int Opad,
                                  int relu, int split, int tw, int th, int tb, void* stream) {
  return launch_16<__half, CU_TENSOR_MAP_DATA_TYPE_FLOAT16>(
      down_conv_f16_kernel, x, w, b, y, ws, B, H, W, C, O, Opad, relu, split, tw, th, tb,
      stream);
}
