// k4/s2 TF-SAME down conv + bias + ReLU for Hopper (sm_90a), NHWC in and out.
//
// Replaces gan_class_transfer2_tpu/ops/pallas_conv.py::_down_kernel (the
// Pallas TPU kernel of the U-Net's DownShuffle, reference train.py:158-169).
// It computes y = relu(conv_k4s2_SAME(x, K) + b) as an implicit GEMM:
//   M = B·(H/2)·(W/2) output pixels, N = O output channels, K = 16·C,
// where row m = (b, oh, ow) of A is the 4×4 window of x at (2·oh−1, 2·ow−1)
// and B is the HWIO kernel read as a (16·C, O) matrix, rows ordered
// (di, dj, c). The wrapper (ops/fused_down_conv.py) casts the weight to x's
// dtype and zero-pads O to a multiple of 128 on every call, as the Pallas
// wrapper repacks its weight per call (pallas_conv.py:89); nothing else is
// copied: the SAME pad, (1, 1) for even inputs, is handled by zero-filling
// out-of-range taps as they are loaded, so no padded or phase-split copy of x
// is ever written (pallas_conv.py:87-88 writes one).
//
// Bound on this card. FLOPs = 2·B·(H/2)·(W/2)·O·16·C; bytes = x + K + y, each
// once. At the four full-width shapes (128²×128→256, 64²×256→512,
// 32²×512→512, 16²×512→512) the FLOPs bound it in float32 (67 TFLOP/s
// without tensor cores) at any batch, and in bfloat16 (989 TFLOP/s) at the
// first three; the 16²→8² layer in bfloat16 is bound by its 8.4 MB weight
// until B ≈ 16 (chip_smoke.py computes the bound for each shape it runs).
//
// What the design does about it:
//   * bfloat16: 128×128 output tiles per block of 8 warps, each warp a 64×32
//     tile of 16×16×16 tensor-core products (WMMA, mma.sync underneath) with
//     float32 accumulators in registers; K slices of 32 staged through shared
//     memory by cp.async in two buffers, so the next slice loads while this
//     one multiplies; out-of-range taps and rows are zero-filled by cp.async.
//   * float32: kept in IEEE float32 (the JAX package runs float32 convs at
//     Precision.HIGHEST), so no TF32 tensor cores: 128×128 tiles, 8×8 outputs
//     per thread in registers, K slices of 8 double-buffered in shared memory
//     with the next slice prefetched into registers.
//   * Both: every A and B element enters shared memory once per tile, the
//     epilogue adds the bias and applies ReLU on the float32 sum and writes y
//     once. Later work: wgmma/TMA for bfloat16, split-K for the small-M layers.
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

struct Shape {
  int B, H, W, C, O, Opad, H2, W2, M;
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

// ------------------------------------------------------------------ float32

constexpr int F_BM = 128, F_BN = 128, F_BK = 8, F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS)
down_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y, Shape s,
                     int relu) {
  __shared__ __align__(16) float As[2][F_BK][F_BM];  // A tile, k-major
  __shared__ __align__(16) float Bs[2][F_BK][F_BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * F_BM, n0 = blockIdx.y * F_BN;

  // loaders: A — one output row, 4 consecutive channels; B — one k row, 4 columns
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const int b_k = tid >> 5, b_n = (tid & 31) * 4;
  int ab, aoh, aow;
  bool aok;
  decode_row(s, m0 + a_row, ab, aoh, aow, aok);

  const int num_k = 16 * s.C / F_BK;
  float4 a_reg, b_reg;
  auto fetch = [&](int kt) {
    const float* p = tap_ptr(x, s, ab, aoh, aow, aok, kt * F_BK + a_k);
    a_reg = p ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
    b_reg = *reinterpret_cast<const float4*>(
        w + static_cast<size_t>(kt * F_BK + b_k) * s.Opad + n0 + b_n);
  };
  auto stash = [&](int buf) {
    As[buf][a_k + 0][a_row] = a_reg.x;
    As[buf][a_k + 1][a_row] = a_reg.y;
    As[buf][a_k + 2][a_row] = a_reg.z;
    As[buf][a_k + 3][a_row] = a_reg.w;
    *reinterpret_cast<float4*>(&Bs[buf][b_k][b_n]) = b_reg;
  };

  // thread (ty, tx) owns rows {ty·4+i, 64+ty·4+i} and columns {tx·4+j, 64+tx·4+j}
  const int tx = tid & 15, ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < num_k; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < num_k) fetch(kt + 1);
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < num_k) stash(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= s.M) continue;
    float* out = y + static_cast<size_t>(row) * s.O;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = n0 + half * 64 + tx * 4;
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

// ----------------------------------------------------------------- bfloat16

constexpr int H_BM = 128, H_BN = 128, H_BK = 32, H_THREADS = 256;
constexpr int A_LD = H_BK + 8;  // row pitches in elements: multiples of 8 (WMMA),
constexpr int B_LD = H_BN + 8;  // padded against shared-memory bank conflicts

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0 source bytes: all 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(H_THREADS)
down_conv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const __nv_bfloat16* __restrict__ bias,
                      __nv_bfloat16* __restrict__ y, Shape s, int relu) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[2][H_BM][A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][H_BK][B_LD];
  __shared__ __align__(128) float stage[H_THREADS / 32][16 * 16];  // epilogue
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * H_BM, n0 = blockIdx.y * H_BN;

  // loaders, 16 bytes per copy: A — rows a_r and a_r+64, 8 channels at a_kc;
  // B — k rows b_kr and b_kr+16, 8 columns at b_nc
  const int a_r = tid >> 2, a_kc = (tid & 3) * 8;
  const int b_kr = tid >> 4, b_nc = (tid & 15) * 8;
  int ab[2], aoh[2], aow[2];
  bool aok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) decode_row(s, m0 + a_r + h * 64, ab[h], aoh[h], aow[h], aok[h]);

  auto issue = [&](int kt, int buf) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat16* p = tap_ptr(x, s, ab[h], aoh[h], aow[h], aok[h], kt * H_BK + a_kc);
      cp_async16(&As[buf][a_r + h * 64][a_kc], p ? p : x, p != nullptr);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = kt * H_BK + b_kr + h * 16;
      cp_async16(&Bs[buf][b_kr + h * 16][b_nc], w + static_cast<size_t>(k) * s.Opad + n0 + b_nc,
                 true);
    }
    cp_async_commit();
  };

  const int wm = warp >> 2, wn = warp & 3;  // this warp's 64×32 tile
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int num_k = 16 * s.C / H_BK;
  issue(0, 0);
  for (int kt = 0; kt < num_k; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < num_k) {
      issue(kt + 1, cur ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < H_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], &As[cur][wm * 64 + i * 16][kk], A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[cur][kk][wn * 32 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's copies overwrite this buffer
  }

  // epilogue: each 16×16 accumulator goes through this warp's staging tile;
  // lane → row lane/2, 8 columns at (lane%2)·8
  float* st = stage[warp];
  const int r = lane >> 1, c8 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm * 64 + i * 16 + r;
      const int col = n0 + wn * 32 + j * 16 + c8;
      if (row < s.M) {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float t = st[r * 16 + c8 + e] + __bfloat162float(bias[col + e]);
          v[e] = __float2bfloat16(relu ? fmaxf(t, 0.f) : t);
        }
        __nv_bfloat16* out = y + static_cast<size_t>(row) * s.O + col;
        if ((s.O & 7) == 0 && col + 7 < s.O) {
          *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(v);
        } else {
          for (int e = 0; e < 8; ++e)
            if (col + e < s.O) out[e] = v[e];
        }
      }
      __syncwarp();
    }
  }
}

Shape make_shape(int B, int H, int W, int C, int O, int Opad) {
  const int H2 = H / 2, W2 = W / 2;
  return Shape{B, H, W, C, O, Opad, H2, W2, B * H2 * W2};
}

// the tilings above need: even H and W, C a multiple of the 32-wide K slice
// (so a slice never straddles two taps), O ≤ Opad, Opad a multiple of 128
bool shape_ok(const Shape& s) {
  return s.B > 0 && s.H >= 2 && s.W >= 2 && s.H % 2 == 0 && s.W % 2 == 0 && s.C > 0 &&
         s.C % 32 == 0 && s.O > 0 && s.O <= s.Opad && s.Opad % 128 == 0;
}

}  // namespace

extern "C" int gct2_down_conv_f32(const void* x, const void* w, const void* b, void* y, int B,
                                  int H, int W, int C, int O, int Opad, int relu,
                                  void* stream) {
  const Shape s = make_shape(B, H, W, C, O, Opad);
  if (!shape_ok(s)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((s.M + F_BM - 1) / F_BM, s.Opad / F_BN);
  down_conv_f32_kernel<<<grid, F_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(y), s, relu);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gct2_down_conv_bf16(const void* x, const void* w, const void* b, void* y, int B,
                                   int H, int W, int C, int O, int Opad, int relu,
                                   void* stream) {
  const Shape s = make_shape(B, H, W, C, O, Opad);
  if (!shape_ok(s)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((s.M + H_BM - 1) / H_BM, s.Opad / H_BN);
  down_conv_bf16_kernel<<<grid, H_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y), s, relu);
  return static_cast<int>(cudaGetLastError());
}
