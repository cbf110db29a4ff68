// The U-Net's conv epilogue for Hopper (sm_90a), NHWC in and out.
//
// Replaces no Pallas kernel: the JAX package leaves a conv's bias, ReLU and
// the sum of a concat pair's two convs (models/unet.py, _pair_up_conv and
// _pair_block_conv) to XLA, which fuses them into the conv. On the card
// cuDNN's convs end at the conv, and the tail ran as ATen passes: a broadcast
// bias add (never contiguous, so ATen's non-vectorised kernel), the pair's
// sum and the ReLU forward; ReLU's threshold_backward and a bias-gradient
// reduction backward (B4's backward: a compare, a where, an fp32 copy and a
// sum). This source holds that tail as one pass each way.
//
//   forward   out = act(y [+ other] [+ bias])     (act: ReLU or none)
//   backward  gs  = g · [out > 0] (or g itself without ReLU), written NHWC;
//             db  = Σ_{B,H,W} gs per channel, summed in float32 and written in
//                   float32 or rounded once to T (the bias's dtype).
//   T: float32, bfloat16 or float16 (an entry point each way for each).
//
// Bound on this card: bytes. Per element the forward reads y (and other) and
// writes out, 3 or 4 bytes of bf16 a term against ~3 float ops; the backward
// reads g and out and writes gs. At the train cell's up0 (256 × 256² × 64,
// bf16) a pair's forward moves 6.4 GB, 1.9 ms at 3.35 TB/s.
//
// Design:
//   * a thread owns one 16-byte vector of channels (8 bf16 or f16, 4 float32) and
//     walks pixels; the bias is loaded once into registers, the sum is float32
//     and rounded once to T. A block is TX lanes along the channel vectors by
//     256 / TX pixel rows (TX the least power of 2 ≥ C / VEC, at most 32), so
//     a warp reads whole 512-byte runs; grid.y covers channel vectors past TX.
//     UNROLL pixels a thread are loaded before any is used.
//   * C % VEC ≠ 0 or a misaligned pointer takes the same kernel with VEC = 1
//     (scalar loads): any C works.
//   * the backward's bias gradient needs a sum across blocks. No float
//     atomics: each block adds its rows in a fixed order into one float32 row
//     of partial sums per block, and a second small launch adds those rows in
//     a fixed order per channel. The plan depends on the shape alone, so two
//     runs give the same bits.
//   * float32: the forward adds in the torch composition's order
//     (other + (y + bias)), so it equals the plain version bit for bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // pixels a thread loads before it uses any

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ void from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void from_float(__half* p, float v) { *p = __float2half_rn(v); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// the block's place: lane tx along channel vectors, row ty along pixels;
// cv the thread's channel vector (inactive where cv·V ≥ C)
struct Place {
  int tx, ty, rows, cv;
  __device__ Place(int TX) {
    tx = threadIdx.x % TX;
    ty = threadIdx.x / TX;
    rows = THREADS / TX;
    cv = blockIdx.y * TX + tx;
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
epilogue_fwd_kernel(const T* __restrict__ y, const T* __restrict__ other,
                    const T* __restrict__ bias, T* __restrict__ out, long long P, int C, int TX,
                    int relu) {
  using W = Vec<T, V>;
  const Place at(TX);
  const int c = at.cv * V;
  if (c >= C) return;
  float b[V];
#pragma unroll
  for (int v = 0; v < V; ++v) b[v] = bias != nullptr ? to_float(bias[c + v]) : 0.f;
  const long long span = static_cast<long long>(at.rows) * UNROLL;
  for (long long base = blockIdx.x * span; base < P; base += gridDim.x * span) {
    W ry[UNROLL], ro[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long p = base + u * at.rows + at.ty;
      if (p < P) {
        const size_t i = static_cast<size_t>(p) * C + c;
        ry[u] = *reinterpret_cast<const W*>(y + i);
        if (other != nullptr) ro[u] = *reinterpret_cast<const W*>(other + i);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long p = base + u * at.rows + at.ty;
      if (p >= P) continue;
      W o;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float s = __fadd_rn(to_float(ry[u].v[v]), b[v]);
        if (other != nullptr) s = __fadd_rn(to_float(ro[u].v[v]), s);
        if (relu && s < 0.f) s = 0.f;
        from_float(&o.v[v], s);
      }
      *reinterpret_cast<W*>(out + static_cast<size_t>(p) * C + c) = o;
    }
  }
}

// gs = g·[out > 0] (threshold_backward's mask: 0 where out ≤ 0) where gs is
// not null; the block's float32 sums of gs per channel into parts[blockIdx.x,
// C] where parts is not null
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
epilogue_bwd_kernel(const T* __restrict__ g, const T* __restrict__ out, T* __restrict__ gs,
                    float* __restrict__ parts, long long P, int C, int TX) {
  using W = Vec<T, V>;
  __shared__ float sh[THREADS][V];
  const Place at(TX);
  const int c = at.cv * V;
  const bool live = c < C;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  const long long span = static_cast<long long>(at.rows) * UNROLL;
  for (long long base = blockIdx.x * span; live && base < P; base += gridDim.x * span) {
    W rg[UNROLL], ro[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long p = base + u * at.rows + at.ty;
      if (p < P) {
        const size_t i = static_cast<size_t>(p) * C + c;
        rg[u] = *reinterpret_cast<const W*>(g + i);
        if (out != nullptr) ro[u] = *reinterpret_cast<const W*>(out + i);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long p = base + u * at.rows + at.ty;
      if (p >= P) continue;
      W m;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        m.v[v] = rg[u].v[v];
        if (out != nullptr && to_float(ro[u].v[v]) <= 0.f) from_float(&m.v[v], 0.f);
        acc[v] = __fadd_rn(acc[v], to_float(m.v[v]));
      }
      if (gs != nullptr) *reinterpret_cast<W*>(gs + static_cast<size_t>(p) * C + c) = m;
    }
  }
  if (parts == nullptr) return;
#pragma unroll
  for (int v = 0; v < V; ++v) sh[threadIdx.x][v] = acc[v];
  __syncthreads();
  // a thread a channel of the block's TX·V: its rows in row order
  const int k = threadIdx.x;
  if (k < TX * V) {
    const int lane = k / V, v = k % V;
    const int ch = (blockIdx.y * TX + lane) * V + v;
    if (ch < C) {
      float s = sh[lane][v];
      for (int r = 1; r < at.rows; ++r) s = __fadd_rn(s, sh[r * TX + lane][v]);
      parts[static_cast<size_t>(blockIdx.x) * C + ch] = s;
    }
  }
}

// db[c] = Σ_r parts[r, c] over the G rows, in a fixed order: 32 lanes along
// channels by 32 strided runs of rows, the runs added in run order; D float
// or T
template <typename D>
__global__ void __launch_bounds__(1024)
epilogue_db_kernel(const float* __restrict__ parts, D* __restrict__ db, int G, int C) {
  __shared__ float sh[32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + tx;
  float s = 0.f;
  if (c < C)
    for (int r = ty; r < G; r += 32) s = __fadd_rn(s, parts[static_cast<size_t>(r) * C + c]);
  sh[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < C) {
    float t = sh[0][tx];
    for (int k = 1; k < 32; ++k) t = __fadd_rn(t, sh[k][tx]);
    from_float(&db[c], t);
  }
}

template <typename T>
int launch_fwd(const void* y, const void* other, const void* bias, void* out, long long P, int C,
               int vec, int TX, int grid_x, int relu, void* stream) {
  const int V = vec;
  if (P <= 0 || C <= 0 || C % V || TX <= 0 || THREADS % TX || grid_x <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_x, (C / V + TX - 1) / TX);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* yt = static_cast<const T*>(y);
  const T* ot = static_cast<const T*>(other);
  const T* bt = static_cast<const T*>(bias);
  T* o = static_cast<T*>(out);
  constexpr int VEC = 16 / sizeof(T);
  if (V == VEC) {
    epilogue_fwd_kernel<T, VEC><<<grid, THREADS, 0, s>>>(yt, ot, bt, o, P, C, TX, relu);
  } else if (V == 1) {
    epilogue_fwd_kernel<T, 1><<<grid, THREADS, 0, s>>>(yt, ot, bt, o, P, C, TX, relu);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* g, const void* out, void* gs, void* parts, void* db, long long P,
               int C, int vec, int TX, int grid_x, int db_f32, void* stream) {
  const int V = vec;
  if (P <= 0 || C <= 0 || C % V || TX <= 0 || THREADS % TX || grid_x <= 0 ||
      (parts == nullptr) != (db == nullptr) || (gs == nullptr && parts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_x, (C / V + TX - 1) / TX);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* gt = static_cast<const T*>(g);
  const T* ot = static_cast<const T*>(out);
  T* gst = static_cast<T*>(gs);
  float* pt = static_cast<float*>(parts);
  constexpr int VEC = 16 / sizeof(T);
  if (V == VEC) {
    epilogue_bwd_kernel<T, VEC><<<grid, THREADS, 0, s>>>(gt, ot, gst, pt, P, C, TX);
  } else if (V == 1) {
    epilogue_bwd_kernel<T, 1><<<grid, THREADS, 0, s>>>(gt, ot, gst, pt, P, C, TX);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || parts == nullptr) return static_cast<int>(e);
  const int blocks = (C + 31) / 32;
  if (db_f32)
    epilogue_db_kernel<float><<<blocks, 1024, 0, s>>>(pt, static_cast<float*>(db), grid_x, C);
  else
    epilogue_db_kernel<T><<<blocks, 1024, 0, s>>>(pt, static_cast<T*>(db), grid_x, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward. y, other, out: (P, C) contiguous in T (P = B·H·W pixels); other
// and bias (C,) in T may be null; (vec, TX, grid_x) is ops/conv_epilogue.plan's
// (vec 1, or 16 bytes of T where C allows it and every pointer is 16-byte
// aligned).
extern "C" int gct2_epilogue_fwd_f32(const void* y, const void* other, const void* bias,
                                     void* out, long long P, int C, int vec, int TX, int grid_x,
                                     int relu, void* stream) {
  return launch_fwd<float>(y, other, bias, out, P, C, vec, TX, grid_x, relu, stream);
}

extern "C" int gct2_epilogue_fwd_bf16(const void* y, const void* other, const void* bias,
                                      void* out, long long P, int C, int vec, int TX, int grid_x,
                                      int relu, void* stream) {
  return launch_fwd<__nv_bfloat16>(y, other, bias, out, P, C, vec, TX, grid_x, relu, stream);
}

extern "C" int gct2_epilogue_fwd_f16(const void* y, const void* other, const void* bias,
                                     void* out, long long P, int C, int vec, int TX, int grid_x,
                                     int relu, void* stream) {
  return launch_fwd<__half>(y, other, bias, out, P, C, vec, TX, grid_x, relu, stream);
}

// Backward. g, out, gs: (P, C) contiguous in T; out null without ReLU (the
// mask is then all ones); gs null where no input but the bias needs a
// gradient; parts float32 (grid_x, C) scratch and db (C,), float32 where
// db_f32 is set and T otherwise, both null where the bias needs none (one
// launch instead of two).
extern "C" int gct2_epilogue_bwd_f32(const void* g, const void* out, void* gs, void* parts,
                                     void* db, long long P, int C, int vec, int TX, int grid_x,
                                     int db_f32, void* stream) {
  return launch_bwd<float>(g, out, gs, parts, db, P, C, vec, TX, grid_x, db_f32, stream);
}

extern "C" int gct2_epilogue_bwd_bf16(const void* g, const void* out, void* gs, void* parts,
                                      void* db, long long P, int C, int vec, int TX, int grid_x,
                                      int db_f32, void* stream) {
  return launch_bwd<__nv_bfloat16>(g, out, gs, parts, db, P, C, vec, TX, grid_x, db_f32,
                                   stream);
}

extern "C" int gct2_epilogue_bwd_f16(const void* g, const void* out, void* gs, void* parts,
                                     void* db, long long P, int C, int vec, int TX, int grid_x,
                                     int db_f32, void* stream) {
  return launch_bwd<__half>(g, out, gs, parts, db, P, C, vec, TX, grid_x, db_f32, stream);
}
