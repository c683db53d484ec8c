// Weight-streaming matmul for decode-shaped activations, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
//   paddle_tpu/ops/pallas/decode_matmul.py:decode_matmul (kernel body
//   _make_kernel).
// What it computes: out[b, N] = x[b, K] @ W for b <= 32 rows, with W
// dense [K, N] (the activation's dtype), int8 [K, N] with a float32
// per-output-channel scale [N], or int4 in the HALVES layout: packed
// [K/2, N] int8 whose row r holds in-row r in the low nibble and in-row
// r + K/2 in the high nibble, both sign-extended. Sums are float32 and
// the scale is applied once, at the end, as _make_kernel does.
//
// What bounds it on an H100: at b <= 8, bytes — the weight is read once
// and every weight byte feeds 2 * b (int8) or 4 * b (int4) flops. At
// b = 32 the float32 CUDA-core arithmetic this simple form uses (67
// TFLOP/s) binds before the 3.35 TB/s of device memory does; only the
// tensor cores would lift that.
//
// Design (the simple form; wgmma and TMA are later work):
// - a grid of (128-column tiles) x (K-splits); each block has 256
//   threads; lane l of every warp owns columns 4l..4l+3 and reads them
//   with one 4-byte load per packed row (int8/int4; 8 or 16 bytes for
//   dense), so a warp reads a 128-byte coalesced segment of one weight
//   row;
// - the 8 warps split the block's rows: warp w takes rows w, w + 8, ...,
//   eight loads in flight per thread before their multiply-adds;
// - the K-split exists to fill the card: the 8B projections with
//   N = 4096 have only 32 column tiles for 132 SMs, so the wrapper picks
//   enough splits for about four blocks per SM; each split writes
//   float32 partial sums to a workspace and a second, tiny kernel adds
//   the splits in order, applies the scale once and casts;
// - the activation rows are staged in shared memory in K-tiles (x for
//   the 8B down projection at b = 32 is 917 KB, far above a block's
//   227 KB), rows past b as zeros; for int4 the tile of in-rows r and
//   the tile of in-rows r + K/2 are staged side by side;
// - int4 unpacks as lo = ((w & 15) ^ 8) - 8 and hi = w >> 4 (arithmetic
//   shift of the signed byte);
// - the 8 per-warp partial sums are added in a fixed warp order in
//   shared memory, so results do not depend on scheduling;
// - the row count is a template parameter (1, 2, 4, 8, 16 or 32, the
//   next at or above b): one build serves every b, no recompile.

#include "common.cuh"

namespace ptt {
namespace {

enum Kind { kDense = 0, kInt8 = 1, kInt4Halves = 2 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;               // output columns per thread
constexpr int kTileN = 32 * kCols;     // output columns per block
constexpr int kUnroll = 8;             // weight loads in flight per thread

// raw weight load of 4 columns of one weight row
template <int KIND, typename T>
struct WRaw;
template <>
struct WRaw<kDense, float> {
  using type = float4;
};
template <>
struct WRaw<kDense, __nv_bfloat16> {
  using type = uint2;
};
template <typename T>
struct WRaw<kInt8, T> {
  using type = uint32_t;
};
template <typename T>
struct WRaw<kInt4Halves, T> {
  using type = uint32_t;
};

__device__ __forceinline__ void unpack(const float4& w, float lo[4], float*) {
  lo[0] = w.x; lo[1] = w.y; lo[2] = w.z; lo[3] = w.w;
}
__device__ __forceinline__ void unpack_bf16(const uint2& w, float lo[4]) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
  for (int c = 0; c < 4; ++c) lo[c] = __bfloat162float(h[c]);
}

template <int KIND, typename T>
__device__ __forceinline__ void unpack_w(const typename WRaw<KIND, T>::type& w,
                                         float lo[4], float hi[4]) {
  if constexpr (KIND == kDense) {
    if constexpr (sizeof(T) == 4) {
      unpack(w, lo, hi);
    } else {
      unpack_bf16(w, lo);
    }
  } else {
    const int8_t* c = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = c[j];
      if constexpr (KIND == kInt8) {
        lo[j] = static_cast<float>(v);
      } else {
        lo[j] = static_cast<float>(((v & 15) ^ 8) - 8);
        hi[j] = static_cast<float>(v >> 4);
      }
    }
  }
}

template <int KIND, typename T, int RB>
__global__ void __launch_bounds__(kThreads)
decode_matmul_kernel(const T* __restrict__ x, const void* __restrict__ w,
                     const float* __restrict__ scale, T* __restrict__ out,
                     float* __restrict__ partial, int b, int K, int N,
                     int rows_per_split) {
  using Raw = typename WRaw<KIND, T>::type;
  constexpr bool kHalves = KIND == kInt4Halves;
  constexpr int kTileK = RB <= 8 ? 256 : 64;  // weight rows per x stage
  __shared__ float xs_a[RB][kTileK];
  __shared__ float xs_b[kHalves ? RB : 1][kHalves ? kTileK : 1];
  __shared__ float red[RB][kTileN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kTileN + lane * kCols;
  const bool col_ok = n0 < N;  // N % 4 == 0: a column group is whole
  const int rows_w = kHalves ? K / 2 : K;  // weight rows
  // this block's K-split: weight rows [k_begin, k_end)
  const int k_begin = blockIdx.y * rows_per_split;
  const int k_end = min(rows_w, k_begin + rows_per_split);
  const Raw* wr = static_cast<const Raw*>(w);
  const long long row_stride = N / kCols;  // in Raw units

  float acc[RB][kCols];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    __syncthreads();
    for (int i = tid; i < RB * kTileK; i += kThreads) {
      const int row = i / kTileK;
      const int k = k0 + i % kTileK;
      float va = 0.f, vb = 0.f;
      if (row < b && k < k_end) {
        va = to_float(x[(long long)row * K + k]);
        if constexpr (kHalves) vb = to_float(x[(long long)row * K + k + rows_w]);
      }
      xs_a[row][i % kTileK] = va;
      if constexpr (kHalves) xs_b[row][i % kTileK] = vb;
    }
    __syncthreads();
    if (!col_ok) continue;
    const int kend = min(kTileK, k_end - k0);
    for (int kk = warp; kk < kend; kk += kWarps * kUnroll) {
      Raw raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kr = kk + u * kWarps;
        if (kr < kend) raw[u] = wr[(long long)(k0 + kr) * row_stride + n0 / kCols];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kr = kk + u * kWarps;
        if (kr >= kend) break;
        float lo[kCols], hi[kCols];
        unpack_w<KIND, T>(raw[u], lo, hi);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const float xa = xs_a[i][kr];
          if constexpr (kHalves) {
            const float xb = xs_b[i][kr];
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              acc[i][c] = fmaf(xa, lo[c], fmaf(xb, hi[c], acc[i][c]));
          } else {
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(xa, lo[c], acc[i][c]);
          }
        }
      }
    }
  }
  // deterministic cross-warp reduction: warps add in order 0..7
  for (int i = tid; i < RB * kTileN; i += kThreads) red[i / kTileN][i % kTileN] = 0.f;
  for (int ww = 0; ww < kWarps; ++ww) {
    __syncthreads();
    if (warp == ww && col_ok) {
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) red[i][lane * kCols + c] += acc[i][c];
    }
  }
  __syncthreads();
  for (int i = tid; i < RB * kTileN; i += kThreads) {
    const int row = i / kTileN;
    const int n = blockIdx.x * kTileN + i % kTileN;
    if (row < b && n < N) {
      if (gridDim.y == 1) {
        const float s = KIND == kDense ? 1.f : scale[n];
        out[(long long)row * N + n] = from_float<T>(red[row][i % kTileN] * s);
      } else {
        partial[((long long)blockIdx.y * b + row) * N + n] = red[row][i % kTileN];
      }
    }
  }
}

// second pass of a K-split: sum the splits in order (deterministic),
// apply the scale once, cast
template <typename T>
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ partial,
                     const float* __restrict__ scale, T* __restrict__ out,
                     int splits, int b, int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)b * N;
  if (i >= total) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += partial[sp * total + i];
  out[i] = from_float<T>(scale == nullptr ? acc : acc * scale[i % N]);
}

template <int KIND, typename T>
int launch(const void* x, const void* w, const float* scale, void* out,
           float* partial, int b, int K, int N, int splits,
           cudaStream_t stream) {
  const int rows_w = KIND == kInt4Halves ? K / 2 : K;
  const int tile_k = b <= 8 ? 256 : 64;  // kTileK of the instantiation
  // splits share the rows in whole x stages
  const int per = (rows_w + splits - 1) / splits;
  const int rows_per_split = (per + tile_k - 1) / tile_k * tile_k;
  const int used = (rows_w + rows_per_split - 1) / rows_per_split;
  if (used != splits) return kUnsupported;
  const dim3 grid((N + kTileN - 1) / kTileN, splits);
#define PTT_DMM_LAUNCH(RB)                                                  \
  decode_matmul_kernel<KIND, T, RB><<<grid, kThreads, 0, stream>>>(        \
      static_cast<const T*>(x), w, scale, static_cast<T*>(out), partial, b, \
      K, N, rows_per_split)
  if (b <= 1) PTT_DMM_LAUNCH(1);
  else if (b <= 2) PTT_DMM_LAUNCH(2);
  else if (b <= 4) PTT_DMM_LAUNCH(4);
  else if (b <= 8) PTT_DMM_LAUNCH(8);
  else if (b <= 16) PTT_DMM_LAUNCH(16);
  else PTT_DMM_LAUNCH(32);
#undef PTT_DMM_LAUNCH
  if (splits > 1) {
    const long long total = (long long)b * N;
    splitk_reduce_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        partial, KIND == kDense ? nullptr : scale, static_cast<T*>(out),
        splits, b, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace ptt

// x [b, K] (dtype), w per `kind` (0 dense [K, N] of dtype, 1 int8 [K, N],
// 2 int4 halves [K/2, N] int8), scale [N] float32 (ignored for dense),
// out [b, N] (dtype); with splits > 1, workspace is float32
// [splits, b, N] and `splits` must be a fixed point of the split rule in
// launch(). Returns 0, a cudaError_t from the launch, or -1 for an
// unsupported shape or type.
extern "C" int ptt_decode_matmul(const void* x, const void* w,
                                 const float* scale, void* out,
                                 float* workspace, int b, int K, int N,
                                 int splits, int kind, int dtype,
                                 void* stream) {
  using namespace ptt;
  if (b < 1 || b > 32 || K <= 0 || N <= 0 || N % kCols != 0) return kUnsupported;
  if (kind == kInt4Halves && K % 2 != 0) return kUnsupported;
  if (splits < 1 || (splits > 1 && workspace == nullptr)) return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PTT_DMM_ARGS x, w, scale, out, workspace, b, K, N, splits, st
  if (dtype == kF32) {
    switch (kind) {
      case kDense: return launch<kDense, float>(PTT_DMM_ARGS);
      case kInt8: return launch<kInt8, float>(PTT_DMM_ARGS);
      case kInt4Halves: return launch<kInt4Halves, float>(PTT_DMM_ARGS);
    }
  } else if (dtype == kBF16) {
    switch (kind) {
      case kDense: return launch<kDense, __nv_bfloat16>(PTT_DMM_ARGS);
      case kInt8: return launch<kInt8, __nv_bfloat16>(PTT_DMM_ARGS);
      case kInt4Halves: return launch<kInt4Halves, __nv_bfloat16>(PTT_DMM_ARGS);
    }
  }
#undef PTT_DMM_ARGS
  return kUnsupported;
}
