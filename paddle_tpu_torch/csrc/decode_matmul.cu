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
// the scale is applied once, at the end, as _make_kernel does; like it,
// the dequantized weight takes x's dtype before the product (int4 and
// int8 values are exact in bfloat16).
//
// What bounds it on an H100: bytes. The weight is read once, and each
// weight byte feeds 2 * b (int8), 4 * b (int4) or b (dense bf16) flops:
// at b = 32 that is at most 128 flops a byte, far below the ~295 at
// which the bf16 tensor cores would bind. Float32 multiply-adds on the
// CUDA cores (67 TFLOP/s) would bind first at b = 32 (the first form of
// this kernel lost 4x to torch.matmul there), so bfloat16 x runs on the
// tensor cores.
//
// Design of the bfloat16 kernel (tc::tc_kernel):
// - mma.sync m16n8k16 (bf16 in, float32 sums) with the WEIGHT as the A
//   operand (16 output columns an m-tile) and x^T as B (8 activation
//   rows an n-tile): b <= 8 takes one n-tile, b 32 four, so no product
//   is padded past b rounded up to 8.
// - the contraction order is the kernel's own. A k-step is 16
//   contraction indices in 8 "pairs", the two bf16 halves of one A or B
//   register. int4: lane (g, t) (g = lane / 4, t = lane % 4) loads packed
//   rows 8s + 2t and 8s + 2t + 1; pair t is their low nibbles (in-rows
//   8s + 2t, + 1) and pair t + 4 their high nibbles (the same + K/2).
//   int8 and dense: rows 16s + 2t, + 1 and 16s + 8 + 2t, + 1. So every B
//   register is two adjacent x values.
// - each lane owns CB consecutive columns of its rows (16 at b <= 8, 8
//   above), read with 16-byte (8-byte) loads past L1: a warp reads whole
//   128-byte (64-byte) row segments. Column j of those feeds m-tile j / 2
//   at A row g + 8 (j % 2): the m-tile row <-> column map is a
//   permutation the epilogue undoes.
// - no integer-to-float conversion: int4 xors each nibble's sign bit
//   (0x88888888) and shifts the words right by 4 for the high nibbles;
//   per A register one prmt puts byte j of the two rows in bytes 0 and
//   2, one lop3 masks the nibbles into the mantissas of bf16 128.0
//   (0x4300), one bf16x2 fma subtracts 136: exact values -8..7. int8 has
//   8 bits, one more than bf16's mantissa holds over 128, so each byte
//   goes through float32 (prmt it under 2^23, subtract 2^23 + 128) and
//   a pair is packed with one cvt.rn.bf16x2. Dense bf16 pairs are one
//   prmt.
// - a block is CG warps side by side (256 columns) times 2 warps that
//   interleave k-steps; it first stages its split's activations once in
//   shared memory in B-fragment order (one 8-byte conflict-free load a
//   lane and n-tile), with its first weights already in flight. Each
//   warp then streams its k-steps through two register buffers of U
//   k-steps: one is multiplied while the next is in flight.
// - the 2 k-interleaved warps add their sums in order in shared memory;
//   the grid is (column tiles) x (K splits), the plan coming from the
//   wrapper (split_plan in ops/cuda/decode_matmul.py): one wave of
//   resident blocks, splits a whole number of k-steps. Each split writes
//   float32 partial sums; a second, tiny kernel, launched as a
//   programmatic dependent so its launch overlaps the first's tail, adds
//   the splits in order, applies the scale once and casts. No atomics:
//   reruns are bit-identical.
// - what still bounds it (H100 80GB HBM3, 700 W, chip_smoke.py): at b 8
//   the large projections reach 43-61% of the byte bound; the small ones
//   (wo, wqkv: 8-13 MB) pay ~10 us of latency and launch for ~3 us of
//   bytes. At b 32 each weight byte also feeds 128 mma.sync flops.
//
// Float32 x (only the tiny float32 models reach it) stays on the
// CUDA-core kernel (cc_kernel) of the first form: float32 FMAs, lane l
// owning 4 columns, x staged in K-tiles, the same split-K and second
// pass.

#include <type_traits>

#include "common.cuh"

namespace ptt {
namespace {

enum Kind { kDense = 0, kInt8 = 1, kInt4Halves = 2 };

// ---- float32: CUDA cores ---------------------------------------------------

namespace cc {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;             // output columns per thread
constexpr int kTileN = 32 * kCols;   // output columns per block
constexpr int kUnroll = 8;           // weight loads in flight per thread

// raw weight load of 4 columns of one weight row
template <int KIND>
using Raw = typename std::conditional<KIND == kDense, float4, uint32_t>::type;

template <int KIND>
__device__ __forceinline__ void unpack_w(const Raw<KIND>& w, float lo[4],
                                         float hi[4]) {
  if constexpr (KIND == kDense) {
    lo[0] = w.x; lo[1] = w.y; lo[2] = w.z; lo[3] = w.w;
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

template <int KIND, int RB>
__global__ void __launch_bounds__(kThreads)
cc_kernel(const float* __restrict__ x, const void* __restrict__ w,
          const float* __restrict__ scale, float* __restrict__ out,
          float* __restrict__ partial, int b, int K, int N,
          int rows_per_split) {
  using R = Raw<KIND>;
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
  const R* wr = static_cast<const R*>(w);
  const long long row_stride = N / kCols;  // in R units

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
        va = x[(long long)row * K + k];
        if constexpr (kHalves) vb = x[(long long)row * K + k + rows_w];
      }
      xs_a[row][i % kTileK] = va;
      if constexpr (kHalves) xs_b[row][i % kTileK] = vb;
    }
    __syncthreads();
    if (!col_ok) continue;
    const int kend = min(kTileK, k_end - k0);
    for (int kk = warp; kk < kend; kk += kWarps * kUnroll) {
      R raw[kUnroll];
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
        unpack_w<KIND>(raw[u], lo, hi);
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
        out[(long long)row * N + n] = red[row][i % kTileN] * s;
      } else {
        partial[((long long)blockIdx.y * b + row) * N + n] = red[row][i % kTileN];
      }
    }
  }
}

}  // namespace cc

// ---- bfloat16: tensor cores ------------------------------------------------

namespace tc {

// The block's shape at NT n-tiles of 8 activation rows (b <= 8 NT): each
// lane owns CB consecutive columns (a warp 8 CB), CG warps sit side by
// side and KG warps interleave k-steps. The CG warps of a k-group share
// the staged activations, so wide blocks keep the activation traffic
// (every column tile reads all of x) well below the weight's.
template <int NT>
struct Shape {
  static constexpr int CB = NT == 1 ? 16 : 8;
  static constexpr int CG = NT == 1 ? 2 : 4;
  static constexpr int KG = 2;
  static constexpr int kThreads = 32 * CG * KG;
  static constexpr int kTileN = 8 * CB * CG;
  static constexpr int MT = CB / 2;  // m-tiles a warp
};

// U: k-steps a warp has in flight per buffer (two buffers); NL: weight
// rows a lane loads a k-step; WPR: 32-bit words of a lane's CB columns
// of one row
template <int KIND, int NT>
struct Cfg {
  static constexpr int U =
      KIND == kInt4Halves ? 4
      : KIND == kInt8     ? 2
                          : 1;
  static constexpr int NL = KIND == kInt4Halves ? 2 : 4;
  static constexpr int WPR = Shape<NT>::CB * (KIND == kDense ? 2 : 1) / 4;
};

// weight row l of k-step s for lane t: int4 packed rows 8s + 2t (+1);
// int8 and dense rows 16s + 2t (+1) and 16s + 8 + 2t (+1)
template <int KIND>
__device__ __forceinline__ long long weight_row(int s, int t, int l) {
  if constexpr (KIND == kInt4Halves) return 8LL * s + 2 * t + l;
  return 16LL * s + 2 * t + (l & 1) + 8 * (l >> 1);
}

// a lane's WPR words of one weight row, read once: past L1, which keeps
// the activations
template <int WPR>
__device__ __forceinline__ void load_row(const uint8_t* p, uint32_t (&d)[WPR]) {
  if constexpr (WPR == 2) {
    asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
                 : "=r"(d[0]), "=r"(d[1]) : "l"(p));
  } else {
#pragma unroll
    for (int i = 0; i < WPR / 4; ++i)
      asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(d[4 * i]), "=r"(d[4 * i + 1]), "=r"(d[4 * i + 2]),
                     "=r"(d[4 * i + 3])
                   : "l"(p + 16 * i));
  }
}

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// int4: the low nibbles of byte j of p and of q (both already xor
// 0x88888888; shift both right by 4 for the high nibbles) as bf16x2,
// exact in -8..7
__device__ __forceinline__ uint32_t deq4(uint32_t p, uint32_t q, int j) {
  const uint32_t t = __byte_perm(p, q, j * 0x0011 + (4 + j) * 0x1100);
  const uint32_t v = (t & 0x000F000Fu) | 0x43004300u;  // 128 + nibble
  return fma_bf16x2(v, 0x3F803F80u, 0xC308C308u);      // * 1 - 136
}

// int8: byte j of w (already xor 0x80808080) as float32, exact
__device__ __forceinline__ float deq8(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 | j)) -
         8388736.f;  // 2^23 + 128
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// the A fragment of m-tile mt from one k-step's rows r: registers (row
// g, pair t), (row g + 8, pair t), (row g, pair t + 4), (row g + 8,
// pair t + 4), i.e. the lane's columns 2 mt and 2 mt + 1. int4: pair t
// is the low nibbles of packed rows 8s + 2t and + 1, pair t + 4 their
// high nibbles; int8 / dense: pair t is rows 16s + 2t and + 1, pair
// t + 4 rows 16s + 8 + 2t and + 1
template <int KIND, int NL, int WPR>
__device__ __forceinline__ void a_frag(const uint32_t (&r)[NL][WPR], int mt,
                                       uint32_t (&a)[4]) {
  const int j0 = (2 * mt) & 3, j1 = j0 + 1, wi = mt >> 1;
  if constexpr (KIND == kInt4Halves) {
    const uint32_t p = r[0][wi] ^ 0x88888888u, q = r[1][wi] ^ 0x88888888u;
    a[0] = deq4(p, q, j0);
    a[1] = deq4(p, q, j1);
    a[2] = deq4(p >> 4, q >> 4, j0);
    a[3] = deq4(p >> 4, q >> 4, j1);
  } else if constexpr (KIND == kInt8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t wa = r[2 * h][wi] ^ 0x80808080u;
      const uint32_t wb = r[2 * h + 1][wi] ^ 0x80808080u;
      a[2 * h] = pack_bf16x2(deq8(wa, j0), deq8(wb, j0));
      a[2 * h + 1] = pack_bf16x2(deq8(wa, j1), deq8(wb, j1));
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a[2 * h] = __byte_perm(r[2 * h][mt], r[2 * h + 1][mt], 0x5410);
      a[2 * h + 1] = __byte_perm(r[2 * h][mt], r[2 * h + 1][mt], 0x7632);
    }
  }
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block's activations in B-fragment order, staged once in shared
// memory: xs[s][nt][lane] = (b0, b1) of k-step s_begin + s, n-tile nt,
// lane (g, t): rows 8 nt + g (zero past b), pair t (b0) and pair t + 4
// (b1) of the kernel's contraction order (int4: x[k] and x[k + 1] for
// the low nibbles, the same at k + K/2 for the high ones; int8 / dense:
// x[k], x[k + 1] and x[k + 8], x[k + 9]). A warp then reads its B
// registers with one conflict-free 8-byte load a lane.
template <int KIND, int NT, int THREADS>
__device__ __forceinline__ void stage_x(const __nv_bfloat16* __restrict__ x,
                                        uint2* xs, int b, int K, int s_begin,
                                        int n_steps) {
  // thread i takes k-step s and activation row 8 nt + g: the 16 x values
  // of its 4 lanes (t = 0..3) are 2 aligned 16-byte loads, written as
  // 32 consecutive bytes
  const int total = n_steps * NT * 8;
#pragma unroll 2
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int g = i & 7, nt = (i >> 3) % NT, s = (i >> 3) / NT;
    const int row = 8 * nt + g;
    uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
    if (row < b) {
      const __nv_bfloat16* xr = x + (long long)row * K;
      const int k = KIND == kInt4Halves ? 8 * (s_begin + s) : 16 * (s_begin + s);
      lo = __ldg(reinterpret_cast<const uint4*>(xr + k));
      hi = __ldg(reinterpret_cast<const uint4*>(
          xr + (KIND == kInt4Halves ? K / 2 + k : k + 8)));
    }
    // lane (g, t): b0 = word t of lo, b1 = word t of hi
    uint4* dst = reinterpret_cast<uint4*>(xs + ((s * NT + nt) * 32 + 4 * g));
    dst[0] = make_uint4(lo.x, hi.x, lo.y, hi.y);
    dst[1] = make_uint4(lo.z, hi.z, lo.w, hi.w);
  }
}

// one buffer of a warp's stream: U k-steps of weight rows and B registers
template <int KIND, int NT>
struct Buf {
  uint32_t w[Cfg<KIND, NT>::U][Cfg<KIND, NT>::NL][Cfg<KIND, NT>::WPR];
};

// shared memory of a block: the staged activations of a split of at most
// max_steps k-steps, and after them the cross-warp sums (same bytes)
template <int NT>
constexpr int max_steps() { return 256 / NT; }
template <int NT>
constexpr int smem_bytes(int steps) {
  const int xs = steps * NT * 32 * 8;
  const int red = 8 * NT * (Shape<NT>::kTileN + 4) * 4;
  return xs > red ? xs : red;
}

template <int KIND, int NT>
__global__ void __launch_bounds__(Shape<NT>::kThreads)
tc_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ w,
          const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
          float* __restrict__ partial, int b, int K, int N,
          int steps_per_split) {
  using S = Shape<NT>;
  using C = Cfg<KIND, NT>;
  constexpr int U = C::U, NL = C::NL, WPR = C::WPR, KG = S::KG, MT = S::MT;
  constexpr int kRows = 8 * NT;
  constexpr int kRedStride = S::kTileN + 4;
  extern __shared__ __align__(16) uint8_t smem[];
  uint2* xs = reinterpret_cast<uint2*>(smem);
  float* red = reinterpret_cast<float*>(smem);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cg = warp % S::CG, kg = warp / S::CG;
  const int n_lane = blockIdx.x * S::kTileN + 8 * S::CB * cg + S::CB * g;
  const bool col_ok = n_lane < N;  // N % CB == 0
  const int steps = K / 16;  // k-steps over the whole of K
  const int s_begin = blockIdx.y * steps_per_split;
  const int s_end = min(steps, s_begin + steps_per_split);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  constexpr int kElem = KIND == kDense ? 2 : 1;  // bytes a weight

  float acc[NT][MT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][mt][e] = 0.f;

  // U k-steps s, s + KG, ... of this warp into buf (zeros past the end)
  auto load = [&](Buf<KIND, NT>& buf, int s) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int step = s + u * KG;
      const bool ok = step < s_end;
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        if (ok && col_ok) {
          load_row<WPR>(wb + (weight_row<KIND>(step, t, l) * N + n_lane) * kElem,
                        buf.w[u][l]);
        } else {
#pragma unroll
          for (int i = 0; i < WPR; ++i) buf.w[u][l][i] = 0u;
        }
      }
    }
  };
  auto compute = [&](const Buf<KIND, NT>& buf, int s) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s + u * KG >= s_end) break;
      uint2 bx[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        bx[nt] = xs[((s + u * KG - s_begin) * NT + nt) * 32 + lane];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        a_frag<KIND, NL, WPR>(buf.w[u], mt, a);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_16816(acc[nt][mt], a, bx[nt].x, bx[nt].y);
      }
    }
  };

  // two buffers in turn: the next U k-steps are in flight while the
  // current ones are multiplied
  Buf<KIND, NT> b0, b1;
  constexpr int kGroup = U * KG;
  int s = s_begin + kg;
  // the first weights are in flight while the block stages x
  if (s < s_end) load(b0, s);
  stage_x<KIND, NT, S::kThreads>(x, xs, b, K, s_begin, s_end - s_begin);
  __syncthreads();
  while (s < s_end) {
    if (s + kGroup < s_end) load(b1, s + kGroup);
    compute(b0, s);
    s += kGroup;
    if (s >= s_end) break;
    if (s + kGroup < s_end) load(b0, s + kGroup);
    compute(b1, s);
    s += kGroup;
  }

  // deterministic cross-warp reduction: k-groups add in order 0..KG-1.
  // Lane (g, t) holds, for n-tile nt and m-tile mt, its columns 2mt
  // (d[0], d[1]) and 2mt + 1 (d[2], d[3]) for activation rows 8nt + 2t
  // (d[0], d[2]) and 8nt + 2t + 1 (d[1], d[3])
  __syncthreads();  // xs is read: its bytes take the sums
  for (int i = threadIdx.x; i < kRows * kRedStride; i += S::kThreads)
    red[i] = 0.f;
  const int c_lane = 8 * S::CB * cg + S::CB * g;
  for (int gg = 0; gg < KG; ++gg) {
    __syncthreads();
    if (kg == gg) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float* r0 = red + (8 * nt + 2 * t) * kRedStride + c_lane + 2 * mt;
          r0[0] += acc[nt][mt][0];
          r0[1] += acc[nt][mt][2];
          r0[kRedStride] += acc[nt][mt][1];
          r0[kRedStride + 1] += acc[nt][mt][3];
        }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * S::kTileN; i += S::kThreads) {
    const int row = i / S::kTileN, c = i % S::kTileN;
    const int n = blockIdx.x * S::kTileN + c;
    if (row < b && n < N) {
      const float v = red[row * kRedStride + c];
      if (gridDim.y == 1) {
        const float sc = KIND == kDense ? 1.f : scale[n];
        out[(long long)row * N + n] = __float2bfloat16(v * sc);
      } else {
        partial[((long long)blockIdx.y * b + row) * N + n] = v;
      }
    }
  }
  // this block's partial sums are written: the second pass may start
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

}  // namespace tc

// second pass of a K-split: sum the splits in order (deterministic),
// apply the scale once, cast. Launched as a programmatic dependent of the
// first pass, so its launch overlaps that pass's tail; it waits for the
// first pass's partial sums before reading them.
template <typename T>
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ partial,
                     const float* __restrict__ scale, T* __restrict__ out,
                     int splits, int b, int N) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)b * N;
  if (i >= total) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += partial[sp * total + i];
  out[i] = from_float<T>(scale == nullptr ? acc : acc * scale[i % N]);
}

template <typename T>
int reduce_splits(const float* partial, const float* scale, void* out,
                  int splits, int b, int N, cudaStream_t stream) {
  const long long total = (long long)b * N;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((total + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, splitk_reduce_kernel<T>, partial, scale, static_cast<T*>(out),
      splits, b, N));
}

template <int KIND>
int launch_f32(const void* x, const void* w, const float* scale, void* out,
               float* partial, int b, int K, int N, int splits,
               int rows_per_split, cudaStream_t stream) {
  const dim3 grid((N + cc::kTileN - 1) / cc::kTileN, splits);
#define PTT_DMM_LAUNCH(RB)                                                 \
  cc::cc_kernel<KIND, RB><<<grid, cc::kThreads, 0, stream>>>(              \
      static_cast<const float*>(x), w, scale, static_cast<float*>(out),    \
      partial, b, K, N, rows_per_split)
  if (b <= 1) PTT_DMM_LAUNCH(1);
  else if (b <= 2) PTT_DMM_LAUNCH(2);
  else if (b <= 4) PTT_DMM_LAUNCH(4);
  else if (b <= 8) PTT_DMM_LAUNCH(8);
  else if (b <= 16) PTT_DMM_LAUNCH(16);
  else PTT_DMM_LAUNCH(32);
#undef PTT_DMM_LAUNCH
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (splits == 1) return 0;
  return reduce_splits<float>(partial, KIND == kDense ? nullptr : scale, out,
                              splits, b, N, stream);
}

template <int KIND, int NT>
int launch_tc(const void* x, const void* w, const float* scale, void* out,
              float* partial, int b, int K, int N, int splits, int steps,
              cudaStream_t stream) {
  using S = tc::Shape<NT>;
  if (N % S::CB != 0 || steps > tc::max_steps<NT>()) return kUnsupported;
  // the most shared memory a split may take, allowed once
  static bool attr_set = false;
  if (!attr_set) {
    if (cudaError_t e = cudaFuncSetAttribute(
            tc::tc_kernel<KIND, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            tc::smem_bytes<NT>(tc::max_steps<NT>())))
      return static_cast<int>(e);
    attr_set = true;
  }
  tc::tc_kernel<KIND, NT>
      <<<dim3((N + S::kTileN - 1) / S::kTileN, splits), S::kThreads,
         tc::smem_bytes<NT>(steps), stream>>>(
          static_cast<const __nv_bfloat16*>(x), w, scale,
          static_cast<__nv_bfloat16*>(out), partial, b, K, N, steps);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (splits == 1) return 0;
  return reduce_splits<__nv_bfloat16>(partial, KIND == kDense ? nullptr : scale,
                                      out, splits, b, N, stream);
}

template <int KIND>
int launch_bf16(const void* x, const void* w, const float* scale, void* out,
                float* workspace, int b, int K, int N, int splits,
                int rows_per_split, cudaStream_t stream) {
  // whole k-steps: 16 contraction indices, i.e. 8 packed int4 rows or
  // 16 int8/dense rows
  const int per_step = KIND == kInt4Halves ? 8 : 16;
  if (K % 16 != 0 || rows_per_split % per_step != 0 ||
      (splits > 1 && workspace == nullptr))
    return kUnsupported;
  const int steps = rows_per_split / per_step;
  if (b <= 8)
    return launch_tc<KIND, 1>(x, w, scale, out, workspace, b, K, N, splits,
                              steps, stream);
  if (b <= 16)
    return launch_tc<KIND, 2>(x, w, scale, out, workspace, b, K, N, splits,
                              steps, stream);
  return launch_tc<KIND, 4>(x, w, scale, out, workspace, b, K, N, splits,
                            steps, stream);
}

}  // namespace
}  // namespace ptt

// x [b, K] (dtype), w per `kind` (0 dense [K, N] of dtype, 1 int8 [K, N],
// 2 int4 halves [K/2, N] int8), scale [N] float32 (ignored for dense),
// out [b, N] (dtype). The split plan comes from the caller
// (ops/cuda/decode_matmul.py:split_plan): `splits` blocks along K, each
// over `rows_per_split` weight rows (packed rows for int4), every split
// non-empty; bfloat16 also needs whole k-steps (8 packed int4 rows or
// 16 int8/dense rows a split, at most 256 / NT k-steps of 16 indices,
// NT = 1, 2, 4 at b <= 8, 16, 32), K % 16 == 0 and N % 16 (b <= 8) or
// 8. With splits > 1, workspace is float32 [splits, b, N]. Returns 0, a
// cudaError_t from a launch, or -1 for an unsupported shape, type or
// plan.
extern "C" int ptt_decode_matmul(const void* x, const void* w,
                                 const float* scale, void* out,
                                 float* workspace, int b, int K, int N,
                                 int splits, int rows_per_split, int kind,
                                 int dtype, void* stream) {
  using namespace ptt;
  if (b < 1 || b > 32 || K <= 0 || N <= 0 || N % 4 != 0) return kUnsupported;
  if (kind == kInt4Halves && K % 2 != 0) return kUnsupported;
  const int rows_w = kind == kInt4Halves ? K / 2 : K;
  // the plan covers every weight row once, with no empty split
  if (splits < 1 || rows_per_split < 1 ||
      (long long)(splits - 1) * rows_per_split >= rows_w ||
      (long long)splits * rows_per_split < rows_w)
    return kUnsupported;
  if (splits > 1 && workspace == nullptr) return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PTT_DMM_ARGS \
  x, w, scale, out, workspace, b, K, N, splits, rows_per_split, st
  if (dtype == kF32) {
    switch (kind) {
      case kDense: return launch_f32<kDense>(PTT_DMM_ARGS);
      case kInt8: return launch_f32<kInt8>(PTT_DMM_ARGS);
      case kInt4Halves: return launch_f32<kInt4Halves>(PTT_DMM_ARGS);
    }
  } else if (dtype == kBF16) {
    switch (kind) {
      case kDense: return launch_bf16<kDense>(PTT_DMM_ARGS);
      case kInt8: return launch_bf16<kInt8>(PTT_DMM_ARGS);
      case kInt4Halves: return launch_bf16<kInt4Halves>(PTT_DMM_ARGS);
    }
  }
#undef PTT_DMM_ARGS
  return kUnsupported;
}
