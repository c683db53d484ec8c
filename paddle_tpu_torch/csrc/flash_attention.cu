// Flash attention for training on Hopper (sm_90a): the forward, the dq
// backward and the dk/dv backward.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   _flash_fwd (kernel body _fwd_kernel)            -> flash_fwd_kernel
//   _bwd_pair_call's dq call (_bwd_dq_kernel)        -> flash_bwd_dq_kernel
//   _bwd_pair_call's dk/dv call (_bwd_dkv_kernel)    -> flash_bwd_dkv_kernel
// reached from flash_attention_pallas / flash_attention_pallas_segmented
// through their VJPs (_fa_fwd/_fa_bwd, _fas_fwd/_fas_bwd).
//
// What they compute (the JAX kernels' semantics, not their blocking):
// - q [b, sq, h, d], k/v [b, sk, hk, d] read in place through strides
//   (no [b, h, s, d] copies); GQA reads kv-head h / group, K/V are never
//   expanded. Optional segment ids [b, s] int32 mask unequal tokens,
//   together with causal. Causal aligns the queries to the END of the
//   keys: row r sees column c iff r + (sk - sq) >= c.
// - forward: q scaled in float32 BEFORE the product; online softmax in
//   float32 with JAX's finite -1e30 for masked scores and the guard
//   s > -0.5e30, so fully-masked rows give 0 and never NaN; out in q's
//   dtype, lse = m + log(max(l, 1e-30)) float32 [b, h, sq].
// - backward (given lse and delta = sum(out * dout, -1) [b, h, sq]):
//   s = (q . k) * scale AFTER the product, p = exp(s - lse) under the
//   same guard, ds = p * (dp - delta) * scale; dq = ds . K in q's dtype;
//   dk = ds^T . Q and dv = p^T . dO in float32, summed over the GQA
//   group INSIDE the block (no atomics), so two runs are bit-identical.
//   No 2048-chunking: the TPU tiled the backward only for VMEM.
//
// What bounds it on an H100: operations. At the llama_mid shape (b 4,
// s 2048, h 16, d 128, causal) the forward does ~69 GFLOP for ~34 MB of
// q/k/v/out: 2000 flops per byte, far above the ~295 where the bf16
// tensor cores become the limit.
//
// Design (the simple, right form; the fast form is later work). These
// kernels take float32 inputs at every head_dim and bfloat16 at head_dim
// 256; bfloat16 at head_dim 64, 72 and 128 (the Llama / GPT and DiT-XL/2
// training paths) runs on the tensor cores in flash_attention_wg.cu
// (wgmma, TMA) with the same semantics.
// - CUDA-core float32 FMAs (67 TFLOP/s peak, not the 989 of the tensor
//   cores): the float32 path must agree with the CPU to 1e-4, which
//   bfloat16 or TF32 products would not.
// - one 256-thread block per (q tile, head, batch) for the forward and
//   dq, per (k tile, kv-head, batch) for dk/dv; tiles of 64 rows (32 at
//   d = 256), staged in shared memory as float32 with rows padded to
//   d + 1 floats, so the lane-per-row reads of the products hit distinct
//   banks. 116-166 KB of dynamic shared memory at d = 128.
// - a head_dim that is not a multiple of 16 (72: DiT-XL/2's 1152 / 16)
//   pads the tiles to the next multiple (80): the pad columns are zeroed
//   once, no load writes them, the q.k products stop at d, and the output
//   columns past d are computed from zeros and never stored.
// - a 16 x 16 thread grid: thread (ty, tx) owns score rows ty*RM + i and
//   columns tx + 16 j, and the same rows of the [rows, d] accumulators at
//   columns tx + 16 j; row max and sum are 16-lane shuffles.
// - causal work is skipped, not masked: the forward and dq stop at the
//   last key tile a query tile can see, and dk/dv start at the first
//   query tile that can see the key tile (half the work at sq == sk).
// Not done here: TMA or cp.async double buffering, a persistent schedule
// for the causal imbalance.

#include "flash_attention.cuh"

namespace ptt {
namespace {

constexpr int kFlashThreads = 256;  // a 16 x 16 grid of threads

template <int D>
struct FlashShape {
  static_assert(D % 8 == 0, "rows are loaded in chunks of 8");
  static constexpr int kRows = D > 128 ? 32 : 64;  // rows of a q or k tile
  static constexpr int kRM = kRows / 16;            // tile rows per thread
  static constexpr int kDP = (D + 15) / 16 * 16;    // d padded to 16 columns
  static constexpr int kDC = kDP / 16;              // d columns per thread
  static constexpr int kLD = kDP + 1;               // padded row stride
  static constexpr int kPS = kRows + 1;             // score tile row stride
};

// zeros into the pad columns [D, kDP) of a tile of R rows (nothing when D
// is a multiple of 16); load_tile never writes them
template <int D, int R>
__device__ __forceinline__ void zero_pad(float* dst) {
  using S = FlashShape<D>;
  constexpr int kPad = S::kDP - D;
  if constexpr (kPad > 0) {
    for (int i = threadIdx.x; i < R * kPad; i += kFlashThreads)
      dst[(i / kPad) * S::kLD + D + i % kPad] = 0.f;
  }
}

// rows [r0, r0 + R) of one head of a [b, s, heads, D] tensor (src points
// at row 0 of that head; rows are row_stride elements apart) into
// dst[R][kLD] as float32 times mul; rows at or past s are zeros
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int r0,
                                          int s, float mul) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < R * kChunks; i += kFlashThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    float v[8];
    if (r0 + r < s) {
      load8(src + (long long)(r0 + r) * row_stride + c, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
    float* d = dst + r * FlashShape<D>::kLD + c;
#pragma unroll
    for (int j = 0; j < 8; ++j) d[j] = v[j] * mul;
  }
}

// the segment ids of rows [r0, r0 + R) (pad where past s)
template <int R>
__device__ __forceinline__ void load_seg(int* dst, const int* seg, int r0,
                                         int s, int pad) {
  for (int i = threadIdx.x; i < R; i += kFlashThreads)
    dst[i] = r0 + i < s ? seg[r0 + i] : pad;
}

// acc[i][j] += sum_c A[ty*RM + i][c] * B[tx + 16 j][c] over the D real
// columns (row stride kLD)
template <int D, int RM>
__device__ __forceinline__ void mm_abt(const float* A, const float* B,
                                       int ty, int tx, float (&acc)[RM][RM]) {
  constexpr int LD = FlashShape<D>::kLD;
  const float* a0 = A + ty * RM * LD;
  const float* b0 = B + tx * LD;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float a[RM], b[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = a0[i * LD + c];
#pragma unroll
    for (int j = 0; j < RM; ++j) b[j] = b0[16 * j * LD + c];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k P[ty*RM + i][k] * X[k][tx + 16 j]  (P: row stride PS,
// X: row stride kLD, K rows of X; j over the padded columns)
template <int D, int RM, int K, int PS>
__device__ __forceinline__ void mm_px(const float* P, const float* X,
                                      int ty, int tx,
                                      float (&acc)[RM][FlashShape<D>::kDC]) {
  const float* p0 = P + ty * RM * PS;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = p0[i * PS + k];
    const float* x = X + k * FlashShape<D>::kLD + tx;
#pragma unroll
    for (int j = 0; j < FlashShape<D>::kDC; ++j) {
      const float b = x[16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
    }
  }
}

// acc[i][j] += sum_q P[q][ty*RM + i] * X[q][tx + 16 j]: the transposed
// product of dk/dv (P: row stride PS, X: row stride kLD, Q rows)
template <int D, int RM, int Q, int PS>
__device__ __forceinline__ void mm_ptx(const float* P, const float* X,
                                       int ty, int tx,
                                       float (&acc)[RM][FlashShape<D>::kDC]) {
#pragma unroll 4
  for (int q = 0; q < Q; ++q) {
    float a[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = P[q * PS + ty * RM + i];
    const float* x = X + q * FlashShape<D>::kLD + tx;
#pragma unroll
    for (int j = 0; j < FlashShape<D>::kDC; ++j) {
      const float b = x[16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
    }
  }
}

// column tx + 16 j of the padded tile is a real column (< D)
template <int D>
__device__ __forceinline__ bool real_col(int tx, int j) {
  return FlashShape<D>::kDP == D || tx + 16 * j < D;
}

// reductions over the 16 lanes that share a score row
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qseg,
                 const int* __restrict__ kseg, T* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int h, int hk,
                 float scale, int causal) {
  using S = FlashShape<D>;
  constexpr int BM = S::kRows, RM = S::kRM, DC = S::kDC, LD = S::kLD,
                PS = S::kPS;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BM * LD;
  float* vs = ks + BM * LD;
  float* ps = vs + BM * LD;
  int* qsg = reinterpret_cast<int*>(ps + BM * PS);
  int* ksg = qsg + BM;

  const int q0 = blockIdx.x * BM, hh = blockIdx.y, bi = blockIdx.z;
  const int hkv = hh / (h / hk);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool seg = qseg != nullptr;
  const long long kstride = (long long)hk * D;
  const T* kb = k + ((long long)bi * sk * hk + hkv) * D;
  const T* vb = v + ((long long)bi * sk * hk + hkv) * D;

  zero_pad<D, BM>(vs);  // the P.V product reads V's pad columns
  load_tile<T, D, BM>(qs, q + ((long long)bi * sq * h + hh) * D,
                      (long long)h * D, q0, sq, scale);
  if (seg) load_seg<BM>(qsg, qseg + (long long)bi * sq, q0, sq, -1);

  float m[RM], l[RM], acc[RM][DC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int nk = key_tiles(q0, BM, sq, sk, BM, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BM;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, BM>(ks, kb, kstride, k0, sk, 1.f);
    load_tile<T, D, BM>(vs, vb, kstride, k0, sk, 1.f);
    if (seg) load_seg<BM>(ksg, kseg + (long long)bi * sk, k0, sk, -2);
    __syncthreads();

    float s[RM][RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) s[i][j] = 0.f;
    mm_abt<D, RM>(qs, ks, ty, tx, s);

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int rl = ty * RM + i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const int cl = tx + 16 * j;
        if (!visible(q0 + rl, k0 + cl, sq, sk, causal, seg,
                     seg ? qsg[rl] : 0, seg ? ksg[cl] : 0))
          s[i][j] = kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const float p =
            s[i][j] > kMasked * 0.5f ? expf(s[i][j] - m_new) : 0.f;
        ps[rl * PS + tx + 16 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    mm_px<D, RM, BM, PS>(ps, vs, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty * RM + i;
    if (r >= sq) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    T* o = out + (((long long)bi * sq + r) * h + hh) * D + tx;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      if (real_col<D>(tx, j)) o[16 * j] = from_float<T>(acc[i][j] / ls);
    if (tx == 0) lse[((long long)bi * h + hh) * sq + r] = m[i] + logf(ls);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ qseg,
                    const int* __restrict__ kseg, T* __restrict__ dq, int sq,
                    int sk, int h, int hk, float scale, int causal) {
  using S = FlashShape<D>;
  constexpr int BM = S::kRows, RM = S::kRM, DC = S::kDC, LD = S::kLD,
                PS = S::kPS;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BM * LD;
  float* ks = dos + BM * LD;
  float* vs = ks + BM * LD;
  float* dss = vs + BM * LD;
  int* qsg = reinterpret_cast<int*>(dss + BM * PS);
  int* ksg = qsg + BM;

  const int q0 = blockIdx.x * BM, hh = blockIdx.y, bi = blockIdx.z;
  const int hkv = hh / (h / hk);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool seg = qseg != nullptr;
  const long long qoff = ((long long)bi * sq * h + hh) * D;
  const long long kstride = (long long)hk * D;
  const T* kb = k + ((long long)bi * sk * hk + hkv) * D;
  const T* vb = v + ((long long)bi * sk * hk + hkv) * D;

  zero_pad<D, BM>(ks);  // the dS.K product reads K's pad columns
  load_tile<T, D, BM>(qs, q + qoff, (long long)h * D, q0, sq, 1.f);
  load_tile<T, D, BM>(dos, dout + qoff, (long long)h * D, q0, sq, 1.f);
  if (seg) load_seg<BM>(qsg, qseg + (long long)bi * sq, q0, sq, -1);
  float lse_r[RM], del_r[RM], acc[RM][DC];
  const long long row0 = ((long long)bi * h + hh) * sq;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty * RM + i;
    lse_r[i] = r < sq ? lse[row0 + r] : 0.f;
    del_r[i] = r < sq ? delta[row0 + r] : 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int nk = key_tiles(q0, BM, sq, sk, BM, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BM;
    __syncthreads();
    load_tile<T, D, BM>(ks, kb, kstride, k0, sk, 1.f);
    load_tile<T, D, BM>(vs, vb, kstride, k0, sk, 1.f);
    if (seg) load_seg<BM>(ksg, kseg + (long long)bi * sk, k0, sk, -2);
    __syncthreads();

    float s[RM][RM], dp[RM][RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) s[i][j] = dp[i][j] = 0.f;
    mm_abt<D, RM>(qs, ks, ty, tx, s);
    mm_abt<D, RM>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int rl = ty * RM + i;
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const int cl = tx + 16 * j;
        float sc = s[i][j] * scale;
        if (!visible(q0 + rl, k0 + cl, sq, sk, causal, seg,
                     seg ? qsg[rl] : 0, seg ? ksg[cl] : 0))
          sc = kMasked;
        const float p = sc > kMasked * 0.5f ? expf(sc - lse_r[i]) : 0.f;
        dss[rl * PS + cl] = p * (dp[i][j] - del_r[i]) * scale;
      }
    }
    __syncthreads();
    mm_px<D, RM, BM, PS>(dss, ks, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty * RM + i;
    if (r >= sq) continue;
    T* o = dq + (((long long)bi * sq + r) * h + hh) * D + tx;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      if (real_col<D>(tx, j)) o[16 * j] = from_float<T>(acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ qseg,
                     const int* __restrict__ kseg, float* __restrict__ dk,
                     float* __restrict__ dv, int sq, int sk, int h, int hk,
                     float scale, int causal) {
  using S = FlashShape<D>;
  constexpr int BM = S::kRows, RM = S::kRM, DC = S::kDC, LD = S::kLD,
                PS = S::kPS;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BM * LD;
  float* qs = vs + BM * LD;
  float* dos = qs + BM * LD;
  float* ps = dos + BM * LD;
  float* dss = ps + BM * PS;
  float* lse_s = dss + BM * PS;
  float* del_s = lse_s + BM;
  int* qsg = reinterpret_cast<int*>(del_s + BM);
  int* ksg = qsg + BM;

  const int k0 = blockIdx.x * BM, hkv = blockIdx.y, bi = blockIdx.z;
  const int group = h / hk;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool seg = qseg != nullptr;
  const long long koff = ((long long)bi * sk * hk + hkv) * D;
  const long long qstride = (long long)h * D;

  zero_pad<D, BM>(qs);  // P^T.dO and dS^T.Q read their pad columns
  zero_pad<D, BM>(dos);
  load_tile<T, D, BM>(ks, k + koff, (long long)hk * D, k0, sk, 1.f);
  load_tile<T, D, BM>(vs, v + koff, (long long)hk * D, k0, sk, 1.f);
  if (seg) load_seg<BM>(ksg, kseg + (long long)bi * sk, k0, sk, -2);

  float dk_acc[RM][DC], dv_acc[RM][DC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nq = (sq + BM - 1) / BM;
  // the first query tile whose last row can see this key tile
  const int first = causal ? max(k0 - (sk - sq), 0) / BM : 0;
  for (int g = 0; g < group; ++g) {
    const int hh = hkv * group + g;
    const long long qoff = ((long long)bi * sq * h + hh) * D;
    const long long row0 = ((long long)bi * h + hh) * sq;
    for (int qt = first; qt < nq; ++qt) {
      const int q0 = qt * BM;
      __syncthreads();
      load_tile<T, D, BM>(qs, q + qoff, qstride, q0, sq, 1.f);
      load_tile<T, D, BM>(dos, dout + qoff, qstride, q0, sq, 1.f);
      for (int i = threadIdx.x; i < BM; i += kFlashThreads) {
        const bool in = q0 + i < sq;
        lse_s[i] = in ? lse[row0 + q0 + i] : 0.f;
        del_s[i] = in ? delta[row0 + q0 + i] : 0.f;
      }
      if (seg) load_seg<BM>(qsg, qseg + (long long)bi * sq, q0, sq, -1);
      __syncthreads();

      float s[RM][RM], dp[RM][RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RM; ++j) s[i][j] = dp[i][j] = 0.f;
      mm_abt<D, RM>(qs, ks, ty, tx, s);
      mm_abt<D, RM>(dos, vs, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int rl = ty * RM + i;  // query row of the tile
#pragma unroll
        for (int j = 0; j < RM; ++j) {
          const int cl = tx + 16 * j;  // key row of the tile
          float sc = s[i][j] * scale;
          if (!visible(q0 + rl, k0 + cl, sq, sk, causal, seg,
                       seg ? qsg[rl] : 0, seg ? ksg[cl] : 0))
            sc = kMasked;
          const float p = sc > kMasked * 0.5f ? expf(sc - lse_s[rl]) : 0.f;
          ps[rl * PS + cl] = p;
          dss[rl * PS + cl] = p * (dp[i][j] - del_s[rl]) * scale;
        }
      }
      __syncthreads();
      mm_ptx<D, RM, BM, PS>(ps, dos, ty, tx, dv_acc);
      mm_ptx<D, RM, BM, PS>(dss, qs, ty, tx, dk_acc);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int c = k0 + ty * RM + i;
    if (c >= sk) continue;
    const long long o = (((long long)bi * sk + c) * hk + hkv) * D + tx;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      if (!real_col<D>(tx, j)) continue;
      dk[o + 16 * j] = dk_acc[i][j];
      dv[o + 16 * j] = dv_acc[i][j];
    }
  }
}

// float32 elements of shared memory each kernel uses
template <int D>
constexpr int fwd_smem() {
  using S = FlashShape<D>;
  return 3 * S::kRows * S::kLD + S::kRows * S::kPS + 2 * S::kRows;
}
template <int D>
constexpr int dq_smem() {
  using S = FlashShape<D>;
  return 4 * S::kRows * S::kLD + S::kRows * S::kPS + 2 * S::kRows;
}
template <int D>
constexpr int dkv_smem() {
  using S = FlashShape<D>;
  return 4 * S::kRows * S::kLD + 2 * S::kRows * S::kPS + 4 * S::kRows;
}
static_assert(dkv_smem<72>() * 4 <= 227 * 1024, "dk/dv tile too large");
static_assert(dkv_smem<128>() * 4 <= 227 * 1024, "dk/dv tile too large");
static_assert(dkv_smem<256>() * 4 <= 227 * 1024, "dk/dv tile too large");

// launch kernel on grid (tiles, heads, b) with `floats` of dynamic
// shared memory; returns the launch status
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int floats, int tiles, int heads, int b,
           cudaStream_t stream, Args... args) {
  const int bytes = floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(tiles, heads, b), kFlashThreads, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, const int* qseg,
        const int* kseg, void* out, float* lse, int b, int sq, int sk,
        int h, int hk, float scale, int causal, cudaStream_t st) {
  constexpr int BM = FlashShape<D>::kRows;
  return launch(flash_fwd_kernel<T, D>, fwd_smem<D>(), (sq + BM - 1) / BM,
                h, b, st, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v), qseg,
                kseg, static_cast<T*>(out), lse, sq, sk, h, hk, scale,
                causal);
}

template <typename T, int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int* qseg,
           const int* kseg, void* dq, int b, int sq, int sk, int h, int hk,
           float scale, int causal, cudaStream_t st) {
  constexpr int BM = FlashShape<D>::kRows;
  return launch(flash_bwd_dq_kernel<T, D>, dq_smem<D>(), (sq + BM - 1) / BM,
                h, b, st, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), lse, delta, qseg, kseg,
                static_cast<T*>(dq), sq, sk, h, hk, scale, causal);
}

template <typename T, int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, const int* qseg,
            const int* kseg, float* dk, float* dv, int b, int sq, int sk,
            int h, int hk, float scale, int causal, cudaStream_t st) {
  constexpr int BM = FlashShape<D>::kRows;
  return launch(flash_bwd_dkv_kernel<T, D>, dkv_smem<D>(),
                (sk + BM - 1) / BM, hk, b, st, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), lse, delta, qseg, kseg, dk, dv,
                sq, sk, h, hk, scale, causal);
}

bool shape_ok(int b, int sq, int sk, int h, int hk) {
  return b > 0 && sq > 0 && sk > 0 && hk > 0 && h % hk == 0 && h <= 65535;
}

// The backward's first pass: delta[b, h, s] = sum_d out * dout over the
// row (b, s, h) of [b, s, h, d] tensors, float32, one warp a row, as
// JAX computes it outside Pallas (flash_attention.py:398). One pass over
// out and dout in place of the plain version's casts, product, sum and
// transpose.
template <typename T>
__global__ void __launch_bounds__(256)
bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                 float* __restrict__ delta, int rows, int sq, int h, int d) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + (long long)row * d;
  const T* g = dout + (long long)row * d;
  float acc = 0.f;
  for (int i = 8 * lane; i < d; i += 256) {
    float a[8], c[8];
    load8(o + i, a);
    load8(g + i, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = fmaf(a[j], c[j], acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    const int hh = row % h, s = (row / h) % sq, bb = row / (h * sq);
    delta[((long long)bb * h + hh) * sq + s] = acc;
  }
}

int bwd_delta(int dtype, const void* out, const void* dout, float* delta,
              int b, int sq, int h, int d, cudaStream_t st) {
  if (d % 8 != 0) return kUnsupported;
  const int rows = b * sq * h;
  const unsigned grid = (unsigned)(((long long)rows * 32 + 255) / 256);
  if (dtype == kF32)
    bwd_delta_kernel<float><<<grid, 256, 0, st>>>(
        static_cast<const float*>(out), static_cast<const float*>(dout), delta,
        rows, sq, h, d);
  else if (dtype == kBF16)
    bwd_delta_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(out),
        static_cast<const __nv_bfloat16*>(dout), delta, rows, sq, h, d);
  else
    return kUnsupported;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace ptt

// Dispatch on dtype (0 float32, 1 bfloat16) and head_dim (64, 72, 128, 256)
// for the CUDA-core kernels above; what hopper_route takes never comes
// here: the entry points send it to the Hopper kernels
// (flash_attention_wg.cu), which walk the work list `sched`.
#define PTT_FLASH_DISPATCH(FN, ...)                                       \
  switch (dtype * 1000 + d) {                                             \
    case 64: return FN<float, 64>(__VA_ARGS__);                           \
    case 72: return FN<float, 72>(__VA_ARGS__);                           \
    case 128: return FN<float, 128>(__VA_ARGS__);                         \
    case 256: return FN<float, 256>(__VA_ARGS__);                         \
    case 1256: return FN<__nv_bfloat16, 256>(__VA_ARGS__);                \
    default: return kUnsupported;                                         \
  }

namespace ptt {
namespace {
// kernel 0 (forward), 1 (dq) or 2 (dk/dv) at dtype and head_dim d runs a
// Hopper kernel: bfloat16 at the head_dims flash_wg::takes names. The
// route depends on these alone: a call it names goes there or fails.
bool hopper_route(int kernel, int dtype, int d) {
  return dtype == kBF16 && flash_wg::takes(kernel, d);
}
}  // namespace
}  // namespace ptt

// q [b, sq, h, d], k/v [b, sk, hk, d] of dtype, contiguous; segment ids
// [b, sq] / [b, sk] int32 or both null. Writes out [b, sq, h, d] (dtype)
// and lse [b, h, sq] float32. The Hopper route (bfloat16 at head_dim 64,
// 72 and 128) also takes the work list sched (n_rows rows of 8 int32,
// built for tiles of bm own and bn streamed rows); the other routes ignore
// it. Returns 0, a cudaError_t, or -1 for an unsupported shape, type or
// work list.
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             const int* q_seg, const int* kv_seg, void* out,
                             float* lse, const int* sched, int b, int sq,
                             int sk, int h, int hk, int d, int dtype,
                             int causal, int n_rows, int bm, int bn,
                             float scale, void* stream) {
  using namespace ptt;
  if (!shape_ok(b, sq, sk, h, hk) || (q_seg == nullptr) != (kv_seg == nullptr))
    return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hopper_route(0, dtype, d))
    return flash_wg::fwd(d, q, k, v, q_seg, kv_seg, out, lse, sched, n_rows,
                         bm, bn, b, sq, sk, h, hk, scale, causal, st);
  PTT_FLASH_DISPATCH(fwd, q, k, v, q_seg, kv_seg, out, lse, b, sq, sk, h,
                     hk, scale, causal, st)
}

// The dq backward: dout like q, lse and delta [b, h, sq] float32; writes
// dq [b, sq, h, d] of dtype. With out (the forward's output, like q) the
// launch first writes delta = sum(out * dout, -1) itself.
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                float* delta, const void* out,
                                const int* q_seg, const int* kv_seg, void* dq,
                                const int* sched, int b, int sq, int sk,
                                int h, int hk, int d, int dtype, int causal,
                                int n_rows, int bm, int bn, float scale,
                                void* stream) {
  using namespace ptt;
  if (!shape_ok(b, sq, sk, h, hk) || (q_seg == nullptr) != (kv_seg == nullptr))
    return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out != nullptr)
    if (int e = bwd_delta(dtype, out, dout, delta, b, sq, h, d, st)) return e;
  if (hopper_route(1, dtype, d))
    return flash_wg::bwd_dq(d, q, k, v, dout, lse, delta, q_seg, kv_seg, dq,
                            sched, n_rows, bm, bn, b, sq, sk, h, hk, scale,
                            causal, st);
  PTT_FLASH_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, q_seg, kv_seg, dq, b,
                     sq, sk, h, hk, scale, causal, st)
}

// The dk/dv backward: writes dk, dv [b, sk, hk, d] float32, each summed
// over the kv-head's group of query heads. On the Hopper route a work
// list whose rows are pieces of key tiles also takes the workspace ws
// [2, n_slots, b, sk, hk, d] float32 and pieces [key tiles] int32 (see
// flash_wg::bwd_dkv); ws is null otherwise.
extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, const int* q_seg,
                                 const int* kv_seg, float* dk, float* dv,
                                 float* ws, const int* pieces,
                                 const int* sched, int b, int sq, int sk,
                                 int h, int hk, int d, int dtype, int causal,
                                 int n_rows, int bm, int bn, int n_slots,
                                 float scale, void* stream) {
  using namespace ptt;
  if (!shape_ok(b, sq, sk, h, hk) || (q_seg == nullptr) != (kv_seg == nullptr))
    return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hopper_route(2, dtype, d))
    return flash_wg::bwd_dkv(d, q, k, v, dout, lse, delta, q_seg, kv_seg, dk,
                             dv, ws, pieces, n_slots, sched, n_rows, bm, bn,
                             b, sq, sk, h, hk, scale, causal, st);
  if (ws != nullptr) return kUnsupported;
  PTT_FLASH_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, q_seg, kv_seg, dk,
                     dv, b, sq, sk, h, hk, scale, causal, st)
}

#undef PTT_FLASH_DISPATCH

// Registers a thread of the Hopper kernel 0 (forward), 1 (dq) or 2
// (dk/dv) at head_dim d, as built; -1 for a head_dim without one (256)
// or a failed query. Their setmaxnreg split needs 168.
extern "C" int ptt_flash_regs(int kernel, int d) {
  return ptt::flash_wg::regs(kernel, d);
}

// Dynamic shared memory in bytes of one block of kernel 0 (forward),
// 1 (dq) or 2 (dk/dv) for dtype at head_dim d; -1 for a pair not taken.
extern "C" int ptt_flash_smem_bytes(int kernel, int d, int dtype) {
  using namespace ptt;
  if (hopper_route(kernel, dtype, d)) return flash_wg::smem_bytes(kernel, d);
  if (dtype != kF32 && !(dtype == kBF16 && d == 256)) return kUnsupported;
  const int f = static_cast<int>(sizeof(float));
#define PTT_FLASH_SMEM(D)                                      \
  return f * (kernel == 0 ? fwd_smem<D>()                      \
                          : kernel == 1 ? dq_smem<D>() : dkv_smem<D>())
  switch (d) {
    case 64: PTT_FLASH_SMEM(64);
    case 72: PTT_FLASH_SMEM(72);
    case 128: PTT_FLASH_SMEM(128);
    case 256: PTT_FLASH_SMEM(256);
    default: return kUnsupported;
  }
#undef PTT_FLASH_SMEM
}
