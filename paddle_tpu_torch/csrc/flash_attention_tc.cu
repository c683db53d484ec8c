// Flash attention on the tensor cores (mma.sync m16n8k16, bfloat16 in,
// float32 accumulate) for bfloat16 q/k/v at head_dim 64 and 128: the
// training path's forward, dq and dk/dv kernels.
//
// Replaces, with flash_attention.cu (float32 inputs and head_dim 256 run
// there on CUDA cores), the TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py: _fwd_kernel (via _flash_fwd),
// _bwd_dq_kernel and _bwd_dkv_kernel (via _bwd_pair_call). The masking,
// causal alignment, GQA mapping, guarded softmax and outputs are those of
// flash_attention.cu's header comment; only the arithmetic differs:
// - the products take bfloat16 operands: q, k, v and dout as given, and
//   the probabilities p and ds rounded to bfloat16 for the second product
//   (p . V, ds . K, p^T . dO, ds^T . Q), as FlashAttention-2 does; every
//   sum, the softmax and the row statistics stay float32;
// - the forward scales the float32 scores after q . k (JAX scales q
//   before it: the same value, without a bfloat16 rounding of q * scale).
//
// What bounds it on an H100: operations (see flash_attention.cu); these
// kernels move the products from the 67 TFLOP/s of CUDA-core float32 to
// the tensor cores (mma.sync; wgmma would be the next step).
//
// Design (simple form):
// - 4 warps per block, each warp owns 16 rows of the block's tile:
//   forward and dq: 64 query rows, key tiles of 64; dk/dv: 64 key rows,
//   query tiles of 32 (dk and dv accumulate in registers for the whole
//   block, so the query tile is kept small).
// - tiles staged in shared memory as bfloat16, rows padded by 8 elements
//   so the fragment loads of a warp hit 32 distinct banks; p and ds go
//   through shared memory (each warp its own rows) on their way from the
//   accumulator layout to the A-operand layout.
// - the GQA group is summed inside the dk/dv block, in a fixed order: two
//   runs on the same inputs are bit-identical.
// Not done here: ldmatrix, cp.async/TMA double buffering, wgmma, keeping p
// in registers between the two products, a causal-balanced schedule.

#include "flash_attention.cuh"

namespace ptt {
namespace flash_tc {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps, 16 rows each
constexpr int kRows = 64;      // rows of the block's own tile
constexpr int kDkvQ = 32;      // query rows per step of dk/dv

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// A operand (16 x 16) from row-major M: rows r0.., columns k0..
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* m,
                                       int ld, int r0, int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = m + (r0 + (lane >> 2)) * ld + k0 + (lane & 3) * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B operand (16 x 8) with B[k][n] = M[n0 + n][k0 + k] (M row-major)
__device__ __forceinline__ void frag_b_nk(uint32_t& b0, uint32_t& b1,
                                          const bf16* m, int ld, int n0,
                                          int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = m + (n0 + (lane >> 2)) * ld + k0 + (lane & 3) * 2;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B operand (16 x 8) with B[k][n] = M[k0 + k][n0 + n] (M row-major)
__device__ __forceinline__ void frag_b_kn(uint32_t& b0, uint32_t& b1,
                                          const bf16* m, int ld, int k0,
                                          int n0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = m + (k0 + (lane & 3) * 2) * ld + n0 + (lane >> 2);
  b0 = pack2(p[0], p[ld]);
  b1 = pack2(p[8 * ld], p[9 * ld]);
}

// rows [r0, r0 + R) of one head of a [b, s, heads, D] bfloat16 tensor
// (src at row 0 of that head) into dst[R][ld]; rows past s are zeros
template <int D, int R>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long row_stride, int r0,
                                          int s) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < s)
      v = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

template <int R>
__device__ __forceinline__ void load_seg(int* dst, const int* seg, int r0,
                                         int s) {
  for (int i = threadIdx.x; i < R; i += kThreads)
    dst[i] = r0 + i < s ? seg[r0 + i] : -1;
}

// reductions over the 4 lanes of a quad, which share an accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// shared memory layouts, in bfloat16 elements unless noted
template <int D>
struct Smem {
  static constexpr int kLD = D + 8;       // a [rows, D] tile's row stride
  static constexpr int kLP = kRows + 8;   // a [64, 64] score tile
  static constexpr int kLQ = kDkvQ + 8;   // a [64, 32] score tile (dk/dv)
  static constexpr int kTile = kRows * kLD;
  static constexpr int fwd_bytes =
      2 * (3 * kTile + kRows * kLP) + 4 * 2 * kRows;
  static constexpr int dq_bytes =
      2 * (4 * kTile + kRows * kLP) + 4 * 2 * kRows;
  static constexpr int dkv_bytes =
      2 * (2 * kTile + 2 * kDkvQ * kLD + 2 * kRows * kLQ) +
      4 * (3 * kDkvQ + kRows);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const int* __restrict__ qseg,
           const int* __restrict__ kseg, bf16* __restrict__ out,
           float* __restrict__ lse, int sq, int sk, int h, int hk,
           float scale, int causal) {
  using L = Smem<D>;
  constexpr int LD = L::kLD, LP = L::kLP, NT = D / 8, KS = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + L::kTile;
  bf16* vs = ks + L::kTile;
  bf16* ps = vs + L::kTile;
  int* qsg = reinterpret_cast<int*>(ps + kRows * LP);
  int* ksg = qsg + kRows;

  const int q0 = blockIdx.x * kRows, hh = blockIdx.y, bi = blockIdx.z;
  const int hkv = hh / (h / hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = warp * 16;  // the warp's first row
  const bool seg = qseg != nullptr;
  const long long kstride = (long long)hk * D;
  const bf16* kb = k + ((long long)bi * sk * hk + hkv) * D;
  const bf16* vb = v + ((long long)bi * sk * hk + hkv) * D;

  load_tile<D, kRows>(qs, LD, q + ((long long)bi * sq * h + hh) * D,
                      (long long)h * D, q0, sq);
  if (seg) load_seg<kRows>(qsg, qseg + (long long)bi * sq, q0, sq);
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) frag_a(qf[kk], qs, LD, w0, kk * 16);

  float o[NT][4], m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  const int nk = key_tiles(q0, kRows, sq, sk, kRows, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();
    load_tile<D, kRows>(ks, LD, kb, kstride, k0, sk);
    load_tile<D, kRows>(vs, LD, vb, kstride, k0, sk);
    if (seg) load_seg<kRows>(ksg, kseg + (long long)bi * sk, k0, sk);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b0, b1;
        frag_b_nk(b0, b1, ks, LD, j * 8, kk * 16);
        mma(s[j], qf[kk], b0, b1);
      }
    }
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = w0 + g + (e >> 1) * 8, cl = j * 8 + t * 2 + (e & 1);
        float x = s[j][e] * scale;
        if (!visible(q0 + rl, k0 + cl, sq, sk, causal, seg,
                     seg ? qsg[rl] : 0, seg ? ksg[cl] : 0))
          x = kMasked;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) m_new[i] = fmaxf(m[i], quad_max(mx[i]));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p =
            s[j][e] > kMasked * 0.5f ? expf(s[j][e] - m_new[i]) : 0.f;
        sum[i] += p;
        ps[(w0 + g + i * 8) * LP + j * 8 + t * 2 + (e & 1)] =
            __float2bfloat16(p);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float corr = expf(m[i] - m_new[i]);
      l[i] = l[i] * corr + quad_sum(sum[i]);
      m[i] = m_new[i];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][2 * i] *= corr;
        o[j][2 * i + 1] *= corr;
      }
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t a[4];
      frag_a(a, ps, LP, w0, kk * 16);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b0, b1;
        frag_b_kn(b0, b1, vs, LD, kk * 16, j * 8);
        mma(o[j], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + w0 + g + i * 8;
    if (r >= sq) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    bf16* orow = out + (((long long)bi * sq + r) * h + hh) * D + t * 2;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack2(__float2bfloat16(o[j][2 * i] / ls),
                __float2bfloat16(o[j][2 * i + 1] / ls));
    if (t == 0) lse[((long long)bi * h + hh) * sq + r] = m[i] + logf(ls);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const int* __restrict__ qseg, const int* __restrict__ kseg,
          bf16* __restrict__ dq, int sq, int sk, int h, int hk, float scale,
          int causal) {
  using L = Smem<D>;
  constexpr int LD = L::kLD, LP = L::kLP, NT = D / 8, KS = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + L::kTile;
  bf16* ks = dos + L::kTile;
  bf16* vs = ks + L::kTile;
  bf16* dss = vs + L::kTile;
  int* qsg = reinterpret_cast<int*>(dss + kRows * LP);
  int* ksg = qsg + kRows;

  const int q0 = blockIdx.x * kRows, hh = blockIdx.y, bi = blockIdx.z;
  const int hkv = hh / (h / hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = warp * 16;
  const bool seg = qseg != nullptr;
  const long long qoff = ((long long)bi * sq * h + hh) * D;
  const long long kstride = (long long)hk * D;
  const bf16* kb = k + ((long long)bi * sk * hk + hkv) * D;
  const bf16* vb = v + ((long long)bi * sk * hk + hkv) * D;

  load_tile<D, kRows>(qs, LD, q + qoff, (long long)h * D, q0, sq);
  load_tile<D, kRows>(dos, LD, dout + qoff, (long long)h * D, q0, sq);
  if (seg) load_seg<kRows>(qsg, qseg + (long long)bi * sq, q0, sq);
  float lse_r[2], del_r[2], acc[NT][4];
  const long long row0 = ((long long)bi * h + hh) * sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + w0 + g + i * 8;
    lse_r[i] = r < sq ? lse[row0 + r] : 0.f;
    del_r[i] = r < sq ? delta[row0 + r] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int nk = key_tiles(q0, kRows, sq, sk, kRows, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();
    load_tile<D, kRows>(ks, LD, kb, kstride, k0, sk);
    load_tile<D, kRows>(vs, LD, vb, kstride, k0, sk);
    if (seg) load_seg<kRows>(ksg, kseg + (long long)bi * sk, k0, sk);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4], ado[4];
      frag_a(aq, qs, LD, w0, kk * 16);
      frag_a(ado, dos, LD, w0, kk * 16);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        frag_b_nk(b0, b1, ks, LD, j * 8, kk * 16);
        mma(s[j], aq, b0, b1);
        frag_b_nk(b0, b1, vs, LD, j * 8, kk * 16);
        mma(dp[j], ado, b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int rl = w0 + g + i * 8, cl = j * 8 + t * 2 + (e & 1);
        float x = s[j][e] * scale;
        if (!visible(q0 + rl, k0 + cl, sq, sk, causal, seg,
                     seg ? qsg[rl] : 0, seg ? ksg[cl] : 0))
          x = kMasked;
        const float p = x > kMasked * 0.5f ? expf(x - lse_r[i]) : 0.f;
        dss[rl * LP + cl] = __float2bfloat16(p * (dp[j][e] - del_r[i]) * scale);
      }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t a[4];
      frag_a(a, dss, LP, w0, kk * 16);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b0, b1;
        frag_b_kn(b0, b1, ks, LD, kk * 16, j * 8);
        mma(acc[j], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + w0 + g + i * 8;
    if (r >= sq) continue;
    bf16* orow = dq + (((long long)bi * sq + r) * h + hh) * D + t * 2;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack2(__float2bfloat16(acc[j][2 * i]),
                __float2bfloat16(acc[j][2 * i + 1]));
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int* __restrict__ qseg, const int* __restrict__ kseg,
           float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
           int h, int hk, float scale, int causal) {
  using L = Smem<D>;
  constexpr int LD = L::kLD, LQ = L::kLQ, NT = D / 8, KS = D / 16;
  constexpr int BQ = kDkvQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + L::kTile;
  bf16* qs = vs + L::kTile;
  bf16* dos = qs + BQ * LD;
  bf16* pts = dos + BQ * LD;   // p^T [key][query]
  bf16* dsts = pts + kRows * LQ;
  float* lse_s = reinterpret_cast<float*>(dsts + kRows * LQ);
  float* del_s = lse_s + BQ;
  int* qsg = reinterpret_cast<int*>(del_s + BQ);
  int* ksg = qsg + BQ;

  const int k0 = blockIdx.x * kRows, hkv = blockIdx.y, bi = blockIdx.z;
  const int group = h / hk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = warp * 16;  // the warp's first key row
  const bool seg = qseg != nullptr;
  const long long koff = ((long long)bi * sk * hk + hkv) * D;
  const long long qstride = (long long)h * D;

  load_tile<D, kRows>(ks, LD, k + koff, (long long)hk * D, k0, sk);
  load_tile<D, kRows>(vs, LD, v + koff, (long long)hk * D, k0, sk);
  if (seg) load_seg<kRows>(ksg, kseg + (long long)bi * sk, k0, sk);

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int nq = (sq + BQ - 1) / BQ;
  // the first query tile whose last row can see this key tile
  const int first = causal ? max(k0 - (sk - sq), 0) / BQ : 0;
  for (int gi = 0; gi < group; ++gi) {
    const int hh = hkv * group + gi;
    const long long qoff = ((long long)bi * sq * h + hh) * D;
    const long long row0 = ((long long)bi * h + hh) * sq;
    for (int qt = first; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_tile<D, BQ>(qs, LD, q + qoff, qstride, q0, sq);
      load_tile<D, BQ>(dos, LD, dout + qoff, qstride, q0, sq);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const bool in = q0 + i < sq;
        lse_s[i] = in ? lse[row0 + q0 + i] : 0.f;
        del_s[i] = in ? delta[row0 + q0 + i] : 0.f;
      }
      if (seg) load_seg<BQ>(qsg, qseg + (long long)bi * sq, q0, sq);
      __syncthreads();

      // s^T and dp^T: [16 keys of the warp, 32 queries]
      float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ak[4], av[4];
        frag_a(ak, ks, LD, w0, kk * 16);
        frag_a(av, vs, LD, w0, kk * 16);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          uint32_t b0, b1;
          frag_b_nk(b0, b1, qs, LD, j * 8, kk * 16);
          mma(st[j], ak, b0, b1);
          frag_b_nk(b0, b1, dos, LD, j * 8, kk * 16);
          mma(dpt[j], av, b0, b1);
        }
      }
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = w0 + g + (e >> 1) * 8;   // key row of the tile
          const int ql = j * 8 + t * 2 + (e & 1);  // query row of the step
          float x = st[j][e] * scale;
          if (!visible(q0 + ql, k0 + kl, sq, sk, causal, seg,
                       seg ? qsg[ql] : 0, seg ? ksg[kl] : 0))
            x = kMasked;
          const float p = x > kMasked * 0.5f ? expf(x - lse_s[ql]) : 0.f;
          pts[kl * LQ + ql] = __float2bfloat16(p);
          dsts[kl * LQ + ql] =
              __float2bfloat16(p * (dpt[j][e] - del_s[ql]) * scale);
        }
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t ap[4], ad[4];
        frag_a(ap, pts, LQ, w0, kk * 16);
        frag_a(ad, dsts, LQ, w0, kk * 16);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t b0, b1;
          frag_b_kn(b0, b1, dos, LD, kk * 16, j * 8);
          mma(dva[j], ap, b0, b1);
          frag_b_kn(b0, b1, qs, LD, kk * 16, j * 8);
          mma(dka[j], ad, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = k0 + w0 + g + i * 8;
    if (c >= sk) continue;
    const long long o = (((long long)bi * sk + c) * hk + hkv) * D + t * 2;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<float2*>(dk + o + j * 8) =
          make_float2(dka[j][2 * i], dka[j][2 * i + 1]);
      *reinterpret_cast<float2*>(dv + o + j * 8) =
          make_float2(dva[j][2 * i], dva[j][2 * i + 1]);
    }
  }
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int bytes, int tiles, int heads, int b,
           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(tiles, heads, b), kThreads, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int fwd(int d, const void* q, const void* k, const void* v, const int* qseg,
        const int* kseg, void* out, float* lse, int b, int sq, int sk, int h,
        int hk, float scale, int causal, cudaStream_t st) {
  const int tiles = (sq + kRows - 1) / kRows;
#define PTT_TC_FWD(D)                                                       \
  launch(fwd_kernel<D>, Smem<D>::fwd_bytes, tiles, h, b, st,                \
         static_cast<const bf16*>(q), static_cast<const bf16*>(k),          \
         static_cast<const bf16*>(v), qseg, kseg, static_cast<bf16*>(out), \
         lse, sq, sk, h, hk, scale, causal)
  if (d == 64) return PTT_TC_FWD(64);
  if (d == 128) return PTT_TC_FWD(128);
#undef PTT_TC_FWD
  return kUnsupported;
}

int bwd_dq(int d, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* delta,
           const int* qseg, const int* kseg, void* dq, int b, int sq, int sk,
           int h, int hk, float scale, int causal, cudaStream_t st) {
  const int tiles = (sq + kRows - 1) / kRows;
#define PTT_TC_DQ(D)                                                      \
  launch(dq_kernel<D>, Smem<D>::dq_bytes, tiles, h, b, st,                \
         static_cast<const bf16*>(q), static_cast<const bf16*>(k),        \
         static_cast<const bf16*>(v), static_cast<const bf16*>(dout),     \
         lse, delta, qseg, kseg, static_cast<bf16*>(dq), sq, sk, h, hk,   \
         scale, causal)
  if (d == 64) return PTT_TC_DQ(64);
  if (d == 128) return PTT_TC_DQ(128);
#undef PTT_TC_DQ
  return kUnsupported;
}

int bwd_dkv(int d, const void* q, const void* k, const void* v,
            const void* dout, const float* lse, const float* delta,
            const int* qseg, const int* kseg, float* dk, float* dv, int b,
            int sq, int sk, int h, int hk, float scale, int causal,
            cudaStream_t st) {
  const int tiles = (sk + kRows - 1) / kRows;
#define PTT_TC_DKV(D)                                                      \
  launch(dkv_kernel<D>, Smem<D>::dkv_bytes, tiles, hk, b, st,              \
         static_cast<const bf16*>(q), static_cast<const bf16*>(k),         \
         static_cast<const bf16*>(v), static_cast<const bf16*>(dout),      \
         lse, delta, qseg, kseg, dk, dv, sq, sk, h, hk, scale, causal)
  if (d == 64) return PTT_TC_DKV(64);
  if (d == 128) return PTT_TC_DKV(128);
#undef PTT_TC_DKV
  return kUnsupported;
}

int smem_bytes(int kernel, int d) {
#define PTT_TC_SMEM(D)                                                  \
  (kernel == 0 ? Smem<D>::fwd_bytes                                     \
               : kernel == 1 ? Smem<D>::dq_bytes : Smem<D>::dkv_bytes)
  if (d == 64) return PTT_TC_SMEM(64);
  if (d == 128) return PTT_TC_SMEM(128);
#undef PTT_TC_SMEM
  return kUnsupported;
}

}  // namespace flash_tc
}  // namespace ptt
