// Flash attention for Hopper (sm_90a) with wgmma, TMA and an mbarrier
// ring: the training path's forward, dq and dk/dv kernels for bfloat16
// q/k/v at head_dim 64 and 128.
//
// Replaces, with flash_attention.cu (float32 inputs and head_dim 256 run
// there on CUDA cores), the TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py:
//   _fwd_kernel (:69, called :157 by _flash_fwd)          -> fwd_kernel
//   _bwd_dq_kernel (:174, called :326 by _bwd_pair_call)  -> dq_kernel
//   _bwd_dkv_kernel (:229, called :358 by _bwd_pair_call) -> dkv_kernel
// The masking, causal alignment (row r sees column c iff r + (sk - sq) >=
// c), GQA mapping, segment ids, guarded softmax (finite -1e30, rows that
// see no key give 0 and lse -1e30 + log 1e-30) and outputs are those of
// flash_attention.cu's header comment. The products take bfloat16
// operands (q, k, v, dout as given; p and ds rounded to bfloat16 for the
// second product); every sum, the softmax and the row statistics stay
// float32. The softmax runs in base 2 (scale folded into log2 e).
//
// What bounds them on an H100: operations. At llama_mid (b 4, s 2048,
// h 16, kv 8, d 128, causal) the forward does ~69 GFLOP for ~34 MB; the
// bfloat16 tensor cores (989 TFLOP/s) are the limit, and only wgmma
// reaches their full rate.
//
// Design (hopper.cuh holds the PTX):
// - a persistent grid, one CTA per SM, walking the work list that
//   ops/cuda/flash_attention.py builds (flash_schedule): one row per
//   (batch, head, own tile) with the streamed tiles [lo, hi) it must
//   visit and the mask-free ones [free_lo, free_hi), longest rows first;
//   CTA c takes rows c, c + grid, ..., every other round walked backwards
//   (row_of), so the causal rows spread evenly, and every run does the
//   same sums in the same order.
// - 384 threads: warpgroup 0 is the producer (one warp issues the TMA
//   loads; setmaxnreg hands its registers to the consumers), warpgroups
//   1 and 2 consume, 64 rows of the own tile each.
// - the own tile (forward and dq: 128 query rows of Q (and dO); dk/dv:
//   128 key rows of K and V) is loaded once per row of the list; the
//   streamed tiles (forward: 128 keys; dq: 64 keys; dk/dv: 64 queries)
//   go through a ring of 3 stages at head_dim 128 (4 at 64), each with a
//   full/empty mbarrier pair. TMA zero-fills rows past s.
// - first products (S = Q K^T, dP = dO V^T, and the transposed S^T = K
//   Q^T, dP^T = V dO^T of dk/dv) are wgmma with both operands in shared
//   memory, K-major; the probabilities stay in registers and feed the
//   second product (P V, dS K, P^T dO, dS^T Q) as wgmma's register A
//   operand against an MN-major B.
// - the forward and dq issue a tile's first products together with the
//   previous tile's second product, and run the tile's softmax (or dS)
//   while that second product finishes. dk/dv cannot (dK, dV, S^T and
//   dP^T would not fit the registers): the other consumer warpgroup
//   keeps the tensor cores busy meanwhile.
// - the per-element mask is a separate, compile-time copy of the softmax
//   run only on tiles outside [free_lo, free_hi): the causal diagonal,
//   ragged edges, and every tile when segmented. exp2 is MUFU's
//   ex2.approx.ftz: the library exp2f's denormal handling cost a third
//   of the forward.
// - dk/dv sum the GQA group inside the CTA in a fixed order and there
//   are no atomics: two runs are bit-identical. A dk/dv list with fewer
//   rows than SMs (the ring's 1024-row blocks) comes cut into pieces of
//   each row's query tiles; a piece writes its float32 partial dK/dV to
//   its own workspace slot and dkv_piece_sum adds the slots in piece
//   order.
// - setmaxnreg 24/240 over 384 threads waits forever unless the launch
//   holds 168 registers a thread: launch() reads each kernel's numRegs
//   once and refuses (kShortRegisters) a build with fewer, so the call
//   raises instead of hanging.

#include <atomic>
#include <type_traits>

#include "flash_attention.cuh"
#include "hopper.cuh"

namespace ptt {

namespace hopper {

int encode_bshd(CUtensorMap* map, const void* base, int b, int s, int heads,
                int d, int rows) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
      const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
      const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
      CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)s * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hopper

namespace flash_wg {
namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kWG = 128;           // threads of a warpgroup
constexpr int kThreads = 3 * kWG;  // producer + two consumers
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// registers a thread the setmaxnreg split hands out: 24 to the producer
// warpgroup and 240 to each consumer must fit what the launch holds
constexpr int kLaunchRegs =
    (kProducerRegs * kWG + kConsumerRegs * 2 * kWG) / kThreads;
static_assert(kLaunchRegs * kThreads ==
                  kProducerRegs * kWG + kConsumerRegs * 2 * kWG,
              "setmaxnreg split does not divide evenly");

// one row of the work list: 8 int32 (see flash_schedule); piece is the
// row's slot in the dk/dv workspace of a split list (0 otherwise)
struct Work {
  int b, head, tile, lo, hi, free_lo, free_hi, piece;
};

__device__ __forceinline__ Work load_work(const int* sched, int i) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(sched) + 2 * i);
  const int4 c = __ldg(reinterpret_cast<const int4*>(sched) + 2 * i + 1);
  return {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
}

// the k-th row of the work list this CTA takes: rows c, c + grid, ... in
// rounds, every other round walked backwards (c' = grid - 1 - c), so the
// long rows at the head of the list spread evenly over the CTAs. Fixed
// for a given grid, so every run does the same sums in the same order.
__device__ __forceinline__ int row_of(int k) {
  const int g = gridDim.x, c = blockIdx.x;
  return k * g + ((k & 1) ? g - 1 - c : c);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// an m64nN accumulator as N / 16 register A fragments (k16 each); for
// bfloat16 the layouts line up without a permutation
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&p)[N / 2],
                                         uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(p[8 * kk + 0], p[8 * kk + 1]);
    a[kk][1] = pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);
    a[kk][2] = pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);
    a[kk][3] = pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);
  }
}

// 2^x on the MUFU unit, denormal results flushed to 0 (a probability
// below 2^-126 of the row max adds nothing to a float32 sum)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// K-major operand: k step kk (16 columns) of a [ROWS, D] tile whose
// 64-wide boxes are ROWS * 128 bytes apart; addr may start at a row
// inside the first box (a warpgroup's 64 rows)
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor(uint32_t addr, int kk) {
  return desc_sw128(addr + (kk >> 2) * ROWS * 128 + (kk & 3) * 32, 16,
                    1024);
}
// MN-major B operand: k step kk (16 rows) of a [ROWS, D] tile at addr
template <int ROWS>
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr, int kk) {
  return desc_sw128(addr + kk * 2048, ROWS * 128, 1024);
}

// thread coordinates inside the consumer warpgroups
struct Lane {
  int wg, lane, t, rw;  // rw: own-tile row of d[0] (d[2] is rw + 8)
  __device__ __forceinline__ Lane() {
    const int ct = threadIdx.x - kWG;
    wg = ct >> 7;
    lane = ct & 31;
    t = lane & 3;
    rw = wg * 64 + ((ct >> 5) & 3) * 16 + (lane >> 2);
  }
};

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// shared memory: the own tile(s), the ring, per-stage side rows, barriers
template <int D, int BM, int BN, int S, int OWN, int STREAM, int SIDE>
struct Layout {
  static constexpr int kOwnTile = BM * D * 2;     // bytes of one own tile
  static constexpr int kStreamTile = BN * D * 2;  // one streamed tile
  static constexpr int kStage = STREAM * kStreamTile;
  static constexpr int kRing = OWN * kOwnTile;
  static constexpr int kSide = kRing + S * kStage;  // SIDE int arrays [S][BN]
  static constexpr int kBar = kSide + S * SIDE * BN * 4;
  static constexpr int kBytes = kBar + (4 * S + 2) * 8 + 1024;
  static_assert(kBytes <= 227 * 1024, "shared memory over 227 KB");
};

template <int D>
struct Fwd {
  static constexpr int BM = 128, BN = 128, S = D == 64 ? 4 : 3;
  using L = Layout<D, BM, BN, S, 1, 2, 1>;
};
template <int D>
struct Dq {
  static constexpr int BM = 128, BN = 64, S = D == 64 ? 4 : 3;
  using L = Layout<D, BM, BN, S, 2, 2, 1>;
};
template <int D>
struct Dkv {
  static constexpr int BM = 128, BN = 64, S = D == 64 ? 4 : 3;
  using L = Layout<D, BM, BN, S, 2, 2, 3>;
};

// bars: full[S], empty[S], own full, own empty, and for the forward's
// separate V ring full_v[S], empty_v[S]
template <int S>
__device__ __forceinline__ void init_barriers(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + s, 32);             // full: the producer warp
      mbar_init(bars + S + s, 8);          // empty: the consumer warps
      mbar_init(bars + 2 * S + 2 + s, 1);  // full_v: its TMA thread
      mbar_init(bars + 3 * S + 2 + s, 8);  // empty_v
    }
    mbar_init(bars + 2 * S, 1);      // own tile loaded
    mbar_init(bars + 2 * S + 1, 8);  // own tile released
    mbar_fence_init();
  }
  __syncthreads();
}

// ---- forward ---------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const int* __restrict__ sched, int n_rows,
           const int* __restrict__ qseg, const int* __restrict__ kseg,
           bf16* __restrict__ out, float* __restrict__ lse, int sq, int sk,
           int h, int hk, float scale, int causal) {
  using C = Fwd<D>;
  using L = typename C::L;
  constexpr int BM = C::BM, BN = C::BN, S = C::S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + S;
  uint64_t* own_full = full + 2 * S;
  uint64_t* own_empty = own_full + 1;
  uint64_t* full_v = own_empty + 1;  // K and V ride separate rings
  uint64_t* empty_v = full_v + S;
  int* sseg = reinterpret_cast<int*>(sm + L::kSide);
  const bool seg = qseg != nullptr;
  init_barriers<S>(full);

  if (threadIdx.x < kWG) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
    }
    int n = 0, no = 0;
    for (int k = 0, i = row_of(0); i < n_rows; i = row_of(++k)) {
      const Work w = load_work(sched, i);
      if (w.hi <= w.lo) continue;
      mbar_wait(own_empty, (no & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(own_full, L::kOwnTile);
        tma_load_tile<D, BM>(sm, &tq, own_full, w.head, w.tile * BM, w.b);
      }
      ++no;
      const int hkv = w.head / (h / hk);
      // V of tile m into stage m % S, issued after K of tile m + 1: the
      // order in which the consumers need them
      auto load_v = [&](int m, int kt) {
        const int st = m % S;
        mbar_wait(empty_v + st, ((m / S) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_tx(full_v + st, L::kStreamTile);
          tma_load_tile<D, BN>(sm + L::kRing + st * L::kStage +
                                   L::kStreamTile,
                               &tv, full_v + st, hkv, kt * BN, w.b);
        }
      };
      for (int kt = w.lo; kt < w.hi; ++kt, ++n) {
        const int st = n % S;
        mbar_wait(empty + st, ((n / S) & 1) ^ 1);
        if (seg)
          for (int c = lane; c < BN; c += 32) {
            const int col = kt * BN + c;
            sseg[st * BN + c] =
                col < sk ? kseg[(long long)w.b * sk + col] : -1;
          }
        if (lane == 0) {
          mbar_arrive_tx(full + st, L::kStreamTile);
          tma_load_tile<D, BN>(sm + L::kRing + st * L::kStage, &tk,
                               full + st, hkv, kt * BN, w.b);
        } else {
          mbar_arrive(full + st);
        }
        if (kt > w.lo) load_v(n - 1, kt - 1);
      }
      load_v(n - 1, w.hi - 1);
    }
    return;
  }

  // consumers
  setmaxnreg_inc<kConsumerRegs>();
  const Lane ln;
  const float sl2 = scale * kLog2e;
  const uint32_t q_s = smem_u32(sm) + ln.wg * 64 * 128;
  int n = 0, no = 0;
  for (int k = 0, i = row_of(0); i < n_rows; i = row_of(++k)) {
    const Work w = load_work(sched, i);
    const int q0 = w.tile * BM;
    float o[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
    float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
    int qs[2] = {0, 0};
    if (seg)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = q0 + ln.rw + 8 * rr;
        qs[rr] = r < sq ? qseg[(long long)w.b * sq + r] : -1;
      }
    if (w.hi > w.lo) {
      mbar_wait(own_full, no & 1);
      float s[BN / 2];
      uint32_t pa[BN / 16][4];
      // S = Q K^T of the tile in stage st into s (one commit group)
      auto issue_s = [&](int st) {
        const uint32_t k_s = smem_u32(sm + L::kRing + st * L::kStage);
        wgmma_ss_z<BN, 0>(s, kmajor<BM>(q_s, 0), kmajor<BN>(k_s, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss<BN, 0>(s, kmajor<BM>(q_s, kk), kmajor<BN>(k_s, kk), 1);
        wgmma_commit();
      };
      // O += P V of the tile in stage st (one commit group)
      auto issue_pv = [&](int st) {
        const uint32_t v_s =
            smem_u32(sm + L::kRing + st * L::kStage) + L::kStreamTile;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<D, 1>(o, pa[kk], mnmajor<BN>(v_s, kk), 1);
        wgmma_commit();
      };
      // the online softmax of key tile kt (stage st) on s: scores in
      // log2 units, masked where the tile needs it; the new row max into
      // m, p = exp2(s - m) into s, the rescale of the old sums into corr
      auto softmax_t = [&](int kt, int st, float (&corr)[2], auto masked) {
        constexpr bool mask = decltype(masked)::value;
        float mx[2] = {m[0], m[1]};
        if constexpr (mask) {
          const int k0 = kt * BN;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = 8 * j + 2 * ln.t + (e & 1);
              float x = s[4 * j + e] * sl2;
              if (!visible(q0 + ln.rw + 8 * (e >> 1), k0 + c, sq, sk, causal,
                           seg, qs[e >> 1], seg ? sseg[st * BN + c] : 0))
                x = kMasked;
              s[4 * j + e] = x;
              mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        } else {
          float raw[2] = {s[0], s[2]};
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              raw[e >> 1] = fmaxf(raw[e >> 1], s[4 * j + e]);
          mx[0] = fmaxf(mx[0], raw[0] * sl2);
          mx[1] = fmaxf(mx[1], raw[1] * sl2);
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          mx[rr] = quad_max(mx[rr]);
          corr[rr] = exp2_ftz(m[rr] - mx[rr]);
          m[rr] = mx[rr];
        }
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = e >> 1;
            float p;
            if constexpr (mask)
              p = s[4 * j + e] > kMasked * 0.5f
                      ? exp2_ftz(s[4 * j + e] - m[rr])
                      : 0.f;
            else
              p = exp2_ftz(fmaf(s[4 * j + e], sl2, -m[rr]));
            s[4 * j + e] = p;
            sum[rr] += p;
          }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * corr[rr] + sum[rr];
      };
      auto softmax = [&](int kt, int st, float (&corr)[2]) {
        if (kt < w.free_lo || kt >= w.free_hi)
          softmax_t(kt, st, corr, std::true_type{});
        else
          softmax_t(kt, st, corr, std::false_type{});
      };

      // tile lo alone, then each later tile's S overlaps the previous
      // tile's P V on the tensor cores, and its softmax runs while that
      // P V finishes
      int st = n % S;
      float corr[2];
      mbar_wait(full + st, (n / S) & 1);
      wgmma_fence();
      issue_s(st);
      wgmma_wait<0>();
      fence_regs(s);
      if (w.lo == w.hi - 1) release(own_empty, ln.lane);
      softmax(w.lo, st, corr);  // o is still 0: nothing to rescale
      release(empty + st, ln.lane);  // K done; the mask read its side row
      acc_to_a<BN>(s, pa);
      for (int kt = w.lo + 1; kt < w.hi; ++kt) {
        const int prev = st;
        ++n;
        st = n % S;
        mbar_wait(full + st, (n / S) & 1);
        mbar_wait(full_v + prev, ((n - 1) / S) & 1);
        fence_regs(o);
        fence_regs(pa);
        wgmma_fence();
        issue_s(st);
        issue_pv(prev);
        wgmma_wait<1>();
        fence_regs(s);
        if (kt == w.hi - 1) release(own_empty, ln.lane);
        softmax(kt, st, corr);
        release(empty + st, ln.lane);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        release(empty_v + prev, ln.lane);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j + 0] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }
        acc_to_a<BN>(s, pa);
      }
      mbar_wait(full_v + st, (n / S) & 1);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      issue_pv(st);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      release(empty_v + st, ln.lane);
      ++n;
      ++no;
    }

    float lt[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) lt[rr] = quad_sum(l[rr]);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = q0 + ln.rw + 8 * rr;
      if (r >= sq) continue;
      const float ls = fmaxf(lt[rr], 1e-30f);
      const float inv = 1.f / ls;
      bf16* orow = out + (((long long)w.b * sq + r) * h + w.head) * D +
                   2 * ln.t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(o[4 * j + 2 * rr] * inv, o[4 * j + 2 * rr + 1] * inv);
      if (ln.t == 0)
        lse[((long long)w.b * h + w.head) * sq + r] =
            (m[rr] > kMasked * 0.5f ? m[rr] * kLn2 : kMasked) + logf(ls);
    }
  }
}

// ---- dq --------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const int* __restrict__ sched, int n_rows,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const int* __restrict__ qseg, const int* __restrict__ kseg,
          bf16* __restrict__ dq, int sq, int sk, int h, int hk, float scale,
          int causal) {
  using C = Dq<D>;
  using L = typename C::L;
  constexpr int BM = C::BM, BN = C::BN, S = C::S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + S;
  uint64_t* own_full = full + 2 * S;
  uint64_t* own_empty = own_full + 1;
  int* sseg = reinterpret_cast<int*>(sm + L::kSide);
  const bool seg = qseg != nullptr;
  init_barriers<S>(full);

  if (threadIdx.x < kWG) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tdo);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
    }
    int n = 0, no = 0;
    for (int k = 0, i = row_of(0); i < n_rows; i = row_of(++k)) {
      const Work w = load_work(sched, i);
      if (w.hi <= w.lo) continue;
      mbar_wait(own_empty, (no & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(own_full, 2 * L::kOwnTile);
        tma_load_tile<D, BM>(sm, &tq, own_full, w.head, w.tile * BM, w.b);
        tma_load_tile<D, BM>(sm + L::kOwnTile, &tdo, own_full, w.head,
                             w.tile * BM, w.b);
      }
      ++no;
      const int hkv = w.head / (h / hk);
      for (int kt = w.lo; kt < w.hi; ++kt, ++n) {
        const int st = n % S;
        mbar_wait(empty + st, ((n / S) & 1) ^ 1);
        if (seg)
          for (int c = lane; c < BN; c += 32) {
            const int col = kt * BN + c;
            sseg[st * BN + c] =
                col < sk ? kseg[(long long)w.b * sk + col] : -1;
          }
        if (lane == 0) {
          uint8_t* base = sm + L::kRing + st * L::kStage;
          mbar_arrive_tx(full + st, L::kStage);
          tma_load_tile<D, BN>(base, &tk, full + st, hkv, kt * BN, w.b);
          tma_load_tile<D, BN>(base + L::kStreamTile, &tv, full + st, hkv,
                               kt * BN, w.b);
        } else {
          mbar_arrive(full + st);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const Lane ln;
  const float sl2 = scale * kLog2e;
  const uint32_t q_s = smem_u32(sm) + ln.wg * 64 * 128;
  const uint32_t do_s = q_s + L::kOwnTile;
  int n = 0, no = 0;
  for (int k = 0, i = row_of(0); i < n_rows; i = row_of(++k)) {
    const Work w = load_work(sched, i);
    const int q0 = w.tile * BM;
    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float l2[2], dl[2];
    int qs[2] = {0, 0};
    const long long row0 = ((long long)w.b * h + w.head) * sq;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = q0 + ln.rw + 8 * rr;
      l2[rr] = r < sq ? lse[row0 + r] * kLog2e : 0.f;
      dl[rr] = r < sq ? delta[row0 + r] : 0.f;
      if (seg) qs[rr] = r < sq ? qseg[(long long)w.b * sq + r] : -1;
    }
    if (w.hi > w.lo) {
      mbar_wait(own_full, no & 1);
      float s[BN / 2], dp[BN / 2];
      uint32_t da[BN / 16][4];
      // S = Q K^T and dP = dO V^T of the tile in stage st (one group)
      auto issue_s = [&](int st) {
        const uint32_t k_s = smem_u32(sm + L::kRing + st * L::kStage);
        const uint32_t v_s = k_s + L::kStreamTile;
        wgmma_ss_z<BN, 0>(s, kmajor<BM>(q_s, 0), kmajor<BN>(k_s, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss<BN, 0>(s, kmajor<BM>(q_s, kk), kmajor<BN>(k_s, kk), 1);
        wgmma_ss_z<BN, 0>(dp, kmajor<BM>(do_s, 0), kmajor<BN>(v_s, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss<BN, 0>(dp, kmajor<BM>(do_s, kk), kmajor<BN>(v_s, kk), 1);
        wgmma_commit();
      };
      // dQ += dS K of the tile in stage st (one group)
      auto issue_dq = [&](int st) {
        const uint32_t k_s = smem_u32(sm + L::kRing + st * L::kStage);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<D, 1>(acc, da[kk], mnmajor<BN>(k_s, kk), 1);
        wgmma_commit();
      };
      // ds = p (dp - delta) scale into s, p = exp2(s scale log2 e - lse
      // log2 e), masked where the tile needs it
      auto grad_t = [&](int kt, int st, auto masked) {
        const int k0 = kt * BN;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = e >> 1;
            const int c = 8 * j + 2 * ln.t + (e & 1);
            float p = exp2_ftz(fmaf(s[4 * j + e], sl2, -l2[rr]));
            if constexpr (decltype(masked)::value)
              if (!visible(q0 + ln.rw + 8 * rr, k0 + c, sq, sk, causal, seg,
                           qs[rr], seg ? sseg[st * BN + c] : 0))
                p = 0.f;
            s[4 * j + e] = p * (dp[4 * j + e] - dl[rr]) * scale;
          }
      };
      auto grad = [&](int kt, int st) {
        if (kt < w.free_lo || kt >= w.free_hi)
          grad_t(kt, st, std::true_type{});
        else
          grad_t(kt, st, std::false_type{});
      };

      // each tile's S and dP overlap the previous tile's dQ product
      int st = n % S;
      mbar_wait(full + st, (n / S) & 1);
      wgmma_fence();
      issue_s(st);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (w.lo == w.hi - 1) release(own_empty, ln.lane);
      grad(w.lo, st);
      acc_to_a<BN>(s, da);
      for (int kt = w.lo + 1; kt < w.hi; ++kt) {
        const int prev = st;
        ++n;
        st = n % S;
        mbar_wait(full + st, (n / S) & 1);
        fence_regs(acc);
        fence_regs(da);
        wgmma_fence();
        issue_s(st);
        issue_dq(prev);
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        if (kt == w.hi - 1) release(own_empty, ln.lane);
        grad(kt, st);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(da);
        release(empty + prev, ln.lane);
        acc_to_a<BN>(s, da);
      }
      fence_regs(acc);
      fence_regs(da);
      wgmma_fence();
      issue_dq(st);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
      release(empty + st, ln.lane);
      ++n;
      ++no;
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = q0 + ln.rw + 8 * rr;
      if (r >= sq) continue;
      bf16* orow = dq + (((long long)w.b * sq + r) * h + w.head) * D +
                   2 * ln.t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
    }
  }
}

// ---- dk/dv -----------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tdo,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const int* __restrict__ sched, int n_rows,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int* __restrict__ qseg, const int* __restrict__ kseg,
           float* __restrict__ dk, float* __restrict__ dv, long long slot,
           int sq, int sk, int h, int hk, float scale, int causal) {
  using C = Dkv<D>;
  using L = typename C::L;
  constexpr int BM = C::BM, BN = C::BN, S = C::S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + S;
  uint64_t* own_full = full + 2 * S;
  uint64_t* own_empty = own_full + 1;
  // per stage: lse * log2 e, delta, segment ids of the tile's queries
  float* slse = reinterpret_cast<float*>(sm + L::kSide);
  float* sdel = slse + S * BN;
  int* sseg = reinterpret_cast<int*>(sdel + S * BN);
  const bool seg = qseg != nullptr;
  const int group = h / hk;
  init_barriers<S>(full);

  if (threadIdx.x < kWG) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tdo);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
    }
    int n = 0, no = 0;
    for (int k = 0, i = row_of(0); i < n_rows; i = row_of(++k)) {
      const Work w = load_work(sched, i);
      if (w.hi <= w.lo) continue;
      mbar_wait(own_empty, (no & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(own_full, 2 * L::kOwnTile);
        tma_load_tile<D, BM>(sm, &tk, own_full, w.head, w.tile * BM, w.b);
        tma_load_tile<D, BM>(sm + L::kOwnTile, &tv, own_full, w.head,
                             w.tile * BM, w.b);
      }
      ++no;
      for (int gi = 0; gi < group; ++gi) {
        const int hh = w.head * group + gi;
        const long long row0 = ((long long)w.b * h + hh) * sq;
        for (int qt = w.lo; qt < w.hi; ++qt, ++n) {
          const int st = n % S;
          mbar_wait(empty + st, ((n / S) & 1) ^ 1);
          for (int c = lane; c < BN; c += 32) {
            const int r = qt * BN + c;
            const bool in = r < sq;
            slse[st * BN + c] = in ? lse[row0 + r] * kLog2e : 0.f;
            sdel[st * BN + c] = in ? delta[row0 + r] : 0.f;
            if (seg)
              sseg[st * BN + c] = in ? qseg[(long long)w.b * sq + r] : -1;
          }
          if (lane == 0) {
            uint8_t* base = sm + L::kRing + st * L::kStage;
            mbar_arrive_tx(full + st, L::kStage);
            tma_load_tile<D, BN>(base, &tq, full + st, hh, qt * BN, w.b);
            tma_load_tile<D, BN>(base + L::kStreamTile, &tdo, full + st, hh,
                                 qt * BN, w.b);
          } else {
            mbar_arrive(full + st);
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const Lane ln;
  const float sl2 = scale * kLog2e;
  const uint32_t k_s = smem_u32(sm) + ln.wg * 64 * 128;
  const uint32_t v_s = k_s + L::kOwnTile;
  int n = 0, no = 0;
  for (int k = 0, i = row_of(0); i < n_rows; i = row_of(++k)) {
    const Work w = load_work(sched, i);
    const int k0 = w.tile * BM;
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dka[j] = dva[j] = 0.f;
    int ks[2] = {0, 0};
    if (seg)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int c = k0 + ln.rw + 8 * rr;
        ks[rr] = c < sk ? kseg[(long long)w.b * sk + c] : -2;
      }
    if (w.hi > w.lo) {
      mbar_wait(own_full, no & 1);
      float s[BN / 2], dp[BN / 2];
      uint32_t pa[BN / 16][4], da[BN / 16][4];
      // S^T = K Q^T and dP^T = V dO^T of the tile in stage st (one group)
      auto issue_s = [&](int st) {
        const uint32_t q_s = smem_u32(sm + L::kRing + st * L::kStage);
        const uint32_t do_s = q_s + L::kStreamTile;
        wgmma_ss_z<BN, 0>(s, kmajor<BM>(k_s, 0), kmajor<BN>(q_s, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss<BN, 0>(s, kmajor<BM>(k_s, kk), kmajor<BN>(q_s, kk), 1);
        wgmma_ss_z<BN, 0>(dp, kmajor<BM>(v_s, 0), kmajor<BN>(do_s, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss<BN, 0>(dp, kmajor<BM>(v_s, kk), kmajor<BN>(do_s, kk), 1);
        wgmma_commit();
      };
      // dV += P^T dO and dK += dS^T Q of the tile in stage st (one group)
      auto issue_dkv = [&](int st) {
        const uint32_t q_s = smem_u32(sm + L::kRing + st * L::kStage);
        const uint32_t do_s = q_s + L::kStreamTile;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<D, 1>(dva, pa[kk], mnmajor<BN>(do_s, kk), 1);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<D, 1>(dka, da[kk], mnmajor<BN>(q_s, kk), 1);
        wgmma_commit();
      };
      // p^T into s and ds^T into dp for query tile qt (stage st), masked
      // where the tile needs it; lse and delta are per column here
      auto grad_t = [&](int qt, int st, auto masked) {
        const float* tl = slse + st * BN;
        const float* td = sdel + st * BN;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = e >> 1;
            const int c = 8 * j + 2 * ln.t + (e & 1);  // query of the tile
            float p = exp2_ftz(fmaf(s[4 * j + e], sl2, -tl[c]));
            if constexpr (decltype(masked)::value)
              if (!visible(qt * BN + c, k0 + ln.rw + 8 * rr, sq, sk, causal,
                           seg, seg ? sseg[st * BN + c] : 0, ks[rr]))
                p = 0.f;
            s[4 * j + e] = p;
            dp[4 * j + e] = p * (dp[4 * j + e] - td[c]) * scale;
          }
      };
      auto grad = [&](int qt, int st) {
        if (qt < w.free_lo || qt >= w.free_hi)
          grad_t(qt, st, std::true_type{});
        else
          grad_t(qt, st, std::false_type{});
      };

      // the group's query heads in order, each over tiles [lo, hi). The
      // two products of a tile are not overlapped with the next tile's:
      // dK, dV, S^T and dP^T together would not fit the registers; the
      // other consumer warpgroup fills the tensor cores meanwhile
      const int per = w.hi - w.lo, tiles = group * per;
      for (int x = 0; x < tiles; ++x, ++n) {
        const int st = n % S;
        mbar_wait(full + st, (n / S) & 1);
        wgmma_fence();
        issue_s(st);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        if (x == tiles - 1) release(own_empty, ln.lane);
        grad(w.lo + x % per, st);
        acc_to_a<BN>(s, pa);
        acc_to_a<BN>(dp, da);
        fence_regs(dva);
        fence_regs(dka);
        wgmma_fence();
        issue_dkv(st);
        wgmma_wait<0>();
        fence_regs(dva);
        fence_regs(dka);
        fence_regs(pa);
        fence_regs(da);
        release(empty + st, ln.lane);
      }
      ++no;
    }

    // a piece of a split list writes its partial sums to its own slot
    // (slot floats apart); dkv_piece_sum adds the slots afterwards
    float* const dk_out = dk + w.piece * slot;
    float* const dv_out = dv + w.piece * slot;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int c = k0 + ln.rw + 8 * rr;
      if (c >= sk) continue;
      const long long o =
          (((long long)w.b * sk + c) * hk + w.head) * D + 2 * ln.t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(dk_out + o + 8 * j) =
            make_float2(dka[4 * j + 2 * rr], dka[4 * j + 2 * rr + 1]);
        *reinterpret_cast<float2*>(dv_out + o + 8 * j) =
            make_float2(dva[4 * j + 2 * rr], dva[4 * j + 2 * rr + 1]);
      }
    }
  }
}

// second pass of a split dk/dv list: dk[i] (and dv[i]) is the sum, in
// slot order, of the pieces[tile of i's key row] slots of the workspace
// ws_k (ws_v), each slot floats long; float4 at a time
__global__ void __launch_bounds__(256)
dkv_piece_sum(const float* __restrict__ ws_k, const float* __restrict__ ws_v,
              const int* __restrict__ pieces, float* __restrict__ dk,
              float* __restrict__ dv, long long slot, int row_floats,
              int sk, int bm) {
  const long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= slot) return;
  const int n = pieces[(int)((i / row_floats) % sk) / bm];
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
  for (int p = 0; p < n; ++p) {
    const float4 x = *reinterpret_cast<const float4*>(ws_k + p * slot + i);
    const float4 y = *reinterpret_cast<const float4*>(ws_v + p * slot + i);
    a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
  }
  *reinterpret_cast<float4*>(dk + i) = a;
  *reinterpret_cast<float4*>(dv + i) = c;
}

// numRegs of each instantiation, [fwd, dq, dk/dv][d 64, 128], read with
// cudaFuncGetAttributes at its first launch (0 until then)
std::atomic<int> g_regs[3][2];

template <typename Kernel>
cudaError_t kernel_regs(Kernel kernel, std::atomic<int>& cache, int* regs) {
  int r = cache.load(std::memory_order_relaxed);
  if (r == 0) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    r = attr.numRegs;
    cache.store(r, std::memory_order_relaxed);
  }
  *regs = r;
  return cudaSuccess;
}

// launch kernel on a persistent grid of min(n_rows, SMs) CTAs, or refuse
// (kShortRegisters) when its build holds fewer than kLaunchRegs registers
// a thread: its setmaxnreg would then wait forever
template <typename Kernel, typename... Args>
int launch(Kernel kernel, std::atomic<int>& regs_cache, int bytes,
           int n_rows, cudaStream_t stream, Args... args) {
  if (n_rows <= 0) return 0;
  int regs = 0;
  if (cudaError_t e = kernel_regs(kernel, regs_cache, &regs))
    return static_cast<int>(e);
  if (regs < kLaunchRegs) return kShortRegisters;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_rows < sms ? n_rows : sms, kThreads, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// the maps of a [b, s, heads, d] tensor in boxes of `rows`
#define PTT_WG_MAP(NAME, PTR, S, HEADS, ROWS)                           \
  CUtensorMap NAME;                                                     \
  if (int e_ = encode_bshd(&NAME, PTR, b, S, HEADS, D, ROWS)) return e_;

template <int D>
int fwd_d(const void* q, const void* k, const void* v, const int* qseg,
          const int* kseg, void* out, float* lse, const int* sched,
          int n_rows, int b, int sq, int sk, int h, int hk, float scale,
          int causal, cudaStream_t st) {
  using C = Fwd<D>;
  PTT_WG_MAP(tq, q, sq, h, C::BM)
  PTT_WG_MAP(tk, k, sk, hk, C::BN)
  PTT_WG_MAP(tv, v, sk, hk, C::BN)
  return launch(fwd_kernel<D>, g_regs[0][D / 128], C::L::kBytes, n_rows, st,
                tq, tk, tv, sched,
                n_rows, qseg, kseg, static_cast<bf16*>(out), lse, sq, sk, h,
                hk, scale, causal);
}

template <int D>
int dq_d(const void* q, const void* k, const void* v, const void* dout,
         const float* lse, const float* delta, const int* qseg,
         const int* kseg, void* dq, const int* sched, int n_rows, int b,
         int sq, int sk, int h, int hk, float scale, int causal,
         cudaStream_t st) {
  using C = Dq<D>;
  PTT_WG_MAP(tq, q, sq, h, C::BM)
  PTT_WG_MAP(tdo, dout, sq, h, C::BM)
  PTT_WG_MAP(tk, k, sk, hk, C::BN)
  PTT_WG_MAP(tv, v, sk, hk, C::BN)
  return launch(dq_kernel<D>, g_regs[1][D / 128], C::L::kBytes, n_rows, st,
                tq, tdo, tk, tv, sched, n_rows, lse, delta, qseg, kseg,
                static_cast<bf16*>(dq), sq, sk, h, hk, scale, causal);
}

template <int D>
int dkv_d(const void* q, const void* k, const void* v, const void* dout,
          const float* lse, const float* delta, const int* qseg,
          const int* kseg, float* dk, float* dv, float* ws, const int* pieces,
          int n_slots, const int* sched, int n_rows, int b, int sq, int sk,
          int h, int hk, float scale, int causal, cudaStream_t st) {
  using C = Dkv<D>;
  PTT_WG_MAP(tq, q, sq, h, C::BN)
  PTT_WG_MAP(tdo, dout, sq, h, C::BN)
  PTT_WG_MAP(tk, k, sk, hk, C::BM)
  PTT_WG_MAP(tv, v, sk, hk, C::BM)
  const long long slot = (long long)b * sk * hk * D;
  if (ws == nullptr)
    return launch(dkv_kernel<D>, g_regs[2][D / 128], C::L::kBytes, n_rows,
                  st, tq, tdo, tk, tv, sched, n_rows, lse, delta, qseg, kseg,
                  dk, dv, slot, sq, sk, h, hk, scale, causal);
  // a split list: the pieces write slots of ws (dk's n_slots slots, then
  // dv's), which dkv_piece_sum adds in slot order into dk and dv
  if (pieces == nullptr || n_slots < 1) return kUnsupported;
  float* ws_v = ws + n_slots * slot;
  const int e = launch(dkv_kernel<D>, g_regs[2][D / 128], C::L::kBytes,
                       n_rows, st, tq, tdo, tk, tv, sched, n_rows, lse, delta,
                       qseg, kseg, ws, ws_v, slot, sq, sk, h, hk, scale,
                       causal);
  if (e != 0) return e;
  const long long quads = slot / 4;  // D is a multiple of 4
  dkv_piece_sum<<<(unsigned)((quads + 255) / 256), 256, 0, st>>>(
      ws, ws_v, pieces, dk, dv, slot, hk * D, sk, C::BM);
  return static_cast<int>(cudaGetLastError());
}

#undef PTT_WG_MAP

// the tiles (own rows, streamed rows) the schedule was built for must be
// the kernel's
template <typename C>
bool tiles_ok(int bm, int bn) {
  return bm == C::BM && bn == C::BN;
}

}  // namespace

int fwd(int d, const void* q, const void* k, const void* v, const int* qseg,
        const int* kseg, void* out, float* lse, const int* sched, int n_rows,
        int bm, int bn, int b, int sq, int sk, int h, int hk, float scale,
        int causal, cudaStream_t st) {
  if (d == 64 && tiles_ok<Fwd<64>>(bm, bn))
    return fwd_d<64>(q, k, v, qseg, kseg, out, lse, sched, n_rows, b, sq, sk,
                     h, hk, scale, causal, st);
  if (d == 128 && tiles_ok<Fwd<128>>(bm, bn))
    return fwd_d<128>(q, k, v, qseg, kseg, out, lse, sched, n_rows, b, sq,
                      sk, h, hk, scale, causal, st);
  return kUnsupported;
}

int bwd_dq(int d, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* delta,
           const int* qseg, const int* kseg, void* dq, const int* sched,
           int n_rows, int bm, int bn, int b, int sq, int sk, int h, int hk,
           float scale, int causal, cudaStream_t st) {
  if (d == 64 && tiles_ok<Dq<64>>(bm, bn))
    return dq_d<64>(q, k, v, dout, lse, delta, qseg, kseg, dq, sched, n_rows,
                    b, sq, sk, h, hk, scale, causal, st);
  if (d == 128 && tiles_ok<Dq<128>>(bm, bn))
    return dq_d<128>(q, k, v, dout, lse, delta, qseg, kseg, dq, sched,
                     n_rows, b, sq, sk, h, hk, scale, causal, st);
  return kUnsupported;
}

int bwd_dkv(int d, const void* q, const void* k, const void* v,
            const void* dout, const float* lse, const float* delta,
            const int* qseg, const int* kseg, float* dk, float* dv,
            float* ws, const int* pieces, int n_slots, const int* sched,
            int n_rows, int bm, int bn, int b, int sq, int sk, int h, int hk,
            float scale, int causal, cudaStream_t st) {
  if (d == 64 && tiles_ok<Dkv<64>>(bm, bn))
    return dkv_d<64>(q, k, v, dout, lse, delta, qseg, kseg, dk, dv, ws,
                     pieces, n_slots, sched, n_rows, b, sq, sk, h, hk, scale,
                     causal, st);
  if (d == 128 && tiles_ok<Dkv<128>>(bm, bn))
    return dkv_d<128>(q, k, v, dout, lse, delta, qseg, kseg, dk, dv, ws,
                      pieces, n_slots, sched, n_rows, b, sq, sk, h, hk,
                      scale, causal, st);
  return kUnsupported;
}

int regs(int kernel, int d) {
  if ((d != 64 && d != 128) || kernel < 0 || kernel > 2) return kUnsupported;
  int r = 0;
  cudaError_t e = cudaSuccess;
  std::atomic<int>& cache = g_regs[kernel][d / 128];
  if (d == 64)
    e = kernel == 0 ? kernel_regs(fwd_kernel<64>, cache, &r)
        : kernel == 1 ? kernel_regs(dq_kernel<64>, cache, &r)
                      : kernel_regs(dkv_kernel<64>, cache, &r);
  else
    e = kernel == 0 ? kernel_regs(fwd_kernel<128>, cache, &r)
        : kernel == 1 ? kernel_regs(dq_kernel<128>, cache, &r)
                      : kernel_regs(dkv_kernel<128>, cache, &r);
  return e == cudaSuccess ? r : kUnsupported;
}

int smem_bytes(int kernel, int d) {
#define PTT_WG_SMEM(D)                                                   \
  (kernel == 0 ? Fwd<D>::L::kBytes                                       \
               : kernel == 1 ? Dq<D>::L::kBytes : Dkv<D>::L::kBytes)
  if (d == 64) return PTT_WG_SMEM(64);
  if (d == 128) return PTT_WG_SMEM(128);
#undef PTT_WG_SMEM
  return kUnsupported;
}

}  // namespace flash_wg
}  // namespace ptt
