// One-token decode attention over the paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   paddle_tpu/ops/pallas/paged_attention.py:paged_attention_decode_pallas
//   (call :164, kernel body _decode_kernel :46).
// What it computes: for every sequence b and query head, attention of
// this step's query q[b] over the pool positions p < context_lens[b] of
// the sequence's own pages (block_tables[b]), bounded by max_pages *
// block_size; page ids are clamped into the pool. GQA: the `group` query
// heads of kv-head h share its K/V. The softmax is online in float32 with
// the finite -1e30 of the JAX kernel, and the output is acc / max(l,
// 1e-30), so a sequence with ctx <= 0 comes out as exact zeros. This is
// the ragged kernel's function with one row per sequence (the JAX
// package's decode oracle is that ragged call); pools are float32 or
// bfloat16 of q's dtype (an int8 pool goes to the ragged kernel).
//
// What bounds it on an H100: bytes. A sequence's kv-head reads ctx * d K
// and V values once and does 4 * group flops per value, far below the
// ~295 flop/byte where the tensor cores bind. At b 8 a grid of one block
// per (sequence, kv-head) fills 64 of 132 SMs, and one long sequence of a
// mixed batch sets the time of the whole launch.
//
// Design, bfloat16 at head_dim 64 / 128 (paged_decode_kernel over
// paged_attention.cuh, whose header has the details): the ragged
// design's one-row tiles. A unit is (sequence, kv-head, KV split); the
// host sizes the grid from b, kv_heads, max_pages and the SM count: a
// batch of at most one unit an SM gets a deep ring (~192 KB of stages in
// flight a block) and may cut a long sequence's positions into shares,
// whose float32 partials the last share to finish adds in share order.
// Pages come in by TMA; the group's query vectors are the columns of
// mma.sync m16n8k16 products whose rows are positions (S^T = K Q^T, O^T
// += V^T P^T).
//
// float32 pools, head_dim 256, and pages that are not whole 16-position
// chunks run the first, CUDA-core form (paged_decode_cc_kernel): one
// 128-thread block per (sequence, kv-head), tiles of up to 128 positions
// staged by cp.async into two buffers, every query head of the group
// served from each staged tile, float32 FMAs.

#include "paged_attention.cuh"

namespace ptt {
namespace {

// ---- bfloat16: tensor cores (paged_attention.cuh) -------------------------

template <int D>
__global__ void __launch_bounds__(paged::kThreads, 2)
paged_decode_kernel(const paged::Params p,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv) {
  extern __shared__ __align__(1024) unsigned char smem[];
  paged::attention_unit<D, false>(p, &tk, &tv, smem);
}

template <int D>
int launch_tc(const paged::Params& p, int blocks, const void* k,
              const void* v, cudaStream_t stream) {
  return paged::launch<D, false>(paged_decode_kernel<D>, p, blocks, k, v,
                                 stream);
}

// ---- float32, head_dim 256 and the rest: CUDA cores -------------------------

namespace cc {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;   // query heads per kv-head
constexpr int kHeadsPerWarp = kMaxGroup / kWarps;
constexpr float kNegInf = -1e30f;
constexpr int kStageBytes = 32768;  // one stage of K (or V), unpadded

template <typename T, int D>
struct DecodeShape {
  // positions per tile
  static constexpr int kTile =
      kStageBytes / (D * (int)sizeof(T)) < 128
          ? kStageBytes / (D * (int)sizeof(T)) : 128;
  // threads that split one position's dot product
  static constexpr int kSplit = kThreads / kTile;
  static constexpr int kPad = 16 / (int)sizeof(T);  // 16 bytes
  static constexpr int kLD = D + kPad;               // shared row stride
  static constexpr int kRowChunks = D * (int)sizeof(T) / 16;
  // p.V: each thread owns kCols columns of d for kHeadSets heads
  static constexpr int kCols = D > kThreads ? D / kThreads : 1;
  static constexpr int kColSpan = D > kThreads ? kThreads : D;
  static constexpr int kHeadStride = kThreads / kColSpan;
  static constexpr int kHeadSlots = (kMaxGroup + kHeadStride - 1) / kHeadStride;
  static constexpr int kSmemBytes = 4 * kTile * kLD * (int)sizeof(T);
  static_assert(kThreads % kTile == 0, "tile must divide the block");
  static_assert((D / kSplit) % 8 == 0, "a thread's d slice must be 8-wide");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_cc_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const int* __restrict__ tables,
                       const int* __restrict__ context_lens,
                       T* __restrict__ out, int num_heads, int kv_heads,
                       int num_blocks, int block_size, int max_pages, int group,
                       float scale) {
  using S = DecodeShape<T, D>;
  constexpr int TP = S::kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kbuf = reinterpret_cast<T*>(smem_raw);       // [2][TP][kLD]
  T* vbuf = kbuf + 2 * TP * S::kLD;               // [2][TP][kLD]
  __shared__ __align__(16) float qs[kMaxGroup][D];
  __shared__ float sc[kMaxGroup][TP];
  __shared__ float corr_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long head0 = (long long)b * num_heads + (long long)h * group;
  T* o = out + head0 * D;
  const int ctx = context_lens[b];
  if (ctx <= 0) {  // nothing visible: exact zeros, no page is read
    for (int i = tid; i < group * D; i += kThreads) o[i] = from_float<T>(0.f);
    return;
  }
  const int* trow = tables + (long long)b * max_pages;
  const int n_pos = min(ctx, max_pages * block_size);
  const int n_tiles = (n_pos + TP - 1) / TP;

  // stage tile `t` into buffer `stage`: every 16-byte chunk of the
  // visible rows, each row read from its own page
  auto issue = [&](int t, int stage) {
    const int base = t * TP;
    const int rows = min(TP, n_pos - base);
    T* kd = kbuf + stage * TP * S::kLD;
    T* vd = vbuf + stage * TP * S::kLD;
    for (int c = tid; c < rows * S::kRowChunks; c += kThreads) {
      const int p = c / S::kRowChunks;
      const int e = (c % S::kRowChunks) * (16 / (int)sizeof(T));
      const int gp = base + p;
      const int page =
          min(max(__ldg(trow + gp / block_size), 0), num_blocks - 1);
      const long long off =
          (((long long)page * kv_heads + h) * block_size + gp % block_size) *
              D + e;
      cp_async16(kd + p * S::kLD + e, kp + off);
      cp_async16(vd + p * S::kLD + e, vp + off);
    }
  };

  issue(0, 0);
  cp_async_commit();

  for (int i = tid; i < group * D; i += kThreads)
    qs[i / D][i % D] = to_float(q[head0 * D + i]) * scale;

  float m_run[kHeadsPerWarp], l_run[kHeadsPerWarp];
#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) {
    m_run[j] = kNegInf;
    l_run[j] = 0.f;
  }
  float acc[S::kCols][S::kHeadSlots];
#pragma unroll
  for (int c = 0; c < S::kCols; ++c)
#pragma unroll
    for (int j = 0; j < S::kHeadSlots; ++j) acc[c][j] = 0.f;

  // score phase: position tid / kSplit, d slice part * D / kSplit
  const int sp = tid / S::kSplit;
  const int part = tid % S::kSplit;
  constexpr int kSlice = D / S::kSplit;
  // p.V phase: columns col0 + c * kThreads, heads hset + j * kHeadStride
  const int col0 = tid % S::kColSpan;
  const int hset = tid / S::kColSpan;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) issue(t + 1, stage ^ 1);
    cp_async_commit();   // possibly empty: keeps one group per tile
    cp_async_wait_one(); // this thread's copies of tile t have landed
    __syncthreads();     // ... and every other thread's
    const T* kt = kbuf + stage * TP * S::kLD;
    const T* vt = vbuf + stage * TP * S::kLD;
    const int base = t * TP;
    const int rows = min(TP, n_pos - base);

    // scores of every head at position sp
    float s[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) s[g] = 0.f;
    if (sp < rows) {
      const T* krow = kt + sp * S::kLD + part * kSlice;
#pragma unroll 4
      for (int dd = 0; dd < kSlice; dd += 8) {
        float kv[8];
        load8(krow + dd, kv);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < group) {
            const float* qg = &qs[g][part * kSlice + dd];
            const float4 a = *reinterpret_cast<const float4*>(qg);
            const float4 c = *reinterpret_cast<const float4*>(qg + 4);
            float v = s[g];
            v = fmaf(a.x, kv[0], v); v = fmaf(a.y, kv[1], v);
            v = fmaf(a.z, kv[2], v); v = fmaf(a.w, kv[3], v);
            v = fmaf(c.x, kv[4], v); v = fmaf(c.y, kv[5], v);
            v = fmaf(c.z, kv[6], v); v = fmaf(c.w, kv[7], v);
            s[g] = v;
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
      for (int o2 = 1; o2 < S::kSplit; o2 <<= 1)
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], o2);
      if (part == 0 && g < group) sc[g][sp] = sp < rows ? s[g] : kNegInf;
    }
    __syncthreads();

    // online-softmax statistics: warp w owns heads w, w + kWarps, ...
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) {
      const int g = warp + j * kWarps;
      if (g >= group) continue;  // warp-uniform
      float mx = kNegInf;
      for (int p = lane; p < TP; p += 32) mx = fmaxf(mx, sc[g][p]);
      const float m_new = fmaxf(m_run[j], warp_max(mx));
      float sum = 0.f;
      for (int p = lane; p < TP; p += 32) {
        const float v = sc[g][p];
        const float pr = v > kNegInf * 0.5f ? expf(v - m_new) : 0.f;
        sc[g][p] = pr;
        sum += pr;
      }
      const float corr = expf(m_run[j] - m_new);
      l_run[j] = l_run[j] * corr + warp_sum(sum);
      m_run[j] = m_new;
      if (lane == 0) corr_s[g] = corr;
    }
    __syncthreads();

    // p.V: every thread updates its columns for its heads
#pragma unroll
    for (int j = 0; j < S::kHeadSlots; ++j) {
      const int g = hset + j * S::kHeadStride;
      if (g < group) {
#pragma unroll
        for (int c = 0; c < S::kCols; ++c) acc[c][j] *= corr_s[g];
      }
    }
    for (int p = 0; p < rows; ++p) {
      float v[S::kCols];
#pragma unroll
      for (int c = 0; c < S::kCols; ++c)
        v[c] = to_float(vt[p * S::kLD + col0 + c * kThreads]);
#pragma unroll
      for (int j = 0; j < S::kHeadSlots; ++j) {
        const int g = hset + j * S::kHeadStride;
        if (g < group) {
          const float pr = sc[g][p];
#pragma unroll
          for (int c = 0; c < S::kCols; ++c)
            acc[c][j] = fmaf(pr, v[c], acc[c][j]);
        }
      }
    }
    __syncthreads();  // tile t's buffers and sc are free for reuse
  }

  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) {
      const int g = warp + j * kWarps;
      if (g < group) l_s[g] = l_run[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < S::kHeadSlots; ++j) {
    const int g = hset + j * S::kHeadStride;
    if (g < group) {
      const float inv = 1.f / fmaxf(l_s[g], 1e-30f);
#pragma unroll
      for (int c = 0; c < S::kCols; ++c)
        o[g * D + col0 + c * kThreads] = from_float<T>(acc[c][j] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* tables,
           const int* context_lens, void* out, int b, int num_heads,
           int kv_heads, int num_blocks, int block_size, int max_pages,
           float scale, cudaStream_t stream) {
  using S = DecodeShape<T, D>;
  static_assert(S::kSmemBytes + (kMaxGroup * D + kMaxGroup * S::kTile) * 4 <=
                    227 * 1024, "decode tile too large");
  auto kernel = paged_decode_cc_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(b, kv_heads), kThreads, S::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, context_lens, static_cast<T*>(out),
      num_heads, kv_heads, num_blocks, block_size, max_pages,
      num_heads / kv_heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int head_dim, const void* q, const void* k, const void* v,
             const int* tables, const int* context_lens, void* out, int b,
             int num_heads, int kv_heads, int num_blocks, int block_size,
             int max_pages, float scale, cudaStream_t st) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(q, k, v, tables, context_lens, out, b, num_heads,
                           kv_heads, num_blocks, block_size, max_pages, scale,
                           st);
    case 128:
      return launch<T, 128>(q, k, v, tables, context_lens, out, b, num_heads,
                            kv_heads, num_blocks, block_size, max_pages,
                            scale, st);
    case 256:
      return launch<T, 256>(q, k, v, tables, context_lens, out, b, num_heads,
                            kv_heads, num_blocks, block_size, max_pages,
                            scale, st);
    default:
      return kUnsupported;
  }
}

}  // namespace cc

}  // namespace
}  // namespace ptt

// q [b, num_heads, head_dim] (dtype), pools [num_blocks, kv_heads,
// block_size, head_dim] of the same dtype, tables [b, max_pages] int32,
// context_lens [b] int32; out like q. The plan is the caller's
// (ops/cuda/paged_attention_plan.py:grid_plan): on the tensor-core route
// (bfloat16, head_dim 64 or 128, block_size a multiple of 16 that
// divides 64 or is a multiple of it) `splits` (1..16) KV splits a
// sequence may take, `deep` (0 / 1: the grid holds at most one block an
// SM, so the ring takes about 192 KB) and `blocks` (1..b) grid blocks a
// kv-head and split, each working sequences blocks apart; with splits > 1
// a float32
// workspace of splits * b * num_heads * (head_dim + 2) values and int32
// counters [b * kv_heads] that are zero (the kernel leaves them zero).
// splits = 1, deep = 0 and blocks = b elsewhere. Returns 0, a
// cudaError_t from the launch, or -1 for an unsupported shape, type or
// plan.
extern "C" int ptt_paged_attention_decode(
    const void* q, const void* k, const void* v, const int* tables,
    const int* context_lens, void* out, float* workspace, int* counters,
    int b, int num_heads, int kv_heads, int head_dim, int num_blocks,
    int block_size, int max_pages, int dtype, int splits, int deep,
    int blocks, float scale, void* stream) {
  using namespace ptt;
  if (b == 0) return 0;
  if (b < 0 || kv_heads <= 0 || num_heads % kv_heads != 0 ||
      num_heads / kv_heads > cc::kMaxGroup || max_pages <= 0 ||
      block_size <= 0 || num_blocks <= 0)
    return kUnsupported;
  if (splits < 1 || splits > paged::kMaxSplits || (deep != 0 && deep != 1) ||
      blocks < 1 || blocks > b ||
      (splits > 1 && (workspace == nullptr || counters == nullptr)))
    return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (paged::tensor_core_route(dtype, head_dim, block_size)) {
    paged::Params p = {};
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.tables = tables;
    p.row_seq = nullptr;  // row r reads table row r
    p.row_ctx = context_lens;
    p.out = static_cast<__nv_bfloat16*>(out);
    p.ws = workspace;
    p.counters = counters;
    p.rows = b;
    p.num_heads = num_heads;
    p.kv_heads = kv_heads;
    p.num_blocks = num_blocks;
    p.block_size = block_size;
    p.num_seqs = b;
    p.max_pages = max_pages;
    p.group = num_heads / kv_heads;
    p.tile_rows = 1;
    p.splits = splits;
    p.deep = deep;
    p.scale_log2 = scale * paged::kLog2e;
    return head_dim == 64 ? launch_tc<64>(p, blocks, k, v, st)
                          : launch_tc<128>(p, blocks, k, v, st);
  }
  if (splits != 1 || deep != 0 || blocks != b) return kUnsupported;
  if (dtype == kF32)
    return cc::launch_d<float>(head_dim, q, k, v, tables, context_lens, out,
                               b, num_heads, kv_heads, num_blocks,
                               block_size, max_pages, scale, st);
  if (dtype == kBF16)
    return cc::launch_d<__nv_bfloat16>(head_dim, q, k, v, tables,
                                       context_lens, out, b, num_heads,
                                       kv_heads, num_blocks, block_size,
                                       max_pages, scale, st);
  return kUnsupported;
}
