// Ragged paged attention over the paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   paddle_tpu/ops/pallas/ragged_paged_attention.py:ragged_paged_attention_pallas
//   (call :282, kernel body _ragged_kernel :54).
// What it computes: one flattened batch of rows that mixes decode rows
// and prefill-chunk rows. Row r reads block-table row row_seq[r] and
// sees the pool positions p < row_ctx[r] (that one bound is both the
// context limit and the causal mask inside a prefill chunk), bounded by
// max_pages * block_size; page ids are clamped into the pool. GQA: the
// `group` query heads of kv-head h share its K/V. Softmax is online, in
// float32, with the finite -1e30; the output is acc / max(l, 1e-30), so
// rows with row_ctx <= 0 are exact zeros. An int8 pool carries a float32
// scale per (page, kv-head, slot).
//
// What bounds it on an H100: bytes. Every visible K and V row of a
// sequence's kv-head must be read once and feeds 4 * group flops per
// value for each row that sees it, far below the ~295 flop/byte where
// the tensor cores bind. The TPU kernel walks each sequence of a row
// block once (first-occurrence dedup, _ragged_kernel's seq_body); the
// first form of this kernel did not, and a 64-row prefill chunk re-read
// its pages 64 times.
//
// Design, bfloat16 q at head_dim 64 / 128 (ragged_attention_kernel over
// paged_attention.cuh, whose header has the details): a unit is (row
// tile, kv-head, KV split), a row tile up to R consecutive rows of one
// sequence (R x group <= 32) cut at aligned rows, so a prefill chunk's
// rows walk their pages once as the rows of mma.sync m16n8k16 products
// (a decode row's group query vectors take the narrow products, positions
// as rows); tiles are found from row_seq on the device; pages come in by
// TMA through an mbarrier ring; int8 pools convert in registers; few
// units (a decode ministep) may split their positions over blocks, the
// last of which merges them in split order.
//
// float32 q, head_dim 32, and pages that are not whole 16-position
// chunks run the first, CUDA-core form (ragged_attention_cc_kernel): one
// 128-thread block per (row, kv-head) walking tiles of 32 positions
// staged in shared memory as float32, scores with one lane per position,
// p.V with each thread owning a slice of the [group, d] accumulator. Only
// the tiny float32 models reach it.

#include "paged_attention.cuh"

namespace ptt {
namespace {

// ---- bfloat16: tensor cores (paged_attention.cuh) -------------------------

template <int D, bool QUANT>
__global__ void __launch_bounds__(paged::kThreads, 2)
ragged_attention_kernel(const paged::Params p,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv) {
  extern __shared__ __align__(1024) unsigned char smem[];
  paged::attention_unit<D, QUANT>(p, &tk, &tv, smem);
}

template <int D, bool QUANT>
int launch_tc(const paged::Params& p, int blocks, const void* k,
              const void* v, cudaStream_t stream) {
  return paged::launch<D, QUANT>(ragged_attention_kernel<D, QUANT>, p,
                                 blocks, k, v, stream);
}

// ---- float32 and the rest: CUDA cores ---------------------------------------

namespace cc {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;      // pool positions per tile: one per lane
constexpr int kMaxGroup = 8;   // query heads per kv-head
constexpr int kHeadsPerWarp = kMaxGroup / kWarps;
constexpr float kNegInf = -1e30f;

template <typename T, typename KV, int D, bool QUANT>
__global__ void __launch_bounds__(kThreads)
ragged_attention_cc_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                           const KV* __restrict__ vp,
                           const float* __restrict__ ksc,
                           const float* __restrict__ vsc,
                           const int* __restrict__ tables,
                           const int* __restrict__ row_seq,
                           const int* __restrict__ row_ctx, T* __restrict__ out,
                           int num_heads, int kv_heads, int num_blocks,
                           int block_size, int num_seqs, int max_pages,
                           int group, float scale) {
  constexpr int kOut = (kMaxGroup * D + kThreads - 1) / kThreads;
  __shared__ float qs[kMaxGroup][D];
  __shared__ float ks[kTile][D + 1];  // +1: conflict-free lane-per-row reads
  __shared__ float vs[kTile][D];
  __shared__ float ps[kMaxGroup][kTile];
  __shared__ float corr_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];

  const int r = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long head0 = (long long)r * num_heads + (long long)h * group;
  T* o = out + head0 * D;
  const int ctx = row_ctx[r];
  if (ctx <= 0) {  // padding row: exact zeros, no page is read
    for (int i = tid; i < group * D; i += kThreads) o[i] = from_float<T>(0.f);
    return;
  }
  const int s = min(max(row_seq[r], 0), num_seqs - 1);
  const int* trow = tables + (long long)s * max_pages;
  const int n_pos = min(ctx, max_pages * block_size);

  for (int i = tid; i < group * D; i += kThreads)
    qs[i / D][i % D] = to_float(q[head0 * D + i]) * scale;

  float m_run[kHeadsPerWarp], l_run[kHeadsPerWarp];
#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) {
    m_run[j] = kNegInf;
    l_run[j] = 0.f;
  }
  float acc[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) acc[j] = 0.f;

  constexpr int kChunks = kTile * D / 8;
  for (int base = 0; base < n_pos; base += kTile) {
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < kChunks; c += kThreads) {
      const int p = c / (D / 8);
      const int d0 = (c % (D / 8)) * 8;
      const int gp = base + p;
      float kv[8], vv[8];
      if (gp < n_pos) {
        const int page = min(max(trow[gp / block_size], 0), num_blocks - 1);
        const long long slot =
            ((long long)page * kv_heads + h) * block_size + gp % block_size;
        load8(kp + slot * D + d0, kv);
        load8(vp + slot * D + d0, vv);
        if (QUANT) {
          const float a = ksc[slot];
          const float b = vsc[slot];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            kv[j] *= a;
            vv[j] *= b;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) kv[j] = vv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ks[p][d0 + j] = kv[j];
        vs[p][d0 + j] = vv[j];
      }
    }
    __syncthreads();
    // scores and the online-softmax statistics: warp w owns heads
    // w, w + kWarps, ...; lane = position within the tile
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) {
      const int g = warp + j * kWarps;
      if (g >= group) continue;  // warp-uniform
      const bool valid = base + lane < n_pos;
      float sc = kNegInf;
      if (valid) {
        float a = 0.f;
#pragma unroll 16
        for (int dd = 0; dd < D; ++dd) a = fmaf(qs[g][dd], ks[lane][dd], a);
        sc = a;
      }
      const float m_new = fmaxf(m_run[j], warp_max(sc));
      const float p = valid ? expf(sc - m_new) : 0.f;
      const float corr = expf(m_run[j] - m_new);
      l_run[j] = l_run[j] * corr + warp_sum(p);
      m_run[j] = m_new;
      ps[g][lane] = p;
      if (lane == 0) corr_s[g] = corr;
    }
    __syncthreads();
    // accumulator update: thread owns outputs tid + j * kThreads
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int idx = tid + j * kThreads;
      if (idx < group * D) {
        const int g = idx / D;
        const int dd = idx % D;
        float a = acc[j] * corr_s[g];
#pragma unroll 8
        for (int p = 0; p < kTile; ++p) a = fmaf(ps[g][p], vs[p][dd], a);
        acc[j] = a;
      }
    }
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
  for (int j = 0; j < kOut; ++j) {
    const int idx = tid + j * kThreads;
    if (idx < group * D)
      o[idx] = from_float<T>(acc[j] / fmaxf(l_s[idx / D], 1e-30f));
  }
}

template <typename T, typename KV, bool QUANT>
int launch(const void* q, const void* k, const void* v, const float* ksc,
           const float* vsc, const int* tables, const int* row_seq,
           const int* row_ctx, void* out, int rows, int num_heads,
           int kv_heads, int head_dim, int num_blocks, int block_size,
           int num_seqs, int max_pages, float scale, cudaStream_t stream) {
  const dim3 grid(rows, kv_heads);
  const int group = num_heads / kv_heads;
#define PTT_RPA_LAUNCH(D)                                                   \
  ragged_attention_cc_kernel<T, KV, D, QUANT>                               \
      <<<grid, kThreads, 0, stream>>>(                                      \
      static_cast<const T*>(q), static_cast<const KV*>(k),                 \
      static_cast<const KV*>(v), ksc, vsc, tables, row_seq, row_ctx,       \
      static_cast<T*>(out), num_heads, kv_heads, num_blocks, block_size,   \
      num_seqs, max_pages, group, scale)
  switch (head_dim) {
    case 32: PTT_RPA_LAUNCH(32); break;
    case 64: PTT_RPA_LAUNCH(64); break;
    case 128: PTT_RPA_LAUNCH(128); break;
    default: return kUnsupported;
  }
#undef PTT_RPA_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cc

}  // namespace
}  // namespace ptt

// q [rows, num_heads, head_dim] (dtype), pools [num_blocks, kv_heads,
// block_size, head_dim] of the same dtype, or int8 with float32 scales
// [num_blocks, kv_heads, block_size] when quantized; tables [num_seqs,
// max_pages] int32; row_seq / row_ctx [rows] int32; out like q.
// The plan is the caller's (ops/cuda/paged_attention_plan.py:grid_plan):
// on the tensor-core route (bfloat16, head_dim 64 or 128, block_size a
// multiple of 16 that divides 64 or is a multiple of it) `splits` (1..16)
// KV splits a unit may take, `deep` (0 / 1: the grid holds at most one
// block an SM, so the ring takes about 192 KB) and `blocks` (1..rows)
// grid blocks a kv-head and split, each working tiles blocks apart; with
// splits > 1 a float32
// workspace of splits * rows * num_heads * (head_dim + 2) values and
// int32 counters [rows * kv_heads] that are zero (the kernel leaves them
// zero). splits = 1 and deep = 0 elsewhere. Returns 0, a cudaError_t from
// the launch, or -1 for an unsupported shape, type or plan.
extern "C" int ptt_ragged_paged_attention(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int* tables, const int* row_seq,
    const int* row_ctx, void* out, float* workspace, int* counters,
    int rows, int num_heads, int kv_heads, int head_dim, int num_blocks,
    int block_size, int num_seqs, int max_pages, int dtype, int quantized,
    int splits, int deep, int blocks, float scale, void* stream) {
  using namespace ptt;
  if (rows == 0) return 0;
  if (rows < 0 || kv_heads <= 0 || num_heads % kv_heads != 0 ||
      num_heads / kv_heads > cc::kMaxGroup || num_seqs <= 0 ||
      max_pages <= 0 || block_size <= 0 || num_blocks <= 0)
    return kUnsupported;
  if (splits < 1 || splits > paged::kMaxSplits || (deep != 0 && deep != 1) ||
      blocks < 1 || blocks > rows ||
      (splits > 1 && (workspace == nullptr || counters == nullptr)))
    return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (paged::tensor_core_route(dtype, head_dim, block_size)) {
    paged::Params p = {};
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.k_scale = k_scale;
    p.v_scale = v_scale;
    p.tables = tables;
    p.row_seq = row_seq;
    p.row_ctx = row_ctx;
    p.out = static_cast<__nv_bfloat16*>(out);
    p.ws = workspace;
    p.counters = counters;
    p.rows = rows;
    p.num_heads = num_heads;
    p.kv_heads = kv_heads;
    p.num_blocks = num_blocks;
    p.block_size = block_size;
    p.num_seqs = num_seqs;
    p.max_pages = max_pages;
    p.group = num_heads / kv_heads;
    p.tile_rows = paged::tile_rows(p.group);
    p.splits = splits;
    p.deep = deep;
    p.scale_log2 = scale * paged::kLog2e;
    if (head_dim == 64)
      return quantized ? launch_tc<64, true>(p, blocks, k, v, st)
                       : launch_tc<64, false>(p, blocks, k, v, st);
    return quantized ? launch_tc<128, true>(p, blocks, k, v, st)
                     : launch_tc<128, false>(p, blocks, k, v, st);
  }
  if (splits != 1 || deep != 0 || blocks != rows) return kUnsupported;
  if (dtype == kF32) {
    return quantized
        ? cc::launch<float, int8_t, true>(q, k, v, k_scale, v_scale, tables,
                                          row_seq, row_ctx, out, rows,
                                          num_heads, kv_heads, head_dim,
                                          num_blocks, block_size, num_seqs,
                                          max_pages, scale, st)
        : cc::launch<float, float, false>(q, k, v, k_scale, v_scale, tables,
                                          row_seq, row_ctx, out, rows,
                                          num_heads, kv_heads, head_dim,
                                          num_blocks, block_size, num_seqs,
                                          max_pages, scale, st);
  }
  if (dtype == kBF16) {
    return quantized
        ? cc::launch<__nv_bfloat16, int8_t, true>(
              q, k, v, k_scale, v_scale, tables, row_seq, row_ctx, out, rows,
              num_heads, kv_heads, head_dim, num_blocks, block_size, num_seqs,
              max_pages, scale, st)
        : cc::launch<__nv_bfloat16, __nv_bfloat16, false>(
              q, k, v, k_scale, v_scale, tables, row_seq, row_ctx, out, rows,
              num_heads, kv_heads, head_dim, num_blocks, block_size, num_seqs,
              max_pages, scale, st);
  }
  return kUnsupported;
}

// dynamic shared memory a block of the tensor-core kernels takes at
// (head_dim, int8 pool, deep ring), or -1 for a head_dim they do not take
extern "C" int ptt_paged_attention_smem(int head_dim, int quantized,
                                        int deep) {
  using ptt::paged::Cfg;
#define PTT_SMEM(D, Q) \
  Cfg<D, Q>::smem_bytes(deep ? Cfg<D, Q>::kDeepStages : Cfg<D, Q>::kStages)
  if (head_dim == 64) return quantized ? PTT_SMEM(64, true) : PTT_SMEM(64, false);
  if (head_dim == 128)
    return quantized ? PTT_SMEM(128, true) : PTT_SMEM(128, false);
#undef PTT_SMEM
  return -1;
}
