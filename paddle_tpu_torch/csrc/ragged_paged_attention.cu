// Ragged paged attention over the paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   paddle_tpu/ops/pallas/ragged_paged_attention.py:ragged_paged_attention_pallas
//   (kernel body _ragged_kernel).
// What it computes: one flattened batch of rows that mixes decode rows
// and prefill-chunk rows. Row r reads block-table row row_seq[r] and
// sees the pool positions p < row_ctx[r] (that one bound is both the
// context limit and the causal mask inside a prefill chunk). GQA: the
// `group` query heads of kv-head h share its K/V. Softmax is online, in
// float32. Rows with row_ctx <= 0 are exact zeros. An int8 pool carries
// a float32 scale per (page, kv-head, slot); value * scale is formed
// before both products, as the JAX oracle's gather does.
//
// What bounds it on an H100: bytes. Each row reads ctx * d K and V
// values per kv-head and does ~4 * group flops per value read, far
// below the ~295 flop/byte where the tensor cores would bind.
//
// Design (the simple, right form; the fast form is later work):
// - one 128-thread block per (row, kv-head): the block loads its row's
//   page ids itself (CUDA has no scalar prefetch);
// - it walks the visible positions in tiles of 32, staging each tile's
//   K and V slice of its head in shared memory as float32 (dequantized
//   there for int8 pools), so every K/V element is read from device
//   memory once per (row, head); 16-byte vector loads;
// - warp w scores query heads w and w + 4 with one lane per position,
//   keeps that head's running max and sum in registers (warp shuffles),
//   and publishes the correction factor; then every thread updates its
//   slice of the [group, d] float32 accumulator;
// - a page index past the table width is never read (positions are
//   bounded by min(ctx, max_pages * block_size), the oracle's bound), a
//   non-aligned ctx masks by position inside the page, and page ids are
//   clamped into the pool like the oracle's clip-mode gather.
// Not done here: the TPU kernel's first-occurrence dedup of a prefill
// chunk's page walk, split-KV for long contexts, and cp.async/TMA
// double buffering.

#include "common.cuh"

namespace ptt {
namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;      // pool positions per tile: one per lane
constexpr int kMaxGroup = 8;   // query heads per kv-head
constexpr int kHeadsPerWarp = kMaxGroup / kWarps;
constexpr float kNegInf = -1e30f;

template <typename T, typename KV, int D, bool QUANT>
__global__ void __launch_bounds__(kThreads)
ragged_attention_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
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
  ragged_attention_kernel<T, KV, D, QUANT><<<grid, kThreads, 0, stream>>>( \
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

}  // namespace
}  // namespace ptt

// q [rows, num_heads, head_dim] (dtype), pools [num_blocks, kv_heads,
// block_size, head_dim] of the same dtype, or int8 with float32 scales
// [num_blocks, kv_heads, block_size] when quantized; tables [num_seqs,
// max_pages] int32; row_seq / row_ctx [rows] int32; out like q.
// Returns 0, a cudaError_t from the launch, or -1 for an unsupported
// shape or type.
extern "C" int ptt_ragged_paged_attention(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int* tables, const int* row_seq,
    const int* row_ctx, void* out, int rows, int num_heads, int kv_heads,
    int head_dim, int num_blocks, int block_size, int num_seqs,
    int max_pages, int dtype, int quantized, float scale, void* stream) {
  using namespace ptt;
  if (rows == 0) return 0;
  if (rows < 0 || kv_heads <= 0 || num_heads % kv_heads != 0 ||
      num_heads / kv_heads > kMaxGroup || num_seqs <= 0 || max_pages <= 0 ||
      block_size <= 0 || num_blocks <= 0)
    return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    return quantized
        ? launch<float, int8_t, true>(q, k, v, k_scale, v_scale, tables,
                                      row_seq, row_ctx, out, rows, num_heads,
                                      kv_heads, head_dim, num_blocks,
                                      block_size, num_seqs, max_pages, scale, st)
        : launch<float, float, false>(q, k, v, k_scale, v_scale, tables,
                                      row_seq, row_ctx, out, rows, num_heads,
                                      kv_heads, head_dim, num_blocks,
                                      block_size, num_seqs, max_pages, scale, st);
  }
  if (dtype == kBF16) {
    return quantized
        ? launch<__nv_bfloat16, int8_t, true>(
              q, k, v, k_scale, v_scale, tables, row_seq, row_ctx, out, rows,
              num_heads, kv_heads, head_dim, num_blocks, block_size, num_seqs,
              max_pages, scale, st)
        : launch<__nv_bfloat16, __nv_bfloat16, false>(
              q, k, v, k_scale, v_scale, tables, row_seq, row_ctx, out, rows,
              num_heads, kv_heads, head_dim, num_blocks, block_size, num_seqs,
              max_pages, scale, st);
  }
  return kUnsupported;
}

extern "C" const char* ptt_error_string(int code) {
  if (code == ptt::kUnsupported) return "unsupported shape or dtype";
  if (code == ptt::kShortRegisters)
    return "the kernel holds fewer registers a thread than its setmaxnreg "
           "split needs; launched, it would never finish";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
