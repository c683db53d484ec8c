// The device design shared by the two paged-attention kernels for Hopper
// (sm_90a): ragged_paged_attention.cu (mixed prefill + decode rows) and
// paged_attention_decode.cu (one row per sequence). Each .cu file wraps
// the body below in a kernel of its own name, so a profile keeps them
// apart.
//
// What they compute (the TPU kernel _ragged_kernel's function): row r
// reads block-table row row_seq[r] (the decode entry: row r) and sees
// the pool positions p < row_ctx[r], bounded by max_pages * block_size;
// page ids are clamped into the pool; the softmax is online in float32
// with the finite -1e30; the output is acc / max(l, 1e-30), so a row with
// ctx <= 0 is exact zeros; an int8 pool holds values whose float32 scale
// belongs to their (page, kv-head, slot).
//
// What bounds them on an H100: bytes. A unit reads every visible K and V
// row of its kv-head once and does 4 * (query vectors) flops per value,
// far below the ~295 flop/byte where the tensor cores bind.
//
// Design:
// - a unit is (row tile, kv-head): up to R consecutive rows of one
//   sequence, cut at R-aligned rows (R the power of two with R x group <=
//   32; 1 for decode). A prefill chunk's R rows walk their pages once (the
//   TPU kernel's first-occurrence dedup), found from row_seq on the
//   device, with no host sync and no plan kernel: block b of the (blocks,
//   kv-heads, splits) grid scans row_seq 32 rows a ballot and works tiles
//   b, b + blocks, ...; the host sizes blocks to the resident blocks, so
//   no block waits for a slot behind one with nothing to do.
// - split s of a unit walks a contiguous share of its 64-position stages
//   (at least kMinSplitTiles each, and none whose merge traffic would
//   pass its K/V bytes); the host sizes the split count from rows,
//   kv-heads, max_pages, block_size and the SM count (grid_plan in
//   ops/cuda/paged_attention_plan.py). Splits write float32 (m, l, acc)
//   partials; the last to finish (an atomic counter it resets) adds them
//   in split order. No atomics touch the sums: reruns are bit-identical.
// - pages come in by TMA: per 64-position stage one 4-D tensor-map load
//   of each page's K and V rows ([nb, kvh, bs, d] pool: the rows of one
//   kv-head are contiguous) in 128-byte swizzled boxes, plus a 1-D bulk
//   copy of an int8 page's scale rows, into a ring of stages with a full
//   mbarrier each: 3 (bf16, d 128) or 4 stages keep two blocks an SM; a
//   grid of one block an SM takes a ring of ~192 KB. Warp 0 fills the
//   ring; the last warp done with a stage refills it.
// - four warps; a warp takes 32 positions of a stage in one online-softmax
//   step (base 2). Units of at most 8 query vectors (a decode row at
//   group <= 8) run narrow products, positions as rows: S^T = K Q^T and
//   O^T += V^T P^T, P^T's fragments being S^T's accumulator tiles
//   transposed by movmatrix; two warps split a stage and the other two
//   take the next one. Wider units run Q as rows, one m-tile of 16 a warp
//   pair. Products are mma.sync m16n8k16, bf16 operands, float32 sums.
// - the unit's Q is staged once in shared memory; bf16 operands of Q and
//   K are read by ldmatrix from the swizzled layouts (conflict-free), V
//   as 16 consecutive bytes of four positions a lane. int8 K and V are
//   converted in registers: a byte becomes a float32 by a prmt under 2^23
//   and one subtraction, two floats pack by one prmt of their upper
//   halves (no int-to-float instruction); K's int8 order is a head-dim
//   permutation of its own, which Q's words follow.
// - the K scale multiplies the score column; the V scale is folded into
//   p before P is rounded to bfloat16. Rows are masked at their own ctx;
//   16-position chunks past every row's ctx are skipped.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace ptt {
namespace paged {

using bf16 = __nv_bfloat16;

constexpr int kTilePos = 64;       // pool positions a stage holds
constexpr int kComputeWarps = 4;
constexpr int kThreads = 32 * kComputeWarps;
constexpr int kMaxM = 32;          // query vectors of a unit
constexpr int kMaxSplits = 16;     // KV splits of one unit, at most
// a unit splits only where each split keeps this many stages
constexpr int kMinSplitTiles = 4;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const bf16* q;          // [rows, num_heads, D]
  const float* k_scale;   // int8 pools: [num_blocks, kv_heads, block_size]
  const float* v_scale;
  const int* tables;      // [num_seqs, max_pages]
  const int* row_seq;     // [rows]; nullptr: row r reads table row r
  const int* row_ctx;     // [rows]
  bf16* out;              // [rows, num_heads, D]
  // splits > 1: float32 partial sums [splits, rows, num_heads, D], then
  // (m, l) [splits, rows, num_heads, 2]; split s of a unit writes slot s
  float* ws;
  // [rows * kv_heads], zero between calls: arrivals of a unit's splits
  int* counters;
  int rows, num_heads, kv_heads, num_blocks, block_size, num_seqs,
      max_pages;
  int group, tile_rows;
  int splits;  // KV splits a unit may take (gridDim.z)
  int deep;    // 1: a grid of at most one block an SM, the deep ring
  float scale_log2;       // softmax scale * log2(e): base-2 exponentials
};

// the tensor-core route: bfloat16 q, head_dim 64 or 128, and pages that
// are whole 16-position chunks and tile a 64-position stage (or are
// tiled by it)
inline bool tensor_core_route(int dtype, int head_dim, int block_size) {
  return dtype == kBF16 && (head_dim == 64 || head_dim == 128) &&
         block_size % 16 == 0 &&
         (block_size % kTilePos == 0 || kTilePos % block_size == 0);
}

// R, the most rows of one row tile of the ragged entry: the largest power
// of two whose rows hold at most kMaxM query vectors (a tile never spans
// a 32-row ballot)
inline int tile_rows(int group) {
  int r = kMaxM;
  while (r > 1 && r * group > kMaxM) r >>= 1;
  return r;
}

template <int D, bool QUANT>
struct Cfg {
  static constexpr int kElt = QUANT ? 1 : 2;           // bytes a value
  static constexpr int kRowBytes = D * kElt;           // one pool row
  static constexpr int kBoxBytes = kRowBytes < 128 ? kRowBytes : 128;
  static constexpr int kBoxes = kRowBytes / kBoxBytes; // boxes a row
  static constexpr bool kSwizzle = kBoxBytes == 128;
  static constexpr int kBoxD = kBoxBytes / kElt;       // head dims a box
  static constexpr int kChunks = kBoxBytes / 16;       // 16-byte chunks
  static constexpr int kCPL = kChunks / 4;   // K chunks a lane, per box
  static constexpr int kKPC = 4 / kElt;      // k-steps a K chunk holds
  static constexpr int kKSteps = D / 16;
  static constexpr int kVW = kBoxD / 8;      // V columns a lane, per box
  static constexpr int kNT = D / 8;          // n-tiles of P V
  static constexpr int kBoxStride = kTilePos * kBoxBytes;
  static constexpr int kKVBytes = kTilePos * kRowBytes;  // K (or V)
  static constexpr int kStageBytes =
      2 * kKVBytes + (QUANT ? 2 * kTilePos * 4 : 0);
  static constexpr int kStagePitch = (kStageBytes + 1023) / 1024 * 1024;
  // the ring: kStages keeps two blocks an SM; a grid of at most one block
  // an SM takes kDeepStages (about 192 KB), twice the bytes in flight
  static constexpr int kStages = kStagePitch > 24576 ? 3 : 4;
  static constexpr int kDeepStages = 196608 / kStagePitch;
  static constexpr int kRingBytes = kStages * kStagePitch;
  // the compute warps' partial sums, merged after the walk (in the ring)
  static constexpr int kScratchLD = D + 4;
  static constexpr int kScratchBytes =
      kComputeWarps * 16 * (kScratchLD + 2) * 4;
  // the unit's Q rows, bfloat16, as kMaxM rows of D / 64 swizzled boxes
  static constexpr int kQBytes = kMaxM * D * 2;
  // Q and the ring of `stages` at a 1024-byte boundary, the ring's
  // mbarriers and the last-split flag
  static constexpr int smem_bytes(int stages) {
    return 1024 + kQBytes + stages * kStagePitch + 2 * stages * 8 + 16;
  }
  static_assert(kKSteps == kBoxes * kCPL * kKPC, "k-steps do not tile d");
  static_assert(kNT == kBoxes * kVW, "n-tiles do not tile d");
  static_assert(kScratchBytes <= kRingBytes, "scratch exceeds the ring");
  static_assert(smem_bytes(kDeepStages) <= 232448, "deep ring too large");
};

// ---- PTX ------------------------------------------------------------------

// a 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into shared memory, counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(hopper::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(hopper::smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// MUFU's exp2; a result below 2^-126 flushes to 0, which adds nothing to
// a float32 sum whose largest term is 1
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// byte j of w (int8) as float32, exactly: under 2^23 by one prmt, then
// one subtraction
__device__ __forceinline__ float i8_float(uint32_t w, int j) {
  return __uint_as_float(
             __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7650 | j)) -
         8388736.f;  // 2^23 + 128
}

// two small integers held exactly as float32 as a bfloat16x2 (lo in the
// low half): their low 16 bits are zero, so the upper halves are exact
__device__ __forceinline__ uint32_t ints_bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- the unit ---------------------------------------------------------------

// output row (rows x heads) of query vector m of the unit at row r0,
// kv-head h
__device__ __forceinline__ long long out_row(const Params& p, int r0, int h,
                                             int m) {
  return (long long)(r0 + m / p.group) * p.num_heads + h * p.group +
         m % p.group;
}

// the 8x8 bfloat16 tile the warp holds one register a lane (lane 4 r + c
// holding row r, columns 2 c and 2 c + 1), transposed
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;"
               : "=r"(y) : "r"(x));
  return y;
}

// two int8s (byte j0 of w0, byte j1 of w1) as a bfloat16x2
__device__ __forceinline__ uint32_t i8x2(uint32_t w0, int j0, uint32_t w1,
                                         int j1) {
  return ints_bf16x2(i8_float(w0, j0), i8_float(w1, j1));
}

// byte offset of 16-byte chunk c of row `row` in a region of 128-byte
// swizzled boxes of `rows` rows (the TMA layout of the stages, and of Q)
__device__ __forceinline__ int swz(int row, int c, int rows) {
  return (c >> 3) * rows * 128 + row * 128 + (((c & 7) ^ (row & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// word w (head dims 2 w, 2 w + 1) of row m of the staged Q
__device__ __forceinline__ uint32_t q_word(const unsigned char* qs, int m,
                                           int w) {
  return *reinterpret_cast<const uint32_t*>(
      qs + swz(m, w >> 2, kMaxM) + 4 * (w & 3));
}

// the head-dim order of the int8 K reads: k-step (cs, kk) of lane t takes
// words lo = (d0 + 4 kk) / 2 (k-indices 2t, 2t + 1) and lo + 1 (2t + 8,
// 2t + 9) of a row, d0 = (kCPL t + cs) * 16
template <int D, bool QUANT>
__device__ __forceinline__ int k_word(int ks, int t) {
  using C = Cfg<D, QUANT>;
  const int kk = ks % C::kKPC, bc = ks / C::kKPC;
  const int b = bc / C::kCPL, cs = bc % C::kCPL;
  return (b * C::kBoxD + (C::kCPL * t + cs) * (16 / C::kElt) + 4 * kk) / 2;
}

// four 8 x 8 bfloat16 matrices of a swizzled region with `rows` rows, in
// natural head-dim order: lane i gives row r0 + (i & 7) + 8 * ((i >> 3) &
// rbit ? 1 : 0) at head dims 16 ks + 8 * ((i >> 3) & dbit ? 1 : 0); r[j] is
// matrix j. A fragments: rbit 1, dbit 2; two n-tiles of B: rbit 2, dbit 1
__device__ __forceinline__ void ldsm_tile(const unsigned char* base, int rows,
                                          int r0, int ks, int lane, int rbit,
                                          int dbit, uint32_t (&r)[4]) {
  const int mat = lane >> 3;
  const int row = r0 + (lane & 7) + ((mat & rbit) ? 8 : 0);
  const int c = 2 * ks + ((mat & dbit) ? 1 : 0);
  ldsm_x4(hopper::smem_u32(base + swz(row, c, rows)), r);
}

// the four k-step registers (k-indices 2t, 2t + 1 / 2t + 8, 2t + 9) of
// stage rows ra and rb at k-step kk of chunk (b, cs), as an mma operand
// {row ra lo, row rb lo, row ra hi, row rb hi}
template <int D, bool QUANT>
__device__ __forceinline__ void k_rows(const unsigned char* sb, int b, int cs,
                                       int t, int ra, int rb,
                                       uint32_t (&wa)[4], uint32_t (&wb)[4]) {
  using C = Cfg<D, QUANT>;
  const int lc = C::kCPL * t + cs;
  const int pa = C::kSwizzle ? (lc ^ (ra & 7)) : lc;
  const int pb = C::kSwizzle ? (lc ^ (rb & 7)) : lc;
  const uint4 x = *reinterpret_cast<const uint4*>(
      sb + b * C::kBoxStride + ra * C::kBoxBytes + pa * 16);
  const uint4 y = *reinterpret_cast<const uint4*>(
      sb + b * C::kBoxStride + rb * C::kBoxBytes + pb * 16);
  wa[0] = x.x; wa[1] = x.y; wa[2] = x.z; wa[3] = x.w;
  wb[0] = y.x; wb[1] = y.y; wb[2] = y.z; wb[3] = y.w;
}

// k-step kk's pair of k-indices (lo: 2t, 2t + 1; hi: 2t + 8, 2t + 9) of a
// K chunk word set, as bfloat16x2
template <bool QUANT>
__device__ __forceinline__ uint32_t k_pair(const uint32_t (&w)[4], int kk,
                                           int hi) {
  if constexpr (QUANT) return i8x2(w[kk], 2 * hi, w[kk], 2 * hi + 1);
  return w[2 * kk + hi];
}

// the V rows of positions r0 + {0, 1, 8, 9} that lane g reads in box b:
// kVW * kElt bytes at its chunk (16 bytes; int8 at head_dim 64: 8)
template <int D, bool QUANT>
__device__ __forceinline__ void v_rows(const unsigned char* vb, int r0,
                                       int g, uint32_t (&v)[4][4]) {
  using C = Cfg<D, QUANT>;
  const int rr[4] = {r0, r0 + 1, r0 + 8, r0 + 9};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (C::kVW * C::kElt == 16) {
      const int pc = C::kSwizzle ? (g ^ (rr[q] & 7)) : g;
      const uint4 x = *reinterpret_cast<const uint4*>(
          vb + rr[q] * C::kBoxBytes + pc * 16);
      v[q][0] = x.x; v[q][1] = x.y; v[q][2] = x.z; v[q][3] = x.w;
    } else {
      const uint2 x =
          *reinterpret_cast<const uint2*>(vb + rr[q] * C::kBoxBytes + 8 * g);
      v[q][0] = x.x; v[q][1] = x.y; v[q][2] = v[q][3] = 0u;
    }
  }
}

// column e (0 .. kVW - 1) of V rows qa and qb as bfloat16x2 {row qa, row qb}
template <bool QUANT>
__device__ __forceinline__ uint32_t v_pair(const uint32_t (&a)[4],
                                           const uint32_t (&b)[4], int e) {
  if constexpr (QUANT) return i8x2(a[e >> 2], e & 3, b[e >> 2], e & 3);
  return __byte_perm(a[e >> 1], b[e >> 1], (e & 1) ? 0x7632u : 0x5410u);
}

template <int D, bool QUANT>
__device__ __forceinline__ void attention_unit(const Params& p,
                                               const CUtensorMap* tk,
                                               const CUtensorMap* tv,
                                               unsigned char* smem_raw) {
  using C = Cfg<D, QUANT>;
  constexpr int KS = C::kKSteps;
  const int h = blockIdx.y, split = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pos_cap = p.max_pages * p.block_size;
  const long long n_out = (long long)p.rows * p.num_heads;
  float* ws_ml = p.ws + (long long)p.splits * n_out * D;
  const int n_st = p.deep ? C::kDeepStages : C::kStages;

  if (threadIdx.x == 0) {  // the maps, ahead of the first copy
    hopper::tma_prefetch(tk);
    hopper::tma_prefetch(tv);
  }

  // aligned by an offset, not through an integer: the compiler keeps the
  // shared address space and reads the stages with LDS
  unsigned char* qs =
      smem_raw + ((1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* ring = qs + C::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + n_st * C::kStagePitch);
  int* released = reinterpret_cast<int*>(full + n_st);  // warps done, a stage
  int* last = released + n_st;
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_st; ++s) {
      hopper::mbar_init(full + s, 1);
      released[s] = 0;
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  float* so = reinterpret_cast<float*>(ring);  // [warp][16][kScratchLD]
  float* sml = so + kComputeWarps * 16 * C::kScratchLD;  // [warp][16][2]

  // block b works tiles b, b + gridDim.x, ... of the launch; every warp
  // finds them alike from row_seq, 32 rows a ballot
  int it = 0;                // stages this block has walked: ring phase
  int scan = 0, before = 0;  // first row of the 32-row chunk, its tiles
  for (int k = blockIdx.x;; k += gridDim.x) {
    int r0 = -1, n_rows = 0, seq = 0;
    if (p.row_seq == nullptr) {  // decode: one tile a row
      if (k < p.rows) r0 = seq = k, n_rows = 1;
    } else {
      const int R = p.tile_rows;  // a power of two <= 32
      while (scan < p.rows) {
        const int r = scan + lane;
        // row r starts a tile: R-aligned, or its sequence differs from
        // the row before
        const unsigned bits = __ballot_sync(
            0xffffffffu, r < p.rows && (r % R == 0 ||
                                        __ldg(p.row_seq + r) !=
                                            __ldg(p.row_seq + r - 1)));
        const int n = __popc(bits);
        if (before + n > k) {
          const int pos = __fns(bits, 0, k - before + 1);
          const unsigned after = bits & ~((2u << pos) - 1u);
          r0 = scan + pos;
          n_rows = (after ? __ffs(after) - 1 : min(32, p.rows - scan)) - pos;
          seq = min(max(__ldg(p.row_seq + r0), 0), p.num_seqs - 1);
          break;
        }
        before += n;
        scan += 32;
      }
    }
    if (r0 < 0) break;  // no tile left

    // the unit's M query vectors; up to 8 take the narrow products
    // (positions as rows: S^T = K Q^T, O^T = V^T P^T), more the wide ones
    // (query vectors as rows, one or two m-tiles)
    const int M = n_rows * p.group;
    const bool narrow = M <= 8;
    const int n_mt = narrow ? 1 : (M + 15) / 16;
    // a warp takes 32 positions of a stage in one softmax step; the warps
    // of one m-tile split a stage in halves and, when four share it, take
    // alternate stages
    const int n_share = kComputeWarps / n_mt;
    const int mt = warp % n_mt, share = warp / n_mt;
    const int n_groups = n_share / 2, group = share / 2;
    const int lrow0 = (share & 1) * 32;  // the warp's first position

    const int* trow = p.tables + (long long)seq * p.max_pages;
    int page = 0;  // table entries win .. win + 31, one a lane
    if (lane < p.max_pages) page = __ldg(trow + lane);
    auto ctx_of = [&](int m) {
      return m < M ? min(max(__ldg(p.row_ctx + r0 + m / p.group), 0), pos_cap)
                   : 0;
    };
    int n_pos = 0;  // positions the unit walks: its rows' largest ctx
    {
      const int c = lane < n_rows
                        ? min(max(__ldg(p.row_ctx + r0 + lane), 0), pos_cap)
                        : 0;
      n_pos = __reduce_max_sync(0xffffffffu, c);
    }
    // this split's stages (paged_attention_plan.split_tiles is the same
    // rule): the unit's stages cut into eff contiguous shares of at least
    // kMinSplitTiles (one share when fewer), fewer where a share's merge
    // traffic would pass the K/V bytes it walks
    const int nt = (n_pos + kTilePos - 1) / kTilePos;
    int eff = min(min(p.splits, nt), max(1, nt / kMinSplitTiles));
    if (p.splits > 1) {
      const long long kv =
          (long long)n_pos * (2 * C::kRowBytes + (QUANT ? 8 : 0));
      const long long merge = (long long)M * (D + 2) * 8;
      eff = min(eff, (int)max(1LL, kv / merge));
    }
    if (eff == 0) {  // nothing visible: split 0 writes exact zeros
      if (split == 0)
        for (int i = threadIdx.x; i < M * D; i += kThreads)
          p.out[out_row(p, r0, h, i / D) * D + i % D] = __float2bfloat16(0.f);
      continue;
    }
    if (split >= eff) continue;
    const int t_begin = split * nt / eff;
    const int n_tiles = (split + 1) * nt / eff - t_begin;

    // the copies of the unit's stage i (a whole warp calls it; lane 0
    // issues, the table entries come from the warp's window)
    const int bs = p.block_size;
    const int rows_pg = bs < kTilePos ? bs : kTilePos;  // rows a box
    int win = 0;
    auto issue = [&](int i) {
      const int st = (it + i) % n_st;
      const int base = (t_begin + i) * kTilePos;
      const int end = min(base + kTilePos, n_pos);
      const int pg0 = base / bs, pg1 = (end - 1) / bs;
      if (pg1 >= win + 32) {
        win = pg0;
        page = win + lane < p.max_pages ? __ldg(trow + win + lane) : 0;
      }
      unsigned char* sb = ring + st * C::kStagePitch;
      if (lane == 0) {
        hopper::mbar_arrive_tx(full + st,
                               (pg1 - pg0 + 1) * rows_pg *
                                   (2 * C::kRowBytes + (QUANT ? 8 : 0)));
      }
      for (int pg = pg0; pg <= pg1; ++pg) {
        const int id = __shfl_sync(0xffffffffu, page, pg - win);
        if (lane == 0) {
          const int pid = min(max(id, 0), p.num_blocks - 1);
          const int slot0 = bs < kTilePos ? 0 : base % bs;
          const int row0 = bs < kTilePos ? pg * bs - base : 0;
#pragma unroll
          for (int b = 0; b < C::kBoxes; ++b) {
            const int off = b * C::kBoxStride + row0 * C::kBoxBytes;
            hopper::tma_load_4d(sb + off, tk, full + st, b * C::kBoxD, slot0,
                                h, pid);
            hopper::tma_load_4d(sb + C::kKVBytes + off, tv, full + st,
                                b * C::kBoxD, slot0, h, pid);
          }
          if constexpr (QUANT) {
            const long long so_ =
                ((long long)pid * p.kv_heads + h) * bs + slot0;
            float* scl = reinterpret_cast<float*>(sb + 2 * C::kKVBytes);
            bulk_load(scl + row0, p.k_scale + so_, rows_pg * 4, full + st);
            bulk_load(scl + kTilePos + row0, p.v_scale + so_, rows_pg * 4,
                      full + st);
          }
        }
      }
    };
    // warp 0 fills the ring (in stage order: the first stage lands first);
    // afterwards the last of the four warps to be done with a stage
    // refills it with the unit's stage n_st later (its reads are done:
    // `released` orders them before the copy). The previous unit's sums
    // were written to the ring through the generic proxy: a proxy fence
    // orders them before this unit's copies.
    if (warp == 0) {
      if (lane == 0 && k != (int)blockIdx.x)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      for (int i = 0; i < min(n_st, n_tiles); ++i) issue(i);
    }
    // the unit's Q rows, staged once (zeros past M): every load issued
    // before the first store
    {
      constexpr int kPer = kMaxM * (D / 8) / kThreads;
      uint4 x[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = threadIdx.x + u * kThreads;
        const int m = i / (D / 8), c = i % (D / 8);
        x[u] = m < M ? __ldg(reinterpret_cast<const uint4*>(
                                 p.q + out_row(p, r0, h, m) * D) + c)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = threadIdx.x + u * kThreads;
        *reinterpret_cast<uint4*>(qs + swz(i / (D / 8), i % (D / 8), kMaxM)) =
            x[u];
      }
    }
    __syncthreads();  // Q is staged
    // the unit's stages: step(sb, tile0, nkc) on the warp's own (nkc: its
    // 16-position chunks that some row sees, 1 or 2)
    auto walk = [&](auto&& step) {
      for (int i = 0; i < n_tiles; ++i) {
        const int st = (it + i) % n_st;
        hopper::mbar_wait(full + st, ((it + i) / n_st) & 1);
        const int tile0 = (t_begin + i) * kTilePos;
        const int nkc =
            i % n_groups == group
                ? (min(32, max(0, n_pos - tile0 - lrow0)) + 15) >> 4
                : 0;
        if (nkc > 0) step(ring + st * C::kStagePitch, tile0, nkc);
        __syncwarp();
        int done = 0;
        if (lane == 0) {
          __threadfence_block();
          done = atomicAdd(released + st, 1) == kComputeWarps - 1;
          if (done) {
            released[st] = 0;
            __threadfence_block();
          }
        }
        if (__shfl_sync(0xffffffffu, done, 0) && i + n_st < n_tiles)
          issue(i + n_st);
      }
    };

    if (narrow) {
      // ---- positions as rows: per 16 positions S^T [16 x 8] = K Q^T and
      // O^T [16 head dims x 8] += V^T P^T; lane (g, t) scores query
      // vectors 2t, 2t + 1 at positions g, g + 8 of a chunk
      // Q^T's B fragments: query vector g; K's A fragments by ldmatrix in
      // natural head-dim order (bfloat16), or converted from the int8
      // stage in the K reads' order
      uint32_t qb[KS][2];
#pragma unroll
      for (int ks = 0; ks < KS; ks += 2) {
        if constexpr (QUANT) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int lo = k_word<D, QUANT>(ks + u, t);
            qb[ks + u][0] = q_word(qs, g, lo);
            qb[ks + u][1] = q_word(qs, g, lo + 1);
          }
        } else {
          // matrices (rows 0-7; chunk 2 ks + j): b0, b1 of ks and ks + 1
          uint32_t r[4];
          ldsm_x4(hopper::smem_u32(qs + swz(lane & 7, 2 * ks + (lane >> 3),
                                            kMaxM)), r);
          qb[ks][0] = r[0];
          qb[ks][1] = r[1];
          qb[ks + 1][0] = r[2];
          qb[ks + 1][1] = r[3];
        }
      }
      const int ctx0 = ctx_of(2 * t), ctx1 = ctx_of(2 * t + 1);
      constexpr int MD = D / 16;  // m-tiles of O^T
      float on[MD][4];
#pragma unroll
      for (int j = 0; j < MD; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) on[j][e] = 0.f;
      float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
      walk([&](const unsigned char* sb, int tile0, int nkc) {
        const float* ksc = reinterpret_cast<const float*>(sb + 2 * C::kKVBytes);
        const float* vsc = ksc + kTilePos;
        float s[2][4], s2[2][4];  // chunk, two accumulators
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[c][e] = s2[c][e] = 0.f;
        auto scores = [&](auto nc) {
          constexpr int NC = decltype(nc)::value;
          if constexpr (QUANT) {
#pragma unroll
            for (int b = 0; b < C::kBoxes; ++b)
#pragma unroll
              for (int cs = 0; cs < C::kCPL; ++cs) {
                uint32_t wa[NC][4], wb[NC][4];
#pragma unroll
                for (int c = 0; c < NC; ++c)
                  k_rows<D, QUANT>(sb, b, cs, t, lrow0 + 16 * c + g,
                                   lrow0 + 16 * c + g + 8, wa[c], wb[c]);
#pragma unroll
                for (int kk = 0; kk < C::kKPC; ++kk)
#pragma unroll
                  for (int c = 0; c < NC; ++c) {
                    const uint32_t a[4] = {k_pair<QUANT>(wa[c], kk, 0),
                                           k_pair<QUANT>(wb[c], kk, 0),
                                           k_pair<QUANT>(wa[c], kk, 1),
                                           k_pair<QUANT>(wb[c], kk, 1)};
                    const int ks = (b * C::kCPL + cs) * C::kKPC + kk;
                    mma_16816((ks & 1) ? s2[c] : s[c], a, qb[ks][0],
                              qb[ks][1]);
                  }
              }
          } else {
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
#pragma unroll
              for (int c = 0; c < NC; ++c) {
                uint32_t a[4];
                ldsm_tile(sb, kTilePos, lrow0 + 16 * c, ks, lane, 1, 2, a);
                mma_16816((ks & 1) ? s2[c] : s[c], a, qb[ks][0], qb[ks][1]);
              }
          }
        };
        if (nkc == 2)
          scores(std::integral_constant<int, 2>{});
        else
          scores(std::integral_constant<int, 1>{});
        // scale, mask each query vector at its own ctx, one online-softmax
        // step for the warp's 32 positions (values of one query vector lie
        // in the lanes of one t: reduce over g)
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int lp = lrow0 + 16 * c + g;
          const int ap = tile0 + lp;
          float f0 = p.scale_log2, f8 = p.scale_log2;
          if constexpr (QUANT) {
            if (c < nkc) {
              f0 *= ksc[lp];
              f8 *= ksc[lp + 8];
            }
          }
          s[c][0] = ap < ctx0 ? (s[c][0] + s2[c][0]) * f0 : kNegInf;
          s[c][1] = ap < ctx1 ? (s[c][1] + s2[c][1]) * f0 : kNegInf;
          s[c][2] = ap + 8 < ctx0 ? (s[c][2] + s2[c][2]) * f8 : kNegInf;
          s[c][3] = ap + 8 < ctx1 ? (s[c][3] + s2[c][3]) * f8 : kNegInf;
          mx0 = fmaxf(mx0, fmaxf(s[c][0], s[c][2]));
          mx1 = fmaxf(mx1, fmaxf(s[c][1], s[c][3]));
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
        }
        const float new0 = fmaxf(m_run[0], mx0), new1 = fmaxf(m_run[1], mx1);
        const float r0c = exp2_ftz(m_run[0] - new0);
        const float r1c = exp2_ftz(m_run[1] - new1);
        m_run[0] = new0;
        m_run[1] = new1;
        float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int ap = tile0 + lrow0 + 16 * c + g;
          s[c][0] = ap < ctx0 ? exp2_ftz(s[c][0] - new0) : 0.f;
          s[c][1] = ap < ctx1 ? exp2_ftz(s[c][1] - new1) : 0.f;
          s[c][2] = ap + 8 < ctx0 ? exp2_ftz(s[c][2] - new0) : 0.f;
          s[c][3] = ap + 8 < ctx1 ? exp2_ftz(s[c][3] - new1) : 0.f;
          ls0 += s[c][0] + s[c][2];
          ls1 += s[c][1] + s[c][3];
        }
        l_run[0] = l_run[0] * r0c + ls0;
        l_run[1] = l_run[1] * r1c + ls1;
#pragma unroll
        for (int j = 0; j < MD; ++j) {
          on[j][0] *= r0c;
          on[j][1] *= r1c;
          on[j][2] *= r0c;
          on[j][3] *= r1c;
        }
        // O^T += V^T P^T: P^T's B fragments are S^T's accumulator tiles
        // transposed; V^T's A rows of m-tile (b, e2) are head dims
        // b * kBoxD + kVW * g + 2 e2 (row g) and + 1 (row g + 8)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (c < nkc) {
            float q0 = s[c][0], q1 = s[c][1], q2 = s[c][2], q3 = s[c][3];
            if constexpr (QUANT) {
              const float va = vsc[lrow0 + 16 * c + g];
              const float vb8 = vsc[lrow0 + 16 * c + g + 8];
              q0 *= va; q1 *= va; q2 *= vb8; q3 *= vb8;
            }
            const uint32_t b0 = transpose8(pack_bf16x2(q0, q1));
            const uint32_t b1 = transpose8(pack_bf16x2(q2, q3));
#pragma unroll
            for (int b = 0; b < C::kBoxes; ++b) {
              uint32_t v[4][4];
              v_rows<D, QUANT>(sb + C::kKVBytes + b * C::kBoxStride,
                               lrow0 + 16 * c + 2 * t, g, v);
#pragma unroll
              for (int e2 = 0; e2 < C::kVW / 2; ++e2) {
                const uint32_t a[4] = {v_pair<QUANT>(v[0], v[1], 2 * e2),
                                       v_pair<QUANT>(v[0], v[1], 2 * e2 + 1),
                                       v_pair<QUANT>(v[2], v[3], 2 * e2),
                                       v_pair<QUANT>(v[2], v[3], 2 * e2 + 1)};
                mma_16816(on[b * (C::kVW / 2) + e2], a, b0, b1);
              }
            }
          }
        }
      });
      // the row sums over the lanes of one t
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        l_run[0] += __shfl_xor_sync(0xffffffffu, l_run[0], o);
        l_run[1] += __shfl_xor_sync(0xffffffffu, l_run[1], o);
      }
      __syncthreads();  // every stage is consumed: the ring takes the sums
      float* w0 = so + (warp * 16 + 2 * t) * C::kScratchLD;
      float* w1 = w0 + C::kScratchLD;
#pragma unroll
      for (int j = 0; j < MD; ++j) {
        const int b = j / (C::kVW / 2), e2 = j % (C::kVW / 2);
        const int d0 = b * C::kBoxD + C::kVW * g + 2 * e2;
        w0[d0] = on[j][0];
        w1[d0] = on[j][1];
        w0[d0 + 1] = on[j][2];
        w1[d0 + 1] = on[j][3];
      }
      if (g == 0) {
        float* ml = sml + (warp * 16 + 2 * t) * 2;
        ml[0] = m_run[0];
        ml[1] = l_run[0];
        ml[2] = m_run[1];
        ml[3] = l_run[1];
      }
    } else {
      // ---- query vectors as rows: per 16 positions S [16 x 8] = Q K^T
      // and O [16 x 8 head dims] += P V for m-tile mt; lane (g, t) holds
      // query vectors 16 mt + g, + 8
      const int mA = 16 * mt + g, mB = mA + 8;
      uint32_t qq[KS][4];  // Q's A fragments: rows mA, mB
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if constexpr (QUANT) {
          const int lo = k_word<D, QUANT>(ks, t);
          qq[ks][0] = q_word(qs, mA, lo);
          qq[ks][1] = q_word(qs, mB, lo);
          qq[ks][2] = q_word(qs, mA, lo + 1);
          qq[ks][3] = q_word(qs, mB, lo + 1);
        } else {
          ldsm_tile(qs, kMaxM, 16 * mt, ks, lane, 1, 2, qq[ks]);
        }
      }
      const int ctxA = ctx_of(mA), ctxB = ctx_of(mB);
      float o[C::kNT][4];
#pragma unroll
      for (int j = 0; j < C::kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
      float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
      walk([&](const unsigned char* sb, int tile0, int nkc) {
        const float* ksc = reinterpret_cast<const float*>(sb + 2 * C::kKVBytes);
        const float* vsc = ksc + kTilePos;
        // S: n-tile j holds positions lrow0 + 8 j + (0..7); k-steps
        // outside, n-tiles inside (independent accumulators)
        float s[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        auto scores = [&](auto nj) {
          constexpr int NJ = decltype(nj)::value;
          if constexpr (QUANT) {
#pragma unroll
            for (int b = 0; b < C::kBoxes; ++b)
#pragma unroll
              for (int cs = 0; cs < C::kCPL; ++cs) {
                uint32_t w[NJ][4];
#pragma unroll
                for (int j = 0; j < NJ; j += 2)
                  k_rows<D, QUANT>(sb, b, cs, t, lrow0 + 8 * j + g,
                                   lrow0 + 8 * (j + 1) + g, w[j], w[j + 1]);
#pragma unroll
                for (int kk = 0; kk < C::kKPC; ++kk)
#pragma unroll
                  for (int j = 0; j < NJ; ++j)
                    mma_16816(s[j], qq[(b * C::kCPL + cs) * C::kKPC + kk],
                              k_pair<QUANT>(w[j], kk, 0),
                              k_pair<QUANT>(w[j], kk, 1));
              }
          } else {
            // K's B fragments by ldmatrix, two n-tiles at a time
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
#pragma unroll
              for (int j = 0; j < NJ; j += 2) {
                uint32_t bk[4];
                ldsm_tile(sb, kTilePos, lrow0 + 8 * j, ks, lane, 2, 1, bk);
                mma_16816(s[j], qq[ks], bk[0], bk[1]);
                mma_16816(s[j + 1], qq[ks], bk[2], bk[3]);
              }
          }
        };
        if (nkc == 2)
          scores(std::integral_constant<int, 4>{});
        else
          scores(std::integral_constant<int, 2>{});
        // scale, mask each row at its own ctx, one online-softmax step
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int lp = lrow0 + 8 * j + 2 * t;
          const int ap = tile0 + lp;
          float f0 = p.scale_log2, f1 = p.scale_log2;
          if constexpr (QUANT) {
            if (j < 2 * nkc) {
              const float2 kq = *reinterpret_cast<const float2*>(ksc + lp);
              f0 *= kq.x;
              f1 *= kq.y;
            }
          }
          s[j][0] = ap < ctxA ? s[j][0] * f0 : kNegInf;
          s[j][1] = ap + 1 < ctxA ? s[j][1] * f1 : kNegInf;
          s[j][2] = ap < ctxB ? s[j][2] * f0 : kNegInf;
          s[j][3] = ap + 1 < ctxB ? s[j][3] * f1 : kNegInf;
          mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
          mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
        }
        const float new0 = fmaxf(m_run[0], quad_max(mx0));
        const float new1 = fmaxf(m_run[1], quad_max(mx1));
        const float r0c = exp2_ftz(m_run[0] - new0);
        const float r1c = exp2_ftz(m_run[1] - new1);
        m_run[0] = new0;
        m_run[1] = new1;
        float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ap = tile0 + lrow0 + 8 * j + 2 * t;
          s[j][0] = ap < ctxA ? exp2_ftz(s[j][0] - new0) : 0.f;
          s[j][1] = ap + 1 < ctxA ? exp2_ftz(s[j][1] - new0) : 0.f;
          s[j][2] = ap < ctxB ? exp2_ftz(s[j][2] - new1) : 0.f;
          s[j][3] = ap + 1 < ctxB ? exp2_ftz(s[j][3] - new1) : 0.f;
          ls0 += s[j][0] + s[j][1];
          ls1 += s[j][2] + s[j][3];
        }
        l_run[0] = l_run[0] * r0c + ls0;
        l_run[1] = l_run[1] * r1c + ls1;
#pragma unroll
        for (int j = 0; j < C::kNT; ++j) {
          o[j][0] *= r0c;
          o[j][1] *= r0c;
          o[j][2] *= r1c;
          o[j][3] *= r1c;
        }
        // O += P V over the seen chunks: lane (g, t) feeds positions 2t,
        // 2t + 1, 2t + 8, 2t + 9 of a chunk and, per box, head dims
        // b * kBoxD + kVW * g + e as column g of n-tile b * kVW + e
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (c < nkc) {
            float pa[4] = {s[2 * c][0], s[2 * c][1], s[2 * c][2],
                           s[2 * c][3]};
            float pb[4] = {s[2 * c + 1][0], s[2 * c + 1][1],
                           s[2 * c + 1][2], s[2 * c + 1][3]};
            const int R0 = lrow0 + 16 * c + 2 * t;
            if constexpr (QUANT) {
              const float2 va = *reinterpret_cast<const float2*>(vsc + R0);
              const float2 vb = *reinterpret_cast<const float2*>(vsc + R0 + 8);
              pa[0] *= va.x; pa[1] *= va.y; pa[2] *= va.x; pa[3] *= va.y;
              pb[0] *= vb.x; pb[1] *= vb.y; pb[2] *= vb.x; pb[3] *= vb.y;
            }
            const uint32_t a[4] = {pack_bf16x2(pa[0], pa[1]),
                                   pack_bf16x2(pa[2], pa[3]),
                                   pack_bf16x2(pb[0], pb[1]),
                                   pack_bf16x2(pb[2], pb[3])};
#pragma unroll
            for (int b = 0; b < C::kBoxes; ++b) {
              uint32_t v[4][4];
              v_rows<D, QUANT>(sb + C::kKVBytes + b * C::kBoxStride, R0, g,
                               v);
#pragma unroll
              for (int e = 0; e < C::kVW; ++e)
                mma_16816(o[b * C::kVW + e], a, v_pair<QUANT>(v[0], v[1], e),
                          v_pair<QUANT>(v[2], v[3], e));
            }
          }
        }
      });
      l_run[0] = quad_sum(l_run[0]);
      l_run[1] = quad_sum(l_run[1]);
      __syncthreads();  // every stage is consumed: the ring takes the sums
      float* w0 = so + (warp * 16 + g) * C::kScratchLD;
      float* w1 = w0 + 8 * C::kScratchLD;
#pragma unroll
      for (int j = 0; j < C::kNT; ++j) {
        const int b = j / C::kVW, e = j % C::kVW;
        const int d0 = b * C::kBoxD + C::kVW * 2 * t + e;
        w0[d0] = o[j][0];
        w0[d0 + C::kVW] = o[j][1];
        w1[d0] = o[j][2];
        w1[d0 + C::kVW] = o[j][3];
      }
      if (t == 0) {
        float* ml = sml + (warp * 16 + g) * 2;
        ml[0] = m_run[0];
        ml[1] = l_run[0];
        ml[16] = m_run[1];
        ml[17] = l_run[1];
      }
    }
    it += n_tiles;

    // ---- the warps of each m-tile merged in order, then stored: the
    // output (one split) or this split's partial sums
    __syncthreads();
    for (int idx = threadIdx.x; idx < M * (D / 4); idx += kThreads) {
      const int m = idx / (D / 4), d = (idx % (D / 4)) * 4;
      const int mm = m >> 4, rr = m & 15;
      float mstar = kNegInf;
      for (int sh = 0; sh < n_share; ++sh)
        mstar = fmaxf(mstar, sml[((sh * n_mt + mm) * 16 + rr) * 2]);
      float l = 0.f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int sh = 0; sh < n_share; ++sh) {
        const int w = sh * n_mt + mm;
        const float* ml = sml + (w * 16 + rr) * 2;
        const float wt = exp2_ftz(ml[0] - mstar);
        const float4 x = *reinterpret_cast<const float4*>(
            so + (w * 16 + rr) * C::kScratchLD + d);
        l += wt * ml[1];
        acc.x += wt * x.x;
        acc.y += wt * x.y;
        acc.z += wt * x.z;
        acc.w += wt * x.w;
      }
      const long long orow = out_row(p, r0, h, m);
      if (eff == 1) {
        const float den = fmaxf(l, 1e-30f);
        uint2 pk;
        pk.x = pack_bf16x2(acc.x / den, acc.y / den);
        pk.y = pack_bf16x2(acc.z / den, acc.w / den);
        *reinterpret_cast<uint2*>(p.out + orow * D + d) = pk;
      } else {
        *reinterpret_cast<float4*>(p.ws + (split * n_out + orow) * D + d) =
            acc;
        if (d == 0)
          *reinterpret_cast<float2*>(ws_ml + (split * n_out + orow) * 2) =
              make_float2(mstar, l);
      }
    }
    if (eff > 1) {
      // the last split of the unit to finish adds every split's partial
      // sums in split order; the counter it read is reset for the next call
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) {
        int* cnt = p.counters + (long long)r0 * p.kv_heads + h;
        const int arrived = atomicAdd(cnt, 1) + 1;
        if (arrived == eff) *cnt = 0;
        *last = arrived == eff;
      }
      __syncthreads();
      if (*last) {
        __threadfence();
        for (int idx = threadIdx.x; idx < M * (D / 4); idx += kThreads) {
          const int m = idx / (D / 4), d = (idx % (D / 4)) * 4;
          const long long orow = out_row(p, r0, h, m);
          // every split's (m, l) read at once; then the sums, four splits
          // at a time, added in split order
          float2 ml[kMaxSplits];
#pragma unroll
          for (int w = 0; w < kMaxSplits; ++w)
            if (w < eff)
              ml[w] = __ldcg(reinterpret_cast<const float2*>(ws_ml) +
                             (w * n_out + orow));
          float mstar = kNegInf;
#pragma unroll
          for (int w = 0; w < kMaxSplits; ++w)
            if (w < eff) mstar = fmaxf(mstar, ml[w].x);
          float l = 0.f;
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int w0 = 0; w0 < kMaxSplits; w0 += 4) {
            if (w0 >= eff) break;
            float4 x[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (w0 + u < eff)
                x[u] = __ldcg(reinterpret_cast<const float4*>(
                    p.ws + ((w0 + u) * n_out + orow) * D + d));
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int w = w0 + u;
              if (w < eff && ml[w].y > 0.f) {  // a split that saw nothing
                const float wt = exp2_ftz(ml[w].x - mstar);
                l += wt * ml[w].y;
                acc.x += wt * x[u].x;
                acc.y += wt * x[u].y;
                acc.z += wt * x[u].z;
                acc.w += wt * x[u].w;
              }
            }
          }
          const float den = fmaxf(l, 1e-30f);
          uint2 pk;
          pk.x = pack_bf16x2(acc.x / den, acc.y / den);
          pk.y = pack_bf16x2(acc.z / den, acc.w / den);
          *reinterpret_cast<uint2*>(p.out + orow * D + d) = pk;
        }
      }
    }
    __syncthreads();  // the ring is free for the next unit's stages
  }
}

// ---- host ---------------------------------------------------------------------

// the tensor map of one pool plane [num_blocks, kv_heads, block_size, d]:
// boxes of min(d * elt, 128) bytes by min(block_size, 64) rows of one
// (page, kv-head), with the 128-byte swizzle when a box row is 128 bytes
inline int encode_pool(CUtensorMap* map, const void* base, int num_blocks,
                       int kv_heads, int block_size, int d, bool int8) {
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
  const cuuint64_t elt = int8 ? 1 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)block_size,
                              (cuuint64_t)kv_heads, (cuuint64_t)num_blocks};
  const cuuint64_t strides[3] = {
      d * elt, (cuuint64_t)block_size * d * elt,
      (cuuint64_t)kv_heads * block_size * d * elt};
  const cuuint32_t box_bytes = d * elt < 128 ? (cuuint32_t)(d * elt) : 128;
  const cuuint32_t box[4] = {
      (cuuint32_t)(box_bytes / elt),
      (cuuint32_t)(block_size < kTilePos ? block_size : kTilePos), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// encode the maps and launch the unit kernel on a (blocks, kv-heads,
// splits) grid, with the deep ring when p.deep
template <int D, bool QUANT, typename Kernel>
int launch(Kernel kernel, const Params& p, int blocks, const void* kpool,
           const void* vpool, cudaStream_t stream) {
  using C = Cfg<D, QUANT>;
  CUtensorMap tk, tv;
  if (int e = encode_pool(&tk, kpool, p.num_blocks, p.kv_heads,
                          p.block_size, D, QUANT))
    return e;
  if (int e = encode_pool(&tv, vpool, p.num_blocks, p.kv_heads,
                          p.block_size, D, QUANT))
    return e;
  const int bytes = C::smem_bytes(p.deep ? C::kDeepStages : C::kStages);
  if (cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes))
    return static_cast<int>(e);
  kernel<<<dim3(blocks, p.kv_heads, p.splits), kThreads, bytes, stream>>>(
      p, tk, tv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace paged
}  // namespace ptt
