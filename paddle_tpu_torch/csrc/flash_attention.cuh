// Shared by the two flash-attention sources: the masking rules, and the
// launchers of the Hopper kernels (flash_attention_wg.cu: wgmma, TMA) that
// the C entry points (flash_attention.cu) call for bfloat16 at the head_dims
// flash_wg::takes names: the forward at 64 and 128, dq and dk/dv at 64, 72
// and 128.
#pragma once

#include "common.cuh"

namespace ptt {

constexpr float kMasked = -1e30f;  // JAX's finite _NEG_INF

// the key tiles [0, n) a query tile [q0, q0 + rows) can see
__device__ __forceinline__ int key_tiles(int q0, int rows, int sq, int sk,
                                         int bn, bool causal) {
  const int n = (sk + bn - 1) / bn;
  if (!causal) return n;
  const int last = min(q0 + rows, sq) - 1 + (sk - sq);  // its last key
  return last < 0 ? 0 : min(n, last / bn + 1);
}

// query row r sees key c: both in range, causal aligned to the END of the
// keys, equal segment ids (qs, ks) when segmented
__device__ __forceinline__ bool visible(int r, int c, int sq, int sk,
                                        bool causal, bool seg, int qs,
                                        int ks) {
  return r < sq && c < sk && (!causal || r + (sk - sq) >= c) &&
         (!seg || qs == ks);
}

namespace flash_wg {

// Whether kernel 0 (fwd), 1 (dq) or 2 (dk/dv) has a Hopper instantiation
// at head_dim d (bfloat16 only).
bool takes(int kernel, int d);
// Each returns 0, a cudaError_t, or kUnsupported for a head_dim it does
// not take or a work list built for other tiles (bm own rows, bn
// streamed rows). Layouts as the C entry points of flash_attention.cu;
// sched is the work list of n_rows rows of 8 int32 that flash_schedule
// (ops/cuda/flash_attention.py) builds.
int fwd(int d, const void* q, const void* k, const void* v, const int* qseg,
        const int* kseg, void* out, float* lse, const int* sched, int n_rows,
        int bm, int bn, int b, int sq, int sk, int h, int hk, float scale,
        int causal, cudaStream_t st);
int bwd_dq(int d, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* delta,
           const int* qseg, const int* kseg, void* dq, const int* sched,
           int n_rows, int bm, int bn, int b, int sq, int sk, int h, int hk,
           float scale, int causal, cudaStream_t st);
// dk/dv: ws null for a list without pieces; otherwise float32
// [2, n_slots, b, sk, hk, d] (dk's slots, then dv's) that the pieces write
// and a second pass sums into dk, dv in slot order, key tile t taking
// pieces[t] slots (int32 on the device, one per tile of bm key rows).
int bwd_dkv(int d, const void* q, const void* k, const void* v,
            const void* dout, const float* lse, const float* delta,
            const int* qseg, const int* kseg, float* dk, float* dv,
            float* ws, const int* pieces, int n_slots, const int* sched,
            int n_rows, int bm, int bn, int b, int sq, int sk, int h, int hk,
            float scale, int causal, cudaStream_t st);
// dynamic shared memory in bytes of kernel 0 (fwd), 1 (dq), 2 (dk/dv)
int smem_bytes(int kernel, int d);
// registers a thread of kernel 0 (fwd), 1 (dq), 2 (dk/dv) at head_dim d
// as built (cudaFuncGetAttributes), or kUnsupported
int regs(int kernel, int d);

}  // namespace flash_wg
}  // namespace ptt
