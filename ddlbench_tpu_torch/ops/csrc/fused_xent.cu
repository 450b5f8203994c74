// Fused LM-head loss (projection + softmax cross-entropy) for Hopper
// (sm_90a): the forward row statistics, dh and dW, never writing the
// [N, V] logits to device memory.
//
// Three kernels, each replacing a Pallas TPU kernel of the JAX package
// (ddlbench_tpu/ops/fused_xent.py), each in two builds, one per input type:
//
//   forward <- _fx_fwd_kernel (:381), launched by _fxent_fwd_pallas (:427,
//              call :443): z = h @ W swept over vocab tiles, per row the
//              online logsumexp (lse), the gold logit, zsum = sum_v z and
//              the argmax (the smallest index among equal maxima).
//   dh      <- _fx_dh_kernel (:490, dz from _fx_dz :479), launched by
//              _fxent_bwd_pallas (:537, call :565): dh = dz @ W^T,
//              recomputing z tile by tile from the saved lse.
//   dW      <- _fx_dw_kernel (:513), launched by _fxent_bwd_pallas (call
//              :581): dW = h^T @ dz over the rows.
//
// Semantics (the TPU kernels', not their block layout): every product
// accumulates in float32; the running max starts at -1e30 and the row sum
// is clamped at 1e-20 before the log; vocab columns >= V take part in none
// of lse, gold, zsum or the argmax; rows >= N are neither read nor written.
// dz = c_p * exp(z - lse) - c_oh * [col == label] - c_sm on a row whose
// label is >= 0 and 0 on a masked row (label < 0): the mask SELECTS before
// anything multiplies. In the bfloat16 build dz is rounded to bfloat16
// before both products, as the reference rounds it to h's dtype (:487).
// dh and dW accumulate in float32 and are written once, in the input type
// (dW over all N rows, as the reference casts its float32 dW to w's dtype).
//
// Blocks run in no order, so each carried sum of a Pallas grid is a loop
// inside one block: the forward and dh sweep the vocabulary inside a row
// tile; dW sweeps the rows inside a 64-column vocab tile. No atomics: dW is
// deterministic, and reruns are bitwise equal.
//
// Bound: at lmbench's shape (N 16 384, D 512, V 32 768, bf16) the forward
// does 2 N D V = 5.5e11 flops (0.556 ms at 989 TFLOP/s), dh and dW 4 N D V
// each (the recomputed z and the product: 1.11 ms); the bytes (h 16.8 MB,
// W 33.5 MB) take about 0.015 ms. All three are bound by the tensor cores.
//
// bfloat16 build (the training path; V a multiple of 8, so W's rows are
// 16-byte aligned). D is cut into 64-wide chunks.
//   All three (fx_fwd_wgmma<NK>, fx_dh_wgmma<NK>, fx_dw_wgmma<NK>) are
//   Hopper's wgmma with TMA loads through mbarrier rings (hopper.cuh),
//   one persistent block per SM walking the work items, built for the D
//   chunk counts NK = 2, 4, ..., 12.
//   forward: 64 rows of h resident (one item); W's vocab tiles stream as
//     [64 d][64 v] chunks, the even tiles through warpgroup 0's ring and
//     the odd ones through warpgroup 1's, each fed by its own producer
//     warp. Each warpgroup computes its tiles' 64 x 64 scores once (1.0x
//     the flops; h K-major, the W chunk MN-major) and folds them into its
//     threads' statistics (running max and exp2 sum, gold, zsum, argmax
//     over the columns a thread holds) while the other warpgroup's
//     products run. At the item's end the statistics are reduced over each
//     row's four lanes and the two warpgroups' merged through shared
//     memory in a fixed order: reruns are bitwise equal.
//   dh and dW: a block is two consumer warpgroups and a producer
//     warpgroup that keeps one lane issuing TMA and gives its registers to
//     the consumers (setmaxnreg).
//     dh takes 64 rows of h resident and streams W's vocab tiles as
//     [64 d][64 v] chunks; each warpgroup computes the whole 64 x 64 score
//     tile (wgmma from shared memory), turns it into dz in registers, and
//     multiplies dz as the register A operand into its half of D (4 x 32
//     float32 accumulator registers at D 512): dz never touches shared
//     memory. dW is the same turned over: 64 vocab columns of W resident,
//     h's row tiles streamed, the transposed scores z^T = W^T h^T (W read
//     MN-major) so that dz^T is the A operand of dW^T += dz^T h. Both
//     warpgroups recompute the scores (1.5x the flops): splitting the
//     reduction between them and adding the halves through shared memory
//     was measured slower, and so was issuing the next tile's scores
//     behind a warpgroup's products (PERF.md). Past D 512 a warpgroup's
//     share of the accumulator (160 or 192 registers) leaves no room for a
//     64 x 64 score tile, so it takes each tile in two 64 x 32 halves,
//     scores then products. Each wgmma sequence is straight-line code (the
//     chunk counts and the ring depth are compile-time), which ptxas needs
//     to keep the products in flight back to back.
//
// float32 build (the tests' comparisons and --dtype float32; any V): the
// same sweeps with float32 FMAs on the CUDA cores (no TF32: the float32
// checks hold 1e-5), 4 warps a block with the same fragment ownership,
// float32 tiles of stride 68 staged by the threads (transposed where a
// product needs it), the dh and dW accumulators ([64, D] float32) in
// dynamic shared memory, each thread adding its own elements after every D
// chunk.
//
// Inputs are contiguous: h [N, D], W [D, V] (one type), labels int32 [N],
// lse float32 [N], coef float32 [3] = (c_p, c_oh, c_sm) on the device.
// D a multiple of 16, at most kMaxD. Plain C interface, bound with ctypes:
// each launcher returns cudaGetLastError() and launches on the stream it is
// given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kTile = 64;         // rows and columns of a score tile, D chunk
constexpr int kMaxD = 768;        // the widest head the shared memory holds
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

using bf16 = __nv_bfloat16;

// Fragment element i of column group nt sits at tile row m0 + g + 8 (i >> 1)
// and tile column n0 + 8 nt + 2 t + (i & 1) (the m16n8 accumulator layout),
// g = lane / 4, t = lane % 4.

// Reductions over the 4 lanes that own a fragment row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  return x + __shfl_xor_sync(kFullMask, x, 2);
}

// dz of one score: 0 on a masked row or a column past V.
__device__ __forceinline__ float dz_of(float z, int label, float lse_row,
                                       int col, bool live, float c_p,
                                       float c_oh, float c_sm) {
  if (label < 0 || !live) return 0.f;
  return c_p * expf(z - lse_row) - (col == label ? c_oh : 0.f) - c_sm;
}

// The forward's running statistics of this thread's two rows (hh: rows g
// and g + 8 of the warp's 16).
struct RowStats {
  int lab[2];
  float m[2], l[2], gold[2], zsum[2], best[2];
  int arg[2];
};

__device__ __forceinline__ void stats_init(RowStats& st, const int* labels,
                                           long r0, int row, int nr) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    st.lab[hh] = r < nr ? labels[r0 + r] : -1;
    st.m[hh] = st.best[hh] = kNegInf;
    st.l[hh] = st.gold[hh] = st.zsum[hh] = 0.f;
    st.arg[hh] = 0;
  }
}

// Fold the 16 x 64 score tile s (the vocab tile at c0, nc columns live)
// into the statistics: online logsumexp, gold logit, zsum, argmax.
__device__ __forceinline__ void stats_fold(RowStats& st,
                                           const float (&s)[8][4], int c0,
                                           int nc, int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    // this lane's columns in increasing order; strict > keeps the first
    float bm = kNegInf;
    int bi = 0;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * nt + 2 * t + e;
        const float z = s[nt][2 * hh + e];
        if (col < nc) {
          st.zsum[hh] += z;
          if (c0 + col == st.lab[hh]) st.gold[hh] += z;
          if (z > bm) {
            bm = z;
            bi = c0 + col;
          }
        }
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the quad: ties take the
      const float ov = __shfl_xor_sync(kFullMask, bm, off);  // smaller
      const int oi = __shfl_xor_sync(kFullMask, bi, off);    // index
      if (ov > bm || (ov == bm && oi < bi)) {
        bm = ov;
        bi = oi;
      }
    }
    if (bm > st.best[hh]) {  // strict: an earlier tile keeps a tie
      st.best[hh] = bm;
      st.arg[hh] = bi;
    }
    const float m_new = fmaxf(st.m[hh], bm);
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * nt + 2 * t + e < nc) sum += expf(s[nt][2 * hh + e] - m_new);
    st.l[hh] = st.l[hh] * expf(st.m[hh] - m_new) + quad_sum(sum);
    st.m[hh] = m_new;
  }
}

__device__ __forceinline__ void stats_write(const RowStats& st, long r0,
                                            int row, int nr, int t,
                                            float* lse, float* gold,
                                            float* zsum, int* amax) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float g_row = quad_sum(st.gold[hh]), z_row = quad_sum(st.zsum[hh]);
    const int r = row + 8 * hh;
    if (t == 0 && r < nr) {
      lse[r0 + r] = st.m[hh] + logf(fmaxf(st.l[hh], 1e-20f));
      gold[r0 + r] = g_row;
      zsum[r0 + r] = z_row;
      amax[r0 + r] = st.arg[hh];
    }
  }
}

// ===========================================================================
// float32: CUDA cores
// ===========================================================================

constexpr int kThreadsF = 128;  // 4 warps, 16 tile rows each
constexpr int kLdf = kTile + 4;  // float32 stride of a staged 64-row tile
constexpr int kTileF = kTile * kLdf;

// Stage rows [0, n_rows) and columns [0, n_cols) of the 64 x 64 block at
// src (row r at src + r * ld) into dst (stride kLdf), or its transpose
// (dst[col][r]); the rest becomes zeros. 16-byte chunks where the chunk is
// whole and ld allows (vec), else element by element.
template <bool Transpose>
__device__ __forceinline__ void stage_f(const float* __restrict__ src,
                                        long ld, int n_rows, int n_cols,
                                        bool vec, float* __restrict__ dst) {
  for (int c = threadIdx.x; c < kTile * (kTile / 4); c += kThreadsF) {
    // transposed: lanes walk rows, so each store column is contiguous
    const int r = Transpose ? c % kTile : c / (kTile / 4);
    const int col = Transpose ? (c / kTile) * 4 : (c % (kTile / 4)) * 4;
    float e[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < n_rows) {
      const float* s = src + r * ld + col;
      if (vec && col + 4 <= n_cols) {
        const float4 v = *reinterpret_cast<const float4*>(s);
        e[0] = v.x;
        e[1] = v.y;
        e[2] = v.z;
        e[3] = v.w;
      } else {
        for (int i = 0; i < 4 && col + i < n_cols; ++i) e[i] = s[i];
      }
    }
    if (Transpose) {
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[(col + i) * kLdf + r] = e[i];
    } else {
      *reinterpret_cast<float4*>(dst + r * kLdf + col) =
          make_float4(e[0], e[1], e[2], e[3]);
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

// s[nt] += a * b^T over the 64-wide chunk: this thread's fragment elements
// of rows row0, row0 + 8 of tile a against rows 8 nt + 2 t + e of tile b
// (both [row][k], stride kLdf).
__device__ __forceinline__ void scores_acc(const float* a, const float* b,
                                           int row0, int t,
                                           float (&s)[8][4]) {
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + row0 * kLdf + k);
    const float4 a1 =
        *reinterpret_cast<const float4*>(a + (row0 + 8) * kLdf + k);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 bv = *reinterpret_cast<const float4*>(
            b + (8 * nt + 2 * t + e) * kLdf + k);
        s[nt][e] += dot4(a0, bv);
        s[nt][2 + e] += dot4(a1, bv);
      }
  }
}

// acc += p * wt^T (wt staged [n][k]): p goes through this warp's rows of
// the scratch tile (no other warp touches them while the block is in this
// phase), then as scores_acc.
__device__ __forceinline__ void accumulate(const float (&p)[8][4],
                                           float* scratch, const float* wt,
                                           int row0, int t,
                                           float (&acc)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      scratch[(row0 + 8 * (i >> 1)) * kLdf + 8 * nt + 2 * t + (i & 1)] =
          p[nt][i];
  __syncwarp();
  scores_acc(scratch, wt, row0, t, acc);
  __syncwarp();
}

// z = h[r0 : r0 + 64] @ W[:, c0 : c0 + 64] into s (zeroed here): D chunks
// of h staged [row][k] in ha and of W staged transposed [col][k] in wb.
__device__ __forceinline__ void row_scores(const float* h, const float* w,
                                           long r0, int nr, int c0, int nc,
                                           int D, int V, float* ha,
                                           float* wb, int row0, int t,
                                           float (&s)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
  for (int k0 = 0; k0 < D; k0 += kTile) {
    const int nk = min(kTile, D - k0);
    __syncthreads();  // every warp is done with the previous chunks
    stage_f<false>(h + r0 * D + k0, D, nr, nk, D % 4 == 0, ha);
    stage_f<true>(w + static_cast<long>(k0) * V + c0, V, nk, nc, V % 4 == 0,
                  wb);
    __syncthreads();
    scores_acc(ha, wb, row0, t, s);
  }
}

// acc[row][k0 + n] += part[row][n] for n < nk: each thread adds its own
// fragment elements (acc rows of stride acc_ld).
__device__ __forceinline__ void add_part(const float (&part)[8][4],
                                         float* acc, int acc_ld, int row0,
                                         int t, int k0, int nk) {
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 8 * dt + 2 * t + (i & 1);
      if (n < nk) acc[(row0 + 8 * (i >> 1)) * acc_ld + k0 + n] += part[dt][i];
    }
}

__global__ void __launch_bounds__(kThreadsF)
    fx_fwd_f32(const float* __restrict__ h, const float* __restrict__ w,
               const int* __restrict__ labels, float* __restrict__ lse,
               float* __restrict__ gold, float* __restrict__ zsum,
               int* __restrict__ amax, int N, int D, int V) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);
  float* wt = hs + kTileF;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = 16 * (threadIdx.x >> 5) + g;
  const long r0 = static_cast<long>(blockIdx.x) * kTile;
  const int nr = static_cast<int>(min(static_cast<long>(kTile), N - r0));
  RowStats st;
  stats_init(st, labels, r0, row0, nr);
  for (int c0 = 0; c0 < V; c0 += kTile) {
    const int nc = min(kTile, V - c0);
    float s[8][4];
    row_scores(h, w, r0, nr, c0, nc, D, V, hs, wt, row0, t, s);
    stats_fold(st, s, c0, nc, t);
  }
  stats_write(st, r0, row0, nr, t, lse, gold, zsum, amax);
}

__global__ void __launch_bounds__(kThreadsF)
    fx_dh_f32(const float* __restrict__ h, const float* __restrict__ w,
              const int* __restrict__ labels, const float* __restrict__ lse,
              const float* __restrict__ coef, float* __restrict__ dh, int N,
              int D, int V, int acc_ld) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);  // [64 rows][acc_ld]
  float* buf0 = acc + kTile * acc_ld;
  float* buf1 = buf0 + kTileF;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = 16 * (threadIdx.x >> 5) + g;
  const long r0 = static_cast<long>(blockIdx.x) * kTile;
  const int nr = static_cast<int>(min(static_cast<long>(kTile), N - r0));
  const float c_p = coef[0], c_oh = coef[1], c_sm = coef[2];
  for (int i = threadIdx.x; i < kTile * acc_ld; i += kThreadsF) acc[i] = 0.f;
  int lab[2];
  float lse_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    lab[hh] = r < nr ? labels[r0 + r] : -1;
    lse_r[hh] = r < nr ? lse[r0 + r] : 0.f;
  }
  for (int c0 = 0; c0 < V; c0 += kTile) {
    const int nc = min(kTile, V - c0);
    float s[8][4];
    row_scores(h, w, r0, nr, c0, nc, D, V, buf0, buf1, row0, t, s);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 8 * nt + 2 * t + (i & 1), hh = i >> 1;
        s[nt][i] = dz_of(s[nt][i], lab[hh], lse_r[hh], c0 + col, col < nc,
                         c_p, c_oh, c_sm);
      }
    // dh[:, k0 : k0 + 64] += dz @ W[k0 : k0 + 64, c0 : c0 + 64]^T
    for (int k0 = 0; k0 < D; k0 += kTile) {
      const int nk = min(kTile, D - k0);
      __syncthreads();
      stage_f<false>(w + static_cast<long>(k0) * V + c0, V, nk, nc,
                     V % 4 == 0, buf1);
      __syncthreads();
      float part[8][4] = {};
      accumulate(s, buf0, buf1, row0, t, part);
      add_part(part, acc, acc_ld, row0, t, k0, nk);
    }
  }
  __syncthreads();
  for (long i = threadIdx.x; i < static_cast<long>(nr) * D; i += kThreadsF) {
    const long r = i / D, d = i % D;
    dh[(r0 + r) * D + d] = acc[r * acc_ld + d];
  }
}

__global__ void __launch_bounds__(kThreadsF)
    fx_dw_f32(const float* __restrict__ h, const float* __restrict__ w,
              const int* __restrict__ labels, const float* __restrict__ lse,
              const float* __restrict__ coef, float* __restrict__ dw, int N,
              int D, int V, int acc_ld) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);  // [64 cols][acc_ld]
  float* buf0 = acc + kTile * acc_ld;
  float* buf1 = buf0 + kTileF;
  int* lab_s = reinterpret_cast<int*>(buf1 + kTileF);
  float* lse_s = reinterpret_cast<float*>(lab_s + kTile);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col0 = 16 * (threadIdx.x >> 5) + g;  // this warp's vocab columns
  const int c0 = blockIdx.x * kTile;
  const int nc = min(kTile, V - c0);
  const float c_p = coef[0], c_oh = coef[1], c_sm = coef[2];
  for (int i = threadIdx.x; i < kTile * acc_ld; i += kThreadsF) acc[i] = 0.f;
  for (long r0 = 0; r0 < N; r0 += kTile) {
    const int nr = static_cast<int>(min(static_cast<long>(kTile), N - r0));
    __syncthreads();  // every warp is done with the previous row tile
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x;
      lab_s[r] = r < nr ? labels[r0 + r] : -1;
      lse_s[r] = r < nr ? lse[r0 + r] : 0.f;
    }
    // z^T: vocab columns as rows (W^T chunks in buf0), rows as columns (h
    // chunks in buf1)
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    for (int k0 = 0; k0 < D; k0 += kTile) {
      const int nk = min(kTile, D - k0);
      __syncthreads();
      stage_f<true>(w + static_cast<long>(k0) * V + c0, V, nk, nc,
                    V % 4 == 0, buf0);
      stage_f<false>(h + r0 * D + k0, D, nr, nk, D % 4 == 0, buf1);
      __syncthreads();
      scores_acc(buf0, buf1, col0, t, s);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = col0 + 8 * (i >> 1), r = 8 * nt + 2 * t + (i & 1);
        s[nt][i] = dz_of(s[nt][i], lab_s[r], lse_s[r], c0 + c, c < nc, c_p,
                         c_oh, c_sm);
      }
    // dW^T[:, k0 : k0 + 64] += dz^T @ h[r0 : r0 + 64, k0 : k0 + 64]
    for (int k0 = 0; k0 < D; k0 += kTile) {
      const int nk = min(kTile, D - k0);
      __syncthreads();
      stage_f<true>(h + r0 * D + k0, D, nr, nk, D % 4 == 0, buf1);
      __syncthreads();
      float part[8][4] = {};
      accumulate(s, buf0, buf1, col0, t, part);
      add_part(part, acc, acc_ld, col0, t, k0, nk);
    }
  }
  __syncthreads();
  for (long i = threadIdx.x; i < static_cast<long>(D) * nc; i += kThreadsF) {
    const long d = i / nc, c = i % nc;  // lanes walk the vocab: coalesced
    dw[d * V + c0 + c] = acc[c * acc_ld + d];
  }
}

// ===========================================================================
// bfloat16: wgmma, TMA and mbarrier rings
// ===========================================================================

// Two floats as a bf16 pair, the first in the low half (the fragment order).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  unsigned u;
  memcpy(&u, &v, 4);
  return u;
}

using hopper::desc_sw128;
using hopper::fence_regs;
using hopper::kKMajorStep;
using hopper::kMnMajorStep;

constexpr int kConsumers = 256;  // two warpgroups
constexpr int kThreadsWs = kConsumers + 128;  // and a producer warpgroup
// registers a thread after setmaxnreg: the producer gives up what the
// consumers' accumulators need (24 x 128 + 240 x 256 <= 65 536)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kChunkBytes = kTile * kTile * 2;  // a [64][64] bf16 chunk
constexpr int kMaxStages = 16;  // the ring: streamed chunks in flight
constexpr float kLog2e = 1.4426950408889634f;

// The D chunk counts the kernels are built for (D rounded up; the chunks
// past D are zeros from TMA's out-of-bounds fill), and how each splits.
// Each warpgroup owns kNC = NK / 2 chunks of the output (32 kNC float32
// accumulator registers). Up to D 512 (at most 128 of them) it takes a
// tile's scores whole (64 x 64: 32 registers); past D 512 (160 or 192) in
// two halves of 32 streamed columns (dh) or rows (dW), each half's scores
// (16 registers) multiplied before the next half's are computed, so no
// score is computed twice by a warpgroup at any D.
template <int NK>
struct BwdTiling {
  static constexpr int kNC = NK / 2;
  static constexpr int kSubW = NK <= 8 ? kTile : kTile / 2;  // score width
  static constexpr int kSubs = kTile / kSubW;
  static_assert(2 * kNC == NK, "D chunks split evenly");
};

// 2^x on the special-function unit, results below 2^-126 flushed to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// bf16 pairs of an m64 accumulator's columns 16 kk .. 16 kk + 15: the A
// fragment of k step kk (hopper.cuh).
template <int KS>
__device__ __forceinline__ void pack_a(const float* d, uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// Shared memory of both backward kernels: NK resident chunks (h's rows for
// dh, W's vocab columns for dW), a ring of `stages` streamed chunks (W for
// dh, h for dW), the barriers of the resident buffer and of the ring; 1 KB
// of alignment slack.
struct BwdSmem {
  uint8_t* res;
  uint8_t* ring;
  uint64_t* res_full;
  uint64_t* res_empty;
  uint64_t* full;
  uint64_t* empty;
};

__host__ __device__ constexpr int bwd_smem_bytes(int nk, int stages) {
  return (nk + stages) * kChunkBytes + (2 + 2 * stages) * 8 + 1024;
}

__device__ __forceinline__ BwdSmem bwd_smem(uint8_t* raw, int nk,
                                            int stages) {
  BwdSmem m;
  m.res = hopper::align1024(raw);
  m.ring = m.res + nk * kChunkBytes;
  m.res_full = reinterpret_cast<uint64_t*>(m.ring + stages * kChunkBytes);
  m.res_empty = m.res_full + 1;
  m.full = m.res_empty + 1;
  m.empty = m.full + stages;
  return m;
}

// Thread 0 initialises the barriers; then the warpgroups trade registers.
// True for the producer warpgroup.
__device__ __forceinline__ bool bwd_init(const BwdSmem& m, int stages) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(m.res_full, 1);
    hopper::mbar_init(m.res_empty, kConsumers);
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&m.full[s], 1);
      hopper::mbar_init(&m.empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    return true;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  return false;
}

// The ring stage of streamed chunk number `step`.
__device__ __forceinline__ int stage_of(int step, int stages) {
  return step % stages;
}

// Wait for streamed chunks step .. step + NK - 1 (one vocab or row tile).
template <int NK>
__device__ __forceinline__ void wait_tile(const BwdSmem& sm, int step,
                                          int stages) {
#pragma unroll
  for (int kc = 0; kc < NK; ++kc)
    hopper::mbar_wait(&sm.full[stage_of(step + kc, stages)],
                      ((step + kc) / stages) & 1);
}

// The 64 x (R / 2) scores of the streamed chunks step.. into s: A
// (resident chunk kc) times B (streamed chunk kc), each MN-major where TA /
// TB is 1, summed over the NK chunks. At R 16 (N 32) B is the half `sub`
// of each streamed chunk (hopper.cuh: its columns, MN-major; its rows,
// K-major).
template <int NK, int TA, int TB, int R>
__device__ __forceinline__ void score_tile(const BwdSmem& sm, int step,
                                           int stages, int sub,
                                           float (&s)[R]) {
  const int b_off = R == 32 ? 0 : TB ? sub * kTile : sub * kChunkBytes / 2;
#pragma unroll
  for (int j = 0; j < R; ++j) s[j] = 0.f;
  fence_regs(s);
  hopper::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < NK; ++kc) {
    const uint64_t a_desc = desc_sw128(sm.res + kc * kChunkBytes);
    const uint64_t b_desc = desc_sw128(
        sm.ring + stage_of(step + kc, stages) * kChunkBytes + b_off);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_ss<TA, TB>(
          s, a_desc + kk * (TA ? kMnMajorStep : kKMajorStep),
          b_desc + kk * (TB ? kMnMajorStep : kKMajorStep), 1);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  fence_regs(s);
}

// dz of one accumulator element: 0 on a masked row (label < 0) or past the
// vocabulary, else c_p exp(z - lse) - c_oh [col == label] - c_sm, with
// lse2 = lse * log2 e.
__device__ __forceinline__ float dz_of2(float z, int label, float lse2,
                                        int col, int V, float c_p, float c_oh,
                                        float c_sm) {
  if (label < 0 || col >= V) return 0.f;
  return c_p * exp2_ftz(fmaf(z, kLog2e, -lse2)) -
         (col == label ? c_oh : 0.f) - c_sm;
}

// acc[i] += dz * the streamed chunk c_lo + i, i < NC (B MN-major where TB
// is 1), over the chunk's 64 or (R 16) its 32 rows of the reduction axis
// starting at 32 sub; then, after the last half, the chunks are released.
template <int NC, int TB, int R>
__device__ __forceinline__ void add_products(const BwdSmem& sm, int step,
                                             int stages, int c_lo, int sub,
                                             const float (&dz)[R],
                                             float (&acc)[NC][32]) {
  constexpr int KS = R / 8;  // k16 steps
  uint32_t a[KS][4];  // dz as bf16 A fragments
  pack_a<KS>(dz, a);
#pragma unroll
  for (int i = 0; i < NC; ++i) fence_regs(acc[i]);
  fence_regs(a);
  hopper::wgmma_fence();
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const uint64_t b_desc = desc_sw128(
        sm.ring + stage_of(step + c_lo + i, stages) * kChunkBytes);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      hopper::wgmma_m64n64k16_rs<TB>(
          acc[i], a[kk],
          b_desc + (KS * sub + kk) * (TB ? kMnMajorStep : kKMajorStep));
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < NC; ++i) fence_regs(acc[i]);
  fence_regs(a);
  if (KS * (sub + 1) == 4)
    for (int i = 0; i < NC; ++i)
      hopper::mbar_arrive(&sm.empty[stage_of(step + c_lo + i, stages)]);
}

// Release the tile's chunks this warpgroup does not multiply (its own,
// [c_lo, c_lo + NC), go after its product).
template <int NK, int NC>
__device__ __forceinline__ void release_others(const BwdSmem& sm, int step,
                                               int stages, int c_lo) {
  for (int kc = 0; kc < NK; ++kc)
    if (kc < c_lo || kc >= c_lo + NC)
      hopper::mbar_arrive(&sm.empty[stage_of(step + kc, stages)]);
}

// dh: persistent blocks walk the 64-row tiles, tile w going to block
// w % gridDim.x. The producer loads the tile's h rows (NK chunks,
// resident) and streams W's vocab tiles as NK chunks [64 d][64 v] each
// through the ring. The warpgroups compute the score tile z = h W[:, tile]
// (64 x 64, or two 64 x 32 halves past D 512; wgmma with h K-major and the
// W chunk MN-major), turn it into dz in registers, and add dz W[:, tile]^T
// to their own kNC chunks of dh (wgmma with dz as the register A operand
// and the W chunk K-major).
// Every wgmma sequence is straight-line code (NK and kNC compile-time, the
// tile's barriers waited first), so ptxas keeps the products back to back.
template <int NK>
__global__ void __launch_bounds__(kThreadsWs, 1)
    fx_dh_wgmma(const __grid_constant__ CUtensorMap tm_h,
                const __grid_constant__ CUtensorMap tm_w,
                const int* __restrict__ labels, const float* __restrict__ lse,
                const float* __restrict__ coef, bf16* __restrict__ dh, int N,
                int D, int V) {
  constexpr int NC = BwdTiling<NK>::kNC, SW = BwdTiling<NK>::kSubW;
  constexpr int SUBS = BwdTiling<NK>::kSubs;
  extern __shared__ uint8_t smem_raw[];
  const int nv = (V + kTile - 1) / kTile;
  const int items = (N + kTile - 1) / kTile;
  constexpr int stages = kMaxStages;
  const BwdSmem sm = bwd_smem(smem_raw, NK, stages);

  if (bwd_init(sm, stages)) {  // the producer: one lane issues TMA
    if (threadIdx.x == kConsumers) {
      int step = 0;  // W chunks loaded so far, over every item
      for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
        const int r0 = w * kTile;
        hopper::mbar_wait(sm.res_empty, (n & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(sm.res_full, NK * kChunkBytes);
        for (int kc = 0; kc < NK; ++kc)
          hopper::tma_load_2d(sm.res + kc * kChunkBytes, &tm_h, sm.res_full,
                              kc * kTile, r0);
        for (int vt = 0; vt < nv; ++vt)
          for (int kc = 0; kc < NK; ++kc, ++step) {
            const int s = stage_of(step, stages);
            hopper::mbar_wait(&sm.empty[s], ((step / stages) & 1) ^ 1);
            hopper::mbar_arrive_expect_tx(&sm.full[s], kChunkBytes);
            hopper::tma_load_2d(sm.ring + s * kChunkBytes, &tm_w,
                                &sm.full[s], vt * kTile, kc * kTile);
          }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = 16 * warp + g;  // this thread's rows: row, row + 8
  const float c_p = coef[0], c_oh = coef[1], c_sm = coef[2];
  int step = 0;
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
    const long r0 = static_cast<long>(w) * kTile;
    const int c_lo = wg * NC;  // own chunks: c_lo + i
    int lab[2];
    float lse2[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long r = r0 + row + 8 * hh;
      lab[hh] = r < N ? labels[r] : -1;
      lse2[hh] = r < N ? lse[r] * kLog2e : 0.f;
    }
    float acc[NC][32];
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[i][j] = 0.f;
    hopper::mbar_wait(sm.res_full, n & 1);
    for (int vt = 0; vt < nv; ++vt, step += NK) {
      wait_tile<NK>(sm, step, stages);
#pragma unroll
      for (int sub = 0; sub < SUBS; ++sub) {
        float z[SW / 2];
        score_tile<NK, 0, 1>(sm, step, stages, sub, z);  // z = h W[:, cols]
        if (sub == SUBS - 1) {
          if (vt == nv - 1) hopper::mbar_arrive(sm.res_empty);  // h read
          release_others<NK, NC>(sm, step, stages, c_lo);
        }
        const int c0 = vt * kTile + sub * SW;
#pragma unroll
        for (int i = 0; i < SW / 2; ++i) {
          const int hh = (i >> 1) & 1;
          z[i] = dz_of2(z[i], lab[hh], lse2[hh],
                        c0 + 8 * (i >> 2) + 2 * t + (i & 1), V, c_p, c_oh,
                        c_sm);
        }
        // dh[:, chunk] += dz W[chunk, cols]^T
        add_products<NC, 0>(sm, step, stages, c_lo, sub, z, acc);
      }
    }
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long r = r0 + row + 8 * hh;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = (c_lo + i) * kTile + 8 * j + 2 * t;
          if (r < N && d < D)
            *reinterpret_cast<unsigned*>(dh + r * D + d) =
                pack_bf16(acc[i][4 * j + 2 * hh], acc[i][4 * j + 2 * hh + 1]);
        }
      }
  }
}

// dW: the same turned over. Work items are 64-column vocab tiles; the
// item's W columns are resident (NK chunks [64 d][64 v]) and the rows of h
// stream through the ring as NK chunks [64 rows][64 d] per row tile (taken
// in two halves of 32 rows past D 512).
// The warpgroups compute the transposed scores z^T = W[:, tile]^T
// h_tile^T (64 vocab columns x 64 rows; wgmma with the W chunk MN-major as
// A and the h chunk K-major as B), so dz^T is in the accumulator layout and
// feeds dW^T[:, chunk] += dz^T h[tile, chunk] as the register A operand
// against the h chunk MN-major. lse and labels are per accumulator column:
// each thread loads its 16 (8 a half) rows' before the score product. Each
// warpgroup keeps its kNC chunks of dW^T in registers over all rows: no
// atomics, so reruns are bitwise equal.
template <int NK>
__global__ void __launch_bounds__(kThreadsWs, 1)
    fx_dw_wgmma(const __grid_constant__ CUtensorMap tm_h,
                const __grid_constant__ CUtensorMap tm_w,
                const int* __restrict__ labels, const float* __restrict__ lse,
                const float* __restrict__ coef, bf16* __restrict__ dw, int N,
                int D, int V) {
  constexpr int NC = BwdTiling<NK>::kNC, SW = BwdTiling<NK>::kSubW;
  constexpr int SUBS = BwdTiling<NK>::kSubs;
  extern __shared__ uint8_t smem_raw[];
  const int nrt = (N + kTile - 1) / kTile;
  const int items = (V + kTile - 1) / kTile;
  constexpr int stages = kMaxStages;
  const BwdSmem sm = bwd_smem(smem_raw, NK, stages);

  if (bwd_init(sm, stages)) {  // the producer: one lane issues TMA
    if (threadIdx.x == kConsumers) {
      int step = 0;  // h chunks loaded so far, over every item
      for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
        const int c0 = w * kTile;
        hopper::mbar_wait(sm.res_empty, (n & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(sm.res_full, NK * kChunkBytes);
        for (int kc = 0; kc < NK; ++kc)
          hopper::tma_load_2d(sm.res + kc * kChunkBytes, &tm_w, sm.res_full,
                              c0, kc * kTile);
        for (int rt = 0; rt < nrt; ++rt)
          for (int kc = 0; kc < NK; ++kc, ++step) {
            const int s = stage_of(step, stages);
            hopper::mbar_wait(&sm.empty[s], ((step / stages) & 1) ^ 1);
            hopper::mbar_arrive_expect_tx(&sm.full[s], kChunkBytes);
            hopper::tma_load_2d(sm.ring + s * kChunkBytes, &tm_h,
                                &sm.full[s], kc * kTile, rt * kTile);
          }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col = 16 * warp + g;  // this thread's vocab columns: col, +8
  const float c_p = coef[0], c_oh = coef[1], c_sm = coef[2];
  int step = 0;
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
    const int c0 = w * kTile;
    const int c_lo = wg * NC;  // own chunks: c_lo + i
    float acc[NC][32];
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[i][j] = 0.f;
    hopper::mbar_wait(sm.res_full, n & 1);
    for (int rt = 0; rt < nrt; ++rt, step += NK) {
      wait_tile<NK>(sm, step, stages);
#pragma unroll
      for (int sub = 0; sub < SUBS; ++sub) {
        float lse2[SW / 4];  // accumulator column 8 (j / 2) + 2 t + j % 2's
        int lab[SW / 4];
#pragma unroll
        for (int j = 0; j < SW / 4; ++j) {
          const int r =
              rt * kTile + sub * SW + 8 * (j >> 1) + 2 * t + (j & 1);
          lab[j] = r < N ? labels[r] : -1;
          lse2[j] = r < N ? lse[r] * kLog2e : 0.f;
        }
        float zt[SW / 2];  // z^T = W[:, tile]^T h[rows]^T
        score_tile<NK, 1, 0>(sm, step, stages, sub, zt);
#pragma unroll
        for (int i = 0; i < SW / 2; ++i) {
          const int j = 2 * (i >> 2) + (i & 1);
          zt[i] = dz_of2(zt[i], lab[j], lse2[j],
                         c0 + col + 8 * ((i >> 1) & 1), V, c_p, c_oh, c_sm);
        }
        if (sub == SUBS - 1) {
          if (rt == nrt - 1) hopper::mbar_arrive(sm.res_empty);  // W read
          release_others<NK, NC>(sm, step, stages, c_lo);
        }
        // dW^T[:, chunk] += dz^T h[rows, chunk]
        add_products<NC, 1>(sm, step, stages, c_lo, sub, zt, acc);
      }
    }
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int v = c0 + col + 8 * hh;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = (c_lo + i) * kTile + 8 * j + 2 * t + e;
            if (v < V && d < D)
              dw[static_cast<long>(d) * V + v] =
                  __float2bfloat16_rn(acc[i][4 * j + 2 * hh + e]);
          }
      }
  }
}

// ---------------------------------------------------------------------------
// The forward
// ---------------------------------------------------------------------------

constexpr int kFwdThreads = kConsumers + 64;  // and two producer warps
constexpr int kFwdMaxStages = 8;  // chunks in flight in each ring
constexpr int kMergeFloats = 5 * kTile;  // a warpgroup's row statistics
// shared memory beside the resident chunks and the rings: the alignment
// slack, two items' merge rows, the barriers
constexpr int kFwdFixed = 1024 + 2 * kMergeFloats * 4 +
                          (2 + 4 * kFwdMaxStages) * 8;

// The forward's rings at NK D chunks: each warpgroup's depth kStages
// (what shared memory leaves beside the NK resident chunks, at most
// kFwdMaxStages), and kGroup, the chunks of a score tile issued between two
// waits: the largest divisor of NK of which three groups fit in a ring, so
// two groups' chunks are in flight while one group's products run (fewer
// chunks a group drain the products more often; PERF.md §6).
template <int NK>
struct FwdTiling {
  static constexpr int stages() {
    const int s = (kMaxSmem - kFwdFixed - NK * kChunkBytes) /
                  (2 * kChunkBytes);
    return s < kFwdMaxStages ? s : kFwdMaxStages;
  }
  static constexpr int kStages = stages();
  static constexpr int group() {
    for (int gs = NK; gs > 1; --gs)
      if (NK % gs == 0 && 3 * gs <= kStages) return gs;
    return 1;
  }
  static constexpr int kGroup = group();
  static constexpr int kSmem = (NK + 2 * kStages) * kChunkBytes + kFwdFixed;
  static_assert(kGroup <= kStages && kSmem <= kMaxSmem,
                "the resident chunks and the rings fit");
};

// Fold this thread's 32 scores of a 64 x 64 tile (vocab columns c0..c0 +
// 63; those >= V excluded) into its running statistics of rows hh = 0, 1
// over the columns it holds: the max m and the sum l of exp(z - m) (exp2
// domain), zsum, the gold logit, and the argmax (strict >: the first
// column of the maximum).
__device__ __forceinline__ void fwd_fold(const float (&z)[32], int c0, int V,
                                         int t, const int (&lab)[2],
                                         float (&m)[2], float (&l)[2],
                                         float (&zs)[2], float (&gd)[2],
                                         int (&arg)[2]) {
  const bool whole = c0 + kTile <= V;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rel = lab[hh] - c0;  // the gold column within the tile
    float mx = kNegInf;
    int ai = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const float v = z[4 * j + 2 * hh + e];
        if (whole || c0 + col < V) {
          zs[hh] += v;
          gd[hh] += col == rel ? v : 0.f;
          if (v > mx) {
            mx = v;
            ai = c0 + col;
          }
        }
      }
    if (mx > m[hh]) arg[hh] = ai;  // strict: an earlier tile keeps a tie
    const float m_new = fmaxf(m[hh], mx);
    const float m2 = m_new * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (whole || c0 + 8 * j + 2 * t + e < V)
          sum += exp2_ftz(fmaf(z[4 * j + 2 * hh + e], kLog2e, -m2));
    l[hh] = l[hh] * exp2_ftz((m[hh] - m_new) * kLog2e) + sum;
    m[hh] = m_new;
  }
}

// The forward: persistent blocks walk the 64-row tiles, tile w going to
// block w % gridDim.x. Producer warp 0 loads the tile's h rows (NK
// chunks, resident); W's vocab tiles stream as NK chunks [64 d][64 v]
// each, the even tiles through warpgroup 0's ring and the odd ones through
// warpgroup 1's, each ring fed by its own producer warp, so neither ring
// waits on the other's consumer. Each warpgroup computes its tiles' 64 x 64 scores once
// (wgmma, h K-major and the W chunk MN-major, in groups of kGroup chunks)
// and folds them into its threads' statistics while the other
// warpgroup's products run. At the item's end the statistics are reduced
// over each row's four lanes, and warpgroup 1 hands its rows to warpgroup
// 0 through shared memory, which merges them in a fixed order and writes
// the row's lse, gold, zsum and argmax.
template <int NK>
__global__ void __launch_bounds__(kFwdThreads, 1)
    fx_fwd_wgmma(const __grid_constant__ CUtensorMap tm_h,
                 const __grid_constant__ CUtensorMap tm_w,
                 const int* __restrict__ labels, float* __restrict__ lse,
                 float* __restrict__ gold, float* __restrict__ zsum,
                 int* __restrict__ amax, int N, int V) {
  using T = FwdTiling<NK>;
  constexpr int S = T::kStages, GS = T::kGroup;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* res = hopper::align1024(smem_raw);
  uint8_t* ring = res + NK * kChunkBytes;  // warpgroup w's: w S chunks on
  float* merge = reinterpret_cast<float*>(ring + 2 * S * kChunkBytes);
  uint64_t* res_full = reinterpret_cast<uint64_t*>(merge + 2 * kMergeFloats);
  uint64_t* res_empty = res_full + 1;
  uint64_t* full = res_empty + 1;  // [2][S]
  uint64_t* empty = full + 2 * S;  // [2][S]
  const int nv = (V + kTile - 1) / kTile;
  const int items = (N + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    hopper::mbar_init(res_full, 1);
    hopper::mbar_init(res_empty, kConsumers);
    for (int s = 0; s < 2 * S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers / 2);  // one warpgroup
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warp q feeds ring q
    const int q = (threadIdx.x - kConsumers) >> 5;
    if ((threadIdx.x & 31) == 0) {  // one lane issues TMA
      int step = 0;  // chunks loaded into ring q so far
      for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
        if (q == 0) {  // and warp 0 the item's h rows
          hopper::mbar_wait(res_empty, (n & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(res_full, NK * kChunkBytes);
          for (int kc = 0; kc < NK; ++kc)
            hopper::tma_load_2d(res + kc * kChunkBytes, &tm_h, res_full,
                                kc * kTile, w * kTile);
        }
        for (int vt = q; vt < nv; vt += 2)
          for (int kc = 0; kc < NK; ++kc, ++step) {
            const int s = q * S + step % S;
            hopper::mbar_wait(&empty[s], ((step / S) & 1) ^ 1);
            hopper::mbar_arrive_expect_tx(&full[s], kChunkBytes);
            hopper::tma_load_2d(ring + s * kChunkBytes, &tm_w, &full[s],
                                vt * kTile, kc * kTile);
          }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = 16 * warp + g;  // this thread's rows: row, row + 8
  uint8_t* my_ring = ring + wg * S * kChunkBytes;
  uint64_t* my_full = full + wg * S;
  uint64_t* my_empty = empty + wg * S;
  int step = 0;  // chunks of this warpgroup's ring consumed so far
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
    const long r0 = static_cast<long>(w) * kTile;
    int lab[2], arg[2] = {0, 0};
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float zs[2] = {0.f, 0.f}, gd[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long r = r0 + row + 8 * hh;
      lab[hh] = r < N ? labels[r] : -1;
    }
    hopper::mbar_wait(res_full, n & 1);
    for (int vt = wg; vt < nv; vt += 2, step += NK) {
      float z[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) z[i] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < NK; k0 += GS) {
#pragma unroll
        for (int kc = k0; kc < k0 + GS; ++kc)
          hopper::mbar_wait(&my_full[(step + kc) % S], ((step + kc) / S) & 1);
        fence_regs(z);
        hopper::wgmma_fence();
#pragma unroll
        for (int kc = k0; kc < k0 + GS; ++kc) {
          const uint64_t a_desc = desc_sw128(res + kc * kChunkBytes);
          const uint64_t b_desc =
              desc_sw128(my_ring + ((step + kc) % S) * kChunkBytes);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)  // z (+)= h W[:, tile]
            hopper::wgmma_m64n64k16_ss<0, 1>(
                z, a_desc + kk * kKMajorStep, b_desc + kk * kMnMajorStep,
                kc + kk > 0 ? 1 : 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        fence_regs(z);
#pragma unroll
        for (int kc = k0; kc < k0 + GS; ++kc)
          hopper::mbar_arrive(&my_empty[(step + kc) % S]);
      }
      if (vt + 2 >= nv) hopper::mbar_arrive(res_empty);  // h read
      fwd_fold(z, vt * kTile, V, t, lab, m, l, zs, gd, arg);
    }
    if (wg >= nv) hopper::mbar_arrive(res_empty);  // no tile of this item

    // each row over its quad
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float mq = quad_max(m[hh]);
      l[hh] = quad_sum(l[hh] * exp2_ftz((m[hh] - mq) * kLog2e));
      zs[hh] = quad_sum(zs[hh]);
      gd[hh] = quad_sum(gd[hh]);
      float bv = m[hh];
      int bi = arg[hh];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // ties take the smaller index
        const float ov = __shfl_xor_sync(kFullMask, bv, off);
        const int oi = __shfl_xor_sync(kFullMask, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      m[hh] = mq;
      arg[hh] = bi;
    }
    // warpgroup 1's rows to warpgroup 0, which merges them
    float* mb = merge + (n & 1) * kMergeFloats;
    if (wg == 1 && t == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row + 8 * hh;
        mb[r] = m[hh];
        mb[kTile + r] = l[hh];
        mb[2 * kTile + r] = zs[hh];
        mb[3 * kTile + r] = gd[hh];
        mb[4 * kTile + r] = __int_as_float(arg[hh]);
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    if (wg == 1) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row + 8 * hh;
      const float m1 = mb[r], l1 = mb[kTile + r];
      const int a1 = __float_as_int(mb[4 * kTile + r]);
      const float mm = fmaxf(m[hh], m1);
      l[hh] = l[hh] * exp2_ftz((m[hh] - mm) * kLog2e) +
              l1 * exp2_ftz((m1 - mm) * kLog2e);
      if (m1 > m[hh] || (m1 == m[hh] && a1 < arg[hh])) arg[hh] = a1;
      m[hh] = mm;
      zs[hh] += mb[2 * kTile + r];
      gd[hh] += mb[3 * kTile + r];
    }
    if (t == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long r = r0 + row + 8 * hh;
        if (r < N) {
          lse[r] = m[hh] + logf(fmaxf(l[hh], 1e-20f));
          gold[r] = gd[hh];
          zsum[r] = zs[hh];
          amax[r] = arg[hh];
        }
      }
    }
  }
}

// One 64 x 64 x 64 product in each wgmma form the backward kernels issue,
// for the card tests; a, b bf16 [64, 64] row-major, loaded by TMA with the
// 128-byte swizzle, c float32 [64, 64]. Mode 0: c = a b, a K-major and b
// MN-major from shared memory (dh's scores); mode 1: c = a b^T, a from
// registers and b K-major (dh's product); mode 2: c = a^T b^T, a MN-major
// and b K-major from shared memory (dW's transposed scores); modes 3 and 4:
// modes 0 and 2 as two N 32 halves, each reading half of b (the scores
// past D 512).
__global__ void __launch_bounds__(128)
    fx_wgmma_tile_test(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_b,
                       const bf16* __restrict__ a, float* __restrict__ c,
                       int mode) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * kChunkBytes);
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_arrive_expect_tx(bar, 2 * kChunkBytes);
    hopper::tma_load_2d(smem, &tm_a, bar, 0, 0);
    hopper::tma_load_2d(smem + kChunkBytes, &tm_b, bar, 0, 0);
  }
  hopper::mbar_wait(bar, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  uint32_t fa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      fa[kk][r] = *reinterpret_cast<const uint32_t*>(
          a + (r0 + 8 * (r & 1)) * kTile + 16 * kk + 8 * (r >> 1) + 2 * t);
  const uint64_t a_desc = desc_sw128(smem);
  const uint64_t b_desc = desc_sw128(smem + kChunkBytes);
  fence_regs(d);
  fence_regs(fa);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (mode == 0)
      hopper::wgmma_m64n64k16_ss<0, 1>(d, a_desc + kk * kKMajorStep,
                                         b_desc + kk * kMnMajorStep, 1);
    else if (mode == 1)
      hopper::wgmma_m64n64k16_rs<0>(d, fa[kk], b_desc + kk * kKMajorStep);
    else if (mode == 2)
      hopper::wgmma_m64n64k16_ss<1, 0>(d, a_desc + kk * kMnMajorStep,
                                         b_desc + kk * kKMajorStep, 1);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  fence_regs(d);
  fence_regs(fa);
  if (mode < 3) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      c[(r0 + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + 2 * t + (i & 1)] =
          d[i];
    return;
  }
  for (int sub = 0; sub < 2; ++sub) {
    float e[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) e[i] = 0.f;
    fence_regs(e);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (mode == 3)
        hopper::wgmma_m64n32k16_ss<0, 1>(
            e, a_desc + kk * kKMajorStep,
            desc_sw128(smem + kChunkBytes + sub * kTile) + kk * kMnMajorStep,
            1);
      else
        hopper::wgmma_m64n32k16_ss<1, 0>(
            e, a_desc + kk * kMnMajorStep,
            desc_sw128(smem + kChunkBytes + sub * kChunkBytes / 2) +
                kk * kKMajorStep,
            1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_regs(e);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      c[(r0 + 8 * ((i >> 1) & 1)) * 64 + 32 * sub + 8 * (i >> 2) + 2 * t +
        (i & 1)] = e[i];
  }
}

// ===========================================================================
// Launchers
// ===========================================================================

cudaError_t check_shape(int N, int D, int V, int dtype) {
  if (N < 1 || V < 1 || D < 16 || D > kMaxD || D % 16 ||
      (dtype == 1 && V % 8))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int blocks, int threads, int bytes,
                   cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

int tiles(int n, int tile = kTile) { return (n + tile - 1) / tile; }

// float32 backward: the accumulator, two tiles, the dW kernel's per-row
// labels and lse. Accumulator rows are padded by 8 floats (bank spread)
// where that still fits.
int f32_acc_ld(int D) {
  const int fixed = (2 * kTileF + 2 * kTile) * 4;
  return kTile * (D + 8) * 4 + fixed <= kMaxSmem ? D + 8 : D;
}
int f32_bwd_bytes(int acc_ld) {
  return (kTile * acc_ld + 2 * kTileF + 2 * kTile) * 4;
}

// Blocks of a persistent kernel: one per SM of the current device, and no
// more than there are work items.
int persistent_blocks(int items) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    sms = 1;
  return min(items, sms);
}

// The D chunk count a head is built for: D rounded up to an even number
// of chunks of 64 (2 to 12).
int nk_built(int D) { return max(2, (tiles(D) + 1) / 2 * 2); }

// Tensor maps over h [N, D] and W [D, V], boxes of 64 x 64.
cudaError_t head_maps(CUtensorMap& mh, CUtensorMap& mw, const bf16* h,
                      const bf16* w, int N, int D, int V) {
  const cudaError_t e = hopper::bf16_2d_map(&mh, h, D, N, kTile);
  return e == cudaSuccess ? hopper::bf16_2d_map(&mw, w, V, D, kTile) : e;
}

// f(std::integral_constant<int, NK>()) for NK = nk, one of the D chunk
// counts the bfloat16 kernels are built for (2, 4, ..., 12).
template <int NK = 2, typename F>
cudaError_t with_nk(int nk, F f) {
  if constexpr (NK < 12) {
    if (nk != NK) return with_nk<NK + 2>(nk, f);
  }
  if (nk != NK) return cudaErrorInvalidValue;
  return f(std::integral_constant<int, NK>());
}

// The bfloat16 forward.
cudaError_t fwd_wgmma(const bf16* h, const bf16* w, const int* labels,
                      float* lse, float* gold, float* zsum, int* amax, int N,
                      int D, int V, cudaStream_t s) {
  CUtensorMap mh, mw;
  const cudaError_t e = head_maps(mh, mw, h, w, N, D, V);
  if (e != cudaSuccess) return e;
  return with_nk(nk_built(D), [&](auto nk) {
    constexpr int NK = decltype(nk)::value;
    return launch(fx_fwd_wgmma<NK>, persistent_blocks(tiles(N)), kFwdThreads,
                  FwdTiling<NK>::kSmem, s, mh, mw, labels, lse, gold, zsum,
                  amax, N, V);
  });
}

// The bfloat16 dh (dw false) or dW (dw true) kernel.
cudaError_t bwd_wgmma(bool dw, const bf16* h, const bf16* w,
                      const int* labels, const float* lse, const float* coef,
                      bf16* out, int N, int D, int V, cudaStream_t s) {
  CUtensorMap mh, mw;
  const cudaError_t e = head_maps(mh, mw, h, w, N, D, V);
  if (e != cudaSuccess) return e;
  return with_nk(nk_built(D), [&](auto nk) {
    constexpr int NK = decltype(nk)::value;
    static_assert(NK <= kMaxStages &&
                      bwd_smem_bytes(NK, kMaxStages) <= kMaxSmem,
                  "the resident chunks and the ring fit");
    return launch(dw ? fx_dw_wgmma<NK> : fx_dh_wgmma<NK>,
                  persistent_blocks(dw ? tiles(V) : tiles(N)), kThreadsWs,
                  bwd_smem_bytes(NK, kMaxStages), s, mh, mw, labels, lse,
                  coef, out, N, D, V);
  });
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.

extern "C" int ddl_fxent_fwd(const void* h, const void* w, const int* labels,
                             float* lse, float* gold, float* zsum, int* amax,
                             int N, int D, int V, int dtype, void* stream) {
  cudaError_t e = check_shape(N, D, V, dtype);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch(fx_fwd_f32, tiles(N), kThreadsF, 2 * kTileF * 4, s,
                    static_cast<const float*>(h),
                    static_cast<const float*>(w), labels, lse, gold, zsum,
                    amax, N, D, V);
    case 1:
      return fwd_wgmma(static_cast<const bf16*>(h),
                       static_cast<const bf16*>(w), labels, lse, gold, zsum,
                       amax, N, D, V, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int ddl_fxent_dh(const void* h, const void* w, const int* labels,
                            const float* lse, const float* coef, void* out,
                            int N, int D, int V, int dtype, void* stream) {
  cudaError_t e = check_shape(N, D, V, dtype);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: {
      const int ld = f32_acc_ld(D);
      return launch(fx_dh_f32, tiles(N), kThreadsF, f32_bwd_bytes(ld), s,
                    static_cast<const float*>(h),
                    static_cast<const float*>(w), labels, lse, coef,
                    static_cast<float*>(out), N, D, V, ld);
    }
    case 1:
      return bwd_wgmma(false, static_cast<const bf16*>(h),
                       static_cast<const bf16*>(w), labels, lse, coef,
                       static_cast<bf16*>(out), N, D, V, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int ddl_fxent_dw(const void* h, const void* w, const int* labels,
                            const float* lse, const float* coef, void* out,
                            int N, int D, int V, int dtype, void* stream) {
  cudaError_t e = check_shape(N, D, V, dtype);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: {
      const int ld = f32_acc_ld(D);
      return launch(fx_dw_f32, tiles(V), kThreadsF, f32_bwd_bytes(ld), s,
                    static_cast<const float*>(h),
                    static_cast<const float*>(w), labels, lse, coef,
                    static_cast<float*>(out), N, D, V, ld);
    }
    case 1:
      return bwd_wgmma(true, static_cast<const bf16*>(h),
                       static_cast<const bf16*>(w), labels, lse, coef,
                       static_cast<bf16*>(out), N, D, V, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The card tests' check of the wgmma forms of the backward kernels: c
// [64, 64] float32 from a, b bf16 [64, 64] (mode 0: a b, 1: a b^T, 2:
// a^T b^T, 3: a b and 4: a^T b^T in two N 32 halves).
extern "C" int ddl_fx_wgmma_tile_test(const void* a, const void* b, float* c,
                                      int mode, void* stream) {
  CUtensorMap ma, mb;
  cudaError_t e = hopper::bf16_2d_map(&ma, a, kTile, kTile, kTile);
  if (e == cudaSuccess) e = hopper::bf16_2d_map(&mb, b, kTile, kTile, kTile);
  if (e != cudaSuccess) return e;
  return launch(fx_wgmma_tile_test, 1, 128, 2 * kChunkBytes + 8 + 1024,
                static_cast<cudaStream_t>(stream), ma, mb,
                static_cast<const bf16*>(a), c, mode);
}

extern "C" const char* ddl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
