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
// inside one block: the forward and dh take one row tile per block and
// sweep the vocabulary inside it; dW takes one 64-column vocab tile per
// block and sweeps the rows inside it. No atomics: dW is deterministic.
//
// Bound: at lmbench's shape (N 16 384, D 512, V 32 768, bf16) the forward
// does 2 N D V = 5.5e11 flops (0.556 ms at 989 TFLOP/s), dh and dW 4 N D V
// each (the recomputed z and the product: 1.11 ms); the bytes (h 16.8 MB,
// W 33.5 MB) take about 0.015 ms. All three are bound by the tensor cores,
// so the design keeps them fed: operands reach shared memory by cp.async
// (16 bytes a thread, no registers, zero-filled past the edges) ahead of
// their use, fragments come out of it by ldmatrix, and every accumulator
// stays in registers.
//
// bfloat16 build (the training path; V a multiple of 8, so W's rows are
// 16-byte aligned): mma.sync m16n8k16 (bf16 in, f32 accumulate), 8 warps a
// block. D is cut into 64-wide chunks (NK of them, D rounded up, the rest
// zero), staged as bf16 rows of stride 72 (ldmatrix conflict-free).
//   forward: 128 rows a block, resident; a ring of kFwdStages W chunks
//     streams the vocabulary. Warp w owns rows 16 w..16 w + 15 of every
//     64-column score tile and folds it into its rows' statistics.
//   dh: 64 rows a block, resident; the vocab tile's W (all NK chunks)
//     resident too, read by both passes: z = h W (each warp 16 rows x 32
//     columns), dz to shared memory as bf16, then dh += dz W^T (each warp
//     16 rows x the 32-wide half of every D chunk, NK x 16 float32
//     registers). Chunk kc of the next tile is loaded as soon as the
//     second pass is done with chunk kc, under the rest of the pass.
//   dW: the same turned over: the 64-column W tile resident, the 64-row
//     tiles of h streaming through both passes; dW^T += dz^T h in
//     registers over all rows.
// No TMA, wgmma or warp specialisation yet.
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

#include <cstring>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kTile = 64;         // rows and columns of a score tile, D chunk
constexpr int kMaxD = 768;        // the widest head the shared memory holds
constexpr int kMaxNK = kMaxD / kTile;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

using bf16 = __nv_bfloat16;

// Fragment element i of column group nt sits at tile row m0 + g + 8 (i >> 1)
// and tile column n0 + 8 nt + 2 t + (i & 1) (the m16n8 accumulator layout),
// g = lane / 4, t = lane % 4.

// Reductions over the 4 lanes that own a fragment row.
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
// bfloat16: tensor cores
// ===========================================================================

constexpr int kThreads = 256;    // 8 warps
constexpr int kLdc = kTile + 8;  // bf16 stride of a staged [64][64] chunk
constexpr int kChunk = kTile * kLdc;
constexpr int kFwdRows = 128;    // rows of a forward block: 8 warps x 16
constexpr int kFwdStages = 3;    // W chunks in flight in the forward

// d += a * b for one m16n8k16 tile: a the 16 x 16 bf16 A fragment, b0/b1
// the 16 x 8 bf16 B fragment, d the 16 x 8 float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, the first in the low half (the fragment order).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  unsigned u;
  memcpy(&u, &v, 4);
  return u;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without registers; zero bytes read (the
// destination zero-filled) when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cp_async_wait<n> for a count known only after unrolling (n < kMaxNK).
template <int N = 0>
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if constexpr (N < kMaxNK - 1) {
    if (n > N) {
      cp_async_wait_n<N + 1>(n);
      return;
    }
  }
  cp_async_wait<N>();
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and receives, of matrix i, register i: row
// l / 4, columns 2 (l % 4) and + 1 (transposed: rows 2 (l % 4) and + 1 of
// column l / 4).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The A fragment (rows m0.., k0..: 16 x 16) of a buffer holding A
// row-major [m][k] (frag_a) or transposed [k][m] (frag_a_t), stride ld.
__device__ __forceinline__ void frag_a(unsigned (&a)[4], const bf16* buf,
                                       int ld, int m0, int k0) {
  const int l = threadIdx.x & 31, i = l >> 3, r = l & 7;
  ldsm_x4(a, buf + (m0 + r + 8 * (i & 1)) * ld + k0 + 8 * (i >> 1));
}

__device__ __forceinline__ void frag_a_t(unsigned (&a)[4], const bf16* buf,
                                         int ld, int m0, int k0) {
  const int l = threadIdx.x & 31, i = l >> 3, r = l & 7;
  ldsm_x4_t(a, buf + (k0 + r + 8 * (i >> 1)) * ld + m0 + 8 * (i & 1));
}

// The B fragments of two n8 tiles (n0 and n0 + 8; b[0..1] and b[2..3]) over
// k0..k0 + 15, from a buffer holding B transposed [n][k] (frag_b) or
// row-major [k][n] (frag_b_t), stride ld.
__device__ __forceinline__ void frag_b(unsigned (&b)[4], const bf16* buf,
                                       int ld, int n0, int k0) {
  const int l = threadIdx.x & 31, i = l >> 3, r = l & 7;
  ldsm_x4(b, buf + (n0 + r + 8 * (i >> 1)) * ld + k0 + 8 * (i & 1));
}

__device__ __forceinline__ void frag_b_t(unsigned (&b)[4], const bf16* buf,
                                         int ld, int n0, int k0) {
  const int l = threadIdx.x & 31, i = l >> 3, r = l & 7;
  ldsm_x4_t(b, buf + (k0 + r + 8 * (i & 1)) * ld + n0 + 8 * (i >> 1));
}

// acc[2 np], acc[2 np + 1] += A (rows m0.., k0..k0 + 15 of abuf) times B
// (k0.., columns n0 + 16 np.. of bbuf) for np < NP; AT and BT pick the
// transposed buffer layouts.
template <int NP, bool AT, bool BT>
__device__ __forceinline__ void mma_k16(float (*acc)[4], const bf16* abuf,
                                        int lda, int m0, const bf16* bbuf,
                                        int ldb, int n0, int k0) {
  unsigned a[4];
  if (AT)
    frag_a_t(a, abuf, lda, m0, k0);
  else
    frag_a(a, abuf, lda, m0, k0);
#pragma unroll
  for (int np = 0; np < NP; ++np) {
    unsigned b[4];
    if (BT)
      frag_b_t(b, bbuf, ldb, n0 + 16 * np, k0);
    else
      frag_b(b, bbuf, ldb, n0 + 16 * np, k0);
    mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// A [64 rows][64 cols] block at src (row stride ld; rows < nr and columns <
// nc read, nc a multiple of 8) into a chunk buffer, asynchronously.
__device__ __forceinline__ void load_chunk(const bf16* src, long ld, int nr,
                                           int nc, bf16* dst) {
#pragma unroll
  for (int i = 0; i < kTile * 8 / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads, r = c >> 3, col = (c & 7) * 8;
    const bool ok = r < nr && col < nc;
    cp_async16(dst + r * kLdc + col, ok ? src + r * ld + col : src, ok);
  }
}

// Rows [0, rows) x columns [0, width) of a row-major block at src into dst
// (stride ldd), asynchronously; rows >= nr and columns >= nc zero-filled.
__device__ __forceinline__ void load_rows(const bf16* src, long ld, int nr,
                                          int nc, int rows, int width,
                                          int ldd, bf16* dst) {
  const int per = width / 8;
  for (int c = threadIdx.x; c < rows * per; c += kThreads) {
    const int r = c / per, col = (c % per) * 8;
    const bool ok = r < nr && col < nc;
    cp_async16(dst + r * ldd + col, ok ? src + r * ld + col : src, ok);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// The labels and lse of this thread's two rows m0 + g, m0 + g + 8 of the
// row tile at r0 (nr live).
__device__ __forceinline__ void row_labels(const int* labels,
                                           const float* lse, long r0, int nr,
                                           int row, int (&lab)[2],
                                           float (&lse_r)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    lab[hh] = r < nr ? labels[r0 + r] : -1;
    lse_r[hh] = r < nr ? lse[r0 + r] : 0.f;
  }
}

// dz of this thread's fragment elements of a 16 x 32 score part (rows
// m0 + g + 8 hh, columns n0 + 8 nt + 2 t + e of the vocab tile at c0, nc
// of them live), into the bf16 dz tile (stride kLdc).
__device__ __forceinline__ void write_dz(const float (&z)[4][4],
                                         const int (&lab)[2],
                                         const float (&lse_r)[2], int m0,
                                         int n0, int c0, int nc, float c_p,
                                         float c_oh, float c_sm, bf16* dzs) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int col = n0 + 8 * nt + 2 * t;
      float dz[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        dz[e] = dz_of(z[nt][2 * hh + e], lab[hh], lse_r[hh], c0 + col + e,
                      col + e < nc, c_p, c_oh, c_sm);
      *reinterpret_cast<unsigned*>(dzs + (m0 + g + 8 * hh) * kLdc + col) =
          pack_bf16(dz[0], dz[1]);
    }
}

__global__ void __launch_bounds__(kThreads, 1)
    fx_fwd_mma(const bf16* __restrict__ h, const bf16* __restrict__ w,
               const int* __restrict__ labels, float* __restrict__ lse,
               float* __restrict__ gold, float* __restrict__ zsum,
               int* __restrict__ amax, int N, int D, int V) {
  extern __shared__ float4 smem4[];
  const int nk = (D + kTile - 1) / kTile, ldr = nk * kTile + 8;
  bf16* hres = reinterpret_cast<bf16*>(smem4);  // [128 rows][ldr], resident
  bf16* ring = hres + kFwdRows * ldr;           // kFwdStages W chunks
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (threadIdx.x >> 5);
  const long r0 = static_cast<long>(blockIdx.x) * kFwdRows;
  const int nr = static_cast<int>(min(static_cast<long>(kFwdRows), N - r0));
  RowStats st;
  stats_init(st, labels, r0, m0 + g, nr);
  const int nv = (V + kTile - 1) / kTile, Q = nv * nk;
  // the flat stream of W chunks: q -> (vocab tile q / nk, D chunk q % nk)
  auto load_q = [&](int q) {
    const int vt = q / nk, kc = q % nk;
    load_chunk(w + static_cast<long>(kc) * kTile * V + vt * kTile, V,
               D - kc * kTile, V - vt * kTile,
               ring + (q % kFwdStages) * kChunk);
  };
  load_rows(h + r0 * D, D, nr, D, kFwdRows, nk * kTile, ldr, hres);
#pragma unroll
  for (int s = 0; s < kFwdStages - 1; ++s) {
    if (s < Q) load_q(s);
    cp_async_commit();  // the first group carries the resident rows too
  }
  float s[8][4];
  for (int q = 0; q < Q; ++q) {
    cp_async_wait<kFwdStages - 2>();
    __syncthreads();  // chunk q has landed; every warp is done with q - 1
    if (q + kFwdStages - 1 < Q) load_q(q + kFwdStages - 1);
    cp_async_commit();
    const int vt = q / nk, kc = q % nk;
    if (kc == 0) zero(s);
    const bf16* wc = ring + (q % kFwdStages) * kChunk;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_k16<4, false, true>(s, hres + kc * kTile, ldr, m0, wc, kLdc, 0,
                              16 * kk);
    if (kc == nk - 1) stats_fold(st, s, vt * kTile, min(kTile, V - vt * kTile),
                                 t);
  }
  stats_write(st, r0, m0 + g, nr, t, lse, gold, zsum, amax);
}

// dh for 64 rows a block, NK = D chunks. Warp w owns rows 16 (w % 4).. and,
// of every 64-wide tile, the 32-wide half w / 4: of the vocab tile's
// scores, and of each D chunk of dh, whose float32 accumulator stays in
// registers for the whole sweep.
template <int NK>
__global__ void __launch_bounds__(kThreads, 1)
    fx_dh_mma(const bf16* __restrict__ h, const bf16* __restrict__ w,
              const int* __restrict__ labels, const float* __restrict__ lse,
              const float* __restrict__ coef, bf16* __restrict__ dh, int N,
              int D, int V) {
  extern __shared__ float4 smem4[];
  constexpr int ldr = NK * kTile + 8;
  bf16* hres = reinterpret_cast<bf16*>(smem4);  // [64 rows][ldr]
  bf16* wt = hres + kTile * ldr;                // NK chunks [64 d][64 c]
  bf16* dzs = wt + NK * kChunk;                 // [64 rows][64 c]
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  const long r0 = static_cast<long>(blockIdx.x) * kTile;
  const int nr = static_cast<int>(min(static_cast<long>(kTile), N - r0));
  const float c_p = coef[0], c_oh = coef[1], c_sm = coef[2];
  int lab[2];
  float lse_r[2];
  row_labels(labels, lse, r0, nr, m0 + g, lab, lse_r);
  float acc[NK][4][4];
#pragma unroll
  for (int kc = 0; kc < NK; ++kc) zero(acc[kc]);
  const int nv = (V + kTile - 1) / kTile;
  load_rows(h + r0 * D, D, nr, D, kTile, NK * kTile, ldr, hres);
#pragma unroll
  for (int kc = 0; kc < NK; ++kc) {
    load_chunk(w + static_cast<long>(kc) * kTile * V, V, D - kc * kTile, V,
               wt + kc * kChunk);
    cp_async_commit();
  }
  for (int vt = 0; vt < nv; ++vt) {
    const int c0 = vt * kTile;
    float z[4][4];
    zero(z);
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {  // z = h @ W[:, tile]
      cp_async_wait_n(NK - 1 - kc);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_k16<2, false, true>(z, hres + kc * kTile, ldr, m0,
                                wt + kc * kChunk, kLdc, n0, 16 * kk);
    }
    write_dz(z, lab, lse_r, m0, n0, c0, min(kTile, V - c0), c_p, c_oh, c_sm,
             dzs);
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {  // dh[:, chunk] += dz @ W[chunk]^T
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_k16<2, false, false>(acc[kc], dzs, kLdc, m0, wt + kc * kChunk,
                                 kLdc, n0, 16 * kk);
      __syncthreads();  // every warp is done with chunk kc
      if (vt + 1 < nv)
        load_chunk(w + static_cast<long>(kc) * kTile * V + c0 + kTile, V,
                   D - kc * kTile, V - c0 - kTile, wt + kc * kChunk);
      cp_async_commit();
    }
  }
#pragma unroll
  for (int kc = 0; kc < NK; ++kc)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = m0 + g + 8 * hh, d = kc * kTile + n0 + 8 * nt + 2 * t;
        if (r < nr && d < D)
          *reinterpret_cast<unsigned*>(dh + (r0 + r) * D + d) =
              pack_bf16(acc[kc][nt][2 * hh], acc[kc][nt][2 * hh + 1]);
      }
}

// dW for 64 vocab columns a block. In the first pass warp w owns rows
// 16 (w % 4).. and columns 32 (w / 4).. of the scores; in the second,
// vocab columns 16 (w % 4).. and the 32-wide half w / 4 of each D chunk of
// dW^T, accumulated in registers over all rows.
template <int NK>
__global__ void __launch_bounds__(kThreads, 1)
    fx_dw_mma(const bf16* __restrict__ h, const bf16* __restrict__ w,
              const int* __restrict__ labels, const float* __restrict__ lse,
              const float* __restrict__ coef, bf16* __restrict__ dw, int N,
              int D, int V) {
  extern __shared__ float4 smem4[];
  bf16* wres = reinterpret_cast<bf16*>(smem4);  // NK chunks [64 d][64 c]
  bf16* hc = wres + NK * kChunk;                // NK chunks [64 r][64 d]
  bf16* dzs = hc + NK * kChunk;                 // [64 r][64 c]
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  const int c0 = blockIdx.x * kTile, nc = min(kTile, V - c0);
  const float c_p = coef[0], c_oh = coef[1], c_sm = coef[2];
  float acc[NK][4][4];
#pragma unroll
  for (int kc = 0; kc < NK; ++kc) zero(acc[kc]);
  const int nrt = (N + kTile - 1) / kTile;
#pragma unroll
  for (int kc = 0; kc < NK; ++kc) {
    load_chunk(w + static_cast<long>(kc) * kTile * V + c0, V, D - kc * kTile,
               nc, wres + kc * kChunk);
    load_chunk(h + kc * kTile, D, min(kTile, N), D - kc * kTile,
               hc + kc * kChunk);
    cp_async_commit();
  }
  for (int rt = 0; rt < nrt; ++rt) {
    const long r0 = static_cast<long>(rt) * kTile;
    const int nr = static_cast<int>(min(static_cast<long>(kTile), N - r0));
    int lab[2];
    float lse_r[2];
    row_labels(labels, lse, r0, nr, m0 + g, lab, lse_r);
    float z[4][4];
    zero(z);
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {  // z = h[tile] @ W[:, c0..]
      cp_async_wait_n(NK - 1 - kc);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_k16<2, false, true>(z, hc + kc * kChunk, kLdc, m0,
                                wres + kc * kChunk, kLdc, n0, 16 * kk);
    }
    write_dz(z, lab, lse_r, m0, n0, c0, nc, c_p, c_oh, c_sm, dzs);
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {  // dW^T[:, chunk] += dz^T @ h[tile]
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_k16<2, true, true>(acc[kc], dzs, kLdc, m0, hc + kc * kChunk,
                               kLdc, n0, 16 * kk);
      __syncthreads();  // every warp is done with chunk kc
      if (rt + 1 < nrt)
        load_chunk(h + (r0 + kTile) * D + kc * kTile, D,
                   static_cast<int>(min(static_cast<long>(kTile),
                                        N - r0 - kTile)),
                   D - kc * kTile, hc + kc * kChunk);
      cp_async_commit();
    }
  }
#pragma unroll
  for (int kc = 0; kc < NK; ++kc)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = m0 + g + 8 * (i >> 1);
        const int d = kc * kTile + n0 + 8 * nt + 2 * t + (i & 1);
        if (c < nc && d < D)
          dw[static_cast<long>(d) * V + c0 + c] =
              __float2bfloat16_rn(acc[kc][nt][i]);
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

// The D chunk counts the bf16 backward kernels are built for: D is
// rounded up to the next (the chunks past D are zero).
constexpr int next_nk(int nk) {
  return nk < 2 ? nk + 1 : nk < 4 ? 4 : nk < 8 ? 8 : kMaxNK;
}
int nk_built(int D) {
  int nk = 1;
  while (nk < tiles(D)) nk = next_nk(nk);
  return nk;
}

template <int NK>
cudaError_t dh_mma(const bf16* h, const bf16* w, const int* labels,
                   const float* lse, const float* coef, bf16* out, int N,
                   int D, int V, int nk, cudaStream_t s) {
  if constexpr (NK < kMaxNK) {
    if (nk != NK)
      return dh_mma<next_nk(NK)>(h, w, labels, lse, coef, out, N, D, V, nk,
                                 s);
  }
  const int bytes = (kTile * (NK * kTile + 8) + (NK + 1) * kChunk) * 2;
  return launch(fx_dh_mma<NK>, tiles(N), kThreads, bytes, s, h, w, labels,
                lse, coef, out, N, D, V);
}

template <int NK>
cudaError_t dw_mma(const bf16* h, const bf16* w, const int* labels,
                   const float* lse, const float* coef, bf16* out, int N,
                   int D, int V, int nk, cudaStream_t s) {
  if constexpr (NK < kMaxNK) {
    if (nk != NK)
      return dw_mma<next_nk(NK)>(h, w, labels, lse, coef, out, N, D, V, nk,
                                 s);
  }
  const int bytes = (2 * NK + 1) * kChunk * 2;
  return launch(fx_dw_mma<NK>, tiles(V), kThreads, bytes, s, h, w, labels,
                lse, coef, out, N, D, V);
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
      return launch(fx_fwd_mma, tiles(N, kFwdRows), kThreads,
                    (kFwdRows * (tiles(D) * kTile + 8) + kFwdStages * kChunk) *
                        2,
                    s, static_cast<const bf16*>(h),
                    static_cast<const bf16*>(w), labels, lse, gold, zsum,
                    amax, N, D, V);
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
      return dh_mma<1>(static_cast<const bf16*>(h),
                       static_cast<const bf16*>(w), labels, lse, coef,
                       static_cast<bf16*>(out), N, D, V, nk_built(D), s);
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
      return dw_mma<1>(static_cast<const bf16*>(h),
                       static_cast<const bf16*>(w), labels, lse, coef,
                       static_cast<bf16*>(out), N, D, V, nk_built(D), s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ddl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
