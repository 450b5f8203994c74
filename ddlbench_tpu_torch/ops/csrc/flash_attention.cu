// Causal / prefix-LM flash attention (forward, dQ, dK/dV) for Hopper
// (sm_90a).
//
// Three kernels, each replacing a Pallas TPU kernel of the JAX package
// (ddlbench_tpu/ops/flash_attention.py), each in two builds, one per input
// type:
//
//   forward  <- _fwd_kernel_res (:205) / _fwd_kernel_stream (:304),
//               launched by _flash_fwd_impl (:420): O and the row
//               logsumexp (lse) in one online-softmax sweep.
//   dQ       <- _dq_kernel_res (:235) / _dq_kernel_stream (:335), launched
//               by _flash_bwd_core (:494, call :549): dQ, recomputing P
//               from the saved lse.
//   dK/dV    <- _dkv_kernel_res (:261) / _dkv_kernel_stream (:361),
//               launched by _flash_bwd_core (call :597): dK and dV over the
//               query-side sweep.
//
// Semantics (the TPU kernels', not their block layout): scale 1/sqrt(dh);
// every product accumulates in float32; masked scores are -1e30 (not -inf);
// a key at absolute position k_offset + j is visible to the query at
// q_offset + i when q_pos >= k_pos or k_pos < prefix_len (prefix-LM);
// o = acc / max(l, 1e-20) and lse = m + log(max(l, 1e-20)), so a fully
// masked row gives o = 0 and lse ~ -1e30. In the backward the mask selects
// BEFORE anything multiplies: p = mask ? exp(s - lse) : 0, because exp of a
// masked score minus a fully masked row's lse overflows to inf and inf * 0
// would put NaN into the gradients. ds = p * (dp - delta) * scale, with
// delta = rowsum(dO * O) computed by the caller. As in the reference's
// bfloat16 path, P and dS are rounded to bfloat16 before the products they
// feed (P V, dS K, P^T dO, dS^T Q); the row sum l stays float32.
//
// Block skipping, as on the TPU: a query tile stops at its last visible key
// tile (the forward and dQ), and a key tile starts at the first query tile
// that can see it, or at 0 when it overlaps the prefix (dK/dV). Any Tq and
// Tk: tail tiles are masked here (the TPU's divisor rule is not carried
// over), and rows past the end are staged as zeros and never written. Tiles
// are 64 x 64 and shared memory per block is fixed whatever T is: the TPU's
// resident/streaming split is a VMEM artifact, and one streaming design
// serves every length.
//
// Bound: at the training shape (B 16, H 8, T 1024, dh 64, bf16, causal) one
// call must move its operands once (about 67 MB for the forward, 20 us at
// 3.35 TB/s) and do 4 (forward), 6 (dQ) or 8 (dK/dV) * dh flops per visible
// (query, key) pair (17 to 34 GFLOP, 17 to 35 us at the bf16 tensor-core
// rate): memory and the tensor cores are both near their limit.
//
// bfloat16 build (the training path): the tile products run on the tensor
// cores, mma.sync m16n8k16 (bf16 in, f32 accumulate), with the FlashAttention-2
// register layout. One block of 4 warps per (64-row tile, batch*head); each
// warp owns 16 rows of the tile and keeps its operand fragments of the fixed
// side (Q in the forward; Q and dO in dQ; K and V in dK/dV) in registers for
// the whole sweep. Score fragments become the next product's A fragments in
// registers (the m16n8 accumulator layout of two adjacent key columns is
// the m16k16 A layout), so P and dS never touch shared memory. The swept
// tiles are staged in shared memory as bfloat16 rows of stride kLdh = 72
// (the 8-element pad puts the 32 lanes' fragment words on 32 banks), plus a
// transposed copy where a product needs the tile as its B operand along the
// other axis (V^T in the forward, K^T in dQ, Q^T and dO^T in dK/dV). Row
// max and sum are two xor shuffles over a row's 4 owner lanes. No cp.async,
// TMA or wgmma yet, and no double buffering: a tile's loads and its
// products do not overlap.
//
// float32 build (the tests' plain comparisons and --dtype float32): the
// same sweep with float32 FMAs on the CUDA cores. One block of 256 threads;
// thread (ty, tx) = (tid / 16, tid % 16) holds the 4x4 score entries at
// rows ty + 16 i and columns tx + 16 j and the 4x4 output entries at rows
// ty + 16 i and head dims 4 tx + j; a row's 16 owners are a half-warp, so
// row max and sum are four xor shuffles. Tiles are float32 rows of stride
// kLd = 68 (float4 reads, conflict-free).
//
// Inputs are contiguous [B*H, T, 64]; lse and delta are float32 [B*H, Tq];
// outputs are in the input type. Plain C interface, bound with ctypes: each
// launcher returns cudaGetLastError() and launches on the stream it is
// given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kDh = 64;    // head dim of every transformer variant
constexpr int kTile = 64;  // rows of a query tile, keys of a key tile
static_assert(kTile == kDh, "one row stride serves every 64 x 64 tile");

__device__ __forceinline__ bool visible(int q_pos, int k_pos, int prefix_len) {
  return q_pos >= k_pos || k_pos < prefix_len;
}

// Number of leading key tiles a query at absolute position <= q_hi_pos can
// see (flash_attention.py _causal_kv_bound).
__device__ __forceinline__ int kv_tiles(int q_hi_pos, int k_offset,
                                        int prefix_len, int num_k) {
  int vis = q_hi_pos - k_offset + 1;
  if (prefix_len) vis = max(vis, prefix_len - k_offset);
  if (vis <= 0) return 0;
  return min((vis + kTile - 1) / kTile, num_k);
}

// First query tile whose last row can see key tile kt's first key, 0 when
// the tile overlaps the prefix (flash_attention.py :272-275).
__device__ __forceinline__ int first_q_tile(int kt, int q_offset, int k_offset,
                                            int prefix_len, int num_q) {
  const int k_lo = k_offset + kt * kTile;
  if (prefix_len && k_lo < prefix_len) return 0;
  const int rel = k_lo - q_offset;
  if (rel <= 0) return 0;
  return min(rel / kTile, num_q);
}

// ===========================================================================
// bfloat16: tensor cores
// ===========================================================================

using bf16 = __nv_bfloat16;
constexpr int kWarpsMma = 4;  // 16 tile rows per warp
constexpr int kThreadsMma = 32 * kWarpsMma;
constexpr int kLdh = kDh + 8;  // bf16 row stride of a staged tile
constexpr int kTileHalves = kTile * kLdh;

// d += a * b for one m16n8k16 tile: a is the 16 x 16 bf16 A fragment, b0/b1
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

// The 32-bit word holding tile[row][col] and tile[row][col + 1] (col even).
__device__ __forceinline__ unsigned word(const bf16* tile, int row, int col) {
  return *reinterpret_cast<const unsigned*>(tile + row * kLdh + col);
}

// Stage rows [0, n_rows) of a kTile x kDh tile (row r at src + r * kDh) into
// dst (stride kLdh); rows past n_rows become zeros. 16-byte chunks, eight
// lanes to a row: coalesced.
__device__ __forceinline__ void stage(const bf16* __restrict__ src, int n_rows,
                                      bf16* __restrict__ dst) {
  for (int c = threadIdx.x; c < kTile * 8; c += kThreadsMma) {
    const int r = c >> 3, col = (c & 7) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows)
      u = *reinterpret_cast<const uint4*>(src + static_cast<long>(r) * kDh + col);
    *reinterpret_cast<uint4*>(dst + r * kLdh + col) = u;
  }
}

// The same tile transposed: dst[d][r] = src[r][d]. Consecutive lanes take
// consecutive rows, so each 2-byte store of a warp lands in one 64-byte run.
__device__ __forceinline__ void stage_t(const bf16* __restrict__ src,
                                        int n_rows, bf16* __restrict__ dst) {
  for (int c = threadIdx.x; c < kTile * 8; c += kThreadsMma) {
    const int r = c & (kTile - 1), col = (c / kTile) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows)
      u = *reinterpret_cast<const uint4*>(src + static_cast<long>(r) * kDh + col);
    bf16 e[8];
    memcpy(e, &u, 16);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(col + i) * kLdh + r] = e[i];
  }
}

// A fragments of this warp's 16 rows (row0 = 16 warp + g) of a staged tile,
// for the four 16-wide chunks of the head dim.
__device__ __forceinline__ void load_a(const bf16* tile, int row0, int t,
                                       unsigned (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = word(tile, row0, 16 * kk + 2 * t);
    a[kk][1] = word(tile, row0 + 8, 16 * kk + 2 * t);
    a[kk][2] = word(tile, row0, 16 * kk + 8 + 2 * t);
    a[kk][3] = word(tile, row0 + 8, 16 * kk + 8 + 2 * t);
  }
}

// s[nt] = a * b^T over the head dim for the 8 column groups nt of 8 rows of
// the staged tile b (row-major [column][dh]): the score-shaped products
// Q K^T, dO V^T, K Q^T and V dO^T.
__device__ __forceinline__ void scores(const unsigned (&a)[4][4],
                                       const bf16* b, int g, int t,
                                       float (&s)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_bf16(s[nt], a[kk], word(b, 8 * nt + g, 16 * kk + 2 * t),
               word(b, 8 * nt + g, 16 * kk + 8 + 2 * t));
  }
}

// acc[dt] += p * w over the tile's 64 columns, p the score-shaped fragments
// (rounded to bf16 here), w staged transposed ([head dim][column]): the
// output-shaped products P V, dS K, P^T dO and dS^T Q.
__device__ __forceinline__ void accumulate(const float (&p)[8][4],
                                           const bf16* wt, int g, int t,
                                           float (&acc)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const unsigned a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      mma_bf16(acc[dt], a, word(wt, 8 * dt + g, 16 * kk + 2 * t),
               word(wt, 8 * dt + g, 16 * kk + 8 + 2 * t));
  }
}

// Reductions over the 4 lanes that own a fragment row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  return x + __shfl_xor_sync(kFullMask, x, 2);
}

// Write rows row0 and row0 + 8 (those below n_rows) of an output-shaped
// accumulator, times mul[h], to out (row-major [row][dh]).
__device__ __forceinline__ void store_rows(const float (&acc)[8][4],
                                           const float (&mul)[2], int row0,
                                           int n_rows, int t,
                                           bf16* __restrict__ out) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= n_rows) continue;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      *reinterpret_cast<unsigned*>(out + static_cast<long>(r) * kDh + 8 * dt +
                                   2 * t) =
          pack_bf16(acc[dt][2 * h] * mul[h], acc[dt][2 * h + 1] * mul[h]);
  }
}

// Fragment element i of column group nt sits at row row0 + 8 (i >> 1) and
// column 8 nt + 2 t + (i & 1) of the 64 x 64 score tile.

__global__ void __launch_bounds__(kThreadsMma)
    flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  float* __restrict__ lse, int Tq, int Tk, int q_offset,
                  int k_offset, int prefix_len, float scale) {
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* ks = qs + kTileHalves;
  bf16* vt = ks + kTileHalves;  // V^T
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = 16 * (threadIdx.x >> 5) + g;
  const int num_q = (Tq + kTile - 1) / kTile;
  const int num_k = (Tk + kTile - 1) / kTile;
  const int qt = num_q - 1 - static_cast<int>(blockIdx.x);  // longest first
  const long bh = blockIdx.y;
  const int q0 = qt * kTile;
  const int nq = min(kTile, Tq - q0);
  stage(q + (bh * Tq + q0) * kDh, nq, qs);
  __syncthreads();
  unsigned qa[4][4];
  load_a(qs, row0, t, qa);
  const int n_kt = kv_tiles(q_offset + q0 + nq - 1, k_offset, prefix_len, num_k);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    const int nk = min(kTile, Tk - k0);
    __syncthreads();  // every warp is done with the previous ks, vt
    stage(k + (bh * Tk + k0) * kDh, nk, ks);
    stage_t(v + (bh * Tk + k0) * kDh, nk, vt);
    __syncthreads();
    float s[8][4];
    scores(qa, ks, g, t, s);
    unsigned ok = 0;  // bit 4 nt + i: element (nt, i) is visible
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1, kc = 8 * nt + 2 * t + (i & 1);
        const bool vis = kc < nk && visible(q_offset + q0 + row0 + 8 * h,
                                            k_offset + k0 + kc, prefix_len);
        ok |= static_cast<unsigned>(vis) << (4 * nt + i);
        s[nt][i] = vis ? s[nt][i] * scale : kNegInf;
        mx[h] = fmaxf(mx[h], s[nt][i]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        s[nt][i] = (ok >> (4 * nt + i)) & 1u ? expf(s[nt][i] - m[h]) : 0.f;
        sum[h] += s[nt][i];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + quad_sum(sum[h]);
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[dt][i] *= corr[i >> 1];
    accumulate(s, vt, g, t, acc);
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l_safe = fmaxf(l[h], 1e-20f);
    inv[h] = 1.f / l_safe;
    const int r = row0 + 8 * h;
    if (t == 0 && r < nq) lse[bh * Tq + q0 + r] = m[h] + logf(l_safe);
  }
  store_rows(acc, inv, row0, nq, t, o + (bh * Tq + q0) * kDh);
}

__global__ void __launch_bounds__(kThreadsMma)
    flash_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int Tq, int Tk, int q_offset,
                 int k_offset, int prefix_len, float scale) {
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* dos = qs + kTileHalves;
  bf16* ks = dos + kTileHalves;
  bf16* kt_s = ks + kTileHalves;  // K^T
  bf16* vs = kt_s + kTileHalves;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = 16 * (threadIdx.x >> 5) + g;
  const int num_q = (Tq + kTile - 1) / kTile;
  const int num_k = (Tk + kTile - 1) / kTile;
  const int qt = num_q - 1 - static_cast<int>(blockIdx.x);
  const long bh = blockIdx.y;
  const int q0 = qt * kTile;
  const int nq = min(kTile, Tq - q0);
  stage(q + (bh * Tq + q0) * kDh, nq, qs);
  stage(dout + (bh * Tq + q0) * kDh, nq, dos);
  __syncthreads();
  unsigned qa[4][4], doa[4][4];
  load_a(qs, row0, t, qa);
  load_a(dos, row0, t, doa);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    lse_r[h] = r < nq ? lse[bh * Tq + q0 + r] : 0.f;
    delta_r[h] = r < nq ? delta[bh * Tq + q0 + r] : 0.f;
  }
  const int n_kt = kv_tiles(q_offset + q0 + nq - 1, k_offset, prefix_len, num_k);

  float acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    const int nk = min(kTile, Tk - k0);
    __syncthreads();
    stage(k + (bh * Tk + k0) * kDh, nk, ks);
    stage_t(k + (bh * Tk + k0) * kDh, nk, kt_s);
    stage(v + (bh * Tk + k0) * kDh, nk, vs);
    __syncthreads();
    float s[8][4], dp[8][4];
    scores(qa, ks, g, t, s);
    scores(doa, vs, g, t, dp);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1, kc = 8 * nt + 2 * t + (i & 1);
        const bool vis = kc < nk && visible(q_offset + q0 + row0 + 8 * h,
                                            k_offset + k0 + kc, prefix_len);
        const float p = vis ? expf(s[nt][i] * scale - lse_r[h]) : 0.f;
        s[nt][i] = p * (dp[nt][i] - delta_r[h]) * scale;  // ds
      }
    accumulate(s, kt_s, g, t, acc);
  }
  const float one[2] = {1.f, 1.f};
  store_rows(acc, one, row0, nq, t, dq + (bh * Tq + q0) * kDh);
}

__global__ void __launch_bounds__(kThreadsMma)
    flash_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int Tq, int Tk, int q_offset,
                  int k_offset, int prefix_len, float scale) {
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* dos = qs + kTileHalves;
  bf16* qt_s = dos + kTileHalves;   // Q^T
  bf16* dot_s = qt_s + kTileHalves;  // dO^T
  float* lse_s = reinterpret_cast<float*>(dot_s + kTileHalves);
  float* delta_s = lse_s + kTile;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = 16 * (threadIdx.x >> 5) + g;  // this warp's keys
  const int num_q = (Tq + kTile - 1) / kTile;
  const int kt = blockIdx.x;  // early key tiles have the most query tiles
  const long bh = blockIdx.y;
  const int k0 = kt * kTile;
  const int nk = min(kTile, Tk - k0);
  // K and V pass through the Q and dO buffers into registers
  stage(k + (bh * Tk + k0) * kDh, nk, qs);
  stage(v + (bh * Tk + k0) * kDh, nk, dos);
  __syncthreads();
  unsigned ka[4][4], va[4][4];
  load_a(qs, row0, t, ka);
  load_a(dos, row0, t, va);
  const int start = first_q_tile(kt, q_offset, k_offset, prefix_len, num_q);

  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[dt][i] = dv_acc[dt][i] = 0.f;
  for (int qt = start; qt < num_q; ++qt) {
    const int q0 = qt * kTile;
    const int nq = min(kTile, Tq - q0);
    __syncthreads();
    stage(q + (bh * Tq + q0) * kDh, nq, qs);
    stage(dout + (bh * Tq + q0) * kDh, nq, dos);
    stage_t(q + (bh * Tq + q0) * kDh, nq, qt_s);
    stage_t(dout + (bh * Tq + q0) * kDh, nq, dot_s);
    const int tr = threadIdx.x;
    if (tr < kTile) {
      lse_s[tr] = tr < nq ? lse[bh * Tq + q0 + tr] : 0.f;
      delta_s[tr] = tr < nq ? delta[bh * Tq + q0 + tr] : 0.f;
    }
    __syncthreads();
    // transposed scores: keys as rows, queries as columns
    float p[8][4], ds[8][4];
    scores(ka, qs, g, t, p);
    scores(va, dos, g, t, ds);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = row0 + 8 * (i >> 1), qc = 8 * nt + 2 * t + (i & 1);
        const bool vis = qc < nq && kr < nk &&
                         visible(q_offset + q0 + qc, k_offset + k0 + kr,
                                 prefix_len);
        const float pv = vis ? expf(p[nt][i] * scale - lse_s[qc]) : 0.f;
        ds[nt][i] = pv * (ds[nt][i] - delta_s[qc]) * scale;
        p[nt][i] = pv;
      }
    accumulate(p, dot_s, g, t, dv_acc);   // dV += P^T dO
    accumulate(ds, qt_s, g, t, dk_acc);   // dK += dS^T Q
  }
  const float one[2] = {1.f, 1.f};
  store_rows(dk_acc, one, row0, nk, t, dk + (bh * Tk + k0) * kDh);
  store_rows(dv_acc, one, row0, nk, t, dv + (bh * Tk + k0) * kDh);
}

// ===========================================================================
// float32: CUDA cores
// ===========================================================================

constexpr int kThreads = 256;
constexpr int kLd = kDh + 4;  // float32 row stride of a staged tile
constexpr int kTileFloats = kTile * kLd;

// Stage rows [0, n_rows) of a kTile x kDh float32 tile into dst (stride
// kLd); rows past n_rows become zeros. 16-byte chunks, coalesced.
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int n_rows, float* __restrict__ dst) {
  for (int c = threadIdx.x; c < kTile * (kDh / 4); c += kThreads) {
    const int r = c / (kDh / 4);
    const int col = (c % (kDh / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows)
      x = *reinterpret_cast<const float4*>(src + static_cast<long>(r) * kDh + col);
    *reinterpret_cast<float4*>(dst + r * kLd + col) = x;
  }
}

// kTile per-row floats (lse or delta) into dst; rows past n_rows are 0.
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          int n_rows, float* __restrict__ dst) {
  const int t = threadIdx.x;
  if (t < kTile) dst[t] = t < n_rows ? src[t] : 0.f;
}

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] (both tiles row-major,
// stride kLd): the score-shaped products Q K^T and dO V^T.
__device__ __forceinline__ void rows_dot_rows(const float* __restrict__ a,
                                              const float* __restrict__ b,
                                              int ty, int tx,
                                              float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kDh; d += 4) {
    float av[4][4], bv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(a + (ty + 16 * i) * kLd + d);
      av[i][0] = x.x; av[i][1] = x.y; av[i][2] = x.z; av[i][3] = x.w;
      const float4 y =
          *reinterpret_cast<const float4*>(b + (tx + 16 * i) * kLd + d);
      bv[i][0] = y.x; bv[i][1] = y.y; bv[i][2] = y.z; bv[i][3] = y.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j] = fmaf(av[i][e], bv[j][e], s[i][j]);
  }
}

// acc[i][j] += sum_c p[ty + 16 i][c] * w[c][4 tx + j] over the kTile
// columns c of p: the output-shaped products P V, dS K, P^T dO and dS^T Q.
__device__ __forceinline__ void rows_times_tile(const float* __restrict__ p,
                                                const float* __restrict__ w,
                                                int ty, int tx,
                                                float (&acc)[4][4]) {
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float pv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(p + (ty + 16 * i) * kLd + c);
      pv[i][0] = x.x; pv[i][1] = x.y; pv[i][2] = x.z; pv[i][3] = x.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 y =
          *reinterpret_cast<const float4*>(w + (c + e) * kLd + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(pv[i][e], y.x, acc[i][0]);
        acc[i][1] = fmaf(pv[i][e], y.y, acc[i][1]);
        acc[i][2] = fmaf(pv[i][e], y.z, acc[i][2]);
        acc[i][3] = fmaf(pv[i][e], y.w, acc[i][3]);
      }
    }
  }
}

// Reductions over the 16 lanes of a half-warp (one score row's owners).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int Tq, int Tk, int q_offset,
                  int k_offset, int prefix_len, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kTileFloats;
  float* vs = ks + kTileFloats;
  float* ps = vs + kTileFloats;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int num_q = (Tq + kTile - 1) / kTile;
  const int num_k = (Tk + kTile - 1) / kTile;
  const int qt = num_q - 1 - static_cast<int>(blockIdx.x);  // longest first
  const long bh = blockIdx.y;
  const int q0 = qt * kTile;
  const int nq = min(kTile, Tq - q0);
  load_tile(q + (bh * Tq + q0) * kDh, nq, qs);
  const int n_kt = kv_tiles(q_offset + q0 + nq - 1, k_offset, prefix_len, num_k);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    const int nk = min(kTile, Tk - k0);
    __syncthreads();  // the previous tile's reads of ks, vs, ps are done
    load_tile(k + (bh * Tk + k0) * kDh, nk, ks);
    load_tile(v + (bh * Tk + k0) * kDh, nk, vs);
    __syncthreads();
    float s[4][4];
    rows_dot_rows(qs, ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_offset + q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        ok[j] = kc < nk && visible(q_pos, k_offset + k0 + kc, prefix_len);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * kLd + tx + 16 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    rows_times_tile(ps, vs, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    const float l_safe = fmaxf(l[i], 1e-20f);
    *reinterpret_cast<float4*>(o + (bh * Tq + q0 + r) * kDh + 4 * tx) =
        make_float4(acc[i][0] / l_safe, acc[i][1] / l_safe,
                    acc[i][2] / l_safe, acc[i][3] / l_safe);
    if (tx == 0) lse[bh * Tq + q0 + r] = m[i] + logf(l_safe);
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int Tq, int Tk, int q_offset,
                 int k_offset, int prefix_len, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kTileFloats;
  float* ks = dos + kTileFloats;
  float* vs = ks + kTileFloats;
  float* dss = vs + kTileFloats;
  float* lse_s = dss + kTileFloats;
  float* delta_s = lse_s + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int num_q = (Tq + kTile - 1) / kTile;
  const int num_k = (Tk + kTile - 1) / kTile;
  const int qt = num_q - 1 - static_cast<int>(blockIdx.x);
  const long bh = blockIdx.y;
  const int q0 = qt * kTile;
  const int nq = min(kTile, Tq - q0);
  load_tile(q + (bh * Tq + q0) * kDh, nq, qs);
  load_tile(dout + (bh * Tq + q0) * kDh, nq, dos);
  load_rows(lse + bh * Tq + q0, nq, lse_s);
  load_rows(delta + bh * Tq + q0, nq, delta_s);
  const int n_kt = kv_tiles(q_offset + q0 + nq - 1, k_offset, prefix_len, num_k);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    const int nk = min(kTile, Tk - k0);
    __syncthreads();
    load_tile(k + (bh * Tk + k0) * kDh, nk, ks);
    load_tile(v + (bh * Tk + k0) * kDh, nk, vs);
    __syncthreads();
    float s[4][4], dp[4][4];
    rows_dot_rows(qs, ks, ty, tx, s);
    rows_dot_rows(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int q_pos = q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        const bool ok =
            kc < nk && visible(q_pos, k_offset + k0 + kc, prefix_len);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dss[r * kLd + kc] = p * (dp[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();
    rows_times_tile(dss, ks, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    *reinterpret_cast<float4*>(dq + (bh * Tq + q0 + r) * kDh + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int Tq, int Tk, int q_offset,
                  int k_offset, int prefix_len, float scale) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kTileFloats;
  float* qs = vs + kTileFloats;
  float* dos = qs + kTileFloats;
  float* pt = dos + kTileFloats;   // P^T: [key][query]
  float* dst = pt + kTileFloats;   // dS^T: [key][query]
  float* lse_s = dst + kTileFloats;
  float* delta_s = lse_s + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int num_q = (Tq + kTile - 1) / kTile;
  const int kt = blockIdx.x;  // early key tiles have the most query tiles
  const long bh = blockIdx.y;
  const int k0 = kt * kTile;
  const int nk = min(kTile, Tk - k0);
  load_tile(k + (bh * Tk + k0) * kDh, nk, ks);
  load_tile(v + (bh * Tk + k0) * kDh, nk, vs);
  const int start = first_q_tile(kt, q_offset, k_offset, prefix_len, num_q);

  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  for (int qt = start; qt < num_q; ++qt) {
    const int q0 = qt * kTile;
    const int nq = min(kTile, Tq - q0);
    __syncthreads();
    load_tile(q + (bh * Tq + q0) * kDh, nq, qs);
    load_tile(dout + (bh * Tq + q0) * kDh, nq, dos);
    load_rows(lse + bh * Tq + q0, nq, lse_s);
    load_rows(delta + bh * Tq + q0, nq, delta_s);
    __syncthreads();
    // scores with queries as rows (ty + 16 i) and keys as columns (tx + 16 j)
    float s[4][4], dp[4][4];
    rows_dot_rows(qs, ks, ty, tx, s);
    rows_dot_rows(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int q_pos = q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        const bool ok = r < nq && kc < nk &&
                        visible(q_pos, k_offset + k0 + kc, prefix_len);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        pt[kc * kLd + r] = p;
        dst[kc * kLd + r] = p * (dp[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();
    rows_times_tile(pt, dos, ty, tx, dv_acc);   // dV += P^T dO
    rows_times_tile(dst, qs, ty, tx, dk_acc);   // dK += dS^T Q
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nk) continue;
    const long off = (bh * Tk + k0 + r) * kDh + 4 * tx;
    *reinterpret_cast<float4*>(dk + off) =
        make_float4(dk_acc[i][0], dk_acc[i][1], dk_acc[i][2], dk_acc[i][3]);
    *reinterpret_cast<float4*>(dv + off) =
        make_float4(dv_acc[i][0], dv_acc[i][1], dv_acc[i][2], dv_acc[i][3]);
  }
}

// ===========================================================================
// Launchers
// ===========================================================================

// Shapes every launcher checks: head dim 64, a grid the card can hold.
cudaError_t check_shape(int BH, int Tq, int Tk, int dh) {
  if (dh != kDh || BH < 1 || BH > 65535 || Tq < 1 || Tk < 1)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Launch kernel on grid (tiles, BH) with `bytes` of dynamic shared memory
// (above 48 KB only after the opt-in).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int tiles, int BH, int threads, int bytes,
                   cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(tiles, BH), threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

constexpr int kF32Bytes = static_cast<int>(sizeof(float));
constexpr int kBf16Bytes = static_cast<int>(sizeof(bf16));

int tiles(int T) { return (T + kTile - 1) / kTile; }

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.

extern "C" int ddl_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int BH, int Tq, int Tk,
                             int dh, int q_offset, int k_offset,
                             int prefix_len, float scale, int dtype,
                             void* stream) {
  cudaError_t e = check_shape(BH, Tq, Tk, dh);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch(flash_fwd_f32, tiles(Tq), BH, kThreads,
                    4 * kTileFloats * kF32Bytes, s,
                    static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<float*>(o), lse,
                    Tq, Tk, q_offset, k_offset, prefix_len, scale);
    case 1:
      return launch(flash_fwd_mma, tiles(Tq), BH, kThreadsMma,
                    3 * kTileHalves * kBf16Bytes, s,
                    static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(o), lse,
                    Tq, Tk, q_offset, k_offset, prefix_len, scale);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int ddl_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dqp, int BH, int Tq,
                            int Tk, int dh, int q_offset, int k_offset,
                            int prefix_len, float scale, int dtype,
                            void* stream) {
  cudaError_t e = check_shape(BH, Tq, Tk, dh);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch(flash_dq_f32, tiles(Tq), BH, kThreads,
                    (5 * kTileFloats + 2 * kTile) * kF32Bytes, s,
                    static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(dout), lse, delta,
                    static_cast<float*>(dqp), Tq, Tk, q_offset, k_offset,
                    prefix_len, scale);
    case 1:
      return launch(flash_dq_mma, tiles(Tq), BH, kThreadsMma,
                    5 * kTileHalves * kBf16Bytes, s,
                    static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v),
                    static_cast<const bf16*>(dout), lse, delta,
                    static_cast<bf16*>(dqp), Tq, Tk, q_offset, k_offset,
                    prefix_len, scale);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int ddl_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dkp, void* dvp, int BH,
                             int Tq, int Tk, int dh, int q_offset,
                             int k_offset, int prefix_len, float scale,
                             int dtype, void* stream) {
  cudaError_t e = check_shape(BH, Tq, Tk, dh);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch(flash_dkv_f32, tiles(Tk), BH, kThreads,
                    (6 * kTileFloats + 2 * kTile) * kF32Bytes, s,
                    static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(dout), lse, delta,
                    static_cast<float*>(dkp), static_cast<float*>(dvp), Tq, Tk,
                    q_offset, k_offset, prefix_len, scale);
    case 1:
      return launch(flash_dkv_mma, tiles(Tk), BH, kThreadsMma,
                    4 * kTileHalves * kBf16Bytes + 2 * kTile * kF32Bytes, s,
                    static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v),
                    static_cast<const bf16*>(dout), lse, delta,
                    static_cast<bf16*>(dkp), static_cast<bf16*>(dvp), Tq, Tk,
                    q_offset, k_offset, prefix_len, scale);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ddl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
