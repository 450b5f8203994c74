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
// over), and rows past the end are read as zeros and never written. Shared
// memory per block is fixed whatever T is: the TPU's resident/streaming
// split is a VMEM artifact, and one streaming design serves every length.
//
// Bound: at the training shape (B 16, H 8, T 1024, dh 64, bf16, causal) one
// call must move its operands once (about 67 MB for the forward, 20 us at
// 3.35 TB/s) and do 4 (forward), 6 (dQ) or 8 (dK/dV) * dh flops per visible
// (query, key) pair (17 to 34 GFLOP, 17 to 35 us at the bf16 tensor-core
// rate of 989 TFLOP/s).
//
// bfloat16 builds (the training path), each bounded at lmbench's shape:
//
//   forward (flash_fwd_wgmma) <- _flash_fwd_impl. Bound by bytes: 0.0202
//   ms (Q, K, V read once, O and lse written once), the flops at 0.0174
//   ms. The mma.sync kernel it replaces took 0.2820-0.2856 ms. Design: a
//   Q-stationary sweep by a persistent grid, one block per SM walking the
//   (128-query tile, batch*head) items longest first; two consumer
//   warpgroups of 64 query rows and one producer warp. TMA loads each
//   item's Q tile (double-buffered, so the next item's Q arrives during the
//   current one) and streams 128-key K and V tiles through a 2-stage ring
//   of 32 KB stages (full/empty mbarriers), so loads run ahead of the
//   products. S = Q K^T is wgmma m64n128k16 from shared memory, both
//   operands K-major; the online softmax runs in registers in the exp2
//   domain (scores scaled once by scale * log2 e, ex2.approx), with the
//   mask evaluated only on tiles that need it (diagonal, tail, straddling
//   prefix_len). O += P V is wgmma m64n64k16 with P from registers (the S
//   accumulator packed to bf16 is the A fragment) and V as it lies,
//   MN-major through the transpose flag: no transposed copy.
//
//   dK/dV (flash_dkv_wgmma) <- _flash_bwd_core's second call. Bound by
//   operations: 0.0348 ms (8 x dh flops a visible pair). The mma.sync
//   kernel it replaces took 0.4410-0.4463 ms. Design: a KV-stationary sweep
//   by a persistent grid over (128-key tile, batch*head) items, early key
//   tiles (the most work) first; two consumer warpgroups of 64 keys and
//   one producer warp. TMA loads each item's K and V (double-buffered);
//   64-query Q and dO tiles stream through a 3-stage ring, the producer
//   warp writing their lse (times log2 e) and delta beside them. S^T = K
//   Q^T and dP^T = V dO^T are wgmma with both operands K-major as they lie
//   (P^T computed while dP^T runs); P^T and dS^T stay in registers and
//   feed dV += P^T dO and dK += dS^T Q as register A operands against dO
//   and Q MN-major: no transposed staging.
//
//   dQ (flash_dq_wgmma) <- _flash_bwd_core's first call. Bound by
//   operations: 0.0261 ms (6 x dh flops a visible pair). The mma.sync
//   kernel it replaces took 0.2638-0.2683 ms. Design: the mirror of
//   dK/dV, Q-stationary, on the forward's plumbing: persistent blocks over
//   (128-query tile, batch*head) items, longest first; two consumer
//   warpgroups of 64 query rows and one producer warp. TMA loads each
//   item's Q and dO tiles (double-buffered), the producer warp writing the
//   item's lse (times log2 e) and delta rows beside them; 64-key K and V
//   tiles stream through a 4-stage ring. S = Q K^T and dP = dO V^T are
//   wgmma with both operands K-major as they lie (P computed while dP
//   runs, the mask only on tiles that need it); dS stays in registers and
//   feeds dQ += dS K as the register A operand against K read MN-major, as
//   the forward's P V. dQ is written once, in bf16. No atomics: reruns are
//   bitwise equal (folding dQ into dK/dV's KV-stationary sweep would need
//   atomic adds in a varying order).
//
// All three use 3-D tensor maps over [B*H, T, 64] with the 128-byte
// swizzle, so a tail box reads zeros past T (never the next head's rows);
// those rows and columns are still masked, and rows past T are never
// written. Tensor maps are built on the host (cuTensorMapEncodeTiled via
// the runtime's driver entry point) and passed by value as
// __grid_constant__. The Hopper plumbing is in hopper.cuh.
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

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kDh = 64;    // head dim of every transformer variant
constexpr int kTile = 64;  // rows of a query tile, keys of a key tile
static_assert(kTile == kDh, "one row stride serves every 64 x 64 tile");

__device__ __forceinline__ bool visible(int q_pos, int k_pos, int prefix_len) {
  return q_pos >= k_pos || k_pos < prefix_len;
}

// Number of leading key tiles of `tile` keys a query at absolute position
// <= q_hi_pos can see (flash_attention.py _causal_kv_bound).
__device__ __forceinline__ int kv_tiles(int q_hi_pos, int k_offset,
                                        int prefix_len, int num_k,
                                        int tile = kTile) {
  int vis = q_hi_pos - k_offset + 1;
  if (prefix_len) vis = max(vis, prefix_len - k_offset);
  if (vis <= 0) return 0;
  return min((vis + tile - 1) / tile, num_k);
}

// First query tile of `tile` rows whose last row can see the key at
// absolute position k_lo, 0 when that key lies in the prefix
// (flash_attention.py :272-275).
__device__ __forceinline__ int first_q_tile(int k_lo, int q_offset,
                                            int prefix_len, int num_q,
                                            int tile = kTile) {
  if (prefix_len && k_lo < prefix_len) return 0;
  const int rel = k_lo - q_offset;
  if (rel <= 0) return 0;
  return min(rel / tile, num_q);
}

// ===========================================================================
// bfloat16: wgmma, TMA and an mbarrier ring
// ===========================================================================

using bf16 = __nv_bfloat16;

// Two floats as a bf16 pair, the first in the low half (the fragment order).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  unsigned u;
  memcpy(&u, &v, 4);
  return u;
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

using hopper::desc_sw128;
using hopper::fence_regs;
using hopper::kKMajorStep;
using hopper::kMnMajorStep;

// depth of the streamed-tile rings: a third stage sped dK/dV up 2-9 % and
// the forward 2 % at T 1024 but slowed it 4 % at T 8192
constexpr int kFwdStages = 2;
constexpr int kDkvStages = 3;
constexpr int kConsumers = 256;      // two warpgroups
constexpr int kThreadsWs = kConsumers + 32;  // and one producer warp
constexpr int kRowBytes = kDh * 2;   // one bf16 row: 128 bytes, one swizzle row
constexpr int kBM = 128;             // forward: query rows of a block
constexpr int kBN = 128;             // forward: keys of a streamed K/V tile
constexpr int kBK = 128;             // dK/dV: keys of a block
constexpr int kBQ = 64;              // dK/dV: queries of a streamed Q/dO tile
// dQ: keys of a streamed K/V tile (128 spilled and was slower) and the
// tiles in flight (2 and 6 were slower at T 1024)
constexpr int kDqBN = 64;
constexpr int kDqStages = 4;
static_assert(kDqBN == 64, "dQ's score tiles are m64n64 products");
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf2 = kNegInf * kLog2e;  // the mask value, exp2 domain

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

// Write the rows of a 64 x 64 accumulator (this thread's rows r0 and
// r0 + 8 of out, those below n_rows), times mul[h], as bf16.
__device__ __forceinline__ void store_acc(const float (&acc)[32],
                                          const float (&mul)[2], int r0,
                                          int n_rows, int t,
                                          bf16* __restrict__ out) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<unsigned*>(out + static_cast<long>(r) * kDh + 8 * j +
                                   2 * t) =
          pack_bf16(acc[4 * j + 2 * h] * mul[h],
                    acc[4 * j + 2 * h + 1] * mul[h]);
  }
}

// Shared memory: two Q tiles (one per work item in flight), kFwdStages K
// tiles and kFwdStages V tiles (128 rows each, 16 KB), then the barriers;
// 1 KB of alignment slack.
constexpr int kFwdTile = kBN * kRowBytes;
constexpr int kFwdSmem = (2 + 2 * kFwdStages) * kFwdTile +
                         (4 + 2 * kFwdStages) * 8 + 1024;

// 2^x on the special-function unit, results below 2^-126 flushed to 0 (a
// probability that small is 0 in bf16 and in the row sum).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Persistent: gridDim.x blocks (at most one per SM) walk the work items
// (128-query tile, batch*head), longest tiles first, item w going to block
// w % gridDim.x. The producer loads the next item's Q tile and first K/V
// tiles while the consumers finish the current one.
__global__ void __launch_bounds__(kThreadsWs, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    bf16* __restrict__ o, float* __restrict__ lse, int BH,
                    int Tq, int Tk, int q_offset, int k_offset,
                    int prefix_len, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);  // 2 tiles
  bf16* ks = reinterpret_cast<bf16*>(smem + 2 * kFwdTile);
  bf16* vs = reinterpret_cast<bf16*>(smem + (2 + kFwdStages) * kFwdTile);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + (2 + 2 * kFwdStages) *
                                                            kFwdTile);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + kFwdStages;

  const int num_q = (Tq + kBM - 1) / kBM;
  const int num_k = (Tk + kBN - 1) / kBN;
  const int items = num_q * BH;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      hopper::mbar_init(&q_full[b], 1);
      hopper::mbar_init(&q_empty[b], kConsumers);
    }
    for (int s = 0; s < kFwdStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp: one lane issues TMA
    if (threadIdx.x == kConsumers) {
      int step = 0;  // K/V tiles loaded so far, over every item
      for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
        const int q0 = (num_q - 1 - w / BH) * kBM, bh = w % BH;
        const int b = n & 1;
        hopper::mbar_wait(&q_empty[b], ((n >> 1) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&q_full[b], kBM * kRowBytes);
        hopper::tma_load_3d(qs + b * kBM * kDh, &tm_q, &q_full[b], 0, q0, bh);
        const int n_kt = kv_tiles(q_offset + min(q0 + kBM, Tq) - 1, k_offset,
                                  prefix_len, num_k, kBN);
        for (int kt = 0; kt < n_kt; ++kt, ++step) {
          const int s = step % kFwdStages;
          hopper::mbar_wait(&empty[s], ((step / kFwdStages) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], 2 * kFwdTile);
          hopper::tma_load_3d(ks + s * kBN * kDh, &tm_k, &full[s], 0,
                              kt * kBN, bh);
          hopper::tma_load_3d(vs + s * kBN * kDh, &tm_v, &full[s], 0,
                              kt * kBN, bh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows qw0 .. qw0 + 63 of an item
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float c = scale * kLog2e;
  int step = 0;
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
    const int q0 = (num_q - 1 - w / BH) * kBM, bh = w % BH;
    const int b = n & 1;
    const int n_kt = kv_tiles(q_offset + min(q0 + kBM, Tq) - 1, k_offset,
                              prefix_len, num_k, kBN);
    const int qw0 = q0 + 64 * wg;
    const int r0 = qw0 + 16 * warp + g;  // this thread's rows: r0, r0 + 8
    const int wg_kt = qw0 < Tq ? kv_tiles(q_offset + min(qw0 + 64, Tq) - 1,
                                          k_offset, prefix_len, num_k, kBN)
                               : 0;
    const uint64_t q_desc = desc_sw128(qs + (b * kBM + 64 * wg) * kDh);

    float m[2] = {kNegInf2, kNegInf2}, l[2] = {0.f, 0.f}, acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    hopper::mbar_wait(&q_full[b], (n >> 1) & 1);
    for (int kt = 0; kt < n_kt; ++kt, ++step) {
      const int s = step % kFwdStages;
      hopper::mbar_wait(&full[s], (step / kFwdStages) & 1);
      if (kt < wg_kt) {  // uniform over the warpgroup
        const int k0 = kt * kBN;
        float sc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] = 0.f;
        const uint64_t k_desc = desc_sw128(ks + s * kBN * kDh);
        fence_regs(sc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_m64n128k16_ss(sc, q_desc + kk * kKMajorStep,
                                      k_desc + kk * kKMajorStep, kk);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        fence_regs(sc);

        // every key of the tile visible to every row of the warpgroup?
        const int k_hi = k_offset + k0 + kBN - 1;
        const bool open = k0 + kBN <= Tk &&
                          (q_offset + qw0 >= k_hi || k_hi < prefix_len);
        float mx[2] = {kNegInf2, kNegInf2};
        if (open) {  // the max of the raw scores, scaled once (c > 0)
#pragma unroll
          for (int i = 0; i < 64; ++i)
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
          mx[0] *= c;
          mx[1] *= c;
        } else {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int h = (i >> 1) & 1, kc = 8 * (i >> 2) + 2 * t + (i & 1);
            const bool vis = k0 + kc < Tk &&
                             visible(q_offset + r0 + 8 * h, k_offset + k0 + kc,
                                     prefix_len);
            sc[i] = vis ? sc[i] * c : kNegInf2;
            mx[h] = fmaxf(mx[h], sc[i]);
          }
        }
        float corr[2], base[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float m_new = fmaxf(m[h], quad_max(mx[h]));
          corr[h] = exp2_ftz(m[h] - m_new);
          m[h] = m_new;
          // a row with nothing visible yet: every score is the mask value,
          // and exp2(mask - 0) = 0 keeps its p at 0
          base[h] = m_new == kNegInf2 ? 0.f : m_new;
        }
        if (open) {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int h = (i >> 1) & 1;
            sc[i] = exp2_ftz(fmaf(sc[i], c, -base[h]));
            sum[h] += sc[i];
          }
        } else {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int h = (i >> 1) & 1;
            sc[i] = exp2_ftz(sc[i] - base[h]);
            sum[h] += sc[i];
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] *= corr[(i >> 1) & 1];

        uint32_t pa[8][4];  // P as bf16 A fragments
        pack_a<8>(sc, pa);
        const uint64_t v_desc = desc_sw128(vs + s * kBN * kDh);
        fence_regs(acc);
        fence_regs(pa);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          hopper::wgmma_m64n64k16_rs<1>(acc, pa[kk],
                                         v_desc + kk * kMnMajorStep);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
      }
      hopper::mbar_arrive(&empty[s]);
    }
    hopper::mbar_arrive(&q_empty[b]);  // this item's S products are done

    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float l_safe = fmaxf(quad_sum(l[h]), 1e-20f);
      inv[h] = 1.f / l_safe;
      const int r = r0 + 8 * h;
      if (t == 0 && r < Tq)
        lse[static_cast<long>(bh) * Tq + r] = m[h] * kLn2 + logf(l_safe);
    }
    store_acc(acc, inv, r0, Tq, t, o + static_cast<long>(bh) * Tq * kDh);
  }
}

// Shared memory: two K and two V tiles (128 rows; one pair per work item
// in flight), kDkvStages Q and kDkvStages dO tiles (64 rows), kDkvStages
// rows of lse * log2 e and of delta, the barriers.
constexpr int kDkvKvTile = kBK * kRowBytes;
constexpr int kDkvQTile = kBQ * kRowBytes;
constexpr int kDkvSmem = 4 * kDkvKvTile + 2 * kDkvStages * kDkvQTile +
                         2 * kDkvStages * kBQ * 4 + (4 + 2 * kDkvStages) * 8 +
                         1024;

// Persistent like the forward: blocks walk the work items (128-key tile,
// batch*head), the early key tiles (the most query tiles) first.
__global__ void __launch_bounds__(kThreadsWs, 1)
    flash_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int BH, int Tq, int Tk,
                    int q_offset, int k_offset, int prefix_len, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  bf16* ks = reinterpret_cast<bf16*>(smem);  // 2 tiles
  bf16* vs = reinterpret_cast<bf16*>(smem + 2 * kDkvKvTile);  // 2 tiles
  bf16* qs = reinterpret_cast<bf16*>(smem + 4 * kDkvKvTile);
  bf16* dos = qs + kDkvStages * kBQ * kDh;
  float* lse_s = reinterpret_cast<float*>(smem + 4 * kDkvKvTile +
                                          2 * kDkvStages * kDkvQTile);
  float* delta_s = lse_s + kDkvStages * kBQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(delta_s + kDkvStages * kBQ);
  uint64_t* kv_empty = kv_full + 2;
  uint64_t* full = kv_empty + 2;
  uint64_t* empty = full + kDkvStages;

  const int num_q = (Tq + kBQ - 1) / kBQ;
  const int items = ((Tk + kBK - 1) / kBK) * BH;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      hopper::mbar_init(&kv_full[b], 1);
      hopper::mbar_init(&kv_empty[b], kConsumers);
    }
    for (int s = 0; s < kDkvStages; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp's lanes
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp
    const int lane = threadIdx.x - kConsumers;
    int step = 0;  // Q/dO tiles loaded so far, over every item
    for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
      const int k0 = (w / BH) * kBK, bh = w % BH;
      const int b = n & 1;
      if (lane == 0) {
        hopper::mbar_wait(&kv_empty[b], ((n >> 1) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&kv_full[b], 2 * kDkvKvTile);
        hopper::tma_load_3d(ks + b * kBK * kDh, &tm_k, &kv_full[b], 0, k0, bh);
        hopper::tma_load_3d(vs + b * kBK * kDh, &tm_v, &kv_full[b], 0, k0, bh);
      }
      const int start = first_q_tile(k_offset + k0, q_offset, prefix_len,
                                     num_q, kBQ);
      for (int qt = start; qt < num_q; ++qt, ++step) {
        const int s = step % kDkvStages;
        const int q0 = qt * kBQ;
        hopper::mbar_wait(&empty[s], ((step / kDkvStages) & 1) ^ 1);
        // each lane writes 2 of the tile's lse and delta rows, 0 past Tq;
        // its arrival below publishes them
        for (int r = lane; r < kBQ; r += 32) {
          const bool in = q0 + r < Tq;
          const long at = static_cast<long>(bh) * Tq + q0 + r;
          lse_s[s * kBQ + r] = in ? lse[at] * kLog2e : 0.f;
          delta_s[s * kBQ + r] = in ? delta[at] : 0.f;
        }
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(&full[s], 2 * kDkvQTile);
          hopper::tma_load_3d(qs + s * kBQ * kDh, &tm_q, &full[s], 0, q0, bh);
          hopper::tma_load_3d(dos + s * kBQ * kDh, &tm_do, &full[s], 0, q0,
                              bh);
        } else {
          hopper::mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys kw0 .. kw0 + 63 of an item
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float c = scale * kLog2e;
  int step = 0;
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
    const int k0 = (w / BH) * kBK, bh = w % BH;
    const int b = n & 1;
    const int start = first_q_tile(k_offset + k0, q_offset, prefix_len, num_q,
                                   kBQ);
    const int kw0 = k0 + 64 * wg;
    const int r0 = kw0 + 16 * warp + g;  // this thread's keys: r0, r0 + 8
    const int wg_start = kw0 < Tk ? first_q_tile(k_offset + kw0, q_offset,
                                                 prefix_len, num_q, kBQ)
                                  : num_q;
    const int k_hi = k_offset + kw0 + 63;  // the warpgroup's last key
    const uint64_t k_desc = desc_sw128(ks + (b * kBK + 64 * wg) * kDh);
    const uint64_t v_desc = desc_sw128(vs + (b * kBK + 64 * wg) * kDh);

    float dk_acc[32], dv_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    hopper::mbar_wait(&kv_full[b], (n >> 1) & 1);
    for (int qt = start; qt < num_q; ++qt, ++step) {
      const int s = step % kDkvStages;
      hopper::mbar_wait(&full[s], (step / kDkvStages) & 1);
      if (qt >= wg_start) {  // uniform over the warpgroup
        const int q0 = qt * kBQ;
        const uint64_t q_desc = desc_sw128(qs + s * kBQ * kDh);
        const uint64_t do_desc = desc_sw128(dos + s * kBQ * kDh);
        const float* lse2 = lse_s + s * kBQ;
        const float* dl = delta_s + s * kBQ;
        // transposed scores: this warpgroup's keys as rows, queries as
        // columns
        float st[32], dpt[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
        fence_regs(st);
        fence_regs(dpt);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_m64n64k16_ss<0, 0>(st, k_desc + kk * kKMajorStep,
                                           q_desc + kk * kKMajorStep, kk);
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_m64n64k16_ss<0, 0>(
              dpt, v_desc + kk * kKMajorStep, do_desc + kk * kKMajorStep, kk);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // S^T is in; dP^T may still run
        fence_regs(st);

        // every (key, query) pair of the tile visible and inside both ends?
        const bool open = q0 + kBQ <= Tq && kw0 + 64 <= Tk &&
                          (q_offset + q0 >= k_hi || k_hi < prefix_len);
        if (open) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int qc = 8 * (i >> 2) + 2 * t + (i & 1);
            st[i] = exp2_ftz(fmaf(st[i], c, -lse2[qc]));
          }
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int kr = r0 + 8 * ((i >> 1) & 1);
            const int qc = 8 * (i >> 2) + 2 * t + (i & 1);
            const bool vis = q0 + qc < Tq && kr < Tk &&
                             visible(q_offset + q0 + qc, k_offset + kr,
                                     prefix_len);
            st[i] = vis ? exp2_ftz(fmaf(st[i], c, -lse2[qc])) : 0.f;  // P^T
          }
        }
        hopper::wgmma_wait<0>();
        fence_regs(dpt);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qc = 8 * (i >> 2) + 2 * t + (i & 1);
          dpt[i] = st[i] * (dpt[i] - dl[qc]) * scale;  // dS^T
        }
        uint32_t pa[4][4], da[4][4];
        pack_a<4>(st, pa);
        pack_a<4>(dpt, da);
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pa);
        fence_regs(da);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dV += P^T dO
          hopper::wgmma_m64n64k16_rs<1>(dv_acc, pa[kk],
                                         do_desc + kk * kMnMajorStep);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dK += dS^T Q
          hopper::wgmma_m64n64k16_rs<1>(dk_acc, da[kk],
                                         q_desc + kk * kMnMajorStep);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pa);
        fence_regs(da);
      }
      hopper::mbar_arrive(&empty[s]);
    }
    hopper::mbar_arrive(&kv_empty[b]);  // this item's K and V reads are done
    const float one[2] = {1.f, 1.f};
    store_acc(dk_acc, one, r0, Tk, t, dk + static_cast<long>(bh) * Tk * kDh);
    store_acc(dv_acc, one, r0, Tk, t, dv + static_cast<long>(bh) * Tk * kDh);
  }
}

// Shared memory: two Q and two dO tiles (128 rows; one pair per work item
// in flight), their rows of lse * log2 e and of delta, kDqStages K and
// kDqStages V tiles (kDqBN keys), the barriers.
constexpr int kDqQTile = kBM * kRowBytes;
constexpr int kDqKvTile = kDqBN * kRowBytes;
constexpr int kDqSmem = 4 * kDqQTile + 2 * kDqStages * kDqKvTile +
                        4 * kBM * 4 + (4 + 2 * kDqStages) * 8 + 1024;

// Q-stationary, the mirror of flash_dkv_wgmma: persistent blocks walk the
// work items (128-query tile, batch*head) longest first, as the forward
// does. The producer warp loads each item's Q and dO tiles (double-
// buffered) and writes their lse (times log2 e) and delta rows beside
// them; K and V tiles of kDqBN keys stream through a kDqStages ring.
__global__ void __launch_bounds__(kThreadsWs, 1)
    flash_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int BH, int Tq, int Tk, int q_offset, int k_offset,
                   int prefix_len, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);                  // 2 tiles
  bf16* dos = reinterpret_cast<bf16*>(smem + 2 * kDqQTile);  // 2 tiles
  bf16* ks = reinterpret_cast<bf16*>(smem + 4 * kDqQTile);
  bf16* vs = ks + kDqStages * kDqBN * kDh;
  float* lse_s = reinterpret_cast<float*>(smem + 4 * kDqQTile +
                                          2 * kDqStages * kDqKvTile);
  float* delta_s = lse_s + 2 * kBM;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(delta_s + 2 * kBM);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + kDqStages;

  const int num_q = (Tq + kBM - 1) / kBM;
  const int num_k = (Tk + kDqBN - 1) / kDqBN;
  const int items = num_q * BH;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      hopper::mbar_init(&q_full[b], 32);  // the producer warp's lanes
      hopper::mbar_init(&q_empty[b], kConsumers);
    }
    for (int s = 0; s < kDqStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp
    const int lane = threadIdx.x - kConsumers;
    int step = 0;  // K/V tiles loaded so far, over every item (lane 0)
    for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
      const int q0 = (num_q - 1 - w / BH) * kBM, bh = w % BH;
      const int b = n & 1;
      hopper::mbar_wait(&q_empty[b], ((n >> 1) & 1) ^ 1);
      // each lane writes 4 of the item's lse and delta rows, 0 past Tq;
      // its arrival below publishes them
      for (int r = lane; r < kBM; r += 32) {
        const bool in = q0 + r < Tq;
        const long at = static_cast<long>(bh) * Tq + q0 + r;
        lse_s[b * kBM + r] = in ? lse[at] * kLog2e : 0.f;
        delta_s[b * kBM + r] = in ? delta[at] : 0.f;
      }
      if (lane != 0) {
        hopper::mbar_arrive(&q_full[b]);
        continue;
      }
      hopper::mbar_arrive_expect_tx(&q_full[b], 2 * kDqQTile);
      hopper::tma_load_3d(qs + b * kBM * kDh, &tm_q, &q_full[b], 0, q0, bh);
      hopper::tma_load_3d(dos + b * kBM * kDh, &tm_do, &q_full[b], 0, q0,
                          bh);
      const int n_kt = kv_tiles(q_offset + min(q0 + kBM, Tq) - 1, k_offset,
                                prefix_len, num_k, kDqBN);
      for (int kt = 0; kt < n_kt; ++kt, ++step) {
        const int s = step % kDqStages;
        hopper::mbar_wait(&empty[s], ((step / kDqStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * kDqKvTile);
        hopper::tma_load_3d(ks + s * kDqBN * kDh, &tm_k, &full[s], 0,
                            kt * kDqBN, bh);
        hopper::tma_load_3d(vs + s * kDqBN * kDh, &tm_v, &full[s], 0,
                            kt * kDqBN, bh);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows qw0 .. qw0 + 63 of an item
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float c = scale * kLog2e;
  int step = 0;
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
    const int q0 = (num_q - 1 - w / BH) * kBM, bh = w % BH;
    const int b = n & 1;
    const int n_kt = kv_tiles(q_offset + min(q0 + kBM, Tq) - 1, k_offset,
                              prefix_len, num_k, kDqBN);
    const int qw0 = q0 + 64 * wg;
    const int r0 = qw0 + 16 * warp + g;  // this thread's rows: r0, r0 + 8
    const int wg_kt = qw0 < Tq ? kv_tiles(q_offset + min(qw0 + 64, Tq) - 1,
                                          k_offset, prefix_len, num_k, kDqBN)
                               : 0;
    const uint64_t q_desc = desc_sw128(qs + (b * kBM + 64 * wg) * kDh);
    const uint64_t do_desc = desc_sw128(dos + (b * kBM + 64 * wg) * kDh);

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    hopper::mbar_wait(&q_full[b], (n >> 1) & 1);
    float lse2[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse2[h] = lse_s[b * kBM + r0 - q0 + 8 * h];
      dl[h] = delta_s[b * kBM + r0 - q0 + 8 * h];
    }
    for (int kt = 0; kt < n_kt; ++kt, ++step) {
      const int s = step % kDqStages;
      hopper::mbar_wait(&full[s], (step / kDqStages) & 1);
      if (kt < wg_kt) {  // uniform over the warpgroup
        const int k0 = kt * kDqBN;
        const uint64_t k_desc = desc_sw128(ks + s * kDqBN * kDh);
        const uint64_t v_desc = desc_sw128(vs + s * kDqBN * kDh);
        float sc[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
        fence_regs(sc);
        fence_regs(dp);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // S = Q K^T
          hopper::wgmma_m64n64k16_ss<0, 0>(sc, q_desc + kk * kKMajorStep,
                                           k_desc + kk * kKMajorStep, kk);
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dP = dO V^T
          hopper::wgmma_m64n64k16_ss<0, 0>(dp, do_desc + kk * kKMajorStep,
                                           v_desc + kk * kKMajorStep, kk);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // S is in; dP may still run
        fence_regs(sc);

        // every key of the tile visible to every row of the warpgroup?
        const int k_hi = k_offset + k0 + kDqBN - 1;
        const bool open = k0 + kDqBN <= Tk &&
                          (q_offset + qw0 >= k_hi || k_hi < prefix_len);
        if (open) {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            sc[i] = exp2_ftz(fmaf(sc[i], c, -lse2[(i >> 1) & 1]));
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int h = (i >> 1) & 1, kc = 8 * (i >> 2) + 2 * t + (i & 1);
            const bool vis = k0 + kc < Tk &&
                             visible(q_offset + r0 + 8 * h,
                                     k_offset + k0 + kc, prefix_len);
            sc[i] = vis ? exp2_ftz(fmaf(sc[i], c, -lse2[h])) : 0.f;  // P
          }
        }
        hopper::wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i)  // dS
          dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]) * scale;
        uint32_t da[4][4];
        pack_a<4>(dp, da);
        fence_regs(acc);
        fence_regs(da);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dQ += dS K
          hopper::wgmma_m64n64k16_rs<1>(acc, da[kk],
                                         k_desc + kk * kMnMajorStep);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(da);
      }
      hopper::mbar_arrive(&empty[s]);
    }
    hopper::mbar_arrive(&q_empty[b]);  // this item's Q and dO reads are done
    const float one[2] = {1.f, 1.f};
    store_acc(acc, one, r0, Tq, t, dq + static_cast<long>(bh) * Tq * kDh);
  }
}

// One 64 x 64 x 64 product in each operand form the kernels use, for the
// card tests: mode 0, c = a b^T with a and b from shared memory, both
// K-major (the score products); mode 1, c = a b with a from registers and
// b MN-major (the P V-shaped products). One warpgroup; a, b bf16 [64, 64]
// row-major, c float32 [64, 64].
__global__ void __launch_bounds__(128)
    wgmma_tile_test(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_b,
                    const bf16* __restrict__ a, float* __restrict__ c,
                    int mode) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = reinterpret_cast<bf16*>(smem + 64 * kRowBytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 128 * kRowBytes);
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_arrive_expect_tx(bar, 128 * kRowBytes);
    hopper::tma_load_3d(as, &tm_a, bar, 0, 0, 0);
    hopper::tma_load_3d(bs, &tm_b, bar, 0, 0, 0);
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
          a + (r0 + 8 * (r & 1)) * kDh + 16 * kk + 8 * (r >> 1) + 2 * t);
  const uint64_t a_desc = desc_sw128(as), b_desc = desc_sw128(bs);
  fence_regs(d);
  fence_regs(fa);
  hopper::wgmma_fence();
  if (mode == 0) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_m64n64k16_ss<0, 0>(d, a_desc + kk * kKMajorStep,
                                       b_desc + kk * kKMajorStep, 1);
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_m64n64k16_rs<1>(d, fa[kk], b_desc + kk * kMnMajorStep);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  fence_regs(d);
  fence_regs(fa);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    c[(r0 + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + 2 * t + (i & 1)] = d[i];
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
  const int start = first_q_tile(k_offset + k0, q_offset, prefix_len, num_q);

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

int tiles(int T, int tile = kTile) { return (T + tile - 1) / tile; }

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

// Tensor maps over bf16 [BH, T, 64] tensors: `maps[i]` over ptrs[i] with
// T = rows[i] and boxes of box[i] rows.
template <int N>
cudaError_t row_maps(CUtensorMap (&maps)[N], const void* const (&ptrs)[N],
                     const int (&rows)[N], const int (&box)[N], int BH) {
  for (int i = 0; i < N; ++i) {
    const cudaError_t e =
        hopper::bf16_rows_map(&maps[i], ptrs[i], BH, rows[i], box[i]);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

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
    case 1: {
      CUtensorMap m[3];
      e = row_maps<3>(m, {q, k, v}, {Tq, Tk, Tk}, {kBM, kBN, kBN}, BH);
      if (e != cudaSuccess) return e;
      return launch(flash_fwd_wgmma, persistent_blocks(tiles(Tq, kBM) * BH),
                    1, kThreadsWs, kFwdSmem, s, m[0], m[1], m[2],
                    static_cast<bf16*>(o), lse, BH, Tq, Tk, q_offset,
                    k_offset, prefix_len, scale);
    }
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
    case 1: {
      CUtensorMap m[4];
      e = row_maps<4>(m, {q, k, v, dout}, {Tq, Tk, Tk, Tq},
                      {kBM, kDqBN, kDqBN, kBM}, BH);
      if (e != cudaSuccess) return e;
      return launch(flash_dq_wgmma, persistent_blocks(tiles(Tq, kBM) * BH), 1,
                    kThreadsWs, kDqSmem, s, m[0], m[1], m[2], m[3], lse, delta,
                    static_cast<bf16*>(dqp), BH, Tq, Tk, q_offset, k_offset,
                    prefix_len, scale);
    }
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
    case 1: {
      CUtensorMap m[4];
      e = row_maps<4>(m, {q, k, v, dout}, {Tq, Tk, Tk, Tq},
                      {kBQ, kBK, kBK, kBQ}, BH);
      if (e != cudaSuccess) return e;
      return launch(flash_dkv_wgmma, persistent_blocks(tiles(Tk, kBK) * BH),
                    1, kThreadsWs, kDkvSmem, s, m[0], m[1], m[2], m[3], lse,
                    delta, static_cast<bf16*>(dkp), static_cast<bf16*>(dvp),
                    BH, Tq, Tk, q_offset, k_offset, prefix_len, scale);
    }
    default:
      return cudaErrorInvalidValue;
  }
}

// The card tests' check of the two wgmma operand forms: c [64, 64] float32
// from a, b bf16 [64, 64] (mode 0: a b^T, mode 1: a b).
extern "C" int ddl_wgmma_tile_test(const void* a, const void* b, float* c,
                                   int mode, void* stream) {
  CUtensorMap m[2];
  cudaError_t e = row_maps<2>(m, {a, b}, {64, 64}, {64, 64}, 1);
  if (e != cudaSuccess) return e;
  return launch(wgmma_tile_test, 1, 1, 128, 128 * kRowBytes + 8 + 1024,
                static_cast<cudaStream_t>(stream), m[0], m[1],
                static_cast<const bf16*>(a), c, mode);
}

extern "C" const char* ddl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
