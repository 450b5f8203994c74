// Paged attention over a shared KV pool, for Hopper (sm_90a).
//
// Two kernels, each replacing a Pallas TPU kernel of the JAX package:
//
//   paged_decode_kernel  <- ddlbench_tpu/ops/paged_decode.py
//                           _paged_attn_kernel (:318), launched by
//                           paged_attention (:361): single-query
//                           flash-decode, one query per (row, head) at
//                           position pos[r].
//   paged_chunk_kernel   <- _paged_chunk_attn_kernel (:703), launched by
//                           paged_chunk_attention (:768): C chunk queries
//                           per row at absolute positions start[r] + c.
//
// Both compute an online softmax over the row's live pages, reached through
// the page table: pool[table[r, j]] holds positions [j*page, (j+1)*page).
// The TPU grid (rows, pages) carried m/l/acc in VMEM across its sequential
// page axis; Hopper runs blocks in no order, so the page walk is a loop
// inside one block, and each block reads table[r, j] and pos/start[r]
// itself (this replaces scalar prefetch).
//
// Bound: memory. A call must read each distinct live page's K and V once
// (distinct slots x page x H x dh x 2 x sizeof(KT)). The serving slice's
// pool has 64 slots, one of them scratch, so a decode call reads at most
// 63 distinct pages of 64 KiB (f32, page 16, H 8, dh 64): 4.1 MB per
// layer, about 1.2 us at 3.35 TB/s. The arithmetic is two dot products per
// (query, key), far below the card's rate at one query per row, so the
// design is about keeping loads in flight, not about wgmma.
//
// Design (simple, not yet fast): one block per query, i.e. per (row, head)
// for decode and per (row, head, c) for a chunk; the chunk's queries of one
// row re-read the same pages, which the L2 cache serves. The block's
// kWarps warps split the live pages (warp w takes pages w, w + kWarps, ...)
// with an online-softmax state each, merged at the end. A warp folds
// kKeys = 16 keys of a page at a time with two lanes per key: lane
// (key, half) dots half of the head dim (vector loads of one key row's
// half), one shuffle adds the halves, and four shuffles give the keys' max
// and sum. For P.V each lane owns dh/32 adjacent output dims and walks the
// 16 keys with independent, coalesced V-row loads. No TMA, cp.async or
// wgmma yet (later work). The loop stops at the last page the query can
// see: later pages are fully masked and contribute exactly zero.
//
// Types: the pool element type KT is float, __nv_bfloat16 or int8_t; the
// query and output are float (the serving model runs in float32), and
// everything accumulates in float32. The mask value is -1e30 (not -inf),
// and the output is acc / max(l, 1e-20), as in the TPU kernels
// (paged_decode.py:329-358). Head dim 64, that of every transformer variant.
//
// The int8 pool (dtype code 2) replaces the int8 branches of the same two
// TPU kernels (paged_decode.py:323-340 and :714-731, scale blocks :398-402
// and :805-809): each key and value row is dequantised as it is loaded,
// k[d] = float(int8) * scale_k[slot * page + p] (the same for v), before
// the dot product or the P.V update uses it: the TPU kernels' arithmetic.
// The sidecars are [n_pages, page] float32, read one scale per key row by
// the row's lane (a shuffle hands the V scales to every lane); only slots
// of the row's live pages are read. An int8 page is a quarter of the f32
// page's bytes, plus 2 x page x 4 bytes of scales: the bound drops about
// 4x, and the kernel's loads are 32-byte key halves and 2-byte value
// pairs, which this simple design does not coalesce better (later work).
// Masked keys inside the last visible page (stale rejected-draft bytes, or
// zero scales) dequantise to finite values and weigh exp(-1e30 - m) = 0.
//
// Plain C interface, bound with ctypes: each launcher returns
// cudaGetLastError() and launches on the stream it is given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarps = 8;  // warps of one block, splitting the pages
constexpr int kKeys = 16;  // keys a warp folds at once (two lanes each)
constexpr int kDh = 64;    // head dim of every transformer variant

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// N consecutive elements at p (aligned to their byte size, 2 to 16) as
// float, in vector loads of up to 16 bytes.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  constexpr int kChunk = kBytes >= 16 ? 16 : kBytes;
  constexpr int kPer = kChunk / static_cast<int>(sizeof(T));
  static_assert(kBytes % kChunk == 0, "vector width");
#pragma unroll
  for (int i = 0; i < kBytes / kChunk; ++i) {
    T e[kPer];
    if constexpr (kChunk == 16) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      memcpy(e, &u, 16);
    } else if constexpr (kChunk == 8) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[i];
      memcpy(e, &u, 8);
    } else if constexpr (kChunk == 4) {
      const unsigned u = reinterpret_cast<const unsigned*>(p)[i];
      memcpy(e, &u, 4);
    } else {
      // an int8 lane's two value dims
      static_assert(kChunk == 2, "vector width");
      const unsigned short u = reinterpret_cast<const unsigned short*>(p)[i];
      memcpy(e, &u, 2);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) out[i * kPer + k] = to_f32(e[k]);
  }
}

// One query (q: dh elements, at stream position qpos) against pages
// [0, n_live) of one table row, for one head; writes dh outputs to o.
// Key row p of the page in slot s starts at pool + ((s * page + p) * H + h)
// * kDh; on an int8 pool its scale is sk[s * page + p] (and sv[...] for
// the value row). Shared memory: kWarps * (kDh + 2) floats.
template <typename KT>
__device__ __forceinline__ void attend(const float* __restrict__ q,
                                       const KT* __restrict__ pool_k,
                                       const KT* __restrict__ pool_v,
                                       const float* __restrict__ sk,
                                       const float* __restrict__ sv,
                                       const int* __restrict__ trow, int H,
                                       int h, int page, int n_live, int qpos,
                                       float scale, float* __restrict__ o,
                                       float* smem) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int kHalf = kDh / 2;  // dims one lane dots per key
  constexpr int kOwn = kDh / 32;  // output dims one lane owns
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int key = lane & (kKeys - 1);
  const int half = lane >> 4;
  const long stride = static_cast<long>(H) * kDh;  // between key rows

  float qv[kHalf];
  load_vec<float, kHalf>(q + half * kHalf, qv);
  float m = kNegInf, l = 0.f;
  float acc[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) acc[i] = 0.f;

  for (int j = warp; j < n_live; j += kWarps) {
    const long slot_row = static_cast<long>(trow[j]) * page;  // sidecar row
    const long page_base = (slot_row * H + h) * kDh;
    for (int p0 = 0; p0 < page; p0 += kKeys) {
      const int n_keys = min(kKeys, page - p0);
      const long base = page_base + p0 * stride;
      // scores: lane (key, half) dots its half of the key row
      float s = 0.f;
      float vscale = 1.f;  // lane `key`'s value-row scale (int8 pools)
      if (key < n_keys) {
        float kv[kHalf];
        load_vec<KT, kHalf>(pool_k + base + key * stride + half * kHalf, kv);
        if constexpr (kQuant) {
          const float ks = sk[slot_row + p0 + key];
          vscale = sv[slot_row + p0 + key];
#pragma unroll
          for (int d = 0; d < kHalf; ++d) kv[d] *= ks;
        }
#pragma unroll
        for (int d = 0; d < kHalf; ++d) s += qv[d] * kv[d];
      }
      s += __shfl_xor_sync(kFullMask, s, 16);
      const int kpos = j * page + p0 + key;
      s = (key < n_keys && kpos <= qpos) ? s * scale : kNegInf;
      // the 16 keys' max and sum (each value sits in both halves)
      float m_blk = s;
#pragma unroll
      for (int x = 8; x > 0; x >>= 1)
        m_blk = fmaxf(m_blk, __shfl_xor_sync(kFullMask, m_blk, x));
      const float m_new = fmaxf(m, m_blk);
      const float alpha = expf(m - m_new);
      const float e = expf(s - m_new);
      float l_blk = e;
#pragma unroll
      for (int x = 8; x > 0; x >>= 1)
        l_blk += __shfl_xor_sync(kFullMask, l_blk, x);
      l = alpha * l + l_blk;
      m = m_new;
#pragma unroll
      for (int i = 0; i < kOwn; ++i) acc[i] *= alpha;
      // P.V: every lane walks the keys over its own dims
#pragma unroll
      for (int p = 0; p < kKeys; ++p) {
        const float ep = __shfl_sync(kFullMask, e, p);
        float vs = 1.f;
        if constexpr (kQuant) vs = __shfl_sync(kFullMask, vscale, p);
        if (p < n_keys) {
          float vv[kOwn];
          load_vec<KT, kOwn>(pool_v + base + p * stride + lane * kOwn, vv);
          if constexpr (kQuant) {
#pragma unroll
            for (int i = 0; i < kOwn; ++i) vv[i] *= vs;
          }
#pragma unroll
          for (int i = 0; i < kOwn; ++i) acc[i] += ep * vv[i];
        }
      }
    }
  }

  // merge the warps' states: m = max m_w; l, acc rescaled by exp(m_w - m).
  // A warp left without pages holds m = -1e30, l = 0, acc = 0 and adds 0.
  float* sacc = smem;              // [kWarps][kDh]
  float* sml = smem + kWarps * kDh;  // [kWarps][2]: m, l
#pragma unroll
  for (int i = 0; i < kOwn; ++i) sacc[warp * kDh + lane * kOwn + i] = acc[i];
  if (lane == 0) {
    sml[2 * warp] = m;
    sml[2 * warp + 1] = l;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kDh; d += blockDim.x) {
    float m_all = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sml[2 * w]);
    float l_all = 0.f, od = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sml[2 * w] - m_all);
      l_all += f * sml[2 * w + 1];
      od += f * sacc[w * kDh + d];
    }
    o[d] = od / fmaxf(l_all, 1e-20f);
  }
}

// q, out: [rows, H, dh]; pools: [n_pages, page, H, dh]; table: [rows,
// tstride] int32; pos: [rows] int32. One block per (row, head).
template <typename KT>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const float* __restrict__ q,
                        const KT* __restrict__ pool_k,
                        const KT* __restrict__ pool_v,
                        const float* __restrict__ sk,
                        const float* __restrict__ sv,
                        const int* __restrict__ table,
                        const int* __restrict__ pos, float* __restrict__ out,
                        int H, int page, int npl, int tstride, float scale) {
  __shared__ float smem[kWarps * (kDh + 2)];
  const int r = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int t = pos[r];
  const int n_live = min(npl, t / page + 1);
  const long qo = static_cast<long>(blockIdx.x) * kDh;
  attend<KT>(q + qo, pool_k, pool_v, sk, sv,
             table + static_cast<long>(r) * tstride, H, h, page, n_live, t,
             scale, out + qo, smem);
}

// q, out: [rows, H, C, dh]; start: [rows] int32. One block per
// (row, head, c): blockIdx.x = (r * H + h) * C + c.
template <typename KT>
__global__ void __launch_bounds__(kWarps * 32)
    paged_chunk_kernel(const float* __restrict__ q,
                       const KT* __restrict__ pool_k,
                       const KT* __restrict__ pool_v,
                       const float* __restrict__ sk,
                       const float* __restrict__ sv,
                       const int* __restrict__ table,
                       const int* __restrict__ start, float* __restrict__ out,
                       int H, int C, int page, int npl, int tstride,
                       float scale) {
  __shared__ float smem[kWarps * (kDh + 2)];
  const int c = blockIdx.x % C;
  const int h = (blockIdx.x / C) % H;
  const int r = blockIdx.x / (C * H);
  const int qpos = start[r] + c;
  const int n_live = min(npl, qpos / page + 1);
  const long qo = static_cast<long>(blockIdx.x) * kDh;
  attend<KT>(q + qo, pool_k, pool_v, sk, sv,
             table + static_cast<long>(r) * tstride, H, h, page, n_live,
             qpos, scale, out + qo, smem);
}

template <typename KT>
cudaError_t launch(const float* q, const void* pk, const void* pv,
                   const float* sk, const float* sv, const int* table,
                   const int* pos, float* out, int rows, int H, int C, int dh,
                   int page, int npl, int tstride, float scale, bool chunk,
                   cudaStream_t stream) {
  if (dh != kDh || page < 1 || npl < 1 || C < 1) return cudaErrorInvalidValue;
  if (std::is_same<KT, int8_t>::value && (sk == nullptr || sv == nullptr))
    return cudaErrorInvalidValue;
  const long n = static_cast<long>(rows) * H * C;
  if (n == 0) return cudaSuccess;
  if (n > 0x7fffffffL) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(n);
  const KT* k = static_cast<const KT*>(pk);
  const KT* v = static_cast<const KT*>(pv);
  if (chunk) {
    paged_chunk_kernel<KT><<<blocks, kWarps * 32, 0, stream>>>(
        q, k, v, sk, sv, table, pos, out, H, C, page, npl, tstride, scale);
  } else {
    paged_decode_kernel<KT><<<blocks, kWarps * 32, 0, stream>>>(
        q, k, v, sk, sv, table, pos, out, H, page, npl, tstride, scale);
  }
  return cudaGetLastError();
}

// pool dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (with the scale
// sidecars sk, sv; NULL for the other types).
int dispatch(const float* q, const void* pool_k, const void* pool_v,
             const float* sk, const float* sv, const int* table,
             const int* pos, float* out, int rows, int H, int C, int dh,
             int page, int npl, int tstride, float scale, int ktype,
             bool chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ktype) {
    case 0: return launch<float>(q, pool_k, pool_v, sk, sv, table, pos, out, rows, H, C, dh, page, npl, tstride, scale, chunk, s);
    case 1: return launch<__nv_bfloat16>(q, pool_k, pool_v, sk, sv, table, pos, out, rows, H, C, dh, page, npl, tstride, scale, chunk, s);
    case 2: return launch<int8_t>(q, pool_k, pool_v, sk, sv, table, pos, out, rows, H, C, dh, page, npl, tstride, scale, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ddl_paged_decode(const float* q, const void* pool_k,
                                const void* pool_v, const float* scale_k,
                                const float* scale_v, const int* table,
                                const int* pos, float* out, int rows, int H,
                                int dh, int page, int npl, int tstride,
                                float scale, int ktype, void* stream) {
  return dispatch(q, pool_k, pool_v, scale_k, scale_v, table, pos, out, rows,
                  H, 1, dh, page, npl, tstride, scale, ktype, false, stream);
}

extern "C" int ddl_paged_chunk(const float* q, const void* pool_k,
                               const void* pool_v, const float* scale_k,
                               const float* scale_v, const int* table,
                               const int* start, float* out, int rows, int H,
                               int C, int dh, int page, int npl, int tstride,
                               float scale, int ktype, void* stream) {
  return dispatch(q, pool_k, pool_v, scale_k, scale_v, table, start, out,
                  rows, H, C, dh, page, npl, tstride, scale, ktype, true,
                  stream);
}

extern "C" const char* ddl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
