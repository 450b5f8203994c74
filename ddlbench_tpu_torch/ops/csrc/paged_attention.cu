// Paged attention over a shared KV pool, for Hopper (sm_90a).
//
// Two kernels, each replacing a Pallas TPU kernel of the JAX package:
//
//   paged_decode_ring    <- ddlbench_tpu/ops/paged_decode.py
//                           _paged_attn_kernel (:318), launched by
//                           paged_attention (:361): single-query
//                           flash-decode, one query per (row, head) at
//                           position pos[r].
//   paged_chunk_tiled    <- _paged_chunk_attn_kernel (:703), launched by
//                           paged_chunk_attention (:768, call :822): C
//                           chunk queries per row at absolute positions
//                           start[r] + c (chunked prefill, and the
//                           speculative verify pass).
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
// (query, key); over an int8 pool (a quarter of the bytes) a 16-query
// chunk's float32 operations, at 67 TFLOP/s, bound it instead.
//
// Both kernels walk pages the same way. Warp w of a block's kWarps takes
// the live pages w, w + 8, ... up to the last page its queries can see (later
// pages are fully masked and contribute exactly zero), one 16-key chunk at
// a time (a page of 32 is two chunks, a page of 8 one partial chunk),
// through a ring of stages of its own filled by 16-byte cp.async copies
// (copy_chunk): a chunk's K rows, V rows and, on an int8 pool, its 16 K and
// 16 V scales. Rows past a partial chunk are zero-filled by the copy (V 0,
// scale 0) and their probabilities are 0. A bfloat16 or int8 chunk is first
// dequantised once into a float chunk of the warp's (dequant_chunk; int8 by
// byte permute and a subtract, not the quarter-rate I2F). Rows in shared
// memory are padded by 16 bytes against bank conflicts. A key a query
// cannot see weighs an explicit 0, so a warp with no visible key holds m =
// -1e30, l = 0, acc = 0. The warps' states are merged in warp order at the
// end, so reruns give the same bits. No tensor cores (the query and the
// reference's arithmetic are float32), no TMA (a head's slice of a page is
// 16 rows 2 KiB apart, and a tensor map over the pool would be encoded at
// every call on a host-bound path), no split across blocks.
//
// Decode (paged_decode_ring): one block per (row, head). At the serving
// shape a row holds 4-16 pages, so a warp walks at most two: the time is
// latency, not bandwidth, and the design counts trips to device memory.
// The block copies its query, pos[r] and the row's first kTable table
// entries into shared memory in one trip; then each warp fills its whole
// ring (kStages chunks: every chunk of a two-page walk) before it computes
// the first, and refills a stage as soon as it is read. The scores: lane
// (key, half) dots half of key `key`'s row with its half of the query (kept
// in registers), one shuffle adds the halves, four shuffles give the
// chunk's max and sum. P.V: each lane owns 2 adjacent output dims and walks
// the 16 keys, each probability brought by a shuffle.
//
// Chunk (paged_chunk_tiled): one block per (row, head, tile of up to
// kTileQ = 16 chunk queries), so each live page of a head is read from
// device memory once per tile and shared by every query of the tile (the
// TPU kernel's grid step likewise attends all C queries against one page).
// The block stages its queries and its row's table entries in shared
// memory; each warp keeps kStages - 1 chunks in flight ahead of the one it
// computes. What bounds a block is shared-memory loads: so the scores are
// register-blocked, lane (half, cg, kg) dotting queries cg + 4i against
// keys kg + 4j over half the dims (every value loaded feeds 4 products);
// one shuffle exchange adds the halves, and each lane then keeps the online
// softmax (m, l) of two queries over the chunk's 16 keys, reduced over 4
// lanes by shuffles. For P.V each lane owns 4 dims of 8 queries and reads
// the probabilities and the V rows from shared memory.
//
// Types: the pool element type KT is float, __nv_bfloat16 or int8_t; the
// query and output are float (the serving model runs in float32), and
// everything accumulates in float32. The mask value is -1e30 (not -inf),
// and the output is acc / max(l, 1e-20), as in the TPU kernels
// (paged_decode.py:329-358). Head dim 64, that of every transformer variant.
//
// The int8 pool (dtype code 2) replaces the int8 branches of the same two
// TPU kernels (paged_decode.py:323-340 and :714-731, scale blocks :398-402
// and :805-809): each key and value row is dequantised before use, k[d] =
// float(int8) * scale_k[slot * page + p] (the same for v): the TPU kernels'
// arithmetic. The sidecars are [n_pages, page] float32; only slots of the
// row's live pages are read. Masked keys inside the last visible page
// (stale rejected-draft bytes, or zero scales) dequantise to finite values
// and weigh 0.
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
constexpr int kKeys = 16;  // keys of one chunk of a warp's walk
constexpr int kDh = 64;    // head dim of every transformer variant
constexpr int kTileQ = 16;  // chunk queries of one block
constexpr int kStages = 2;  // cp.async ring depth of one warp
constexpr int kTable = 2048;  // table entries a block stages

// kDh / 2 bfloat16 values at p (16-byte aligned) as float
__device__ __forceinline__ void load_bf16_half_row(
    const __nv_bfloat16* p, float (&out)[kDh / 2]) {
#pragma unroll
  for (int i = 0; i < kDh / 16; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[i];
    __nv_bfloat16 e[8];
    memcpy(e, &u, 16);
#pragma unroll
    for (int k = 0; k < 8; ++k) out[8 * i + k] = __bfloat162float(e[k]);
  }
}

// ---------------------------------------------------------------------------
// cp.async: asynchronous global -> shared copies, completed per thread by
// commit/wait groups. src_bytes 0 zero-fills the destination.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four int8 values packed in w (little-endian) as float, exactly, without
// the quarter-rate integer conversion: the float with bit pattern
// 0x4B000000 | (b ^ 0x80) is 2^23 + b + 128.
__device__ __forceinline__ void int8x4_to_f32(unsigned w, float* out) {
  const unsigned x = w ^ 0x80808080u;
  out[0] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650)) - 8388736.f;
  out[1] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7651)) - 8388736.f;
  out[2] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7652)) - 8388736.f;
  out[3] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7653)) - 8388736.f;
}

// kDh / 2 pool elements at p (16-byte aligned) as float
template <typename KT>
__device__ __forceinline__ void load_half_row(const KT* p,
                                              float (&out)[kDh / 2]) {
  if constexpr (std::is_same<KT, int8_t>::value) {
#pragma unroll
    for (int i = 0; i < kDh / 32; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      int8x4_to_f32(u.x, out + 16 * i);
      int8x4_to_f32(u.y, out + 16 * i + 4);
      int8x4_to_f32(u.z, out + 16 * i + 8);
      int8x4_to_f32(u.w, out + 16 * i + 12);
    }
  } else {
    load_bf16_half_row(p, out);
  }
}

// Shared memory of paged_chunk_tiled<KT>, in bytes, in this order:
//   queries   [kTileQ][kRow] float (rows padded to kRow)
//   per warp  probabilities [kKeys][kTileQ] float, then alphas [kTileQ]
//   per warp  (bfloat16 and int8 pools) the current chunk as float: K rows
//             [kKeys][kRow], V rows [kKeys][kRow], dequantised once
//   ring      per warp kStages stages: K rows [kKeys][kPoolRow bytes], V
//             rows [kKeys][kPoolRow bytes], on an int8 pool K and V scales
//             [2][kKeys] float; after the walk, the merge area
//             [kWarps][kTileQ][kDh] acc, [kWarps][kTileQ][2] m and l,
//             [kWarps][kTileQ] rescale factors
//   table     the row's first kTable entries, int (a page past them is
//             looked up in device memory)
// Every row is padded by 16 bytes, so that 8 lanes touching 8 rows at once
// hit 8 different bank groups. A float32 stage has the float chunk's
// layout (kPoolRow = kRow floats), so the float32 kernels compute on their
// ring stages directly. The decode kernel's stages and float chunks have
// the same layout (kStage, kChunkF32).
template <typename KT>
struct ChunkSmem {
  static constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  static constexpr bool kF32 = std::is_same<KT, float>::value;
  static constexpr int kRow = kDh + 4;  // floats between float rows
  static constexpr int kPoolRow = kDh * static_cast<int>(sizeof(KT)) + 16;
  static constexpr int kScales = kQuant ? 2 * kKeys * 4 : 0;
  static constexpr int kStage = 2 * kKeys * kPoolRow + kScales;
  static constexpr int kQ = kTileQ * kRow * 4;
  static constexpr int kPbWarp = (kKeys + 1) * kTileQ;  // floats
  static constexpr int kPb = kWarps * kPbWarp * 4;
  static constexpr int kChunkF32 = 2 * kKeys * kRow;  // floats
  static constexpr int kConv = kF32 ? 0 : kWarps * kChunkF32 * 4;
  static constexpr int kRing = kWarps * kStages * kStage;
  static constexpr int kMerge = kWarps * kTileQ * (kDh + 3) * 4;
  static constexpr int kRingOrMerge = kRing > kMerge ? kRing : kMerge;
  static constexpr int kTableAt = kQ + kPb + kConv + kRingOrMerge;
  static constexpr int kBytes = kTableAt + 4 * kTable;
  static_assert(kStage % 16 == 0 && kTableAt % 16 == 0, "16-byte alignment");
  static_assert(!kF32 || kPoolRow == kRow * 4, "float32 stage layout");
};

// Chunk i of warp `warp`'s walk (page warp + kWarps * (i / nch), keys
// 16 * (i % nch) .., head h), copied by the warp's lanes into ring stage st
// with 16-byte cp.async copies; rows past the page's end (and their scales)
// are zero-filled. The page's slot is stab[j] for the first kTable pages,
// trow[j] in device memory past them.
template <typename KT>
__device__ __forceinline__ void copy_chunk(
    unsigned char* st, int i, int nch, int warp, int lane, const int* stab,
    const int* __restrict__ trow, const KT* __restrict__ pool_k,
    const KT* __restrict__ pool_v, const float* __restrict__ sk,
    const float* __restrict__ sv, int H, int h, int page) {
  using L = ChunkSmem<KT>;
  constexpr int kPieces = kDh * sizeof(KT) / 16;  // 16-byte copies a row
  static_assert(kKeys * kPieces % 32 == 0, "whole copies a lane");
  const long stride = static_cast<long>(H) * kDh;  // elements between rows
  const int p0 = kKeys * (i % nch);
  const int n_keys = min(kKeys, page - p0);
  const int j = warp + kWarps * (i / nch);
  const long srow = static_cast<long>(j < kTable ? stab[j] : trow[j]) *
                    page + p0;  // sidecar index of the chunk's key 0
  const char* gk = reinterpret_cast<const char*>(pool_k + (srow * H + h) *
                                                 kDh);
  const char* gv = reinterpret_cast<const char*>(pool_v + (srow * H + h) *
                                                 kDh);
#pragma unroll
  for (int y = 0; y < kKeys * kPieces / 32; ++y) {
    const int row = (lane + 32 * y) / kPieces;
    const int piece = (lane + 32 * y) % kPieces;
    const bool ok = row < n_keys;
    const long off = (ok ? row * stride : 0) * sizeof(KT) + piece * 16;
    cp_async16(st + row * L::kPoolRow + piece * 16, gk + off, ok ? 16 : 0);
    cp_async16(st + (kKeys + row) * L::kPoolRow + piece * 16, gv + off,
               ok ? 16 : 0);
  }
  if constexpr (L::kQuant) {  // lanes 0-15 the K scales, 16-31 the V
    const int key = lane & (kKeys - 1);
    const bool ok = key < n_keys;
    cp_async4(st + 2 * kKeys * L::kPoolRow + lane * 4,
              (lane >> 4 ? sv : sk) + srow + (ok ? key : 0), ok ? 4 : 0);
  }
}

// The bfloat16 or int8 chunk in ring stage st as float into cv: K rows,
// then V rows, kRow floats apart. Lane (half, row) converts its half K row
// and half V row once, an int8 row times its scale.
template <typename KT>
__device__ __forceinline__ void dequant_chunk(const unsigned char* st,
                                              float* cv, int lane) {
  using L = ChunkSmem<KT>;
  constexpr int kHalf = kDh / 2;
  const float* ssc = reinterpret_cast<const float*>(
      st + 2 * kKeys * L::kPoolRow);  // K scales, then V scales
  const int row = lane & (kKeys - 1), hh = lane >> 4;
#pragma unroll
  for (int kv = 0; kv < 2; ++kv) {  // K, then V
    float x[kHalf];
    load_half_row<KT>(reinterpret_cast<const KT*>(
                          st + (kv * kKeys + row) * L::kPoolRow) + hh * kHalf,
                      x);
    if constexpr (L::kQuant) {
      const float s = ssc[kv * kKeys + row];
#pragma unroll
      for (int d = 0; d < kHalf; ++d) x[d] *= s;
    }
#pragma unroll
    for (int d = 0; d < kHalf / 4; ++d)
      reinterpret_cast<float4*>(cv + (kv * kKeys + row) * L::kRow +
                                hh * kHalf)[d] =
          make_float4(x[4 * d], x[4 * d + 1], x[4 * d + 2], x[4 * d + 3]);
  }
}

// q, out: [rows, H, C, dh]; start: [rows] int32. One block per
// (row, head, tile of kTileQ queries): blockIdx.x = (r * H + h) * n_tiles
// + t. Block size kWarps * 32; dynamic shared memory ChunkSmem<KT>::kBytes.
// One block per SM (its shared memory), so the registers may use it all.
template <typename KT>
__global__ void __launch_bounds__(kWarps * 32, 1)
    paged_chunk_tiled(const float* __restrict__ q,
                      const KT* __restrict__ pool_k,
                      const KT* __restrict__ pool_v,
                      const float* __restrict__ sk,
                      const float* __restrict__ sv,
                      const int* __restrict__ table,
                      const int* __restrict__ start, float* __restrict__ out,
                      int H, int C, int page, int npl, int tstride,
                      float scale) {
  using L = ChunkSmem<KT>;
  constexpr int kHalf = kDh / 2;
  constexpr int kR4 = L::kRow / 4;        // float4s between padded rows
  static_assert(kTileQ * kDh / 4 == kWarps * 32, "one float4 a thread");
  static_assert(kTileQ == 16 && kKeys == 16, "lane layouts");
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* spb = reinterpret_cast<float*>(smem + L::kQ);
  float* sconv = reinterpret_cast<float*>(smem + L::kQ + L::kPb);
  unsigned char* ring = smem + L::kQ + L::kPb + L::kConv;
  int* stab = reinterpret_cast<int*>(smem + L::kTableAt);

  const int n_tiles = (C + kTileQ - 1) / kTileQ;
  const int t = blockIdx.x % n_tiles;
  const int h = (blockIdx.x / n_tiles) % H;
  const int r = blockIdx.x / (n_tiles * H);
  const int c0 = t * kTileQ;
  const int nq = min(kTileQ, C - c0);
  const long qo = (static_cast<long>(r * H + h) * C + c0) * kDh;
  const int* trow = table + static_cast<long>(r) * tstride;
  {  // the tile's queries (zeros past C) and the row's first table entries,
     // loaded together
    const int c = threadIdx.x / (kDh / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < nq) v = reinterpret_cast<const float4*>(q + qo)[threadIdx.x];
    reinterpret_cast<float4*>(sq)[c * kR4 + threadIdx.x % (kDh / 4)] = v;
    for (int j = threadIdx.x; j < min(npl, kTable); j += blockDim.x)
      stab[j] = trow[j];
  }
  const int qpos0 = start[r] + c0;  // stream position of the tile's query 0
  const int n_live = min(npl, (qpos0 + nq - 1) / page + 1);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // scores: lane (hd, cg, kg) dots queries cg + 4 i with keys kg + 4 j over
  // dims 32 hd .. 32 hd + 31, and after the exchange of halves keeps the
  // softmax of queries cg + 4 (2 hd + ii), ii = 0, 1
  const int hd = lane >> 4, cg = (lane >> 2) & 3, kg = lane & 3;
  // P.V: lane (qh, dg) owns dims 4 dg .. 4 dg + 3 of queries 8 qh .. 8 qh + 7
  const int qh = lane >> 4, dg = lane & 15;
  const int nch = (page + kKeys - 1) / kKeys;      // chunks a page
  const int n_pages = n_live > warp ? (n_live - warp - 1) / kWarps + 1 : 0;
  const int n_chunks = n_pages * nch;
  unsigned char* wring = ring + warp * kStages * L::kStage;
  float* pb = spb + warp * L::kPbWarp;  // [kKeys][kTileQ], then alphas
  auto issue = [&](int i) {
    copy_chunk<KT>(wring + (i % kStages) * L::kStage, i, nch, warp, lane,
                   stab, trow, pool_k, pool_v, sk, sv, H, h, page);
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // queries kept
  float acc[8][4];  // P.V: queries 8 qh + c, dims 4 dg + d
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int d = 0; d < 4; ++d) acc[c][d] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_chunks) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_chunks; ++i) {
    if (i + kStages - 1 < n_chunks) issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this lane's copies of chunk i
    __syncwarp();                  // ... and every lane's
    const unsigned char* st = wring + (i % kStages) * L::kStage;
    // the chunk's K rows as float, kRow apart, then its V rows
    const float* kf;
    if constexpr (L::kF32) {
      kf = reinterpret_cast<const float*>(st);
    } else {
      float* cv = sconv + warp * L::kChunkF32;
      dequant_chunk<KT>(st, cv, lane);
      __syncwarp();
      kf = cv;
    }
    const float* vf = kf + kKeys * L::kRow;
    const int kpos0 = (warp + kWarps * (i / nch)) * page + kKeys * (i % nch);
    const int n_keys = min(kKeys, page - kKeys * (i % nch));

    // scores: 4 queries x 4 keys a lane over half the dims, so that each
    // value read from shared memory feeds 4 products
    float part[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) part[a][b] = 0.f;
    const float4* q4 = reinterpret_cast<const float4*>(sq) + hd * (kHalf / 4);
    const float4* k4 = reinterpret_cast<const float4*>(kf) + hd * (kHalf / 4);
#pragma unroll
    for (int d = 0; d < kHalf / 4; ++d) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = q4[(cg + 4 * a) * kR4 + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kv[b] = k4[(kg + 4 * b) * kR4 + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          part[a][b] += qv[a].x * kv[b].x;
          part[a][b] += qv[a].y * kv[b].y;
          part[a][b] += qv[a].z * kv[b].z;
          part[a][b] += qv[a].w * kv[b].w;
        }
    }

    // softmax of the lane's two queries over the chunk's 16 keys: one
    // shuffle brings the other half's partial dots, two reduce over kg
    float p[2][4], alpha[2];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int c = cg + 4 * (2 * hd + ii);
      float s[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float mine = hd ? part[2 + ii][b] : part[ii][b];
        const float other = __shfl_xor_sync(
            kFullMask, hd ? part[ii][b] : part[2 + ii][b], 16);
        const int k = kg + 4 * b;
        const bool vis = k < n_keys && kpos0 + k <= qpos0 + c;
        s[b] = vis ? (mine + other) * scale : kNegInf;
      }
      float m_blk = fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3]));
      m_blk = fmaxf(m_blk, __shfl_xor_sync(kFullMask, m_blk, 1));
      m_blk = fmaxf(m_blk, __shfl_xor_sync(kFullMask, m_blk, 2));
      const float m_new = fmaxf(m[ii], m_blk);
      alpha[ii] = expf(m[ii] - m_new);
      float l_blk = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int k = kg + 4 * b;
        const bool vis = k < n_keys && kpos0 + k <= qpos0 + c;
        p[ii][b] = vis ? expf(s[b] - m_new) : 0.f;
        l_blk += p[ii][b];
      }
      l_blk += __shfl_xor_sync(kFullMask, l_blk, 1);
      l_blk += __shfl_xor_sync(kFullMask, l_blk, 2);
      l[ii] = alpha[ii] * l[ii] + l_blk;
      m[ii] = m_new;
    }
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int c = cg + 4 * (2 * hd + ii);
#pragma unroll
      for (int b = 0; b < 4; ++b) pb[(kg + 4 * b) * kTileQ + c] = p[ii][b];
      if (kg == 0) pb[kKeys * kTileQ + c] = alpha[ii];
    }
    __syncwarp();

    // P.V: every lane walks the 16 keys over its 4 dims of 8 queries
    {
      const float4* al =
          reinterpret_cast<const float4*>(pb + kKeys * kTileQ + 8 * qh);
      const float4 a0 = al[0], a1 = al[1];
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int d = 0; d < 4; ++d) acc[c][d] *= a[c];
    }
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      const float4 v = reinterpret_cast<const float4*>(vf + k * L::kRow)[dg];
      const float4* pr =
          reinterpret_cast<const float4*>(pb + k * kTileQ + 8 * qh);
      const float4 p0 = pr[0], p1 = pr[1];
      const float pk[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc[c][0] += pk[c] * v.x;
        acc[c][1] += pk[c] * v.y;
        acc[c][2] += pk[c] * v.z;
        acc[c][3] += pk[c] * v.w;
      }
    }
    __syncwarp();  // the stage and the buffers are free for the next chunk
  }
  cp_async_wait<0>();

  // merge the warps' states in warp order into the ring's space: m = max
  // m_w; l, acc rescaled by f_w = exp(m_w - m), computed once per (w, c).
  // A warp left without pages holds m = -1e30, l = 0, acc = 0 and adds 0.
  __syncthreads();
  float* sacc = reinterpret_cast<float*>(ring);  // [kWarps][kTileQ][kDh]
  float* sml = sacc + kWarps * kTileQ * kDh;     // [kWarps][kTileQ][2]
  float* sf = sml + kWarps * kTileQ * 2;         // [kWarps][kTileQ]
#pragma unroll
  for (int c = 0; c < 8; ++c)
    reinterpret_cast<float4*>(sacc + (warp * kTileQ + 8 * qh + c) * kDh)[dg] =
        make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
  if (kg == 0) {
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int c = cg + 4 * (2 * hd + ii);
      sml[2 * (warp * kTileQ + c)] = m[ii];
      sml[2 * (warp * kTileQ + c) + 1] = l[ii];
    }
  }
  __syncthreads();
  if (threadIdx.x < kWarps * kTileQ) {  // thread (w, c)
    const int c = threadIdx.x % kTileQ;
    float m_all = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      m_all = fmaxf(m_all, sml[2 * (w * kTileQ + c)]);
    sf[threadIdx.x] = expf(sml[2 * threadIdx.x] - m_all);
  }
  __syncthreads();
  for (int x = threadIdx.x; x < nq * kDh; x += blockDim.x) {
    const int c = x / kDh, d = x % kDh;
    float l_all = 0.f, od = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = sf[w * kTileQ + c];
      l_all += f * sml[2 * (w * kTileQ + c) + 1];
      od += f * sacc[(w * kTileQ + c) * kDh + d];
    }
    out[qo + x] = od / fmaxf(l_all, 1e-20f);
  }
}

// Shared memory of paged_decode_ring<KT>, in bytes, in this order:
//   query     [kDh] float, then pos[r] (padded to 16 bytes)
//   per warp  (bfloat16 and int8 pools) the current chunk as float
//   ring      per warp kStages stages (ChunkSmem's); after the walk, the
//             merge area [kWarps][kDh] acc, [kWarps][2] m and l
//   table     the row's first kTable entries, int
template <typename KT>
struct DecodeSmem {
  using L = ChunkSmem<KT>;
  static constexpr int kQ = kDh * 4 + 16;
  static constexpr int kRing = kWarps * kStages * L::kStage;
  static constexpr int kMerge = kWarps * (kDh + 2) * 4;
  static constexpr int kRingOrMerge = kRing > kMerge ? kRing : kMerge;
  static constexpr int kTableAt = kQ + L::kConv + kRingOrMerge;
  static constexpr int kBytes = kTableAt + 4 * kTable;
  static_assert(kQ % 16 == 0 && kTableAt % 16 == 0, "16-byte alignment");
};

// q, out: [rows, H, dh]; pools: [n_pages, page, H, dh]; table: [rows,
// tstride] int32; pos: [rows] int32. One block per (row, head):
// blockIdx.x = r * H + h. Block size kWarps * 32; dynamic shared memory
// DecodeSmem<KT>::kBytes, so one block per SM.
template <typename KT>
__global__ void __launch_bounds__(kWarps * 32, 1)
    paged_decode_ring(const float* __restrict__ q,
                      const KT* __restrict__ pool_k,
                      const KT* __restrict__ pool_v,
                      const float* __restrict__ sk,
                      const float* __restrict__ sv,
                      const int* __restrict__ table,
                      const int* __restrict__ pos, float* __restrict__ out,
                      int H, int page, int npl, int tstride, float scale) {
  using L = ChunkSmem<KT>;
  using D = DecodeSmem<KT>;
  constexpr int kHalf = kDh / 2;  // dims one lane dots per key
  static_assert(kKeys == 16 && kDh == 64, "lane layouts");
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  int* spos = reinterpret_cast<int*>(smem + kDh * 4);
  float* sconv = reinterpret_cast<float*>(smem + D::kQ);
  unsigned char* ring = smem + D::kQ + L::kConv;
  int* stab = reinterpret_cast<int*>(smem + D::kTableAt);

  const int r = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long qo = static_cast<long>(blockIdx.x) * kDh;
  const int* trow = table + static_cast<long>(r) * tstride;
  // one trip: the query, pos[r] and the row's first table entries
  if (threadIdx.x < kDh / 4)
    cp_async16(sq + 4 * threadIdx.x, q + qo + 4 * threadIdx.x, 16);
  else if (threadIdx.x == kDh / 4)
    cp_async4(spos, pos + r, 4);
  for (int j = threadIdx.x; j < min(npl, kTable); j += blockDim.x)
    cp_async4(stab + j, trow + j, 4);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int qpos = *spos;
  const int n_live = min(npl, qpos / page + 1);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int key = lane & (kKeys - 1), half = lane >> 4;  // scores
  const int nch = (page + kKeys - 1) / kKeys;  // chunks a page
  const int n_pages = n_live > warp ? (n_live - warp - 1) / kWarps + 1 : 0;
  const int n_chunks = n_pages * nch;
  unsigned char* wring = ring + warp * kStages * L::kStage;
  auto issue = [&](int i) {
    copy_chunk<KT>(wring + (i % kStages) * L::kStage, i, nch, warp, lane,
                   stab, trow, pool_k, pool_v, sk, sv, H, h, page);
  };
  // the whole ring in flight before the first chunk is computed
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < n_chunks) issue(i);
    cp_async_commit();
  }

  float qv[kHalf];  // this lane's half of the query
#pragma unroll
  for (int d = 0; d < kHalf / 4; ++d) {
    const float4 x = reinterpret_cast<const float4*>(sq + half * kHalf)[d];
    qv[4 * d] = x.x;
    qv[4 * d + 1] = x.y;
    qv[4 * d + 2] = x.z;
    qv[4 * d + 3] = x.w;
  }
  float m = kNegInf, l = 0.f;
  float2 acc = make_float2(0.f, 0.f);  // output dims 2 lane, 2 lane + 1

  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait<kStages - 1>();  // this lane's copies of chunk i
    __syncwarp();                  // ... and every lane's
    unsigned char* st = wring + (i % kStages) * L::kStage;
    // the chunk's K rows as float, kRow apart, then its V rows
    const float* kf;
    if constexpr (L::kF32) {
      kf = reinterpret_cast<const float*>(st);
    } else {  // converted once; the stage is then free for chunk i + kStages
      float* cv = sconv + warp * L::kChunkF32;
      dequant_chunk<KT>(st, cv, lane);
      __syncwarp();
      if (i + kStages < n_chunks) issue(i + kStages);
      cp_async_commit();
      kf = cv;
    }
    const float* vf = kf + kKeys * L::kRow;
    const int p0 = kKeys * (i % nch);
    const int kpos = (warp + kWarps * (i / nch)) * page + p0 + key;
    const bool vis = key < min(kKeys, page - p0) && kpos <= qpos;

    // score of key `key` over half the dims; one shuffle adds the halves
    const float4* k4 =
        reinterpret_cast<const float4*>(kf + key * L::kRow + half * kHalf);
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < kHalf / 4; ++d) {
      const float4 kv = k4[d];
      s += qv[4 * d] * kv.x;
      s += qv[4 * d + 1] * kv.y;
      s += qv[4 * d + 2] * kv.z;
      s += qv[4 * d + 3] * kv.w;
    }
    s += __shfl_xor_sync(kFullMask, s, 16);
    s = vis ? s * scale : kNegInf;
    // the 16 keys' max and sum (each value sits in both halves)
    float m_blk = s;
#pragma unroll
    for (int x = 8; x > 0; x >>= 1)
      m_blk = fmaxf(m_blk, __shfl_xor_sync(kFullMask, m_blk, x));
    const float m_new = fmaxf(m, m_blk);
    const float alpha = expf(m - m_new);
    const float p = vis ? expf(s - m_new) : 0.f;
    float l_blk = p;
#pragma unroll
    for (int x = 8; x > 0; x >>= 1)
      l_blk += __shfl_xor_sync(kFullMask, l_blk, x);
    l = alpha * l + l_blk;
    m = m_new;
    acc.x *= alpha;
    acc.y *= alpha;
    // P.V: every lane walks the 16 keys over its own 2 dims
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      const float pk = __shfl_sync(kFullMask, p, k);
      const float2 v = reinterpret_cast<const float2*>(vf + k * L::kRow)[lane];
      acc.x += pk * v.x;
      acc.y += pk * v.y;
    }
    __syncwarp();  // the stage and the float chunk are read
    if constexpr (L::kF32) {
      if (i + kStages < n_chunks) issue(i + kStages);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  // merge the warps' states in warp order into the ring's space: m = max
  // m_w; l, acc rescaled by exp(m_w - m). A warp left without pages holds
  // m = -1e30, l = 0, acc = 0 and adds 0.
  __syncthreads();
  float* sacc = reinterpret_cast<float*>(ring);  // [kWarps][kDh]
  float* sml = sacc + kWarps * kDh;              // [kWarps][2]: m, l
  reinterpret_cast<float2*>(sacc + warp * kDh)[lane] = acc;
  if (lane == 0) {
    sml[2 * warp] = m;
    sml[2 * warp + 1] = l;
  }
  __syncthreads();
  if (threadIdx.x < kDh) {
    const int d = threadIdx.x;
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
    out[qo + d] = od / fmaxf(l_all, 1e-20f);
  }
}

// Lets `kernel` use `bytes` of dynamic shared memory, once: `allowed`
// remembers that it was set.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& allowed) {
  if (allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  allowed = e == cudaSuccess;
  return e;
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
  const long tiles = chunk ? (C + kTileQ - 1) / kTileQ : 1;
  const long n = static_cast<long>(rows) * H * tiles;
  if (n == 0) return cudaSuccess;
  if (n > 0x7fffffffL) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(n);
  const KT* k = static_cast<const KT*>(pk);
  const KT* v = static_cast<const KT*>(pv);
  static bool chunk_allowed = false, decode_allowed = false;
  cudaError_t e;
  if (chunk) {
    constexpr int bytes = ChunkSmem<KT>::kBytes;
    e = allow_smem(paged_chunk_tiled<KT>, bytes, chunk_allowed);
    if (e != cudaSuccess) return e;
    paged_chunk_tiled<KT><<<blocks, kWarps * 32, bytes, stream>>>(
        q, k, v, sk, sv, table, pos, out, H, C, page, npl, tstride, scale);
  } else {
    constexpr int bytes = DecodeSmem<KT>::kBytes;
    e = allow_smem(paged_decode_ring<KT>, bytes, decode_allowed);
    if (e != cudaSuccess) return e;
    paged_decode_ring<KT><<<blocks, kWarps * 32, bytes, stream>>>(
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
