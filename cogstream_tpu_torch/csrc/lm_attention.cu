// K3 and K4: causal GQA attention over the position-tagged KV cache.
//
// K3 replaces cogstream_tpu/ops/lm_attention.py::_prefill_kernel
// (prefill_flash_attention); K4 replaces ::_decode_kernel
// (decode_splash_attention). Both keep the JAX contract: ALL validity
// (causality, empty slot, per-turn kv_allowed, padded query) is one
// int32 compare `q_pos >= eff_kv_pos`, where invisible slots carry
// SENTINEL = 2^30 and padded queries -1; the GQA group folds into the
// query rows (row r = s * G + g of kv head h reads query head h*G + g);
// a fully masked row outputs 0.
//
// * K3 in bf16 (cs_gqa_prefill_tc): the tensor-core tile of tc_tile.cuh.
//   Bound on the H100: arithmetic (4 D FLOP per visible (row, slot)
//   pair; the 7B ingest prefill is ~4e11 FLOP over ~50 MB). A pre-pass
//   stores each 64-slot key tile's smallest and largest eff position: a
//   block skips every tile whose smallest position exceeds its largest
//   query position (the causal tail and the empty cache beyond the write
//   index cost one integer compare and are never loaded), and a warp
//   whose rows have all reached a tile's largest position runs it
//   without the per-score compare. A block of 4 warps owns 64 * MT
//   folded rows of one (batch, kv head), so each K/V tile is read once
//   for all G query heads of the rows; K/V tiles stream through a
//   cp.async double buffer with each tile's eff positions, and the score
//   / softmax / P.V work runs on bf16 tensor cores with f32
//   accumulators. The pre-pass also bounds the block's last tile, so the
//   skipped tail is not even scanned. Row tiles are launched last-first
//   (the last rows see the most slots). MT = 2 (128 rows, 32 per warp)
//   halves the shared-memory reads per (row, slot) pair and the K/V
//   traffic from L2; a grid that would not fill the SMs at 128 rows (a
//   question prefill of a few dozen tokens) takes MT = 1. Two blocks
//   share an SM, so one block's softmax overlaps the other's MMAs.
// * K4 in bf16 (cs_gqa_decode_tc): a decode-shaped tensor-core kernel,
//   ONE launch per call with no pre-pass and no second pass, so a decode
//   step can be captured in a CUDA graph. Bound on the H100: reading the
//   visible K/V bytes of the cache (S <= 8 rows per kv head do ~4 D FLOP
//   per 4 D bytes). Its R = S * G folded rows take ceil(R / 16) m16
//   tiles (1 at S = 1, G = 7: 7 real rows in 16), up to MT per block;
//   the cache splits into runs of `tiles_per_split` 64-slot tiles
//   (flash-decoding, the split count chosen by the wrapper from kv_len
//   and the SM count), one block per (split, batch x kv head, row group).
//   The 4 warps of a block share its rows and take its tiles in turn,
//   each with its own online softmax (tc::scores / tc::accumulate) and
//   its own K and V buffers, copied as two cp.async groups so the scores
//   run while V lands and the next tile's K lands during P.V. Before a
//   tile is copied the warp reads its 64 eff positions (while the
//   previous tile's scores run) and a warp vote skips a tile no row can
//   see and the compare of a tile every row sees wholly. The warps merge
//   in shared memory in warp order; with one split the block writes the
//   output, otherwise its partial (m, l, acc) goes to the caller's
//   workspace and the last block of the (batch x kv head, row group),
//   found by an atomic ticket it resets, merges the partials in split
//   order: two calls give the same bits.
// * f32, K3 and K4 (cs_gqa_attention): the CUDA-core f32 tile of
//   common.cuh (attend_tile), one 256-thread block per (64-row tile,
//   batch x kv head, key chunk), after the tile_min pre-pass. f32 keeps
//   exact f32 products (the tiny f32 sessions hold card-vs-CPU greedy
//   tokens through it).
//   - K3 f32: one chunk spans the whole cache; the block writes
//     normalized rows.
//   - K4 f32: chunks of `chunk_tiles` tiles; each block writes its
//     partial (m, l, acc) and cs_gqa_combine merges the chunks.
//
// An e4m3 K/V cache (the fp8 KV cache, kv_dtype code E4M3): each route
// reads the cache's own bytes and converts them on chip, as the TPU
// kernels do (`k_ref[0].astype(q.dtype)`), so the K/V traffic from HBM
// halves against bf16 and no bf16 copy of the cache is ever made.
//   - K4 tensor-core kernel (template flag F8): cp.async copies the
//     tile's e4m3 rows into a byte tile in shared memory (16-byte chunks,
//     swizzled: tc::swz), and the MMAs' B fragments are read from those
//     bytes and widened in registers just before their mma.sync
//     (tc::scores_f8, tc::accumulate_f8; exact: every e4m3 value is a
//     bf16 value). There is no bf16 K/V tile: K/V cross shared memory
//     once, as bytes. Q is staged with its head dims permuted so that a
//     key's 32-bit word is K's B fragment; V's fragments come from a 4x4
//     byte transpose of four keys' words, with P's keys permuted to match
//     and O's head dims put back as the warps' merge writes O. What
//     bounds it is each warp's chain of latencies (copy, widen, MMA,
//     softmax, widen, MMA) over its tiles, then the merge. A warp keeps only its K and V
//     bytes (16 KB at D = 128), so a block takes 8 warps, and decode_plan
//     rounds a split up to whole tiles for all 8 (over a 9216-slot
//     window: one tile a warp at S = 1, two at S = 5 and 8, where a bf16
//     warp has 2 and 3): the longest chain is shorter.
//   - K3 tensor-core kernel (F8): the same widening in registers loses
//     here, since each of a block's warps reads every element of a tile,
//     so each would widen the whole tile (1.4x the bf16 kernel's time on
//     the H100, PERF.md). K3 widens each tile ONCE a block instead: two
//     byte stages of e4m3 rows, widened by all threads (tc::e4m3_tile)
//     into one of two bf16 K/V tiles that the unchanged bf16 body reads.
//     Tile t's math and tile t + 1's widening share one barrier interval
//     (one barrier a tile) while the bytes of t + 2 land. What bounds it
//     is the widening's issue slots and its bf16 stores beside the math,
//     so the 2-m-tile instance takes 8 warps (256 rows: the widening a
//     row halves; 176 KB, one block an SM). The 1-m-tile instance, for
//     prefills whose blocks would leave SMs idle, keeps 4 warps and 64
//     rows, so that such a prefill spreads over more SMs.
//   - f32 route: gqa_attention_kernel<float, __nv_fp8_e4m3> widens each
//     element as it fills the f32 tile.
//
// Row addressing (pooled serving): every route takes an optional `rows`
// ([B] int32 on the device). With it, input row b reads cache row
// rows[b] of a [B_pool, T_cache, Hkv, D] cache (the TPU kernel's `rows`
// operand in its index maps): only the K/V base pointer moves, while q,
// q_pos, eff, out and K4's split partials and tickets stay indexed by the
// input row. A null `rows` reads cache row b, as before. No gather copy.
//
// The port writes each decode step's K/V IN PLACE into the cache before
// attention (runtime/generate.py), so K4 needs no side buffer or fresh
// K/V stream: the TPU kernel's main (+) side (+) fresh folding becomes
// one cache range.
#include <type_traits>

#include "common.cuh"
#include "tc_tile.cuh"

namespace {

constexpr int MAX_SMEM = 232448;  // 227 KB: a block's dynamic shared memory

// smallest eff position of each 64-slot key tile: tile_min[b, tile]
__global__ void tile_min_kernel(const int* __restrict__ eff,
                                int* __restrict__ tile_min, int kv_len,
                                int n_tiles) {
  const int b = blockIdx.y, tile = blockIdx.x, t = tile * cs::BK + threadIdx.x;
  int v = t < kv_len ? eff[(size_t)b * kv_len + t] : cs::SENTINEL;
  v = cs::warp_min_i(v);
  __shared__ int red[cs::BK / 32];
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) tile_min[(size_t)b * n_tiles + tile] = min(red[0], red[1]);
}

// K3's tensor-core pre-pass: each 64-slot tile's smallest and largest eff
// position (SENTINEL past kv_len) into tile_mm[0][b][tile] and
// tile_mm[1][b][tile]
__global__ void tile_minmax_kernel(const int* __restrict__ eff,
                                   int* __restrict__ tile_mm, int B,
                                   int kv_len, int n_tiles) {
  const int b = blockIdx.y, tile = blockIdx.x, t = tile * cs::BK + threadIdx.x;
  const int v = t < kv_len ? eff[(size_t)b * kv_len + t] : cs::SENTINEL;
  const int lo = cs::warp_min_i(v), hi = cs::warp_max_i(v);
  __shared__ int red[2][cs::BK / 32];
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = lo;
    red[1][threadIdx.x >> 5] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const size_t i = (size_t)b * n_tiles + tile;
    tile_mm[i] = min(red[0][0], red[0][1]);
    tile_mm[(size_t)B * n_tiles + i] = max(red[1][0], red[1][1]);
  }
}

template <typename T, typename KV>
__global__ void __launch_bounds__(cs::NT)
gqa_attention_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                     const KV* __restrict__ v, const int* __restrict__ qpos,
                     const int* __restrict__ eff,
                     const int* __restrict__ tile_min,
                     const int* __restrict__ rows, T* __restrict__ out,
                     float* __restrict__ part_m, float* __restrict__ part_l,
                     float* __restrict__ part_acc, int S, int Hq, int Hkv,
                     int D, int T_cache, int kv_len, int chunk_tiles,
                     float scale) {
  extern __shared__ float smem[];
  const int DS = D + 4, G = Hq / Hkv, R = S * G;
  const int n_tiles = (kv_len + cs::BK - 1) / cs::BK;
  float* Qs = smem;
  float* Ks = Qs + cs::BR * DS;
  float* Vs = Ks + cs::BK * DS;
  float* Ps = Vs + cs::BK * DS;
  int* rpos = reinterpret_cast<int*>(Ps + cs::BR * cs::PS);
  int* cpos = rpos + cs::BR;
  int* red = cpos + cs::BK;
  int* tmin = red + cs::NT / 32;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / Hkv, h = blockIdx.y % Hkv;
  const size_t kv_row = rows ? rows[b] : b;  // the cache row of input row b
  const int r0 = blockIdx.x * cs::BR;
  const int t_begin = blockIdx.z * chunk_tiles;
  const int t_end = min(t_begin + chunk_tiles, n_tiles);

  for (int i = tid; i < cs::BR * D; i += cs::NT) {
    const int rr = i / D, d = i % D, r = r0 + rr;
    float val = 0.f;
    if (r < R) {
      const int s = r / G, g = r % G;
      val = cs::to_f(q[(((size_t)b * S + s) * Hq + h * G + g) * D + d]);
    }
    Qs[rr * DS + d] = val;
  }
  int my = -1;
  if (tid < cs::BR) {
    const int r = r0 + tid;
    my = r < R ? qpos[(size_t)b * S + r / G] : -1;
    rpos[tid] = my;
  }
  my = cs::warp_max_i(my);
  if ((tid & 31) == 0) red[tid >> 5] = my;
  for (int i = t_begin + tid; i < t_end; i += cs::NT)
    tmin[i - t_begin] = tile_min[(size_t)b * n_tiles + i];
  __syncthreads();
  int qmax = red[0];
  for (int w = 1; w < cs::NT / 32; ++w) qmax = max(qmax, red[w]);

  cs::RowState st;
  st.init();
  for (int tile = t_begin; tile < t_end; ++tile) {
    if (tmin[tile - t_begin] > qmax) continue;  // uniform across the block
    const int k0 = tile * cs::BK;
    const int ncols = min(cs::BK, kv_len - k0);
    for (int i = tid; i < ncols * D; i += cs::NT) {
      const int c = i / D, d = i % D;
      const size_t off = ((kv_row * T_cache + k0 + c) * Hkv + h) * D + d;
      Ks[c * DS + d] = cs::to_f(k[off]);
      Vs[c * DS + d] = cs::to_f(v[off]);
    }
    for (int c = tid; c < cs::BK; c += cs::NT)
      cpos[c] = c < ncols ? eff[(size_t)b * kv_len + k0 + c] : cs::SENTINEL;
    __syncthreads();
    cs::attend_tile(Qs, Ks, Vs, Ps, D, ncols, scale,
                    [&](int r, int c) { return rpos[r] >= cpos[c]; }, st);
    __syncthreads();  // tile consumed before the next load overwrites it
  }

  const int rr = tid >> 2, r = r0 + rr;
  if (r >= R) return;
  if (part_m == nullptr) {
    const int s = r / G, g = r % G;
    cs::store_row(st, out + (((size_t)b * S + s) * Hq + h * G + g) * D, D);
    return;
  }
  const size_t p = ((size_t)blockIdx.y * gridDim.z + blockIdx.z) * R + r;
  if ((tid & 3) == 0) {
    part_m[p] = st.m;
    part_l[p] = st.l;
  }
  const int quad = tid & 3, D4 = D >> 2;
  float4* acc4 = reinterpret_cast<float4*>(part_acc + p * D);
#pragma unroll
  for (int jj = 0; jj < cs::ACC4; ++jj) {
    const int g = quad + 4 * jj;
    if (g < D4) acc4[g] = st.acc[jj];
  }
}

// merge the per-chunk partials of K4: one block per (batch x kv head,
// folded row), one thread per head-dim element
template <typename T>
__global__ void gqa_combine_kernel(const float* __restrict__ part_m,
                                   const float* __restrict__ part_l,
                                   const float* __restrict__ part_acc,
                                   T* __restrict__ out, int S, int Hq,
                                   int Hkv, int D, int n_chunks) {
  const int bh = blockIdx.x, r = blockIdx.y, d = threadIdx.x;
  const int G = Hq / Hkv, R = S * G;
  const int b = bh / Hkv, h = bh % Hkv, s = r / G, g = r % G;
  float M = cs::NEG_INF;
  for (int c = 0; c < n_chunks; ++c)
    M = fmaxf(M, part_m[((size_t)bh * n_chunks + c) * R + r]);
  float L = 0.f, A = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const size_t p = ((size_t)bh * n_chunks + c) * R + r;
    const float m = part_m[p];
    const float w = m > cs::NEG_INF * 0.5f ? expf(m - M) : 0.f;
    L += w * part_l[p];
    A += w * part_acc[p * D + d];
  }
  out[(((size_t)b * S + s) * Hq + h * G + g) * D + d] =
      cs::from_f<T>(A / (L > 0.f ? L : 1.f));
}

template <typename T, typename KV>
int launch_gqa(const void* q, const void* k, const void* v, const void* qpos,
               const void* eff, void* tile_min, const void* rows, void* out,
               void* part_m,
               void* part_l, void* part_acc, int B, int S, int Hq, int Hkv,
               int D, int T_cache, int kv_len, int chunk_tiles, int n_chunks,
               float scale, cudaStream_t st) {
  const int n_tiles = (kv_len + cs::BK - 1) / cs::BK;
  tile_min_kernel<<<dim3(n_tiles, B), cs::BK, 0, st>>>(
      static_cast<const int*>(eff), static_cast<int*>(tile_min), kv_len,
      n_tiles);
  const int R = S * (Hq / Hkv);
  const size_t bytes = cs::tile_smem_floats(D) * sizeof(float) +
                       (2 * cs::BR + cs::NT / 32 + chunk_tiles) * sizeof(int);
  auto kern = gqa_attention_kernel<T, KV>;
  // once per instantiation, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((R + cs::BR - 1) / cs::BR, B * Hkv, n_chunks);
  kern<<<grid, cs::NT, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(eff), static_cast<const int*>(tile_min),
      static_cast<const int*>(rows), static_cast<T*>(out),
      static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), S, Hq, Hkv,
      D, T_cache, kv_len, chunk_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

// K3: the tensor-core prefill tile (see the header), 4 warps of MT
// m-tiles. F8: k and v are e4m3 bytes, copied into two byte stages and
// widened once a block into two bf16 tiles that the bf16 body reads, by
// 8 warps (MT = 2 or 1) or 4 (MT = 1).
constexpr int TC_WARPS = 4;

// K/V element type of a tensor-core kernel: e4m3 bytes or bf16
template <bool F8>
using KVT = typename std::conditional<F8, uint8_t, tc::bf16>::type;

// K (or V) bytes of one K4 key tile in shared memory: bf16 rows of KS
// elements, or e4m3 rows of D bytes
template <int D, bool F8>
__host__ __device__ constexpr int tile_bytes() {
  return F8 ? tc::BK * D : tc::BK * tc::stride(D) * 2;
}

// NW warps of MT m-tiles: bf16 takes 4 warps; e4m3 4 or 8 (a tile is
// widened once for the block's 16 NW MT rows), see dispatch_prefill_tc
template <int D, int MT, int NW, bool F8>
__global__ void __launch_bounds__(NW * 32, F8 ? 1 : 2)
gqa_prefill_tc_kernel(const tc::bf16* __restrict__ q,
                      const KVT<F8>* __restrict__ k,
                      const KVT<F8>* __restrict__ v,
                      const int* __restrict__ qpos,
                      const int* __restrict__ eff,
                      const int* __restrict__ tile_mm,
                      const int* __restrict__ rows,
                      tc::bf16* __restrict__ out, int B, int S, int Hq,
                      int Hkv, int T_cache, int kv_len, float scale2) {
  constexpr int WR = 16 * MT, BR = NW * WR, NT = 32 * NW, BK = tc::BK;
  constexpr int KS = tc::stride(D), CH = D / 8;  // 16-byte Q chunks per row
  // K/V: 16-byte chunks of a global row, elements per chunk, bf16 tiles,
  // position slots (F8: three, so a copy never waits for a barrier)
  constexpr int CHK = D * sizeof(KVT<F8>) / 16;
  constexpr int EPC = 16 / sizeof(KVT<F8>);
  constexpr int NSB = 2, NCP = F8 ? 3 : 2;
  const int n_tiles = (kv_len + BK - 1) / BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc::bf16* Qs = reinterpret_cast<tc::bf16*>(smem_raw);
  tc::bf16* Ks = Qs + BR * KS;                    // NSB tiles
  tc::bf16* Vs = Ks + NSB * BK * KS;              // NSB tiles
  uint8_t* K8 = reinterpret_cast<uint8_t*>(Vs + NSB * BK * KS);  // F8: 2
  uint8_t* V8 = K8 + (F8 ? 2 * BK * D : 0);       // stages of e4m3 rows
  int* cpos = reinterpret_cast<int*>(V8 + (F8 ? 2 * BK * D : 0));  // NCP
  int* rpos = cpos + NCP * BK;
  int* red = rpos + BR;
  int* tmin = red + NW;
  int* tmax = tmin + n_tiles;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = Hq / Hkv, R = S * G;
  const int b = blockIdx.y / Hkv, h = blockIdx.y % Hkv;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BR;  // last rows first
  const size_t tok = (size_t)Hkv * D;             // K/V token stride
  const size_t kv_row = rows ? rows[b] : b;  // the cache row of input row b
  const KVT<F8>* kb = k + kv_row * T_cache * tok + (size_t)h * D;
  const KVT<F8>* vb = v + kv_row * T_cache * tok + (size_t)h * D;
  const int* effb = eff + (size_t)b * kv_len;

  for (int i = tid; i < BR * CH; i += NT) {
    const int rr = i / CH, c = i % CH, r = r0 + rr;
    const tc::bf16* src = q;
    if (r < R)
      src = q + (((size_t)b * S + r / G) * Hq + h * G + r % G) * D + c * 8;
    tc::cp_async16(Qs + rr * KS + c * 8, src, r < R);
  }
  tc::cp_async_commit();
  int my = -1;
  if (tid < BR) {
    const int r = r0 + tid;
    my = r < R ? qpos[(size_t)b * S + r / G] : -1;
    rpos[tid] = my;
  }
  my = cs::warp_max_i(my);
  if (lane == 0) red[warp] = my;
  for (int i = tid; i < n_tiles; i += NT) {
    tmin[i] = tile_mm[(size_t)b * n_tiles + i];
    tmax[i] = tile_mm[((size_t)B + b) * n_tiles + i];
  }
  __syncthreads();
  int qmax = red[0];
  for (int w = 1; w < NW; ++w) qmax = max(qmax, red[w]);
  int last = -1;  // the last tile any row of the block can see
  for (int i = tid; i < n_tiles; i += NT)
    if (tmin[i] <= qmax) last = i;
  last = cs::warp_max_i(last);
  __syncthreads();  // every thread has read qmax out of red
  if (lane == 0) red[warp] = last;
  __syncthreads();
  last = red[0];
  for (int w = 1; w < NW; ++w) last = max(last, red[w]);
  const int end = last + 1;

  auto next = [&](int t) {  // uniform across the block
    while (t < end && tmin[t] > qmax) ++t;
    return t;
  };
  // tile t into K/V stage `stage` (bf16 tiles, or F8's byte stages) and
  // its positions into slot `slot`
  auto load = [&](int t, int stage, int slot) {
    const int k0 = t * BK;
    // destination rows: the bf16 tile's (stride KS), or F8's byte stage
    unsigned char* kd = F8 ? K8 + stage * BK * D
        : reinterpret_cast<unsigned char*>(Ks + stage * BK * KS);
    unsigned char* vd = F8 ? V8 + stage * BK * D
        : reinterpret_cast<unsigned char*>(Vs + stage * BK * KS);
    constexpr int DST = F8 ? D : KS * 2;  // destination row bytes
    for (int i = tid; i < BK * CHK; i += NT) {
      const int c = i / CHK, ch = i % CHK;
      const bool ok = k0 + c < kv_len;  // ragged last tile: zero rows
      const size_t off = ok ? (size_t)(k0 + c) * tok + ch * EPC : 0;
      tc::cp_async16(kd + c * DST + ch * 16, kb + off, ok);
      tc::cp_async16(vd + c * DST + ch * 16, vb + off, ok);
    }
    for (int c = tid; c < BK; c += NT) {
      int* dst = cpos + slot * BK + c;
      if (k0 + c < kv_len)
        tc::cp_async4(dst, effb + k0 + c);
      else
        *dst = cs::SENTINEL;
    }
    tc::cp_async_commit();
  };
  // F8: the byte stage's K and V into bf16 tile sb, each thread its chunks
  auto widen = [&](int stage, int sb) {
    tc::e4m3_tile<D>(Ks + sb * BK * KS, K8 + stage * BK * D, tid, NT);
    tc::e4m3_tile<D>(Vs + sb * BK * KS, V8 + stage * BK * D, tid, NT);
  };

  tc::State<D, MT> st;
  st.init();
  int t = next(0), stage = 0;
  if (t < end) load(t, 0, 0);
  tc::cp_async_wait<0>();
  __syncthreads();
  const tc::bf16* Qw = Qs + warp * WR * KS;  // this warp's rows
  int rp[MT][2], wmin = cs::SENTINEL;  // wmin: the warp's smallest row
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rp[m][i] = rpos[warp * WR + m * 16 + i * 8 + (lane >> 2)];
      wmin = min(wmin, rp[m][i]);
    }
  wmin = cs::warp_min_i(wmin);
  // a tile whose largest position every row of the warp has reached (a
  // padded row, -1, has reached none) needs no compare
  auto math = [&](int tt, int sb, int slot) {
    const int* cp = cpos + slot * BK;
    tc::attend<D, MT>(Qw, Ks + sb * BK * KS, Vs + sb * BK * KS, scale2,
                      tmax[tt] <= wmin,
                      [=](int m, int i, int c) { return rp[m][i] >= cp[c]; },
                      st);
  };
  if constexpr (!F8) {
    while (t < end) {
      const int tn = next(t + 1);
      if (tn < end) {  // the next tile's copy overlaps this tile's math
        load(tn, stage ^ 1, stage ^ 1);
        tc::cp_async_wait<1>();
      } else {
        tc::cp_async_wait<0>();
      }
      __syncthreads();
      math(t, stage, stage);
      __syncthreads();  // this stage consumed before it is refilled
      t = tn;
      stage ^= 1;
    }
  } else {
    // two bf16 tiles, one barrier a tile: tile t's math and tile t1's
    // widening run between the same two barriers, while the bytes of t2
    // land in the stage that t's bytes left
    int t1 = t < end ? next(t + 1) : end, slot = 0, sb = 0;
    if (t1 < end) load(t1, 1, 1);
    if (t < end) widen(0, 0);
    stage = 1;  // t1's byte stage
    while (t < end) {
      tc::cp_async_wait<0>();  // t1's bytes
      __syncthreads();
      const int t2 = t1 < end ? next(t1 + 1) : end;
      if (t2 < end) load(t2, stage ^ 1, slot == 0 ? NCP - 1 : slot - 1);
      if (t1 < end) widen(stage, sb ^ 1);
      math(t, sb, slot);
      t = t1;
      t1 = t2;
      stage ^= 1;
      sb ^= 1;
      slot = slot == NCP - 1 ? 0 : slot + 1;
    }
  }
  tc::finish(st);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + warp * WR + m * 16 + i * 8 + (lane >> 2);
      if (r < R)
        tc::store_row(
            st, m, i,
            out + (((size_t)b * S + r / G) * Hq + h * G + r % G) * D);
    }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

template <int D, int MT, int NW, bool F8>
int launch_prefill_tc(const void* q, const void* k, const void* v,
                      const void* qpos, const void* eff, const void* tile_mm,
                      const void* rows, void* out, int B, int S, int Hq,
                      int Hkv, int T_cache, int kv_len, float scale2,
                      cudaStream_t st) {
  constexpr int BR = NW * 16 * MT, NSB = 2, NCP = F8 ? 3 : 2;
  auto kern = gqa_prefill_tc_kernel<D, MT, NW, F8>;
  // once per instantiation, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_tiles = (kv_len + tc::BK - 1) / tc::BK;
  // Q, the bf16 K/V tiles (F8: plus two stages of e4m3 rows), then the
  // positions
  const size_t bytes =
      (size_t)(BR + 2 * NSB * tc::BK) * tc::stride(D) * sizeof(tc::bf16) +
      (F8 ? (size_t)4 * tc::BK * D : 0) +
      (size_t)(NCP * tc::BK + BR + NW + 2 * n_tiles) * sizeof(int);
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const int R = S * (Hq / Hkv);
  const dim3 grid((R + BR - 1) / BR, B * Hkv);
  kern<<<grid, NW * 32, bytes, st>>>(
      static_cast<const tc::bf16*>(q), static_cast<const KVT<F8>*>(k),
      static_cast<const KVT<F8>*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(eff), static_cast<const int*>(tile_mm),
      static_cast<const int*>(rows), static_cast<tc::bf16*>(out), B, S, Hq,
      Hkv, T_cache, kv_len, scale2);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool F8>
int dispatch_prefill_tc(const void* q, const void* k, const void* v,
                        const void* qpos, const void* eff,
                        const void* tile_mm, const void* rows, void* out,
                        int B, int S, int Hq, int Hkv, int T_cache,
                        int kv_len, float scale2, cudaStream_t st) {
  const int R = S * (Hq / Hkv), bh = B * Hkv, sms = sm_count();
#define CS_LAUNCH_PREFILL(MT, NW)                                           \
  return launch_prefill_tc<D, MT, NW, F8>(q, k, v, qpos, eff, tile_mm, rows, \
                                          out, B, S, Hq, Hkv, T_cache,       \
                                          kv_len, scale2, st)
  if constexpr (F8) {
    // each block holds an SM: the fewest waves of blocks weighted by a
    // block's time a tile, measured on the H100 as 17 : 11 : 10 for 256
    // (8 warps, 2 m-tiles), 128 (8 warps) and 64 rows (4 warps)
    auto cost = [&](int rows_a_block, int weight) {
      return ((R + rows_a_block - 1) / rows_a_block * bh + sms - 1) / sms *
             weight;
    };
    const int c256 = cost(256, 17), c128 = cost(128, 11), c64 = cost(64, 10);
    if (c256 <= c128 && c256 <= c64) CS_LAUNCH_PREFILL(2, 8);
    if (c128 <= c64) CS_LAUNCH_PREFILL(1, 8);
    CS_LAUNCH_PREFILL(1, 4);
  } else {
    // 128-row blocks (2 m-tiles per warp) unless they would leave SMs idle
    if ((R + 127) / 128 * bh >= sms) CS_LAUNCH_PREFILL(2, TC_WARPS);
    CS_LAUNCH_PREFILL(1, TC_WARPS);
  }
#undef CS_LAUNCH_PREFILL
}

// K4's Q rows in shared memory (stride KS): copied as they are, or for an
// e4m3 cache with the head dims permuted as tc::f8_q_col says, in 4-byte
// words; rows r0 + [0, NR) of (batch b, kv head h), zero past R
template <int D, int NR, bool F8>
__device__ __forceinline__ void stage_q(tc::bf16* Qs,
                                        const tc::bf16* __restrict__ q,
                                        int b, int h, int r0, int R, int S,
                                        int Hq, int G, int tid, int nt) {
  constexpr int KS = tc::stride(D);
  constexpr int W = F8 ? D / 2 : D / 8;  // copies a row: words or chunks
  for (int i = tid; i < NR * W; i += nt) {
    const int rr = i / W, c = i % W, r = r0 + rr;
    const tc::bf16* src = q;
    if (r < R)
      src = q + (((size_t)b * S + r / G) * Hq + h * G + r % G) * D;
    if constexpr (F8) {
      tc::cp_async4(Qs + rr * KS + tc::f8_q_col<D>(2 * c), src + 2 * c,
                    r < R);
    } else {
      tc::cp_async16(Qs + rr * KS + c * 8, src + c * 8, r < R);
    }
  }
}

// destination byte offset of chunk ch (16 bytes) of key row c in a K4 K/V
// tile: bf16 rows of stride KS, or e4m3 rows swizzled by tc::swz
template <int D, bool F8>
__device__ __forceinline__ int tile_chunk(int c, int ch) {
  if constexpr (F8) {
    return c * D + 16 * (ch ^ tc::swz<D>(c));
  } else {
    return c * tc::stride(D) * 2 + ch * 16;
  }
}

// K4 in bf16: the decode-shaped tensor-core kernel (see the header). A
// block of NW warps owns the RB = 16 * MT folded rows r0 + [0, RB) of one
// (batch, kv head) and the key tiles [t_begin, t_end) of one split; warp
// w takes tiles t_begin + w, + NW, ... each with its own online softmax.
// F8: k and v are e4m3 bytes; a warp keeps its K and V tiles' bytes and
// widens their fragments in registers (tc::scores_f8, tc::accumulate_f8).
// A block has 4 warps, or 8 over an e4m3 cache: a warp's tile costs more
// there (the widening lies on the warp's chain) and its bytes half as
// much shared memory, so a split's tiles spread over twice the warps
// (decode_plan rounds an e4m3 split up to whole tiles for the 8).
template <bool F8>
__host__ __device__ constexpr int dec_warps() {
  return F8 ? 8 : 4;
}

// shared-memory bytes of the K4 warps' K and V tiles, which the warps'
// merge (m, l and O rows of 16 MT rows each, f32) overlays afterwards
template <int D, int MT, bool F8>
__host__ __device__ constexpr int dec_kv_bytes() {
  constexpr int NW = dec_warps<F8>();
  return 2 * NW * tile_bytes<D, F8>() > NW * 16 * MT * (D + 2) * 4
             ? 2 * NW * tile_bytes<D, F8>()
             : NW * 16 * MT * (D + 2) * 4;
}

template <int D, int MT, bool F8>
__global__ void __launch_bounds__(dec_warps<F8>() * 32)
gqa_decode_tc_kernel(const tc::bf16* __restrict__ q,
                     const KVT<F8>* __restrict__ k,
                     const KVT<F8>* __restrict__ v,
                     const int* __restrict__ qpos,
                     const int* __restrict__ eff,
                     const int* __restrict__ rows, float* __restrict__ part_ml,
                     float* __restrict__ part_acc, int* __restrict__ tickets,
                     tc::bf16* __restrict__ out, int S, int Hq, int Hkv,
                     int T_cache, int kv_len, int tiles_per_split,
                     float scale2) {
  constexpr int NW = dec_warps<F8>(), NT = 32 * NW, RB = 16 * MT;
  constexpr int BK = tc::BK;
  constexpr int KS = tc::stride(D), D4 = D / 4;
  // K/V: 16-byte chunks of a global row, elements per chunk
  constexpr int CHK = D * sizeof(KVT<F8>) / 16;
  constexpr int EPC = 16 / sizeof(KVT<F8>);
  constexpr int TB = tile_bytes<D, F8>();
  constexpr int WS = RB * (D + 2);  // merge floats per warp: m, l, O rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc::bf16* Qs = reinterpret_cast<tc::bf16*>(smem_raw);
  // per warp a K and a V tile of TB bytes
  unsigned char* KV = reinterpret_cast<unsigned char*>(Qs + RB * KS);
  int* cpos_all = reinterpret_cast<int*>(KV + dec_kv_bytes<D, MT, F8>());
  int* last = cpos_all + NW * BK;
  float* mrg = reinterpret_cast<float*>(KV);  // after the tiles: NW x WS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, n_splits = gridDim.x, bh = blockIdx.y;
  const int b = bh / Hkv, h = bh % Hkv;
  const int G = Hq / Hkv, R = S * G, r0 = blockIdx.z * RB;
  const int RL = min(RB, R - r0);  // this block's real rows
  const int n_tiles = (kv_len + BK - 1) / BK;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const size_t tok = (size_t)Hkv * D;  // K/V token stride
  const size_t kv_row = rows ? rows[b] : b;  // the cache row of input row b
  const KVT<F8>* kb = k + kv_row * T_cache * tok + (size_t)h * D;
  const KVT<F8>* vb = v + kv_row * T_cache * tok + (size_t)h * D;
  const int* effb = eff + (size_t)b * kv_len;
  auto out_row = [&](int r) {  // folded row r of the block -> out
    const int rr = r0 + r;
    return out + (((size_t)b * S + rr / G) * Hq + h * G + rr % G) * D;
  };

  stage_q<D, RB, F8>(Qs, q, b, h, r0, R, S, Hq, G, tid, NT);  // zero past R
  tc::cp_async_commit();
  // the thread's row positions (-1 past R); every warp holds all RB rows,
  // so warp reductions give the block's largest position (qmax) and the
  // smallest over its real rows (rmin: a padded query, -1, makes it -1)
  int rp[MT][2], qmax = -1, rmin = cs::SENTINEL;
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 16 * t + 8 * i + (lane >> 2);
      rp[t][i] = r < R ? qpos[(size_t)b * S + r / G] : -1;
      qmax = max(qmax, rp[t][i]);
      if (r < R) rmin = min(rmin, rp[t][i]);
    }
  qmax = cs::warp_max_i(qmax);
  rmin = cs::warp_min_i(rmin);

  // the warp's K and V tiles
  unsigned char* Kd = KV + warp * 2 * TB;
  unsigned char* Vd = Kd + TB;
  int* cpos = cpos_all + warp * BK;
  auto load = [&](unsigned char* dst, const KVT<F8>* src, int t) {
    const int k0 = t * BK;
    for (int i = lane; i < BK * CHK; i += 32) {
      const int c = i / CHK, ch = i % CHK;
      const bool ok = k0 + c < kv_len;  // ragged last tile: zero rows
      const size_t off = ok ? (size_t)(k0 + c) * tok + ch * EPC : 0;
      tc::cp_async16(dst + tile_chunk<D, F8>(c, ch), src + off, ok);
    }
    tc::cp_async_commit();
  };
  // the lane's two eff positions of tile t (SENTINEL past kv_len)
  auto fetch = [&](int t, int& e0, int& e1) {
    const int s0 = t * BK + lane;
    e0 = s0 < kv_len ? effb[s0] : cs::SENTINEL;
    e1 = s0 + 32 < kv_len ? effb[s0 + 32] : cs::SENTINEL;
  };
  // from tile t (its positions in e0, e1), the warp's first tile that a
  // row of the block can see; its largest position into emax. A tile no
  // row sees (the empty cache past the write index, a causal tail) is
  // never copied. t_end if none.
  auto settle = [&](int t, int& e0, int& e1, int& emax) {
    while (t < t_end) {
      if (cs::warp_min_i(min(e0, e1)) <= qmax) {
        emax = cs::warp_max_i(max(e0, e1));
        return t;
      }
      t += NW;
      if (t < t_end) fetch(t, e0, e1);
    }
    return t_end;
  };

  tc::State<D, MT> st;
  st.init();
  int e0 = cs::SENTINEL, e1 = cs::SENTINEL, emax = cs::SENTINEL;
  int t = t_begin + warp;
  if (t < t_end) fetch(t, e0, e1);
  t = settle(t, e0, e1, emax);
  if (t < t_end) {
    cpos[lane] = e0;
    cpos[lane + 32] = e1;
    load(Kd, kb, t);
    load(Vd, vb, t);
    tc::cp_async_wait<1>();  // Q and K landed, V may be in flight
  } else {
    tc::cp_async_wait<0>();
  }
  __syncthreads();  // Q rows of every thread
  // per tile: K and V are two copy groups, so the scores run while V
  // lands, the next K lands during P.V and the next V during its scores
  while (t < t_end) {
    int n0 = cs::SENTINEL, n1 = cs::SENTINEL, nmax = cs::SENTINEL;
    if (t + NW < t_end) fetch(t + NW, n0, n1);  // read during the scores
    __syncwarp();                                // K(t), cpos visible
    const int* cp = cpos;
    tc::PFrag<MT> pa;
    // a tile whose largest position every real row has reached needs no
    // compare (pad rows past R see everything then, and are not stored)
    auto visible = [=](int m, int i, int c) { return rp[m][i] >= cp[c]; };
    if constexpr (F8) {
      tc::scores_f8<D, MT>(Qs, Kd, scale2, emax <= rmin, visible, st, pa);
    } else {
      tc::scores<D, MT>(Qs, reinterpret_cast<const tc::bf16*>(Kd), scale2,
                        emax <= rmin, visible, st, pa);
    }
    const int tn = settle(t + NW, n0, n1, nmax);
    __syncwarp();  // K(t) and cpos consumed
    if (tn < t_end) {
      cpos[lane] = n0;
      cpos[lane + 32] = n1;
      load(Kd, kb, tn);
      tc::cp_async_wait<1>();  // V(t)
    } else {
      tc::cp_async_wait<0>();
    }
    __syncwarp();  // V(t) visible
    if constexpr (F8) {
      tc::accumulate_f8<D, MT>(Vd, pa, st);
    } else {
      tc::accumulate<D, MT>(reinterpret_cast<const tc::bf16*>(Vd), pa, st);
    }
    __syncwarp();  // V(t) consumed
    if (tn < t_end) {
      load(Vd, vb, tn);
      tc::cp_async_wait<1>();  // K(tn)
    }
    t = tn;
    emax = nmax;
  }
  tc::finish(st);

  // merge the warps' states in warp order (mrg overlays the warps' tiles)
  __syncthreads();
  float* mw = mrg + warp * WS;
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * t + 8 * i + (lane >> 2);
      if ((lane & 3) == 0) {
        mw[r] = st.m[t][i];
        mw[RB + r] = st.l[t][i];
      }
      float* orow = mw + 2 * RB + r * D;
      if constexpr (F8) {  // head dims (D/4) (lane % 4) + [0, D/4)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int n = 0; n < D / 8; n += 4)
            *reinterpret_cast<float4*>(orow + (D / 4) * (lane & 3) +
                                       e * (D / 8) + n) =
                make_float4(st.o[t][n][2 * i + e], st.o[t][n + 1][2 * i + e],
                            st.o[t][n + 2][2 * i + e],
                            st.o[t][n + 3][2 * i + e]);
      } else {
        const int c0 = (lane & 3) * 2;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<float2*>(orow + n * 8 + c0) =
              make_float2(st.o[t][n][2 * i], st.o[t][n][2 * i + 1]);
      }
    }
  __syncthreads();
  // out: 4 normalized values of row r (0 for a row that saw nothing)
  auto store4 = [&](int r, int g, float4 a, float l) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    *reinterpret_cast<uint2*>(out_row(r) + 4 * g) =
        make_uint2(tc::pack(a.x * inv, a.y * inv),
                   tc::pack(a.z * inv, a.w * inv));
  };
  // weight of a state with max m against the merged max M
  auto weight = [&](float m, float M) {
    return m == -INFINITY ? 0.f : exp2f((m - M) * scale2);
  };
  const size_t slot0 = ((size_t)bh * gridDim.z + blockIdx.z) * n_splits;
  for (int idx = tid; idx < RL * D4; idx += NT) {
    const int r = idx / D4, g = idx % D4;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, mrg[w * WS + r]);
    float L = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* base = mrg + w * WS;
      const float wt = weight(base[r], M);
      const float4 o =
          *reinterpret_cast<const float4*>(base + 2 * RB + r * D + 4 * g);
      L += wt * base[RB + r];
      A.x += wt * o.x;
      A.y += wt * o.y;
      A.z += wt * o.z;
      A.w += wt * o.w;
    }
    if (n_splits == 1) {
      store4(r, g, A, L);
    } else {
      const size_t p = (slot0 + split) * RB + r;
      if (g == 0) reinterpret_cast<float2*>(part_ml)[p] = make_float2(M, L);
      reinterpret_cast<float4*>(part_acc + p * D)[g] = A;
    }
  }
  if (n_splits == 1) return;

  // the last block of this (batch x kv head, row group) to finish merges
  // every split's partial, in split order (deterministic)
  __threadfence();  // this block's partials reach L2 before its ticket
  __syncthreads();
  int* ticket = tickets + (size_t)bh * gridDim.z + blockIdx.z;
  if (tid == 0) *last = atomicAdd(ticket, 1) == n_splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const float2* ml = reinterpret_cast<const float2*>(part_ml);
  for (int idx = tid; idx < RL * D4; idx += NT) {
    const int r = idx / D4, g = idx % D4;
    float M = -INFINITY;
    for (int sp = 0; sp < n_splits; ++sp)
      M = fmaxf(M, __ldcg(ml + (slot0 + sp) * RB + r).x);
    float L = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < n_splits; ++sp) {
      const size_t p = (slot0 + sp) * RB + r;
      const float2 s2 = __ldcg(ml + p);
      const float wt = weight(s2.x, M);
      const float4 o = __ldcg(reinterpret_cast<const float4*>(part_acc +
                                                               p * D) + g);
      L += wt * s2.y;
      A.x += wt * o.x;
      A.y += wt * o.y;
      A.z += wt * o.z;
      A.w += wt * o.w;
    }
    store4(r, g, A, L);
  }
  __syncthreads();  // every partial read
  if (tid == 0) *ticket = 0;  // ready for the next launch
}

template <int D, int MT, bool F8>
int launch_decode_tc(const void* q, const void* k, const void* v,
                     const void* qpos, const void* eff, const void* rows,
                     void* part_ml,
                     void* part_acc, void* tickets, void* out, int B, int S,
                     int Hq, int Hkv, int T_cache, int kv_len,
                     int tiles_per_split, int n_splits, float scale2,
                     cudaStream_t st) {
  constexpr int RB = 16 * MT, NW = dec_warps<F8>();
  auto kern = gqa_decode_tc_kernel<D, MT, F8>;
  // once per instantiation, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t bytes =
      (size_t)RB * tc::stride(D) * sizeof(tc::bf16) +
      (size_t)dec_kv_bytes<D, MT, F8>() +
      (size_t)(NW * tc::BK + 4) * sizeof(int);
  const int R = S * (Hq / Hkv);
  const dim3 grid(n_splits, B * Hkv, (R + RB - 1) / RB);
  kern<<<grid, NW * 32, bytes, st>>>(
      static_cast<const tc::bf16*>(q), static_cast<const KVT<F8>*>(k),
      static_cast<const KVT<F8>*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(eff), static_cast<const int*>(rows),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc),
      static_cast<int*>(tickets),
      static_cast<tc::bf16*>(out), S, Hq, Hkv, T_cache, kv_len,
      tiles_per_split, scale2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 queries only (bf16 goes to cs_gqa_prefill_tc / cs_gqa_decode_tc);
// k and v f32 or e4m3 (kv_dtype). rows: null, or the [B] int32 cache row
// of each input row. part_m == nullptr: K3 on the CUDA-core tile (one
// chunk, normalized output). Otherwise K4's first pass (partials per
// chunk; finish with cs_gqa_combine).
extern "C" int cs_gqa_attention(const void* q, const void* k, const void* v,
                                const void* qpos, const void* eff,
                                void* tile_min, void* out, void* part_m,
                                void* part_l, void* part_acc, int B, int S,
                                int Hq, int Hkv, int D, int T_cache,
                                int kv_len, int chunk_tiles, int n_chunks,
                                float scale, int dtype, int kv_dtype,
                                const void* rows, void* stream) {
  if (dtype != cs::F32 || (kv_dtype != cs::F32 && kv_dtype != cs::E4M3) ||
      D % 4 != 0 || D > 4 * cs::MAX_D4 || Hq % Hkv != 0 ||
      kv_len > T_cache || (part_m == nullptr && n_chunks != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_dtype == cs::E4M3)
    return launch_gqa<float, __nv_fp8_e4m3>(
        q, k, v, qpos, eff, tile_min, rows, out, part_m, part_l, part_acc, B,
        S, Hq, Hkv, D, T_cache, kv_len, chunk_tiles, n_chunks, scale, st);
  return launch_gqa<float, float>(q, k, v, qpos, eff, tile_min, rows, out,
                                  part_m, part_l, part_acc, B, S, Hq, Hkv, D,
                                  T_cache, kv_len, chunk_tiles, n_chunks,
                                  scale, st);
}

// K4 f32's second pass: merge the chunks' partials
extern "C" int cs_gqa_combine(const void* part_m, const void* part_l,
                              const void* part_acc, void* out, int B, int S,
                              int Hq, int Hkv, int D, int n_chunks, int dtype,
                              void* stream) {
  if (dtype != cs::F32) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * Hkv, S * (Hq / Hkv));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gqa_combine_kernel<float><<<grid, D, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<float*>(out), S, Hq,
      Hkv, D, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// K3 in bf16 (head dim 64 or 128): the tile min / max pre-pass into
// tile_mm ([2, B, n_tiles] int32), then the tensor-core prefill tile.
// k and v bf16 or e4m3 (kv_dtype). Normalized output [B, S, Hq, D].
// rows: null, or the [B] int32 cache row of each input row (k, v are then
// [B_pool, T_cache, Hkv, D]).
extern "C" int cs_gqa_prefill_tc(const void* q, const void* k, const void* v,
                                 const void* qpos, const void* eff,
                                 void* tile_mm, void* out, int B, int S,
                                 int Hq, int Hkv, int D, int T_cache,
                                 int kv_len, float scale, int kv_dtype,
                                 const void* rows, void* stream) {
  if ((D != 64 && D != 128) || Hq % Hkv != 0 || kv_len > T_cache ||
      (kv_dtype != cs::BF16 && kv_dtype != cs::E4M3))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (kv_len + cs::BK - 1) / cs::BK;
  if (n_tiles > 0)
    tile_minmax_kernel<<<dim3(n_tiles, B), cs::BK, 0, st>>>(
        static_cast<const int*>(eff), static_cast<int*>(tile_mm), B, kv_len,
        n_tiles);
  const float scale2 = scale * tc::LOG2E;
#define CS_PREFILL_TC(DD, F8)                                              \
  if (D == DD && (kv_dtype == cs::E4M3) == F8)                             \
    return dispatch_prefill_tc<DD, F8>(q, k, v, qpos, eff, tile_mm, rows,  \
                                       out, B, S, Hq, Hkv, T_cache, kv_len, \
                                       scale2, st);
  CS_PREFILL_TC(128, false) CS_PREFILL_TC(128, true)
  CS_PREFILL_TC(64, false) CS_PREFILL_TC(64, true)
#undef CS_PREFILL_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4 in bf16 (head dim 64 or 128, mt in {1, 2}: m-tiles per warp, so
// 16 * mt folded rows per block; k and v bf16 or e4m3, kv_dtype): one
// launch per decode attention call.
// part_ml ([slots, 16 mt] float2), part_acc ([slots, 16 mt, D] f32) and
// tickets ([B * Hkv * row groups] int32, zero between launches) are the
// caller's workspace, slots = B * Hkv * row groups * n_splits; they are
// not touched when n_splits == 1. Normalized output [B, S, Hq, D].
// rows: null, or the [B] int32 cache row of each input row.
extern "C" int cs_gqa_decode_tc(const void* q, const void* k, const void* v,
                                const void* qpos, const void* eff,
                                void* part_ml, void* part_acc, void* tickets,
                                void* out, int B, int S, int Hq, int Hkv,
                                int D, int T_cache, int kv_len, int mt,
                                int tiles_per_split, int n_splits,
                                float scale, int kv_dtype, const void* rows,
                                void* stream) {
  const int n_tiles = (kv_len + cs::BK - 1) / cs::BK;
  if ((D != 64 && D != 128) || Hq % Hkv != 0 || kv_len > T_cache ||
      kv_len <= 0 || S <= 0 || B <= 0 || tiles_per_split <= 0 ||
      n_splits <= 0 || (long long)n_splits * tiles_per_split < n_tiles ||
      (kv_dtype != cs::BF16 && kv_dtype != cs::E4M3))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale2 = scale * tc::LOG2E;
  const bool f8 = kv_dtype == cs::E4M3;
#define CS_DECODE_TC(DD, MM, F8)                                           \
  if (D == DD && mt == MM && f8 == F8)                                     \
    return launch_decode_tc<DD, MM, F8>(                                   \
        q, k, v, qpos, eff, rows, part_ml, part_acc, tickets, out, B, S,   \
        Hq, Hkv, T_cache, kv_len, tiles_per_split, n_splits, scale2, st);
  CS_DECODE_TC(128, 1, false) CS_DECODE_TC(128, 2, false)
  CS_DECODE_TC(64, 1, false) CS_DECODE_TC(64, 2, false)
  CS_DECODE_TC(128, 1, true) CS_DECODE_TC(128, 2, true)
  CS_DECODE_TC(64, 1, true) CS_DECODE_TC(64, 2, true)
#undef CS_DECODE_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

// warps a block of cs_gqa_decode_tc over a kv_dtype cache (decode_plan
// in ops/lm_attention.py rounds an e4m3 split up to whole tiles for them)
extern "C" int cs_decode_tc_warps(int kv_dtype) {
  return kv_dtype == cs::E4M3 ? dec_warps<true>() : dec_warps<false>();
}
