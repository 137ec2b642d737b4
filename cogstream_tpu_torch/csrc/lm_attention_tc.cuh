// The tensor-core kernels of K3 (prefill) and K4 (decode) over the
// position-tagged KV cache, templated on the cache's K/V kind (a cs::DType
// code: bf16, e4m3, e5m2, f16 or f32; the queries are bf16). The design
// is in lm_attention.cu's header. Each kind's instances are built in a
// translation unit of their own (lm_attention.cu: bf16, with the C
// entries; lm_attention_<kind>.cu: the others), each defining its
// prefill_tc_<kind> / decode_tc_<kind>, so that nvcc builds them at once.
#pragma once

#include <climits>

#include "common.cuh"
#include "tc_tile.cuh"

namespace {

constexpr int MAX_SMEM = 232448;  // 227 KB: a block's dynamic shared memory

// K3: the tensor-core prefill tile (see lm_attention.cu), 4 warps of MT
// m-tiles over a bf16 cache, two blocks an SM. The body reads two bf16 K
// and V tiles; another K/V kind KV (a cs::DType code) reaches them so:
//  - f16, f32 (rounded to bf16): after tile t's math each thread loads its
//    chunks of tile t + 1 into registers, rounds them and stores them into
//    the free bf16 tile (tc::chunk_to_bf16), one barrier a tile: no byte
//    stage, so a block holds bf16's tiles and Q only (140 KB at 256 rows,
//    D = 128). 8 warps at 256 (MT = 2) or 128 rows (MT = 1), one block an
//    SM; f16 also 4 warps at 64 rows, two blocks an SM;
//  - e4m3, e5m2: two byte stages, widened once a block into the bf16
//    tiles, by 8 warps (MT = 2 or 1) or 4 (MT = 1), one block an SM.
// The rounding is each element's once a block, so 256-row blocks halve it
// a row against bf16's 128: on the H100, over f16 at the ingest prefill,
// the 128-row 4-warp form (bf16's instance, two blocks an SM) measured
// 1.15x bf16 and the 256-row one 1.03x (PERF.md).
constexpr int TC_WARPS = 4;

using tc::KVT;
using tc::is_f8;

// byte stages of K and V rows in their own width that K3 keeps over a
// cache of kind KV: fp8 two, the others none (f16 and f32 are narrowed in
// registers on their way into the bf16 tile)
__host__ __device__ constexpr int prefill_stages(int kv) {
  return is_f8(kv) ? 2 : 0;
}

// K (or V) bytes of one K4 key tile in shared memory: the cache's own
// rows, bf16 or f16 at stride KS, fp8 or f32 rows of D elements (swizzled)
template <int D, int KV>
__host__ __device__ constexpr int tile_bytes() {
  return is_f8(KV)         ? tc::BK * D
         : KV == cs::F32 ? tc::BK * D * 4
                         : tc::BK * tc::stride(D) * 2;
}

// NW warps of MT m-tiles: bf16 takes 4, two blocks an SM; another kind 4
// or 8 (a tile is converted once for the block's 16 NW MT rows), one
// block an SM at 8 warps or with byte stages, else two; see
// dispatch_prefill_tc
template <int D, int MT, int NW, int KV>
__global__ void __launch_bounds__(
    NW * 32, NW == TC_WARPS && prefill_stages(KV) == 0 ? 2 : 1)
gqa_prefill_tc_kernel(const tc::bf16* __restrict__ q,
                      const KVT<KV>* __restrict__ k,
                      const KVT<KV>* __restrict__ v,
                      const int* __restrict__ qpos,
                      const int* __restrict__ eff,
                      const int* __restrict__ tile_mm,
                      const int* __restrict__ rows,
                      tc::bf16* __restrict__ out, int B, int S, int Hq,
                      int Hkv, int T_cache, int kv_len, float scale2) {
  constexpr int WR = 16 * MT, BR = NW * WR, NT = 32 * NW, BK = tc::BK;
  constexpr int KS = tc::stride(D), CH = D / 8;  // 16-byte Q chunks per row
  // staged (fp8): K/V rows copied in their own width into NST byte
  // stages, then converted; f16, f32 (NARROW): narrowed in registers into
  // the bf16 tile
  constexpr int NST = prefill_stages(KV);
  constexpr bool ST = NST > 0, NARROW = KV == cs::F16 || KV == cs::F32;
  // K/V: bytes of a global row, its 16-byte chunks, elements per chunk;
  // bf16 tiles, position slots (staged: three, so a copy never waits for
  // a barrier)
  constexpr int RB = D * sizeof(KVT<KV>);
  constexpr int CHK = RB / 16;
  constexpr int EPC = 16 / sizeof(KVT<KV>);
  constexpr int NSB = 2, NCP = ST ? 3 : 2;
  const int n_tiles = (kv_len + BK - 1) / BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc::bf16* Qs = reinterpret_cast<tc::bf16*>(smem_raw);
  tc::bf16* Ks = Qs + BR * KS;                    // NSB tiles
  tc::bf16* Vs = Ks + NSB * BK * KS;              // NSB tiles
  uint8_t* K8 = reinterpret_cast<uint8_t*>(Vs + NSB * BK * KS);  // NST
  uint8_t* V8 = K8 + NST * BK * RB;               // stages of K/V rows
  int* cpos = reinterpret_cast<int*>(V8 + NST * BK * RB);  // NCP
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
  const KVT<KV>* kb = k + kv_row * T_cache * tok + (size_t)h * D;
  const KVT<KV>* vb = v + kv_row * T_cache * tok + (size_t)h * D;
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
  // tile t's positions into slot `slot` (in the caller's copy group)
  auto copy_pos = [&](int t, int slot) {
    const int k0 = t * BK;
    for (int c = tid; c < BK; c += NT) {
      int* dst = cpos + slot * BK + c;
      if (k0 + c < kv_len)
        tc::cp_async4(dst, effb + k0 + c);
      else
        *dst = cs::SENTINEL;
    }
  };
  // tile t into K/V stage `stage` (bf16 tiles, or the staged kinds'
  // stages) and its positions into slot `slot`
  auto load = [&](int t, int stage, int slot) {
    const int k0 = t * BK;
    // destination rows: the bf16 tile's (stride KS), or a stage's
    unsigned char* kd = ST ? K8 + stage * BK * RB
        : reinterpret_cast<unsigned char*>(Ks + stage * BK * KS);
    unsigned char* vd = ST ? V8 + stage * BK * RB
        : reinterpret_cast<unsigned char*>(Vs + stage * BK * KS);
    constexpr int DST = ST ? RB : KS * 2;  // destination row bytes
    for (int i = tid; i < BK * CHK; i += NT) {
      const int c = i / CHK, ch = i % CHK;
      const bool ok = k0 + c < kv_len;  // ragged last tile: zero rows
      const size_t off = ok ? (size_t)(k0 + c) * tok + ch * EPC : 0;
      tc::cp_async16(kd + c * DST + ch * 16, kb + off, ok);
      tc::cp_async16(vd + c * DST + ch * 16, vb + off, ok);
    }
    copy_pos(t, slot);
    tc::cp_async_commit();
  };
  // f16 / f32: tile t's K and V chunks loaded into registers, rounded to
  // bf16 and stored into bf16 tile sb: a thread's N chunks of K, then its
  // N of V, in rounds of up to 8 loads in flight (one round when that is
  // all of them: f16 at 8 warps, D = 128)
  auto narrow = [&](int t, int sb) {
    const int k0 = t * BK;
    constexpr int N = BK * CHK / NT, U = 2 * N < 8 ? 2 * N : 8;
    static_assert(2 * N % U == 0, "whole rounds of loads");
    auto round_trip = [&](int j0) {
      uint4 w[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u, i = j % N * NT + tid, c = i / CHK;
        const KVT<KV>* src = j < N ? kb : vb;
        w[u] = k0 + c < kv_len  // ragged last tile: zero rows
            ? __ldg(reinterpret_cast<const uint4*>(
                  src + (size_t)(k0 + c) * tok + i % CHK * EPC))
            : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u, i = j % N * NT + tid;
        tc::chunk_to_bf16<KV>((j < N ? Ks : Vs) + sb * BK * KS +
                                  i / CHK * KS + i % CHK * EPC,
                              w[u]);
      }
    };
    // the rounds unrolled at MT = 2 only: on the H100 that was faster
    // there, and slower at MT = 1 than the compiler's own choice
    // (tools/k3_instance_probe.py, PERF.md)
    if constexpr (MT == 2) {
#pragma unroll
      for (int j0 = 0; j0 < 2 * N; j0 += U) round_trip(j0);
    } else {
      for (int j0 = 0; j0 < 2 * N; j0 += U) round_trip(j0);
    }
  };
  // staged: the stage's K and V into bf16 tile sb, each thread its chunks
  // (the chunks its load copied)
  auto widen = [&](int stage, int sb) {
    tc::convert_tile<D, KV>(Ks + sb * BK * KS, K8 + stage * BK * RB, tid,
                            NT);
    tc::convert_tile<D, KV>(Vs + sb * BK * KS, V8 + stage * BK * RB, tid,
                            NT);
  };

  tc::State<D, MT> st;
  st.init();
  int t = next(0), stage = 0;
  if (t < end) {
    if constexpr (NARROW) {
      copy_pos(t, 0);
      tc::cp_async_commit();
      narrow(t, 0);
    } else {
      load(t, 0, 0);
    }
  }
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
  if constexpr (NARROW) {
    // f16 / f32, one barrier a tile: after t's math each thread narrows
    // its chunks of t1 into the free bf16 tile
    while (t < end) {
      const int t1 = next(t + 1);
      if (t1 < end) {  // t1's positions land during t's math
        copy_pos(t1, stage ^ 1);
        tc::cp_async_commit();
      }
      math(t, stage, stage);
      if (t1 < end) {
        narrow(t1, stage ^ 1);
        tc::cp_async_wait<0>();
      }
      __syncthreads();  // t1 narrowed, t's tile consumed before its refill
      t = t1;
      stage ^= 1;
    }
  } else if constexpr (!ST) {
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

template <int D, int MT, int NW, int KV>
int launch_prefill_tc(const void* q, const void* k, const void* v,
                      const void* qpos, const void* eff, const void* tile_mm,
                      const void* rows, void* out, int B, int S, int Hq,
                      int Hkv, int T_cache, int kv_len, float scale2,
                      cudaStream_t st) {
  constexpr int NST = prefill_stages(KV);
  constexpr int BR = NW * 16 * MT, NSB = 2, NCP = NST ? 3 : 2;
  auto kern = gqa_prefill_tc_kernel<D, MT, NW, KV>;
  // once per instantiation, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_tiles = (kv_len + tc::BK - 1) / tc::BK;
  // Q, the bf16 K/V tiles (staged: plus NST stages of K and V rows in
  // their own width), then the positions
  const size_t bytes =
      (size_t)(BR + 2 * NSB * tc::BK) * tc::stride(D) * sizeof(tc::bf16) +
      (size_t)2 * NST * tc::BK * D * sizeof(KVT<KV>) +
      (size_t)(NCP * tc::BK + BR + NW + 2 * n_tiles) * sizeof(int);
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const int R = S * (Hq / Hkv);
  const dim3 grid((R + BR - 1) / BR, B * Hkv);
  kern<<<grid, NW * 32, bytes, st>>>(
      static_cast<const tc::bf16*>(q), static_cast<const KVT<KV>*>(k),
      static_cast<const KVT<KV>*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(eff), static_cast<const int*>(tile_mm),
      static_cast<const int*>(rows), static_cast<tc::bf16*>(out), B, S, Hq,
      Hkv, T_cache, kv_len, scale2);
  return static_cast<int>(cudaGetLastError());
}

// rows a block (256, 128 or 64) of the instance with the fewest waves of
// blocks (one an SM), each wave weighted by that instance's time a wave
// (w256, w128, w64; w64 = 0: no 64-row instance); a tie goes to the
// larger block
inline int fewest_waves(int R, int bh, int sms, int w256, int w128,
                        int w64) {
  auto cost = [&](int rows_a_block, int weight) {
    return ((R + rows_a_block - 1) / rows_a_block * bh + sms - 1) / sms *
           weight;
  };
  const int c256 = cost(256, w256), c128 = cost(128, w128);
  const int c64 = w64 ? cost(64, w64) : INT_MAX;
  if (c256 <= c128 && c256 <= c64) return 256;
  return c128 <= c64 ? 128 : 64;
}

template <int D, int KV>
int dispatch_prefill_tc(const void* q, const void* k, const void* v,
                        const void* qpos, const void* eff,
                        const void* tile_mm, const void* rows, void* out,
                        int B, int S, int Hq, int Hkv, int T_cache,
                        int kv_len, float scale2, cudaStream_t st) {
  const int R = S * (Hq / Hkv), bh = B * Hkv, sms = sm_count();
#define CS_LAUNCH_PREFILL(MT, NW)                                           \
  return launch_prefill_tc<D, MT, NW, KV>(q, k, v, qpos, eff, tile_mm, rows, \
                                          out, B, S, Hq, Hkv, T_cache,       \
                                          kv_len, scale2, st)
  if constexpr (KV == cs::F32) {
    // 256 (2 m-tiles) or 128 rows, 8 warps, by the fewest waves of one
    // block an SM weighted 20 : 14, a block's time a wave on the H100
    // (tools/k3_instance_probe.py: the pick is within 4% of the faster
    // instance at each of its 9 prefills). No 64-row instance: its 4 warps
    // narrow 32 f32 chunks a thread a tile, and their loads' latency made
    // it slower than 128 rows at every prefill measured (S = 40 to 4384)
    if (fewest_waves(R, bh, sms, 20, 14, 0) == 256) CS_LAUNCH_PREFILL(2, 8);
    CS_LAUNCH_PREFILL(1, 8);
  } else if constexpr (KV != cs::BF16) {
    // 256 (8 warps, 2 m-tiles), 128 (8 warps) or 64 rows (4 warps) by the
    // fewest waves of one block an SM, each weighted by a block's time a
    // wave, measured on the H100 over e4m3 as 17 : 11 : 10 (e5m2 takes
    // e4m3's weights; over f16 they pick the fastest of the three at each
    // of tools/k3_instance_probe.py's 9 prefills)
    const int rows_a_block = fewest_waves(R, bh, sms, 17, 11, 10);
    if (rows_a_block == 256) CS_LAUNCH_PREFILL(2, 8);
    if (rows_a_block == 128) CS_LAUNCH_PREFILL(1, 8);
    CS_LAUNCH_PREFILL(1, 4);
  } else {
    // bf16: 128-row blocks (2 m-tiles per warp) unless they would leave
    // SMs idle
    if ((R + 127) / 128 * bh >= sms) CS_LAUNCH_PREFILL(2, TC_WARPS);
    CS_LAUNCH_PREFILL(1, TC_WARPS);
  }
#undef CS_LAUNCH_PREFILL
}

// K4's Q rows in shared memory (stride KS): copied as they are, or for an
// fp8 cache with the head dims permuted as tc::f8_q_col says, in 4-byte
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

// destination byte offset of chunk ch (16 bytes) of key row c in a K4
// K (or, is_v, V) tile of kind KV: bf16 or f16 rows of stride KS, fp8
// rows swizzled by tc::swz, f32 rows by tc::f32_k_chunk / f32_v_chunk
template <int D, int KV>
__device__ __forceinline__ int tile_chunk(int c, int ch, bool is_v) {
  if constexpr (is_f8(KV)) {
    return c * D + 16 * (ch ^ tc::swz<D>(c));
  } else if constexpr (KV == cs::F32) {
    return c * D * 4 +
           16 * (is_v ? tc::f32_v_chunk<D>(c, ch) : tc::f32_k_chunk(c, ch));
  } else {
    return c * tc::stride(D) * 2 + ch * 16;
  }
}

// K4 in bf16: the decode-shaped tensor-core kernel (see lm_attention.cu).
// A block of NW warps owns the RB = 16 * MT folded rows r0 + [0, RB) of
// one (batch, kv head) and the key tiles [t_begin, t_end) of one split;
// warp w takes tiles t_begin + w, + NW, ... each with its own online
// softmax. KV (a cs::DType code) is the cache's kind. Every kind's tile
// is the cache's own bytes, copied by cp.async (K and V of a tile two copy
// groups), and the other kinds' B fragments become bf16 in registers just
// before their MMA: fp8 (e4m3, e5m2) widened (tc::scores_f8,
// tc::accumulate_f8), f16 and f32 rounded to nearest even (tc::scores /
// accumulate<F16>, tc::scores_f32 / accumulate_f32). K4's warps read
// disjoint tiles, so each element is converted once.
// Warps a block by kind (dec_warps; decode_plan in ops/lm_attention.py
// mirrors it): bf16 and f16 4 (f16 keeps bf16's tile layout and bytes);
// fp8 8 (a warp's bytes take half as much shared memory, so a split's
// tiles spread over twice the warps); f32 3 (a warp's f32 K and V tiles
// take 64 KB at D = 128). Every kind but bf16 has its split rounded up to
// whole tiles for its warps (decode_plan).
template <int KV>
__host__ __device__ constexpr int dec_warps() {
  return is_f8(KV) ? 8 : KV == cs::F32 ? 3 : 4;
}

// shared-memory bytes of the K4 warps' K and V tiles, which the warps'
// merge (m, l and O rows of 16 MT rows each, f32) overlays afterwards
template <int D, int MT, int NW, int KV>
__host__ __device__ constexpr int dec_kv_bytes() {
  return 2 * NW * tile_bytes<D, KV>() > NW * 16 * MT * (D + 2) * 4
             ? 2 * NW * tile_bytes<D, KV>()
             : NW * 16 * MT * (D + 2) * 4;
}

template <int D, int MT, int NW, int KV>
__global__ void __launch_bounds__(NW * 32)
gqa_decode_tc_kernel(const tc::bf16* __restrict__ q,
                     const KVT<KV>* __restrict__ k,
                     const KVT<KV>* __restrict__ v,
                     const int* __restrict__ qpos,
                     const int* __restrict__ eff,
                     const int* __restrict__ rows, float* __restrict__ part_ml,
                     float* __restrict__ part_acc, int* __restrict__ tickets,
                     tc::bf16* __restrict__ out, int S, int Hq, int Hkv,
                     int T_cache, int kv_len, int tiles_per_split,
                     float scale2) {
  constexpr bool F8 = is_f8(KV), F32 = KV == cs::F32;
  // O's head dims permuted in the state (fp8, f32: see tc_tile.cuh)
  constexpr bool PERM_O = F8 || F32;
  constexpr int NT = 32 * NW, RB = 16 * MT;
  constexpr int BK = tc::BK;
  constexpr int KS = tc::stride(D), D4 = D / 4;
  // K/V: 16-byte chunks of a global row, elements per chunk
  constexpr int CHK = D * sizeof(KVT<KV>) / 16;
  constexpr int EPC = 16 / sizeof(KVT<KV>);
  constexpr int TB = tile_bytes<D, KV>();
  constexpr int WS = RB * (D + 2);  // merge floats per warp: m, l, O rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc::bf16* Qs = reinterpret_cast<tc::bf16*>(smem_raw);
  // per warp a K and a V tile of TB bytes
  unsigned char* KVs = reinterpret_cast<unsigned char*>(Qs + RB * KS);
  int* cpos_all =
      reinterpret_cast<int*>(KVs + dec_kv_bytes<D, MT, NW, KV>());
  int* last = cpos_all + NW * BK;
  float* mrg = reinterpret_cast<float*>(KVs);  // after the tiles: NW x WS

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
  const KVT<KV>* kb = k + kv_row * T_cache * tok + (size_t)h * D;
  const KVT<KV>* vb = v + kv_row * T_cache * tok + (size_t)h * D;
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
  unsigned char* Kd = KVs + warp * 2 * TB;
  unsigned char* Vd = Kd + TB;
  int* cpos = cpos_all + warp * BK;
  // tile t's K (or V) rows into dst, one copy group
  auto load = [&](unsigned char* dst, const KVT<KV>* src, int t, bool is_v) {
    const int k0 = t * BK;
    for (int i = lane; i < BK * CHK; i += 32) {
      const int c = i / CHK, ch = i % CHK;
      const bool ok = k0 + c < kv_len;  // ragged last tile: zero rows
      const size_t off = ok ? (size_t)(k0 + c) * tok + ch * EPC : 0;
      tc::cp_async16(dst + tile_chunk<D, KV>(c, ch, is_v), src + off, ok);
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
    load(Kd, kb, t, false);
    load(Vd, vb, t, true);
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
      tc::scores_f8<D, MT, KV>(Qs, Kd, scale2, emax <= rmin, visible, st,
                               pa);
    } else if constexpr (F32) {
      tc::scores_f32<D, MT>(Qs, reinterpret_cast<const float*>(Kd), scale2,
                            emax <= rmin, visible, st, pa);
    } else {
      tc::scores<D, MT, KV>(Qs, reinterpret_cast<const tc::bf16*>(Kd),
                            scale2, emax <= rmin, visible, st, pa);
    }
    const int tn = settle(t + NW, n0, n1, nmax);
    __syncwarp();  // K(t) and cpos consumed
    if (tn < t_end) {
      cpos[lane] = n0;
      cpos[lane + 32] = n1;
      load(Kd, kb, tn, false);
      tc::cp_async_wait<1>();  // V(t)
    } else {
      tc::cp_async_wait<0>();
    }
    __syncwarp();  // V(t) visible
    if constexpr (F8) {
      tc::accumulate_f8<D, MT, KV>(Vd, pa, st);
    } else if constexpr (F32) {
      tc::accumulate_f32<D, MT>(reinterpret_cast<const float*>(Vd), pa, st);
    } else {
      tc::accumulate<D, MT, KV>(reinterpret_cast<const tc::bf16*>(Vd), pa,
                                st);
    }
    __syncwarp();  // V(t) consumed
    if (tn < t_end) {
      load(Vd, vb, tn, true);
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
      if constexpr (PERM_O) {  // head dims (D/4) (lane % 4) + [0, D/4)
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

template <int D, int MT, int NW, int KV>
int launch_decode_tc(const void* q, const void* k, const void* v,
                     const void* qpos, const void* eff, const void* rows,
                     void* part_ml,
                     void* part_acc, void* tickets, void* out, int B, int S,
                     int Hq, int Hkv, int T_cache, int kv_len,
                     int tiles_per_split, int n_splits, float scale2,
                     cudaStream_t st) {
  constexpr int RB = 16 * MT;
  auto kern = gqa_decode_tc_kernel<D, MT, NW, KV>;
  // once per instantiation, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t bytes =
      (size_t)RB * tc::stride(D) * sizeof(tc::bf16) +
      (size_t)dec_kv_bytes<D, MT, NW, KV>() +
      (size_t)(NW * tc::BK + 4) * sizeof(int);
  static_assert(RB * tc::stride(D) * 2 + dec_kv_bytes<D, MT, NW, KV>() +
                        (NW * tc::BK + 4) * 4 <= MAX_SMEM,
                "a K4 block's shared memory");
  const int R = S * (Hq / Hkv);
  const dim3 grid(n_splits, B * Hkv, (R + RB - 1) / RB);
  kern<<<grid, NW * 32, bytes, st>>>(
      static_cast<const tc::bf16*>(q), static_cast<const KVT<KV>*>(k),
      static_cast<const KVT<KV>*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(eff), static_cast<const int*>(rows),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc),
      static_cast<int*>(tickets),
      static_cast<tc::bf16*>(out), S, Hq, Hkv, T_cache, kv_len,
      tiles_per_split, scale2);
  return static_cast<int>(cudaGetLastError());
}

// K3 and K4 on the tensor cores over a cache of kind KV, as a kind's
// translation unit instantiates them: cudaErrorInvalidValue for another
// head dim (64 or 128) or m-tile count (1 or 2)
template <int KV>
int prefill_tc_kind(int D, const void* q, const void* k, const void* v,
                    const void* qpos, const void* eff, const void* tile_mm,
                    const void* rows, void* out, int B, int S, int Hq,
                    int Hkv, int T_cache, int kv_len, float scale2,
                    cudaStream_t st) {
  if (D == 128)
    return dispatch_prefill_tc<128, KV>(q, k, v, qpos, eff, tile_mm, rows,
                                        out, B, S, Hq, Hkv, T_cache, kv_len,
                                        scale2, st);
  if (D == 64)
    return dispatch_prefill_tc<64, KV>(q, k, v, qpos, eff, tile_mm, rows,
                                       out, B, S, Hq, Hkv, T_cache, kv_len,
                                       scale2, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int KV>
int decode_tc_kind(int D, int mt, const void* q, const void* k,
                   const void* v, const void* qpos, const void* eff,
                   const void* rows, void* part_ml, void* part_acc,
                   void* tickets, void* out, int B, int S, int Hq, int Hkv,
                   int T_cache, int kv_len, int tiles_per_split,
                   int n_splits, float scale2, cudaStream_t st) {
#define CS_DECODE_TC(DD, MM)                                               \
  if (D == DD && mt == MM)                                                 \
    return launch_decode_tc<DD, MM, dec_warps<KV>(), KV>(                  \
        q, k, v, qpos, eff, rows, part_ml, part_acc, tickets, out, B, S,   \
        Hq, Hkv, T_cache, kv_len, tiles_per_split, n_splits, scale2, st);
  CS_DECODE_TC(128, 1) CS_DECODE_TC(128, 2)
  CS_DECODE_TC(64, 1) CS_DECODE_TC(64, 2)
#undef CS_DECODE_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// each kind's entries, defined in its translation unit as
// prefill_tc_kind<KV> / decode_tc_kind<KV>
#define CS_LM_KIND(NAME)                                                   \
  int prefill_tc_##NAME(int D, const void* q, const void* k,               \
                        const void* v, const void* qpos, const void* eff,  \
                        const void* tile_mm, const void* rows, void* out,  \
                        int B, int S, int Hq, int Hkv, int T_cache,        \
                        int kv_len, float scale2, cudaStream_t st);        \
  int decode_tc_##NAME(int D, int mt, const void* q, const void* k,        \
                       const void* v, const void* qpos, const void* eff,   \
                       const void* rows, void* part_ml, void* part_acc,    \
                       void* tickets, void* out, int B, int S, int Hq,     \
                       int Hkv, int T_cache, int kv_len,                   \
                       int tiles_per_split, int n_splits, float scale2,    \
                       cudaStream_t st);
CS_LM_KIND(e4m3)
CS_LM_KIND(e5m2)
CS_LM_KIND(f16)
CS_LM_KIND(f32)
#undef CS_LM_KIND
// K3's f32 route (lm_attention_f32q.cu)
int prefill_f32q(int D, int block_rows, const void* q, const void* k,
                 const void* v, const void* qpos, const void* eff,
                 const void* tile_mm, const void* rows, void* out, int B,
                 int S, int Hq, int Hkv, int T_cache, int kv_len, int kv,
                 float scale2, cudaStream_t st);
