// The bf16 tensor-core varlen segment attention kernel of K1
// (vision_attention.cu: 2D RoPE fused in, operands in the fused QKV rows)
// and K5 (segment_attention.cu: no rotation, [N, H, D] rows). One body,
// templated on kRope; the operand layout is a row stride and three column
// bases (q, k, v of head 0; head h adds h * D).
//
// A block of 8 warps owns 256 query rows (four 64-row host tiles, 2
// m-tiles per warp) of one head and walks the 64-key tiles of the union
// of their token ranges [kv_lo, kv_hi) (ops/flash_attention.py
// vision_kv_ranges), streamed by a cp.async double buffer straight from
// the rows (a head's row of D bf16 is a whole number of 16-byte chunks
// for D % 8 == 0; no transpose, no 128-lane pad). The Q.K^T depth is
// padded to a multiple of 16 with zero columns in Q and K (80 at
// D = 72); P.V runs D/8 n-tiles. A warp whose rows and key tile lie in
// one frame skips the segment compare (most tiles: frames are 1008
// tokens). Query i sees key j iff seg[i] == seg[j] >= 0: a pad row (seg
// -1) keeps max -inf and outputs exactly 0.
//
// kRope (K1): each key tile's f32 cos and sin rows are staged with it; q
// is rotated once per block and k once per visiting query block, in place
// in shared memory (each thread 4 pairs (d, d + D/2), f32, one bf16
// rounding), as soon as the tile lands, after the previous tile's math:
// the MMAs only see rotated tiles and the rotation never waits on device
// memory.
#pragma once

#include "common.cuh"
#include "tc_tile.cuh"

namespace {

// q or k pairs (d + j, d + D/2 + j), j < 4, of one row, rotated in
// place: the plain path's x*cos + rotate_half(x)*sin with each product
// and the sum rounded in f32 (no FMA), then one bf16 rounding. d % 4 ==
// 0, so the bf16 halves move as 8 bytes and cos / sin as 16.
template <int D>
__device__ __forceinline__ void rotate4(tc::bf16* row, const float* c,
                                        const float* s, int d) {
  constexpr int HALF = D / 2;
  uint2* pa = reinterpret_cast<uint2*>(row + d);
  uint2* pb = reinterpret_cast<uint2*>(row + d + HALF);
  const uint2 ra = *pa, rb = *pb;
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&ra);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&rb);
  const float x1[4] = {__low2float(a2[0]), __high2float(a2[0]),
                       __low2float(a2[1]), __high2float(a2[1])};
  const float x2[4] = {__low2float(b2[0]), __high2float(b2[0]),
                       __low2float(b2[1]), __high2float(b2[1])};
  const float4 c1 = *reinterpret_cast<const float4*>(c + d);
  const float4 s1 = *reinterpret_cast<const float4*>(s + d);
  const float4 c2 = *reinterpret_cast<const float4*>(c + d + HALF);
  const float4 s2 = *reinterpret_cast<const float4*>(s + d + HALF);
  const float cc1[4] = {c1.x, c1.y, c1.z, c1.w};
  const float ss1[4] = {s1.x, s1.y, s1.z, s1.w};
  const float cc2[4] = {c2.x, c2.y, c2.z, c2.w};
  const float ss2[4] = {s2.x, s2.y, s2.z, s2.w};
  float y1[4], y2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    y1[j] = __fadd_rn(__fmul_rn(x1[j], cc1[j]), __fmul_rn(-x2[j], ss1[j]));
    y2[j] = __fadd_rn(__fmul_rn(x2[j], cc2[j]), __fmul_rn(x1[j], ss2[j]));
  }
  *pa = make_uint2(tc::pack(y1[0], y1[1]), tc::pack(y1[2], y1[3]));
  *pb = make_uint2(tc::pack(y2[0], y2[1]), tc::pack(y2[2], y2[3]));
}

// 8 warps of 2 m-tiles: 256 query rows per block, so each key tile (and
// its cos / sin rows) crosses from L2 once per 256 rows
constexpr int SEG_WARPS = 8, SEG_MT = 2;

template <int D, bool kRope>
__global__ void __launch_bounds__(SEG_WARPS * 32)
segment_tc_kernel(const tc::bf16* __restrict__ q,
                  const tc::bf16* __restrict__ k,
                  const tc::bf16* __restrict__ v, long long row_stride,
                  const float* __restrict__ cosv,
                  const float* __restrict__ sinv,
                  const int* __restrict__ seg, const int* __restrict__ kv_lo,
                  const int* __restrict__ kv_hi, tc::bf16* __restrict__ out,
                  int N, int H, float scale2) {
  constexpr int NW = SEG_WARPS, MT = SEG_MT, WR = 16 * MT, BR = NW * WR;
  constexpr int NT = 32 * NW, BK = tc::BK;
  constexpr int KD = tc::depth(D), KS = tc::stride(D), CH = D / 8;
  constexpr int HALF = D / 2, QT = BR / cs::BR;  // host tiles per block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc::bf16* Qs = reinterpret_cast<tc::bf16*>(smem_raw);
  tc::bf16* Ks = Qs + BR * KS;                    // 2 stages
  tc::bf16* Vs = Ks + 2 * BK * KS;                // 2 stages
  float* cs_ = reinterpret_cast<float*>(Vs + 2 * BK * KS);  // cos | sin
  int* cseg = reinterpret_cast<int*>(cs_ + (kRope ? 2 * BK * D : 0));
  int* rseg = cseg + 2 * BK;                      // cseg: 2 stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, q0 = blockIdx.x * BR;
  const size_t rs = static_cast<size_t>(row_stride);
  q += h * D;
  k += h * D;
  v += h * D;
  const int n_qt = (N + cs::BR - 1) / cs::BR, t0 = blockIdx.x * QT;
  const int lo = kv_lo[t0];
  int hi = kv_hi[t0];
  for (int j = 1; j < QT; ++j)
    if (t0 + j < n_qt) hi = max(hi, kv_hi[t0 + j]);

  // zero Q.K^T depth padding of Q and both K stages (never copied over)
  if constexpr (KD > D) {
    for (int i = tid; i < (BR + 2 * BK) * (KD - D); i += NT)
      Qs[(i / (KD - D)) * KS + D + i % (KD - D)] = __float2bfloat16_rn(0.f);
  }
  for (int i = tid; i < BR * CH; i += NT) {
    const int rr = i / CH, c = i % CH, n = q0 + rr;
    const tc::bf16* src = n < N ? q + n * rs + c * 8 : q;
    tc::cp_async16(Qs + rr * KS + c * 8, src, n < N);
  }
  tc::cp_async_commit();
  if (tid < BR) rseg[tid] = q0 + tid < N ? seg[q0 + tid] : -1;

  // K, V and segment ids of the tile at k0 into a stage; with kRope its
  // cos and sin rows into the one cos | sin buffer (read by rotate()
  // before the next load is issued)
  auto load = [&](int k0, int stage) {
    tc::bf16* kd = Ks + stage * BK * KS;
    tc::bf16* vd = Vs + stage * BK * KS;
    for (int i = tid; i < BK * CH; i += NT) {
      const int c = i / CH, ch = i % CH, n = k0 + c;
      const bool ok = n < hi;  // ragged last tile: zero rows
      const size_t off = ok ? n * rs : 0;
      tc::cp_async16(kd + c * KS + ch * 8, k + off + ch * 8, ok);
      tc::cp_async16(vd + c * KS + ch * 8, v + off + ch * 8, ok);
    }
    // (braced: with an unbraced discarded `if constexpr` statement here,
    // nvcc 12.8 compiled away the rest of the lambda)
    if constexpr (kRope) {
      for (int i = tid; i < BK * (D / 4); i += NT) {
        const int c = i / (D / 4), ch = i % (D / 4), n = k0 + c;
        const size_t off = n < hi ? (size_t)n * D + ch * 4 : 0;
        tc::cp_async16(cs_ + c * D + ch * 4, cosv + off, n < hi);
        tc::cp_async16(cs_ + (BK + c) * D + ch * 4, sinv + off, n < hi);
      }
    }
    for (int c = tid; c < BK; c += NT) {
      int* dst = cseg + stage * BK + c;
      if (k0 + c < hi)
        tc::cp_async4(dst, seg + k0 + c);
      else
        *dst = -2;  // matches no row
    }
    tc::cp_async_commit();
  };
  // rotate the landed tile at k0 in place (its cos | sin are staged)
  auto rotate = [&](int k0, int stage) {
    tc::bf16* kd = Ks + stage * BK * KS;
    const int ncols = min(BK, hi - k0);
    for (int i = tid; i < BK * (HALF / 4); i += NT) {
      const int c = i / (HALF / 4), d = 4 * (i % (HALF / 4));
      if (c < ncols)
        rotate4<D>(kd + c * KS, cs_ + c * D, cs_ + (BK + c) * D, d);
    }
  };

  if (lo < hi) load(lo, 0);
  tc::cp_async_wait<0>();
  __syncthreads();
  if constexpr (kRope) {
    for (int i = tid; i < BR * (HALF / 4); i += NT) {  // q, once per block
      const int rr = i / (HALF / 4), d = 4 * (i % (HALF / 4)), n = q0 + rr;
      if (n < N)
        rotate4<D>(Qs + rr * KS, cosv + (size_t)n * D, sinv + (size_t)n * D,
                   d);
    }
    if (lo < hi) rotate(lo, 0);
    __syncthreads();
  }
  const tc::bf16* Qw = Qs + warp * WR * KS;  // this warp's rows
  int rsg[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      rsg[m][i] = rseg[warp * WR + m * 16 + i * 8 + (lane >> 2)];
  // the warp's one segment, or -1 when its rows hold several or padding
  // (segment ids are non-decreasing runs: first == last means all equal)
  const int wfirst = rseg[warp * WR], wlast = rseg[warp * WR + WR - 1];
  const int wseg = wfirst >= 0 && wfirst == wlast ? wfirst : -1;

  tc::State<D, MT> st;
  st.init();
  int stage = 0;
  for (int k0 = lo; k0 < hi; k0 += BK) {
    const bool more = k0 + BK < hi;
    // the next tile's copy overlaps this tile's math (and, with kRope,
    // its rotation runs before the next tile's math)
    if (more) load(k0 + BK, stage ^ 1);
    const int* cg = cseg + stage * BK;
    // a tile of the warp's own segment only needs no compare
    tc::attend<D, MT>(Qw, Ks + stage * BK * KS, Vs + stage * BK * KS, scale2,
                      wseg >= 0 && cg[0] == wseg && cg[BK - 1] == wseg,
                      [=](int m, int i, int c) {
                        return rsg[m][i] >= 0 && rsg[m][i] == cg[c];
                      },
                      st);
    if (more) {
      tc::cp_async_wait<0>();
      if constexpr (kRope) {
        __syncthreads();
        rotate(k0 + BK, stage ^ 1);
      }
    }
    __syncthreads();  // landed (rotated) before use; this stage consumed
    stage ^= 1;
  }
  tc::finish(st);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = q0 + warp * WR + m * 16 + i * 8 + (lane >> 2);
      if (n < N) tc::store_row(st, m, i, out + (size_t)n * H * D + h * D);
    }
}

constexpr int SEG_MAX_SMEM = 232448;  // 227 KB: a block's dynamic smem

// q, k, v: head 0's columns of row 0; rows row_stride elements apart
template <int D, bool kRope>
int launch_segment_tc(const void* q, const void* k, const void* v,
                      long long row_stride, const void* cosv,
                      const void* sinv, const void* seg, const void* kv_lo,
                      const void* kv_hi, void* out, int n, int heads,
                      float scale2, cudaStream_t st) {
  constexpr int BR = SEG_WARPS * 16 * SEG_MT;
  auto kern = segment_tc_kernel<D, kRope>;
  // once per instantiation, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SEG_MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t bytes =
      (size_t)(BR + 4 * tc::BK) * tc::stride(D) * sizeof(tc::bf16) +
      (kRope ? (size_t)2 * tc::BK * D * sizeof(float) : 0) +
      (size_t)(2 * tc::BK + BR) * sizeof(int);
  const dim3 grid((n + BR - 1) / BR, heads);
  kern<<<grid, SEG_WARPS * 32, bytes, st>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), row_stride,
      static_cast<const float*>(cosv), static_cast<const float*>(sinv),
      static_cast<const int*>(seg), static_cast<const int*>(kv_lo),
      static_cast<const int*>(kv_hi), static_cast<tc::bf16*>(out), n, heads,
      scale2);
  return static_cast<int>(cudaGetLastError());
}

// the head dims the tile takes: D % 8 == 0, D <= 128
#define CS_SEGMENT_TC_DIMS(X)                                              \
  X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64) X(72) X(80) X(88) X(96) \
  X(104) X(112) X(120) X(128)

}  // namespace
