// bf16 tensor-core attention tile for Hopper, shared by the redesigned K1
// and K5 (segment_tc.cuh: vision_attention.cu, segment_attention.cu), K3
// and K4 (lm_attention.cu).
//
// A warp owns MT m-tiles of 16 query rows; a block of warps (4 in K3,
// 8 in K1 / K5) walks 64-key tiles that a cp.async double buffer
// streams into shared memory (the copy of tile j + 1 is in flight while
// tile j is computed); K4's warps each walk their own tiles. Per tile and
// warp:
//   S = Q K^T   mma.sync m16n8k16 bf16 -> f32; Q's A fragments and K's B
//               fragments come from ldmatrix on [row][dim] rows, and
//               each K fragment serves all MT m-tiles;
//   mask        one predicate per S element, on the accumulator fragment
//               (thread holds rows lane/4 and lane/4 + 8, columns
//               8j + 2 (lane % 4) + {0, 1});
//   softmax     online, f32, in the log2 domain; row max over the 4
//               lanes of a quad (row sums stay per lane until finish());
//               a row with nothing visible keeps m = -inf and p = 0 (it
//               outputs exactly 0);
//   O += P V    P rounded to bf16 in registers is the A operand (the S
//               accumulator layout of two n-tiles is the A layout of one
//               k-step), V's B fragments come from ldmatrix.trans.
// attend() runs both stages; scores() and accumulate() run them apart,
// so that a caller can wait for a tile's V after its scores (K4).
// When a warp owns only 16 rows, each warp reads the whole K and V tile
// from shared memory and those reads weigh as much as the MMAs: MT = 2
// halves them per (row, key) pair (K3 went from 2.4 to 1.8 ms on the
// H100 with it).
// K4 over an fp8 cache (e4m3 or e5m2: scores_f8 / accumulate_f8, below)
// keeps no bf16 K/V tile: its B fragments come straight from the tile's
// bytes in shared memory and are widened in registers just before their
// MMA; K4's warps read disjoint tiles, so each element is widened once.
// K3's warps all read each tile, so in registers every warp would widen
// every element (issue-bound, 1.4x its bf16 time on the H100): K3
// converts each tile once a block with convert_tile into a bf16 tile
// (PERF.md); an f16 or f32 cache's chunks are rounded to bf16 in
// registers as each thread stores them into the bf16 tile (chunk_to_bf16).
// Rows are padded in shared memory to KS = KD + 8 bf16 (KD: the head dim
// rounded up to the MMA depth 16): 16-byte row chunks then fall on odd
// multiples of 16 bytes, so the 8 rows of one ldmatrix hit 8 disjoint
// bank groups.
//
// This is the mma.sync (FA2-style) form of the tile, not wgmma: a wgmma
// form of the Q.K^T stage, issued and awaited per tile, measured slower
// on the H100 than this one (PERF.md, findings); wgmma pays off with
// P.V from registers and the next tile's Q.K^T in flight during this
// tile's softmax.
#pragma once

#include <cuda_fp16.h>

#include "common.cuh"

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;         // keys per tile
constexpr int NS = BK / 8;     // S n-tiles of 8 keys per warp
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int depth(int D) { return (D + 15) / 16 * 16; }
__host__ __device__ constexpr int stride(int D) { return depth(D) + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; pred false writes 16 zero bytes (src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
// 4-byte async copy; pred false writes 4 zero bytes (src not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// c += a * b for one m16n8k16 bf16 product with an f32 accumulator
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one bf16x2 register, lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// an f16x2 register -> bf16x2, each half rounded to nearest even (the
// f16 -> f32 step is exact)
__device__ __forceinline__ uint32_t f16x2_to_bf16x2(uint32_t h) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  return pack(f.x, f.y);
}

// B fragments read by ldmatrix from a tile of kind KV as the bf16 MMA
// takes them: bf16 as they are; f16 (an f16 KV cache's own bytes, which
// K4 keeps in the bf16 tile's layout) rounded to bf16 in registers
template <int KV, int N>
__device__ __forceinline__ void to_bf16(uint32_t (&b)[N]) {
  static_assert(KV == cs::BF16 || KV == cs::F16, "a 16-bit tile");
  if constexpr (KV == cs::F16) {
#pragma unroll
    for (int i = 0; i < N; ++i) b[i] = f16x2_to_bf16x2(b[i]);
  }
}

// Online-softmax state of a warp's MT m-tiles of 16 rows: m, l per
// thread row (the thread's rows of m-tile t are 16t + lane/4 and
// 16t + lane/4 + 8 of the warp's rows), O as D/8 n-tile fragments.
template <int D, int MT>
struct State {
  float m[MT][2], l[MT][2];
  float o[MT][D / 8][4];
  __device__ void init() {
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      m[t][0] = m[t][1] = -INFINITY;
      l[t][0] = l[t][1] = 0.f;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        o[t][n][0] = o[t][n][1] = o[t][n][2] = o[t][n][3] = 0.f;
    }
  }
};

// One 64-key tile for the warp's 16 * MT query rows, whose first row is
// Qw in shared memory; Ks / Vs are [BK][KS] bf16 rows. Each K and V
// fragment a warp loads serves its MT m-tiles, so shared-memory reads
// per (row, key) pair fall as 1 / MT. visible(t, i, c): may the thread's
// row i (0: lane/4, 1: lane/4 + 8) of m-tile t see key column c? It is
// not asked when `all_visible` (warp-uniform) says every row of the
// warp sees every column. scale2 = softmax scale * log2(e).
//
// Per score the softmax costs one FFMA and one EX2 (the scale folds into
// the exponent, the running max stays in raw units), plus the mask's
// compare and select where a tile is not wholly visible: on the H100
// this ALU work weighs as much as the MMAs of a D <= 128 tile.
//
// scores(): S = Q K^T, the mask and the online-softmax update of st (m, l,
// O rescaled); P in bf16 A fragments into pa. accumulate(): O += P V.
template <int MT>
using PFrag = uint32_t[MT][NS / 2][4];

template <int D, int MT, class Visible, class Key>
__device__ __forceinline__ void softmax_tile(float (&s)[MT][NS][4],
                                             float scale2, bool all_visible,
                                             Visible visible, Key key,
                                             State<D, MT>& st,
                                             PFrag<MT>& pa);

template <int D, int MT, int KV = cs::BF16, class Visible>
__device__ __forceinline__ void scores(const bf16* Qw, const bf16* Ks,
                                       float scale2, bool all_visible,
                                       Visible visible, State<D, MT>& st,
                                       PFrag<MT>& pa) {
  constexpr int KS = stride(D);
  const int lane = threadIdx.x & 31;
  float s[MT][NS][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < NS; ++j) s[t][j][0] = s[t][j][1] = s[t][j][2] =
        s[t][j][3] = 0.f;
  // S = Q K^T: Q's A fragments per k-step; one ldmatrix.x4 gives the B
  // fragments of 2 key n-tiles
  const bf16* qrow = Qw + ((lane & 7) + ((lane >> 3) & 1) * 8) * KS +
                     (lane >> 4) * 8;
  const bf16* krow = Ks + ((lane & 7) + (lane >> 4) * 8) * KS +
                     ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < depth(D) / 16; ++kk) {
    uint32_t qa[MT][4];
#pragma unroll
    for (int t = 0; t < MT; ++t) ldsm_x4(qa[t], qrow + t * 16 * KS + kk * 16);
#pragma unroll
    for (int j = 0; j < NS; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, krow + j * 8 * KS + kk * 16);
      to_bf16<KV>(b);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        mma(s[t][j], qa[t], b[0], b[1]);
        mma(s[t][j + 1], qa[t], b[2], b[3]);
      }
    }
  }
  softmax_tile<D, MT>(s, scale2, all_visible, visible,
                      [](int j, int c) { return j * 8 + c; }, st, pa);
}

// The mask and the online-softmax update of one tile's scores s (st's m,
// l, O rescaled), and P in bf16 as the A fragments of NS / 2 k-steps into
// pa. key(j, c): the tile's key in column c of S n-tile j.
template <int D, int MT, class Visible, class Key>
__device__ __forceinline__ void softmax_tile(float (&s)[MT][NS][4],
                                             float scale2, bool all_visible,
                                             Visible visible, Key key,
                                             State<D, MT>& st,
                                             PFrag<MT>& pa) {
  const int lane = threadIdx.x & 31;
  // mask on the fragment (masked scores -inf, so exp2 gives 0)
  const int c0 = (lane & 3) * 2;
  if (!all_visible) {
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(t, e >> 1, key(j, c0 + (e & 1))))
            s[t][j][e] = -INFINITY;
  }
  // row max over the quad; P in bf16 as the A fragments of 4 k-steps
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    float mx[2] = {st.m[t][0], st.m[t][1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[t][j][0], s[t][j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[t][j][2], s[t][j][3]));
    }
    float off[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = cs::quad_max(mx[i]);
      // a row that has seen nothing keeps max -inf: offset 0 keeps its
      // exp2(-inf) = 0 instead of NaN
      off[i] = mx[i] == -INFINITY ? 0.f : mx[i] * scale2;
      alpha[i] = exp2f(st.m[t][i] * scale2 - off[i]);
      st.m[t][i] = mx[i];
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(fmaf(s[t][j][e], scale2, -off[e >> 1]));
        ps[e >> 1] += p[e];
      }
      pa[t][j >> 1][(j & 1) * 2 + 0] = pack(p[0], p[1]);
      pa[t][j >> 1][(j & 1) * 2 + 1] = pack(p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) st.l[t][i] = st.l[t][i] * alpha[i] + ps[i];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      st.o[t][n][0] *= alpha[0];
      st.o[t][n][1] *= alpha[0];
      st.o[t][n][2] *= alpha[1];
      st.o[t][n][3] *= alpha[1];
    }
  }
}

template <int D, int MT, int KV = cs::BF16>
__device__ __forceinline__ void accumulate(const bf16* Vs,
                                           const PFrag<MT>& pa,
                                           State<D, MT>& st) {
  constexpr int KS = stride(D);
  const int lane = threadIdx.x & 31;
  // O += P V: one ldmatrix.x4.trans gives the B fragments of 2 head-dim
  // n-tiles (x2 for an odd last one)
  const bf16* vrow = Vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * KS +
                     (lane >> 4) * 8;
#pragma unroll
  for (int k = 0; k < NS / 2; ++k) {
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      if (n + 1 < D / 8) {
        uint32_t b[4];
        ldsm_x4_t(b, vrow + k * 16 * KS + n * 8);
        to_bf16<KV>(b);
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          mma(st.o[t][n], pa[t][k], b[0], b[1]);
          mma(st.o[t][n + 1], pa[t][k], b[2], b[3]);
        }
      } else {
        uint32_t b[2];
        ldsm_x2_t(b, vrow + k * 16 * KS + n * 8);
        to_bf16<KV>(b);
#pragma unroll
        for (int t = 0; t < MT; ++t) mma(st.o[t][n], pa[t][k], b[0], b[1]);
      }
    }
  }
}

template <int D, int MT, class Visible>
__device__ __forceinline__ void attend(const bf16* Qw, const bf16* Ks,
                                       const bf16* Vs, float scale2,
                                       bool all_visible, Visible visible,
                                       State<D, MT>& st) {
  PFrag<MT> pa;
  scores<D, MT>(Qw, Ks, scale2, all_visible, visible, st, pa);
  accumulate<D, MT>(Vs, pa, st);
}

// Row sums over the quad: call with every lane of the warp, after the
// last tile and before store_row.
template <int D, int MT>
__device__ __forceinline__ void finish(State<D, MT>& st) {
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    st.l[t][0] = cs::quad_sum(st.l[t][0]);
    st.l[t][1] = cs::quad_sum(st.l[t][1]);
  }
}

// Normalized output of the thread's row i of m-tile t (0 for a row that
// saw nothing) into dst[0, D): bf16 pairs at columns 8n + 2 (lane % 4).
template <int D, int MT>
__device__ __forceinline__ void store_row(const State<D, MT>& st, int t,
                                          int i, bf16* dst) {
  const float inv = st.l[t][i] > 0.f ? 1.f / st.l[t][i] : 0.f;
  const int c0 = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    *reinterpret_cast<uint32_t*>(dst + n * 8 + c0) =
        pack(st.o[t][n][2 * i] * inv, st.o[t][n][2 * i + 1] * inv);
}

// ---------------------------------------------------------------------------
// fp8 K / V (the e4m3 or e5m2 KV cache of K3 and K4): fragments widened in
// registers
// ---------------------------------------------------------------------------
// A tile is BK rows (keys) of D fp8 bytes in shared memory, copied from
// the cache in 16-byte chunks; chunk ch of row c sits at chunk
// ch ^ swz<D>(c) of its row, so that the loads below hit distinct bank
// groups (D = 128: conflict-free; D = 64: two-way on V). No bf16 copy of
// the tile exists: every B fragment is read as fp8 bytes and widened just
// before its MMA, so K / V cross shared memory once (bytes in, bytes out)
// and a warp's extra live set is 4 k-steps' words (32 registers), not a
// tile.
//
// The fragment layout follows the bytes, and both operands are permuted
// to match:
//   Q.K^T  the m16n8k16 B fragment of k-step kk holds head dims {2c, 2c+1,
//          2c+8, 2c+9} (c = lane % 4) of one key; the lane's 32-bit word
//          of the key's row holds dims (D/4) c + 4 kk + {0, 1, 2, 3}. Q is
//          staged with its head dims permuted the same way (f8_q_col), so
//          the word IS the fragment: a sum over a permuted index is the
//          same sum of the same products.
//   P.V    a B fragment holds 4 keys of one head dim. K's n-columns choose
//          which key each S column holds (f8_key), so that the P columns
//          of k-step k are keys 16 k + 4 c + {0, 1, 2, 3} of lane c: the
//          lane reads its 4 rows' 16 (D = 128) or 8 (D = 64) bytes of dims
//          (D/8) g + [0, D/8) (g = lane / 4) and transposes them with
//          byte permutes; O's n-tile n, column g is then head dim
//          (D/8) g + n, which K4's merge undoes as it writes O's rows.
// The widening (cvt.rn.f16x2.e4m3x2 or .e5m2x2, exact: an e5m2 byte is
// the high byte of an f16 of the same bias; f16 -> f32 exact; the f32's
// upper half is the bf16, exact since an e4m3 value has 4 significant
// bits and an e5m2 value 3; inf and NaN stay so) is the only work the
// bf16 tile does not have. KV (a cs::DType code, E4M3 or E5M2) picks the
// widening; the layout is one for both.

template <int D>
__device__ __forceinline__ int swz(int c) {
  static_assert(D == 64 || D == 128, "fp8 tiles take head dim 64 or 128");
  return D == 128 ? ((c >> 1) & 6) | (c & 1) : (c >> 2) & 3;
}

// the tile key that column c of S n-tile j holds (fp8 layout)
__device__ __forceinline__ int f8_key(int j, int c) {
  return 16 * (j >> 1) + 2 * (j & 1) + 4 * (c >> 1) + (c & 1);
}

// the column of the staged Q row that takes Q's head dims d, d + 1 (d
// even): k-step kk's column 2c + e + 8h holds dim (D/4) c + 4 kk + 2h + e
template <int D>
__device__ __forceinline__ int f8_q_col(int d) {
  constexpr int L = D / 4;
  const int rem = d % L;
  return 16 * (rem >> 2) + 2 * (d / L) + 8 * ((rem >> 1) & 1);
}

// two fp8 bytes of kind KV (E4M3 or E5M2; the low one into the low half)
// -> bf16x2, exact
template <int KV>
__device__ __forceinline__ uint32_t f8x2_to_bf16x2(uint32_t two) {
  static_assert(KV == cs::E4M3 || KV == cs::E5M2, "an fp8 kind");
  const __half2 h(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two & 0xffffu),
      KV == cs::E4M3 ? __NV_E4M3 : __NV_E5M2));
  const float2 f = __half22float2(h);
  return __byte_perm(__float_as_uint(f.x), __float_as_uint(f.y), 0x7632);
}

// K/V element of a cache of kind KV (a cs::DType code) as the tensor-core
// kernels read it: fp8 bytes, bf16, f16 or f32
template <int KV> struct KVElem { using T = uint8_t; };
template <> struct KVElem<cs::BF16> { using T = bf16; };
template <> struct KVElem<cs::F16> { using T = __half; };
template <> struct KVElem<cs::F32> { using T = float; };
template <int KV>
using KVT = typename KVElem<KV>::T;

__host__ __device__ constexpr bool is_f8(int kv) {
  return kv == cs::E4M3 || kv == cs::E5M2;
}

// One 16-byte chunk of a KV row (16 fp8, 8 f16 or bf16, or 4 f32 elements)
// into bf16 at dst (32, 16 or 8 bytes, as aligned): fp8 widened
// exactly, f16 and f32 rounded to nearest even (cvt.rn.bf16x2.f32 after
// the exact f16 -> f32), as the TPU kernels' ``astype`` does.
template <int KV>
__device__ __forceinline__ void chunk_to_bf16(bf16* dst, uint4 w) {
  if constexpr (is_f8(KV)) {
    uint4* o = reinterpret_cast<uint4*>(dst);
    o[0] = make_uint4(f8x2_to_bf16x2<KV>(w.x), f8x2_to_bf16x2<KV>(w.x >> 16),
                      f8x2_to_bf16x2<KV>(w.y), f8x2_to_bf16x2<KV>(w.y >> 16));
    o[1] = make_uint4(f8x2_to_bf16x2<KV>(w.z), f8x2_to_bf16x2<KV>(w.z >> 16),
                      f8x2_to_bf16x2<KV>(w.w), f8x2_to_bf16x2<KV>(w.w >> 16));
  } else if constexpr (KV == cs::F16) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(f16x2_to_bf16x2(w.x), f16x2_to_bf16x2(w.y),
                   f16x2_to_bf16x2(w.z), f16x2_to_bf16x2(w.w));
  } else if constexpr (KV == cs::F32) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(
        pack(__uint_as_float(w.x), __uint_as_float(w.y)),
        pack(__uint_as_float(w.z), __uint_as_float(w.w)));
  } else {  // bf16: as it is
    *reinterpret_cast<uint4*>(dst) = w;
  }
}

// K3 over an fp8 cache: a tile's rows in their own width (BK
// rows of D elements, row stride D elements) converted into the bf16 tile
// the MMAs read (row stride KS), one 16-byte chunk a step, steps tid,
// tid + nt, ... (zero rows of a ragged tile stay zero). For e4m3 a form
// without the conversion units (the byte's bits moved into a bf16's
// places, then one multiply by 2^120) measured slower on the H100
// (PERF.md).
template <int D, int KV>
__device__ __forceinline__ void convert_tile(bf16* dst, const uint8_t* src,
                                             int tid, int nt) {
  constexpr int KS = stride(D);
  constexpr int EPC = 16 / sizeof(KVT<KV>);   // elements a chunk
  constexpr int CH = D / EPC;                 // chunks a row
  for (int i = tid; i < BK * CH; i += nt) {
    const int c = i / CH, ch = i % CH;
    chunk_to_bf16<KV>(dst + c * KS + ch * EPC,
                      *reinterpret_cast<const uint4*>(
                          src + (c * CH + ch) * 16));
  }
}

// S = Q K^T over an fp8 K tile of kind KV (K8: BK swizzled rows of D
// bytes), then the mask and online softmax as scores(); Qw is staged by
// f8_q_col. The lane's words of all NS keys for 4 k-steps are held at
// once, so Q's fragments are read once a tile (holding half of them and
// reading Q twice measured 3% slower at <128, 2>, PERF.md).
template <int D, int MT, int KV, class Visible>
__device__ __forceinline__ void scores_f8(const bf16* Qw, const uint8_t* K8,
                                          float scale2, bool all_visible,
                                          Visible visible, State<D, MT>& st,
                                          PFrag<MT>& pa) {
  constexpr int KS = stride(D), CPL = D / 64;  // 16-byte chunks per lane
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  float s[MT][NS][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < NS; ++j) s[t][j][0] = s[t][j][1] = s[t][j][2] =
        s[t][j][3] = 0.f;
  const bf16* qrow = Qw + ((lane & 7) + ((lane >> 3) & 1) * 8) * KS +
                     (lane >> 4) * 8;
#pragma unroll
  for (int h = 0; h < CPL; ++h) {       // k-steps 4h .. 4h + 3
    uint4 kw[NS];  // the lane's 16 bytes of each key: 4 k-steps' words
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int key = f8_key(j, g);
      kw[j] = *reinterpret_cast<const uint4*>(
          K8 + key * D + 16 * ((CPL * c + h) ^ swz<D>(key)));
    }
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) {
      uint32_t qa[MT][4];
#pragma unroll
      for (int t = 0; t < MT; ++t)
        ldsm_x4(qa[t], qrow + t * 16 * KS + (4 * h + k4) * 16);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const uint32_t w = k4 == 0   ? kw[j].x
                           : k4 == 1 ? kw[j].y
                           : k4 == 2 ? kw[j].z
                                     : kw[j].w;
        const uint32_t b0 = f8x2_to_bf16x2<KV>(w);
        const uint32_t b1 = f8x2_to_bf16x2<KV>(w >> 16);
#pragma unroll
        for (int t = 0; t < MT; ++t) mma(s[t][j], qa[t], b0, b1);
      }
    }
  }
  softmax_tile<D, MT>(s, scale2, all_visible, visible,
                      [](int j, int col) { return f8_key(j, col); }, st, pa);
}

// O += P V over an fp8 V tile of kind KV (V8 as scores_f8's K8); P's
// columns are the keys f8_key gave them.
template <int D, int MT, int KV>
__device__ __forceinline__ void accumulate_f8(const uint8_t* V8,
                                              const PFrag<MT>& pa,
                                              State<D, MT>& st) {
  constexpr int NB = D / 8;  // bytes a lane reads of a row: its n-tiles
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int k = 0; k < NS / 2; ++k) {
    uint32_t a[4][NB / 4];  // rows 16k + 4c + r: dims NB g + [0, NB)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int key = 16 * k + 4 * c + r;
      const uint8_t* row = V8 + key * D;
      if constexpr (D == 128) {
        const uint4 w = *reinterpret_cast<const uint4*>(
            row + 16 * (g ^ swz<D>(key)));
        a[r][0] = w.x, a[r][1] = w.y, a[r][2] = w.z, a[r][3] = w.w;
      } else {
        const uint2 w = *reinterpret_cast<const uint2*>(
            row + 16 * ((g >> 1) ^ swz<D>(key)) + 8 * (g & 1));
        a[r][0] = w.x, a[r][1] = w.y;
      }
    }
#pragma unroll
    for (int wd = 0; wd < NB / 4; ++wd) {
      // byte m of each row's word: keys (0, 1) of dim m in x01, (2, 3) in
      // x23, two dims to a register
      const uint32_t x01[2] = {__byte_perm(a[0][wd], a[1][wd], 0x5140),
                               __byte_perm(a[0][wd], a[1][wd], 0x7362)};
      const uint32_t x23[2] = {__byte_perm(a[2][wd], a[3][wd], 0x5140),
                               __byte_perm(a[2][wd], a[3][wd], 0x7362)};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int sh = 16 * (m & 1);
        const uint32_t b0 = f8x2_to_bf16x2<KV>(x01[m >> 1] >> sh);
        const uint32_t b1 = f8x2_to_bf16x2<KV>(x23[m >> 1] >> sh);
#pragma unroll
        for (int t = 0; t < MT; ++t)
          mma(st.o[t][4 * wd + m], pa[t][k], b0, b1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 K / V (an f32 KV cache under bf16 queries, K4): fragments rounded to
// bf16 in registers
// ---------------------------------------------------------------------------
// A K4 warp keeps its tile as the cache's own f32 rows (BK rows of D
// floats, 16-byte chunks moved by a swizzle, below) and rounds each B
// fragment to bf16 (cvt.rn.bf16x2.f32, as chunk_to_bf16) just before its
// MMA, so the products and sums are the bf16 kernel's over the rounded
// cache:
//   Q.K^T  b0 / b1 of k-step kk, key n-tile j are key 8j + g's head dims
//          16 kk + 2c + {0, 1} / + 8 (g = lane / 4, c = lane % 4): one
//          8-byte load and one cvt each, in ldmatrix's order (Q is staged
//          as it is: the k-steps sum the same dims as bf16's);
//   P.V    b0 / b1 of k-step k hold keys 16k + 2c + {0, 1} / + {8, 9} of
//          one head dim, so the lane reads those 4 rows' 16-byte chunks of
//          dims (D/8) g + [0, D/8) and pairs them (one cvt a register): O's
//          n-tile n, column g is head dim (D/8) g + n, as for fp8 above,
//          which K4's merge undoes. Each output element is still the MMA's
//          sum over the same keys of the same values.
// The swizzles keep each load's 8 (16-byte) or 16 (8-byte) lanes of a
// phase on distinct banks, and a warp's copy of a row (consecutive
// chunks) too.

// chunk ch of f32 K row r: ch ^ 2 (r % 4); the 16 lanes of an 8-byte
// phase read rows 8j + [0, 4) at chunks 4 kk + {0, 1} (or + {2, 3})
__device__ __forceinline__ int f32_k_chunk(int r, int ch) {
  return ch ^ (2 * (r & 3));
}

// chunk ch of f32 V row r: a lane pair's chunk parity, the row's parity
// and the row's bits 1-2 (D = 128; D = 64: bits 1 and 2 apart) moved into
// the low 3 bits, so that a phase's 8 lanes (rows 16k + 2c + off, c < 4,
// two chunks apart by D/32 or D/16) hit 8 bank groups
template <int D>
__device__ __forceinline__ int f32_v_chunk(int r, int ch) {
  static_assert(D == 64 || D == 128, "f32 tiles take head dim 64 or 128");
  const int rb = D == 128 ? (r >> 1) & 3
                          : ((r >> 1) & 1) | (((r >> 2) & 1) << 2);
  return ch ^ ((2 * (ch >> 3) + (r & 1)) ^ rb);
}

// S = Q K^T over an f32 K tile (K32: BK rows of D floats, f32_k_chunk),
// then the mask and online softmax as scores()
template <int D, int MT, class Visible>
__device__ __forceinline__ void scores_f32(const bf16* Qw, const float* K32,
                                           float scale2, bool all_visible,
                                           Visible visible, State<D, MT>& st,
                                           PFrag<MT>& pa) {
  constexpr int KS = stride(D);
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  float s[MT][NS][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < NS; ++j) s[t][j][0] = s[t][j][1] = s[t][j][2] =
        s[t][j][3] = 0.f;
  const bf16* qrow = Qw + ((lane & 7) + ((lane >> 3) & 1) * 8) * KS +
                     (lane >> 4) * 8;
  // head dims d, d + 1 of key row `key` (d even) as bf16x2
  auto pair = [&](int key, int d) {
    const float2 w = *reinterpret_cast<const float2*>(
        K32 + key * D + 4 * f32_k_chunk(key, d >> 2) + (d & 3));
    return pack(w.x, w.y);
  };
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qa[MT][4];
#pragma unroll
    for (int t = 0; t < MT; ++t) ldsm_x4(qa[t], qrow + t * 16 * KS + kk * 16);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int key = 8 * j + g, d = 16 * kk + 2 * c;
      const uint32_t b0 = pair(key, d), b1 = pair(key, d + 8);
#pragma unroll
      for (int t = 0; t < MT; ++t) mma(s[t][j], qa[t], b0, b1);
    }
  }
  softmax_tile<D, MT>(s, scale2, all_visible, visible,
                      [](int j, int col) { return j * 8 + col; }, st, pa);
}

// O += P V over an f32 V tile (V32: BK rows of D floats, f32_v_chunk); O's
// head dims permuted as the section's header says
template <int D, int MT>
__device__ __forceinline__ void accumulate_f32(const float* V32,
                                               const PFrag<MT>& pa,
                                               State<D, MT>& st) {
  constexpr int NQ = D / 32;  // chunks of the lane's D/8 dims
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int k = 0; k < NS / 2; ++k) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float4 w[4];  // keys 16k + 2c + {0, 1, 8, 9}: dims (D/8) g + 4q + [0, 4)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = 16 * k + 2 * c + (r & 1) + 8 * (r >> 1);
        w[r] = *reinterpret_cast<const float4*>(
            V32 + key * D + 4 * f32_v_chunk<D>(key, NQ * g + q));
      }
      auto at = [](const float4& v, int m) {
        return m == 0 ? v.x : m == 1 ? v.y : m == 2 ? v.z : v.w;
      };
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint32_t b0 = pack(at(w[0], m), at(w[1], m));
        const uint32_t b1 = pack(at(w[2], m), at(w[3], m));
#pragma unroll
        for (int t = 0; t < MT; ++t) mma(st.o[t][4 * q + m], pa[t][k], b0, b1);
      }
    }
  }
}

}  // namespace tc
