// K1: varlen block-diagonal vision attention with the 2D RoPE rotation
// fused in.
//
// Replaces cogstream_tpu/ops/flash_attention.py::_flash_kernel_packed_rope
// (flash_attention_packed_rope_fusedqkv). Same contract: q/k/v are read
// straight out of ONE fused QKV GEMM output [N, 3*H*D] (column groups q
// | k | v, head-major inside each group), q and k are rotated on the
// tile (x*cos + rotate_half(x)*sin in f32, rounded to the input dtype
// exactly like the unfused path), each token attends only to tokens of
// its own segment (frame), pad tokens (segment -1) output 0.
//
// TPU mechanisms left behind: no 128-lane per-head padding (D = 72 is
// read as is), no +-1 permutation matmul (rotate_half is an index), no
// v5e block-size cost model (the host gives each 64-row query tile the
// token range [kv_lo, kv_hi) of the segments it holds).
//
// Bound on the H100: arithmetic (block-diagonal attention over 1008-
// token frames is ~75 GFLOP per tower layer at 16x1008 tokens).
// * bf16 (cs_vision_attention_tc): the tensor-core kernel of
//   segment_tc.cuh with the rotation compiled in (kRope; K5 runs the same
//   body without it): 256 query rows of one head per block, 64-key tiles
//   through a cp.async double buffer straight from the fused QKV rows
//   with each tile's f32 cos and sin rows, q and k rotated in shared
//   memory as they land.
// * f32 (cs_vision_attention): the register-blocked f32 tile of
//   f32_tile.cuh (exact f32 FFMAs), one 256-thread block per 128 query
//   rows of one head (64 at a head dim above 80, for shared memory): its
//   64-row host tiles' token ranges joined, 64-key tiles walked with one K
//   and one V tile, V copied (cp.async) while a tile's scores run and the
//   next K with its f32 cos and sin rows while its P.V runs. q is rotated
//   once a block as it is loaded; each K chunk pair (d, d + D/2) is
//   rotated in place by the thread that copied it, as it lands, with the
//   plain path's roundings (x*cos + rotate_half(x)*sin, each product and
//   the sum rounded in f32). A thread whose rows lie in one frame with
//   all its keys skips the segment compares.
#include "common.cuh"
#include "f32_tile.cuh"
#include "segment_tc.cuh"

namespace {

// the rotation of pairs (x1[e], x2[e]) = (x[d + e], x[d + D/2 + e]) with
// their cos / sin: y1 = x1*c1 - x2*s1, y2 = x2*c2 + x1*s2, every product
// and sum rounded once in f32 (no FMA), as the plain version computes it
__device__ __forceinline__ void rotate_pair(float& x1, float& x2, float c1,
                                            float s1, float c2, float s2) {
  const float y1 = __fadd_rn(__fmul_rn(x1, c1), __fmul_rn(-x2, s1));
  const float y2 = __fadd_rn(__fmul_rn(x2, c2), __fmul_rn(x1, s2));
  x1 = y1;
  x2 = y2;
}

// rows a block of the f32 tile at padded head dim DP (the cos / sin stage
// of a key tile takes 64 KB at DP = 128)
__host__ __device__ constexpr int vision_f32_rows(int DP) {
  return DP == 128 ? 64 : 128;
}

template <int DP>
__host__ __device__ constexpr size_t vision_f32_smem() {
  using Sh = f32t::Shape<DP, vision_f32_rows(DP)>;
  return (size_t)Sh::FLOATS * sizeof(float) +
         (size_t)2 * f32t::BK * DP * sizeof(float) +  // cos | sin stage
         (size_t)(vision_f32_rows(DP) + f32t::BK) * sizeof(int);
}

// f32 operands: the register-blocked f32 tile
template <int DP>
__global__ void __launch_bounds__(f32t::NT, 1)
vision_attention_f32_kernel(const float* __restrict__ qkv,
                            const float* __restrict__ cosv,
                            const float* __restrict__ sinv,
                            const int* __restrict__ seg,
                            const int* __restrict__ kv_lo,
                            const int* __restrict__ kv_hi,
                            float* __restrict__ out, int N, int H, int D,
                            float scale2) {
  constexpr int BR = vision_f32_rows(DP);
  using Sh = f32t::Shape<DP, BR>;
  constexpr int BK = f32t::BK, NT = f32t::NT, DS = Sh::DS;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BR * DS;
  float* Vs = Ks + BK * DS;
  float* Ps = Vs + BK * DS;
  float* alpha = Ps + BK * Sh::PST;
  float* lsum = alpha + BR;
  float* cs_ = lsum + BR;       // the K tile's cos rows (stride DP)
  float* sn_ = cs_ + BK * DP;   // and sin rows
  int* rseg = reinterpret_cast<int*>(sn_ + BK * DP);
  int* cseg = rseg + BR;

  const int tid = threadIdx.x, h = blockIdx.y, q0 = blockIdx.x * BR;
  const size_t rs = (size_t)3 * H * D;  // elements between tokens
  const int qcol = h * D, kcol = (H + h) * D, vcol = (2 * H + h) * D;
  // rotation pairs (d .. d + W - 1, + D/2): 16-byte chunks where D/2 is a
  // multiple of 4, single floats otherwise
  const int half = D / 2, W = half % 4 == 0 ? 4 : 1, HC = half / W;
  // the key range: the union of the block's 64-row host tiles' ranges
  constexpr int QT = BR / 64;
  const int n_qt = (N + 63) / 64, t0 = blockIdx.x * QT;
  const int lo = kv_lo[t0];
  int hi = kv_hi[t0];
  for (int j = 1; j < QT; ++j)
    if (t0 + j < n_qt) hi = max(hi, kv_hi[t0 + j]);

  if (D < DP)  // zero head-dim padding of Q, K and V
    for (int i = tid; i < (BR + 2 * BK) * (DP - D); i += NT)
      Qs[i / (DP - D) * DS + D + i % (DP - D)] = 0.f;
  const f32t::Div hc_div(HC), ch_div(D / 4);
  // q rotated once a block (zero rows past N)
  f32t::for_chunks(BR, hc_div, [&](int rr, int hc) {
    const int d = hc * W, n = q0 + rr;
    float* dst = Qs + rr * DS;
    for (int e = 0; e < W; ++e) {
      float x1 = 0.f, x2 = 0.f;
      if (n < N) {
        const float* x = qkv + n * rs + qcol;
        const float* c = cosv + (size_t)n * D;
        const float* s = sinv + (size_t)n * D;
        x1 = x[d + e];
        x2 = x[d + e + half];
        rotate_pair(x1, x2, c[d + e], s[d + e], c[d + e + half],
                    s[d + e + half]);
      }
      dst[d + e] = x1;
      dst[d + e + half] = x2;
    }
  });
  if (tid < BR) rseg[tid] = q0 + tid < N ? seg[q0 + tid] : -1;
  __syncthreads();
  // this thread's own score rows' segments; s0: their one segment, if
  // they share one (else -3, which no key carries)
  constexpr int RH = Sh::RS / 2;
  const int kg = f32t::score_kg();
  int rsg[RH], s0 = rseg[f32t::score_row(0, RH)];
#pragma unroll
  for (int i = 0; i < RH; ++i) {
    rsg[i] = rseg[f32t::score_row(i, RH)];
    if (rsg[i] != s0) s0 = -3;
  }
  if (s0 < 0) s0 = -3;

  auto copy16 = [](float* dst, const float* src, bool ok, int w) {
    if (w == 4)
      tc::cp_async16(dst, src, ok);
    else
      tc::cp_async4(dst, src, ok);
  };
  // K rows of tile t (keys lo + 64 t ...) with their cos / sin rows, in
  // rotation pairs, and the keys' segments (-2 past hi)
  auto fetch_k = [&](int t) {
    const int k0 = lo + t * BK;
    f32t::for_chunks(BK, hc_div, [&](int c, int hc) {
      const int d = hc * W, n = k0 + c;
      const bool ok = n < hi;  // ragged last tile: zero rows
      const float* x = qkv + (ok ? n : 0) * rs + kcol;
      const size_t cr = (size_t)(ok ? n : 0) * D;
      copy16(Ks + c * DS + d, x + d, ok, W);
      copy16(Ks + c * DS + d + half, x + d + half, ok, W);
      copy16(cs_ + c * DP + d, cosv + cr + d, ok, W);
      copy16(cs_ + c * DP + d + half, cosv + cr + d + half, ok, W);
      copy16(sn_ + c * DP + d, sinv + cr + d, ok, W);
      copy16(sn_ + c * DP + d + half, sinv + cr + d + half, ok, W);
    });
    for (int c = tid; c < BK; c += NT) {
      if (k0 + c < hi)
        tc::cp_async4(cseg + c, seg + k0 + c);
      else
        cseg[c] = -2;
    }
  };
  // the pairs this thread copied, rotated in place
  auto land_k = [&](int) {
    f32t::for_chunks(BK, hc_div, [&](int c, int hc) {
      const int d = hc * W;
      float* x = Ks + c * DS;
      const float* cr = cs_ + c * DP;
      const float* sr = sn_ + c * DP;
      for (int e = 0; e < W; ++e)
        rotate_pair(x[d + e], x[d + e + half], cr[d + e], sr[d + e],
                    cr[d + e + half], sr[d + e + half]);
    });
  };
  auto fetch_v = [&](int t) {
    const int k0 = lo + t * BK;
    f32t::for_chunks(BK, ch_div, [&](int c, int ch) {
      const int n = k0 + c;
      const bool ok = n < hi;
      tc::cp_async16(Vs + c * DS + ch * 4,
                     qkv + (ok ? n : 0) * rs + vcol + ch * 4, ok);
    });
  };

  f32t::Rows<RH> st;
  st.init();
  f32t::Acc<DP, BR> o;
  f32t::zero<DP, BR>(o);
  const int n_tiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;
  f32t::stream(
      0, n_tiles, [](int t) { return t; }, [&](int t) { fetch_k(t); },
      land_k, [&](int t, int) { fetch_v(t); },
      [&](int tn, int) {
        if (tn < n_tiles) fetch_k(tn);
      },
      [&](int, int) {
        bool all = true;
#pragma unroll
        for (int j = 0; j < f32t::KPT; ++j)
          all = all && cseg[kg + 8 * j] == s0;
        f32t::scores<DP, BR>(
            Qs, Ks, Ps, alpha, D / 4, scale2, all,
            [&](int i, int c) { return rsg[i] >= 0 && rsg[i] == cseg[c]; },
            st);
      },
      [&]() { f32t::accumulate<DP, BR, 8>(Ps, Vs, alpha, o); });
  tc::cp_async_wait<0>();
  f32t::finish(st, lsum);
  __syncthreads();
  f32t::store<DP, BR>(o, lsum, D, [&](int rr) -> float* {
    const int n = q0 + rr;
    return n < N ? out + (size_t)n * H * D + h * D : nullptr;
  });
}

template <int DP>
int launch_vision_f32(const void* qkv, const void* cosv, const void* sinv,
                      const void* seg, const void* kv_lo, const void* kv_hi,
                      void* out, int n, int heads, int d, float scale2,
                      cudaStream_t st) {
  constexpr int BR = vision_f32_rows(DP);
  constexpr size_t bytes = vision_f32_smem<DP>();
  static_assert(bytes <= 232448, "shared memory of a block");
  auto kern = vision_attention_f32_kernel<DP>;
  // once per instantiation, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kern<<<dim3((n + BR - 1) / BR, heads), f32t::NT, bytes, st>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(cosv),
      static_cast<const float*>(sinv), static_cast<const int*>(seg),
      static_cast<const int*>(kv_lo), static_cast<const int*>(kv_hi),
      static_cast<float*>(out), n, heads, d, scale2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 operands, head dim d even, a multiple of 4 and at most 128: the
// register-blocked f32 tile (bf16 goes to cs_vision_attention_tc).
// kv_lo / kv_hi: the token range of each 64-row host tile (block_q 64).
extern "C" int cs_vision_attention(const void* qkv, const void* cosv,
                                   const void* sinv, const void* seg,
                                   const void* kv_lo, const void* kv_hi,
                                   void* out, int n, int heads, int d,
                                   int block_q, float scale, int dtype,
                                   void* stream) {
  if (dtype != cs::F32 || block_q != cs::BR || d % 4 != 0 || d > 128 ||
      d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale2 = scale * tc::LOG2E;
#define CS_VISION_F32(DP)                                                 \
  if (d <= DP)                                                            \
    return launch_vision_f32<DP>(qkv, cosv, sinv, seg, kv_lo, kv_hi, out, \
                                 n, heads, d, scale2, st);
  CS_VISION_F32(32) CS_VISION_F32(64) CS_VISION_F32(80) CS_VISION_F32(128)
#undef CS_VISION_F32
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 operands, head dim D % 8 == 0 and D <= 128: the tensor-core tile
extern "C" int cs_vision_attention_tc(const void* qkv, const void* cosv,
                                      const void* sinv, const void* seg,
                                      const void* kv_lo, const void* kv_hi,
                                      void* out, int n, int heads, int d,
                                      int block_q, float scale,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale2 = scale * tc::LOG2E;
  if (block_q != cs::BR) return static_cast<int>(cudaErrorInvalidValue);
  // q, k, v: the column groups of the fused rows
  const tc::bf16* q = static_cast<const tc::bf16*>(qkv);
  const size_t hd = (size_t)heads * d;
  switch (d) {
#define CS_VISION_TC(D)                                                   \
  case D:                                                                 \
    return launch_segment_tc<D, true>(q, q + hd, q + 2 * hd, 3 * hd, cosv, \
                                      sinv, seg, kv_lo, kv_hi, out, n,     \
                                      heads, scale2, st);
    CS_SEGMENT_TC_DIMS(CS_VISION_TC)
#undef CS_VISION_TC
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
