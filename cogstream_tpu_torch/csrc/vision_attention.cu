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
// * bf16 (cs_vision_attention_tc): the tensor-core tile of tc_tile.cuh.
//   A block of 8 warps owns 256 query rows (four host tiles, 2 m-tiles
//   per warp) of one head and walks the 64-key tiles of their token
//   range, streamed by a cp.async double buffer straight from the fused
//   QKV rows (a head's row of D bf16 is a whole number of 16-byte chunks
//   for D % 8 == 0), with each tile's f32 cos and sin rows. q is rotated
//   once per block and k once per visiting query block, in place in
//   shared memory (each thread 4 pairs (d, d + D/2), f32, one bf16
//   rounding): the rotated tile is the MMA operand. A key tile is
//   rotated as soon as it lands, after the previous tile's math, from
//   its staged cos and sin, so the rotation never waits on device
//   memory. The Q.K^T depth is
//   padded to a multiple of 16 with zero columns in both Q and K; P.V
//   runs D/8 n-tiles (9 at D = 72). A warp whose rows and key tile lie
//   in one frame skips the segment compare (most tiles: frames are
//   1008 tokens).
// * f32 (cs_vision_attention): the CUDA-core f32 tile of common.cuh,
//   one 256-thread block per (64-row tile, head).
#include "common.cuh"
#include "tc_tile.cuh"

namespace {

__device__ __forceinline__ float rotated(const float* row,
                                         const float* cs_row,
                                         const float* sn_row, int d,
                                         int half) {
  const float x = row[d];
  const float partner = row[d < half ? d + half : d - half];
  const float rot = d < half ? -partner : partner;
  return x * cs_row[d] + rot * sn_row[d];
}

// f32 operands: the CUDA-core tile
__global__ void __launch_bounds__(cs::NT)
vision_attention_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ cosv,
                        const float* __restrict__ sinv,
                        const int* __restrict__ seg,
                        const int* __restrict__ kv_lo,
                        const int* __restrict__ kv_hi,
                        float* __restrict__ out, int N, int H, int D,
                        float scale) {
  extern __shared__ float smem[];
  const int DS = D + 4, half = D / 2;
  float* Qs = smem;
  float* Ks = Qs + cs::BR * DS;
  float* Vs = Ks + cs::BK * DS;
  float* Ps = Vs + cs::BK * DS;
  int* rseg = reinterpret_cast<int*>(Ps + cs::BR * cs::PS);
  int* cseg = rseg + cs::BR;

  const int tid = threadIdx.x, h = blockIdx.y;
  const int q0 = blockIdx.x * cs::BR;
  const size_t row_stride = (size_t)3 * H * D;
  const int qcol = h * D, kcol = (H + h) * D, vcol = (2 * H + h) * D;

  for (int i = tid; i < cs::BR * D; i += cs::NT) {
    const int rr = i / D, d = i % D, n = q0 + rr;
    float val = 0.f;
    if (n < N)
      val = rotated(qkv + n * row_stride + qcol, cosv + (size_t)n * D,
                    sinv + (size_t)n * D, d, half);
    Qs[rr * DS + d] = val;
  }
  for (int rr = tid; rr < cs::BR; rr += cs::NT)
    rseg[rr] = q0 + rr < N ? seg[q0 + rr] : -1;

  cs::RowState st;
  st.init();
  const int lo = kv_lo[blockIdx.x], hi = kv_hi[blockIdx.x];
  for (int k0 = lo; k0 < hi; k0 += cs::BK) {
    const int ncols = min(cs::BK, hi - k0);
    __syncthreads();  // previous tile fully consumed (and Q/rseg written)
    for (int i = tid; i < ncols * D; i += cs::NT) {
      const int c = i / D, d = i % D, n = k0 + c;
      const float* row = qkv + n * row_stride;
      Ks[c * DS + d] = rotated(row + kcol, cosv + (size_t)n * D,
                               sinv + (size_t)n * D, d, half);
      Vs[c * DS + d] = row[vcol + d];
    }
    for (int c = tid; c < cs::BK; c += cs::NT)
      cseg[c] = c < ncols ? seg[k0 + c] : -2;
    __syncthreads();
    cs::attend_tile(Qs, Ks, Vs, Ps, D, ncols, scale,
                    [&](int r, int c) {
                      return rseg[r] >= 0 && rseg[r] == cseg[c];
                    },
                    st);
  }
  const int n = q0 + (tid >> 2);
  if (n < N) cs::store_row(st, out + (size_t)n * H * D + h * D, D);
}

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

// 8 warps of 2 m-tiles: 256 query rows per block, so each key tile and
// its cos / sin rows cross from L2 once per 256 rows
constexpr int TC_WARPS = 8, TC_MT = 2;

template <int D>
__global__ void __launch_bounds__(TC_WARPS * 32)
vision_attention_tc_kernel(const tc::bf16* __restrict__ qkv,
                           const float* __restrict__ cosv,
                           const float* __restrict__ sinv,
                           const int* __restrict__ seg,
                           const int* __restrict__ kv_lo,
                           const int* __restrict__ kv_hi,
                           tc::bf16* __restrict__ out, int N, int H,
                           float scale2) {
  constexpr int NW = TC_WARPS, MT = TC_MT, WR = 16 * MT, BR = NW * WR;
  constexpr int NT = 32 * NW, BK = tc::BK;
  constexpr int KD = tc::depth(D), KS = tc::stride(D), CH = D / 8;
  constexpr int HALF = D / 2, QT = BR / cs::BR;  // host tiles per block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc::bf16* Qs = reinterpret_cast<tc::bf16*>(smem_raw);
  tc::bf16* Ks = Qs + BR * KS;                    // 2 stages
  tc::bf16* Vs = Ks + 2 * BK * KS;                // 2 stages
  float* cs_ = reinterpret_cast<float*>(Vs + 2 * BK * KS);  // cos | sin
  int* cseg = reinterpret_cast<int*>(cs_ + 2 * BK * D);     // 2 stages
  int* rseg = cseg + 2 * BK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, q0 = blockIdx.x * BR;
  const size_t row_stride = (size_t)3 * H * D;
  const int qcol = h * D, kcol = (H + h) * D, vcol = (2 * H + h) * D;
  const int n_qt = (N + cs::BR - 1) / cs::BR, t0 = blockIdx.x * QT;
  const int lo = kv_lo[t0];
  int hi = kv_hi[t0];
  for (int j = 1; j < QT; ++j)
    if (t0 + j < n_qt) hi = max(hi, kv_hi[t0 + j]);

  // zero Q.K^T depth padding of Q and both K stages (never copied over)
  if constexpr (KD > D)
    for (int i = tid; i < (BR + 2 * BK) * (KD - D); i += NT)
      Qs[(i / (KD - D)) * KS + D + i % (KD - D)] = __float2bfloat16_rn(0.f);
  for (int i = tid; i < BR * CH; i += NT) {
    const int rr = i / CH, c = i % CH, n = q0 + rr;
    const tc::bf16* src = n < N ? qkv + n * row_stride + qcol + c * 8 : qkv;
    tc::cp_async16(Qs + rr * KS + c * 8, src, n < N);
  }
  tc::cp_async_commit();
  if (tid < BR) rseg[tid] = q0 + tid < N ? seg[q0 + tid] : -1;

  // K, V and segment ids of the tile at k0 into a stage; its cos and sin
  // rows into the one cos | sin buffer (read by rotate() before the next
  // load is issued)
  auto load = [&](int k0, int stage) {
    tc::bf16* kd = Ks + stage * BK * KS;
    tc::bf16* vd = Vs + stage * BK * KS;
    for (int i = tid; i < BK * CH; i += NT) {
      const int c = i / CH, ch = i % CH, n = k0 + c;
      const bool ok = n < hi;  // ragged last tile: zero rows
      const tc::bf16* row = qkv + (ok ? n * row_stride : 0);
      tc::cp_async16(kd + c * KS + ch * 8, row + kcol + ch * 8, ok);
      tc::cp_async16(vd + c * KS + ch * 8, row + vcol + ch * 8, ok);
    }
    for (int i = tid; i < BK * (D / 4); i += NT) {
      const int c = i / (D / 4), ch = i % (D / 4), n = k0 + c;
      const size_t off = n < hi ? (size_t)n * D + ch * 4 : 0;
      tc::cp_async16(cs_ + c * D + ch * 4, cosv + off, n < hi);
      tc::cp_async16(cs_ + (BK + c) * D + ch * 4, sinv + off, n < hi);
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
  for (int i = tid; i < BR * (HALF / 4); i += NT) {  // q, once per block
    const int rr = i / (HALF / 4), d = 4 * (i % (HALF / 4)), n = q0 + rr;
    if (n < N)
      rotate4<D>(Qs + rr * KS, cosv + (size_t)n * D, sinv + (size_t)n * D, d);
  }
  if (lo < hi) rotate(lo, 0);
  __syncthreads();
  const tc::bf16* Qw = Qs + warp * WR * KS;  // this warp's rows
  int rs[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      rs[m][i] = rseg[warp * WR + m * 16 + i * 8 + (lane >> 2)];
  // the warp's one segment, or -1 when its rows hold several or padding
  // (segment ids are non-decreasing runs: first == last means all equal)
  const int wfirst = rseg[warp * WR], wlast = rseg[warp * WR + WR - 1];
  const int wseg = wfirst >= 0 && wfirst == wlast ? wfirst : -1;

  tc::State<D, MT> st;
  st.init();
  int stage = 0;
  for (int k0 = lo; k0 < hi; k0 += BK) {
    const bool more = k0 + BK < hi;
    // the next tile's copy overlaps this tile's math, and its rotation
    // runs before the next tile's math: the MMAs only see rotated tiles
    if (more) load(k0 + BK, stage ^ 1);
    const int* cg = cseg + stage * BK;
    // a tile of the warp's own segment only needs no compare
    tc::attend<D, MT>(Qw, Ks + stage * BK * KS, Vs + stage * BK * KS, scale2,
                      wseg >= 0 && cg[0] == wseg && cg[BK - 1] == wseg,
                      [=](int m, int i, int c) {
                        return rs[m][i] >= 0 && rs[m][i] == cg[c];
                      },
                      st);
    if (more) {
      tc::cp_async_wait<0>();
      __syncthreads();
      rotate(k0 + BK, stage ^ 1);
    }
    __syncthreads();  // rotated before use; this stage consumed before refill
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

constexpr int MAX_SMEM = 232448;  // 227 KB: a block's dynamic shared memory

template <int D>
int launch_vision_tc(const void* qkv, const void* cosv, const void* sinv,
                     const void* seg, const void* kv_lo, const void* kv_hi,
                     void* out, int n, int heads, float scale2,
                     cudaStream_t st) {
  constexpr int BR = TC_WARPS * 16 * TC_MT;
  auto kern = vision_attention_tc_kernel<D>;
  // once per instantiation, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t bytes =
      (size_t)(BR + 4 * tc::BK) * tc::stride(D) * sizeof(tc::bf16) +
      (size_t)2 * tc::BK * D * sizeof(float) +
      (size_t)(2 * tc::BK + BR) * sizeof(int);
  const dim3 grid((n + BR - 1) / BR, heads);
  kern<<<grid, TC_WARPS * 32, bytes, st>>>(
      static_cast<const tc::bf16*>(qkv), static_cast<const float*>(cosv),
      static_cast<const float*>(sinv), static_cast<const int*>(seg),
      static_cast<const int*>(kv_lo), static_cast<const int*>(kv_hi),
      static_cast<tc::bf16*>(out), n, heads, scale2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 operands: the CUDA-core tile (bf16 goes to cs_vision_attention_tc)
extern "C" int cs_vision_attention(const void* qkv, const void* cosv,
                                   const void* sinv, const void* seg,
                                   const void* kv_lo, const void* kv_hi,
                                   void* out, int n, int heads, int d,
                                   int block_q, float scale, int dtype,
                                   void* stream) {
  if (dtype != cs::F32 || block_q != cs::BR || d % 4 != 0 ||
      d > 4 * cs::MAX_D4 || d % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n + cs::BR - 1) / cs::BR;
  const size_t bytes =
      cs::tile_smem_floats(d) * sizeof(float) + 2 * cs::BR * sizeof(int);
  auto k = vision_attention_kernel;
  static const cudaError_t attr = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(cs::tile_smem_floats(4 * cs::MAX_D4) * sizeof(float) +
            2 * cs::BR * sizeof(int)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  k<<<dim3(n_tiles, heads), cs::NT, bytes, st>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(cosv),
      static_cast<const float*>(sinv), static_cast<const int*>(seg),
      static_cast<const int*>(kv_lo), static_cast<const int*>(kv_hi),
      static_cast<float*>(out), n, heads, d, scale);
  return static_cast<int>(cudaGetLastError());
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
  switch (d) {
#define CS_VISION_TC(D)                                                     \
  case D:                                                                   \
    return launch_vision_tc<D>(qkv, cosv, sinv, seg, kv_lo, kv_hi, out, n, \
                               heads, scale2, st);
    CS_VISION_TC(8) CS_VISION_TC(16) CS_VISION_TC(24) CS_VISION_TC(32)
    CS_VISION_TC(40) CS_VISION_TC(48) CS_VISION_TC(56) CS_VISION_TC(64)
    CS_VISION_TC(72) CS_VISION_TC(80) CS_VISION_TC(88) CS_VISION_TC(96)
    CS_VISION_TC(104) CS_VISION_TC(112) CS_VISION_TC(120) CS_VISION_TC(128)
#undef CS_VISION_TC
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
