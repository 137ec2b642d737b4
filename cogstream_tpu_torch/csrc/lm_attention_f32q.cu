// K3's f32-query route (cs_gqa_prefill_f32 in lm_attention.cu): causal GQA
// prefill over the position-tagged cache on the f32 tile of f32_tile.cuh,
// the cache in f32 or (widened exactly) bf16, f16, e4m3 or e5m2.
//
// A block of 256 threads owns BR = 128 or 64 folded rows (r = s * G + g)
// of one (batch, kv head), so each K/V tile is read once for all G query
// heads of its rows; blocks launch last rows first (the last rows see the
// most slots). The pre-pass (tile_minmax_kernel) gives each 64-slot tile
// its smallest and largest eff position: the block walks only the tiles
// some row can see (up to the last one, which bounds the walk) and a
// thread whose rows have all reached a tile's largest position skips the
// compares. An f32 cache lands in the f32 K / V tiles by cp.async (V
// during a tile's scores, the next K during its P.V); another kind is
// read as its own bytes into registers a stage ahead (the next K during
// the scores, the next V during P.V) and each thread widens the chunks it
// read into the f32 tile right after the barrier that frees it.
// Bound on the H100: arithmetic at the f32 rate (4 D FLOP a visible
// (row, slot) pair, 67 TFLOP/s). The wrapper picks BR (ops/lm_attention.py
// prefill_f32_rows): 128, or 64 where 128-row blocks would leave SMs
// idle (a question prefill of a few dozen tokens).
#include "f32_tile.cuh"

namespace {

constexpr int F32Q_MAX_SMEM = 232448;  // 227 KB a block

template <int DP, int BR, bool NARROW>
__global__ void __launch_bounds__(f32t::NT, 1)
gqa_prefill_f32_kernel(const float* __restrict__ q,
                       const void* __restrict__ k,
                       const void* __restrict__ v,
                       const int* __restrict__ qpos,
                       const int* __restrict__ eff,
                       const int* __restrict__ tile_mm,
                       const int* __restrict__ rows, float* __restrict__ out,
                       int B, int S, int Hq, int Hkv, int D, int T_cache,
                       int kv_len, int kv, float scale2) {
  using Sh = f32t::Shape<DP, BR>;
  constexpr int BK = f32t::BK, NT = f32t::NT, DS = Sh::DS;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BR * DS;
  float* Vs = Ks + BK * DS;
  float* Ps = Vs + BK * DS;
  float* alpha = Ps + BK * Sh::PST;
  float* lsum = alpha + BR;
  int* rpos = reinterpret_cast<int*>(lsum + BR);
  int* cpos = rpos + BR;     // two slots of a tile's eff positions
  int* red = cpos + 2 * BK;  // NT / 32

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = Hq / Hkv, R = S * G;
  const int b = blockIdx.y / Hkv, h = blockIdx.y % Hkv;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BR;  // last rows first
  const int n_tiles = (kv_len + BK - 1) / BK;
  const size_t tok = (size_t)Hkv * D;  // K/V elements between slots
  const size_t kv_row = rows ? rows[b] : b;  // the cache row of input row b
  const size_t base = kv_row * T_cache * tok + (size_t)h * D;
  const int* effb = eff + (size_t)b * kv_len;
  const int* tmin = tile_mm + (size_t)b * n_tiles;
  const int* tmax = tile_mm + ((size_t)B + b) * n_tiles;

  // zero head-dim padding of Q, K and V (no copy writes it)
  if (D < DP)
    for (int i = tid; i < (BR + 2 * BK) * (DP - D); i += NT)
      Qs[i / (DP - D) * DS + D + i % (DP - D)] = 0.f;
  const int CH = D / 4;  // 16-byte chunks of a Q row (and an f32 K/V row)
  const f32t::Div ch_div(CH);
  f32t::for_chunks(BR, ch_div, [&](int rr, int ch) {
    const int r = r0 + rr;
    const float* src = q;
    if (r < R)
      src = q + (((size_t)b * S + r / G) * Hq + h * G + r % G) * D + ch * 4;
    tc::cp_async16(Qs + rr * DS + ch * 4, src, r < R);
  });
  tc::cp_async_commit();
  int my = -1;
  if (tid < BR) {
    const int r = r0 + tid;
    my = r < R ? qpos[(size_t)b * S + r / G] : -1;
    rpos[tid] = my;
  }
  my = cs::warp_max_i(my);
  if (lane == 0) red[warp] = my;
  __syncthreads();
  int qmax = red[0];
  for (int w = 1; w < NT / 32; ++w) qmax = max(qmax, red[w]);
  int last = -1;  // the last tile any row of the block can see
  for (int i = tid; i < n_tiles; i += NT)
    if (tmin[i] <= qmax) last = i;
  last = cs::warp_max_i(last);
  __syncthreads();  // every thread has read qmax out of red
  if (lane == 0) red[warp] = last;
  __syncthreads();
  last = red[0];
  for (int w = 1; w < NT / 32; ++w) last = max(last, red[w]);
  const int end = last + 1;

  // this thread's own score rows' positions and the smallest of them
  constexpr int RH = Sh::RS / 2;
  int rp[RH], rmin = cs::SENTINEL;
#pragma unroll
  for (int i = 0; i < RH; ++i) {
    rp[i] = rpos[f32t::score_row(i, RH)];
    rmin = min(rmin, rp[i]);
  }

  auto next = [&](int t) {  // uniform across the block
    while (t < end && tmin[t] > qmax) ++t;
    return t;
  };
  // tile t's eff positions into slot `slot` (SENTINEL past kv_len)
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
  // an f32 cache: tile t's rows of src straight into the f32 tile
  auto copy_f32 = [&](float* dst, const void* src, int t) {
    const float* s0 = static_cast<const float*>(src) + base;
    const int k0 = t * BK;
    f32t::for_chunks(BK, ch_div, [&](int c, int ch) {
      const bool ok = k0 + c < kv_len;  // ragged last tile: zero rows
      tc::cp_async16(dst + c * DS + ch * 4,
                     ok ? s0 + (size_t)(k0 + c) * tok + ch * 4 : s0, ok);
    });
  };
  f32t::Rows<RH> st;
  st.init();
  f32t::Acc<DP, BR> o;
  f32t::zero<DP, BR>(o);
  // another kind: its own bytes through registers (f32t::Narrow)
  f32t::Narrow<DP> nar(kv, D);
  const size_t es = NARROW ? nar.rb / D : 4;  // bytes an element
  auto fetch = [&](const void* src, int t) {
    const uint8_t* s0 = static_cast<const uint8_t*>(src) + base * es;
    nar.fetch(s0 + (size_t)t * BK * tok * es, tok * es, kv_len - t * BK);
  };
  auto scores = [&](int t, int slot) {
    const int* cp = cpos + slot * BK;
    f32t::scores<DP, BR>(Qs, Ks, Ps, alpha, CH, scale2, tmax[t] <= rmin,
                         [&](int i, int c) { return rp[i] >= cp[c]; }, st);
  };
  // P.V's key loop unrolled 64 over an f32 cache, 16 over another kind
  // (the faster of 4, 8, 16 and 64 for each on the H100 at the ingest
  // prefill: the Narrow fetch holds 16 registers through P.V)
  auto accumulate = [&] {
    f32t::accumulate<DP, BR, NARROW ? 16 : 64>(Ps, Vs, alpha, o);
  };
  if constexpr (NARROW) {
    // K(t + 1) read during tile t's scores and widened after barrier B,
    // V(t + 1) read during its P.V and widened after the next barrier A
    f32t::stream(
        next(0), end, next,
        [&](int t) {
          fetch(k, t);
          nar.land(Ks, DS);
          copy_pos(t, 0);
          fetch(v, t);
        },
        [](int) {},
        [&](int, int tn) {
          nar.land(Vs, DS);
          if (tn < end) fetch(k, tn);
        },
        [&](int tn, int slot) {
          if (tn >= end) return;
          nar.land(Ks, DS);
          copy_pos(tn, slot);
          fetch(v, tn);
        },
        scores, accumulate);
  } else {
    // cp.async: V(t) during tile t's scores, K(t + 1) during its P.V
    f32t::stream(
        next(0), end, next,
        [&](int t) {
          copy_f32(Ks, k, t);
          copy_pos(t, 0);
        },
        [](int) {}, [&](int t, int) { copy_f32(Vs, v, t); },
        [&](int tn, int slot) {
          if (tn >= end) return;
          copy_f32(Ks, k, tn);
          copy_pos(tn, slot);
        },
        scores, accumulate);
  }
  tc::cp_async_wait<0>();
  f32t::finish(st, lsum);
  __syncthreads();
  f32t::store<DP, BR>(o, lsum, D, [&](int rr) -> float* {
    const int r = r0 + rr;
    return r < R ? out + (((size_t)b * S + r / G) * Hq + h * G + r % G) * D
                 : nullptr;
  });
}

template <int DP, int BR, bool NARROW>
int launch_prefill_f32(const void* q, const void* k, const void* v,
                       const void* qpos, const void* eff,
                       const void* tile_mm, const void* rows, void* out,
                       int B, int S, int Hq, int Hkv, int D, int T_cache,
                       int kv_len, int kv, float scale2, cudaStream_t st) {
  using Sh = f32t::Shape<DP, BR>;
  constexpr size_t bytes =
      (size_t)Sh::FLOATS * sizeof(float) +
      (size_t)(BR + 2 * f32t::BK + f32t::NT / 32) * sizeof(int);
  static_assert(bytes <= F32Q_MAX_SMEM, "shared memory of a block");
  auto kern = gqa_prefill_f32_kernel<DP, BR, NARROW>;
  // once per instantiation, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int R = S * (Hq / Hkv);
  const dim3 grid((R + BR - 1) / BR, B * Hkv);
  kern<<<grid, f32t::NT, bytes, st>>>(
      static_cast<const float*>(q), k, v, static_cast<const int*>(qpos),
      static_cast<const int*>(eff), static_cast<const int*>(tile_mm),
      static_cast<const int*>(rows), static_cast<float*>(out), B, S, Hq,
      Hkv, D, T_cache, kv_len, kv, scale2);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int dispatch_prefill_f32(int block_rows, const void* q, const void* k,
                         const void* v, const void* qpos, const void* eff,
                         const void* tile_mm, const void* rows, void* out,
                         int B, int S, int Hq, int Hkv, int D, int T_cache,
                         int kv_len, int kv, float scale2, cudaStream_t st) {
#define CS_PREFILL_F32(BR, NARROW)                                          \
  return launch_prefill_f32<DP, BR, NARROW>(q, k, v, qpos, eff, tile_mm,    \
                                            rows, out, B, S, Hq, Hkv, D,    \
                                            T_cache, kv_len, kv, scale2, st)
  if (block_rows == 128) {
    if (kv == cs::F32) CS_PREFILL_F32(128, false);
    CS_PREFILL_F32(128, true);
  }
  if (kv == cs::F32) CS_PREFILL_F32(64, false);
  CS_PREFILL_F32(64, true);
#undef CS_PREFILL_F32
}

}  // namespace

// K3's f32 route after the pre-pass: head dim D (a multiple of 4, at most
// 128, padded to 32, 64 or 128), block_rows 64 or 128, the cache's kind
// kv (f32, bf16, f16, e4m3 or e5m2); scale2 = scale * log2(e)
int prefill_f32q(int D, int block_rows, const void* q, const void* k,
                 const void* v, const void* qpos, const void* eff,
                 const void* tile_mm, const void* rows, void* out, int B,
                 int S, int Hq, int Hkv, int T_cache, int kv_len, int kv,
                 float scale2, cudaStream_t st) {
  if (block_rows != 64 && block_rows != 128)
    return static_cast<int>(cudaErrorInvalidValue);
#define CS_F32Q(DP)                                                        \
  if (D <= DP)                                                             \
    return dispatch_prefill_f32<DP>(block_rows, q, k, v, qpos, eff,        \
                                    tile_mm, rows, out, B, S, Hq, Hkv, D,  \
                                    T_cache, kv_len, kv, scale2, st);
  CS_F32Q(32) CS_F32Q(64) CS_F32Q(128)
#undef CS_F32Q
  return static_cast<int>(cudaErrorInvalidValue);
}
