// The f32 flash-attention tile of K1's and K3's f32 routes
// (vision_attention.cu, lm_attention_f32q.cu) on the H100's CUDA cores.
// Every product is an exact f32 FMA: no tensor cores, since TF32 would
// round the operands and the tiny f32 sessions hold card-vs-CPU greedy
// tokens through these routes.
//
// What bounds it on the H100: the FFMA issue rate (67 TFLOP/s in f32:
// one warp FFMA a clock on each SM sub-partition) and the shared-memory
// bytes the FFMAs need (128 bytes a clock an SM reach the threads, so an
// LDS.128 costs 4 clocks however many threads share its address: a
// stage needs at most one byte loaded an FFMA to keep up). The tile
// blocks registers for both, in a block of 256 threads over BR query
// rows (64 or 128) and 64-key tiles:
//  * scores: lanes l and l ^ 16 of a warp share one (rg, kg) pair of 16
//    row groups x 8 key groups, rows rg + 16 i and keys kg + 8 j (8 x 8
//    at BR = 128), each over half of the head-dim chunks: per chunk 8
//    LDS.128 of Q and 8 of K for 256 FFMAs (one byte an FFMA; a 16 x 16
//    grid of 8 x 4 tiles over all of D needs 1.5, and measured slower on
//    the H100). The two halves add their partial sums by one shuffle a
//    score, each keeping the totals of half the rows. Rows are padded to
//    DS = DP + 4 floats, so a warp's 8 consecutive keys hit distinct
//    banks.
//  * softmax: online, in the log2 domain (scale * log2(e) folded into
//    one FMA before exp2f); a row's max is reduced over its 8 key groups
//    by shuffles, its sum stays per thread until the end. Masked scores
//    are -inf; a thread whose rows all see all its keys skips the
//    compares.
//  * P.V: P goes through shared memory key-major (P[key][row]) with each
//    row's rescale factor; thread (rg, dg) keeps an O micro-tile of RPT
//    rows x GPT float4 head-dim groups in registers: per key RPT / 4 (or
//    one narrower) loads of P and GPT LDS.128 of V for 4 RPT GPT FFMAs (8
//    rows x 8 dims at DP = 128, BR = 128: one byte an FFMA). At DP = 80
//    (K1's D = 72) lanes l and l ^ 16 split the tile's keys over one 4 x
//    20 micro-tile, adding their sums once a block (a 2 x 20 tile needs
//    2.2 bytes an FFMA, and K1 measured slower with it).
// The head dim is padded to DP (32, 64, 80 or 128) in shared memory with
// zero columns; the score loop runs over the real D / 4 chunks, P.V over
// DP / 4 groups.
//
// stream() runs the key tiles with ONE K tile and ONE V tile in shared
// memory (Q 66 KB, K, V and P 33 KB each at D = 128, BR = 128: 169,984
// bytes, one block an SM) and two barriers a tile, A before the scores
// and B before P.V; each tile's data moves while the other stage runs:
//  * an f32 cache and K1's rows arrive by cp.async: V(t) during tile t's
//    scores, K(t + 1) during its P.V, each waited for before the next
//    barrier; K1 rotates the K chunks it copied in place, by the thread
//    that copied them (their cos / sin rows land with them);
//  * a bf16, f16, e4m3 or e5m2 cache under f32 queries (Narrow) is read
//    as its own bytes into registers (__ldg) a stage ahead, K(t + 1)
//    during tile t's scores and V(t + 1) during its P.V, and each thread
//    widens the chunks it read into the f32 tile right after the barrier
//    that frees it, so the stores drain while the next stage computes.
//    The cache is never copied in another dtype, and no byte stage
//    crosses shared memory. On the H100 at K3's ingest prefill every
//    other form tried measured slower: widening right before a barrier
//    (from registers or from cp.async byte stages), in the middle of a
//    stage, or as the score and P.V loops read K and V bytes.
#pragma once

#include "common.cuh"
#include "tc_tile.cuh"

namespace f32t {

constexpr int NT = 256;  // threads a block: 16 x 16 in both stages
constexpr int BK = 64;   // keys a tile
constexpr int KPT = 8;   // keys a thread in the score stage: kg + 8 j

// The score stage's threads: lanes l and l ^ 16 of a warp share one
// (rg, kg) pair, rows rg + 16 i and keys kg + 8 j, each over half of the
// head-dim chunks (score_half); warp w holds row groups 2w and 2w + 1.
__device__ __forceinline__ int score_half() { return (threadIdx.x >> 4) & 1; }
__device__ __forceinline__ int score_rg() {
  return ((threadIdx.x >> 5) << 1) | ((threadIdx.x >> 3) & 1);
}
__device__ __forceinline__ int score_kg() { return threadIdx.x & 7; }
// the block row of own row ii (of RH) of this score thread
__device__ __forceinline__ int score_row(int ii, int RH) {
  return score_rg() + 16 * (score_half() * RH + ii);
}

// float4 head-dim groups a thread owns in P.V, by padded head dim
__host__ __device__ constexpr int pv_groups(int DP) {
  return DP == 80 ? 5 : 2;
}

// i / n for 0 <= i < 2^16 by one multiply-high (exact there: the error of
// ceil(2^32 / n) times i stays below 1 / n); the copy loops' row of a
// chunk without an integer division
struct Div {
  int n;
  unsigned magic;
  __device__ explicit Div(int n_) : n(n_), magic(0xffffffffu / n_ + 1u) {}
  __device__ int quo(int i) const {
    return n == 1 ? i : (int)__umulhi((unsigned)i, magic);
  }
};

// f(c, ch) for the chunks i = tid, tid + NT, ... of `rows` rows of d.n
// chunks (c = i / n, ch = i % n): the chunks this thread copies, and later
// converts, of a tile
template <class F>
__device__ __forceinline__ void for_chunks(int rows, const Div& d, F f) {
  for (int i = threadIdx.x; i < rows * d.n; i += NT) {
    const int c = d.quo(i);
    f(c, i - c * d.n);
  }
}

template <int DP, int BR>
struct Shape {
  static_assert(DP == 32 || DP == 64 || DP == 80 || DP == 128,
                "padded head dim");
  static_assert(BR == 64 || BR == 128, "rows a block");
  static constexpr int DS = DP + 4;          // floats a Q / K / V row
  static constexpr int DS4 = DS / 4;
  static constexpr int PST = BR + 4;         // floats a key's P row
  static constexpr int RS = BR / 16;         // score rows of a thread pair
  static constexpr int GPT = pv_groups(DP);  // P.V float4 groups a thread
  static constexpr int DG = DP / 4 / GPT;    // P.V head-dim groups
  // P.V key halves: at DP = 80 lanes l and l ^ 16 take the tile's keys
  // 0-31 and 32-63 of one O micro-tile (their sums added once, at the
  // end), so that a thread's tile is 4 rows x 5 groups, not 2 x 5
  static constexpr int KS = DP == 80 ? 2 : 1;
  static constexpr int RPT = BR * DG * KS / NT;  // P.V rows a thread
  static_assert(DG * GPT * 4 == DP && RPT >= 1, "P.V layout");
  // floats of Q, K, V, P, the rows' rescale factors and sums
  static constexpr int FLOATS = (BR + 2 * BK) * DS + BK * PST + 2 * BR;
};

// online-softmax state of a score thread's rows (half of its pair's):
// max (log2 domain) and the thread's part of the sum
template <int RS>
struct Rows {
  float m[RS], l[RS];
  __device__ void init() {
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
  }
};

// S = Q K^T for this thread's rows and keys over its half of the first
// d4 head-dim chunks; the two halves of a pair add their partial sums by
// one shuffle each (no shared memory, no barrier), each keeping the
// totals of half of the rows (row slots half * RS / 2 + ii, ii < RS /
// 2: the thread's own rows). Then the mask (visible(ii, c): may own row
// ii see key column c; all: every own row sees every key of the
// thread) and one online-softmax step of those rows: P into Ps, each
// row's rescale factor into alpha (by the row's kg == 0 thread).
template <int DP, int BR, class Visible>
__device__ __forceinline__ void scores(const float* Qs, const float* Ks,
                                       float* Ps, float* alpha, int d4,
                                       float scale2, bool all,
                                       Visible visible,
                                       Rows<BR / 32>& st) {
  using Sh = Shape<DP, BR>;
  constexpr int RS = Sh::RS, RH = RS / 2, DS4 = Sh::DS4;
  const int half = score_half(), rg = score_rg(), kg = score_kg();
  const float4* q4 = reinterpret_cast<const float4*>(Qs) + rg * DS4;
  const float4* k4 = reinterpret_cast<const float4*>(Ks) + kg * DS4;
  const int mid = (d4 + 1) / 2;
  float s[RS][KPT];
#pragma unroll
  for (int i = 0; i < RS; ++i)
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int c = half ? mid : 0; c < (half ? d4 : mid); ++c) {
    float4 a[RS], b[KPT];
#pragma unroll
    for (int i = 0; i < RS; ++i) a[i] = q4[i * 16 * DS4 + c];
#pragma unroll
    for (int j = 0; j < KPT; ++j) b[j] = k4[j * 8 * DS4 + c];
#pragma unroll
    for (int i = 0; i < RS; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        float t = s[i][j];
        t = fmaf(a[i].x, b[j].x, t);
        t = fmaf(a[i].y, b[j].y, t);
        t = fmaf(a[i].z, b[j].z, t);
        s[i][j] = fmaf(a[i].w, b[j].w, t);
      }
  }
  // this thread's rows: slots half * RH + ii; the partner sends the
  // partial sums of them and takes those of its own rows
  float t[RH][KPT];
#pragma unroll
  for (int ii = 0; ii < RH; ++ii)
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float send = half ? s[ii][j] : s[RH + ii][j];
      const float mine = half ? s[RH + ii][j] : s[ii][j];
      t[ii][j] = mine + __shfl_xor_sync(0xffffffffu, send, 16);
    }
  const int i0 = half * RH;
  if (!all) {
#pragma unroll
    for (int ii = 0; ii < RH; ++ii)
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        if (!visible(ii, kg + 8 * j)) t[ii][j] = -INFINITY;
  }
#pragma unroll
  for (int ii = 0; ii < RH; ++ii) {
    float mx = t[ii][0];
#pragma unroll
    for (int j = 1; j < KPT; ++j) mx = fmaxf(mx, t[ii][j]);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(st.m[ii], mx * scale2);
    // a row that has seen nothing yet keeps m = -inf and p = 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float a = exp2f(st.m[ii] - m_use);
    st.m[ii] = m_new;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = exp2f(fmaf(t[ii][j], scale2, -m_use));
      t[ii][j] = p;
      ps += p;
    }
    st.l[ii] = st.l[ii] * a + ps;
    if (kg == 0) alpha[rg + 16 * (i0 + ii)] = a;
  }
#pragma unroll
  for (int j = 0; j < KPT; ++j)
#pragma unroll
    for (int ii = 0; ii < RH; ++ii)
      Ps[(kg + 8 * j) * Sh::PST + rg + 16 * (i0 + ii)] = t[ii][j];
}

// N consecutive floats of a P row (aligned to min(N, 4) floats)
template <int N>
__device__ __forceinline__ void load_p(float (&p)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int u = 0; u < N; u += 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + u);
      p[u] = x.x;
      p[u + 1] = x.y;
      p[u + 2] = x.z;
      p[u + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    p[0] = x.x;
    p[1] = x.y;
  } else {
    p[0] = *src;
  }
}

template <int DP, int BR>
using Acc = float4[Shape<DP, BR>::RPT][Shape<DP, BR>::GPT];

// thread (rg, dg)'s O micro-tile in P.V and its key half kh
template <int DP, int BR>
__device__ __forceinline__ void pv_thread(int& rg, int& dg, int& kh) {
  using Sh = Shape<DP, BR>;
  const int tid = threadIdx.x;
  const int t = Sh::KS == 2 ? ((tid >> 5) << 4) | (tid & 15) : tid;
  kh = Sh::KS == 2 ? (tid >> 4) & 1 : 0;
  rg = t / Sh::DG;
  dg = t % Sh::DG;
}

// O = alpha O + P V over one key tile (this thread's key half) for thread
// (rg, dg)'s micro-tile, the key loop unrolled U times
template <int DP, int BR, int U>
__device__ __forceinline__ void accumulate(const float* Ps, const float* Vs,
                                           const float* alpha,
                                           Acc<DP, BR>& o) {
  using Sh = Shape<DP, BR>;
  constexpr int RPT = Sh::RPT, GPT = Sh::GPT, DG = Sh::DG;
  constexpr int KN = BK / Sh::KS;  // keys a thread
  int rg, dg, kh;
  pv_thread<DP, BR>(rg, dg, kh);
  const float* p0 = Ps + kh * KN * Sh::PST + rg * RPT;
  const float4* v4 =
      reinterpret_cast<const float4*>(Vs) + kh * KN * Sh::DS4 + dg;
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const float a = alpha[rg * RPT + u];
#pragma unroll
    for (int g = 0; g < GPT; ++g) {
      o[u][g].x *= a;
      o[u][g].y *= a;
      o[u][g].z *= a;
      o[u][g].w *= a;
    }
  }
#pragma unroll U
  for (int c = 0; c < KN; ++c) {
    float p[RPT];
    load_p<RPT>(p, p0 + c * Sh::PST);
    float4 v[GPT];
#pragma unroll
    for (int g = 0; g < GPT; ++g) v[g] = v4[c * Sh::DS4 + DG * g];
#pragma unroll
    for (int u = 0; u < RPT; ++u)
#pragma unroll
      for (int g = 0; g < GPT; ++g) {
        o[u][g].x = fmaf(p[u], v[g].x, o[u][g].x);
        o[u][g].y = fmaf(p[u], v[g].y, o[u][g].y);
        o[u][g].z = fmaf(p[u], v[g].z, o[u][g].z);
        o[u][g].w = fmaf(p[u], v[g].w, o[u][g].w);
      }
  }
}

template <int DP, int BR>
__device__ __forceinline__ void zero(Acc<DP, BR>& o) {
#pragma unroll
  for (int u = 0; u < Shape<DP, BR>::RPT; ++u)
#pragma unroll
    for (int g = 0; g < Shape<DP, BR>::GPT; ++g)
      o[u][g] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// each of this thread's rows' sum over its 8 key groups into lsum (by
// its kg == 0 thread)
template <int RH>
__device__ __forceinline__ void finish(const Rows<RH>& st, float* lsum) {
  const int rg = score_rg(), kg = score_kg(), i0 = score_half() * RH;
#pragma unroll
  for (int ii = 0; ii < RH; ++ii) {
    float l = st.l[ii];
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (kg == 0) lsum[rg + 16 * (i0 + ii)] = l;
  }
}

// O / l of this thread's rows (after finish() and a barrier) into
// dst(row of the block), a row pointer or nullptr for a row not written;
// the first D head dims; a row that saw nothing (l = 0) is 0
template <int DP, int BR, class Dst>
__device__ __forceinline__ void store(Acc<DP, BR>& o, const float* lsum,
                                      int D, Dst dst) {
  using Sh = Shape<DP, BR>;
  int rg, dg, kh;
  pv_thread<DP, BR>(rg, dg, kh);
  if constexpr (Sh::KS == 2) {  // the two key halves' sums
#pragma unroll
    for (int u = 0; u < Sh::RPT; ++u)
#pragma unroll
      for (int g = 0; g < Sh::GPT; ++g) {
        o[u][g].x += __shfl_xor_sync(0xffffffffu, o[u][g].x, 16);
        o[u][g].y += __shfl_xor_sync(0xffffffffu, o[u][g].y, 16);
        o[u][g].z += __shfl_xor_sync(0xffffffffu, o[u][g].z, 16);
        o[u][g].w += __shfl_xor_sync(0xffffffffu, o[u][g].w, 16);
      }
    if (kh) return;
  }
#pragma unroll
  for (int u = 0; u < Sh::RPT; ++u) {
    const int rr = rg * Sh::RPT + u;
    float* row = dst(rr);
    if (row == nullptr) continue;
    const float l = lsum[rr];
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int g = 0; g < Sh::GPT; ++g) {
      const int gg = dg + Sh::DG * g;
      if (4 * gg < D)
        reinterpret_cast<float4*>(row)[gg] =
            make_float4(o[u][g].x * inv, o[u][g].y * inv, o[u][g].z * inv,
                        o[u][g].w * inv);
    }
  }
}

// The key tiles t, next(t + 1), ... before end through one K and one V
// tile, two barriers a tile (A before a tile's scores, B before its P.V;
// see the header). The hooks move the tiles: start(t) begins the first
// tile; before_a(slot) finishes K(t) in this thread's chunks (after its
// copies landed); after_a(t, tn) and after_b(tn, slot) run right after
// the barriers, when V, then K, is free, so a hook's stores or copies
// overlap the stage that follows. Every hook's cp.async copies are
// committed as one group; the caller has committed its own (Q) before
// and waits for every group after. scores(t, slot) and accumulate() are
// the tile's two stages (K(t)'s key tags in slot `slot`).
template <class Next, class Start, class BeforeA, class AfterA,
          class AfterB, class Scores, class Accumulate>
__device__ __forceinline__ void stream(int t, int end, Next next,
                                       Start start, BeforeA before_a,
                                       AfterA after_a, AfterB after_b,
                                       Scores scores, Accumulate accumulate) {
  if (t >= end) return;
  start(t);
  tc::cp_async_commit();
  int slot = 0;
  while (t < end) {
    const int tn = next(t + 1);
    tc::cp_async_wait<0>();
    before_a(slot);
    __syncthreads();  // A: K(t) and its tags visible; V, P, alpha free
    after_a(t, tn);
    tc::cp_async_commit();
    scores(t, slot);
    tc::cp_async_wait<0>();
    __syncthreads();  // B: V(t), P and alpha visible; K free
    after_b(tn, slot ^ 1);
    tc::cp_async_commit();
    accumulate();
    t = tn;
    slot ^= 1;
  }
}

// two (16-bit kinds: bf16, f16) or four (fp8: e4m3, e5m2) elements of a
// K/V row in a 32-bit word widened exactly to f32
template <int KV>
__device__ __forceinline__ float2 widen2(uint32_t w) {
  if constexpr (KV == cs::BF16) {
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  } else {
    static_assert(KV == cs::F16, "a 16-bit kind");
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  }
}
template <int KV>
__device__ __forceinline__ float4 widen4(uint32_t w) {
  static_assert(tc::is_f8(KV), "an fp8 kind");
  const auto kind = KV == cs::E4M3 ? __NV_E4M3 : __NV_E5M2;
  const float2 lo = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), kind)));
  const float2 hi = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w >> 16), kind)));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
// a 32-bit word of a K/V row of kind KV widened exactly to f32 at dst
// (aligned to its width)
template <int KV>
__device__ __forceinline__ void widen_word(float* dst, uint32_t w) {
  if constexpr (tc::is_f8(KV)) {
    *reinterpret_cast<float4*>(dst) = widen4<KV>(w);
  } else {
    *reinterpret_cast<float2*>(dst) = widen2<KV>(w);
  }
}

// A K or V tile of a bf16, f16, e4m3 or e5m2 cache (kind code kv) on its
// way into the f32 tile: fetch() reads this thread's chunks of the tile's
// rows (16 bytes, or 4 where a row of rb bytes is not a whole number of
// 16-byte chunks; zeros past the last row) into registers as the cache's
// own bytes, land() widens them exactly into the f32 tile (row stride ds
// floats). At most MW words a thread: a 16-bit kind at head dim DP.
template <int DP>
struct Narrow {
  static constexpr int MW = BK * DP * 2 / 4 / NT;
  uint32_t w[MW];
  int kv, rb, cb;
  Div chunks;  // chunks a row
  __device__ Narrow(int kv_, int D)
      : kv(kv_),
        rb(D * (kv_ == cs::BF16 || kv_ == cs::F16 ? 2 : 1)),
        cb(rb % 16 == 0 ? 16 : 4),
        chunks(rb / cb) {}

  // rows [0, n_rows) of the tile, row c at src + c * stride bytes
  __device__ __forceinline__ void fetch(const uint8_t* src, size_t stride,
                                        int n_rows) {
    const int total = BK * chunks.n;
    if (cb == 16) {
#pragma unroll
      for (int u = 0; u < MW / 4; ++u) {
        const int i = threadIdx.x + u * NT;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (i < total) {
          const int c = chunks.quo(i);
          if (c < n_rows)
            x = __ldg(reinterpret_cast<const uint4*>(
                src + c * stride + (i - c * chunks.n) * 16));
        }
        w[4 * u] = x.x;
        w[4 * u + 1] = x.y;
        w[4 * u + 2] = x.z;
        w[4 * u + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < MW; ++u) {
        const int i = threadIdx.x + u * NT;
        uint32_t x = 0u;
        if (i < total) {
          const int c = chunks.quo(i);
          if (c < n_rows)
            x = __ldg(reinterpret_cast<const unsigned*>(
                src + c * stride + (i - c * chunks.n) * 4));
        }
        w[u] = x;
      }
    }
  }

  template <int KV>
  __device__ __forceinline__ void land(float* dst, int ds) const {
    constexpr int ES = tc::is_f8(KV) ? 1 : 2;
    const int total = BK * chunks.n;
    if (cb == 16) {
#pragma unroll
      for (int u = 0; u < MW / 4; ++u) {
        const int i = threadIdx.x + u * NT;
        if (i < total) {
          const int c = chunks.quo(i);
          float* d = dst + c * ds + (i - c * chunks.n) * (16 / ES);
          if constexpr (tc::is_f8(KV)) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              reinterpret_cast<float4*>(d)[e] = widen4<KV>(w[4 * u + e]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const float2 lo = widen2<KV>(w[4 * u + e]);
              const float2 hi = widen2<KV>(w[4 * u + e + 1]);
              reinterpret_cast<float4*>(d)[e / 2] =
                  make_float4(lo.x, lo.y, hi.x, hi.y);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < MW; ++u) {
        const int i = threadIdx.x + u * NT;
        if (i < total) {
          const int c = chunks.quo(i);
          widen_word<KV>(dst + c * ds + (i - c * chunks.n) * (4 / ES),
                         w[u]);
        }
      }
    }
  }

  __device__ __forceinline__ void land(float* dst, int ds) const {
    switch (kv) {
      case cs::BF16: land<cs::BF16>(dst, ds); break;
      case cs::F16: land<cs::F16>(dst, ds); break;
      case cs::E4M3: land<cs::E4M3>(dst, ds); break;
      case cs::E5M2: land<cs::E5M2>(dst, ds); break;
    }
  }
};

}  // namespace f32t
