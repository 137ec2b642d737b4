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
// * f32 queries: exact f32 products on the CUDA cores (the tiny f32
//   sessions hold card-vs-CPU greedy tokens through them).
//   - K3 f32 (cs_gqa_prefill_f32): the register-blocked f32 tile of
//     f32_tile.cuh (lm_attention_f32q.cu) after the tile min / max
//     pre-pass. A block owns 128 folded rows of one (batch, kv head), or
//     64 where 128-row blocks would leave SMs idle (the wrapper's
//     prefill_f32_rows), launched last rows first, and walks only the
//     tiles some row can see; a thread whose rows have all reached a
//     tile's largest position skips the compares. Bound on the H100:
//     arithmetic at the f32 rate (67 TFLOP/s), so the tile is register
//     blocked: each thread computes 8 x 4 scores (4 x 4 at 64 rows) by
//     outer products over head-dim chunks, and an O micro-tile in
//     registers from P staged key-major in shared memory.
//   - K4 f32 (cs_gqa_attention): the CUDA-core f32 tile of common.cuh
//     (attend_tile), one 256-thread block per (64-row tile, batch x kv
//     head, chunk of `chunk_tiles` key tiles), after the tile_min
//     pre-pass; each block writes its partial (m, l, acc) and
//     cs_gqa_combine merges the chunks.
//
// An e4m3 K/V cache (the fp8 KV cache, kv_dtype code E4M3): each route
// reads the cache's own bytes and converts them on chip, as the TPU
// kernels do (`k_ref[0].astype(q.dtype)`), so the K/V traffic from HBM
// halves against bf16 and no bf16 copy of the cache is ever made.
//   - K4 tensor-core kernel (K/V kind E4M3): cp.async copies the
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
//   - K3 tensor-core kernel (E4M3): the same widening in registers loses
//     here, since each of a block's warps reads every element of a tile,
//     so each would widen the whole tile (1.4x the bf16 kernel's time on
//     the H100, PERF.md). K3 widens each tile ONCE a block instead: two
//     byte stages of e4m3 rows, widened by all threads (tc::convert_tile)
//     into one of two bf16 K/V tiles that the unchanged bf16 body reads.
//     Tile t's math and tile t + 1's widening share one barrier interval
//     (one barrier a tile) while the bytes of t + 2 land. What bounds it
//     is the widening's issue slots and its bf16 stores beside the math,
//     so the 2-m-tile instance takes 8 warps (256 rows: the widening a
//     row halves; 176 KB, one block an SM). The 1-m-tile instance, for
//     prefills whose blocks would leave SMs idle, keeps 4 warps and 64
//     rows, so that such a prefill spreads over more SMs.
//   - f32 routes: K3's reads each tile's bytes into registers and each
//     thread widens the chunks it read into the f32 tile (f32_tile.cuh
//     Narrow); K4's (gqa_attention_kernel<float, __nv_fp8_e4m3>) widens
//     each element as it fills its f32 tile.
//
// The other cache dtypes (codes E5M2, F16, and F32 or BF16 under the other
// query dtype) take the same rule, K/V converted to q's compute dtype
// inside the tile, never as a copy of the cache:
//   - e5m2 under bf16 queries: e4m3's design, with the twin widening (an
//     e5m2 byte is the high byte of an f16: cvt.rn.f16x2.e5m2x2, exact);
//     K4 8 warps in registers, K3 once a block from byte stages.
//   - f16 or f32 under bf16 queries: rounded to bf16 (round to nearest
//     even, as `astype` does), then bf16's arithmetic.
//     K3 narrows in registers: after tile t's math a thread loads its
//     16-byte chunks of tile t + 1, rounds them and stores them into the
//     bf16 tile (no byte stage), one barrier a tile, in 8-warp blocks of
//     256 or 128 rows (f16 also 64 rows of 4 warps) by weighted waves:
//     the rounding, once a block, then weighs half as much a row as in
//     bf16's 128-row block. On the H100, rounding in place after a
//     cp.async into the bf16 tile, on bf16's instance, measured 1.27x bf16
//     over f16, and a single f32 byte stage whose chunks each thread
//     copies and rounds itself timed as the narrowing (PERF.md).
//     K4 keeps the cache's own bytes: each warp's K and V tiles land by
//     cp.async, two copy groups, as bf16's do (V lands during the scores,
//     the next K during P.V), and each B fragment is rounded in registers
//     just before its MMA, once (the warps read disjoint tiles): f16 from
//     ldmatrix on bf16's tile layout (two exact cvt.f32.f16, one
//     cvt.rn.bf16x2.f32 a register), f32 from swizzled f32 rows (8-byte
//     pairs along the head dim for Q.K^T, 16-byte chunks of four keys
//     paired along the keys for P.V, O's head dims permuted as for fp8).
//     f16 runs bf16's 4 warps (on bf16's split it gives the bf16
//     kernel's bits over the rounded cache); f32's K and V tiles take
//     64 KB a warp, so it runs 3 warps. Both round the split up to whole
//     tiles a warp. Measured on the H100 (PERF.md): f16 rounded in place
//     after its own cp.async, on bf16's plan, ran 1.18-1.37x bf16.
//   - bf16, f16 or e5m2 under f32 queries: widened exactly, as e4m3 is on
//     the f32 routes (K3 once a tile, each chunk by the thread that read
//     it; K4 as each element fills its tile, gqa_attention_kernel<float,
//     KV>).
// lm_attention_tc.cuh holds the tensor-core templates; each K/V kind's
// instances are built in a file of their own (this one: bf16;
// lm_attention_<kind>.cu: e4m3, e5m2, f16, f32; lm_attention_f32q.cu:
// K3's f32 route), so that nvcc builds them at once.
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
#include "lm_attention_tc.cuh"

namespace {

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

// K4 f32's first pass: each block's partial (m, l, acc) of its rows over
// its chunk of key tiles
template <typename T, typename KV>
__global__ void __launch_bounds__(cs::NT)
gqa_attention_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                     const KV* __restrict__ v, const int* __restrict__ qpos,
                     const int* __restrict__ eff,
                     const int* __restrict__ tile_min,
                     const int* __restrict__ rows,
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
               const void* eff, void* tile_min, const void* rows,
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
      static_cast<const int*>(rows), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), S, Hq, Hkv,
      D, T_cache, kv_len, chunk_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4 in f32 (bf16 goes to cs_gqa_decode_tc; K3 in f32 to
// cs_gqa_prefill_f32): the first pass, partials per chunk of chunk_tiles
// key tiles into part_m / part_l / part_acc (finish with
// cs_gqa_combine). k and v f32, bf16, f16, e4m3 or e5m2
// (kv_dtype), each element widened exactly to f32 as the tile is filled.
// rows: null, or the [B] int32 cache row of each input row.
extern "C" int cs_gqa_attention(const void* q, const void* k, const void* v,
                                const void* qpos, const void* eff,
                                void* tile_min, void* part_m, void* part_l,
                                void* part_acc, int B, int S, int Hq,
                                int Hkv, int D, int T_cache, int kv_len,
                                int chunk_tiles, int n_chunks, float scale,
                                int dtype, int kv_dtype, const void* rows,
                                void* stream) {
  if (dtype != cs::F32 || D % 4 != 0 || D > 4 * cs::MAX_D4 ||
      Hq % Hkv != 0 || kv_len > T_cache || part_m == nullptr ||
      part_l == nullptr || part_acc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CS_GQA_F32(CODE, KV)                                                \
  if (kv_dtype == CODE)                                                     \
    return launch_gqa<float, KV>(q, k, v, qpos, eff, tile_min, rows,        \
                                 part_m, part_l, part_acc, B, S, Hq, Hkv, D, \
                                 T_cache, kv_len, chunk_tiles, n_chunks,     \
                                 scale, st);
  CS_GQA_F32(cs::F32, float) CS_GQA_F32(cs::BF16, __nv_bfloat16)
  CS_GQA_F32(cs::F16, __half) CS_GQA_F32(cs::E4M3, __nv_fp8_e4m3)
  CS_GQA_F32(cs::E5M2, __nv_fp8_e5m2)
#undef CS_GQA_F32
  return static_cast<int>(cudaErrorInvalidValue);
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

// K3 in f32 (head dim a multiple of 4, at most 128): the tile min / max
// pre-pass into tile_mm ([2, B, n_tiles] int32), then the register-blocked
// f32 tile (lm_attention_f32q.cu) in blocks of block_rows (64 or 128)
// folded rows. k and v f32, bf16, f16, e4m3 or e5m2 (kv_dtype), widened
// exactly. Normalized output [B, S, Hq, D]. rows: null, or the [B] int32
// cache row of each input row (k, v are then [B_pool, T_cache, Hkv, D]).
extern "C" int cs_gqa_prefill_f32(const void* q, const void* k,
                                  const void* v, const void* qpos,
                                  const void* eff, void* tile_mm, void* out,
                                  int B, int S, int Hq, int Hkv, int D,
                                  int T_cache, int kv_len, int block_rows,
                                  float scale, int kv_dtype, const void* rows,
                                  void* stream) {
  if (D % 4 != 0 || D <= 0 || D > 128 || Hq % Hkv != 0 ||
      kv_len > T_cache || kv_dtype < cs::F32 || kv_dtype > cs::F16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (kv_len + cs::BK - 1) / cs::BK;
  if (n_tiles > 0)
    tile_minmax_kernel<<<dim3(n_tiles, B), cs::BK, 0, st>>>(
        static_cast<const int*>(eff), static_cast<int*>(tile_mm), B, kv_len,
        n_tiles);
  return prefill_f32q(D, block_rows, q, k, v, qpos, eff, tile_mm, rows, out,
                      B, S, Hq, Hkv, T_cache, kv_len, kv_dtype,
                      scale * tc::LOG2E, st);
}

// K3 in bf16 (head dim 64 or 128): the tile min / max pre-pass into
// tile_mm ([2, B, n_tiles] int32), then the tensor-core prefill tile.
// k and v bf16, e4m3, e5m2, f16 or f32 (kv_dtype). Normalized output
// [B, S, Hq, D].
// rows: null, or the [B] int32 cache row of each input row (k, v are then
// [B_pool, T_cache, Hkv, D]).
extern "C" int cs_gqa_prefill_tc(const void* q, const void* k, const void* v,
                                 const void* qpos, const void* eff,
                                 void* tile_mm, void* out, int B, int S,
                                 int Hq, int Hkv, int D, int T_cache,
                                 int kv_len, float scale, int kv_dtype,
                                 const void* rows, void* stream) {
  if ((D != 64 && D != 128) || Hq % Hkv != 0 || kv_len > T_cache ||
      kv_dtype < cs::F32 || kv_dtype > cs::F16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (kv_len + cs::BK - 1) / cs::BK;
  if (n_tiles > 0)
    tile_minmax_kernel<<<dim3(n_tiles, B), cs::BK, 0, st>>>(
        static_cast<const int*>(eff), static_cast<int*>(tile_mm), B, kv_len,
        n_tiles);
  const float scale2 = scale * tc::LOG2E;
  switch (kv_dtype) {
#define CS_PREFILL_TC(CODE, FN)                                           \
  case CODE:                                                              \
    return FN(D, q, k, v, qpos, eff, tile_mm, rows, out, B, S, Hq, Hkv,   \
              T_cache, kv_len, scale2, st);
    CS_PREFILL_TC(cs::BF16, prefill_tc_kind<cs::BF16>)
    CS_PREFILL_TC(cs::E4M3, prefill_tc_e4m3)
    CS_PREFILL_TC(cs::E5M2, prefill_tc_e5m2)
    CS_PREFILL_TC(cs::F16, prefill_tc_f16)
    CS_PREFILL_TC(cs::F32, prefill_tc_f32)
#undef CS_PREFILL_TC
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4 in bf16 (head dim 64 or 128, mt in {1, 2}: m-tiles per warp, so
// 16 * mt folded rows per block; k and v bf16, e4m3, e5m2, f16 or f32,
// kv_dtype): one launch per decode attention call.
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
      kv_dtype < cs::F32 || kv_dtype > cs::F16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale2 = scale * tc::LOG2E;
  switch (kv_dtype) {
#define CS_DECODE_TC(CODE, FN)                                            \
  case CODE:                                                              \
    return FN(D, mt, q, k, v, qpos, eff, rows, part_ml, part_acc, tickets, \
              out, B, S, Hq, Hkv, T_cache, kv_len, tiles_per_split,        \
              n_splits, scale2, st);
    CS_DECODE_TC(cs::BF16, decode_tc_kind<cs::BF16>)
    CS_DECODE_TC(cs::E4M3, decode_tc_e4m3)
    CS_DECODE_TC(cs::E5M2, decode_tc_e5m2)
    CS_DECODE_TC(cs::F16, decode_tc_f16)
    CS_DECODE_TC(cs::F32, decode_tc_f32)
#undef CS_DECODE_TC
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// warps a block of cs_gqa_decode_tc over a kv_dtype cache (decode_plan
// in ops/lm_attention.py mirrors them: DECODE_WARPS); -1 for another code
extern "C" int cs_decode_tc_warps(int kv_dtype) {
  switch (kv_dtype) {
    case cs::F32: return dec_warps<cs::F32>();
    case cs::BF16: return dec_warps<cs::BF16>();
    case cs::E4M3: return dec_warps<cs::E4M3>();
    case cs::E5M2: return dec_warps<cs::E5M2>();
    case cs::F16: return dec_warps<cs::F16>();
  }
  return -1;
}
