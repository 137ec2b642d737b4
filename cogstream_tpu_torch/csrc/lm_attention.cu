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
// One kernel serves both. A 256-thread block owns (query-row tile, batch
// x kv head, key chunk) and walks the 64-slot key tiles of its chunk
// with an f32 online softmax (common.cuh attend_tile).
// * K3 (prefill, many rows): one chunk spans the whole cache; the block
//   writes normalized rows. A pre-pass stores each 64-slot tile's
//   smallest eff position, and a block skips every tile whose smallest
//   position exceeds its largest query position — the causal tail and
//   the empty cache beyond the write index cost one integer compare.
//   Bound on the H100: arithmetic; the CUDA-core f32 tile is the simple
//   first form (tensor-core tiles come later).
// * K4 (decode, S <= 8 rows per kv head): one block per kv head would
//   fill 4 of 132 SMs, so the cache splits into chunks of `chunk_tiles`
//   tiles (flash-decoding): each block writes its partial (m, l, acc)
//   and cs_gqa_combine merges the chunks. Bound on the H100: reading the
//   cache's K/V bytes; the split puts every SM on that read.
//
// The port writes each decode step's K/V IN PLACE into the cache before
// attention (runtime/generate.py), so K4 needs no side buffer or fresh
// K/V stream: the TPU kernel's main (+) side (+) fresh folding becomes
// one cache range.
#include "common.cuh"

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

template <typename T>
__global__ void __launch_bounds__(cs::NT)
gqa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ qpos,
                     const int* __restrict__ eff,
                     const int* __restrict__ tile_min, T* __restrict__ out,
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
      const size_t off = (((size_t)b * T_cache + k0 + c) * Hkv + h) * D + d;
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

template <typename T>
int launch_gqa(const void* q, const void* k, const void* v, const void* qpos,
               const void* eff, void* tile_min, void* out, void* part_m,
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
  auto kern = gqa_attention_kernel<T>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  const dim3 grid((R + cs::BR - 1) / cs::BR, B * Hkv, n_chunks);
  kern<<<grid, cs::NT, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(eff), static_cast<const int*>(tile_min),
      static_cast<T*>(out), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), S, Hq, Hkv,
      D, T_cache, kv_len, chunk_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part_m == nullptr: K3 (one chunk, normalized output). Otherwise K4's
// first pass (partials per chunk; finish with cs_gqa_combine).
extern "C" int cs_gqa_attention(const void* q, const void* k, const void* v,
                                const void* qpos, const void* eff,
                                void* tile_min, void* out, void* part_m,
                                void* part_l, void* part_acc, int B, int S,
                                int Hq, int Hkv, int D, int T_cache,
                                int kv_len, int chunk_tiles, int n_chunks,
                                float scale, int dtype, void* stream) {
  if (D % 4 != 0 || D > 4 * cs::MAX_D4 || Hq % Hkv != 0 || kv_len > T_cache ||
      (part_m == nullptr && n_chunks != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cs::BF16)
    return launch_gqa<__nv_bfloat16>(q, k, v, qpos, eff, tile_min, out,
                                     part_m, part_l, part_acc, B, S, Hq, Hkv,
                                     D, T_cache, kv_len, chunk_tiles,
                                     n_chunks, scale, st);
  return launch_gqa<float>(q, k, v, qpos, eff, tile_min, out, part_m, part_l,
                           part_acc, B, S, Hq, Hkv, D, T_cache, kv_len,
                           chunk_tiles, n_chunks, scale, st);
}

extern "C" int cs_gqa_combine(const void* part_m, const void* part_l,
                              const void* part_acc, void* out, int B, int S,
                              int Hq, int Hkv, int D, int n_chunks, int dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * Hkv, S * (Hq / Hkv));
  if (dtype == cs::BF16)
    gqa_combine_kernel<__nv_bfloat16><<<grid, D, 0, st>>>(
        static_cast<const float*>(part_m), static_cast<const float*>(part_l),
        static_cast<const float*>(part_acc), static_cast<__nv_bfloat16*>(out),
        S, Hq, Hkv, D, n_chunks);
  else
    gqa_combine_kernel<float><<<grid, D, 0, st>>>(
        static_cast<const float*>(part_m), static_cast<const float*>(part_l),
        static_cast<const float*>(part_acc), static_cast<float*>(out), S, Hq,
        Hkv, D, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
