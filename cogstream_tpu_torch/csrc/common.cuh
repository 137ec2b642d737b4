// Shared helpers for the cogstream_tpu_torch kernels: dtype conversion,
// warp reductions, and the f32 online-softmax attention tile that the f32
// routes of the decode (K4) and segment (K5) kernels run. The f32 routes of
// the vision (K1) and prefill (K3) kernels run the register-blocked tile
// of f32_tile.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cs {

// dtype codes, shared with ops/kernels.py DTYPE_CODES (E4M3, E5M2, F16: a
// K/V cache only, KV_DTYPE_CODES)
enum DType { F32 = 0, BF16 = 1, E4M3 = 2, E5M2 = 3, F16 = 4 };

constexpr float NEG_INF = -1e30f;     // ops/attention.py NEG_INF
constexpr int SENTINEL = 1 << 30;     // eff position of an invisible slot

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// exact: every e4m3, e5m2 and f16 value is an f32 value
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f(__nv_fp8_e5m2 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ int warp_max_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int warp_min_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
// reductions over the 4 lanes of a quad (the 4 threads sharing a row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// Attention tile of K4's and K5's f32 routes: BR query rows x BK key
// columns, 256 threads. Thread `tid` owns row r = tid / 4; the four
// threads of a quad split the key columns (c = quad + 4j) for the scores
// and the head-dim float4 groups (g = quad + 4j) for P.V. Q, K and V tiles
// sit in shared memory as f32 rows of stride D + 4 floats (the pad spreads
// rows over the banks). Scores, softmax and the P.V accumulation are all
// f32. Each thread re-reads its Q row and its P row from shared memory for
// every key (about one LDS.128 for 4 FFMAs), so it runs at ~10-13% of the
// H100's f32 rate (PERF.md); K1 and K3 left it for f32_tile.cuh, whose
// register-blocked tiles need about one byte loaded an FFMA.
// ---------------------------------------------------------------------------
constexpr int BR = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int PS = BK + 1;       // P tile row stride (bank spread)
constexpr int MAX_D4 = 32;       // head dim <= 128, multiple of 4
constexpr int ACC4 = MAX_D4 / 4; // float4 accumulators per thread

struct RowState {
  float m, l;
  float4 acc[ACC4];
  __device__ void init() {
    m = NEG_INF;
    l = 0.f;
#pragma unroll
    for (int j = 0; j < ACC4; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

__host__ __device__ constexpr int tile_smem_floats(int D) {
  return 3 * BR * (D + 4) + BR * PS;  // Qs, Ks, Vs (BK == BR), Ps
}

// One online-softmax step over a loaded K/V tile with `ncols` valid
// columns. mask(r, c) says whether query row r may see key column c.
template <class Mask>
__device__ __forceinline__ void attend_tile(const float* Qs, const float* Ks,
                                            const float* Vs, float* Ps,
                                            int D, int ncols, float scale,
                                            Mask mask, RowState& st) {
  const int tid = threadIdx.x, r = tid >> 2, quad = tid & 3;
  const int DS = D + 4, D4 = D >> 2, DS4 = DS >> 2;
  const float4* q4 = reinterpret_cast<const float4*>(Qs + r * DS);
  float s[BK / 4];
  float mt = NEG_INF;
#pragma unroll
  for (int j = 0; j < BK / 4; ++j) {
    const int c = quad + 4 * j;
    float val = NEG_INF;
    if (c < ncols && mask(r, c)) {
      const float4* k4 = reinterpret_cast<const float4*>(Ks + c * DS);
      float dot = 0.f;
      for (int g = 0; g < D4; ++g) {
        const float4 a = q4[g], b = k4[g];
        dot += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
      }
      val = dot * scale;
      mt = fmaxf(mt, val);
    }
    s[j] = val;
  }
  mt = quad_max(mt);
  const float m_new = fmaxf(st.m, mt);
  float psum = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 4; ++j) {
    // masked scores carry NEG_INF; a fully masked row keeps p = 0
    const float p = s[j] > NEG_INF * 0.5f ? expf(s[j] - m_new) : 0.f;
    Ps[r * PS + quad + 4 * j] = p;
    psum += p;
  }
  psum = quad_sum(psum);
  const float alpha = st.m > NEG_INF * 0.5f ? expf(st.m - m_new) : 0.f;
  st.l = st.l * alpha + psum;
  st.m = m_new;
  __syncwarp();  // a row's P entries come from its own quad
  const float4* v4 = reinterpret_cast<const float4*>(Vs);
#pragma unroll
  for (int jj = 0; jj < ACC4; ++jj) {
    const int g = quad + 4 * jj;
    if (g < D4) {
      float4 a = st.acc[jj];
      a.x *= alpha; a.y *= alpha; a.z *= alpha; a.w *= alpha;
      for (int c = 0; c < ncols; ++c) {
        const float p = Ps[r * PS + c];
        const float4 vv = v4[c * DS4 + g];
        a.x += p * vv.x; a.y += p * vv.y; a.z += p * vv.z; a.w += p * vv.w;
      }
      st.acc[jj] = a;
    }
  }
}

// Normalized output of one row: acc / l (0 for a fully masked row, like
// the JAX kernels' `acc / where(l > 0, l, 1)`).
template <typename T>
__device__ __forceinline__ void store_row(const RowState& st, T* dst, int D) {
  const int quad = threadIdx.x & 3, D4 = D >> 2;
  const float inv = st.l > 0.f ? 1.f / st.l : 1.f;
#pragma unroll
  for (int jj = 0; jj < ACC4; ++jj) {
    const int g = quad + 4 * jj;
    if (g < D4) {
      const float4 a = st.acc[jj];
      dst[4 * g + 0] = from_f<T>(a.x * inv);
      dst[4 * g + 1] = from_f<T>(a.y * inv);
      dst[4 * g + 2] = from_f<T>(a.z * inv);
      dst[4 * g + 3] = from_f<T>(a.w * inv);
    }
  }
}

}  // namespace cs
