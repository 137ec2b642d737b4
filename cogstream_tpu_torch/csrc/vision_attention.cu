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
// token frames is ~75 GFLOP per tower layer at 16x1008 tokens), so the
// tile design matters. This first kernel is the simple form: one
// 256-thread block per (query tile, head) walks the key tiles of its
// segment range with f32 CUDA-core dot products from shared memory and
// an f32 online softmax. Tensor-core (wgmma) tiles are later work.
#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ float rotated(const T* row, const float* cs_row,
                                         const float* sn_row, int d,
                                         int half) {
  const float x = cs::to_f(row[d]);
  const float partner = cs::to_f(row[d < half ? d + half : d - half]);
  const float rot = d < half ? -partner : partner;
  // the JAX path casts the rotated value back to the activation dtype
  return cs::to_f(cs::from_f<T>(x * cs_row[d] + rot * sn_row[d]));
}

template <typename T>
__global__ void __launch_bounds__(cs::NT)
vision_attention_kernel(const T* __restrict__ qkv, const float* __restrict__ cosv,
                        const float* __restrict__ sinv, const int* __restrict__ seg,
                        const int* __restrict__ kv_lo, const int* __restrict__ kv_hi,
                        T* __restrict__ out, int N, int H, int D, float scale) {
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
      const T* row = qkv + n * row_stride;
      Ks[c * DS + d] = rotated(row + kcol, cosv + (size_t)n * D,
                               sinv + (size_t)n * D, d, half);
      Vs[c * DS + d] = cs::to_f(row[vcol + d]);
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

}  // namespace

extern "C" int cs_vision_attention(const void* qkv, const void* cosv,
                                   const void* sinv, const void* seg,
                                   const void* kv_lo, const void* kv_hi,
                                   void* out, int n, int heads, int d,
                                   int block_q, float scale, int dtype,
                                   void* stream) {
  if (block_q != cs::BR || d % 4 != 0 || d > 4 * cs::MAX_D4 || d % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n + cs::BR - 1) / cs::BR;
  const size_t bytes =
      cs::tile_smem_floats(d) * sizeof(float) + 2 * cs::BR * sizeof(int);
  const dim3 grid(n_tiles, heads), block(cs::NT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cs::BF16) {
    auto k = vision_attention_kernel<__nv_bfloat16>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    k<<<grid, block, bytes, st>>>(
        static_cast<const __nv_bfloat16*>(qkv),
        static_cast<const float*>(cosv), static_cast<const float*>(sinv),
        static_cast<const int*>(seg), static_cast<const int*>(kv_lo),
        static_cast<const int*>(kv_hi), static_cast<__nv_bfloat16*>(out),
        n, heads, d, scale);
  } else {
    auto k = vision_attention_kernel<float>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    k<<<grid, block, bytes, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(cosv),
        static_cast<const float*>(sinv), static_cast<const int*>(seg),
        static_cast<const int*>(kv_lo), static_cast<const int*>(kv_hi),
        static_cast<float*>(out), n, heads, d, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
