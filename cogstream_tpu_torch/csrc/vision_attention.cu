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
// * f32 (cs_vision_attention): the CUDA-core f32 tile of common.cuh,
//   one 256-thread block per (64-row tile, head).
#include "common.cuh"
#include "segment_tc.cuh"

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
