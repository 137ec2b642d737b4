// K5: head-major varlen segment attention (no RoPE inside).
//
// Replaces cogstream_tpu/ops/flash_attention.py::_flash_kernel
// (_flash_call, segment_flash_attention): the general segment flash
// attention of the vision tower's head-major branch, which the frozen
// tower of the training path runs. q, k and v arrive already rotated as
// [N, H, D] (token-major rows of H heads; the TPU wrapper's transpose to
// [H, N, D] and its 128-lane pad are left behind: the kernel reads a
// head's D values at row offset h * D). Query i sees key j iff seg[i] ==
// seg[j] >= 0; a query with no visible key (a pad row) outputs 0, as the
// JAX kernel's masked `acc / where(l > 0, l, 1)` does. Online softmax in
// f32.
//
// The host gives each 64-row query tile the token range [kv_lo, kv_hi)
// of the segments it holds (ops/flash_attention.py vision_kv_ranges, the
// same metadata as K1), not the v5e block-size cost model of
// FlashRanges.build; tiles that straddle frames mask per token.
//
// Bound on the H100: arithmetic. Block-diagonal attention over 16 frames
// of 1008 tokens, 16 heads of 72, is 4*H*sum(L^2)*D ~ 7.5e10 FLOP per
// layer against ~149 MB of q, k, v and out.
// * bf16 (cs_segment_attention_tc): K1's tensor-core kernel
//   (segment_tc.cuh) with the rotation compiled out: 8 warps x 2 m-tiles
//   = 256 query rows of one head per block, 64-key tiles through the
//   cp.async double buffer straight from the [N, H, D] rows (row stride
//   H * D, column h * D), mma.sync bf16 with f32 softmax, the Q.K^T depth
//   padded to 80 at D = 72.
// * f32 (cs_segment_attention): the CUDA-core f32 tile of common.cuh
//   (attend_tile), one 256-thread block per (64-row tile, head): exact f32
//   products, which the f32 training checks rely on.
#include "common.cuh"
#include "segment_tc.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(cs::NT)
segment_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ seg,
                         const int* __restrict__ kv_lo,
                         const int* __restrict__ kv_hi, T* __restrict__ out,
                         int N, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int DS = D + 4;
  float* Qs = smem;
  float* Ks = Qs + cs::BR * DS;
  float* Vs = Ks + cs::BK * DS;
  float* Ps = Vs + cs::BK * DS;
  int* rseg = reinterpret_cast<int*>(Ps + cs::BR * cs::PS);
  int* cseg = rseg + cs::BR;

  const int tid = threadIdx.x, h = blockIdx.y;
  const int q0 = blockIdx.x * cs::BR;
  const size_t row_stride = (size_t)H * D;   // elements between tokens
  const size_t hcol = (size_t)h * D;

  for (int i = tid; i < cs::BR * D; i += cs::NT) {
    const int rr = i / D, d = i % D, n = q0 + rr;
    Qs[rr * DS + d] = n < N ? cs::to_f(q[n * row_stride + hcol + d]) : 0.f;
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
      const int c = i / D, d = i % D;
      const size_t off = (size_t)(k0 + c) * row_stride + hcol + d;
      Ks[c * DS + d] = cs::to_f(k[off]);
      Vs[c * DS + d] = cs::to_f(v[off]);
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
  if (n < N) cs::store_row(st, out + n * row_stride + hcol, D);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* seg, const void* kv_lo, const void* kv_hi,
                   void* out, int n, int heads, int d, float scale,
                   size_t bytes, cudaStream_t st) {
  auto kern = segment_attention_kernel<T>;
  // once per instantiation, not per launch: room for the largest head dim
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(cs::tile_smem_floats(4 * cs::MAX_D4) * sizeof(float) +
            2 * cs::BR * sizeof(int)));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((n + cs::BR - 1) / cs::BR, heads), block(cs::NT);
  kern<<<grid, block, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seg),
      static_cast<const int*>(kv_lo), static_cast<const int*>(kv_hi),
      static_cast<T*>(out), n, heads, d, scale);
  return cudaGetLastError();
}

}  // namespace

// the CUDA-core tile (the wrapper sends only f32 here; bf16 goes to
// cs_segment_attention_tc)
extern "C" int cs_segment_attention(const void* q, const void* k,
                                    const void* v, const void* seg,
                                    const void* kv_lo, const void* kv_hi,
                                    void* out, int n, int heads, int d,
                                    int block_q, float scale, int dtype,
                                    void* stream) {
  if (dtype != cs::F32 || block_q != cs::BR || d % 4 != 0 ||
      d > 4 * cs::MAX_D4 || n <= 0 || heads <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      cs::tile_smem_floats(d) * sizeof(float) + 2 * cs::BR * sizeof(int);
  return static_cast<int>(launch<float>(q, k, v, seg, kv_lo, kv_hi, out, n,
                                        heads, d, scale, bytes,
                                        static_cast<cudaStream_t>(stream)));
}

// bf16 operands [N, H, D], head dim D % 8 == 0 and D <= 128: the
// tensor-core kernel of segment_tc.cuh without the rotation
extern "C" int cs_segment_attention_tc(const void* q, const void* k,
                                       const void* v, const void* seg,
                                       const void* kv_lo, const void* kv_hi,
                                       void* out, int n, int heads, int d,
                                       int block_q, float scale,
                                       void* stream) {
  if (block_q != cs::BR || n <= 0 || heads <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale2 = scale * tc::LOG2E;
  const long long row_stride = (long long)heads * d;
  switch (d) {
#define CS_SEGMENT_TC(D)                                                 \
  case D:                                                                \
    return launch_segment_tc<D, false>(q, k, v, row_stride, nullptr,    \
                                       nullptr, seg, kv_lo, kv_hi, out, \
                                       n, heads, scale2, st);
    CS_SEGMENT_TC_DIMS(CS_SEGMENT_TC)
#undef CS_SEGMENT_TC
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
