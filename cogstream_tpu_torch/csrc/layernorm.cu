// K2: row LayerNorm for the vision tower.
//
// Replaces cogstream_tpu/ops/layernorm.py::_ln_kernel (pallas_layernorm).
// Same math: f32 mean, centred f32 variance, rsqrt(var + eps), affine
// with f32 scale/bias, one cast to the input dtype.
//
// Bound on the H100: device-memory bandwidth (one read and one write of
// [N, H] per call; at N=16384, H=1152 bf16 that is 75 MB). Design: one
// warp per row, eight rows per 256-thread block, so any N and any H
// work (the TPU kernel's block-divisibility fallback is gone). The row
// is read three times (sum, centred variance, normalize); the second
// and third reads hit L1/L2, not device memory. Vectorized loads are a
// later optimization.
#include "common.cuh"

namespace {

template <typename T>
__global__ void layernorm_kernel(const T* __restrict__ x,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ bias,
                                 T* __restrict__ out, int n, int h,
                                 float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= n) return;
  const T* xr = x + (size_t)row * h;
  float s = 0.f;
  for (int d = lane; d < h; d += 32) s += cs::to_f(xr[d]);
  const float mu = cs::warp_sum(s) / h;
  float v = 0.f;
  for (int d = lane; d < h; d += 32) {
    const float c = cs::to_f(xr[d]) - mu;
    v += c * c;
  }
  const float rstd = rsqrtf(cs::warp_sum(v) / h + eps);
  T* orow = out + (size_t)row * h;
  for (int d = lane; d < h; d += 32)
    orow[d] = cs::from_f<T>((cs::to_f(xr[d]) - mu) * rstd * scale[d] + bias[d]);
}

}  // namespace

extern "C" int cs_layernorm(const void* x, const void* scale,
                            const void* bias, void* out, int n, int h,
                            float eps, int dtype, void* stream) {
  const int rows_per_block = 8;
  const dim3 grid((n + rows_per_block - 1) / rows_per_block), block(256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cs::BF16)
    layernorm_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(out), n, h, eps);
  else
    layernorm_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<float*>(out), n, h,
        eps);
  return static_cast<int>(cudaGetLastError());
}
