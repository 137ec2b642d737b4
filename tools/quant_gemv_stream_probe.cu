// Bare weight-stream probes for tools/quant_gemv_probe.py (no math, not a
// kernel of the port): a ring of 128-row stages fed by one producer warp
// with cp.async.bulk copies of one row each (probe_stream), or by one
// thread with TMA boxes of 128 rows x 128 bytes (probe_tma: 1-4 boxes a
// stage, side by side or along k), stream-K over (tile, stage) units; and
// a plain coalesced 16-byte read of the same bytes (probe_read_all).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
__device__ __forceinline__ uint32_t su32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(su32(b)), "r"(n) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(su32(b)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* b, uint32_t n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(su32(b)), "r"(n) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint64_t* b, uint32_t par) {
  uint32_t ok;
  asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(ok) : "r"(su32(b)), "r"(par) : "memory");
  return ok != 0;
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t par) {
  while (!mbar_try(b, par)) {
  }
}
__device__ __forceinline__ void bulk(void* dst, const void* src, uint32_t n, uint64_t* b) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(su32(dst)), "l"(src), "r"(n), "r"(su32(b)) : "memory");
}

constexpr int NT = 32 + 256;

template <int ROWB>
__global__ void __launch_bounds__(NT, 1)
stream_probe(const int8_t* w, long long tile_stride, long long stage_stride,
             long long piece_stride, int n_tiles, int n_stages, int stages,
             unsigned* sink) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int RS = ROWB + 16, SB = 128 * RS;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + 16;
  uint8_t* ring = smem + 256;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long U = static_cast<long long>(n_tiles) * n_stages;
  const long long u0 = blockIdx.x * U / gridDim.x;
  const long long u1 = (blockIdx.x + 1) * U / gridDim.x;
  if (warp == 0) {
    int i = 0;
    for (long long u = u0; u < u1; ++u, ++i) {
      const int slot = i % stages;
      mbar_wait(empty + slot, ((i / stages) & 1) ^ 1);
      if (lane == 0) mbar_arrive_tx(full + slot, 128 * ROWB);
      __syncwarp();
      const long long t = u / n_stages, s = u % n_stages;
      const int8_t* src = w + t * tile_stride + s * stage_stride;
      for (int r = lane; r < 128; r += 32)
        bulk(ring + slot * SB + r * RS, src + r * piece_stride, ROWB, full + slot);
    }
  } else {
    const int cw = warp - 1;
    unsigned acc = 0;
    int i = 0;
    for (long long u = u0; u < u1; ++u, ++i) {
      const int slot = i % stages;
      mbar_wait(full + slot, (i / stages) & 1);
      const uint8_t* st = ring + slot * SB;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        acc ^= *reinterpret_cast<const unsigned*>(
            st + (cw * 16 + rr * 4 + (lane >> 3)) * RS + (lane & 7) * (ROWB / 8));
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }
    if (acc == 0x9E3779B9u) sink[0] = acc;
  }
}


__device__ __forceinline__ void tma3(void* dst, const CUtensorMap* tm, int c0, int c1, int c2, uint64_t* b) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
               ::"r"(su32(dst)), "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(c2), "r"(su32(b)) : "memory");
}
// TMA ring: one 3D box [128 x 128 x 1] per stage; unit u -> tile t, stage s:
// coordinates (c0, c1) = k6 ? (t*128, s*128) : (s*128, t*128)
__global__ void __launch_bounds__(NT, 1)
tma_probe(const __grid_constant__ CUtensorMap tm, int k6, int n_tiles, int n_stages, int stages, int nl, int boxes, unsigned* sink) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + 16;
  uint8_t* ring = smem + 1024;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) { mbar_init(full + s, 1); mbar_init(empty + s, 8); }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long U = static_cast<long long>(n_tiles) * n_stages;
  const long long u0 = blockIdx.x * U / gridDim.x, u1 = (blockIdx.x + 1) * U / gridDim.x;
  if (warp == 0) {
    if (lane == 0) {
      int i = 0;
      for (long long u = u0; u < u1; ++u, ++i) {
        const int slot = i % stages;
        mbar_wait(empty + slot, ((i / stages) & 1) ^ 1);
        mbar_arrive_tx(full + slot, 16384 * boxes);
        const int t = u / n_stages, s = u % n_stages;
        for (int j = 0; j < boxes; ++j)
          tma3(ring + slot * 16384 * boxes + j * 16384, &tm, k6 ? (t * boxes + j) * 128 : (s * boxes + j) * 128,
               k6 ? s * 128 : t * 128, static_cast<int>(u % nl), full + slot);
      }
    }
  } else {
    const int cw = warp - 1;
    unsigned acc = 0;
    int i = 0;
    for (long long u = u0; u < u1; ++u, ++i) {
      const int slot = i % stages;
      mbar_wait(full + slot, (i / stages) & 1);
      const uint8_t* st = ring + slot * 16384 * boxes;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        acc ^= *reinterpret_cast<const unsigned*>(st + (cw * 16 + rr * 4 + (lane >> 3)) * 128 + (lane & 7) * 16);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }
    if (acc == 0x9E3779B9u) sink[0] = acc;
  }
}

__global__ void read_all(const uint4* __restrict__ p, long long n16, unsigned* sink) {
  unsigned acc = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i + 7 * stride < n16; i += 8 * stride) {
    uint4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __ldcs(p + i + k * stride);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc ^= v[k].x ^ v[k].y ^ v[k].z ^ v[k].w;
  }
  for (; i < n16; i += stride) {
    const uint4 v = __ldcs(p + i);
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x9E3779B9u) sink[0] = acc;
}
}  // namespace

extern "C" int probe_stream(const void* w, long long tile_stride, long long stage_stride,
                            long long piece_stride, int n_tiles, int n_stages, int stages,
                            int rowb, int grid, void* sink, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rowb == 128) {
    const int bytes = 256 + stages * 128 * (128 + 16);
    cudaFuncSetAttribute(stream_probe<128>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    stream_probe<128><<<grid, NT, bytes, st>>>(static_cast<const int8_t*>(w), tile_stride,
        stage_stride, piece_stride, n_tiles, n_stages, stages, static_cast<unsigned*>(sink));
  } else {
    const int bytes = 256 + stages * 128 * (256 + 16);
    cudaFuncSetAttribute(stream_probe<256>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    stream_probe<256><<<grid, NT, bytes, st>>>(static_cast<const int8_t*>(w), tile_stride,
        stage_stride, piece_stride, n_tiles, n_stages, stages, static_cast<unsigned*>(sink));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_read_all(const void* p, long long n16, int grid, void* sink, void* stream) {
  read_all<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(p), n16, static_cast<unsigned*>(sink));
  return static_cast<int>(cudaGetLastError());
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
static EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}
// dims innermost first (d0, d1, d2), strides of d1, d2 in bytes; box 128 x 128 x 1, 128-byte swizzle
extern "C" int probe_tma(const void* w, long long d0, long long d1, long long d2, long long s1, long long s2,
                         int k6, int n_tiles, int n_stages, int stages, int nl, int boxes, int grid, void* sink, void* stream) {
  CUtensorMap tm;
  cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  cuuint64_t strides[2] = {(cuuint64_t)s1, (cuuint64_t)s2};
  cuuint32_t box[3] = {128, 128, 1}, es[3] = {1, 1, 1};
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return 999;
  CUresult r = fn(&tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(w), dims, strides, box, es,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  const int bytes = 2048 + stages * 16384 * boxes;
  cudaFuncSetAttribute(tma_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  tma_probe<<<grid, NT, bytes, static_cast<cudaStream_t>(stream)>>>(tm, k6, n_tiles, n_stages, stages, nl, boxes,
                                                                      static_cast<unsigned*>(sink));
  return static_cast<int>(cudaGetLastError());
}
