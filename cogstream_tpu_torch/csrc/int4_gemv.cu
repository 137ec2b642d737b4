// K7: fused-unpack rank-1 int4 GEMV for decode-sized m (<= 64).
//
// Replaces cogstream_tpu/ops/quant_gemv.py::_gemv_kernel_w4a8 (K7). Its
// uniform and cubic forms were K6 until PR 16 (_gemv_kernel; K6 now runs
// quant_gemv_sm90.cu) and its stacked forms K8 / K9 until PR 6
// (int4_gemv_tc.cu); chip_smoke.py phase 3 still times them on the same
// operands as those kernels' yardsticks. One templated kernel serves all:
//
//   out[r, o] = epilogue( sum_p  x_lo[r, p] * w(lo(q[p, o]))
//                              + x_hi[r, p] * w(hi(q[p, o])) )
//
// where q is [half, dout] int8 holding row p in its low nibble and row
// p + half in its high nibble (split halves), x_lo / x_hi are the two
// halves of an activation row, and
//   UNIFORM: bf16 activations, w(s) = s, epilogue acc * scale[o];
//   CUBIC:   bf16 activations, w(s) = bf16(s * (A + C * s^2)) with
//            code = [A, C] read on the device, epilogue acc * scale[o];
//   W4A8:    int8 activations, exact int32 sums kept per half, epilogue
//            (acc_lo * sx[r, 0] + acc_hi * sx[r, 1]) * scale[o].
// The stacked forms (K8/K9) take the base of [L, half, dout] weights and
// [L, dout] scales with their layer strides and a device-resident
// `const int* layer`: each block loads its own layer index (the TPU
// kernel's scalar prefetch), so selecting a layer needs no host sync and
// no copy. The 2D forms pass no layer pointer (index 0, stride 0).
//
// Bound on the H100: device-memory bandwidth. The weights are 4 bits
// each and read once (lm_head 272 MB, gate_proj of one layer 34 MB at 7B
// width); at m <= 8 there are 2-16 multiply-adds per weight byte, far
// below the card's ratio. Design: a block owns 256 output columns; each
// lane of a warp loads 8 contiguous bytes of one packed row (a warp reads
// 256 contiguous bytes), four rows in flight, and unpacks them with
// shifts ((u << 28) >> 28 for the low nibble, u >> 4 for the high). The 8
// warps of a block take interleaved packed rows and are summed through
// shared memory at the end in a fixed order. Activations are staged in
// shared memory in chunks of 256 packed rows (down_proj's x halves at
// m = 8 are ~300 KB, more than a block may hold). A decode step (m = 1)
// runs a one-row instance with eight packed rows in flight per warp;
// larger m is tiled by 8 rows (4 for W4A8, whose two int32 accumulators
// per output double the registers); the m-tile is the fastest grid axis,
// so the m-tiles of one
// column block run together and re-read the weights from L2. Where the
// column blocks alone cannot fill the SMs (k_proj/v_proj: 2 blocks) K is
// split: each split writes f32 (W4A8: int32 lo/hi) partials and a
// combine pass sums them in split order and applies the epilogue. No
// atomics, so outputs are the same from run to run. The TPU kernel
// carried its K sum across sequential grid steps; here it is the loop
// inside the block plus the combine.
//
// Products are exact in f32 (bf16 x small integer, or bf16 x bf16), so
// the bf16 variants differ from a plain f32 matmul only in summation
// order. The W4A8 sums are exact integers and the epilogue's roundings
// are spelled out (__fmaf_rn / __fmul_rn), so that the compiler's own
// contraction cannot change them against the plain version.
#include <type_traits>

#include "common.cuh"

namespace {

enum Variant { UNIFORM = 0, CUBIC = 1, W4A8 = 2 };

constexpr int NT = 256;          // threads per block
constexpr int WARPS = NT / 32;
constexpr int COLS = 8;          // output columns per lane (8-byte load)
constexpr int BN = 32 * COLS;    // output columns per block
constexpr int KC = 256;          // packed rows of activations per chunk
// rows of x per block: 1 for a decode step (m = 1), else 8 (4 for W4A8)
template <int V> constexpr int MTILE = V == W4A8 ? 4 : 8;
// packed rows in flight per warp: more where the m-tile leaves registers
template <int MT> constexpr int UNROLL = MT == 1 ? 8 : 4;
template <int V>
using Acc = typename std::conditional<V == W4A8, int, float>::type;

// Signed low / high nibble of byte b (0..3) of a 32-bit word.
__device__ __forceinline__ int lo_nib(unsigned w, int b) {
  return static_cast<int>(w << (28 - 8 * b)) >> 28;
}
__device__ __forceinline__ int hi_nib(unsigned w, int b) {
  return static_cast<int>(w << (24 - 8 * b)) >> 28;
}

template <int V>
__device__ __forceinline__ Acc<V> load_x(const void* x, size_t i) {
  if constexpr (V == W4A8)
    return static_cast<const int8_t*>(x)[i];
  else
    return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
}

// Epilogue of one output: the K sums (`s` for bf16 variants, `sl`/`sh`
// for W4A8) times the row and column scales.
template <int V>
__device__ __forceinline__ float epilogue(Acc<V> s, Acc<V> sl, Acc<V> sh,
                                          const float* sx, int row,
                                          float col_scale) {
  if constexpr (V == W4A8) {
    // one fused multiply-add, as XLA compiles the JAX epilogue
    const float y = __fmaf_rn(static_cast<float>(sl), sx[2 * row],
                              __fmul_rn(static_cast<float>(sh),
                                        sx[2 * row + 1]));
    return __fmul_rn(y, col_scale);
  } else {
    return __fmul_rn(s, col_scale);
  }
}

template <int V, int MT, typename OutT>
__global__ void __launch_bounds__(NT)
int4_gemv_kernel(const void* __restrict__ x, const float* __restrict__ sx,
                 const int8_t* __restrict__ q4, long long layer_stride,
                 const float* __restrict__ scale, int scale_stride,
                 const int* __restrict__ layer,
                 const float* __restrict__ code, OutT* __restrict__ out,
                 Acc<V>* __restrict__ part, int m, int half, int dout,
                 int rows_per_split) {
  constexpr int UN = UNROLL<MT>;
  using A = Acc<V>;
  __shared__ A xs[2][MT][KC];
  __shared__ __align__(16) A red[WARPS][BN];
  __shared__ float tbl[16];   // CUBIC: bf16 codebook value of s = i - 8

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * MT;
  const int mrows = min(MT, m - m0);
  const int cb = blockIdx.y * BN;
  const int col0 = cb + lane * COLS;
  const int split = blockIdx.z;
  const int k_begin = split * rows_per_split;
  const int k_end = min(half, k_begin + rows_per_split);
  const int li = layer ? __ldg(layer) : 0;
  const int8_t* w = q4 + static_cast<long long>(li) * layer_stride;
  const int ldx = 2 * half;

  if constexpr (V == CUBIC) {
    if (threadIdx.x < 16) {
      const float s = static_cast<float>(static_cast<int>(threadIdx.x) - 8);
      const float v = __fmul_rn(
          s, __fadd_rn(code[0], __fmul_rn(code[1], __fmul_rn(s, s))));
      tbl[threadIdx.x] = __bfloat162float(__float2bfloat16_rn(v));
    }
  }

  A acc_l[MT][COLS], acc_h[MT][COLS];   // acc_h is unused but for W4A8
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc_l[r][j] = acc_h[r][j] = A(0);

  const bool live = col0 < dout;
  for (int kc = k_begin; kc < k_end; kc += KC) {
    const int kn = min(KC, k_end - kc);
    __syncthreads();   // the previous chunk (and tbl) are settled
    for (int i = threadIdx.x; i < 2 * MT * KC; i += NT) {
      const int h = i / (MT * KC), r = (i / KC) % MT, k = i % KC;
      A v = A(0);
      if (r < mrows && k < kn)
        v = load_x<V>(x, static_cast<size_t>(m0 + r) * ldx + h * half + kc + k);
      xs[h][r][k] = v;
    }
    __syncthreads();
    if (!live) continue;

    auto consume = [&](uint2 u, int k) {
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const unsigned word = j < 4 ? u.x : u.y;
        const int sl = lo_nib(word, j & 3), sh = hi_nib(word, j & 3);
        if constexpr (V == W4A8) {
#pragma unroll
          for (int r = 0; r < MT; ++r) {
            acc_l[r][j] += xs[0][r][k] * sl;
            acc_h[r][j] += xs[1][r][k] * sh;
          }
        } else {
          float wl, wh;
          if constexpr (V == CUBIC) {
            wl = tbl[sl + 8];
            wh = tbl[sh + 8];
          } else {
            wl = static_cast<float>(sl);
            wh = static_cast<float>(sh);
          }
#pragma unroll
          for (int r = 0; r < MT; ++r)
            acc_l[r][j] += xs[0][r][k] * wl + xs[1][r][k] * wh;
        }
      }
    };

    int k = warp;
    for (; k + (UN - 1) * WARPS < kn; k += UN * WARPS) {
      uint2 u[UN];
#pragma unroll
      for (int t = 0; t < UN; ++t)
        u[t] = __ldg(reinterpret_cast<const uint2*>(
            w + static_cast<size_t>(kc + k + t * WARPS) * dout + col0));
#pragma unroll
      for (int t = 0; t < UN; ++t) consume(u[t], k + t * WARPS);
    }
    for (; k < kn; k += WARPS)
      consume(__ldg(reinterpret_cast<const uint2*>(
                  w + static_cast<size_t>(kc + k) * dout + col0)),
              k);
  }

  // Sum the 8 warps' partial sums, one output row (and half) at a time,
  // in warp order; thread t then owns column cb + t.
  const int col = cb + threadIdx.x;
  const float col_scale =
      (part == nullptr && col < dout)
          ? scale[static_cast<long long>(li) * scale_stride + col]
          : 0.f;
  constexpr int NH = V == W4A8 ? 2 : 1;
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    A sums[NH];
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      __syncthreads();
      A* dst = &red[warp][lane * COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) dst[j] = h == 0 ? acc_l[r][j] : acc_h[r][j];
      __syncthreads();
      A s = A(0);
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) s += red[wi][threadIdx.x];
      sums[h] = s;
    }
    if (r < mrows && col < dout) {
      const int row = m0 + r;
      if (part != nullptr) {
#pragma unroll
        for (int h = 0; h < NH; ++h)
          part[(static_cast<size_t>(split * NH + h) * m + row) * dout + col] =
              sums[h];
      } else {
        out[static_cast<size_t>(row) * dout + col] = cs::from_f<OutT>(
            epilogue<V>(sums[0], sums[0], sums[NH - 1], sx, row, col_scale));
      }
    }
  }
}

// Split-K combine: sums the splits' partials in split order and applies
// the epilogue. One thread per output.
template <int V, typename OutT>
__global__ void int4_gemv_combine(const Acc<V>* __restrict__ part,
                                  const float* __restrict__ sx,
                                  const float* __restrict__ scale,
                                  int scale_stride,
                                  const int* __restrict__ layer,
                                  OutT* __restrict__ out, int m, int dout,
                                  int splits) {
  constexpr int NH = V == W4A8 ? 2 : 1;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t n = static_cast<size_t>(m) * dout;
  if (i >= n) return;
  const int row = static_cast<int>(i / dout), col = static_cast<int>(i % dout);
  const int li = layer ? __ldg(layer) : 0;
  Acc<V> s[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) s[h] = Acc<V>(0);
  for (int sp = 0; sp < splits; ++sp)
#pragma unroll
    for (int h = 0; h < NH; ++h) s[h] += part[(sp * NH + h) * n + i];
  out[i] = cs::from_f<OutT>(epilogue<V>(
      s[0], s[0], s[NH - 1], sx, row,
      scale[static_cast<long long>(li) * scale_stride + col]));
}

template <int V, int MT, typename OutT>
void launch(const void* x, const float* sx, const int8_t* q4,
            long long layer_stride, const float* scale, int scale_stride,
            const int* layer, const float* code, void* out, void* part,
            int m, int half, int dout, int rows_per_split, int splits,
            cudaStream_t st) {
  const dim3 grid((m + MT - 1) / MT, (dout + BN - 1) / BN, splits);
  Acc<V>* p = splits > 1 ? static_cast<Acc<V>*>(part) : nullptr;
  int4_gemv_kernel<V, MT, OutT><<<grid, NT, 0, st>>>(
      x, sx, q4, layer_stride, scale, scale_stride, layer, code,
      static_cast<OutT*>(out), p, m, half, dout, rows_per_split);
  if (splits > 1) {
    const size_t n = static_cast<size_t>(m) * dout;
    int4_gemv_combine<V, OutT><<<(n + 255) / 256, 256, 0, st>>>(
        p, sx, scale, scale_stride, layer, static_cast<OutT*>(out), m, dout,
        splits);
  }
}

template <int V, typename OutT>
void launch_mt(const void* x, const float* sx, const int8_t* q4,
               long long layer_stride, const float* scale, int scale_stride,
               const int* layer, const float* code, void* out, void* part,
               int m, int half, int dout, int rows_per_split, int splits,
               cudaStream_t st) {
  if (m == 1)
    launch<V, 1, OutT>(x, sx, q4, layer_stride, scale, scale_stride, layer,
                       code, out, part, m, half, dout, rows_per_split, splits,
                       st);
  else
    launch<V, MTILE<V>, OutT>(x, sx, q4, layer_stride, scale, scale_stride,
                              layer, code, out, part, m, half, dout,
                              rows_per_split, splits, st);
}

template <int V>
void launch_dtype(int out_dtype, const void* x, const float* sx,
                  const int8_t* q4, long long layer_stride,
                  const float* scale, int scale_stride, const int* layer,
                  const float* code, void* out, void* part, int m, int half,
                  int dout, int rows_per_split, int splits, cudaStream_t st) {
  if (out_dtype == cs::BF16)
    launch_mt<V, __nv_bfloat16>(x, sx, q4, layer_stride, scale,
                                scale_stride, layer, code, out, part, m,
                                half, dout, rows_per_split, splits, st);
  else
    launch_mt<V, float>(x, sx, q4, layer_stride, scale, scale_stride, layer,
                        code, out, part, m, half, dout, rows_per_split,
                        splits, st);
}

}  // namespace

// x: [m, 2*half] bf16 (UNIFORM/CUBIC) or int8 (W4A8); sx: [m, 2] f32
// (W4A8); q4: layer 0 of [L, half, dout] int8 with `layer_stride`
// elements per layer (0 for a 2D weight); scale: [L, dout] f32 with
// `scale_stride`; layer: device int32 (nullptr: layer 0); code: [A, C]
// f32 (CUBIC); part: splits > 1 workspace, [splits, m, dout] f32 or
// [splits, 2, m, dout] int32 (W4A8). dout must be a multiple of 8.
extern "C" int cs_int4_gemv(const void* x, const void* sx, const void* q4,
                            long long layer_stride, const void* scale,
                            int scale_stride, const void* layer,
                            const void* code, void* out, void* part, int m,
                            int half, int dout, int rows_per_split,
                            int splits, int variant, int out_dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sxf = static_cast<const float*>(sx);
  const auto* q = static_cast<const int8_t*>(q4);
  const auto* sc = static_cast<const float*>(scale);
  const auto* li = static_cast<const int*>(layer);
  const auto* cd = static_cast<const float*>(code);
  if (variant == W4A8)
    launch_dtype<W4A8>(out_dtype, x, sxf, q, layer_stride, sc, scale_stride,
                       li, cd, out, part, m, half, dout, rows_per_split,
                       splits, st);
  else if (variant == CUBIC)
    launch_dtype<CUBIC>(out_dtype, x, sxf, q, layer_stride, sc, scale_stride,
                        li, cd, out, part, m, half, dout, rows_per_split,
                        splits, st);
  else
    launch_dtype<UNIFORM>(out_dtype, x, sxf, q, layer_stride, sc,
                          scale_stride, li, cd, out, part, m, half, dout,
                          rows_per_split, splits, st);
  return static_cast<int>(cudaGetLastError());
}
