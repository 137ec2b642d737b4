// K10 on Hopper: the weight-only int8 GEMV for m <= 64 rows, over stacked
// [L, din, dout] weights with the layer index read on the device (the
// decoder's projection sites) or one 2D [din, dout] weight (the lm_head).
// Each layer is stored column-major (weight (k, o) at o * din + k), the
// layout torch._int_mm needs for the W8A8 prefill of the same weights.
//
// It replaces no Pallas kernel. The JAX package's int8 decode is XLA's
// fusion of cogstream_tpu/ops/quant.py::quantized_matmul (the dequant
// `(q * scale).astype(bf16)` folded into the consuming dot, so a step
// reads one byte per weight); in eager PyTorch the same expression
// materializes an f32 and a bf16 copy of every weight on every call. This
// kernel is that fusion: for the layer `*layer`,
//
//   out[r, o] = sum_p x[r, p] * bf16(f32(q[p, o]) * scale[o])
//
// each weight rounded as XLA rounds it (the scale applied to the weight,
// not in the epilogue), with f32 sums.
//
// What bounds it on the H100: device-memory bytes. A call reads one
// layer's int8 weights once (gate_proj at 7B width: 67.9 MB, 20.3 us at
// 3.35 TB/s; the lm_head 545 MB, 163 us). At m = 64 the tensor-core work
// is 8.7 GFLOP, 8.8 us at the bf16 peak, below the bytes. The body is
// K8's (int4_gemv_tc.cu) with the unpack replaced:
//
// * Weight stream: a block owns 128 output columns and a range of k;
//   16-byte cp.async copies fill a 4-stage ring of 128-column x 128-k
//   tiles (16 KB; each column's run of k one 128-byte row), three in
//   flight while one is converted. The grid splits K so that every SM
//   streams about the same bytes in few waves (ops/quant_gemv.py
//   stacked_plan, K8's model).
// * Tensor cores with the roles swapped: the weights are the mma.sync
//   m16n8k16 A operand (16 output columns x 16 k, row-major in the ring
//   as they are), the activations the B operand (16 k x 8 activation
//   rows), so m rows take ceil(m / 8) n8 tiles and every weight byte
//   leaves device memory once per call. The fragments' k order is a
//   permutation: thread t reads k 8t .. 8t + 7 of a 32-k quarter of each
//   of its two columns (one 8-byte shared load each) for two k16 steps,
//   and the activations' B fragments follow it (one 16-byte load per
//   row tile).
// * The conversion, in registers: a byte b becomes f32 exactly through
//   the offset-binary magic (bits 0x4B0000xx with xx = b ^ 0x80 are
//   2^23 + 128 + b), is multiplied by its column's scale (f32, round to
//   nearest) and packed to bf16x2 (round to nearest): one byte permute,
//   one add, one multiply and half a conversion per weight. The column
//   scales sit in registers for the whole call.
// * One launch: split-K blocks write f32 partials to a workspace the
//   caller keeps; the last block of a column tile (an atomic ticket it
//   resets) sums them in split order. Deterministic, no allocation, no
//   host sync: a call can be captured in a CUDA graph.
//
// f32 activations take a plain CUDA-core kernel (one thread per output
// column and up to 8 rows, sequential f32 sums of x * f32(q) * scale, no
// bf16 rounding), as K1, K3 and K4 keep f32 routes: the tiny f32 sessions
// of the tests run through it.
#include <algorithm>

#include "tc_tile.cuh"

namespace {

constexpr int NT = 256;              // threads per block (8 warps)
constexpr int WARPS = NT / 32;
constexpr int BN = 128;              // output columns per block
constexpr int KT = 128;              // weight rows (k) per ring stage
constexpr int STAGES = 4;
constexpr int RING = STAGES * KT * BN;   // ring bytes (64 KB)
constexpr int KQ = 32;               // k per quarter: a warp's unit of work
constexpr int NQ = KT / KQ;          // quarters per stage

// A tiles (16 columns each) per warp by n-tile count, as K8's: the 8
// warps split the 128 columns 8 / AT ways and a stage's quarters AT ways
template <int NTM>
constexpr int AT = NTM <= 2 ? 4 : 2;
// bytes of the warps' sums, [AT][xrows][BN] f32
template <int NTM>
constexpr int red_bytes(int xrows) {
  return AT<NTM> * xrows * BN * 4;
}

// shared-memory row stride of the staged bf16 activations: a multiple of
// 128 bytes plus 64, so the two rows of a quarter-warp's 16-byte loads
// fall on the two halves of the banks
__host__ __device__ constexpr int x_stride(int rows) {
  return (rows * 2 + 127) / 128 * 128 + 64;
}

// the ring holds each output column's KT weights as one 128-byte row;
// 16-byte chunk c of row r sits at chunk c ^ key(r), so the four columns
// of a half-warp's 8-byte loads read four different 32-byte windows
__device__ __forceinline__ int swz(int r, int c) {
  return c ^ ((r & 3) << 1);
}

// byte k of offset-binary word u (u = w ^ 0x80808080) as the f32 value of
// the signed byte of w: 0x4B0000xx is 2^23 + xx
__device__ __forceinline__ float byte_f32(uint32_t u, int k) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + k)) -
         8388736.0f;
}

// bf16x2 of bytes k, k + 1 of word w, each times scale s (f32, rounded
// to nearest, then to bf16)
__device__ __forceinline__ uint32_t pair(uint32_t w, int k, float s) {
  const uint32_t u = w ^ 0x80808080u;
  return tc::pack(__fmul_rn(byte_f32(u, k), s),
                  __fmul_rn(byte_f32(u, k + 1), s));
}

__device__ __forceinline__ void store(void* out, int out_dtype, size_t i,
                                      float v) {
  if (out_dtype == cs::BF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

// grid (dout / BN column tiles, K splits); 256 threads (two blocks per SM
// at NTM <= 2); dynamic shared memory the larger of RING + xrows *
// x_stride(rows_per_split) and red_bytes(xrows). q holds each layer
// column-major (weight (k, o) at o * din + k).
template <int NTM>
__global__ void __launch_bounds__(NT, NTM <= 2 ? 2 : 1)
int8_gemv_tc_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ q, long long layer_stride,
                    const float* __restrict__ scale, int scale_stride,
                    const int* __restrict__ layer, void* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ tickets,
                    int m, int din, int dout, int rows_per_split,
                    int out_dtype) {
  constexpr int ATN = AT<NTM>;           // A tiles (16 columns) per warp
  constexpr int CGN = 8 / ATN;           // warps across the 128 columns
  constexpr int KGN = WARPS / CGN;       // warps across a stage's quarters
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;
  uint8_t* ring = smem;
  uint8_t* xs = smem + RING;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int k_begin = split * rows_per_split;
  const int k_len = min(din, k_begin + rows_per_split) - k_begin;
  const int n_stages = k_len / KT;
  const int nt = (m + 7) >> 3;           // live n8 tiles of rows
  const int xrows = nt * 8;
  const int RS = x_stride(rows_per_split);
  const int li = layer == nullptr ? 0 : __ldg(layer);
  const int8_t* w = q + static_cast<long long>(li) * layer_stride +
                    static_cast<size_t>(tile) * BN * din + k_begin;

  // the weights of stage s into its ring slot: 128 columns x 128 k, each
  // column's run of k one 128-byte row (16-byte cp.async, one commit
  // group per stage, empty past the block's range)
  auto issue = [=](int s) {
    if (s < n_stages) {
      uint8_t* dst = ring + (s % STAGES) * (KT * BN);
      const int8_t* src = w + static_cast<size_t>(s) * KT;
      for (int i = tid; i < KT * BN / 16; i += NT) {
        const int r = i >> 3, c = i & 7;
        tc::cp_async16(dst + r * KT + (swz(r, c) << 4),
                       src + static_cast<size_t>(r) * din + c * 16, true);
      }
    }
    tc::cp_async_commit();
  };
  // stage 0's weights, then the activations of the block's K range (rows
  // >= m zero; one cp.async group), then the other stages
  issue(0);
  {
    const int chunks = k_len * 2 / 16;
    const char* xb = reinterpret_cast<const char*>(x);
    for (int i = tid; i < xrows * chunks; i += NT) {
      const int c = i % chunks, r = i / chunks;
      const char* src =
          r < m ? xb + (static_cast<size_t>(r) * din + k_begin) * 2 + c * 16
                : xb;
      tc::cp_async16(xs + r * RS + c * 16, src, r < m);
    }
    tc::cp_async_commit();
  }
  for (int s = 1; s < STAGES - 1; ++s) issue(s);

  const int cg = warp % CGN, kg = warp / CGN;
  // A tile j: ring rows (tile columns) X_j = cg * 16 ATN + 16 j + g (A
  // row g) and X_j + 8 (A row g + 8); their scales, for the whole call
  float sc[ATN][2];
#pragma unroll
  for (int j = 0; j < ATN; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sc[j][h] = scale[static_cast<long long>(li) * scale_stride + tile * BN +
                       cg * 16 * ATN + 16 * j + g + 8 * h];

  float acc[ATN][NTM][4];
#pragma unroll
  for (int j = 0; j < ATN; ++j)
#pragma unroll
    for (int n = 0; n < NTM; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    tc::cp_async_wait<STAGES - 2>();   // stage s has landed
    __syncthreads();                   // ... for every thread; s - 1 done
    issue(s + STAGES - 1);             // into the slot of stage s - 1
    const uint8_t* ws = ring + (s % STAGES) * (KT * BN);
#pragma unroll
    for (int qi = 0; qi < NQ / KGN; ++qi) {
      // quarter qq: thread t reads k 32 qq + 8 t .. + 7 of its columns
      // (two k16 steps: k 8t .. 8t + 3 and 8t + 4 .. 8t + 7 stand for the
      // fragment's k 2t, 2t + 1, 2t + 8, 2t + 9 of each step)
      const int qq = kg + KGN * qi;
      const int c = 2 * qq + (t >> 1), off = (t & 1) * 8;
      // B fragments: 16 bytes (8 bf16) of each activation row at the
      // thread's k run, both steps
      const int kx = (s * KT + KQ * qq + 8 * t) * 2;
      uint4 b[NTM];
#pragma unroll
      for (int n = 0; n < NTM; ++n)
        if (n < nt)
          b[n] = *reinterpret_cast<const uint4*>(xs + (8 * n + g) * RS + kx);
#pragma unroll
      for (int j = 0; j < ATN; ++j) {
        const int X = cg * 16 * ATN + 16 * j + g, Y = X + 8;
        const uint2 wx = *reinterpret_cast<const uint2*>(
            ws + X * KT + (swz(X, c) << 4) + off);
        const uint2 wy = *reinterpret_cast<const uint2*>(
            ws + Y * KT + (swz(Y, c) << 4) + off);
        const float sx = sc[j][0], sy = sc[j][1];
        const uint32_t a0[4] = {pair(wx.x, 0, sx), pair(wy.x, 0, sy),
                                pair(wx.x, 2, sx), pair(wy.x, 2, sy)};
        const uint32_t a1[4] = {pair(wx.y, 0, sx), pair(wy.y, 0, sy),
                                pair(wx.y, 2, sx), pair(wy.y, 2, sy)};
#pragma unroll
        for (int n = 0; n < NTM; ++n)
          if (n < nt) {
            tc::mma(acc[j][n], a0, b[n].x, b[n].y);
            tc::mma(acc[j][n], a1, b[n].z, b[n].w);
          }
      }
    }
  }

  // the warps' sums meet in shared memory (over the ring), then each
  // thread owns one column of the tile and sums its k groups in order
  tc::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);   // [KGN][xrows][BN]
#pragma unroll
  for (int j = 0; j < ATN; ++j)
#pragma unroll
    for (int n = 0; n < NTM; ++n)
      if (n < nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 8 * n + 2 * t + (e & 1);
          const int colx = cg * 16 * ATN + 16 * j + g + 8 * (e >> 1);
          red[(kg * xrows + row) * BN + colx] = acc[j][n][e];
        }
      }
  __syncthreads();

  const int oc = tid & (BN - 1), rsub = tid / BN;
  const int ocol = tile * BN + oc;
  const size_t plane = static_cast<size_t>(m) * dout;
  for (int r = rsub; r < m; r += NT / BN) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < KGN; ++k) v += red[(k * xrows + r) * BN + oc];
    const size_t o = static_cast<size_t>(r) * dout + ocol;
    if (splits == 1)
      store(out, out_dtype, o, v);
    else
      part[split * plane + o] = v;
  }
  if (splits == 1) return;

  // the last block of this column tile sums every split's partials in
  // split order (deterministic)
  __threadfence();   // this block's partials reach L2 before its ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + tile, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // RG rows x SG splits of loads in flight per thread (the partials sit
  // in L2); past the last split the terms are 0
  constexpr int RG = 4, SG = 8;
  for (int r0 = rsub * RG; r0 < m; r0 += NT / BN * RG) {
    float sum[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) sum[i] = 0.f;
    for (int sp0 = 0; sp0 < splits; sp0 += SG) {
      float v[RG][SG];
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int k = 0; k < SG; ++k) {
          const int r = r0 + i, sp = sp0 + k;
          v[i][k] = (r < m && sp < splits)
                        ? __ldcg(part + sp * plane +
                                 static_cast<size_t>(r) * dout + ocol)
                        : 0.f;
        }
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int k = 0; k < SG; ++k) sum[i] += v[i][k];
    }
#pragma unroll
    for (int i = 0; i < RG; ++i)
      if (r0 + i < m)
        store(out, out_dtype, static_cast<size_t>(r0 + i) * dout + ocol,
              sum[i]);
  }
  if (tid == 0) tickets[tile] = 0;   // ready for the next launch
}

// the largest block: the ring and 96 KB of staged activations
constexpr int MAX_SMEM = 200 * 1024;

template <int NTM>
int launch_tc(const void* x, const int8_t* q, long long layer_stride,
              const float* scale, int scale_stride, const int* layer,
              void* out, void* part, int* tickets, int m, int din, int dout,
              int rows_per_split, int splits, int out_dtype,
              cudaStream_t st) {
  auto kern = int8_gemv_tc_kernel<NTM>;
  // once per instantiation, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int xrows = (m + 7) / 8 * 8;
  const size_t bytes =
      std::max(RING + static_cast<size_t>(xrows) * x_stride(rows_per_split),
               static_cast<size_t>(red_bytes<NTM>(xrows)));
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(dout / BN, splits);
  kern<<<grid, NT, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), q, layer_stride, scale,
      scale_stride, layer, out, static_cast<float*>(part), tickets, m, din,
      dout, rows_per_split, out_dtype);
  return static_cast<int>(cudaGetLastError());
}

// f32 activations: one thread per output column and 8 rows (blockIdx.y),
// the activations staged 128 rows of k at a time; sequential f32 sums
constexpr int F_COLS = 128, F_ROWS = 8, F_K = 128;

__global__ void __launch_bounds__(F_COLS)
int8_gemv_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                     long long layer_stride, const float* __restrict__ scale,
                     int scale_stride, const int* __restrict__ layer,
                     void* __restrict__ out, int m, int din, int dout,
                     int out_dtype) {
  __shared__ float xs[F_ROWS][F_K];
  const int li = layer == nullptr ? 0 : __ldg(layer);
  const int o = blockIdx.x * F_COLS + threadIdx.x;
  const int r0 = blockIdx.y * F_ROWS;
  const int8_t* wq = q + static_cast<long long>(li) * layer_stride +
                    static_cast<size_t>(o < dout ? o : 0) * din;
  const float s =
      o < dout ? scale[static_cast<long long>(li) * scale_stride + o] : 0.f;
  float acc[F_ROWS];
#pragma unroll
  for (int r = 0; r < F_ROWS; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < din; k0 += F_K) {
    for (int i = threadIdx.x; i < F_ROWS * F_K; i += F_COLS) {
      const int r = i / F_K, k = k0 + i % F_K;
      xs[r][i % F_K] =
          (r0 + r < m && k < din) ? x[static_cast<size_t>(r0 + r) * din + k]
                                  : 0.f;
    }
    __syncthreads();
    if (o < dout) {
      const int kn = min(F_K, din - k0);
      for (int k = 0; k < kn; ++k) {
        const float wv = __fmul_rn(static_cast<float>(wq[k0 + k]), s);
#pragma unroll
        for (int r = 0; r < F_ROWS; ++r) acc[r] = __fmaf_rn(xs[r][k], wv, acc[r]);
      }
    }
    __syncthreads();
  }
  if (o < dout)
    for (int r = 0; r < F_ROWS && r0 + r < m; ++r)
      store(out, out_dtype, static_cast<size_t>(r0 + r) * dout + o, acc[r]);
}

}  // namespace

// x: [m, din] f32 or bf16 (x_dtype); q: [L, din, dout] int8, each layer
// column-major, with `layer_stride` elements per layer (stacked: layer a
// device int32) or [din, dout] column-major (layer null); scale: [L, dout]
// f32 with `scale_stride` (or [dout]); out: [m, dout] f32 or bf16 (out_dtype). bf16: part, with
// splits > 1, [splits, m, dout] f32 partials and tickets [dout / 128]
// int32, zero between launches (the caller's workspace); din, dout and
// rows_per_split multiples of 128. f32: part, tickets, rows_per_split and
// splits unused. 1 <= m <= 64.
extern "C" int cs_int8_gemv(const void* x, const void* q,
                            long long layer_stride, const void* scale,
                            int scale_stride, const void* layer, void* out,
                            void* part, void* tickets, int m, int din,
                            int dout, int rows_per_split, int splits,
                            int x_dtype, int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 1 || m > 64) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qq = static_cast<const int8_t*>(q);
  const auto* sc = static_cast<const float*>(scale);
  const auto* li = static_cast<const int*>(layer);
  if (x_dtype == cs::F32) {
    const dim3 grid((dout + F_COLS - 1) / F_COLS, (m + F_ROWS - 1) / F_ROWS);
    int8_gemv_f32_kernel<<<grid, F_COLS, 0, st>>>(
        static_cast<const float*>(x), qq, layer_stride, sc, scale_stride, li,
        out, m, din, dout, out_dtype);
    return static_cast<int>(cudaGetLastError());
  }
  if (x_dtype != cs::BF16 || din % KT || dout % BN || rows_per_split % KT)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* tk = static_cast<int*>(tickets);
  const int nt = (m + 7) / 8;
#define CS_INT8_TC(NTM)                                                      \
  if (nt <= NTM)                                                             \
    return launch_tc<NTM>(x, qq, layer_stride, sc, scale_stride, li, out,    \
                          part, tk, m, din, dout, rows_per_split, splits,    \
                          out_dtype, st);
  CS_INT8_TC(1) CS_INT8_TC(2) CS_INT8_TC(4) CS_INT8_TC(8)
#undef CS_INT8_TC
  return static_cast<int>(cudaErrorInvalidValue);
}
