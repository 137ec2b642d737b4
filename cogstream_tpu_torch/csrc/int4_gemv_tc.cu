// K8 / K9 on Hopper: the stacked rank-1 int4 GEMV for m <= 64 rows on
// tensor cores, one launch per call.
//
// Replaces cogstream_tpu/ops/quant_gemv.py::_gemv_kernel_idx (K8, bf16
// activations) and _gemv_kernel_idx_w4a8 (K9, int8 activations with a
// scale per row and half). Both compute, for the layer `*layer` of
// stacked [L, half, dout] split-halves weights,
//
//   out[r, o] = epilogue( sum_p x_lo[r, p] * lo(q[p, o])
//                               + x_hi[r, p] * hi(q[p, o]) )
//
// with lo / hi the signed low / high nibble of byte q[p, o] (row p and
// row p + half of the unpacked weight) and the epilogue
//   K8: acc * scale[o]                       (f32 sums of exact products)
//   K9: (acc_lo * sx[r, 0] + acc_hi * sx[r, 1]) * scale[o] (exact int32
//       sums; one fused multiply-add, as XLA compiles the JAX epilogue)
// so K9 is bit-identical to its plain version and K8 differs from it only
// in the order of its f32 sums.
//
// What bounds it on the H100: device-memory bytes. Each call reads one
// layer's packed weights once (gate_proj at 7B width: 34 MB, 10.2 us at
// 3.35 TB/s); at m = 40 the tensor-core work is 5.4 GFLOP, 5.5 us at the
// bf16 peak, below the bytes. The kernel before this one (int4_gemv.cu,
// still K6 / K7's) lost its time to a stop-and-go stream (8-byte loads,
// all unpacked before the next went out), to re-reading and re-unpacking
// every weight byte per 8-row m-tile on CUDA cores at m > 8, and to a
// second launch that summed the K splits. Here:
//
// * Weight stream. A block owns 128 output columns and a range of packed
//   rows; 16-byte cp.async copies fill a 4-stage shared-memory ring of
//   128-row x 128-column tiles (16 KB), so three tiles are in flight
//   while one is unpacked. The first tile is issued before the block
//   stages the activations of its K range (cp.async too, once), the next
//   two after. The grid splits K so that every SM streams about the same
//   bytes in few waves (ops/quant_gemv.py stacked_plan).
// * Tensor cores with the roles swapped: the weights are the A operand
//   (16 output columns x k) and the activations the B operand (k x 8
//   rows), so m rows take ceil(m / 8) n8 tiles (m = 40: 5, none wasted)
//   and every weight byte leaves device memory once per call and is
//   unpacked once. K8: nibbles become bf16 in registers (exact: -8..7,
//   through the 0x4300 | u magic and one bf16x2 FMA), mma.sync m16n8k16
//   bf16 with f32 accumulators, x_lo meets the low nibbles and x_hi the
//   high ones in one accumulator. K9: nibbles become int8 holding 16 * s
//   (a mask, no sign extension), mma.sync m16n8k32 s8 with separate lo
//   and hi int32 accumulators, divided by 16 exactly at the end. A
//   fragment's rows and k are a permutation chosen so that each thread
//   reads whole runs of bytes of four (K8) or eight (K9) packed rows from
//   the ring; the activations' B fragments follow the same k order (one
//   8-byte shared load each).
// * One launch. Split-K blocks write their partial sums to a workspace
//   that the caller keeps between calls; the last block of a column tile
//   (an atomic ticket it resets) sums the partials in split order and
//   applies the epilogue. Deterministic, no allocation, no host sync:
//   a call can be captured in a CUDA graph.
// * The 8 warps of a block split the tile's columns (by 16 * AT) and a
//   stage's k chunks; their sums meet once, in warp order, in shared
//   memory. What bounds the stream is the unpack: with one 4-warp block
//   a scheduler had one warp, whose dependent shared loads, byte
//   permutes and conversions left the memory pipe idle; 8 warps and two
//   blocks per SM give each scheduler four.
#include <algorithm>
#include <type_traits>

#include "tc_tile.cuh"

namespace {

enum Variant { BF16DOT = 0, W4A8 = 2 };   // ops/quant_gemv.py UNIFORM, W4A8

constexpr int NT = 256;              // threads per block (8 warps)
constexpr int WARPS = NT / 32;
constexpr int BN = 128;              // output columns per block
constexpr int KT = 128;              // packed rows per ring stage
constexpr int STAGES = 4;
constexpr int RING = STAGES * KT * BN;   // ring bytes (64 KB)

// per variant: packed rows per mma chunk, whose bytes a thread reads in
// runs of 4 (K8) or 8 (K9) rows
template <int V> constexpr int CH = V == W4A8 ? 32 : 16;
template <int V> constexpr int ROWS = CH<V> / 4;
// A tiles (16 columns each) per warp by n-tile count. The 8 warps split
// the 128 columns 8 / AT ways and a stage's chunks AT ways, so each warp
// unpacks 8 / AT chunks of a stage, independent work between barriers
// (on the H100, 2 chunks a warp streamed faster than 1 at m <= 16; PERF.md).
// The accumulators stay at 4 * AT * NTM registers (8 * for K9) <= 128
// and the warps' sums (AT * NH * 8 NTM rows of 512 bytes) inside the
// ring but for K9 at NTM = 8
template <int V, int NTM>
constexpr int AT = V == W4A8 ? 2 : (NTM <= 2 ? 4 : 2);
// bytes of the warps' sums, [AT][NH][xrows][BN]
template <int V, int NTM>
constexpr int red_bytes(int xrows) {
  return AT<V, NTM> * (V == W4A8 ? 2 : 1) * xrows * BN * 4;
}
template <int V> constexpr int NH = V == W4A8 ? 2 : 1;
template <int V>
using Acc = typename std::conditional<V == W4A8, int, float>::type;

__host__ __device__ constexpr int x_elem(int v) { return v == W4A8 ? 1 : 2; }
// shared-memory row stride of the staged activations: a multiple of 128
// bytes plus 32, so the 4 rows of a half-warp's 8-byte loads fall on
// distinct banks
__host__ __device__ constexpr int x_stride(int rows, int v) {
  return (rows * x_elem(v) + 127) / 128 * 128 + 32;
}

// 16-byte chunk c of ring row r sits at chunk c ^ key(r): the threads of
// one shared load read rows 2^SH apart, which the key spreads over the
// banks (SH = log2 of a thread's run of rows)
template <int V>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int SH = V == W4A8 ? 3 : 2;
  return c ^ (((r >> SH) & 3) << 1);
}

// bf16x2 of two offset-binary nibbles u (0..15, bits 0-3 of each half):
// 0x4300 | u is 128 + u, and 128 + u - 136 = u - 8, the signed nibble
__device__ __forceinline__ uint32_t nib_bf16x2(uint32_t w) {
  const uint32_t v = (w & 0x000F000Fu) | 0x43004300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The thread's 2 * ATN bytes of ring rows r0 .. r0 + NR - 1 at tile
// column `col` (a multiple of 2 * ATN), as ATN / 2 words per row.
template <int V, int NR, int ATN>
__device__ __forceinline__ void load_rows(const uint8_t* ws, int r0, int col,
                                          uint32_t (&w)[NR][ATN / 2]) {
#pragma unroll
  for (int e = 0; e < NR; ++e) {
    const int r = r0 + e;
    const uint8_t* p = ws + r * BN + (swz<V>(r, col >> 4) << 4) + (col & 15);
    if constexpr (ATN == 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[e][0] = v.x;
      w[e][1] = v.y;
      w[e][2] = v.z;
      w[e][3] = v.w;
    } else if constexpr (ATN == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[e][0] = v.x;
      w[e][1] = v.y;
    } else {
      w[e][0] = *reinterpret_cast<const uint32_t*>(p);
    }
  }
}

// Epilogue of one output from its K sums (K9: 16x the exact int32 sums,
// divided back here) and the row / column scales.
template <int V>
__device__ __forceinline__ float epilogue(const Acc<V> (&s)[NH<V>],
                                          const float* sx, int row,
                                          float col_scale) {
  if constexpr (V == W4A8) {
    const float y = __fmaf_rn(static_cast<float>(s[0] >> 4), sx[2 * row],
                              __fmul_rn(static_cast<float>(s[NH<V> - 1] >> 4),
                                        sx[2 * row + 1]));
    return __fmul_rn(y, col_scale);
  } else {
    return __fmul_rn(s[0], col_scale);
  }
}

__device__ __forceinline__ void store(void* out, int out_dtype, size_t i,
                                      float v) {
  if (out_dtype == cs::BF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

// grid (dout / BN column tiles, K splits); 256 threads (two blocks per
// SM at NTM <= 2); dynamic shared memory the larger of RING + 2 * xrows *
// x_stride(rows_per_split) and red_bytes(xrows)
template <int V, int NTM>
__global__ void __launch_bounds__(NT, NTM <= 2 ? 2 : 1)
int4_gemv_tc_kernel(const void* __restrict__ x, const float* __restrict__ sx,
                    const int8_t* __restrict__ q4, long long layer_stride,
                    const float* __restrict__ scale, int scale_stride,
                    const int* __restrict__ layer, void* __restrict__ out,
                    Acc<V>* __restrict__ part, int* __restrict__ tickets,
                    int m, int half, int dout, int rows_per_split,
                    int out_dtype) {
  constexpr int ATN = AT<V, NTM>;        // A tiles (16 columns) per warp
  constexpr int CGN = 8 / ATN;           // warps across the 128 columns
  constexpr int KGN = WARPS / CGN;       // warps across a stage's chunks
  constexpr int CHR = CH<V>, NR = ROWS<V>, NCH = KT / CHR;
  constexpr int XE = x_elem(V);
  constexpr int H = NH<V>;
  using A = Acc<V>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;
  uint8_t* ring = smem;
  uint8_t* xs = smem + RING;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int k_begin = split * rows_per_split;
  const int k_len = min(half, k_begin + rows_per_split) - k_begin;
  const int n_stages = k_len / KT;
  const int nt = (m + 7) >> 3;           // live n8 tiles of rows
  const int xrows = nt * 8;
  const int RS = x_stride(rows_per_split, V);
  const int li = __ldg(layer);
  const int8_t* w = q4 + static_cast<long long>(li) * layer_stride +
                    static_cast<size_t>(k_begin) * dout +
                    static_cast<size_t>(tile) * BN;

  // the weights of stage s into its ring slot (16-byte cp.async, one
  // commit group per stage, empty past the block's range)
  auto issue = [=](int s) {
    if (s < n_stages) {
      uint8_t* dst = ring + (s % STAGES) * (KT * BN);
      const int8_t* src = w + static_cast<size_t>(s) * KT * dout;
      for (int i = tid; i < KT * BN / 16; i += NT) {
        const int r = i >> 3, c = i & 7;
        tc::cp_async16(dst + r * BN + (swz<V>(r, c) << 4),
                       src + static_cast<size_t>(r) * dout + c * 16, true);
      }
    }
    tc::cp_async_commit();
  };
  // stage 0's weights, then the activations of the block's K range (both
  // halves, rows >= m zero; one cp.async group, so no register round
  // trip holds them up), then the other stages: stage s waits for the
  // groups before it and lets the two after it fly
  issue(0);
  {
    const int chunks = k_len * XE / 16;
    const char* xb = static_cast<const char*>(x);
    for (int i = tid; i < 2 * xrows * chunks; i += NT) {
      const int c = i % chunks, rr = i / chunks;
      const int r = rr % xrows, h = rr / xrows;
      const char* src =
          r < m ? xb + (static_cast<size_t>(r) * 2 * half + h * half +
                        k_begin) * XE + c * 16
                : xb;
      tc::cp_async16(xs + (h * xrows + r) * RS + c * 16, src, r < m);
    }
    tc::cp_async_commit();
  }
  for (int s = 1; s < STAGES - 1; ++s) issue(s);

  A acc[H][ATN][NTM][4];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < ATN; ++j)
#pragma unroll
      for (int n = 0; n < NTM; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][j][n][e] = A(0);

  const int cg = warp % CGN, kg = warp / CGN;
  const int col = cg * 16 * ATN + 2 * ATN * g;   // the thread's columns

  for (int s = 0; s < n_stages; ++s) {
    tc::cp_async_wait<STAGES - 2>();   // stage s has landed
    __syncthreads();                   // ... for every thread; s - 1 done
    issue(s + STAGES - 1);             // into the slot of stage s - 1
    const uint8_t* ws = ring + (s % STAGES) * (KT * BN);
#pragma unroll
    for (int ci = 0; ci < NCH / KGN; ++ci) {
      const int c = kg + KGN * ci;
      uint32_t wv[NR][ATN / 2];
      load_rows<V, NR, ATN>(ws, c * CHR + NR * t, col, wv);
      // B fragments: 8 bytes of each row's lo / hi activations at the
      // thread's k run
      const int kx = (s * KT + c * CHR + NR * t) * XE;
      uint2 bl[NTM], bh[NTM];
#pragma unroll
      for (int n = 0; n < NTM; ++n) {
        if (n < nt) {
          bl[n] = *reinterpret_cast<const uint2*>(xs + (8 * n + g) * RS + kx);
          bh[n] = *reinterpret_cast<const uint2*>(
              xs + (xrows + 8 * n + g) * RS + kx);
        }
      }
#pragma unroll
      for (int j = 0; j < ATN; ++j) {
        // __byte_perm(a, b, sel): bytes [2j, 2j + 1] of row words a and b
        // (sel 0x5410 for the word's low pair, 0x7632 for its high pair)
        const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
        if constexpr (V == W4A8) {
          // a0 / a2: column 2j of rows 0-3 / 4-7; a1 / a3: column 2j + 1
          uint32_t a[4];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const uint32_t X = __byte_perm(wv[4 * hh][j >> 1],
                                           wv[4 * hh + 1][j >> 1], sel);
            const uint32_t Y = __byte_perm(wv[4 * hh + 2][j >> 1],
                                           wv[4 * hh + 3][j >> 1], sel);
            a[2 * hh] = __byte_perm(X, Y, 0x6420u);
            a[2 * hh + 1] = __byte_perm(X, Y, 0x7531u);
          }
          // 16 x the signed nibble, as int8: a mask each
          const uint32_t al[4] = {(a[0] << 4) & 0xF0F0F0F0u,
                                  (a[1] << 4) & 0xF0F0F0F0u,
                                  (a[2] << 4) & 0xF0F0F0F0u,
                                  (a[3] << 4) & 0xF0F0F0F0u};
          const uint32_t ah[4] = {a[0] & 0xF0F0F0F0u, a[1] & 0xF0F0F0F0u,
                                  a[2] & 0xF0F0F0F0u, a[3] & 0xF0F0F0F0u};
#pragma unroll
          for (int n = 0; n < NTM; ++n) {
            if (n < nt) {
              mma_s8(acc[0][j][n], al, bl[n].x, bl[n].y);
              mma_s8(acc[H - 1][j][n], ah, bh[n].x, bh[n].y);
            }
          }
        } else {
          // bytes [row 0, row 1] / [row 2, row 3] of columns 2j, 2j + 1,
          // nibbles to offset binary
          const uint32_t W01 =
              __byte_perm(wv[0][j >> 1], wv[1][j >> 1], sel) ^ 0x88888888u;
          const uint32_t W23 =
              __byte_perm(wv[2][j >> 1], wv[3][j >> 1], sel) ^ 0x88888888u;
          const uint32_t al[4] = {nib_bf16x2(W01), nib_bf16x2(W01 >> 8),
                                  nib_bf16x2(W23), nib_bf16x2(W23 >> 8)};
          const uint32_t ah[4] = {nib_bf16x2(W01 >> 4), nib_bf16x2(W01 >> 12),
                                  nib_bf16x2(W23 >> 4), nib_bf16x2(W23 >> 12)};
#pragma unroll
          for (int n = 0; n < NTM; ++n) {
            if (n < nt) {
              tc::mma(acc[0][j][n], al, bl[n].x, bl[n].y);
              tc::mma(acc[0][j][n], ah, bh[n].x, bh[n].y);
            }
          }
        }
      }
    }
  }

  // the warps' sums meet in shared memory (over the ring), then each
  // thread owns one column of the tile and sums its k groups in order
  tc::cp_async_wait<0>();
  __syncthreads();
  A* red = reinterpret_cast<A*>(ring);   // [KGN][H][xrows][BN]
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < ATN; ++j)
#pragma unroll
      for (int n = 0; n < NTM; ++n) {
        if (n < nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 8 * n + 2 * t + (e & 1);
            red[((kg * H + h) * xrows + row) * BN + col + 2 * j + (e >> 1)] =
                acc[h][j][n][e];
          }
        }
      }
  __syncthreads();

  // thread tid owns column tid % BN of the tile, in every other row
  const int oc = tid & (BN - 1), rsub = tid / BN;
  const int ocol = tile * BN + oc;
  const float col_scale =
      scale[static_cast<long long>(li) * scale_stride + ocol];
  const size_t plane = static_cast<size_t>(m) * dout;
  for (int r = rsub; r < m; r += NT / BN) {
    A sum[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      A v = A(0);
#pragma unroll
      for (int k = 0; k < KGN; ++k) v += red[((k * H + h) * xrows + r) * BN + oc];
      sum[h] = v;
    }
    const size_t o = static_cast<size_t>(r) * dout + ocol;
    if (splits == 1) {
      store(out, out_dtype, o, epilogue<V>(sum, sx, r, col_scale));
    } else {
#pragma unroll
      for (int h = 0; h < H; ++h) part[(split * H + h) * plane + o] = sum[h];
    }
  }
  if (splits == 1) return;

  // the last block of this column tile sums every split's partials in
  // split order (deterministic) and applies the epilogue
  __threadfence();   // this block's partials reach L2 before its ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + tile, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // RG rows x SG splits of loads in flight per thread: the partials sit
  // in L2, and one dependent load per split and row would leave this
  // block waiting out m * splits round trips. Past the last split the
  // terms are 0, which leaves every sum as it was.
  constexpr int RG = 4, SG = 8;
  for (int r0 = rsub * RG; r0 < m; r0 += NT / BN * RG) {
    A sum[RG][H];
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int h = 0; h < H; ++h) sum[i][h] = A(0);
    for (int sp0 = 0; sp0 < splits; sp0 += SG) {
      A v[RG][H][SG];
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int k = 0; k < SG; ++k) {
            const int r = r0 + i, sp = sp0 + k;
            v[i][h][k] = (r < m && sp < splits)
                             ? __ldcg(part + (sp * H + h) * plane +
                                      static_cast<size_t>(r) * dout + ocol)
                             : A(0);
          }
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int k = 0; k < SG; ++k) sum[i][h] += v[i][h][k];
    }
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      if (r0 + i < m) {
        store(out, out_dtype, static_cast<size_t>(r0 + i) * dout + ocol,
              epilogue<V>(sum[i], sx, r0 + i, col_scale));
      }
    }
  }
  if (tid == 0) tickets[tile] = 0;   // ready for the next launch
}

// the largest block: the ring and 96 KB of staged activations, or K9's
// warp sums at NTM = 8 (128 KB)
constexpr int MAX_SMEM = 200 * 1024;

template <int V, int NTM>
int launch(const void* x, const float* sx, const int8_t* q4,
           long long layer_stride, const float* scale, int scale_stride,
           const int* layer, void* out, void* part, int* tickets, int m,
           int half, int dout, int rows_per_split, int splits, int out_dtype,
           cudaStream_t st) {
  auto kern = int4_gemv_tc_kernel<V, NTM>;
  // once per instantiation, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int xrows = (m + 7) / 8 * 8;
  const size_t bytes =
      std::max(RING + static_cast<size_t>(2 * xrows) * x_stride(rows_per_split, V),
          static_cast<size_t>(red_bytes<V, NTM>(xrows)));
  const dim3 grid(dout / BN, splits);
  kern<<<grid, NT, bytes, st>>>(x, sx, q4, layer_stride, scale, scale_stride,
                                layer, out, static_cast<Acc<V>*>(part),
                                tickets, m, half, dout, rows_per_split,
                                out_dtype);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_nt(const void* x, const float* sx, const int8_t* q4,
              long long layer_stride, const float* scale, int scale_stride,
              const int* layer, void* out, void* part, int* tickets, int m,
              int half, int dout, int rows_per_split, int splits,
              int out_dtype, cudaStream_t st) {
  const int nt = (m + 7) / 8;
#define CS_GEMV_TC(NTM)                                                     \
  if (nt <= NTM)                                                          \
    return launch<V, NTM>(x, sx, q4, layer_stride, scale, scale_stride,   \
                          layer, out, part, tickets, m, half, dout,       \
                          rows_per_split, splits, out_dtype, st);
  CS_GEMV_TC(1) CS_GEMV_TC(2) CS_GEMV_TC(4) CS_GEMV_TC(8)
#undef CS_GEMV_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: [m, 2 * half] bf16 (variant 0, K8) or int8 (variant 2, K9); sx: [m, 2]
// f32 (K9); q4: layer 0 of [L, half, dout] int8 with `layer_stride`
// elements per layer; scale: [L, dout] f32 with `scale_stride`; layer:
// device int32; out: [m, dout] f32 or bf16 (out_dtype); part: with
// splits > 1, [splits, NH, m, dout] f32 (K8) or int32 (K9) partials and
// tickets: [dout / 128] int32, zero between launches (the caller's
// workspace; not touched with one split). 1 <= m <= 64; half, dout and
// rows_per_split multiples of 128.
extern "C" int cs_int4_gemv_tc(const void* x, const void* sx, const void* q4,
                               long long layer_stride, const void* scale,
                               int scale_stride, const void* layer,
                               void* out, void* part, void* tickets, int m,
                               int half, int dout, int rows_per_split,
                               int splits, int variant, int out_dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 1 || m > 64 || half % KT || dout % BN || rows_per_split % KT)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* sxf = static_cast<const float*>(sx);
  const auto* q = static_cast<const int8_t*>(q4);
  const auto* sc = static_cast<const float*>(scale);
  const auto* li = static_cast<const int*>(layer);
  auto* tk = static_cast<int*>(tickets);
  if (variant == W4A8)
    return launch_nt<W4A8>(x, sxf, q, layer_stride, sc, scale_stride, li,
                           out, part, tk, m, half, dout, rows_per_split,
                           splits, out_dtype, st);
  if (variant == BF16DOT)
    return launch_nt<BF16DOT>(x, sxf, q, layer_stride, sc, scale_stride, li,
                              out, part, tk, m, half, dout, rows_per_split,
                              splits, out_dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
