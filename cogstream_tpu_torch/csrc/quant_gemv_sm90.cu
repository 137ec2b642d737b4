// K6 and K10 on Hopper: the decode GEMVs of a 2D rank-1 int4 weight (K6,
// the int4 lm_head and its vocab shards) and of a column-major int8
// weight (K10, the int8 decoder's projections and lm_head, the products
// large enough to repay this kernel's fixed cost: ops/int8_gemv.py
// takes_sm90), m <= 64 rows, one persistent launch per call.
//
// K6 replaces cogstream_tpu/ops/quant_gemv.py::_gemv_kernel (uniform or
// cubic codebook). For a [half, dout] split-halves store (the low nibble
// of byte q[p, o] is row p of the unpacked weight, the high nibble row p
// + half) and bf16 activations,
//   out[r, o] = scale[o] * sum_p x[r, p] w(lo(q[p, o])) + x[r, p + half]
//                                                         w(hi(q[p, o]))
// with w(s) = s (uniform: the slope is in scale) or bf16(s (A + C s^2))
// (cubic, code = [A, C] read on the device), f32 sums.
// K10 replaces no Pallas kernel: the JAX package's int8 decode is XLA's
// fusion of cogstream_tpu/ops/quant.py::quantized_matmul, the dequant
// `(q * scale).astype(bf16)` folded into the consuming dot, and eager
// PyTorch would materialize every weight. For a column-major [din, dout]
// layer (weight (k, o) at o * din + k; stacked with `*layer` read on the
// device),
//   out[r, o] = sum_k x[r, k] * bf16(f32(q[k, o]) * scale[o])
// each weight rounded as XLA rounds it, f32 sums.
//
// What bounds them on the H100: device-memory bytes. The lm_head's int4
// bytes are 272 MB (81.6 us at 3.35 TB/s), its int8 bytes 545 MB; a 7B
// gate_proj's int8 layer 67.9 MB (20.3 us). At m = 64 the tensor-core
// work of that layer is 8.7 GFLOP, 8.8 us at the bf16 peak. What held
// the kernels before back (PERF.md section 6, PR 16): not K6's int-to-
// float conversions (a variant without them was no faster) nor K10's
// activation-fragment loads or mma.sync at m = 64 (variants without them
// 1-7% faster), but their weight streams (8-byte loads; a cp.async ring)
// and K10's K splits, whose partials grew with m. Here:
//
// * Weight stream. One block per SM walks a contiguous range of (column
//   tile, stage) units, stream-K: U = tiles x stages units, block b takes
//   [b U / G, (b + 1) U / G), so every SM streams the same bytes in one
//   wave whatever the shape. A tile is 256 output columns, a stage two TMA
//   boxes of 128 rows x 128 bytes side by side with the 128-byte swizzle
//   (K6: 128 packed rows, 256 contiguous bytes of each; K10: 128 k of each
//   of the 256 columns), issued by one thread into a ring of 3-8 stages
//   that complete on mbarriers. The tensor map is encoded once per weight
//   tensor and cached (a 3D map for stacked K10 weights, the layer index
//   read on the device). The producer warpgroup then stages the stage's
//   activations (below) for both consumer warpgroups. Bare streams measured
//   on the H100 (PERF.md, PR 16): rings of 128-byte bulk copies 0.57
//   TB/s, one TMA box a stage 2.3, two 3.0 (a plain coalesced read 3.1).
// * Tensor cores, warpgroup MMA with the weights as the register A
//   operand (consumer warpgroup w takes box w: 128 columns as two sets of
//   64, two accumulators) and the staged activations as the B operand,
//   read by descriptor from shared memory (N = m rounded up to 8, 16, 32,
//   40 or 64): no thread loads activation fragments, and every weight
//   byte is read from device memory once per call and converted once. The
//   A registers are read asynchronously, so four steps' fragments rotate
//   and each is kept live until a wait covers its MMA. K10 at m <= 8 runs
//   mma.sync per warp on the same fragments instead (faster there).
// * Conversion in registers, by bit operations. K6 uniform: a byte's two
//   nibbles become one bf16x2 through the 0x4300 | u magic and one bf16x2
//   FMA (exact for -8..7), one byte permute and one lop3 (which also
//   flips the sign bit into offset binary). K6 cubic: the codebook's 16
//   bf16 values, rounded as the plain version rounds them, are built once
//   per thread into eight registers (low and high bytes) and selected
//   with byte permutes, two levels of 8 entries, four nibbles at a time.
//   The A fragment of K6 pairs the low and high nibble of one byte (rows
//   p and p + half), so the producer interleaves x's halves as it stages
//   them. K10: a byte becomes f32 through the 0x4B0000xx magic, times its
//   column's scale (f32, round to nearest), packed to bf16x2; the
//   fragment's k order is a permutation (thread t reads k 4t .. 4t + 3
//   of its two columns with one 4-byte load per k16 step), which the
//   producer applies to the activations as it stages them.
// * One launch, no allocation, deterministic. A tile split between
//   blocks leaves each block's f32 sums (its registers, as they lie) in a
//   workspace the caller keeps; the last block of the tile (an atomic
//   ticket per tile and warpgroup, which it resets) sums them in block
//   order and applies the epilogue. A call can be captured in a CUDA
//   graph, and two calls give the same bits.
#include <cuda.h>

#include <mutex>

#include "tc_tile.cuh"

namespace {

// ops/quant_gemv.py UNIFORM, CUBIC; INT8 is K10
enum Variant { UNIFORM = 0, CUBIC = 1, INT8 = 3 };

constexpr int BOX = 128;             // a TMA box: 128 rows of 128 bytes
constexpr int BOX_BYTES = BOX * BOX;
constexpr int BOXES = 2;             // boxes a stage (32 KB of weights)
constexpr int W_BYTES = BOXES * BOX_BYTES;
constexpr int TILE_N = BOXES * BOX;  // output columns a tile
constexpr int PRODUCERS = 128;       // one producer warpgroup
constexpr int CONSUMERS = 256;       // two consumer warpgroups
constexpr int NT = PRODUCERS + CONSUMERS;
constexpr int HEAD = 1024;           // barriers and flags before the ring
constexpr int ALIGN = 1024;          // the 128-byte swizzle's period
constexpr int SMEM_MAX = 232448;     // a block's shared memory on the H100
constexpr int MAX_STAGES = 8;

// A tile is 256 output columns, a stage 128 rows of its two 128-column
// boxes (side by side; consumer warpgroup w takes box w): K6's rows are
// packed rows (256 bf16 k: both nibbles), K10's are k (each box row one
// column's run of 128 k). The stage's activations: N rows x stage_k bf16
// in the no-swizzle K-major layout of wgmma (8-row x 16-byte core
// matrices, the ones along k 128 bytes apart, n-blocks of 8 rows SBO
// apart).
template <int V> __host__ __device__ constexpr int stage_k() {
  return V == INT8 ? BOX : 2 * BOX;
}
template <int V> __host__ __device__ constexpr int sbo() {
  return stage_k<V>() / 8 * 128;
}
template <int V, int N> __host__ __device__ constexpr int x_bytes() {
  return N * stage_k<V>() * 2;
}
template <int V, int N> __host__ __device__ constexpr int stage_bytes() {
  return W_BYTES + x_bytes<V, N>();
}
template <int V, int N> __host__ __device__ constexpr int n_stages_ring() {
  return (SMEM_MAX - ALIGN - HEAD) / stage_bytes<V, N>() < MAX_STAGES
             ? (SMEM_MAX - ALIGN - HEAD) / stage_bytes<V, N>() : MAX_STAGES;
}
template <int V, int N> __host__ __device__ constexpr int smem_bytes() {
  return ALIGN + HEAD + n_stages_ring<V, N>() * stage_bytes<V, N>();
}

struct Args {
  const void* x;            // [m, k * 2] bf16 (K6: the two halves), [m, k]
  const float* scale;       // [L, dout] with scale_stride, or [dout]
  int scale_stride;
  const int* layer;         // device int32 (nullptr: layer 0)
  const float* code;        // CUBIC: [A, C]
  void* out;                // [m, dout] f32 or bf16
  float* part;              // [grid, 2, 2, 128 * N] f32 partial sums
  int* tickets;             // [2 * tiles], zero between launches
  int m, k, dout;           // k: packed rows (K6) or din (K10)
  int n_tiles, n_stages;    // tiles of 256 columns, stages of 128 rows
  int out_dtype;
};

__device__ __forceinline__ uint32_t su32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(su32(b)),
               "r"(n) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(su32(b))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* b, uint32_t n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(su32(b)), "r"(n) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(su32(b)), "r"(parity) : "memory");
}
// one box of the tensor map at (c0, c1, c2) into shared memory,
// completing on barrier b (the map's 128-byte swizzle puts 16-byte chunk
// c of a box's row r at chunk c ^ (r % 8); the consumers' loads apply it)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* tm,
                                         int c0, int c1, int c2,
                                         uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(su32(dst)), "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0),
      "r"(c1), "r"(c2), "r"(su32(b)) : "memory");
}
// generic-proxy writes to shared memory become visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}
// An MMA reads its A registers asynchronously: keeps them live (not
// reused by the compiler) until a wait that covers their MMA. A_DEPTH
// steps' A fragments rotate, so A_DEPTH - 1 MMAs stay in flight while the
// next step converts its weights.
constexpr int A_DEPTH = 4;
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
// keeps the compiler from moving accumulator accesses across the
// asynchronous MMAs
template <int NA>
__device__ __forceinline__ void fence_acc(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// no-swizzle shared-memory matrix descriptor: start address, the byte
// offsets between core matrices along k (leading) and along n (stride)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d[64 x N] += a[64 x 16] (bf16 registers) * b[16 x N] (bf16, shared
// memory, K-major), f32 accumulators: thread (warp w, lane 4 g + t) holds
// d[4 i + e] at row 16 w + g + 8 (e >> 1), column 8 i + 2 t + (e & 1)
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  if constexpr (N == 40) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19"
        "}, {%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
}

// K10 at m <= 8: the same product on mma.sync m16n8k16, each warp on its
// own 16 rows of A (its slice of the warpgroup's 64), the B fragment read
// from the staged activations (k16 step `step`: core matrices 2 step and
// 2 step + 1, row g, bytes 4 t4 ..); the accumulator layout is wgmma's at
// N = 8. At one activation tile the loop is bound by latency, and warps
// that do not synchronize per step hide more of it (K10 at m = 1 measured
// faster so; K6 slower, and keeps wgmma).
__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4],
                                     const uint8_t* xg, int step, int g,
                                     int t4) {
  const uint8_t* b = xg + step * 256 + g * 16 + t4 * 4;
  tc::mma(d, a, *reinterpret_cast<const uint32_t*>(b),
          *reinterpret_cast<const uint32_t*>(b + 128));
}

// ---- conversions -----------------------------------------------------

// K6 uniform: bf16x2 of the two signed nibbles of one byte of h (byte
// permute `sel` puts the byte in bits 0-7 and the byte of h >> 4 in bits
// 16-23): lop3 keeps each low nibble, flips it to offset binary u = s + 8
// and ORs in 0x4300 (bf16 128 + u), one FMA subtracts 136. Exact.
__device__ __forceinline__ uint32_t nib2_uniform(uint32_t h, uint32_t h4,
                                                 uint32_t sel) {
  const uint32_t r = __byte_perm(h, h4, sel);
  uint32_t v, o;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n"   // b ? a ^ c : c
      : "=r"(v) : "r"(r), "r"(0x000F000Fu), "r"(0x43084308u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(o) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return o;
}

// K6 cubic: the codebook value of each nibble n (two's complement s) of
// the 16 bits of h: low bytes from tl, high bytes from th (entry n at
// byte n % 4 of word n / 4), bf16x2 of the two nibbles of byte 0 in c0
// and of byte 1 in c1 (low nibble in the low half)
__device__ __forceinline__ void nib4_cubic(uint32_t h, const uint32_t (&tl)[4],
                                           const uint32_t (&th)[4],
                                           uint32_t& c0, uint32_t& c1) {
  const uint32_t s7 = h & 0x7777u;                      // entry within 8
  const uint32_t hi = ((h >> 1) & 0x4444u) | 0x3210u;   // bit 3: upper 8
  const uint32_t lo_b = __byte_perm(__byte_perm(tl[0], tl[1], s7),
                                    __byte_perm(tl[2], tl[3], s7), hi);
  const uint32_t hi_b = __byte_perm(__byte_perm(th[0], th[1], s7),
                                    __byte_perm(th[2], th[3], s7), hi);
  c0 = __byte_perm(lo_b, hi_b, 0x5140u);
  c1 = __byte_perm(lo_b, hi_b, 0x7362u);
}

// K10: bf16x2 of bytes k, k + 1 of w, each f32(byte) * s rounded to
// nearest (0x4B0000xx is 2^23 + xx; xx the offset-binary byte)
__device__ __forceinline__ uint32_t int8_pair(uint32_t w, int k, float s) {
  const uint32_t u = w ^ 0x80808080u;
  const float a = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + k)) -
                  8388736.0f;
  const float b = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7651 + k)) -
                  8388736.0f;
  return tc::pack(__fmul_rn(a, s), __fmul_rn(b, s));
}

__device__ __forceinline__ void store(void* out, int out_dtype, size_t i,
                                      float v) {
  if (out_dtype == cs::BF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

// ---- the producer warpgroup ----------------------------------------------

// The activations of stage s into the stage's B operand; rows >= m stay
// zero. K6: x_lo and x_hi of 4 packed rows interleaved into one 16-byte
// core-matrix row (pairs [lo, hi], the A fragment's k order); K10: 16 k of
// a row into two core-matrix rows, the even and the odd bf16 pairs (thread
// t's A fragment reads k 4t .. 4t + 3). K6 loads BATCH items a thread
// before it stores them (measured faster); K10 one (measured faster at
// m = 40 / 64, the same at m = 1).
template <int V>
__device__ __forceinline__ void stage_x(const Args& a, uint8_t* xs, int s,
                                        int tid) {
  constexpr int SBO = sbo<V>();
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  if constexpr (V == INT8) {
    constexpr int PER_ROW = BOX / 16;
    for (int it = tid; it < a.m * PER_ROW; it += PRODUCERS) {
      const int r = it / PER_ROW, c = it % PER_ROW;
      const uint4* src = reinterpret_cast<const uint4*>(
          x + static_cast<size_t>(r) * a.k + s * BOX + c * 16);
      const uint4 p0 = __ldg(src), p1 = __ldg(src + 1);
      uint8_t* d = xs + (r >> 3) * SBO + (2 * c) * 128 + (r & 7) * 16;
      *reinterpret_cast<uint4*>(d) = make_uint4(p0.x, p0.z, p1.x, p1.z);
      *reinterpret_cast<uint4*>(d + 128) = make_uint4(p0.y, p0.w, p1.y, p1.w);
    }
  } else {
    constexpr int PER_ROW = BOX / 4, BATCH = 2;
    const int half = a.k;
    const int n = a.m * PER_ROW;
    for (int base = tid; base < n; base += PRODUCERS * BATCH) {
      uint2 lo[BATCH], hi[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int it = base + u * PRODUCERS;
        if (it < n) {
          const int r = it / PER_ROW, g4 = it % PER_ROW;
          const __nv_bfloat16* row =
              x + static_cast<size_t>(r) * 2 * half + s * BOX + g4 * 4;
          lo[u] = __ldg(reinterpret_cast<const uint2*>(row));
          hi[u] = __ldg(reinterpret_cast<const uint2*>(row + half));
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int it = base + u * PRODUCERS;
        if (it < n) {
          const int r = it / PER_ROW, g4 = it % PER_ROW;
          *reinterpret_cast<uint4*>(xs + (r >> 3) * SBO + g4 * 128 +
                                    (r & 7) * 16) =
              make_uint4(__byte_perm(lo[u].x, hi[u].x, 0x5410u),
                         __byte_perm(lo[u].x, hi[u].x, 0x7632u),
                         __byte_perm(lo[u].y, hi[u].y, 0x5410u),
                         __byte_perm(lo[u].y, hi[u].y, 0x7632u));
        }
      }
    }
  }
}

// A block's work (ops/quant_gemv.py stream_segments), stream-K: units
// [u0, u1) = [b U / G, (b + 1) U / G) of the U = n_tiles x n_stages
// (tile, stage) units in tile-major order, so that every block streams the
// same bytes in one wave; a tile split between blocks is finished by the
// last of them.
struct Work {
  long long U, u0, u1;
};
__device__ __forceinline__ Work block_work(const Args& a) {
  Work w;
  w.U = static_cast<long long>(a.n_tiles) * a.n_stages;
  w.u0 = blockIdx.x * w.U / gridDim.x;
  w.u1 = (blockIdx.x + 1) * w.U / gridDim.x;
  return w;
}

template <int V, int N>
__device__ __forceinline__ void produce(const Args& a, const CUtensorMap* tm,
                                        uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, int li, int tid) {
  constexpr int ST = n_stages_ring<V, N>(), SB = stage_bytes<V, N>();
  const Work wk = block_work(a);
  const int S = a.n_stages;
  int i = 0;
  for (long long u = wk.u0; u < wk.u1; ++u, ++i) {
    const int t = static_cast<int>(u / S), s = static_cast<int>(u % S);
    const int slot = i % ST;
    uint8_t* st = ring + slot * SB;
    mbar_wait(empty + slot, ((i / ST) & 1) ^ 1);
    if (tid == 0) {
      // the stage's boxes, rows s * 128 .. + 127 of columns t * 256 .. +
      // 127 and .. + 255: K6 packed rows (a box row per packed row), K10
      // layer li's columns (a box row per column, its k s * 128 ..). A
      // box past dout is not loaded; its results are never stored.
      const int nb = t * TILE_N + BOX < a.dout ? BOXES : 1;
      mbar_arrive_tx(full + slot, nb * BOX_BYTES);
      for (int j = 0; j < nb; ++j) {
        if constexpr (V == INT8)
          tma_load(st + j * BOX_BYTES, tm, s * BOX, t * TILE_N + j * BOX, li,
                   full + slot);
        else
          tma_load(st + j * BOX_BYTES, tm, t * TILE_N + j * BOX, s * BOX, 0,
                   full + slot);
      }
    }
    stage_x<V>(a, st + W_BYTES, s, tid);
    fence_async_smem();
    mbar_arrive(full + slot);
  }
}

// ---- the consumer warpgroups -----------------------------------------------

template <int V, int N>
__device__ __forceinline__ void consume(const Args& a, uint8_t* ring,
                                        uint64_t* full, uint64_t* empty,
                                        volatile int* flag, int li,
                                        int ct) {
  constexpr int ST = n_stages_ring<V, N>(), SB = stage_bytes<V, N>();
  constexpr int NA = N / 2, SBO = sbo<V>(), SLOT = 128 * N;
  const int wg = ct >> 7, wt = ct & 127;
  const int w = wt >> 5, lane = wt & 31, g = lane >> 2, t4 = lane & 3;
  const int G = gridDim.x, b = blockIdx.x;
  const int S = a.n_stages;
  const Work wk = block_work(a);
  // Consumer warpgroup wg takes box wg, 128 columns, as two sets of 64
  // (two accumulators, two MMAs a k16 step). K6: this thread's 16-byte
  // chunk of a box row (warp w: chunks w and w + 4, so the four rows of
  // one load fall on distinct banks after the swizzle) and its 4 bytes
  // (columns) in it: set q's A rows g / g + 8 are columns 16 chunk + cb +
  // 2 q / + 1. K10: set q's A rows g / g + 8 are box rows (columns) 64 q
  // + 16 w + g / + 8.
  const int chunk = w + 4 * (g >> 2), cb = 4 * (g & 3);

  uint32_t tl[4] = {0, 0, 0, 0}, th[4] = {0, 0, 0, 0};
  if constexpr (V == CUBIC) {
    // the codebook of every nibble n, rounded as the plain version: f32
    // s * (A + C * s^2), then bf16
    const float A = __ldg(a.code), C = __ldg(a.code + 1);
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const float sv = static_cast<float>(n < 8 ? n : n - 16);
      const float v =
          __fmul_rn(sv, __fadd_rn(A, __fmul_rn(C, __fmul_rn(sv, sv))));
      const uint32_t bits = __bfloat16_as_ushort(__float2bfloat16_rn(v));
      tl[n >> 2] |= (bits & 0xFFu) << (8 * (n & 3));
      th[n >> 2] |= (bits >> 8) << (8 * (n & 3));
    }
  }

  float acc[2][NA];
  int i = 0;
  // stages s0 .. s1 - 1 of tile t, then its sums out
  auto segment = [&](int t, int s0, int s1) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int v = 0; v < NA; ++v) acc[q][v] = 0.f;
    float sc[2][2] = {};   // K10: the scales of set q's columns g, g + 8
    if constexpr (V == INT8) {
      const int c0 = t * TILE_N + wg * BOX + 16 * w + g;
      const float* p = a.scale + static_cast<long long>(li) * a.scale_stride;
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + 64 * q + 8 * h;
          sc[q][h] = c < a.dout ? __ldg(p + c) : 0.f;
        }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) fence_acc(acc[q]);
    for (int s = s0; s < s1; ++s, ++i) {
      const int slot = i % ST;
      mbar_wait(full + slot, (i / ST) & 1);
      const uint8_t* st = ring + slot * SB;
      const uint32_t xs = su32(st + W_BYTES);
      if constexpr (V == INT8) {
        // box wg, rows (columns) r = 64 q + 16 w + g and r + 8 (both r % 8
        // = g), k 16 j + 4 t4 .. + 3 of the stage
        const uint8_t* r0 =
            st + wg * BOX_BYTES + (16 * w + g) * BOX + 4 * t4;
        uint32_t af[A_DEPTH][2][4] = {};   // step j's A: af[j % A_DEPTH]
#pragma unroll
        for (int j = 0; j < BOX / 16; ++j) {
          const int c = ((j ^ g) & 7) << 4;
          uint32_t (&f)[2][4] = af[j % A_DEPTH];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const uint8_t* p = r0 + q * 64 * BOX + c;
            const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
            const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + 8 * BOX);
            f[q][0] = int8_pair(w0, 0, sc[q][0]);
            f[q][1] = int8_pair(w1, 0, sc[q][1]);
            f[q][2] = int8_pair(w0, 2, sc[q][0]);
            f[q][3] = int8_pair(w1, 2, sc[q][1]);
          }
          if constexpr (N == 8) {
            mma8(acc[0], f[0], st + W_BYTES, j, g, t4);
            mma8(acc[1], f[1], st + W_BYTES, j, g, t4);
          } else {
            const uint64_t d = smem_desc(xs + j * 256, 128, SBO);
            wgmma_fence();
            wgmma<N>(acc[0], f[0], d);
            wgmma<N>(acc[1], f[1], d);
            wgmma_commit();
            wgmma_wait<A_DEPTH - 1>();   // step j + 1 - A_DEPTH is done
            fence_regs(af[(j + 1) % A_DEPTH][0]);
            fence_regs(af[(j + 1) % A_DEPTH][1]);
          }
        }
      } else {
        // box wg: A row g / g + 8 of set q is column 16 chunk + cb + 2 q /
        // + 1 of the box; k pairs t4 and t4 + 4: packed rows 8 j + t4 and
        // 8 j + t4 + 4, both nibbles
        const uint8_t* box = st + wg * BOX_BYTES;
        const uint8_t* r0 = box + t4 * BOX + (((chunk ^ t4) & 7) << 4) + cb;
        const uint8_t* r1 =
            box + (t4 + 4) * BOX + (((chunk ^ (t4 + 4)) & 7) << 4) + cb;
        uint32_t af[A_DEPTH][2][4] = {};   // step j's A: af[j % A_DEPTH]
#pragma unroll
        for (int j = 0; j < BOX / 8; ++j) {
          const uint32_t h0 = *reinterpret_cast<const uint32_t*>(r0 + 1024 * j);
          const uint32_t h1 = *reinterpret_cast<const uint32_t*>(r1 + 1024 * j);
          uint32_t (&f)[2][4] = af[j % A_DEPTH];
          if constexpr (V == CUBIC) {
            nib4_cubic(h0, tl, th, f[0][0], f[0][1]);
            nib4_cubic(h1, tl, th, f[0][2], f[0][3]);
            nib4_cubic(h0 >> 16, tl, th, f[1][0], f[1][1]);
            nib4_cubic(h1 >> 16, tl, th, f[1][2], f[1][3]);
          } else {
            const uint32_t h04 = h0 >> 4, h14 = h1 >> 4;
            f[0][0] = nib2_uniform(h0, h04, 0x0400u);
            f[0][1] = nib2_uniform(h0, h04, 0x0501u);
            f[0][2] = nib2_uniform(h1, h14, 0x0400u);
            f[0][3] = nib2_uniform(h1, h14, 0x0501u);
            f[1][0] = nib2_uniform(h0, h04, 0x0602u);
            f[1][1] = nib2_uniform(h0, h04, 0x0703u);
            f[1][2] = nib2_uniform(h1, h14, 0x0602u);
            f[1][3] = nib2_uniform(h1, h14, 0x0703u);
          }
          const uint64_t d = smem_desc(xs + j * 256, 128, SBO);
          wgmma_fence();
          wgmma<N>(acc[0], f[0], d);
          wgmma<N>(acc[1], f[1], d);
          wgmma_commit();
          wgmma_wait<A_DEPTH - 1>();   // step j + 1 - A_DEPTH is done
          fence_regs(af[(j + 1) % A_DEPTH][0]);
          fence_regs(af[(j + 1) % A_DEPTH][1]);
        }
      }
      if constexpr (!(V == INT8 && N == 8)) wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < 2; ++q) fence_acc(acc[q]);
      mbar_arrive(empty + slot);
    }

    if (!(s0 == 0 && s1 == S)) {
      // a tile split between blocks: this block's sums into its slot (its
      // first or last segment), then the last block of the tile sums the
      // slots of every block that covered it, in block order
      float* part = a.part;
      const int which = t == static_cast<int>(wk.u0 / S) ? 0 : 1;
      float* mine = part + (static_cast<size_t>(b * 2 + which) * 2 + wg) * SLOT;
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int v = 0; v < NA; ++v)
          __stcg(mine + (q * NA + v) * 128 + wt, acc[q][v]);
      __threadfence();
      wg_barrier(1 + wg);
      const long long ub = static_cast<long long>(t) * S;
      const int bf = static_cast<int>(((ub + 1) * G - 1) / wk.U);
      const int bl = static_cast<int>(((ub + S) * G - 1) / wk.U);
      if (wt == 0)
        flag[wg] = atomicAdd(a.tickets + 2 * t + wg, 1) == bl - bf;
      wg_barrier(1 + wg);
      if (flag[wg] == 0) return;   // another block finishes the tile
      __threadfence();
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int v = 0; v < NA; ++v) acc[q][v] = 0.f;
      // FB blocks' slots in flight at once (a tile of a deep k, such as
      // down_proj's, meets ~10 blocks; one L2 round trip each would leave
      // the tile's last block waiting), summed in block order
      constexpr int FB = N <= 8 ? 4 : N <= 16 ? 2 : 1;
      for (int b0 = bf; b0 <= bl; b0 += FB) {
        float pv[FB][2][NA];
#pragma unroll
        for (int f = 0; f < FB; ++f) {
          const int bb = b0 + f;
          if (bb <= bl) {
            const int wb = t == static_cast<int>((bb * wk.U / G) / S) ? 0 : 1;
            const float* p =
                part + (static_cast<size_t>(bb * 2 + wb) * 2 + wg) * SLOT;
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
              for (int v = 0; v < NA; ++v)
                pv[f][q][v] = __ldcg(p + (q * NA + v) * 128 + wt);
          }
        }
#pragma unroll
        for (int f = 0; f < FB; ++f)
          if (b0 + f <= bl) {
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
              for (int v = 0; v < NA; ++v) acc[q][v] += pv[f][q][v];
          }
      }
      if (wt == 0) a.tickets[2 * t + wg] = 0;   // ready for the next launch
    }

    // the epilogue: acc[q][4 i + e] is output column col(q, e), activation
    // row 8 i + 2 t4 + (e & 1)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col =
            t * TILE_N + wg * BOX +
            (V == INT8 ? 64 * q + 16 * w + g + 8 * (e >> 1)
                       : 16 * chunk + cb + 2 * q + (e >> 1));
        if (col >= a.dout) continue;
        const float cscale = V == INT8 ? 1.f : __ldg(a.scale + col);
#pragma unroll
        for (int n8 = 0; n8 < N / 8; ++n8) {
          const int row = 8 * n8 + 2 * t4 + (e & 1);
          if (row < a.m) {
            const float v = V == INT8 ? acc[q][4 * n8 + e]
                                      : __fmul_rn(acc[q][4 * n8 + e], cscale);
            store(a.out, a.out_dtype, static_cast<size_t>(row) * a.dout + col,
                  v);
          }
        }
      }
  };
  for (long long u = wk.u0; u < wk.u1;) {
    const int s0 = static_cast<int>(u % S);
    const int s1 = static_cast<int>(s0 + (wk.u1 - u) < S ? s0 + (wk.u1 - u) : S);
    segment(static_cast<int>(u / S), s0, s1);
    u += s1 - s0;
  }
}

template <int V, int N>
__global__ void __launch_bounds__(NT, 1)
quant_gemv_sm90_kernel(const __grid_constant__ CUtensorMap tm, const Args a) {
  constexpr int ST = n_stages_ring<V, N>(), SB = stage_bytes<V, N>();
  constexpr int XB = x_bytes<V, N>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((ALIGN - su32(smem_raw) % ALIGN) % ALIGN);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  volatile int* flag = reinterpret_cast<volatile int*>(smem + 256);
  uint8_t* ring = smem + HEAD;
  const int tid = threadIdx.x;

  // activation rows >= m stay zero in every stage
  for (int i = tid; i < ST * (XB / 16); i += NT) {
    const int s = i / (XB / 16), o = i % (XB / 16);
    *reinterpret_cast<uint4*>(ring + s * SB + W_BYTES + o * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, PRODUCERS + 1);   // + the expect_tx arrival
      mbar_init(empty + s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_async_smem();
  __syncthreads();

  const int li = a.layer == nullptr ? 0 : __ldg(a.layer);
  if (tid < PRODUCERS)
    produce<V, N>(a, &tm, ring, full, empty, li, tid);
  else
    consume<V, N>(a, ring, full, empty, flag, li, tid - PRODUCERS);
}

template <int V, int N>
int launch(const CUtensorMap& tm, const Args& a, int grid, cudaStream_t st) {
  auto kern = quant_gemv_sm90_kernel<V, N>;
  constexpr int bytes = smem_bytes<V, N>();
  // once per instantiation, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kern<<<grid, NT, bytes, st>>>(tm, a);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_n(const CUtensorMap& tm, const Args& a, int grid,
             cudaStream_t st) {
  if (a.m <= 8) return launch<V, 8>(tm, a, grid, st);
  if (a.m <= 16) return launch<V, 16>(tm, a, grid, st);
  if (a.m <= 32) return launch<V, 32>(tm, a, grid, st);
  if (a.m <= 40) return launch<V, 40>(tm, a, grid, st);
  return launch<V, 64>(tm, a, grid, st);
}

// ---- tensor maps, encoded once per weight tensor -----------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

struct MapEntry {
  const void* ptr;
  long long d0, d1, d2;
  CUtensorMap map;
};
constexpr int MAP_CACHE = 64;
MapEntry g_maps[MAP_CACHE];
int g_n_maps = 0, g_next_map = 0;
long long g_encodes = 0;
std::mutex g_map_lock;

// the driver's encoder, through the runtime (no link against libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The uint8 tensor map of a contiguous [d2][d1][d0] array at ptr (d0
// innermost) with 128 x 128 x 1 boxes and the 128-byte swizzle, from the
// cache keyed by pointer and shape (the strides follow from the shape),
// encoded on a miss. A pointer reused for another tensor of the same shape
// maps the same bytes, so a stale entry is never wrong.
int tensor_map(const void* ptr, long long d0, long long d1, long long d2,
               CUtensorMap* out) {
  std::lock_guard<std::mutex> guard(g_map_lock);
  for (int i = 0; i < g_n_maps; ++i) {
    const MapEntry& e = g_maps[i];
    if (e.ptr == ptr && e.d0 == d0 && e.d1 == d1 && e.d2 == d2) {
      *out = e.map;
      return 0;
    }
  }
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  MapEntry& e = g_maps[g_next_map];
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0),
                                 static_cast<cuuint64_t>(d0 * d1)};
  const cuuint32_t box[3] = {128, 128, 1}, elem[3] = {1, 1, 1};
  const CUresult r = fn(&e.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  e.ptr = ptr;
  e.d0 = d0;
  e.d1 = d1;
  e.d2 = d2;
  ++g_encodes;
  g_next_map = (g_next_map + 1) % MAP_CACHE;
  if (g_n_maps < MAP_CACHE) ++g_n_maps;
  *out = e.map;
  return 0;
}

}  // namespace

// x: [m, 2 * k] bf16 (K6, split halves) or [m, k] bf16 (K10); q: the
// weights, [k, dout] int8 packed (K6, 2D) or `layers` column-major [din =
// k, dout] int8 layers, contiguous (K10; `layer` a device int32, nullptr
// for one 2D layer); scale: f32 [dout] (K6) or [L, dout] with
// `scale_stride`; code: f32 [A, C] (CUBIC); out: [m, dout] f32 or bf16
// (out_dtype); part: f32 [grid * 2 * 2 * 128 * N] with N = m rounded up
// to 8, 16, 32, 40 or 64, and tickets: int32 [2 * dout / 128], zero
// between launches (the caller's workspace); grid: blocks, at most one per
// SM and one per unit (K6: ceil(dout / 256) tiles x k / 128 stages; K10:
// dout / 128 tiles x ceil(k / 256) stages). 1 <= m <= 64; k and dout
// multiples of 128; every pointer 16-byte aligned. The weights' tensor
// map is encoded at the first call on them and cached.
extern "C" int cs_quant_gemv_sm90(const void* x, const void* q, int layers,
                                  const void* scale, int scale_stride,
                                  const void* layer, const void* code,
                                  void* out, void* part, void* tickets,
                                  int m, int k, int dout, int grid,
                                  int variant, int out_dtype, void* stream) {
  const int tiles = (dout + TILE_N - 1) / TILE_N, stages = k / BOX;
  if (m < 1 || m > 64 || k % BOX || dout % BOX || k < BOX || dout < BOX ||
      layers < 1 || grid < 1 || static_cast<long long>(grid) > 1LL * tiles * stages)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm;
  const int err = variant == INT8 ? tensor_map(q, k, dout, layers, &tm)
                                  : tensor_map(q, dout, k, 1, &tm);
  if (err) return err;
  Args a;
  a.x = x;
  a.scale = static_cast<const float*>(scale);
  a.scale_stride = scale_stride;
  a.layer = static_cast<const int*>(layer);
  a.code = static_cast<const float*>(code);
  a.out = out;
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<int*>(tickets);
  a.m = m;
  a.k = k;
  a.dout = dout;
  a.n_tiles = tiles;
  a.n_stages = stages;
  a.out_dtype = out_dtype;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == UNIFORM) return launch_n<UNIFORM>(tm, a, grid, st);
  if (variant == CUBIC) return launch_n<CUBIC>(tm, a, grid, st);
  if (variant == INT8) return launch_n<INT8>(tm, a, grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// tensor maps encoded so far in this process (one per weight tensor)
extern "C" int cs_quant_gemv_sm90_encodes() {
  std::lock_guard<std::mutex> guard(g_map_lock);
  return static_cast<int>(g_encodes);
}
