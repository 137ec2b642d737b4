// One chosen instance of K4's tensor-core kernel over an f16 or f32 KV
// cache (lm_attention_tc.cuh, D = 128): <MT m-tiles, NW warps>, with the
// split the caller gives, for tools/torch_kernel_ab.py --plans, which
// weighs each kind's warps and split (dec_warps, decode_plan) by timing
// them. Built on its own (nvcc -shared -I cogstream_tpu_torch/csrc), never
// part of the port's library. kv is a cs::DType code (F32 or F16); the
// workspace (part_ml, part_acc, tickets) is cs_gqa_decode_tc's.
#include "lm_attention_tc.cuh"

extern "C" int k4_instance(int kv, int mt, int nw, const void* q,
                           const void* k, const void* v, const void* qpos,
                           const void* eff, const void* rows, void* part_ml,
                           void* part_acc, void* tickets, void* out, int B,
                           int S, int Hq, int Hkv, int T_cache, int kv_len,
                           int tiles_per_split, int n_splits, float scale,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale2 = scale * tc::LOG2E;
#define K4_INSTANCE(KV, NW)                                                   \
  if (kv == KV && nw == NW) {                                                 \
    if (mt == 1)                                                              \
      return launch_decode_tc<128, 1, NW, KV>(                                \
          q, k, v, qpos, eff, rows, part_ml, part_acc, tickets, out, B, S,    \
          Hq, Hkv, T_cache, kv_len, tiles_per_split, n_splits, scale2, st);   \
    if (mt == 2)                                                              \
      return launch_decode_tc<128, 2, NW, KV>(                                \
          q, k, v, qpos, eff, rows, part_ml, part_acc, tickets, out, B, S,    \
          Hq, Hkv, T_cache, kv_len, tiles_per_split, n_splits, scale2, st);   \
  }
  K4_INSTANCE(cs::F16, 4) K4_INSTANCE(cs::F16, 5) K4_INSTANCE(cs::F16, 6)
  K4_INSTANCE(cs::F32, 3) K4_INSTANCE(cs::F32, 2)
#undef K4_INSTANCE
  return static_cast<int>(cudaErrorInvalidValue);
}
