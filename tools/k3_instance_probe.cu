// One chosen instance of K3's tensor-core kernel over an f32 or f16 KV
// cache (lm_attention_tc.cuh, D = 128): <MT m-tiles, NW warps>, the rows a
// block 16 * MT * NW, for tools/k3_instance_probe.py, which weighs
// dispatch_prefill_tc's choice by timing each. Built on its own (nvcc
// -shared -I cogstream_tpu_torch/csrc), never part of the port's library.
// tile_mm is the caller's [2, B, n_tiles] min / max pre-pass; kv is a
// cs::DType code (F32 or F16).
#include "lm_attention_tc.cuh"

extern "C" int k3_instance(int kv, int mt, int nw, const void* q,
                           const void* k, const void* v, const void* qpos,
                           const void* eff, const void* tile_mm, void* out,
                           int B, int S, int Hq, int Hkv, int T_cache,
                           int kv_len, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale2 = scale * tc::LOG2E;
#define K3_INSTANCE(KV, MT, NW)                                              \
  if (kv == KV && mt == MT && nw == NW)                                      \
    return launch_prefill_tc<128, MT, NW, KV>(                               \
        q, k, v, qpos, eff, tile_mm, nullptr, out, B, S, Hq, Hkv, T_cache,   \
        kv_len, scale2, st);
  K3_INSTANCE(cs::F32, 2, 8) K3_INSTANCE(cs::F32, 1, 8)
  K3_INSTANCE(cs::F32, 2, 4) K3_INSTANCE(cs::F32, 1, 4)
  K3_INSTANCE(cs::F16, 2, 8) K3_INSTANCE(cs::F16, 1, 8)
  K3_INSTANCE(cs::F16, 2, 4) K3_INSTANCE(cs::F16, 1, 4)
#undef K3_INSTANCE
  return static_cast<int>(cudaErrorInvalidValue);
}
