// K3 and K4 on the tensor cores over an f16 KV cache (rounded to bf16 in
// registers: K3 by each thread for its chunks on the way into the bf16
// tile, 256, 128 or 64 rows a block; K4 in its B fragments before their
// MMA, from the cache's own bytes, bf16's 4 warps), bf16
// queries: this kind's instances of
// lm_attention_tc.cuh, built beside the other kinds' (lm_attention.cu's C
// entries call these).
#include "lm_attention_tc.cuh"

int prefill_tc_f16(int D, const void* q, const void* k, const void* v,
                   const void* qpos, const void* eff, const void* tile_mm,
                   const void* rows, void* out, int B, int S, int Hq, int Hkv,
                   int T_cache, int kv_len, float scale2, cudaStream_t st) {
  return prefill_tc_kind<cs::F16>(D, q, k, v, qpos, eff, tile_mm, rows, out, B,
                                  S, Hq, Hkv, T_cache, kv_len, scale2, st);
}

int decode_tc_f16(int D, int mt, const void* q, const void* k, const void* v,
                  const void* qpos, const void* eff, const void* rows,
                  void* part_ml, void* part_acc, void* tickets, void* out,
                  int B, int S, int Hq, int Hkv, int T_cache, int kv_len,
                  int tiles_per_split, int n_splits, float scale2,
                  cudaStream_t st) {
  return decode_tc_kind<cs::F16>(D, mt, q, k, v, qpos, eff, rows, part_ml,
                                 part_acc, tickets, out, B, S, Hq, Hkv,
                                 T_cache, kv_len, tiles_per_split, n_splits,
                                 scale2, st);
}
