#!/usr/bin/env python3
"""Run the PyTorch port's serving and training paths once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line or a few; any failure exits non-zero):

1. device — the card's name and power limit from nvidia-smi;
2. build  — nvcc builds the port's kernels (cogstream_tpu_torch/csrc), one
   process per source, all at once, and prints the registers and spills
   ptxas gave the tensor-core kernels of K1, K3, K4, K5, K8 and K9, and
   the f32 tile's instances of K1 and K3 (registers, spills, shared bytes
   and blocks an SM);
3. kernels — each kernel against its plain PyTorch version on the card,
   in bf16, at the shapes the 7B paths give it, with both times, the
   time of one PyTorch library call computing the same function where
   one exists, and the least time the card could take (bound): K1
   vision attention, K2 LayerNorm, K3 prefill attention, K4 decode
   attention, K5 head-major segment attention (the training tower's),
   and the int4 GEMVs K6 (uniform and cubic) and K7 on the lm_head, K8
   and K9 on stacked gate_proj (m = 1, 40, 64) / down_proj (m = 1), on
   their tensor-core kernel, timed beside the CUDA-core kernel K6 / K7
   keep, two calls bit-identical; the int8 GEMV K10 (not a TPU kernel:
   the fusion XLA does in the JAX int8 matmul) on stacked gate_proj (m =
   1, 40, 64), down_proj (m = 1) and the 2D lm_head (m = 1), two calls
   bit-identical and a CUDA-graph replay equal to the eager call, beside
   ``torch._weight_int8pack_mm`` where the card's build has it; K6
   (uniform) on the lm_head and K8 on gate_proj (m = 1) beside
   ``torch._weight_int4pack_mm`` on the same values (repacked, the
   rscale folded into the activations; its time reported only where its
   output agrees); K7 and K9 at Qwen2-7B's tp = 2 shard shapes (the
   lm_head's vocab shard, gate_proj's column shard, down_proj's row
   shard through the row-shard wrapper with K9's f32 partials); and the
   W8A8 product of one gate_proj at a 4384-row prefill (activation
   quantization, ``torch._int_mm`` on the held column-major weights and on
   a row-major copy, epilogue) beside the bf16 ``F.linear``. K1, K3, K4 and K5 run their
   bf16 tensor-core kernels, timed beside their f32 route (CUDA-core
   f32 tiles) on the same values, its bound at the f32 peak, its plain
   version (once) and the library call on those f32 values; K1's and
   K3's f32 routes (the register-blocked f32 tile) are also held to that
   plain version, each row within F32_ROW_TOL of its max |ref|, and K3's
   must beat the library call in f32 (their kernels-line records carry
   phase 4's launches); K3 also at a question prefill (a few
   dozen tokens over a ~9k-slot window), where it must beat the f32
   route (held to its plain version too); K3, K4 and K5 must beat the
   library call. K4 and K5 are timed
   from CUDA graphs; K4's two calls must be bit-identical and one call
   captured in a graph, replayed after its q / eff were rewritten, must
   equal the eager call; K4 also runs a verify step (S = 8). Pad rows
   and fully masked rows must be exactly 0. Lookahead's verify steps (S
   = k+1 queries at consecutive positions, their own slots live): K4 at
   S = 5 and 8, K3 at S = 9, each within the per-row bound and timed
   beside its bytes bound and S = 1's. Then pooled addressing: K3
   (the 4384-token prefill) and K4 (S = 1 and 8) read rows [2] and
   [3, 1] of a [4, 9216, 4, 128] pool cache through ``rows``, each call
   bit-identical to the kernel on a contiguous copy of those rows and
   within the 2-ulp bound of the plain version, timed beside that copy's
   call; one K4 call with rows replays in a CUDA graph. The fp8 KV cache:
   torch's CUDA cast to e4m3 equals its CPU cast on all 65536 bf16 bit
   patterns and on f32 draws, and the port's cache cast saturates past
   464; K3 (the 4384-token prefill) and K4 (S = 1, 5, 8) over an e4m3
   cache, held to their plain versions by the 2-ulp row rule, timed
   beside the bf16 route on the same values and beside their bound, K4's
   graph replay bit-identical, and both again through ``rows`` on a [4,
   9216, 4, 128] e4m3 pool; ptxas registers, shared memory and blocks per
   SM of the bf16 and e4m3 instantiations. The other cache dtypes: K3
   and K4 over an e5m2, f16 and f32 cache on the tensor-core kernels (bf16
   queries) and over a bf16 cache on the f32 route, at the same shapes,
   each within the 2-ulp row rule of its plain version and counted under
   its dtype, timed beside the bf16 (f32) route on the same values and
   beside its bound (K4 at S = 1, 5 and 8), K4's graph replay
   bit-identical, K3 over f16 and f32 within one bf16 ulp of the bf16
   kernel over the cache rounded to bf16 (its differing elements
   counted), K4 over them each row within one bf16 ulp of its max there
   and f16 on bf16's split bit-equal to it; every e5m2 byte
   widened exactly as V and as K; those instances' ptxas figures;
4. reference — a tiny-config session (f32) runs ingest → ask(AC) →
   ingest → ask(FCC) on the card (kernels) and on the CPU (plain
   versions); greedy tokens, selections and slot ranges must agree. Then
   the same with a rank-1 int4 decoder and W4A8 decode (K6-K9), and
   with an int8 decoder, w8a8_prefill and the W8A8 tower (K10's f32
   route and ``torch._int_mm`` on the card). Then
   tiny training (f32, dropout 0, the same weights and LoRA init on
   both): two ``train_stage1`` steps and two ``Stage2Trainer`` turns
   (one with a pooling plan; the tower runs K5 on the card), losses and
   updated adapters held to the CPU's. A tiny 3-row ``SessionPool``
   (ingest_batch, ask_batch AC then FCC, a solo ask, ask_stream) on the
   card and the CPU: the same tokens, selections, ranges, positions. The
   tiny f32 dialogue with lookahead_k = 2 (K4 verifies) and 8 (K3
   verifies) on the card and the CPU: the same tokens and verify steps;
   on the card the vanilla dialogue's tokens, and its cache wherever
   pos >= 0. The tiny f32 session over an e4m3, an e5m2 and a bf16 cache,
   card vs CPU: the same tokens, selections and ranges, the cache within
   one step of its dtype, K3 and K4 launched over it (the bf16 cache's
   counts are the f32 route's launches in the kernels line). The phase's
   launches of the f32-query routes (CUDA-core tiles) of K1, K3, K4, K5.
   QLoRA: the backward of each GEMV wrapper (K6-K10 at 7B gate_proj
   shapes, m = 64) against the f32 product of g and the weights it
   dequantizes (2-ulp rule), each forward launching its kernel; tiny
   ``Stage2Trainer`` turns on a base quantized whole (NF4, then int8 with
   w8a8_prefill) card vs CPU, losses and adapters held to the CPU's, K10
   launching in the int8 run's 64-token turn;
5. main path — a 7B-width ``StreamingSession`` (cogreasoner_7b, bf16,
   random weights from a seeded generator, 16384-slot cache) ingests two
   16-frame segments (24x42 patch grids, merge 2, seeded uint8 patch
   rows) and answers ask(AC) and ask(FCC); K1-K4's launch counts must
   rise during this phase, every one of K1's, K3's and K4's launches on
   its tensor-core kernel (K4: one launch per call, no combine pass),
   every output must be finite and the slot ranges ordered and disjoint.
   Lookahead: (a) the session is saved after its FCC turn and asks a
   third question four times from that state, in turns: vanilla,
   lookahead_k=4 twice, vanilla (lookahead tokens equal up to the first
   step whose vanilla top-1 / top-2 logit gap is within 2 bf16 ulps;
   steps, accepted-draft rate, decode tok/s and the step split);
   (b) on a 512-token prompt, the vanilla loop's 71 greedy tokens are the
   teacher of ``generate_tokens_lookahead`` with fixed_accept 0, 2, 4 at
   k = 4 and 7 at k = 7 (steps, wall, tok/s under the same rule), and a
   verify step's cost (S = 5, 8) beside a decode step's; (c) a second
   session with an e4m3 cache (kv_dtype) ingests the same segments and
   asks the same questions: ingest s, turns, decode tok/s, the cache's
   bytes beside bf16's, the greedy-prefix agreement with the bf16
   answers (reported), the largest |K| / |V| and saturated elements; K3
   and K4 (counted from zero) must run over the e4m3 cache; then a decode
   step's cost over 9000 history slots in a bf16 and an e4m3 cache; the
   same session and step cost over an e5m2 cache, and one segment and
   its AC ask (8 tokens) over an f16 and over an f32 cache, each with K3
   and K4 launched over its cache on the tensor-core kernels (the kernels
   line's launches of those routes) and no inf or NaN written;
8. engine (runs on the phase-5 model, before phases 7 and 6) — the
   evaluation entry point at full width and depth: the host decoders
   are probed (Pillow, OpenCV, ffmpeg), a seeded 150-frame video of ten
   static scenes with a moving block (224x364, 1 fps; an mp4v clip where
   OpenCV writes one, else a directory of .npy frames) and a spec of
   three 50-frame stream segments with one QA each go through
   ``answer_generate.run_eval`` and ``CogReasonerEngine`` in NC, AC, FCC
   and gt (16 greedy tokens a turn). Per turn: wall, encode,
   compression, visual tokens before and after, events, minor frames,
   prefill tokens and ms, marginal decode tok/s. K1-K4 must launch, all
   K1/K3/K4 launches on the tensor-core kernels; the last turn (150
   frames) must run k-means at K = 10, pool minor frames and drop static
   tokens; outputs finite, the FCC selection parses. Then the checkpoint
   round trip at full width, depth cut to 2 decoder and 2 tower layers:
   ``save_cogreasoner_to_hf`` → ``load_cogreasoner_from_hf`` bit-identical,
   the int4 and int8 loads identical to ``quantize_text_``, and the int4
   model's FCC turns launch K6 and K8 (write / load seconds, host peak
   RSS); (c) the training commands as subprocesses on that checkpoint,
   ``train-stage1`` on seeded selector chains and ``train-stage2
   --quantize-base nf4`` on the clip under a seeded three-segment spec:
   each exits 0, trains at least one step and writes its adapter; (d)
   the reference's published workflow through the port's command line on
   that checkpoint and the clip, each stage a subprocess: segment-videos
   (cuts at 50 and 100 s) -> datagen --model fake -> train-stage1 ->
   train-stage2 -> answer-generate (FCC, both adapters) -> judge x5 ->
   summarize -> nlp-metrics; every stage exits 0, the query chains are
   non-empty with sorted event times, one prediction per QA of the first
   chain, all five scores on every judged QA; each stage's wall. Phase 9
   (d) runs here too, while the checkpoint exists: ``serve --supervise``
   on it, solo and with ``--pool-rows 2``, beside an unfaulted control
   ``serve``; the second ingest's second chunk hits a real device-side
   assert (COGSTREAM_FAULT_INGEST_DISPATCH=3: an index past a tensor's
   end); the client must get a 503 naming it, the child exit 17, the
   supervisor (which must hold no /dev/nvidia file) start a new child
   that restores the session, and the next ask answer turn 1 with the
   control's tokens; fault -> 503 ms, child exit -> ready s, restore s.
   (c), (d) and the two supervised cases run side by side, each on a
   thread (their walls are taken so);
9. pooled serving (runs on the phase-5 model, after phase 8, before
   phases 7 and 6) — (a) a ``SessionPool`` of 4 rows x 16384 slots
   (3.76 GB of cache): two ``ingest_batch`` ticks of a seeded 16-frame
   24x42 segment per row, ``ask_batch`` AC then FCC on all rows (16
   greedy tokens), a solo pooled ask (K3 / K4 through ``rows``, allocator
   peak below one row's bytes: no copy of the whole row), ``ask_stream``
   in chunks of 16, and row 3 saved, asked, closed, restored with ``open_restored``
   and asked again with the same tokens; the rows a call does not
   address keep their checksums; (b) ``SessionServer(pool_rows=4)``
   over HTTP on 127.0.0.1: four clients create, ingest phase 8's clip,
   ask FCC twice, one streams; every answer non-empty, the stream ends
   with 0x1e and its meta, one frontend batch holds more than one row.
   K1-K4 launch in each, all K1 / K3 / K4 on the tensor-core kernels;
   (c) a 4 x 16384 pool with an e4m3 cache (its bytes beside the bf16
   pool's 3.76 GB), one ingest_batch tick and ask_batch AC, K3 / K4 over
   the e4m3 pool through rows;
7. training main path (runs on the phase-5 model, before phase 6) — the
   frozen ``cogreasoner_7b`` base with LoRA r=8 on all 7 projections x
   28 layers (stage 1), plus the projector readout (stage 2): (a)
   stage-1 steps on seeded selector samples, (b) ``Stage2Trainer``
   turns on a packed turn of 8 frames of 24x42 patches (grad_accum 2,
   remat on). Per step: wall time, tokens/s, peak GiB. K5 must launch
   27 times per tower forward, all on its tensor-core tile, every loss
   be finite, the LoRA b leaves
   change, the base stay bit-identical and a held-out forward's loss
   fall. Then QLoRA: a copy of the model quantized whole
   (``quantize_cogreasoner_``; NF4, then int8 with w8a8_prefill, one
   resident at a time beside the bf16 weights) trains 2 stage-2
   micro-steps on the same turn: wall, tokens/s, peak GiB (raw and less
   the resident bf16 weights) and model GiB beside bf16's; K5 27 times
   per tower forward on its tensor-core tile, finite losses, changed b
   leaves, the quantized base's checksum unchanged;
10. int8 main path (runs on the phase-5 model, after phase 7, before
   phase 6) — (a) an int8 copy of the decoder beside the bf16 one and a
   decode step of each (launches, device and wall ms); (b) for
   (w8a8_prefill, encoder_int8) = (off, off), (on, off), (on, on) a fresh
   session ingests a 16-frame 24x42 segment and answers AC (8 tokens)
   and FCC (16 tokens): K10 launches in every mode, ``torch._int_mm`` in
   the decoder only under w8a8_prefill and in the tower only under
   encoder_int8, no decode step dequantizes an int8 weight, every K1 /
   K3 / K4 launch on its tensor-core kernel; the off/off session asks
   once more with lookahead_k=4 (K10 launches at m = 5, steps, tok/s, no
   dequantization); (c) evaluate/quant_quality
   at full width and depth, bf16 the truth: int8, int8 + W8A8, int4u,
   int4c and nf4 by logit MAE, KL, top-1 agreement over 128 probe tokens
   and greedy prefix agreement over 16 tokens, one scheme resident at a
   time; int8's KL below each 4-bit scheme's; and the fp8kv row: the bf16
   build's cached logits and greedy continuation over an e4m3 cache
   against a bf16 cache;
11. tensor-parallel serving (runs on the phase-5 model, after phase 9,
   before phases 7, 10 and 6) — tp = 2 over a gloo group of two
   subprocesses of this script (``--tp-rank``), both on this card (NCCL
   refuses two ranks on one device; the kernels' library, built here,
   only loads there). The parent rewrites phase 8 (b)'s 2+2-layer
   checkpoint, starts the ranks, and while they run writes the solo
   references: phase 5's two ingests and asks replayed on the phase-5
   model (untimed), and replayed again with every row-parallel GEMM's
   sums split in two f32 halves as two ranks split them (the witness of
   what that sum order alone does to the logits); an int8
   (``w8a8_prefill``) and an int4 copy of the phase-5 decoder each ingest
   an 8-frame segment and ask AC (4 tokens). Each rank: (a) a tiny f32 session (ingest,
   AC, ingest, FCC, a lookahead_k=4 ask) with ``mesh=``, its tokens equal
   to the same session run solo on the card (rank 0 runs it first), K1-K4
   launched on each rank; (b) the phase-5 model at full width and depth,
   each rank drawing the same seeded tensors one at a time and keeping
   its shard (``init_cogreasoner_sharded``), phase 5's two segments and
   asks: each rank's first-step logits (its vocab slice) within 1e-2 of
   the row max of the solo replay's, or 1.5 times the witness's gap where
   that is larger, its AC and FCC selections equal to the replay's, the
   greedy-prefix agreement, K1-K4 launches, shard
   GiB beside the whole model's, collectives per decode step, walls (two
   ranks sharing one card over gloo: not a TP speed); (c) int8 +
   ``w8a8_prefill`` and int4 copies of the sharded decoder
   (``quantize_text_`` on the shards, absmaxes over both ranks), the
   int4 copy also with ``w4a8_decode`` and ``w8a8_prefill`` (int8
   activations; the row-parallel sites quantize each half at its global
   half's scale): the first token equal to the solo reference's, K10 /
   K6 + K8 (and not K7 / K9) / K7 + K9 (and not K6 / K8) launched on
   each rank, the W4A8 first-step logits within (b)'s AC gate of the
   solo W4A8 session's; (d) ``load_cogreasoner_from_hf(mesh=)`` of the checkpoint
   (bf16, int8 and int4 at load): every tensor equal to the rank's slice
   of the whole load; (e) snapshots and adapters on the shards, after
   (b)'s asks: (e1) the sharded session saves (rank 0 gathers every kv
   head and writes; snapshot GB, gather + write s), each rank's K/V equal
   to the file's slice at its kv heads bit for bit; (e2) a fresh sharded
   session restored from it (read + send s) answers the next AC ask (8
   tokens) as the original answers it after the save; (e3) the parent's
   solo session restores the file: its cache equal to the file's bytes,
   each rank's first-step logits on that ask within (b)'s AC gate of its;
   (e4) an e4m3 sharded session restored from the file: its own
   snapshot's bytes equal to the ranks'; (e5) a sharded session with the
   language and the full adapter (r = 8, every ``b`` from N(0, 0.03^2),
   sliced by the session) restored from the file and asked the same:
   each rank's first-step logits within the gate of the solo session's
   with the same adapters, the adapters moving the solo logits (the (e3)
   restore's) by 10 x the gate or more, and (the control) each rank's
   logits with the other rank's slice of the adapters beyond the gate.
   (b) asks 8 tokens a turn. A rank that fails fails the phase. Then
   (f) a new world of four ranks (``--tp-dp-rank``) on a (data 2, model
   2) mesh loads (d)'s checkpoint with ``mesh=`` and serves it:
   ``SessionServer(pool_rows=4)`` over HTTP, four clients (create, ingest
   an 8-frame clip, ask AC; rows 0-1 on data group 0, 2-3 on group 1),
   the session on row 2 saved and asked on, a fresh pooled server
   restoring it onto its row 2 and asked the same, and a solo server's
   session (replicated over the groups) asked, saved and restored: each
   row's and the solo session's first-step logit slices on the ranks
   that ran them within (b)'s AC gate of a solo server's on the whole
   checkpoint (the parent's), every rank's texts and selections equal to
   rank 0's, the restored row and session continuing with the original's
   tokens, each snapshot written and read by one rank (rank 2 the
   row's, rank 0 the solo session's), K1-K4 on every rank; shard GiB and
   walls (four ranks sharing one card: no data-parallel speed).
   ``--tp-only`` runs phase 11 alone; with ``--tp-snapshot-fault`` the
   ranks write rank 0's kv heads in every rank's place and keep the
   adapters whole, with ``--tp-w4a8-fault`` (c)'s W4A8 row-parallel
   sites quantize each rank's halves at their own scales, and either way
   the phase must fail;
12. data- and tensor-parallel training (runs on the phase-5 model, after
   phase 11, before phase 7) — two ranks on this card over gloo
   (subprocesses of this script, ``--train-rank``), LoRA dropout 0. The
   parent first runs the same steps in one process: one
   ``train_stage1`` step of 2 x 2048 byte tokens (a quarter of phase 7's
   batch: two whole bf16 replicas fit the card in (a)), its witness
   in two data ranks' sum order, two ``Stage2Trainer`` micro-steps on
   a 4-frame 24x42 turn (warm-up, then an update) and one on a 64-token
   text turn over an int8 copy (one stage-1 step: the checks read the
   first step's gradients). The ranks: (a) ``train_stage1`` on a (data
   2, model 1) mesh, losses and gathered adapters bit-equal to the witness; (b) on (data
   1, model 2), (c) ``Stage2Trainer`` on (1, 2), the 4-frame turn (the
   tower on 8 heads a rank: every K5 launch on its tensor-core tile)
   and the 64-token turn on an int8 copy of the shards (K10 on column
   and row shards): losses within 1e-2 of one process's, adapters
   within 2.01 lr an update. Replicated leaves bit-equal across the
   ranks; the adapter files the ranks wrote load in the parent; per rank
   peak GiB, collectives a step and walls (two ranks sharing one card
   over gloo: not a speed). Then, in the same two ranks on the whole
   model, (d) ``train_stage1`` on a (data 1, pipe 2) mesh, GPipe with 2
   microbatches, each rank its stage's 14 layers, and (e) the two
   4-frame micro-steps of ``Stage2Trainer`` with
   ``sequence_parallel=2`` (the ring; the tower replicated on each rank,
   K5 and K2): their first-step gradients, losses and adapters held to
   the one-process steps as (b) and (c) are, with each part's wall, its
   ``ppermute`` hops and bytes (and each hop's wall), and each rank's
   peak GiB; with ``--train-pp-fault`` one backward hop of each of (d)
   and (e) carries zeros from rank 1, and the phase must fail. (f), after
   (c) in the same ranks: the 64-token turn on the int8 shards with
   ``w8a8_prefill`` (stage 2's ``--w8a8-forward``: W8A8 on column and row
   shards), held to the one-process W8A8 turn with (b)'s bounds, and a
   7B o_proj and down_proj W8A8 product on row shards bit-equal to the
   whole product on the card, forward and ``dx``; with
   ``--train-w8a8-fault`` each rank's activations take their own absmax,
   and the phase must fail. A rank that fails fails the phase;
6. int4 main path — the same model's decoder is quantized in place to
   rank-1 uniform int4 (the bf16 weights are freed; memory before and
   after is printed); then, with w4a8_decode off and on, a fresh session
   ingests a 16-frame segment and answers ask(AC) and ask(FCC). Counted
   over the sessions alone, K6 and K8 must launch with w4a8_decode off
   (and K7, K9 not) and K7 and K9 with it on; K8 / K9 launches are also
   split into m = 1 (decode) and 1 < m <= 64 (question prefills), whose
   wall times are printed with the asks'. A third session runs
   w8a8_prefill: its segment prefill must take the W4A8 prefill branch
   (``torch._int_mm`` on the nibbles) and its question prefills K9. The
   w4a8_decode session asks once more with lookahead_k=4 (K8 / K9
   launches at m = 5, steps, tok/s).

With ``--profile`` it runs torch.profiler over one more ingest and three
asks (the last with lookahead_k=4) on the phase-5 session, and over one
more step of each training stage and QLoRA scheme in phase 7, and
prints each one's
device busy share and its kernels by device time.

It then prints the kernels JSON line, the card line, and last
``{"ok": true, "device": {...}}``. It runs on the first visible card
only. Without a CUDA device, or outside a checkout of the repository,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

KERNELS = [  # name, wrapper module, attribute, source, TPU kernel replaced
    ("K1_vision_attention", "cogstream_tpu_torch.ops.flash_attention",
     "flash_attention_packed_rope_fusedqkv",
     "cogstream_tpu_torch/csrc/vision_attention.cu",
     "cogstream_tpu/ops/flash_attention.py:333"),
    ("K2_layernorm", "cogstream_tpu_torch.ops.layernorm", "layernorm",
     "cogstream_tpu_torch/csrc/layernorm.cu",
     "cogstream_tpu/ops/layernorm.py:38"),
    ("K3_prefill_attention", "cogstream_tpu_torch.ops.lm_attention",
     "prefill_flash_attention", "cogstream_tpu_torch/csrc/lm_attention.cu",
     "cogstream_tpu/ops/lm_attention.py:121"),
    ("K4_decode_attention", "cogstream_tpu_torch.ops.lm_attention",
     "decode_attention", "cogstream_tpu_torch/csrc/lm_attention.cu",
     "cogstream_tpu/ops/lm_attention.py:316"),
    ("K5_segment_attention", "cogstream_tpu_torch.ops.flash_attention",
     "segment_flash_attention",
     "cogstream_tpu_torch/csrc/segment_attention.cu",
     "cogstream_tpu/ops/flash_attention.py:90"),
    ("K6_int4_gemv", "cogstream_tpu_torch.ops.quant_gemv", "gemv_k6",
     "cogstream_tpu_torch/csrc/quant_gemv_sm90.cu",
     "cogstream_tpu/ops/quant_gemv.py:112"),
    ("K7_int4_gemv_w4a8", "cogstream_tpu_torch.ops.quant_gemv", "gemv_k7",
     "cogstream_tpu_torch/csrc/int4_gemv.cu",
     "cogstream_tpu/ops/quant_gemv.py:148"),
    ("K8_int4_gemv_idx", "cogstream_tpu_torch.ops.quant_gemv", "gemv_k8",
     "cogstream_tpu_torch/csrc/int4_gemv_tc.cu",
     "cogstream_tpu/ops/quant_gemv.py:247"),
    ("K9_int4_gemv_idx_w4a8", "cogstream_tpu_torch.ops.quant_gemv",
     "gemv_k9", "cogstream_tpu_torch/csrc/int4_gemv_tc.cu",
     "cogstream_tpu/ops/quant_gemv.py:282"),
    # not a TPU kernel: the Hopper counterpart of the dequant XLA fuses
    # into the JAX package's int8 matmul
    ("K10_int8_gemv", "cogstream_tpu_torch.ops.int8_gemv", "gemv_k10",
     "cogstream_tpu_torch/csrc/quant_gemv_sm90.cu",
     "none (XLA fusion, cogstream_tpu/ops/quant.py:575)"),
]
BF16_PATH = range(0, 4)     # K1-K4: the bf16 main path (phase 5)
TC_PATH = (0, 2, 3)         # K1, K3, K4: bf16 on their tensor-core kernels
TRAIN_PATH = range(4, 5)    # K5: the training main path (phase 7)
INT4_PATH = range(5, 9)     # K6-K9: the int4 main path (phase 6)
INT8_PATH = range(9, 10)    # K10: the int8 main path (phase 10)
STACKED = (7, 8)            # K8, K9: counted by m regime too
# one NVIDIA H100 SXM (published datasheet figures): HBM bytes/s
# and dense peak operations/s by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def wrapper(i):
    import importlib

    return getattr(importlib.import_module(KERNELS[i][1]), KERNELS[i][2])


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n: int, replays: int = 5) -> float:
    """Device time of one ``fn`` call: ``n`` calls captured into one CUDA
    graph, replayed ``replays`` times between CUDA events. Unlike
    :func:`cuda_ms` it excludes the host's enqueue time, which exceeds
    the device time of a small kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * n)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: float, ops: float, kind: str = "bf16"):
    """The least time the card could take for work that moves ``n_bytes``
    (each input read once, each output written once) and does ``ops``
    operations on ``kind`` operands: the larger of the two times, and
    which one it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def segment_pairs(seg) -> int:
    """(query, key) pairs that see each other under segment ids (-1 =
    pad): sum over segments of L^2."""
    s = seg[seg >= 0].long()
    return int((s.bincount().double() ** 2).sum().item())


def visible_pairs(qpos, eff) -> int:
    """(query, slot) pairs with q_pos >= eff (the K3/K4 mask), per batch
    row 0."""
    import torch

    srt = eff[0].sort().values
    q = qpos[0]
    return int(torch.searchsorted(srt, q[q >= 0], right=True).sum().item())


def sdpa_ms(q, k, v, mask, iters: int) -> float:
    """Device time of one ``F.scaled_dot_product_attention`` call
    ([B, H, L, D] operands, boolean ``mask``: True = attend) on the
    memory-efficient backend, the library yardstick of the attention
    kernels; used nowhere in the port."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        return cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), iters)


def row_check(got, ref, width: int):
    """Largest |got - ref| and the worst ratio of a row's error to its
    bound, over rows of ``width`` elements (one head of one token, or one
    LayerNorm row). Both sides are f32 sums rounded once to bf16, so an
    element may differ by the f32 summation-order error (about 1e-6 of
    the row's largest |ref|) plus one bf16 rounding on each side: the
    bound is 2 bf16 ulps of the row's largest |ref|. Fully masked rows
    are 0 on both sides and must match exactly."""
    import torch

    g = got.float().reshape(-1, width)
    r = ref.float().reshape(-1, width)
    err = (g - r).abs().amax(1)
    row_max = r.abs().amax(1).clamp_min(1e-30)
    bound = 2 * torch.exp2(torch.floor(torch.log2(row_max)) - 7)
    return err.max().item(), (err / bound).max().item()


# the f32 routes' row rule: each row within this share of its own max
# |ref| (both sides are f32 sums over thousands of keys in other orders,
# whose means of unit-normal V cancel to a few hundredths; a wrong tile or
# a lost key moves a row by far more)
F32_ROW_TOL = 1e-4


def f32_row_check(got, ref, width: int):
    """row_check for f32 outputs: the largest |got - ref| and the worst
    ratio of a row's error to F32_ROW_TOL times its max |ref| (a fully
    masked row must match exactly)."""
    g = got.float().reshape(-1, width)
    r = ref.float().reshape(-1, width)
    err = (g - r).abs().amax(1)
    bound = F32_ROW_TOL * r.abs().amax(1).clamp_min(1e-30)
    return err.max().item(), (err / bound).max().item()


# K/V kinds of K3's and K4's tensor-core instances: the template argument
# KV (csrc/common.cuh DType), the element bytes, K3's (m-tiles, warps)
# instances (lm_attention_tc.cuh dispatch_prefill_tc), K3's byte stages
# of K and V rows (prefill_stages: f16 and f32 are narrowed in registers)
# and K4's warps
KV_KINDS = {"bf16": (1, 2, ((2, 4), (1, 4)), 0, 4),
            "e4m3": (2, 1, ((2, 8), (1, 8), (1, 4)), 2, 8),
            "e5m2": (3, 1, ((2, 8), (1, 8), (1, 4)), 2, 8),
            "f16": (4, 2, ((2, 8), (1, 8), (1, 4)), 0, 4),
            "f32": (0, 4, ((2, 8), (1, 8)), 0, 3)}


def _lm_label(kernel: str, kind: str, mt: int, warps: int = 0) -> str:
    tiles = f"{mt} m-tile{'s' if mt > 1 else ''}"
    tag = "" if kind == "bf16" else f" {kind}"
    if kernel == "K4" or kind == "bf16":
        return f"{kernel} tc{tag} <D=128, {tiles}>"
    return f"{kernel} tc{tag} <D=128, {tiles}, {warps} warps>"


# the tensor-core kernels by the (mangled) names of their instantiations
# on the main paths: K3 at D = 128 by its instances, K1 and K5 at D = 72
# (one body, with and without the rotation), K4 at D = 128 (1 m-tile for
# S <= 2, 2 for longer steps) and D = 64, each K3 / K4 over every K/V kind
# (KV_KINDS), K8 and K9 by their largest count of n8 row tiles (m <= 8,
# 16, 32, 64), as is the earlier K10 kernel (phase 3's yardstick); K6
# and K10 on their warpgroup-MMA kernel by variant and MMA width N
TC_KERNELS = {
    **{_lm_label("K3", kind, mt, w):
       f"gqa_prefill_tc_kernelILi128ELi{mt}ELi{w}ELi{code}EE"
       for kind, (code, _, k3, *_) in KV_KINDS.items() for mt, w in k3},
    **{_lm_label("K4", kind, mt):
       f"gqa_decode_tc_kernelILi128ELi{mt}ELi{nw}ELi{code}E"
       for kind, (code, *_, nw) in KV_KINDS.items() for mt in (1, 2)},
    "K1 tc <D=72, rope>": "segment_tc_kernelILi72ELb1E",
    "K5 tc <D=72>": "segment_tc_kernelILi72ELb0E",
    "K4 tc <D=64, 1 m-tile>": "gqa_decode_tc_kernelILi64ELi1ELi4ELi1E",
    "K4 tc <D=64, 2 m-tiles>": "gqa_decode_tc_kernelILi64ELi2ELi4ELi1E",
              "K8 tc <1 n-tile>": "int4_gemv_tc_kernelILi0ELi1E",
              "K8 tc <2 n-tiles>": "int4_gemv_tc_kernelILi0ELi2E",
              "K8 tc <4 n-tiles>": "int4_gemv_tc_kernelILi0ELi4E",
              "K8 tc <8 n-tiles>": "int4_gemv_tc_kernelILi0ELi8E",
              "K9 tc <1 n-tile>": "int4_gemv_tc_kernelILi2ELi1E",
              "K9 tc <2 n-tiles>": "int4_gemv_tc_kernelILi2ELi2E",
              "K9 tc <4 n-tiles>": "int4_gemv_tc_kernelILi2ELi4E",
              "K9 tc <8 n-tiles>": "int4_gemv_tc_kernelILi2ELi8E",
              "K10 before PR 16 <1 n-tile>": "int8_gemv_tc_kernelILi1E",
              "K10 before PR 16 <8 n-tiles>": "int8_gemv_tc_kernelILi8E",
              "K6 sm90 <uniform, N=8>": "quant_gemv_sm90_kernelILi0ELi8E",
              "K6 sm90 <cubic, N=8>": "quant_gemv_sm90_kernelILi1ELi8E",
              "K6 sm90 <uniform, N=64>": "quant_gemv_sm90_kernelILi0ELi64E",
              "K10 sm90 <N=8>": "quant_gemv_sm90_kernelILi3ELi8E",
              "K10 sm90 <N=40>": "quant_gemv_sm90_kernelILi3ELi40E",
              "K10 sm90 <N=64>": "quant_gemv_sm90_kernelILi3ELi64E"}


def lm_attention_smem(kv_len: int = 16384) -> dict:
    """Dynamic shared memory and threads of K3's and K4's tensor-core
    blocks at D = 128 as ``launch_prefill_tc`` / ``launch_decode_tc`` size
    them (csrc/lm_attention_tc.cuh), each K/V kind, by TC_KERNELS label:
    K3 keeps Q, two bf16 K and V tiles, for fp8 two stages of K and V
    rows in their own width, and the positions (two slots, three when
    staged); K4 Q, each warp's K and V tile (the cache's own rows: bf16
    or f16 padded, fp8 or f32 swizzled; overlaid by the warps' f32 merge)
    and the positions."""
    KS, BK, D = 136, 64, 128
    out = {}
    for kind, (_, eb, k3, stages, nw) in KV_KINDS.items():
        for mt, w3 in k3:
            br = 16 * mt * w3
            out[_lm_label("K3", kind, mt, w3)] = (
                br * KS * 2 + 4 * BK * KS * 2 + 2 * stages * BK * D * eb
                + ((3 if stages else 2) * BK + br + w3
                   + 2 * -(-kv_len // BK)) * 4, 32 * w3)
        # one K4 K (or V) tile: the cache's own rows (bf16, f16 padded)
        tile = BK * D * eb if eb != 2 else BK * KS * 2
        for mt in (2, 1):
            kv = max(2 * nw * tile, nw * 16 * mt * (D + 2) * 4)
            out[_lm_label("K4", kind, mt)] = (
                16 * mt * KS * 2 + kv + (nw * BK + 4) * 4, 32 * nw)
    return out


def blocks_per_sm(regs, smem: int, threads: int = 128):
    """Resident blocks of `threads` per H100 SM allowed by registers
    (allocated per warp in units of 256) and shared memory (228 KB an SM,
    1 KB reserved a block); None without a register count."""
    if regs is None:
        return None
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = 65536 // (per_warp * threads // 32)
    return min(by_regs, 233472 // (smem + 1024), 2048 // threads)


def lm_attention_usage(log: str) -> dict:
    """K3's and K4's tensor-core instances at D = 128 by TC_KERNELS
    label: ptxas registers and spill bytes from the build ``log``, shared
    memory and threads a block, and the blocks an SM holds."""
    usage = ptxas_usage(log, TC_KERNELS)
    out = {}
    for name, (smem, threads) in lm_attention_smem().items():
        use = usage.get(name, {})
        out[name] = {**use, "smem": smem, "threads": threads,
                     "blocks_per_sm": blocks_per_sm(use.get("registers"),
                                                    smem, threads)}
    return out


# the f32 tile's instances on the f32 routes' main shapes
# (csrc/f32_tile.cuh): K3's at head dim 128 (gqa_prefill_f32_kernel<DP,
# rows a block, narrow cache>) and K1's at D = 72 (padded to 80)
F32_TILE_KERNELS = {
    f"K3 f32 <D=128, {br} rows, {kind} cache>":
        f"gqa_prefill_f32_kernelILi128ELi{br}ELb{int(kind != 'f32')}E"
    for br in (128, 64) for kind in ("f32", "narrow")}
F32_TILE_KERNELS["K1 f32 <D=72>"] = "vision_attention_f32_kernelILi80E"


def f32_tile_usage(log: str) -> dict:
    """The f32 tile's instances (F32_TILE_KERNELS): ptxas registers and
    spill bytes from the build ``log``, shared memory and threads a block
    as the launches size them (Q, K, V and P tiles of rows padded to DP +
    4 floats, the rows' rescale factors and sums, the positions; K1 also
    a K tile's cos and sin rows), and the blocks an SM holds."""
    usage = ptxas_usage(log, F32_TILE_KERNELS)
    out = {}
    for name in F32_TILE_KERNELS:
        k1 = name.startswith("K1")
        dp, br = (80, 128) if k1 else (128, int(name.split(", ")[1][:-5]))
        floats = (br + 128) * (dp + 4) + 64 * (br + 4) + 2 * br
        smem = 4 * (floats + (2 * 64 * dp + br + 64 if k1
                              else br + 2 * 64 + 8))
        use = usage.get(name, {})
        out[name] = {**use, "smem": smem, "threads": 256,
                     "blocks_per_sm": blocks_per_sm(use.get("registers"),
                                                    smem, 256)}
    return out


def ptxas_usage(log: str, names: dict) -> dict:
    """Registers and spill bytes (stores, loads) that ``ptxas -v``
    reported in ``log`` for each kernel of ``names`` (label -> a part of
    its mangled name)."""
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            cur = next((k for k, n in names.items() if n in fn), None)
        elif cur and "spill stores" in line:
            out.setdefault(cur, {})["spill_bytes"] = [
                int(line.split(f"bytes spill {w}")[0].split(",")[-1])
                for w in ("stores", "loads")]
        elif cur and "Used" in line and "registers" in line:
            out.setdefault(cur, {})["registers"] = int(
                line.split("Used")[1].split("registers")[0])
    return out


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def check_kernels(dev):
    import torch
    import torch.nn.functional as F

    from cogstream_tpu_torch.models.vision_encoder import build_vision_metadata
    from cogstream_tpu_torch.ops import flash_attention as fa
    from cogstream_tpu_torch.ops import kernels
    from cogstream_tpu_torch.ops import layernorm as ln
    from cogstream_tpu_torch.ops import lm_attention as lma
    from cogstream_tpu_torch.ops.rope import (apply_vision_rope_cs,
                                              vision_rope_angles,
                                              vision_rope_cos_sin)

    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    results = []
    f32_results = []   # the redesigned f32 routes of K1 and K3

    def record(idx, err, ratio, ms, plain_ms, bound, library_ms):
        name = KERNELS[idx][0]
        lib = "none" if library_ms is None else f"{library_ms:.4f}"
        log(f"kernel {name}: max_abs_err={err:.6g}, worst row at {ratio:.3g}"
            f" of its bound (2 bf16 ulps of the row's max |ref|) "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib} "
            f"bound_ms={bound[0]:.4f} ({bound[1]})")
        if not ratio <= 1.0:
            raise AssertionError(f"{name} disagrees with its plain version")
        results.append({"name": name, "route": "cuda",
                        "source": KERNELS[idx][3],
                        "replaces": KERNELS[idx][4], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound[0], "bound_by": bound[1],
                        "library_ms": library_ms})

    def dev_t(a, dtype=None):
        return torch.as_tensor(a).to(dev, dtype)

    def heads_first(x):          # [N, H, D] -> [1, H, N, D]
        return x.transpose(0, 1).unsqueeze(0).contiguous()

    def block_diag(seg):
        return ((seg[:, None] == seg[None, :]) & (seg[:, None] >= 0))

    # K1: a 16-frame 24x42 segment bucketed to 16384 rows, and a ragged
    # batch whose frames straddle query tiles
    H, D = 16, 72
    k1_err, k1_ratio = [], []
    for grids in ([[16, 24, 42]], [[4, 24, 42], [3, 16, 30], [5, 10, 14]]):
        n_rows = sum(t * h * w for t, h, w in grids)
        meta = build_vision_metadata(np.array(grids),
                                     np.array([2] * len(grids)),
                                     pad_to=-(-n_rows // 1024) * 1024)
        N = meta.segment_ids.shape[0]
        qkv = dev_t(rng.standard_normal((N, 3 * H * D)), bf)
        c2, s2 = vision_rope_cos_sin(vision_rope_angles(
            dev_t(meta.pos_ids, torch.int32), D))
        args = (qkv, c2[:, 0].contiguous(), s2[:, 0].contiguous(),
                dev_t(meta.segment_ids, torch.int32))
        ranges = (dev_t(meta.kv_lo, torch.int32),
                  dev_t(meta.kv_hi, torch.int32))
        got = fa.flash_attention_packed_rope_fusedqkv(*args, *ranges, H)
        ref = fa.flash_attention_packed_rope_plain(*args, H, 1 / math.sqrt(D))
        err, ratio = row_check(got, ref, D)
        k1_err.append(err)
        k1_ratio.append(ratio)
        pad_zero = bool((got[args[3] < 0] == 0).all())
        log(f"kernel K1 case grids={grids}: N={N} max_abs_err={err:.6g}, "
            f"max |ref|={ref.float().abs().max().item():.4g}, worst row at "
            f"{ratio:.3g} of its bound; {int((args[3] < 0).sum())} pad "
            f"rows zero {pad_zero}")
        if not pad_zero:
            raise AssertionError("K1 pad rows are not zero")
        if len(k1_err) == 1:   # time the main path's 16x24x42 segment
            k1_ms = cuda_ms(lambda: fa.flash_attention_packed_rope_fusedqkv(
                *args, *ranges, H), 20)
            k1_plain_ms = cuda_ms(lambda: fa.flash_attention_packed_rope_plain(
                *args, H, 1 / math.sqrt(D)), 2)
            qkv32 = qkv.float()
            got32 = fa.flash_attention_packed_rope_fusedqkv(
                qkv32, *args[1:], *ranges, H)
            k1_f32_ms = cuda_ms(lambda: fa.flash_attention_packed_rope_fusedqkv(
                qkv32, *args[1:], *ranges, H), 5)
            seg = args[3]
            b32 = bound_ms(nbytes(qkv32, *args[1:], *ranges) + 4 * got.numel(),
                           4 * H * D * segment_pairs(seg), "f32")
            # the f32 route's yardsticks on its f32 values: the plain
            # version once (its output the reference), SDPA on the
            # rotated f32 q / k
            ref32 = []
            f32_plain = cuda_ms(lambda: ref32.append(
                fa.flash_attention_packed_rope_plain(
                    qkv32, *args[1:], H, 1 / math.sqrt(D))), 1, warmup=0)
            err32, ratio32 = f32_row_check(got32, ref32[0], D)
            pad32 = bool((got32[seg < 0] == 0).all())
            q, k, v = qkv32.reshape(N, 3, H, D).unbind(1)
            f32_lib = sdpa_ms(heads_first(apply_vision_rope_cs(q, c2, s2)),
                              heads_first(apply_vision_rope_cs(k, c2, s2)),
                              heads_first(v), block_diag(seg), 2)
            log(f"kernel K1 routes at N={N}: tensor-core tile (bf16) "
                f"{k1_ms:.4f} ms, f32 tile (f32, same values) "
                f"{k1_f32_ms:.4f} ms, its bound {b32[0]:.4f} ms ({b32[1]}, "
                f"f32 peak), its plain version {f32_plain:.4f} ms, library "
                f"(f32) {f32_lib:.4f} ms; f32 route max_abs_err={err32:.6g},"
                f" worst row at {ratio32:.3g} of its bound ({F32_ROW_TOL:g} "
                f"of the row's max |ref|), pad rows zero {pad32}")
            if not (ratio32 <= 1.0 and pad32):
                raise AssertionError("K1's f32 route disagrees with its "
                                     "plain version")
            f32_results.append({
                "name": "K1_vision_attention_f32", "route": "cuda",
                "source": "cogstream_tpu_torch/csrc/vision_attention.cu",
                "replaces": KERNELS[0][4], "max_abs_err": err32,
                "ms": k1_f32_ms, "plain_ms": f32_plain, "bound_ms": b32[0],
                "bound_by": b32[1], "library_ms": f32_lib})
            del qkv32, q, k, v, got32, ref32
            k1_bound = bound_ms(nbytes(*args, *ranges, got),
                                4 * H * D * segment_pairs(seg))
            # library yardstick: SDPA on the already-rotated q/k (no
            # PyTorch call fuses the rotation)
            q, k, v = qkv.reshape(N, 3, H, D).unbind(1)
            q = apply_vision_rope_cs(q, c2, s2)
            k = apply_vision_rope_cs(k, c2, s2)
            k1_lib = sdpa_ms(heads_first(q), heads_first(k), heads_first(v),
                             block_diag(seg), 10)
            del q, k, v
    record(0, max(k1_err), max(k1_ratio), k1_ms, k1_plain_ms, k1_bound,
           k1_lib)

    # K2: the tower's LayerNorm at the encode bucket
    x = dev_t(rng.standard_normal((16384, 1152)) * 2 + 0.5, bf)
    sc = dev_t(rng.standard_normal(1152), torch.float32)
    b = dev_t(rng.standard_normal(1152), torch.float32)
    got = ln.layernorm(x, sc, b, 1e-6)
    ref = ln.layernorm_plain(x, sc, b, 1e-6)
    scb, bb = sc.to(bf), b.to(bf)
    record(1, *row_check(got, ref, 1152),
           cuda_ms(lambda: ln.layernorm(x, sc, b, 1e-6), 20),
           cuda_ms(lambda: ln.layernorm_plain(x, sc, b, 1e-6), 5),
           bound_ms(nbytes(x, sc, b, got), 8 * x.numel(), "f32"),
           cuda_ms(lambda: F.layer_norm(x, (1152,), scb, bb, 1e-6), 20))

    # K3: the second ingest's prefill — 4384 tokens (positions 4607..)
    # into a 16384-slot cache holding 4607 history slots — with position
    # holes and kv_allowed
    T, Hq, Hkv, Dl, hist, S = 16384, 28, 4, 128, 4607, 4384
    k = dev_t(rng.standard_normal((1, T, Hkv, Dl)), bf)
    v = dev_t(rng.standard_normal((1, T, Hkv, Dl)), bf)
    q = dev_t(rng.standard_normal((1, S, Hq, Dl)), bf)
    pos = np.full((1, T), -1, np.int32)
    pos[0, :hist + S] = np.arange(hist + S)
    pos[0, rng.choice(hist, 300, replace=False)] = -1
    allowed = rng.random((1, T)) > 0.3
    allowed[0, hist:] = True
    qpos = np.full((1, S), -1, np.int32)
    qpos[0, :S - 20] = hist + np.arange(S - 20)
    eff = lma.effective_kv_positions(dev_t(pos, torch.int32),
                                     dev_t(allowed, torch.bool))
    qp = dev_t(qpos, torch.int32)
    # unit-normal q/k/v at D=128 give logits of about N(0, 1), so a row
    # averaging ~4.6k-9k visible slots has |o| of a few hundredths: the
    # bound scales with each row's own max |ref|, not a fixed atol
    got = lma.prefill_flash_attention(q, k, v, qp, eff)
    ref = lma.gqa_attention_plain(q, k, v, qp, eff)
    # bytes: the K/V rows visible to some query (the rest are never read)
    seen = int((eff[0] < lma.SENTINEL).sum().item())
    kv_row = Hkv * Dl * 2
    k3_bound = bound_ms(nbytes(q, qp, eff, got) + 2 * seen * kv_row,
                        4 * Hq * Dl * visible_pairs(qp, eff))

    def sdpa_operands(qq, kk, vv, qpos_t, eff_t):
        g = Hq // Hkv
        mask = (qpos_t[0][:, None] >= eff_t[0][None, :])
        return (qq[0].transpose(0, 1).unsqueeze(0).contiguous(),
                kk[0, :eff_t.shape[1]].repeat_interleave(g, 1).transpose(
                    0, 1).unsqueeze(0).contiguous(),
                vv[0, :eff_t.shape[1]].repeat_interleave(g, 1).transpose(
                    0, 1).unsqueeze(0).contiguous(), mask)

    k3_lib = sdpa_ms(*sdpa_operands(q, k, v, qp, eff), 10)
    k3_ms = cuda_ms(lambda: lma.prefill_flash_attention(q, k, v, qp, eff), 10)
    q32, k32, v32 = q.float(), k.float(), v.float()
    got32 = lma.prefill_flash_attention(q32, k32, v32, qp, eff)
    k3_f32_ms = cuda_ms(lambda: lma.prefill_flash_attention(
        q32, k32, v32, qp, eff), 5)
    b32 = bound_ms(nbytes(q32, qp, eff) + 4 * got.numel() + 4 * seen * kv_row,
                   4 * Hq * Dl * visible_pairs(qp, eff), "f32")
    ref32 = []   # the plain version's output, from its timed call
    f32_plain = cuda_ms(lambda: ref32.append(lma.gqa_attention_plain(
        q32, k32, v32, qp, eff)), 1, warmup=0)
    err32, ratio32 = f32_row_check(got32, ref32[0], Dl)
    f32_lib = sdpa_ms(*sdpa_operands(q32, k32, v32, qp, eff), 3)
    pad_zero = bool((got[0, S - 20:] == 0).all())
    pad32 = bool((got32[0, S - 20:] == 0).all())
    log(f"kernel K3 routes at S={S}: tensor-core tile (bf16) {k3_ms:.4f} ms,"
        f" f32 tile (f32, same values) {k3_f32_ms:.4f} ms (its bound "
        f"{b32[0]:.4f} ms, {b32[1]}, f32 peak; its plain version "
        f"{f32_plain:.4f} ms, library (f32) {f32_lib:.4f} ms), library "
        f"{k3_lib:.4f} ms; 20 padded query rows zero {pad_zero}; f32 route "
        f"max_abs_err={err32:.6g}, worst row at {ratio32:.3g} of its bound "
        f"({F32_ROW_TOL:g} of the row's max |ref|), padded rows zero "
        f"{pad32}")
    if not pad_zero:
        raise AssertionError("K3 padded query rows are not zero")
    if not (ratio32 <= 1.0 and pad32):
        raise AssertionError("K3's f32 route disagrees with its plain "
                             "version")
    if not k3_f32_ms < f32_lib:
        raise AssertionError(f"K3's f32 route ({k3_f32_ms:.4f} ms) is not "
                             f"faster than the library call in f32 "
                             f"({f32_lib:.4f} ms)")
    f32_results.append({
        "name": "K3_prefill_attention_f32", "route": "cuda",
        "source": "cogstream_tpu_torch/csrc/lm_attention_f32q.cu",
        "replaces": KERNELS[2][4], "max_abs_err": err32, "ms": k3_f32_ms,
        "plain_ms": f32_plain, "bound_ms": b32[0], "bound_by": b32[1],
        "library_ms": f32_lib})
    del got32, ref32
    record(2, *row_check(got, ref, Dl), k3_ms,
           cuda_ms(lambda: lma.gqa_attention_plain(q, k, v, qp, eff), 1),
           k3_bound, k3_lib)
    if not k3_ms < k3_lib:
        raise AssertionError(f"K3 ({k3_ms:.4f} ms) is not faster than the "
                             f"library call ({k3_lib:.4f} ms)")

    # K3 at a question prefill: 32 tokens over a 9216-slot window holding
    # 9000 history slots — a grid of 8-16 blocks, fewer than the SMs
    Sq, Wq, fill = 32, 9216, 9000
    qq = dev_t(rng.standard_normal((1, Sq, Hq, Dl)), bf)
    pos = np.full((1, T), -1, np.int32)
    pos[0, :fill + Sq] = np.arange(fill + Sq)
    pos[0, rng.choice(fill, 300, replace=False)] = -1
    effq = lma.effective_kv_positions(
        dev_t(pos, torch.int32), dev_t(allowed, torch.bool))[:, :Wq]
    effq = effq.contiguous()
    qpq = dev_t(np.arange(fill, fill + Sq, dtype=np.int32)[None])
    gotq = lma.prefill_flash_attention(qq, k, v, qpq, effq)
    errq, ratioq = row_check(gotq, lma.gqa_attention_plain(qq, k, v, qpq,
                                                           effq), Dl)
    qq32 = qq.float()
    q_ms = cuda_ms(lambda: lma.prefill_flash_attention(qq, k, v, qpq, effq),
                   20)
    q_f32_ms = cuda_ms(lambda: lma.prefill_flash_attention(
        qq32, k32, v32, qpq, effq), 10)
    errq32, ratioq32 = f32_row_check(
        lma.prefill_flash_attention(qq32, k32, v32, qpq, effq),
        lma.gqa_attention_plain(qq32, k32, v32, qpq, effq), Dl)
    q_rows = lma.prefill_f32_rows(Sq * (Hq // Hkv), 1, Hkv,
                                  kernels.sm_count(dev))
    q_lib = sdpa_ms(*sdpa_operands(qq, k, v, qpq, effq), 20)
    log(f"kernel K3 question prefill S={Sq} over a {Wq}-slot window ({fill}"
        f" history slots): max_abs_err={errq:.6g}, worst row at "
        f"{ratioq:.3g} of its bound; tensor-core tile (bf16) {q_ms:.4f} ms, "
        f"f32 tile (f32, same values, {q_rows} rows a block) "
        f"{q_f32_ms:.4f} ms, max_abs_err={errq32:.6g}, worst row at "
        f"{ratioq32:.3g} of its bound; library {q_lib:.4f} ms")
    if not ratioq <= 1.0 or not q_ms < q_f32_ms or not ratioq32 <= 1.0:
        raise AssertionError("K3 at the question prefill disagrees with its "
                             "plain version or is slower than the f32 route")
    del q32, k32, v32, qq32

    # K4: one decode step over a 9216-slot window holding 9000 slots, on
    # the tensor-core kernel (one launch); times from CUDA graphs, since
    # the host's enqueue exceeds the kernel's device time
    W, fill = 9216, 9000
    q1 = dev_t(rng.standard_normal((1, 1, Hq, Dl)), bf)
    pos = np.full((1, T), -1, np.int32)
    pos[0, :fill + 1] = np.arange(fill + 1)
    pos[0, rng.choice(fill, 300, replace=False)] = -1
    eff = lma.effective_kv_positions(dev_t(pos, torch.int32),
                                     dev_t(allowed, torch.bool))[:, :W]
    eff = eff.contiguous()
    qp = dev_t([[fill]], torch.int32)
    t0 = lma.decode_attention.tc_launches
    got = lma.decode_attention(q1, k, v, qp, eff)
    if lma.decode_attention.tc_launches != t0 + 1:
        raise AssertionError("K4 bf16 did not run the tensor-core kernel")
    ref = lma.gqa_attention_plain(q1, k, v, qp, eff)
    seen = int((eff[0] < lma.SENTINEL).sum().item())
    k4_bound = bound_ms(nbytes(q1, qp, eff, got) + 2 * seen * kv_row,
                        4 * Hq * Dl * visible_pairs(qp, eff))
    k4_lib = sdpa_ms(*sdpa_operands(q1, k, v, qp, eff), 50)
    k4_ms = graph_ms(lambda: lma.decode_attention(q1, k, v, qp, eff), 50)
    q1_32, k32, v32 = q1.float(), k.float(), v.float()
    k4_f32_ms = graph_ms(lambda: lma.decode_attention(q1_32, k32, v32, qp,
                                                      eff), 20)
    b32 = bound_ms(nbytes(q1_32, qp, eff) + 4 * got.numel()
                   + 4 * seen * kv_row,
                   4 * Hq * Dl * visible_pairs(qp, eff), "f32")
    k4_f32_plain = cuda_ms(lambda: lma.gqa_attention_plain(q1_32, k32, v32,
                                                           qp, eff), 1,
                           warmup=0)
    k4_f32_lib = sdpa_ms(*sdpa_operands(q1_32, k32, v32, qp, eff), 20)
    del k32, v32
    # capture: one call in a graph, replayed after q and eff are rewritten
    # in place, against the eager call on the new values
    qr, effr = q1.clone(), eff.clone()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out_g = lma.decode_attention(qr, k, v, qp, effr)
    qr.copy_(dev_t(rng.standard_normal((1, 1, Hq, Dl)), bf))
    effr[0, rng.choice(fill, 500, replace=False)] = lma.SENTINEL
    g.replay()
    torch.cuda.synchronize()
    replay_equal = bool(torch.equal(out_g, lma.decode_attention(
        qr, k, v, qp, effr)))
    repeat_equal = bool(torch.equal(got, lma.decode_attention(
        q1, k, v, qp, eff)))
    log(f"kernel K4 routes over a {W}-slot window: tensor-core kernel "
        f"(bf16, one launch) {k4_ms:.4f} ms, CUDA-core tile + combine (f32,"
        f" same values) {k4_f32_ms:.4f} ms (its bound {b32[0]:.4f} ms, "
        f"{b32[1]}, f32 peak; its plain version {k4_f32_plain:.4f} ms, "
        f"library (f32) {k4_f32_lib:.4f} ms), library {k4_lib:.4f} ms (graph"
        f" ms for both routes); two calls bit-identical {repeat_equal}; "
        f"graph replay after q / eff rewritten equals the eager call "
        f"{replay_equal}")
    record(3, *row_check(got, ref, Dl), k4_ms,
           cuda_ms(lambda: lma.gqa_attention_plain(q1, k, v, qp, eff), 5),
           k4_bound, k4_lib)
    if not (replay_equal and repeat_equal):
        raise AssertionError("K4 is not deterministic or its graph replay "
                             "differs from the eager call")
    if not k4_ms < k4_lib:
        raise AssertionError(f"K4 ({k4_ms:.4f} ms) is not faster than the "
                             f"library call ({k4_lib:.4f} ms)")
    # K4 at a verify step (S = 8: 56 folded rows, 2 m-tiles per warp in 2
    # row groups) with a padded query, against its plain version
    q8 = dev_t(rng.standard_normal((1, 8, Hq, Dl)), bf)
    qp8 = dev_t([[fill - 7 + i for i in range(7)] + [-1]], torch.int32)
    got8 = lma.decode_attention(q8, k, v, qp8, eff)
    err8, ratio8 = row_check(got8, lma.gqa_attention_plain(q8, k, v, qp8,
                                                           eff), Dl)
    k4_8_ms = graph_ms(lambda: lma.decode_attention(q8, k, v, qp8, eff), 20)
    pad8 = bool((got8[0, 7] == 0).all())
    log(f"kernel K4 verify step S=8: max_abs_err={err8:.6g}, worst row at "
        f"{ratio8:.3g} of its bound; padded query zero {pad8}; "
        f"{k4_8_ms:.4f} ms")
    if not ratio8 <= 1.0 or not pad8:
        raise AssertionError("K4 at S=8 disagrees with its plain version")
    # lookahead verify steps: S = k+1 queries at consecutive positions
    # after the 9000 history slots, their own slots live (each sees the
    # step's slots up to its own): K4 at S = 5 and 8 (k = 4, 7), K3 at S =
    # 9 (k = 8, past DECODE_MAX_S), beside the S = 1 step above
    verify = {"S=1": {"kernel": "K4", "ms": k4_ms, "bound_ms": k4_bound[0],
                      "bound_by": k4_bound[1]}}
    for Sv in (5, 8, 9):
        pos = np.full((1, T), -1, np.int32)
        pos[0, :fill + Sv] = np.arange(fill + Sv)
        pos[0, rng.choice(fill, 300, replace=False)] = -1
        effv = lma.effective_kv_positions(dev_t(pos, torch.int32),
                                          dev_t(allowed, torch.bool))
        effv = effv[:, :W].contiguous()
        qv = dev_t(rng.standard_normal((1, Sv, Hq, Dl)), bf)
        qpv = dev_t(np.arange(fill, fill + Sv)[None], torch.int32)
        k4_route = Sv <= lma.DECODE_MAX_S
        fn = lma.decode_attention if k4_route else lma.prefill_flash_attention
        t0 = fn.tc_launches
        gotv = fn(qv, k, v, qpv, effv)
        on_tc = fn.tc_launches == t0 + 1
        errv, ratiov = row_check(gotv, lma.gqa_attention_plain(
            qv, k, v, qpv, effv), Dl)
        # K4 from a CUDA graph (capture-safe); K3 allocates its tile
        # metadata per call, so it is event-timed (host enqueue included)
        msv = (graph_ms(lambda: fn(qv, k, v, qpv, effv), 20) if k4_route
               else cuda_ms(lambda: fn(qv, k, v, qpv, effv), 20))
        seen = int((effv[0] < lma.SENTINEL).sum().item())
        bv = bound_ms(nbytes(qv, qpv, effv, gotv) + 2 * seen * kv_row,
                      4 * Hq * Dl * visible_pairs(qpv, effv))
        name = "K4" if k4_route else "K3"
        verify[f"S={Sv}"] = {"kernel": name, "ms": msv, "bound_ms": bv[0],
                             "bound_by": bv[1], "max_abs_err": errv}
        log(f"kernel {name} verify step S={Sv} (lookahead k={Sv - 1}) over "
            f"a {W}-slot window: max_abs_err={errv:.6g}, worst row at "
            f"{ratiov:.3g} of its bound; tensor-core kernel {on_tc}; "
            f"{msv:.4f} ms ({'graph' if k4_route else 'event'} ms), bound "
            f"{bv[0]:.4f} ms ({bv[1]}); S=1: {k4_ms:.4f} ms, bound "
            f"{k4_bound[0]:.4f} ms")
        if not ratiov <= 1.0 or not on_tc:
            raise AssertionError(f"{name} at the verify step S={Sv} "
                                 "disagrees with its plain version")
    del k, v, q, q1, q8, got, ref

    # K5: the training tower's head-major attention — 16 aligned frames
    # of 1008 tokens (8 frames of 24x42 patches merge 2 is the stage-2
    # turn; 16 the tower's segment bucket), and a ragged batch with a
    # padded tail; bf16 [16128, 16, 72]
    k5_err, k5_ratio = [], []
    for lengths, pad in (([1008] * 16, 0), ([1008, 700, 333, 1008, 64], 111)):
        seg = dev_t(np.concatenate([np.full(L, i, np.int32) for i, L in
                                    enumerate(lengths)]
                                   + [np.full(pad, -1, np.int32)]))
        N = seg.shape[0]
        q, k, v = (dev_t(rng.standard_normal((N, H, D)), bf)
                   for _ in range(3))
        ranges = tuple(dev_t(r) for r in fa.vision_kv_ranges(
            seg.cpu().numpy()))
        with torch.no_grad():
            got = fa.segment_flash_attention(q, k, v, seg, ranges)
        ref = fa.segment_flash_attention_plain(q, k, v, seg, 1 / math.sqrt(D))
        err, ratio = row_check(got, ref, D)
        k5_err.append(err)
        k5_ratio.append(ratio)
        log(f"kernel K5 case lengths={lengths} pad={pad}: N={N} "
            f"max_abs_err={err:.6g}, max |ref|="
            f"{ref.float().abs().max().item():.4g}, worst row at "
            f"{ratio:.3g} of its bound; pad rows zero "
            f"{bool((got[N - pad:] == 0).all())}")
        if pad and not bool((got[N - pad:] == 0).all()):
            raise AssertionError("K5 pad rows are not zero")
        if len(k5_err) == 1:   # time the aligned 16-frame case
            wrap = fa.segment_flash_attention
            with torch.no_grad():
                k5_ms = graph_ms(lambda: wrap(q, k, v, seg, ranges), 5)
                q32, k32, v32 = q.float(), k.float(), v.float()
                k5_f32_ms = cuda_ms(lambda: wrap(q32, k32, v32, seg, ranges),
                                    3)
                b32 = bound_ms(nbytes(q32, k32, v32, seg, *ranges)
                               + 4 * got.numel(),
                               4 * H * D * segment_pairs(seg), "f32")
                k5_f32_plain = cuda_ms(
                    lambda: fa.segment_flash_attention_plain(
                        q32, k32, v32, seg, 1 / math.sqrt(D)), 1, warmup=0)
                k5_f32_lib = sdpa_ms(heads_first(q32), heads_first(k32),
                                     heads_first(v32), block_diag(seg), 2)
                del q32, k32, v32
            k5_plain_ms = cuda_ms(lambda: fa.segment_flash_attention_plain(
                q, k, v, seg, 1 / math.sqrt(D)), 2)
            k5_bound = bound_ms(nbytes(q, k, v, seg, *ranges, got),
                                4 * H * D * segment_pairs(seg))
            k5_lib = sdpa_ms(heads_first(q), heads_first(k), heads_first(v),
                             block_diag(seg), 5)
            log(f"kernel K5 routes at N={N}: tensor-core tile (bf16, graph "
                f"ms) {k5_ms:.4f} ms, CUDA-core tile (f32, same values) "
                f"{k5_f32_ms:.4f} ms (its bound {b32[0]:.4f} ms, {b32[1]}, "
                f"f32 peak; its plain version {k5_f32_plain:.4f} ms, library "
                f"(f32) {k5_f32_lib:.4f} ms), library {k5_lib:.4f} ms")
    record(4, max(k5_err), max(k5_ratio), k5_ms, k5_plain_ms, k5_bound,
           k5_lib)
    if not k5_ms < k5_lib:
        raise AssertionError(f"K5 ({k5_ms:.4f} ms) is not faster than the "
                             f"library call ({k5_lib:.4f} ms)")
    return results, verify, f32_results


LIB_INT4 = {}   # K6 / K8: torch._weight_int4pack_mm (ms, note)


def _int4_store(rng, dev, shape, cubic=False):
    """Random rank-1 int4 storage [L,] din/2, dout on the card (every
    byte value occurs; scales of the magnitude a real fit gives)."""
    import torch

    from cogstream_tpu_torch.ops.quant import CUBIC_A, CUBIC_C

    *lead, half, dout = shape
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    q4 = torch.randint(-128, 128, shape, dtype=torch.int8, device=dev,
                       generator=gen)
    scale = torch.rand((*lead, dout), device=dev, generator=gen) * 0.03 + 0.01
    rscale = torch.rand((*lead, 2 * half), device=dev, generator=gen) + 0.5
    code = torch.tensor([CUBIC_A, CUBIC_C] if cubic else [1.0 / 7.0],
                        device=dev).expand(*lead, -1).contiguous()
    return {"q4": q4, "scale": scale, "rscale": rscale, "code": code}


def _cuda_core_stacked(variant, x, sx, qp, layer):
    """One stacked call on the CUDA-core kernel (``cs_int4_gemv``, K6 /
    K7's, which K8 / K9 ran before the tensor-core kernel), bf16 out: the
    yardstick beside the tensor-core kernel; used nowhere in the port."""
    import torch

    from cogstream_tpu_torch.ops import kernels
    from cogstream_tpu_torch.ops import quant_gemv as qg

    L, half, dout = qp["q4"].shape
    m = x.shape[0]
    mt = 1 if m == 1 else 4 if variant == qg.W4A8 else 8
    rows, splits = qg._splits(x.device, -(-m // mt) * -(-dout // qg._BN),
                              half)
    part = None
    if splits > 1:
        part = torch.empty((splits * (2 if variant == qg.W4A8 else 1), m,
                            dout), dtype=torch.int32 if variant == qg.W4A8
                           else torch.float32, device=x.device)
    out = torch.empty((m, dout), dtype=torch.bfloat16, device=x.device)
    kernels.check(kernels.library().cs_int4_gemv(
        x.data_ptr(), None if sx is None else sx.data_ptr(),
        qp["q4"].data_ptr(), half * dout, qp["scale"].data_ptr(), dout,
        layer.data_ptr(), None, out.data_ptr(),
        None if part is None else part.data_ptr(), m, half, dout, rows,
        splits, variant, kernels.dtype_code(out), kernels.stream_ptr(x)),
        "cs_int4_gemv")
    return out


def _int4pack(q4, sc, group: int = 128):
    """A rank-1 uniform int4 store's nibbles (one layer, split halves
    ``[din/2, dout]``) and its column scales folded with the codebook
    (``sc = scale / 7``) in ``torch._weight_int4pack_mm``'s form: unsigned
    nibbles ``s + 8`` packed by ``torch._convert_weight_to_int4pack``, one
    (scale, zero = 0) pair a column for every group of ``group`` rows.
    Its dequantization ``(q - 8) * scale + zero`` is the store's ``s *
    sc``, so with the rscale folded into the activations (as the K6 / K8
    launchers fold it) the call computes the same function, its scales
    rounded to bf16."""
    import torch

    from cogstream_tpu_torch.ops.quant import _unpack_halves

    lo, hi = _unpack_halves(q4)
    w = (torch.cat([lo, hi]) + 8).to(torch.uint8).t().contiguous()
    packed = ((w[:, ::2] << 4) | w[:, 1::2]).contiguous()
    wp = torch._convert_weight_to_int4pack(packed, 8)
    din, dout = w.shape[1], w.shape[0]
    sz = torch.zeros((din // group, dout, 2), dtype=torch.bfloat16,
                     device=q4.device)
    sz[..., 0] = sc.to(torch.bfloat16)[None]
    return wp, sz, group


def _int4pack_ms(xb, packs, n: int, ref, ref_layer: int = 0):
    """Device ms of ``torch._weight_int4pack_mm`` on the same values (the
    library yardstick of K6 / K8, used nowhere in the port), cycling over
    ``packs`` (one (weight, scales, group) per layer) as the stacked
    kernel cycles over its layers; and its worst row error against the
    kernel's output ``ref`` on layer ``ref_layer`` (of that row's max).
    (None, why) where the card's build has no such kernel."""
    import torch

    it = iter(range(10 ** 9))

    def call():
        wp, sz, g = packs[next(it) % len(packs)]
        return torch._weight_int4pack_mm(xb, wp, g, sz)

    try:
        wp, sz, g = packs[ref_layer]
        y = torch._weight_int4pack_mm(xb, wp, g, sz).float()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        return None, str(e).splitlines()[0][:120]
    r = ref.float()
    err = float(((y - r).abs().amax(-1)
                 / r.abs().amax(-1).clamp(min=1e-30)).max())
    if not err <= 2e-2:       # bf16 scales round by 2^-9: a far miss is
        return None, f"a different function (worst row error {err:.3g})"
    return graph_ms(call, n), f"worst row error {err:.3g} of its max"


def sass_conversions() -> dict:
    """Int-to-float conversions (I2F, I2FP) and byte permutes in the SASS
    of the int4 GEMV kernels of the built library, by kernel: the CUDA-core
    kernel K6 ran before PR 16 (``int4_gemv_kernel``, uniform and cubic at
    one row) and its replacement (``quant_gemv_sm90_kernel``, N = 8).
    ``cuobjdump`` comes with the CUDA toolkit; without it, {}."""
    import re

    from cogstream_tpu_torch.ops import kernels

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(kernels.build())],
                          capture_output=True, text=True).stdout
    names = {"K6 before PR 16, uniform": "int4_gemv_kernelILi0ELi1E",
             "K6 before PR 16, cubic": "int4_gemv_kernelILi1ELi1E",
             "K6 sm90, uniform": "quant_gemv_sm90_kernelILi0ELi8E",
             "K6 sm90, cubic": "quant_gemv_sm90_kernelILi1ELi8E"}
    out, cur = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            cur = next((k for k, n in names.items() if n in fn.group(1)
                        and k not in out), None)
            if cur:
                out[cur] = {"I2F": 0, "PRMT": 0, "HFMA2": 0, "LOP3": 0}
            continue
        if cur:
            for op in re.findall(r"\b(I2FP?|PRMT|HFMA2|LOP3)\b", line):
                out[cur]["I2F" if op.startswith("I2F") else op] += 1
    return out


def _k6_before(cubic, xb, q4, sc, code):
    """One 2D call on the CUDA-core kernel K6 ran before PR 16
    (``cs_int4_gemv``, now K7's), bf16 out: phase 3's yardstick of the new
    K6 on the same operands; used nowhere in the port."""
    from cogstream_tpu_torch.ops import quant_gemv as qg

    return qg._launch(qg.CUBIC if cubic else qg.UNIFORM, xb, None, q4, sc,
                      code, xb.dtype)


def _graph_replay_equal(call, x, fresh):
    """One ``call()`` captured in a CUDA graph, replayed after ``x`` was
    rewritten in place with ``fresh``: equal bit for bit to the eager call
    on the new values."""
    import torch

    call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = call()
    x.copy_(fresh)
    g.replay()
    torch.cuda.synchronize()
    return bool(torch.equal(out, call()))


def check_int4_kernels(dev):
    """K6 (uniform and cubic) and K7 on the 7B lm_head (3584 -> 152064,
    m = 1; K6 also at m = 5, the lookahead verify, and on a vocab shard
    [1792, 76032]), K6 beside the CUDA-core kernel it ran before PR 16 and
    ``torch._weight_int4pack_mm``, called twice (bit-identical) and
    replayed from a CUDA graph (equal to the eager call); K8 and K9 on
    stacked gate_proj [28, 1792, 18944] at m = 1, 40
    and 64 and down_proj [28, 9472, 3584] at m = 1, layer 17, each also
    timed on the CUDA-core kernel and called twice (bit-identical). Each
    wrapper
    against its plain version on the same card, bf16 in and out, with
    the per-row bound of phase 3. Kernel and plain ms: device time of
    the launcher alone (and of the plain version) on prepared operands,
    from CUDA graphs; stacked sites cycle over all 28 layers so every
    launch reads its weights from device memory, as a decode step does.
    Wrapper ms: CUDA events around the whole wrapper, activation
    preparation (rscale fold, bf16 rounding or int8 quantization) and the
    host's enqueue time included."""
    import torch

    from cogstream_tpu_torch.ops import quant_gemv as qg
    from cogstream_tpu_torch.ops.quant import CUBIC_A, CUBIC_C

    rng = np.random.default_rng(1)
    bf = torch.bfloat16

    # 2D: the lm_head, uniform and cubic codebooks
    head_u = _int4_store(rng, dev, (1792, 152064))
    head_c = {**head_u, "code": torch.tensor([CUBIC_A, CUBIC_C], device=dev)}
    x1 = torch.as_tensor(rng.standard_normal((1, 3584))).to(dev, bf)
    lines = []
    for conv, found in sass_conversions().items():
        log(f"kernel K6 SASS, {conv} (per kernel body): {found}")
    cases = [("K6", head_u, False, 1), ("K6_cubic", head_c, False, 1),
             ("K7", head_u, True, 1), ("K6", head_u, False, 5),
             ("K6_cubic", head_c, False, 5)]
    for key, qp, w4a8, m in cases:
        x1 = torch.as_tensor(rng.standard_normal((m, 3584))).to(dev, bf)
        got = qg.int4_rank1_gemv(x1, qp, bf, w4a8=w4a8)
        ref = qg.int4_rank1_gemv_plain(x1, qp, bf, w4a8=w4a8)
        err, ratio = row_check(got, ref, 152064)
        xs = x1.float() * qp["rscale"][None]
        sc = qp["scale"] * qp["code"][0] if key != "K6_cubic" else qp["scale"]
        extra = ""
        if w4a8:
            xq, sx = qg._int8_halves(xs, 1792)
            ms = graph_ms(lambda: qg.gemv_k7(xq, sx, qp["q4"], sc, bf), 20)
            plain_ms = graph_ms(lambda: qg._plain_w4a8(xq, sx, qp["q4"], sc,
                                                       bf), 3)
        else:
            xb = xs.to(bf)
            code = qp["code"] if key == "K6_cubic" else torch.cat(
                [qp["code"], qp["code"].new_zeros(1)])
            cubic = key == "K6_cubic"
            call = (lambda: qg.gemv_k6(xb, qp["q4"], sc, code, cubic, bf))
            same = bool(torch.equal(call(), call()))
            replay = _graph_replay_equal(call, xb, (torch.as_tensor(
                rng.standard_normal((m, 3584))).to(dev) * xs.std()).to(bf))
            if not same or not replay:
                raise AssertionError(f"{key} m={m}: two calls equal {same}, "
                                     f"graph replay equal {replay}")
            ms = graph_ms(call, 20)
            before_ms = graph_ms(lambda: _k6_before(cubic, xb, qp["q4"], sc,
                                                    code), 20)
            ms_again = graph_ms(call, 20)
            plain_ms = graph_ms(lambda: qg._plain_bf16(xb, qp["q4"], sc, code,
                                                       cubic, bf), 3)
            extra = (f" (CUDA-core kernel before PR 16 {before_ms:.4f} ms, "
                     f"this kernel again {ms_again:.4f}; two calls "
                     f"bit-identical {same}, graph replay equal {replay})")
        wrap_ms = cuda_ms(lambda: qg.int4_rank1_gemv(x1, qp, bf, w4a8=w4a8),
                          20)
        if key == "K6" and m == 1:
            lib = _int4pack_ms(xs.to(bf), [_int4pack(qp["q4"], sc)], 20,
                               got)
            LIB_INT4[key] = lib
            log(f"kernel K6 lm_head m=1: torch._weight_int4pack_mm "
                f"{lib[0]} ms ({lib[1]})")
        # the launcher's operands: activations (bf16, or int8 + two f32
        # scales), packed nibbles, column scales, codebook; bf16 out
        act = x1.numel() * (1 if w4a8 else 2) + (8 * m if w4a8 else 0)
        bnd = bound_ms(act + nbytes(qp["q4"], qp["scale"], qp["code"], got),
                       2 * m * 3584 * 152064, "int8" if w4a8 else "bf16")
        lines.append((key, f"lm_head m={m}{extra}", err, ratio, ms, plain_ms,
                      wrap_ms, bnd))
    # a vocab shard of the lm_head (tensor parallelism over two cards'
    # columns), uniform, m = 1
    shard = {k: v[..., :76032].contiguous() if k in ("q4", "scale") else v
             for k, v in head_u.items()}
    x1 = torch.as_tensor(rng.standard_normal((1, 3584))).to(dev, bf)
    got = qg.int4_rank1_gemv(x1, shard, bf)
    err, ratio = row_check(got, qg.int4_rank1_gemv_plain(x1, shard, bf), 76032)
    xb = (x1.float() * shard["rscale"][None]).to(bf)
    sc = shard["scale"] * shard["code"][0]
    code = torch.cat([shard["code"], shard["code"].new_zeros(1)])
    ms = graph_ms(lambda: qg.gemv_k6(xb, shard["q4"], sc, code, False, bf), 20)
    lines.append(("K6", "lm_head vocab shard [1792, 76032] m=1", err, ratio,
                  ms, float("nan"), float("nan"),
                  bound_ms(2 * 3584 + nbytes(shard["q4"], shard["scale"], got),
                           2 * 3584 * 76032)))

    # stacked: gate_proj (m = 1, 40 and 64) and down_proj (m = 1), layer
    # 17, on the tensor-core kernel; beside each, the CUDA-core kernel that
    # K6 / K7 keep (csrc/int4_gemv.cu, which K8 / K9 ran before) on the
    # same operands
    for site, shape, ms_list in (("gate_proj", (28, 1792, 18944),
                                  (1, 40, 64)),
                                 ("down_proj", (28, 9472, 3584), (1,))):
        qp = _int4_store(rng, dev, shape)
        ids = torch.arange(28, dtype=torch.int32, device=dev)
        L, half, dout = shape
        for m in ms_list:
            x = torch.as_tensor(rng.standard_normal((m, 2 * half))).to(dev, bf)
            for key, w4a8 in (("K8", False), ("K9", True)):
                lay = ids[17:18]
                got = qg.int4_rank1_gemv_stacked(x, qp, lay, bf, w4a8=w4a8)
                ref = qg.int4_rank1_gemv_stacked_plain(x, qp, lay, bf,
                                                       w4a8=w4a8)
                err, ratio = row_check(got, ref, dout)
                same = bool(torch.equal(got, qg.int4_rank1_gemv_stacked(
                    x, qp, lay, bf, w4a8=w4a8)))
                if not same:
                    raise AssertionError(f"{key} m={m}: two calls differ")
                r = qp["rscale"][17:18] * qp["code"][17:18, :1]
                xs = x.float() * r
                it = iter(range(10 ** 9))
                if w4a8:
                    xq, sx = qg._int8_halves(xs, half)
                    ms = graph_ms(lambda: qg.gemv_k9(
                        xq, sx, qp["q4"], qp["scale"],
                        ids[next(it) % L:][:1], bf), L)
                    core_ms = graph_ms(lambda: _cuda_core_stacked(
                        qg.W4A8, xq, sx, qp, ids[next(it) % L:][:1]), L)
                    plain_ms = graph_ms(lambda: qg._plain_w4a8(
                        xq, sx, qp["q4"][17], qp["scale"][17], bf), 3)
                else:
                    xb = xs.to(bf)
                    ms = graph_ms(lambda: qg.gemv_k8(
                        xb, qp["q4"], qp["scale"], ids[next(it) % L:][:1],
                        bf), L)
                    core_ms = graph_ms(lambda: _cuda_core_stacked(
                        qg.UNIFORM, xb, None, qp, ids[next(it) % L:][:1]), L)
                    plain_ms = graph_ms(lambda: qg._plain_bf16(
                        xb, qp["q4"][17], qp["scale"][17], None, False, bf), 3)
                    if site == "gate_proj" and m == 1:
                        # the library call on the same values, one packed
                        # weight per layer (layer 17's activations)
                        packs = [_int4pack(qp["q4"][i], qp["scale"][i])
                                 for i in range(L)]
                        lib = _int4pack_ms(xb, packs, L, got, 17)
                        del packs
                        LIB_INT4[key] = lib
                        log(f"kernel K8 gate_proj m=1: "
                            f"torch._weight_int4pack_mm {lib[0]} ms "
                            f"({lib[1]})")
                wrap_ms = cuda_ms(lambda: qg.int4_rank1_gemv_stacked(
                    x, qp, ids[next(it) % L:][:1], bf, w4a8=w4a8), L)
                # one layer's weights, as each launch reads
                act = x.numel() * (1 if w4a8 else 2) + (8 * m if w4a8 else 0)
                bnd = bound_ms(act + nbytes(qp["q4"][17], qp["scale"][17],
                                            got),
                               2 * m * 2 * half * dout,
                               "int8" if w4a8 else "bf16")
                rows, splits = qg.stacked_plan(m, half, dout, w4a8,
                                               torch.cuda.get_device_properties(
                                                   dev).multi_processor_count)
                lines.append((key, f"{site} [28, {half}, {dout}] m={m} "
                              f"({splits} K splits of {rows} rows; "
                              f"CUDA-core kernel {core_ms:.4f} ms; two calls "
                              f"bit-identical {same})", err, ratio, ms,
                              plain_ms, wrap_ms, bnd))
        del qp
    # after the main-path shapes (each kernel's first line is its row in
    # the kernels line)
    lines += int4_w4a8_shard_lines(rng, dev, shard)
    del shard
    results = []
    for key, what, err, ratio, ms, plain_ms, wrap_ms, bnd in lines:
        log(f"kernel {key} {what}: max_abs_err={err:.6g}, worst row at "
            f"{ratio:.3g} of its bound; kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} wrapper_ms={wrap_ms:.4f} "
            f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
        if not ratio <= 1.0:
            raise AssertionError(f"{key} {what} disagrees with its plain "
                                 "version")
    # one kernels-line entry per kernel: the worst error over its cases,
    # the time and bound of its first (main-path) shape. library_ms: K6
    # (uniform) and K8 beside torch._weight_int4pack_mm on the same values
    # (repacked, the rscale folded into the activations as the launchers
    # fold it); K7 / K9 have none (no PyTorch call takes int8 activations
    # against int4 weights)
    log("kernel K7, K9: library_ms none (no PyTorch call computes the W4A8 "
        "GEMV)")
    for idx in INT4_PATH:
        key = KERNELS[idx][0].split("_")[0]
        mine = [ln for ln in lines if ln[0].split("_")[0] == key]
        results.append({"name": KERNELS[idx][0], "route": "cuda",
                        "source": KERNELS[idx][3],
                        "replaces": KERNELS[idx][4],
                        "max_abs_err": max(ln[2] for ln in mine),
                        "ms": mine[0][4], "plain_ms": mine[0][5],
                        "bound_ms": mine[0][7][0],
                        "bound_by": mine[0][7][1],
                        "library_ms": LIB_INT4.get(key, (None,))[0]})
    return results


def int4_w4a8_shard_lines(rng, dev, head_shard):
    """Phase 3's W4A8 GEMVs at Qwen2-7B's tp = 2 shard shapes, each
    against its plain version (the wrappers, bf16 in and out): K7 on the
    lm_head's vocab shard ``head_shard`` [1792, 76032] (its columns), K9
    on gate_proj's column shard [28, 1792, 9472] and on down_proj's row
    shard [28, 4736, 3584], the latter through the row-shard wrapper
    (``quant.RowShard`` of rows [0, 9472) of 18944 without a group: the
    global halves' scales, K9's f32 partial sums, then the rounding). m =
    1 (a decode step), layer 17; kernel, plain and wrapper ms as
    :func:`check_int4_kernels` takes them. Lines as that function's."""
    import torch

    from cogstream_tpu_torch.ops import quant_gemv as qg
    from cogstream_tpu_torch.ops.quant import RowShard

    bf, f32 = torch.bfloat16, torch.float32
    lines = []
    x1 = torch.as_tensor(rng.standard_normal((1, 3584))).to(dev, bf)
    got = qg.int4_rank1_gemv(x1, head_shard, bf, w4a8=True)
    err, ratio = row_check(got, qg.int4_rank1_gemv_plain(
        x1, head_shard, bf, w4a8=True), 76032)
    xq, sx = qg._int8_halves(x1.float() * head_shard["rscale"][None], 1792)
    sc = head_shard["scale"] * head_shard["code"][0]
    ms = graph_ms(lambda: qg.gemv_k7(xq, sx, head_shard["q4"], sc, bf), 20)
    plain_ms = graph_ms(lambda: qg._plain_w4a8(xq, sx, head_shard["q4"], sc,
                                               bf), 3)
    wrap_ms = cuda_ms(lambda: qg.int4_rank1_gemv(x1, head_shard, bf,
                                                 w4a8=True), 20)
    lines.append(("K7", "lm_head vocab shard [1792, 76032] m=1 (tp = 2)",
                  err, ratio, ms, plain_ms, wrap_ms,
                  bound_ms(3584 + 8 + nbytes(head_shard["q4"],
                                             head_shard["scale"], got),
                           2 * 3584 * 76032, "int8")))
    ids = torch.arange(28, dtype=torch.int32, device=dev)
    for site, shape, rows in (
            ("gate_proj column shard", (28, 1792, 9472), None),
            ("down_proj row shard", (28, 4736, 3584),
             RowShard(18944, 0, 9472, None))):
        qp = _int4_store(rng, dev, shape)
        L, half, dout = shape
        x = torch.as_tensor(rng.standard_normal((1, 2 * half))).to(dev, bf)
        lay = ids[17:18]
        got = qg.int4_rank1_gemv_stacked(x, qp, lay, bf, w4a8=True,
                                         rows=rows)
        err, ratio = row_check(got, qg.int4_rank1_gemv_stacked_plain(
            x, qp, lay, bf, w4a8=True, rows=rows), dout)
        xq, sx = qg._int8_halves(
            x.float() * qp["rscale"][17:18] * qp["code"][17:18, :1], half)
        out = bf if rows is None else f32
        it = iter(range(10 ** 9))
        ms = graph_ms(lambda: qg.gemv_k9(xq, sx, qp["q4"], qp["scale"],
                                         ids[next(it) % L:][:1], out), L)
        plain_ms = graph_ms(lambda: qg._plain_w4a8(
            xq, sx, qp["q4"][17], qp["scale"][17], out), 3)
        wrap_ms = cuda_ms(lambda: qg.int4_rank1_gemv_stacked(
            x, qp, ids[next(it) % L:][:1], bf, w4a8=True, rows=rows), L)
        rows_n, splits = qg.stacked_plan(
            1, half, dout, True,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        lines.append(("K9", f"{site} [28, {half}, {dout}] m=1 (tp = 2"
                      f"{', f32 partials' if rows else ''}; {splits} K "
                      f"splits of {rows_n} rows)", err, ratio, ms, plain_ms,
                      wrap_ms,
                      bound_ms(x.numel() + 8 + nbytes(qp["q4"][17],
                                                      qp["scale"][17])
                               + dout * (2 if rows is None else 4),
                               2 * 2 * half * dout, "int8")))
        del qp
    return lines


def _int8_store(dev, shape, seed: int):
    """Random int8 storage [L,] din, dout on the card, column-major as the
    port holds it (every byte value but -128 occurs), with per-column
    scales of the magnitude a real fit gives."""
    import torch

    from cogstream_tpu_torch.ops.quant import column_major

    *lead, din, dout = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = column_major(torch.randint(-127, 128, tuple(shape), dtype=torch.int8,
                                   device=dev, generator=gen))
    scale = torch.rand((*lead, dout), device=dev, generator=gen) * 4e-3 + 1e-3
    return {"q": q, "scale": scale}


def _int8pack_ms(x, q, scale, n: int):
    """Device ms of ``torch._weight_int8pack_mm`` (x @ (q * scale), the
    scale applied after the product) on the same operands, the library
    yardstick of K10 (used nowhere in the port), or (None, why) where
    the card's build has no such kernel."""
    import torch

    def call():
        return torch._weight_int8pack_mm(x, q.t(), scale)

    try:
        call()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        return None, str(e).splitlines()[0][:120]
    return graph_ms(call, n), None


def _k10_before(x, q, scale, layer, m, din, dout, dev):
    """One bf16 call on the mma.sync kernel (``cs_int8_gemv``, its split
    from ``stacked_plan``; K10's only bf16 kernel before PR 16, since then
    its route for the smaller products), bf16 out, whatever the size."""
    import torch

    from cogstream_tpu_torch.ops import kernels
    from cogstream_tpu_torch.ops import quant_gemv as qg

    rows, splits = quant_gemv_plan(m, din, dout, dev)
    part, tickets = qg._tc_workspace(dev, splits * m * dout, dout // 128)
    out = torch.empty((m, dout), dtype=torch.bfloat16, device=dev)
    kernels.check(kernels.library().cs_int8_gemv(
        x.data_ptr(), q.data_ptr(), din * dout if layer is not None else 0,
        scale.data_ptr(), dout if layer is not None else 0,
        None if layer is None else layer.data_ptr(), out.data_ptr(),
        part.data_ptr(), tickets.data_ptr(), m, din, dout, rows, splits,
        kernels.dtype_code(x), kernels.dtype_code(out),
        kernels.stream_ptr(x)), "cs_int8_gemv")
    return out


def check_int8_kernels(dev):
    """K10 on stacked gate_proj [28, 3584, 18944] (column-major layers) at
    m = 1, 5, 40 and 64, down_proj [28, 18944, 3584] at m = 1 (layer 17),
    the 2D lm_head [3584, 152064] at m = 1 and q_proj [28, 3584, 3584] /
    k_proj [28, 3584, 512] at m = 1 and 5, against its plain version
    on the same card (bf16 in and out) within the per-row bound of phase
    3; two calls bit-identical; one call captured in a CUDA graph,
    replayed after x (and the layer index) were rewritten in place, equal
    to the eager call on the new values; the wrapper's route (by
    ``int8_gemv.takes_sm90``) timed beside both kernels on the same
    operands, and the count of tensor maps the persistent kernel encoded
    (one per weight tensor, none per call). Kernel and plain ms from CUDA
    graphs
    (stacked sites cycle over the 28 layers, so every launch reads its
    weights from device memory). Then the W8A8 product of one gate_proj
    at a 4384-row prefill: ``quantize_int8_act`` + ``torch._int_mm`` +
    the epilogue, each part timed, ``_int_mm`` also on a row-major copy of
    the weights (the JAX layout), beside the bf16 ``F.linear`` the bf16
    model runs. Returns (kernels-line entry, W8A8 metrics)."""
    import torch
    import torch.nn.functional as F

    from cogstream_tpu_torch.ops import int8_gemv as ig
    from cogstream_tpu_torch.ops import quant

    from cogstream_tpu_torch.ops import kernels
    from cogstream_tpu_torch.ops import quant_gemv as qg

    rng = np.random.default_rng(4)
    bf = torch.bfloat16
    lines = []
    encodes = kernels.library().cs_quant_gemv_sm90_encodes
    enc0, calls = encodes(), 0
    for site, shape, ms_list in (("gate_proj", (28, 3584, 18944),
                                  (1, 5, 40, 64)),
                                 ("down_proj", (28, 18944, 3584), (1,)),
                                 ("lm_head", (3584, 152064), (1,)),
                                 ("q_proj", (28, 3584, 3584), (1, 5)),
                                 ("k_proj", (28, 3584, 512), (1, 5))):
        qp = _int8_store(dev, shape, int(rng.integers(1 << 30)))
        stacked = len(shape) == 3
        L = shape[0] if stacked else 1
        din, dout = shape[-2:]
        ids = torch.arange(L, dtype=torch.int32, device=dev)
        q17 = qp["q"][17] if stacked else qp["q"]
        s17 = qp["scale"][17] if stacked else qp["scale"]
        for m in ms_list:
            x = torch.as_tensor(rng.standard_normal((m, din))).to(dev, bf)
            w = {**qp, "layer": ids[17:18]} if stacked else qp
            got = ig.int8_gemv(x, w, bf)
            err, ratio = row_check(got, ig.int8_gemv_plain(x, w, bf), dout)
            same = bool(torch.equal(got, ig.int8_gemv(x, w, bf)))
            xg = x.clone()
            lg = ids[17:18].clone()
            wg = {**qp, "layer": lg} if stacked else qp
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out_g = ig.int8_gemv(xg, wg, bf)
            xg.copy_(torch.as_tensor(rng.standard_normal((m, din))).to(dev, bf))
            lg.fill_(3)
            g.replay()
            torch.cuda.synchronize()
            replay = bool(torch.equal(out_g, ig.int8_gemv(xg, wg, bf)))
            if not same or not replay:
                raise AssertionError(f"K10 {site} m={m}: two calls equal "
                                     f"{same}, graph replay equal {replay}")
            it = iter(range(10 ** 9))
            n_calls = L if stacked else 10

            def lay():
                return ids[next(it) % L:][:1] if stacked else None

            def new():
                return ig.gemv_k10(x, qp["q"], qp["scale"], lay(), bf)

            def before():
                return _k10_before(x, qp["q"], qp["scale"], lay(), m, din,
                                   dout, dev)

            def sm90():
                return qg._launch_sm90(qg.INT8, x, qp["q"], L if stacked
                                       else 1, qp["scale"], dout if stacked
                                       else 0, lay(), None, din, dout, bf)
            ms = graph_ms(new, n_calls)
            before_ms = graph_ms(before, n_calls)
            sm90_ms = graph_ms(sm90, n_calls)
            ms_again = graph_ms(new, n_calls)
            calls += 4 + 4 * n_calls
            plain_ms = graph_ms(lambda: ig._plain(x, q17, s17, None, bf), 3)
            lib_ms, why = _int8pack_ms(x, q17, s17, 10)
            bnd = bound_ms(nbytes(x, q17, s17, got), 2 * m * din * dout)
            grid = qg.stream_grid(*qg.sm90_units(din, dout),
                                  torch.cuda.get_device_properties(
                                      dev).multi_processor_count)
            route = ("persistent" if ig.takes_sm90(m, din, dout)
                     else "mma.sync")
            lines.append((f"{site} [{'28, ' if stacked else ''}{din}, {dout}] "
                          f"m={m} (the {route} kernel; the persistent one "
                          f"{sm90_ms:.4f} ms in {grid} blocks, the mma.sync "
                          f"one (K10 before PR 16) {before_ms:.4f} ms, the "
                          f"route again {ms_again:.4f}; two calls "
                          f"bit-identical {same}, graph replay equal "
                          f"{replay})", err, ratio, ms, plain_ms, lib_ms,
                          why, bnd))
        if site == "gate_proj":
            # the W8A8 product of one layer at a 4384-row prefill
            xp = torch.as_tensor(rng.standard_normal((4384, din))).to(dev, bf)
            wlin = quant.dequantize_int8({"q": q17, "scale": s17},
                                         bf).t().contiguous()
            xq, sx = quant.quantize_int8_act(xp)
            yi = torch._int_mm(xq, q17)
            q_row = q17.contiguous()
            w8a8 = {
                "act_quant_ms": cuda_ms(lambda: quant.quantize_int8_act(xp),
                                        10),
                "int_mm_ms": cuda_ms(lambda: torch._int_mm(xq, q17), 10),
                "int_mm_row_major_ms": cuda_ms(
                    lambda: torch._int_mm(xq, q_row), 5),
                "epilogue_ms": cuda_ms(lambda: (yi.to(torch.float32) * sx
                                                * s17[None, :]).to(bf), 10),
                "w8a8_total_ms": cuda_ms(lambda: quant.int8_act_matmul(
                    *quant.quantize_int8_act(xp), q17, s17, bf), 10),
                "bf16_linear_ms": cuda_ms(lambda: F.linear(xp, wlin), 10)}
            del xp, wlin, xq, yi, q_row
        del qp, q17, s17
    for what, err, ratio, ms, plain_ms, lib_ms, why, bnd in lines:
        log(f"kernel K10 {what}: max_abs_err={err:.6g}, worst row at "
            f"{ratio:.3g} of its bound; kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms="
            f"{'none (' + why + ')' if lib_ms is None else f'{lib_ms:.4f}'}"
            f" bound_ms={bnd[0]:.4f} ({bnd[1]})")
        if not ratio <= 1.0:
            raise AssertionError(f"K10 {what} disagrees with its plain "
                                 "version")
    log("kernel W8A8 gate_proj [3584, 18944] at 4384 rows (one layer): "
        + ", ".join(f"{k} {v:.4f}" for k, v in w8a8.items()))
    # the tensor maps are encoded once per weight tensor, not per call
    enc = encodes() - enc0
    log(f"kernel K10: {enc} tensor maps encoded over {calls} calls on 5 "
        "weight tensors")
    if not 1 <= enc <= 5:
        raise AssertionError(f"K10 encoded {enc} tensor maps for 5 weights")
    first = lines[0]
    return {"name": KERNELS[9][0], "route": "cuda", "source": KERNELS[9][3],
            "replaces": KERNELS[9][4],
            "max_abs_err": max(ln[1] for ln in lines), "ms": first[3],
            "plain_ms": first[4], "bound_ms": first[7][0],
            "bound_by": first[7][1], "library_ms": first[5]}, w8a8


def quant_gemv_plan(m: int, din: int, dout: int, dev):
    """The (rows per split, splits) of the K10 kernel before PR 16 on
    ``dev`` (phase 3's yardstick)."""
    import torch

    from cogstream_tpu_torch.ops import quant_gemv as qg

    return qg.stacked_plan(m, din, dout, False, torch.cuda.
                           get_device_properties(dev).multi_processor_count,
                           x_halves=1)


def check_rows_kernels(dev):
    """Phase 3, pooled addressing: K3 and K4 reading a [4, 9216, 4, 128]
    bf16 pool cache through ``rows`` ([2] and [3, 1]) — K3 at the timed
    4384-token prefill over 4607 history slots, K4 at S = 1 and S = 8
    over 9000 — each call bit-identical to the same kernel on a
    contiguous copy of the addressed rows and within the 2-ulp row bound
    of the plain version (which gathers); device ms beside the call
    without ``rows``; one K4 call with ``rows`` captured in a CUDA graph
    and replayed after q was rewritten equals the eager call. Returns
    {label: (ms with rows, ms on the contiguous copy)}."""
    import torch

    from cogstream_tpu_torch.ops import lm_attention as lma

    rng = np.random.default_rng(9)
    bf = torch.bfloat16
    Bp, T, Hq, Hkv, Dl = 4, 9216, 28, 4, 128

    def dev_t(a, dtype=None):
        return torch.as_tensor(a).to(dev, dtype)

    pk = dev_t(rng.standard_normal((Bp, T, Hkv, Dl)), bf)
    pv = dev_t(rng.standard_normal((Bp, T, Hkv, Dl)), bf)
    allowed = rng.random((1, T)) > 0.3
    timings = {}
    for rows in ([2], [3, 1]):
        B = len(rows)
        cr = lma.cache_rows(rows, dev)
        kc, vc = pk[rows].contiguous(), pv[rows].contiguous()
        for kind, S, hist in (("K3", 4384, 4607), ("K4", 1, 9000),
                              ("K4", 8, 9000)):
            pos = np.full((B, T), -1, np.int32)
            pos[:, :hist + S] = np.arange(hist + S)
            pos[:, rng.choice(hist, 300, replace=False)] = -1
            al = np.repeat(allowed, B, 0)
            al[:, hist:] = True
            qpos = np.tile(hist + np.arange(S, dtype=np.int32), (B, 1))
            if S > 1:
                qpos[:, -1] = -1            # a padded query
            eff = lma.effective_kv_positions(dev_t(pos, torch.int32),
                                             dev_t(al, torch.bool))
            qp = dev_t(qpos, torch.int32)
            q = dev_t(rng.standard_normal((B, S, Hq, Dl)), bf)
            wrap = (lma.prefill_flash_attention if kind == "K3"
                    else lma.decode_attention)
            n0 = wrap.rows_launches
            got = wrap(q, pk, pv, qp, eff, rows=cr)
            want = wrap(q, kc, vc, qp, eff)
            same = bool(torch.equal(got, want))
            err, ratio = row_check(got, lma.gqa_attention_plain(
                q, pk, pv, qp, eff, rows=cr), Dl)
            timer = (lambda f: cuda_ms(f, 5)) if kind == "K3" \
                else (lambda f: graph_ms(f, 20))
            ms_rows = timer(lambda: wrap(q, pk, pv, qp, eff, rows=cr))
            ms_flat = timer(lambda: wrap(q, kc, vc, qp, eff))
            label = f"{kind} S={S} rows={rows}"
            timings[label] = (ms_rows, ms_flat)
            log(f"kernel {label}: bit-identical to the contiguous copy "
                f"{same}; max_abs_err={err:.6g}, worst row at {ratio:.3g} "
                f"of its bound; {ms_rows:.4f} ms with rows, {ms_flat:.4f} "
                f"ms on the contiguous copy")
            if not same or not ratio <= 1.0 or wrap.rows_launches == n0:
                raise AssertionError(f"{label} disagrees")
    # capture: one K4 call with rows, replayed after q is rewritten
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out_g = lma.decode_attention(q, pk, pv, qp, eff, rows=cr)
    q.copy_(dev_t(rng.standard_normal(tuple(q.shape)), bf))
    g.replay()
    torch.cuda.synchronize()
    replay = bool(torch.equal(out_g, lma.decode_attention(q, pk, pv, qp, eff,
                                                          rows=cr)))
    log(f"kernel K4 rows={rows} graph replay after q rewritten equals the "
        f"eager call {replay}")
    if not replay:
        raise AssertionError("K4 with rows differs under graph replay")
    return timings


def check_fp8_cast(dev):
    """Phase 3, the fp8 cache's cast: torch's CUDA cast to e4m3 against its
    CPU cast, byte for byte, over all 65536 bf16 bit patterns and 2^20 f32
    draws over e4m3's range, its subnormals and past 448 (the tiny f32
    decoder writes f32 keys); then the port's cache cast
    (``qwen2.to_cache``) on the card against the CPU: the same bytes for
    every non-NaN input, NaN kept, and past 464 saturated to +-448 (torch's own cast there depends
    on its version; JAX's gives NaN: ROADMAP Queue 3)."""
    import torch

    from cogstream_tpu_torch.models.qwen2 import to_cache

    f8 = torch.float8_e4m3fn
    bits = torch.from_numpy(np.arange(1 << 16, dtype=np.uint16).view(
        np.int16)).view(torch.bfloat16)
    rng = np.random.default_rng(0)
    f32 = torch.from_numpy((rng.standard_normal(1 << 20) * 10.0 ** rng.uniform(
        -4, 3, 1 << 20)).astype(np.float32))
    for name, x in (("bf16 bit patterns", bits), ("f32 draws", f32)):
        raw = bool(torch.equal(x.to(dev).to(f8).cpu().view(torch.uint8),
                               x.to(f8).view(torch.uint8)))
        nan = torch.isnan(x)
        big = ~nan & (x.float().abs() > 464)
        raw_big = x[big].to(dev).to(f8).float().cpu()
        card = to_cache(x.to(dev), f8).cpu()
        # NaN inputs give NaN on both (the clamp may flip a NaN's sign bit)
        same = bool(torch.equal(card.view(torch.uint8)[~nan],
                                to_cache(x, f8).view(torch.uint8)[~nan]))
        nan_ok = bool(torch.isnan(card[nan].float()).all())
        sat = bool(torch.equal(card[big].float(),
                               x[big].float().sign() * 448))
        log(f"fp8 cast: {name} ({x.numel()}): torch's card cast equals its "
            f"CPU cast byte for byte {raw} (torch {torch.__version__}: "
            f"{int(big.sum())} values past 464 give NaN "
            f"{int(torch.isnan(raw_big).sum())}, +-448 "
            f"{int((raw_big.abs() == 448).sum())}); the port's to_cache on "
            f"the card equals the CPU's {same}, NaN kept {nan_ok}, past 464 "
            f"saturated to +-448 {sat}")
        if not (raw and same and nan_ok and sat):
            raise AssertionError("the e4m3 cast on the card differs from the"
                                 " CPU's or does not saturate")


def fp8_widening_exact(dev, f8, rng):
    """Phase 3: every byte of an fp8 K/V kind (``f8``: e4m3 or e5m2)
    through K3's and K4's tensor-core widening, bit for bit. All 256 byte
    values (inf and NaN included) as the V of the one visible slot, q = 0,
    so each output head is its kv head's V row widened by torch; and every
    finite byte as the K of slot 0 (beside a zero K at slot 1), each folded
    query row one-hot at dim r % 128, so each score is one product: the
    output equals the bf16 kernel on the widened cache bit for bit, NaN in
    the kv heads that hold a NaN byte (a NaN anywhere in a key's row makes
    each of its scores NaN)."""
    import torch

    from cogstream_tpu_torch.ops import lm_attention as lma

    bf, Dl = torch.bfloat16, 128
    name = str(f8).removeprefix("torch.float8_")

    def dev_t(a, dtype=None):
        return torch.as_tensor(a).to(dev, dtype)

    def same_bits(a, b):
        return bool(torch.equal(torch.nan_to_num(a.float(), 1e9),
                                torch.nan_to_num(b.float(), 1e9)))

    bytes_ = torch.arange(256, device=dev).to(torch.uint8).reshape(2, Dl)
    vb = torch.zeros((1, 256, 2, Dl), dtype=torch.uint8, device=dev)
    vb[0, 0] = bytes_
    v8, k8 = vb.view(f8), torch.zeros_like(vb).view(f8)
    eff = torch.full((1, 256), lma.SENTINEL, dtype=torch.int32, device=dev)
    eff[0, 0] = 0
    want = v8[0, 0].to(bf).float().repeat_interleave(7, 0)
    for wrap, S in ((lma.prefill_flash_attention, 16),
                    (lma.decode_attention, 1)):
        args = (torch.zeros((1, S, 14, Dl), dtype=bf, device=dev), k8, v8,
                dev_t(np.arange(S, dtype=np.int32)[None]), eff)
        out = wrap(*args)
        exact = same_bits(out, want.expand_as(out)) and same_bits(
            out, wrap(*args[:1], k8.to(bf), v8.to(bf), *args[3:]))
        log(f"kernel {'K3' if S > 1 else 'K4'} {name}: all 256 {name} byte "
            f"values as V widen exactly (inf and NaN kept), equal to the "
            f"bf16 kernel on the widened cache {exact}")
        if not exact:
            raise AssertionError(f"an {name} byte of V does not widen "
                                 "exactly")
    # kv heads 0 and 1 every finite byte, heads 2 and 3 only the NaN bytes
    kb = torch.zeros((1, 256, 4, Dl), dtype=torch.uint8, device=dev)
    every = bytes_.clone()
    every[~torch.isfinite(every.view(f8).float())] = 0
    kb[0, 0, :2] = every
    kb[0, 0, 2, Dl - 1], kb[0, 0, 3, Dl - 1] = 0x7F, 0xFF
    k8 = kb.view(f8)
    v8 = dev_t(rng.standard_normal((1, 256, 4, Dl)), bf).to(f8)
    eff = torch.full((1, 256), lma.SENTINEL, dtype=torch.int32, device=dev)
    eff[0, :2] = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    for wrap, S in ((lma.prefill_flash_attention, 16),
                    (lma.decode_attention, 8)):
        G = Dl // S
        r = torch.arange(S * G, device=dev)
        q = torch.zeros((1, S, 4, G, Dl), dtype=bf, device=dev)
        q[0, r // G, :, r % G, r % Dl] = 1.0
        args = (q.reshape(1, S, 4 * G, Dl), k8, v8,
                dev_t(np.arange(1, S + 1, dtype=np.int32)[None]), eff)
        out = wrap(*args)
        ref = wrap(*args[:1], k8.to(bf), v8.to(bf), *args[3:])
        nan = torch.isnan(ref).reshape(S, 4, G, Dl)
        exact = (same_bits(out, ref) and bool(nan[:, 2:].all())
                 and not bool(nan[:, :2].any()))
        log(f"kernel {'K3' if wrap is lma.prefill_flash_attention else 'K4'}"
            f" {name}: every finite {name} byte as K (one product a score) "
            f"equals the bf16 kernel on the widened cache bit for bit, NaN "
            f"where a NaN byte is {exact}")
        if not exact:
            raise AssertionError(f"an {name} byte of K does not widen "
                                 "exactly")


def check_fp8_pool_kernels(dev):
    """Phase 3, the fp8 KV cache read through ``rows``: K3 (the 4384-token
    prefill over 4607 history slots) and K4 (S = 1, 8 over 9000) reading
    rows [2] and [3, 1] of a [4, 9216, 4, 128] e4m3 pool, each call
    bit-identical to the same kernel on a contiguous copy of those rows and
    within the 2-ulp row rule of the plain version, counted in
    ``.rows_launches`` and ``.fp8_launches``. (K3 and K4 over e4m3 at the
    main path's shapes: :func:`check_kv_dtype_kernels`.) Returns {label:
    ms}."""
    import torch

    from cogstream_tpu_torch.ops import lm_attention as lma

    rng = np.random.default_rng(8)
    bf, f8 = torch.bfloat16, torch.float8_e4m3fn
    Hq, Hkv, Dl = 28, 4, 128
    timings = {}

    def dev_t(a, dtype=None):
        return torch.as_tensor(a).to(dev, dtype)

    # pooled addressing on an e4m3 pool
    Bp, Tp = 4, 9216
    pk = dev_t(rng.standard_normal((Bp, Tp, Hkv, Dl)), bf).to(f8)
    pv = dev_t(rng.standard_normal((Bp, Tp, Hkv, Dl)), bf).to(f8)
    for rows in ([2], [3, 1]):
        B = len(rows)
        cr = lma.cache_rows(rows, dev)
        kc, vc = pk[rows].contiguous(), pv[rows].contiguous()
        for kind, S, hist in (("K3", 4384, 4607), ("K4", 1, 9000),
                              ("K4", 8, 9000)):
            pos = np.full((B, Tp), -1, np.int32)
            pos[:, :hist + S] = np.arange(hist + S)
            pos[:, rng.choice(hist, 300, replace=False)] = -1
            qpos = np.tile(hist + np.arange(S, dtype=np.int32), (B, 1))
            if S > 1:
                qpos[:, -1] = -1            # a padded query
            eff = lma.effective_kv_positions(dev_t(pos, torch.int32))
            qp = dev_t(qpos, torch.int32)
            q = dev_t(rng.standard_normal((B, S, Hq, Dl)), bf)
            wrap = (lma.prefill_flash_attention if kind == "K3"
                    else lma.decode_attention)
            n0, f0 = wrap.rows_launches, wrap.fp8_launches
            got = wrap(q, pk, pv, qp, eff, rows=cr)
            counted = (wrap.rows_launches, wrap.fp8_launches) == (n0 + 1,
                                                                  f0 + 1)
            same = bool(torch.equal(got, wrap(q, kc, vc, qp, eff)))
            err, ratio = row_check(got, lma.gqa_attention_plain(
                q, pk, pv, qp, eff, rows=cr), Dl)
            timer = (lambda f: cuda_ms(f, 5)) if kind == "K3" \
                else (lambda f: graph_ms(f, 20))
            ms_rows = timer(lambda: wrap(q, pk, pv, qp, eff, rows=cr))
            label = f"{kind} fp8 S={S} rows={rows}"
            timings[label] = ms_rows
            log(f"kernel {label}: bit-identical to the contiguous copy "
                f"{same}; max_abs_err={err:.6g}, worst row at {ratio:.3g} of "
                f"its bound; {ms_rows:.4f} ms")
            if not (same and ratio <= 1.0 and counted):
                raise AssertionError(f"{label} disagrees")
    return timings


# (query dtype, cache dtype, record suffix, the instances' source) of the
# K/V routes phase 3 holds beyond bf16: the tensor-core kernels over
# e4m3, e5m2, f16 and f32 caches, and the f32 route over a bf16 cache
KV_ROUTES = (("bfloat16", "float8_e4m3fn", "fp8kv",
              "cogstream_tpu_torch/csrc/lm_attention_e4m3.cu"),
             ("bfloat16", "float8_e5m2", "e5m2kv",
              "cogstream_tpu_torch/csrc/lm_attention_e5m2.cu"),
             ("bfloat16", "float16", "f16kv",
              "cogstream_tpu_torch/csrc/lm_attention_f16.cu"),
             ("bfloat16", "float32", "f32kv",
              "cogstream_tpu_torch/csrc/lm_attention_f32.cu"),
             ("float32", "bfloat16", "bf16kv_f32q",
              "cogstream_tpu_torch/csrc/lm_attention.cu"))


def one_ulp_apart(got, want):
    """(elements of two bf16 tensors that differ, whether each lies within
    one bf16 ulp of the larger magnitude of the two)."""
    import torch

    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
    within = bool(((g - w).abs() <= torch.exp2(
        torch.floor(torch.log2(mag)) - 7)).all())
    return int((g != w).sum().item()), within


def check_kv_dtype_kernels(dev):
    """Phase 3, the caches in another dtype than q: K3 and K4 over an e4m3,
    e5m2, f16 and f32 cache on their tensor-core kernels (bf16 queries) and
    over a bf16 cache on the f32 route (f32 queries), each held to its plain
    version
    on the same values by the 2-ulp row rule, timed beside the bf16 route
    on the same values (the cache converted to bf16: what the kernel
    computes with; on the f32 route, beside an f32 cache of those values)
    and beside its bound (the cache's own K/V bytes); K3 over f16 and f32
    within one bf16 ulp of the bf16 kernel over the cache rounded to bf16,
    its differing elements counted. K3 at the 4384-token
    prefill over 4607 history slots of a 16384-slot cache, K4 at S = 1, 5
    and 8 over a 9216-slot window holding 9000 (timed at S = 1; the f32
    route: S = 1);
    K4's two calls bit-identical and, on the tensor cores, one call
    replayed in a CUDA graph after q / eff were rewritten equal to the
    eager call; each call counted in ``.kv_launches`` under the cache's
    dtype. Then every e4m3 and e5m2 byte through the widening
    (:func:`fp8_widening_exact`). Prints the instances' ptxas registers,
    spills, shared memory and blocks per SM. No PyTorch call takes K/V in
    another dtype than q, so ``library_ms`` is null. Returns (kernel
    records: K3 then K4 for each of KV_ROUTES, {label: ms})."""
    import torch

    from cogstream_tpu_torch.ops import kernels
    from cogstream_tpu_torch.ops import lm_attention as lma

    rng = np.random.default_rng(18)
    T, Hq, Hkv, Dl = 16384, 28, 4, 128
    timings, records = {}, []
    for name, use in lm_attention_usage(kernels.last_build_log).items():
        if any(f" {k} " in name for k in ("e4m3", "e5m2", "f16", "f32")):
            log(f"kernel kv {name}: {use}")
            timings[f"ptxas {name}"] = use

    def dev_t(a, dtype=None):
        return torch.as_tensor(a).to(dev, dtype)

    def case(S, hist, qd, W=None):
        pos = np.full((1, T), -1, np.int32)
        pos[0, :hist + S] = np.arange(hist + S)
        pos[0, rng.choice(hist, 300, replace=False)] = -1
        allowed = rng.random((1, T)) > 0.3
        allowed[0, hist:] = True
        eff = lma.effective_kv_positions(dev_t(pos, torch.int32),
                                         dev_t(allowed, torch.bool))
        if W is not None:
            eff = eff[:, :W].contiguous()
        return dev_t(rng.standard_normal((1, S, Hq, Dl)), qd), eff

    for qname, kvname, suffix, source in KV_ROUTES:
        qd, kd = getattr(torch, qname), getattr(torch, kvname)
        tc = qd == torch.bfloat16
        kc = dev_t(rng.standard_normal((1, T, Hkv, Dl)), torch.float32).to(kd)
        vc = dev_t(rng.standard_normal((1, T, Hkv, Dl)), torch.float32).to(kd)
        # the same values in the queries' dtype: the other route's operands
        kq, vq = kc.to(qd), vc.to(qd)
        row = Hkv * Dl * kc.element_size()   # cache bytes of a slot's K
        ops_kind = "bf16" if tc else "f32"

        def bound(q, qp, eff, out, row=row, ops_kind=ops_kind):
            seen = int((eff[0] < lma.SENTINEL).sum().item())
            return bound_ms(nbytes(q, qp, eff, out) + 2 * seen * row,
                            4 * Hq * Dl * visible_pairs(qp, eff), ops_kind)

        def launched(wrap, call):
            n0 = (wrap.tc_launches, wrap.kv_launches.get(kvname, 0))
            out = call()
            ok = (wrap.tc_launches - n0[0] == int(tc)
                  and wrap.kv_launches.get(kvname, 0) == n0[1] + 1)
            return out, ok

        other = "bf16" if tc else "f32"
        # K3: the second ingest's prefill
        S, hist = 4384, 4607
        q, eff = case(S, hist, qd)
        qpos = np.full((1, S), -1, np.int32)
        qpos[0, :S - 20] = hist + np.arange(S - 20)
        qp = dev_t(qpos, torch.int32)
        wrap = lma.prefill_flash_attention
        got, counted = launched(wrap, lambda: wrap(q, kc, vc, qp, eff))
        err, ratio = row_check(got, lma.gqa_attention_plain(
            q, kc, vc, qp, eff), Dl)
        iters = 10 if tc else 2
        ms = cuda_ms(lambda: wrap(q, kc, vc, qp, eff), iters)
        ms_q = cuda_ms(lambda: wrap(q, kq, vq, qp, eff), iters)
        plain = cuda_ms(lambda: lma.gqa_attention_plain(q, kc, vc, qp, eff),
                        1)
        b = bound(q, qp, eff, got)
        pad_zero = bool((got[0, S - 20:] == 0).all())
        # f16 / f32 under bf16 queries: the bf16 kernel's function over the
        # cache rounded to bf16, bit-equal where both launch blocks of as
        # many rows; a block of another size rescales a row's sums at the
        # tiles it sees nothing of by exp2 of a rounding residue, so each
        # element must lie within one bf16 ulp of the bf16 kernel's
        rounded = ""
        one_ulp = True
        if tc and kvname in ("float16", "float32"):
            n_diff, one_ulp = one_ulp_apart(got, wrap(q, kq, vq, qp, eff))
            rounded = (f"; elements differing from the bf16 kernel over the "
                       f"cache rounded to bf16 {n_diff} of {got.numel()}, "
                       f"all within one bf16 ulp {one_ulp}")
        log(f"kernel K3 {kvname} cache, {qname} queries, S={S} over {hist} "
            f"history slots: max_abs_err={err:.6g}, worst row at {ratio:.3g}"
            f" of its bound; {'tensor-core kernel' if tc else 'f32 route'} "
            f"with the {kvname} code {counted}; {ms:.4f} ms, {other} cache "
            f"(same values) {ms_q:.4f} ms ({ms / ms_q:.3f}x), plain "
            f"{plain:.4f} ms; bound {b[0]:.4f} ms ({b[1]}); 20 padded query "
            f"rows zero {pad_zero}{rounded}")
        if not (ratio <= 1.0 and counted and pad_zero and one_ulp):
            raise AssertionError(f"K3 over the {kvname} cache disagrees with"
                                 " its plain version or the bf16 kernel")
        timings[f"K3 {suffix} S=4384"] = {"ms": ms, f"{other}_ms": ms_q,
                                          "bound_ms": b[0]}
        records.append({"name": f"K3_prefill_attention_{suffix}",
                        "route": "cuda", "source": source,
                        "replaces": KERNELS[2][4], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain, "bound_ms": b[0],
                        "bound_by": b[1], "library_ms": None})
        del got, q

        # K4: decode and verify steps over a 9216-slot window holding 9000
        W, fill = 9216, 9000
        wrap = lma.decode_attention
        k4 = {}
        timer = graph_ms if tc else (lambda f, n: cuda_ms(f, n))
        for Sv in ((1, 5, 8) if tc else (1,)):
            qv, effv = case(Sv, fill, qd, W)
            qpv = dev_t(np.arange(fill, fill + Sv)[None], torch.int32)
            gotv, counted = launched(wrap, lambda: wrap(qv, kc, vc, qpv,
                                                        effv))
            errv, ratiov = row_check(gotv, lma.gqa_attention_plain(
                qv, kc, vc, qpv, effv), Dl)
            bv = bound(qv, qpv, effv, gotv)
            repeat = bool(torch.equal(gotv, wrap(qv, kc, vc, qpv, effv)))
            # f16 / f32 under bf16 queries: the bf16 kernel's function over
            # the cache rounded to bf16. On its own plan (whole tiles a
            # warp; f32 3 warps) a warp's softmax rounds P against another
            # running max: each row within one bf16 ulp of its max |bf16
            # kernel| (test_rounded_cache_decode_equals_the_bf16_kernel).
            # f16 has bf16's warps: on bf16's split, bit-equal
            rounded = ""
            one_ulp = True
            if tc and kvname in ("float16", "float32"):
                w = wrap(qv, kq, vq, qpv, effv)
                n_diff, _ = one_ulp_apart(gotv, w)
                _, row_ulps = row_check(gotv, w, Dl)
                row_ulps *= 2    # row_check's bound is 2 ulps
                code = kernels.KV_DTYPE_CODES[kd]
                one_ulp = row_ulps <= 1.0
                rounded = (f"; against the bf16 kernel over the cache rounded"
                           f" to bf16 ({lma.DECODE_WARPS[code]} warps, whole "
                           f"tiles): {n_diff} of {gotv.numel()} elements "
                           f"differ, worst row at {row_ulps:.3g} bf16 ulps "
                           f"of its max, every row within one ulp {one_ulp}")
                if lma.DECODE_WARPS[code] == lma.DECODE_WARPS[1]:
                    plan = lma.decode_plan
                    lma.decode_plan = lambda *a: plan(*a[:6])
                    try:
                        same = bool(torch.equal(
                            wrap(qv, kc, vc, qpv, effv), w))
                    finally:
                        lma.decode_plan = plan
                    one_ulp = one_ulp and same
                    rounded += f"; on bf16's split bit-equal {same}"
            timed = ""
            msv = None
            if tc or Sv == 1:
                msv = timer(lambda: wrap(qv, kc, vc, qpv, effv), 50)
                msv_q = timer(lambda: wrap(qv, kq, vq, qpv, effv), 50)
                timings[f"K4 {suffix} S={Sv}"] = {
                    "ms": msv, f"{other}_ms": msv_q, "bound_ms": bv[0]}
                timed = (f"; {msv:.4f} ms, {other} cache (same values) "
                         f"{msv_q:.4f} ms ({msv / msv_q:.3f}x)"
                         f"{' (graph ms)' if tc else ''}")
            log(f"kernel K4 {kvname} cache, {qname} queries, S={Sv} over a "
                f"{W}-slot window ({fill} history slots): max_abs_err="
                f"{errv:.6g}, worst row at {ratiov:.3g} of its bound; the "
                f"{kvname} code {counted}; two calls bit-identical "
                f"{repeat}{timed}; bound {bv[0]:.4f} ms ({bv[1]}){rounded}")
            if not (ratiov <= 1.0 and counted and repeat and one_ulp):
                raise AssertionError(f"K4 over the {kvname} cache at S={Sv} "
                                     "disagrees with its plain version or "
                                     "the bf16 kernel")
            k4[Sv] = (qv, qpv, effv, errv, msv, bv)
        qv, qpv, effv, _, msv, bv = k4[1]
        plain = cuda_ms(lambda: lma.gqa_attention_plain(qv, kc, vc, qpv,
                                                        effv), 5)
        if tc:
            # one call in a graph, replayed after q and eff are rewritten
            qr, effr = qv.clone(), effv.clone()
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out_g = wrap(qr, kc, vc, qpv, effr)
            qr.copy_(dev_t(rng.standard_normal((1, 1, Hq, Dl)), qd))
            effr[0, rng.choice(fill, 500, replace=False)] = lma.SENTINEL
            g.replay()
            torch.cuda.synchronize()
            replay = bool(torch.equal(out_g, wrap(qr, kc, vc, qpv, effr)))
            log(f"kernel K4 {kvname} cache: graph replay after q / eff "
                f"rewritten equals the eager call {replay}")
            if not replay:
                raise AssertionError(f"K4 over the {kvname} cache differs "
                                     "under graph replay")
            del g, out_g
        records.append({"name": f"K4_decode_attention_{suffix}",
                        "route": "cuda", "source": source,
                        "replaces": KERNELS[3][4],
                        "max_abs_err": max(v[3] for v in k4.values()),
                        "ms": msv, "plain_ms": plain, "bound_ms": bv[0],
                        "bound_by": bv[1], "library_ms": None})
        del kc, vc, kq, vq, k4
        torch.cuda.empty_cache()
    for f8 in (torch.float8_e4m3fn, torch.float8_e5m2):
        fp8_widening_exact(dev, f8, rng)
    return records, timings


# ---------------------------------------------------------------------------
# phase 4: tiny session, kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------

def run_tiny_session(model, cfg, device, **kw):
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.runtime.session import StreamingSession

    tok = ByteTokenizer(image_token_id=cfg.image_token_index)
    sess = StreamingSession(model.to(device), cfg, tok, max_len=2048, **kw)
    rng = np.random.default_rng(0)
    t, gh, gw = 3, 4, 4
    pv = rng.integers(0, 256, (t * gh * gw, 3 * 14 * 14), dtype=np.uint8)
    out = []
    for stamps, q, mode in (([0.0, 1.0, 2.0], "what is happening?", "AC"),
                            ([3.0, 4.0, 5.0], "and now?", "FCC")):
        sess.append_stream_segment(pv, (t, gh, gw), 2, timestamps=stamps)
        r = sess.ask(q, mode=mode, max_new_tokens=8)
        out.append((r["tokens"], r["selection"]))
    return out, [(r.kind, r.start, r.end) for r in sess.ranges], sess


def check_reference(dev):
    import copy
    import dataclasses

    import torch

    from cogstream_tpu_torch.config import CogReasonerConfig, CompressionConfig
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params

    cfg = dataclasses.replace(
        CogReasonerConfig.tiny(),
        compression=CompressionConfig(frames_per_event=3,
                                      keyframes_per_event=1,
                                      min_events_for_compression=1,
                                      similarity_threshold=2.0))
    cpu_model = init_cogreasoner_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
    gpu_model = copy.deepcopy(cpu_model)
    ref, ref_ranges, ref_sess = run_tiny_session(cpu_model, cfg, "cpu")
    got, got_ranges, got_sess = run_tiny_session(gpu_model, cfg, dev)
    err = (got_sess.cache.k.float().cpu() - ref_sess.cache.k).abs().max().item()
    log(f"reference: tiny session tokens {got} vs cpu {ref}; ranges equal "
        f"{got_ranges == ref_ranges}; cache k max_abs_err {err:.3g}")
    if got != ref or got_ranges != ref_ranges or not err <= 1e-4:
        raise AssertionError("tiny session on the card disagrees with the "
                             "plain versions on the CPU")


def run_tiny_lookahead(model, cfg, device, k: int):
    """The tiny two-turn dialogue (AC, FCC; 16 greedy tokens a turn) with
    ``lookahead_k=k`` on ``device`` (k = 0: the vanilla decoder). Returns
    ([(tokens, verify steps)] per turn, the session, the forwards' token
    counts on ``device``)."""
    from cogstream_tpu_torch.models import qwen2
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.runtime import session as sess_mod

    tok = ByteTokenizer(image_token_id=cfg.image_token_index)
    sess = sess_mod.StreamingSession(model.to(device), cfg, tok,
                                     max_len=2048)
    rng = np.random.default_rng(0)
    t, gh, gw = 3, 4, 4
    pv = rng.integers(0, 256, (t * gh * gw, 3 * 14 * 14), dtype=np.uint8)
    fwd, la, sizes, inside = (qwen2.qwen2_forward,
                              sess_mod.generate_tokens_lookahead, [], [])

    def counted(text, embeds, *a, **kw):
        if inside:        # the lookahead decoder's forwards only
            sizes.append(embeds.shape[1])
        return fwd(text, embeds, *a, **kw)

    def lookahead(*a, **kw):
        inside.append(1)
        try:
            return la(*a, **kw)
        finally:
            inside.pop()

    qwen2.qwen2_forward = counted
    sess_mod.generate_tokens_lookahead = lookahead
    out = []
    try:
        for stamps, q, mode in (([0.0, 1.0, 2.0], "what is happening?",
                                 "AC"),
                                ([3.0, 4.0, 5.0], "and now?", "FCC")):
            sess.append_stream_segment(pv, (t, gh, gw), 2, timestamps=stamps)
            r = sess.ask(q, mode=mode, max_new_tokens=16, lookahead_k=k)
            out.append((r["tokens"], sess.last_lookahead_steps if k else 0))
    finally:
        qwen2.qwen2_forward = fwd
        sess_mod.generate_tokens_lookahead = la
    return out, sess, sizes


def check_reference_lookahead(dev):
    """Phase 4, lookahead: the tiny f32 dialogue with lookahead_k = 2 (K4
    verifies, S = 3) and 8 (K3 verifies, S = 9) on the card and on the
    CPU: the same tokens and verify steps each turn; on the card the
    tokens equal the same dialogue's vanilla greedy ones, and the cache
    equals the vanilla cache wherever pos >= 0 (positions and write index
    exact, K/V within 1e-4: f32, another summation order)."""
    import copy
    import dataclasses

    import torch

    from cogstream_tpu_torch.config import CogReasonerConfig, CompressionConfig
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params
    from cogstream_tpu_torch.ops import lm_attention as lma

    cfg = dataclasses.replace(
        CogReasonerConfig.tiny(),
        compression=CompressionConfig(frames_per_event=3,
                                      keyframes_per_event=1))
    cpu_model = init_cogreasoner_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
    gpu_model = copy.deepcopy(cpu_model)
    van, van_sess, _ = run_tiny_lookahead(gpu_model, cfg, dev, 0)
    L = cfg.text.num_hidden_layers
    for k in (2, 8):
        ref, _, _ = run_tiny_lookahead(cpu_model, cfg, "cpu", k)
        n0 = (lma.decode_attention.launches,
              lma.prefill_flash_attention.launches)
        got, sess, sizes = run_tiny_lookahead(gpu_model, cfg, dev, k)
        k4 = lma.decode_attention.launches - n0[0]
        k3 = lma.prefill_flash_attention.launches - n0[1]
        steps = sum(n for _, n in got)
        verifies = sizes.count(k + 1)
        live = sess.cache.pos[0] >= 0
        same_pos = bool(torch.equal(sess.cache.pos, van_sess.cache.pos)) \
            and sess.write_index == van_sess.write_index
        err = max((a[:, :, live] - b[:, :, live]).abs().max().item()
                  for a, b in ((sess.cache.k, van_sess.cache.k),
                               (sess.cache.v, van_sess.cache.v)))
        tokens_vanilla = [t for t, _ in got] == [t for t, _ in van]
        log(f"reference lookahead k={k}: tiny dialogue (tokens, steps) "
            f"{got} vs cpu {ref}; tokens equal the vanilla dialogue's "
            f"{tokens_vanilla}; cache positions and write index equal "
            f"{same_pos}, live K/V max_abs_err {err:.3g}; {verifies} verify "
            f"forwards (S={k + 1}); card launches K3 {k3}, K4 {k4}")
        verify_launches = k4 if k + 1 <= lma.DECODE_MAX_S else k3
        if got != ref or not tokens_vanilla or not same_pos \
                or not err <= 1e-4 or verifies != steps or steps == 0 \
                or verify_launches < L * verifies:
            raise AssertionError(f"tiny lookahead dialogue (k={k}) on the "
                                 "card disagrees with the CPU or with the "
                                 "vanilla decoder")


def run_tiny_pool(model, cfg, device):
    """A tiny 3-row SessionPool on ``device``: one ingest_batch tick,
    ask_batch AC then FCC on every row, a solo ask on row 1, ask_stream
    on row 2. Returns (answers, per-row slot ranges, cache positions)."""
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.runtime.pool import SessionPool

    tok = ByteTokenizer(image_token_id=cfg.image_token_index)
    pool = SessionPool(model.to(device), cfg, tok, n_rows=3, max_len=1024)
    rng = np.random.default_rng(0)
    t, gh, gw = 3, 4, 4
    for _ in range(3):
        pool.open()
    pool.ingest_batch([(b, rng.integers(0, 256, (t * gh * gw, 3 * 14 * 14),
                                        dtype=np.uint8),
                        (t, gh, gw), 2, [0.0, 1.0, 2.0]) for b in range(3)])
    out = [pool.ask_batch([(b, f"what is in view {b}?") for b in range(3)],
                          mode=m, max_new_tokens=8) for m in ("AC", "FCC")]
    out.append(pool.ask(1, "and then?", mode="FCC", max_new_tokens=8))
    out.append(list(pool.sessions[2].ask_stream("more?", mode="AC",
                                                max_new_tokens=8, chunk=3)))
    ranges = [[(r.kind, r.start, r.end) for r in pool.sessions[b].ranges]
              for b in range(3)]
    return out, ranges, pool.cache.pos.cpu()


def check_reference_fp8(dev):
    """Phase 4, the caches in another dtype: the tiny f32 session
    (check_reference's) with ``kv_dtype`` e4m3, e5m2 and bf16 on the card
    (K3 / K4's f32 tile reading the cache) and on the CPU (the plain
    versions): the same greedy tokens, selections and slot ranges; the
    cache where pos >= 0 equal in at least 99.5% of elements, the rest one
    step of the cache dtype apart (a ~1e-6 difference of the f32 keys flips
    a rounding only next to a tie, and a flip moves later layers' keys by
    ~1e-3 of the row, which flips a few more: tests/test_torch_fp8kv.py
    found 99.84% in an e4m3 pool). K3 and K4 are counted by cache dtype
    from zero just before the card's session and read just after: each must
    have launched. Returns {cache dtype name: (K3, K4 launches)}; the bf16
    cache's are the f32 route's over bf16 (the f32 decoder's session is
    that route's path)."""
    import copy
    import dataclasses

    import torch

    from cogstream_tpu_torch.config import CogReasonerConfig, CompressionConfig
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params
    from cogstream_tpu_torch.ops import lm_attention as lma

    cfg = dataclasses.replace(
        CogReasonerConfig.tiny(),
        compression=CompressionConfig(frames_per_event=3,
                                      keyframes_per_event=1,
                                      min_events_for_compression=1,
                                      similarity_threshold=2.0))
    cpu_model = init_cogreasoner_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
    gpu_model = copy.deepcopy(cpu_model)
    wraps = (lma.prefill_flash_attention, lma.decode_attention)
    # mantissa bits and smallest normal exponent: one step at |x| is
    # 2^(max(floor(log2 |x|), emin) - bits)
    formats = {"float8_e4m3fn": (3, -6), "float8_e5m2": (2, -14),
               "bfloat16": (7, -126)}
    launches = {}
    for name, (bits, emin) in formats.items():
        kd = getattr(torch, name)
        ref, ref_ranges, ref_sess = run_tiny_session(cpu_model, cfg, "cpu",
                                                     kv_dtype=kd)
        for w in wraps:
            w.kv_launches = {}
        got, got_ranges, got_sess = run_tiny_session(gpu_model, cfg, dev,
                                                     kv_dtype=kd)
        used = tuple(w.kv_launches.get(name, 0) for w in wraps)
        launches[name] = used
        live = ref_sess.cache.pos[0] >= 0
        shares, steps = [], []
        for n in ("k", "v"):
            a = getattr(got_sess.cache, n).cpu()[:, 0, live].float()
            b = getattr(ref_sess.cache, n)[:, 0, live].float()
            shares.append((a == b).float().mean().item())
            step = torch.exp2(torch.floor(torch.log2(b.abs())).clamp_min(
                emin) - bits)
            steps.append(((a - b).abs() / step).max().item())
        log(f"reference: tiny f32 session over a {name} cache, tokens {got} "
            f"vs cpu {ref}; ranges equal {got_ranges == ref_ranges}; K / V "
            f"equal where pos >= 0 in {shares} of elements, the rest within "
            f"{steps} steps of {name}; launches over it (K3, K4) {used}")
        if got != ref or got_ranges != ref_ranges or min(shares) < 0.995 \
                or max(steps) > 1 or min(used) == 0:
            raise AssertionError(f"the tiny session over a {name} cache on "
                                 "the card disagrees with the plain versions"
                                 " on the CPU")
    return launches


def check_reference_pool(dev):
    """Phase 4, pooled: the tiny f32 pool on the card (K1-K4, K3 / K4
    reading the pool through ``rows``) and on the CPU; greedy tokens,
    selections, slot ranges and cache positions must agree."""
    import copy

    import torch

    from cogstream_tpu_torch.config import CogReasonerConfig
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params
    from cogstream_tpu_torch.ops import lm_attention as lma

    cfg = CogReasonerConfig.tiny()
    cpu_model = init_cogreasoner_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
    gpu_model = copy.deepcopy(cpu_model)
    ref = run_tiny_pool(cpu_model, cfg, "cpu")
    r0 = (lma.prefill_flash_attention.rows_launches,
          lma.decode_attention.rows_launches)
    got = run_tiny_pool(gpu_model, cfg, dev)
    rows = (lma.prefill_flash_attention.rows_launches - r0[0],
            lma.decode_attention.rows_launches - r0[1])
    same = (got[0] == ref[0], got[1] == ref[1], torch.equal(got[2], ref[2]))
    log(f"reference pool: tiny 3-row pool answers equal {same[0]}, ranges "
        f"equal {same[1]}, cache positions equal {same[2]}; K3 / K4 rows "
        f"launches on the card {rows}; last answers {got[0][2]['tokens']} "
        f"vs cpu {ref[0][2]['tokens']}")
    if not all(same) or min(rows) == 0:
        raise AssertionError("tiny pool on the card disagrees with the "
                             "plain versions on the CPU")


def tiny_int4_cfg():
    """The tiny session config with the int4 parity test's text widths
    (tests/test_torch_quant.py) and W4A8 decode."""
    import dataclasses

    from cogstream_tpu_torch.config import CogReasonerConfig, CompressionConfig

    cfg = CogReasonerConfig.tiny()
    return dataclasses.replace(
        cfg, compression=CompressionConfig(frames_per_event=3,
                                           keyframes_per_event=1,
                                           min_events_for_compression=1,
                                           similarity_threshold=2.0),
        text=dataclasses.replace(cfg.text, hidden_size=256,
                                 intermediate_size=512,
                                 num_attention_heads=4,
                                 num_key_value_heads=2, vocab_size=1024,
                                 w4a8_decode=True))


def check_reference_int4(dev):
    """The tiny session on a rank-1 uniform int4 decoder with W4A8
    decode: K6-K9 on the card against their plain versions on the CPU.
    Tokens, selections and slot ranges must agree; cache K/V within 1e-2
    of each row's max |ref| (the GEMVs round activations to bf16 / int8,
    so an f32 summation-order difference upstream can flip one rounding;
    tests/test_torch_quant.py)."""
    import copy

    import torch

    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params
    from cogstream_tpu_torch.ops.quant import quantize_text_

    cfg = tiny_int4_cfg()
    cpu_model = init_cogreasoner_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
    quantize_text_(cpu_model.text)
    gpu_model = copy.deepcopy(cpu_model)
    before = [wrapper(i).launches for i in INT4_PATH]
    ref, ref_ranges, ref_sess = run_tiny_session(cpu_model, cfg, "cpu")
    got, got_ranges, got_sess = run_tiny_session(gpu_model, cfg, dev)
    launched = [wrapper(i).launches - b for i, b in zip(INT4_PATH, before)]
    wi = ref_sess.write_index
    ratio = 0.0
    for a, b in ((got_sess.cache.k, ref_sess.cache.k),
                 (got_sess.cache.v, ref_sess.cache.v)):
        a, b = a[:, :, :wi].float().cpu(), b[:, :, :wi]
        bound = 1e-2 * b.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        ratio = max(ratio, ((a - b).abs() / bound).max().item())
    log(f"reference int4: tiny W4A8 session tokens {got} vs cpu {ref}; "
        f"ranges equal {got_ranges == ref_ranges}; cache K/V worst row at "
        f"{ratio:.3g} of its bound; card launches K6-K9 {launched}")
    if got != ref or got_ranges != ref_ranges or not ratio <= 1.0 \
            or min(launched) == 0:
        raise AssertionError("tiny int4 session on the card disagrees with "
                             "the plain versions on the CPU")


def check_reference_int8(dev):
    """The tiny session (f32, the int4 check's text widths) on a
    per-channel int8 decoder with w8a8_prefill and the W8A8 tower
    (encoder_int8): K10 (its f32 route) and ``torch._int_mm`` on the card
    against the plain versions on the CPU. Tokens, selections and slot
    ranges must agree and K10 must launch; the cache K/V within 5e-2 of
    each row's max |ref| (int8 activations turn an f32 summation-order
    difference upstream into whole rounding steps;
    tests/test_torch_quant_modes.py measured 2.5e-2 against JAX)."""
    import copy
    import dataclasses

    import torch

    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params
    from cogstream_tpu_torch.ops import quant

    cfg = tiny_int4_cfg()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, w4a8_decode=False, w8a8_prefill=True))
    cpu_model = init_cogreasoner_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
    quant.quantize_text_(cpu_model.text, bits=8)
    gpu_model = copy.deepcopy(cpu_model)
    ref, ref_ranges, ref_sess = run_tiny_session(cpu_model, cfg, "cpu",
                                                 encoder_int8=True)
    n0, mm0 = wrapper(9).launches, dict(quant.int8_mm.calls)
    got, got_ranges, got_sess = run_tiny_session(gpu_model, cfg, dev,
                                                 encoder_int8=True)
    k10 = wrapper(9).launches - n0
    mm = {k: v - mm0.get(k, 0) for k, v in quant.int8_mm.calls.items()}
    wi = ref_sess.write_index
    ratio = 0.0
    for a, b in ((got_sess.cache.k, ref_sess.cache.k),
                 (got_sess.cache.v, ref_sess.cache.v)):
        a, b = a[:, :, :wi].float().cpu(), b[:, :, :wi]
        bound = 5e-2 * b.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        ratio = max(ratio, ((a - b).abs() / bound).max().item())
    log(f"reference int8: tiny W8A8 session (encoder_int8) tokens {got} vs "
        f"cpu {ref}; ranges equal {got_ranges == ref_ranges}; cache K/V "
        f"worst row at {ratio:.3g} of its bound; card K10 launches {k10}, "
        f"_int_mm calls {mm}")
    if got != ref or got_ranges != ref_ranges or not ratio <= 1.0 \
            or k10 == 0 or min(mm.get("decoder", 0), mm.get("tower", 0)) == 0:
        raise AssertionError("tiny int8 session on the card disagrees with "
                             "the plain versions on the CPU")


TRAIN_DIR = os.path.join(REPO, "build", "chip_smoke_train")


def _fresh_dir(name: str) -> str:
    import shutil

    path = os.path.join(TRAIN_DIR, name)
    shutil.rmtree(path, ignore_errors=True)
    return path


def _selector_samples(rng, n: int, words: int = 6):
    """Seeded selector samples: random-word questions with 2-4 history
    QAs, relevance and visual flags (the stage-1 data layout)."""
    from cogstream_tpu_torch.train.data import SelectorSample

    vocab = ["red", "cup", "falls", "table", "why", "when", "person", "door",
             "opens", "car", "street", "left", "right", "light", "dog"]

    def text():
        return " ".join(rng.choice(vocab, words)) + "?"

    out = []
    for _ in range(n):
        h = int(rng.integers(2, 5))
        rel = sorted(int(i) for i in rng.choice(h, int(rng.integers(0, h)),
                                                replace=False))
        out.append(SelectorSample(text(), [text() for _ in range(h)],
                                  [text() for _ in range(h)], rel,
                                  bool(rng.integers(0, 2))))
    return out


def _stage2_turn(rng, tok, cfg, t: int, gh: int, gw: int, ms: int,
                 max_seq_len: int, pool: bool = False):
    """A packed stage-2 turn: ``t`` frames of gh x gw patches (seeded
    normalized pixel rows), one ``<image>`` per merged token, a question
    and an answer; with ``pool`` the second frame is minor (only its
    first token kept, the frame mean-pooled into it)."""
    import types

    from cogstream_tpu_torch.train.stage2 import pack_turn_batch

    merged = (gh // ms) * (gw // ms)
    images = types.SimpleNamespace(
        pixel_values=rng.standard_normal(
            (t * gh * gw, 3 * 14 * 14)).astype(np.float32),
        grid_sizes=np.array([[t, gh, gw]]), merge_sizes=np.array([ms]))
    frames = "".join(f"Time {f:.1f}s:" + "<image>" * merged
                     for f in range(t))
    prompt = ("<|im_start|>user\n<|stream_start|>" + frames +
              "<|stream_end|>What happens in the clip?<|im_end|>\n"
              "<|im_start|>assistant\n")
    keep = minor = None
    if pool:
        keep = np.ones((t * merged,), bool)
        keep[merged + 1:2 * merged] = False
        minor = np.zeros(t, bool)
        minor[1] = True
    return pack_turn_batch(tok, cfg, prompt, "A person opens the door.",
                           images, keep, max_seq_len, minor_frames=minor)


def _adapters_vs(got_tree, ref_tree, lr: float):
    """Updated adapters in units of lr (tests/test_torch_train.py), leaf by
    leaf path: the worst element and the share of elements beyond 1e-3
    lr."""
    from cogstream_tpu_torch.models.lora import iter_leaves

    g, r = dict(iter_leaves(got_tree)), dict(iter_leaves(ref_tree))
    if g.keys() != r.keys():
        raise AssertionError(f"LoRA trees differ: {sorted(g)[:3]} vs "
                             f"{sorted(r)[:3]}")
    d = np.concatenate([(g[k].detach().float().cpu() - r[k].detach().float()
                         .cpu()).abs().reshape(-1).numpy() for k in r])
    return float(d.max() / lr), float(np.mean(d > 1e-3 * lr))


def check_training_reference(dev):
    """Tiny training (f32, dropout 0) on the card against the CPU: the
    same init_cogreasoner_params weights and the same LoRA init on both.
    Two train_stage1 steps (logged losses within the log's 4 decimals)
    and two Stage2Trainer turns (one with a pooling plan, one text-only;
    losses rtol 1e-5); updated adapters within 2.01 lr everywhere and
    1e-3 lr on at least 99% of the elements (tests/test_torch_train.py's
    bounds). K5 runs in the card's stage-2 tower."""
    import copy

    import torch

    from cogstream_tpu_torch.config import CogReasonerConfig, LoRAConfig
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params
    from cogstream_tpu_torch.models.lora import (init_cogreasoner_lora,
                                                 map_leaves)
    from cogstream_tpu_torch.ops import flash_attention as fa
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.train import stage1, stage2

    cfg = CogReasonerConfig.tiny()
    tok = ByteTokenizer(image_token_id=cfg.image_token_index)
    lc = LoRAConfig(dropout=0.0, include_projector=True)
    cpu_model = init_cogreasoner_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
    lora0 = init_cogreasoner_lora(torch.Generator().manual_seed(1), cfg, lc,
                                  device="cpu")

    def lora_on(device):
        return map_leaves(
            lambda t: t.detach().clone().to(device).requires_grad_(True),
            lora0)

    samples = _selector_samples(np.random.default_rng(0), 3)
    scfg = stage1.Stage1Config(epochs=2, batch_size=3, max_len=2048,
                               grad_accum=1, warmup_steps=1, save_every=1000,
                               log_every=1, shuffle_copies=1,
                               include_demo=False, learning_rate=1e-3)
    s2cfg = stage2.Stage2Config(max_seq_len=2048, grad_accum=1,
                                save_every=10_000, learning_rate=1e-3)
    rng = np.random.default_rng(1)
    turns = [_stage2_turn(rng, tok, cfg, 2, 4, 4, 2, 2048, pool=True),
             stage2.pack_turn_batch(tok, cfg, "<|im_start|>user\nhi?"
                                    "<|im_end|>\n", "yes", None, None, 2048)]
    out = {}
    for name, model in (("cpu", cpu_model),
                        ("card", copy.deepcopy(cpu_model).to(dev))):
        k5 = fa.segment_flash_attention.launches
        logs = []
        st1 = stage1.train_stage1(
            model.text, cfg, tok, samples, _fresh_dir(f"s1_{name}"), scfg,
            resume=False, log=logs.append, lora_cfg=lc,
            lora=lora_on(model.text.device)["text"])
        losses1 = [float(m.split(" loss ")[1].split()[0]) for m in logs
                   if " loss " in m]
        trainer = stage2.Stage2Trainer(
            model, cfg, tok, s2cfg, _fresh_dir(f"s2_{name}"), total_steps=20,
            log=lambda *a: None, lora_cfg=lc, lora=lora_on(model.text.device))
        losses2 = [trainer.train_turn(dict(b)) for b in turns]
        out[name] = (losses1, st1.lora, losses2, trainer.state.lora)
        k5 = fa.segment_flash_attention.launches - k5   # the card's run
    (l1c, a1c, l2c, a2c), (l1g, a1g, l2g, a2g) = out["cpu"], out["card"]
    d1 = _adapters_vs(a1g, a1c, 1e-3)
    d2 = _adapters_vs(a2g, a2c, 1e-3)
    ok1 = len(l1g) == len(l1c) == 2 and all(
        abs(a - b) <= 1.1e-4 for a, b in zip(l1g, l1c))
    ok2 = all(abs(a - b) <= 1e-5 * abs(b) + 1e-6 for a, b in zip(l2g, l2c))
    log(f"reference training: stage-1 losses card {l1g} cpu {l1c}; stage-2 "
        f"losses card {[f'{x:.7g}' for x in l2g]} cpu "
        f"{[f'{x:.7g}' for x in l2c]}; adapters (worst / lr, share beyond "
        f"1e-3 lr) stage 1 {d1}, stage 2 {d2}; K5 launches {k5}")
    if not (ok1 and ok2 and d1[0] <= 2.01 and d1[1] < 0.01 and d2[0] <= 2.01
            and d2[1] < 0.01 and k5 == 2 * cfg.vision.num_hidden_layers):
        raise AssertionError("tiny training on the card disagrees with the "
                             "CPU")


def check_gemv_backward(dev):
    """The backward each GEMV wrapper carries (a LoRA turn on a frozen
    quantized base reaches them at m <= 64): K6 and K7 on a 2D rank-1
    gate_proj (3584 -> 18944), K8 and K9 on two stacked such layers
    (layer 1), K10 on the int8 gate_proj, 2D and stacked; 64 bf16 rows.
    Each forward must launch its kernel, and ``dx`` must equal the f32
    product of ``g`` and the weights the backward dequantizes (JAX's
    transpose of the XLA form: ``g @ W_deq^T``, rank-1 per packed half
    with the row scales after) within the 2-ulp row rule; the frozen
    weights require no gradient."""
    import torch

    from cogstream_tpu_torch.ops import int8_gemv, quant, quant_gemv

    rng = np.random.default_rng(11)
    gen = torch.Generator(device=dev).manual_seed(11)
    din, dout, m = 3584, 18944, 64
    r1 = _int4_store(rng, dev, (2, din // 2, dout))
    i8 = _int8_store(dev, (2, din, dout), 12)
    layer = torch.tensor([1], dtype=torch.int32, device=dev)

    def two_d(qp):
        return {k: v[1] for k, v in qp.items()}

    def rank1_ref(g, qp):
        prep = quant.materialize_split(qp, torch.bfloat16)
        half = din // 2
        return torch.cat([(g.float() @ prep[w].float().t())
                          * prep["rscale"][sl] for w, sl in
                          (("wl", slice(0, half)), ("wh", slice(half, din)))],
                         dim=-1)

    def int8_ref(g, qp):
        w = (qp["q"].float() * qp["scale"][None, :]).bfloat16().float()
        return g.float() @ w.t()

    cases = [
        ("K6", 5, lambda x: quant_gemv.int4_rank1_gemv(x, two_d(r1)),
         lambda g: rank1_ref(g, two_d(r1))),
        ("K7", 6, lambda x: quant_gemv.int4_rank1_gemv(x, two_d(r1),
                                                       w4a8=True),
         lambda g: rank1_ref(g, two_d(r1))),
        ("K8", 7, lambda x: quant_gemv.int4_rank1_gemv_stacked(x, r1, layer),
         lambda g: rank1_ref(g, two_d(r1))),
        ("K9", 8, lambda x: quant_gemv.int4_rank1_gemv_stacked(
            x, r1, layer, w4a8=True), lambda g: rank1_ref(g, two_d(r1))),
        ("K10", 9, lambda x: int8_gemv.int8_gemv(x, two_d(i8)),
         lambda g: int8_ref(g, two_d(i8))),
        ("K10 stacked", 9, lambda x: int8_gemv.int8_gemv(
            x, {**i8, "layer": layer}), lambda g: int8_ref(g, two_d(i8))),
    ]
    worst, ok = {}, True
    for name, idx, fwd, ref in cases:
        x = torch.randn((m, din), generator=gen, device=dev,
                        dtype=torch.bfloat16).requires_grad_(True)
        g = torch.randn((m, dout), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        n0 = wrapper(idx).launches
        y = fwd(x)
        launched = wrapper(idx).launches - n0
        y.backward(g)
        _, ratio = row_check(x.grad, ref(g), din)
        worst[name] = (launched, round(ratio, 3))
        ok &= launched == 1 and ratio <= 1.0 and x.grad.dtype == x.dtype
    ok &= not any(t.requires_grad for qp in (r1, i8) for t in qp.values())
    log(f"reference GEMV backward: (forward launches, dx worst row / its "
        f"2-ulp bound) {worst}")
    if not ok:
        raise AssertionError("a GEMV kernel's backward disagrees with the "
                             "dequantized product")


def check_qlora_reference(dev):
    """Tiny QLoRA (f32, dropout 0) on the card against the CPU: the tiny
    config with the int4 check's 128-multiple text widths, the same
    ``init_cogreasoner_params`` weights quantized whole by
    ``quantize_cogreasoner_`` (NF4, then int8 with ``w8a8_prefill``, the
    stage-2 ``--w8a8-forward``) and the same LoRA init on both. Two
    ``Stage2Trainer`` turns each (a packed visual turn with a pooling plan,
    128 tokens, and a text-only turn of 64, where the int8 lm_head runs K10
    under autograd). NF4: losses rtol 1e-5, adapters within 2.01 lr and
    1e-3 lr on 99% of the elements (tests/test_torch_train.py's bounds);
    int8 + W8A8: losses within 1e-3 relative, adapters within 2.01 lr (the
    card's f32 GEMMs differ from the CPU's upstream, and such a difference
    can flip an int8 activation rounding: 5.2e-5 relative measured on an
    H100, where the CPU packages agree to 6.6e-8). K5 must run in the
    card's tower and K10 in the int8 run."""
    import copy
    import dataclasses

    import torch

    from cogstream_tpu_torch.config import LoRAConfig
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params
    from cogstream_tpu_torch.models.lora import (init_cogreasoner_lora,
                                                 map_leaves)
    from cogstream_tpu_torch.ops import flash_attention as fa
    from cogstream_tpu_torch.ops.quant import quantize_cogreasoner_
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.train import stage2

    base = tiny_int4_cfg()
    base = dataclasses.replace(base, text=dataclasses.replace(
        base.text, w4a8_decode=False))
    tok = ByteTokenizer(image_token_id=base.image_token_index)
    lc = LoRAConfig(dropout=0.0, include_projector=True)
    lora0 = init_cogreasoner_lora(torch.Generator().manual_seed(1), base, lc,
                                  device="cpu")
    s2cfg = stage2.Stage2Config(max_seq_len=2048, grad_accum=1,
                                save_every=10_000, learning_rate=1e-3)
    rng = np.random.default_rng(1)
    turns = [_stage2_turn(rng, tok, base, 2, 4, 4, 2, 2048, pool=True),
             stage2.pack_turn_batch(tok, base, "<|im_start|>user\nhi?"
                                    "<|im_end|>\n", "yes", None, None, 2048)]
    assert turns[1]["input_ids"].shape == (1, 64)     # K10's m <= 64
    ok = True
    for scheme, bits, w8 in (("nf4", 4, False), ("int8+w8a8", 8, True)):
        cfg = dataclasses.replace(base, text=dataclasses.replace(
            base.text, w8a8_prefill=w8))
        cpu_model = init_cogreasoner_params(
            base, torch.Generator().manual_seed(0), device="cpu")
        quantize_cogreasoner_(cpu_model, bits)
        out = {}
        for name, model in (("cpu", cpu_model),
                            ("card", copy.deepcopy(cpu_model).to(dev))):
            k5, k10 = (fa.segment_flash_attention.launches,
                       wrapper(9).launches)
            trainer = stage2.Stage2Trainer(
                model, cfg, tok, s2cfg, _fresh_dir(f"q_{scheme}_{name}"),
                total_steps=20, log=lambda *a: None, lora_cfg=lc,
                lora=map_leaves(lambda t: t.detach().clone().to(
                    model.text.device).requires_grad_(True), lora0))
            losses = [trainer.train_turn(dict(b)) for b in turns]
            out[name] = (losses, trainer.state.lora)
            k5 = fa.segment_flash_attention.launches - k5  # the card's run
            k10 = wrapper(9).launches - k10
        (lc_, ac), (lg, ag) = out["cpu"], out["card"]
        d = _adapters_vs(ag, ac, 1e-3)
        rtol = 1e-3 if w8 else 1e-5
        ok_s = all(abs(a - b) <= rtol * abs(b) + 1e-6 for a, b in
                   zip(lg, lc_)) and d[0] <= 2.01 \
            and (w8 or d[1] < 0.01) \
            and k5 == 2 * base.vision.num_hidden_layers \
            and (bits == 4 or k10 > 0)
        log(f"reference QLoRA {scheme}: stage-2 losses card "
            f"{[f'{x:.7g}' for x in lg]} cpu {[f'{x:.7g}' for x in lc_]}; "
            f"adapters (worst / lr, share beyond 1e-3 lr) {d}; card K5 "
            f"launches {k5}, K10 launches {k10}")
        ok &= ok_s
    if not ok:
        raise AssertionError("tiny QLoRA on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# phase 5: the 7B-width main path
# ---------------------------------------------------------------------------

class PhaseTimer:
    """Wraps the session's device entry points with synchronized wall
    clocks (instrumentation of this script only)."""

    def __init__(self):
        import torch

        from cogstream_tpu_torch.models import qwen2
        from cogstream_tpu_torch.runtime import session as sess_mod

        self.torch = torch
        self.forwards = []        # (S, t_start, t_end)
        self.logits = []          # (t_start, t_end)
        self.encode_s = []
        fwd, enc = qwen2.qwen2_forward, sess_mod.encode_images
        head = qwen2.lm_logits

        def timed_forward(model, embeds, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fwd(model, embeds, *a, **k)
            torch.cuda.synchronize()
            self.forwards.append((embeds.shape[1], t0, time.perf_counter()))
            return out

        def timed_logits(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = head(*a, **k)
            torch.cuda.synchronize()
            self.logits.append((t0, time.perf_counter()))
            return out

        def timed_encode(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = enc(*a, **k)
            torch.cuda.synchronize()
            self.encode_s.append(time.perf_counter() - t0)
            return out

        qwen2.qwen2_forward = timed_forward
        qwen2.lm_logits = timed_logits
        sess_mod.encode_images = timed_encode
        self.restore = lambda: (setattr(qwen2, "qwen2_forward", fwd),
                                setattr(qwen2, "lm_logits", head),
                                setattr(sess_mod, "encode_images", enc))

    def mark(self):
        return len(self.forwards)

    def decode_rate(self, since: int) -> float:
        """Marginal decode tok/s: steps after the first decode step over
        the wall time between their starts (prefill never charged)."""
        starts = [t0 for S, t0, _ in self.forwards[since:] if S == 1]
        if len(starts) < 2:
            return float("nan")
        return (len(starts) - 1) / (starts[-1] - starts[0])

    def gen_rate(self, since: int, S_step: int, tokens: int,
                 t_end: float) -> float:
        """Decode tok/s: ``tokens`` (those after the first) over the wall
        from the start of the first ``S_step``-token forward after
        ``since`` (1: vanilla steps; k+1: lookahead verifies) to
        ``t_end``."""
        starts = [t0 for S, t0, _ in self.forwards[since:] if S == S_step]
        return tokens / (t_end - starts[0]) if starts else float("nan")

    def step_split(self, since: int, S_step: int = 1) -> str:
        """A decode step's wall (or a lookahead verify's, ``S_step`` =
        k+1), split into the forward, the lm_head logits and the rest of
        the loop between two forwards (sampling or the host's draft and
        accept, the done check, the next embedding): means in ms over the
        steps after ``since``."""
        dec = [(t0, t1) for S, t0, t1 in self.forwards[since:]
               if S == S_step]
        if len(dec) < 2:
            return "no decode steps"
        fwd = lg = rest = 0.0
        for (a0, a1), (b0, _) in zip(dec, dec[1:]):
            head = sum(t1 - t0 for t0, t1 in self.logits
                       if t0 >= a1 and t1 <= b0)
            fwd, lg, rest = fwd + a1 - a0, lg + head, rest + b0 - a1 - head
        n = len(dec) - 1
        return (f"step {1e3 * (dec[-1][0] - dec[0][0]) / n:.2f} ms = forward "
                f"{1e3 * fwd / n:.2f} + logits {1e3 * lg / n:.2f} + rest "
                f"{1e3 * rest / n:.2f}")


class LogitGaps:
    """The top-1 logit and its gap to the top-2 of the last row of every
    ``lm_logits`` call while installed, kept on the device and fetched
    once by ``read`` (instrumentation of this script only)."""

    def __init__(self):
        import torch

        from cogstream_tpu_torch.models import qwen2

        self.tops = []
        head = qwen2.lm_logits

        def spy(*a, **k):
            out = head(*a, **k)
            self.tops.append(torch.topk(out[0, -1].float(), 2).values)
            return out

        qwen2.lm_logits = spy
        self.restore = lambda: setattr(qwen2, "lm_logits", head)

    def read(self):
        import torch

        return [(a, a - b) for a, b in torch.stack(self.tops).cpu().tolist()]


def gap_rule(ref, got, tops):
    """Greedy tokens ``got`` held to ``ref`` (bf16 GEMMs at m = k+1 and at
    m = 1 may round differently): equal up to the first step whose top-1 /
    top-2 logit gap in the run that made ``ref`` (``tops``, LogitGaps) is
    within 2 bf16 ulps of its top-1 logit; from there they may part.
    Returns (ok, that step or None, its gap, the leading agreement)."""
    close = next((i for i, (top, gap) in enumerate(tops[:len(ref)])
                  if gap <= 2 * 2.0 ** (math.floor(math.log2(
                      max(abs(top), 1e-30))) - 7)), None)
    agree = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b),
                 min(len(ref), len(got)))
    ok = ref == got if close is None else agree >= close
    return ok, close, None if close is None else tops[close][1], agree


def parting_gap(tops, agree: int, n: int) -> str:
    """The reference run's top-1 / top-2 logit gap and top-1 at the step
    where two greedy sequences of ``n`` tokens first differ (or 'none')."""
    if agree >= min(n, len(tops)):
        return "none"
    top, gap = tops[agree]
    return f"gap {gap:.6g} at top-1 {top:.6g}"


LA_QUESTION = "Describe the last frame in detail."


def session_lookahead(sess, timer, stamp):
    """Phase 5 (a): the session after its FCC turn is saved, then asks a
    third question (AC, 32 tokens) four times from that state, restored
    before each: vanilla, lookahead_k=4, lookahead_k=4, vanilla (in turns,
    so each side has a neighbour from the same minute of the shared
    host). The lookahead tokens are held to the first vanilla ask's under
    :func:`gap_rule`, the second vanilla ask to the first exactly; prints
    the agreement, verify steps, the accepted-draft rate (random weights
    decide it), each ask's decode tok/s and its step split."""
    import torch

    snap = os.path.join(REPO, "build", "chip_smoke_lookahead.npz")
    os.makedirs(os.path.dirname(snap), exist_ok=True)
    k, n_new = 4, 32
    runs = []
    try:
        sess.save(snap)
        for i, la_k in enumerate((0, k, k, 0)):
            if i:
                sess.load_state(snap)
            gaps = LogitGaps() if i == 0 else None
            mark = timer.mark()
            t0 = time.perf_counter()
            try:
                r = sess.ask(LA_QUESTION, mode="AC", max_new_tokens=n_new,
                             lookahead_k=la_k)
                torch.cuda.synchronize()
            finally:
                if gaps is not None:
                    gaps.restore()
            t1 = time.perf_counter()
            S_step = la_k + 1
            runs.append({
                "k": la_k, "tokens": r["tokens"], "turn_s": t1 - t0,
                "tok_per_s": timer.gen_rate(mark, S_step,
                                            len(r["tokens"]) - 1, t1),
                "split": timer.step_split(mark, S_step),
                "steps": sess.last_lookahead_steps if la_k else None})
            if i == 0:
                tops = gaps.read()
    finally:
        if os.path.exists(snap):
            os.remove(snap)
    van = runs[0]["tokens"]
    ok = runs[3]["tokens"] == van
    for r in runs:
        kind = f"lookahead k={r['k']}" if r["k"] else "vanilla"
        log(f"main: third ask ({kind}): turn {r['turn_s']:.3f}s, decode "
            f"{r['tok_per_s']:.1f} tok/s; {r['split']} [{stamp}]")
    for r in runs[1:3]:
        n, steps = len(r["tokens"]), r["steps"]
        accepted = n - 1 - steps
        good, close, gap, agree = gap_rule(van, r["tokens"], tops)
        ok = ok and good and steps >= 1
        log(f"main: lookahead ask (AC, k={k}, restored): {n} tokens in "
            f"{steps} verify steps, {accepted} drafts accepted of "
            f"{steps * k} ({accepted / (steps * k):.3f}, random weights); "
            f"tokens agree with the vanilla ask's for {agree} of {len(van)}"
            f" (where they part: "
            f"{parting_gap(tops, agree, min(n, len(van)))}), first step "
            f"with a top-1/top-2 gap within 2 bf16 ulps: {close} (gap "
            f"{gap}) [{stamp}]")
    if not ok:
        raise AssertionError("the lookahead ask departs from the vanilla "
                             "greedy tokens before a close logit gap, or "
                             "the vanilla ask is not reproducible")
    la = runs[1]
    return {"la_steps": la["steps"], "la_tokens": len(la["tokens"]),
            "la_accept_rate": (len(la["tokens"]) - 1 - la["steps"])
            / (la["steps"] * k),
            "la_decode_tok_per_s": [r["tok_per_s"] for r in runs[1:3]],
            "la_vanilla_decode_tok_per_s": [runs[0]["tok_per_s"],
                                            runs[3]["tok_per_s"]],
            "la_turn_s": [r["turn_s"] for r in runs[1:3]],
            "la_vanilla_turn_s": [runs[0]["turn_s"], runs[3]["turn_s"]]}


def run_lookahead_schedule(text, dev, stamp):
    """Phase 5 (b): a fixed acceptance schedule on the 7B-width decoder. A
    seeded 512-token prompt in a fresh 1024-slot cache; its vanilla greedy
    71 tokens (eos_id=-1) are the teacher. ``generate_tokens_lookahead``
    with ``fixed_draft`` = teacher and ``fixed_accept`` 0, 2, 4 at k = 4
    and 7 at k = 7 emits 64 tokens, held to the teacher under
    :func:`gap_rule`: steps, wall s and decode tok/s beside the vanilla
    loop's, in two rounds taken in turns; then one verify step's cost (S
    = 5, 8) beside a decode step's on the same cache."""
    import torch

    from cogstream_tpu_torch.models import qwen2
    from cogstream_tpu_torch.runtime.generate import (
        generate_tokens, generate_tokens_lookahead)

    cfg = text.cfg
    rng = np.random.default_rng(11)
    S, n_new, slots = 512, 64, 1024
    ids = rng.integers(0, cfg.vocab_size, (1, S))
    emb = qwen2.embed(text, torch.as_tensor(ids, device=dev))
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
    last = torch.tensor([S - 1], device=dev)

    def cache():
        return qwen2.init_kv_cache(cfg, 1, slots, dtype=text.dtype,
                                   device=dev)

    def vanilla():
        mark = timer.mark()
        t0 = time.perf_counter()
        base = generate_tokens(text, emb, pos, last, cache(), None,
                               n_new + 7, -1)
        teacher = base.tokens[0].cpu()
        t1 = time.perf_counter()
        return teacher, t1 - t0, timer.gen_rate(mark, 1, n_new + 6, t1)

    timer = PhaseTimer()
    metrics = {}
    try:
        gaps = LogitGaps()
        try:
            teacher, _, _ = vanilla()     # the teacher and its logit gaps
        finally:
            gaps.restore()
        tops = gaps.read()
        ref = teacher[:n_new].tolist()
        # two rounds in turns (vanilla, then each schedule), so each rate
        # has a neighbour from the same minute of the shared host
        for rnd in (1, 2):
            again, wall, van_rate = vanilla()
            log(f"lookahead schedule, round {rnd}: vanilla loop {n_new + 7} "
                f"tokens after a {S}-token prompt in {wall:.3f}s, decode "
                f"{van_rate:.1f} tok/s; same tokens as the teacher "
                f"{bool(torch.equal(again, teacher))} [{stamp}]")
            metrics.setdefault("la_sched_vanilla_tok_per_s", []).append(
                van_rate)
            for k, acc in ((4, 0), (4, 2), (4, 4), (7, 7)):
                mark = timer.mark()
                t0 = time.perf_counter()
                r = generate_tokens_lookahead(
                    text, emb, pos, last, cache(), ids, n_new, -1,
                    lookahead_k=k, fixed_draft=teacher, fixed_accept=acc)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                rate = timer.gen_rate(mark, k + 1, n_new - 1, t1)
                ok, close, gap, agree = gap_rule(ref, r.tokens[0].tolist(),
                                                 tops)
                want = -(-(n_new - 1) // (acc + 1))
                log(f"lookahead schedule, round {rnd}, k={k} fixed_accept="
                    f"{acc}: {r.steps} verify steps (schedule {want}), "
                    f"{t1 - t0:.3f}s, decode {rate:.1f} tok/s vs vanilla "
                    f"{van_rate:.1f} ({rate / van_rate:.2f}x); tokens agree "
                    f"with the teacher for {agree} of {n_new} (where they "
                    f"part: {parting_gap(tops, agree, n_new)}), first "
                    f"close gap "
                    f"step {close} (gap {gap}) [{stamp}]")
                m = metrics.setdefault(f"la_sched_k{k}_a{acc}", {
                    "steps": [], "wall_s": [], "tok_per_s": []})
                for key, val in (("steps", r.steps), ("wall_s", t1 - t0),
                                 ("tok_per_s", rate)):
                    m[key].append(val)
                if not ok:
                    raise AssertionError("fixed-schedule lookahead departs "
                                         "from the teacher before a close "
                                         "logit gap")
    finally:
        timer.restore()
    for tokens in (1, 5, 8):
        n, dev_ms, wall_ms, _ = decode_step_cost(
            text, "bf16", stamp, tokens=tokens, head_rows=tokens,
            slots=slots, fill=S + n_new)
        metrics[f"la_step_S{tokens}"] = {"launches": n, "device_ms": dev_ms,
                                         "wall_ms": wall_ms}
    return metrics


MAIN_ANSWERS = {}   # phase 5's bf16 answer tokens by mode (AC, FCC)
MAIN_SEGMENTS = (16, 24, 42, 2)   # frames, grid h, grid w, merge


def main_segments():
    """Phase 5's two seeded 16-frame 24x42 segments of uint8 patch rows."""
    t, gh, gw, _ = MAIN_SEGMENTS
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (t * gh * gw, 3 * 14 * 14), dtype=np.uint8)
            for _ in range(2)]


def run_main_path(dev, stamp):
    import torch

    from cogstream_tpu_torch import presets
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.runtime.session import StreamingSession

    cfg = presets.cogreasoner_7b()
    t0 = time.perf_counter()
    model = init_cogreasoner_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"main: 7B-width model ({n_params / 1e9:.2f}B params bf16) "
        f"initialized in {time.perf_counter() - t0:.1f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    tok = ByteTokenizer(image_token_id=cfg.image_token_index,
                        vocab=cfg.text.vocab_size)
    timer = PhaseTimer()
    t, gh, gw, ms = MAIN_SEGMENTS
    segments = main_segments()

    for i in BF16_PATH:                    # count the main path only
        wrapper(i).launches = 0
    for i in TC_PATH:
        wrapper(i).tc_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_main = time.perf_counter()
    sess = StreamingSession(model, cfg, tok, max_len=16384)
    metrics = {}
    asks = [("What is happening in the video?", "AC"),
            ("What changed since then?", "FCC")]
    for seg_i, (pv, (question, mode)) in enumerate(zip(segments, asks)):
        mark = timer.mark()
        wi0 = sess.write_index
        t0 = time.perf_counter()
        sess.append_stream_segment(pv, (t, gh, gw), ms,
                                   timestamps=[float(seg_i * t + f)
                                               for f in range(t)])
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        pf = [(S, b - a) for S, a, b in timer.forwards[mark:] if S > 8]
        metrics[f"ingest{seg_i}_s"] = ingest_s
        metrics[f"encode{seg_i}_frames_per_s"] = t / timer.encode_s[-1]
        # the segment prefill is the first forward of the ingest; the rest
        # are the event-summary forwards
        metrics[f"ingest{seg_i}_prefill_tok_per_s"] = pf[0][0] / pf[0][1]
        log(f"main: ingest {seg_i}: {ingest_s:.3f}s; encode "
            f"{timer.encode_s[-1]:.3f}s ({t / timer.encode_s[-1]:.1f} frames/s); "
            f"prefill {pf[0][0]} tokens in {pf[0][1]:.3f}s "
            f"({pf[0][0] / pf[0][1]:.0f} tok/s); cache {wi0} -> "
            f"{sess.write_index} slots [{stamp}]")

        sel_s, after_sel = [], []
        select = sess.selector.select

        def timed_select(*a, **k):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            out = select(*a, **k)
            torch.cuda.synchronize()
            sel_s.append(time.perf_counter() - s0)
            after_sel.append(timer.mark())
            return out

        sess.selector.select = timed_select
        mark = timer.mark()
        t0 = time.perf_counter()
        r = sess.ask(question, mode=mode, max_new_tokens=32)
        torch.cuda.synchronize()
        turn_s = time.perf_counter() - t0
        sess.selector.select = select
        # the answer's decode steps only (not the selector's)
        dec = timer.decode_rate(after_sel[0] if after_sel else mark)
        metrics[f"{mode}_turn_s"] = turn_s
        metrics[f"{mode}_decode_tok_per_s"] = dec
        if sel_s:
            metrics["selector_s"] = sel_s[0]
        log(f"main: ask {mode}: turn {turn_s:.3f}s; selector "
            f"{(sel_s[0] if sel_s else 0.0):.3f}s (selection "
            f"{r['selection']!r}); {len(r['tokens'])} tokens, marginal "
            f"decode {dec:.1f} tok/s; "
            f"{timer.step_split(after_sel[0] if after_sel else mark)} "
            f"[{stamp}]")
        toks = r["tokens"]
        MAIN_ANSWERS[mode] = toks
        if not (toks and all(0 <= x < cfg.text.vocab_size for x in toks)):
            raise AssertionError(f"bad answer tokens {toks}")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    metrics.update(session_lookahead(sess, timer, stamp))
    launches = [wrapper(i).launches for i in BF16_PATH]
    tc_launches = {KERNELS[i][0]: wrapper(i).tc_launches for i in TC_PATH}
    timer.restore()

    # outputs: finite cache and event reps, ordered disjoint slot ranges
    wi = sess.write_index
    finite = bool(torch.isfinite(sess.cache.k[:, :, :wi]).all()
                  and torch.isfinite(sess.cache.v[:, :, :wi]).all()
                  and all(torch.isfinite(e.rep).all() for e in sess.events))
    starts = [r.start for r in sess.ranges]
    ends = [r.end for r in sess.ranges]
    ordered = (starts == sorted(starts)
               and all(e <= s for e, s in zip(ends[:-1], starts[1:]))
               and all(r.start <= r.end for r in sess.ranges))
    # bf16 runs only the tensor-core kernels: K4 one launch per call, and
    # never the f32 route's cs_gqa_combine
    all_tc = all(tc_launches[KERNELS[i][0]] == launches[i] for i in TC_PATH)
    log(f"main: {main_s:.1f}s for 2 ingests + 2 asks; launches "
        f"{dict(zip([KERNELS[i][0] for i in BF16_PATH], launches))}, on "
        f"the tensor-core kernels {tc_launches} (all {all_tc}); cache "
        f"{wi} slots; "
        f"{len(sess.events)} events; finite {finite}; ranges ordered and "
        f"disjoint {ordered}; peak {torch.cuda.max_memory_allocated() / 2**30:.1f}"
        f" GiB [{stamp}]")
    if not finite or not ordered or min(launches) == 0 \
            or min(tc_launches.values()) == 0 or not all_tc \
            or len(sess.events) != 2:
        raise AssertionError("main path check failed")
    return launches, metrics, sess


# phase 5 (c)'s sessions over another cache dtype: (dtype name, metric
# prefix, full: phase 5's two segments and asks of 32 tokens, else one
# segment and its AC ask of 8 tokens, a decode step's cost over 9000 slots
# measured)
KV_SESSIONS = (("float8_e4m3fn", "fp8", True), ("float8_e5m2", "e5m2", True),
               ("float16", "f16", False), ("float32", "f32", False))


def run_kv_session(sess16, dev, stamp, kv_name: str, tag: str,
                   full: bool):
    """Phase 5 (c), a cache in another dtype at 7B width: a second
    ``StreamingSession`` on the phase-5 model with ``kv_dtype`` ``kv_name``
    (e4m3 and e5m2: the fp8 caches; f16; f32) ingests phase 5's segments
    and asks its questions (``full``: both, 32 greedy tokens; else the
    first and its AC ask, 8 tokens). K3 / K4 counts are reset just before
    and read just after: every launch on its tensor-core kernel, and K3 and
    K4 each launched over this cache (the selector's and the event
    summaries' forwards keep bf16 caches of their own). Prints ingest
    seconds, turns and decode tok/s; the cache's bytes beside the bf16
    session's; the greedy-prefix agreement with phase 5's bf16 answers
    (reported, not asserted: the cache is lossy or rounds to bf16); the
    largest |K| and |V| the bf16 session holds and how many of its
    elements pass the cache dtype's largest value, and how many of this
    cache's elements sit at it (``qwen2.saturate``) or are not finite
    (must be none); with ``full``, ``decode_step_cost`` over a 9216-slot
    cache holding 9000 slots (e4m3's beside bf16's). Metrics under
    ``tag``. Returns ([K3, K4 launches over this cache], metrics)."""
    import torch

    from cogstream_tpu_torch.evaluate.quant_quality import prefix_agreement
    from cogstream_tpu_torch.models.qwen2 import CACHE_MAX
    from cogstream_tpu_torch.ops import lm_attention as lma
    from cogstream_tpu_torch.runtime.session import StreamingSession

    kd = getattr(torch, kv_name)
    model, cfg, tok = sess16.model, sess16.cfg, sess16.tok
    t, gh, gw, ms = MAIN_SEGMENTS
    k3, k4 = lma.prefill_flash_attention, lma.decode_attention
    timer = PhaseTimer()
    metrics = {}
    for w in (k3, k4):
        w.launches = w.tc_launches = w.fp8_launches = 0
        w.kv_launches = {}
    asks = [("What is happening in the video?", "AC"),
            ("What changed since then?", "FCC")]
    tokens = 32 if full else 8
    try:
        sess = StreamingSession(model, cfg, tok, max_len=16384, kv_dtype=kd)
        for seg_i, (pv, (question, mode)) in enumerate(
                zip(main_segments()[:2 if full else 1], asks)):
            mark = timer.mark()
            t0 = time.perf_counter()
            sess.append_stream_segment(pv, (t, gh, gw), ms,
                                       timestamps=[float(seg_i * t + f)
                                                   for f in range(t)])
            torch.cuda.synchronize()
            ingest_s = time.perf_counter() - t0
            pf = [(S, b - a) for S, a, b in timer.forwards[mark:] if S > 8]
            metrics[f"{tag}_ingest{seg_i}_s"] = ingest_s
            metrics[f"{tag}_ingest{seg_i}_prefill_tok_per_s"] = \
                pf[0][0] / pf[0][1]
            after_sel = []
            select = sess.selector.select

            def marked_select(*a, **k):
                out = select(*a, **k)
                after_sel.append(timer.mark())
                return out

            sess.selector.select = marked_select
            mark = timer.mark()
            t0 = time.perf_counter()
            r = sess.ask(question, mode=mode, max_new_tokens=tokens)
            torch.cuda.synchronize()
            turn_s = time.perf_counter() - t0
            sess.selector.select = select
            since = after_sel[0] if after_sel else mark
            dec = timer.decode_rate(since)
            agree = prefix_agreement(
                np.asarray(MAIN_ANSWERS[mode][:tokens]),
                np.asarray(r["tokens"]))
            metrics.update({f"{tag}_{mode}_turn_s": turn_s,
                            f"{tag}_{mode}_decode_tok_per_s": dec,
                            f"{tag}_{mode}_prefix_agree_vs_bf16": agree})
            log(f"main {kv_name} cache: ingest {seg_i} {ingest_s:.3f}s "
                f"(prefill {pf[0][0]} tokens, {pf[0][0] / pf[0][1]:.0f} "
                f"tok/s); ask {mode}: turn {turn_s:.3f}s, "
                f"{len(r['tokens'])} tokens, marginal decode {dec:.1f} "
                f"tok/s; {timer.step_split(since)}; greedy prefix agreement"
                f" with the bf16 session {agree:.3f} (selection "
                f"{r['selection']!r}) [{stamp}]")
            if not all(0 <= x < cfg.text.vocab_size for x in r["tokens"]):
                raise AssertionError(f"bad {kv_name} answer tokens "
                                     f"{r['tokens']}")
    finally:
        timer.restore()
    torch.cuda.synchronize()
    counts = {n: (w.launches, w.tc_launches, w.kv_launches.get(kv_name, 0))
              for n, w in (("K3", k3), ("K4", k4))}
    c8, c16 = sess.cache, sess16.cache
    wi = sess.write_index
    top = CACHE_MAX.get(kd, float("inf"))
    # per layer: no widened copy of the whole cache
    bad, at_top = 0, [0, 0]
    for i, x in enumerate((c8.k, c8.v)):
        for layer in x:
            a = layer[:, :wi].float()
            bad += int((~torch.isfinite(a)).sum())
            at_top[i] += int((a.abs() == top).sum())
            del a
    live16 = c16.pos[0] >= 0
    big = []
    for x in (c16.k, c16.v):
        a = x[:, 0, live16].abs()
        big.append((float(a.amax()), int((a > top).sum())))
        del a
    b8, b16 = nbytes(c8.k, c8.v, c8.pos), nbytes(c16.k, c16.v, c16.pos)
    metrics.update({f"{tag}_cache_bytes": b8, "bf16_cache_bytes": b16,
                    f"{tag}_max_abs_kv_bf16_session": [m for m, _ in big],
                    f"{tag}_over_max_bf16_session": [n for _, n in big],
                    f"{tag}_at_max": at_top})
    log(f"main {kv_name} cache: {wi} slots; cache {b8 / 1e9:.3f} GB against "
        f"the bf16 session's {b16 / 1e9:.3f} GB; the bf16 session's largest "
        f"|K| {big[0][0]:.4g}, |V| {big[1][0]:.4g}, elements past {top:g} "
        f"(K, V) {[n for _, n in big]}; elements at +-{top:g} (K, V) "
        f"{at_top}, not finite {bad}; K3 / K4 (launches, tensor-core, over "
        f"{kv_name}) {counts} [{stamp}]")
    if bad or any(c[0] != c[1] or c[2] == 0 for c in counts.values()):
        raise AssertionError(f"the {kv_name} session did not run K3 / K4 "
                             "over its cache on the tensor-core kernels")
    launches = [counts["K3"][2], counts["K4"][2]]
    del sess
    gc.collect()
    if full:
        steps = [("bf16 cache", None)] if tag == "fp8" else []
        for label, kv in steps + [(f"{kv_name} cache", kd)]:
            n, dev_ms, wall_ms, _ = decode_step_cost(
                model.text, label, stamp, slots=9216, fill=9000, kv_dtype=kv)
            key = "bf16" if kv is None else tag
            metrics[f"{key}_step_9000_device_ms"] = dev_ms
            metrics[f"{key}_step_9000_wall_ms"] = wall_ms
    return launches, metrics


def decode_step_cost(text, label: str, stamp: str, steps: int = 10,
                     tokens: int = 1, head_rows: int = 1, slots: int = 64,
                     fill: int = 0, kv_dtype=None):
    """One decode step (a ``tokens``-token cached forward plus the
    full-vocab logits of its last ``head_rows`` rows; 1 token, a
    lookahead verify's k+1 with all k+1 rows, or a question prefill's few
    dozen) on a scratch cache of at least ``slots`` slots whose first
    ``fill`` hold history positions (zero K/V; the cache in ``kv_dtype``,
    the model's by default): its kernel launches and
    summed kernel device time from torch.profiler (its five largest
    kernels are printed, and the GEMVs' share: int4 K6-K9, int8 K10), and
    its host wall ms from a synchronized clock over ``steps`` unprofiled
    steps. Returns (launches, device ms, wall ms, GEMV device ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cogstream_tpu_torch.models import qwen2

    cfg = text.cfg
    cache = qwen2.init_kv_cache(
        cfg, 1, max(slots, fill + tokens * (steps + 2)),
        dtype=kv_dtype or text.dtype, device=text.device)
    cache.pos[:, :fill] = torch.arange(fill, dtype=torch.int32)
    cache.write_index = fill
    emb = torch.zeros((1, tokens, cfg.hidden_size), dtype=text.dtype,
                      device=text.device)

    def step(i):
        pos = torch.arange(fill + i * tokens, fill + (i + 1) * tokens,
                           dtype=torch.int32, device=text.device)[None]
        h, _ = qwen2.qwen2_forward(text, emb, pos, cache)
        qwen2.lm_logits(text, h[:, -head_rows:], w8a8=cfg.w4a8_decode)

    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(1)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    n = sum(e.count for e in kern)
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    gemv_ms = sum(e.self_device_time_total for e in kern
                  if "int4_gemv" in e.key or "int8_gemv" in e.key
                  or "quant_gemv" in e.key) / 1e3
    t0 = time.perf_counter()
    for i in range(steps):
        step(2 + i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    top = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in sorted(
                        kern, key=lambda e: -e.self_device_time_total)[:5])
    what = ("decode step" if tokens == 1 else f"verify step S={tokens}"
            if head_rows == tokens else f"{tokens}-token prefill")
    log(f"{what} ({label}, {cache.max_len}-slot {str(cache.k.dtype)[6:]} "
        f"cache, {fill} filled): {n}"
        f" launches, device {dev_ms:.2f} ms (GEMVs {gemv_ms:.2f}), wall "
        f"{wall_ms:.2f} ms (busy {dev_ms / wall_ms:.3f}); largest: {top} "
        f"[{stamp}]")
    return n, dev_ms, wall_ms, gemv_ms


# ---------------------------------------------------------------------------
# phase 8 (engine): the evaluation path, answer-generate
# ---------------------------------------------------------------------------

ENGINE_DIR = os.path.join(REPO, "build", "chip_smoke_engine")
ENGINE_MODES = ("NC", "AC", "FCC", "gt")
ENGINE_TOKENS = 8           # greedy tokens a turn
# 150 frames at 1 fps in three stream segments of 50 (answer_generate's
# default layout), 224x364: the processor's own smart-resize target for
# 150 frames under the 16384-token budget (8x13 merged tokens a frame)
ENGINE_T, ENGINE_HW, ENGINE_SCENES = 150, (224, 364), 10
ENGINE_QAS = (("What is on screen at the start?", []),
              ("Which block moved in the second part?", [1]),
              ("What changed over the whole stream?", [1, 0]))


def _engine_dir(*parts) -> str:
    """An empty directory under ENGINE_DIR (build/, ignored by git)."""
    import shutil

    path = os.path.join(ENGINE_DIR, *parts)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def probe_host_decoders() -> dict:
    """Pillow and OpenCV versions (None when absent), whether OpenCV
    writes and reads back an mp4v clip, and the ffmpeg binary."""
    import importlib
    import shutil

    found = {}
    for mod in ("PIL", "cv2"):
        try:
            found[mod] = importlib.import_module(mod).__version__
        except ImportError:
            found[mod] = None
    found["cv2_mp4v"] = False
    if found["cv2"]:
        import cv2

        path = os.path.join(_engine_dir("probe"), "p.mp4")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 1,
                            (64, 48))
        for _ in range(3):
            w.write(np.zeros((48, 64, 3), np.uint8))
        w.release()
        cap = cv2.VideoCapture(path)
        found["cv2_mp4v"] = bool(cap.isOpened() and cap.read()[0])
        cap.release()
    found["ffmpeg"] = shutil.which("ffmpeg")
    return found


def engine_frames():
    """ENGINE_T seeded uint8 frames (HWC) in ENGINE_SCENES scenes: each
    scene a static background of flat colored rectangles (it compresses
    losslessly enough that static patches stay static through mp4v) with
    one 28x28 block moving 14 px a frame."""
    rng = np.random.default_rng(7)
    h, w = ENGINE_HW
    per = ENGINE_T // ENGINE_SCENES
    frames = []
    for _ in range(ENGINE_SCENES):
        bg = np.empty((h, w, 3), np.uint8)
        bg[:] = rng.integers(0, 256, 3)
        for _ in range(8):
            y, x = rng.integers(0, h - 56), rng.integers(0, w - 84)
            bg[y:y + 56, x:x + 84] = rng.integers(0, 256, 3)
        color = rng.integers(0, 256, 3)
        for f in range(per):
            fr = bg.copy()
            fr[84:112, 14 * f:14 * f + 28] = color
            frames.append(fr)
    return frames


def write_engine_inputs(route: str):
    """The evaluation inputs under ENGINE_DIR: one video (an mp4v clip at
    1 fps with OpenCV, else a directory of .npy frames, which the video
    loader reads with numpy alone) and its spec of three segments with
    one QA each. Returns (video_dir, query_dir)."""
    video_dir, query_dir = _engine_dir("videos"), _engine_dir("queries")
    frames = engine_frames()
    if route == "cv2":
        import cv2

        name = "stream.mp4"
        h, w = ENGINE_HW
        wr = cv2.VideoWriter(os.path.join(video_dir, name),
                             cv2.VideoWriter_fourcc(*"mp4v"), 1, (w, h))
        for f in frames:
            wr.write(f)
        wr.release()
    else:
        name = "stream"
        os.makedirs(os.path.join(video_dir, name))
        for i, f in enumerate(frames):
            np.save(os.path.join(video_dir, name, f"{i:04d}.npy"), f)
    seg = ENGINE_T // 3
    bounds = [0.0, seg - 0.5, 2 * seg - 0.5, float(ENGINE_T)]
    spec = {"video": name, "segments": [
        {"timestamp": [bounds[i], bounds[i + 1]], "QAs": [
            {"QA_pairs": [{"Q": q, "A": "-"}], "relevance": rel,
             "is_visual": True, "label": "Streaming"}]}
        for i, (q, rel) in enumerate(ENGINE_QAS)]}
    with open(os.path.join(query_dir, "stream.json"), "w") as f:
        json.dump(spec, f)
    return video_dir, query_dir


class EngineProbe:
    """Per-turn instrumentation of ``CogReasonerEngine.chat`` (this
    script only): synchronized wall clocks around the chat, the host
    processor (video decode, resize, patchify, tokenize), the selector,
    the tower + projector, the compression (k-means, event relevance,
    pooling, mask) and every decoder forward; the compression result;
    the k-means K; the prefill's real token count."""

    def __init__(self, engine):
        import torch

        from cogstream_tpu_torch.models import cogreasoner, qwen2
        from cogstream_tpu_torch.ops import kmeans
        from cogstream_tpu_torch.runtime import engine as eng_mod

        self.turns = []
        self.kmeans_k = []
        sync = torch.cuda.synchronize
        self._undo = []

        def patch(mod, name, make):
            orig = getattr(mod, name)
            setattr(mod, name, make(orig))
            self._undo.append((mod, name, orig))

        def timed(key):
            def make(orig):
                def run(*a, **k):
                    sync()
                    t0 = time.perf_counter()
                    out = orig(*a, **k)
                    sync()
                    self.cur[key] = self.cur.get(key, 0.0) + \
                        (time.perf_counter() - t0) * 1e3
                    if key == "compress_ms":
                        self.cur["comp"] = out
                    return out
                return run
            return make

        def forward(orig):
            def run(model, embeds, *a, **k):
                sync()
                t0 = time.perf_counter()
                out = orig(model, embeds, *a, **k)
                sync()
                self.cur["forwards"].append(
                    (embeds.shape[1], t0, time.perf_counter()))
                return out
            return run

        def gen(orig):
            def run(model, embeds, positions, *a, **k):
                self.cur["gen_mark"] = len(self.cur["forwards"])
                self.cur["prefill_tokens"] = int((positions >= 0).sum())
                return orig(model, embeds, positions, *a, **k)
            return run

        def km(orig):
            def run(features, timestamps, num_clusters, *a, **k):
                self.kmeans_k.append(num_clusters)
                return orig(features, timestamps, num_clusters, *a, **k)
            return run

        def chat(orig):
            def run(*a, **k):
                self.cur = {"forwards": []}
                sync()
                t0 = time.perf_counter()
                out = orig(*a, **k)
                sync()
                self.cur["wall_ms"] = (time.perf_counter() - t0) * 1e3
                self.cur["result"] = out
                self.turns.append(self.cur)
                return out
            return run

        patch(cogreasoner, "encode_images", timed("encode_ms"))
        patch(cogreasoner, "run_visual_compression", timed("compress_ms"))
        patch(engine, "processor", timed("process_ms"))
        patch(engine.selector, "select", timed("select_ms"))
        patch(qwen2, "qwen2_forward", forward)
        patch(eng_mod, "generate_tokens", gen)
        patch(kmeans, "kmeans_with_time", km)
        patch(engine, "chat", chat)

    def restore(self):
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)

    @staticmethod
    def summary(turn) -> dict:
        fw = turn["forwards"][turn["gen_mark"]:]
        S, a, b = fw[0]
        starts = [t0 for s, t0, _ in fw[1:] if s == 1]
        comp = turn.get("comp")
        out = {"wall_ms": turn["wall_ms"],
               "process_ms": turn.get("process_ms", 0.0),
               "select_ms": turn.get("select_ms", 0.0),
               "encode_ms": turn.get("encode_ms", 0.0),
               "compress_ms": turn.get("compress_ms", 0.0),
               "prefill_tokens": turn["prefill_tokens"], "prefill_bucket": S,
               "prefill_ms": (b - a) * 1e3,
               "decode_tok_per_s": ((len(starts) - 1)
                                    / (starts[-1] - starts[0])
                                    if len(starts) > 1 else float("nan")),
               "new_tokens": turn["result"].num_tokens,
               "selection": turn["result"].selection,
               "events": 0, "minor_frames": 0, "visual_tokens": 0,
               "visual_kept": 0, "similarities": [], "finite": True}
        if comp is not None:
            keep = comp.keep_visual
            out.update(visual_tokens=int(keep.numel()),
                       visual_kept=int(keep.sum()),
                       finite=bool(comp.mm_features.isfinite().all()) and (
                           comp.similarities is None
                           or bool(comp.similarities.isfinite().all())))
            if comp.similarities is not None:
                out.update(events=int(comp.similarities.numel()),
                           minor_frames=int(comp.minor_frames.sum()),
                           similarities=[round(float(s), 4) for s in
                                         comp.similarities])
        return out


def run_engine_path(model, dev, stamp):
    """Phase 8 (engine), on the phase-5 bf16 7B model: (a)
    :func:`engine_turns`, (b) :func:`run_checkpoint_round_trip`, in an
    ENGINE_DIR made empty first and removed at the end (``run_eval``
    skips a video whose result file exists, so files of a run that
    stopped would leave this one with no turns)."""
    import shutil

    shutil.rmtree(ENGINE_DIR, ignore_errors=True)
    try:
        metrics, video_dir, query_dir = engine_turns(model, dev, stamp)
        metrics.update(run_checkpoint_round_trip(dev, stamp, video_dir,
                                                 query_dir))
        return metrics
    finally:
        shutil.rmtree(ENGINE_DIR, ignore_errors=True)


def engine_turns(model, dev, stamp):
    """Phase 8 (a), on the phase-5 bf16 7B model (28 decoder layers,
    seeded weights): ``answer_generate.run_eval`` over one video of 150
    frames (three stream segments of 50, one QA each, so the last turn
    has two answered turns of history) in each of NC, AC, FCC and gt, 32
    greedy new tokens a turn, through ``CogReasonerEngine`` on the card.
    Checks: K1-K4 launch in the phase, every K1/K3/K4 launch on its
    tensor-core kernel; the last turns run k-means at K = 10 and pool at
    least one minor frame; the turns without events (50 and 100 frames,
    under the 10-event minimum), where only the pixel-diff mask can drop
    tokens, keep fewer visual tokens than they have; every answer is
    written, finite selections parse. Returns (metrics, video_dir,
    query_dir)."""
    import torch

    from cogstream_tpu_torch import presets
    from cogstream_tpu_torch.evaluate.answer_generate import run_eval
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.runtime.engine import CogReasonerEngine
    from cogstream_tpu_torch.runtime.history import parse_selection

    cfg = presets.cogreasoner_7b()
    found = probe_host_decoders()
    route = "cv2" if found["cv2_mp4v"] else "npy"
    log(f"engine: host decoders {found}; input route {route} [{stamp}]")
    video_dir, query_dir = write_engine_inputs(route)
    tok = ByteTokenizer(image_token_id=cfg.image_token_index,
                        vocab=cfg.text.vocab_size)
    engine = CogReasonerEngine(model, cfg, tok)
    probe = EngineProbe(engine)
    for i in BF16_PATH:
        wrapper(i).launches = 0
    for i in TC_PATH:
        wrapper(i).tc_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    results, metrics = {}, {}
    try:
        for mode in ENGINE_MODES:
            save = os.path.join(ENGINE_DIR, "preds", mode)
            n0 = len(probe.turns)
            run_eval(engine, engine.processor, video_dir, query_dir, save,
                     mode=mode, process_index=0, process_count=1,
                     max_new_tokens=ENGINE_TOKENS,
                     log=lambda m: log(f"engine: {m}"))
            with open(os.path.join(save, "stream.json")) as f:
                results[mode] = json.load(f)
            for j, turn in enumerate(probe.turns[n0:]):
                s = EngineProbe.summary(turn)
                metrics[f"engine_{mode}_turn{j}"] = s
                log(f"engine: {mode} turn {j}: wall {s['wall_ms']:.1f} ms; "
                    f"processor {s['process_ms']:.1f} ms; selector "
                    f"{s['select_ms']:.1f} ms; "
                    f"encode {s['encode_ms']:.1f} ms; compression "
                    f"{s['compress_ms']:.1f} ms; visual tokens "
                    f"{s['visual_tokens']} -> {s['visual_kept']}; events "
                    f"{s['events']}, minor frames {s['minor_frames']}, sims "
                    f"{s['similarities']}; prefill {s['prefill_tokens']} "
                    f"tokens (bucket {s['prefill_bucket']}) in "
                    f"{s['prefill_ms']:.1f} ms; {s['new_tokens']} new "
                    f"tokens, marginal decode {s['decode_tok_per_s']:.1f} "
                    f"tok/s; selection {s['selection']!r} [{stamp}]")
    finally:
        probe.restore()
    torch.cuda.synchronize()
    phase_s = time.perf_counter() - t_phase
    launches = {KERNELS[i][0]: wrapper(i).launches for i in BF16_PATH}
    tc = {KERNELS[i][0]: wrapper(i).tc_launches for i in TC_PATH}
    all_tc = all(tc[KERNELS[i][0]] == launches[KERNELS[i][0]]
                 for i in TC_PATH)
    last = [metrics[f"engine_{m}_turn2"] for m in ENGINE_MODES]
    n_qas = [len(r["QAs"]) for r in results.values()]
    turns = [metrics[f"engine_{m}_turn{j}"] for m in ENGINE_MODES
             for j in range(3)]
    finite = all(t["finite"] for t in turns) and all(
        isinstance(q["prediction"], str) for r in results.values()
        for q in r["QAs"])
    events_ok = (probe.kmeans_k and set(probe.kmeans_k) == {10}
                 and all(s["events"] == 10 for s in last
                         if s["visual_tokens"]))
    pooled = any(s["minor_frames"] > 0 for s in last)
    mask_only = [t for t in turns if t["visual_tokens"] and not t["events"]]
    dropped = bool(mask_only) and all(
        t["visual_kept"] < t["visual_tokens"] for t in mask_only)
    fcc = metrics["engine_FCC_turn2"]["selection"]
    fcc_ok = fcc.startswith("[") and fcc.endswith("]") and \
        parse_selection(fcc) == (results["FCC"]["QAs"][2]["pred_visual"],
                                 results["FCC"]["QAs"][2]["pred_coi"])
    log(f"engine: {phase_s:.1f}s for {sum(n_qas)} turns in 4 modes; "
        f"launches {launches}, on the tensor-core kernels {tc} (all "
        f"{all_tc}); k-means K {sorted(set(probe.kmeans_k))} over "
        f"{len(probe.kmeans_k)} turns; pooled minor frames {pooled}; "
        f"pixel-diff drops in the {len(mask_only)} turns without events "
        f"{dropped}; finite {finite}; FCC selection "
        f"{fcc!r} parses {fcc_ok}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{stamp}]")
    if (n_qas != [3] * 4 or min(launches.values()) == 0 or not all_tc
            or not events_ok or not pooled or not dropped or not fcc_ok
            or not finite):
        raise AssertionError("engine path check failed")
    metrics["engine_launches"] = launches
    return metrics, video_dir, query_dir


class RssPeak:
    """Peak resident set size of this process (VmRSS, sampled every
    2 ms on a thread) between ``start`` and ``stop``."""

    def __init__(self):
        import threading

        self.peak = self.base = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def _run(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, self._rss())

    def stop(self) -> int:
        self._stop.set()
        self._thread.join(timeout=5)
        return max(self.peak, self._rss())


def run_checkpoint_round_trip(dev, stamp, video_dir, query_dir):
    """Phase 8 (b): the checkpoint round trip at full width, depth cut
    to 2 decoder and 2 tower layers (a ``cogreasoner_7b`` model, ~3.2 GB
    in bf16, mostly the two 152064 x 3584 tables; seeded weights).
    ``save_cogreasoner_to_hf`` writes it under build/; the bf16 load must
    give every tensor bit-identical to the source; a load with
    ``quantize_text_bits=4`` must give the int4 stores ``quantize_text_``
    makes of the same weights (and one with ``quantize_text_bits=8`` the
    stores of ``quantize_text_(bits=8)``), and the int4 model answers
    phase 8 (a)'s
    three turns in FCC mode with K6 and K8 launching. Prints write and
    load seconds and the host's peak RSS during each load."""
    import dataclasses

    import torch

    from cogstream_tpu_torch import presets
    from cogstream_tpu_torch.evaluate.answer_generate import run_eval
    from cogstream_tpu_torch.models.checkpoint import (
        load_cogreasoner_from_hf, save_cogreasoner_to_hf)
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params
    from cogstream_tpu_torch.ops.quant import quantize_text_
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.runtime.engine import CogReasonerEngine

    cfg7 = presets.cogreasoner_7b()
    cfg = dataclasses.replace(
        cfg7, text=dataclasses.replace(cfg7.text, num_hidden_layers=2),
        vision=dataclasses.replace(cfg7.vision, num_hidden_layers=2))
    src = init_cogreasoner_params(
        cfg, torch.Generator(device=dev).manual_seed(3), device=dev)
    out_dir = os.path.join(ENGINE_DIR, "hf")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_cogreasoner_to_hf(src, cfg, out_dir)
    write_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(out_dir, f))
               for f in os.listdir(out_dir))

    def load(**kw):
        rss = RssPeak()
        t0 = time.perf_counter()
        model = load_cogreasoner_from_hf(out_dir, cfg, device=dev, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = rss.stop()
        return model, secs, peak - rss.base, peak

    bf16, load_s, rss_d, rss_peak = load()
    a, b = bf16.state_dict(), src.state_dict()
    same = list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
    del bf16, a
    q8, load8_s, _, _ = load(quantize_text_bits=8)
    src8 = init_cogreasoner_params(
        cfg, torch.Generator(device=dev).manual_seed(3), device=dev)
    quantize_text_(src8.text, bits=8)
    a, b = q8.text.state_dict(), src8.text.state_dict()
    same8 = list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
    del q8, src8, a, b
    q4, load4_s, rss4_d, rss4_peak = load(quantize_text_bits=4)
    quantize_text_(src.text)
    a, b = q4.text.state_dict(), src.text.state_dict()
    same4 = list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
    del src, a, b
    log(f"checkpoint: 2+2-layer 7B-width model written in {write_s:.1f}s "
        f"({size / 2**30:.2f} GiB); bf16 load {load_s:.1f}s, every tensor "
        f"bit-identical {same}, host RSS +{rss_d / 2**30:.2f} GiB (peak "
        f"{rss_peak / 2**30:.2f} GiB); int4 load {load4_s:.1f}s, stores "
        f"bit-identical to quantize_text_ {same4}, host RSS "
        f"+{rss4_d / 2**30:.2f} GiB (peak {rss4_peak / 2**30:.2f} GiB); "
        f"int8 load {load8_s:.1f}s, stores bit-identical to "
        f"quantize_text_(bits=8) {same8} [{stamp}]")

    before = [wrapper(i).launches for i in INT4_PATH]
    tok = ByteTokenizer(image_token_id=cfg.image_token_index,
                        vocab=cfg.text.vocab_size)
    save = os.path.join(ENGINE_DIR, "preds", "int4_FCC")
    t0 = time.perf_counter()
    run_eval(CogReasonerEngine(q4, cfg, tok), None, video_dir, query_dir,
             save, mode="FCC", process_index=0, process_count=1,
             max_new_tokens=32, log=lambda m: log(f"checkpoint: {m}"))
    torch.cuda.synchronize()
    int4_s = time.perf_counter() - t0
    launched = {KERNELS[i][0]: wrapper(i).launches - n
                for i, n in zip(INT4_PATH, before)}
    with open(os.path.join(save, "stream.json")) as f:
        n_turns = len(json.load(f)["QAs"])
    log(f"checkpoint: int4 model answered {n_turns} FCC turns in "
        f"{int4_s:.1f}s; int4 launches {launched} [{stamp}]")
    del q4
    if not same or not same4 or not same8 or n_turns != 3 \
            or launched["K6_int4_gemv"] == 0 \
            or launched["K8_int4_gemv_idx"] == 0:
        raise AssertionError("checkpoint round trip check failed")
    gc.collect()
    torch.cuda.empty_cache()
    return {"ckpt_write_s": write_s, "ckpt_bytes": size,
            "ckpt_load_s": load_s, "ckpt_load_rss_delta": rss_d,
            "ckpt_int4_load_s": load4_s, "ckpt_int4_load_rss_delta": rss4_d,
            "ckpt_int8_load_s": load8_s,
            **run_host_streams(stamp, out_dir, video_dir)}


def run_host_streams(stamp, ckpt_dir, video_dir):
    """Phase 8 (c), (d) and 9 (d) side by side, each on a thread of its
    own (their subprocesses are independent, and most of their wall is
    each command's start-up on the host): the two training commands, the
    workflow, and the solo and pooled supervised servers. Every stream
    runs to its end; then the first failure is raised. Their walls are
    taken with the others running beside them."""
    from concurrent.futures import ThreadPoolExecutor

    clip = _clip_file(video_dir)
    streams = {
        "train CLIs": lambda: run_training_clis(stamp, ckpt_dir, video_dir),
        "workflow": lambda: run_workflow(stamp, ckpt_dir, video_dir),
        "supervise solo": lambda: supervised_case(stamp, ckpt_dir, clip, 0),
        "supervise pooled": lambda: supervised_case(stamp, ckpt_dir, clip,
                                                    2)}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(streams)) as ex:
        futures = {k: ex.submit(fn) for k, fn in streams.items()}
        errors = {k: f.exception() for k, f in futures.items()}
    log(f"phase 8 (c), (d) and 9 (d) side by side in "
        f"{time.perf_counter() - t0:.1f}s; failed "
        f"{[k for k, e in errors.items() if e is not None]} [{stamp}]")
    for k, e in errors.items():
        if e is not None:
            raise AssertionError(f"phase 8 stream {k!r} failed") from e
    out = {}
    out.update(futures["train CLIs"].result())
    out.update(futures["workflow"].result())
    out["supervise"] = {"solo": futures["supervise solo"].result(),
                        "pooled": futures["supervise pooled"].result()}
    return out


def run_training_clis(stamp, ckpt_dir, video_dir):
    """Phase 8 (c): the two training commands as subprocesses on phase 8
    (b)'s 2+2-layer 7B-width checkpoint (byte tokenizer): ``train-stage1``
    on the selector samples of 2 seeded chains (``--max-len 4096``: byte
    tokens, prompts with the demo block), one epoch at batch 2; ``train-stage2
    --quantize-base nf4`` on phase 8's clip under a seeded spec of three
    10-frame segments, one QA each (relevance and visual flags from the
    seed), the two side by side. Each must exit 0, print its steps /
    turns (at least one) and write its adapter. Prints each one's wall."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(21)
    root = _engine_dir("train_cli")
    qa = {}
    for v, smp in enumerate(_selector_samples(rng, 2)):
        qas = [{"QA_pairs": [{"Q": q, "A": a}], "relevance": [],
                "is_visual": True} for q, a in zip(smp.hist_qs, smp.hist_as)]
        qas.append({"QA_pairs": [{"Q": smp.question, "A": "-"}],
                    "relevance": [int(i in smp.relevance)
                                  for i in range(len(qas))],
                    "is_visual": smp.if_visual})
        qa[f"vid{v}"] = {"QAs": qas}
    qa_json = os.path.join(root, "qa.json")
    with open(qa_json, "w") as f:
        json.dump(qa, f)
    names = [n for n in os.listdir(video_dir) if not n.startswith(".")]
    words = ["what", "moves", "where", "color", "block", "now", "left"]
    segs = []
    for i in range(3):
        q = " ".join(rng.choice(words, 5)) + "?"
        segs.append({"timestamp": [10.0 * i, 10.0 * i + 9.5], "QAs": [
            {"QA_pairs": [{"Q": q, "A": "a block moves."}],
             "relevance": [int(x) for x in rng.integers(0, 2, i)],
             "is_visual": bool(i != 1)}]})
    qdir = os.path.join(root, "queries")
    os.makedirs(qdir)
    with open(os.path.join(qdir, "clip.json"), "w") as f:
        json.dump({"video": names[0], "segments": segs}, f)
    runs = {
        "train-stage1": (["--qa-json", qa_json, "--epochs", "1",
                          "--batch-size", "2", "--max-len", "4096"],
                         "language_module.npz", "stage1: "),
        "train-stage2": (["--video-dir", video_dir, "--query-dir", qdir,
                          "--quantize-base", "nf4"],
                         "full_module.npz", "clip.json: "),
    }

    def run(cmd):
        return run_cli(f"train CLI {cmd}", [
            cmd, "--model-dir", ckpt_dir, "--out", os.path.join(root, cmd)]
            + runs[cmd][0], stamp, timeout=600)

    with ThreadPoolExecutor(len(runs)) as ex:
        done = dict(zip(runs, ex.map(run, runs)))
    ok, out = True, {}
    for cmd, (args, adapter, mark) in runs.items():
        out_dir = os.path.join(root, cmd)
        stdout, wall = done[cmd]
        said = [ln for ln in stdout.splitlines() if ln.startswith(mark)]
        first = said[-1][len(mark):].split()[0] if said else ""
        n = int(first) if first.isdigit() else 0
        wrote = os.path.exists(os.path.join(out_dir, adapter))
        log(f"train CLI {cmd}: {said[-1] if said else 'no summary line'}; "
            f"wrote {adapter} {wrote} [{stamp}]")
        ok &= wrote and n >= 1
        out[f"cli_{cmd.replace('-', '_')}_s"] = wall
    if not ok:
        raise AssertionError("a training command failed")
    return out


def _clip_file(video_dir) -> str:
    """Phase 8's mp4v clip (the cv2 route; the .npy route has no file)."""
    names = [n for n in os.listdir(video_dir) if n.endswith(".mp4")]
    if not names:
        raise AssertionError("phases 8 (d) and 9 (d) need phase 8's mp4v "
                             "clip (OpenCV wrote none)")
    return os.path.join(video_dir, names[0])


def run_cli(label: str, args, stamp: str, timeout: int = 900):
    """``python -m cogstream_tpu_torch ARGS`` as a subprocess: logs its
    exit code, wall and last output line, fails on a non-zero exit;
    returns its standard output and wall."""
    import subprocess as sp

    t0 = time.perf_counter()
    r = sp.run([sys.executable, "-m", "cogstream_tpu_torch", *args],
               cwd=REPO, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    last = (r.stdout.strip().splitlines() or [""])[-1]
    log(f"{label}: exit {r.returncode} in {wall:.2f}s; {last[:240]} "
        f"[{stamp}]")
    if r.returncode != 0:
        log(r.stdout[-2000:] + r.stderr[-4000:])
        raise AssertionError(f"{label} failed")
    return r.stdout, wall


def run_workflow(stamp, ckpt_dir, video_dir):
    """Phase 8 (d): the reference's published workflow through the port's
    command line, each stage a subprocess, on phase 8 (b)'s 2+2-layer
    7B-width checkpoint and phase 8's 150-frame clip: segment-videos
    (cuts at 50 and 100 s) -> datagen --model fake --n-streams 1 (one
    query chain) -> train-stage1 (byte
    tokens, --max-len 4096) -> train-stage2 -> answer-generate (FCC, both
    adapters, 16 tokens) -> judge x5 (FakeJudge) -> summarize, and
    nlp-metrics beside the judges. Every stage must exit 0; the spec has 3 segments with
    keyframes; the query chains are non-empty with Event_Time sorted;
    there is one prediction per QA of the first chain; every judged QA
    carries all five scores. Prints each stage's wall, and the wall of a
    bare interpreter importing the package (every command's start-up:
    the package's config imports torch), taken beside segment-videos."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    def import_wall():
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", "import cogstream_tpu_torch"],
                       cwd=REPO, check=True, timeout=300)
        return time.perf_counter() - t0

    clip = _clip_file(video_dir)
    name = os.path.splitext(os.path.basename(clip))[0]
    root = _engine_dir("workflow")
    seg, dg = os.path.join(root, "segmented"), os.path.join(root, "datagen")
    dataset = os.path.join(dg, "dataset")
    chains_dir = os.path.join(dataset, "query_chains")
    evdir = os.path.join(root, "eval_videos")
    s1, s2 = os.path.join(root, "stage1"), os.path.join(root, "stage2")
    preds, judged = os.path.join(root, "preds"), os.path.join(root, "judged")
    walls = {}
    t_flow = time.perf_counter()

    def stage(key, *args):
        out, walls[key] = run_cli(f"workflow {key}", args, stamp)
        return out

    with ThreadPoolExecutor(1) as ex:
        bare = ex.submit(import_wall)
        stage("segment-videos", "segment-videos", "--video", clip,
              "--timestamps", "50,100", "--out-root", seg)
        import_s = bare.result()
    with open(os.path.join(seg, f"{name}.json")) as f:
        spec = json.load(f)
    stage("datagen", "datagen", "--segments-dir", seg, "--out-root", dg,
          "--model", "fake", "--n-streams", "1")
    with open(os.path.join(chains_dir, f"{name}.json")) as f:
        chains = json.load(f)["query_chains"]
    times = [[q["info"]["Event_Time"] for q in c] for c in chains]
    out = stage("train-stage1", "train-stage1", "--qa-json", dataset,
                "--model-dir", ckpt_dir, "--out", s1, "--epochs", "1",
                "--batch-size", "2", "--max-len", "4096")
    steps = [ln for ln in out.splitlines() if ln.startswith("stage1: ")]
    os.makedirs(os.path.join(evdir, name))
    for sg in spec["segments"]:
        shutil.copy(sg["path"], os.path.join(evdir, name))
    stage("train-stage2", "train-stage2", "--model-dir", ckpt_dir,
          "--video-dir", evdir, "--query-dir", chains_dir, "--out", s2)
    lang = os.path.join(s1, "language_module.npz")
    full = os.path.join(s2, "full_module.npz")
    stage("answer-generate", "answer-generate", "--model-dir", ckpt_dir,
          "--lora-adapter-1", lang, "--lora-adapter-2", full,
          "--video-dir", evdir, "--query-dir", chains_dir, "--save-dir",
          preds, "--mode", "FCC", "--max-new-tokens", "16")
    with open(os.path.join(preds, f"{name}.json")) as f:
        qas = json.load(f)["QAs"]
    # nlp-metrics reads only the predictions: it runs beside the judges
    # (which merge their scores into one judged file, so one at a time)
    with ThreadPoolExecutor(1) as ex:
        nlp = ex.submit(stage, "nlp-metrics", "nlp-metrics", "--pred-dir",
                        preds)
        for metric in ("IA", "DC", "CA", "TP", "LC"):
            stage(f"judge {metric}", "judge", "--metric", metric,
                  "--pred-dir", preds, "--out-dir", judged, "--model",
                  "fake")
        report_path = os.path.join(root, "report.json")
        stage("summarize", "summarize", "--judged-dir", judged, "--out",
              report_path)
        metrics = json.loads(nlp.result().strip().splitlines()[-1])
    with open(os.path.join(judged, f"{name}.json")) as f:
        scores = [set(q.get("scores", {})) for q in json.load(f)["QAs"]]
    with open(report_path) as f:
        report = json.load(f)
    flow_s = time.perf_counter() - t_flow
    five = {"IA", "DC", "CA", "TP", "LC"}
    log(f"workflow: {len(spec['segments'])} segments, {len(chains)} chains "
        f"of {[len(c) for c in chains]} QAs, {steps[-1] if steps else 'no'}"
        f" stage-1 line, {len(qas)} predictions, average score "
        f"{report['scores']['average']}, nlp {json.dumps(metrics)}; stages "
        f"{sum(walls.values()):.1f}s, wall {flow_s:.1f}s; an interpreter "
        f"importing the package {import_s:.2f}s [{stamp}]")
    if len(spec["segments"]) != 3 \
            or not all(sg["keyframes"] for sg in spec["segments"]) \
            or not chains or not all(chains) \
            or any(t != sorted(t) for t in times) \
            or not os.path.exists(lang) or not os.path.exists(full) \
            or len(qas) != len(chains[0]) \
            or not all("prediction" in q for q in qas) \
            or not scores or any(s != five for s in scores) \
            or report["scores"]["average"] is None:
        raise AssertionError("workflow check failed")
    return {"workflow_s": walls, "workflow_wall_s": flow_s,
            "package_import_s": import_s}


# ---------------------------------------------------------------------------
# phase 9 (d): serve --supervise, a real device-side assert, restore
# ---------------------------------------------------------------------------

def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _http(port: int, path: str, body=None, timeout: float = 600):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _wait_serving(port: int, proc, deadline_s: float = 300) -> float:
    """Poll /stats until the server answers; returns the time it did."""
    import urllib.error

    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        if proc.poll() is not None:
            raise AssertionError(f"server exited rc={proc.returncode}")
        try:
            _http(port, "/stats", timeout=5)
            return time.time()
        except (urllib.error.URLError, ConnectionError, OSError):
            time.sleep(0.02)
    raise AssertionError("server did not come up")


def _children(pid: int):
    try:
        with open(f"/proc/{pid}/task/{pid}/children") as f:
            return [int(x) for x in f.read().split()]
    except OSError:
        return []


def _holds_card(pid: int) -> bool:
    """Whether a process has a /dev/nvidia* device file open (a CUDA
    context opens them)."""
    fd_dir = f"/proc/{pid}/fd"
    for fd in os.listdir(fd_dir):
        try:
            if os.readlink(os.path.join(fd_dir, fd)).startswith(
                    "/dev/nvidia"):
                return True
        except OSError:
            pass
    return False


def supervised_case(stamp, ckpt_dir, clip, pool_rows: int):
    """One phase 9 (d) case: ``serve --supervise`` (fault injection on the
    third ingest dispatch) beside an unfaulted control ``serve``, both
    subprocesses on the checkpoint. Session s1 ingests 0-16 s of the clip
    (one 16-frame chunk) and asks AC on both; the second ingest (16-48 s,
    two chunks) faults in the middle on a real device-side assert; the
    client must get 503 naming it, the child exit 17, the supervisor
    start a new child that restores s1, and the next ask answer turn 1
    with the control's tokens. The supervisor must hold no /dev/nvidia
    file. Returns fault -> 503 ms, child exit -> ready s, restore s."""
    import re
    import signal
    import subprocess as sp
    import urllib.error

    from cogstream_tpu_torch.runtime.serve import FAULT_ENV

    label = f"pool_rows={pool_rows}" if pool_rows else "solo"
    root = _engine_dir(f"supervise_{pool_rows}")
    snapdir = os.path.join(root, "snaps")
    common = ["-m", "cogstream_tpu_torch", "serve", "--model-dir", ckpt_dir,
              "--host", "127.0.0.1"]
    if pool_rows:
        common += ["--pool-rows", str(pool_rows)]
    port, cport = _free_port(), _free_port()
    env = {k: v for k, v in os.environ.items() if k != FAULT_ENV}
    env["PYTHONUNBUFFERED"] = "1"
    logs = {k: open(os.path.join(root, f"{k}.log"), "w+")
            for k in ("sup", "ctl")}
    procs = {
        "sup": sp.Popen([sys.executable, *common, "--port", str(port),
                         "--supervise", "--auto-snapshot-dir", snapdir,
                         "--restart-cooldown", "0.5"], cwd=REPO,
                        env={**env, FAULT_ENV: "3"}, stdout=logs["sup"],
                        stderr=sp.STDOUT, start_new_session=True),
        "ctl": sp.Popen([sys.executable, *common, "--port", str(cport)],
                        cwd=REPO, env=env, stdout=logs["ctl"],
                        stderr=sp.STDOUT, start_new_session=True)}

    def sup_log() -> str:
        logs["sup"].seek(0)
        return logs["sup"].read()

    ask = {"session_id": "s1", "mode": "AC", "max_new_tokens": 16}
    try:
        t0 = time.time()
        up = _wait_serving(port, procs["sup"])
        _wait_serving(cport, procs["ctl"])
        start_s = up - t0
        child = _children(procs["sup"].pid)
        sup_card = _holds_card(procs["sup"].pid)
        child_card = bool(child) and _holds_card(child[0])
        first = []
        for p in (port, cport):
            _http(p, "/session", {"session_id": "s1"})
            ing = _http(p, "/ingest", {"session_id": "s1",
                                       "video_path": clip, "start": 0.0,
                                       "end": 16.0, "fps": 1.0})
            first.append((ing, _http(p, "/ask", {**ask, "question":
                                                 "What is on screen?"})))
        t_req = time.time()
        try:
            _http(port, "/ingest", {"session_id": "s1", "video_path": clip,
                                    "start": 16.0, "end": 48.0, "fps": 1.0})
            code, body = 200, {}
        except urllib.error.HTTPError as e:
            code, body = e.code, json.loads(e.read())
        t_503 = time.time()
        while child and os.path.exists(f"/proc/{child[0]}"):
            time.sleep(0.005)
        t_exit = time.time()
        ready = _wait_serving(port, procs["sup"])
        got = _http(port, "/ask", {**ask, "question": "And now?"})
        want = _http(cport, "/ask", {**ask, "question": "And now?"})
        text = sup_log()
    finally:
        for proc in procs.values():
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait(timeout=60)
        for f in logs.values():
            f.close()
    fault = re.search(r"sticky CUDA error at ([0-9.]+): (.*)", text)
    restore = re.search(r"restored 1 session\(s\) from .* in ([0-9.]+) s",
                        text)
    out = {"start_s": start_s,
           "faulting_request_ms": (t_503 - t_req) * 1e3,
           "fault_to_503_ms": ((t_503 - float(fault.group(1))) * 1e3
                               if fault else None),
           "exit_to_ready_s": ready - t_exit,
           "restore_s": float(restore.group(1)) if restore else None}
    ok = (code == 503 and body.get("backend_fatal") is True
          and body.get("recovering") is True
          and "device-side assert triggered" in body.get("error", "")
          and "serve child died rc=17" in text and fault and restore
          and first[0][1]["tokens"] == first[1][1]["tokens"]
          and got["turn"] == want["turn"] == 1
          and got["tokens"] == want["tokens"]
          and got["cache_tokens"] == want["cache_tokens"]
          and not sup_card and child_card)
    log(f"supervise {label}: served in {start_s:.2f}s; ingest "
        f"{first[0][0]['frames']} frames ({first[0][0]['decode_backend']}), "
        f"ask tokens equal to the control's "
        f"{first[0][1]['tokens'] == first[1][1]['tokens']}; faulting ingest "
        f"-> {code} in {out['faulting_request_ms']:.1f} ms (fault -> 503 "
        f"{out['fault_to_503_ms'] or float('nan'):.3f} ms), error "
        f"{body.get('error', '')[:80]!r}, backend_fatal "
        f"{body.get('backend_fatal')}, recovering {body.get('recovering')}; "
        f"{fault.group(2)[:80] if fault else 'no fault line'}; child exit "
        f"17 {'serve child died rc=17' in text}; exit -> ready "
        f"{out['exit_to_ready_s']:.2f}s, restore {out['restore_s']} s; "
        f"restored ask turn {got['turn']}, tokens equal to the control's "
        f"{got['tokens'] == want['tokens']} ({len(got['tokens'])} tokens); "
        f"supervisor holds the card {sup_card}, child {child_card} "
        f"[{stamp}]")
    if not ok:
        log(text[-4000:])
        raise AssertionError(f"supervised serving ({label}) check failed")
    return out


# ---------------------------------------------------------------------------
# phase 9: pooled serving at full width and depth, and the HTTP server
# ---------------------------------------------------------------------------

POOL_ROWS, POOL_LEN = 4, 16384


def row_checksums(cache, rows):
    """Per pool row, sums of its K, V (as int16 and int32 words) and
    positions: a change of any stored bit changes them (almost surely)."""
    import torch

    out = {}
    for r in rows:
        sums = []
        for t in (cache.k[:, r], cache.v[:, r]):
            for w in (torch.int16, torch.int32):   # one layer at a time
                sums.append(sum(int(t[li].view(w).sum(dtype=torch.int64))
                                for li in range(t.shape[0])))
        sums.append(int(cache.pos[r].sum(dtype=torch.int64)))
        out[r] = tuple(sums)
    return out


def peak_sites(call, top: int = 6):
    """Runs ``call()`` under the CUDA allocator's history and itemizes
    its peak: replays the allocations made during the call (memory
    resident before it is not counted) and sums, at the moment the sum
    was largest, the live bytes by the innermost frame in the port that
    allocated them. Returns (result, peak bytes, [(bytes, site)])."""
    import torch

    hist = torch.cuda.memory
    hist._record_memory_history(enabled="all", context="alloc",
                                stacks="python", max_entries=1_000_000)
    try:
        res = call()
        torch.cuda.synchronize()
        trace = hist._snapshot()["device_traces"][torch.cuda.current_device()]
    finally:
        hist._record_memory_history(enabled=None)

    def site(frames):
        for f in frames:
            if "cogstream_tpu_torch" in f["filename"]:
                name = f["filename"].split("cogstream_tpu_torch/")[-1]
                return f"{name}:{f['line']} {f['name']}"
        return "outside the port"

    live, cur, peak, at_peak = {}, 0, 0, {}
    for e in trace:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], e.get("frames", []))
            cur += e["size"]
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif e["action"] == "free_completed" and e["addr"] in live:
            cur -= live.pop(e["addr"])[0]
    by_site = {}
    for size, frames in at_peak.values():
        key = site(frames)
        by_site[key] = by_site.get(key, 0) + size
    return res, peak, sorted(((b, k) for k, b in by_site.items()),
                             reverse=True)[:top]


def reset_counts():
    for i in BF16_PATH:
        wrapper(i).launches = 0
    for i in TC_PATH:
        wrapper(i).tc_launches = 0
    for i in (2, 3):
        wrapper(i).rows_launches = 0


def read_counts():
    launches = {KERNELS[i][0]: wrapper(i).launches for i in BF16_PATH}
    tc = {KERNELS[i][0]: wrapper(i).tc_launches for i in TC_PATH}
    rows = {KERNELS[i][0]: wrapper(i).rows_launches for i in (2, 3)}
    all_tc = all(tc[KERNELS[i][0]] == launches[KERNELS[i][0]]
                 for i in TC_PATH)
    return launches, tc, rows, all_tc


def pooled_step_cost(pool, stamp: str, steps: int = 10):
    """One pooled decode step over all the pool's rows (B = 4 at their
    fill levels, each query at its row's next position, a read window
    over the deepest row, plus the full-vocab logits), as
    ``decode_step_cost`` measures the solo step: launches and device ms
    from torch.profiler, wall ms over ``steps`` unprofiled steps. Every
    slot is dropped (the step's K/V write puts back the bytes it reads),
    so the rows keep their contents. Returns (launches, device ms, wall
    ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cogstream_tpu_torch.models import qwen2
    from cogstream_tpu_torch.ops.lm_attention import cache_rows
    from cogstream_tpu_torch.runtime.session import StreamingSession

    text, cache = pool.model.text, pool.cache
    order = sorted(pool.sessions)
    dev = cache.pos.device
    rows = cache_rows(order, dev)
    fill = [pool.sessions[r].write_index for r in order]
    window = StreamingSession.kv_window_for(max(fill) + 64, pool.max_len) \
        or pool.max_len
    pos = torch.tensor([[pool.sessions[r].next_pos] for r in order],
                       dtype=torch.int32, device=dev)
    drop = torch.full((len(order), 1), pool.max_len, dtype=torch.int64,
                      device=dev)
    emb = torch.zeros((len(order), 1, text.cfg.hidden_size),
                      dtype=text.dtype, device=dev)
    allowed = torch.ones((len(order), pool.max_len), dtype=torch.bool,
                         device=dev)

    def step():
        h, _ = qwen2.qwen2_forward(text, emb, pos, cache, kv_allowed=allowed,
                                   kv_window=window, write_slots=drop,
                                   cache_rows=rows)
        qwen2.lm_logits(text, h)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    n = sum(e.count for e in kern)
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    top = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in sorted(
                        kern, key=lambda e: -e.self_device_time_total)[:6])
    log(f"pool: decode step over {len(order)} rows (fill {fill}, window "
        f"{window}): {n} launches, device {dev_ms:.2f} ms, wall "
        f"{wall_ms:.2f} ms (busy {dev_ms / wall_ms:.3f}); largest: {top} "
        f"[{stamp}]")
    return n, dev_ms, wall_ms


# phase 9's pooled asks: greedy tokens (ask_stream: 32, two chunks of 16)
POOL_TOKENS = 16


def run_pool_path(model, dev, stamp, b1_rate):
    """Phase 9 (pool), on the phase-5 bf16 7B model: a ``SessionPool`` of
    4 rows x 16384 slots. Two ``ingest_batch`` ticks of one seeded
    16-frame 24x42 segment per row (each row its own seed); ``ask_batch``
    AC, then FCC (``select_batch``) on all 4 rows, 16 greedy tokens; a
    solo ``pool.ask`` on row 1 (K3 / K4 through ``rows``); ``ask_stream``
    on row 2 in chunks of 16; row 3 saved, asked (FCC), closed, restored
    with ``open_restored`` and asked again: the same tokens. Checks: rows
    a call does not address keep their checksums; K1-K4 launch, every
    K1 / K3 / K4 launch on its tensor-core kernel, K3 and K4 launch with
    ``rows``; the solo ask's allocator peak stays below one row's bytes
    (no copy of the whole row). Returns metrics."""
    import shutil

    import torch

    from cogstream_tpu_torch import presets
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.runtime.pool import SessionPool

    cfg = presets.cogreasoner_7b()
    tok = ByteTokenizer(image_token_id=cfg.image_token_index,
                        vocab=cfg.text.vocab_size)
    snap_dir = os.path.join(REPO, "build", "chip_smoke_pool")
    shutil.rmtree(snap_dir, ignore_errors=True)
    os.makedirs(snap_dir)
    t, gh, gw, ms = 16, 24, 42, 2
    metrics = {}
    timer = PhaseTimer()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    try:
        pool = SessionPool(model, cfg, tok, n_rows=POOL_ROWS,
                           max_len=POOL_LEN)
        c = pool.cache
        row_bytes = (c.k[:, 0].numel() * c.k.element_size() * 2
                     + c.pos[0].numel() * 4)
        log(f"pool: {POOL_ROWS} rows x {POOL_LEN} slots, pooled cache "
            f"{nbytes(c.k, c.v, c.pos) / 1e9:.2f} GB ({row_bytes / 1e9:.3f} "
            f"GB a row) [{stamp}]")
        rows = [pool.open() for _ in range(POOL_ROWS)]
        for tick in range(2):
            segs = [np.random.default_rng(100 * tick + r).integers(
                0, 256, (t * gh * gw, 3 * 14 * 14), dtype=np.uint8)
                for r in rows]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pool.ingest_batch([(r, segs[r], (t, gh, gw), ms,
                                [float(tick * t + f) for f in range(t)])
                               for r in rows])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            metrics[f"pool_ingest_tick{tick}_s"] = wall
            log(f"pool: ingest_batch tick {tick}: {wall:.3f}s for "
                f"{POOL_ROWS} x {t} frames ({POOL_ROWS * t / wall:.1f} "
                f"frames/s); fill "
                f"{[pool.sessions[r].write_index for r in rows]} [{stamp}]")
        sel_s, after_sel = [], []
        select_batch = pool.sessions[0].selector.select_batch

        def timed_select(*a, **k):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            out = select_batch(*a, **k)
            torch.cuda.synchronize()
            sel_s.append(time.perf_counter() - s0)
            after_sel.append(timer.mark())
            return out

        pool.sessions[0].selector.select_batch = timed_select
        for mode, q in (("AC", "What is happening in row {}?"),
                        ("FCC", "What changed in row {}?")):
            mark = timer.mark()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pool.ask_batch([(r, q.format(r)) for r in rows],
                                 mode=mode, max_new_tokens=POOL_TOKENS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rate = timer.decode_rate(after_sel[-1] if mode == "FCC"
                                     else mark)
            metrics[f"pool_ask_batch_{mode}_s"] = wall
            metrics[f"pool_{mode}_decode_tok_per_s_per_row"] = rate
            n_tok = [len(out[r]["tokens"]) for r in rows]
            log(f"pool: ask_batch {mode}: {wall:.3f}s"
                + (f"; selector batch {sel_s[-1]:.3f}s" if mode == "FCC"
                   else "")
                + f"; tokens {n_tok}; marginal decode {rate:.1f} tok/s a "
                f"row, {POOL_ROWS * rate:.1f} tok/s over {POOL_ROWS} rows "
                f"(phase 5, B = 1: {b1_rate:.1f}); "
                f"{timer.step_split(after_sel[-1] if mode == 'FCC' else mark)}"
                f"; selections "
                f"{[out[r]['selection'] for r in rows]} [{stamp}]")
            if min(n_tok) == 0 or not all(
                    0 <= x < cfg.text.vocab_size for r in rows
                    for x in out[r]["tokens"]):
                raise AssertionError(f"pool ask_batch {mode} answers bad")
        pool.sessions[0].selector.select_batch = select_batch
        if sel_s:
            metrics["pool_selector_batch_s"] = sel_s[-1]
        before = row_checksums(pool.cache, rows)
        (metrics["pool_step_launches"], metrics["pool_step_device_ms"],
         metrics["pool_step_ms"]) = pooled_step_cost(pool, stamp)
        if row_checksums(pool.cache, rows) != before:
            raise AssertionError("the measured pooled step changed a row")

        def untouched(call, row, label):
            """``call()``'s result, wall s and allocator peak above the
            memory resident before it (the rows' checksums allocate per
            layer, so the peak is taken around the call alone); the other
            rows' checksums must not change."""
            others = [r for r in rows if r != row]
            before = row_checksums(pool.cache, others)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            same = row_checksums(pool.cache, others) == before
            log(f"pool: {label}: {wall:.3f}s; rows {others} unchanged "
                f"{same} [{stamp}]")
            if not same:
                raise AssertionError(f"{label} changed rows it does not "
                                     "address")
            return res, wall, peak

        r0 = (wrapper(2).rows_launches, wrapper(3).rows_launches)
        solo, _, peak = untouched(lambda: pool.ask(
            1, "What is on screen now?", mode="FCC",
            max_new_tokens=POOL_TOKENS),
            1, "solo ask on row 1")
        rows_used = (wrapper(2).rows_launches - r0[0],
                     wrapper(3).rows_launches - r0[1])
        log(f"pool: solo ask on row 1: {len(solo['tokens'])} tokens; "
            f"allocator peak above the resident {peak / 1e9:.3f} GB (one "
            f"row {row_bytes / 1e9:.3f} GB); K3 / K4 launches with rows "
            f"{rows_used} [{stamp}]")
        # the bound catches a copy of the whole row; a copy of one layer's
        # share would fit under it: that one tests/test_torch_pool.py
        # excludes (every pooled K3 / K4 call gets the pool's storage)
        if not peak < row_bytes or min(rows_used) == 0:
            raise AssertionError("the solo pooled ask copied its whole row "
                                 "or did not read it through rows")
        deltas, wall, _ = untouched(lambda: list(pool.sessions[2].ask_stream(
            "Describe it step by step.", mode="AC", max_new_tokens=32,
            chunk=16)), 2, "ask_stream on row 2 (chunks of 16)")
        final = deltas[-1]
        if not isinstance(final, dict) or "".join(deltas[:-1]) != \
                final["text"]:
            raise AssertionError("ask_stream did not end with its result")
        metrics["pool_ask_stream_s"] = wall

        path = os.path.join(snap_dir, "row3.snap.npz")
        _, save_s, _ = untouched(lambda: pool.sessions[3].save(path), 3,
                              "save row 3")
        q3 = "What happened to the last block?"
        first, _, _ = untouched(
            lambda: pool.ask(3, q3, mode="FCC", max_new_tokens=POOL_TOKENS),
            3,
            "FCC ask on row 3")
        pool.close(3)
        new_row, restore_s, _ = untouched(
            lambda: pool.open_restored(path), 3,
            "restore row 3 (open_restored)")
        (again, peak3, sites), _, _ = untouched(
            lambda: peak_sites(lambda: pool.ask(
                new_row, q3, mode="FCC", max_new_tokens=POOL_TOKENS)), 3,
            "FCC ask on the restored row (allocations recorded)")
        log(f"pool: the restored row's solo FCC ask peaked "
            f"{peak3 / 1e9:.3f} GB above the resident; live at the peak, "
            f"by allocating site: " + "; ".join(
                f"{site} {b / 1e6:.1f} MB" for b, site in sites)
            + f" [{stamp}]")
        snap_bytes = os.path.getsize(path)
        same = again["tokens"] == first["tokens"] and \
            again["selection"] == first["selection"]
        metrics.update(pool_snapshot_bytes=snap_bytes,
                       pool_save_s=save_s, pool_restore_s=restore_s)
        log(f"pool: snapshot of row 3 {snap_bytes / 1e6:.1f} MB, save "
            f"{save_s:.3f}s, restore {restore_s:.3f}s onto row {new_row}; "
            f"the restored row answers the same tokens {same} [{stamp}]")
        if new_row != 3 or not same:
            raise AssertionError("the restored row answers differently")
    finally:
        timer.restore()
        shutil.rmtree(snap_dir, ignore_errors=True)
    torch.cuda.synchronize()
    launches, tc, rows_n, all_tc = read_counts()
    finite = bool(torch.isfinite(pool.cache.k).all()
                  and torch.isfinite(pool.cache.v).all())
    log(f"pool: {time.perf_counter() - t_phase:.1f}s; launches {launches}, "
        f"on the tensor-core kernels {tc} (all {all_tc}), with rows "
        f"{rows_n}; cache finite {finite}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{stamp}]")
    if min(launches.values()) == 0 or not all_tc or min(rows_n.values()) == 0 \
            or not finite:
        raise AssertionError("pool path check failed")
    metrics["pool_launches"] = launches
    metrics["pool_rows_launches"] = rows_n
    del pool
    gc.collect()     # sessions and their pool refer to each other
    return metrics


def run_fp8_pool(model, dev, stamp):
    """Phase 9 (c), the fp8 pool: a ``SessionPool`` of 4 rows x 16384
    slots with ``kv_dtype=torch.float8_e4m3fn`` on the phase-5 model, its
    allocated bytes beside the bf16 pool's 3.76 GB; one ``ingest_batch``
    tick of phase 9's seeded segments and ``ask_batch`` AC on all rows
    (16 greedy tokens), its decode tok/s. K3 and K4 must launch over the
    e4m3 pool through ``rows``, every launch on its tensor-core kernel.
    Returns metrics."""
    import torch

    from cogstream_tpu_torch import presets
    from cogstream_tpu_torch.ops import lm_attention as lma
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.runtime.pool import SessionPool

    cfg = presets.cogreasoner_7b()
    tok = ByteTokenizer(image_token_id=cfg.image_token_index,
                        vocab=cfg.text.vocab_size)
    t, gh, gw, ms = 16, 24, 42, 2
    k3, k4 = lma.prefill_flash_attention, lma.decode_attention
    for w in (k3, k4):
        w.launches = w.tc_launches = w.fp8_launches = w.rows_launches = 0
    timer = PhaseTimer()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    try:
        pool = SessionPool(model, cfg, tok, n_rows=POOL_ROWS,
                           max_len=POOL_LEN, kv_dtype=torch.float8_e4m3fn)
        torch.cuda.synchronize()
        alloc = torch.cuda.memory_allocated() - base
        c = pool.cache
        bf16_bytes = (c.k.numel() + c.v.numel()) * 2 + c.pos.numel() * 4
        log(f"pool fp8: {POOL_ROWS} rows x {POOL_LEN} slots, e4m3 cache "
            f"{nbytes(c.k, c.v, c.pos) / 1e9:.3f} GB (allocated "
            f"{alloc / 1e9:.3f} GB) against the bf16 pool's "
            f"{bf16_bytes / 1e9:.3f} GB [{stamp}]")
        rows = [pool.open() for _ in range(POOL_ROWS)]
        segs = [np.random.default_rng(r).integers(
            0, 256, (t * gh * gw, 3 * 14 * 14), dtype=np.uint8) for r in rows]
        t0 = time.perf_counter()
        pool.ingest_batch([(r, segs[r], (t, gh, gw), ms,
                            [float(f) for f in range(t)]) for r in rows])
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        mark = timer.mark()
        t0 = time.perf_counter()
        out = pool.ask_batch([(r, f"What is happening in row {r}?")
                              for r in rows], mode="AC",
                             max_new_tokens=POOL_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rate = timer.decode_rate(mark)
        n_tok = [len(out[r]["tokens"]) for r in rows]
        u8 = c.k.view(torch.uint8)
        nan = int(((u8 & 0x7F) == 0x7F).sum())
        counts = {n: (w.launches, w.tc_launches, w.fp8_launches,
                      w.rows_launches) for n, w in (("K3", k3), ("K4", k4))}
        log(f"pool fp8: ingest_batch {ingest_s:.3f}s for {POOL_ROWS} x {t} "
            f"frames; ask_batch AC {wall:.3f}s, tokens {n_tok}, marginal "
            f"decode {rate:.1f} tok/s a row, {POOL_ROWS * rate:.1f} tok/s "
            f"over {POOL_ROWS} rows; {timer.step_split(mark)}; K NaN bytes "
            f"{nan}; K3 / K4 (launches, tensor-core, over e4m3, with rows) "
            f"{counts} [{stamp}]")
        if nan or min(n_tok) == 0 or any(
                c_[0] != c_[1] or c_[2] == 0 or c_[3] == 0
                for c_ in counts.values()):
            raise AssertionError("fp8 pool path check failed")
    finally:
        timer.restore()
    metrics = {"pool_fp8_cache_bytes": nbytes(c.k, c.v, c.pos),
               "pool_fp8_allocated_bytes": alloc,
               "pool_bf16_cache_bytes": bf16_bytes,
               "pool_fp8_ingest_s": ingest_s,
               "pool_fp8_AC_decode_tok_per_s_per_row": rate}
    del pool, c, u8
    gc.collect()
    torch.cuda.empty_cache()
    return metrics


def run_http_path(model, dev, stamp):
    """Phase 9 (HTTP): ``SessionServer(pool_rows=4)`` on the same model,
    served on 127.0.0.1 at a free port from a thread. Four client threads
    each POST /session, /ingest of phase 8's clip (written again under
    build/: its mp4v file, or its .npy frame directory where OpenCV
    writes none), then /ask FCC twice (after all four ingested); client 0
    then runs /ask_stream; /stats is read. Every response must be
    well-formed JSON with a non-empty answer, the stream must end with
    0x1e and its meta, and the frontend must have answered a batch of
    more than one row. Prints per-request latencies."""
    import shutil
    import threading
    import urllib.request

    import torch

    from cogstream_tpu_torch import presets
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.runtime.serve import (SessionServer,
                                                   make_http_server)

    cfg = presets.cogreasoner_7b()
    tok = ByteTokenizer(image_token_id=cfg.image_token_index,
                        vocab=cfg.text.vocab_size)
    shutil.rmtree(ENGINE_DIR, ignore_errors=True)
    found = probe_host_decoders()
    route = "cv2" if found["cv2_mp4v"] else "npy"
    video_dir, _ = write_engine_inputs(route)
    video = os.path.join(video_dir, os.listdir(video_dir)[0])
    server = SessionServer(model, cfg, tok, max_len=POOL_LEN,
                           pool_rows=POOL_ROWS)
    httpd = make_http_server(server, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    port = httpd.server_address[1]
    lat, errors, answers = {}, [], {}
    gate = threading.Barrier(POOL_ROWS)

    def post(path, body, key):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            raw = r.read()
        lat[key] = time.perf_counter() - t0
        return raw

    def client(i):
        sid = f"c{i}"
        try:
            json.loads(post("/session", {"session_id": sid}, f"{sid} session"))
            ing = json.loads(post("/ingest", {"session_id": sid,
                                              "video_path": video,
                                              "fps": 1.0}, f"{sid} ingest"))
            answers[f"{sid} ingest"] = ing
            gate.wait(timeout=600)
            for j in range(2):
                a = json.loads(post("/ask", {
                    "session_id": sid, "mode": "FCC", "max_new_tokens": 32,
                    "question": f"What is client {i} watching ({j})?"},
                    f"{sid} ask{j}"))
                answers[f"{sid} ask{j}"] = a
                if not (isinstance(a.get("text"), str) and a.get("tokens")
                        and a["turn"] == j):
                    raise AssertionError(f"{sid} ask{j}: empty answer {a}")
            if i == 0:
                raw = post("/ask_stream", {
                    "session_id": sid, "mode": "AC", "max_new_tokens": 32,
                    "question": "Tell me what happens, step by step."},
                    f"{sid} ask_stream")
                text, sep, meta = raw.rpartition(b"\x1e")
                meta = json.loads(meta)
                answers[f"{sid} ask_stream"] = meta
                if not sep or meta["text"] != text.decode() \
                        or meta["turn"] != 2:
                    raise AssertionError(f"bad stream {raw[-200:]!r}")
        except Exception as e:  # noqa: BLE001
            errors.append(f"{sid}: {type(e).__name__}: {e}")
            gate.abort()

    reset_counts()
    t0 = time.perf_counter()
    try:
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(POOL_ROWS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=900)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        shutil.rmtree(ENGINE_DIR, ignore_errors=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, tc, rows_n, all_tc = read_counts()
    batches = (server.frontend.ask_batches, server.frontend.max_batch_rows)
    for key in sorted(lat):
        log(f"http: {key}: {lat[key]:.3f}s [{stamp}]")
    ing = answers.get("c0 ingest", {})
    log(f"http: {POOL_ROWS} clients in {wall:.1f}s; ingest of {video!r} "
        f"({route}): {ing.get('frames')} frames, backend "
        f"{ing.get('decode_backend')}, cache {ing.get('cache_tokens')} slots;"
        f" ask batches (count, most rows) {batches}; stats "
        f"{json.dumps(stats)}; launches {launches}, on the tensor-core "
        f"kernels {tc} (all {all_tc}), with rows {rows_n}; errors {errors} "
        f"[{stamp}]")
    if errors or len(answers) != 3 * POOL_ROWS + 1 or batches[1] < 2 \
            or min(launches.values()) == 0 or not all_tc:
        raise AssertionError("http path check failed")
    del server, httpd
    gc.collect()     # sessions and their pool refer to each other
    return {"http_wall_s": wall, "http_latency_s": lat,
            "http_ask_batches": batches}


# ---------------------------------------------------------------------------
# phase 10: the int8 main path, W8A8 prefill, the W8A8 tower, quant quality
# ---------------------------------------------------------------------------

def shared_copy(module):
    """A copy of ``module`` with new submodules over its own tensors (a
    deep copy whose memo maps every parameter and buffer to itself):
    quantizing the copy in place replaces the copy's linears only, so
    ``module``'s bf16 weights stay where they are and its embeddings, norms
    and biases are shared."""
    import copy

    shared = list(module.parameters()) + list(module.buffers())
    return copy.deepcopy(module, memo={id(t): t for t in shared})


class DequantSpy:
    """Counts int8 dequantizations on the card (``quant.dequantize_int8``
    and K10's plain form) made inside a decode-length forward or logits
    call (at most 8 rows), where K10 must run instead (instrumentation of
    this script only)."""

    def __init__(self):
        from cogstream_tpu_torch.models import qwen2
        from cogstream_tpu_torch.ops import int8_gemv, quant

        self.calls = 0
        rows = []
        deq, plain = quant.dequantize_int8, int8_gemv._plain
        fwd, head = qwen2.qwen2_forward, qwen2.lm_logits

        def count(t):
            if rows and rows[-1] <= 8 and t.is_cuda:
                self.calls += 1

        def spy_deq(qp, *a, **k):
            count(qp["q"])
            return deq(qp, *a, **k)

        def spy_plain(x, *a, **k):
            count(x)
            return plain(x, *a, **k)

        def scoped(fn):
            def run(model, h, *a, **k):
                rows.append(h.shape[1])
                try:
                    return fn(model, h, *a, **k)
                finally:
                    rows.pop()
            return run

        quant.dequantize_int8, int8_gemv._plain = spy_deq, spy_plain
        qwen2.qwen2_forward, qwen2.lm_logits = scoped(fwd), scoped(head)
        self.restore = lambda: (
            setattr(quant, "dequantize_int8", deq),
            setattr(int8_gemv, "_plain", plain),
            setattr(qwen2, "qwen2_forward", fwd),
            setattr(qwen2, "lm_logits", head))


class GemvRows:
    """Launches of K8, K9 and K10 by the rows m of each call, while
    installed (instrumentation of this script only). Each spy shares its
    wrapper's attribute dict, so the wrapper's own counts, which it bumps
    through its module-level name, stay whole."""

    def __init__(self):
        from cogstream_tpu_torch.ops import int8_gemv, quant_gemv

        self.by_m = {}
        self._undo = []
        for mod, name in ((quant_gemv, "gemv_k8"), (quant_gemv, "gemv_k9"),
                          (int8_gemv, "gemv_k10")):
            fn = getattr(mod, name)

            def spy(x, *a, _fn=fn, _name=name[5:].upper(), **k):
                n0 = _fn.launches
                out = _fn(x, *a, **k)
                if _fn.launches > n0:
                    key = f"{_name} m={x.shape[0]}"
                    self.by_m[key] = self.by_m.get(key, 0) + 1
                return out

            spy.__dict__ = fn.__dict__
            setattr(mod, name, spy)
            self._undo.append((mod, name, fn))

    def restore(self):
        for mod, name, fn in self._undo:
            setattr(mod, name, fn)


def quantized_lookahead_ask(sess, label: str, stamp: str, k: int = 4):
    """Phases 6 and 10: one AC ask (32 tokens) with ``lookahead_k=k`` on a
    quantized session: the verify steps' GEMV launches at m = k+1, the
    steps and the decode tok/s."""
    import torch

    timer = PhaseTimer()
    rows = GemvRows()
    try:
        mark = timer.mark()
        r = sess.ask(LA_QUESTION, mode="AC", max_new_tokens=32,
                     lookahead_k=k)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        rows.restore()
        timer.restore()
    n, steps = len(r["tokens"]), sess.last_lookahead_steps
    rate = timer.gen_rate(mark, k + 1, n - 1, t_end)
    at_m = {key: c for key, c in rows.by_m.items()
            if key.endswith(f"m={k + 1}")}
    log(f"{label} lookahead ask (AC, k={k}): {n} tokens in {steps} verify "
        f"steps ({(n - 1 - steps) / (steps * k):.3f} of drafts accepted, "
        f"random weights), decode {rate:.1f} tok/s; GEMV launches at m = "
        f"{k + 1}: {at_m}; all by m {rows.by_m} [{stamp}]")
    if not steps or not at_m:
        raise AssertionError(f"{label} lookahead ask ran no verify GEMV")
    return {"steps": steps, "tokens": n, "decode_tok_per_s": rate,
            "launches_at_m": at_m}


# the quantized paths' FCC asks (phases 10 and 6): greedy tokens
QUANT_FCC_TOKENS = 16


def run_int8_path(model, dev, stamp):
    """Phase 10, on the phase-5 bf16 7B model: (a) an int8 copy of the
    decoder beside the bf16 one, one decode step of each (launches,
    device ms, wall ms); (b) for (w8a8_prefill, encoder_int8) = (off,
    off), (on, off), (on, on) a fresh session on the int8 decoder ingests
    a 16-frame 24x42 segment and answers AC (8 tokens) then FCC (16).
    K10 must launch in every mode, ``torch._int_mm`` in the decoder only
    under w8a8_prefill and in the tower only under encoder_int8, no
    decode step may dequantize an int8 weight, every K1 / K3 / K4 launch
    is on its tensor-core kernel; (c) the quantization-quality ladder at
    full width and depth. Returns (K10's launches in (b), metrics)."""
    import dataclasses

    import torch

    from cogstream_tpu_torch import presets
    from cogstream_tpu_torch.models.cogreasoner import CogReasoner
    from cogstream_tpu_torch.ops import quant
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.runtime.session import StreamingSession

    cfg0 = presets.cogreasoner_7b()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text8 = quant.quantize_text_(shared_copy(model.text), bits=8)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    gib = (quant.quantized_bytes(text8.int8)
           + quant.quantized_bytes(text8.lm_head)) / 2**30
    log(f"int8: decoder copied to int8 in {quant_s:.1f}s: {gib:.2f} GiB of "
        f"int8 weights and scales beside the bf16 ones; card "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated [{stamp}]")
    metrics = {"int8_weights_gib": gib}
    spy = DequantSpy()
    try:
        for label, text in (("bf16", model.text), ("int8", text8)):
            n, dev_ms, wall_ms, gemv_ms = decode_step_cost(text, label, stamp)
            metrics.update({f"p10_{label}_step_launches": n,
                            f"p10_{label}_step_device_ms": dev_ms,
                            f"p10_{label}_step_ms": wall_ms,
                            f"p10_{label}_step_gemv_device_ms": gemv_ms})
        step_deq = spy.calls
        tok = ByteTokenizer(image_token_id=cfg0.image_token_index,
                            vocab=cfg0.text.vocab_size)
        rng = np.random.default_rng(5)
        t, gh, gw, ms = 16, 24, 42, 2
        pv = rng.integers(0, 256, (t * gh * gw, 3 * 14 * 14), dtype=np.uint8)
        k10 = 0
        for w8, enc in ((False, False), (True, False), (True, True)):
            mode = (f"w8a8_prefill={'on' if w8 else 'off'}, "
                    f"encoder_int8={'on' if enc else 'off'}")
            cfg = dataclasses.replace(cfg0, text=dataclasses.replace(
                cfg0.text, w8a8_prefill=w8))
            reset_counts()
            wrapper(9).launches = wrapper(9).sm90_launches = 0
            mm0 = dict(quant.int8_mm.calls)
            spy.calls = 0
            timer = PhaseTimer()
            sess = StreamingSession(CogReasoner(text8, model.vision,
                                                model.projector), cfg, tok,
                                    max_len=16384, encoder_int8=enc)
            mark = timer.mark()
            t0 = time.perf_counter()
            sess.append_stream_segment(pv, (t, gh, gw), ms,
                                       timestamps=[float(f) for f in range(t)])
            torch.cuda.synchronize()
            ingest_s = time.perf_counter() - t0
            pf = [(S, b - a) for S, a, b in timer.forwards[mark:] if S > 8]
            sess.ask("What is happening in the video?", mode="AC",
                     max_new_tokens=8)
            mark = timer.mark()
            t0 = time.perf_counter()
            r = sess.ask("What changed since then?", mode="FCC",
                         max_new_tokens=QUANT_FCC_TOKENS)
            torch.cuda.synchronize()
            turn_s = time.perf_counter() - t0
            dec = timer.decode_rate(mark)
            timer.restore()
            launches, tc, _, all_tc = read_counts()
            n10 = wrapper(9).launches
            k10 += n10
            mm = {k: v - mm0.get(k, 0) for k, v in quant.int8_mm.calls.items()}
            wi = sess.write_index
            finite = bool(torch.isfinite(sess.cache.k[:, :, :wi]).all()
                          and torch.isfinite(sess.cache.v[:, :, :wi]).all())
            key = ("w8a8_" if w8 else "") + ("enc8_" if enc else "")
            metrics.update({f"int8_{key}ingest_s": ingest_s,
                            f"int8_{key}prefill_tok_per_s":
                                pf[0][0] / pf[0][1],
                            f"int8_{key}FCC_turn_s": turn_s,
                            f"int8_{key}decode_tok_per_s": dec})
            log(f"int8 path, {mode}: ingest {ingest_s:.3f}s (prefill "
                f"{pf[0][0]} tokens in {pf[0][1]:.3f}s, "
                f"{pf[0][0] / pf[0][1]:.0f} tok/s); FCC turn {turn_s:.3f}s, "
                f"{len(r['tokens'])} tokens, marginal decode {dec:.1f} tok/s; "
                f"K10 launches {n10} ({wrapper(9).sm90_launches} on the "
                f"persistent kernel); _int_mm calls {mm}; int8 dequantized "
                f"in decode steps {spy.calls}; K1-K4 launches {launches}, "
                f"all K1/K3/K4 on tensor cores {all_tc}; finite {finite} "
                f"[{stamp}]")
            toks = r["tokens"]
            ok = (n10 > 0 and (mm.get("decoder", 0) > 0) == w8
                  and (mm.get("tower", 0) > 0) == enc and spy.calls == 0
                  and all_tc and finite and toks
                  and all(0 <= x < cfg.text.vocab_size for x in toks))
            if not ok:
                raise AssertionError(f"int8 main path ({mode}) check failed")
            if not (w8 or enc):
                deq0 = spy.calls
                metrics["int8_lookahead"] = quantized_lookahead_ask(
                    sess, "int8 path", stamp)
                if spy.calls != deq0:
                    raise AssertionError("an int8 verify step dequantized "
                                         f"{spy.calls - deq0} weights")
            del sess
    finally:
        spy.restore()
    if step_deq:
        raise AssertionError(f"an int8 decode step dequantized {step_deq} "
                             "weights")
    del text8
    torch.cuda.empty_cache()
    metrics.update(run_quant_quality(cfg0.text, dev, stamp))
    return [k10], metrics


# phase 10's greedy prefix agreement: tokens
QUALITY_TOKENS = 16


def fp8kv_quality(model, cfg, ids, greedy, stamp):
    """The fp8kv row of the quality ladder on the bf16 build: logit MAE,
    KL and top-1 agreement of ``cached_logits`` over an e4m3 cache
    against a bf16 cache, and the greedy prefix agreement of the e4m3
    cache's continuation with the bf16 one's; K3 and K4 must launch over
    the e4m3 cache."""
    import torch

    from cogstream_tpu_torch.evaluate import quant_quality as qq
    from cogstream_tpu_torch.ops import lm_attention as lma

    f8 = torch.float8_e4m3fn
    f0 = (lma.prefill_flash_attention.fp8_launches,
          lma.decode_attention.fp8_launches)
    row = qq.compare_logits(qq.cached_logits(model, ids, cfg, 512),
                            qq.cached_logits(model, ids, cfg, 512,
                                             kv_dtype=f8), "fp8kv")
    row["fp8kv_prefix_agree"] = qq.prefix_agreement(
        greedy, qq.greedy_continuation(model, cfg, ids, n=QUALITY_TOKENS, max_len=512,
                                       kv_dtype=f8))
    used = (lma.prefill_flash_attention.fp8_launches - f0[0],
            lma.decode_attention.fp8_launches - f0[1])
    log("quality: fp8kv (e4m3 cache vs bf16 cache, cached logits): "
        + ", ".join(f"{k[6:]} {v}" for k, v in row.items())
        + f"; K3 / K4 launches over e4m3 {used} [{stamp}]")
    if min(used) == 0:
        raise AssertionError("the fp8kv probe did not read an e4m3 cache")
    return row


def run_quant_quality(tcfg, dev, stamp):
    """Phase 10 (c): ``evaluate/quant_quality`` at full 7B width and depth,
    one scheme resident at a time, each built from the same seeded floats:
    bf16 (the truth), int8, int8 with W8A8 prefill, int4u, int4c, nf4.
    Teacher-forced logits over 128 probe tokens (logit MAE, KL, top-1
    agreement) and greedy prefix agreement over 16 tokens, each against
    bf16. int8's KL must be below each 4-bit scheme's. On the bf16 build,
    the fp8kv row: the cached logits (K3) and the greedy continuation (K4)
    over an e4m3 cache against a bf16 cache."""
    import dataclasses

    import torch

    from cogstream_tpu_torch.evaluate import quant_quality as qq

    ids = qq.probe_ids(tcfg, n=128, device=dev)
    w8cfg = dataclasses.replace(tcfg, w8a8_prefill=True)
    out, truth, model = {}, None, None
    for scheme in ("bf16", "int8", "int8+w8a8", "int4u", "int4c", "nf4"):
        t0 = time.perf_counter()
        if scheme != "int8+w8a8":        # W8A8 reuses the int8 build
            model = None
            torch.cuda.empty_cache()
            model = qq.build_text_params(tcfg, scheme, seed=0, device=dev)
        cfg = w8cfg if scheme == "int8+w8a8" else tcfg
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        logits = qq.tf_logits(model, ids, cfg)
        greedy = qq.greedy_continuation(model, cfg, ids, n=QUALITY_TOKENS,
                                        max_len=512)
        torch.cuda.synchronize()
        if truth is None:
            truth = (logits, greedy)
            log(f"quality: bf16 truth built in {build_s:.1f}s; "
                f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated "
                f"[{stamp}]")
            out.update(fp8kv_quality(model, cfg, ids, greedy, stamp))
            continue
        key = scheme.replace("+", "_")
        row = qq.compare_logits(truth[0], logits, key)
        row[f"{key}_prefix_agree"] = qq.prefix_agreement(truth[1], greedy)
        out.update(row)
        log(f"quality: {scheme} vs bf16 (built in {build_s:.1f}s): "
            + ", ".join(f"{k[len(key) + 1:]} {v}" for k, v in row.items())
            + f" [{stamp}]")
    del model
    torch.cuda.empty_cache()
    worse = [s for s in ("int4u", "int4c", "nf4")
             if not out["int8_kl"] < out[f"{s}_kl"]]
    if worse:
        raise AssertionError(f"int8's KL is not below {worse}'s")
    return {"quality": out}


# ---------------------------------------------------------------------------
# phase 6: the int4 main path
# ---------------------------------------------------------------------------

def run_int4_path(model, dev, stamp):
    """Quantize the main path's 7B-width decoder in place (every q/k/v/o,
    gate/up/down and the lm_head to rank-1 uniform int4; the bf16
    weights are freed) and measure one decode step per mode; then for
    w4a8_decode False and True: a fresh session ingests one 16-frame
    segment, answers a short ask(AC) (the history the selector reads)
    and then ask(FCC); then a third session with w8a8_prefill (and
    w4a8_decode off). Only the sessions' launches are counted: K6 and
    K8 must launch without w4a8_decode and K7 and K9 never; K7 and K9
    must launch with it; under w8a8_prefill the segment prefill (m > 64)
    takes the W4A8 prefill branch (``torch._int_mm`` on the nibbles) and
    the question prefills (16 <= S <= 64) K9, while decode steps stay on
    K6 / K8. Outputs finite, ranges ordered."""
    import dataclasses

    import torch

    from cogstream_tpu_torch import presets
    from cogstream_tpu_torch.ops.quant import (int8_mm, quantize_text_,
                                               quantized_bytes)
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.runtime.session import StreamingSession

    cfg0 = presets.cogreasoner_7b()
    text = model.text
    bf16_launches, bf16_dev_ms, bf16_step_ms, _ = decode_step_cost(
        text, "bf16", stamp)
    torch.cuda.synchronize()
    mem0, dec0 = torch.cuda.memory_allocated(), quantized_bytes(text)
    t0 = time.perf_counter()
    quantize_text_(text)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    mem1, dec1 = torch.cuda.memory_allocated(), quantized_bytes(text)
    log(f"int4: decoder quantized in place in {quant_s:.1f}s; decoder "
        f"{dec0 / 2**30:.2f} -> {dec1 / 2**30:.2f} GiB; card "
        f"{mem0 / 2**30:.2f} -> {mem1 / 2**30:.2f} GiB allocated [{stamp}]")
    metrics = {"int4_decoder_gib": dec1 / 2**30,
               "bf16_decoder_gib": dec0 / 2**30,
               "bf16_step_launches": bf16_launches,
               "bf16_step_device_ms": bf16_dev_ms,
               "bf16_step_ms": bf16_step_ms}
    tok = ByteTokenizer(image_token_id=cfg0.image_token_index,
                        vocab=cfg0.text.vocab_size)
    rng = np.random.default_rng(2)
    t, gh, gw, ms = 16, 24, 42, 2
    pv = rng.integers(0, 256, (t * gh * gw, 3 * 14 * 14), dtype=np.uint8)

    def set_mode(w4a8, w8=False):
        cfg = dataclasses.replace(cfg0, text=dataclasses.replace(
            cfg0.text, w4a8_decode=w4a8, w8a8_prefill=w8))
        text.cfg = cfg.text
        return cfg

    # the per-step cost first, and that of a 64-token question prefill
    # (the GEMV route at m = 64): their scratch steps launch K6-K9 outside
    # the sessions, so they run before the sessions' counts start
    for w4a8 in (False, True):
        set_mode(w4a8)
        mode = "w4a8" if w4a8 else "int4"
        n, dev_ms, step_ms, gemv_ms = decode_step_cost(text, mode, stamp)
        metrics[f"{mode}_step_launches"] = n
        metrics[f"{mode}_step_device_ms"] = dev_ms
        metrics[f"{mode}_step_ms"] = step_ms
        metrics[f"{mode}_step_gemv_device_ms"] = gemv_ms
        n, dev_ms, step_ms, gemv_ms = decode_step_cost(text, mode, stamp,
                                                       steps=4, tokens=64)
        metrics[f"{mode}_prefill64_device_ms"] = dev_ms
        metrics[f"{mode}_prefill64_ms"] = step_ms
        metrics[f"{mode}_prefill64_gemv_device_ms"] = gemv_ms

    names = [KERNELS[i][0] for i in INT4_PATH]
    launches = [0] * len(names)
    for w4a8, w8 in ((False, False), (True, False), (False, True)):
        mode = "w4a8" if w4a8 else "w8a8p" if w8 else "int4"
        cfg = set_mode(w4a8, w8)
        for i in INT4_PATH:                # count this session only
            wrapper(i).launches = 0
        for i in STACKED:
            wrapper(i).multirow_launches = 0
        mm0 = int8_mm.calls.get("decoder", 0)
        timer = PhaseTimer()
        sess = StreamingSession(model, cfg, tok, max_len=16384)
        mark = timer.mark()
        t0 = time.perf_counter()
        sess.append_stream_segment(pv, (t, gh, gw), ms,
                                   timestamps=[float(f) for f in range(t)])
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        pf = [(S, b - a) for S, a, b in timer.forwards[mark:] if S > 8]
        mark = timer.mark()
        t0 = time.perf_counter()
        sess.ask("What is happening in the video?", mode="AC",
                 max_new_tokens=8)
        torch.cuda.synchronize()
        ac_s = time.perf_counter() - t0
        # the question prefills: the asks' forwards of 1 < S <= 64 tokens,
        # which take the GEMV route at m = S
        qpf = [(S, b - a) for S, a, b in timer.forwards[mark:]
               if 1 < S <= 64]
        sel_s, after_sel = [], []
        select = sess.selector.select

        def timed_select(*a, **k):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            out = select(*a, **k)
            torch.cuda.synchronize()
            sel_s.append(time.perf_counter() - s0)
            after_sel.append(timer.mark())
            return out

        sess.selector.select = timed_select
        mark = timer.mark()
        t0 = time.perf_counter()
        r = sess.ask("What changed since then?", mode="FCC",
                     max_new_tokens=QUANT_FCC_TOKENS)
        torch.cuda.synchronize()
        turn_s = time.perf_counter() - t0
        dec = timer.decode_rate(after_sel[0] if after_sel else mark)
        qpf += [(S, b - a) for S, a, b in timer.forwards[mark:]
                if 1 < S <= 64]
        timer.restore()
        counts = dict(zip(names, (wrapper(i).launches for i in INT4_PATH)))
        multirow = {KERNELS[i][0]: wrapper(i).multirow_launches
                    for i in STACKED}
        by_m = {k: {"m=1": counts[k] - n, "1<m<=64": n}
                for k, n in multirow.items()}
        launches = [a + b for a, b in zip(launches, counts.values())]
        prefill_mm = int8_mm.calls.get("decoder", 0) - mm0
        metrics.update({f"{mode}_ingest_s": ingest_s,
                        f"{mode}_prefill_int_mm_calls": prefill_mm,
                        f"{mode}_prefill_tok_per_s": pf[0][0] / pf[0][1],
                        f"{mode}_AC_turn_s": ac_s,
                        f"{mode}_question_prefill_s": [b for _, b in qpf],
                        f"{mode}_question_prefill_tokens":
                            [a for a, _ in qpf],
                        f"{mode}_stacked_launches_by_m": by_m,
                        f"{mode}_FCC_turn_s": turn_s,
                        f"{mode}_selector_s": sel_s[0] if sel_s else None,
                        f"{mode}_decode_tok_per_s": dec})
        toks = r["tokens"]
        wi = sess.write_index
        finite = bool(torch.isfinite(sess.cache.k[:, :, :wi]).all()
                      and torch.isfinite(sess.cache.v[:, :, :wi]).all()
                      and all(torch.isfinite(e.rep).all()
                              for e in sess.events))
        starts = [x.start for x in sess.ranges]
        ends = [x.end for x in sess.ranges]
        ordered = (starts == sorted(starts)
                   and all(e <= s for e, s in zip(ends[:-1], starts[1:]))
                   and all(x.start <= x.end for x in sess.ranges))
        log(f"int4 path, w4a8_decode={w4a8}, w8a8_prefill={w8}: ingest "
            f"{ingest_s:.3f}s "
            f"(prefill {pf[0][0]} tokens in {pf[0][1]:.3f}s); FCC turn "
            f"{turn_s:.3f}s, selector {(sel_s[0] if sel_s else 0.0):.3f}s "
            f"(selection "
            f"{r['selection']!r}), {len(toks)} tokens, marginal decode "
            f"{dec:.1f} tok/s; AC turn {ac_s:.3f}s; question prefills "
            f"{[(a, round(b, 4)) for a, b in qpf]} (tokens, s); finite "
            f"{finite}, ranges ordered {ordered}; launches {counts}, K8 / K9 "
            f"by m {by_m}; W4A8 prefill branch _int_mm calls {prefill_mm} "
            f"[{stamp}]")
        if not (toks and all(0 <= x < cfg.text.vocab_size for x in toks)) \
                or not finite or not ordered or not sel_s:
            raise AssertionError(f"int4 main path ({mode}) check failed")
        # the w8 rule: bf16-dot GEMVs (K6/K8) without w4a8_decode, the
        # W4A8 ones (K7/K9) for every decode-length forward with it; under
        # w8a8_prefill the prefills at m > 64 on the W4A8 prefill branch
        # and the question prefills on K9 (m > 1), decode on K6 / K8
        k6, k7, k8, k9 = counts.values()
        if (w4a8 and min(k7, k9) == 0) or \
                (not w4a8 and not w8 and (min(k6, k8) == 0 or k7 + k9 > 0
                                          or prefill_mm)) or \
                (w8 and (min(k6, k8, prefill_mm) == 0 or k7 > 0
                         or multirow["K9_int4_gemv_idx_w4a8"] == 0)):
            raise AssertionError(f"int4 main path ({mode}) launched "
                                 f"{counts}")
        if w4a8:
            metrics["w4a8_lookahead"] = quantized_lookahead_ask(
                sess, "int4 path, w4a8_decode=True,", stamp)
        del sess
    log(f"int4: launches {dict(zip(names, launches))} [{stamp}]")
    if min(launches) == 0:
        raise AssertionError("a kernel of the int4 path was never launched")
    return launches, metrics


# ---------------------------------------------------------------------------
# phase 7: training at full width
# ---------------------------------------------------------------------------

def base_checksum(model):
    """Two integer sums over the raw bits of every base tensor (values
    and squares of their 16/32-bit words): any changed bit changes them."""
    import torch

    total = [0, 0]
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            w = t.detach().reshape(-1)
            w = w.view(torch.int16 if w.element_size() == 2 else
                       torch.int32 if w.element_size() == 4 else torch.int8)
            for c in w.split(1 << 26):
                c = c.to(torch.int64)
                total[0] += int(c.sum().item())
                total[1] += int((c * c).sum().item())
    return tuple(total)


def run_training(model, dev, stamp, profile: bool = False):
    """The 7B-width training path on the phase-5 bf16 model (frozen,
    seeded random weights). (a) Stage 1: ``train_stage1``'s step (the
    constrained selector CE, remat, LoRA dropout 0.1, AdamW) on one batch
    of 8 seeded selector samples at 2048 byte tokens (no demo block);
    (b) stage 2:
    ``Stage2Trainer.train_turn`` on one packed turn of 8 frames of 24x42
    patches (8064 patch rows, 2016 merged tokens) in the 4096-token
    bucket, grad_accum 2 over 4 micro-steps. Before and after each, a
    dropout-free held-out forward on the same batch; its loss must fall.
    Checks K5's launches (27 per tower forward), finite losses, changed
    LoRA b leaves, and a bit-identical frozen base. With ``profile``, one
    more step of each stage runs under torch.profiler after the checks
    (:func:`profiled`)."""
    import torch

    from cogstream_tpu_torch import presets
    from cogstream_tpu_torch.config import LoRAConfig
    from cogstream_tpu_torch.models.lora import (init_cogreasoner_lora,
                                                 iter_leaves)
    from cogstream_tpu_torch.ops import flash_attention as fa
    from cogstream_tpu_torch.processor.tokenizer import (
        ByteTokenizer, constrained_selector_token_ids)
    from cogstream_tpu_torch.runtime.sampling import build_vocab_mask
    from cogstream_tpu_torch.train import stage2, trainer as tr
    from cogstream_tpu_torch.train.data import encode_selector_sample
    from cogstream_tpu_torch.train.multimodal import multimodal_loss_fn
    from cogstream_tpu_torch.train.stage1 import Stage1Config

    cfg = presets.cogreasoner_7b()
    tok = ByteTokenizer(image_token_id=cfg.image_token_index,
                        vocab=cfg.text.vocab_size)
    lc = LoRAConfig(include_projector=True)          # r=8, alpha 16, 0.1
    n_layers = cfg.vision.num_hidden_layers
    checksum0 = base_checksum(model)
    metrics, ok = {}, True
    for i in TRAIN_PATH:                   # count the training path only
        wrapper(i).launches = 0
        wrapper(i).tc_launches = 0
    lora = init_cogreasoner_lora(torch.Generator(device=dev).manual_seed(0),
                                 cfg, lc, device=dev)
    n_lora = sum(t.numel() for _, t in iter_leaves(lora))
    log(f"train: LoRA r={lc.rank} on {len(lora['text']['layers'])} layers x "
        f"7 projections + projector readout: {n_lora / 1e6:.2f}M params "
        f"[{stamp}]")

    def step_line(tag, i, loss, dt, tokens):
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"train {tag} step {i}: loss {loss:.5f}, {dt:.3f}s, "
            f"{tokens / dt:.0f} tok/s, peak {peak:.2f} GiB [{stamp}]")
        return peak

    # (a) stage 1: the Stage1Config batch of 8; 2048 byte tokens hold a
    # selector prompt (without the few-shot demo block) that a subword
    # tokenizer fits in Stage1Config's 1024
    s1 = Stage1Config()
    rng = np.random.default_rng(7)
    rows = []
    for smp in _selector_samples(rng, 64):
        enc = encode_selector_sample(tok, smp, 2 * s1.max_len,
                                     include_demo=False)
        if enc is not None:
            rows.append(enc)
        if len(rows) == s1.batch_size:
            break
    batch = tr.to_device({k: np.stack([r[k] for r in rows])
                          for k in rows[0]}, dev)
    B, S = batch["input_ids"].shape
    real = int((batch["input_ids"] != 0).sum().item())
    vm = build_vocab_mask(cfg.text.vocab_size,
                          constrained_selector_token_ids(tok), dev)
    text_lora = lora["text"]
    # warmup 0 and one update per step: the reference's 50-step warmup
    # and grad_accum 4 would leave 4 steps at a learning rate near 0
    tx = tr.make_optimizer(s1.learning_rate, total_steps=1000,
                           warmup_steps=0, grad_accum=1)
    step = tr.make_train_step(tx, tr.bind_text_loss(lc, vm, remat=True),
                              dropout_seed=s1.seed ^ 0x5EED)
    state = tr.init_train_state(tx, text_lora)

    def eval1():
        with torch.no_grad():
            return tr.text_loss_fn(model.text, text_lora, batch, lc.scale,
                                   vm, remat=False).item()

    before = eval1()
    b0 = [t.detach().clone() for k, t in iter_leaves(text_lora)
          if k.endswith(".b")]
    losses, peaks, times = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(model.text, state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses.append(loss.item())
        times.append(dt)
        peaks.append(step_line("stage1", i, losses[-1], dt, B * S))
    after = eval1()
    moved = all(not torch.equal(a, t) for a, (k, t) in zip(
        b0, ((k, t) for k, t in iter_leaves(text_lora) if k.endswith(".b"))))
    log(f"train stage1: batch {B}x{S} ({real} non-pad tokens); held-out "
        f"loss {before:.5f} -> {after:.5f}; b leaves changed {moved} "
        f"[{stamp}]")
    ok &= all(math.isfinite(x) for x in losses) and moved and after < before
    if profile:
        profiled("train_stage1_step", lambda: step(model.text, state, batch),
                 stamp)
    metrics.update({"stage1_step_s": times, "stage1_tok_per_s":
                    [B * S / t for t in times], "stage1_peak_gib": max(peaks),
                    "stage1_loss": losses, "stage1_heldout_loss":
                    [before, after]})

    # (b) stage 2: one packed turn, 8 frames of 24x42 patches, merge 2
    s2cfg = stage2.Stage2Config(grad_accum=2)
    turn = _stage2_turn(np.random.default_rng(8), tok, cfg, 8, 24, 42, 2,
                        s2cfg.max_seq_len)
    S2 = turn["input_ids"].shape[1]
    n_vis = int(turn["num_vis_tokens"])
    lora = init_cogreasoner_lora(torch.Generator(device=dev).manual_seed(1),
                                 cfg, lc, device=dev)
    trainer = stage2.Stage2Trainer(model, cfg, tok, s2cfg,
                                   _fresh_dir("stage2_7b"), total_steps=4,
                                   log=lambda *a: None, lora_cfg=lc,
                                   lora=lora)
    dev_turn = tr.to_device({k: v for k, v in turn.items()
                             if k != "num_vis_tokens"}, dev)

    def eval2():
        with torch.no_grad():
            return multimodal_loss_fn(model, lora, dev_turn, lc.scale,
                                      n_vis, remat=False).item()

    k5_0 = fa.segment_flash_attention.launches
    k5_tc0 = fa.segment_flash_attention.tc_launches
    before2 = eval2()
    b0 = [t.detach().clone() for k, t in iter_leaves(lora)
          if k.endswith(".b")]
    losses2, peaks2, times2 = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses2.append(trainer.train_turn(dict(turn)))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times2.append(dt)
        peaks2.append(step_line("stage2", i, losses2[-1], dt, S2))
    after2 = eval2()
    k5 = fa.segment_flash_attention.launches - k5_0
    k5_tc = fa.segment_flash_attention.tc_launches - k5_tc0
    moved2 = all(not torch.equal(a, t) for a, (k, t) in zip(
        b0, ((k, t) for k, t in iter_leaves(lora) if k.endswith(".b"))))
    log(f"train stage2: turn of {turn['pixel_values'].shape[0]} patch rows, "
        f"{n_vis} merged tokens, {S2}-token bucket; held-out loss "
        f"{before2:.5f} -> {after2:.5f}; b leaves changed {moved2} "
        f"(projector included); K5 launches {k5} over 6 tower forwards, "
        f"{k5_tc} on the tensor-core tile [{stamp}]")
    ok &= all(math.isfinite(x) for x in losses2) and moved2 \
        and after2 < before2 and k5 == k5_tc == 6 * n_layers \
        and turn["pixel_values"].shape[0] == 8064 and n_vis == 2016
    checksum1 = base_checksum(model)
    log(f"train: base checksum {checksum0} -> {checksum1}, identical "
        f"{checksum0 == checksum1} [{stamp}]")
    ok &= checksum0 == checksum1
    if profile:
        profiled("train_stage2_micro_step",
                 lambda: trainer.train_turn(dict(turn)), stamp)
    metrics.update({"stage2_step_s": times2, "stage2_tok_per_s":
                    [S2 / t for t in times2],
                    "stage2_peak_gib": max(peaks2), "stage2_loss": losses2,
                    "stage2_heldout_loss": [before2, after2]})
    launches = [wrapper(i).launches for i in TRAIN_PATH]
    if not ok or min(launches) == 0:
        raise AssertionError("training main path check failed")
    return launches, metrics


def run_qlora(model, dev, stamp, bf16: dict, profile: bool = False):
    """The 7B QLoRA path (after phase 7, before 10 and 6): for NF4 and
    then int8 with ``w8a8_prefill`` (the stage-2 ``--w8a8-forward``), a
    copy of the phase-5 model quantized whole (``quantize_cogreasoner_``
    on a :func:`shared_copy`: one scheme resident at a time beside the
    bf16 weights, which phases 10 and 6 need) trains 2 ``Stage2Trainer``
    micro-steps (grad_accum 1, remat, LoRA r=8 with dropout 0.1 on the 7
    projections and the projector) on phase 7's 8-frame turn. Per step: wall s, tokens/s, the allocator's
    peak, and that peak less the bf16 weights the copy does not share
    (the footing of phase 7's bf16 peak, where the model trained is the
    one resident); the model GiB of each. Checks: K5 launches 27 times per
    tower forward, all on its tensor-core tile; every loss finite; the
    LoRA b leaves change; the quantized base's checksum unchanged. With
    ``profile``, one more micro-step of each runs under torch.profiler
    after the checks (:func:`profiled`)."""
    import dataclasses

    import torch

    from cogstream_tpu_torch import presets
    from cogstream_tpu_torch.config import LoRAConfig
    from cogstream_tpu_torch.models.lora import (init_cogreasoner_lora,
                                                 iter_leaves)
    from cogstream_tpu_torch.ops import flash_attention as fa
    from cogstream_tpu_torch.ops.quant import (quantize_cogreasoner_,
                                               quantized_bytes)
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.train import stage2

    cfg7 = presets.cogreasoner_7b()
    tok = ByteTokenizer(image_token_id=cfg7.image_token_index,
                        vocab=cfg7.text.vocab_size)
    lc = LoRAConfig(include_projector=True)
    turn = _stage2_turn(np.random.default_rng(8), tok, cfg7, 8, 24, 42, 2,
                        stage2.Stage2Config().max_seq_len)
    S2 = turn["input_ids"].shape[1]
    n_layers = cfg7.vision.num_hidden_layers
    bf16_gib = quantized_bytes(model) / 2 ** 30
    ids = {id(t) for t in list(model.parameters()) + list(model.buffers())}
    metrics, ok = {}, True
    for scheme, bits, w8 in (("nf4", 4, False), ("int8_w8a8", 8, True)):
        cfg = dataclasses.replace(cfg7, text=dataclasses.replace(
            cfg7.text, w8a8_prefill=w8))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qmodel = quantize_cogreasoner_(shared_copy(model), bits)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        tensors = list(qmodel.parameters()) + list(qmodel.buffers())
        shared = sum(t.numel() * t.element_size() for t in tensors
                     if id(t) in ids)
        q_gib = quantized_bytes(qmodel) / 2 ** 30
        not_shared = bf16_gib - shared / 2 ** 30
        lora = init_cogreasoner_lora(
            torch.Generator(device=dev).manual_seed(1), cfg, lc, device=dev)
        trainer = stage2.Stage2Trainer(
            qmodel, cfg, tok, stage2.Stage2Config(grad_accum=1),
            _fresh_dir(f"qlora_{scheme}"), total_steps=2,
            log=lambda *a: None, lora_cfg=lc, lora=lora)
        checksum0 = base_checksum(qmodel)
        b0 = [t.detach().clone() for k, t in iter_leaves(lora)
              if k.endswith(".b")]
        k5, k5_tc = (fa.segment_flash_attention.launches,
                     fa.segment_flash_attention.tc_launches)
        losses, times, peaks = [], [], []
        torch.cuda.reset_peak_memory_stats()
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.train_turn(dict(turn)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
            log(f"qlora {scheme} step {i}: loss {losses[-1]:.5f}, "
                f"{times[-1]:.3f}s, {S2 / times[-1]:.0f} tok/s, peak "
                f"{peaks[-1]:.2f} GiB allocated, {peaks[-1] - not_shared:.2f}"
                f" GiB less the resident bf16 weights (bf16 step "
                f"{min(bf16['stage2_step_s']):.3f}s, peak "
                f"{bf16['stage2_peak_gib']:.2f} GiB) [{stamp}]")
        k5 = fa.segment_flash_attention.launches - k5
        k5_tc = fa.segment_flash_attention.tc_launches - k5_tc
        moved = all(not torch.equal(a, t) for a, (k, t) in zip(
            b0, ((k, t) for k, t in iter_leaves(lora) if k.endswith(".b"))))
        checksum1 = base_checksum(qmodel)
        log(f"qlora {scheme}: quantized copy in {quant_s:.1f}s, model "
            f"{q_gib:.2f} GiB (bf16 {bf16_gib:.2f} GiB, {shared / 2**30:.2f}"
            f" GiB of it shared); K5 launches {k5} over 2 tower forwards, "
            f"{k5_tc} on the tensor-core tile; b leaves changed {moved}; "
            f"base checksum identical {checksum0 == checksum1} [{stamp}]")
        ok &= all(math.isfinite(x) for x in losses) and moved \
            and checksum0 == checksum1 and k5 == k5_tc == 2 * n_layers
        if profile:
            profiled(f"qlora_{scheme}_micro_step",
                     lambda: trainer.train_turn(dict(turn)), stamp)
        metrics.update({f"qlora_{scheme}_step_s": times,
                        f"qlora_{scheme}_tok_per_s": [S2 / t for t in times],
                        f"qlora_{scheme}_peak_gib": max(peaks),
                        f"qlora_{scheme}_peak_less_bf16_gib":
                            max(peaks) - not_shared,
                        f"qlora_{scheme}_model_gib": q_gib,
                        f"qlora_{scheme}_quantize_s": quant_s,
                        f"qlora_{scheme}_loss": losses})
        del trainer, qmodel, lora, tensors, b0
    metrics["bf16_model_gib"] = bf16_gib
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("7B QLoRA path check failed")
    return metrics


def profile_phases(sess, stamp):
    """``--profile``: torch.profiler over one more ingest, an FCC ask and
    an AC ask on the main path's session (:func:`profiled` each)."""
    t, gh, gw = 16, 24, 42
    pv = np.random.default_rng(1).integers(0, 256, (t * gh * gw, 3 * 14 * 14),
                                           dtype=np.uint8)
    phases = [
        ("ingest", lambda: sess.append_stream_segment(
            pv, (t, gh, gw), 2, timestamps=[2.0 * t + f for f in range(t)])),
        ("ask_FCC", lambda: sess.ask("What changed?", mode="FCC",
                                     max_new_tokens=32)),
        ("ask_AC", lambda: sess.ask("And now?", mode="AC",
                                    max_new_tokens=32)),
        ("ask_AC_lookahead4", lambda: sess.ask("And then?", mode="AC",
                                               max_new_tokens=32,
                                               lookahead_k=4)),
    ]
    for name, fn in phases:
        profiled(name, fn, stamp)


def profiled(name, fn, stamp):
    """torch.profiler around one ``fn()``: its wall time, summed device
    kernel time and busy share (one stream, so kernels never overlap),
    and its ten largest kernels by device time. The profiler adds host
    time, so the wall exceeds an unprofiled one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    log(f"profile {name}: wall {wall_ms:.1f} ms, device kernel time "
        f"{dev_ms:.1f} ms, busy {dev_ms / wall_ms:.3f} [{stamp}]")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"profile {name}:   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:6d}x {e.key[:80]}")


# ---------------------------------------------------------------------------
# phase 11: tensor-parallel serving, two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

TP_DIR = os.path.join(REPO, "build", "chip_smoke_tp")
TP_WORLD = 2
# (b)'s bound on the first-step logits, of each row's max |ref|: 1e-2, or
# TP_WITNESS_FACTOR times the gap that the tensor-parallel sum order alone
# opens in one process (SplitSums) where that gap is larger
TP_LOGIT_TOL = 1e-2
TP_WITNESS_FACTOR = 1.5
MAIN_ASKS = [("What is happening in the video?", "AC"),
             ("What changed since then?", "FCC")]
# (b)'s asks: greedy tokens each (the gate reads the first step's logits)
TP_ASK_TOKENS = 8
# (e): the ask after a snapshot, asked of the original sharded session, of
# a sharded session restored from the file and of the solo one restored
E_QUESTION = "What is on the screen now?"
E_TOKENS = 8
# (e5)'s adapters: LoRA r = 8 on the 7 projections x 28 layers (and the
# projector's readout in the full adapter), every ``b`` drawn from
# N(0, TP_ADAPTER_B_STD^2): large enough that the adapters move the solo
# first-step logits by TP_ADAPTER_EFFECT times the gate or more (else the
# check could not fail a wrong slice)
TP_ADAPTER_B_STD = 3e-2
TP_ADAPTER_EFFECT = 10.0


class FirstLogits:
    """Records the whole-vocab logits of each decode loop's first step (the
    first ``lm_logits`` call without a sliced head after each ``arm``: its
    last row as ``first``, every row, one per batch row, as
    ``first_rows``) and
    the collectives issued between the full-vocab calls of one decode
    loop (instrumentation of this script only)."""

    def __init__(self):
        from cogstream_tpu_torch.models import qwen2
        from cogstream_tpu_torch.parallel.mesh import COLLECTIVES

        self.qwen2, self.counts = qwen2, COLLECTIVES
        self.head = qwen2.lm_logits
        self.first = None
        self.steps = []           # collectives per decode step
        self._last = None

        def tapped(*a, **k):
            out = self.head(*a, **k)
            if k.get("head") is None:
                now = sum(self.counts.values())
                if self.first is None:
                    rows = out.reshape(-1, out.shape[-1]).float().cpu()
                    self.first, self.first_rows = rows[-1].numpy(), \
                        rows.numpy()
                elif self._last is not None:
                    self.steps.append(now - self._last)
                self._last = now
            return out

        qwen2.lm_logits = tapped

    def arm(self):
        self.first, self._last = None, None

    def restore(self):
        self.qwen2.lm_logits = self.head


class SplitSums:
    """Two ranks' row-parallel arithmetic in one process (phase 11 (b)'s
    witness). While installed, each row-parallel site of the whole model
    (the decoder's o_proj and down_proj, the tower's o and fc2, the
    projector's second linear) computes as two halves of its input
    channels, each product's sums kept in f32, then added, biased and
    rounded once: what ``row_parallel_linear`` and
    ``materialized_linear(reduce=)`` compute on two ranks, the all-reduce
    of two f32 partials being one addition. Every other op runs as it
    does. ``decoder=False`` leaves the decoder's sites whole (a quantized
    decoder: phase 11 (c)'s W4A8 witness)."""

    def __init__(self, model, decoder: bool = True):
        from cogstream_tpu_torch.models import projector, qwen2, vision_encoder
        from cogstream_tpu_torch.ops.quant import _add_bias, _mm_wide

        text = model.text.layers if decoder else []
        sites = ([layer.attn["o_proj"] for layer in text]
                 + [layer.mlp["down_proj"] for layer in text]
                 + [layer.o for layer in model.vision.layers]
                 + [layer.fc2 for layer in model.vision.layers]
                 + [model.projector.layers[1]])
        ids = {id(m) for m in sites}
        self.calls = 0
        self.mods = (qwen2, vision_encoder, projector)
        dense, linear = qwen2.dense, vision_encoder.materialized_linear
        self.saved = (dense, linear)

        def split(lin, x):
            self.calls += 1
            h, w = x.shape[-1] // 2, lin.weight
            y = (_mm_wide(x[..., :h].contiguous(), w[:, :h].contiguous())
                 + _mm_wide(x[..., h:].contiguous(), w[:, h:].contiguous()))
            return _add_bias(y, lin).to(x.dtype)

        def dense_split(x, lin, *a, **k):
            return split(lin, x) if id(lin) in ids else dense(x, lin, *a, **k)

        def linear_split(lin, x, reduce=None):
            return split(lin, x) if id(lin) in ids else linear(lin, x, reduce)

        qwen2.dense = dense_split
        vision_encoder.materialized_linear = linear_split
        projector.materialized_linear = linear_split

    def restore(self):
        qwen2, vision_encoder, projector = self.mods
        qwen2.dense = self.saved[0]
        vision_encoder.materialized_linear = self.saved[1]
        projector.materialized_linear = self.saved[1]


def tp_adapters(cfg, dev):
    """(e5)'s two adapters, whole and detached, the same in every process:
    the language adapter (decoder) and the full one (decoder and the
    projector's readout), LoRA r = 8 from seeds 31 / 32, every ``b`` then
    drawn from N(0, TP_ADAPTER_B_STD^2) from seed 33 on the card."""
    import torch

    from cogstream_tpu_torch.config import LoRAConfig
    from cogstream_tpu_torch.models.lora import (init_cogreasoner_lora,
                                                 init_qwen2_lora, iter_leaves,
                                                 map_leaves)

    lc = LoRAConfig(rank=8, dropout=0.0, include_projector=True)
    trees = {
        "language_module": init_qwen2_lora(
            torch.Generator(device=dev).manual_seed(31), cfg.text, lc,
            device=dev),
        "full_module": init_cogreasoner_lora(
            torch.Generator(device=dev).manual_seed(32), cfg, lc,
            device=dev)}
    gen = torch.Generator(device=dev).manual_seed(33)
    out = {}
    for name, tree in trees.items():
        tree = map_leaves(lambda t: t.detach().clone(), tree)
        for path, t in iter_leaves(tree):
            if path.rsplit(".", 1)[-1] == "b":
                t.copy_(torch.randn(t.shape, generator=gen, device=dev)
                        * TP_ADAPTER_B_STD)
        out[name] = tree
    return out


def tp_adapter_turn(model, cfg, tok, adapters, first_tap, **kw):
    """(e5)'s turn: a session with ``adapters`` restores (e1)'s snapshot
    and asks ``E_QUESTION`` (4 tokens: the question's prefill and the
    decode run through every adapted projection); (tokens, first-step
    logits)."""
    from cogstream_tpu_torch.runtime.session import StreamingSession

    sess = StreamingSession(model, cfg, tok, max_len=16384,
                            adapters=adapters, **kw)
    sess.load_state(os.path.join(TP_DIR, "e_snapshot.npz"))
    first_tap.arm()
    r = sess.ask(E_QUESTION, mode="AC", max_new_tokens=4)
    return r["tokens"], first_tap.first


def snapshot_matches_cache(sess, path) -> bool:
    """Whether ``sess``'s live K/V equal the snapshot file's K/V at the
    session's kv heads (every kv head for a solo session), byte for
    byte."""
    with np.load(path) as z:
        wi = json.loads(str(z["meta"]))["wi"]
        tp = sess.model.text.tp
        heads = (list(tp.kv_heads) if tp is not None
                 else list(range(z["k"].shape[2])))
        for name in ("k", "v"):
            local = getattr(sess.cache, name)[:, 0, :wi].contiguous()
            if not np.array_equal(z[name][:, :, heads],
                                  kv_host_bytes(local)):
                return False
    return True


def kv_host_bytes(t):
    """A cache tensor's bytes on the host (a ``uint8`` view)."""
    import torch

    return t.contiguous().view(torch.uint8).cpu().numpy()


def tp_solo_turns(model, cfg, tok):
    """Phase 5's two ingests and asks in a fresh solo session on
    ``model``, untimed: per mode the first-step logits (host f32), the
    answer tokens and the selection."""
    from cogstream_tpu_torch.runtime.session import StreamingSession

    t, gh, gw, ms = MAIN_SEGMENTS
    tap = FirstLogits()
    out = {}
    try:
        sess = StreamingSession(model, cfg, tok, max_len=16384)
        for seg_i, (pv, (question, mode)) in enumerate(zip(main_segments(),
                                                           MAIN_ASKS)):
            sess.append_stream_segment(pv, (t, gh, gw), ms,
                                       timestamps=[float(seg_i * t + f)
                                                   for f in range(t)])
            tap.arm()
            r = sess.ask(question, mode=mode, max_new_tokens=TP_ASK_TOKENS)
            out[mode] = {"logits": tap.first, "tokens": r["tokens"],
                         "selection": r["selection"]}
    finally:
        tap.restore()
    return out


def tp_slice_err(got, ref, lo_hi):
    """One rank's vocab slice ``got`` of the first-step logits against the
    whole row ``ref``: (max |got - ref| over the row's max |ref|, the same
    in bf16 ulps of that max; the ulp of a value in [2^e, 2^(e+1)) is
    2^(e-7))."""
    top = max(float(np.abs(ref).max()), 1e-30)
    d = float(np.abs(np.asarray(got, np.float64)
                     - ref[slice(*lo_hi)]).max())
    return d / top, d / 2.0 ** (math.floor(math.log2(top)) - 7)


def tp_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def cut_config():
    """Phase 8 (b)'s checkpoint config: 7B width, 2 decoder and 2 tower
    layers."""
    import dataclasses

    from cogstream_tpu_torch import presets

    cfg7 = presets.cogreasoner_7b()
    return dataclasses.replace(
        cfg7, text=dataclasses.replace(cfg7.text, num_hidden_layers=2),
        vision=dataclasses.replace(cfg7.vision, num_hidden_layers=2))


def tp_whole_gib(cfg):
    """(model, decoder) GiB of the whole ``cfg`` model (sized on meta)."""
    from cogstream_tpu_torch.models.cogreasoner import CogReasoner
    from cogstream_tpu_torch.models.projector import Projector
    from cogstream_tpu_torch.models.qwen2 import Qwen2Model
    from cogstream_tpu_torch.models.vision_encoder import VisionTower

    m = CogReasoner(Qwen2Model(cfg.text, device="meta"),
                    VisionTower(cfg.vision, device="meta"),
                    Projector(cfg.vision.hidden_size, cfg.text.hidden_size,
                              cfg.mm_projector_type, "meta",
                              cfg.text.torch_dtype))
    return _gib(m), _gib(m.text)


def write_cut_checkpoint(dev, out_dir):
    """Phase 8 (b)'s 2+2-layer 7B-width checkpoint (seed 3), written to
    ``out_dir``; returns its config."""
    import torch

    from cogstream_tpu_torch.models.checkpoint import save_cogreasoner_to_hf
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params

    cfg = cut_config()
    src = init_cogreasoner_params(
        cfg, torch.Generator(device=dev).manual_seed(3), device=dev)
    save_cogreasoner_to_hf(src, cfg, out_dir)
    del src
    torch.cuda.empty_cache()
    return cfg


# phase 11 (c)'s quantized sessions: per scheme (bits), the sessions run on
# one quantized copy of the decoder (key, serving flags)
TP_QUANT = ((8, (("int8", {"w8a8_prefill": True}),)),
            (4, (("int4", {}),
                 ("w4a8", {"w4a8_decode": True, "w8a8_prefill": True}))))


def tp_quant_session(model, cfg, tok, first_tap, **kw):
    """Phase 11 (c)'s quantized turn: the first 8 frames of phase 5's
    first segment, ask(AC) for 4 tokens; (tokens, first-step logits)."""
    from cogstream_tpu_torch.runtime.session import StreamingSession

    t, gh, gw, ms = MAIN_SEGMENTS
    t = min(t, 8)
    sess = StreamingSession(model, cfg, tok, max_len=16384, **kw)
    sess.append_stream_segment(main_segments()[0][: t * gh * gw],
                               (t, gh, gw), ms,
                               timestamps=[float(f) for f in range(t)])
    first_tap.arm()
    r = sess.ask("What is happening in the video?", mode="AC",
                 max_new_tokens=4)
    return r["tokens"], first_tap.first


def tp_w4a8_prefill(model, cfg):
    """Phase 11 (c)'s exact W4A8 check: a 128-token seeded text prompt
    through ``model``'s decoder under ``cfg``'s flags, cache-free (m =
    128 > 64: the W4A8 prefill branch on every site, exact int32 sums),
    then the head (K7) on its last row; (that row's hidden state, its
    logits), host f32. On two row shards with their global halves' scales
    the prefill is the solo one's arithmetic, bit for bit."""
    import torch

    from cogstream_tpu_torch.models import qwen2
    from cogstream_tpu_torch.models.cogreasoner import with_serving_flags

    text = with_serving_flags(model, cfg).text
    ids = torch.as_tensor(np.random.default_rng(19).integers(
        3, 256, (1, 128)), device=text.device)
    pos = torch.arange(128, dtype=torch.int32, device=text.device)[None]
    h, _ = qwen2.qwen2_forward(text, qwen2.embed(text, ids), pos)
    lg = qwen2.lm_logits(text, h[:, -1:], w8a8=cfg.text.w4a8_decode)
    return (h[0, -1].float().cpu().numpy(), lg[0, 0].float().cpu().numpy())


def run_tp_path(model, dev, stamp, fault=False, w4a8_fault=False):
    """Phase 11: tensor-parallel serving at tp = 2, both ranks on this card
    (subprocesses of this script, ``--tp-rank``), their process group on
    gloo: NCCL refuses two ranks on one device, and the smoke has one card.
    The parent writes (d)'s checkpoint, starts the ranks, and while they
    run writes the references: phase 5's asks replayed solo (untimed) and
    again under :class:`SplitSums` (the witness: the solo model with two
    ranks' row-parallel sum order), the solo card sessions of (c) on
    ``shared_copy``s of the phase-5 decoder quantized to int8 / int4. The
    ranks' results are held here: (a) the
    tiny f32 tokens equal to the solo card session's (which rank 0 runs),
    K1-K4 launched on each rank; (b) each rank's first-step logits (its
    vocab slice) within ``TP_LOGIT_TOL`` of the row max of the solo
    replay's, or ``TP_WITNESS_FACTOR`` times the witness's gap to the solo
    replay where that is larger (28 layers of bf16 roundings carry a
    changed sum order that far; the error against the witness and the
    1e-2 verdict are printed beside), each rank's AC and FCC selections
    equal to the solo replay's, K1-K4 on each rank, per rank shard GiB
    beside the whole model's, collectives per decode step, walls (two
    ranks sharing one card over gloo: not a TP speed); (c) the first
    token equal to the solo card session's, K10 / K6 + K8 launched on each
    rank; (d) every tensor of the sharded load equal to that rank's slice
    of the whole load."""
    import dataclasses
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from cogstream_tpu_torch import presets
    from cogstream_tpu_torch.models.cogreasoner import CogReasoner
    from cogstream_tpu_torch.ops.quant import quantize_text_
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer

    shutil.rmtree(TP_DIR, ignore_errors=True)
    os.makedirs(TP_DIR)
    try:
        cfg = presets.cogreasoner_7b()
        tok = ByteTokenizer(image_token_id=cfg.image_token_index,
                            vocab=cfg.text.vocab_size)
        t0 = time.perf_counter()
        write_cut_checkpoint(dev, os.path.join(TP_DIR, "hf"))
        ckpt_s = time.perf_counter() - t0

        def ranks():
            t0 = time.perf_counter()
            rcs = run_ranks("--tp-rank", TP_DIR, TP_WORLD,
                            extra=(["--tp-snapshot-fault"] if fault else [])
                            + (["--tp-w4a8-fault"] if w4a8_fault else []))
            return rcs, time.perf_counter() - t0

        # the ranks run while this process writes the references (they
        # are read only once the ranks are done)
        with ThreadPoolExecutor(1) as ex:
            world = ex.submit(ranks)
            # (b)'s references: phase 5's asks replayed solo, and again
            # with the row-parallel sums split as two ranks split them
            solo = tp_solo_turns(model, cfg, tok)
            witness = SplitSums(model)
            try:
                emu = tp_solo_turns(model, cfg, tok)
            finally:
                witness.restore()
            emu_calls = witness.calls
            gc.collect()
            torch.cuda.empty_cache()
            refs = {}
            tap = FirstLogits()
            try:
                for bits, sessions in TP_QUANT:
                    text = quantize_text_(shared_copy(model.text), bits)
                    qmodel = CogReasoner(text, model.vision, model.projector)
                    for key, flags in sessions:
                        qcfg = dataclasses.replace(
                            cfg, text=dataclasses.replace(cfg.text, **flags))
                        refs[key] = tp_quant_session(qmodel, qcfg, tok, tap)
                    if bits == 4:
                        # (c)'s W4A8 witness: the tower's and the
                        # projector's row-parallel sums split as two ranks
                        # split them (the decoder's int4 sites whole)
                        witness = SplitSums(qmodel, decoder=False)
                        try:
                            refs["w4a8_witness"] = tp_quant_session(
                                qmodel, qcfg, tok, tap)
                        finally:
                            witness.restore()
                        refs["w4a8_prefill"] = tp_w4a8_prefill(qmodel, qcfg)
                    del text, qmodel
                    gc.collect()
                    torch.cuda.empty_cache()
            finally:
                tap.restore()
            log(f"tp: references: solo int8 / int4 / W4A8 card sessions, "
                f"tokens {refs['int8'][0]} / {refs['int4'][0]} / "
                f"{refs['w4a8'][0]}; checkpoint written in {ckpt_s:.1f}s "
                f"[{stamp}]")
            rcs, wall = world.result()
        for r in range(TP_WORLD):
            with open(os.path.join(TP_DIR, f"rank{r}.log")) as f:
                for line in f.read().splitlines():
                    log(f"tp: rank {r}: {line}")
        if rcs != [0] * TP_WORLD:
            raise AssertionError(f"tensor-parallel ranks exited {rcs}")
        res = []
        for r in range(TP_WORLD):
            with open(os.path.join(TP_DIR, f"rank{r}.json")) as f:
                res.append(json.load(f))
        refs["restored"] = tp_solo_restore(model, cfg, tok, dev)
        ok, gate, metrics = tp_verdict(res, refs, solo, emu, emu_calls, wall,
                                       stamp)
        f_ok, f_metrics = tp_dp_verdict(*run_tp_dp_path(dev, stamp), gate,
                                        stamp)
        if not (ok and f_ok):
            raise AssertionError("tensor-parallel phase failed")
        return {**metrics, **f_metrics}
    finally:
        shutil.rmtree(TP_DIR, ignore_errors=True)


def tp_solo_restore(model, cfg, tok, dev):
    """(e3): a solo session on the whole model restores the ranks'
    snapshot: its cache against the file's bytes, then ``E_QUESTION``
    (first-step logits, tokens, restore s); and (e5)'s reference, the
    same with both adapters."""
    import torch

    from cogstream_tpu_torch.runtime.session import StreamingSession

    path = os.path.join(TP_DIR, "e_snapshot.npz")
    sess = StreamingSession(model, cfg, tok, max_len=16384)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.load_state(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    equal = snapshot_matches_cache(sess, path)
    tap = FirstLogits()
    try:
        tap.arm()
        r = sess.ask(E_QUESTION, mode="AC", max_new_tokens=E_TOKENS)
        out = {"cache_equal": equal, "logits": tap.first,
               "tokens": r["tokens"], "load_s": load_s}
        del sess
        # (e5)'s reference: the same restore and ask with both adapters
        out["adapters"] = tp_adapter_turn(model, cfg, tok,
                                          tp_adapters(cfg, dev), tap)
    finally:
        tap.restore()
    return out


def tp_verdict(res, refs, solo, emu, emu_calls, wall, stamp):
    """Phase 11 (a)-(e)'s checks on the ranks' results (see run_tp_path):
    (ok, (b)'s AC gate, metrics)."""
    ok = True
    a = [r["a"] for r in res]
    solo_a = a[0]["solo"]
    a_ok = all(x["tokens"] == solo_a for x in a) and all(
        min(x["launches"].values()) > 0 for x in a)
    ok &= a_ok
    log(f"tp: (a) tiny f32 session at tp = 2 (AC, FCC, lookahead_k=4): "
        f"tokens equal to the solo card session on every rank {a_ok}; "
        f"launches per rank {[x['launches'] for x in a]} [{stamp}]")

    b = [r["b"] for r in res]
    whole = (0, len(solo["AC"]["logits"]))
    gap, gap_ulps, bound, errs, ulps, to_emu, agree = ({} for _ in range(7))
    for _, mode in MAIN_ASKS:
        ref = solo[mode]["logits"]
        gap[mode], gap_ulps[mode] = tp_slice_err(emu[mode]["logits"], ref,
                                                 whole)
        bound[mode] = max(TP_LOGIT_TOL, TP_WITNESS_FACTOR * gap[mode])
        got = [np.load(os.path.join(TP_DIR, f"rank{i}_{mode}.npy"))
               for i in range(TP_WORLD)]
        pairs = [tp_slice_err(g, ref, x["vocab"]) for g, x in zip(got, b)]
        errs[mode] = [e for e, _ in pairs]
        ulps[mode] = [u for _, u in pairs]
        to_emu[mode] = [tp_slice_err(g, emu[mode]["logits"], x["vocab"])[0]
                        for g, x in zip(got, b)]
        agree[mode] = {
            "tp": tp_prefix(b[0]["tokens"][mode], solo[mode]["tokens"]),
            "witness": tp_prefix(emu[mode]["tokens"], solo[mode]["tokens"]),
            "replay_vs_phase5": tp_prefix(solo[mode]["tokens"],
                                          MAIN_ANSWERS.get(mode, []))}
    sel = {mode: [x["selections"][mode] for x in b] for _, mode in MAIN_ASKS}
    sel_ok = all(s == [solo[m]["selection"]] * TP_WORLD
                 for m, s in sel.items())
    logits_ok = all(max(errs[m]) <= bound[m] for m in errs)
    b_ok = (logits_ok and sel_ok and emu_calls > 0
            and all(min(x["launches"].values()) > 0 for x in b)
            and all(x["tokens"] == b[0]["tokens"] for x in b))
    ok &= b_ok
    log(f"tp: (b) 7B width, full depth, tp = 2, against phase 5's asks "
        f"replayed solo: witness (the same solo model with its "
        f"row-parallel sums split in two halves in f32, {emu_calls} split "
        f"GEMMs) vs solo {gap} of the row max ({gap_ulps} bf16 ulps); "
        f"each rank's first-step logit slice vs solo {errs} of the row "
        f"max ({ulps} ulps), within max({TP_LOGIT_TOL:g}, "
        f"{TP_WITNESS_FACTOR:g} x witness) = {bound} {logits_ok}, within "
        f"{TP_LOGIT_TOL:g} {max(max(e) for e in errs.values()) <= TP_LOGIT_TOL}"
        f"; vs the witness {to_emu}; selections per rank {sel} equal to "
        f"the solo replay's "
        f"{ {m: solo[m]['selection'] for m in sel} } {sel_ok} (witness "
        f"{ {m: emu[m]['selection'] for m in sel} }); greedy-prefix "
        f"agreement of {TP_ASK_TOKENS} with the solo replay {agree}; "
        f"launches per rank "
        f"{[x['launches'] for x in b]}; shard GiB per "
        f"rank {[round(x['gib'], 3) for x in b]} (decoder "
        f"{[round(x['decoder_gib'], 3) for x in b]}) beside the whole "
        f"model's {b[0]['whole_gib']:.3f} (decoder "
        f"{b[0]['whole_decoder_gib']:.3f}); collectives per decode step "
        f"per rank {[x['collectives_per_step'] for x in b]}; walls (two "
        f"ranks sharing one card over gloo, not a TP speed): init "
        f"{[round(x['init_s'], 1) for x in b]} s, ingests "
        f"{[x['ingest_s'] for x in b]} s, turns {[x['turn_s'] for x in b]}"
        f" s; peak {[round(x['peak_gib'], 1) for x in b]} GiB; (b) "
        f"{b_ok} [{stamp}]")

    c = [r["c"] for r in res]
    c_ok = True
    k6k8 = ("K6_int4_gemv", "K8_int4_gemv_idx")
    k7k9 = ("K7_int4_gemv_w4a8", "K9_int4_gemv_idx_w4a8")
    for key, what, kern, absent in (
            ("int8", "int8 decoder with w8a8_prefill", ("K10_int8_gemv",),
             ()),
            ("int4", "int4 decoder (weight-only)", k6k8, k7k9),
            ("w4a8", "int4 decoder with w4a8_decode and w8a8_prefill",
             k7k9, k6k8)):
        first = [x[key]["tokens"][0] for x in c]
        launched = [{k: x[key]["launches"][k] for k in kern + absent}
                    for x in c]
        c_errs = [tp_slice_err(np.load(os.path.join(TP_DIR,
                                                    f"rank{i}_{key}.npy")),
                               refs[key][1], x["vocab"])[0]
                  for i, x in enumerate(c)]
        gated, gate = True, ""
        if key == "w4a8":
            # int8 activations turn a sum-order difference into ~2e-2 of
            # the logits on this build (the int8 shards' gap above): the
            # gate is (b)'s rule over the W4A8 witness's gap; the exact
            # prefill below is what tells the row shards' scales apart
            w_gap = tp_slice_err(refs["w4a8_witness"][1], refs[key][1],
                                 (0, len(refs[key][1])))[0]
            w_bound = max(TP_LOGIT_TOL, TP_WITNESS_FACTOR * w_gap)
            hid, lg = refs["w4a8_prefill"]
            exact = [bool(np.array_equal(np.load(os.path.join(
                TP_DIR, f"rank{i}_w4a8_h.npy")), hid) and np.array_equal(
                np.load(os.path.join(TP_DIR, f"rank{i}_w4a8_l.npy")),
                lg[slice(*x["vocab"])])) for i, x in enumerate(c)]
            off = [tp_slice_err(np.load(os.path.join(
                TP_DIR, f"rank{i}_w4a8_l.npy")), lg, x["vocab"])[0]
                for i, x in enumerate(c)]
            gated = max(c_errs) <= w_bound and all(exact)
            gate = (f", within max({TP_LOGIT_TOL:g}, {TP_WITNESS_FACTOR:g} "
                    f"x the W4A8 witness's {w_gap:.4g}) = {w_bound:.4g} "
                    f"{max(c_errs) <= w_bound} ((b)'s AC gate "
                    f"{bound['AC']:.4g}); a 128-token text prefill's last "
                    f"hidden row and logit slice bit-equal to the solo "
                    f"W4A8 model's {exact} (logits off by {off} of the row "
                    f"max)")
            c_metrics = {"tp_w4a8_logit_err": c_errs,
                         "tp_w4a8_witness_gap": w_gap,
                         "tp_w4a8_prefill_exact": exact}
        good = (first == [refs[key][0][0]] * TP_WORLD and gated
                and all(min(n[k] for k in kern) > 0 for n in launched)
                and all(n[k] == 0 for n in launched for k in absent))
        c_ok &= good
        log(f"tp: (c) {what} at tp = 2: tokens "
            f"{[x[key]['tokens'] for x in c]} vs solo card {refs[key][0]}; "
            f"first-step logit error of the row max {c_errs}{gate}; launches "
            f"per rank {launched} (of {list(kern)} each > 0, of "
            f"{list(absent)} none); (c) {key} {good} [{stamp}]")
    ok &= c_ok

    d = [r["d"] for r in res]
    d_ok = all(all(v["equal"] for v in x.values()) for x in d)
    ok &= d_ok
    log(f"tp: (d) load_cogreasoner_from_hf(mesh=) of the 2+2-layer "
        f"checkpoint: every tensor equal to the rank's slice of the whole "
        f"load (bf16, int8, int4 at load) {d_ok}; per rank "
        f"{[{k: (v['equal'], round(v['gib'], 3)) for k, v in x.items()} for x in d]}"
        f" (GiB) [{stamp}]")
    e_ok, e_out = tp_snapshot_verdict(res, refs, solo, bound["AC"], stamp)
    ok &= e_ok
    log(f"tp: phase 11 (a)-(e) in {wall:.1f}s; collectives on gloo with "
        f"CUDA tensors: {sorted(res[0]['collective_kinds'])} [{stamp}]")
    return ok, bound["AC"], {
        **e_out, **c_metrics, "tp_logit_err": errs, "tp_logit_ulps": ulps,
        "tp_witness_gap": gap, "tp_logit_err_vs_witness": to_emu,
        "tp_prefix_agree": agree,
        "tp_gib": [x["gib"] for x in b], "tp_whole_gib": b[0]["whole_gib"],
        "tp_collectives_per_step": b[0]["collectives_per_step"],
        "tp_ingest_s": [x["ingest_s"] for x in b],
        "tp_turn_s": [x["turn_s"] for x in b], "tp_wall_s": wall}


def tp_snapshot_verdict(res, refs, solo, gate, stamp):
    """Phase 11 (e)'s checks (see :func:`tp_rank_snapshots`): (e1) every
    rank's K/V equal to the file's slice at its kv heads; (e2) the
    restored sharded session's tokens equal to the original's; (e3) the
    solo restore's cache equal to the file's bytes and each rank's
    first-step logit slice within ``gate`` (phase 11 (b)'s AC gate) of
    the solo restore's; (e4) the e4m3 snapshot's bytes equal to the
    ranks'; (e5) each rank's first-step logit slice with both adapters
    within ``gate`` of the solo session's with the same adapters, the
    adapters moving the solo logits by ``TP_ADAPTER_EFFECT`` x the gate
    or more, and each rank's slice with the other rank's slice of the
    adapters beyond the gate (the control: the gate tells a wrong slice
    of the right shape). Returns (ok, metrics)."""
    e = [r["e"] for r in res]
    vocab = [r["b"]["vocab"] for r in res]
    e1 = all(x["slices_equal"] for x in e)
    e2 = all(x["restored_tokens"] == x["tokens"] == e[0]["tokens"]
             for x in e)
    rest = refs["restored"]
    e3_errs = [tp_slice_err(np.load(os.path.join(TP_DIR, f"rank{i}_e.npy")),
                            rest["logits"], v)[0]
               for i, v in enumerate(vocab)]
    e3 = rest["cache_equal"] and max(e3_errs) <= gate
    e4 = all(x["e4m3_slices_equal"] for x in e)
    whole = (0, len(rest["logits"]))
    toks5, ref5 = rest["adapters"]
    effect = tp_slice_err(rest["logits"], ref5, whole)[0]
    errors = [x.get("adapter_error") for x in e]
    e5_errs = ([] if any(errors) else
               [tp_slice_err(np.load(os.path.join(TP_DIR, f"rank{i}_e5.npy")),
                             ref5, v)[0] for i, v in enumerate(vocab)])
    swapped = [tp_slice_err(np.load(os.path.join(TP_DIR,
                                                 f"rank{i}_e5x.npy")),
                            ref5, v)[0] for i, v in enumerate(vocab)]
    e5 = (not any(errors) and max(e5_errs) <= gate
          and effect >= TP_ADAPTER_EFFECT * gate and min(swapped) > gate)
    gb = e[0]["file_bytes"] / 1e9
    log(f"tp: (e1) snapshot of the sharded session (rank 0 gathers every "
        f"kv head and writes): {gb:.4f} GB, gather + write "
        f"{[x['save_s'] for x in e]} s per rank; each rank's K/V equal to "
        f"the file's slice at its kv heads, bit for bit {e1} "
        f"{[x['slices_equal'] for x in e]} [{stamp}]")
    log(f"tp: (e2) a fresh sharded session restored from it (rank 0 reads "
        f"and sends): read + send {[x['load_s'] for x in e]} s per rank; "
        f"its {E_TOKENS} AC tokens {e[0]['restored_tokens']} equal to the "
        f"original session's after the save {e[0]['tokens']} on every rank "
        f"{e2} [{stamp}]")
    log(f"tp: (e3) the solo session restored from it in "
        f"{rest['load_s']:.3f} s: cache equal to the file's bytes "
        f"{rest['cache_equal']}; each rank's first-step logit slice vs the "
        f"solo restore's {e3_errs} of the row max, within (b)'s AC gate "
        f"{gate:.4g} {max(e3_errs) <= gate}; solo tokens {rest['tokens']} "
        f"(greedy-prefix agreement "
        f"{tp_prefix(e[0]['tokens'], rest['tokens'])} of {E_TOKENS}) "
        f"[{stamp}]")
    log(f"tp: (e4) an e4m3 sharded session restored from it: its snapshot "
        f"{e[0]['e4m3_file_bytes'] / 1e9:.4f} GB, K/V bytes equal to each "
        f"rank's {e4} {[x['e4m3_slices_equal'] for x in e]}; AC tokens "
        f"{e[0]['e4m3_tokens']} [{stamp}]")
    log(f"tp: (e5) both adapters (r = 8, b ~ N(0, {TP_ADAPTER_B_STD:g}^2)) "
        f"sliced on each rank: first-step logit slices vs the solo session "
        f"with the same adapters {e5_errs} of the row max, within the gate "
        f"{gate:.4g}; the adapters move the solo logits by {effect:.4g} of "
        f"the row max, {effect / gate:.1f} x the gate (at least "
        f"{TP_ADAPTER_EFFECT:g} x); with the other rank's slice "
        f"(the control) {swapped}, beyond the gate "
        f"{min(swapped) > gate}; tokens per rank "
        f"{[x.get('adapter_tokens') for x in e]} vs solo {toks5}; errors "
        f"{errors}; (e5) {e5} [{stamp}]")
    ok = e1 and e2 and e3 and e4 and e5
    log(f"tp: (e) (e1) {e1} (e2) {e2} (e3) {e3} (e4) {e4} (e5) {e5} "
        f"[{stamp}]")
    return ok, {"tp_snapshot_gb": gb,
                "tp_snapshot_save_s": [x["save_s"] for x in e],
                "tp_snapshot_load_s": [x["load_s"] for x in e],
                "tp_restore_logit_err": e3_errs,
                "tp_adapter_logit_err": e5_errs,
                "tp_adapter_swapped_err": swapped,
                "tp_adapter_effect": effect}


def _gib(module) -> float:
    seen = {}
    for t in list(module.parameters()) + list(module.buffers()):
        seen[id(t)] = t.numel() * t.element_size()
    return sum(seen.values()) / 2**30


def tp_rank_snapshots(sess, model, cfg, tok, mesh, rank, dev, fault):
    """Phase 11 (e) on one rank, after (b)'s asks on ``sess``: (e1) the
    sharded session's snapshot (rank 0 gathers and writes; gather + write
    s) and this rank's K/V against the file's slice at its kv heads; (e2)
    the ask after the snapshot (``E_QUESTION``, its first-step logit slice
    saved for the parent's solo restore), then a fresh sharded session
    restored from the file (read + send s) asked the same; (e4) an e4m3
    sharded session restored from that file, its own snapshot's bytes
    against this rank's, and an AC ask; (e5) a session with both adapters
    (:func:`tp_adapters`, sliced by the session) restored from the file
    and asked ``E_QUESTION``, its first-step logit slice saved.
    Then (e5)'s control: the same turn with the other model rank's slice
    of the adapters, its first-step logit slice saved.
    ``fault`` plants the two faults the phase must catch: rank 0's kv
    heads written in every rank's place, and the adapters left whole on
    the ranks."""
    import copy

    import torch

    from cogstream_tpu_torch.parallel import sharding
    from cogstream_tpu_torch.runtime import session as session_mod
    from cogstream_tpu_torch.runtime.session import StreamingSession

    if fault:
        gather = sharding.gather_to_first

        def rank0_everywhere(x, group):
            parts = gather(x, group)
            return None if parts is None else [parts[0]] * len(parts)

        sharding.gather_to_first = rank0_everywhere
        session_mod.shard_adapters = lambda adapters, cfg, mesh: adapters
    out = {}
    path = os.path.join(TP_DIR, "e_snapshot.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.save(path)
    torch.cuda.synchronize()
    out["save_s"] = round(time.perf_counter() - t0, 3)
    torch.distributed.barrier()        # the file is written (rank 0)
    out["file_bytes"] = os.path.getsize(path)
    out["slices_equal"] = snapshot_matches_cache(sess, path)
    tap = FirstLogits()
    try:
        tap.arm()
        out["tokens"] = sess.ask(E_QUESTION, mode="AC",
                                 max_new_tokens=E_TOKENS)["tokens"]
        np.save(os.path.join(TP_DIR, f"rank{rank}_e.npy"), tap.first)
        fresh = StreamingSession(model, cfg, tok, max_len=16384, mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.load_state(path)
        torch.cuda.synchronize()
        out["load_s"] = round(time.perf_counter() - t0, 3)
        out["restored_tokens"] = fresh.ask(
            E_QUESTION, mode="AC", max_new_tokens=E_TOKENS)["tokens"]
        del fresh
        f8 = StreamingSession(model, cfg, tok, max_len=16384, mesh=mesh,
                              kv_dtype=torch.float8_e4m3fn)
        f8.load_state(path)
        p8 = os.path.join(TP_DIR, "e_snapshot_e4m3.npz")
        f8.save(p8)
        torch.distributed.barrier()
        out["e4m3_file_bytes"] = os.path.getsize(p8)
        out["e4m3_slices_equal"] = snapshot_matches_cache(f8, p8)
        out["e4m3_tokens"] = f8.ask(E_QUESTION, mode="AC",
                                    max_new_tokens=4)["tokens"]
        del f8
        try:
            toks, first = tp_adapter_turn(model, cfg, tok,
                                          tp_adapters(cfg, dev), tap,
                                          mesh=mesh)
            out["adapter_tokens"] = toks
            np.save(os.path.join(TP_DIR, f"rank{rank}_e5.npy"), first)
        except Exception as e:  # noqa: BLE001 — the parent fails (e5)
            out["adapter_error"] = f"{type(e).__name__}: {e}"[:300]
        # (e5)'s control: the other rank's slice of the same adapters (of
        # the right shape, so the session takes it as sliced)
        other = copy.copy(mesh)
        other.model_index = mesh.model - 1 - mesh.model_index
        swapped = sharding.shard_adapters(tp_adapters(cfg, dev), cfg, other)
        _, first = tp_adapter_turn(model, cfg, tok, swapped, tap, mesh=mesh)
        np.save(os.path.join(TP_DIR, f"rank{rank}_e5x.npy"), first)
    finally:
        tap.restore()
    return out


def tp_rank_main(rank: int, port: int, dev=None, fault=False,
                 w4a8_fault=False) -> int:
    """One rank of phase 11 (``chip_smoke.py --tp-rank R --tp-port P``):
    joins the gloo group on this card, runs (a)-(e) and writes
    ``rank<R>.json`` (and its logit slices) under TP_DIR; ``fault``
    (``--tp-snapshot-fault``) plants (e)'s faults, ``w4a8_fault``
    (``--tp-w4a8-fault``) (c)'s: the W4A8 row-parallel sites without
    their ``RowShard``, so each rank quantizes its halves alone."""
    import dataclasses

    import torch

    from cogstream_tpu_torch import presets
    from cogstream_tpu_torch.models import qwen2
    from cogstream_tpu_torch.config import CogReasonerConfig, CompressionConfig
    from cogstream_tpu_torch.models.checkpoint import load_cogreasoner_from_hf
    from cogstream_tpu_torch.models.cogreasoner import (
        CogReasoner, init_cogreasoner_params)
    from cogstream_tpu_torch.ops import kernels
    from cogstream_tpu_torch.ops.quant import quantize_text_
    from cogstream_tpu_torch.parallel.distributed import initialize_if_needed
    from cogstream_tpu_torch.parallel.mesh import COLLECTIVES, make_mesh
    from cogstream_tpu_torch.parallel.sharding import (
        init_cogreasoner_sharded, shard_cogreasoner)
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.runtime.session import StreamingSession

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dev or torch.device("cuda", 0)
    kernels.library()                      # built by the parent: loads
    initialize_if_needed(f"tcp://127.0.0.1:{port}", TP_WORLD, rank,
                         backend="gloo", timeout_s=900)
    mesh = make_mesh(data_parallel=1, model_parallel=TP_WORLD)
    out = {}

    def counts(idx):
        return {KERNELS[i][0]: wrapper(i).launches for i in idx}

    def zero(idx):
        for i in idx:
            wrapper(i).launches = 0

    # (a) tiny f32, rank 0 first runs the same session solo on the card
    cfg = dataclasses.replace(
        CogReasonerConfig.tiny(),
        compression=CompressionConfig(frames_per_event=3,
                                      keyframes_per_event=1,
                                      min_events_for_compression=1,
                                      similarity_threshold=2.0))
    tiny = init_cogreasoner_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu").to(dev)

    def tiny_turns(**kw):
        turns, _, sess = run_tiny_session(tiny, cfg, dev, **kw)
        la = sess.ask("and after that?", mode="AC", max_new_tokens=8,
                      lookahead_k=4)
        return [t for t, _ in turns] + [la["tokens"]]

    solo = tiny_turns() if rank == 0 else None
    zero(BF16_PATH)
    out["a"] = {"tokens": tiny_turns(mesh=mesh), "solo": solo,
                "launches": counts(BF16_PATH)}
    del tiny
    log(f"(a) tiny tokens {out['a']['tokens']}")

    # (b) phase 5's model at tp = 2, each rank building only its shard
    cfg = presets.cogreasoner_7b()
    tok = ByteTokenizer(image_token_id=cfg.image_token_index,
                        vocab=cfg.text.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_cogreasoner_sharded(
        cfg, torch.Generator(device=dev).manual_seed(0), mesh, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    whole_gib, whole_dec = tp_whole_gib(cfg)
    t, gh, gw, ms = MAIN_SEGMENTS
    zero(BF16_PATH)
    COLLECTIVES.clear()
    tap = FirstLogits()
    sess = StreamingSession(model, cfg, tok, max_len=16384, mesh=mesh)
    ingest_s, turn_s, tokens, selections = [], [], {}, {}
    steps = []
    for seg_i, (pv, (question, mode)) in enumerate(zip(main_segments(),
                                                       MAIN_ASKS)):
        t0 = time.perf_counter()
        sess.append_stream_segment(pv, (t, gh, gw), ms,
                                   timestamps=[float(seg_i * t + f)
                                               for f in range(t)])
        torch.cuda.synchronize()
        ingest_s.append(round(time.perf_counter() - t0, 3))
        tap.arm()
        tap.steps = []
        t0 = time.perf_counter()
        r = sess.ask(question, mode=mode, max_new_tokens=TP_ASK_TOKENS)
        torch.cuda.synchronize()
        turn_s.append(round(time.perf_counter() - t0, 3))
        tokens[mode] = r["tokens"]
        steps += tap.steps
        selections[mode] = r["selection"]
        np.save(os.path.join(TP_DIR, f"rank{rank}_{mode}.npy"), tap.first)
    tap.restore()
    lo_hi = list(model.text.tp.vocab)
    out["b"] = {
        "tokens": tokens, "selections": selections, "vocab": lo_hi,
        "launches": counts(BF16_PATH), "gib": _gib(model),
        "decoder_gib": _gib(model.text), "whole_gib": whole_gib,
        "whole_decoder_gib": whole_dec, "init_s": init_s,
        "ingest_s": ingest_s, "turn_s": turn_s,
        "collectives_per_step": (sorted(set(steps)) if steps else []),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"(b) tokens {tokens}; selections {selections}")
    out["e"] = tp_rank_snapshots(sess, model, cfg, tok, mesh, rank, dev,
                                 fault)
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    log(f"(e) {out['e']}")

    # (c) quantized copies of the sharded decoder, one at a time; with
    # w4a8_fault the W4A8 session's row-parallel sites quantize each
    # rank's halves at their own scales
    out["c"] = {"vocab": lo_hi}
    tap = FirstLogits()
    for bits, sessions in TP_QUANT:
        text = quantize_text_(shared_copy(model.text), bits)
        idx = INT8_PATH if bits == 8 else INT4_PATH
        for key, flags in sessions:
            qcfg = dataclasses.replace(
                cfg, text=dataclasses.replace(cfg.text, **flags))
            shards = qwen2.row_shards
            if w4a8_fault and key == "w4a8":
                qwen2.row_shards = lambda text: {"o_proj": None,
                                                 "down_proj": None}
            zero(idx)
            qmodel = CogReasoner(text, model.vision, model.projector)
            try:
                toks, first = tp_quant_session(qmodel, qcfg, tok, tap,
                                               mesh=mesh)
                out["c"][key] = {"tokens": toks, "launches": counts(idx)}
                if key == "w4a8":
                    hid, lg = tp_w4a8_prefill(qmodel, qcfg)
                    np.save(os.path.join(TP_DIR, f"rank{rank}_w4a8_h.npy"),
                            hid)
                    np.save(os.path.join(TP_DIR, f"rank{rank}_w4a8_l.npy"),
                            lg)
            finally:
                qwen2.row_shards = shards
            np.save(os.path.join(TP_DIR, f"rank{rank}_{key}.npy"), first)
        del text
        gc.collect()
        torch.cuda.empty_cache()
    tap.restore()
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the sharded load against this rank's slice of the whole load
    ckpt = os.path.join(TP_DIR, "hf")
    ccfg = cut_config()
    out["d"] = {}
    for bits in (None, 8, 4):
        whole_m = load_cogreasoner_from_hf(ckpt, ccfg, device=dev,
                                           quantize_text_bits=bits)
        want = shard_cogreasoner(whole_m, ccfg, mesh)
        del whole_m
        got = load_cogreasoner_from_hf(ckpt, ccfg, device=dev,
                                       quantize_text_bits=bits, mesh=mesh)
        w = dict(want.named_parameters())
        w.update(dict(want.named_buffers()))
        g = dict(got.named_parameters())
        g.update(dict(got.named_buffers()))
        equal = sorted(w) == sorted(g) and all(
            w[n].dtype == g[n].dtype and w[n].shape == g[n].shape
            and torch.equal(w[n], g[n]) for n in w)
        out["d"][str(bits or "bf16")] = {"equal": bool(equal),
                                         "gib": _gib(got)}
        del want, got, w, g
        torch.cuda.empty_cache()
    out["collective_kinds"] = sorted(COLLECTIVES)
    with open(os.path.join(TP_DIR, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# phase 11 (f): a server on a (data 2, model 2) mesh, four ranks on the card
# ---------------------------------------------------------------------------

TP_DP_WORLD = 4
# the four clients' questions (client i asks the i-th), the question asked
# after a snapshot, greedy tokens an ask, the servers' cache length
TP_DP_ASKS = ("What is on the screen?", "What moves in the video?",
              "Which colors do you see?", "Describe the scene.")
TP_DP_CONT = "And what happens next?"
TP_DP_TOKENS = 8
TP_DP_LEN = 4096


def tp_dp_frames() -> str:
    """(f)'s clip: the first frame of eight of phase 8's scenes, as a
    directory of .npy frames under TP_DIR (the video loader reads it with
    numpy alone, at 1 fps)."""
    path = os.path.join(TP_DIR, "frames")
    os.makedirs(path, exist_ok=True)
    for i, f in enumerate(engine_frames()[::ENGINE_T // ENGINE_SCENES][:8]):
        np.save(os.path.join(path, f"{i:04d}.npy"), f)
    return path


def tp_dp_reference(dev):
    """(f)'s reference: a solo server on the whole 2 + 2-layer checkpoint,
    one session per question on (f)'s clip; {question: (tokens,
    selection, first-step logits)}."""
    import torch

    from cogstream_tpu_torch.models.checkpoint import load_cogreasoner_from_hf
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.runtime.serve import SessionServer

    cfg = cut_config()
    tok = ByteTokenizer(image_token_id=cfg.image_token_index,
                        vocab=cfg.text.vocab_size)
    whole = load_cogreasoner_from_hf(os.path.join(TP_DIR, "hf"), cfg,
                                     device=dev)
    srv = SessionServer(whole, cfg, tok, max_len=TP_DP_LEN)
    frames = os.path.join(TP_DIR, "frames")
    tap = FirstLogits()
    out = {}
    try:
        for i, q in enumerate(TP_DP_ASKS):
            srv.create(f"c{i}")
            srv.ingest(f"c{i}", frames, None, None, 1.0)
            tap.arm()
            r = srv.ask(f"c{i}", q, mode="AC", max_new_tokens=TP_DP_TOKENS)
            out[q] = (r["tokens"], r["selection"], tap.first)
    finally:
        tap.restore()
        srv.close()
    del srv, whole
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_tp_dp_path(dev, stamp):
    """Phase 11 (f): a sharded server on a (data 2, model 2) mesh, four
    ranks (``chip_smoke.py --tp-dp-rank R``) on this card over gloo,
    loading phase 11 (d)'s checkpoint with ``load_cogreasoner_from_hf(
    mesh=)``; the parent writes the clip, starts them, and computes the
    solo server's reference while they run. Returns (the ranks' results,
    the reference, wall s)."""
    from concurrent.futures import ThreadPoolExecutor

    tp_dp_frames()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as ex:
        world = ex.submit(run_ranks, "--tp-dp-rank", TP_DIR, TP_DP_WORLD)
        ref = tp_dp_reference(dev)
        rcs = world.result()
    wall = time.perf_counter() - t0
    for r in range(TP_DP_WORLD):
        with open(os.path.join(TP_DIR, f"rank{r}.log")) as f:
            for line in f.read().splitlines():
                log(f"tp: (f) rank {r}: {line}")
    if rcs != [0] * TP_DP_WORLD:
        raise AssertionError(f"(data 2, model 2) ranks exited {rcs}")
    res = []
    for r in range(TP_DP_WORLD):
        with open(os.path.join(TP_DIR, f"f_rank{r}.json")) as f:
            res.append(json.load(f))
    log(f"tp: (f) reference: the solo server's tokens "
        f"{ {q: v[0] for q, v in ref.items()} } [{stamp}]")
    return res, ref, wall


def tp_dp_verdict(res, ref, wall, gate, stamp):
    """Phase 11 (f)'s checks (see :func:`tp_dp_rank_main`): each pooled
    row's and the solo session's first-step logit slice on every rank of
    the group that ran it within ``gate`` (phase 11 (b)'s AC gate) of the
    solo server's for the same question; every rank's texts and
    selections equal to rank 0's; the row of data group 1 restored from
    its snapshot continuing with the tokens of the row it was saved from,
    and so the solo session; each snapshot written and read by one rank
    (rank 2 the row's, rank 0 the solo session's); K1-K4 launched on
    every rank. Returns (ok, metrics)."""
    errs, missing = {}, []
    for r, x in enumerate(res):
        firsts = np.load(os.path.join(TP_DIR, f"f_rank{r}_first.npz"))
        for key, q in x["first_q"].items():
            if key not in firsts:
                missing.append((r, key))
                continue
            errs[(r, key)] = tp_slice_err(firsts[key], ref[q][2],
                                          x["vocab"])[0]
    per_row = {}
    for (r, key), e in errs.items():
        per_row.setdefault(key, []).append(e)
    # every pooled row on both ranks of its group, and the solo ask on all
    covered = (len(per_row) == len(TP_DP_ASKS) + 1 and all(
        len(v) == (TP_DP_WORLD if k == "solo" else 2)
        for k, v in per_row.items()))
    logits_ok = covered and not missing and max(errs.values()) <= gate
    same = all(x["answers"] == res[0]["answers"] for x in res)
    a0 = res[0]
    cont_ok = (a0["cont"]["row_saved"] == a0["cont"]["row_restored"]
               and a0["cont"]["solo"] == a0["cont"]["solo_restored"]
               and a0["cont"]["restored_row"] == 2)
    io = [x["io"] for x in res]
    io_ok = io == [{"written": ["f_solo.npz"], "read": ["f_solo.npz"]},
                   {"written": [], "read": []},
                   {"written": ["f_row2.npz"], "read": ["f_row2.npz"]},
                   {"written": [], "read": []}]
    launches_ok = all(min(x["launches"].values()) > 0 for x in res)
    ok = (logits_ok and same and cont_ok and io_ok and launches_ok
          and not a0["errors"])
    log(f"tp: (f) SessionServer(mesh=(data 2, model 2), pool_rows=4) over "
        f"HTTP, four clients (rows {a0['rows_of']}: rows 0-1 on data "
        f"group 0, 2-3 on group 1) and a solo server's session replicated "
        f"over both groups, on phase 11 (d)'s 2 + 2-layer checkpoint "
        f"loaded with mesh=: first-step logit slices vs the solo server's "
        f"{ {f'{r}:{k}': round(e, 6) for (r, k), e in sorted(errs.items())} }"
        f" of the row max, within (b)'s AC gate {gate:.4g} {logits_ok} "
        f"(missing {missing}); every rank's texts and selections equal to "
        f"rank 0's {same}; the row held by data group 1 saved and "
        f"restored onto row {a0['cont']['restored_row']} of a fresh "
        f"server: {TP_DP_CONT!r} tokens {a0['cont']['row_restored']} vs "
        f"the unsaved row's {a0['cont']['row_saved']}, the solo session's "
        f"restore {a0['cont']['solo_restored']} vs "
        f"{a0['cont']['solo']} {cont_ok}; snapshot files written / read "
        f"per rank {io} {io_ok}; launches per rank "
        f"{[x['launches'] for x in res]} {launches_ok}; client errors "
        f"{a0['errors']}; shard GiB per rank "
        f"{[round(x['gib'], 3) for x in res]}, load "
        f"{[x['load_s'] for x in res]} s; walls (four ranks sharing one "
        f"card over gloo, no data-parallel speed): clients "
        f"{a0['walls']} s, the world {wall:.1f} s; (f) {ok} [{stamp}]")
    return ok, {"tp_dp_logit_err": max(errs.values()) if errs else None,
                "tp_dp_gib": [x["gib"] for x in res],
                "tp_dp_walls_s": a0["walls"], "tp_dp_wall_s": wall}


def tp_dp_rank_main(rank: int, port: int, dev=None) -> int:
    """One rank of phase 11 (f) (``chip_smoke.py --tp-dp-rank R --tp-port
    P``): joins the 4-rank gloo group on this card, loads the checkpoint
    on (data 2, model 2) and runs three servers, rank 0 driving them:
    (1) ``pool_rows=4`` over HTTP, four client threads (create, ingest,
    ask AC), then /save of the session on row 2 (data group 1) and its
    ask of ``TP_DP_CONT``; (2) a fresh pooled server: two sessions, then
    /restore of that file (onto row 2) and the same ask; (3) a solo
    server: one session (replicated over both data groups) asked, saved,
    restored as a second one, both asked ``TP_DP_CONT``. Every rank
    records its first-step logit slices, answers, snapshot files and
    K1-K4 launches into ``f_rank<R>.{json,npz}`` under TP_DIR."""
    import threading
    import urllib.request

    import torch

    from cogstream_tpu_torch.models.checkpoint import load_cogreasoner_from_hf
    from cogstream_tpu_torch.ops import kernels
    from cogstream_tpu_torch.parallel.distributed import initialize_if_needed
    from cogstream_tpu_torch.parallel.mesh import make_mesh
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.runtime.serve import (SessionServer,
                                                   make_http_server)
    from cogstream_tpu_torch.runtime.session import StreamingSession

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dev or torch.device("cuda", 0)
    kernels.library()                      # built by the parent: loads
    initialize_if_needed(f"tcp://127.0.0.1:{port}", TP_DP_WORLD, rank,
                         backend="gloo", timeout_s=900)
    mesh = make_mesh(data_parallel=2, model_parallel=2)
    cfg = cut_config()
    tok = ByteTokenizer(image_token_id=cfg.image_token_index,
                        vocab=cfg.text.vocab_size)
    t0 = time.perf_counter()
    model = load_cogreasoner_from_hf(os.path.join(TP_DIR, "hf"), cfg,
                                     device=dev, mesh=mesh)
    torch.cuda.synchronize()
    out = {"gib": _gib(model), "load_s": round(time.perf_counter() - t0, 3),
           "vocab": list(model.text.tp.vocab), "first_q": {},
           "answers": [], "io": {"written": [], "read": []}}
    io = out["io"]
    write, read = (StreamingSession._write_snapshot,
                   StreamingSession._read_snapshot)

    def spy_write(sess, path, *a):
        io["written"].append(os.path.relpath(path, TP_DIR))
        return write(sess, path, *a)

    def spy_read(sess, path):
        io["read"].append(os.path.relpath(path, TP_DIR))
        return read(sess, path)

    StreamingSession._write_snapshot = spy_write
    StreamingSession._read_snapshot = spy_read
    for i in BF16_PATH:
        wrapper(i).launches = 0
    tap = FirstLogits()
    firsts = {}
    frames = os.path.join(TP_DIR, "frames")

    def record(answers):
        out["answers"].append({str(k): {f: v[f] for f in ("text",
                                                          "selection")}
                               for k, v in answers.items()})

    # (1) the pooled server: every rank records its rows' first-step
    # logit slices and every batch's answers
    srv = SessionServer(model, cfg, tok, max_len=TP_DP_LEN, pool_rows=4,
                        mesh=mesh)
    pool_ask = srv.pool.ask_batch

    def ask_batch(requests, **kw):
        tap.arm()
        answers = pool_ask(requests, **kw)
        held = sorted(b for b, _ in requests if srv.pool.holds(b))
        qs = dict(requests)
        for i, b in enumerate(held):
            if qs[b] in TP_DP_ASKS:
                firsts[f"row{b}"] = tap.first_rows[i]
                out["first_q"][f"row{b}"] = qs[b]
        record(answers)
        return answers

    srv.pool.ask_batch = ask_batch
    if rank == 0:
        httpd = make_http_server(srv, "127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        port_http = httpd.server_address[1]
        gate = threading.Barrier(len(TP_DP_ASKS))
        walls, errors = {}, []

        def post(path, body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port_http}{path}",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                return json.loads(r.read())

        def client(i):
            sid = f"c{i}"
            try:
                t0 = time.perf_counter()
                post("/session", {"session_id": sid})
                post("/ingest", {"session_id": sid, "video_path": frames,
                                 "fps": 1.0})
                gate.wait(timeout=600)
                post("/ask", {"session_id": sid, "question": TP_DP_ASKS[i],
                              "mode": "AC", "max_new_tokens": TP_DP_TOKENS})
                walls[sid] = round(time.perf_counter() - t0, 3)
            except Exception as e:  # noqa: BLE001 — fails (f)
                errors.append(f"{sid}: {type(e).__name__}: {e}")
                gate.abort()

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(TP_DP_ASKS))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        out["walls"], out["errors"] = walls, errors
        out["rows_of"] = dict(srv._row_of)
        sid2 = next(s for s, b in srv._row_of.items() if b == 2)
        path = os.path.join(TP_DIR, "f_row2.npz")
        post("/save", {"session_id": sid2, "path": path})
        cont = {"row_saved": post("/ask", {
            "session_id": sid2, "question": TP_DP_CONT, "mode": "AC",
            "max_new_tokens": TP_DP_TOKENS})["tokens"]}
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    else:
        srv.follow()
    # (2) a fresh pooled server restores the row onto its row 2
    srv2 = SessionServer(model, cfg, tok, max_len=TP_DP_LEN, pool_rows=4,
                         mesh=mesh)
    if rank == 0:
        for sid in ("x0", "x1"):
            srv2.create(sid)
        srv2.restore_session("r", path)
        cont["restored_row"] = srv2._row_of["r"]
        cont["row_restored"] = srv2.ask("r", TP_DP_CONT, mode="AC",
                                        max_new_tokens=TP_DP_TOKENS)["tokens"]
        srv2.close()
    else:
        srv2.follow()
    # (3) a solo server: its session is replicated over the data groups
    srv3 = SessionServer(model, cfg, tok, max_len=TP_DP_LEN, mesh=mesh)
    op_ask = srv3._op_ask

    def solo_ask(sid, question, **kw):
        tap.arm()
        answer = op_ask(sid, question, **kw)
        if question in TP_DP_ASKS:
            firsts["solo"] = tap.first
            out["first_q"]["solo"] = question
        record({sid: answer})
        return answer

    srv3._op_ask = solo_ask
    if rank == 0:
        srv3.create("s")
        srv3.ingest("s", frames, None, None, 1.0)
        srv3.ask("s", TP_DP_ASKS[0], mode="AC", max_new_tokens=TP_DP_TOKENS)
        path = os.path.join(TP_DIR, "f_solo.npz")
        srv3.save_session("s", path)
        srv3.restore_session("s2", path)
        for sid, key in (("s", "solo"), ("s2", "solo_restored")):
            cont[key] = srv3.ask(sid, TP_DP_CONT, mode="AC",
                                 max_new_tokens=TP_DP_TOKENS)["tokens"]
        out["cont"] = cont
        srv3.close()
    else:
        srv3.follow()
    tap.restore()
    out["launches"] = {KERNELS[i][0]: wrapper(i).launches for i in BF16_PATH}
    np.savez(os.path.join(TP_DIR, f"f_rank{rank}_first.npz"), **firsts)
    with open(os.path.join(TP_DIR, f"f_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# phase 12: data- and tensor-parallel training, two ranks sharing the card
# ---------------------------------------------------------------------------

TRAIN_TP_DIR = os.path.join(REPO, "build", "chip_smoke_train_tp")
TRAIN_TP_WORLD = 2
TRAIN_TP_S1 = dict(epochs=1, batch_size=2, max_len=2048, grad_accum=1,
                   warmup_steps=0, shuffle_copies=1, include_demo=False,
                   save_every=1000, log_every=1, learning_rate=1e-4)
TRAIN_TP_S2 = dict(grad_accum=1, save_every=10_000, learning_rate=1e-4)
# stage-1 steps in (a) and (b) (and their one-process references)
TRAIN_TP_STEPS = 1
# (d)'s GPipe microbatches (2 x 2048 tokens: one row each) and stages
TRAIN_PP_M = 2
TRAIN_PP_STAGES = 2
# every LoRA ``b`` starts drawn from N(0, TRAIN_TP_B_STD^2) instead of 0,
# so that the adapters act in the first forward and every leaf's first
# gradient is nonzero
TRAIN_TP_B_STD = 1e-2
# (b) / (c)'s bounds against one process: each first-step gradient leaf
# within TRAIN_TP_GRAD_REL of its norm (relative Frobenius) and all leaves
# together within TRAIN_TP_GRAD_ALL, each loss within TRAIN_TP_LOSS_REL of
# its value; adapters after the updates within 2.01 lr an update (Adam
# moves an element about +-lr whatever its gradient's size: a sanity bound
# only). Set from card readings (H100): sound layouts read at most 0.052
# of a leaf, 0.013 over all, 7.5e-4 of a loss (the data split's sum order
# alone, (a)'s witness: 0.028 and 0.0065); without copy_to_model on the
# attention input (--train-tp-fault) 1.18-1.39 of a leaf, 0.76-0.82 over
# all, 1.9e-2 of (b)'s second loss. (a) is held to its witness, the two
# data ranks' arithmetic in one process, bit for bit
TRAIN_TP_GRAD_REL = 0.15
TRAIN_TP_GRAD_ALL = 0.04
TRAIN_TP_LOSS_REL = 2e-3
TRAIN_TP_QUESTION = ("<|im_start|>user\nWhat happens next?<|im_end|>\n"
                     "<|im_start|>assistant\n")


def train_tp_inputs(cfg, tok):
    """Phase 12's data: 2 seeded selector samples that fit 2048 byte tokens
    without the demo block (one batch of 2, one step: a quarter of phase
    7's batch, so that two whole bf16 replicas fit on the card in (a) and
    the shards' all-reduces over gloo stay short; the gradient checks read
    the first step); a 4-frame turn of phase 7's 24x42 frames; a
    text-only turn in the 64-token bucket."""
    from cogstream_tpu_torch.train.data import encode_selector_sample
    from cogstream_tpu_torch.train.stage2 import pack_turn_batch

    samples = [s for s in _selector_samples(np.random.default_rng(7), 64)
               if encode_selector_sample(tok, s, TRAIN_TP_S1["max_len"],
                                         include_demo=False) is not None][:2]
    turn = _stage2_turn(np.random.default_rng(8), tok, cfg, 4, 24, 42, 2,
                        4096)
    text_turn = pack_turn_batch(tok, cfg, TRAIN_TP_QUESTION,
                                "The door opens.", None, None, 4096)
    assert text_turn["input_ids"].shape == (1, 64)    # K10's m <= 64
    return samples, turn, text_turn


def train_tp_lora_cfg():
    from cogstream_tpu_torch.config import LoRAConfig

    # dropout 0: every layout then computes the one-process function
    return LoRAConfig(dropout=0.0, include_projector=True)


def train_tp_lora(cfg, dev, stage: int):
    """Phase 12's initial adapter tree, whole (a run on a mesh keeps its
    slice): the stage's init from seed 0 (stage 1) or 1 (stage 2), every
    ``b`` then drawn from N(0, TRAIN_TP_B_STD^2) on the card from seed
    11, the same in every process."""
    import torch

    from cogstream_tpu_torch.models.lora import (init_cogreasoner_lora,
                                                 init_qwen2_lora, iter_leaves)

    lc = train_tp_lora_cfg()
    gen = torch.Generator(device=dev).manual_seed(stage - 1)
    tree = (init_qwen2_lora(gen, cfg.text, lc, device=dev) if stage == 1
            else init_cogreasoner_lora(gen, cfg, lc, device=dev))
    gen = torch.Generator(device=dev).manual_seed(11)
    with torch.no_grad():
        for path, t in iter_leaves(tree):
            if path.rsplit(".", 1)[-1] == "b":
                t.copy_(torch.randn(t.shape, generator=gen, device=dev)
                        * TRAIN_TP_B_STD)
    return tree


def train_tp_stage2(model, cfg, tok, out_dir, turns, dev, mesh_tp=None,
                    sp: int = 1):
    """``Stage2Trainer`` micro-steps on ``turns`` (phase 12 (c), and (e)
    with ``sp`` ranks on the ring): the losses, walls and the trainer.
    Stage 2's warm-up (JAX's recipe, at least one update) gives the first
    micro-step learning rate 0: its gradient is held, the second one
    updates."""
    import torch

    from cogstream_tpu_torch.train import stage2

    tr = stage2.Stage2Trainer(
        model, cfg, tok, stage2.Stage2Config(**TRAIN_TP_S2,
                                             model_parallel=mesh_tp,
                                             sequence_parallel=sp),
        out_dir, total_steps=4, log=lambda *a: None,
        lora_cfg=train_tp_lora_cfg(), lora=train_tp_lora(cfg, dev, 2))
    losses, walls = [], []
    for turn in turns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(tr.train_turn(dict(turn)))
        torch.cuda.synchronize()
        walls.append(round(time.perf_counter() - t0, 3))
    return losses, walls, tr


class _TwoDataRanks:
    """The witness of phase 12 (a): two data ranks' arithmetic in one
    process. While installed, a text loss counts its valid targets over
    the whole batch (what the data group's count all-reduce gives), so a
    half batch's loss is its Σ nll over the global count."""

    def __init__(self, total):
        from cogstream_tpu_torch.train import trainer

        self.trainer, self.total = trainer, total
        self.saved = (trainer.loss_groups, trainer.all_reduce)
        token = self

        def groups(text):
            return {"count_group": token}

        def reduce(x, group, op="sum"):
            if group is token:
                return x.new_full(x.shape, self.total)
            return self.saved[1](x, group, op)

        trainer.loss_groups = groups
        trainer.all_reduce = reduce

    def restore(self):
        self.trainer.loss_groups, self.trainer.all_reduce = self.saved


def train_tp_witness(model, cfg, tok, samples, dev):
    """Phase 12 (a)'s witness: each of ``train_stage1``'s steps (same
    batches, same optimizer) computed as two data ranks compute it, each
    half batch's loss over the global count and gradient, the two summed
    in f32; returns (losses, adapters, the first step's gradients)."""
    import torch

    from cogstream_tpu_torch.models.lora import iter_leaves
    from cogstream_tpu_torch.processor.tokenizer import (
        constrained_selector_token_ids)
    from cogstream_tpu_torch.runtime.sampling import build_vocab_mask
    from cogstream_tpu_torch.train import trainer as tr
    from cogstream_tpu_torch.train.data import selector_batches

    s1 = TRAIN_TP_S1
    lc = train_tp_lora_cfg()
    lora = train_tp_lora(cfg, dev, 1)
    leaves = [t for _, t in iter_leaves(lora)]
    tx = tr.make_optimizer(s1["learning_rate"], total_steps=TRAIN_TP_STEPS,
                           warmup_steps=0, grad_accum=1)
    state = tx.init(leaves)
    vm = build_vocab_mask(cfg.text.vocab_size,
                          constrained_selector_token_ids(tok), dev)
    loss_fn = tr.bind_text_loss(lc, vm, remat=True, text_cfg=cfg.text)
    losses, first = [], None
    for batch in selector_batches(tok, samples, s1["batch_size"],
                                  s1["max_len"], seed=0, shuffle_copies=1,
                                  include_demo=False):
        n = int((batch["labels"][:, 1:] != tr.IGNORE_INDEX).sum())
        half = batch["input_ids"].shape[0] // 2
        total, grads = None, None
        for d in range(2):
            part = tr.to_device({k: v[d * half:(d + 1) * half]
                                 for k, v in batch.items()}, dev)
            two = _TwoDataRanks(n)
            try:
                loss = loss_fn(model.text, lora, part)
            finally:
                two.restore()
            g = torch.autograd.grad(loss, leaves)
            grads = [x.float() for x in g] if grads is None else [
                a + b.float() for a, b in zip(grads, g)]
            total = loss.detach() if total is None else total + loss.detach()
        if first is None:
            first = [g.clone() for g in grads]
        updates, state = tx.update(grads, state, leaves)
        with torch.no_grad():
            for p, u in zip(leaves, updates):
                p.add_(u.to(p.dtype))
        losses.append(float(total))
    return losses, lora, first


class StepSpy:
    """Each training step's collectives, wall, wall inside the collectives
    (a sync before and after each all-reduce and ``ppermute`` hop: compute
    is not counted, the wait for the other rank is) and loss, each hop's
    bytes and wall, and the first update's gradients since the last
    :meth:`take_grads` (whole on one process, a mesh rank's slices on a
    rank), through the ``make_train_step`` of the modules given
    (instrumentation of this script only)."""

    def __init__(self, *modules):
        import torch

        from cogstream_tpu_torch.parallel import mesh

        self.steps, self.grads, self.coll_s, self.hops = [], None, 0.0, []
        self.saved = [(m, m.make_train_step) for m in modules]
        self.mesh, self.reduce = mesh, mesh._all_reduce
        # the hop this spy times (ZeroBackHop may wrap it)
        self.orig_hop = self.hop = mesh._hop
        spy = self

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = spy.reduce(*a, **k)
            torch.cuda.synchronize()
            spy.coll_s += time.perf_counter() - t0
            return out

        def timed_hop(tensors, group, shift):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = spy.hop(tensors, group, shift)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            spy.coll_s += dt
            spy.hops.append((sum(t.numel() * t.element_size()
                                 for t in tensors), shift, dt))
            return out

        mesh._hop = timed_hop

        class Tap:
            """The optimizer, its first update's gradients kept."""

            def __init__(self, tx):
                self.tx = tx

            def __getattr__(self, name):
                return getattr(self.tx, name)

            def update(self, grads, state, params):
                if spy.grads is None:
                    spy.grads = [g.detach().float().clone() for g in grads]
                return self.tx.update(grads, state, params)

        mesh._all_reduce = timed
        for m, make in self.saved:
            def wrapped(tx, *a, _make=make, **k):
                step = _make(Tap(tx), *a, **k)

                def run(*args):
                    torch.cuda.synchronize()
                    n0, c0 = sum(mesh.COLLECTIVES.values()), spy.coll_s
                    t0 = time.perf_counter()
                    state, loss = step(*args)
                    torch.cuda.synchronize()
                    spy.steps.append((sum(mesh.COLLECTIVES.values()) - n0,
                                      round(time.perf_counter() - t0, 3),
                                      round(spy.coll_s - c0, 3),
                                      float(loss)))
                    return state, loss
                return run
            m.make_train_step = wrapped

    def take(self):
        out, self.steps = self.steps, []
        return out

    def take_hops(self):
        out, self.hops = self.hops, []
        return out

    def take_grads(self):
        out, self.grads = self.grads, None
        return out

    def restore(self):
        self.mesh._all_reduce, self.mesh._hop = self.reduce, self.orig_hop
        for m, make in self.saved:
            m.make_train_step = make


class NoAttnCopy:
    """A planted fault for phase 12's self-test (``--train-tp-fault``):
    the decoder's normed attention input skips ``copy_to_model``, so the
    input gradient of a rank's q / k / v block is not summed over the
    model group, as when the Megatron copy operator is missing there."""

    def __init__(self, text):
        from cogstream_tpu_torch.models import qwen2

        self.qwen2 = qwen2
        self.saved = (qwen2.rms_norm, qwen2.copy_to_model)
        norm, copy = self.saved
        ids = {id(layer.input_norm) for layer in text.layers}
        last = [None]

        def tagged(x, scale, eps):
            out = norm(x, scale, eps)
            if id(scale) in ids:
                last[0] = out
            return out

        def skip(x, group):
            return x if x is last[0] else copy(x, group)

        qwen2.rms_norm, qwen2.copy_to_model = tagged, skip

    def restore(self):
        self.qwen2.rms_norm, self.qwen2.copy_to_model = self.saved


class ZeroBackHop:
    """A planted fault for phase 12's self-test (``--train-pp-fault``): on
    rank 1, the first backward ``ppermute`` hop after each :meth:`arm`
    sends zeros of the right shapes (the schedule stays whole, the
    gradient it carries is lost), as when a stage drops a received
    tensor's gradient."""

    def __init__(self, spy, rank: int):
        self.armed = False
        real = spy.hop
        fault = self

        def hop(tensors, group, shift):
            if rank == 1 and fault.armed and shift < 0:
                fault.armed = False
                tensors = [t.new_zeros(t.shape) for t in tensors]
            return real(tensors, group, shift)

        spy.hop = hop

    def arm(self):
        self.armed = True


def w8a8_cfg(cfg):
    """``cfg`` with the decoder's ``w8a8_prefill`` on (stage 2's
    ``--w8a8-forward``): an int8 base's prefill-length GEMMs run W8A8."""
    import dataclasses

    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, w8a8_prefill=True))


class W8A8LocalAbsmax:
    """A planted fault for phase 12 (f)'s self-test
    (``--train-w8a8-fault``): int8 activations take each rank's own
    absmax (``quantize_int8_act`` ignores its group), so a row-parallel
    W8A8 site quantizes its channels at another scale than the whole
    row's."""

    def __init__(self):
        from cogstream_tpu_torch.ops import quant

        self.quant, self.saved = quant, quant.quantize_int8_act
        alone = self.saved
        quant.quantize_int8_act = lambda x, reduce=None: alone(x)

    def restore(self):
        self.quant.quantize_int8_act = self.saved


# (f)'s exact products: 7B o_proj [3584, 3584] and down_proj [18944, 3584]
# at 64 rows, the weights' rows split over the two ranks
W8A8_EXACT_SITES = (("o_proj", 3584), ("down_proj", 18944))


def w8a8_row_shard_exact(mesh, dev) -> dict:
    """Phase 12 (f)'s exact check, on each rank: the W8A8 product
    (``quant._W8A8STE``) of each W8A8_EXACT_SITES weight on this rank's row
    shard (the model group as ``reduce``) against the whole product on the
    card, forward and ``dx``, bit for bit. Seeded the same on every rank:
    x [64, din] bf16 normal draws, int8 weights with power-of-two scales,
    an integer output gradient, so every term and partial sum of ``dx = g
    @ W_deq^T`` is exact in f32 and the rounded ``dx`` is the same bits
    whatever the GEMM's summation order. Returns {site: (forward equal,
    dx equal)}."""
    import torch

    from cogstream_tpu_torch.ops import quant

    out = {}
    for i, (site, din) in enumerate(W8A8_EXACT_SITES):
        gen = torch.Generator(device=dev).manual_seed(40 + i)
        x = torch.randn((64, din), generator=gen, device=dev).to(
            torch.bfloat16)
        q = torch.randint(-127, 128, (din, 3584), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = torch.exp2(-torch.randint(6, 9, (3584,), generator=gen,
                                          device=dev).float())
        g = torch.randint(-4, 5, (64, 3584), generator=gen,
                          device=dev).to(torch.bfloat16)
        whole = x.clone().requires_grad_(True)
        y = quant._W8A8STE.apply(whole, quant.column_major(q), scale)
        dx, = torch.autograd.grad(y, whole, g)
        n = din // mesh.model
        rows = slice(mesh.model_index * n, (mesh.model_index + 1) * n)
        xs = x[:, rows].clone().requires_grad_(True)
        ys = quant._W8A8STE.apply(xs, quant.column_major(q[rows]), scale,
                                  mesh.model_group)
        dxs, = torch.autograd.grad(ys, xs, g)
        out[site] = (bool(torch.equal(ys, y)),
                     bool(torch.equal(dxs, dx[:, rows])))
    return out


def _grads_vs(got, ref):
    """First-step gradients (path -> tensor) against the reference's:
    the largest per-leaf relative Frobenius gap, its leaf, and the gap over
    every leaf together."""
    import torch

    if got.keys() != ref.keys():
        raise AssertionError(f"gradient trees differ: {sorted(got)[:3]} vs "
                             f"{sorted(ref)[:3]}")
    worst, leaf, num, den = 0.0, None, 0.0, 0.0
    for k, r in ref.items():
        r = r.float().cpu()
        d = float(torch.linalg.vector_norm(got[k].float().cpu() - r))
        n = float(torch.linalg.vector_norm(r))
        num, den = num + d * d, den + n * n
        rel = d / n if n > 0 else (0.0 if d == 0 else float("inf"))
        if rel >= worst:
            worst, leaf = rel, k
    return worst, leaf, (num / den) ** 0.5 if den > 0 else float("inf")


def _whole_grads(state, grads):
    """A rank's first-step gradient slices, whole (collective over the
    model or pipe group; already whole without a layout), by leaf path on
    the host."""
    from cogstream_tpu_torch.models.lora import iter_leaves

    if state.layout is None:
        paths, whole = [p for p, _ in iter_leaves(state.lora)], grads
    else:
        paths, whole = state.layout.paths, state.layout.gather_leaves(grads)
    return {p: g.cpu() for p, g in zip(paths, whole)}


def run_train_tp_path(model, dev, stamp, fault=False, pp_fault=False,
                      w8a8_fault=False):
    """Phase 12: data- and tensor-parallel LoRA training at 7B width and
    depth, two ranks on this card (subprocesses of this script,
    ``--train-rank``) over gloo, as phase 11. The parent first runs the
    same steps in one process on the phase-5 model (untimed; LoRA dropout
    0, so every layout computes one function; every ``b`` drawn nonzero,
    :func:`train_tp_lora`): ``train_stage1`` one step of 2 x 2048 byte
    tokens, its witness in two data ranks' sum order
    (:func:`train_tp_witness`), two ``Stage2Trainer`` micro-steps on phase
    7's frames in a 4-frame turn (the first is warm-up, at learning rate
    0: the second
    makes the update that (c)'s adapters are held to), and one on the
    64-token text turn over an int8 copy
    (``quantize_cogreasoner_`` on a ``shared_copy``). The ranks run (a)
    ``train_stage1`` on a (2, 1) mesh (two whole replicas, each batch
    split on ``data``), (b) on a (1, 2) mesh (each rank its shard of the
    decoder and the LoRA), (c) ``Stage2Trainer`` on (1, 2): the two
    4-frame micro-steps (the tower on 8 heads a rank, K5), then the
    64-token turn on an int8 copy of the shards (K10 on column and row
    shards). Held here: (a)'s losses and gathered adapters equal to the
    witness's; (b), (c) and the int8 turn's first-step gradients, gathered
    over the ranks, within ``TRAIN_TP_GRAD_REL`` of one process's leaf by
    leaf, their losses within ``TRAIN_TP_LOSS_REL``, their adapters within
    2.01 lr an update; each rank's replicated leaves bit-equal to the
    other's; every K5 launch on its tensor-core kernel (2 x 27), K10
    launched on each rank; the adapter files the ranks wrote load here.
    Printed per rank: peak GiB, collectives a step, walls and the wall
    inside the collectives (two ranks sharing one card over gloo: not a
    speed). Then (d) ``train_stage1`` on a (data 1, pipe 2) mesh (GPipe,
    TRAIN_PP_M microbatches) and (e) ``Stage2Trainer`` with
    ``sequence_parallel=2`` on the 4-frame turn, both in the same ranks on
    the whole model, held to the same one-process steps as (b) and (c):
    first-step gradients gathered over the stages (summed over the ring)
    within ``TRAIN_TP_GRAD_REL`` / ``TRAIN_TP_GRAD_ALL``, losses within
    ``TRAIN_TP_LOSS_REL``, adapters within 2.01 lr an update, (e)'s K5
    launches all on the tensor-core tile (2 x 27 a rank, the whole tower)
    and K2 launched; printed with each part's hops, bytes and hop walls.
    (f), in the same ranks after (c): (c)'s 64-token turn on the int8
    shards with ``w8a8_prefill`` (stage 2's ``--w8a8-forward``: W8A8 on
    column and row shards, the row shards' absmax MAXed and int32 sums
    reduced over the model group), held to the one-process W8A8 turn with
    (b)'s bounds, and the exact products of
    :func:`w8a8_row_shard_exact` (forward and ``dx`` bit-equal to the
    whole). ``fault`` plants :class:`NoAttnCopy` in the ranks,
    ``pp_fault`` :class:`ZeroBackHop`, ``w8a8_fault``
    :class:`W8A8LocalAbsmax` in (f) (the checks' self-tests: the phase
    must then fail)."""
    import shutil

    import torch

    from cogstream_tpu_torch import presets
    from cogstream_tpu_torch.models.lora import iter_leaves
    from cogstream_tpu_torch.ops.quant import quantize_cogreasoner_
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.train import stage1, stage2
    from cogstream_tpu_torch.train.checkpoint import load_lora_adapter

    shutil.rmtree(TRAIN_TP_DIR, ignore_errors=True)
    os.makedirs(TRAIN_TP_DIR)
    try:
        cfg = presets.cogreasoner_7b()
        tok = ByteTokenizer(image_token_id=cfg.image_token_index,
                            vocab=cfg.text.vocab_size)
        samples, turn, text_turn = train_tp_inputs(cfg, tok)
        t0 = time.perf_counter()
        spy = StepSpy(stage1, stage2)
        ref = {}
        try:
            s1 = stage1.train_stage1(
                model.text, cfg, tok, samples,
                os.path.join(TRAIN_TP_DIR, "s1"),
                stage1.Stage1Config(**TRAIN_TP_S1), resume=False,
                log=lambda *a: None, lora_cfg=train_tp_lora_cfg(),
                lora=train_tp_lora(cfg, dev, 1))
            ref["s1_losses"] = [x for *_, x in spy.take()]
            ref["s1_lora"], ref["s1_grads"] = s1.lora, spy.take_grads()
            losses, _, tr2 = train_tp_stage2(
                model, cfg, tok, os.path.join(TRAIN_TP_DIR, "s2"),
                [turn, turn], dev)
            ref["s2_losses"], ref["s2_lora"] = losses, tr2.state.lora
            ref["s2_grads"] = spy.take_grads()
            del tr2
            q = quantize_cogreasoner_(shared_copy(model), 8)
            ref["int8_losses"] = train_tp_stage2(
                q, cfg, tok, os.path.join(TRAIN_TP_DIR, "int8"),
                [text_turn], dev)[0]
            ref["int8_grads"] = spy.take_grads()
            ref["w8a8_losses"] = train_tp_stage2(
                q, w8a8_cfg(cfg), tok, os.path.join(TRAIN_TP_DIR, "w8a8"),
                [text_turn], dev)[0]
            ref["w8a8_grads"] = spy.take_grads()
            del q
        finally:
            spy.restore()
        ref["w_losses"], ref["w_lora"], w_grads = train_tp_witness(
            model, cfg, tok, samples, dev)
        paths = {"s1": [p for p, _ in iter_leaves(s1.lora)]}
        for c in ("s2", "int8", "w8a8"):
            paths[c] = [p for p, _ in iter_leaves(ref["s2_lora"])]
        for c in ("s1", "s2", "int8", "w8a8"):
            ref[f"{c}_grads"] = {p: g.cpu() for p, g in
                                 zip(paths[c], ref[f"{c}_grads"])}
        w_grads = {p: g.cpu() for p, g in zip(paths["s1"], w_grads)}
        ref["w_vs_s1"] = _grads_vs(w_grads, ref["s1_grads"])
        del s1, w_grads
        gc.collect()
        torch.cuda.empty_cache()
        log(f"train-tp: one-process references in "
            f"{time.perf_counter() - t0:.1f}s: stage 1 losses "
            f"{ref['s1_losses']} (witness {ref['w_losses']}), stage 2 "
            f"{ref['s2_losses']}, int8 {ref['int8_losses']}, int8 + W8A8 "
            f"{ref['w8a8_losses']} [{stamp}]")
        t0 = time.perf_counter()
        rcs = run_ranks("--train-rank", TRAIN_TP_DIR, TRAIN_TP_WORLD,
                        extra=(["--train-tp-fault"] if fault else [])
                        + (["--train-pp-fault"] if pp_fault else [])
                        + (["--train-w8a8-fault"] if w8a8_fault else []))
        wall = time.perf_counter() - t0
        for r in range(TRAIN_TP_WORLD):
            with open(os.path.join(TRAIN_TP_DIR, f"rank{r}.log")) as f:
                for line in f.read().splitlines():
                    log(f"train-tp: rank {r}: {line}")
        if rcs != [0] * TRAIN_TP_WORLD:
            raise AssertionError(f"training ranks exited {rcs}")
        res = []
        for r in range(TRAIN_TP_WORLD):
            with open(os.path.join(TRAIN_TP_DIR, f"rank{r}.json")) as f:
                res.append(json.load(f))
        got = {c: load_lora_adapter(os.path.join(TRAIN_TP_DIR, c, name),
                                    device=dev)
               for c, name in (("a", "language_module.npz"),
                               ("b", "language_module.npz"),
                               ("c", "full_module.npz"),
                               ("d", "language_module.npz"),
                               ("e", "full_module.npz"))}
        grads = {c: torch.load(os.path.join(TRAIN_TP_DIR, f"grads_{c}.pt"))
                 for c in ("b", "c", "c_int8", "c_w8a8", "d", "e")}
        return train_tp_verdict(res, ref, got, grads, wall, stamp)
    finally:
        shutil.rmtree(TRAIN_TP_DIR, ignore_errors=True)


def train_tp_verdict(res, ref, got, grads, wall, stamp):
    """Phase 12's checks on the ranks' results (see run_train_tp_path)."""
    lr = TRAIN_TP_S1["learning_rate"]

    def rel(a, b):
        return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))

    def gap(c, key):
        worst, leaf, total = _grads_vs(grads[c], ref[key])
        return (worst <= TRAIN_TP_GRAD_REL and total <= TRAIN_TP_GRAD_ALL,
                f"first-step gradients vs one process {worst:.3g} of the "
                f"leaf's norm at worst ({leaf}), {total:.3g} over every leaf "
                f"(bounds {TRAIN_TP_GRAD_REL}, {TRAIN_TP_GRAD_ALL})")

    ok = True
    a0 = res[0]["a"]
    bit = _adapters_vs(got["a"], ref["w_lora"], lr)
    plain = _adapters_vs(got["a"], ref["s1_lora"], lr)
    a_ok = (a0["losses"] == ref["w_losses"] and bit[0] == 0.0
            and a0["steps"] == TRAIN_TP_STEPS)
    w = ref["w_vs_s1"]
    log(f"train-tp (a) stage 1 on (data 2, model 1): losses {a0['losses']} "
        f"(witness {ref['w_losses']}, one process {ref['s1_losses']}); "
        f"gathered adapters vs the witness {bit[0]:.3g} lr max (bit-equal "
        f"{bit[0] == 0.0}), vs one process {plain[0]:.3g} lr max, "
        f"{plain[1]:.4f} of elements beyond 1e-3 lr; the witness's "
        f"first-step gradients vs one process (the data split's sum order "
        f"alone) {w[0]:.3g} of the leaf's norm at worst ({w[1]}), "
        f"{w[2]:.3g} over every leaf [{stamp}]")
    b0 = res[0]["b"]
    bgap = _adapters_vs(got["b"], ref["s1_lora"], lr)
    b_grads, btxt = gap("b", "s1_grads")
    b_ok = (rel(b0["losses"], ref["s1_losses"]) <= TRAIN_TP_LOSS_REL
            and b_grads and bgap[0] <= 2.01 * TRAIN_TP_STEPS
            and b0["steps"] == TRAIN_TP_STEPS)
    log(f"train-tp (b) stage 1 on (data 1, model 2): {btxt}; losses "
        f"{b0['losses']} (one process {ref['s1_losses']}, rel {rel(b0['losses'], ref['s1_losses']):.3g}"
        f", bound {TRAIN_TP_LOSS_REL}); gathered adapters vs one process "
        f"{bgap[0]:.3g} lr max, {bgap[1]:.4f} beyond 1e-3 lr [{stamp}]")
    c0 = res[0]["c"]
    cgap = _adapters_vs(got["c"], ref["s2_lora"], lr)
    c_grads, ctxt = gap("c", "s2_grads")
    q_grads, qtxt = gap("c_int8", "int8_grads")
    c_ok = (rel(c0["losses"], ref["s2_losses"]) <= TRAIN_TP_LOSS_REL
            and rel(c0["int8_losses"], ref["int8_losses"])
            <= TRAIN_TP_LOSS_REL and c_grads and q_grads
            and cgap[0] <= 2.01)
    log(f"train-tp (c) stage 2 on (data 1, model 2): {ctxt}; losses "
        f"{c0['losses']} (one process {ref['s2_losses']}, rel "
        f"{rel(c0['losses'], ref['s2_losses']):.3g}, bound "
        f"{TRAIN_TP_LOSS_REL}); gathered adapters "
        f"after one update vs one process {cgap[0]:.3g} lr max, "
        f"{cgap[1]:.4f} beyond 1e-3 lr; int8 turn: {qtxt}; loss "
        f"{c0['int8_losses']} (one process {ref['int8_losses']}, rel "
        f"{rel(c0['int8_losses'], ref['int8_losses']):.3g}) [{stamp}]")
    for r, x in enumerate(res):
        k5 = x["c"]["k5"]
        heads = x["c"]["tower_heads"]
        k_ok = (k5["launches"] == k5["tc_launches"] == 2 * 27
                and heads == 8 and x["c"]["k10"] > 0)
        shares = {c: [round(s / t, 3) for s, t in
                      zip(x[c]["coll_s"], x[c]["walls"])] for c in "abc"}
        log(f"train-tp: rank {r}: K5 {k5['launches']} launches, "
            f"{k5['tc_launches']} on the tensor-core tile, {heads} tower "
            f"heads; K10 {x['c']['k10']} launches in the int8 turn; peak GiB "
            f"(a) {x['a']['peak_gib']:.2f} (b) {x['b']['peak_gib']:.2f} (c) "
            f"{x['c']['peak_gib']:.2f}; collectives a step (a) "
            f"{x['a']['collectives']} (b) {x['b']['collectives']} (c) "
            f"{x['c']['collectives']} int8 {x['c']['int8_collectives']}; "
            f"step walls (a) {x['a']['walls']} (b) {x['b']['walls']} (c) "
            f"{x['c']['walls']} s, of them in the collectives (a) "
            f"{x['a']['coll_s']} (b) {x['b']['coll_s']} (c) "
            f"{x['c']['coll_s']} s, shares {shares}; int8 turn "
            f"{x['c']['int8_walls']} s, {x['c']['int8_coll_s']} in the "
            f"collectives (two ranks sharing one card over gloo: not a "
            f"speed) [{stamp}]")
        ok &= k_ok
    d_ok, e_ok = train_pp_verdict(res, ref, got, grads, gap, rel, stamp)
    f0 = res[0]["f"]
    f_grads, ftxt = gap("c_w8a8", "w8a8_grads")
    exact = [x["f"]["exact"] for x in res]
    f_ok = (rel(f0["losses"], ref["w8a8_losses"]) <= TRAIN_TP_LOSS_REL
            and f_grads
            and all(all(e) for x in exact for e in x.values())
            and all(x["f"]["int8_mm"] > 0 for x in res))
    log(f"train-tp (f) stage 2 with w8a8_prefill on (data 1, model 2), the "
        f"64-token turn on the int8 shards: {ftxt}; loss {f0['losses']} "
        f"(one process {ref['w8a8_losses']}, rel "
        f"{rel(f0['losses'], ref['w8a8_losses']):.3g}, bound "
        f"{TRAIN_TP_LOSS_REL}; int8 weight-only turn {ref['int8_losses']}); "
        f"W8A8 products a rank {[x['f']['int8_mm'] for x in res]}; walls "
        f"{[x['f']['walls'] for x in res]} s, in the collectives "
        f"{[x['f']['coll_s'] for x in res]} s; exact row-shard products "
        f"(forward, dx) bit-equal to the whole, by rank {exact} [{stamp}]")
    same = {c: res[0][c]["replicated"] == res[1][c]["replicated"]
            for c in "abcdef"}
    log(f"train-tp: replicated leaves bit-equal across the ranks {same}; "
        f"phase 12 in {wall:.1f}s [{stamp}]")
    ok &= (a_ok and b_ok and c_ok and d_ok and e_ok and f_ok
           and all(same.values()))
    if not ok:
        raise AssertionError(f"phase 12 failed: (a) {a_ok} (b) {b_ok} (c) "
                             f"{c_ok} (d) {d_ok} (e) {e_ok} (f) {f_ok} "
                             f"replicated {same}")
    return {"train_tp_peak_gib": [[x[c]["peak_gib"] for c in "abcdef"]
                                  for x in res],
            "train_tp_walls": [[x[c]["walls"] for c in "abcdef"]
                               for x in res],
            "train_tp_losses": {c: res[0][c]["losses"] for c in "abcdef"},
            "train_w8a8_exact": exact,
            "train_pp_hops": {c: [res[0][c]["hops"], res[0][c]["hop_bytes"]]
                              for c in "de"},
            "train_tp_wall_s": wall}


def train_pp_verdict(res, ref, got, grads, gap, rel, stamp):
    """Phase 12 (d) and (e)'s checks and lines: (d) against the stage-1
    step and (e) against the stage-2 micro-steps of one process, with the
    bounds (b) and (c) take; each part's walls, hops, bytes and each
    rank's peak GiB. Returns (d_ok, e_ok)."""
    lr = TRAIN_TP_S1["learning_rate"]
    d0, e0 = res[0]["d"], res[0]["e"]
    dgap = _adapters_vs(got["d"], ref["s1_lora"], lr)
    d_grads, dtxt = gap("d", "s1_grads")
    d_ok = (rel(d0["losses"], ref["s1_losses"]) <= TRAIN_TP_LOSS_REL
            and d_grads and dgap[0] <= 2.01 * TRAIN_TP_STEPS
            and d0["steps"] == TRAIN_TP_STEPS
            and all(x["d"]["layers"] == 28 // TRAIN_PP_STAGES for x in res))
    M, P = TRAIN_PP_M, TRAIN_PP_STAGES
    act = TRAIN_TP_S1["max_len"] * 3584 * 2 * (TRAIN_TP_S1["batch_size"]
                                               // M)
    fwd = [dt for b, sh, dt in d0["hop_walls"] if sh > 0 and b == act]
    log(f"train-tp (d) stage 1 on (data 1, pipe 2), GPipe with M = {M}: "
        f"{dtxt}; losses {d0['losses']} (one process {ref['s1_losses']}, "
        f"rel {rel(d0['losses'], ref['s1_losses']):.3g}, bound "
        f"{TRAIN_TP_LOSS_REL}); gathered adapters vs one process "
        f"{dgap[0]:.3g} lr max, {dgap[1]:.4f} beyond 1e-3 lr; "
        f"{d0['layers']} layers a stage; ppermute over {d0['route']}: "
        f"{d0['hops']} hops a rank ({M + P - 2} forward, as many backward), "
        f"{d0['hop_bytes']} bytes sent, {d0['hop_s']} s in them; a "
        f"[{TRAIN_TP_S1['batch_size'] // M}, {TRAIN_TP_S1['max_len']}, 3584] "
        f"bf16 hop ({act} bytes) {min(fwd, default=0):.4f}-"
        f"{max(fwd, default=0):.4f} s (host copies, two ranks on one card) "
        f"[{stamp}]")
    egap = _adapters_vs(got["e"], ref["s2_lora"], lr)
    e_grads, etxt = gap("e", "s2_grads")
    e_ok = (rel(e0["losses"], ref["s2_losses"]) <= TRAIN_TP_LOSS_REL
            and e_grads and egap[0] <= 2.01)
    log(f"train-tp (e) stage 2 with sequence_parallel=2 (the ring): "
        f"{etxt}; losses {e0['losses']} (one process {ref['s2_losses']}, "
        f"rel {rel(e0['losses'], ref['s2_losses']):.3g}, bound "
        f"{TRAIN_TP_LOSS_REL}); adapters after one update vs one process "
        f"{egap[0]:.3g} lr max, {egap[1]:.4f} beyond 1e-3 lr; "
        f"{e0['hops']} hops a rank, {e0['hop_bytes']} bytes sent, "
        f"{e0['hop_s']} s in them [{stamp}]")
    for r, x in enumerate(res):
        k5 = x["e"]["k5"]
        e_ok &= (k5["launches"] == k5["tc_launches"] == 2 * 27
                 and k5["k2"] > 0)
        log(f"train-tp: rank {r}: (d) walls {x['d']['walls']} s, in the "
            f"collectives {x['d']['coll_s']} s, peak "
            f"{x['d']['peak_gib']:.2f} GiB; (e) walls {x['e']['walls']} s, "
            f"in the collectives {x['e']['coll_s']} s, peak "
            f"{x['e']['peak_gib']:.2f} GiB, K5 {k5['launches']} launches "
            f"({k5['tc_launches']} on the tensor-core tile), K2 {k5['k2']} "
            f"(two ranks sharing one card over gloo: not a speed) [{stamp}]")
    return d_ok, e_ok


def run_ranks(flag: str, out_dir: str, world: int, timeout_s: float = 900,
              extra=()):
    """Start ``world`` ranks (this script with ``flag R --tp-port P`` and
    ``extra``), each logging to ``out_dir``, and wait for them; their exit
    codes. A rank that outlives ``timeout_s``, or that exits non-zero
    while the other still runs, ends every rank."""
    port = _free_port()
    procs = []
    for r in range(world):
        out = open(os.path.join(out_dir, f"rank{r}.log"), "w")
        procs.append((out, subprocess.Popen(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"), flag,
             str(r), "--tp-port", str(port), *extra],
            stdout=out, stderr=subprocess.STDOUT)))
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        codes = [p.poll() for _, p in procs]
        if all(c is not None for c in codes) or any(
                c not in (None, 0) for c in codes):
            break
        time.sleep(0.5)
    rcs = []
    for out, p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
            rcs.append("killed")
        else:
            rcs.append(p.returncode)
        out.close()
    return rcs


def _replicated_digest(state) -> str:
    """A digest of a LoRA state's leaves that the ranks replicate: those
    the model axis does not split, those outside a pipeline stage's
    ``layers``, every leaf without a layout (the sp ring)."""
    import hashlib

    from cogstream_tpu_torch.models.lora import iter_leaves

    specs = getattr(state.layout, "specs", None)
    h = hashlib.sha256()
    for path, t in iter_leaves(state.lora):
        if (state.layout is None
                or (specs is None and not path.startswith("layers."))
                or (specs is not None and specs[path].index is None)):
            h.update(path.encode())
            h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def train_rank_main(rank: int, port: int, dev=None, fault=False,
                    pp_fault=False, w8a8_fault=False) -> int:
    """One rank of phase 12 (``chip_smoke.py --train-rank R --tp-port
    P``): joins the gloo group on this card, runs (a), (d), (e) on the
    whole model, then (b), (c) on its shards, and writes ``rank<R>.json``
    under TRAIN_TP_DIR (rank 0 writes the adapter files and the gathered
    first-step gradients of (b)-(f) and the int8 turn), then (f) after
    (c). ``fault`` (``--train-tp-fault``) plants :class:`NoAttnCopy`,
    ``pp_fault`` (``--train-pp-fault``) :class:`ZeroBackHop`,
    ``w8a8_fault`` (``--train-w8a8-fault``) :class:`W8A8LocalAbsmax` in
    (f)."""
    import torch

    from cogstream_tpu_torch import presets
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params
    from cogstream_tpu_torch.ops import flash_attention as fa
    from cogstream_tpu_torch.ops import int8_gemv, kernels
    from cogstream_tpu_torch.ops import quant
    from cogstream_tpu_torch.ops.layernorm import layernorm
    from cogstream_tpu_torch.ops.quant import quantize_cogreasoner_
    from cogstream_tpu_torch.parallel.distributed import initialize_if_needed
    from cogstream_tpu_torch.parallel.mesh import (COLLECTIVE_BYTES,
                                                   COLLECTIVES, make_mesh)
    from cogstream_tpu_torch.parallel.sharding import shard_cogreasoner
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.train import stage1, stage2

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dev or torch.device("cuda", 0)
    kernels.library()                      # built by the parent: loads
    initialize_if_needed(f"tcp://127.0.0.1:{port}", TRAIN_TP_WORLD, rank,
                         backend="gloo", timeout_s=900)
    cfg = presets.cogreasoner_7b()
    tok = ByteTokenizer(image_token_id=cfg.image_token_index,
                        vocab=cfg.text.vocab_size)
    samples, turn, text_turn = train_tp_inputs(cfg, tok)
    out = {}
    spy = StepSpy(stage1, stage2)
    zero_hop = ZeroBackHop(spy, rank) if pp_fault else None

    def record(case, state, **extra):
        steps = spy.take()
        out[case] = {"collectives": sorted({n for n, *_ in steps}),
                     "walls": [w for _, w, _, _ in steps],
                     "coll_s": [c for _, _, c, _ in steps],
                     "losses": [x for *_, x in steps],
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "replicated": _replicated_digest(state), **extra}
        torch.cuda.reset_peak_memory_stats()

    def save_grads(case, state):
        whole = _whole_grads(state, spy.take_grads())
        if rank == 0:
            torch.save(whole, os.path.join(TRAIN_TP_DIR, f"grads_{case}.pt"))

    # (a) two whole replicas, the batch split on data
    model = init_cogreasoner_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.reset_peak_memory_stats()
    st = stage1.train_stage1(
        model.text, cfg, tok, samples, os.path.join(TRAIN_TP_DIR, "a"),
        stage1.Stage1Config(**TRAIN_TP_S1, data_parallel=2), resume=False,
        log=lambda *a: None, lora_cfg=train_tp_lora_cfg(),
        lora=train_tp_lora(cfg, dev, 1))
    spy.take_grads()
    record("a", st, steps=st.step)
    log(f"(a) steps {st.step} losses {out['a']['losses']} walls "
        f"{out['a']['walls']}")
    del st

    def hops_of(case):
        """(d) / (e)'s hops: the counters' deltas and each hop's wall."""
        hops = spy.take_hops()
        return {"hops": COLLECTIVES["ppermute"] - hops0[0],
                "hop_bytes": COLLECTIVE_BYTES["ppermute"] - hops0[1],
                "hop_walls": [[b, sh, round(dt, 5)] for b, sh, dt in hops],
                "hop_s": round(sum(dt for *_, dt in hops), 4)}

    # (d) GPipe on (data 1, pipe 2): a view of this stage's 14 layers; the
    # other stage's wait on the host meanwhile (this process keeps the
    # whole model for (e) and (b), a stage needs only its own layers)
    n_stage = cfg.text.num_hidden_layers // TRAIN_PP_STAGES
    others = [layer for i, layer in enumerate(model.text.layers)
              if i // n_stage != rank]
    for layer in others:
        layer.to("cpu")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hops0 = (COLLECTIVES["ppermute"], COLLECTIVE_BYTES["ppermute"])
    spy.take_hops()
    if zero_hop:
        zero_hop.arm()
    st = stage1.train_stage1(
        model.text, cfg, tok, samples, os.path.join(TRAIN_TP_DIR, "d"),
        stage1.Stage1Config(**TRAIN_TP_S1, pipeline_stages=TRAIN_PP_STAGES,
                            pipeline_microbatches=TRAIN_PP_M),
        resume=False, log=lambda *a: None, lora_cfg=train_tp_lora_cfg(),
        lora=train_tp_lora(cfg, dev, 1))
    save_grads("d", st)
    record("d", st, steps=st.step, layers=len(st.lora["layers"]),
           route=torch.distributed.get_backend(st.layout.group),
           **hops_of("d"))
    log(f"(d) steps {st.step} losses {out['d']['losses']} walls "
        f"{out['d']['walls']} hops {out['d']['hops']} "
        f"({out['d']['hop_bytes']} bytes, {out['d']['hop_s']} s)")
    del st
    for layer in others:
        layer.to(dev)
    torch.cuda.reset_peak_memory_stats()

    # (e) the ring: two stage-2 micro-steps with sequence_parallel=2, the
    # tower replicated on each rank (K5, K2)
    k5 = fa.segment_flash_attention
    k5.launches = k5.tc_launches = layernorm.launches = 0
    hops0 = (COLLECTIVES["ppermute"], COLLECTIVE_BYTES["ppermute"])
    spy.take_hops()
    if zero_hop:
        zero_hop.arm()
    losses, walls, tr = train_tp_stage2(
        model, cfg, tok, os.path.join(TRAIN_TP_DIR, "e"), [turn, turn], dev,
        sp=2)
    k5_e = {"launches": k5.launches, "tc_launches": k5.tc_launches,
            "k2": layernorm.launches}
    tr.finish()
    save_grads("e", tr.state)
    record("e", tr.state, k5=k5_e, **hops_of("e"))
    log(f"(e) losses {losses} walls {walls} hops {out['e']['hops']} "
        f"({out['e']['hop_bytes']} bytes, {out['e']['hop_s']} s) K5 / K2 "
        f"{k5_e}")
    del tr

    # (b) the decoder and its LoRA on model-axis shards
    mesh = make_mesh(1, 2)
    sharded = shard_cogreasoner(model, cfg, mesh)
    if fault:
        NoAttnCopy(sharded.text)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    st = stage1.train_stage1(
        sharded.text, cfg, tok, samples, os.path.join(TRAIN_TP_DIR, "b"),
        stage1.Stage1Config(**TRAIN_TP_S1, model_parallel=2), resume=False,
        log=lambda *a: None, lora_cfg=train_tp_lora_cfg(),
        lora=train_tp_lora(cfg, dev, 1))
    save_grads("b", st)
    record("b", st, steps=st.step)
    log(f"(b) steps {st.step} losses {out['b']['losses']} walls "
        f"{out['b']['walls']}")
    del st

    # (c) stage 2 on the shards: the tower on 8 heads a rank (K5), then
    # the 64-token turn on an int8 copy (K10 on column and row shards)
    k5 = fa.segment_flash_attention
    k5.launches = k5.tc_launches = 0
    losses, walls, tr = train_tp_stage2(
        sharded, cfg, tok, os.path.join(TRAIN_TP_DIR, "c"), [turn, turn],
        dev, mesh_tp=2)
    k5_counts = {"launches": k5.launches, "tc_launches": k5.tc_launches}
    tr.finish()
    save_grads("c", tr.state)
    state = tr.state
    del tr
    c_steps = spy.take()
    q = quantize_cogreasoner_(shared_copy(sharded), 8)
    int8_gemv.gemv_k10.launches = 0
    int8_losses, int8_walls, tr8 = train_tp_stage2(
        q, cfg, tok, os.path.join(TRAIN_TP_DIR, "c_int8"), [text_turn], dev,
        mesh_tp=2)
    k10 = int8_gemv.gemv_k10.launches
    save_grads("c_int8", tr8.state)
    del tr8
    int8_steps, spy.steps = spy.take(), c_steps
    record("c", state, int8_losses=int8_losses, int8_walls=int8_walls,
           int8_coll_s=[c for _, _, c, _ in int8_steps],
           int8_collectives=[n for n, *_ in int8_steps], k5=k5_counts,
           k10=k10, tower_heads=len(sharded.vision.tp.heads))
    log(f"(c) losses {losses} walls {walls} int8 {int8_losses} walls "
        f"{int8_walls} K5 {k5_counts} K10 {k10}")

    # (f) the same turn with w8a8_prefill (--w8a8-forward) on the int8
    # shards, then the exact row-shard products
    planted = W8A8LocalAbsmax() if w8a8_fault else None
    w8_calls = quant.int8_mm.calls.get("decoder", 0)
    w8_losses, w8_walls, trw = train_tp_stage2(
        q, w8a8_cfg(cfg), tok, os.path.join(TRAIN_TP_DIR, "c_w8a8"),
        [text_turn], dev, mesh_tp=2)
    w8_calls = quant.int8_mm.calls.get("decoder", 0) - w8_calls
    save_grads("c_w8a8", trw.state)
    record("f", trw.state, int8_mm=w8_calls,
           exact=w8a8_row_shard_exact(mesh, dev))
    if planted:
        planted.restore()
    log(f"(f) losses {w8_losses} walls {w8_walls} W8A8 products {w8_calls}"
        f" exact {out['f']['exact']}")
    del trw, q
    out["collective_kinds"] = sorted(COLLECTIVES)
    with open(os.path.join(TRAIN_TP_DIR, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


def run_train_tp_alone(dev, card, fault, pp_fault=False,
                       w8a8_fault=False) -> int:
    """``--train-tp-only``: phase 12 on phase 5's model (random weights
    from seed 0), without the other phases; prints its metrics."""
    import torch

    from cogstream_tpu_torch import presets
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params

    model = init_cogreasoner_params(
        presets.cogreasoner_7b(), torch.Generator(device=dev).manual_seed(0),
        device=dev)
    metrics = run_train_tp_path(model, dev, card, fault, pp_fault,
                                w8a8_fault)
    log("metrics: " + json.dumps(metrics))
    return 0


def run_tp_alone(dev, card, fault, w4a8_fault) -> int:
    """``--tp-only``: phase 11 on phase 5's model (random weights from
    seed 0), without the other phases; prints its metrics."""
    import torch

    from cogstream_tpu_torch import presets
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params

    model = init_cogreasoner_params(
        presets.cogreasoner_7b(), torch.Generator(device=dev).manual_seed(0),
        device=dev)
    metrics = run_tp_path(model, dev, card, fault, w4a8_fault)
    log("metrics: " + json.dumps(metrics))
    return 0


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, profile one more ingest and "
                         "two asks, and one more step of each training "
                         "stage and QLoRA scheme, with torch.profiler")
    ap.add_argument("--tp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # phase 11's rank processes
    ap.add_argument("--tp-port", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--train-rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # phase 12's rank processes
    ap.add_argument("--tp-only", action="store_true",
                    help="build the kernels and run phase 11 (tensor-"
                         "parallel serving, snapshots and adapters) alone")
    ap.add_argument("--tp-snapshot-fault", action="store_true",
                    help="with --tp-only: plant faults in the ranks (rank "
                         "0's kv heads written in every rank's place, the "
                         "adapters left whole); phase 11 must then fail")
    ap.add_argument("--tp-w4a8-fault", action="store_true",
                    help="with --tp-only: phase 11 (c)'s W4A8 shards quantize "
                         "their row-parallel halves at each rank's own "
                         "scales; phase 11 must then fail")
    ap.add_argument("--tp-dp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # phase 11 (f)'s rank processes
    ap.add_argument("--train-tp-only", action="store_true",
                    help="build the kernels and run phase 12 (data- and "
                         "tensor-parallel training) alone")
    ap.add_argument("--train-tp-fault", action="store_true",
                    help="with --train-tp-only: plant a fault in the ranks "
                         "(no copy_to_model on the decoder's attention "
                         "input); phase 12 must then fail")
    ap.add_argument("--train-pp-fault", action="store_true",
                    help="with --train-tp-only: rank 1 sends zeros in one "
                         "backward ppermute hop of (d) and of (e); phase 12 "
                         "must then fail")
    ap.add_argument("--train-w8a8-fault", action="store_true",
                    help="with --train-tp-only: (f)'s W8A8 activations take "
                         "each rank's own absmax; phase 12 must then fail")
    args = ap.parse_args()
    # the smoke uses one card: show it only the first visible one, so the
    # device count it reports is the number of cards it ran on
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from cogstream_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: {torch.cuda.device_count()} cards visible, "
              "expected 1", file=sys.stderr)
        return 1
    if args.tp_rank is not None:
        return tp_rank_main(args.tp_rank, args.tp_port,
                            fault=args.tp_snapshot_fault,
                            w4a8_fault=args.tp_w4a8_fault)
    if args.tp_dp_rank is not None:
        return tp_dp_rank_main(args.tp_dp_rank, args.tp_port)
    if args.train_rank is not None:
        return train_rank_main(args.train_rank, args.tp_port,
                               fault=args.train_tp_fault,
                               pp_fault=args.train_pp_fault,
                               w8a8_fault=args.train_w8a8_fault)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", visible],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    log(f"device: {card}")

    t0 = time.perf_counter()
    kernels.library()
    log(f"build: kernels built and loaded in {time.perf_counter() - t0:.1f}s "
        f"(nvcc {kernels.last_build_seconds})")
    usage = ptxas_usage(kernels.last_build_log, TC_KERNELS)
    for name, use in usage.items():
        log(f"build: ptxas {name}: {use}")
    for name, use in lm_attention_usage(kernels.last_build_log).items():
        log(f"build: {name}: {use['smem']} bytes of shared memory a block "
            f"of {use['threads']} threads (16384-slot read), "
            f"{use['blocks_per_sm']} blocks per SM (registers "
            f"{use.get('registers')})")
    for name, use in f32_tile_usage(kernels.last_build_log).items():
        log(f"build: ptxas {name}: registers {use.get('registers')}, spill "
            f"bytes {use.get('spill_bytes')}, {use['smem']} bytes of shared "
            f"memory a block of {use['threads']} threads, "
            f"{use['blocks_per_sm']} blocks per SM")

    if args.train_tp_only:
        return run_train_tp_alone(dev, card, args.train_tp_fault,
                                  args.train_pp_fault, args.train_w8a8_fault)
    if args.tp_only:
        return run_tp_alone(dev, card, args.tp_snapshot_fault,
                            args.tp_w4a8_fault)
    walls = {}
    t_phase = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        walls[name] = round(now - t_phase[0], 1)
        t_phase[0] = now

    results, verify_ms, f32_results = check_kernels(dev)
    results += check_int4_kernels(dev)
    k10, w8a8_ms = check_int8_kernels(dev)
    results.append(k10)
    rows_ms = check_rows_kernels(dev)
    check_fp8_cast(dev)
    kv_results, kv_ms = check_kv_dtype_kernels(dev)
    fp8_rows_ms = check_fp8_pool_kernels(dev)
    mark("3 kernels")
    # the f32-query routes (CUDA-core tiles) of K1, K3, K4 and K5: launched
    # by phase 4's f32 sessions and training alone
    f32_routes = {f"K{i + 1}": (lambda w: w.launches - w.tc_launches)(
        wrapper(i)) for i in (0, 2, 3, 4)}
    check_reference(dev)
    check_reference_int4(dev)
    check_reference_int8(dev)
    check_reference_pool(dev)
    check_reference_lookahead(dev)
    tiny_kv_launches = check_reference_fp8(dev)
    check_training_reference(dev)
    check_gemv_backward(dev)
    check_qlora_reference(dev)
    f32_routes = {k: (wrapper(int(k[1]) - 1).launches
                      - wrapper(int(k[1]) - 1).tc_launches - n)
                  for k, n in f32_routes.items()}
    log(f"reference: f32-query routes (CUDA-core tiles) launched in phase 4 "
        f"{f32_routes}")
    # the redesigned f32 routes of K1 and K3 (the f32 tile) run in phase 4
    # alone: their launches there
    for r in f32_results:
        r["launches"] = f32_routes[r["name"][:2]]
        if not r["launches"]:
            raise AssertionError(f"{r['name']} was not launched in phase 4")
    mark("4 reference")
    launches, metrics, sess = run_main_path(dev, card)
    kv_launches = {}
    for kv_name, tag, full in KV_SESSIONS:
        kv_launches[kv_name], kv_metrics = run_kv_session(
            sess, dev, card, kv_name, tag, full)
        metrics.update(kv_metrics)
    # the f32 route over a bf16 cache: the tiny f32 sessions of phase 4
    kv_launches["bfloat16"] = list(tiny_kv_launches["bfloat16"])
    metrics["kv_attention_ms"] = kv_ms
    metrics["fp8_rows_ms"] = fp8_rows_ms
    if args.profile:
        profile_phases(sess, card)
    model = sess.model
    metrics["verify_attention_ms"] = verify_ms
    metrics.update(run_lookahead_schedule(model.text, dev, card))
    del sess
    mark("5 main path")
    metrics.update(run_engine_path(model, dev, card))
    mark("8 engine")
    metrics.update(run_pool_path(model, dev, card,
                                 metrics["AC_decode_tok_per_s"]))
    metrics.update(run_fp8_pool(model, dev, card))
    metrics.update(run_http_path(model, dev, card))
    mark("9 pool")
    metrics.update(run_tp_path(model, dev, card))
    mark("11 tensor-parallel serving")
    metrics.update(run_train_tp_path(model, dev, card))
    mark("12 tensor-parallel training")
    metrics["rows_ms"] = rows_ms
    train_launches, train_metrics = run_training(model, dev, card,
                                                 args.profile)
    train_metrics.update(run_qlora(model, dev, card, train_metrics,
                                   args.profile))
    mark("7 training")
    int8_launches, int8_metrics = run_int8_path(model, dev, card)
    mark("10 int8")
    int4_launches, int4_metrics = run_int4_path(model, dev, card)
    mark("6 int4")
    kv_counts = [n for _, kv_name, *_ in KV_ROUTES
                 for n in kv_launches[kv_name]]
    for r, n in zip(results + kv_results,
                    launches + train_launches + int4_launches
                    + int8_launches + kv_counts, strict=True):
        r["launches"] = n
    results += kv_results + f32_results
    metrics["w8a8_gate_proj_4384_ms"] = w8a8_ms
    metrics.update(train_metrics)
    metrics.update(int8_metrics)
    metrics.update(int4_metrics)
    metrics["phase_walls_s"] = walls
    log(f"phase walls (s, after the build): {walls}; "
        f"{sum(walls.values()):.1f} in all [{card}]")
    log("metrics: " + json.dumps(metrics))
    print(json.dumps({"kernels": results}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
