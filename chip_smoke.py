#!/usr/bin/env python3
"""Run the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):

1. device — the card's name and power limit from nvidia-smi;
2. build  — nvcc builds the port's kernels (cogstream_tpu_torch/csrc);
3. kernels — each kernel (K1 vision attention, K2 LayerNorm, K3 prefill
   attention, K4 decode attention) against its plain PyTorch version on
   the card, in bf16, at the shapes the 7B serving path gives it, with
   both times;
4. reference — a tiny-config session (f32) runs ingest → ask(AC) →
   ingest → ask(FCC) on the card (kernels) and on the CPU (plain
   versions); greedy tokens, selections and slot ranges must agree;
5. main path — a 7B-width ``StreamingSession`` (cogreasoner_7b, bf16,
   random weights from a seeded generator, 16384-slot cache) ingests two
   16-frame segments (24x42 patch grids, merge 2, seeded uint8 patch
   rows) and answers ask(AC) and ask(FCC); every kernel's launch count
   must rise during this phase, every output must be finite and the slot
   ranges ordered and disjoint.

With ``--profile`` it then runs torch.profiler over one more ingest and
two asks on the same session and prints each phase's device busy share
and its kernels by device time.

It then prints the kernels JSON line, the card line, and last
``{"ok": true, "device": {...}}``. It runs on the first visible card
only. Without a CUDA device, or outside a checkout of the repository,
it exits non-zero and prints no result.
"""

from __future__ import annotations

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
]


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


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def check_kernels(dev):
    import torch

    from cogstream_tpu_torch.models.vision_encoder import build_vision_metadata
    from cogstream_tpu_torch.ops import flash_attention as fa
    from cogstream_tpu_torch.ops import layernorm as ln
    from cogstream_tpu_torch.ops import lm_attention as lma
    from cogstream_tpu_torch.ops.rope import (vision_rope_angles,
                                              vision_rope_cos_sin)

    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    results = []

    def record(idx, err, ratio, ms, plain_ms):
        name = KERNELS[idx][0]
        log(f"kernel {name}: max_abs_err={err:.6g}, worst row at {ratio:.3g}"
            f" of its bound (2 bf16 ulps of the row's max |ref|) "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
        if not ratio <= 1.0:
            raise AssertionError(f"{name} disagrees with its plain version")
        results.append({"name": name, "route": "cuda",
                        "source": KERNELS[idx][3],
                        "replaces": KERNELS[idx][4], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms})

    def dev_t(a, dtype=None):
        return torch.as_tensor(a).to(dev, dtype)

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
        log(f"kernel K1 case grids={grids}: N={N} max_abs_err={err:.6g}, "
            f"max |ref|={ref.float().abs().max().item():.4g}, worst row at "
            f"{ratio:.3g} of its bound")
        if len(k1_err) == 1:   # time the main path's 16x24x42 segment
            k1_ms = cuda_ms(lambda: fa.flash_attention_packed_rope_fusedqkv(
                *args, *ranges, H), 5)
            k1_plain_ms = cuda_ms(lambda: fa.flash_attention_packed_rope_plain(
                *args, H, 1 / math.sqrt(D)), 2)
    record(0, max(k1_err), max(k1_ratio), k1_ms, k1_plain_ms)

    # K2: the tower's LayerNorm at the encode bucket
    x = dev_t(rng.standard_normal((16384, 1152)) * 2 + 0.5, bf)
    sc = dev_t(rng.standard_normal(1152), torch.float32)
    b = dev_t(rng.standard_normal(1152), torch.float32)
    got = ln.layernorm(x, sc, b, 1e-6)
    ref = ln.layernorm_plain(x, sc, b, 1e-6)
    record(1, *row_check(got, ref, 1152),
           cuda_ms(lambda: ln.layernorm(x, sc, b, 1e-6), 20),
           cuda_ms(lambda: ln.layernorm_plain(x, sc, b, 1e-6), 5))

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
    record(2, *row_check(got, ref, Dl),
           cuda_ms(lambda: lma.prefill_flash_attention(q, k, v, qp, eff), 3),
           cuda_ms(lambda: lma.gqa_attention_plain(q, k, v, qp, eff), 1))

    # K4: one decode step over a 9216-slot window holding 9000 slots
    W, fill = 9216, 9000
    q1 = dev_t(rng.standard_normal((1, 1, Hq, Dl)), bf)
    pos = np.full((1, T), -1, np.int32)
    pos[0, :fill + 1] = np.arange(fill + 1)
    pos[0, rng.choice(fill, 300, replace=False)] = -1
    eff = lma.effective_kv_positions(dev_t(pos, torch.int32),
                                     dev_t(allowed, torch.bool))[:, :W]
    eff = eff.contiguous()
    qp = dev_t([[fill]], torch.int32)
    got = lma.decode_attention(q1, k, v, qp, eff)
    ref = lma.gqa_attention_plain(q1, k, v, qp, eff)
    record(3, *row_check(got, ref, Dl),
           cuda_ms(lambda: lma.decode_attention(q1, k, v, qp, eff), 50),
           cuda_ms(lambda: lma.gqa_attention_plain(q1, k, v, qp, eff), 5))
    return results


# ---------------------------------------------------------------------------
# phase 4: tiny session, kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------

def run_tiny_session(model, cfg, device):
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.runtime.session import StreamingSession

    tok = ByteTokenizer(image_token_id=cfg.image_token_index)
    sess = StreamingSession(model.to(device), cfg, tok, max_len=2048)
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
    cpu_model = init_cogreasoner_params(cfg, torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model)
    ref, ref_ranges, ref_sess = run_tiny_session(cpu_model, cfg, "cpu")
    got, got_ranges, got_sess = run_tiny_session(gpu_model, cfg, dev)
    err = (got_sess.cache.k.float().cpu() - ref_sess.cache.k).abs().max().item()
    log(f"reference: tiny session tokens {got} vs cpu {ref}; ranges equal "
        f"{got_ranges == ref_ranges}; cache k max_abs_err {err:.3g}")
    if got != ref or got_ranges != ref_ranges or not err <= 1e-4:
        raise AssertionError("tiny session on the card disagrees with the "
                             "plain versions on the CPU")


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
        self.encode_s = []
        fwd, enc = qwen2.qwen2_forward, sess_mod.encode_images

        def timed_forward(model, embeds, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fwd(model, embeds, *a, **k)
            torch.cuda.synchronize()
            self.forwards.append((embeds.shape[1], t0, time.perf_counter()))
            return out

        def timed_encode(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = enc(*a, **k)
            torch.cuda.synchronize()
            self.encode_s.append(time.perf_counter() - t0)
            return out

        qwen2.qwen2_forward = timed_forward
        sess_mod.encode_images = timed_encode
        self.restore = lambda: (setattr(qwen2, "qwen2_forward", fwd),
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
    rng = np.random.default_rng(0)
    t, gh, gw, ms = 16, 24, 42, 2
    segments = [rng.integers(0, 256, (t * gh * gw, 3 * 14 * 14),
                             dtype=np.uint8) for _ in range(2)]

    for i in range(len(KERNELS)):          # count the main path only
        wrapper(i).launches = 0
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
            f"decode {dec:.1f} tok/s [{stamp}]")
        toks = r["tokens"]
        if not (toks and all(0 <= x < cfg.text.vocab_size for x in toks)):
            raise AssertionError(f"bad answer tokens {toks}")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    launches = [wrapper(i).launches for i in range(len(KERNELS))]
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
    log(f"main: {main_s:.1f}s for 2 ingests + 2 asks; launches "
        f"{dict(zip([k[0] for k in KERNELS], launches))}; cache {wi} slots; "
        f"{len(sess.events)} events; finite {finite}; ranges ordered and "
        f"disjoint {ordered}; peak {torch.cuda.max_memory_allocated() / 2**30:.1f}"
        f" GiB [{stamp}]")
    if not finite or not ordered or min(launches) == 0 \
            or len(sess.events) != 2:
        raise AssertionError("main path check failed")
    return launches, metrics, sess


def profile_phases(sess, stamp):
    """``--profile``: torch.profiler over one more ingest, an FCC ask and
    an AC ask on the main path's session. Prints each phase's wall time,
    its summed device kernel time and busy share (one stream, so kernels
    never overlap), and its kernels by device time. The profiler adds
    host time, so these walls exceed the unprofiled ones."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    ]
    for name, fn in phases:
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


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, profile one more ingest and "
                         "two asks with torch.profiler")
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

    results = check_kernels(dev)
    check_reference(dev)
    launches, metrics, sess = run_main_path(dev, card)
    for r, n in zip(results, launches):
        r["launches"] = n
    log("metrics: " + json.dumps(metrics))
    if args.profile:
        profile_phases(sess, card)
    print(json.dumps({"kernels": results}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
