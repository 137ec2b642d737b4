#!/usr/bin/env python3
"""Time the PyTorch port's attention kernels in two checkouts on one card.

    python3 tools/torch_kernel_ab.py OTHER_CHECKOUT [--rounds 2]

Runs OTHER, this checkout, this checkout, OTHER (``--rounds`` times),
each in its own process (both packages are named ``cogstream_tpu_torch``),
and prints one JSON line per run and a summary: the device ms of K1
(``flash_attention_packed_rope_fusedqkv``, bf16, one 16-frame 24x42
segment bucketed to 16384 rows, 16 heads of 72), of K5
(``segment_flash_attention``, bf16 [16128, 16, 72], 16 frames of 1008)
and of K3 (``prefill_flash_attention``, a 4384-token prefill over 4607
history slots of a 16384-slot cache), each the mean of 20 launches
between CUDA events, best of 3; and of K4 (``decode_attention``, one
step over a 9216-slot window holding 9000), 50 calls captured in a CUDA
graph, best of 3 replays. K3 and K4 run over a bf16 cache and, in a
checkout that has the fp8 KV cache, over the same values in e4m3. Each
checkout builds its own kernels into its own ``build/kernels``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_one(root: str) -> dict:
    """K1 and K5 device ms of the package under ``root``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from cogstream_tpu_torch.models.vision_encoder import build_vision_metadata
    from cogstream_tpu_torch.ops import flash_attention as fa
    from cogstream_tpu_torch.ops import kernels
    from cogstream_tpu_torch.ops.rope import (vision_rope_angles,
                                              vision_rope_cos_sin)

    assert fa.__file__.startswith(os.path.abspath(root)), fa.__file__
    kernels.library()
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    rng = np.random.default_rng(0)

    def ms(fn):
        fn()
        best = float("inf")
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(20):
                fn()
            b.record()
            torch.cuda.synchronize()
            best = min(best, a.elapsed_time(b) / 20)
        return best

    H, D = 16, 72
    meta = build_vision_metadata(np.array([[16, 24, 42]]), np.array([2]),
                                 pad_to=16384)
    N = meta.segment_ids.shape[0]
    qkv = torch.as_tensor(rng.standard_normal((N, 3 * H * D))).to(dev, bf)
    c2, s2 = vision_rope_cos_sin(vision_rope_angles(
        torch.as_tensor(meta.pos_ids).to(dev, torch.int32), D))
    args = (qkv, c2[:, 0].contiguous(), s2[:, 0].contiguous(),
            torch.as_tensor(meta.segment_ids).to(dev, torch.int32),
            torch.as_tensor(meta.kv_lo).to(dev, torch.int32),
            torch.as_tensor(meta.kv_hi).to(dev, torch.int32))
    k1 = ms(lambda: fa.flash_attention_packed_rope_fusedqkv(*args, H))

    seg_np = np.repeat(np.arange(16, dtype=np.int32), 1008)
    seg = torch.as_tensor(seg_np).to(dev)
    q, k, v = (torch.as_tensor(rng.standard_normal((16128, H, D))).to(dev, bf)
               for _ in range(3))
    ranges = tuple(torch.as_tensor(r).to(dev)
                   for r in fa.vision_kv_ranges(seg_np))
    with torch.no_grad():
        k5 = ms(lambda: fa.segment_flash_attention(q, k, v, seg, ranges))
    out = {"root": root, "K1_ms": k1, "K5_ms": k5}
    out.update(time_lm_attention(rng, dev, ms))
    out["card"] = torch.cuda.get_device_name(0)
    return out


def time_lm_attention(rng, dev, ms) -> dict:
    """K3 and K4 device ms over a bf16 cache and, where the checkout has
    the fp8 KV cache, over the same values in e4m3."""
    import numpy as np
    import torch

    from cogstream_tpu_torch.ops import lm_attention as lma

    bf = torch.bfloat16

    def graph_ms(fn, n=50):
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                fn()
        best = float("inf")
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            g.replay()
            b.record()
            torch.cuda.synchronize()
            best = min(best, a.elapsed_time(b) / n)
        return best

    T, Hq, Hkv, D = 16384, 28, 4, 128
    k = torch.as_tensor(rng.standard_normal((1, T, Hkv, D))).to(dev, bf)
    v = torch.as_tensor(rng.standard_normal((1, T, Hkv, D))).to(dev, bf)
    caches = {"bf16": (k, v)}
    if hasattr(lma.decode_attention, "fp8_launches"):
        k8, v8 = k.to(torch.float8_e4m3fn), v.to(torch.float8_e4m3fn)
        caches = {"bf16": (k8.to(bf), v8.to(bf)), "e4m3": (k8, v8)}
    out = {}
    for S, hist, W in ((4384, 4607, T), (1, 9000, 9216)):
        pos = np.full((1, T), -1, np.int32)
        pos[0, :hist + S] = np.arange(hist + S)
        eff = lma.effective_kv_positions(
            torch.as_tensor(pos).to(dev))[:, :W].contiguous()
        q = torch.as_tensor(rng.standard_normal((1, S, Hq, D))).to(dev, bf)
        qp = torch.arange(hist, hist + S, dtype=torch.int32,
                          device=dev)[None]
        for name, (kc, vc) in caches.items():
            if S == 1:
                out[f"K4_{name}_ms"] = graph_ms(
                    lambda: lma.decode_attention(q, kc, vc, qp, eff))
            else:
                out[f"K3_{name}_ms"] = ms(
                    lambda: lma.prefill_flash_attention(q, kc, vc, qp, eff))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="the other checkout (e.g. the parent "
                                  "commit unpacked with git archive)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--time-one", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.time_one:
        print(json.dumps(time_one(a.other)), flush=True)
        return 0
    other = os.path.abspath(a.other)
    runs = {"other": [], "this": []}
    for _ in range(a.rounds):
        for tag, root in (("other", other), ("this", HERE), ("this", HERE),
                          ("other", other)):
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                root, "--time-one"], capture_output=True,
                               text=True, cwd=root)
            if r.returncode != 0:
                print(r.stdout, r.stderr, file=sys.stderr)
                return r.returncode
            line = json.loads(r.stdout.strip().splitlines()[-1])
            print(json.dumps({"run": tag, **line}), flush=True)
            runs[tag].append(line)
    keys = [k for k in runs["this"][0] if k.endswith("_ms")
            and k in runs["other"][0]]
    summary = {f"{tag}_{key}": [x[key] for x in got]
               for tag, got in runs.items() for key in keys}
    best = {tag: min(x["K1_ms"] for x in got) for tag, got in runs.items()}
    summary["K1_this_over_other"] = best["this"] / best["other"]
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
