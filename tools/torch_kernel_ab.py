#!/usr/bin/env python3
"""Time the PyTorch port's attention kernels in two checkouts on one card.

    python3 tools/torch_kernel_ab.py OTHER_CHECKOUT [--rounds 2]
    python3 tools/torch_kernel_ab.py --plans

Runs OTHER, this checkout, this checkout, OTHER (``--rounds`` times),
each in its own process (both packages are named ``cogstream_tpu_torch``),
and prints one JSON line per run and a summary: the device ms of K1
(``flash_attention_packed_rope_fusedqkv``, bf16, one 16-frame 24x42
segment bucketed to 16384 rows, 16 heads of 72), of K5
(``segment_flash_attention``, bf16 [16128, 16, 72], 16 frames of 1008)
and of K3 (``prefill_flash_attention``, a 4384-token prefill over 4607
history slots of a 16384-slot cache; K3s1000 / K3s600, 1000 / 600
tokens over 8000; K3s40, a 40-token question over 9000), each the mean
of 20 launches
between CUDA events, best of 3; and of K4 (``decode_attention``, one
step over a 9216-slot window holding 9000; K4s8, a verify step of 8
queries), 50 calls captured in a CUDA graph, best of 3 replays. K3 and K4 run over a bf16 cache and, in a
checkout that has the fp8 KV cache, over the same values in e4m3; in a
checkout that has the other cache dtypes, also over those bf16 values in
e5m2 and over f32 normal draws in f16 and in f32, each beside the bf16
kernel over that cache rounded to bf16 (``bf16_of_f16``,
``bf16_of_f32``). Each output is hashed, and the summary says which agree
bit for bit between the checkouts and gives, in this checkout, each f16 /
f32 time over its rounded bf16 twin's (best against best). Each checkout
builds its own kernels into its own ``build/kernels``.

Then the f32-query routes on f32 values (:func:`time_f32_routes`): K1
and K5 on those shapes in f32, K3 at phase 3's 4384-token prefill (with
position holes and kv_allowed) over an f32 cache and over the same values
in bf16, f16, e4m3 and e5m2, K3 at a 32-token question over a 9216-slot
window, K4 at one step over that window (a CUDA graph), each hashed; in a
checkout that picks K3's f32 rows a block, K3 f32 at the ingest and the
question with each block size pinned. The summary gives each f32 route's
time in this checkout over the other's and K3 f32's time over a bf16
cache over its time over the f32 cache.

Last, one JSON line names the kernels whose SASS is the same in both
checkouts' libraries and those whose SASS differs (``cuobjdump -sass``,
encodings and label numbers dropped).

``--plans`` times K4 in this checkout alone, CUDA graphs of 50 calls in
alternating rounds, at the serving shapes its launch plan must cover: a
9216-slot window holding 9000 (S = 1, 5, 8), a 4-row pool ([4, 16384]
cache, rows [3, 1, 0, 2] holding 9000 / 4000 / 12000 / 16000, S = 1), a
1024-slot window holding 1000 (S = 1, 5, 8) and a tensor-parallel shard
(14 query heads over 2 kv heads, the 9216-slot window, S = 1): bf16 on
its plan, e4m3 (the same values) on ``decode_plan``'s e4m3 plan, and e4m3
on the bf16 plan (no rounding of the split to whole tiles for every
warp); then, over f32 normal draws in f16 and in f32, each instance and
split of ``K4_CANDIDATES`` (``tools/k4_instance_probe.cu``, built with
nvcc into ``build/k4_instance_probe/``, ptxas's figures printed) and the
port's own plan, beside the bf16 kernel over that cache rounded to bf16,
with each output's differing elements and its largest difference in
bf16 ulps of the element and of its row's max against that kernel's.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
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
    out.update(time_f32_routes(dev, ms, args, q, k, v, seg, ranges))
    out["card"] = torch.cuda.get_device_name(0)
    return out


def sha(t) -> str:
    """Hash of a tensor's bytes (f32 or bf16)."""
    import torch

    return hashlib.sha1(t.contiguous().view(torch.int16).cpu().numpy()
                        .tobytes()).hexdigest()


def time_f32_routes(dev, ms, k1_args, q, k, v, seg, ranges) -> dict:
    """The f32-query routes on f32 values: K1 (the 16-frame segment of
    time_one in f32), K5 (its [16128, 16, 72] operands in f32), K3 (a
    4384-token prefill over 4607 history slots with 300 position holes
    and a 70% kv_allowed, phase 3's case; then over the same values in a
    bf16, f16, e4m3 and e5m2 cache; and a 32-token question over a
    9216-slot window holding 9000), K4 (one step over that window, 50
    calls in a CUDA graph). Where the checkout picks K3's f32 rows a block
    (``prefill_f32_rows``), also K3 f32 at the ingest and the question
    with each block size pinned."""
    import numpy as np
    import torch

    from cogstream_tpu_torch.ops import flash_attention as fa
    from cogstream_tpu_torch.ops import lm_attention as lma

    rng = np.random.default_rng(7)
    out = {}
    f32 = torch.float32
    H = 16
    qkv32 = k1_args[0].float()
    runs = {"K1f32": lambda: fa.flash_attention_packed_rope_fusedqkv(
        qkv32, *k1_args[1:], H)}
    q5, k5, v5 = q.float(), k.float(), v.float()
    runs["K5f32"] = lambda: fa.segment_flash_attention(q5, k5, v5, seg,
                                                       ranges)
    T, Hq, Hkv, D = 16384, 28, 4, 128

    def case(S, hist, W=T):
        pos = np.full((1, T), -1, np.int32)
        pos[0, :hist + S] = np.arange(hist + S)
        pos[0, rng.choice(hist, 300, replace=False)] = -1
        allowed = rng.random((1, T)) > 0.3
        allowed[0, hist:] = True
        eff = lma.effective_kv_positions(
            torch.as_tensor(pos).to(dev),
            torch.as_tensor(allowed).to(dev))[:, :W].contiguous()
        qq = torch.as_tensor(rng.standard_normal((1, S, Hq, D)),
                             dtype=f32).to(dev)
        qp = torch.arange(hist, hist + S, dtype=torch.int32,
                          device=dev)[None]
        return qq, qp, eff

    kc = torch.as_tensor(rng.standard_normal((1, T, Hkv, D)),
                         dtype=f32).to(dev)
    vc = torch.as_tensor(rng.standard_normal((1, T, Hkv, D)),
                         dtype=f32).to(dev)
    ingest, question, step = case(4384, 4607), case(32, 9000, 9216), case(
        1, 9000, 9216)
    pf = lma.prefill_flash_attention
    runs["K3f32"] = lambda: pf(ingest[0], kc, vc, *ingest[1:])
    for name, dt in (("bf16", torch.bfloat16), ("f16", torch.float16),
                     ("e4m3", torch.float8_e4m3fn),
                     ("e5m2", torch.float8_e5m2)):
        kn, vn = kc.to(dt), vc.to(dt)
        runs[f"K3f32_{name}kv"] = (lambda kn=kn, vn=vn: pf(
            ingest[0], kn, vn, *ingest[1:]))
    runs["K3f32s32"] = lambda: pf(question[0], kc, vc, *question[1:])
    with torch.no_grad():
        for name, fn in runs.items():
            out[f"{name}_sha"] = sha(fn())
            out[f"{name}_ms"] = ms(fn)
    out["K4f32_sha"] = sha(lma.decode_attention(step[0], kc, vc, *step[1:]))
    g = torch.cuda.CUDAGraph()
    lma.decode_attention(step[0], kc, vc, *step[1:])
    torch.cuda.synchronize()
    with torch.cuda.graph(g):
        for _ in range(50):
            lma.decode_attention(step[0], kc, vc, *step[1:])
    best = float("inf")
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / 50)
    out["K4f32_ms"] = best
    plan = getattr(lma, "prefill_f32_rows", None)
    if plan is not None:   # each block size pinned
        try:
            for rows in lma.PREFILL_F32_ROWS:
                lma.prefill_f32_rows = lambda *a, rows=rows: rows
                out[f"K3f32_rows{rows}_ms"] = ms(runs["K3f32"])
                out[f"K3f32s32_rows{rows}_ms"] = ms(runs["K3f32s32"])
        finally:
            lma.prefill_f32_rows = plan
    return out


def time_lm_attention(rng, dev, ms) -> dict:
    """K3 and K4 device ms over a bf16 cache and, where the checkout has
    them, over the same values in e4m3 and e5m2 and over f32 draws in f16
    and f32 beside those rounded to bf16."""
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
    if hasattr(lma.decode_attention, "kv_launches"):
        e5 = torch.float8_e5m2
        caches["e5m2"] = (caches["bf16"][0].to(e5), caches["bf16"][1].to(e5))
        kf = torch.as_tensor(rng.standard_normal((1, T, Hkv, D)),
                             dtype=torch.float32).to(dev)
        vf = torch.as_tensor(rng.standard_normal((1, T, Hkv, D)),
                             dtype=torch.float32).to(dev)
        for name, dt in (("f16", torch.float16), ("f32", torch.float32)):
            caches[name] = (kf.to(dt), vf.to(dt))
            caches[f"bf16_of_{name}"] = (kf.to(dt).to(bf), vf.to(dt).to(bf))
    out = {}
    for kernel, S, hist, W in (("K3", 4384, 4607, T),
                               ("K3s1000", 1000, 8000, T),
                               ("K3s600", 600, 8000, T),
                               ("K3s40", 40, 9000, T), ("K4", 1, 9000, 9216),
                               ("K4s8", 8, 9000, 9216)):
        pos = np.full((1, T), -1, np.int32)
        pos[0, :hist + S] = np.arange(hist + S)
        eff = lma.effective_kv_positions(
            torch.as_tensor(pos).to(dev))[:, :W].contiguous()
        q = torch.as_tensor(rng.standard_normal((1, S, Hq, D))).to(dev, bf)
        qp = torch.arange(hist, hist + S, dtype=torch.int32,
                          device=dev)[None]
        for name, (kc, vc) in caches.items():
            k4 = kernel.startswith("K4")
            fn = lma.decode_attention if k4 else lma.prefill_flash_attention
            got = fn(q, kc, vc, qp, eff)
            out[f"{kernel}_{name}_sha"] = hashlib.sha1(
                got.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
            timer = graph_ms if k4 else ms
            out[f"{kernel}_{name}_ms"] = timer(
                lambda: fn(q, kc, vc, qp, eff))
    return out


# K4 candidates over an f16 and an f32 cache (tools/k4_instance_probe.cu):
# label -> (csrc DType code, warps a block, split); split "bf16" is
# decode_plan's bf16 split, "whole" that split rounded up to whole tiles
# for every warp
K4_CANDIDATES = {
    "f16 4 warps": (4, 4, "bf16"),
    "f16 4 warps, whole tiles": (4, 4, "whole"),
    "f16 5 warps": (4, 5, "bf16"),
    "f16 5 warps, whole tiles": (4, 5, "whole"),
    "f16 6 warps, whole tiles": (4, 6, "whole"),
    "f32 3 warps": (0, 3, "bf16"),
    "f32 3 warps, whole tiles": (0, 3, "whole"),
    "f32 2 warps": (0, 2, "bf16"),
    "f32 2 warps, whole tiles": (0, 2, "whole"),
}


def build_k4_probe():
    """tools/k4_instance_probe.cu built with nvcc into
    build/k4_instance_probe/ and loaded; prints ptxas's figures."""
    import ctypes

    out_dir = os.path.join(HERE, "build", "k4_instance_probe")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libk4probe.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    r = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared",
         "-I", os.path.join(HERE, "cogstream_tpu_torch", "csrc"),
         os.path.join(HERE, "tools", "k4_instance_probe.cu"), "-o", lib],
        capture_output=True, text=True)
    if r.returncode != 0:
        sys.exit(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    for line in (r.stdout + r.stderr).splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas:", line.strip(), flush=True)
    so = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    so.k4_instance.argtypes = [I] * 3 + [P] * 10 + [I] * 8 + [
        ctypes.c_float, P]
    so.k4_instance.restype = I
    return so


def plan_sweep(rounds: int) -> int:
    """K4 over e4m3 on its own plan and on bf16's, and over f16 and f32 on
    each of K4_CANDIDATES and on the port's plan, beside bf16 on the same
    values (see the module's docstring); one JSON line per shape."""
    import numpy as np
    import torch

    from cogstream_tpu_torch.ops import kernels
    from cogstream_tpu_torch.ops import lm_attention as lma

    dev = torch.device("cuda", 0)
    bf, f8 = torch.bfloat16, torch.float8_e4m3fn
    rng = np.random.default_rng(3)
    plan = lma.decode_plan
    probe = build_k4_probe()
    kernels.library()
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()

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

    def bf16_plan(*args):           # the split without e4m3's rounding
        return plan(*args[:6])

    def one_ulp(got, want):
        """(elements differing, the largest difference in bf16 ulps of the
        larger of the two elements, and in ulps of the row's max |want|: a
        row is one head of one query)"""
        g, w = got.float(), want.float()
        mag = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        diff = (g - w).abs().reshape(-1, D)
        row = w.abs().reshape(-1, D).amax(1).clamp_min(1e-30)
        row_ulp = torch.exp2(torch.floor(torch.log2(row)) - 7)
        return (int((g != w).sum().item()),
                ((g - w).abs() / ulp).max().item(),
                (diff.amax(1) / row_ulp).max().item())

    D, T = 128, 16384
    # label, S, query heads, kv heads, window, fill of each input row,
    # cache rows (None: input row b reads cache row b)
    shapes = [(f"window 9216 S={s}", s, 28, 4, 9216, [9000], None)
              for s in (1, 5, 8)]
    shapes += [("pool of 4 S=1", 1, 28, 4, T, [9000, 4000, 12000, 16000],
                [3, 1, 0, 2])]
    shapes += [(f"window 1024 S={s}", s, 28, 4, 1024, [1000], None)
               for s in (1, 5, 8)]
    shapes += [("tp shard 14 / 2 heads S=1", 1, 14, 2, 9216, [9000], None)]
    for label, S, Hq, Hkv, W, fills, rows in shapes:
        B = len(fills)
        k16 = torch.as_tensor(rng.standard_normal((B, T, Hkv, D))).to(dev, bf)
        v16 = torch.as_tensor(rng.standard_normal((B, T, Hkv, D))).to(dev, bf)
        k8, v8 = k16.to(f8), v16.to(f8)
        k16, v16 = k8.to(bf), v8.to(bf)
        kf = torch.as_tensor(rng.standard_normal((B, T, Hkv, D)),
                             dtype=torch.float32).to(dev)
        vf = torch.as_tensor(rng.standard_normal((B, T, Hkv, D)),
                             dtype=torch.float32).to(dev)
        wide = {"f16": (kf.half(), vf.half()), "f32": (kf, vf)}
        twins = {n: (kc.to(bf), vc.to(bf)) for n, (kc, vc) in wide.items()}
        del kf, vf
        pos = np.full((B, T), -1, np.int32)
        for b, n in enumerate(fills):
            pos[rows[b] if rows else b, :n] = np.arange(n)
        order = rows if rows else list(range(B))
        eff = lma.effective_kv_positions(
            torch.as_tensor(pos[order]).to(dev))[:, :W].contiguous()
        q = torch.as_tensor(rng.standard_normal((B, S, Hq, D))).to(dev, bf)
        qp = torch.as_tensor(np.array(fills)[:, None] - S +
                             np.arange(S)).to(dev, torch.int32)
        rr = lma.cache_rows(rows, dev) if rows else None
        R = S * (Hq // Hkv)
        mt, groups, per_bf16, _ = plan(B, Hkv, R, D, W, 132)
        n_tiles = -(-W // 64)

        def call(k, v):
            return lambda: lma.decode_attention(q, k, v, qp, eff, rows=rr)

        outs = {}

        def candidate(name):
            code, nw, rule = K4_CANDIDATES[name]
            kc, vc = wide["f16" if code == 4 else "f32"]
            per = per_bf16 if rule == "bf16" else -(-per_bf16 // nw) * nw
            n_splits = -(-n_tiles // per)
            n_part = B * Hkv * groups * n_splits * 16 * mt
            part = torch.empty(n_part * (2 + D), dtype=torch.float32,
                               device=dev)
            tickets = torch.zeros(B * Hkv * groups, dtype=torch.int32,
                                  device=dev)
            out = outs[name] = torch.empty_like(q)
            ml = part.data_ptr()

            def fn():
                rc = probe.k4_instance(
                    code, mt, nw, q.data_ptr(), kc.data_ptr(),
                    vc.data_ptr(), qp.data_ptr(), eff.data_ptr(),
                    None if rr is None else rr.dev.data_ptr(), ml,
                    ml + n_part * 2 * 4, tickets.data_ptr(), out.data_ptr(),
                    B, S, Hq, Hkv, T, W, per, n_splits, 1.0 / math.sqrt(D),
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            return fn, (part, tickets), (nw, per, n_splits)

        fns, keep, plans = {}, [], {}
        for name in K4_CANDIDATES:
            fn, ws, plans[name] = candidate(name)
            fns[name] = fn
            keep.append(ws)
        fns["bf16"] = call(k16, v16)
        fns["e4m3"] = call(k8, v8)
        fns["e4m3 on the bf16 plan"] = "bf16 plan"
        for n in ("f16", "f32"):
            fns[f"port {n}"] = call(*wide[n])
            fns[f"bf16 of {n}"] = call(*twins[n])
        runs = {name: [] for name in fns}
        for _ in range(rounds):
            for name in list(runs) + list(reversed(list(runs))):
                fn = fns[name]
                if fn == "bf16 plan":
                    lma.decode_plan = bf16_plan
                    fn = call(k8, v8)
                try:
                    runs[name].append(graph_ms(fn))
                finally:
                    lma.decode_plan = plan
        bits = {}
        for name in K4_CANDIDATES:
            fns[name]()
            n = "f16" if K4_CANDIDATES[name][0] == 4 else "f32"
            bits[name] = one_ulp(outs[name], fns[f"bf16 of {n}"]())
        for n in ("f16", "f32"):
            bits[f"port {n}"] = one_ulp(fns[f"port {n}"](),
                                        fns[f"bf16 of {n}"]())
        best = {name: min(t) for name, t in runs.items()}
        print(json.dumps({
            "shape": label, "card": power,
            "plan bf16": plan(B, Hkv, R, D, W, 132),
            "plan e4m3": plan(B, Hkv, R, D, W, 132, f8),
            "plan f16": plan(B, Hkv, R, D, W, 132, torch.float16),
            "plan f32": plan(B, Hkv, R, D, W, 132, torch.float32),
            "candidate plans (warps, split, splits)": plans, **runs,
            "over bf16 (best against best)": {
                name: best[name] / best[
                    "bf16 of f16" if "f16" in name else "bf16 of f32"]
                for name in best if "f16" in name or "f32" in name},
            "against bf16 of the kind: differing, ulps, row ulps": bits}),
            flush=True)
        del keep, outs
        torch.cuda.empty_cache()
    return 0


def sass_functions(root: str) -> dict:
    """{kernel's mangled name: its SASS instructions} of the kernel library
    that ``root`` built last (``cuobjdump -sass``), each instruction
    without its encoding and with branch labels unnumbered; names without
    the hashes of their file's anonymous namespace (they follow the
    source's path), and K4's without its warps argument and the index of
    its kind's (so a checkout whose K4 takes its warps from its kind
    compares with one that takes them as an argument)."""
    import glob
    import re

    libs = sorted(glob.glob(os.path.join(root, "build", "kernels", "*.so")),
                  key=os.path.getmtime)
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", libs[-1]],
                          capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_(\d+_\w+?_cu)_"
                         r"[0-9a-f]{8}", r"_GLOBAL__N__\1", m.group(1))
            if "gqa_decode_tc_kernel" in cur:   # and its KV's index
                cur = re.sub(r"IXT\d+_E", "IXT_E", re.sub(
                    r"(gqa_decode_tc_kernelILi\d+ELi\d+E)Li\d+E(Li\d+E)",
                    r"\1\2", cur))
            funcs[cur] = []
        elif cur and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            ins = line.split("*/", 1)[1].split(";")[0]
            funcs[cur].append(re.sub(r"\.L_x_\d+", ".L", ins).strip())
    return funcs


def sass_compare(other: str) -> dict:
    """Kernels of both checkouts' libraries by whether their SASS is the
    same (names as sass_functions gives them)."""
    a, b = sass_functions(other), sass_functions(HERE)
    same = sorted(n for n in a if n in b and a[n] == b[n])
    return {"sass_identical": same,
            "sass_differs": sorted(n for n in a if n in b and a[n] != b[n]),
            "sass_only_other": sorted(set(a) - set(b)),
            "sass_only_this": sorted(set(b) - set(a))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?", help="the other checkout (e.g. "
                    "the parent commit unpacked with git archive)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--plans", action="store_true",
                    help="time K4's launch plans (e4m3; f16 and f32 "
                    "candidates) in this checkout")
    ap.add_argument("--time-one", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.plans:
        sys.path.insert(0, HERE)
        return plan_sweep(a.rounds)
    if a.other is None:
        ap.error("OTHER_CHECKOUT is needed unless --plans is given")
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
    for key in keys:      # this checkout over the other, best against best
        if key.startswith(("K1f32", "K3f32", "K4f32", "K5f32")):
            summary[key.replace("_ms", "_this_over_other")] = min(
                x[key] for x in runs["this"]) / min(
                x[key] for x in runs["other"])
    if "K3f32_bf16kv_ms" in runs["this"][0]:   # K3 f32 over a bf16 cache
        summary["K3f32_bf16kv_over_f32kv"] = min(
            x["K3f32_bf16kv_ms"] for x in runs["this"]) / min(
            x["K3f32_ms"] for x in runs["this"])
    for key in keys:      # this checkout's f16 / f32 over the rounded twin
        for kind in ("f16", "f32"):
            twin = key.replace(f"_{kind}_ms", f"_bf16_of_{kind}_ms")
            if key.endswith(f"_{kind}_ms") and twin in runs["this"][0]:
                summary[key.replace("_ms", "_over_bf16")] = min(
                    x[key] for x in runs["this"]) / min(
                    x[twin] for x in runs["this"])
    for key in runs["this"][0]:
        if key.endswith("_sha") and key in runs["other"][0]:
            summary[key.replace("_sha", "_bits_equal")] = len(
                {x[key] for got in runs.values() for x in got}) == 1
    print(json.dumps(summary))
    print(json.dumps(sass_compare(other)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
