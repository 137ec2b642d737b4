#!/usr/bin/env python3
"""Time every instance of K3's tensor-core kernel over an f32 and an f16
KV cache on one card, to weigh ``dispatch_prefill_tc``'s choice.

    python3 tools/k3_instance_probe.py [--rounds 2] [--kinds f32 f16]

Builds ``tools/k3_instance_probe.cu`` (it includes
``csrc/lm_attention_tc.cuh`` and launches one chosen instance
``<D = 128, MT m-tiles, NW warps>`` over f32 or f16 K/V: 256, 128, 128
and 64 rows a block for (2, 8), (1, 8), (2, 4) and (1, 4)) with nvcc into
``build/k3_instance_probe/``. Then, at prefills of S tokens over a
16384-slot cache (28 query heads over 4 kv heads of 128, bf16 queries,
K/V from a seeded f32 normal draw cast to the kind), it times each
instance (CUDA events, 10 launches, best of 3; ``--rounds`` rounds in
turns, each instance's best kept), the port's K3 over that cache
(``prefill_flash_attention``, the instance the C entry picks) and over
the cache rounded to bf16, and checks every instance's output bit-equal
to the bf16 kernel's. Prints one JSON line per kind and shape and a
summary per kind: each instance's ms per wave of blocks (one block an
SM, as ``fewest_waves`` counts them), its median over the shapes relative
to the 64-row instance's as 10 (the rule's weights), and for each shape
the port's time (the instance the C entry picked) over the fastest
instance's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = ((2, 8), (1, 8), (2, 4), (1, 4))     # (m-tiles, warps)
KINDS = {"f32": 0, "f16": 4}                     # csrc/common.cuh DType
# (S, history slots): question prefills, chunked ingests, the ingest
SHAPES = ((40, 9000), (100, 8000), (300, 8000), (600, 8000), (1000, 8000),
          (1210, 4000), (2420, 4000), (4384, 223), (4384, 4607))


def build() -> ctypes.CDLL:
    out_dir = os.path.join(HERE, "build", "k3_instance_probe")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libk3probe.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    r = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared",
         "-I", os.path.join(HERE, "cogstream_tpu_torch", "csrc"),
         os.path.join(HERE, "tools", "k3_instance_probe.cu"), "-o", lib],
        capture_output=True, text=True)
    if r.returncode != 0:
        sys.exit(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    for line in (r.stdout + r.stderr).splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas:", line.strip(), flush=True)
    so = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    so.k3_instance.argtypes = [I, I, I] + [P] * 7 + [I] * 6 + [
        ctypes.c_float, P]
    so.k3_instance.restype = I
    return so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kinds", nargs="+", default=list(KINDS),
                    choices=list(KINDS))
    a = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from cogstream_tpu_torch.ops import kernels
    from cogstream_tpu_torch.ops import lm_attention as lma

    so = build()
    kernels.library()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = torch.cuda.get_device_name(0)
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    rng = np.random.default_rng(23)
    T, Hq, Hkv, D, BK = 16384, 28, 4, 128, 64
    k32 = torch.as_tensor(rng.standard_normal((1, T, Hkv, D)),
                          dtype=torch.float32).to(dev)
    v32 = torch.as_tensor(rng.standard_normal((1, T, Hkv, D)),
                          dtype=torch.float32).to(dev)
    stream = torch.cuda.current_stream().cuda_stream

    def ms(fn):
        fn()
        best = float("inf")
        for _ in range(3):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(10):
                fn()
            e.record()
            torch.cuda.synchronize()
            best = min(best, s.elapsed_time(e) / 10)
        return best

    for kind in a.kinds:
        dt = getattr(torch, {"f32": "float32", "f16": "float16"}[kind])
        kc, vc = k32.to(dt), v32.to(dt)
        kb, vb = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
        per_wave = {inst: [] for inst in INSTANCES}
        picks = []
        for S, hist in SHAPES:
            pos = np.full((1, T), -1, np.int32)
            pos[0, :hist + S] = np.arange(hist + S)
            eff = lma.effective_kv_positions(torch.as_tensor(pos).to(dev))
            q = torch.as_tensor(rng.standard_normal((1, S, Hq, D))).to(
                dev, torch.bfloat16)
            qp = torch.arange(hist, hist + S, dtype=torch.int32,
                              device=dev)[None]
            n_tiles = -(-T // BK)
            tiles = torch.nn.functional.pad(
                eff, (0, n_tiles * BK - T), value=lma.SENTINEL).view(
                    1, n_tiles, BK)
            tile_mm = torch.stack([tiles.amin(-1), tiles.amax(-1)]).to(
                torch.int32).contiguous()
            want = lma.prefill_flash_attention(q, kb, vb, qp, eff)
            outs = {inst: torch.empty_like(q) for inst in INSTANCES}

            def call(inst):
                rc = so.k3_instance(
                    KINDS[kind], inst[0], inst[1], q.data_ptr(),
                    kc.data_ptr(), vc.data_ptr(), qp.data_ptr(),
                    eff.data_ptr(), tile_mm.data_ptr(),
                    outs[inst].data_ptr(), 1, S, Hq, Hkv, T, T,
                    1.0 / math.sqrt(D), stream)
                if rc != 0:
                    raise RuntimeError(f"{kind} {inst}: CUDA error {rc}")

            times = {inst: float("inf") for inst in INSTANCES}
            port = {kind: float("inf"), "bf16": float("inf")}
            for _ in range(a.rounds):
                for inst in INSTANCES + tuple(reversed(INSTANCES)):
                    times[inst] = min(times[inst], ms(lambda: call(inst)))
                port[kind] = min(port[kind], ms(
                    lambda: lma.prefill_flash_attention(q, kc, vc, qp, eff)))
                port["bf16"] = min(port["bf16"], ms(
                    lambda: lma.prefill_flash_attention(q, kb, vb, qp, eff)))
            torch.cuda.synchronize()
            equal = {f"{m}x{w}": bool(torch.equal(outs[(m, w)], want))
                     for m, w in INSTANCES}
            R = S * Hq // Hkv
            waves = {inst: -(-(-(-R // (16 * inst[0] * inst[1])) * Hkv)
                             // sms) for inst in INSTANCES}
            for inst in INSTANCES:
                per_wave[inst].append(times[inst] / waves[inst])
            fastest = min(INSTANCES, key=times.get)
            picks.append({"S": S, "history": hist,
                          "fastest": "%dx%d" % fastest,
                          "fastest_ms": times[fastest],
                          "port_ms": port[kind],
                          "port_over_fastest": port[kind] / times[fastest]})
            print(json.dumps({
                "kind": kind, "S": S, "history": hist, "card": power,
                "ms": {f"{m}x{w}": times[(m, w)] for m, w in INSTANCES},
                "waves": {f"{m}x{w}": waves[(m, w)] for m, w in INSTANCES},
                f"port_{kind}_ms": port[kind], "port_bf16_ms": port["bf16"],
                f"{kind}_over_bf16": port[kind] / port["bf16"],
                "bits_equal_bf16": equal}), flush=True)
        base = statistics.median(per_wave[(1, 4)])
        print(json.dumps({
            "kind": kind, "card": card, "power": power,
            "weights_10_for_64_rows": {
                f"{m}x{w}": 10 * statistics.median(per_wave[(m, w)]) / base
                for m, w in INSTANCES},
            "port_vs_fastest": picks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
