#!/usr/bin/env python3
"""Check and time the stacked int4 GEMVs K8 / K9 (``csrc/int4_gemv_tc.cu``)
on one CUDA card, and sweep their K split.

    python3 tools/int4_gemv_tc_sweep.py [--no-check]

For the 7B sites gate_proj [28, 1792, 18944], down_proj [28, 9472, 3584]
and q_proj / o_proj [28, 1792, 3584]:

1. (unless ``--no-check``) every m of 1, 2, 8, 9, 17, 40, 64, f32 and
   bf16 out, against the plain version on the card: K9 at f32 out exactly,
   K8 within 1e-5 of each row's max |ref| (bf16 out: 2^-7);
2. at m = 1, 8 and 40, the device ms of one call (CUDA graphs of 28 calls
   cycling over the layers, so every call reads cold weights) at every
   K split of whole 128-row stages, beside the split ``stacked_plan``
   picks.

Prints one line per case and the card's name; exits non-zero on a check
that fails.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def graph_ms(fn, n: int, replays: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(replays):
        g.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / (replays * n)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--no-check", action="store_true")
    args = ap.parse_args()
    import torch

    from cogstream_tpu_torch.ops import kernels
    from cogstream_tpu_torch.ops import quant_gemv as qg

    if not torch.cuda.is_available():
        print("int4_gemv_tc_sweep: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), flush=True)
    kernels.library()
    sms = kernels.sm_count(dev)
    rng = np.random.default_rng(0)
    bad = 0
    for shape in ((28, 1792, 18944), (28, 9472, 3584), (28, 1792, 3584)):
        L, half, dout = shape
        gen = torch.Generator(device=dev).manual_seed(1)
        qp = {"q4": torch.randint(-128, 128, shape, dtype=torch.int8,
                                  device=dev, generator=gen),
              "scale": torch.rand((L, dout), device=dev, generator=gen)
              * 0.03 + 0.01,
              "rscale": torch.rand((L, 2 * half), device=dev, generator=gen)
              + 0.5,
              "code": torch.full((L, 1), 1 / 7, device=dev)}
        ids = torch.arange(L, dtype=torch.int32, device=dev)
        for m in () if args.no_check else (1, 2, 8, 9, 17, 40, 64):
            x = torch.as_tensor(rng.standard_normal((m, 2 * half))).to(
                dev, torch.bfloat16)
            for w4a8 in (False, True):
                for od in (torch.float32, torch.bfloat16):
                    got = qg.int4_rank1_gemv_stacked(x, qp, ids[17:18], od,
                                                     w4a8=w4a8).float()
                    ref = qg.int4_rank1_gemv_stacked_plain(
                        x, qp, ids[17:18], od, w4a8=w4a8).float()
                    if w4a8 and od == torch.float32:
                        ratio = 0.0 if torch.equal(got, ref) else float("inf")
                    else:
                        tol = 1e-5 if od == torch.float32 else 2 ** -7
                        ratio = ((got - ref).abs() / (tol * ref.abs().amax(
                            -1, keepdim=True))).max().item()
                    bad += not ratio <= 1.0
                    print(f"check {shape} m={m} {'K9' if w4a8 else 'K8'} "
                          f"out={od}: worst row at {ratio:.3g} of its bound",
                          flush=True)
        n_stages = half // 128
        for m in (1, 8, 40):
            for var in (qg.UNIFORM, qg.W4A8):
                w4a8 = var == qg.W4A8
                x = (torch.randint(-127, 128, (m, 2 * half), dtype=torch.int8,
                                   device=dev) if w4a8 else
                     torch.randn((m, 2 * half), device=dev).to(torch.bfloat16))
                sx = torch.rand((m, 2), device=dev)
                out = torch.empty((m, dout), dtype=torch.bfloat16, device=dev)
                res = []
                for per in range(1, n_stages + 1):
                    splits = -(-n_stages // per)
                    if -(-n_stages // splits) != per:
                        continue
                    rows = per * 128
                    x_bytes = 2 * (-(-m // 8) * 8) * qg._tc_x_stride(rows,
                                                                     w4a8)
                    if x_bytes > qg._TC_X_BUDGET and per > 1:
                        continue
                    part, tickets = qg._tc_workspace(
                        dev, splits * 2 * m * dout, dout // 128)
                    it = iter(range(10 ** 9))

                    def call():
                        lay = ids[next(it) % L:][:1]
                        kernels.check(kernels.library().cs_int4_gemv_tc(
                            x.data_ptr(), sx.data_ptr(), qp["q4"].data_ptr(),
                            half * dout, qp["scale"].data_ptr(), dout,
                            lay.data_ptr(), out.data_ptr(), part.data_ptr(),
                            tickets.data_ptr(), m, half, dout, rows, splits,
                            var, kernels.dtype_code(out),
                            kernels.stream_ptr(x)), "cs_int4_gemv_tc")
                    res.append((splits, round(graph_ms(call, L), 4)))
                plan = qg.stacked_plan(m, half, dout, w4a8, sms)
                print(f"sweep {shape} m={m} {'K9' if w4a8 else 'K8'}: plan "
                      f"{plan[1]} splits of {plan[0]} rows; (splits, ms) "
                      f"{res}", flush=True)
    print(f"checks failed: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
