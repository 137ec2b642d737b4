#!/usr/bin/env python3
"""What bounds the int4 / int8 decode GEMVs on one CUDA card: scratch
variants of the kernels K6 and K10 ran before their Hopper redesign, and
bare weight streams. Used nowhere in the port.

    python3 tools/quant_gemv_probe.py

1. K6 before the redesign (the uniform and cubic forms of
   ``csrc/int4_gemv.cu``) on the 7B lm_head [1792, 152064] at m = 1,
   beside a copy whose int-to-float conversions are replaced by the
   ``0x4B000000 | u`` magic (bit-identical output: checked);
2. K10 before the redesign (the mma.sync route of ``csrc/int8_gemv.cu``)
   on gate_proj [28, 3584, 18944] at m = 1, 40 and 64, beside a copy
   without its activation-fragment shared loads and a copy without those
   and without its mma.sync (outputs discarded);
3. bare streams of the same bytes: a ring of 128-row stages filled by
   ``cp.async.bulk`` copies of 128- or 256-byte rows, by TMA boxes of 128
   x 128 bytes (1, 2 or 4 a stage), and a plain coalesced read
   (``tools/quant_gemv_stream_probe.cu``).

The variants are patched copies built into ``build/quant_gemv_probe/``
with nvcc (the repository's sources are not touched). Times: device ms of
one call from CUDA graphs (stacked weights cycle over the 28 layers).
Prints one line per measurement and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "build", "quant_gemv_probe")
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                    "nvcc")

K6_MAGIC = [("""            wl = static_cast<float>(sl);
            wh = static_cast<float>(sh);""",
             """            const unsigned sh8 = 8 * (j & 3);
            wl = __int_as_float(0x4B000000u | (((word >> sh8) & 0xFu) ^ 8u))
                 - 8388616.0f;
            wh = __int_as_float(0x4B000000u |
                                (((word >> (sh8 + 4)) & 0xFu) ^ 8u))
                 - 8388616.0f;""")]
K10_NO_B = [("""          b[n] = *reinterpret_cast<const uint4*>(xs + (8 * n + g) * RS + kx);""",
             """          b[n] = make_uint4(kx + n, kx ^ n, kx * 3 + n, n + 0x3F803F80u);""")]
K10_NO_MMA = K10_NO_B + [("""            tc::mma(acc[j][n], a0, b[n].x, b[n].y);
            tc::mma(acc[j][n], a1, b[n].z, b[n].w);""",
                          """            acc[j][n][0] += __int_as_float(((a0[0] ^ a0[1] ^ a0[2] ^ a0[3] ^
                a1[0] ^ a1[1] ^ a1[2] ^ a1[3] ^ b[n].x) & 0x007FFFFFu) |
                0x3F800000u);""")]


def build(csrc: str):
    """Each variant and the stream probe as its own shared library."""
    os.makedirs(OUT, exist_ok=True)
    jobs = {"k6": ("int4_gemv.cu", []), "k6_magic": ("int4_gemv.cu", K6_MAGIC),
            "k10": ("int8_gemv.cu", []), "k10_no_b": ("int8_gemv.cu", K10_NO_B),
            "k10_no_mma": ("int8_gemv.cu", K10_NO_MMA)}
    procs = {}
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-I", csrc]
    for name, (src, subs) in jobs.items():
        text = open(os.path.join(csrc, src)).read()
        for a, b in subs:
            if a not in text:
                raise SystemExit(f"{name}: {src} changed, patch not found")
            text = text.replace(a, b)
        path = os.path.join(OUT, name + ".cu")
        open(path, "w").write(text)
        procs[name] = subprocess.Popen(
            [NVCC, *flags, path, "-o", os.path.join(OUT, name + ".so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs["stream"] = subprocess.Popen(
        [NVCC, *flags, os.path.join(ROOT, "tools",
                                    "quant_gemv_stream_probe.cu"),
         "-o", os.path.join(OUT, "stream.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc {name} failed:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(os.path.join(OUT, name + ".so"))
    return libs


def main() -> int:
    import torch

    from chip_smoke import graph_ms
    from cogstream_tpu_torch.ops import kernels
    from cogstream_tpu_torch.ops import quant_gemv as qg
    from cogstream_tpu_torch.ops.quant import CUBIC_A, CUBIC_C, column_major

    if not torch.cuda.is_available():
        print("quant_gemv_probe: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    libs = build(str(kernels.CSRC))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("k6", "k6_magic"):
        libs[name].cs_int4_gemv.argtypes = list(
            kernels._SIGNATURES["cs_int4_gemv"])
    for name in ("k10", "k10_no_b", "k10_no_mma"):
        libs[name].cs_int8_gemv.argtypes = list(
            kernels._SIGNATURES["cs_int8_gemv"])
    sp = libs["stream"]
    sp.probe_stream.argtypes = [P, L, L, L, I, I, I, I, I, P, P]
    sp.probe_tma.argtypes = [P, L, L, L, L, L, I, I, I, I, I, I, I, P, P]
    sp.probe_read_all.argtypes = [P, L, I, P, P]

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    sink = torch.zeros(4, dtype=torch.int32, device=dev)

    # 1. K6 before the redesign, its conversions against the magic
    half, dout = 1792, 152064
    q4 = torch.randint(-128, 128, (half, dout), dtype=torch.int8, device=dev,
                       generator=gen)
    sc = torch.rand(dout, device=dev, generator=gen) * 0.03 + 0.01
    x = torch.randn((1, 2 * half), device=dev, generator=gen).to(bf)
    codes = {0: torch.tensor([1.0, 0.0], device=dev),
             1: torch.tensor([CUBIC_A, CUBIC_C], device=dev)}
    rows, splits = qg._splits(dev, -(-dout // qg._BN), half)

    def k6(lib, variant, out):
        return lambda: kernels.check(lib.cs_int4_gemv(
            x.data_ptr(), None, q4.data_ptr(), 0, sc.data_ptr(), 0, None,
            codes[variant].data_ptr(), out.data_ptr(), None, 1, half, dout,
            rows, splits, variant, kernels.DTYPE_CODES[bf], stream()), "k6")

    o1 = torch.empty((1, dout), dtype=bf, device=dev)
    o2 = torch.empty_like(o1)
    k6(libs["k6"], 0, o1)()
    k6(libs["k6_magic"], 0, o2)()
    torch.cuda.synchronize()
    print(f"K6 lm_head m=1: the magic variant equals the original "
          f"{bool(torch.equal(o1, o2))}", flush=True)
    for turn in range(2):
        print(f"K6 lm_head m=1, turn {turn}: uniform "
              f"{graph_ms(k6(libs['k6'], 0, o1), 20):.4f} ms, uniform with "
              f"the magic {graph_ms(k6(libs['k6_magic'], 0, o2), 20):.4f}, "
              f"cubic {graph_ms(k6(libs['k6'], 1, o1), 20):.4f}", flush=True)

    # 3. bare streams of the lm_head's int4 bytes
    nbytes = q4.numel()

    def bulk(rowb, stages):
        return lambda: kernels.check(sp.probe_stream(
            q4.data_ptr(), rowb, 128 * dout, dout, dout // rowb, half // 128,
            stages, rowb, sms, sink.data_ptr(), stream()), "bulk")

    def tma(w, d0, d1, d2, k6_layout, nt, ns, stages, nl, boxes):
        return lambda: kernels.check(sp.probe_tma(
            w.data_ptr(), d0, d1, d2, d0, d0 * d1, k6_layout, nt, ns, stages,
            nl, boxes, sms, sink.data_ptr(), stream()), "tma")

    for rowb, stages in ((128, 8), (256, 6)):
        ms = graph_ms(bulk(rowb, stages), 10)
        print(f"stream lm_head int4, cp.async.bulk rows of {rowb} B, "
              f"{stages} stages: {ms:.4f} ms = {nbytes / ms / 1e9:.3f} TB/s",
              flush=True)
    for boxes, stages in ((1, 8), (2, 6), (4, 3)):
        ms = graph_ms(tma(q4, dout, half, 1, 1, dout // (128 * boxes),
                          half // 128, stages, 1, boxes), 10)
        print(f"stream lm_head int4, TMA {boxes} box(es) of 128 x 128 B side "
              f"by side, {stages} stages: {ms:.4f} ms = "
              f"{nbytes / ms / 1e9:.3f} TB/s", flush=True)
    ms = graph_ms(lambda: kernels.check(sp.probe_read_all(
        q4.data_ptr(), nbytes // 16, sms * 8, sink.data_ptr(), stream()),
        "read"), 10)
    print(f"stream lm_head int4, plain coalesced read: {ms:.4f} ms = "
          f"{nbytes / ms / 1e9:.3f} TB/s (bound {nbytes / 3.35e9:.4f} ms)",
          flush=True)
    del q4

    # 2. K10 before the redesign at m = 1 / 40 / 64 and its variants
    Lr, din, dout = 28, 3584, 18944
    q = column_major(torch.randint(-127, 128, (Lr, din, dout),
                                   dtype=torch.int8, device=dev,
                                   generator=gen))
    s8 = torch.rand((Lr, dout), device=dev, generator=gen) * 4e-3 + 1e-3
    ids = torch.arange(Lr, dtype=torch.int32, device=dev)
    part, tickets = qg._tc_workspace(dev, 28 * 64 * dout, dout // 128)
    for m in (1, 40, 64):
        xm = torch.randn((m, din), device=dev, generator=gen).to(bf)
        out = torch.empty((m, dout), dtype=bf, device=dev)
        r8, s8p = qg.stacked_plan(m, din, dout, False, sms, x_halves=1)
        it = iter(range(10 ** 9))

        def k10(lib):
            return lambda: kernels.check(lib.cs_int8_gemv(
                xm.data_ptr(), q.data_ptr(), din * dout, s8.data_ptr(), dout,
                ids[next(it) % Lr:].data_ptr(), out.data_ptr(),
                part.data_ptr(), tickets.data_ptr(), m, din, dout, r8, s8p,
                kernels.DTYPE_CODES[bf], kernels.DTYPE_CODES[bf], stream()),
                "k10")

        for turn in range(2):
            print(f"K10 gate_proj m={m} ({s8p} K splits), turn {turn}: "
                  f"original {graph_ms(k10(libs['k10']), Lr):.4f} ms, "
                  f"without B loads {graph_ms(k10(libs['k10_no_b']), Lr):.4f}"
                  f", without B loads and mma.sync "
                  f"{graph_ms(k10(libs['k10_no_mma']), Lr):.4f}", flush=True)
    nb = din * dout
    for boxes, stages in ((1, 8), (2, 6)):
        lay = torch.randint(-127, 128, (Lr, dout, din), dtype=torch.int8,
                            device=dev, generator=gen) if boxes == 1 else lay
        ms = graph_ms(tma(lay, din, dout, Lr, 0, dout // 128,
                          din // (128 * boxes), stages, Lr, boxes), 10)
        print(f"stream gate_proj int8 column-major, TMA {boxes} box(es) along "
              f"k, {stages} stages: {ms:.4f} ms = {nb / ms / 1e9:.3f} TB/s "
              f"(bound {nb / 3.35e9:.4f} ms)", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
