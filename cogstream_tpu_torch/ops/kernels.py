"""Build and load the port's CUDA kernels (``cogstream_tpu_torch/csrc``).

Each ``csrc/*.cu`` file compiles with its own nvcc process, all started
together, and the objects link into ONE shared library with a plain C
interface, loaded with ``ctypes`` — seconds to build, where an extension
that includes PyTorch's headers takes minutes. The build
runs at first use (never at import: the CPU tests import every module
on hosts with no nvcc) into ``build/kernels/`` at the repository root,
under a file name keyed by a hash of the sources, so an edited source
rebuilds and a stale library is never loaded.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code, so a
refused launch (too much shared memory, a bad grid) never passes
silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of every entry point (all return cudaError_t as int)
_SIGNATURES = {
    # x, scale, bias, out, n, h, eps, dtype, stream
    "cs_layernorm": (_P, _P, _P, _P, _I, _I, _F, _I, _P),
    # qkv, cos, sin, seg, kv_lo, kv_hi, out, n, heads, d, block_q,
    # scale, dtype, stream
    "cs_vision_attention": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _F, _I, _P),
    # qkv, cos, sin, seg, kv_lo, kv_hi, out, n, heads, d, block_q, scale,
    # stream (bf16)
    "cs_vision_attention_tc": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _F, _P),
    # q, k, v, seg, kv_lo, kv_hi, out, n, heads, d, block_q, scale, dtype,
    # stream (f32)
    "cs_segment_attention": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _F, _I, _P),
    # q, k, v, seg, kv_lo, kv_hi, out, n, heads, d, block_q, scale, stream
    # (bf16)
    "cs_segment_attention_tc": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _F, _P),
    # q, k, v, q_pos, eff, tile_min, out, part_m, part_l, part_acc,
    # B, S, Hq, Hkv, D, T_cache, kv_len, chunk_tiles, n_chunks, scale,
    # dtype, kv dtype, rows, stream (f32)
    "cs_gqa_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                         _P, _P),
    # part_m, part_l, part_acc, out, B, S, Hq, Hkv, D, n_chunks, dtype,
    # stream (f32)
    "cs_gqa_combine": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, q_pos, eff, part_ml, part_acc, tickets, out, B, S, Hq, Hkv,
    # D, T_cache, kv_len, mt, tiles_per_split, n_splits, scale, kv dtype,
    # rows, stream (bf16)
    "cs_gqa_decode_tc": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P),
    # q, k, v, q_pos, eff, tile_min, out, B, S, Hq, Hkv, D, T_cache,
    # kv_len, scale, kv dtype, rows, stream (bf16)
    "cs_gqa_prefill_tc": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _F, _I, _P, _P),
    # x, sx, q4, layer_stride, scale, scale_stride, layer, code, out, part,
    # m, half, dout, rows_per_split, splits, variant, out dtype, stream
    "cs_int4_gemv": (_P, _P, _P, _L, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                     _I, _I, _I, _P),
    # x, sx, q4, layer_stride, scale, scale_stride, layer, out, part,
    # tickets, m, half, dout, rows_per_split, splits, variant, out dtype,
    # stream
    "cs_int4_gemv_tc": (_P, _P, _P, _L, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _I, _I, _P),
    # x, q, layer_stride, scale, scale_stride, layer, out, part, tickets,
    # m, din, dout, rows_per_split, splits, x dtype, out dtype, stream
    "cs_int8_gemv": (_P, _P, _L, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _I, _I, _P),
    # x, q, layers, scale, scale_stride, layer, code, out, part, tickets,
    # m, k, dout, grid, variant, out dtype, stream (K6, K10 bf16)
    "cs_quant_gemv_sm90": (_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I,
                           _I, _I, _I, _I, _P),
    # tensor maps the K6 / K10 kernel encoded so far (one per weight)
    "cs_quant_gemv_sm90_encodes": (),
}
# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# K/V cache dtype codes of K3 and K4 (the fp8 cache is e4m3 only)
KV_DTYPE_CODES = {**DTYPE_CODES, torch.float8_e4m3fn: 2}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
last_build_seconds: Optional[float] = None   # None: loaded a cached build
last_build_log: str = ""   # nvcc/ptxas output of the last build (-Xptxas -v)


def _source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "cogstream_tpu_torch build only where the CUDA "
                       "toolkit is installed")


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into ``build/kernels/`` unless a library for
    the current sources already exists: one nvcc per source, all running
    at once, then one link. ptxas reports each kernel's registers and
    spills (``-Xptxas -v``) into :data:`last_build_log` (kept beside the
    library and read back with a cached build), printed with ``verbose``.
    Returns the library path."""
    global last_build_seconds, last_build_log
    out = BUILD_DIR / f"libcogstream_kernels_{_source_hash()}.so"
    report = out.with_suffix(".ptxas.txt")
    if out.exists():
        if report.exists():
            last_build_log = report.read_text()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmpdir, src.stem + ".o")
            cmd = [nvcc, "-Xptxas", "-v", *NVCC_FLAGS, "-c", str(src),
                   "-o", obj]
            procs.append((obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for obj, p in procs:
            log = p.communicate()[0]
            logs.append(log)
            if p.returncode != 0:
                failed.append(f"{obj} ({p.returncode}):\n{log}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = os.path.join(tmpdir, "lib.so")
        r = subprocess.run([nvcc, "-shared", "-o", lib,
                            *(obj for obj, _ in procs)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stdout}\n{r.stderr}")
        last_build_log = "".join(logs)
        if verbose:
            print(last_build_log)
        report.write_text(last_build_log)
        os.replace(lib, out)   # atomic: a reader never sees a partial file
    last_build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def plain_route(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the wrapper runs its plain version), False
    for a CUDA tensor (the wrapper launches its kernel); any other
    device raises. There is no fallback from a CUDA tensor."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


class KernelError(RuntimeError):
    """A port kernel's entry point returned a CUDA error; ``code`` is the
    ``cudaError_t`` value (a sticky one from an earlier fault on the card
    shows up here too: ``runtime.serve._backend_fatal`` reads it)."""

    def __init__(self, name: str, code: int):
        super().__init__(f"CUDA kernel {name} failed to launch: "
                         f"cudaError {code}")
        self.code = code


def check(code: int, name: str) -> None:
    if code != 0:
        raise KernelError(name, code)


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_sm_counts: dict = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached: read once)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def kv_dtype_code(t: torch.Tensor) -> int:
    """Code of a K/V cache operand of K3 / K4: f32, bf16 or e4m3."""
    if t.dtype not in KV_DTYPE_CODES:
        raise TypeError(f"K/V cache takes float32, bfloat16 or "
                        f"float8_e4m3fn, got {t.dtype}")
    return KV_DTYPE_CODES[t.dtype]


def require(t: torch.Tensor, name: str, device: torch.device,
            dtype=None, shape=None) -> None:
    """Validate a kernel operand before its pointer reaches C."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_aligned(*tensors: torch.Tensor) -> None:
    """The tensor-core tiles copy rows in 16-byte chunks: each operand must
    start on a 16-byte boundary (a fresh allocation does; a view with an
    odd offset may not)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"operand of shape {tuple(t.shape)} is not "
                             "16-byte aligned")
