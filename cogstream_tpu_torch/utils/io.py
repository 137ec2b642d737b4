"""Atomic file writes and the snapshot array codec (copy of the parts of
``cogstream_tpu/utils/io.py`` the evaluation and serving paths use):
tmp file + fsync + rename, atomic on POSIX, so a reader or a resumed run
never sees a partial file; ``pack_array`` / ``unpack_array`` store
extension dtypes as bytes, in the JAX package's layout."""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any


def atomic_write_text(path: str, text: str) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_", suffix=".part")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())   # durability: a rename that commits
            # before the data blocks flush leaves a truncated file that
            # resumable pipelines would skip forever
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj: Any, indent: int = 1) -> None:
    atomic_write_text(path, json.dumps(obj, indent=indent))


def atomic_write_npz(path: str, **arrays: Any) -> None:
    """np.savez via tmp-file + rename (atomic on POSIX)."""
    import numpy as np

    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_", suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# torch dtypes numpy cannot name: stored as their bytes under the JAX
# package's (ml_dtypes) names, so snapshots cross between the packages
_EXT_DTYPES = {"bfloat16": "bfloat16", "float8_e4m3fn": "float8_e4m3fn",
               "float8_e5m2": "float8_e5m2"}


def pack_array(a) -> tuple:
    """(uint8 byte view, dtype name) — lets np.savez carry extension
    dtypes (bfloat16, float8) that its header format can't express.
    Takes numpy arrays and torch tensors (copied to the host)."""
    import numpy as np
    import torch

    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name in _EXT_DTYPES:
            if t.ndim == 0:
                raise ValueError("pack_array: 0-d arrays don't round-trip; "
                                 "reshape to (1,) at the call site")
            return t.view(torch.uint8).numpy(), _EXT_DTYPES[name]
        a = t.numpy()
    a = np.ascontiguousarray(np.asarray(a))
    if a.ndim == 0:
        # unpack_array cannot restore a 0-d shape (it returns the byte
        # view re-typed) — silently promoting to (1,) would break the
        # documented round trip; reject loudly instead
        raise ValueError("pack_array: 0-d arrays don't round-trip; "
                         "reshape to (1,) at the call site")
    return a.view(np.uint8), a.dtype.name


def unpack_array(b, dtype_name: str):
    """Inverse of pack_array: a numpy array for the dtypes numpy names,
    a CPU torch tensor for bfloat16 / float8 (read as bytes and viewed as
    the torch dtype; ml_dtypes is not needed)."""
    import numpy as np
    import torch

    if dtype_name in _EXT_DTYPES:
        raw = torch.from_numpy(np.ascontiguousarray(np.asarray(b),
                                                    np.uint8))
        return raw.view(getattr(torch, dtype_name))
    return np.asarray(b).view(np.dtype(dtype_name))
