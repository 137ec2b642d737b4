"""Atomic JSON writes (copy of the part of ``cogstream_tpu/utils/io.py``
the evaluation path uses): tmp file + fsync + rename, atomic on POSIX, so
a reader or a resumed run never sees a partial file."""

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
