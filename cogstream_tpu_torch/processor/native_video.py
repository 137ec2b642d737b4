"""ctypes binding for the native video decode runtime (native/videoio.cpp)
— a copy of ``cogstream_tpu/processor/native_video.py``.

Decode runs in a native thread + frame ring so the host CPU decodes
ahead of the device; Python only copies ready frames into numpy. The
library is the repository's own ``native/libvideoio.so`` (``make -C
native``), shared with the JAX package; it is not part of either package.

Falls back transparently: ``is_available()`` is False when the shared
library can't be built (no g++) or ffmpeg is missing — callers then use
processor/video_loader.py's pure-Python path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SO_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libvideoio.so"))

_lib = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    if not os.path.exists(_SO_PATH):
        try:
            subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                           check=True, capture_output=True, timeout=120)
        except Exception:
            _build_failed = True
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        _build_failed = True
        return None
    lib.vio_open.restype = ctypes.c_void_p
    lib.vio_open.argtypes = [ctypes.c_char_p, ctypes.c_double,
                             ctypes.c_int, ctypes.c_int,
                             ctypes.c_double, ctypes.c_double,
                             ctypes.c_int, ctypes.c_int]
    lib.vio_next.restype = ctypes.c_int
    lib.vio_next.argtypes = [ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_uint8)]
    lib.vio_buffered.restype = ctypes.c_int
    lib.vio_buffered.argtypes = [ctypes.c_void_p]
    lib.vio_frames_decoded.restype = ctypes.c_long
    lib.vio_frames_decoded.argtypes = [ctypes.c_void_p]
    lib.vio_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def is_available() -> bool:
    from .video_loader import have_ffmpeg

    return _load() is not None and have_ffmpeg()


class NativeVideoStream:
    """Iterate RGB24 frames of a video with ahead-of-time native decode."""

    def __init__(self, path: str, width: int, height: int,
                 fps: float = 0.0, start: float = 0.0, end: float = 0.0,
                 ring_frames: int = 16, apply_scale: bool = True):
        lib = _load()
        if lib is None:
            raise RuntimeError("native videoio unavailable")
        self._lib = lib
        self.width, self.height = width, height
        self._handle = lib.vio_open(path.encode(), float(fps),
                                    int(width), int(height),
                                    float(start), float(end),
                                    int(ring_frames),
                                    int(bool(apply_scale)))
        if not self._handle:
            raise RuntimeError(f"vio_open failed for {path}")
        self._frame = np.empty((height, width, 3), np.uint8)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        rc = self._lib.vio_next(
            self._handle,
            self._frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc == 1:
            return self._frame.copy()
        self.close()
        if rc == 0:
            raise StopIteration
        raise RuntimeError("native decode error")

    @property
    def buffered(self) -> int:
        return self._lib.vio_buffered(self._handle) if self._handle else 0

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.vio_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def decode_video(path: str, width: int, height: int, fps: float = 0.0,
                 start: float = 0.0, end: float = 0.0,
                 max_frames: Optional[int] = None,
                 apply_scale: bool = True) -> np.ndarray:
    """Decode to [T, H, W, 3] uint8 with the native ring pipeline."""
    frames = []
    stream = NativeVideoStream(path, width, height, fps, start, end,
                               apply_scale=apply_scale)
    for frame in stream:
        frames.append(frame)
        if max_frames is not None and len(frames) >= max_frames:
            stream.close()
            break
    if not frames:
        return np.zeros((0, height, width, 3), np.uint8)
    return np.stack(frames)
