"""Chunked decode-ahead frame streaming (copy of
``cogstream_tpu/processor/frame_stream.py``; serving's chunked ingest is
its only consumer).

The buffered ``load_video`` path decodes a whole segment before any
device work starts. This module streams a video as fixed-size frame
CHUNKS while a decoder runs AHEAD of the consumer into a bounded buffer,
so host decode overlaps the card's encode during serving ingest:

- **native ring** backend: the C++ ffmpeg-pipe ring decoder
  (native/videoio.cpp) on hosts with ffmpeg — decode thread + frame
  ring entirely outside Python;
- **cv2 thread** backend: a Python reader thread over OpenCV's bundled
  decoder pushing into a bounded queue (hosts without ffmpeg, such as
  the card's machine), same back-pressure semantics.

Frame selection matches ``video_loader.load_video`` exactly per
backend (ffmpeg ``fps=...:round=up`` grid for native; the cv2 source-
index map for the thread backend), so chunked ingest sees the same
frames as a buffered load. ``buffered`` exposes the decoder's current
lead for overlap diagnostics (``/ingest``'s ``decode_buffered_max``).

Chunks are **HWC** (``[t, H, W, 3]``), unlike ``load_video``'s CHW
frames: both decoders produce HWC natively and the preprocess resize
consumes HWC, so a CHW chunk layout would pay two strided
transpose-copies per chunk for nothing. ``ImageProcessor`` accepts
either layout.
"""

from __future__ import annotations

import math
import os
import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

Chunk = Tuple[np.ndarray, List[float]]   # ([t, H, W, 3] uint8, seconds)


class FrameChunkStream:
    """Iterator of frame chunks with a decode-ahead backend."""

    def __init__(self, backend: str, frame_iter, buffered_fn, close_fn,
                 chunk_frames: int, total_frames_hint: int = 0):
        self.backend = backend
        self._it = frame_iter            # yields (frame_chw, ts)
        self._buffered = buffered_fn
        self._close = close_fn
        self.chunk_frames = chunk_frames
        self.frames_seen = 0
        self.buffered_max = 0            # decoder lead high-water mark
        # expected whole-window frame count — sizes the chunked resize
        # budget as if the window were one batch (0 = unknown)
        self.total_frames_hint = total_frames_hint

    @property
    def buffered(self) -> int:
        """Frames decoded ahead of the consumer right now."""
        n = self._buffered()
        if n > self.buffered_max:
            self.buffered_max = n
        return n

    def __iter__(self) -> Iterator[Chunk]:
        return self

    def __next__(self) -> Chunk:
        frames: List[np.ndarray] = []
        ts: List[float] = []
        for _ in range(self.chunk_frames):
            try:
                f, t = next(self._it)
            except StopIteration:
                break
            frames.append(f)
            ts.append(t)
        if not frames:
            self.close()
            raise StopIteration
        self.frames_seen += len(frames)
        self.buffered_max = max(self.buffered_max, self.buffered)
        return np.stack(frames), ts

    def close(self) -> None:
        self._close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _native_stream(path: str, start: Optional[float],
                   end: Optional[float], fps: float, chunk_frames: int,
                   ring_frames: int,
                   max_frames: Optional[int]) -> Optional[FrameChunkStream]:
    from . import native_video
    from .video_loader import probe_video, _video_stream

    if not native_video.is_available():
        return None
    try:
        info = probe_video(path)
        vs = _video_stream(info)
        w, h = int(vs["width"]), int(vs["height"])
        duration = float(info["format"]["duration"])
        stream_start = float(vs.get("start_time", 0.0) or 0.0)
    except Exception:
        return None
    t0 = max(stream_start, start) if start is not None else stream_start
    t1 = min(end, stream_start + duration) if end is not None \
        else stream_start + duration
    window = max(0.0, t1 - t0)
    if max_frames is not None and fps and fps * window >= max_frames:
        # uniform subsampling needs the whole set — buffered path wins.
        # >= not >: ffmpeg's fps round=up can emit one frame past
        # fps*window, which would overrun max_frames uncapped
        return None

    stream = native_video.NativeVideoStream(
        path, w, h, fps or 0.0,
        t0 if (start is not None or end is not None) else 0.0,
        t1 if (start is not None or end is not None) else 0.0,
        ring_frames=ring_frames, apply_scale=False)
    step = 1.0 / fps if fps else None

    def frame_iter():
        for k, frame in enumerate(stream):
            # HWC as decoded; timestamps on the fps grid from the
            # window start (load_video's arange semantics)
            t = t0 + k * step if step is not None else t0
            yield frame, float(t)

    hint = int(math.ceil(window * fps)) if fps else 0
    return FrameChunkStream("native-ring", frame_iter(),
                            lambda: stream.buffered, stream.close,
                            chunk_frames, total_frames_hint=hint)


def _cv2_stream(path: str, start: Optional[float], end: Optional[float],
                fps: float, chunk_frames: int, ring_frames: int,
                max_frames: Optional[int]) -> Optional[FrameChunkStream]:
    try:
        import cv2
    except ImportError:
        return None
    from .video_loader import cv2_frame_plan, cv2_source_count

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        cap.release()
        return None
    n_src, src_fps = cv2_source_count(cap)
    if n_src <= 0:
        # unknown frame count — no plan possible; the buffered loader
        # (which counts by grab) wins
        cap.release()
        return None
    # the SAME selection plan as the buffered _load_video_cv2 — chunked
    # ingest must see identical frames/labels to a buffered load
    src_idx, wanted, _ = cv2_frame_plan(
        n_src, src_fps, start, end, fps, max_frames)

    q: "queue.Queue" = queue.Queue(maxsize=ring_frames)
    stop = threading.Event()

    def reader():
        try:
            # shared access strategy (video_loader.cv2_iter_wanted):
            # sequential grab/retrieve for dense sampling, seek-based
            # access for sparse strides — corrupt wanted frames are
            # skipped, never stalling the index walk
            from .video_loader import cv2_iter_wanted

            for want_pos, frame in cv2_iter_wanted(cap, src_idx):
                if stop.is_set():
                    break
                rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                item = (rgb, float(wanted[want_pos]))
                while not stop.is_set():
                    try:                # bounded put = back-pressure
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
        finally:
            cap.release()
            # EOF sentinel: must never be dropped — a consumer stalled
            # on a long device dispatch keeps the queue full for far
            # longer than any fixed timeout, and a lost sentinel leaves
            # frame_iter blocked on q.get() forever.
            while not stop.is_set():
                try:
                    q.put(None, timeout=0.2)
                    break
                except queue.Full:
                    continue

    th = threading.Thread(target=reader, daemon=True)
    th.start()

    def frame_iter():
        while True:
            item = q.get()
            if item is None:
                return
            yield item

    def close():
        stop.set()
        while True:                      # unblock a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        th.join(timeout=2.0)

    return FrameChunkStream("cv2-thread", frame_iter(), q.qsize, close,
                            chunk_frames, total_frames_hint=len(wanted))


def open_frame_stream(
    path: str,
    start: Optional[float] = None,
    end: Optional[float] = None,
    fps: float = 1.0,
    chunk_frames: int = 16,
    ring_frames: int = 32,
    max_frames: Optional[int] = None,
) -> Optional[FrameChunkStream]:
    """Open a chunked decode-ahead stream, or None when only the
    buffered ``load_video`` path applies (frame dirs; ffmpeg hosts
    whose window exceeds ``max_frames`` — there the buffered load
    decodes via ffmpeg and subsamples post-hoc, and streaming through
    cv2 instead would select DIFFERENT frames than the buffered path
    on the same host)."""
    if os.path.isdir(path):
        return None
    from .video_loader import have_ffmpeg

    s = _native_stream(path, start, end, fps, chunk_frames, ring_frames,
                       max_frames)
    if s is not None:
        return s
    if have_ffmpeg():
        # the native backend declined (max_frames window, probe
        # failure, lib absent) — the buffered ffmpeg path is this
        # host's parity reference, so don't swap decoders mid-contract
        return None
    return _cv2_stream(path, start, end, fps, chunk_frames, ring_frames,
                       max_frames)
