"""Video segmentation + keyframe sampling (C18).

Host-only copy of ``cogstream_tpu/datagen/segmentation.py`` (the port
imports nothing of the JAX package; tests/test_torch_host.py pins the
copy's code to the original).

Rebuild of dataset_gen_pipeline/split_videos.py with ffmpeg instead of
moviepy (no moviepy on the hosts; ffmpeg where the host has it): split a raw video at human-provided
event timestamps (stream-copy first, re-encode retry on failure — the
analogue of the reference's audio-failure retry, split_videos.py:
109-113) and sample duration-adaptive keyframes capped at 512px.
Hosts without ffmpeg binaries (the card's machine among them) fall
back to OpenCV decode/encode.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple
from ..utils.io import atomic_write_json


def _have_ffmpeg() -> bool:
    return (shutil.which("ffmpeg") is not None
            and shutil.which("ffprobe") is not None)


def _run(cmd: List[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def _cv2_duration(path: str) -> float:
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        n = cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0.0
        if fps <= 0 or n <= 0:
            raise RuntimeError(f"cv2 could not probe {path!r}")
        return n / fps
    finally:
        cap.release()


def _cv2_segment(path: str, seg_path: str, s: float, e: float) -> None:
    """Raises (and removes the partial file) when nothing decodes or
    the writer can't open — the cv2 analogue of the ffmpeg path's
    returncode + size check; a silent empty segment would be recorded
    in the spec and never regenerated (resume skips existing files)."""
    import cv2

    cap = cv2.VideoCapture(path)
    written = 0
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        out = cv2.VideoWriter(seg_path,
                              cv2.VideoWriter_fourcc(*"mp4v"), fps,
                              (w, h))
        if not out.isOpened():
            raise RuntimeError(f"cv2 VideoWriter failed for {seg_path!r}")
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(round(s * fps)))
        for _ in range(max(int(round((e - s) * fps)), 1)):
            ok, frame = cap.read()
            if not ok:
                break
            out.write(frame)
            written += 1
        out.release()
    finally:
        cap.release()
    if written == 0 or not os.path.getsize(seg_path):
        try:
            os.unlink(seg_path)
        except OSError:
            pass
        raise RuntimeError(
            f"cv2 decoded 0 frames for segment [{s}, {e}) of {path!r}")


def _cv2_keyframe(path: str, fp: str, t: float, max_px: int) -> bool:
    import cv2

    cap = cv2.VideoCapture(path)
    ok = False
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(t * fps))
        ok, frame = cap.read()
    finally:
        cap.release()
    if not ok:
        return False
    h, w = frame.shape[:2]
    scale = min(1.0, max_px / max(h, w))
    if scale < 1.0:
        frame = cv2.resize(frame, (int(w * scale), int(h * scale)),
                           interpolation=cv2.INTER_AREA)
    return bool(cv2.imwrite(fp, frame))


def probe_duration(path: str) -> float:
    if not _have_ffmpeg():
        return _cv2_duration(path)
    r = _run(["ffprobe", "-v", "error", "-show_entries",
              "format=duration", "-of", "json", path])
    if r.returncode != 0:
        raise RuntimeError(f"ffprobe failed: {r.stderr[:200]}")
    return float(json.loads(r.stdout)["format"]["duration"])


def segment_video(path: str, out_dir: str,
                  timestamps: Sequence[float]) -> List[Dict]:
    """Split at timestamps; returns [{"path", "timestamp": [s, e]}]."""
    os.makedirs(out_dir, exist_ok=True)
    duration = probe_duration(path)
    bounds = [0.0] + sorted(t for t in timestamps if 0 < t < duration) \
        + [duration]
    base = os.path.splitext(os.path.basename(path))[0]
    out = []
    for i, (s, e) in enumerate(zip(bounds[:-1], bounds[1:])):
        seg_path = os.path.join(out_dir, f"{base}_seg{i:03d}.mp4")
        if not os.path.exists(seg_path):
            if not _have_ffmpeg():
                _cv2_segment(path, seg_path, s, e)
            else:
                cmd = ["ffmpeg", "-y", "-v", "error", "-ss", str(s),
                       "-to", str(e), "-i", path, "-c", "copy", seg_path]
                r = _run(cmd)
                if r.returncode != 0 or not os.path.getsize(seg_path):
                    # stream-copy can fail at non-keyframe cuts → re-encode
                    r = _run(["ffmpeg", "-y", "-v", "error",
                              "-ss", str(s), "-to", str(e), "-i", path,
                              "-c:v", "libx264", "-preset", "veryfast",
                              "-an", seg_path])
                    if r.returncode != 0:
                        raise RuntimeError(
                            f"segment {i} failed: {r.stderr[:200]}")
        out.append({"path": seg_path, "timestamp": [s, e], "index": i})
    return out


def keyframe_count(duration: float, base: int = 4, max_frames: int = 16
                   ) -> int:
    """Duration-adaptive count: ~1 frame / 10s within [base, max]."""
    return max(base, min(max_frames, base + int(duration // 10)))


def sample_keyframes(path: str, out_dir: str, duration: Optional[float]
                     = None, max_px: int = 512) -> List[str]:
    """Uniformly sample keyframes, long side capped at max_px."""
    os.makedirs(out_dir, exist_ok=True)
    duration = duration or probe_duration(path)
    n = keyframe_count(duration)
    base = os.path.splitext(os.path.basename(path))[0]
    frames = []
    for i in range(n):
        t = duration * (i + 0.5) / n
        fp = os.path.join(out_dir, f"{base}_kf{i:02d}.jpg")
        if not os.path.exists(fp):
            if not _have_ffmpeg():
                if not _cv2_keyframe(path, fp, t, max_px):
                    continue
            else:
                r = _run(["ffmpeg", "-y", "-v", "error", "-ss", str(t),
                          "-i", path, "-frames:v", "1",
                          "-vf",
                          f"scale='min({max_px},iw)':'min({max_px},ih)':"
                          "force_original_aspect_ratio=decrease",
                          fp])
                if r.returncode != 0:
                    continue
        if os.path.exists(fp):
            frames.append(fp)
    return frames


def split_and_sample(video_path: str, out_root: str,
                     timestamps: Sequence[float], log=print) -> Dict:
    """Full C18 driver for one video; writes the per-video JSON spec the
    generation stage consumes."""
    base = os.path.splitext(os.path.basename(video_path))[0]
    seg_dir = os.path.join(out_root, "segments")
    kf_dir = os.path.join(out_root, "keyframes")
    spec_path = os.path.join(out_root, f"{base}.json")
    if os.path.exists(spec_path):   # resumable
        with open(spec_path) as f:
            return json.load(f)
    segments = segment_video(video_path, seg_dir, timestamps)
    for seg in segments:
        s, e = seg["timestamp"]
        seg["keyframes"] = sample_keyframes(seg["path"], kf_dir,
                                            duration=e - s)
        log(f"segment {seg['index']}: {len(seg['keyframes'])} keyframes")
    spec = {"video": video_path, "segments": segments}
    atomic_write_json(spec_path, spec, indent=1)
    return spec
