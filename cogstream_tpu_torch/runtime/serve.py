"""Serving front-end for streaming sessions on the card (port of
``cogstream_tpu/runtime/serve.py``).

JSON over HTTP (stdlib ``ThreadingHTTPServer``):

    POST /session            {"session_id"?}            -> creates a session
    POST /ingest             {"session_id", "video_path", "start", "end",
                              "fps"?}                   -> decode+encode+cache
    POST /ask                {"session_id", "question", "mode"?,
                              "max_new_tokens"?}        -> answer (+ its
                                                           token ids)
    POST /ask_stream         same body -> chunked text deltas, then a
                             0x1e record separator + final JSON meta
    POST /save               {"session_id", "path"}     -> snapshot to disk
    POST /restore            {"session_id", "path"}     -> recreate from
                             a snapshot (restart recovery, no re-ingest)
    GET  /stats                                         -> per-stage timers

One process drives one card. Requests serialize on a lock; with
``pool_rows`` > 0 the sessions live in a :class:`SessionPool` and a
:class:`BatchingFrontend` batches concurrent asks (one pooled decode) and
ingests (one batched encode + prefill). All device work runs on the
current CUDA stream of the process, one call at a time: K4's split
workspace is shared per device (``ops/lm_attention._decode_workspace``).
``torch.inference_mode`` is per thread, so every model entry point
(session, pool) enters it itself.

``--auto-snapshot-dir`` snapshots each session after every successful
/ingest and /ask, and a starting server restores every snapshot it finds
there.

Crash recovery (``--supervise``): a sticky CUDA error (an illegal
address, a device-side assert, ...) leaves the process's CUDA context
unusable; no in-process retry recovers. The serving process therefore
runs under a supervisor that never touches CUDA itself: the request that
met the error gets a 503 ``{"backend_fatal": true, "recovering": true}``,
the child exits (rc 17), the supervisor starts a new one, and that
process restores every session from its auto-snapshot. Clients retry a
503 after the restart and keep their streams.

The quantized modes load as in JAX: ``--quantize-weights int8|int4``
(K10 / K6-K9 decode), ``--w8a8-prefill`` (int8 activations in prefill
GEMMs; needs ``--quantize-weights``), ``--w4a8-decode`` (int4 only) and
``--encoder-int8`` (the W8A8 vision tower, one copy for the server).
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch


class UnknownSession(Exception):
    pass


# cudaError_t values after which the CUDA context of the process is
# unusable (CUDA 12.8 driver_types.h: "the process must be terminated and
# relaunched"), with uncorrectable ECC
STICKY_CUDA_ERRORS = frozenset({
    214,    # cudaErrorECCUncorrectable
    226,    # cudaErrorContained
    700,    # cudaErrorIllegalAddress
    702,    # cudaErrorLaunchTimeout
    710,    # cudaErrorAssert (device-side assert)
    714,    # cudaErrorHardwareStackError
    715,    # cudaErrorIllegalInstruction
    716,    # cudaErrorMisalignedAddress
    717,    # cudaErrorInvalidAddressSpace
    718,    # cudaErrorInvalidPc
    719,    # cudaErrorLaunchFailure
    721,    # cudaErrorTensorMemoryLeak
    810,    # cudaErrorMpsClientTerminated
    911,    # cudaErrorExternalDevice
})


def _backend_fatal(e: BaseException) -> bool:
    """True for errors after which the process's CUDA context is unusable:
    the process must be replaced, not retried.

    Both the TYPE and the status must match: ``torch.AcceleratorError``
    (torch's CUDA error, carrying ``error_code``) or the port's own
    ``KernelError`` (carrying ``code``), with a sticky code. An
    out-of-memory error is recoverable in the process, and an error of
    another type whose message merely contains "CUDA error" (an
    upstream error string surfaced through ingest) must not take down
    the serving process and its sessions."""
    from ..ops.kernels import KernelError

    if isinstance(e, KernelError):
        code = e.code
    elif isinstance(e, torch.AcceleratorError):
        code = getattr(e, "error_code", None)
    else:
        return False
    return code in STICKY_CUDA_ERRORS


# Fault injection for recovery tests: when set to N, the N-th ingest
# dispatch (and every later one) of the process faults: a real device-side
# assert on a CUDA model, its torch error on a CPU one.
FAULT_ENV = "COGSTREAM_FAULT_INGEST_DISPATCH"
SUPERVISED_ENV = "COGSTREAM_SERVE_SUPERVISED"
FATAL_EXIT = 17     # a supervised child's exit after a sticky error


def inject_fault(device: torch.device) -> None:
    """Raise the error a sticky CUDA fault raises. On the card: an index
    past the end of a tensor trips the indexing kernel's device-side
    assert (cudaErrorAssert, which poisons the context), and the
    synchronize raises it here. On the CPU: ``torch.AcceleratorError``
    with the text and ``error_code`` torch gives the card's error."""
    if device.type == "cuda":
        x = torch.zeros(4, device=device)
        x[torch.tensor([1 << 20], device=device)]
        torch.cuda.synchronize(device)
        raise AssertionError("the out-of-range index raised no error")
    e = torch.AcceleratorError(f"CUDA error: device-side assert triggered "
                               f"(injected by {FAULT_ENV})")
    e.error_code = 710
    raise e


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"#{item})")


# the collector thread waits this long after the first queued request, so
# concurrent requests join one batch
FLUSH_S = 0.015


class BatchingFrontend:
    """Opportunistic request batching over a SessionPool: /ask and
    /ingest calls enqueue and block; a collector thread flushes every
    ``FLUSH_S``. Pending ingests flush first (grouped by segment shape
    into one ``pool.ingest_batch``), then pending questions (one per row,
    grouped by decode params) run as one pooled prefill+decode."""

    def __init__(self, pool, lock=None, extra_eos_ids: tuple = ()):
        self.pool = pool
        self.extra_eos_ids = tuple(extra_eos_ids)
        self.lock = lock or threading.Lock()   # serializes device work
        self._queue: list = []
        self._ingest_queue: list = []
        self._cv = threading.Condition()
        self.ask_batches = 0                   # pooled decodes run
        self.max_batch_rows = 0                # rows of the largest
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the collector thread (it holds the pool) once the queued
        requests are answered."""
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout=60)

    def ask(self, row: int, question: str, mode: str = "FCC",
            max_new_tokens: int = 256) -> Dict:
        item = {"row": row, "q": question, "mode": mode,
                "new": max_new_tokens, "event": threading.Event(),
                "result": None, "error": None}
        with self._cv:
            self._queue.append(item)
            self._cv.notify()
        item["event"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def ingest(self, row: int, pixel_values, grid_size, merge_size,
               timestamps) -> None:
        item = {"row": row, "args": (pixel_values, tuple(grid_size),
                                     int(merge_size), list(timestamps)),
                "event": threading.Event(), "error": None}
        with self._cv:
            self._ingest_queue.append(item)
            self._cv.notify()
        item["event"].wait()
        if item["error"] is not None:
            raise item["error"]

    def _flush_ingests(self, pending: list) -> None:
        # group by segment shape; one request per row per flush
        by_shape: Dict = {}
        leftover = []
        seen_rows = set()
        for it in pending:
            _, grid, ms, _ = it["args"]
            if it["row"] in seen_rows:
                leftover.append(it)
                continue
            seen_rows.add(it["row"])
            by_shape.setdefault((grid, ms), []).append(it)
        for (grid, ms), items in by_shape.items():
            try:
                with self.lock:
                    if len(items) == 1:
                        it = items[0]
                        self.pool.ingest(it["row"], it["args"][0], grid,
                                         ms, it["args"][3])
                    else:
                        self.pool.ingest_batch(
                            [(it["row"], it["args"][0], grid, ms,
                              it["args"][3]) for it in items])
            except Exception as e:  # noqa: BLE001
                for it in items:
                    it["error"] = e
            for it in items:
                it["event"].set()
        if leftover:
            with self._cv:
                self._ingest_queue = leftover + self._ingest_queue
                self._cv.notify()

    def _loop(self):
        import time as _t

        while True:
            with self._cv:
                while (not self._queue and not self._ingest_queue
                       and not self._closed):
                    self._cv.wait()
                if self._closed and not self._queue \
                        and not self._ingest_queue:
                    return
            _t.sleep(FLUSH_S)   # let a batch accumulate
            with self._cv:
                pending, self._queue = self._queue, []
                pending_ing, self._ingest_queue = self._ingest_queue, []
            if pending_ing:
                self._flush_ingests(pending_ing)
            # one request per row per batch; group by decode params
            by_params: Dict = {}
            leftover = []
            seen_rows = set()
            for it in pending:
                key = (it["mode"], it["new"])
                if it["row"] in seen_rows:
                    leftover.append(it)
                    continue
                seen_rows.add(it["row"])
                by_params.setdefault(key, []).append(it)
            for (mode, new), items in by_params.items():
                try:
                    with self.lock:
                        out = self.pool.ask_batch(
                            [(it["row"], it["q"]) for it in items],
                            mode=mode, max_new_tokens=new,
                            extra_eos_ids=self.extra_eos_ids)
                    self.ask_batches += 1
                    self.max_batch_rows = max(self.max_batch_rows,
                                              len(items))
                    for it in items:
                        it["result"] = out[it["row"]]
                except Exception as e:  # noqa: BLE001
                    for it in items:
                        it["error"] = e
                for it in items:
                    it["event"].set()
            if leftover:
                with self._cv:
                    self._queue = leftover + self._queue
                    self._cv.notify()


class SessionServer:
    def __init__(self, model, cfg, tokenizer, adapters=None,
                 max_len: int = 16384, pool_rows: int = 0,
                 ingest_chunk_frames: int = 16, lookahead_k: int = 0,
                 extra_eos_ids: tuple = (), encoder_int8: bool = False,
                 auto_snapshot_dir: Optional[str] = None, mesh=None):
        from ..models.cogreasoner import with_int8_tower
        from ..utils.profiling import StageTimer
        from .session import StreamingSession

        if mesh is not None:
            raise _not_ported("mesh (tensor-parallel serving)", 9)
        # encoder_int8: ONE W8A8 copy of the tower, shared by the solo
        # sessions and the pool (each finds its model's tower int8 already)
        if encoder_int8:
            model = with_int8_tower(model)
        # lookahead_k: the server's default for speculative greedy decodes
        # on solo sessions (a request's "lookahead_k" overrides it; the
        # pooled batch decode ignores both)
        self.lookahead_k = lookahead_k
        # the checkpoint's full terminator set (generation_config
        # eos_token_id list), applied to every decode as HF does
        self.extra_eos_ids = tuple(extra_eos_ids)
        self._mk = lambda: StreamingSession(model, cfg, tokenizer,
                                            adapters=adapters,
                                            max_len=max_len)
        self.sessions: Dict[str, object] = {}
        self.lock = threading.Lock()
        self.timer = StageTimer()
        self.cfg = cfg
        # frames per chunked-ingest dispatch; the decoder streams ahead of
        # the card's encode between dispatches
        self.ingest_chunk_frames = ingest_chunk_frames
        # every successful /ingest and /ask snapshots its session here;
        # restore_all brings them back at start
        self.auto_snapshot_dir = auto_snapshot_dir
        if auto_snapshot_dir:
            os.makedirs(auto_snapshot_dir, exist_ok=True)
        # a supervised child (run_supervised sets the variable) exits
        # after a sticky CUDA error so that the supervisor replaces it
        self.supervised = os.environ.get(SUPERVISED_ENV) == "1"
        self.exit_code = 0
        self._fault_at = int(os.environ.get(FAULT_ENV) or 0)
        self._dispatches = 0
        self.pool = None
        self.frontend = None
        self._row_of: Dict[str, int] = {}
        self._next_sid = 0
        if pool_rows > 0:
            from .pool import SessionPool

            self.pool = SessionPool(model, cfg, tokenizer, n_rows=pool_rows,
                                    max_len=max_len, adapters=adapters)
            self.frontend = BatchingFrontend(
                self.pool, lock=self.lock,
                extra_eos_ids=tuple(extra_eos_ids))

    def _get(self, session_id: str):
        if session_id not in self.sessions:
            raise UnknownSession(f"unknown session {session_id!r}")
        return self.sessions[session_id]

    def create(self, session_id: Optional[str] = None) -> Dict:
        """Create a session; without an id one is minted under the lock.
        Creating over an existing id replaces it and releases its pool
        row (a retried POST /session must not leak rows)."""
        with self.lock:
            if session_id is None:
                session_id = f"s{self._next_sid}"
                self._next_sid += 1
            if self.pool is not None:
                old = self._row_of.pop(session_id, None)
                if old is not None:
                    self.pool.close(old)
                row = self.pool.open()
                self._row_of[session_id] = row
                self.sessions[session_id] = self.pool.sessions[row]
            else:
                self.sessions[session_id] = self._mk()
        return {"session_id": session_id}

    def _dispatch_batch(self, session_id: str, sess, batch,
                        timestamps: List[float], pv_device=None,
                        keep_mask=None) -> None:
        """Dispatch one preprocessed chunk's ingest: batched frontend,
        pool, or bare session (with the rows and keep mask the
        preprocess worker may have made ahead)."""
        if self._fault_at:
            self._dispatches += 1
            if self._dispatches >= self._fault_at:
                with self.lock:
                    inject_fault(sess.device)
        t, gh, gw = (int(x) for x in batch.grid_sizes[0])
        ms = int(batch.merge_sizes[0])
        if self.frontend is not None:
            # concurrent streams' segments coalesce into one batched ingest
            self.frontend.ingest(self._row_of[session_id],
                                 batch.pixel_values, (t, gh, gw), ms,
                                 timestamps)
        elif self.pool is not None:
            with self.lock:
                self.pool.ingest(self._row_of[session_id],
                                 batch.pixel_values, (t, gh, gw), ms,
                                 timestamps)
        else:
            with self.lock:
                sess.append_stream_segment(
                    batch.pixel_values, (t, gh, gw), ms, timestamps,
                    pixel_values_device=pv_device, keep_mask=keep_mask)

    def ingest(self, session_id: str, video_path: str,
               start: Optional[float], end: Optional[float],
               fps: float = 1.0) -> Dict:
        from ..processor.frame_stream import open_frame_stream
        from ..processor.image_processor import (ImageProcessor,
                                                 smart_resize_single_factor)
        from ..processor.video_loader import load_video

        with self.timer.stage("ingest"):
            # video decode and preprocess run OUTSIDE the lock; only the
            # device dispatch serializes. Raw uint8 rows normalize on the
            # card.
            sess = self._get(session_id)
            proc = ImageProcessor(self.cfg.processor)
            stream = open_frame_stream(
                video_path, start=start, end=end, fps=fps,
                chunk_frames=self.ingest_chunk_frames,
                max_frames=self.cfg.processor.max_frames)
            if stream is None:
                # frame directories (and ffmpeg hosts whose window needs
                # uniform subsampling): one buffered segment
                frames, timestamps, _ = load_video(
                    video_path, start_time=start, end_time=end, fps=fps,
                    max_frames=self.cfg.processor.max_frames)
                batch = proc([np.stack(frames)], modals=["video"],
                             raw_uint8=True)
                self._dispatch_batch(session_id, sess, batch, timestamps)
                decode_stats = {"backend": "buffered", "buffered_max": 0}
                n_frames = len(frames)
            else:
                # chunked decode-ahead: the decoder (native ring / cv2
                # thread) runs ahead, a preprocess worker resizes and
                # patchifies chunk k+1 while chunk k's ingest runs. The
                # resize target pins to the whole window's frame budget so
                # every chunk shares one grid (each chunk's first frame
                # keeps all its tokens: the keep mask restarts per chunk).
                pq: "queue.Queue" = queue.Queue(maxsize=2)
                perr: list = []
                solo = self.frontend is None and self.pool is None
                state = {"target": None}

                def _prep(chunk):
                    if state["target"] is None:
                        pc = self.cfg.processor
                        total = max(stream.total_frames_hint, len(chunk))
                        state["target"] = smart_resize_single_factor(
                            [chunk[0]], pc.patch_size * pc.video_merge_size,
                            pc.min_tokens, pc.max_tokens,
                            num_frames_override=total)
                    batch = proc([chunk], modals=["video"], raw_uint8=True,
                                 target_sizes=state["target"])
                    pv_dev = keep = None
                    if solo:
                        # upload the rows and compute the keep mask now,
                        # while the previous chunk's device work runs (one
                        # stream: the copy orders behind it)
                        t, gh, gw = (int(x) for x in batch.grid_sizes[0])
                        with torch.inference_mode():
                            pv_dev = torch.from_numpy(np.ascontiguousarray(
                                batch.pixel_values)).to(sess.device)
                            keep = sess.ingest_keep_mask(
                                pv_dev, (t, gh, gw),
                                int(batch.merge_sizes[0]))
                    return batch, pv_dev, keep

                def _preprocess_worker():
                    try:
                        for chunk, ts in stream:
                            pq.put((*_prep(chunk), ts))
                    except Exception as e:  # noqa: BLE001
                        perr.append(e)
                    finally:
                        pq.put(None)

                with stream:
                    th = threading.Thread(target=_preprocess_worker,
                                          daemon=True)
                    th.start()
                    while True:
                        item = pq.get()
                        if item is None:
                            break
                        batch, pv_dev, keep, ts = item
                        self._dispatch_batch(session_id, sess, batch, ts,
                                             pv_device=pv_dev,
                                             keep_mask=keep)
                    th.join(timeout=5.0)
                    if perr:
                        raise perr[0]
                decode_stats = {"backend": stream.backend,
                                "buffered_max": stream.buffered_max}
                n_frames = stream.frames_seen
        self._auto_snapshot(session_id)
        # request-local stats: concurrent ingests never mix
        return {"frames": n_frames, "cache_tokens": sess.write_index,
                "decode_backend": decode_stats["backend"],
                "decode_buffered_max": decode_stats["buffered_max"]}

    def ask(self, session_id: str, question: str, mode: str = "FCC",
            max_new_tokens: int = 512,
            lookahead_k: Optional[int] = None) -> Dict:
        if self.frontend is not None:
            with self.lock:
                self._get(session_id)
                row = self._row_of[session_id]
            # block WITHOUT the lock: the collector thread takes it to run
            # the pooled decode, so concurrent asks batch together (the
            # batched decode has no speculative path)
            with self.timer.stage("ask"):
                out = self.frontend.ask(row, question, mode=mode,
                                        max_new_tokens=max_new_tokens)
        else:
            with self.lock:
                sess = self._get(session_id)
                with self.timer.stage("ask"):
                    out = sess.ask(question, mode=mode,
                                   max_new_tokens=max_new_tokens,
                                   lookahead_k=(self.lookahead_k
                                                if lookahead_k is None
                                                else lookahead_k),
                                   extra_eos_ids=self.extra_eos_ids)
        self._auto_snapshot(session_id)
        return out

    def ask_stream(self, session_id: str, question: str,
                   mode: str = "FCC", max_new_tokens: int = 512):
        """Generator of text deltas, ending with the result dict. Pooled
        sessions stream too (their row is theirs alone); the lock is held
        for the whole stream, so batched asks queue behind it."""
        with self.lock:
            sess = self._get(session_id)
            with self.timer.stage("ask"):
                yield from sess.ask_stream(
                    question, mode=mode, max_new_tokens=max_new_tokens,
                    extra_eos_ids=self.extra_eos_ids)

    def save_session(self, session_id: str, path: str) -> Dict:
        """Snapshot a live session to disk (atomic npz)."""
        with self.lock:
            sess = self._get(session_id)
            sess.save(path)
        return {"session_id": session_id, "path": path,
                "cache_tokens": sess.write_index}

    def restore_session(self, session_id: str, path: str) -> Dict:
        """Recreate a session from a snapshot, replacing one of the same
        id. Transactional: the snapshot loads onto a fresh row first;
        only then is the old row released, so a failed restore leaves
        the old session usable and leaks nothing."""
        with self.lock:
            if self.pool is not None:
                row = self.pool.open_restored(path)   # raises: no change
                old = self._row_of.pop(session_id, None)
                if old is not None:
                    self.pool.close(old)
                self._row_of[session_id] = row
                self.sessions[session_id] = self.pool.sessions[row]
            else:
                sess = self._mk()
                sess.load_state(path)
                self.sessions[session_id] = sess
        return {"session_id": session_id,
                "cache_tokens": self.sessions[session_id].write_index,
                "turns": len(self.sessions[session_id].hist_qs)}

    def close(self) -> None:
        """Stop the batching frontend's thread (pooled servers)."""
        if self.frontend is not None:
            self.frontend.close()

    def request_shutdown(self, code: int = FATAL_EXIT) -> None:
        """After a sticky CUDA error: in a supervised child, exit shortly
        (letting the 503 flush) so the supervisor replaces the process.
        Outside supervision this only records the code (tests and
        embedded servers must not be killed)."""
        self.exit_code = code
        if not self.supervised:
            return

        def _die():
            time.sleep(0.5)
            os._exit(code)

        threading.Thread(target=_die, daemon=True).start()

    def stats(self) -> Dict:
        out = self.timer.summary()
        if self.frontend is not None:
            out["ask_batches"] = {"n": self.frontend.ask_batches,
                                  "max_rows": self.frontend.max_batch_rows}
        return out

    # ---- snapshots for restarts ----------------------------------------

    def _snap_path(self, session_id: str) -> str:
        return os.path.join(self.auto_snapshot_dir, f"{session_id}.snap.npz")

    def _auto_snapshot(self, session_id: str) -> None:
        """Post-request snapshot. Best effort: a failed snapshot must not
        fail the request that produced good output (logged to stderr)."""
        if not self.auto_snapshot_dir:
            return
        try:
            with self.lock:
                sess = self.sessions.get(session_id)
                if sess is not None:
                    with self.timer.stage("snapshot"):
                        sess.save(self._snap_path(session_id))
        except Exception as e:  # noqa: BLE001
            print(f"auto-snapshot of {session_id!r} failed: {e!r}",
                  file=sys.stderr)

    def restore_all(self) -> List[str]:
        """Start-up recovery: restore every ``*.snap.npz`` of the
        auto-snapshot dir; one corrupt snapshot does not block the
        rest."""
        if not self.auto_snapshot_dir:
            return []
        restored = []
        for fn in sorted(os.listdir(self.auto_snapshot_dir)):
            if not fn.endswith(".snap.npz"):
                continue
            sid = fn[: -len(".snap.npz")]
            try:
                self.restore_session(
                    sid, os.path.join(self.auto_snapshot_dir, fn))
                restored.append(sid)
            except Exception as e:  # noqa: BLE001
                print(f"restore of {sid!r} failed: {e!r}", file=sys.stderr)
        return restored


def make_handler(server: SessionServer):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload: Dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/stats":
                return self._json(200, server.stats())
            return self._json(404, {"error": "unknown path"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                return self._json(400, {"error": "bad json"})
            try:
                if self.path == "/session":
                    return self._json(200, server.create(
                        req.get("session_id")))
                if self.path == "/ingest":
                    return self._json(200, server.ingest(
                        req["session_id"], req["video_path"],
                        req.get("start"), req.get("end"),
                        req.get("fps", 1.0)))
                if self.path == "/ask":
                    return self._json(200, server.ask(
                        req["session_id"], req["question"],
                        req.get("mode", "FCC"),
                        req.get("max_new_tokens", 512),
                        lookahead_k=req.get("lookahead_k")))
                if self.path == "/save":
                    return self._json(200, server.save_session(
                        req["session_id"], req["path"]))
                if self.path == "/restore":
                    return self._json(200, server.restore_session(
                        req["session_id"], req["path"]))
                if self.path == "/ask_stream":
                    # resolve the session BEFORE the headers so 404 / 400
                    # stay clean status codes
                    server._get(req["session_id"])
                    question = req["question"]
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; charset=utf-8")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    try:
                        for item in server.ask_stream(
                                req["session_id"], question,
                                req.get("mode", "FCC"),
                                req.get("max_new_tokens", 512)):
                            if isinstance(item, dict):
                                self.wfile.write(b"\x1e")
                                self.wfile.write(json.dumps(item).encode())
                            else:
                                self.wfile.write(item.encode())
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionError, OSError):
                        # the client went away mid-stream: nothing to tell
                        # it; ask_stream's finally committed the session
                        pass
                    except Exception as e:  # noqa: BLE001
                        # headers already sent: an in-band error record,
                        # never a second status line
                        try:
                            self.wfile.write(b"\x1e" + json.dumps(
                                {"error": f"{type(e).__name__}: {e}"}
                            ).encode())
                        except OSError:
                            pass
                    return None
                return self._json(404, {"error": "unknown path"})
            except UnknownSession as e:
                return self._json(404, {"error": str(e)})
            except KeyError as e:
                return self._json(400, {"error": f"missing field {e}"})
            except Exception as e:  # noqa: BLE001
                if _backend_fatal(e):
                    # the CUDA context is lost: tell the client to retry
                    # after the restart, then (supervised) exit so that
                    # the supervisor replaces the process
                    print(f"sticky CUDA error at {time.time():.6f}: "
                          f"{type(e).__name__}: "
                          f"{str(e).splitlines()[0]}",
                          file=sys.stderr, flush=True)
                    self._json(503, {"error": f"{type(e).__name__}: {e}",
                                     "backend_fatal": True,
                                     "recovering": server.supervised})
                    server.request_shutdown(FATAL_EXIT)
                    return None
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):   # quiet
            pass

    return Handler


def make_http_server(server: SessionServer, host: str = "0.0.0.0",
                     port: int = 8787) -> ThreadingHTTPServer:
    """The HTTP server over ``server`` (port 0: a free port, read back
    from ``.server_address``), not yet serving."""
    return ThreadingHTTPServer((host, port), make_handler(server))


def serve(server: SessionServer, port: int = 8787, host: str = "0.0.0.0"):
    t0 = time.perf_counter()
    restored = server.restore_all()
    if restored:
        print(f"restored {len(restored)} session(s) from "
              f"{server.auto_snapshot_dir} in "
              f"{time.perf_counter() - t0:.3f} s: {restored}", flush=True)
    make_http_server(server, host, port).serve_forever()


def run_supervised(child_argv: List[str], max_restarts: int = 20,
                   cooldown_s: float = 2.0) -> int:
    """Supervisor loop: run the serving child and start a new one when it
    dies (rc != 0; rc 17 is the exit after a sticky CUDA error). The
    child sees COGSTREAM_SERVE_SUPERVISED=1, which arms request_shutdown.
    This process only starts processes: it never initializes CUDA, so
    no child inherits a context."""
    env = dict(os.environ)
    env[SUPERVISED_ENV] = "1"
    restarts = 0
    while True:
        rc = subprocess.run(child_argv, env=env).returncode
        if rc == 0:
            return 0
        restarts += 1
        if restarts > max_restarts:
            print(f"serve child died rc={rc}; restart budget "
                  f"({max_restarts}) exhausted", file=sys.stderr)
            return rc
        print(f"serve child died rc={rc}; restarting "
              f"({restarts}/{max_restarts}) after {cooldown_s:g}s",
              file=sys.stderr, flush=True)
        time.sleep(cooldown_s)


def child_argv(argv: List[str]) -> List[str]:
    """The command line of a supervised serving child: this module with
    ``argv`` less ``--supervise``."""
    return [sys.executable, "-m", "cogstream_tpu_torch.runtime.serve"] + [
        a for a in argv if a != "--supervise"]


def quant_flags(args) -> dict:
    """The decoder flags of ``--w8a8-prefill`` and ``--w4a8-decode``,
    checked as the JAX CLIs check them (exits on a flag its
    ``--quantize-weights`` does not allow)."""
    flags = {}
    if args.w8a8_prefill:
        if not args.quantize_weights:
            raise SystemExit("--w8a8-prefill requires --quantize-weights")
        flags["w8a8_prefill"] = True
    if args.w4a8_decode:
        if args.quantize_weights != "int4":
            raise SystemExit("--w4a8-decode requires --quantize-weights int4")
        flags["w4a8_decode"] = True
    return flags


def with_text_flags(cfg, flags: dict):
    """``cfg`` with ``flags`` set on its decoder config."""
    import dataclasses

    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                             **flags))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cogstream_tpu_torch serve")
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--max-len", type=int, default=16384)
    ap.add_argument("--pool-rows", type=int, default=0,
                    help=">0 enables pooled batched serving")
    ap.add_argument("--quantize-weights", choices=("int8", "int4"),
                    help="quantize the decoder at load: int8 per channel "
                         "(K10 decode), int4 rank-1 uniform (K6-K9)")
    ap.add_argument("--w4a8-decode", action="store_true",
                    help="int8-activation decode steps on int4 weights "
                         "(requires --quantize-weights int4)")
    ap.add_argument("--w8a8-prefill", action="store_true",
                    help="int8-activation prefill GEMMs on the quantized "
                         "decoder (requires --quantize-weights)")
    ap.add_argument("--encoder-int8", action="store_true",
                    help="W8A8 vision tower for ingest")
    ap.add_argument("--supervise", action="store_true",
                    help="run under a supervisor: after a sticky CUDA "
                         "error the serving process exits and a new one "
                         "starts; sessions restore from "
                         "--auto-snapshot-dir")
    ap.add_argument("--auto-snapshot-dir",
                    help="snapshot each session after every successful "
                         "/ingest and /ask; start-up restores them all "
                         "(required for --supervise recovery to keep "
                         "streams)")
    ap.add_argument("--restart-cooldown", type=float, default=2.0,
                    help="seconds between supervisor relaunches")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)

    if args.supervise:
        raise SystemExit(run_supervised(child_argv(argv),
                                        cooldown_s=args.restart_cooldown))
    flags = quant_flags(args)
    from ..config import load_generation_config, load_hf_config
    from ..models.checkpoint import load_cogreasoner_from_hf
    from ..processor.tokenizer import load_tokenizer

    cfg = with_text_flags(
        load_hf_config(os.path.join(args.model_dir, "config.json")), flags)
    model = load_cogreasoner_from_hf(
        args.model_dir, cfg,
        quantize_text_bits={"int8": 8, "int4": 4}.get(args.quantize_weights),
        device=args.device)
    tok = load_tokenizer(args.model_dir, cfg.image_token_index,
                         cfg.text.vocab_size)
    eos = load_generation_config(args.model_dir).eos_token_ids
    print(f"serving on {args.host}:{args.port}"
          + (f" (pooled x{args.pool_rows})" if args.pool_rows else ""),
          flush=True)
    serve(SessionServer(model, cfg, tok, max_len=args.max_len,
                        pool_rows=args.pool_rows,
                        extra_eos_ids=tuple(eos or ()),
                        encoder_int8=args.encoder_int8,
                        auto_snapshot_dir=args.auto_snapshot_dir),
          args.port, args.host)


if __name__ == "__main__":
    main()
