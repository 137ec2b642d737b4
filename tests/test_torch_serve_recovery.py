"""Supervised serving of the port (``serve --supervise``) on the CPU.

The fatal-error predicate ``_backend_fatal`` (True only for torch's CUDA
error type or the port's ``KernelError`` with a sticky ``cudaError``
code), the fault injection, the 503 branch, the batching frontend's
error hand-off, and the whole recovery chain of the JAX package's
tests/test_serve_recovery.py through the real command line:

  healthy ingest + ask -> snapshot -> fault in the middle of the second
  ingest -> the client gets 503 {"backend_fatal": true, "recovering":
  true} -> the child exits 17 -> the supervisor starts a new one -> it
  restores the session -> the next ask has turn 1 and the tokens of an
  unfaulted control server,

solo and pooled (``--pool-rows 2``), on a tiny checkpoint written by the
JAX package's exporter; and once as a tensor-parallel world under
``torchrun --nproc-per-node 2 --max-restarts 1`` (gloo on the CPU), whose
elastic agent is the supervisor.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from cogstream_tpu.config import CogReasonerConfig as JConfig
from cogstream_tpu.models.checkpoint import save_cogreasoner_to_hf
from cogstream_tpu.models.cogreasoner import init_cogreasoner_params
from cogstream_tpu_torch.ops.kernels import KernelError
from cogstream_tpu_torch.runtime import serve as serve_mod
from cogstream_tpu_torch.runtime.serve import (BatchingFrontend, FAULT_ENV,
                                               _backend_fatal, inject_fault)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _accel(msg: str, code=None):
    e = torch.AcceleratorError(msg)
    if code is not None:
        e.error_code = code
    return e


# ---------------------------------------------------------------------------
# the predicate
# ---------------------------------------------------------------------------

FATAL = {
    "illegal address": _accel("CUDA error: an illegal memory access was "
                              "encountered", 700),
    "device-side assert": _accel("CUDA error: device-side assert triggered",
                                 710),
    "illegal instruction": _accel("CUDA error: an illegal instruction was "
                                  "encountered", 715),
    "misaligned address": _accel("CUDA error: misaligned address", 716),
    "launch failure": _accel("CUDA error: unspecified launch failure", 719),
    "launch timeout": _accel("CUDA error: the launch timed out and was "
                             "terminated", 702),
    "uncorrectable ECC": _accel("CUDA error: uncorrectable ECC error "
                                "encountered", 214),
    "invalid pc": _accel("CUDA error: invalid program counter", 718),
    "kernel, illegal address": KernelError("cs_gqa_decode_tc", 700),
    "kernel, device-side assert": KernelError("cs_layernorm", 710),
}

NOT_FATAL = {
    "out of memory": torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"),
    "plain RuntimeError naming a CUDA error": RuntimeError(
        "CUDA error: an illegal memory access was encountered"),
    "ValueError naming an illegal access": ValueError(
        "upstream said: illegal memory access"),
    "RuntimeError naming a device-side assert": RuntimeError(
        "CUDA error: device-side assert triggered"),
    "torch error, out-of-memory code": _accel(
        "CUDA error: out of memory", 2),
    "torch error, invalid value": _accel("CUDA error: invalid argument", 1),
    "torch error without a code": _accel(
        "CUDA error: device-side assert triggered"),
    "kernel refused its launch": KernelError("cs_vision_attention_tc", 9),
    "kernel out of resources": KernelError("cs_gqa_prefill_tc", 701),
    "KeyError": KeyError("session_id"),
}


@pytest.mark.parametrize("name", sorted(FATAL))
def test_backend_fatal_true_for_sticky_cuda_errors(name):
    assert _backend_fatal(FATAL[name]) is True


@pytest.mark.parametrize("name", sorted(NOT_FATAL))
def test_backend_fatal_false_for_other_errors(name):
    assert _backend_fatal(NOT_FATAL[name]) is False


def test_kernel_error_keeps_its_message_and_type():
    """``kernels.check`` raises the typed error with the message it
    always had; it is still a RuntimeError for older handlers."""
    from cogstream_tpu_torch.ops import kernels

    with pytest.raises(KernelError) as ei:
        kernels.check(710, "cs_layernorm")
    assert isinstance(ei.value, RuntimeError) and ei.value.code == 710
    assert str(ei.value) == ("CUDA kernel cs_layernorm failed to launch: "
                             "cudaError 710")
    kernels.check(0, "cs_layernorm")


def test_injected_cpu_fault_is_backend_fatal():
    with pytest.raises(torch.AcceleratorError) as ei:
        inject_fault(torch.device("cpu"))
    assert ei.value.error_code == 710
    assert "device-side assert triggered" in str(ei.value)
    assert _backend_fatal(ei.value)


def test_frontend_hands_the_same_error_to_the_request_thread():
    """An error raised in the batching frontend's thread (the pool's
    ingest or ask) reaches the request's thread as the same object, so
    the handler's 503 branch sees the sticky error."""
    err = _accel("CUDA error: an illegal memory access was encountered", 700)

    class Pool:
        def ingest(self, *a):
            raise err

        def ask_batch(self, *a, **kw):
            raise err

    fe = BatchingFrontend(Pool())
    try:
        for call in (lambda: fe.ingest(0, None, (1, 2, 2), 2, [0.0]),
                     lambda: fe.ask(0, "q?")):
            with pytest.raises(torch.AcceleratorError) as ei:
                call()
            assert ei.value is err
    finally:
        fe.close()


def test_unsupervised_server_answers_503_and_stays_up(monkeypatch, tmp_path):
    """Outside supervision the 503 says ``recovering: false``, the exit
    code is only recorded, and the server keeps answering; the failed
    ingest writes no snapshot."""
    from cogstream_tpu_torch.config import CogReasonerConfig
    from cogstream_tpu_torch.models.cogreasoner import \
        init_cogreasoner_params as tinit
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer

    monkeypatch.setenv(FAULT_ENV, "1")
    monkeypatch.delenv(serve_mod.SUPERVISED_ENV, raising=False)
    cfg = CogReasonerConfig.tiny()
    model = tinit(cfg, torch.Generator().manual_seed(0), device="cpu")
    server = serve_mod.SessionServer(
        model, cfg, ByteTokenizer(image_token_id=cfg.image_token_index),
        max_len=512, auto_snapshot_dir=str(tmp_path / "snaps"))
    httpd = serve_mod.make_http_server(server, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    port = httpd.server_address[1]
    try:
        frames = tmp_path / "frames"
        frames.mkdir()
        rng = np.random.default_rng(0)
        for i in range(2):
            np.save(frames / f"{i:03d}.npy",
                    rng.integers(0, 255, (56, 56, 3), np.uint8))
        assert _post(port, "/session", {"session_id": "a"}) == \
            {"session_id": "a"}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/ingest", {"session_id": "a",
                                    "video_path": str(frames)})
        assert ei.value.code == 503
        body = json.loads(ei.value.read())
        assert body["backend_fatal"] is True and body["recovering"] is False
        assert "device-side assert triggered" in body["error"]
        assert server.exit_code == 17 and not server.supervised
        assert not os.listdir(tmp_path / "snaps")
        r = _post(port, "/ask", {"session_id": "a", "question": "q?",
                                 "mode": "AC", "max_new_tokens": 2})
        assert r["turn"] == 0
    finally:
        httpd.shutdown()
        httpd.server_close()


# ---------------------------------------------------------------------------
# the chain through the real command line
# ---------------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post(port, path, payload, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _wait_up(port, proc, deadline_s=120):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        assert proc.poll() is None, f"server exited rc={proc.returncode}"
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/stats", timeout=5):
                return
        except (urllib.error.URLError, ConnectionError, OSError):
            time.sleep(0.2)
    raise TimeoutError("server did not come up")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("recovery_ckpt"))
    cfg = JConfig.tiny()
    save_cogreasoner_to_hf(init_cogreasoner_params(jax.random.PRNGKey(0),
                                                   cfg), cfg, d)
    return d


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 32 s 64x64 mp4v clip at 2 fps: a moving marker on a seeded
    background."""
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path_factory.mktemp("recovery_clip") / "clip.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 2, (64, 64))
    base = np.random.default_rng(0).integers(0, 255, (64, 64, 3), np.uint8)
    for i in range(64):
        f = base.copy()
        f[:16, :16] = (i * 7) % 255
        w.write(f)
    w.release()
    return path


def _spawn(argv, env, log):
    return subprocess.Popen(
        [sys.executable, "-m", "cogstream_tpu_torch", "serve"] + argv,
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)


def _stop(proc):
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait(timeout=30)


ASK = {"mode": "AC", "max_new_tokens": 6}


@pytest.mark.parametrize("pool_rows", [0, 2], ids=["solo", "pooled"])
def test_supervised_serve_recovers_through_the_cli(ckpt, clip, tmp_path,
                                                   pool_rows):
    snapdir = str(tmp_path / "snaps")
    env = {k: v for k, v in os.environ.items()
           if k not in (FAULT_ENV, serve_mod.SUPERVISED_ENV)}
    env.update(OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    common = ["--model-dir", ckpt, "--device", "cpu", "--host", "127.0.0.1",
              "--max-len", "2048"]
    if pool_rows:
        common += ["--pool-rows", str(pool_rows)]
    port, cport = _free_port(), _free_port()
    sup_log = open(tmp_path / "supervisor.log", "w+")
    ctl_log = open(tmp_path / "control.log", "w+")
    # the first ingest (8 frames at 1 fps) is one 16-frame chunk, the
    # second (24 frames) two: dispatch 3 faults in the middle of it
    sup = _spawn(common + ["--port", str(port), "--supervise",
                           "--auto-snapshot-dir", snapdir,
                           "--restart-cooldown", "0.2"],
                 {**env, FAULT_ENV: "3"}, sup_log)
    ctl = _spawn(common + ["--port", str(cport)], env, ctl_log)
    ingest1 = {"session_id": "s1", "video_path": clip, "start": 0.0,
               "end": 8.0, "fps": 1.0}
    ingest2 = dict(ingest1, start=8.0, end=32.0)
    try:
        _wait_up(port, sup)
        _wait_up(cport, ctl)
        ref = []
        for p in (port, cport):
            assert _post(p, "/session", {"session_id": "s1"}) == \
                {"session_id": "s1"}
            r = _post(p, "/ingest", ingest1)
            assert r["frames"] == 8 and r["cache_tokens"] > 0
            r = _post(p, "/ask", {"session_id": "s1",
                                  "question": "what happened?", **ASK})
            assert r["turn"] == 0
            ref.append(r)
        assert ref[0]["tokens"] == ref[1]["tokens"]
        snap = os.path.join(snapdir, "s1.snap.npz")
        assert os.path.exists(snap)
        before = os.path.getmtime(snap)

        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/ingest", ingest2)
        assert ei.value.code == 503
        body = json.loads(ei.value.read())
        assert body["backend_fatal"] is True
        assert body["recovering"] is True
        assert "device-side assert triggered" in body["error"]
        # the failed request wrote no snapshot
        assert os.path.getmtime(snap) == before

        # the supervisor replaces the child; the new one restores s1
        t0 = time.monotonic()
        while time.monotonic() - t0 < 60:
            sup_log.seek(0)
            if "serve child died rc=17" in sup_log.read():
                break
            time.sleep(0.2)
        _wait_up(port, sup)
        got = _post(port, "/ask", {"session_id": "s1",
                                   "question": "and now?", **ASK})
        want = _post(cport, "/ask", {"session_id": "s1",
                                     "question": "and now?", **ASK})
        assert got["turn"] == want["turn"] == 1
        assert got["tokens"] == want["tokens"]
        assert got["cache_tokens"] == want["cache_tokens"]
        sup_log.seek(0)
        log = sup_log.read()
        assert "serve child died rc=17; restarting (1/20)" in log, log
        assert "restored 1 session(s)" in log, log
    finally:
        _stop(sup)
        _stop(ctl)
        sup_log.close()
        ctl_log.close()


def test_supervised_mesh_serve_recovers_under_torchrun(ckpt, clip, tmp_path):
    """``serve --supervise`` under ``torchrun --nproc-per-node 2
    --max-restarts 1`` (tensor-parallel over gloo on the CPU): the elastic
    agent is the supervisor. The injected fault on rank 0's third ingest
    dispatch gives a 503 with ``recovering: true``; both ranks take the
    exit-17 path, the agent starts a new world (whose ranks do not find
    the old world's failure key), its rank 0 restores the session from
    the auto-snapshot dir, and the next ask has turn 1 and the tokens of
    an unfaulted control world. The new world's fault counter starts
    again and the check dispatches no ingest, so the fault does not fire
    again before it."""
    snapdir = str(tmp_path / "snaps")
    env = {k: v for k, v in os.environ.items()
           if k not in (FAULT_ENV, serve_mod.SUPERVISED_ENV)
           and not k.startswith(("RANK", "WORLD_SIZE", "MASTER_",
                                 "LOCAL_RANK", "TORCHELASTIC"))}
    env.update(OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    common = ["--model-dir", ckpt, "--device", "cpu", "--host", "127.0.0.1",
              "--max-len", "2048", "--auto-snapshot-dir"]

    def world(port, snaps, log, extra_env):
        return subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "--max-restarts", "1", "-m",
             "cogstream_tpu_torch.runtime.serve", *common, snaps, "--port",
             str(port), "--supervise"],
            cwd=ROOT, env={**env, **extra_env}, stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True)

    port, cport = _free_port(), _free_port()
    log = open(tmp_path / "world.log", "w+")
    ctl_log = open(tmp_path / "control.log", "w+")
    # the first ingest (8 frames at 1 fps) is one 16-frame chunk, the
    # second (24 frames) two: dispatch 3 faults in the middle of it
    sup = world(port, snapdir, log, {FAULT_ENV: "3"})
    ctl = world(cport, str(tmp_path / "ctl_snaps"), ctl_log, {})
    ingest1 = {"session_id": "s1", "video_path": clip, "start": 0.0,
               "end": 8.0, "fps": 1.0}
    ingest2 = dict(ingest1, start=8.0, end=32.0)
    try:
        _wait_up(port, sup)
        _wait_up(cport, ctl)
        ref = []
        for p in (port, cport):
            assert _post(p, "/session", {"session_id": "s1"}) == \
                {"session_id": "s1"}
            assert _post(p, "/ingest", ingest1)["frames"] == 8
            ref.append(_post(p, "/ask", {"session_id": "s1",
                                         "question": "what happened?",
                                         **ASK}))
        assert ref[0]["tokens"] == ref[1]["tokens"]
        snap = os.path.join(snapdir, "s1.snap.npz")
        before = os.path.getmtime(snap)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/ingest", ingest2)
        assert ei.value.code == 503
        body = json.loads(ei.value.read())
        assert body["backend_fatal"] is True and body["recovering"] is True
        assert "device-side assert triggered" in body["error"]
        assert os.path.getmtime(snap) == before
        t0 = time.monotonic()
        while time.monotonic() - t0 < 60:
            log.seek(0)
            if "restored 1 session(s)" in log.read():
                break
            time.sleep(0.2)
        _wait_up(port, sup)
        got = _post(port, "/ask", {"session_id": "s1",
                                   "question": "and now?", **ASK})
        want = _post(cport, "/ask", {"session_id": "s1",
                                     "question": "and now?", **ASK})
        assert got["turn"] == want["turn"] == 1
        assert got["tokens"] == want["tokens"]
        assert got["cache_tokens"] == want["cache_tokens"]
        log.seek(0)
        text = log.read()
        for r in (0, 1):
            assert text.count(f"rank {r}: exit 17") == 1, text
        assert text.count("restored 1 session(s)") == 1, text
        assert text.count("sticky CUDA error at") == 1, text
        assert sup.poll() is None
    finally:
        _stop(sup)
        _stop(ctl)
        log.close()
        ctl_log.close()
