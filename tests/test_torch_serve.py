"""The port's HTTP serving front-end (``runtime/serve.py``) on the CPU with
the tiny model: every endpoint over an ephemeral 127.0.0.1 port, the
error codes of the JAX package's tests/test_serve.py, an ingest + ask
over HTTP against the JAX server on the same clip (identical answers and
slot counts), pooled concurrent asks against the port's solo sessions,
row accounting, auto-snapshots and the ``serve`` command line.

Weights come from the JAX initializer through models/bridge.py (f32).
"""

import dataclasses
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from cogstream_tpu.config import (CogReasonerConfig as JConfig,
                                  CompressionConfig as JCompression)
from cogstream_tpu.models.cogreasoner import init_cogreasoner_params
from cogstream_tpu.processor.tokenizer import ByteTokenizer as JTok
from cogstream_tpu.runtime.serve import SessionServer as JServer
from cogstream_tpu_torch.config import (CogReasonerConfig as TConfig,
                                        CompressionConfig as TCompression)
from cogstream_tpu_torch.models import bridge
from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer as TTok
from cogstream_tpu_torch.runtime.serve import (SessionServer,
                                               make_http_server)
from cogstream_tpu_torch.runtime.session import StreamingSession

cv2 = pytest.importorskip("cv2")

COMP = dict(frames_per_event=3, keyframes_per_event=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(JConfig.tiny(),
                               compression=JCompression(**COMP))
    tcfg = dataclasses.replace(TConfig.tiny(),
                               compression=TCompression(**COMP))
    params = init_cogreasoner_params(jax.random.PRNGKey(0), jcfg)
    model = bridge.cogreasoner_from_params(jax.tree.map(np.asarray, params),
                                           tcfg, device="cpu")
    return jcfg, tcfg, params, model


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """An 8 s 64x48 mp4v clip at 10 fps: 3 static scenes with a marker."""
    path = str(tmp_path_factory.mktemp("serve") / "clip.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    rng = np.random.default_rng(0)
    scenes = rng.integers(0, 255, (3, 48, 64, 3), np.uint8)
    for i in range(80):
        f = scenes[min(i // 30, 2)].copy()
        f[:8, :8] = i * 3
        w.write(f)
    w.release()
    return path


def _server(setup, **kw):
    _, tcfg, _, model = setup
    return SessionServer(model, tcfg, TTok(image_token_id=
                                           tcfg.image_token_index), **kw)


@pytest.fixture(scope="module")
def http(setup):
    server = _server(setup, max_len=2048, ingest_chunk_frames=3)
    httpd = make_http_server(server, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    yield server, httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()


def _post(port, path, payload, raw=False):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=payload if raw else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
        return json.loads(r.read())


def _stream(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/ask_stream",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        raw = r.read()
    text, meta = raw.rsplit(b"\x1e", 1)
    return text.decode(), json.loads(meta)


def test_http_endpoints_match_the_jax_server(setup, http, clip, tmp_path):
    """/session, /ingest (the chunked cv2 stream), /ask, /ask_stream,
    /save, /restore and /stats; the answers and slot counts equal the JAX
    server's on the same clip."""
    jcfg, _, params, _ = setup
    server, port = http
    jserver = JServer(params, jcfg, JTok(image_token_id=
                                         jcfg.image_token_index),
                      max_len=2048, use_pallas=False, ingest_chunk_frames=3)
    assert _post(port, "/session", {"session_id": "a"}) == {
        "session_id": "a"}
    jserver.create("a")
    r = _post(port, "/ingest", {"session_id": "a", "video_path": clip,
                                "start": 0.0, "end": 8.0, "fps": 1.0})
    rj = jserver.ingest("a", clip, 0.0, 8.0, 1.0)
    assert r["decode_backend"] == "cv2-thread"
    for key in ("frames", "cache_tokens", "decode_backend"):
        assert r[key] == rj[key], key
    for q, mode in (("what is happening?", "AC"), ("and now?", "FCC")):
        a = _post(port, "/ask", {"session_id": "a", "question": q,
                                 "mode": mode, "max_new_tokens": 6})
        aj = jserver.ask("a", q, mode=mode, max_new_tokens=6)
        assert {k: a[k] for k in aj} == aj and len(a["tokens"]) == 6
    text, meta = _stream(port, {"session_id": "a", "question": "more?",
                                "mode": "AC", "max_new_tokens": 8})
    items = list(jserver.ask_stream("a", "more?", mode="AC",
                                    max_new_tokens=8))
    assert meta == items[-1] and text == "".join(items[:-1])
    assert meta["text"] == text and meta["turn"] == 2

    path = str(tmp_path / "a.snap.npz")
    saved = _post(port, "/save", {"session_id": "a", "path": path})
    assert saved["cache_tokens"] == server.sessions["a"].write_index
    restored = _post(port, "/restore", {"session_id": "b", "path": path})
    assert restored == {"session_id": "b",
                        "cache_tokens": saved["cache_tokens"], "turns": 3}
    a = _post(port, "/ask", {"session_id": "a", "question": "last?",
                             "mode": "AC", "max_new_tokens": 6})
    b = _post(port, "/ask", {"session_id": "b", "question": "last?",
                             "mode": "AC", "max_new_tokens": 6})
    assert a == b
    stats = _get(port, "/stats")
    assert stats["ask"]["n"] == 5 and stats["ingest"]["n"] == 1


def test_http_error_codes(setup, http):
    _, port = http
    _post(port, "/session", {"session_id": "e"})
    cases = [("/ask", {"session_id": "e"}, 400),            # missing field
             ("/ask", {"session_id": "nope", "question": "x"}, 404),
             ("/ask_stream", {"session_id": "nope", "question": "x"}, 404),
             ("/nowhere", {}, 404),
             ("/restore", {"session_id": "e",
                           "path": "/nonexistent/snapshot.npz"}, 500)]
    for path, body, code in cases:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, path, body)
        assert e.value.code == code, path
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/ask", b"{not json", raw=True)
    assert e.value.code == 400
    # a request's lookahead_k (once a 500) answers 200, with the greedy
    # tokens of a vanilla session
    _, tcfg, _, model = setup
    got = _post(port, "/ask", {"session_id": "e", "question": "x",
                               "lookahead_k": 2, "max_new_tokens": 8})
    ref = StreamingSession(model, tcfg, TTok(image_token_id=1000),
                           max_len=2048).ask("x", max_new_tokens=8)
    assert got["tokens"] == ref["tokens"] and got["text"] == ref["text"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/nowhere")
    assert e.value.code == 404


def test_pooled_concurrent_asks_equal_solo_sessions(setup):
    """Two rows ingest concurrently (one batched ingest through the
    frontend) and ask concurrently (one pooled decode); each answer
    equals a solo port session's on the same inputs."""
    _, tcfg, _, model = setup
    server = _server(setup, max_len=1024, pool_rows=3)
    for sid in ("a", "b"):
        server.create(sid)
    rng = np.random.default_rng(0)
    pvs = {sid: rng.integers(0, 255, (3 * 4 * 4, 3 * 14 * 14),
                             dtype=np.uint8) for sid in ("a", "b")}
    stamps = [0.0, 1.0, 2.0]
    gate = threading.Barrier(2)

    def ingest(sid):
        gate.wait()
        server.frontend.ingest(server._row_of[sid], pvs[sid], (3, 4, 4), 2,
                               stamps)

    questions = {"a": "what is happening?", "b": "who is there?"}
    results = {}

    def ask(sid):
        gate.wait()
        results[sid] = server.ask(sid, questions[sid], mode="AC",
                                  max_new_tokens=6)

    for fn in (ingest, ask):
        ths = [threading.Thread(target=fn, args=(s,)) for s in ("a", "b")]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=300)
    assert server.stats()["ask_batches"] == {"n": 1, "max_rows": 2}
    tok = TTok(image_token_id=tcfg.image_token_index)
    for sid, q in questions.items():
        solo = StreamingSession(model, tcfg, tok, max_len=1024)
        solo.append_stream_segment(pvs[sid], (3, 4, 4), 2, stamps)
        want = solo.ask(q, mode="AC", max_new_tokens=6)
        assert results[sid]["text"] == want["text"]
        assert results[sid]["turn"] == 0
    # a streamed ask on a pooled row, then a batched one, stay consistent
    items = list(server.ask_stream("a", "and now?", mode="AC",
                                   max_new_tokens=8))
    assert "".join(items[:-1]) == items[-1]["text"]
    assert server.ask("a", "again?", mode="AC",
                      max_new_tokens=4)["turn"] == 2
    server.close()
    assert not server.frontend._thread.is_alive()


def test_pool_rows_do_not_leak(setup, tmp_path):
    """A create over an existing id releases its row; restores run twice
    over one id keep one row; a failed restore is transactional."""
    server = _server(setup, max_len=512, pool_rows=2)
    for _ in range(4):
        server.create("a")
    assert len(server.pool.sessions) == 1
    path = str(tmp_path / "a.npz")
    server.save_session("a", path)
    for _ in range(2):
        server.restore_session("a", path)
    assert len(server.pool.sessions) == 1
    old = server._row_of["a"]
    with pytest.raises(Exception):
        server.restore_session("a", "/nonexistent/snapshot.npz")
    assert server._row_of["a"] == old and len(server.pool.sessions) == 1
    sid = server.create()["session_id"]
    assert sid != "a" and len(server.pool.sessions) == 2
    assert isinstance(server.ask("a", "alive?", mode="AC",
                                 max_new_tokens=3)["text"], str)
    server.close()


def test_auto_snapshots_restore_at_start(setup, tmp_path):
    snaps = str(tmp_path / "snaps")
    server = _server(setup, max_len=512, auto_snapshot_dir=snaps)
    server.create("x")
    server.ask("x", "hello?", mode="AC", max_new_tokens=4)
    assert os.listdir(snaps) == ["x.snap.npz"]
    fresh = _server(setup, max_len=512, pool_rows=2, auto_snapshot_dir=snaps)
    assert fresh.restore_all() == ["x"]
    s = fresh.sessions["x"]
    assert s.hist_qs == ["hello?"]
    assert s.write_index == server.sessions["x"].write_index
    fresh.close()


def test_ingest_frame_dir_and_worker_error(setup, clip, tmp_path,
                                           monkeypatch):
    """A frame directory takes the buffered path (no stream); a failure
    inside the preprocess worker surfaces as the ingest's exception and
    leaves the server usable."""
    from cogstream_tpu_torch.processor import image_processor

    server = _server(setup, max_len=2048, ingest_chunk_frames=2)
    server.create("x")
    d = tmp_path / "frames"
    d.mkdir()
    rng = np.random.default_rng(1)
    for i in range(3):
        np.save(d / f"{i:03d}.npy", rng.integers(0, 255, (48, 64, 3),
                                                 np.uint8))
    r = server.ingest("x", str(d), None, None, 1.0)
    assert r["decode_backend"] == "buffered" and r["frames"] == 3

    calls = {"n": 0}
    orig = image_processor.ImageProcessor.__call__

    def boom(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] >= 2:      # the second chunk, mid-stream
            raise RuntimeError("preprocess exploded")
        return orig(self, *a, **kw)

    monkeypatch.setattr(image_processor.ImageProcessor, "__call__", boom)
    with pytest.raises(RuntimeError, match="preprocess exploded"):
        server.ingest("x", clip, 0.0, 6.0, 1.0)
    monkeypatch.setattr(image_processor.ImageProcessor, "__call__", orig)
    assert server.ingest("x", clip, 0.0, 2.0, 1.0)["frames"] >= 2


def test_server_refuses_unported_options(setup, monkeypatch):
    """Options of other queue items still raise naming their item;
    ``encoder_int8`` (once refused) builds ONE W8A8 copy of the tower that
    the solo sessions and the pool share, and leaves the model's own;
    ``lookahead_k`` (once refused) is the server's default for solo asks,
    a request's value overriding it, with a vanilla session's answers; a
    pool with an fp8 cache (``kv_dtype``, once refused) answers as JAX's
    fp8 pool does."""
    import cogstream_tpu_torch.runtime.session as tsess_mod

    _, tcfg, _, model = setup
    server = _server(setup, encoder_int8=True, pool_rows=2, max_len=512)
    sess = server._mk()
    assert sess.model.vision.int8 and server.pool.model.vision is \
        sess.model.vision
    assert not model.vision.int8
    used = []
    real = tsess_mod.generate_tokens_lookahead
    monkeypatch.setattr(tsess_mod, "generate_tokens_lookahead",
                        lambda *a, **kw: used.append(kw["lookahead_k"])
                        or real(*a, **kw))
    la = _server(setup, lookahead_k=2, max_len=512)
    la.create("s")
    ref = StreamingSession(model, tcfg, TTok(image_token_id=1000),
                           max_len=512)
    for q, k in (("what?", None), ("and then?", 0), ("more?", 3)):
        got = la.ask("s", q, mode="AC", max_new_tokens=8, lookahead_k=k)
        want = ref.ask(q, mode="AC", max_new_tokens=8)
        assert (got["tokens"], got["cache_tokens"]) == \
            (want["tokens"], want["cache_tokens"])
    assert used == [2, 3]
    with pytest.raises(NotImplementedError, match="#9"):
        _server(setup, mesh=object())
    # an fp8 pool (once refused) builds an e4m3 cache and answers as JAX's
    from cogstream_tpu.runtime.pool import SessionPool as JPool
    from cogstream_tpu_torch.runtime.pool import SessionPool
    jcfg, _, params, _ = setup
    tp = SessionPool(model, tcfg, TTok(image_token_id=tcfg.image_token_index),
                     n_rows=2, max_len=512, kv_dtype=torch.float8_e4m3fn)
    jp = JPool(params, jcfg, JTok(image_token_id=jcfg.image_token_index),
               n_rows=2, max_len=512, kv_dtype=jax.numpy.float8_e4m3fn)
    assert tp.cache.k.dtype == tp.cache.v.dtype == torch.float8_e4m3fn
    pix = np.random.default_rng(3).normal(size=(48, 588)).astype(np.float32)
    for p in (tp, jp):
        p.open()
        p.ingest(0, pix, (3, 4, 4), 2, [0.0, 1.0, 2.0])
    got = tp.ask_batch([(0, "what?")], mode="AC", max_new_tokens=8)[0]
    want = jp.ask_batch([(0, "what?")], mode="AC", max_new_tokens=8)[0]
    assert (got["text"], got["cache_tokens"]) == \
        (want["text"], want["cache_tokens"])


def test_serve_cli(tmp_path, capsys, monkeypatch):
    """``serve`` left the unported list: ``--help`` prints its options,
    ``--supervise`` hands the supervisor the child's command line, and the
    quantized modes load as JAX's CLI loads them: ``--w8a8-prefill``
    needs ``--quantize-weights``; ``--quantize-weights int8 --w8a8-prefill
    --encoder-int8`` serves an int8 decoder under w8a8_prefill with a
    W8A8 tower."""
    from cogstream_tpu_torch import __main__ as tmain
    from cogstream_tpu_torch.models.checkpoint import save_cogreasoner_to_hf
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params
    from cogstream_tpu_torch.runtime import serve as serve_mod

    assert "serve" not in tmain.NOT_PORTED
    with pytest.raises(SystemExit) as e:
        tmain.main(["serve", "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--pool-rows" in out and "--auto-snapshot-dir" in out
    base = ["serve", "--model-dir", str(tmp_path)]
    # --supervise runs the supervisor loop over a child command line
    # without the flag, and touches no CUDA state itself
    runs = []
    monkeypatch.setattr(serve_mod, "run_supervised",
                        lambda argv, cooldown_s: runs.append(
                            (argv, cooldown_s)) or 0)
    with pytest.raises(SystemExit) as e:
        tmain.main(base + ["--supervise", "--restart-cooldown", "0.5"])
    assert e.value.code == 0
    assert runs == [([sys.executable, "-m", "cogstream_tpu_torch.runtime.serve",
                      "--model-dir", str(tmp_path), "--restart-cooldown",
                      "0.5"], 0.5)]
    assert not torch.cuda.is_initialized()
    with pytest.raises(SystemExit, match="requires --quantize-weights int4"):
        tmain.main(base + ["--w4a8-decode"])
    with pytest.raises(SystemExit, match="requires --quantize-weights$"):
        tmain.main(base + ["--w8a8-prefill"])
    cfg = TConfig.tiny()
    save_cogreasoner_to_hf(init_cogreasoner_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), cfg,
        str(tmp_path))
    served = []
    monkeypatch.setattr(serve_mod, "serve",
                        lambda server, *a, **k: served.append(server))
    tmain.main(base + ["--quantize-weights", "int8", "--w8a8-prefill",
                       "--encoder-int8", "--device", "cpu"])
    sess = served[0]._mk()
    assert sess.model.text.cfg.w8a8_prefill
    assert sess.model.text.int8["gate_proj"].q.dtype == torch.int8
    assert sess.model.vision.int8
