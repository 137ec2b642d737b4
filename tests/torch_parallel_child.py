"""One rank of a tensor-parallel world for tests/test_torch_parallel.py.

Imports only the port. The parent test writes the inputs (the JAX
package's seeded weights as flat ``.npz`` trees, a frame directory and an
HF checkpoint) into ``--dir``; every rank of a gloo world on the CPU
(``--world`` 2 or 4) builds the same objects, runs the same cases on its
shard, and writes what it saw to ``--dir/w<world>_r<rank>.{json,npz}``,
which the parent holds to the JAX package's mesh results.

    python tests/torch_parallel_child.py --world 2 --rank R --port P --dir D
    python tests/torch_parallel_child.py --world 2 --rank R --port P --dir D \
        --fault early|mid
    python tests/torch_parallel_child.py --world 4 --rank R --port P --dir D \
        --fault dp
"""

import argparse
import dataclasses
import json
import os
import sys
import threading
import traceback
import urllib.error
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

COMP = dict(frames_per_event=2, keyframes_per_event=1)
SEG = (2, 4, 4)
QUESTION = "what is this?"
CONVERSATION = [{"role": "user", "content": "hello, what now?"}]
# the fault worlds' process-group timeout: their followers idle past it
# between requests, and their failures end both ranks well before it
FAULT_GROUP_TIMEOUT_S = 10


def _leaves(tree):
    from cogstream_tpu_torch.models.lora import iter_leaves

    return iter_leaves(tree)


def unflatten(path: str):
    """A ``/``-keyed flat npz back into the nested tree (integer keys are
    list indices)."""
    tree: dict = {}
    with np.load(path) as d:
        for key in d.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = d[key]

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(tree)


CONT = "and now?"
# the int4 decoder's int8-activation modes, and the forwards' lengths
W4A8_MODES = {"w4a8_decode": {"w4a8_decode": True},
              "w8a8_prefill": {"w8a8_prefill": True},
              "both": {"w4a8_decode": True, "w8a8_prefill": True}}
W4A8_LENGTHS = (8, 16)
HIST_CONVERSATION = [
    {"role": "user", "content": "what is the first scene?"},
    {"role": "assistant", "content": "a noisy pattern."},
    {"role": "user", "content": "and what came after it?"}]
# how long a rank waits for a snapshot the JAX side writes meanwhile
JAX_SNAPSHOT_WAIT_S = 200


def wait_for(path: str) -> str:
    import time

    deadline = time.time() + JAX_SNAPSHOT_WAIT_S
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"{path} was not written")
        time.sleep(0.2)
    time.sleep(0.2)
    return path


class Rank:
    def __init__(self, args):
        from cogstream_tpu_torch.config import (CogReasonerConfig,
                                                CompressionConfig)
        from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer

        self.args = args
        self.dir = args.dir
        self.cfg = dataclasses.replace(
            CogReasonerConfig.tiny(), compression=CompressionConfig(**COMP))
        self.tok = ByteTokenizer(image_token_id=self.cfg.image_token_index)
        self.out: dict = {}
        self.arrays: dict = {}
        self.pv = np.load(os.path.join(self.dir, "pv.npy"))

    def model(self, name: str = "params"):
        return self.model_as(self.cfg, name)

    def model_as(self, cfg, name: str = "params"):
        from cogstream_tpu_torch.models import bridge

        return bridge.cogreasoner_from_params(
            unflatten(os.path.join(self.dir, f"{name}.npz")), cfg,
            device="cpu")

    def adapters(self, *names):
        """The JAX package's seeded adapters (bridged), by serving name."""
        from cogstream_tpu_torch.models import bridge

        files = {"language_module": "lora_lang", "full_module": "lora_full"}
        return {n: bridge.lora_from_params(
            unflatten(os.path.join(self.dir, f"{files[n]}.npz")),
            device="cpu") for n in names}

    def flags(self, **kw):
        return dataclasses.replace(
            self.cfg, text=dataclasses.replace(self.cfg.text, **kw))

    # -- cases ------------------------------------------------------------

    def session(self, tag, mesh, model, cfg=None, lookahead=True, **kw):
        from cogstream_tpu_torch.runtime.session import StreamingSession

        sess = StreamingSession(model, cfg or self.cfg, self.tok,
                                max_len=1024, summary_forward=False,
                                mesh=mesh, **kw)
        sess.append_stream_segment(self.pv, SEG, 2, [0.0, 1.0])
        a = sess.ask(QUESTION, mode="AC", max_new_tokens=6)
        res = {"text": a["text"], "tokens": a["tokens"],
               "cache_tokens": a["cache_tokens"]}
        if lookahead:
            la = sess.ask(QUESTION, mode="AC", max_new_tokens=6,
                          lookahead_k=4)
            res.update(la_text=la["text"], la_tokens=la["tokens"],
                       la_steps=sess.last_lookahead_steps,
                       la_cache_tokens=la["cache_tokens"])
        c = sess.cache
        # copies: later asks write the cache in place
        if c.k.dtype == torch.float32:
            self.arrays[f"{tag}_k"] = c.k.numpy().copy()
            self.arrays[f"{tag}_v"] = c.v.numpy().copy()
        self.arrays[f"{tag}_pos"] = c.pos.numpy().copy()
        res["kv_heads"] = list(sess.model.text.tp.kv_heads)
        self.out[tag] = res
        return sess

    def snapshot(self, tag, sess, mesh, model, cfg=None, **kw):
        """``sess.save`` (rank 0 writes ``<tag>.snap.npz``), each rank's
        live K/V bytes beside it, then the continuation ``CONT`` asked of
        ``sess`` and of a fresh sharded session restored from the file."""
        from cogstream_tpu_torch.runtime.session import StreamingSession

        path = os.path.join(self.dir, f"{tag}.snap.npz")
        sess.save(path)
        wi = sess.write_index
        for name in ("k", "v"):
            self.arrays[f"{tag}_snap{name}"] = getattr(
                sess.cache, name)[:, 0, :wi].contiguous().view(
                    torch.uint8).numpy()
        fresh = StreamingSession(model, cfg or self.cfg, self.tok,
                                 max_len=1024, summary_forward=False,
                                 mesh=mesh, **kw)
        fresh.load_state(path)
        res = {"kv_heads": list(sess.model.text.tp.kv_heads),
               "writer": os.path.exists(path) and mesh.model_index == 0}
        for key, s_ in (("cont", sess), ("restored", fresh)):
            a = s_.ask(CONT, mode="AC", max_new_tokens=6)
            res[key] = {"text": a["text"], "tokens": a["tokens"],
                        "cache_tokens": a["cache_tokens"]}
        self.out[f"{tag}_snap"] = res

    def jax_snapshot(self, tag, mesh, model):
        """The JAX mesh session's snapshot (written by the parent while
        this world runs) restored into a sharded session: ``CONT``."""
        from cogstream_tpu_torch.runtime.session import StreamingSession

        sess = StreamingSession(model, self.cfg, self.tok, max_len=1024,
                                summary_forward=False, mesh=mesh)
        sess.load_state(wait_for(os.path.join(self.dir,
                                              f"j{tag}.snap.npz")))
        a = sess.ask(CONT, mode="AC", max_new_tokens=6)
        self.out[f"{tag}_jsnap"] = {"text": a["text"], "tokens": a["tokens"],
                                    "cache_tokens": a["cache_tokens"]}

    def refused_snapshot(self, mesh, model):
        """A snapshot that does not fit fails on every rank alike, and
        the session keeps its state."""
        from cogstream_tpu_torch.parallel.mesh import AgreedError
        from cogstream_tpu_torch.runtime.session import StreamingSession

        sess = StreamingSession(model, self.cfg, self.tok, max_len=160,
                                summary_forward=False, mesh=mesh)
        before = sess.write_index
        try:
            sess.load_state(os.path.join(self.dir, "session2.snap.npz"))
            res = None
        except AgreedError as e:
            res = {"error": str(e), "kept": sess.write_index == before}
        self.out["refused_snapshot"] = res

    def forward(self, tag, model, mesh):
        """Hidden states and this rank's logits slice of one prompt."""
        from cogstream_tpu_torch.models import qwen2
        from cogstream_tpu_torch.parallel.sharding import shard_cogreasoner

        text = shard_cogreasoner(model, self.cfg, mesh).text
        ids = torch.from_numpy(np.load(os.path.join(self.dir, "ids.npy")))
        pos = torch.arange(ids.shape[1], dtype=torch.int32)[None]
        h, _ = qwen2.qwen2_forward(text, qwen2.embed(text, ids), pos)
        self.arrays[f"{tag}_hidden"] = h.numpy()
        self.arrays[f"{tag}_logits"] = qwen2.lm_logits(text, h).numpy()
        self.out[tag] = {"vocab": list(text.tp.vocab or (0, 0))}

    def generate(self, model, mesh):
        from cogstream_tpu_torch.models import qwen2
        from cogstream_tpu_torch.parallel.sharding import shard_cogreasoner
        from cogstream_tpu_torch.runtime.generate import generate_tokens

        text = shard_cogreasoner(model, self.cfg, mesh).text
        ids = torch.from_numpy(np.load(os.path.join(self.dir, "ids.npy")))
        S, new = ids.shape[1], 8
        cache = qwen2.init_kv_cache(self.cfg.text, 1, S + new, device="cpu",
                                    kv_heads=qwen2.local_kv_heads(text))
        res = generate_tokens(
            text, qwen2.embed(text, ids),
            torch.arange(S, dtype=torch.int32)[None],
            torch.tensor([S - 1]), cache, None, new, eos_id=-1)
        self.out["generate"] = {"tokens": res.tokens[0].tolist()}

    def quant_forward(self, tag, model, mesh, cfg):
        """Hidden states and this rank's logits slice of the prompt at S =
        16 (a prefill-length program) and its first 8 tokens (a
        decode-length one) through the sharded decoder under ``cfg``'s
        serving flags; the head under ``w4a8_decode``, as decode loops
        run it."""
        from cogstream_tpu_torch.models import qwen2
        from cogstream_tpu_torch.models.cogreasoner import with_serving_flags
        from cogstream_tpu_torch.parallel.sharding import shard_cogreasoner

        text = with_serving_flags(shard_cogreasoner(model, cfg, mesh),
                                  cfg).text
        ids = torch.from_numpy(np.load(os.path.join(self.dir, "ids.npy")))
        for S in W4A8_LENGTHS:
            pos = torch.arange(S, dtype=torch.int32)[None]
            h, _ = qwen2.qwen2_forward(text, qwen2.embed(text, ids[:, :S]),
                                       pos)
            self.arrays[f"{tag}_s{S}_hidden"] = h.numpy()
            self.arrays[f"{tag}_s{S}_logits"] = qwen2.lm_logits(
                text, h, w8a8=cfg.text.w4a8_decode).numpy()

    def int4_w4a8(self, model, mesh, world):
        """The rank-1 int4 decoder's shards under ``w4a8_decode``,
        ``w8a8_prefill`` and both: a session (AC) and the forwards of
        :meth:`quant_forward`. At tp = 4 the mode controls: the forwards
        weight-only, and under both flags with each rank's halves
        quantized at their own (local) scales."""
        from cogstream_tpu_torch.models import qwen2

        for mode, flags in W4A8_MODES.items():
            cfg = self.flags(**flags)
            self.session(f"int4_{mode}{world}", mesh, model, cfg=cfg,
                         lookahead=False)
            self.quant_forward(f"int4f_{mode}{world}", model, mesh, cfg)
        if world != 4:
            return
        self.quant_forward("int4f_weight_only4", model, mesh, self.cfg)
        shards = qwen2.row_shards
        qwen2.row_shards = lambda text: {"o_proj": None, "down_proj": None}
        try:
            self.quant_forward("int4f_local_scales4", model, mesh,
                               self.flags(**W4A8_MODES["both"]))
        finally:
            qwen2.row_shards = shards

    def snapshot_io(self):
        """Record every snapshot file this rank writes and reads (paths
        relative to ``--dir``) under ``out["snapshot_io"]``."""
        from cogstream_tpu_torch.runtime.session import StreamingSession

        io = self.out["snapshot_io"] = {"written": [], "read": []}
        write, read = (StreamingSession._write_snapshot,
                       StreamingSession._read_snapshot)

        def spy_write(sess, path, *a):
            io["written"].append(os.path.relpath(path, self.dir))
            return write(sess, path, *a)

        def spy_read(sess, path):
            io["read"].append(os.path.relpath(path, self.dir))
            return read(sess, path)

        StreamingSession._write_snapshot = spy_write
        StreamingSession._read_snapshot = spy_read

    def engine(self, model, mesh):
        from cogstream_tpu_torch.runtime.engine import CogReasonerEngine

        eng = CogReasonerEngine(model, self.cfg, self.tok, mesh=mesh)
        got = eng.chat(CONVERSATION, mode="AC", max_new_tokens=8)
        la = eng.chat(CONVERSATION, mode="AC", max_new_tokens=8,
                      lookahead_k=4)
        self.out["engine"] = {"text": got.text, "la_text": la.text,
                              "num": got.num_tokens}

    def pool(self, model, mesh):
        from cogstream_tpu_torch.runtime.pool import SessionPool

        pool = SessionPool(model, self.cfg, self.tok, n_rows=2, max_len=1024,
                           summary_forward=False, mesh=mesh)
        for r in (pool.open(), pool.open()):
            pool.ingest(r, self.pv, SEG, 2, [0.0, 1.0])
        out = pool.ask_batch([(0, "what is happening?"),
                              (1, "who is there?")], mode="AC",
                             max_new_tokens=8)
        self.out["pool"] = {
            "rows_held": sorted(pool.sessions),
            "cache_rows": int(pool.cache.k.shape[1]),
            "answers": {str(b): {"text": o["text"], "tokens": o["tokens"]}
                        for b, o in out.items()}}

    def pool_snapshot(self, model, mesh):
        """A row that data group 1 holds on (data 2, model 2) (6 rows,
        3 a group): saved by that group's first rank (rank 2), restored
        onto another of its rows; both rows answer alike. A missing file
        raises on every rank and releases its row."""
        from cogstream_tpu_torch.parallel.mesh import AgreedError
        from cogstream_tpu_torch.runtime.pool import SessionPool

        pool = SessionPool(model, self.cfg, self.tok, n_rows=6, max_len=1024,
                           summary_forward=False, mesh=mesh)
        rows = [pool.open() for _ in range(4)]
        pool.ingest(3, self.pv, SEG, 2, [0.0, 1.0])
        first = pool.ask_batch([(3, QUESTION)], mode="AC",
                               max_new_tokens=6)[3]
        path = os.path.join(self.dir, "pool_row3.snap.npz")
        pool.save(3, path)
        restored = pool.open_restored(path)
        out = pool.ask_batch([(3, CONT), (restored, CONT)], mode="AC",
                             max_new_tokens=6)
        try:
            pool.open_restored(os.path.join(self.dir, "missing.npz"))
            refused = None
        except AgreedError as e:
            refused = str(e)
        self.out["pool_snapshot"] = {
            "rows": rows, "restored": restored, "first": first["tokens"],
            "answers": {str(b): o["tokens"] for b, o in out.items()},
            "writer": os.path.exists(path) and mesh.rank == 2,
            "held": sorted(pool.sessions), "open": sorted(pool._open),
            "refused": refused}

    def adapters_cases(self, model, mesh):
        """Both adapters at tp = 2: the engine (FCC with history: the
        selector takes the language adapter), a session with the language
        adapter (AC, then FCC) and a 2-row pool with both."""
        from cogstream_tpu_torch.runtime.engine import CogReasonerEngine
        from cogstream_tpu_torch.runtime.pool import SessionPool
        from cogstream_tpu_torch.runtime.session import StreamingSession

        both = self.adapters("language_module", "full_module")
        eng = CogReasonerEngine(model, self.cfg, self.tok, adapters=both,
                                mesh=mesh)
        got = eng.chat(HIST_CONVERSATION, mode="FCC", max_new_tokens=8)
        res = {"engine": {"text": got.text, "selection": got.selection,
                          "num": got.num_tokens}}
        sess = StreamingSession(
            model, self.cfg, self.tok, max_len=1024, summary_forward=False,
            adapters=self.adapters("language_module"), mesh=mesh)
        sess.append_stream_segment(self.pv, SEG, 2, [0.0, 1.0])
        res["session"] = [
            {k: a[k] for k in ("text", "selection", "cache_tokens")}
            for a in (sess.ask(QUESTION, mode="AC", max_new_tokens=6),
                      sess.ask(CONT, mode="FCC", max_new_tokens=6))]
        pool = SessionPool(model, self.cfg, self.tok, n_rows=2, max_len=1024,
                           summary_forward=False, adapters=both, mesh=mesh)
        for r in (pool.open(), pool.open()):
            pool.ingest(r, self.pv, SEG, 2, [0.0, 1.0])
        res["pool"] = []
        for mode, qs in (("AC", ("what is happening?", "who is there?")),
                         ("FCC", (CONT, "why?"))):
            out = pool.ask_batch(list(enumerate(qs)), mode=mode,
                                 max_new_tokens=6)
            res["pool"].append({str(b): {"text": o["text"],
                                         "selection": o["selection"]}
                                for b, o in out.items()})
        res["sliced"] = sum(t.numel() for _, t in _leaves(
            eng.adapters["full_module"])) < sum(
            t.numel() for _, t in _leaves(both["full_module"]))
        self.out["adapters"] = res

    def loader(self, mesh):
        """The sharded load against the slice of the whole load, byte for
        byte (bf16 as stored, and quantized at load to int8 and int4)."""
        from cogstream_tpu_torch.models.checkpoint import (
            load_cogreasoner_from_hf)
        from cogstream_tpu_torch.parallel.sharding import shard_cogreasoner

        ckpt = os.path.join(self.dir, "hf")
        res = {}
        for bits in (None, 8, 4):
            whole = load_cogreasoner_from_hf(ckpt, self.cfg,
                                             dtype=torch.float32,
                                             quantize_text_bits=bits,
                                             device="cpu")
            want = shard_cogreasoner(whole, self.cfg, mesh)
            got = load_cogreasoner_from_hf(ckpt, self.cfg,
                                           dtype=torch.float32,
                                           quantize_text_bits=bits,
                                           device="cpu", mesh=mesh)
            w = dict(want.named_parameters())
            w.update(dict(want.named_buffers()))
            g = dict(got.named_parameters())
            g.update(dict(got.named_buffers()))
            res[str(bits)] = {
                "names_equal": sorted(w) == sorted(g),
                "unequal": [n for n in w if n in g and not (
                    w[n].shape == g[n].shape and w[n].dtype == g[n].dtype
                    and torch.equal(w[n], g[n]))],
                "bytes": sum(t.numel() * t.element_size()
                             for t in g.values()),
                "whole_bytes": sum(t.numel() * t.element_size() for t in
                                   list(whole.parameters())
                                   + list(whole.buffers()))}
        self.out["loader"] = res

    def plans(self, model, mesh):
        from cogstream_tpu_torch.parallel.sharding import (
            ensure_cogreasoner_sharded, sharded_mesh)

        sharded = ensure_cogreasoner_sharded(model, self.cfg, mesh)
        self.out["plans"] = {
            "idempotent": ensure_cogreasoner_sharded(
                sharded, self.cfg, mesh) is sharded,
            "none": ensure_cogreasoner_sharded(model, self.cfg,
                                               None) is model,
            "original_whole": sharded_mesh(model) is None,
            "mesh": sharded_mesh(sharded) is mesh}

    def server(self, model, mesh, name="server"):
        """SessionServer(mesh=) over HTTP (rank 0) against the solo server
        on the whole model, solo sessions and a 4-row pool, auto-
        snapshotting into rank 0's directory; then /save and /restore, and
        a fresh mesh server whose ``restore_all`` brings the sessions back,
        against the solo server that never stopped. ``name`` prefixes the
        result's key and the files."""
        from cogstream_tpu_torch.runtime.serve import (SessionServer,
                                                       make_http_server)

        frames = os.path.join(self.dir, "frames")
        res, snaps = {}, {}
        for kind, kw in (("solo", {}), ("pooled", {"pool_rows": 4})):
            snaps[kind] = os.path.join(self.dir, f"{name}_{kind}")
            srv = SessionServer(model, self.cfg, self.tok, max_len=2048,
                                mesh=mesh, auto_snapshot_dir=snaps[kind],
                                **kw)
            if mesh.rank > 0:
                srv.follow()
                srv = SessionServer(model, self.cfg, self.tok, max_len=2048,
                                    mesh=mesh, auto_snapshot_dir=snaps[kind],
                                    **kw)
                srv.follow()
                continue
            ref = SessionServer(model, self.cfg, self.tok, max_len=2048,
                                **kw)
            httpd = make_http_server(srv, "127.0.0.1", 0)
            th = threading.Thread(target=httpd.serve_forever, daemon=True)
            th.start()
            port = httpd.server_address[1]
            try:
                res[kind] = self._http_turns(port, ref, frames)
                res[kind].update(self._http_snapshots(port, ref,
                                                      f"{name}_{kind}"))
            finally:
                httpd.shutdown()
                httpd.server_close()
                srv.close()
            again = SessionServer(model, self.cfg, self.tok, max_len=2048,
                                  mesh=mesh, auto_snapshot_dir=snaps[kind],
                                  **kw)
            try:
                res[kind]["restored"] = again.restore_all()
                res[kind]["after_restart"] = [
                    {k: srv_.ask(sid, "one more?", mode=mode,
                                 max_new_tokens=6)[k]
                     for k in ("text", "turn", "cache_tokens", "tokens")}
                    for sid, mode in (("b", "FCC"), ("c", "AC"))
                    for srv_ in (again, ref)]
            finally:
                again.close()
                ref.close()
        self.out[name] = res

    def _http_snapshots(self, port, ref, stem):
        """/save of session a, /restore of it as c (and the solo server's
        own save / restore), asks of both; a snapshot that does not exist
        gives the solo server's error and the server serves on."""
        def post(path, payload):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        path = os.path.join(self.dir, f"{stem}_a.npz")
        ref_path = os.path.join(self.dir, f"{stem}_a_ref.npz")
        got = [post("/save", {"session_id": "a", "path": path})[1],
               post("/restore", {"session_id": "c", "path": path})[1]]
        want = [dict(ref.save_session("a", ref_path), path=path),
                ref.restore_session("c", ref_path)]
        for sid in ("c", "a"):
            got.append(post("/ask", {"session_id": sid, "question": "again?",
                                     "mode": "AC", "max_new_tokens": 6})[1])
            want.append(ref.ask(sid, "again?", mode="AC", max_new_tokens=6))
        missing = post("/restore", {"session_id": "d",
                                    "path": os.path.join(self.dir, "no.npz")})
        # a full pool refuses a session on every rank; the server serves on
        created = [post("/session", {"session_id": sid})[0]
                   for sid in ("e", "f")]
        return {"snap_got": got, "snap_want": json.loads(json.dumps(want)),
                "missing": missing, "created": created,
                "serving_after": post("/ask", {
                    "session_id": "a", "question": "still there?",
                    "mode": "AC", "max_new_tokens": 2})[0]}

    @staticmethod
    def _http_turns(port, ref, frames):
        def post(path, payload):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as r:
                return r.read()

        got, want = [], []
        for sid in ("a", "b"):
            got.append(json.loads(post("/session", {"session_id": sid})))
            want.append(ref.create(sid))
            r = json.loads(post("/ingest", {"session_id": sid,
                                            "video_path": frames,
                                            "start": None, "end": None,
                                            "fps": 1.0}))
            got.append({k: r[k] for k in ("frames", "cache_tokens")})
            rj = ref.ingest(sid, frames, None, None, 1.0)
            want.append({k: rj[k] for k in ("frames", "cache_tokens")})
        for q, mode in (("what is happening?", "AC"), ("and now?", "FCC")):
            for sid in ("a", "b"):
                got.append(json.loads(post("/ask", {
                    "session_id": sid, "question": q, "mode": mode,
                    "max_new_tokens": 6})))
                want.append(ref.ask(sid, q, mode=mode, max_new_tokens=6))
        raw = post("/ask_stream", {"session_id": "a", "question": "more?",
                                   "mode": "AC", "max_new_tokens": 6})
        text, meta = raw.rsplit(b"\x1e", 1)
        items = list(ref.ask_stream("a", "more?", mode="AC",
                                    max_new_tokens=6))
        got.append({"text": text.decode(), "meta": json.loads(meta)})
        want.append({"text": "".join(items[:-1]), "meta": items[-1]})
        return {"got": got, "want": json.loads(json.dumps(want))}

    def fault(self, case):
        """A sharded server (solo sessions) whose failing rank fails in its
        second ask: ``early`` (tp = 2, rank 1) as the ask starts, before
        any collective of it; ``mid`` (tp = 2, rank 1) and ``dp`` (data 2
        x model 2, rank 2: data group 1's first rank) in its prefill, at
        the third row-parallel reduce. Rank 0 serves HTTP and writes its
        port to ``--dir/<case>.port``; the parent test is the client. No
        rank returns: the server's fault path ends them all."""
        from cogstream_tpu_torch.models import qwen2
        from cogstream_tpu_torch.parallel.mesh import make_mesh
        from cogstream_tpu_torch.runtime.serve import (SessionServer,
                                                       make_http_server)

        mesh = (make_mesh(data_parallel=2, model_parallel=2) if case == "dp"
                else make_mesh(data_parallel=1, model_parallel=2))
        srv = SessionServer(self.model(), self.cfg, self.tok, max_len=2048,
                            mesh=mesh)
        if mesh.rank == 0:
            httpd = make_http_server(srv, "127.0.0.1", 0)
            path = os.path.join(self.dir, f"{case}.port")
            with open(path + ".tmp", "w") as f:
                f.write(str(httpd.server_address[1]))
            os.replace(path + ".tmp", path)
            httpd.serve_forever()
            return
        if mesh.rank != (2 if case == "dp" else 1):
            srv.follow()
            return
        asks, reduces = [], []
        op_ask, dense = srv._op_ask, qwen2.dense

        def faulty_ask(*a, **k):
            asks.append(1)
            if len(asks) == 2 and case == "early":
                raise RuntimeError("injected fault before any collective")
            return op_ask(*a, **k)

        def faulty_dense(*a, **k):
            if len(asks) == 2 and k.get("reduce") is not None:
                reduces.append(1)
                if len(reduces) == 3:
                    raise RuntimeError("injected fault mid-forward")
            return dense(*a, **k)

        srv._op_ask = faulty_ask
        qwen2.dense = faulty_dense
        srv.follow()

    # -- worlds -----------------------------------------------------------

    def world2(self):
        from cogstream_tpu_torch.parallel.mesh import make_mesh

        tp = make_mesh(data_parallel=1, model_parallel=2)
        model = self.model()
        self.plans(model, tp)
        self.forward("forward2", model, tp)
        self.snapshot("session2", self.session("session2", tp, model), tp,
                      model)
        bf16 = self.flags(dtype="bfloat16")
        m16 = self.model_as(bf16)
        self.snapshot("bf16", self.session("bf16", tp, m16, cfg=bf16,
                                           lookahead=False), tp, m16,
                      cfg=bf16)
        self.refused_snapshot(tp, model)
        self.adapters_cases(model, tp)
        self.session("enc8", tp, model, lookahead=False, encoder_int8=True)
        self.session("int8", tp, self.model("params_int8"),
                     cfg=self.flags(w8a8_prefill=True), encoder_int8=True)
        int4 = self.model("params_int4")
        self.session("int4", tp, int4)
        self.int4_w4a8(int4, tp, 2)
        self.engine(model, tp)
        self.loader(tp)
        self.server(model, tp)
        self.jax_snapshot("session2", tp, model)

    def world4(self):
        from cogstream_tpu_torch.parallel.mesh import make_mesh

        tp = make_mesh(data_parallel=1, model_parallel=4)
        dp = make_mesh(data_parallel=2, model_parallel=2)
        model = self.model()
        self.forward("forward4", model, tp)
        self.generate(model, tp)
        self.snapshot("session4", self.session("session4", tp, model), tp,
                      model)
        fp8 = torch.float8_e4m3fn
        self.snapshot("e4m3", self.session("e4m3", tp, model, lookahead=False,
                                           kv_dtype=fp8), tp, model,
                      kv_dtype=fp8)
        self.pool(model, dp)
        self.pool_snapshot(model, dp)
        self.jax_snapshot("session4", tp, model)
        self.int4_w4a8(self.model("params_int4"), tp, 4)
        self.snapshot_io()
        self.server(model, dp, name="server_dp")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--fault", choices=("early", "mid", "dp"),
                    help="run Rank.fault(case) instead of the world's cases")
    args = ap.parse_args()
    torch.set_num_threads(1)
    from cogstream_tpu_torch.parallel.distributed import initialize_if_needed

    initialize_if_needed(f"tcp://127.0.0.1:{args.port}", args.world,
                         args.rank, backend="gloo",
                         timeout_s=FAULT_GROUP_TIMEOUT_S if args.fault
                         else 300)
    rank = Rank(args)
    if args.fault:
        rank.fault(args.fault)
        return 1
    stem = os.path.join(args.dir, f"w{args.world}_r{args.rank}")
    try:
        getattr(rank, f"world{args.world}")()
    except Exception:  # noqa: BLE001 — recorded for the parent, then rc 1
        rank.out["error"] = traceback.format_exc()
        with open(stem + ".json", "w") as f:
            json.dump(rank.out, f)
        return 1
    np.savez(stem + ".npz", **rank.arrays)
    with open(stem + ".json", "w") as f:
        json.dump(rank.out, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
