"""The port's tensor-parallel serving against the JAX package's mesh
serving, on the CPU.

The JAX side runs in this process on conftest's 8 virtual CPU devices
(``make_mesh(devices=...)``). The port's side runs as gloo worlds of 2 and
4 ranks (tests/torch_parallel_child.py, one process per rank, importing
only the port), fed the JAX package's seeded weights through
models/bridge.py and numpy inputs; the two worlds start before the JAX
references are computed and run beside them.

What is held, in f32 at the tiny size (4 q / 2 kv heads, tower 2 heads: at
tp = 4 the decoder's kv heads and the tower's attention take the
fallbacks of parallel/sharding.py):

* ``generate_tokens`` at tp = 4: tokens equal to the JAX mesh's
  (tests/test_sharding.py::test_tp_sharded_generate_matches_unsharded);
* a cache-free forward at tp = 2 and 4: hidden states, and each rank's
  logits against JAX's logits at that rank's vocab slice, within 1e-5 of
  the row max;
* the session AC ask plus a lookahead ask at tp = 2 and 4: texts, fill
  levels and lookahead steps equal to the JAX mesh session's, each rank's
  cache equal to JAX's at that rank's kv heads within 1e-5 of the row max;
* ``encoder_int8`` at tp = 2, an int8 decoder under ``w8a8_prefill`` +
  ``encoder_int8``, and a weight-only rank-1 int4 decoder, against JAX
  mesh sessions of the same trees and flags;
* the rank-1 int4 decoder's shards with int8 activations (``w4a8_decode``,
  ``w8a8_prefill`` and both) at tp = 2 and 4 against the JAX mesh session
  (its XLA W4A8 branch: per row and GLOBAL half int8 activations): texts
  and ``cache_tokens`` equal, forwards within 3e-3 of the row max and the
  cache within 5e-3 (the int4 / int8 rounding bounds of
  tests/test_torch_quant.py) of the port's solo session, and of JAX's
  unless prefills take int8 activations (then 5e-2, the W8A8 session
  bound: the solo port session sits 6.7e-3 from JAX's there); weight-only
  shards, and shards whose halves
  quantize at their own (local) scales, miss those bounds at tp = 4; in
  one process (threads standing in for ranks) the row-parallel W4A8 forms
  at tp = 2 and 4 against the whole weight's, and group-wise int4 / NF4
  of row and column shards byte-equal to the slice of the whole
  quantization;
* the engine's text turn (vanilla and lookahead) at tp = 2;
* ``SessionPool`` on a (data = 2, model = 2) mesh (tests/test_pool.py::
  test_pool_on_tp_mesh_matches_unsharded);
* ``load_cogreasoner_from_hf(mesh=)`` byte for byte against the slice of
  the whole load (plain, int8 and int4 at load);
* the plans: every parameter and quantized buffer has a spec, and
  ``ensure_cogreasoner_sharded`` is idempotent;
* ``SessionServer(mesh=)`` over HTTP at tp = 2 (solo and pooled) answering
  as the solo server; and, in two more worlds, a server whose rank 1
  fails in an ask (before any collective, and mid-forward): the client
  gets a 503 naming that error and both ranks exit within seconds;
* every rank's tokens, texts and replicated hidden states bit-equal to
  rank 0's;
* snapshots of a sharded session (rank 0 gathers every kv head and
  writes the solo file): at tp = 2 and 4 in f32 equal to the JAX mesh
  session's ``save`` of the same turns (K/V within 1e-5 of the row max,
  meta equal); in bf16 (tp = 2) and e4m3 (tp = 4, overlapping kv heads)
  the file's K/V bytes at each rank's kv heads equal that rank's cache;
  the greedy continuation equal to JAX's after every restore route (the
  sharded snapshot into a fresh sharded session, a solo port session and
  a JAX session; JAX's snapshot into a sharded session); a snapshot that
  does not fit raises on every rank and changes nothing; a pool row held
  by data group 1 on (data 2, model 2) saved and restored;
* LoRA adapters at tp = 2 (both, from the JAX package, bridged and
  sliced on every rank): the engine, a session with the language adapter
  and a pool with both give the JAX mesh objects' texts and selections;
  the slicing is idempotent, refuses a mis-shaped tree, and keeps
  ``LoraLayout``'s refusal where kv heads are shared by ranks (tp = 4);
* the mesh server's /save and /restore (solo and pooled) answering as
  the solo server's, and a fresh mesh server's ``restore_all`` answering
  as the solo server that never stopped;
* ``SessionServer(mesh=)`` on (data 2, model 2) in the 4-rank world, solo
  (sessions replicated over the data groups) and pooled (4 rows, two a
  group), answering as the solo server and as JAX's
  ``SessionServer(mesh=make_mesh(2, 2))``, its snapshots and restart as
  above: a solo session's files written and read by rank 0 alone, a row
  data group 1 holds by rank 2 alone; and, in a 4-rank fault world, a
  rank of data group 1 failing mid-ask: a 503 and every rank gone.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogstream_tpu.config import (CogReasonerConfig as JConfig,
                                  CompressionConfig as JCompression)
from cogstream_tpu.models import qwen2 as jq
from cogstream_tpu.config import LoRAConfig as JLoRA
from cogstream_tpu.models.checkpoint import save_cogreasoner_to_hf
from cogstream_tpu.models.cogreasoner import init_cogreasoner_params
from cogstream_tpu.models.lora import init_cogreasoner_lora, init_qwen2_lora
from cogstream_tpu.ops.quant import quantize_tree
from cogstream_tpu.parallel.mesh import make_mesh as j_make_mesh
from cogstream_tpu.parallel.sharding import (qwen2_param_specs,
                                             shard_params)
from cogstream_tpu.processor.tokenizer import ByteTokenizer as JTok
from cogstream_tpu.runtime.engine import CogReasonerEngine as JEngine
from cogstream_tpu.runtime.generate import generate_tokens as j_generate
from cogstream_tpu.runtime.pool import SessionPool as JPool
from cogstream_tpu.runtime.serve import SessionServer as JServer
from cogstream_tpu.runtime.session import StreamingSession as JSession
from cogstream_tpu_torch.config import (CogReasonerConfig as TConfig,
                                        CompressionConfig as TCompression)
from cogstream_tpu_torch.models import bridge
from cogstream_tpu_torch.ops import quant as tquant
from cogstream_tpu_torch.parallel import sharding as tsh
from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer as TTok
from cogstream_tpu_torch.runtime.session import StreamingSession as TSession
from cogstream_tpu_torch.utils.io import unpack_array

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(HERE, "torch_parallel_child.py")
COMP = dict(frames_per_event=2, keyframes_per_event=1)
SEG = (2, 4, 4)
QUESTION = "what is this?"
CONVERSATION = [{"role": "user", "content": "hello, what now?"}]
CONT = "and now?"
HIST_CONVERSATION = [
    {"role": "user", "content": "what is the first scene?"},
    {"role": "assistant", "content": "a noisy pattern."},
    {"role": "user", "content": "and what came after it?"}]
WORLD_TIMEOUT_S = 300
# the int4 decoder's int8-activation modes, and the forwards' lengths
# (tests/torch_parallel_child.py)
W4A8_MODES = {"w4a8_decode": {"w4a8_decode": True},
              "w8a8_prefill": {"w8a8_prefill": True},
              "both": {"w4a8_decode": True, "w8a8_prefill": True}}
W4A8_LENGTHS = (8, 16)
# int4 / int8 rounding bounds, of the row max (tests/test_torch_quant.py)
INT4_FORWARD = 3e-3
INT4_CACHE = 5e-3


def _flat(tree, prefix=""):
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(_flat(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _seeded_lora(tree, seed):
    """Every leaf of a JAX LoRA tree drawn from N(0, 0.05^2): adapters
    that move the outputs (a zero ``b`` would not)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(
        rng.standard_normal(x.shape) * 0.05, np.float32), tree)


def _jcfg(**text):
    cfg = dataclasses.replace(JConfig.tiny(),
                              compression=JCompression(**COMP))
    if text:
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                                **text))
    return cfg


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Inputs on disk, then both port worlds started (they run while the
    JAX references compute)."""
    d = str(tmp_path_factory.mktemp("tp"))
    cfg = _jcfg()
    params = init_cogreasoner_params(jax.random.PRNGKey(0), cfg)
    trees = {
        "params": params,
        "params_int8": {**params, "text": quantize_tree(params["text"],
                                                        bits=8)},
        "params_int4": {**params, "text": quantize_tree(
            params["text"], bits=4, rank1=True, nf4=False)}}
    for name, tree in trees.items():
        np.savez(os.path.join(d, f"{name}.npz"), **_flat(tree))
    rng = np.random.default_rng(0)
    pv = rng.normal(size=(2 * 4 * 4, 3 * 14 * 14)).astype(np.float32)
    np.save(os.path.join(d, "pv.npy"), pv)
    ids = np.random.default_rng(0).integers(3, 200, (1, 16)).astype(
        np.int32)
    np.save(os.path.join(d, "ids.npy"), ids)
    os.makedirs(os.path.join(d, "frames"))
    frng = np.random.default_rng(1)
    for i in range(3):
        np.save(os.path.join(d, "frames", f"{i:03d}.npy"),
                frng.integers(0, 255, (48, 64, 3), np.uint8))
    save_cogreasoner_to_hf(params, cfg, os.path.join(d, "hf"),
                           dtype=jnp.float32)
    lora = JLoRA(rank=4, include_projector=True)
    adapters = {
        "language_module": _seeded_lora(init_qwen2_lora(
            jax.random.PRNGKey(1), cfg.text, lora), 1),
        "full_module": _seeded_lora(init_cogreasoner_lora(
            jax.random.PRNGKey(2), cfg, lora), 2)}
    np.savez(os.path.join(d, "lora_lang.npz"),
             **_flat(adapters["language_module"]))
    np.savez(os.path.join(d, "lora_full.npz"),
             **_flat(adapters["full_module"]))
    trees["adapters"] = adapters
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "MASTER_"))}
    procs, faults = [], {}
    for world, fault in ((2, None), (4, None), (2, "early"), (2, "mid"),
                         (4, "dp")):
        port = _free_port()
        for r in range(world):
            name = f"w{world}_r{r}" if fault is None else f"{fault}_r{r}"
            log = open(os.path.join(d, f"{name}.log"), "w")
            p = subprocess.Popen(
                [sys.executable, CHILD, "--world", str(world), "--rank",
                 str(r), "--port", str(port), "--dir", d]
                + ([] if fault is None else ["--fault", fault]),
                stdout=log, stderr=subprocess.STDOUT, env=env)
            procs.append((world, r, log, p))
            if fault is not None:
                faults.setdefault(fault, []).append(p)
    yield d, cfg, trees, pv, ids, faults
    for *_, log, p in procs:
        if p.poll() is None:
            p.kill()
        log.close()


@pytest.fixture(scope="module")
def jref(data):
    """The JAX package's mesh results for every case."""
    d, cfg, trees, pv, ids, _ = data
    params = trees["params"]
    tok = JTok(image_token_id=cfg.image_token_index)
    devs = jax.devices()
    mesh = {2: j_make_mesh(1, 2, devices=devs[:2]),
            4: j_make_mesh(1, 4, devices=devs[:4])}
    out = {}

    def session(tag, tp, tree, c=cfg, lookahead=True, **kw):
        sess = JSession(tree, c, tok, max_len=1024, summary_forward=False,
                        mesh=mesh[tp], **kw)
        sess.append_stream_segment(pv, SEG, 2, [0.0, 1.0])
        a = sess.ask(QUESTION, mode="AC", max_new_tokens=6)
        res = {"text": a["text"], "cache_tokens": a["cache_tokens"]}
        if lookahead:
            la = sess.ask(QUESTION, mode="AC", max_new_tokens=6,
                          lookahead_k=4)
            res.update(la_text=la["text"], la_steps=sess.last_lookahead_steps,
                       la_cache_tokens=la["cache_tokens"])
        res.update(k=np.asarray(sess.cache.k), v=np.asarray(sess.cache.v),
                   pos=np.asarray(sess.cache.pos))
        out[tag] = res
        return sess

    for tp in (2, 4):
        # the snapshot a sharded port session restores, and the
        # continuation every restore route must give
        tag = f"session{tp}"
        sess = session(tag, tp, params)
        path = os.path.join(d, f"j{tag}.snap.npz")
        sess.save(path + ".tmp.npz")
        os.replace(path + ".tmp.npz", path)
        a = sess.ask(CONT, mode="AC", max_new_tokens=6)
        out[tag]["cont"] = {"text": a["text"],
                            "cache_tokens": a["cache_tokens"]}
    session("enc8", 2, params, lookahead=False, encoder_int8=True)
    session("int8", 2, trees["params_int8"], _jcfg(w8a8_prefill=True),
            encoder_int8=True)
    int4 = trees["params_int4"]
    session("int4", 2, int4)
    # int8 activations on the int4 tree: the mesh sessions, and the whole
    # forwards (on the CPU the mesh and the whole tree both take the XLA
    # W4A8 branch)
    for mode, flags in W4A8_MODES.items():
        c = _jcfg(**flags)
        for tp in (2, 4):
            session(f"int4_{mode}{tp}", tp, int4, c, lookahead=False)
        out[f"int4f_{mode}"] = _jax_forwards(int4["text"], ids, c.text)

    S, new = ids.shape[1], 8
    emb = jq.embed(params["text"], jnp.asarray(ids))
    positions = jnp.asarray(np.arange(S, dtype=np.int32)[None])
    sp = shard_params(params["text"], qwen2_param_specs(cfg.text, mesh[4]),
                      mesh[4])
    with mesh[4]:
        gen = j_generate(sp, emb, positions, jnp.asarray([S - 1], jnp.int32),
                         jq.init_kv_cache(cfg.text, 1, S + new),
                         jax.random.PRNGKey(0), cfg.text, new, eos_id=-1,
                         temperature=0.0)
    out["generate"] = np.asarray(gen.tokens)[0].tolist()
    h, _ = jq.qwen2_forward(params["text"], emb, positions, cfg.text)
    out["hidden"] = np.asarray(h)
    out["logits"] = np.asarray(jq.lm_logits(params["text"], h))

    eng = JEngine(params, cfg, tok, mesh=mesh[2])
    got = eng.chat(CONVERSATION, mode="AC", max_new_tokens=8)
    la = eng.chat(CONVERSATION, mode="AC", max_new_tokens=8, lookahead_k=4)
    out["engine"] = {"text": got.text, "la_text": la.text,
                     "num": got.num_tokens}

    pool = JPool(params, cfg, tok, n_rows=2, max_len=1024,
                 summary_forward=False,
                 mesh=j_make_mesh(2, 2, devices=devs[:4]))
    for r in (pool.open(), pool.open()):
        pool.ingest(r, pv, SEG, 2, [0.0, 1.0])
    ans = pool.ask_batch([(0, "what is happening?"), (1, "who is there?")],
                         mode="AC", max_new_tokens=8)
    out["pool"] = {b: a["text"] for b, a in ans.items()}

    ads = jax.tree.map(jnp.asarray, trees["adapters"])
    eng = JEngine(params, cfg, tok, adapters=ads, mesh=mesh[2])
    got = eng.chat(HIST_CONVERSATION, mode="FCC", max_new_tokens=8)
    res = {"engine": {"text": got.text, "selection": got.selection,
                      "num": got.num_tokens}}
    sess = JSession(params, cfg, tok, max_len=1024, summary_forward=False,
                    adapters={"language_module": ads["language_module"]},
                    mesh=mesh[2])
    sess.append_stream_segment(pv, SEG, 2, [0.0, 1.0])
    res["session"] = [{k: a[k] for k in ("text", "selection",
                                         "cache_tokens")}
                      for a in (sess.ask(QUESTION, mode="AC",
                                         max_new_tokens=6),
                                sess.ask(CONT, mode="FCC",
                                         max_new_tokens=6))]
    pool = JPool(params, cfg, tok, n_rows=2, max_len=1024,
                 summary_forward=False, adapters=ads, mesh=mesh[2])
    for r in (pool.open(), pool.open()):
        pool.ingest(r, pv, SEG, 2, [0.0, 1.0])
    res["pool"] = []
    for mode, qs in (("AC", ("what is happening?", "who is there?")),
                     ("FCC", (CONT, "why?"))):
        ans = pool.ask_batch(list(enumerate(qs)), mode=mode,
                             max_new_tokens=6)
        res["pool"].append({str(b): {"text": a["text"],
                                     "selection": a["selection"]}
                            for b, a in ans.items()})
    out["adapters"] = res

    # JAX's server on (data 2, model 2), as the port's mesh server is asked
    mesh22 = j_make_mesh(2, 2, devices=devs[:4])
    for kind, kw in (("solo", {}), ("pooled", {"pool_rows": 4})):
        srv = JServer(params, cfg, tok, max_len=2048, mesh=mesh22, **kw)
        out[f"jserver_{kind}"] = _jax_server_turns(
            srv, os.path.join(d, "frames"))
    return out


def _jax_forwards(text, ids, tcfg):
    """{S: (hidden, logits)} of the prompt's first S tokens through the
    JAX decoder under ``tcfg``'s flags, the head under ``w4a8_decode``."""
    out = {}
    for S in W4A8_LENGTHS:
        emb = jq.embed(text, jnp.asarray(ids[:, :S]))
        h, _ = jq.qwen2_forward(text, emb, jnp.asarray(
            np.arange(S, dtype=np.int32)[None]), tcfg)
        out[S] = (np.asarray(h), np.asarray(
            jq.lm_logits(text, h, w8a8=tcfg.w4a8_decode)))
    return out


def _jax_server_turns(srv, frames):
    """The calls of tests/torch_parallel_child.py's ``_http_turns`` on a
    JAX server: creates, ingests, AC and FCC asks of two sessions, and a
    streamed ask."""
    got = []
    for sid in ("a", "b"):
        got.append(srv.create(sid))
        r = srv.ingest(sid, frames, None, None, 1.0)
        got.append({k: r[k] for k in ("frames", "cache_tokens")})
    for q, mode in (("what is happening?", "AC"), ("and now?", "FCC")):
        for sid in ("a", "b"):
            got.append(srv.ask(sid, q, mode=mode, max_new_tokens=6))
    items = list(srv.ask_stream("a", "more?", mode="AC", max_new_tokens=6))
    got.append({"text": "".join(items[:-1]), "meta": items[-1]})
    return json.loads(json.dumps(got))


@pytest.fixture(scope="module")
def worlds(data, jref):
    """Each rank's outputs: {world: [(json, npz) per rank]}."""
    d = data[0]
    deadline = time.time() + WORLD_TIMEOUT_S
    out = {}
    for world in (2, 4):
        ranks = []
        for r in range(world):
            stem = os.path.join(d, f"w{world}_r{r}")
            while not os.path.exists(stem + ".json"):
                if time.time() > deadline:
                    with open(stem + ".log") as f:
                        pytest.fail(f"world {world} rank {r} timed out:\n"
                                    + f.read()[-3000:])
                time.sleep(0.2)
            time.sleep(0.1)
            with open(stem + ".json") as f:
                res = json.load(f)
            if "error" in res:
                pytest.fail(f"world {world} rank {r}:\n{res['error']}")
            ranks.append((res, dict(np.load(stem + ".npz"))))
        out[world] = ranks
    return out


def _close(got, want, tol=1e-5):
    """Each row within ``tol`` of that row's max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.maximum(np.abs(want).max(axis=-1, keepdims=True), 1e-30)
    err = np.abs(got - want) / scale
    assert err.max() <= tol, err.max()


def _cache_matches(res, arrays, tag, ref, tol=1e-5):
    heads = res[tag]["kv_heads"]
    pos = arrays[f"{tag}_pos"]
    np.testing.assert_array_equal(pos, ref["pos"])
    live = pos[0] >= 0
    for name in ("k", "v"):
        got = arrays[f"{tag}_{name}"][:, 0][:, live]
        want = ref[name][:, 0][:, live][:, :, heads]
        _close(got, want, tol)


# ---------------------------------------------------------------------------
# plans (this process: a rank's place in a layout, without process groups)
# ---------------------------------------------------------------------------

def _layout(data, model, rank):
    """What the plans read of a Mesh, for ``rank`` of a ``data x model``
    layout (row-major, as ``parallel.mesh.axis_ranks``)."""
    d, m = divmod(rank, model)
    return types.SimpleNamespace(shape={"data": data, "model": model},
                                 data_index=d, model_index=m,
                                 model_group=None, data_group=None)


@pytest.mark.parametrize("tp", [2, 4])
def test_plans_cover_every_parameter(data, tp):
    """Every parameter of the port's model has a spec, and every
    parameter and buffer of its int8 and int4 forms an adapted one
    (tests/test_sharding.py::test_qwen2_specs_cover_tree)."""
    cfg = dataclasses.replace(TConfig.tiny(),
                              compression=TCompression(**COMP))
    model = bridge.cogreasoner_from_params(
        jax.tree.map(np.asarray, data[2]["params"]), cfg, device="cpu")
    for rank in range(tp):
        mesh = _layout(1, tp, rank)
        specs = tsh.cogreasoner_param_specs(cfg, mesh)
        assert set(specs) == {n for n, _ in model.named_parameters()}
        leaves = tsh.adapt_specs_to_quantized(model, specs)
        assert set(leaves) == set(specs)
    for bits in (8, 4):
        qm = bridge.cogreasoner_from_params(
            jax.tree.map(np.asarray, data[2]["params"]), cfg, device="cpu")
        tquant.quantize_text_(qm.text, bits)
        leaves = tsh.adapt_specs_to_quantized(
            qm, tsh.cogreasoner_param_specs(cfg, _layout(1, tp, 0)))
        names = {n for n, _ in qm.named_parameters()} | {
            n for n, _ in qm.named_buffers()}
        assert set(leaves) == names


@pytest.mark.parametrize("tp", [2, 4])
def test_plan_slices_partition_the_model(data, tp):
    """The ranks' slices of every split weight tile it: q heads, the MLP,
    the vocab and the tower heads each once; kv heads at least once, and
    each rank holds exactly the kv heads its q heads read."""
    cfg = TConfig.tiny()
    G = cfg.text.num_attention_heads // cfg.text.num_key_value_heads
    shards = [tsh.text_shard(cfg.text, _layout(1, tp, r))
              for r in range(tp)]
    assert sorted(h for s in shards for h in s.q_heads) == list(
        range(cfg.text.num_attention_heads))
    for s in shards:
        assert list(s.kv_heads) == sorted({h // G for h in s.q_heads})
    assert sorted({h for s in shards for h in s.kv_heads}) == list(
        range(cfg.text.num_key_value_heads))
    assert sorted(i for s in shards for i in range(*s.vocab)) == list(
        range(cfg.text.vocab_size))
    towers = [tsh.tower_shard(cfg.vision, _layout(1, tp, r))
              for r in range(tp)]
    # 2 tower heads: split at tp = 2, replicated at tp = 4
    assert all(t.attn_split == (tp == 2) for t in towers)


@pytest.mark.parametrize("data,model", [(1, 4), (2, 2)])
def test_kv_cache_specs_place_heads_and_rows(data, model):
    """A whole cache's local slice: the plan's kv heads, and rows split
    on the data axis when they divide (replicated when they do not), as
    JAX's ``place_kv_cache``."""
    from cogstream_tpu_torch.models import qwen2 as tq

    cfg = TConfig.tiny().text
    full = tq.init_kv_cache(cfg, 4, 8, device="cpu")
    full.k.copy_(torch.arange(full.k.numel(), dtype=torch.float32)
                 .reshape(full.k.shape))
    for rank in range(data * model):
        mesh = _layout(data, model, rank)
        heads, rows = tsh.kv_cache_specs(cfg, mesh, 4)
        assert heads == tsh.text_shard(cfg, mesh).kv_heads
        assert rows == (None if data == 1 else
                        (mesh.data_index * 2, mesh.data_index * 2 + 2))
        local = tsh.place_kv_cache(full, cfg, mesh)
        r = slice(None) if rows is None else slice(*rows)
        assert torch.equal(local.k, full.k[:, r][:, :, :, list(heads)])
        assert tsh.kv_cache_specs(cfg, mesh, 3)[1] is None


def test_mesh_layouts_and_one_process_bring_up():
    """``make_mesh`` in a process without a group is the 1 x 1 mesh and
    refuses other products; ``initialize_if_needed`` is a no-op there;
    ``axis_ranks`` lays ranks out row-major, as JAX's reshape;
    ``with_retries`` retries and then raises the last error."""
    from cogstream_tpu_torch.parallel import distributed as tdist
    from cogstream_tpu_torch.parallel import mesh as tmesh

    assert tdist.initialize_if_needed() == (0, 1)
    m = tmesh.make_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.model_group is None
    assert tmesh.single_device_mesh().size == 1
    with pytest.raises(ValueError, match="2x1"):
        tmesh.make_mesh(data_parallel=2, model_parallel=1)
    rows, cols = tmesh.axis_ranks(2, 4)
    assert rows == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert cols == [[0, 4], [1, 5], [2, 6], [3, 7]]
    lay = _layout(2, 4, 6)
    assert 6 in rows[lay.data_index] and 6 in cols[lay.model_index]
    assert tmesh.divisible(8, lay) and not tmesh.divisible(6, lay)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError(f"try {len(calls)}")
        return "ok"

    assert tdist.with_retries(flaky, backoff_s=0.0) == "ok"
    calls.clear()
    with pytest.raises(RuntimeError, match="try 2"):
        tdist.with_retries(flaky, max_attempts=2, backoff_s=0.0)


def test_int4_row_shard_repacks_to_its_own_pairing():
    """A row-parallel rank-1 int4 shard dequantizes to the rows of the
    whole weight's dequantization (the split-halves pairing repacked)."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(64, 24, generator=g)
    qp = tquant.quantize_int4_rank1(w, nf4=False)
    whole = tquant.dequantize_int4(qp, torch.float32)
    spec = tsh.Spec(inn=(16, 32))
    local = {k: tsh.slice_leaf(v, tsh.LeafSpec(spec, kind, 64)) for k, v, kind
             in (("q4", qp["q4"], "q4"), ("scale", qp["scale"], "s"),
                 ("rscale", qp["rscale"], "r"), ("code", qp["code"], "rep"))}
    torch.testing.assert_close(tquant.dequantize_int4(local, torch.float32),
                               whole[16:32], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the worlds against JAX
# ---------------------------------------------------------------------------

def test_generate_tokens_tp4(jref, worlds):
    for res, _ in worlds[4]:
        assert res["generate"]["tokens"] == jref["generate"]


@pytest.mark.parametrize("world", [2, 4])
def test_forward_hidden_and_logit_slices(jref, worlds, world):
    ranks = worlds[world]
    for r, (res, arrays) in enumerate(ranks):
        h = arrays[f"forward{world}_hidden"]
        _close(h[0], jref["hidden"][0])
        assert np.array_equal(h, ranks[0][1][f"forward{world}_hidden"])
        lo, hi = res[f"forward{world}"]["vocab"]
        assert hi - lo == jref["logits"].shape[-1] // world
        _close(arrays[f"forward{world}_logits"][0],
               jref["logits"][0][:, lo:hi])


@pytest.mark.parametrize("world", [2, 4])
def test_session_ac_and_lookahead(jref, worlds, world):
    tag = f"session{world}"
    ref = jref[tag]
    for res, arrays in worlds[world]:
        got = res[tag]
        assert got["text"] == ref["text"]
        assert got["la_text"] == ref["la_text"] == ref["text"]
        assert got["la_steps"] == ref["la_steps"]
        assert (got["cache_tokens"], got["la_cache_tokens"]) == \
            (ref["cache_tokens"], ref["la_cache_tokens"])
        assert got["tokens"] == worlds[world][0][0][tag]["tokens"]
        _cache_matches(res, arrays, tag, ref)


# the cache bound of a session with the W8A8 tower: the JAX mesh session
# runs its head-major tower branch (the port's packed one; both are JAX's),
# and W8A8 forwards round chaotically (tests/test_torch_quant_modes.py
# SESSION holds the solo session to the same bound)
W8A8_SESSION = 5e-2


@pytest.mark.parametrize("tag,tol", [("enc8", W8A8_SESSION),
                                     ("int8", W8A8_SESSION),
                                     ("int4", 1e-5)])
def test_quantized_sessions(jref, worlds, tag, tol):
    """encoder_int8; an int8 decoder under w8a8_prefill + encoder_int8;
    a rank-1 int4 decoder, weight-only: each against the JAX mesh session
    of the same tree and flags."""
    ref = jref[tag]
    for res, arrays in worlds[2]:
        got = res[tag]
        assert got["text"] == ref["text"]
        assert got["cache_tokens"] == ref["cache_tokens"]
        if "la_text" in ref:
            assert got["la_text"] == ref["la_text"]
        assert got["tokens"] == worlds[2][0][0][tag]["tokens"]
        _cache_matches(res, arrays, tag, ref, tol)


@pytest.fixture(scope="module")
def solo_int4(data):
    """The port's solo (whole-model) int4 session under each mode: the
    reference that isolates what the shards add."""
    cfg = dataclasses.replace(TConfig.tiny(),
                              compression=TCompression(**COMP))
    tree = jax.tree.map(np.asarray, data[2]["params_int4"])
    out = {}
    for mode, flags in W4A8_MODES.items():
        c = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                              **flags))
        sess = TSession(bridge.cogreasoner_from_params(tree, c, device="cpu"),
                        c, TTok(image_token_id=c.image_token_index),
                        max_len=1024, summary_forward=False)
        sess.append_stream_segment(data[3], SEG, 2, [0.0, 1.0])
        a = sess.ask(QUESTION, mode="AC", max_new_tokens=6)
        out[mode] = {"text": a["text"], "k": sess.cache.k.numpy(),
                     "v": sess.cache.v.numpy(),
                     "pos": sess.cache.pos.numpy()}
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", list(W4A8_MODES))
def test_int4_w4a8_sessions(jref, worlds, solo_int4, mode, world):
    """A sharded rank-1 int4 decoder under ``mode`` gives the JAX mesh
    session's text and fill level, and every rank's tokens equal rank
    0's. Each rank's cache at its kv heads: within the int4 rounding
    bound (5e-3 of the row max) of the port's solo session, and of JAX's
    where only decode steps take int8 activations; where prefills do
    (``w8a8_prefill``), within the W8A8 session bound (5e-2) of JAX's,
    as the solo port session is too: an int8 rounding flip in the ingest
    prefill puts it 6.7e-3 from JAX's solo session (measured), the
    products themselves being bit-equal (tests/test_torch_quant_modes.py
    ``test_w4a8_prefill_branch``)."""
    tag = f"int4_{mode}{world}"
    ref = jref[tag]
    to_jax = W8A8_SESSION if W4A8_MODES[mode].get("w8a8_prefill") \
        else INT4_CACHE
    for res, arrays in worlds[world]:
        got = res[tag]
        assert got["text"] == ref["text"] == solo_int4[mode]["text"]
        assert got["cache_tokens"] == ref["cache_tokens"]
        assert got["tokens"] == worlds[world][0][0][tag]["tokens"]
        _cache_matches(res, arrays, tag, ref, to_jax)
        _cache_matches(res, arrays, tag, solo_int4[mode], INT4_CACHE)


def _forward_errors(res, arrays, tag, ref):
    """{(S, "hidden" | "logits"): max error of the row max} of one rank's
    forwards ``tag`` against JAX's ``ref`` ({S: (hidden, logits)})."""
    lo, hi = res["forward2" if "forward2" in res else "forward4"]["vocab"]
    out = {}
    for S, (h, logits) in ref.items():
        for name, want in (("hidden", h[0]), ("logits", logits[0][:, lo:hi])):
            got = np.asarray(arrays[f"{tag}_s{S}_{name}"][0], np.float64)
            scale = np.maximum(np.abs(want).max(axis=-1, keepdims=True),
                               1e-30)
            out[(S, name)] = float((np.abs(got - want) / scale).max())
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", list(W4A8_MODES))
def test_int4_w4a8_forwards(jref, worlds, mode, world):
    """The sharded int4 decoder's forwards under ``mode`` (a prefill- and
    a decode-length prompt): hidden states and each rank's logits slice
    within 3e-3 of the row max of JAX's."""
    for res, arrays in worlds[world]:
        errs = _forward_errors(res, arrays, f"int4f_{mode}{world}",
                               jref[f"int4f_{mode}"])
        assert max(errs.values()) <= INT4_FORWARD, errs


@pytest.mark.parametrize("control", ["weight_only", "local_scales"])
def test_int4_w4a8_mode_controls_miss(jref, worlds, control):
    """At tp = 4, against JAX's forwards under both flags: the shards run
    weight-only, or with each rank's halves quantized at their own scales
    (the global halves' MAX left out), miss the bound the W4A8 shards
    meet, in the decode- and the prefill-length forward."""
    for res, arrays in worlds[4]:
        errs = _forward_errors(res, arrays, f"int4f_{control}4",
                               jref["int4f_both"])
        for S in W4A8_LENGTHS:
            assert max(errs[(S, "hidden")], errs[(S, "logits")]) \
                > INT4_FORWARD, errs


def test_engine_text_turn(jref, worlds):
    for res, _ in worlds[2]:
        assert res["engine"] == jref["engine"]


def test_pool_on_data_and_model_axes(jref, worlds):
    """Rows split over the data axis (one held per group, a 1-row cache);
    every rank returns both rows' answers, equal to JAX's."""
    for r, (res, _) in enumerate(worlds[4]):
        got = res["pool"]
        assert got["rows_held"] == [r // 2] and got["cache_rows"] == 1
        assert {int(b): a["text"] for b, a in got["answers"].items()} == \
            jref["pool"]
        assert got["answers"] == worlds[4][0][0]["pool"]["answers"]


@pytest.mark.parametrize("bits", ["None", "8", "4"])
def test_sharded_load_equals_slices(worlds, bits):
    """load_cogreasoner_from_hf(mesh=) gives each rank the slice of the
    whole load, byte for byte, and less than the whole; at load-time
    int8 / int4 the slice of the whole quantization (the absmaxes taken
    over every rank's part)."""
    for res, _ in worlds[2]:
        got = res["loader"][bits]
        assert got["names_equal"] and got["unequal"] == []
        assert got["bytes"] < got["whole_bytes"]


def test_ensure_sharded_is_idempotent(worlds):
    for res, _ in worlds[2]:
        assert res["plans"] == {"idempotent": True, "none": True,
                                "original_whole": True, "mesh": True}


@pytest.mark.parametrize("kind", ["solo", "pooled"])
def test_server_on_mesh_answers_as_solo(worlds, kind):
    got = worlds[2][0][0]["server"][kind]
    assert got["got"] == got["want"]
    assert len(got["got"]) == 9


def _post(port, path, payload, timeout=60):
    """(status, JSON body) of a POST to the fault world's rank 0."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# the fault worlds' process-group timeout (tests/torch_parallel_child.py)
FAULT_GROUP_TIMEOUT_S = 10
FATAL_EXIT = 17


@pytest.mark.parametrize("case", ["early", "mid", "dp"])
def test_server_rank_failure_ends_every_rank(data, case):
    """A sharded server whose failing rank fails in an ask: at tp = 2
    rank 1, before any collective of the ask or mid-forward; on (data 2,
    model 2) rank 2, data group 1's first rank, mid-forward. Rank 0's
    client gets a 503 naming that rank's error, and every rank exits with
    rc 17 within a few seconds, well before the group's timeout (no rank
    is left waiting in a collective). Before that, the followers idle
    past the group timeout between requests and the first ask is
    answered."""
    d, faults = data[0], data[5]
    procs = faults[case]
    failing = 2 if case == "dp" else 1
    path = os.path.join(d, f"{case}.port")
    deadline = time.time() + WORLD_TIMEOUT_S
    while not os.path.exists(path):
        if time.time() > deadline or any(p.poll() is not None
                                         for p in procs):
            with open(os.path.join(d, f"{case}_r{failing}.log")) as f:
                pytest.fail(f"fault world {case} did not serve:\n"
                            + f.read()[-3000:])
        time.sleep(0.2)
    # the followers wait for the first request past the group timeout
    time.sleep(max(0.0, os.path.getmtime(path) + FAULT_GROUP_TIMEOUT_S + 2
                   - time.time()))
    with open(path) as f:
        port = int(f.read())
    assert _post(port, "/session", {"session_id": "a"})[0] == 200
    assert _post(port, "/ingest", {"session_id": "a",
                                   "video_path": os.path.join(d, "frames"),
                                   "start": None, "end": None,
                                   "fps": 1.0})[0] == 200
    ok = _post(port, "/ask", {"session_id": "a", "question": QUESTION,
                              "mode": "AC", "max_new_tokens": 4})
    assert ok[0] == 200 and ok[1]["tokens"], ok
    t0 = time.time()
    status, body = _post(port, "/ask", {"session_id": "a",
                                        "question": QUESTION, "mode": "AC",
                                        "max_new_tokens": 4})
    rcs = [p.wait(timeout=60) for p in procs]
    ended = time.time() - t0
    assert status == 503 and body["mesh_fatal"] is True, body
    assert body["error"].startswith(f"rank {failing}: _op_ask failed"), body
    assert "injected fault" in body["error"], body
    assert rcs == [FATAL_EXIT] * len(procs)
    assert ended < FAULT_GROUP_TIMEOUT_S / 2, ended


def test_non_mesh_argument_raises():
    cfg = TConfig.tiny()
    with pytest.raises(TypeError, match="Mesh"):
        tsh.ensure_cogreasoner_sharded(object(), cfg, object())


# ---------------------------------------------------------------------------
# snapshots of a sharded session
# ---------------------------------------------------------------------------

def _snapshot(path):
    """(meta, {name: array}) of a snapshot, the K/V as the host copies
    ``unpack_array`` gives (f32 as numpy; bf16 / e4m3 as torch)."""
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        arrays = {n: unpack_array(z[n], meta["dtypes"][n])
                  for n in meta["dtypes"]}
        raw = {n: z[n] for n in ("k", "v")}
    return meta, arrays, raw


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_snapshot_equals_jax_save(data, jref, worlds, world):
    """The file rank 0 wrote equals the JAX mesh session's ``save`` of the
    same turns: meta equal (the port's extra ``torch_rng_state`` aside),
    every kv head's K/V within 1e-5 of the row max, positions and event
    reps; only rank 0 wrote, and each rank's live K/V is the file's slice
    at its kv heads, bit for bit."""
    d = data[0]
    tag = f"session{world}"
    meta, arrays, raw = _snapshot(os.path.join(d, f"{tag}.snap.npz"))
    jmeta, jarrays, _ = _snapshot(os.path.join(d, f"j{tag}.snap.npz"))
    dt, jdt = meta.pop("dtypes"), jmeta.pop("dtypes")
    assert meta == jmeta
    assert {k: v for k, v in dt.items() if k != "torch_rng_state"} == jdt
    np.testing.assert_array_equal(arrays["pos"], jarrays["pos"])
    for name in ("k", "v"):
        assert arrays[name].shape[2] == 2        # every kv head
        _close(arrays[name], jarrays[name])
    if "event_reps" in jdt:
        _close(arrays["event_reps"], jarrays["event_reps"])
    writers = [res[f"{tag}_snap"]["writer"] for res, _ in worlds[world]]
    assert writers == [True] + [False] * (world - 1)
    for res, a in worlds[world]:
        heads = res[f"{tag}_snap"]["kv_heads"]
        for name in ("k", "v"):
            assert np.array_equal(raw[name][:, :, heads],
                                  a[f"{tag}_snap{name}"])


@pytest.mark.parametrize("tag,world", [("bf16", 2), ("e4m3", 4)])
def test_sharded_snapshot_bytes_equal_the_ranks(data, worlds, tag, world):
    """bf16 (tp = 2) and e4m3 (tp = 4: each rank one of the 2 kv heads,
    two ranks per head): the file keeps the cache's dtype, and its K/V
    bytes at each rank's kv heads equal that rank's cache bytes; the
    restored sharded session continues with the original's tokens."""
    meta, arrays, raw = _snapshot(os.path.join(data[0], f"{tag}.snap.npz"))
    want = {"bf16": "bfloat16", "e4m3": "float8_e4m3fn"}[tag]
    assert meta["dtypes"]["k"] == meta["dtypes"]["v"] == want
    heads = [res[f"{tag}_snap"]["kv_heads"] for res, _ in worlds[world]]
    assert sorted({h for hs in heads for h in hs}) == [0, 1]
    for (res, a), hs in zip(worlds[world], heads):
        for name in ("k", "v"):
            assert np.array_equal(raw[name][:, :, hs], a[f"{tag}_snap{name}"])
        snap = res[f"{tag}_snap"]
        assert snap["restored"] == snap["cont"]
        assert snap["cont"] == worlds[world][0][0][f"{tag}_snap"]["cont"]


def _continue_solo_port(data, path):
    cfg = dataclasses.replace(TConfig.tiny(),
                              compression=TCompression(**COMP))
    model = bridge.cogreasoner_from_params(
        jax.tree.map(np.asarray, data[2]["params"]), cfg, device="cpu")
    sess = TSession(model, cfg, TTok(image_token_id=cfg.image_token_index),
                    max_len=1024, summary_forward=False)
    sess.load_state(path)
    a = sess.ask(CONT, mode="AC", max_new_tokens=6)
    return {"text": a["text"], "cache_tokens": a["cache_tokens"]}


def _continue_jax(data, path):
    cfg = data[1]
    sess = JSession(data[2]["params"], cfg,
                    JTok(image_token_id=cfg.image_token_index), max_len=1024,
                    summary_forward=False)
    sess.load_state(path)
    a = sess.ask(CONT, mode="AC", max_new_tokens=6)
    return {"text": a["text"], "cache_tokens": a["cache_tokens"]}


@pytest.mark.parametrize("world", [2, 4])
def test_restore_routes_continue_as_jax(data, jref, worlds, world):
    """The greedy continuation after the snapshot equals the JAX mesh
    session's, whatever restores it: the sharded session itself, a fresh
    sharded session from the sharded file, a solo port session and a JAX
    session from that file, and a sharded session from JAX's file."""
    tag = f"session{world}"
    want = jref[tag]["cont"]
    path = os.path.join(data[0], f"{tag}.snap.npz")
    for res, _ in worlds[world]:
        for got in (res[f"{tag}_snap"]["cont"], res[f"{tag}_snap"]["restored"],
                    res[f"{tag}_jsnap"]):
            assert {k: got[k] for k in want} == want
        assert res[f"{tag}_jsnap"]["tokens"] == \
            res[f"{tag}_snap"]["cont"]["tokens"]
    assert _continue_solo_port(data, path) == want
    assert _continue_jax(data, path) == want


def test_snapshot_that_does_not_fit_raises_on_every_rank(worlds):
    for res, _ in worlds[2]:
        got = res["refused_snapshot"]
        assert got["kept"] and got["error"].startswith(
            "ValueError: snapshot needs"), got


def test_pool_row_snapshot_on_data_and_model_axes(worlds):
    """Row 3 of 6, held by data group 1, is written by that group's first
    rank (rank 2) alone, restored onto row 4 (also group 1's), and both
    rows answer alike on every rank; a missing file raises on every rank
    and releases the row it took."""
    ranks = [res["pool_snapshot"] for res, _ in worlds[4]]
    assert [r["writer"] for r in ranks] == [False, False, True, False]
    for r in ranks:
        assert r["rows"] == [0, 1, 2, 3] and r["restored"] == 4
        assert r["answers"]["3"] == r["answers"]["4"]
        assert r["answers"] == ranks[0]["answers"]
        assert r["open"] == [0, 1, 2, 3, 4]
        assert r["refused"].startswith("FileNotFoundError"), r["refused"]
    assert [r["held"] for r in ranks] == [[0, 1, 2], [0, 1, 2], [3, 4],
                                          [3, 4]]


# ---------------------------------------------------------------------------
# LoRA adapters on a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["engine", "session", "pool"])
def test_adapters_on_a_mesh_match_jax(jref, worlds, case):
    """Both adapters (the JAX package's, bridged) sliced on each rank at
    tp = 2 give the JAX mesh objects' texts and selections: the engine's
    FCC turn with history (the selector on the language adapter), a
    session with the language adapter (AC, then FCC), a pool with both."""
    for res, _ in worlds[2]:
        assert res["adapters"][case] == jref["adapters"][case]
        assert res["adapters"]["sliced"]


def _port_adapters(data, *names):
    files = {"language_module": "language_module",
             "full_module": "full_module"}
    return {n: bridge.lora_from_params(data[2]["adapters"][files[n]],
                                       device="cpu") for n in names}


def test_shard_adapters_slices_once_and_refuses_misshapes(data):
    """``shard_adapters`` gives each rank of tp = 2 its slice (the
    ranks' ``b`` blocks of a column site tile the whole), passes a tree
    already sliced for the mesh through unchanged (the same object), and
    raises ``ValueError`` on a tree that is neither; ``None`` meshes and
    empty adapters pass through. At tp = 4 (kv heads shared by ranks) it
    raises ``LoraLayout``'s refusal."""
    from cogstream_tpu_torch.models.lora import iter_leaves

    cfg = TConfig.tiny()
    whole = _port_adapters(data, "language_module", "full_module")
    parts = [tsh.shard_adapters(whole, cfg, _layout(1, 2, r))
             for r in range(2)]
    for part in parts:
        assert tsh.shard_adapters(part, cfg, _layout(1, 2, 0)) is part
    for name, site in (("language_module", "layers.0.attn.k_proj"),
                       ("full_module", "text.layers.1.mlp.gate_proj")):
        leaves = [dict(iter_leaves(p[name])) for p in parts]
        want = dict(iter_leaves(whole[name]))
        torch.testing.assert_close(
            torch.cat([x[f"{site}.b"] for x in leaves], dim=1),
            want[f"{site}.b"].detach(), rtol=0, atol=0)
        assert torch.equal(leaves[0][f"{site}.a"], want[f"{site}.a"])
    assert tsh.shard_adapters(whole, cfg, None) is whole
    assert tsh.shard_adapters({}, cfg, _layout(1, 2, 0)) == {}
    bad = {"language_module": parts[0]["language_module"],
           "full_module": whole["full_module"]}
    bad["language_module"] = {"layers": [
        {g: {n: {"a": ab["a"], "b": ab["b"][:, :3]}
             for n, ab in names.items()} for g, names in layer.items()}
        for layer in bad["language_module"]["layers"]]}
    with pytest.raises(ValueError, match="neither whole nor sliced"):
        tsh.shard_adapters(bad, cfg, _layout(1, 2, 0))
    with pytest.raises(NotImplementedError, match="kv heads shared"):
        tsh.shard_adapters(whole, cfg, _layout(1, 4, 1))


# ---------------------------------------------------------------------------
# the mesh server's snapshots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["solo", "pooled"])
def test_mesh_server_snapshots_and_restarts(worlds, kind):
    """/save and /restore of a mesh server answer as the solo server's
    (a restored copy answers as its original); a missing file, and a
    session asked of a full pool, give the solo server's 500 and the
    server serves on; a fresh mesh server's
    ``restore_all`` (its auto-snapshots) brings every session back, and
    its answers equal the solo server's that never stopped."""
    got = worlds[2][0][0]["server"][kind]
    assert got["snap_got"] == got["snap_want"]
    code, body = got["missing"]
    assert code == 500 and body["error"].startswith("FileNotFoundError")
    # a pool of 4 rows holds a, b, c and e: f finds it full (a 500, as
    # the solo server's), and the server serves on
    assert got["created"] == ([200, 200] if kind == "solo" else [200, 500])
    assert got["serving_after"] == 200
    assert got["restored"] == ["a", "b", "c"]
    after = got["after_restart"]
    assert after[0] == after[1] and after[2] == after[3]


def test_sliced_head_adapter_gathers_the_ranks_columns():
    """The static ``logit_ids`` head's lm_head adapter on a vocab-sharded
    decoder: each rank fills the columns its vocab slice holds (zeros
    elsewhere), and the all-reduce (here the sum of the two ranks'
    parts) gives the whole adapter's columns at those ids."""
    from cogstream_tpu_torch.runtime.generate import _sliced_lora_b

    b = torch.randn(4, 10, generator=torch.Generator().manual_seed(0))
    lid = torch.tensor([7, 1, 4, 9])
    parts = []
    for lo, hi in ((0, 5), (5, 10)):
        model = types.SimpleNamespace(tp=types.SimpleNamespace(
            vocab=(lo, hi), group=None))
        part = _sliced_lora_b(model, b[:, lo:hi], lid)
        held = (lid >= lo) & (lid < hi)
        assert torch.equal(part[:, ~held], torch.zeros(4, int((~held).sum())))
        parts.append(part)
    assert torch.equal(parts[0] + parts[1], b[:, lid])
    whole = types.SimpleNamespace(tp=None)
    assert torch.equal(_sliced_lora_b(whole, b, lid), b[:, lid])


# ---------------------------------------------------------------------------
# a server on (data 2, model 2)
# ---------------------------------------------------------------------------

ASK_KEYS = ("text", "selection", "if_visual", "turn", "cache_tokens")


@pytest.mark.parametrize("kind", ["solo", "pooled"])
def test_data_mesh_server_answers_as_solo_and_jax(jref, worlds, kind):
    """``SessionServer(mesh=)`` on (data 2, model 2) over HTTP: solo
    sessions (replicated over the data groups) and a 4-row pool (rows 0-1
    on data group 0, 2-3 on group 1) answer as the solo server on the
    whole model, and as JAX's server on its (2, 2) mesh: creates, ingests,
    AC and FCC asks and a streamed ask."""
    got = worlds[4][0][0]["server_dp"][kind]
    assert got["got"] == got["want"]
    assert len(got["got"]) == 9
    want = jref[f"jserver_{kind}"]
    assert got["got"][:4] == want[:4]
    for g, w in zip(got["got"][4:8], want[4:8]):
        assert {k: g[k] for k in ASK_KEYS} == {k: w[k] for k in ASK_KEYS}
    assert got["got"][8]["text"] == want[8]["text"]
    assert {k: got["got"][8]["meta"][k] for k in ASK_KEYS} == \
        {k: want[8]["meta"][k] for k in ASK_KEYS}


@pytest.mark.parametrize("kind", ["solo", "pooled"])
def test_data_mesh_server_snapshots(worlds, kind):
    """The (2, 2) server's /save, /restore and restart answer as the solo
    server's. Solo sessions: every file (the /save and each
    auto-snapshot) is written and read by rank 0 alone. Pooled: session a
    (row 0) is saved by rank 0, restored as c onto row 2, which data
    group 1 holds: rank 2 alone reads it and writes c's auto-snapshots,
    and reads them back at the restart."""
    got = worlds[4][0][0]["server_dp"][kind]
    assert got["snap_got"] == got["snap_want"]
    code, body = got["missing"]
    assert code == 500 and body["error"].startswith("FileNotFoundError")
    assert got["created"] == ([200, 200] if kind == "solo" else [200, 500])
    assert got["serving_after"] == 200
    assert got["restored"] == ["a", "b", "c"]
    after = got["after_restart"]
    assert after[0] == after[1] and after[2] == after[3]
    stem = f"server_dp_{kind}"
    io = [{op: sorted({p for p in res["snapshot_io"][op]
                       if p.startswith(stem) and not p.endswith("_ref.npz")})
           for op in ("written", "read")} for res, _ in worlds[4]]
    auto = {f"{stem}/{sid}.snap.npz" for sid in ("a", "b", "c")}
    if kind == "solo":
        assert set(io[0]["written"]) == auto | {f"{stem}_a.npz"}
        assert set(io[0]["read"]) == auto | {f"{stem}_a.npz"}
        assert all(not x["written"] and not x["read"] for x in io[1:])
        return
    c = f"{stem}/c.snap.npz"
    assert set(io[0]["written"]) == auto - {c} | {f"{stem}_a.npz"}
    assert io[2]["written"] == [c]
    assert io[2]["read"] == sorted([f"{stem}_a.npz", c])
    assert set(io[0]["read"]) == auto - {c}
    assert not any(x["written"] or x["read"] for x in (io[1], io[3]))


# ---------------------------------------------------------------------------
# int4 shards in one process (threads standing in for ranks)
# ---------------------------------------------------------------------------

class _ThreadGroup:
    """A group of threads standing in for ranks: each all-reduce waits
    for every member's tensor and gives each the combination."""

    def __init__(self, n):
        import threading

        self.n = n
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n
        self.local = threading.local()

    def reduce(self, x, op):
        self.slots[self.local.rank] = x.detach().clone()
        self.barrier.wait()
        stack = torch.stack(list(self.slots))
        self.barrier.wait()
        return stack.sum(0) if op == "sum" else stack.amax(0)


def _threaded(monkeypatch, n, fn):
    """``fn(rank, group)`` on ``n`` threads through one :class:`_ThreadGroup`
    (the port's ``all_reduce`` and group sizes patched to it); the
    results in rank order."""
    import threading

    from cogstream_tpu_torch.parallel import mesh as tmesh

    def reduce(x, group, op="sum"):
        return x if group is None else group.reduce(x, op)

    monkeypatch.setattr(tmesh, "all_reduce", reduce)
    monkeypatch.setattr(tquant, "all_reduce", reduce)
    monkeypatch.setattr(tquant, "ranks_in", lambda g: 1 if g is None
                        else g.n)
    group, out, errors = _ThreadGroup(n), [None] * n, []

    def run(r):
        group.local.rank = r
        try:
            out[r] = fn(r, group)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _row_slice(qp, lo, hi, din):
    kinds = {"q4": "q4", "scale": "gs" if "rscale" not in qp else "s",
             "rscale": "r", "code": "rep"}
    return {k: tsh.slice_leaf(v, tsh.LeafSpec(tsh.Spec(inn=(lo, hi)),
                                              kinds[k], din))
            for k, v in qp.items()}


@pytest.mark.parametrize("tp", [2, 4])
def test_int4_w4a8_row_shard_equals_whole(monkeypatch, tp):
    """A row-parallel rank-1 int4 shard's W4A8 forms against the whole
    weight's, on a shape both GEMV routes take (din 1024 / tp packed in
    halves of 128-multiples, dout 256): the prefill branch bit-equal to
    the whole one, K7's and K9's plain routes (m = 3) within 1e-6 of the
    row max of the whole GEMV; with each rank's halves at their own
    scales they miss 1e-3, and at tp = 4 also with only the global halves'
    MAX left out (at tp = 2 each rank's rows are one global half, so the
    MAX has nothing to combine)."""
    from cogstream_tpu_torch.ops import quant_gemv as qg

    rng = np.random.default_rng(0)
    din, dout, m = 1024, 256, 3
    w = torch.tensor(rng.standard_normal((din, dout)), dtype=torch.float32)
    qp = tquant.quantize_int4_rank1(w, nf4=False)
    x = torch.tensor(rng.standard_normal((m, din)), dtype=torch.float32)
    f32 = torch.float32
    whole = {"prefill": tquant._w4a8_prefill(x, qp, f32),
             "k7": qg.int4_rank1_gemv(x, qp, f32, w4a8=True)}
    stacked = {k: v[None] for k, v in qp.items()}
    layer = torch.zeros(1, dtype=torch.int32)
    whole["k9"] = qg.int4_rank1_gemv_stacked(x, stacked, layer, f32,
                                             w4a8=True)
    n = din // tp

    def rank(r, group):
        lo, hi = r * n, (r + 1) * n
        loc = _row_slice(qp, lo, hi, din)
        rows = tquant.RowShard(din, lo, hi, group)
        xl = x[:, lo:hi]
        st = {k: v[None] for k, v in loc.items()}
        out = {"prefill": tquant._w4a8_prefill(xl, loc, f32, rows),
               "k7": tquant.int4_matmul(xl, loc, f32, act_int8=True,
                                        reduce=group, rows=rows),
               "k9": qg.int4_rank1_gemv_stacked(xl, st, layer, f32,
                                                w4a8=True, rows=rows),
               "local": tquant.int4_matmul(xl, loc, f32, act_int8=True,
                                           reduce=group)}
        solo = tquant.RowShard(din, lo, hi, None)       # no MAX
        out["no_max"] = group.reduce(qg.int4_rank1_gemv_plain(
            xl, loc, f32, w4a8=True, rows=solo), "sum")
        return out

    assert qg.gemv_viable(_row_slice(qp, 0, n, din), m)
    for out in _threaded(monkeypatch, tp, rank):
        assert torch.equal(out["prefill"], whole["prefill"])
        top = whole["k7"].abs().amax(-1, keepdim=True)
        for key in ("k7", "k9"):
            assert ((out[key] - whole[key]).abs() / top).max() <= 1e-6
        assert ((out["local"] - whole["k7"]).abs() / top).max() > 1e-3
        miss = ((out["no_max"] - whole["k7"]).abs() / top).max()
        assert (miss > 1e-3) if tp == 4 else (miss <= 1e-6)
    with pytest.raises(ValueError, match="straddle"):
        tquant.RowShard(12, 2, 8, None).halves()


@pytest.mark.parametrize("nf4", [True, False])
def test_groupwise_shard_quantization_is_the_slice(monkeypatch, nf4):
    """Group-wise NF4 / uniform int4 (groups of 32 along din) of a row
    shard (tp = 2 and 4: each holds whole groups) and of a column shard
    equals the slice of the whole weight's quantization byte for byte,
    the row shard's halves repacked to its own pairing; a weight whose
    whole din the group does not divide falls back to int8 as the whole
    does (the slice of the whole int8); a row shard that splits a group
    raises (four shards of 24 rows of a 96-row weight)."""
    rng = np.random.default_rng(1)
    din, dout, G = 256, 48, 32
    w = torch.tensor(rng.standard_normal((din, dout)), dtype=torch.float32)
    whole = tquant.quantize_kernel(w, 4, G, nf4)
    assert "q4" in whole and "rscale" not in whole

    def same(a, b):
        return set(a) == set(b) and all(
            a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)

    for tp in (2, 4):
        n = din // tp
        got = _threaded(monkeypatch, tp, lambda r, g: tquant.quantize_kernel(
            w[r * n:(r + 1) * n], 4, G, nf4, row_group=g))
        for r, part in enumerate(got):
            assert same(part, _row_slice(whole, r * n, (r + 1) * n, din))
    cols = torch.arange(16, 32)
    part = tquant.quantize_kernel(w[:, 16:32], 4, G, nf4, col_group=object())
    assert same(part, {k: v.index_select(-1, cols) for k, v in whole.items()})
    # din 264 is no multiple of 32: int8, column scales over both shards
    w8 = torch.tensor(rng.standard_normal((264, dout)), dtype=torch.float32)
    want = tquant.quantize_kernel(w8, 4, G, nf4)
    assert "q" in want
    got = _threaded(monkeypatch, 2, lambda r, g: tquant.quantize_kernel(
        w8[r * 132:(r + 1) * 132], 4, G, nf4, row_group=g))
    for r, part in enumerate(got):
        assert torch.equal(part["q"], want["q"][r * 132:(r + 1) * 132])
        assert torch.equal(part["scale"], want["scale"])
    with pytest.raises(ValueError, match="whole groups"):
        _threaded(monkeypatch, 4, lambda r, g: tquant.quantize_kernel(
            w[r * 24:(r + 1) * 24], 4, G, nf4, row_group=g))


def test_serve_data_parallel_needs_a_world(monkeypatch):
    """``serve --data-parallel 2`` outside a world of ranks exits with a
    message before loading anything."""
    from cogstream_tpu_torch.runtime import serve

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        serve.main(["--model-dir", "/nonexistent", "--data-parallel", "2"])
