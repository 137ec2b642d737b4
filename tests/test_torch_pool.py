"""The port's pooled serving path against the JAX package, on the CPU:
``qwen2_forward`` with ``write_slots`` + ``cache_rows``, K4's plain route
with ``rows``, pooled ``generate_tokens``, ``Selector.select_batch``,
``SessionPool`` (ingest, ingest_batch, ask_batch in AC / FCC / NC, the
solo pooled ask, ask_stream), ``reset``, pool-row compaction, session
snapshots across the packages, and the per-row generators.

Weights come from the JAX initializers through models/bridge.py (f32);
inputs are seeded numpy draws. Tokens, selections, slot ranges,
``next_pos``, cache positions and fill levels are IDENTICAL; K/V, hidden
states and event reps agree to atol = rtol = 1e-4 (the session tests'
tolerance). K/V are compared at the slots a position tags (pos >= 0):
slots past a compacted row's fill level hold bytes nothing reads (the
JAX compaction copies slot 0 there, the port leaves them).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cogstream_tpu.runtime.session as jsess_mod
from cogstream_tpu.config import (CogReasonerConfig as JConfig,
                                  CompressionConfig as JCompression)
from cogstream_tpu.models import qwen2 as jq
from cogstream_tpu.models.cogreasoner import init_cogreasoner_params
from cogstream_tpu.ops import lm_attention as jlma
from cogstream_tpu.processor.tokenizer import ByteTokenizer as JTok
from cogstream_tpu.runtime.generate import generate_tokens as j_generate
from cogstream_tpu.runtime.pool import SessionPool as JPool
from cogstream_tpu.runtime.retrieval import Selector as JSelector
from cogstream_tpu_torch.config import (CogReasonerConfig as TConfig,
                                        CompressionConfig as TCompression)
from cogstream_tpu_torch.models import bridge
from cogstream_tpu_torch.models import qwen2 as tq
from cogstream_tpu_torch.ops import lm_attention as tlma
from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer as TTok
from cogstream_tpu_torch.runtime.generate import generate_tokens as t_generate
from cogstream_tpu_torch.runtime.pool import SessionPool as TPool
from cogstream_tpu_torch.runtime.retrieval import Selector as TSelector
from cogstream_tpu_torch.runtime.session import StreamingSession as TSession

TOL = dict(atol=1e-4, rtol=1e-4)
# three frames per event: with two, the keyframe pick is a rounding tie
COMP = dict(frames_per_event=3, keyframes_per_event=1)
SEG = (3, 4, 4)      # frames, grid h, grid w (merge 2: 4 tokens a frame)


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
    jtok = JTok(image_token_id=jcfg.image_token_index)
    ttok = TTok(image_token_id=tcfg.image_token_index)
    return jcfg, tcfg, params, model, jtok, ttok


def _segment(seed):
    t, gh, gw = SEG
    rng = np.random.default_rng(seed)
    return rng.normal(size=(t * gh * gw, 3 * 14 * 14)).astype(np.float32)


def _assert_pool_cache(tc, jc, live_only=False):
    jpos = np.asarray(jc.pos)
    np.testing.assert_array_equal(tc.pos.numpy(), jpos)
    tk, tv = tc.k.numpy(), tc.v.numpy()
    jk, jv = np.asarray(jc.k), np.asarray(jc.v)
    if live_only:
        live = jpos >= 0
        tk, tv, jk, jv = (a[:, live] for a in (tk, tv, jk, jv))
    np.testing.assert_allclose(tk, jk, **TOL)
    np.testing.assert_allclose(tv, jv, **TOL)


def _assert_sessions(ts, js):
    assert [dataclasses.astuple(r) for r in ts.ranges] == \
        [dataclasses.astuple(r) for r in js.ranges]
    assert ts.write_index == js.write_index
    assert ts.next_pos == js.next_pos
    assert ts.total_frames == js.total_frames
    assert ts.hist_qs == js.hist_qs and ts.hist_as == js.hist_as
    assert len(ts.events) == len(js.events)
    for te, je in zip(ts.events, js.events):
        assert te.keyframe_mask == je.keyframe_mask
        assert te.shadow_slots == je.shadow_slots
        assert [s.tolist() for s in te.frame_slots] == \
            [np.asarray(s).tolist() for s in je.frame_slots]
        np.testing.assert_allclose(te.rep.cpu().numpy(), np.asarray(je.rep),
                                   **TOL)
    assert len(ts._pending_frames) == len(js._pending_frames)


def _same_answer(rt, rj):
    for key in ("text", "selection", "if_visual", "turn", "cache_tokens"):
        assert rt[key] == rj[key], key


# ---------------------------------------------------------------------------
# the forward, K4 and the decode loop
# ---------------------------------------------------------------------------

def _filled_pool(setup, T, fills, seed=0):
    """A 3-row pool cache in both packages, row b filled to fills[b]."""
    jcfg, _, params, model, _, _ = setup
    rng = np.random.default_rng(seed)
    H, B, S = jcfg.text.hidden_size, len(fills), max(fills)
    jc = jq.init_kv_cache(jcfg.text, B, T)
    tc = tq.init_kv_cache(model.text.cfg, B, T, device="cpu")
    emb = rng.standard_normal((B, S, H)).astype(np.float32)
    pos = np.full((B, S), -1, np.int32)
    ws = np.full((B, S), T, np.int64)
    for b, f in enumerate(fills):
        pos[b, :f] = np.arange(f)
        ws[b, :f] = np.arange(f)
    _, jc = jq.qwen2_forward(params["text"], jnp.asarray(emb),
                             jnp.asarray(pos), jcfg.text, cache=jc,
                             write_slots=jnp.asarray(ws))
    tq.qwen2_forward(model.text, torch.from_numpy(emb),
                     torch.from_numpy(pos), tc, write_slots=ws)
    _assert_pool_cache(tc, jc)
    return jc, tc


@pytest.mark.parametrize("rows", [[2], [0, 2]])
def test_forward_write_slots_cache_rows(setup, rows):
    """Rows of a 3-row pool prefill at their own fill levels through
    ``cache_rows``; padded slots are dropped; rows the call does not
    address stay bit-identical."""
    jcfg, _, params, model, _, _ = setup
    T, fills = 256, [40, 10, 25]
    jc, tc = _filled_pool(setup, T, fills)
    before = (tc.k.clone(), tc.v.clone(), tc.pos.clone())
    rng = np.random.default_rng(1)
    B, S = len(rows), 8
    emb = rng.standard_normal((B, S, jcfg.text.hidden_size)).astype(
        np.float32)
    pos = np.full((B, S), -1, np.int32)
    ws = np.full((B, S), T, np.int64)
    for i, r in enumerate(rows):
        n = 5 + i
        pos[i, :n] = 100 + np.arange(n)
        ws[i, :n] = fills[r] + np.arange(n)
    hj, jc = jq.qwen2_forward(params["text"], jnp.asarray(emb),
                              jnp.asarray(pos), jcfg.text, cache=jc,
                              write_slots=jnp.asarray(ws),
                              cache_rows=jnp.asarray(rows, jnp.int32))
    ht, tc = tq.qwen2_forward(model.text, torch.from_numpy(emb),
                              torch.from_numpy(pos), tc, write_slots=ws,
                              cache_rows=rows)
    real = pos >= 0
    np.testing.assert_allclose(ht.numpy()[real], np.asarray(hj)[real],
                               **TOL)
    _assert_pool_cache(tc, jc)
    assert tc.write_index == 0      # pooled rows keep their own fill
    for r in set(range(3)) - set(rows):
        assert torch.equal(tc.k[:, r], before[0][:, r])
        assert torch.equal(tc.v[:, r], before[1][:, r])
        assert torch.equal(tc.pos[r], before[2][r])


def test_decode_attention_rows_matches_jax():
    """K4's plain route with ``rows`` against the JAX kernel's ``rows``
    operand (``decode_splash_attention``, interpret mode), as
    tests/test_lm_attention.py drives it: the JAX kernel reads main ⊕
    side ⊕ fresh, the port one pool cache holding that concatenation in
    the addressed rows."""
    rng = np.random.default_rng(4)
    L, B, Bp, T, Ts, S, Hq, Hkv, D = 2, 2, 4, 256, 32, 1, 4, 2, 128
    rows = np.asarray([3, 1], np.int32)
    fills, side_fill = [100, 200, 40, 150], 3
    mk = rng.standard_normal((L, Bp, T, Hkv, D)).astype(np.float32)
    mv = rng.standard_normal((L, Bp, T, Hkv, D)).astype(np.float32)
    mpos = np.full((Bp, T), -1, np.int32)
    for b in range(Bp):
        mpos[b, :fills[b]] = np.arange(fills[b])
        mpos[b, fills[b] // 2] = -1
    sk = rng.standard_normal((L, B, Ts, Hkv, D)).astype(np.float32)
    sv = rng.standard_normal((L, B, Ts, Hkv, D)).astype(np.float32)
    spos = np.full((B, Ts), -1, np.int32)
    for b in range(B):
        spos[b, :side_fill] = fills[rows[b]] + np.arange(side_fill)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    kn = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    step_pos = np.stack([fills[r] + side_fill + np.arange(S)
                         for r in rows]).astype(np.int32)
    eff_m = jnp.repeat(jlma.effective_kv_positions(
        jnp.asarray(mpos))[rows], Hkv, axis=1)
    eff_s = jnp.repeat(jlma.effective_kv_positions(jnp.asarray(spos)), Hkv,
                       axis=1)
    # the port's pool cache: addressed rows hold main ⊕ side ⊕ fresh
    Tc = T + Ts + S
    pk = np.zeros((L, Bp, Tc, Hkv, D), np.float32)
    pv = np.zeros_like(pk)
    ppos = np.full((Bp, Tc), -1, np.int32)
    pk[:, :, :T], pv[:, :, :T], ppos[:, :T] = mk, mv, mpos
    for b, r in enumerate(rows):
        pk[:, r, T:T + Ts], pv[:, r, T:T + Ts] = sk[:, b], sv[:, b]
        pk[:, r, T + Ts:], pv[:, r, T + Ts:] = kn[None, b], vn[None, b]
        ppos[r, T:T + Ts] = spos[b]
        ppos[r, T + Ts:] = step_pos[b]
    eff = tlma.effective_kv_positions(torch.from_numpy(ppos))[list(rows)]
    for li in range(L):
        ref = jlma.decode_splash_attention(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
            jnp.asarray(mk), jnp.asarray(mv), jnp.asarray(sk),
            jnp.asarray(sv), jnp.int32(li), jnp.asarray(step_pos), eff_m,
            eff_s, rows=jnp.asarray(rows), interpret=True)
        out = tlma.decode_attention(
            torch.from_numpy(q), torch.from_numpy(pk[li]),
            torch.from_numpy(pv[li]), torch.from_numpy(step_pos),
            eff.contiguous(), rows=rows.tolist())
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)


def test_rows_checked_on_the_host():
    q = torch.zeros((2, 1, 4, 64))
    k = torch.zeros((3, 64, 2, 64))
    pos = torch.zeros((2, 1), dtype=torch.int32)
    eff = torch.zeros((2, 64), dtype=torch.int32)
    for bad in ([1, 1], [0, 3], [0]):
        with pytest.raises(ValueError):
            tlma.decode_attention(q, k, k, pos, eff, rows=bad)
        with pytest.raises(ValueError):
            tlma.prefill_flash_attention(q, k, k, pos, eff, rows=bad)


@pytest.mark.parametrize("rows", [None, [2, 0]])
def test_pooled_generate_tokens(setup, rows):
    """Pooled prefill + greedy decode: rows at different fill levels, one
    row inactive (done from the start), per-row kv_allowed, a read
    window; tokens, counts and the whole cache equal the JAX side-buffer
    loop's merged cache."""
    jcfg, _, params, model, _, _ = setup
    T, fills = 256, [40, 10, 25]
    jc, tc = _filled_pool(setup, T, fills, seed=2)
    order = rows or [0, 1, 2]
    active = [True, False, True][:len(order)] if rows is None \
        else [True, True]
    rng = np.random.default_rng(3)
    B, S = len(order), 8
    ids = rng.integers(16, 272, (B, S))
    emb = np.asarray(params["text"]["embed_tokens"])[ids]
    pos = np.full((B, S), -1, np.int32)
    ws = np.full((B, S), T, np.int64)
    last = np.zeros((B,), np.int32)
    for i, r in enumerate(order):
        n = 4 + 2 * i
        pos[i, :n] = 300 + np.arange(n)
        ws[i, :n] = fills[r] + np.arange(n)
        last[i] = n - 1
    allowed = rng.random((B, T)) > 0.3
    kw_j = dict(write_slots=jnp.asarray(ws), active=jnp.asarray(active),
                kv_window=128, kv_allowed=jnp.asarray(allowed))
    kw_t = dict(write_slots=ws, active=torch.tensor(active), kv_window=128,
                kv_allowed=torch.from_numpy(allowed))
    if rows is not None:
        kw_j["cache_rows"] = jnp.asarray(rows, jnp.int32)
        kw_t["cache_rows"] = rows
    rj = j_generate(params["text"], jnp.asarray(emb), jnp.asarray(pos),
                    jnp.asarray(last), jc, jax.random.PRNGKey(0), jcfg.text,
                    10, 2, **kw_j)
    rt = t_generate(model.text, torch.from_numpy(emb), torch.from_numpy(pos),
                    torch.from_numpy(last), tc, None, 10, 2, **kw_t)
    np.testing.assert_array_equal(rt.tokens.numpy(), np.asarray(rj.tokens))
    np.testing.assert_array_equal(rt.num_tokens.numpy(),
                                  np.asarray(rj.num_tokens))
    _assert_pool_cache(rt.cache, rj.cache)
    assert rt.cache.write_index == 0   # pooled rows keep their own fill


def test_select_batch(setup):
    """Three histories of different lengths in one constrained decode."""
    jcfg, _, params, model, jtok, ttok = setup
    js = JSelector(params["text"], jcfg.text, jtok)
    ts = TSelector(model.text, ttok)
    items = [("and now?", ["what is it?"], ["a cat"]),
             ("is it moving?", ["what?", "where?", "who?"],
              ["a dog", "on a mat", "nobody"]),
             ("why?", [], [])]
    out_t = ts.select_batch(items)
    assert out_t == js.select_batch(items)
    assert out_t[0] == ts.select(*items[0])
    assert ts.prefix_hits == js.prefix_hits + 1


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

def _pools(setup, n_rows=3, max_len=1024, summary_forward=False, seed=0):
    jcfg, tcfg, params, model, jtok, ttok = setup
    jp = JPool(params, jcfg, jtok, n_rows=n_rows, max_len=max_len,
               summary_forward=summary_forward, seed=seed)
    tp = TPool(model, tcfg, ttok, n_rows=n_rows, max_len=max_len,
               summary_forward=summary_forward, seed=seed)
    return jp, tp


def _drain(gen):
    items = list(gen)
    return items[:-1], items[-1]


@pytest.mark.parametrize("summary_forward", [False, True])
def test_pool_matches_jax(setup, summary_forward):
    """ingest, ingest_batch, ask_batch AC / FCC / NC, a solo pooled ask
    and ask_stream on a 3-row pool, in both packages."""
    jp, tp = _pools(setup, summary_forward=summary_forward)
    t = SEG[0]
    for p in (jp, tp):
        assert [p.open() for _ in range(3)] == [0, 1, 2]
    for p in (jp, tp):
        p.ingest(0, _segment(0), SEG, 2, [0.0, 1.0, 2.0])
        p.ingest_batch([(b, _segment(10 + b), SEG, 2,
                         [3.0 + i for i in range(t)]) for b in (2, 0, 1)])
    steps = [([(0, "what is happening?"), (1, "who is there?"),
               (2, "where is it?")], "AC"),
             ([(0, "and now?"), (2, "is it moving?")], "FCC"),
             ([(1, "why?")], "NC")]
    for reqs, mode in steps:
        oj = jp.ask_batch(reqs, mode=mode, max_new_tokens=8)
        ot = tp.ask_batch(reqs, mode=mode, max_new_tokens=8)
        assert sorted(ot) == sorted(oj)
        for b in oj:
            _same_answer(ot[b], oj[b])
    _same_answer(tp.ask(1, "what did I ask?", mode="FCC", max_new_tokens=6),
                 jp.ask(1, "what did I ask?", mode="FCC", max_new_tokens=6))
    dj, fj = _drain(jp.sessions[2].ask_stream("tell me more", mode="AC",
                                              max_new_tokens=8, chunk=3))
    dt, ft = _drain(tp.sessions[2].ask_stream("tell me more", mode="AC",
                                              max_new_tokens=8, chunk=3))
    assert dt == dj and ft == fj
    for b in range(3):
        _assert_sessions(tp.sessions[b], jp.sessions[b])
    _assert_pool_cache(tp.cache, jp.cache)


def test_pool_reset_and_row_compaction(setup):
    """A small max_len forces the second ingest to evict and compact a
    pool row in place; ``reset`` then clears it; the other row stays
    bit-identical through both."""
    jp, tp = _pools(setup, n_rows=2, max_len=320)
    for p in (jp, tp):
        p.open(), p.open()
        p.ingest(1, _segment(5), SEG, 2, [0.0, 1.0, 2.0])
    other = (tp.cache.k[:, 1].clone(), tp.cache.pos[1].clone())
    for seed, stamps in ((0, [0.0, 1.0, 2.0]), (1, [3.0, 4.0, 5.0])):
        for p in (jp, tp):
            p.ingest(0, _segment(seed), SEG, 2, stamps)
        _same_answer(tp.ask(0, "what now?", mode="AC", max_new_tokens=6),
                     jp.ask(0, "what now?", mode="AC", max_new_tokens=6))
    assert tp.sessions[0].ranges[0].kind == "system"
    assert len(tp.sessions[0].events) == 1     # the first event went
    _assert_sessions(tp.sessions[0], jp.sessions[0])
    _assert_pool_cache(tp.cache, jp.cache, live_only=True)
    for p in (jp, tp):
        p.sessions[0].reset()
    _assert_sessions(tp.sessions[0], jp.sessions[0])
    _assert_pool_cache(tp.cache, jp.cache, live_only=True)
    assert torch.equal(tp.cache.k[:, 1], other[0])
    assert torch.equal(tp.cache.pos[1], other[1])


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pooled", [False, True])
def test_jax_snapshot_restores_into_the_port(setup, pooled, tmp_path):
    """A JAX session's ``save`` loads into the port (solo, or a pool row
    through ``open_restored``); the next greedy ask equals the JAX
    package's continued ask (its solo session, or the snapshot restored
    into a JAX pool row: a pool row packs its prompts tightly). The
    snapshot holds an open event window."""
    jcfg, tcfg, params, model, jtok, ttok = setup
    js = jsess_mod.StreamingSession(params, jcfg, jtok, max_len=1024)
    js.append_stream_segment(_segment(0), SEG, 2, [0.0, 1.0, 2.0])
    js.append_stream_segment(_segment(1)[:32], (2, 4, 4), 2, [3.0, 4.0])
    js.ask("what is happening?", mode="AC", max_new_tokens=6)
    path = str(tmp_path / "j.snap.npz")
    js.save(path)
    assert len(js._pending_frames) == 2
    if pooled:
        tp = TPool(model, tcfg, ttok, n_rows=2, max_len=1024)
        tp.open()
        ts = tp.sessions[tp.open_restored(path)]
        jp = JPool(params, jcfg, jtok, n_rows=2, max_len=1024)
        jp.open()
        js = jp.sessions[jp.open_restored(path)]
    else:
        ts = TSession(model, tcfg, ttok, max_len=1024)
        ts.load_state(path)
    _assert_sessions(ts, js)
    row, jrow = (ts._row, js._row) if pooled else (0, 0)
    wi = js.write_index
    np.testing.assert_array_equal(ts.cache.pos[row].numpy(),
                                  np.asarray(js.cache.pos[jrow]))
    np.testing.assert_allclose(ts.cache.k[:, row, :wi].numpy(),
                               np.asarray(js.cache.k[:, jrow, :wi]), **TOL)
    _same_answer(ts.ask("and now?", mode="FCC", max_new_tokens=8),
                 js.ask("and now?", mode="FCC", max_new_tokens=8))
    ts.append_stream_segment(_segment(2)[:16], (1, 4, 4), 2, [5.0])
    js.append_stream_segment(_segment(2)[:16], (1, 4, 4), 2, [5.0])
    _assert_sessions(ts, js)


def test_port_snapshot_round_trip(setup, tmp_path):
    """save -> load_state into a fresh pool row reproduces the row's
    cache bits and all bookkeeping; the generator state travels too."""
    _, tcfg, _, model, _, ttok = setup
    tp = TPool(model, tcfg, ttok, n_rows=3, max_len=512,
               summary_forward=True, seed=3)
    a = tp.open()
    tp.ingest(a, _segment(0), SEG, 2, [0.0, 1.0, 2.0])
    tp.ingest(a, _segment(1)[:16], (1, 4, 4), 2, [3.0])
    tp.ask(a, "what?", mode="AC", max_new_tokens=5, temperature=1.0)
    path = str(tmp_path / "t.snap.npz")
    tp.sessions[a].save(path)
    b = tp.open_restored(path)
    sa, sb = tp.sessions[a], tp.sessions[b]
    wi = sa.write_index
    assert torch.equal(tp.cache.k[:, b, :wi], tp.cache.k[:, a, :wi])
    assert torch.equal(tp.cache.v[:, b, :wi], tp.cache.v[:, a, :wi])
    assert torch.equal(tp.cache.pos[b], tp.cache.pos[a])
    for key in ("ranges", "next_pos", "total_frames", "hist_qs", "hist_as",
                "_wi", "_system_prompt"):
        assert getattr(sb, key) == getattr(sa, key), key
    for x, y in zip(sa.events, sb.events):
        assert torch.equal(x.rep, y.rep)
        assert x.keyframe_mask == y.keyframe_mask
    assert [f.frame_id for f in sa._pending_frames] == \
        [f.frame_id for f in sb._pending_frames]
    for x, y in zip(sa._pending_frames, sb._pending_frames):
        assert torch.equal(x.frame_rows, y.frame_rows)
        assert np.array_equal(x.feat, y.feat)
    assert torch.equal(sa._gen.get_state(), sb._gen.get_state())
    ra = sa.ask("more?", mode="AC", max_new_tokens=6, temperature=1.0)
    rb = sb.ask("more?", mode="AC", max_new_tokens=6, temperature=1.0)
    assert ra["tokens"] == rb["tokens"]


def test_corrupt_snapshot_releases_its_row(setup, tmp_path):
    _, tcfg, _, model, _, ttok = setup
    tp = TPool(model, tcfg, ttok, n_rows=2, max_len=256)
    tp.open()
    bad = tmp_path / "bad.snap.npz"
    bad.write_bytes(b"not a snapshot")
    with pytest.raises(Exception):
        tp.open_restored(str(bad))
    assert sorted(tp.sessions) == [0]
    # a snapshot whose meta names a missing array fails the same way
    s = tp.sessions[0]
    path = str(tmp_path / "ok.snap.npz")
    s.save(path)
    d = dict(np.load(path))
    meta = json.loads(str(d["meta"]))
    meta["events"] = [{"frame_ids": [0], "frame_slots": [[0]],
                       "shadow_slots": [0], "keyframe_mask": [True]}]
    d["meta"] = np.asarray(json.dumps(meta))
    np.savez(path, **d)
    with pytest.raises(KeyError):
        tp.open_restored(path)
    assert sorted(tp.sessions) == [0]
    assert tp.open() == 1


# ---------------------------------------------------------------------------
# sampling: properties (torch and JAX draws differ)
# ---------------------------------------------------------------------------

def test_sampled_pool_decodes_reproducible_and_independent(setup):
    """Batched sampling follows the pool's seeded generator (same seed,
    same outputs); solo sampled asks follow each row's own generator,
    seeded (seed << 16) ^ (row + 1), so two rows with the same history
    draw different streams."""
    _, tcfg, _, model, _, ttok = setup

    def run(seed):
        tp = TPool(model, tcfg, ttok, n_rows=2, max_len=512,
                   summary_forward=False, seed=seed)
        for _ in range(2):
            r = tp.open()
            tp.ingest(r, _segment(0), SEG, 2, [0.0, 1.0, 2.0])
        batch = tp.ask_batch([(0, "describe this"), (1, "describe this")],
                             mode="AC", max_new_tokens=12, temperature=1.0)
        solo = [tp.ask(r, "and then?", mode="AC", max_new_tokens=12,
                       temperature=1.0)["tokens"] for r in (0, 1)]
        return [batch[r]["tokens"] for r in (0, 1)], solo

    a, b = run(7), run(7)
    assert a == b
    assert a[0][0] != a[0][1]          # the batch draws per row
    assert a[1][0] != a[1][1]          # per-row generators differ
    assert run(8) != a


# ---------------------------------------------------------------------------
# no row copy: every pooled attention call reads the pool cache in place
# ---------------------------------------------------------------------------

def test_pooled_attention_reads_the_pool_cache_in_place(setup, monkeypatch):
    """Every K3 / K4 call of a pooled ingest, batched ask, solo ask and
    ask_stream (AC: no selector, whose own cache is not the pool's) gets
    the pool's whole [B_pool, T] K/V storage and a row map, never a
    gathered copy of a row: the only copy left is inside the kernels'
    plain version, which the card never runs."""
    _, tcfg, _, model, _, ttok = setup
    tp = TPool(model, tcfg, ttok, n_rows=3, max_len=512,
               summary_forward=False)
    calls = []

    def spy(fn):
        def wrapped(q, k, v, *a, rows=None, **kw):
            calls.append((k.untyped_storage().data_ptr(),
                          v.untyped_storage().data_ptr(), k.shape[0],
                          None if rows is None else rows.host))
            return fn(q, k, v, *a, rows=rows, **kw)
        return wrapped

    for name in ("decode_attention", "prefill_flash_attention"):
        monkeypatch.setattr(tq, name, spy(getattr(tq, name)))
    for _ in range(3):
        tp.open()
    tp.ingest_batch([(b, _segment(20 + b), SEG, 2, [0.0, 1.0, 2.0])
                     for b in range(3)])
    tp.ask_batch([(0, "what is here?"), (2, "and there?")], mode="AC",
                 max_new_tokens=4)
    n_batch = len(calls)
    tp.ask(1, "what did I ask?", mode="AC", max_new_tokens=4)
    n_solo = len(calls)
    _drain(tp.sessions[2].ask_stream("more", mode="AC", max_new_tokens=6,
                                     chunk=2))
    assert 0 < n_batch < n_solo < len(calls)
    store = (tp.cache.k.untyped_storage().data_ptr(),
             tp.cache.v.untyped_storage().data_ptr())
    for kp, vp, b_pool, rows in calls:
        assert (kp, vp) == store and b_pool == 3
    assert {c[3] for c in calls[n_batch:n_solo]} == {(1,)}
    assert {c[3] for c in calls[n_solo:]} == {(2,)}
