"""The port's prompt-lookup speculative decode against the JAX package, on
the CPU: ``generate_tokens_lookahead`` (the cases of the JAX package's
tests/test_lookahead.py), ``StreamingSession.ask(lookahead_k=)`` with its
fallbacks, ``CogReasonerEngine.generate(lookahead_k=)`` and a one-layer
int4 decoder under ``w4a8_decode``.

Weights come from the JAX initializers through models/bridge.py;
prompts are seeded numpy draws. Tolerances: tokens, ``num_tokens``,
``steps``, write indices and cache positions IDENTICAL to JAX's; cache
K/V within 1e-5 (f32) wherever the position is live (``pos >= 0``: the
rejected slots' stale K/V are never read); the int4 decoder's cache
within 3e-3 of each row's max |ref| (tests/test_torch_quant.py's bound
for whole int4 forwards: bf16 / int8 activation rounding flips).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cogstream_tpu.runtime.engine as jeng_mod
import cogstream_tpu.runtime.session as jsess_mod
import cogstream_tpu_torch.runtime.engine as teng_mod
import cogstream_tpu_torch.runtime.generate as tgen_mod
import cogstream_tpu_torch.runtime.session as tsess_mod
from cogstream_tpu.config import (CogReasonerConfig as JConfig,
                                  CompressionConfig as JCompression,
                                  Qwen2Config as JQwen2Config)
from cogstream_tpu.models import qwen2 as jq
from cogstream_tpu.models.cogreasoner import init_cogreasoner_params
from cogstream_tpu.ops import quant as jquant
from cogstream_tpu.processor.tokenizer import ByteTokenizer as JTok
from cogstream_tpu.runtime.engine import CogReasonerEngine as JEngine
from cogstream_tpu.runtime.generate import (
    generate_tokens_lookahead as j_lookahead)
from cogstream_tpu_torch.config import (CogReasonerConfig as TConfig,
                                        CompressionConfig as TCompression,
                                        Qwen2Config as TQwen2Config)
from cogstream_tpu_torch.models import bridge
from cogstream_tpu_torch.models import qwen2 as tq
from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer as TTok
from cogstream_tpu_torch.runtime.engine import CogReasonerEngine as TEngine
from cogstream_tpu_torch.runtime.generate import (
    generate_tokens as t_generate,
    generate_tokens_lookahead as t_lookahead)
from cogstream_tpu_torch.runtime.pool import SessionPool
from cogstream_tpu_torch.runtime.session import StreamingSession as TSession

TOL = dict(atol=1e-5, rtol=1e-5)
S, NEW = 12, 24
EOS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def text_models():
    """Per seed: the tiny decoder's JAX params, the bridged port model and
    a seeded prompt (tests/test_lookahead.py's setup)."""
    jcfg, tcfg = JConfig.tiny().text, TConfig.tiny().text
    out = {}
    for seed in range(6):
        params = jq.init_qwen2_params(jax.random.PRNGKey(seed), jcfg)
        model = bridge.qwen2_from_params(_np(params), tcfg, device="cpu")
        ids = np.random.default_rng(seed).integers(
            3, 200, size=(1, S)).astype(np.int32)
        out[seed] = (params, model, ids,
                     np.asarray(params["embed_tokens"])[ids])
    return jcfg, out


@pytest.fixture(scope="module")
def jax_runs(text_models):
    """JAX lookahead results by (seed, k, extra kwargs), each run once."""
    jcfg, models = text_models
    memo = {}

    def run(seed, k, max_len=None, ids=None, **kw):
        key = (seed, k, max_len, None if ids is None else ids.tobytes(),
               repr(sorted(kw.items())))
        if key not in memo:
            params, _, ids0, emb = models[seed]
            memo[key] = j_lookahead(
                params, jnp.asarray(emb), jnp.asarray(_pos()),
                jnp.asarray([S - 1], jnp.int32),
                jq.init_kv_cache(jcfg, 1, max_len or S + NEW + k + 1),
                jnp.asarray(ids0 if ids is None else ids), jcfg, NEW,
                eos_id=EOS, lookahead_k=k, **kw)
        return memo[key]

    return run


def _pos(n=S, start=0):
    return np.arange(start, start + n, dtype=np.int32)[None]


def _port(models, seed, k, max_len=None, ids=None, **kw):
    _, model, ids0, emb = models[seed]
    cache = tq.init_kv_cache(model.cfg, 1, max_len or S + NEW + k + 1,
                             device="cpu")
    return t_lookahead(model, torch.from_numpy(emb), torch.from_numpy(_pos()),
                       torch.tensor([S - 1]), cache,
                       ids0 if ids is None else ids, NEW, EOS,
                       lookahead_k=k, **kw)


def _port_vanilla(models, seed, max_len, n_new=NEW, **kw):
    _, model, _, emb = models[seed]
    return t_generate(model, torch.from_numpy(emb), torch.from_numpy(_pos()),
                      torch.tensor([S - 1]),
                      tq.init_kv_cache(model.cfg, 1, max_len, device="cpu"),
                      None, n_new, EOS, **kw)


def _assert_live_cache(tc, jc):
    """Same write index and positions; K/V within TOL where pos >= 0."""
    assert tc.write_index == int(jc.write_index)
    pos = tc.pos.numpy()
    np.testing.assert_array_equal(pos, np.asarray(jc.pos))
    live = pos[0] >= 0
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(a.numpy()[:, :, live],
                                   np.asarray(b)[:, :, live], **TOL)


def _assert_same_as_jax(rt, rj):
    np.testing.assert_array_equal(rt.tokens.numpy(), np.asarray(rj.tokens))
    np.testing.assert_array_equal(rt.num_tokens.numpy(),
                                  np.asarray(rj.num_tokens))
    assert rt.steps == int(rj.steps)
    _assert_live_cache(rt.cache, rj.cache)


# ---------------------------------------------------------------------------
# generate_tokens_lookahead
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lookahead_matches_jax(text_models, jax_runs, seed, k):
    """Tokens, num_tokens and the verify-step count equal JAX's; the cache
    too (k = 8 verifies 9 tokens: the K3 route, S > DECODE_MAX_S)."""
    _assert_same_as_jax(_port(text_models[1], seed, k), jax_runs(seed, k))


@pytest.mark.parametrize("seed", [0, 3])
def test_lookahead_exact_greedy_parity(text_models, seed):
    """The lookahead output is the vanilla greedy sequence, and the cache
    is left as the vanilla loop leaves it (write index, positions, live
    K/V): rejected and fed-but-cut slots are blanked on exit."""
    models = text_models[1]
    base = _port_vanilla(models, seed, S + NEW)
    la = _port(models, seed, 4)
    np.testing.assert_array_equal(la.tokens.numpy(), base.tokens.numpy())
    np.testing.assert_array_equal(la.num_tokens.numpy(),
                                  base.num_tokens.numpy())
    assert la.steps <= max(int(la.num_tokens[0]) - 1, 0) + 1
    wi = la.cache.write_index
    assert wi == base.cache.write_index
    assert (la.cache.pos[0, wi:] == -1).all()
    assert torch.equal(la.cache.pos[:, :wi], base.cache.pos[:, :wi])
    for a, b in ((la.cache.k, base.cache.k), (la.cache.v, base.cache.v)):
        np.testing.assert_allclose(a[:, :, :wi].numpy(), b[:, :, :wi].numpy(),
                                   **TOL)


def test_lookahead_accelerates_repetitive_sequences(text_models, jax_runs):
    """Tiny greedy models settle into cycles: the bigram draft accepts and
    some seed emits more than one token per forward, as in JAX."""
    accelerated = 0
    for seed in range(6):
        la = _port(text_models[1], seed, 4)
        assert la.steps == int(jax_runs(seed, 4).steps)
        n = int(la.num_tokens[0])
        if n >= NEW // 2 and la.steps < n - 1:
            accelerated += 1
    assert accelerated >= 1, "no seed produced an accepted draft"


def test_lookahead_stop_ids(text_models, jax_runs):
    """A stop token is kept and everything after it is eos; the cache
    keeps only the emissions before it live, as the vanilla loop's."""
    models = text_models[1]
    stop = int(_port(models, 1, 4).tokens[0, NEW // 2])
    la = _port(models, 1, 4, stop_ids=(stop,))
    _assert_same_as_jax(la, jax_runs(1, 4, stop_ids=(stop,)))
    base = _port_vanilla(models, 1, S + NEW, stop_ids=(stop,))
    np.testing.assert_array_equal(la.tokens.numpy(), base.tokens.numpy())
    wi = la.cache.write_index
    assert wi == base.cache.write_index
    assert (la.cache.pos[0, wi:] == -1).all()
    assert torch.equal(la.cache.pos[:, :wi], base.cache.pos[:, :wi])


def test_lookahead_decoupled_corpus(text_models, jax_runs):
    """A wider, -1-padded match corpus with ``corpus_last`` gives the
    aligned corpus's output and steps (the engine's case)."""
    models = text_models[1]
    wide = np.full((1, S + 20), -1, np.int32)
    wide[0, :S] = models[0][2]
    got = _port(models, 0, 4, ids=wide, corpus_last=[S - 1])
    aligned = _port(models, 0, 4)
    np.testing.assert_array_equal(got.tokens.numpy(), aligned.tokens.numpy())
    assert got.steps == aligned.steps
    _assert_same_as_jax(got, jax_runs(0, 4, ids=wide,
                                      corpus_last=jnp.asarray([S - 1])))


def test_lookahead_kv_window(text_models, jax_runs):
    """Windowed: the unwindowed output, every slot at or after the window
    untouched, the same cache as JAX's windowed call; a window without
    room for the k+1 overhang raises."""
    models = text_models[1]
    k = 4
    win = S + NEW + k + 1
    big = win + 64
    full = _port(models, 3, k, max_len=big)
    wind = _port(models, 3, k, max_len=big, kv_window=win)
    np.testing.assert_array_equal(full.tokens.numpy(), wind.tokens.numpy())
    assert torch.equal(full.cache.pos[:, :win], wind.cache.pos[:, :win])
    assert (wind.cache.pos[0, win:] == -1).all()
    assert (wind.cache.k[:, :, win:] == 0).all()
    _assert_same_as_jax(wind, jax_runs(3, k, max_len=big, kv_window=win))
    with pytest.raises(ValueError, match="needed for lookahead"):
        _port(models, 3, k, max_len=big, kv_window=S + NEW)


def test_lookahead_cache_reusable_for_next_turn(text_models):
    """A follow-up prefill + decode on the lookahead turn's cache equals
    the same follow-up on the vanilla turn's cache."""
    models = text_models[1]
    k, n_new = 4, 12
    total = S + n_new + k + 1 + 8 + 12
    _, model, ids, emb = models[2]
    base = _port_vanilla(models, 2, total, n_new=n_new)
    la = t_lookahead(model, torch.from_numpy(emb), torch.from_numpy(_pos()),
                     torch.tensor([S - 1]),
                     tq.init_kv_cache(model.cfg, 1, total, device="cpu"),
                     ids, n_new, EOS, lookahead_k=k)
    ids2 = np.random.default_rng(9).integers(3, 200, size=(1, 8))
    emb2 = torch.from_numpy(np.asarray(model.embed_tokens[ids2]))
    outs = []
    for res in (base, la):
        pos2 = torch.from_numpy(_pos(8, S + int(res.num_tokens[0])))
        r2 = t_generate(model, emb2, pos2, torch.tensor([7]), res.cache,
                        None, 12, EOS)
        outs.append(r2.tokens.numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("accept", [0, 2, 4])
def test_lookahead_fixed_schedule(text_models, jax_runs, accept):
    """fixed_draft = the model's own greedy continuation: every verify
    accepts exactly ``accept`` drafts, so steps is closed-form; the
    tokens stay the teacher's and everything equals JAX's."""
    jcfg, models = text_models
    k = 4
    params, model, ids, emb = models[4]
    base = t_generate(model, torch.from_numpy(emb), torch.from_numpy(_pos()),
                      torch.tensor([S - 1]),
                      tq.init_kv_cache(model.cfg, 1, S + NEW + k,
                                       device="cpu"), None, NEW + k, -1)
    teacher = base.tokens[0].numpy().astype(np.int32)
    runs = [t_lookahead(model, torch.from_numpy(emb),
                        torch.from_numpy(_pos()), torch.tensor([S - 1]),
                        tq.init_kv_cache(model.cfg, 1, S + NEW + k + 1,
                                         device="cpu"),
                        ids, NEW, -1, lookahead_k=k, fixed_draft=teacher,
                        fixed_accept=accept) for _ in range(2)]
    la = runs[0]
    np.testing.assert_array_equal(la.tokens.numpy(), teacher[None, :NEW])
    assert la.steps == -(-(NEW - 1) // (accept + 1)) == runs[1].steps
    rj = j_lookahead(params, jnp.asarray(emb), jnp.asarray(_pos()),
                     jnp.asarray([S - 1], jnp.int32),
                     jq.init_kv_cache(jcfg, 1, S + NEW + k + 1),
                     jnp.asarray(ids), jcfg, NEW, eos_id=-1, lookahead_k=k,
                     fixed_draft=jnp.asarray(teacher), fixed_accept=accept)
    _assert_same_as_jax(la, rj)


def _oracle(next_of):
    """A tiny decoder whose greedy next token depends only on the token
    fed: ``next_of[t]``, else ``t`` itself. Attention and MLP outputs are
    zeroed, so a position's hidden state is its normalized embedding, and
    each head column sums the embeddings of the tokens that map to it.
    Returns (JAX params, port model, run) with ``run(package, prompt,
    n_new, k, **kw)`` a lookahead call on a fresh cache."""
    jcfg, tcfg = JConfig.tiny().text, TConfig.tiny().text
    params = jax.tree.map(np.array, jq.init_qwen2_params(
        jax.random.PRNGKey(0), jcfg))
    for grp, name in (("attn", "o_proj"), ("mlp", "down_proj")):
        params["layers"][grp][name]["kernel"][:] = 0
    params["final_norm"]["scale"][:] = 1
    emb = params["embed_tokens"]
    head = np.zeros_like(emb)
    for t in range(emb.shape[0]):
        head[next_of.get(t, t)] += emb[t]
    params["lm_head"]["kernel"] = np.ascontiguousarray(head.T)
    model = bridge.qwen2_from_params(params, tcfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)

    def run(package, prompt, n_new, k, **kw):
        e, n = emb[prompt], S + n_new + k + 1
        if package == "jax":
            return j_lookahead(jparams, jnp.asarray(e), jnp.asarray(_pos()),
                               jnp.asarray([S - 1], jnp.int32),
                               jq.init_kv_cache(jcfg, 1, n),
                               jnp.asarray(prompt), jcfg, n_new,
                               eos_id=EOS, lookahead_k=k, **kw)
        return t_lookahead(model, torch.from_numpy(e),
                           torch.from_numpy(_pos()), torch.tensor([S - 1]),
                           tq.init_kv_cache(tcfg, 1, n, device="cpu"),
                           prompt, n_new, EOS, lookahead_k=k, **kw)

    return model, run


def test_lookahead_drafts_copy_stale_eos(monkeypatch):
    """The draft reads JAX's history BUFFER, whose entries past the fill
    level hold the eos padding of earlier verify steps. On a decoder that
    repeats its input token and maps 50 to 0, the prompt makes the first
    two drafts miss, so stale eos entries follow a run of 0s and every
    later draft copies them: JAX's steps. A draft made from a clean list
    of the real tokens (padding read as 0 past the fill level) accepts
    whole drafts of 0s and takes fewer steps."""
    _, run = _oracle({50: 0})
    prompt = np.array([[80, 50, 0, 60, 61, 62, 0, 0, 70, 71, 72, 50]],
                      np.int32)
    drafts = []
    real = tgen_mod._lookup_draft

    def recording(hist, hlen, prev, cur, kk):
        drafts.append(real(hist, hlen, prev, cur, kk))
        return drafts[-1]

    monkeypatch.setattr(tgen_mod, "_lookup_draft", recording)
    got = run("port", prompt, 16, 3)
    assert got.tokens[0].tolist() == [0] * 16
    _assert_same_as_jax(got, run("jax", prompt, 16, 3))
    assert any(EOS in d for d in drafts[2:])

    def clean(hist, hlen, prev, cur, kk):
        h = hist.copy()
        h[hlen:] = -1
        return real(h, hlen, prev, cur, kk)

    monkeypatch.setattr(tgen_mod, "_lookup_draft", clean)
    other = run("port", prompt, 16, 3)
    assert other.tokens[0].tolist() == [0] * 16
    assert other.steps < got.steps


def test_lookahead_accepted_terminal_cuts_the_draft():
    """A drafted stop token can be ACCEPTED with more accepted drafts after
    it: only the emissions up to the first terminal count (``prior_fin``),
    the rest are eos, and the exit leaves none of the fed-but-cut slots
    live. Here 60 -> 61 -> 62 (the stop id) -> 62, and the prompt's
    earlier ``60 61`` is followed by ``62 62 62``, so the one verify step
    accepts all three drafts."""
    model, run = _oracle({60: 61, 61: 62})
    prompt = np.array([[80, 60, 61, 62, 62, 62, 81, 82, 83, 84, 85, 60]],
                      np.int32)
    got = run("port", prompt, 8, 3, stop_ids=(62,))
    assert got.tokens[0].tolist() == [61, 62] + [EOS] * 6
    assert got.steps == 1
    _assert_same_as_jax(got, run("jax", prompt, 8, 3, stop_ids=(62,)))
    e = torch.from_numpy(np.asarray(model.embed_tokens[prompt]))
    base = t_generate(model, e, torch.from_numpy(_pos()),
                      torch.tensor([S - 1]),
                      tq.init_kv_cache(model.cfg, 1, S + 8, device="cpu"),
                      None, 8, EOS, stop_ids=(62,))
    np.testing.assert_array_equal(got.tokens.numpy(), base.tokens.numpy())
    assert got.cache.write_index == base.cache.write_index == S + 1
    assert (got.cache.pos[0, S + 1:] == -1).all()


# ---------------------------------------------------------------------------
# the session, the pool and the engine
# ---------------------------------------------------------------------------

EVENTS = dict(frames_per_event=3, keyframes_per_event=1)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(JConfig.tiny(),
                               compression=JCompression(**EVENTS))
    tcfg = dataclasses.replace(TConfig.tiny(),
                               compression=TCompression(**EVENTS))
    params = init_cogreasoner_params(jax.random.PRNGKey(0), jcfg)
    model = bridge.cogreasoner_from_params(_np(params), tcfg, device="cpu")
    return jcfg, tcfg, params, model


TURNS = [([0.0, 1.0, 2.0], "what is happening?", "AC"),
         ([3.0, 4.0, 5.0], "and now?", "FCC")]


def _segment():
    t, gh, gw = 3, 4, 4
    pv = np.random.default_rng(0).normal(
        size=(t * gh * gw, 3 * 14 * 14)).astype(np.float32)
    return pv, (t, gh, gw)


def _dialogue(sess, **ask_kw):
    pv, grid = _segment()
    out = []
    for stamps, q, mode in TURNS:
        sess.append_stream_segment(pv, grid, 2, timestamps=stamps)
        out.append(sess.ask(q, mode=mode, max_new_tokens=12, **ask_kw))
    return out


def test_session_lookahead_matches_jax(setup, monkeypatch):
    """Two turns (AC, FCC) with lookahead_k=4 in both packages: tokens,
    texts, verify steps, slot ranges, write index and cache equal JAX's;
    and the port's lookahead dialogue is the vanilla dialogue (texts,
    ranges, positions), its answer slots accounted with no special
    case."""
    jcfg, tcfg, params, model = setup
    jruns = []

    def recording(*a, **k):
        r = j_lookahead(*a, **k)
        jruns.append((np.asarray(r.tokens)[0, :int(r.num_tokens[0])]
                      .tolist(), int(r.steps)))
        return r

    monkeypatch.setattr(jsess_mod, "generate_tokens_lookahead", recording)
    js = jsess_mod.StreamingSession(params, jcfg,
                                    JTok(image_token_id=1000), max_len=1024)
    ts = TSession(model, tcfg, TTok(image_token_id=1000), max_len=1024)
    pv, grid = _segment()
    for i, (stamps, q, mode) in enumerate(TURNS):
        js.append_stream_segment(pv, grid, 2, timestamps=stamps)
        ts.append_stream_segment(pv, grid, 2, timestamps=stamps)
        rj = js.ask(q, mode=mode, max_new_tokens=12, lookahead_k=4)
        rt = ts.ask(q, mode=mode, max_new_tokens=12, lookahead_k=4)
        assert (rt["tokens"], ts.last_lookahead_steps) == jruns[i]
        for key in rj:
            assert rt[key] == rj[key], key
    assert len(jruns) == 2
    assert [dataclasses.astuple(r) for r in ts.ranges] == \
        [dataclasses.astuple(r) for r in js.ranges]
    assert ts.next_pos == js.next_pos
    _assert_live_cache(ts.cache, js.cache)

    vs = TSession(model, tcfg, TTok(image_token_id=1000), max_len=1024)
    van = _dialogue(vs)
    assert [r["text"] for r in van] == ts.hist_as
    assert vs.ranges == ts.ranges and vs.write_index == ts.write_index
    assert torch.equal(vs.cache.pos, ts.cache.pos)
    assert vs.last_lookahead_steps is None


@pytest.mark.parametrize("kw", [dict(temperature=0.7), dict(top_p=0.9),
                                dict(top_k=5),
                                dict(repetition_penalty=1.05)],
                         ids=["temperature", "top_p", "top_k", "penalty"])
def test_session_sampling_falls_back(setup, monkeypatch, kw):
    """Sampling params or a repetition penalty take the vanilla decoder
    silently: the same answers as lookahead_k=0 (the same generator
    draws), and the lookahead decoder never runs."""
    _, tcfg, _, model = setup
    outs = [_dialogue(TSession(model, tcfg, TTok(image_token_id=1000),
                               max_len=1024), **kw)]

    def forbidden(*a, **k):
        raise AssertionError("lookahead ran")

    monkeypatch.setattr(tsess_mod, "generate_tokens_lookahead", forbidden)
    sess = TSession(model, tcfg, TTok(image_token_id=1000), max_len=1024)
    outs.append(_dialogue(sess, lookahead_k=4, **kw))
    assert outs[0] == outs[1]
    assert sess.last_lookahead_steps is None


def test_pooled_session_falls_back(setup, monkeypatch):
    """A session stored in a pool row decodes vanilla whatever its
    lookahead_k: the same answers, ranges and positions as lookahead_k=0."""
    _, tcfg, _, model = setup

    def run(**kw):
        pool = SessionPool(model, tcfg, TTok(image_token_id=1000),
                           n_rows=2, max_len=1024)
        pool.open()
        row = pool.open()
        out = _dialogue(pool.sessions[row], **kw)
        return out, pool.sessions[row].ranges, pool.cache.pos.clone()

    ref = run()

    def forbidden(*a, **k):
        raise AssertionError("lookahead ran")

    monkeypatch.setattr(tsess_mod, "generate_tokens_lookahead", forbidden)
    got = run(lookahead_k=4)
    assert got[0] == ref[0] and got[1] == ref[1]
    assert torch.equal(got[2], ref[2])


@pytest.mark.parametrize("k", [2, 8])
def test_engine_lookahead_matches_jax(setup, monkeypatch, k):
    """``CogReasonerEngine.generate(lookahead_k=)`` on a text turn with an
    answered turn in its history: the same tokens and verify steps as the
    JAX engine's (the corpus is the rewritten conversation's ids, -1-padded
    to their own bucket), and the port's vanilla tokens."""
    jcfg, tcfg, params, model = setup
    seen = {"jax": [], "port": []}

    def recorder(fn, key):
        def run(*a, **kw):
            r = fn(*a, **kw)
            seen[key].append((np.asarray(r.tokens)[0, :int(
                np.asarray(r.num_tokens)[0])].tolist(), int(r.steps)))
            return r
        return run

    monkeypatch.setattr(jeng_mod, "generate_tokens_lookahead",
                        recorder(j_lookahead, "jax"))
    monkeypatch.setattr(teng_mod, "generate_tokens_lookahead",
                        recorder(t_lookahead, "port"))
    conv = [{"role": "user", "content": "what is the first scene?"},
            {"role": "assistant", "content": "a noisy pattern."},
            {"role": "user", "content": "and what came after it?"}]
    jeng = JEngine(params, jcfg, JTok(image_token_id=1000))
    teng = TEngine(model, tcfg, TTok(image_token_id=1000))
    ref = jeng.chat(conv, mode="AC", max_new_tokens=16, lookahead_k=k)
    got = teng.chat(conv, mode="AC", max_new_tokens=16, lookahead_k=k)
    van = teng.chat(conv, mode="AC", max_new_tokens=16)
    assert dataclasses.astuple(got) == dataclasses.astuple(ref) \
        == dataclasses.astuple(van)
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 1


def test_int4_w4a8_lookahead_matches_jax(monkeypatch):
    """A one-layer rank-1 int4 decoder with ``w4a8_decode``: every verify
    step (S = k+1 < 16) takes the W4A8 route in both packages, as does the
    first token's head. Tokens and steps equal JAX's; the live cache within
    3e-3 of each row's max |ref|."""
    text = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                num_hidden_layers=1, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=512,
                bos_token_id=1, eos_token_id=2, dtype="float32",
                w4a8_decode=True)
    monkeypatch.setattr(jquant, "_gemv_route_ok", lambda: True)
    jcfg = JQwen2Config(**text)
    qparams = jquant.quantize_tree(
        jq.init_qwen2_params(jax.random.PRNGKey(1), jcfg), bits=4,
        rank1=True, nf4=False)
    model = bridge.qwen2_from_params(_np(qparams), TQwen2Config(**text),
                                     device="cpu")
    k, n_new = 4, 12
    ids = np.random.default_rng(1).integers(3, 200, (1, S)).astype(np.int32)
    emb = np.asarray(qparams["embed_tokens"])[ids]
    rj = j_lookahead(qparams, jnp.asarray(emb), jnp.asarray(_pos()),
                     jnp.asarray([S - 1], jnp.int32),
                     jq.init_kv_cache(jcfg, 1, S + n_new + k + 1),
                     jnp.asarray(ids), jcfg, n_new, eos_id=EOS,
                     lookahead_k=k)
    rt = t_lookahead(model, torch.from_numpy(emb), torch.from_numpy(_pos()),
                     torch.tensor([S - 1]),
                     tq.init_kv_cache(model.cfg, 1, S + n_new + k + 1,
                                      device="cpu"),
                     ids, n_new, EOS, lookahead_k=k)
    np.testing.assert_array_equal(rt.tokens.numpy(), np.asarray(rj.tokens))
    assert rt.steps == int(rj.steps)
    tc, jc = rt.cache, rj.cache
    assert tc.write_index == int(jc.write_index)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    live = tc.pos.numpy()[0] >= 0
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        a, b = a.numpy()[:, :, live], np.asarray(b)[:, :, live]
        err = np.abs(a - b)
        bound = 3e-3 * np.abs(b).max(axis=-1, keepdims=True)
        assert (err <= bound).all(), float((err / bound).max())
