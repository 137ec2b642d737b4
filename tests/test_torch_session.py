"""The PyTorch port's serving runtime against the JAX package, on the CPU:
``generate_tokens``, ``Selector.select``, and the slice as a whole — a
tiny-config ``StreamingSession`` in both packages running ingest →
ask(AC) → ingest → ask(FCC).

Weights come from the JAX initializers through models/bridge.py;
inputs are seeded numpy draws. Greedy tokens, selection strings, slot
ranges, cache positions and write indices must be IDENTICAL; cache K/V
and event representations agree to atol = rtol = 1e-4 (f32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cogstream_tpu.runtime.session as jsess_mod
from cogstream_tpu.config import (CogReasonerConfig as JConfig,
                                  CompressionConfig as JCompression,
                                  LoRAConfig)
from cogstream_tpu.models import qwen2 as jq
from cogstream_tpu.models.cogreasoner import init_cogreasoner_params
from cogstream_tpu.models.lora import init_qwen2_lora
from cogstream_tpu.processor.tokenizer import ByteTokenizer as JTok
from cogstream_tpu.runtime.generate import generate_tokens as j_generate
from cogstream_tpu.runtime.retrieval import Selector as JSelector
from cogstream_tpu_torch.config import (CogReasonerConfig as TConfig,
                                        CompressionConfig as TCompression)
from cogstream_tpu_torch.models import bridge
from cogstream_tpu_torch.models import qwen2 as tq
from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer as TTok
from cogstream_tpu_torch.runtime.generate import generate_tokens as t_generate
from cogstream_tpu_torch.runtime.retrieval import Selector as TSelector
from cogstream_tpu_torch.runtime.session import StreamingSession as TSession

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = JConfig.tiny(), TConfig.tiny()
    params = init_cogreasoner_params(jax.random.PRNGKey(0), jcfg)
    model = bridge.cogreasoner_from_params(jax.tree.map(np.asarray, params),
                                           tcfg, device="cpu")
    return jcfg, tcfg, params, model


def _assert_cache(tc, jc):
    assert tc.write_index == int(jc.write_index)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)


@pytest.mark.parametrize("mode", ["answer", "selector", "penalty"])
def test_generate_tokens(setup, mode):
    """Prefill after existing history (under kv_allowed + a read window
    for the answer mode), then greedy decode; tokens and the final cache
    must match the JAX side-buffer loop's merged cache."""
    jcfg, _, params, model = setup
    rng = np.random.default_rng(0)
    H, T = jcfg.text.hidden_size, 2048
    jc = jq.init_kv_cache(jcfg.text, 1, T)
    tc = tq.init_kv_cache(model.text.cfg, 1, T, device="cpu")
    hist = rng.standard_normal((1, 64, H)).astype(np.float32)
    hp = np.arange(64, dtype=np.int32)[None]
    _, jc = jq.qwen2_forward(params["text"], jnp.asarray(hist),
                             jnp.asarray(hp), jcfg.text, cache=jc)
    tq.qwen2_forward(model.text, torch.from_numpy(hist),
                     torch.from_numpy(hp), tc)
    S, real = 32, 27
    ids = rng.integers(16, 272, (1, S))
    emb = np.asarray(params["text"]["embed_tokens"])[ids]
    pos = np.full((1, S), -1, np.int32)
    pos[0, :real] = 64 + np.arange(real)
    last = np.array([real - 1], np.int32)
    kw_j, kw_t = {}, {}
    if mode == "answer":
        allowed = rng.random((1, T)) > 0.4
        allowed[:, 64:] = True
        kw_j = dict(kv_allowed=jnp.asarray(allowed), kv_window=1024)
        kw_t = dict(kv_allowed=torch.from_numpy(allowed), kv_window=1024)
        n_new = 12
    elif mode == "penalty":
        kw_j = dict(repetition_penalty=1.3, extra_eos_ids=(700,),
                    penalty_ids=jnp.asarray(np.where(pos >= 0, ids, -1)))
        kw_t = dict(repetition_penalty=1.3, extra_eos_ids=(700,),
                    penalty_ids=torch.from_numpy(np.where(pos >= 0, ids, -1)))
        n_new = 12
    else:
        tok = JTok(image_token_id=jcfg.image_token_index)
        from cogstream_tpu.processor.tokenizer import (
            constrained_selector_token_ids, selector_stop_token_ids)
        kw_j = kw_t = dict(
            logit_ids=tuple(constrained_selector_token_ids(tok)),
            stop_ids=tuple(selector_stop_token_ids(tok)))
        n_new = 24
    rj = j_generate(params["text"], jnp.asarray(emb), jnp.asarray(pos),
                    jnp.asarray(last), jc, jax.random.PRNGKey(0), jcfg.text,
                    n_new, 2, **kw_j)
    rt = t_generate(model.text, torch.from_numpy(emb), torch.from_numpy(pos),
                    torch.from_numpy(last), tc, None, n_new, 2, **kw_t)
    np.testing.assert_array_equal(rt.tokens.numpy(), np.asarray(rj.tokens))
    np.testing.assert_array_equal(rt.num_tokens.numpy(),
                                  np.asarray(rj.num_tokens))
    _assert_cache(rt.cache, rj.cache)


def _lora(cfg, seed):
    lora = init_qwen2_lora(jax.random.PRNGKey(seed), cfg.text,
                           LoRAConfig(rank=4))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda x: np.asarray(
        rng.standard_normal(x.shape) * 0.05, np.float32), lora)
    return ([(jax.tree.map(jnp.asarray, tree), jnp.float32(1.0))],
            [(bridge.adapter_from_params(tree, device="cpu"), 1.0)])


def test_selector_select(setup):
    jcfg, _, params, model = setup
    ja, ta = _lora(jcfg, 1)
    jtok = JTok(image_token_id=jcfg.image_token_index)
    ttok = TTok(image_token_id=jcfg.image_token_index)
    js = JSelector(params["text"], jcfg.text, jtok, adapters=ja)
    ts = TSelector(model.text, ttok, adapters=ta)
    hq, ha = ["what is it?", "where?"], ["a cat", "on a mat"]
    for q in ("and now?", "is it moving?"):
        assert ts.select(q, hq, ha) == js.select(q, hq, ha)
    assert ts.prefix_hits == js.prefix_hits == 2
    # without the shared prefix KV: one full prefill, same selection
    ts_full = TSelector(model.text, ttok, adapters=ta, prefix_cache=False)
    assert ts_full.select("and now?", hq, ha) == js.select("and now?", hq, ha)
    assert ts_full.prefix_hits == 0


# Three frames per event: with two, both frames sit at the same distance
# from their mean and the keyframe pick is a rounding-level tie.
EVENTS = dict(frames_per_event=3, keyframes_per_event=1)
SESSION_CASES = {  # compression, uint8 rows, max_len, max_prefill_chunk
    # the flow of tests/test_train_session.py::test_streaming_session_turns
    "turns": (EVENTS, False, 2048, None),
    # event pruning live from the first event (every event scores below
    # the threshold), uint8 patch rows normalized on the device
    "pruning": (dict(EVENTS, min_events_for_compression=1,
                     similarity_threshold=2.0), True, 2048, None),
    # a 320-slot cache: the second ingest evicts the oldest segment (and
    # its event) and compacts the cache
    "eviction": (EVENTS, False, 320, None),
    # prefills longer than 32 tokens split into chunk prefills
    "chunked": (EVENTS, False, 2048, 32),
}


@pytest.mark.parametrize("case", sorted(SESSION_CASES))
def test_streaming_session_slice(setup, case, monkeypatch):
    jcfg0, tcfg0, params, model = setup
    comp, uint8, max_len, chunk = SESSION_CASES[case]
    jcfg = dataclasses.replace(jcfg0, compression=JCompression(**comp))
    tcfg = dataclasses.replace(tcfg0, compression=TCompression(**comp))
    if chunk is not None:
        monkeypatch.setattr(jsess_mod.StreamingSession, "max_prefill_chunk",
                            chunk)
        monkeypatch.setattr(TSession, "max_prefill_chunk", chunk)
    jtok = JTok(image_token_id=jcfg.image_token_index)
    ttok = TTok(image_token_id=tcfg.image_token_index)

    jtokens = []   # answer tokens of the JAX session's generate calls

    def recording_generate(*a, **k):
        r = j_generate(*a, **k)
        jtokens.append(np.asarray(r.tokens)[0, :int(r.num_tokens[0])]
                       .tolist())
        return r

    monkeypatch.setattr(jsess_mod, "generate_tokens", recording_generate)
    js = jsess_mod.StreamingSession(params, jcfg, jtok, max_len=max_len)
    ts = TSession(model, tcfg, ttok, max_len=max_len)

    rng = np.random.default_rng(0)
    t, gh, gw, ms = 3, 4, 4, 2
    shape = (t * gh * gw, 3 * 14 * 14)
    pv = (rng.integers(0, 256, shape, dtype=np.uint8) if uint8
          else rng.normal(size=shape).astype(np.float32))
    turns = [([0.0, 1.0, 2.0], "what is happening?", "AC"),
             ([3.0, 4.0, 5.0], "and now?", "FCC")]
    for stamps, question, mode in turns:
        js.append_stream_segment(pv, (t, gh, gw), ms, timestamps=stamps)
        ts.append_stream_segment(pv, (t, gh, gw), ms, timestamps=stamps)
        rj = js.ask(question, mode=mode, max_new_tokens=8)
        rt = ts.ask(question, mode=mode, max_new_tokens=8)
        assert rt["tokens"] == jtokens[-1]
        for key in ("text", "selection", "if_visual", "turn",
                    "cache_tokens"):
            assert rt[key] == rj[key], key

    assert [dataclasses.astuple(r) for r in ts.ranges] == \
        [dataclasses.astuple(r) for r in js.ranges]
    assert ts.write_index == js.write_index
    assert ts.next_pos == js.next_pos
    assert ts.hist_qs == js.hist_qs and ts.hist_as == js.hist_as
    assert len(ts.events) == len(js.events) == (1 if case == "eviction"
                                                else 2)
    for te, je in zip(ts.events, js.events):
        assert te.keyframe_mask == je.keyframe_mask
        assert te.shadow_slots == je.shadow_slots
        np.testing.assert_allclose(te.rep.numpy(), np.asarray(je.rep), **TOL)
    _assert_cache(ts.cache, js.cache)
