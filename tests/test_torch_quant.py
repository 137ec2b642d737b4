"""The port's 4-bit serving mode against the JAX package, on the CPU:
quantizers, the plain versions of K6-K9, the GEMV route decision, the
int4 decoder forward, the bridge, and a tiny int4 streaming session.

Inputs are seeded numpy draws. Where the JAX function reaches its Pallas
GEMV it runs in interpret mode: direct calls pass ``interpret=True``;
model and session runs force the route on with
``monkeypatch.setattr(quant, "_gemv_route_ok", lambda: True)``, as the
JAX package's own tests do (without it the CPU takes the XLA path and
``w4a8_decode`` does nothing there). The port needs no switch: on the
CPU each wrapper runs its plain version.

Tolerances: quantizer bytes exact. bf16-dot GEMVs within 1e-5 of each
row's max |ref| (the same bf16 operands and exact f32 products; only
the f32 summation order differs). W4A8 GEMVs bit-identical (exact
integer sums, then the same f32 epilogue in the same order). One int4
projection (``dense``: GEMV + bias + LoRA), and the logits of one hidden
state, within 1e-5 of each row's max |ref|. Whole int4 decoder forwards:
every element within 3e-3 of its row's max |ref|, the session's cache
within 5e-3, not the bf16 model's 1e-4: the GEMV route rounds each
activation to bf16 (or int8) before the dot, so an f32 difference of one
ulp upstream (attention and norms sum in another order) flips a rounding
now and then, a step of 2^-8 (bf16) or 1/127 of the row's absmax (int8)
in one activation. Measured on these shapes: forwards up to 1.5e-3 of
the row max (the cache-free W4A8 forward), the session's cache up to
2.6e-3. A forward run in the other ``w4a8_decode`` mode than JAX's
misses these bounds (3.2e-3 to 4.5e-3 on the hidden state, 1.1e-2 on
the cache, far more on the logits): ``test_int4_forward_mode_control``
holds the bounds to that. Session tokens, selections, slot ranges and
cache positions exact.
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
                                  LoRAConfig, Qwen2Config as JQwen2Config)
from cogstream_tpu.models import qwen2 as jq
from cogstream_tpu.models.cogreasoner import init_cogreasoner_params
from cogstream_tpu.models.lora import init_qwen2_lora
from cogstream_tpu.ops import quant as jquant
from cogstream_tpu.ops import quant_gemv as jgemv
from cogstream_tpu.processor.tokenizer import ByteTokenizer as JTok
from cogstream_tpu.runtime.generate import generate_tokens as j_generate
from cogstream_tpu_torch.config import (CogReasonerConfig as TConfig,
                                        CompressionConfig as TCompression,
                                        Qwen2Config as TQwen2Config)
from cogstream_tpu_torch.models import bridge
from cogstream_tpu_torch.models import qwen2 as tq
from cogstream_tpu_torch.ops import quant as tquant
from cogstream_tpu_torch.ops import quant_gemv as tgemv
from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer as TTok
from cogstream_tpu_torch.runtime.session import StreamingSession as TSession

KEYS = ("q4", "scale", "rscale", "code")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(qp):
    return {k: torch.from_numpy(np.array(v)) for k, v in qp.items()}


INT4_FWD = 3e-3      # whole int4 forwards (module docstring)
INT4_SESSION = 5e-3  # the int4 session's cache


def _row_ratio(got, ref, rtol) -> float:
    """Worst ratio of an element's error to ``rtol`` times its row's max
    |ref| (an all-zero row must match exactly)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    bound = np.broadcast_to(rtol * np.abs(ref).max(axis=-1, keepdims=True),
                            err.shape)
    ratio = np.divide(err, bound, out=np.where(err > 0, np.inf, 0.0),
                      where=bound > 0)
    return float(ratio.max())


def _row_close(got, ref, rtol):
    """Every row within ``rtol`` of its own max |ref|."""
    ratio = _row_ratio(got, ref, rtol)
    assert ratio <= 1.0, ratio


# ---------------------------------------------------------------------------
# (a) quantizers: bytes equal to JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(256, 384), (2, 128, 256)])
@pytest.mark.parametrize("scheme", ["uniform", "cubic", "int8"])
def test_quantizers_byte_equal(shape, scheme):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    w[..., 3, :] *= 9.0                       # a heavy row and column
    w[..., 5] *= 0.01
    if scheme == "int8":
        ref = jquant.quantize_int8(jnp.asarray(w))
        got = tquant.quantize_int8(torch.from_numpy(w))
        keys = ("q", "scale")
    else:
        nf4 = scheme == "cubic"
        ref = jquant.quantize_int4_rank1(jnp.asarray(w), nf4=nf4)
        got = tquant.quantize_int4_rank1(torch.from_numpy(w), nf4=nf4)
        keys = KEYS
        np.testing.assert_array_equal(
            tquant.dequantize_int4(got, torch.float32).numpy(),
            np.asarray(jquant.dequantize_int4(ref, jnp.float32)))
    for k in keys:
        assert got[k].dtype == getattr(torch, str(np.asarray(ref[k]).dtype))
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), k)


def test_int8_act_and_unpack_exact():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((5, 96)) * 3).astype(np.float32)
    x[2] = 0.0                                # the 1e-6 absmax floor
    qj, sj = jquant.quantize_int8_act(jnp.asarray(x))
    qt, st = tquant.quantize_int8_act(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    packed = rng.integers(-128, 128, (7, 9)).astype(np.int8)
    for a, b in zip(tquant._unpack_halves(torch.from_numpy(packed)),
                    jquant._unpack_halves(jnp.asarray(packed))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# (b) plain K6-K9 against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

def _stacked(L, din, dout, seed):
    w = np.random.default_rng(seed).standard_normal(
        (L, din, dout)).astype(np.float32)
    return _np(jquant.quantize_int4_rank1(jnp.asarray(w), nf4=False))


@pytest.mark.parametrize("m", [1, 3, 17])
@pytest.mark.parametrize("variant", ["K6", "K6_cubic", "K7"])
def test_gemv_2d_plain_vs_pallas(variant, m):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((512, 256)).astype(np.float32)
    qp = _np(jquant.quantize_int4_rank1(jnp.asarray(w),
                                        nf4=variant == "K6_cubic"))
    x = rng.standard_normal((m, 512)).astype(np.float32)
    w4a8 = variant == "K7"
    ref = jgemv.int4_rank1_gemv(jnp.asarray(x), jax.tree.map(jnp.asarray, qp),
                                jnp.float32, w4a8=w4a8, interpret=True)
    got = tgemv.int4_rank1_gemv(torch.from_numpy(x), _t(qp), torch.float32,
                                w4a8=w4a8)
    if w4a8:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        _row_close(got.numpy(), ref, 1e-5)


@pytest.mark.parametrize("m", [1, 3, 17])
@pytest.mark.parametrize("variant", ["K8", "K9"])
def test_gemv_stacked_plain_vs_pallas(variant, m):
    qp = _stacked(3, 256, 384, 3)
    x = np.random.default_rng(4).standard_normal((m, 256)).astype(np.float32)
    w4a8 = variant == "K9"
    ids = torch.arange(3, dtype=torch.int32)
    for layer in (0, 2):
        ref = jgemv.int4_rank1_gemv_stacked(
            jnp.asarray(x), jax.tree.map(jnp.asarray, qp),
            jnp.asarray(layer, jnp.int32), jnp.float32, w4a8=w4a8,
            interpret=True)
        got = tgemv.int4_rank1_gemv_stacked(
            torch.from_numpy(x), _t(qp), ids[layer:layer + 1], torch.float32,
            w4a8=w4a8)
        if w4a8:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        else:
            _row_close(got.numpy(), ref, 1e-5)
        # the *_plain wrapper (the card checks' reference) is the same code
        plain = tgemv.int4_rank1_gemv_stacked_plain(
            torch.from_numpy(x), _t(qp), ids[layer:layer + 1],
            torch.float32, w4a8=w4a8)
        assert torch.equal(plain, got)


def test_gemv_bf16_output_and_batch_dims():
    rng = np.random.default_rng(5)
    qp = _np(jquant.quantize_int4_rank1(
        jnp.asarray(rng.standard_normal((256, 384)).astype(np.float32)),
        nf4=False))
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    ref = jgemv.int4_rank1_gemv(jnp.asarray(x), jax.tree.map(jnp.asarray, qp),
                                jnp.bfloat16, interpret=True)
    got = tgemv.int4_rank1_gemv(torch.from_numpy(x), _t(qp), torch.bfloat16)
    assert got.shape == (2, 3, 384) and got.dtype == torch.bfloat16
    # f32 sums in another order, then one bf16 rounding on each side
    _row_close(got.float().numpy(), np.asarray(ref, np.float32), 2 ** -7)


# ---------------------------------------------------------------------------
# (c) the route decision equals JAX's
# ---------------------------------------------------------------------------

def test_route_decision_matches_jax():
    halves = [64, 128, 256, 896, 1792, 4736, 9472, 100]
    douts = [20, 128, 200, 384, 512, 3584, 18944, 152064]
    for half in halves:
        for dout in douts:
            assert tgemv._pick_blocks(half, dout) == \
                jgemv._pick_blocks(half, dout), (half, dout)
    rng = np.random.default_rng(6)
    for din, dout in [(512, 256), (256, 384), (512, 200), (200, 256),
                      (256, 20)]:
        w = rng.standard_normal((2, din, dout)).astype(np.float32)
        for nf4 in (False, True):
            jq3 = jquant.quantize_int4_rank1(jnp.asarray(w), nf4=nf4)
            tq3 = tquant.quantize_int4_rank1(torch.from_numpy(w), nf4=nf4)
            jq2 = {k: v[0] for k, v in jq3.items()}
            tq2 = {k: v[0] for k, v in tq3.items()}
            for m in (1, 17, 64, 65, 256):
                assert tgemv.gemv_viable(tq2, m) == jgemv.gemv_viable(jq2, m)
                assert tgemv.gemv_viable(tq3, m) == jgemv.gemv_viable(jq3, m)
                assert tgemv.gemv_viable_stacked(tq3, m) == \
                    jgemv.gemv_viable_stacked(jq3, m)
                assert tgemv.gemv_viable_stacked(tq2, m) == \
                    jgemv.gemv_viable_stacked(jq2, m)


def test_unported_schemes_raise():
    w = torch.randn(128, 256)
    group = {"q4": torch.zeros(64, 256, dtype=torch.int8),
             "scale": torch.ones(2, 256)}
    with pytest.raises(NotImplementedError, match="Queue 1 #4"):
        tquant.int4_matmul(torch.randn(1, 128), group)
    qp = tquant.quantize_int4_rank1(w, nf4=False)
    with pytest.raises(NotImplementedError, match="Queue 1 #4"):
        tquant.int4_matmul(torch.randn(65, 128), qp, act_int8=True)
    with pytest.raises(NotImplementedError, match="Queue 1 #4"):
        tquant.quantized_matmul(torch.randn(2, 128),
                                tquant.quantize_int8(w), w8a8=True)


# ---------------------------------------------------------------------------
# (d) the int4 decoder forward, (f) the bridge
# ---------------------------------------------------------------------------

TEXT = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=512,
            bos_token_id=1, eos_token_id=2, dtype="float32")


@pytest.fixture(scope="module")
def int4_text():
    cfg = JQwen2Config(**TEXT)
    params = jq.init_qwen2_params(jax.random.PRNGKey(1), cfg)
    qparams = jquant.quantize_tree(params, bits=4, rank1=True, nf4=False)
    lora = init_qwen2_lora(jax.random.PRNGKey(7), cfg, LoRAConfig(rank=4))
    rng = np.random.default_rng(7)
    tree = jax.tree.map(lambda v: np.asarray(
        rng.standard_normal(v.shape) * 0.05, np.float32), lora)
    model = bridge.qwen2_from_params(_np(qparams), TQwen2Config(**TEXT))
    return (cfg, params, qparams, model,
            [(jax.tree.map(jnp.asarray, tree), jnp.float32(1.0))],
            [(bridge.adapter_from_params(tree), 1.0)])


def test_bridge_matches_port_quantizer(int4_text):
    """quantize_text_ on the port's model of the JAX weights gives the
    bytes of the bridged JAX quantize_tree output; q4 keeps the JAX
    layout [L, din/2, dout]."""
    cfg, params, qparams, model, _, _ = int4_text
    own = tquant.quantize_text_(
        bridge.qwen2_from_params(_np(params), TQwen2Config(**TEXT)))
    for grp, name in tquant.GEMV_SITES:
        ref = model.int4[name]
        assert ref.q4.shape == (2, cfg.hidden_size // 2
                                if name != "down_proj"
                                else cfg.intermediate_size // 2,
                                ref.scale.shape[-1])
        for k in KEYS:
            np.testing.assert_array_equal(getattr(own.int4[name], k).numpy(),
                                          getattr(ref, k).numpy(), k)
            np.testing.assert_array_equal(
                getattr(ref, k).numpy(),
                np.asarray(qparams["layers"][grp][name]["kernel"][k]))
        lin = own.layers[1].attn[name] if grp == "attn" \
            else own.layers[1].mlp[name]
        # per-layer 2D views share the stacked storage
        assert lin.qp()["q4"].data_ptr() == own.int4[name].q4[1].data_ptr()
    for k in KEYS:
        np.testing.assert_array_equal(
            getattr(own.lm_head.store, k).numpy(),
            np.asarray(qparams["lm_head"]["kernel"][k]))
    assert tquant.quantized_bytes(own) == tquant.quantized_bytes(model)


@pytest.mark.parametrize("w8a8", [False, True])
@pytest.mark.parametrize("indexed", [False, True])
def test_int4_dense(int4_text, monkeypatch, indexed, w8a8):
    """One projection on the same input in both packages: the stacked
    weight + layer index (K8/K9; the JAX decode scan's restored view) or
    the layer's 2D slice (K6/K7), plus bias and a LoRA delta."""
    _, _, qparams, model, ja, ta = int4_text
    monkeypatch.setattr(jquant, "_gemv_route_ok", lambda: True)
    x = np.random.default_rng(9).standard_normal((3, 256)).astype(np.float32)
    for grp, name in (("attn", "k_proj"), ("mlp", "down_proj")):
        din = 512 if name == "down_proj" else 256
        xs = np.tile(x, (1, din // 256))
        p = qparams["layers"][grp][name]
        jad = ja[0][0]["layers"][grp][name]
        for li in (0, 1):
            kern = ({**p["kernel"], "layer": jnp.int32(li)} if indexed
                    else {k: v[li] for k, v in p["kernel"].items()})
            jp = {"kernel": kern, **({"bias": p["bias"][li]}
                                     if "bias" in p else {})}
            ref = jq.dense(jnp.asarray(xs), jp,
                           [({"a": jad["a"][li], "b": jad["b"][li]},
                             jnp.float32(1.0))], 2.0, w8a8=w8a8)
            tad = ta[0][0]["layers"][li][grp][name]
            got = tq.dense(torch.from_numpy(xs),
                           getattr(model.layers[li], grp)[name],
                           [(tad, 1.0)], 2.0, w8a8=w8a8, indexed=indexed)
            _row_close(got.numpy(), ref, 1e-5)


def _forward_ratios(int4_text, monkeypatch, cached, jax_w4a8, port_w4a8):
    """A decode step (cached: K8/K9 over the stacked weights) or a short
    cache-free forward (K6/K7 over per-layer 2D slices), with LoRA, in
    both packages: the worst ratio of each output's error to its bound
    (hidden state and cache at INT4_FWD; the logits of JAX's hidden state
    at 1e-5, as one projection)."""
    cfg0, _, qparams, model, ja, ta = int4_text
    monkeypatch.setattr(jquant, "_gemv_route_ok", lambda: True)
    jcfg = dataclasses.replace(cfg0, w4a8_decode=jax_w4a8)
    monkeypatch.setattr(model, "cfg", dataclasses.replace(
        model.cfg, w4a8_decode=port_w4a8))
    rng = np.random.default_rng(8)
    if cached:
        hist = rng.standard_normal((1, 8, 256)).astype(np.float32)
        jc = jq.init_kv_cache(jcfg, 1, 16)
        tc = tq.init_kv_cache(model.cfg, 1, 16)
        hp = np.arange(8, dtype=np.int32)[None]
        _, jc = jq.qwen2_forward(qparams, jnp.asarray(hist), jnp.asarray(hp),
                                 jcfg, cache=jc, adapters=ja)
        tq.qwen2_forward(model, torch.from_numpy(hist), torch.from_numpy(hp),
                         tc, ta)
        emb = rng.standard_normal((1, 1, 256)).astype(np.float32)
        pos = np.array([[8]], np.int32)
    else:
        jc = tc = None
        emb = rng.standard_normal((2, 5, 256)).astype(np.float32)
        pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
        pos[1, -2:] = -1
    counts = {k: getattr(tgemv, k).launches for k in
              ("gemv_k6", "gemv_k7", "gemv_k8", "gemv_k9")}
    hj, jc = jq.qwen2_forward(qparams, jnp.asarray(emb), jnp.asarray(pos),
                              jcfg, cache=jc, adapters=ja)
    ht, tc = tq.qwen2_forward(model, torch.from_numpy(emb),
                              torch.from_numpy(pos), tc, ta)
    ratios = {"hidden": _row_ratio(ht.numpy(), hj, INT4_FWD)}
    lj = jq.lm_logits(qparams, hj, ja, w8a8=jax_w4a8)
    lt = tq.lm_logits(model, torch.from_numpy(np.array(hj)), ta,
                      w8a8=port_w4a8)
    ratios["logits"] = _row_ratio(lt.numpy(), lj, 1e-5)
    if cached:
        assert tc.write_index == int(jc.write_index)
        np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
        for name, a, b in (("k", tc.k, jc.k), ("v", tc.v, jc.v)):
            ratios[name] = _row_ratio(a.numpy()[:, :, :9],
                                      np.asarray(b)[:, :, :9], INT4_FWD)
    # CPU tensors never launch a kernel
    assert counts == {k: getattr(tgemv, k).launches for k in counts}
    return ratios


@pytest.mark.parametrize("w4a8", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_int4_forward(int4_text, monkeypatch, cached, w4a8):
    """The int4 decoder forward matches JAX's in the same mode."""
    ratios = _forward_ratios(int4_text, monkeypatch, cached, w4a8, w4a8)
    assert max(ratios.values()) <= 1.0, ratios


@pytest.mark.parametrize("jax_w4a8", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_int4_forward_mode_control(int4_text, monkeypatch, cached, jax_w4a8):
    """The control of test_int4_forward's bounds: the port run in the
    other w4a8_decode mode than JAX's must miss them, so a port that
    ignored (or inverted) w4a8_decode cannot pass."""
    ratios = _forward_ratios(int4_text, monkeypatch, cached, jax_w4a8,
                             not jax_w4a8)
    assert max(ratios.values()) > 1.0, ratios


# ---------------------------------------------------------------------------
# (e) the tiny int4 streaming session, W4A8 decode
# ---------------------------------------------------------------------------

def test_int4_session_w4a8(monkeypatch):
    """ingest → ask(AC) → ingest → ask(FCC) on a rank-1 uniform int4
    decoder with w4a8_decode, at the text widths of the JAX package's
    int4 session test; the KV cache is the model's dtype (f32 here; fp8
    KV is not ported)."""
    events = dict(frames_per_event=3, keyframes_per_event=1)

    def cfg_of(C, Comp):
        c = C.tiny()
        return dataclasses.replace(
            c, compression=Comp(**events), text=dataclasses.replace(
                c.text, hidden_size=256, intermediate_size=512,
                num_attention_heads=4, num_key_value_heads=2,
                vocab_size=1024, w4a8_decode=True))

    jcfg, tcfg = cfg_of(JConfig, JCompression), cfg_of(TConfig, TCompression)
    params = init_cogreasoner_params(jax.random.PRNGKey(0), jcfg)
    params = {**params, "text": jquant.quantize_tree(
        params["text"], bits=4, rank1=True, nf4=False)}
    model = bridge.cogreasoner_from_params(_np(params), tcfg)
    assert isinstance(model.text.lm_head, tquant.Int4Linear)
    monkeypatch.setattr(jquant, "_gemv_route_ok", lambda: True)

    jtokens = []

    def recording_generate(*a, **k):
        r = j_generate(*a, **k)
        jtokens.append(np.asarray(r.tokens)[0, :int(r.num_tokens[0])]
                       .tolist())
        return r

    monkeypatch.setattr(jsess_mod, "generate_tokens", recording_generate)
    jtok = JTok(image_token_id=jcfg.image_token_index)
    ttok = TTok(image_token_id=tcfg.image_token_index)
    js = jsess_mod.StreamingSession(params, jcfg, jtok, max_len=1024)
    ts = TSession(model, tcfg, ttok, max_len=1024)
    pv = np.random.default_rng(4).normal(
        size=(3 * 4 * 4, 3 * 14 * 14)).astype(np.float32)
    for stamps, question, mode in (([0.0, 1.0, 2.0], "what?", "AC"),
                                   ([3.0, 4.0, 5.0], "and now?", "FCC")):
        js.append_stream_segment(pv, (3, 4, 4), 2, timestamps=stamps)
        ts.append_stream_segment(pv, (3, 4, 4), 2, timestamps=stamps)
        rj = js.ask(question, mode=mode, max_new_tokens=6)
        rt = ts.ask(question, mode=mode, max_new_tokens=6)
        assert rt["tokens"] == jtokens[-1]
        for key in ("text", "selection", "if_visual", "cache_tokens"):
            assert rt[key] == rj[key], key
    assert [dataclasses.astuple(r) for r in ts.ranges] == \
        [dataclasses.astuple(r) for r in js.ranges]
    assert ts.write_index == js.write_index
    np.testing.assert_array_equal(ts.cache.pos.numpy(), np.asarray(js.cache.pos))
    wi = ts.write_index
    for a, b in ((ts.cache.k, js.cache.k), (ts.cache.v, js.cache.v)):
        _row_close(a.numpy()[:, :, :wi], np.asarray(b)[:, :, :wi],
                   INT4_SESSION)
    for te, je in zip(ts.events, js.events):
        assert te.keyframe_mask == je.keyframe_mask
        _row_close(te.rep.numpy(), np.asarray(je.rep), INT4_FWD)


def test_w8a8_prefill_raises_at_session_construction():
    cfg = TConfig.tiny()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, w8a8_prefill=True))
    from cogstream_tpu_torch.models.cogreasoner import \
        init_cogreasoner_params as t_init
    model = t_init(TConfig.tiny(), torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="Queue 1 #4"):
        TSession(model, cfg, TTok(image_token_id=cfg.image_token_index),
                 max_len=256)
