"""The port's quantized serving modes beyond rank-1 int4 against the JAX
package, on the CPU: group-wise int4 / NF4, ``quantize_tree``, the int8
weight-only decoder (K10's plain version), W8A8 / W4A8 prefill, the
straight-through W8A8 gradient, the W8A8 vision tower, load-time int8,
a tiny session with every mode on, and the quantization-quality probes.

Inputs are seeded numpy draws (or JAX initializers through
models/bridge.py). Where the JAX function reaches a Pallas kernel it runs
as the JAX package's own tests run it on the CPU: the tower's packed path
with ``use_pallas=True`` (interpret mode), the int4 GEMV route forced on
with ``monkeypatch.setattr(jquant, "_gemv_route_ok", lambda: True)``.

Tolerances: quantizer bytes exact, the NF4 codebook bit-equal. Single
products: exact where both sides do the same integer sums and the same
f32 epilogue (``int8_act_matmul``, the W8A8 product), else within 1e-5
of each row's max |ref| (f32 summation order; the NF4 Horner chain or the
W4A8 epilogue may fuse a multiply-add in XLA). Weight-only int8 decoder
forwards: 1e-4 of the row max, as the bf16 model's (only f32 summation
order differs). Forwards with int8 activations: 3e-3 of the row max, as
the int4 forwards of tests/test_torch_quant.py: an f32 difference of one
ulp upstream flips an activation's int8 rounding now and then (a step of
1/127 of the row's absmax); ``test_int8_w8a8_forward_mode_control`` holds
that bound to missing the wrong mode. The W8A8 tower: 1e-2 of the row max
(GEMMs with int8 activations and a gelu between two of them). Some
configurations make a W8A8 forward chaotic: on the quality probes' random
build (uniform weights, embeddings of std 0.02) the port's own W8A8
forward moves by 2% of the row max when its input moves by one ulp, as
far as it lies from JAX's (measured), so there only the size of the W8A8
effect is compared; the tiny session's cache holds such prefills and is
held to 5e-2 of the row max (measured 2.5e-2). Session tokens,
selections, slot ranges and cache positions exact.
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
                                  Qwen2Config as JQwen2Config)
from cogstream_tpu.evaluate import quant_quality as jqq
from cogstream_tpu.models import checkpoint as jck
from cogstream_tpu.models import qwen2 as jq
from cogstream_tpu.models.cogreasoner import init_cogreasoner_params
from cogstream_tpu.models.vision_encoder import (
    build_vision_metadata as j_meta, quantize_vision_w8a8 as j_w8a8,
    vision_encoder_core as j_core, vision_encoder_forward as j_vision)
from cogstream_tpu.ops import quant as jquant
from cogstream_tpu.processor.tokenizer import ByteTokenizer as JTok
from cogstream_tpu.runtime.generate import generate_tokens as j_generate
from cogstream_tpu_torch.config import (CogReasonerConfig as TConfig,
                                        CompressionConfig as TCompression,
                                        Qwen2Config as TQwen2Config)
from cogstream_tpu_torch.evaluate import quant_quality as tqq
from cogstream_tpu_torch.models import bridge
from cogstream_tpu_torch.models import checkpoint as tck
from cogstream_tpu_torch.models import qwen2 as tq
from cogstream_tpu_torch.models import vision_encoder as tve
from cogstream_tpu_torch.ops import int8_gemv as tig
from cogstream_tpu_torch.ops import quant as tquant
from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer as TTok
from cogstream_tpu_torch.runtime.session import StreamingSession as TSession

FWD = 1e-4        # weight-only int8 forwards
ACT8_FWD = 3e-3   # forwards with int8 activations (module docstring)
TOWER = 1e-2      # the W8A8 vision tower
SESSION = 5e-2    # the W8A8 session's cache (module docstring)


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
    ratio = _row_ratio(got, ref, rtol)
    assert ratio <= 1.0, ratio


def _weights(shape, seed=0):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[..., 3, :] *= 9.0                       # a heavy row and column
    w[..., 5] *= 0.01
    return w


# ---------------------------------------------------------------------------
# (a) quantizers: bytes equal to JAX
# ---------------------------------------------------------------------------

def test_poly_nf4_code_is_jax_bit_for_bit():
    """The float64 fit, its coefficients and the 16 levels equal JAX's;
    the f32 Horner evaluation agrees to f32 rounding."""
    assert tquant.POLY_NF4_CODE == jquant.POLY_NF4_CODE
    np.testing.assert_array_equal(tquant._NF4_POLY, jquant._NF4_POLY)
    u = np.arange(16, dtype=np.float32)
    np.testing.assert_allclose(
        tquant._nf4_poly_eval(torch.from_numpy(u)).numpy(),
        np.asarray(jquant._nf4_poly_eval(jnp.asarray(u))), rtol=0,
        atol=2e-7)


@pytest.mark.parametrize("shape,group", [((256, 96), 64), ((2, 128, 64), 32),
                                         ((64, 40), 64)])
@pytest.mark.parametrize("nf4", [False, True])
def test_quantize_int4_group_byte_equal(shape, group, nf4):
    """Group-wise uniform (int8 nibbles) and NF4 (uint8 codebook indices)
    bytes and scales equal JAX's; so does the materializing dequant (to
    f32 rounding for NF4's polynomial)."""
    w = _weights(shape)
    ref = jquant.quantize_int4(jnp.asarray(w), group_size=group, nf4=nf4)
    got = tquant.quantize_int4(torch.from_numpy(w), group_size=group, nf4=nf4)
    for k in ("q4", "scale"):
        assert got[k].dtype == getattr(torch, str(np.asarray(ref[k]).dtype))
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), k)
    np.testing.assert_allclose(
        tquant.dequantize_int4(got, torch.float32).numpy(),
        np.asarray(jquant.dequantize_int4(ref, jnp.float32)), rtol=1e-6,
        atol=0)
    lo, hi = tquant._unpack_halves(got["q4"])
    for a, b in zip((lo, hi), jquant._unpack_halves(ref["q4"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _tree(rng):
    """A plain params tree with kernels at several depths, a list, a
    ``patch_embed`` (din 588, which no group of 64 divides) and an odd din
    (63, which no 4-bit scheme takes)."""
    def lin(din, dout):
        return {"kernel": rng.standard_normal((din, dout)).astype(np.float32),
                "bias": rng.standard_normal(dout).astype(np.float32)}
    return {"patch_embed": lin(588, 64),
            "layers": [{"attn": {"q": lin(128, 64)},
                        "mlp": {"fc1": lin(64, 96)}} for _ in range(2)],
            "head": {"kernel": rng.standard_normal((2, 64, 32)).astype(
                np.float32)},
            "odd": lin(63, 16),
            "norm": {"scale": np.ones(64, np.float32)}}


@pytest.mark.parametrize("kw", [dict(bits=8), dict(bits=4),
                                dict(bits=4, nf4=False, group_size=32),
                                dict(bits=4, rank1=True),
                                dict(bits=4, rank1=True, nf4=False),
                                dict(bits=8, pred=True)])
def test_quantize_tree_byte_equal(kw):
    """quantize_tree over the same tree in both packages: the same walk,
    the same predicate veto, the int8 fallback for the din the 4-bit
    schemes refuse, every leaf equal byte for byte."""
    kw = dict(kw)
    pred = (lambda name: name != "patch_embed") if kw.pop("pred", False) \
        else None
    tree = _tree(np.random.default_rng(3))
    ref = _np(jquant.quantize_tree(jax.tree.map(jnp.asarray, tree),
                                   predicate=pred, **kw))
    got = tquant.quantize_tree(jax.tree.map(torch.from_numpy, tree),
                               predicate=pred, **kw)
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    got_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in got_leaves] == [p for p, _ in ref_leaves]
    for (path, a), (_, b) in zip(got_leaves, ref_leaves):
        assert str(a.dtype).split(".")[-1] == str(b.dtype), path
        np.testing.assert_array_equal(a.numpy(), b, str(path))
    if kw["bits"] == 4:                                 # int8 fallbacks
        assert "q" in got["odd"]["kernel"]
        assert ("q" in got["patch_embed"]["kernel"]) != kw.get("rank1", False)
    if pred:
        assert isinstance(got["patch_embed"]["kernel"], torch.Tensor)
    assert tquant.is_quantized(got["head"]["kernel"])
    np.testing.assert_array_equal(
        tquant.materialize_kernel(got["head"]["kernel"], torch.float32),
        np.asarray(jquant.materialize_kernel(
            jax.tree.map(jnp.asarray, ref["head"]["kernel"]), jnp.float32)))


# ---------------------------------------------------------------------------
# (b) products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nf4", [False, True])
@pytest.mark.parametrize("din,group,stacked", [(256, 64, False),
                                               (192, 64, False),
                                               (256, 32, True)])
def test_group_int4_matmul(nf4, din, group, stacked):
    """The group branch of int4_matmul: halves holding whole groups take
    the split-halves form, others (din 192 with groups of 64) the
    materializing dequant; a stacked weight with a layer index takes its
    layer's slice, as the JAX decode scan does."""
    w = _weights((3, din, 96) if stacked else (din, 96), 5)
    qp = _np(jquant.quantize_int4(jnp.asarray(w), group_size=group, nf4=nf4))
    x = np.random.default_rng(6).standard_normal((4, din)).astype(np.float32)
    if stacked:
        ref = jquant.int4_matmul(jnp.asarray(x),
                                 {k: v[1] for k, v in qp.items()})
        got = tquant.int4_matmul(torch.from_numpy(x), {
            **_t(qp), "layer": torch.tensor([1], dtype=torch.int32)})
    else:
        ref = jquant.int4_matmul(jnp.asarray(x), qp)
        got = tquant.int4_matmul(torch.from_numpy(x), _t(qp))
    _row_close(got.numpy(), ref, 1e-5)


@pytest.mark.parametrize("m", [65, 130])
def test_w4a8_prefill_branch(monkeypatch, m):
    """Uniform rank-1 int4 at m > 64 with act_int8: JAX's W4A8 prefill
    branch (the nibbles against per-row int8 activations of each half);
    a cubic weight ignores act_int8 there, as in JAX."""
    monkeypatch.setattr(jquant, "_gemv_route_ok", lambda: True)
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, 256)).astype(np.float32)
    for nf4 in (False, True):
        qp = _np(jquant.quantize_int4_rank1(jnp.asarray(_weights((256, 384))),
                                            nf4=nf4))
        ref = jquant.int4_matmul(jnp.asarray(x), qp, act_int8=True)
        n0 = tquant.int8_mm.calls.get("decoder", 0)
        got = tquant.int4_matmul(torch.from_numpy(x), _t(qp), act_int8=True)
        assert tquant.int8_mm.calls.get("decoder", 0) - n0 == (0 if nf4
                                                               else 2)
        _row_close(got.numpy(), ref, 1e-5)


def test_int8_act_matmul_exact():
    """quantize_int8_act + int8_act_matmul: the same int8 bytes, exact
    int32 sums and the same epilogue roundings, bit for bit; so is the
    W8A8 product through quantized_matmul, batch dims included."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 5, 96)) * 3).astype(np.float32)
    qp = jquant.quantize_int8(jnp.asarray(_weights((96, 40))))
    xq, sx = jquant.quantize_int8_act(jnp.asarray(x[0]))
    ref = jquant.int8_act_matmul(xq, sx, qp["q"], qp["scale"], jnp.float32)
    tq8 = _t(_np(qp))
    txq, tsx = tquant.quantize_int8_act(torch.from_numpy(x[0]))
    got = tquant.int8_act_matmul(txq, tsx, tq8["q"], tq8["scale"],
                                 torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = jquant.quantized_matmul(jnp.asarray(x), qp, w8a8=True)
    got = tquant.quantized_matmul(torch.from_numpy(x), tq8, w8a8=True)
    assert got.shape == (2, 5, 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_w8a8_ste_gradient():
    """The straight-through W8A8 product: its primal is the serving path
    bit for bit, ``dx`` equals ``jax.grad``'s (``g @ W_deq^T``), and the
    int8 weights get no gradient."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    g = rng.standard_normal((6, 48)).astype(np.float32)
    qp = jquant.quantize_int8(jnp.asarray(_weights((64, 48))))

    def loss(xx):
        return jnp.sum(jquant.quantized_matmul(xx, qp, w8a8=True) * g)

    ref = jax.grad(loss)(jnp.asarray(x))
    tq8 = {k: v.clone() for k, v in _t(_np(qp)).items()}
    scale = tq8["scale"].requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tquant.quantized_matmul(xt, {"q": tq8["q"], "scale": scale},
                                w8a8=True)
    np.testing.assert_array_equal(
        y.detach().numpy(),
        np.asarray(jquant.quantized_matmul(jnp.asarray(x), qp, w8a8=True)))
    (y * torch.from_numpy(g)).sum().backward()
    _row_close(xt.grad.numpy(), ref, 1e-5)
    assert scale.grad is None


# ---------------------------------------------------------------------------
# (c) the int8 decoder
# ---------------------------------------------------------------------------

TEXT = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=512,
            bos_token_id=1, eos_token_id=2, dtype="float32")


@pytest.fixture(scope="module")
def int8_text():
    cfg = JQwen2Config(**TEXT)
    params = jq.init_qwen2_params(jax.random.PRNGKey(1), cfg)
    qparams = jquant.quantize_tree(params, bits=8)
    model = bridge.qwen2_from_params(_np(qparams), TQwen2Config(**TEXT),
                                     device="cpu")
    return cfg, params, qparams, model


def test_int8_bridge_matches_port_quantizer(int8_text):
    """quantize_text_(bits=8) of the port's model of the JAX weights
    holds the bytes of the bridged JAX ``quantize_tree(bits=8)``: stacked
    [L, din, dout] per site (held column-major), the 2D lm_head."""
    cfg, params, qparams, model = int8_text
    own = tquant.quantize_text_(bridge.qwen2_from_params(
        _np(params), TQwen2Config(**TEXT), device="cpu"), bits=8)
    for grp, name in tquant.GEMV_SITES:
        ref = qparams["layers"][grp][name]["kernel"]
        for k in ("q", "scale"):
            for m in (own, model):
                np.testing.assert_array_equal(
                    getattr(m.int8[name], k).numpy(), np.asarray(ref[k]))
        assert own.int8[name].q.transpose(-1, -2).is_contiguous()
        lin = getattr(own.layers[1], grp)[name]
        assert lin.qp()["q"].data_ptr() == own.int8[name].q[1].data_ptr()
    np.testing.assert_array_equal(own.lm_head.store.q.numpy(),
                                  np.asarray(qparams["lm_head"]["kernel"]["q"]))
    assert tquant.quantized_bytes(own) == tquant.quantized_bytes(model)


def _forward_ratios(int8_text, cached, S, jax_w8, port_w8):
    """A cache-free forward or a cached prefill + decode step of the int8
    decoder in both packages (``w8a8_prefill`` per side): the worst ratio
    of each output's error to its bound (hidden states and cache at the
    mode's tolerance; the logits of JAX's hidden state at 1e-5)."""
    cfg0, _, qparams, model = int8_text
    jcfg = dataclasses.replace(cfg0, w8a8_prefill=jax_w8)
    model.cfg = dataclasses.replace(model.cfg, w8a8_prefill=port_w8)
    rtol = ACT8_FWD if (jax_w8 or port_w8) and S >= 16 else FWD
    rng = np.random.default_rng(S)
    emb = rng.standard_normal((1, S, 256)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    ratios = {}
    n0 = tig.gemv_k10.launches
    if cached:
        jc = jq.init_kv_cache(jcfg, 1, 128)
        tc = tq.init_kv_cache(model.cfg, 1, 128, device="cpu")
        hj, jc = jq.qwen2_forward(qparams, jnp.asarray(emb), jnp.asarray(pos),
                                  jcfg, cache=jc)
        ht, tc = tq.qwen2_forward(model, torch.from_numpy(emb),
                                  torch.from_numpy(pos), tc)
        ratios["prefill"] = _row_ratio(ht.numpy(), hj, rtol)
        step = rng.standard_normal((1, 1, 256)).astype(np.float32)
        sp = np.array([[S]], np.int32)
        hj, jc = jq.qwen2_forward(qparams, jnp.asarray(step), jnp.asarray(sp),
                                  jcfg, cache=jc)
        ht, tc = tq.qwen2_forward(model, torch.from_numpy(step),
                                  torch.from_numpy(sp), tc)
        np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
        for name, a, b in (("k", tc.k, jc.k), ("v", tc.v, jc.v)):
            ratios[name] = _row_ratio(a.numpy()[:, :, :S + 1],
                                      np.asarray(b)[:, :, :S + 1], rtol)
    else:
        hj, _ = jq.qwen2_forward(qparams, jnp.asarray(emb), jnp.asarray(pos),
                                 jcfg)
        ht, _ = tq.qwen2_forward(model, torch.from_numpy(emb),
                                 torch.from_numpy(pos))
    ratios["hidden"] = _row_ratio(ht.numpy(), hj, rtol)
    lj = jq.lm_logits(qparams, hj)
    lt = tq.lm_logits(model, torch.from_numpy(np.array(hj)))
    ratios["logits"] = _row_ratio(lt.numpy(), lj, 1e-5)
    assert tig.gemv_k10.launches == n0        # the CPU runs K10's plain form
    return ratios


@pytest.mark.parametrize("w8a8", [False, True])
@pytest.mark.parametrize("cached,S", [(False, 5), (False, 20), (True, 20),
                                      (True, 70)])
def test_int8_forward(int8_text, cached, S, w8a8):
    """The int8 decoder forward matches JAX's in the same mode:
    cache-free, a cached prefill (S >= 16: W8A8 under the flag; S = 70 off
    K10's m <= 64 route) and the decode step after it (S < 16: weight-only
    in both modes)."""
    ratios = _forward_ratios(int8_text, cached, S, w8a8, w8a8)
    assert max(ratios.values()) <= 1.0, ratios


@pytest.mark.parametrize("jax_w8", [False, True])
def test_int8_w8a8_forward_mode_control(int8_text, jax_w8):
    """The control of the bounds above: a prefill run in the other
    w8a8_prefill mode than JAX's misses them."""
    ratios = _forward_ratios(int8_text, False, 20, jax_w8, not jax_w8)
    assert max(ratios.values()) > 1.0, ratios


def test_int8_decode_unchanged_by_w8a8_prefill(int8_text):
    """A decode step (S < 16) is bit-identical with w8a8_prefill on and
    off (JAX's gate; tests/test_qwen2.py holds the JAX side to it)."""
    _, _, _, model = int8_text
    rng = np.random.default_rng(2)
    emb = torch.from_numpy(rng.standard_normal((1, 3, 256)).astype(
        np.float32))
    outs = []
    for flag in (False, True):
        model.cfg = dataclasses.replace(model.cfg, w8a8_prefill=flag)
        outs.append(tq.qwen2_forward(model, emb, torch.arange(
            3, dtype=torch.int32)[None])[0])
    assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# (d) the W8A8 vision tower
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tower():
    jcfg, tcfg = JConfig.tiny(), TConfig.tiny()
    params = init_cogreasoner_params(jax.random.PRNGKey(0), jcfg)
    vis = bridge.vision_from_params(_np(params["vision"]), tcfg.vision,
                                    device="cpu")
    return jcfg, params, vis, tve.quantize_vision_w8a8(vis)


def test_quantize_vision_w8a8_byte_equal(tower):
    """The port's int8 copy of the tower holds the bytes of JAX's
    quantize_vision_w8a8 (q / k / v side by side in the fused QKV store);
    the bridge of JAX's int8 tree gives the same module; the patch
    embedding stays as it was and the source tower is untouched."""
    jcfg, params, vis, q8 = tower
    ref = _np(j_w8a8(params["vision"]))
    bridged = bridge.vision_from_params(ref, TConfig.tiny().vision,
                                        device="cpu")
    assert q8.int8 and bridged.int8 and not vis.int8
    assert q8.patch_embed is vis.patch_embed
    assert not isinstance(ref["patch_embed"]["kernel"], dict)
    for mine, other, lp in zip(q8.layers, bridged.layers, ref["layers"]):
        a = lp["attn"]
        want = {"qkv": {k: np.concatenate([a[n]["kernel"][k] for n in "qkv"],
                                          -1) for k in ("q", "scale")},
                "o": a["o"]["kernel"], "fc1": lp["mlp"]["fc1"]["kernel"],
                "fc2": lp["mlp"]["fc2"]["kernel"]}
        for name, kern in want.items():
            for m in (mine, other):
                lin = getattr(m, name)
                assert tve.is_w8(lin)
                for k in ("q", "scale"):
                    np.testing.assert_array_equal(
                        getattr(lin.store, k).numpy(), kern[k])
            np.testing.assert_array_equal(getattr(mine, name).bias.numpy(),
                                          getattr(other, name).bias.numpy())


def test_w8a8_padding_is_exact():
    """JAX's packed path pads each head from D to 128 lanes with zero
    weights and unit scales; the port does not pad. The padding changes
    no per-column scale, no per-row activation absmax and no product
    column, so the unpadded W8A8 GEMMs give JAX's numbers."""
    rng = np.random.default_rng(9)
    H, D, Dp, N = 2, 16, 128, 7
    x = rng.standard_normal((N, H * D)).astype(np.float32)
    qp = jquant.quantize_int8(jnp.asarray(_weights((H * D, H * D))))
    qw = jnp.pad(qp["q"].reshape(-1, H, D), ((0, 0), (0, 0), (0, Dp - D)))
    sc = jnp.pad(qp["scale"].reshape(H, D), ((0, 0), (0, Dp - D)),
                 constant_values=1.0)
    xq, sx = jquant.quantize_int8_act(jnp.asarray(x))
    padded = jquant.int8_act_matmul(xq, sx, qw.reshape(-1, H * Dp),
                                    sc.reshape(-1), jnp.float32)
    got = tquant.int8_act_matmul(*tquant.quantize_int8_act(
        torch.from_numpy(x)), *_t(_np(qp)).values(), torch.float32)
    np.testing.assert_array_equal(
        np.asarray(padded).reshape(N, H, Dp)[..., :D].reshape(N, -1),
        got.numpy())
    # the o-projection's input: zero lanes leave each row's absmax
    xpad = jnp.pad(jnp.asarray(x).reshape(N, H, D),
                   ((0, 0), (0, 0), (0, Dp - D))).reshape(N, -1)
    np.testing.assert_array_equal(np.asarray(jquant.quantize_int8_act(xpad)[1]),
                                  np.asarray(sx))


@pytest.mark.parametrize("grids,pad_to", [([[2, 4, 4]], None),
                                          ([[2, 4, 4], [1, 6, 4]], 64)])
def test_w8a8_tower_packed_path(tower, grids, pad_to):
    """The packed serving path (W8A8 fused QKV, o and MLP GEMMs) against
    JAX's packed path on its int8 tree (Pallas K1/K2 in interpret mode);
    it differs from the bf16 tower by more than it differs from JAX."""
    jcfg, params, vis, q8 = tower
    rng = np.random.default_rng(0)
    n = sum(t * h * w for t, h, w in grids)
    pv = rng.integers(0, 256, (n, 3 * 14 * 14), dtype=np.uint8)
    merges = np.array([2] * len(grids))
    ref = j_vision(j_w8a8(params["vision"]), pv, np.array(grids), merges,
                   jcfg.vision, use_pallas=True, pad_to=pad_to)
    n0 = tquant.int8_mm.calls.get("tower", 0)
    got = tve.vision_encoder_forward(q8, pv, np.array(grids), merges,
                                     pad_to=pad_to)
    assert tquant.int8_mm.calls["tower"] - n0 == 4 * len(q8.layers)
    _row_close(got.numpy(), ref, TOWER)
    plain = tve.vision_encoder_forward(vis, pv, np.array(grids), merges,
                                       pad_to=pad_to)
    assert _row_ratio(plain.numpy(), ref, TOWER) > _row_ratio(
        got.numpy(), ref, TOWER)


def test_w8a8_tower_head_major_branch(tower):
    """Without packed ranges (the head-major branch) the attention stays
    weight-only and the MLP runs W8A8, as JAX's does (plain segment
    attention on both sides)."""
    jcfg, params, vis, q8 = tower
    grids, merges = np.array([[2, 4, 4]]), np.array([2])
    pv = np.random.default_rng(1).standard_normal(
        (32, 3 * 14 * 14)).astype(np.float32)
    m = j_meta(grids, merges)
    ref = j_core(j_w8a8(params["vision"]), jnp.asarray(pv),
                 jnp.asarray(m.pos_ids), jnp.asarray(m.segment_ids),
                 jnp.asarray(m.merge_group_ids), m.num_out_tokens,
                 jcfg.vision, use_pallas=False)
    n0 = tquant.int8_mm.calls.get("tower", 0)
    got = tve.vision_encoder_core(
        q8, torch.from_numpy(pv), torch.from_numpy(m.pos_ids),
        torch.from_numpy(m.segment_ids), torch.from_numpy(m.merge_group_ids),
        m.num_out_tokens, use_pallas=False)
    assert tquant.int8_mm.calls["tower"] - n0 == 2 * len(q8.layers)
    _row_close(got.numpy(), ref, TOWER)


# ---------------------------------------------------------------------------
# (e) the tiny session, every mode on
# ---------------------------------------------------------------------------

def _session_cfgs():
    events = dict(frames_per_event=3, keyframes_per_event=1)

    def cfg_of(C, Comp):
        c = C.tiny()
        return dataclasses.replace(
            c, compression=Comp(**events), text=dataclasses.replace(
                c.text, hidden_size=256, intermediate_size=512,
                num_attention_heads=4, num_key_value_heads=2,
                vocab_size=1024, w8a8_prefill=True))

    return cfg_of(JConfig, JCompression), cfg_of(TConfig, TCompression)


def test_int8_session_w8a8_encoder_int8(monkeypatch):
    """ingest → ask(AC) → ingest → ask(FCC) on an int8 decoder with
    w8a8_prefill and the W8A8 tower (JAX: ``encoder_int8`` on its packed
    path, ``use_pallas=True``): greedy tokens, selections, slot ranges
    and cache positions equal JAX's; the session holds its own int8 tower
    and leaves the model's as it is."""
    jcfg, tcfg = _session_cfgs()
    params = init_cogreasoner_params(jax.random.PRNGKey(0), jcfg)
    params = {**params, "text": jquant.quantize_tree(params["text"], bits=8)}
    model = bridge.cogreasoner_from_params(_np(params), tcfg, device="cpu")
    jtokens = []

    def recording_generate(*a, **k):
        r = j_generate(*a, **k)
        jtokens.append(np.asarray(r.tokens)[0, :int(r.num_tokens[0])]
                       .tolist())
        return r

    monkeypatch.setattr(jsess_mod, "generate_tokens", recording_generate)
    js = jsess_mod.StreamingSession(
        params, jcfg, JTok(image_token_id=jcfg.image_token_index),
        max_len=1024, use_pallas=True, encoder_int8=True)
    ts = TSession(model, tcfg, TTok(image_token_id=tcfg.image_token_index),
                  max_len=1024, encoder_int8=True)
    assert ts.model.vision.int8 and not model.vision.int8
    mm0 = dict(tquant.int8_mm.calls)
    pv = np.random.default_rng(4).integers(0, 256, (3 * 4 * 4, 3 * 14 * 14),
                                           dtype=np.uint8)
    for stamps, question, mode in (([0.0, 1.0, 2.0], "what?", "AC"),
                                   ([3.0, 4.0, 5.0], "and now?", "FCC")):
        js.append_stream_segment(pv, (3, 4, 4), 2, timestamps=stamps)
        ts.append_stream_segment(pv, (3, 4, 4), 2, timestamps=stamps)
        rj = js.ask(question, mode=mode, max_new_tokens=6)
        rt = ts.ask(question, mode=mode, max_new_tokens=6)
        assert rt["tokens"] == jtokens[-1]
        for key in ("text", "selection", "if_visual", "cache_tokens"):
            assert rt[key] == rj[key], key
    for site in ("decoder", "tower"):
        assert tquant.int8_mm.calls.get(site, 0) > mm0.get(site, 0), site
    assert [dataclasses.astuple(r) for r in ts.ranges] == \
        [dataclasses.astuple(r) for r in js.ranges]
    np.testing.assert_array_equal(ts.cache.pos.numpy(),
                                  np.asarray(js.cache.pos))
    wi = ts.write_index
    for a, b in ((ts.cache.k, js.cache.k), (ts.cache.v, js.cache.v)):
        _row_close(a.numpy()[:, :, :wi], np.asarray(b)[:, :, :wi], SESSION)


def test_session_config_flags_reach_the_decoder():
    """A session's config carries the serving flags, as the JAX session's
    does: a model built without w8a8_prefill, served by a session whose
    config sets it, prefills its int8 decoder W8A8 (the flags once stayed
    on the model's own config, silently)."""
    _, tcfg = _session_cfgs()
    plain_cfg = dataclasses.replace(tcfg, text=dataclasses.replace(
        tcfg.text, w8a8_prefill=False))
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params \
        as t_init

    model = t_init(plain_cfg, torch.Generator().manual_seed(0), device="cpu")
    tquant.quantize_text_(model.text, bits=8)
    n0 = tquant.int8_mm.calls.get("decoder", 0)
    sess = TSession(model, tcfg, TTok(image_token_id=tcfg.image_token_index),
                    max_len=256)
    assert sess.model.text.cfg.w8a8_prefill
    assert not model.text.cfg.w8a8_prefill
    assert tquant.int8_mm.calls.get("decoder", 0) > n0   # system prefill


# ---------------------------------------------------------------------------
# (f) load-time int8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_load_byte_equal(tmp_path, dtype):
    """quantize_text_bits=8 from a checkpoint stored in ``dtype``: the
    stores equal JAX's load of the same files byte for byte."""
    jcfg, tcfg = JConfig.tiny(), TConfig.tiny()
    params = init_cogreasoner_params(jax.random.PRNGKey(0), jcfg)
    jck.save_cogreasoner_to_hf(params, jcfg, str(tmp_path),
                               dtype=getattr(jnp, dtype))
    ref = jck.load_cogreasoner_from_hf(str(tmp_path), jcfg,
                                       quantize_text_bits=8)["text"]
    got = tck.load_cogreasoner_from_hf(str(tmp_path), tcfg,
                                       quantize_text_bits=8,
                                       device="cpu").text
    for grp, name in tquant.GEMV_SITES:
        for k in ("q", "scale"):
            np.testing.assert_array_equal(
                getattr(got.int8[name], k).numpy(),
                np.asarray(ref["layers"][grp][name]["kernel"][k]))
    for k in ("q", "scale"):
        np.testing.assert_array_equal(
            getattr(got.lm_head.store, k).numpy(),
            np.asarray(ref["lm_head"]["kernel"][k]))


# ---------------------------------------------------------------------------
# (g) quant_quality
# ---------------------------------------------------------------------------

QQ = dict(vocab_size=256, hidden_size=256, intermediate_size=384,
          num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
          dtype="bfloat16")


def test_quality_probes_match_jax():
    """The probes on JAX's own int8 build, bridged (embeddings in f32 so
    both forwards run f32): teacher-forced and cached logits within 1e-4
    of the row max, greedy tokens equal; the W8A8 probe moves the logits
    by as much as JAX's does (its MAE against weight-only within 20%: the
    forward is chaotic here, module docstring); divergence,
    compare_logits and prefix_agreement equal JAX's on the same logits;
    the cached logits over an e4m3 cache (kv_dtype) within the same
    bound of JAX's."""
    jcfg = dataclasses.replace(JQwen2Config(**QQ), dtype="float32")
    tcfg = TQwen2Config(**{**QQ, "dtype": "float32"})
    tree = _np(jqq.build_text_params(JQwen2Config(**QQ), "int8", seed=3))
    tree["embed_tokens"] = tree["embed_tokens"].astype(np.float32)
    jtree = jax.tree.map(jnp.asarray, tree)
    model = bridge.qwen2_from_params(tree, tcfg, device="cpu")
    jids = jqq.probe_ids(jcfg, n=40)
    ids = tqq.probe_ids(tcfg, n=40, device="cpu")
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    jw = dataclasses.replace(jcfg, w8a8_prefill=True)
    tw = dataclasses.replace(tcfg, w8a8_prefill=True)
    lj, lt = jqq.tf_logits(jtree, jids, jcfg), tqq.tf_logits(model, ids, tcfg)
    _row_close(lt.numpy(), lj, FWD)
    _row_close(tqq.cached_logits(model, ids, tcfg, 64).numpy(),
               jqq.cached_logits(jtree, jids, jcfg, 64), FWD)
    lw = jqq.tf_logits(jtree, jids, jw)
    w8 = tqq.compare_logits(lt, tqq.tf_logits(model, ids, tw), "w8a8")
    assert w8["w8a8_logit_mae"] == pytest.approx(
        jqq.compare_logits(lj, lw, "w8a8")["w8a8_logit_mae"], rel=0.2)
    ref = jqq.compare_logits(lj, lw, "w8a8")
    got = tqq.compare_logits(torch.from_numpy(np.array(lj)),
                             torch.from_numpy(np.array(lw)), "w8a8")
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-5, abs=1e-6), k
    a = jqq.greedy_continuation(jtree, jcfg, jids, n=8, max_len=64)
    b = tqq.greedy_continuation(model, tcfg, ids, n=8, max_len=64)
    np.testing.assert_array_equal(b, a)
    for x, y in (([1, 2, 3, 4], [1, 2, 9, 4]), ([5], [5]), ([], [])):
        assert tqq.prefix_agreement(np.asarray(x), np.asarray(y)) == \
            jqq.prefix_agreement(np.asarray(x), np.asarray(y))
    _row_close(tqq.cached_logits(model, ids, tcfg, 64,
                                 kv_dtype=torch.float8_e4m3fn).numpy(),
               jqq.cached_logits(jtree, jids, jcfg, 64,
                                 kv_dtype=jnp.float8_e4m3fn), FWD)


@pytest.fixture(scope="module")
def ladder():
    cfg = TQwen2Config(**QQ)
    ids = tqq.probe_ids(cfg, n=48, device="cpu")
    lbf = tqq.tf_logits(tqq.build_text_params(cfg, "bf16", device="cpu"),
                        ids, cfg)
    return cfg, ids, lbf


def test_quality_rebuild_is_deterministic(ladder):
    """Two builds from one seed give the same logits; another seed does
    not; every scheme quantizes the same float model (its dequantized
    weights are within a quantization step of the bf16 build's)."""
    cfg, ids, lbf = ladder
    la = tqq.tf_logits(tqq.build_text_params(cfg, "int8", seed=3,
                                             device="cpu"), ids, cfg)
    lb = tqq.tf_logits(tqq.build_text_params(cfg, "int8", seed=3,
                                             device="cpu"), ids, cfg)
    mae, kl, agree = tqq.divergence(la, lb)
    assert float(mae) == 0.0 and float(agree) == 1.0
    lc = tqq.tf_logits(tqq.build_text_params(cfg, "int8", seed=4,
                                             device="cpu"), ids, cfg)
    assert float(tqq.divergence(la, lc)[0]) > 0.0
    bf = tqq.build_text_params(cfg, "bf16", device="cpu")
    for scheme in ("int8", "nf4"):
        m = tqq.build_text_params(cfg, scheme, device="cpu")
        w = bf.layers[1].mlp["up_proj"].weight.t().float()
        deq = tquant.dequantize(m.layers[1].mlp["up_proj"].qp(),
                                torch.float32)
        step = w.abs().amax(0) / (127 if scheme == "int8" else 4)
        assert ((deq - w).abs() <= step).all()


def test_quality_scheme_ladder(ladder):
    """On the port's own build: bf16 against itself is exact; int8 is
    closer to bf16 than each 4-bit scheme (logit MAE and KL; the ladder
    the JAX package's test_scheme_ladder holds); W8A8 costs more than
    weight-only int8; int8 agrees with bf16 on top-1 almost everywhere."""
    cfg, ids, lbf = ladder
    out = {}
    for scheme in tqq.SCHEMES:
        m = tqq.build_text_params(cfg, scheme, device="cpu")
        out[scheme] = tqq.compare_logits(lbf, tqq.tf_logits(m, ids, cfg),
                                         scheme)
        if scheme == "int8":
            out["w8a8"] = tqq.compare_logits(lbf, tqq.tf_logits(
                m, ids, dataclasses.replace(cfg, w8a8_prefill=True)), "w8a8")
    assert out["bf16"]["bf16_logit_mae"] == 0.0
    assert out["bf16"]["bf16_top1_agree"] == 1.0
    for s in ("int4u", "int4c", "nf4"):
        assert 0.0 < out["int8"]["int8_logit_mae"] < out[s][f"{s}_logit_mae"]
        assert out["int8"]["int8_kl"] < out[s][f"{s}_kl"]
    assert out["int8"]["int8_kl"] < out["w8a8"]["w8a8_kl"]
    assert out["int8"]["int8_top1_agree"] > 0.9, out
