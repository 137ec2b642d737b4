"""QLoRA training in the PyTorch port against the JAX package, on the CPU:
LoRA over a frozen base quantized whole (``quantize_cogreasoner_`` against
``quantize_tree(params, bits, nf4)``), the GEMV kernels' backwards, the
stage-2 curriculum ``train_stage2_video``, ``count_dataset_turns`` and the
``train-stage1`` / ``train-stage2`` commands.

The tiny config (f32) with 128-multiple decoder widths, so that a batch of
at most 64 rows reaches K10's route (its plain version here) under
autograd; the tower keeps the tiny widths, so an NF4 / int4 tower mixes
4-bit GEMMs with the int8 fallback (din 32 and the patch embedding) as the
7B tower does (din 588 and 4304). Weights are JAX's initializers, carried
across by models/bridge.py and quantized on each side by its own
quantizer; inputs are seeded numpy draws; LoRA dropout 0. Tolerances:

* quantized trees: bytes exact;
* quantized towers: 1e-4 of each row's max |ref| where every GEMM is
  weight-only, 1e-2 where JAX's W8A8 rule fires (the tiny tower's din-32
  GEMMs fall back to int8), as tests/test_torch_quant_modes.py's W8A8
  tower;
* losses: rtol 1e-5; each LoRA leaf's gradient within 1e-4 of its max
  |ref| (tests/test_torch_train.py's bounds), W8A8 (``w8a8_prefill``)
  included: an f32 difference upstream could flip an int8 activation
  rounding, but at this size none does (measured worst over the three
  objectives: loss 6.6e-8 relative, gradients 1.4e-6 of the leaf max);
  ``test_w8a8_mode_control`` holds the port with W8A8 off to missing the
  gradient bound (measured 2.3e-2 and 2.9e-2 of the leaf max);
* GEMV backwards: ``dx`` within 1e-5 of each row's max |ref| against
  ``jax.grad`` of JAX's ``quantized_matmul``;
* the curriculum: losses rtol 1e-5, updated adapters in units of lr as in
  tests/test_torch_train.py.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogstream_tpu.config import CogReasonerConfig as JConfig
from cogstream_tpu.config import LoRAConfig as JLoRA
from cogstream_tpu.models import lora as jlora
from cogstream_tpu.models.cogreasoner import init_cogreasoner_params
from cogstream_tpu.ops import quant as jquant
from cogstream_tpu.processor.tokenizer import ByteTokenizer as JTok
from cogstream_tpu.train import multimodal as jmm
from cogstream_tpu.train import stage2 as jstage2
from cogstream_tpu.train import trainer as jtr
from cogstream_tpu_torch import __main__ as tmain
from cogstream_tpu_torch.config import CogReasonerConfig as TConfig
from cogstream_tpu_torch.config import LoRAConfig as TLoRA
from cogstream_tpu_torch.models import bridge
from cogstream_tpu_torch.models import lora as tlora
from cogstream_tpu_torch.ops import int8_gemv as tig
from cogstream_tpu_torch.ops import quant as tquant
from cogstream_tpu_torch.ops import quant_gemv as tqg
from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer as TTok
from cogstream_tpu_torch.train import multimodal as tmm
from cogstream_tpu_torch.train import stage2 as tstage2
from cogstream_tpu_torch.train import trainer as ttr

cv2 = pytest.importorskip("cv2")

LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = 1e-4
# mode -> (bits, nf4, w8a8_prefill)
MODES = {"int8": (8, True, False), "nf4": (4, True, False),
         "int4": (4, False, False), "int8_w8a8": (8, True, True)}
TEXT = dict(hidden_size=256, intermediate_size=512, vocab_size=1024)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(w8a8=False):
    j, t = JConfig.tiny(), TConfig.tiny()
    j = dataclasses.replace(j, text=dataclasses.replace(
        j.text, w8a8_prefill=w8a8, **TEXT))
    t = dataclasses.replace(t, text=dataclasses.replace(
        t.text, w8a8_prefill=w8a8, **TEXT))
    return j, t


@pytest.fixture(scope="module")
def base():
    jcfg, _ = _cfgs()
    params = init_cogreasoner_params(jax.random.PRNGKey(0), jcfg)
    return params, jax.tree.map(np.asarray, params)


_MODELS = {}


def _mode(base, mode):
    """(jax cfg, port cfg, JAX quantized tree, port model quantized by
    ``quantize_cogreasoner_``) for ``mode``, built once per module."""
    bits, nf4, w8 = MODES[mode]
    key = (bits, nf4)
    if key not in _MODELS:
        params, host = base
        jq = jquant.quantize_tree(params, bits=bits, nf4=nf4)
        model = bridge.cogreasoner_from_params(host, _cfgs()[1],
                                               device="cpu")
        tquant.quantize_cogreasoner_(model, bits, nf4=nf4)
        _MODELS[key] = (jq, model)
    return _cfgs(w8) + _MODELS[key]


def _lora_pair(jcfg, seed, projector=True):
    """A JAX LoRA tree with seeded nonzero b leaves and its port tree."""
    tree = jax.tree.map(np.asarray, jlora.init_cogreasoner_lora(
        jax.random.PRNGKey(seed), jcfg,
        JLoRA(rank=4, include_projector=projector)))
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.standard_normal(x.shape).astype(np.float32) * 0.05)
        if p[-1].key == "b" else x, tree)
    return (jax.tree.map(jnp.asarray, tree),
            bridge.lora_from_params(tree, device="cpu"))


def _leaf_ratio(jg, tg, rel):
    """Worst |port - jax| over ``rel`` times the leaf's max |jax|."""
    ref = dict(tlora.iter_leaves(jax.tree.map(np.asarray, jg)))
    got = dict(tlora.iter_leaves(tg))
    assert ref.keys() == got.keys()
    return max(float(np.abs(got[k] - ref[k]).max())
               / (rel * max(float(np.abs(ref[k]).max()), 1e-30))
               for k in ref)


def _port_grads(loss, tree):
    grads = iter(torch.autograd.grad(
        loss, [t for _, t in tlora.iter_leaves(tree)]))
    return bridge.lora_to_params(tlora.map_leaves(lambda t: next(grads),
                                                  tree))


# ---------------------------------------------------------------------------
# the quantized tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["int8", "nf4", "int4"])
def test_quantized_tree_bytes(base, mode):
    """``quantize_cogreasoner_`` on the bridged base equals the bridge of
    ``quantize_tree(params, bits, nf4)`` byte for byte, every buffer and
    parameter; the fused vision QKV equals JAX's q / k / v dicts
    concatenated along dout; no plain linear remains, and the
    embeddings, norms and biases are the base's."""
    jcfg, tcfg, jq, model = _mode(base, mode)
    ref = bridge.cogreasoner_from_params(jax.tree.map(np.asarray, jq), tcfg,
                                         device="cpu")
    got_sd, ref_sd = model.state_dict(), ref.state_dict()
    assert got_sd.keys() == ref_sd.keys()
    for k in ref_sd:
        assert got_sd[k].dtype == ref_sd[k].dtype, k
        assert torch.equal(got_sd[k], ref_sd[k]), k
    assert not any(isinstance(m, torch.nn.Linear) for m in model.modules())
    for li, layer in enumerate(model.vision.layers):
        attn = jq["vision"]["layers"][li]["attn"]
        for k, v in layer.qkv.store.qp().items():
            cat = np.concatenate([np.asarray(attn[n]["kernel"][k])
                                  for n in ("q", "k", "v")], -1)
            np.testing.assert_array_equal(v.numpy(), cat)
    plain = bridge.cogreasoner_from_params(base[1], tcfg, device="cpu")
    np.testing.assert_array_equal(model.text.embed_tokens.numpy(),
                                  plain.text.embed_tokens.numpy())
    np.testing.assert_array_equal(model.vision.layers[0].ln1.scale.numpy(),
                                  plain.vision.layers[0].ln1.scale.numpy())
    np.testing.assert_array_equal(model.vision.layers[1].fc2.bias.numpy(),
                                  plain.vision.layers[1].fc2.bias.numpy())
    pe = model.vision.patch_embed.store      # din 588: int8 in every mode
    assert pe.scheme == "int8" and model.vision.dtype == torch.float32
    fc2 = model.vision.layers[0].fc2.store   # din 64: the mode's scheme
    assert fc2.scheme == ("int8" if mode == "int8" else "int4")


TOWER = 1e-2    # a tower with W8A8 GEMMs (tests/test_torch_quant_modes.py)


def _row_ratio(got, ref, rtol):
    """Worst |got - ref| over ``rtol`` times its row's max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    bound = rtol * np.abs(ref).max(axis=-1, keepdims=True)
    return float((np.abs(got - ref) / bound).max())


def _tower_out(base, mode, branch, grids=((2, 4, 4),)):
    """(port, JAX) merged features of ``mode``'s quantized tower: the
    packed path (JAX's with its Pallas K1 / K2 in interpret mode) or the
    head-major branch (plain segment attention on both sides)."""
    from cogstream_tpu.models.vision_encoder import (
        build_vision_metadata as j_meta, vision_encoder_core as j_core,
        vision_encoder_forward as j_vision)
    from cogstream_tpu_torch.models import vision_encoder as tve

    jcfg, _, jq, model = _mode(base, mode)
    grids, merges = np.array(grids), np.array([2] * len(grids))
    n = int(sum(t * h * w for t, h, w in grids))
    rng = np.random.default_rng(4)
    if branch == "packed":
        pv = rng.integers(0, 256, (n, 3 * 14 * 14), dtype=np.uint8)
        ref = j_vision(jq["vision"], pv, grids, merges, jcfg.vision,
                       use_pallas=True)
        got = tve.vision_encoder_forward(model.vision, pv, grids, merges)
        return got.numpy(), np.asarray(ref)
    pv = rng.standard_normal((n, 3 * 14 * 14)).astype(np.float32)
    m = j_meta(grids, merges)
    ref = j_core(jq["vision"], jnp.asarray(pv), jnp.asarray(m.pos_ids),
                 jnp.asarray(m.segment_ids), jnp.asarray(m.merge_group_ids),
                 m.num_out_tokens, jcfg.vision, use_pallas=False)
    got = tve.vision_encoder_core(
        model.vision, torch.from_numpy(pv), torch.from_numpy(m.pos_ids),
        torch.from_numpy(m.segment_ids), torch.from_numpy(m.merge_group_ids),
        m.num_out_tokens, use_pallas=False)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("branch", ["packed", "head_major"])
@pytest.mark.parametrize("mode", ["int8", "nf4", "int4"])
def test_quantized_tower(base, mode, branch, monkeypatch):
    """The tower quantized whole against JAX's on the ``quantize_tree``
    tree, both branches. Its GEMMs take JAX's W8A8 rule (``_is_w8``: the
    packed attention when fused QKV and o are int8, the MLP when fc1 and
    fc2 are), so every tiny tower's packed attention is W8A8 (din 32
    falls back to int8) and an int8 tower's MLP too: those within 1e-2 of
    each row's max |ref|, weight-only ones within 1e-4. Mode control: an
    int8 tower forced weight-only misses JAX by more."""
    from cogstream_tpu_torch.models import vision_encoder as tve

    vis = _mode(base, mode)[3].vision
    w8_attn = all(tve.is_w8(getattr(vis.layers[0], n)) for n in ("qkv", "o"))
    w8_mlp = all(tve.is_w8(getattr(vis.layers[0], n)) for n in ("fc1", "fc2"))
    assert w8_attn and w8_mlp == (mode == "int8")
    w8 = w8_mlp or (branch == "packed" and w8_attn)
    got, ref = _tower_out(base, mode, branch)
    assert _row_ratio(got, ref, TOWER if w8 else 1e-4) <= 1.0
    if mode == "int8":
        monkeypatch.setattr(tve, "is_w8", lambda lin: False)
        weight_only, _ = _tower_out(base, mode, branch)
        assert _row_ratio(weight_only, ref, TOWER) > \
            _row_ratio(got, ref, TOWER)


# ---------------------------------------------------------------------------
# losses and LoRA gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

def _text_batch(B=2, S=24, seed=6):
    rng = np.random.default_rng(seed)
    ids = rng.integers(16, 272, (B, S)).astype(np.int32)
    ids[1, -5:] = 0
    labels = np.full((B, S), jtr.IGNORE_INDEX, np.int32)
    labels[:, 12:] = ids[:, 12:]
    labels[1, -5:] = jtr.IGNORE_INDEX
    return {"input_ids": ids, "labels": labels}


def _embeds_batch(jcfg):
    rng = np.random.default_rng(15)
    pos = np.tile(np.arange(24, dtype=np.int32), (2, 1))
    pos[1, -5:] = -1
    return {"inputs_embeds": rng.standard_normal(
        (2, 24, jcfg.text.hidden_size)).astype(np.float32),
        "positions": pos, "labels": _text_batch()["labels"]}


def _mm_batch(jcfg):
    """A packed turn with a pooling plan (64 tokens: K10's route)."""
    import types

    t, gh, gw, ms = 2, 4, 4, 2
    merged = (gh // ms) * (gw // ms)
    rng = np.random.default_rng(2)
    images = types.SimpleNamespace(
        pixel_values=rng.normal(size=(t * gh * gw, 3 * 14 * 14)).astype(
            np.float32),
        grid_sizes=np.array([[t, gh, gw]]), merge_sizes=np.array([ms]))
    keep = np.ones((t * merged,), bool)
    keep[merged + 1:] = False
    prompt = ("<|im_start|>user\n" + "<image>" * (t * merged) +
              "what?<|im_end|>\n<|im_start|>assistant\n")
    tok = TTok(image_token_id=jcfg.image_token_index)
    batch = tstage2.pack_turn_batch(tok, jcfg, prompt, "an answer", images,
                                    keep, 2048,
                                    minor_frames=np.array([False, True]))
    assert batch["input_ids"].shape == (1, 64)
    return batch


def _losses(base, mode, kind, port_w8a8=None):
    """(JAX loss, JAX grads, port loss, port grads) of one objective on
    ``mode``'s base; ``port_w8a8`` overrides the port's flag."""
    jcfg, tcfg, jq, model = _mode(base, mode)
    if port_w8a8 is not None:
        tcfg = dataclasses.replace(tcfg, text=dataclasses.replace(
            tcfg.text, w8a8_prefill=port_w8a8))
    jt, tt = _lora_pair(jcfg, 7, projector=kind == "multimodal")
    if kind == "text":
        jt, tt = jt["text"], tt["text"]
        batch = _text_batch()

        def jloss(lo, b):
            return jtr.text_loss_fn(jq["text"], lo, b, jcfg.text, 2.0, None,
                                    remat=False)

        def tloss(lo, b):
            return ttr.text_loss_fn(model.text, lo, b, 2.0, None,
                                    remat=False, text_cfg=tcfg.text)
    elif kind == "embeds":
        batch = _embeds_batch(jcfg)

        def jloss(lo, b):
            return jtr.embeds_loss_fn(jq["text"], lo, b, jcfg.text, 2.0,
                                      remat=False)

        def tloss(lo, b):
            return ttr.embeds_loss_fn(model.text, lo, b, 2.0, remat=True,
                                      text_cfg=tcfg.text)
    else:
        batch = dict(_mm_batch(jcfg))
        n_vis = int(batch.pop("num_vis_tokens"))

        def jloss(lo, b):
            return jmm.multimodal_loss_fn(jq, lo, b, jcfg, 2.0,
                                          num_vis_tokens=n_vis, remat=False)

        def tloss(lo, b):
            return tmm.multimodal_loss_fn(model, lo, b, 2.0, n_vis,
                                          remat=True, text_cfg=tcfg.text)
    jl, jg = jax.value_and_grad(jloss)(jt, jax.tree.map(jnp.asarray, batch))
    tl = tloss(tt, ttr.to_device(batch, "cpu"))
    tg = _port_grads(tl, tt)
    if kind == "embeds":
        jg, tg = jg["text"], tg["text"]
    return float(jl), jg, tl.item(), tg


@pytest.mark.parametrize("kind", ["text", "embeds", "multimodal"])
@pytest.mark.parametrize("mode", list(MODES))
def test_qlora_loss_and_grads(base, mode, kind):
    """The stage-1 (``text_loss_fn``), pre-spliced (``embeds_loss_fn``) and
    stage-2 (``multimodal_loss_fn``) objectives on the quantized base: loss
    and every LoRA leaf's gradient against ``jax.value_and_grad`` (bounds
    in the module docstring)."""
    jl, jg, tl, tg = _losses(base, mode, kind)
    np.testing.assert_allclose(tl, jl, **LOSS)
    assert _leaf_ratio(jg, tg, GRAD) <= 1.0


@pytest.mark.parametrize("kind", ["text", "multimodal"])
def test_w8a8_mode_control(base, kind):
    """The port with ``w8a8_prefill`` off against JAX's W8A8 objective:
    its gradients must miss the bound that the right mode meets, so the
    bound tells the modes apart."""
    jl, jg, tl, tg = _losses(base, "int8_w8a8", kind, port_w8a8=False)
    assert _leaf_ratio(jg, tg, GRAD) > 1.0


def test_frozen_base_gets_no_gradient(base):
    """A step on the NF4 base leaves every base tensor bit-identical and
    requires no gradient of it; only LoRA leaves are in the optimizer."""
    jcfg, tcfg, _, model = _mode(base, "nf4")
    before = [t.clone() for t in model.state_dict().values()]
    _, tt = _lora_pair(jcfg, 3)
    tx = ttr.make_optimizer(1e-2, total_steps=4, warmup_steps=0)
    state = ttr.init_train_state(tx, tt)
    loss = ttr.bind_text_loss(TLoRA(dropout=0.0), remat=True,
                              text_cfg=tcfg.text)
    step = ttr.make_train_step(
        tx, lambda m, lo, b: loss(m, lo["text"], b))
    state, _ = step(model.text, state, ttr.to_device(_text_batch(), "cpu"))
    assert all(not t.requires_grad for t in model.state_dict().values())
    assert all(torch.equal(a, b) for a, b in
               zip(before, model.state_dict().values()))
    assert len(state.opt_state["mu"]) == len(list(tlora.iter_leaves(tt)))


# ---------------------------------------------------------------------------
# the GEMV kernels' backwards (plain route) against jax.grad
# ---------------------------------------------------------------------------

def _gemv_case(case, rng):
    """(JAX weight dict, port weight dict with its route check) of one
    GEMV: K6 uniform / cubic and K7 (2D rank-1), K8 / K9 (stacked rank-1
    with a layer), K10 (int8, 2D and stacked)."""
    din, dout, L = 256, 384, 3
    w = rng.standard_normal((L, din, dout)).astype(np.float32)
    w[:, 7] *= 6.0
    if case.startswith("k10"):
        jq = jquant.quantize_int8(jnp.asarray(w))
    else:
        jq = jquant.quantize_int4_rank1(jnp.asarray(w),
                                        nf4=case == "k6_cubic")
    host = {k: np.array(v) for k, v in jq.items()}
    jqp = {k: v[1] for k, v in jq.items()}      # JAX: the layer's 2D form
    if case in ("k8", "k9", "k10_stacked"):
        tqp = {k: torch.from_numpy(v) for k, v in host.items()}
        tqp["layer"] = torch.tensor([1], dtype=torch.int32)
    else:
        tqp = {k: torch.from_numpy(v[1].copy()) for k, v in host.items()}
    if "q" in tqp:
        tqp["q"] = tquant.column_major(tqp["q"])
    return jqp, tqp


GEMV_CASES = {"k6": False, "k6_cubic": False, "k7": True, "k8": False,
              "k9": True, "k10": False, "k10_stacked": False}


@pytest.mark.parametrize("case", list(GEMV_CASES))
def test_gemv_backward(monkeypatch, case):
    """Each GEMV wrapper a grad-enabled ``QuantLinear`` reaches (m <= 64,
    through ``quantized_matmul``; the cubic K6, which only the serving
    head reaches, through its wrapper) keeps its kernel route as the forward
    (its plain version on the CPU) and has ``dx`` within 1e-5 of each
    row's max |ref| against ``jax.grad`` of JAX's weight-only
    ``quantized_matmul`` on the layer's 2D weight (its XLA forms on the
    CPU; W4A8's activation rounding passes straight through); the frozen
    weights get no gradient."""
    w4a8 = GEMV_CASES[case]
    rng = np.random.default_rng(3)
    jqp, tqp = _gemv_case(case, rng)
    x = rng.standard_normal((2, 20, 256)).astype(np.float32)
    g = rng.standard_normal((2, 20, 384)).astype(np.float32)
    # the straight-through reference: JAX's weight-only form (its own
    # W4A8 branch rounds through an integer cast, whose grad is zero)
    ref = jax.grad(lambda xx: jnp.sum(jquant.quantized_matmul(
        xx, jqp) * g))(jnp.asarray(x))
    used = []
    for mod, name in ((tqg, "int4_rank1_gemv"),
                      (tqg, "int4_rank1_gemv_stacked"), (tig, "int8_gemv")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (
            used.append(_n), _f(*a, **k))[1])
    xt = torch.from_numpy(x).requires_grad_(True)
    if case == "k6_cubic":     # off the route (as in JAX): the wrapper
        y = tqg.int4_rank1_gemv(xt, tqp)
    else:
        y = tquant.quantized_matmul(xt, tqp, w8a8=w4a8)
    assert used, "the GEMV route was not taken"
    (y * torch.from_numpy(g)).sum().backward()
    ref = np.asarray(ref).reshape(-1, 256)
    err = np.abs(xt.grad.numpy().reshape(-1, 256) - ref)
    assert (err <= 1e-5 * np.abs(ref).max(-1, keepdims=True)).all()
    assert all(t.grad is None for t in tqp.values())


# ---------------------------------------------------------------------------
# the stage-2 curriculum and its schedule horizon
# ---------------------------------------------------------------------------

CHAIN = [
    {"Q": ["what is shown?"], "A": ["noise."],
     "info": {"Event_Time": 1, "relevance": [], "is_visual": True}},
    {"Q": ["and now?"], "A": ["more noise."],
     "info": {"Event_Time": 7, "relevance": [1], "is_visual": True}},
    {"Q": ["why?"], "A": ["static."],
     "info": {"Event_Time": 7, "relevance": [0, 1], "is_visual": False}},
]
SEGMENTS = [
    {"timestamp": [0.0, 2.0], "QAs": [
        {"QA_pairs": [{"Q": "what is shown?", "A": "noise."}],
         "relevance": [], "is_visual": True}]},
    {"timestamp": [2.0, 4.0], "QAs": [
        {"QA_pairs": [{"Q": "and now?", "A": "more noise."}],
         "relevance": [1], "is_visual": True},
        {"QA_pairs": [{"Q": "why?", "A": "static."}],
         "relevance": [0, 1], "is_visual": False}]},
]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """tests/test_stage2_e2e.py's clip (40 frames of seeded noise at 10
    fps) and, beside it, the published layout of the same frames: a video
    directory ``vidA`` of two 2-second segment files."""
    root = tmp_path_factory.mktemp("vid")
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 255, (48, 64, 3), np.uint8) for _ in range(40)]
    (root / "vidA").mkdir()
    for path, part in ((root / "clip.mp4", frames),
                       (root / "vidA" / "segment_1.mp4", frames[:20]),
                       (root / "vidA" / "segment_2.mp4", frames[20:])):
        w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                            (64, 48))
        for f in part:
            w.write(f)
        w.release()
    return str(root)


def test_count_dataset_turns(tmp_path):
    """Both layouts (an internal spec, published chains as a bare list and
    under ``query_chains``), unreadable files skipped: JAX's count."""
    (tmp_path / "a.json").write_text(json.dumps(
        {"video": "clip.mp4", "segments": SEGMENTS}))
    (tmp_path / "b.json").write_text(json.dumps([CHAIN, CHAIN[:1]]))
    (tmp_path / "c.json").write_text(json.dumps({"query_chains": [CHAIN]}))
    (tmp_path / "d.json").write_text("{not json")
    (tmp_path / "e.txt").write_text("[]")
    got = tstage2.count_dataset_turns(str(tmp_path))
    assert got == jstage2.count_dataset_turns(str(tmp_path)) == 9
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tstage2.count_dataset_turns(str(empty)) == \
        jstage2.count_dataset_turns(str(empty)) == 1


def _one_device_mesh(*args):
    from cogstream_tpu.parallel.mesh import make_mesh

    return make_mesh(1, 1, devices=jax.devices()[:1])


def test_train_stage2_video_on_nf4_base(base, clip, tmp_path, monkeypatch):
    """JAX's ``test_stage2_curriculum_on_nf4_base`` on both sides: an NF4
    base, the GT-selection rewrite, compression on the visual turns and a
    text-only turn; one trainer over two videos, the internal layout
    (timestamps into one clip) and then the published one (segment files
    through ``load_eval_spec``). Losses rtol 1e-5 after each video, the
    step count, updated adapters in units of lr."""
    from cogstream_tpu.evaluate.answer_generate import load_eval_spec
    from cogstream_tpu.processor.processing import CogStreamProcessor as JP
    from cogstream_tpu_torch.processor.processing import \
        CogStreamProcessor as TP

    jcfg, tcfg, jq, model = _mode(base, "nf4")
    monkeypatch.setattr(jstage2, "LoRAConfig",
                        lambda **kw: JLoRA(dropout=0.0, **kw))
    monkeypatch.setattr(jstage2, "make_mesh", _one_device_mesh)
    # the out dir is new, so JAX's restore finds nothing; skipping the call
    # skips its checkpoint library's import (~8 s)
    monkeypatch.setattr(jstage2.ckpt, "restore_train_state",
                        lambda *a: None)
    qpath = tmp_path / "vidA.json"
    qpath.write_text(json.dumps([CHAIN]))
    spec = load_eval_spec(str(qpath), clip)
    assert [seg["segment_file"] for seg in spec["segments"]] == \
        ["segment_1.mp4", "segment_2.mp4"]
    videos = [(os.path.join(clip, "clip.mp4"), SEGMENTS),
              (os.path.join(clip, spec["video"]), spec["segments"])]
    s2 = dict(max_seq_len=2048, max_frames=4, grad_accum=1,
              save_every=10_000, fps=1, learning_rate=1e-3)
    jtok = JTok(image_token_id=jcfg.image_token_index)
    ttok = TTok(image_token_id=jcfg.image_token_index)
    jtrainer = jstage2.Stage2Trainer(jq, jcfg, jtok, jstage2.Stage2Config(
        **s2), str(tmp_path / "j"), total_steps=20, log=lambda *a: None)
    init = jax.tree.map(np.asarray, jlora.init_cogreasoner_lora(
        jax.random.PRNGKey(0), jcfg,
        JLoRA(dropout=0.0, include_projector=True)))
    ttrainer = tstage2.Stage2Trainer(
        model, tcfg, ttok, tstage2.Stage2Config(**s2), str(tmp_path / "t"),
        total_steps=20, log=lambda *a: None,
        lora_cfg=TLoRA(dropout=0.0, include_projector=True),
        lora=bridge.lora_from_params(init, device="cpu"))
    for video, segments in videos:
        jl = jstage2.train_stage2_video(jtrainer, JP(jtok, jcfg.processor),
                                        video, segments)
        tl = tstage2.train_stage2_video(ttrainer, TP(ttok, tcfg.processor),
                                        video, segments)
        assert len(tl) == len(jl) == 3
        np.testing.assert_allclose(tl, jl, **LOSS)
    assert ttrainer.state.step == int(np.asarray(jtrainer.state.step)) == 6
    ref = dict(tlora.iter_leaves(jax.tree.map(np.asarray,
                                              jtrainer.state.lora)))
    got = dict(tlora.iter_leaves(bridge.lora_to_params(ttrainer.state.lora)))
    d = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    assert d.max() <= 2.01e-3 and np.mean(d > 1e-6) < 0.01


# ---------------------------------------------------------------------------
# the train-stage1 / train-stage2 commands
# ---------------------------------------------------------------------------

QA = {"vid1": {"QAs": [
    {"QA_pairs": [{"Q": "q0", "A": "a0"}], "relevance": [], "is_visual": True},
    {"QA_pairs": [{"Q": "q1", "A": "a1"}], "relevance": [1],
     "is_visual": False},
    {"QA_pairs": [{"Q": "q2", "A": "a2"}], "relevance": [1, 0],
     "is_visual": True},
]}}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny checkpoint the port writes (no tokenizer files: the byte
    tokenizer)."""
    from cogstream_tpu_torch.models.checkpoint import save_cogreasoner_to_hf
    from cogstream_tpu_torch.models.cogreasoner import \
        init_cogreasoner_params as t_init

    path = str(tmp_path_factory.mktemp("ckpt"))
    cfg = TConfig.tiny()
    save_cogreasoner_to_hf(t_init(cfg, torch.Generator().manual_seed(0),
                                  device="cpu"), cfg, path)
    return path


def test_train_stage1_cli(ckpt, tmp_path, capsys):
    """``train-stage1`` on a seeded ``--qa-json`` file and on a published
    chain directory takes its steps (byte tokens: ``--max-len 2048``)
    and writes ``language_module.npz``; without ``--device`` it asks for
    the card; ``--pipeline-stages 2`` in one process is JAX's "needs 2
    devices" (the pipelined command runs under torchrun in
    tests/test_torch_pipeline.py)."""
    (tmp_path / "qa.json").write_text(json.dumps(QA))
    chains = tmp_path / "chains"
    chains.mkdir()
    (chains / "v.json").write_text(json.dumps([CHAIN]))
    for qa, out in ((tmp_path / "qa.json", "s1"), (chains, "s1_dir")):
        argv = ["train-stage1", "--qa-json", str(qa), "--model-dir", ckpt,
                "--out", str(tmp_path / out), "--epochs", "1",
                "--batch-size", "2", "--max-len", "2048", "--device", "cpu"]
        assert tmain.main(argv) == 0
        assert (tmp_path / out / "language_module.npz").exists()
        printed = capsys.readouterr().out
        assert "selector samples" in printed
        assert int(printed.split("stage1: ")[1].split()[0]) >= 1
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tmain.main(argv[:-2])
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tmain.main(argv + ["--pipeline-stages", "2"])


@pytest.mark.parametrize("quantize", ["nf4", "int8_w8a8"])
def test_train_stage2_cli(ckpt, clip, tmp_path, capsys, quantize):
    """``train-stage2 --quantize-base nf4`` (and int8 with
    ``--w8a8-forward``) over a one-video query dir (published chains,
    segment files) trains every turn and writes ``full_module.npz``."""
    qdir = tmp_path / "queries"
    qdir.mkdir()
    (qdir / "vidA.json").write_text(json.dumps([CHAIN]))
    flags = (["--quantize-base", "nf4"] if quantize == "nf4" else
             ["--quantize-base", "int8", "--w8a8-forward"])
    argv = ["train-stage2", "--model-dir", ckpt, "--video-dir",
            clip, "--query-dir", str(qdir), "--out",
            str(tmp_path / "out"), "--device", "cpu"] + flags
    assert tmain.main(argv) == 0
    assert "vidA.json: 3 turns, mean loss" in capsys.readouterr().out
    assert (tmp_path / "out" / "full_module.npz").exists()


def test_train_stage2_cli_errors(ckpt, tmp_path, capsys):
    """``--w8a8-forward`` without an int8 base is the argparse error;
    ``--sequence-parallel`` takes JAX's refusals (3: not a power of two; 2
    in one process: "needs 2 devices"; the command runs under torchrun in
    tests/test_torch_pipeline.py); without ``--device`` the command asks
    for the card."""
    argv = ["train-stage2", "--model-dir", ckpt, "--video-dir",
            str(tmp_path), "--query-dir", str(tmp_path), "--out",
            str(tmp_path / "out"), "--device", "cpu"]
    for bad in (["--w8a8-forward"], ["--quantize-base", "nf4",
                                     "--w8a8-forward"]):
        with pytest.raises(SystemExit) as e:
            tmain.main(argv + bad)
        assert e.value.code == 2
        assert "--w8a8-forward requires --quantize-base int8" in \
            capsys.readouterr().err
    with pytest.raises(ValueError, match="power of two"):
        tmain.main(argv + ["--sequence-parallel", "3"])
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tmain.main(argv + ["--sequence-parallel", "2"])
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tmain.main(argv[:-2])
    assert "train-stage1" not in tmain.NOT_PORTED
    assert "train-stage2" not in tmain.NOT_PORTED
