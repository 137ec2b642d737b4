"""The PyTorch port's LoRA training path against the JAX package, on the CPU.

Weights come from the JAX initializers (tiny config, f32) through
models/bridge.py; inputs are seeded numpy draws fed to both sides. The
JAX side runs as the JAX package's own tests run it (its head-major
tower branch reaches the Pallas K5 in interpret mode). Tolerances, each
stated where it is asserted:

* losses: rtol 1e-5 (f32, summation order);
* gradients: per leaf, within 1e-4 of the leaf's own max |ref| — an
  element at rounding level may differ in relative terms;
* updated adapters: in units of the learning rate. Adam's first update
  moves every element with |g| >> eps by about lr, so a gradient element
  at rounding level can flip its step's sign between the packages; most
  elements must agree to 1e-3 lr and every one to 2.01 lr;
* tower features, host metadata, data batches: 1e-4 / exact.
"""

import dataclasses
import inspect
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cogstream_tpu.config import CogReasonerConfig as JConfig
from cogstream_tpu.config import LoRAConfig as JLoRA
from cogstream_tpu.models import lora as jlora
from cogstream_tpu.models.cogreasoner import init_cogreasoner_params
from cogstream_tpu.models.vision_encoder import (
    build_vision_metadata as j_meta, vision_encoder_core as j_core)
from cogstream_tpu.ops import flash_attention as jfa
from cogstream_tpu.processor.tokenizer import ByteTokenizer as JTok
from cogstream_tpu.train import checkpoint as jckpt
from cogstream_tpu.train import data as jdata
from cogstream_tpu.train import multimodal as jmm
from cogstream_tpu.train import stage1 as jstage1
from cogstream_tpu.train import stage2 as jstage2
from cogstream_tpu.train import trainer as jtr
from cogstream_tpu_torch.config import CogReasonerConfig as TConfig
from cogstream_tpu_torch.config import LoRAConfig as TLoRA
from cogstream_tpu_torch.models import bridge
from cogstream_tpu_torch.models import lora as tlora
from cogstream_tpu_torch.models import qwen2 as tq
from cogstream_tpu_torch.models.vision_encoder import (
    build_vision_metadata as t_meta, vision_encoder_core as t_core)
from cogstream_tpu_torch.ops import flash_attention as tfa
from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer as TTok
from cogstream_tpu_torch.train import checkpoint as tckpt
from cogstream_tpu_torch.train import data as tdata
from cogstream_tpu_torch.train import multimodal as tmm
from cogstream_tpu_torch.train import stage1 as tstage1
from cogstream_tpu_torch.train import stage2 as tstage2
from cogstream_tpu_torch.train import trainer as ttr

LOSS = dict(rtol=1e-5, atol=1e-6)


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
    host = jax.tree.map(np.asarray, params)
    model = bridge.cogreasoner_from_params(host, tcfg, device="cpu")
    return jcfg, tcfg, params, model


def _lora_pair(jcfg, seed, rank=4, projector=True, nonzero_b=True):
    """A JAX LoRA tree (stacked) and its bridged port tree. With
    ``nonzero_b`` the zero-init b leaves are replaced by seeded draws so
    that every leaf has a gradient."""
    tree = jlora.init_cogreasoner_lora(
        jax.random.PRNGKey(seed), jcfg,
        JLoRA(rank=rank, include_projector=projector))
    tree = jax.tree.map(np.asarray, tree)
    if nonzero_b:
        rng = np.random.default_rng(seed)
        tree = jax.tree_util.tree_map_with_path(
            lambda p, x: (rng.standard_normal(x.shape).astype(np.float32)
                          * 0.05) if p[-1].key == "b" else x, tree)
    return (jax.tree.map(jnp.asarray, tree),
            bridge.lora_from_params(tree, device="cpu"))


def _grads_close(jg, tg, rel=1e-4):
    """Per leaf: |port - jax| <= rel * max |jax| of that leaf."""
    ref = dict(tlora.iter_leaves(jax.tree.map(np.asarray, jg)))
    got = dict(tlora.iter_leaves(tg))
    assert ref.keys() == got.keys()
    for k in ref:
        r, g = ref[k], got[k]
        bound = rel * max(float(np.abs(r).max()), 1e-30)
        assert np.abs(g - r).max() <= bound, (k, np.abs(g - r).max(), bound)


def _port_grads(loss, tree):
    """d loss / d leaf for every leaf, in the JAX layout (numpy)."""
    grads = iter(torch.autograd.grad(
        loss, [t for _, t in tlora.iter_leaves(tree)]))
    return bridge.lora_to_params(tlora.map_leaves(lambda t: next(grads),
                                                  tree))


# ---------------------------------------------------------------------------
# K5 host metadata and the head-major tower
# ---------------------------------------------------------------------------

SEG_SETS = [([64, 64], 128), ([100, 57, 200, 43], 428), ([300], 300),
            ([136] * 16, None), ([136] * 6, 1024)]


def _segs(lengths, total):
    seg = np.concatenate([np.full(L, i, np.int32)
                          for i, L in enumerate(lengths)])
    if total is not None and total > seg.shape[0]:
        seg = np.concatenate([seg, np.full(total - seg.shape[0], -1,
                                           np.int32)])
    return seg


def test_flash_ranges_pinned_to_jax():
    """kv_block_ranges and FlashRanges are byte-for-byte copies of the
    JAX host metadata, and give its outputs on every segment set."""
    for name in ("_round_up", "kv_block_ranges", "FlashRanges"):
        assert inspect.getsource(getattr(tfa, name)) == \
            inspect.getsource(getattr(jfa, name))
    for lengths, total in SEG_SETS:
        seg = _segs(lengths, total)
        for bq, bk in ((128, 128), (64, 128), (136, 136)):
            got, ref = (m.kv_block_ranges(seg, bq, bk) for m in (tfa, jfa))
            np.testing.assert_array_equal(got[0], ref[0])
            np.testing.assert_array_equal(got[1], ref[1])
            assert got[2] == ref[2]
        got, ref = tfa.FlashRanges.build(seg), jfa.FlashRanges.build(seg)
        assert vars(got).keys() == vars(ref).keys()
        for k in vars(ref):
            np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))


@pytest.mark.parametrize("grids,pad_to,uint8", [
    ([[2, 4, 4]], None, False),
    ([[2, 4, 4], [1, 6, 4]], 64, True),   # ragged frames + pad rows
])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_head_major_tower(setup, grids, pad_to, uint8, use_pallas):
    """The tower without packed ranges against JAX
    ``vision_encoder_core`` eager: ``use_pallas=True`` reaches the Pallas
    K5 (interpret mode) on the JAX side and K5's plain version here;
    ``use_pallas=False`` the plain segment attention on both. atol =
    rtol = 1e-4."""
    jcfg, _, params, model = setup
    rng = np.random.default_rng(0)
    n = sum(t * h * w for t, h, w in grids)
    shape = (n, 3 * 14 * 14)
    pv = (rng.integers(0, 256, shape, dtype=np.uint8) if uint8 else
          rng.standard_normal(shape).astype(np.float32))
    merges = np.array([2] * len(grids))
    jm = j_meta(np.array(grids), merges, pad_to=pad_to)
    tm = t_meta(np.array(grids), merges, pad_to=pad_to)
    N = jm.pos_ids.shape[0]
    pvp = np.concatenate([pv, np.zeros((N - n, shape[1]), pv.dtype)])
    ref = j_core(params["vision"], jnp.asarray(pvp), jnp.asarray(jm.pos_ids),
                 jnp.asarray(jm.segment_ids), jnp.asarray(jm.merge_group_ids),
                 jm.num_out_tokens, jcfg.vision, use_pallas=use_pallas)
    calls = tfa.segment_flash_attention.launches
    got = t_core(model.vision, torch.from_numpy(pvp),
                 torch.from_numpy(tm.pos_ids), torch.from_numpy(tm.segment_ids),
                 torch.from_numpy(tm.merge_group_ids), tm.num_out_tokens,
                 use_pallas=use_pallas)
    assert tfa.segment_flash_attention.launches == calls   # CPU: plain
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# LoRA trees
# ---------------------------------------------------------------------------

def test_lora_bridge_round_trip(setup):
    jcfg = setup[0]
    jt, tt = _lora_pair(jcfg, 3)
    jt["text"]["lm_head"] = {
        "a": jnp.ones((jcfg.text.hidden_size, 4)) * 0.5,
        "b": jnp.arange(4 * jcfg.text.vocab_size, dtype=jnp.float32
                        ).reshape(4, -1)}
    tt = bridge.lora_from_params(jax.tree.map(np.asarray, jt), device="cpu")
    assert all(t.requires_grad and t.is_leaf and t.dtype == torch.float32
               for _, t in tlora.iter_leaves(tt))
    assert len(tt["text"]["layers"]) == jcfg.text.num_hidden_layers
    back = bridge.lora_to_params(tt)
    ref = dict(tlora.iter_leaves(jax.tree.map(np.asarray, jt)))
    got = dict(tlora.iter_leaves(back))
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    assert tlora.num_lora_params(tt) == jlora.num_lora_params(jt)


def test_lora_init_and_peft(setup):
    """Port init: the JAX tree's structure, shapes and statistics (draws
    differ: torch.Generator); PEFT interchange: the JAX result."""
    jcfg, tcfg = setup[0], setup[1]
    lc = TLoRA(rank=4, include_projector=True)
    tt = tlora.init_cogreasoner_lora(torch.Generator().manual_seed(0), tcfg,
                                     lc, device="cpu")
    jt = jlora.init_cogreasoner_lora(jax.random.PRNGKey(0), jcfg,
                                     JLoRA(rank=4, include_projector=True))
    shapes = {k: v.shape for k, v in tlora.iter_leaves(
        bridge.lora_to_params(tt))}
    assert shapes == {k: v.shape for k, v in tlora.iter_leaves(
        jax.tree.map(np.asarray, jt))}
    for k, t in tlora.iter_leaves(tt):
        assert t.requires_grad
        if k.endswith(".b"):
            assert torch.all(t == 0)
    a = tt["text"]["layers"][0]["mlp"]["down_proj"]["a"]
    assert abs(a.std().item() * a.shape[0] ** 0.5 - 1.0) < 0.1
    # PEFT state dict → tree
    rng = np.random.default_rng(1)
    sd = {}
    for i in range(jcfg.text.num_hidden_layers):
        for hf, (din, dout) in (("self_attn.q_proj", (64, 64)),
                                ("mlp.down_proj", (128, 64))):
            pre = f"base_model.model.model.layers.{i}.{hf}"
            sd[f"{pre}.lora_A.weight"] = torch.from_numpy(
                rng.standard_normal((4, din)).astype(np.float32))
            sd[f"{pre}.lora_B.weight"] = torch.from_numpy(
                rng.standard_normal((dout, 4)).astype(np.float32))
    ref = jlora.qwen2_lora_from_peft_state_dict(sd, jcfg.text)
    got = bridge.lora_to_params(tlora.qwen2_lora_from_peft_state_dict(
        sd, tcfg.text, device="cpu"))
    ref = dict(tlora.iter_leaves(jax.tree.map(np.asarray, ref)))
    assert dict(tlora.iter_leaves(got)).keys() == ref.keys()
    for k, v in tlora.iter_leaves(got):
        np.testing.assert_array_equal(v, ref[k])


# ---------------------------------------------------------------------------
# losses, schedule, optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_masked_cross_entropy(masked):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    labels[0, :4] = jtr.IGNORE_INDEX
    labels[1, 7:] = jtr.IGNORE_INDEX
    vm = np.zeros(50, bool)
    vm[rng.choice(50, 12, replace=False)] = True
    vm[labels[labels >= 0]] = True
    jl, jn = jtr.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                      jnp.asarray(vm) if masked else None)
    tl, tn = ttr.masked_cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels),
                                      torch.from_numpy(vm) if masked else None)
    np.testing.assert_allclose(tl.item(), float(jl), **LOSS)
    assert int(tn) == int(jn)
    ids = np.array([[5, 6, 0, 0], [3, 0, 4, 0]], np.int32)
    np.testing.assert_array_equal(
        ttr.positions_from_ids(torch.from_numpy(ids)).numpy(),
        np.asarray(jtr.positions_from_ids(jnp.asarray(ids))))


@pytest.mark.parametrize("total,warmup,accum", [(100, 10, 1), (100, 10, 4),
                                                (40, 0, 2), (5, 50, 1)])
def test_lr_schedule_matches_optax(total, warmup, accum):
    ref = jtr.make_lr_schedule(1e-4, total, warmup, accum)
    got = ttr.make_lr_schedule(1e-4, total, warmup, accum)
    for c in (0, 1, 3, 9, 10, 11, 20, 24, 49, 50, 51, 99, 100, 150):
        np.testing.assert_allclose(got(c), float(ref(c)), rtol=1e-6,
                                   atol=1e-12)
    assert ttr.make_lr_schedule(3e-4, 10, 1, schedule="constant") == \
        jtr.make_lr_schedule(3e-4, 10, 1, schedule="constant")


@pytest.mark.parametrize("accum,wd", [(1, 0.0), (2, 0.01)])
def test_adamw_and_accumulation_match_optax(accum, wd):
    """One AdamW update (accum 1) and a grad_accum=2 window over four
    micro-steps: parameters after each step within 1e-6 lr + f32
    rounding of the parameter (same gradients on both sides)."""
    rng = np.random.default_rng(5)
    p0 = {"x": rng.standard_normal((3, 4)).astype(np.float32),
          "y": rng.standard_normal(5).astype(np.float32)}
    lr = 1e-3
    jtx = jtr.make_optimizer(lr, total_steps=8, warmup_steps=0,
                             weight_decay=wd, grad_accum=accum)
    ttx = ttr.make_optimizer(lr, total_steps=8, warmup_steps=0,
                             weight_decay=wd, grad_accum=accum)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jtx.init(jp)
    tp = [torch.from_numpy(p0["x"].copy()), torch.from_numpy(p0["y"].copy())]
    ts = ttx.init(tp)
    for i in range(4 if accum > 1 else 2):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * 10 ** -i
             for k, v in p0.items()}
        upd, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tu, ts = ttx.update([torch.from_numpy(g["x"]),
                             torch.from_numpy(g["y"])], ts, tp)
        if tu is not None:
            for p, u in zip(tp, tu):
                p.add_(u)
        for p, k in zip(tp, ("x", "y")):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]),
                                       atol=1e-6 * lr + 1e-6, rtol=0)
    moved = [not np.array_equal(p.numpy(), p0[k]) for p, k in
             zip(tp, ("x", "y"))]
    assert all(moved)


# ---------------------------------------------------------------------------
# losses and gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

def _text_batch(jcfg, B=2, S=24, seed=6):
    rng = np.random.default_rng(seed)
    ids = rng.integers(16, 272, (B, S)).astype(np.int32)
    ids[1, -5:] = 0                                   # padded tail
    labels = np.full((B, S), jtr.IGNORE_INDEX, np.int32)
    labels[:, 12:] = ids[:, 12:]
    labels[1, -5:] = jtr.IGNORE_INDEX
    return {"input_ids": ids, "labels": labels}


@pytest.mark.parametrize("masked", [False, True])
def test_text_loss_and_grads(setup, masked):
    jcfg, _, params, model = setup
    jt, tt = _lora_pair(jcfg, 7, projector=False)
    jt, tt = jt["text"], tt["text"]
    batch = _text_batch(jcfg)
    vm = None
    if masked:
        vm = np.zeros(jcfg.text.vocab_size, bool)
        vm[np.unique(batch["input_ids"])] = True
    jloss, jg = jax.value_and_grad(
        lambda lo: jtr.text_loss_fn(params["text"], lo,
                                    jax.tree.map(jnp.asarray, batch),
                                    jcfg.text, 2.0,
                                    None if vm is None else jnp.asarray(vm),
                                    remat=False))(jt)
    tloss = ttr.text_loss_fn(model.text, tt, ttr.to_device(batch, "cpu"),
                             2.0, None if vm is None else torch.from_numpy(vm),
                             remat=False)
    np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS)
    _grads_close(jg, _port_grads(tloss, tt))


def test_embeds_loss_and_grads(setup):
    """The pre-spliced-embeddings objective against JAX ``embeds_loss_fn``
    (loss rtol 1e-5, gradients per leaf 1e-4 of max |ref|)."""
    jcfg, _, params, model = setup
    jt, tt = _lora_pair(jcfg, 14, projector=False)
    rng = np.random.default_rng(15)
    batch = _text_batch(jcfg)
    emb = rng.standard_normal((2, 24, jcfg.text.hidden_size)).astype(
        np.float32)
    pos = np.tile(np.arange(24, dtype=np.int32), (2, 1))
    pos[1, -5:] = -1
    batch = {"inputs_embeds": emb, "positions": pos,
             "labels": batch["labels"]}
    jloss, jg = jax.value_and_grad(
        lambda lo: jtr.embeds_loss_fn(params["text"], lo,
                                      jax.tree.map(jnp.asarray, batch),
                                      jcfg.text, 2.0, remat=False))(jt)
    loss_fn = ttr.bind_embeds_loss(TLoRA(dropout=0.0), remat=True)
    tloss = loss_fn(model.text, tt, ttr.to_device(batch, "cpu"))
    np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS)
    _grads_close(jg["text"], _port_grads(tloss, tt)["text"])


def _mm_batch(jcfg, pool: bool, seed=2):
    """A packed stage-2 turn through the JAX ``pack_turn_batch`` (the
    port's must build the same arrays)."""
    t, gh, gw, ms = 2, 4, 4, 2
    merged = (gh // ms) * (gw // ms)
    rng = np.random.default_rng(seed)
    images = types.SimpleNamespace(
        pixel_values=rng.normal(size=(t * gh * gw, 3 * 14 * 14)).astype(
            np.float32),
        grid_sizes=np.array([[t, gh, gw]]), merge_sizes=np.array([ms]))
    keep = np.ones((t * merged,), bool)
    minor = None
    if pool:                       # frame 1 minor: only its patch-0 stays
        keep[merged + 1:] = False
        minor = np.array([False, True])
    prompt = ("<|im_start|>user\n" + "<image>" * (t * merged) +
              "what?<|im_end|>\n<|im_start|>assistant\n")
    jtok = JTok(image_token_id=jcfg.image_token_index)
    ttok = TTok(image_token_id=jcfg.image_token_index)
    jb = jstage2.pack_turn_batch(jtok, jcfg, prompt, "an answer", images,
                                 keep, 2048, minor_frames=minor)
    tb = tstage2.pack_turn_batch(ttok, jcfg, prompt, "an answer", images,
                                 keep, 2048, minor_frames=minor)
    assert jb.keys() == tb.keys()
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
    assert ("pool_group" in jb) == pool
    return jb


@pytest.mark.parametrize("pool", [False, True])
def test_multimodal_loss_and_grads(setup, pool):
    """Stage-2 loss (frozen tower → projector + LoRA → pooling → splice
    → decoder → CE) and the LoRA gradients, projector adapter included,
    against ``jax.value_and_grad`` of the JAX loss."""
    jcfg, _, params, model = setup
    jt, tt = _lora_pair(jcfg, 8)
    batch = dict(_mm_batch(jcfg, pool))
    n_vis = int(batch.pop("num_vis_tokens"))
    jloss, jg = jax.value_and_grad(
        lambda lo: jmm.multimodal_loss_fn(
            params, lo, jax.tree.map(jnp.asarray, batch), jcfg, 2.0,
            num_vis_tokens=n_vis, remat=False))(jt)
    tloss = tmm.multimodal_loss_fn(model, tt, ttr.to_device(batch, "cpu"),
                                   2.0, num_vis_tokens=n_vis, remat=False)
    np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS)
    tg = _port_grads(tloss, tt)
    _grads_close(jg, tg)
    assert np.abs(tg["projector"]["layers"][1]["b"]).max() > 0


def test_pool_feature_table(setup):
    rng = np.random.default_rng(9)
    proj = rng.standard_normal((12, 5)).astype(np.float32)
    group = np.array([-1, 0, 0, 0, -1, 1, 1, -1, -1, 2, 2, 2], np.int32)
    dst = np.array([1, 5, 9, 12, 12, 12, 12, 12], np.int32)
    ref = jmm.pool_feature_table(jnp.asarray(proj), jnp.asarray(group),
                                 jnp.asarray(dst))
    got = tmm.pool_feature_table(torch.from_numpy(proj),
                                 torch.from_numpy(group),
                                 torch.from_numpy(dst))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_remat_matches_no_remat(setup):
    """Per-layer recomputation changes nothing: loss and gradients equal
    with remat on and off, LoRA dropout included (each recomputed layer
    redraws its forward's masks)."""
    jcfg, _, _, model = setup
    _, tt = _lora_pair(jcfg, 10, projector=False)
    batch = ttr.to_device(_text_batch(jcfg), "cpu")
    out = []
    for remat in (False, True):
        loss = ttr.text_loss_fn(model.text, tt["text"], batch, 2.0,
                                remat=remat, dropout_rate=0.1,
                                dropout_seed=ttr.step_seed(1, 0))
        out.append((loss.item(), _port_grads(loss, tt["text"])))
    assert out[0][0] == out[1][0]
    for (k, a), (_, b) in zip(tlora.iter_leaves(out[0][1]),
                              tlora.iter_leaves(out[1][1])):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)


def test_lora_dropout_semantics(setup):
    """Dropout is stochastic across steps, reproducible from the seed,
    and the identity at rate 0 (or without a seed)."""
    jcfg, _, _, model = setup
    _, tt = _lora_pair(jcfg, 11, projector=False)
    batch = ttr.to_device(_text_batch(jcfg), "cpu")

    def loss(rate, seed):
        with torch.no_grad():
            return ttr.text_loss_fn(model.text, tt["text"], batch, 2.0,
                                    remat=False, dropout_rate=rate,
                                    dropout_seed=seed).item()

    s0, s1 = ttr.step_seed(5, 0), ttr.step_seed(5, 1)
    assert loss(0.1, s0) == loss(0.1, s0)
    assert loss(0.1, s0) != loss(0.1, s1)
    assert loss(0.0, s0) == loss(0.0, s1) == loss(0.1, None)
    x = torch.ones(2000)
    g = tq.site_generator(3, 0, 1)
    kept = tmm._adapter_in(x, 0.25, g)
    assert set(kept.unique().tolist()) <= {0.0, float(x[0] / 0.75)}
    assert abs((kept == 0).float().mean().item() - 0.25) < 0.05
    assert torch.equal(tmm._adapter_in(x, 0.25, tq.site_generator(3, 0, 1)),
                       kept)


# ---------------------------------------------------------------------------
# data, checkpoints, adapters
# ---------------------------------------------------------------------------

QA = {"vid1": {"QAs": [
    {"QA_pairs": [{"Q": "q0", "A": "a0"}], "relevance": [], "is_visual": True},
    {"QA_pairs": [{"Q": "q1", "A": "a1"}], "relevance": [1],
     "is_visual": False},
    {"QA_pairs": [{"Q": "q2", "A": "a2"}], "relevance": [1, 0],
     "is_visual": True},
    {"QA_pairs": [{"Q": "q3 ü", "A": "a3"}], "relevance": [0, 1, 1],
     "is_visual": True},
]}}
CHAIN = [
    {"Q": ["what color?"], "A": ["red"],
     "info": {"ID": 0, "is_visual": True, "relevance": []}},
    {"Q": ["and the object?"], "A": ["a cup"],
     "info": {"ID": 1, "is_visual": True, "relevance": "[1]"}},
    {"Q": ["why did it fall?"], "A": ["pushed"],
     "info": {"ID": 2, "is_visual": False, "relevance": [0, 1]}},
]


def test_data_loaders_match_jax(tmp_path):
    (tmp_path / "qa.json").write_text(json.dumps(QA))
    d = tmp_path / "chains"
    d.mkdir()
    (d / "a.json").write_text(json.dumps([CHAIN]))
    (d / "b.json").write_text(json.dumps({"query_chains": [[CHAIN]]}))
    for fn, arg in (("load_selector_dataset", str(tmp_path / "qa.json")),
                    ("load_selector_dir", str(d))):
        got, ref = getattr(tdata, fn)(arg), getattr(jdata, fn)(arg)
        assert [vars(s) for s in got] == [vars(s) for s in ref]
        assert [s.target for s in got] == [s.target for s in ref]
    samples = tdata.load_selector_dataset(str(tmp_path / "qa.json"))
    jsamples = jdata.load_selector_dataset(str(tmp_path / "qa.json"))
    import random
    assert [vars(s) for s in tdata.shuffle_augment(
        samples[2], random.Random(3), 4)] == [vars(s) for s in
                                              jdata.shuffle_augment(
                                                  jsamples[2],
                                                  random.Random(3), 4)]
    for demo in (True, False):
        got = list(tdata.selector_batches(TTok(), samples, 2, 2048, seed=4,
                                          shuffle_copies=2,
                                          include_demo=demo))
        ref = list(jdata.selector_batches(JTok(), jsamples, 2, 2048, seed=4,
                                          shuffle_copies=2,
                                          include_demo=demo))
        assert len(got) == len(ref) > 1
        for g, r in zip(got, ref):
            assert g.keys() == r.keys()
            for k in r:
                np.testing.assert_array_equal(g[k], r[k])
    assert tdata.encode_selector_sample(TTok(), samples[0], 100) is None
    for p, t in (("[yes,2,0]", "[yes,0,2]"), ("[no,0]", "[yes,0]")):
        assert tdata.selection_exact_match(p, t) == \
            jdata.selection_exact_match(p, t)
    assert tstage2.build_gt_selection([1, 0, 1], 2, False) == \
        jstage2.build_gt_selection([1, 0, 1], 2, False)
    minor = np.array([False, True, True, False, True])
    for m in (minor, np.zeros(5, bool)):
        got = tstage2.build_pool_arrays(m, np.array([[5, 4, 4]]),
                                        np.array([2]), 20)
        ref = jstage2.build_pool_arrays(m, np.array([[5, 4, 4]]),
                                        np.array([2]), 20)
        assert (got is None) == (ref is None)
        if ref is not None:
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)


def test_checkpoint_resume_continues_trajectory(setup, tmp_path):
    """Three steps straight equal one step, a save, a restore into a
    fresh state and two more steps (dropout on: the per-step seeds come
    from the restored step counter)."""
    jcfg, _, _, model = setup
    batch = ttr.to_device(_text_batch(jcfg), "cpu")
    loss_fn = ttr.bind_text_loss(TLoRA(rank=4), remat=False)

    def fresh():
        tx = ttr.make_optimizer(1e-2, total_steps=6, warmup_steps=1,
                                grad_accum=2)
        _, tt = _lora_pair(jcfg, 12, projector=False)
        return tx, ttr.init_train_state(tx, tt["text"])

    tx, state = fresh()
    step = ttr.make_train_step(tx, loss_fn, dropout_seed=9)
    for _ in range(3):
        state, _ = step(model.text, state, batch)
    tx2, s2 = fresh()
    step2 = ttr.make_train_step(tx2, loss_fn, dropout_seed=9)
    s2, _ = step2(model.text, s2, batch)
    tckpt.save_train_state(str(tmp_path), s2)
    _, template = fresh()
    s3 = tckpt.restore_train_state(str(tmp_path), template)
    assert s3.step == 1 and s3.opt_state["mini_step"] == 1
    for _ in range(2):
        s3, _ = step2(model.text, s3, batch)
    for (k, a), (_, b) in zip(tlora.iter_leaves(state.lora),
                              tlora.iter_leaves(s3.lora)):
        assert torch.equal(a, b), k
    assert tckpt.restore_train_state(str(tmp_path / "none"), template) is None


def test_adapter_npz_interchange(setup, tmp_path):
    """An adapter written by either package loads in the other."""
    jcfg = setup[0]
    jt, tt = _lora_pair(jcfg, 13)
    path = tckpt.save_lora_adapter(str(tmp_path / "t"), tt, "full_module")
    back = jckpt.load_lora_adapter(path)
    ref = dict(tlora.iter_leaves(jax.tree.map(np.asarray, jt)))
    assert dict(tlora.iter_leaves(jax.tree.map(np.asarray, back))).keys() \
        == ref.keys()
    for k, v in tlora.iter_leaves(jax.tree.map(np.asarray, back)):
        np.testing.assert_array_equal(v, ref[k])
    path = jckpt.save_lora_adapter(str(tmp_path / "j"), jt, "full_module")
    got = bridge.lora_to_params(tckpt.load_lora_adapter(path, device="cpu"))
    for k, v in tlora.iter_leaves(got):
        np.testing.assert_array_equal(v, ref[k])


# ---------------------------------------------------------------------------
# training loops: train_stage1 and Stage2Trainer against JAX over 2 steps
# ---------------------------------------------------------------------------

def _adapters_close(jtree, ttree, lr):
    """Updated adapters in units of lr (module docstring)."""
    ref = dict(tlora.iter_leaves(jax.tree.map(np.asarray, jtree)))
    got = dict(tlora.iter_leaves(bridge.lora_to_params(ttree)))
    assert ref.keys() == got.keys()
    d = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    assert d.max() <= 2.01 * lr, d.max() / lr
    assert np.mean(d > 1e-3 * lr) < 0.01, np.mean(d > 1e-3 * lr)


def _one_device_mesh(*args):
    """The JAX training loops' mesh on one device: it places arrays only, so the
    numbers are those of the default 8-device mesh, at half the time."""
    from cogstream_tpu.parallel.mesh import make_mesh

    return make_mesh(1, 1, devices=jax.devices()[:1])


def test_train_stage1_matches_jax(setup, tmp_path, monkeypatch):
    """Two steps of the stage-1 loop (dropout 0, the JAX init bridged
    into the port): logged losses within the log's 4 decimals (1.1e-4)
    and updated adapters in units of lr."""
    jcfg, tcfg, params, model = setup
    (tmp_path / "qa.json").write_text(json.dumps(QA))
    scfg = dict(epochs=2, batch_size=3, max_len=1408, grad_accum=1,
                warmup_steps=1, save_every=1000, log_every=1,
                shuffle_copies=1, include_demo=False, learning_rate=1e-3)
    monkeypatch.setattr(jstage1, "LoRAConfig",
                        lambda: JLoRA(dropout=0.0))
    monkeypatch.setattr(jstage1, "make_mesh", _one_device_mesh)
    jlogs, tlogs = [], []
    jstate = jstage1.train_stage1(
        {"text": params["text"]}, jcfg, JTok(image_token_id=1000),
        jdata.load_selector_dataset(str(tmp_path / "qa.json")),
        str(tmp_path / "j"), jstage1.Stage1Config(**scfg),
        log=jlogs.append)
    init = jax.tree.map(np.asarray, jlora.init_qwen2_lora(
        jax.random.PRNGKey(0), jcfg.text, JLoRA(dropout=0.0)))
    tstate = tstage1.train_stage1(
        model.text, tcfg, TTok(image_token_id=1000),
        tdata.load_selector_dataset(str(tmp_path / "qa.json")),
        str(tmp_path / "t"), tstage1.Stage1Config(**scfg),
        log=tlogs.append, lora_cfg=TLoRA(dropout=0.0),
        lora=bridge.lora_from_params(init, device="cpu"))
    assert tstate.step == int(jstate.step) == 2

    def losses(logs):
        return [float(m.split(" loss ")[1].split()[0]) for m in logs
                if " loss " in m]
    np.testing.assert_allclose(losses(tlogs), losses(jlogs), atol=1.1e-4,
                               rtol=0)
    _adapters_close(jstate.lora, tstate.lora, 1e-3)
    assert (tmp_path / "t" / "language_module.npz").exists()


def test_stage2_trainer_matches_jax(setup, tmp_path, monkeypatch):
    """Two ``train_turn`` micro-steps (accum 1; one turn with a pooling
    plan, one text-only with the dummy visual table), dropout 0, the JAX
    init bridged: losses rtol 1e-5, updated adapters in units of lr."""
    jcfg, tcfg, params, model = setup
    monkeypatch.setattr(jstage2, "LoRAConfig",
                        lambda **kw: JLoRA(dropout=0.0, **kw))
    monkeypatch.setattr(jstage2, "make_mesh", _one_device_mesh)
    s2 = dict(max_seq_len=2048, grad_accum=1, save_every=10_000,
              learning_rate=1e-3)
    jtrainer = jstage2.Stage2Trainer(params, jcfg, JTok(image_token_id=1000),
                                     jstage2.Stage2Config(**s2),
                                     str(tmp_path / "j"), total_steps=20,
                                     log=lambda *a: None)
    init = jax.tree.map(np.asarray, jlora.init_cogreasoner_lora(
        jax.random.PRNGKey(0), jcfg,
        JLoRA(dropout=0.0, include_projector=True)))
    ttrainer = tstage2.Stage2Trainer(
        model, tcfg, TTok(image_token_id=1000), tstage2.Stage2Config(**s2),
        str(tmp_path / "t"), total_steps=20, log=lambda *a: None,
        lora_cfg=TLoRA(dropout=0.0, include_projector=True),
        lora=bridge.lora_from_params(init, device="cpu"))
    text_turn = tstage2.pack_turn_batch(
        TTok(image_token_id=1000), tcfg, "<|im_start|>user\nhi?<|im_end|>\n",
        "yes", None, None, 2048)
    for batch in (_mm_batch(jcfg, pool=True), text_turn):
        jl = jtrainer.train_turn(dict(batch))
        tl = ttrainer.train_turn(dict(batch))
        np.testing.assert_allclose(tl, jl, **LOSS)
    _adapters_close(jtrainer.state.lora, ttrainer.state.lora, 1e-3)
    assert not ttrainer.preempted()
    ttrainer.finish()
    assert (tmp_path / "t" / "full_module.npz").exists()


@pytest.mark.parametrize("name", ["Stage1Config", "Stage2Config"])
def test_stage_configs_match_jax(name):
    """The stage config dataclasses are field-for-field copies."""
    mod_j, mod_t = {"Stage1Config": (jstage1, tstage1),
                    "Stage2Config": (jstage2, tstage2)}[name]

    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert spec(getattr(mod_t, name)) == spec(getattr(mod_j, name))


def test_preemption_guard_and_selector_eval():
    """PreemptionGuard: SIGTERM inside the context only sets the flag and
    the previous handler comes back; evaluate_selector scores exact
    matches of a Selector's output."""
    import os
    import signal

    prev = signal.getsignal(signal.SIGTERM)
    with ttr.PreemptionGuard() as guard:
        assert not guard()
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard()
    assert signal.getsignal(signal.SIGTERM) is prev
    samples = [tdata.SelectorSample("q", ["h0", "h1"], ["a0", "a1"], r, v)
               for r, v in (([1], True), ([0, 1], False), ([], True))]
    picks = iter(["[yes,1]", "[no,0]", "[yes]"])
    sel = types.SimpleNamespace(select=lambda *a: next(picks))
    got = tstage1.evaluate_selector(sel, samples)
    assert got == {"exact_match": 2 / 3, "n": 3}


def test_parallel_options_raise(setup):
    """Pipeline and sequence parallelism train (tests/test_torch_pipeline.py);
    what stays refused is JAX's: a pipeline with a model axis, an sp size
    that is not a power of two or does not divide ``max_seq_len``, and too
    few ranks (one process here); an sp axis of one rank is the dense
    loss."""
    from cogstream_tpu_torch.parallel.mesh import SequenceMesh

    jcfg, tcfg, _, model = setup
    with pytest.raises(ValueError, match="exclusive with model_parallel"):
        tstage1.train_stage1(model.text, tcfg, TTok(), [], "/nonexistent",
                             tstage1.Stage1Config(pipeline_stages=2,
                                                  model_parallel=2))
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tstage1.train_stage1(model.text, tcfg, TTok(), [], "/nonexistent",
                             tstage1.Stage1Config(pipeline_stages=2))
    for kw, match in (({"sequence_parallel": 3}, "power of two"),
                      ({"sequence_parallel": 2, "max_seq_len": 3001},
                       "must divide max_seq_len=3001"),
                      ({"sequence_parallel": 2}, "needs 2 devices, have 1")):
        with pytest.raises(ValueError, match=match):
            tstage2.Stage2Trainer(model, tcfg, TTok(),
                                  tstage2.Stage2Config(**kw), "/nonexistent")
    # data parallelism is ported: without a mesh the batch is the chunk
    batch = {"input_ids": np.zeros((2, 3), np.int32)}
    assert ttr.shard_batch(batch, None) is batch
    rng = np.random.default_rng(0)
    S = 16
    mm = {"pixel_values": torch.zeros(4, 3 * 14 * 14),
          "vis_pos": torch.zeros(4, 2, dtype=torch.int32),
          "vis_seg": torch.full((4,), -1, dtype=torch.int32),
          "vis_grp": torch.full((4,), -1, dtype=torch.int32),
          "input_ids": torch.as_tensor(rng.integers(3, 200, (1, S))),
          "feat_src": torch.full((1, S), -1, dtype=torch.int32),
          "positions": torch.arange(S, dtype=torch.int32)[None],
          "labels": torch.as_tensor(rng.integers(3, 200, (1, S)))}
    dense = tmm.multimodal_loss_fn(model, {}, mm, 2.0, 1)
    one = tmm.multimodal_loss_fn(model, {}, mm, 2.0, 1, sp=SequenceMesh(1))
    torch.testing.assert_close(one, dense, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tstage2.main(["--model-dir", "/nonexistent", "--video-dir", "v",
                      "--query-dir", "q", "--out", "o",
                      "--sequence-parallel", "2"])


# ---------------------------------------------------------------------------
# the card by default
# ---------------------------------------------------------------------------

def test_constructors_default_to_the_card(setup):
    """A constructor called without a device asks for CUDA: there is no CPU
    fallback, so without a card it raises; the tests pass
    ``device="cpu"``."""
    from cogstream_tpu_torch.models import vision_encoder as tve
    from cogstream_tpu_torch.models.cogreasoner import \
        init_cogreasoner_params as t_init

    assert tve.default_device() == torch.device("cuda")
    assert tve.default_device("cpu") == torch.device("cpu")
    tcfg = setup[1]
    ctors = [
        lambda: tq.Qwen2Model(tcfg.text),
        lambda: tve.VisionTower(tcfg.vision),
        lambda: tq.init_kv_cache(tcfg.text, 1, 8),
        lambda: t_init(tcfg, torch.Generator()),
        lambda: tlora.init_qwen2_lora(torch.Generator(), tcfg.text, TLoRA()),
        lambda: bridge.lora_from_params(bridge.lora_to_params(
            _lora_pair(setup[0], 1)[1])),
    ]
    for make in ctors:
        if torch.cuda.is_available():
            out = make()
            t = next(iter(out.parameters())) if isinstance(
                out, torch.nn.Module) else getattr(out, "k", None)
            if t is None:
                t = next(v for _, v in tlora.iter_leaves(out))
            assert t.device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                make()
