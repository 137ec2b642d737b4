"""The PyTorch port's models against the JAX package, on the CPU.

Weights come from the JAX initializers (tiny config, f32) and reach the
port through models/bridge.py; inputs are seeded numpy draws. The JAX
vision tower runs its serving path (``use_pallas=True``: the Pallas K1
and K2 kernels in interpret mode). Tolerances: whole-model hidden
states and logits atol = rtol = 1e-4; single ops 1e-5; cache positions
and write indices exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogstream_tpu.config import CogReasonerConfig as JConfig, LoRAConfig
from cogstream_tpu.models import qwen2 as jq
from cogstream_tpu.models.cogreasoner import init_cogreasoner_params
from cogstream_tpu.models.lora import init_qwen2_lora
from cogstream_tpu.models.projector import projector_forward
from cogstream_tpu.models.vision_encoder import vision_encoder_forward
from cogstream_tpu_torch.config import CogReasonerConfig as TConfig
from cogstream_tpu_torch.models import bridge
from cogstream_tpu_torch.models import qwen2 as tq
from cogstream_tpu_torch.models.vision_encoder import (
    vision_encoder_forward as t_vision_forward)
from cogstream_tpu_torch.runtime.generate import _sliced_head

HID = dict(atol=1e-4, rtol=1e-4)


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
    model = bridge.cogreasoner_from_params(host, tcfg)
    return jcfg, tcfg, params, model


def _lora(cfg, seed, with_head=False):
    """A LoRA tree with non-zero b (JAX init leaves b at zero)."""
    lora = init_qwen2_lora(jax.random.PRNGKey(seed), cfg.text,
                           LoRAConfig(rank=4))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda x: np.asarray(rng.standard_normal(x.shape) * 0.05,
                             np.float32), lora)
    if with_head:
        tree["lm_head"] = {
            "a": rng.standard_normal((cfg.text.hidden_size, 4)).astype(
                np.float32) * 0.05,
            "b": rng.standard_normal((4, cfg.text.vocab_size)).astype(
                np.float32) * 0.05}
    j = [(jax.tree.map(jnp.asarray, tree), jnp.float32(1.0))]
    t = [(bridge.adapter_from_params(tree), 1.0)]
    return j, t


@pytest.mark.parametrize("grids,merges,pad_to,uint8", [
    ([[2, 4, 4]], [2], None, False),
    ([[2, 4, 4], [1, 6, 4]], [2, 2], 64, True),   # ragged frames + pad rows
])
def test_vision_tower(setup, grids, merges, pad_to, uint8):
    jcfg, _, params, model = setup
    rng = np.random.default_rng(0)
    n = sum(t * h * w for t, h, w in grids)
    shape = (n, 3 * 14 * 14)
    pv = (rng.integers(0, 256, shape, dtype=np.uint8) if uint8 else
          rng.standard_normal(shape).astype(np.float32))
    ref = vision_encoder_forward(params["vision"], pv, np.array(grids),
                                 np.array(merges), jcfg.vision,
                                 use_pallas=True, pad_to=pad_to)
    got = t_vision_forward(model.vision, pv, np.array(grids),
                           np.array(merges), pad_to=pad_to)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **HID)


def test_projector(setup):
    jcfg, _, params, model = setup
    x = np.random.default_rng(1).standard_normal(
        (10, jcfg.vision.hidden_size)).astype(np.float32)
    ref = projector_forward(params["projector"], jnp.asarray(x))
    got = model.projector(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("lora", [False, True])
def test_qwen2_cache_free(setup, lora):
    jcfg, _, params, model = setup
    rng = np.random.default_rng(2)
    B, S = 2, 24
    emb = rng.standard_normal((B, S, jcfg.text.hidden_size)).astype(
        np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[1, -5:] = -1                                   # padded tail
    ja, ta = _lora(jcfg, 3) if lora else (None, None)
    ref, _ = jq.qwen2_forward(params["text"], jnp.asarray(emb),
                              jnp.asarray(pos), jcfg.text, adapters=ja)
    got, _ = tq.qwen2_forward(model.text, torch.from_numpy(emb),
                              torch.from_numpy(pos), adapters=ta)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **HID)


@pytest.mark.parametrize("lora", [False, True])
def test_qwen2_prefill_and_decode(setup, lora):
    """Prefill into the cache twice (the second under a kv_allowed
    mask), then one cached decode step (K4's route in the port)."""
    jcfg, _, params, model = setup
    rng = np.random.default_rng(4)
    H, T = jcfg.text.hidden_size, 96
    ja, ta = _lora(jcfg, 5) if lora else (None, None)
    jc = jq.init_kv_cache(jcfg.text, 1, T)
    tc = tq.init_kv_cache(model.text.cfg, 1, T)
    allowed = rng.random((1, T)) > 0.3
    allowed[:, 32:] = True
    steps = [  # (S, positions, kv_allowed)
        (32, np.r_[np.arange(28), [-1] * 4], None),
        (32, np.arange(28, 60), allowed),
        (1, np.array([60]), allowed),
    ]
    for S, p, allow in steps:
        emb = rng.standard_normal((1, S, H)).astype(np.float32)
        p = p.astype(np.int32)[None]
        hj, jc = jq.qwen2_forward(
            params["text"], jnp.asarray(emb), jnp.asarray(p), jcfg.text,
            cache=jc, adapters=ja,
            kv_allowed=None if allow is None else jnp.asarray(allow))
        ht, tc = tq.qwen2_forward(
            model.text, torch.from_numpy(emb), torch.from_numpy(p), tc,
            adapters=ta,
            kv_allowed=None if allow is None else torch.from_numpy(allow))
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **HID)
        assert tc.write_index == int(jc.write_index)
        np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **HID)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **HID)


def test_lm_logits_with_logit_ids(setup):
    jcfg, _, params, model = setup
    h = np.random.default_rng(6).standard_normal(
        (1, 3, jcfg.text.hidden_size)).astype(np.float32)
    ja, ta = _lora(jcfg, 7, with_head=True)
    ref = np.asarray(jq.lm_logits(params["text"], jnp.asarray(h), ja))
    got = tq.lm_logits(model.text, torch.from_numpy(h), ta).numpy()
    np.testing.assert_allclose(got, ref, **HID)
    lid = (2, 17, 300, 1000, 5)
    head = _sliced_head(model.text.lm_head, torch.tensor(lid), torch.float32)
    head_lora = [({"a": t["lm_head"]["a"], "b": t["lm_head"]["b"][:, list(lid)]},
                  g) for t, g in ta]
    sliced = tq.lm_logits(model.text, torch.from_numpy(h), head=head,
                          head_lora=head_lora).numpy()
    np.testing.assert_allclose(sliced, ref[..., list(lid)], **HID)
