"""What each quantized serving scheme costs in output fidelity, end to end
through every decoder layer — port of
``cogstream_tpu/evaluate/quant_quality.py``.

* **The same floats for every scheme.** ``build_text_params`` draws each
  layer's weights on the device from a ``torch.Generator`` seeded by
  (seed, layer), rounds them to bf16 and quantizes them there, so a call
  with another scheme quantizes the identical float model and two
  schemes never need to be resident together. The draws are torch's, not
  ``jax.random``'s: the contract is the JAX one (one seed, one float
  model, every scheme), not the same numbers as the JAX package.
* **bf16 is the truth.** One H100 holds a bf16 7B decoder, so the ladder
  compares int8, int8 + W8A8, int4u (rank-1 uniform), int4c (rank-1
  cubic) and nf4 (group-64) against bf16 (the 16 GB v5e of the JAX
  package could not, and compared against int8).
* Weights are random, so absolute divergences lack a real checkpoint's
  outlier structure; the relative ladder across schemes is the
  measurement. Teacher-forced top-1 agreement and greedy-prefix
  agreement are scale-free beside the logit MAE and KL.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..config import Qwen2Config
from ..models import qwen2
from ..models.qwen2 import Qwen2Model
from ..models.vision_encoder import default_device
from ..ops import quant

SCHEMES = ("bf16", "int8", "int4u", "int4c", "nf4")


def _quantize_kernel(w: torch.Tensor, scheme: str):
    """A bf16 ``[din, dout]`` kernel in ``scheme``: the tensor itself for
    bf16, else its quantized dict."""
    if scheme == "bf16":
        return w
    if scheme == "int8":
        return quant.quantize_int8(w)
    if scheme == "int4u":
        return quant.quantize_int4_rank1(w, nf4=False)
    if scheme == "int4c":
        return quant.quantize_int4_rank1(w, nf4=True)
    if scheme == "nf4":
        return quant.quantize_int4(w, nf4=True)
    raise ValueError(scheme)


def _generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) << 20) + int(stream))


def _uniform_bf16(gen, din: int, dout: int, device) -> torch.Tensor:
    """U(-1/sqrt(din), 1/sqrt(din)) in f32, rounded to bf16 (the JAX
    ``_gen_dense``)."""
    s = 1.0 / math.sqrt(din)
    w = torch.rand((din, dout), generator=gen, device=device) * (2 * s) - s
    return w.to(torch.bfloat16)


def _site_shapes(cfg: Qwen2Config):
    H, I = cfg.hidden_size, cfg.intermediate_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    return {"q_proj": (H, H), "k_proj": (H, kv), "v_proj": (H, kv),
            "o_proj": (H, H), "gate_proj": (H, I), "up_proj": (H, I),
            "down_proj": (I, H)}


@torch.no_grad()
def build_text_params(cfg: Qwen2Config, scheme: str, seed: int = 0,
                      device=None) -> Qwen2Model:
    """A bf16 decoder in ``scheme``, deterministic in ``seed``: layer i's
    seven kernels come from generator (seed, 2 + i), the embeddings and
    the head from (seed, 0) and (seed, 1); norms are ones, q/k/v biases
    zeros. A quantized scheme holds one weight's bf16 copy at a time."""
    device = default_device(device)
    L = cfg.num_hidden_layers
    shapes = _site_shapes(cfg)
    model = Qwen2Model(cfg, device="meta", dtype=torch.bfloat16)

    def param(t):
        return nn.Parameter(t, requires_grad=False)

    model.embed_tokens = param((torch.randn(
        (cfg.vocab_size, cfg.hidden_size), generator=_generator(seed, 0,
                                                                device),
        device=device) * 0.02).to(torch.bfloat16))
    model.final_norm = param(torch.ones(cfg.hidden_size, device=device))
    stores: Dict[str, Dict[str, torch.Tensor]] = {}
    for li, layer in enumerate(model.layers):
        layer.input_norm = param(torch.ones(cfg.hidden_size, device=device))
        layer.post_attn_norm = param(torch.ones(cfg.hidden_size,
                                                device=device))
        gen = _generator(seed, 2 + li, device)
        for grp, name in quant.GEMV_SITES:
            lin = getattr(layer, grp)[name]
            if lin.bias is not None:
                lin.bias = param(torch.zeros(lin.out_features,
                                             dtype=torch.bfloat16,
                                             device=device))
            k = _quantize_kernel(_uniform_bf16(gen, *shapes[name], device),
                                 scheme)
            if scheme == "bf16":
                lin.weight = param(k.t().contiguous())
                continue
            if name not in stores:
                stores[name] = quant.empty_stack(L, k)
            for key, v in k.items():
                stores[name][key][li] = v
    head = _quantize_kernel(_uniform_bf16(
        _generator(seed, 1, device), cfg.hidden_size, cfg.vocab_size, device),
        scheme)
    if scheme == "bf16":
        model.lm_head.weight = param(head.t().contiguous())
        return model
    return quant.install_quantized_(model, stores, head)


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

def probe_ids(cfg: Qwen2Config, n: int = 128, seed: int = 17,
              device=None) -> torch.Tensor:
    """[1, n] int32 token ids, the JAX package's draw."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(1, cfg.vocab_size, (1, n)),
                           dtype=torch.int32, device=default_device(device))


@contextlib.contextmanager
def _config(model: Qwen2Model, cfg: Qwen2Config):
    """Run ``model`` under ``cfg`` (its serving flags: the port's forward
    reads them from the model, the JAX one from its argument)."""
    old = model.cfg
    model.cfg = cfg
    try:
        yield model
    finally:
        model.cfg = old


def tf_logits(model: Qwen2Model, ids: torch.Tensor,
              cfg: Qwen2Config) -> torch.Tensor:
    """Teacher-forced logits [S, V] f32 of the cache-free forward (W8A8
    engages through ``cfg.w8a8_prefill``, as in a serving prefill)."""
    with _config(model, cfg), torch.inference_mode():
        pos = torch.arange(ids.shape[1], dtype=torch.int32,
                           device=ids.device)[None]
        h, _ = qwen2.qwen2_forward(model, qwen2.embed(model, ids), pos)
        return qwen2.lm_logits(model, h).to(torch.float32)[0]


def cached_logits(model: Qwen2Model, ids: torch.Tensor, cfg: Qwen2Config,
                  max_len: int, kv_dtype=None) -> torch.Tensor:
    """The prefill THROUGH a KV cache (the serving path) → [S, V] f32.
    ``kv_dtype`` runs it over a cache of that dtype (any
    ``runtime.session.check_kv_dtype`` takes: e4m3 / e5m2 for the fp8
    caches), where the cache's rounding changes the numbers."""
    from ..runtime.session import check_kv_dtype

    kv_dtype = check_kv_dtype(kv_dtype, model.dtype)
    with _config(model, cfg), torch.inference_mode():
        cache = qwen2.init_kv_cache(cfg, 1, max_len, dtype=kv_dtype,
                                    device=ids.device)
        pos = torch.arange(ids.shape[1], dtype=torch.int32,
                           device=ids.device)[None]
        h, _ = qwen2.qwen2_forward(model, qwen2.embed(model, ids), pos,
                                   cache)
        return qwen2.lm_logits(model, h).to(torch.float32)[0]


@torch.inference_mode()
def divergence(la: torch.Tensor, lb: torch.Tensor):
    """Mean-abs logit delta, KL(a||b) in nats and teacher-forced top-1
    agreement, as 0-d tensors on the logits' device."""
    mae = (la - lb).abs().mean()
    lpa = torch.log_softmax(la, dim=-1)
    lpb = torch.log_softmax(lb, dim=-1)
    kl = (lpa.exp() * (lpa - lpb)).sum(dim=-1).mean()
    agree = (la.argmax(-1) == lb.argmax(-1)).to(torch.float32).mean()
    return mae, kl, agree


def greedy_continuation(model: Qwen2Model, cfg: Qwen2Config,
                        ids: torch.Tensor, n: int = 32, max_len: int = 512,
                        kv_dtype=None) -> np.ndarray:
    """Greedy token ids (host ints) after a cached prefill: the
    generation-path probe (decode steps at S < 16, so ``w4a8_decode`` and
    the decode kernels take part); ``kv_dtype`` as in
    :func:`cached_logits`."""
    from ..runtime.generate import generate_tokens
    from ..runtime.session import check_kv_dtype

    kv_dtype = check_kv_dtype(kv_dtype, model.dtype)
    with _config(model, cfg):
        cache = qwen2.init_kv_cache(cfg, 1, max_len, dtype=kv_dtype,
                                    device=ids.device)
        S = ids.shape[1]
        pos = torch.arange(S, dtype=torch.int32, device=ids.device)[None]
        with torch.inference_mode():
            emb = qwen2.embed(model, ids)
        r = generate_tokens(model, emb, pos,
                            torch.tensor([S - 1], device=ids.device), cache,
                            None, n, eos_id=-7, temperature=0.0)
    return r.tokens[0].cpu().numpy()


def prefix_agreement(a: np.ndarray, b: np.ndarray) -> float:
    """Length of the common greedy prefix / total (after the first
    mismatch the sequences are conditioned differently)."""
    n = min(len(a), len(b))
    if n == 0:
        return 1.0
    neq = np.nonzero(np.asarray(a[:n]) != np.asarray(b[:n]))[0]
    return float((neq[0] if len(neq) else n) / n)


def compare_logits(la, lb, prefix: str) -> Dict[str, float]:
    mae, kl, agree = divergence(la, lb)
    return {f"{prefix}_logit_mae": round(float(mae), 5),
            f"{prefix}_kl": round(float(kl), 6),
            f"{prefix}_top1_agree": round(float(agree), 4)}
