"""Historic Dialogue Retrieval: constrained selector decoding (port of
``cogstream_tpu/runtime/retrieval.py``).

The prompt text is the stage-1-trained selector's interface and is
copied byte for byte (tests/test_torch_host.py holds it to the JAX
original). The decode is greedy over a static allowed-id set with the
lm_head sliced to those ids (``logit_ids``) and an early stop at ``]``.
The turn-invariant prompt head is prefilled once and its KV spliced
into each turn's cache.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models import qwen2
from ..models.qwen2 import KVCache, Qwen2Model, init_kv_cache
from ..processor.tokenizer import (constrained_selector_token_ids,
                                   selector_stop_token_ids)
from .generate import (PAD_BUCKETS, bucket_length, decode_new_tokens,
                       generate_tokens)
from .history import parse_selection, selection_string

SELECTOR_SYSTEM = """<|im_start|>system
You are a QA-pair filtering assistant. Your task is to identify which of the historical QA pairs are helpful for answering the current question and determine if the historical QA pairs alone are sufficient to answer it.

A QA pair is considered helpful if it provides:
- Relevant background information, context, or details
- Additional facts or insights that can be used to answer the current question
- Matching roles, scenarios, or domain knowledge that could support the answer

Output a single bracketed sequence:
- Start with 'yes' if the historical QA pairs are insufficient to fully answer the question (additional visual information may be needed).
- Start with 'no' if the current question can be fully answered using only the historical QA pairs (no additional visual information needed).
- Follow with the indices (starting from 0) of the helpful QA pairs, e.g., [yes,0,5] or [no,0,5].
- If no QA pairs are helpful, output [yes] or [no] based on the question's dependency.
- Do not add extra text or explanation — only output the bracketed sequence.
<|im_end|>"""

SELECTOR_DEMO = """\nExample:
Current Question: What causes earthquakes?
Historical QA Pairs:
0. Q: How to measure earthquakes? A: Using the Richter scale
1. Q: What is tectonic plate? A: Massive rock slabs beneath crust
2. Q: What is the weather like today? A: Sunny and warm
→ Output: [no,1]
------------------------------
Example:
Current Question: What does an earthquake look like?
Historical QA Pairs:
0. Q: How to measure earthquakes? A: Using the Richter scale
1. Q: What is tectonic plate? A: Massive rock slabs beneath crust
2. Q: What is the weather like today? A: Sunny and warm
→ Output: [yes]
------------------------------"""


def selector_prefix_text(include_demo: bool = True) -> str:
    """The turn-invariant head of the selector prompt (system rubric +
    few-shot demos + the ``Current Question:`` tag)."""
    demo = SELECTOR_DEMO if include_demo else ""
    return (f"{SELECTOR_SYSTEM}"
            f"<|im_start|>user\n{demo}"
            f"\nCurrent Question:")


def build_selector_prompt(current_question: str, hist_qs: List[str],
                          hist_as: List[str],
                          include_demo: bool = True) -> str:
    user = f""" {current_question}

Historical QA Pairs (ordered by time):"""
    for i, (q, a) in enumerate(zip(hist_qs, hist_as)):
        user += f"\n{i}. Q: {q}\n   A: {a}"
    user += ("\nGenerate a bracketed sequence (e.g., [yes,0,5] or [no,0,5]) "
             "indicating the dependency (yes or no) and the indices of "
             "helpful QA pairs. Only output the bracketed sequence.")
    return (f"{selector_prefix_text(include_demo)}{user}<|im_end|>"
            f"<|im_start|>assistant\n")


def window_selector_history(tokenizer, current_question: str,
                            hist_qs: List[str], hist_as: List[str],
                            max_prompt_tokens: int,
                            include_demo: bool = True):
    """Trim history to the most recent turns whose selector prompt fits
    ``max_prompt_tokens``. Returns (qs, as, offset): indices decoded
    against the window map back as ``i + offset``."""
    qs, as_ = list(hist_qs), list(hist_as)
    offset = 0
    while qs:
        prompt = build_selector_prompt(current_question, qs, as_,
                                       include_demo)
        if len(tokenizer.encode(prompt)) <= max_prompt_tokens:
            break
        drop = max(1, len(qs) // 8)
        qs, as_ = qs[drop:], as_[drop:]
        offset += drop
    return qs, as_, offset


def _remap_selection(selection: str, offset: int) -> str:
    """Shift windowed selection indices back to absolute turn ids."""
    if not offset:
        return selection
    if_visual, idx = parse_selection(selection)
    return selection_string(if_visual, [i + offset for i in idx])


# decode-cap buckets; 50 is the reference's constant ceiling
CAP_BUCKETS = (12, 24, 36, 50)


def maximal_selection(history_len: int) -> str:
    """The longest grammatical selector output over ``history_len`` QAs."""
    return "[yes" + "".join(f",{i}" for i in range(history_len)) + "]"


def selector_token_cap(history_len: int, tokenizer, ceiling: int = 50,
                       buckets=CAP_BUCKETS) -> int:
    """Worst-case decode length of a grammatical selection over
    ``history_len`` history QAs (the maximal selection plus eos,
    tokenized with the serving tokenizer), bucketed."""
    need = len(tokenizer.encode(maximal_selection(history_len))) + 1
    for b in buckets:
        if need <= b:
            return min(b, ceiling)
    return ceiling


def normalize_selection(text: str) -> str:
    """Bracket-normalize the raw decode."""
    text = text.strip()
    if text == "":
        return "[yes]"
    if not text.endswith("]"):
        text += "]"
    if not text.startswith("["):
        text = "[" + text
    return text


def _prefix_kv_device(model: Qwen2Model, ids: torch.Tensor, adapters,
                      lora_scale: float) -> KVCache:
    """Prefill of the turn-invariant selector prompt head into an
    exact-length [L, 1, P] cache (positions 0..P-1)."""
    P = ids.shape[0]
    emb = qwen2.embed(model, ids)[None]
    positions = torch.arange(P, dtype=torch.int32, device=ids.device)[None]
    cache = init_kv_cache(model.cfg, 1, P, dtype=model.dtype,
                          device=ids.device,
                          kv_heads=qwen2.local_kv_heads(model))
    _, cache = qwen2.qwen2_forward(model, emb, positions, cache, adapters,
                                   lora_scale)
    return cache


def _splice_prefix_cache(pre: KVCache, total: int, batch: int) -> KVCache:
    """A fresh [batch, total]-slot turn cache whose first P slots hold the
    shared prefix KV, with write_index = P."""
    L, _, P, Hkv, D = pre.k.shape
    k = pre.k.new_zeros((L, batch, total, Hkv, D))
    v = pre.v.new_zeros((L, batch, total, Hkv, D))
    k[:, :, :P] = pre.k
    v[:, :, :P] = pre.v
    pos = torch.full((batch, total), -1, dtype=torch.int32,
                     device=pre.pos.device)
    pos[:, :P] = pre.pos
    return KVCache(k, v, pos, P)


class Selector:
    """Runs the constrained retrieval decode with the language adapter,
    continuing from the shared prefix KV whenever the full prompt's ids
    literally start with the cached prefix ids (else a full prefill —
    same result)."""

    def __init__(self, model: Qwen2Model, tokenizer, adapters=None,
                 lora_scale: float = 2.0, max_new_tokens: int = 50,
                 prefix_cache: bool = True):
        self.model = model
        self.tokenizer = tokenizer
        self.adapters = adapters
        self.lora_scale = lora_scale
        self.max_new_tokens = max_new_tokens
        self.max_prompt_tokens = PAD_BUCKETS[-1] - max_new_tokens
        self.allowed_ids = tuple(constrained_selector_token_ids(tokenizer))
        self.stop_ids = tuple(selector_stop_token_ids(tokenizer))
        self.prefix_cache = prefix_cache
        self._cap_cache = {}
        self._prefix = {}        # include_demo -> (ids np, KVCache)
        self.prefix_hits = 0

    def _prefix_for(self, include_demo: bool):
        if not self.prefix_cache:
            return None
        got = self._prefix.get(include_demo)
        if got is None:
            ids = np.asarray(self.tokenizer.encode(
                selector_prefix_text(include_demo)), np.int32)
            cache = _prefix_kv_device(
                self.model, torch.from_numpy(ids).to(self.model.device),
                self.adapters, self.lora_scale)
            got = (ids, cache)
            self._prefix[include_demo] = got
        return got

    def _cap_for(self, history_lens) -> int:
        h = max(history_lens) if history_lens else 0
        key = (h, self.max_new_tokens)
        got = self._cap_cache.get(key)
        if got is None:
            got = selector_token_cap(h, self.tokenizer, self.max_new_tokens)
            self._cap_cache[key] = got
        return got

    def _prep_batch(self, ids_list, include_demo: bool, cap: int):
        """Pad/position a batch of selector prompts (continuing from the
        shared prefix KV when every row starts with its ids)."""
        B = len(ids_list)
        pre = self._prefix_for(include_demo)
        if pre is not None:
            pids, pcache = pre
            P = len(pids)
            if all(len(i) > P and np.array_equal(i[:P], pids)
                   for i in ids_list):
                sufs = [i[P:] for i in ids_list]
                S = bucket_length(max(len(s) for s in sufs))
                padded = np.zeros((B, S), np.int32)
                positions = np.full((B, S), -1, np.int32)
                last = np.zeros((B,), np.int32)
                for b, s in enumerate(sufs):
                    padded[b, :len(s)] = s
                    positions[b, :len(s)] = np.arange(P, P + len(s))
                    last[b] = len(s) - 1
                cache = _splice_prefix_cache(pcache, P + S + cap, B)
                self.prefix_hits += 1
                return padded, positions, last, cache
        S = bucket_length(max(len(i) for i in ids_list))
        padded = np.zeros((B, S), np.int32)
        positions = np.full((B, S), -1, np.int32)
        last = np.zeros((B,), np.int32)
        for b, ids in enumerate(ids_list):
            padded[b, :len(ids)] = ids
            positions[b, :len(ids)] = np.arange(len(ids))
            last[b] = len(ids) - 1
        cache = init_kv_cache(self.model.cfg, B, S + cap,
                              dtype=self.model.dtype,
                              device=self.model.device,
                              kv_heads=qwen2.local_kv_heads(self.model))
        return padded, positions, last, cache

    @torch.inference_mode()
    def select_batch(self, items, include_demo: bool = True,
                     generator: Optional[torch.Generator] = None
                     ) -> List[str]:
        """Batched constrained retrieval: ``items`` is a list of
        (current_question, hist_qs, hist_as); one prefill+decode covers
        all of them (the pooled serving path)."""
        windowed = [window_selector_history(
            self.tokenizer, q, hq, ha, self.max_prompt_tokens,
            include_demo) for q, hq, ha in items]
        prompts = [build_selector_prompt(q, hq, ha, include_demo)
                   for (q, _, _), (hq, ha, _) in zip(items, windowed)]
        ids_list = [np.asarray(self.tokenizer.encode(p), np.int32)
                    for p in prompts]
        cap = self._cap_for([len(hq) for hq, _, _ in windowed])
        padded, positions, last, cache = self._prep_batch(
            ids_list, include_demo, cap)
        dev = self.model.device
        emb = qwen2.embed(self.model, torch.from_numpy(padded).to(dev))
        result = generate_tokens(
            self.model, emb, torch.from_numpy(positions).to(dev),
            torch.from_numpy(last).to(dev), cache, generator, cap,
            self.tokenizer.eos_token_id, temperature=0.0,
            logit_ids=self.allowed_ids, adapters=self.adapters,
            lora_scale=self.lora_scale, stop_ids=self.stop_ids)
        toks = result.tokens.cpu().numpy()
        nums = result.num_tokens.cpu().numpy()
        outs = []
        for b in range(len(ids_list)):
            ids_out = toks[b, :int(nums[b])].tolist()
            if ids_out and ids_out[-1] == self.tokenizer.eos_token_id:
                ids_out = ids_out[:-1]
            outs.append(_remap_selection(
                normalize_selection(self.tokenizer.decode(
                    ids_out, skip_special_tokens=True)),
                windowed[b][2]))
        return outs

    @torch.inference_mode()
    def select(self, current_question: str, hist_qs: List[str],
               hist_as: List[str], include_demo: bool = True,
               generator: Optional[torch.Generator] = None) -> str:
        hist_qs, hist_as, offset = window_selector_history(
            self.tokenizer, current_question, hist_qs, hist_as,
            self.max_prompt_tokens, include_demo)
        prompt = build_selector_prompt(current_question, hist_qs, hist_as,
                                       include_demo)
        ids = np.asarray(self.tokenizer.encode(prompt), np.int32)
        cap = self._cap_for([len(hist_qs)])
        padded, positions, last, cache = self._prep_batch([ids],
                                                          include_demo, cap)
        dev = self.model.device
        emb = qwen2.embed(self.model, torch.from_numpy(padded).to(dev))
        result = generate_tokens(
            self.model, emb, torch.from_numpy(positions).to(dev),
            torch.from_numpy(last).to(dev), cache, generator, cap,
            self.tokenizer.eos_token_id, temperature=0.0,
            logit_ids=self.allowed_ids, adapters=self.adapters,
            lora_scale=self.lora_scale, stop_ids=self.stop_ids)
        text = decode_new_tokens(result.tokens.cpu(),
                                 result.num_tokens.cpu(), self.tokenizer)
        return _remap_selection(normalize_selection(text), offset)
