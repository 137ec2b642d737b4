"""CogReasoner inference engine — port of ``cogstream_tpu/runtime/engine.py``.

The per-turn API of the reference's evaluation (``cogreasoner_chat.py``):
``qa_selection`` (modes FCC / AC / NC / gt), ``generate`` and ``chat``.
The engine is stateless across turns: every turn re-processes the whole
conversation (processor, vision tower, Visual Stream Compression,
splice, prefill), like the reference. The KV-reusing streaming session
is runtime/session.py.

One difference from the JAX engine: the prefill runs over the bucket of
the compacted prompt (``bucket_length`` of its real length), not over
the bucket of the uncompressed one, whose tail after compaction is only
padding. Padding carries position -1 and is invisible either way.

``mesh=`` (parallel/mesh.Mesh) serves tensor-parallel: every rank builds
the engine with the same arguments and runs the same turns; the model is
sharded once (``parallel/sharding.ensure_cogreasoner_sharded``), the
adapters sliced with it (``shard_adapters``: the selector takes the
language adapter's slice) and each turn's caches hold the rank's kv heads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CogReasonerConfig
from ..models import cogreasoner
from ..models.cogreasoner import (CogReasoner, with_int8_tower,
                                  with_serving_flags)
from ..models.qwen2 import init_kv_cache, local_kv_heads
from ..parallel.sharding import (ensure_cogreasoner_sharded,
                                 shard_adapters, sharded_mesh)
from ..processor.processing import CogStreamProcessor, ProcessorOutput
from .generate import (bucket_length, decode_new_tokens, generate_tokens,
                       generate_tokens_lookahead)
from .history import parse_selection, rewrite_history, selection_string
from .retrieval import Selector


@dataclass
class SelectionResult:
    input_ids: np.ndarray          # pruned prompt token ids
    selection: str                 # raw selector output (e.g. "[yes,0,2]")
    if_visual: bool


@dataclass
class TurnResult:
    text: str
    selection: str
    if_visual: bool
    num_tokens: int


class CogReasonerEngine:
    """Holds the model and the selector; one instance per process. Runs
    on the model's device."""

    def __init__(
        self,
        model: CogReasoner,
        cfg: CogReasonerConfig,
        tokenizer,
        adapters: Optional[Dict[str, Dict]] = None,
        rng_seed: int = 0,
        mesh=None,
        encoder_int8: bool = False,
    ):
        # mesh: this rank's shard of the model (idempotent); cfg's serving
        # flags; encoder_int8: the engine's own W8A8 copy of the vision tower
        model = ensure_cogreasoner_sharded(model, cfg, mesh)
        adapters = shard_adapters(adapters, cfg, sharded_mesh(model))
        self.mesh = mesh
        model = with_serving_flags(model, cfg)
        if encoder_int8:
            model = with_int8_tower(model)
        self.model = model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.adapters = adapters or {}
        self.device = model.text.device
        self.processor = CogStreamProcessor(tokenizer, cfg.processor)
        self.generator = torch.Generator(device=self.device).manual_seed(
            rng_seed)

        lang = self.adapters.get("language_module")
        self.selector = Selector(
            model.text, tokenizer,
            adapters=[(lang.get("text", lang), 1.0)] if lang else None)

    # -- history retrieval + prompt rewrite ---------------------------------

    def qa_selection(
        self,
        out: ProcessorOutput,
        mode: str = "FCC",
        select_gt: Optional[Sequence[int]] = None,
        if_visual: Optional[bool] = None,
    ) -> SelectionResult:
        """History retrieval + prompt rewrite."""
        if mode == "AC" or not out.hist_qs:
            # empty history short-circuits to if_visual=True in EVERY
            # mode including gt — the reference sets if_visual = True on
            # its len(hist_qs)==0 branch even when the caller
            # teacher-forces if_visual=False
            return SelectionResult(out.input_ids, "", True)
        if mode == "FCC":
            selection = self.selector.select(
                out.current_question, out.hist_qs, out.hist_as,
                generator=self.generator)
        elif mode == "NC":
            selection = "[yes]"
        elif mode == "gt":
            if select_gt is None:
                raise ValueError("gt mode requires select_gt")
            selection = selection_string(
                True if if_visual is None else if_visual, select_gt)
        else:
            raise ValueError(f"unknown qa_selection mode: {mode}")

        visual, indices = parse_selection(selection)
        n_hist = min(len(out.hist_qs), len(out.hist_as))
        kept_qs = [out.hist_qs[i] for i in indices if i < n_hist]
        kept_as = [out.hist_as[i] for i in indices if i < n_hist]
        new_text = rewrite_history(out.original_text, visual, kept_qs,
                                   kept_as, out.current_question)
        new_ids = np.asarray(self.tokenizer.encode(new_text), np.int32)
        return SelectionResult(new_ids, selection, visual)

    # -- multimodal prefill inputs ------------------------------------------

    def prepare_multimodal(
        self,
        out: ProcessorOutput,
        input_ids: np.ndarray,
        if_visual: bool,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(embeds [1, S, H], positions [1, S], last_index [1]) for the
        prefill, S the bucket of the compacted prompt."""
        dev = self.device
        S = bucket_length(len(input_ids))
        ids = np.zeros((S,), np.int32)
        ids[:len(input_ids)] = input_ids
        valid = np.zeros((S,), bool)
        valid[:len(input_ids)] = True

        images = out.images
        if if_visual and images is not None \
                and images.pixel_values.shape[0] > 0:
            pv = torch.from_numpy(images.pixel_values).to(dev)
            mm = cogreasoner.encode_images(self.model, pv, images.grid_sizes,
                                           images.merge_sizes)
            comp = cogreasoner.run_visual_compression(
                self.model, self.cfg, self.tokenizer, mm, pv,
                images.grid_sizes, images.merge_sizes, images.modals,
                out.all_timestamps,
                np.asarray(self.tokenizer.encode(out.current_question),
                           np.int32),
                self.generator)
            mm_features, keep = comp.mm_features, comp.keep_visual
        else:
            mm_features = torch.zeros((1, self.cfg.text.hidden_size),
                                      dtype=self.model.text.dtype, device=dev)
            keep = torch.zeros((1,), dtype=torch.bool, device=dev)

        mi = cogreasoner.splice_and_compact(
            self.model, self.cfg, torch.from_numpy(ids).to(dev),
            torch.from_numpy(valid).to(dev), mm_features, keep)
        n = bucket_length(max(int(mi.length), 1))
        return (mi.embeds[None, :n], mi.positions[None, :n],
                mi.last_index.reshape(1).to(torch.int32))

    # -- generation ----------------------------------------------------------

    @torch.inference_mode()
    def generate(
        self,
        out: ProcessorOutput,
        sel: SelectionResult,
        max_new_tokens: int = 1024,
        temperature: float = 0.0,
        top_p: float = 1.0,
        top_k: int = 0,
        repetition_penalty: float = 1.0,
        lookahead_k: int = 0,
        extra_eos_ids: tuple = (),
    ) -> TurnResult:
        embeds, positions, last_index = self.prepare_multimodal(
            out, sel.input_ids, sel.if_visual)
        xeos = tuple(extra_eos_ids) or None

        full = self.adapters.get("full_module")
        adapters = [(full.get("text", full), 1.0)] if full else None

        # prompt-lookup speculative decode: exact greedy output, fewer
        # forwards; only for greedy decodes without a repetition penalty
        # (the reference's default 1.05 falls back to the vanilla loop).
        # The match corpus is the rewritten conversation's text ids,
        # -1-padded to their own bucket (media runs never match).
        if (lookahead_k > 0 and temperature == 0.0
                and repetition_penalty == 1.0):
            n_ids = len(sel.input_ids)
            pids = np.full((1, bucket_length(n_ids)), -1, np.int32)
            pids[0, :n_ids] = sel.input_ids
            cache = init_kv_cache(
                self.cfg.text, 1,
                embeds.shape[1] + max_new_tokens + lookahead_k + 1,
                dtype=self.model.text.dtype, device=self.device,
                kv_heads=local_kv_heads(self.model.text))
            result = generate_tokens_lookahead(
                self.model.text, embeds, positions, last_index, cache, pids,
                max_new_tokens, self.tokenizer.eos_token_id,
                lookahead_k=lookahead_k, adapters=adapters,
                corpus_last=[n_ids - 1], extra_eos_ids=xeos)
            text = decode_new_tokens(result.tokens, result.num_tokens,
                                     self.tokenizer)
            return TurnResult(text, sel.selection, sel.if_visual,
                              int(result.num_tokens[0]))

        # repetition-penalty context = the full (rewritten) conversation
        # ids, exactly HF generate's input_ids
        pen_ids = None
        if repetition_penalty != 1.0:
            pen_ids = torch.from_numpy(np.asarray(
                sel.input_ids, np.int32)[None]).to(self.device)

        cache = init_kv_cache(self.cfg.text, 1,
                              embeds.shape[1] + max_new_tokens,
                              dtype=self.model.text.dtype, device=self.device,
                              kv_heads=local_kv_heads(self.model.text))
        result = generate_tokens(
            self.model.text, embeds, positions, last_index, cache,
            self.generator, max_new_tokens, self.tokenizer.eos_token_id,
            temperature=temperature, top_p=top_p, top_k=top_k,
            repetition_penalty=repetition_penalty, penalty_ids=pen_ids,
            adapters=adapters, extra_eos_ids=xeos)
        tokens, num = result.tokens.cpu(), result.num_tokens.cpu()
        text = decode_new_tokens(tokens, num, self.tokenizer)
        return TurnResult(text, sel.selection, sel.if_visual, int(num[0]))

    # -- one full turn -------------------------------------------------------

    def chat(
        self,
        conversation: List[dict],
        mode: str = "FCC",
        max_new_tokens: int = 1024,
        temperature: float = 0.0,
        top_p: float = 1.0,
        top_k: int = 0,
        repetition_penalty: float = 1.0,
        lookahead_k: int = 0,
        extra_eos_ids: tuple = (),
        select_gt=None,
        if_visual=None,
    ) -> TurnResult:
        """processor → qa_selection → generate."""
        out = self.processor(conversation, add_generation_prompt=True)
        sel = self.qa_selection(out, mode=mode, select_gt=select_gt,
                                if_visual=if_visual)
        return self.generate(out, sel, max_new_tokens=max_new_tokens,
                             temperature=temperature, top_p=top_p,
                             top_k=top_k,
                             repetition_penalty=repetition_penalty,
                             lookahead_k=lookahead_k,
                             extra_eos_ids=extra_eos_ids)
