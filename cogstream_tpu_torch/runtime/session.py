"""Streaming session with cross-turn KV reuse — port of the solo serving
path of ``cogstream_tpu/runtime/session.py``.

* **ingest** (``append_stream_segment``): the segment's frames are
  encoded (vision tower + projector), pixel-diff compressed on the host,
  wrapped in ``stream``-role template text and prefilled into the
  position-tagged cache once, with one extra pooled SHADOW token per
  frame (exact mean-pool values for pruned-event asks); every
  ``frames_per_event`` frames seal an event whose summary representation
  comes from one batched LM forward.
* **ask**: the selector's constrained decode picks history turns (FCC),
  a per-turn ``kv_allowed`` mask hides everything unselected (and, with
  enough events, prunes unimportant events to their keyframes + shadow
  tokens), then the question is prefilled and the answer decoded.

History never re-tokenizes: kept tokens keep their cache slots and
absolute RoPE positions. The cache's ``write_index`` is a host int (the
port's KVCache keeps it on the host), so no device scalar is read.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CogReasonerConfig
from ..models import qwen2
from ..models.cogreasoner import (SUMMARY_INSTRUCTION, SUMMARY_SYSTEM,
                                  CogReasoner, encode_images,
                                  pixel_diff_keep_mask_host)
from ..models.qwen2 import KVCache, Qwen2Model, init_kv_cache
from .generate import decode_new_tokens, generate_tokens
from .history import parse_selection
from .retrieval import Selector

SYSTEM_PROMPT = (
    "You are a helpful assistant watching a live video stream and "
    "answering the user's questions about it.")


def _ingest_device_step(text: Qwen2Model, adapters, cache: KVCache,
                        mm: torch.Tensor, ids_pad, img_pad, rows_pad,
                        shadow_idx, positions, kv_allowed, frame_rows_idx,
                        t: int, merged: int):
    """Device half of one segment ingest: embed the template ids, splice
    the kept visual rows (pads scatter into a scratch row), put each
    frame's pooled SHADOW embedding at its slot, prefill the cache, and
    return the per-frame features/rows the event machinery needs.
    ``kv_allowed`` hides earlier shadow slots from this prefill."""
    emb = qwen2.embed(text, ids_pad)
    emb = torch.cat([emb, emb.new_zeros((1, emb.shape[1]))])
    emb[img_pad] = mm[rows_pad].to(emb.dtype)
    pooled = mm[: t * merged].reshape(t, merged, -1).mean(dim=1)
    emb[shadow_idx] = pooled.to(emb.dtype)
    emb = emb[:-1]
    _, cache = qwen2.qwen2_forward(text, emb[None], positions[None], cache,
                                   adapters, kv_allowed=kv_allowed)
    frame_rows_all = mm[frame_rows_idx.reshape(-1)].reshape(t, merged, -1)
    return cache, pooled.to(torch.float32), frame_rows_all


def _event_summary_batch_device(text: Qwen2Model, ids_pad, img_pad, sel_pad,
                                feats, pos) -> torch.Tensor:
    """Batched event-summary forward: K events' prompts embed + splice +
    one cache-free decoder pass + masked mean. ``feats`` is [K, F, H];
    ``sel_pad`` indexes each event's own rows; ``img_pad`` pads point at
    the scratch row L."""
    K = ids_pad.shape[0]
    emb = qwen2.embed(text, ids_pad)                        # [K, L, H]
    emb = torch.cat([emb, emb.new_zeros((K, 1, emb.shape[-1]))], dim=1)
    rows = torch.arange(K, device=emb.device)[:, None]
    emb[rows, img_pad] = feats[rows, sel_pad].to(emb.dtype)
    emb = emb[:, :-1]
    hidden, _ = qwen2.qwen2_forward(text, emb, pos)
    valid = (pos >= 0)[..., None].to(torch.float32)
    return ((hidden.to(torch.float32) * valid).sum(dim=1)
            / valid.sum(dim=1).clamp(min=1.0))


def _question_rep_device(text: Qwen2Model, ids: torch.Tensor,
                         q_pos: torch.Tensor) -> torch.Tensor:
    """Masked-mean hidden rep of the current question (the cosine query
    of event pruning)."""
    h, _ = qwen2.qwen2_forward(text, qwen2.embed(text, ids)[None], q_pos)
    valid = (q_pos[0] >= 0)[:, None].to(torch.float32)
    return ((h[0].to(torch.float32) * valid).sum(dim=0)
            / valid.sum().clamp(min=1.0))


@torch.inference_mode()
def flush_event_reps(sessions) -> None:
    """Compute deferred event-summary representations for every pending
    event across ``sessions`` in ONE batched forward per feature shape."""
    work = []
    for sess in sessions:
        for ev, frames in sess._rep_pending:
            work.append((sess, ev, sess._event_summary_pack(frames)))
    if not work:
        return
    groups: Dict[Tuple[int, ...], List] = {}
    for item in work:
        key = tuple(r.shape[0] for r in item[2]["rows"])
        groups.setdefault(key, []).append(item)
    for items in groups.values():
        sess0 = items[0][0]
        dev = sess0.device
        K_real = len(items)
        # pow-2 batch bucket; pad rows carry one real token (pos 0) so
        # the forward stays NaN-free; their reps are discarded
        K = 1 << (K_real - 1).bit_length()
        L = StreamingSession._bucket(
            max(len(it[2]["ids"]) for it in items), 256)
        n_img_p = StreamingSession._bucket(
            max(max(len(it[2]["img"]) for it in items), 1), 128)
        ids_pad = np.zeros((K, L), np.int32)
        pos = np.full((K, L), -1, np.int32)
        pos[K_real:, 0] = 0
        img_pad = np.full((K, n_img_p), L, np.int64)   # scratch row
        sel_pad = np.zeros((K, n_img_p), np.int64)
        feats = []
        for i, (_, _, p) in enumerate(items):
            n = len(p["ids"])
            ids_pad[i, :n] = p["ids"]
            pos[i, :n] = np.arange(n)
            img_pad[i, :len(p["img"])] = p["img"]
            sel_pad[i, :len(p["sel"])] = p["sel"]
            feats.append(torch.cat(p["rows"], dim=0))
        for _ in range(K - K_real):
            feats.append(torch.zeros_like(feats[0]))
        reps = _event_summary_batch_device(
            sess0.model.text, torch.from_numpy(ids_pad).to(dev),
            torch.from_numpy(img_pad).to(dev),
            torch.from_numpy(sel_pad).to(dev), torch.stack(feats),
            torch.from_numpy(pos).to(dev))
        for i, (_, ev, _) in enumerate(items):
            ev.rep = reps[i]
    for sess in sessions:
        sess._rep_pending = []


@dataclass
class SlotRange:
    kind: str        # "system" | "stream" | "shadow" | "question" | "answer"
    start: int
    end: int                  # exclusive
    turn: int = -1            # QA turn index for question/answer ranges


@dataclass
class PendingFrame:
    """An ingested frame awaiting its event window to close."""
    frame_id: int
    timestamp: float
    feat: np.ndarray            # [H] pooled feature (event machinery)
    img_slots: np.ndarray       # cache slots of this frame's <image> tokens
    shadow_slot: int            # cache slot of the pooled shadow token
    frame_rows: torch.Tensor    # [merged, H] fixed-shape feature rows
    n_kept: int                 # how many of frame_rows are real


@dataclass
class EventRecord:
    frame_ids: List[int]
    rep: Optional[torch.Tensor] = None      # [H] summary representation
    frame_slots: List[np.ndarray] = field(default_factory=list)
    shadow_slots: List[int] = field(default_factory=list)
    keyframe_mask: List[bool] = field(default_factory=list)
    rep_host: Optional[np.ndarray] = None   # host mirror, filled lazily


class StreamingSession:
    """One dialogue stream over one growing video. Batch size 1; the
    model's device (``model.text``) holds the cache and runs every
    forward."""

    # No single prefill carries more tokens than this; longer sequences
    # split into chunk prefills (exact: each chunk attends back to the
    # previous ones through the position-tagged cache).
    max_prefill_chunk: int = 16384

    def __init__(self, model: CogReasoner, cfg: CogReasonerConfig, tokenizer,
                 adapters: Optional[Dict[str, Dict]] = None,
                 max_len: int = 16384, rng_seed: int = 0,
                 system_prompt: str = SYSTEM_PROMPT):
        if cfg.text.w8a8_prefill:
            raise NotImplementedError("w8a8_prefill (the W8A8 prefill "
                                      "branch) is not ported yet (ROADMAP "
                                      "Queue 1 #4)")
        self.model = model
        self.cfg = cfg
        self.tok = tokenizer
        self.adapters = adapters or {}
        self.max_len = max_len
        self.device = model.text.device
        self.cache = init_kv_cache(cfg.text, 1, max_len,
                                   dtype=model.text.dtype,
                                   device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self.ranges: List[SlotRange] = []
        self.events: List[EventRecord] = []
        self.hist_qs: List[str] = []
        self.hist_as: List[str] = []
        self.next_pos = 0          # absolute RoPE position counter
        self.total_frames = 0
        self._pending_frames: List[PendingFrame] = []
        self._rep_pending: List[Tuple[EventRecord, List[PendingFrame]]] = []

        lang = self.adapters.get("language_module")
        self.selector = Selector(
            model.text, tokenizer,
            adapters=[(lang.get("text", lang), 1.0)] if lang else None)
        self._system_prompt = system_prompt
        ids = tokenizer.encode(
            f"<|im_start|>system\n{system_prompt}<|im_end|>\n")
        self._prefill_text(np.asarray(ids, np.int32), kind="system")

    # ------------------------------------------------------------------
    # cache plumbing
    # ------------------------------------------------------------------

    @property
    def write_index(self) -> int:
        return self.cache.write_index

    def _full_adapters(self):
        full = self.adapters.get("full_module")
        if full is None:
            return None
        return [(full.get("text", full), 1.0)]

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @staticmethod
    def _bucket(n: int, step: int = 32) -> int:
        return max(step, -(-n // step) * step)

    @staticmethod
    def kv_window_for(needed: int, max_len: int) -> Optional[int]:
        """Decode-read window: bucketed to 1024 slots (4096 past 16k
        depth), applied when it at least halves reads (or on deep
        caches)."""
        step = 1024 if needed <= 16384 else 4096
        W = StreamingSession._bucket(needed, step)
        if 2 * W <= max_len:
            return W
        if max_len > 16384 and W < max_len:
            return W
        return None

    def _kv_window(self, needed: int) -> Optional[int]:
        return self.kv_window_for(needed, self.max_len)

    def _prefill_embeds(self, embeds: torch.Tensor, kind: str,
                        turn: int = -1) -> SlotRange:
        """Write S tokens into the cache (bucketed to multiples of 32;
        padding slots carry position -1). Sequences longer than
        ``max_prefill_chunk`` split into full chunks plus one bucketed
        tail, so the real tokens stay slot-contiguous."""
        S = embeds.shape[0]
        start = self.write_index
        off = 0
        while off < S:
            n = min(self.max_prefill_chunk, S - off)
            self._prefill_one(embeds[off:off + n])
            off += n
        r = SlotRange(kind, start, start + S, turn)
        self.ranges.append(r)
        return r

    def _prefill_one(self, embeds: torch.Tensor) -> None:
        """One prefill: bucket, pad, forward, advance the position."""
        S = embeds.shape[0]
        Sp = self._bucket(S)
        start = self.write_index
        if start + Sp > self.max_len:
            raise RuntimeError(
                f"session cache overflow: {start}+{Sp} > {self.max_len}")
        if Sp > S:
            embeds = torch.cat([embeds, embeds.new_zeros((Sp - S,
                                                          embeds.shape[1]))])
        positions = np.full((1, Sp), -1, np.int32)
        positions[0, :S] = np.arange(self.next_pos, self.next_pos + S)
        qwen2.qwen2_forward(self.model.text, embeds[None],
                            self._dev(positions), self.cache,
                            self._full_adapters())
        self.next_pos += S

    @torch.inference_mode()
    def _prefill_text(self, ids: np.ndarray, kind: str,
                      turn: int = -1) -> SlotRange:
        emb = qwen2.embed(self.model.text, self._dev(ids))
        return self._prefill_embeds(emb, kind, turn)

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------

    def _segment_plan(self, keep_host: np.ndarray, t: int, merged: int,
                      timestamps: Sequence[float]) -> Dict:
        """Host half of segment ingest: template ids + scatter/gather
        index plan."""
        img_id = self.tok.image_token_id
        all_ids: List[np.ndarray] = []
        frame_img_offsets: List[np.ndarray] = []
        feat_rows: List[np.ndarray] = []
        offset = 0
        for fi in range(t):
            kept = np.nonzero(keep_host[fi])[0]
            stamp = f"Time {float(timestamps[fi]):.1f}s:"
            text = (f"<|im_start|>stream\n{stamp}"
                    + "<image>" * len(kept) + "<|im_end|>\n")
            ids = np.asarray(self.tok.encode(text), np.int32)
            img_pos = np.nonzero(ids == img_id)[0]
            all_ids.append(ids)
            frame_img_offsets.append(offset + img_pos)
            feat_rows.append(fi * merged + kept)
            offset += len(ids)
        seg_ids = np.concatenate(all_ids)
        frame_rows_idx = np.zeros((t, merged), np.int64)
        kept_counts = np.zeros((t,), np.int32)
        for fi in range(t):
            k = feat_rows[fi]
            frame_rows_idx[fi, :len(k)] = k
            kept_counts[fi] = len(k)
        return dict(
            t=t, merged=merged, n=len(seg_ids), seg_ids=seg_ids,
            frame_img_offsets=frame_img_offsets,
            flat_img=(np.concatenate(frame_img_offsets)
                      if frame_img_offsets else np.zeros((0,), np.int64)),
            flat_rows=(np.concatenate(feat_rows)
                       if feat_rows else np.zeros((0,), np.int64)),
            frame_rows_idx=frame_rows_idx, kept_counts=kept_counts,
            timestamps=[float(x) for x in timestamps])

    def _pack_plan(self, plan: Dict, Sp: int, n_img_p: int) -> Dict:
        """Pad a plan to the buckets. Layout: [segment (n)][shadow pooled
        tokens (t)][pad]. Pads: ids → 0, scatter targets → scratch row
        Sp, positions → -1."""
        n, t = plan["n"], plan["t"]
        ids_pad = np.zeros((Sp,), np.int32)
        ids_pad[:n] = plan["seg_ids"]
        n_img = len(plan["flat_img"])
        img_pad = np.full((n_img_p,), Sp, np.int64)
        img_pad[:n_img] = plan["flat_img"]
        rows_pad = np.zeros((n_img_p,), np.int64)
        rows_pad[:n_img] = plan["flat_rows"]
        positions = np.concatenate([
            np.arange(self.next_pos, self.next_pos + n + t, dtype=np.int32),
            np.full((Sp - n - t,), -1, np.int32)])
        return dict(ids_pad=ids_pad, img_pad=img_pad, rows_pad=rows_pad,
                    shadow_idx=n + np.arange(t), positions=positions,
                    frame_rows_idx=plan["frame_rows_idx"])

    def _commit_segment(self, plan: Dict, start: int,
                        frame_feats: np.ndarray,
                        frame_rows_all: torch.Tensor) -> None:
        """Host bookkeeping after the device prefill: ranges, pending
        frames, event sealing."""
        n, t = plan["n"], plan["t"]
        self.next_pos += n + t
        r = SlotRange("stream", start, start + n)
        self.ranges.append(r)
        self.ranges.append(SlotRange("shadow", start + n, start + n + t))
        for fi in range(t):
            frame_id = self.total_frames
            self.total_frames += 1
            self._pending_frames.append(PendingFrame(
                frame_id, plan["timestamps"][fi], frame_feats[fi],
                r.start + plan["frame_img_offsets"][fi], start + n + fi,
                frame_rows_all[fi], int(plan["kept_counts"][fi])))
            if len(self._pending_frames) >= \
                    self.cfg.compression.frames_per_event:
                self._close_event()

    def ingest_keep_mask(self, pixel_values: np.ndarray,
                         grid_size: Tuple[int, int, int],
                         merge_size: int) -> np.ndarray:
        """The segment's pixel-diff keep mask (pure host numpy)."""
        t, gh, gw = (int(x) for x in grid_size)
        cc = self.cfg.compression
        merged = (gh // merge_size) * (gw // merge_size)
        return pixel_diff_keep_mask_host(
            pixel_values, t, merged, minor=np.zeros((t,), bool),
            threshold=cc.pixel_diff_threshold,
            min_tokens=cc.min_tokens_per_frame,
            image_std=tuple(self.cfg.vision.image_std),
            rescale_factor=self.cfg.vision.rescale_factor)

    @torch.inference_mode()
    def append_stream_segment(self, pixel_values: np.ndarray,
                              grid_size: Tuple[int, int, int],
                              merge_size: int,
                              timestamps: Sequence[float]) -> None:
        """Encode + compress + prefill one video segment (stream role),
        as ONE prefill of every frame's template ids with the kept visual
        rows spliced in."""
        t, gh, gw = (int(x) for x in grid_size)
        if t != len(timestamps):
            raise ValueError(f"{t} frames but {len(timestamps)} timestamps")
        merged = (gh // merge_size) * (gw // merge_size)
        rows = t * gh * gw
        pad_rows = -(-rows // 1024) * 1024   # bucket the encode shape
        mm = encode_images(self.model, pixel_values, np.array([[t, gh, gw]]),
                           np.array([merge_size]), pad_to=pad_rows)
        keep = self.ingest_keep_mask(pixel_values, (t, gh, gw), merge_size)
        plan = self._segment_plan(keep, t, merged, timestamps)
        Sp = self._bucket(plan["n"] + t)
        n_img_p = self._bucket(max(len(plan["flat_img"]), 1), 128)
        self.evict_for(Sp)
        start = self.write_index
        if start + Sp > self.max_len:
            raise RuntimeError(
                f"session cache overflow: {start}+{Sp} > {self.max_len}")
        packed = self._pack_plan(plan, Sp, n_img_p)
        self.cache, frame_feats, frame_rows_all = _ingest_device_step(
            self.model.text, self._full_adapters(), self.cache, mm,
            self._dev(packed["ids_pad"]), self._dev(packed["img_pad"]),
            self._dev(packed["rows_pad"]), self._dev(packed["shadow_idx"]),
            self._dev(packed["positions"]),
            self._dev(self._ingest_allowed())[None],
            self._dev(packed["frame_rows_idx"]), t, merged)
        self._commit_segment(plan, start, frame_feats.cpu().numpy(),
                             frame_rows_all)
        flush_event_reps([self])

    def _ingest_allowed(self) -> np.ndarray:
        """Visibility for ingest prefills: everything except shadow
        slots (pooled duplicates never enter full-res attention)."""
        allowed = np.ones((self.max_len,), bool)
        for r in self.ranges:
            if r.kind == "shadow":
                allowed[r.start:r.end] = False
        return allowed

    def _close_event(self) -> None:
        """Seal a frames_per_event window: pick keyframes (nearest the
        mean feature) and queue the event's summary forward (run by
        ``flush_event_reps`` at the end of the ingest)."""
        frames = self._pending_frames
        self._pending_frames = []
        feats = np.stack([f.feat for f in frames])
        center = feats.mean(axis=0)
        d = np.linalg.norm(feats - center, axis=1)
        kf = set(np.argsort(d)[:self.cfg.compression.keyframes_per_event]
                 .tolist())
        ev = EventRecord(frame_ids=[f.frame_id for f in frames])
        ev.frame_slots = [f.img_slots for f in frames]
        ev.shadow_slots = [f.shadow_slot for f in frames]
        ev.keyframe_mask = [i in kf for i in range(len(frames))]
        self._rep_pending.append((ev, frames))
        self.events.append(ev)

    def _event_summary_pack(self, frames) -> Dict:
        """Host half of one event's summary prompt: ids + splice plan
        over the event's kept visual rows."""
        parts = ["<|im_start|>system\n" + SUMMARY_SYSTEM + "<|im_end|>\n"
                 "<|im_start|>user\n"]
        rows = []
        sel_idx = []
        for j, f in enumerate(frames):
            parts.append(f"Time {f.timestamp:.1f}s:" + "<image>" * f.n_kept
                         + ("," if j < len(frames) - 1 else ""))
            rows.append(f.frame_rows)
            sel_idx.append(j * f.frame_rows.shape[0] + np.arange(f.n_kept))
        parts.append("\n" + SUMMARY_INSTRUCTION + "<|im_end|>\n"
                     "<|im_start|>assistant")
        ids = np.asarray(self.tok.encode("".join(parts)), np.int32)
        img_positions = np.nonzero(ids == self.tok.image_token_id)[0]
        sel = np.concatenate(sel_idx) if sel_idx else np.zeros(0, np.int64)
        return dict(ids=ids, img=img_positions, sel=sel, rows=rows)

    # ------------------------------------------------------------------
    # compaction — long-stream endurance
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def compact(self, keep_range) -> int:
        """Compact the cache to the ranges ``keep_range`` selects (one
        gather moves surviving slots to the front; absolute positions are
        preserved). Returns the new live-slot count."""
        kept = [r for r in self.ranges if r.kind == "system"
                or keep_range(r)]
        perm = (np.concatenate([np.arange(r.start, r.end) for r in kept])
                if kept else np.zeros((0,), np.int64))
        n_new = len(perm)
        old2new = np.full((self.max_len,), -1, np.int64)
        old2new[perm] = np.arange(n_new)
        idx = np.zeros((self.max_len,), np.int64)
        idx[:n_new] = perm
        gidx = self._dev(idx)
        c = self.cache
        pos = c.pos.index_select(1, gidx)
        pos[:, n_new:] = -1
        self.cache = KVCache(c.k.index_select(2, gidx),
                             c.v.index_select(2, gidx), pos, n_new)

        new_ranges: List[SlotRange] = []
        off = 0
        for r in kept:
            n = r.end - r.start
            new_ranges.append(SlotRange(r.kind, off, off + n, r.turn))
            off += n
        self.ranges = new_ranges

        remapped_events: List[EventRecord] = []
        for ev in self.events:
            new_fs = [old2new[np.asarray(s)] for s in ev.frame_slots]
            new_sh = [int(old2new[s]) for s in ev.shadow_slots]
            if (any((a < 0).any() for a in new_fs if a.size)
                    or any(s < 0 for s in new_sh)):
                continue   # its segment was evicted
            ev.frame_slots = new_fs
            ev.shadow_slots = new_sh
            remapped_events.append(ev)
        self.events = remapped_events

        remapped_pending = []
        for f in self._pending_frames:
            new_slots = old2new[np.asarray(f.img_slots)]
            new_shadow = int(old2new[f.shadow_slot])
            if (new_slots.size and (new_slots < 0).any()) or new_shadow < 0:
                continue
            f.img_slots = new_slots
            f.shadow_slot = new_shadow
            remapped_pending.append(f)
        self._pending_frames = remapped_pending
        return n_new

    def evict_for(self, needed: int) -> bool:
        """Make room for ``needed`` new slots by evicting the OLDEST
        stream segments (with their shadow ranges) and whole QA turns;
        the system prompt always survives. True when a compaction ran."""
        if self.write_index + needed <= self.max_len:
            return False
        live = [r for r in self.ranges if r.kind != "system"]
        sizes = {id(r): r.end - r.start for r in live}
        must_free = self.write_index + needed - self.max_len
        dropped: set = set()
        freed = self.write_index - sum(r.end - r.start for r in self.ranges)
        for i, r in enumerate(live):
            if freed >= must_free:
                break
            if id(r) in dropped:
                continue
            dropped.add(id(r))
            freed += sizes[id(r)]
            if (r.kind == "stream" and i + 1 < len(live)
                    and live[i + 1].kind == "shadow"):
                nxt = live[i + 1]
                dropped.add(id(nxt))
                freed += sizes[id(nxt)]
            if r.kind == "question":
                for other in live[i + 1:]:
                    if other.kind == "answer" and other.turn == r.turn:
                        if id(other) not in dropped:
                            dropped.add(id(other))
                            freed += sizes[id(other)]
                        break
        self.compact(lambda r: id(r) not in dropped)
        return True

    # ------------------------------------------------------------------
    # ask
    # ------------------------------------------------------------------

    def _question_rep(self, question_ids: np.ndarray) -> torch.Tensor:
        n = len(question_ids)
        Sp = self._bucket(n)
        ids = np.zeros((Sp,), np.int32)
        ids[:n] = question_ids
        q_pos = np.concatenate([np.arange(n, dtype=np.int32),
                                np.full((Sp - n,), -1, np.int32)])[None]
        return _question_rep_device(self.model.text, self._dev(ids),
                                    self._dev(q_pos))

    def _allowed_mask(self, if_visual: bool, selected_turns: Sequence[int],
                      question_ids: np.ndarray) -> np.ndarray:
        allowed = np.zeros((self.max_len,), bool)
        allowed[self.write_index:] = True               # future slots
        sel = set(selected_turns)
        for r in self.ranges:
            if r.kind == "system":
                allowed[r.start:r.end] = True
            elif r.kind == "stream":
                allowed[r.start:r.end] = if_visual
            elif r.kind == "shadow":
                allowed[r.start:r.end] = False   # pooled duplicates
            elif r.kind in ("question", "answer") and r.turn in sel:
                allowed[r.start:r.end] = True

        cc = self.cfg.compression
        if (if_visual and self.events
                and len(self.events) >= cc.min_events_for_compression):
            # question-aware event pruning: events below the similarity
            # threshold keep their keyframes at full resolution; every
            # other frame collapses to its pooled SHADOW slot
            q = self._question_rep(question_ids).cpu().numpy()
            uncached = [e for e in self.events if e.rep_host is None]
            if uncached:
                fetched = torch.stack([e.rep for e in uncached]).cpu().numpy()
                for e, r in zip(uncached, fetched):
                    e.rep_host = r
            reps = np.stack([e.rep_host for e in self.events])
            sim = reps @ q / (np.linalg.norm(reps, axis=1)
                              * np.linalg.norm(q) + 1e-8)
            for e, s in zip(self.events, sim):
                if s < cc.similarity_threshold:
                    for is_key, slots, shadow in zip(
                            e.keyframe_mask, e.frame_slots, e.shadow_slots):
                        allowed[slots] = is_key
                        allowed[shadow] = not is_key
        return allowed

    @torch.inference_mode()
    def ask(self, question: str, mode: str = "FCC",
            max_new_tokens: int = 512, temperature: float = 0.0,
            top_p: float = 1.0, top_k: int = 0,
            repetition_penalty: float = 1.0,
            extra_eos_ids: tuple = ()) -> Dict:
        turn = len(self.hist_qs)
        question_ids = np.asarray(self.tok.encode(question), np.int32)
        if mode == "FCC" and self.hist_qs:
            selection = self.selector.select(question, self.hist_qs,
                                             self.hist_as,
                                             generator=self._gen)
            if_visual, sel_idx = parse_selection(selection)
        elif mode == "NC":
            selection, if_visual, sel_idx = "[yes]", True, []
        else:  # AC / first turn: everything visible
            selection, if_visual = "[yes]", True
            sel_idx = list(range(turn))

        q_text = (f"<|im_start|>user\n{question}<|im_end|>\n"
                  f"<|im_start|>assistant\n")
        q_ids = np.asarray(self.tok.encode(q_text), np.int32)
        S = len(q_ids)
        Sp = self._bucket(S)
        # evict BEFORE building the visibility mask (compaction moves slots)
        self.evict_for(Sp + max_new_tokens)
        allowed = self._allowed_mask(if_visual, sel_idx, question_ids)
        start = self.write_index
        if start + Sp + max_new_tokens > self.max_len:
            raise RuntimeError("session cache overflow")
        ids_pad = np.zeros((Sp,), np.int32)
        ids_pad[:S] = q_ids
        emb = qwen2.embed(self.model.text, self._dev(ids_pad))[None]
        positions = np.full((1, Sp), -1, np.int32)
        positions[0, :S] = np.arange(self.next_pos, self.next_pos + S)
        penalty_ids = None
        if repetition_penalty != 1.0:
            penalty_ids = self._dev(np.where(np.arange(Sp) < S, ids_pad,
                                             -1)[None])
        result = generate_tokens(
            self.model.text, emb, self._dev(positions),
            self._dev(np.asarray([S - 1], np.int32)), self.cache, self._gen,
            max_new_tokens, self.tok.eos_token_id, temperature=temperature,
            top_p=top_p, top_k=top_k, repetition_penalty=repetition_penalty,
            penalty_ids=penalty_ids, adapters=self._full_adapters(),
            kv_allowed=self._dev(allowed)[None],
            kv_window=self._kv_window(start + Sp + max_new_tokens),
            extra_eos_ids=tuple(extra_eos_ids) or None)
        self.cache = result.cache
        tokens, num = result.tokens.cpu(), result.num_tokens.cpu()
        n_fed = max(0, int(num[0]) - 1)
        text = decode_new_tokens(tokens, num, self.tok)
        # answer slots = tokens fed back through the cache (the terminal
        # token never re-enters): prompt bucket + fed tokens
        ans_start = start + Sp
        if self.write_index != ans_start + n_fed:
            raise RuntimeError("cache write index out of step with the "
                               "answer length")
        self.ranges.append(SlotRange("question", start, start + S, turn))
        self.ranges.append(SlotRange("answer", ans_start, self.write_index,
                                     turn))
        self.next_pos += S + n_fed
        self.hist_qs.append(question)
        self.hist_as.append(text)
        return {"text": text, "selection": selection,
                "if_visual": if_visual, "turn": turn,
                "cache_tokens": self.write_index,
                "tokens": tokens[0, :int(num[0])].tolist()}
