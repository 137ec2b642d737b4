"""Streaming session with cross-turn KV reuse — port of
``cogstream_tpu/runtime/session.py`` (solo and pooled sessions).

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

A session bound to a :class:`~cogstream_tpu_torch.runtime.pool.SessionPool`
(``pool=``, ``row=``) owns no cache: every prefill, decode and compaction
addresses its row of the pool's shared cache in place (``cache_rows`` /
``write_slots``; K3 and K4 read the row through their ``rows``
operand), and its fill level is its own host int ``_wi``, which packs
the row tightly (padding slots are dropped, never written).

``save`` / ``load_state`` snapshot a session into one ``.npz`` in the JAX
package's layout, so a JAX snapshot restores into the port.

``mesh=`` (parallel/mesh.Mesh) serves tensor-parallel: every rank builds
the session with the same arguments and makes the same calls; the model is
sharded once (``parallel/sharding.ensure_cogreasoner_sharded``), the
adapters sliced with it (``shard_adapters``), the cache holds the rank's kv
heads, and every host decision reads values that are the same on every
rank. A sharded session's snapshot is the solo one: the first rank of the
model group gathers every kv head and alone writes the file, and on
``load_state`` alone reads it and sends each rank its kv heads and the
rest of the state (no disk shared by the ranks is assumed). A solo session
on a mesh with a ``data`` axis is replicated over the data groups (as in
JAX): rank 0 (data index 0, model index 0) alone writes and reads its
file, hands the whole cache to the other groups' first ranks, and an error
is agreed over the whole world. A pool row keeps its data group's first
rank.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CogReasonerConfig
from ..models import qwen2
from ..models.cogreasoner import (SUMMARY_INSTRUCTION, SUMMARY_SYSTEM,
                                  CogReasoner, encode_images,
                                  pixel_diff_keep_mask, with_int8_tower,
                                  with_serving_flags)
from ..models.qwen2 import (KVCache, Qwen2Model, init_kv_cache, kv_bytes,
                            local_kv_heads, to_cache)
from ..parallel.mesh import agree, broadcast_from_first, broadcast_object
from ..parallel.sharding import (ensure_cogreasoner_sharded,
                                 gather_kv_heads, scatter_kv_heads,
                                 shard_adapters, sharded_mesh)
from ..ops.kernels import KV_DTYPE_CODES
from ..ops.lm_attention import cache_rows
from .generate import (decode_new_tokens, generate_tokens,
                       generate_tokens_lookahead)
from .history import parse_selection
from .retrieval import Selector

SYSTEM_PROMPT = (
    "You are a helpful assistant watching a live video stream and "
    "answering the user's questions about it.")


def _ingest_device_step(text: Qwen2Model, adapters, cache: KVCache,
                        mm: torch.Tensor, ids_pad, img_pad, rows_pad,
                        shadow_idx, positions, kv_allowed, frame_rows_idx,
                        write_slots, rows, t: int, merged: int):
    """Device half of segment ingest for B rows (a session: B = 1; a
    pool's ``ingest_batch``: one segment per row, one prefill): embed the
    template ids, splice the kept visual rows (pads scatter into a
    scratch row), put each frame's pooled SHADOW embedding at its slot,
    prefill the cache, and return the per-frame features / rows the
    event machinery needs. ``mm`` is the feature table of one vision
    encode; row i's features occupy rows [i*t*merged, (i+1)*t*merged).
    ``kv_allowed`` hides earlier shadow slots from this prefill."""
    B = ids_pad.shape[0]
    emb = qwen2.embed(text, ids_pad)                             # [B,Sp,H]
    emb = torch.cat([emb, emb.new_zeros((B, 1, emb.shape[-1]))], dim=1)
    bi = torch.arange(B, device=emb.device)[:, None]
    emb[bi, img_pad] = mm[rows_pad].to(emb.dtype)
    pooled = mm[: B * t * merged].reshape(B, t, merged, -1).mean(dim=2)
    emb[bi, shadow_idx] = pooled.to(emb.dtype)
    emb = emb[:, :-1]
    _, cache = qwen2.qwen2_forward(text, emb, positions, cache, adapters,
                                   kv_allowed=kv_allowed,
                                   write_slots=write_slots, cache_rows=rows)
    frame_rows_all = mm[frame_rows_idx.reshape(-1)].reshape(B, t, merged, -1)
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


def _compact_row_device(cache: KVCache, gidx: torch.Tensor, n_new: int,
                        row: int) -> None:
    """Pooled compaction: move row ``row``'s surviving slots (``gidx``,
    ascending) to the front of the row IN PLACE on the shared pool
    cache (an fp8 cache as its bytes); slots past ``n_new`` become empty
    (pos -1)."""
    for c in (kv_bytes(cache.k), kv_bytes(cache.v)):
        c[:, row, :n_new] = c[:, row].index_select(1, gidx)
    cache.pos[row, :n_new] = cache.pos[row].index_select(0, gidx)
    cache.pos[row, n_new:] = -1


def check_kv_dtype(kv_dtype, model_dtype: torch.dtype) -> torch.dtype:
    """The dtype of a session's or pool's KV cache: the model's (``None``)
    or any float dtype K3 / K4 read (``ops.kernels.KV_DTYPE_CODES``: the
    fp8 caches e4m3 / e5m2, f16, f32 under a bf16 model, bf16 under an
    f32 one; JAX's ``init_kv_cache`` takes any). Another dtype (an
    integer one, float64) raises ``TypeError``."""
    if kv_dtype is None:
        return model_dtype
    if kv_dtype not in KV_DTYPE_CODES:
        raise TypeError(f"kv_dtype {kv_dtype} is no KV cache dtype: it "
                        "takes one of "
                        + ", ".join(map(str, KV_DTYPE_CODES)))
    return kv_dtype


class StreamingSession:
    """One dialogue stream over one growing video. Batch size 1; the
    model's device (``model.text``) holds the cache and runs every
    forward. With ``pool``/``row`` the session lives in one row of the
    pool's shared cache (runtime/pool.py)."""

    # No single prefill carries more tokens than this; longer sequences
    # split into chunk prefills (exact: each chunk attends back to the
    # previous ones through the position-tagged cache).
    max_prefill_chunk: int = 16384

    def __init__(self, model: CogReasoner, cfg: CogReasonerConfig, tokenizer,
                 adapters: Optional[Dict[str, Dict]] = None,
                 max_len: int = 16384, rng_seed: int = 0,
                 system_prompt: str = SYSTEM_PROMPT,
                 summary_forward: bool = True, kv_dtype=None,
                 pool=None, row: Optional[int] = None,
                 encoder_int8: bool = False, mesh=None):
        kv_dtype = check_kv_dtype(kv_dtype, model.text.dtype)
        # mesh: this rank's shard of the model (idempotent); the decoder
        # runs under cfg's serving flags, as the JAX session's does;
        # encoder_int8: the W8A8 vision tower for ingest, the session's own
        # int8 copy (the model's tower is left as it is)
        model = ensure_cogreasoner_sharded(model, cfg, mesh)
        # the adapters follow the model's shards (a pool's or server's
        # sessions get the sharded model without a mesh)
        adapters = shard_adapters(adapters, cfg, sharded_mesh(model))
        model = with_serving_flags(model, cfg)
        if encoder_int8:
            model = with_int8_tower(model)
        self.model = model
        self.cfg = cfg
        self.tok = tokenizer
        self.adapters = adapters or {}
        self.max_len = max_len
        self.device = model.text.device
        # per-event summary LM forward at ingest (True: reps in hidden
        # space; False: feature-space centroids)
        self.summary_forward = summary_forward
        self._pool, self._row = pool, row
        self._rows = None
        if pool is None:
            self._own_cache = init_kv_cache(
                cfg.text, 1, max_len, dtype=kv_dtype, device=self.device,
                kv_heads=local_kv_heads(model.text))
        else:
            if row is None or max_len != pool.max_len:
                raise ValueError("a pooled session needs its row and the "
                                 "pool's max_len")
            self._rows = cache_rows([row], self.device)
            # clear any previous tenant's slots on this row
            pool.cache.pos[row] = -1
        self._wi = 0               # pooled fill level (host int)
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        # verify forwards of the last lookahead ask (a host int)
        self.last_lookahead_steps: Optional[int] = None
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
    def cache(self) -> KVCache:
        """Solo: the session's own 1-row cache. Pooled: the pool's shared
        cache (one storage; assignments write it back)."""
        return self._own_cache if self._pool is None else self._pool.cache

    @cache.setter
    def cache(self, c: KVCache) -> None:
        if self._pool is None:
            self._own_cache = c
        else:
            self._pool.cache = c

    def _row_slots(self, start: int, n_real: int,
                   n_total: int) -> Optional[np.ndarray]:
        """Pooled write_slots of a prefill at ``start``: real tokens pack
        tightly, padding slots drop (never written)."""
        if self._pool is None:
            return None
        slots = np.full((1, n_total), self.max_len, np.int64)
        slots[0, :n_real] = start + np.arange(n_real)
        return slots

    @property
    def write_index(self) -> int:
        """The fill level: the solo cache's host write index, or the
        pooled row's own ``_wi``."""
        return self.cache.write_index if self._pool is None else self._wi

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
                            self._full_adapters(),
                            write_slots=self._row_slots(start, S, Sp),
                            cache_rows=self._rows)
        self.next_pos += S
        self._wi = start + S      # pooled rows pack tightly

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

    def _pack_plan(self, plan: Dict, Sp: int, n_img_p: int,
                   row_offset: int = 0) -> Dict:
        """Pad a plan to the buckets. Layout: [segment (n)][shadow pooled
        tokens (t)][pad]. ``row_offset`` shifts feature-row indices into
        a batch-global feature table. Pads: ids → 0, scatter targets →
        scratch row Sp, positions → -1."""
        n, t = plan["n"], plan["t"]
        ids_pad = np.zeros((Sp,), np.int32)
        ids_pad[:n] = plan["seg_ids"]
        n_img = len(plan["flat_img"])
        img_pad = np.full((n_img_p,), Sp, np.int64)
        img_pad[:n_img] = plan["flat_img"]
        rows_pad = np.full((n_img_p,), row_offset, np.int64)
        rows_pad[:n_img] = plan["flat_rows"] + row_offset
        positions = np.concatenate([
            np.arange(self.next_pos, self.next_pos + n + t, dtype=np.int32),
            np.full((Sp - n - t,), -1, np.int32)])
        return dict(ids_pad=ids_pad, img_pad=img_pad, rows_pad=rows_pad,
                    shadow_idx=n + np.arange(t), positions=positions,
                    frame_rows_idx=plan["frame_rows_idx"] + row_offset)

    def _commit_segment(self, plan: Dict, start: int,
                        frame_feats: np.ndarray,
                        frame_rows_all: torch.Tensor) -> None:
        """Host bookkeeping after the device prefill: ranges, pending
        frames, event sealing."""
        n, t = plan["n"], plan["t"]
        self.next_pos += n + t
        self._wi = start + n + t   # pooled rows pack tightly
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

    def ingest_keep_mask(self, pixel_values: torch.Tensor,
                         grid_size: Tuple[int, int, int],
                         merge_size: int) -> np.ndarray:
        """The segment's pixel-diff keep mask, computed on the rows'
        device and brought to the host for the segment plan."""
        t, gh, gw = (int(x) for x in grid_size)
        cc = self.cfg.compression
        merged = (gh // merge_size) * (gw // merge_size)
        return pixel_diff_keep_mask(
            pixel_values, t, merged,
            minor=torch.zeros((t,), dtype=torch.bool,
                              device=pixel_values.device),
            threshold=cc.pixel_diff_threshold,
            min_tokens=cc.min_tokens_per_frame,
            image_std=tuple(self.cfg.vision.image_std),
            rescale_factor=self.cfg.vision.rescale_factor).cpu().numpy()

    @torch.inference_mode()
    def append_stream_segment(self, pixel_values: np.ndarray,
                              grid_size: Tuple[int, int, int],
                              merge_size: int,
                              timestamps: Sequence[float],
                              pixel_values_device=None,
                              keep_mask: Optional[np.ndarray] = None
                              ) -> None:
        """Encode + compress + prefill one video segment (stream role),
        as ONE prefill of every frame's template ids with the kept visual
        rows spliced in. Serving's preprocess worker may pass the rows
        already uploaded (``pixel_values_device``) and their keep mask."""
        t, gh, gw = (int(x) for x in grid_size)
        if t != len(timestamps):
            raise ValueError(f"{t} frames but {len(timestamps)} timestamps")
        merged = (gh // merge_size) * (gw // merge_size)
        rows = t * gh * gw
        pad_rows = -(-rows // 1024) * 1024   # bucket the encode shape
        # one upload serves mask and tower
        pv = (self._dev(pixel_values) if pixel_values_device is None
              else pixel_values_device)
        # the mask first: its host sync then waits for no tower work
        keep = (keep_mask if keep_mask is not None
                else self.ingest_keep_mask(pv, (t, gh, gw), merge_size))
        mm = encode_images(self.model, pv, np.array([[t, gh, gw]]),
                           np.array([merge_size]), pad_to=pad_rows)
        plan = self._segment_plan(keep, t, merged, timestamps)
        Sp = self._bucket(plan["n"] + t)
        n_img_p = self._bucket(max(len(plan["flat_img"]), 1), 128)
        self.evict_for(Sp)
        start = self.write_index
        if start + Sp > self.max_len:
            raise RuntimeError(
                f"session cache overflow: {start}+{Sp} > {self.max_len}")
        packed = self._pack_plan(plan, Sp, n_img_p)
        dev = {k: self._dev(v)[None] for k, v in packed.items()}
        self.cache, frame_feats, frame_rows_all = _ingest_device_step(
            self.model.text, self._full_adapters(), self.cache, mm,
            dev["ids_pad"], dev["img_pad"], dev["rows_pad"],
            dev["shadow_idx"], dev["positions"],
            self._dev(self._ingest_allowed())[None], dev["frame_rows_idx"],
            self._row_slots(start, plan["n"] + t, Sp), self._rows, t, merged)
        self._commit_segment(plan, start, frame_feats[0].cpu().numpy(),
                             frame_rows_all[0])
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
        if self.summary_forward:
            # rep deferred: flush_event_reps batches every event sealed
            # by this ingest (a pool tick: the whole tick) in one forward
            self._rep_pending.append((ev, frames))
        else:
            ev.rep = torch.from_numpy(center.astype(np.float32)).to(
                self.device)
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
        if self._pool is not None:
            _compact_row_device(self.cache, self._dev(perm.astype(np.int64)),
                                n_new, self._row)
            self._wi = n_new
        else:
            idx = np.zeros((self.max_len,), np.int64)
            idx[:n_new] = perm
            gidx = self._dev(idx)
            c = self.cache
            pos = c.pos.index_select(1, gidx)
            pos[:, n_new:] = -1
            # an fp8 cache moves as its bytes (kv_bytes)
            k, v = (kv_bytes(t).index_select(2, gidx).view(t.dtype)
                    for t in (c.k, c.v))
            self.cache = KVCache(k, v, pos, n_new)

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

    def _select(self, question: str, mode: str, turn: int):
        """(selection, if_visual, selected turns) of one ask."""
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
        return selection, if_visual, sel_idx

    def _question_prompt(self, question: str):
        q_text = (f"<|im_start|>user\n{question}<|im_end|>\n"
                  f"<|im_start|>assistant\n")
        q_ids = np.asarray(self.tok.encode(q_text), np.int32)
        S = len(q_ids)
        Sp = self._bucket(S)
        ids_pad = np.zeros((Sp,), np.int32)
        ids_pad[:S] = q_ids
        positions = np.full((1, Sp), -1, np.int32)
        positions[0, :S] = np.arange(self.next_pos, self.next_pos + S)
        return ids_pad, positions, S, Sp

    @torch.inference_mode()
    def ask(self, question: str, mode: str = "FCC",
            max_new_tokens: int = 512, temperature: float = 0.0,
            top_p: float = 1.0, top_k: int = 0,
            repetition_penalty: float = 1.0, lookahead_k: int = 0,
            extra_eos_ids: tuple = ()) -> Dict:
        # prompt-lookup speculative decode (generate_tokens_lookahead) on
        # greedy solo turns only: sampling params or a pooled row take the
        # vanilla decoder silently, so callers may leave lookahead_k on.
        # Greedy draws nothing from the generator on either decoder.
        use_la = (lookahead_k > 0 and temperature == 0.0 and top_p == 1.0
                  and top_k == 0 and repetition_penalty == 1.0
                  and self._pool is None)
        la_pad = lookahead_k + 1 if use_la else 0
        turn = len(self.hist_qs)
        question_ids = np.asarray(self.tok.encode(question), np.int32)
        selection, if_visual, sel_idx = self._select(question, mode, turn)
        ids_pad, positions, S, Sp = self._question_prompt(question)
        # evict BEFORE building the visibility mask (compaction moves slots)
        self.evict_for(Sp + max_new_tokens + la_pad)
        allowed = self._allowed_mask(if_visual, sel_idx, question_ids)
        start = self.write_index
        if start + Sp + max_new_tokens + la_pad > self.max_len:
            raise RuntimeError("session cache overflow")
        emb = qwen2.embed(self.model.text, self._dev(ids_pad))[None]
        kv_window = self._kv_window(start + Sp + max_new_tokens + la_pad)
        if use_la:
            result = generate_tokens_lookahead(
                self.model.text, emb, self._dev(positions),
                self._dev(np.asarray([S - 1], np.int32)), self.cache,
                ids_pad[None], max_new_tokens, self.tok.eos_token_id,
                lookahead_k=lookahead_k, adapters=self._full_adapters(),
                kv_allowed=self._dev(allowed)[None], kv_window=kv_window,
                extra_eos_ids=tuple(extra_eos_ids) or None)
            self.last_lookahead_steps = result.steps
        else:
            penalty_ids = None
            if repetition_penalty != 1.0:
                penalty_ids = self._dev(np.where(np.arange(Sp) < S, ids_pad,
                                                 -1)[None])
            result = generate_tokens(
                self.model.text, emb, self._dev(positions),
                self._dev(np.asarray([S - 1], np.int32)), self.cache,
                self._gen, max_new_tokens, self.tok.eos_token_id,
                temperature=temperature, top_p=top_p, top_k=top_k,
                repetition_penalty=repetition_penalty,
                penalty_ids=penalty_ids, adapters=self._full_adapters(),
                kv_allowed=self._dev(allowed)[None],
                write_slots=self._row_slots(start, S, Sp),
                cache_rows=self._rows, kv_window=kv_window,
                extra_eos_ids=tuple(extra_eos_ids) or None)
        self.cache = result.cache
        tokens, num = result.tokens.cpu(), result.num_tokens.cpu()
        n_fed = max(0, int(num[0]) - 1)
        text = decode_new_tokens(tokens, num, self.tok)
        # answer slots = tokens fed back through the cache (the terminal
        # token never re-enters): solo, prompt bucket + fed tokens; pooled,
        # tight packing after the S real prompt tokens
        ans_start = start + (S if self._pool is not None else Sp)
        self._wi = ans_start + n_fed
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

    def ask_stream(self, question: str, mode: str = "FCC",
                   max_new_tokens: int = 512, chunk: int = 16,
                   temperature: float = 0.0, extra_eos_ids: tuple = ()):
        """Generator variant of ``ask``: yields text deltas as decode
        chunks complete. Each chunk is one prefill+decode whose 1-token
        "prompt" is the previous chunk's last sampled token, so the cache
        simply continues. Ends by yielding the final result dict (as
        ``ask``'s, without ``tokens``). Abandoning the generator commits
        what the cache already holds."""
        turn = len(self.hist_qs)
        question_ids = np.asarray(self.tok.encode(question), np.int32)
        with torch.inference_mode():
            selection, if_visual, sel_idx = self._select(question, mode,
                                                         turn)
            ids_pad, positions, S, Sp = self._question_prompt(question)
            self.evict_for(Sp + max_new_tokens)
            allowed = self._dev(self._allowed_mask(
                if_visual, sel_idx, question_ids))[None]
            emb = qwen2.embed(self.model.text, self._dev(ids_pad))[None]
        start = self.write_index
        if start + Sp + max_new_tokens > self.max_len:
            raise RuntimeError("session cache overflow")
        positions = self._dev(positions)
        last_index = self._dev(np.asarray([S - 1], np.int32))

        all_ids: List[int] = []
        emitted = ""
        produced = 0
        done = False
        wrote_any = False
        stride = S if self._pool is not None else Sp
        wi = start + stride
        write_slots = self._row_slots(start, S, Sp)
        kv_window = self._kv_window(start + Sp + max_new_tokens)
        next_pos = self.next_pos + S
        eos = self.tok.eos_token_id
        try:
            while produced < max_new_tokens and not done:
                n_chunk = min(chunk, max_new_tokens - produced)
                result = generate_tokens(
                    self.model.text, emb, positions, last_index, self.cache,
                    self._gen, n_chunk, eos, temperature=temperature,
                    adapters=self._full_adapters(), kv_allowed=allowed,
                    write_slots=write_slots, cache_rows=self._rows,
                    kv_window=kv_window,
                    extra_eos_ids=tuple(extra_eos_ids) or None)
                self.cache = result.cache
                wrote_any = True
                toks = result.tokens.cpu().numpy()[0]
                num = int(result.num_tokens.cpu()[0])
                chunk_ids = toks[:num].tolist()
                done = (bool(chunk_ids) and chunk_ids[-1] == eos) \
                    or num < n_chunk
                # the continuation feeds the last sampled token as prompt
                if chunk_ids and chunk_ids[-1] == eos:
                    chunk_ids = chunk_ids[:-1]
                all_ids.extend(chunk_ids)
                produced += num
                wi += max(0, num - 1)
                text_so_far = self.tok.decode(all_ids,
                                              skip_special_tokens=True)
                delta = text_so_far[len(emitted):]
                emitted = text_so_far
                if delta:
                    yield delta
                if not done and produced < max_new_tokens:
                    last_tok = int(toks[num - 1])
                    with torch.inference_mode():
                        emb = qwen2.embed(self.model.text, self._dev(
                            np.asarray([[last_tok]], np.int32)))
                    positions = self._dev(np.asarray(
                        [[next_pos + produced - 1]], np.int32))
                    last_index = self._dev(np.asarray([0], np.int32))
                    # the continuation's 1-token prompt takes the next
                    # slot (counted only when it runs)
                    write_slots = self._row_slots(wi, 1, 1)
                    wi += 1
        finally:
            # commit even when the consumer abandons the generator (an
            # HTTP client gone mid-stream): the cache already holds what
            # was generated, so the host state must say so. Nothing to
            # commit if the first chunk never wrote.
            if wrote_any:
                self._wi = wi
                self.ranges.append(SlotRange("question", start, start + S,
                                             turn))
                self.ranges.append(SlotRange("answer", start + stride, wi,
                                             turn))
                # positions advance by FED tokens only (the final sampled
                # token never re-enters the cache, as ask's n_fed)
                self.next_pos = next_pos + max(0, produced - 1)
                self.hist_qs.append(question)
                self.hist_as.append(emitted)
        yield {"text": emitted, "selection": selection,
               "if_visual": if_visual, "turn": turn,
               "cache_tokens": self.write_index}

    @torch.inference_mode()
    def reset(self) -> None:
        """Start a fresh dialogue stream on the same cache storage (the
        positions are cleared; old K/V bytes become unreachable)."""
        if self._pool is None:
            self.cache.pos.fill_(-1)
            self.cache.write_index = 0
        else:
            self.cache.pos[self._row] = -1
        self._wi = 0
        self.ranges = []
        self.events = []
        self.hist_qs, self.hist_as = [], []
        self.next_pos = 0
        self.total_frames = 0
        self._pending_frames = []
        self._rep_pending = []
        ids = self.tok.encode(
            f"<|im_start|>system\n{self._system_prompt}<|im_end|>\n")
        self._prefill_text(np.asarray(ids, np.int32), kind="system")

    # ------------------------------------------------------------------
    # persistence — serving restarts without losing live streams
    # ------------------------------------------------------------------

    def _mesh_group(self):
        """(mesh, model group, replicas) of a sharded session ((None, None,
        False) solo); ``replicas``: a session on a mesh with a ``data``
        axis that every data group holds a copy of (a solo session, or a
        row of a pool whose rows are not split)."""
        mesh = sharded_mesh(self.model)
        if mesh is None:
            return None, None, False
        split = self._pool is not None and self._pool.split
        return mesh, mesh.model_group, mesh.data > 1 and not split

    def save(self, path: str) -> None:
        """Snapshot this session (its cache row trimmed to the fill level
        and all host bookkeeping) into one atomic ``.npz`` in the JAX
        package's layout. The generator state goes under
        ``torch_rng_state``, and two words hashed from it under JAX's
        ``rng_key``, so a JAX session restores the snapshot too (the two
        packages' sampling streams differ anyway). The K/V keep the
        cache's dtype: an fp8 cache stores its bytes. Weights are not
        included.

        Sharded (every rank calls it): the model group's first rank
        gathers every kv head and writes the solo file; the other ranks
        write nothing. A failed write raises on every rank of the model
        group (``parallel.mesh.AgreedError``). A session replicated over
        data groups is written by rank 0 alone, its error agreed over the
        world."""
        mesh, group, replicas = self._mesh_group()
        agreed = mesh.host_group if replicas else group
        if self._rep_pending:
            raise RuntimeError("ingest left unflushed event reps")
        row = self._row if self._pool is not None else 0
        wi = self.write_index
        c = self.cache
        k, v = c.k[:, row, :wi], c.v[:, row, :wi]
        if group is not None:
            k = gather_kv_heads(k, self.cfg.text, mesh, dim=2)
            v = gather_kv_heads(v, self.cfg.text, mesh, dim=2)
        if k is None or (replicas and mesh.data_index != 0):
            agree(None, agreed)    # not the writer: it writes nothing
            return
        error = None
        try:
            self._write_snapshot(path, k, v, c.pos[row, :wi])
        except Exception as e:  # noqa: BLE001 — raised on every rank
            error = e
        agree(error, agreed)

    def _write_snapshot(self, path: str, k, v, pos) -> None:
        import hashlib

        from ..utils.io import atomic_write_npz, pack_array

        meta = {
            "version": 1,
            "max_len": self.max_len,
            "wi": self.write_index,
            "next_pos": self.next_pos,
            "total_frames": self.total_frames,
            "hist_qs": self.hist_qs,
            "hist_as": self.hist_as,
            "system_prompt": self._system_prompt,
            "ranges": [[r.kind, r.start, r.end, r.turn]
                       for r in self.ranges],
            "events": [{
                "frame_ids": ev.frame_ids,
                "frame_slots": [np.asarray(s).tolist()
                                for s in ev.frame_slots],
                "shadow_slots": list(ev.shadow_slots),
                "keyframe_mask": list(ev.keyframe_mask),
            } for ev in self.events],
            "pending": [{
                "frame_id": f.frame_id,
                "timestamp": f.timestamp,
                "img_slots": np.asarray(f.img_slots).tolist(),
                "shadow_slot": int(f.shadow_slot),
                "n_kept": int(f.n_kept),
            } for f in self._pending_frames],
        }
        arrays: Dict[str, np.ndarray] = {}
        dtypes: Dict[str, str] = {}

        def put(name, a):
            arrays[name], dtypes[name] = pack_array(a)

        put("k", k)
        put("v", v)
        put("pos", pos)
        state = self._gen.get_state()
        put("torch_rng_state", state)
        put("rng_key", np.frombuffer(hashlib.sha256(
            state.numpy().tobytes()).digest()[:8], np.uint32).copy())
        if self.events:
            # one device-to-host copy for all reps
            put("event_reps", torch.stack(
                [ev.rep.to(self.device, torch.float32)
                 for ev in self.events]).cpu())
        for i, f in enumerate(self._pending_frames):
            put(f"pend_feat_{i}", np.asarray(f.feat, np.float32))
            put(f"pend_rows_{i}", f.frame_rows)
        meta["dtypes"] = dtypes
        atomic_write_npz(path, meta=np.asarray(json.dumps(meta)), **arrays)

    def _read_snapshot(self, path: str) -> Dict:
        """A snapshot's meta and arrays (host), checked against this
        session: ``max_len`` must fit it and its K/V (every kv head) the
        model's cache."""
        from ..utils.io import unpack_array

        d = np.load(path)
        meta = json.loads(str(d["meta"]))
        wi = int(meta["wi"])
        if wi > self.max_len:
            raise ValueError(
                f"snapshot needs {wi} slots, session has {self.max_len}")
        dt = meta["dtypes"]
        arrays = {name: unpack_array(d[name], dt[name]) for name in dt}
        t = self.cfg.text
        c = self.cache
        want = (c.k.shape[0], wi, t.num_key_value_heads) + tuple(
            c.k.shape[4:])
        for name in ("k", "v"):
            if tuple(arrays[name].shape) != want:
                raise ValueError(f"snapshot K/V {tuple(arrays[name].shape)}"
                                 " do not fit this model's cache")
        if meta["events"] and "event_reps" not in arrays:
            raise KeyError("event_reps")
        for i in range(len(meta["pending"])):
            for name in (f"pend_feat_{i}", f"pend_rows_{i}"):
                if name not in arrays:
                    raise KeyError(name)
        return {"meta": meta, "arrays": arrays}

    @torch.inference_mode()
    def load_state(self, path: str) -> None:
        """Restore a ``save`` snapshot, the port's or the JAX package's,
        into this session (solo or a pool row). The session must share
        the snapshot's model, config and tokenizer; ``max_len`` must fit
        it. A JAX snapshot carries only ``rng_key``: the generator is
        then seeded from its two words. A snapshot that does not fit
        raises before the session changes.

        Sharded (every rank calls it): the model group's first rank reads
        the file and sends every rank the state and its kv heads, so every
        rank restores the same generator state; a snapshot that does not
        fit raises on every rank (``parallel.mesh.AgreedError``). A
        session replicated over data groups is read by rank 0 alone, which
        sends the whole cache to the other groups' first ranks and the
        state to every rank; an error is agreed over the world."""
        mesh, group, replicas = self._mesh_group()
        agreed = mesh.host_group if replicas else group
        # the first rank of its model group, and the reader
        first = group is None or mesh.model_index == 0
        reader = first and not (replicas and mesh.data_index != 0)
        snap, error = None, None
        if reader:
            try:
                snap = self._read_snapshot(path)
            except Exception as e:  # noqa: BLE001 — raised on every rank
                error = e
        agree(error, agreed)
        c = self.cache
        kv = {}
        if reader:
            # cast into the session's cache dtype, as JAX does: a bf16
            # snapshot loads into an fp8 session (saturating at the cache
            # dtype's largest value where JAX's cast gives NaN or inf,
            # ROADMAP Queue 3)
            for name, cache_t in (("k", c.k), ("v", c.v)):
                kv[name] = to_cache(torch.as_tensor(
                    snap["arrays"].pop(name)).to(self.device), cache_t.dtype)
        if agreed is not None:
            snap = broadcast_object(snap, agreed)
        wi = int(snap["meta"]["wi"])
        for name, cache_t in (("k", c.k), ("v", c.v)):
            if replicas and first:
                # rank 0's whole cache to the other data groups' first
                # ranks (the data group of model index 0)
                whole = cache_t.new_empty(
                    (cache_t.shape[0], wi, self.cfg.text.num_key_value_heads)
                    + tuple(cache_t.shape[4:]))
                kv[name] = broadcast_from_first(kv.get(name), whole,
                                                mesh.data_group)
            if group is not None:
                like = cache_t.new_empty((cache_t.shape[0], wi)
                                         + tuple(cache_t.shape[3:]))
                kv[name] = scatter_kv_heads(kv.get(name), like,
                                            self.cfg.text, mesh, dim=2)
        self._restore(snap["meta"], snap["arrays"], kv["k"], kv["v"])

    def _restore(self, meta: Dict, arrays: Dict, k: torch.Tensor,
                 v: torch.Tensor) -> None:
        """This session's state from a snapshot's meta and arrays and this
        rank's K/V (in the cache's dtype)."""
        def dev(a, dtype=None):
            return torch.as_tensor(a).to(self.device, dtype)

        wi = int(meta["wi"])
        c = self.cache
        row = self._row if self._pool is not None else 0
        c.k[:, row, :wi] = k
        c.v[:, row, :wi] = v
        c.pos[row] = -1
        c.pos[row, :wi] = dev(arrays["pos"], torch.int32)
        if self._pool is None:
            c.write_index = wi
        self._wi = wi
        self.next_pos = int(meta["next_pos"])
        self.total_frames = int(meta["total_frames"])
        self.hist_qs = list(meta["hist_qs"])
        self.hist_as = list(meta["hist_as"])
        self._system_prompt = meta["system_prompt"]
        if "torch_rng_state" in arrays:
            self._gen.set_state(torch.as_tensor(arrays["torch_rng_state"]))
        else:
            w = np.asarray(arrays["rng_key"]).reshape(-1).astype(np.uint64)
            self._gen.manual_seed(int(w[0]) << 32 | int(w[-1]))
        self.ranges = [SlotRange(k_, s_, e_, t_)
                       for k_, s_, e_, t_ in meta["ranges"]]
        reps = arrays.get("event_reps")
        self.events = [EventRecord(
            frame_ids=list(ev["frame_ids"]),
            rep=dev(reps[i], torch.float32),
            frame_slots=[np.asarray(s_, np.int64)
                         for s_ in ev["frame_slots"]],
            shadow_slots=list(ev["shadow_slots"]),
            keyframe_mask=list(ev["keyframe_mask"]))
            for i, ev in enumerate(meta["events"])]
        self._pending_frames = [
            PendingFrame(p["frame_id"], p["timestamp"],
                         np.asarray(arrays[f"pend_feat_{i}"], np.float32),
                         np.asarray(p["img_slots"], np.int64),
                         p["shadow_slot"],
                         dev(arrays[f"pend_rows_{i}"],
                             self.model.text.dtype),
                         p["n_kept"])
            for i, p in enumerate(meta["pending"])]
        self._rep_pending = []
