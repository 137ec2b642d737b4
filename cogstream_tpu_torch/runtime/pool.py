"""Pooled multi-session serving: batched decode over shared cache rows
(port of ``cogstream_tpu/runtime/pool.py``).

Decode is weight-bound, so B sessions decoding together cost little more
than one: the weight reads amortize over the batch. The pool gives every
session a ROW of one shared ``[L, B_pool, max_len, Hkv, D]`` KV cache,
updated in place. Per-row slot writes (``write_slots``) let each row sit
at its own fill level, and one ``generate_tokens`` call answers many
sessions' questions at once (per-row ``kv_allowed`` masks, per-row eos).

Single storage: sessions bound to the pool own no cache. Every
per-session op (ingest prefill, compaction, solo ask) addresses its row
of the shared tensor through ``cache_rows``, which K3 and K4 read in
place (their ``rows`` operand), so no row is copied.

``mesh=`` (parallel/mesh.Mesh): the model is sharded on the ``model`` axis
and the rows split across the ``data`` groups when ``n_rows`` divides:
group ``d`` holds rows ``[d * n_rows / data, (d + 1) * n_rows / data)`` in
its cache and sessions, and runs only those rows of an ``ingest_batch`` /
``ask_batch``; the answers are then exchanged, so every rank returns every
row's result. Rows that do not divide are held by every group. The
adapters are sliced for the model axis (``shard_adapters``). A row's
snapshot (:meth:`SessionPool.save`, :meth:`SessionPool.open_restored`) is
written and read by the first rank of the model group of the data group
that holds the row (``StreamingSession.save`` / ``load_state``; a row every
group holds, by rank 0 alone); every rank calls both, and every rank
raises a failed one. :meth:`SessionPool.ask_stream` and
:meth:`SessionPool.row_state` give every rank what the holding group has.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CogReasonerConfig
from ..models import qwen2
from ..models.cogreasoner import (CogReasoner, encode_images,
                                  pixel_diff_keep_mask, with_int8_tower,
                                  with_serving_flags)
from ..models.qwen2 import init_kv_cache, local_kv_heads
from ..parallel.mesh import (DATA_AXIS, AgreedError, all_gather_objects,
                             portable)
from ..parallel.sharding import ensure_cogreasoner_sharded, shard_adapters
from .generate import generate_tokens
from .history import parse_selection
from .session import (SlotRange, StreamingSession, _ingest_device_step,
                      check_kv_dtype, flush_event_reps)


class SessionPool:
    def __init__(self, model: CogReasoner, cfg: CogReasonerConfig,
                 tokenizer, n_rows: int = 4, max_len: int = 8192,
                 adapters: Optional[Dict] = None,
                 summary_forward: bool = True, kv_dtype=None,
                 seed: int = 0, encoder_int8: bool = False, mesh=None):
        # the shared cache's dtype: the model's, or another (check_kv_dtype)
        kv_dtype = check_kv_dtype(kv_dtype, model.text.dtype)
        # mesh: this rank's shard of the model; cfg's serving flags;
        # encoder_int8: the pool (and every session on it) ingests through
        # its own W8A8 copy of the tower
        model = ensure_cogreasoner_sharded(model, cfg, mesh)
        adapters = shard_adapters(adapters, cfg, mesh)
        model = with_serving_flags(model, cfg)
        if encoder_int8:
            model = with_int8_tower(model)
        self.model = model
        self.cfg = cfg
        self.tok = tokenizer
        self.n_rows = n_rows
        self.max_len = max_len
        self.adapters = adapters or {}
        self.device = model.text.device
        # the pool's own generator for batched sampling: sampled batch
        # decodes are reproducible given the seed
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # the rows this rank's data group holds: [_row_lo, _row_lo + n)
        self.mesh = mesh
        d = 1 if mesh is None else mesh.shape[DATA_AXIS]
        # split rows: each data group holds its own (else every group
        # holds every row)
        self.split = d > 1 and n_rows % d == 0
        held = n_rows // d if self.split else n_rows
        self._row_lo = mesh.data_index * held if self.split else 0
        self._row_hi = self._row_lo + held
        self.cache = init_kv_cache(cfg.text, held, max_len,
                                   dtype=kv_dtype, device=self.device,
                                   kv_heads=local_kv_heads(model.text))
        # the open rows (all groups'), and the sessions of the held ones
        self._open: set = set()
        self.sessions: Dict[int, StreamingSession] = {}
        # per-row seed: rows sharing one seed would sample identical
        # streams; folding in the row keeps runs reproducible per (seed,
        # row) and independent across rows
        self._mk = lambda row: StreamingSession(
            model, cfg, tokenizer, adapters=self.adapters, max_len=max_len,
            summary_forward=summary_forward, pool=self,
            row=row - self._row_lo, rng_seed=(seed << 16) ^ (row + 1))

    # -- row plumbing --------------------------------------------------------

    def _free_row(self) -> int:
        for b in range(self.n_rows):
            if b not in self._open:
                return b
        full = RuntimeError("session pool full")
        # every rank of a mesh holds the same open rows: all raise it here
        raise full if self.mesh is None or self.mesh.size == 1 \
            else AgreedError(full)

    def holds(self, row: int) -> bool:
        """Whether this rank's data group holds ``row``."""
        return self._row_lo <= row < self._row_hi

    def _local_rows(self, rows):
        return [b - self._row_lo for b in rows]

    def _share(self, out: Dict[int, Dict]) -> Dict[int, Dict]:
        """Every group's row results, on every rank (split rows only)."""
        if not self.split:
            return out
        merged: Dict[int, Dict] = {}
        for part in all_gather_objects(out, self.mesh.host_group):
            merged.update(part)
        return merged

    def open(self) -> int:
        """Create a session on a free row and return the row id. The
        session clears the row's previous tenant and prefills its system
        prompt straight into it (on the group that holds the row)."""
        b = self._free_row()
        self._open.add(b)
        if self.holds(b):
            self.sessions[b] = self._mk(b)
        return b

    def close(self, row: int) -> None:
        self._open.discard(row)
        self.sessions.pop(row, None)

    def _row_call(self, row: int, method: str, *args):
        """``sessions[row].<method>(*args)`` on the group that holds
        ``row``; with split rows its failure is raised on every rank
        (as an ``AgreedError``)."""
        error = None
        try:
            if self.holds(row):
                getattr(self.sessions[row], method)(*args)
        except Exception as e:  # noqa: BLE001 — shared below
            if not self.split:
                raise
            error = e
        if self.split:
            errors = [e for e in all_gather_objects(
                portable(error), self.mesh.host_group) if e is not None]
            if errors:
                raise errors[0] if isinstance(errors[0], AgreedError) \
                    else AgreedError(errors[0])

    def save(self, row: int, path: str) -> None:
        """Snapshot ``row``'s session (``StreamingSession.save``)."""
        if row not in self._open:
            raise ValueError("unknown row")
        self._row_call(row, "save", path)

    def open_restored(self, path: str) -> int:
        """Open a session on a free row and restore a ``session.save``
        snapshot into it. A failed restore releases the row again (on
        every rank)."""
        b = self.open()
        try:
            self._row_call(b, "load_state", path)
        except Exception:
            self.close(b)
            raise
        return b

    # -- per-session ops (write the shared rows directly) --------------------

    def ingest(self, row: int, *args, **kwargs) -> None:
        if self.holds(row):
            self.sessions[row].append_stream_segment(*args, **kwargs)

    @torch.inference_mode()
    def ingest_batch(
        self,
        requests: Sequence[Tuple],   # (row, pixel_values, grid_size,
                                     #  merge_size, timestamps)
    ) -> None:
        """Ingest one segment into MANY rows with one batched vision
        encode and ONE LM prefill. All segments share (t, gh, gw,
        merge_size). Events sealed this tick summarize in one batched
        forward afterwards."""
        if not requests:
            return
        rows_req = [int(r[0]) for r in requests]
        if len(set(rows_req)) != len(rows_req):
            raise ValueError("duplicate rows")
        if any(b not in self._open for b in rows_req):
            raise ValueError("unknown row")
        t, gh, gw = (int(x) for x in requests[0][2])
        ms = int(requests[0][3])
        for r in requests:
            if tuple(int(x) for x in r[2]) != (t, gh, gw) \
                    or int(r[3]) != ms:
                raise ValueError(
                    "ingest_batch requires a uniform segment shape; "
                    "mixed shapes must go through ingest()")
            if t != len(r[4]):
                raise ValueError(f"{t} frames but {len(r[4])} timestamps")
        # this group's rows only
        requests = [r for r in requests if self.holds(int(r[0]))]
        if not requests:
            return
        rows_req = [int(r[0]) for r in requests]
        B = len(requests)
        merged = (gh // ms) * (gw // ms)
        cc = self.cfg.compression

        # one dtype: raw uint8 rows normalize on the card; a mixed batch
        # would promote raw rows into the float path unnormalized
        pix_items = [np.asarray(r[1]) for r in requests]
        if len({a.dtype for a in pix_items}) > 1:
            raise ValueError(
                "ingest_batch requires a uniform pixel dtype "
                f"(got {sorted({str(a.dtype) for a in pix_items})}); "
                "mix raw-uint8 and float callers via ingest()")
        pv = torch.from_numpy(np.ascontiguousarray(
            np.concatenate(pix_items, axis=0))).to(self.device)
        per = t * gh * gw
        keep_all = np.stack([pixel_diff_keep_mask(
            pv[i * per:(i + 1) * per], t, merged,
            minor=torch.zeros((t,), dtype=torch.bool, device=self.device),
            threshold=cc.pixel_diff_threshold,
            min_tokens=cc.min_tokens_per_frame,
            image_std=tuple(self.cfg.vision.image_std),
            rescale_factor=self.cfg.vision.rescale_factor).cpu().numpy()
            for i in range(B)])
        # K1 is varlen: the batch encodes at its own row count
        mm = encode_images(self.model, pv, np.array([[t, gh, gw]] * B),
                           np.array([ms] * B))

        plans, starts = [], []
        for i, (b, _, _, _, ts) in enumerate(requests):
            plans.append(self.sessions[b]._segment_plan(keep_all[i], t,
                                                        merged, ts))
        Sp = StreamingSession._bucket(max(p["n"] for p in plans) + t)
        n_img_p = max(max(len(p["flat_img"]) for p in plans), 1)

        packs = []
        for i, b in enumerate(rows_req):
            sess = self.sessions[b]
            sess.evict_for(Sp)
            start = sess.write_index
            if start + Sp > self.max_len:
                raise RuntimeError(
                    f"pool row {b} overflow: {start}+{Sp} > {self.max_len}")
            starts.append(start)
            packs.append(sess._pack_plan(plans[i], Sp, n_img_p,
                                         row_offset=i * t * merged))

        slots = np.full((B, Sp), self.max_len, np.int64)
        for i, (p, start) in enumerate(zip(plans, starts)):
            slots[i, :p["n"] + t] = start + np.arange(p["n"] + t)
        allowed = np.stack([self.sessions[b]._ingest_allowed()
                            for b in rows_req])

        def stack(key):
            return torch.from_numpy(np.stack([p[key] for p in packs])).to(
                self.device)

        sess0 = self.sessions[rows_req[0]]
        self.cache, frame_feats, frame_rows_all = _ingest_device_step(
            self.model.text, sess0._full_adapters(), self.cache, mm,
            stack("ids_pad"), stack("img_pad"), stack("rows_pad"),
            stack("shadow_idx"), stack("positions"),
            torch.from_numpy(allowed).to(self.device),
            stack("frame_rows_idx"), slots, self._local_rows(rows_req), t,
            merged)
        frame_feats = frame_feats.cpu().numpy()
        for i, (b, start, plan) in enumerate(zip(rows_req, starts, plans)):
            self.sessions[b]._commit_segment(plan, start, frame_feats[i],
                                             frame_rows_all[i])
        # every event sealed this tick summarizes in ONE batched forward
        flush_event_reps([self.sessions[b] for b in rows_req])

    def ask(self, row: int, question: str, **kwargs) -> Dict:
        """Solo ask (unbatched): the session's pooled path, on the group
        that holds the row; every rank returns the answer."""
        out = ({row: self.sessions[row].ask(question, **kwargs)}
               if self.holds(row) else {})
        return self._share(out)[row]

    def ask_stream(self, row: int, question: str, **kwargs):
        """The session's ``ask_stream`` on the group that holds ``row``,
        whose ranks yield its items as they come; with split rows every
        other rank yields them all once the stream ended (a failure is
        raised on every rank, as an ``AgreedError``)."""
        if not self.split:
            yield from self.sessions[row].ask_stream(question, **kwargs)
            return
        items, error = [], None
        if self.holds(row):
            try:
                for item in self.sessions[row].ask_stream(question,
                                                          **kwargs):
                    items.append(item)
                    yield item
            except Exception as e:  # noqa: BLE001 — shared below
                error = e
        shared = all_gather_objects((items, portable(error)),
                                    self.mesh.host_group)
        errors = [e for _, e in shared if e is not None]
        if errors:
            raise AgreedError(errors[0])
        if not self.holds(row):
            yield from max(shared, key=lambda part: len(part[0]))[0]

    def row_state(self, row: int) -> Dict:
        """``{"cache_tokens", "turns"}`` of ``row``'s session, on every
        rank (from the group that holds it)."""
        out = {}
        if self.holds(row):
            sess = self.sessions[row]
            out[row] = {"cache_tokens": sess.write_index,
                        "turns": len(sess.hist_qs)}
        return self._share(out)[row]

    # -- the batched path ----------------------------------------------------

    @torch.inference_mode()
    def ask_batch(
        self,
        requests: Sequence[Tuple[int, str]],       # (row, question)
        mode: str = "FCC",
        max_new_tokens: int = 256,
        temperature: float = 0.0,
        extra_eos_ids: tuple = (),
    ) -> Dict[int, Dict]:
        """Answer several sessions' questions in ONE prefill+decode over
        their rows (``cache_rows``, ascending). Selection (one batched
        constrained decode, ``Selector.select_batch``) and the visibility
        masks are built per row first."""
        reqs = dict(requests)
        if not reqs:
            return {}
        if any(r not in self._open for r in reqs):
            raise ValueError("unknown row")
        # this group's rows; the others' answers come from _share
        reqs = {b: q for b, q in reqs.items() if self.holds(b)}
        if not reqs:
            return self._share({})
        order = sorted(reqs)

        # batched FCC selection: one constrained decode for every row
        # with history
        selections: Dict[int, str] = {}
        fcc_rows = [b for b in order
                    if mode == "FCC" and self.sessions[b].hist_qs]
        if fcc_rows:
            s0 = self.sessions[fcc_rows[0]]
            sel_out = s0.selector.select_batch(
                [(reqs[b], self.sessions[b].hist_qs,
                  self.sessions[b].hist_as) for b in fcc_rows],
                generator=s0._gen)
            selections = dict(zip(fcc_rows, sel_out))

        metas: Dict[int, Dict] = {}
        Sp = 32
        for b in order:
            q = reqs[b]
            sess = self.sessions[b]
            if b in selections:
                selection = selections[b]
                if_visual, sel_idx = parse_selection(selection)
            elif mode == "NC":
                # no-context ablation: past turns invisible (as the
                # session's ask(mode="NC"))
                selection, if_visual, sel_idx = "[yes]", True, []
            else:  # AC / first turn: everything visible
                selection, if_visual = "[yes]", True
                sel_idx = list(range(len(sess.hist_qs)))
            q_text = (f"<|im_start|>user\n{q}<|im_end|>\n"
                      f"<|im_start|>assistant\n")
            q_ids = np.asarray(self.tok.encode(q_text), np.int32)
            Sp = max(Sp, StreamingSession._bucket(len(q_ids)))
            metas[b] = dict(q=q, q_ids=q_ids, selection=selection,
                            if_visual=if_visual, sel_idx=sel_idx)

        B = len(order)
        ids = np.zeros((B, Sp), np.int32)
        positions = np.full((B, Sp), -1, np.int32)
        slots = np.full((B, Sp), self.max_len, np.int64)  # drop by default
        last_index = np.zeros((B,), np.int32)
        allowed = np.zeros((B, self.max_len), bool)
        for i, b in enumerate(order):
            m, sess = metas[b], self.sessions[b]
            n = len(m["q_ids"])
            sess.evict_for(Sp + max_new_tokens)   # compacts the row in place
            start = sess.write_index
            if start + Sp + max_new_tokens > self.max_len:
                raise RuntimeError(
                    f"pool row {b} overflow: {start}+{Sp}"
                    f"+{max_new_tokens} > {self.max_len}")
            ids[i, :n] = m["q_ids"]
            positions[i, :n] = np.arange(sess.next_pos, sess.next_pos + n)
            slots[i, :n] = np.arange(start, start + n)
            last_index[i] = n - 1
            allowed[i] = sess._allowed_mask(
                m["if_visual"], m["sel_idx"],
                np.asarray(self.tok.encode(m["q"]), np.int32))
            m.update(start=start, n=n)

        dev = self.device
        emb = qwen2.embed(self.model.text, torch.from_numpy(ids).to(dev))
        # one adapter convention for the pool (session._full_adapters)
        adapters = self.sessions[order[0]]._full_adapters()
        # decode-read window: the deepest row's live extent, bucketed
        needed = max(m["start"] + Sp for m in metas.values()) \
            + max_new_tokens
        result = generate_tokens(
            self.model.text, emb, torch.from_numpy(positions).to(dev),
            torch.from_numpy(last_index).to(dev), self.cache, self._gen,
            max_new_tokens, self.tok.eos_token_id, temperature=temperature,
            adapters=adapters, kv_allowed=torch.from_numpy(allowed).to(dev),
            write_slots=slots, cache_rows=self._local_rows(order),
            kv_window=StreamingSession.kv_window_for(needed, self.max_len),
            extra_eos_ids=tuple(extra_eos_ids) or None)
        self.cache = result.cache

        out: Dict[int, Dict] = {}
        toks = result.tokens.cpu().numpy()     # one copy for the batch
        nums = result.num_tokens.cpu().numpy()
        for i, b in enumerate(order):
            m, sess = metas[b], self.sessions[b]
            ids_out = toks[i, :int(nums[i])].tolist()
            if ids_out and ids_out[-1] == self.tok.eos_token_id:
                ids_out = ids_out[:-1]
            text = self.tok.decode(ids_out, skip_special_tokens=True)
            n_fed = max(0, int(nums[i]) - 1)   # terminal token never cached
            # pooled prompts pack tightly: decode continues right after
            # the n real prompt tokens
            turn = len(sess.hist_qs)
            end = m["start"] + m["n"] + n_fed
            sess.ranges.append(SlotRange(
                "question", m["start"], m["start"] + m["n"], turn))
            sess.ranges.append(SlotRange(
                "answer", m["start"] + m["n"], end, turn))
            sess.next_pos += m["n"] + n_fed
            sess.hist_qs.append(m["q"])
            sess.hist_as.append(text)
            sess._wi = end
            out[b] = {"text": text, "selection": m["selection"],
                      "if_visual": m["if_visual"], "turn": turn,
                      "cache_tokens": end,
                      "tokens": toks[i, :int(nums[i])].tolist()}
        return self._share(out)
