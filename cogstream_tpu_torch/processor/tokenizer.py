"""Tokenizers and selector token sets.

Copies of ``ByteTokenizer``, ``HFTokenizer``, ``load_tokenizer``,
``constrained_selector_token_ids`` and ``selector_stop_token_ids`` from
``cogstream_tpu/processor/tokenizer.py`` (importing that module would
import JAX through the package ``__init__``). tests/test_torch_host.py
holds them to the originals. ``HFTokenizer`` imports ``transformers``
only when it is built: a checkpoint without tokenizer files takes the
byte-level fallback, which needs nothing.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

IM_START = "<|im_start|>"
IM_END = "<|im_end|>"
STREAM_START = "<|stream_start|>"
STREAM_END = "<|stream_end|>"
IMAGE_TOKEN = "<image>"


class ByteTokenizer:
    """Byte-level tokenizer with CogStream's special tokens.

    Layout: ids 0..15 reserved (0=pad, 1=bos, 2=eos/<|im_end|>,
    3=<|im_start|>, 4=<|stream_start|>, 5=<|stream_end|>); bytes map to
    16..271; the image token id is configurable.
    """

    PAD_ID = 0
    BOS_ID = 1
    EOS_ID = 2

    def __init__(self, image_token_id: int = 1000, vocab: int = 1024):
        self._specials: Dict[str, int] = {
            IM_START: 3,
            IM_END: 2,
            STREAM_START: 4,
            STREAM_END: 5,
            IMAGE_TOKEN: image_token_id,
        }
        self._inv = {v: k for k, v in self._specials.items()}
        self.eos_token_id = 2
        self.bos_token_id = 1
        self.pad_token_id = 0
        self.image_token_id = image_token_id
        self._vocab = vocab

    def vocab_size(self) -> int:
        return self._vocab

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        i = 0
        specials = sorted(self._specials, key=len, reverse=True)
        while i < len(text):
            for sp in specials:
                if text.startswith(sp, i):
                    ids.append(self._specials[sp])
                    i += len(sp)
                    break
            else:
                ids.extend(b + 16 for b in text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = False) -> str:
        out: List[str] = []
        buf: List[int] = []

        def flush():
            if buf:
                out.append(bytes(buf).decode("utf-8", errors="replace"))
                buf.clear()

        for tid in ids:
            tid = int(tid)
            if tid in self._inv:
                flush()
                if not skip_special_tokens:
                    out.append(self._inv[tid])
            elif 16 <= tid < 272:
                buf.append(tid - 16)
            else:
                flush()  # unknown/reserved id: drop
        flush()
        return "".join(out)

    def convert_tokens_to_ids(self, token: str) -> int:
        if token in self._specials:
            return self._specials[token]
        ids = self.encode(token)
        if len(ids) != 1:
            raise ValueError(f"{token!r} is not a single token")
        return ids[0]


class HFTokenizer:
    """Wraps a HuggingFace Qwen2 tokenizer directory (vocab/merges
    JSONs), loaded at run time from a checkpoint path."""

    def __init__(self, path: str, image_token: str = IMAGE_TOKEN):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, use_fast=True)
        self.eos_token_id = self._tok.eos_token_id
        self.pad_token_id = self._tok.pad_token_id or self._tok.eos_token_id
        self.bos_token_id = self._tok.bos_token_id
        self.image_token_id = self._tok.convert_tokens_to_ids(image_token)

    def vocab_size(self) -> int:
        return len(self._tok)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = False) -> str:
        return self._tok.decode(list(ids),
                                skip_special_tokens=skip_special_tokens)

    def convert_tokens_to_ids(self, token: str) -> int:
        return self._tok.convert_tokens_to_ids(token)


def load_tokenizer(path: str, image_token_id: Optional[int] = None,
                   vocab_size: Optional[int] = None):
    """The checkpoint directory's tokenizer: the HF fast tokenizer when
    the directory ships vocab files (every real Qwen2 checkpoint does),
    else ``ByteTokenizer`` with the config's image-token id and vocab
    size (the small checkpoints ``save_cogreasoner_to_hf`` writes)."""
    if any(os.path.exists(os.path.join(path, f))
           for f in ("tokenizer.json", "vocab.json",
                     "tokenizer_config.json")):
        return HFTokenizer(path)
    kwargs = {}
    if image_token_id is not None:
        kwargs["image_token_id"] = image_token_id
    if vocab_size is not None:
        kwargs["vocab"] = vocab_size
    print(f"[cogstream] {path} ships no tokenizer files; "
          "using the byte-level fallback tokenizer")
    return ByteTokenizer(**kwargs)


def constrained_selector_token_ids(tok) -> List[int]:
    """Token ids allowed during historic-dialogue-retrieval decoding:
    digits, brackets, comma, yes/no and the end token."""
    allowed = set()
    pieces = [str(i) for i in range(10)] + ["[", "]", ",", "no", "yes"]
    for p in pieces:
        allowed.update(tok.encode(p))
    allowed.add(tok.eos_token_id)
    try:
        allowed.add(tok.convert_tokens_to_ids(IM_END))
    except Exception:
        pass
    return sorted(a for a in allowed if a is not None and a >= 0)


def selector_stop_token_ids(tok) -> List[int]:
    """Token ids that complete a bracketed selection (``]``, im_end)."""
    stops = set(tok.encode("]"))
    try:
        stops.add(tok.convert_tokens_to_ids(IM_END))
    except Exception:
        pass
    return sorted(s for s in stops if s is not None and s >= 0)
