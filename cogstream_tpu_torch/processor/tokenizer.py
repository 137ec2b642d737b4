"""Byte-level tokenizer and selector token sets.

Copies of ``ByteTokenizer``, ``constrained_selector_token_ids`` and
``selector_stop_token_ids`` from ``cogstream_tpu/processor/tokenizer.py``
(importing that module would import JAX through the package
``__init__``). tests/test_torch_host.py holds them to the originals.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

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
