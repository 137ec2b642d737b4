"""Selector output parsing and the historic-dialogue rewrite, copied
from ``cogstream_tpu/runtime/history.py``: ``parse_selection``,
``selection_string`` and ``rewrite_history`` (the re-prefilling
engine's prompt pruning; the streaming session masks cache slots
instead)."""

from __future__ import annotations

import re
from typing import List, Tuple

_TIME_BLOCK_COMMA = re.compile(r"Time \d+\.\d+s:(?:<image>)*,")
_TIME_BLOCK_NL = re.compile(r"Time \d+\.\d+s:(?:<image>)*\n")
_USER_VISUAL = re.compile(r"((?:(?:Time \d+\.\d+s:(?:<image>)*),?)*)\s*(.*)",
                          re.DOTALL)
_STREAM_BLOCK = re.compile(r"<\|stream_start\|>.*?<\|stream_end\|>\n?",
                           re.DOTALL)


def parse_selection(selection: str) -> Tuple[bool, List[int]]:
    """Parse the selector output ``[yes,0,5]`` → (if_visual, indices):
    a 'no' prefix clears the visual flag; non-integer fragments are
    skipped."""
    if_visual = True
    indices: List[int] = []
    parts = selection.strip().strip("[]").split(",")
    if parts and parts[0]:
        head = parts[0].strip()
        if head == "no":
            if_visual = False
            parts = parts[1:]
        elif head == "yes":
            parts = parts[1:]
    for part in parts:
        part = part.strip()
        if part:
            try:
                indices.append(int(part))
            except ValueError:
                continue
    return if_visual, indices


def rewrite_history(
    text: str,
    if_visual: bool,
    kept_qs: List[str],
    kept_as: List[str],
    current_question: str,
) -> str:
    """Prune the serialized conversation to the selected turns.

    Handles both visual placements: the reference embeds video inside
    ``user`` turns (its regexes below), while this framework's chat
    template gives video its own ``<|stream_start|>stream ...`` blocks
    — those are kept verbatim when ``if_visual`` and dropped otherwise.
    """
    if not if_visual:
        text = _TIME_BLOCK_COMMA.sub("", text)
        text = _TIME_BLOCK_NL.sub("", text)
        text = _STREAM_BLOCK.sub("", text)

    # lift stream blocks out so the im_start-based turn parser below
    # never sees them; reinsert each (in order) before the turn that
    # followed it in the original serialization
    stream_blocks: List[Tuple[int, str]] = []

    def _grab(m):
        stream_blocks.append((m.start(), m.group(0)))
        return "\x00"   # placeholder marking the boundary

    text = _STREAM_BLOCK.sub(_grab, text)
    pieces = text.split("\x00")
    # pieces[i] precedes stream_blocks[i]; re-render keeping order
    segments: List[Tuple[str, str]] = []   # (kind, payload)
    for i, piece in enumerate(pieces):
        for seg in piece.split("<|im_start|>")[1 if i == 0 else 0:] \
                if piece.strip() else []:
            if seg.strip():
                segments.append(("im", seg))
        if i < len(stream_blocks):
            segments.append(("stream", stream_blocks[i][1]))

    filtered: List[str] = []
    for kind, segment in segments:
        if kind == "stream":
            filtered.append(segment)
            continue
        role_content = segment.split("\n", 1)
        if len(role_content) != 2:
            continue
        role, content = role_content
        role = role.strip()
        content = content.split("<|im_end|>")[0].strip()

        if role == "system":
            filtered.append(f"<|im_start|>{role}\n{content}<|im_end|>\n")
            continue

        if role == "user":
            visual_content = ""
            question = content
            if if_visual:
                m = _USER_VISUAL.match(content)
                if m:
                    visual_content = m.group(1).rstrip(",").strip()
                    question = m.group(2).strip()
            if question == current_question or question in kept_qs:
                filtered.append(f"<|im_start|>{role}\n{content}<|im_end|>\n")
            elif if_visual and visual_content:
                filtered.append(f"<|im_start|>{role}\n{visual_content}")
            continue

        if role == "assistant":
            if content in kept_as:
                filtered.append(f"<|im_start|>{role}\n{content}<|im_end|>\n")

    filtered.append("<|im_start|>assistant\n")

    # merge orphan user blocks into the preceding unterminated segment
    # (stream blocks terminate with <|stream_end|> — not orphans)
    cleaned: List[str] = []
    for i, segment in enumerate(filtered):
        if segment.startswith("<|im_start|>user\n"):
            prev = filtered[i - 1].rstrip() if i else ""
            if i == 0 or not (prev.endswith("<|im_end|>")
                              or prev.endswith("<|stream_end|>")):
                body = segment[len("<|im_start|>user\n"):]
                if body.strip():
                    cleaned.append(body)
                continue
        cleaned.append(segment)
    return "".join(cleaned)


def selection_string(if_visual: bool, indices) -> str:
    """Selection serialization ``[yes,0,5]``."""
    parts = ["yes" if if_visual else "no"] + [str(i) for i in indices]
    return "[" + ",".join(parts) + "]"
