"""Selector output parsing, copied from ``cogstream_tpu/runtime/history.py``
(``parse_selection`` and ``selection_string``; the rest of that module
is the reference-parity rewrite path, not on the serving slice)."""

from __future__ import annotations

from typing import List, Tuple


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


def selection_string(if_visual: bool, indices) -> str:
    """Selection serialization ``[yes,0,5]``."""
    parts = ["yes" if if_visual else "no"] + [str(i) for i in indices]
    return "[" + ",".join(parts) + "]"
