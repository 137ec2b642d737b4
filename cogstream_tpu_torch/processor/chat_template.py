"""Chat-template renderer.

A plain-Python implementation of the semantics of the reference Jinja
template (the reference checkpoint's `chat_template.json`): the custom
``stream`` role uses ``<|stream_start|>/<|stream_end|>`` delimiters,
video content expands to per-frame ``Time X.Xs:<image>`` stamps joined
by commas, image content to ``Time X.Xs: <image>`` lines.  Being plain
Python keeps the hot processing path free of a Jinja dependency and
makes the renderer unit-testable token by token.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_SYSTEM_PROMPT = (
    "You are VideoLLaMA3 created by Alibaba DAMO Academy, a helpful "
    "assistant to help people understand images and videos."
)

Conversation = List[Dict[str, Any]]


def _fmt_ts(ts: float) -> str:
    """Format a timestamp the way Jinja's ``round(1) | string`` does."""
    return str(round(float(ts), 1))


def _render_content_item(content: Any, image_token: str) -> str:
    if isinstance(content, str):
        return content
    if not isinstance(content, dict):
        raise TypeError(f"Unsupported content item: {content!r}")
    ctype = content.get("type")
    if ctype == "text" or "text" in content:
        return content["text"]
    if ctype == "image" or "image" in content:
        out = ""
        if "timestamp" in content:
            out += f"Time {_fmt_ts(content['timestamp'])}s: "
        return out + image_token + "\n"
    if ctype == "video" or "video" in content:
        num_frames = content["num_frames"]
        parts = []
        for i in range(num_frames):
            piece = ""
            if "timestamps" in content:
                piece += f"Time {_fmt_ts(content['timestamps'][i])}s:"
            if i < num_frames - 1:
                piece += image_token + ","
            else:
                piece += image_token + "\n"
            parts.append(piece)
        return "".join(parts)
    raise ValueError(f"Unknown content type: {ctype!r}")


def render_chat(
    conversation: Conversation,
    add_system_prompt: bool = False,
    add_generation_prompt: bool = False,
    image_token: str = DEFAULT_IMAGE_TOKEN,
    system_prompt: str = DEFAULT_SYSTEM_PROMPT,
) -> str:
    """Render a conversation to the model's serialized text form."""
    out: List[str] = []
    for idx, message in enumerate(conversation):
        role = message["role"]
        if add_system_prompt and idx == 0 and role != "system":
            out.append(f"<|im_start|>system\n{system_prompt}<|im_end|>\n")
        ident = "stream" if role == "stream" else "im"
        out.append(f"<|{ident}_start|>{role}\n")
        content = message["content"]
        if isinstance(content, str):
            out.append(content + f"<|{ident}_end|>\n")
        else:
            for item in content:
                out.append(_render_content_item(item, image_token))
            if ident == "stream":
                out.append(f"<|{ident}_end|>")
            else:
                out.append(f"<|{ident}_end|>\n")
    if add_generation_prompt:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


GENERATION_PROMPT = "<|im_start|>assistant\n"
