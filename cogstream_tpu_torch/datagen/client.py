"""MLLM API client (C22) + offline fake for tests.

Host-only copy of ``cogstream_tpu/datagen/client.py`` (the port imports
nothing of the JAX package; tests/test_torch_host.py pins the copy's
code to the original).

Behavioral parity with tools/MLLMs.py: ``chat`` (text), ``vision``
(base64-encoded images), ``mix_chat`` (interleaved text/image turns),
retry-with-backoff, usage accounting, model fallback. The reference
ships with blank api_key/url (MLLMs.py:20-21) — here configuration is
explicit and a deterministic ``FakeMLLM`` exists so the whole pipeline
runs hermetically (the test backend the reference lacks, SURVEY.md §4).
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Union


def _b64_image(image) -> str:
    if isinstance(image, (bytes, bytearray)):
        return base64.b64encode(bytes(image)).decode()
    if isinstance(image, str) and os.path.exists(image):
        with open(image, "rb") as f:
            return base64.b64encode(f.read()).decode()
    raise ValueError("image must be raw bytes or a file path")


class MLLMClient:
    """OpenAI-compatible multimodal chat client.

    Transport: the ``openai`` SDK when installed, else a stdlib
    ``urllib`` POST speaking the same ``/chat/completions`` wire format
    — neither the test image nor the card's machine ships an openai
    package, and the reference's own
    judge clients were MISSING from its repo entirely
    (eval_1_IA.py:4-5), so the client must not depend on an optional
    SDK to function. Retry/backoff/fallback/usage logic is transport-
    independent (``_call``) and covered offline by a local HTTP stub
    (tests/test_judge_http.py)."""

    def __init__(self, model: str, api_key: Optional[str] = None,
                 base_url: Optional[str] = None, max_retries: int = 5,
                 fallback_model: Optional[str] = None,
                 temperature: float = 0.7,
                 backoff: Optional[callable] = None):
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
        self.base_url = (base_url or os.environ.get("OPENAI_BASE_URL")
                         or "https://api.openai.com/v1").rstrip("/")
        try:
            from openai import OpenAI  # gated import

            self.client = OpenAI(api_key=self.api_key,
                                 base_url=self.base_url)
        except ImportError:
            self.client = None         # stdlib urllib transport
        self.model = model
        self.fallback_model = fallback_model
        self.max_retries = max_retries
        self.temperature = temperature
        self.prompt_tokens = 0
        self.completion_tokens = 0
        self._backoff = backoff or time.sleep

    def _request(self, messages: List[Dict], model: str) -> str:
        """One transport round trip; raises on any failure."""
        if self.client is not None:
            r = self.client.chat.completions.create(
                model=model, messages=messages,
                temperature=self.temperature)
            if r.usage:
                self.prompt_tokens += r.usage.prompt_tokens or 0
                self.completion_tokens += r.usage.completion_tokens or 0
            return r.choices[0].message.content or ""
        import urllib.request

        body = json.dumps({"model": model, "messages": messages,
                           "temperature": self.temperature}).encode()
        req = urllib.request.Request(
            f"{self.base_url}/chat/completions", data=body,
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {self.api_key}"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            data = json.loads(resp.read().decode())
        usage = data.get("usage") or {}
        self.prompt_tokens += usage.get("prompt_tokens") or 0
        self.completion_tokens += usage.get("completion_tokens") or 0
        return (data["choices"][0]["message"].get("content")
                or "")

    def _call(self, messages: List[Dict]) -> str:
        model = self.model
        for attempt in range(self.max_retries):
            try:
                return self._request(messages, model)
            except Exception:
                if attempt == self.max_retries - 1:
                    raise
                if self.fallback_model and attempt >= self.max_retries // 2:
                    model = self.fallback_model
                self._backoff(min(2 ** attempt, 20))
        return ""

    def chat(self, prompt: str, system: Optional[str] = None) -> str:
        msgs = []
        if system:
            msgs.append({"role": "system", "content": system})
        msgs.append({"role": "user", "content": prompt})
        return self._call(msgs)

    def vision(self, prompt: str, images: Sequence) -> str:
        content: List[Dict] = [{"type": "text", "text": prompt}]
        for img in images:
            content.append({"type": "image_url", "image_url": {
                "url": f"data:image/jpeg;base64,{_b64_image(img)}"}})
        return self._call([{"role": "user", "content": content}])

    def mix_chat(self, parts: Sequence[Union[str, Dict]]) -> str:
        """parts: strings and {"image": path_or_bytes} dicts, in order."""
        content: List[Dict] = []
        for p in parts:
            if isinstance(p, str):
                content.append({"type": "text", "text": p})
            else:
                content.append({"type": "image_url", "image_url": {
                    "url": "data:image/jpeg;base64,"
                           + _b64_image(p["image"])}})
        return self._call([{"role": "user", "content": content}])


class FakeMLLM:
    """Deterministic offline MLLM: answers derive from a prompt hash.
    Understands the pipeline's JSON-output requests well enough to emit
    schema-valid QA lists / scores, so C19-C23 run end-to-end in tests."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.calls = 0

    def _h(self, text: str) -> int:
        return int(hashlib.sha1(f"{self.seed}|{text}".encode())
                   .hexdigest(), 16)

    def chat(self, prompt: str, system: Optional[str] = None) -> str:
        return self._respond(prompt)

    def vision(self, prompt: str, images: Sequence) -> str:
        return self._respond(prompt + f" [{len(images)} images]")

    def mix_chat(self, parts) -> str:
        text = " ".join(p for p in parts if isinstance(p, str))
        return self._respond(text)

    def _respond(self, prompt: str) -> str:
        self.calls += 1
        h = self._h(prompt)
        low = prompt.lower()
        if "json" in low and ("qa" in low or "question" in low):
            k = 2 + h % 2
            if "co-reference](qa<k>)" in low:
                qas = [{"Q": f"[Co-reference](QA{i + 1}) generated "
                             f"follow-up {h % 97}-{i}?",
                        "A": f"generated answer {h % 89}-{i}."}
                       for i in range(k)]
            elif "bracketed label" in low:
                tags = ("Attributes", "Items", "Actions",
                        "Temporal Perception")
                qas = [{"Q": f"[{tags[(h + i) % 4]}] generated question "
                             f"{h % 97}-{i}?",
                        "A": f"generated answer {h % 89}-{i}."}
                       for i in range(k)]
            else:
                qas = [{"Q": f"generated question {h % 97}-{i}?",
                        "A": f"generated answer {h % 89}-{i}."}
                       for i in range(k)]
            return json.dumps(qas)
        if "score" in low or "dependency" in low:
            return str(h % 8)            # 0-7 relevance scale
        if "summar" in low:
            return f"summary of events (hash {h % 1000})."
        return f"response {h % 10000}."
