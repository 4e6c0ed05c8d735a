"""Prompt + response formatting (reference ml/formatter.py, 550 LoC).

Covers the same surface: generation-arg normalization, chat templating
(native HF template when a tokenizer provides one, manual Qwen/Llama/generic
fallbacks), ``<think>``-block reasoning extraction, and the ResponseFormatter
producing OpenAI / simple / raw shapes for non-stream, SSE chunk, SSE final
with usage, and errors.
"""

from __future__ import annotations

import json
import re
import time
import uuid
from typing import Any

# ---------------------------------------------------------------------------
# Generation-argument normalization (reference formatter.py:7-116)
# ---------------------------------------------------------------------------


def normalize_generate_args(
    req: Any,  # GenerationRequest
    *,
    prompt_len: int,
    max_context: int,
) -> dict:
    """Clamp/clean sampling args against the model's context window
    (reference normalize_generate_args: pad/eos fixups, max_new_tokens
    clamping, sampling-param validation, formatter.py:7)."""
    room = max(max_context - prompt_len, 1)
    max_new = min(int(req.max_new_tokens), room)
    if req.max_length:
        max_new = min(max_new, max(int(req.max_length) - prompt_len, 1))
    temperature = float(req.temperature) if req.do_sample else 0.0
    if temperature < 1e-4:
        temperature = 0.0  # greedy
    top_p = min(max(float(req.top_p), 1e-3), 1.0)
    top_k = max(int(req.top_k), 0)
    return {
        "max_new_tokens": max_new,
        "temperature": temperature,
        "top_p": top_p,
        "top_k": top_k,
        # range-validated at parse time ([-2, 2] → 400), passed through
        # like temperature/top_p
        "presence_penalty": float(getattr(req, "presence_penalty", 0.0)),
        "frequency_penalty": float(getattr(req, "frequency_penalty", 0.0)),
    }


# ---------------------------------------------------------------------------
# Chat templating (reference formatter.py:161-323)
# ---------------------------------------------------------------------------


def format_chat_prompt(
    message: str,
    history: list[dict] | None = None,
    *,
    tokenizer: Any = None,
    model_name: str = "",
    system_prompt: str | None = None,
    enable_thinking: bool = False,
) -> str:
    """Render a chat exchange to a single prompt string.

    Prefers the tokenizer's native ``apply_chat_template`` (reference
    formatter.py:238-260); falls back to manual Qwen (ChatML) / Llama-3 /
    generic templates keyed off the model name (formatter.py:161-235).
    """
    msgs = list(history or [])
    if system_prompt and not any(m.get("role") == "system" for m in msgs):
        msgs.insert(0, {"role": "system", "content": system_prompt})
    msgs.append({"role": "user", "content": message})

    if tokenizer is not None and getattr(tokenizer, "chat_template", None):
        kw = {"tokenize": False, "add_generation_prompt": True}
        try:
            return tokenizer.apply_chat_template(
                msgs, enable_thinking=enable_thinking, **kw
            )
        except TypeError:  # template without thinking support
            return tokenizer.apply_chat_template(msgs, **kw)

    name = model_name.lower()
    if "qwen" in name or "chatml" in name:
        out = []
        for m in msgs:
            out.append(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>")
        out.append("<|im_start|>assistant")
        if not enable_thinking and "qwen3" in name:
            out.append("<think>\n\n</think>\n")
        return "\n".join(out) + "\n"
    if "llama-3" in name or "llama3" in name:
        out = ["<|begin_of_text|>"]
        for m in msgs:
            out.append(
                f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
                f"{m['content']}<|eot_id|>"
            )
        out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        return "".join(out)
    # generic
    out = []
    for m in msgs:
        out.append(f"{m['role'].capitalize()}: {m['content']}")
    out.append("Assistant:")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Reasoning extraction (reference formatter.py:118-159)
# ---------------------------------------------------------------------------

_THINK_RE = re.compile(
    r"<(think|thinking|reasoning|reflection)>(.*?)</\1>\s*",
    re.DOTALL | re.IGNORECASE,
)


def extract_reasoning_and_answer(text: str) -> tuple[str, str]:
    """Split ``<think>``-family blocks from the visible answer. Returns
    ``(reasoning, answer)``; reasoning is "" when no block is present. An
    unterminated block (stream cut mid-thought) counts as all reasoning."""
    blocks = _THINK_RE.findall(text)
    if blocks:
        reasoning = "\n".join(b[1].strip() for b in blocks)
        answer = _THINK_RE.sub("", text).strip()
        return reasoning, answer
    m = re.match(r"\s*<(think|thinking|reasoning)>(.*)", text, re.DOTALL | re.IGNORECASE)
    if m:
        return m.group(2).strip(), ""
    return "", text.strip()


class StopStream:
    """Streaming stop-sequence filter with OpenAI earliest-START semantics.

    The subtlety: with overlapping stops (e.g. ``["X", "bXY"]`` on
    ``"abXY…"``) the first COMPLETED match ("X") is not necessarily the
    earliest-STARTING one ("bXY") — cutting eagerly would emit different
    text than the non-stream path's ``min(find(s))`` truncation. So the
    filter never emits past the earliest position where any stop could
    still start (exact prefix check), and only cuts once no earlier
    candidate remains open. ``flush()`` resolves pending prefixes at end of
    stream (an unfinished prefix is NOT a match)."""

    def __init__(self, stops: list[str], emit):
        self.stops = list(stops)
        self.emit = emit
        self.hold = ""
        self.stopped = False

    def _earliest_open_prefix(self) -> int | None:
        for j in range(len(self.hold)):
            tail = self.hold[j:]
            if any(s.startswith(tail) and len(tail) < len(s)
                   for s in self.stops):
                return j
        return None

    def _scan(self, final: bool) -> None:
        if self.stopped:
            return
        hits = [i for i in (self.hold.find(s) for s in self.stops)
                if i != -1]
        best = min(hits) if hits else None
        pending = None if final else self._earliest_open_prefix()
        if best is not None and (pending is None or pending >= best):
            if best:
                self.emit(self.hold[:best])
            self.hold = ""
            self.stopped = True
            return
        boundary = pending if pending is not None else len(self.hold)
        if boundary:
            self.emit(self.hold[:boundary])
            self.hold = self.hold[boundary:]

    def feed(self, delta: str) -> None:
        if self.stopped or not delta:
            return
        self.hold += delta
        self._scan(final=False)

    def flush(self) -> None:
        self._scan(final=True)


class ThinkStripStream:
    """Incremental ``<think>`` stripper for SSE streams (reference strips
    think blocks in-stream, ml/validator.py:782-808). Feed decoded text
    pieces; emits only visible-answer text."""

    def __init__(self):
        self._buf = ""
        self._in_think = False
        self._done_think = False

    def feed(self, piece: str) -> str:
        self._buf += piece
        out = []
        while self._buf:
            if self._in_think:
                end = self._buf.find("</think>")
                if end < 0:
                    return "".join(out)  # still inside the block
                self._buf = self._buf[end + len("</think>"):]
                self._in_think = False
                self._done_think = True
                self._buf = self._buf.lstrip("\n")
                continue
            start = self._buf.find("<think>")
            if start < 0:
                # hold back a potential partial opening tag at the tail
                safe = len(self._buf)
                for k in range(1, min(len("<think>"), len(self._buf)) + 1):
                    if "<think>".startswith(self._buf[-k:]):
                        safe = len(self._buf) - k
                        break
                out.append(self._buf[:safe])
                self._buf = self._buf[safe:]
                return "".join(out)
            out.append(self._buf[:start])
            self._buf = self._buf[start + len("<think>"):]
            self._in_think = True
        return "".join(out)

    def flush(self) -> str:
        out, self._buf = ("" if self._in_think else self._buf), ""
        return out


# ---------------------------------------------------------------------------
# Response shapes (reference ResponseFormatter, formatter.py:327-550)
# ---------------------------------------------------------------------------


class ResponseFormatter:
    """OpenAI / simple / raw response shapes + SSE wire format."""

    def __init__(self, model: str, fmt: str = "simple"):
        self.model = model
        self.fmt = fmt
        self.id = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        self.created = int(time.time())

    def _usage(self, prompt_tokens: int, completion_tokens: int) -> dict:
        return {
            "prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens,
        }

    def complete(
        self,
        text: str,
        *,
        prompt_tokens: int = 0,
        completion_tokens: int = 0,
        reasoning: str = "",
        finish_reason: str = "stop",
        extra: dict | None = None,
    ) -> dict:
        """Non-stream final body (reference formatter.py:331-407).
        ``extra`` merges server-side annotations (e.g. ``num_beams_used``
        when the worker clamped a beam request) into the body top level."""
        if self.fmt == "openai":
            msg = {"role": "assistant", "content": text}
            if reasoning:
                msg["reasoning_content"] = reasoning
            body = {
                "id": self.id,
                "object": "chat.completion",
                "created": self.created,
                "model": self.model,
                "choices": [
                    {"index": 0, "message": msg, "finish_reason": finish_reason}
                ],
                "usage": self._usage(prompt_tokens, completion_tokens),
            }
        elif self.fmt == "raw":
            body = {"output": text, "reasoning": reasoning}
        else:
            body = {
                "response": text,
                "model": self.model,
                "usage": self._usage(prompt_tokens, completion_tokens),
            }
            if reasoning:
                body["reasoning"] = reasoning
        if extra:
            body.update(extra)
        return body

    def complete_multi(self, results: list[dict]) -> dict:
        """OpenAI ``n``-choice completion body: one choice per generated
        result dict ({text, reasoning, finish_reason, prompt_tokens,
        completion_tokens}). Usage counts the prompt once (every choice
        shares it) and sums completions — OpenAI's convention."""
        choices = []
        for i, r in enumerate(results):
            msg = {"role": "assistant", "content": r["text"]}
            if r.get("reasoning"):
                msg["reasoning_content"] = r["reasoning"]
            choices.append(
                {"index": i, "message": msg,
                 "finish_reason": r.get("finish_reason", "stop")}
            )
        prompt = results[0]["prompt_tokens"] if results else 0
        return {
            "id": self.id,
            "object": "chat.completion",
            "created": self.created,
            "model": self.model,
            "choices": choices,
            "usage": self._usage(
                prompt, sum(r.get("completion_tokens", 0) for r in results)
            ),
        }

    def stream_chunk(self, delta_text: str) -> dict:
        """One SSE chunk (reference formatter.py:409-450)."""
        if self.fmt == "openai":
            return {
                "id": self.id,
                "object": "chat.completion.chunk",
                "created": self.created,
                "model": self.model,
                "choices": [
                    {"index": 0, "delta": {"content": delta_text},
                     "finish_reason": None}
                ],
            }
        return {"token": delta_text, "model": self.model}

    def stream_prelude(self, meta: dict) -> dict:
        """First SSE event of a stream, carrying the journal re-attach
        handle (``jrid``, docs/FAILURE_MODEL.md "Control plane") before
        any token — a client can only resume a crash-interrupted stream
        if it learned the jrid ahead of the crash. Shaped as an empty
        delta chunk so strict OpenAI stream parsers pass through it."""
        body = self.stream_chunk("")
        body.update(meta)
        return body

    def stream_final(
        self, *, prompt_tokens: int, completion_tokens: int,
        finish_reason: str = "stop", extra: dict | None = None,
    ) -> dict:
        """Final SSE chunk with usage (reference formatter.py:452-509).
        ``extra`` merges server-side annotations (e.g. ``jrid``) into the
        body top level, like :meth:`complete`."""
        if self.fmt == "openai":
            body = {
                "id": self.id,
                "object": "chat.completion.chunk",
                "created": self.created,
                "model": self.model,
                "choices": [
                    {"index": 0, "delta": {}, "finish_reason": finish_reason}
                ],
                "usage": self._usage(prompt_tokens, completion_tokens),
            }
        else:
            body = {
                "done": True,
                "model": self.model,
                "usage": self._usage(prompt_tokens, completion_tokens),
                "finish_reason": finish_reason,
            }
        if extra:
            body.update(extra)
        return body

    def error(self, message: str, *, status: int = 500, kind: str = "server_error") -> dict:
        """Error body (reference formatter.py:512-549)."""
        if self.fmt == "openai":
            return {"error": {"message": message, "type": kind, "code": status}}
        return {"error": message, "status": status}


def sse_event(data: dict | str) -> bytes:
    """Wire-encode one SSE event (``data: {...}\\n\\n``)."""
    if not isinstance(data, str):
        data = json.dumps(data, separators=(",", ":"))
    return f"data: {data}\n\n".encode()


SSE_DONE = b"data: [DONE]\n\n"
