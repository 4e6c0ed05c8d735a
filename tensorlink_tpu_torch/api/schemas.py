"""Request/response schemas (reference api/models.py, pydantic).

Dataclasses + explicit validation: the environment has no pydantic, and the
validation the API actually needs is small (types, ranges, enums). Unlike the
reference's ``GenerationRequest`` — which is mutated in-flight with
``output``/``processing``/``cancelled`` fields as it rides through the
pipeline (api/models.py:17-57) — these are immutable inputs; pipeline state
lives in :class:`~tensorlink_tpu_torch.api.server.PendingRequest`.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class ValidationError(ValueError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValidationError(msg)


@dataclass(frozen=True)
class GenerationRequest:
    """POST /v1/generate body (reference api/models.py:17)."""

    hf_name: str
    message: str = ""
    history: list[dict] = field(default_factory=list)  # [{role, content}]
    max_length: int | None = None
    max_new_tokens: int = 256
    temperature: float = 0.6
    top_p: float = 0.95
    top_k: int = 0
    do_sample: bool = True
    # OpenAI repetition control, APPLIED in the compiled sampler
    # (engine/sampling.py; the reference declares these, api/models.py:73-74,
    # but never uses them). Single-stage jobs only.
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    stream: bool = False
    output_format: str = "simple"  # "simple" | "openai" | "raw"
    enable_thinking: bool = False
    # opt-in speculative decode (prompt-lookup drafting; greedy B=1 —
    # engine/generate.py::generate_lookahead). Emits exactly the vanilla
    # greedy tokens, so honoring it is always safe; ignored when sampling.
    lookahead: bool = False
    # opt-in CONTINUOUS speculative decoding (engine/continuous.py,
    # docs/SERVING.md "Speculative decoding"): the request's decode slot
    # packs prompt-lookup drafts as extra ragged rows and the one
    # compiled step verifies them in-program — works under any sampling,
    # emits the bit-identical stream either way, and is a no-op unless
    # the hosting replica runs MLConfig.spec_decode (see /healthz
    # serving_modes). A pure speed hint, like lookahead.
    speculative: bool = False
    # opt-OUT of the disaggregated prefill→decode handoff (docs/SERVING.md
    # "Disaggregated prefill/decode"): on a pool with prefill/decode
    # worker roles a continuous request prefills on a prefill-pool worker
    # and is handed to a decode-pool worker at the prefill boundary —
    # bit-identical either way, so the default is opted in; false pins
    # the stream to the admission worker (debugging, latency-probing a
    # specific replica). A no-op on single-pool deployments.
    handoff: bool = True
    # beam search width (the reference forwards num_beams to HF generate,
    # ml/formatter.py:88-92; here engine/generate.py::generate_beam on
    # whole-model jobs and ml/module.py::_generate_beam_pipelined on
    # multi-stage jobs). >1: deterministic beam decode — sampling knobs
    # are ignored, streaming is rejected.
    num_beams: int = 1
    # OpenAI-style stop sequences (the reference declares this field,
    # api/models.py:70, but never applies it — here output is truncated at
    # the earliest occurrence, streaming included via api/formatter.py
    # StopStream). A confirmed match CANCELS the row mid-loop on
    # host-driven decode paths (pipelined sessions, streamed engine
    # decode), and on the fully-compiled streamed loop it rides the
    # STREAM_CANCEL backchannel to the worker, which polls at
    # ``stream_chunk_steps`` chunk boundaries — overrun past a stop is at
    # most one chunk, not the full token budget. Non-streamed single-stage
    # requests keep the pure compiled loop (no cancel); completion_tokens
    # always counts tokens generated THROUGH the match, not the full
    # decode.
    # With enable_thinking=true the live stream is unfiltered (raw think
    # text) and only the final answer is truncated.
    stop: list[str] = field(default_factory=list)
    # SLO scheduling class (engine/scheduler.py, docs/SERVING.md
    # "Scheduling"): "interactive" | "batch" | "best_effort". Empty →
    # the validator's MLConfig.default_priority. Orders admission on the
    # continuous serving path (aging keeps low classes starvation-free;
    # an interactive request may preempt a lower-class slot) and selects
    # the 429 backpressure queue the request is judged against.
    priority: str = ""
    # journal rid of a stream a LOST validator was serving (the client
    # re-attach ladder, docs/FAILURE_MODEL.md "Control plane"). Repeat
    # the ORIGINAL request body plus this field against the recovered
    # validator: the stream resumes from the worker's orphan buffer and
    # the response carries the COMPLETE stream from token 0 — clients
    # REPLACE any partial pre-crash text with it (exactly-once by
    # replacement). The jrid itself rides every response body and, on
    # SSE, a prelude event before the first delta.
    reattach: str = ""

    _PRIORITIES = ("interactive", "batch", "best_effort")

    @classmethod
    def _parse_priority(cls, v) -> str:
        if v is None or v == "":
            return ""
        _require(
            isinstance(v, str) and v.lower() in cls._PRIORITIES,
            "priority must be one of interactive|batch|best_effort",
        )
        return v.lower()

    @staticmethod
    def _parse_stop(v) -> list[str]:
        if v is None:
            return []
        if isinstance(v, str):
            v = [v]
        _require(isinstance(v, list) and len(v) <= 4, "stop: up to 4 strings")
        for s in v:
            _require(isinstance(s, str) and s, "stop entries must be "
                     "non-empty strings")
        return list(v)

    @classmethod
    def parse(cls, d: dict) -> "GenerationRequest":
        _require(isinstance(d.get("hf_name"), str) and d["hf_name"], "hf_name required")
        try:
            req = cls(
                hf_name=d["hf_name"],
                message=str(d.get("message", "")),
                history=list(d.get("history", [])),
                max_length=d.get("max_length"),
                max_new_tokens=int(d.get("max_new_tokens", 256)),
                temperature=float(d.get("temperature", 0.6)),
                top_p=float(d.get("top_p", 0.95)),
                top_k=int(d.get("top_k", 0)),
                do_sample=bool(d.get("do_sample", True)),
                presence_penalty=float(d.get("presence_penalty", 0.0)),
                frequency_penalty=float(d.get("frequency_penalty", 0.0)),
                stream=bool(d.get("stream", False)),
                output_format=str(d.get("output_format", "simple")),
                enable_thinking=bool(d.get("enable_thinking", False)),
                lookahead=bool(d.get("lookahead", False)),
                speculative=bool(d.get("speculative", False)),
                handoff=bool(d.get("handoff", True)),
                num_beams=int(d.get("num_beams", 1)),
                stop=cls._parse_stop(d.get("stop")),
                priority=cls._parse_priority(d.get("priority")),
                reattach=str(d.get("reattach", "") or ""),
            )
        except ValidationError:
            raise
        except (TypeError, ValueError) as e:
            # null / non-numeric values in numeric fields must be a 400,
            # not an int()/float() TypeError surfacing as a 500
            raise ValidationError(f"invalid field value: {e}")
        _require(len(req.reattach) <= 64, "reattach rid too long")
        _require(
            not (req.reattach and req.num_beams > 1),
            "reattach cannot combine with num_beams",
        )
        _require(req.max_new_tokens > 0, "max_new_tokens must be positive")
        _require(0.0 <= req.temperature <= 2.0, "temperature must be in [0, 2]")
        _require(0.0 < req.top_p <= 1.0, "top_p must be in (0, 1]")
        _require(req.top_k >= 0, "top_k must be >= 0")
        _require(1 <= req.num_beams <= 8, "num_beams must be in [1, 8]")
        _require(
            req.num_beams == 1 or not req.stream,
            "num_beams > 1 requires stream=false",
        )
        _require(
            req.num_beams == 1 or not req.do_sample,
            "num_beams > 1 is deterministic: set do_sample=false",
        )
        _require(
            req.num_beams == 1
            or (req.presence_penalty == 0 and req.frequency_penalty == 0),
            "num_beams > 1 does not support repetition penalties",
        )
        for nm, v in (("presence_penalty", req.presence_penalty),
                      ("frequency_penalty", req.frequency_penalty)):
            _require(-2.0 <= v <= 2.0, f"{nm} must be in [-2, 2]")
        _require(
            req.output_format in ("simple", "openai", "raw"),
            "output_format must be simple|openai|raw",
        )
        for h in req.history:
            _require(
                isinstance(h, dict) and "role" in h and "content" in h,
                "history entries need role+content",
            )
        return req


@dataclass(frozen=True)
class ChatCompletionRequest:
    """POST /v1/chat/completions body (reference api/models.py:60)."""

    model: str
    messages: list[dict]
    max_tokens: int = 256
    temperature: float = 0.6
    top_p: float = 0.95
    stream: bool = False
    lookahead: bool = False  # speculative decode hint (greedy only)
    # continuous draft/verify hint (see GenerationRequest.speculative)
    speculative: bool = False
    # prefill→decode handoff opt-out (see GenerationRequest.handoff)
    handoff: bool = True
    stop: list[str] = field(default_factory=list)
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # number of choices (OpenAI ``n``; non-streaming only — the n requests
    # dispatch concurrently and the batcher coalesces them into one decode)
    n: int = 1
    # SLO scheduling class (see GenerationRequest.priority)
    priority: str = ""

    @classmethod
    def parse(cls, d: dict) -> "ChatCompletionRequest":
        _require(isinstance(d.get("model"), str) and d["model"], "model required")
        msgs = d.get("messages")
        _require(isinstance(msgs, list) and msgs, "messages required")
        for m in msgs:
            _require(
                isinstance(m, dict) and "role" in m and "content" in m,
                "each message needs role+content",
            )
        try:
            req = cls(
                model=d["model"],
                messages=msgs,
                max_tokens=int(d.get("max_tokens", d.get("max_completion_tokens", 256))),
                temperature=float(d.get("temperature", 0.6)),
                top_p=float(d.get("top_p", 0.95)),
                stream=bool(d.get("stream", False)),
                lookahead=bool(d.get("lookahead", False)),
                speculative=bool(d.get("speculative", False)),
                handoff=bool(d.get("handoff", True)),
                stop=GenerationRequest._parse_stop(d.get("stop")),
                presence_penalty=float(d.get("presence_penalty", 0.0)),
                frequency_penalty=float(d.get("frequency_penalty", 0.0)),
                n=int(d.get("n", 1)),
                priority=GenerationRequest._parse_priority(d.get("priority")),
            )
        except ValidationError:
            raise
        except (TypeError, ValueError) as e:
            raise ValidationError(f"invalid field value: {e}")
        _require(req.max_tokens > 0, "max_tokens must be positive")
        _require(1 <= req.n <= 8, "n must be in [1, 8]")
        _require(
            req.n == 1 or not req.stream, "n > 1 requires stream=false"
        )
        for nm, v in (("presence_penalty", req.presence_penalty),
                      ("frequency_penalty", req.frequency_penalty)):
            _require(-2.0 <= v <= 2.0, f"{nm} must be in [-2, 2]")
        return req

    def to_generation_request(self) -> GenerationRequest:
        """OpenAI messages → internal request (reference
        _parse_chat_messages, api/node.py:53-92): last user message is the
        prompt, the rest is history."""
        history = [
            {"role": m["role"], "content": m["content"]} for m in self.messages[:-1]
        ]
        last = self.messages[-1]
        return GenerationRequest(
            hf_name=self.model,
            message=str(last.get("content", "")),
            history=history,
            max_new_tokens=self.max_tokens,
            temperature=self.temperature,
            top_p=self.top_p,
            stream=self.stream,
            output_format="openai",
            lookahead=self.lookahead,
            speculative=self.speculative,
            handoff=self.handoff,
            stop=self.stop,
            presence_penalty=self.presence_penalty,
            frequency_penalty=self.frequency_penalty,
            priority=self.priority,
        )


@dataclass(frozen=True)
class JobRequest:
    """POST /request-model body (reference api/models.py:9). ``config`` is
    an optional explicit ModelConfig dict — the analogue of the reference's
    custom-distribution job path (user_thread.py:242 explicit jobs)."""

    hf_name: str
    batch: int = 1
    seq_len: int = 2048
    training: bool = False
    config: dict | None = None
    # weight-only-quantized serving ("int8" halves parameter HBM traffic;
    # "int8+kv" also stores KV quantized — docs/SERVING.md "Quantized KV")
    quant: str | None = None

    @classmethod
    def parse(cls, d: dict) -> "JobRequest":
        _require(isinstance(d.get("hf_name"), str) and d["hf_name"], "hf_name required")
        cfg = d.get("config")
        _require(cfg is None or isinstance(cfg, dict), "config must be an object")
        quant = d.get("quant")
        _require(
            quant in (None, "int8", "int8+kv"),
            "quant must be \"int8\" or \"int8+kv\"",
        )
        try:
            req = cls(
                hf_name=d["hf_name"],
                batch=int(d.get("batch", 1)),
                seq_len=int(d.get("seq_len", 2048)),
                training=bool(d.get("training", False)),
                config=cfg,
                quant=quant,
            )
        except ValidationError:
            raise
        except (TypeError, ValueError) as e:
            raise ValidationError(f"invalid field value: {e}")
        _require(req.batch >= 1, "batch must be >= 1")
        _require(req.seq_len >= 1, "seq_len must be >= 1")
        return req
