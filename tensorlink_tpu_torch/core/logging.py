"""Tagged, colored logging with a VERBOSE level and rotating file output.

Reference parity: smart_node.py:47,119-125,499-530 — colored tag-prefixed
``debug_print`` with custom VERBOSE=5 level and a TimedRotatingFileHandler to
``logs/runtime.log`` with 7-day retention. Re-specified on top of stdlib
logging rather than hand-rolled prints.

**Structured JSON mode** (``NodeConfig.json_logs`` →
:func:`set_json_logs`): every line becomes one JSON object carrying
``ts`` (epoch seconds), ``level``, ``tag``, ``msg`` — and ``trace_id``
when a distributed-trace span is active on the emitting thread
(core/trace.py ``current_trace``), so cluster log aggregates join
directly against ``GET /trace/<rid>``. Plain colored mode stays the
default.
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import sys
from pathlib import Path

# process-wide log-mode switch, flipped once at node start (BaseNode reads
# NodeConfig.json_logs before any executor thread spawns); a dict cell so
# formatters see updates without module-global rebinding
# tlint: disable=TL006(process-wide log-mode flag — set once at node start, reset via set_json_logs(False) in tests)
_MODE = {"json": False}


def set_json_logs(enabled: bool) -> None:
    """Switch every tensorlink logger (stream and file handlers alike)
    to/from one-JSON-object-per-line output."""
    _MODE["json"] = bool(enabled)


def json_logs_enabled() -> bool:
    return _MODE["json"]

VERBOSE = 5
logging.addLevelName(VERBOSE, "VERBOSE")

# tlint: disable=TL006(read-only constant table — never mutated at runtime)
_COLORS = {
    "VERBOSE": "\033[90m",
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[41m",
}
_RESET = "\033[0m"


class _TagFormatter(logging.Formatter):
    def __init__(self, color: bool):
        super().__init__()
        self.color = color

    def format(self, record: logging.LogRecord) -> str:
        tag = getattr(record, "tag", record.name.rsplit(".", 1)[-1])
        if _MODE["json"]:
            out = {
                # record.created is the stdlib's epoch stamp — a genuine
                # wall-clock timestamp for log joining, never used for
                # durations
                "ts": round(record.created, 6),
                "level": record.levelname,
                "tag": tag,
                "msg": record.getMessage(),
            }
            from tensorlink_tpu_torch.core.trace import current_trace

            tid = current_trace.get()
            if tid:
                out["trace_id"] = tid
            if record.exc_info:
                out["exc"] = self.formatException(record.exc_info)
            return json.dumps(out, default=str)
        base = f"[{self.formatTime(record, '%H:%M:%S')}] [{tag}] {record.getMessage()}"
        if record.exc_info:
            base += "\n" + self.formatException(record.exc_info)
        if self.color:
            c = _COLORS.get(record.levelname, "")
            return f"{c}{base}{_RESET}" if c else base
        return base


class NodeLogger(logging.LoggerAdapter):
    """Logger bound to a node tag, e.g. ``[worker:ab12cd]``."""

    def process(self, msg, kwargs):
        extra = kwargs.setdefault("extra", {})
        extra.setdefault("tag", self.extra["tag"])
        return msg, kwargs

    def verbose(self, msg, *args, **kwargs):
        self.log(VERBOSE, msg, *args, **kwargs)


def get_logger(
    tag: str,
    level: int = logging.INFO,
    log_dir: str | Path | None = None,
    color: bool = True,
) -> NodeLogger:
    logger = logging.getLogger(f"tensorlink_tpu_torch.{tag}")
    logger.setLevel(min(level, VERBOSE))
    stream_handlers = [
        h for h in logger.handlers if isinstance(h, logging.StreamHandler)
        and not isinstance(h, logging.FileHandler)
    ]
    if not stream_handlers:
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(_TagFormatter(color=color and sys.stderr.isatty()))
        sh.setLevel(level)
        logger.addHandler(sh)
    else:
        # Later calls may lower the level (e.g. enable VERBOSE after import).
        for h in stream_handlers:
            h.setLevel(min(h.level, level))
    if log_dir is not None and not any(
        isinstance(h, logging.FileHandler) for h in logger.handlers
    ):
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        fh = logging.handlers.TimedRotatingFileHandler(
            Path(log_dir) / "runtime.log",
            when="D",
            backupCount=7,  # 7-day retention, reference smart_node.py:119-125
        )
        fh.setFormatter(_TagFormatter(color=False))
        fh.setLevel(VERBOSE)
        logger.addHandler(fh)
    logger.propagate = False
    return NodeLogger(logger, {"tag": tag})
