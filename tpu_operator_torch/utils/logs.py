"""Structured logging setup shared by every CLI.

The port's copy of ``tpu_operator/utils/logs.py``, which uses no device: the
port imports nothing of the JAX package, so it keeps its own, and
``tests/test_torch_kube_copy.py`` holds the two equal on the same inputs.

Reference analogue: zap with a configurable level/encoding
(main.go:77-83 wires zap options; operands log JSON in production). One
helper so `--log-format json` means the same thing in every binary, and the
fluentd/Cloud-Logging pipeline gets one parseable shape.
"""

from __future__ import annotations

import json
import logging
import time

# LogRecord's own attributes — anything else on the record arrived via
# ``extra={...}`` and belongs in the JSON line as a structured field
_RESERVED = frozenset(vars(logging.makeLogRecord({}))) | {"message"}


class JsonFormatter(logging.Formatter):
    """One JSON object per line: base fields, any ``extra={...}`` fields,
    and — when a reconcile trace is active on the logging thread — its
    trace/span ids, so log lines join up with /debug/traces spans."""

    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": round(time.time(), 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        for key, val in vars(record).items():
            if key in _RESERVED or key in entry:
                continue
            try:
                json.dumps(val)
            except (TypeError, ValueError):
                val = repr(val)
            entry[key] = val
        from . import trace
        active = trace.current()
        if active is not None and active.trace_id is not None:
            entry["trace_id"] = active.trace_id
            entry["span_id"] = active.span_id
        if record.exc_info:
            entry["exc"] = self.formatException(record.exc_info)
        return json.dumps(entry)


def setup_logging(verbose: bool = False, fmt: str = "text"):
    """fmt: "text" (human) or "json" (one object per line)."""
    level = logging.DEBUG if verbose else logging.INFO
    if fmt == "json":
        handler = logging.StreamHandler()
        handler.setFormatter(JsonFormatter())
        logging.basicConfig(level=level, handlers=[handler], force=True)
    else:
        logging.basicConfig(
            level=level,
            format="%(asctime)s %(levelname)s %(name)s %(message)s",
            force=True)


def add_logging_flags(parser):
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--log-format", choices=("text", "json"),
                        default="text")
