"""Structured JSON logging with request trace-id binding.

The text log format stays the default (humans at a terminal); ``--log-format
json`` (env ``LOCALAI_LOG_FORMAT=json``) switches every line to one JSON
object so a collector can join server logs with the trace store and
/metrics on the ``trace_id`` field.

The trace id travels on a :mod:`contextvars` ContextVar: the server's
request wrapper (``api.server``) binds the per-request id in the handler's
own thread for the duration of the request (the server runs one thread a
connection, and each thread has its own context, so concurrent requests
cannot bleed ids into each other's log lines), and any ``log.*`` call made
from that thread — handler code, model manager, scheduler submit path —
carries it automatically. Engine-thread log lines have no request context
and simply omit the field.

A copy of ``localai_tpu/obs/logging.py`` with the names kept; stdlib only.
"""

from __future__ import annotations

import contextvars
import io
import json
import logging
import sys
import time
import traceback
from typing import Optional

_TRACE_ID: contextvars.ContextVar[str] = contextvars.ContextVar(
    "localai_trace_id", default="")

# logging.LogRecord attributes that are plumbing, not payload — anything
# else passed via ``extra=`` lands in the JSON line
_RECORD_FIELDS = frozenset(vars(
    logging.LogRecord("", 0, "", 0, "", (), None)
)) | {"message", "asctime", "taskName"}


def bind_trace_id(trace_id: str) -> contextvars.Token:
    """Bind the current context's trace id; returns the reset token."""
    return _TRACE_ID.set(trace_id)


def unbind_trace_id(token: contextvars.Token) -> None:
    _TRACE_ID.reset(token)


def current_trace_id() -> str:
    return _TRACE_ID.get()


class JsonFormatter(logging.Formatter):
    """One JSON object per line: ts, level, logger, message, trace_id (when
    bound), exc (when raised), plus any ``extra=`` fields."""

    def format(self, record: logging.LogRecord) -> str:
        out: dict = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S",
                                time.gmtime(record.created))
                  + f".{int(record.msecs):03d}Z",
            "level": record.levelname.lower(),
            "logger": record.name,
            "message": record.getMessage(),
        }
        tid = _TRACE_ID.get()
        if tid:
            out["trace_id"] = tid
        if record.exc_info:
            buf = io.StringIO()
            traceback.print_exception(*record.exc_info, file=buf)
            out["exc"] = buf.getvalue()
        for key, value in record.__dict__.items():
            if key not in _RECORD_FIELDS and not key.startswith("_"):
                out[key] = value
        return json.dumps(out, default=str)


def setup(fmt: str = "text", level: int = logging.INFO,
          stream: Optional[object] = None) -> None:
    """Configure the root logger. ``fmt='json'`` installs the structured
    formatter; ``'text'`` keeps the classic single-line format."""
    handler = logging.StreamHandler(stream or sys.stderr)
    if fmt == "json":
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s"))
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(level)
