"""Severity-filtered logging for the port, the JAX package's
``utils/logging.py``: default level INFO, ``-t/--trace`` drops the filter
to DEBUG.

- ``QI_LOG_LEVEL`` — initial level by name (``DEBUG``/``INFO``/``WARNING``/
  ``ERROR``/``CRITICAL``) or numeric value; ``-t`` still overrides it.
- ``QI_LOG_JSON`` — set: each log line becomes one JSON object
  (``{"kind": "log", "level": ..., "logger": ..., "msg": ..., "t_wall":
  ...}``), so log lines and ``qi-telemetry/1`` events interleave in one
  machine-readable stream.

The handler is installed on the package's root logger
(``quorum_intersection_tpu_torch``) the first time :func:`get_logger` or
:func:`set_trace` runs; module loggers made with ``logging.getLogger`` under
that name inherit it.
"""

from __future__ import annotations

import json
import logging
import sys

from quorum_intersection_tpu_torch.utils.env import qi_env, qi_env_flag

_ROOT_NAME = "quorum_intersection_tpu_torch"
_configured = False


class _JsonFormatter(logging.Formatter):
    """One JSON object per log line — telemetry-stream compatible."""

    def format(self, record: logging.LogRecord) -> str:
        line = {
            "kind": "log",
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
            "t_wall": round(record.created, 3),
        }
        if record.exc_info:
            line["exc"] = self.formatException(record.exc_info)
        return json.dumps(line, default=str)


def _env_level() -> int:
    """Level named by QI_LOG_LEVEL (default INFO; bad values ignored)."""
    raw = qi_env("QI_LOG_LEVEL").strip()
    if not raw:
        return logging.INFO
    if raw.isdigit():
        return int(raw)
    level = logging.getLevelName(raw.upper())
    return level if isinstance(level, int) else logging.INFO


def _configure() -> None:
    global _configured
    if _configured:
        return
    logger = logging.getLogger(_ROOT_NAME)
    handler = logging.StreamHandler(sys.stderr)
    if qi_env_flag("QI_LOG_JSON"):
        handler.setFormatter(_JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter("[%(levelname)s] %(name)s: %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(_env_level())
    logger.propagate = False
    _configured = True


def get_logger(name: str = "") -> logging.Logger:
    _configure()
    return logging.getLogger(f"{_ROOT_NAME}.{name}" if name else _ROOT_NAME)


def set_trace(enabled: bool = True) -> None:
    """Enable DEBUG logging, the reference's ``-t`` (overrides
    ``QI_LOG_LEVEL``; disabling restores the env level)."""
    _configure()
    logging.getLogger(_ROOT_NAME).setLevel(logging.DEBUG if enabled else _env_level())
