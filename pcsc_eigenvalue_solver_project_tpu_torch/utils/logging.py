"""Structured logging for solver runs.

The port of the JAX package's ``utils/logging.py``, with the same logger
name: the reference's observability contract is the
``iterations``/``converged`` result fields plus the demo's output; this
adds a standard-library logger namespaced ``eigsol_tpu`` and a JSON-line
event emitter.
"""

from __future__ import annotations

import json
import logging
import sys
import time

LOGGER_NAME = "eigsol_tpu"


def get_logger(name: str | None = None) -> logging.Logger:
    logger = logging.getLogger(f"{LOGGER_NAME}.{name}" if name else LOGGER_NAME)
    if not logging.getLogger(LOGGER_NAME).handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logging.getLogger(LOGGER_NAME).addHandler(h)
        logging.getLogger(LOGGER_NAME).setLevel(logging.INFO)
    return logger


def emit_event(kind: str, stream=None, **fields) -> None:
    """One JSON line per event (bench results, parity reports, timings)."""
    rec = {"event": kind, "ts": round(time.time(), 3), **fields}
    print(json.dumps(rec), file=stream or sys.stderr)


def log_result(name: str, res) -> None:
    """Log a solver result's observability fields."""
    get_logger("solver").info(
        "%s: eigenvalue=%s iterations=%d converged=%s",
        name, complex(res.eigenvalue) if hasattr(res, "eigenvalue") else "-",
        int(res.iterations), bool(res.converged))
