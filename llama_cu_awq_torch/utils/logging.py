"""Structured logging for the port's services (the JAX package's
utils/logging.py: the CLI keeps the reference's printf surface, the
servers log through standard `logging` underneath).

Every logger lives under the port's root logger, "llama_cu_awq_torch",
which gets one stderr handler at INFO on first use, so a server's
startup line reaches stderr without the caller configuring logging.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager

ROOT = "llama_cu_awq_torch"
_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"
_configured = False


def get_logger(name: str = ROOT) -> logging.Logger:
    """The logger `name` under the port's root ("serve" is
    "llama_cu_awq_torch.serve"); the first call gives the root a stderr
    handler at INFO and stops it from propagating to Python's root
    logger."""
    global _configured
    if not _configured:
        root = logging.getLogger(ROOT)
        if not root.handlers:
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter(_FORMAT))
            root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True
    if name != ROOT and not name.startswith(ROOT + "."):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)


@contextmanager
def log_timing(logger: logging.Logger, what: str, level=logging.INFO):
    """Log the wall time of a block: `with log_timing(log, "load"):`"""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.log(level, "%s took %.3fs", what, time.perf_counter() - t0)
