"""Structured logging.

Replaces the reference's ad-hoc prints (and its DISPLAY-probe side effect,
orderParam_lib.py:33-38) with a namespaced stdlib logger.
"""

from __future__ import annotations

import logging

_LOGGER = None

# Process-lifetime seen-set for log_once; keys are namespaced tuples.
_LOGGED_ONCE: set = set()


def log_once(key, msg: str, *args, level: str = "info") -> bool:
    """Emit a log record once per key per process, so that steady-state
    driver loops don't repeat it. Returns whether the record was emitted."""
    if key in _LOGGED_ONCE:
        return False
    _LOGGED_ONCE.add(key)
    getattr(get_logger(), level)(msg, *args)
    return True


def get_logger(name: str = "waterorderlib_tpu_torch") -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger(name)
        if not logger.handlers:
            h = logging.StreamHandler()
            h.setFormatter(
                logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
            )
            logger.addHandler(h)
            logger.setLevel(logging.INFO)
        _LOGGER = logger
    return _LOGGER
