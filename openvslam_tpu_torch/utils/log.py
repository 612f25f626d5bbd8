"""Logging taxonomy (a copy of ``openvslam_tpu/utils/log.py`` under the
port's own logger namespace; ref: spdlog used throughout src/openvslam/*).

The reference logs lifecycle and SLAM events via spdlog::info/debug with a
``--debug`` CLI switch in the examples.  We mirror that with stdlib logging
under the ``openvslam_tpu_torch`` namespace:

* INFO  — lifecycle (startup/shutdown/reset, map save/load, module
  enable/disable) and rare SLAM events (initialization, tracking lost,
  relocalization, loop detection/correction, global BA).
* DEBUG — per-frame / per-keyframe detail (tracking inliers, keyframe
  insertion, mapping statistics).

Library convention: a NullHandler is installed on import so embedding
applications stay silent unless they configure logging; the example runners
call :func:`enable_console` (``--debug`` raises the level to DEBUG),
matching the reference binaries' default spdlog console sink.
"""
from __future__ import annotations

import logging

_ROOT = "openvslam_tpu_torch"

logging.getLogger(_ROOT).addHandler(logging.NullHandler())


def get_logger(name: str) -> logging.Logger:
    """Namespaced logger, e.g. get_logger("tracking")."""
    return logging.getLogger(f"{_ROOT}.{name}")


def enable_console(debug: bool = False) -> None:
    """Attach a console handler to the package root (spdlog-like format).

    Used by the example runners; idempotent.
    """
    root = logging.getLogger(_ROOT)
    root.setLevel(logging.DEBUG if debug else logging.INFO)
    for h in root.handlers:
        if isinstance(h, logging.StreamHandler) and not isinstance(
            h, logging.NullHandler
        ):
            h.setLevel(logging.DEBUG if debug else logging.INFO)
            return
    handler = logging.StreamHandler()
    handler.setLevel(logging.DEBUG if debug else logging.INFO)
    handler.setFormatter(logging.Formatter(
        "[%(asctime)s] [%(levelname).1s] [%(name)s] %(message)s",
        datefmt="%H:%M:%S",
    ))
    root.addHandler(handler)
