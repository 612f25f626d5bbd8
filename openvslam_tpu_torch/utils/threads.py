"""What the System's worker threads share: the mapping worker, the loop
worker and the background global BA each run on a CUDA stream of their own
and count, rather than lose, the exceptions they raise."""
from __future__ import annotations

import contextlib
import threading
import traceback
from typing import Optional

import torch

from .log import get_logger

_log = get_logger("threads")


class WorkerFaults:
    """Exceptions raised on worker threads: how many, and the first one's
    traceback.  ``System.stats()`` reports both; a worker that records a
    fault goes on with its next item."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.first: Optional[str] = None

    def record(self, where: str):
        """Record the exception being handled (call from an ``except``)."""
        tb = traceback.format_exc()
        with self._lock:
            self.count += 1
            if self.first is None:
                self.first = f"{where} ({threading.current_thread().name}):\n{tb}"
        _log.error("%s failed on %s:\n%s", where, threading.current_thread().name, tb)


def worker_stream(device: torch.device) -> Optional[torch.cuda.Stream]:
    """A new CUDA stream for the calling worker (None off the card).  It
    first waits for everything queued on the default stream so far: the
    tensors the constructing thread uploaded before the worker started."""
    if device.type != "cuda":
        return None
    s = torch.cuda.Stream(device)
    s.wait_stream(torch.cuda.default_stream(device))
    return s


def on_stream(stream: Optional[torch.cuda.Stream]):
    """``torch.cuda.stream(stream)``, or nothing off the card."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def sync_current_stream(device: torch.device):
    """Wait for the calling thread's current stream only (other threads'
    streams keep running)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
