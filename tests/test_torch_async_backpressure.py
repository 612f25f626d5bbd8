"""Keyframe-insertion backpressure of the port's async mapping
(``openvslam_tpu_torch.system._AsyncMapperProxy``), held to the gates of
tests/test_backpressure.py with the same stub mappers: the queue is counted,
``wait_for_backlog`` paces the feed, returns at once while the mapper is
paused and reports its timeouts, only the queue's tail runs local BA, and
``pause(wait=True)`` joins the keyframe in flight.  Also: a stub mapper that
raises is counted, not lost, and the kernels' launch counter keeps every
increment under concurrent threads.  Every wait and join is bounded.
"""
import sys
import threading
import time

import pytest

from openvslam_tpu_torch import kernels
from openvslam_tpu_torch.system import _AsyncMapperProxy
from openvslam_tpu_torch.utils.threads import WorkerFaults


class _GatedMapper:
    """process_keyframe blocks until ``gate`` is set, so the queue contents
    are deterministic."""

    def __init__(self):
        self.gate = threading.Event()
        self.entered = threading.Event()   # the worker is inside process_keyframe
        self.processed = []
        self._next = 0

    def store_keyframe(self, frame):
        kf = self._next
        self._next += 1
        return kf

    def _phase(self, name, t0):
        pass

    def process_keyframe(self, kf, run_ba=True):
        self.entered.set()
        assert self.gate.wait(timeout=30.0)
        self.processed.append((kf, run_ba))


class _SlowMapper(_GatedMapper):
    """process_keyframe takes ``delay`` seconds."""

    def __init__(self, delay):
        super().__init__()
        self.delay = delay

    def process_keyframe(self, kf, run_ba=True):
        time.sleep(self.delay)
        self.processed.append((kf, run_ba))


def _proxy(mapper):
    return _AsyncMapperProxy(mapper, threading.RLock(), WorkerFaults())


def test_backlog_counts_queued_keyframes():
    m = _GatedMapper()
    proxy = _proxy(m)
    assert proxy.backlog == 0
    for i in range(4):
        proxy.insert_keyframe(frame=i)
    assert m.entered.wait(timeout=5.0)
    # the worker is parked inside process_keyframe(0); 1..3 are queued
    assert proxy.backlog == 3
    m.gate.set()
    proxy.drain(timeout=30.0)
    assert proxy.backlog == 0
    assert [k for k, _ in m.processed] == [0, 1, 2, 3]


def test_wait_for_backlog_paces_insertion():
    m = _SlowMapper(delay=0.1)
    proxy = _proxy(m)
    for i in range(3):
        proxy.insert_keyframe(frame=i)
    t0 = time.time()
    drained = proxy.wait_for_backlog(max_backlog=1, timeout=10.0)
    waited = time.time() - t0
    assert drained
    assert proxy.backlog <= 1
    # it had to wait for at least one slow process_keyframe to finish
    assert waited > 0.03, waited
    proxy.drain(timeout=30.0)


def test_backlogged_queue_skips_ba():
    """Abort-on-backlog: only the queue's tail runs local BA."""
    m = _GatedMapper()
    proxy = _proxy(m)
    for i in range(3):
        proxy.insert_keyframe(frame=i)
    assert m.entered.wait(timeout=5.0)   # keyframe 0 is in flight
    assert proxy.backlog == 2            # 1..2 queued behind it
    m.gate.set()
    proxy.drain(timeout=30.0)
    ran_ba = [ba for _, ba in m.processed]
    assert ran_ba[-1] is True
    assert False in ran_ba[:-1]


def test_wait_for_backlog_early_out_while_paused():
    """A paused mapper cannot drain its queue: wait_for_backlog returns at
    once instead of burning its timeout on every fed frame."""
    m = _GatedMapper()
    proxy = _proxy(m)
    for i in range(4):
        proxy.insert_keyframe(frame=i)
    proxy.pause()
    t0 = time.time()
    drained = proxy.wait_for_backlog(max_backlog=1, timeout=10.0)
    waited = time.time() - t0
    assert not drained
    assert waited < 2.0, waited
    proxy.resume()
    m.gate.set()
    proxy.drain(timeout=30.0)
    assert [k for k, _ in m.processed] == [0, 1, 2, 3]


def test_pause_wait_joins_inflight_keyframe():
    """pause(wait=True), the loop worker's handshake before a correction,
    returns only after the keyframe in flight finishes, and the queue
    survives the pause/resume cycle."""
    m = _GatedMapper()
    proxy = _proxy(m)
    for i in range(3):
        proxy.insert_keyframe(frame=i)
    assert m.entered.wait(timeout=5.0)   # the worker is inside keyframe 0
    timer = threading.Timer(0.2, m.gate.set)
    timer.start()
    t0 = time.time()
    proxy.pause(wait=True, timeout=30.0)
    waited = time.time() - t0
    timer.join(timeout=5.0)
    assert waited >= 0.15, waited
    assert proxy.paused
    # keyframe 0 completed, then the worker saw the pause and parked;
    # 1..2 stay queued across it
    assert [k for k, _ in m.processed] == [0]
    time.sleep(0.2)
    assert [k for k, _ in m.processed] == [0]
    proxy.resume()
    proxy.drain(timeout=30.0)
    assert [k for k, _ in m.processed] == [0, 1, 2]


def test_wait_for_backlog_timeout_is_reported():
    m = _GatedMapper()
    proxy = _proxy(m)
    for i in range(3):
        proxy.insert_keyframe(frame=i)
    drained = proxy.wait_for_backlog(max_backlog=1, timeout=0.3)
    assert not drained
    assert proxy.timeouts_hit == 1
    m.gate.set()
    proxy.drain(timeout=30.0)


def test_worker_exception_is_counted_and_the_queue_goes_on():
    """A keyframe whose processing raises is recorded (count and first
    traceback) and the worker processes the rest of the queue."""

    class _Raising(_SlowMapper):
        def process_keyframe(self, kf, run_ba=True):
            if kf == 1:
                raise ValueError("planted failure")
            super().process_keyframe(kf, run_ba)

    m = _Raising(delay=0.0)
    proxy = _proxy(m)
    for i in range(3):
        proxy.insert_keyframe(frame=i)
    proxy.drain(timeout=30.0)
    assert [k for k, _ in m.processed] == [0, 2]
    assert proxy.faults.count == 1
    assert "planted failure" in proxy.faults.first


def test_drain_timeout_raises():
    m = _GatedMapper()
    proxy = _proxy(m)
    proxy.insert_keyframe(frame=0)
    proxy.insert_keyframe(frame=1)
    assert m.entered.wait(timeout=5.0)
    with pytest.raises(TimeoutError):
        proxy.drain(timeout=0.3)
    m.gate.set()


def test_launch_counter_loses_no_increment():
    """Threads counting launches at once (the tracking thread and the
    loop worker both launch K2) lose no increment, in the totals and in
    the per-thread split."""
    n_threads, n_each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        kernels.reset_launch_counts()
        start = threading.Barrier(n_threads)

        def hammer():
            start.wait(timeout=30.0)
            for _ in range(n_each):
                kernels.count_launch("projection_match")

        threads = [threading.Thread(target=hammer, name=f"hammer-{i}") for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
        assert kernels.launch_counts()["projection_match"] == n_threads * n_each
        by_thread = kernels.launch_counts_by_thread()
        assert {by_thread[f"hammer-{i}"]["projection_match"] for i in range(n_threads)} == {n_each}
    finally:
        sys.setswitchinterval(old)
        kernels.reset_launch_counts()
