"""The kernel wrappers' launch counters under threads: Tune's trials (and
Serve's replicas) launch the same kernels from several threads, so each
wrapper counts through ``ops._build.count_launch``, under a lock. Eight
threads add to one counter; no increment may be lost. The counters are
read and reset as plain attributes (``flash.flash_fwd.launches = 0``), as
chip_smoke.py does. On CPython 3.12 an unlocked ``+=`` of an int attribute
has no thread switch between its read and its write, so the last case
gives the counter a getter that yields the interpreter between the two:
only the lock keeps that count whole (and keeps the wrappers' counts
whole on an interpreter without the GIL)."""

import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from ray_tpu_torch.ops import _build, flash  # noqa: E402
from ray_tpu_torch.ops import paged_attention, ring_attention  # noqa: E402

WRAPPERS = {"flash_fwd": flash.flash_fwd, "flash_bwd_dq": flash.flash_bwd_dq,
            "flash_bwd_dkv": flash.flash_bwd_dkv,
            "paged_attention": paged_attention.paged_attention,
            "block_attention": ring_attention.block_attention}
THREADS, EACH = 8, 20_000


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_counter_loses_nothing_under_threads(name):
    fn = WRAPPERS[name]
    saved, interval = fn.launches, sys.getswitchinterval()
    fn.launches = 0
    start = threading.Barrier(THREADS)

    def hammer():
        start.wait()
        for _ in range(EACH):
            _build.count_launch(fn)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert fn.launches == THREADS * EACH
    finally:
        sys.setswitchinterval(interval)
        fn.launches = saved


class _YieldingCounter:
    """``launches`` whose read hands the interpreter to another thread."""

    def __init__(self):
        self._n = 0

    @property
    def launches(self):
        value = self._n
        time.sleep(0)
        return value

    @launches.setter
    def launches(self, value):
        self._n = value


def test_count_is_whole_when_the_read_yields():
    counter = _YieldingCounter()
    start = threading.Barrier(THREADS)

    def hammer():
        start.wait()
        for _ in range(500):
            _build.count_launch(counter)

    threads = [threading.Thread(target=hammer) for _ in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert counter.launches == THREADS * 500
