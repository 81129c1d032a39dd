"""
Per-stage wall-clock bookkeeping for the CLI pipelines.

API-compatible with the reference's StageTimer (whatshap/timer.py) — the
subcommands print the same end-of-run stage breakdown — but implemented on
``time.monotonic()`` (immune to wall-clock adjustments) with a single
accumulator table instead of separate start/elapsed dicts.
"""

import logging
import time
from contextlib import contextmanager
from typing import Iterable, Iterator, TypeVar

logger = logging.getLogger(__name__)

_T = TypeVar("_T")


class StageTimer:
    """Accumulates wall-clock time across named, non-overlapping stages."""

    __slots__ = ("_acc", "_running", "_born")

    def __init__(self) -> None:
        # stage -> accumulated seconds (only finished intervals)
        self._acc: dict = {}
        # stage -> monotonic timestamp of the currently open interval
        self._running: dict = {}
        self._born = time.monotonic()

    def start(self, stage: str) -> None:
        self._running[stage] = time.monotonic()

    def stop(self, stage: str) -> float:
        delta = time.monotonic() - self._running.pop(stage)
        if delta < 0:
            # monotonic makes this unreachable in practice; keep the guard
            # so a broken clock degrades to zero instead of negative totals
            logger.warning(
                "Unreliable runtime measurements: Measured a runtime that is not positive"
            )
            delta = 0.0
        self._acc[stage] = self._acc.get(stage, 0.0) + delta
        return delta

    def elapsed(self, stage: str) -> float:
        return self._acc.get(stage, 0.0)

    def sum(self) -> float:
        return sum(self._acc.values())

    def total(self) -> float:
        return time.monotonic() - self._born

    @contextmanager
    def __call__(self, stage: str):
        self.start(stage)
        try:
            yield
        finally:
            self.stop(stage)

    def iterate(self, stage: str, iterable: Iterable[_T]) -> Iterator[_T]:
        """Yield from *iterable*, charging only the producer's time (time
        spent pulling the next item) to *stage* — consumer time between
        yields is not counted."""
        it = iter(iterable)
        while True:
            self.start(stage)
            try:
                item = next(it)
            except StopIteration:
                self.stop(stage)
                return
            self.stop(stage)
            yield item
