"""The reference over many traces at once: a pool of spawned processes,
each holding its own :class:`~.match.Reference` of the network, so that a
judged sample of thousands of answers takes seconds after the window.
"""
from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

_REF = None


def _init(arrays, params, precision):
    global _REF
    from .match import Reference
    _REF = Reference(arrays, params, precision)


def _answer(task):
    lat, lon, times, threshold_sec, levels, trans = task
    return _REF.answer(lat, lon, times, threshold_sec, levels, trans)


def _rows(task):
    lat, lon, times, pipe = task
    return _REF.vehicle_rows(lat, lon, times, pipe)


class ReferencePool:
    """``procs`` processes (the host's cores by default), each with a
    reference of ``arrays`` at ``precision``; closes its workers on
    exit."""

    def __init__(self, arrays: dict, params: dict,
                 precision: str = "float16", procs: int = 0):
        procs = procs or min(8, os.cpu_count() or 1)
        # a worker that dies breaks the pool and raises here, where a
        # multiprocessing.Pool would wait for its task forever
        self._pool = ProcessPoolExecutor(
            procs, mp_context=multiprocessing.get_context("spawn"),
            initializer=_init, initargs=(arrays, params, precision))

    def answers(self, tasks: list) -> list:
        """Each task (lat, lon, times, threshold_sec, report_levels,
        transition_levels) to its ``/report`` answer
        (``Reference.answer``), in order."""
        return list(self._pool.map(_answer, tasks, chunksize=8))

    def rows(self, tasks: list) -> list:
        """Each task (lat, lon, times, pipe) to the vehicle's tile rows
        (``Reference.vehicle_rows``), in order."""
        return list(self._pool.map(_rows, tasks))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._pool.shutdown(wait=True, cancel_futures=True)
