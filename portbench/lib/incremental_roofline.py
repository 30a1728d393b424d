"""The incremental step's bytes, operations and least time on the card,
from the program's counts of what its launches held
(``matcher/incremental.py`` ``_launch``: ``match.incremental.cells.kept``,
``.cells.launched`` and ``.rows.launched``) and the configuration's K.

A real step (a kept cell: one row and round with a step to take) reads its
operands, the distances (float32) and valid flags (1 byte) of its K
candidates, its K x K routes (float32), its gc (float32) and case (int32),
and writes its K new scores (float32), K back-pointers (int32) and best
(int32): ``matcher/incremental.py`` ``slab_row_bytes`` a row and round,
4K^2 + 13K + 12. A padded cell reads nothing and its zeros need not be
written, so it costs no byte of the bound. A row of a launch reads its K
carried scores (float32) and its step count (int32) once. The operations,
about six float32 operations for each (i, j) of a step and four for each
j, bound nothing at these sizes, and are counted all the same.

Peaks are ``roofline.py``'s: one H100 SXM at its 700 W limit.
"""
from __future__ import annotations

from .roofline import F32_OPS_PER_S, HBM_BYTES_PER_S


def step_bytes(K: int) -> int:
    """Bytes one real step reads and writes (``slab_row_bytes``)."""
    return 4 * K * K + 13 * K + 12


def row_bytes(K: int) -> int:
    """Bytes one row of a launch reads once: its carried scores and its
    step count."""
    return 4 * K + 4


def step_ops(K: int) -> int:
    """float32 operations of one real step."""
    return 6 * K * K + 4 * K


def bound_s(kept: int, rows: int, K: int) -> float:
    """The least time of launches that held ``kept`` real steps over
    ``rows`` rows: the larger of their bytes over the peak bandwidth and
    their operations over the peak rate."""
    return max((kept * step_bytes(K) + rows * row_bytes(K))
               / HBM_BYTES_PER_S, kept * step_ops(K) / F32_OPS_PER_S)
