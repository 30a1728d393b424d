"""The ``/report`` wire: bodies from the C writer over run columns.

The native path's :class:`~reporter_tpu_torch.matcher.matcher.MatchRuns`
serialise through the host runtime's writer (``native.write_report_json``
and friends): one C call emits a whole body into one buffer. The Python
writers (``service.report._report_json_py``,
``matcher.render_segments_json_py``) are the oracle it is held against,
and serve only what the C writer cannot express: level sets that are not
a 0..7 bitmask (:func:`level_mask`), and the numpy path's plain dicts.

Failure domain ``wire.circuit``, as in the JAX package: a C writer fault
(or an armed ``wire.native`` failpoint) counts ``wire.errors`` and a
breaker failure, and that response is written by the Python writer, byte
for byte the same; while the breaker is open every response skips the C
writer, until a half-open probe closes it. A writer fault never answers
500. Counters: ``wire.native`` responses, ``wire.fallback`` (counted by
``service.report.report_wire``) and ``wire.errors``, and the breaker's
``wire.circuit.*``. The breaker is process-wide; the service's
``circuit_threshold`` and ``circuit_cooldown_s`` set it
(``server.configure_faults``).
"""
from __future__ import annotations

import json
import logging
import math
import numbers
from typing import Optional

from .. import native
from ..utils import faults, metrics
from ..utils.circuit import CircuitBreaker

logger = logging.getLogger("reporter_tpu_torch.wire")

#: the writer's failure domain: open, every response takes the Python
#: writer
circuit = CircuitBreaker("wire.circuit")


def level_mask(levels) -> Optional[int]:
    """Levels as a 0..7 bitmask, or None when a mask cannot reproduce the
    Python scan's set-membership semantics (the caller then takes the
    Python writer). The scan tests ``level in levels`` where level is an
    int in -1..7 (-1 = no segment id), so:

    - integral numbers in 0..7 become mask bits (bools and x.0 floats
      compare equal to int levels in a set);
    - non-integral or non-numeric values (2.5, "0", None) never equal an
      int level and are dropped, never coerced;
    - a value equal to -1 can match the no-id level, which no 0..7 mask
      expresses: None;
    - integral values past 7 never match (level = sid & 7): dropped.
    """
    m = 0
    for v in levels:
        if isinstance(v, numbers.Integral):  # bool, int, numpy ints
            iv = int(v)
        elif isinstance(v, numbers.Real):  # float, numpy floats
            f = float(v)
            if not math.isfinite(f) or f != int(f):
                continue
            iv = int(f)
        elif v is None or isinstance(v, (str, bytes)):
            continue
        else:
            # an exotic number (Decimal, a type with its own __eq__) might
            # match in the set test: only the Python scan knows
            return None
        if iv == -1:
            return None
        if 0 <= iv <= 7:
            m |= 1 << iv
    return m


def maybe_native_report(arrays: dict, lo: int, hi: int, trace_end,
                        threshold_sec, report_levels,
                        transition_levels) -> Optional[memoryview]:
    """The whole ``/report`` body for run columns [lo, hi) from the C
    writer, or None when a level set is not a bitmask, the breaker is
    open or the writer faulted (the caller then takes the Python writer).

    Chunk memo: when the batched assembly attached the chunk layout
    (``_run_off``/``_trace_end``), the first body asked of a chunk emits
    every trace's body in one C call into one buffer, and later bodies
    are slices of it. The memo is keyed on (threshold, masks) and each
    slice is checked against its trace's recorded end time, so a caller
    with other options or another trace takes the per-trace C call
    instead of stale bytes. Two threads racing to build the memo write
    equal buffers; the last one stays. A memo hit writes nothing, so it
    passes no failpoint; it serves bytes the C writer wrote, so a
    half-open probe it takes closes the breaker. (The JAX package asks
    the breaker before the masks and leaves a probe that a memo hit or a
    mask serves in flight, so that its breaker stays half-open.)"""
    rep_m = level_mask(report_levels)
    trans_m = level_mask(transition_levels)
    if rep_m is None or trans_m is None:
        return None
    if not circuit.allow():
        return None
    threshold_sec = float(threshold_sec)
    trace_end = float(trace_end)
    key = (threshold_sec, rep_m, trans_m)
    memo = arrays.get("_wire_chunk")
    if memo is not None and memo[0] == key:
        hit = memo[1].get((lo, hi))
        if hit is not None and (hit[0] == trace_end or lo == hi):
            circuit.record_success()
            metrics.count("wire.native")
            return hit[1]
    try:
        faults.failpoint("wire.native")
        out = None
        # one memo per chunk: with requests alternating two option sets,
        # a rebuild per mismatch would serialise the chunk once per
        # request, so a mismatch takes the per-trace call
        if memo is None and "_run_off" in arrays:
            buf, offsets = native.write_report_json_batch(
                arrays, threshold_sec, rep_m, trans_m)
            ro = arrays["_run_off"].tolist()
            ends = arrays["_trace_end"].tolist()
            mv = buf.data
            slices = {(ro[t], ro[t + 1]): (ends[t],
                                           mv[offsets[t]:offsets[t + 1]])
                      for t in range(len(offsets) - 1)}
            arrays["_wire_chunk"] = (key, slices)
            hit = slices.get((lo, hi))
            if hit is not None and (hit[0] == trace_end or lo == hi):
                out = hit[1]
        if out is None:
            out = native.write_report_json(arrays, lo, hi, trace_end,
                                           threshold_sec, rep_m, trans_m)
    except Exception as e:
        circuit.record_failure()
        metrics.count("wire.errors")
        logger.warning("native /report writer failed (%s); serving through "
                       "the Python writer", e)
        return None
    circuit.record_success()
    metrics.count("wire.native")
    return out


def maybe_native_segments(arrays: dict, lo: int, hi: int,
                          mode: str) -> Optional[memoryview]:
    """``{"segments":...,"mode":...}`` for run columns [lo, hi) from the C
    writer, or None (the same failure domain as
    :func:`maybe_native_report`)."""
    if not circuit.allow():
        return None
    try:
        faults.failpoint("wire.native")
        mode_json = b'"auto"' if mode == "auto" \
            else json.dumps(mode).encode("utf-8")
        out = native.write_segments_json(arrays, lo, hi, mode_json)
    except Exception as e:
        circuit.record_failure()
        metrics.count("wire.errors")
        logger.warning("native segments writer failed (%s); serving "
                       "through the Python writer", e)
        return None
    circuit.record_success()
    metrics.count("wire.native")
    return out
