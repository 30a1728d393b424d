"""The ``/report`` wire: bodies from the C writer over run columns.

The native path's :class:`~reporter_tpu_torch.matcher.matcher.MatchRuns`
serialise through the host runtime's writer (``native.write_report_json``
and friends): one C call emits a whole body into one buffer. The Python
writers (``service.report._report_json_py``,
``matcher.render_segments_json_py``) are the oracle it is held against,
and serve only what the C writer cannot express: level sets that are not
a 0..7 bitmask (:func:`level_mask`), and the numpy path's plain dicts.
A writer fault raises.
"""
from __future__ import annotations

import json
import math
import numbers
from typing import Optional

from .. import native


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
    writer, or None when a level set is not a bitmask (the caller then
    takes the Python writer).

    Chunk memo: when the batched assembly attached the chunk layout
    (``_run_off``/``_trace_end``), the first body asked of a chunk emits
    every trace's body in one C call into one buffer, and later bodies
    are slices of it. The memo is keyed on (threshold, masks) and each
    slice is checked against its trace's recorded end time, so a caller
    with other options or another trace takes the per-trace C call
    instead of stale bytes. Two threads racing to build the memo write
    equal buffers; the last one stays."""
    rep_m = level_mask(report_levels)
    trans_m = level_mask(transition_levels)
    if rep_m is None or trans_m is None:
        return None
    threshold_sec = float(threshold_sec)
    trace_end = float(trace_end)
    key = (threshold_sec, rep_m, trans_m)
    memo = arrays.get("_wire_chunk")
    if memo is None and "_run_off" in arrays:
        buf, offsets = native.write_report_json_batch(
            arrays, threshold_sec, rep_m, trans_m)
        ro = arrays["_run_off"].tolist()
        ends = arrays["_trace_end"].tolist()
        mv = buf.data
        memo = (key, {(ro[t], ro[t + 1]): (ends[t],
                                           mv[offsets[t]:offsets[t + 1]])
                      for t in range(len(offsets) - 1)})
        arrays["_wire_chunk"] = memo
    # one memo per chunk: with requests alternating two option sets, a
    # rebuild per mismatch would serialise the chunk once per request
    if memo is not None and memo[0] == key:
        hit = memo[1].get((lo, hi))
        if hit is not None and (hit[0] == trace_end or lo == hi):
            return hit[1]
    return native.write_report_json(arrays, lo, hi, trace_end,
                                    threshold_sec, rep_m, trans_m)


def native_segments(arrays: dict, lo: int, hi: int,
                    mode: str) -> memoryview:
    """``{"segments":...,"mode":...}`` for run columns [lo, hi) from the C
    writer."""
    mode_json = b'"auto"' if mode == "auto" \
        else json.dumps(mode).encode("utf-8")
    return native.write_segments_json(arrays, lo, hi, mode_json)
