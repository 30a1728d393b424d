"""The decode's bytes, operations and least time on the card, from its
shapes: frozen from ``chip_smoke.py`` (``wire_bytes``, ``wire_ops``,
``bound_ms``, :605-637) and ``relax_bound``'s peaks (:3765-3792).

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit: 3.35
TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def wire_bytes(B: int, T: int, K: int, float_bytes: int = 2) -> int:
    """Bytes the decode of ``B`` rows of bucket ``T`` with ``K``
    candidates must move: dist (floats) and valid (1 byte) and case
    (int32) read once, route and gc only for the T-1 transitions, paths
    (B, T) int32 and scores (B,) float32 written once."""
    steps = max(T - 1, 0)
    per_row = (T * K * (float_bytes + 1)
               + steps * (K * K * float_bytes + float_bytes)
               + T * 4)
    return B * (per_row + T * 4 + 4)


def wire_ops(B: int, T: int, K: int) -> int:
    """float32 operations of the decode: per (t, i, j) a subtract, abs,
    divide, reachability compare, add and max compare; per (t, j) a
    divide, two multiplies and an add."""
    return B * (T - 1) * K * K * 6 + B * T * K * 4


def bound_s(B: int, T: int, K: int, float_bytes: int = 2) -> float:
    """The least time for the decode's bytes and operations: the larger
    of bytes over peak bandwidth and operations over peak rate."""
    return max(wire_bytes(B, T, K, float_bytes) / HBM_BYTES_PER_S,
               wire_ops(B, T, K) / F32_OPS_PER_S)
