"""Vectorised text for the probe formats: fixed-width ASCII columns built
as byte matrices, so a few million lines take a fraction of a second.

Numbers are zero-padded to a fixed width ("0014.612345"), which every
parser of the formats reads as the same value (``float``, ``int``).
"""
from __future__ import annotations

import numpy as np

_ZERO = ord("0")


def digits(values: np.ndarray, width: int) -> np.ndarray:
    """(n, width) ASCII digits of non-negative integers, zero-padded;
    a value that does not fit raises."""
    v = np.asarray(values, dtype=np.int64)
    if v.size and (v.min() < 0 or v.max() >= 10 ** width):
        raise ValueError(f"values out of range for {width} digits")
    out = np.empty((v.size, width), np.uint8)
    for k in range(width - 1, -1, -1):
        out[:, k] = _ZERO + v % 10
        v = v // 10
    return out


def fixed(values: np.ndarray, int_width: int, decimals: int) -> np.ndarray:
    """(n, w) ASCII of signed decimals rounded to ``decimals`` places:
    a sign column ('-' or '0'), ``int_width`` digits, '.', decimals."""
    x = np.asarray(values, dtype=np.float64)
    scaled = np.rint(np.abs(x) * 10 ** decimals).astype(np.int64)
    whole = digits(scaled // 10 ** decimals, int_width)
    frac = digits(scaled % 10 ** decimals, decimals)
    sign = np.where(x < 0, ord("-"), _ZERO).astype(np.uint8)[:, None]
    dot = np.full((x.size, 1), ord("."), np.uint8)
    return np.hstack([sign, whole, dot, frac])


def text(n: int, *cols: bytes | np.ndarray) -> bytes:
    """Lines of the columns in order: each column a (n, w) byte matrix
    or a bytes literal repeated on every line; each line ends in a
    newline."""
    parts = []
    for c in cols:
        if isinstance(c, (bytes, bytearray)):
            parts.append(np.frombuffer(bytes(c), np.uint8)[None, :]
                         .repeat(n, axis=0))
        else:
            parts.append(c)
    parts.append(np.full((n, 1), ord("\n"), np.uint8))
    return np.hstack(parts).tobytes()


def labels(prefix: str, ids: np.ndarray, width: int) -> np.ndarray:
    """(n, len(prefix)+width) ASCII of ``prefix`` + zero-padded ids."""
    head = np.frombuffer(prefix.encode(), np.uint8)[None, :]
    return np.hstack([head.repeat(len(ids), axis=0), digits(ids, width)])
