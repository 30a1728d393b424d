"""Frozen copy of the port's single-trace numpy Viterbi
(``reporter_tpu_torch/matcher/cpu_ref.py`` ``viterbi_decode_numpy``), with
the wire's rounding and the control's lower precision.

Semantics: emission ``-0.5*(d/sigma)^2`` (invalid candidates -inf),
transition ``-|route-gc|/beta`` (unreachable -inf), SKIP steps carry state
through the identity, RESTART steps start a new chain carrying the
finished chain's best score as a constant offset.

``precision`` is that of the wire, the distances the decode reads; the
scores are float32 either way. ``"float16"`` is what the configuration
states: float16 where every finite distance of the trace fits
(``WIRE_MAX_M``), else float32, as the port packs it. ``"float8_e5m2"`` is
the control, the nearest precision below: the 8-bit float whose range
covers the wire's (e4m3 saturates at 448 m).
"""
from __future__ import annotations

import numpy as np

from .consts import NEG_INF, RESTART, SKIP, UNREACHABLE_THRESHOLD

PRECISIONS = ("float16", "float8_e5m2")


def on_wire(dist_m, route_m, gc_m, f16: bool, precision: str):
    """The decode's inputs as the wire carries them, as float32."""
    arrays = [np.asarray(a, np.float32) for a in (dist_m, route_m, gc_m)]
    if precision == "float8_e5m2":
        import torch
        return tuple(torch.from_numpy(a).to(torch.float8_e5m2)
                     .to(torch.float32).numpy() for a in arrays)
    if precision != "float16":
        raise ValueError(f"unknown precision {precision!r}")
    if not f16:
        return tuple(arrays)
    with np.errstate(over="ignore"):  # the sentinels overflow to +inf
        return tuple(a.astype(np.float16).astype(np.float32)
                     for a in arrays)


def viterbi_decode_numpy(dist_m, valid, route_m, gc_m, case, sigma, beta):
    """Decode ONE trace; shapes (T,K), (T,K), (T-1,K,K), (T-1,), (T,).
    Returns (path (T,) i32, score f32)."""
    dist_m = np.asarray(dist_m, dtype=np.float32)
    route_m = np.asarray(route_m, dtype=np.float32)
    gc_m = np.asarray(gc_m, dtype=np.float32)
    case = np.asarray(case)
    T, K = dist_m.shape

    with np.errstate(over="ignore", invalid="ignore"):
        em = np.where(valid, -0.5 * (dist_m / np.float32(sigma)) ** 2,
                      NEG_INF).astype(np.float32)
    em[case == SKIP] = 0.0

    identity = np.where(np.eye(K, dtype=bool), 0.0, NEG_INF).astype(np.float32)

    scores = em[0].copy()
    bps = np.empty((T - 1, K), dtype=np.int32)
    prev_bests = np.empty(T - 1, dtype=np.int32)
    for t in range(1, T):
        if case[t] == SKIP:
            tr_t = identity
        elif case[t] == RESTART:
            tr_t = np.zeros((K, K), dtype=np.float32)
        else:
            dev = np.abs(route_m[t - 1] - gc_m[t - 1])
            with np.errstate(invalid="ignore"):
                tr_t = np.where(route_m[t - 1] < UNREACHABLE_THRESHOLD,
                                -dev / np.float32(beta),
                                NEG_INF).astype(np.float32)
        cand = scores[:, None] + tr_t
        best = cand.max(axis=0)
        bps[t - 1] = cand.argmax(axis=0)
        prev_bests[t - 1] = int(scores.argmax())
        stepped = best + em[t]
        if case[t] == RESTART:
            scores = scores.max() + em[t]
        else:
            scores = stepped

    path = np.empty(T, dtype=np.int32)
    path[-1] = int(scores.argmax())
    for t in range(T - 1, 0, -1):
        if case[t] == RESTART:
            path[t - 1] = prev_bests[t - 1]
        else:
            path[t - 1] = bps[t - 1][path[t]]
    return path, np.float32(scores.max())
