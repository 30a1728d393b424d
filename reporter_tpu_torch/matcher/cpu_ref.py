"""Pure-numpy single-trace Viterbi: an oracle independent of the decodes.

The port of ``reporter_tpu/matcher/cpu_ref.py``. It decodes one trace at
a time on the host, with no torch and no batching, and is an
implementation independent of the plain scan (``matcher/hmm.py``), the
associative scan and the card's kernel. Its one caller is the bigreplay
harness (``tools/bigreplay.py``), which scores the serving decode's
segment ids against it. No serving, streaming or pipeline path calls
it: the port never degrades a decode to the host.

Semantics mirror ``matcher/hmm.py`` exactly: emission
``-0.5*(d/sigma)^2`` (invalid candidates -inf), transition
``-|route-gc|/beta`` (unreachable -inf), SKIP steps carry state through
the identity, RESTART steps start a new chain carrying the finished
chain's best score as a constant offset.
"""
from __future__ import annotations

import numpy as np

from .hmm import NEG_INF, RESTART, SKIP, UNREACHABLE_THRESHOLD


def viterbi_decode_numpy(dist_m, valid, route_m, gc_m, case, sigma, beta):
    """Decode ONE trace; shapes (T,K), (T,K), (T-1,K,K), (T-1,), (T,).

    Returns (path (T,) i32, score f32) with the same contract as one row
    of ``hmm.viterbi_decode_batch``.
    """
    dist_m = np.asarray(dist_m, dtype=np.float32)
    route_m = np.asarray(route_m, dtype=np.float32)
    gc_m = np.asarray(gc_m, dtype=np.float32)
    case = np.asarray(case)
    T, K = dist_m.shape

    em = np.where(valid, -0.5 * (dist_m / np.float32(sigma)) ** 2, NEG_INF)
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
            tr_t = np.where(route_m[t - 1] < UNREACHABLE_THRESHOLD,
                            -dev / np.float32(beta), NEG_INF)
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


def decode_chunk_numpy(batch, sigma, beta) -> np.ndarray:
    """Every real row of a ``batchpad.PaddedBatch`` through
    :func:`viterbi_decode_numpy`: (B, T) int32 paths, filler rows left 0
    (assembly never reads them). Reads the tensors the decode would read;
    the native prep's dead trailing time row of route and gc is cut to the
    documented T-1."""
    dist = np.asarray(batch.dist_m, dtype=np.float32)
    valid = np.asarray(batch.valid)
    T = dist.shape[1]
    route = np.asarray(batch.route_m[:, :max(T - 1, 0)], dtype=np.float32)
    gc = np.asarray(batch.gc_m[:, :max(T - 1, 0)], dtype=np.float32)
    case = np.asarray(batch.case)
    out = np.zeros(dist.shape[:2], dtype=np.int32)
    for b in range(len(batch.traces)):
        out[b], _score = viterbi_decode_numpy(
            dist[b], valid[b], route[b], gc[b], case[b], sigma, beta)
    return out
