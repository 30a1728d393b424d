"""The associative-scan Viterbi decode, in PyTorch ops.

The same decode as ``matcher/hmm.py``'s scan, over the **max-plus
semiring**, where a Viterbi step is a matrix "product":

    (A @ B)[i, j] = max_k (A[i, k] + B[k, j])

Step matrices ``M_t[i, j] = transition[t][i, j] + emission[t + 1][j]``
compose associatively, so every prefix score vector comes out of one
associative scan over the time axis: O(log T) dependent levels instead of
T. A RESTART step's matrix is constant over i and a SKIP step's is the
max-plus identity; both are what ``transition_scores`` already emits, so
``M = tr + em[1:, None, :]`` holds for every case. Backpointers are
recomputed from the prefix scores in one batched argmax, and the
backtrace composes the per-step index maps by a second associative scan
(integer gathers, exact in any order).

The prefix products use a copy of the recursion of
``jax.lax.associative_scan`` (pairs ``[0:-1:2]`` with ``[1::2]``, recurse,
combine the odd prefixes with ``elems[2::2]``, prepend ``elems[0]``,
interleave), and its interleave adds 0.0 as that one pads and adds. Each
max-plus entry is one f32 add and an exact max, so with the same tree
the paths and scores here are bit-equal to the JAX package's
``ops.assoc_viterbi.viterbi_assoc_batch``; against the sequential scan
they agree in path quality, and may differ only where f32 order flips an
exact score tie.

Work is O(T K^3) against the scan's O(T K^2). The first level's
(B, (T-1)/2, K, K, K) broadcast temporary is 535 MB at (512, 1024, 8) in
f32, so :func:`viterbi_assoc_batch` decodes in slices of rows whose
temporary stays within ``TEMP_BYTES`` (rows are independent: the slices
change no result).

These are torch ops on the tensors' device, not a hand kernel: the JAX
package's module is a jitted XLA program, not a ``pl.pallas_call``, and
here it is an opt-in decode (``SegmentMatcher(decode="assoc")``) beside
the CUDA kernel ``viterbi_decode``, which stays the card's default. A
hand kernel waits until a workload asks for ``assoc`` on the card.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..matcher.hmm import (RESTART, emission_scores, transition_scores,
                           trim_time_pad)

#: the most bytes one slice's max-plus broadcast temporary may take
TEMP_BYTES = 256 << 20


def _maxplus_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., K, K) max-plus product: (a @ b)[i,j] = max_k a[i,k] + b[k,j].

    The broadcast sum is indexed (..., i, k, j); the contraction axis k is
    axis -2."""
    return torch.amax(a[..., :, :, None] + b[..., None, :, :], dim=-2)


def step_matrices(em: torch.Tensor, tr: torch.Tensor) -> torch.Tensor:
    """(..., T-1, K, K) composable step matrices from emission (..., T, K)
    and transition (..., T-1, K, K) scores."""
    return tr + em[..., 1:, None, :]


def _interleave(even: torch.Tensor, odd: torch.Tensor,
                zero) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along axis 1 (``even`` as long as
    ``odd`` or one longer). ``zero`` is added to each element, as the JAX
    interleave adds its two zero-padded halves (-0.0 comes out +0.0);
    None for integer maps."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n, *even.shape[2:]))
    out[:, 0::2] = even if zero is None else even + zero
    out[:, 1::2] = odd if zero is None else odd + zero
    return out


def associative_scan(combine: Callable, elems: torch.Tensor,
                     zero=0.0) -> torch.Tensor:
    """Inclusive prefix scan of ``elems`` along axis 1 by an associative
    ``combine``, in ``jax.lax.associative_scan``'s order of combination."""
    n = elems.shape[1]
    if n < 2:
        return elems
    odd = associative_scan(
        combine, combine(elems[:, 0:-1:2], elems[:, 1::2]), zero)
    even = combine(odd[:, :-1] if n % 2 == 0 else odd, elems[:, 2::2])
    even = torch.cat([elems[:, :1], even], dim=1)
    return _interleave(even, odd, zero)


def _compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Index maps (..., K): apply ``a`` then ``b`` (``b[a[j]]``)."""
    return torch.gather(b, -1, a)


def _decode(em: torch.Tensor, tr: torch.Tensor, case: torch.Tensor):
    """Paths and scores of one slice of rows: em (B, T, K), tr
    (B, T-1, K, K), case (B, T)."""
    B, T, K = em.shape
    if T == 1:
        return (torch.argmax(em[:, 0], dim=1).to(torch.int32)[:, None],
                torch.amax(em[:, 0], dim=1))
    M = step_matrices(em, tr)                                # (B, T-1, K, K)
    P = associative_scan(_maxplus_matmul, M)
    init = em[:, 0]                                          # (B, K)
    prefix = torch.amax(init[:, None, :, None] + P, dim=2)   # (B, T-1, K)
    scores = torch.cat([init[:, None], prefix], dim=1)       # (B, T, K)

    cand = scores[:, :-1, :, None] + tr                      # (B, T-1, K, K)
    bps = torch.argmax(cand, dim=2)                          # (B, T-1, K)
    prev_bests = torch.argmax(scores[:, :-1], dim=2)         # (B, T-1)
    last = torch.argmax(scores[:, -1], dim=1)                # (B,)
    # step t's index map: the candidate at t given the one at t+1
    maps = torch.where((case[:, 1:] == RESTART)[:, :, None],
                       prev_bests[:, :, None], bps)
    # suffix compositions, latest step first: path[t] = map_t(...(last))
    suffix = associative_scan(_compose, maps.flip(1), None).flip(1)
    rest = torch.gather(suffix, 2,
                        last[:, None, None].expand(B, T - 1, 1))[:, :, 0]
    paths = torch.cat([rest, last[:, None]], dim=1)
    return paths.to(torch.int32), torch.amax(scores[:, -1], dim=1)


def rows_per_slice(T: int, K: int) -> int:
    """Rows one slice decodes so that its first-level broadcast temporary,
    (T/2 pairs of K^3 f32 each a row), fits ``TEMP_BYTES`` (at least 1)."""
    per_row = max(1, T // 2) * K ** 3 * 4
    return max(1, TEMP_BYTES // per_row)


def viterbi_assoc_batch(dist_m: torch.Tensor, valid: torch.Tensor,
                        route_m: torch.Tensor, gc_m: torch.Tensor,
                        case: torch.Tensor, sigma, beta):
    """Batched decode by the associative scan, on the tensors' device;
    the contract of ``matcher.hmm.viterbi_decode_batch``: dist_m (B,T,K)
    f16 or f32, valid (B,T,K) bool, route_m (B,T-1|T,K,K), gc_m
    (B,T-1|T), case (B,T) int, sigma and beta scalars. Returns (paths
    (B,T) int32, scores (B,) f32), the total score over all chains."""
    route_m, gc_m = trim_time_pad(dist_m, route_m, gc_m)
    case = case.to(torch.int32)
    B, T, K = dist_m.shape
    step = rows_per_slice(T, K)
    paths, scores = [], []
    for lo in range(0, B, step):
        hi = min(B, lo + step)
        em = emission_scores(dist_m[lo:hi], valid[lo:hi], case[lo:hi], sigma)
        tr = transition_scores(route_m[lo:hi], gc_m[lo:hi],
                               case[lo:hi, 1:], beta)
        p, s = _decode(em, tr, case[lo:hi])
        paths.append(p)
        scores.append(s)
    if len(paths) == 1:
        return paths[0], scores[0]
    return torch.cat(paths), torch.cat(scores)


__all__ = ["viterbi_assoc_batch", "step_matrices", "associative_scan",
           "rows_per_slice", "TEMP_BYTES"]
