"""HMM scoring and the plain batched Viterbi decode, in PyTorch.

- emission score of candidate k at point t: log N(dist | 0, sigma_z)
  with constants dropped -> ``-0.5 * (d / sigma)^2``
- transition score between candidates (i, j) of consecutive points:
  ``-|route_dist - great_circle| / beta`` (exponential deviation model)
- Viterbi decode as a Python loop over time, vectorised over the batch.

Everything is fixed-shape: traces padded to T points, K candidates. Control
flow that depends on data is encoded host-side as a per-point ``case``
tensor:

  NORMAL  — standard Viterbi step
  RESTART — chain restarts here (first kept point, or after a breakage
            split; reference knob ``breakage_distance``)
  SKIP    — padding tail; state passes through untouched

so each step is branch-free ``torch.where`` selects.

:func:`viterbi_decode_batch` is the plain version of the CUDA decode
kernel (ops/csrc/viterbi.cu): the CPU path runs it, and the card's kernel
is held against it. Its float operations and their order are the JAX
scan's (``-0.5 * z * z``, ``(prev + tr)`` then ``+ em``), so on the CPU
its paths and scores are bit-equal to that scan.
"""
from __future__ import annotations

import torch

NEG_INF = -1.0e30
NORMAL, RESTART, SKIP = 0, 1, 2
# route distances at/above this threshold are "no route found within bound"
UNREACHABLE_THRESHOLD = 0.5e9
# largest finite distance the f16 wire format ships (sentinels above
# UNREACHABLE_THRESHOLD travel as +inf). Bounded at 4096 m so the f16 ulp
# stays <= 2 m (<= 1 m rounding). Batches with finite distances beyond
# this ship f32 instead (batchpad.pack_batches).
WIRE_MAX_M = 4.096e3


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor on ``like``'s device: a true f32 division by a
    tensor, never a Python-scalar fast path that may multiply by a
    reciprocal instead."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def emission_scores(dist_m: torch.Tensor, valid: torch.Tensor,
                    case: torch.Tensor, sigma) -> torch.Tensor:
    """(..., T, K) emission log-scores.

    ``dist_m`` point->edge distances (f16 wire or f32), ``valid`` candidate
    mask, ``case`` per-point case codes (..., T), ``sigma`` the scalar
    effective sigma_z. SKIP rows become all-zero so they never poison the
    running scores.
    """
    dist_m = dist_m.to(torch.float32)
    z = dist_m / _scalar(sigma, dist_m)
    scores = torch.where(valid, -0.5 * z * z, NEG_INF)
    return torch.where((case == SKIP)[..., None], 0.0, scores)


def transition_scores(route_m: torch.Tensor, gc_m: torch.Tensor,
                      case_to: torch.Tensor, beta) -> torch.Tensor:
    """(..., T-1, K, K) transition log-scores for steps into points 1..T-1.

    Steps into a SKIP point use the identity matrix (0 on the diagonal,
    NEG_INF off it) so the chain state is carried through unchanged. Steps
    into a RESTART point are zeroed. Unreachable route distances (the f16
    wire carries them as +inf) become NEG_INF.
    """
    K = route_m.shape[-1]
    route_m = route_m.to(torch.float32)
    gc_m = gc_m.to(torch.float32)
    dev = torch.abs(route_m - gc_m[..., None, None])
    scores = torch.where(route_m < UNREACHABLE_THRESHOLD,
                         -dev / _scalar(beta, dev), NEG_INF)
    eye = torch.eye(K, dtype=torch.bool, device=route_m.device)
    identity = torch.where(eye, 0.0, NEG_INF).to(torch.float32)
    scores = torch.where((case_to == SKIP)[..., None, None], identity, scores)
    return torch.where((case_to == RESTART)[..., None, None], 0.0, scores)


def trim_time_pad(dist_m, route_m, gc_m):
    """Accept route/gc with T time rows (a dead trailing step) or the
    classic T-1 rows; return (T-1)-row views."""
    Tm1 = dist_m.shape[-2] - 1
    if route_m.shape[-3] == Tm1 + 1:
        route_m = route_m[..., :Tm1, :, :]
        gc_m = gc_m[..., :Tm1]
    return route_m, gc_m


def viterbi_decode_batch(dist_m: torch.Tensor, valid: torch.Tensor,
                         route_m: torch.Tensor, gc_m: torch.Tensor,
                         case: torch.Tensor, sigma, beta):
    """Decode a padded batch of traces.

    Shapes: dist_m (B,T,K) f32 or f16; valid (B,T,K) bool; route_m
    (B,T-1,K,K) (or (B,T,K,K) with a dead last step — see trim_time_pad);
    gc_m (B,T-1) (or (B,T)); case (B,T) int; sigma, beta scalars.
    Returns (paths (B,T) int32 candidate indices, scores (B,) f32).

    Ties break to the lowest index (``torch.argmax`` returns the first
    maximal index, like ``jnp.argmax``).
    """
    route_m, gc_m = trim_time_pad(dist_m, route_m, gc_m)
    case = case.to(torch.int32)
    em = emission_scores(dist_m, valid, case, sigma)            # (B, T, K)
    tr = transition_scores(route_m, gc_m, case[:, 1:], beta)    # (B, T-1, K, K)
    B, T, K = em.shape
    bps = torch.empty((B, max(T - 1, 0), K), dtype=torch.int64,
                      device=em.device)
    prev_bests = torch.empty((B, max(T - 1, 0)), dtype=torch.int64,
                             device=em.device)
    scores = em[:, 0]
    for t in range(T - 1):
        cand = scores[:, :, None] + tr[:, t]                    # (B, Kp, Kc)
        best = torch.amax(cand, dim=1)
        bps[:, t] = torch.argmax(cand, dim=1)
        stepped = best + em[:, t + 1]
        # a restart carries the finished chain's best score as a constant
        # offset (argmax-invariant) so the final score is the total over
        # all chains
        restarted = torch.amax(scores, dim=1, keepdim=True) + em[:, t + 1]
        prev_bests[:, t] = torch.argmax(scores, dim=1)
        scores = torch.where((case[:, t + 1] == RESTART)[:, None],
                             restarted, stepped)

    paths = torch.empty((B, T), dtype=torch.int64, device=em.device)
    cur = torch.argmax(scores, dim=1)
    paths[:, T - 1] = cur
    for t in range(T - 2, -1, -1):
        via_bp = torch.gather(bps[:, t], 1, cur[:, None])[:, 0]
        cur = torch.where(case[:, t + 1] == RESTART, prev_bests[:, t], via_bp)
        paths[:, t] = cur
    return paths.to(torch.int32), torch.amax(scores, dim=1)
