"""The Viterbi decode's step for N carried traces: build, bind, launch.

The incremental streaming decode (``matcher/incremental.py``) carries each
uuid's last-step scores between reports and advances them by the kept
points appended since. This module holds that step:

- :func:`incremental_step_plain`, the plain PyTorch version of one step:
  one step of ``matcher/hmm.py``'s scan (``emission_scores``,
  ``transition_scores``, then the max and first-index argmax over the
  previous candidates and the RESTART select). It is the CPU path and the
  card's reference; :func:`incremental_steps_plain` runs it round after
  round, the scores carried, each row for its own number of rounds.
- :func:`incremental_steps_cuda`, the wrapper of the CUDA kernel
  ``incremental_steps`` in ``csrc/viterbi.cu``, which it shares with the
  batched decode (``ops/viterbi.py`` builds and loads the library): R
  rounds of N rows in one launch. It checks its tensors, launches the
  kernel or raises, and counts launches in
  ``incremental_steps_cuda.launches``. :func:`incremental_step_cuda` is
  its one round (R = 1), for the one-step contract.

The kernel replaces the JAX package's XLA program
``reporter_tpu/ops/incremental.py::incremental_step_batch`` (:50). Per
row it computes ``cand[i, j] = prev[i] + tr[i, j]``, ``bp[j]`` the first
maximal i, ``new_scores[j] = case == RESTART ? max(prev) + em[j] :
max_i cand[i, j] + em[j]`` and ``prev_best`` the first maximal index of
``prev``, and carries ``new_scores`` into the next round. Its bound is
bytes: a row's round reads ``K*K*4 + K*9 + 8`` bytes and writes ``K*8 +
4`` (at N=512, K=8, one round, 206,848 bytes, 0.062 us at 3.35 TB/s);
what a launch costs in practice is its fixed part and one round's chain.
Its design (csrc/viterbi.cu, "incremental_step"): for K <= 32 a segment
of K lanes (rounded up to a power of two) a row, several rows a warp, the
previous scores in registers and exchanged by warp shuffles, every load
of a round started before its chain and the next round's during it; past
32 candidates a block per row.

Maxima follow the JAX step's reduction as XLA compiles it on the CPU,
which both versions repeat bit for bit: of equal values it keeps the
later, which shows only in a zero's sign (``max(+0.0, -0.0)`` is -0.0,
``max(-0.0, +0.0)`` is +0.0; an on-edge point scores -0.0).
``torch.amax`` makes no promise about it, so the plain version takes the
value at the last maximal index.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..matcher.hmm import RESTART, emission_scores, transition_scores
from . import nvcc, viterbi

#: the most candidates the kernel takes (a block of K threads a row, past
#: the 32 a warp packs)
MAX_K = 128

_lock = threading.Lock()
_kernel = None  # ctypes function once bound


def _max_last(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The max of ``x`` over ``dim`` as the JAX step reduces it: the value
    at the last maximal index."""
    last = x.shape[dim] - 1 - torch.argmax(torch.flip(x, [dim]), dim)
    return torch.gather(x, dim, last.unsqueeze(dim)).squeeze(dim)


def incremental_step_plain(dist_m: torch.Tensor, valid: torch.Tensor,
                           route_m: torch.Tensor, gc_m: torch.Tensor,
                           case: torch.Tensor, prev_scores: torch.Tensor,
                           sigma, beta):
    """Advance N carried traces by one appended kept point.

    Shapes: dist_m (N, K) f32 (or f16) point-to-edge distances, valid
    (N, K) bool, route_m (N, K, K) route distances from each trace's
    previous kept point, gc_m (N,) great-circle distances, case (N,) int
    case codes, prev_scores (N, K) f32 carried scores; sigma and beta
    scalars. Returns (new_scores (N, K) f32, bp (N, K) int32, prev_best
    (N,) int32) on the tensors' device.

    A window's first kept point is the same call with case RESTART and
    prev_scores 0: ``max(0) + em`` is the scan's first row.
    """
    case = case.to(torch.int32)
    em = emission_scores(dist_m[:, None], valid[:, None], case[:, None],
                         sigma)[:, 0]
    tr = transition_scores(route_m[:, None], gc_m[:, None], case[:, None],
                           beta)[:, 0]
    cand = prev_scores[:, :, None] + tr                    # (N, Kp, Kc)
    bp = torch.argmax(cand, dim=1)
    stepped = _max_last(cand, 1) + em
    prev_best = torch.argmax(prev_scores, dim=1)
    restarted = _max_last(prev_scores, 1)[:, None] + em
    new_scores = torch.where((case == RESTART)[:, None], restarted, stepped)
    return new_scores, bp.to(torch.int32), prev_best.to(torch.int32)


def build():
    """The kernel's entry point ``incremental_steps``, from the decode's
    library (``csrc/viterbi.cu``, compiled once per source version by
    ``ops.nvcc``); raises if the build fails."""
    global _kernel
    with _lock:
        if _kernel is None:
            lib, _log = nvcc.load(viterbi.SOURCE, "viterbi")
            fn = lib.incremental_steps
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            fn.argtypes = [p, p, p, p, p, p, p, i, i, i, f, f, p, p, p, p]
            fn.restype = i
            _kernel = fn
        return _kernel


def incremental_steps_plain(dist_m, valid, route_m, gc_m, case,
                            prev_scores, n_steps, sigma, beta):
    """R rounds of :func:`incremental_step_plain`, the scores carried.

    Shapes: dist_m (R, N, K), valid (R, N, K), route_m (R, N, K, K), gc_m
    (R, N), case (R, N) each round's operands; prev_scores (N, K) the
    scores before round 0; n_steps (N,) each row's rounds (a count past
    R runs R, one below 0 none).
    Returns (new_scores (R, N, K) f32, bp (R, N, K) int32, prev_best
    (R, N) int32): round r's outputs, zeros in a row's rounds at and past
    its step count."""
    R, N, K = dist_m.shape
    dev = dist_m.device
    scores = torch.zeros((R, N, K), dtype=torch.float32, device=dev)
    bp = torch.zeros((R, N, K), dtype=torch.int32, device=dev)
    prev_best = torch.zeros((R, N), dtype=torch.int32, device=dev)
    prev = prev_scores
    for r in range(R):
        act = n_steps.to(dev) > r
        s, b, pb = incremental_step_plain(dist_m[r], valid[r], route_m[r],
                                          gc_m[r], case[r], prev, sigma,
                                          beta)
        scores[r] = torch.where(act[:, None], s, scores[r])
        bp[r] = torch.where(act[:, None], b, bp[r])
        prev_best[r] = torch.where(act, pb, prev_best[r])
        prev = s
    return scores, bp, prev_best


def output_words(N: int, K: int, R: int = 1) -> int:
    """int32 words of the kernel's one output buffer for R rounds:
    new_scores' bits (R*N*K), bp (R*N*K), prev_best (R*N)."""
    return R * N * (2 * K + 1)


def incremental_steps_cuda(dist_m: torch.Tensor, valid: torch.Tensor,
                           route_m: torch.Tensor, gc_m: torch.Tensor,
                           case: torch.Tensor, prev_scores: torch.Tensor,
                           n_steps: "torch.Tensor | None", sigma, beta,
                           out: "torch.Tensor | None" = None):
    """Launch the CUDA kernel on CUDA tensors: R rounds in one launch,
    :func:`incremental_steps_plain`'s contract, f32 only; ``n_steps``
    int32 (None: R rounds every row). ``out`` is an int32 tensor of
    ``output_words(N, K, R)`` on the device (allocated when None) that
    the kernel fills with new_scores' bits, bp and prev_best in that
    order, so a caller reads all three back in one copy; the returned
    tensors are views of it. Raises on any input the kernel does not
    take."""
    if dist_m.dim() != 3:
        raise ValueError(f"dist_m must be (R, N, K), got "
                         f"{tuple(dist_m.shape)}")
    R, N, K = dist_m.shape
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K} outside 1..{MAX_K}: the incremental step "
                         f"takes at most {MAX_K} candidates")
    dev = dist_m.device
    if out is None:
        out = torch.empty(output_words(N, K, R), dtype=torch.int32,
                          device=dev)
    steps = {} if n_steps is None else {"n_steps": n_steps}
    nvcc.check_operands(dev, dist_m=dist_m, valid=valid, route_m=route_m,
                        gc_m=gc_m, case=case, prev_scores=prev_scores,
                        out=out, **steps)
    if any(t.dtype != torch.float32
           for t in (dist_m, route_m, gc_m, prev_scores)):
        raise TypeError("dist_m, route_m, gc_m and prev_scores must be "
                        "float32")
    if valid.dtype != torch.bool or case.dtype != torch.int32 or \
            out.dtype != torch.int32 or \
            (n_steps is not None and n_steps.dtype != torch.int32):
        raise TypeError("valid must be bool, case, n_steps and out int32")
    if tuple(valid.shape) != (R, N, K) \
            or tuple(route_m.shape) != (R, N, K, K) \
            or tuple(gc_m.shape) != (R, N) or tuple(case.shape) != (R, N) \
            or tuple(prev_scores.shape) != (N, K) \
            or (n_steps is not None and tuple(n_steps.shape) != (N,)) \
            or tuple(out.shape) != (output_words(N, K, R),):
        raise ValueError(
            f"unsupported shapes dist {tuple(dist_m.shape)} valid "
            f"{tuple(valid.shape)} route {tuple(route_m.shape)} gc "
            f"{tuple(gc_m.shape)} case {tuple(case.shape)} prev "
            f"{tuple(prev_scores.shape)} out {tuple(out.shape)}")
    launch((dist_m, valid, route_m, gc_m, case, prev_scores), n_steps,
           sigma, beta, out)
    incremental_steps_cuda.launches += 1
    RNK = R * N * K
    return (out[:RNK].view(torch.float32).view(R, N, K),
            out[RNK:2 * RNK].view(R, N, K), out[2 * RNK:].view(R, N))


incremental_steps_cuda.launches = 0


def incremental_step_cuda(dist_m: torch.Tensor, valid: torch.Tensor,
                          route_m: torch.Tensor, gc_m: torch.Tensor,
                          case: torch.Tensor, prev_scores: torch.Tensor,
                          sigma, beta, out: "torch.Tensor | None" = None):
    """One round of :func:`incremental_steps_cuda` (every row steps): the
    plain :func:`incremental_step_plain`'s contract, f32 only. ``out`` is
    an int32 tensor of ``output_words(N, K)`` on the device (allocated
    when None); the returned tensors are views of it."""
    if dist_m.dim() != 2:
        raise ValueError(f"dist_m must be (N, K), got {tuple(dist_m.shape)}")
    scores, bp, prev_best = incremental_steps_cuda(
        *(t.unsqueeze(0) for t in (dist_m, valid, route_m, gc_m, case)),
        prev_scores, None, sigma, beta, out=out)
    return scores[0], bp[0], prev_best[0]


def launch(inputs, n_steps, sigma, beta, out: torch.Tensor) -> None:
    """Enqueue one kernel launch on the current stream, uncounted and
    unchecked: ``inputs`` as :func:`incremental_steps_cuda` has validated
    them ((R, N, ...) operands and the (N, K) scores), ``n_steps`` int32 or
    None, ``out`` the output buffer. Timing loops call this."""
    dist_m, valid, route_m, gc_m, case, prev_scores = inputs
    R, N, K = dist_m.shape
    fn = build()
    with torch.cuda.device(dist_m.device):
        stream = torch.cuda.current_stream(dist_m.device).cuda_stream
        err = fn(dist_m.data_ptr(), valid.data_ptr(), route_m.data_ptr(),
                 gc_m.data_ptr(), case.data_ptr(), prev_scores.data_ptr(),
                 None if n_steps is None else n_steps.data_ptr(), R, N, K,
                 float(sigma), float(beta), out.data_ptr(),
                 out.data_ptr() + 4 * R * N * K,
                 out.data_ptr() + 8 * R * N * K, stream)
    if err != 0:
        raise RuntimeError(f"incremental_steps launch failed: CUDA error "
                           f"{err}")
