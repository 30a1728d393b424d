"""One step of the Viterbi decode for N carried traces: build, bind, launch.

The incremental streaming decode (``matcher/incremental.py``) carries each
uuid's last-step scores between reports and advances them by the kept
points appended since, one point per trace per launch. This module holds
that step:

- :func:`incremental_step_plain`, the plain PyTorch version: one step of
  ``matcher/hmm.py``'s scan (``emission_scores``, ``transition_scores``,
  then the max and first-index argmax over the previous candidates and
  the RESTART select). It is the CPU path and the card's reference.
- :func:`incremental_step_cuda`, the wrapper of the CUDA kernel
  ``incremental_step`` in ``csrc/viterbi.cu``, which it shares with the
  batched decode (``ops/viterbi.py`` builds and loads the library). It
  checks its tensors, launches the kernel or raises, and counts launches
  in ``incremental_step_cuda.launches``.

The kernel replaces the JAX package's XLA program
``reporter_tpu/ops/incremental.py::incremental_step_batch`` (:50). Per
row it computes ``cand[i, j] = prev[i] + tr[i, j]``, ``bp[j]`` the first
maximal i, ``new_scores[j] = case == RESTART ? max(prev) + em[j] :
max_i cand[i, j] + em[j]`` and ``prev_best`` the first maximal index of
``prev``. Its bound is bytes: a row reads ``K*K*4 + K*9 + 8`` bytes and
writes ``K*8 + 4`` (at N=512, K=8, 206,848 bytes, 0.062 us at 3.35 TB/s);
what a launch costs in practice is its fixed part. Its design is the
simple one: a block per row, a thread per candidate j walking i in
ascending order (csrc/viterbi.cu, "incremental_step").

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

#: a block of K threads, and prev staged in 128 floats of shared memory
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
    """The kernel's entry point, from the decode's library
    (``csrc/viterbi.cu``, compiled once per source version by
    ``ops.nvcc``); raises if the build fails."""
    global _kernel
    with _lock:
        if _kernel is None:
            lib, _log = nvcc.load(viterbi.SOURCE, "viterbi")
            fn = lib.incremental_step
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            fn.argtypes = [p, p, p, p, p, p, i, i, f, f, p, p, p, p]
            fn.restype = i
            _kernel = fn
        return _kernel


def output_words(N: int, K: int) -> int:
    """int32 words of the kernel's one output buffer: new_scores' bits
    (N*K), bp (N*K), prev_best (N)."""
    return N * (2 * K + 1)


def incremental_step_cuda(dist_m: torch.Tensor, valid: torch.Tensor,
                          route_m: torch.Tensor, gc_m: torch.Tensor,
                          case: torch.Tensor, prev_scores: torch.Tensor,
                          sigma, beta, out: "torch.Tensor | None" = None):
    """Launch the CUDA kernel on CUDA tensors; the plain version's
    contract, f32 only. ``out`` is an int32 tensor of
    ``output_words(N, K)`` on the device (allocated when None) that the
    kernel fills with new_scores' bits, bp and prev_best in that order, so
    a caller reads all three back in one copy; the returned tensors are
    views of it. Raises on any input the kernel does not take."""
    if dist_m.dim() != 2:
        raise ValueError(f"dist_m must be (N, K), got {tuple(dist_m.shape)}")
    N, K = dist_m.shape
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K} outside 1..{MAX_K}: the incremental step "
                         f"takes at most {MAX_K} candidates")
    dev = dist_m.device
    if out is None:
        out = torch.empty(output_words(N, K), dtype=torch.int32, device=dev)
    nvcc.check_operands(dev, dist_m=dist_m, valid=valid, route_m=route_m,
                        gc_m=gc_m, case=case, prev_scores=prev_scores,
                        out=out)
    if any(t.dtype != torch.float32
           for t in (dist_m, route_m, gc_m, prev_scores)):
        raise TypeError("dist_m, route_m, gc_m and prev_scores must be "
                        "float32")
    if valid.dtype != torch.bool or case.dtype != torch.int32 or \
            out.dtype != torch.int32:
        raise TypeError("valid must be bool, case and out int32")
    if tuple(valid.shape) != (N, K) or tuple(route_m.shape) != (N, K, K) \
            or tuple(gc_m.shape) != (N,) or tuple(case.shape) != (N,) \
            or tuple(prev_scores.shape) != (N, K) \
            or tuple(out.shape) != (output_words(N, K),):
        raise ValueError(
            f"unsupported shapes dist {tuple(dist_m.shape)} valid "
            f"{tuple(valid.shape)} route {tuple(route_m.shape)} gc "
            f"{tuple(gc_m.shape)} case {tuple(case.shape)} prev "
            f"{tuple(prev_scores.shape)} out {tuple(out.shape)}")
    launch((dist_m, valid, route_m, gc_m, case, prev_scores), sigma, beta,
           out)
    incremental_step_cuda.launches += 1
    return (out[:N * K].view(torch.float32).view(N, K),
            out[N * K:2 * N * K].view(N, K), out[2 * N * K:])


incremental_step_cuda.launches = 0


def launch(inputs, sigma, beta, out: torch.Tensor) -> None:
    """Enqueue one kernel launch on the current stream, uncounted and
    unchecked: ``inputs`` as :func:`incremental_step_cuda` has validated
    them, ``out`` the output buffer. Timing loops call this."""
    dist_m, valid, route_m, gc_m, case, prev_scores = inputs
    N, K = dist_m.shape
    fn = build()
    with torch.cuda.device(dist_m.device):
        stream = torch.cuda.current_stream(dist_m.device).cuda_stream
        err = fn(dist_m.data_ptr(), valid.data_ptr(), route_m.data_ptr(),
                 gc_m.data_ptr(), case.data_ptr(), prev_scores.data_ptr(),
                 N, K, float(sigma), float(beta), out.data_ptr(),
                 out.data_ptr() + 4 * N * K, out.data_ptr() + 8 * N * K,
                 stream)
    if err != 0:
        raise RuntimeError(f"incremental_step launch failed: CUDA error "
                           f"{err}")
