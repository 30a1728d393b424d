"""The batched Viterbi decode kernel: build, bind, launch.

``csrc/viterbi.cu`` is a hand-written CUDA C++ kernel for Hopper
(``sm_90a``) with a plain C entry point. It is compiled with ``nvcc`` into
``reporter_tpu_torch/_build/`` at first use, never at import, and loaded
with ``ctypes`` (``ops.nvcc``). Its plain version is the PyTorch scan
:func:`reporter_tpu_torch.matcher.hmm.viterbi_decode_batch`.

:func:`viterbi_cuda` is the kernel's wrapper: it checks its tensors,
launches the kernel or raises, and counts launches in
``viterbi_cuda.launches``. ``ops.decode_batch`` sends CPU tensors to the
plain version and CUDA tensors here.

:func:`launch_plan` decides the launch (lanes per trace, traces per
block, chunk steps, dynamic shared memory, grid) on the host, so the CPU
tests can pin it. The C entry point takes the chunk steps, shared bytes
and grid, refuses shared bytes that differ from the kernel's own layout
(so the two copies of the layout cannot drift apart unseen on the card),
and launches what it is given.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from ..matcher.hmm import viterbi_decode_batch as viterbi_plain
from . import nvcc

SOURCE = nvcc.CSRC / "viterbi.cu"
#: uint8 backpointers: one trace's (T-1)*K bytes at T=1024 fit one block
MAX_K = 128
#: shared memory one block may use on Hopper
SMEM_MAX = 232_448
#: f32 transition bytes scored per trace per chunk (32 steps at K=8); at
#: K <= SMALL_K a chunk has at least MIN_CHUNK steps where that fits
CHUNK_BYTES = 8_192
MIN_CHUNK = 8


class LaunchPlan(NamedTuple):
    lanes: int              # lanes per trace: a warp
    traces_per_block: int   # one
    chunk_steps: int        # C: time steps staged and scored at a time
    smem_bytes: int         # dynamic shared memory per block
    grid: int               # blocks: one per trace


def group_width(K: int) -> int:
    """G: the next power of two >= K, at least 8, capped at 32."""
    return 8 if K <= 8 else 16 if K <= 16 else 32


def _round16(n: int) -> int:
    return (n + 15) & ~15


#: up to this K one lane's candidates are one tile, and the transitions
#: are stored transposed (csrc/viterbi.cu `SMALL_K`)
SMALL_K = 32


def tr_bytes_per_step(K: int) -> int:
    """f32 transition bytes one staged step takes in shared memory."""
    G = group_width(K)
    return G * G * 4 if K <= SMALL_K else K * K * 4


def bp_row(K: int) -> int:
    """Bytes per backpointer row (csrc/viterbi.cu `bp_row`)."""
    return K if K > SMALL_K else 4 * (((K + 3) // 4) | 1)


def trace_bytes(T: int, K: int, C: int) -> int:
    """Shared bytes a block takes for its trace; csrc/viterbi.cu `layout`
    computes the same, and the C entry point refuses a plan whose bytes
    differ. At K <= ``SMALL_K`` two scored chunks are in flight
    (the producer warps score one while the chain reads the other).
    Staging regions carry 16 bytes of slack for a slice that starts inside
    its first granule."""
    G = group_width(K)
    KP = -(-K // G) * G
    small = K <= SMALL_K
    slots = 2 if small else 1
    return (_round16((T - 1) * bp_row(K))             # uint8 backpointers
            + 2 * KP * 4                               # running scores
            + slots * _round16(C * (G if small else K) * 4)     # emissions
            + slots * (C * tr_bytes_per_step(K) if small        # transitions
                       else _round16(C * tr_bytes_per_step(K)) + 16)
            + _round16(C * K * K * (4 if small else 2)) + 16    # staged route
            + 2 * (_round16(C * 4) + 16)               # staged gc, case
            + _round16(C * K * 4) + 16                 # staged dist
            + _round16(C * K) + 16)                    # staged valid


def launch_plan(B: int, T: int, K: int) -> LaunchPlan:
    """The kernel's launch for a (B, T, K) batch: a block per trace, a warp
    of lanes per trace (it beat a lane group of ``group_width(K)`` lanes,
    four traces to a warp, at K=8 on the H100: PERF.md), and the longest
    chunk of about ``CHUNK_BYTES`` that fits the block's shared memory.
    Raises ``ValueError`` when K is outside 1..``MAX_K`` or one trace does
    not fit a block."""
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K} outside 1..{MAX_K}: the CUDA decode takes "
                         f"at most {MAX_K} candidates (one trace's uint8 "
                         f"backpointers must fit one block)")
    if T < 1 or B < 0:
        raise ValueError(f"bad batch shape B={B}, T={T}")
    C = CHUNK_BYTES // tr_bytes_per_step(K)
    C = max(1, min(T - 1, max(C, MIN_CHUNK) if K <= SMALL_K else C))
    while C > 1 and trace_bytes(T, K, C) > SMEM_MAX:
        C = (C + 1) // 2
    smem = trace_bytes(T, K, C)
    if smem > SMEM_MAX:
        raise ValueError(f"T={T}, K={K}: one trace needs {smem} bytes of "
                         f"shared memory, more than {SMEM_MAX}")
    return LaunchPlan(32, 1, C, smem, B)


_lock = threading.Lock()
_kernel = None  # (ctypes function, build log) once built


def build():
    """Compile (once per source version) and load the kernel library
    (``ops.nvcc``). Returns ``(entry point, compiler log)``; raises if the
    build fails."""
    global _kernel
    with _lock:
        if _kernel is None:
            lib, log = nvcc.load(SOURCE, "viterbi")
            fn = lib.viterbi_decode
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float,
                           ctypes.c_float, i, i, i, p, p, p]
            fn.restype = i
            _kernel = (fn, log)
        return _kernel


def viterbi_cuda(dist_m: torch.Tensor, valid: torch.Tensor,
                 route_m: torch.Tensor, gc_m: torch.Tensor,
                 case: torch.Tensor, sigma, beta):
    """Launch the CUDA kernel on CUDA tensors; same contract as the plain
    version. Raises on any input the kernel does not take."""
    if dist_m.dim() != 3:
        raise ValueError(f"dist_m must be (B, T, K), got {tuple(dist_m.shape)}")
    B, T, K = dist_m.shape
    plan = launch_plan(B, T, K)
    dev = dist_m.device
    nvcc.check_operands(dev, dist_m=dist_m, valid=valid, route_m=route_m,
                        gc_m=gc_m, case=case)
    if dist_m.dtype not in (torch.float16, torch.float32) or \
            route_m.dtype != dist_m.dtype or gc_m.dtype != dist_m.dtype:
        raise TypeError("dist_m, route_m and gc_m must share one dtype, "
                        "float16 or float32")
    if valid.dtype != torch.bool or case.dtype != torch.int32:
        raise TypeError("valid must be bool and case int32")
    Tr = route_m.shape[1] if route_m.dim() == 4 else -1
    if Tr not in (T - 1, T) or tuple(valid.shape) != (B, T, K) \
            or tuple(route_m.shape) != (B, Tr, K, K) \
            or tuple(gc_m.shape) != (B, Tr) or tuple(case.shape) != (B, T):
        raise ValueError(
            f"unsupported shapes dist {tuple(dist_m.shape)} valid "
            f"{tuple(valid.shape)} route {tuple(route_m.shape)} gc "
            f"{tuple(gc_m.shape)} case {tuple(case.shape)}")
    out = (torch.empty((B, T), dtype=torch.int32, device=dev),
           torch.empty((B,), dtype=torch.float32, device=dev))
    launch((dist_m, valid, route_m, gc_m, case), sigma, beta, out, plan)
    viterbi_cuda.launches += 1
    return out


viterbi_cuda.launches = 0


def launch(inputs, sigma, beta, out, plan: LaunchPlan) -> None:
    """Enqueue one kernel launch of ``plan`` on the current stream,
    uncounted and unchecked: ``inputs`` as :func:`viterbi_cuda` has
    validated them, ``out`` the (paths, scores) buffers. Timing loops call
    this with buffers allocated once."""
    dist_m, valid, route_m, gc_m, case = inputs
    paths, scores = out
    B, T, K = dist_m.shape
    fn, _log = build()
    with torch.cuda.device(dist_m.device):
        stream = torch.cuda.current_stream(dist_m.device).cuda_stream
        err = fn(dist_m.data_ptr(), valid.data_ptr(), route_m.data_ptr(),
                 gc_m.data_ptr(), case.data_ptr(), B, T, route_m.shape[1], K,
                 int(dist_m.dtype == torch.float16), float(sigma),
                 float(beta), plan.chunk_steps, plan.smem_bytes, plan.grid,
                 paths.data_ptr(), scores.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"viterbi kernel launch failed: CUDA error {err}")
