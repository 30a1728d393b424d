"""The batched Viterbi decode kernel: build, bind, launch.

``csrc/viterbi.cu`` is a hand-written CUDA C++ kernel for Hopper
(``sm_90a``) with a plain C entry point. It is compiled with ``nvcc`` into
``reporter_tpu_torch/_build/`` at first use, never at import, and loaded
with ``ctypes``. Its plain version is the PyTorch scan
:func:`reporter_tpu_torch.matcher.hmm.viterbi_decode_batch`.

:func:`viterbi_cuda` is the kernel's wrapper: it checks its tensors,
launches the kernel or raises, and counts launches in
``viterbi_cuda.launches``. ``ops.decode_batch`` sends CPU tensors to the
plain version and CUDA tensors here.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..matcher.hmm import viterbi_decode_batch as viterbi_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "viterbi.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
#: two f32 score rows per trace must fit one block's shared memory
MAX_K = 227 * 1024 // 8

_lock = threading.Lock()
_kernel = None  # (ctypes function, build log) once built


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA decode kernel is built "
                       "with the CUDA toolkit's nvcc")


def build():
    """Compile (once per source version) and load the kernel library.
    Returns ``(entry point, compiler log)``; raises if the build fails."""
    global _kernel
    with _lock:
        if _kernel is None:
            src = SOURCE.read_bytes()
            tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                                 ).hexdigest()[:16]
            out = BUILD_DIR / f"libviterbi-{tag}.so"
            log = ""
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                    capture_output=True, text=True)
                log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                       f"{log}")
                os.replace(tmp, out)
            fn = ctypes.CDLL(str(out)).viterbi_decode
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float,
                           ctypes.c_float, p, p, p, p]
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
    dev = dist_m.device
    tensors = {"dist_m": dist_m, "valid": valid, "route_m": route_m,
               "gc_m": gc_m, "case": case}
    for name, x in tensors.items():
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be on the CUDA device {dev}, "
                             f"got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dist_m.dtype not in (torch.float16, torch.float32) or \
            route_m.dtype != dist_m.dtype or gc_m.dtype != dist_m.dtype:
        raise TypeError("dist_m, route_m and gc_m must share one dtype, "
                        "float16 or float32")
    if valid.dtype != torch.bool or case.dtype != torch.int32:
        raise TypeError("valid must be bool and case int32")
    Tr = route_m.shape[1] if route_m.dim() == 4 else -1
    if T < 1 or K < 1 or K > MAX_K or Tr not in (T - 1, T) \
            or tuple(valid.shape) != (B, T, K) \
            or tuple(route_m.shape) != (B, Tr, K, K) \
            or tuple(gc_m.shape) != (B, Tr) or tuple(case.shape) != (B, T):
        raise ValueError(
            f"unsupported shapes dist {tuple(dist_m.shape)} valid "
            f"{tuple(valid.shape)} route {tuple(route_m.shape)} gc "
            f"{tuple(gc_m.shape)} case {tuple(case.shape)} (K <= {MAX_K})")
    out = (torch.empty((B, T), dtype=torch.int32, device=dev),
           torch.empty((B,), dtype=torch.float32, device=dev),
           torch.empty((B, T - 1, K), dtype=torch.int32, device=dev))
    launch((dist_m, valid, route_m, gc_m, case), sigma, beta, out)
    viterbi_cuda.launches += 1
    return out[0], out[1]


viterbi_cuda.launches = 0


def launch(inputs, sigma, beta, out) -> None:
    """Enqueue one kernel launch on the current stream, uncounted and
    unchecked: ``inputs`` as :func:`viterbi_cuda` has validated them,
    ``out`` the (paths, scores, backpointer scratch) buffers. Timing
    loops call this with buffers allocated once."""
    dist_m, valid, route_m, gc_m, case = inputs
    paths, scores, bps = out
    B, T, K = dist_m.shape
    fn, _log = build()
    with torch.cuda.device(dist_m.device):
        stream = torch.cuda.current_stream(dist_m.device).cuda_stream
        err = fn(dist_m.data_ptr(), valid.data_ptr(), route_m.data_ptr(),
                 gc_m.data_ptr(), case.data_ptr(), B, T, route_m.shape[1], K,
                 int(dist_m.dtype == torch.float16), float(sigma),
                 float(beta), bps.data_ptr(), paths.data_ptr(),
                 scores.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"viterbi kernel launch failed: CUDA error {err}")

