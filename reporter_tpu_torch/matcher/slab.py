"""One batch's decode wire in one host slab, uploaded by one copy.

The decode's host inputs (``dist_m``, ``valid``, ``route_m``, ``gc_m``,
``case``; a route tensor already on the device stays out) lie in one
``uint8`` buffer, each at an offset rounded up to :data:`ALIGN` bytes. One
host-to-device copy moves the whole wire into one device buffer, and each
input is a view of it that starts on 16 bytes, as the kernel's launcher
checks (``ops.nvcc.check_operands``). The layout comes from the arrays'
own shapes and dtypes, so the f16 wire, the f32 wire and filler rows lay
out alike.

On the card the buffer comes from torch's pinned caching host allocator
(:func:`pinned`): the copy is asynchronous, and the allocator keeps a
freed block out of reuse until the copy that read it has completed. The
native prep writes its wire straight into a slab
(``batchpad.prepare_batch``); any other batch is copied into a fresh one
on the dispatch lane (:func:`stage`, counted as restaged).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..utils import metrics

#: each array's offset in a slab is a multiple of this many bytes
ALIGN = 128

_TORCH_DTYPE = {np.dtype(np.float16): torch.float16,
                np.dtype(np.float32): torch.float32,
                np.dtype(np.bool_): torch.bool,
                np.dtype(np.int32): torch.int32}


def layout(specs) -> tuple:
    """``(offsets, size)`` for arrays of ``specs`` [(shape, dtype)] laid
    out in order: each offset the end of the one before rounded up to
    :data:`ALIGN`, and the end of the last rounded up the same way (so
    every dtype views the whole slab)."""
    offsets, end = [], 0
    for shape, dtype in specs:
        off = -(-end // ALIGN) * ALIGN
        offsets.append(off)
        end = off + int(np.prod(shape, dtype=np.int64)) \
            * np.dtype(dtype).itemsize
    return tuple(offsets), -(-end // ALIGN) * ALIGN


def pinned(nbytes: int) -> torch.Tensor:
    """``nbytes`` of page-locked host memory from torch's caching host
    allocator: the slab allocator of a matcher on the card."""
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


class Slab:
    """A host buffer of ``used`` bytes from ``alloc`` (bytes -> 1-D
    ``uint8`` tensor) that holds arrays of ``specs`` [(shape, dtype)] at
    :func:`layout`'s offsets; ``views`` are those arrays, numpy views of
    the buffer for the caller to fill."""

    def __init__(self, specs, alloc: Callable[[int], torch.Tensor]):
        self.specs = tuple((tuple(int(n) for n in shape), np.dtype(dtype))
                           for shape, dtype in specs)
        self.offsets, self.used = layout(self.specs)
        self.buf = alloc(self.used)
        raw = self.buf.numpy()
        self.views = tuple(
            np.ndarray(shape, dtype, raw, off)
            for off, (shape, dtype) in zip(self.offsets, self.specs))
        # (dtype, shape, strides, offset in elements) of each device view:
        # one whole-buffer dtype view and one as_strided a view, the
        # fewest torch calls (each may hand the interpreter lock over)
        self._device = tuple(
            (_TORCH_DTYPE[dtype], shape,
             tuple(int(st) // dtype.itemsize for st in view.strides),
             off // dtype.itemsize)
            for off, (shape, dtype), view in zip(self.offsets, self.specs,
                                                 self.views))

    def holds(self, arrays: Sequence) -> bool:
        """True when ``arrays`` are this slab's views, in order."""
        return len(arrays) == len(self.views) and all(
            a is v for a, v in zip(arrays, self.views))

    def device_views(self, dev_buf: torch.Tensor) -> tuple:
        """The arrays as views of ``dev_buf``, a device copy of the
        buffer."""
        typed, out = {}, []
        for dtype, shape, strides, off in self._device:
            whole = typed.get(dtype)
            if whole is None:
                whole = typed[dtype] = dev_buf.view(dtype)
            out.append(whole.as_strided(shape, strides, off))
        return tuple(out)


def stage(arrays: Sequence, slab: Optional[Slab],
          alloc: Callable[[int], torch.Tensor]) -> Slab:
    """The slab that holds the host arrays among ``arrays`` (a tensor is
    on the device already): ``slab`` where it holds them all, else a
    fresh one from ``alloc`` with the arrays copied in. Counts
    ``decode.upload.bytes`` (the host arrays' ``nbytes``, not the slab's
    alignment padding), ``decode.upload.copies`` (one: the upload that
    follows) and, for a fresh slab, ``decode.upload.restaged_bytes``."""
    host = [a for a in arrays if not isinstance(a, torch.Tensor)]
    nbytes = sum(a.nbytes for a in host)
    if slab is None or not slab.holds(host):
        slab = Slab([(a.shape, a.dtype) for a in host], alloc)
        for view, a in zip(slab.views, host):
            np.copyto(view, a)
        metrics.count("decode.upload.restaged_bytes", nbytes)
    metrics.count("decode.upload.bytes", nbytes)
    metrics.count("decode.upload.copies")
    return slab


def upload(arrays: Sequence, slab: Optional[Slab],
           alloc: Callable[[int], torch.Tensor],
           device: torch.device) -> tuple:
    """``arrays`` on ``device`` by one copy on its current stream: the
    host arrays from their slab (:func:`stage`), non-blocking, into one
    device buffer, and a tensor already on the device as it is."""
    slab = stage(arrays, slab, alloc)
    dev_buf = torch.empty(slab.used, dtype=torch.uint8, device=device)
    dev_buf.copy_(slab.buf, non_blocking=True)
    views = iter(slab.device_views(dev_buf))
    return tuple(a if isinstance(a, torch.Tensor) else next(views)
                 for a in arrays)
