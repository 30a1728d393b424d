"""The decode mesh: the cards one matcher decodes over.

The JAX package builds a ``jax.sharding.Mesh`` with two axes:

  ``data`` — traces (the uuid/partition axis reborn): pure data
             parallelism, no cross-device traffic in the decode
  ``seq``  — the time axis of each trace: the associative-scan decode
             composes its max-plus step matrices across devices

Here a :class:`DecodeMesh` is the same grid as a tuple of
``torch.device``, row-major over (data, seq): entry ``d * seq + s`` holds
row shard ``d`` and time span ``s``. The mesh is process-local, as the JAX
package's decode mesh is: a multi-host job partitions uuids across hosts
(``parallel/multihost.py``) and each process decodes over its own cards.

A mesh may name one device more than once (tests use ``cpu`` eight
times, a one-card run names its card twice or four times). Each entry has
its own CUDA stream, made at its first use, so entries on one card queue
their work side by side as entries on several cards do. A mesh belongs to
the matcher that built it, which closes it.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch

from ..utils import locks as _locks

#: ``decode_shard`` settings: "auto" shards over every visible card when
#: there is more than one, "on" the same (a one-device mesh is no mesh),
#: "off" never
SHARD_MODES = ("auto", "on", "off")

_SLICE_RE = re.compile(r"^\s*(?:(\d+)\s*/\s*(\d+)|(\d+)?\s*:\s*(\d+)?)\s*$")


@dataclass(frozen=True)
class DecodeMesh:
    """A (data, seq) grid of devices, row-major; ``axis_names`` is
    ``("data",)`` for a data mesh and ``("data", "seq")`` for a 2-D one.
    ``stream(i)`` is entry i's CUDA stream (None off the card)."""
    devices: Tuple[torch.device, ...]
    shape: Tuple[int, int]
    axis_names: Tuple[str, ...] = ("data", "seq")
    _streams: dict = field(default_factory=dict, compare=False, repr=False)
    _lock: object = field(
        default_factory=lambda: _locks.new_lock("parallel.mesh"),
        compare=False, repr=False)

    def __post_init__(self):
        data, seq = self.shape
        if data < 1 or seq < 1 or data * seq != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} != device count "
                             f"{len(self.devices)}")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError("a mesh's devices are all cards or all cpu")

    @property
    def data(self) -> int:
        return self.shape[0]

    @property
    def seq(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def on_card(self) -> bool:
        return self.devices[0].type == "cuda"

    def entry(self, d: int, s: int = 0) -> int:
        """The entry index of row shard ``d``, time span ``s``."""
        return d * self.seq + s

    def stream(self, i: int) -> Optional["torch.cuda.Stream"]:
        """Entry ``i``'s CUDA stream, made at its first use; None for a
        cpu entry."""
        if not self.on_card:
            return None
        with self._lock:
            s = self._streams.get(i)
            if s is None:
                s = self._streams[i] = torch.cuda.Stream(self.devices[i])
            return s

    def close(self) -> None:
        """Wait for the entries' streams and forget them (a closed mesh
        makes new ones if used again)."""
        with self._lock:
            streams = list(self._streams.values())
            self._streams.clear()
        for s in streams:
            s.synchronize()


def visible_cards() -> List[torch.device]:
    """Every card this process sees, ``cuda:0`` first."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Optional[Tuple[int, int]] = None, devices=None,
              axis_names: Sequence[str] = ("data", "seq")) -> DecodeMesh:
    """A 2-D (data, seq) mesh over ``devices`` (default: every visible
    card), shaped (n, 1) unless ``shape`` says otherwise; raises on a
    shape that does not match the device count, and with no device."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else visible_cards())]
    n = len(devices)
    if n == 0:
        raise RuntimeError("no device for a mesh: no CUDA card is visible "
                           "and none was given")
    if shape is None:
        shape = (n, 1)
    return DecodeMesh(tuple(devices), (int(shape[0]), int(shape[1])),
                      tuple(axis_names))


def make_data_mesh(devices) -> DecodeMesh:
    """A 1-D ``("data",)`` mesh: pure batch parallelism, no cross-entry
    traffic in the decode, so every decode shards on it."""
    devices = [torch.device(d) for d in devices]
    return DecodeMesh(tuple(devices), (len(devices), 1), ("data",))


def device_slice(devices: Sequence, spec: Optional[str]) -> list:
    """The part of ``devices`` that ``spec`` names.

    ``"s/p"``: contiguous block ``s`` of ``p`` (prefork worker ``s`` of
    ``p`` owns ``devices[s*n//p:(s+1)*n//p]``; with more processes than
    devices a slot whose block is empty takes the one device
    ``devices[s*n//p]``, so the slots spread evenly and each owns one).
    ``"lo:hi"``: a half-open range. None or empty: all. A malformed spec,
    a slot out of range and a range that selects nothing raise."""
    devices = list(devices)
    spec = (spec or "").strip()
    if not spec or not devices:
        return devices
    m = _SLICE_RE.match(spec)
    if not m:
        raise ValueError(f"device slice {spec!r} not understood: want "
                         f"'slot/procs' or 'lo:hi'")
    n = len(devices)
    if m.group(1) is not None:
        slot, procs = int(m.group(1)), int(m.group(2))
        if procs <= 0 or slot >= procs:
            raise ValueError(f"device slice {spec!r}: slot out of range")
        lo, hi = slot * n // procs, (slot + 1) * n // procs
        if lo >= hi:
            return [devices[lo]]
        return devices[lo:hi]
    lo = int(m.group(3)) if m.group(3) else 0
    hi = int(m.group(4)) if m.group(4) is not None else n
    picked = devices[lo:hi]
    if not picked:
        raise ValueError(f"device slice {spec!r} selects no device of {n}")
    return picked


def check_slice_spec(spec: Optional[str]) -> None:
    """Raise unless ``spec`` is None or a slice :func:`device_slice`
    understands (a config's ``device_slice`` is checked before any card is
    counted)."""
    if spec is not None and (not isinstance(spec, str)
                             or (spec.strip()
                                 and not _SLICE_RE.match(spec))):
        raise ValueError(f"device slice {spec!r} not understood: want "
                         f"'slot/procs' or 'lo:hi'")


def decode_mesh(device, shard: str = "auto",
                slice_spec: Optional[str] = None, seq_shards: int = 1,
                devices=None) -> Optional[DecodeMesh]:
    """The decode mesh of a matcher on ``device``, or None.

    Over ``devices`` when given (any devices, one named more than once
    among them); else over the visible cards for a bare ``cuda`` device,
    or for a ``cuda:I`` with a ``slice_spec``. Then :func:`device_slice`
    of ``slice_spec``. None with ``shard="off"``, on the CPU without
    ``devices``, for ``cuda:I`` without a spec, and when one device is
    left. ``seq_shards`` > 1 asks for a 2-D mesh: the seq width becomes
    the largest divisor of the device count not above it."""
    if shard not in SHARD_MODES:
        raise ValueError(f"decode_shard {shard!r}: one of {SHARD_MODES}")
    if not isinstance(seq_shards, int) or seq_shards < 1:
        raise ValueError(f"seq_shards {seq_shards!r} must be an int >= 1")
    check_slice_spec(slice_spec)
    if shard == "off":
        return None
    device = torch.device(device)
    if devices is None:
        if device.type != "cuda" or (device.index is not None
                                     and not slice_spec):
            return None
        devices = visible_cards()
    picked = device_slice([torch.device(d) for d in devices], slice_spec)
    n = len(picked)
    if n <= 1:
        return None
    seq = min(seq_shards, n)
    while n % seq:
        seq -= 1
    if seq > 1:
        return make_mesh((n // seq, seq), picked)
    return make_data_mesh(picked)


def mesh_axes(mesh: Optional[DecodeMesh]) -> Tuple[int, int]:
    """(data, seq) widths of a decode mesh; (1, 1) without one."""
    if mesh is None:
        return 1, 1
    return mesh.shape


def decode_mesh_size(mesh: Optional[DecodeMesh]) -> int:
    """The data width of a decode mesh (1 without one): what the chunk and
    the dispatcher's flush cap scale by."""
    return mesh_axes(mesh)[0]


__all__ = ["DecodeMesh", "SHARD_MODES", "make_mesh", "make_data_mesh",
           "device_slice", "check_slice_spec", "decode_mesh", "mesh_axes",
           "decode_mesh_size", "visible_cards"]
