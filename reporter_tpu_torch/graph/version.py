"""Content-derived graph versions: the identity of a map build.

``map_version(net)`` hashes the persisted graph columns (the same arrays
``RoadNetwork.load`` reads — derived caches are excluded, so a reloaded
graph hashes identically) into a short stable token, the same token the
JAX package gives the same network. The optional ``extra`` bytes fold a
city's ``.profile`` artifact in, so a re-profiled build is a new version
even when the geometry is unchanged. The token is cached on the network
object: every call after the first is an attribute read.
"""
from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np

# the persisted columns, in their fixed order; hashing vars() would pick
# up lazily-built derived caches and make the version depend on which
# queries ran first
from .network import COLUMNS

#: hex digits kept: 12 (48 bits) — collision-safe for any realistic
#: number of map builds while staying readable in /health
VERSION_LEN = 12


def map_version(net, extra: Optional[bytes] = None) -> str:
    """The content-derived version token of ``net``.

    Stable across save/load round trips and process restarts; cached on
    the network object (``net._map_version``) after the first call.
    ``extra`` (the raw bytes of a city's ``.profile`` artifact) is folded
    in without being cached.
    """
    cached = getattr(net, "_map_version", None)
    if cached is None:
        h = hashlib.sha256()
        for name in COLUMNS:
            arr = np.ascontiguousarray(getattr(net, name))
            h.update(name.encode())
            h.update(str(arr.dtype).encode())
            h.update(arr.tobytes())
        # segment_length_m is a dict; hash it in sorted-key order, the
        # order the .npz format stores it in
        seg = net.segment_length_m
        for sid in sorted(seg):
            h.update(b"%d:%a" % (int(sid), float(seg[sid])))
        cached = h.hexdigest()[:VERSION_LEN]
        net._map_version = cached
    if extra:
        h = hashlib.sha256(cached.encode())
        h.update(extra)
        return h.hexdigest()[:VERSION_LEN]
    return cached


__all__ = ["map_version", "VERSION_LEN"]
