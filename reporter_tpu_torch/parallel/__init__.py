"""Multi-device and multi-host: the decode mesh, the sharded decode, and
the multi-host bootstrap with its uuid partitioning.

  mesh.py       DecodeMesh, make_mesh, make_data_mesh, device_slice,
                decode_mesh (a matcher's mesh over its cards)
  sharded.py    the row-sharded decode (sharded_data_viterbi) and the
                row- and time-sharded associative decode (sharded_viterbi)
  multihost.py  init_multihost (a gloo process group), host_hash and the
                uuid partition (partition_for_host, host_uuid_filter)

``multihost`` imports no torch; the mesh and the sharded decode import on
first use, so a torch-free process (a spawned gather child) may import
this package.
"""
from .multihost import (host_uuid_filter, init_multihost, partition_for_host,
                        shutdown_multihost)

_LAZY = {"make_mesh": "mesh", "make_data_mesh": "mesh",
         "decode_mesh": "mesh", "DecodeMesh": "mesh",
         "sharded_viterbi": "sharded", "shard_batch": "sharded",
         "sharded_data_viterbi": "sharded", "shard_batch_data": "sharded"}

__all__ = ["make_mesh", "sharded_viterbi", "shard_batch",
           "init_multihost", "partition_for_host", "host_uuid_filter",
           "shutdown_multihost", "make_data_mesh", "decode_mesh",
           "DecodeMesh", "sharded_data_viterbi", "shard_batch_data"]


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
