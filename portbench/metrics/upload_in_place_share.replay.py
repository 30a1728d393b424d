"""The share of the decode's uploaded host bytes that the prep wrote
straight into each batch's upload slab, in % (the program's
``decode.upload.bytes`` less ``decode.upload.restaged_bytes``, the bytes
the dispatch lane had to copy into a slab first, over
``decode.upload.bytes``, in the window). A program that uploads without
slabs counts no ``decode.upload.copies``: nothing to read."""


def read(obs):
    n = obs.counters.get("decode.upload.bytes")
    if not n or "decode.upload.copies" not in obs.counters:
        return None
    restaged = obs.counters.get("decode.upload.restaged_bytes", 0)
    return 100.0 * (n - restaged) / n
