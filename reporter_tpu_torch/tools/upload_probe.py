"""The decode's upload on the card: one slab copy against five pageable
copies, and slabs in flight against the pageable upload.

``time_chunk`` times one (128, 64, 8) chunk of the f16 wire (the replay's
batch: ``dist_m``, ``valid``, ``route_m`` and ``gc_m`` with T time rows,
``case``) moved two ways: five ``Tensor.to`` copies from pageable numpy
arrays, as the dispatch lane uploaded before its slabs, and one
non-blocking copy of a pinned slab (``matcher/slab.py``). Each way is timed
by CUDA events around a round, the median of ``reps`` rounds, and by the
host clock from the round's first call to its return.

``check_in_flight`` runs ``match_many`` on the card with the lanes on and
holds every batch's paths bit-equal to the same decode of the same host
arrays uploaded pageable: the native prep (slabs written in place, the
first dispatch held until at least 8 chunks' slabs are live), the numpy
prep and device routes (both restaged on the dispatch lane). It checks
one copy a batch, the restaged bytes of each leg, and reads torch's
pinned host allocator's statistics where the installed torch has them.

Prints one JSON line::

    python -m reporter_tpu_torch.tools.upload_probe [--reps 50]
        [--traces 1536] [--skip-check]

Needs a CUDA card: exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time

import numpy as np

#: the replay's chunk: rows, time rows, candidates
CHUNK_SHAPE = (128, 64, 8)
#: chunks whose slabs the native leg holds live before its first dispatch
IN_FLIGHT = 8


def chunk_arrays(B: int, T: int, K: int, seed: int = 0) -> tuple:
    """One chunk's f16 wire as the native prep lays it out (route and gc
    with T time rows), seeded."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 60, (B, T, K)).astype(np.float16),
            rng.random((B, T, K)) < 0.8,
            rng.uniform(0, 900, (B, T, K, K)).astype(np.float16),
            rng.uniform(0, 500, (B, T)).astype(np.float16),
            rng.integers(0, 3, (B, T)).astype(np.int32))


def _median_round(dev, reps: int, round_fn) -> tuple:
    """(median device ms, median host ms) of ``reps`` rounds, each
    bracketed by CUDA events on the current stream, after two warm-up
    rounds."""
    import torch
    for _ in range(2):
        round_fn()
    torch.cuda.synchronize(dev)
    dev_ms, host_ms = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        round_fn()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        dev_ms.append(start.elapsed_time(end))
    return statistics.median(dev_ms), statistics.median(host_ms)


def time_chunk(dev, reps: int = 50, shape=CHUNK_SHAPE) -> dict:
    """One chunk's wire moved as five pageable copies and as one pinned
    slab copy: bytes, device and host milliseconds, GB/s of each."""
    import torch

    from ..matcher import slab as wire_slab
    arrays = chunk_arrays(*shape)
    nbytes = sum(a.nbytes for a in arrays)
    sources = [torch.from_numpy(a) for a in arrays]
    wire = wire_slab.Slab([(a.shape, a.dtype) for a in arrays],
                          wire_slab.pinned)
    for view, a in zip(wire.views, arrays):
        np.copyto(view, a)
    dev_buf = torch.empty(wire.used, dtype=torch.uint8, device=dev)
    out = {"shape": list(shape), "bytes": nbytes, "slab_bytes": wire.used}
    with torch.cuda.device(dev):
        for name, round_fn in (
                ("pageable_x5", lambda: [t.to(dev) for t in sources]),
                ("pinned_x1", lambda: dev_buf.copy_(
                    wire.buf[:wire.used], non_blocking=True))):
            d_ms, h_ms = _median_round(dev, reps, round_fn)
            out[name] = {"device_ms": d_ms, "host_ms": h_ms,
                         "gb_per_s": nbytes / (d_ms * 1e-3) / 1e9}
        # the views the decode reads equal the arrays
        for view, a in zip(wire.device_views(dev_buf), arrays):
            if not np.array_equal(view.cpu().numpy(), a):
                raise AssertionError("a slab view differs from its array")
    return out


def _requests(net, n: int, seed: int) -> list:
    """``n`` seeded /report requests of 48-64 points."""
    from ..synth import generate_trace
    rng = np.random.default_rng(seed)
    opts = {"mode": "auto", "report_levels": [0, 1],
            "transition_levels": [0, 1]}
    out = []
    while len(out) < n:
        tr = generate_trace(net, f"veh-{len(out)}", rng, noise_m=4.0,
                            min_route_edges=8, max_route_edges=60)
        if tr is not None and len(tr.points) >= 48:
            out.append({"uuid": tr.uuid, "trace": tr.points[:64],
                        "match_options": opts})
    return out


def _recording_matcher(net, dev, **kw):
    """A matcher on ``dev`` that keeps, for every batch it dispatches, a
    copy of its host arrays, sigma, beta and the dispatch's return, and
    counts the slabs it allocates; once its ``gate_after`` is set > 0, a
    dispatch waits (at most 120 s) until that many slabs have been
    allocated."""
    import torch

    from ..matcher import SegmentMatcher

    class Recording(SegmentMatcher):
        def _dispatch_timed(self, batch, sigma, beta):
            if self.gate_after:
                self.gated = self.gate.wait(timeout=120.0)
            batch.finalize_wire()
            host = tuple(a if isinstance(a, torch.Tensor) else np.array(a)
                         for a in (batch.dist_m, batch.valid, batch.route_m,
                                   batch.gc_m, batch.case))
            out = super()._dispatch_timed(batch, sigma, beta)
            self.records.append((host, sigma, beta, out))
            return out

    m = Recording(net, device=dev, chunk=CHUNK_SHAPE[0], **kw)
    m.records, m.gate, m.gated, m.slabs = [], threading.Event(), None, [0]
    m.gate_after = 0
    alloc = m._slab_alloc

    def counting(nbytes):
        m.slabs[0] += 1
        if m.slabs[0] >= m.gate_after:
            m.gate.set()
        return alloc(nbytes)

    m._slab_alloc = counting
    return m


def check_in_flight(dev, traces: int = 1536, seed: int = 5) -> dict:
    """``match_many`` on the card on each upload leg, every batch's paths
    held bit-equal to the pageable upload of its host arrays; raises on a
    difference or a wrong count."""
    import torch

    from .. import ops
    from ..synth import build_grid_city
    from ..utils import metrics
    net = build_grid_city(rows=20, cols=20, spacing_m=200.0, seed=42)
    reqs = _requests(net, traces, seed)
    out = {"traces": traces}
    if hasattr(torch.cuda, "reset_peak_host_memory_stats"):
        torch.cuda.reset_peak_host_memory_stats()
    for leg, kw, gate in (("native", {}, IN_FLIGHT),
                          ("numpy", {"native": False}, 0),
                          ("device_routes", {"route_device": True}, 0)):
        m = _recording_matcher(net, dev, **kw)
        m.match_many(reqs[:64])           # builds and warms
        m.records.clear()
        m.slabs[0] = 0
        m.gate_after = gate
        m.gate.clear()
        metrics.default.reset()
        t0 = time.perf_counter()
        m.match_many(reqs)
        wall = time.perf_counter() - t0
        counters = metrics.snapshot()["counters"]
        batches = len(m.records)
        equal = 0
        for host, sigma, beta, (paths, _event, _dev, _t) in m.records:
            x = tuple(a.to(dev) if isinstance(a, torch.Tensor)
                      else torch.from_numpy(a).to(dev) for a in host)
            want, _scores = ops.decode_batch(*x, sigma, beta)
            if not torch.equal(want.cpu(), paths):
                raise AssertionError(f"{leg}: a batch's paths differ from "
                                     f"the pageable upload's")
            equal += 1
        copies = counters.get("decode.upload.copies", 0)
        up = counters.get("decode.upload.bytes", 0)
        restaged = counters.get("decode.upload.restaged_bytes", 0)
        if copies != batches:
            raise AssertionError(f"{leg}: {copies} copies for {batches} "
                                 f"batches")
        if (restaged == 0) != (leg == "native"):
            raise AssertionError(f"{leg}: restaged {restaged} of {up} B")
        if gate and not m.gated:
            raise AssertionError(f"{leg}: only {m.slabs[0]} slabs were "
                                 f"live before the first dispatch")
        out[leg] = {"batches": batches, "paths_equal": equal,
                    "copies": copies, "upload_bytes": up,
                    "restaged_bytes": restaged, "slabs": m.slabs[0],
                    "wall_s": wall}
        m.close()
    if hasattr(torch.cuda, "host_memory_stats"):
        out["host_memory_stats"] = {
            k: v for k, v in torch.cuda.host_memory_stats().items()
            if "bytes" in k or "alloc" in k}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--traces", type=int, default=1536)
    ap.add_argument("--skip-check", action="store_true",
                    help="time the chunk's copies only")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("upload_probe: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    result = {"device": torch.cuda.get_device_name(dev),
              "torch": torch.__version__,
              "chunk": time_chunk(dev, args.reps)}
    if not args.skip_check:
        result["in_flight"] = check_in_flight(dev, args.traces)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
