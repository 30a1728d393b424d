"""The ThreadSanitizer drive of the port's host runtime.

``python -m reporter_tpu_torch.tools.sanitize tsan`` runs this module, not
pytest, in a child interpreter with libtsan preloaded and the
``-fsanitize=thread`` build of ``native/csrc/host_runtime.cpp`` bound
through ``native.load(library=)``. The pytest harness deadlocks under a
preloaded libtsan on common glibc pairings (every thread asleep at the
first test), and a check must never hang, so this drive covers the
native concurrency surface the native test files cover, directly:

- the worker pool's span handoff: ``prepare_batch`` at 4 prep threads
  shards spans across the pool with no phase barrier;
- the striped route-pair memo's clock eviction: a memo bound of 64 pairs
  (``SegmentMatcher(route_memo=64)``) forces lookups, inserts and
  evictions from all four workers at once;
- the bit-identity of the prep tensors at 1, 2 and 5 threads, and equal
  values under eviction pressure, so a logic race that TSan does not
  flag still fails the drive;
- the cross-call memo's whole-row hit path, the wire writer from four
  threads over one chunk's run columns, and the memo's warm and export
  beside live prep.

Every knob is an argument of the port's ``SegmentMatcher`` on
``device="cpu"`` (the drive is host code and launches nothing). Any TSan
report aborts the process (``halt_on_error=1`` in the caller's
``TSAN_OPTIONS``); a parity failure exits 1.

Usage::

  python -m reporter_tpu_torch.tools.tsan_drive [--library PATH]
      [--prep-threads 4] [--route-memo 64]
"""
from __future__ import annotations

import argparse
import sys
import threading

PREP_KEYS = ("edge_ids", "dist_m", "offset_m", "route_m", "gc_m", "case",
             "kept_idx", "num_kept", "dwell", "has_cands", "max_finite")


def log(msg: str) -> None:
    print(f"tsan-drive: {msg}", flush=True)


def fail(msg: str) -> int:
    sys.stderr.write(f"tsan-drive: FAIL: {msg}\n")
    return 1


def _same_prep(a: dict, b: dict):
    """The first prep key whose tensors differ, or None."""
    import numpy as np
    for k in PREP_KEYS:
        if not np.array_equal(a[k], b[k]):
            return k
    return None


def drive(prep_threads: int = 4, route_memo: int = 64) -> int:
    """Run every leg; 0 when all held, 1 (with the reason on stderr) on
    the first that did not."""
    import numpy as np

    from ..core.geo import equirectangular_m
    from ..core.tracebatch import TraceBatch
    from ..matcher import MatchParams, SegmentMatcher
    from ..matcher.batchpad import prepare_batch
    from ..synth import build_grid_city, generate_trace
    from ..utils import metrics

    def matcher(**kw):
        return SegmentMatcher(city, MatchParams(max_candidates=8),
                              device="cpu", pipeline=False, **kw)

    def prep(m, n_threads):
        return prepare_batch(m.runtime, batch, m.params, 64,
                             n_threads=n_threads).prep

    city = build_grid_city(rows=10, cols=10, spacing_m=200.0, seed=5)
    rng = np.random.default_rng(11)
    traces = []
    while len(traces) < 20:
        tr = generate_trace(city, f"p{len(traces)}", rng, noise_m=5.0,
                            min_route_edges=3, max_route_edges=14)
        if tr is not None and len(tr.points) >= 4:
            traces.append(tr.points[:60])
    batch = TraceBatch.from_requests([{"trace": t} for t in traces])

    # -- leg 1: the native candidate lookup against the numpy grid --------
    m0 = matcher()
    pts = [p for t in traces for p in t]
    lat = np.array([p["lat"] for p in pts])
    lon = np.array([p["lon"] for p in pts])
    c_np = m0.grid.candidates(lat, lon, k=8)
    c_nat = m0.runtime.candidates(lat, lon, k=8)
    if not np.array_equal(c_np.edge_ids, c_nat.edge_ids):
        return fail("native candidate edges differ from SpatialGrid's")
    if not np.allclose(c_np.dist_m, c_nat.dist_m, atol=1e-3):
        return fail("native candidate distances differ from SpatialGrid's")
    log(f"candidates parity: {len(pts)} points")

    # -- leg 2: prep bit-identical across thread counts --------------------
    outs = [prep(m0, n) for n in (1, 2, 5)]
    for other in outs[1:]:
        k = _same_prep(outs[0], other)
        if k is not None:
            return fail(f"prep key {k} differs across thread counts")
    golden = outs[0]
    log("prep bit-identity: thread counts 1/2/5")

    # -- leg 3: concurrent prep storm over the worker pool -----------------
    errors: list = []

    def storm(rounds: int) -> None:
        try:
            m = matcher(prep_threads=prep_threads)
            for _ in range(rounds):
                k = _same_prep(prep(m, prep_threads), golden)
                if k is not None:
                    raise AssertionError(f"prep key {k} diverged under "
                                         f"the storm")
            m.close()
        except BaseException as e:  # reported below, never swallowed
            errors.append(e)

    threads = [threading.Thread(target=storm, args=(3,)) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        return fail(f"concurrent prep storm: {errors[0]}")
    log(f"concurrent prep storm: 4 threads x 3 rounds at {prep_threads} "
        f"prep threads, parity held")

    # -- leg 4: striped route-memo clock eviction under pressure -----------
    m = matcher(prep_threads=prep_threads, route_memo=route_memo)
    prep(m, prep_threads)
    evicted = prep(m, prep_threads)
    stats = m.runtime.route_memo_stats()
    if stats["evictions"] <= 0:
        return fail(f"route-memo bound never evicted ({stats})")
    if stats["size"] > route_memo:
        return fail(f"route-memo exceeded its bound ({stats})")
    k = _same_prep(evicted, golden)
    if k is not None:
        return fail(f"prep key {k} changed under memo eviction")
    m.close()
    log(f"route-memo eviction: {stats['evictions']} evictions at bound "
        f"{route_memo}, values exact")

    # -- leg 5: cross-call memo reuse (the whole-row hit path) -------------
    tr = None
    rng2 = np.random.default_rng(4)
    while tr is None:
        tr = generate_trace(city, "memo", rng2, noise_m=4.0,
                            min_route_edges=8)
    m = matcher()
    mlat = np.array([p["lat"] for p in tr.points])
    mlon = np.array([p["lon"] for p in tr.points])
    cands = m.runtime.candidates(mlat, mlon, k=8)
    gc = np.asarray(equirectangular_m(mlat[:-1], mlon[:-1], mlat[1:],
                                      mlon[1:]), dtype=np.float32)
    m.runtime.route_matrices(cands, gc)
    s1 = m.runtime.route_memo_stats()
    m.runtime.route_matrices(cands, gc)
    s2 = m.runtime.route_memo_stats()
    if not (s2["hits"] > s1["hits"] and s2["misses"] == s1["misses"]):
        return fail(f"route-memo cross-call reuse broken ({s1} -> {s2})")
    m.close()
    log("route-memo cross-call reuse: hit path exercised")

    # -- leg 6: the wire writer from four threads over one chunk -----------
    # synthesised run columns (no decode), with the chunk memo dropped
    # each round so the threads race its build, the benign last writer
    # wins of service/wire.py; byte parity with the Python writer
    from ..matcher.matcher import MatchRuns, RunColumns
    from ..service.report import _report_json_py, report_wire

    wrng = np.random.default_rng(17)
    n_traces_w, runs_per = 16, 6
    n_runs = n_traces_w * runs_per
    starts = np.round(1.5e9 + np.cumsum(wrng.uniform(1.0, 9.0, n_runs)), 3)
    ends = np.round(starts + wrng.uniform(0.5, 6.0, n_runs), 3)
    starts[::17] = -1.0  # sentinel rows, like real discontinuities
    ends[::17] = -1.0
    seg_id = wrng.integers(0, 1 << 40, n_runs).astype(np.int64)
    seg_id[::5] = -1  # unassociated rows
    n_ways = 2 * n_runs
    wcols = RunColumns({
        "seg_id": seg_id,
        "internal": (wrng.random(n_runs) < 0.15).astype(np.uint8),
        "start": starts, "end": ends,
        "length": wrng.integers(5, 900, n_runs).astype(np.int32),
        "queue": wrng.integers(0, 60, n_runs).astype(np.int32),
        "begin_idx": np.arange(n_runs, dtype=np.int32),
        "end_idx": np.arange(1, n_runs + 1, dtype=np.int32),
        "way_off": np.arange(0, n_ways + 1, 2, dtype=np.int64)[:n_runs + 1],
        "ways": wrng.integers(1, 1 << 30, n_ways).astype(np.int64),
    })
    run_off = np.arange(0, n_runs + 1, runs_per, dtype=np.int64)
    t_ends = np.round(np.array([starts[min(hi, n_runs) - 1] + 30.0
                                for hi in run_off[1:]]), 3)
    wcols.arrays["_run_off"] = run_off
    wcols.arrays["_trace_end"] = np.ascontiguousarray(t_ends, np.float64)
    runs = [(MatchRuns(wcols, int(run_off[t]), int(run_off[t + 1]), "auto"),
             {"uuid": f"wire-{t}", "trace": [{"time": float(t_ends[t])}]})
            for t in range(n_traces_w)]
    want = [_report_json_py(mm, rq, 15, {0, 1, 2}, {0, 1, 2})
            .encode("utf-8") for mm, rq in runs]
    native_before = metrics.counter("wire.native")

    def wire_storm(rounds: int) -> None:
        try:
            for _ in range(rounds):
                wcols.arrays.pop("_wire_chunk", None)
                for (mm, rq), exp in zip(runs, want):
                    got = report_wire(mm, rq, 15, {0, 1, 2}, {0, 1, 2})
                    if bytes(got) != exp:
                        raise AssertionError(
                            f"wire bytes differ for {rq['uuid']}")
        except BaseException as e:
            errors.append(e)

    wthreads = [threading.Thread(target=wire_storm, args=(6,))
                for _ in range(4)]
    for t in wthreads:
        t.start()
    for t in wthreads:
        t.join()
    if errors:
        return fail(f"wire writer storm: {errors[0]}")
    if metrics.counter("wire.native") <= native_before:
        return fail("wire writer storm never took the C writer")
    log(f"wire writer storm: 4 threads x 6 rounds over {len(runs)} "
        f"traces, byte parity held")

    # -- leg 7: memo warm and export beside live prep ----------------------
    wm = matcher()
    ea0, eb0 = m0.runtime.route_memo_export(1 << 16)
    if ea0.size == 0:
        return fail("nothing to export from the warmed handle")

    def warm_storm(rounds: int) -> None:
        try:
            for _ in range(rounds):
                wm.runtime.route_memo_warm(ea0, eb0)
                wm.runtime.route_memo_export(1 << 16)
        except BaseException as e:
            errors.append(e)

    def prep_storm(rounds: int) -> None:
        try:
            for _ in range(rounds):
                k = _same_prep(prep(wm, prep_threads), golden)
                if k is not None:
                    raise AssertionError(f"prep key {k} diverged under "
                                         f"the warm storm")
        except BaseException as e:
            errors.append(e)

    wsthreads = ([threading.Thread(target=warm_storm, args=(4,))
                  for _ in range(2)]
                 + [threading.Thread(target=prep_storm, args=(3,))
                    for _ in range(2)])
    for t in wsthreads:
        t.start()
    for t in wsthreads:
        t.join()
    if errors:
        return fail(f"memo warm/export storm: {errors[0]}")
    wstats = wm.runtime.route_memo_stats()
    if wstats["size"] <= 0:
        return fail(f"warm storm left an empty memo ({wstats})")
    wm.close()
    m0.close()
    log(f"memo warm/export storm: 2 warmers x 2 preppers over {ea0.size} "
        f"pairs, prep parity held")
    log("clean: every leg held")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m reporter_tpu_torch.tools.tsan_drive",
        description=__doc__.splitlines()[0])
    parser.add_argument("--library", default=None,
                        help="host runtime library to bind (the "
                             "sanitizer build); default: build and load "
                             "the regular one")
    parser.add_argument("--prep-threads", type=int, default=4)
    parser.add_argument("--route-memo", type=int, default=64,
                        help="route-pair memo bound, pairs (small, so "
                             "the clock eviction runs)")
    args = parser.parse_args(argv)
    from .. import native
    try:
        native.load(library=args.library)
    except RuntimeError as e:
        return fail(f"host runtime: {e}")
    return drive(args.prep_threads, args.route_memo)


if __name__ == "__main__":
    sys.exit(main())
