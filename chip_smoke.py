#!/usr/bin/env python3
"""Smoke run of reporter_tpu_torch on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --against DIR

Phases, each fatal on failure:

1. build    compile ops/csrc/viterbi.cu with nvcc for sm_90a and the host
            runtime (native/csrc/host_runtime.cpp) with g++, and load
            both, printing ptxas's registers and spills (any spill fails
            the run, after the timing)
2. verify   the kernel against its plain PyTorch version on the card at
            the main path's shapes, the native prep's layout (route and
            gc with T time rows) and shapes that reach every branch of
            the launch plan, f16 and f32 wire: paths equal, scores
            bit-equal
3. main     SegmentMatcher.match_many (native prep, the two device lanes)
            + report_json() on the 20x20 synthetic city, 512 traces of
            the T=64 bucket and a mixed T=16/64/256 batch, on the card,
            and the same batches through the numpy prep on the card
            (native=False, lanes on); every body byte-equal to the port's
            own CPU runs on the native and the numpy path, the kernel's
            launches read around each run and held to its path's
            chunking; both paths' own batches (route and gc in T and in
            T-1 rows) through the kernel and the plain version; traces/s
            with the lanes on, and the stage split of a run without them
4. serve    the /report front door in this process (serve(): 64 handler
            threads, the dispatcher's flush cap of 256, native prep) on
            the card, two services built from config files, one with the
            lanes on and one with "pipeline": false: main's 608 requests
            POSTed from 64 client threads in a child process, a warm
            window each, then eight timed windows in turns (four each);
            every body byte-equal to the native CPU run, a few GETs too,
            the error answers equal to a CPU service's, the kernel
            launched at least once per dispatcher batch and at most once
            per chunk of each bucket in it; every batch the dispatchers
            formed rebuilt and held kernel against plain; per window
            requests/s, p50/p99 latency, batches, mean batch size,
            launches and the service's own timers, then each setting's
            median and range
5. prefork  python3 -m reporter_tpu_torch.service.server ... --procs 2 as
            a subprocess on the card: both workers answer 64 requests
            with the CPU run's bytes, SIGTERM reaps them and the parent
            exits 0 (the workers open the card after the fork)
6. city     512 traces of the T=64 bucket on a 100x100 grid city (10,000
            nodes, 39,600 edges) through the native matcher on the card:
            bodies byte-equal to the port's native CPU run, the kernel's
            launches in this phase, the route-pair memo's counters
7. timing   CUDA-event times of the kernel from CUDA graphs (the main
            path's batch, and batches and one trace at T=64/256/1024,
            twice in turns; the per-step slope and intercept; the main
            batch with the L2 flushed) and of the plain version, beside
            the least time the card could take and a model of the chain

Prints the card's name and power limit, one JSON line describing the
kernel (``launches``: match_many's in the main phase; ``launches_serve``:
each timed serve window's, lanes on), and as the
last line {"ok": true, "device": {...}}. Exits non-zero,
printing no result, without a CUDA card or without the package beside it.

With ``--against DIR`` (another checkout of the repo, such as a parent
commit unpacked with ``git archive``) only the build runs, then both
kernels decode the same inputs at (512,64,8) and (64,1024,8): their
outputs must be equal, and each is timed by CUDA graphs and by launches
from Python, in the order other, this, this, other.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
# dependent latencies in SM cycles, for the chain model only: a
# shared-memory load and an f32 add/compare/select (Hopper microbenchmark
# figures), and a warp shuffle (assumed equal to a shared-memory load)
SMEM_CYCLES, ALU_CYCLES, SHFL_CYCLES = 30, 4, 30
L2_BYTES = 50 * 2**20       # H100 L2; the flush buffer is larger

N_TRACES = 512              # the service's decode batch
SERVE_CLIENTS = 64          # client threads, as many as handler threads
# the serve phase's timed windows of 608 requests: four with the lanes
# on and four inline, in turns so that neither setting always goes first
SERVE_ORDER = ("lanes on", "inline", "inline", "lanes on",
               "inline", "lanes on", "lanes on", "inline")
T_MAIN = 64
K = 8                       # MatchParams.max_candidates default
CITY = dict(rows=20, cols=20, spacing_m=200.0, seed=42)
BIG_CITY = dict(rows=100, cols=100, spacing_m=200.0, seed=42)
OPTS = {"mode": "auto", "report_levels": [0, 1, 2],
        "transition_levels": [0, 1, 2]}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


# -- inputs ------------------------------------------------------------------
def random_inputs(B, T, K, seed, ties=False, special=False, dead_step=False):
    """Decode inputs with restarts, SKIP tails and unreachable routes; with
    ``ties``, odd candidates duplicate even ones exactly; with ``special``,
    trace 0 is RESTART at every step and trace 1 SKIP after its first
    point; with ``dead_step``, route and gc carry T rows (Tr = T)."""
    from reporter_tpu_torch.matcher.hmm import NORMAL, RESTART, SKIP
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0.0, 40.0, (B, T, K)).astype(np.float32)
    valid = rng.random((B, T, K)) > 0.1
    valid[:, :, 0] = True
    gc = rng.uniform(5.0, 40.0, (B, T - 1)).astype(np.float32)
    route = (gc[..., None, None]
             + rng.exponential(15.0, (B, T - 1, K, K))).astype(np.float32)
    route[rng.random(route.shape) < 0.05] = 1.0e9
    case = np.full((B, T), NORMAL, dtype=np.int32)
    case[:, 0] = RESTART
    for b in range(B):
        if T > 3:
            case[b, rng.integers(2, T - 1, size=2)] = RESTART
        n_skip = int(rng.integers(0, max(T // 4, 1)))
        if n_skip:
            case[b, T - n_skip:] = SKIP
    if special:
        case[0, :] = RESTART
        if B > 1:
            case[1, 1:] = SKIP
    if ties:
        dist[:, :, 1::2] = dist[:, :, 0::2]
        valid[:, :, 1::2] = valid[:, :, 0::2]
        route[:, :, 1::2, :] = route[:, :, 0::2, :]
        route[:, :, :, 1::2] = route[:, :, :, 0::2]
    if dead_step:
        route = np.concatenate(
            [route, np.full((B, 1, K, K), 7.0, np.float32)], axis=1)
        gc = np.concatenate([gc, np.full((B, 1), 3.0, np.float32)], axis=1)
    return dist, valid, route, gc, case


def to_device(arrays, f16, dev):
    import torch
    dist, valid, route, gc, case = arrays
    if f16:
        with np.errstate(over="ignore"):  # unreachable overflows to +inf
            dist, route, gc = (a.astype(np.float16) for a in (dist, route, gc))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (dist, valid, route, gc, case))


def wire_bytes(tensors, T, rows=None):
    """Bytes the decode must move for its first ``rows`` traces (all rows
    by default; a padded batch's filler rows decode to nothing): dist,
    valid and case read once, route and gc only for the T-1 transitions
    (the dead T-th row the native prep writes feeds no output), paths
    (rows, T) i32 and scores (rows,) f32 written once."""
    dist, valid, route, gc, case = tensors
    B = dist.shape[0] if rows is None else rows
    steps = min(route.shape[1], T - 1)
    Kx = dist.shape[2]
    per_trace = (T * Kx * (dist.element_size() + valid.element_size())
                 + steps * (Kx * Kx * route.element_size()
                            + gc.element_size())
                 + T * case.element_size())
    return B * (per_trace + T * 4 + 4)


def wire_ops(B, T, K):
    """f32 operations of the decode: per (t, i, j) a subtract, abs,
    divide, reachability compare, add and max compare; per (t, j) a
    divide, two multiplies and an add."""
    return B * (T - 1) * K * K * 6 + B * T * K * 4


def bound_ms(tensors, T, K, rows=None):
    """The least time for the decode's bytes and operations on the card
    (for the first ``rows`` traces, all by default): a floor that ignores
    the serial chain (see ``chain_cycles``)."""
    B = tensors[0].shape[0] if rows is None else rows
    t_bytes = wire_bytes(tensors, T, rows) / HBM_BYTES_PER_S
    t_ops = wire_ops(B, T, K) / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def chain_cycles(T, K):
    """A model of one trace's dependence chain in SM cycles, as the kernel
    runs it. Per step at K <= 32: G shuffles of the previous scores out of
    the lanes' registers (the last issued G-1 cycles after the first), the
    (independent) adds of the transitions, log2(G) tree levels of compare
    + select, the add of the emission and the select that keeps pads at
    -inf. Above 32: the previous scores read from shared memory, then per
    candidate slot and tile of G the adds and the tree, the tiles combined
    in turn, and the add of the emission. Then the backtrace's dependent
    loads from shared memory: at K <= 32 the kernel splits the T-1 rows
    into 32 odd-length segments, each lane walks its segment twice and
    lane 0 chains the 32 segment maps between the walks (2 * segment +
    32 loads); above, lane 0 walks all T-1 rows. Staging and scoring are
    left out: the producer warps do them beside the chain."""
    from reporter_tpu_torch.ops.viterbi import SMALL_K, group_width
    G = group_width(K)
    levels = int(np.log2(G)) * 2 * ALU_CYCLES
    if K <= SMALL_K:
        step = SHFL_CYCLES + (G - 1) + ALU_CYCLES + levels + 2 * ALU_CYCLES
        back = 2 * (((T - 1 + 31) // 32) | 1) + 32
    else:
        n = -(-K // G)
        tile = ALU_CYCLES + levels
        step = (SMEM_CYCLES + n * (n * tile + (n - 1) * 2 * ALU_CYCLES)
                + ALU_CYCLES)
        back = T - 1
    return (T - 1) * step + back * SMEM_CYCLES


# -- phases --------------------------------------------------------------------
def phase_build():
    """Build the kernel; returns the ptxas spill lines that are not 0."""
    import re
    from reporter_tpu_torch.ops import viterbi
    t0 = time.perf_counter()
    _fn, build_log = viterbi.build()
    secs = time.perf_counter() - t0
    log(f"[build] {viterbi.SOURCE.relative_to(ROOT)} -> sm_90a in {secs:.2f} s")
    spills = []
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and m.groups() != ("0", "0"):
            spills.append(line.strip())
    check("spill stores" in build_log, "nvcc printed no ptxas -v report")
    from reporter_tpu_torch import native
    t0 = time.perf_counter()
    native.load()
    log(f"[build] {native.SOURCE.relative_to(ROOT)} -> g++ "
        f"{' '.join(native.cxx_flags())} in "
        f"{time.perf_counter() - t0:.2f} s")
    return spills


def bit_equal(a, b):
    """Number of f32 entries whose bits differ."""
    import torch
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def phase_verify(dev):
    """Kernel vs plain on the card, same inputs: paths equal, scores
    bit-equal. The shapes reach every branch of the launch plan: K from 1
    to 128 (lane groups of 8, 16, 32 and strided lanes), T=1 and 2, chunks
    that end mid-trace (T=200 at K=5 and 8, T=1024), B=1 and B not a
    multiple of the traces per block, Tr = T (the native prep's layout,
    also at the main shape), traces RESTART at every step or SKIP after
    their first point, and exact ties."""
    import torch
    from reporter_tpu_torch.ops import viterbi, viterbi_cuda, viterbi_plain
    cases = [((N_TRACES, T_MAIN, K), {}),
             ((N_TRACES, T_MAIN, K), {"dead_step": True}),
             ((64, 1024, K), {}),
             ((37, 16, K), {}), ((16, 64, 40), {}),
             ((64, T_MAIN, K), {"ties": True}),
             ((9, 16, 1), {"special": True}),
             ((37, 200, 5), {"special": True}),
             ((16, 64, 12), {"special": True, "dead_step": True}),
             ((8, 64, 32), {"special": True}),
             ((3, 64, 128), {"special": True}),
             ((2, 1024, 128), {"special": True}),
             ((5, 1, K), {}), ((7, 2, 12), {"dead_step": True}),
             ((1, 200, K), {}), ((6, 200, K), {"special": True,
                                              "dead_step": True})]
    sigma, beta = np.float32(4.07), np.float32(3.0)
    for seed, ((B, T, Kc), kw) in enumerate(cases):
        arrays = random_inputs(B, T, Kc, seed, **kw)
        plan = viterbi.launch_plan(B, T, Kc)
        for f16 in (True, False):
            x = to_device(arrays, f16, dev)
            k_paths, k_scores = viterbi_cuda(*x, sigma, beta)
            torch.cuda.synchronize()
            p_paths, p_scores = viterbi_plain(*x, sigma, beta)
            torch.cuda.synchronize()
            what = f"B,T,K={B},{T},{Kc} {'f16' if f16 else 'f32'} {kw}"
            check(torch.equal(k_paths, p_paths),
                  f"paths differ at {what}: "
                  f"{int((k_paths != p_paths).sum())} entries")
            differ = bit_equal(k_scores, p_scores)
            check(differ == 0, f"{differ}/{B} scores not bit-equal at {what}")
            if kw.get("ties"):
                check(bool((k_paths % 2 == 0).all()),
                      "exact ties did not break to the lowest index")
            log(f"[verify] {what}: paths equal, scores bit-equal, plan "
                f"lanes={plan.lanes} traces/block={plan.traces_per_block} "
                f"C={plan.chunk_steps} smem={plan.smem_bytes} "
                f"grid={plan.grid}")
        del x, k_paths, k_scores, p_paths, p_scores
    torch.cuda.empty_cache()


def draw_requests(net, rng, n, lengths, min_edges):
    """``n`` synthetic /report requests, traces cut to the given lengths
    in turn (each drawn trace has at least its length)."""
    from reporter_tpu_torch.synth import generate_trace
    out = []
    while len(out) < n:
        L = lengths[len(out) % len(lengths)]
        tr = generate_trace(net, f"veh-{len(out)}", rng, noise_m=4.0,
                            min_route_edges=min_edges, max_route_edges=60)
        if tr is not None and len(tr.points) >= L:
            out.append({"uuid": tr.uuid, "trace": tr.points[:L],
                        "match_options": OPTS})
    return out


def make_requests(numpy_matcher, rng, n, lengths, min_edges):
    """``n`` requests as :func:`draw_requests` draws them, each kept only
    if its kept points land in the bucket of its length, so the numpy and
    the native path (which buckets by raw length) decode it at one T."""
    from reporter_tpu_torch.matcher.batchpad import bucket_length
    out, tries = [], 0
    while len(out) < n:
        tries += 1
        check(tries < 50, "could not draw enough traces")
        cand = draw_requests(numpy_matcher.net, rng, 2 * (n - len(out)),
                             lengths, min_edges)
        for req, p in zip(cand, numpy_matcher.prepare_many(cand)):
            if len(out) < n and p.T == bucket_length(len(req["trace"])):
                req["uuid"] = f"veh-{len(out)}"
                out.append(req)
    return out


def bodies(matches, reqs):
    from reporter_tpu_torch.service.report import report_json
    return [report_json(m, r, 15, {0, 1, 2}, {0, 1, 2})
            for m, r in zip(matches, reqs)]


def expected_launches(reqs, chunk):
    """Kernel launches the native dispatch makes for ``reqs``: one per
    chunk of each raw-length bucket. No bucket splits: the power of two
    at or above each request's length (12, 48, 64, 200) is its bucket."""
    return chunks_per_bucket([len(r["trace"]) for r in reqs], chunk)


def chunks_per_bucket(lengths, chunk):
    """Chunks of ``chunk`` traces in each raw-length bucket of traces
    with these point counts, summed."""
    from reporter_tpu_torch.matcher.batchpad import bucket_length
    counts = {}
    for n in lengths:
        T = bucket_length(int(n))
        counts[T] = counts.get(T, 0) + 1
    return sum(-(-n // chunk) for n in counts.values())


def expected_launches_numpy(reqs, chunk):
    """Kernel launches the numpy dispatch makes for ``reqs``: each chunk of
    ``chunk`` requests in order is prepped at once and ``pack_batches``
    gives one batch per bucket in it (``make_requests`` keeps only
    requests whose kept points land in the bucket of their length)."""
    from reporter_tpu_torch.matcher.batchpad import bucket_length
    return sum(len({bucket_length(len(r["trace"]))
                    for r in reqs[lo:lo + chunk]})
               for lo in range(0, len(reqs), chunk))


def numpy_batches(numpy_matcher, reqs, chunk):
    """The batches the numpy dispatch builds for ``reqs``: route and gc
    with T-1 time rows, exactly the bucket's traces."""
    from reporter_tpu_torch.matcher.batchpad import pack_batches
    for lo in range(0, len(reqs), chunk):
        yield from pack_batches(numpy_matcher.prepare_many(reqs[lo:lo + chunk]))


def native_batches(runtime, tb, params, chunk):
    """The native batches the dispatch builds for the TraceBatch ``tb``
    (one bucket per raw length, chunks of ``chunk``, rows padded to a
    power of two)."""
    from reporter_tpu_torch.matcher.batchpad import (bucket_length,
                                                     padded_batch_rows,
                                                     prepare_batch)
    by_T = {}
    for i, n in enumerate(tb.lengths()):
        by_T.setdefault(bucket_length(int(n)), []).append(i)
    for T, group in sorted(by_T.items()):
        for lo in range(0, len(group), chunk):
            part = group[lo:lo + chunk]
            yield prepare_batch(runtime, tb.gather(part), params, T,
                                pad_rows=padded_batch_rows(len(part)))


def against_plain(x, sigma, beta, what):
    """One batch ``x`` on the card through the kernel and the plain
    version: paths equal, scores bit-equal. Returns (the kernel's paths,
    the scores' largest absolute difference)."""
    import torch
    from reporter_tpu_torch import ops
    k_paths, k_scores = ops.viterbi_cuda(*x, sigma, beta)
    torch.cuda.synchronize()
    p_paths, p_scores = ops.viterbi_plain(*x, sigma, beta)
    torch.cuda.synchronize()
    check(torch.equal(k_paths, p_paths),
          f"paths differ from the plain version, {what}")
    differ = bit_equal(k_scores, p_scores)
    check(differ == 0, f"{differ} scores not bit-equal, {what}")
    return k_paths, float((k_scores - p_scores).abs().max())


def timed_run(matcher, reqs):
    """One counted, timed match_many + report_json of ``reqs`` after a
    warm-up call (route caches and memo warm): (bodies, wall seconds,
    kernel launches, stage seconds)."""
    from reporter_tpu_torch import ops
    matcher.match_many(reqs)
    for k in matcher.stage_seconds:
        matcher.stage_seconds[k] = 0.0
    ops.viterbi_cuda.launches = 0
    t0 = time.perf_counter()
    out = bodies(matcher.match_many(reqs), reqs)
    wall = time.perf_counter() - t0
    return (out, wall, ops.viterbi_cuda.launches,
            {k: round(v, 4) for k, v in matcher.stage_seconds.items()})


def phase_main(dev):
    import torch
    from reporter_tpu_torch import ops
    from reporter_tpu_torch.core.tracebatch import TraceBatch
    from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
    from reporter_tpu_torch.synth import build_grid_city

    t0 = time.perf_counter()
    city = build_grid_city(**CITY)
    params = MatchParams(max_candidates=K)
    gpu = SegmentMatcher(city, params)          # the card, by default
    check(gpu.device.type == "cuda", f"default device is {gpu.device}")
    check(gpu.runtime is not None and gpu._lanes is not None,
          "the default matcher is not native with the lanes on")
    inline = SegmentMatcher(city, params, pipeline=False)
    gpu_numpy = SegmentMatcher(city, params, native=False)
    check(gpu_numpy.device.type == "cuda" and gpu_numpy.runtime is None
          and gpu_numpy._lanes is not None,
          "the numpy matcher is not on the card with the lanes on")
    cpu = SegmentMatcher(city, params, device="cpu")
    cpu_numpy = SegmentMatcher(city, params, device="cpu", native=False)
    rng = np.random.default_rng(7)
    main = make_requests(cpu_numpy, rng, N_TRACES, [T_MAIN],
                         max(4, T_MAIN // 12))
    mixed = make_requests(cpu_numpy, rng, 96, [12, 48, 200], 21)
    log(f"[main] city {city.num_nodes} nodes / {city.num_edges} edges, "
        f"{len(main)} T={T_MAIN} + {len(mixed)} mixed requests in "
        f"{time.perf_counter() - t0:.2f} s; chunk {gpu.chunk} traces, "
        f"{gpu.prep_threads} prep threads")

    # the counted, timed runs: the lanes on (the main path), then inline
    # for a stage split that sums to the wall, then the numpy prep on the
    # card with the lanes on
    body_main, wall_main, launches_main, stages_piped = timed_run(gpu, main)
    body_mixed, _wall, launches_mixed, _st = timed_run(gpu, mixed)
    launches = launches_main + launches_mixed
    body_inline, wall_inline, _n, stages = timed_run(inline, main)
    np_main, wall_np, launches_np_main, stages_np = timed_run(gpu_numpy, main)
    np_mixed, _wall, launches_np_mixed, _st = timed_run(gpu_numpy, mixed)
    for what, reqs, got, want in (
            ("native T=64 batch", main, launches_main,
             expected_launches(main, gpu.chunk)),
            ("native mixed batch", mixed, launches_mixed,
             expected_launches(mixed, gpu.chunk)),
            ("numpy T=64 batch", main, launches_np_main,
             expected_launches_numpy(main, gpu_numpy.chunk)),
            ("numpy mixed batch", mixed, launches_np_mixed,
             expected_launches_numpy(mixed, gpu_numpy.chunk))):
        check(got == want, f"{what}: {got} kernel launches, want {want} "
                           f"(chunks of {gpu.chunk})")
    log(f"[main] {N_TRACES} traces, lanes on: "
        f"{N_TRACES / wall_main:.1f} traces/s ({wall_main:.4f} s wall, warm "
        f"route memo), stage seconds {stages_piped} (overlapped), kernel "
        f"launches {launches_main}; mixed batch launches {launches_mixed}")
    rest = wall_inline - sum(stages.values())
    log(f"[main] {N_TRACES} traces, inline: "
        f"{N_TRACES / wall_inline:.1f} traces/s ({wall_inline:.4f} s wall), "
        f"stage split {stages}, report + rest {rest:.4f} s")
    log(f"[main] {N_TRACES} traces, numpy prep, lanes on: "
        f"{N_TRACES / wall_np:.1f} traces/s ({wall_np:.4f} s wall, warm "
        f"route cache), stage seconds {stages_np} (overlapped), kernel "
        f"launches {launches_np_main}; mixed batch launches "
        f"{launches_np_mixed}")

    check(body_inline == body_main, "inline bodies differ from the lanes'")
    cpu_bodies = {}
    for name, ref in (("native", cpu), ("numpy", cpu_numpy)):
        want_main = bodies(ref.match_many(main), main)
        want_mixed = bodies(ref.match_many(mixed), mixed)
        cpu_bodies[name] = want_main + want_mixed
        for path, got_main, got_mixed in (("native", body_main, body_mixed),
                                          ("numpy", np_main, np_mixed)):
            check(got_main == want_main,
                  f"the card's {path} /report bodies differ from the "
                  f"port's {name} CPU run (T=64 batch)")
            check(got_mixed == want_mixed,
                  f"the card's {path} /report bodies differ from the "
                  f"port's {name} CPU run (mixed batch)")
    n_seg = sum(b.count('"way_ids"') for b in body_main)
    check(n_seg > N_TRACES, f"only {n_seg} segments matched")

    # the main path's own batches, native (route and gc with T time rows)
    # and numpy (T-1 rows), through the kernel and the plain version on
    # the card: paths equal to each other and to the CPU plain decode,
    # scores bit-equal
    sigma, beta = np.float32(params.effective_sigma), np.float32(params.beta)
    buckets = set()
    main_x = main_err = main_rows = None
    for layout, batches in (
            ("native", lambda reqs: native_batches(
                cpu.runtime, TraceBatch.from_requests(reqs), params,
                gpu.chunk)),
            ("numpy", lambda reqs: numpy_batches(cpu_numpy, reqs,
                                                 gpu_numpy.chunk))):
        for reqs in (main, mixed):
            for batch in batches(reqs):
                shape = batch.case.shape
                buckets.add((layout, shape[1]))
                arrays = (batch.dist_m, batch.valid, batch.route_m,
                          batch.gc_m, batch.case)
                x = tuple(torch.from_numpy(a).to(dev) for a in arrays)
                want_rows = shape[1] if layout == "native" else shape[1] - 1
                check(x[2].shape[1] == want_rows,
                      f"{layout} route_m has {x[2].shape[1]} time rows")
                what = f"{layout} batch {shape}"
                k_paths, err = against_plain(x, sigma, beta, what)
                cpu_paths, _ = ops.viterbi_plain(
                    *(torch.from_numpy(a) for a in arrays), sigma, beta)
                check(torch.equal(k_paths.cpu(), cpu_paths),
                      f"paths differ from the CPU run, {what}")
                log(f"[main] {what} {batch.dist_m.dtype}: paths equal, "
                    f"scores bit-equal")
                if main_x is None:  # the native T=64 batch's first chunk
                    main_x, main_err = x, err
                    main_rows = len(batch.traces)
    want_buckets = {(layout, T) for layout in ("native", "numpy")
                    for T in (16, 64, 256)}
    check(buckets == want_buckets, f"buckets {sorted(buckets)}")
    check(tuple(main_x[0].shape) == (min(gpu.chunk, N_TRACES), T_MAIN, K)
          and main_x[0].dtype == torch.float16,
          f"the main path's first batch is {tuple(main_x[0].shape)} "
          f"{main_x[0].dtype}")
    log(f"[main] /report bodies of the native and the numpy path on the "
        f"card byte-equal to the native and numpy CPU runs for all "
        f"{len(main) + len(mixed)} traces, lanes on and inline, paths "
        f"equal in buckets 16, 64 and 256 of both layouts, {n_seg} segments")
    served = {"city": city, "params": params, "reqs": main + mixed,
              "want": cpu_bodies["native"]}
    return launches, (main_x, main_rows), main_err, (sigma, beta), served


def http(url, data=None):
    """(status, headers, body) of one request: POST with ``data``, else
    GET."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=data,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def post_all(url, reqs, clients):
    """POST every request to ``url``/report from a pool of ``clients``
    threads in a child process (so the load does not share the
    service's GIL): ([(status, X-Reporter-Proc, body)] in request order,
    per-request seconds, wall seconds)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        with open(f"{tmp}/reqs.json", "w") as f:
            json.dump(reqs, f)
        subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.client_main(*sys.argv[1:])", url,
             f"{tmp}/reqs.json", f"{tmp}/out.json", str(clients)],
            cwd=ROOT, check=True, timeout=600)
        with open(f"{tmp}/out.json") as f:
            out = json.load(f)
    return ([(st, tag, body.encode()) for st, tag, body in out["answers"]],
            out["seconds"], out["wall"])


def client_main(url, reqs_path, out_path, clients):
    """The load generator :func:`post_all` runs in its own process."""
    from concurrent.futures import ThreadPoolExecutor
    with open(reqs_path) as f:
        reqs = json.load(f)
    # urllib's first use in 64 threads at once races its lazy set-up
    # (seconds on a loaded host): one GET from this thread first
    http(url + "/health")

    def one(req):
        t0 = time.perf_counter()
        st, h, body = http(url + "/report", json.dumps(req).encode())
        return ((st, h["X-Reporter-Proc"], body.decode()),
                time.perf_counter() - t0)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(int(clients)) as pool:
        done = list(pool.map(one, reqs))
    wall = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump({"answers": [a for a, _ in done],
                   "seconds": [t for _, t in done], "wall": wall}, f)


def error_requests(req):
    """(method, path, body) of the requests the service refuses: each
    validation error, malformed JSON, a GET without json, a bad action."""
    import urllib.parse
    pts = req["trace"][:5]
    bad = [{"trace": pts, "match_options": OPTS},
           {"uuid": "e", "trace": pts[:1], "match_options": OPTS},
           {"uuid": "e", "trace": pts,
            "match_options": {"transition_levels": [0]}},
           {"uuid": "e", "trace": pts,
            "match_options": {"report_levels": [0]}}]
    return ([("/report", json.dumps(b).encode()) for b in bad]
            + [("/report", b'{"uuid": '), ("/report", None),
               ("/nope?json=" + urllib.parse.quote(json.dumps(req)), None)])


def answers_match(answers, want, what):
    """Every answer 200 with the body the native CPU run gave."""
    for i, (st, _tag, body) in enumerate(answers):
        check(st == 200, f"{what}: request {i} answered {st}")
        check(body.decode() == want[i],
              f"{what}: /report body {i} differs from the native CPU run")


def spread(values):
    """(median, least, most) of a window series."""
    return float(np.median(values)), float(min(values)), float(max(values))


def phase_serve(dev, served):
    """The /report front door on the card: two services of the port in
    this process (``serve()``, 64 handler threads, the dispatcher's
    default flush cap of 256 traces, the native prep), built from config
    files as ``main`` builds them, one with the lanes on and one with
    ``"service": {"pipeline": false}``. Each takes a warm window of the
    main path's 512 T=64 and 96 mixed requests, POSTed from 64 client
    threads in a child process, then a few GETs and the error requests;
    then the timed windows of the same 608 requests run in the turns of
    ``SERVE_ORDER``. In every window every body is byte-equal to the
    native CPU run's, and each dispatcher batch launched the kernel at
    least once and at most once per chunk of each bucket in it; the error
    answers equal a CPU service's. Afterwards every batch the dispatchers
    formed in the timed windows is rebuilt by the native prep and goes
    through the kernel and the plain version on the card (paths equal,
    scores bit-equal). Returns {"lanes on"/"inline": [window numbers]}."""
    import tempfile
    import urllib.parse
    import torch
    from reporter_tpu_torch import ops
    from reporter_tpu_torch.matcher import SegmentMatcher
    from reporter_tpu_torch.service.server import (ReporterService,
                                                   matcher_from_config,
                                                   read_config, serve)
    from reporter_tpu_torch.utils import metrics
    city, params = served["city"], served["params"]
    reqs, want = served["reqs"], served["want"]
    cpu_svc = ReporterService(SegmentMatcher(city, params, device="cpu"))
    cpu_httpd = serve(cpu_svc, "127.0.0.1", 0)
    cpu_url = f"http://127.0.0.1:{cpu_httpd.server_address[1]}"
    up = {}        # setting -> (matcher, service, server, url, batches)
    windows = {"lanes on": [], "inline": []}
    formed = []    # (TraceBatch, its kernel launches) of the timed windows
    with tempfile.TemporaryDirectory() as tmp:
        city.save(f"{tmp}/city.npz")
        try:
            for lanes, keys in (("lanes on", {}),
                                ("inline", {"pipeline": False})):
                cfg = f"{tmp}/{len(up)}.json"
                with open(cfg, "w") as f:
                    json.dump({"graph": f"{tmp}/city.npz",
                               "matcher": {"max_candidates": K},
                               "service": keys}, f)
                conf = read_config(cfg)
                matcher = matcher_from_config(conf, "cuda")
                lanes_on = matcher._lanes is not None
                check(matcher.device.type == "cuda"
                      and matcher.runtime is not None
                      and lanes_on == (lanes == "lanes on"),
                      f"the {lanes} matcher is not native on the card")
                batches = []
                match_many = matcher.match_many

                def counted(tb, match_many=match_many, batches=batches):
                    before = ops.viterbi_cuda.launches
                    result = match_many(tb)
                    batches.append((tb, ops.viterbi_cuda.launches - before))
                    return result

                matcher.match_many = counted   # the service binds it below
                svc = ReporterService(matcher, **conf["service"])
                check(svc.dispatcher.max_batch == 256, "flush cap is not 256")
                httpd = serve(svc, "127.0.0.1", 0)
                url = f"http://127.0.0.1:{httpd.server_address[1]}"
                up[lanes] = (matcher, svc, httpd, url, batches)
                # warm (route memo), then the GETs and the error answers
                answers_match(post_all(url, reqs, SERVE_CLIENTS)[0], want,
                              f"{lanes}, warm window")
                for i in (0, 1, N_TRACES, len(reqs) - 1):
                    st, _h, body = http(
                        url + "/report?json="
                        + urllib.parse.quote(json.dumps(reqs[i])))
                    check(st == 200 and body.decode() == want[i],
                          f"{lanes}: GET body {i} differs")
                for path, data in error_requests(reqs[0]):
                    got, ref = http(url + path, data), http(cpu_url + path,
                                                            data)
                    check((got[0], got[2]) == (ref[0], ref[2])
                          and got[0] in (400, 500),
                          f"{lanes}: {path} answered {got[0]} {got[2]!r}, "
                          f"the CPU service {ref[0]} {ref[2]!r}")
            for turn, lanes in enumerate(SERVE_ORDER):
                matcher, _svc, _httpd, url, batches = up[lanes]
                what = f"{lanes}, window {turn}"
                batches.clear()
                metrics.default.reset()
                ops.viterbi_cuda.launches = 0
                answers, secs, wall = post_all(url, reqs, SERVE_CLIENTS)
                launches = ops.viterbi_cuda.launches
                run = list(batches)
                timers = metrics.snapshot()["timers"]
                answers_match(answers, want, what)
                check(sum(len(tb) for tb, _k in run) == len(reqs),
                      f"{what}: the dispatcher matched "
                      f"{sum(len(tb) for tb, _k in run)} traces")
                check(sum(k for _tb, k in run) == launches,
                      f"{what}: launches outside the dispatcher's batches")
                for tb, k in run:
                    most = chunks_per_bucket(tb.lengths(), matcher.chunk)
                    check(1 <= k <= most,
                          f"{what}: a batch of {len(tb)} traces launched "
                          f"the kernel {k} times, want 1..{most}")
                formed += run
                lat = np.array(secs) * 1e3
                handle = timers["service.handle"]
                match = timers["dispatch.match_many"]
                w = {"requests_per_s": len(reqs) / wall, "wall_s": wall,
                     "p50_ms": float(np.percentile(lat, 50)),
                     "p99_ms": float(np.percentile(lat, 99)),
                     "batches": len(run), "mean_batch": len(reqs) / len(run),
                     "launches": launches,
                     "handle_mean_ms": handle["mean_s"] * 1e3,
                     "match_many_mean_ms": match["mean_s"] * 1e3,
                     "match_many_busy": match["total_s"] / wall}
                windows[lanes].append(w)
                log(f"[serve] {what}: {len(reqs)} requests from "
                    f"{SERVE_CLIENTS} client threads in {wall:.4f} s: "
                    f"{w['requests_per_s']:.1f} requests/s, p50 "
                    f"{w['p50_ms']:.2f} ms, p99 {w['p99_ms']:.2f} ms; "
                    f"{len(run)} dispatcher batches, mean "
                    f"{w['mean_batch']:.1f} traces; {launches} kernel "
                    f"launches; service.handle mean "
                    f"{w['handle_mean_ms']:.2f} ms; match_many mean "
                    f"{w['match_many_mean_ms']:.2f} ms, busy "
                    f"{w['match_many_busy']:.1%} of the wall")
        finally:
            for _m, svc, httpd, _u, _b in up.values():
                httpd.shutdown()
                httpd.server_close()
                check(svc.dispatcher.close(), "a dispatcher did not stop")
            cpu_httpd.shutdown()
            cpu_httpd.server_close()
            check(cpu_svc.dispatcher.close(), "the CPU dispatcher did not stop")

    # the dispatchers' own batches, rebuilt by the native prep, through
    # the kernel and the plain version on the card
    sigma, beta = np.float32(params.effective_sigma), np.float32(params.beta)
    shapes = {}
    for tb, _k in formed:
        for batch in native_batches(cpu_svc.matcher.runtime, tb, params,
                                    up["lanes on"][0].chunk):
            x = tuple(torch.from_numpy(a).to(dev)
                      for a in (batch.dist_m, batch.valid, batch.route_m,
                                batch.gc_m, batch.case))
            against_plain(x, sigma, beta,
                          f"a served batch {tuple(batch.case.shape)}")
            shape = tuple(batch.case.shape)
            shapes[shape] = shapes.get(shape, 0) + 1
    log(f"[serve] the {len(formed)} dispatcher batches of the timed "
        f"windows, rebuilt by the native prep: {sum(shapes.values())} "
        f"kernel batches of (rows, T) {dict(sorted(shapes.items()))}, paths "
        f"equal to the plain version on the card, scores bit-equal")

    for lanes, ws in windows.items():
        parts = []
        for key, fmt in (("requests_per_s", ".1f"), ("p50_ms", ".2f"),
                         ("p99_ms", ".2f"), ("mean_batch", ".1f"),
                         ("launches", ".0f")):
            med, lo, hi = spread([w[key] for w in ws])
            parts.append(f"{key} {med:{fmt}} ({lo:{fmt}}-{hi:{fmt}})")
        log(f"[serve] {lanes}, {len(ws)} windows, median (least-most): "
            + "; ".join(parts))
    (on, on_lo, on_hi), (off, off_lo, off_hi) = (
        spread([w["requests_per_s"] for w in windows[k]])
        for k in ("lanes on", "inline"))
    overlap = max(on_lo, off_lo) <= min(on_hi, off_hi)
    log(f"[serve] all bodies of both settings byte-equal to the native CPU "
        f"run in every window; lanes on / inline, medians of requests/s: "
        f"{on / off:.3f}; the two ranges "
        f"{'overlap' if overlap else 'do not overlap'}")
    return windows


def phase_prefork(served):
    """``python3 -m reporter_tpu_torch.service.server cfg 127.0.0.1:PORT
    --procs 2`` on the card: both workers answer (two X-Reporter-Proc
    tags) 64 requests from 64 client threads with the native CPU run's
    bytes, and SIGTERM to the parent reaps both workers and exits 0. The
    workers open the card after the fork: a parent that had initialised
    CUDA, or run a torch op, would leave them none that works. No rate is
    taken: one burst of 64 requests measures its own start and end."""
    import os
    import signal
    import socket
    import tempfile
    reqs = served["reqs"][:32] + served["reqs"][N_TRACES:N_TRACES + 32]
    want = served["want"][:32] + served["want"][N_TRACES:N_TRACES + 32]
    with tempfile.TemporaryDirectory() as tmp, socket.socket() as sock:
        served["city"].save(f"{tmp}/city.npz")
        with open(f"{tmp}/cfg.json", "w") as f:
            json.dump({"graph": f"{tmp}/city.npz",
                       "matcher": {"max_candidates": K}}, f)
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        url = f"http://127.0.0.1:{port}"
        err = open(f"{tmp}/stderr", "w+")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "reporter_tpu_torch.service.server",
             f"{tmp}/cfg.json", f"127.0.0.1:{port}", "--procs", "2"],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=err)
        try:
            tags = {}
            while len(tags) < 2:
                if proc.poll() is not None or time.perf_counter() - t0 > 300:
                    err.seek(0)
                    fail(f"the pre-fork server gave {tags} (rc "
                         f"{proc.poll()}): {err.read()[-3000:]}")
                try:
                    st, h, _b = http(url + "/health")
                except OSError:
                    time.sleep(0.1)
                    continue
                tag = h["X-Reporter-Proc"]
                tags[tag.split(":")[0]] = tag
            up = time.perf_counter() - t0
            answers = post_all(url, reqs, SERVE_CLIENTS)[0]
            answers_match(answers, want, "pre-fork")
            seen = {tag for _st, tag, _body in answers}
            check(seen == set(tags.values()),
                  f"answers came from {sorted(seen)}, workers "
                  f"{sorted(tags.values())}")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
        check(rc == 0, f"the pre-fork parent exited {rc} on SIGTERM")
        for tag in tags.values():
            try:
                os.kill(int(tag.split(":")[1]), 0)
            except ProcessLookupError:
                continue
            fail(f"worker {tag} outlived its parent")
        err.close()
    log(f"[prefork] 2 workers {sorted(tags.values())} up in {up:.2f} s "
        f"on the card; both answered {len(reqs)} requests from "
        f"{SERVE_CLIENTS} client threads, bodies byte-equal to the native "
        f"CPU run; SIGTERM reaped both, parent rc 0")


def phase_city():
    """512 traces of the T=64 bucket on the 100x100 city through the
    native matcher on the card, lanes on: bodies byte-equal to the port's
    native CPU run, and the kernel's launches counted in this phase."""
    from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
    from reporter_tpu_torch.synth import build_grid_city

    t0 = time.perf_counter()
    city = build_grid_city(**BIG_CITY)
    params = MatchParams(max_candidates=K)
    gpu = SegmentMatcher(city, params)
    cpu = SegmentMatcher(city, params, device="cpu")
    reqs = draw_requests(city, np.random.default_rng(11), N_TRACES, [T_MAIN],
                         max(4, T_MAIN // 12))
    log(f"[city] {city.num_nodes} nodes / {city.num_edges} edges, "
        f"{len(reqs)} T={T_MAIN} requests in "
        f"{time.perf_counter() - t0:.2f} s")
    got, wall, launches, stages = timed_run(gpu, reqs)
    want = expected_launches(reqs, gpu.chunk)
    check(launches == want, f"{launches} kernel launches, want {want}")
    check(got == bodies(cpu.match_many(reqs), reqs),
          "/report bodies differ from the port's native CPU run")
    log(f"[city] {N_TRACES} traces, lanes on: {N_TRACES / wall:.1f} "
        f"traces/s ({wall:.4f} s wall, warm route memo), stage seconds "
        f"{stages} (overlapped), kernel launches {launches}; bodies "
        f"byte-equal to the native CPU run; route-pair memo "
        f"{gpu.runtime.route_memo_stats()}")
    return launches


def time_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n):
    """Device time of ``fn`` per call: ``n`` calls captured in one CUDA
    graph, replayed three times between CUDA events, so no host work
    (Python, ctypes, the launch itself) sits between the kernels. A
    kernel's inputs stay in the 50 MB L2 across launches, as they do right
    after the matcher's host-to-device copy."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * n)


def out_bufs(x):
    import torch
    B, T, _ = x[0].shape
    return (torch.empty((B, T), dtype=torch.int32, device=x[0].device),
            torch.empty((B,), dtype=torch.float32, device=x[0].device))


def launcher(mod, x, scalars):
    """A call that enqueues one launch of ``mod``'s kernel (an
    ``ops.viterbi`` module) on ``x`` into buffers allocated once, uncounted.
    A module without ``launch_plan`` has the first design's launch, which
    also takes an int32 backpointer scratch."""
    import torch
    bufs = out_bufs(x)
    if hasattr(mod, "launch_plan"):
        plan = mod.launch_plan(*x[0].shape)
        return lambda: mod.launch(x, *scalars, bufs, plan)
    B, T, Kx = x[0].shape
    bufs += (torch.empty((B, T - 1, Kx), dtype=torch.int32,
                         device=x[0].device),)
    return lambda: mod.launch(x, *scalars, bufs)


def flushed_ms(fn, dev, n=50):
    """Kernel time per launch with a 128 MB buffer written before each, so
    the inputs come from HBM: each launch of ``fn`` between its own pair of
    CUDA events, the median and the spread (least, most) of ``n``. The
    write takes the card longer than the host takes to queue the next
    launch, so the launches wait in the stream and no host time falls
    between the events."""
    import torch
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device=dev)
    check(flush.numel() * 4 > L2_BYTES, "flush buffer smaller than L2")
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for start, end in events:
        flush.fill_(1.0)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = [start.elapsed_time(end) for start, end in events]
    return float(np.median(ms)), min(ms), max(ms)


def phase_timing(dev, main, scalars, sm_mhz):
    """Kernel times (K=8, f16 wire) from CUDA graphs: the main path's
    native batch (``main``: its tensors and its rows that hold traces), a
    512-trace T=64 batch with route and gc in T-1 rows (the shape and
    layout the ``kernels`` line timed in the slice before the native prep,
    kept as a series across commits) and batches at T=256 and 1024, twice
    in turns; the first trace alone at T=64, 256 and 1024, whose three
    times give the chain's cost per step (slope) and its fixed part
    (intercept); the main batch launched from Python without a graph and
    with the L2 flushed before each launch; the plain version."""
    from reporter_tpu_torch.ops import viterbi, viterbi_plain
    main_x, main_rows = main
    shapes = {"main": main_x,
              "b512": to_device(random_inputs(N_TRACES, T_MAIN, K, 97),
                                True, dev),
              "mid": to_device(random_inputs(64, 256, K, 98), True, dev),
              "long": to_device(random_inputs(64, 1024, K, 99), True, dev)}
    batch = {name: [] for name in shapes}
    for _round in range(2):
        for name, x in shapes.items():
            batch[name].append(graph_ms(launcher(viterbi, x, scalars), 100))
    one = {name: graph_ms(launcher(viterbi, tuple(t[:1] for t in x),
                                   scalars), 100)
           for name, x in shapes.items() if name != "b512"}
    steps = np.array([shapes[name][0].shape[1] - 1 for name in one], float)
    slope, intercept = np.polyfit(steps, np.array(list(one.values())), 1)
    log(f"[timing] one trace: per-step slope {slope * 1e3:.5f} us "
        f"({slope * sm_mhz * 1e3:.1f} cycles at {sm_mhz} MHz), intercept "
        f"{intercept:.5f} ms")

    B, T, Kx = main_x[0].shape
    eager = time_ms(launcher(viterbi, main_x, scalars), 200)
    log(f"[timing] B,T,K={B},{T},{Kx} launched from Python back to back "
        f"(no graph): {eager:.4f} ms a launch")
    med, lo, hi = flushed_ms(launcher(viterbi, main_x, scalars), dev)
    log(f"[timing] B,T,K={B},{T},{Kx} with the L2 flushed before each "
        f"launch, own events each: median {med:.4f} ms (least {lo:.4f}, "
        f"most {hi:.4f})")

    out = {}
    for name, x in shapes.items():
        B, T, Kx = x[0].shape
        plain = (time_ms(lambda: viterbi_plain(*x, *scalars), 3)
                 if name != "mid" else None)
        rows = main_rows if name == "main" else B
        bms, by = bound_ms(x, T, Kx, rows)
        cyc = chain_cycles(T, Kx)
        p = viterbi.launch_plan(B, T, Kx)
        one_ms = f"{one[name]:.4f} ms" if name in one else "not timed"
        log(f"[timing] B,T,K={B},{T},{Kx} f16 wire: kernel "
            f"{batch[name][0]:.4f} / {batch[name][1]:.4f} ms (two rounds), "
            f"one trace {one_ms}, chain model {cyc} cycles = "
            f"{cyc / (sm_mhz * 1e3):.4f} ms at {sm_mhz} MHz, plain "
            f"{'not timed' if plain is None else f'{plain:.3f} ms'}, "
            f"bound {bms:.5f} ms by {by} "
            f"({wire_bytes(x, T, rows)} bytes, {wire_ops(rows, T, Kx)} "
            f"f32 ops for {rows} traces); "
            f"plan lanes={p.lanes} traces/block={p.traces_per_block} "
            f"C={p.chunk_steps} smem={p.smem_bytes} grid={p.grid}")
        out[name] = (batch[name][0], plain, bms, by)
    log("[timing] library: no single PyTorch call computes a Viterbi decode")
    return out


def load_other(path):
    """The ``reporter_tpu_torch.ops.viterbi`` module of the checkout at
    ``path``, imported under a package name of its own beside this one;
    it builds its kernel into that checkout."""
    import importlib
    import importlib.util
    root = Path(path).resolve() / "reporter_tpu_torch"
    check((root / "ops" / "viterbi.py").is_file(),
          f"no reporter_tpu_torch/ops/viterbi.py under {path}")
    name = "other_reporter_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, root / "__init__.py", submodule_search_locations=[str(root)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{name}.ops.viterbi")


def phase_against(dev, path):
    """This checkout's kernel against the one at ``path`` (K=8, f16 wire,
    same inputs): paths equal and scores bit-equal, then each timed per
    launch by CUDA graphs (``graph_ms``) and by launches from Python back
    to back (``time_ms``), in the order other, this, this, other. Returns
    {"B,T,K": {method: {"other": [ms, ms], "this": [ms, ms]}}}."""
    import torch
    from reporter_tpu_torch.ops import viterbi
    other = load_other(path)
    t0 = time.perf_counter()
    other.build()
    log(f"[against] built {path}'s kernel in "
        f"{time.perf_counter() - t0:.2f} s")
    scalars = (np.float32(4.07), np.float32(3.0))
    out = {}
    for seed, shape in enumerate([(N_TRACES, T_MAIN, K), (64, 1024, K)]):
        x = to_device(random_inputs(*shape, 300 + seed), True, dev)
        (t_paths, t_scores), (o_paths, o_scores) = (
            mod.viterbi_cuda(*x, *scalars) for mod in (viterbi, other))
        torch.cuda.synchronize()
        check(torch.equal(t_paths, o_paths),
              f"paths differ from {path}'s kernel at {shape}")
        differ = bit_equal(t_scores, o_scores)
        check(differ == 0, f"{differ} scores differ from {path}'s kernel "
              f"at {shape}")
        fns = {"this": launcher(viterbi, x, scalars),
               "other": launcher(other, x, scalars)}
        ms = {m: {"other": [], "this": []} for m in ("graph", "eager")}
        for name in ("other", "this", "this", "other"):
            ms["graph"][name].append(graph_ms(fns[name], 100))
            ms["eager"][name].append(time_ms(fns[name], 200))
        what = ",".join(map(str, shape))
        for method, by in ms.items():
            ratio = np.mean(by["other"]) / np.mean(by["this"])
            log(f"[against] B,T,K={what} {method}: {path} "
                f"{by['other'][0]:.4f} / {by['other'][1]:.4f} ms, this "
                f"{by['this'][0]:.4f} / {by['this'][1]:.4f} ms; "
                f"{path} takes {ratio:.2f}x as long")
        out[what] = ms
    return out


def max_sm_mhz() -> int:
    """The card's maximum SM clock, which the chain model runs at."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()
    check(bool(out), "nvidia-smi gave no clocks.max.sm")
    return int(out[0])


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="DIR",
                    help="time this kernel against the one in the "
                         "checkout at DIR; nothing else runs")
    args = ap.parse_args()
    if not (ROOT / "reporter_tpu_torch" / "ops" / "csrc" / "viterbi.cu").is_file():
        fail("reporter_tpu_torch is not beside this script")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    log(f"[device] {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    spills = phase_build()
    if args.against:
        against = phase_against(dev, args.against)
        check(not spills, f"ptxas reports spills: {spills}")
        return finish(smi, {"against": args.against, "ms": against})
    phase_verify(dev)
    launches, main, max_err, scalars, served = phase_main(dev)
    serving = phase_serve(dev, served)
    phase_prefork(served)
    phase_city()
    times = phase_timing(dev, main, scalars, max_sm_mhz())
    check(not spills, f"ptxas reports spills: {spills}")

    ms, plain, bms, by = times["main"]
    ms_512, _plain, bms_512, _by = times["b512"]
    kernels = [{
        "name": "viterbi_decode",
        "route": "cuda",
        "source": "reporter_tpu_torch/ops/csrc/viterbi.cu",
        "replaces": "reporter_tpu/ops/pallas_viterbi.py:77",
        # match_many's main and mixed batches (phase_main)
        "launches": launches,
        # each timed window of the /report front door, lanes on
        # (phase_serve): the count follows how the dispatcher batched
        "launches_serve": [w["launches"] for w in serving["lanes on"]],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": None,
        # the same kernel at a fixed (512,64,8), route and gc in T-1
        # rows: the shape the line's "ms" had before the native prep
        "ms_512_64_8": ms_512,
        "bound_ms_512_64_8": bms_512,
    }]
    return finish(smi, {"kernels": kernels})


def finish(smi, result) -> int:
    """Print the card's name and power limit, ``result`` as a JSON line
    and the closing {"ok": true, ...} line; returns the exit code 0."""
    import torch
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    print(json.dumps(result), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
