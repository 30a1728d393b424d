#!/usr/bin/env python3
"""Smoke run of reporter_tpu_torch on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --against DIR

Phases, each fatal on failure:

1. build    compile ops/csrc/viterbi.cu (the decode and the incremental
            step) and ops/csrc/route_relax.cu with nvcc for sm_90a and the
            host runtime (native/csrc/host_runtime.cpp) with g++, all
            three at once, and load them, printing ptxas's registers and
            spills (any spill fails the run, after the timing)
2. verify   the kernel against its plain PyTorch version on the card at
            the main path's shapes, the native prep's layout (route and
            gc with T time rows) and shapes that reach every branch of
            the launch plan, f16 and f32 wire: paths equal, scores
            bit-equal. Then ``verify-step``: the incremental step against
            its plain version on the card and on the CPU at N of 1, 37,
            512 and 4,096 rows and K of 4, 8, 16 and 128, with ties,
            NORMAL, RESTART and SKIP rows, routes at 1e9 and +inf,
            invalid candidates and signed zeros: scores bit-equal, bp and
            prev_best equal
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
7. route-city  device routes (route_device=True) on larger cities, bodies
            byte-equal to the native CPU run with host routes and launches
            held to the chunking: 512 traces on a 40x40 grid city (1,600
            nodes, 6,240 edges), cold and warm; city's 512 on the 100x100
            city (past the node-kernel cache: every chunk relaxes, S =
            2,048), device and host routes once cold each, then ten warm
            rounds in turns, beside city's host-route wall; 64 traces on a
            125x125 grid city (15,625 nodes, past relax's shared-memory
            limit: relax_sweep), cold
8. timing   CUDA-event times of the decode kernel from CUDA graphs (the
            main path's batch, and batches and one trace at T=64/256/1024,
            twice in turns; the per-step slope and intercept; the main
            batch with the L2 flushed) and of the plain version, beside
            the least time the card could take and a model of the chain;
            then of the route kernels, by CUDA graphs: one whole
            relaxation by relax (one launch) and by relax_sweep's sweeps
            at the main path's first chunk and at the 100x100 city's, a
            relax_sweep sweep at the 125x125 city's first chunk, one
            pair_costs launch at the main path's first chunk, and their
            plain versions, beside their bounds

After main come two phases of the device route costs (``route_device``):

   verify-routes  relax against the plain relax_csr on the card at three
            shapes (the 20x20 city's first main chunk, S=512, at its
            chunk bound; the 40x40 city with 1,024 sources at 1,500 m;
            the 100x100 city's first chunk, S=2,048, at its chunk bound),
            each to convergence and capped at one sweep and at one sweep
            short; relax_sweep the same way on the 125x125 city with 64
            sources at 1,500 m: dist and time bit-equal, iters and
            converged equal. pair_costs against its plain version at
            (128, 64, 8), cached and uncached node kernels, turn penalty
            off and on, time caps and backward pairs in the inputs: route
            bit-equal, max_finite equal
   routes   match_many for main's 608 requests on the card, device
            routes (route_device=True) and host routes, each lanes on and
            inline: one cold run each, then ten warm rounds in turns;
            bodies byte-equal to the CPU runs with host routes and with
            route_device=True; launches (decode and pair_costs once per
            chunk, relax sweeps the sum of iters) and the route.device
            counters (relax: one launch and one host read per
            relaxation; the cold lanes-on run's counters, sweeps
            included, equal to the CPU run's); the prep stage's seconds
            and the wall, each setting's warm median and range, with the
            host prep's own route share (phase_ns); every chunk's device
            route tensor equal to the host prep's

After routes comes the incremental streaming decode:

   stream   SegmentMatcher.match_incremental on the card. Parity: main's
            512 uuids (every fourth under a second sigma_z), 4 raw points
            appended a call until each trace ends; the served slots equal
            a CPU run's, each served match and /report body byte-equal to
            the card's match_many of the same window and to the CPU run,
            the carried-state blobs and counters equal the CPU run's, and
            incremental_step launched once per round and parameter group.
            Fallback: a matcher with incremental_lag=2 behind a
            ReporterService; report_incremental equal to report_many slot
            for slot, viterbi_decode launches counted for the declined
            slots. Streaming legs (BENCH_STREAM_r01.json's shape): windows
            warmed to 64 and 256 raw points, lag 32, then 32 reports of
            one more point each, with 1 uuid and with 512 uuids a call:
            the incremental decode seconds and wall a call against
            match_many's of the same windows, steps per point, commits;
            served matches byte-equal to match_many's. The timing phase
            then times incremental_step by CUDA graphs at (1,8) and
            (512,8) beside its bound and the plain version

Prints the card's name and power limit, one JSON line describing the
kernels (viterbi_decode: ``launches`` match_many's in the main phase,
``launches_serve`` each timed serve window's, lanes on,
``launches_stream_fallback`` the stream phase's declined slots; relax and
pair_costs: the routes phase's device lanes-on runs, cold and the first
warm round; relax_sweep: route-city's 125x125 run, one launch a sweep;
incremental_step: the stream phase's parity leg, one launch a round),
and as the last line {"ok": true, "device": {...}}. Exits non-zero,
printing no result, without a CUDA card or without the package beside it.

With ``--against DIR`` (another checkout of the repo, such as a parent
commit unpacked with ``git archive``) only the build runs, then both
decode kernels decode the same inputs at (512,64,8) and (64,1024,8):
their outputs must be equal, and each is timed by CUDA graphs and by
launches from Python, in the order other, this, this, other. Then the
route kernels: the relaxation of the main path's first chunk and of the
100x100 city's first chunk, this checkout's relax against the other's
sweeps (by CUDA graphs, and as the matcher calls each, host reads
included), and pair_costs at the main chunk, in the same order, outputs
bit-equal. Then main's 608 requests go through match_many with
route_device=True and the lanes on, one matcher from each checkout, cold
once and ten warm rounds in turns: bodies byte-equal to host routes, the
prep stage's seconds and the wall of each run, and each side's warm
median and range.
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
MID_CITY = dict(rows=40, cols=40, spacing_m=200.0, seed=42)
# past relax's shared-memory limit (14,528 nodes): relax_sweep's graph
HUGE_CITY = dict(rows=125, cols=125, spacing_m=200.0, seed=42)
OPTS = {"mode": "auto", "report_levels": [0, 1, 2],
        "transition_levels": [0, 1, 2]}
# the stream phase: every fourth uuid of the parity leg in a second
# parameter group; the streaming legs' windows (raw points), measured
# reports and lag (BENCH_STREAM_r01.json's shape)
OPTS_B = dict(OPTS, sigma_z=5.0)
STREAM_WINDOWS = (64, 256)
STREAM_MEASURE = 32
STREAM_LAG = 32
# the longest jump between two traces stitched into one stream
SEAM_M = 800.0
# the step's checked shapes: N rows by K candidates
STEP_N = (1, 37, 512, 4096)
STEP_K = (4, 8, 16, 128)


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
    """Build the kernels (one nvcc per source) and the host runtime (g++),
    all at once; returns the ptxas spill lines that are not 0."""
    import re
    from concurrent.futures import ThreadPoolExecutor
    from reporter_tpu_torch import native
    from reporter_tpu_torch.ops import route_relax, viterbi

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(3) as pool:
        jobs = [(mod.SOURCE, pool.submit(timed, mod.build))
                for mod in (viterbi, route_relax)]
        host = pool.submit(timed, native.load)
        built = [(src, job.result()) for src, job in jobs]
        _lib, host_secs = host.result()
    spills = []
    for src, ((_fn, build_log), secs) in built:
        log(f"[build] {src.relative_to(ROOT)} -> sm_90a in {secs:.2f} s")
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line or \
                    "Compiling entry" in line:
                log(f"[build] {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and m.groups() != ("0", "0"):
                spills.append(f"{src.name}: {line.strip()}")
        check("spill stores" in build_log,
              f"nvcc printed no ptxas -v report for {src.name}")
    log(f"[build] {native.SOURCE.relative_to(ROOT)} -> g++ "
        f"{' '.join(native.cxx_flags())} in {host_secs:.2f} s (beside the "
        f"nvcc builds)")
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


def bodies(matches, reqs, report_json=None):
    """The /report bodies of ``matches``, by this package's writer unless
    given another checkout's."""
    if report_json is None:
        from reporter_tpu_torch.service.report import report_json
    return [report_json(m, r, 15, {0, 1, 2}, {0, 1, 2})
            for m, r in zip(matches, reqs)]


def main_requests(cpu_numpy):
    """main's 512 requests at T=64 and its 96 mixed ones (T=16/64/256),
    drawn from numpy seed 7 on ``cpu_numpy``'s city."""
    rng = np.random.default_rng(7)
    main = make_requests(cpu_numpy, rng, N_TRACES, [T_MAIN],
                         max(4, T_MAIN // 12))
    mixed = make_requests(cpu_numpy, rng, 96, [12, 48, 200], 21)
    return main, mixed


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


def native_batches(runtime, tb, params, chunk, **kw):
    """The native batches the dispatch builds for the TraceBatch ``tb``
    (one bucket per raw length, chunks of ``chunk``, rows padded to a
    power of two); ``kw`` goes to ``prepare_batch``."""
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
                                pad_rows=padded_batch_rows(len(part)), **kw)


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
    main, mixed = main_requests(cpu_numpy)
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


def first_chunk(runtime, params, reqs, chunk, backward=False):
    """The native prep dict of the first ``chunk`` requests (one T=64
    chunk of the main batch) and its trace count; with ``backward``, the
    first 16 traces' second point repeats the first's candidates 10 m
    further back (same-edge pairs within the backward tolerance)."""
    from reporter_tpu_torch.core.tracebatch import TraceBatch
    from reporter_tpu_torch.matcher.batchpad import (bucket_length,
                                                     prepare_batch)
    part = reqs[:chunk]
    T = bucket_length(len(part[0]["trace"]))
    prep = prepare_batch(runtime, TraceBatch.from_requests(part), params,
                         T).prep
    if backward:
        prep = dict(prep, edge_ids=prep["edge_ids"].copy(),
                    offset_m=prep["offset_m"].copy())
        prep["edge_ids"][:16, 1] = prep["edge_ids"][:16, 0]
        prep["offset_m"][:16, 1] = np.maximum(prep["offset_m"][:16, 0] - 10,
                                              0)
    return prep, len(part)


def abs_err(a, b) -> float:
    """Largest absolute difference of two f32 tensors, entries that
    compare equal (infinities included) counting 0."""
    import torch
    return float(torch.where(a == b, torch.zeros_like(a), (a - b).abs()
                             ).max())


def relax_against_plain(kernel, srcs, bound, max_iters, what):
    """``srcs`` relaxed at ``bound`` on the card by the kernel the graph
    takes (``kernel.relax_kernel``: ``relax_cuda`` over its CSR arcs, or
    ``relax_sweep_cuda``) and by the plain version: dist and time
    bit-equal, iters and converged equal. Returns (kernel dist, kernel
    time, iters, converged, the largest absolute difference)."""
    import torch
    from reporter_tpu_torch.ops import route_relax
    cols = (kernel._e_start, kernel._e_end, kernel._e_len, kernel._e_secs)
    src = torch.from_numpy(np.asarray(srcs, np.int32)).to(kernel.device)
    if kernel.relax_kernel == "relax":
        k_out = route_relax.relax_cuda(kernel._arcs, src, bound,
                                       n_nodes=kernel.n_nodes,
                                       max_iters=max_iters)
    else:
        k_out = route_relax.relax_sweep_cuda(*cols, src, bound,
                                             n_nodes=kernel.n_nodes,
                                             max_iters=max_iters)
    torch.cuda.synchronize()
    p_out = route_relax.relax_csr(*cols, src, bound, n_nodes=kernel.n_nodes,
                                  max_iters=max_iters)
    torch.cuda.synchronize()
    for name, a, b in (("dist", k_out[0], p_out[0]),
                       ("time", k_out[1], p_out[1])):
        differ = bit_equal(a, b)
        check(differ == 0, f"{kernel.relax_kernel} {name}: {differ} entries "
                           f"not bit-equal, {what}")
    check(k_out[2:] == p_out[2:], f"{kernel.relax_kernel} iters/converged "
                                  f"{k_out[2:]} against the plain "
                                  f"{p_out[2:]}, {what}")
    return (*k_out, max(abs_err(k_out[0], p_out[0]),
                        abs_err(k_out[1], p_out[1])))


def chunk_sources(kernel, prep, params, B):
    """The relaxation a chunk asks for: (its plan, its sources padded to a
    power of two by repeating the first, as ``DeviceRouteKernel`` pads
    them)."""
    from reporter_tpu_torch.graph.route_device import _next_pow2
    plan = kernel.plan(prep, params, B)
    S = _next_pow2(len(plan.srcs))
    return plan, np.concatenate([plan.srcs, np.full(S - len(plan.srcs),
                                                    plan.srcs[0], np.int32)])


def verify_relax(kernel, srcs, bound, label):
    """``relax_against_plain`` run to convergence, then with a cap of one
    sweep and a cap one short of the sweeps it needed: every run
    bit-equal, the capped ones not converged. Returns (dist, time,
    iters, the largest absolute difference)."""
    dist, time_sn, iters, ok, err = relax_against_plain(
        kernel, srcs, bound, kernel.n_nodes, label)
    check(ok, f"{label}: the relaxation did not converge")
    caps = sorted({1, max(iters - 1, 1)})
    for cap in caps:
        got = relax_against_plain(kernel, srcs, bound, cap,
                                  f"{label}, max_iters={cap}")
        check(got[2:4] == (cap, False), f"{label}, max_iters={cap}: "
                                        f"gave {got[2:4]}")
    log(f"[verify-routes] {kernel.relax_kernel}, {label} (N={kernel.n_nodes},"
        f" E={kernel.n_edges}), S={len(srcs)} at {float(bound):.1f} m: "
        f"{iters} sweeps, converged; and capped at {caps} sweeps, not "
        f"converged: dist and time bit-equal to the plain version, iters "
        f"and converged equal")
    return dist, time_sn, iters, err


def phase_verify_routes(dev, served, big, huge):
    """The route kernels against their plain versions on the card, same
    inputs. ``relax`` at three shapes: the 20x20 city with the first main
    chunk's sources (S = 512 after padding) at its chunk bound, the 40x40
    city with 1,024 seeded sources at 1,500 m, and the 100x100 city with
    the first chunk of ``big``'s requests (S = 2,048) at its chunk bound;
    each run to convergence and with caps of one sweep and of one sweep
    short: dist and time bit-equal, iters and converged equal.
    ``relax_sweep`` on ``huge``'s 125x125 grid (15,625 nodes, past
    ``relax``'s shared-memory limit) with 64 seeded sources at 1,500 m,
    the same way. ``pair_costs`` at the first main chunk's (128, 64, 8), its first
    16 traces given same-edge backward pairs, on the cached (N, N) and
    the uncached (S, N) kernels, with the turn penalty off and on (time
    caps are armed by the default params): route bit-equal and
    max_finite equal. Returns each kernel's largest absolute difference
    from its plain version."""
    import torch
    from reporter_tpu_torch.graph.route_device import (DeviceRouteKernel,
                                                       pack_blobs)
    from reporter_tpu_torch.matcher import SegmentMatcher
    from reporter_tpu_torch.ops import route_relax
    from reporter_tpu_torch.synth import build_grid_city
    city, params = served["city"], served["params"]
    cpu = SegmentMatcher(city, params, device="cpu")
    kernel = DeviceRouteKernel(city, dev)
    check(kernel.relax_kernel == "relax",
          f"the 20x20 city takes {kernel.relax_kernel}")
    prep, B = first_chunk(cpu.runtime, params, served["reqs"], 128,
                          backward=True)
    plan, srcs = chunk_sources(kernel, prep, params, B)
    check(len(srcs) == 512, f"the first main chunk relaxes {len(srcs)} "
                            f"sources, not 512")
    dist, time_sn, _iters, relax_err = verify_relax(
        kernel, srcs, plan.chunk_bound, "20x20 city, first main chunk")
    mid = DeviceRouteKernel(build_grid_city(**MID_CITY), dev)
    relax_err = max(relax_err, verify_relax(
        mid, np.random.default_rng(6).choice(mid.n_nodes, 1024,
                                             replace=False),
        np.float32(1500.0), "40x40 city")[3])
    del mid
    bk = DeviceRouteKernel(big["city"], dev)
    big_plan, big_srcs = first_chunk_sources(bk, big)
    check(len(big_srcs) == 2048, f"the 100x100 city's first chunk relaxes "
                                 f"{len(big_srcs)} sources, not 2,048")
    relax_err = max(relax_err, verify_relax(
        bk, big_srcs, big_plan.chunk_bound,
        "100x100 city, first chunk")[3])
    del bk
    hk = DeviceRouteKernel(huge["city"], dev)
    check(hk.relax_kernel == "relax_sweep",
          f"the 125x125 city takes {hk.relax_kernel}")
    sweep_err = verify_relax(
        hk, np.random.default_rng(7).choice(hk.n_nodes, 64, replace=False),
        np.float32(1500.0), "125x125 city")[3]
    del hk

    # node kernels on both layouts: rows of the relaxed sources (S, N), and
    # the cache's (N, N) with row i = node i
    N = kernel.n_nodes
    layouts = {}
    row = np.full(N, -1, np.int32)
    row[plan.srcs] = np.arange(len(plan.srcs), dtype=np.int32)
    layouts["uncached"] = (dist, time_sn, row)
    full = [torch.full((N, N), float("inf"), device=dev) for _ in range(2)]
    idx = torch.from_numpy(plan.srcs.astype(np.int64)).to(dev)
    for f, part in zip(full, (dist, time_sn)):
        f.index_copy_(0, idx, part[:len(plan.srcs)])
    row = np.full(N, -1, np.int32)
    row[plan.srcs] = plan.srcs
    layouts["cached"] = (*full, row)
    Bc, T, Kc = plan.edge.shape
    edge = plan.edge
    same = edge[:, 1:, None, :] == edge[:, :-1, :, None]
    back = same & (plan.offset[:, 1:, None, :] < plan.offset[:, :-1, :, None])
    check(bool(back.any()) and bool((plan.caps >= 0).any()),
          "no backward pairs or no time caps in the pair-costs inputs")
    cols = kernel.edge_columns()
    pair_max_err = 0.0
    for name, (d_sn, t_sn, node_row) in layouts.items():
        for tpen in (0.0, 0.5):
            ints, f32s = (torch.from_numpy(a).to(dev) for a in pack_blobs(
                edge, plan.offset, plan.nk, plan.bounds, plan.caps, node_row,
                params.backward_tolerance_m, tpen))
            k_route, k_max = route_relax.pair_costs_cuda(
                ints, f32s, d_sn, t_sn, *cols, B=Bc, T=T, K=Kc, N=N)
            torch.cuda.synchronize()
            p_route, p_max = route_relax.pair_costs_packed(
                ints, f32s, d_sn, t_sn, *cols, B=Bc, T=T, K=Kc, N=N)
            torch.cuda.synchronize()
            what = f"pair_costs ({Bc},{T},{Kc}) {name}, turn penalty {tpen}"
            differ = bit_equal(k_route, p_route)
            check(differ == 0, f"{what}: {differ} entries not bit-equal")
            check(float(k_max) == float(p_max),
                  f"{what}: max_finite {float(k_max)} against the plain "
                  f"{float(p_max)}")
            finite = k_route < route_relax.UNREACHABLE
            pair_max_err = max(pair_max_err, abs_err(k_route, p_route))
            n_back = int((back & (k_route.cpu().numpy() == 0.0)).sum())
            log(f"[verify-routes] {what}: route bit-equal, max_finite "
                f"{float(k_max):.3f} equal; {int(finite.sum())} finite of "
                f"{k_route.numel()}, {n_back} free backward pairs")
    return {"relax_err": relax_err, "sweep_err": sweep_err,
            "pair_err": pair_max_err}


def counted_run(matcher, reqs):
    """One match_many + report_json of ``reqs`` with every kernel's launch
    count, the metrics and the stage seconds set to 0 just before and read
    just after: (bodies, wall seconds, {kernel: launches}, counters, stage
    seconds)."""
    from reporter_tpu_torch import ops
    from reporter_tpu_torch.utils import metrics
    for k in matcher.stage_seconds:
        matcher.stage_seconds[k] = 0.0
    metrics.default.reset()
    for fn in kernel_wrappers().values():
        fn.launches = 0
    ops.relax_cuda.reads = 0
    t0 = time.perf_counter()
    out = bodies(matcher.match_many(reqs), reqs)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernel_wrappers().items()}
    launches["relax_reads"] = ops.relax_cuda.reads
    return (out, wall, launches, metrics.snapshot()["counters"],
            {k: round(v, 4) for k, v in matcher.stage_seconds.items()})


def kernel_wrappers():
    """Each kernel's counted wrapper, by the name the ``kernels`` line
    gives it (``relax_sweep``'s counts sweeps)."""
    from reporter_tpu_torch import ops
    return {"viterbi_decode": ops.viterbi_cuda, "relax": ops.relax_cuda,
            "relax_sweep": ops.relax_sweep_cuda,
            "pair_costs": ops.pair_costs_cuda}


def check_route_launches(what, reqs, chunk, launches, counters, kernel):
    """The chunking's launch counts: the decode and ``pair_costs`` once per
    chunk (every chunk here has live transitions); with ``relax`` one
    launch and one host read (iters and converged) per relaxation, with
    ``relax_sweep`` one launch per sweep (the sum of the relaxations'
    iters), and never the other."""
    chunks = expected_launches(reqs, chunk)
    routed = counters.get("route.device.chunks", 0)
    relaxes = counters.get("route.device.relaxes", 0)
    sweeps = counters.get("route.device.sweeps", 0)
    check(launches["viterbi_decode"] == chunks,
          f"{what}: {launches['viterbi_decode']} decode launches, want "
          f"{chunks}")
    check(routed + counters.get("route.device.empty_chunks", 0) == chunks
          and launches["pair_costs"] == routed == chunks,
          f"{what}: {launches['pair_costs']} pair_costs launches for "
          f"{routed} routed chunks, want {chunks}")
    want = ({"relax": relaxes, "relax_reads": relaxes, "relax_sweep": 0}
            if kernel == "relax" else
            {"relax": 0, "relax_reads": 0, "relax_sweep": sweeps})
    got = {k: launches[k] for k in want}
    check(got == want, f"{what}: relaxation launches {got}, want {want} "
                       f"({relaxes} relaxations of {sweeps} sweeps in all)")


def route_counters(counters) -> dict:
    from reporter_tpu_torch.utils.metrics import ROUTE_DEVICE_COUNTERS
    return {k.split(".", 2)[2]: counters.get(k, 0)
            for k in ROUTE_DEVICE_COUNTERS}


#: phase_routes' settings: (route_device, pipeline)
ROUTE_SETTINGS = {"device, lanes on": (True, True),
                  "host, lanes on": (False, True),
                  "device, inline": (True, False),
                  "host, inline": (False, False)}
#: warm rounds in turns, in phase_routes and in the --against comparison
ROUTE_WARM_ROUNDS = 10


def phase_routes(dev, served):
    """match_many on the card for main's 512 + 96 requests in each of
    ``ROUTE_SETTINGS``: device routes (``route_device=True``) or host
    routes, lanes on or inline. Each setting runs once cold (a new
    matcher: empty node-kernel cache, cold route memo), then
    ``ROUTE_WARM_ROUNDS`` warm rounds in turns (the order reversed every
    other round). Every body is byte-equal to the port's native CPU run
    with host routes and to its CPU run with ``route_device=True`` (the
    plain versions); device launches are held to the chunking. Prints each
    run's prep-stage seconds, wall and the host prep's own route share
    (``phase_ns``), and each setting's warm median and range. Then every
    chunk's device route tensor, rebuilt by
    ``prepare_batch(route_kernel=...)``, is held equal to the host prep's.
    Returns the lanes-on device setting's kernel launches (cold and the
    first warm round) and the runs' numbers."""
    from reporter_tpu_torch.core.tracebatch import TraceBatch
    from reporter_tpu_torch.matcher import SegmentMatcher
    city, params = served["city"], served["params"]
    reqs, want = served["reqs"], served["want"]
    from reporter_tpu_torch.utils import metrics
    t0 = time.perf_counter()
    cpu_dev = SegmentMatcher(city, params, device="cpu", route_device=True)
    metrics.default.reset()
    check(bodies(cpu_dev.match_many(reqs), reqs) == want,
          "the port's CPU run with route_device=True differs from host "
          "routes")
    cpu_route = route_counters(metrics.snapshot()["counters"])
    log(f"[routes] the CPU run with route_device=True (plain versions): "
        f"all {len(reqs)} bodies byte-equal to host routes, "
        f"{time.perf_counter() - t0:.2f} s; route.device {cpu_route}")
    matchers = {name: SegmentMatcher(city, params, route_device=device,
                                     pipeline=pipeline)
                for name, (device, pipeline) in ROUTE_SETTINGS.items()}
    names = list(ROUTE_SETTINGS)
    order = [(name, "cold") for name in names]
    for r in range(ROUTE_WARM_ROUNDS):
        order += [(name, f"warm {r + 1}")
                  for name in (names if r % 2 == 0 else names[::-1])]
    runs, launches = {}, {"relax": 0, "pair_costs": 0}
    warm = {name: {"prep": [], "wall": []} for name in names}
    for name, run in order:
        m = matchers[name]
        got, wall, n, ctr, stages = counted_run(m, reqs)
        what = f"{name}, {run}"
        check(got == want, f"{what}: /report bodies differ from the native "
                           f"CPU run with host routes")
        if name.startswith("device"):
            check_route_launches(what, reqs, m.chunk, n, ctr,
                                 m.route_kernel.relax_kernel)
        if name == "device, lanes on" and run == "cold":
            # the same chunking as the CPU run: the same relaxations, so
            # the same sources, cache rows and sweeps, the plain
            # version's count
            check(route_counters(ctr) == cpu_route,
                  f"{what}: route.device {route_counters(ctr)}, the CPU "
                  f"run's {cpu_route}")
        if name == "device, lanes on" and run in ("cold", "warm 1"):
            for k in launches:
                launches[k] += n[k]
        if run != "cold":
            warm[name]["prep"].append(m.stage_seconds["prep"])
            warm[name]["wall"].append(wall)
        phase = {k: ctr.get(f"prep.phase.{k}_ns", 0)
                 for k in ("candidates", "select", "routes")}
        share = phase["routes"] / max(sum(phase.values()), 1)
        runs[what] = {"wall_s": wall, "stages": stages, "launches": n,
                      "route": route_counters(ctr), "phase_ns": phase}
        sweeps = ctr.get("route.device.sweeps", 0)
        relaxes = ctr.get("route.device.relaxes", 0)
        log(f"[routes] {what}: {len(reqs)} traces in {wall:.4f} s "
            f"({len(reqs) / wall:.1f} traces/s), prep "
            f"{m.stage_seconds['prep']:.6f} s, stage seconds {stages}; "
            f"launches {n}; native prep phase_ns {phase} (routes "
            f"{share:.1%}); sweeps per relax "
            f"{sweeps / relaxes if relaxes else 0:.1f}; route.device "
            f"{route_counters(ctr)}")
    for name in names:
        p, w = warm[name]["prep"], warm[name]["wall"]
        log(f"[routes] {name}, {len(p)} warm rounds: prep median "
            f"{float(np.median(p)):.6f} s (range {min(p):.6f}-{max(p):.6f}),"
            f" wall median {float(np.median(w)):.6f} s (range "
            f"{min(w):.6f}-{max(w):.6f})")
    runs["warm"] = warm

    gpu = matchers["device, lanes on"]
    cpu = SegmentMatcher(city, params, device="cpu")
    tb = TraceBatch.from_requests(reqs)
    n_chunks = 0
    for host, got in zip(
            native_batches(cpu.runtime, tb, params, gpu.chunk),
            native_batches(gpu.runtime, tb, params, gpu.chunk,
                           route_kernel=gpu.route_kernel, defer_routes=True)):
        got.finalize_wire()
        got.routes_to_host()
        B, T = len(host.traces), host.case.shape[1]
        check(got.prep["route_m"][:B, :T - 1].tobytes()
              == host.prep["route_m"][:B, :T - 1].tobytes()
              and got.prep["max_finite"][0] == host.prep["max_finite"][0],
              f"chunk {n_chunks} ({B}, {T}): device route rows differ from "
              f"the host prep's")
        check(got.route_m.device.type == dev.type
              and got.route_m.cpu().numpy().tobytes()
              == host.route_m.tobytes(),
              f"chunk {n_chunks}: the wire route tensor on the card differs "
              f"from the host prep's")
        n_chunks += 1
    log(f"[routes] all {n_chunks} chunks: the device route tensor equal to "
        f"the host prep's route_m[:B, :T-1] (and on the {host.route_m.dtype} "
        f"wire, filler rows and the dead step included)")
    return launches, runs


def phase_route_city(big, huge):
    """Device routes on larger cities, each against host routes. 512
    traces of the T=64 bucket with ``route_device=True`` on a 40x40 grid
    city (1,600 nodes, 6,240 edges, its node kernels cached), cold and
    warm; ``big``'s 512 on the 100x100 city (10,000 nodes, past the
    node-kernel cache: every chunk relaxes, S = 2,048), device routes and
    host routes each once cold on a new matcher, then
    ``ROUTE_WARM_ROUNDS`` warm rounds in turns; and ``huge``'s 64 traces
    on the 125x125 city (15,625 nodes), whose relaxations
    ``relax_sweep`` runs, cold. Every body byte-equal to the native CPU run with host routes,
    launches held to the chunking. Returns the 125x125 run's
    ``relax_sweep`` launches and the 100x100 runs' numbers."""
    from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
    from reporter_tpu_torch.synth import build_grid_city
    t0 = time.perf_counter()
    city = build_grid_city(**MID_CITY)
    params = MatchParams(max_candidates=K)
    reqs = draw_requests(city, np.random.default_rng(13), N_TRACES, [T_MAIN],
                         max(4, T_MAIN // 12))
    want = bodies(SegmentMatcher(city, params, device="cpu").match_many(reqs),
                  reqs)
    gpu = SegmentMatcher(city, params, route_device=True)
    check(gpu.route_kernel._cache_ok, "the 40x40 city is not cached")
    log(f"[route-city] {city.num_nodes} nodes / {city.num_edges} edges, "
        f"{len(reqs)} T={T_MAIN} requests and their CPU bodies in "
        f"{time.perf_counter() - t0:.2f} s")
    for run in ("cold", "warm"):
        got, wall, n, ctr, stages = counted_run(gpu, reqs)
        check(got == want, f"40x40 city, {run}: /report bodies differ from "
                           f"the native CPU run with host routes")
        check_route_launches(f"40x40 city, {run}", reqs, gpu.chunk, n, ctr,
                             "relax")
        log(f"[route-city] 40x40 city, {run}: {N_TRACES / wall:.1f} "
            f"traces/s ({wall:.4f} s wall), stage seconds {stages} "
            f"(overlapped); launches {n}; route.device "
            f"{route_counters(ctr)}; bodies byte-equal to host routes")

    # the 100x100 city: device routes against host routes, in turns
    city, params, reqs, want = (big[k] for k in ("city", "params", "reqs",
                                                 "want"))
    sides = {"device": SegmentMatcher(city, params, route_device=True),
             "host": SegmentMatcher(city, params)}
    check(not sides["device"].route_kernel._cache_ok
          and sides["device"].route_kernel.relax_kernel == "relax",
          "the 100x100 city is cached, or does not take relax")
    order = [("device", "cold"), ("host", "cold")]
    for r in range(ROUTE_WARM_ROUNDS):
        pair = ["device", "host"] if r % 2 == 0 else ["host", "device"]
        order += [(name, f"warm {r + 1}") for name in pair]
    runs = {name: {"cold": None, "wall": [], "prep": []} for name in sides}
    for name, run in order:
        m = sides[name]
        got, wall, n, ctr, stages = counted_run(m, reqs)
        what = f"100x100 city, {name} routes, {run}"
        check(got == want, f"{what}: /report bodies differ from the native "
                           f"CPU run with host routes")
        if name == "device":
            check_route_launches(what, reqs, m.chunk, n, ctr, "relax")
        if run == "cold":
            runs[name]["cold"] = {"wall_s": wall, "stages": stages}
        else:
            runs[name]["wall"].append(wall)
            runs[name]["prep"].append(stages["prep"])
        log(f"[route-city] {what}: {len(reqs)} traces in {wall:.4f} s "
            f"({len(reqs) / wall:.1f} traces/s), stage seconds {stages} "
            f"(overlapped); launches {n}; route.device "
            f"{route_counters(ctr)}")
    for name in sides:
        w, p = runs[name]["wall"], runs[name]["prep"]
        log(f"[route-city] 100x100 city, {name} routes, {len(w)} warm "
            f"rounds: wall median {float(np.median(w)):.6f} s (range "
            f"{min(w):.6f}-{max(w):.6f}), prep median "
            f"{float(np.median(p)):.6f} s (range {min(p):.6f}-{max(p):.6f})")
    wins = sum(d < h for d, h in zip(runs["device"]["wall"],
                                     runs["host"]["wall"]))
    log(f"[route-city] 100x100 city: device routes shorter in wall in {wins} "
        f"of {ROUTE_WARM_ROUNDS} warm pairs; cold {runs['device']['cold']} "
        f"against host {runs['host']['cold']}; [city]'s host-route wall "
        f"{big['host_wall_s']:.4f} s")

    # relax_sweep on the main path: a graph past relax's limit
    city, params, reqs = huge["city"], huge["params"], huge["reqs"]
    want = bodies(SegmentMatcher(city, params, device="cpu").match_many(reqs),
                  reqs)
    gpu = SegmentMatcher(city, params, route_device=True)
    check(gpu.route_kernel.relax_kernel == "relax_sweep",
          f"the 125x125 city takes {gpu.route_kernel.relax_kernel}")
    got, wall, n, ctr, stages = counted_run(gpu, reqs)
    check(got == want, "125x125 city: /report bodies differ from the native "
                       "CPU run with host routes")
    check_route_launches("125x125 city", reqs, gpu.chunk, n, ctr,
                         "relax_sweep")
    log(f"[route-city] 125x125 city ({city.num_nodes} nodes / "
        f"{city.num_edges} edges), {len(reqs)} traces, cold: {wall:.4f} s "
        f"wall, stage seconds {stages}; launches {n}; route.device "
        f"{route_counters(ctr)}; bodies byte-equal to host routes")
    return n["relax_sweep"], runs


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


def grid_inputs(shape, n, seed):
    """A grid city of ``shape`` (a dict of build_grid_city's arguments),
    its params and ``n`` requests of the T=64 bucket drawn from numpy
    ``seed``."""
    from reporter_tpu_torch.matcher import MatchParams
    from reporter_tpu_torch.synth import build_grid_city
    t0 = time.perf_counter()
    city = build_grid_city(**shape)
    reqs = draw_requests(city, np.random.default_rng(seed), n, [T_MAIN],
                         max(4, T_MAIN // 12))
    log(f"[inputs] {shape['rows']}x{shape['cols']} city: {city.num_nodes} "
        f"nodes / {city.num_edges} edges, {len(reqs)} T={T_MAIN} requests "
        f"in {time.perf_counter() - t0:.2f} s")
    return {"city": city, "params": MatchParams(max_candidates=K),
            "reqs": reqs}


def phase_city(big):
    """``big``'s 512 traces on the 100x100 city through the native matcher
    on the card, lanes on: bodies byte-equal to the port's native CPU run
    (kept in ``big["want"]``, with the wall in ``big["host_wall_s"]``),
    and the kernel's launches counted in this phase."""
    from reporter_tpu_torch.matcher import SegmentMatcher
    city, params, reqs = big["city"], big["params"], big["reqs"]
    gpu = SegmentMatcher(city, params)
    cpu = SegmentMatcher(city, params, device="cpu")
    got, wall, launches, stages = timed_run(gpu, reqs)
    want = expected_launches(reqs, gpu.chunk)
    check(launches == want, f"{launches} kernel launches, want {want}")
    big["want"] = bodies(cpu.match_many(reqs), reqs)
    big["host_wall_s"] = wall
    check(got == big["want"],
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


def first_chunk_sources(kernel, city_inputs, backward=False):
    """(plan, padded sources, prep) of the first 128-trace chunk of
    ``city_inputs``' requests (a dict of city, params and reqs, as
    ``big_city`` gives)."""
    from reporter_tpu_torch.matcher import SegmentMatcher
    params = city_inputs["params"]
    runtime = SegmentMatcher(city_inputs["city"], params,
                             device="cpu").runtime
    prep, B = first_chunk(runtime, params, city_inputs["reqs"], 128,
                          backward=backward)
    plan, srcs = chunk_sources(kernel, prep, params, B)
    return plan, srcs


def bound_of(n_bytes, n_ops):
    """(ms, "bytes" or "operations"): the larger of the two floors."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def relax_bound(kernel, S, dist):
    """``relax``'s least time for one relaxation: the (S, N) dist and time
    planes written, the sources and the CSR arcs read once; two adds, a
    compare and a min for every arc out of every node a row reached (this
    run's data: each such arc is relaxed at least once)."""
    import torch
    N, E = kernel.n_nodes, kernel.n_edges
    outdeg = torch.diff(kernel._arcs.offsets).to(torch.float32)
    arcs = float((torch.isfinite(dist).to(torch.float32) @ outdeg).sum())
    n_bytes = 8 * S * N + 4 * S + 4 * (N + 1) + 12 * E
    return (*bound_of(n_bytes, 4 * arcs), n_bytes)


def sweep_bound(S, N, E):
    """``relax_sweep``'s least time for one sweep: S*N packed words read
    and written, the E edge columns read; per (row, edge) two adds, a
    compare and a min."""
    n_bytes = 16 * S * N + 16 * E
    return (*bound_of(n_bytes, 4 * S * E), n_bytes)


def time_relaxations(dev, kernel, srcs, bound, label, other=None):
    """One relaxation of ``srcs`` at ``bound`` timed by CUDA graphs:
    ``relax`` in one launch where the graph takes it, ``relax_sweep``'s
    sweeps back to back after a state reset, and with ``other`` (another
    checkout's ``ops.route_relax``) its sweeps the same way; each result
    bit-equal to the plain version's; then the plain version's time.
    Returns {"relax"|"relax_sweep"|"other"|"plain": ms, "iters":
    sweeps}."""
    import torch
    from reporter_tpu_torch.ops import route_relax
    N = kernel.n_nodes
    src = torch.from_numpy(np.asarray(srcs, np.int32)).to(dev)
    cols = (kernel._e_start, kernel._e_end, kernel._e_len, kernel._e_secs)

    def sweeps(mod, name):
        """``mod``'s sweeps, timed, then their final state held bit-equal
        to the plain version's."""
        start = mod.pack_sources(src, N)
        bufs = (start.clone(), torch.empty_like(start))
        flag = torch.zeros(1, dtype=torch.int32, device=dev)

        def run():
            bufs[0].copy_(start)
            for k in range(iters):
                mod.launch_sweep(bufs[k % 2], bufs[1 - k % 2], *cols, bound,
                                 flag)
        out[name] = graph_ms(run, max(1, n // 4))
        for got, want in zip(route_relax.unpack_state(bufs[iters % 2]),
                             plain[:2]):
            check(bit_equal(got, want) == 0,
                  f"{label}: {name}'s relaxation differs from the plain "
                  f"version")

    plain = route_relax.relax_csr(*cols, src, bound, n_nodes=N, max_iters=N)
    check(plain[3], f"{label}: the timed relaxation did not converge")
    out = {"iters": plain[2]}
    iters = plain[2]
    n = max(2, min(50, int(2e7 // (len(srcs) * N))))
    if kernel.relax_kernel == "relax":
        planes = torch.empty((2, len(srcs), N), device=dev)
        info = torch.zeros(3, dtype=torch.int32, device=dev)
        out["relax"] = graph_ms(lambda: route_relax.launch_relax(
            kernel._arcs, src, bound, N, planes[0], planes[1], info), n)
        for got, want in zip(planes, plain[:2]):
            check(bit_equal(got, want) == 0,
                  f"{label}: relax differs from the plain version")
    sweeps(route_relax, "relax_sweep")
    if other is not None:
        sweeps(other, "other")
    del plain
    out["plain"] = time_ms(lambda: route_relax.relax_csr(
        *cols, src, bound, n_nodes=N, max_iters=N), 2)
    torch.cuda.empty_cache()
    return out


def phase_timing_routes(dev, served, big, huge):
    """The route kernels at the main path's shapes, timed by CUDA graphs,
    each beside its bound and its plain version. ``relax``: one
    relaxation of the main path's first chunk (the 20x20 city, 128 T=64
    traces: S = 512 sources) and of the 100x100 city's first chunk (S =
    2,048), with ``relax_sweep``'s sweeps on the same inputs beside it
    (the kernel it replaced on these graphs). ``relax_sweep``: a sweep of
    the 125x125 city's first chunk, the graph past ``relax``'s limit.
    ``pair_costs``: one launch at the main chunk's (128, 64, 8) from the
    cached (N, N) node kernels, default params. Returns {kernel: (ms,
    plain ms, bound ms, bound by)} and the 100x100 numbers."""
    import torch
    from reporter_tpu_torch.graph.route_device import (DeviceRouteKernel,
                                                       pack_blobs)
    from reporter_tpu_torch.ops import route_relax
    city, params = served["city"], served["params"]
    out = {}
    for name, inputs in (("20x20", {"city": city, "params": params,
                                    "reqs": served["reqs"]}),
                         ("100x100", big)):
        kernel = DeviceRouteKernel(inputs["city"], dev)
        plan, srcs = first_chunk_sources(kernel, inputs)
        bound = float(plan.chunk_bound)
        ms = time_relaxations(dev, kernel, srcs, bound, name)
        dist = route_relax.relax_cuda(
            kernel._arcs, torch.from_numpy(srcs).to(dev), bound,
            n_nodes=kernel.n_nodes, max_iters=kernel.n_nodes)[0]
        r_bound, r_by, r_bytes = relax_bound(kernel, len(srcs), dist)
        log(f"[timing] relax, {name} city's first chunk (S={len(srcs)}, "
            f"N={kernel.n_nodes}, E={kernel.n_edges}) at {bound:.1f} m, "
            f"{ms['iters']} sweeps: {ms['relax']:.4f} ms in one launch; "
            f"relax_sweep's sweeps on the same inputs {ms['relax_sweep']:.4f}"
            f" ms ({ms['relax_sweep'] / ms['iters']:.4f} ms a sweep; "
            f"{ms['relax_sweep'] / ms['relax']:.2f}x relax); plain "
            f"{ms['plain']:.3f} ms; bound {r_bound:.5f} ms by {r_by} "
            f"({r_bytes} bytes)")
        out[f"relax {name}"] = (ms, r_bound, r_by)
        if name == "20x20":
            main_kernel, main_plan, main_srcs = kernel, plan, srcs
        del dist
        torch.cuda.empty_cache()

    kernel = DeviceRouteKernel(huge["city"], dev)
    plan, srcs = first_chunk_sources(kernel, huge)
    ms = time_relaxations(dev, kernel, srcs, float(plan.chunk_bound),
                          "125x125")
    s_bound = sweep_bound(len(srcs), kernel.n_nodes, kernel.n_edges)
    sweep_ms = ms["relax_sweep"] / ms["iters"]
    plain_sweep = ms["plain"] / ms["iters"]
    log(f"[timing] relax_sweep, 125x125 city's first chunk (S={len(srcs)}, "
        f"N={kernel.n_nodes}, E={kernel.n_edges}) at "
        f"{float(plan.chunk_bound):.1f} m: {ms['iters']} sweeps (state "
        f"reset included) {ms['relax_sweep']:.4f} ms = {sweep_ms:.4f} ms a "
        f"sweep; plain {ms['plain']:.3f} ms ({plain_sweep:.3f} a sweep); "
        f"bound {s_bound[0]:.5f} ms a sweep by {s_bound[1]} ({s_bound[2]} "
        f"bytes)")
    out["relax_sweep"] = (sweep_ms, plain_sweep, s_bound[0], s_bound[1])
    del kernel
    torch.cuda.empty_cache()

    # the main path's assembly: the cached (N, N) node kernels
    kernel, plan, srcs = main_kernel, main_plan, main_srcs
    N = kernel.n_nodes
    dist, time_sn, _i, _ok = route_relax.relax_cuda(
        kernel._arcs, torch.from_numpy(srcs).to(dev), float(plan.chunk_bound),
        n_nodes=N, max_iters=N)
    full = [torch.full((N, N), float("inf"), device=dev) for _ in range(2)]
    idx = torch.from_numpy(plan.srcs.astype(np.int64)).to(dev)
    for f, part in zip(full, (dist, time_sn)):
        f.index_copy_(0, idx, part[:len(plan.srcs)])
    node_row = np.full(N, -1, np.int32)
    node_row[plan.srcs] = plan.srcs
    ints, f32s = (torch.from_numpy(a).to(dev) for a in pack_blobs(
        plan.edge, plan.offset, plan.nk, plan.bounds, plan.caps, node_row,
        params.backward_tolerance_m, params.turn_penalty_factor))
    Bc, T, Kc = plan.edge.shape
    route = torch.empty((Bc, T - 1, Kc, Kc), device=dev)
    max_bits = torch.zeros(1, dtype=torch.int32, device=dev)
    edges = kernel.edge_columns()
    pair_ms = graph_ms(lambda: route_relax.launch_pair_costs(
        ints, f32s, *full, edges, Bc, T, Kc, N, route, max_bits), 100)
    plain_pair = time_ms(lambda: route_relax.pair_costs_packed(
        ints, f32s, *full, *edges, B=Bc, T=T, K=Kc, N=N), 5)
    pair_bytes = route.numel() * 4 + ints.numel() * 4 + f32s.numel() * 4
    pair_ops = route.numel() * 25  # the emit ladder, about 25 f32 ops
    pair_bound = bound_of(pair_bytes, pair_ops)
    log(f"[timing] pair_costs ({Bc},{T},{Kc}), cached (N, N) kernels: "
        f"{pair_ms:.4f} ms; plain {plain_pair:.3f} ms; bound "
        f"{pair_bound[0]:.5f} ms by {pair_bound[1]} ({pair_bytes} bytes: "
        f"the route tensor written, the blobs read; {pair_ops} f32 ops)")
    log("[timing] library: no single PyTorch call computes a bounded "
        "relaxation or the emit ladder")
    ms, r_bound, r_by = out.pop("relax 20x20")
    out["relax"] = (ms["relax"], ms["plain"], r_bound, r_by)
    out["pair_costs"] = (pair_ms, plain_pair, *pair_bound)
    return out


def load_other(path, module):
    """The ``reporter_tpu_torch.<module>`` module of the checkout at
    ``path``, its package imported once under a name of its own beside
    this one; it builds its kernels and host runtime into that
    checkout."""
    import importlib
    import importlib.util
    name = "other_reporter_tpu_torch"
    if name not in sys.modules:
        root = Path(path).resolve() / "reporter_tpu_torch"
        check((root / "ops" / "viterbi.py").is_file(),
              f"no reporter_tpu_torch/ops/viterbi.py under {path}")
        spec = importlib.util.spec_from_file_location(
            name, root / "__init__.py",
            submodule_search_locations=[str(root)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(f"{name}.{module}")


def phase_against(dev, path):
    """This checkout's kernel against the one at ``path`` (K=8, f16 wire,
    same inputs): paths equal and scores bit-equal, then each timed per
    launch by CUDA graphs (``graph_ms``) and by launches from Python back
    to back (``time_ms``), in the order other, this, this, other. Returns
    {"B,T,K": {method: {"other": [ms, ms], "this": [ms, ms]}}}."""
    import torch
    from reporter_tpu_torch.ops import viterbi
    other = load_other(path, "ops.viterbi")
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


def host_ms(fn, n):
    """Host-clock time of ``fn`` per call, ``n`` calls after one more,
    ending in a synchronise: what a caller waits, host reads included."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def phase_against_route_kernels(dev, path):
    """The route kernels of this checkout against the ones at ``path``, in
    one process, on the same inputs: the relaxation of the main path's
    first chunk (20x20 city, S = 512) and of the 100x100 city's first
    chunk (S = 2,048), as ``relax`` (one launch) here and as ``path``'s
    sweeps, timed by CUDA graphs (each result bit-equal to the plain
    version) and as the matcher calls each, host reads included, on the
    host's clock; then ``pair_costs`` at the main chunk's (128, 64, 8)
    from the cached (N, N) kernels by CUDA graphs, outputs equal. Every
    timing in the order other, this, this, other."""
    import torch
    from reporter_tpu_torch.graph.route_device import (DeviceRouteKernel,
                                                       pack_blobs)
    from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
    from reporter_tpu_torch.ops import route_relax
    from reporter_tpu_torch.synth import build_grid_city
    other = load_other(path, "ops.route_relax")
    other.build()
    # the other checkout's sweep loop (its relax_cuda before this slice)
    other_sweeps = getattr(other, "relax_sweep_cuda", other.relax_cuda)
    city = build_grid_city(**CITY)
    params = MatchParams(max_candidates=K)
    main, _mixed = main_requests(
        SegmentMatcher(city, params, device="cpu", native=False))
    out = {}
    for name, inputs in (("20x20", {"city": city, "params": params,
                                    "reqs": main}),
                         ("100x100", grid_inputs(BIG_CITY, 128, 11))):
        kernel = DeviceRouteKernel(inputs["city"], dev)
        plan, srcs = first_chunk_sources(kernel, inputs)
        bound = float(plan.chunk_bound)
        src = torch.from_numpy(srcs).to(dev)
        N = kernel.n_nodes
        cols = (kernel._e_start, kernel._e_end, kernel._e_len,
                kernel._e_secs)
        fns = {"this": lambda: route_relax.relax_cuda(
                   kernel._arcs, src, bound, n_nodes=N, max_iters=N),
               "other": lambda: other_sweeps(
                   *cols, src, bound, n_nodes=N, max_iters=N)}
        ms = {"graph": {"other": [], "this": []},
              "host": {"other": [], "this": []}}
        for side in ("other", "this", "this", "other"):
            got = time_relaxations(dev, kernel, srcs, bound, name,
                                   other if side == "other" else None)
            ms["graph"][side].append(got["other" if side == "other"
                                         else "relax"])
            ms["host"][side].append(host_ms(fns[side], 20))
        for method, by in ms.items():
            log(f"[against] relaxation, {name} city's first chunk "
                f"(S={len(srcs)}, N={N}, {got['iters']} sweeps), {method}: "
                f"{path} {by['other'][0]:.4f} / {by['other'][1]:.4f} ms, "
                f"this {by['this'][0]:.4f} / {by['this'][1]:.4f} ms; {path} "
                f"takes {np.mean(by['other']) / np.mean(by['this']):.2f}x as "
                f"long")
        out[f"relax {name}"] = ms
        if name == "20x20":
            dist, time_sn = fns["this"]()[:2]
            main_kernel, main_plan = kernel, plan

    kernel, plan = main_kernel, main_plan
    N = kernel.n_nodes
    full = [torch.full((N, N), float("inf"), device=dev) for _ in range(2)]
    idx = torch.from_numpy(plan.srcs.astype(np.int64)).to(dev)
    for f, part in zip(full, (dist, time_sn)):
        f.index_copy_(0, idx, part[:len(plan.srcs)])
    node_row = np.full(N, -1, np.int32)
    node_row[plan.srcs] = plan.srcs
    ints, f32s = (torch.from_numpy(a).to(dev) for a in pack_blobs(
        plan.edge, plan.offset, plan.nk, plan.bounds, plan.caps, node_row,
        params.backward_tolerance_m, params.turn_penalty_factor))
    Bc, T, Kc = plan.edge.shape
    edges = kernel.edge_columns()
    bufs = {side: (torch.empty((Bc, T - 1, Kc, Kc), device=dev),
                   torch.zeros(1, dtype=torch.int32, device=dev))
            for side in ("other", "this")}
    mods = {"other": other, "this": route_relax}
    ms = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        route, max_bits = bufs[side]
        ms[side].append(graph_ms(lambda: mods[side].launch_pair_costs(
            ints, f32s, *full, edges, Bc, T, Kc, N, route, max_bits), 100))
    check(bit_equal(bufs["this"][0], bufs["other"][0]) == 0
          and torch.equal(bufs["this"][1], bufs["other"][1]),
          f"pair_costs differs from {path}'s")
    log(f"[against] pair_costs ({Bc},{T},{Kc}), graph: {path} "
        f"{ms['other'][0]:.4f} / {ms['other'][1]:.4f} ms, this "
        f"{ms['this'][0]:.4f} / {ms['this'][1]:.4f} ms; {path} takes "
        f"{np.mean(ms['other']) / np.mean(ms['this']):.2f}x as long; "
        f"outputs equal")
    out["pair_costs"] = ms
    return out


def phase_against_routes(path):
    """Device-route prep of this checkout against the one at ``path``:
    main's 608 requests through ``match_many`` with ``route_device=True``
    and the lanes on, one matcher from each checkout (each from its own
    package: city, params, matcher, writer), one cold run each, then
    ``ROUTE_WARM_ROUNDS`` warm rounds in turns (other, this, this, other,
    ...). Every body is byte-equal to this checkout's native CPU run with
    host routes. Returns {"other"|"this": {"prep": [...], "wall": [...]}}
    of the warm runs, in seconds."""
    from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
    from reporter_tpu_torch.synth import build_grid_city
    t0 = time.perf_counter()
    city = build_grid_city(**CITY)
    params = MatchParams(max_candidates=K)
    main, mixed = main_requests(
        SegmentMatcher(city, params, device="cpu", native=False))
    reqs = main + mixed
    want = bodies(SegmentMatcher(city, params, device="cpu").match_many(reqs),
                  reqs)
    om = load_other(path, "matcher")
    sides = {
        "other": (om.SegmentMatcher(
            load_other(path, "synth").build_grid_city(**CITY),
            om.MatchParams(max_candidates=K), route_device=True),
            load_other(path, "service.report").report_json),
        "this": (SegmentMatcher(city, params, route_device=True), None)}
    log(f"[against-routes] {len(reqs)} requests, both matchers built in "
        f"{time.perf_counter() - t0:.2f} s")
    order = ["other", "this"]
    for r in range(ROUTE_WARM_ROUNDS):
        order += ["other", "this"] if r % 2 else ["this", "other"]
    out = {name: {"prep": [], "wall": []} for name in sides}
    for i, name in enumerate(order):
        m, writer = sides[name]
        for k in m.stage_seconds:
            m.stage_seconds[k] = 0.0
        t1 = time.perf_counter()
        got = bodies(m.match_many(reqs), reqs, writer)
        wall = time.perf_counter() - t1
        run = "cold" if i < 2 else "warm"
        check(got == want, f"{name}, {run}: /report bodies differ from the "
                           f"native CPU run with host routes")
        if run == "warm":
            out[name]["prep"].append(m.stage_seconds["prep"])
            out[name]["wall"].append(wall)
        log(f"[against-routes] {name} ({path if name == 'other' else '.'}), "
            f"{run}: wall {wall:.6f} s, stage seconds "
            f"{ {k: round(v, 6) for k, v in m.stage_seconds.items()} }")
    for what in ("prep", "wall"):
        o, t = out["other"][what], out["this"][what]
        wins = sum(a > b for a, b in zip(o, t))
        log(f"[against-routes] warm {what}, {len(t)} pairs: {path} median "
            f"{float(np.median(o)):.6f} s (range {min(o):.6f}-{max(o):.6f}),"
            f" this median {float(np.median(t)):.6f} s (range "
            f"{min(t):.6f}-{max(t):.6f}); this shorter in {wins} of "
            f"{len(t)} pairs")
    return out


# -- the incremental streaming decode ------------------------------------------
def step_inputs(N, Kc, seed):
    """Incremental-step rows with exact ties (a few distances, routes and
    scores repeat), NORMAL, RESTART and SKIP rows, routes at 1e9 and
    +inf, invalid candidates, on-edge points (em == -0.0) and carried
    scores holding -0.0."""
    from reporter_tpu_torch.matcher.hmm import NORMAL, RESTART, SKIP
    rng = np.random.default_rng(seed)
    dist = rng.choice(np.array([0.0, 0.0, 1.0, 2.5, 5.5, 10.0, 40.0],
                               np.float32), (N, Kc))
    valid = rng.random((N, Kc)) > 0.2
    gc = rng.choice(np.array([0.0, 5.0, 10.0, 20.0], np.float32), N)
    route = (gc[:, None, None] + rng.choice(
        np.array([0.0, 0.0, 3.0, 6.0], np.float32), (N, Kc, Kc))
             ).astype(np.float32)
    route[rng.random(route.shape) < 0.1] = 1.0e9
    route[rng.random(route.shape) < 0.1] = np.inf
    case = rng.choice(np.array([NORMAL, RESTART, SKIP], np.int32), N)
    prev = rng.choice(np.array([-0.0, 0.0, -1.0, -2.0, -1.0e30],
                               np.float32), (N, Kc))
    return dist, valid, route, gc.astype(np.float32), case, prev


def step_equal(a, b):
    """Whether two (new_scores, bp, prev_best) triples are equal, scores
    bit for bit, and the scores' largest absolute difference."""
    import torch
    a = [t.cpu() for t in a]
    b = [t.cpu() for t in b]
    same = (bit_equal(a[0], b[0]) == 0 and torch.equal(a[1], b[1])
            and torch.equal(a[2], b[2]))
    return same, float((a[0] - b[0]).abs().max())


def phase_verify_step(dev):
    """``incremental_step`` against its plain version on the card and on
    the CPU, same inputs (``step_inputs``) at every N of ``STEP_N`` and K
    of ``STEP_K``: new_scores bit-equal, bp and prev_best equal; and the
    kernel's first 37 rows of a 512-row launch equal to a launch of those
    37 rows alone. Returns the scores' largest absolute difference."""
    import itertools
    import torch
    from reporter_tpu_torch.ops import (incremental_step_cuda,
                                        incremental_step_plain)
    sigma, beta = np.float32(4.07), np.float32(3.0)
    worst, zeros = 0.0, set()
    for seed, (N, Kc) in enumerate(itertools.product(STEP_N, STEP_K)):
        arrays = step_inputs(N, Kc, 500 + seed)
        x = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        got = incremental_step_cuda(*x, sigma, beta)
        torch.cuda.synchronize()
        for where, want in (
                ("card", incremental_step_plain(*x, sigma, beta)),
                ("CPU", incremental_step_plain(
                    *(torch.from_numpy(a) for a in arrays), sigma, beta))):
            same, err = step_equal(got, want)
            check(same, f"incremental_step differs from the plain version "
                        f"on the {where} at N,K={N},{Kc}")
            worst = max(worst, err)
        sc = got[0].cpu()
        zeros |= set(torch.signbit(sc[sc == 0]).tolist())
        if N == 512 and Kc == K:
            head = incremental_step_cuda(*(t[:37].contiguous() for t in x),
                                         sigma, beta)
            same, _err = step_equal(head, [t[:37] for t in got])
            check(same, "37 rows alone differ from the same rows of 512")
        del x, got
    check(zeros == {False, True}, "the checked scores held no zeros of both "
                                  "signs")
    torch.cuda.empty_cache()
    log(f"[verify-step] incremental_step bit-equal to the plain version on "
        f"the card and on the CPU at N {STEP_N} x K {STEP_K} (ties, NORMAL/"
        f"RESTART/SKIP rows, routes at 1e9 and +inf, invalid candidates, "
        f"+0.0 and -0.0 in the scores); 37 rows alone equal the same rows "
        f"of 512; largest |difference| {worst}")
    return worst


def match_json(match) -> str:
    """Canonical JSON of a match: a dict, or a MatchRuns by its C
    writer."""
    from reporter_tpu_torch.matcher.matcher import (MatchRuns,
                                                    render_segments_json)
    if isinstance(match, MatchRuns):
        match = json.loads(render_segments_json(match.cols, match.lo,
                                                match.hi, match.mode))
    return json.dumps(match, sort_keys=True)


def counters(*names):
    from reporter_tpu_torch.utils import metrics
    got = metrics.snapshot()["counters"]
    return [got.get(n, 0) for n in names]


def timer_total(name) -> float:
    from reporter_tpu_torch.utils import metrics
    return metrics.snapshot()["timers"].get(name, {}).get("total_s", 0.0)


def stream_parity(dev, served):
    """match_incremental on the card for main's 512 uuids (every fourth in
    the second parameter group, ``OPTS_B``), 4 raw points appended a call
    until each trace ends: the served and declined slots equal a CPU
    run's, every served match and /report body byte-equal to the card's
    match_many of the same window and to the CPU run's match, the two
    tables' blobs and counters equal. ``incremental_step`` is counted
    from 0 over the run: one launch per round and parameter group, the
    CPU run's rounds. Returns (launches, rounds by group)."""
    from reporter_tpu_torch import ops
    from reporter_tpu_torch.matcher import SegmentMatcher
    city, params = served["city"], served["params"]
    reqs0 = [dict(r, match_options=OPTS_B if i % 4 == 3 else OPTS)
             for i, r in enumerate(served["reqs"][:N_TRACES])]
    gpu = SegmentMatcher(city, params, device=dev)
    cpu = SegmentMatcher(city, params, device="cpu")
    n_served = n_windows = 0
    walls = []
    ops.incremental_step_cuda.launches = 0
    for hi in range(4, T_MAIN + 1, 4):
        reqs = [dict(r, trace=r["trace"][:hi]) for r in reqs0]
        t0 = time.perf_counter()
        got = gpu.match_incremental(reqs)
        walls.append(time.perf_counter() - t0)
        want = cpu.match_incremental(reqs)
        batch = gpu.match_many(reqs)
        check([g is None for g in got] == [w is None for w in want],
              f"window {hi}: the card serves other slots than the CPU")
        live = [i for i, g in enumerate(got) if g is not None]
        n_windows += len(reqs)
        n_served += len(live)
        for i in live:
            check(match_json(got[i]) == match_json(want[i])
                  == match_json(batch[i]),
                  f"window {hi}, {reqs[i]['uuid']}: the match differs")
        sub = [reqs[i] for i in live]
        check(bodies([got[i] for i in live], sub)
              == bodies([batch[i] for i in live], sub),
              f"window {hi}: a /report body differs from match_many's")
    launches = ops.incremental_step_cuda.launches
    rounds = dict(gpu.incremental_table.rounds)
    check(rounds == cpu.incremental_table.rounds and len(rounds) == 2,
          f"rounds {rounds} on the card, {cpu.incremental_table.rounds} on "
          f"the CPU")
    check(launches == sum(rounds.values()),
          f"{launches} incremental_step launches for {rounds} rounds")
    check(gpu.incremental_table.gauge() == cpu.incremental_table.gauge(),
          "the card's table counters differ from the CPU run's")
    check(dict(gpu.incremental_table.to_blobs())
          == dict(cpu.incremental_table.to_blobs()),
          "the card's carried-state blobs differ from the CPU run's")
    check(n_served > n_windows // 2, f"only {n_served} of {n_windows} "
                                     f"windows served")
    log(f"[stream] parity: {N_TRACES} uuids, 4 raw points a call, "
        f"{len(walls)} calls: {n_served} of {n_windows} windows served, "
        f"each match and /report body byte-equal to the card's match_many "
        f"and to the CPU run; blobs and counters equal the CPU run's "
        f"({gpu.incremental_table.gauge()}); incremental_step launches "
        f"{launches} = rounds by (sigma, beta, K) {rounds}; wall a call "
        f"median {float(np.median(walls)):.4f} s (range "
        f"{min(walls):.4f}-{max(walls):.4f})")
    return launches, rounds


def stream_fallback(dev, served):
    """A matcher with ``incremental_lag=2`` behind a ReporterService:
    report_incremental over 128 of main's requests (every eighth without
    a uuid) at windows of 2, 16, 32, 48 and 64 raw points equals
    report_many slot for slot. Two points need no commit, so the first
    call serves the uuids; past them the lag forces fallbacks. The
    declined slots go through the dispatcher's match_many, whose
    ``viterbi_decode`` launches (counted from 0 around each
    report_incremental) are returned."""
    from reporter_tpu_torch import ops
    from reporter_tpu_torch.matcher import SegmentMatcher
    from reporter_tpu_torch.service.server import ReporterService
    svc = ReporterService(SegmentMatcher(served["city"], served["params"],
                                         device=dev, incremental_lag=2))
    reqs0 = [dict(r, uuid=None) if i % 8 == 7 else r
             for i, r in enumerate(served["reqs"][:128])]
    launches = n_served = 0
    try:
        for hi in (2, 16, 32, 48, 64):
            reqs = [dict(r, trace=r["trace"][:hi]) for r in reqs0]
            n_served += sum(m is not None
                            for m in svc.matcher.match_incremental(reqs))
            ops.viterbi_cuda.launches = 0
            got = svc.report_incremental(reqs)
            launches += ops.viterbi_cuda.launches
            check(got == svc.report_many(reqs) and None not in got,
                  f"window {hi}: report_incremental differs from "
                  f"report_many")
        gauge = svc.matcher.incremental_table.gauge()
    finally:
        check(svc.dispatcher.close(), "the dispatcher did not stop")
    check(gauge["fallbacks"] > 0 and n_served > 0 and launches > 0,
          f"lag 2: {n_served} served, {gauge['fallbacks']} fallbacks, "
          f"{launches} decode launches")
    log(f"[stream] fallback: lag 2, 128 requests, 5 calls: "
        f"report_incremental equal to report_many in every slot; "
        f"{n_served} windows served, {gauge['fallbacks']} fallbacks; "
        f"viterbi_decode launches for the declined slots {launches}")
    return launches


def long_streams(reqs, n, length):
    """``n`` point streams of ``length`` points. Stream i starts with
    request i's trace and goes on, each time it ends, with a trace whose
    first point lies within ``SEAM_M`` of its last (the k-th such trace
    at the k-th seam), after a gap of the jump at 10 m/s, at least 5 s:
    a long session across coverage gaps. A jump of at most 800 m bounds
    the route search at 4,000 m, so every window stays on the f16 wire,
    as one batch of them does: ``match_many`` then decodes each window
    as it would alone."""
    from reporter_tpu_torch.core.geo import equirectangular_m
    starts = np.array([[r["trace"][0]["lat"], r["trace"][0]["lon"]]
                       for r in reqs])
    out = []
    for i in range(n):
        pts = list(reqs[i]["trace"])
        k = 0
        while len(pts) < length:
            end = pts[-1]
            jump = equirectangular_m(end["lat"], end["lon"], starts[:, 0],
                                     starts[:, 1])
            near = np.flatnonzero(jump <= SEAM_M)
            check(len(near) > 0, f"stream {i}: no trace starts within "
                                 f"{SEAM_M} m of {end}")
            j = int(near[k % len(near)])
            seg = reqs[j]["trace"]
            t_off = pts[-1]["time"] + max(5.0, float(jump[j]) / 10.0)
            base = seg[0]["time"]
            pts.extend(dict(p, time=p["time"] - base + t_off) for p in seg)
            k += 1
        out.append(pts[:length])
    return out


def pctl_ms(xs):
    return (round(float(np.percentile(xs, 50)) * 1e3, 4),
            round(float(np.percentile(xs, 99)) * 1e3, 4))


def stream_leg(dev, served, T, n):
    """One streaming leg: ``n`` uuids, each window warmed to ``T`` raw
    points in one call, then ``STREAM_MEASURE`` reports of one more point
    each through match_incremental and match_many of the same windows
    (the collector off): per call, the incremental decode seconds (the
    ``match.incremental.decode`` span: prep of the appended points, the
    device rounds, the commits) and wall, match_many's decode stage
    seconds and wall. Every served match is byte-equal to match_many's
    or, where the native path's run times round otherwise
    (``native_rounding``: ``RunColumns`` rounds with ``np.round``, the
    Python assembly with ``round``), to the numpy prep's match_many of
    the window."""
    import gc
    from reporter_tpu_torch import ops
    from reporter_tpu_torch.matcher import SegmentMatcher
    streams = long_streams(served["reqs"][:N_TRACES], n, T + STREAM_MEASURE)
    m = SegmentMatcher(served["city"], served["params"], device=dev,
                       incremental_lag=STREAM_LAG)

    def reqs_at(hi):
        return [{"uuid": f"s{i}", "trace": pts[:hi], "match_options": OPTS}
                for i, pts in enumerate(streams)]

    m.match_incremental(reqs_at(T))
    m.match_many(reqs_at(T + STREAM_MEASURE))  # the batch path's buckets
    steps0, commits0 = counters("match.incremental.steps",
                                "match.incremental.commits")
    inc_dec, inc_wall, mm_dec, mm_wall = [], [], [], []
    launches0 = ops.incremental_step_cuda.launches
    n_served = rounding = 0
    numpy_m = SegmentMatcher(served["city"], served["params"], device=dev,
                             native=False)
    gc.collect()
    gc.disable()
    try:
        for r in range(1, STREAM_MEASURE + 1):
            reqs = reqs_at(T + r)
            d0 = timer_total("match.incremental.decode")
            t0 = time.perf_counter()
            got = m.match_incremental(reqs)
            inc_wall.append(time.perf_counter() - t0)
            inc_dec.append(timer_total("match.incremental.decode") - d0)
            s0 = m.stage_seconds["decode"]
            t0 = time.perf_counter()
            batch = m.match_many(reqs)
            mm_wall.append(time.perf_counter() - t0)
            mm_dec.append(m.stage_seconds["decode"] - s0)
            for req, g, b in zip(reqs, got, batch):
                if g is None:
                    continue
                n_served += 1
                if match_json(g) != match_json(b):
                    rounding += 1
                    check(match_json(g) == match_json(
                        numpy_m.match_many([req])[0]),
                          f"T={T}, {n} uuids, report {r}, {req['uuid']}: "
                          f"a served match differs from match_many's on "
                          f"both preps")
    finally:
        gc.enable()
    steps, commits = (a - b for a, b in zip(
        counters("match.incremental.steps", "match.incremental.commits"),
        (steps0, commits0)))
    out = {"window": T, "uuids": n,
           "dec_ms": pctl_ms(inc_dec), "wall_ms": pctl_ms(inc_wall),
           "batch_dec_ms": pctl_ms(mm_dec), "batch_wall_ms": pctl_ms(mm_wall),
           "steps_per_point": round(steps / (n * STREAM_MEASURE), 4),
           "commits": commits, "served": n_served,
           "windows": n * STREAM_MEASURE, "native_rounding": rounding,
           "launches": ops.incremental_step_cuda.launches - launches0}
    check(n_served > 0, f"T={T}, {n} uuids: nothing served")
    log(f"[stream] leg {json.dumps(out)} (ms as [p50, p99] a call)")
    return out


def phase_stream(dev, served):
    """The incremental streaming decode on the card: the parity leg, the
    fallback leg and the streaming legs (``STREAM_WINDOWS`` x 1 and 512
    uuids). Returns (incremental_step launches of the parity leg, rounds,
    viterbi_decode launches of the fallback leg, the legs)."""
    t0 = time.perf_counter()
    launches, rounds = stream_parity(dev, served)
    fallback_launches = stream_fallback(dev, served)
    legs = [stream_leg(dev, served, T, n)
            for T in STREAM_WINDOWS for n in (1, N_TRACES)]
    log(f"[stream] {time.perf_counter() - t0:.1f} s")
    return launches, rounds, fallback_launches, legs


def step_bound_ms(N, Kc):
    """The least time of one step of N rows: each input read once (dist,
    valid, route, gc, case, prev) and each output written once (scores,
    bp, prev_best) at the card's memory rate, against about 6 f32 ops
    per (row, i, j) and 4 per (row, j) at its f32 rate."""
    n_bytes = N * (Kc * 4 + Kc + Kc * Kc * 4 + 4 + 4 + Kc * 4) \
        + N * (Kc * 8 + 4)
    n_ops = N * Kc * Kc * 6 + N * Kc * 4
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", n_bytes)


def phase_timing_step(dev):
    """incremental_step by CUDA graphs (100 launches a graph) at N=1 and
    512 rows, K=8, beside its bound and the plain version's time on the
    card. Returns {N: (ms, plain ms, bound ms, bound by)}."""
    import torch
    from reporter_tpu_torch.ops import incremental
    sigma, beta = np.float32(4.07), np.float32(3.0)
    out = {}
    for N in (1, N_TRACES):
        x = tuple(torch.from_numpy(a).to(dev)
                  for a in step_inputs(N, K, 900 + N))
        buf = torch.empty(incremental.output_words(N, K), dtype=torch.int32,
                          device=dev)
        ms = graph_ms(lambda: incremental.launch(x, sigma, beta, buf), 100)
        plain = time_ms(
            lambda: incremental.incremental_step_plain(*x, sigma, beta), 20)
        bms, by, n_bytes = step_bound_ms(N, K)
        out[N] = (ms, plain, bms, by)
        log(f"[timing] incremental_step N,K={N},{K}: {ms:.5f} ms (CUDA "
            f"graphs), plain {plain:.4f} ms, bound {bms:.6f} ms by {by} "
            f"({n_bytes} bytes)")
    log("[timing] library: no single PyTorch call computes a Viterbi step")
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
                    help="time this kernel, and device-route prep, "
                         "against the checkout at DIR; nothing else runs")
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
        kernels = phase_against_route_kernels(dev, args.against)
        routes = phase_against_routes(args.against)
        check(not spills, f"ptxas reports spills: {spills}")
        return finish(smi, {"against": args.against, "ms": against,
                            "route_kernels_ms": kernels,
                            "routes_s": routes})
    phase_verify(dev)
    step_err = phase_verify_step(dev)
    launches, main, max_err, scalars, served = phase_main(dev)
    big = grid_inputs(BIG_CITY, N_TRACES, 11)
    huge = grid_inputs(HUGE_CITY, 64, 17)
    verified = phase_verify_routes(dev, served, big, huge)
    route_launches, _runs = phase_routes(dev, served)
    step_launches, _rounds, fallback_launches, _legs = phase_stream(
        dev, served)
    serving = phase_serve(dev, served)
    phase_prefork(served)
    phase_city(big)
    sweep_launches, _big_runs = phase_route_city(big, huge)
    times = phase_timing(dev, main, scalars, max_sm_mhz())
    route_times = phase_timing_routes(dev, served, big, huge)
    step_times = phase_timing_step(dev)
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
        # the stream phase's fallback leg: report_incremental's declined
        # slots through the dispatcher's match_many (phase_stream)
        "launches_stream_fallback": fallback_launches,
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
    source = "reporter_tpu_torch/ops/csrc/route_relax.cu"
    for name, replaces, err, n in (
            # match_many with route_device=True, lanes on, cold and warm
            # (phase_routes): one launch a relaxation
            ("relax", "reporter_tpu/ops/route_relax.py:61",
             verified["relax_err"], route_launches["relax"]),
            # the 125x125 city with route_device=True (phase_route_city):
            # one launch a sweep; "ms" is a sweep's
            ("relax_sweep", "reporter_tpu/ops/route_relax.py:61",
             verified["sweep_err"], sweep_launches),
            ("pair_costs", "reporter_tpu/ops/route_relax.py:120",
             verified["pair_err"], route_launches["pair_costs"])):
        r_ms, r_plain, r_bound, r_by = route_times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": r_ms, "plain_ms": r_plain, "bound_ms": r_bound,
            "bound_by": r_by, "library_ms": None})
    ms, plain, bms, by = step_times[N_TRACES]
    kernels.append({
        "name": "incremental_step", "route": "cuda",
        "source": "reporter_tpu_torch/ops/csrc/viterbi.cu",
        "replaces": "reporter_tpu/ops/incremental.py:50",
        # match_incremental's parity leg (phase_stream): one a round
        "launches": step_launches, "max_abs_err": step_err,
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": None,
        # one row, the one-uuid stream's step
        "ms_1_8": step_times[1][0], "bound_ms_1_8": step_times[1][2]})
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
