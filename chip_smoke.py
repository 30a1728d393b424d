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
            prev_best equal; and R rounds in one launch (ragged step
            counts) at (N, K, R) of (512, 8, 4), (1, 8, 4), (37, 32, 3)
            and (37, 128, 3)
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
   obs      the observability layer through ReporterService and the
            threaded server, from a config file with shadow_sample 1.0:
            main's 608 requests from 64 client threads, every eighth with
            ?trace=1: bodies (a traced answer's report member) byte-equal
            to the native CPU run, each span tree well formed and holding
            every stage (the median split printed), every chunk
            re-decoded by the plain scan on the CPU with no mismatch while
            the kernel launched once a chunk, then the split again with
            the shadow off; /profile's chunk events the
            dispatched chunks, no build after the build phase; /metrics
            scrape-clean; /health 200, and 503 naming the breach from a
            second service with slo_ms "service.handle=0.001"; the
            incremental shadow over a 64-uuid stream; a flight-recorder
            dump with the last wide events. Then torch.profiler
            (metrics.device_trace, Chrome traces under
            reporter_tpu_torch/_build/obs/) over one warm match_many of
            512 traces, lanes on and inline, and over one serving window:
            the device's busy and idle shares and kernel time by name;
            then requests/s of the window in turns disarmed, traced and
            shadowed (every chunk re-decoded, trace off)
   faults   the failure domains and overload control on the card, each
            leg a front door from a config file on the 20x20 city with
            main's 608 requests: native.prep, matcher.assemble (one
            poisoned trace, quarantined into the spool) and wire.native
            each armed with a bounded storm that opens its breaker at
            threshold 2 (/health 503 naming the domain; the writer's
            breaker is not a /health domain), a window while open with
            every body byte-equal, then a probe after the cooldown that
            closes it; decode.dispatch, route.device and native.prep on
            a route_device door (threshold 1): 500, then 503 with
            Retry-After and no kernel launch, then the probe's launches
            (relax and pair_costs with device routes), bytes and closed
            breaker, and no chunk through the numpy prep;
            match.incremental.commit on the stream parity input: every
            slot declined and report_incremental equal to report_many;
            admission with an in-flight bound of 8: windows from 256
            client threads until the ladder reaches shed_trace (every
            answer 200 or 429, every 429 with Retry-After in [1, 30],
            every 200 byte-equal; requests/s, shed share and served p99
            printed), the ladder back at normal within two holds a rung,
            then rung 4 forced: the decode stays on the card (launches
            equal the chunks). Launches equal the chunks
            dispatched in every leg; the plain scan runs 0 times
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
            limit: relax_cluster, one launch and one read a relaxation)
            the same way; 8 traces on a 341x341 grid city (116,281 nodes,
            past a cluster's reach: relax_sweep), cold
   worker   the streaming worker (reporter_tpu_torch.streaming.worker.main)
            in this process on the 100x100 city: 2,048 vehicles' probe
            lines (written by a low-priority child process started with
            the run) to tile files, with the carried-state decode
            (report_incremental: incremental_step launched) and with
            "incremental": false (report_many: viterbi_decode), tiles
            byte-equal; then the first 512 vehicles fault-free, with
            match.incremental.commit=error#1 (it fires), killed by
            worker.offer=crash+k#1 in a child process (exit 137, decode
            frames in its snapshot) and resumed by a new worker, and with
            --device cpu, each byte-equal to the fault-free card run.
            No leg parses badly, sheds or dead-letters; a card leg calls
            no plain version, the CPU leg launches no kernel. One JSON
            line a leg (messages, reports, flushes, tiles, segments kept
            and culled, launches, the match.incremental counters and
            gauge, wall, messages/s, reports/s, the batcher.flush p50 and
            p99), then the phase's seconds beside the card's name and
            power limit
8. timing   the launch floor (an empty kernel with the kernels' C launch
            interface, built beside them, by CUDA graphs and back to back);
            CUDA-event times of the decode kernel from CUDA graphs (the
            main path's batch, and batches and one trace at T=64/256/1024,
            twice in turns; the per-step slope and intercept; the main
            batch with the L2 flushed) and of the plain version, beside
            the least time the card could take and a model of the chain;
            then of the route kernels, by CUDA graphs: one whole
            relaxation by relax (one launch) and by relax_sweep's sweeps
            at the main path's first chunk and at the 100x100 city's, and
            by relax_cluster (one launch) and relax_sweep's sweeps at the
            125x125 city's first chunk, one pair_costs launch at the main
            path's first chunk, and their plain versions, beside their
            bounds

After main come two phases of the device route costs (``route_device``):

   verify-routes  relax against the plain relax_csr on the card at three
            shapes (the 20x20 city's first main chunk, S=512, at its
            chunk bound; the 40x40 city with 1,024 sources at 1,500 m;
            the 100x100 city's first chunk, S=2,048, at its chunk bound),
            each to convergence and capped at one sweep and at one sweep
            short; relax_cluster the same way on the 125x125 city (2
            blocks a cluster) with its first chunk's 1,024 sources at the
            chunk bound and with 64 sources at 1,500 m, and on a 200x200
            city (3 blocks) with 64 sources; relax_sweep by a direct call
            on the 125x125 city with the 64 sources: dist and time
            bit-equal, iters and converged equal. pair_costs against its plain version at
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
            incremental_step launched once per call and parameter group
            (every round of the call in one launch).
            Fallback: a matcher with incremental_lag=2 behind a
            ReporterService; report_incremental equal to report_many slot
            for slot, viterbi_decode launches counted for the declined
            slots. Streaming legs (BENCH_STREAM_r01.json's shape): windows
            warmed to 64 and 256 raw points, lag 32, then 16 reports of
            one more point each, with 1 uuid and with 512 uuids a call:
            the incremental decode seconds and wall a call against
            match_many's of the same windows, steps per point, commits;
            served matches byte-equal to match_many's. The timing phase
            then times incremental_step by CUDA graphs at (1,8), (512,8)
            and (512,8) for 4 rounds beside its bound and the plain
            version

Prints the card's name and power limit, one JSON line describing the
kernels (viterbi_decode: ``launches`` match_many's in the main phase,
``launches_serve`` each timed serve window's, lanes on,
``launches_obs`` the obs phase's parity window's,
``launches_stream_fallback`` the stream phase's declined slots,
``launches_faults`` the faults phase's legs; relax and
pair_costs: the routes phase's device lanes-on runs, cold and the first
warm round; relax_cluster: route-city's 125x125 device runs, cold and
the first warm round; relax_sweep: route-city's 341x341 run, one launch
a sweep; incremental_step: the stream phase's parity leg, one launch a
call and parameter group;
each kernel also its ``launches_faults``, its ``launches_worker`` (the
worker phase's legs, each counted from 0) and the ``launch_floor_ms``),
and as the last line {"ok": true, "device": {...}}. Exits non-zero,
printing no result, without a CUDA card or without the package beside it.

With ``--against DIR`` (another checkout of the repo, such as a parent
commit unpacked with ``git archive``) only the build runs, then both
decode kernels decode the same inputs at (512,64,8) and (64,1024,8):
their outputs must be equal, and each is timed by CUDA graphs and by
launches from Python, in the order other, this, this, other. Then the
incremental steps at (1,8), (512,8) and 4 rounds of (512,8), outputs
equal, each timed by CUDA graphs the same way (a checkout without the
multi-round kernel launches once a round). Then the route kernels: the
relaxation of the main path's first chunk and of the 100x100 city's
first chunk, this checkout's relax against the other's
sweeps (by CUDA graphs, and as the matcher calls each, host reads
included), and pair_costs at the main chunk, in the same order, outputs
bit-equal. Then main's 608 requests go through match_many with
route_device=True and the lanes on, one matcher from each checkout, cold
once and ten warm rounds in turns: bodies byte-equal to host routes, the
prep stage's seconds and the wall of each run, and each side's warm
median and range. Last, one front door from each checkout, observability
at its defaults: match_many of main's 512 traces and a serving window of
the 608 requests, ten rounds in turns, bodies byte-equal to the native
CPU run: what the always-on instrumentation costs.
"""
import json
import os
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
# past relax's shared-memory limit (14,528 nodes): relax_cluster's graph,
# 2 blocks a cluster
HUGE_CITY = dict(rows=125, cols=125, spacing_m=200.0, seed=42)
# relax_cluster at 3 blocks a cluster (verify-routes)
WIDE_CITY = dict(rows=200, cols=200, spacing_m=200.0, seed=42)
# past relax_cluster's 116,216 nodes: relax_sweep on the main path
PAST_CITY = dict(rows=341, cols=341, spacing_m=200.0, seed=42)
#: grid cities that relax_cluster runs at clusters of 4 blocks (48,400
#: nodes) and of 8 (108,900 nodes), checked directly in verify-routes
CLUSTER_CITIES = {4: dict(rows=220, cols=220, spacing_m=200.0, seed=42),
                  8: dict(rows=330, cols=330, spacing_m=200.0, seed=42)}
#: the widths relax_cluster is also held at on the 125x125 city, forced
FORCED_WIDTHS = (2, 3, 4, 5, 6, 7, 8)
#: seeds of the random sources every width check repeats over
WIDTH_SEEDS = (8, 9, 10)
PAST_TRACES = 8
OPTS = {"mode": "auto", "report_levels": [0, 1, 2],
        "transition_levels": [0, 1, 2]}
# the stream phase: every fourth uuid of the parity leg in a second
# parameter group; the streaming legs' windows (raw points), measured
# reports and lag (BENCH_STREAM_r01.json's shape)
OPTS_B = dict(OPTS, sigma_z=5.0)
STREAM_WINDOWS = (64, 256)
#: reports measured a streaming leg (32 before the worker phase came; cut
#: to keep the whole run near half its time limit)
STREAM_MEASURE = 16
STREAM_LAG = 32
# the longest jump between two traces stitched into one stream
SEAM_M = 800.0
# the faults phase: every breaker's cooldown, and the admission leg's
# client threads, in-flight bound, ladder hold and most windows
FAULT_COOLDOWN_S = 3.0
ADMIT_CLIENTS = 256
ADMIT_INFLIGHT = 8
ADMIT_HOLD_S = 0.25
ADMIT_WINDOWS = 6
# an empty kernel with the kernels' C launch interface: the launch floor
# every kernel time is set against (built beside the kernels, timed the
# same way); measurement only, on no path
LAUNCH_FLOOR_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
# the step's checked shapes: N rows by K candidates
STEP_N = (1, 37, 512, 4096)
STEP_K = (4, 8, 16, 128)
# (N, K, R): the rounds of one launch checked in verify-step
STEP_ROUNDS = ((512, 8, 4), (1, 8, 4), (37, 32, 3), (37, 128, 3))


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

    from reporter_tpu_torch.ops import nvcc
    floor_src = nvcc.BUILD_DIR / "launch_floor.cu"
    floor_src.parent.mkdir(parents=True, exist_ok=True)
    floor_src.write_text(LAUNCH_FLOOR_CU)
    with ThreadPoolExecutor(4) as pool:
        jobs = [(mod.SOURCE, pool.submit(timed, mod.build))
                for mod in (viterbi, route_relax)]
        host = pool.submit(timed, native.load)
        floor = pool.submit(timed, lambda: nvcc.load(floor_src,
                                                     "launch_floor"))
        built = [(src, job.result()) for src, job in jobs]
        _lib, host_secs = host.result()
        _floor, floor_secs = floor.result()
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
        f"nvcc builds); the empty launch-floor kernel in {floor_secs:.2f} s")
    return spills


def launch_floor_ms(dev):
    """Device time of one launch of an empty kernel through a C launcher,
    as the kernels are launched: by CUDA graphs (``graph_ms``, 100 a
    graph) and back to back from Python (``time_ms``)."""
    import ctypes
    import torch
    from reporter_tpu_torch.ops import nvcc
    lib, _log = nvcc.load(nvcc.BUILD_DIR / "launch_floor.cu", "launch_floor")
    fn = lib.launch_floor
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def launch():
        check(fn(torch.cuda.current_stream(dev).cuda_stream) == 0,
              "the empty kernel did not launch")
    graphed, eager = graph_ms(launch, 100), time_ms(launch, 200)
    log(f"[timing] launch floor: an empty kernel {graphed:.5f} ms a launch "
        f"by CUDA graphs, {eager:.5f} ms back to back from Python")
    return graphed


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


def cluster_at_width(kernel, src, bound, max_iters, width):
    """``relax_cluster`` launched directly at clusters of ``width`` blocks
    (uncounted: a check, not the main path), after the occupancy query
    for that plan: (dist, time, iters, converged)."""
    import torch
    from reporter_tpu_torch.ops import route_relax
    N = kernel.n_nodes
    route_relax.check_cluster(N, kernel.device, width)
    planes = torch.empty((2, len(src), N), device=kernel.device)
    info = torch.zeros(3, dtype=torch.int32, device=kernel.device)
    route_relax.launch_relax_cluster(kernel._arcs, src, bound, max_iters,
                                     planes[0], planes[1], info, width)
    iters, stuck, bad = info.tolist()
    check(bad == 0, f"relax_cluster at width {width}: {bad} bad sources")
    return planes[0], planes[1], iters, stuck == 0


def relax_against_plain(kernel, srcs, bound, max_iters, what, which=None,
                        width=None):
    """``srcs`` relaxed at ``bound`` on the card by ``which`` (default the
    kernel the graph takes, ``kernel.relax_kernel``: ``relax_cuda`` or
    ``relax_cluster_cuda`` over its CSR arcs, or ``relax_sweep_cuda``;
    with ``width``, ``relax_cluster`` at clusters of that many blocks)
    and by the plain version:
    dist and time bit-equal, iters and converged equal. Returns (kernel
    dist, kernel time, iters, converged, the largest absolute
    difference)."""
    import torch
    from reporter_tpu_torch.ops import route_relax
    which = which or kernel.relax_kernel
    cols = (kernel._e_start, kernel._e_end, kernel._e_len, kernel._e_secs)
    src = torch.from_numpy(np.asarray(srcs, np.int32)).to(kernel.device)
    if which == "relax":
        k_out = route_relax.relax_cuda(kernel._arcs, src, bound,
                                       n_nodes=kernel.n_nodes,
                                       max_iters=max_iters)
    elif which == "relax_cluster" and width:
        k_out = cluster_at_width(kernel, src, bound, max_iters, width)
    elif which == "relax_cluster":
        k_out = route_relax.relax_cluster_cuda(
            kernel._arcs, src, bound, n_nodes=kernel.n_nodes,
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
        check(differ == 0, f"{which} {name}: {differ} entries not "
                           f"bit-equal, {what}")
    check(k_out[2:] == p_out[2:], f"{which} iters/converged {k_out[2:]} "
                                  f"against the plain {p_out[2:]}, {what}")
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


def verify_relax(kernel, srcs, bound, label, which=None, width=None):
    """``relax_against_plain`` run to convergence, then with a cap of one
    sweep and a cap one short of the sweeps it needed: every run
    bit-equal, the capped ones not converged. Returns (dist, time,
    iters, the largest absolute difference)."""
    from reporter_tpu_torch.ops import route_relax
    which = which or kernel.relax_kernel
    dist, time_sn, iters, ok, err = relax_against_plain(
        kernel, srcs, bound, kernel.n_nodes, label, which, width)
    check(ok, f"{label}: the relaxation did not converge")
    caps = sorted({1, max(iters - 1, 1)})
    for cap in caps:
        got = relax_against_plain(kernel, srcs, bound, cap,
                                  f"{label}, max_iters={cap}", which, width)
        check(got[2:4] == (cap, False), f"{label}, max_iters={cap}: "
                                        f"gave {got[2:4]}")
    blocks = ""
    if which == "relax_cluster":
        blocks = (f", clusters of "
                  f"{width or route_relax.cluster_width(kernel.n_nodes)} "
                  f"blocks{' (forced)' if width else ''}")
    log(f"[verify-routes] {which}, {label} (N={kernel.n_nodes}, "
        f"E={kernel.n_edges}{blocks}), S={len(srcs)} at {float(bound):.1f} "
        f"m: {iters} sweeps, converged; and capped at {caps} sweeps, not "
        f"converged: dist and time bit-equal to the plain version, iters "
        f"and converged equal")
    return dist, time_sn, iters, err


def phase_verify_routes(dev, served, big, huge, past):
    """The route kernels against their plain versions on the card, same
    inputs. ``relax`` at three shapes: the 20x20 city with the first main
    chunk's sources (S = 512 after padding) at its chunk bound, the 40x40
    city with 1,024 seeded sources at 1,500 m, and the 100x100 city with
    the first chunk of ``big``'s requests (S = 2,048) at its chunk bound;
    each run to convergence and with caps of one sweep and of one sweep
    short: dist and time bit-equal, iters and converged equal.
    ``relax_cluster`` on ``huge``'s 125x125 grid (15,625 nodes, past
    ``relax``'s shared-memory limit: clusters of 2 blocks) with its first
    chunk's sources (S = 1,024) at its chunk bound and with 64 seeded
    sources at 1,500 m; then on the same grid at every width of
    ``FORCED_WIDTHS`` (launched directly), the first chunk and 256
    sources of each of ``WIDTH_SEEDS``; on a 200x200 grid (40,000
    nodes, 3 blocks) and ``CLUSTER_CITIES`` (4 and 8 blocks) with 64
    sources of each seed at 1,500 m; ``relax_sweep`` by a direct call on
    the 125x125 grid with the 64 sources, and on ``past``'s 341x341 grid
    (116,281 nodes, past a cluster's reach) with its first chunk's
    sources at its chunk bound, the shapes the main path gives it; the
    same way each.
    ``pair_costs`` at the first main chunk's (128, 64, 8), its first
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
    check(hk.relax_kernel == "relax_cluster"
          and route_relax.cluster_width(hk.n_nodes) == 2,
          f"the 125x125 city takes {hk.relax_kernel}")
    huge_plan, huge_srcs = first_chunk_sources(hk, huge)
    check(len(huge_srcs) == 1024, f"the 125x125 city's first chunk relaxes "
                                  f"{len(huge_srcs)} sources, not 1,024")
    some = np.random.default_rng(7).choice(hk.n_nodes, 64, replace=False)
    cluster_err = max(
        verify_relax(hk, huge_srcs, huge_plan.chunk_bound,
                     "125x125 city, first chunk")[3],
        verify_relax(hk, some, np.float32(1500.0), "125x125 city")[3])
    # every cluster width on the same graph, forced: the first chunk and
    # 256 sources of each seed at 1,500 m, so that a lost minimum at any
    # width, even an intermittent one, fails the run
    for width in FORCED_WIDTHS:
        cluster_err = max(cluster_err, verify_relax(
            hk, huge_srcs, huge_plan.chunk_bound,
            "125x125 city, first chunk", width=width)[3])
        for seed in WIDTH_SEEDS:
            cluster_err = max(cluster_err, verify_relax(
                hk, np.random.default_rng(seed).choice(hk.n_nodes, 256,
                                                       replace=False),
                np.float32(1500.0), f"125x125 city, seed {seed}",
                width=width)[3])
    # relax_sweep serves graphs past a cluster's reach; held here by a
    # direct call on the same graph too
    sweep_err = verify_relax(hk, some, np.float32(1500.0), "125x125 city",
                             which="relax_sweep")[3]
    del hk
    torch.cuda.empty_cache()
    for width, shape in ((3, WIDE_CITY), *CLUSTER_CITIES.items()):
        wide = DeviceRouteKernel(build_grid_city(**shape), dev)
        name = f"{shape['rows']}x{shape['cols']} city"
        check(wide.relax_kernel == "relax_cluster"
              and route_relax.cluster_width(wide.n_nodes) == width,
              f"the {name} takes {wide.relax_kernel} at "
              f"{route_relax.cluster_width(wide.n_nodes)} blocks a cluster")
        for seed in WIDTH_SEEDS:
            cluster_err = max(cluster_err, verify_relax(
                wide, np.random.default_rng(seed).choice(wide.n_nodes, 64,
                                                         replace=False),
                np.float32(1500.0), f"{name}, seed {seed}")[3])
        del wide
        torch.cuda.empty_cache()
    # relax_sweep at the shapes the main path gives it: the 341x341
    # city's first chunk at its chunk bound
    pk = DeviceRouteKernel(past["city"], dev)
    check(pk.relax_kernel == "relax_sweep",
          f"the {PAST_CITY['rows']}x{PAST_CITY['cols']} city takes "
          f"{pk.relax_kernel}")
    past_plan, past_srcs = first_chunk_sources(pk, past)
    sweep_err = max(sweep_err, verify_relax(
        pk, past_srcs, past_plan.chunk_bound,
        f"{PAST_CITY['rows']}x{PAST_CITY['cols']} city, first chunk")[3])
    del pk
    torch.cuda.empty_cache()

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
    return {"relax_err": relax_err, "cluster_err": cluster_err,
            "sweep_err": sweep_err, "pair_err": pair_max_err}


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
    ops.relax_cuda.reads = ops.relax_cluster_cuda.reads = 0
    t0 = time.perf_counter()
    out = bodies(matcher.match_many(reqs), reqs)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernel_wrappers().items()}
    launches["relax_reads"] = ops.relax_cuda.reads
    launches["relax_cluster_reads"] = ops.relax_cluster_cuda.reads
    return (out, wall, launches, metrics.snapshot()["counters"],
            {k: round(v, 4) for k, v in matcher.stage_seconds.items()})


def kernel_wrappers():
    """Each kernel's counted wrapper, by the name the ``kernels`` line
    gives it (``relax_sweep``'s counts sweeps)."""
    from reporter_tpu_torch import ops
    return {"viterbi_decode": ops.viterbi_cuda, "relax": ops.relax_cuda,
            "relax_cluster": ops.relax_cluster_cuda,
            "relax_sweep": ops.relax_sweep_cuda,
            "pair_costs": ops.pair_costs_cuda}


def check_route_launches(what, reqs, chunk, launches, counters, kernel):
    """The chunking's launch counts: the decode and ``pair_costs`` once per
    chunk (every chunk here has live transitions); with ``relax`` or
    ``relax_cluster`` (``kernel``) one launch and one host read (iters and
    converged) per relaxation, with ``relax_sweep`` one launch per sweep
    (the sum of the relaxations' iters), and never another."""
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
    want = {"relax": 0, "relax_reads": 0, "relax_cluster": 0,
            "relax_cluster_reads": 0, "relax_sweep": 0}
    if kernel == "relax_sweep":
        want["relax_sweep"] = sweeps
    else:
        want[kernel] = want[f"{kernel}_reads"] = relaxes
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


def phase_route_city(big, huge, past):
    """Device routes on larger cities, each against host routes. 512
    traces of the T=64 bucket with ``route_device=True`` on a 40x40 grid
    city (1,600 nodes, 6,240 edges, its node kernels cached), cold and
    warm; ``big``'s 512 on the 100x100 city (10,000 nodes, past the
    node-kernel cache: every chunk relaxes, S = 2,048), device routes and
    host routes each once cold on a new matcher, then
    ``ROUTE_WARM_ROUNDS`` warm rounds in turns; ``huge``'s 64 traces on
    the 125x125 city (15,625 nodes), whose relaxations ``relax_cluster``
    runs, the same way; and ``past``'s ``PAST_TRACES`` traces on a
    341x341 city (116,281 nodes, past a cluster's reach), whose
    relaxations ``relax_sweep`` runs, cold. Every body byte-equal to the
    native CPU run with host routes, launches held to the chunking. Returns the
    launches of ``relax_cluster`` (the 125x125 city's device runs, cold
    and the first warm round) and ``relax_sweep`` (the 341x341 run), and
    the 100x100 and 125x125 runs' numbers."""
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

    # relax_cluster on the main path: the 125x125 city, past relax's limit,
    # device routes against host routes, in turns
    city, params, reqs = huge["city"], huge["params"], huge["reqs"]
    want = bodies(SegmentMatcher(city, params, device="cpu").match_many(reqs),
                  reqs)
    sides = {"device": SegmentMatcher(city, params, route_device=True),
             "host": SegmentMatcher(city, params)}
    check(sides["device"].route_kernel.relax_kernel == "relax_cluster",
          f"the 125x125 city takes "
          f"{sides['device'].route_kernel.relax_kernel}")
    huge_runs = {name: {"cold": None, "wall": []} for name in sides}
    cluster_launches = 0
    for name, run in order:
        got, wall, n, ctr, stages = counted_run(sides[name], reqs)
        what = f"125x125 city, {name} routes, {run}"
        check(got == want, f"{what}: /report bodies differ from the native "
                           f"CPU run with host routes")
        if name == "device":
            check_route_launches(what, reqs, sides[name].chunk, n, ctr,
                                 "relax_cluster")
            if run in ("cold", "warm 1"):
                cluster_launches += n["relax_cluster"]
        if run == "cold":
            huge_runs[name]["cold"] = {"wall_s": wall, "stages": stages}
        else:
            huge_runs[name]["wall"].append(wall)
        log(f"[route-city] {what}: {len(reqs)} traces in {wall:.4f} s, "
            f"stage seconds {stages}; launches {n}; route.device "
            f"{route_counters(ctr)}")
    for name in sides:
        w = huge_runs[name]["wall"]
        log(f"[route-city] 125x125 city ({city.num_nodes} nodes / "
            f"{city.num_edges} edges), {name} routes, {len(w)} warm rounds: "
            f"wall median {float(np.median(w)):.6f} s (range "
            f"{min(w):.6f}-{max(w):.6f})")
    wins = sum(d < h for d, h in zip(huge_runs["device"]["wall"],
                                     huge_runs["host"]["wall"]))
    log(f"[route-city] 125x125 city: device routes (relax_cluster) shorter "
        f"in wall in {wins} of {ROUTE_WARM_ROUNDS} warm pairs; cold "
        f"{huge_runs['device']['cold']} against host "
        f"{huge_runs['host']['cold']}")
    del sides

    # relax_sweep on the main path: a graph past a cluster's reach
    city, params, reqs = past["city"], past["params"], past["reqs"]
    want = bodies(SegmentMatcher(city, params, device="cpu").match_many(reqs),
                  reqs)
    gpu = SegmentMatcher(city, params, route_device=True)
    check(gpu.route_kernel.relax_kernel == "relax_sweep",
          f"the {PAST_CITY['rows']}x{PAST_CITY['cols']} city takes "
          f"{gpu.route_kernel.relax_kernel}")
    got, wall, n, ctr, stages = counted_run(gpu, reqs)
    what = f"{PAST_CITY['rows']}x{PAST_CITY['cols']} city"
    check(got == want, f"{what}: /report bodies differ from the native CPU "
                       f"run with host routes")
    check_route_launches(what, reqs, gpu.chunk, n, ctr, "relax_sweep")
    log(f"[route-city] {what} ({city.num_nodes} nodes / {city.num_edges} "
        f"edges, past relax_cluster's reach), {len(reqs)} traces, cold: "
        f"{wall:.4f} s wall, stage seconds {stages}; launches {n}; "
        f"route.device {route_counters(ctr)}; bodies byte-equal to host "
        f"routes")
    return ({"relax_cluster": cluster_launches,
             "relax_sweep": n["relax_sweep"]},
            {"100x100": runs, "125x125": huge_runs})


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


def post_all(url, reqs, clients, trace_every=0, span=False, retry=False):
    """POST every request to ``url``/report from a pool of ``clients``
    threads in a child process (so the load does not share the
    service's GIL), every ``trace_every``-th (from the first) to
    ``/report?trace=1``: ([(status, X-Reporter-Proc, body)] in request
    order, per-request seconds, wall seconds), with ``span`` the epoch
    nanoseconds at which the child's first request started and its last
    ended, and with ``retry`` each answer's Retry-After header (None
    where it has none)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        with open(f"{tmp}/reqs.json", "w") as f:
            json.dump(reqs, f)
        subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.client_main(*sys.argv[1:])", url,
             f"{tmp}/reqs.json", f"{tmp}/out.json", str(clients),
             str(trace_every)],
            cwd=ROOT, check=True, timeout=600)
        with open(f"{tmp}/out.json") as f:
            out = json.load(f)
    got = ([(st, tag, body.encode()) for st, tag, body in out["answers"]],
           out["seconds"], out["wall"])
    if span:
        got += ((out["t0_ns"], out["t1_ns"]),)
    return got + (out["retry"],) if retry else got


def client_main(url, reqs_path, out_path, clients, trace_every="0"):
    """The load generator :func:`post_all` runs in its own process."""
    from concurrent.futures import ThreadPoolExecutor
    with open(reqs_path) as f:
        reqs = json.load(f)
    every = int(trace_every)
    # urllib's first use in 64 threads at once races its lazy set-up
    # (seconds on a loaded host): one GET from this thread first
    http(url + "/health")

    def one(i):
        path = "/report?trace=1" if every and i % every == 0 else "/report"
        t0 = time.perf_counter()
        st, h, body = http(url + path, json.dumps(reqs[i]).encode())
        return ((st, h["X-Reporter-Proc"], body.decode()),
                time.perf_counter() - t0, h["Retry-After"])

    t0_ns = time.time_ns()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(int(clients)) as pool:
        done = list(pool.map(one, range(len(reqs))))
    wall = time.perf_counter() - t0
    t1_ns = time.time_ns()
    with open(out_path, "w") as f:
        json.dump({"answers": [a for a, _t, _r in done],
                   "seconds": [t for _a, t, _r in done], "wall": wall,
                   "retry": [r for _a, _t, r in done],
                   "t0_ns": t0_ns, "t1_ns": t1_ns}, f)


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


OBS_STAGES = ("service.request", "service.parse", "service.handle",
              "dispatch.batch", "dispatch.match_many", "matcher.chunk",
              "matcher.prep", "prep.candidates", "prep.select",
              "prep.routes", "matcher.decode_dispatch",
              "matcher.decode_wait", "matcher.assemble", "report.serialise")
OBS_TRACE_EVERY = 8         # every eighth request of the parity window
#: the overhead turns: disarmed (trace and shadow off), traced (every
#: request's spans recorded, none exported), shadowed (every chunk
#: re-decoded by the plain scan on the CPU)
OBS_ORDER = ("disarmed", "traced", "shadowed", "shadowed", "traced",
             "disarmed")
OBS_STREAM_UUIDS = 64
_SAMPLE_RE = r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{le="[^"]+"\})? [0-9eE.+-]+$'
_META_RE = r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|histogram)$"


def span_split(events, what):
    """Check one ?trace=1 answer's span tree (one trace id, one root
    ``service.request``, every parent in the tree, each span inside its
    parent's interval, every stage of ``OBS_STAGES`` present) and return
    its milliseconds per span name (spans of a name summed)."""
    check(events and all(e["ph"] == "X" for e in events),
          f"{what}: an empty tree or an open span in it")
    check(len({e["args"]["trace_id"] for e in events}) == 1,
          f"{what}: more than one trace id")
    by_id = {e["args"]["span_id"]: e for e in events}
    check(len(by_id) == len(events), f"{what}: a span id twice")
    roots = [e["name"] for e in events if e["args"]["parent_id"] == 0]
    check(roots == ["service.request"], f"{what}: roots {roots}")
    for e in events:
        if e["args"]["parent_id"] == 0:
            continue
        p = by_id.get(e["args"]["parent_id"])
        check(p is not None, f"{what}: the parent of {e['name']} is not in "
                             f"the tree")
        # 0.01 us of slack for the ns -> us float division
        check(e["ts"] >= p["ts"] - 0.01
              and e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 0.01,
              f"{what}: {e['name']} [{e['ts']:.3f} +{e['dur']:.3f} us] lies "
              f"outside its parent {p['name']} [{p['ts']:.3f} "
              f"+{p['dur']:.3f} us]")
    missing = set(OBS_STAGES) - {e["name"] for e in events}
    check(not missing, f"{what}: no {sorted(missing)} span")
    split = {}
    for e in events:
        split[e["name"]] = split.get(e["name"], 0.0) + e["dur"] / 1e3
    return split


def scrape_clean(text, what):
    """Every line of a /metrics body a TYPE line or a sample, each
    histogram's buckets monotone and its +Inf bucket equal to its
    count."""
    import re
    check(text.endswith("\n"), f"{what}: no final newline")
    buckets, counts = {}, {}
    for line in text.splitlines():
        check(re.match(_META_RE, line) or re.match(_SAMPLE_RE, line),
              f"{what}: not scrape-clean: {line!r}")
        m = re.match(r'^(\S+)_bucket\{le="([^"]+)"\} (\d+)$', line)
        if m:
            buckets.setdefault(m.group(1), []).append(
                (m.group(2), int(m.group(3))))
        m = re.match(r"^(\S+)_count (\d+)$", line)
        if m:
            counts[m.group(1)] = int(m.group(2))
    check(set(buckets) == set(counts) and buckets,
          f"{what}: histograms without counts")
    for base, bs in buckets.items():
        vals = [n for _le, n in bs]
        check(vals == sorted(vals) and bs[-1] == ("+Inf", counts[base]),
              f"{what}: {base}: buckets not monotone or +Inf != count")
    return len(buckets), len(text.splitlines())


def device_busy(dt, window, lo=None, hi=None):
    """From a ``metrics.device_trace``: (wall s, busy share, the device's
    kernel time by name [(ms, name, launches)]) over the interval of the
    record_function ``window`` (or [lo, hi] in the profiler's
    microseconds): busy is the union of the CUDA kernel, memcpy and
    memset intervals in it."""
    from torch.autograd import DeviceType
    evs = dt.profile.events()
    # the profiler mirrors a host annotation with kernels under it onto
    # the device's timeline: those copies are annotations, not activity
    notes = {e.name for e in evs if e.device_type == DeviceType.CPU}
    win = [e for e in evs
           if e.name == window and e.device_type == DeviceType.CPU]
    check(len(win) == 1, f"the device trace holds {len(win)} {window} "
                         f"regions")
    if lo is None:
        lo, hi = win[0].time_range.start, win[0].time_range.end
    spans = sorted((max(lo, e.time_range.start), min(hi, e.time_range.end))
                   for e in evs if e.device_type == DeviceType.CUDA
                   and e.name not in notes
                   and not getattr(e, "is_user_annotation", False)
                   and e.time_range.end > lo and e.time_range.start < hi)
    check(spans, f"{window}: no CUDA activity in the window")
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += cur[1] - cur[0]
    kernels = []
    for a in dt.profile.key_averages():
        if getattr(a, "device_type", None) != DeviceType.CUDA \
                or a.key in notes:
            continue
        us = getattr(a, "self_device_time_total", None)
        if us is None:
            us = a.self_cuda_time_total
        if us > 0:
            kernels.append((us / 1e3, a.key, a.count))
    kernels.sort(reverse=True)
    return (hi - lo) / 1e6, busy / (hi - lo), kernels


def log_busy(what, wall, busy, kernels, smi):
    log(f"[obs] device trace, {what}: wall {wall:.4f} s, device busy "
        f"{busy:.2%}, idle {1 - busy:.2%} (union of CUDA kernel and memcpy "
        f"intervals; {smi})")
    for ms, name, n in kernels[:8]:
        log(f"[obs]   {ms:10.3f} ms  {n:6d} x  {name[:90]}")


def phase_obs(dev, served, smi):
    """The observability layer on the card, through ``ReporterService``
    and the threaded server built from a config file with
    ``shadow_sample`` 1.0 and a flight-recorder directory: main's 608
    requests from 64 client threads, every eighth with ``?trace=1``,
    bodies byte-equal to the native CPU run (a traced answer's ``report``
    member), every traced span tree well formed and holding every stage
    of ``OBS_STAGES`` (the median split printed), every chunk shadowed by
    the plain scan on the CPU with no mismatch and no error while the
    kernel launched once a chunk; the same window with the shadow off,
    for the split without it; ``/profile``'s chunk events the chunks
    the matcher dispatched and no build after the build phase;
    ``/metrics`` scrape-clean; ``/health`` 200, and 503 naming the breach
    from a second service with ``slo_ms`` "service.handle=0.001"; the
    incremental shadow over a 64-uuid stream through
    ``report_incremental``; a flight-recorder dump with the last wide
    events. Then ``metrics.device_trace`` over one warm ``match_many``
    of main's 512 traces (lanes on and inline) and over one 608-request
    serving window: busy and idle shares and kernel time by name. Then
    the serving window in turns disarmed, traced and shadowed, for
    requests/s.
    Returns {"launches": the parity window's kernel launches, ...}."""
    import tempfile
    import torch
    from torch.profiler import record_function
    from reporter_tpu_torch import ops
    from reporter_tpu_torch.matcher import SegmentMatcher
    from reporter_tpu_torch.obs import flightrec, profiler
    from reporter_tpu_torch.service.server import (ReporterService,
                                                   configure_obs,
                                                   matcher_from_config,
                                                   read_config, serve)
    from reporter_tpu_torch.utils import metrics
    city, params = served["city"], served["params"]
    reqs, want = served["reqs"], served["want"]
    main = reqs[:N_TRACES]
    out_dir = ROOT / "reporter_tpu_torch" / "_build" / "obs"
    rec_dir = out_dir / "flightrec"
    t_phase = time.perf_counter()
    up = []        # (service, server) to stop
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        city.save(f"{tmp}/city.npz")

        def config(name, **keys):
            with open(f"{tmp}/{name}.json", "w") as f:
                json.dump({"graph": f"{tmp}/city.npz",
                           "matcher": {"max_candidates": K},
                           "service": keys}, f)
            conf = read_config(f"{tmp}/{name}.json")
            configure_obs(conf["obs"])
            return conf

        try:
            conf = config("obs", shadow_sample=1.0,
                          flightrec_dir=str(rec_dir))
            matcher = matcher_from_config(conf, "cuda")
            check(matcher.device.type == dev.type and matcher._lanes
                  is not None and matcher.runtime is not None,
                  "the [obs] matcher is not native on the card, lanes on")
            svc = ReporterService(matcher, **conf["service"])
            httpd = serve(svc, "127.0.0.1", 0)
            up.append((svc, httpd))
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            chunks = []   # (T, K, traces, rows) of every drained chunk
            drain = matcher._drain_stage

            def drain_counted(batch, order, *rest):
                rows, T, Kb = batch.dist_m.shape
                chunks.append((T, Kb, len(order), rows))
                return drain(batch, order, *rest)

            matcher._drain_stage = drain_counted  # bound at each submit
            answers_match(post_all(url, reqs, SERVE_CLIENTS)[0], want,
                          "[obs] warm window")
            check(profiler.drain_shadow(120.0), "the shadow did not drain")

            def traced_window(what):
                """608 requests, every 8th ?trace=1: (wall, launches,
                each traced answer's split); every body checked."""
                ops.viterbi_cuda.launches = 0
                answers, _secs, wall = post_all(
                    url, reqs, SERVE_CLIENTS, trace_every=OBS_TRACE_EVERY)
                launches = ops.viterbi_cuda.launches
                splits = []
                for i, (st, _tag, body) in enumerate(answers):
                    check(st == 200, f"[obs] {what}: request {i} answered "
                                     f"{st}")
                    if i % OBS_TRACE_EVERY:
                        check(body.decode() == want[i],
                              f"[obs] {what}: body {i} differs from the "
                              f"native CPU run")
                        continue
                    head = ('{"report":' + want[i] + ',"trace":').encode()
                    check(body.startswith(head) and body.endswith(b"}"),
                          f"[obs] {what}: traced answer {i}: its report "
                          f"member differs from the native CPU run's body")
                    trace = json.loads(body[len(head):-1])
                    splits.append(span_split(trace["traceEvents"],
                                             f"{what}: traced answer {i}"))
                return wall, launches, splits

            def median_split(splits):
                """Median ms per stage, and of the dispatcher queue."""
                med = {k: float(np.median([s.get(k, 0.0) for s in splits]))
                       for k in OBS_STAGES}
                queue = float(np.median([
                    s["service.handle"] - s["dispatch.batch"]
                    - s["report.serialise"] for s in splits]))
                return med, queue

            # -- parity: the shadow on every chunk, ?trace=1 on every 8th
            profiler.reset()
            metrics.default.reset()
            chunks.clear()
            wall, launches, splits = traced_window("parity")
            behind = profiler.shadow_stats()["pending"]
            t0 = time.perf_counter()
            check(profiler.drain_shadow(120.0), "the shadow did not drain")
            lag = time.perf_counter() - t0
            n_traced = len(splits)
            ctr = metrics.snapshot()["counters"]
            shadow = profiler.shadow_stats()
            check(len(chunks) == launches == ctr.get("profile.chunks", 0)
                  == ctr.get("decode.shadow.chunks", 0),
                  f"[obs] {launches} launches, {len(chunks)} chunks drained, "
                  f"{ctr.get('profile.chunks', 0)} chunk events, "
                  f"{ctr.get('decode.shadow.chunks', 0)} chunks shadowed")
            check(shadow["sampled"] == ctr.get("decode.shadow.sampled", 0)
                  == sum(c[2] for c in chunks) == len(reqs),
                  f"[obs] the shadow sampled {shadow['sampled']} traces of "
                  f"{len(reqs)}")
            check(shadow["mismatch"] == 0
                  and ctr.get("decode.shadow.errors", 0) == 0
                  and ctr.get("decode.shadow.dropped", 0) == 0,
                  f"[obs] shadow {shadow}, counters {ctr}")
            med, queue = median_split(splits)
            log(f"[obs] parity: {len(reqs)} requests from {SERVE_CLIENTS} "
                f"client threads, every {OBS_TRACE_EVERY}th traced, in "
                f"{wall:.4f} s: bodies byte-equal to the native CPU run (the "
                f"report member of {n_traced} traced answers); {len(chunks)} "
                f"chunks, {launches} kernel launches; the shadow re-decoded "
                f"{ctr['decode.shadow.chunks']} chunks, {shadow['sampled']} "
                f"traces, by the plain scan on the CPU: 0 mismatches, 0 "
                f"errors, 0 dropped; {behind} chunks still waiting at the "
                f"window's end, drained {lag:.2f} s later")
            log(f"[obs] {n_traced} span trees well formed (one trace id, "
                f"parents resolve, children inside their parents, all "
                f"{len(OBS_STAGES)} stages); median ms per traced request, "
                f"the shadow on every chunk: "
                + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
                + f"; in the dispatcher queue (handle - batch - serialise) "
                f"{queue:.3f}")
            result.update(launches=launches, traced=n_traced,
                          split_ms=med, queue_ms=queue)

            # -- the same split with the shadow off
            configure_obs({"shadow_sample": 0.0})
            before = counters("decode.shadow.chunks")
            wall_off, _n, splits = traced_window("shadow off")
            check(counters("decode.shadow.chunks") == before,
                  "[obs] the shadow ran with shadow_sample 0")
            med_off, queue_off = median_split(splits)
            log(f"[obs] {len(splits)} span trees well formed; median ms per "
                f"traced request, the shadow off ({wall_off:.4f} s for the "
                f"window, against {wall:.4f} s with it): "
                + ", ".join(f"{k} {v:.3f}" for k, v in med_off.items())
                + f"; in the dispatcher queue {queue_off:.3f}")
            result.update(split_ms_shadow_off=med_off,
                          queue_ms_shadow_off=queue_off)
            configure_obs({"shadow_sample": 1.0})

            # -- the endpoints
            st, _h, raw = http(url + "/profile")
            prof = json.loads(raw)
            # /profile shows the last 64 events; the one dispatcher thread
            # records them in the order the FIFO drain lane drains
            got = [(e["bucket_T"], e["K"], e["traces"], e["rows"])
                   for e in prof["events"]]
            check(st == 200 and len(got) == min(64, len(chunks))
                  and got == chunks[len(chunks) - len(got):],
                  f"/profile {st}: its chunk events {got} are not the last "
                  f"of the dispatched chunks {chunks}")
            # holds by construction: the build phase loaded every
            # library, and ops/nvcc.py loads a library once per process
            check(prof["compile_episodes"] == 0
                  and all(sh["compiles"] == 0 for sh in prof["shapes"])
                  and ctr.get("decode.compile.recompiles", 0) == 0,
                  f"kernel builds after the build phase: {prof['shapes']}")
            for sh in prof["shapes"]:
                lat = sh["launch_latency"]
                log(f"[obs] /profile shape (B={sh['B']}, T={sh['T']}, "
                    f"K={sh['K']}, {sh['backend']}): {sh['dispatches']} "
                    f"dispatches, steady mean {sh['steady']['mean_s']} s; "
                    f"{lat['n']} launches, launch latency (event pair: "
                    f"submission and kernel) mean "
                    f"{lat['mean_s'] * 1e3:.4f} ms, max "
                    f"{lat['max_s'] * 1e3:.4f} ms")
            st, h, raw = http(url + "/metrics")
            check(st == 200 and h["Content-type"].startswith("text/plain"),
                  f"/metrics {st} {h['Content-type']}")
            n_hist, n_lines = scrape_clean(raw.decode(), "/metrics")
            st, _h, raw = http(url + "/health")
            check(st == 200 and json.loads(raw)["status"] == "ok",
                  f"/health {st} {raw[:200]!r}")
            log(f"[obs] /profile: its {len(got)} chunk events = the last "
                f"{len(got)} dispatched (T, K, traces, rows) of "
                f"{len(chunks)}, 0 builds after the build phase (by "
                f"construction); "
                f"/metrics: {n_lines} lines, {n_hist} histograms, "
                f"scrape-clean, each +Inf bucket its count; /health 200")

            # -- the incremental shadow: a 64-uuid stream
            names = ("match.incremental.matches",
                     "match.incremental.shadow_checks",
                     "match.incremental.shadow_mismatches",
                     "match.incremental.shadow_errors")
            before = counters(*names)
            for hi in (16, 32, 48, 64):
                window = [dict(r, trace=r["trace"][:hi])
                          for r in main[:OBS_STREAM_UUIDS]]
                check(None not in svc.report_incremental(window),
                      f"report_incremental: a slot failed at {hi} points")
            n_match, n_check, n_mis, n_err = (
                a - b for a, b in zip(counters(*names), before))
            check(n_match > 0 and n_check == n_match and n_mis == 0
                  and n_err == 0,
                  f"incremental shadow: {n_match} windows served, {n_check} "
                  f"checked, {n_mis} mismatches, {n_err} errors")
            log(f"[obs] incremental shadow: {OBS_STREAM_UUIDS} uuids, 4 "
                f"calls: {n_match} windows served, {n_check} re-matched by "
                f"the batch path on the host, 0 mismatches, 0 errors")

            # -- SLO breach on a second service
            conf2 = config("slo", slo_ms="service.handle=0.001")
            svc2 = ReporterService(matcher, **conf2["service"])
            httpd2 = serve(svc2, "127.0.0.1", 0)
            up.append((svc2, httpd2))
            st, _h, raw = http(f"http://127.0.0.1:{httpd2.server_address[1]}"
                               "/health")
            body = json.loads(raw)
            check(st == 503 and body["status"] == "degraded"
                  and [b["stage"] for b in body["slo"]["breaches"]]
                  == ["service.handle"],
                  f"slo_ms service.handle=0.001: /health {st} {body}")
            configure_obs({"slo_ms": None, "shadow_sample": 0.0})
            check(http(url + "/health")[0] == 200, "/health after the SLO")
            log(f"[obs] slo_ms service.handle=0.001: /health 503, breach "
                f"{body['slo']['breaches']}")

            # -- the flight recorder
            path = flightrec.dump("chip_smoke")
            check(path is not None and os.path.exists(path),
                  f"flightrec.dump wrote {path}")
            with open(path) as f:
                post = json.load(f)
            check(post["wide_events"] and post["wide_events"]
                  == profiler.recent_events(16),
                  "the dump does not hold the last wide events")
            log(f"[obs] flightrec.dump: {os.path.relpath(path, ROOT)}, "
                f"{len(post['wide_events'])} wide events, "
                f"{len(post['spans'])} spans")

            # -- the device's idle share, from torch.profiler
            inline = SegmentMatcher(city, params, pipeline=False)
            for what, m in (("lanes on", matcher), ("inline", inline)):
                m.match_many(main)   # warm
                with metrics.device_trace(str(out_dir), dev) as dt:
                    with record_function("obs.match_many"):
                        m.match_many(main)
                wall_s, busy, kern = device_busy(dt, "obs.match_many")
                log_busy(f"one warm match_many of {N_TRACES} traces, "
                         f"{what} ({os.path.relpath(dt.path, ROOT)})",
                         wall_s, busy, kern, smi)
                result[f"match_many_{what.replace(' ', '_')}"] = {
                    "wall_s": wall_s, "busy": busy}
            with metrics.device_trace(str(out_dir), dev) as dt:
                anchor_us = time.time_ns() / 1e3
                with record_function("obs.serve_window"):
                    answers, _secs, wall, (t0_ns, t1_ns) = post_all(
                        url, reqs, SERVE_CLIENTS, span=True)
            answers_match(answers, want, "[obs] traced serving window")
            ev = next(e for e in dt.profile.events()
                      if e.name == "obs.serve_window")
            off = anchor_us - ev.time_range.start
            wall_s, busy, kern = device_busy(
                dt, "obs.serve_window", t0_ns / 1e3 - off,
                t1_ns / 1e3 - off)
            log_busy(f"one serving window of {len(reqs)} requests, lanes on "
                     f"({os.path.relpath(dt.path, ROOT)}; client wall "
                     f"{wall:.4f} s)", wall_s, busy, kern, smi)
            result["serve_window"] = {"wall_s": wall_s, "busy": busy}

            # -- what tracing and the shadow cost: the window in turns
            rates = {mode: [] for mode in OBS_ORDER}
            for mode in OBS_ORDER:
                configure_obs({"trace": mode == "traced",
                               "shadow_sample":
                               1.0 if mode == "shadowed" else 0.0})
                before = counters("decode.shadow.chunks",
                                  "decode.shadow.dropped",
                                  "decode.shadow.mismatch",
                                  "decode.shadow.errors")
                answers, _secs, wall = post_all(url, reqs, SERVE_CLIENTS)
                t0 = time.perf_counter()
                check(profiler.drain_shadow(120.0),
                      "the shadow did not drain")
                lag = time.perf_counter() - t0
                answers_match(answers, want, f"[obs] {mode} window")
                n_chunks, dropped, n_mis, n_err = (
                    a - b for a, b in zip(counters(
                        "decode.shadow.chunks", "decode.shadow.dropped",
                        "decode.shadow.mismatch", "decode.shadow.errors"),
                        before))
                check((n_chunks > 0) == (mode == "shadowed")
                      and n_mis == 0 and n_err == 0,
                      f"[obs] {mode} window: {n_chunks} chunks shadowed, "
                      f"{n_mis} mismatches, {n_err} errors")
                rates[mode].append(len(reqs) / wall)
                log(f"[obs] overhead, {mode}: {len(reqs) / wall:.1f} "
                    f"requests/s ({wall:.4f} s)"
                    + (f"; {n_chunks} chunks shadowed, {dropped} dropped, "
                       f"drained {lag:.2f} s after the window"
                       if mode == "shadowed" else ""))
            configure_obs({"trace": False, "shadow_sample": 0.0})
            log("[obs] overhead, requests/s, medians of two windows each: "
                + ", ".join(f"{m} {np.median(r):.1f}"
                            for m, r in rates.items())
                + f" (order {' '.join(OBS_ORDER)}; informational; {smi})")
            result["rates"] = rates
        finally:
            configure_obs({"trace": False, "slo_ms": None,
                           "shadow_sample": 0.0, "flightrec_dir": None})
            for s_, h_ in up:
                h_.shutdown()
                h_.server_close()
            for s_, _h in up:
                check(s_.dispatcher.close(), "an [obs] dispatcher did not "
                                             "stop")
            check(profiler.shutdown_shadow_pool(), "the shadow pool did not "
                                                   "stop")
    log(f"[obs] phase took {time.perf_counter() - t_phase:.1f} s")
    return result


def phase_faults(dev, served):
    """Failure domains and overload control on the card, each leg through
    a front door built from a config file (``read_config``,
    ``configure_faults``, ``matcher_from_config``), the 20x20 city and
    main's 608 requests, with every breaker at threshold 2 (1 for the
    card's domains) and ``FAULT_COOLDOWN_S``:

    - ``native.prep``, ``matcher.assemble`` and ``wire.native``, the
      host-to-host sites: a bounded storm (``#limit``) fired by two
      requests opens the breaker at its threshold, /health answers 503
      naming the domain (the writer's breaker is not a /health domain, as
      in the JAX package: its state and counters are read instead), a
      window of the 608 requests from 64 client threads runs while it is
      open, then a probe after the cooldown closes it and /health answers
      200. Every 200 body is byte-equal to the native CPU run's but the
      one poisoned trace's, which holds the empty match and whose
      quarantine file is in the spool. viterbi_decode's launches equal
      the chunks dispatched;
    - ``decode.dispatch``, ``route.device`` (on a ``route_device``
      matcher) and ``native.prep`` on a ``route_device`` matcher, whose
      numpy prep would search the routes on the host: the failing chunk
      answers 500, then requests answer 503 with Retry-After and no
      kernel launches, and after the cooldown the probe launches (the
      decode, and relax and pair_costs with device routes), answers the
      CPU run's bytes and closes the breaker; no chunk takes the numpy
      prep;
    - ``match.incremental.commit`` on the stream phase's parity input:
      the failing call declines every slot, and report_incremental equals
      report_many;
    - admission armed with ``ADMIT_INFLIGHT`` in flight: windows of the
      608 requests from ``ADMIT_CLIENTS`` client threads until the ladder
      reaches ``shed_trace``: every answer 200 or 429, every 429 with
      Retry-After in [1, 30], every 200 body byte-equal; the ladder back
      at ``normal`` within two holds a rung once the load stops. Then
      rung 4 forced: a window with the launches equal to the chunks (and
      ``pressure.oracle_chunks`` 0, which the port never counts: the
      launches are the evidence).

    The plain scan is counted throughout and must stay at 0. Returns
    {kernel: {leg: launches}}."""
    import tempfile
    from reporter_tpu_torch import ops
    from reporter_tpu_torch.matcher import SegmentMatcher
    from reporter_tpu_torch.matcher import matcher as matcher_mod
    from reporter_tpu_torch.service import admission, wire
    from reporter_tpu_torch.service.report import report_json
    from reporter_tpu_torch.service.server import (ReporterService,
                                                   configure_faults,
                                                   configure_obs,
                                                   matcher_from_config,
                                                   read_config, serve)
    from reporter_tpu_torch.utils import faults, metrics
    city, params = served["city"], served["params"]
    reqs, want = served["reqs"], served["want"]
    t_phase = time.perf_counter()
    plain_calls = [0]
    plain = ops.viterbi_plain

    def counted_plain(*args, **kw):
        plain_calls[0] += 1
        return plain(*args, **kw)

    ops.viterbi_plain = counted_plain   # ops.decode_batch reads it here
    launches = {name: {} for name in kernel_wrappers()}
    launches["incremental_step"] = {}
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    city.save(f"{tmp}/city.npz")
    spool_dir = f"{tmp}/spool"

    def door(name, pool_size=64, **keys):
        """(matcher, service, server, url, dispatched batches) of one
        front door from a config file."""
        keys = {"circuit_threshold": 2,
                "circuit_cooldown_s": FAULT_COOLDOWN_S,
                "deadletter_dir": spool_dir, "shadow_sample": 0.0,
                "trace": False, **keys}
        with open(f"{tmp}/{name}.json", "w") as f:
            json.dump({"graph": f"{tmp}/city.npz",
                       "matcher": {"max_candidates": K}, "service": keys}, f)
        conf = read_config(f"{tmp}/{name}.json")
        configure_obs(conf["obs"])
        configure_faults(conf["faults"])
        matcher = matcher_from_config(conf, "cuda")
        svc = ReporterService(matcher, **conf["service"])
        httpd = serve(svc, "127.0.0.1", 0, pool_size)
        dispatched = [0]
        stage = matcher._dispatch_stage

        def counted_stage(*args):
            out = stage(*args)
            dispatched[0] += 1   # a batch that reached its launch
            return out

        matcher._dispatch_stage = counted_stage  # bound at each submit
        return (matcher, svc, httpd,
                f"http://127.0.0.1:{httpd.server_address[1]}", dispatched)

    def close(svc, httpd):
        httpd.shutdown()
        httpd.server_close()
        check(svc.dispatcher.close(), "a [faults] dispatcher did not stop")

    def post(url, i):
        return http(url + "/report", json.dumps(reqs[i]).encode())

    def health(url):
        st, _h, body = http(url + "/health")
        return st, json.loads(body)

    def wait_cooldown(breaker):
        time.sleep(breaker.snapshot()["cooldown_remaining_s"] + 0.05)

    def host_leg(site, spec, breaker_of, opened_name):
        matcher, svc, httpd, url, dispatched = door(site.replace(".", "_"))
        what = f"[faults] {site}"
        try:
            metrics.default.reset()
            ops.viterbi_cuda.launches = dispatched[0] = 0
            faults.configure(spec)
            storm = [post(url, i) for i in (0, 1)]
            breaker = breaker_of(matcher)
            check(breaker.snapshot()["state"] == "open"
                  and metrics.counter(f"{opened_name}.opened") == 1,
                  f"{what}: the breaker did not open at its threshold: "
                  f"{breaker.snapshot()}")
            st, body = health(url)
            if site == "wire.native":
                check(st == 200 and body["degraded"]["open"] == [],
                      f"{what}: /health {st} {body['degraded']}")
            else:
                check(st == 503 and body["degraded"]["open"] == [site],
                      f"{what}: /health {st} {body['degraded']} while open")
            answers, _secs, wall = post_all(url, reqs, SERVE_CLIENTS)
            wait_cooldown(breaker)
            probe = post(url, 2)
            st_after, body_after = health(url)
            check(st_after == 200 and body_after["degraded"]["open"] == []
                  and breaker.snapshot()["state"] == "closed"
                  and metrics.counter(f"{opened_name}.closed") == 1,
                  f"{what}: the probe did not close the breaker: "
                  f"{breaker.snapshot()}")
            poisoned = None
            if site == "matcher.assemble":
                poisoned = 0
                empty = report_json({"segments": [], "mode": "auto"},
                                    reqs[0], 15, {0, 1, 2}, {0, 1, 2})
                check(storm[0][0] == 200 and storm[0][2].decode() == empty,
                      f"{what}: the poisoned trace's answer {storm[0][0]} "
                      f"is not the empty match")
                path = f"{spool_dir}/poison.{reqs[0]['uuid']}.json"
                check(os.path.exists(path),
                      f"{what}: no quarantine file {path}")
                with open(path) as f:
                    spooled = json.load(f)
                check([(p["lat"], p["lon"]) for p in spooled["trace"]]
                      == [(p["lat"], p["lon"]) for p in reqs[0]["trace"]],
                      f"{what}: the quarantine file holds another trace")
                check(metrics.counter("matcher.assemble.quarantined") == 1,
                      f"{what}: quarantined "
                      f"{metrics.counter('matcher.assemble.quarantined')}")
            for i, (st, _h, body) in ((0, storm[0]), (1, storm[1]),
                                      (2, probe)):
                if i != poisoned:
                    check(st == 200 and body.decode() == want[i],
                          f"{what}: request {i} answered {st} or other "
                          f"bytes")
            answers_match(answers, want, f"{what}: window while open")
            n = ops.viterbi_cuda.launches
            check(n == dispatched[0],
                  f"{what}: {n} launches for {dispatched[0]} chunks")
            counts = {k: v for k, v in metrics.snapshot()["counters"]
                      .items() if "circuit" in k or k.startswith(
                          ("wire.", "matcher.assemble"))}
            log(f"[faults] {site}: spec {spec}; the breaker opened at its "
                f"threshold and the probe closed it after "
                f"{FAULT_COOLDOWN_S} s; /health {'200 (not a /health '
                'domain)' if site == 'wire.native' else '503 naming it'} "
                f"while open, 200 after; {len(reqs)} requests while open "
                f"in {wall:.4f} s ({len(reqs) / wall:.1f} requests/s), "
                f"every 200 body byte-equal"
                + (", the poisoned trace empty and quarantined"
                   if poisoned is not None else "")
                + f"; viterbi_decode launches {n} = chunks {dispatched[0]}; "
                f"counters {counts}")
            return n
        finally:
            faults.clear()
            close(svc, httpd)

    host_preps = [0]
    numpy_prep = matcher_mod.prepare_traces_numpy

    def counted_numpy_prep(*args):
        host_preps[0] += 1
        return numpy_prep(*args)

    def card_leg(leg, domain, route_device, breaker_of, errors):
        matcher, svc, httpd, url, dispatched = door(
            leg.replace(".", "_").replace("+", "_"), circuit_threshold=1,
            route_device=route_device)
        breaker = breaker_of(matcher)
        spec = f"{domain}=error#1"
        what = f"[faults] {leg}"
        host_preps[0] = 0
        # the matcher's degraded prep: with device routes it would search
        # the routes on the host, so it must not run in these legs
        matcher_mod.prepare_traces_numpy = counted_numpy_prep
        try:
            metrics.default.reset()
            for fn in kernel_wrappers().values():
                fn.launches = 0
            dispatched[0] = 0
            faults.configure(spec)
            st, _h, body = post(url, 0)
            check(st == 500 and b"injected error" in body,
                  f"{what}: the failing chunk answered {st} {body[:200]!r}")
            st, hbody = health(url)
            check(st == 503 and hbody["degraded"]["open"] == [domain],
                  f"{what}: /health {st} {hbody['degraded']} while open")
            before = {k: fn.launches for k, fn in kernel_wrappers().items()}
            refused, refused_ms = [], []
            for i in range(1, 9):
                t0 = time.perf_counter()
                st, h, body = post(url, i)
                refused_ms.append((time.perf_counter() - t0) * 1e3)
                retry = h["Retry-After"]
                check(st == 503 and retry is not None
                      and 1 <= int(retry) <= np.ceil(FAULT_COOLDOWN_S)
                      and json.loads(body)["domain"] == domain,
                      f"{what}: request {i} answered {st} Retry-After "
                      f"{retry} while open")
                refused.append(int(retry))
            after = {k: fn.launches for k, fn in kernel_wrappers().items()}
            check(after == before,
                  f"{what}: launches while open: {before} -> {after}")
            wait_cooldown(breaker)
            st, _h, body = post(url, 9)
            check(st == 200 and body.decode() == want[9],
                  f"{what}: the probe answered {st} or other bytes")
            probe = {k: fn.launches - after[k]
                     for k, fn in kernel_wrappers().items()}
            check(probe["viterbi_decode"] == 1
                  and (not route_device or (probe["pair_costs"] >= 1
                                            and probe["relax"] >= 1)),
                  f"{what}: the probe launched {probe}")
            st, hbody = health(url)
            check(st == 200 and breaker.snapshot()["state"] == "closed",
                  f"{what}: /health {st} after the probe, "
                  f"{breaker.snapshot()}")
            check(metrics.counter(errors) == 1,
                  f"{what}: {errors} {metrics.counter(errors)}")
            check(host_preps[0] == 0,
                  f"{what}: {host_preps[0]} chunks took the numpy prep")
            log(f"[faults] {leg}: spec {spec}; the failing chunk "
                f"answered 500 and opened the breaker (threshold 1); "
                f"/health 503 naming it; 8 requests answered 503 with "
                f"Retry-After {sorted(set(refused))} s and no launch "
                f"({before}) in {np.median(refused_ms):.2f} ms each "
                f"(median; most {max(refused_ms):.2f}); after "
                f"{FAULT_COOLDOWN_S} s the probe "
                f"launched {probe}, answered the CPU run's bytes and "
                f"closed the breaker; the numpy prep ran 0 times")
            return {k: v for k, v in probe.items() if v}
        finally:
            matcher_mod.prepare_traces_numpy = numpy_prep
            faults.clear()
            close(svc, httpd)

    def commit_leg():
        svc = ReporterService(SegmentMatcher(city, params, device=dev))
        reqs0 = [dict(r, match_options=OPTS_B if i % 4 == 3 else OPTS)
                 for i, r in enumerate(reqs[:N_TRACES])]

        def window(hi):
            return [dict(r, trace=r["trace"][:hi]) for r in reqs0]
        try:
            check(None not in svc.report_incremental(window(40)),
                  "[faults] commit: a warm report failed")
            served_before = sum(m is not None for m in
                                svc.matcher.match_incremental(window(44)))
            metrics.default.reset()
            ops.incremental_steps_cuda.launches = 0
            faults.configure("match.incremental.commit=error#1")
            got = svc.report_incremental(window(48))
            fired = faults.fired_counts()
            faults.clear()
            steps = ops.incremental_steps_cuda.launches
            check(fired == {"match.incremental.commit": 1}
                  and metrics.counter("matcher.circuit.incremental.failures")
                  == 1 and metrics.counter("match.incremental.matches") == 0,
                  f"[faults] commit: fired {fired}, counters "
                  f"{metrics.snapshot()['counters']}")
            check(got == svc.report_many(window(48)) and None not in got,
                  "[faults] commit: report_incremental differs from "
                  "report_many")
            again = sum(m is not None for m in
                        svc.matcher.match_incremental(window(52)))
        finally:
            faults.clear()
            check(svc.dispatcher.close(), "the commit dispatcher did not "
                                          "stop")
        log(f"[faults] match.incremental.commit: {len(reqs0)} uuids, "
            f"{served_before} windows served before; the armed call "
            f"declined all {len(got)} slots (incremental_step launches "
            f"{steps} before the fault), report_incremental equal to "
            f"report_many; {again} served on the next call")
        return steps

    def admission_leg():
        admission._reset_module()
        matcher, svc, httpd, url, dispatched = door(
            "admission", pool_size=ADMIT_CLIENTS, admission=True,
            inflight_max=ADMIT_INFLIGHT, pressure_hold_s=ADMIT_HOLD_S)
        what = "[faults] admission"
        try:
            check(svc.admission is not None
                  and svc.admission.inflight_max == ADMIT_INFLIGHT,
                  f"{what}: the gate is not armed")
            metrics.default.reset()
            ops.viterbi_cuda.launches = dispatched[0] = 0
            windows = []
            for w in range(ADMIT_WINDOWS):
                answers, secs, wall, retry = post_all(
                    url, reqs, ADMIT_CLIENTS, retry=True)
                n429 = 0
                ok_s = []
                for i, (st, _h, body) in enumerate(answers):
                    check(st in (200, 429),
                          f"{what}: window {w} request {i} answered {st}")
                    if st == 429:
                        n429 += 1
                        check(retry[i] is not None
                              and 1 <= int(retry[i]) <= 30,
                              f"{what}: a 429 with Retry-After {retry[i]}")
                    else:
                        ok_s.append(secs[i])
                        check(body.decode() == want[i],
                              f"{what}: window {w} body {i} differs")
                windows.append({
                    "requests_per_s": len(reqs) / wall, "wall_s": wall,
                    "shed_share": n429 / len(reqs),
                    "served_p99_ms": float(np.percentile(ok_s, 99)) * 1e3
                    if ok_s else None,
                    "level": admission.current_level()})
                if metrics.counter("pressure.enter.shed_trace"):
                    break
            peak = max(w["level"] for w in windows)
            check(metrics.counter("pressure.enter.shed_trace") >= 1,
                  f"{what}: the ladder did not reach shed_trace in "
                  f"{len(windows)} windows: {windows}")
            n = ops.viterbi_cuda.launches
            check(n == dispatched[0],
                  f"{what}: {n} launches for {dispatched[0]} chunks")
            # the last window's sheds may still step the ladder down one
            # rung at the first sample after the load; from there each
            # rung needs two holds of calm
            level = admission.current_level()
            bound = 2 * ADMIT_HOLD_S * (level + 1) + 1.0
            t0 = time.perf_counter()
            while health(url)[1]["pressure"]["level"]:
                check(time.perf_counter() - t0 < bound,
                      f"{what}: the ladder stayed above normal for "
                      f"{bound:.2f} s after the load stopped")
                time.sleep(0.02)
            recovered = time.perf_counter() - t0
            for w, row in enumerate(windows):
                log(f"[faults] admission window {w}: {len(reqs)} requests "
                    f"from {ADMIT_CLIENTS} client threads, in-flight bound "
                    f"{ADMIT_INFLIGHT}: {row['requests_per_s']:.1f} "
                    f"requests/s ({row['wall_s']:.4f} s), shed share "
                    f"{row['shed_share']:.4f}, served p99 "
                    f"{row['served_p99_ms']} ms, ladder level "
                    f"{row['level']} after it")
            log(f"[faults] admission: every answer 200 or 429, every 429 "
                f"with Retry-After in [1, 30], every 200 body byte-equal; "
                f"sheds {metrics.counter('admission.shed.inflight')} "
                f"(inflight), ladder peak {peak} "
                f"({admission.RUNGS[peak]}), transitions "
                f"{metrics.counter('pressure.transitions')}; back at normal "
                f"{recovered:.3f} s after the load stopped (level {level} "
                f"then, hold {ADMIT_HOLD_S} s, bound {bound:.2f} s); "
                f"viterbi_decode launches {n} = chunks {dispatched[0]}")
            # rung 4 forced: the gate off, the ladder made with no hold
            svc.admission = None
            admission._reset_module()
            lad = admission.ladder(hold_s=0.0)
            for _ in range(4):
                lad.observe(True)
            st, body = health(url)
            check(body["pressure"]["state"] == "oracle_decode",
                  f"{what}: rung 4 not reported: {body['pressure']}")
            metrics.default.reset()
            ops.viterbi_cuda.launches = dispatched[0] = 0
            answers, _secs, wall = post_all(url, reqs, SERVE_CLIENTS)
            answers_match(answers, want, f"{what}: rung 4 window")
            n4 = ops.viterbi_cuda.launches
            check(n4 == dispatched[0] and n4 > 0
                  and metrics.counter("pressure.oracle_chunks") == 0,
                  f"{what}: rung 4: {n4} launches for {dispatched[0]} "
                  f"chunks, oracle_chunks "
                  f"{metrics.counter('pressure.oracle_chunks')}")
            log(f"[faults] rung 4 (oracle_decode) forced and reported: "
                f"{len(reqs)} requests in {wall:.4f} s, bodies byte-equal, "
                f"viterbi_decode launches {n4} = chunks {dispatched[0]} "
                f"(pressure.oracle_chunks 0 too, which the port never "
                f"counts)")
            return {"admission": n, "oracle_decode": n4}
        finally:
            admission._reset_module()
            close(svc, httpd)

    try:
        decode = launches["viterbi_decode"]
        for site, spec, breaker_of, name in (
                ("native.prep", "native.prep=error#2",
                 lambda m: m.circuit, "matcher.circuit"),
                ("matcher.assemble", "matcher.assemble=error#3",
                 lambda m: m.circuit_assemble, "matcher.circuit.assemble"),
                ("wire.native", "wire.native=error#2",
                 lambda m: wire.circuit, "wire.circuit")):
            decode[site] = host_leg(site, spec, breaker_of, name)
        for leg, domain, route_device, breaker_of, errors in (
                ("decode.dispatch", "decode.dispatch", False,
                 lambda m: m.circuit_decode,
                 "matcher.circuit.decode.errors"),
                ("route.device", "route.device", True,
                 lambda m: m.circuit_route, "route.device.errors"),
                ("native.prep+route_device", "native.prep", True,
                 lambda m: m.circuit, "matcher.circuit.native_errors")):
            for kernel, n in card_leg(leg, domain, route_device, breaker_of,
                                      errors).items():
                launches[kernel][leg] = n
        launches["incremental_step"]["match.incremental.commit"] = \
            commit_leg()
        decode.update(admission_leg())
    finally:
        ops.viterbi_plain = plain
        configure_faults({"faults": None, "deadletter_dir": None,
                          "circuit_threshold": 5, "circuit_cooldown_s": 30.0})
        tmp_dir.cleanup()
    check(plain_calls[0] == 0,
          f"[faults] the plain scan ran {plain_calls[0]} times")
    log(f"[faults] the plain scan ran 0 times; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


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
    ``relax`` or ``relax_cluster`` in one launch where the graph takes
    it, ``relax_sweep``'s sweeps back to back after a state reset, and
    with ``other`` (another checkout's ``ops.route_relax``) its sweeps the
    same way; each result bit-equal to the plain version's; then the
    plain version's time. Returns {"relax"|"relax_cluster"|"relax_sweep"
    |"other"|"plain": ms, "iters": sweeps}."""
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
    if kernel.relax_kernel in ("relax", "relax_cluster"):
        planes = torch.empty((2, len(srcs), N), device=dev)
        info = torch.zeros(3, dtype=torch.int32, device=dev)
        if kernel.relax_kernel == "relax":
            def one():
                route_relax.launch_relax(kernel._arcs, src, bound, N,
                                         planes[0], planes[1], info)
        else:
            route_relax.check_cluster(N, dev)

            def one():
                route_relax.launch_relax_cluster(
                    kernel._arcs, src, bound, N, planes[0], planes[1], info)
        out[kernel.relax_kernel] = graph_ms(one, n)
        for got, want in zip(planes, plain[:2]):
            check(bit_equal(got, want) == 0,
                  f"{label}: {kernel.relax_kernel} differs from the plain "
                  f"version")
    sweeps(route_relax, "relax_sweep")
    if other is not None:
        sweeps(other, "other")
    del plain
    out["plain"] = time_ms(lambda: route_relax.relax_csr(
        *cols, src, bound, n_nodes=N, max_iters=N), 2)
    torch.cuda.empty_cache()
    return out


def phase_timing_routes(dev, served, big, huge, past):
    """The route kernels at the main path's shapes, timed by CUDA graphs,
    each beside its bound and its plain version. ``relax``: one
    relaxation of the main path's first chunk (the 20x20 city, 128 T=64
    traces: S = 512 sources) and of the 100x100 city's first chunk (S =
    2,048), with ``relax_sweep``'s sweeps on the same inputs beside it
    (the kernel it replaced on these graphs). ``relax_cluster``: one
    relaxation of the 125x125 city's first chunk (S = 1,024, past
    ``relax``'s limit), and ``relax_sweep``'s sweeps (a sweep's time) on
    the same inputs. ``relax_sweep``: its sweeps (a sweep's time) at
    ``past``'s 341x341 city's first chunk (S = 128, N = 116,281), the
    shapes the main path gives it.
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
    bound = float(plan.chunk_bound)
    ms = time_relaxations(dev, kernel, srcs, bound, "125x125")
    dist = route_relax.relax_cluster_cuda(
        kernel._arcs, torch.from_numpy(srcs).to(dev), bound,
        n_nodes=kernel.n_nodes, max_iters=kernel.n_nodes)[0]
    c_bound, c_by, c_bytes = relax_bound(kernel, len(srcs), dist)
    del dist
    s_bound = sweep_bound(len(srcs), kernel.n_nodes, kernel.n_edges)
    sweep_ms = ms["relax_sweep"] / ms["iters"]
    plain_sweep = ms["plain"] / ms["iters"]
    log(f"[timing] relax_cluster, 125x125 city's first chunk (S={len(srcs)}"
        f", N={kernel.n_nodes}, E={kernel.n_edges}, clusters of "
        f"{route_relax.cluster_width(kernel.n_nodes)} blocks) at "
        f"{bound:.1f} m, {ms['iters']} sweeps: {ms['relax_cluster']:.4f} ms "
        f"in one launch; relax_sweep's sweeps on the same inputs (state "
        f"reset included) {ms['relax_sweep']:.4f} ms = {sweep_ms:.4f} ms a "
        f"sweep ({ms['relax_sweep'] / ms['relax_cluster']:.2f}x "
        f"relax_cluster); plain {ms['plain']:.3f} ms ({plain_sweep:.3f} a "
        f"sweep); bound {c_bound:.5f} ms by {c_by} ({c_bytes} bytes); "
        f"relax_sweep's bound {s_bound[0]:.5f} ms a sweep by {s_bound[1]} "
        f"({s_bound[2]} bytes)")
    out["relax_cluster"] = (ms["relax_cluster"], ms["plain"], c_bound, c_by)
    out["relax_sweep 125x125"] = (sweep_ms, plain_sweep, s_bound[0],
                                  s_bound[1])
    del kernel
    torch.cuda.empty_cache()

    kernel = DeviceRouteKernel(past["city"], dev)
    plan, srcs = first_chunk_sources(kernel, past)
    bound = float(plan.chunk_bound)
    name = f"{PAST_CITY['rows']}x{PAST_CITY['cols']}"
    ms = time_relaxations(dev, kernel, srcs, bound, name)
    s_bound = sweep_bound(len(srcs), kernel.n_nodes, kernel.n_edges)
    sweep_ms = ms["relax_sweep"] / ms["iters"]
    plain_sweep = ms["plain"] / ms["iters"]
    log(f"[timing] relax_sweep, {name} city's first chunk (S={len(srcs)}, "
        f"N={kernel.n_nodes}, E={kernel.n_edges}, past a cluster's reach) at "
        f"{bound:.1f} m, {ms['iters']} sweeps (state reset included): "
        f"{ms['relax_sweep']:.4f} ms = {sweep_ms:.4f} ms a sweep; plain "
        f"{ms['plain']:.3f} ms ({plain_sweep:.3f} a sweep); bound "
        f"{s_bound[0]:.5f} ms a sweep by {s_bound[1]} ({s_bound[2]} bytes)")
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


def step_launcher(mod, x, sigma, beta):
    """(a call that enqueues R rounds of ``mod``'s incremental step on
    the stacked operands ``x`` (R, N, ...) and (N, K) scores, uncounted,
    a call that returns its (scores, bp, prev_best) stacked by round):
    one launch where ``mod`` has the multi-round kernel, else one launch
    a round, each round's scores the next one's input."""
    import torch
    R, N, Kc = x[0].shape
    if hasattr(mod, "incremental_steps_cuda"):
        buf = torch.empty(mod.output_words(N, Kc, R), dtype=torch.int32,
                          device=x[0].device)
        RNK = R * N * Kc
        return (lambda: mod.launch(x, None, sigma, beta, buf),
                lambda: (buf[:RNK].view(torch.float32).view(R, N, Kc),
                         buf[RNK:2 * RNK].view(R, N, Kc),
                         buf[2 * RNK:].view(R, N)))
    bufs = [torch.empty(mod.output_words(N, Kc), dtype=torch.int32,
                        device=x[0].device) for _ in range(R)]
    NK = N * Kc

    def run():
        prev = x[5]
        for r in range(R):
            mod.launch((*(t[r] for t in x[:5]), prev), sigma, beta, bufs[r])
            prev = bufs[r][:NK].view(torch.float32).view(N, Kc)

    return run, lambda: (
        torch.stack([b[:NK].view(torch.float32).view(N, Kc) for b in bufs]),
        torch.stack([b[NK:2 * NK].view(N, Kc) for b in bufs]),
        torch.stack([b[2 * NK:] for b in bufs]))


def phase_against_step(dev, path):
    """This checkout's incremental step against the one at ``path`` at
    each (N, R) of ``STEP_TIMED`` (K=8, every row stepping every round):
    outputs equal (scores bit for bit), then each timed by CUDA graphs in
    the order other, this, this, other; a checkout without the
    multi-round kernel takes one launch a round. Returns {"N,R":
    {"other": [ms, ms], "this": [ms, ms]}}."""
    import torch
    from reporter_tpu_torch.ops import incremental
    other = load_other(path, "ops.incremental")
    sigma, beta = np.float32(4.07), np.float32(3.0)
    out = {}
    for N, R in STEP_TIMED:
        x = tuple(torch.from_numpy(a).to(dev)
                  for a in stacked_steps(N, K, R, 950 + N + R))
        fns = {name: step_launcher(mod, x, sigma, beta)
               for name, mod in (("this", incremental), ("other", other))}
        for run, _res in fns.values():
            run()
        torch.cuda.synchronize()
        same, _err = step_equal(fns["this"][1](), fns["other"][1]())
        check(same, f"incremental step at N,K,R={N},{K},{R} differs from "
                    f"{path}'s")
        ms = {"other": [], "this": []}
        for name in ("other", "this", "this", "other"):
            ms[name].append(graph_ms(fns[name][0], 100))
        log(f"[against] incremental_step N,K={N},{K}, {R} round(s): {path} "
            f"{ms['other'][0]:.5f} / {ms['other'][1]:.5f} ms, this "
            f"{ms['this'][0]:.5f} / {ms['this'][1]:.5f} ms")
        out[f"{N},{R}"] = ms
    return out


def phase_against_stream(dev, path):
    """The ragged call (``ragged_windows``) through a matcher of each
    checkout on the card, as first reports with new uuids each time: in
    turns other, this, this, other for the wall, then each once traced by
    tracemalloc for its host peak; the device peak over what was
    allocated before and the incremental-step launches of each call.
    Every match of this checkout is byte-equal to the other's. Returns
    {"other"|"this": {"wall_s": [...], "host_peak_bytes", "device_peak_
    bytes", "launches"}}."""
    from reporter_tpu_torch import ops
    from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
    from reporter_tpu_torch.synth import build_grid_city
    om = load_other(path, "matcher")
    oo = load_other(path, "ops")
    render = load_other(path, "matcher.matcher").render_segments_json
    counter = {"this": ops.incremental_steps_cuda,
               "other": getattr(oo, "incremental_steps_cuda", None)
               or oo.incremental_step_cuda}
    city = build_grid_city(**CITY)
    served = {"city": city, "params": MatchParams(max_candidates=K)}
    served["reqs"] = main_requests(SegmentMatcher(
        city, served["params"], device="cpu", native=False))[0]
    windows = ragged_windows(served)
    sides = {"other": om.SegmentMatcher(
        load_other(path, "synth").build_grid_city(**CITY),
        om.MatchParams(max_candidates=K), device=dev),
        "this": SegmentMatcher(city, served["params"], device=dev)}
    out = {name: {"wall_s": []} for name in sides}
    first = {}
    for i, name in enumerate(("other", "this", "this", "other",
                              "other", "this")):
        traced = i >= 4
        reqs, got, wall, host, dev_peak, n = ragged_call(
            sides[name], windows, f"a{i}", lambda: counter[name].launches,
            traced)
        if traced:
            out[name]["host_peak_bytes"] = host
        else:
            out[name]["wall_s"].append(wall)
            out[name].setdefault("device_peak_bytes", dev_peak)
            out[name].setdefault("launches", n)
        first.setdefault(name, [
            None if g is None else match_json(g) if name == "this" else
            json.dumps(g if isinstance(g, dict) else json.loads(render(
                g.cols, g.lo, g.hi, g.mode)), sort_keys=True) for g in got])
        log(f"[against-stream] {name} ({path if name == 'other' else '.'}), "
            f"ragged call {i + 1}{', traced' if traced else ''}: wall "
            f"{wall:.4f} s, device peak {dev_peak} bytes, launches {n}"
            + (f", host peak {host} bytes" if traced else ""))
    check(first["this"] == first["other"],
          "the ragged call's matches differ between the checkouts")
    for name in sides:
        w = out[name]["wall_s"]
        log(f"[against-stream] {name}: wall median "
            f"{float(np.median(w)):.4f} s (range {min(w):.4f}-{max(w):.4f}); "
            f"{json.dumps(out[name])}")
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


AGAINST_SERVE_ROUNDS = 10  # rounds of two turns, one a checkout


def phase_against_serve(dev, path):
    """What this checkout's always-on instrumentation costs against the
    checkout at ``path`` (a parent without it): one front door from each
    checkout, each from its own package (config file, native matcher on
    ``dev`` with the lanes on, ``ReporterService``, threaded server),
    every observability key at its default (trace disarmed, the shadow
    off). A warm window of main's 608 requests each, then
    ``AGAINST_SERVE_ROUNDS`` rounds in turns (other, this, this, other,
    ...), a turn being the median of five warm ``match_many`` +
    report calls of main's 512 traces and one window of the 608 requests
    from 64 client threads; every body byte-equal to this checkout's
    native CPU run. Returns {"other"|"this": {"match_many_s": [...],
    "requests_per_s": [...]}}, one entry a turn."""
    import tempfile
    from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
    from reporter_tpu_torch.service import server as this_server
    from reporter_tpu_torch.synth import build_grid_city
    city = build_grid_city(**CITY)
    params = MatchParams(max_candidates=K)
    main, mixed = main_requests(
        SegmentMatcher(city, params, device="cpu", native=False))
    reqs = main + mixed
    want = bodies(SegmentMatcher(city, params, device="cpu").match_many(reqs),
                  reqs)
    mods = {"other": (load_other(path, "service.server"),
                      load_other(path, "service.report").report_json),
            "this": (this_server, None)}
    sides = {}     # name -> (matcher, writer, service, server, url)
    out = {name: {"match_many_s": [], "requests_per_s": []} for name in mods}
    with tempfile.TemporaryDirectory() as tmp:
        city.save(f"{tmp}/city.npz")
        with open(f"{tmp}/cfg.json", "w") as f:
            json.dump({"graph": f"{tmp}/city.npz",
                       "matcher": {"max_candidates": K}, "service": {}}, f)
        try:
            for name, (srv, writer) in mods.items():
                conf = srv.read_config(f"{tmp}/cfg.json")
                m = srv.matcher_from_config(conf, dev.type)
                check(m.device.type == dev.type and m._lanes is not None
                      and m.runtime is not None,
                      f"[against-serve] {name}: the matcher is not native "
                      f"on {dev.type} with the lanes on")
                svc = srv.ReporterService(m, **conf["service"])
                httpd = srv.serve(svc, "127.0.0.1", 0)
                url = f"http://127.0.0.1:{httpd.server_address[1]}"
                sides[name] = (m, writer, svc, httpd, url)
                answers_match(post_all(url, reqs, SERVE_CLIENTS)[0], want,
                              f"[against-serve] {name}, warm window")
            order = []
            for r in range(AGAINST_SERVE_ROUNDS):
                order += ["this", "other"] if r % 2 else ["other", "this"]
            for name in order:
                m, writer, _svc, _httpd, url = sides[name]
                walls = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    got = bodies(m.match_many(main), main, writer)
                    walls.append(time.perf_counter() - t0)
                    check(got == want[:N_TRACES],
                          f"[against-serve] {name}: match_many bodies "
                          f"differ from the native CPU run")
                answers, _secs, wall = post_all(url, reqs, SERVE_CLIENTS)
                answers_match(answers, want, f"[against-serve] {name}")
                out[name]["match_many_s"].append(float(np.median(walls)))
                out[name]["requests_per_s"].append(len(reqs) / wall)
                log(f"[against-serve] {name} "
                    f"({path if name == 'other' else '.'}): match_many of "
                    f"{N_TRACES} traces {np.median(walls):.6f} s (median "
                    f"of 5); serving {len(reqs) / wall:.1f} requests/s "
                    f"({wall:.4f} s)")
        finally:
            for _m, _w, svc, httpd, _u in sides.values():
                httpd.shutdown()
                httpd.server_close()
                check(svc.dispatcher.close(), "an [against-serve] "
                                              "dispatcher did not stop")
    for what, unit in (("match_many_s", "s"), ("requests_per_s", "/s")):
        o, t = out["other"][what], out["this"][what]
        better = (lambda a, b: a > b) if unit == "s" else \
            (lambda a, b: a < b)
        wins = sum(better(a, b) for a, b in zip(o, t))
        log(f"[against-serve] {what}, {len(t)} turns each: {path} median "
            f"{np.median(o):.6f} (range {min(o):.6f}-{max(o):.6f}), this "
            f"median {np.median(t):.6f} (range {min(t):.6f}-{max(t):.6f}); "
            f"this better in {wins} of {len(t)} pairs")
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


def stacked_steps(N, Kc, R, seed):
    """``incremental_steps``' operands for R rounds of ``step_inputs``
    rows: (R, N, ...) dist, valid, route, gc and case, and round 0's
    carried scores."""
    rounds = [step_inputs(N, Kc, seed + 97 * r) for r in range(R)]
    return [np.stack([rd[k] for rd in rounds]) for k in range(5)] \
        + [rounds[0][5]]


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
    37 rows alone; then ``incremental_steps`` (R rounds in one launch,
    each row for its own number of rounds) against its plain version on
    the card and on the CPU at each (N, K, R) of ``STEP_ROUNDS``. Returns
    the scores' largest absolute difference."""
    import itertools
    import torch
    from reporter_tpu_torch.ops import (incremental_step_cuda,
                                        incremental_step_plain,
                                        incremental_steps_cuda,
                                        incremental_steps_plain)
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
    rng = np.random.default_rng(77)
    for N, Kc, R in STEP_ROUNDS:
        arrays = stacked_steps(N, Kc, R, 800 + N + Kc)
        n_steps = rng.integers(1, R + 1, N).astype(np.int32)
        n_steps[0] = R
        if N > 2:  # counts outside 0..R: read clamped, as the plain version
            n_steps[1:3] = (R + 7, -3)
        cpu = [torch.from_numpy(a) for a in arrays] \
            + [torch.from_numpy(n_steps)]
        x = [t.to(dev) for t in cpu]
        got = incremental_steps_cuda(*x[:6], x[6], sigma, beta)
        torch.cuda.synchronize()
        for where, want in (
                ("card", incremental_steps_plain(*x, sigma, beta)),
                ("CPU", incremental_steps_plain(*cpu, sigma, beta))):
            same, err = step_equal(got, want)
            check(same, f"incremental_steps differs from the plain version "
                        f"on the {where} at N,K,R={N},{Kc},{R}")
            worst = max(worst, err)
        del x, got
    torch.cuda.empty_cache()
    log(f"[verify-step] incremental_step bit-equal to the plain version on "
        f"the card and on the CPU at N {STEP_N} x K {STEP_K} (ties, NORMAL/"
        f"RESTART/SKIP rows, routes at 1e9 and +inf, invalid candidates, "
        f"+0.0 and -0.0 in the scores); 37 rows alone equal the same rows "
        f"of 512; R rounds in one launch, ragged step counts (and counts "
        f"past R and below 0, read clamped), the same at "
        f"(N, K, R) {STEP_ROUNDS}; largest |difference| {worst}")
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
    tables' blobs and counters equal, the rounds the CPU run's.
    ``incremental_step`` is counted from 0 over the run: one launch per
    call and parameter group that stepped (all its rounds). Returns
    (launches, rounds by group)."""
    from reporter_tpu_torch import ops
    from reporter_tpu_torch.matcher import SegmentMatcher
    city, params = served["city"], served["params"]
    reqs0 = [dict(r, match_options=OPTS_B if i % 4 == 3 else OPTS)
             for i, r in enumerate(served["reqs"][:N_TRACES])]
    gpu = SegmentMatcher(city, params, device=dev)
    cpu = SegmentMatcher(city, params, device="cpu")
    n_served = n_windows = calls_groups = 0
    walls = []
    ops.incremental_steps_cuda.launches = 0
    for hi in range(4, T_MAIN + 1, 4):
        reqs = [dict(r, trace=r["trace"][:hi]) for r in reqs0]
        before = dict(gpu.incremental_table.rounds)
        t0 = time.perf_counter()
        got = gpu.match_incremental(reqs)
        walls.append(time.perf_counter() - t0)
        # the groups that stepped in this call: one launch each
        calls_groups += sum(v > before.get(g, 0) for g, v in
                            gpu.incremental_table.rounds.items())
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
    launches = ops.incremental_steps_cuda.launches
    rounds = dict(gpu.incremental_table.rounds)
    check(rounds == cpu.incremental_table.rounds and len(rounds) == 2,
          f"rounds {rounds} on the card, {cpu.incremental_table.rounds} on "
          f"the CPU")
    check(launches == calls_groups < sum(rounds.values()),
          f"{launches} incremental_step launches for {calls_groups} calls "
          f"and groups ({rounds} rounds)")
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
        f"{launches}, one a call and group, for the rounds by (sigma, "
        f"beta, K) {rounds}; wall a call "
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


def ragged_windows(served):
    """The ragged call's windows: main's 512 uuids as first reports, every
    64th of 1,024 points (``long_streams``), the other odd ones of 64 and
    the even ones of 16, so one call's rounds run 16, 64 and about 1,000
    deep."""
    streams = long_streams(served["reqs"][:N_TRACES], N_TRACES, 1024)
    return [pts[:1024 if i % 64 == 0 else 64 if i % 2 else 16]
            for i, pts in enumerate(streams)]


def ragged_call(m, windows, tag, launches_of, traced=False):
    """One ``match_incremental`` of ``windows`` as first reports (uuids
    new to ``m``, named by ``tag``): (requests, matches, wall s, host peak
    bytes (tracemalloc, with ``traced``; else None), device peak bytes
    over what was allocated before, incremental-step launches)."""
    import torch
    import tracemalloc
    reqs = [{"uuid": f"{tag}-{i}", "trace": pts, "match_options": OPTS}
            for i, pts in enumerate(windows)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    n0 = launches_of()
    if traced:
        tracemalloc.start()
    t0 = time.perf_counter()
    got = m.match_incremental(reqs)
    wall = time.perf_counter() - t0
    host = None
    if traced:
        host = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
    torch.cuda.synchronize()
    return (reqs, got, wall, host, torch.cuda.max_memory_allocated() - base,
            launches_of() - n0)


def stream_ragged(dev, served):
    """The ragged call (``ragged_windows``) through ``match_incremental``
    on the card: every slot served or declined as a CPU run does, every
    served match byte-equal to the CPU run's and to the card's
    ``match_many``, blobs equal; then three more such calls, the last
    traced by tracemalloc. Prints the walls, the host and device peaks
    and the launches (slabs of at most ``SLAB_BYTES``). Returns them."""
    from reporter_tpu_torch import ops
    from reporter_tpu_torch.matcher import SegmentMatcher
    from reporter_tpu_torch.matcher.incremental import SLAB_BYTES
    windows = ragged_windows(served)
    city, params = served["city"], served["params"]
    gpu = SegmentMatcher(city, params, device=dev)
    cpu = SegmentMatcher(city, params, device="cpu")

    def launches_of():
        return ops.incremental_steps_cuda.launches

    reqs, got, wall, _h, dev_peak, launches = ragged_call(
        gpu, windows, "r0", launches_of)
    want = cpu.match_incremental(reqs)
    batch = gpu.match_many(reqs)
    check([g is None for g in got] == [w is None for w in want],
          "ragged call: the card serves other slots than the CPU")
    live = [i for i, g in enumerate(got) if g is not None]
    for i in live:
        check(match_json(got[i]) == match_json(want[i])
              == match_json(batch[i]),
              f"ragged call, {reqs[i]['uuid']}: the match differs")
    check(dict(gpu.incremental_table.to_blobs())
          == dict(cpu.incremental_table.to_blobs()),
          "ragged call: the card's blobs differ from the CPU run's")
    check(len(live) > len(reqs) // 2, f"ragged call: only {len(live)} of "
                                      f"{len(reqs)} served")
    walls = [wall]
    for r in (1, 2):
        walls.append(ragged_call(gpu, windows, f"r{r}", launches_of)[2])
    host_peak = ragged_call(gpu, windows, "r3", launches_of, traced=True)[3]
    out = {"uuids": len(windows), "points": sum(map(len, windows)),
           "served": len(live), "launches": launches,
           "slab_bytes": SLAB_BYTES, "wall_s": walls,
           "host_peak_bytes": host_peak, "device_peak_bytes": dev_peak}
    log(f"[stream] ragged call {json.dumps(out)}: first reports of 16, 64 "
        f"and 1,024 points in one call, each served match byte-equal to "
        f"the CPU run's and to match_many's, blobs equal")
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
    launches0 = ops.incremental_steps_cuda.launches
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
           "launches": ops.incremental_steps_cuda.launches - launches0}
    check(n_served > 0, f"T={T}, {n} uuids: nothing served")
    log(f"[stream] leg {json.dumps(out)} (ms as [p50, p99] a call)")
    return out


def phase_stream(dev, served):
    """The incremental streaming decode on the card: the parity leg, the
    fallback leg, the ragged call and the streaming legs
    (``STREAM_WINDOWS`` x 1 and 512 uuids). Returns (incremental_step
    launches of the parity leg, rounds, viterbi_decode launches of the
    fallback leg, the legs)."""
    t0 = time.perf_counter()
    launches, rounds = stream_parity(dev, served)
    fallback_launches = stream_fallback(dev, served)
    stream_ragged(dev, served)
    legs = [stream_leg(dev, served, T, n)
            for T in STREAM_WINDOWS for n in (1, N_TRACES)]
    log(f"[stream] {time.perf_counter() - t0:.1f} s")
    return launches, rounds, fallback_launches, legs


# -- the streaming worker ------------------------------------------------------
#: the [worker] phase's fleet on BIG_CITY: vehicles (one trip each, numpy
#: seed 11), the first legs' and then the smaller legs' count, their start
#: times spread evenly over WORKER_SPREAD_S seconds
WORKER_VEHICLES = 2048      # cut from 4,096 (PERF.md §4)
WORKER_SMALL = 512
WORKER_SPREAD_S = 600
WORKER_FORMAT = r",sv,\|,0,1,2,3,4"
#: the resume leg's child snapshots every this many messages
#: (``--state-every``) and is killed just after one (k a multiple of it)
WORKER_STATE_EVERY = 1024
#: a session gap no stream reaches: the worker then evicts sessions only
#: at the end of the stream, so tile boundaries do not depend on how
#: fast a leg runs on the wall clock (its eviction clock)
WORKER_GAP_MS = 10 ** 12
#: the options every leg runs with: tiles flushed only at the end of the
#: stream and report-ready sessions in batches of 64 (tools/chaos.py's
#: deterministic settings)
WORKER_ARGS = ("-p", "2", "-q", "3600", "-i", "1000000000", "-r", "0,1",
               "-x", "0,1", "-s", "smoke", "--report-flush-interval",
               "1000000000")


def write_worker_stream(path, n=WORKER_VEHICLES):
    """Write the [worker] stream: ``n`` vehicles on BIG_CITY, one trip
    each (``synth.generate_trace``, 4 m noise, a probe every 5 s, 6-60
    edges, numpy seed 11), vehicle i starting ``i * WORKER_SPREAD_S //
    n`` s after the first, every probe merged in time order (ties by
    uuid) as sv lines ``uuid|lat|lon|time|accuracy``. Runs in a child
    process started with the smoke run (``start_worker_stream``), so its
    ~100 s of Python route searches overlap the phases before
    [worker]."""
    from reporter_tpu_torch.synth import build_grid_city, generate_trace
    city = build_grid_city(**BIG_CITY)
    rng = np.random.default_rng(11)
    rows = []
    i = 0
    while i < n:
        uuid = f"veh-{i}"
        tr = generate_trace(city, uuid, rng, noise_m=4.0, sample_period_s=5.0,
                            start_time=1_500_000_000
                            + i * WORKER_SPREAD_S // n,
                            min_route_edges=6, max_route_edges=60)
        if tr is None:
            continue
        rows.extend((p["time"], uuid, p) for p in tr.points)
        i += 1
    rows.sort(key=lambda r: (r[0], r[1]))
    with open(path + ".tmp", "w") as f:
        f.writelines(f"{u}|{p['lat']}|{p['lon']}|{p['time']}|"
                     f"{p['accuracy']}\n" for _t, u, p in rows)
    os.replace(path + ".tmp", path)


def start_worker_stream(tmp):
    """Start ``write_worker_stream`` in a child process at the lowest CPU
    priority; returns (the Popen, the stream's path)."""
    import atexit
    path = os.path.join(tmp, "stream.txt")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import os, chip_smoke; os.nice(19); "
         f"chip_smoke.write_worker_stream({path!r})"], cwd=str(ROOT))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, path


def tile_tree(root):
    """{relative path: bytes} of the tile files under ``root`` (the
    dead-letter spool, a dot directory, left out)."""
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if not d.startswith(".")]
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


class SummaryLog:
    """Keeps the worker's ``summary`` log line (``main`` logs one at the
    end of a run)."""

    def __init__(self):
        import logging
        self.records = []
        handler = logging.Handler(logging.INFO)
        handler.emit = lambda rec: self.records.append(rec.getMessage())
        log_ = logging.getLogger("reporter_tpu_torch.streaming")
        log_.setLevel(logging.INFO)
        log_.addHandler(handler)
        # main()'s basicConfig finds a handler and leaves the root alone:
        # only warnings reach the console
        console = logging.StreamHandler()
        console.setLevel(logging.WARNING)
        logging.getLogger().addHandler(console)

    def last(self):
        lines = [m for m in self.records if m.startswith("summary ")]
        check(bool(lines), "the worker logged no summary")
        return json.loads(lines[-1][len("summary "):])


def worker_leg(name, stream, out, conf, dev, summaries, extra=()):
    """One leg through ``streaming.worker.main`` in this process: the
    kernels' and the plain versions' counts set to 0 just before and
    read just after, the metrics registry reset (per-leg counters and
    the ``batcher.flush`` timer). Checks the leg's health (parse
    failures, sheds, dead letters, at least one tile) and returns its
    numbers, its tile tree and its summary."""
    from reporter_tpu_torch import ops
    from reporter_tpu_torch.streaming import worker
    from reporter_tpu_torch.utils import faults, metrics, spool
    wrappers = dict(kernel_wrappers(),
                    incremental_step=ops.incremental_steps_cuda)
    for w in wrappers.values():
        w.launches = 0
    plain = {"viterbi_plain": ops.viterbi_plain,
             "incremental_steps_plain": ops.incremental_steps_plain}
    plain_calls = dict.fromkeys(plain, 0)

    def counted(key):
        def call(*args, **kw):
            plain_calls[key] += 1
            return plain[key](*args, **kw)
        return call

    for key in plain:
        setattr(ops, key, counted(key))  # ops' dispatchers read them here
    metrics.default.reset()
    conf_path = out + ".json"
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    with open(stream) as f:
        n_lines = sum(1 for _ in f)
    t0 = time.perf_counter()
    try:
        rc = worker.main(["-f", WORKER_FORMAT, *WORKER_ARGS, "-o", out,
                          "--input", stream, "--config", conf_path,
                          "--device", str(dev), *extra])
    finally:
        for key, fn in plain.items():
            setattr(ops, key, fn)
        fired = faults.fired_counts()
        faults.clear()
    wall = time.perf_counter() - t0
    check(rc == 0, f"[worker] {name}: main returned {rc}")
    s = summaries.last()
    snap = metrics.snapshot()
    ctr = snap["counters"]
    flush = snap["timers"].get("batcher.flush", {})
    tree = tile_tree(out)
    dead = spool.backlog(os.path.join(out, ".deadletter"))
    check(s["processed"] == n_lines and s["parse_failures"] == 0,
          f"[worker] {name}: {s['processed']} of {n_lines} messages "
          f"processed, {s['parse_failures']} parse failures")
    check(ctr.get("backpressure.shed", 0) == 0,
          f"[worker] {name}: backpressure shed sessions")
    check(dead["files"] == 0 and not any(
        ctr.get(c, 0) for c in ("batch.deadletter", "batch.dropped",
                                "egress.fail", "egress.deadletter")),
          f"[worker] {name}: dead-lettered {dead} ({ctr})")
    check(tree and s["tiles"] == len(tree), f"[worker] {name}: "
          f"{len(tree)} tiles on disk, {s['tiles']} written")
    inc = {k.split("match.incremental.")[1]: v for k, v in ctr.items()
           if k.startswith("match.incremental.")}
    launches = {k: w.launches for k, w in wrappers.items()}
    row = {"leg": name, "device": str(dev), "messages": s["processed"],
           "reports": s["reports"], "flushes": s["flushes"],
           "tiles": len(tree), "kept": s["kept"], "culled": s["culled"],
           "launches": launches, "plain_calls": plain_calls,
           "incremental": inc, "gauge": s["incremental"],
           "faults_fired": fired,
           "wall_s": round(wall, 3),
           "msgs_per_s": round(s["processed"] / wall, 1),
           "reports_per_s": round(s["reports"] / wall, 1),
           "flush_ms": [round(flush.get("p50_s", 0.0) * 1e3, 3),
                        round(flush.get("p99_s", 0.0) * 1e3, 3)]}
    return row, tree, s


def worker_leg_checks(row, card):
    """No fallback between the card and the CPU: a card leg calls no
    plain version, a CPU leg launches no kernel."""
    if card:
        check(not any(row["plain_calls"].values()),
              f"[worker] {row['leg']}: the card leg ran a plain version "
              f"{row['plain_calls']}")
    else:
        check(not any(row["launches"].values()),
              f"[worker] {row['leg']}: the CPU leg launched {row['launches']}")


def phase_worker(dev, big, stream_proc, stream, smi):
    """The streaming worker (``reporter_tpu_torch.streaming.worker.main``)
    on the card, from raw probe lines to tile files, on BIG_CITY's fleet
    (``write_worker_stream``), in five legs:

    1. incremental  the full stream, defaults: report-ready sessions
       through ``report_incremental`` (``incremental_step`` launched); its
       tile tree is the reference;
    2. batch        the full stream with ``"incremental": false``: every
       report through ``report_many`` (``viterbi_decode``, no
       ``incremental_step``); tiles byte-equal to leg 1's;
    3. commit-error the first WORKER_SMALL vehicles with
       ``match.incremental.commit=error#1`` armed (and
       ``incremental_lag`` 16, so that traces commit): the fault fires
       and the tiles equal a fault-free card run of the same vehicles
       (at the default lag);
    4. resume       the same vehicles in a child process snapshotting
       every WORKER_STATE_EVERY messages (``--state-every``) and killed
       by ``worker.offer=crash+k#1`` (k two thirds of the messages, a
       multiple of it): exit 137, a snapshot carrying decode frames; a new
       worker restores it and reads the rest; tiles equal the fault-free
       run's;
    5. cpu          the same vehicles with ``--device cpu``: tiles equal
       the card's.

    Every leg: no parse failure, no shed, nothing dead-lettered, at least
    one tile; a card leg calls no plain version, the CPU leg launches no
    kernel. Prints one JSON line a leg, then the phase's seconds beside
    ``smi`` (the card's name and power limit), and returns {kernel: {leg:
    launches}}."""
    import tempfile
    import torch
    from reporter_tpu_torch.streaming.anonymiser import Anonymiser, TileSink
    from reporter_tpu_torch.streaming.batcher import PointBatcher
    from reporter_tpu_torch.streaming.state import restore_bytes
    t_phase = time.perf_counter()
    summaries = SummaryLog()
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    graph = os.path.join(tmp, "city.npz")
    big["city"].save(graph)
    check(stream_proc.wait() == 0, "the worker stream's writer failed")
    log(f"[worker] stream ready {time.perf_counter() - t_phase:.1f} s "
        f"after the phase began")
    with open(stream) as f:
        lines = f.readlines()
    small_ids = {f"veh-{i}" for i in range(WORKER_SMALL)}
    small = [ln for ln in lines if ln.split("|", 1)[0] in small_ids]
    k = len(small) * 2 // 3 // WORKER_STATE_EVERY * WORKER_STATE_EVERY
    paths = {}
    for name, part in (("small", small), ("tail", small[k:])):
        paths[name] = os.path.join(tmp, f"{name}.txt")
        with open(paths[name], "w") as f:
            f.writelines(part)
    log(f"[worker] {WORKER_VEHICLES} vehicles, {len(lines)} messages; "
        f"the first {WORKER_SMALL}: {len(small)} messages, killed after "
        f"{k}")
    worker_conf = {"session_gap_ms": WORKER_GAP_MS}

    def conf(**service):
        return {"graph": graph, "service": service, "worker": worker_conf}

    rows, launches = [], {}

    def leg(name, stream_path, c, device=dev, extra=()):
        row, tree, s = worker_leg(name, stream_path,
                                  os.path.join(tmp, name), c, device,
                                  summaries, extra)
        worker_leg_checks(row, device.type == "cuda")
        for kname, n in row["launches"].items():
            launches.setdefault(kname, {})[name] = n
        rows.append(row)
        log(f"[worker] leg {json.dumps(row)}")
        return row, tree, s

    row, ref, _s = leg("incremental", stream, conf())
    check(row["launches"]["incremental_step"] >= 1,
          "[worker] incremental: incremental_step never launched")
    row, tree, _s = leg("batch", stream, conf(incremental=False))
    check(tree == ref, "[worker] batch: tiles differ from the incremental "
                       "leg's")
    check(row["launches"]["incremental_step"] == 0
          and row["launches"]["viterbi_decode"] >= 1,
          f"[worker] batch: launches {row['launches']}")
    _row, small_ref, _s = leg("small", paths["small"], conf())
    # lag 16, as tools/chaos.py's commit leg: at the default 32 this
    # stream's reports come too often for a carried trace to commit
    row, tree, _s = leg("commit-error", paths["small"],
                        conf(faults="match.incremental.commit=error#1",
                             incremental_lag=16))
    check(row["faults_fired"] == {"match.incremental.commit": 1}
          and row["incremental"].get("errors", 0) >= 1,
          f"[worker] commit-error: the fault did not fire "
          f"({row['faults_fired']}, {row['incremental']})")
    check(tree == small_ref, "[worker] commit-error: tiles differ from the "
                             "fault-free run's")
    # resume: a child process killed after message k, then a worker here
    # restoring its snapshot and reading the rest of the stream
    state = os.path.join(tmp, "resume.state")
    out = os.path.join(tmp, "resume")
    crash_conf = out + "-crash.json"
    with open(crash_conf, "w") as f:
        json.dump(conf(faults=f"worker.offer=crash+{k}#1"), f)
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "reporter_tpu_torch.streaming.worker",
         "-f", WORKER_FORMAT, *WORKER_ARGS, "-o", out, "--input",
         paths["small"], "--config", crash_conf, "--device", str(dev),
         "--state-file", state, "--state-every", str(WORKER_STATE_EVERY)],
        cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    check(p.returncode == 137, f"[worker] resume: the child exited "
                               f"{p.returncode}: {p.stderr[-2000:]}")
    with open(state, "rb") as f:
        frames = restore_bytes(
            f.read(), PointBatcher(lambda t: None, lambda k_, s: None),
            Anonymiser(TileSink(os.path.join(tmp, "scratch")), 1, 3600))
    check(len(frames) > 0, "[worker] resume: the snapshot carries no "
                           "decode frames")
    row, tree, s = leg("resume", paths["tail"], conf(),
                       extra=("--state-file", state))
    check(s["restored"] and tree == small_ref,
          f"[worker] resume: restored {s['restored']}; tiles differ from "
          f"the fault-free run's")
    row["child_s"] = round(child_s, 3)
    row["frames"] = len(frames)
    log(f"[worker] resume: the child exited 137 after {k} messages in "
        f"{child_s:.1f} s, its snapshot {len(frames)} decode frames; "
        f"restored and read the other {len(small) - k}")
    _row, tree, _s = leg("cpu", paths["small"], conf(),
                         device=torch.device("cpu"))
    check(tree == small_ref, "[worker] cpu: tiles differ from the card's")
    tmp_dir.cleanup()
    log(f"[worker] {time.perf_counter() - t_phase:.1f} s on {smi}; every "
        f"leg's tiles byte-equal to its reference")
    return launches


def step_bound_ms(N, Kc, R=1):
    """The least time of R rounds of N rows: each input read once (dist,
    valid, route, gc, case a round; the carried scores and step counts
    once) and each output written once (scores, bp, prev_best a round) at
    the card's memory rate, against about 6 f32 ops per (round, row, i,
    j) and 4 per (round, row, j) at its f32 rate."""
    n_bytes = R * N * (Kc * 4 + Kc + Kc * Kc * 4 + 4 + 4) \
        + N * (Kc * 4 + 4) + R * N * (Kc * 8 + 4)
    n_ops = R * (N * Kc * Kc * 6 + N * Kc * 4)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", n_bytes)


#: (N, R) the timing phase times the step at, K=8: one row and 512 rows a
#: round, and 512 rows for 4 rounds in one launch
STEP_TIMED = ((1, 1), (N_TRACES, 1), (N_TRACES, 4))


def phase_timing_step(dev):
    """incremental_step by CUDA graphs (100 launches a graph) at each (N,
    R) of ``STEP_TIMED``, K=8, every row stepping every round, beside its
    bound and the plain version's time on the card. Returns {(N, R): (ms,
    plain ms, bound ms, bound by)}."""
    import torch
    from reporter_tpu_torch.ops import incremental
    sigma, beta = np.float32(4.07), np.float32(3.0)
    out = {}
    for N, R in STEP_TIMED:
        arrays = stacked_steps(N, K, R, 900 + N + R)
        x = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        n_steps = torch.full((N,), R, dtype=torch.int32, device=dev)
        buf = torch.empty(incremental.output_words(N, K, R),
                          dtype=torch.int32, device=dev)
        ms = graph_ms(lambda: incremental.launch(x, n_steps, sigma, beta,
                                                 buf), 100)
        plain = time_ms(lambda: incremental.incremental_steps_plain(
            *x, n_steps, sigma, beta), 20)
        bms, by, n_bytes = step_bound_ms(N, K, R)
        out[N, R] = (ms, plain, bms, by)
        log(f"[timing] incremental_step N,K={N},{K}, {R} round(s) in one "
            f"launch: {ms:.5f} ms (CUDA graphs), plain {plain:.4f} ms, bound "
            f"{bms:.6f} ms by {by} ({n_bytes} bytes)")
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
                    help="time this kernel, device-route prep and the "
                         "front door against the checkout at DIR; nothing "
                         "else runs")
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

    if not args.against:
        # the [worker] phase's stream, written while the phases before
        # it run
        import tempfile
        stream_dir = tempfile.TemporaryDirectory()
        stream_proc, stream = start_worker_stream(stream_dir.name)
    spills = phase_build()
    if args.against:
        against = phase_against(dev, args.against)
        step = phase_against_step(dev, args.against)
        ragged = phase_against_stream(dev, args.against)
        kernels = phase_against_route_kernels(dev, args.against)
        routes = phase_against_routes(args.against)
        serving = phase_against_serve(dev, args.against)
        check(not spills, f"ptxas reports spills: {spills}")
        return finish(smi, {"against": args.against, "ms": against,
                            "step_ms": step, "ragged_call": ragged,
                            "route_kernels_ms": kernels,
                            "routes_s": routes, "serve": serving})
    phase_verify(dev)
    step_err = phase_verify_step(dev)
    launches, main, max_err, scalars, served = phase_main(dev)
    big = grid_inputs(BIG_CITY, N_TRACES, 11)
    huge = grid_inputs(HUGE_CITY, 64, 17)
    past = grid_inputs(PAST_CITY, PAST_TRACES, 19)
    verified = phase_verify_routes(dev, served, big, huge, past)
    route_launches, _runs = phase_routes(dev, served)
    step_launches, _rounds, fallback_launches, _legs = phase_stream(
        dev, served)
    serving = phase_serve(dev, served)
    obs = phase_obs(dev, served, smi[0] if smi else "nvidia-smi: no output")
    fault_launches = phase_faults(dev, served)
    phase_prefork(served)
    phase_city(big)
    city_launches, _city_runs = phase_route_city(big, huge, past)
    worker_launches = phase_worker(dev, big, stream_proc, stream,
                                   smi[0] if smi else "nvidia-smi: no output")
    stream_dir.cleanup()
    floor = launch_floor_ms(dev)
    times = phase_timing(dev, main, scalars, max_sm_mhz())
    route_times = phase_timing_routes(dev, served, big, huge, past)
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
        # the obs phase's parity window (phase_obs): every chunk shadowed
        # by the plain scan on the CPU, every eighth request traced
        "launches_obs": obs["launches"],
        # the faults phase (phase_faults): each leg's launches, equal to
        # the chunks it dispatched (the card domains' legs: the probe's)
        "launches_faults": fault_launches["viterbi_decode"],
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
            # the 125x125 city with route_device=True (phase_route_city),
            # cold and the first warm round: one launch a relaxation
            ("relax_cluster", "reporter_tpu/ops/route_relax.py:61",
             verified["cluster_err"], city_launches["relax_cluster"]),
            # the 341x341 city with route_device=True (phase_route_city):
            # one launch a sweep; "ms" is a sweep's at its first chunk
            ("relax_sweep", "reporter_tpu/ops/route_relax.py:61",
             verified["sweep_err"], city_launches["relax_sweep"]),
            ("pair_costs", "reporter_tpu/ops/route_relax.py:120",
             verified["pair_err"], route_launches["pair_costs"])):
        r_ms, r_plain, r_bound, r_by = route_times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": r_ms, "plain_ms": r_plain, "bound_ms": r_bound,
            "bound_by": r_by, "library_ms": None,
            # the faults phase's route.device leg (the probe)
            "launches_faults": fault_launches[name]})
        if name == "relax_sweep":
            # a sweep at the 125x125 city's first chunk, the shape the
            # kernel served before relax_cluster took that city
            (kernels[-1]["ms_125x125"], kernels[-1]["plain_ms_125x125"],
             kernels[-1]["bound_ms_125x125"], _by) = \
                route_times["relax_sweep 125x125"]
    ms, plain, bms, by = step_times[N_TRACES, 1]
    kernels.append({
        "name": "incremental_step", "route": "cuda",
        "source": "reporter_tpu_torch/ops/csrc/viterbi.cu",
        "replaces": "reporter_tpu/ops/incremental.py:50",
        # match_incremental's parity leg (phase_stream): one a call and
        # parameter group, all its rounds
        "launches": step_launches, "max_abs_err": step_err,
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": None,
        # the faults phase's match.incremental.commit leg
        "launches_faults": fault_launches["incremental_step"],
        # one row, the one-uuid stream's step
        "ms_1_8": step_times[1, 1][0], "bound_ms_1_8": step_times[1, 1][2],
        # 512 rows, 4 rounds in one launch
        "ms_512_8_r4": step_times[N_TRACES, 4][0],
        "plain_ms_512_8_r4": step_times[N_TRACES, 4][1],
        "bound_ms_512_8_r4": step_times[N_TRACES, 4][2]})
    for k in kernels:
        # an empty kernel's launch by CUDA graphs, as "ms" is timed
        k["launch_floor_ms"] = floor
        # the worker phase's legs (phase_worker), each counted from 0
        k["launches_worker"] = worker_launches[k["name"]]
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
