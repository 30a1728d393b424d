#!/usr/bin/env python3
"""Smoke run of reporter_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build    compile ops/csrc/viterbi.cu with nvcc for sm_90a and load it
2. verify   the kernel against its plain PyTorch version on the card at
            the main path's shapes and edge cases, f16 and f32 wire:
            paths exactly equal, scores within rtol 1e-5
3. main     the /report path: SegmentMatcher.match_many + report() on
            the 20x20 synthetic city, 512 traces of the T=64 bucket and a
            mixed T=16/64/256 batch, on the card; every body byte-equal
            to the port's own CPU run, every path equal, and the kernel's
            launch count read around this phase alone
4. timing   CUDA-event times of the kernel and the plain version at the
            main path's shapes, beside the least time the card could take

Prints the card's name and power limit, one JSON line describing the
kernel, and as the last line {"ok": true, "device": {...}}. Exits non-zero,
printing no result, without a CUDA card or without the package beside it.
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
RTOL = 1e-5
# dependent latencies in SM cycles (Hopper microbenchmarks), for the chain
# model only: a shared-memory load, an f32 add/compare/select, an L2 hit
SMEM_CYCLES, ALU_CYCLES, L2_CYCLES = 30, 4, 260

N_TRACES = 512              # the service's decode batch
T_MAIN = 64
K = 8                       # MatchParams.max_candidates default
CITY = dict(rows=20, cols=20, spacing_m=200.0, seed=42)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


# -- inputs ------------------------------------------------------------------
def random_inputs(B, T, K, seed, ties=False):
    """Decode inputs with restarts, SKIP tails and unreachable routes; with
    ``ties``, odd candidates duplicate even ones exactly."""
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
    if ties:
        dist[:, :, 1::2] = dist[:, :, 0::2]
        valid[:, :, 1::2] = valid[:, :, 0::2]
        route[:, :, 1::2, :] = route[:, :, 0::2, :]
        route[:, :, :, 1::2] = route[:, :, :, 0::2]
    return dist, valid, route, gc, case


def to_device(arrays, f16, dev):
    import torch
    dist, valid, route, gc, case = arrays
    if f16:
        with np.errstate(over="ignore"):  # unreachable overflows to +inf
            dist, route, gc = (a.astype(np.float16) for a in (dist, route, gc))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (dist, valid, route, gc, case))


def wire_bytes(tensors, T):
    """Bytes the decode must move: each input read once, paths (B, T) i32
    and scores (B,) f32 written once."""
    B = tensors[0].shape[0]
    return sum(t.numel() * t.element_size() for t in tensors) + B * T * 4 + B * 4


def wire_ops(B, T, K):
    """f32 operations of the decode: per (t, i, j) a subtract, abs,
    divide, reachability compare, add and max compare; per (t, j) a
    divide, two multiplies and an add."""
    return B * (T - 1) * K * K * 6 + B * T * K * 4


def bound_ms(tensors, T, K):
    """The least time for the decode's bytes and operations on the card:
    a floor that ignores the serial chain (see ``chain_cycles``)."""
    B = tensors[0].shape[0]
    t_bytes = wire_bytes(tensors, T) / HBM_BYTES_PER_S
    t_ops = wire_ops(B, T, K) / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def chain_cycles(T, K):
    """A model of one trace's dependence chain in SM cycles, from
    microbenchmarked Hopper latencies: per step, the shared-memory round
    trip of the previous scores, the add of the transition, K dependent
    compare-selects of the running max, and the add of the emission;
    then T-1 dependent backpointer loads served by L2."""
    step = SMEM_CYCLES + ALU_CYCLES + K * 2 * ALU_CYCLES + ALU_CYCLES
    return (T - 1) * (step + L2_CYCLES)


# -- phases --------------------------------------------------------------------
def phase_build():
    from reporter_tpu_torch.ops import viterbi
    t0 = time.perf_counter()
    _fn, build_log = viterbi.build()
    secs = time.perf_counter() - t0
    log(f"[build] {viterbi.SOURCE.relative_to(ROOT)} -> sm_90a in {secs:.2f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def phase_verify(dev):
    """Kernel vs plain on the card, same inputs."""
    import torch
    from reporter_tpu_torch.ops import viterbi_cuda, viterbi_plain
    cases = [((N_TRACES, T_MAIN, K), False), ((64, 1024, K), False),
             ((37, 16, K), False), ((16, 64, 40), False),
             ((64, T_MAIN, K), True)]
    sigma, beta = np.float32(4.07), np.float32(3.0)
    for seed, ((B, T, Kc), ties) in enumerate(cases):
        arrays = random_inputs(B, T, Kc, seed, ties=ties)
        for f16 in (True, False):
            x = to_device(arrays, f16, dev)
            k_paths, k_scores = viterbi_cuda(*x, sigma, beta)
            torch.cuda.synchronize()
            p_paths, p_scores = viterbi_plain(*x, sigma, beta)
            torch.cuda.synchronize()
            check(torch.equal(k_paths, p_paths),
                  f"paths differ at {(B, T, Kc)} f16={f16} ties={ties}: "
                  f"{int((k_paths != p_paths).sum())} entries")
            check(torch.allclose(k_scores, p_scores, rtol=RTOL, atol=0.0),
                  f"scores beyond rtol {RTOL} at {(B, T, Kc)} f16={f16}")
            not_bit_equal = int((k_scores.view(torch.int32)
                                 != p_scores.view(torch.int32)).sum())
            err = float((k_scores - p_scores).abs().max())
            if ties:
                check(bool((k_paths % 2 == 0).all()),
                      "exact ties did not break to the lowest index")
            log(f"[verify] B,T,K={B},{T},{Kc} {'f16' if f16 else 'f32'}"
                f"{' ties' if ties else ''}: paths equal, scores not "
                f"bit-equal {not_bit_equal}/{B}, max abs err {err:g}")


def make_requests(matcher, rng, n, lengths, min_edges):
    """``n`` synthetic /report requests, traces cut to the given lengths
    in turn; each kept only if its kept points land in the bucket of its
    length (drawn in bulk, prepared in bulk)."""
    from reporter_tpu_torch.matcher.batchpad import bucket_length
    from reporter_tpu_torch.synth import generate_trace
    opts = {"mode": "auto", "report_levels": [0, 1, 2],
            "transition_levels": [0, 1, 2]}
    out, tries = [], 0
    while len(out) < n:
        tries += 1
        check(tries < 50, "could not draw enough traces")
        cand = []
        while len(cand) < 2 * (n - len(out)):
            L = lengths[(len(out) + len(cand)) % len(lengths)]
            tr = generate_trace(matcher.net, f"veh-{len(out) + len(cand)}",
                                rng, noise_m=4.0, min_route_edges=min_edges,
                                max_route_edges=60)
            if tr is None or len(tr.points) < L:
                continue
            cand.append({"uuid": tr.uuid, "trace": tr.points[:L],
                         "match_options": opts})
        for req, p in zip(cand, matcher.prepare_many(cand)):
            if len(out) < n and p.T == bucket_length(len(req["trace"])):
                req["uuid"] = f"veh-{len(out)}"
                out.append(req)
    return out


def bodies(matches, reqs):
    from reporter_tpu_torch.service.report import report_json
    return [report_json(json.loads(json.dumps(m)), r, 15, {0, 1, 2},
                        {0, 1, 2}) for m, r in zip(matches, reqs)]


def phase_main(dev):
    import torch
    from reporter_tpu_torch import ops
    from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
    from reporter_tpu_torch.matcher.batchpad import pack_batches
    from reporter_tpu_torch.synth import build_grid_city

    t0 = time.perf_counter()
    city = build_grid_city(**CITY)
    params = MatchParams(max_candidates=K)
    gpu = SegmentMatcher(city, params)          # the card, by default
    check(gpu.device.type == "cuda", f"default device is {gpu.device}")
    cpu = SegmentMatcher(city, params, device="cpu")
    rng = np.random.default_rng(7)
    main = make_requests(gpu, rng, N_TRACES, [T_MAIN], max(4, T_MAIN // 12))
    mixed = make_requests(gpu, rng, 96, [12, 48, 200], 21)
    log(f"[main] city {city.num_nodes} nodes / {city.num_edges} edges, "
        f"{len(main)} T={T_MAIN} + {len(mixed)} mixed requests in "
        f"{time.perf_counter() - t0:.2f} s")

    # one call to warm the host route cache, then the counted, timed run
    gpu.match_many(main)
    for k in gpu.stage_seconds:
        gpu.stage_seconds[k] = 0.0
    ops.viterbi_cuda.launches = 0
    t0 = time.perf_counter()
    got_main = gpu.match_many(main)
    body_main = bodies(got_main, main)
    wall_main = time.perf_counter() - t0
    launches_main = ops.viterbi_cuda.launches
    stages = {k: round(v, 4) for k, v in gpu.stage_seconds.items()}
    got_mixed = gpu.match_many(mixed)
    body_mixed = bodies(got_mixed, mixed)
    launches = ops.viterbi_cuda.launches
    check(launches_main >= 1, "match_many on cuda never launched the kernel")
    check(launches - launches_main == 3,
          f"mixed batch took {launches - launches_main} launches, want 3")
    log(f"[main] {N_TRACES} traces: {N_TRACES / wall_main:.1f} traces/s "
        f"({wall_main:.3f} s wall, warm route cache), stages {stages}, "
        f"kernel launches {launches_main}; mixed batch launches "
        f"{launches - launches_main}")

    check(body_main == bodies(cpu.match_many(main), main),
          "/report bodies differ from the port's CPU run (T=64 batch)")
    check(body_mixed == bodies(cpu.match_many(mixed), mixed),
          "/report bodies differ from the port's CPU run (mixed batch)")
    n_seg = sum(len(m["segments"]) for m in got_main)
    check(n_seg > N_TRACES, f"only {n_seg} segments matched")

    # the main path's own batches through the kernel and the plain version
    # on the card: paths equal to each other and to the CPU run, scores
    # within rtol
    sigma, beta = np.float32(params.effective_sigma), np.float32(params.beta)
    buckets = set()
    main_x, main_err = None, None
    for reqs in (main, mixed):
        for batch in pack_batches(cpu.prepare_many(reqs)):
            shape = batch.case.shape
            buckets.add(shape[1])
            x = tuple(torch.from_numpy(a).to(dev) for a in
                      (batch.dist_m, batch.valid, batch.route_m, batch.gc_m,
                       batch.case))
            k_paths, k_scores = ops.viterbi_cuda(*x, sigma, beta)
            torch.cuda.synchronize()
            p_paths, p_scores = ops.viterbi_plain(*x, sigma, beta)
            torch.cuda.synchronize()
            check(torch.equal(k_paths, p_paths),
                  f"paths differ from the plain version, batch {shape}")
            check(np.array_equal(k_paths.cpu().numpy(),
                                 cpu.decode(batch, sigma, beta)),
                  f"paths differ from the CPU run, batch {shape}")
            check(torch.allclose(k_scores, p_scores, rtol=RTOL, atol=0.0),
                  f"scores beyond rtol {RTOL}, batch {shape}")
            err = float((k_scores - p_scores).abs().max())
            log(f"[main] batch {shape} {batch.dist_m.dtype}: paths equal, "
                f"max abs score err {err:g}")
            if shape == (N_TRACES, T_MAIN):
                main_x, main_err = x, err
    check(buckets == {16, 64, 256}, f"buckets {sorted(buckets)}")
    check(main_x is not None and main_x[0].dtype == torch.float16,
          "no (512, 64) f16 batch on the main path")
    log(f"[main] /report bodies byte-equal to the CPU run for all "
        f"{len(main) + len(mixed)} traces, paths equal in buckets "
        f"{sorted(buckets)}, {n_seg} segments")
    return launches, main_x, main_err, (sigma, beta)


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


def phase_timing(dev, main_x, scalars, sm_mhz):
    """Kernel time from back-to-back launches into buffers allocated
    once (no per-call wrapper work between them); the inputs stay in
    the 50 MB L2 across launches, as they do right after the matcher's
    host-to-device copy. The same launch on the batch's first trace
    alone measures the dependence chain: one warp, nothing to overlap."""
    import torch
    from reporter_tpu_torch.ops import viterbi, viterbi_plain
    sigma, beta = scalars
    long_x = to_device(random_inputs(64, 1024, K, 99), True, dev)
    out = {}
    for name, x in (("main", main_x), ("long", long_x)):
        B, T, Kx = x[0].shape
        kernel_ms = {}
        for rows in (B, 1):
            xs = tuple(t[:rows] for t in x)
            bufs = (torch.empty((rows, T), dtype=torch.int32, device=dev),
                    torch.empty((rows,), dtype=torch.float32, device=dev),
                    torch.empty((rows, T - 1, Kx), dtype=torch.int32,
                                device=dev))
            kernel_ms[rows] = time_ms(
                lambda: viterbi.launch(xs, sigma, beta, bufs), 200)
        ms = kernel_ms[B]
        plain = time_ms(lambda: viterbi_plain(*x, sigma, beta), 3)
        bms, by = bound_ms(x, T, Kx)
        cyc = chain_cycles(T, Kx)
        log(f"[timing] B,T,K={B},{T},{Kx} f16 wire: kernel {ms:.4f} ms, "
            f"one trace {kernel_ms[1]:.4f} ms, plain {plain:.3f} ms, "
            f"bound {bms:.5f} ms by {by} ({wire_bytes(x, T)} bytes, "
            f"{wire_ops(B, T, Kx)} f32 ops), chain model {cyc} cycles = "
            f"{cyc / (sm_mhz * 1e3):.4f} ms at {sm_mhz} MHz")
        out[name] = (ms, plain, bms, by)
    log("[timing] library: no single PyTorch call computes a Viterbi decode")
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

    phase_build()
    phase_verify(dev)
    launches, main_x, max_err, scalars = phase_main(dev)
    times = phase_timing(dev, main_x, scalars, max_sm_mhz())

    ms, plain, bms, by = times["main"]
    kernels = [{
        "name": "viterbi_decode",
        "route": "cuda",
        "source": "reporter_tpu_torch/ops/csrc/viterbi.cu",
        "replaces": "reporter_tpu/ops/pallas_viterbi.py:77",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": None,
    }]
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
