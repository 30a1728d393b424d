"""Run one cell of the benchmark once.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It loads, warms up, measures whole units of
work for ``--seconds``, checks the window's outputs against the plain
reference, and prints one JSON line as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and ``checks`` (each compared number beside
its limit); with ``--trace 1`` also ``breakdown``. The same checks are
the last lines of standard error.

It exits non-zero and prints no result without CUDA or with fewer cards
than the cell asks for, when the program is not beside it, or when a
module of the JAX stack or the JAX package is loaded once the window has
closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    __package__ = "portbench"

from portbench.lib import bench  # noqa: E402

#: fixed cache directories inside the checkout, so that only the first
#: run of a checkout compiles (the program builds its own kernels into
#: ``reporter_tpu_torch/_build``)
CACHE = os.path.join(bench.HERE, ".cache")


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int) -> int:
    sys.stderr.write(f"portbench: {msg}\n")
    return code


def execute(bench_json: dict, workload: str, seed: int, seconds: float,
            trace: bool, chips: int = 1, device: str = "cuda",
            overrides: dict | None = None):
    """One run of ``workload`` on ``device``: (the result line as a dict,
    the check lines for standard error). ``overrides`` goes to
    :class:`~.lib.bench.Env`, for the harness's own tests."""
    home = os.getcwd()
    rundir = tempfile.mkdtemp(prefix="portbench-run-")
    try:
        env = bench.Env(workload, seed, seconds, trace, T_START, rundir,
                        device, overrides)
        entry = bench.load_module("entries", env.cell["entry"])
        os.chdir(rundir)  # match_traces writes its row directories in .
        out = entry.run(env)
    finally:
        os.chdir(home)
        shutil.rmtree(rundir, ignore_errors=True)

    e2e = bench.cell_metrics(bench_json, workload, "end_to_end")
    if trace:
        metrics = bench.per_layer(bench_json, workload, out.obs)
    else:
        values = dict(out.e2e, setup_s=out.setup_s)
        missing = [m["name"] for m in e2e if m["name"] not in values]
        if missing and device == "cuda":
            raise RuntimeError(f"the run read no {', '.join(missing)}")
        # off the card (the harness's own tests) a device metric is absent
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in e2e if m["name"] in values}
    device_row = {"platform": "gpu" if device == "cuda" else device,
                  "kind": device_kind(device), "count": chips,
                  "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": all(v <= lim for _n, v, lim in out.checks),
              "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_row}
    if trace and out.obs.device is not None:
        device_row["busy_s"] = out.obs.device.busy_s
        device_row["window_s"] = out.obs.device.window_s
        result["breakdown"] = bench.breakdown(out.obs.device)
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in out.checks}
    lines = [f"check {n} {v!r} limit {lim!r} "
             f"{'ok' if v <= lim else 'FAILED'}\n" for n, v, lim in out.checks]
    return result, lines


def written() -> int:
    """Bytes this process has handed to ``write`` (``wchar``: files,
    pipes and sockets alike)."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return -1


def device_kind(device: str) -> str:
    if device != "cuda":
        return device
    import torch
    return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
    # a library the port loads must not bring the JAX stack in with it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    try:
        bench_json = bench.benchmark()
        bench.load_json("cells", args.workload)
    except FileNotFoundError as e:
        return fail(f"no such benchmark file: {e.filename}", 2)
    chips = [w["chips"] for w in bench_json["workloads"]
             if w["name"] == args.workload]
    if not chips:
        return fail(f"{args.workload} is no workload of BENCHMARK.json", 2)
    chips = int(chips[0])
    import torch
    if not torch.cuda.is_available():
        return fail("CUDA is not available", 3)
    if torch.cuda.device_count() < chips:
        return fail(f"{torch.cuda.device_count()} cards, the cell needs "
                    f"{chips}", 3)
    try:
        import reporter_tpu_torch  # noqa: F401
    except ImportError as e:
        return fail(f"the program is not beside the benchmark: {e}", 4)

    result, lines = execute(bench_json, args.workload, args.seed,
                            args.seconds, bool(args.trace), chips)
    found = bench.forbidden_modules()
    if found:
        return fail("modules of the JAX stack or the JAX package are "
                    f"loaded: {', '.join(found)}", 5)
    sys.stderr.write(f"portbench: this process wrote {written()} bytes\n")
    sys.stderr.write("".join(lines))
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
