"""The harness's core: finding a cell's files by name, the timed window,
the per-layer readers, the checks and the result line.

A cell ``portbench/cells/<cell>.json`` names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``) and
its entry (``entries/<entry>.py``, whose ``run(env)`` returns an
:class:`Outcome`). A per-layer metric ``<name>`` is read by
``metrics/<name>.py``'s ``read(obs)``, which returns a number or None.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
#: top-level module names that no run may hold: the JAX stack and the
#: JAX package the port was made from (compared whole: the port's own
#: name begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "reporter_tpu")


def load_json(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json``."""
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def with_overrides(kind: str, name: str, over: dict) -> dict:
    """``portbench/<kind>/<name>.json`` (empty where there is no such
    file) with ``over``'s keys put over it; a dict merges into the
    file's dict of that key."""
    path = os.path.join(HERE, kind, name + ".json")
    out = load_json(kind, name) if os.path.exists(path) else {}
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            value = dict(out[key], **value)
        out[key] = value
    return out


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = f"portbench.{kind}"
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


@dataclass
class Obs:
    """What a ``--trace 1`` run saw, for the per-layer readers: the window
    (``window_s``), the work done in it (``work``: probes or requests),
    the program's counter deltas and timer snapshot, its matcher's stage
    seconds, the harness's span seconds, the decode shapes dispatched
    [(B, T, K, dispatches)], the device summary (``devtrace``), and any
    entry-specific readings in ``extra``."""
    window_s: float
    work: float
    counters: dict = field(default_factory=dict)
    timers: dict = field(default_factory=dict)
    stage_seconds: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)
    shapes: list = field(default_factory=list)
    device: Optional[object] = None
    extra: dict = field(default_factory=dict)


@dataclass
class Outcome:
    """An entry's run: its end-to-end values by metric name, set-up
    seconds, requests attempted and failed, the checks [(name, value,
    limit)] (a check passes at value <= limit), the device peak, and the
    :class:`Obs` of the window."""
    e2e: dict
    setup_s: float
    attempted: int
    failed: int
    checks: list
    memory_peak_bytes: int
    obs: Obs


class Env:
    """What an entry gets: the cell, its configuration and mix, the run's
    seed, window and trace flag, the process's start, and the per-run
    scratch directory (the working directory while the entry runs), and
    the device the program runs on. ``overrides`` ({"cell": ...,
    "config": ..., "mix": ...}) puts keys over the files', for the
    harness's own tests: at small sizes, or for a kind of cell that no
    cell of ``BENCHMARK.json`` runs."""

    def __init__(self, cell_name: str, seed: int, seconds: float,
                 trace: bool, t_start: float, rundir: str,
                 device: str = "cuda", overrides: Optional[dict] = None):
        over = overrides or {}
        self.name = cell_name
        self.cell = with_overrides("cells", cell_name, over.get("cell", {}))
        self.config = with_overrides("configs", self.cell["config"],
                                     over.get("config", {}))
        self.mix = with_overrides("traffic", self.cell["traffic"],
                                  over.get("mix", {}))
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.t_start = t_start
        self.rundir = rundir
        #: "cuda", or "cpu" for the CPU tests of the harness itself
        self.device = device

    @property
    def on_card(self) -> bool:
        return self.device == "cuda"

    def sync(self) -> None:
        if self.on_card:
            import torch
            torch.cuda.synchronize()

    def memory_peak(self) -> int:
        if not self.on_card:
            return 0
        import torch
        return int(torch.cuda.max_memory_allocated())

    def lap(self, what: str) -> None:
        """Note on standard error how far set-up has come."""
        sys.stderr.write(f"portbench: {what} at "
                         f"{time.perf_counter() - self.t_start:.3f} s\n")

    def limits(self) -> dict:
        return self.cell["limits"]


def timed_units(units, do_unit: Callable, seconds: float):
    """Run whole units until one ends at or past ``seconds`` after the
    first began; returns (first unit's start, elapsed, units run).
    Raises when the units run out first: the staged traffic is too small
    for the window."""
    t0 = time.perf_counter()
    n = 0
    ends = []
    for u in units:
        do_unit(u)
        n += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            sys.stderr.write("portbench: units ended at "
                             + " ".join(f"{e:.2f}" for e in ends) + "\n")
            return t0, ends[-1], n
    raise RuntimeError(f"the staged traffic ran out after {n} units in "
                       f"{time.perf_counter() - t0:.1f} s: stage more")


def per_layer(bench: dict, cell: str, obs: Obs) -> dict:
    """Every per-layer metric of the cell that its reader finds."""
    out = {}
    for m in cell_metrics(bench, cell, "per_layer"):
        value = load_module("metrics", m["name"]).read(obs)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def breakdown(summary) -> dict:
    """The trace's longest device operations and idle gaps, ten each."""
    return {"device_ops": [[n, s] for n, s, _c in summary.kernels[:10]],
            "idle_gaps": sorted(([k, v] for k, v in summary.idle.items()),
                                key=lambda r: -r[1])[:10]}
