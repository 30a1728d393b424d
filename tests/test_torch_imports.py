"""The port stands alone: importing every module of ``reporter_tpu_torch``
pulls in neither JAX nor any module of ``reporter_tpu`` and builds no
library, the port reads no environment variable, and its entry points
refuse to run without CUDA unless given the CPU."""
import json
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import reporter_tpu_torch
from reporter_tpu_torch.matcher import SegmentMatcher, resolve_device
from reporter_tpu_torch.synth import build_grid_city

PROBE = """
import importlib, json, pkgutil, sys
import reporter_tpu_torch
names = [m.name for m in pkgutil.walk_packages(reporter_tpu_torch.__path__,
                                               "reporter_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "modules": sorted(sys.modules),
                  "native_loaded": sys.modules[
                      "reporter_tpu_torch.native"]._lib is not None}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                         text=True, check=True, timeout=120)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    expected = {m.name for m in pkgutil.walk_packages(
        reporter_tpu_torch.__path__, "reporter_tpu_torch.")}
    assert set(got["imported"]) == expected
    assert {"reporter_tpu_torch.ops.viterbi",
            "reporter_tpu_torch.ops.incremental",
            "reporter_tpu_torch.matcher.incremental",
            "reporter_tpu_torch.native"} <= expected
    assert not got["native_loaded"]
    mods = got["modules"]
    assert not [m for m in mods if m == "jax" or m.startswith("jax.")]
    assert not [m for m in mods
                if m == "reporter_tpu" or m.startswith("reporter_tpu.")]


@pytest.mark.parametrize("first", ["reporter_tpu_torch.graph.route_device",
                                   "reporter_tpu_torch.ops.route_relax",
                                   "reporter_tpu_torch.ops.incremental",
                                   "reporter_tpu_torch.matcher.incremental"])
def test_a_module_imports_first(first):
    """The port's modules import one another in a cycle (ops -> matcher
    -> graph.route_device -> ops); each entry imports in a fresh process."""
    subprocess.run([sys.executable, "-c", f"import {first}"], check=True,
                   timeout=120)


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        SegmentMatcher()
    with pytest.raises(RuntimeError, match="CUDA"):
        SegmentMatcher(build_grid_city(rows=3, cols=3))
    assert resolve_device("cpu").type == "cpu"


def test_port_reads_no_environment_variable():
    root = Path(reporter_tpu_torch.__file__).parent
    files = [p for p in root.rglob("*")
             if p.suffix in (".py", ".cpp", ".cu", ".h", ".cuh")]
    assert {p.name for p in files} >= {"host_runtime.cpp", "viterbi.cu",
                                       "matcher.py"}
    found = [f"{p.relative_to(root)}:{n}"
             for p in files
             for n, line in enumerate(p.read_text().splitlines(), 1)
             if re.search(r"os\.environ|getenv", line)]
    assert not found
