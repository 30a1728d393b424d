"""The port stands alone: importing every module of ``reporter_tpu_torch``
pulls in neither JAX nor any module of ``reporter_tpu``, and its entry
points refuse to run without CUDA unless given the CPU."""
import json
import pkgutil
import subprocess
import sys

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
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                         text=True, check=True, timeout=120)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    expected = {m.name for m in pkgutil.walk_packages(
        reporter_tpu_torch.__path__, "reporter_tpu_torch.")}
    assert set(got["imported"]) == expected
    assert "reporter_tpu_torch.ops.viterbi" in expected
    mods = got["modules"]
    assert not [m for m in mods if m == "jax" or m.startswith("jax.")]
    assert not [m for m in mods
                if m == "reporter_tpu" or m.startswith("reporter_tpu.")]


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        SegmentMatcher()
    with pytest.raises(RuntimeError, match="CUDA"):
        SegmentMatcher(build_grid_city(rows=3, cols=3))
    assert resolve_device("cpu").type == "cpu"
