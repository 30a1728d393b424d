"""The port's pre-fork serving mode (``service/prefork.py``), end to end.

``python -m reporter_tpu_torch.service.server cfg.json host:port --procs
2 --device cpu`` runs in a fresh interpreter: its parent forks both
workers before anything touches a device or runs a torch op, and each
worker builds its matcher after the fork. Both workers answer behind one
port with the port's bytes; a SIGKILLed worker is restarted in its slot;
SIGTERM to the parent reaps both and the parent exits 0. A worker that
cannot open the card exits non-zero, and the restart budget ends the run.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from reporter_tpu.service import prefork as jax_prefork
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu_torch.graph.network import RoadNetwork
from reporter_tpu_torch.matcher import SegmentMatcher
from reporter_tpu_torch.service import prefork
from reporter_tpu_torch.service.report import report_json
from reporter_tpu_torch.synth import generate_trace

from test_torch_service import (ROOT, call, free_port, post_report,
                                start_main, wait_up)


def test_exit_code_decoding():
    """rc-137 awareness: a SIGKILLed worker and an ``os._exit(137)``
    decode to the same shell-style code, as in the JAX package."""
    for kill in (False, True):
        pid = os.fork()
        if pid == 0:
            if kill:
                os.kill(os.getpid(), signal.SIGKILL)
            os._exit(137)
        _, status = os.waitpid(pid, 0)
        assert prefork._exit_code(status) == 137
        assert jax_prefork._exit_code(status) == 137


def _tags(url, n, seen, deadline):
    """Answers of ``/health`` until ``n`` slots have answered (each
    connection lands on a worker the kernel picks): {slot: tag}."""
    while len(seen) < n:
        assert time.monotonic() < deadline, f"only {seen} answered"
        try:
            st, h, _b = call(url, "/health")
        except OSError:
            time.sleep(0.05)
            continue
        assert st == 200
        tag = h["X-Reporter-Proc"]
        seen.setdefault(tag.split(":")[0], tag)
    return seen


def test_prefork_two_workers_end_to_end(tmp_path):
    city = jax_city(rows=8, cols=8, spacing_m=200.0, seed=3)
    city.save(str(tmp_path / "city.npz"))
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"graph": str(tmp_path / "city.npz"),
         "service": {"max_wait_ms": 5.0}}))
    local = SegmentMatcher(RoadNetwork.load(str(tmp_path / "city.npz")),
                           device="cpu")
    rng = np.random.default_rng(3)
    reqs = []
    while len(reqs) < 4:
        tr = generate_trace(local.net, f"veh-{len(reqs)}", rng, noise_m=3.0)
        if tr is not None:
            reqs.append(tr.request_json(report_levels=(0, 1, 2),
                                        transition_levels=(0, 1, 2)))
    want = [report_json(m, r, 15, {0, 1, 2}, {0, 1, 2}).encode()
            for m, r in zip(local.match_many(reqs), reqs)]

    port = free_port()
    url = f"http://127.0.0.1:{port}"
    proc = start_main(tmp_path / "cfg.json", port, "--procs", "2",
                      "--device", "cpu")
    try:
        wait_up(proc, url)
        deadline = time.monotonic() + 120
        tags = _tags(url, 2, {}, deadline)
        assert set(tags) == {"p0", "p1"}
        assert tags["p0"] != tags["p1"]
        # /report from both workers, with the port's bytes
        answered = set()
        for i in range(400):
            st, h, body = post_report(url, reqs[i % len(reqs)])
            assert st == 200 and body == want[i % len(reqs)]
            answered.add(h["X-Reporter-Proc"])
            if answered == set(tags.values()) and i >= len(reqs):
                break
        assert answered == set(tags.values())
        # SIGKILL p0: the supervisor restarts its slot under a new pid
        os.kill(int(tags["p0"].split(":")[1]), signal.SIGKILL)
        new = None
        while new is None:
            assert time.monotonic() < deadline, "p0 never came back"
            try:
                st, h, body = post_report(url, reqs[0])
            except OSError:  # the killed worker's connection
                time.sleep(0.05)
                continue
            assert st == 200 and body == want[0]
            tag = h["X-Reporter-Proc"]
            if tag.startswith("p0:") and tag != tags["p0"]:
                new = tag
        workers = [int(new.split(":")[1]), int(tags["p1"].split(":")[1])]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    err = proc.stderr.read()
    assert "SIGKILLed (rc 137)" in err
    for pid in workers:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


SCRIPT = r"""
import socket, sys
import torch
from reporter_tpu_torch.graph.network import RoadNetwork
from reporter_tpu_torch.matcher import SegmentMatcher
from reporter_tpu_torch.service.prefork import serve_prefork
from reporter_tpu_torch.service.server import ReporterService, slot_device

def make_service(slot, procs):
    device = slot_device(torch.device("cuda"), slot, procs)
    return ReporterService(SegmentMatcher(RoadNetwork.load(sys.argv[1]),
                                          device=device))

with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
sys.exit(serve_prefork(make_service, "127.0.0.1", port, 2, 64,
                       max_total_restarts=2))
"""


def test_workers_without_a_card_exit_and_spend_the_budget(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the workers would start")
    jax_city(rows=4, cols=4, spacing_m=200.0, seed=3).save(
        str(tmp_path / "city.npz"))
    proc = subprocess.run([sys.executable, "-c", SCRIPT,
                           str(tmp_path / "city.npz")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "CUDA is not available" in proc.stderr
    assert "died in startup" in proc.stderr
    assert "restart budget exhausted" in proc.stderr


def test_slot_device_splits_the_visible_cards(monkeypatch):
    import torch
    from reporter_tpu_torch.service.server import slot_device
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    dev = torch.device
    assert [str(slot_device(dev("cuda"), s, 2)) for s in range(2)] == [
        "cuda:0", "cuda:2"]
    assert [str(slot_device(dev("cuda"), s, 8)) for s in range(8)] == [
        "cuda:0", "cuda:0", "cuda:1", "cuda:1", "cuda:2", "cuda:2",
        "cuda:3", "cuda:3"]
    assert slot_device(dev("cuda"), 0, 1) == dev("cuda")
    assert slot_device(dev("cuda:3"), 1, 2) == dev("cuda:3")
    assert slot_device(dev("cpu"), 1, 2) == dev("cpu")
