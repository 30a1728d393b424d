"""The port's bigreplay harness (``reporter_tpu_torch/tools/bigreplay.py``)
and its oracle (``reporter_tpu_torch/matcher/cpu_ref.py``) on the CPU.

- ``cpu_ref.viterbi_decode_numpy`` is bit-equal, in paths and scores, to
  the JAX package's ``cpu_ref`` and to the port's plain scan on seeded
  inputs with SKIP and RESTART steps, invalid candidates and unreachable
  routes; no serving, streaming or pipeline module imports it.
- ``bigreplay --probes 3000 --writers 2 --agreement-sample 15``: oracle
  agreement >= 0.99, exactly-once on both legs and empty spools.
- The clean leg with flushes made a pure function of the stream (flush
  intervals past the run) writes the tile trees the JAX package's own
  workers write from the same seeded metro.

Tolerance: exact.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
from reporter_tpu.matcher.cpu_ref import viterbi_decode_numpy as jax_ref
from reporter_tpu.service.server import ReporterService as JaxService
from reporter_tpu.streaming.anonymiser import Anonymiser as JaxAnonymiser
from reporter_tpu.streaming.anonymiser import TileSink as JaxSink
from reporter_tpu.streaming.formatter import Formatter as JaxFormatter
from reporter_tpu.streaming.worker import StreamWorker as JaxWorker
from reporter_tpu.streaming.worker import inproc_submitter as jax_submitter
from reporter_tpu_torch import ops
from reporter_tpu_torch.matcher.cpu_ref import viterbi_decode_numpy
from reporter_tpu_torch.matcher.hmm import NORMAL, RESTART, SKIP
from reporter_tpu_torch.tools import bigreplay, chaos

PKG = os.path.dirname(os.path.dirname(os.path.abspath(ops.__file__)))


def decode_inputs(B, T, K, seed):
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0.0, 40.0, (B, T, K)).astype(np.float32)
    valid = rng.random((B, T, K)) > 0.15
    valid[:, :, 0] = True
    gc = rng.uniform(5.0, 400.0, (B, T - 1)).astype(np.float32)
    route = (gc[:, :, None, None]
             + rng.uniform(0.0, 300.0, (B, T - 1, K, K))).astype(np.float32)
    route[rng.random(route.shape) < 0.1] = 1e9
    route[rng.random(route.shape) < 0.02] = np.inf
    case = rng.choice([NORMAL, RESTART, SKIP], size=(B, T),
                      p=[0.8, 0.1, 0.1]).astype(np.int32)
    case[:, 0] = NORMAL
    case[0, 1:] = RESTART
    case[1, 1:] = SKIP
    return dist, valid, route, gc, case


@pytest.mark.parametrize("T,K,seed", [(2, 4, 1), (16, 8, 2), (64, 8, 3),
                                      (33, 16, 4)])
def test_cpu_ref_is_bit_equal_to_the_jax_oracle_and_the_plain_scan(T, K,
                                                                   seed):
    dist, valid, route, gc, case = decode_inputs(6, T, K, seed)
    paths, scores = ops.viterbi_plain(*(torch.from_numpy(a) for a in (
        dist, valid, route, gc, case)), 4.07, 3.0)
    for b in range(len(dist)):
        p, s = viterbi_decode_numpy(dist[b], valid[b], route[b], gc[b],
                                    case[b], 4.07, 3.0)
        jp, js = jax_ref(dist[b], valid[b], route[b], gc[b], case[b],
                         4.07, 3.0)
        assert p.dtype == np.int32 and np.array_equal(p, jp)
        assert np.float32(s).tobytes() == np.float32(js).tobytes()
        assert np.array_equal(p, paths[b].numpy())
        assert np.float32(s).tobytes() == scores[b].numpy().tobytes()


def test_no_serving_path_imports_the_oracle():
    users = []
    for root, _dirs, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py") and name != "cpu_ref.py":
                path = os.path.join(root, name)
                if "cpu_ref" in open(path).read():
                    users.append(os.path.relpath(path, PKG))
    assert users == [os.path.join("tools", "bigreplay.py")]


def test_smoke_is_exactly_once_and_agrees_with_the_oracle(tmp_path):
    out = tmp_path / "bigreplay.json"
    assert bigreplay.main(["--device", "cpu", "--probes", "3000",
                           "--writers", "2", "--agreement-sample", "15",
                           "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert art["agreement"] >= 0.99 and art["agreement_traces"] == 15
    for leg in ("clean", "chaos"):
        once = art[leg]["exactly_once"]
        assert once["cells"] > 0 and once["reingest_files_deduped"] > 0
    assert art["chaos"]["fired"]["decode.dispatch"] == 10
    assert art["fault_throughput_ratio"] >= 0.2


def jax_clean_leg(metro, writers, workdir):
    """The clean leg through the JAX package's own workers, flushes past
    the run (so they fall where the stream puts them)."""
    trees = {}
    for name, city, _traces, lines in metro:
        out_dir = os.path.join(workdir, f"out-{name}")
        service = JaxService(JaxMatcher(net=city), threshold_sec=15,
                             max_batch=64, max_wait_ms=5.0)
        threads = []
        for w, shard in enumerate(chaos.shard_lines(lines, writers)):
            if not shard:
                continue
            anon = JaxAnonymiser(JaxSink(out_dir, deadletter=os.path.join(
                workdir, f"spool-{name}-w{w}")), privacy=1,
                quantisation=3600, source=f"big-{name}")
            anon.writer_id = f"w{w}"
            worker = JaxWorker(
                JaxFormatter.from_config(bigreplay.FMT),
                jax_submitter(service), anon, reports="0,1,2",
                transitions="0,1,2", flush_interval_s=1e9,
                submit_many=service.report_many,
                report_flush_interval_s=1e9)
            threads.append(threading.Thread(target=worker.run,
                                            args=(iter(shard),)))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        service.dispatcher.close()
        trees[name] = chaos.tile_tree(out_dir)
    return trees


def jax_harness(monkeypatch):
    """The JAX repo's tools/bigreplay.py as a module (nothing run)."""
    import importlib.util
    monkeypatch.setenv("REPORTER_TPU_PLATFORM", "cpu")
    spec = importlib.util.spec_from_file_location(
        "jax_bigreplay_tool", os.path.join(os.path.dirname(PKG), "tools",
                                           "bigreplay.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_clean_leg_tiles_equal_the_jax_packages(tmp_path, monkeypatch):
    """The same seeded metro from both harnesses, and the clean leg's
    tile trees from both packages' workers."""
    metro = bigreplay.build_metro(3000, 9)
    jax_metro = jax_harness(monkeypatch).build_metro(3000, 9)
    assert [(n, t, ln) for n, _c, t, ln in metro] \
        == [(n, t, ln) for n, _c, t, ln in jax_metro]
    leg = bigreplay.run_leg(metro, 2, str(tmp_path / "port"), "cpu",
                            flush_interval_s=1e9,
                            report_flush_interval_s=1e9)
    assert leg["spooled_left"] == 0 and not leg["parse_failures"]
    want = jax_clean_leg(jax_metro, 2, str(tmp_path / "jax"))
    got = {name: chaos.tile_tree(d) for (name, *_r), d
           in zip(metro, leg["out_dirs"])}
    assert all(want.values()) and got == want
