"""The port's ``parallel/`` against the JAX package's, on the CPU.

A decode mesh that names ``cpu`` more than once stands for many cards;
the JAX package's mesh is over the 8 virtual CPU devices that
``tests/conftest.py`` forces. The same seeded inputs go through both:

- ``device_slice`` picks the same devices for every well-formed spec
  (the JAX package's slicing cases among them); a malformed spec raises
  in the port where the JAX package logs and keeps every device;
- ``host_hash``, ``partition_for_host`` and ``host_uuid_filter`` agree
  over 1,000 uuids;
- the row-sharded decode (``sharded_data_viterbi``) over 1, 2 and 8
  entries is bit-equal to the JAX package's over 1, 2 and 8 devices, by
  the scan and by the associative scan, an all-SKIP filler row included;
- the row- and time-sharded associative decode (``sharded_viterbi``) on a
  (4, 2) mesh agrees with the JAX package's on ``make_mesh((4, 2))`` and
  with the scan within the f64 re-score tolerance of 1e-2 (the contract
  of the JAX package's ``tests/test_parallel.py``);
- two processes rendezvous through ``init_multihost`` on gloo (60 s
  bound) and partition 1,000 uuids disjointly and completely.
"""
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from reporter_tpu.matcher.hmm import viterbi_decode_batch as jax_scan
from reporter_tpu.matcher import MatchParams as JaxParams
from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
from reporter_tpu.matcher.batchpad import pack_batches as jax_pack
from reporter_tpu.matcher.batchpad import prepare_trace as jax_prepare
from reporter_tpu.ops import assoc_viterbi as jax_assoc
from reporter_tpu.parallel import mesh as jax_mesh
from reporter_tpu.parallel import multihost as jax_multihost
from reporter_tpu.parallel import sharded as jax_sharded
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu.synth import generate_trace as jax_trace
from reporter_tpu_torch import ops
from reporter_tpu_torch.matcher.hmm import NORMAL, RESTART, SKIP
from reporter_tpu_torch.parallel import mesh, multihost, sharded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIGMA, BETA = 4.07, 3.0
#: the f64 re-score tolerance of the JAX package's tests/test_parallel.py
TOL = 1e-2


def cpus(n):
    return ["cpu"] * n


# -- device_slice ------------------------------------------------------------

SPECS = ["", "0/2", "1/2", "3/4", "0/8", "7/8", "2:4", ":3", "5:", "0:8",
         " 1 / 2 ", "4:5"]


def _jax_slice(monkeypatch, spec, n):
    monkeypatch.setenv(jax_mesh.ENV_DEVICE_SLICE, spec)
    return jax_mesh.device_slice(list(range(n)))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("spec", SPECS)
def test_device_slice_equals_the_jax_packages(monkeypatch, spec, n):
    want = _jax_slice(monkeypatch, spec, n)
    try:
        got = mesh.device_slice(list(range(n)), spec)
    except ValueError:
        # the port refuses a spec that selects nothing; the JAX package
        # logs and keeps every device
        assert want == list(range(n))
        assert spec.strip() and ":" in spec
        return
    assert got == want


def test_device_slice_the_jax_packages_cases():
    # test_sharded_decode.py's TestDeviceSlice, through the port
    s = mesh.device_slice
    assert s(range(8), "0/2") == [0, 1, 2, 3]
    assert s(range(8), "1/2") == [4, 5, 6, 7]
    assert s(range(8), "3/4") == [6, 7]
    assert s(range(4), "5/8") == [2]
    assert s(range(4), "0/8") == [0]
    assert [s(range(2), f"{k}/4")[0] for k in range(4)] == [0, 0, 1, 1]
    assert s(range(8), "2:4") == [2, 3]
    assert s(range(8), None) == list(range(8))


@pytest.mark.parametrize("spec", ["banana", "9/4", "2/0", "1/2/3", "5:5",
                                  "-1:2"])
def test_a_malformed_slice_raises_where_the_jax_package_keeps_all(
        monkeypatch, spec):
    assert _jax_slice(monkeypatch, spec, 8) == list(range(8))
    with pytest.raises(ValueError):
        mesh.device_slice(list(range(8)), spec)


# -- meshes ------------------------------------------------------------------

def test_make_mesh_shapes_as_the_jax_packages():
    m = mesh.make_mesh(devices=cpus(8))
    assert m.shape == (8, 1) == jax_mesh.make_mesh().devices.shape
    m2 = mesh.make_mesh((4, 2), cpus(8))
    assert m2.axis_names == ("data", "seq") == jax_mesh.make_mesh(
        (4, 2)).axis_names
    assert mesh.mesh_axes(m2) == (4, 2) == jax_mesh.mesh_axes(
        jax_mesh.make_mesh((4, 2)))
    assert mesh.make_data_mesh(cpus(3)).axis_names == ("data",)
    for bad in ((3, 2), (0, 8)):
        with pytest.raises(ValueError):
            mesh.make_mesh(bad, cpus(8))
    with pytest.raises(ValueError):
        jax_mesh.make_mesh((3, 2))
    assert mesh.mesh_axes(None) == (1, 1) == jax_mesh.mesh_axes(None)
    assert mesh.decode_mesh_size(m2) == 4 and mesh.decode_mesh_size(None) == 1


def test_decode_mesh_rules():
    dm = mesh.decode_mesh
    # the CPU without named devices, shard off, one device: no mesh
    assert dm("cpu") is None
    assert dm("cpu", "off", devices=cpus(8)) is None
    assert dm("cpu", devices=cpus(1)) is None
    assert dm("cpu", "on", devices=cpus(1)) is None
    assert dm("cpu", devices=cpus(8), slice_spec="3/8") is None
    if not torch.cuda.is_available():
        assert dm("cuda") is None and dm("cuda", "on") is None
    m = dm("cpu", devices=cpus(8))
    assert m.shape == (8, 1) and m.axis_names == ("data",)
    assert dm("cpu", devices=cpus(8), slice_spec="1/2").shape == (4, 1)
    # the seq width falls to the largest divisor of the device count
    assert dm("cpu", devices=cpus(8), seq_shards=2).shape == (4, 2)
    assert dm("cpu", devices=cpus(8), seq_shards=3).shape == (4, 2)
    assert dm("cpu", devices=cpus(6), seq_shards=4).shape == (2, 3)
    assert dm("cpu", devices=cpus(2), seq_shards=8).shape == (1, 2)
    for kw in ({"shard": "maybe"}, {"seq_shards": 0}, {"seq_shards": 1.5},
               {"slice_spec": "banana"}):
        with pytest.raises(ValueError):
            dm("cpu", devices=cpus(8), **kw)


def test_a_mesh_has_one_device_type_and_no_stream_off_the_card():
    with pytest.raises(ValueError):
        mesh.make_data_mesh(["cpu", "cuda:0"])
    m = mesh.make_data_mesh(cpus(2))
    assert m.stream(0) is None and not m.on_card
    m.close()


@pytest.mark.parametrize("shape,decode,want", [
    ((8, 1), "fused", 8), ((8, 1), "scan", 8), ((8, 1), "assoc", 8),
    ((4, 2), "fused", None), ((4, 2), "scan", None), ((4, 2), "assoc", 4),
    ((1, 2), "assoc", None)])
def test_batch_pad_multiple_as_the_jax_packages(shape, decode, want):
    m = mesh.make_mesh(shape, cpus(shape[0] * shape[1]))
    assert ops.batch_pad_multiple(m, decode) == want
    assert ops.batch_pad_multiple(None, decode) is None


def test_shard_width():
    m8 = mesh.make_data_mesh(cpus(8))
    m42 = mesh.make_mesh((4, 2), cpus(8))
    assert ops.shard_width(m8, 16, 64) == 8
    assert ops.shard_width(m8, 12, 64) == 1
    assert ops.shard_width(None, 16, 64) == 1
    assert ops.shard_width(m42, 16, 64, "assoc") == 8
    assert ops.shard_width(m42, 16, 64, "fused") == 1
    assert ops.shard_width(m42, 16, 63, "assoc") == 1


# -- multihost ---------------------------------------------------------------

UUIDS = [f"veh-{i}" for i in range(1000)]


def test_host_hash_pinned_and_equal_to_the_jax_packages():
    assert multihost.host_hash("veh-42") == 12078884699722865484
    assert [multihost.host_hash(u) for u in UUIDS] == \
        [jax_multihost.host_hash(u) for u in UUIDS]


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_partitions_equal_the_jax_packages(n):
    parts = [multihost.partition_for_host(UUIDS, n, p) for p in range(n)]
    assert parts == [jax_multihost.partition_for_host(UUIDS, n, p)
                     for p in range(n)]
    assert sorted(i for part in parts for i in part) == list(range(1000))
    with pytest.raises(ValueError):
        multihost.partition_for_host(UUIDS, n, n)


def test_host_uuid_filter_equals_the_jax_packages(monkeypatch):
    for var in (jax_multihost.ENV_NUM_PROCESSES,
                jax_multihost.ENV_PROCESS_ID):
        monkeypatch.delenv(var, raising=False)
    assert multihost.host_uuid_filter() is None
    assert jax_multihost.host_uuid_filter() is None
    assert multihost.host_uuid_filter(1, 0) is None
    monkeypatch.setenv(jax_multihost.ENV_NUM_PROCESSES, "3")
    monkeypatch.setenv(jax_multihost.ENV_PROCESS_ID, "1")
    want = jax_multihost.host_uuid_filter()
    got = multihost.host_uuid_filter(3, 1)
    assert [u for u in UUIDS if got(u)] == [u for u in UUIDS if want(u)]
    for pid in (3, -1, None):
        with pytest.raises(ValueError):
            multihost.host_uuid_filter(3, pid)


def test_the_multihost_module_imports_no_torch():
    """A spawned pipeline gather child imports it: it stays torch-free,
    and so does the package's own import."""
    code = ("import sys, reporter_tpu_torch.parallel as p\n"
            "from reporter_tpu_torch.parallel import multihost\n"
            "assert multihost.owned_by_host('veh-42', 2, 0) in (True, False)\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


def test_init_multihost_without_a_coordinator_is_a_no_op():
    assert multihost.init_multihost() is False
    assert multihost.init_multihost(None, 2, 1) is False
    with pytest.raises(ValueError):
        multihost.init_multihost("127.0.0.1:1", 2, None)
    with pytest.raises(ValueError):
        multihost.init_multihost("127.0.0.1:1", 2, 2)
    multihost.shutdown_multihost()  # nothing joined: a no-op


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


RANK = r"""
import json, sys
import torch.distributed as dist
from reporter_tpu_torch.parallel import multihost
how, port, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
if how == "env":
    assert multihost.init_multihost("env://", timeout_s=50)
else:
    assert multihost.init_multihost(f"127.0.0.1:{port}", 2, rank,
                                    timeout_s=50)
uuids = [f"veh-{i}" for i in range(1000)]
mine = multihost.partition_for_host(uuids, dist.get_world_size(),
                                    dist.get_rank())
parts = [None, None]
dist.all_gather_object(parts, mine)
multihost.shutdown_multihost()
print(json.dumps({"rank": rank, "parts": parts}))
"""


@pytest.mark.parametrize("how", ["tcp", "env"])
def test_two_processes_rendezvous_and_partition(how):
    """Two processes join one gloo group (an explicit address, and
    torchrun's variables through env://), exchange their partitions of
    1,000 uuids, and find them disjoint and complete."""
    port = free_port()
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, how, str(port), str(r)], cwd=ROOT,
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    parts = outs[0]["parts"]
    assert outs[1]["parts"] == parts
    assert parts[0] and parts[1] and not set(parts[0]) & set(parts[1])
    assert sorted(parts[0] + parts[1]) == list(range(1000))
    assert parts == [jax_multihost.partition_for_host(UUIDS, 2, p)
                     for p in range(2)]


def test_a_rendezvous_that_times_out_raises():
    port = free_port()
    code = (f"from reporter_tpu_torch.parallel import multihost\n"
            f"multihost.init_multihost('127.0.0.1:{port}', 2, 0, "
            f"timeout_s=2)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0


# -- the row-sharded decode --------------------------------------------------

def random_batch(B, T, K, seed, f16=False, route_rows=None):
    """Seeded inputs with RESTART and SKIP steps, unroutable pairs and an
    all-SKIP filler row (the last)."""
    rng = np.random.default_rng(seed)
    dtype = np.float16 if f16 else np.float32
    dist = rng.uniform(0, 30, (B, T, K)).astype(dtype)
    valid = rng.uniform(size=(B, T, K)) > 0.1
    valid[:, :, 0] = True
    Tr = T - 1 if route_rows is None else route_rows
    gc = rng.uniform(5, 40, (B, Tr)).astype(dtype)
    route = rng.uniform(5, 80, (B, Tr, K, K)).astype(dtype)
    route[rng.uniform(size=route.shape) < 0.05] = 1e9 if not f16 else np.inf
    case = np.full((B, T), NORMAL, np.int32)
    case[:, 0] = RESTART
    case[rng.uniform(size=(B, T)) < 0.05] = RESTART
    for b in range(B):
        case[b, T - int(rng.integers(0, T // 3 + 1)):] = SKIP
    case[-1, :] = SKIP
    return dist, valid, route, gc, case


def _port_run(run, args):
    out = run(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args),
              SIGMA, BETA)
    p, s = out.wait()
    return p.numpy(), s.numpy()


def _jax_run(run, args):
    p, s = run(*args, SIGMA, BETA)
    return np.asarray(p), np.asarray(s)


JAX_KERNELS = {"scan": jax_scan.__wrapped__,
               "assoc": jax_assoc.viterbi_assoc_batch.__wrapped__}


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("decode", ["fused", "scan", "assoc"])
def test_row_sharded_decode_bit_equal_to_the_jax_packages(n, decode):
    """"fused" is the plain scan on the CPU: both hold to the JAX scan."""
    args = random_batch(8, 16, 4, seed=5 + n)
    jax_run = jax_sharded.sharded_data_viterbi(
        jax_mesh.make_data_mesh(jax.devices()[:n]),
        JAX_KERNELS["assoc" if decode == "assoc" else "scan"])
    pj, sj = _jax_run(jax_run, args)
    port_mesh = mesh.make_data_mesh(cpus(n))
    pt, st = _port_run(sharded.sharded_data_viterbi(port_mesh, decode), args)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(st.view(np.int32), sj.view(np.int32))
    # and bit-equal to the port's own unsharded decode
    p1, s1 = ops.decode_batch(*(torch.from_numpy(a) for a in args), SIGMA,
                              BETA, decode=decode)
    np.testing.assert_array_equal(pt, p1.numpy())
    np.testing.assert_array_equal(st.view(np.int32),
                                  s1.numpy().view(np.int32))


@pytest.mark.parametrize("f16,route_rows", [(True, None), (False, 32)])
def test_row_sharded_decode_on_both_wires_and_layouts(f16, route_rows):
    args = random_batch(16, 32, 8, seed=11, f16=f16, route_rows=route_rows)
    port_mesh = mesh.make_data_mesh(cpus(4))
    for decode in ops.DECODES:
        pt, st = _port_run(sharded.sharded_data_viterbi(port_mesh, decode),
                           args)
        p1, s1 = ops.decode_batch(*(torch.from_numpy(a) for a in args),
                                  SIGMA, BETA, decode=decode)
        assert np.array_equal(pt, p1.numpy()), decode
        assert np.array_equal(st.view(np.int32), s1.numpy().view(np.int32))


def test_shard_batch_data_splits_rows():
    args = random_batch(8, 16, 4, seed=3)
    shards = sharded.shard_batch_data(mesh.make_data_mesh(cpus(4)), *args)
    assert len(shards) == 4
    for d, x in enumerate(shards):
        for a, t in zip(args, x):
            assert np.array_equal(t.numpy(), a[2 * d:2 * d + 2])
    with pytest.raises(ValueError):
        sharded.shard_batch_data(mesh.make_data_mesh(cpus(3)), *args)
    with pytest.raises(ValueError):
        sharded.shard_batch_data(mesh.make_mesh((4, 2), cpus(8)), *args)


def test_decode_batch_on_a_mesh_counts_and_falls_through():
    from reporter_tpu_torch.utils import metrics
    args = [torch.from_numpy(a) for a in random_batch(8, 16, 4, seed=9)]
    m8 = mesh.make_data_mesh(cpus(8))
    c0 = metrics.default.counter("decode.shard.chunks")
    r0 = metrics.default.counter("decode.shard.rows")
    p, s = ops.decode_batch(*args, SIGMA, BETA, mesh=m8)
    assert metrics.default.counter("decode.shard.chunks") == c0 + 1
    assert metrics.default.counter("decode.shard.rows") == r0 + 8
    p1, _ = ops.decode_batch(*args, SIGMA, BETA)
    assert torch.equal(p, p1)
    pending = ops.decode_batch(*args, SIGMA, BETA, mesh=m8, pending=True)
    assert isinstance(pending, sharded.ShardedDecode) and not pending.events
    assert torch.equal(pending.wait()[0], p1)
    # 3 rows do not divide over 8 entries: the first device, uncounted
    p3, _ = ops.decode_batch(*(a[:3] for a in args), SIGMA, BETA, mesh=m8)
    assert torch.equal(p3, p1[:3])
    assert metrics.default.counter("decode.shard.chunks") == c0 + 2
    with pytest.raises(ValueError):
        ops.decode_batch(*args, SIGMA, BETA, events=(1, 2), mesh=m8)


# -- the row- and time-sharded associative decode ---------------------------

def rescore_f64(dist, route, gc, case, path):
    """One path's total log-score in float64 numpy (kept points only; no
    transition into a RESTART; an unroutable step costs 1e9)."""
    total = 0.0
    for t in range(len(case)):
        if case[t] == SKIP:
            continue
        k = int(path[t])
        total += -0.5 * (float(dist[t, k]) / SIGMA) ** 2
        if t and case[t] == NORMAL:
            r = float(route[t - 1, int(path[t - 1]), k])
            total += (-abs(r - float(gc[t - 1])) / BETA if r < 0.5e9
                      else -1e9)
    return total


def assert_rescore_close(args, p_a, p_b):
    dist, _valid, route, gc, case = args
    for b in range(dist.shape[0]):
        sa = rescore_f64(dist[b], route[b], gc[b], case[b], p_a[b])
        sb = rescore_f64(dist[b], route[b], gc[b], case[b], p_b[b])
        assert sa == pytest.approx(sb, abs=TOL), f"trace {b}"


@pytest.fixture(scope="module")
def prepared_batch():
    """test_parallel.py's batch: 8 traces of the JAX package's 10x10 city
    prepared and packed by the JAX package (numpy arrays)."""
    city = jax_city(rows=10, cols=10, spacing_m=200.0, seed=6,
                    service_road_fraction=0.0, internal_fraction=0.0)
    m = JaxMatcher(net=city)
    rng = np.random.default_rng(0)
    prepared = []
    for i in range(8):
        tr = None
        while tr is None:
            tr = jax_trace(city, f"v{i}", rng, noise_m=4.0,
                           min_route_edges=8, max_route_edges=14)
        prepared.append(jax_prepare(city, m.grid, tr.points, JaxParams(),
                                    m.route_cache))
    batches = jax_pack(prepared)
    assert len(batches) == 1
    b = batches[0]
    return tuple(np.asarray(a) for a in (b.dist_m, b.valid, b.route_m,
                                         b.gc_m, b.case))


def test_time_sharded_decode_matches_the_jax_packages(prepared_batch):
    args = prepared_batch
    pj, _ = _jax_run(jax_sharded.sharded_viterbi(jax_mesh.make_mesh((4, 2))),
                     args)
    ps, _ = _jax_run(jax_scan, args)
    pt, st = _port_run(sharded.sharded_viterbi(
        mesh.make_mesh((4, 2), cpus(8))), args)
    assert pt.dtype == np.int32 and st.dtype == np.float32
    assert_rescore_close(args, pt, pj)
    assert_rescore_close(args, pt, ps)
    # the port's unsharded assoc decode too
    pa, sa = ops.viterbi_assoc_batch(*(torch.from_numpy(a) for a in args),
                                     SIGMA, BETA)
    assert_rescore_close(args, pt, pa.numpy())
    assert np.allclose(st, sa.numpy(), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 8), (8, 1), (2, 2),
                                   (1, 2)])
@pytest.mark.parametrize("T,route_rows", [(16, None), (16, 16), (8, None)])
def test_time_sharded_decode_within_the_rescore(shape, T, route_rows):
    """Random inputs (restarts, SKIP tails, unroutable pairs, a filler
    row) at every mesh shape, both route layouts, and T = 8 on 8 spans
    (a last span with no step of its own): within 1e-2 of the unsharded
    scan and assoc decodes by the f64 re-score, scores close."""
    B = 8
    args = random_batch(B, T, 4, seed=T + shape[1], route_rows=route_rows)
    m = mesh.make_mesh(shape, cpus(shape[0] * shape[1]))
    pt, st = _port_run(sharded.sharded_viterbi(m), args)
    x = tuple(torch.from_numpy(a) for a in args)
    for fn in (ops.viterbi_assoc_batch, ops.viterbi_plain):
        p, s = fn(*x, SIGMA, BETA)
        assert_rescore_close(args, pt, p.numpy())
        assert np.allclose(st, s.numpy(), rtol=1e-5, atol=1e-3)


def test_decode_batch_dispatches_assoc_to_the_time_sharded_decode():
    from reporter_tpu_torch.utils import metrics
    args = random_batch(8, 16, 4, seed=21)
    x = [torch.from_numpy(a) for a in args]
    m = mesh.make_mesh((4, 2), cpus(8))
    c0 = metrics.default.counter("decode.shard.chunks")
    p, _ = ops.decode_batch(*x, SIGMA, BETA, decode="assoc", mesh=m)
    assert metrics.default.counter("decode.shard.chunks") == c0 + 1
    pa, _ = ops.viterbi_assoc_batch(*x, SIGMA, BETA)
    assert_rescore_close(args, p.numpy(), pa.numpy())
    # the scan does not shard time: the first device, uncounted
    p2, _ = ops.decode_batch(*x, SIGMA, BETA, decode="scan", mesh=m)
    assert torch.equal(p2, ops.viterbi_plain(*x, SIGMA, BETA)[0])
    assert metrics.default.counter("decode.shard.chunks") == c0 + 1


def test_shard_batch_pads_route_to_T_and_splits_time():
    args = random_batch(8, 16, 4, seed=2)
    pieces = sharded.shard_batch(mesh.make_mesh((2, 4), cpus(8)), *args)
    assert len(pieces) == 8
    for i, p in enumerate(pieces):
        d, s = divmod(i, 4)
        last = s == 3
        assert tuple(p["dist"].shape) == (4, 4 if last else 5, 4)
        assert tuple(p["route"].shape) == (4, 3 if last else 4, 4, 4)
        assert tuple(p["gc"].shape) == (4, 3 if last else 4)
        assert np.array_equal(p["route"].numpy(),
                              args[2][4 * d:4 * d + 4, 4 * s:4 * s + 4][
                                  :, :p["route"].shape[1]])
    with pytest.raises(ValueError):
        sharded.shard_batch(mesh.make_mesh((2, 4), cpus(8)),
                            *random_batch(8, 15, 4, seed=2))
