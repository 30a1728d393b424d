"""The port's device route costs against the JAX package's, on the CPU.

On the 8x8 grid city, built by each package's own ``build_grid_city``,
with inputs drawn from seeded numpy streams:

- the plain ``relax_csr`` and ``pair_costs`` (``ops/route_relax.py``) give
  the bits of the JAX package's ``relax_csr`` and ``pair_costs``,
  ``iters`` and ``converged`` included;
- ``DeviceRouteKernel.route_matrices`` gives the bytes of the JAX
  package's kernel and of the host search on the reference's crafted
  candidate sets;
- ``prepare_batch(route_kernel=...)`` gives the host prep's chunk bytes,
  filler rows and the dead step included, deferred as synchronous; the
  node-kernel cache serves, misses and re-relaxes as the reference's;
- a chunk over the state budget and a relaxation out of sweeps raise;
- ``/report`` bodies with ``route_device=True`` equal the port's without
  it and the JAX matcher's with ``REPORTER_TPU_ROUTE_DEVICE=1``, and with
  ``prune_sigma`` the JAX matcher's with ``REPORTER_TPU_ROUTE_PRUNE_SIGMA``
  on both prep paths.

The kernels themselves run only on the card (``chip_smoke.py``); here
the CPU tensors take the plain versions. Tolerance: exact.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reporter_tpu.graph.route_device import DeviceRouteKernel as JaxKernel
from reporter_tpu.matcher import MatchParams as JaxParams
from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
from reporter_tpu.ops import route_relax as jax_relax
from reporter_tpu.service.report import report_json as jax_report_json
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu.utils import metrics as jax_metrics
from reporter_tpu_torch import ops
from reporter_tpu_torch.core.tracebatch import TraceBatch
from reporter_tpu_torch.graph import route_device
from reporter_tpu_torch.graph.route import (UNREACHABLE,
                                            candidate_route_matrices)
from reporter_tpu_torch.graph.route_device import DeviceRouteKernel
from reporter_tpu_torch.graph.spatial import PAD_EDGE, CandidateSet
from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
from reporter_tpu_torch.matcher.batchpad import (bucket_length,
                                                 padded_batch_rows,
                                                 prepare_batch)
from reporter_tpu_torch.ops import route_relax
from reporter_tpu_torch.service.report import report_json
from reporter_tpu_torch.service.server import matcher_from_config, read_config
from reporter_tpu_torch.synth import build_grid_city, generate_trace
from reporter_tpu_torch.utils import metrics

CITY = dict(rows=8, cols=8, spacing_m=200.0, seed=3)
PARAMS = MatchParams(max_candidates=8)
UNREACH = np.float32(UNREACHABLE)


@pytest.fixture(scope="module")
def cities():
    return jax_city(**CITY), build_grid_city(**CITY)


@pytest.fixture(scope="module")
def kernels(cities):
    ref_city, city = cities
    return JaxKernel(ref_city), DeviceRouteKernel(city, "cpu")


def _reqs(city, n=6, seed=11, max_pts=48):
    """Seeded /report requests of 4-48 points (T=16 and T=64 buckets)."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        tr = generate_trace(city, f"rd-{len(out)}", rng, noise_m=4.0,
                            min_route_edges=4, max_route_edges=20)
        if tr is None or len(tr.points) < 4:
            continue
        out.append({"uuid": tr.uuid, "trace": tr.points[:max_pts],
                    "match_options": {"mode": "auto",
                                      "report_levels": [0, 1, 2],
                                      "transition_levels": [0, 1, 2]}})
    return out


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(
        np.uint32)


def _columns(city):
    """The float32 edge columns both kernels build (C++ arithmetic)."""
    v = np.maximum(np.asarray(city.edge_speed_kph, np.float32),
                   np.float32(1.0)) * (np.float32(1.0) / np.float32(3.6))
    e_len = np.asarray(city.edge_length_m, np.float32)
    heads = np.asarray(city.headings(), np.float32)
    return {"start": np.asarray(city.edge_start, np.int32),
            "end": np.asarray(city.edge_end, np.int32), "len": e_len,
            "v": v, "secs": e_len / v,
            "hx": np.ascontiguousarray(heads[:, 0]),
            "hy": np.ascontiguousarray(heads[:, 1])}


# -- the plain versions against the JAX programs ----------------------------
@pytest.mark.parametrize("max_iters,bound", [(64, 1500.0), (1, 1500.0),
                                             (3, 700.0), (64, 250.0)])
def test_relax_csr_bit_equal_to_jax(cities, max_iters, bound):
    city = cities[1]
    c = _columns(city)
    srcs = np.random.default_rng(5).integers(0, city.num_nodes, 16
                                             ).astype(np.int32)
    bound = np.float32(bound)
    want = jax_relax.relax_csr(
        jnp.asarray(c["start"]), jnp.asarray(c["end"]),
        jnp.asarray(c["len"]), jnp.asarray(c["secs"]), jnp.asarray(srcs),
        jnp.float32(bound), n_nodes=city.num_nodes, max_iters=max_iters)
    got = route_relax.relax_csr(
        *(torch.from_numpy(c[k]) for k in ("start", "end", "len", "secs")),
        torch.from_numpy(srcs), bound, n_nodes=city.num_nodes,
        max_iters=max_iters)
    assert np.array_equal(_bits(got[0]), _bits(want[0]))
    assert np.array_equal(_bits(got[1]), _bits(want[1]))
    assert (got[2], got[3]) == (int(want[2]), bool(want[3]))
    assert got[3] == (max_iters == 64)
    assert np.isfinite(got[0].numpy()).sum() > len(srcs)


def _pair_inputs(city, layout, seed, K=4, B=3, T=7):
    """Seeded candidate tensors with pads, dead steps and same-edge
    forward and backward pairs, and node kernels relaxed on the ``cached``
    (N, N) or the ``uncached`` (S, N) layout."""
    c = _columns(city)
    rng = np.random.default_rng(seed)
    E, N = city.num_edges, city.num_nodes
    edge = rng.integers(0, E, (B, T, K)).astype(np.int32)
    # a walk: the next point's first candidate continues from the last's
    for t in range(1, T):
        nxt = np.flatnonzero(c["start"] == c["end"][edge[0, t - 1, 0]])
        edge[0, t, 0] = nxt[rng.integers(len(nxt))]
    edge[:, 1:, 1] = edge[:, :1, 1]       # one edge at every point
    edge[rng.random(edge.shape) < 0.15] = PAD_EDGE
    offset = (rng.random((B, T, K)) * c["len"][np.maximum(edge, 0)]
              ).astype(np.float32)
    for t in range(1, T):  # along edge 1: 10 m back, then 5 m forward
        offset[:, t, 1] = np.clip(offset[:, t - 1, 1] + (-10 if t % 2 else 5),
                                  0, c["len"][np.maximum(edge[:, t, 1], 0)])
    nk = np.array([T, T - 2, 1], np.int32)[:B]
    gc = rng.uniform(20, 300, (B, T - 1))
    bounds = np.maximum(500.0, 5.0 * gc).astype(np.float32)
    caps = np.where(rng.random((B, T - 1)) < 0.7,
                    np.maximum(15.0, 2.0 * rng.uniform(0, 40, (B, T - 1))),
                    -1.0).astype(np.float32)
    live = edge[:, :-1] >= 0
    srcs = np.unique(c["end"][edge[:, :-1][live]]).astype(np.int32)
    dist, time, _it, ok = route_relax.relax_csr(
        *(torch.from_numpy(c[k]) for k in ("start", "end", "len", "secs")),
        torch.from_numpy(srcs), np.float32(bounds.max()), n_nodes=N,
        max_iters=N)
    assert ok
    node_row = np.full(N, -1, np.int32)
    if layout == "cached":
        full_d = torch.full((N, N), float("inf"))
        full_t = full_d.clone()
        full_d[torch.from_numpy(srcs).long()] = dist
        full_t[torch.from_numpy(srcs).long()] = time
        dist, time = full_d, full_t
        node_row[srcs] = srcs
    else:
        node_row[srcs] = np.arange(len(srcs), dtype=np.int32)
    return c, edge, offset, nk, bounds, caps, dist.numpy(), time.numpy(), \
        node_row


@pytest.mark.parametrize("layout", ["cached", "uncached"])
@pytest.mark.parametrize("tpen", [0.0, 0.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_pair_costs_bit_equal_to_jax(cities, layout, tpen, seed):
    city = cities[1]
    c, edge, offset, nk, bounds, caps, dist, time, node_row = _pair_inputs(
        city, layout, seed)
    btol = np.float32(25.0)
    args = (edge, offset, nk, bounds, caps, dist, time, node_row, c["start"],
            c["end"], c["len"], c["v"], c["hx"], c["hy"])
    want, want_max = jax_relax.pair_costs(
        *(jnp.asarray(a) for a in args), jnp.float32(btol),
        jnp.float32(tpen))
    got, got_max = route_relax.pair_costs(
        *(torch.from_numpy(a) for a in args), torch.tensor(btol),
        torch.tensor(np.float32(tpen)))
    assert np.array_equal(_bits(got), _bits(want))
    assert float(got_max) == float(want_max) > 0
    got = got.numpy()
    # the ladder's every case is reached: routed, capped or out of
    # bound, same-edge forward and backward, pads and dead steps
    same = edge[:, 1:, None, :] == edge[:, :-1, :, None]
    assert ((got > 0) & (got < UNREACH)).any() and (got == UNREACH).any()
    assert (same & (got == 0.0)).any() and (same & (got > 0)
                                            & (got < UNREACH)).any()
    assert (got[2] == UNREACH).all()  # nk = 1: every step dead
    # the packed entry unpacks to the same call
    B, T, K = edge.shape
    ints = np.concatenate([edge.ravel(), nk, node_row]).astype(np.int32)
    f32s = np.concatenate([offset.ravel(), bounds.ravel(), caps.ravel(),
                           np.array([btol, tpen], np.float32)])
    packed, packed_max = ops.route_pair_costs(
        torch.from_numpy(ints), torch.from_numpy(f32s),
        torch.from_numpy(dist), torch.from_numpy(time),
        *(torch.from_numpy(c[k]) for k in ("start", "end", "len", "v", "hx",
                                           "hy")),
        B=B, T=T, K=K, N=city.num_nodes)
    assert np.array_equal(_bits(packed), _bits(want))
    assert float(packed_max) == float(want_max)


def test_wrappers_refuse_cpu_tensors_and_cpu_takes_the_plain_versions(
        cities):
    city = cities[1]
    c = {k: torch.from_numpy(v) for k, v in _columns(city).items()}
    srcs = torch.tensor([0, 5], dtype=torch.int32)
    before = (route_relax.relax_cuda.launches,
              route_relax.relax_global_cuda.launches,
              route_relax.pair_costs_cuda.launches)
    arcs = route_relax.csr_arcs(*city.csr(), city.edge_end, c["len"].numpy(),
                                c["secs"].numpy(), "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        route_relax.relax_cuda(arcs, srcs, 900.0, n_nodes=city.num_nodes,
                               max_iters=4)
    with pytest.raises(ValueError, match="CUDA device"):
        route_relax.relax_global_cuda(arcs, srcs, 900.0,
                                      n_nodes=city.num_nodes, max_iters=4)
    with pytest.raises(ValueError, match="CUDA device"):
        route_relax.pair_costs_cuda(
            torch.zeros(8, dtype=torch.int32), torch.zeros(8),
            torch.zeros(1, city.num_nodes), torch.zeros(1, city.num_nodes),
            c["start"], c["end"], c["len"], c["v"], c["hx"], c["hy"],
            B=1, T=2, K=1, N=city.num_nodes)
    dist, _t, iters, ok = ops.relax_routes(
        c["start"], c["end"], c["len"], c["secs"], srcs, 900.0,
        n_nodes=city.num_nodes, max_iters=64)
    assert ok and iters > 1 and dist.device.type == "cpu"
    assert (route_relax.relax_cuda.launches,
            route_relax.relax_global_cuda.launches,
            route_relax.pair_costs_cuda.launches) == before


# -- the card's relaxation: its frontier, its plan, its budget ---------------
def _osm_town():
    """The generated OSM town through the port's importer, its columns
    held equal to the JAX package's import of the same bytes."""
    import io
    from reporter_tpu.graph.osm import network_from_osm_xml as jax_osm
    from reporter_tpu.tools.osm_fixture import build_city_xml as jax_xml
    from reporter_tpu_torch.graph.network import COLUMNS
    from reporter_tpu_torch.graph.osm import network_from_osm_xml
    from reporter_tpu_torch.tools.osm_fixture import build_city_xml
    ref = jax_osm(io.BytesIO(jax_xml().encode()))
    town = network_from_osm_xml(io.BytesIO(build_city_xml().encode()))
    for name in COLUMNS:
        got, want = getattr(town, name), getattr(ref, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert town.segment_length_m == ref.segment_length_m
    return town


@pytest.fixture(scope="module")
def relax_cities(cities):
    return {"grid8": cities[1],
            "grid20": build_grid_city(rows=20, cols=20, spacing_m=200.0,
                                      seed=42),
            "osm": _osm_town()}


def _pack(d, t):
    return (d.view(torch.int32).long() << 32) | t.view(torch.int32).long()


def _unpack(w):
    return ((w >> 32).to(torch.int32).view(torch.float32),
            (w & 0xFFFFFFFF).to(torch.int32).view(torch.float32))


def frontier_relax(net, cols, srcs, bound, max_iters):
    """The ``relax`` kernel's algorithm in plain PyTorch, one source row at
    a time: packed (dist, time) words, double-buffered; each sweep copies
    the frontier (the words that differ between the buffers) into the
    write buffer, relaxes only the frontier's out-arcs in ``csr()`` order
    with a scatter-min, and stops on a sweep that lowers nothing.
    Returns (dist, time, iters, converged) as ``relax_csr``."""
    offsets, order = net.csr()
    N = net.num_nodes
    start = torch.from_numpy(np.repeat(np.arange(N), np.diff(offsets)))
    end = torch.from_numpy(cols["end"][order].astype(np.int64))
    length = torch.from_numpy(cols["len"][order])
    secs = torch.from_numpy(cols["secs"][order])
    bound = torch.tensor(np.float32(bound))
    dist, time, iters, converged = [], [], 0, True
    for src in srcs:
        cur = torch.full((N,), route_relax.UNREACHED, dtype=torch.int64)
        cur[int(src)] = 0
        nxt = torch.full_like(cur, route_relax.UNREACHED)
        k, quiet = 0, False
        while k < max_iters:
            front = cur != nxt
            nxt = torch.where(front, cur, nxt)
            arcs = front[start]
            d, t = _unpack(cur[start[arcs]])
            cd = d + length[arcs]
            ok = cd <= bound
            cand = _pack(cd[ok], (t + secs[arcs])[ok])
            new = nxt.scatter_reduce(0, end[arcs][ok], cand, "amin",
                                     include_self=True)
            k += 1
            lowered = bool((new < nxt).any())
            nxt = new
            if not lowered:
                quiet = True
                break
            cur, nxt = nxt, cur
        iters, converged = max(iters, k), converged and quiet
        d, t = _unpack(cur)
        dist.append(d)
        time.append(t)
    return torch.stack(dist), torch.stack(time), iters, converged


@pytest.mark.parametrize("name", ["grid8", "grid20", "osm"])
@pytest.mark.parametrize("bound,cap", [(250.0, None), (1500.0, None),
                                       (6000.0, None), (1500.0, 2)])
def test_frontier_relaxation_bit_equal_to_jax(relax_cities, name, bound,
                                              cap):
    """Relaxing only the frontier's arcs, a row at a time, gives the JAX
    all-edges Jacobi loop's bits, sweep count and convergence, also with
    a cap that stops it short (every row, and the largest count)."""
    net = relax_cities[name]
    c = _columns(net)
    srcs = np.random.default_rng(9).choice(net.num_nodes, 12,
                                           replace=False).astype(np.int32)
    srcs[-1] = srcs[0]  # a repeated row, as the padding makes
    max_iters = net.num_nodes if cap is None else cap
    want = jax_relax.relax_csr(
        jnp.asarray(c["start"]), jnp.asarray(c["end"]),
        jnp.asarray(c["len"]), jnp.asarray(c["secs"]), jnp.asarray(srcs),
        jnp.float32(bound), n_nodes=net.num_nodes, max_iters=max_iters)
    got = frontier_relax(net, c, srcs, bound, max_iters)
    assert np.array_equal(_bits(got[0]), _bits(want[0]))
    assert np.array_equal(_bits(got[1]), _bits(want[1]))
    assert (got[2], got[3]) == (int(want[2]), bool(want[3]))
    assert got[3] == (cap is None) and got[2] > 1


def test_relax_kernel_choice_by_n_and_its_block_plan():
    """``relax`` takes a graph while a row's two packed states (16 bytes a
    node) fit one Hopper block's 232,448 bytes of shared memory: 14,528
    nodes; ``relax_cluster`` from the node past it, its rows split over a
    cluster of 2 to 8 blocks, up to 116,216 nodes; ``relax_global`` past
    that. The block plan keeps a thread's nodes within its 64 frontier
    bits."""
    most = route_relax.SMEM_LIMIT // route_relax.RELAX_NODE_BYTES
    assert most == 14_528
    assert route_relax.relax_fits(most) and not route_relax.relax_fits(
        most + 1)
    assert route_relax.relax_kernel_for(most) == "relax"
    assert route_relax.relax_kernel_for(most + 1) == "relax_cluster"
    assert route_relax.relax_kernel_for(100 * 100) == "relax"
    assert route_relax.relax_kernel_for(125 * 125) == "relax_cluster"
    assert route_relax.cluster_width(125 * 125) == 2
    last = route_relax.CLUSTER_MAX_NODES
    assert route_relax.relax_kernel_for(last) == "relax_cluster"
    assert route_relax.relax_kernel_for(last + 1) == "relax_global"
    assert route_relax.relax_kernel_for(512 * 512) == "relax_global"
    plans = {n: route_relax.relax_threads(n)
             for n in (1, 64, 400, 1600, 2000, 8192, 10_000, most)}
    assert plans == {1: 128, 64: 128, 400: 128, 1600: 256, 2000: 256,
                     8192: 1024, 10_000: 1024, most: 1024}
    for n, threads in plans.items():
        assert threads % 32 == 0 and -(-n // threads) <= 64
    # the CPU takes the plain version whatever N; the card's choice is
    # made once, from N, when the kernel is built
    assert DeviceRouteKernel(build_grid_city(rows=3, cols=3, seed=1),
                             "cpu").relax_kernel == "plain"


def test_relaxation_budget_per_device_and_kernel():
    """What a chunk's relaxation allocates, against its device's ceiling:
    the reference's (S, max(N, E)) gathers on the CPU; on the card the
    (S, N) f32 planes, and for relax_global its blocks' scratch slots too
    (two packed N-word buffers and three N-entry int32 lists a block, a
    block a row until the slots would pass 1 GiB)."""
    S, N, E = 2048, 10_000, 39_600
    assert route_device.relax_bytes(S, N, E, "cpu", "plain") \
        == 2 * 4 * S * E
    assert route_device.relax_bytes(S, N, E, "cuda", "relax") \
        == 8 * S * N == 163_840_000
    assert route_relax.global_blocks(S, N) == S
    assert route_device.relax_bytes(S, N, E, "cuda", "relax_global") \
        == (8 + 16 + 12) * S * N
    # the 100x100 city's chunk: over the CPU's ceiling, inside the card's
    assert route_device.over_budget(S, N, E, "cpu", "plain")
    assert not route_device.over_budget(S, N, E, "cuda", "relax")
    assert not route_device.over_budget(S, N, E, "cuda", "relax_global")
    # the CPU's ceiling is the reference's 64M-element check, exactly
    edge = 64 * 1024 * 1024 // (2 * E)
    assert not route_device.over_budget(edge, N, E, "cpu", "plain")
    assert route_device.over_budget(edge + 1, N, E, "cpu", "plain")
    # the card's is 4 GiB of what relax and relax_global allocate
    edge = 4 * 2**30 // (8 * N)
    assert not route_device.over_budget(edge, N, E, "cuda", "relax")
    assert route_device.over_budget(edge + 1, N, E, "cuda", "relax")
    # relax_global's slots stop at 1 GiB (3,834 blocks of 10,000 nodes),
    # so past that S adds the planes alone
    G = 2**30 // (28 * N)
    assert route_relax.global_blocks(10 * G, N) == G
    edge = (4 * 2**30 - 28 * G * N) // (8 * N)
    assert not route_device.over_budget(edge, N, E, "cuda", "relax_global")
    assert route_device.over_budget(edge + 1, N, E, "cuda", "relax_global")
    # metro graphs' chunks of S = 128: at 1,398,000 nodes (the most that
    # per-sweep launches' 24*S*N bytes took) 27 blocks take the rows in
    # turn, in fewer bytes; at 3 million nodes 12 blocks still fit
    S = 128
    for N, G in ((1_398_000, 27), (3_000_000, 12)):
        assert route_relax.global_blocks(S, N) == G == 2**30 // (28 * N)
        assert route_device.relax_bytes(S, N, 4 * N, "cuda",
                                        "relax_global") \
            == 8 * S * N + 28 * G * N
        assert not route_device.over_budget(S, N, 4 * N, "cuda",
                                            "relax_global")
    assert 8 * S * 1_398_000 + 28 * 27 * 1_398_000 < 24 * S * 1_398_000
    # relax_cluster keeps its state in the cluster's shared memory: the
    # planes alone, as relax (the 125x125 city's chunk, S = 1,024)
    S, N, E = 1024, 125 * 125, 62_000
    assert route_device.relax_bytes(S, N, E, "cuda", "relax_cluster") \
        == 8 * S * N == 128_000_000
    assert not route_device.over_budget(S, N, E, "cuda", "relax_cluster")
    edge = 4 * 2**30 // (8 * N)
    assert not route_device.over_budget(edge, N, E, "cuda", "relax_cluster")
    assert route_device.over_budget(edge + 1, N, E, "cuda", "relax_cluster")


def test_relax_refuses_a_graph_past_shared_memory(cities):
    city = cities[1]
    c = _columns(city)
    arcs = route_relax.csr_arcs(*city.csr(), c["end"], c["len"], c["secs"],
                                "cpu")
    assert arcs.offsets.dtype == torch.int32
    assert np.array_equal(arcs.end.numpy(), c["end"][city.csr()[1]])
    with pytest.raises(ValueError, match="at most 14528 nodes"):
        route_relax.relax_cuda(arcs, torch.tensor([0], dtype=torch.int32),
                               900.0, n_nodes=14_529, max_iters=4)
    with pytest.raises(ValueError, match="CSR arcs do not fit"):
        route_relax.relax_cuda(arcs, torch.tensor([0], dtype=torch.int32),
                               900.0, n_nodes=city.num_nodes + 1,
                               max_iters=4)


@pytest.mark.parametrize("n,width", [
    (14_529, 2), (125 * 125, 2), (29_054, 2), (29_055, 3), (200 * 200, 3),
    (58_108, 4), (100_000, 7), (116_216, 8), (116_217, 0)])
def test_cluster_width_is_the_fewest_blocks_whose_slices_fit(n, width):
    """A block of ``relax_cluster`` holds its slice of ceil(N/C) nodes (16
    bytes each) and 16 bytes of flags: C is the fewest blocks, 2 to 8,
    that fit 232,448 bytes, 0 past 8 x 14,527 nodes."""
    assert route_relax.cluster_width(n) == width
    if width:
        assert route_relax.cluster_smem(n, width) <= route_relax.SMEM_LIMIT
        assert width == 2 or route_relax.cluster_smem(n, width - 1) \
            > route_relax.SMEM_LIMIT
    assert route_relax.cluster_smem(125 * 125, 2) == 16 * 7_813 + 16
    assert route_relax.CLUSTER_MAX_NODES == 8 * 14_527 == 116_216


def test_relax_cluster_refuses_cpu_tensors_and_graphs_past_a_cluster(cities):
    city = cities[1]
    c = _columns(city)
    arcs = route_relax.csr_arcs(*city.csr(), c["end"], c["len"], c["secs"],
                                "cpu")
    src = torch.tensor([0], dtype=torch.int32)
    before = route_relax.relax_cluster_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        route_relax.relax_cluster_cuda(arcs, src, 900.0,
                                       n_nodes=city.num_nodes, max_iters=4)
    with pytest.raises(ValueError, match="at most 116216 nodes"):
        route_relax.relax_cluster_cuda(arcs, src, 900.0, n_nodes=116_217,
                                       max_iters=4)
    with pytest.raises(ValueError, match="CSR arcs do not fit"):
        route_relax.relax_cluster_cuda(arcs, src, 900.0, n_nodes=40_000,
                                       max_iters=4)
    assert route_relax.relax_cluster_cuda.launches == before


def cluster_relax(start, end, length, secs, n_nodes, srcs, bound, max_iters,
                  width):
    """``relax_cluster``'s schedule in plain PyTorch, one source row at a
    time: the row's packed words split into ``width`` slices of ceil(N /
    width) nodes, block r owning slice r. A sweep: every block copies its
    slice's frontier (where cur differs from nxt) into nxt; rank 0 clears
    the other parity's flag; every block relaxes its frontier's out-arcs
    in CSR order and min's each admitted candidate into the nxt slice of
    the block that owns the arc's end, setting this parity's flag if a
    word fell; a quiet flag ends the row. Returns (dist, time, iters,
    converged) as ``relax_csr``."""
    N = n_nodes
    L = -(-N // width)
    order = np.argsort(start, kind="stable")        # arcs by start node
    offsets = np.searchsorted(start[order], np.arange(N + 1))
    a_end = torch.from_numpy(end[order].astype(np.int64))
    a_len = torch.from_numpy(length[order])
    a_secs = torch.from_numpy(secs[order])
    bound = torch.tensor(np.float32(bound))
    lo = [r * L for r in range(width)]
    own = [max(0, min(L, N - lo[r])) for r in range(width)]
    dist, time, iters, converged = [], [], 0, True
    for src in srcs:
        cur = [torch.full((own[r],), route_relax.UNREACHED,
                          dtype=torch.int64) for r in range(width)]
        nxt = [x.clone() for x in cur]
        cur[int(src) // L][int(src) % L] = 0
        flags, parity, k, quiet = [0, 0], 0, 0, False
        while k < max_iters:
            fronts = []
            for r in range(width):   # each block, then cluster.sync()
                front = cur[r] != nxt[r]
                nxt[r] = torch.where(front, cur[r], nxt[r])
                fronts.append(torch.nonzero(front).flatten())
            flags[parity ^ 1] = 0
            for r in range(width):   # each block, then cluster.sync()
                nodes = (fronts[r] + lo[r]).numpy()
                arcs = torch.from_numpy(np.concatenate(
                    [np.arange(offsets[n], offsets[n + 1]) for n in nodes]
                    + [np.zeros(0, np.int64)]).astype(np.int64))
                d, t = _unpack(cur[r][torch.from_numpy(
                    np.repeat(nodes - lo[r], np.diff(offsets)[nodes]))])
                cd = d + a_len[arcs]
                ok = cd <= bound
                cand = _pack(cd[ok], (t + a_secs[arcs])[ok])
                v = a_end[arcs][ok]
                owner = v // L
                for o in range(width):   # atomicMin into the owner's nxt
                    mine = owner == o
                    if not bool(mine.any()):
                        continue
                    new = nxt[o].scatter_reduce(0, v[mine] - lo[o],
                                                cand[mine], "amin",
                                                include_self=True)
                    if bool((new < nxt[o]).any()):
                        flags[parity] = 1
                    nxt[o] = new
            k += 1
            if not flags[parity]:
                quiet = True
                break
            cur, nxt = nxt, cur
            parity ^= 1
        iters, converged = max(iters, k), converged and quiet
        d, t = _unpack(torch.cat(cur))
        dist.append(d)
        time.append(t)
    return torch.stack(dist), torch.stack(time), iters, converged


@pytest.fixture(scope="module")
def cluster_graphs(relax_cities):
    """The 20x20 city's columns, and the same graph with its node ids
    shuffled, so that most arcs cross slices."""
    net = relax_cities["grid20"]
    c = _columns(net)
    perm = np.random.default_rng(12).permutation(net.num_nodes)
    shuffled = dict(c, start=perm[c["start"]].astype(np.int32),
                    end=perm[c["end"]].astype(np.int32))
    return {"grid20": (c, net.num_nodes), "shuffled": (shuffled,
                                                       net.num_nodes)}


@pytest.mark.parametrize("graph", ["grid20", "shuffled"])
@pytest.mark.parametrize("width", [2, 3, 4])
@pytest.mark.parametrize("cap", [None, 1, "short"])
def test_cluster_schedule_bit_equal_to_relax_csr(cluster_graphs, graph,
                                                 width, cap):
    """Slicing the rows over a cluster changes no candidate, no min and no
    sweep count: ``relax_cluster``'s schedule gives the plain
    ``relax_csr``'s dist, time, iters and converged bit for bit, at
    convergence, capped at one sweep and one sweep short of it."""
    c, N = cluster_graphs[graph]
    L = -(-N // width)
    crossing = np.mean(c["start"] // L != c["end"] // L)
    assert crossing > (0.5 if graph == "shuffled" else 0.0)
    srcs = np.random.default_rng(21).choice(N, 10, replace=False).astype(
        np.int32)
    srcs[-1] = srcs[0]  # a repeated row, as the padding makes
    bound = np.float32(1500.0)
    cols = [torch.from_numpy(c[k]) for k in ("start", "end", "len", "secs")]
    full = route_relax.relax_csr(*cols, torch.from_numpy(srcs), bound,
                                 n_nodes=N, max_iters=N)
    assert full[3] and full[2] > 2
    max_iters = {None: N, 1: 1, "short": full[2] - 1}[cap]
    want = full if cap is None else route_relax.relax_csr(
        *cols, torch.from_numpy(srcs), bound, n_nodes=N, max_iters=max_iters)
    got = cluster_relax(c["start"], c["end"], c["len"], c["secs"], N, srcs,
                        bound, max_iters, width)
    assert np.array_equal(_bits(got[0]), _bits(want[0]))
    assert np.array_equal(_bits(got[1]), _bits(want[1]))
    assert (got[2], got[3]) == (want[2], want[3])
    assert got[3] == (cap is None)


def test_packed_state_orders_as_dist_then_time():
    """The kernel's word: float bits of (dist, time), high and low; their
    integer order is the lexicographic order of the pairs. A new
    ``relax_global`` scratch holds every word unreached, and grows, never
    shrinks, with the blocks*N asked of it; each device has one."""
    pairs = np.array([[0.0, 0.0], [0.0, 3.5], [1.0, 0.0], [1.0, 2.0],
                      [700.25, 1e-3], [np.inf, np.inf]], np.float32)
    words = (pairs[:, 0].view(np.uint32).astype(np.uint64) << np.uint64(32)
             ) | pairs[:, 1].view(np.uint32).astype(np.uint64)
    assert np.all(np.diff(words.astype(np.float64)) > 0)
    assert int(words[-1]) == route_relax.UNREACHED
    state = torch.from_numpy(words.astype(np.int64)).reshape(2, 3)
    dist, time = _unpack(state)
    assert np.array_equal(_bits(dist).ravel(), _bits(pairs[:, 0]))
    assert np.array_equal(_bits(time).ravel(), _bits(pairs[:, 1]))
    assert torch.equal(_pack(dist, time), state)
    scratch = route_relax.GlobalScratch()
    w, lists = scratch.take(2, 3, torch.device("cpu"))
    assert w.dtype == torch.int64 and tuple(w.shape) == (12,)
    assert bool((w == route_relax.UNREACHED).all())
    assert lists.dtype == torch.int32 and tuple(lists.shape) == (18,)
    assert scratch.take(1, 5, torch.device("cpu"))[0] is w  # fits: kept
    assert scratch.take(4, 3, torch.device("cpu"))[0].numel() == 24
    assert route_relax.GLOBAL_NODE_BYTES == 2 * 8 + 3 * 4
    assert route_relax.global_scratch("cpu") is \
        route_relax.global_scratch(torch.device("cpu"))


def global_relax(start, end, length, secs, n_nodes, srcs, bound, max_iters,
                 scratch, seed=0):
    """``relax_global``'s schedule in plain numpy, one source row at a time,
    the atomics in a seeded order: ``scratch`` ((G, 2, N) uint64, every
    word unreached before and after) holds G blocks' slots, and row s
    runs in slot s % G, the block that strides over it, after the rows
    before it there; the row's two packed buffers are its slot's;
    the frontier an explicit list, the source first; a sweep copies the
    previous frontier's words into nxt (the buffers then equal), relaxes
    the frontier's out-arcs in CSR order with a min into nxt, and puts an
    arc's end on the next frontier only when its min lowered the word the
    node had at the sweep's start (its first lowerer), and on the reached
    list when that word was unreached; an empty next frontier ends the
    row. The planes start at +inf and take the source's and the reached
    nodes' final words, and those words of both buffers go back to
    unreached. Returns (dist, time, iters, converged) as ``relax_csr``."""
    N = n_nodes
    order = np.argsort(start, kind="stable")        # arcs by start node
    offsets = np.searchsorted(start[order], np.arange(N + 1))
    a_end = end[order].astype(np.int64)
    a_len = length[order]
    a_secs = secs[order]
    bound = np.float32(bound)
    unreached = np.uint64(route_relax.UNREACHED)
    rng = np.random.default_rng(seed)

    def word(d, t):
        return np.uint64((int(np.float32(d).view(np.uint32)) << 32)
                         | int(np.float32(t).view(np.uint32)))

    def pair(w):
        bits = np.array([int(w) >> 32, int(w) & 0xFFFFFFFF], np.uint32)
        return bits.view(np.float32)

    dist = np.full((len(srcs), N), np.inf, np.float32)
    time = dist.copy()
    iters, converged = 0, True
    for s, src in enumerate(srcs):
        cur, nxt = scratch[s % len(scratch), 0], scratch[s % len(scratch), 1]
        assert (cur == unreached).all() and (nxt == unreached).all()
        src = int(src)
        cur[src] = 0
        front, reached = [src], []
        k, quiet = 0, False
        while k < max_iters:
            for n in front:
                nxt[n] = cur[n]
            assert np.array_equal(nxt, cur)
            after = []
            for n in rng.permutation(front):
                d, t = pair(cur[n])
                for a in range(offsets[n], offsets[n + 1]):
                    cd = d + a_len[a]
                    if not cd <= bound:  # the admission rule
                        continue
                    cand = word(cd, t + a_secs[a])
                    v = a_end[a]
                    old = nxt[v]
                    if not cand < old:
                        continue
                    nxt[v] = cand    # atomicMin's lowering; it returned old
                    if old == cur[v]:
                        after.append(v)
                        if old == unreached:
                            reached.append(v)
            k += 1
            if not after:
                quiet = True
                break
            assert len(set(after)) == len(after) <= N  # once a sweep
            cur, nxt = nxt, cur
            front = after
        assert len(set(reached)) == len(reached) < N and src not in reached
        iters, converged = max(iters, k), converged and quiet
        for v in [src, *reached]:
            dist[s, v], time[s, v] = pair(cur[v])
            cur[v] = nxt[v] = unreached
    return dist, time, iters, converged


@pytest.mark.parametrize("graph", ["grid8", "grid20", "shuffled", "osm"])
@pytest.mark.parametrize("cap", [None, 1, "short"])
def test_global_schedule_bit_equal_to_relax_csr(relax_cities, cluster_graphs,
                                                graph, cap):
    """The explicit frontier list, its sparse copy and the first-lowerer
    rule change no candidate, no min and no sweep count: ``relax_global``'s
    schedule gives the JAX ``relax_csr``'s and the plain ``relax_csr``'s
    dist, time, iters and converged bit for bit, at convergence, capped at
    one sweep and one sweep short of it, and leaves its scratch unreached
    for the next relaxation."""
    if graph == "shuffled":
        c, N = cluster_graphs["shuffled"]
    else:
        c, N = _columns(relax_cities[graph]), relax_cities[graph].num_nodes
    srcs = np.random.default_rng(23).choice(N, 10, replace=False).astype(
        np.int32)
    srcs[-1] = srcs[0]  # a repeated row, as the padding makes
    bound = np.float32(1500.0)
    cols = [torch.from_numpy(c[k]) for k in ("start", "end", "len", "secs")]
    full = route_relax.relax_csr(*cols, torch.from_numpy(srcs), bound,
                                 n_nodes=N, max_iters=N)
    assert full[3] and full[2] > 2
    max_iters = {None: N, 1: 1, "short": full[2] - 1}[cap]
    want = full if cap is None else route_relax.relax_csr(
        *cols, torch.from_numpy(srcs), bound, n_nodes=N, max_iters=max_iters)
    ref = jax_relax.relax_csr(
        *(jnp.asarray(c[k]) for k in ("start", "end", "len", "secs")),
        jnp.asarray(srcs), jnp.float32(bound), n_nodes=N, max_iters=max_iters)
    scratch = np.full((len(srcs), 2, N), route_relax.UNREACHED, np.uint64)
    got = global_relax(c["start"], c["end"], c["len"], c["secs"], N, srcs,
                       bound, max_iters, scratch)
    assert (scratch == np.uint64(route_relax.UNREACHED)).all()
    for w in (want, ref):
        assert np.array_equal(_bits(got[0]), _bits(w[0]))
        assert np.array_equal(_bits(got[1]), _bits(w[1]))
        assert (got[2], got[3]) == (int(w[2]), bool(w[3]))
    assert got[3] == (cap is None)


@pytest.mark.parametrize("graph", ["grid20", "shuffled", "osm"])
@pytest.mark.parametrize("blocks", [1, 3])
def test_global_blocks_take_rows_in_turn(relax_cities, cluster_graphs, graph,
                                         blocks):
    """Fewer blocks than rows (``global_blocks`` past its scratch budget,
    or forced): each block's slot serves its rows one after another,
    reset exactly by each, and the planes, iters and converged are the
    plain ``relax_csr``'s bit for bit, at convergence and one sweep
    short."""
    if graph == "shuffled":
        c, N = cluster_graphs["shuffled"]
    else:
        c, N = _columns(relax_cities[graph]), relax_cities[graph].num_nodes
    srcs = np.random.default_rng(29).choice(N, 8, replace=False).astype(
        np.int32)
    bound = np.float32(1500.0)
    cols = [torch.from_numpy(c[k]) for k in ("start", "end", "len", "secs")]
    full = route_relax.relax_csr(*cols, torch.from_numpy(srcs), bound,
                                 n_nodes=N, max_iters=N)
    for max_iters in (N, full[2] - 1):
        want = route_relax.relax_csr(*cols, torch.from_numpy(srcs), bound,
                                     n_nodes=N, max_iters=max_iters)
        scratch = np.full((blocks, 2, N), route_relax.UNREACHED, np.uint64)
        got = global_relax(c["start"], c["end"], c["len"], c["secs"], N,
                           srcs, bound, max_iters, scratch, seed=blocks)
        assert (scratch == np.uint64(route_relax.UNREACHED)).all()
        assert np.array_equal(_bits(got[0]), _bits(want[0]))
        assert np.array_equal(_bits(got[1]), _bits(want[1]))
        assert (got[2], got[3]) == (int(want[2]), bool(want[3]))


def test_global_scratch_serves_one_relaxation_at_a_time(cities, monkeypatch):
    """``relax_global_cuda`` holds its device's scratch's lock from the
    launch to the read of its info, so relaxations from many threads over
    the one kept scratch never overlap (here a stand-in launch on CPU
    tensors dirties the words, yields and restores them, as the kernel
    does), and each finds every word unreached."""
    import sys
    import threading
    city = cities[1]
    c = _columns(city)
    arcs = route_relax.csr_arcs(*city.csr(), c["end"], c["len"], c["secs"],
                                "cpu")
    monkeypatch.setattr(route_relax, "_scratches", {})
    seen = []

    def launch(arcs, src, bound, max_iters, dist, time, info, blocks=None):
        words, _lists = route_relax.global_scratch(dist.device).take(
            route_relax.global_blocks(*dist.shape), dist.shape[1],
            dist.device)
        seen.append(bool((words == route_relax.UNREACHED).all()))
        words[:len(src)] = 0
        threading.Event().wait(0.001)
        words[:len(src)] = route_relax.UNREACHED
        dist.fill_(0.0)
        time.fill_(0.0)
        info[0] = 1

    monkeypatch.setattr(route_relax, "_check_arcs",
                        lambda arcs, src, n: torch.device("cpu"))
    monkeypatch.setattr(route_relax, "launch_relax_global", launch)
    monkeypatch.setattr(route_relax.relax_global_cuda, "launches", 0)
    monkeypatch.setattr(route_relax.relax_global_cuda, "reads", 0)
    src = torch.tensor([0, 5, 9], dtype=torch.int32)
    workers = 2 * (os.cpu_count() or 1) + 1
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            route_relax.relax_global_cuda(arcs, src, 900.0,
                                          n_nodes=city.num_nodes,
                                          max_iters=4)
            for _ in range(4)]) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert len(seen) == 4 * workers and all(seen)
    assert list(route_relax._scratches) == [torch.device("cpu")]
    assert route_relax.relax_global_cuda.launches == 4 * workers
    assert route_relax.relax_global_cuda.reads == 4 * workers


def test_the_dsmem_probe_needs_the_card_and_mirrors_the_kernel(capsys):
    """The DSMEM atomics probe (``analysis/dsmem_atomics.py``) refuses to
    run without CUDA, builds nothing at import, and its ``min/cas`` way
    is ``relax_cluster``'s: a CAS loop whose first guess is the unreached
    word the kernel starts every node at."""
    from reporter_tpu_torch.analysis import dsmem_atomics
    assert dsmem_atomics.main([]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err
    assert dsmem_atomics.UNREACHED == route_relax.UNREACHED
    assert "0x7F8000007F800000ull" in dsmem_atomics.SOURCE
    src = route_relax.SOURCE.read_text()
    assert "unsigned long long old = kUnreached;" in src
    assert "unsigned long long old = kUnreached;" in dsmem_atomics.SOURCE
    assert dsmem_atomics.MODES[2] == "min/cas"


# -- DeviceRouteKernel ------------------------------------------------------
def _pick_edges(city):
    """(e0, e1, e_far): an edge, a continuation out of its end node that
    is not its reverse, and an edge starting far (> the 500 m floor) from
    e0's end node."""
    e_start, e_end = np.asarray(city.edge_start), np.asarray(city.edge_end)
    e0 = int(np.argmax(np.asarray(city.edge_length_m) >= 60.0))
    nxt = np.flatnonzero(e_start == e_end[e0])
    e1 = int(nxt[0] if e_end[nxt[0]] != e_start[e0] else nxt[-1])
    lat, lon = np.asarray(city.node_lat), np.asarray(city.node_lon)
    d2 = (lat[e_start] - lat[e_end[e0]]) ** 2 \
        + (lon[e_start] - lon[e_end[e0]]) ** 2
    return e0, e1, int(np.argmax(d2))


def _crafted(city, case):
    """The reference's crafted (T=4, K=2) candidate set (backward within
    tolerance, same-edge forward, an adjacent routable pair, far pairs
    out of bound, a pad slot) and its variants."""
    e0, e1, e_far = _pick_edges(city)
    edge = np.array([[e0, e0], [e0, e1], [e_far, PAD_EDGE], [e0, e1]],
                    np.int32)
    offset = np.array([[50.0, 10.0], [30.0, 30.0], [5.0, 0.0],
                       [20.0, 40.0]], np.float32)
    gc = np.array([30.0, 40.0, 30.0], np.float32)
    kw = {}
    if case == "zero_length":
        offset[1, 0] = offset[0, 0]
    elif case == "time_cap":
        offset[1, 0] = offset[0, 0]
        kw = dict(dt=np.array([0.1, 0.1, 0.1]), max_route_time_factor=2.0,
                  min_time_bound_s=1.0)
    elif case == "backward_loop":
        edge, offset = edge[:2, :1], np.array([[50.0], [10.0]], np.float32)
        gc = gc[:1]
    elif case == "all_pad":
        edge = np.full((3, 2), PAD_EDGE, np.int32)
        offset = np.zeros((3, 2), np.float32)
        gc = np.zeros(2, np.float32)
    elif case == "turn_penalty":
        kw = dict(turn_penalty_factor=40.0)
    z = np.zeros_like(offset)
    return CandidateSet(edge_ids=edge, dist_m=z + 1.0, offset_m=offset,
                        proj_x=z, proj_y=z), gc, kw


@pytest.mark.parametrize("case", ["distance", "zero_length", "time_cap",
                                  "backward_loop", "all_pad",
                                  "turn_penalty"])
def test_route_matrices_equal_jax_kernel_and_host(cities, kernels, case):
    city = cities[1]
    cands, gc, kw = _crafted(city, case)
    kw.setdefault("backward_tolerance_m", 25.0)
    got = kernels[1].route_matrices(cands, gc, **kw)
    assert got.dtype == np.float32 and got.shape == (
        len(gc), cands.edge_ids.shape[1], cands.edge_ids.shape[1])
    assert got.tobytes() == kernels[0].route_matrices(cands, gc,
                                                      **kw).tobytes()
    assert got.tobytes() == candidate_route_matrices(city, cands, gc,
                                                     **kw).tobytes()
    if case == "distance":
        assert got[0, 0, 0] == 0.0 and got[0, 1, 0] == np.float32(20.0)
        assert (got[1] == UNREACH).all() and (got[2] == UNREACH).all()
    if case == "backward_loop":
        assert 0.0 < got[0, 0, 0] < UNREACH
    if case == "time_cap":
        assert got[0, 0, 0] == 0.0 and got[0, 0, 1] == UNREACH
    if case == "all_pad":
        assert (got == UNREACH).all()


def _native_chunk(city, reqs):
    tb = TraceBatch.from_requests(reqs)
    return tb, max(bucket_length(int(n)) for n in tb.lengths())


@pytest.fixture(scope="module")
def matcher(cities):
    return SegmentMatcher(cities[1], PARAMS, device="cpu")


@pytest.mark.parametrize("n,pad_rows", [(6, None), (5, 8)])
def test_chunk_equals_host_prep(cities, matcher, n, pad_rows):
    """prepare_batch(route_kernel=...) writes the host prep's bytes into
    every tensor (filler rows and the dead step included), before and
    after the wire cast, deferred as synchronous."""
    city = cities[1]
    kernel = DeviceRouteKernel(city, "cpu")
    tb, T = _native_chunk(city, _reqs(city, n=n))
    host = prepare_batch(matcher.runtime, tb, PARAMS, T, pad_rows=pad_rows)
    dev = prepare_batch(matcher.runtime, tb, PARAMS, T, pad_rows=pad_rows,
                        route_kernel=kernel)
    metrics.default.reset()
    deferred = prepare_batch(matcher.runtime, tb, PARAMS, T,
                             pad_rows=pad_rows, route_kernel=kernel,
                             defer_routes=True)
    # the synchronous call warmed the cache: the deferred chunk relaxed
    # nothing and left its route tensor for the decode stage
    snap = metrics.snapshot()["counters"]
    assert snap.get("route.device.deferred_chunks") == 1
    assert snap.get("route.device.relaxes", 0) == 0
    assert deferred.route_m is None and deferred.finalize is not None
    deferred.finalize_wire()
    assert deferred.finalize is None
    deferred.routes_to_host()
    for got in (dev, deferred):
        for k, want in host.prep.items():
            if k != "phase_ns":
                assert want.tobytes() == got.prep[k].tobytes(), k
        route = got.route_m
        if isinstance(route, torch.Tensor):
            route = route.numpy()
        assert route.dtype == host.route_m.dtype == np.float16
        assert route.tobytes() == host.route_m.tobytes()
        assert got.dist_m.tobytes() == host.dist_m.tobytes()
        assert got.gc_m.tobytes() == host.gc_m.tobytes()
    rows = host.prep["route_m"].shape[0]
    assert rows == (pad_rows or n)
    assert (dev.prep["route_m"][n:] == UNREACH).all()
    assert (dev.prep["route_m"][:, T - 1] == UNREACH).all()
    deferred.finalize_wire()  # a no-op the second time
    assert [t.num_kept for t in dev.traces] == \
        [t.num_kept for t in host.traces]


def test_chunk_equals_jax_device_prep(cities, kernels):
    """The port's device-filled chunk equals the JAX package's, each
    through its own native runtime and kernel."""
    from reporter_tpu import native as jax_native
    from reporter_tpu.matcher.batchpad import prepare_batch as jax_prepare
    from reporter_tpu_torch.native import NativeRuntime
    from reporter_tpu_torch.matcher.matcher import GRID_CELL_M
    ref_city, city = cities
    reqs = _reqs(city, n=5, seed=23)
    tb, T = _native_chunk(city, reqs)
    jax_rt = jax_native.NativeRuntime(ref_city, cell_m=GRID_CELL_M)
    want = jax_prepare(jax_rt, [r["trace"] for r in reqs],
                       JaxParams(max_candidates=8), T, pad_rows=8,
                       route_kernel=kernels[0])
    got = prepare_batch(NativeRuntime(city, cell_m=GRID_CELL_M), tb, PARAMS,
                        T, pad_rows=8, route_kernel=kernels[1])
    for k in ("route_m", "max_finite", "edge_ids", "dt"):
        assert got.prep[k].tobytes() == want.prep[k].tobytes(), k


def test_cache_hits_misses_and_rerelaxes_on_a_larger_bound(cities,
                                                            matcher):
    city = cities[1]
    kernel = DeviceRouteKernel(city, "cpu")
    tb, T = _native_chunk(city, _reqs(city, n=4, seed=31))
    wide = MatchParams(max_candidates=8, max_route_distance_factor=60.0)
    counts = []
    for params in (PARAMS, PARAMS, wide):
        metrics.default.reset()
        host = prepare_batch(matcher.runtime, tb, params, T)
        dev = prepare_batch(matcher.runtime, tb, params, T,
                            route_kernel=kernel)
        assert dev.prep["route_m"].tobytes() == host.prep["route_m"].tobytes()
        snap = metrics.snapshot()["counters"]
        counts.append((snap.get("route.device.cache_miss_rows", 0),
                       snap.get("route.device.cache_hit_rows", 0),
                       snap.get("route.device.relaxes", 0),
                       snap["route.device.sources"]))
    (miss0, hit0, relax0, n0), (miss1, hit1, relax1, n1), \
        (miss2, _hit2, relax2, _n2) = counts
    assert (miss0, hit0, relax0) == (n0, 0, 1)
    assert (miss1, hit1, relax1) == (0, n1, 0)
    assert miss2 > 0 and relax2 == 1  # a larger bound relaxes again
    assert kernel.stats()["route_hops"] > 1
    assert kernel.stats()["route_bound_m"] > 500.0


def test_over_budget_and_nonconvergence_raise(cities, matcher, monkeypatch):
    city = cities[1]
    tb, T = _native_chunk(city, _reqs(city, n=3, seed=41))
    metrics.default.reset()
    # a cap below what the relaxation needs (the real cap, N sweeps,
    # never stops one short)
    monkeypatch.setattr(DeviceRouteKernel, "_iter_cap", lambda self: 1)
    starved = DeviceRouteKernel(city, "cpu")
    with pytest.raises(RuntimeError, match="did not converge within 1 "
                                           "sweeps"):
        prepare_batch(matcher.runtime, tb, PARAMS, T, route_kernel=starved)
    assert starved._cache_dist is None  # nothing written to the cache
    m = SegmentMatcher(city, PARAMS, device="cpu", route_device=True)
    with pytest.raises(RuntimeError, match="did not converge"):
        m.match_many(_reqs(city, n=3, seed=41))
    monkeypatch.setattr(route_device, "_STATE_BUDGET_ELEMS", 16)
    with pytest.raises(RuntimeError, match="over budget"):
        prepare_batch(matcher.runtime, tb, PARAMS, T,
                      route_kernel=DeviceRouteKernel(city, "cpu"))
    snap = metrics.snapshot()["counters"]
    assert snap["route.device.nonconverged"] == 2
    assert snap["route.device.budget_exceeded"] == 1


# -- /report bytes -----------------------------------------------------------
def _bodies(matches, reqs, report=report_json):
    return [report(m, r, 15, {0, 1, 2}, {0, 1, 2})
            for m, r in zip(matches, reqs)]


@pytest.mark.parametrize("pipeline", [True, False])
def test_report_bytes_equal_three_ways(cities, monkeypatch, pipeline):
    ref_city, city = cities
    reqs = _reqs(city, n=7, seed=53)
    host = _bodies(SegmentMatcher(city, PARAMS, device="cpu",
                                  pipeline=pipeline).match_many(reqs), reqs)
    metrics.default.reset()
    m = SegmentMatcher(city, PARAMS, device="cpu", pipeline=pipeline,
                       route_device=True, chunk=4)
    dev = _bodies(m.match_many(reqs), reqs)
    assert m.route_kernel is not None
    assert metrics.snapshot()["counters"]["route.device.chunks"] >= 2
    monkeypatch.setenv("REPORTER_TPU_ROUTE_DEVICE", "1")
    jax_metrics.default.reset()
    ref = JaxMatcher(net=ref_city, params=JaxParams(max_candidates=8))
    want = _bodies(ref.match_many(reqs), reqs, jax_report_json)
    assert jax_metrics.default.snapshot()["counters"].get(
        "route.device.chunks", 0) > 0
    assert dev == host == want
    assert sum(b.count('"segment_id"') for b in dev) > len(reqs)


@pytest.mark.parametrize("native", [True, False])
def test_pruning_equals_jax(cities, monkeypatch, native):
    ref_city, city = cities
    reqs = _reqs(city, n=6, seed=61)
    monkeypatch.setenv("REPORTER_TPU_ROUTE_PRUNE_SIGMA", "1.5")
    want = _bodies(JaxMatcher(net=ref_city,
                              params=JaxParams(max_candidates=8),
                              use_native=native).match_many(reqs), reqs,
                   jax_report_json)
    m = SegmentMatcher(city, PARAMS, device="cpu", native=native,
                       prune_sigma=1.5)
    assert _bodies(m.match_many(reqs), reqs) == want
    # pruning cut candidates: fewer live ones than without it
    full = SegmentMatcher(city, PARAMS, device="cpu", native=native)
    kept = [sum(int((p.edge_ids != PAD_EDGE).sum())
                for p in mm.prepare_many(reqs)) for mm in (m, full)]
    assert kept[0] < kept[1]
    with pytest.raises(ValueError, match="prune_sigma"):
        SegmentMatcher(city, PARAMS, device="cpu", prune_sigma=-1.0)


def test_config_keys_reach_the_matcher(cities, tmp_path):
    city = cities[1]
    city.save(str(tmp_path / "city.npz"))
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "graph": str(tmp_path / "city.npz"),
        "matcher": {"max_candidates": 8},
        "service": {"route_device": True, "prune_sigma": 2.0,
                    "pipeline": False}}))
    conf = read_config(str(cfg))
    assert conf["matcher"] == {"route_device": True, "prune_sigma": 2.0,
                               "pipeline": False}
    m = matcher_from_config(conf, "cpu")
    assert m.route_kernel is not None
    assert m.route_kernel.device.type == "cpu" and m.prune_sigma == 2.0
    assert m.route_kernel._iter_cap() == city.num_nodes
    plain = matcher_from_config(read_config(str(cfg)) | {"matcher": {}},
                                "cpu")
    assert plain.route_kernel is None and plain.prune_sigma == 0.0
    # the numpy prep keeps host routes, as the reference's
    assert SegmentMatcher(city, PARAMS, device="cpu", native=False,
                          route_device=True).route_kernel is None
    # no sweep-cap key: the reference's ROUTE_HOPS has no use here until
    # a non-converged chunk can re-prep with host routes
    cfg.write_text(json.dumps({"graph": str(tmp_path / "city.npz"),
                               "service": {"route_hops": 40}}))
    with pytest.raises(ValueError, match="route_hops"):
        read_config(str(cfg))


def test_kernel_build_names_by_content_and_raises_without_nvcc(
        cities, tmp_path, monkeypatch):
    """Both kernel sources build through ops.nvcc: the library is named by
    the source's bytes and the flags; without nvcc (as on this CPU box) the
    build, and so a DeviceRouteKernel on the card, raises."""
    from reporter_tpu_torch.ops import nvcc, viterbi
    a, b = tmp_path / "a.cu", tmp_path / "b.cu"
    a.write_text("// a\n")
    b.write_text("// b\n")
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "build")
    names = {nvcc.library_path(src, "k").name for src in (a, b)}
    assert len(names) == 2 and all(n.startswith("libk-") for n in names)
    assert nvcc.library_path(route_relax.SOURCE, "route_relax").parent \
        == tmp_path / "build"
    assert route_relax.SOURCE.parent == viterbi.SOURCE.parent == nvcc.CSRC
    monkeypatch.setattr(nvcc.shutil, "which", lambda _name: None)
    monkeypatch.setattr(nvcc.os.path, "exists", lambda _path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        nvcc.load(a, "k")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        DeviceRouteKernel(cities[1])  # the card by default
