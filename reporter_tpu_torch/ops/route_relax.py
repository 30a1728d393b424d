"""Device route costs: the bounded relaxation and the pair-cost assembly.

Two functions move the transition-cost stage of the native prep onto the
card (``graph/route_device.py`` owns them):

``relax_csr``
    A multi-source bounded Bellman-Ford over the road graph's edge
    columns: for every source node at once, the shortest network
    distance to every node within ``bound`` meters, and the travel time
    along that shortest-distance path (the minimum over equal-distance
    ties). Sweeps run until one changes nothing, or ``max_iters``.
``pair_costs``
    Gathers the relaxed node kernels into the padded (B, T-1, K, K)
    route tensor with the host emitter's ladder: the same-edge forward
    and backward cases, each step's distance bound and time cap, the
    turn penalty, the UNREACHABLE sentinel on pad candidates and dead
    steps, and the largest finite cost written (the wire-dtype input).

Each has a plain PyTorch version here, written step for step as the JAX
package's ``reporter_tpu/ops/route_relax.py`` (the CPU path and the
card's reference), and hand-written CUDA kernels in
``csrc/route_relax.cu`` (``sm_90a``, built at first use by ``ops.nvcc``):

``relax_cuda``
    launches ``relax`` once for the whole relaxation (a block per source
    row, its state in shared memory, over the graph's CSR arcs) and
    reads ``iters`` and ``converged`` once; ``relax_cuda.launches``
    counts launches and ``relax_cuda.reads`` the host reads. It takes
    graphs whose row state fits a block's shared memory
    (:func:`relax_fits`: N <= 14,528 nodes).
``relax_cluster_cuda``
    for larger graphs up to :data:`CLUSTER_MAX_NODES` (116,216): the same
    in one ``relax_cluster`` launch, each source row's state split over a
    thread-block cluster of :func:`cluster_width` blocks (2 to 8), and
    one read; ``relax_cluster_cuda.launches`` and ``.reads``.
``relax_sweep_cuda``
    for graphs past a cluster's reach: launches ``relax_sweep`` once per
    sweep and reads its changed flag after each one;
    ``relax_sweep_cuda.launches`` counts sweeps.
``pair_costs_cuda``
    launches ``pair_costs`` once on the two packed blobs;
    ``pair_costs_cuda.launches`` counts launches.

``ops.relax_routes`` and ``ops.route_pair_costs`` pick by where the
tensors lie: CPU tensors go to the plain version, CUDA tensors to a
kernel (the relaxation's by N alone), with no fallback from one to the
other. All arithmetic is IEEE float32 in the JAX program's order (the
kernels are built with ``--fmad=false``), so the card's bits equal the
plain version's.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from . import nvcc

SOURCE = nvcc.CSRC / "route_relax.cu"
#: the unreachable sentinel, as graph/route.py and the host runtime write
UNREACHABLE = 1.0e9
#: a node's packed (dist, time) state before it is reached: (+inf, +inf)
UNREACHED = 0x7F800000_7F800000

_F32 = torch.float32


# -- plain versions -----------------------------------------------------------
def relax_step(dist, time, edge_start, edge_end, edge_len, edge_secs, bound):
    """One Jacobi sweep of :func:`relax_csr` (the JAX loop body) on int64
    edge endpoints: returns the new ``(dist, time)``, both computed from
    the old state."""
    inf = torch.tensor(float("inf"), dtype=_F32, device=dist.device)
    cd = dist[:, edge_start] + edge_len
    ct = time[:, edge_start] + edge_secs
    ok = cd <= bound  # the Dijkstra admission rule (nd > bound skips)
    cd = torch.where(ok, cd, inf)
    ct = torch.where(ok, ct, inf)
    idx = edge_end.expand(dist.shape[0], -1)
    # scatter-min distances (duplicate targets reduce correctly)
    nd = dist.scatter_reduce(1, idx, cd, "amin", include_self=True)
    # lexicographic (d, t): among arcs that reach the (possibly unchanged)
    # new distance at their target, keep the least time; nodes whose
    # distance dropped reset their time first
    tie = torch.where(cd == nd[:, edge_end], ct, inf)
    nt = torch.where(nd == dist, time, inf)
    nt = nt.scatter_reduce(1, idx, tie, "amin", include_self=True)
    return nd, nt


def relax_csr(edge_start, edge_end, edge_len, edge_secs, src_nodes, bound,
              *, n_nodes: int, max_iters: int):
    """Multi-source bounded relaxation over the edge columns (plain).

    ``edge_start``/``edge_end`` (E,) int directed edge endpoints,
    ``edge_len`` (E,) f32 meters, ``edge_secs`` (E,) f32 full-edge travel
    seconds, ``src_nodes`` (S,) int sources (duplicates allowed),
    ``bound`` a float32 scalar. Returns ``(dist, time, iters,
    converged)``: (S, N) f32 distances (inf beyond the bound) and times,
    the sweeps run, and whether the last one changed nothing."""
    S = src_nodes.shape[0]
    dev = edge_len.device
    bound = torch.as_tensor(bound, dtype=_F32, device=dev)
    edge_start, edge_end = edge_start.long(), edge_end.long()
    rows = torch.arange(S, device=dev)
    dist = torch.full((S, n_nodes), float("inf"), dtype=_F32, device=dev)
    dist[rows, src_nodes.long()] = 0.0
    time = dist.clone()
    iters, changed = 0, True
    while changed and iters < max_iters:
        nd, nt = relax_step(dist, time, edge_start, edge_end, edge_len,
                            edge_secs, bound)
        changed = bool((nd != dist).any() or (nt != time).any())
        dist, time = nd, nt
        iters += 1
    return dist, time, iters, not changed


def pair_costs(edge, offset, nk, bounds, caps, dist_sn, time_sn, node_row,
               edge_start, edge_end, edge_len, edge_v, head_x, head_y,
               backward_tol, turn_penalty_factor):
    """The (B, T-1, K, K) route tensor from relaxed node kernels (plain).

    ``edge``/``offset`` (B, T, K) int/f32 candidates (pad -1), ``nk``
    (B,) kept points (steps >= nk-1 are dead), ``bounds``/``caps`` (B,
    T-1) f32 per-step distance bound and time cap (< 0: off), ``dist_sn``
    /``time_sn`` (rows, N) f32 node kernels, ``node_row`` (N,) node ->
    kernel row (-1: not a source), the edge columns (``edge_v`` m/s,
    ``head_x``/``head_y`` unit headings) and two f32 scalars. Returns
    ``(route, max_finite)``: UNREACHABLE where inadmissible, padded or
    dead, and the largest finite cost written (0 when none)."""
    unreach = torch.tensor(UNREACHABLE, dtype=_F32, device=offset.device)
    zero = torch.tensor(0.0, dtype=_F32, device=offset.device)
    edge, nk, node_row = edge.long(), nk.long(), node_row.long()
    edge_start, edge_end = edge_start.long(), edge_end.long()
    ea = edge[:, :-1, :, None]               # (B, T-1, K, 1)
    eb = edge[:, 1:, None, :]                # (B, T-1, 1, K)
    oa = offset[:, :-1, :, None]
    ob = offset[:, 1:, None, :]
    sa = ea.clamp(min=0)
    sb = eb.clamp(min=0)

    remaining = edge_len[sa] - oa            # (B, T-1, K, 1)
    via = remaining + ob                     # (B, T-1, K, K)
    row = node_row[edge_end[sa]]             # (B, T-1, K, 1)
    dn = dist_sn[row.clamp(min=0), edge_start[sb]]
    tn = time_sn[row.clamp(min=0), edge_start[sb]]

    b_ = bounds[:, :, None, None]
    cap = caps[:, :, None, None]
    via_dn = via + dn
    # general pair: the host emitter's ladder, in its order
    bad = (via > b_) | (row < 0) | ~torch.isfinite(dn) | (via_dn > b_)
    secs = remaining / edge_v[sa] + ob / edge_v[sb] + tn
    bad = bad | ((cap >= 0) & (secs > cap))
    cos_th = head_x[sa] * head_x[sb] + head_y[sa] * head_y[sb]
    pen = (turn_penalty_factor * 0.5) * (1.0 - cos_th)
    d_gen = torch.where(turn_penalty_factor > 0, via_dn + pen, via_dn)
    general = torch.where(bad, unreach, d_gen)

    # same directed edge: forward progress prices the along-edge meters
    # (time-capped); small apparent backward motion prices as staying put
    same = eb == ea
    fwd = same & (ob >= oa)
    d_fwd = ob - oa
    fwd_val = torch.where((cap >= 0) & (d_fwd / edge_v[sa] > cap),
                          unreach, d_fwd)
    back = same & (ob < oa) & ((oa - ob) <= backward_tol)
    val = torch.where(fwd, fwd_val, torch.where(back, zero, general))

    steps = torch.arange(edge.shape[1] - 1, device=edge.device)
    dead = (ea < 0) | (eb < 0) \
        | (steps[None, :, None, None] >= (nk[:, None, None, None] - 1))
    out = torch.where(dead, unreach, val)
    max_finite = torch.where(out < unreach, out, zero).amax()
    return out, torch.maximum(max_finite, zero)  # JAX's initial=0


def unpack_blobs(ints, f32s, B: int, T: int, K: int, N: int):
    """The six per-chunk tensors and two scalars of the packed blobs
    (``graph.route_device.DeviceRouteKernel._run`` packs them):

      ints: [edge (B*T*K) | nk (B) | node_row (N)]                  int32
      f32s: [offset (B*T*K) | bounds (B*(T-1)) | caps (B*(T-1))
             | backward_tol | turn_penalty_factor]                  float32
    """
    btk = B * T * K
    bt1 = B * (T - 1)
    return (ints[:btk].reshape(B, T, K), f32s[:btk].reshape(B, T, K),
            ints[btk:btk + B], f32s[btk:btk + bt1].reshape(B, T - 1),
            f32s[btk + bt1:btk + 2 * bt1].reshape(B, T - 1),
            ints[btk + B:btk + B + N],
            f32s[btk + 2 * bt1], f32s[btk + 2 * bt1 + 1])


def pair_costs_packed(ints, f32s, dist_sn, time_sn, edge_start, edge_end,
                      edge_len, edge_v, head_x, head_y, *, B, T, K, N):
    """:func:`pair_costs` on the two packed blobs (:func:`unpack_blobs`)."""
    edge, offset, nk, bounds, caps, node_row, btol, tpen = unpack_blobs(
        ints, f32s, B, T, K, N)
    return pair_costs(edge, offset, nk, bounds, caps, dist_sn, time_sn,
                      node_row, edge_start, edge_end, edge_len, edge_v,
                      head_x, head_y, btol, tpen)


# -- the kernels --------------------------------------------------------------
#: dynamic shared memory one block may take on Hopper (the H100's 227 KB)
SMEM_LIMIT = 232_448
#: shared memory of one Hopper SM (228 KB), 1 KB of it reserved per block
SM_SMEM = 233_472
#: shared bytes a node takes in ``relax``: two packed 8-byte words
RELAX_NODE_BYTES = 16
#: ``relax_cluster``: the most blocks of a portable cluster, and the
#: bytes of rank 0's two per-parity flags after every block's slice
CLUSTER_MAX = 8
CLUSTER_FLAG_BYTES = 16

_lock = threading.Lock()
_lib = None  # (ctypes.CDLL with argtypes set, build log) once built
#: (graph size, width) plans of relax_cluster the occupancy query passed
_clusters_checked: set = set()


def build():
    """Compile (once per source version) and load ``csrc/route_relax.cu``.
    Returns ``(library, compiler log)``; raises if the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib, log = nvcc.load(SOURCE, "route_relax")
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.relax.argtypes = [p, i, p, p, p, p, i, f, i, i, p, p, p, p]
            lib.relax.restype = i
            lib.relax_cluster.argtypes = [p, i, p, p, p, p, i, i, f, i, i,
                                          p, p, p, p]
            lib.relax_cluster.restype = i
            lib.relax_cluster_occupancy.argtypes = [i, i, i, p]
            lib.relax_cluster_occupancy.restype = i
            lib.relax_sweep.argtypes = [p, p, p, p, p, p, i, i, i, f, p, p]
            lib.relax_sweep.restype = i
            lib.pair_costs.argtypes = [p, p, p, p, i, p, p, p, p, p, p,
                                       i, i, i, i, p, p, p]
            lib.pair_costs.restype = i
            _lib = (lib, log)
        return _lib


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_edges(dev, edge_start, edge_end, *floats):
    if edge_start.dtype != torch.int32 or edge_end.dtype != torch.int32:
        raise TypeError("edge_start and edge_end must be int32")
    if any(x.dtype != _F32 for x in floats):
        raise TypeError("edge float columns must be float32")
    E = edge_start.shape[0]
    if any(tuple(x.shape) != (E,) for x in (edge_end, *floats)):
        raise ValueError("edge columns must share one (E,) shape")
    nvcc.check_operands(dev, edge_start=edge_start, edge_end=edge_end,
                        **{f"edge_float_{n}": x for n, x in enumerate(floats)})


def _check_sources(dev, src_nodes):
    nvcc.check_operands(dev, src_nodes=src_nodes)
    if src_nodes.dim() != 1 or src_nodes.dtype not in (torch.int32,
                                                       torch.int64):
        raise TypeError("src_nodes must be a 1-D int32 or int64 tensor")


def relax_fits(n_nodes: int) -> bool:
    """Whether ``relax`` takes a graph of ``n_nodes``: one source row's two
    packed states in one block's shared memory. Past it the card runs
    ``relax_cluster``, then ``relax_sweep``; the choice is by N alone."""
    return 0 < RELAX_NODE_BYTES * n_nodes <= SMEM_LIMIT


def cluster_smem(n_nodes: int, width: int) -> int:
    """Shared bytes of one ``relax_cluster`` block: its slice of
    ceil(N / width) nodes, two packed words each, then the flags."""
    return RELAX_NODE_BYTES * -(-n_nodes // width) + CLUSTER_FLAG_BYTES


def cluster_width(n_nodes: int) -> int:
    """``relax_cluster``'s blocks a source row: the fewest, from 2 to
    :data:`CLUSTER_MAX`, whose slices fit a block's shared memory; 0 past
    :data:`CLUSTER_MAX_NODES`."""
    return next((c for c in range(2, CLUSTER_MAX + 1)
                 if cluster_smem(n_nodes, c) <= SMEM_LIMIT), 0)


#: the largest graph one ``relax_cluster`` launch takes: 8 slices of
#: 14,527 nodes (the flags take a node's 16 bytes of each block)
CLUSTER_MAX_NODES = CLUSTER_MAX * (
    (SMEM_LIMIT - CLUSTER_FLAG_BYTES) // RELAX_NODE_BYTES)


def relax_kernel_for(n_nodes: int) -> str:
    """The relaxation kernel the card runs on a graph of ``n_nodes``:
    ``relax`` up to 14,528 nodes, ``relax_cluster`` up to
    :data:`CLUSTER_MAX_NODES`, ``relax_sweep`` past it."""
    if relax_fits(n_nodes):
        return "relax"
    return "relax_cluster" if cluster_width(n_nodes) else "relax_sweep"


def relax_threads(n_nodes: int) -> int:
    """``relax``'s block size: about 2,048 resident threads an SM (a Hopper
    SM holds 228 KB of shared memory, 1 KB of it reserved per block, and
    32 blocks), so a small graph runs several narrow blocks an SM and a
    large one a single block of 1,024; at least 128 threads, and enough
    that a thread owns at most 64 nodes (its frontier bits are one 64-bit
    register)."""
    per_sm = min(32, SM_SMEM // (RELAX_NODE_BYTES * n_nodes + 1024))
    threads = 1 << (2048 // max(per_sm, 1)).bit_length() - 1
    threads = min(max(threads, 128), 1024)
    while -(-n_nodes // threads) > 64:
        threads *= 2
    return threads


class CsrArcs(NamedTuple):
    """The graph's arcs grouped by start node (``RoadNetwork.csr()``'s
    order), as ``relax`` reads them: ``offsets`` (N+1,) int32, arc
    ``end`` (E,) int32, ``length`` and ``secs`` (E,) float32."""
    offsets: torch.Tensor
    end: torch.Tensor
    length: torch.Tensor
    secs: torch.Tensor


def csr_arcs(offsets, order, edge_end, edge_len, edge_secs, device):
    """:class:`CsrArcs` on ``device`` from the CSR adjacency (``offsets``
    (N+1,), ``order`` (E,) edge ids grouped by start node) and the edge
    columns, all numpy."""
    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
            device)
    return CsrArcs(up(offsets, np.int32), up(np.asarray(edge_end)[order],
                                             np.int32),
                   up(np.asarray(edge_len)[order], np.float32),
                   up(np.asarray(edge_secs)[order], np.float32))


def launch_relax(arcs: CsrArcs, src_nodes, bound, max_iters: int, dist,
                 time, info) -> None:
    """Enqueue one ``relax`` launch on the current stream, uncounted and
    unchecked: ``src_nodes`` int32, ``dist``/``time`` (S, N) float32
    outputs, ``info`` three zeroed int32. Timing loops call this
    directly."""
    S, N = dist.shape
    lib, _log = build()
    with torch.cuda.device(dist.device):
        err = lib.relax(
            src_nodes.data_ptr(), S, *(x.data_ptr() for x in arcs), N,
            float(bound), int(max_iters), relax_threads(N), dist.data_ptr(),
            time.data_ptr(), info.data_ptr(), _stream(dist.device))
    if err != 0:
        raise RuntimeError(f"relax launch failed: CUDA error {err}")


def _check_arcs(arcs: CsrArcs, src_nodes, n_nodes: int):
    """Raise unless ``arcs`` and ``src_nodes`` are what the one-launch
    relaxations take; returns their device."""
    dev = arcs.length.device
    if arcs.offsets.dtype != torch.int32 or arcs.end.dtype != torch.int32 \
            or arcs.length.dtype != _F32 or arcs.secs.dtype != _F32:
        raise TypeError("CSR offsets and ends must be int32, lengths and "
                        "seconds float32")
    E = arcs.end.shape[0]
    if arcs.offsets.shape != (n_nodes + 1,) or \
            arcs.length.shape != (E,) or arcs.secs.shape != (E,):
        raise ValueError(f"CSR arcs do not fit {n_nodes} nodes: offsets "
                         f"{tuple(arcs.offsets.shape)}, {E} ends")
    nvcc.check_operands(dev, **arcs._asdict())
    _check_sources(dev, src_nodes)
    return dev


def _relax_once(fn, launch, src_nodes, n_nodes: int, dev):
    """Allocate the planes and info, ``launch(src, dist, time, info)``
    once, read info back in one copy, counting both on the wrapper ``fn``
    (``fn.launches``, ``fn.reads``): ``(dist, time, iters, converged)``;
    raises on a source outside the graph."""
    S = src_nodes.shape[0]
    dist = torch.empty((S, n_nodes), dtype=_F32, device=dev)
    time = torch.empty_like(dist)
    info = torch.zeros(3, dtype=torch.int32, device=dev)
    launch(src_nodes.to(torch.int32), dist, time, info)
    fn.launches += 1
    iters, stuck, bad = info.tolist()
    fn.reads += 1
    if bad:
        raise ValueError(f"{bad} source nodes outside 0..{n_nodes - 1}")
    return dist, time, iters, stuck == 0


def relax_cuda(arcs: CsrArcs, src_nodes, bound, *, n_nodes: int,
               max_iters: int):
    """:func:`relax_csr` on the card in one ``relax`` launch over the CSR
    arcs; same contract and the same bits, ``iters`` and ``converged``
    read back in one copy. Raises on a graph :func:`relax_fits` refuses
    and on a source outside the graph."""
    if not relax_fits(n_nodes):
        most = SMEM_LIMIT // RELAX_NODE_BYTES
        raise ValueError(f"relax takes at most {most} nodes, got {n_nodes}")
    dev = _check_arcs(arcs, src_nodes, n_nodes)
    return _relax_once(
        relax_cuda, lambda src, dist, time, info: launch_relax(
            arcs, src, bound, max_iters, dist, time, info),
        src_nodes, n_nodes, dev)


relax_cuda.launches = 0
relax_cuda.reads = 0


def check_cluster(n_nodes: int, device, width: "int | None" = None) -> None:
    """Raise unless the card can hold at least one cluster of
    ``relax_cluster``'s plan for ``n_nodes`` (``width`` blocks,
    :func:`cluster_width` by default; asked of
    ``cudaOccupancyMaxActiveClusters`` once per plan and process)."""
    width = width or cluster_width(n_nodes)
    if (n_nodes, width) in _clusters_checked:
        return
    lib, _log = build()
    got = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.relax_cluster_occupancy(
            n_nodes, width, relax_threads(-(-n_nodes // width)),
            ctypes.byref(got))
    if err != 0:
        raise RuntimeError(f"relax_cluster occupancy query failed: CUDA "
                           f"error {err}")
    if got.value < 1:
        raise RuntimeError(
            f"the card holds no cluster of {width} blocks of "
            f"{cluster_smem(n_nodes, width)} shared bytes (relax_cluster "
            f"for {n_nodes} nodes)")
    _clusters_checked.add((n_nodes, width))


def launch_relax_cluster(arcs: CsrArcs, src_nodes, bound, max_iters: int,
                         dist, time, info, width: "int | None" = None) -> None:
    """Enqueue one ``relax_cluster`` launch (clusters of ``width`` blocks,
    :func:`cluster_width` by default) on the current stream, uncounted
    and unchecked (as :func:`launch_relax`). Timing loops call this
    directly, and checks that hold the kernel at other widths than a
    graph's own."""
    S, N = dist.shape
    width = width or cluster_width(N)
    lib, _log = build()
    with torch.cuda.device(dist.device):
        err = lib.relax_cluster(
            src_nodes.data_ptr(), S, *(x.data_ptr() for x in arcs), N,
            width, float(bound), int(max_iters),
            relax_threads(-(-N // width)), dist.data_ptr(), time.data_ptr(),
            info.data_ptr(), _stream(dist.device))
    if err != 0:
        raise RuntimeError(f"relax_cluster launch failed: CUDA error {err}")


def relax_cluster_cuda(arcs: CsrArcs, src_nodes, bound, *, n_nodes: int,
                       max_iters: int):
    """:func:`relax_csr` on the card in one ``relax_cluster`` launch: each
    source row on a cluster of :func:`cluster_width` blocks, its state
    split over their shared memory; same contract and the same bits,
    ``iters`` and ``converged`` read back in one copy. Raises on a graph
    past :data:`CLUSTER_MAX_NODES`, on a card that cannot hold one such
    cluster, and on a source outside the graph."""
    if not cluster_width(n_nodes):
        raise ValueError(f"relax_cluster takes at most {CLUSTER_MAX_NODES} "
                         f"nodes, got {n_nodes}")
    dev = _check_arcs(arcs, src_nodes, n_nodes)
    check_cluster(n_nodes, dev)
    return _relax_once(
        relax_cluster_cuda, lambda src, dist, time, info: launch_relax_cluster(
            arcs, src, bound, max_iters, dist, time, info),
        src_nodes, n_nodes, dev)


relax_cluster_cuda.launches = 0
relax_cluster_cuda.reads = 0


def pack_sources(src_nodes, n_nodes: int):
    """The packed (S, N) int64 state before the first sweep: (0, 0) at
    each row's source, (+inf, +inf) elsewhere."""
    S = src_nodes.shape[0]
    state = torch.full((S, n_nodes), UNREACHED, dtype=torch.int64,
                       device=src_nodes.device)
    state[torch.arange(S, device=state.device), src_nodes.long()] = 0
    return state


def unpack_state(state):
    """(dist, time) f32 of a packed state: dist in the high 32 bits."""
    words = state.view(torch.int32).view(*state.shape, 2)
    return (words[..., 1].contiguous().view(_F32),
            words[..., 0].contiguous().view(_F32))


def launch_sweep(old, new, edge_start, edge_end, edge_len, edge_secs,
                 bound, changed) -> None:
    """Enqueue one sweep on the current stream, uncounted and unchecked:
    copy ``old`` into ``new``, zero ``changed`` (int32), then the
    ``relax_sweep`` kernel. Timing loops call this directly."""
    S, N = old.shape
    lib, _log = build()
    with torch.cuda.device(old.device):
        err = lib.relax_sweep(
            old.data_ptr(), new.data_ptr(), edge_start.data_ptr(),
            edge_end.data_ptr(), edge_len.data_ptr(), edge_secs.data_ptr(),
            S, N, edge_start.shape[0], float(bound), changed.data_ptr(),
            _stream(old.device))
    if err != 0:
        raise RuntimeError(f"relax_sweep launch failed: CUDA error {err}")


def relax_sweep_cuda(edge_start, edge_end, edge_len, edge_secs, src_nodes,
                     bound, *, n_nodes: int, max_iters: int):
    """:func:`relax_csr` on the card for any N: one ``relax_sweep`` launch
    per sweep, each followed by a read of its changed flag; same contract
    and the same bits (``edge_start``/``edge_end`` int32 here). The state
    is double-buffered, so every sweep reads only the previous one's
    state: the sweep count and each tie equal the plain version's."""
    dev = edge_len.device
    _check_edges(dev, edge_start, edge_end, edge_len, edge_secs)
    _check_sources(dev, src_nodes)
    bound = float(torch.as_tensor(bound, dtype=_F32))
    state = pack_sources(src_nodes, n_nodes)
    spare = torch.empty_like(state)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    iters, changed = 0, True
    while changed and iters < max_iters:
        launch_sweep(state, spare, edge_start, edge_end, edge_len,
                     edge_secs, bound, flag)
        relax_sweep_cuda.launches += 1
        iters += 1
        changed = bool(flag.item())
        state, spare = spare, state
    dist, time = unpack_state(state)
    return dist, time, iters, not changed


relax_sweep_cuda.launches = 0


def launch_pair_costs(ints, f32s, dist_sn, time_sn, edges, B, T, K, N,
                      route, max_bits) -> None:
    """Enqueue one ``pair_costs`` launch on the current stream, uncounted
    and unchecked; ``edges`` = (edge_start, edge_end, edge_len, edge_v,
    head_x, head_y), ``max_bits`` a zeroed int32 slot. Timing loops call
    this directly."""
    lib, _log = build()
    with torch.cuda.device(route.device):
        err = lib.pair_costs(
            ints.data_ptr(), f32s.data_ptr(), dist_sn.data_ptr(),
            time_sn.data_ptr(), dist_sn.shape[0],
            *(x.data_ptr() for x in edges), B, T, K, N, route.data_ptr(),
            max_bits.data_ptr(), _stream(route.device))
    if err != 0:
        raise RuntimeError(f"pair_costs launch failed: CUDA error {err}")


def pair_costs_cuda(ints, f32s, dist_sn, time_sn, edge_start, edge_end,
                    edge_len, edge_v, head_x, head_y, *, B, T, K, N):
    """:func:`pair_costs_packed` on the card: one ``pair_costs`` launch that
    reads the blobs in place. Returns ``(route, max_finite)``, both on the
    card (``max_finite`` a 0-d f32 tensor), not synchronised."""
    dev = dist_sn.device
    _check_edges(dev, edge_start, edge_end, edge_len, edge_v, head_x, head_y)
    nvcc.check_operands(dev, ints=ints, f32s=f32s, dist_sn=dist_sn,
                        time_sn=time_sn)
    if ints.dtype != torch.int32 or f32s.dtype != _F32 or \
            dist_sn.dtype != _F32 or time_sn.dtype != _F32:
        raise TypeError("ints must be int32; f32s, dist_sn and time_sn "
                        "float32")
    if T < 2 or min(B, K) < 1:
        raise ValueError(f"no transitions in B,T,K={B},{T},{K}")
    btk = B * T * K
    if ints.shape != (btk + B + N,) or \
            f32s.shape != (btk + 2 * B * (T - 1) + 2,) or \
            dist_sn.dim() != 2 or dist_sn.shape[1] != N or \
            time_sn.shape != dist_sn.shape:
        raise ValueError(f"blob or kernel shapes do not fit B,T,K,N="
                         f"{B},{T},{K},{N}: ints {tuple(ints.shape)}, f32s "
                         f"{tuple(f32s.shape)}, dist {tuple(dist_sn.shape)}")
    route = torch.empty((B, T - 1, K, K), dtype=_F32, device=dev)
    max_bits = torch.zeros(1, dtype=torch.int32, device=dev)
    launch_pair_costs(ints, f32s, dist_sn, time_sn,
                      (edge_start, edge_end, edge_len, edge_v, head_x,
                       head_y), B, T, K, N, route, max_bits)
    pair_costs_cuda.launches += 1
    return route, max_bits.view(_F32)[0]


pair_costs_cuda.launches = 0
