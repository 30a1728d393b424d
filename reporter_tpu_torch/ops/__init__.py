"""Device ops: one contract each, two implementations.

  decode      ops/csrc/viterbi.cu, the batched Viterbi (ops/viterbi.py
              builds, binds and launches it); plain: the PyTorch scan in
              matcher/hmm.py. ``decode_batch(decode=)`` picks one of
              ``DECODES``: "fused" (the default) is the kernel on the
              card and the plain scan on the CPU, "scan" the plain scan
              and "assoc" the associative-scan decode in torch ops
              (ops/assoc_viterbi.py), on either device
  relax       ops/csrc/route_relax.cu `relax`, the whole bounded
              relaxation in one launch; past one block's shared memory
              `relax_cluster`, the same over a thread-block cluster; past
              a cluster's `relax_global`, the same with the state in
              global memory (ops/route_relax.py, chosen by N); plain:
              ``route_relax.relax_csr``
  pair costs  ops/csrc/route_relax.cu `pair_costs`, the route tensor from
              relaxed node kernels; plain: ``route_relax.pair_costs_packed``
  step        ops/csrc/viterbi.cu `incremental_steps`, R decode steps for
              N carried traces in one launch (ops/incremental.py); plain:
              ``incremental.incremental_steps_plain``, one round
              ``incremental.incremental_step_plain``

Each dispatcher here picks by where the tensors lie: CUDA tensors go to
the kernel, CPU tensors to the plain version. There is no fallback from
one to the other.

``decode_batch(mesh=)`` decodes over a decode mesh (``parallel/``): rows
split across its data entries, each launching its decode once, and with
``decode="assoc"`` time across its seq entries too. A batch the mesh
does not divide decodes on the mesh's first device, uncounted as
sharded; ``batch_pad_multiple`` is the row multiple a caller pads to so
that it divides.
"""
from .assoc_viterbi import step_matrices, viterbi_assoc_batch
from .incremental import (incremental_step_cuda, incremental_step_plain,
                          incremental_steps_cuda, incremental_steps_plain)
from .route_relax import (pair_costs_cuda, pair_costs_packed,
                          relax_cluster_cuda, relax_csr, relax_cuda,
                          relax_global_cuda, relax_kernel_for)
from .viterbi import viterbi_cuda, viterbi_plain

__all__ = ["decode_batch", "DECODES", "batch_pad_multiple", "shard_width",
           "incremental_step_batch", "incremental_steps", "relax_routes", "viterbi_assoc_batch",
           "step_matrices",
           "route_pair_costs", "viterbi_cuda", "viterbi_plain",
           "incremental_step_cuda", "incremental_step_plain",
           "incremental_steps_cuda", "incremental_steps_plain", "relax_cuda",
           "relax_cluster_cuda", "relax_global_cuda", "relax_csr",
           "pair_costs_cuda",
           "pair_costs_packed"]


#: the decodes ``decode_batch`` offers (the JAX package's
#: ``REPORTER_TPU_DECODE`` names, its "pallas" being "fused" here)
DECODES = ("fused", "scan", "assoc")


def _mesh_axes(mesh):
    from ..parallel.mesh import mesh_axes
    return mesh_axes(mesh)


def batch_pad_multiple(mesh, decode: str = "fused"):
    """The row multiple a batch is padded to so that ``decode_batch``
    shards it over ``mesh``: the data width; None without a mesh, with a
    data width of 1, and on a seq mesh for "fused" and "scan" (only the
    associative decode shards time, so they would not shard there)."""
    data, seq = _mesh_axes(mesh)
    if data <= 1 or (seq > 1 and decode != "assoc"):
        return None
    return data


def shard_width(mesh, B: int, T: int, decode: str = "fused") -> int:
    """How many mesh entries a (B, T) decode by ``decode`` spans: the
    profiler's shape key, so a change of mesh is a new shape and not a
    rebuild storm. 1 unsharded."""
    data, seq = _mesh_axes(mesh)
    if (seq > 1 and decode != "assoc") or B % data or T % seq:
        return 1
    return data * seq


def decode_batch(dist_m, valid, route_m, gc_m, case, sigma, beta,
                 events=None, decode="fused", mesh=None, pending=False):
    """Batched Viterbi decode; same contract as
    ``matcher.hmm.viterbi_decode_batch``: dist_m (B,T,K) f16 or f32, valid
    (B,T,K) bool, route_m (B,T-1|T,K,K), gc_m (B,T-1|T), case (B,T) int32,
    sigma and beta scalars. Returns (paths (B,T) int32, scores (B,) f32)
    on the tensors' device. ``decode`` is one of ``DECODES``; an unknown
    name raises. ``events``, with "fused" on the card only, is a (start,
    end) pair of timing CUDA events recorded around the kernel.

    With a ``mesh`` (``parallel.mesh.DecodeMesh``) a batch whose shape
    divides it (:func:`shard_width` > 1) decodes sharded
    (``parallel.sharded``) and counts ``decode.shard.chunks`` and
    ``decode.shard.rows``; its outputs are on the host, and with
    ``pending=True`` the call returns the ``ShardedDecode`` in flight
    instead of waiting for it. Any other batch decodes on the mesh's first
    device (its tensors moved there)."""
    if decode not in DECODES:
        raise ValueError(f"unknown decode {decode!r}: one of {DECODES}")
    if mesh is not None:
        if events is not None:
            raise ValueError("events time one launch; a mesh has several")
        B, T = dist_m.shape[0], dist_m.shape[1]
        if shard_width(mesh, B, T, decode) > 1:
            from ..parallel import sharded
            from ..utils import metrics
            metrics.count("decode.shard.chunks")
            metrics.count("decode.shard.rows", B)
            run = (sharded.sharded_viterbi(mesh) if decode == "assoc"
                   and mesh.seq > 1 else
                   sharded.sharded_data_viterbi(mesh, decode))
            out = run(dist_m, valid, route_m, gc_m, case, sigma, beta)
            return out if pending else out.wait()
        dev = mesh.devices[0]
        dist_m, valid, route_m, gc_m, case = (
            t.to(dev) for t in (dist_m, valid, route_m, gc_m, case))
    on_cpu = dist_m.device.type == "cpu"
    if events is not None and (on_cpu or decode != "fused"):
        raise ValueError("events time the CUDA kernel; only the fused "
                         "decode on the card has one")
    if decode == "assoc":
        return viterbi_assoc_batch(dist_m, valid, route_m, gc_m, case,
                                   sigma, beta)
    if decode == "scan" or on_cpu:
        return viterbi_plain(dist_m, valid, route_m, gc_m, case, sigma, beta)
    return viterbi_cuda(dist_m, valid, route_m, gc_m, case, sigma, beta,
                        events)


def incremental_step_batch(dist_m, valid, route_m, gc_m, case, prev_scores,
                           sigma, beta, out=None):
    """One decode step for N carried traces (the contract of the JAX
    package's ``ops.incremental.incremental_step_batch``): dist_m (N,K),
    valid (N,K) bool, route_m (N,K,K), gc_m (N,), case (N,) int32,
    prev_scores (N,K) f32, sigma and beta scalars. Returns (new_scores
    (N,K) f32, bp (N,K) int32, prev_best (N,) int32) on the tensors'
    device. ``out``, on the card only, is the kernel's one output buffer
    (``incremental.incremental_step_cuda``)."""
    if dist_m.device.type == "cpu":
        if out is not None:
            raise ValueError("out is the CUDA kernel's buffer; the CPU "
                             "path allocates its own outputs")
        return incremental_step_plain(dist_m, valid, route_m, gc_m, case,
                                      prev_scores, sigma, beta)
    return incremental_step_cuda(dist_m, valid, route_m, gc_m, case,
                                 prev_scores, sigma, beta, out=out)


def incremental_steps(dist_m, valid, route_m, gc_m, case, prev_scores,
                      n_steps, sigma, beta, out=None):
    """R decode steps for N carried traces, the scores carried from round
    to round (``incremental.incremental_steps_plain``'s contract): the
    (R, N, ...) operands, prev_scores (N, K), n_steps (N,) int32 each
    row's rounds. Returns (new_scores (R, N, K), bp (R, N, K), prev_best
    (R, N)) on the tensors' device. ``out``, on the card only, is the
    kernel's one output buffer (``incremental.incremental_steps_cuda``)."""
    if dist_m.device.type == "cpu":
        if out is not None:
            raise ValueError("out is the CUDA kernel's buffer; the CPU "
                             "path allocates its own outputs")
        return incremental_steps_plain(dist_m, valid, route_m, gc_m, case,
                                       prev_scores, n_steps, sigma, beta)
    return incremental_steps_cuda(dist_m, valid, route_m, gc_m, case,
                                  prev_scores, n_steps, sigma, beta, out=out)


def relax_routes(edge_start, edge_end, edge_len, edge_secs, src_nodes, bound,
                 *, n_nodes: int, max_iters: int, arcs=None):
    """Multi-source bounded relaxation (``route_relax.relax_csr``'s
    contract) on the tensors' device: ``(dist, time, iters,
    converged)``. On the card the kernel ``relax_kernel_for(n_nodes)``
    names, over ``arcs`` (``route_relax.CsrArcs``, required there):
    ``relax``, ``relax_cluster`` or, past a cluster's reach,
    ``relax_global``."""
    if edge_len.device.type == "cpu":
        return relax_csr(edge_start, edge_end, edge_len, edge_secs,
                         src_nodes, bound, n_nodes=n_nodes,
                         max_iters=max_iters)
    kernel = relax_kernel_for(n_nodes)
    if arcs is None:
        raise ValueError(f"{kernel} on the card needs the graph's CSR arcs")
    fn = {"relax": relax_cuda, "relax_cluster": relax_cluster_cuda,
          "relax_global": relax_global_cuda}[kernel]
    return fn(arcs, src_nodes, bound, n_nodes=n_nodes, max_iters=max_iters)


def route_pair_costs(ints, f32s, dist_sn, time_sn, edge_start, edge_end,
                     edge_len, edge_v, head_x, head_y, *, B, T, K, N):
    """The (B, T-1, K, K) route tensor and its finite max from two packed
    blobs (``route_relax.pair_costs_packed``'s contract) on the tensors'
    device."""
    fn = pair_costs_packed if dist_sn.device.type == "cpu" \
        else pair_costs_cuda
    return fn(ints, f32s, dist_sn, time_sn, edge_start, edge_end, edge_len,
              edge_v, head_x, head_y, B=B, T=T, K=K, N=N)
