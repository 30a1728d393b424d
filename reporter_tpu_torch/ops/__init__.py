"""Device ops: one contract each, two implementations.

  decode      ops/csrc/viterbi.cu, the batched Viterbi (ops/viterbi.py
              builds, binds and launches it); plain: the PyTorch scan in
              matcher/hmm.py
  relax       ops/csrc/route_relax.cu `relax`, the whole bounded
              relaxation in one launch; past one block's shared memory
              `relax_cluster`, the same over a thread-block cluster; past
              a cluster's `relax_sweep`, one launch per sweep
              (ops/route_relax.py, chosen by N); plain:
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
"""
from .incremental import (incremental_step_cuda, incremental_step_plain,
                          incremental_steps_cuda, incremental_steps_plain)
from .route_relax import (pair_costs_cuda, pair_costs_packed,
                          relax_cluster_cuda, relax_csr, relax_cuda,
                          relax_kernel_for, relax_sweep_cuda)
from .viterbi import viterbi_cuda, viterbi_plain

__all__ = ["decode_batch", "incremental_step_batch", "incremental_steps",
           "relax_routes",
           "route_pair_costs", "viterbi_cuda", "viterbi_plain",
           "incremental_step_cuda", "incremental_step_plain",
           "incremental_steps_cuda", "incremental_steps_plain", "relax_cuda",
           "relax_cluster_cuda", "relax_sweep_cuda", "relax_csr",
           "pair_costs_cuda",
           "pair_costs_packed"]


def decode_batch(dist_m, valid, route_m, gc_m, case, sigma, beta,
                 events=None):
    """Batched Viterbi decode; same contract as
    ``matcher.hmm.viterbi_decode_batch``: dist_m (B,T,K) f16 or f32, valid
    (B,T,K) bool, route_m (B,T-1|T,K,K), gc_m (B,T-1|T), case (B,T) int32,
    sigma and beta scalars. Returns (paths (B,T) int32, scores (B,) f32)
    on the tensors' device. ``events``, on the card only, is a (start,
    end) pair of timing CUDA events recorded around the kernel."""
    if dist_m.device.type == "cpu":
        if events is not None:
            raise ValueError("events time the CUDA kernel; the CPU path "
                             "has none")
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
    names: ``relax`` or ``relax_cluster`` over ``arcs``
    (``route_relax.CsrArcs``, required there), past a cluster's reach
    ``relax_sweep`` over the edge columns."""
    if edge_len.device.type == "cpu":
        return relax_csr(edge_start, edge_end, edge_len, edge_secs,
                         src_nodes, bound, n_nodes=n_nodes,
                         max_iters=max_iters)
    kernel = relax_kernel_for(n_nodes)
    if kernel != "relax_sweep":
        if arcs is None:
            raise ValueError(f"{kernel} on the card needs the graph's CSR "
                             f"arcs")
        fn = relax_cuda if kernel == "relax" else relax_cluster_cuda
        return fn(arcs, src_nodes, bound, n_nodes=n_nodes,
                  max_iters=max_iters)
    return relax_sweep_cuda(edge_start, edge_end, edge_len, edge_secs,
                            src_nodes, bound, n_nodes=n_nodes,
                            max_iters=max_iters)


def route_pair_costs(ints, f32s, dist_sn, time_sn, edge_start, edge_end,
                     edge_len, edge_v, head_x, head_y, *, B, T, K, N):
    """The (B, T-1, K, K) route tensor and its finite max from two packed
    blobs (``route_relax.pair_costs_packed``'s contract) on the tensors'
    device."""
    fn = pair_costs_packed if dist_sn.device.type == "cpu" \
        else pair_costs_cuda
    return fn(ints, f32s, dist_sn, time_sn, edge_start, edge_end, edge_len,
              edge_v, head_x, head_y, B=B, T=T, K=K, N=N)
