"""Device decode: the batched Viterbi, one contract, two implementations.

  kernel  ops/csrc/viterbi.cu, a hand-written CUDA kernel for Hopper
          (ops/viterbi.py builds, binds and launches it)
  plain   the PyTorch scan in matcher/hmm.py

:func:`decode_batch` picks by where the tensors lie: CUDA tensors go to
the kernel, CPU tensors to the plain version. There is no fallback from
one to the other.
"""
from .viterbi import viterbi_cuda, viterbi_plain

__all__ = ["decode_batch", "viterbi_cuda", "viterbi_plain"]


def decode_batch(dist_m, valid, route_m, gc_m, case, sigma, beta):
    """Batched Viterbi decode; same contract as
    ``matcher.hmm.viterbi_decode_batch``: dist_m (B,T,K) f16 or f32, valid
    (B,T,K) bool, route_m (B,T-1|T,K,K), gc_m (B,T-1|T), case (B,T) int32,
    sigma and beta scalars. Returns (paths (B,T) int32, scores (B,) f32)
    on the tensors' device."""
    if dist_m.device.type == "cpu":
        return viterbi_plain(dist_m, valid, route_m, gc_m, case, sigma, beta)
    return viterbi_cuda(dist_m, valid, route_m, gc_m, case, sigma, beta)
