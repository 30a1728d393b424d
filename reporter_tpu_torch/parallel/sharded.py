"""The sharded batched decode over a :class:`~.mesh.DecodeMesh`.

Two mesh shapes, two contracts (the JAX package's):

- a data mesh (seq width 1): rows split across the data entries, each
  entry decodes its rows alone by the decode it is given (the CUDA kernel
  ``viterbi_decode`` on a card, the plain scan on the CPU, or the
  associative scan), with no traffic between entries. Each row runs the
  program it would run alone, so the sharded decode is bit-identical to
  the unsharded one (:func:`sharded_data_viterbi`);
- a (data, seq) mesh: time splits into ``seq`` spans as well, for the
  associative-scan decode only. Each span computes its max-plus prefix
  products on its entry; the span totals, (rows, K, K) each, are
  exchanged once and the carried prefix applied; the backtrace's index
  maps compose the same way (:func:`sharded_viterbi`). This stands for
  the cross-shard combines the JAX package's partitioner inserts. The
  products combine in another order than the unsharded scan's, so the
  paths agree with it by an f64 re-score within 1e-2 (ties may break
  otherwise), not bit for bit.

On the card each entry works on its own stream, which first waits for
the work queued on its device's current stream (a device route tensor
among the inputs). The outputs are copied without blocking into one
pinned host buffer, each entry into its rows, and one event is recorded
per entry: :meth:`ShardedDecode.synchronize` waits on them, and until then
the decode keeps its device tensors alive. A failing entry raises out of
the run; nothing decodes its rows elsewhere.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List

import numpy as np
import torch

from ..utils import metrics
from .mesh import DecodeMesh


class ShardedDecode:
    """One sharded decode in flight: ``paths`` (B, T) int32 and
    ``scores`` (B,) float32 on the host (pinned on the card), complete
    once :meth:`synchronize` returns; ``events`` the entries' CUDA events
    (none on the CPU, where the run has finished), ``held`` the device
    tensors kept alive until then; ``finish``, if given, runs once after
    the wait (it fills ``paths`` from pieces the entries copied)."""

    __slots__ = ("paths", "scores", "events", "held", "finish")

    def __init__(self, paths, scores, events, held, finish=None):
        self.paths = paths
        self.scores = scores
        self.events = events
        self.held = held
        self.finish = finish

    def synchronize(self) -> None:
        """Wait for every entry's copies, complete ``paths``; then drop
        the device tensors."""
        for ev in self.events:
            ev.synchronize()
        if self.finish is not None:
            self.finish()
            self.finish = None
        self.held = ()

    def wait(self):
        """:meth:`synchronize`, then ``(paths, scores)``."""
        self.synchronize()
        return self.paths, self.scores


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def _entry_ctx(mesh: DecodeMesh, i: int):
    """Run on entry ``i``'s stream (nothing to switch on the CPU)."""
    s = mesh.stream(i)
    return torch.cuda.stream(s) if s is not None else contextlib.nullcontext()


def _begin(mesh: DecodeMesh) -> None:
    """Each entry's stream waits for what its device's current stream
    has queued: the run's inputs may have been made there."""
    if not mesh.on_card:
        return
    for i, dev in enumerate(mesh.devices):
        mesh.stream(i).wait_stream(torch.cuda.current_stream(dev))


def _put(mesh: DecodeMesh, i: int, t: torch.Tensor) -> torch.Tensor:
    """``t`` (a slice of an input) as entry ``i``'s own contiguous tensor,
    made on entry i's stream (called inside :func:`_entry_ctx`). A
    tensor already on the entry's device is copied too, so the kernel
    gets a fresh allocation and the source may be freed at once."""
    dev = mesh.devices[i]
    if dev.type == "cpu":
        return t.to(dev).contiguous()
    if t.device == dev:
        t.record_stream(mesh.stream(i))
        return t.clone(memory_format=torch.contiguous_format)
    if t.device.type == "cpu":
        metrics.count("decode.upload.bytes", t.nbytes)
    return t.to(dev).contiguous()


def _uploads(mesh: DecodeMesh):
    """Time the entries' uploads of one batch (``matcher.upload``, on
    the card only)."""
    return (metrics.timer("matcher.upload") if mesh.on_card
            else contextlib.nullcontext())


def _handoff(mesh: DecodeMesh, t: torch.Tensor, src: int,
             dst: int) -> torch.Tensor:
    """Entry ``src``'s tensor ``t`` for use on entry ``dst``: dst's
    stream waits for src's, and the tensor moves if the devices differ."""
    dev = mesh.devices[dst]
    if dev.type == "cpu":
        return t.to(dev)
    s_src, s_dst = mesh.stream(src), mesh.stream(dst)
    if mesh.devices[src] == dev:
        s_dst.wait_stream(s_src)
        t.record_stream(s_dst)
        return t
    # the copy runs on the source device's current stream and waits both
    # ways (torch's cross-device copy): both entries' streams current
    with torch.cuda.stream(s_src), torch.cuda.stream(s_dst):
        return t.to(dev)


def _host_out(mesh: DecodeMesh, B: int, T: int):
    pin = mesh.on_card
    return (torch.empty((B, T), dtype=torch.int32, pin_memory=pin),
            torch.empty((B,), dtype=torch.float32, pin_memory=pin))


def _host_like(mesh: DecodeMesh, t: torch.Tensor) -> torch.Tensor:
    """A host tensor for ``t``'s copy (pinned on the card)."""
    return torch.empty(tuple(t.shape), dtype=t.dtype,
                       pin_memory=mesh.on_card)


def _copy_out(mesh: DecodeMesh, dst: torch.Tensor,
              src: torch.Tensor) -> None:
    """Copy ``src`` into the host rows ``dst`` (on the current stream,
    without blocking on the card)."""
    dst.copy_(src, non_blocking=mesh.on_card)


def _record(mesh: DecodeMesh, i: int, events: list) -> None:
    if mesh.on_card:
        ev = torch.cuda.Event()
        ev.record(mesh.stream(i))
        events.append(ev)


def shard_batch_data(mesh: DecodeMesh, dist_m, valid, route_m, gc_m,
                     case) -> List[tuple]:
    """One padded batch split by rows across the data entries, each slice
    on its entry's device (uploaded on its stream): a list of (dist,
    valid, route, gc, case) per data entry. B must divide by the data
    width; the mesh must have a seq width of 1."""
    if mesh.seq != 1:
        raise ValueError(f"shard_batch_data takes a data mesh, got "
                         f"{mesh.shape}")
    arrays = tuple(_as_tensor(a) for a in (dist_m, valid, route_m, gc_m,
                                           case))
    B = arrays[0].shape[0]
    if B % mesh.data:
        raise ValueError(f"{B} rows do not divide over {mesh.data} entries")
    rows = B // mesh.data
    _begin(mesh)
    out = []
    with _uploads(mesh):
        for d in range(mesh.data):
            i = mesh.entry(d)
            with _entry_ctx(mesh, i):
                out.append(tuple(_put(mesh, i, a[d * rows:(d + 1) * rows])
                                 for a in arrays))
    return out


def sharded_data_viterbi(mesh: DecodeMesh, decode: str = "fused"
                         ) -> Callable:
    """A decode over a data mesh: ``run(dist_m, valid, route_m, gc_m,
    case, sigma, beta)`` splits the rows across the entries
    (:func:`shard_batch_data`) and decodes each slice by
    ``ops.decode_batch(decode=decode)`` on its entry: ``viterbi_decode``
    once per entry on the card with "fused", the plain scan on the CPU,
    or the associative scan. Returns a :class:`ShardedDecode`."""
    from .. import ops
    if decode not in ops.DECODES:
        raise ValueError(f"unknown decode {decode!r}: one of {ops.DECODES}")

    def run(dist_m, valid, route_m, gc_m, case, sigma, beta):
        shards = shard_batch_data(mesh, dist_m, valid, route_m, gc_m, case)
        B, T = shards[0][0].shape[0] * mesh.data, shards[0][0].shape[1]
        paths, scores = _host_out(mesh, B, T)
        rows = B // mesh.data
        events, held = [], []
        for d, x in enumerate(shards):
            i = mesh.entry(d)
            with _entry_ctx(mesh, i):
                p, s = ops.decode_batch(*x, sigma, beta, decode=decode)
                lo, hi = d * rows, (d + 1) * rows
                _copy_out(mesh, paths[lo:hi], p)
                _copy_out(mesh, scores[lo:hi], s)
                _record(mesh, i, events)
            held.append((x, p, s))
        return ShardedDecode(paths, scores, events, held)

    return run


def shard_batch(mesh: DecodeMesh, dist_m, valid, route_m, gc_m,
                case) -> List[dict]:
    """One padded batch split by rows across ``data`` and by time across
    ``seq``, each piece on its entry's device: a list, by entry, of dicts
    with the span's ``dist``, ``valid`` and ``case`` (its L time rows and
    the next span's first, whose emission its last step needs) and its
    ``route`` and ``gc`` (its steps: L rows, L-1 in the last span).

    route and gc arrive with T-1 or T time rows; T-1 is padded to T with
    one dead trailing step (as the JAX package's ``shard_batch`` does) so
    they split along time like the rest, and the last span drops that
    step. B must divide by the data width and T by the seq width."""
    dist_m, valid, route_m, gc_m, case = (
        _as_tensor(a) for a in (dist_m, valid, route_m, gc_m, case))
    B, T = dist_m.shape[0], dist_m.shape[1]
    if B % mesh.data or T % mesh.seq:
        raise ValueError(f"({B}, {T}) does not divide over the mesh "
                         f"{mesh.shape}")
    if route_m.shape[1] == T - 1:
        route_m = torch.cat([route_m, route_m.new_zeros(
            (B, 1) + tuple(route_m.shape[2:]))], dim=1)
        gc_m = torch.cat([gc_m, gc_m.new_zeros((B, 1))], dim=1)
    rows, L = B // mesh.data, T // mesh.seq
    _begin(mesh)
    out = []
    with _uploads(mesh):
        for d in range(mesh.data):
            r = slice(d * rows, (d + 1) * rows)
            for s in range(mesh.seq):
                i = mesh.entry(d, s)
                a, b = s * L, (s + 1) * L
                steps = slice(a, min(b, T - 1))
                with _entry_ctx(mesh, i):
                    out.append({
                        "dist": _put(mesh, i, dist_m[r, a:b + 1]),
                        "valid": _put(mesh, i, valid[r, a:b + 1]),
                        "case": _put(mesh, i,
                                     case[r, a:b + 1].to(torch.int32)),
                        "route": _put(mesh, i, route_m[r, steps]),
                        "gc": _put(mesh, i, gc_m[r, steps])})
    return out


def sharded_viterbi(mesh: DecodeMesh) -> Callable:
    """The associative-scan decode over a (data, seq) mesh (any seq width,
    1 included): ``run(dist_m, valid, route_m, gc_m, case, sigma, beta)``
    returns a :class:`ShardedDecode`. Per row shard, each time span
    computes its step matrices and their prefix products on its entry;
    the span totals go to the shard's first entry, which carries the
    score vector across them and hands each span its carried prefix; each
    span then has its scores and backpointers, and its index maps compose
    into one map per span; those go to the first entry, which carries the
    path's index back from the last point and hands each span its end
    index; each span backtraces its own points."""
    from ..matcher.hmm import RESTART, emission_scores, transition_scores
    from ..ops.assoc_viterbi import (_compose, _maxplus_matmul,
                                     associative_scan, step_matrices)

    def run(dist_m, valid, route_m, gc_m, case, sigma, beta):
        pieces = shard_batch(mesh, dist_m, valid, route_m, gc_m, case)
        B, T = dist_m.shape[0], dist_m.shape[1]
        K = dist_m.shape[2]
        rows, L, S = B // mesh.data, T // mesh.seq, mesh.seq
        # each span's rows of the paths land in a contiguous host piece
        # of their own (a span is not contiguous in the (B, T) buffer);
        # the wait puts them in place
        paths = torch.empty((B, T), dtype=torch.int32)
        scores = torch.empty((B,), dtype=torch.float32,
                             pin_memory=mesh.on_card)
        spans = []
        events, held = [], []
        for d in range(mesh.data):
            first = mesh.entry(d, 0)
            r = slice(d * rows, (d + 1) * rows)
            # per span: emission, transitions, prefix products, total
            local = []
            for s in range(S):
                i = mesh.entry(d, s)
                x = pieces[i]
                with _entry_ctx(mesh, i):
                    em = emission_scores(x["dist"], x["valid"], x["case"],
                                         sigma)
                    tr = transition_scores(x["route"], x["gc"],
                                           x["case"][:, 1:], beta)
                    n = tr.shape[1]
                    if n:
                        P = associative_scan(_maxplus_matmul,
                                             step_matrices(em, tr))
                        total = P[:, -1]
                    else:
                        P = None
                        eye = torch.eye(K, dtype=torch.bool,
                                        device=em.device)
                        total = torch.where(eye, 0.0, -1.0e30).expand(
                            rows, K, K).to(torch.float32)
                local.append((em, tr, P, total))
            # the exchange: the carried score vector into each span
            with _entry_ctx(mesh, first):
                carry = [local[0][0][:, 0]]
                for s in range(S - 1):
                    tot = _handoff(mesh, local[s][3], mesh.entry(d, s),
                                   first)
                    carry.append(torch.amax(carry[-1][:, :, None] + tot,
                                            dim=1))
            # per span: scores, backpointers, composed index maps
            maps_of = []
            for s in range(S):
                i = mesh.entry(d, s)
                em, tr, P, _total = local[s]
                v = _handoff(mesh, carry[s], first, i)
                with _entry_ctx(mesh, i):
                    if P is None:
                        sc = v[:, None]
                    else:
                        sc = torch.cat([v[:, None], torch.amax(
                            v[:, None, :, None] + P, dim=2)], dim=1)
                    if tr.shape[1]:
                        bps = torch.argmax(sc[:, :-1, :, None] + tr, dim=2)
                        prev = torch.argmax(sc[:, :-1], dim=2)
                        case_to = pieces[i]["case"][:, 1:tr.shape[1] + 1]
                        maps = torch.where((case_to == RESTART)[:, :, None],
                                           prev[:, :, None], bps)
                        suffix = associative_scan(_compose, maps.flip(1),
                                                  None).flip(1)
                    else:
                        suffix = None
                maps_of.append((sc, suffix))
            # the exchange back: each span's end index, from the last
            # point's argmax through the later spans' composed maps
            last_i = mesh.entry(d, S - 1)
            sc_last = maps_of[-1][0]
            with _entry_ctx(mesh, last_i):
                last = torch.argmax(sc_last[:, -1], dim=1)
                final = torch.amax(sc_last[:, -1], dim=1)
            ends = [None] * S
            ends[S - 1] = _handoff(mesh, last, last_i, first)
            with _entry_ctx(mesh, first):
                for s in range(S - 1, 0, -1):
                    suffix = maps_of[s][1]
                    if suffix is None:
                        ends[s - 1] = ends[s]
                        continue
                    head = _handoff(mesh, suffix[:, 0], mesh.entry(d, s),
                                    first)
                    ends[s - 1] = torch.gather(head, 1,
                                               ends[s][:, None])[:, 0]
            # per span: its own points' path, copied to the host rows
            for s in range(S):
                i = mesh.entry(d, s)
                suffix = maps_of[s][1]
                end = _handoff(mesh, ends[s], first, i)
                with _entry_ctx(mesh, i):
                    a = s * L
                    if suffix is not None:
                        span = torch.gather(suffix, 2, end[:, None, None]
                                            .expand(rows, suffix.shape[1],
                                                    1))[:, :, 0]
                    else:
                        span = end[:, None][:, :0]
                    if s == S - 1:
                        span = torch.cat([span, end[:, None]], dim=1)
                    span = span.to(torch.int32)
                    piece = _host_like(mesh, span)
                    _copy_out(mesh, piece, span)
                    spans.append((r, a, piece))
                    if s == S - 1:
                        _copy_out(mesh, scores[r], final)
                    _record(mesh, i, events)
                held.append((span, end))
            held.append((local, maps_of, carry, ends, final))
        held.append(pieces)

        def finish():
            for r, a, piece in spans:
                paths[r, a:a + piece.shape[1]] = piece

        return ShardedDecode(paths, scores, events, held, finish)

    return run


__all__ = ["ShardedDecode", "shard_batch_data", "sharded_data_viterbi",
           "shard_batch", "sharded_viterbi"]
