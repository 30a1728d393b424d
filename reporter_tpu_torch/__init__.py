"""reporter_tpu_torch — the GPS probe map matcher on PyTorch and CUDA.

The port of ``reporter_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
It serves the ``/report`` match path: host-side candidate lookup and route
tensors feed a batched HMM Viterbi decode on the card — a hand-written
CUDA kernel (ops/csrc/viterbi.cu) — whose paths assemble into OSMLR
segment runs and datastore reports. It imports ``torch`` and numpy, and
nothing of ``reporter_tpu`` or JAX. Its entry points run on the card
unless they are given ``device="cpu"``.

Layout (each module mirrors its ``reporter_tpu`` counterpart):
  core/     — geodesy, OSMLR id math, tile hierarchy, columnar TraceBatch,
              the Point/Segment/tile value types
  graph/    — road network (.npz format shared with reporter_tpu), spatial
              index, bounded route distances
  matcher/  — HMM scoring + plain PyTorch decode, padding, assembly,
              SegmentMatcher
  ops/      — the CUDA decode kernel, its build and its dispatch
  native/   — the C++ host runtime (batched prep, assembly, wire writer)
  service/  — the /report HTTP service: report(), the micro-batching
              dispatcher, the threaded server, pre-fork workers
  streaming/ — the streaming worker: raw probe lines through the batcher
              and report_incremental to anonymised tile files
  utils/    — metrics, post-fork resets, failpoints, breakers, spools,
              HTTP egress
  synth.py  — synthetic grid cities and probe traces
"""

__version__ = "0.1.0"
