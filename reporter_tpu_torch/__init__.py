"""reporter_tpu_torch — the GPS probe map matcher on PyTorch and CUDA.

The port of ``reporter_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
It runs the ``/report`` match path: host-side candidate lookup and route
tensors feed a batched HMM Viterbi decode on the card — a hand-written
CUDA kernel (ops/csrc/viterbi.cu) — whose paths assemble into OSMLR
segment runs and datastore reports. It imports ``torch`` and numpy, and
nothing of ``reporter_tpu`` or JAX. Its entry points run on the card
unless they are given ``device="cpu"``.

Layout (each module mirrors its ``reporter_tpu`` counterpart):
  core/     — geodesy, OSMLR id math, tile hierarchy, columnar TraceBatch
  graph/    — road network (.npz format shared with reporter_tpu), spatial
              index, bounded route distances
  matcher/  — HMM scoring + plain PyTorch decode, padding, assembly,
              SegmentMatcher
  ops/      — the CUDA decode kernel, its build and its dispatch
  service/  — report(): the /report body
  synth.py  — synthetic grid cities and probe traces
"""

__version__ = "0.1.0"
