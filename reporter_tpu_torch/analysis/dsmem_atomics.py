"""How 64-bit atomic minima behave in a thread-block cluster's distributed
shared memory (DSMEM) on the card: a probe behind ``relax_cluster``'s
choice of atomics (``ops/csrc/route_relax.cu``).

Each block of a cluster holds ``W`` packed 64-bit words in its shared
memory. Every thread lowers ``UPDATES`` words chosen by a hash, anywhere in
its cluster, by one of the ways below (``MODES``), and logs each (word,
candidate) it tried. After a ``cluster.sync()`` each word must hold the
least candidate logged for it: a word that holds more lost a minimum. The
expected minima are reduced on the card with ``scatter_reduce("amin")``
over the log. The ways:

``min/min``
    ``atomicMin`` on the block's own words, ``atomicMin`` through the
    ``cluster.map_shared_rank`` pointer on a neighbour's;
``min via map``
    ``atomicMin`` through the mapped pointer for every word, the block's
    own included;
``min/cas`` (``relax_cluster``'s)
    a volatile pre-check and ``atomicMin`` on the own words, a 64-bit
    ``atomicCAS`` loop from the unreached word on a neighbour's;
``cas/cas``
    the ``atomicCAS`` loop on every word;
``min/min, pre-check``
    ``min/min`` behind a volatile pre-check read, own or mapped;
``own only``
    ``atomicMin`` on the block's own words only (no DSMEM traffic);
``min/ptx``
    ``atomicMin`` on the own words, a neighbour's by the PTX
    ``atom.shared::cluster.min.u64`` at a ``mapa`` address;
``ptx/ptx``
    that PTX atomic for every word;
``min32 via map``
    a 32-bit ``atomicMin`` of the candidate's high half on the high half
    of every word, through the mapped pointer (the low halves stay the
    unreached word's, so the packed minimum is still the one expected).

It also prints the atomic instructions ``cuobjdump -sass`` finds in each
probe kernel and in ``route_relax.cu``'s relaxation kernels. Run it on the
card::

    python -m reporter_tpu_torch.analysis.dsmem_atomics [--reps 5]

It prints one JSON line: for each way, cluster width and ``W``, the runs,
the words checked, the words that lost a minimum (left above the least
candidate) and the words left below it (a value no update wrote).
Nothing here is on any serving path.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys

MODES = ("min/min", "min via map", "min/cas", "cas/cas",
         "min/min, pre-check", "own only", "min/ptx", "ptx/ptx",
         "min32 via map")
#: clusters a launch, threads a block, updates a thread
CLUSTERS = 128
THREADS = 1024
UPDATES = 8
UNREACHED = 0x7F800000_7F800000

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>
namespace cg = cooperative_groups;

constexpr unsigned long long kUnreached = 0x7F8000007F800000ull;

__device__ __forceinline__ unsigned long long mix(unsigned long long x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdull;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ull;
  x ^= x >> 33;
  return x;
}

// relax_cluster's remote update: a CAS loop whose first guess is the
// unreached word
__device__ __forceinline__ void cas_min(unsigned long long* p,
                                        unsigned long long v) {
  unsigned long long old = kUnreached;
  while (v < old) {
    const unsigned long long seen = atomicCAS(p, old, v);
    if (seen == old) return;
    old = seen;
  }
}

__device__ __forceinline__ void ptx_min(unsigned long long* own_word,
                                        int owner, unsigned long long v) {
  const uint32_t at =
      static_cast<uint32_t>(__cvta_generic_to_shared(own_word));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(at), "r"(owner));
  unsigned long long old;
  asm volatile("atom.shared::cluster.min.u64 %0, [%1], %2;"
               : "=l"(old) : "r"(remote), "l"(v) : "memory");
}

template <int MODE>
__global__ void probe(int W, int updates, unsigned long long seed,
                      unsigned long long* out, long long* log_word,
                      long long* log_value) {
  extern __shared__ unsigned long long words[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const long long cl = blockIdx.x / C;
  for (int i = threadIdx.x; i < W; i += blockDim.x) words[i] = kUnreached;
  cluster.sync();
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  for (int u = 0; u < updates; ++u) {
    const unsigned long long h = mix(seed ^ (t * 1000003ull + u));
    int w = static_cast<int>(h % static_cast<unsigned long long>(C * W));
    if (MODE == 5) w = rank * W + w % W;
    const unsigned long long v = mix(h + 1) >> 2;  // below kUnreached
    const int owner = w / W;
    const int i = w - owner * W;
    unsigned long long* own = words + i;
    unsigned long long* mapped = cluster.map_shared_rank(words, owner) + i;
    if (MODE == 0) {
      if (owner == rank) atomicMin(own, v);
      else atomicMin(mapped, v);
    } else if (MODE == 1) {
      atomicMin(mapped, v);
    } else if (MODE == 2) {
      if (owner == rank) {
        if (v < *reinterpret_cast<volatile unsigned long long*>(own))
          atomicMin(own, v);
      } else {
        cas_min(mapped, v);
      }
    } else if (MODE == 3) {
      cas_min(owner == rank ? own : mapped, v);
    } else if (MODE == 4) {
      unsigned long long* p = owner == rank ? own : mapped;
      if (v < *reinterpret_cast<volatile unsigned long long*>(p))
        atomicMin(p, v);
    } else if (MODE == 5) {
      atomicMin(own, v);
    } else if (MODE == 6) {
      if (owner == rank) atomicMin(own, v);
      else ptx_min(own, owner, v);
    } else if (MODE == 7) {
      ptx_min(own, owner, v);
    } else {  // the high half only, 32 bits (little-endian: word + 4)
      atomicMin(reinterpret_cast<unsigned int*>(mapped) + 1,
                static_cast<unsigned int>(v >> 32));
    }
    const long long at = t * updates + u;
    log_word[at] = cl * C * W + w;
    log_value[at] = static_cast<long long>(
        MODE == 8 ? (v >> 32 << 32) | (kUnreached & 0xffffffffull) : v);
  }
  cluster.sync();
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    out[(cl * C + rank) * W + i] = words[i];
}

template <int MODE>
static int launch(int clusters, int C, int threads, int W, int updates,
                  unsigned long long seed, void* out, void* log_word,
                  void* log_value) {
  const size_t smem = sizeof(unsigned long long) * W;
  cudaError_t err = cudaFuncSetAttribute(
      probe<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, probe<MODE>, W, updates, seed,
                           static_cast<unsigned long long*>(out),
                           static_cast<long long*>(log_word),
                           static_cast<long long*>(log_value));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceSynchronize();
}

extern "C" int dsmem_probe(int mode, int clusters, int C, int threads, int W,
                           int updates, unsigned long long seed, void* out,
                           void* log_word, void* log_value) {
  switch (mode) {
    case 0: return launch<0>(clusters, C, threads, W, updates, seed, out,
                             log_word, log_value);
    case 1: return launch<1>(clusters, C, threads, W, updates, seed, out,
                             log_word, log_value);
    case 2: return launch<2>(clusters, C, threads, W, updates, seed, out,
                             log_word, log_value);
    case 3: return launch<3>(clusters, C, threads, W, updates, seed, out,
                             log_word, log_value);
    case 4: return launch<4>(clusters, C, threads, W, updates, seed, out,
                             log_word, log_value);
    case 5: return launch<5>(clusters, C, threads, W, updates, seed, out,
                             log_word, log_value);
    case 6: return launch<6>(clusters, C, threads, W, updates, seed, out,
                             log_word, log_value);
    case 7: return launch<7>(clusters, C, threads, W, updates, seed, out,
                             log_word, log_value);
    case 8: return launch<8>(clusters, C, threads, W, updates, seed, out,
                             log_word, log_value);
  }
  return (int)cudaErrorInvalidValue;
}
"""


def build():
    """The probe's library, built by ``ops.nvcc`` from :data:`SOURCE`
    written into the build directory: (ctypes.CDLL, library path)."""
    from ..ops import nvcc
    src = nvcc.BUILD_DIR / "dsmem_atomics.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(SOURCE)
    lib, _log = nvcc.load(src, "dsmem_atomics")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dsmem_probe.argtypes = [i, i, i, i, i, i, ctypes.c_ulonglong, p, p,
                                p]
    lib.dsmem_probe.restype = i
    return lib, nvcc.library_path(src, "dsmem_atomics")


def run_once(lib, mode: int, C: int, W: int, seed: int, dev):
    """One launch of way ``mode`` at clusters of ``C`` blocks and ``W``
    words a block: (words checked, words above their least candidate,
    words below it)."""
    import torch
    n_words = CLUSTERS * C * W
    n_log = CLUSTERS * C * THREADS * UPDATES
    out = torch.empty(n_words, dtype=torch.int64, device=dev)
    log_word = torch.empty(n_log, dtype=torch.int64, device=dev)
    log_value = torch.empty(n_log, dtype=torch.int64, device=dev)
    err = lib.dsmem_probe(mode, CLUSTERS, C, THREADS, W, UPDATES, seed,
                          out.data_ptr(), log_word.data_ptr(),
                          log_value.data_ptr())
    if err != 0:
        raise RuntimeError(f"dsmem probe {MODES[mode]} at C={C}, W={W}: "
                           f"CUDA error {err}")
    want = torch.full((n_words,), UNREACHED, dtype=torch.int64, device=dev)
    want.scatter_reduce_(0, log_word, log_value, "amin")
    return n_words, int((out > want).sum()), int((out < want).sum())


def sass_atomics(path) -> dict:
    """{kernel: sorted atomic opcodes} in ``cuobjdump -sass`` of the
    library at ``path`` (empty without cuobjdump)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                              text=True, timeout=120).stdout
    except OSError:
        return {}
    found: dict = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            found.setdefault(name, set())
            continue
        m = re.search(r"\b((?:ATOM|RED)[A-Z]*(?:\.[A-Z0-9_]+)*)", line)
        if name and m:
            found[name].add(m.group(1))
    return {k: sorted(v) for k, v in found.items() if v}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5,
                    help="launches of each way, width and W (seeds 1..)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("the DSMEM probe needs a CUDA card", file=sys.stderr)
        return 1
    from ..ops import nvcc, route_relax
    dev = torch.device("cuda", 0)
    lib, path = build()
    results = []
    for mode, name in enumerate(MODES):
        for C in (2, 4, 8):
            for W in (256, 4096):
                words = lost = below = 0
                for rep in range(args.reps):
                    n, high, low = run_once(lib, mode, C, W, 1 + rep, dev)
                    words += n
                    lost += high
                    below += low
                results.append({"way": name, "C": C, "W": W,
                                "runs": args.reps, "words": words,
                                "lost": lost, "below": below})
                print(f"[dsmem] {name}, clusters of {C}, {W} words a "
                      f"block: {lost} of {words} words lost a minimum, "
                      f"{below} below it, over {args.reps} runs",
                      flush=True)
    route_relax.build()
    sass = {"probe": sass_atomics(path),
            "route_relax": sass_atomics(nvcc.library_path(
                route_relax.SOURCE, "route_relax"))}
    for lib_name, kernels in sass.items():
        for kernel, opcodes in kernels.items():
            print(f"[dsmem] sass {lib_name} {kernel}: {' '.join(opcodes)}",
                  flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "results": results, "sass": sass}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
