"""The incremental step kernel's share of its roofline over the window: the
least time of the window's launches (``lib/incremental_roofline.py``,
from the program's counts of the real steps and rows they held and the
configuration's K) over the profiler's time of the kernel
``incremental_steps`` launches (``incremental_packed`` for K up to 32,
``incremental_rows`` past it)."""
from portbench.lib import incremental_roofline

KERNELS = ("incremental_packed", "incremental_rows")


def read(obs):
    K = obs.extra.get("K")
    kept = obs.counters.get("match.incremental.cells.kept")
    rows = obs.counters.get("match.incremental.rows.launched")
    if obs.device is None or not K or not kept or not rows:
        return None
    seconds = sum(obs.device.kernel_seconds(k)[0] for k in KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * incremental_roofline.bound_s(kept, rows, K) / seconds
