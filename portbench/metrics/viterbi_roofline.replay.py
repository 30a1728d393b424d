"""The decode kernel's share of its roofline over the window: the least
time of every launch (``lib/roofline.py`` from its shape, bytes on the
float16 wire) summed, over the profiler's time of ``viterbi_kernel``.

The shapes are the program's dispatch records (``obs/profiler.py``), whose
B counts a batch's rows as launched, filler rows included."""
from portbench.lib import roofline


def read(obs):
    if obs.device is None:
        return None
    seconds, launches = obs.device.kernel_seconds("viterbi_kernel")
    if seconds <= 0 or not obs.shapes:
        return None
    bound = sum(n * roofline.bound_s(B, T, K) for B, T, K, n in obs.shapes)
    return 100.0 * bound / seconds
