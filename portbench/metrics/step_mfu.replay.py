"""The whole window's share of the card's float32 peak: the decode's
operations over every launch of the window (``lib/roofline.py`` from the
dispatch records' shapes) per second of window, over 67 TFLOP/s. It
bounds what taking the decode kernel off the path could claim."""
from portbench.lib import roofline


def read(obs):
    ops = sum(n * roofline.wire_ops(B, T, K) for B, T, K, n in obs.shapes)
    if ops <= 0 or obs.window_s <= 0:
        return None
    return 100.0 * ops / obs.window_s / roofline.F32_OPS_PER_S
