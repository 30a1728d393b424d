"""The card's idle share of the replay window: 100% less the union of its
kernel, memcpy and memset intervals over the window (``lib/devtrace.py``)."""


def read(obs):
    d = obs.device
    if d is None or d.window_s <= 0 or d.busy_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)
