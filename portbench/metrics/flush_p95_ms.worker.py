"""The streaming batcher's flush, 95th percentile in milliseconds (the
program's ``batcher.flush`` timer over the window)."""


def read(obs):
    t = obs.timers.get("batcher.flush")
    if not t or not t.get("count"):
        return None
    return t["p95_s"] * 1e3
