"""Traces per ``match_many`` call of the service's dispatcher over the
window (its ``dispatch.traces`` and ``dispatch.batches`` counters)."""


def read(obs):
    batches = obs.counters.get("dispatch.batches")
    if not batches:
        return None
    return obs.counters.get("dispatch.traces", 0) / batches
