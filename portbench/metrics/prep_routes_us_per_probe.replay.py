"""Host prep's routes phase, thread-summed CPU microseconds a probe
(the native prep's ``prep.phase.routes_ns`` counter over the window)."""


def read(obs):
    ns = obs.counters.get("prep.phase.routes_ns")
    if not ns or obs.work <= 0:
        return None
    return ns / 1e3 / obs.work
