"""Host prep's candidates phase, thread-summed CPU microseconds a probe
(``prep.phase.candidates_ns`` over the window)."""


def read(obs):
    ns = obs.counters.get("prep.phase.candidates_ns")
    if not ns or obs.work <= 0:
        return None
    return ns / 1e3 / obs.work
