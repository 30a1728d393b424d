"""The drain lane's assembly, wall microseconds a probe (the matcher's
``stage_seconds["assemble"]`` over the window; with the lanes on it
overlaps the other stages, so it is read alone and never summed)."""


def read(obs):
    s = obs.stage_seconds.get("assemble")
    if not s or obs.work <= 0:
        return None
    return s * 1e6 / obs.work
