"""What the readers of the program's timers share."""


def us_per_probe(obs, *names):
    """The summed seconds of the program's timers ``names`` over the
    window, in microseconds a probe; None when the run timed none of
    them or counted no probe."""
    timed = [obs.timers[n]["total_s"] for n in names if n in obs.timers]
    if not timed or obs.work <= 0:
        return None
    return sum(timed) * 1e6 / obs.work
