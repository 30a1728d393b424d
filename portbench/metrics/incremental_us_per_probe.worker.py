"""Wall microseconds inside the worker's ``submit_many`` callable
(``ReporterService.report_incremental``: the incremental decode, the
declined slots' batch path and ``report()``) per probe it answered."""


def read(obs):
    s = obs.spans.get("submit_many")
    if s is None or obs.work <= 0:
        return None
    return s * 1e6 / obs.work
