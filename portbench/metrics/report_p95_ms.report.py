"""The 95th percentile of the window's ``/report`` latencies, timed by
the client process from each request's send to its answer."""


def read(obs):
    lat = obs.extra.get("latency_ms")
    if not lat:
        return None
    return lat[min(len(lat) - 1, int(0.95 * len(lat)))]
