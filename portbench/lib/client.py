"""The closed-loop load generator of the ``/report`` cells, in a process
of its own so that its threads do not share the service's interpreter
lock: frozen from ``chip_smoke.py`` ``client_main`` (:2294-2364).

    python3 -m portbench.lib.client URL REQUESTS OUT CLIENTS WARM SECONDS

``REQUESTS`` is a JSON file {"warm": [body, ...], "timed": [body, ...]}
of request bodies (strings). ``CLIENTS`` threads, each one connection
that waits for its answer before it sends again, first send every warm
body once; then, from one common start, they send the timed bodies in
turn, each taking the next as it comes free, until ``SECONDS`` have
passed since that start: a request in flight then is answered and
counted, and no new one is sent. ``OUT`` receives {"t0": the first timed
send (``time.perf_counter``, the system's monotonic clock), "answers":
[[request index, status, sent, answered, body], ...]} with every body
of a 200 answer.
"""
from __future__ import annotations

import itertools
import json
import sys
import threading
import time
import urllib.error
import urllib.request


def post(url: str, data: bytes):
    """(status, body) of one POST."""
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def drive(url: str, bodies: list, clients: int, seconds: float) -> tuple:
    """Send ``bodies`` from ``clients`` threads: each once when
    ``seconds`` is 0, else in turn until ``seconds`` have passed.
    Returns (start, [(index, status, sent, answered, body)])."""
    order = itertools.count()
    done, errors = [], []
    t0 = time.perf_counter()

    def client():
        try:
            while True:
                i = next(order)
                if (seconds and time.perf_counter() - t0 >= seconds) or \
                        (not seconds and i >= len(bodies)):
                    return
                sent = time.perf_counter()
                st, body = post(url, bodies[i % len(bodies)].encode())
                done.append((i, st, sent, time.perf_counter(),
                             body.decode() if st == 200 else ""))
        except BaseException as e:  # re-raised after the join
            errors.append(e)

    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return t0, sorted(done)


def main(url, reqs_path, out_path, clients, warm, seconds) -> int:
    with open(reqs_path) as f:
        reqs = json.load(f)
    clients = int(clients)
    # urllib's first use in many threads at once races its lazy set-up:
    # one request from this thread first
    post(url, reqs["warm"][0].encode())
    if int(warm):
        drive(url, reqs["warm"], clients, 0)
    # the harness opens its window span on this marker
    open(out_path + ".timed", "w").close()
    t0, answers = drive(url, reqs["timed"], clients, float(seconds))
    with open(out_path, "w") as f:
        json.dump({"t0": t0, "answers": answers}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
