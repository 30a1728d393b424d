"""One-shot dead-letter replay: drain a worker's spools by hand.

The streaming worker drains its own spools when its ``worker`` config
block sets ``replay_interval_s`` (``streaming/drainer.py``); this command
drives the same drainer once against a spool directory, for split
deployments and operators. Spooled ``.traces`` bodies are /report-ready
request JSON (re-POSTed to any matcher service: ``--url``); spooled
tiles are flush-layout CSV (re-egressed to any sink the worker could have
written: a directory, an http(s) endpoint or an S3 bucket).

A /report response is observations, and observations re-enter the world
only through a privacy-culling anonymiser: trace replay builds one, and
the recovered segments are culled, tiled and flushed into ``--sink``
(and teed into ``--datastore``) under this run's own source name
(default ``replay-<pid>``, so recovered tile files never collide with a
live writer's or an earlier replay's). Pass the worker's ``--privacy``
and ``--quantisation``. ``--discard-responses`` is the opt-out for the
one deployment where dropping them is right: the remote service owns its
own downstream pipeline.

Usage::

  # re-POST spooled trace JSON; recovered observations re-enter through a
  # real anonymiser into the sink (and the datastore, ledger-deduped)
  python -m reporter_tpu_torch.tools.replay_cli --spool OUT/.deadletter \\
      --url http://host:8002/report --privacy 5 --quantisation 3600 \\
      --sink OUT --datastore STORE

  # re-egress spooled tiles only (no trace replay)
  python -m reporter_tpu_torch.tools.replay_cli --spool OUT/.deadletter \\
      --sink OUT

An S3 sink takes its credentials as ``--aws-access-key-id`` and
``--aws-secret-access-key`` (without them bucket egress fails closed, as
the worker's does). Entries still failing after ``--attempts`` move to
``.quarantine`` (which every scanner skips) instead of wedging the
drain; the exit is 0 only when the spools it was asked to drain are
empty.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m reporter_tpu_torch.tools.replay_cli",
        description=__doc__.splitlines()[0])
    parser.add_argument("--spool", required=True,
                        help="tile dead-letter root (the worker's "
                             "<output>/.deadletter); trace JSON is "
                             "expected under its .traces directory")
    parser.add_argument("--url",
                        help="matcher /report endpoint to re-POST spooled "
                             "trace JSON to; needs --privacy, "
                             "--quantisation and --sink (the recovery "
                             "pipeline) or --discard-responses")
    parser.add_argument("--sink",
                        help="tile sink (directory, http(s) or s3) that "
                             "spooled tiles re-egress into, and that "
                             "trace-replay recoveries flush into")
    parser.add_argument("--datastore",
                        help="histogram store directory: spooled tiles "
                             "also replay into it (ledger-deduped), and "
                             "trace-replay recoveries tee into it")
    parser.add_argument("--privacy", type=int,
                        help="privacy threshold of the trace-replay "
                             "anonymiser (use the worker's)")
    parser.add_argument("--quantisation", type=int,
                        help="tile time quantisation, s, of the "
                             "trace-replay anonymiser (the worker's)")
    parser.add_argument("--mode", default="auto",
                        help="travel mode of the recovery anonymiser "
                             "(default auto)")
    parser.add_argument("--source", default=f"replay-{os.getpid()}",
                        help="source name stamped into recovered tile "
                             "files (default replay-<pid>)")
    parser.add_argument("--discard-responses", action="store_true",
                        help="replay traces without a local recovery "
                             "pipeline: right only when the remote "
                             "service owns its own downstream pipeline")
    parser.add_argument("--attempts", type=int, default=5,
                        help="attempts an entry before .quarantine "
                             "(default 5)")
    parser.add_argument("--aws-access-key-id", default=None,
                        help="S3 credentials of a bucket --sink")
    parser.add_argument("--aws-secret-access-key", default=None)
    args = parser.parse_args(argv)
    if not args.url and not args.sink and not args.datastore:
        parser.error("nothing to do: pass --url, --sink and/or --datastore")
    if args.url and not args.discard_responses and not (
            args.privacy and args.quantisation and args.sink):
        parser.error(
            "--url replays observations: give them a pipeline to land in "
            "(--privacy N --quantisation S --sink DIR, the worker's "
            "knobs) or pass --discard-responses if the remote service "
            "owns its own downstream pipeline")

    from ..datastore import LocalDatastore
    from ..streaming.anonymiser import Anonymiser, TileSink
    from ..streaming.drainer import DeadLetterDrainer
    from ..streaming.worker import http_submitter
    from ..utils import metrics

    credentials = None
    if args.aws_access_key_id or args.aws_secret_access_key:
        credentials = (args.aws_access_key_id, args.aws_secret_access_key)
    sink = TileSink(args.sink, credentials=credentials) if args.sink \
        else None
    datastore = LocalDatastore(args.datastore) if args.datastore else None

    recovery = None
    if args.url and not args.discard_responses:
        tee = None
        if datastore is not None:
            def tee(_tile, segments, ingest_key=None, _ds=datastore):
                return _ds.ingest_segments(segments, ingest_key=ingest_key)
        recovery = Anonymiser(sink, privacy=args.privacy,
                              quantisation=args.quantisation,
                              mode=args.mode, source=args.source, tee=tee)

    drainer = DeadLetterDrainer(
        args.spool,
        submit=http_submitter(args.url) if args.url else None,
        forward=recovery.process if recovery is not None else None,
        sink=sink, datastore=datastore, max_attempts=args.attempts)
    before = drainer.backlog()
    drained = drainer.drain_now()
    recovered_tiles = recovery.punctuate() if recovery is not None else 0
    after = drainer.backlog()
    snap = metrics.default.snapshot()["counters"]
    print(json.dumps({
        "before": before, "drained": drained, "after": after,
        "quarantined": snap.get("replay.quarantined", 0),
        "traces": {"ok": snap.get("replay.traces.ok", 0),
                   "fail": snap.get("replay.traces.fail", 0)},
        "tiles": {"ok": snap.get("replay.tiles.ok", 0),
                  "fail": snap.get("replay.tiles.fail", 0)},
        "recovered_tiles": recovered_tiles,
    }, indent=2))
    left = (after["traces"] if args.url else 0) + \
        (after["tiles"] if args.sink or args.datastore else 0)
    return 0 if left == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
