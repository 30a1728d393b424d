"""Datastore CLI: ingest / compact / query / profile over a histogram store.

  python -m reporter_tpu_torch datastore ingest  <store> <results-dir> [--delete]
  python -m reporter_tpu_torch datastore compact <store> [--level L] [--index I]
  python -m reporter_tpu_torch datastore query   <store> --segment ID
                                  [--segments A,B,C]
                                  [--bbox MINLON,MINLAT,MAXLON,MAXLAT
                                   --bbox-level L]
                                  [--hours 7-9|7,8,9]
                                  [--t0 EPOCH --t1 EPOCH]
                                  [--percentiles 25,50,75,95]
                                  [--window 5m|90s|inf]
  python -m reporter_tpu_torch datastore feed    <store> [--bbox ... --level L]
                                  [--cursor N] [--timeout S]
                                  [--max-polls N]
  python -m reporter_tpu_torch datastore profile <store> [--graph city.npz
                                  --replay traces.jsonl [--device cpu]]
                                  [--cap N] [--city NAME]
  python -m reporter_tpu_torch datastore stats   <store>

Every command takes ``--config conf.json``, the service's config file
(``service/server.py`` ``read_config``): its ``datastore`` object's
knobs (``ledger_max``, ``lease_ttl_s``, ``freshness*``,
``handle_cache_size``) size the store at ``<store>``, as they do for the
server and the worker that mount the same store; without it the store
takes the defaults.
``ingest`` replays any directory in the anonymiser's flush layout — a
results dir OR its ``.deadletter`` spool; ``--delete`` removes each tile
file after a successful append (the dead-letter replay contract).
``--segments`` / ``--bbox`` serve many segments through ONE
``query_many`` sweep per partition (datastore/query.py); ``--window``
answers from the freshness tier's recent-delta overlay (``5m``-style
specs; ``inf`` merges overlay + compacted — see "Freshness tier" in
the README). ``feed`` tails a change-feed cursor over the store: each
long-poll prints one JSON line (events + next cursor) and the next
poll resumes from it, so ``--max-polls N`` makes it scriptable the way
the query commands are; cross-process commits surface via the store
watcher, which the command forces once per poll. ``profile``
with ``--replay`` runs the request JSONs (one per line) through a
matcher on ``--graph`` and commits the native route memo's resident
pairs as the store's ``.profile`` pre-warm artifact; without
``--replay`` it prints the committed artifact's summary. The replay
decodes on the card (``viterbi_decode``) unless given ``--device cpu``,
and raises without one; every other command is host work and takes no
device. All output is one JSON object per line, metrics timers
included, so the commands compose in scripts. The port of
``reporter_tpu/tools/datastore_cli.py``.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..datastore import LocalDatastore, parse_hours_spec
from ..utils import metrics


def _profile(ds, args) -> dict:
    """``profile`` subcommand body: export (with --replay) or show."""
    from ..datastore.profile import (
        export_profile,
        load_profile,
        profile_path,
    )
    path = args.out or profile_path(ds.root)
    if args.replay is None:
        art = load_profile(path)
        if art is None:
            return {"path": path, "present": False}
        return {"path": path, "present": True, "city": art.get("city"),
                "n_pairs": art.get("n_pairs"),
                "memo_stats": art.get("memo_stats")}
    if not args.graph:
        raise SystemExit("profile --replay needs --graph")
    from ..graph.network import RoadNetwork
    from ..matcher import SegmentMatcher
    matcher = SegmentMatcher(RoadNetwork.load(args.graph),
                             device=args.device)
    reqs = []
    with open(args.replay, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                reqs.append(json.loads(line))
    # chunked replay: warm the memo the way serving traffic would
    for i in range(0, len(reqs), 256):
        matcher.match_many(reqs[i:i + 256])
    art = export_profile(matcher, path, cap=args.cap, city=args.city)
    return {"path": path, "n_pairs": art["n_pairs"],
            "replayed": len(reqs), "memo_stats": art["memo_stats"]}


def _open_store(parser, args) -> LocalDatastore:
    """The store at ``args.store``, with the knobs of ``--config``'s
    ``datastore`` object where one is given: the route by which the
    server and the worker mount it."""
    if args.config is None:
        return LocalDatastore(args.store)
    from ..service.server import datastore_from_config, read_config
    try:
        return datastore_from_config(read_config(args.config),
                                     root=args.store)
    except (OSError, ValueError, TypeError) as e:
        parser.error(f"--config {args.config}: {e}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="reporter-datastore", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--config", default=None,
                        help="the service's JSON config file: its "
                             "datastore object's knobs size the store")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_ing = sub.add_parser("ingest", parents=[common],
                           help="replay flushed tiles into the store")
    p_ing.add_argument("store")
    p_ing.add_argument("source", help="results or dead-letter directory")
    p_ing.add_argument("--delete", action="store_true",
                       help="remove each tile file after a successful "
                            "append (dead-letter replay)")
    p_ing.add_argument("--limit", type=int, default=None)

    p_cmp = sub.add_parser("compact", parents=[common],
                           help="merge partition deltas")
    p_cmp.add_argument("store")
    p_cmp.add_argument("--level", type=int, default=None)
    p_cmp.add_argument("--index", type=int, default=None)
    p_cmp.add_argument("--max-deltas", type=int, default=None,
                       help="automatic policy: only compact partitions "
                            "with more than N uncompacted deltas")
    p_cmp.add_argument("--max-delta-bytes", type=int, default=None,
                       help="automatic policy: only compact partitions "
                            "whose uncompacted deltas exceed B bytes")

    p_qry = sub.add_parser("query", parents=[common],
                           help="segment speed histograms "
                           "(single, batched list, or bbox)")
    p_qry.add_argument("store")
    p_qry.add_argument("--segment", type=int, default=None)
    p_qry.add_argument("--segments", default=None,
                       help="comma-separated ids served through one "
                            "query_many sweep")
    p_qry.add_argument("--bbox", default=None,
                       help="min_lon,min_lat,max_lon,max_lat — every "
                            "resident segment of --bbox-level inside")
    p_qry.add_argument("--bbox-level", type=int, default=2)
    p_qry.add_argument("--max-segments", type=int, default=None,
                       help="bbox fan-out bound (explicit truncation)")
    p_qry.add_argument("--hours", default=None,
                       help="hour-of-week subset: '7-9' or '7,8,9'")
    p_qry.add_argument("--t0", type=int, default=None,
                       help="epoch range start (with --t1; alternative "
                            "to --hours)")
    p_qry.add_argument("--t1", type=int, default=None)
    p_qry.add_argument("--percentiles", default=None,
                       help="comma-separated, e.g. 25,50,75,95")
    p_qry.add_argument("--window", default=None,
                       help="freshness window: '5m'/'90s'/seconds for "
                            "recent-overlay-only answers, 'inf' for "
                            "overlay+compacted merge; omit for the "
                            "compacted store only")

    p_fed = sub.add_parser("feed", parents=[common],
                           help="tail a change-feed cursor "
                           "(one JSON line per long-poll)")
    p_fed.add_argument("store")
    p_fed.add_argument("--bbox", default=None,
                       help="min_lon,min_lat,max_lon,max_lat viewport "
                            "filter (needs --level)")
    p_fed.add_argument("--level", type=int, default=None)
    p_fed.add_argument("--cursor", type=int, default=-1,
                       help="resume cursor; -1 = from now")
    p_fed.add_argument("--timeout", type=float, default=25.0,
                       help="seconds each long-poll blocks")
    p_fed.add_argument("--max-polls", type=int, default=0,
                       help="stop after N polls (0 = forever)")

    p_prf = sub.add_parser("profile", parents=[common],
                           help="route-memo pre-warm "
                           "artifact: export from a replay, or show")
    p_prf.add_argument("store")
    p_prf.add_argument("--graph", default=None,
                       help="RoadNetwork .npz to replay against")
    p_prf.add_argument("--replay", default=None,
                       help="request JSONs, one per line (the /report "
                            "body shape); replayed through match_many "
                            "to warm the memo before export")
    p_prf.add_argument("--cap", type=int, default=1 << 16,
                       help="max pairs exported")
    p_prf.add_argument("--city", default=None,
                       help="city name stamped into the artifact")
    p_prf.add_argument("--out", default=None,
                       help="artifact path (default <store>/.profile)")
    p_prf.add_argument("--device", default="cuda",
                       help="the replay's device: cuda (default), cuda:I "
                            "or cpu")

    p_sts = sub.add_parser("stats", parents=[common],
                           help="partition/segment/byte totals")
    p_sts.add_argument("store")

    args = parser.parse_args(argv)
    ds = _open_store(parser, args)

    if args.cmd == "ingest":
        out = ds.ingest_dir(args.source, delete=args.delete,
                            limit=args.limit)
        out["metrics"] = metrics.snapshot()["timers"]
        # clean exit hands the writer lease back (a successor acquires
        # a vacant lease instead of logging a dead-pid steal)
        ds.lease.release()
    elif args.cmd == "compact":
        out = ds.compact(level=args.level, index=args.index,
                         max_deltas=args.max_deltas,
                         max_delta_bytes=args.max_delta_bytes)
        ds.lease.release()
    elif args.cmd == "query":
        hours = parse_hours_spec(args.hours)
        if hours is None and args.t0 is not None and args.t1 is not None:
            from ..datastore import hours_for_range
            hours = hours_for_range(args.t0, args.t1).tolist()
        kwargs = {}
        if args.percentiles:
            kwargs["percentiles"] = [
                float(p) for p in args.percentiles.split(",") if p]
        if args.window is not None:
            from ..datastore.freshness import parse_window
            try:
                parse_window(args.window)
            except ValueError as e:
                parser.error(str(e))
            kwargs["window"] = args.window
        if args.bbox is not None:
            bbox = [float(v) for v in args.bbox.split(",")]
            if args.max_segments is not None:
                kwargs["max_segments"] = args.max_segments
            out = ds.query_bbox(bbox, args.bbox_level, hours=hours,
                                **kwargs)
        elif args.segments is not None:
            ids = [int(s) for s in args.segments.split(",") if s]
            out = {"results": ds.query_many(ids, hours=hours, **kwargs)}
        elif args.segment is not None:
            out = ds.query(args.segment, hours=hours, **kwargs)
        else:
            parser.error("query needs --segment, --segments or --bbox")
    elif args.cmd == "feed":
        tier = ds.enable_freshness()
        if tier is None:
            raise SystemExit("freshness tier disabled")
        bbox = None
        if args.bbox is not None:
            bbox = [float(v) for v in args.bbox.split(",")]
        cursor, polls = args.cursor, 0
        while args.max_polls <= 0 or polls < args.max_polls:
            # surface commits other processes made since the last poll
            # (the in-poll watcher is paced; a CLI tail wants each poll
            # to see the store's latest state)
            tier.feed.watch_store(force=True)
            out = tier.feed.poll(bbox=bbox, level=args.level,
                                 cursor=cursor, timeout_s=args.timeout)
            cursor = out["cursor"]
            polls += 1
            print(json.dumps(out, separators=(",", ":")), flush=True)
        return 0
    elif args.cmd == "profile":
        out = _profile(ds, args)
    else:
        out = ds.stats()

    print(json.dumps(out, separators=(",", ":")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
