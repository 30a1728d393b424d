"""Replay producer: flat file / stdin -> Kafka topic or stream worker.

The framework's equivalent of the reference's ``py/cat_to_kafka.py`` and the
``py/make_requests.sh`` replay driver: every input line passes through
user-supplied ``--key-with`` / ``--value-with`` / ``--send-if`` lambda
strings (reference: cat_to_kafka.py:30-40), with throughput logged every
10k lines (cat_to_kafka.py:59-61). make_requests.sh's bbox gate and
per-uuid keying (make_requests.sh:38-46) are expressible as lambdas, but
``--bbox`` + ``--key-index`` shortcuts cover the common case without one.

Sinks: a Kafka topic (when the client library is installed), stdout
(default — pipe into ``python -m reporter_tpu_torch stream``), or /dev/null
(``--sink null`` for rate testing).
"""
from __future__ import annotations

import argparse
import logging
import sys
import time

logger = logging.getLogger("reporter_tpu_torch.replay")

LOG_EVERY = 10000  # reference: cat_to_kafka.py:59


def _compile_lambda(src: str | None, what: str):
    if not src:
        return None
    fn = eval(src)  # the reference accepts arbitrary lambdas the same way
    if not callable(fn):
        raise argparse.ArgumentTypeError(f"--{what} must be a lambda")
    return fn


def bbox_send_if(bbox: list[float], sep: str, lat_i: int, lon_i: int):
    """A --send-if shortcut: keep separated-value lines whose lat/lon fall
    inside (min_lon, min_lat, max_lon, max_lat)
    (reference: make_requests.sh:38-44)."""
    min_lon, min_lat, max_lon, max_lat = bbox

    def send_if(line: str) -> bool:
        cols = line.rstrip("\n").split(sep)
        try:
            lat, lon = float(cols[lat_i]), float(cols[lon_i])
        except (IndexError, ValueError):
            return False
        return min_lat <= lat <= max_lat and min_lon <= lon <= max_lon

    return send_if


def replay(lines, sink, key_with=None, value_with=None, send_if=None,
           rate: float | None = None) -> tuple[int, int]:
    """Pump lines through the lambda gauntlet into ``sink(key, value)``.

    Returns (sent, total). Per-line failures are logged and skipped
    (reference: cat_to_kafka.py:62-65).
    """
    sent = total = 0
    interval = 1.0 / rate if rate else 0.0
    next_at = time.monotonic()
    for line in lines:
        total += 1
        try:
            stripped = line.rstrip("\n")
            if send_if is not None and not send_if(stripped):
                continue
            key = key_with(stripped) if key_with else None
            value = value_with(stripped) if value_with else stripped
            if rate:
                now = time.monotonic()
                if now < next_at:
                    time.sleep(next_at - now)
                next_at = max(next_at + interval, now - 1.0)
            sink(key, value)
            sent += 1
            if sent % LOG_EVERY == 0:
                logger.info("Sent %d messages of %d total", sent, total)
        except Exception:
            logger.exception("With line: %s", line.rstrip("\n"))
    logger.info("Finished sending %d messages of %d total", sent, total)
    return sent, total


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="reporter-replay",
        description="Replay a flat file (or stdin) into a Kafka topic or "
                    "stdout, with key/value/filter lambdas")
    parser.add_argument("file", help="file to read, '-' for stdin")
    parser.add_argument("--bootstrap",
                        help="Kafka bootstrap servers; omit for stdout")
    parser.add_argument("--topic", default="raw")
    parser.add_argument("--key-with",
                        help='e.g. \'lambda line: line.split("|")[0]\'')
    parser.add_argument("--value-with")
    parser.add_argument("--send-if")
    parser.add_argument("--bbox", help="min_lon,min_lat,max_lon,max_lat "
                        "shortcut filter for separated-value input")
    parser.add_argument("--separator", default="|")
    parser.add_argument("--lat-index", type=int, default=2)
    parser.add_argument("--lon-index", type=int, default=3)
    parser.add_argument("--rate", type=float,
                        help="max messages/sec (soak testing)")
    parser.add_argument("--sink", choices=("auto", "stdout", "null"),
                        default="auto")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    key_with = _compile_lambda(args.key_with, "key-with")
    value_with = _compile_lambda(args.value_with, "value-with")
    send_if = _compile_lambda(args.send_if, "send-if")
    if args.bbox:
        if send_if is not None:
            parser.error("--bbox and --send-if are mutually exclusive")
        send_if = bbox_send_if([float(x) for x in args.bbox.split(",")],
                               args.separator, args.lat_index, args.lon_index)

    if args.bootstrap and args.sink == "auto":
        from ..streaming.broker import KafkaBroker
        broker = KafkaBroker(args.bootstrap)

        def sink(key, value):
            broker.produce(args.topic, key, value.encode())
    elif args.sink == "null":
        def sink(key, value):
            pass
    else:
        def sink(key, value):
            sys.stdout.write(value + "\n")

    handle = sys.stdin if args.file == "-" else open(args.file)
    try:
        replay(handle, sink, key_with, value_with, send_if, rate=args.rate)
    finally:
        if handle is not sys.stdin:
            handle.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
