"""Debug consumer: print a topic's (key, value) stream to stdout.

Equivalent of the reference's PrintConsumer (PrintConsumer.java:24-51,
consumer group "verbose_reporters"): attach to a Kafka topic and print
every record, decoding the framework's binary value types when the topic
carries them (formatted -> Point, segments -> Segment list).
"""
from __future__ import annotations

import argparse
import sys

GROUP = "verbose_reporters"  # reference: PrintConsumer.java:27


def render(topic: str, key, value) -> str:
    """Human-readable record; binary Point/Segment values are decoded."""
    from ..core.types import Point, Segment

    if isinstance(value, (bytes, bytearray)):
        raw = bytes(value)
        if topic.startswith("formatted") and len(raw) == Point.SIZE:
            value = Point.from_bytes(raw)
        elif topic.startswith("segments") and raw and \
                len(raw) % Segment.SIZE == 0:
            value = [Segment.from_bytes(raw, off)
                     for off in range(0, len(raw), Segment.SIZE)]
        else:
            try:
                value = raw.decode()
            except UnicodeDecodeError:
                value = raw.hex()
    return f"{key}={value}"


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="reporter-print-consumer",
        description="Print every record on a topic (debugging)")
    parser.add_argument("--bootstrap", required=True)
    parser.add_argument("--topic", required=True)
    parser.add_argument("--group", default=GROUP)
    args = parser.parse_args(argv)

    from ..streaming.broker import KafkaBroker
    broker = KafkaBroker(args.bootstrap)
    for key, value in broker.consume(args.topic, group=args.group):
        print(render(args.topic, key, value))
    return 0


if __name__ == "__main__":
    sys.exit(main())
