"""Pluggable raw-message formatter, configured by the reference's one-string
format (reference: Formatter.java:36-51 and README "Kafka-based Reporter").
The port of ``reporter_tpu/streaming/formatter.py``.

The first character of the config string is the argument separator; the
first argument picks the type:

  sv:    separator regex, uuid col, lat col, lon col, time col, accuracy
         col, optional date pattern      (Formatter.java:42-44)
  json:  uuid key, lat key, lon key, time key, accuracy key, optional
         date pattern                    (Formatter.java:46-47)

Examples (from the reference README):
  ",sv,\\|,1,9,10,0,5,yyyy-MM-dd HH:mm:ss"
  "@json@id@latitude@longitude@timestamp@accuracy"

Date patterns are the Java/joda style the reference documents; the common
tokens are translated to strptime. Without a pattern, the time field is
epoch seconds.
"""
from __future__ import annotations

import calendar
import json
import math
import re
import time as _time
from typing import Optional, Tuple

from ..core.types import Point

# Java/joda date tokens -> strptime, longest first
_JAVA_TOKENS = [
    ("yyyy", "%Y"), ("yy", "%y"), ("MM", "%m"), ("dd", "%d"),
    ("HH", "%H"), ("mm", "%M"), ("ss", "%S"), ("SSS", "%f"),
]


def java_date_to_strptime(pattern: str) -> str:
    out = pattern
    for java, py in _JAVA_TOKENS:
        out = out.replace(java, py)
    return out


class Formatter:
    def __init__(self, kind: str, *, separator: Optional[str] = None,
                 uuid_field=None, lat_field=None, lon_field=None,
                 time_field=None, accuracy_field=None,
                 time_format: Optional[str] = None):
        if kind not in ("sv", "json"):
            raise ValueError("Unsupported raw format parser")
        self.kind = kind
        self.separator = separator
        self.uuid_field = uuid_field
        self.lat_field = lat_field
        self.lon_field = lon_field
        self.time_field = time_field
        self.accuracy_field = accuracy_field
        self.time_format = java_date_to_strptime(time_format) \
            if time_format else None

    @classmethod
    def from_config(cls, config: str) -> "Formatter":
        """Parse the one-string config (reference: Formatter.java:36-51)."""
        sep, rest = config[0], config[1:]
        args = rest.split(sep)
        if args[0] == "sv":
            return cls(
                "sv", separator=args[1],
                uuid_field=int(args[2]), lat_field=int(args[3]),
                lon_field=int(args[4]), time_field=int(args[5]),
                accuracy_field=int(args[6]),
                time_format=args[7] if len(args) > 7 else None)
        if args[0] == "json":
            return cls(
                "json",
                uuid_field=args[1], lat_field=args[2], lon_field=args[3],
                time_field=args[4], accuracy_field=args[5],
                time_format=args[6] if len(args) > 6 else None)
        raise ValueError("Unsupported raw format parser")

    def _parse_time(self, value) -> int:
        if self.time_format is not None:
            st = _time.strptime(str(value), self.time_format)
            return calendar.timegm(st)
        return int(value)

    def format(self, message: str) -> Tuple[str, Point]:
        """Raw message -> (uuid, Point); raises on unparseable input, which
        callers log and skip (reference: KeyedFormattingProcessor.java:39-41).
        """
        if self.kind == "sv":
            parts = re.split(self.separator, message.rstrip("\r\n"))
            get = lambda i: parts[i]  # noqa: E731
        else:
            node = json.loads(message)
            get = lambda k: node[k]  # noqa: E731
        lat = float(get(self.lat_field))
        lon = float(get(self.lon_field))
        tm = self._parse_time(get(self.time_field))
        accuracy = int(math.ceil(float(get(self.accuracy_field))))
        uuid = str(get(self.uuid_field))
        return uuid, Point(lat, lon, accuracy, tm)
