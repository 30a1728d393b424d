"""Umbrella CLI: ``python -m reporter_tpu_torch <command> [args...]``.

One front door for every service and tool of the port (the analog of the
reference's scattered entry points: reporter-kafka jar,
reporter_service.py, simple_reporter.py, cat_to_kafka.py, get_tiles.py,
PrintConsumer):

  serve            matcher HTTP service (/report)           [reporter_service]
  stream           streaming worker (format/batch/anonymise) [reporter-kafka]
  pipeline         batched 3-stage historical pipeline      [simple_reporter]
  replay           flat file/stdin -> topic/stdout producer [cat_to_kafka]
  print-consumer   debug-print a topic                      [PrintConsumer]
  tiles            list/download graph tiles for a bbox     [get_tiles et al]
  synth            synthetic GPS trace generator      [generate_test_trace]
  accuracy         matcher accuracy gate against synthetic ground truth
  datastore        histogram datastore: ingest/compact/query/feed/profile
  graph            road networks: build, import OSM, tile, untile, inspect

The commands that decode (serve, stream, pipeline, accuracy, and
datastore profile --replay) run on the card unless given ``--device cpu``.
serve, stream and pipeline read their config's ``lockcheck`` before
they load: ``"raw"`` makes every lock of the process a bare one.
"""
from __future__ import annotations

import json
import sys

COMMANDS = {}
#: where the commands that read a service config take its path: a flag,
#: or None for serve's first positional argument (each of serve's
#: options takes a value)
CONFIG_ARGS = {"serve": None, "stream": "--config",
               "pipeline": "--match-config"}


def _cmd(name):
    def register(loader):
        COMMANDS[name] = loader
        return loader
    return register


@_cmd("serve")
def _serve():
    from .service.server import main
    return main


@_cmd("stream")
def _stream():
    from .streaming.worker import main
    return main


@_cmd("pipeline")
def _pipeline():
    from .pipeline.simple_reporter import main
    return main


@_cmd("replay")
def _replay():
    from .tools.replay import main
    return main


@_cmd("print-consumer")
def _print_consumer():
    from .tools.print_consumer import main
    return main


@_cmd("tiles")
def _tiles():
    from .tools.tiles_cli import main
    return main


@_cmd("synth")
def _synth():
    from .tools.synth_cli import main
    return main


@_cmd("accuracy")
def _accuracy():
    from .tools.accuracy_cli import main
    return main


@_cmd("datastore")
def _datastore():
    from .tools.datastore_cli import main
    return main


@_cmd("graph")
def _graph():
    from .tools.graph_cli import main
    return main


def config_path(name, rest):
    """The config file ``rest`` (command ``name``'s arguments) names, or
    None."""
    if name not in CONFIG_ARGS:
        return None
    flag = CONFIG_ARGS[name]
    if flag is not None:
        for i, arg in enumerate(rest):
            if arg == flag:
                return rest[i + 1] if i + 1 < len(rest) else None
            if arg.startswith(flag + "="):
                return arg[len(flag) + 1:]
        return None
    i = 0
    while i < len(rest):
        if not rest[i].startswith("-"):
            return rest[i]
        i += 1 if "=" in rest[i] else 2
    return None


def raw_locks_first(name, rest) -> None:
    """Raw mode (``utils.locks.set_raw``) when the command's config has
    ``lockcheck: "raw"``, before the command's modules load and make
    their locks, as the JAX package's ``REPORTER_TPU_LOCKCHECK=raw``
    does at import. A config that cannot be read is left to the
    command, which reports it."""
    path = config_path(name, rest)
    if path is None:
        return
    try:
        with open(path, encoding="utf-8") as f:
            conf = json.load(f)
    except (OSError, ValueError):
        return
    service = conf.get("service") if isinstance(conf, dict) else None
    if isinstance(service, dict) and service.get("lockcheck") == "raw":
        from .utils import locks
        locks.set_raw()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    name, rest = argv[0], argv[1:]
    if name not in COMMANDS:
        print(f"unknown command {name!r}; one of: "
              + ", ".join(sorted(COMMANDS)), file=sys.stderr)
        return 2
    raw_locks_first(name, rest)
    return COMMANDS[name]()(rest)


if __name__ == "__main__":
    sys.exit(main())
