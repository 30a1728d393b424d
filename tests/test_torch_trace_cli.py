"""The port's trace CLI (``reporter_tpu_torch/tools/trace_cli.py``)
against the JAX repo's ``tools/trace_cli.py``.

``convert`` of the same span records (a bare list, a flight-recorder
dump with in-flight spans, a ``?trace=1`` body and an exported trace)
writes the JAX tool's trace events, byte for byte; ``record --device
cpu`` traces one request through the port's real stack with the span
names and parent structure of the JAX tool's ``record``.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from reporter_tpu_torch.obs import trace as obs_trace
from reporter_tpu_torch.tools import trace_cli

REPO = Path(__file__).resolve().parents[1]
MATCH_SPANS = {"service.request", "dispatch.batch", "matcher.prep",
               "matcher.decode_dispatch", "matcher.decode_wait",
               "matcher.assemble", "report.serialise"}


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX repo's tools/trace_cli.py as a module (nothing run)."""
    spec = importlib.util.spec_from_file_location(
        "jax_trace_cli_tool", REPO / "tools" / "trace_cli.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _records(n=5, pid=None):
    """Span records as the flight recorder and ?trace=1 hold them."""
    out = []
    for i in range(n):
        rec = {"name": f"stage.{i % 3}", "tid": 100 + i % 2,
               "t0_ns": 1_700_000_000_000_000_000 + 1_500 * i,
               "dur_ns": 2_000 + 333 * i, "trace_id": "t-1",
               "span_id": i + 1, "parent_id": i if i else 0,
               "attrs": {"chunk": i, "rows": 8 * i}}
        if pid is not None:
            rec["pid"] = pid
        out.append(rec)
    return out


@pytest.fixture(scope="module")
def recorded():
    """A real ?trace=1 tree from the port's stack (CPU)."""
    return trace_cli.record(2, "cpu")


PAYLOADS = {
    "list": lambda: _records(),
    "list_with_pids": lambda: _records(pid=4242),
    "flightrec": lambda: {"pid": 7, "spans": _records(4),
                          "in_flight": _records(2, pid=7)},
    "report_trace": lambda: {"report": {"segments": []},
                             "trace": {"traceEvents": [{"name": "x"}]}},
    "exported": lambda: {"traceEvents": [{"name": "y", "ph": "X"}],
                         "displayTimeUnit": "ms"},
}


@pytest.mark.parametrize("shape", sorted(PAYLOADS))
def test_convert_writes_the_jax_tools_events(shape, jax_tool, tmp_path):
    src = tmp_path / "in.json"
    src.write_text(json.dumps(PAYLOADS[shape]()))
    outs = []
    for name, main in (("jax", jax_tool.main), ("port", trace_cli.main)):
        out = tmp_path / f"{name}.json"
        assert main(["convert", str(src), "-o", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    assert json.loads(outs[1])["traceEvents"]


def test_convert_of_recorded_spans_equals_the_jax_tools(recorded, jax_tool,
                                                        tmp_path):
    """The records behind a recorded port trace, through both tools."""
    ev = recorded["traceEvents"][0]
    spans = obs_trace.events_for(ev["args"]["trace_id"])
    assert spans
    src = tmp_path / "spans.json"
    src.write_text(json.dumps({"spans": spans, "in_flight": []}))
    outs = []
    for name, main in (("jax", jax_tool.main), ("port", trace_cli.main)):
        out = tmp_path / f"{name}.json"
        assert main(["convert", str(src), "-o", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


def test_unrecognised_payloads_raise_in_both(jax_tool):
    for bad in ("text", {"nothing": 1}):
        with pytest.raises(ValueError):
            trace_cli.spans_from_payload(bad)
        with pytest.raises(ValueError):
            jax_tool.spans_from_payload(bad)


def _tree(obj):
    """{(span name, parent span name)} of a trace-event object."""
    evs = obj["traceEvents"]
    by_id = {e["args"]["span_id"]: e["name"] for e in evs}
    return {(e["name"], by_id.get(e["args"]["parent_id"])) for e in evs}


def test_record_on_the_cpu_traces_the_match_spans(recorded):
    names = {e["name"] for e in recorded["traceEvents"]}
    assert MATCH_SPANS <= names
    assert "kernel.viterbi_decode" not in names  # the plain scan
    evs = recorded["traceEvents"]
    by_id = {e["args"]["span_id"]: e for e in evs}
    for e in evs:
        parent = by_id.get(e["args"]["parent_id"])
        if parent is None:
            continue
        assert parent["ts"] <= e["ts"] + 1e-3
        assert e["ts"] + e["dur"] <= parent["ts"] + parent["dur"] + 1e-3


def test_record_has_the_jax_tools_span_tree(recorded, tmp_path):
    out = tmp_path / "jax.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "tools/trace_cli.py", "record", "--traces", "2",
         "-o", str(out)], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert _tree(json.loads(out.read_text())) == _tree(recorded)


def test_record_cli_writes_the_file(tmp_path, capsys):
    out = tmp_path / "t.json"
    assert trace_cli.main(["record", "--device", "cpu", "-o",
                           str(out)]) == 0
    assert MATCH_SPANS <= {e["name"] for e in
                           json.loads(out.read_text())["traceEvents"]}
    assert "1 request(s)" in capsys.readouterr().out


def test_record_without_a_card_raises_here():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: record runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        trace_cli.record(1, "cuda")
