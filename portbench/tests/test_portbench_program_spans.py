"""The readers of the program's match-stage, lane and upload timers and
counters, and the program's spans in the device trace: the card's idle
time labelled by them (``lib/progtrace.py``), and ``devtrace.summarise``
unmoved by them."""
from types import SimpleNamespace

import pytest

from portbench.lib import bench, devtrace, progtrace

PROBES = 2000.0
TIMERS = {"pipeline.match.parse": 0.5, "pipeline.match.report": 0.25,
          "pipeline.match.write": 0.125, "matcher.join": 0.0625,
          "matcher.lane.dispatch_queued": 0.03, "matcher.lane.drain_queued":
          0.01, "matcher.upload": 0.02}
COUNTERS = {"decode.upload.bytes": 600_000, "decode.cells.kept": 3_000,
            "decode.cells.launched": 4_096}
#: each new reader and what it reads from TIMERS and COUNTERS
READERS = {
    "parse_us_per_probe.replay": 0.5e6 / PROBES,
    "report_rows_us_per_probe.replay": 0.25e6 / PROBES,
    "rows_write_us_per_probe.replay": 0.125e6 / PROBES,
    "match_join_us_per_probe.replay": 0.0625e6 / PROBES,
    "lane_queue_us_per_probe.replay": 0.04e6 / PROBES,
    "upload_us_per_probe.replay": 0.02e6 / PROBES,
    "upload_bytes_per_probe.replay": 600_000 / PROBES,
    "decode_cell_fill.replay": 100.0 * 3_000 / 4_096,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_empty_and_synthetic_windows(name):
    read = bench.load_module("metrics", name).read
    assert read(bench.Obs(window_s=10.0, work=0.0)) is None
    assert read(bench.Obs(window_s=10.0, work=PROBES)) is None
    obs = bench.Obs(window_s=10.0, work=PROBES, counters=dict(COUNTERS),
                    timers={k: {"count": 3, "total_s": v}
                            for k, v in TIMERS.items()})
    assert read(obs) == pytest.approx(READERS[name])


def test_the_new_readers_are_the_cells_metrics():
    b = bench.benchmark()
    cells = {m["name"]: m for m in bench.cell_metrics(
        b, "replay-metro341.sparse", "per_layer")}
    for name in READERS:
        assert cells[name]["moves"] == "card_busy_ns_per_probe"
        assert cells[name]["source"] == ("program_counter" if name.startswith(
            ("upload_bytes", "decode_cell")) else "program_span")


# ---- the program's spans in the device trace ------------------------------
def ev(name, start, end, thread=1, cuda=False, annotation=False):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, thread=thread,
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end),
        is_user_annotation=annotation)


def prog(name, start, end, thread=1):
    return ev(progtrace.PROGRAM_PREFIX + name, start, end, thread)


def profile_of(events):
    return SimpleNamespace(events=lambda: list(events))


def harness_profile():
    """A window on thread 1 with the harness's spans and three kernels."""
    return [ev(devtrace.WINDOW, 0, 100),
            ev("portbench.match_traces", 0, 100),
            ev("portbench.match_many", 5, 60),
            ev("viterbi_kernel<__half, 8>", 10, 12, cuda=True),
            ev("Memcpy HtoD (Pageable -> Device)", 50, 52, cuda=True),
            ev("viterbi_kernel<__half, 8>", 90, 92, cuda=True)]


def program_spans():
    """The program's ranges: on the window's thread, and on a lane thread
    (2) covering it all; with their device-side annotation copies."""
    spans = [prog("pipeline.match.report", 0, 60),
             prog("matcher.prep", 5, 40),
             prog("matcher.decode_dispatch", 0, 100, thread=2)]
    copies = [ev(s.name, s.time_range.start, s.time_range.end, cuda=True,
                 annotation=True) for s in spans]
    return spans + copies


def same_summary(a, b):
    assert (a.busy_s, a.window_s, a.kernels, a.idle) == \
        (b.busy_s, b.window_s, b.kernels, b.idle)
    assert bench.breakdown(a) == bench.breakdown(b)


def test_summarise_is_unmoved_by_program_spans():
    base = harness_profile()
    same_summary(devtrace.summarise(profile_of(base)),
                 devtrace.summarise(profile_of(base + program_spans())))


def test_summarise_of_a_recorded_profile_is_unmoved_by_program_spans(
        monkeypatch):
    """A CPU profile recorded with the mirror armed, reduced with and
    without the program's ranges."""
    from reporter_tpu_torch.obs import trace as obs_trace
    from reporter_tpu_torch.utils.metrics import Registry
    reg = Registry()
    recorded = []
    summarise = devtrace.summarise

    def keep(prof):
        recorded.extend(prof.events())
        return summarise(prof)

    monkeypatch.setattr(devtrace, "summarise", keep)
    obs_trace.configure(True, profiler=True)
    try:
        with devtrace.traced(True, cuda=False):
            with devtrace.span("window"):
                with devtrace.span("match_traces"):
                    with reg.timer("pipeline.match.parse"):
                        with reg.timer("matcher.prep"):
                            pass
    finally:
        obs_trace.configure(False)
    mirrored = [e for e in recorded
                if e.name.startswith(progtrace.PROGRAM_PREFIX)]
    assert sorted(e.name[len(progtrace.PROGRAM_PREFIX):]
                  for e in mirrored) == ["matcher.prep",
                                         "pipeline.match.parse"]
    without = [e for e in recorded if e not in mirrored]
    same_summary(summarise(profile_of(recorded)),
                 summarise(profile_of(without)))


def test_idle_is_labelled_by_the_window_threads_innermost_program_span():
    events = harness_profile() + program_spans()
    idle, recorded = progtrace.idle_by_program(events)
    # gaps [0,10] and [12,50] have their midpoints in matcher.prep (5-40);
    # [52,90] (midpoint 71) and [92,100] lie past the window thread's
    # spans, whatever the lane thread held
    assert idle == pytest.approx({"matcher.prep": 48e-6,
                                  progtrace.UNCOVERED: 46e-6})
    assert recorded == 2
    # the same gaps as the harness's labels
    summary = devtrace.summarise(profile_of(events))
    assert sum(idle.values()) == pytest.approx(sum(summary.idle.values()))
    assert summary.idle == pytest.approx({"match_many": 48e-6,
                                          "match_traces": 46e-6})


def test_no_window_no_labels():
    assert progtrace.idle_by_program(harness_profile()[1:]) == ({}, 0)
