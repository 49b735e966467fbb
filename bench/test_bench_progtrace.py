"""The program's spans on a device trace (``bench/progtrace.py``), on a
synthetic Chrome trace: the opening synchronise and the marker launch,
launches through the runtime and the driver, nested program spans inside
a harness span, the window's closing synchronise and a later one of the
profiler's own."""
from __future__ import annotations

import pytest

from bench import progtrace

T0 = 1000.0                       # the marker's launch on the trace's clock
OPEN_US = -4.0                    # the opening synchronise, from T0


def launch(corr, at_us, cat="cuda_runtime", name="cudaLaunchKernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": T0 + at_us,
            "dur": 3.0, "args": {"correlation": corr}}


def kernel(corr, name, start_us, dur_us):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": T0 + start_us,
            "dur": dur_us, "args": {"correlation": corr}}


# host seconds from the window's start: (name, start, end)
HARNESS = [("batch", 0.00002, 0.00008), ("step", 0.0001, 0.0101)]
# (name, track, start, duration)
PROGRAM = [("train.step", "train", 0.0002, 0.0097),
           ("cada.lhs", "cada", 0.001, 0.001),
           ("train.grads", "train", 0.004, 0.003)]
# (correlation, kernel, launched at, runs from, for) in µs from the marker
OPS = [(1, "fill_marker", 0.0, 5.0, 2.0),
       (2, "copy_batch", 50.0, 60.0, 10.0),
       (3, "row_sq_kernel", 1500.0, 2600.0, 100.0),
       (4, "gemm_a", 5000.0, 5100.0, 300.0),
       (5, "loss_mean", 300.0, 7500.0, 20.0),
       (6, "after_the_step", 10000.0, 10005.0, 40.0)]
SYNC_US, SYNC_S = 12007.0, 0.012  # skew 11 µs (7 from the marker)


def events(close_us=SYNC_US):
    out = []
    for corr, name, at, start, dur in OPS:
        cat = "cuda_driver" if name == "gemm_a" else "cuda_runtime"
        out += [launch(corr, at, cat), kernel(corr, name, start, dur)]
    out.append(launch(98, OPEN_US, name="cudaDeviceSynchronize"))
    out.append(dict(launch(97, 5500.0, name="cudaStreamSynchronize"),
                    dur=300.0))
    out.append(launch(99, close_us, name="cudaDeviceSynchronize"))
    out.append(launch(100, SYNC_US + 900, name="cudaDeviceSynchronize"))
    out.append({"ph": "i", "cat": "kernel", "name": "instant", "ts": T0})
    return out


@pytest.fixture
def trace():
    return progtrace.parse(events(), HARNESS, PROGRAM, 0.0125, 0.0, SYNC_S)


def test_the_innermost_span_at_the_launch_owns_an_operation(trace):
    owners = dict(zip((o[0] for o in trace.ops), trace.owners))
    assert owners == {"fill_marker": "window", "copy_batch": "batch",
                      "row_sq_kernel": "cada.lhs", "gemm_a": "train.grads",
                      "loss_mean": "train.step", "after_the_step": "step"}
    assert trace.kernel_owners("row_sq_kernel") == {"cada.lhs": 1}


def test_operations_launched_outside_the_program_fall_to_the_harness(trace):
    assert trace.launched_in("step") == pytest.approx(40e-6)
    assert trace.launched_in("batch") == pytest.approx(10e-6)


def test_attributed_and_unattributed_time_make_the_total(trace):
    total = sum(d for _, _, d in trace.ops) / 1e6
    assert sum(trace.by_owner().values()) == pytest.approx(total)
    ours = trace.launched_in("train.*", "cada.*")
    rest = trace.launched_in("window", "batch", "step")
    assert ours == pytest.approx((100 + 300 + 20) / 1e6)
    assert ours + rest == pytest.approx(total)
    assert trace.launched_in("cada.*") == pytest.approx(100e-6)


def test_gaps_are_named_by_either_kind_of_span(trace):
    assert trace.span_at(T0 + 1500.0) == "cada.lhs"
    assert trace.span_at(T0 + 9950.0) == "step"
    assert trace.span_at(T0 + 12200.0) == "window"
    names = [name for name, _ in trace.idle_gaps(n=20)]
    assert "train.grads" in names and "step" in names


def test_the_idle_time_split_between_child_and_bare_spans(trace):
    covered, total = trace.idle_split(("step",), ("train.step",))
    # the harness's step runs 100-10,100 µs; busy 2,600-2,700,
    # 5,100-5,400, 7,500-7,520, 10,005-10,045
    assert total == pytest.approx((10100 - 100 - 100 - 300 - 20 - 40) / 1e6)
    # children: cada.lhs 1,000-2,000 (idle throughout) and train.grads
    # 4,000-7,000 (busy 5,100-5,400)
    assert covered == pytest.approx((1000 + 3000 - 300) / 1e6)


def test_the_opening_synchronise_anchors_the_spans(trace):
    assert trace.start_us == pytest.approx(T0 + OPEN_US)
    assert trace.program[1][:3] == pytest.approx(("cada.lhs",
                                                  T0 + OPEN_US + 1000, 1000))
    assert trace.spans[1][1] == pytest.approx(T0 + OPEN_US + 100)


def test_the_clock_skew_is_read_from_the_closing_synchronise(trace):
    assert trace.notes["clock_skew_us"] == pytest.approx(11.0)
    marker = progtrace.parse(events(), HARNESS, PROGRAM, 0.0125, None,
                             SYNC_S)
    assert marker.start_us == T0
    assert marker.notes["clock_skew_us"] == pytest.approx(7.0)
    plain = progtrace.parse(events(), HARNESS, PROGRAM, 0.0125)
    assert "clock_skew_us" not in plain.notes


def test_a_closing_call_that_puts_the_clock_earlier_anchors_it():
    """The closing synchronise 6 µs before the opening one's mapping of
    its reading: a call never comes before its reading, so the spans move
    6 µs earlier."""
    early = progtrace.parse(events(SYNC_US - 17.0), HARNESS, PROGRAM,
                            0.0125, 0.0, SYNC_S)
    assert early.notes["clock_skew_us"] == pytest.approx(-6.0)
    assert early.start_us == pytest.approx(T0 + OPEN_US - 6.0)
    assert early.program[0][1] == pytest.approx(T0 + OPEN_US - 6.0 + 200)


def test_the_host_waits_by_span(trace):
    """Calls of ``WAIT_US`` or more: the 300 µs synchronise in
    train.grads, not the 3 µs launches and synchronises."""
    assert trace.waits_by_span() == {
        "train.grads": {"cudaStreamSynchronize": [1, pytest.approx(3e-4)]}}


def test_the_idle_time_by_span(trace):
    """Idle stretches cut at every span's edge (µs from T0: the window
    from -4, the batch 16-76, the step 96-10,096, train.step 196-9,896,
    cada.lhs 996-1,996, train.grads 3,996-6,996)."""
    want = {"window": 9 + 9 + 20 + 2400, "batch": 44 + 6,
            "step": 100 + 109 + 51, "train.step": 800 + 604 + 1296 + 504
            + 2376, "cada.lhs": 1000, "train.grads": 1104 + 1596}
    got = trace.idle_by_span()
    assert got == pytest.approx({k: v / 1e6 for k, v in want.items()})
    assert sum(got.values()) == pytest.approx(
        trace.window_s - trace.busy_s)


# the marks of PROGRAM's spans, 54 µs after where the host's clock puts
# their edges, in the host's order: train.step opens, cada.lhs opens and
# closes, train.grads opens and closes, train.step closes
MARKS_US = [250.0, 1050.0, 2050.0, 4050.0, 7050.0, 9950.0]
# the spans as the tracer records them (as they close) and their marks
BY_CLOSE = [PROGRAM[1], PROGRAM[2], PROGRAM[0]]
EDGES = [(1, 2), (3, 4), (0, 5)]


def marked_events(marks=MARKS_US):
    out = events() + [launch(200 + i, at, name=progtrace.MARK)
                      for i, at in enumerate(marks)]
    # launched at 1,040: inside cada.lhs by the clock, before its mark
    out += [launch(300, 1040.0), kernel(300, "early", 8000.0, 5.0)]
    return out


def test_marks_place_the_program_spans():
    tr = progtrace.parse(marked_events(), HARNESS, BY_CLOSE, 0.0125, 0.0,
                         SYNC_S, EDGES)
    assert tr.notes["placed_by"] == "marks"
    assert tr.notes["clock_wander_us"] == pytest.approx([54.0, 54.0])
    assert [sp[:3] for sp in tr.program] == [
        ("cada.lhs", T0 + 1050, 1000), ("train.grads", T0 + 4050, 3000),
        ("train.step", T0 + 250, 9700)]
    owners = dict(zip((o[0] for o in tr.ops), tr.owners))
    assert owners["early"] == "train.step"
    assert owners["row_sq_kernel"] == "cada.lhs"


def test_unpaired_marks_fall_back_to_the_clock():
    tr = progtrace.parse(marked_events(MARKS_US[:-1]), HARNESS, BY_CLOSE,
                         0.0125, 0.0, SYNC_S, EDGES)
    assert tr.notes["placed_by"] == "clock"
    assert "clock_wander_us" not in tr.notes
    owners = dict(zip((o[0] for o in tr.ops), tr.owners))
    assert owners["early"] == "cada.lhs"


def test_the_marked_tracer_marks_every_edge():
    from repro_torch.obs import Tracer, as_tracer
    calls = []
    marked = progtrace.Marked(Tracer(), lambda: calls.append(1))
    trace = as_tracer(marked)
    assert trace is marked and bool(trace)
    with trace.span("outer", "t"):
        with trace.span("inner", "t", args={"k": 1}):
            pass
        trace.counter("n", None, 3.0, track="t")
        with trace.span("second", "t"):
            pass
    assert len(calls) == marked.marks == 6
    assert [e[1] for e in marked.spans()] == ["inner", "second", "outer"]
    assert marked.edges == [(1, 2), (3, 4), (0, 5)]
    assert marked.spans()[0][6] == {"k": 1}


def test_merge_and_overlap():
    assert progtrace.merge([(5, 6), (1, 3), (2, 4), (7, 7)]) == [[1, 4],
                                                                 [5, 6]]
    assert progtrace.overlap(0, 10, [[1, 4], [5, 6], [9, 12]]) == 5
