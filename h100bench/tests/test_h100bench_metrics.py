"""The metric arithmetic on recorded device intervals, and the roofline
count on a tiny scene."""

import math

import pytest

from h100bench import harness, work
from h100bench.reference import tracer

BENCH = harness.benchmark()
CELL = harness.Cell("cornell.render", BENCH)
TRAIN = harness.Cell("cornell.train", BENCH)

# (start µs, end µs, name): two overlapping kernels, a copy inside the
# first, a gap, and a kernel of another name.
RECORDS = [
    (0.0, 400.0, "izpi::megakernel_rgb(izpi::Scene, izpi::Camera, int)"),
    (100.0, 150.0, "Memcpy DtoH (Device -> Pageable)"),
    (300.0, 600.0, "izpi::megakernel_rgb(izpi::Scene, izpi::Camera, int)"),
    (800.0, 900.0, "void at::native::reduce_kernel<512, 1>(float)"),
]


def trace(records=RECORDS, window_s=1e-3, counters=None, facts=None):
    return harness.Trace(records, window_s, counters or {"images": 2},
                         facts or {})


def test_union_counts_overlaps_once():
    assert harness.union_seconds(RECORDS) == pytest.approx(700e-6)
    assert harness.union_seconds([]) == 0.0
    assert harness.union_seconds([(0, 10, "a"), (10, 20, "b")]) == \
        pytest.approx(20e-6)


def test_idle_share_records_and_kernel_times():
    tr = trace()
    assert CELL.metric_reader("device_idle_pct.render").read(tr) == \
        pytest.approx(30.0)
    assert CELL.metric_reader("device_records_per_image").read(tr) == 2.0
    assert CELL.metric_reader("kernel_ms.b1").read(tr) == pytest.approx(0.35)
    assert CELL.metric_reader("device_idle_pct.render").read(
        trace(records=[])) is None


def test_step_metrics_read_replays_and_both_reverse_passes():
    recs = [(0, 100, "izpi::diff::diff_trace_fwd(izpi::Scene)"),
            (100, 110, "izpi::diff::diff_trace_bwd_stat(Tex)"),
            (110, 114, "izpi::diff::diff_trace_bwd_lane(RevArgs)"),
            (200, 300, "izpi::diff::diff_trace_fwd(izpi::Scene)"),
            (300, 310, "izpi::diff::diff_trace_bwd_stat(Tex)"),
            (310, 316, "izpi::diff::diff_trace_bwd_global(RevArgs)")]
    tr = trace(recs, counters={"replays": 2, "steps": 2})
    read = TRAIN.metric_reader
    assert read("device_records_per_step").read(tr) == 3.0
    assert read("kernel_ms.fwd").read(tr) == pytest.approx(0.1)
    assert read("kernel_ms.reverse").read(tr) == pytest.approx(0.015)


def test_percentile_and_breakdown():
    xs = list(range(1, 101))
    assert harness.percentile(xs, 95) == pytest.approx(95.05)
    assert harness.percentile([3.0], 95) == 3.0
    host = [(0.0, 1000.0, "render"), (550.0, 850.0, "aten::item")]
    b = harness.breakdown(RECORDS, host)
    assert b["device_ops"][0][1] == pytest.approx(700e-6)
    assert b["idle_gaps"] == [["host: aten::item", pytest.approx(200e-6)]]
    assert harness.kernel_name(RECORDS[0][2]) == "megakernel_rgb"


def test_roofline_count_on_the_cornell_scene():
    """counts/b1.py by hand: the reference's Cornell compile holds 12
    rects and a sphere; 1,000 paths tracing 5,000 rays."""
    cs, meta = tracer.compiled("cornell:cornell_box", "cpu")
    kinds = {"rect": 12, "sphere": 1, "triangle": 0}
    assert meta.n_prims == 13
    counters = {"rays": 5000, "paths": 1000, "images": 1, "nx": 10,
                "ny": 10, "prims": 13, "prim_kinds": kinds}
    facts = {"sm_count": 132, "sm_clock_mhz": 1980.0}
    peaks = harness.peaks()
    flops = 5000 * (12 * 35 + 26)
    int_ops = (3 * 4000 + 7 * 1000) * 79
    nbytes = 13 * work.PRIM_BYTES + 10 * 10 * 12
    want = max(flops / 67e12, int_ops / (132 * 1980e6 * 64),
               nbytes / 3.35e12)
    secs, which = harness.count_module("b1").bound(counters, facts, peaks)
    assert secs == pytest.approx(want) and which == "int32"
    recs = [(0.0, 1e6 * want * 4, "izpi::megakernel_rgb(Scene)")]
    tr = trace(recs, counters=counters, facts=facts)
    assert CELL.metric_reader("b1_roofline").read(tr) == pytest.approx(25.0)
    # Without the SM clock there is no integer rate, and no share.
    assert CELL.metric_reader("b1_roofline").read(
        trace(recs, counters=counters, facts={"sm_count": 132})) is None


def test_threefry_operation_count():
    assert work.THREEFRY_OPS == 79
    assert math.isclose(work.cipher_ops(10, 4, new_samples=False),
                        3 * 6 * 79)
