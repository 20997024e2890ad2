"""The device's idle time charged to the program's spans (`spans.py`) and the
four readers over it, on recorded intervals."""

import pytest

from h100bench import harness, spans

BENCH = harness.benchmark()
RENDER = harness.Cell("cornell.render", BENCH)
TRAIN = harness.Cell("cornell.train", BENCH)
READERS = {"idle_ms.render_enqueue": (RENDER, "images"),
           "idle_ms.render_finish": (RENDER, "images"),
           "idle_ms.step_enqueue": (TRAIN, "steps"),
           "idle_ms.step_finish": (TRAIN, "steps")}

# (start µs, end µs, name): device records with idle gaps [100, 200),
# [300, 500) and [600, 1000).
RECORDS = [(0.0, 100.0, "izpi::megakernel_rgb(izpi::Scene)"),
           (200.0, 300.0, "Memcpy HtoD (Pageable -> Device)"),
           (250.0, 280.0, "void at::native::fill_kernel(float)"),
           (500.0, 600.0, "izpi::megakernel_rgb(izpi::Scene)"),
           (1000.0, 1100.0, "Memcpy DtoH (Device -> Pageable)")]
# The host: the benchmark loop's annotation, the program's spans, an operator.
HOST = [(-50.0, 1200.0, "h100bench: render()"),
        (-40.0, 1150.0, "izpi: render"),
        (120.0, 160.0, "izpi: render.prepare"),
        (140.0, 150.0, "aten::to"),
        (320.0, 700.0, "izpi: megakernel.launch"),
        (800.0, 900.0, "izpi: render.readback"),
        (1100.0, 1120.0, "izpi: render.accumulate")]


def trace(records=RECORDS, host=HOST, counters=None):
    return harness.Trace(records, 2e-3, counters or {"images": 2,
                                                     "steps": 4},
                         {}, host)


def test_idle_goes_to_the_innermost_open_span():
    """[100, 200): `render` 100 − `render.prepare`'s 40 (self time); [300,
    500): `render` 20, `megakernel.launch` 180; [600, 1000):
    `megakernel.launch` 100, `render` 100, `render.readback` 100,
    `render` 100. The operator `aten::to` is no program span."""
    got = spans.idle_by_span(trace())
    want = {"render": 60e-6 + 20e-6 + 200e-6, "render.prepare": 40e-6,
            "megakernel.launch": 280e-6, "render.readback": 100e-6}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k


def test_idle_with_no_span_open_goes_outside():
    host = [(150.0, 180.0, "izpi: step"),
            (550.0, 900.0, "izpi: graph.replay")]
    got = spans.idle_by_span(trace(host=host))
    assert got[spans.OUTSIDE] == pytest.approx((50 + 20 + 200 + 100) * 1e-6)
    assert got["step"] == pytest.approx(30e-6)
    assert got["graph.replay"] == pytest.approx(300e-6)


@pytest.mark.parametrize("host", [HOST, HOST[:1], [(20.0, 40.0, "izpi: x")],
                                  [(100.0, 1000.0, "izpi: a"),
                                   (100.0, 1000.0, "izpi: b")]])
def test_parts_sum_to_the_idle_between_first_and_last_record(host):
    """The slice's idle time (its gaps, not the time before the first
    record or after the last) is split whole, whatever spans are open."""
    got = spans.idle_by_span(trace(host=host))
    if not spans.program_spans(host):
        assert got is None
        return
    assert sum(got.values()) == pytest.approx(700e-6)
    idle = (1100.0 - 0.0) / 1e6 - harness.union_seconds(RECORDS)
    assert sum(got.values()) == pytest.approx(idle)


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_read_nothing_without_program_spans(name):
    cell, _ = READERS[name]
    assert cell.metric_reader(name).read(trace(host=HOST[:1])) is None
    assert cell.metric_reader(name).read(trace(host=())) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_divide_by_images_or_steps(name):
    """Each reader's spans' idle over its count, in ms; with the count
    missing, nothing."""
    cell, per = READERS[name]
    reader = cell.metric_reader(name)
    split = spans.idle_by_span(trace())
    want = 1e3 * sum(split.get(k, 0.0) for k in reader.SPANS)
    for count in (1, 4):
        tr = trace(counters={per: count})
        assert reader.read(tr) == pytest.approx(want / count)
    assert reader.read(trace(counters={"other": 1})) is None


def test_readers_split_a_traced_render_and_step():
    """The render's readers take `render`, `render.prepare` and
    `megakernel.launch`, then `render.readback` and `render.accumulate`;
    the step's take the step and the graph's spans before the replay's
    end, then the clones and the read of the rays."""
    tr = trace()
    read = RENDER.metric_reader
    assert read("idle_ms.render_enqueue").read(tr) == pytest.approx(
        1e3 * (280e-6 + 40e-6 + 280e-6) / 2)
    assert read("idle_ms.render_finish").read(tr) == pytest.approx(
        1e3 * 100e-6 / 2)
    host = [(-10.0, 1100.0, "izpi: step"),
            (110.0, 130.0, "izpi: graph.copy_in"),
            (130.0, 190.0, "izpi: graph.replay"),
            (310.0, 400.0, "izpi: graph.clone_out"),
            (400.0, 1000.0, "izpi: step.rays_read")]
    tr = trace(host=host, counters={"steps": 1})
    read = TRAIN.metric_reader
    assert read("idle_ms.step_enqueue").read(tr) == pytest.approx(
        1e3 * (30e-6 + 20e-6 + 60e-6))
    assert read("idle_ms.step_finish").read(tr) == pytest.approx(
        1e3 * (90e-6 + 100e-6 + 400e-6))


def _shift(records, host):
    """µs `on_host_clock` adds to the first record."""
    return (spans.on_host_clock(trace(records=records, host=host))[0][0]
            - records[0][0])


def test_on_host_clock_puts_host_copies_inside_their_operations():
    """Copies to and from host memory shifted 170 µs early against the
    host operations that wait for them: the shift puts each back inside
    its operation (within the room the windows leave), and the idle split
    is the unshifted trace's. Without such copies, no shift."""
    recs = [(0.0, 100.0, "izpi::megakernel_rgb(izpi::Scene)"),
            (130.0, 132.0, "Memcpy HtoD (Pageable -> Device)"),
            (200.0, 300.0, "izpi::megakernel_rgb(izpi::Scene)"),
            (330.0, 333.0, "Memcpy DtoH (Device -> Pageable)"),
            (360.0, 362.0, "Memcpy DtoH (Device -> Pinned)"),
            (380.0, 381.0, "Memcpy DtoD (Device -> Device)")]
    host = [(120.0, 140.0, "aten::_to_copy"),
            (325.0, 340.0, "aten::_to_copy"),
            (355.0, 366.0, "aten::_local_scalar_dense"),
            (370.0, 375.0, "aten::copy_"),
            (-10.0, 500.0, "izpi: render"),
            (100.0, 200.0, "izpi: render.prepare")]
    early = [(s - 170.0, e - 170.0, n) for s, e, n in recs]
    assert 165.0 <= _shift(early, host) <= 176.0
    assert _shift(recs, host) == pytest.approx(0.0, abs=6.0)
    assert _shift(recs[:1] + recs[2:3], host) == 0.0
    got = spans.idle_by_span(trace(records=early, host=host))
    want = spans.idle_by_span(trace(records=recs, host=host))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=12e-6), k


@pytest.mark.parametrize("base, rate", [(170.0, 0.0), (170.0, 3e-4),
                                        (170.0, -3e-4), (4573.0, -4.2e-3)])
def test_on_host_clock_follows_an_offset_that_drifts(base, rate):
    """Four images' copies `base` µs (+ rate × time) early against their
    operations, each ending 10 µs before its operation, and one read-back
    whose host copies on for 200 µs: every record comes back to within a
    few µs of where it was, and the idle split with it. The last case is
    the largest offset and drift seen on an H100 (4.6 ms, to 1.2 ms over
    0.8 s), where a constant shift fits no two images."""
    recs, host = [], [(-100.0, 400_000.0, "izpi: render")]
    for k in range(4):
        t = k * 100_000.0
        recs += [(t, t + 2.0, "Memcpy HtoD (Pageable -> Device)"),
                 (t + 500.0, t + 96_500.0, "izpi::megakernel_rgb(Scene)"),
                 (t + 96_600.0, t + 96_650.0,
                  "Memcpy DtoH (Device -> Pageable)"),
                 (t + 96_900.0, t + 96_902.0,
                  "Memcpy DtoH (Device -> Pinned)")]
        host += [(t - 40.0, t + 12.0, "aten::_to_copy"),
                 (t + 300.0, t + 96_850.0, "aten::_to_copy"),
                 (t + 96_880.0, t + 96_912.0, "aten::_local_scalar_dense"),
                 (t + 300.0, t + 96_860.0, "izpi: render.readback"),
                 (t + 96_950.0, t + 98_000.0, "izpi: render.accumulate")]
    early = [(s - base - rate * s, e - base - rate * e, n)
             for s, e, n in recs]
    back = spans.on_host_clock(trace(records=early, host=host))
    for (s, e, _), (s2, e2, _) in zip(recs, back):
        assert abs(s2 - s) <= 12.0 and abs(e2 - e) <= 12.0
    got = spans.idle_by_span(trace(records=early, host=host))
    want = spans.idle_by_span(trace(records=recs, host=host))
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=100e-6), k


def test_on_host_clock_takes_the_chain_most_copies_agree_on():
    """An operation that would take one copy at another offset loses to
    the offset that puts every copy inside its own."""
    recs = [(t, t + 2.0, "Memcpy DtoH (Device -> Pinned)")
            for t in (100.0, 1100.0, 2100.0)]
    host = [(t + 300.0, t + 310.0, "aten::_local_scalar_dense")
            for t in (100.0, 1100.0, 2100.0)]
    host.append((95.0, 110.0, "aten::_local_scalar_dense"))
    assert 300.0 <= _shift(recs, host) <= 308.0


def test_on_host_clock_keeps_one_period_of_a_repeating_slice():
    """Steps 3.5 ms apart, each with one read of the rays, the device 2 ms
    early: the chain keeps the offset the reads agree on, not one a period
    off, and every record comes back."""
    recs = [(t, t + 2.0, "Memcpy DtoH (Device -> Pinned)")
            for t in (k * 3500.0 for k in range(6))]
    host = [(s + 2000.0 - 5.0, e + 2000.0 + 10.0,
             "aten::_local_scalar_dense") for s, e, _ in recs]
    back = spans.on_host_clock(trace(records=recs, host=host))
    for (s, e, _), (s2, e2, _) in zip(recs, back):
        assert s2 - s == pytest.approx(2010.0, abs=1e-6)
