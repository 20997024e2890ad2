"""The port's spans (`izpi_tpu_torch.profiling.span`) on the CPU: under a
recording torch.profiler a render on the megakernel route and an eager
training step mark their layers as nested "izpi: " ranges; with no profiler
recording a span is one shared no-op that enters no `record_function`, and
the render's image and rays are bit for bit those rendered under the
profiler."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from izpi_tpu_torch import profiling
from izpi_tpu_torch.core import loops, rng
from izpi_tpu_torch.integrator.path import RenderSettings
from izpi_tpu_torch.parallel import dist
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene.library.cornell import cornell_box

N, SPP, DEPTH = 8, 2, 2


@pytest.fixture(scope="module")
def context():
    return renderer.RenderContext(cornell_box(), device="cpu")


def _render(context, **kw):
    return renderer.render(None, N, N, SPP, RenderSettings(max_depth=DEPTH),
                           seed=3, mode="mega", context=context,
                           device="cpu", **kw)


def _spans(prof):
    """[(start µs, end µs, name without the prefix)] of the program's spans
    in the profile, by start."""
    return sorted((e.time_range.start, e.time_range.end,
                   e.name[len(profiling.PREFIX):]) for e in prof.events()
                  if e.name.startswith(profiling.PREFIX))


def _inside(child, parent):
    return parent[0] <= child[0] and child[1] <= parent[1]


@pytest.mark.parametrize("chunks", [1, 2])
def test_mega_render_spans_nest_in_one_render(context, tmp_path, chunks):
    """One `render` holds one `render.prepare` before the first chunk, then
    a chunk's `megakernel.launch`, `render.readback` and
    `render.accumulate` in that order, and one more `render.accumulate`
    (the canvas); two chunks through a checkpoint a sample."""
    kw = ({} if chunks == 1 else
          dict(checkpoint_path=str(tmp_path / "ck.npz"),
               checkpoint_interval=1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render(context, **kw)
    spans = _spans(prof)
    names = [name for _, _, name in spans]
    assert names == (["render", "render.prepare"]
                     + ["megakernel.launch", "render.readback",
                        "render.accumulate"] * chunks
                     + ["render.accumulate"])
    root = spans[0]
    assert all(_inside(sp, root) for sp in spans[1:])
    assert all(a[1] <= b[0] for a, b in zip(spans[1:], spans[2:])), \
        "the spans under `render` overlap"


def test_eager_step_holds_one_rays_read(context):
    """An eager step is one `step` with one `step.rays_read` inside, and no
    graph's spans."""
    step = dist.build_train_step(context.cs, context.meta,
                                 RenderSettings(max_depth=DEPTH),
                                 context.intersect, N, N)
    assert isinstance(step.runner, loops.Eager)
    params = dist.extract_params(context.cs)
    xs, ys = torch.arange(N).repeat(N), torch.arange(N).repeat_interleave(N)
    target = torch.full((N * N, 3), 0.25)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, xs, ys, target, rng.render_key(0, device="cpu"))
    spans = _spans(prof)
    assert [name for _, _, name in spans] == ["step", "step.rays_read"]
    assert _inside(spans[1], spans[0])
    assert step.rays > 0


def test_spans_off_are_one_no_op_and_change_no_bit(context, monkeypatch):
    """With no profiler recording, `span` hands out one shared object and
    the render enters no `record_function`; its image and rays equal those
    rendered under the profiler bit for bit."""
    assert profiling.span("a") is profiling.span("b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("a") is not profiling.span("b")
        traced = _render(context)
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: entered.append(a))
    plain = _render(context)
    assert entered == []
    assert plain.rays_traced == traced.rays_traced
    assert plain.image.dtype == traced.image.dtype
    assert plain.image.tobytes() == traced.image.tobytes()
