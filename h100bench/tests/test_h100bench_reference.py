"""The plain reference against the port on the CPU, where the port runs
its plain versions: a few pixels of the scene's render, and a small
training step's loss and gradients from the traffic's start."""

import numpy as np
import pytest
import torch

from h100bench import harness
from h100bench.reference import tracer

SCENES = [("cornell:cornell_box", "cornell_box")]
START = harness.Cell("cornell.train", harness.benchmark()).traffic["perturb"]


@pytest.mark.parametrize("spec,name", SCENES)
def test_pixels_and_rays_match_the_port(spec, name):
    from izpi_tpu_torch.integrator.path import RenderSettings
    from izpi_tpu_torch.render import renderer
    from izpi_tpu_torch.scene.library import get_scene

    nx, spp, seed = 12, 2, 2**40 + 321
    ctx = renderer.RenderContext(get_scene(name), device="cpu")
    res = renderer.render(None, nx, nx, spp, RenderSettings(max_depth=50),
                          seed=seed, context=ctx, device="cpu")
    every = list(range(nx * nx))
    ref, rays = tracer.render_pixels(spec, nx, nx, spp, 50, seed, every,
                                     "cpu")
    got = tracer.fetch(res.image, every, nx, nx)
    assert rays == res.rays_traced
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("spec,name", SCENES)
def test_training_step_matches_the_port(spec, name):
    from izpi_tpu_torch.core import loops, rng
    from izpi_tpu_torch.integrator.path import RenderSettings
    from izpi_tpu_torch.parallel import dist
    from izpi_tpu_torch.render import renderer
    from izpi_tpu_torch.scene.library import get_scene

    nx, spp, depth, seed = 8, 2, 8, 2**33 + 5
    ctx = renderer.RenderContext(get_scene(name), device="cpu")
    step = dist.build_train_step(ctx.cs, ctx.meta,
                                 RenderSettings(max_depth=depth),
                                 ctx.intersect, nx, nx, spp=spp,
                                 runner=loops.Eager())
    params = dist.extract_params(ctx.cs)
    rows = tracer.perturb(params, START)
    pid = torch.arange(nx * nx)
    target = torch.rand((nx * nx, 3), generator=torch.Generator(
        ).manual_seed(1)) * 0.5
    loss, grads = step(params, pid % nx, pid // nx, target,
                       rng.render_key(seed))
    cs, meta = tracer.compiled(spec, "cpu")
    ref_params = {k: v.clone() for k, v in tracer.scene_params(cs).items()}
    assert torch.equal(tracer.perturb(ref_params, START), rows)
    from h100bench.reference.plain.integrator import path as rpath

    ref_loss, ref_grads = tracer.loss_and_grads(
        cs, meta, tracer.BruteHit(cs), rpath.RenderSettings(max_depth=depth),
        nx, nx, spp, ref_params, target, tracer.render_key(seed, "cpu"))
    assert float(loss) == pytest.approx(ref_loss, rel=1e-6)
    for k in tracer.PARAMS:
        torch.testing.assert_close(grads[k], ref_grads[k], rtol=1e-5,
                                   atol=1e-8)
    assert float(torch.linalg.vector_norm(ref_grads["tex_c0"])) > 0


def test_perturbed_row_and_its_clamp():
    cs, _ = tracer.compiled("cornell:cornell_box", "cpu")
    params = {k: v.clone() for k, v in tracer.scene_params(cs).items()}
    rows = tracer.perturb(params, START)
    assert rows.tolist() == [1]  # the red wall's albedo
    assert params["tex_c0"][1].tolist() == pytest.approx(START["to"])
    params["tex_c0"][1] = torch.tensor([-0.5, 0.5, 1.5])
    tracer.clamp_rows(params, START, rows)
    assert params["tex_c0"][1].tolist() == [0.0, 0.5, 1.0]
    assert params["tex_c0"][2].tolist() == [15.0, 15.0, 15.0]  # the light
    with pytest.raises(ValueError):
        tracer.perturb(params, dict(START, **{"from": [9.0, 9.0, 9.0]}))
