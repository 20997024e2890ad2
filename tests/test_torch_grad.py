"""The differentiable render step: izpi_tpu_torch.parallel.dist vs the JAX
package's (izpi_tpu/parallel/dist.py:572-643), on one device.

The same 8×8 pixels, key and parameters (the JAX `extract_params` leaves,
carried over with `params_from_jax`) go through both packages' step: the
mean squared error of one differentiable sample per pixel (or of the mean
of spp samples, JAX's `fori_loop` over its sample passes as its
`parallel.dist.build_train_step` runs them) against a seeded target, and
its gradient in each of the six parameters. Tolerances:
- loss within LOSS_RTOL relative;
- each gradient entry within GRAD_ATOL + GRAD_RTOL·|reference|: the two
  packages' libm and XLA's fused multiply-adds differ in the last ulps;
- JAX runs compiled where its FMA contraction leaves the numbers within
  these (the Cornell box), eagerly where it does not matter.
The JAX gradient of `mat_fuzz` is NaN for some metals of `random_scene`
(ROADMAP C): there the port must be finite, elsewhere equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_leaves, mixed_scene
from izpi_tpu.core import rng as jrng
from izpi_tpu.integrator import path as jpath
from izpi_tpu.parallel import dist as jdist
from izpi_tpu.render import renderer as jrenderer
from izpi_tpu.scene import compiler as jcompiler
from izpi_tpu.scene.library import get_scene as j_get_scene
from izpi_tpu.scene.library.cornell import cornell_box as j_cornell
from izpi_tpu_torch import entry as tentry
from izpi_tpu_torch.core import rng as trng
from izpi_tpu_torch.integrator import path as tpath
from izpi_tpu_torch.ops import diff_trace, table_grad
from izpi_tpu_torch.parallel import dist as tdist
from izpi_tpu_torch.render import renderer as trenderer
from izpi_tpu_torch.scene import compiler as tcompiler
from izpi_tpu_torch.scene import types as tst
from izpi_tpu_torch.scene.library import get_scene as t_get_scene

N = 8            # pixels a side
DEPTH = 4
SEED = 0
LOSS_RTOL = 1e-4
GRAD_ATOL = 1e-5
GRAD_RTOL = 1e-3


def _pixels():
    ys = np.repeat(np.arange(N), N)
    xs = np.tile(np.arange(N), N)
    return xs, ys


def _target():
    return (np.random.RandomState(1).rand(N * N, 3) * 0.3).astype(np.float32)


def jax_step(scene, eager: bool, depth: int = DEPTH, spp: int = 1):
    """(cs, meta, params, loss, grads), as numpy, of the JAX package's
    differentiable step: sample 0, or the mean of samples 0..spp-1 added
    in a `fori_loop` (izpi_tpu/parallel/dist.py's `local_loss`)."""
    cs, meta = jcompiler.compile_scene(scene)
    intersect = jpath.make_brute_intersector(cs)
    settings = jpath.RenderSettings(max_depth=depth)
    xs, ys = (jnp.asarray(a, jnp.int32) for a in _pixels())
    target = jnp.asarray(_target())

    def loss_fn(params):
        cs_p = jdist.inject_params(cs, params)

        def body(s, acc):
            color, _ = jrenderer.sample_pass(
                cs_p, meta, settings, intersect, N, N, xs, ys,
                jrng.render_key(SEED), s, differentiable=True)
            return acc + color

        if spp == 1:
            color = body(0, 0.0)
        else:
            color = jax.lax.fori_loop(
                0, spp, body, jnp.zeros((N * N, 3), jnp.float32)) / spp
        return jnp.sum((color - target) ** 2) / jnp.float32(N * N * 3)

    params = jdist.extract_params(cs)
    fn = jax.value_and_grad(loss_fn)
    if eager:
        with jax.disable_jit():
            loss, grads = fn(params)
    else:
        loss, grads = jax.jit(fn)(params)
    return (cs, meta, {k: np.asarray(v) for k, v in params.items()},
            float(loss), {k: np.asarray(v) for k, v in grads.items()})


def port_step(cs, meta, params, use_bvh=None, depth=DEPTH, route=None,
              spp=1):
    """The port's step at spp samples a pixel through brute force, or
    through a traversal's intersector: "bvh4" (`ops.bvh_kernel`) or "row"
    (`ops.bvh_rowkernel`), each running its plain traversal on the CPU;
    `route` is `build_train_step`'s (by default the fused route where the
    scene takes it, `ops.diff_trace`)."""
    intersect = tpath.make_brute_intersector(cs)
    if use_bvh == "bvh4":
        from izpi_tpu_torch.ops import bvh_kernel

        cs, intersect = bvh_kernel.attach(cs)
    elif use_bvh == "row":
        from izpi_tpu_torch.ops import bvh_rowkernel

        cs, intersect = bvh_rowkernel.attach(cs)
    step = tdist.build_train_step(cs, meta, tpath.RenderSettings(
        max_depth=depth), intersect, N, N, spp=spp, route=route)
    xs, ys = (torch.as_tensor(a) for a in _pixels())
    loss, grads = step(params, xs, ys, torch.as_tensor(_target()),
                       trng.render_key(SEED))
    return float(loss), {k: g.numpy() for k, g in grads.items()}, step.rays


def assert_grads_close(got, want, finite_only=False):
    for k in tdist.PARAMS:
        g, w = got[k], want[k]
        assert g.shape == w.shape, k
        assert np.isfinite(g).all(), k
        ok = np.isfinite(w) if finite_only else np.ones(w.shape, bool)
        np.testing.assert_allclose(g[ok], w[ok], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


@pytest.fixture(scope="module", params=["glass", "no_glass"])
def cornell(request):
    scene = j_cornell(with_glass_sphere=request.param == "glass")
    jcs, jmeta, jparams, loss, grads = jax_step(scene, eager=False)
    tcs, tmeta = tcompiler.from_jax_arrays(jax_leaves(jcs), "cpu", jmeta)
    return tcs, tmeta, jparams, loss, grads


def test_loss_and_grads_match_jax(cornell, monkeypatch):
    """Cornell 8×8, depth 4, seed 0, brute force: the loss and all six
    parameters' gradients equal JAX's; tex_c0 (the walls' and the light's
    colours) carries a gradient. The step is the one the card captures,
    run eagerly, on both routes: the checkpointed bounces, whose trace
    runs the fixed trip of max_depth bounces and whose gathers of tex_c0
    and mat_fuzz have their backward in `ops.table_grad` (its plain
    version on the CPU), and the fused route (the default here,
    `ops.diff_trace`), whose one call of the fused reverse returns tex_c0's
    gradient (a table for the one sample pass), with no call of
    `table_grad`."""
    _match_jax(*cornell, 1, monkeypatch)


@pytest.mark.parametrize("spp", [2, 4])
@pytest.mark.parametrize("glass", ["glass", "no_glass"])
def test_loss_and_grads_match_jax_at_spp(glass, spp, monkeypatch):
    """As `test_loss_and_grads_match_jax`, at spp samples a pixel: JAX's
    sample passes in its `fori_loop`, against the port's checkpointed
    route (a sample pass at a time) and its fused route (every pass in one
    launch of the forward kernel and one call of the fused reverse, which
    returns a table a pass), at the same tolerances."""
    jcs, jmeta, jparams, want_loss, want = jax_step(
        j_cornell(with_glass_sphere=glass == "glass"), eager=False, spp=spp)
    tcs, tmeta = tcompiler.from_jax_arrays(jax_leaves(jcs), "cpu", jmeta)
    _match_jax(tcs, tmeta, jparams, want_loss, want, spp, monkeypatch)


def _match_jax(tcs, tmeta, jparams, want_loss, want, spp, monkeypatch):
    """The port's step at spp samples a pixel on both routes against JAX's
    loss and gradients, and the calls of G and the fused reverse each
    route makes."""
    shapes, reverses = [], []
    original, original_reverse = table_grad.table_grad, diff_trace.reverse

    def recording(rows, g, shape, count=None):
        shapes.append(tuple(shape))
        return original(rows, g, shape, count=count)

    def recording_reverse(*args, **kwargs):
        out = original_reverse(*args, **kwargs)
        reverses.append(tuple(out.shape))
        return out

    monkeypatch.setattr(table_grad, "table_grad", recording)
    monkeypatch.setattr(diff_trace, "reverse", recording_reverse)
    for route in ("checkpoint", None):
        shapes.clear()
        reverses.clear()
        loss, got, rays = port_step(tcs, tmeta,
                                    tdist.params_from_jax(jparams, "cpu"),
                                    route=route, spp=spp)
        if route == "checkpoint":
            assert tuple(tcs.textures.c0.shape) in shapes
            assert tuple(tcs.materials.fuzz.shape) in shapes
            assert reverses == []
        else:
            assert shapes == []
            assert reverses == [(spp, *tcs.textures.c0.shape)]
        assert rays > spp * N * N
        np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
        assert_grads_close(got, want)
        assert np.abs(got["tex_c0"]).max() > 1e-3


@pytest.mark.parametrize("traversal", ["bvh4", "row"])
def test_bvh_grads_equal_brute_force(cornell, traversal):
    """The same step through a traversal's intersector (its CPU path is
    the plain traversal: `accel.traverse.closest_bvh`, or the row-stack
    `closest_rows`): equal loss and rays, gradients within the tolerances
    above."""
    tcs, tmeta, jparams, _, _ = cornell
    loss, grads, rays = port_step(tcs, tmeta,
                                  tdist.params_from_jax(jparams, "cpu"))
    bloss, bgrads, brays = port_step(tcs, tmeta,
                                     tdist.params_from_jax(jparams, "cpu"),
                                     use_bvh=traversal)
    assert brays == rays
    np.testing.assert_allclose(bloss, loss, rtol=LOSS_RTOL)
    assert_grads_close(bgrads, grads)


@pytest.fixture(scope="module")
def shirley():
    """random_scene (485 spheres, 69 metals) at depth 2, eager JAX."""
    jcs, jmeta, jparams, loss, grads = jax_step(j_get_scene("random_scene"),
                                                eager=True, depth=2)
    tcs, tmeta = tcompiler.from_jax_arrays(jax_leaves(jcs), "cpu", jmeta)
    return tcs, tmeta, jparams, loss, grads


def test_fuzz_gradients_finite_where_jax_is_nan(shirley):
    """random_scene: where JAX's gradient is finite the port's equals it;
    the port's is finite everywhere. JAX's mat_fuzz gradient holds NaNs
    (the untaken branches of its wheres send 0·Inf back, ROADMAP C); this
    test only means something while it does."""
    tcs, tmeta, jparams, want_loss, want = shirley
    loss, got, _ = port_step(tcs, tmeta, tdist.params_from_jax(jparams, "cpu"),
                             depth=2)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    assert_grads_close(got, want, finite_only=True)
    assert not np.isfinite(want["mat_fuzz"]).all()
    # The metals JAX loses still take a gradient in the port.
    assert np.count_nonzero(got["mat_fuzz"][~np.isfinite(want["mat_fuzz"])])


def test_shirley_bvh_grads_equal_brute_force(shirley):
    """random_scene at depth 2 through the plain BVH4 traversal: the fuzz
    gradients, which flow through the hit distance of the winning sphere,
    equal brute force's."""
    tcs, tmeta, jparams, _, _ = shirley
    loss, grads, rays = port_step(tcs, tmeta,
                                  tdist.params_from_jax(jparams, "cpu"),
                                  depth=2)
    bloss, bgrads, brays = port_step(tcs, tmeta,
                                     tdist.params_from_jax(jparams, "cpu"),
                                     use_bvh="bvh4", depth=2)
    assert brays == rays
    np.testing.assert_allclose(bloss, loss, rtol=LOSS_RTOL)
    assert_grads_close(bgrads, grads)
    assert np.count_nonzero(bgrads["mat_fuzz"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gradients_finite_on_the_mixed_scene(seed):
    """The mixed scene (triangles with and without vertex normals, a
    moving metal sphere, an absorbing glass sphere, a checker floor, a
    box, triangle and sphere lights) at 8×8, depth 6: every gradient is
    finite. Without the guards of the differentiable bounce
    (`primitives.own`, the zero-length and degenerate-direction guards)
    seed 0's fuzz gradient is NaN."""
    cs, meta = tcompiler.compile_scene(mixed_scene(tst), "cpu")
    step = tdist.build_train_step(cs, meta, tpath.RenderSettings(max_depth=6),
                                  tpath.make_brute_intersector(cs), N, N)
    xs, ys = (torch.as_tensor(a) for a in _pixels())
    loss, grads = step(tdist.extract_params(cs), xs, ys,
                       torch.as_tensor(_target()), trng.render_key(seed))
    assert torch.isfinite(loss)
    for k, g in grads.items():
        assert torch.isfinite(g).all(), k


def test_gradients_match_finite_differences():
    """d(loss)/d(tex_c0) by autograd against central differences, as
    tests/test_parallel.py:66-109 checks the JAX package: the same keyed
    sample streams on both sides of the perturbation make the estimate a
    deterministic function of the albedo. Cornell without the glass
    sphere, 8×8, depth 3, seed 2, loss mean(colour)."""
    from izpi_tpu_torch.scene.library.cornell import cornell_box

    cs, meta = tcompiler.compile_scene(cornell_box(with_glass_sphere=False),
                                       "cpu")
    settings = tpath.RenderSettings(max_depth=3)
    intersect = tpath.make_brute_intersector(cs)
    xs, ys = (torch.as_tensor(a) for a in _pixels())
    key = trng.render_key(2)

    def loss_of_c0(c0):
        cs_p = cs._replace(textures=cs.textures._replace(c0=c0))
        color, _ = trenderer.sample_pass(cs_p, meta, settings, intersect, N, N,
                                         xs, ys, key, 0, differentiable=True)
        return color.mean()

    c0 = cs.textures.c0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss_of_c0(c0), [c0])
    assert torch.isfinite(g).all()
    eps = 1e-2
    checked = 0
    with torch.no_grad():
        for i, j in [(0, 0), (0, 1), (1, 2), (3, 0)]:
            d = torch.zeros_like(c0)
            d[i, j] = 1.0
            fd = (float(loss_of_c0(c0 + eps * d))
                  - float(loss_of_c0(c0 - eps * d))) / (2 * eps)
            ad = float(g[i, j])
            assert abs(fd - ad) < max(2e-2 * max(abs(fd), abs(ad)), 2e-3), (
                i, j, fd, ad)
            checked += 1
    assert checked == 4


@pytest.mark.parametrize("name", ["cornell_box", "random_scene"])
def test_forward_unchanged_when_autograd_tracks(name):
    """differentiable=False renders the forward estimate whether or not
    autograd records it: the branch guards that keep gradients finite
    (`primitives.own`, `differentiable_t`) change no value. The trace with
    the scene's parameters requiring grad equals the one under no_grad bit
    for bit (colour and rays), and so does the differentiable trace's
    forward loss with and without autograd."""
    cs, meta = tcompiler.compile_scene(t_get_scene(name), "cpu")
    settings = tpath.RenderSettings(max_depth=DEPTH)
    intersect = tpath.make_brute_intersector(cs)
    xs, ys = (torch.as_tensor(a) for a in _pixels())
    key = trng.render_key(SEED)
    params = tdist.extract_params(cs)
    cs_p = tdist.inject_params(cs, params)
    for differentiable in (False, True):
        with torch.no_grad():
            want, wrays = trenderer.sample_pass(cs, meta, settings, intersect,
                                                N, N, xs, ys, key, 0,
                                                differentiable)
        got, rays = trenderer.sample_pass(cs_p, meta, settings, intersect, N,
                                          N, xs, ys, key, 0, differentiable)
        assert got.requires_grad
        assert int(rays) == int(wrays)
        np.testing.assert_array_equal(got.detach().numpy(), want.numpy())


def test_params_from_jax_and_extract():
    """params_from_jax makes leaves that require grad from the JAX leaves;
    extract_params copies the scene's tensors, leaving the scene out of
    autograd; inject_params puts them back."""
    cs, meta = tcompiler.compile_scene(t_get_scene("cornell_box"), "cpu")
    params = tdist.extract_params(cs)
    assert set(params) == set(tdist.PARAMS)
    assert all(p.requires_grad and p.is_leaf for p in params.values())
    assert not cs.textures.c0.requires_grad
    cs2 = tdist.inject_params(cs, params)
    assert cs2.textures.c0 is params["tex_c0"]
    assert cs2.materials.fuzz is params["mat_fuzz"]
    leaves = {k: v.detach().numpy() for k, v in params.items()}
    back = tdist.params_from_jax(leaves, "cpu")
    for k in tdist.PARAMS:
        assert back[k].requires_grad and back[k].dtype == torch.float32
        np.testing.assert_array_equal(back[k].detach().numpy(), leaves[k])
    with pytest.raises(KeyError, match="mat_fuzz"):
        tdist.params_from_jax({k: v for k, v in leaves.items()
                               if k != "mat_fuzz"}, "cpu")


def test_entry_points_on_the_cpu():
    """entry(): one forward sample of the Cornell box at 64², depth 8;
    train_step_demo(): one step at 16², depth 3, finite and with a
    gradient in tex_c0. Both run on the card unless asked for the CPU."""
    fn, args = tentry.entry(device="cpu")
    color, rays = fn(*args)
    assert color.shape == (64 * 64, 3) and torch.isfinite(color).all()
    assert int(rays) >= 64 * 64
    loss, grads = tentry.train_step_demo(device="cpu")
    assert float(loss) > 0 and float(grads["tex_c0"].abs().max()) > 0


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'cuda' requested"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="'cuda' requested"):
        tentry.train_step_demo()
