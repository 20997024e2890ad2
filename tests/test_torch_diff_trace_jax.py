"""The training step's fused route (`ops.diff_trace`) against the JAX
package's step, on the CPU.

The JAX package's `build_train_step` (jitted, one device, brute force) and
the port's fused step (brute force on the Cornell box; the BVH4 kernel's
intersector, its plain traversal here, on cornell_box_obj) take the same
8×8 pixels, key, target and parameters (`params_from_jax`). Tolerances are
tests/test_torch_grad.py's: the loss within LOSS_RTOL, each gradient entry
within GRAD_ATOL + GRAD_RTOL·|JAX's| (the two packages' libm and XLA's
fused multiply-adds differ in the last ulps). The JAX step's compile takes
most of this file's time, so it lives apart from
tests/test_torch_diff_trace.py.
"""

import numpy as np
import pytest
import torch

from _torch_port import jax_leaves
from izpi_tpu.core import rng as jrng
from izpi_tpu.integrator import path as jpath
from izpi_tpu.parallel import dist as jdist
from izpi_tpu.scene import compiler as jcompiler
from izpi_tpu.scene.library.cornell import cornell_box as j_cornell
from izpi_tpu.scene.library.misc import cornell_box_obj as j_cornell_obj
from izpi_tpu_torch.core import rng
from izpi_tpu_torch.integrator import path
from izpi_tpu_torch.ops import bvh_kernel, diff_trace
from izpi_tpu_torch.parallel import dist
from izpi_tpu_torch.scene import compiler

JAX_N, JAX_DEPTH, SEED = 8, 4, 0
LOSS_RTOL, JAX_GRAD_ATOL, JAX_GRAD_RTOL = 1e-4, 1e-5, 1e-3


def _pixels(n):
    return (torch.arange(n).repeat(n), torch.arange(n).repeat_interleave(n))


def _target(n):
    return torch.as_tensor(
        np.random.RandomState(1).rand(n * n, 3).astype(np.float32) * 0.3)


@pytest.fixture(scope="module", params=["cornell_box", "cornell_box_obj"])
def jax_ref(request):
    """The JAX package's jitted step (brute force, one device) at 8×8,
    depth 4, seed 0: (name, the port's scene from the JAX scene's leaves,
    its meta, params, loss, grads), the last three as numpy."""
    scene = (j_cornell() if request.param == "cornell_box"
             else j_cornell_obj())
    jcs, jmeta = jcompiler.compile_scene(scene)
    intersect = jpath.make_brute_intersector(jcs)
    settings = jpath.RenderSettings(max_depth=JAX_DEPTH)
    xs, ys = (np.asarray(x.numpy(), np.int32) for x in _pixels(JAX_N))
    target = _target(JAX_N).numpy()
    step = jdist.build_train_step(jcs, jmeta, settings, intersect, JAX_N,
                                  JAX_N, jdist.make_mesh(1))
    params = jdist.extract_params(jcs)
    loss, grads = step(params, xs, ys, target, jrng.render_key(SEED))
    tcs, tmeta = compiler.from_jax_arrays(jax_leaves(jcs), "cpu", jmeta)
    return (request.param, tcs, tmeta,
            {k: np.asarray(v) for k, v in params.items()}, float(loss),
            {k: np.asarray(v) for k, v in grads.items()})


def test_fused_step_matches_jax(jax_ref):
    """The port's fused step (brute force on the Cornell box; the BVH4
    kernel's intersector, its plain traversal here, on cornell_box_obj),
    from the JAX parameters (`params_from_jax`), against the JAX
    package's `build_train_step`: loss and every gradient within
    tests/test_torch_grad.py's tolerances."""
    name, tcs, tmeta, jparams, want_loss, want = jax_ref
    intersect = path.make_brute_intersector(tcs)
    if name == "cornell_box_obj":
        tcs, intersect = bvh_kernel.attach(tcs)
    step = dist.build_train_step(tcs, tmeta, path.RenderSettings(
        max_depth=JAX_DEPTH), intersect, JAX_N, JAX_N)
    assert isinstance(step.route, diff_trace.DiffScene)
    xs, ys = _pixels(JAX_N)
    loss, grads = step(dist.params_from_jax(jparams, "cpu"), xs, ys,
                       _target(JAX_N), rng.render_key(SEED))
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    for k in dist.PARAMS:
        g = grads[k].numpy()
        assert g.shape == want[k].shape and np.isfinite(g).all(), k
        np.testing.assert_allclose(g, want[k], rtol=JAX_GRAD_RTOL,
                                   atol=JAX_GRAD_ATOL, err_msg=k)
    assert np.abs(grads["tex_c0"].numpy()).max() > 1e-3
