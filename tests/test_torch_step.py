"""The training step's compiled form, on the CPU: the table gathers' backward
(`ops.table_grad`, its kernel `csrc/table_grad.cu` built as host C++) and
the differentiable trace's fixed trip (`integrator.path.trace`).

Tolerances:
- `TableGather`'s forward and its plain backward are bit for bit what
  PyTorch's indexing and its backward give (the same operations);
- the kernel sums in 64-bit fixed point: each element within
  n²·max|g|·2^-63 of the float64 sum, plus the f32 rounding of the result
  (the bound the source states), and within f32 summation's rounding of
  the plain version (rtol 1e-5, atol 1e-6·max|g|); its output does not
  depend on the order of the rows (bit for bit);
- the fixed-trip trace's loss, rays and gradients equal the early-exit
  form's bit for bit (a bounce of dead paths adds exact zeros).
"""

import ctypes

import numpy as np
import pytest
import torch

from _torch_port import host_kernel
from izpi_tpu_torch.core import loops, rng
from izpi_tpu_torch.core import vecmath as vm
from izpi_tpu_torch.integrator import path
from izpi_tpu_torch.ops import bvh_kernel, diff_trace, table_grad
from izpi_tpu_torch.parallel import dist
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene import compiler
from izpi_tpu_torch.scene.library.cornell import cornell_box
from izpi_tpu_torch.scene.library.misc import cornell_box_obj

# The trainable tables (`dist.PARAMS`) at small sizes, with the number of
# index tensors a gather of each takes (texture/tables.py, spectral/spd.py,
# integrator/path.py `_gather_mat`).
TABLES = {"mat_fuzz": ((9,), 1), "mat_absorption": ((9, 3), 1),
          "tex_c0": ((6, 3), 1), "tex_c1": ((6, 3), 1),
          "tex_images": ((2, 5, 7, 3), 3), "spd_table": ((3, 371), 2)}


def _gather_inputs(shape, n_index, n, seed, dtype=torch.float32):
    """A table of `shape`, n_index index tensors of n ids (a few rows hit
    often, as a wall's rays do, one negative id) and cotangents."""
    rs = np.random.RandomState(seed)
    table = torch.as_tensor(rs.randn(*shape)).to(dtype)
    index = []
    for dim in shape[:n_index]:
        ids = np.where(rs.rand(n) < 0.6, rs.randint(0, min(dim, 2), n),
                       rs.randint(0, dim, n))
        ids[0] = -1
        index.append(torch.as_tensor(ids))
    out_shape = (n, *shape[n_index:])
    g = torch.as_tensor(rs.randn(*out_shape)).to(dtype)
    return table, index, g


@pytest.mark.parametrize("name", list(TABLES))
def test_table_gather_forward_and_plain_backward(name):
    """Forward bit for bit `table[index]`; the CPU backward (the plain
    version) bit for bit the backward of indexing, `index_put_` with
    accumulate on zeros."""
    shape, n_index = TABLES[name]
    table, index, g = _gather_inputs(shape, n_index, 500, 1)
    leaf = table.clone().requires_grad_(True)
    got = table_grad.gather(leaf, *index)
    want = table[tuple(index)]
    assert torch.equal(got, want)
    assert got.grad_fn is not None and "TableGather" in type(got.grad_fn).__name__
    (grad,) = torch.autograd.grad(got, leaf, g)
    ref = torch.zeros_like(table).index_put_(tuple(index), g, accumulate=True)
    assert torch.equal(grad, ref)
    # Without autograd, or on a table that takes no gradient, plain indexing.
    assert table_grad.gather(table, *index).grad_fn is None
    with torch.no_grad():
        assert table_grad.gather(leaf, *index).grad_fn is None


@pytest.mark.parametrize("name", list(TABLES))
def test_table_gather_gradcheck(name):
    """float64 gradcheck of `TableGather` against finite differences."""
    shape, n_index = TABLES[name]
    if name == "spd_table":
        shape = (2, 9)   # the numerical Jacobian takes a column per element
    table, index, _ = _gather_inputs(shape, n_index, 40, 2, torch.float64)
    assert torch.autograd.gradcheck(
        lambda t: table_grad.gather(t, *index), (table.requires_grad_(True),))


def test_flat_rows_and_paths():
    """The flat rows count from the end for a negative id, as indexing
    does; a table of at most SHARED_ELEMS elements takes the kernel's
    shared-memory path."""
    rows = table_grad.flat_rows((2, 5, 7, 3), (torch.tensor([1, -1]),
                                               torch.tensor([4, 0]),
                                               torch.tensor([-2, 6])))
    assert rows.tolist() == [(1 * 5 + 4) * 7 + 5, (1 * 5 + 0) * 7 + 6]
    assert table_grad.path_for((9, 3)) == "shared"
    assert table_grad.path_for((3, 371)) == "shared"
    assert table_grad.path_for((12, 371)) == "global"
    assert table_grad.path_for((1, 512, 512, 3)) == "global"


# The kernel's C entry, for the host: the same three kernels, grids and
# paths as `izpi_table_grad`.
TABLE_GRAD_ENTRY = r"""
extern "C" void run(const long long* rows, const float* g, long long n, const int* count, int c,
                    long long r, void* scratch, float* out) {
  using namespace izpi;
  const long long elems = r * c;
  unsigned long long* acc = (unsigned long long*)scratch;
  unsigned* flags = (unsigned*)(acc + elems);
  unsigned* stat = flags + elems;
  run_grid(grad_blocks(n * c, kGradThreads), kGradThreads,
           [&] { table_grad_absmax(g, n, c, count, stat); });
  if (elems <= kSharedElems) {
    run_grid(grad_blocks(n, kGradThreads * kSharedBatches), kGradThreads,
             [&] { table_grad_scatter_shared(rows, g, n, count, c, elems, stat, acc, flags); });
  } else {
    run_grid(grad_blocks(n, kGradThreads), kGradThreads,
             [&] { table_grad_scatter(rows, g, n, count, c, stat, acc, flags); });
  }
  run_grid(grad_blocks(elems, kGradThreads), kGradThreads,
           [&] { table_grad_finalize(acc, flags, stat, n, count, elems, out); });
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return host_kernel(tmp_path_factory.mktemp("table_grad"), "table_grad.cu",
                       TABLE_GRAD_ENTRY, [p, p, ll, p, i, ll, p, p])


def _host_grad(host, rows, g, shape, count=None):
    c = g.shape[1]
    r = int(np.prod(shape)) // c
    scratch = torch.zeros(r * c * 12 // 8 + 1, dtype=torch.int64)
    out = torch.empty(shape, dtype=torch.float32)
    host.run(ctypes.c_void_p(rows.data_ptr()), ctypes.c_void_p(g.data_ptr()),
             rows.shape[0], ctypes.c_void_p(
                 None if count is None else count.data_ptr()), c, r,
             ctypes.c_void_p(scratch.data_ptr()),
             ctypes.c_void_p(out.data_ptr()))
    return out


@pytest.mark.parametrize("name,n", [("mat_fuzz", 3000),
                                    ("mat_absorption", 2000),
                                    ("spd_table", 1000),
                                    ("tex_images", 1500),
                                    ("big_images", 1100)])
def test_table_grad_kernel_on_host(host, name, n):
    """csrc/table_grad.cu as host C++ against the float64 sum (the fixed
    point's bound) and the plain version (f32 summation), on each path
    (the image stack of 4,608 elements takes the device-memory path); the
    rows in another order give the same bits."""
    shape, n_index = TABLES.get(name, ((2, 16, 48, 3), 3))
    table, index, g = _gather_inputs(shape, n_index, n, 3)
    g[5] *= 1e-30   # tiny values round away only below the bound
    rows = table_grad.flat_rows(shape, index).reshape(-1).contiguous()
    c = int(np.prod(shape[n_index:]))
    g2 = g.reshape(n, c).contiguous()
    assert table_grad.path_for(shape) == (
        "global" if name == "big_images" else "shared")
    got = _host_grad(host, rows, g2, shape)
    exact = torch.zeros((int(np.prod(shape)) // c, c), dtype=torch.float64)
    exact.index_put_((rows,), g2.double(), accumulate=True)
    exact = exact.reshape(shape)
    big = float(g2.abs().max())
    bound = n * n * big * 2.0 ** -63 + exact.abs() * 2.0 ** -24
    assert ((got.double() - exact).abs() <= bound).all()
    plain = table_grad.table_grad(rows, g2, shape)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-6 * big)
    perm = torch.as_tensor(np.random.RandomState(4).permutation(n))
    again = _host_grad(host, rows[perm].contiguous(), g2[perm].contiguous(),
                       shape)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("name,n,live", [("tex_c0", 3000, 1234),
                                         ("big_images", 1100, 517)])
def test_table_grad_kernel_counted_rows(host, name, n, live):
    """With a row count in memory (the fused route's form: a buffer sized
    for every slot, the rows written counted on the device) the kernel adds
    only the first `live` rows, on each path: the same bits as the kernel
    given those rows alone, however the rows past them are filled; the
    wrapper's plain version agrees within G's tolerances."""
    shape, n_index = TABLES.get(name, ((2, 16, 48, 3), 3))
    table, index, g = _gather_inputs(shape, n_index, n, 3)
    rows = table_grad.flat_rows(shape, index).reshape(-1).contiguous()
    c = int(np.prod(shape[n_index:]))
    g2 = g.reshape(n, c).contiguous()
    # Past the count: rows out of range and cotangents that would poison
    # the sums and the fixed point's exponent if they were read.
    rows[live:] = -7
    g2[live:] = float("nan")
    count = torch.tensor([live], dtype=torch.int32)
    got = _host_grad(host, rows, g2, shape, count)
    alone = _host_grad(host, rows[:live].contiguous(),
                       g2[:live].contiguous(), shape)
    assert torch.equal(got.view(torch.int32), alone.view(torch.int32))
    plain = table_grad.table_grad(rows, g2, shape, count=count)
    want = table_grad.table_grad_reference(rows[:live], g2[:live], shape)
    assert torch.equal(plain, want)
    big = float(g2[:live].abs().max())
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-6 * big)


def test_table_grad_kernel_non_finite(host):
    """A NaN, or +Inf beside -Inf, makes its element NaN; an Inf beside
    finite values keeps its sign; the other elements stay finite sums."""
    rows = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3, 3], dtype=torch.int64)
    inf, nan = float("inf"), float("nan")
    g = torch.tensor([[1.0], [nan], [inf], [2.0], [inf], [-inf], [-inf],
                      [0.5], [0.25]], dtype=torch.float32)
    got = _host_grad(host, rows, g, (5,))
    want = torch.zeros(5).index_put_((rows,), g[:, 0], accumulate=True)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])


def _pixels(n, stride, dev="cpu"):
    """n² pixels on a grid of `stride`, the first row offset to the box's
    corners, where paths leave the scene after a few bounces."""
    ys = torch.arange(n).repeat_interleave(n) * stride
    xs = torch.arange(n).repeat(n) * stride
    return xs.to(dev), ys.to(dev)


def _traced_loss(cs, meta, intersect, params, frame, xs, ys, depth,
                 early_exit):
    """(loss, rays, grads by name, bounces run forward) of the
    differentiable trace's checkpointed bounces (route "checkpoint") of one
    sample through (xs, ys) of a frame² image, the loss the mean of the
    colour."""
    bounces = []
    original = path.bounce_rgb

    def counted(*args, **kwargs):
        bounces.append(1)
        return original(*args, **kwargs)

    cs_p = dist.inject_params(cs, params)
    o, d, tme, keys = renderer.camera_rays(cs_p, rng.render_key(3), xs, ys,
                                           frame, frame, 0)
    path.bounce_rgb = counted
    try:
        color, rays = path.trace(cs_p, meta, path.RenderSettings(
            max_depth=depth), intersect, o, d, tme, keys, differentiable=True,
            early_exit=early_exit, route="checkpoint")
        forward = len(bounces)
    finally:
        path.bounce_rgb = original
    loss = vm.de_nan(color).mean()
    grads = torch.autograd.grad(loss, [params[k] for k in dist.PARAMS],
                                allow_unused=True)
    return loss, int(rays), dict(zip(dist.PARAMS, grads)), forward


@pytest.mark.parametrize("name", ["cornell", "cornell_box_obj"])
def test_fixed_trip_trace_equals_early_exit(name):
    """The differentiable trace's fixed trip of max_depth bounces (the
    training step's, JAX's scan) against the early-exit form, on pixels
    whose paths all end before depth 8 (the early exit stops earlier:
    asserted): the same loss, rays and gradients, bit for bit."""
    if name == "cornell":
        cs, meta = compiler.compile_scene(cornell_box(), "cpu")
        intersect = path.make_brute_intersector(cs)
    else:
        cs, meta = compiler.compile_scene(cornell_box_obj(), "cpu")
        cs, intersect = bvh_kernel.attach(cs)
    xs, ys = _pixels(3, 9)
    runs = {}
    for early_exit in (True, False):
        params = dist.extract_params(cs)
        runs[early_exit] = _traced_loss(cs, meta, intersect, params, 32, xs,
                                        ys, 8, early_exit)
    (l1, r1, g1, b1), (l2, r2, g2, b2) = runs[True], runs[False]
    assert b1 < 8 == b2
    assert r1 == r2 and torch.equal(l1, l2)
    for k in dist.PARAMS:
        assert (g1[k] is None) == (g2[k] is None), k
        if g1[k] is not None:
            assert torch.equal(g1[k], g2[k]), k
    assert g1["tex_c0"].abs().max() > 0


@pytest.mark.parametrize("route", ["checkpoint", None])
def test_step_runs_eagerly_on_the_cpu(route):
    """On the CPU the step's runner is `loops.Eager` (a CUDA graph needs a
    card: `loops.Graphed` refuses CPU tensors), the rays are read once
    from the device into `step.rays`, and every gather of a trainable
    table the step reaches has its backward in `table_grad`: on the
    checkpointed bounces each gather of tex_c0 and mat_fuzz; on the fused
    route (the default for the Cornell box, `ops.diff_trace`) none: its
    reverse, called once a step, returns tex_c0's gradient itself, a table
    for each of the step's two sample passes."""
    cs, meta = compiler.compile_scene(cornell_box(), "cpu")
    step = dist.build_train_step(cs, meta, path.RenderSettings(max_depth=3),
                                 path.make_brute_intersector(cs), 8, 8, spp=2,
                                 route=route)
    assert isinstance(step.runner, loops.Eager)
    shapes, reverses = [], []
    original, original_reverse = table_grad.table_grad, diff_trace.reverse

    def recording(rows, g, shape, count=None):
        shapes.append(tuple(shape))
        return original(rows, g, shape, count=count)

    def recording_reverse(*args, **kwargs):
        out = original_reverse(*args, **kwargs)
        reverses.append(tuple(out.shape))
        return out

    table_grad.table_grad = recording
    diff_trace.reverse = recording_reverse
    try:
        xs, ys = _pixels(8, 1)
        loss, grads = step(dist.extract_params(cs), xs, ys,
                           torch.zeros((64, 3)), rng.render_key(0))
    finally:
        table_grad.table_grad = original
        diff_trace.reverse = original_reverse
    assert isinstance(step.rays, int) and step.rays >= 2 * 64
    assert step.runner.trips == 1 and torch.isfinite(loss)
    if route == "checkpoint":
        for k in ("tex_c0", "mat_fuzz"):   # the tables the Cornell box reaches
            assert tuple(grads[k].shape) in shapes, k
    else:
        assert shapes == [] and reverses == [(2, *grads["tex_c0"].shape)]
    with pytest.raises(ValueError, match="CUDA"):
        loops.Graphed().call(lambda x: x + 1, torch.zeros(3))
