"""The training step's fused route (`ops.diff_trace`, `csrc/diff_trace.cu`)
on the CPU.

The same pixels, key and parameters go through the fused route (a forward
path kernel that records each bounce, a reverse that walks the record
back and sums the texture rows' gradient in G's fixed point) and through
the checkpointed bounces (`path.trace(..., route="checkpoint")`); the JAX
package's step is in tests/test_torch_diff_trace_jax.py. Tolerances:
- the plain forward against the checkpointed bounce's forward: equal rays,
  the colour bit for bit (it runs `path.bounce_rgb` itself);
- the fused step's gradients against the checkpointed step's: equal loss,
  each entry within rtol 1e-5 and atol 1e-6·max|g| (G's tolerances,
  tests/test_torch_step.py: the two sum the rows' cotangents in another
  order);
- `csrc/diff_trace.cu` built as host C++: the fused reverse's table
  gradient equals G's (`csrc/table_grad.cu` as host C++) on the plain
  version's slots bit for bit (the same IEEE operations in the same order
  for each cotangent, the same fixed-point terms summed in an order that
  changes no bit), and G's plain version within G's tolerances; the
  forward kernel's rays, records
  and radiance agree with the plain version's within rtol 1e-4 on every
  path that takes the same branches, which all but a few do (host libm's
  sin and cos against PyTorch's differ in the last ulp, which moves a
  direction and can turn a path); the closest hit split over a group of
  lanes equals one lane's `closest_hit` bit for bit at every group size
  (the same tests, the first primitive of an exact-t tie), and the probe
  instance writes the main instance's outputs bit for bit.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import host_kernel, loop_step, with_absorbing_glass
from test_torch_step import TABLE_GRAD_ENTRY, _host_grad
from izpi_tpu_torch.core import rng
from izpi_tpu_torch.integrator import path
from izpi_tpu_torch.ops import bvh_kernel, diff_trace, table_grad
from izpi_tpu_torch.parallel import dist
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene import compiler
from izpi_tpu_torch.scene import types as st
from izpi_tpu_torch.scene.library import get_scene
from izpi_tpu_torch.scene.library.cornell import cornell_box
from izpi_tpu_torch.scene.library.misc import cornell_box_obj

N, DEPTH, SEED = 16, 8, 0
GRAD_RTOL, GRAD_ATOL_REL = 1e-5, 1e-6
# The host forward kernel against its plain version on the paths that take
# the same branches: the last ulps of sin and cos move a direction, and
# with it the ratios and throughputs that follow.
REC_RTOL, REC_ATOL = 1e-4, 1e-6


def _checker_box():
    """The Cornell box with a checker floor: the fused route reads c1."""
    scene = cornell_box()
    checker = st.Lambertian(albedo=st.CheckerTexture(
        st.ConstantTexture((0.2, 0.3, 0.1)), st.ConstantTexture((0.9, 0.9,
                                                                  0.8))))
    scene.world[4] = st.XZRect(0, 555, 0, 555, 0, checker)
    return scene


def _context(name):
    """(cs, meta, intersect) on the CPU: brute force, or cornell_box_obj
    through the BVH4 kernel's intersector (its plain traversal here)."""
    if name == "cornell_box_obj":
        cs, meta = compiler.compile_scene(cornell_box_obj(), "cpu")
        cs, intersect = bvh_kernel.attach(cs)
        return cs, meta, intersect
    scene = _checker_box() if name == "checker" else cornell_box()
    cs, meta = compiler.compile_scene(scene, "cpu")
    return cs, meta, path.make_brute_intersector(cs)


@pytest.fixture(scope="module", params=["cornell_box", "checker",
                                        "cornell_box_obj"])
def ctx(request):
    return request.param, _context(request.param)


def _pixels(n=N):
    return (torch.arange(n).repeat(n), torch.arange(n).repeat_interleave(n))


def _rays(cs, n=N, seed=SEED):
    xs, ys = _pixels(n)
    return renderer.camera_rays(cs, rng.render_key(seed), xs, ys, n, n, 0)


def _target(n=N):
    return torch.as_tensor(
        np.random.RandomState(1).rand(n * n, 3).astype(np.float32) * 0.3)


def test_plain_forward_equals_checkpointed_bounces(ctx):
    """The plain forward (`forward_reference`) against `path.trace`'s
    checkpointed bounces on the same camera rays: equal rays, a path's
    records as many as its rays, the colour bit for bit."""
    name, (cs, meta, intersect) = ctx
    scene = diff_trace.prepare(cs, meta, intersect)
    assert scene is not None and (scene.bvh is not None) == (
        name == "cornell_box_obj") and scene.checker == (name == "checker")
    settings = path.RenderSettings(max_depth=DEPTH)
    o, d, tme, keys = _rays(cs)
    want, w_rays = path.trace(cs, meta, settings, intersect, o, d, tme, keys,
                              differentiable=True, route="checkpoint")
    rad, cnt, rec_f, rec_i = diff_trace.forward_reference(
        cs, meta, settings, intersect, o, d, tme, keys)
    got, g_rays = path.trace(cs, meta, settings, intersect, o, d, tme, keys,
                             differentiable=True, route=scene)
    assert int(cnt.sum()) == int(w_rays) == int(g_rays) > N * N
    assert torch.equal(rad, want) and torch.equal(got, want)
    codes = rec_i & 7
    live = torch.arange(DEPTH)[:, None] < cnt[None, :]
    assert bool((codes[~live] == 0).all()) and bool((rec_f[~live] == 0).all())
    # Every path's first record starts at thru 1; a bounce past the first
    # starts from a scatter.
    assert bool((rec_f[0, :, :3] == 1).all())
    for code in (diff_trace.MISS, diff_trace.EMIT, diff_trace.SCATTER):
        assert bool((codes[live] == code).any()), code
    if name == "checker":
        assert bool(((rec_i >> 3) >= cs.textures.c0.shape[0]).any())


def _step(cs, meta, intersect, route, params=None, n=N, depth=DEPTH, spp=1):
    step = dist.build_train_step(cs, meta, path.RenderSettings(
        max_depth=depth), intersect, n, n, spp=spp, route=route)
    params = params if params is not None else dist.extract_params(cs)
    with torch.no_grad():
        params["tex_c0"] *= 0.7
    xs, ys = _pixels(n)
    loss, grads = step(params, xs, ys, _target(n), rng.render_key(SEED))
    return step, float(loss), grads


def test_fused_step_equals_checkpointed_step(ctx, monkeypatch):
    """The step's gradients through `DiffTrace` against the checkpointed
    route, at 2 samples a pixel: equal loss and rays, every gradient within
    rtol 1e-5 and atol 1e-6·max|g|; the fused step calls the fused reverse
    once a step, which returns each sample pass's gradient of c0's rows
    (and c1's after them where a texture is a checker), and G no time; the
    checkpointed step calls G."""
    name, (cs, meta, intersect) = ctx
    calls, reverses = [], []
    original, original_reverse = table_grad.table_grad, diff_trace.reverse

    def recording(rows, g, shape, count=None):
        calls.append(tuple(shape))
        return original(rows, g, shape, count=count)

    def recording_reverse(*args, **kwargs):
        out = original_reverse(*args, **kwargs)
        reverses.append(tuple(out.shape))
        return out

    monkeypatch.setattr(table_grad, "table_grad", recording)
    monkeypatch.setattr(diff_trace, "reverse", recording_reverse)
    fused, loss, grads = _step(cs, meta, intersect, None, spp=2)
    n_tex = cs.textures.c0.shape[0]
    assert isinstance(fused.route, diff_trace.DiffScene)
    assert reverses == [(2, n_tex * (2 if name == "checker" else 1), 3)]
    assert calls == []
    ref, ref_loss, ref_grads = _step(cs, meta, intersect, "checkpoint",
                                     spp=2)
    assert ref.route == "checkpoint" and len(calls) > 1 and len(reverses) == 1
    assert fused.rays == ref.rays and loss == ref_loss
    for k in dist.PARAMS:
        g, w = grads[k].numpy(), ref_grads[k].numpy()
        assert np.isfinite(g).all(), k
        atol = GRAD_ATOL_REL * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=k)
    assert np.abs(grads["tex_c0"].numpy()).max() > 1e-4
    if name == "checker":
        assert np.abs(grads["tex_c1"].numpy()).max() > 1e-5


@pytest.mark.parametrize("spp", [1, 2, 3])
def test_merged_passes_equal_per_sample_loop(ctx, spp, monkeypatch):
    """The fused step's sample passes as one pass of spp·N paths
    (`renderer.sample_passes`, through the plain versions here) against
    the same step a sample pass at a time: the loss, the rays and every
    gradient bit for bit, and each pass's camera rays, radiance and
    records those of its own pass; one call of the fused reverse a step,
    with each pass's table, and the checkpointed route's step unchanged."""
    name, (cs, meta, intersect) = ctx
    settings = path.RenderSettings(max_depth=DEPTH)
    reverses = []
    original_reverse = diff_trace.reverse

    def recording_reverse(*args, **kwargs):
        out = original_reverse(*args, **kwargs)
        reverses.append(tuple(out.shape))
        return out

    monkeypatch.setattr(diff_trace, "reverse", recording_reverse)
    step = dist.build_train_step(cs, meta, settings, intersect, N, N, spp=spp)
    route = step.route
    assert isinstance(route, diff_trace.DiffScene)
    params = dist.extract_params(cs)
    with torch.no_grad():
        params["tex_c0"] *= 0.7
    xs, ys = _pixels()
    target, key = _target(), rng.render_key(SEED)
    loss, grads = step(params, xs, ys, target, key)
    n_rows = route.n_tex * (2 if route.checker else 1)
    assert reverses == [(spp, n_rows, 3)]
    want_loss, want_grads, want_rays = loop_step(
        cs, meta, settings, intersect, N, spp, route, params, xs, ys, target,
        key)
    assert len(reverses) == 1 + spp
    assert step.rays == want_rays
    assert torch.equal(loss.view(torch.int32), want_loss.view(torch.int32))
    for k in dist.PARAMS:
        assert torch.equal(grads[k].view(torch.int32),
                           want_grads[k].view(torch.int32)), k
    assert float(grads["tex_c0"].abs().max()) > 0

    # Each pass of the merged forward against its own pass's.
    colours, rays = renderer.sample_passes(cs, meta, settings, intersect, N,
                                           N, xs, ys, key, spp, route)
    assert colours.shape == (spp, N * N, 3) and int(rays) == want_rays
    merged = renderer.sample_rays(cs, key, xs, ys, N, N, spp)
    rays_all = [renderer.camera_rays(cs, key, xs, ys, N, N, s)
                for s in range(spp)]
    for got, parts in zip(merged, zip(*rays_all)):
        assert torch.equal(got, torch.cat(parts))
    out = diff_trace.forward(route, cs, meta, settings, intersect, *merged)
    for s in range(spp):
        own = slice(s * N * N, (s + 1) * N * N)
        rad, cnt, rec_f, rec_i = diff_trace.forward(
            route, cs, meta, settings, intersect, *rays_all[s])
        assert torch.equal(out[0][own].view(torch.int32),
                           rad.view(torch.int32))
        assert torch.equal(out[1][own], cnt)
        assert torch.equal(out[2][:, own], rec_f)
        assert torch.equal(out[3][:, own], rec_i)
        color, _ = renderer.sample_pass(cs, meta, settings, intersect, N, N,
                                        xs, ys, key, s, differentiable=True,
                                        route=route)
        assert torch.equal(colours[s], color)

    # The checkpointed route keeps its per-sample loop: its step is the loop's.
    ckpt = dist.build_train_step(cs, meta, settings, intersect, N, N,
                                 spp=spp, route="checkpoint")
    c_loss, c_grads = ckpt(params, xs, ys, target, key)
    w_loss, w_grads, w_rays = loop_step(cs, meta, settings, intersect, N, spp,
                                        "checkpoint", params, xs, ys, target,
                                        key)
    assert ckpt.rays == w_rays and torch.equal(c_loss, w_loss)
    for k in dist.PARAMS:
        assert torch.equal(c_grads[k], w_grads[k]), k


def test_fused_backward_runs_once():
    """The reverse keeps its cotangents in the forward's records, so the
    graph's backward runs once: a second, over a retained graph, raises
    as after an in-place change of a saved tensor."""
    cs, meta, intersect = _context("cornell_box")
    route = diff_trace.prepare(cs, meta, intersect)
    params = dist.extract_params(cs)
    cs_p = dist.inject_params(cs, params)
    xs, ys = _pixels(4)
    colours, _ = renderer.sample_passes(
        cs_p, meta, path.RenderSettings(max_depth=4), intersect, 4, 4, xs, ys,
        rng.render_key(SEED), 2, route)
    loss = colours.sum()
    loss.backward(retain_graph=True)
    assert float(params["tex_c0"].grad.abs().max()) > 0
    with pytest.raises(RuntimeError, match="inplace operation"):
        loss.backward()


def _with_sphere_material(scene, material):
    world = [dataclasses.replace(h, material=material)
             if isinstance(h, st.Sphere) else h for h in scene.world]
    return dataclasses.replace(scene, world=world)


def _ineligible(name):
    if name == "metal":
        return _with_sphere_material(cornell_box(), st.Metal(
            albedo=(0.8, 0.6, 0.4), fuzz=0.2))
    if name == "absorbing_glass":
        return with_absorbing_glass(cornell_box())
    if name == "pbr":
        return _with_sphere_material(cornell_box(), st.PBR(
            albedo=st.ConstantTexture((0.7, 0.5, 0.3)),
            roughness=st.ConstantTexture((0.4, 0.4, 0.4))))
    if name == "media":
        scene = cornell_box()
        smoke = st.ConstantMedium(
            boundary=st.Sphere((370, 100, 180), (370, 100, 180), 0, 1, 80,
                               st.Lambertian(albedo=st.ConstantTexture(
                                   (1.0, 1.0, 1.0)))),
            density=0.01, phase=st.Isotropic(albedo=st.ConstantTexture(
                (0.8, 0.8, 0.8))))
        return dataclasses.replace(scene, world=scene.world + [smoke])
    return get_scene(name)


@pytest.mark.parametrize("name", ["metal", "absorbing_glass", "pbr", "media",
                                  "cornell_box_spectral_simple"])
def test_ineligible_scenes_keep_the_checkpointed_bounces(name):
    """Metal, absorbing glass, PBR, media and spectral scenes: not
    `eligible_diff`, so the step takes the checkpointed bounces by itself,
    and its loss, rays and gradients are those of the step told to
    (route "checkpoint"), bit for bit."""
    cs, meta = compiler.compile_scene(_ineligible(name), "cpu")
    intersect = path.make_brute_intersector(cs)
    assert not diff_trace.eligible_diff(cs, meta, intersect)
    assert diff_trace.prepare(cs, meta, intersect) is None
    runs = [_step(cs, meta, intersect, route, n=8, depth=3)
            for route in (None, "checkpoint")]
    (s1, l1, g1), (s2, l2, g2) = runs
    assert s1.route == s2.route == "checkpoint"
    assert s1.rays == s2.rays and l1 == l2
    for k in dist.PARAMS:
        assert torch.equal(g1[k], g2[k]), k
        assert torch.isfinite(g1[k]).all(), k


def test_eligibility_needs_the_scanned_scene():
    """The intersector must scan the scene's own primitives: brute force
    within 560 primitives, or the BVH4 kernel's; the row-stack pair and
    another scene's brute force keep the checkpointed bounces."""
    from izpi_tpu_torch.ops import bvh_rowkernel

    cs, meta = compiler.compile_scene(cornell_box(), "cpu")
    assert diff_trace.eligible_diff(cs, meta, path.make_brute_intersector(cs))
    params = dist.extract_params(cs)
    cs_p = dist.inject_params(cs, params)   # the step's: same primitives
    assert diff_trace.eligible_diff(cs_p, meta,
                                    path.make_brute_intersector(cs))
    other, _ = compiler.compile_scene(cornell_box(), "cpu")
    assert not diff_trace.eligible_diff(cs, meta,
                                        path.make_brute_intersector(other))
    cs_r, row = bvh_rowkernel.attach(cs)
    assert not diff_trace.eligible_diff(cs_r, meta, row)
    cs_b, bvh = bvh_kernel.attach(cs)
    assert diff_trace.eligible_diff(cs_b, meta, bvh)
    big = dataclasses.replace(meta, n_prims=600)
    assert not diff_trace.eligible_diff(cs, big,
                                        path.make_brute_intersector(cs))
    with pytest.raises(ValueError, match="route"):
        path.trace(cs, meta, path.RenderSettings(max_depth=2),
                   path.make_brute_intersector(cs), *_rays(cs, 2),
                   differentiable=True, route="fused")


# ---------------------------------------------------------------------------
# csrc/diff_trace.cu as host C++
# ---------------------------------------------------------------------------

HOST_ENTRY = r"""
extern "C" void fwd(const float* prim_f, const int* prim_i, int n_prims, const float* mat_f,
                    const int* mat_i, const float* light_f, const int* light_i, int n_lights,
                    const int* nodes, const float* bvh_prims, const float* c0, const float* c1,
                    int n_tex, const float* o, const float* d, const float* t,
                    const long long* keys, int n, int max_depth, float bg_r, float bg_g,
                    float bg_b, int book, float* rad, int* cnt, float* rec_f, int* rec_i,
                    unsigned long long* probe) {
  const izpi::Scene sc{prim_f, prim_i, n_prims, mat_f, mat_i, light_f, light_i, n_lights};
  const izpi::diff::Tex tex{c0, c1, n_tex};
  const izpi::diff::FwdArgs a{o, d, t, keys, n, max_depth, izpi::mk(bg_r, bg_g, bg_b),
                              book ? 2.0f : 1.0f, rad, cnt, rec_f, rec_i, probe};
  const izpi::diff::BvhHit bvh{nodes, bvh_prims};
  const int threads = izpi::diff::kThreads;
  run_grid((n + threads - 1) / threads, threads, [&] {
    if (nodes == nullptr && probe == nullptr) {
      izpi::diff::diff_trace_fwd(sc, tex, a);
    } else if (nodes == nullptr) {
      izpi::diff::diff_trace_fwd_probe(sc, tex, a);
    } else if (probe == nullptr) {
      izpi::diff::diff_trace_fwd_bvh(sc, bvh, tex, a);
    } else {
      izpi::diff::diff_trace_fwd_bvh_probe(sc, bvh, tex, a);
    }
  });
}

// The closest hit of n_rays rays over the primitive rows taken by groups
// of G lanes, and one lane's (closest_hit) beside it: t and index a ray.
extern "C" void group_hits(const float* prim_f, const int* prim_i, int n_prims, const float* o,
                           const float* d, const float* t, int n_rays, int G, float* t_out,
                           int* idx_out, float* t_ref, int* idx_ref) {
  const izpi::Scene sc{prim_f, prim_i, n_prims, nullptr, nullptr, nullptr, nullptr, 0};
  const int per = 32 / G;
  run_grid((n_rays + per - 1) / per, 32, [&] {
    const int lane = threadIdx.x & 31, r = lane % G;
    const int ray = blockIdx.x * per + lane / G;
    const bool has = ray < n_rays;
    const int k = has ? ray : 0;
    const izpi::V3 ro = izpi::ld3(o + 3 * k), rd = izpi::ld3(d + 3 * k);
    float tg;
    const int hit =
        izpi::diff::BruteHit{}.group(sc, has, ro, rd, t[k], izpi::kTMin, izpi::kTMax, G, r, tg);
    if (has && r == 0) {
      t_out[ray] = tg;
      idx_out[ray] = hit;
      idx_ref[ray] = izpi::closest_hit(sc, ro, rd, t[k], izpi::kTMin, izpi::kTMax, t_ref[ray]);
    }
  });
}

// The fused reverse: its two passes, as izpi_diff_trace_bwd launches them.
extern "C" void run(float* rec_f, const int* rec_i, const int* cnt, const float* g_rad,
                    const float* c0, const float* c1, int n_tex, int n, int n_pass,
                    int max_depth, float bg_r, float bg_g, float bg_b, int n_rows,
                    void* scratch, float* out) {
  using namespace izpi::diff;
  const Tex tex{c0, c1, n_tex};
  const RevArgs ra{rec_f, rec_i, cnt, g_rad, n, n_pass, izpi::mk(bg_r, bg_g, bg_b)};
  const long long elems = 3LL * n_rows;
  const int blocks = (n / n_pass) * pass_blocks(n_pass);
  const GradScratch gs = grad_scratch(scratch, elems * (n / n_pass), blocks);
  float4* kept = reinterpret_cast<float4*>(rec_f);
  run_grid(blocks, kRevThreads, [&] {
    diff_trace_bwd_stat(tex, ra, gs, elems * (n / n_pass), kept);
  });
  const int path = add_path(elems);
  run_grid(blocks, kRevThreads, [&] {
    if (path == kAddLane) {
      diff_trace_bwd_lane(ra, gs, elems, kept, out);
    } else if (path == kAddBlock) {
      diff_trace_bwd_block(ra, gs, elems, kept, out);
    } else {
      diff_trace_bwd_global(ra, gs, elems, kept, out);
    }
  });
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = host_kernel(tmp_path_factory.mktemp("diff_trace"), "diff_trace.cu",
                      HOST_ENTRY, [p, p, p, p, p, p, i, i, i, i, f, f, f, i,
                                   p, p])
    lib.fwd.argtypes = ([p, p, i, p, p, p, p, i, p, p, p, p, i, p, p, p, p, i,
                         i, f, f, f, i] + [p] * 5)
    lib.group_hits.argtypes = [p, p, i, p, p, p, i, i] + [p] * 4
    return lib


@pytest.fixture(scope="module")
def g_host(tmp_path_factory):
    """G (csrc/table_grad.cu) as host C++: the yardstick of the fused
    reverse's bits."""
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return host_kernel(tmp_path_factory.mktemp("table_grad"), "table_grad.cu",
                       TABLE_GRAD_ENTRY, [p, p, ll, p, i, ll, p, p])


def _host_reverse(host, rec_f, rec_i, cnt, g_rad, c0, c1, background, n_rows,
                  passes=1):
    """The fused reverse as host C++ over `passes` sample passes: each
    pass's table gradient (passes, n_rows, 3), from a scratch filled with
    bytes it must not read (room for every pass's table and a block's
    partials): it zeroes what it adds into. It keeps each record's
    cotangent in the record's place, overwriting rec_f."""
    depth, n = rec_i.shape
    scratch = torch.full(((36 * n_rows * passes + 8 * n + 12 + 7) // 8,), -3,
                         dtype=torch.int64)
    out = torch.full((passes, n_rows, 3), -7.0)
    host.run(_p(rec_f), _p(rec_i), _p(cnt), _p(g_rad), _p(c0), _p(c1),
             c0.shape[0], n, n // passes, depth,
             *[float(x) for x in background], n_rows, _p(scratch), _p(out))
    return out


def _reverse_vs_g(host, g_host, rec_f, rec_i, cnt, g_rad, c0, c1, background,
                  checker):
    """The fused reverse (host C++) against G's host build on
    `reverse_reference`'s counted slots: bit for bit
    (the same terms, summed in an order that changes no bit), and against
    G's plain version within G's tolerances (rtol 1e-5, atol 1e-6·max|g|;
    NaN where it is NaN). Returns the gradient."""
    n_tex = c0.shape[0]
    n_rows = n_tex * (2 if checker else 1)
    depth = rec_i.shape[0]
    rows, g, count = diff_trace.reverse_reference(
        rec_f, rec_i, cnt, g_rad, c0, c1,
        path.RenderSettings(max_depth=depth, background=background), checker)
    live = int(count)
    assert live == int(cnt.sum())
    want = _host_grad(g_host, rows[:live].contiguous(), g[:live].contiguous(),
                      (n_rows, 3))
    got = _host_reverse(host, rec_f.clone(), rec_i, cnt, g_rad, c0, c1,
                        background, n_rows)[0]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    plain = table_grad.table_grad_reference(rows[:live], g[:live],
                                            (n_rows, 3))
    assert torch.equal(torch.isnan(got), torch.isnan(plain))
    ok = ~torch.isnan(plain)
    big = float(g[:live][torch.isfinite(g[:live])].abs().max()) if live else 0
    torch.testing.assert_close(got[ok], plain[ok], rtol=1e-5,
                               atol=1e-6 * max(big, 1e-30))
    return got


def _p(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _host_forward(host, scene, cs, meta, settings, o, d, tme, keys,
                  probe=None):
    """The forward kernel as host C++ (with `probe`, a zeroed int64 tensor
    of (warps, PROBE_COLUMNS), its probe instance)."""
    n, depth = o.shape[0], settings.max_depth
    rad = torch.zeros((n, 3))
    cnt = torch.zeros((n,), dtype=torch.int32)
    rec_f = torch.zeros((depth, n, 4))
    rec_i = torch.zeros((depth, n), dtype=torch.int32)
    bvh = scene.bvh
    c0, c1 = cs.textures.c0.contiguous(), cs.textures.c1.contiguous()
    host.fwd(_p(scene.prim_f), _p(scene.prim_i), meta.n_prims,
             _p(scene.mat_f), _p(scene.mat_i), _p(scene.light_f),
             _p(scene.light_i), meta.n_lights,
             _p(None if bvh is None else bvh.nodes),
             _p(None if bvh is None else bvh.prim_table), _p(c0), _p(c1),
             scene.n_tex, _p(o), _p(d), _p(tme), _p(keys), n, depth,
             *[float(x) for x in settings.background],
             int(settings.exact_book_cosine), _p(rad), _p(cnt), _p(rec_f),
             _p(rec_i), _p(probe))
    return rad, cnt, rec_f, rec_i


@pytest.mark.parametrize("background", [(0.0, 0.0, 0.0), (0.7, 0.8, 1.0)])
def test_kernels_on_host_equal_plain(host, g_host, ctx, background):
    """The forward kernel on the step's camera rays (brute force and the
    BVH form) and the fused reverse on the plain forward's records, as
    host C++, against their plain versions (the module docstring's
    tolerances): at most 2% of the paths turn (another ray count or
    record code or row), the others' records and radiance agree within
    REC_RTOL, REC_ATOL; the reverse's table gradient bit for bit G's on
    the plain version's slots, under a black and a sky background."""
    name, (cs, meta, intersect) = ctx
    scene = diff_trace.prepare(cs, meta, intersect)
    settings = path.RenderSettings(max_depth=DEPTH, background=background)
    o, d, tme, keys = (x.contiguous() for x in _rays(cs))
    want = diff_trace.forward_reference(cs, meta, settings, intersect, o, d,
                                        tme, keys)
    got = _host_forward(host, scene, cs, meta, settings, o, d, tme, keys)
    live = torch.arange(DEPTH)[:, None] < want[1][None, :]
    same = (got[1] == want[1]) & ((got[3] == want[3]) | ~live).all(0)
    assert float(same.float().mean()) >= 0.98, float(same.float().mean())
    keep = live & same[None, :]
    np.testing.assert_allclose(got[2][keep].numpy(), want[2][keep].numpy(),
                               rtol=REC_RTOL, atol=REC_ATOL)
    np.testing.assert_allclose(got[0][same].numpy(), want[0][same].numpy(),
                               rtol=REC_RTOL, atol=REC_ATOL)

    rs = np.random.RandomState(7)
    g_rad = torch.as_tensor(rs.randn(N * N, 3).astype(np.float32))
    rec_f, rec_i, cnt = want[2], want[3], want[1]
    assert int(cnt.sum()) < DEPTH * N * N
    # Past a path's records the planes hold what the kernel never reads.
    rec_f = torch.where(live[..., None], rec_f, torch.nan)
    rec_i = torch.where(live, rec_i, -1)
    c0, c1 = cs.textures.c0.contiguous(), cs.textures.c1.contiguous()
    grad = _reverse_vs_g(host, g_host, rec_f, rec_i, cnt, g_rad, c0, c1,
                         background, scene.checker)
    assert float(grad.abs().max()) > 0


def _random_records(n, n_tex, depth=6, seed=None):
    """Records of every code over n paths of 0 to depth records (a third of
    the first 300 paths with none), rows of a checker's [c0; c1] table of
    n_tex rows each, and the radiance's cotangent, from numpy's seed."""
    rs = np.random.RandomState(n if seed is None else seed)
    cnt = torch.as_tensor(rs.randint(0, depth + 1, size=n).astype(np.int32))
    cnt[: min(n, 300)] = torch.where(torch.arange(min(n, 300)) % 3 == 0, 0,
                                     cnt[: min(n, 300)])
    codes = rs.randint(0, 5, size=(depth, n))
    rec_i = torch.as_tensor(((rs.randint(0, 2 * n_tex, size=(depth, n))
                              << diff_trace.CODE_BITS) | codes).astype(
                                  np.int32))
    rec_f = torch.as_tensor(rs.rand(depth, n, 4).astype(np.float32))
    g_rad = torch.as_tensor(rs.randn(n, 3).astype(np.float32))
    c0 = torch.as_tensor(rs.rand(n_tex, 3).astype(np.float32))
    c1 = torch.as_tensor(rs.rand(n_tex, 3).astype(np.float32))
    return rec_f, rec_i, cnt, g_rad, c0, c1


@pytest.mark.parametrize("n", [1, 128, 1000, 4100])
def test_reverse_kernel_sums_random_records_on_host(host, g_host, n):
    """The fused reverse over one block, a whole one and partial last
    blocks (blocks and paths with no record, n = 1's only path among
    them), on random records of every
    code into a checker's 4 rows (12 elements: the lanes' own copies in
    shared memory), each block's paths sorted by length: the table gradient
    G gives on the plain version's slots, bit for bit, under a sky
    background."""
    rec_f, rec_i, cnt, g_rad, c0, c1 = _random_records(n, 2)
    assert diff_trace.add_path(4) == "lane"
    grad = _reverse_vs_g(host, g_host, rec_f, rec_i, cnt, g_rad, c0, c1,
                         (0.7, 0.8, 1.0), True)
    # n = 1: its one path has no record, and the gradient is zero.
    assert bool(torch.isfinite(grad).all())
    assert (float(grad.abs().max()) > 0) == (int(cnt.sum()) > 0) == (n > 1)


@pytest.mark.parametrize("n_tex,path_name", [(100, "shared"),
                                             (1400, "global")])
def test_reverse_kernel_table_paths_on_host(host, g_host, n_tex, path_name):
    """A table of 600 elements (the block's copy in shared memory, its rows
    staged) and of 8,400 (above 4,096: straight into device memory, its
    rows read from device memory): bit for bit G's on the plain slots."""
    rows = 2 * n_tex
    assert table_grad.path_for((rows, 3)) == path_name
    assert diff_trace.add_path(rows) == ("block" if path_name == "shared"
                                         else "global")
    rec_f, rec_i, cnt, g_rad, c0, c1 = _random_records(300, n_tex, seed=5)
    grad = _reverse_vs_g(host, g_host, rec_f, rec_i, cnt, g_rad, c0, c1,
                         (0.0, 0.0, 0.0), True)
    assert float(grad.abs().max()) > 0


@pytest.mark.parametrize("passes,n,n_tex", [(2, 300, 2), (3, 128, 100),
                                            (4, 257, 1400)])
def test_reverse_kernel_passes_on_host(host, g_host, passes, n, n_tex):
    """The fused reverse over `passes` sample passes of n paths each (the
    lanes' copies, the block's and device memory; a pass's last block
    partial where 256 does not divide n): each pass's table bit for bit
    the reverse's over that pass alone, which is G's on the pass's plain
    slots, though the passes' largest cotangents, and so their exponents,
    differ; the live records hold their kept cotangents after it."""
    rec_f, rec_i, cnt, g_rad, c0, c1 = _random_records(passes * n, n_tex,
                                                       seed=13)
    g_rad = g_rad * (4.0 ** torch.arange(passes)).repeat_interleave(n)[:, None]
    n_rows, background = 2 * n_tex, (0.7, 0.8, 1.0)
    want = []
    for s in range(passes):
        own = slice(s * n, (s + 1) * n)
        want.append(_reverse_vs_g(
            host, g_host, rec_f[:, own].contiguous(),
            rec_i[:, own].contiguous(), cnt[own].contiguous(),
            g_rad[own].contiguous(), c0, c1, background, True))
    records = rec_f.clone()
    got = _host_reverse(host, records, rec_i, cnt, g_rad, c0, c1, background,
                        n_rows, passes)
    for s in range(passes):
        assert torch.equal(got[s].view(torch.int32),
                           want[s].view(torch.int32)), s
    live = torch.arange(rec_f.shape[0])[:, None] < cnt[None, :]
    assert torch.equal(records[~live], rec_f[~live])
    assert not torch.equal(records[live], rec_f[live])
    assert len({float(w.abs().max()) for w in want}) == passes


def test_reverse_kernel_non_finite_on_host(host, g_host):
    """NaN, +Inf and -Inf in the radiance's cotangent: each element they
    reach comes back NaN or ±Inf by G's flags, the others as finite sums,
    bit for bit G's on the plain slots."""
    rec_f, rec_i, cnt, g_rad, c0, c1 = _random_records(300, 5, seed=9)
    live = torch.nonzero(cnt > 0).flatten()
    g_rad[live[0]] = torch.tensor([float("nan"), 0.5, 0.5])
    g_rad[live[1], 1] = float("inf")
    g_rad[live[2], 2] = -float("inf")
    grad = _reverse_vs_g(host, g_host, rec_f, rec_i, cnt, g_rad, c0, c1,
                         (0.7, 0.8, 1.0), True)
    assert bool(torch.isnan(grad).any()) and bool(torch.isfinite(grad).any())


def test_reverse_kernel_zero_cotangent_on_host(host, g_host):
    """An all-zero cotangent of the radiance (no finite |value| above 0,
    the fixed point's exponent 0): a zero gradient, G's bits."""
    rec_f, rec_i, cnt, g_rad, c0, c1 = _random_records(100, 5, seed=11)
    grad = _reverse_vs_g(host, g_host, rec_f, rec_i, cnt,
                         torch.zeros_like(g_rad), c0, c1, (0.7, 0.8, 1.0),
                         True)
    assert bool((grad == 0).all())


def _random_rays(n, seed, lo, hi):
    """n rays from points in the box [lo, hi]³ in random directions, at
    random times, from numpy's seed."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    t = rs.rand(n).astype(np.float32)
    return tuple(torch.as_tensor(x) for x in (o, d, t))


def _group_hits(host, prim_f, prim_i, rays, g):
    """(t, index) of the rays by groups of g lanes and by one lane."""
    o, d, t = rays
    n = o.shape[0]
    out = [torch.full((n,), torch.nan), torch.full((n,), -7, dtype=torch.int32)]
    ref = [torch.full((n,), torch.nan), torch.full((n,), -7, dtype=torch.int32)]
    host.group_hits(_p(prim_f), _p(prim_i), prim_f.shape[0], _p(o), _p(d),
                    _p(t), n, g, *[_p(x) for x in out + ref])
    return out, ref


@pytest.mark.parametrize("g", diff_trace.GROUPS)
def test_group_closest_hit_equals_one_lane_on_host(host, g):
    """The forward kernel's closest hit taken by groups of g lanes (each
    lane a share of the primitives, the group's lexicographic least (t,
    index)) against one lane's `closest_hit`, as host C++, bit for bit: on
    the Cornell box's camera rays and rays in random directions from inside
    it, and on its primitive table twice over, where every hit is an exact-t
    tie that the first copy must win."""
    cs, meta, intersect = _context("cornell_box")
    scene = diff_trace.prepare(cs, meta, intersect)
    o, d, tme, _ = _rays(cs, 8)
    rays = [torch.cat([a, b]).contiguous() for a, b in zip(
        (o, d, tme), _random_rays(192, 3, 20.0, 530.0))]
    n_p = meta.n_prims
    for twice in (False, True):
        prim_f = torch.cat([scene.prim_f] * (2 if twice else 1)).contiguous()
        prim_i = torch.cat([scene.prim_i] * (2 if twice else 1)).contiguous()
        (t, idx), (t_ref, idx_ref) = _group_hits(host, prim_f, prim_i, rays,
                                                 g)
        assert torch.equal(idx, idx_ref) and torch.equal(
            t.view(torch.int32), t_ref.view(torch.int32))
        hits = idx >= 0
        assert float(hits.float().mean()) > 0.5
        assert bool((idx[hits] < n_p).all()) or not twice


def test_probe_on_host_sees_every_group_size(host, ctx):
    """The forward kernel's probe instance as host C++ at depth 50, where a
    warp's last paths run with few others: its outputs equal the main
    instance's bit for bit, each warp's passes are its longest path, and
    the brute-force form's passes ran at every group size, 1 to 32 lanes a
    path (at depth 8 the 16² frame's warps never get below 3 live paths);
    the BVH form, one thread a path, counts no group."""
    name, (cs, meta, intersect) = ctx
    scene = diff_trace.prepare(cs, meta, intersect)
    settings = path.RenderSettings(max_depth=50)
    rays = [x.contiguous() for x in _rays(cs)]
    main = _host_forward(host, scene, cs, meta, settings, *rays)
    rows = torch.zeros((-(-N * N // diff_trace.WARP_PATHS),
                        len(diff_trace.PROBE_COLUMNS)), dtype=torch.int64)
    probed = _host_forward(host, scene, cs, meta, settings, *rays,
                           probe=rows)
    live = torch.arange(50)[:, None] < main[1][None, :]
    assert torch.equal(probed[0].view(torch.int32), main[0].view(torch.int32))
    assert torch.equal(probed[1], main[1])
    assert torch.equal(probed[2][live], main[2][live])
    assert torch.equal(probed[3][live], main[3][live])
    summary = diff_trace.probe_summary(rows, probed[1])
    assert summary["passes_equal_longest"]
    assert summary["bounces"] == int(main[1].sum())
    by_group = summary["passes_by_group"].values()
    if scene.bvh is None:
        assert all(v > 0 for v in by_group), summary["passes_by_group"]
    else:
        assert not any(by_group), summary["passes_by_group"]
