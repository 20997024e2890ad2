"""The training step's bounce loop: a forward path kernel that records each
bounce and a reverse kernel that walks the record back.

Counterpart of the JAX package's jitted step (izpi_tpu/parallel/dist.py:
597-643), whose trace is a `lax.scan` of `jax.checkpoint`ed bounces
(izpi_tpu/integrator/path.py:699-740); no `pallas_call`. Its kernels are
`csrc/diff_trace.cu` (the source's head says what they compute and why
that needs no geometry adjoint):
- `izpi_diff_trace_fwd`, a warp's 32 paths in its lanes (brute force: a
  bounce a pass, the lanes of ended paths helping the live ones with their
  closest hits and draws; the BVH form: one thread a path): the
  differentiable bounce of `integrator.path.bounce_rgb` from the camera
  ray to the path's end, with one 20-byte record a live bounce (thru,
  ratio, the texture row gathered and a code), its radiance and its ray
  count, the bits of one thread a path;
- `izpi_diff_trace_bwd`, the fused reverse, in two launches: the first
  sorts a block's paths by record count and walks a warp's records back
  plane by plane from the radiance's cotangent to each gathered row's,
  keeping those and finding their largest value; the second sums them
  straight into the texture tables' gradient in the 64-bit fixed point of
  G (`ops.table_grad`, `csrc/fixed_point.cuh`), whose bits it gives, with
  no (row, cotangent) slot and no call of G.

The training step traces its sample passes in one launch of each: pass s
is paths [s·N, (s+1)·N) of one forward launch, and the reverse sums each
pass into a table of its own (`reverse`'s `passes`), so that each pass's
gradient has the bits a launch over it alone gives; `DiffTrace` adds the
passes' tables in the order autograd added one call's each.

It takes the scenes where no trainable parameter reaches a ray's origin or
direction (`eligible_diff`): the RGB megakernel's shading without metal
and absorbing glass, constant or checker textures, through brute force or
the BVH4 kernel's intersector. Every other scene keeps the checkpointed
PyTorch bounce (`integrator.path.trace`'s route "checkpoint").

This module holds:
- `eligible_diff` and `prepare`, the host's decision and the static tables
  (`DiffScene`), made once when `parallel.dist.build_train_step` builds
  the step, never inside a captured step;
- `forward` and `reverse`, the wrappers: a CUDA tensor launches the kernel
  on the current stream (or the call raises), a CPU tensor runs the plain
  version, `forward_reference` (built from `bounce_rgb` itself) or
  `reverse_reference`'s slots summed by `table_grad_reference`;
- `probe`, the forward kernel's probe instance (the card only, never on a
  main path): the same outputs and how its warps spent the launch;
- `DiffTrace`, the `torch.autograd.Function` over both, and `trace`, which
  `integrator.path.trace` calls.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from izpi_tpu_torch.core import vecmath as vm
from izpi_tpu_torch.integrator import path as path_mod
from izpi_tpu_torch.materials import tables as mt
from izpi_tpu_torch.ops import bvh_kernel, megakernel, table_grad
from izpi_tpu_torch.texture import tables as tex_tables

ENTRY_FWD = "izpi_diff_trace_fwd"
ENTRY_BWD = "izpi_diff_trace_bwd"
# A record's code, its low CODE_BITS bits (csrc/diff_trace.cu); the texture
# row gathered sits above them.
NONE, MISS, EMIT, SCATTER, REFRACT = 0, 1, 2, 3, 4
CODE_BITS = 3
REC_F = 4  # floats a record: thru (3), ratio

# A table of at most this many elements is summed in the reverse's lanes'
# own copies in shared memory (csrc/diff_trace.cu kLaneElems); up to
# table_grad.SHARED_ELEMS in its block's copy, beyond that in device memory.
LANE_ELEMS = 16

# Launches of the forward and the reverse kernel (a reverse's two kernels
# count one), and the sample passes the forward's launches carried.
fwd_launches = 0
bwd_launches = 0
fwd_passes = 0


class DiffScene(NamedTuple):
    """The static tables of an eligible scene as the kernels read them:
    `megakernel.pack_tables`' rows with each material's albedo texture id
    (clamped at 0) in mat_i's fourth column, and the BVH4 (`bvh_kernel.
    KernelScene`) for a scene intersected through it, else None."""

    prim_f: torch.Tensor
    prim_i: torch.Tensor
    mat_f: torch.Tensor
    mat_i: torch.Tensor
    light_f: torch.Tensor
    light_i: torch.Tensor
    bvh: Optional[bvh_kernel.KernelScene]
    n_tex: int
    checker: bool   # a checker reads c1: the stacked table is [c0; c1]


def _scans(intersect, cs) -> Optional[str]:
    """"bvh" for the BVH4 kernel's intersector over `cs`'s primitives,
    "brute" for brute force over them, else None (the parameters a step
    injects leave the primitives the same tensors)."""
    if isinstance(intersect, bvh_kernel.BVHKernelIntersector):
        return "bvh" if intersect.cs.prims is cs.prims else None
    brute = getattr(intersect, "brute_cs", None)
    return "brute" if brute is not None and brute.prims is cs.prims else None


def eligible_diff(cs, meta, intersect) -> bool:
    """The fused route takes the scene: the RGB megakernel shades it
    (`megakernel._shaded`: RGB, no media, PBR, image or noise), no
    material is a metal (reads `cs.materials.kind` from the device) and
    no dielectric absorbs, its textures are whole (not sharded), it has a
    light, and its intersector is brute force over `cs`'s primitives
    (`path.make_brute_intersector`) within `megakernel.MAX_PRIMS` of them
    or the BVH4 kernel's (`bvh_kernel.BVHKernelIntersector`, as
    `megakernel.eligible_bvh`)."""
    if not megakernel._shaded(meta) or meta.has_absorbing_dielectric:
        return False
    if meta.tex_shard_group is not None or meta.n_lights < 1:
        return False
    scans = _scans(intersect, cs)
    if not (scans == "bvh" or (scans == "brute"
                               and meta.n_prims <= megakernel.MAX_PRIMS)):
        return False
    return not bool((cs.materials.kind.cpu() == mt.MAT_METAL).any())


def prepare(cs, meta, intersect) -> Optional[DiffScene]:
    """The scene's `DiffScene` where `eligible_diff` holds, else None.
    Reads the device (the material kinds, the camera row): call it on the
    host before a capture."""
    if not eligible_diff(cs, meta, intersect):
        return None
    t = megakernel.pack_tables(cs)
    mat_i = t.mat_i.clone()
    mat_i[:, 3] = torch.clamp(cs.materials.tex_albedo, min=0).to(torch.int32)
    bvh = intersect.ks if _scans(intersect, cs) == "bvh" else None
    return DiffScene(t.prim_f, t.prim_i, t.mat_f, mat_i.contiguous(),
                     t.light_f, t.light_i, bvh, int(cs.textures.c0.shape[0]),
                     bool(meta.has_checker))


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------


def forward_reference(cs, meta, settings, intersect, o, d, time, keys):
    """Plain version of the forward kernel: the differentiable bounce
    (`path.bounce_rgb`, differentiable=True) under no_grad, bounce after
    bounce until every path has ended or max_depth bounces ran, each live
    bounce recorded. Returns (rad (N, 3) before DeNAN, cnt (N,) i32 rays a
    path, rec_f (D, N, 4) f32, rec_i (D, N) i32); a path's records past its
    count are zeros."""
    n, depth_max = o.shape[0], settings.max_depth
    dev = o.device
    thru = torch.ones_like(o)
    rad = torch.zeros_like(o)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    cnt = torch.zeros(n, dtype=torch.int32, device=dev)
    rec_f = torch.zeros((depth_max, n, REC_F), dtype=torch.float32, device=dev)
    rec_i = torch.zeros((depth_max, n), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=o.dtype, device=dev)
    n_tex = cs.textures.c0.shape[0]
    with torch.no_grad():
        for k in range(depth_max):
            if not bool(active.any()):
                break
            live, thru_in, seen = active, thru, {}
            o, d, thru, rad, active, _ = path_mod.bounce_rgb(
                cs, meta, settings, intersect, o, d, time, keys,
                torch.full((n,), k, dtype=torch.int64, device=dev), thru, rad,
                live, differentiable=True, record=seen)
            rec, mat = seen["rec"], seen["mat"]
            kind = mat["kind"]
            is_light = kind == mt.MAT_DIFFUSE_LIGHT
            code = torch.where(
                ~rec.hit, MISS, torch.where(
                    is_light, torch.where(seen["facing"], EMIT, NONE),
                    torch.where(kind == mt.MAT_DIELECTRIC, REFRACT, SCATTER)))
            row = torch.clamp(mat["tex_albedo"], min=0).long()
            if meta.has_checker:
                p = rec.p
                sines = (torch.sin(10.0 * p[..., 0]) * torch.sin(10.0 * p[..., 1])
                         * torch.sin(10.0 * p[..., 2]))
                c1 = ((cs.textures.kind[row] == tex_tables.TEX_CHECKER)
                      & ~(sines < 0.0))
                row = torch.where(c1, row + n_tex, row)
            row = torch.where((code == EMIT) | (code == SCATTER), row, 0)
            ratio = torch.where(code == SCATTER, seen["ratio"], zero)
            rec_f[k] = torch.where(live[:, None], torch.cat(
                [thru_in, ratio[:, None]], dim=1), zero)
            rec_i[k] = torch.where(live, (row.int() << CODE_BITS) | code.int(),
                                   0)
            cnt = cnt + live.int()
        sentinel = vm.const((0.0, 0.0, 1.0), o)
        rad = rad + torch.where(active[:, None], thru * sentinel[None, :], zero)
    return rad, cnt, rec_f, rec_i


def reverse_reference(rec_f, rec_i, cnt, g_rad, c0, c1, settings,
                      checker: bool):
    """Plain version of the reverse's walk: the records walked back, every
    path at once. Returns (rows (D·N,) int64, g (D·N, 3) f32, count (1,)
    i32): the first count = Σ cnt slots hold the live records, path after
    path and bounce after bounce within a path (row 0 and zeros where
    nothing is gathered); the slots past them are zeros. G
    (`table_grad.table_grad(rows, g, shape, count=count)`) on them gives
    the fused reverse's bits."""
    depth_max, n = rec_i.shape
    dev = g_rad.device
    table = torch.cat([c0, c1]) if checker else c0
    bg = vm.const(settings.background, g_rad)
    zero = torch.zeros((), dtype=g_rad.dtype, device=dev)
    # Past a path's count the records are not read (the kernel leaves them
    # unwritten).
    live = torch.arange(depth_max, device=dev)[:, None] < cnt[None, :]
    code = torch.where(live, rec_i & ((1 << CODE_BITS) - 1), NONE)
    row = torch.where(live, rec_i >> CODE_BITS, 0).long()
    rec_f = torch.where(live[..., None], rec_f, 0.0)
    last = code[torch.clamp(cnt.long() - 1, min=0), torch.arange(n, device=dev)]
    capped = (cnt > 0) & ((last == SCATTER) | (last == REFRACT))
    a = torch.where(capped[:, None], g_rad * vm.const((0.0, 0.0, 1.0), g_rad),
                    zero)
    rows = torch.zeros((depth_max, n), dtype=torch.int64, device=dev)
    g = torch.zeros((depth_max, n, 3), dtype=g_rad.dtype, device=dev)
    for k in reversed(range(depth_max)):
        c, thru, ratio = code[k][:, None], rec_f[k, :, :3], rec_f[k, :, 3:]
        albedo = table[row[k]]
        ga = torch.where(c == EMIT, g_rad * thru,
                         torch.where(c == SCATTER, (a * thru) * ratio, zero))
        a_new = torch.where(
            c == MISS, g_rad * bg, torch.where(
                c == EMIT, g_rad * albedo, torch.where(
                    c == SCATTER, a * (albedo * ratio),
                    torch.where(c == NONE, zero, a))))
        a = torch.where(live[k][:, None], a_new, a)
        rows[k] = row[k]
        g[k] = torch.where(live[k][:, None], ga, zero)
    # The live slots, path after path.
    by_path = live.t()
    total = int(by_path.sum())
    out_rows = torch.zeros((depth_max * n,), dtype=torch.int64, device=dev)
    out_g = torch.zeros((depth_max * n, 3), dtype=g_rad.dtype, device=dev)
    out_rows[:total] = rows.t()[by_path]
    out_g[:total] = g.transpose(0, 1)[by_path]
    count = torch.tensor([total], dtype=torch.int32, device=dev)
    return out_rows, out_g, count


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def forward(scene: DiffScene, cs, meta, settings, intersect, o, d, time,
            keys, passes: int = 1):
    """(rad, cnt, rec_f, rec_i) of the forward kernel (`forward_reference`
    says what each holds; past a path's count the records are not
    written). On a CUDA tensor this launches `izpi_diff_trace_fwd` on the
    current stream; any failure to build or launch raises. On a CPU tensor
    it runs `forward_reference`. `passes`: the sample passes the paths
    hold, which `fwd_passes` counts (each path's outputs are its own
    whatever the launch holds)."""
    dev = o.device
    if dev.type == "cpu":
        return forward_reference(cs, meta, settings, intersect, o, d, time,
                                 keys)
    if dev.type != "cuda":
        raise ValueError(f"diff_trace: unsupported device {dev}")
    out = _launch_fwd(scene, cs, meta, settings, o, d, time, keys)
    global fwd_passes
    fwd_passes += passes
    return out


# Paths a warp of the forward kernel, one a lane (csrc/diff_trace.cu).
WARP_PATHS = 32
# The probe instance's columns, a row a warp (csrc/diff_trace.cu
# ProbeColumn), in the order the kernel writes them.
GROUPS = (1, 2, 4, 8, 16, 32)
PROBE_COLUMNS = ("passes", "cycles_bounce", "cycles_hit", "cycles_draws",
                 "start_ns", "end_ns", *[f"passes_g{g}" for g in GROUPS],
                 *[f"cycles_pass_g{g}" for g in GROUPS])


def probe(scene: DiffScene, cs, meta, settings, o, d, time, keys):
    """The forward kernel's probe instance (`izpi_diff_trace_fwd_probe`, on
    the card only, never on a main path, not counted in `fwd_launches`):
    the outputs of `forward` and a dict of how its warps spent the launch
    (`probe_summary` of its (warps, PROBE_COLUMNS) rows): `lane_use`, the
    paths' bounces over 32 × the warps' bounce passes; `longest_mean`, a warp's
    longest path (its passes) averaged over the warps; the shares of the
    live lanes' cycles in the closest hit, the cipher and the rest of the
    bounce, and `cycles_per_bounce`; `span_us`, the first warp's start to
    the last warp's end, and the warps' ends after that start as shares of
    it (`end_p50`, `end_p90`, `end_max`), so `tail_share` = 1 − end_p50 is
    the share of the launch after half its warps had ended; `start_spread`,
    the last warp's start as a share of it; `passes_by_group`, the shares
    of the passes run at 1, 2, ..., 32 lanes a path, and
    `cycles_per_pass_by_group`, a pass's clock64 cycles at each (ballot to
    ballot; the BVH form, one thread a path, counts no group)."""
    if o.device.type != "cuda":
        raise ValueError("the probe runs the forward kernel on a CUDA device")
    n = o.shape[0]
    rows = torch.zeros((-(-n // WARP_PATHS), len(PROBE_COLUMNS)),
                       dtype=torch.int64, device=o.device)
    out = _launch_fwd(scene, cs, meta, settings, o, d, time, keys, rows)
    return out, probe_summary(rows.cpu(), out[1].cpu())


def probe_summary(rows, cnt) -> dict:
    """The figures of `probe` from its rows and the paths' ray counts."""
    c = {k: rows[:, i] for i, k in enumerate(PROBE_COLUMNS)}
    n = cnt.shape[0]
    longest = torch.nn.functional.pad(cnt, (0, (-n) % WARP_PATHS)).view(
        -1, WARP_PATHS).amax(1)
    passes = int(c["passes"].sum())
    bounce = max(int(c["cycles_bounce"].sum()), 1)
    hit, draws = int(c["cycles_hit"].sum()), int(c["cycles_draws"].sum())
    start = int(c["start_ns"].min())
    span = max(int(c["end_ns"].max()) - start, 1)
    ends = (c["end_ns"] - start).double() / span
    by_group = [int(c[f"passes_g{g}"].sum()) for g in GROUPS]
    return dict(
        passes=passes, bounces=int(cnt.sum()),
        passes_equal_longest=bool(torch.equal(c["passes"], longest.long())),
        lane_use=int(cnt.sum()) / max(32 * passes, 1),
        longest_mean=float(longest.double().mean()),
        share_hit=hit / bounce, share_draws=draws / bounce,
        share_rest=1.0 - (hit + draws) / bounce,
        cycles_per_bounce=bounce / max(int(cnt.sum()), 1),
        span_us=span / 1e3, end_p50=float(ends.quantile(0.5)),
        end_p90=float(ends.quantile(0.9)), end_max=float(ends.max()),
        tail_share=1.0 - float(ends.quantile(0.5)),
        start_spread=int(c["start_ns"].max() - start) / span,
        passes_by_group={g: k / max(sum(by_group), 1)
                         for g, k in zip(GROUPS, by_group)},
        cycles_per_pass_by_group={
            g: int(c[f"cycles_pass_g{g}"].sum()) / max(k, 1)
            for g, k in zip(GROUPS, by_group)})


def _launch_fwd(scene: DiffScene, cs, meta, settings, o, d, time, keys,
                probe_rows=None):
    """`forward` on a CUDA device; with `probe_rows` (a zeroed int64 tensor
    of (warps, PROBE_COLUMNS)), the probe instance, counted apart."""
    dev = o.device
    n, depth_max = o.shape[0], int(settings.max_depth)
    c0, c1 = cs.textures.c0, cs.textures.c1
    tables = [("prim_f", scene.prim_f, (meta.n_prims, megakernel.PRIM_F),
               torch.float32),
              ("prim_i", scene.prim_i, (meta.n_prims, megakernel.PRIM_I),
               torch.int32),
              ("mat_f", scene.mat_f, (meta.n_materials, megakernel.MAT_F),
               torch.float32),
              ("mat_i", scene.mat_i, (meta.n_materials, megakernel.MAT_I),
               torch.int32),
              ("light_f", scene.light_f, (meta.n_lights, megakernel.LIGHT_F),
               torch.float32),
              ("light_i", scene.light_i, (meta.n_lights,), torch.int32),
              ("c0", c0, (scene.n_tex, 3), torch.float32),
              ("c1", c1, (scene.n_tex, 3), torch.float32),
              ("o", o, (n, 3), torch.float32), ("d", d, (n, 3), torch.float32),
              ("time", time, (n,), torch.float32),
              ("keys", keys, (n, 2), torch.int64)]
    bvh = scene.bvh
    if bvh is not None:
        tables += [("nodes", bvh.nodes, (bvh.nodes.shape[0],
                                         bvh_kernel.NODE_WORDS), torch.int32),
                   ("prim_table", bvh.prim_table,
                    (meta.n_prims, bvh_kernel.PRIM_WORDS), torch.float32)]
    megakernel.check_tables(dev, tables)
    from izpi_tpu_torch.ops import _build

    lib = _build.load()
    rad = torch.empty((n, 3), dtype=torch.float32, device=dev)
    cnt = torch.empty((n,), dtype=torch.int32, device=dev)
    rec_f = torch.empty((depth_max, n, REC_F), dtype=torch.float32,
                        device=dev)
    rec_i = torch.empty((depth_max, n), dtype=torch.int32, device=dev)
    bg = [float(x) for x in settings.background]
    args = (_ptr(scene.prim_f), _ptr(scene.prim_i), meta.n_prims,
            _ptr(scene.mat_f), _ptr(scene.mat_i), _ptr(scene.light_f),
            _ptr(scene.light_i), meta.n_lights,
            _ptr(None if bvh is None else bvh.nodes),
            _ptr(None if bvh is None else bvh.prim_table), _ptr(c0), _ptr(c1),
            scene.n_tex, _ptr(o), _ptr(d), _ptr(time), _ptr(keys), n,
            depth_max, bg[0], bg[1], bg[2],
            int(bool(settings.exact_book_cosine)), _ptr(rad), _ptr(cnt),
            _ptr(rec_f), _ptr(rec_i))
    entry = ENTRY_FWD if probe_rows is None else ENTRY_FWD + "_probe"
    with torch.cuda.device(dev):
        if probe_rows is None:
            err = lib.izpi_diff_trace_fwd(*args, _stream(dev))
        else:
            megakernel.check_tables(dev, [
                ("probe", probe_rows, (-(-n // WARP_PATHS),
                                       len(PROBE_COLUMNS)), torch.int64)])
            err = lib.izpi_diff_trace_fwd_probe(*args, _ptr(probe_rows),
                                                _stream(dev))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    if probe_rows is None:
        global fwd_launches
        fwd_launches += 1
    return rad, cnt, rec_f, rec_i


def add_path(n_rows: int) -> str:
    """Where the reverse's second pass sums a table of n_rows rows of 3:
    "lane", "block" or "global" (csrc/diff_trace.cu add_path)."""
    elems = 3 * n_rows
    if elems <= LANE_ELEMS:
        return "lane"
    return "block" if elems <= table_grad.SHARED_ELEMS else "global"


def reverse(scene: DiffScene, rec_f, rec_i, cnt, g_rad, c0, c1, settings,
            passes: int = 1):
    """The gradients (passes, n_rows, 3) f32 of the stacked [c0; c1]
    table's first n_rows rows (c0's alone where no texture is a checker)
    from the forward's records and the radiance's cotangent g_rad, one a
    sample pass (pass s: the paths [s·N, (s+1)·N) of the n = passes·N):
    each record's albedo cotangent (`reverse_reference`'s slots) summed at
    its row as G sums a pass's (`table_grad`: the same bits). On a CUDA
    tensor this launches `izpi_diff_trace_bwd` on the current stream (two
    launches for every pass, the first keeping each record's cotangent for
    the second in the record's place: it overwrites rec_f), or raises; on
    a CPU tensor it runs `reverse_reference` and then
    `table_grad.table_grad_reference` on each pass's counted slots."""
    n_rows = scene.n_tex * (2 if scene.checker else 1)
    dev = g_rad.device
    depth_max, n = rec_i.shape
    if passes < 1 or n % passes:
        raise ValueError(f"diff_trace: {n} paths in {passes} passes")
    n_pass = n // passes
    if dev.type == "cpu":
        out = []
        for s in range(passes):
            own = slice(s * n_pass, (s + 1) * n_pass)
            rows, g, count = reverse_reference(
                rec_f[:, own], rec_i[:, own], cnt[own], g_rad[own], c0, c1,
                settings, scene.checker)
            live = int(count.reshape(()))
            out.append(table_grad.table_grad_reference(
                rows[:live], g[:live], (n_rows, 3)))
        return torch.stack(out)
    if dev.type != "cuda":
        raise ValueError(f"diff_trace: unsupported device {dev}")
    megakernel.check_tables(dev, [
        ("rec_f", rec_f, (depth_max, n, REC_F), torch.float32),
        ("rec_i", rec_i, (depth_max, n), torch.int32),
        ("cnt", cnt, (n,), torch.int32),
        ("g_rad", g_rad, (n, 3), torch.float32),
        ("c0", c0, (scene.n_tex, 3), torch.float32),
        ("c1", c1, (scene.n_tex, 3), torch.float32)])
    from izpi_tpu_torch.ops import _build

    lib = _build.load()
    scratch = torch.empty(((lib.izpi_diff_trace_bwd_scratch(n, n_pass, n_rows)
                            + 7) // 8,), dtype=torch.int64, device=dev)
    out = torch.empty((passes, n_rows, 3), dtype=torch.float32, device=dev)
    bg = [float(x) for x in settings.background]
    with torch.cuda.device(dev):
        err = lib.izpi_diff_trace_bwd(
            _ptr(rec_f), _ptr(rec_i), _ptr(cnt), _ptr(g_rad), _ptr(c0),
            _ptr(c1), scene.n_tex, n, n_pass, depth_max, bg[0], bg[1], bg[2],
            n_rows, _ptr(scratch), _ptr(out), _stream(dev))
    if err != 0:
        raise RuntimeError(f"{ENTRY_BWD} launch failed: CUDA error {err}")
    global bwd_launches
    bwd_launches += 1
    return out


class DiffTrace(torch.autograd.Function):
    """(rad, rays) of `path.trace(..., differentiable=True)` on an eligible
    scene, differentiable in the texture colours c0 and c1: one launch of
    the forward kernel over every sample pass's paths, then in the
    backward one call of the reverse, which sums the stacked [c0; c1]
    rows' gradient (c0's alone where no texture is a checker) itself, a
    table a pass. The passes' tables are added last pass first, as
    autograd added the gradients of one call a pass (the last call's
    backward runs first), so the sum has those bits. The other tables get
    no gradient. The reverse keeps its cotangents in the records' memory,
    so the graph's backward runs once (a second raises, as after a
    version change of a saved tensor)."""

    @staticmethod
    def forward(ctx, args, o, d, time, keys, c0, c1):
        scene, cs, meta, settings, intersect, passes = args
        rad, cnt, rec_f, rec_i = forward(scene, cs, meta, settings, intersect,
                                         o, d, time, keys, passes)
        ctx.save_for_backward(rec_f, rec_i, cnt, c0, c1)
        ctx.scene, ctx.settings, ctx.passes = scene, settings, passes
        rays = cnt.sum(dtype=torch.int64)
        ctx.mark_non_differentiable(rays)
        return rad, rays

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_rad, _g_rays):
        rec_f, rec_i, cnt, c0, c1 = ctx.saved_tensors
        scene = ctx.scene
        tables = reverse(scene, rec_f, rec_i, cnt, g_rad.contiguous(), c0, c1,
                         ctx.settings, ctx.passes)
        torch.autograd.graph.increment_version(rec_f)
        grad = tables[-1]
        for s in reversed(range(ctx.passes - 1)):
            grad = grad + tables[s]
        g0 = grad[:scene.n_tex]
        g1 = grad[scene.n_tex:] if scene.checker else None
        return None, None, None, None, None, g0, g1


def trace(scene: DiffScene, cs, meta, settings, intersect, o, d, time, keys,
          passes: int = 1):
    """`path.trace(..., differentiable=True)`'s (rad (N, 3) not DeNAN'd,
    rays as a 0-dim int64 tensor) through `DiffTrace`; `passes` sample
    passes of N / passes paths each, pass after pass."""
    return DiffTrace.apply((scene, cs, meta, settings, intersect, passes),
                           o.contiguous(), d.contiguous(), time.contiguous(),
                           keys.contiguous(), cs.textures.c0, cs.textures.c1)
