"""Flat texture table + batched RGB evaluation.

Counterpart of `izpi_tpu/texture/tables.py:26-125`. All textures in a scene
are one SoA table and evaluation is tagged selects over the whole ray batch.
Image textures live in one zero-padded (I, maxH, maxW, 3) stack so a lookup
is one gather; PBR materials' image maps are also baked by the compiler into
one (Ic, maxH, maxW, 8) combined stack (albedo.rgb, normal.xyz, mean
roughness, mean metalness), read once per bounce
(`integrator.path._eval_pbr_texs`).

Texture-sharded mode (`parallel.dist.make_sharded_textures`, the JAX
package's `shard_axis`): `images` and `combined` hold one rank's slice of
the stacks, `img_base` and `combo_base` the slice's first global row, and
`eval_rgb(..., shard_group=group)` looks up the ids the rank owns and
all-reduces the masked values over the group. The per-texture metadata
(`img_w`, `img_h`, `combo_w`, `combo_h`) stays whole on every rank.

Kinds: 0 CONSTANT, 1 CHECKER (two constant children), 2 IMAGE, 3 NOISE.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from izpi_tpu_torch.ops import table_grad
from izpi_tpu_torch.texture import perlin as perlin_mod

TEX_CONSTANT = 0
TEX_CHECKER = 1
TEX_IMAGE = 2
TEX_NOISE = 3


class Textures(NamedTuple):
    kind: torch.Tensor    # (T,) int32
    c0: torch.Tensor      # (T, 3) f32 const color / checker odd
    c1: torch.Tensor      # (T, 3) f32 checker even
    scale: torch.Tensor   # (T,) f32 noise scale
    img_id: torch.Tensor  # (T,) int32, -1 if not an image
    images: torch.Tensor  # (I, maxH, maxW, 3) f32 (I >= 1; a dummy if unused)
    img_w: torch.Tensor   # (I,) int32
    img_h: torch.Tensor   # (I,) int32
    perlin: perlin_mod.PerlinTables
    combined: torch.Tensor  # (Ic, maxH, maxW, 8) f32; (0, 1, 1, 8) if none
    combo_w: torch.Tensor   # (Ic,) int32
    combo_h: torch.Tensor   # (Ic,) int32
    # Texture-sharded mode: the global row of this rank's first image and
    # combined row (0-dim int tensors); None with whole stacks.
    img_base: object = None
    combo_base: object = None


def texel_index(x, n):
    """int32(x) truncated toward zero, clipped to [0, n - 1]: the reference's
    index math (texture/image.go:73-101) as XLA converts, which saturates
    out-of-range values and sends NaN to 0 (a plain cast to int in torch
    leaves those undefined). x: (N,) f32; n: (N,) int."""
    safe = torch.nan_to_num(x, nan=0.0).clamp(-1.0, 2.0 ** 30)
    return torch.minimum(torch.clamp(safe.to(torch.int32), min=0),
                         torch.clamp(n - 1, min=0))


def image_lookup(images, img_w, img_h, img_id, u, v, local_id=None):
    """Nearest neighbour with the V flip, the reference's index math:
    i = int(u·W), j = int((1 - v)·(H - 0.001)), clamped. local_id
    (texture-sharded mode) indexes the rank's slice of `images`, while
    img_id still indexes the whole metadata tables."""
    w = img_w[img_id]
    h = img_h[img_id]
    i = texel_index(u * w.float(), w)
    j = texel_index((1.0 - v) * (h.float() - 0.001), h)
    return table_grad.gather(images, img_id if local_id is None else local_id,
                             j.long(), i.long())


def sharded_rows(stack, base, row_id, index, group):
    """Rows `stack[row_id - base][index]` of a stack sharded over `group`
    (tables.py:99-114, path.py:302-311): each rank reads the ids its slice
    holds, sends zero for the others, and one all-reduce sums them, so
    every rank gets every row. `index(local_row)` gathers the values of
    the clamped local row ids."""
    local = row_id - base
    n_loc = stack.shape[0]
    owned = (local >= 0) & (local < n_loc)
    val = index(torch.clamp(local, 0, max(n_loc - 1, 0)))
    val = torch.where(owned[..., None], val, torch.zeros_like(val))
    dist.all_reduce(val, op=dist.ReduceOp.SUM, group=group)
    return val


def eval_rgb(tex: Textures, tex_id, u, v, p, has_checker: bool = True,
             has_image: bool = True, has_noise: bool = True,
             shard_group=None):
    """Evaluate RGB textures for a ray batch.

    tex_id: (N,) int (a negative id reads texture 0, as in the JAX
    package); u, v: (N,); p: (N, 3). Returns (N, 3). The has_* flags are
    the scene's static facts (SceneMeta): a kind the scene lacks is not
    evaluated. shard_group (the JAX package's shard_axis) is the process
    group over which the image stack is sharded (`tex` then holds one
    rank's slice, from `img_base` on), or None for a whole stack; every
    rank of the group must make the same calls."""
    tid = torch.clamp(tex_id, min=0).long()
    kind = tex.kind[tid]
    c0 = table_grad.gather(tex.c0, tid)
    out = c0
    if has_checker:
        # CHECKER: sign of sin(10x)sin(10y)sin(10z) picks odd/even
        # (texture/checker.go:26).
        c1 = table_grad.gather(tex.c1, tid)
        sines = (torch.sin(10.0 * p[..., 0]) * torch.sin(10.0 * p[..., 1])
                 * torch.sin(10.0 * p[..., 2]))
        checker = torch.where((sines < 0.0)[..., None], c0, c1)
        out = torch.where((kind == TEX_CHECKER)[..., None], checker, out)
    if has_image:
        gid = torch.clamp(tex.img_id[tid], min=0).long()
        if shard_group is None:
            img = image_lookup(tex.images, tex.img_w, tex.img_h, gid, u, v)
        else:
            img = sharded_rows(
                tex.images, tex.img_base, gid,
                lambda loc: image_lookup(tex.images, tex.img_w, tex.img_h,
                                         gid, u, v, local_id=loc),
                shard_group)
        out = torch.where((kind == TEX_IMAGE)[..., None], img, out)
    if has_noise:
        # NOISE marble: 0.5·(1 + sin(scale·z + 10·turb(p)))
        # (texture/noise.go:27).
        t = perlin_mod.turb(tex.perlin, p, 7)
        marble = 0.5 * (1.0 + torch.sin(tex.scale[tid] * p[..., 2] + 10.0 * t))
        out = torch.where((kind == TEX_NOISE)[..., None],
                          marble[..., None].expand_as(c0), out)
    return out
