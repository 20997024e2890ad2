"""Gathers from the trainable tables, with a hand-written backward.

The training step differentiates the render in the scene's material,
texture and SPD tables (`parallel.dist.PARAMS`); every read of those tables
is a gather of rows by per-ray indices, and the gradient of a gather is a
scatter-add of the rays' cotangents into the table. PyTorch's own (the
backward of indexing, `index_put_` with accumulate: a sort by row and a
segment sum) took most of the eager step's device time.

- `gather(table, *index)`: `table[index]`; where autograd records a table
  that requires grad, through `TableGather`, whose forward is that same
  indexing (the same values, bit for bit) and whose backward is
  `table_grad`.
- `table_grad(rows, g, shape, count=None)`: the table's gradient, `g`
  (N, C) added at the flat rows `rows` (N,) of a table viewed as (R, C),
  or at its first `count` rows where a producer counted them on the
  device (`ops.diff_trace.reverse_reference`'s slots). On a CUDA tensor
  it launches `csrc/table_grad.cu` (`izpi_table_grad`: a deterministic
  scatter-add in 64-bit fixed point, see the source) on the current stream
  or raises; on a CPU tensor it runs `table_grad_reference`, the backward
  PyTorch's indexing has.

The kernel replaces no Pallas kernel: the JAX package leaves this scatter
to XLA (the backward of jnp indexing under `jax.value_and_grad`).
"""

from __future__ import annotations

import ctypes
import math

import torch

# Launches of `izpi_table_grad` made by `table_grad`.
launches = 0
# A table of at most this many elements takes the kernel's shared-memory
# path (csrc/table_grad.cu kSharedElems), a larger one the device-memory
# path.
SHARED_ELEMS = 4096


def path_for(shape) -> str:
    """The kernel's path for a table of `shape`: "shared" or "global"."""
    return "shared" if math.prod(shape) <= SHARED_ELEMS else "global"


def flat_rows(shape, index) -> torch.Tensor:
    """The flat row ids (int64, broadcast over the index tensors) that
    `table[index]` reads from a table of `shape` viewed as (R, C), R the
    product of the leading len(index) dimensions; negative ids count from
    the end, as indexing does."""
    index = torch.broadcast_tensors(*index)
    rows = None
    for i, dim in zip(index, shape):
        i = i.long()
        i = torch.where(i < 0, i + dim, i)
        rows = i if rows is None else rows * dim + i
    return rows


def table_grad_reference(rows, g, shape):
    """Plain version of `table_grad`: the backward PyTorch's indexing has
    (zeros, then `index_put_` with accumulate), through the flat rows."""
    c = g.shape[1]
    out = torch.zeros((math.prod(shape) // c, c), dtype=g.dtype,
                      device=g.device)
    return out.index_put_((rows,), g, accumulate=True).reshape(shape)


def _check(name, t, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"table_grad: {name} is on {t.device}, not {dev}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or (
            not t.is_contiguous()):
        raise ValueError(f"table_grad: {name} must be a contiguous {dtype} "
                         f"tensor of shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")


def table_grad(rows, g, shape, count=None):
    """The gradient of a float32 table of `shape`, viewed as (R, C) with C =
    g.shape[1]: g (N, C) added at rows (N,) int64 in [0, R); where `count`
    (a one-element int32 tensor on g's device) is given, only the first
    count of them add, and the rest are never read. On a CUDA tensor this
    launches `izpi_table_grad`, which reads the count on the device; on a
    CPU tensor it runs `table_grad_reference`."""
    dev = g.device
    if dev.type == "cpu":
        if count is not None:
            live = int(count.reshape(()))
            rows, g = rows[:live], g[:live]
        return table_grad_reference(rows, g, shape)
    if dev.type != "cuda":
        raise ValueError(f"table_grad: unsupported device {dev}")
    n, c = rows.shape[0], g.shape[1]
    n_rows = math.prod(shape) // c
    _check("rows", rows, torch.int64, (n,), dev)
    _check("g", g, torch.float32, (n, c), dev)
    if count is not None:
        _check("count", count, torch.int32, (1,), dev)
    if n_rows * c != math.prod(shape):
        raise ValueError(f"table_grad: rows of {c} do not tile {tuple(shape)}")
    from izpi_tpu_torch.ops import _build

    lib = _build.load()
    scratch = torch.zeros((lib.izpi_table_grad_scratch(n_rows, c) + 7) // 8,
                          dtype=torch.int64, device=dev)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.izpi_table_grad(
            ctypes.c_void_p(rows.data_ptr()), ctypes.c_void_p(g.data_ptr()),
            n, ctypes.c_void_p(None if count is None else count.data_ptr()),
            c, n_rows, ctypes.c_void_p(scratch.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"izpi_table_grad launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out


class TableGather(torch.autograd.Function):
    """`table[index]`, whose backward is `table_grad` (the kernel on the
    card): the cotangents of the gathered rows added into the table."""

    @staticmethod
    def forward(ctx, table, *index):
        ctx.save_for_backward(*index)
        ctx.shape = table.shape
        return table[index]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        index = ctx.saved_tensors
        rows = flat_rows(ctx.shape, index).reshape(-1)
        c = math.prod(ctx.shape[len(index):])
        grad = table_grad(rows.contiguous(),
                          g.reshape(rows.shape[0], c).contiguous(), ctx.shape)
        return (grad, *([None] * len(index)))


def gather(table, *index):
    """`table[index]` (index: integer tensors, one per leading dimension
    indexed); through `TableGather` where autograd records the gather of a
    table that requires grad."""
    if table.requires_grad and torch.is_grad_enabled():
        return TableGather.apply(table, *index)
    return table[index]
