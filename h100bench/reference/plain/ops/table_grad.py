"""Gathers from the trainable tables (frozen plain copy).

The port routes a gather's backward through its own fixed-point kernel; the
reference keeps PyTorch's own indexing and its backward (`index_put_` with
accumulate), the plain version that kernel is held to."""

from __future__ import annotations


def gather(table, *index):
    """`table[index]` (index: integer tensors, one per leading dimension
    indexed), differentiable in `table` by PyTorch's own backward."""
    return table[index]
