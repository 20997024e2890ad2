"""Orthonormal basis from a normal, batched.

Counterpart of `izpi_tpu/core/onb.py`. Reference: internal/onb/onb.go
`BuildFromW` (onb.go:38); the branch `|w.x| > 0.9 ? (0,1,0) : (1,0,0)`
becomes a select.
"""

from __future__ import annotations

import torch

from h100bench.reference.plain.core import vecmath as vm


def build_from_w(n):
    """Return (u, v, w), each shaped like n: w = normalize(n),
    v = normalize(w × a), u = w × v (onb.go:41-46)."""
    w = vm.normalize(n)
    big_x = (torch.abs(w[..., 0]) > 0.9)[..., None]
    a = torch.where(big_x, vm.const((0.0, 1.0, 0.0), w),
                    vm.const((1.0, 0.0, 0.0), w))
    v = vm.normalize(vm.cross(w, a))
    u = vm.cross(w, v)
    return u, v, w


def local(u, v, w, a):
    """a.x*u + a.y*v + a.z*w  (onb.go:63)."""
    return a[..., 0:1] * u + a[..., 1:2] * v + a[..., 2:3] * w
