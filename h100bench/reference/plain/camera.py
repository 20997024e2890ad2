"""Thin-lens camera: host-side precompute + batched ray generation.

Counterpart of `izpi_tpu/camera.py:33-82`. Reference: internal/camera/camera.go.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from h100bench.reference.plain.core import rng, sampling
from h100bench.reference.plain.scene import types as st

CAMERA_SALT = 0x5EED  # salt of the camera draw at depth 0


class CameraArrays(NamedTuple):
    origin: torch.Tensor       # (3,)
    lower_left: torch.Tensor   # (3,)
    horizontal: torch.Tensor   # (3,)
    vertical: torch.Tensor     # (3,)
    u: torch.Tensor            # (3,)
    v: torch.Tensor            # (3,)
    lens_radius: torch.Tensor  # ()
    time0: torch.Tensor        # ()
    time1: torch.Tensor        # ()


def compile_camera_host(c: st.Camera) -> dict:
    """The camera frame (camera.go:28-58), on the host in float64."""
    look_from = np.array(c.look_from, dtype=np.float64)
    look_at = np.array(c.look_at, dtype=np.float64)
    vup = np.array(c.vup, dtype=np.float64)

    lens_radius = c.aperture / 2.0
    theta = c.vfov * math.pi / 180.0
    half_height = math.tan(theta / 2.0)
    half_width = c.aspect * half_height
    w = look_from - look_at
    w /= np.linalg.norm(w)
    u = np.cross(vup, w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)

    fd = c.focus_dist
    lower_left = look_from - half_width * fd * u - half_height * fd * v - fd * w
    horizontal = 2.0 * half_width * fd * u
    vertical = 2.0 * half_height * fd * v
    return dict(origin=look_from, lower_left=lower_left, horizontal=horizontal,
                vertical=vertical, u=u, v=v, lens_radius=lens_radius,
                time0=c.time0, time1=c.time1)


def get_rays(cam: CameraArrays, s, t, uniforms):
    """Batched GetRay (camera.go:61-69).

    s, t: (N,) film coordinates in [0,1); uniforms: (N, 3) for the defocus
    disc (2) and shutter time (1). Returns (origin (N,3), dir (N,3), time (N,))."""
    rd = sampling.random_in_unit_disc(uniforms[:, 0], uniforms[:, 1])
    rd = rd * cam.lens_radius
    offset = rd[:, 0:1] * cam.u[None, :] + rd[:, 1:2] * cam.v[None, :]
    time = cam.time0 + uniforms[:, 2] * (cam.time1 - cam.time0)
    origin = cam.origin[None, :] + offset
    direction = (cam.lower_left[None, :]
                 + s[:, None] * cam.horizontal[None, :]
                 + t[:, None] * cam.vertical[None, :]
                 - cam.origin[None, :]
                 - offset)
    return origin, direction, time


def rays_from_uniforms(cam: CameraArrays, u, px, py, nx: int, ny: int):
    """Camera rays through pixels (px, py) from the camera's 5 uniforms u
    (N, 5): film coords (p + ξ) / n, then `get_rays` (renderer.py
    sample_pass, megakernel.py:644-667)."""
    s = (px.float() + u[:, 0]) / nx
    t = (py.float() + u[:, 1]) / ny
    return get_rays(cam, s, t, u[:, 2:5])
