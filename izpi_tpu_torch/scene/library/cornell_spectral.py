"""Spectral Cornell box, with or without the dispersive glass pyramid.

Counterpart of `izpi_tpu/scene/library/cornell_spectral.py:18-88`, value
for value, plus `cornell_box_pyramid_spectral` (the registry entry of
`izpi_tpu/scene/library/__init__.py:17-19`), the reference's default
workload and `bench.py`'s `spectral_pyramid` configuration.

Modeled on the reference's CornellBoxSpectral proto scene
(internal/scenes/scenes.go:1380-1830): a 100³ box, neutral-0.73 white walls,
Gaussian green (peak .9 @540nm, width 40) and red (peak .9 @640nm) side
walls, a neutral-15 area light, black tabulated spectral background, camera
at (50,50,-140) with vfov 40.
"""

from __future__ import annotations

import numpy as np

from izpi_tpu_torch.scene import types as st
from izpi_tpu_torch.spectral import spd as spd_mod


def _prism_mesh(material: st.Material, apex, half_base: float,
                height: float) -> st.TriangleMesh:
    """A 4-sided glass pyramid (apex over a square base) as a triangle mesh —
    the dispersion showcase geometry (transparent-pyramid scene family)."""
    ax, ay, az = apex
    y0 = ay - height
    b = half_base
    base = [
        (ax - b, y0, az - b), (ax + b, y0, az - b),
        (ax + b, y0, az + b), (ax - b, y0, az + b),
    ]
    top = (ax, ay, az)
    tris = []
    for i in range(4):
        v0 = base[i]
        v1 = base[(i + 1) % 4]
        tris.append([v0, v1, top])
    # Base (two triangles, facing down).
    tris.append([base[0], base[2], base[1]])
    tris.append([base[0], base[3], base[2]])
    return st.TriangleMesh(vertices=np.array(tris, np.float64),
                           material=material)


def cornell_box_spectral(aspect: float = 1.0,
                         with_prism: bool = False) -> st.Scene:
    white = st.Lambertian(spectral_albedo=st.SpectralNeutral(0.73))
    green = st.Lambertian(
        spectral_albedo=st.SpectralGaussian(peak=0.9, center=540.0, width=40.0))
    red = st.Lambertian(
        spectral_albedo=st.SpectralGaussian(peak=0.9, center=640.0, width=40.0))
    light = st.DiffuseLight(spectral_emit=st.SpectralNeutral(15.0))

    world = [
        st.FlipNormals(st.XYRect(0, 100, 0, 100, 100, white)),   # back
        st.XZRect(0, 100, 0, 100, 0, white),                     # floor
        st.FlipNormals(st.XZRect(0, 100, 0, 100, 100, white)),   # ceiling
        st.FlipNormals(st.YZRect(0, 100, 0, 100, 100, green)),   # left (x=100)
        st.YZRect(0, 100, 0, 100, 0, red),                       # right (x=0)
        st.FlipNormals(st.XZRect(35, 65, 35, 65, 99.5, light)),  # area light
    ]
    if with_prism:
        # Dispersive glass prism built from TRIANGLES like the reference's
        # prism scenes (scenes.go:1831 CornellBoxPrismSpectral) — triangle
        # emitter-members give real light PDFs; a Box would become the
        # reference's null light member (PDF 0, Random=(1,0,0), box.go:57-63)
        # and poison spectral pixels with 0/0 NaNs.
        eta = st.SpectralTabulated(
            wavelengths=tuple(np.arange(380.0, 751.0, 10.0)),
            values=tuple(
                1.60 + 0.04 * ((550.0 / lam) ** 2 - 1.0) + 0.05 *
                (380.0 / lam) ** 4
                for lam in np.arange(380.0, 751.0, 10.0)
            ),
        )
        glass = st.Dielectric(spectral_ref_idx=eta)
        world.append(_prism_mesh(glass, apex=(50.0, 62.0, 50.0),
                                 half_base=16.0, height=30.0))

    camera = st.Camera(
        look_from=(50.0, 50.0, -140.0),
        look_at=(50.0, 50.0, 0.0),
        vfov=40.0,
        aspect=aspect,
        focus_dist=10.0,
    )
    background = spd_mod.SPD(
        np.arange(380.0, 751.0, 10.0), np.zeros(38)
    )
    return st.Scene(world=world, camera=camera, spectral=True,
                    spectral_background=background)


def cornell_box_pyramid_spectral(aspect: float = 1.0) -> st.Scene:
    """The spectral Cornell box with the glass pyramid."""
    return cornell_box_spectral(aspect, with_prism=True)
