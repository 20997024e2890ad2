"""Texture converter tool.

Parity with cmd/texture_converter/texture_converter.go: converts a texture
to EXR under a data profile —
  albedo: sRGB-decode then convert to ACEScg (oiio.ConvertToACEScg),
  linear: sRGB-decode only (oiio.LineariseSRGB),
  raw:    pass pixel values through unchanged (oiio.Raw).

Run: python -m izpi_tpu_torch.tools.texture_converter --input-file in.png

A copy of `izpi_tpu/tools/texture_converter.py` on the port's image reader
(PNG, EXR, HDR, PFM) and EXR writer (`io.output`), which need neither PIL
nor imageio.
"""

from __future__ import annotations

import argparse

import numpy as np

# sRGB (D65) linear RGB → ACEScg (AP1, via Bradford D65→D60). Standard
# colour-science matrix.
SRGB_TO_ACESCG = np.array([
    [0.6131324224, 0.3395380158, 0.0474166960],
    [0.0701243808, 0.9163940113, 0.0134515240],
    [0.0205876575, 0.1095745716, 0.8697361738],
])


def srgb_decode(img: np.ndarray) -> np.ndarray:
    """Inverse sRGB EOTF."""
    img = np.asarray(img, np.float64)
    return np.where(img <= 0.04045, img / 12.92,
                    ((img + 0.055) / 1.055) ** 2.4)


def convert(img: np.ndarray, profile: str) -> np.ndarray:
    if profile == "raw":
        return np.asarray(img, np.float64)
    if profile == "linear":
        return srgb_decode(img)
    if profile == "albedo":
        return srgb_decode(img) @ SRGB_TO_ACESCG.T
    raise ValueError(f"unknown data profile {profile!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m izpi_tpu_torch.tools.texture_converter",
        description="A tool to convert textures between different data "
                    "profiles")
    p.add_argument("--data-profile", default="albedo",
                   choices=["albedo", "linear", "raw"])
    p.add_argument("--input-file", required=True)
    p.add_argument("--output-file", default="output.exr")
    args = p.parse_args(argv)

    from izpi_tpu_torch.io import output as output_mod

    img = output_mod.read_image(args.input_file)
    out = convert(img, args.data_profile).astype(np.float32)
    output_mod.write_exr(args.output_file, out,
                         aces=args.data_profile == "albedo")
    print(f"wrote {args.output_file} ({args.data_profile})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
