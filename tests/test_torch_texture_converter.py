"""izpi_tpu_torch.tools.texture_converter vs the JAX package's
(izpi_tpu/tools/texture_converter.py): the albedo, linear and raw profiles
of a seeded image give the same arrays, and the command line writes the
same EXR from the same PNG (read back with the port's reader; the JAX tool
reads the PNG with PIL, the port with its own decoder)."""

import numpy as np
import pytest

from izpi_tpu.tools import texture_converter as jconv
from izpi_tpu_torch.io import output
from izpi_tpu_torch.tools import texture_converter as tconv

PROFILES = ["albedo", "linear", "raw"]


def _image():
    return np.random.RandomState(7).rand(5, 6, 3).astype(np.float32)


@pytest.mark.parametrize("profile", PROFILES)
def test_convert_equals_jax(profile):
    np.testing.assert_array_equal(tconv.convert(_image(), profile),
                                  jconv.convert(_image(), profile))


@pytest.mark.parametrize("profile", PROFILES)
def test_command_line_equals_jax(profile, tmp_path, capsys):
    src = str(tmp_path / "in.png")
    output.write_png(src, _image())
    assert np.array_equal(output.read_image(src),
                          jconv_read(src))  # both readers: the same texels
    for name, tool in (("port", tconv), ("jax", jconv)):
        assert tool.main(["--data-profile", profile, "--input-file", src,
                          "--output-file", str(tmp_path / f"{name}.exr")]) == 0
    got = output.read_image(str(tmp_path / "port.exr"))
    np.testing.assert_array_equal(got,
                                  output.read_image(str(tmp_path / "jax.exr")))
    np.testing.assert_array_equal(
        got, tconv.convert(output.read_image(src), profile).astype(np.float32))
    assert "wrote" in capsys.readouterr().out


def jconv_read(path):
    from izpi_tpu.io import output as joutput

    return joutput.read_image(path)


def test_unknown_profile_raises():
    with pytest.raises(ValueError, match="unknown data profile"):
        tconv.convert(_image(), "srgb")
