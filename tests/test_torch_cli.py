"""`python -m izpi_tpu_torch` (izpi_tpu_torch.cli) vs the JAX package's
CLI (izpi_tpu/cli.py), and the binary `.izpi` scene decoder
(scene/izpi_binary.py)."""

import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from izpi_tpu import cli as jcli
from izpi_tpu.scene import izpi_binary as jbin
from izpi_tpu.scene import pbtxt as jpbtxt
from izpi_tpu_torch import cli as tcli
from izpi_tpu_torch.io import output as toutput
from izpi_tpu_torch.scene import izpi_binary as tbin
from izpi_tpu_torch.scene import pbtxt as tpbtxt

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "-x", "8", "-y", "6", "--samples", "2",
         "--max-depth", "3"]


def _options(parser):
    return {a.dest: (sorted(a.option_strings), a.default,
                     tuple(a.choices) if a.choices else None)
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    """Every JAX option with its strings, default and choices; the port
    adds --device (default "cuda") and nothing else."""
    got, want = _options(tcli.build_parser()), _options(jcli.build_parser())
    assert got.pop("device") == (["--device"], "cuda", None)
    assert got == want
    args = tcli.build_parser().parse_args([])
    assert (args.scene, args.x, args.y, args.samples, args.sampler,
            args.max_depth, args.output_file) == (
        "cornell_box_pyramid_spectral", 500, 500, 1000, "spectral", 50,
        "output.png")


@pytest.mark.parametrize("extra,mode", [
    ([], "png"),
    (["--output-mode", "exr"], "exr"),
    (["--scene", "cornell_box", "--sampler", "colour", "--output-mode",
      "pfm"], "pfm"),
    (["--scene", "cornell_box", "--sampler", "normal", "--output-mode",
      "hdr"], "hdr"),
])
def test_main_writes_a_readable_file(tmp_path, capsys, extra, mode):
    out = str(tmp_path / f"o.{mode}")
    assert tcli.main(SMALL + extra + ["--output-file", out]) == 0
    img = toutput.read_image(out)
    assert img.shape == (6, 8, 3) and np.isfinite(img).all()
    assert img.max() > 0
    assert "Rendering completed" in capsys.readouterr().out


def test_exr_of_a_spectral_render_is_aces(tmp_path):
    """The default pyramid (spectral) writes ACEScg, so its EXR carries the
    ACES chromaticities; a colour render's does not."""
    a, b = tmp_path / "a.exr", tmp_path / "b.exr"
    tcli.main(SMALL + ["--output-mode", "exr", "--output-file", str(a)])
    tcli.main(SMALL + ["--scene", "cornell_box", "--sampler", "colour",
                       "--output-mode", "exr", "--output-file", str(b)])
    assert b"chromaticities" in a.read_bytes()
    assert b"chromaticities" not in b.read_bytes()


def test_checkpoint_and_profile_flags(tmp_path):
    """--checkpoint with an interval writes the checkpoint; --profile-dir
    writes a torch.profiler trace; --preview writes the preview."""
    out, ckpt = tmp_path / "c.png", tmp_path / "c.npz"
    prof, prev = tmp_path / "prof", tmp_path / "prev.png"
    assert tcli.main(SMALL + ["--samples", "4", "--checkpoint", str(ckpt),
                              "--checkpoint-interval", "2", "--profile-dir",
                              str(prof), "--preview", str(prev),
                              "--output-file", str(out)]) == 0
    with np.load(ckpt) as z:
        assert int(z["samples_done"]) == 4
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
    assert toutput.read_image(str(prev)).shape == (6, 8, 3)


@pytest.mark.parametrize("flags", [
    ["--role", "leader"], ["--role", "worker"],
    ["--coordinator", "localhost:1234"], ["--num-processes", "2"],
    ["--process-id", "1"], ["--shard-prims"], ["--num-workers", "2"]])
def test_multihost_flags_without_role_render_standalone_a15(
        flags, tmp_path, monkeypatch, capsys):
    """Multi-host rendering is ported. --role alone decides, as in the JAX
    CLI (izpi_tpu/cli.py:95): a role without a coordinator or torchrun's
    environment exits before any render naming --coordinator; any other
    flag of it without --role renders standalone, with one warning on
    stderr that names the flag."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    out = tmp_path / "x.png"
    argv = SMALL + flags + ["--output-file", str(out)]
    if flags[0] == "--role":
        with pytest.raises(SystemExit, match="--coordinator"):
            tcli.main(argv)
        assert not out.exists()
        return
    assert tcli.main(argv) == 0
    assert toutput.read_image(str(out)).shape == (6, 8, 3)
    err = capsys.readouterr().err
    warnings = [line for line in err.splitlines() if "warning" in line]
    assert len(warnings) == 1 and flags[0] in warnings[0]
    assert "--role leader or --role worker" in warnings[0]


def test_bare_host_worker_needs_a_rank(tmp_path, monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(SystemExit, match="--process-id"):
        tcli.main(SMALL + ["--role", "worker", "--coordinator",
                           "127.0.0.1:1", "--num-processes", "2",
                           "--output-file", str(tmp_path / "x.png")])


def test_cuda_without_a_card_fails(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'cuda' requested"):
        tcli.main(["-x", "4", "-y", "4", "--samples", "1", "--output-file",
                   str(tmp_path / "x.png")])


def test_python_dash_m(tmp_path):
    """`python -m izpi_tpu_torch` runs the CLI (importing
    izpi_tpu_torch.__main__ does not)."""
    out = tmp_path / "m.png"
    proc = subprocess.run(
        [sys.executable, "-m", "izpi_tpu_torch", *SMALL, "--scene",
         "cornell_box", "--output-file", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert toutput.read_image(str(out)).shape == (6, 8, 3)


# A minimal protobuf writer for the test's `.izpi` file.
def _varint(n):
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(no, wire, payload):
    tag = _varint(no << 3 | wire)
    if wire == 2:
        return tag + _varint(len(payload)) + payload
    return tag + payload


def _vec3(x, y, z):
    return b"".join(_field(i, 5, struct.pack("<f", v))
                    for i, v in ((1, x), (2, y), (3, z)))


def _izpi_scene() -> bytes:
    def f32(x):
        return struct.pack("<f", x)

    def constant(r, g, b):   # a Texture of type CONSTANT
        return _field(2, 0, _varint(1)) + _field(
            3, 2, _field(1, 2, _vec3(r, g, b)))

    camera = (_field(1, 2, _vec3(0, 1, -6)) + _field(2, 2, _vec3(0, 0.5, 0))
              + _field(3, 2, _vec3(0, 1, 0)) + _field(4, 5, f32(40))
              + _field(5, 5, f32(1.0)))
    lambert = (_field(1, 2, b"red") + _field(2, 0, _varint(4))  # LAMBERT
               + _field(6, 2, _field(1, 2, constant(0.8, 0.3, 0.2))))
    light = (_field(1, 2, b"lamp") + _field(2, 0, _varint(2))   # DIFFUSE_LIGHT
             + _field(4, 2, _field(1, 2, constant(6, 6, 6))))
    sphere = (_field(1, 2, _vec3(0, 0.5, 0)) + _field(2, 5, f32(0.5))
              + _field(3, 2, b"red"))
    lamp = (_field(1, 2, _vec3(0, 3, 0)) + _field(2, 5, f32(0.7))
            + _field(3, 2, b"lamp"))
    tri = (_field(1, 2, _vec3(-3, 0, -3)) + _field(2, 2, _vec3(3, 0, -3))
           + _field(3, 2, _vec3(0, 0, 3)) + _field(10, 2, b"red"))
    objects = (_field(2, 2, sphere) + _field(2, 2, lamp) + _field(1, 2, tri))
    return (_field(1, 2, b"t") + _field(3, 0, _varint(1))       # RGB
            + _field(4, 2, camera)
            + _field(5, 2, _field(1, 2, b"red") + _field(2, 2, lambert))
            + _field(5, 2, _field(1, 2, b"lamp") + _field(2, 2, light))
            + _field(8, 2, objects))


def test_izpi_scene_decodes_to_the_jax_tree(tmp_path):
    """A binary scene (a sphere, a lamp and a triangle) decodes to the JAX
    decoder's tree and loads to the same scene description; the CLI
    renders it."""
    path = tmp_path / "s.izpi"
    path.write_bytes(_izpi_scene())
    got, want = tbin.load_tree(str(path)), jbin.load_tree(str(path))
    assert got == want
    assert len(got["objects"]["spheres"]) == 2
    assert repr(tpbtxt.load_scene(str(path))) == repr(
        jpbtxt.load_scene(str(path)))
    out = tmp_path / "s.png"
    assert tcli.main(SMALL + ["--scene", str(path), "--sampler", "colour",
                              "--output-file", str(out)]) == 0
    assert toutput.read_image(str(out)).max() > 0
