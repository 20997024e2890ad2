"""izpi_tpu_torch.io vs the JAX package's io (izpi_tpu/io/output.py,
postprocess.py): writers, readers and the post-processing filters.

- The EXR, PFM and HDR writers write the JAX writers' bytes.
- The PNG writer is the port's own (zlib and struct; the JAX one calls
  PIL): PIL decodes it to the JAX PNG's pixels.
- The reader decodes what PIL writes (grey, grey and alpha, RGB, RGBA,
  palette), each of PNG's five row filters, both EXR chunk layouts of ZIP
  and the JAX writers' files, to the values written; HDR within its 8-bit
  mantissa. It raises, naming the file, on what it cannot decode.
- postprocess equals JAX's to float64 rounding (rtol 1e-12).
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from izpi_tpu.io import output as joutput
from izpi_tpu.io import postprocess as jpost
from izpi_tpu_torch.io import output as toutput
from izpi_tpu_torch.io import postprocess as tpost


def _image(seed=0, h=5, w=7, scale=4.0):
    return (np.random.RandomState(seed).rand(h, w, 3) * scale).astype(
        np.float32)


@pytest.mark.parametrize("mode,aces", [("exr", False), ("exr", True),
                                       ("pfm", False), ("hdr", False)])
def test_writers_write_the_jax_bytes(tmp_path, mode, aces):
    img = _image(1)
    img[0, 0] = 0.0
    img[1, 2] = (1e-3, 2e3, 7.0)
    toutput.write(str(tmp_path / f"t.{mode}"), img, aces=aces)
    joutput.write(str(tmp_path / f"j.{mode}"), img, aces=aces)
    assert (tmp_path / f"t.{mode}").read_bytes() == \
        (tmp_path / f"j.{mode}").read_bytes()


def test_png_decodes_to_the_jax_png(tmp_path):
    """The port's PNG (gamma 2, clamp, int(x·255 + 0.5)) and the JAX one
    (PIL) decode under PIL to the same pixels; values over 1 and under 0
    clamp."""
    img = _image(2, 9, 11, scale=1.5) - 0.2
    toutput.write_png(str(tmp_path / "t.png"), img)
    joutput.write_png(str(tmp_path / "j.png"), img)
    got = np.asarray(Image.open(tmp_path / "t.png"))
    want = np.asarray(Image.open(tmp_path / "j.png"))
    assert got.shape == (9, 11, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        toutput.read_image(str(tmp_path / "t.png")), got / np.float32(255.0))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "P4", "1"])
def test_reader_decodes_pil_pngs(tmp_path, mode):
    """PNGs PIL writes in each colour type read to JAX's read_image values
    (PIL's convert("RGB"): alpha dropped, grey broadcast, palette looked
    up), raw over 255 with no sRGB decode. "P" has 256 colours, "P4" 16
    (PIL packs them 4 bits a pixel), "1" is 1-bit grey."""
    rs = np.random.RandomState(3)
    rgb = Image.fromarray(rs.randint(0, 256, (13, 10, 3)).astype(np.uint8))
    if mode == "P":
        im = rgb.quantize(256)
    elif mode == "P4":
        im = rgb.quantize(16)
    else:
        im = rgb.convert(mode)
    im.save(tmp_path / "x.png")
    got = toutput.read_image(str(tmp_path / "x.png"))
    want = joutput.read_image(str(tmp_path / "x.png"))
    assert got.dtype == np.float32 and got.shape == (13, 10, 3)
    np.testing.assert_array_equal(got, want)


def _png_with_filter(px: np.ndarray, ftype: int) -> bytes:
    """An 8-bit RGB PNG whose every row uses filter `ftype` (0-4)."""
    h, w, _ = px.shape
    rows = px.reshape(h, w * 3).astype(np.int64)
    out = []
    prior = np.zeros(w * 3, np.int64)
    for y in range(h):
        line = rows[y]
        left = np.concatenate([np.zeros(3, np.int64), line[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int64), prior[:-3]])
        if ftype == 0:
            pred = np.zeros_like(line)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prior
        elif ftype == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prior),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        out.append(bytes([ftype]) + ((line - pred) % 256).astype(
            np.uint8).tobytes())
        prior = line

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_reader_undoes_every_png_filter(tmp_path, ftype):
    """Each of the five row filters, checked against PIL's decode."""
    px = np.random.RandomState(ftype).randint(0, 256, (6, 9, 3)).astype(
        np.uint8)
    (tmp_path / "f.png").write_bytes(_png_with_filter(px, ftype))
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "f.png").convert("RGB")), px)
    np.testing.assert_array_equal(toutput.read_image(str(tmp_path / "f.png")),
                                  px / np.float32(255.0))


@pytest.mark.parametrize("mode", ["exr", "pfm"])
def test_float_round_trips(tmp_path, mode):
    """EXR and PFM carry float32 exactly, through the port's and the JAX
    package's readers alike."""
    img = _image(4) - 1.0
    path = str(tmp_path / f"x.{mode}")
    toutput.write(path, img)
    np.testing.assert_array_equal(toutput.read_image(path), img)
    np.testing.assert_array_equal(joutput.read_image(path), img)


def test_hdr_round_trip_and_run_length(tmp_path):
    """HDR: the writer's 8-bit mantissas read back within one step of the
    pixel's brightest channel (a step is 2^-6 of it at most); a new-style
    run-length file of the same pixels reads to the same values."""
    img = _image(5, 4, 12, scale=50.0)
    img[0, :4] = 0.0
    img[1, :6] = img[1, 0]          # a run
    path = str(tmp_path / "x.hdr")
    toutput.write_hdr(path, img)
    got = toutput.read_image(path)
    step = img.max(axis=-1, keepdims=True) * 2.0 ** -6
    assert np.all(np.abs(got - img) <= step)
    assert np.all(got <= img)

    data = (tmp_path / "x.hdr").read_bytes()
    head_end = data.index(b"+X 12\n") + len(b"+X 12\n")
    rgbe = np.frombuffer(data[head_end:], np.uint8).reshape(4, 12, 4)
    rle = bytearray(data[:head_end])
    for row in rgbe:
        rle += bytes([2, 2, 0, 12])
        for c in range(4):
            vals = row[:, c]
            x = 0
            while x < 12:
                n = 1
                while x + n < 12 and n < 127 and vals[x + n] == vals[x]:
                    n += 1
                if n >= 3:
                    rle += bytes([128 + n, vals[x]])
                    x += n
                else:
                    rle += bytes([1, vals[x]])
                    x += 1
    (tmp_path / "r.hdr").write_bytes(bytes(rle))
    np.testing.assert_array_equal(toutput.read_image(str(tmp_path / "r.hdr")),
                                  got)


def _exr_zip16(path, img):
    """A spec-valid ZIP EXR: 16 scanlines a chunk, channels B, G, R."""
    h, w, _ = img.shape

    def attr(name, type_, data):
        return name + b"\0" + type_ + b"\0" + struct.pack("<i", len(data)) + data

    chans = b"".join(n + b"\0" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)
                     for n in (b"B", b"G", b"R")) + b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (attr(b"channels", b"chlist", chans)
              + attr(b"compression", b"compression", b"\x03")
              + attr(b"dataWindow", b"box2i", box)
              + attr(b"displayWindow", b"box2i", box)
              + attr(b"lineOrder", b"lineOrder", b"\x00") + b"\0")
    blocks = []
    for y0 in range(0, h, 16):
        raw = b"".join(img[y, :, c].tobytes() for y in range(y0, min(h, y0 + 16))
                       for c in (2, 1, 0))
        comp = toutput._exr_zip(raw)
        blocks.append(struct.pack("<ii", y0, len(comp)) + comp)
    pos = 8 + len(header) + 8 * len(blocks)
    table = b""
    for b in blocks:
        table += struct.pack("<q", pos)
        pos += len(b)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", 20000630, 2) + header + table
                + b"".join(blocks))


def test_exr_zip_layouts(tmp_path):
    """A spec-valid 16-row ZIP file reads; a file that declares ZIP but
    holds one row a chunk (an earlier JAX writer's) reads line by line,
    told apart by its chunk table, not by its first offset alone; a table
    that fits neither raises."""
    img = _image(6, 37, 5)
    _exr_zip16(str(tmp_path / "z16.exr"), img)
    np.testing.assert_array_equal(toutput.read_image(str(tmp_path / "z16.exr")),
                                  img)
    np.testing.assert_array_equal(joutput.read_image(str(tmp_path / "z16.exr")),
                                  img)

    toutput.write_exr(str(tmp_path / "one.exr"), img)
    data = bytearray((tmp_path / "one.exr").read_bytes())
    at = data.index(b"compression\0compression\0") + len(
        b"compression\0compression\0") + 4
    assert data[at] == 2
    data[at] = 3                                # declare ZIP
    (tmp_path / "legacy.exr").write_bytes(bytes(data))
    np.testing.assert_array_equal(
        toutput.read_image(str(tmp_path / "legacy.exr")), img)

    # The one-row table starts where its first entry points 8·h bytes on.
    h = img.shape[0]
    table = next(p for p in range(at, len(data) - 8)
                 if struct.unpack("<q", data[p:p + 8])[0] == p + 8 * h)
    data[table + 24:table + 32] = struct.pack("<q", len(data) + 100)
    (tmp_path / "broken.exr").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="broken.exr"):
        toutput.read_image(str(tmp_path / "broken.exr"))


def test_reader_raises_naming_the_file(tmp_path):
    """A JPEG, a 16-bit PNG and a truncated file raise, each naming its
    file; nothing becomes a placeholder."""
    rs = np.random.RandomState(7)
    Image.fromarray(rs.randint(0, 256, (8, 8, 3)).astype(np.uint8)).save(
        tmp_path / "p.jpg")
    with pytest.raises(ValueError, match="p.jpg"):
        toutput.read_image(str(tmp_path / "p.jpg"))
    Image.fromarray(rs.randint(0, 65535, (4, 4)).astype(np.uint16)).save(
        tmp_path / "deep.png")
    with pytest.raises(ValueError, match="deep.png.*8-bit"):
        toutput.read_image(str(tmp_path / "deep.png"))
    (tmp_path / "short.exr").write_bytes(struct.pack("<ii", 20000630, 2))
    with pytest.raises(ValueError, match="short.exr"):
        toutput.read_image(str(tmp_path / "short.exr"))


def test_postprocess_matches_jax(tmp_path):
    img = _image(8, 6, 6, scale=2.0) - 0.5
    cube = tmp_path / "lut.cube"
    n = 4
    grid = np.random.RandomState(9).rand(n, n, n, 3)
    cube.write_text("TITLE \"t\"\nLUT_3D_SIZE 4\nDOMAIN_MIN 0 0 0\n"
                    "DOMAIN_MAX 1 1 1\n"
                    + "\n".join(" ".join(f"{v:.6f}" for v in row)
                                for row in grid.reshape(-1, 3)) + "\n")
    for t_filters, j_filters in (
            ([tpost.Gamma()], [jpost.Gamma()]),
            ([tpost.Clamp(0.1, 0.9)], [jpost.Clamp(0.1, 0.9)]),
            ([tpost.Gamma(), tpost.Clamp(),
              tpost.ColourGrading.from_cube_file(str(cube))],
             [jpost.Gamma(), jpost.Clamp(),
              jpost.ColourGrading.from_cube_file(str(cube))])):
        np.testing.assert_allclose(tpost.Pipeline(t_filters).apply(img),
                                   jpost.Pipeline(j_filters).apply(img),
                                   rtol=1e-12, atol=0)


def test_preview_server_serves_the_png(tmp_path):
    """PreviewServer (io.display) on 127.0.0.1, a free port: the page and
    the PNG as it is on disk; a missing file is a 404."""
    import urllib.error
    import urllib.request

    from izpi_tpu_torch.io import display

    path = tmp_path / "p.png"
    toutput.write_png(str(path), _image(9, scale=1.0))
    server = display.PreviewServer(str(path)).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(base + "/preview.png?1", timeout=10) as r:
            assert r.headers["Content-Type"] == "image/png"
            assert r.read() == path.read_bytes()
        with urllib.request.urlopen(base + "/", timeout=10) as r:
            assert b"preview.png" in r.read()
        path.unlink()
        with pytest.raises(urllib.error.HTTPError, match="404"):
            urllib.request.urlopen(base + "/preview.png", timeout=10)
    finally:
        server.stop()
