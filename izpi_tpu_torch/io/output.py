"""Image writers and readers, on numpy, zlib and struct alone.

Counterpart of `izpi_tpu/io/output.py`. The reference writes PNG through
Go's standard library and EXR, HDR and PFM through OpenImageIO
(internal/output/png.go, oiio.go); the JAX package writes PNG through PIL
and reads PNG through PIL and HDR through imageio. Neither is here: the
PNG writer and every reader are written out below.

Output semantics kept from the reference:
- the PNG path applies gamma 2 and a clamp to [0, 1] before quantizing
  (leader.go:178-183, postprocess Gamma + Clamp);
- EXR, HDR and PFM are written linear;
- the ACES EXR carries the AP1 chromaticities and the adopted neutral
  (oiio.go:26-41).
The EXR, HDR and PFM writers are the JAX package's, byte for byte.

The readers decode PNG (8-bit grey, grey with alpha, RGB, RGBA and
palette images, 1, 2 and 4-bit grey and palette ones, every filter type,
not interlaced), EXR (single-part scanline, NONE, ZIPS or ZIP, HALF, FLOAT
or UINT channels), Radiance HDR (flat or run-length scanlines) and PFM. A file in any other format or
variant raises with its name; nothing is replaced by a placeholder.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from izpi_tpu_torch.io import postprocess


def write(path: str, image: np.ndarray, mode: Optional[str] = None,
          aces: bool = False) -> None:
    """Dispatch by extension or explicit mode ∈ {png, exr, hdr, pfm}."""
    mode = mode or path.rsplit(".", 1)[-1].lower()
    if mode == "png":
        write_png(path, image)
    elif mode == "exr":
        write_exr(path, image, aces=aces)
    elif mode == "hdr":
        write_hdr(path, image)
    elif mode == "pfm":
        write_pfm(path, image)
    else:
        raise ValueError(f"unknown output mode {mode!r}")


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """An 8-bit RGB PNG of `image` (H, W, 3) after the reference's gamma 2
    and clamp (leader.go:178-183), quantized as int(x·255 + 0.5), every
    row unfiltered (filter type 0)."""
    img = postprocess.Pipeline([postprocess.Gamma(), postprocess.Clamp()]) \
        .apply(np.asarray(image, np.float64))
    px = (img * 255.0 + 0.5).astype(np.uint8)
    h, w, c = px.shape
    if c != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {px.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), px.reshape(h, w * 3)],
                          axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# OpenEXR (scanline, float32, zip-per-scanline): the JAX package's writer.
# ---------------------------------------------------------------------------


def _exr_attr(name: bytes, type_: bytes, data: bytes) -> bytes:
    return name + b"\0" + type_ + b"\0" + struct.pack("<i", len(data)) + data


def write_exr(path: str, image: np.ndarray, aces: bool = False) -> None:
    """Write a linear float32 EXR (ZIPS-compressed scanlines, channels
    B, G, R). aces=True stamps the ACEScg (AP1/D60) chromaticities and
    adoptedNeutral, the reference's OIIOACES metadata (oiio.go:26-41)."""
    img = np.asarray(image, np.float32)
    h, w, _ = img.shape

    channels = b""
    for name in (b"B", b"G", b"R"):
        # pixel type 2 = FLOAT, pLinear 0, sampling 1,1
        channels += name + b"\0" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)
    channels += b"\0"

    header = b""
    header += _exr_attr(b"channels", b"chlist", channels)
    # ZIPS: one scanline per chunk.
    header += _exr_attr(b"compression", b"compression", struct.pack("B", 2))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _exr_attr(b"dataWindow", b"box2i", box)
    header += _exr_attr(b"displayWindow", b"box2i", box)
    header += _exr_attr(b"lineOrder", b"lineOrder", struct.pack("B", 0))
    header += _exr_attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _exr_attr(b"screenWindowCenter", b"v2f",
                        struct.pack("<ff", 0.0, 0.0))
    header += _exr_attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    if aces:
        # AP1 primaries + D60 white (ACEScg), plus adoptedNeutral.
        chroma = struct.pack("<8f", 0.713, 0.293, 0.165, 0.830,
                             0.128, 0.044, 0.32168, 0.33767)
        header += _exr_attr(b"chromaticities", b"chromaticities", chroma)
        header += _exr_attr(b"adoptedNeutral", b"v2f",
                            struct.pack("<ff", 0.32168, 0.33767))
    header += b"\0"

    blocks = []
    for y in range(h):
        row = img[y]
        raw = (row[:, 2].tobytes() + row[:, 1].tobytes()
               + row[:, 0].tobytes())
        comp = _exr_zip(raw)
        blocks.append(struct.pack("<ii", y, len(comp)) + comp)

    magic = struct.pack("<i", 20000630) + struct.pack("<i", 2)
    pos = len(magic) + len(header) + 8 * h
    offsets = []
    for blk in blocks:
        offsets.append(pos)
        pos += len(blk)

    with open(path, "wb") as f:
        f.write(magic)
        f.write(header)
        for off in offsets:
            f.write(struct.pack("<q", off))
        for blk in blocks:
            f.write(blk)


def _exr_zip(raw: bytes) -> bytes:
    """EXR's ZIP: a two-way byte interleave, a delta predictor, deflate;
    the raw bytes when deflate does not shrink them."""
    data = np.frombuffer(raw, np.uint8)
    half = (len(data) + 1) // 2
    interleaved = np.empty(len(data), np.uint8)
    interleaved[0::2] = data[:half]
    interleaved[1::2] = data[half:half + len(data) - half]
    delta = np.empty(len(data), np.uint8)
    delta[0] = interleaved[0]
    delta[1:] = (interleaved[1:].astype(np.int16)
                 - interleaved[:-1].astype(np.int16) + 128).astype(np.uint8)
    comp = zlib.compress(delta.tobytes())
    return comp if len(comp) < len(raw) else raw


def write_pfm(path: str, image: np.ndarray) -> None:
    """Portable FloatMap (PF, little-endian, bottom-up rows)."""
    img = np.asarray(image, np.float32)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # negative scale = little endian
        f.write(img[::-1].tobytes())


def write_hdr(path: str, image: np.ndarray) -> None:
    """Radiance RGBE (.hdr), flat scanlines."""
    img = np.asarray(image, np.float64)
    h, w, _ = img.shape
    brightest = np.maximum(img.max(axis=-1), 1e-32)
    exponent = np.ceil(np.log2(brightest)).astype(np.int32) + 1
    scale = np.exp2(-exponent + 8)
    rgbe = np.zeros((h, w, 4), np.uint8)
    mantissa = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., :3] = mantissa
    rgbe[..., 3] = (exponent + 128).astype(np.uint8)
    zero = brightest < 1e-30
    rgbe[zero] = 0
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


# ---------------------------------------------------------------------------
# Readers (texture loading; the reference reads through OpenImageIO).
# ---------------------------------------------------------------------------


def read_image(path: str) -> np.ndarray:
    """Read a PNG, EXR, HDR or PFM file to (H, W, 3) float32. PNG values
    are the raw 8-bit values over 255, with no sRGB decode
    (texture/image.go:95-101), and its alpha is dropped. The format comes
    from the file's own signature, not its name."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data.startswith(_PNG_SIGNATURE):
            return _read_png(data)
        if data[:4] == struct.pack("<i", 20000630):
            return _read_exr(data)
        if data.startswith((b"#?RADIANCE", b"#?RGBE")):
            return _read_hdr(data)
        if data[:3] == b"PF\n":
            return _read_pfm(data)
    except (ValueError, IndexError, struct.error, zlib.error) as exc:
        raise ValueError(f"{path}: {exc}") from exc
    raise ValueError(f"{path}: not a PNG, EXR, HDR or PFM file; convert "
                     f"it to one of these")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth)."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {rows.size} bytes, not "
                         f"{h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:
            # Sub: a running sum over the pixels, per byte of a pixel.
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) % 256
        elif ftype == 2:
            cur = (line + prior) % 256
        elif ftype in (3, 4):
            cur = np.zeros(stride, np.int64)
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + int(prior[i])) // 2
                else:
                    upleft = int(prior[i - bpp]) if i >= bpp else 0
                    pred = _paeth(int(left), int(prior[i]), upleft)
                cur[i] = (int(line[i]) + pred) % 256
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def _read_png(data: bytes) -> np.ndarray:
    pos = len(_PNG_SIGNATURE)
    header = None
    palette = None
    idat = []
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    if channels is None:
        raise ValueError(f"unknown PNG colour type {ctype}")
    if depth != 8 and not (ctype in (0, 3) and depth in (1, 2, 4)):
        raise ValueError(f"PNG of {depth} bits a sample: only 8-bit PNG "
                         f"(and 1, 2 or 4-bit grey or palette) is read")
    if interlace:
        raise ValueError("interlaced PNG is not read")
    if depth == 8:
        px = _unfilter(zlib.decompress(b"".join(idat)), h, w * channels,
                       channels).reshape(h, w, channels)
    else:
        # Packed samples, most significant bits first; filters work on
        # whole bytes (one a "pixel").
        packed = _unfilter(zlib.decompress(b"".join(idat)), h,
                           -(-w * depth // 8), 1)
        bits = np.unpackbits(packed, axis=1)[:, :w * depth]
        weights = 1 << np.arange(depth - 1, -1, -1)
        px = (bits.reshape(h, w, depth) * weights).sum(-1).astype(np.uint8)
        if ctype == 0:   # grey scales up to 0..255, as PIL's convert does
            px = (px.astype(np.int64) * 255 // (2 ** depth - 1)).astype(
                np.uint8)
        px = px[..., None]
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        rgb = palette[px[..., 0]]
    elif ctype in (0, 4):
        rgb = np.repeat(px[..., :1], 3, axis=-1)
    else:
        rgb = px[..., :3]
    return rgb.astype(np.float32) / 255.0


def _read_pfm(data: bytes) -> np.ndarray:
    lines = data.split(b"\n", 3)
    w, h = (int(x) for x in lines[1].split())
    scale = float(lines[2])
    pix = np.frombuffer(lines[3], "<f4" if scale < 0 else ">f4",
                        count=w * h * 3)
    return pix.reshape(h, w, 3)[::-1].astype(np.float32)


def _read_hdr(data: bytes) -> np.ndarray:
    """Radiance RGBE: flat or new-style run-length scanlines, "-Y h +X w";
    a value is m·2^(e-136) (rgbe.c's rgbe2float)."""
    pos = 0
    fmt = None
    while True:
        end = data.index(b"\n", pos)
        line = data[pos:end].strip()
        pos = end + 1
        if not line:
            break
        if line.startswith(b"FORMAT="):
            fmt = line[7:]
    if fmt not in (None, b"32-bit_rle_rgbe"):
        raise ValueError(f"HDR format {fmt.decode()!r} is not read")
    end = data.index(b"\n", pos)
    res = data[pos:end].split()
    pos = end + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"HDR resolution {b' '.join(res).decode()!r}: only "
                         f"'-Y h +X w' is read")
    h, w = int(res[1]), int(res[3])
    rgbe = np.zeros((h, w, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    for y in range(h):
        if (8 <= w < 0x8000 and buf[pos] == 2 and buf[pos + 1] == 2
                and not buf[pos + 2] & 0x80):
            if (int(buf[pos + 2]) << 8 | int(buf[pos + 3])) != w:
                raise ValueError(f"HDR scanline {y} has the wrong width")
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = int(buf[pos])
                    pos += 1
                    if count > 128:
                        count -= 128
                        rgbe[y, x:x + count, c] = buf[pos]
                        pos += 1
                    else:
                        if count == 0:
                            raise ValueError(f"HDR scanline {y}: empty run")
                        rgbe[y, x:x + count, c] = buf[pos:pos + count]
                        pos += count
                    x += count
                if x != w:
                    raise ValueError(f"HDR scanline {y}: runs overrun it")
        else:
            row = buf[pos:pos + 4 * w]
            if row.size != 4 * w:
                raise ValueError("HDR file ends before its last scanline")
            if (row.reshape(w, 4)[:, :3] == 1).all(axis=1).any():
                raise ValueError("old-style run-length HDR is not read")
            rgbe[y] = row.reshape(w, 4)
            pos += 4 * w
    e = rgbe[..., 3].astype(np.int32)
    f = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    return (rgbe[..., :3].astype(np.float64) * f[..., None]).astype(np.float32)


_EXR_PIXSIZE = {0: 4, 1: 2, 2: 4}   # UINT, HALF, FLOAT
_EXR_DTYPE = {0: np.uint32, 1: np.float16, 2: np.float32}
_EXR_COMP_NAMES = {0: "NONE", 1: "RLE", 2: "ZIPS", 3: "ZIP", 4: "PIZ",
                   5: "PXR24", 6: "B44", 7: "B44A", 8: "DWAA", 9: "DWAB"}


def _exr_unzip(raw: bytes, expect: int) -> bytes:
    """Invert EXR's deflate, delta predictor and two-way interleave."""
    if len(raw) == expect:          # stored uncompressed (zip didn't shrink)
        return raw
    delta = np.frombuffer(zlib.decompress(raw), np.uint8).astype(np.int64)
    rec = np.cumsum(
        np.concatenate([delta[:1], delta[1:] - 128])).astype(np.uint8)
    half = (len(rec) + 1) // 2
    deinter = np.empty(len(rec), np.uint8)
    deinter[:half] = rec[0::2]
    deinter[half:] = rec[1::2]
    return deinter.tobytes()


def _exr_chunks(data: bytes, pos: int, y0: int, h: int, lines: int):
    """The chunk offsets of a scanline file whose table starts at `pos`,
    if every chunk lies in the file, in increasing order, and starts with
    the y of its block of `lines` rows; else None."""
    n = -(-h // lines)
    if pos + 8 * n > len(data):
        return None
    offsets = struct.unpack(f"<{n}q", data[pos:pos + 8 * n])
    prev = pos + 8 * n - 1
    for k, off in enumerate(offsets):
        if off <= prev or off + 8 > len(data):
            return None
        y, size = struct.unpack("<ii", data[off:off + 8])
        if y != y0 + k * lines or size < 0 or off + 8 + size > len(data):
            return None
        prev = off
    return offsets


def _read_exr(data: bytes) -> np.ndarray:
    """Single-part scanline EXR: HALF, FLOAT or UINT pixels, any channel
    names, NONE, ZIPS or ZIP compression. Returns (H, W, 3) float32 RGB (Y
    broadcast for a grey file).

    A file that declares ZIP (16 rows a chunk) but holds one row a chunk,
    as an earlier writer of the JAX package made them, is read line by
    line, but only when its table does not parse as 16-row chunks and
    parses as one-row chunks: every offset inside the file, increasing,
    each chunk starting with its own row's y (the JAX reader guessed from
    the first offset alone, io/output.py:289)."""
    version = struct.unpack("<i", data[4:8])[0]
    if version & 0x200:
        raise ValueError("tiled EXR is not read (scanline only)")
    if version & 0x1000:
        raise ValueError("multi-part EXR is not read")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        end = data.index(b"\0", pos)
        name = data[pos:end].decode()
        pos = end + 1
        end = data.index(b"\0", pos)
        type_ = data[pos:end].decode()
        pos = end + 1
        size = struct.unpack("<i", data[pos:pos + 4])[0]
        pos += 4
        attrs[name] = (type_, data[pos:pos + size])
        pos += size
    pos += 1

    # The channel list, in file order (alphabetical; each row's data
    # follows it).
    chans = []
    cdata = attrs["channels"][1]
    cpos = 0
    while cdata[cpos] != 0:
        end = cdata.index(b"\0", cpos)
        cname = cdata[cpos:end].decode()
        cpos = end + 1
        ptype, _, _, _, _, sx, sy = struct.unpack(
            "<iBBBBii", cdata[cpos:cpos + 16])
        cpos += 16
        if sx != 1 or sy != 1:
            raise ValueError(f"subsampled channel {cname!r} is not read")
        if ptype not in _EXR_PIXSIZE:
            raise ValueError(f"unknown pixel type {ptype} for {cname!r}")
        chans.append((cname, ptype))

    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    comp = attrs["compression"][1][0]
    if comp not in (0, 2, 3):
        raise ValueError(
            f"EXR compression {_EXR_COMP_NAMES.get(comp, comp)} is not read: "
            f"re-encode with ZIP, ZIPS or NONE (e.g. `oiiotool in.exr "
            f"--compression zip -o out.exr`)")
    lines_per_block = 16 if comp == 3 else 1
    offsets = _exr_chunks(data, pos, y0, h, lines_per_block)
    if offsets is None and comp == 3:
        offsets = _exr_chunks(data, pos, y0, h, 1)
        lines_per_block = 1
    if offsets is None:
        raise ValueError("EXR chunk table does not match its scanlines")

    bytes_per_line = sum(w * _EXR_PIXSIZE[pt] for _, pt in chans)
    planes = {cname: np.zeros((h, w), np.float32) for cname, _ in chans}
    for off in offsets:
        y, size = struct.unpack("<ii", data[off:off + 8])
        y -= y0
        n_lines = min(lines_per_block, h - y)
        raw = data[off + 8: off + 8 + size]
        if comp in (2, 3):
            raw = _exr_unzip(raw, bytes_per_line * n_lines)
        if len(raw) != bytes_per_line * n_lines:
            raise ValueError(f"EXR chunk of row {y + y0} holds {len(raw)} "
                             f"bytes, not {bytes_per_line * n_lines}")
        lpos = 0
        for ly in range(y, y + n_lines):
            for cname, ptype in chans:
                nbytes = w * _EXR_PIXSIZE[ptype]
                vals = np.frombuffer(raw[lpos:lpos + nbytes],
                                     _EXR_DTYPE[ptype])
                planes[cname][ly] = vals.astype(np.float32)
                lpos += nbytes

    names = {c for c, _ in chans}
    out = np.zeros((h, w, 3), np.float32)
    if {"R", "G", "B"} <= names:
        for i, c in enumerate("RGB"):
            out[..., i] = planes[c]
    elif "Y" in names:
        out[:] = planes["Y"][..., None]
    else:
        picks = [c for c, _ in chans][:3]
        for i, c in enumerate(picks):
            out[..., i] = planes[c]
        for i in range(len(picks), 3):
            out[..., i] = out[..., max(len(picks) - 1, 0)]
    return out
