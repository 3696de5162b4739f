"""PNG reading and writing with webui-compatible metadata (this package's copy
of the PNG parts of ``sdtpu/utils/image.py``: ``build_parameters_text``,
``parse_parameters_text``, ``walk_image_metadata``, ``image_to_base64``,
``read_png``, ``base64_png_to_image``, and the CLI's
``resolve_output_path``).

The port needs no Pillow: it always writes PNG with the JAX package's own
zlib writer (``_write_png_fallback``: the same IHDR, the same tEXt
``parameters`` chunk, the same bytes), and reads the PNGs users hand in
(8-bit grey, grey + alpha, RGB or RGBA, any of the five row filters) as
Pillow's ``convert("RGB")`` gives them.  Palette, 16-bit and interlaced
PNGs, and JPEG and WebP in either direction, need Pillow and are refused
by name.
"""
from __future__ import annotations

import base64
import io
import os
import re
import struct
import zlib
from typing import Dict, Optional

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def build_parameters_text(gp, extra: Optional[Dict[str, str]] = None) -> str:
    """webui-style generation parameters string."""
    lines = [gp.prompt]
    if gp.negative_prompt:
        lines.append(f"Negative prompt: {gp.negative_prompt}")
    fields = [
        f"Steps: {gp.sample_steps}",
        f"Sampler: {gp.sample_method}",
        f"Schedule type: {gp.schedule}",
        f"CFG scale: {gp.cfg_scale:g}",
        f"Seed: {gp.seed}",
        f"Size: {gp.width}x{gp.height}",
    ]
    if gp.clip_skip > 0:
        fields.append(f"Clip skip: {gp.clip_skip}")
    if extra:
        fields.extend(f"{k}: {v}" for k, v in extra.items())
    fields.append("Version: sdtpu")
    lines.append(", ".join(fields))
    return "\n".join(lines)


def parse_parameters_text(text: str) -> Dict[str, str]:
    """Read back a webui parameters blob into a dict."""
    out: Dict[str, str] = {}
    lines = text.split("\n")
    if not lines:
        return out
    out["prompt"] = lines[0]
    for line in lines[1:]:
        if line.startswith("Negative prompt: "):
            out["negative_prompt"] = line[len("Negative prompt: "):]
        else:
            for field in line.split(", "):
                if ": " in field:
                    k, v = field.split(": ", 1)
                    out[k.strip().lower().replace(" ", "_")] = v
    return out


def resolve_output_path(output: str, i: int, n: int, begin_idx=None) -> str:
    """Output file naming: printf-style %d sequences and --output-begin-idx."""
    begin = 0 if begin_idx is None or begin_idx < 0 else begin_idx
    if re.search(r"%0?\d*d", output):
        return output % (begin + i)
    if n == 1:
        return output
    base, ext = os.path.splitext(output)
    return f"{base}_{begin + i}{ext}"


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(image: np.ndarray, parameters: Optional[str] = None) -> bytes:
    """[H,W,3] uint8 → PNG bytes (filter 0 rows, zlib level 6), with
    ``parameters`` as a tEXt chunk."""
    h, w, _ = image.shape
    raw = b"".join(b"\x00" + image[y].tobytes() for y in range(h))
    out = io.BytesIO()
    out.write(PNG_SIGNATURE)
    out.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
    if parameters:
        out.write(_png_chunk(b"tEXt", b"parameters\x00" + parameters.encode("latin-1", "replace")))
    out.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
    out.write(_png_chunk(b"IEND", b""))
    return out.getvalue()


def write_image(path: str, image: np.ndarray, parameters: Optional[str] = None) -> None:
    """Write a PNG (any extension but .jpg / .jpeg / .webp, as the JAX
    package's ``write_image``); JPEG and WebP raise ``ValueError``."""
    low = path.lower()
    if low.endswith((".jpg", ".jpeg", ".webp")):
        raise ValueError(f"{path}: JPEG and WebP output need Pillow, which the port does not "
                         "use; write a .png")
    with open(path, "wb") as f:
        f.write(encode_png(image, parameters))


# the JAX package's video containers (``write_video``: AVI of JPEG frames,
# animated WebP, GIF, WebM) need Pillow's encoders, which the port does not use
VIDEO_CONTAINERS = (".avi", ".webp", ".gif", ".webm")


def write_video_frames(path: str, frames: np.ndarray) -> list:
    """A clip [T, H, W, 3] uint8 as one PNG a frame, ``<path without its
    extension>_0000.png``..., as the JAX package's ``write_video`` writes a
    path that names none of its containers → the paths written.  A container
    raises ``ValueError``."""
    if path.lower().endswith(VIDEO_CONTAINERS):
        raise ValueError(f"{path}: {'/'.join(VIDEO_CONTAINERS)} output needs Pillow's JPEG / WebP "
                         "encoders, which the port does not use; name a .png to write one PNG a "
                         "frame")
    base = path.rsplit(".", 1)[0]
    paths = [f"{base}_{i:04d}.png" for i in range(len(frames))]
    for p, f in zip(paths, frames):
        with open(p, "wb") as fh:
            fh.write(encode_png(f))
    return paths


# colour type → (channels, what Pillow's convert("RGB") keeps of them)
PNG_COLOUR_TYPES = {0: (1, [0, 0, 0]), 2: (3, [0, 1, 2]), 4: (2, [0, 0, 0]), 6: (4, [0, 1, 2])}


def _diagonal(rows: np.ndarray, y: int, x: int, n: int, bpp: int) -> np.ndarray:
    """The view [n, bpp] of pixels (y + i, x - i), i < n, of ``rows`` [H, W·bpp]."""
    return np.lib.stride_tricks.as_strided(rows[y, x * bpp:], (n, bpp), (rows.strides[0] - bpp, 1))


def _unfilter_wavefront(raw: np.ndarray, kinds: np.ndarray, prior: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Rows [h, stride] of any filters below the reconstructed row ``prior``.
    Average and Paeth make each pixel depend on the one to its left and the
    two above, so the pixels of one anti-diagonal (y + x = t) are independent
    of each other: h + w - 1 vector steps, each over one anti-diagonal, with
    every row's own predictor picked by a bit mask."""
    h, stride = raw.shape
    w = stride // bpp
    out = np.empty((h, stride), dtype=np.uint8)
    sel = -(kinds[:, None] == np.arange(1, 5)).astype(np.int16)  # all ones where Sub/Up/Avg/Paeth
    m_sub, m_up, m_avg, m_paeth = (sel[:, i:i + 1] for i in range(4))
    above = np.zeros((w + 1, bpp), dtype=np.int16)
    above[:w] = prior.reshape(w, bpp)
    # d1 / d2: anti-diagonals t - 1 / t - 2, at index y + 1 (index 0: ``prior``)
    d2 = np.zeros((h + 1, bpp), dtype=np.int16)
    d1 = np.zeros((h + 1, bpp), dtype=np.int16)
    d1[0] = above[0]
    for t in range(h + w - 1):
        lo, hi = max(0, t - w + 1), min(h, t + 1)
        a, b, c = d1[lo + 1:hi + 1], d1[lo:hi], d2[lo:hi]  # left, above, above-left
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = ((a & m_sub[lo:hi]) | (b & m_up[lo:hi]) | (((a + b) >> 1) & m_avg[lo:hi])
                | (paeth & m_paeth[lo:hi]))
        new = np.zeros((h + 1, bpp), dtype=np.int16)
        new[0] = above[min(t + 1, w)]
        new[lo + 1:hi + 1] = (_diagonal(raw, lo, t - lo, hi - lo, bpp) + pred) & 255
        _diagonal(out, lo, t - lo, hi - lo, bpp)[:] = new[lo + 1:hi + 1]
        d2, d1 = d1, new
    return out


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Filtered scanlines → the image's bytes [h, stride].  None, Sub and Up
    rows run row by row; the rows from the first Average or Paeth row to the
    last one run as one wavefront (``_unfilter_wavefront``)."""
    if len(data) < h * (1 + stride):
        raise ValueError("truncated PNG image data")
    rows = np.frombuffer(data, dtype=np.uint8, count=h * (1 + stride)).reshape(h, 1 + stride)
    kinds, raw = rows[:, 0], rows[:, 1:]
    if (kinds > 4).any():
        raise ValueError(f"PNG row filter {kinds[kinds > 4][0]} is not one of the five")
    slow = np.flatnonzero(kinds >= 3)
    first, last = (int(slow[0]), int(slow[-1]) + 1) if slow.size else (h, h)
    out = np.zeros((h, stride), dtype=np.uint8)
    prior, y = np.zeros(stride, dtype=np.uint8), 0
    while y < h:
        if y == first:
            out[first:last] = _unfilter_wavefront(raw[first:last], kinds[first:last], prior, bpp)
            y = last
        else:
            if kinds[y] == 0:
                out[y] = raw[y]
            elif kinds[y] == 1:  # Sub: a running sum along each byte lane
                out[y] = np.cumsum(raw[y].reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
            else:  # Up
                out[y] = raw[y] + prior
            y += 1
        prior = out[y - 1]
    return out


def decode_png(blob: bytes):
    """PNG bytes → (image [H,W,3] uint8, parameters text or None).  Reads
    8-bit grey, grey + alpha, RGB and RGBA PNGs with any row filters, as
    Pillow's ``convert("RGB")`` gives them (grey repeated, alpha dropped);
    palette, 16-bit and interlaced PNGs, and JPEG and WebP, raise
    ``ValueError`` naming them."""
    if blob[:3] == b"\xff\xd8\xff":
        raise ValueError("a JPEG image: reading JPEG needs Pillow, which the port does not use; "
                         "hand in a PNG")
    if blob[:4] == b"RIFF" and blob[8:12] == b"WEBP":
        raise ValueError("a WebP image: reading WebP needs Pillow, which the port does not use; "
                         "hand in a PNG")
    if blob[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, params, header = 8, [], None, None
    while pos + 8 <= len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        tag, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag in (b"tEXt", b"zTXt", b"iTXt") and data.startswith(b"parameters\x00"):
            body = data[len(b"parameters\x00"):]
            if tag == b"zTXt":
                params = zlib.decompress(body[1:]).decode("latin-1", "replace")
            elif tag == b"iTXt":
                text = body[2:].split(b"\x00", 2)[-1]  # after the language and translated key
                params = (zlib.decompress(text) if body[0] else text).decode("utf-8", "replace")
            else:
                params = body.decode("latin-1", "replace")
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("a PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype == 3:
        raise ValueError("a palette PNG: reading palette images needs Pillow; hand in an RGB PNG")
    if ctype not in PNG_COLOUR_TYPES:
        raise ValueError(f"PNG colour type {ctype} is not one of 0, 2, 4, 6")
    if depth != 8:
        raise ValueError(f"a {depth}-bit PNG: the port reads 8-bit PNGs; hand in an 8-bit one")
    if interlace:
        raise ValueError("an interlaced PNG: the port reads non-interlaced PNGs")
    channels, keep = PNG_COLOUR_TYPES[ctype]
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * channels, channels)
    return np.ascontiguousarray(rows.reshape(h, w, channels)[..., keep]), params


def read_png(path: str):
    """→ (image [H,W,3] uint8, parameters text or None) of a PNG file
    (``decode_png``)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def base64_png_to_image(data: str) -> np.ndarray:
    """A base64 PNG (a ``data:`` URL too) → [H,W,3] uint8."""
    if data.startswith("data:"):
        data = data.split(",", 1)[1]
    return decode_png(base64.b64decode(data))[0]


def walk_image_metadata(path: str, include_structural: bool = False,
                        include_raw: bool = False, brief: bool = False):
    """Chunk-level metadata walk of a PNG (the metadata mode's reader).

    → list of dicts {"chunk", "length", ["keyword"], ["value"], ["raw"]}.
    tEXt/iTXt/zTXt parse to keyword/value; other chunks get a raw hex
    preview when include_raw; structural chunks (IHDR/IDAT/IEND, ...) appear
    only with include_structural; brief truncates long text values.  The JAX
    package also walks JPEG and WebP; the port writes neither and refuses
    them."""
    def _val(text: str) -> str:
        if brief and len(text) > 96:
            return text[:96] + f"…({len(text)} chars)"
        return text

    def _entry(name: str, length: int, keyword=None, value=None, data=None):
        e = {"chunk": name, "length": length}
        if keyword is not None:
            e["keyword"] = keyword
        if value is not None:
            e["value"] = _val(value)
        if data is not None and include_raw:
            e["raw"] = data[:32].hex()
        return e

    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (the port reads no JPEG or WebP)")
    entries = []
    structural = {b"IHDR", b"IDAT", b"IEND", b"PLTE", b"pHYs", b"sRGB",
                  b"gAMA", b"cHRM", b"bKGD", b"sBIT", b"tIME"}
    pos = 8
    while pos + 8 <= len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + n]
        name = tag.decode("latin-1")
        if tag == b"tEXt" and b"\x00" in data:
            k, v = data.split(b"\x00", 1)
            entries.append(_entry(name, n, k.decode("latin-1"), v.decode("latin-1", "replace")))
        elif tag == b"zTXt" and b"\x00" in data:
            k, rest = data.split(b"\x00", 1)
            try:
                v = zlib.decompress(rest[1:]).decode("latin-1", "replace")
            except Exception:
                v = "(bad zTXt payload)"
            entries.append(_entry(name, n, k.decode("latin-1"), v))
        elif tag == b"iTXt" and data.count(b"\x00") >= 4:
            k, rest = data.split(b"\x00", 1)
            comp = rest[0]
            # rest[2:] = lang\0translated_kw\0text
            parts = rest[2:].split(b"\x00", 2)
            text = parts[2] if len(parts) == 3 else b""
            if comp:
                try:
                    text = zlib.decompress(text)
                except Exception:
                    text = b"(bad iTXt payload)"
            entries.append(_entry(name, n, k.decode("latin-1"), text.decode("utf-8", "replace")))
        elif tag in structural:
            if include_structural:
                e = _entry(name, n, data=data)
                if tag == b"IHDR" and n >= 8:
                    w, h = struct.unpack(">II", data[:8])
                    e["value"] = f"{w}x{h}"
                entries.append(e)
        else:  # eXIf and friends: unparsed payload
            entries.append(_entry(name, n, data=data))
        pos += 12 + n
        if tag == b"IEND":
            break
    return entries


def image_to_base64_png(image: np.ndarray, parameters: Optional[str] = None) -> str:
    return base64.b64encode(encode_png(image, parameters)).decode("ascii")


def image_to_base64(image: np.ndarray, fmt: str = "png", quality: int = 90,
                    parameters: Optional[str] = None) -> str:
    """Base64-encode an image as PNG; jpeg / webp need Pillow and raise
    ``ValueError`` (``quality`` is theirs)."""
    fmt = (fmt or "png").lower()
    if fmt != "png":
        raise ValueError(f"output_format {fmt!r} needs Pillow, which the port does not use; "
                         "the port encodes png")
    return image_to_base64_png(image, parameters=parameters)
