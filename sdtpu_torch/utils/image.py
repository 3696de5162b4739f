"""PNG writing with webui-compatible metadata (this package's copy of the PNG
parts of ``sdtpu/utils/image.py``: ``build_parameters_text``,
``parse_parameters_text``, ``walk_image_metadata``, ``image_to_base64``,
and the CLI's ``resolve_output_path``).

The port needs no Pillow: it always writes PNG with the JAX package's own
zlib writer (``_write_png_fallback``: the same IHDR, the same tEXt
``parameters`` chunk, the same bytes), and decodes only what it writes.
JPEG and WebP output need Pillow and are refused.
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


def decode_png(blob: bytes):
    """PNG bytes → (image [H,W,3] uint8, parameters text or None) of an 8-bit
    RGB PNG whose rows all use filter 0, as ``encode_png`` writes them."""
    if blob[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, params, size = 8, [], None, None
    while pos + 8 <= len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        tag, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", data)
            if (depth, ctype, interlace) != (8, 2, 0):
                raise ValueError("not an 8-bit RGB PNG without interlace")
            size = (h, w)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"tEXt" and data.startswith(b"parameters\x00"):
            params = data[len(b"parameters\x00"):].decode("latin-1", "replace")
        pos += 12 + n
    h, w = size
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("rows with PNG filters other than 0 are not read here")
    return rows[:, 1:].reshape(h, w, 3).copy(), params


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
