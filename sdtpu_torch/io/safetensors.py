"""safetensors reading in pure python + numpy (this package's copy of the
reader in ``sdtpu/io/safetensors.py``; HF sharded index.json supported).

Format: u64-LE header length, JSON header {name: {dtype, shape, data_offsets}},
raw tensor bytes. Reading uses mmap so weights stage lazily.
"""
from __future__ import annotations

import json
import mmap
import os
from typing import Dict

import numpy as np

from sdtpu_torch.io.gguf import _parallel_map

_DTYPES: Dict[str, np.dtype] = {
    "F64": np.dtype("<f8"),
    "F32": np.dtype("<f4"),
    "F16": np.dtype("<f2"),
    "BF16": np.dtype("<u2"),  # decoded below
    "I64": np.dtype("<i8"),
    "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"),
    "U8": np.dtype("u1"),
    "BOOL": np.dtype("?"),
    "F8_E4M3": np.dtype("u1"),
    "F8_E5M2": np.dtype("u1"),
}


def _bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    return (raw.astype(np.uint32) << 16).view(np.float32)


def _f8_e4m3_to_f32(raw: np.ndarray) -> np.ndarray:
    """OCP FP8 E4M3 (no inf, 448 max) → f32."""
    r = raw.astype(np.uint32)
    sign = (r >> 7) & 1
    exp = (r >> 3) & 0xF
    mant = r & 0x7
    out = np.empty(raw.shape, dtype=np.float32)
    # normal: exp>0 → value = 2^(exp-7) * (1 + mant/8)
    normal = (2.0 ** (exp.astype(np.float32) - 7)) * (1 + mant.astype(np.float32) / 8)
    subnormal = (2.0**-6) * (mant.astype(np.float32) / 8)
    out = np.where(exp > 0, normal, subnormal)
    # E4M3FN: exp=15,mant=7 is NaN
    out = np.where((exp == 15) & (mant == 7), np.float32(np.nan), out)
    return np.where(sign == 1, -out, out).astype(np.float32)


def _f8_e5m2_to_f32(raw: np.ndarray) -> np.ndarray:
    # E5M2 is a truncated f16: widen to 16 bits
    return (raw.astype(np.uint16) << 8).view(np.float16).astype(np.float32)


class SafetensorsFile:
    """Lazily-readable safetensors file (mmap-backed)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        header_len = int.from_bytes(self._mm[:8], "little")
        header = json.loads(self._mm[8 : 8 + header_len].decode("utf-8"))
        self.metadata = header.pop("__metadata__", {})
        self.entries = header
        self._data_start = 8 + header_len

    def names(self):
        return list(self.entries.keys())

    def tensor(self, name: str) -> np.ndarray:
        """The named tensor; float types are widened to f32."""
        e = self.entries[name]
        dtype, shape = e["dtype"], tuple(e["shape"])
        begin, end = e["data_offsets"]
        raw = np.frombuffer(
            self._mm, dtype=_DTYPES[dtype], count=max(1, int(np.prod(shape))) if shape else 1,
            offset=self._data_start + begin,
        )
        if dtype == "BF16":
            arr = _bf16_to_f32(raw)
        elif dtype == "F8_E4M3":
            arr = _f8_e4m3_to_f32(raw)
        elif dtype == "F8_E5M2":
            arr = _f8_e5m2_to_f32(raw)
        elif dtype in ("F64", "F16"):
            arr = raw.astype(np.float32)
        else:
            arr = raw
        return arr.reshape(shape)

    def close(self):
        self._mm.close()
        self._f.close()


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Load one .safetensors file, or an HF index.json shard set."""
    if path.endswith(".index.json") or path.endswith("index.json"):
        with open(path) as f:
            index = json.load(f)
        base = os.path.dirname(path)
        out: Dict[str, np.ndarray] = {}
        shards = sorted(set(index["weight_map"].values()))
        for shard in shards:
            out.update(load_safetensors(os.path.join(base, shard)))
        return out
    f = SafetensorsFile(path)
    # multi-threaded tensor reading: page-in + dtype widening release the GIL
    return dict(_parallel_map(lambda n: (n, f.tensor(n)), f.names()))
