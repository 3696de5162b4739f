"""Safe PyTorch checkpoint reading (.ckpt / .pt / .pth / .bin), no code
execution (counterpart of ``sdtpu/io/torch_ckpt.py``).

A restricted unpickler materializes tensors and containers only: the torch
ZIP container (``data.pkl`` + ``data/<key>`` storages) and the legacy
serialization format.  A global outside its allow-list is never imported or
called: it unpickles to an inert placeholder, so a file that pickles other
objects beside its state dict (a training callback) still reads, and one
that pickles a call runs nothing.  ``torch.load`` is not used.
"""
from __future__ import annotations

import io
import pickle
import struct
import zipfile
from typing import Dict

import numpy as np

_STORAGE_DTYPES = {
    "FloatStorage": np.dtype("<f4"),
    "HalfStorage": np.dtype("<f2"),
    "BFloat16Storage": np.dtype("<u2"),
    "DoubleStorage": np.dtype("<f8"),
    "LongStorage": np.dtype("<i8"),
    "IntStorage": np.dtype("<i4"),
    "ShortStorage": np.dtype("<i2"),
    "CharStorage": np.dtype("i1"),
    "ByteStorage": np.dtype("u1"),
    "BoolStorage": np.dtype("?"),
}


class _LazyTensor:
    def __init__(self, storage_key, dtype_name, numel):
        self.storage_key = storage_key
        self.dtype_name = dtype_name
        self.numel = numel
        self.offset = 0
        self.size = ()
        self.stride = ()

    def materialize(self, read_storage) -> np.ndarray:
        dt = _STORAGE_DTYPES[self.dtype_name]
        raw = read_storage(self.storage_key, dt, self.numel)
        n = int(np.prod(self.size)) if self.size else 1
        arr = raw[self.offset : self.offset + n] if self.size else raw[self.offset : self.offset + 1]
        if self.dtype_name == "BFloat16Storage":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        elif dt in (np.dtype("<f2"), np.dtype("<f8")):
            arr = arr.astype(np.float32)
        # strides are in elements; handle non-contiguous via as_strided on a copy
        if self.size and self.stride:
            expected = _contiguous_stride(self.size)
            if tuple(self.stride) != expected:
                full = raw  # keep original buffer for as_strided
                if self.dtype_name == "BFloat16Storage":
                    full = (raw.astype(np.uint32) << 16).view(np.float32)
                elif dt in (np.dtype("<f2"), np.dtype("<f8")):
                    full = raw.astype(np.float32)
                view = np.lib.stride_tricks.as_strided(
                    full[self.offset :],
                    shape=self.size,
                    strides=[s * full.dtype.itemsize for s in self.stride],
                )
                return np.ascontiguousarray(view)
        return arr.reshape(self.size)


def _contiguous_stride(size):
    stride = []
    acc = 1
    for s in reversed(size):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def _rebuild_tensor_v2(storage, storage_offset, size, stride, *args):
    t = _LazyTensor(storage.storage_key, storage.dtype_name, storage.numel)
    t.offset = storage_offset
    t.size = tuple(size)
    t.stride = tuple(stride)
    return t


class _StorageRef:
    def __init__(self, storage_key, dtype_name, numel):
        self.storage_key = storage_key
        self.dtype_name = dtype_name
        self.numel = numel


class _SafeUnpickler(pickle.Unpickler):
    """Allowlist-only unpickler: tensors + containers, nothing executable."""

    _ALLOWED = {
        ("collections", "OrderedDict"): dict,
        ("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor_v2,
        ("torch._utils", "_rebuild_tensor"): _rebuild_tensor_v2,
    }
    _DTYPE_CLASSES = set(_STORAGE_DTYPES)

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return self._ALLOWED[(module, name)]
        if module == "torch" and name in self._DTYPE_CLASSES:
            return name  # storage type tag, used in persistent_load
        if module == "torch" and name.endswith("Tensor"):
            return name
        if (module, name) == ("torch.serialization", "_get_layout"):
            return lambda *_: None
        if (module, name) == ("numpy.core.multiarray", "scalar"):
            return lambda dtype, raw: np.frombuffer(raw, dtype=dtype)[0]
        if (module, name) == ("numpy", "dtype"):
            return np.dtype
        # anything else: return an inert placeholder instead of executing
        return _Inert(f"{module}.{name}")

    def persistent_load(self, pid):
        # zip: ('storage', type, key, location, numel)
        # legacy: ('storage', type, root_key, location, numel, view_metadata)
        if isinstance(pid, tuple) and pid and pid[0] == "storage":
            stype, key, _loc, numel = pid[1], pid[2], pid[3], pid[4]
            if not isinstance(stype, str):
                stype = getattr(stype, "__name__", str(stype))
            return _StorageRef(str(key), stype, int(numel))
        raise pickle.UnpicklingError(f"unsupported persistent id {pid!r}")


class _Inert:
    def __init__(self, name):
        self._name = name

    def __call__(self, *a, **k):
        return self

    def __repr__(self):
        return f"<inert {self._name}>"


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Read a torch ZIP (or legacy) checkpoint → {name: float32/raw array}."""
    if zipfile.is_zipfile(path):
        return _load_zip(path)
    return _load_legacy(path)


def _load_zip(path: str) -> Dict[str, np.ndarray]:
    zf = zipfile.ZipFile(path)
    pkl_name = next(n for n in zf.namelist() if n.endswith("data.pkl"))
    root = pkl_name[: -len("data.pkl")]
    obj = _SafeUnpickler(io.BytesIO(zf.read(pkl_name))).load()

    cache: Dict[str, np.ndarray] = {}

    def read_storage(key, dt, numel):
        if key not in cache:
            raw = zf.read(f"{root}data/{key}")
            cache[key] = np.frombuffer(raw, dtype=dt)
        return cache[key]

    return _flatten_state_dict(obj, read_storage)


def _load_legacy(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        data = f.read()
    buf = io.BytesIO(data)
    up = _SafeUnpickler(buf)
    magic = up.load()  # magic number
    up2 = _SafeUnpickler(buf)
    _protocol = up2.load()
    up3 = _SafeUnpickler(buf)
    _sys_info = up3.load()
    up4 = _SafeUnpickler(buf)
    obj = up4.load()
    # deserialized storage keys follow
    up5 = _SafeUnpickler(buf)
    keys = up5.load()
    storages: Dict[str, np.ndarray] = {}
    for key in keys:
        (numel,) = struct.unpack("<q", buf.read(8))
        # find dtype from tensors referencing this key (resolved lazily below)
        storages[str(key)] = (buf.tell(), numel)
        # itemsize unknown until a tensor references it — scan obj
        buf.seek(0, io.SEEK_CUR)
        # temporarily store; actual reading happens in read_storage
        itemsize = _find_itemsize(obj, str(key))
        buf.seek(numel * itemsize, io.SEEK_CUR)

    def read_storage(key, dt, numel):
        pos, n = storages[key]
        return np.frombuffer(data, dtype=dt, count=n, offset=pos)

    return _flatten_state_dict(obj, read_storage)


def _find_itemsize(obj, key) -> int:
    for t in _iter_tensors(obj):
        if t.storage_key == key:
            return _STORAGE_DTYPES[t.dtype_name].itemsize
    return 4


def _iter_tensors(obj):
    if isinstance(obj, _LazyTensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _iter_tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _iter_tensors(v)


def _flatten_state_dict(obj, read_storage) -> Dict[str, np.ndarray]:
    # checkpoints often wrap the state dict under 'state_dict'
    if isinstance(obj, dict) and "state_dict" in obj and isinstance(obj["state_dict"], dict):
        obj = obj["state_dict"]
    out: Dict[str, np.ndarray] = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            if isinstance(v, _LazyTensor):
                out[str(k)] = v.materialize(read_storage)
    return out
