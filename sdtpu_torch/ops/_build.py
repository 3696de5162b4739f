"""Build and bind the port's CUDA kernels.

The sources in ``sdtpu_torch/csrc`` are compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and linked into
one shared library with a plain C interface, loaded with ``ctypes``.  The build happens on first use, into
``build/sdtpu_torch_kernels/<hash>/`` beside the package, keyed on a hash of
the sources and flags, so a second process reuses it.  Nothing here runs at
import time: the CPU tests import every module of the port.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "sdtpu_torch_kernels"
LIB_NAME = "libsdtpu_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

# dtype codes of the C entry points (csrc/common.cuh, enum DType)
DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # dtype, q, k, v, bias, out, workspace, bh, lq, lk, d, scale, stream
    "sdtpu_flash_attention": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # dtype, x, xq, sx, m, k, stream
    "sdtpu_w8a8_quantize_rows": (_I, _P, _P, _P, _I, _I, _P),
    # dtype, x, xq, wq, sx, sw, out, m, n, k, stream
    "sdtpu_w8a8_matmul": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # dtype, x, packed, scale, out, m, n, k, kp, group, stream
    "sdtpu_q4_matmul": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # dtype, x, q, scale, out, m, n, k, kp, group, stream
    "sdtpu_gq_matmul": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "sdtpu_gq_matmul_ws": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # dtype, x, q, scale, zero, out, m, n, k, kp, group, stream
    "sdtpu_gq_zero_matmul": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # dtype, x, q, scale, out, m, n, k, stream
    "sdtpu_w8a16_matmul": (_I, _P, _P, _P, _P, _I, _I, _I, _P),
}
# entry points that return a value rather than a cudaError_t
QUERIES = {
    # dtype, bh, lq, lk, d -> bytes of f32 scratch
    "sdtpu_flash_workspace_bytes": ((_I, _I, _I, _I, _I), ctypes.c_longlong),
    # dtype, bh, lq, lk, d -> the key splits the call runs (1: not split)
    "sdtpu_flash_splits": ((_I, _I, _I, _I, _I), ctypes.c_longlong),
    # m, n -> x rows per block of the 4-bit wgmma kernel (0: another form runs)
    "sdtpu_q4_tile_rows": ((_I, _I), ctypes.c_longlong),
    # m, k -> the W8A8 form: 0 the GEMV, 1 the split-K form, 2 the wgmma kernel
    "sdtpu_w8a8_form": ((_I, _I), ctypes.c_longlong),
    # m, n, k -> splits of K of the W8A8 split-K form (0: another form runs)
    "sdtpu_w8a8_splits": ((_I, _I, _I), ctypes.c_longlong),
    # dtype, m -> the 4-bit form for m rows: 0 the GEMV, 1 the split-K form,
    # 2 the wgmma kernel, 3 the float32 kernel
    "sdtpu_q4_form": ((_I, _I), ctypes.c_longlong),
    # m, n, k -> splits of K of the 4-bit split-K form, bf16 (0: another form runs)
    "sdtpu_q4_splits": ((_I, _I, _I), ctypes.c_longlong),
    # m, n -> x rows per block of the float32 form of the 4-bit and int8 matmuls
    "sdtpu_f32_tile_rows": ((_I, _I), ctypes.c_longlong),
    # dtype, mode (0 group, 1 affine, 2 W8A16), m -> the group-dequant form:
    # 0 the GEMV, 1 the mma.sync form, 2 the wgmma kernel, 3 the float32
    # kernel, 4 the split-K form
    "sdtpu_gq_form": ((_I, _I, _I), ctypes.c_longlong),
    # m, n, k -> splits of K of the group / W8A16 split-K form, bf16 (0:
    # another form runs)
    "sdtpu_gq_splits": ((_I, _I, _I), ctypes.c_longlong),
}


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return str(path)


def build(out_dir: Path) -> Path:
    """Compile every ``csrc/*.cu`` into ``out_dir/LIB_NAME``: one ``nvcc -c``
    per source, run in parallel, then one link.  The compilers' output
    (ptxas register and spill counts) goes to ``out_dir/build.log``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    nvcc = _nvcc()
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [out_dir / f"{p.stem}.{tag}.o" for p in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for p, o in zip(srcs, objs)]
    logs, failed = [], []
    for p, proc in zip(srcs, procs):
        out, _ = proc.communicate()
        logs.append(f"== {p.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{p.name} (code {proc.returncode}):\n{out[-6000:]}")
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    if not failed:
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        logs.append(f"== link\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append(f"link (code {res.returncode}):\n{res.stderr[-6000:]}")
    for o in objs:
        o.unlink(missing_ok=True)
    (out_dir / "build.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    lib = out_dir / LIB_NAME
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built on first use (once per source hash)."""
    lib_path = build_dir() / LIB_NAME
    if not lib_path.exists():
        build(lib_path.parent)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    for name, (argtypes, restype) in QUERIES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    lib.sdtpu_error_string.argtypes = [ctypes.c_int]
    lib.sdtpu_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call one C entry point and raise if the launch was refused."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.sdtpu_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def query(name: str, *args) -> int:
    """Call one C entry point of ``QUERIES`` and return its value."""
    return getattr(library(), name)(*args)


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Validate what the kernels assume: CUDA, contiguous, 16-byte aligned."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor must be 16-byte aligned")
