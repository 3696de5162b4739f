"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and builds nothing at import.

Every module of ``sdtpu_torch``, and ``chip_smoke.py``, is imported in a
fresh interpreter whose ``sys.meta_path`` refuses ``jax``, ``jaxlib`` and
``sdtpu`` (the JAX package; ``sdtpu_torch`` is another name); the CUDA
binding's table of C entry points is checked against the kernel sources,
since the kernels themselves compile only where ``nvcc`` is installed.
"""
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "sdtpu_torch"
REFUSED = ("jax", "jaxlib", "sdtpu")


def _modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_with_jax_blocked():
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, sys

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {REFUSED!r}:
                    raise ImportError(f"refused: {{name}}")
                return None

        sys.meta_path.insert(0, Refuse())
        for mod in {_modules()!r} + ["chip_smoke"]:
            importlib.import_module(mod)
        assert not any(m.split(".")[0] in {REFUSED!r} for m in sys.modules)
        from sdtpu_torch.ops import _build
        assert _build.library.cache_info().currsize == 0  # nothing built at import
        print("ok", len({_modules()!r}))
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.startswith("ok")


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|sdtpu)\b(?!_)", re.M)
    sources = [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]
    offenders = [str(p) for p in sources if pat.search(p.read_text())]
    assert offenders == []
    assert pat.search("from sdtpu.io import gguf") and pat.search("  import jax.numpy as jnp")
    assert not pat.search("from sdtpu_torch.io import gguf")


def test_tokenizer_data_is_the_ports_own():
    from sdtpu_torch.tokenizers import clip

    data = PKG / "tokenizers" / "data" / "clip_merges.txt.gz"
    assert data.is_file()
    assert "sdtpu_torch" in clip.__file__ and "sdtpu/" not in clip.__file__


def _c_entry_points():
    """name → number of parameters of every ``extern "C" int`` in csrc."""
    src = "\n".join(p.read_text() for p in sorted((PKG / "csrc").glob("*.cu")))
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
        out[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
    return out


def test_binding_table_matches_kernel_sources():
    from sdtpu_torch.ops import _build

    entries = _c_entry_points()
    for name, argtypes in _build.SIGNATURES.items():
        assert name in entries, f"{name} has no extern \"C\" definition in csrc"
        assert entries[name] == len(argtypes), name


@pytest.mark.parametrize("stem", ["flash_attention", "w8a8_matmul", "q4_matmul", "gq_matmul"])
def test_kernel_source_names_the_tpu_kernel_it_replaces(stem):
    head = (PKG / "csrc" / f"{stem}.cu").read_text()[:3000]
    assert "Replaces the TPU kernel" in head
    assert "What bounds it on the card" in head


def test_source_hash_keys_the_build():
    from sdtpu_torch.ops import _build

    assert _build.source_hash() == _build.source_hash()
    assert {p.name for p in _build.sources()} >= {"flash_attention.cu", "w8a8_matmul.cu",
                                                  "q4_matmul.cu", "gq_matmul.cu", "common.cuh"}
    assert _build.build_dir().parent == REPO / "build" / "sdtpu_torch_kernels"


def test_the_gguf_loader_is_among_the_checked_modules():
    assert {"sdtpu_torch.loader", "sdtpu_torch.ops.quant"} <= set(_modules())
    assert "sdtpu_gq_matmul_ws" in _c_entry_points()
