"""The port's diffusers-name converters and the loader on diffusers-named
files, against ``sdtpu``.

Key lists: every tensor name of the full-width SD1.5 and SDXL UNets, the
SD1.5 and SDXL ControlNets, SD3.5-Medium's MMDiT and the Wan 2.1 VAE
(encoder included), written under diffusers names by
``sdtpu_torch.tools.diffusers_names``, go through the port's converters
and the JAX package's: the same name for every key (host Python on both
sides, so equal).  Files: ``tools/sd15_file.py``, ``sdxl_file.py``,
``sd3_file.py`` and ``wan_file.py`` write a module at a small config under
both namings from one seed; the port's loader reads the diffusers file to
the tensors of the original-names file, key for key and bit for bit, as
the JAX loader does (the Wan VAE aside: the JAX loader's test for the
diffusers layout misses it, and the port's reads it to what the JAX loader
gives for the original names).
"""
import dataclasses

import numpy as np
import pytest

import sdtpu.io.name_conversion as jnc
from sdtpu.io.model_loader import load_model_bundle as jax_load_model_bundle
from sdtpu_torch.config import SDVersion
from sdtpu_torch.factory import sd3_configs, unet_config_for, wan_configs
from sdtpu_torch.io import name_conversion as tnc
from sdtpu_torch.io.model_loader import load_model_bundle
from sdtpu_torch.models import controlnet as tcn
from sdtpu_torch.models import mmdit as tmmdit
from sdtpu_torch.models import unet as tu
from sdtpu_torch.models import wan_vae as twv
from sdtpu_torch.tools import diffusers_names as dn

KEY_LISTS = {
    "sd15_unet": (lambda: tu.param_specs(tu.SD1_UNET_CONFIG), dn.unet_name, "convert_diffusers_unet_name"),
    "sdxl_unet": (lambda: tu.param_specs(tu.SDXL_UNET_CONFIG), dn.unet_name, "convert_diffusers_unet_name"),
    "sd15_controlnet": (lambda: tcn.controlnet_specs(tu.SD1_UNET_CONFIG), dn.controlnet_name,
                        "convert_diffusers_controlnet_name"),
    "sdxl_controlnet": (lambda: tcn.controlnet_specs(tu.SDXL_UNET_CONFIG), dn.controlnet_name,
                        "convert_diffusers_controlnet_name"),
    "sd3.5_medium_mmdit": (lambda: tmmdit.param_specs(tmmdit.SD35_MEDIUM_CONFIG), dn.sd3_name,
                           "convert_diffusers_sd3_name"),
    "wan_vae": (lambda: twv.param_specs(decode_only=False), dn.wan_vae_name, "convert_diffusers_wan_vae_name"),
}


@pytest.mark.parametrize("kind", sorted(KEY_LISTS))
def test_converters_match_jax_key_for_key(kind):
    specs, rename, conv = KEY_LISTS[kind]
    specs = specs()
    names = dn.to_diffusers(specs, rename, getattr(tnc, conv))  # each reads back to its internal name
    flat = [d for parts in names.values() for d in parts]
    assert len(flat) >= len(specs) and len(set(flat)) == len(flat)
    ours, theirs = getattr(tnc, conv), getattr(jnc, conv)
    assert [ours(d) for d in flat] == [theirs(d) for d in flat]
    if "unet" in kind or "controlnet" in kind:  # canonicalize_name maps them under the UNet prefix
        assert [tnc.canonicalize_name(d) for d in flat] == [jnc.canonicalize_name(d) for d in flat]


def _same_diffusion(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def _write(kind, tmp_path):
    """(paths of the pair, the load_model_bundle kwargs of each, the module)."""
    from sdtpu_torch.tools import sd3_file, sd15_file, sdxl_file, wan_file

    if kind in ("sd15_unet", "sdxl_unet"):
        version = SDVersion.SD1 if kind == "sd15_unet" else SDVersion.SDXL
        cfg = dataclasses.replace(unet_config_for(version, small=True), num_res_blocks=2)
        tool = sd15_file if kind == "sd15_unet" else sdxl_file
        paths = tool.write_unet_files(tmp_path, device="cpu", cfg=cfg)["paths"]
        return {k: dict(diffusion_model_path=p) for k, p in paths.items()}, "diffusion"
    if kind == "sd3":
        paths = sd3_file.write_mmdit_files(tmp_path, device="cpu", depth=2, cfg=sd3_configs(True)[0])["paths"]
        return {k: dict(diffusion_model_path=p) for k, p in paths.items()}, "diffusion"
    dit_cfg = wan_configs(True)[0]  # the diffusers names number the Wan VAE's full layout
    vae_cfg = dataclasses.replace(twv.WAN21_VAE_CONFIG, dim=8)
    paths = wan_file.write_vae_files(tmp_path, device="cpu", cfg=vae_cfg, dit_cfg=dit_cfg)["paths"]
    return ({k: dict(diffusion_model_path=paths["dit"], vae_path=paths[k])
             for k in ("original", "diffusers")}, "vae")


@pytest.mark.parametrize("kind", ["sd15_unet", "sdxl_unet", "sd3", "wan_vae"])
def test_diffusers_files_load_as_the_original_names(kind, tmp_path):
    """The diffusers file loads to the original file's module, tensor for
    tensor (q, k and v fused back for SD3, the UNet's upsamplers placed
    after the block's attention), with the version and the tensors the JAX
    loader gives."""
    files, module = _write(kind, tmp_path)
    orig = load_model_bundle(**files["original"])
    got = load_model_bundle(**files["diffusers"])
    want = jax_load_model_bundle(**files["diffusers"])
    assert got.version == orig.version and got.version.value == want.version.value
    _same_diffusion(getattr(got, module), getattr(orig, module))
    if kind == "wan_vae":
        # the JAX loader's trigger finds the encoder's mid-block resnets and
        # leaves the file unconverted (the port's looks in its down blocks)
        assert "encoder.middle.0.residual.0.gamma" not in want.vae
        _same_diffusion(getattr(got, module), jax_load_model_bundle(**files["original"]).vae)
        return
    _same_diffusion(getattr(got, module), getattr(want, module))
