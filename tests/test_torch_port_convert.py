"""Weight bridge, state-dict layout, device handling and import isolation
of viscy_tpu_torch.

The port's ``state_dict`` must equal the reference VisCy inventory (so a
released checkpoint loads with ``strict=True``), and flax params carried
into the port and back through ``viscy_tpu``'s own converter must come
back bit for bit.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu.models.unet.fcmae import FullyConvolutionalMAE as JFCMAE
from viscy_tpu.training.convert import convert_fcmae_state_dict
from viscy_tpu.training.state_dict_inventory import fcmae_state_dict_inventory
from viscy_tpu_torch.apps.cytoland.engine import VSUNet
from viscy_tpu_torch.device import resolve_device
from viscy_tpu_torch.models.unet.fcmae import FullyConvolutionalMAE
from viscy_tpu_torch.training.convert import fcmae_state_dict_from_flax, load_flax_params

from _torch_port_helpers import NARROW, flax_params

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP = dict(NARROW, encoder_blocks=(3, 3, 9, 3), dims=(96, 192, 384, 768))


def _inventory(cfg):
    keys = ("in_channels", "out_channels", "encoder_blocks", "dims", "stem_kernel_size",
            "in_stack_depth", "decoder_conv_blocks")
    return fcmae_state_dict_inventory(**{k: cfg[k] for k in keys})


@pytest.mark.parametrize("cfg", [NARROW, FLAGSHIP], ids=["narrow", "flagship"])
def test_port_state_dict_equals_reference_inventory(cfg):
    sd = FullyConvolutionalMAE(**cfg).state_dict()
    inv = _inventory(cfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v) for k, v in inv.items()}
    assert all(v.dtype == torch.float32 for v in sd.values())


@pytest.fixture(scope="module")
def narrow_flax():
    return flax_params(JFCMAE(**NARROW), 21, jnp.zeros((1, 1, 15, 32, 32)))


def test_bridge_loads_strict_and_keeps_unbridged_stem_conv2d(narrow_flax):
    model = FullyConvolutionalMAE(**NARROW, generator=torch.Generator().manual_seed(5))
    conv2d = model.encoder.stem.conv2d.weight.detach().clone()
    bridged = fcmae_state_dict_from_flax(narrow_flax)
    assert set(model.state_dict()) - set(bridged) == {
        "encoder.stem.conv2d.weight", "encoder.stem.conv2d.bias"
    }
    load_flax_params(model, narrow_flax)
    sd = model.state_dict()
    for k, v in bridged.items():
        assert torch.equal(sd[k], v), k
    assert torch.equal(model.encoder.stem.conv2d.weight, conv2d)
    # the full dict (bridge + the seeded conv2d) loads with strict=True
    FullyConvolutionalMAE(**NARROW).load_state_dict(sd, strict=True)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def test_bridge_round_trips_through_jax_converter(narrow_flax):
    model = FullyConvolutionalMAE(**NARROW)
    load_flax_params(model, narrow_flax)
    back = _flat(convert_fcmae_state_dict({k: v.numpy() for k, v in model.state_dict().items()}))
    orig = _flat(narrow_flax)
    assert set(back) - set(orig) == {"encoder/stem/conv2d/kernel", "encoder/stem/conv2d/bias"}
    assert set(orig) <= set(back)
    for k, v in orig.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_bridge_rejects_unknown_leaves(narrow_flax):
    with pytest.raises(KeyError):
        # head/conv0 and conv1 are PixelToVoxelHead's (head_conv=True); no head has a conv2
        fcmae_state_dict_from_flax({"head": {"conv2": {"kernel": np.zeros((3, 3, 3, 1, 1))}}})
    with pytest.raises(KeyError):
        fcmae_state_dict_from_flax({"encoder": {"stem": {"norm": {"gamma": np.zeros(3)}}}})


def test_port_imports_no_jax_flax_or_viscy_tpu():
    """Import every viscy_tpu_torch module and chip_smoke.py in a fresh
    interpreter, and resolve every name of ``viscy_tpu.transforms.__all__``
    through ``resolve_class`` under both reference spellings
    (``viscy_transforms.X`` and ``viscy.transforms.X``, the MONAI names
    lazily), the JAX host transforms and the normalize helpers, and the JAX
    class paths of the sampler, ``CELLDiff3DVS``, the foundation models and
    engine and the concatenated, combined, CTMC-v1, classification and
    cell-division datamodules (module paths and the packages' exports);
    whatever the environment pre-imports, they must add none of these, nor
    the packages the card's machine lacks: the zarr stacks (tensorstore,
    zarr, numcodecs), PIL, tifffile, tensorboardX, tensorboard (and
    TensorFlow), pandas, sklearn, anndata, wandb, transformers and
    safetensors. (yaml, click and scipy are on that machine.)"""
    from viscy_tpu import transforms as jax_transforms
    from viscy_tpu.data import host_transforms as jax_host
    from viscy_tpu.preprocess import normalize as jax_pre
    from viscy_tpu.training import normalize as jax_train

    names = {
        "transforms": [f"{p}.{n}" for n in jax_transforms.__all__ for p in ("viscy_transforms", "viscy.transforms")],
        "host": [f"viscy_tpu.data.host_transforms.{n}" for n in ("HostNormalizeIntensityd",
                 "HostScaleIntensityRangePercentilesd", *jax_host.__all__)],
        "functions": [f"viscy_tpu.preprocess.normalize.{n}" for n in (*jax_pre.__all__, "hist_adapteq_2D")]
        + [f"viscy_tpu.training.normalize.{n}" for n in jax_train.__all__],
        "slice18": [
            "viscy_tpu.models.celldiff.transport.Sampler", "viscy_tpu.models.celldiff.Sampler",
            "viscy_tpu.apps.dynacell.celldiff_wrapper.CELLDiff3DVS", "dynacell.CELLDiff3DVS",
            "viscy_tpu.apps.dynacell.celldiff_wrapper.trajectory_sampler",
            "viscy_tpu.models.foundation.vit.DinoViT", "viscy_tpu.models.foundation.vit.ViTBlock",
            "viscy_tpu.models.foundation.convert.convert_dinov2_state_dict",
            "viscy_tpu.models.foundation.convert.load_dinov2_checkpoint",
            *(f"viscy_tpu.models.foundation.wrappers.{n}" for n in ("DINOv3Model", "CellDinoModel",
                                                                     "OpenPhenomModel")),
            "viscy_tpu.models.foundation.DinoViT", "viscy_models.DINOv3Model", "viscy_models.OpenPhenomModel",
            "viscy_tpu.apps.dynaclr.foundation_engine.FoundationModule", "dynaclr.FoundationModule",
            "viscy_tpu.data.channel_utils.ChannelMetadata", "viscy_tpu.data.channel_utils.parse_channel_name",
            *(f"viscy_data.{n}" for n in ("ChannelDropout", "CombineMode", "CombinedDataModule", "ConcatDataModule",
                                          "BatchedConcatDataModule", "BatchedConcatDataset",
                                          "CachedConcatDataModule", "CTMCv1DataModule",
                                          "CellDivisionTripletDataModule", "CellDivisionTripletDataset",
                                          "ClassificationDataModule", "ClassificationDataset")),
            "viscy_tpu.data.ctmc_v1.CTMCv1Dataset", "viscy_tpu.data.combined.ConcatDataModule",
            "viscy_tpu.data.channel_dropout.ChannelDropout",
            "viscy_tpu.data.cell_classification.ClassificationDataModule",
            "viscy_tpu.data.cell_division_triplet.CellDivisionTripletDataModule",
        ],
    }
    assert len(names["transforms"]) == 2 * 57 and len(names["host"]) == 12
    code = f"""
import importlib, pkgutil, sys
before = set(sys.modules)
from viscy_tpu_torch.training.instantiate import resolve_class
names = {names!r}
resolved = [resolve_class(n) for group in names.values() for n in group]
print("RESOLVED", len(resolved), sum(r.__module__.startswith("viscy_tpu_torch.") for r in resolved))
import viscy_tpu_torch
for m in pkgutil.walk_packages(viscy_tpu_torch.__path__, "viscy_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
added = set(sys.modules) - before
bad = sorted(n for n in added if n.split(".")[0] in ("jax", "jaxlib", "flax", "viscy_tpu", "tensorstore",
                                                    "zarr", "numcodecs", "PIL", "tifffile", "tensorboardX",
                                                    "tensorboard", "tensorflow", "pandas", "wandb", "sklearn",
                                                    "anndata", "transformers", "safetensors"))
print("MODULES", len([n for n in added if n.startswith("viscy_tpu_torch")]))
print("BAD", bad)
print("CELLDIFF", sorted(n for n in added if n.startswith(("viscy_tpu_torch.models.celldiff.",
      "viscy_tpu_torch.models.unet.unet3d", "viscy_tpu_torch.models.components.conv_blocks",
      "viscy_tpu_torch.apps.dynacell.engine"))))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("MODULES", "BAD", "CELLDIFF", "RESOLVED")))
    n = sum(len(group) for group in names.values())
    assert lines["RESOLVED"] == f"{n} {n}"
    assert int(lines["MODULES"]) >= 98
    assert lines["BAD"] == "[]"
    assert lines["CELLDIFF"] == str([
        "viscy_tpu_torch.apps.dynacell.engine", "viscy_tpu_torch.models.celldiff.celldiff_net",
        "viscy_tpu_torch.models.celldiff.paths", "viscy_tpu_torch.models.celldiff.transport",
        "viscy_tpu_torch.models.celldiff.vit_bottleneck", "viscy_tpu_torch.models.components.conv_blocks",
        "viscy_tpu_torch.models.unet.unet3d", "viscy_tpu_torch.models.unet.unet3d_base"])


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        VSUNet("fcmae", dict(NARROW), device="cuda")
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        VSUNet("fcmae", dict(NARROW), fov_shard=True, device="cpu")
    # masked pretraining is ported: the module builds and returns (pred, mask)
    pre = VSUNet("fcmae", dict(NARROW, pretraining=True), device="cpu")
    x = torch.rand((1, 1, 15, 64, 64), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        pred, mask = pre.model(x, mask_ratio=0.5, mask_generator=torch.Generator().manual_seed(1))
    assert pred.shape == (1, 2, 15, 64, 64) and mask.shape == (1, 1, 64, 64) and float(mask.float().mean()) == 0.5
    # head_conv=True builds with PixelToVoxelHead; "UNeXt2" builds the UNeXt2 model (both held
    # against JAX in tests/test_torch_port_unext2.py); an unknown architecture still raises
    head = FullyConvolutionalMAE(**dict(NARROW, head_conv=True)).head
    assert type(head).__name__ == "PixelToVoxelHead" and "conv.0.adn.A.weight" in head.state_dict()
    unext2 = VSUNet("UNeXt2", dict(in_stack_depth=5, backbone="convnextv2_test"), device="cpu")
    assert type(unext2.model).__name__ == "UNeXt2" and "pretraining" not in unext2.model_config
    with torch.no_grad():
        assert unext2.model(torch.zeros((1, 1, 5, 64, 64))).shape == (1, 1, 5, 64, 64)
    with pytest.raises(ValueError):
        VSUNet("UNeXt3", dict(NARROW), device="cpu")
    # "UNeXt2_2D" forces pretraining off, as in the JAX engine
    m = VSUNet("UNeXt2_2D", dict(NARROW, pretraining=True, fused_mlp=False), device="cpu")
    assert m.model.total_stride == 32


def test_chip_smoke_fails_without_the_package(tmp_path):
    """Alone in a directory (or without a card) the script exits non-zero
    and prints no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                         cwd=tmp_path, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
