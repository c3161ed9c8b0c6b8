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
        fcmae_state_dict_from_flax({"head": {"conv0": {"kernel": np.zeros((3, 3, 3, 1, 1))}}})
    with pytest.raises(KeyError):
        fcmae_state_dict_from_flax({"encoder": {"stem": {"norm": {"gamma": np.zeros(3)}}}})


def test_port_imports_no_jax_flax_or_viscy_tpu():
    """Import every viscy_tpu_torch module and chip_smoke.py in a fresh
    interpreter; whatever the environment pre-imports, they must add none
    of these."""
    code = """
import importlib, pkgutil, sys
before = set(sys.modules)
import viscy_tpu_torch
for m in pkgutil.walk_packages(viscy_tpu_torch.__path__, "viscy_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
added = set(sys.modules) - before
bad = sorted(n for n in added if n.split(".")[0] in ("jax", "jaxlib", "flax", "viscy_tpu"))
print("MODULES", len([n for n in added if n.startswith("viscy_tpu_torch")]))
print("BAD", bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines() if line.startswith(("MODULES", "BAD")))
    assert int(lines["MODULES"]) >= 15
    assert lines["BAD"] == "[]"


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
    with pytest.raises(NotImplementedError):
        VSUNet("fcmae", dict(NARROW, pretraining=True), device="cpu")
    with pytest.raises(NotImplementedError):
        FullyConvolutionalMAE(**dict(NARROW, head_conv=True))
    with pytest.raises(ValueError):
        VSUNet("UNeXt2", dict(NARROW), device="cpu")
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
