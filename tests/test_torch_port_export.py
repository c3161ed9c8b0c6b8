"""``viscy-torch export`` against viscy_tpu's forward (the pattern of
``tests/test_export.py``).

A two-stage FCMAE (total stride 8) with seeded JAX weights carried across
by the weight bridge. ``format: stablehlo`` writes a ``torch.export``
program: through the CLI with ``embed_params: true`` and the weights from
``export.ckpt_path`` (called as ``fn(x)``), and through ``export_model``
with ``embed_params: false`` (called as ``fn(state_dict, x)``). Loaded with
``load_exported``, each runs at two batch sizes and two YX multiples of the
stride and agrees with JAX's forward to 2e-3 of the range with Pearson r >
0.9999 (the repo's torch-parity bound), and with the port's eager forward
bit for bit. ``format: orbax`` writes the reference-named state_dict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from viscy_tpu.models.unet.fcmae import FullyConvolutionalMAE as JFCMAE
from viscy_tpu_torch.apps.cytoland.engine import VSUNet
from viscy_tpu_torch.training import cli
from viscy_tpu_torch.training.convert import load_flax_params
from viscy_tpu_torch.training.export import export_model, load_exported

from _torch_port_helpers import assert_rel_close, flax_params

TWO_STAGE = dict(in_channels=1, out_channels=1, encoder_blocks=(1, 1), dims=(8, 16), decoder_conv_blocks=1,
                 stem_kernel_size=(5, 4, 4), in_stack_depth=5, pretraining=False)
SHAPES = [(1, 1, 5, 32, 32), (3, 1, 5, 48, 64)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("export")
    jmodel = JFCMAE(**TWO_STAGE)
    params = flax_params(jmodel, 3, jnp.zeros((1, 1, 5, 32, 32)))
    apply = jax.jit(lambda x: jmodel.apply({"params": params}, x))
    inputs = [np.random.default_rng(i).random(s, np.float32) for i, s in enumerate(SHAPES)]
    want = [np.asarray(apply(jnp.asarray(x))) for x in inputs]
    module = VSUNet("fcmae", dict(TWO_STAGE), device="cpu", example_input_yx_shape=(32, 32))
    load_flax_params(module.model, params)
    assert module.model.total_stride == 8
    return tmp, module, inputs, want


def _check(fn, module, inputs, want, state=None):
    for x, w in zip(inputs, want):
        xt = torch.from_numpy(x)
        got = fn(xt) if state is None else fn(state, xt)
        assert tuple(got.shape) == w.shape
        assert_rel_close(got.detach().numpy(), w, 2e-3, 0.9999)
        with torch.no_grad():
            assert torch.equal(got.detach(), module.forward(xt))


def test_cli_export_with_embedded_weights_from_a_checkpoint(setup):
    tmp, module, inputs, want = setup
    ckpt = tmp / "weights.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in module.model.state_dict().items()}}, ckpt)
    out = tmp / "model.pt2"
    cfg = {"model": {"class_path": "cytoland.engine.VSUNet",
                     "init_args": {"architecture": "fcmae", "seed": 123, "example_input_yx_shape": [32, 32],
                                   "model_config": {k: list(v) if isinstance(v, tuple) else v
                                                    for k, v in TWO_STAGE.items()}}},
           "trainer": {"device": "cpu", "default_root_dir": str(tmp / "run")},
           "export": {"export_path": str(out), "ckpt_path": str(ckpt), "embed_params": True}}
    (tmp / "export.yml").write_text(yaml.safe_dump(cfg))
    cli.main(["export", "-c", str(tmp / "export.yml")])
    assert out.stat().st_size > 0
    _check(load_exported(out), module, inputs, want)


def test_export_with_the_state_dict_as_an_input(setup):
    tmp, module, inputs, want = setup
    out = export_model(module, {"export_path": str(tmp / "state.pt2")})
    state = {k: v.detach() for k, v in module.model.state_dict().items()}
    _check(load_exported(out), module, inputs, want, state=state)


def test_orbax_format_writes_the_state_dict(setup):
    tmp, module, _, _ = setup
    out = export_model(module, {"format": "orbax", "export_path": str(tmp / "params.pt")})
    saved = torch.load(out, weights_only=True)
    state = module.model.state_dict()
    assert saved.keys() == state.keys() and all(torch.equal(saved[k], state[k]) for k in state)
    with pytest.raises(ValueError, match="onnx"):
        export_model(module, {"format": "onnx", "export_path": str(tmp / "x")})
