"""The foundation extractors, their checkpoint conversion and
``FoundationModule`` in the port against viscy_tpu.

- ``DinoViT`` and each wrapper with numpy-seeded flax weights carried
  across by ``dinovit_state_dict_from_flax`` /
  ``foundation_state_dict_from_flax``: max|d| <= 2e-3 of the range with
  Pearson r > 0.9999 (the port's parity bound), on and off the native
  grid, one and two channels, 5-D and 4-D inputs.
- The Hugging Face path three ways: a randomly initialized
  ``transformers.Dinov2Model``, the JAX ``DinoViT`` through JAX's
  ``convert_dinov2_state_dict``, and the port's through its own converter
  and ``load_state_dict``; a ``.safetensors`` file written by the
  ``safetensors`` library read by the port's reader bit for bit.
- A Hugging Face DINOv3 checkpoint does not convert, in JAX or here
  (learned positions against rotary embeddings and register tokens).
- ``viscy-torch predict`` with ``FoundationModule`` writes the AnnData store
  of ``predict_step`` on the same windows.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from viscy_tpu.apps.dynaclr import foundation_engine as jfe
from viscy_tpu.models.foundation import convert as jconv
from viscy_tpu.models.foundation import vit as jvit
from viscy_tpu.models.foundation import wrappers as jw
from viscy_tpu_torch.apps.dynaclr.foundation_engine import FoundationModule
from viscy_tpu_torch.models.foundation import convert as tconv
from viscy_tpu_torch.models.foundation import vit as tvit
from viscy_tpu_torch.models.foundation import wrappers as tw
from viscy_tpu_torch.training import cli
from viscy_tpu_torch.training.callbacks import embedding_writer as tew
from viscy_tpu_torch.training.compose import load_composed_config
from viscy_tpu_torch.training.convert import dinovit_state_dict_from_flax, foundation_state_dict_from_flax
from viscy_tpu_torch.training.trainer import BatchPrefetcher

from _torch_port_helpers import assert_rel_close, flax_params
from test_torch_port_embeddings import plate  # noqa: F401  (the DynaCLR plate and tracks fixture)

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
VIT = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2)
WRAP = dict(embed_dim=32, depth=1, num_heads=2)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _close(got, want, rel=2e-3):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert_rel_close(got, np.asarray(want), rel, 0.9999)


def _transformers():
    os.environ.setdefault("USE_TF", "0")
    os.environ["HF_HUB_OFFLINE"] = "1"
    return pytest.importorskip("transformers")


@pytest.mark.parametrize("size", [32, 48, 24], ids=["native", "larger", "smaller"])
def test_dinovit_matches_jax_on_and_off_the_native_grid(size):
    """At 32^2 the learned positions as they are; at 48^2 and 24^2 resized
    as ``jax.image.resize(..., "linear")`` resizes them (antialiased when
    they shrink)."""
    x = _x((2, size, size, 3), 1)
    jmod = jvit.DinoViT(**VIT)
    params = flax_params(jmod, 2, jnp.asarray(x))
    want = jax.jit(lambda p, a: jmod.apply({"params": p}, a))(params, jnp.asarray(x))
    tmod = tvit.DinoViT(**VIT).eval()
    tmod.load_state_dict(dinovit_state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    for k in ("cls", "patch_mean", "tokens"):
        _close(got[k], want[k])


def test_resize_linear_matches_jax_image_resize():
    """Up and down, with the antialiased triangle JAX widens by the scale."""
    x = _x((3, 17, 29, 2), 3)
    for shape in ((3, 31, 11, 2), (3, 8, 64, 2)):
        want = jax.image.resize(jnp.asarray(x), shape, "linear")
        got = tvit.resize_linear(torch.from_numpy(x), {1: shape[1], 2: shape[2]})
        _close(got, want, 1e-6)


WRAPPERS = [
    ("DINOv3Model", dict(resize_to=32), (2, 1, 5, 40, 40)),
    ("CellDinoModel", dict(img_size=28), (2, 2, 3, 64, 48)),
    ("CellDinoModel", dict(resize_to=28, feature="patch_mean"), (2, 1, 70, 70)),
    ("OpenPhenomModel", dict(resize_to=32), (2, 2, 3, 30, 30)),
    ("OpenPhenomModel", dict(resize_to=32), (2, 3, 36, 36)),
]


@pytest.mark.parametrize("name,kw,shape", WRAPPERS, ids=[f"{n}-{len(s)}d-{s[1]}ch" for n, _, s in WRAPPERS])
def test_wrappers_match_jax(name, kw, shape):
    """Preprocessing (center slice, min-max, RGB, resize, ImageNet) and the
    frozen backbone; OpenPhenom min-maxes and embeds each channel alone."""
    x = _x(shape, 4) * 3 + 1
    jmod = getattr(jw, name)(**WRAP, **kw)
    params = flax_params(jmod, 5, jnp.asarray(x))
    jf, jp = jax.jit(lambda p, a: jmod.apply({"params": p}, a))(params, jnp.asarray(x))
    tmod = getattr(tw, name)(**WRAP, **kw).eval()
    tmod.load_state_dict(foundation_state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        f, p = tmod(torch.from_numpy(x))
    _close(f, jf)
    _close(p, jp)
    assert not any(q.requires_grad for q in tmod.parameters())
    assert tmod.patch_size == (16 if name == "DINOv3Model" else 14)


def test_preprocess_matches_jax():
    for shape, r in (((2, 1, 5, 40, 40), 28), ((2, 2, 64, 48), 56), ((1, 4, 3, 20, 20), 16)):
        x = _x(shape, 6)
        want = jnp.transpose(jw._preprocess(jnp.asarray(x), r), (0, 3, 1, 2))
        _close(tw.preprocess(torch.from_numpy(x), r), want, 1e-5)


def test_foundation_module_predict_step_and_frozen_optimizer():
    """``predict_step`` against JAX's; the optimizer changes no parameter,
    gradients or not, as ``optax.set_to_zero()`` (the JAX engine's)."""
    jmod = jfe.FoundationModule(jw.CellDinoModel(**WRAP, patch_size=14, resize_to=28), (1, 1, 3, 48, 48))
    tmod = FoundationModule({"class_path": "viscy_tpu.models.foundation.wrappers.CellDinoModel",
                             "init_args": dict(**WRAP, patch_size=14, resize_to=28)}, (1, 1, 3, 48, 48),
                            device="cpu")
    assert tmod.example_input()["anchor"].shape == (1, 1, 3, 48, 48)
    x = _x((3, 1, 3, 48, 48), 7)
    params = flax_params(jmod.model, 8, jnp.asarray(x))
    want = jmod.predict_step({"params": jax.tree_util.tree_map(jnp.asarray, params)}, {"anchor": jnp.asarray(x)})
    tmod.model.load_state_dict(foundation_state_dict_from_flax(params), strict=True)
    tmod.eval()
    with torch.no_grad():
        got = tmod.predict_step({"anchor": torch.from_numpy(x)})
    assert set(got) == {"features", "projections"}
    for k in got:
        _close(got[k], want[k])
    before = {k: v.clone() for k, v in tmod.state_dict().items()}
    opt, sched, schedule = tmod.configure_optimizers(10)
    for p in tmod.parameters():
        p.grad = torch.ones_like(p)
    for _ in range(3):
        opt.step()
        sched.step()
    assert schedule(5) == 0.0
    for k, v in tmod.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(NotImplementedError):
        tmod.training_loss({"anchor": torch.from_numpy(x)})


@pytest.fixture(scope="module")
def hf_model():
    transformers = _transformers()
    cfg = transformers.Dinov2Config(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                                    intermediate_size=256, image_size=32, patch_size=8, layerscale_value=0.5,
                                    hidden_act="gelu")
    torch.manual_seed(0)
    return transformers.Dinov2Model(cfg).eval()


def test_hf_dinov2_three_ways(hf_model, tmp_path):
    """HF's ``Dinov2Model``, JAX's ``DinoViT`` after JAX's converter, the
    port's after its converter and ``load_state_dict``: the same tokens, on
    the native grid and off it (where HF's bicubic position resize differs
    from ``jax.image.resize``'s linear, so only JAX and the port agree)."""
    x = _x((2, 3, 32, 32), 9)
    with torch.no_grad():
        ref = hf_model(torch.from_numpy(x)).last_hidden_state.numpy()
    sd = hf_model.state_dict()
    jparams = jconv.convert_dinov2_state_dict(sd, depth=2, num_heads=2)
    jmod = jvit.DinoViT(**VIT)
    tmod = tvit.DinoViT(**VIT).eval()
    tmod.load_state_dict(tconv.convert_dinov2_state_dict(sd, depth=2, num_heads=2), strict=True)
    for size in (32, 40):
        xs = _x((2, 3, size, size), 10 + size)
        want = jmod.apply({"params": jparams}, jnp.asarray(xs.transpose(0, 2, 3, 1)))["tokens"]
        with torch.no_grad():
            got = tmod(torch.from_numpy(xs))["tokens"]
        _close(got, want)
    with torch.no_grad():
        _close(tmod(torch.from_numpy(x))["tokens"], ref, 1e-5)
    # checkpoints on disk: a directory of save_pretrained, a .bin, a .safetensors
    hf_model.save_pretrained(tmp_path / "ckpt")
    torch.save(sd, tmp_path / "w.bin")
    for path in (tmp_path / "ckpt", tmp_path / "w.bin", tmp_path / "ckpt" / "model.safetensors"):
        loaded = tconv.load_dinov2_checkpoint(path, depth=2, num_heads=2)
        assert set(loaded) == set(tmod.state_dict())
        for k, v in loaded.items():
            assert torch.equal(v, sd[k]), (path, k)


def test_safetensors_reader_is_bit_exact(tmp_path):
    safetensors_torch = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g), "b": torch.randn(7, generator=g).to(torch.float16),
               "c": torch.randn(2, 2, 2, generator=g).to(torch.bfloat16), "d": torch.arange(6).reshape(2, 3),
               "e": torch.randn(4, generator=g).double(), "f": torch.tensor([True, False]),
               "g": torch.zeros((0, 3))}
    safetensors_torch.save_file(tensors, tmp_path / "t.safetensors", metadata={"format": "pt"})
    got = tconv.read_safetensors(tmp_path / "t.safetensors")
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        assert torch.equal(got[k].view(torch.uint8) if v.numel() else got[k], v.view(torch.uint8) if v.numel()
                           else v), k


def test_conversion_refusals_and_the_dinov3_checkpoint_fault(hf_model):
    """The port's converter refuses a wrong depth or head count and unknown
    keys by name. A Hugging Face DINOv3 checkpoint (rotary positions,
    register tokens, ``layer.{i}.attention.q_proj``) converts in neither
    package: JAX's ``DINOv3Model`` is a DINOv2 ViT at patch 16."""
    sd = hf_model.state_dict()
    with pytest.raises(ValueError, match="depth"):
        tconv.convert_dinov2_state_dict(sd, depth=3, num_heads=2)
    with pytest.raises(ValueError, match="num_heads"):
        tconv.convert_dinov2_state_dict(sd, depth=2, num_heads=3)
    with pytest.raises(KeyError, match="pooler"):
        tconv.convert_dinov2_state_dict({**sd, "pooler.dense.weight": torch.zeros(1)}, depth=2, num_heads=2)
    transformers = _transformers()
    cfg = transformers.DINOv3ViTConfig(hidden_size=64, num_hidden_layers=1, num_attention_heads=2,
                                       intermediate_size=256, image_size=32, patch_size=16, num_register_tokens=4)
    v3 = transformers.DINOv3ViTModel(cfg).state_dict()
    assert "embeddings.position_embeddings" not in v3 and "embeddings.register_tokens" in v3
    with pytest.raises(KeyError):
        jconv.convert_dinov2_state_dict(v3, depth=1, num_heads=2)
    with pytest.raises(KeyError, match="register_tokens"):
        tconv.convert_dinov2_state_dict(v3, depth=1, num_heads=2)


def test_foundation_predict_through_the_cli(plate, tmp_path):  # noqa: F811
    """``viscy-torch predict`` of ``configs/dynaclr_predict.yml`` with its
    model replaced by ``FoundationModule(DINOv3Model)`` (narrow, on the
    CPU) and no checkpoint: the AnnData store equals ``predict_step`` on
    the same windows, bit for bit."""
    root, plate_path = plate
    cfg = load_composed_config(ROOT / "configs/dynaclr_predict.yml")
    cfg["model"] = {"class_path": "dynaclr.FoundationModule", "init_args": {
        "model": {"class_path": "viscy_models.DINOv3Model", "init_args": dict(**WRAP, resize_to=32)},
        "example_input_array_shape": [1, 2, 10, 32, 32], "device": "cpu"}}
    cfg["data"]["init_args"].update(data_path=str(plate_path), tracks_path=str(root / "tracks"), z_range=[1, 11],
                                    initial_yx_patch_size=[32, 32], final_yx_patch_size=[32, 32], batch_size=16,
                                    predict_cells=False)
    store = tmp_path / "emb.zarr"
    cfg["trainer"] = {"device": "cpu", "default_root_dir": str(tmp_path / "pred"), "callbacks": [
        {"class_path": "viscy_utils.callbacks.EmbeddingWriter", "init_args": {"output_path": str(store)}}]}
    cfg.pop("ckpt_path")
    (tmp_path / "p.yml").write_text(yaml.safe_dump(cfg))
    trainer = cli.main(["predict", "-c", str(tmp_path / "p.yml")])
    dm = trainer._active_datamodule
    module = FoundationModule(tw.DINOv3Model(**WRAP, resize_to=32), device="cpu").eval()
    feats = []
    with torch.inference_mode():
        for batch in BatchPrefetcher(dm.predict_dataloader(), torch.device("cpu")):
            if dm.predict_device_transform:
                batch = dm.device_transform(batch, None, "predict")
            feats.append(module.predict_step(batch)["features"].numpy())
    got = tew.read_embedding_dataset(store)
    assert got.X.shape == (len(dm.predict_dataset), 32) and got.n_obs >= 20
    np.testing.assert_array_equal(got.X, np.concatenate(feats))
