"""The port's embedding store, PCA, ``convert_to_anndata``, the DynaCLR
command line and the auxiliary heads against viscy_tpu.

- Stores: the JAX reader reads the port's AnnData zarr store with equal
  contents; the port reads a store the JAX module wrote with its
  uncompressed ``_write_array`` and refuses a blosc one by name.
- PCA: within 1e-5 of the range of the JAX writer's (sklearn's ``full``
  solver, float32) at 200 rows.
- ``convert_to_anndata``: the same contents as JAX's on the same input.
- ``cli.main`` fit -> predict -> convert_to_anndata through
  ``configs/dynaclr_fit.yml`` and ``configs/dynaclr_predict.yml`` on the
  CPU, the encoder narrowed and the paths overridden here: the store
  against ``predict_step`` on the same windows, bit for bit.
- Auxiliary heads: the engine's loss and every gradient (heads included)
  against JAX's ``ContrastiveModule`` with the same seeded weights, carried
  across by ``contrastive_state_dict_from_flax``: within 2e-3 of the range
  and r > 0.9999, the port's parity bound.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from viscy_tpu.apps.dynaclr import engine as jdyn
from viscy_tpu.evaluation import anndata_lite as jad
from viscy_tpu.models.components import heads as jheads
from viscy_tpu.models.contrastive import loss as jloss
from viscy_tpu.preprocess.precompute import convert_to_anndata as j_convert
from viscy_tpu.training.callbacks import embedding_writer as jew
from viscy_tpu_torch.apps.dynaclr import engine as tdyn
from viscy_tpu_torch.evaluation import anndata_lite as tad
from viscy_tpu_torch.models.contrastive import loss as tloss
from viscy_tpu_torch.preprocess.precompute import convert_to_anndata
from viscy_tpu_torch.training import cli
from viscy_tpu_torch.training.callbacks import embedding_writer as tew
from viscy_tpu_torch.training.convert import contrastive_state_dict_from_flax, load_flax_params
from viscy_tpu_torch.training.trainer import read_checkpoint
from viscy_tpu_torch.zarr_io.store import UnsupportedCodecError, open_ome_zarr
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

from _torch_port_helpers import assert_rel_close, rel_err, seeded_params
from test_torch_port_contrastive import TINY, _batch, _jvars, _variables
from test_torch_port_triplet import _write_tracks

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


def _index(n: int, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [dict(fov_name=f"/A/{1 + i % 2}/{i % 3}/", track_id=int(rng.integers(0, 200)), t=i % 4, id=i,
                 parent_track_id=-1, parent_id=-1, y=int(rng.integers(0, 90)), x=int(rng.integers(0, 90)))
            for i in range(n)]


def _embeddings(n: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    feats = (rng.normal(0, 1, (n, 24)) @ rng.normal(0, 1, (24, 24))).astype(np.float32)
    return feats, rng.normal(0, 1, (n, 6)).astype(np.float32)


def _same_obs(got: tad.Frame, want) -> None:
    assert got.names == list(want.columns)
    assert got.index.tolist() == list(want.index)
    for c in want.columns:
        assert got[c].tolist() == want[c].tolist(), c


def test_the_jax_reader_reads_the_port_store(tmp_path):
    feats, proj = _embeddings(40)
    tew.write_embedding_dataset(tmp_path / "e.zarr", feats, _index(40), projections=proj, compute_pca=True,
                                pca_components=5, uns_metadata={"data_path": "/d/plate.zarr", "tracks_path": "/t"})
    meta = json.loads((tmp_path / "e.zarr/X/.zarray").read_text())
    assert meta["compressor"] is None and meta["shape"] == [40, 24]
    ad = jad.read_anndata_zarr(tmp_path / "e.zarr")
    np.testing.assert_array_equal(ad.X, feats)
    assert set(ad.obsm) == {"X_projections", "X_pca"}
    np.testing.assert_array_equal(ad.obsm["X_projections"], proj)
    assert ad.obsm["X_pca"].shape == (40, 5) and ad.obsm["X_pca"].dtype == np.float32
    assert ad.uns == {"data_path": "/d/plate.zarr", "tracks_path": "/t"}
    want_obs = jew.pd.DataFrame(_index(40))
    want_obs["fov_name"] = want_obs["fov_name"].str.strip("/")
    assert list(ad.obs.columns) == list(want_obs.columns)
    for c in want_obs.columns:
        assert ad.obs[c].tolist() == want_obs[c].tolist(), c
    assert ad.obs["fov_name"].tolist()[:2] == ["A/1/0", "A/2/1"]
    assert ad.obs.index.tolist() == [str(i) for i in range(40)]
    # the port's own reader reads it back as written
    back = tew.read_embedding_dataset(tmp_path / "e.zarr")
    np.testing.assert_array_equal(back["features"], feats)
    np.testing.assert_array_equal(back["projections"], proj)
    _same_obs(back.obs, ad.obs)
    assert back.uns == ad.uns and back.var.index.tolist() == list(ad.var.index)


def test_the_port_reads_a_jax_store_and_refuses_blosc(tmp_path, monkeypatch):
    feats, proj = _embeddings(30, 4)
    obs = jew.pd.DataFrame(_index(30, 3))
    obs.index = obs.index.astype(str)
    store = jad.AnnDataLite(X=feats, obs=obs, obsm={"X_projections": proj}, uns={"note": "x", "k": 3})
    jad.write_anndata_zarr(tmp_path / "blosc.zarr", store)
    with pytest.raises(UnsupportedCodecError, match="blosc"):
        tad.read_anndata_zarr(tmp_path / "blosc.zarr")
    monkeypatch.setattr(jad, "_write_numeric_ts", jad._write_array)
    jad.write_anndata_zarr(tmp_path / "raw.zarr", store)
    got = tad.read_anndata_zarr(tmp_path / "raw.zarr")
    np.testing.assert_array_equal(got.X, feats)
    np.testing.assert_array_equal(got.obsm["X_projections"], proj)
    _same_obs(got.obs, obs)
    assert got.uns == {"note": "x", "k": 3}


def test_pca_matches_the_jax_writer_at_sklearns_full_sizes(tmp_path, monkeypatch):
    monkeypatch.setattr(jad, "_write_numeric_ts", jad._write_array)
    feats, _ = _embeddings(200, 7)
    for n in (8, 30):  # 30 > min(X.shape) - 1: 23 components
        j = jew.write_embedding_dataset(tmp_path / f"j{n}.zarr", feats, jew.pd.DataFrame(_index(200)),
                                        compute_pca=True, pca_components=n)
        t = tew.write_embedding_dataset(tmp_path / f"t{n}.zarr", feats, _index(200), compute_pca=True,
                                        pca_components=n)
        want, got = j.obsm["X_pca"], t.obsm["X_pca"]
        assert got.shape == want.shape == (200, min(n, 23))
        err, _ = rel_err(got, want)
        assert err <= 1e-5, err
    with pytest.raises(NotImplementedError, match="umap_kwargs"):
        tew.EmbeddingWriter(str(tmp_path / "u.zarr"), umap_kwargs={})


def test_convert_to_anndata_matches_jax(tmp_path):
    feats, proj = _embeddings(25, 9)
    tew.write_embedding_dataset(tmp_path / "e.zarr", feats, _index(25), projections=proj, compute_pca=True,
                                uns_metadata={"data_path": "p"})
    j_convert(tmp_path / "e.zarr", tmp_path / "j.zarr")
    convert_to_anndata(tmp_path / "e.zarr", tmp_path / "t.zarr")
    want, got = jad.read_anndata_zarr(tmp_path / "j.zarr"), jad.read_anndata_zarr(tmp_path / "t.zarr")
    np.testing.assert_array_equal(got.X, want.X)
    assert set(got.obsm) == set(want.obsm) == {"X_projections"}
    np.testing.assert_array_equal(got.obsm["X_projections"], want.obsm["X_projections"])
    assert got.obs.equals(want.obs) and got.var.index.equals(want.var.index) and got.uns == want.uns == {}


# -- the DynaCLR command line -------------------------------------------------------------------


@pytest.fixture(scope="module")
def plate(tmp_path_factory):
    root = tmp_path_factory.mktemp("dynaclr_cli")
    path = build_hcs_plate(root / "plate.zarr", ["Phase3D", "RFP"], zyx_shape=(12, 96, 96), num_timepoints=3,
                           rows=("A",), cols=("1",), fovs=("0", "1", "2", "3", "4"), seed=8)
    rng = np.random.default_rng(9)
    for name, pos in open_ome_zarr(path, mode="r+").positions():
        pos.zattrs["normalization"] = {ch: {"fov_statistics": {"mean": 0.5, "std": float(rng.uniform(0.2, 0.4))}}
                                       for ch in ("Phase3D", "RFP")}
        _write_tracks(root / "tracks" / name / "tracks.csv", rng)
    return root, path


NARROW_ENCODER = {k: (list(v) if isinstance(v, tuple) else v) for k, v in TINY.items()}


def _config(path, base: str, override: dict) -> str:
    path.write_text(yaml.safe_dump({"base": [str(ROOT / "configs" / base)], **override}))
    return str(path)


def test_dynaclr_fit_predict_and_convert_through_the_cli(plate, tmp_path):
    root, plate_path = plate
    data = dict(data_path=str(plate_path), tracks_path=str(root / "tracks"), z_range=[1, 11])
    fit_cfg = _config(tmp_path / "fit.yml", "dynaclr_fit.yml", {
        "model": {"init_args": {"encoder": NARROW_ENCODER}},
        "data": {"init_args": {**data, "initial_yx_patch_size": [48, 48], "final_yx_patch_size": [32, 32],
                               "batch_size": 4}},
        "trainer": {"device": "cpu", "max_epochs": 1, "limit_train_batches": 2, "limit_val_batches": 1,
                    "default_root_dir": str(tmp_path / "run"), "log_every_n_steps": 1},
    })
    trainer = cli.main(["fit", "-c", fit_cfg])
    assert trainer.global_step == 2 and np.isfinite(trainer.logged_metrics["loss/train"])
    assert np.isfinite(trainer.logged_metrics["loss/validate"])
    last = tmp_path / "run/checkpoints/last"
    store = tmp_path / "emb.zarr"
    predict = {
        "model": {"init_args": {"encoder": NARROW_ENCODER}},
        "data": {"init_args": {**data, "initial_yx_patch_size": [32, 32], "final_yx_patch_size": [32, 32],
                               "batch_size": 16, "predict_cells": False}},
        "trainer": {"device": "cpu", "default_root_dir": str(tmp_path / "pred"), "callbacks": [
            {"class_path": "viscy_utils.callbacks.EmbeddingWriter",
             "init_args": {"output_path": str(store), "compute_pca": True, "pca_components": 8}}]},
        "ckpt_path": str(last),
    }
    trainer = cli.main(["predict", "-c", _config(tmp_path / "predict.yml", "dynaclr_predict.yml", predict)])
    # the shipped predict_cells: true without (fov, track) pairs embeds nothing in JAX; the port refuses it
    shipped = dict(predict, data={"init_args": {**predict["data"]["init_args"], "predict_cells": True}})
    with pytest.raises(ValueError, match="predict_cells=True.*include_fov_names"):
        cli.main(["predict", "-c", _config(tmp_path / "shipped.yml", "dynaclr_predict.yml", shipped)])

    # the store against predict_step on the same (normalized, cropped) windows
    dm, module = trainer._active_datamodule, tdyn.ContrastiveModule(encoder=TINY, device="cpu").eval()
    module.model.load_state_dict(read_checkpoint(last)[1])
    feats, projs, index = [], [], []
    with torch.inference_mode():
        for batch in dm.predict_dataloader():
            b = {k: (torch.from_numpy(v) if k == "anchor" else v) for k, v in batch.items()}
            b["anchor_norm_meta"] = {c: {lv: {s: torch.from_numpy(a) for s, a in st.items()}
                                         for lv, st in m.items()} for c, m in batch["anchor_norm_meta"].items()}
            pred = module.predict_step(dm.device_transform(b, None, "predict"))
            feats.append(pred["features"].numpy())
            projs.append(pred["projections"].numpy())
            index += batch["index"]
    got = tew.read_embedding_dataset(store)
    assert got.X.shape == (len(dm.predict_dataset), 128) and len(index) == got.n_obs >= 20
    np.testing.assert_array_equal(got.X, np.concatenate(feats))
    np.testing.assert_array_equal(got.obsm["X_projections"], np.concatenate(projs))
    assert got.obs["track_id"].tolist() == [int(r["track_id"]) for r in index]
    assert got.obs["fov_name"].tolist() == [r["fov_name"] for r in index]
    assert got.uns == {"data_path": str(plate_path), "tracks_path": str(root / "tracks")}
    want_pca = tew.pca(got.X, 8)
    assert_rel_close(got.obsm["X_pca"], want_pca, 1e-6)

    convert = {"convert": {"embeddings_path": str(store), "output_path": str(tmp_path / "ad.zarr")}}
    assert cli.main(["convert_to_anndata", "-c", _config(tmp_path / "convert.yml", "dynaclr_predict.yml",
                                                          convert)]) is None
    ad = tad.read_anndata_zarr(tmp_path / "ad.zarr")
    np.testing.assert_array_equal(ad.X, got.X)
    assert list(ad.obsm) == ["X_projections"] and ad.uns == {}
    _same_obs(ad.obs, jad.read_anndata_zarr(tmp_path / "ad.zarr").obs)


# -- the auxiliary heads ----------------------------------------------------------------------


def _heads(ns, in_dims: int) -> dict:
    return {
        "cls": ns.ClassificationHead(in_dims=in_dims, hidden_dims=[24, 16], num_classes=5, top_k=2, head_name="cls",
                                     batch_key="label", loss_weight=0.7),
        "xm": ns.CrossModalContrastiveHead(in_dims=in_dims, target_dims=6, proj_dims=8, image_hidden=16,
                                           target_hidden=12, temperature=0.2, head_name="xm", batch_key="tx",
                                           loss_weight=0.4, weight_schedule="cosine", weight_start=0.1,
                                           weight_warmup_epochs=10),
    }


def test_auxiliary_heads_loss_and_gradients_match_jax():
    jmod = jdyn.ContrastiveModule(encoder=dict(TINY), loss_function=jloss.NTXentLoss(0.5),
                                  auxiliary_heads=_heads(jheads, 128))
    key = jax.random.PRNGKey(0)
    example = {k: jnp.zeros((2, 2, 10, 64, 64)) for k in ("anchor", "positive", "negative")}
    shapes = jax.eval_shape(lambda: jmod.init_with_rngs({"params": key, "dropout": key}, example))
    params = seeded_params(shapes["params"], 31)
    _, stats = _variables(jdyn.ContrastiveEncoder(**TINY), 31, jnp.zeros((1, 2, 10, 64, 64)))
    batch = _batch(6, 40)
    rng = np.random.default_rng(41)
    label = rng.integers(0, 5, 6)
    tx = rng.normal(0, 1, (6, 6)).astype(np.float32)
    tx[2] = np.nan  # an unpaired cell
    epoch = 3
    jb = {**{k: jnp.asarray(v) for k, v in batch.items()}, "label": jnp.asarray(label), "tx": jnp.asarray(tx),
          "_schedule": jmod.schedule_state(epoch)}

    def loss_fn(p):
        value, (_, extra) = jmod.training_loss({"params": p, "batch_stats": _jvars(params, stats)["batch_stats"]},
                                               jb, jax.random.PRNGKey(0))
        return value

    want, jgrads = jax.jit(jax.value_and_grad(loss_fn))(_jvars(params, stats)["params"])
    want_val = jax.jit(lambda v: jmod.validation_loss(v, jb, jax.random.PRNGKey(0))[0])(_jvars(params, stats))

    tmod = tdyn.ContrastiveModule(encoder=dict(TINY), loss_function=tloss.NTXentLoss(0.5),
                                  auxiliary_heads={k: {"class_path": f"viscy_tpu.models.components.heads."
                                                                     f"{type(h).__name__}",
                                                       "init_args": {f.name: getattr(h, f.name)
                                                                     for f in dataclasses.fields(h)
                                                                     if f.name not in ("parent", "name")}}
                                                   for k, h in _heads(jheads, 128).items()},
                                  device="cpu")
    assert tmod.schedule_state(epoch) == jmod.schedule_state(epoch)
    tmod.on_epoch_start(epoch)
    load_flax_params(tmod.model, params, stats)
    assert {k.split(".")[1] for k in tmod.model.state_dict() if k.startswith("aux_heads.")} == {"cls", "xm"}
    tb = {**{k: torch.from_numpy(v) for k, v in batch.items()}, "label": torch.from_numpy(label),
          "tx": torch.from_numpy(tx)}
    with torch.no_grad():
        np.testing.assert_allclose(float(tmod.eval().validation_loss(tb)), float(want_val), rtol=1e-5)
    got = tmod.train().training_loss(tb, torch.Generator())
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_g = contrastive_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    grads = {name: p.grad for name, p in tmod.model.named_parameters()}
    assert set(grads) == set(want_g) and sum(k.startswith("aux_heads.") for k in grads) == 26
    for name, g in grads.items():
        if name in ("projection.0.bias", "projection.3.bias"):  # removed by the next train-mode BatchNorm
            continue
        if g.numel() == 1:  # the cosine classifier's log_scale: no range, relative to its value
            np.testing.assert_allclose(g.numpy(), want_g[name].numpy(), rtol=2e-3, err_msg=name)
        else:
            assert_rel_close(g.numpy(), want_g[name].numpy(), 2e-3, 0.9999)
    # a batch without the heads' keys: the contrastive loss alone, as JAX skips them
    with torch.no_grad():
        plain = tdyn.ContrastiveModule(encoder=dict(TINY), loss_function=tloss.NTXentLoss(0.5), device="cpu")
        plain.load_state_dict({k: v for k, v in tmod.state_dict().items() if "aux_heads" not in k})
        no_keys = {k: v for k, v in tb.items() if k not in ("label", "tx")}
        assert float(tmod.eval().validation_loss(no_keys)) == float(plain.eval().validation_loss(no_keys))


@pytest.mark.parametrize("name", ["dynaclr_fit.yml", "dynaclr_predict.yml"])
def test_both_dynaclr_configs_instantiate_whole(name):
    """Every node of the shipped configs builds in the port, as shipped
    (the model on the CPU)."""
    from viscy_tpu_torch.data.triplet import TripletDataModule
    from viscy_tpu_torch.training.compose import load_composed_config
    from viscy_tpu_torch.training.instantiate import instantiate

    cfg = load_composed_config(ROOT / "configs" / name)
    module = instantiate(dict(cfg["model"], init_args=dict(cfg["model"]["init_args"], device="cpu")))
    assert isinstance(module, tdyn.ContrastiveModule) and module.model.in_stack_depth == 15
    dm = instantiate(cfg["data"])
    assert isinstance(dm, TripletDataModule) and dm.source_channel == ["Phase3D", "RFP"]
    assert [type(t).__name__ for t in dm._norm_compose] == ["NormalizeSampled", "BatchedCenterSpatialCropd"]
    trainer = cli.build_trainer(dict(cfg.get("trainer", {}), device="cpu"))
    writers = [cb for cb in trainer.callbacks if isinstance(cb, tew.EmbeddingWriter)]
    assert len(writers) == ("predict" in name)
    if writers:
        assert writers[0].compute_pca and writers[0].pca_components == 8 and cfg["ckpt_path"]


def test_jax_predict_skips_the_device_transform(plate, tmp_path):
    """A fault of the JAX trainer, not copied: its ``predict`` never runs the
    datamodule's device transform, so JAX embeds the raw windows even though
    the config lists normalizations. The port's ``Trainer.predict`` runs
    ``TripletDataModule.device_transform`` (normalize, center-crop), as the
    reference's ``on_after_batch_transfer`` does (the CLI test above holds
    the port's store against it)."""
    from viscy_tpu import transforms as J
    from viscy_tpu.data.triplet import TripletDataModule as JTripletDataModule
    from viscy_tpu.training.trainer import Trainer as JTrainer

    root, plate_path = plate
    jdm = JTripletDataModule(data_path=str(plate_path), tracks_path=str(root / "tracks"),
                             source_channel=["Phase3D", "RFP"], z_range=(1, 11), initial_yx_patch_size=(32, 32),
                             final_yx_patch_size=(32, 32), batch_size=8,
                             normalizations=[J.NormalizeSampled(keys=["Phase3D", "RFP"], level="fov_statistics")])
    jmod = jdyn.ContrastiveModule(encoder=dict(TINY), example_input_array_shape=(1, 2, 10, 32, 32))
    trainer = JTrainer(default_root_dir=tmp_path)
    got = np.asarray(trainer.predict(jmod, jdm, return_predictions=True)[0]["features"])
    batch = next(iter(jdm.predict_dataloader()))
    step = jax.jit(jmod.predict_step)
    raw = np.asarray(step(trainer.state.variables, {"anchor": jnp.asarray(batch["anchor"])})["features"])
    view = jdm.device_transform({"anchor": jnp.asarray(batch["anchor"]), "anchor_norm_meta": batch["anchor_norm_meta"]},
                                jax.random.PRNGKey(0), stage="predict")
    normalized = np.asarray(step(trainer.state.variables, view)["features"])
    np.testing.assert_allclose(got, raw, rtol=1e-5, atol=1e-5)  # two jit programs
    assert np.abs(got - normalized).max() > 1e-2


def test_jax_engine_cannot_run_a_batchnorm_head():
    """Why the port refuses a head with ``norm="bn"``: the JAX engine keeps
    only a head's params (``init_with_rngs``) and applies it without its
    batch statistics, so such a head fails there."""
    head = jheads.ClassificationHead(in_dims=128, hidden_dims=8, num_classes=3, norm="bn")
    jmod = jdyn.ContrastiveModule(encoder=dict(TINY), loss_function=jloss.NTXentLoss(0.5),
                                  auxiliary_heads={"cls": head})
    key = jax.random.PRNGKey(0)
    example = {k: jnp.zeros((2, 2, 10, 64, 64)) for k in ("anchor", "positive", "negative")}
    shapes = jax.eval_shape(lambda: jmod.init_with_rngs({"params": key, "dropout": key}, example))
    assert "cls" in shapes["params"]["aux_heads"] and "aux_heads" not in shapes.get("batch_stats", {})
    batch = {**example, "label": jnp.zeros((2,), jnp.int32)}
    with pytest.raises(Exception, match="batch_stats"):
        jax.eval_shape(lambda v: jmod.training_loss(v, batch, key), shapes)
