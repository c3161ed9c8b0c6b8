"""The trainer callbacks ``OnlineEvalCallback`` and ``EmbeddingSnapshotCallback``,
``training/log_images.py``, ``evaluation/clustering.py::effective_rank`` and
the image events of the port's ``CSVLogger`` against viscy_tpu, and the
JAX ``ModelCheckpoint``'s ignored options against the port's refusals.

The JAX online-eval callback scores its k-NN probe with sklearn; the port
copies sklearn's splits and vote in numpy (the card's machine has no
sklearn), so the splits are also held against sklearn's own. Features are
seeded normals, far from ties. Tolerances: k-NN accuracies and splits
exactly equal; effective rank and temporal smoothness within 1e-9
relative; the snapshot's features within the DynaCLR forward's bound (2e-3
of the range, Pearson r > 0.9999); images bit for bit.
"""

import io
import logging
import sys
import types
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.model_selection import StratifiedKFold, train_test_split

from viscy_tpu.apps.dynaclr import engine as jdyn
from viscy_tpu.evaluation import clustering as jclustering
from viscy_tpu.models.contrastive.encoder import ContrastiveEncoder as JEncoder
from viscy_tpu.models.contrastive.loss import NTXentLoss as JNTXent
from viscy_tpu.training import log_images as jlog
from viscy_tpu.training.callbacks import checkpoint as jckpt
from viscy_tpu.training.callbacks import embedding_snapshot as jsnap
from viscy_tpu.training.callbacks import online_eval as jeval
from viscy_tpu.training.trainer import CSVLogger as JCSVLogger
from viscy_tpu_torch.apps.dynaclr.engine import ContrastiveModule
from viscy_tpu_torch.models.contrastive.loss import NTXentLoss
from viscy_tpu_torch.evaluation import clustering as tclustering
from viscy_tpu_torch.training import log_images as tlog
from viscy_tpu_torch.training.callbacks import checkpoint as tckpt
from viscy_tpu_torch.training.callbacks import embedding_snapshot as tsnap
from viscy_tpu_torch.training.callbacks import embedding_writer as tew
from viscy_tpu_torch.training.callbacks import online_eval as teval
from viscy_tpu_torch.training.convert import load_flax_params
from viscy_tpu_torch.training.instantiate import instantiate
from viscy_tpu_torch.training.trainer import CSVLogger, Trainer

from _torch_port_helpers import assert_rel_close, seeded_params

# narrow stand-in for configs/dynaclr_fit.yml's encoder, as tests/test_torch_port_contrastive.py's
CONTRASTIVE = dict(backbone="convnext_test", in_channels=2, in_stack_depth=10, stem_kernel_size=(5, 4, 4),
                   stem_stride=(5, 4, 4), embedding_dim=32, projection_dim=16)


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-300)


def _dataset(n: int, counts: tuple[int, ...], seed: int, dim: int = 16, tracks: int = 4):
    """Seeded features with a class signal, string labels, track ids and
    timepoints (tracks of ``tracks`` rows)."""
    rng = np.random.default_rng(seed)
    labels = np.repeat([f"marker_{chr(97 + i)}" for i in range(len(counts))], counts)[:n]
    rng.shuffle(labels)
    centers = rng.normal(0, 1.0, (len(counts), dim))
    code = np.searchsorted(np.unique(labels), labels)
    feats = (centers[code] + rng.normal(0, 1.2, (n, dim))).astype(np.float32)
    track_ids = np.arange(n) // tracks
    timepoints = (np.arange(n) % tracks) * 2
    return feats, labels, track_ids, timepoints


# -- the metrics ----------------------------------------------------------------------------------------


def test_effective_rank_and_smoothness_match_jax():
    feats, _, track_ids, timepoints = _dataset(40, (20, 20), 0)
    assert _rel(tclustering.effective_rank(feats), jclustering.effective_rank(feats)) <= 1e-9
    bad = feats.copy()
    bad[[3, 17]] = np.nan
    assert _rel(teval.effective_rank(bad), jeval.effective_rank(bad)) <= 1e-9
    one = bad[[3, 17, 0]]  # one finite row
    assert np.isnan(teval.effective_rank(one)) and np.isnan(jeval.effective_rank(one))
    got = teval.temporal_smoothness(feats, track_ids, timepoints)
    assert _rel(got, jeval.temporal_smoothness(feats, track_ids, timepoints)) <= 1e-9
    assert np.isnan(teval.temporal_smoothness(feats[:4], np.arange(4), timepoints[:4]))


SPLIT_CASES = [(20, 20), (7, 5, 9), (3, 11, 2, 6), (2, 2, 2), (13, 4)]


@pytest.mark.parametrize("counts", SPLIT_CASES, ids=[str(c) for c in SPLIT_CASES])
def test_the_splits_are_sklearns(counts):
    """``StratifiedKFold(n, shuffle=False)``'s test folds and
    ``train_test_split(stratify=y, random_state=0)``'s train and test rows,
    index for index."""
    y = np.random.default_rng(sum(counts)).permutation(np.repeat(np.arange(len(counts)), counts))
    for n_splits in range(2, min(5, min(counts)) + 1):
        folds = teval.stratified_kfold_test_folds(y, n_splits)
        for f, (_, test) in enumerate(StratifiedKFold(n_splits, shuffle=False).split(np.zeros(len(y)), y)):
            np.testing.assert_array_equal(np.flatnonzero(folds == f), test)
    for size in (0.2, 0.35):
        if min(counts) < 2 or min(len(y) - int(np.ceil(size * len(y))), int(np.ceil(size * len(y)))) < len(counts):
            continue
        rows = np.arange(len(y))
        want_train, want_test = train_test_split(rows, test_size=size, stratify=y, random_state=0)
        got_train, got_test = teval.stratified_holdout(y, size)
        np.testing.assert_array_equal(got_train, want_train)
        np.testing.assert_array_equal(got_test, want_test)


KNN_CASES = [
    dict(n=40, counts=(14, 13, 13), k=5, mode="cv"),
    dict(n=30, counts=(10, 20), k=20, mode="cv"),
    dict(n=12, counts=(4, 4, 4), k=20, mode="cv"),  # k above each fold's training rows: NaN in both
    dict(n=21, counts=(7, 5, 9), k=5, mode="holdout"),
    dict(n=33, counts=(11, 11, 11), k=4, mode="holdout"),
    dict(n=20, counts=(19, 1), k=5, mode="cv"),  # a singleton: holdout, which needs two a class: None
    dict(n=10, counts=(10,), k=3, mode="cv"),  # one class: None
]


@pytest.mark.parametrize("case", KNN_CASES, ids=[f"{c['mode']}-{c['counts']}-k{c['k']}" for c in KNN_CASES])
def test_knn_probe_equals_sklearns(case):
    feats, labels, _, _ = _dataset(case["n"], case["counts"], case["n"] + case["k"])
    want = jeval.OnlineEvalCallback(k=case["k"], knn_eval_mode=case["mode"])._knn_accuracy(feats, labels)
    got = teval.knn_accuracy(feats, labels, case["k"], case["mode"])
    if want is None or np.isnan(want):
        assert got is want or (got is not None and np.isnan(got) and np.isnan(want))
    else:
        assert got == want


def test_the_vote_breaks_ties_to_the_smallest_label():
    """Two neighbours of each class at k = 4: the smallest encoded label, as
    sklearn's ``KNeighborsClassifier`` predicts."""
    from sklearn.neighbors import KNeighborsClassifier

    train = np.array([[1, 0.1], [1, -0.1], [1, 0.2], [1, -0.2], [-1, 0]], np.float32)
    y = np.array([1, 2, 2, 1, 0])
    test = np.array([[1, 0]], np.float32)
    want = KNeighborsClassifier(4, metric="cosine").fit(train, y).predict(test)
    assert teval.knn_predict(train, y, test, 4).tolist() == want.tolist() == [1]


# -- OnlineEvalCallback ---------------------------------------------------------------------------------


class _Logger:
    def __init__(self) -> None:
        self.metrics: list[tuple[dict, int]] = []
        self.images: list[tuple[str, np.ndarray, int]] = []

    def log_metrics(self, metrics, step):
        self.metrics.append((dict(metrics), step))

    def log_image(self, tag, image, step):
        self.images.append((tag, np.asarray(image), step))


def _stub_trainer(root=None, epoch=0, variables=None):
    return SimpleNamespace(current_epoch=epoch, global_step=7, default_root_dir=root, logger=_Logger(),
                           device=torch.device("cpu"), state=SimpleNamespace(variables=variables))


def _run_callback(cb, trainer, batches) -> list:
    cb.on_validation_epoch_start(trainer, None)
    for i, (outputs, batch) in enumerate(batches):
        cb.on_validation_batch_end(trainer, None, outputs, batch, i)
    cb.on_validation_epoch_end(trainer, None, {})
    return trainer.logger.metrics


@pytest.mark.parametrize("mode", ["cv", "holdout"])
def test_online_eval_callback_logs_what_jax_logs(mode):
    """Features from the step's outputs, metadata from ``anchor_meta`` (one
    batch's labels under ``labels``, one batch's meta from ``index``),
    ``max_samples`` cutting the rows: the same metric names and steps,
    k-NN equal, effective rank and smoothness within 1e-9 relative."""
    feats, labels, track_ids, timepoints = _dataset(46, (16, 15, 15), 3)
    batches = []
    for i, start in enumerate(range(0, 46, 8)):
        rows = slice(start, start + 8)
        meta = [{"marker": m, "track_id": int(t), "t": int(tp)}
                for m, t, tp in zip(labels[rows], track_ids[rows], timepoints[rows])]
        if i == 1:
            meta = [{"labels": {"marker": m["marker"]}, "track_id": m["track_id"], "t": m["t"]} for m in meta]
        key = "index" if i == 2 else "anchor_meta"
        batches.append(({"features": feats[rows]}, {key: meta}))
    kw = dict(k=6, knn_eval_mode=mode, max_samples=40)
    got = _run_callback(teval.OnlineEvalCallback(**kw), _stub_trainer(), batches)
    want = _run_callback(jeval.OnlineEvalCallback(**kw), _stub_trainer(), batches)
    assert [(sorted(m), s) for m, s in got] == [(sorted(m), s) for m, s in want]
    assert len(got[0][0]) == 3
    for (g, _), (w, _) in zip(got, want):
        for k in w:
            if k.startswith("metrics/knn_acc"):
                assert g[k] == w[k], k
            else:
                assert _rel(g[k], w[k]) <= 1e-9, k


def test_online_eval_without_metadata_logs_the_rank_only_and_skips_other_epochs():
    feats = _dataset(12, (6, 6), 4)[0]
    batches = [({"features": feats[:6]}, {}), ({"features": torch.from_numpy(feats[6:])}, {})]
    cb = teval.OnlineEvalCallback(every_n_epochs=2)
    got = _run_callback(cb, _stub_trainer(), batches)
    assert [sorted(m) for m, _ in got] == [["metrics/effective_rank/val"], ["online_eval/effective_rank"]]
    assert _rel(got[0][0]["metrics/effective_rank/val"], jeval.effective_rank(feats)) <= 1e-9
    assert _run_callback(cb, _stub_trainer(epoch=1), batches) == []
    assert _run_callback(cb, _stub_trainer(), batches[:1][:0]) == []


# -- EmbeddingSnapshotCallback --------------------------------------------------------------------------


def _contrastive_pair():
    """The JAX engine and its seeded variables, and the port engine on them."""
    jenc = JEncoder(**CONTRASTIVE)
    shapes = jax.eval_shape(lambda: jenc.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 10, 64, 64))))
    rng = np.random.default_rng(9)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, s: (rng.normal(0, 0.1, s.shape) if path[-1].key == "mean" else rng.uniform(0.5, 1.5, s.shape))
        .astype(np.float32), shapes.get("batch_stats", {}))
    variables = {"params": seeded_params(shapes["params"], 8), "batch_stats": stats}
    j = jdyn.ContrastiveModule(encoder=dict(CONTRASTIVE), loss_function=JNTXent(0.5))
    t = ContrastiveModule(encoder=dict(CONTRASTIVE), loss_function=NTXentLoss(0.5), device="cpu")
    load_flax_params(t.model, variables["params"], variables["batch_stats"])
    return j, variables, t


def test_embedding_snapshot_writes_the_features_jax_writes(tmp_path):
    """Three validation batches of 4 anchors, ``max_batches`` 2: the saved
    ``epoch_0.npy`` against the JAX callback's (eval-mode encoder), the
    module's training mode restored, the PCA pairplot logged (matplotlib
    is installed here); nothing on an epoch off the period."""
    j, variables, t = _contrastive_pair()
    rng = np.random.default_rng(2)
    anchors = [rng.normal(0, 1, (5, 2, 10, 32, 32)).astype(np.float32) for _ in range(3)]
    trainers = {}
    for side, cb, module, batch_of in (
            # the JAX callback calls ``module.forward`` only: the engine's, jitted
            ("jax", jsnap.EmbeddingSnapshotCallback(every_n_epochs=2, max_batches=2),
             SimpleNamespace(forward=jax.jit(j.forward)), jnp.asarray),
            ("torch", tsnap.EmbeddingSnapshotCallback(every_n_epochs=2, max_batches=2), t.train(), torch.from_numpy)):
        trainer = trainers[side] = _stub_trainer(tmp_path / side, 0, variables)
        cb.on_validation_epoch_start(trainer, module)
        for i, a in enumerate(anchors):
            cb.on_validation_batch_end(trainer, module, {}, {"anchor": batch_of(a)}, i)
        cb.on_validation_epoch_end(trainer, module, {})
        off = _stub_trainer(tmp_path / f"{side}_off", 1, variables)
        cb.on_validation_batch_end(off, module, {}, {"anchor": batch_of(anchors[0])}, 0)
        cb.on_validation_epoch_end(off, module, {})
        assert not (tmp_path / f"{side}_off").exists()
    assert t.training
    got = np.load(tmp_path / "torch" / "embeddings" / "epoch_0.npy")
    want = np.load(tmp_path / "jax" / "embeddings" / "epoch_0.npy")
    assert got.shape == want.shape and got.shape[0] == 10
    assert_rel_close(got, want, 2e-3, 0.9999)
    (tag, image, step), = trainers["torch"].logger.images
    assert tag == "embeddings/pca" and step == 7 and image.dtype == np.uint8 and image.ndim == 3
    assert [i[0] for i in trainers["jax"].logger.images] == ["embeddings/pca"]


def test_the_pairplot_is_skipped_only_without_matplotlib(tmp_path, monkeypatch, caplog):
    feats = _dataset(12, (6, 6), 5)[0]
    module = SimpleNamespace(training=False, eval=lambda: None, train=lambda mode=True: None,
                             model=lambda a: (torch.from_numpy(feats[: len(a)]), None))
    cb = tsnap.EmbeddingSnapshotCallback(every_n_epochs=1)

    def run(root):
        trainer = _stub_trainer(root)
        cb.on_validation_epoch_start(trainer, module)
        cb.on_validation_batch_end(trainer, module, {}, {"anchor": np.zeros((12, 1))}, 0)
        cb.on_validation_epoch_end(trainer, module, {})
        return trainer

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with caplog.at_level(logging.INFO, logger="viscy_tpu_torch"):
        trainer = run(tmp_path / "a")
    assert trainer.logger.images == [] and "matplotlib is not installed" in caplog.text
    np.testing.assert_array_equal(np.load(tmp_path / "a" / "embeddings" / "epoch_0.npy"), feats)
    monkeypatch.delitem(sys.modules, "matplotlib")

    def broken(features):
        raise RuntimeError("pairplot failed")

    monkeypatch.setattr(tlog, "pca_pairplot", broken)
    with pytest.raises(RuntimeError, match="pairplot failed"):
        run(tmp_path / "b")


def test_callbacks_in_a_fit(tmp_path):
    """Both callbacks by their reference class paths in ``Trainer.fit`` of a
    narrow ``ContrastiveModule``: the snapshot holds the encoder's eval-mode
    features of the validation anchors, ``metrics.csv`` the online rank."""
    _, _, t = _contrastive_pair()
    rng = np.random.default_rng(3)
    val = [{k: rng.normal(0, 1, (4, 2, 10, 32, 32)).astype(np.float32) for k in ("anchor", "positive")}
           for _ in range(2)]

    class DM:
        def setup(self, stage):
            pass

        def train_dataloader(self):
            return val[:1]

        def val_dataloader(self):
            return val

    callbacks = instantiate([{"class_path": "viscy_utils.callbacks.EmbeddingSnapshotCallback",
                              "init_args": {"every_n_epochs": 1}},
                             {"class_path": "viscy_utils.callbacks.online_eval.OnlineEvalCallback"}])
    assert [type(c) for c in callbacks] == [tsnap.EmbeddingSnapshotCallback, teval.OnlineEvalCallback]
    trainer = Trainer(max_epochs=1, device="cpu", default_root_dir=tmp_path, callbacks=callbacks,
                      checkpoint_every_n_epochs=10, use_tensorboard=False)
    trainer.fit(t, DM())
    got = np.load(tmp_path / "embeddings" / "epoch_0.npy")
    t.eval()
    with torch.no_grad():
        want = torch.cat([t.model(torch.from_numpy(b["anchor"]))[0] for b in val]).numpy()
    np.testing.assert_array_equal(got, want)
    lines = (tmp_path / "metrics.csv").read_text()
    assert "online_eval/effective_rank" in lines and "metrics/effective_rank/val" in lines


# -- log_images and the image event -------------------------------------------------------------------


def test_log_images_match_jax():
    rng = np.random.default_rng(6)
    arrays = (rng.normal(0, 1, (2, 1, 5, 12, 10)).astype(np.float32), rng.normal(0, 1, (2, 2, 12, 10)))
    want = jlog.detach_sample(arrays, 2)
    got = tlog.detach_sample(tuple(torch.from_numpy(np.asarray(a)) for a in arrays), 2)
    assert all(np.array_equal(g, w) for gr, wr in zip(got, want) for g, w in zip(gr, wr))
    np.testing.assert_array_equal(tlog.render_images(got), jlog.render_images(want))
    logger = _Logger()
    tlog.log_image_grid(logger, "val/samples", got, 3)
    assert logger.images[0][0] == "val/samples" and np.array_equal(logger.images[0][1], jlog.render_images(want))


def test_pairplot_components_are_sklearns_pca():
    from sklearn.decomposition import PCA

    feats = _dataset(30, (15, 15), 7)[0].astype(np.float64)
    np.testing.assert_allclose(tew.pca(feats, 3), PCA(n_components=3).fit_transform(feats), rtol=0, atol=1e-9)
    image = tlog.pca_pairplot(feats)
    assert image.dtype == np.uint8 and image.shape[2] == 3


def test_image_event_equals_tensorboardx(tmp_path):
    from PIL import Image

    sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))
    from tensorboard.backend.event_processing.event_file_loader import LegacyEventFileLoader

    rng = np.random.default_rng(8)
    images = [rng.random((9, 7, 3)).astype(np.float32), (rng.random((6, 11, 3)) * 255).astype(np.uint8)]
    read = {}
    for side, logger in (("port", CSVLogger(tmp_path / "port")), ("jax", JCSVLogger(tmp_path / "jax", True))):
        for step, img in enumerate(images):
            logger.log_image("embeddings/pca", img, step)
        logger.close()
        (path,) = (tmp_path / side).glob("events.out.tfevents.*")
        read[side] = [(e.step, v.tag, v.image.height, v.image.width, v.image.colorspace,
                       np.asarray(Image.open(io.BytesIO(v.image.encoded_image_string))))
                      for e in LegacyEventFileLoader(str(path)).Load() for v in e.summary.value]
    assert len(read["port"]) == 2
    for got, want in zip(read["port"], read["jax"]):
        assert got[:5] == want[:5]
        np.testing.assert_array_equal(got[5], want[5])


# -- ModelCheckpoint ----------------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(mode="max"), dict(save_last=False), dict(filename="{epoch}-best")])
def test_jax_model_checkpoint_ignores_what_the_port_refuses(kw):
    """The JAX callback stores ``mode`` and drops ``save_last`` and
    ``filename``: after ``on_fit_start`` the trainer holds no mode, no
    ``last`` switch and no name pattern, so a run with ``mode: max`` keeps
    the lowest scores (``ROADMAP.md`` Queue 3). The port refuses each."""
    trainer = SimpleNamespace(default_root_dir=Path("unused"))
    jckpt.ModelCheckpoint(monitor="metrics/ssim", **kw).on_fit_start(trainer, None)
    assert vars(trainer) == {"default_root_dir": Path("unused"), "checkpoint_monitor": "metrics/ssim",
                             "checkpoint_top_k": 5, "checkpoint_every_n_epochs": 1}
    with pytest.raises(NotImplementedError, match="not ported"):
        tckpt.ModelCheckpoint(monitor="metrics/ssim", **kw)
