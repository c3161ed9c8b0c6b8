"""``viscy-torch test`` against viscy_tpu's ``Trainer.test`` on one plate and
one set of weights.

A plate of two FOVs (Phase3D, Nucleus with blobs, Membrane), ground-truth
masks (16-bit PNGs, as PIL writes them: the instances of the Nucleus
center slice) for two of its four z-windows, the
tiny FCMAE with seeded JAX weights carried across by the weight bridge (the
port's from a checkpoint file through ``--ckpt_path``). The test loader's
batches (one window a batch, host normalization, ``labels`` where a mask
matches) equal JAX's bit for bit; the logged ``test/*`` means equal JAX's:
the regression metrics at rtol 1e-4 (f32 forwards on two stacks), the
segmentation leg's exactly (it segments the target's center slice,
``test_evaluate_cellpose``, so both sides segment the same image; the
leg on a prediction is held against JAX in
``test_torch_port_segmentation.py``). The loop also wrote a TensorBoard
event file."""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from viscy_tpu.apps.cytoland import engine as jengine
from viscy_tpu.data import hcs as jhcs
from viscy_tpu.models.unet.fcmae import FullyConvolutionalMAE as JFCMAE
from viscy_tpu.training.losses.mixed_loss import MixedLoss as JMixedLoss
from viscy_tpu.training.trainer import Trainer as JTrainer
from viscy_tpu.transforms.normalize import NormalizeSampled as JNormalize
from viscy_tpu_torch.apps.cytoland.engine import VSUNet
from viscy_tpu_torch.apps.dynacell.eval.segmentation import segment_nucleus_instances
from viscy_tpu_torch.data import hcs as thcs
from viscy_tpu_torch.training import cli
from viscy_tpu_torch.training.convert import load_flax_params
from viscy_tpu_torch.transforms import NormalizeSampled
from viscy_tpu_torch.zarr_io.store import open_ome_zarr
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

from _torch_port_fit_common import TINY
from _torch_port_helpers import flax_params

CHANNELS = ["Phase3D", "Nucleus", "Membrane"]
REGRESSION = ("loss", "metrics/mae", "metrics/mse", "metrics/pearson", "metrics/cosine", "metrics/ssim")
SEGMENTATION = ("metrics/accuracy", "metrics/dice_score", "metrics/jaccard", "metrics/mAP", "metrics/mAP_50",
                "metrics/mAP_75", "metrics/mAR_100")


def _blobs(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    img = rng.normal(0.1, 0.03, shape)
    for _ in range(6):
        cy, cx, r = rng.uniform(8, shape[0] - 8), rng.uniform(8, shape[1] - 8), rng.uniform(3, 6)
        img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
    return img.astype(np.float32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("test_stage")
    plate = build_hcs_plate(tmp / "plate.zarr", CHANNELS, zyx_shape=(6, 64, 64), num_timepoints=1, rows=("A",),
                            cols=("1",), fovs=("0", "1"), seed=4, norm_meta=True)
    masks = tmp / "masks"
    masks.mkdir()
    for f, (_, pos) in enumerate(open_ome_zarr(plate, mode="r+").positions()):
        data = pos["0"][:]
        for z in range(6):
            data[0, 1, z] = _blobs(10 * f + z, (64, 64))
        pos["0"][:] = data
        z = 2 + f  # FOV 0: the first window's center; FOV 1: the second's
        labels = segment_nucleus_instances(data[0, 1, z]).astype(np.int16)
        with warnings.catch_warnings():  # PIL deprecates writing int16 ("I") images
            warnings.simplefilter("ignore", DeprecationWarning)
            Image.fromarray(labels).save(masks / f"img_p{f:03d}_z{z}_cp_masks.png")
    params = flax_params(JFCMAE(**TINY), 5, jnp.zeros((1, 1, 5, 64, 64)))
    return tmp, plate, masks, params


def _datamodule(pkg, plate, masks):
    norm = (JNormalize if pkg == "jax" else NormalizeSampled)(keys=["Phase3D"], level="fov_statistics")
    mod = jhcs if pkg == "jax" else thcs
    return mod.HCSDataModule(plate, source_channel="Phase3D", target_channel=["Nucleus", "Membrane"],
                             z_window_size=5, batch_size=2, num_workers=0, normalizations=[norm],
                             ground_truth_masks=str(masks))


def test_test_batches_equal_jax(setup):
    _, plate, masks, _ = setup
    jdm, tdm = _datamodule("jax", plate, masks), _datamodule("torch", plate, masks)
    jdm.setup("test")
    tdm.setup("test")
    want, got = list(jdm.test_dataloader()), list(tdm.test_dataloader())
    assert len(got) == len(want) == 4
    assert sum("labels" in b for b in got) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ("source", "target", "labels"):
            if k in w:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_cli_test_equals_jax_trainer_test(setup):
    tmp, plate, masks, params = setup
    loss = dict(l1_alpha=0.5, l2_alpha=0.0, ms_dssim_alpha=0.5)
    jmod = jengine.VSUNet("fcmae", dict(TINY, fused_mlp=False), loss_function=JMixedLoss(**loss),
                          test_evaluate_cellpose=True)
    jmod.init_variables = lambda rng, batch: {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    want = JTrainer(default_root_dir=tmp / "jax", use_tensorboard=False).test(jmod, _datamodule("jax", plate, masks))

    tmod = VSUNet("fcmae", dict(TINY), device="cpu")
    load_flax_params(tmod.model, params)
    ckpt = tmp / "weights.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in tmod.model.state_dict().items()}}, ckpt)
    root = tmp / "port"
    cfg = {
        "model": {"class_path": "cytoland.engine.VSUNet",
                  "init_args": {"architecture": "fcmae", "model_config": {k: list(v) if isinstance(v, tuple) else v
                                                                         for k, v in TINY.items()},
                                "test_evaluate_cellpose": True, "seed": 99,
                                "loss_function": {"class_path": "viscy_utils.losses.MixedLoss", "init_args": loss}}},
        "data": {"class_path": "viscy_data.HCSDataModule",
                 "init_args": {"data_path": str(plate), "source_channel": "Phase3D",
                               "target_channel": ["Nucleus", "Membrane"], "z_window_size": 5, "batch_size": 2,
                               "num_workers": 0, "ground_truth_masks": str(masks),
                               "normalizations": [{"class_path": "viscy_transforms.NormalizeSampled",
                                                   "init_args": {"keys": ["Phase3D"],
                                                                 "level": "fov_statistics"}}]}},
        "trainer": {"device": "cpu", "default_root_dir": str(root)},
    }
    (tmp / "test.yml").write_text(yaml.safe_dump(cfg))
    trainer = cli.main(["test", "-c", str(tmp / "test.yml"), "--ckpt_path", str(ckpt)])
    rows = [json.loads(line) for line in (root / "metrics.csv").read_text().splitlines()]
    got = {k[len("test/"):]: v for k, v in rows[-1].items() if k.startswith("test/")}
    assert set(got) == set(want) == set(REGRESSION + SEGMENTATION)
    for k in REGRESSION:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    for k in SEGMENTATION:
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["metrics/mAP"] == 1.0  # each mask is the segmentation of its own slice
    assert len(list(root.glob("events.out.tfevents.*"))) == 1
    assert trainer.device == torch.device("cpu")


def test_segmentation_leg_on_the_prediction_and_cellpose_refusal(setup):
    """Without ``test_evaluate_cellpose`` the leg segments the first sample's
    predicted center slice: from the test step's prediction or, given none,
    from a forward of its own (the JAX leg's second forward), alike; a
    CellPose model path raises ImportError when cellpose is absent."""
    _, plate, masks, params = setup
    tdm = _datamodule("torch", plate, masks)
    tdm.setup("test")
    batch = next(b for b in tdm.test_dataloader() if "labels" in b)
    batch = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}
    tmod = VSUNet("fcmae", dict(TINY), device="cpu").eval()
    load_flax_params(tmod.model, params)
    with torch.no_grad():
        metrics = tmod.test_step(batch)
        own = tmod.test_step_host(batch)
    assert set(SEGMENTATION) <= set(metrics) and all(np.isfinite(float(v)) for v in metrics.values())
    assert {k: metrics[k] for k in SEGMENTATION} == own
    cellpose = VSUNet("fcmae", dict(TINY), device="cpu", test_cellpose_model_path="nuclei")
    with pytest.raises(ImportError, match="CellPose not installed"):
        cellpose.test_step_host(batch)
