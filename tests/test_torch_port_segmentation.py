"""The test stage's segmentation leg, alone: the port's
``segment_nucleus_instances`` and ``mean_average_precision`` against
viscy_tpu's on seeded images.

Instance labels equal JAX's exactly (same scipy calls on the same float32
images); the joint-histogram IoU equals JAX's dense-mask IoU matrix, and
every mAP / mAR equals JAX's, including the empty and no-match cases and
labels that are not consecutive."""

import warnings

import numpy as np
import pytest
from scipy import ndimage

from viscy_tpu.apps.dynacell.eval.segmentation import segment_nucleus_instances as j_segment
from viscy_tpu.evaluation import metrics as jm
from viscy_tpu_torch.apps.dynacell.eval.segmentation import segment_nucleus_instances
from viscy_tpu_torch.evaluation.metrics import label_iou_matrix, mean_average_precision


def _nuclei_image(seed: int, shape=(96, 112), n=14) -> np.ndarray:
    """Gaussian blobs (touching pairs included) on a noisy background."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    img = rng.normal(0.1, 0.05, shape)
    for _ in range(n):
        cy, cx = rng.uniform(8, shape[0] - 8), rng.uniform(8, shape[1] - 8)
        r = rng.uniform(3, 7)
        img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
    return img.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_instances_equal_jax(seed):
    img = _nuclei_image(seed)
    got, want = segment_nucleus_instances(img), j_segment(img)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert got.max() >= 5


def test_instances_of_a_flat_and_a_seedless_image_equal_jax():
    flat = np.full((40, 40), 0.3, np.float32)
    assert np.array_equal(segment_nucleus_instances(flat), j_segment(flat))
    assert not segment_nucleus_instances(flat).any()
    small = np.zeros((40, 40), np.float32)
    small[10:13, 10:13] = 1.0  # blobs too thin for a seed (distance <= 1)
    small[25:27, 5:35] = 1.0
    assert np.array_equal(segment_nucleus_instances(small), j_segment(small))


def _pairs():
    rng = np.random.default_rng(7)
    target = ndimage.label(_nuclei_image(3) > 0.6)[0].astype(np.int32)
    shifted = np.roll(target, (1, 2), axis=(0, 1))
    relabeled = np.where(target > 0, target * 7 + 100, 0).astype(np.int32)  # sparse, unordered ids
    noisy = np.where(rng.random(target.shape) < 0.05, 0, shifted).astype(np.int32)
    empty = np.zeros_like(target)
    other = np.zeros_like(target)
    other[:5, :5] = 3  # no overlap with any target instance
    return {
        "identical": (target, target),
        "shifted": (shifted, target),
        "relabeled": (relabeled, target),
        "noisy": (noisy, relabeled),
        "pred empty": (empty, target),
        "target empty": (target, empty),
        "both empty": (empty, empty),
        "no match": (other, target),
        "segmented": (segment_nucleus_instances(_nuclei_image(3)), target),
    }


@pytest.mark.parametrize("case", list(_pairs()))
def test_iou_and_average_precision_equal_jax(case):
    pred, target = _pairs()[case]
    want_iou = jm._mask_iou_matrix(jm.labels_to_masks(pred), jm.labels_to_masks(target))
    got_iou = label_iou_matrix(pred, target)
    assert got_iou.shape == want_iou.shape and np.array_equal(got_iou, want_iou)
    with warnings.catch_warnings():  # both sides take nanmean of all-NaN APs when both are empty
        warnings.simplefilter("ignore", RuntimeWarning)
        got, want = mean_average_precision(pred, target), jm.mean_average_precision(pred, target)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), (k, got[k], want[k])


def test_label_images_must_be_2d_and_alike():
    with pytest.raises(ValueError, match="2D"):
        mean_average_precision(np.zeros((2, 4, 4), np.int32), np.zeros((2, 4, 4), np.int32))
    with pytest.raises(ValueError, match="shape"):
        mean_average_precision(np.zeros((4, 4), np.int32), np.zeros((4, 5), np.int32))
