"""Cytoland virtual-staining engine (counterpart of
``viscy_tpu/apps/cytoland/engine.py``), training and prediction.

``VSUNet`` wraps UNeXt2 (``"UNeXt2"``, the released VSCyto3D architecture),
the legacy 2-D and 2.5-D U-Nets (``"2D"``, ``"2.5D"``), the FNet3D 3-D U-Net
(``"FNet3D"``) or the FCMAE-based UNeXt2 (``"fcmae"`` / ``"UNeXt2_2D"``) with the reference supervised training and validation losses (MixedLoss by
default, with the optional bf16 loss inputs; a batch's ``fg_mask`` goes to
the loss, e.g. ``SpotlightLoss``; stochastic depth in the encoder while
training), its AdamW + schedule (optionally with
the encoder frozen), the test step (regression metrics on the device, the
segmentation leg on the host), and the reference predict step: divisible pad,
forward, center crop, optional 4-rotation test-time augmentation, and
batched YX tiling with hat-weight blending for large fields of view.
``FcmaeUNet`` adds masked pretraining (``fit_mask_ratio``, ``MaskedMSELoss``
against the source) and the encoder-only transfer of a pretrained
checkpoint for fine-tuning.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Literal, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from viscy_tpu_torch.apps.cytoland.prediction import rotation_tta_transforms, tiled_forward_yx, tta_median
from viscy_tpu_torch.device import resolve_device
from viscy_tpu_torch.models.unet.fcmae import FullyConvolutionalMAE
from viscy_tpu_torch.models.unet.unet2d import Unet2d
from viscy_tpu_torch.models.unet.unet25d import Unet25d
from viscy_tpu_torch.models.unet.unet3d import Unet3d
from viscy_tpu_torch.models.unet.unext2 import UNeXt2
from viscy_tpu_torch.ops.ssim import ssim_25d
from viscy_tpu_torch.parallel.mesh import global_sum
from viscy_tpu_torch.training.losses.mixed_loss import MixedLoss
from viscy_tpu_torch.training.module import TrainModule

_logger = logging.getLogger("viscy_tpu_torch")

_UNET_ARCHITECTURE = {
    "2D": Unet2d,
    "UNeXt2": UNeXt2,
    "2.5D": Unet25d,
    "FNet3D": Unet3d,
    "fcmae": FullyConvolutionalMAE,
    "UNeXt2_2D": FullyConvolutionalMAE,
}


class MaskedMSELoss:
    """Masked MSE for FCMAE pretraining (reference ``engine.py:106``): the
    per-pixel squared error in float32 averaged over Z, summed where the
    ``(B, 1, H, W)`` mask is 1 and divided by ``max(mask.sum(), 1)``; in a
    job of several processes both sums are the global batch's."""

    def __call__(self, preds: torch.Tensor, original: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        loss = (preds.float() - original.float()).square()
        sums = global_sum(torch.stack([(loss.mean(dim=2) * mask).sum(), mask.sum().to(loss.dtype)]))
        return sums[0] / torch.clamp_min(sums[1], 1.0)


def _divisible_pad(x: torch.Tensor, factor: int, pad_z: bool = False) -> torch.Tensor:
    """Zero-pad YX (and optionally Z) up to multiples of ``factor``,
    SYMMETRICALLY (floor before, ceil after) like MONAI
    ``DivisiblePad(method="symmetric")``, so ``_center_crop_to_shape`` is
    its exact inverse."""
    z, y, xx = x.shape[-3:]
    pz = (-z) % factor if pad_z else 0
    py = (-y) % factor
    px = (-xx) % factor
    if not (pz or py or px):
        return x
    return F.pad(x, (px // 2, px - px // 2, py // 2, py - py // 2, pz // 2, pz - pz // 2))


def _center_crop_to_shape(x: torch.Tensor, spatial: Sequence[int]) -> torch.Tensor:
    """The centred ``spatial`` window of ``x``'s trailing axes, sliced as
    numpy (and the JAX engine) slice ``[start, start + size)`` with ``start =
    (extent - size) // 2``: where the extent is smaller than the window (a
    2.5-D U-Net's depth-1 output under a 5-deep window) the start is
    negative and Python's slice rule clamps it, e.g. depth 1 keeps its slice
    and depth 3 under 5 keeps only its last."""
    slices = [slice(None)] * (x.ndim - len(spatial))
    for dim, size in zip(range(x.ndim - len(spatial), x.ndim), spatial):
        start = (x.shape[dim] - size) // 2
        lo, hi, _ = slice(start, start + size).indices(x.shape[dim])
        slices.append(slice(lo, max(lo, hi)))
    return x[tuple(slices)]


class VSUNet(TrainModule):
    """Virtual-staining U-Net engine.

    ``model_config`` takes the JAX engine's keys (lists become tuples;
    ``dtype`` may be a string such as ``"bfloat16"``). Weights are drawn
    from a ``torch.Generator`` seeded with ``seed``; load trained weights
    with ``model.load_state_dict`` (reference torch names). ``device``
    defaults to ``"cuda"`` and raises when no card is visible.
    ``loss_function`` defaults to ``MixedLoss()``; ``bf16_loss`` feeds it
    bf16 prediction and target (its math stays float32). ``freeze_encoder``
    leaves every ``encoder.*`` parameter out of the optimizer: no update,
    no weight decay (``optax.set_to_zero`` on the JAX side).
    """

    architectures = _UNET_ARCHITECTURE

    def __init__(
        self,
        architecture: Literal["2D", "UNeXt2", "2.5D", "FNet3D", "fcmae", "UNeXt2_2D"],
        model_config: dict | None = None,
        loss_function=None,
        lr: float = 1e-3,
        schedule: Literal["WarmupCosine", "Constant"] = "Constant",
        freeze_encoder: bool = False,
        warmup_steps: int = 0,
        warmup_multiplier: float = 1e-3,
        bf16_loss: bool = False,
        test_time_augmentations: bool = False,
        tta_type: Literal["mean", "median", "product"] = "mean",
        tile_yx: Sequence[int] | None = None,
        tile_batch: int = 104,
        fov_shard: bool = False,
        example_input_yx_shape: Sequence[int] = (256, 256),
        test_cellpose_model_path: str | None = None,
        test_cellpose_diameter: float | None = None,
        test_evaluate_cellpose: bool = False,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__()
        net_class = self.architectures.get(architecture)
        if net_class is None:
            raise ValueError(f"Architecture {architecture} not in {list(self.architectures)}")
        if fov_shard:
            raise NotImplementedError("fov_shard (one FOV across several cards) is not ported")
        if tta_type not in ("mean", "median", "product"):
            raise ValueError(f"tta_type must be mean, median or product, got {tta_type!r}")
        device = resolve_device(device)
        model_config = dict(model_config or {})
        if architecture in ("fcmae", "UNeXt2_2D"):
            model_config.setdefault("pretraining", architecture == "fcmae")
            if architecture == "UNeXt2_2D":
                model_config["pretraining"] = False
        for k, v in model_config.items():
            if isinstance(v, list):
                model_config[k] = tuple(v)
        self.architecture = architecture
        self.model_config = model_config
        self.model = net_class(**model_config, generator=torch.Generator().manual_seed(seed))
        self.model.to(device)
        self.loss_function = loss_function if loss_function is not None else MixedLoss()
        self.lr = lr
        self.schedule = schedule
        self.freeze_encoder = freeze_encoder
        self.warmup_steps = warmup_steps
        self.warmup_multiplier = warmup_multiplier
        self.bf16_loss = bf16_loss
        self.test_time_augmentations = test_time_augmentations
        self.tta_type = tta_type
        self.tile_yx = tuple(tile_yx) if tile_yx else None
        self.tile_batch = tile_batch
        self.example_input_yx_shape = tuple(example_input_yx_shape)
        # the test stage's segmentation leg
        self.test_cellpose_model_path = test_cellpose_model_path
        self.test_cellpose_diameter = test_cellpose_diameter
        self.test_evaluate_cellpose = test_evaluate_cellpose
        self._cellpose_model = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)

    def example_input(self) -> dict:
        """Zero ``source`` (1, C_in, D, *example_input_yx_shape) and ``target``
        (1, C_out, D_out, ...) arrays, as the JAX engine's (D = 1 for
        ``"2D"``)."""
        cfg = self.model_config
        depth = 1 if self.architecture == "2D" else cfg.get("in_stack_depth", 5)
        out_depth = getattr(self.model, "out_stack_depth", None) or depth
        yx = self.example_input_yx_shape
        return {
            "source": np.zeros((1, cfg.get("in_channels", 1), depth, *yx), np.float32),
            "target": np.zeros((1, cfg.get("out_channels", 1), out_depth, *yx), np.float32),
        }

    def _compute_loss(self, pred: torch.Tensor, target: torch.Tensor, batch: dict) -> torch.Tensor:
        if "fg_mask" in batch:
            return self.loss_function(pred, target, fg_mask=batch["fg_mask"])
        if self.bf16_loss and isinstance(self.loss_function, MixedLoss):
            pred = pred.to(torch.bfloat16)
            target = target.to(torch.bfloat16)
        return self.loss_function(pred, target)

    def training_loss(self, batch: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        """Supervised loss of the forward on ``batch["source"]`` against
        ``batch["target"]`` (NCDHW); a batch's ``fg_mask`` goes to the loss
        as ``fg_mask=``. ``generator`` draws the encoder's stochastic-depth
        masks (``encoder_drop_path_rate``), or the legacy U-Nets' dropout
        masks, in training mode; a model with a rate above 0 in training
        mode needs it. A model's BatchNorms (the legacy U-Nets', FNet3D's)
        update their running statistics in this forward, as the JAX engine
        takes its ``batch_stats`` updates from it."""
        pred = self.model(batch["source"], generator=generator)
        return self._compute_loss(pred, batch["target"], batch)

    def validation_loss(self, batch: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        """The loss of the deterministic forward (the trainer runs it in eval
        mode under ``torch.no_grad()``); ``generator`` is not drawn from."""
        return self._compute_loss(self.forward(batch["source"]), batch["target"], batch)

    def test_step(self, batch: dict) -> dict:
        """The test stage's metrics of one batch: the loss and MAE, MSE,
        Pearson, cosine and SSIM-2.5D (21 x 21 window) of the forward
        against ``batch["target"]``, each a 0-d tensor on the batch's
        device; with ``labels`` in the batch also the host segmentation
        metrics of :meth:`test_step_host` (Python floats) on its first
        sample's prediction."""
        pred = self.forward(batch["source"])
        target = batch["target"]
        loss = self._compute_loss(pred, target, batch)
        p, t = pred.float(), target.float()
        pf, tf = p.reshape(p.shape[0], -1), t.reshape(t.shape[0], -1)
        pc, tc = pf - pf.mean(dim=1, keepdim=True), tf - tf.mean(dim=1, keepdim=True)

        def corr(a, b):
            # norms as sqrt(sum of squares), jnp.linalg.norm's definition: on the CPU, torch's
            # float32 Tensor.norm over a 1024^2 x 30 sample drifts by 2e-3, its sum does not
            norm = lambda v: (v * v).sum(dim=1).sqrt()
            return ((a * b).sum(dim=1) / torch.clamp(norm(a) * norm(b), min=1e-8)).mean()

        out = {
            "loss": loss,
            "metrics/mae": (p - t).abs().mean(),
            "metrics/mse": (p - t).square().mean(),
            "metrics/pearson": corr(pc, tc),
            "metrics/cosine": corr(pf, tf),
            "metrics/ssim": ssim_25d(p, t, in_plane_window_size=(21, 21)).mean(),
        }
        if "labels" in batch:
            out.update(self.test_step_host(batch, pred[:1]))
        return out

    def _instance_segment(self, pred2d: np.ndarray) -> np.ndarray:
        """Instance labels of a predicted nuclei image: CellPose when a model
        path is configured (``ImportError`` when cellpose is not installed),
        else the native watershed."""
        if self.test_cellpose_model_path is not None and self._cellpose_model is None:
            try:
                from cellpose.models import CellposeModel
            except ImportError as e:
                raise ImportError(
                    "CellPose not installed; omit test_cellpose_model_path to use the native "
                    "watershed instance segmentation"
                ) from e
            self._cellpose_model = CellposeModel(model_type=self.test_cellpose_model_path)
        if self._cellpose_model is not None:
            masks = self._cellpose_model.eval(pred2d, channels=[0, 0], diameter=self.test_cellpose_diameter)[0]
            return np.asarray(masks).astype(np.int32)
        from viscy_tpu_torch.apps.dynacell.eval.segmentation import segment_nucleus_instances

        return segment_nucleus_instances(pred2d)

    def test_step_host(self, batch: dict, pred: torch.Tensor | None = None) -> dict:
        """The segmentation leg, on the host, for a batch with ``labels``:
        instance-segment the center slice of the first sample's prediction
        (``pred``, else a forward of that sample; the target's center slice
        with ``test_evaluate_cellpose``) and score it against the labels:
        pixel accuracy, Dice, Jaccard, mAP, mAP@50, mAP@75, mAR@100. Values
        that are not finite (no instance on either side) are left out."""
        if "labels" not in batch:
            return {}
        from viscy_tpu_torch.evaluation.metrics import mean_average_precision

        if self.test_evaluate_cellpose:
            target = batch["target"][:1]
            pred2d = target[0, 0, target.shape[-3] // 2]
        else:
            if pred is None:
                with torch.no_grad():
                    pred = self.forward(batch["source"][:1])
            # the prediction's own center: its depth may differ from the target's
            pred2d = pred[0, 0, pred.shape[-3] // 2]
        pred2d = pred2d.float().cpu().numpy()
        labels = batch["labels"].cpu().numpy()
        if labels.ndim == 3:
            labels = labels[0]
        pred_labels = self._instance_segment(pred2d)
        pb, tb = pred_labels > 0, labels > 0
        tp = float(np.logical_and(pb, tb).sum())
        coco = mean_average_precision(pred_labels, labels.astype(np.int32))
        out = {
            "metrics/accuracy": float((pb == tb).mean()),
            "metrics/dice_score": float(2 * tp / max(pb.sum() + tb.sum(), 1)),
            "metrics/jaccard": float(tp / max(np.logical_or(pb, tb).sum(), 1)),
            "metrics/mAP": float(coco["map"]),
            "metrics/mAP_50": float(coco["map_50"]),
            "metrics/mAP_75": float(coco["map_75"]),
            "metrics/mAR_100": float(coco["mar_100"]),
        }
        # an empty pair has no AP: leave it out of the mean over batches
        return {k: v for k, v in out.items() if np.isfinite(v)}

    def configure_optimizers(self, total_steps: int):
        """AdamW with the engine's schedule (``warmup_steps=0`` takes the
        default warmup of 1 % of ``total_steps``), over every parameter but
        the encoder's (UNeXt2's ``encoder_stages``, not its stem) when
        ``freeze_encoder``."""
        from viscy_tpu_torch.training.optimizers import configure_adamw_scheduler

        params = [
            p for name, p in self.named_parameters()
            if not (self.freeze_encoder and {"encoder", "encoder_stages"} & set(name.split(".")))
        ]
        return configure_adamw_scheduler(
            params,
            lr=self.lr,
            schedule=self.schedule,
            total_steps=total_steps,
            warmup_steps=self.warmup_steps or None,
            warmup_multiplier=self.warmup_multiplier,
        )

    def _pad_forward_crop(self, source: torch.Tensor, factor: int | None = None) -> torch.Tensor:
        """Divisible-pad, forward, center-crop. ``factor`` defaults to the
        reference-compatible ``2**num_blocks`` (the padded extent feeds the
        GRN's global statistics); the tiled path passes ``total_stride``."""
        original = source.shape[2:]
        padded = _divisible_pad(source, factor or 2**self.model.num_blocks,
                                pad_z=getattr(self.model, "downsamples_z", False))
        return _center_crop_to_shape(self.forward(padded), original)

    def _total_stride(self) -> int:
        return getattr(self.model, "total_stride", None) or 2**self.model.num_blocks

    def _full_frame_predict(self, source: torch.Tensor, factor: int | None = None):
        if not self.test_time_augmentations:
            return self._pad_forward_crop(source, factor=factor)
        orig_yx = source.shape[-2:]
        preds = []
        for fwd, inv in zip(*rotation_tta_transforms(4)):
            p = inv(self._pad_forward_crop(fwd(source), factor=factor))
            preds.append(_center_crop_to_shape(p, (p.shape[-3], *orig_yx)))
        stacked = torch.stack(preds)
        if self.tta_type == "mean":
            return stacked.mean(dim=0)
        if self.tta_type == "median":
            return tta_median(stacked)
        return torch.exp(torch.log(stacked + 1e-9).sum(dim=0))

    def predict_step(self, batch: dict) -> torch.Tensor:
        source = batch["source"]
        if self.tile_yx is not None and (
            source.shape[-2] > self.tile_yx[0] or source.shape[-1] > self.tile_yx[1]
        ):
            # tiles pad to the true stride, not the reference-compatible factor
            return tiled_forward_yx(
                lambda tiles: self._full_frame_predict(tiles, factor=self._total_stride()),
                source,
                tile=self.tile_yx,
                tile_batch=self.tile_batch,
            )
        return self._full_frame_predict(source)


class FcmaeUNet(VSUNet):
    """FCMAE engine (reference ``engine.py:808``): masked pretraining and
    fine-tuning.

    ``architecture`` defaults to ``"fcmae"``, so ``pretraining`` defaults to
    true, as in the JAX engine. With ``pretraining`` the training and
    validation losses are ``MaskedMSELoss`` (the configured loss when it is
    one) of the prediction against the SOURCE over the masked tokens; the
    mask is drawn at ``fit_mask_ratio``. Without it the steps are
    ``VSUNet``'s.

    ``encoder_only`` takes the encoder of the checkpoint at ``ckpt_path``
    (:meth:`load_pretrained`, which the trainer calls once the weights are
    built and before the optimizer, so a resume still wins); it raises
    ``ValueError`` without ``ckpt_path``. Without ``encoder_only``,
    ``ckpt_path`` loads nothing, as in the JAX engine (resume with the
    trainer's ``ckpt_path``). ``log_batches_per_epoch`` and
    ``log_samples_per_batch`` are the reference's image-logging knobs,
    accepted for its configs and unused: the JAX engine logs no images
    either.
    """

    def __init__(
        self,
        fit_mask_ratio: float = 0.0,
        encoder_only: bool = False,
        ckpt_path: str | Path | None = None,
        log_batches_per_epoch: int = 8,
        log_samples_per_batch: int = 1,
        architecture: Literal["fcmae", "UNeXt2_2D"] = "fcmae",
        device: str | torch.device = "cuda",
        **kwargs,
    ) -> None:
        if encoder_only and ckpt_path is None:
            raise ValueError("encoder_only=True requires ckpt_path")
        super().__init__(architecture, device=device, **kwargs)
        self.fit_mask_ratio = fit_mask_ratio
        self.encoder_only = encoder_only
        self._encoder_ckpt = ckpt_path if encoder_only else None
        if ckpt_path is not None and not encoder_only:
            _logger.warning("model ckpt_path %s loads nothing without encoder_only=True; pass the "
                            "trainer's ckpt_path to resume", ckpt_path)
        if self.model.pretraining and self.fit_mask_ratio <= 0.0:
            _logger.warning("FCMAE pretraining with fit_mask_ratio=0 — no masking applied")

    def load_pretrained(self) -> None:
        """Encoder-only transfer (reference ``engine.py:855-867``): copy every
        ``encoder.*`` tensor of the checkpoint at ``ckpt_path`` (a port or a
        Lightning checkpoint, or a bare ``state_dict``) into the model,
        bit for bit; the decoder and head keep their own weights. The
        checkpoint's encoder must be this model's, tensor for tensor and
        shape for shape, else ``ValueError`` (the JAX engine replaces the
        whole encoder tree, which then fails at its first use; a stem of
        another ``stem_kernel_size`` or ``in_stack_depth`` is named).
        ``KeyError`` when the checkpoint has no encoder tensors; a directory
        (an orbax checkpoint of the JAX package) raises by name."""
        if self._encoder_ckpt is None:
            return
        from viscy_tpu_torch.training.trainer import read_checkpoint

        path = Path(self._encoder_ckpt)
        if path.is_dir():
            raise ValueError(
                f"{path} is a directory, an orbax checkpoint of the JAX package, which this package "
                "cannot read without orbax: convert its params with "
                "viscy_tpu_torch.training.convert.fcmae_state_dict_from_flax, torch.save the result "
                "and point ckpt_path at that file"
            )
        _, state = read_checkpoint(path)
        src = {k[len("encoder."):]: v for k, v in state.items() if k.startswith("encoder.")}
        if not src:
            raise KeyError(f"checkpoint {path} has no encoder parameters")
        own = self.model.encoder.state_dict()
        extra, missing = sorted(set(src) - set(own)), sorted(set(own) - set(src))
        shaped = sorted(k for k in own if k in src and src[k].shape != own[k].shape)
        if extra or missing or shaped:
            stem = [f"encoder.{k} {tuple(src[k].shape)} here {tuple(own[k].shape)}" for k in shaped
                    if k.startswith("stem.") and k.endswith(".weight")]
            hint = (f"; the stem kernels differ ({', '.join(stem)}): pretrain with this model's "
                    "stem_kernel_size and in_stack_depth" if stem else "")
            found = [f"{what} {keys[:6]}" for what, keys in (("tensors the model lacks", extra),
                     ("tensors the checkpoint lacks", missing), ("tensors of another shape", shaped)) if keys]
            raise ValueError(f"checkpoint {path} encoder does not fit the model: {'; '.join(found)}{hint}")
        with torch.no_grad():
            for k, t in own.items():
                t.copy_(src[k])
        _logger.info("Loaded encoder parameters from %s", path)

    def forward_fit_fcmae(
        self,
        batch: dict,
        generator: torch.Generator | None = None,
        drop_path_masks=None,
        mask: torch.Tensor | None = None,
    ):
        """``(pred, target, mask)`` of the pretraining forward on
        ``batch["source"]`` at ``fit_mask_ratio``: the target is the source,
        the mask ``(B, 1, H, W)`` bool (True = masked). The token mask, then
        the drop-path masks, are drawn from ``generator`` (as the JAX engine
        draws both from the step's rng), unless given (the token mask
        low-resolution)."""
        source = batch["source"]
        pred, mask = self.model(source, generator=generator, drop_path_masks=drop_path_masks,
                                mask_ratio=self.fit_mask_ratio, mask_generator=generator, mask=mask)
        return pred, source, mask

    def _masked_loss(self, pred, target, mask) -> torch.Tensor:
        if mask is None:
            raise ValueError("FCMAE pretraining at fit_mask_ratio=0 masks nothing: the masked loss has no "
                             "tokens to average")
        loss_fn = self.loss_function if isinstance(self.loss_function, MaskedMSELoss) else MaskedMSELoss()
        return loss_fn(pred, target, mask.float())

    def training_loss(self, batch: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        """With ``pretraining``: the masked loss of the forward against the
        source, the token mask and stochastic depth drawn from
        ``generator``; else ``VSUNet.training_loss``."""
        if not self.model.pretraining:
            return super().training_loss(batch, generator)
        return self._masked_loss(*self.forward_fit_fcmae(batch, generator))

    def validation_loss(self, batch: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        """With ``pretraining``: as :meth:`training_loss`, the token mask and
        any stochastic depth drawn from ``generator``. The JAX engine runs
        this forward with ``deterministic=False``, so the encoder's drop
        path acts in validation too; the model runs in training mode for
        it. Else ``VSUNet.validation_loss``."""
        if not self.model.pretraining:
            return super().validation_loss(batch, generator)
        was_training = self.model.training
        self.model.train()
        try:
            return self._masked_loss(*self.forward_fit_fcmae(batch, generator))
        finally:
            self.model.train(was_training)
