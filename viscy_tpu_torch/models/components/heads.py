"""Output heads (counterpart of ``viscy_tpu/models/components/heads.py``):
the spatial heads re-inflate channels-last 2-D decoder features to
``(B, C, D, H, W)`` voxels; the projection MLP maps contrastive embeddings;
the auxiliary heads (:class:`ClassificationHead`,
:class:`CrossModalContrastiveHead`) compute a loss of their own on the
contrastive engine's anchor embedding.
"""

from __future__ import annotations

import math
from typing import Literal, Sequence

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from viscy_tpu_torch.models.components.blocks import (
    BatchNorm,
    Conv,
    LayerNorm,
    Linear,
    icnr_init,
    pad_pool_blur_2d,
    pixel_shuffle_2d,
)
from viscy_tpu_torch.parallel.mesh import gather_batch


def normal_init(std: float):
    """flax ``initializers.normal(std)`` (MONAI's ``normal_init``)."""

    def init(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return nn.init.normal_(weight, 0.0, std, generator=generator)

    return init


class _ConvPReLU(nn.Module):
    """MONAI ``Convolution`` parameters as the reference names them: ``conv``
    and the PReLU's single slope ``adn.A.weight`` (0.25 at init)."""

    def __init__(self, in_ch: int, out_ch: int, generator: torch.Generator) -> None:
        super().__init__()
        self.conv = Conv(in_ch, out_ch, (3, 3, 3), generator, init=normal_init(0.02))
        self.adn = nn.ModuleDict({"A": nn.PReLU(1, 0.25)})


class PixelToVoxelHead(nn.Module):
    """Pixel-shuffle head (reference ``heads.py:594``): 2-D features ->
    3-D voxels. Pixel shuffle x2 (optionally pad-pool blurred), the channels
    folded into ``out_stack_depth + 2`` slices (``c*D + d``), a 3x3x3 conv
    valid in Z, a non-affine instance norm (float32 statistics with the fast
    variance, eps 1e-6 as the JAX package's flax ``GroupNorm``), PReLU with
    one slope, a 1x1x1 conv (ICNR init), float32, then a per-slice pixel
    shuffle x2. Channels-last ``(B, h, w, C)`` in, float32 ``(B, C_out, D,
    4h, 4w)`` out."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        out_stack_depth: int,
        generator: torch.Generator,
        expansion_ratio: int = 4,
        pool: bool = False,
        dtype: torch.dtype = torch.float32,
        eps: float = 1e-6,
    ) -> None:
        super().__init__()
        self.out_stack_depth = out_stack_depth
        self.pool = pool
        self.dtype = dtype
        self.eps = eps
        mid = out_channels * expansion_ratio * 2**2
        c_in = in_channels // 2**2 // (out_stack_depth + 2)
        self.conv = nn.ModuleList(
            [
                _ConvPReLU(c_in, mid, generator),
                Conv(mid, out_channels * 2**2, (1, 1, 1), generator, init=icnr_init(2, 2)),
            ]
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = pixel_shuffle_2d(x, 2)
        if self.pool:
            x = pad_pool_blur_2d(x, 2)
        x = rearrange(x, "b h w (c d) -> b c d h w", d=self.out_stack_depth + 2)
        first, last = self.conv
        y = F.conv3d(x.to(dt), first.conv.weight.to(dt), None, 1, (0, 1, 1))
        y = y + first.conv.bias.to(dt).view(1, -1, 1, 1, 1)
        y32 = y.float()
        mu = y32.mean(dim=(2, 3, 4), keepdim=True)
        var = torch.clamp_min((y32 * y32).mean(dim=(2, 3, 4), keepdim=True) - mu * mu, 0.0)
        y = ((y32 - mu) * torch.rsqrt(var + self.eps)).to(y.dtype)
        y = torch.where(y >= 0, y, first.adn["A"].weight * y)
        y = F.conv3d(y.to(dt), last.weight.to(dt)) + last.bias.to(dt).view(1, -1, 1, 1, 1)
        return rearrange(y.float(), "b (c i j) d h w -> b c d (h i) (w j)", i=2, j=2)


class ProjectionMLP(nn.Sequential):
    """Linear -> BN -> ReLU -> Linear -> BN (reference
    ``contrastive/encoder.py:118``), state names ``0``, ``1``, ``3``, ``4``;
    the BatchNorms update their running statistics as flax does
    (:class:`BatchNorm`) in training mode."""

    def __init__(self, in_dims: int, hidden_dims: int, out_dims: int, generator: torch.Generator) -> None:
        super().__init__(
            Linear(in_dims, hidden_dims, generator),
            BatchNorm(hidden_dims),
            nn.ReLU(),
            Linear(hidden_dims, out_dims, generator),
            BatchNorm(out_dims),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fc0, bn0, _, fc1, bn1 = self
        x = torch.relu(bn0(F.linear(x, fc0.weight, fc0.bias)))
        return bn1(F.linear(x, fc1.weight, fc1.bias))


class PixelToVoxelShuffleHead(nn.Module):
    """Pure pixel-shuffle head (reference ``heads.py:656``): one sub-pixel
    upsample by ``xy_scaling`` (optionally pad-pool blurred), then the
    channels unfold into ``(C_out, D)`` with torch ordering ``c*D + d``.
    Channels-last ``(B, h, w, C_out*D*r*r)`` in, ``(B, C_out, D, H, W)`` out,
    in the input's dtype. It has no parameters."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        out_stack_depth: int = 5,
        xy_scaling: int = 4,
        pool: bool = False,
    ) -> None:
        super().__init__()
        self.out_channels = out_channels
        self.out_stack_depth = out_stack_depth
        self.xy_scaling = xy_scaling
        self.pool = pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pixel_shuffle_2d(x, self.xy_scaling)
        if self.pool:
            x = pad_pool_blur_2d(x, self.xy_scaling)
        return rearrange(
            x, "b h w (c d) -> b c d h w", c=self.out_channels, d=self.out_stack_depth
        )


# -- auxiliary heads (reference heads.py:34-346) ----------------------------------------------


class CosineClassifier(nn.Module):
    """L2-normalized linear head with a learnable log-temperature
    (reference ``heads.py:430``): ``exp(log_scale) * x^ @ w^.T``, rows of
    ``x`` and ``weight (num_classes, in_dim)`` normalized with eps 1e-12."""

    def __init__(self, in_dim: int, num_classes: int, generator: torch.Generator, init_scale: float = 20.0,
                 learn_scale: bool = True) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty((num_classes, in_dim)))
        with torch.no_grad():
            normal_init(0.01)(self.weight, generator)
        log_scale = torch.tensor(math.log(init_scale))
        if learn_scale:
            self.log_scale = nn.Parameter(log_scale)
        else:
            self.register_buffer("log_scale", log_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xn = x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-12)
        wn = self.weight / (torch.linalg.vector_norm(self.weight, dim=1, keepdim=True) + 1e-12)
        return torch.exp(self.log_scale) * (xn @ wn.T)


class MLP(nn.Module):
    """The JAX package's configurable MLP (reference ``heads.py:470``) as the
    auxiliary heads build it: hidden layers ``fc{i}`` -> LayerNorm
    ``norm{i}`` (flax's, eps 1e-6) -> ReLU, then either the projection
    ``fc_out`` -> ``norm_out`` (``num_classes`` None) or the classifier
    ``head`` (cosine or linear)."""

    def __init__(
        self,
        in_dims: int,
        hidden_dims: int | Sequence[int],
        generator: torch.Generator,
        out_dims: int | None = None,
        num_classes: int | None = None,
        cosine_classifier: bool = True,
    ) -> None:
        super().__init__()
        if num_classes is None and out_dims is None:
            raise ValueError("out_dims is required in projection mode")
        hidden = [hidden_dims] if isinstance(hidden_dims, int) else list(hidden_dims)
        self.num_classes = num_classes
        self.n_hidden = len(hidden)
        dims = [in_dims, *hidden]
        for i, (a, b) in enumerate(zip(dims, dims[1:])):
            self.add_module(f"fc{i}", Linear(a, b, generator))
            self.add_module(f"norm{i}", LayerNorm(b))
        if num_classes is None:
            self.fc_out = Linear(dims[-1], out_dims, generator)
            self.norm_out = LayerNorm(out_dims)
        elif cosine_classifier:
            self.head = CosineClassifier(dims[-1], num_classes, generator)
        else:
            self.head = Linear(dims[-1], num_classes, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_hidden):
            fc = getattr(self, f"fc{i}")
            x = torch.relu(getattr(self, f"norm{i}")(F.linear(x, fc.weight, fc.bias), x.dtype))
        if self.num_classes is None:
            return self.norm_out(F.linear(x, self.fc_out.weight, self.fc_out.bias), x.dtype)
        if isinstance(self.head, CosineClassifier):
            return self.head(x)
        return F.linear(x, self.head.weight, self.head.bias)


def _head_generator(generator: torch.Generator | None) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


class BaseHead(nn.Module):
    """An auxiliary task head (reference ``heads.py:34``): it names its batch
    key and computes ``(loss, metrics)`` from ``(features, targets)``; its
    loss weight at an epoch is :meth:`weight_at` (constant, or a cosine ramp
    from ``weight_start`` over ``weight_warmup_epochs``)."""

    def __init__(
        self,
        head_name: str = "aux",
        batch_key: str = "label",
        loss_weight: float = 1.0,
        weight_schedule: Literal["cosine", "constant"] = "constant",
        weight_start: float = 0.0,
        weight_warmup_epochs: int = 50,
    ) -> None:
        super().__init__()
        self.head_name = head_name
        self.batch_key = batch_key
        self.loss_weight = loss_weight
        self.weight_schedule = weight_schedule
        self.weight_start = weight_start
        self.weight_warmup_epochs = weight_warmup_epochs

    def weight_at(self, epoch: int) -> float:
        if self.weight_schedule == "cosine":
            from viscy_tpu_torch.models.contrastive.loss import cosine_anneal

            return cosine_anneal(self.weight_start, self.loss_weight, epoch, self.weight_warmup_epochs)
        return self.loss_weight


class ClassificationHead(BaseHead):
    """MLP classifier (reference ``heads.py:159``): cross-entropy of the
    ``(B,)`` integer labels, with top-1 and top-k accuracies. ``norm="bn"``
    raises: the contrastive engine keeps no head batch statistics, in the
    JAX package as here."""

    def __init__(
        self,
        in_dims: int = 768,
        hidden_dims: int | Sequence[int] = 256,
        num_classes: int = 2,
        cosine_classifier: bool = True,
        top_k: int = 5,
        norm: Literal["bn", "ln"] = "ln",
        generator: torch.Generator | None = None,
        **base,
    ) -> None:
        super().__init__(**base)
        if norm != "ln":
            raise NotImplementedError(f"ClassificationHead norm={norm!r}: only 'ln' runs (a head's BatchNorm has "
                                      "no state in the contrastive engine)")
        self.in_dims = in_dims
        self.num_classes = num_classes
        self.top_k = top_k
        self.mlp = MLP(in_dims, hidden_dims, _head_generator(generator), num_classes=num_classes,
                       cosine_classifier=cosine_classifier)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, dict]:
        logits = self.mlp(x)
        y = y.to(torch.int64)
        logp = torch.log_softmax(logits, dim=-1)
        loss = -logp.gather(-1, y[:, None]).mean()
        top1 = (logits.argmax(dim=-1) == y).float().mean()
        topk_idx = torch.topk(logits, min(self.top_k, self.num_classes), dim=-1).indices
        topk = (topk_idx == y[:, None]).any(dim=-1).float().mean()
        return loss, {f"metrics/acc_top1/{self.head_name}": top1, f"metrics/acc_top{self.top_k}/{self.head_name}": topk}


class CrossModalContrastiveHead(BaseHead):
    """Cross-modal InfoNCE head (reference ``heads.py:274``): image features
    and a paired ``(B, target_dims)`` vector projected into one space,
    symmetric InfoNCE across the batch; rows with a NaN target are unpaired:
    they weigh nothing and their columns are left out of every softmax. In a
    job of several processes the batch is the global one
    (:func:`~viscy_tpu_torch.parallel.mesh.gather_batch`), every rank
    computing the one loss."""

    def __init__(
        self,
        in_dims: int = 768,
        target_dims: int = 50,
        proj_dims: int = 128,
        image_hidden: int | Sequence[int] = 256,
        target_hidden: int | Sequence[int] = 128,
        temperature: float = 0.1,
        generator: torch.Generator | None = None,
        **base,
    ) -> None:
        super().__init__(**base)
        self.in_dims = in_dims
        self.target_dims = target_dims
        self.temperature = temperature
        g = _head_generator(generator)
        self.image_proj = MLP(in_dims, image_hidden, g, out_dims=proj_dims)
        self.target_proj = MLP(target_dims, target_hidden, g, out_dims=proj_dims)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, dict]:
        unit = lambda z: z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-12)
        z_img = gather_batch(unit(self.image_proj(x)))
        z_tgt = gather_batch(unit(self.target_proj(torch.nan_to_num(y, nan=0.0))))
        valid = gather_batch((~torch.isnan(y).any(dim=-1)).to(z_img.dtype)) > 0.5
        logits = (z_img @ z_tgt.T) / self.temperature
        neg_inf = torch.finfo(logits.dtype).min
        l_i2t = torch.where(valid[None, :], logits, neg_inf)
        l_t2i = torch.where(valid[None, :], logits.T, neg_inf)
        ce_i2t = -torch.diagonal(torch.log_softmax(l_i2t, dim=-1))
        ce_t2i = -torch.diagonal(torch.log_softmax(l_t2i, dim=-1))
        w = valid.to(logits.dtype)
        n_valid = w.sum()
        per_row = torch.where(valid, 0.5 * (ce_i2t + ce_t2i), 0.0)
        denom = torch.clamp_min(n_valid, 1.0)
        zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
        loss = torch.where(n_valid >= 2, per_row.sum() / denom, zero)
        cos_diag = torch.where(n_valid >= 1, ((z_img * z_tgt).sum(-1) * w).sum() / denom, zero)
        diag = torch.arange(logits.shape[0], device=logits.device)
        hit = (l_i2t.argmax(dim=-1) == diag).to(logits.dtype)
        retrieval = torch.where(n_valid >= 1, (hit * w).sum() / denom, zero)
        return loss, {
            f"metrics/paired_frac/{self.head_name}": w.mean(),
            f"metrics/cos/{self.head_name}": cos_diag,
            f"metrics/r@1/{self.head_name}": retrieval,
        }
