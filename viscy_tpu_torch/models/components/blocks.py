"""ConvNeXt(-v2) building blocks, the timm-style multiscale encoder and the
UNeXt2 decoder (counterpart of ``viscy_tpu/models/components/blocks.py``).

Activations are channels-last ``(B, H, W, C)`` as in the JAX package; the
convolutions view them as channels-last NCHW tensors, so no copy is made.
Parameters are float32 and use the reference VisCy torch layout and names
(``(O, I, kh, kw)`` convs, ``(O, I)`` linears), so released checkpoints
load with ``strict=True``. ``dtype`` is the compute dtype: inputs and
weights are cast to it where flax casts them (conv/dense outputs and their
bias adds in ``dtype``; LayerNorm statistics in float32). No autocast.

Every ConvNeXt-v2 block (GRN, no layer scale) runs its LN -> fc1 -> GELU ->
GRN -> fc2 -> residual segment through
:func:`viscy_tpu_torch.ops.fused_block.fused_mlp_grn` (the Hopper kernel on
the card, its plain version on the CPU); v1 blocks (layer scale, no GRN)
run in plain torch.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from viscy_tpu_torch.ops.fused_block import fused_mlp_grn
from viscy_tpu_torch.parallel.mesh import data_parallel, global_sum

Init = Callable[[torch.Tensor, torch.Generator], torch.Tensor]

# ConvNeXt(-v2) backbones: name -> (depths, dims) (the JAX package's table)
CONVNEXT_ARCHS: dict[str, tuple[tuple[int, ...], tuple[int, ...]]] = {
    "convnextv2_atto": ((2, 2, 6, 2), (40, 80, 160, 320)),
    "convnextv2_femto": ((2, 2, 6, 2), (48, 96, 192, 384)),
    "convnextv2_pico": ((2, 2, 6, 2), (64, 128, 256, 512)),
    "convnextv2_nano": ((2, 2, 8, 2), (80, 160, 320, 640)),
    "convnextv2_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnextv2_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnextv2_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    # narrow stand-ins for CPU tests
    "convnextv2_test": ((1, 1, 2, 1), (16, 32, 64, 128)),
    "convnext_test": ((1, 1, 2, 1), (16, 32, 64, 128)),
}


def convnext_arch(backbone: str) -> tuple[tuple[int, ...], tuple[int, ...], bool]:
    """``(depths, dims, v2)`` of a backbone: v2 blocks have GRN and no layer
    scale, v1 (``convnext_*``) blocks a layer scale and no GRN."""
    if backbone not in CONVNEXT_ARCHS:
        raise ValueError(f"Unknown backbone {backbone!r}")
    depths, dims = CONVNEXT_ARCHS[backbone]
    return depths, dims, "v2" in backbone

# std of a unit normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


def _fan_in(weight: torch.Tensor) -> int:
    # torch layout (O, I, *kernel): fan_in = I * prod(kernel)
    return math.prod(weight.shape[1:])


def trunc_normal_init(std: float = 0.02) -> Init:
    """timm ``_init_weights`` init: normal with ``std`` truncated at +-2 std
    (flax ``truncated_normal(stddev=std)``)."""

    def init(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)

    return init


def variance_scaling_init(scale: float) -> Init:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")``:
    ``scale=1`` is ``lecun_normal`` (flax's conv/dense default), ``scale=2``
    is ``he_normal``."""

    def init(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        std = math.sqrt(scale / _fan_in(weight)) / _TRUNC_STD
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)

    return init


def icnr_init(upsample_factor: int, upsample_dims: int, init: Init | None = None) -> Init:
    """ICNR init for a weight whose output feeds a pixel shuffle (reference
    ``components/blocks.py:14``): the ``factor**dims`` output channels of
    each shuffled phase group start equal. Output channel ``o = c * scale +
    phase`` (pixel-shuffle order), so one sub-kernel repeats along dim 0."""
    init = init or variance_scaling_init(2.0)
    scale = upsample_factor**upsample_dims

    def initializer(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        out = weight.shape[0]
        if scale <= 1 or out % scale:
            return init(weight, generator)
        sub = init(torch.empty((out // scale, *weight.shape[1:])), generator)
        with torch.no_grad():
            weight.copy_(sub.repeat_interleave(scale, dim=0))
        return weight

    return initializer


class Conv(nn.Module):
    """Convolution parameters ``weight (O, I/groups, *kernel)`` and ``bias (O,)``."""

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        kernel: Sequence[int],
        generator: torch.Generator,
        groups: int = 1,
        bias: bool = True,
        init: Init | None = None,
    ) -> None:
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty((out_ch, in_ch // groups, *kernel)))
        with torch.no_grad():
            (init or variance_scaling_init(1.0))(self.weight, generator)
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def nhwc(self, x: torch.Tensor, dtype: torch.dtype, stride: int = 1, padding: int = 0):
        """flax ``nn.Conv(dtype=dtype)`` on channels-last 2-D input."""
        y = F.conv2d(
            x.permute(0, 3, 1, 2).to(dtype),
            self.weight.to(dtype),
            None,
            stride,
            padding,
            1,
            self.groups,
        ).permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


class Linear(nn.Module):
    """Dense parameters ``weight (O, I)`` and ``bias (O,)`` (``None`` with
    ``bias=False``)."""

    def __init__(
        self, in_dim: int, out_dim: int, generator: torch.Generator, init: Init | None = None, bias: bool = True
    ) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty((out_dim, in_dim)))
        with torch.no_grad():
            (init or variance_scaling_init(1.0))(self.weight, generator)
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float, dtype: torch.dtype
) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=dtype)`` over the last axis: f32 statistics
    with the fast variance ``max(E[x^2] - mu^2, 0)``, output in ``dtype``."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp_min((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu, 0.0)
    y = (x32 - mu) * (torch.rsqrt(var + eps) * weight.float()) + bias.float()
    return y.to(dtype)


class LayerNorm(nn.Module):
    """Channels-last LayerNorm with ``weight``/``bias`` (flax scale/bias)."""

    def __init__(self, dim: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps, dtype)


class GRN(nn.Module):
    """Global Response Normalization (ConvNeXt-v2) parameters: ``gamma``
    (``weight``) and ``beta`` (``bias``), both zero at init. The GRN itself
    (``gx = ||x||_2`` over the spatial axes, ``nx = gx / mean_c(gx)``,
    ``gamma * x * nx + beta + x``) runs inside
    :func:`viscy_tpu_torch.ops.fused_block.fused_mlp_grn`."""

    def __init__(self, dim: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over every axis but
    the last, under torch ``BatchNorm`` state names (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``).

    In training the batch statistics are computed in at least float32 (a
    float64 input keeps float64, as flax promotes them) with the fast
    variance ``max(E[x^2] - mu^2, 0)``, the BIASED variance, and the running
    statistics take ``momentum * running + (1 - momentum) * batch`` with
    that biased variance, as flax updates them (torch's own BatchNorm would
    store the unbiased one). In eval the running statistics normalize.

    In a job of several processes the training statistics are the global
    batch's, as in the JAX step over the sharded batch: the sums of ``x``
    and ``x * x`` and the count are summed over the processes
    (:func:`~viscy_tpu_torch.parallel.mesh.global_sum`, gradient included),
    so the running statistics stay equal on every rank."""

    def __init__(self, dim: int, momentum: float = 0.9, eps: float = 1e-5) -> None:
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xs = x.to(torch.promote_types(x.dtype, torch.float32))
            axes = tuple(range(x.ndim - 1))
            if data_parallel():
                c = x.shape[-1]
                count = xs.new_full((1,), xs.numel() // c)
                sums = global_sum(torch.cat([xs.sum(dim=axes), (xs * xs).sum(dim=axes), count]))
                mean = sums[:c] / sums[-1]
                var = torch.clamp_min(sums[c : 2 * c] / sums[-1] - mean * mean, 0.0)
            else:
                mean = xs.mean(dim=axes)
                var = torch.clamp_min((xs * xs).mean(dim=axes) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def pixel_shuffle_2d(x: torch.Tensor, r: int) -> torch.Tensor:
    """Sub-pixel upsample, torch ``nn.PixelShuffle`` channel order:
    ``(B, H, W, C*r*r) -> (B, H*r, W*r, C)``, channel ``k = c*r^2 + i*r + j``."""
    return rearrange(x, "b h w (c i j) -> b (h i) (w j) c", i=r, j=r)


def pad_pool_blur_2d(x: torch.Tensor, r: int) -> torch.Tensor:
    """MONAI SubpixelUpsample pad-pool blur: zero pad of ``r - 1`` on the
    LEADING (top/left) edges, then a stride-1 ``r x r`` mean."""
    if r == 1:
        return x
    x = F.pad(x, (0, 0, r - 1, 0, r - 1, 0))
    return F.avg_pool2d(x.permute(0, 3, 1, 2), r, stride=1).permute(0, 2, 3, 1)


class GrnMlp(nn.Module):
    """fc1 / GRN / fc2 parameters of a ConvNeXt MLP. ``conv_mlp`` keeps
    fc1/fc2 as 1x1 convs (timm ``conv_mlp=True``, the decoder), else dense;
    ``use_grn=False`` (the v1 block) has no GRN."""

    def __init__(
        self,
        dim: int,
        hidden: int,
        generator: torch.Generator,
        conv_mlp: bool = False,
        fc2_init: Init | None = None,
        use_grn: bool = True,
    ) -> None:
        super().__init__()
        if conv_mlp:
            self.fc1 = Conv(dim, hidden, (1, 1), generator, init=trunc_normal_init())
            self.grn = GRN(hidden) if use_grn else None
            self.fc2 = Conv(hidden, dim, (1, 1), generator, init=fc2_init or trunc_normal_init())
        else:
            self.fc1 = Linear(dim, hidden, generator, init=trunc_normal_init())
            self.grn = GRN(hidden) if use_grn else None
            self.fc2 = Linear(hidden, dim, generator, init=fc2_init or trunc_normal_init())


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` over the last axis (a 1x1 conv weight is
    viewed as 2-D): the product in ``dtype``, then the bias added in it."""
    w = weight.reshape(weight.shape[0], -1)
    return F.linear(x.to(dtype), w.to(dtype)) + bias.to(dtype)


def mlp_grn_residual(
    x: torch.Tensor,
    shortcut: torch.Tensor,
    norm: LayerNorm,
    mlp: GrnMlp,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """``shortcut + fc2(GRN(gelu(fc1(LN(x)))))`` on channels-last maps
    through the fused kernel (the block's whole MLP segment); ``mask``
    (``(B, H, W)``, 1 where tokens are kept) gives the masked FCMAE
    semantics: GRN statistics over kept tokens, the branch zeroed at
    masked ones."""
    b, h, w, c = x.shape
    m = mlp.grn.weight.shape[0]
    out = fused_mlp_grn(
        x.reshape(b, h * w, c).contiguous(),
        shortcut.reshape(b, h * w, c).contiguous(),
        norm.weight,
        norm.bias,
        mlp.fc1.weight.view(m, c),
        mlp.fc1.bias,
        mlp.grn.weight,
        mlp.grn.bias,
        mlp.fc2.weight.view(c, m),
        mlp.fc2.bias,
        mask=None if mask is None else mask.reshape(b, h * w),
        eps_ln=norm.eps,
        eps_grn=mlp.grn.eps,
    )
    return out.reshape(b, h, w, c)


class DropPath(nn.Module):
    """Per-sample stochastic depth on a residual branch (counterpart of
    ``viscy_tpu/models/components/blocks.py``'s ``DropPath``).

    In training at ``rate > 0`` each sample's branch is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, else zeroed:
    ``where(keep, x / keep_prob, 0)``, the division in ``x``'s dtype (the
    keep probability rounded to it first, as JAX rounds a Python float to a
    bf16 array's dtype). The keep mask is drawn from an explicit
    ``torch.Generator`` (never from global RNG state), or given as a
    ``(B,)`` tensor. In eval mode, or at rate 0, the branch passes as is."""

    def __init__(self, rate: float = 0.0) -> None:
        super().__init__()
        self.rate = float(rate)

    @property
    def active(self) -> bool:
        return self.training and self.rate > 0.0

    def keep_mask(self, batch: int, generator: torch.Generator) -> torch.Tensor:
        """A ``(B,)`` bool mask, each entry kept with probability ``1 - rate``."""
        return torch.rand((batch,), generator=generator, device=generator.device) < 1.0 - self.rate

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None, keep: torch.Tensor | None = None
    ) -> torch.Tensor:
        if not self.active:
            return x
        if keep is None:
            if generator is None:
                raise ValueError("DropPath in training needs a torch.Generator or a keep mask")
            keep = self.keep_mask(x.shape[0], generator)
        keep = keep.to(device=x.device, dtype=torch.bool).reshape((-1,) + (1,) * (x.ndim - 1))
        # filled on the device: no host-to-device copy, no sync
        keep_prob = torch.full((), 1.0 - self.rate, dtype=x.dtype, device=x.device)
        return torch.where(keep, x / keep_prob, x.new_zeros(()))


class ConvNeXtBlock(nn.Module):
    """timm ConvNeXt block: 7x7 depthwise conv (with bias) -> LN -> MLP ->
    residual (counterpart of the JAX ``ConvNeXtBlock``).

    ``use_grn`` (v2: GRN, no layer scale) runs LN/fc1/GELU/GRN/fc2 and the
    residual add through the fused kernel; with ``ls_init_value`` (v1: a
    layer-scale ``gamma``, no GRN) the MLP runs in plain torch. ``conv_mlp``
    keeps fc1/fc2 as 1x1 convs (the decoder), else Linear (the encoder).
    With stochastic depth active (training, ``drop_path > 0``) the v2 kernel
    computes the branch alone (a zero shortcut: ``0 + z`` is ``z``), then
    ``DropPath`` scales it and the shortcut is added in torch, the JAX
    unfused block's order (exact for 0/1 keep masks)."""

    def __init__(
        self,
        dim: int,
        generator: torch.Generator,
        kernel_size: int = 7,
        mlp_ratio: int = 4,
        dtype: torch.dtype = torch.float32,
        fc2_init: Init | None = None,
        conv_mlp: bool = True,
        use_grn: bool = True,
        ls_init_value: float | None = None,
        drop_path: float = 0.0,
    ) -> None:
        super().__init__()
        if use_grn == (ls_init_value is not None):
            raise ValueError("a ConvNeXt block is v2 (GRN, no layer scale) or v1 (layer scale, no GRN)")
        self.dtype = dtype
        self.kernel_size = kernel_size
        self.conv_dw = Conv(
            dim, dim, (kernel_size, kernel_size), generator, groups=dim, init=trunc_normal_init()
        )
        self.norm = LayerNorm(dim)
        self.mlp = GrnMlp(
            dim, mlp_ratio * dim, generator, conv_mlp=conv_mlp, fc2_init=fc2_init, use_grn=use_grn
        )
        self.gamma = None if use_grn else nn.Parameter(torch.full((dim,), float(ls_init_value)))
        self.drop_path = DropPath(drop_path)

    def _v1_branch(self, y: torch.Tensor) -> torch.Tensor:
        """LN -> fc1 -> GELU -> fc2 -> layer scale, as the unfused flax
        block (the f32 ``gamma`` promotes a bf16 branch to f32, as in JAX)."""
        dt = self.dtype
        h = self.norm(y, dt)
        h = F.gelu(dense(h, self.mlp.fc1.weight, self.mlp.fc1.bias, dt))
        return dense(h, self.mlp.fc2.weight, self.mlp.fc2.bias, dt) * self.gamma

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None, keep: torch.Tensor | None = None
    ) -> torch.Tensor:
        y = self.conv_dw.nhwc(x, self.dtype, padding=self.kernel_size // 2)
        if self.gamma is not None:
            branch = self._v1_branch(y)
        elif not self.drop_path.active:
            return mlp_grn_residual(y, x, self.norm, self.mlp)
        else:
            branch = mlp_grn_residual(y, torch.zeros_like(y), self.norm, self.mlp)
        return x + self.drop_path(branch, generator, keep)


def downsample(in_chs: int, out_chs: int, k: int, generator: torch.Generator) -> nn.ModuleList:
    """LayerNorm + ``k x k`` stride-``k`` conv pair (timm stage downsample;
    state-dict names ``downsample.0`` / ``downsample.1``)."""
    return nn.ModuleList(
        [LayerNorm(in_chs), Conv(in_chs, out_chs, (k, k), generator, init=trunc_normal_init())]
    )


def apply_downsample(ds: nn.ModuleList, x: torch.Tensor, stride: int, dtype) -> torch.Tensor:
    return ds[1].nhwc(ds[0](x, dtype), dtype, stride=stride)


class ConvNeXtStage(nn.Module):
    """Optional LN + strided-conv downsample (when ``in_chs != out_chs`` or
    ``stride > 1``), then ConvNeXt blocks; ``last_fc2_init`` initializes the
    last block's fc2 (ICNR when the stage feeds a pixel shuffle).
    ``drop_path_rates`` are the blocks' stochastic-depth rates."""

    def __init__(
        self,
        in_chs: int,
        out_chs: int,
        generator: torch.Generator,
        depth: int = 2,
        stride: int = 2,
        kernel_size: int = 7,
        mlp_ratio: int = 4,
        dtype: torch.dtype = torch.float32,
        last_fc2_init: Init | None = None,
        conv_mlp: bool = True,
        use_grn: bool = True,
        ls_init_value: float | None = None,
        drop_path_rates: Sequence[float] | None = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.downsample = None
        if in_chs != out_chs or stride > 1:
            self.downsample = downsample(in_chs, out_chs, stride if stride > 1 else 1, generator)
        rates = list(drop_path_rates) if drop_path_rates is not None else [0.0] * depth
        self.blocks = nn.ModuleList(
            ConvNeXtBlock(
                out_chs,
                generator,
                kernel_size=kernel_size,
                mlp_ratio=mlp_ratio,
                dtype=dtype,
                fc2_init=last_fc2_init if i == depth - 1 else None,
                conv_mlp=conv_mlp,
                use_grn=use_grn,
                ls_init_value=ls_init_value,
                drop_path=rates[i],
            )
            for i in range(depth)
        )

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None, keeps=None) -> torch.Tensor:
        """``keeps``: an iterator of ``(B,)`` keep masks, one per block whose
        drop path is active, in block order; else None (masks are drawn from
        ``generator``)."""
        if self.downsample is not None:
            x = apply_downsample(self.downsample, x, self.stride, self.dtype)
        for block in self.blocks:
            keep = next(keeps) if keeps is not None and block.drop_path.active else None
            x = block(x, generator, keep)
        return x


class MultiscaleEncoder(nn.Module):
    """timm ConvNeXt encoder behind an external stem (counterpart of the JAX
    ``MultiscaleEncoder``): the surviving timm stem LayerNorm, then stages
    of ``depths`` blocks at ``dims`` (stride 1, then 2), the blocks'
    stochastic-depth rates rising linearly from 0 to ``drop_path_rate``.
    Returns every stage's channels-last output.

    State-dict names follow the reference's two timm wrappings:
    ``features_only`` (UNeXt2: ``stem_1``, ``stages_{i}``) or the
    classification model (the contrastive encoder: ``stem.1``,
    ``stages.{i}``)."""

    def __init__(
        self,
        depths: Sequence[int],
        dims: Sequence[int],
        generator: torch.Generator,
        use_grn: bool = True,
        ls_init_value: float | None = None,
        drop_path_rate: float = 0.0,
        dtype: torch.dtype = torch.float32,
        features_only: bool = True,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.features_only = features_only
        total = sum(depths)
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        stem_norm = LayerNorm(dims[0])
        stages = []
        start = 0
        for i, (depth, dim) in enumerate(zip(depths, dims)):
            stages.append(
                ConvNeXtStage(
                    dims[max(i - 1, 0)],
                    dim,
                    generator,
                    depth=depth,
                    stride=1 if i == 0 else 2,
                    dtype=dtype,
                    conv_mlp=False,
                    use_grn=use_grn,
                    ls_init_value=ls_init_value,
                    drop_path_rates=rates[start : start + depth],
                )
            )
            start += depth
        if features_only:
            self.stem_1 = stem_norm
            for i, stage in enumerate(stages):
                self.add_module(f"stages_{i}", stage)
        else:
            self.stem = nn.Sequential(nn.Identity(), stem_norm)
            self.stages = nn.ModuleList(stages)
        self.num_stages = len(stages)

    def _parts(self) -> tuple[LayerNorm, list[ConvNeXtStage]]:
        if self.features_only:
            return self.stem_1, [getattr(self, f"stages_{i}") for i in range(self.num_stages)]
        return self.stem[1], list(self.stages)

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None, drop_path_masks=None
    ) -> list[torch.Tensor]:
        """``generator`` draws the active blocks' keep masks in training;
        ``drop_path_masks`` gives them instead, one ``(B,)`` mask per block
        with an active drop path, in block order (the first block's rate is
        0: it takes none)."""
        stem_norm, stages = self._parts()
        x = stem_norm(x, self.dtype)
        keeps = None if drop_path_masks is None else iter(drop_path_masks)
        features = []
        for stage in stages:
            x = stage(x, generator, keeps)
            features.append(x)
        return features


class UNeXt2UpStage(nn.Module):
    """Decoder stage: pixel-shuffle upsample, concat skip, ConvNeXt refine.

    As in the reference (``components/blocks.py:77``), the refining stage is
    built for ``in_channels / scale^2 + in_channels / 2`` input channels
    (upsampled map plus the skip one level up)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        scale_factor: int,
        generator: torch.Generator,
        conv_blocks: int = 2,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.scale_factor = scale_factor
        mid = in_channels // scale_factor**2
        self.conv = ConvNeXtStage(
            mid + in_channels // 2,
            out_channels,
            generator,
            depth=conv_blocks,
            stride=1,
            dtype=dtype,
            last_fc2_init=icnr_init(scale_factor, 2),
        )

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None) -> torch.Tensor:
        x = pixel_shuffle_2d(x, self.scale_factor)
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype)], dim=-1)
        return self.conv(x)


class UNeXt2Decoder(nn.Module):
    """Multi-stage decoder (reference ``components/blocks.py:175``);
    ``num_channels`` runs bottleneck -> output, stage ``i`` upsamples by
    ``strides[i]`` and fuses the next-higher-resolution skip."""

    def __init__(
        self,
        num_channels: Sequence[int],
        strides: Sequence[int],
        generator: torch.Generator,
        conv_blocks: int = 2,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.decoder_stages = nn.ModuleList(
            UNeXt2UpStage(
                num_channels[i],
                num_channels[i + 1],
                strides[i],
                generator,
                conv_blocks=conv_blocks,
                dtype=dtype,
            )
            for i in range(len(num_channels) - 1)
        )

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        feat = features[0]
        skips = list(features[1:]) + [None]
        for stage, skip in zip(self.decoder_stages, skips):
            feat = stage(feat, skip)
        return feat
