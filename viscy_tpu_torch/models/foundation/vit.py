"""DINOv2-style Vision Transformer (counterpart of
``viscy_tpu/models/foundation/vit.py``; reference vendored
``foundation/_dinov2_vit.py``).

Patch embedding, a CLS token and learned positions (resized off the native
grid as ``jax.image.resize(..., "linear")`` resizes them: antialiased when
they shrink), pre-LN blocks with LayerScale, a final LayerNorm. Parameter
names are those of Hugging Face's ``Dinov2Model``
(``embeddings.patch_embeddings.projection``,
``encoder.layer.{i}.attention.attention.query``, ``layer_scale1.lambda1``,
``layernorm``, ...), so a converted HF state dict loads with
``load_state_dict`` (:mod:`viscy_tpu_torch.models.foundation.convert`).

Inputs are channels-first ``(B, 3, H, W)`` (the JAX module takes ``(B, H,
W, 3)``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from viscy_tpu_torch.transforms.zoom import resize_matrix

__all__ = ["DinoViT", "ViTBlock", "resize_linear"]


def resize_linear(x: torch.Tensor, sizes: dict[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, ..., "linear")`` (antialiased) over the axes of
    ``sizes`` (axis -> new length); axes whose length is unchanged are left
    as they are, as JAX leaves them."""
    y = x
    for dim, n_out in sizes.items():
        n_in = y.shape[dim]
        if n_in == n_out:
            continue
        w = resize_matrix(n_in, n_out, "linear", True, y.device)
        y = torch.movedim(torch.tensordot(y, w.to(y.dtype), dims=([dim], [0])), -1, dim)
    return y


def _trunc_normal(shape, std: float, g: torch.Generator) -> torch.Tensor:
    return torch.nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2 * std, b=2 * std, generator=g)


def _linear(n_in: int, n_out: int, g: torch.Generator) -> nn.Linear:
    """A Linear with flax's default init: LeCun normal weights, zero bias."""
    lin = nn.Linear(n_in, n_out)
    with torch.no_grad():
        lin.weight.copy_(_trunc_normal((n_out, n_in), 1.0 / math.sqrt(n_in) / 0.87962566103423978, g))
        lin.bias.zero_()
    return lin


class _Namespace(nn.Module):
    """A bare container, so parameter paths read as HF names them."""

    def __init__(self, **children: nn.Module) -> None:
        super().__init__()
        for name, child in children.items():
            self.add_module(name, child)


class _LayerScale(nn.Module):
    def __init__(self, dim: int, init: float) -> None:
        super().__init__()
        self.lambda1 = nn.Parameter(torch.full((dim,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.lambda1


class ViTBlock(nn.Module):
    """Pre-LN block (eps 1e-6): multi-head self-attention with biased q, k,
    v and output projections (the query scaled by ``1 / sqrt(head_dim)``,
    softmax in float32), LayerScale, then an MLP with the exact erf GELU
    and LayerScale."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, ls_init: float = 1e-5,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        if dim % num_heads:
            raise ValueError(f"embed_dim {dim} is not a multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attention = _Namespace(
            attention=_Namespace(query=_linear(dim, dim, g), key=_linear(dim, dim, g), value=_linear(dim, dim, g)),
            output=_Namespace(dense=_linear(dim, dim, g)),
        )
        self.layer_scale1 = _LayerScale(dim, ls_init)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Namespace(fc1=_linear(dim, hidden, g), fc2=_linear(hidden, dim, g))
        self.layer_scale2 = _LayerScale(dim, ls_init)

    def _attend(self, h: torch.Tensor) -> torch.Tensor:
        b, n, e = h.shape
        a = self.attention.attention
        heads = lambda lin: lin(h).reshape(b, n, self.num_heads, e // self.num_heads).transpose(1, 2)
        q, k, v = heads(a.query), heads(a.key), heads(a.value)
        q = q / math.sqrt(e // self.num_heads)
        weights = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1).to(v.dtype)
        out = (weights @ v).transpose(1, 2).reshape(b, n, e)
        return self.attention.output.dense(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.layer_scale1(self._attend(self.norm1(x)))
        h = self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x)), approximate="none"))
        return x + self.layer_scale2(h)


class DinoViT(nn.Module):
    """ViT-S/B style encoder: ``forward(x)`` with ``x`` ``(B, 3, H, W)``
    returns ``{"cls": (B, E), "patch_mean": (B, E), "tokens": (B, 1 + N,
    E)}``, after the final LayerNorm."""

    def __init__(self, img_size: int = 224, patch_size: int = 14, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, mlp_ratio: float = 4.0, generator: torch.Generator | None = None) -> None:
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.img_size, self.patch_size, self.embed_dim = img_size, patch_size, embed_dim
        self.depth, self.num_heads = depth, num_heads
        proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        with torch.no_grad():
            fan_in = 3 * patch_size * patch_size
            proj.weight.copy_(_trunc_normal(proj.weight.shape, 1.0 / math.sqrt(fan_in) / 0.87962566103423978, g))
            proj.bias.zero_()
        n_base = (img_size // patch_size) ** 2
        self.embeddings = _Namespace(patch_embeddings=_Namespace(projection=proj))
        self.embeddings.cls_token = nn.Parameter(_trunc_normal((1, 1, embed_dim), 0.02, g))
        self.embeddings.position_embeddings = nn.Parameter(_trunc_normal((1, n_base + 1, embed_dim), 0.02, g))
        self.encoder = _Namespace(layer=nn.ModuleList(ViTBlock(embed_dim, num_heads, mlp_ratio, generator=g)
                                                      for _ in range(depth)))
        self.layernorm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        b = x.shape[0]
        e = self.embed_dim
        feat = self.embeddings.patch_embeddings.projection(x)
        gh, gw = feat.shape[2:]
        tokens = feat.flatten(2).transpose(1, 2)
        pos = self.embeddings.position_embeddings
        patch_pos = pos[:, 1:]
        side = self.img_size // self.patch_size
        if gh * gw != side * side:
            grid = patch_pos.reshape(side, side, e)
            patch_pos = resize_linear(grid, {0: gh, 1: gw}).reshape(1, gh * gw, e)
        tokens = tokens + patch_pos
        cls = (self.embeddings.cls_token + pos[:, :1]).expand(b, 1, e)
        tokens = torch.cat([cls, tokens], dim=1)
        for block in self.encoder.layer:
            tokens = block(tokens)
        tokens = self.layernorm(tokens)
        return {"cls": tokens[:, 0], "patch_mean": tokens[:, 1:].mean(dim=1), "tokens": tokens}
