"""ViT bottleneck of the 3-D U-Nets (counterpart of
``viscy_tpu/models/celldiff/vit_bottleneck.py``; reference
``celldiff/vit_bottleneck.py:26``, ``modules/transformer.py``).

Cubic ``patch_size`` patches of the bottleneck volume are embedded by one
strided conv (``img_embedding.proj``), fixed 3-D sin-cos positions are
added (D gets 1/4 of the width, H and W 3/8 each), diffusers-style
transformer blocks follow (bias-free Q/K/V, GEGLU feed-forward, adaLN-Zero
conditioning on the timestep embedding), then the final layer (non-affine
LayerNorm at eps 1e-6, optional adaLN, ``linear``) and the unpatchify.
No residual around the bottleneck. Attention is a plain ``matmul`` and
``softmax``, as the JAX module writes it. Token vectors are laid out
``(pz, py, px, c)``, the layout of the JAX package's converted kernels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from viscy_tpu_torch.models.components.blocks import Conv, Linear


def get_3d_sincos_pos_embed(embed_dim: int, grid: tuple[int, int, int]) -> np.ndarray:
    """3-D sin-cos positional embedding, ``(D*H*W, embed_dim)`` float32: D
    gets ``embed_dim/4`` channels, H and W ``3*embed_dim/8`` each, each
    axis laid out ``[sin | cos]`` (the JAX package's own copy)."""
    if embed_dim % 16 != 0:
        raise ValueError(f"embed_dim must be divisible by 16, got {embed_dim}")

    def _1d(dim: int, positions: np.ndarray) -> np.ndarray:
        omega = np.arange(dim // 2, dtype=np.float64)
        omega /= dim / 2.0
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", positions.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    d, h, w = grid
    gz, gy, gx = np.meshgrid(
        np.arange(d, dtype=np.float32), np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
        indexing="ij",
    )
    emb = np.concatenate([_1d(embed_dim // 4, gz), _1d(3 * embed_dim // 8, gy), _1d(3 * embed_dim // 8, gx)],
                         axis=1)
    return emb.astype(np.float32)


def _zeros(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return weight.zero_()


def _dense(x: torch.Tensor, lin: Linear) -> torch.Tensor:
    return F.linear(x, lin.weight, lin.bias)


class _Attention(nn.Module):
    """Self-attention: bias-free ``to_q`` / ``to_k`` / ``to_v`` to
    ``heads * dim_head``, scores divided by ``sqrt(dim_head)`` in the input
    dtype, ``to_out.0`` back to ``hidden_size`` (with bias)."""

    def __init__(self, hidden_size: int, num_heads: int, dim_head: int, generator: torch.Generator) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.dim_head = dim_head
        inner = num_heads * dim_head
        self.to_q = Linear(hidden_size, inner, generator, bias=False)
        self.to_k = Linear(hidden_size, inner, generator, bias=False)
        self.to_v = Linear(hidden_size, inner, generator, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, hidden_size, generator)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        split = lambda a: a.reshape(b, t, self.num_heads, self.dim_head).transpose(1, 2)
        q, k, v = split(_dense(x, self.to_q)), split(_dense(x, self.to_k)), split(_dense(x, self.to_v))
        scores = torch.matmul(q, k.transpose(-1, -2)) / torch.sqrt(torch.tensor(self.dim_head, dtype=x.dtype))
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
        return _dense(out.transpose(1, 2).reshape(b, t, -1), self.to_out[0])


class _GEGLU(nn.Module):
    """``proj`` to twice the inner width, ``h * gelu(gate)`` (exact GELU)."""

    def __init__(self, hidden_size: int, inner_dim: int, generator: torch.Generator) -> None:
        super().__init__()
        self.proj = Linear(hidden_size, 2 * inner_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = _dense(x, self.proj).chunk(2, dim=-1)
        return h * F.gelu(gate)


class _FeedForward(nn.Module):
    """diffusers ``FeedForward`` with GEGLU: ``net.0`` (GEGLU), ``net.2``
    (the linear back to ``hidden_size``)."""

    def __init__(self, hidden_size: int, inner_dim: int, generator: torch.Generator) -> None:
        super().__init__()
        # net.1 is the reference's dropout (0 here)
        self.net = nn.ModuleList([_GEGLU(hidden_size, inner_dim, generator), nn.Identity(),
                                  Linear(inner_dim, hidden_size, generator)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _dense(self.net[0](x), self.net[2])


def _layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=eps)


class TransformerBlock(nn.Module):
    """Pre-LN transformer block (non-affine LayerNorms at eps 1e-5); with
    ``conditioned`` the adaLN-Zero form: ``adaLN.1(silu(cond))`` gives the
    shift, scale and gate of the attention and of the feed-forward
    (zero-initialized, so each block starts as the identity)."""

    def __init__(
        self,
        hidden_size: int,
        num_heads: int,
        generator: torch.Generator,
        mlp_ratio: float = 4.0,
        conditioned: bool = True,
        dim_head: int | None = None,
    ) -> None:
        super().__init__()
        self.attn = _Attention(hidden_size, num_heads, dim_head or hidden_size // num_heads, generator)
        self.ff = _FeedForward(hidden_size, int(hidden_size * mlp_ratio), generator)
        self.adaLN = (nn.ModuleList([nn.SiLU(), Linear(hidden_size, 6 * hidden_size, generator, init=_zeros)])
                      if conditioned else None)

    def forward(self, x: torch.Tensor, cond: torch.Tensor | None = None) -> torch.Tensor:
        if self.adaLN is None or cond is None:
            x = x + self.attn(_layer_norm(x, 1e-5))
            return x + self.ff(_layer_norm(x, 1e-5))
        mod = _dense(F.silu(cond), self.adaLN[1])[:, None]
        shift_a, scale_a, gate_a, shift_m, scale_m, gate_m = mod.chunk(6, dim=-1)
        x = x + gate_a * self.attn(_layer_norm(x, 1e-5) * (1 + scale_a) + shift_a)
        return x + gate_m * self.ff(_layer_norm(x, 1e-5) * (1 + scale_m) + shift_m)


class _PatchEmbed(nn.Module):
    """``proj``: the Conv3d of kernel = stride = ``patch_size``."""

    def __init__(self, in_channels: int, hidden_size: int, patch_size: int, generator: torch.Generator) -> None:
        super().__init__()
        self.proj = Conv(in_channels, hidden_size, (patch_size,) * 3, generator)


class _FinalLayer(nn.Module):
    """LayerNorm at eps 1e-6 without affine, the optional ``adaLN`` shift
    and scale (zero-initialized), then ``linear`` to ``p^3 * C``."""

    def __init__(self, hidden_size: int, out_dim: int, conditioned: bool, generator: torch.Generator) -> None:
        super().__init__()
        self.linear = Linear(hidden_size, out_dim, generator)
        self.adaLN = (nn.ModuleList([nn.SiLU(), Linear(hidden_size, 2 * hidden_size, generator, init=_zeros)])
                      if conditioned else None)

    def forward(self, x: torch.Tensor, cond: torch.Tensor | None) -> torch.Tensor:
        x = _layer_norm(x, 1e-6)
        if self.adaLN is not None and cond is not None:
            shift, scale = _dense(F.silu(cond), self.adaLN[1])[:, None].chunk(2, dim=-1)
            x = x * (1 + scale) + shift
        return _dense(x, self.linear)


class ViTBottleneck3D(nn.Module):
    """Transformer bottleneck over NCDHW volumes whose D, H and W are
    multiples of ``patch_size``. ``dropout`` and ``final_dropout`` must be 0:
    the shipped configs use none, and dropout is not ported."""

    def __init__(
        self,
        in_channels: int,
        generator: torch.Generator,
        hidden_size: int = 512,
        num_heads: int = 8,
        num_hidden_layers: int = 2,
        patch_size: int = 4,
        mlp_ratio: float = 4.0,
        conditioned: bool = True,
        dim_head: int | None = 64,
        dropout: float = 0.0,
        final_dropout: float = 0.0,
    ) -> None:
        super().__init__()
        if dropout or final_dropout:
            raise NotImplementedError("dropout in the ViT bottleneck is not ported (dropout=0, final_dropout=0)")
        self.patch_size = patch_size
        self.hidden_size = hidden_size
        self.img_embedding = _PatchEmbed(in_channels, hidden_size, patch_size, generator)
        self.blocks = nn.ModuleList(
            TransformerBlock(hidden_size, num_heads, generator, mlp_ratio, conditioned, dim_head)
            for _ in range(num_hidden_layers))
        self.proj_out = _FinalLayer(hidden_size, patch_size**3 * in_channels, conditioned, generator)
        self._pos: dict[tuple, torch.Tensor] = {}

    def _pos_embed(self, grid: tuple[int, int, int], device: torch.device) -> torch.Tensor:
        key = (*grid, str(device))
        if key not in self._pos:
            self._pos[key] = torch.from_numpy(get_3d_sincos_pos_embed(self.hidden_size, grid)).to(device)
        return self._pos[key]

    def forward(self, x: torch.Tensor, time_embeds: torch.Tensor | None = None) -> torch.Tensor:
        b, c, d, h, w = x.shape
        p = self.patch_size
        for name, size in zip(("D", "H", "W"), (d, h, w)):
            if size % p != 0:
                raise ValueError(f"Latent {name} dimension {size} is not divisible by patch_size={p}")
        grid = (d // p, h // p, w // p)
        proj = self.img_embedding.proj
        tokens = F.conv3d(x, proj.weight, proj.bias, stride=p).flatten(2).transpose(1, 2)
        tokens = tokens + self._pos_embed(grid, x.device)[None]
        for blk in self.blocks:
            tokens = blk(tokens, time_embeds)
        out = self.proj_out(tokens, time_embeds)
        # unpatchify: token vector (pz, py, px, c) -> (c, dz pz, hy py, wx px)
        out = out.reshape(b, *grid, p, p, p, c).permute(0, 7, 1, 4, 2, 5, 3, 6)
        return out.reshape(b, c, d, h, w)
