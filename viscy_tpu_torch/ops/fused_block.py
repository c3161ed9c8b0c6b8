"""Fused ConvNeXt-v2 MLP + GRN forward (counterpart of
``viscy_tpu/ops/pallas/fused_block.py``).

``fused_mlp_grn`` computes ``shortcut + fc2(GRN(gelu(fc1(LN(x)))))`` on
``(B, S, C)`` activations. On a CUDA tensor it launches the hand-written
Hopper kernel ``csrc/fused_mlp_grn.cu`` (stats pass A, a (B, M) glue step
in plain torch, apply pass B), which never writes an M-wide tensor to
device memory; on a CPU tensor it runs :func:`reference_mlp_grn`, the
plain version the kernel is checked against.

Weights use torch's layout: ``w1`` is fc1's ``(M, C)`` and ``w2`` is
fc2's ``(C, M)`` (``nn.Linear`` weights, or 1x1 conv weights viewed as
2-D). Activations are in the block's compute dtype; parameters stay
float32 and are rounded to the compute dtype exactly where the flax
modules round them.
"""

from __future__ import annotations

import ctypes
import math

import torch

_SQRT2 = math.sqrt(2.0)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL = "fused_mlp_grn"

# kernel launches on CUDA tensors (pass A and pass B count one each)
launches = 0
_lib: ctypes.CDLL | None = None


def _gelu_exact(u: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU in ``u``'s dtype, as the JAX kernel writes it:
    ``u * (erf(u / sqrt2) + 1) / 2`` with sqrt2 rounded to that dtype first
    (JAX's weakly typed constant), erf evaluated in float32."""
    sqrt2 = torch.tensor(_SQRT2, dtype=u.dtype, device=u.device)
    return (u * (torch.erf(u / sqrt2) + 1) / 2).to(u.dtype)


def _grn_coeffs(ss: torch.Tensor, eps_grn: float):
    """``(gx, mean + eps, nx)`` from the (B, M) f32 sum of squares."""
    gx = torch.sqrt(ss)
    mn = gx.mean(dim=-1, keepdim=True) + eps_grn
    return gx, mn, gx / mn


def reference_mlp_grn(
    x: torch.Tensor,
    shortcut: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    grn_gamma: torch.Tensor,
    grn_beta: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    eps_ln: float = 1e-6,
    eps_grn: float = 1e-6,
) -> torch.Tensor:
    """Plain version, op for op the JAX ``reference_mlp_grn`` (flax dtype
    promotion included; masked semantics of MaskedConvNeXtV2Block)."""
    cdt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp_min((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu, 0.0)
    ln = (
        (x32 - mu) * torch.rsqrt(var + eps_ln) * ln_scale.float() + ln_bias.float()
    ).to(cdt)
    u = torch.matmul(ln.float(), w1.to(cdt).float().t()).to(cdt) + b1.to(cdt)
    v = _gelu_exact(u)
    mk = None if mask is None else mask.to(cdt)[..., None]
    vs = v if mk is None else v * mk
    vs32 = vs.float()
    gx = torch.sqrt((vs32 * vs32).sum(dim=1, keepdim=True))
    nx = gx / (gx.mean(dim=-1, keepdim=True) + eps_grn)
    t = v * nx.to(cdt)
    y = (grn_gamma.float() * t.float() + grn_beta.float() + v.float()).to(cdt)
    z = torch.matmul(y.float(), w2.to(cdt).float().t()).to(cdt) + b2.to(cdt)
    if mk is not None:
        z = z * mk
    return shortcut + z


def _check_param(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, activations on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _library() -> ctypes.CDLL:
    """The kernel library with its C signatures declared (built on first use)."""
    global _lib
    if _lib is None:
        from viscy_tpu_torch.ops import _build

        lib = _build.load(_KERNEL)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fmg_stats_tile_rows.argtypes = [i, i, i]
        lib.fmg_stats_tile_rows.restype = i
        lib.fmg_apply_supported.argtypes = [i, i, i]
        lib.fmg_apply_supported.restype = i
        lib.fmg_stats.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, f, p]
        lib.fmg_stats.restype = i
        lib.fmg_apply.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, f, p]
        lib.fmg_apply.restype = i
        _lib = lib
    return _lib


def _fused_cuda(x, shortcut, ln_s, ln_b, w1, b1, gg, gb, w2, b2, mask, eps_ln, eps_grn):
    global launches
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16 activations, got {x.dtype}")
    if shortcut.dtype != x.dtype or shortcut.device != x.device:
        raise ValueError("shortcut must match x in dtype and device")
    if not (x.is_contiguous() and shortcut.is_contiguous()):
        raise ValueError("x and shortcut must be contiguous (B, S, C)")
    bsz, s, c = x.shape
    m = w1.shape[0]
    dev = x.device
    for name, t, shape in (
        ("ln_scale", ln_s, (c,)),
        ("ln_bias", ln_b, (c,)),
        ("w1", w1, (m, c)),
        ("b1", b1, (m,)),
        ("grn_gamma", gg, (m,)),
        ("grn_beta", gb, (m,)),
        ("w2", w2, (c, m)),
        ("b2", b2, (c,)),
    ):
        _check_param(name, t, shape, dev)
    if not 0 < bsz <= 65535:
        raise ValueError(f"batch {bsz} outside the kernel's grid range (1..65535)")
    lib = _library()
    code = _DTYPE_CODE[x.dtype]
    mask_f = None
    if mask is not None:
        # the kernel multiplies in the compute dtype, as the flax block does
        mask_f = mask.to(device=dev, dtype=x.dtype).float().contiguous()
    with torch.cuda.device(dev):
        tile_rows = lib.fmg_stats_tile_rows(code, c, m)
        if tile_rows == 0 or not lib.fmg_apply_supported(code, c, m):
            raise ValueError(f"C={c} ({x.dtype}) does not fit the kernel's shared-memory tiles")
        # weights in the compute dtype, as JAX's _fwd casts them (no copy in f32)
        w1c, w2c = w1.to(x.dtype), w2.to(x.dtype)
        partial = torch.empty((bsz, -(-s // tile_rows), m), dtype=torch.float32, device=dev)
        out = torch.empty_like(x)
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = lib.fmg_stats(
            code, _ptr(x), _ptr(mask_f), _ptr(ln_s), _ptr(ln_b), _ptr(w1c), _ptr(b1),
            _ptr(partial), bsz, s, c, m, eps_ln, stream,
        )
        if rc:
            raise RuntimeError(f"fused_mlp_grn stats pass failed to launch (cudaError {rc})")
        launches += 1
        # fixed-order reduction over tiles: deterministic, no float atomics
        _, _, nx = _grn_coeffs(partial.sum(dim=1), eps_grn)
        rc = lib.fmg_apply(
            code, _ptr(x), _ptr(shortcut), _ptr(mask_f), _ptr(ln_s), _ptr(ln_b), _ptr(w1c),
            _ptr(b1), _ptr(nx), _ptr(gg), _ptr(gb), _ptr(w2c), _ptr(b2), _ptr(out),
            bsz, s, c, m, eps_ln, stream,
        )
        if rc:
            raise RuntimeError(f"fused_mlp_grn apply pass failed to launch (cudaError {rc})")
        launches += 1
    return out


def fused_mlp_grn(
    x: torch.Tensor,
    shortcut: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    grn_gamma: torch.Tensor,
    grn_beta: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    eps_ln: float = 1e-6,
    eps_grn: float = 1e-6,
) -> torch.Tensor:
    """``shortcut + fc2(GRN(gelu(fc1(LN(x)))))`` for ``(B, S, C)`` inputs.

    ``mask`` (0/1, ``(B, S)``) gives the FCMAE masked semantics: GRN
    statistics over mask-zeroed activations and the branch zeroed before
    the residual add. CUDA tensors go through the kernel (any ``S``; the
    ragged last tile is masked in the kernel), CPU tensors through
    :func:`reference_mlp_grn`; any other device raises.
    """
    if x.ndim != 3 or shortcut.shape != x.shape:
        raise ValueError(f"expected (B, S, C) pairs, got {tuple(x.shape)} / {tuple(shortcut.shape)}")
    if mask is not None and tuple(mask.shape) != tuple(x.shape[:2]):
        raise ValueError(f"mask must be (B, S), got {tuple(mask.shape)}")
    args = (x, shortcut, ln_scale, ln_bias, w1, b1, grn_gamma, grn_beta, w2, b2)
    if x.device.type == "cuda":
        return _fused_cuda(*args, mask, eps_ln, eps_grn)
    if x.device.type == "cpu":
        return reference_mlp_grn(*args, mask=mask, eps_ln=eps_ln, eps_grn=eps_grn)
    raise RuntimeError(f"fused_mlp_grn runs on cuda (kernel) or cpu (plain), not {x.device}")
