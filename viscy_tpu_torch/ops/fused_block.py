"""Fused ConvNeXt-v2 MLP + GRN, forward and backward (counterpart of
``viscy_tpu/ops/pallas/fused_block.py``).

``fused_mlp_grn`` computes ``shortcut + fc2(GRN(gelu(fc1(LN(x)))))`` on
``(B, S, C)`` activations through :class:`FusedMlpGrn`, an autograd
Function. On CUDA tensors both directions launch the hand-written Hopper
kernels of ``csrc/fused_mlp_grn.cu``:

- forward: a LayerNorm prep, pass A (fc1 and GELU, with the GRN
  statistics' per-row-tile partials), the (B, M) GRN glue in plain torch,
  pass B (GRN, fc2, mask and residual), as tiled tensor-core products over
  an M-wide (M = 4C) scratch that lives for the call (see
  :func:`_fused_cuda`); the (B, M) sum of squares ``ss`` is saved for the
  backward, as the JAX ``_fwd`` saves it;
- backward: pass C (GRN statistics cotangent ``P``, ``d grn_beta``,
  ``d fc2``), the (B, M) GRN glue in plain torch, pass D (``d fc1``, the
  LayerNorm parameter gradients and ``dx``), as tiled tensor-core products
  over an M-wide scratch that lives for the call (see
  :func:`_fused_bwd_cuda`).

On CPU tensors the Function runs the plain versions
:func:`reference_mlp_grn` and :func:`reference_mlp_grn_bwd`, the functions
the kernels are checked against. Any other device raises.

Weights use torch's layout: ``w1`` is fc1's ``(M, C)`` and ``w2`` is
fc2's ``(C, M)`` (``nn.Linear`` weights, or 1x1 conv weights viewed as
2-D), and their gradients come back in the same layout. Activations are
in the block's compute dtype; parameters stay float32 and are rounded to
the compute dtype exactly where the flax modules round them.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

_SQRT2 = math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL = "fused_mlp_grn"
# the forward kernels' tiling (checked against the library when it loads):
# rows and hidden columns of a pass-A tile, rows of a pass-B tile and the
# output columns it may take
FWD_ROW_TILE = 128
FWD_HIDDEN_TILE = 128
FWD_APPLY_ROWS = 64
FWD_APPLY_COLS = (128, 256)
# the grids' row-tile limit (blockIdx.y) of passes A and B, of the front
# products and of the dln product
MAX_ROW_TILES = 65535
# the backward kernels' tiling (checked against the library when it loads):
# rows of a front-product tile, rows and columns of a weight-gradient
# product's tile, the K step, rows per block of the row kernels; and the
# fewest rows a split of a weight-gradient product gets
BWD_ROW_TILE = 64
BWD_TILE = 128
BWD_K_STEP = 64
BWD_LN_ROWS = 64  # also the forward prep's
BWD_MIN_SPLIT_ROWS = 256

# kernel launches on CUDA tensors, counted per pass: forward passes A and B
# one each in ``launches`` (the LayerNorm prep kernel is counted with pass A),
# backward passes C and D one each in ``bwd_launches`` (each pass runs several
# kernels and counts once, at its last); the launches of masked calls are
# also counted in ``masked_launches`` / ``masked_bwd_launches``
launches = 0
bwd_launches = 0
masked_launches = 0
masked_bwd_launches = 0
_lib: ctypes.CDLL | None = None


def _gelu_exact(u: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU in ``u``'s dtype, as the JAX kernel writes it:
    ``u * (erf(u / sqrt2) + 1) / 2`` with sqrt2 rounded to that dtype first
    (JAX's weakly typed constant), erf evaluated in float32."""
    sqrt2 = torch.tensor(_SQRT2, dtype=u.dtype, device=u.device)
    return (u * (torch.erf(u / sqrt2) + 1) / 2).to(u.dtype)


def _gelu_grad_f32(u32: torch.Tensor) -> torch.Tensor:
    """d gelu / du in float32 (JAX ``_gelu_grad_f32``)."""
    phi = torch.exp(-0.5 * u32 * u32) * _INV_SQRT_2PI
    cdf = 0.5 * (torch.erf(u32 / _SQRT2) + 1.0)
    return cdf + u32 * phi


def _grn_coeffs(ss: torch.Tensor, eps_grn: float):
    """``(gx, mean + eps, nx)`` from the (B, M) f32 sum of squares."""
    gx = torch.sqrt(ss)
    mn = gx.mean(dim=-1, keepdim=True) + eps_grn
    return gx, mn, gx / mn


def _grn_bwd_coeffs(p: torch.Tensor, ss: torch.Tensor, grn_gamma: torch.Tensor, eps_grn: float):
    """The (B, M) glue between passes C and D (JAX ``_bwd``): from
    ``P[b, m] = sum_s dy * v`` the GRN cotangents ``coef1`` (on dy),
    ``coef2`` (on the statistics path) and ``d grn_gamma``."""
    gx, mn, nx = _grn_coeffs(ss, eps_grn)
    gg32 = grn_gamma.float()
    a_nx = gg32 * p
    dgg = (p * nx).sum(dim=0)
    m = ss.shape[-1]
    # nx = gx / mean(gx + eps): dgx = A/m - sum_k(A_k gx_k)/(M m^2)
    dgx = a_nx / mn - (a_nx * gx).sum(dim=-1, keepdim=True) / (m * mn * mn)
    # through gx = sqrt(sum v^2): dv += v * dgx / gx (0 where gx == 0)
    coef2 = torch.where(gx > 0, dgx / torch.clamp_min(gx, 1e-30), torch.zeros_like(gx))
    coef1 = gg32 * nx + 1.0
    return coef1, coef2, dgg


def _ln_fc1_gelu(x, ln_scale, ln_bias, w1, b1, eps_ln):
    """LN -> fc1 -> GELU over the last axis: ``(v, u, ln, xhat, rstd)``
    with v, u, ln in the compute dtype and xhat, rstd float32."""
    cdt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp_min((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu, 0.0)
    rstd = torch.rsqrt(var + eps_ln)
    xc = x32 - mu
    # flax _normalize combines rsqrt * scale before multiplying
    ln = (xc * (rstd * ln_scale.float()) + ln_bias.float()).to(cdt)
    u = torch.matmul(ln.float(), w1.to(cdt).float().t()).to(cdt) + b1.to(cdt)
    return _gelu_exact(u), u, ln, xc * rstd, rstd


def _reference_ss(x, ln_scale, ln_bias, w1, b1, mask, eps_ln) -> torch.Tensor:
    """(B, M) float32 sum over S of the (masked) GELU output squared."""
    v = _ln_fc1_gelu(x, ln_scale, ln_bias, w1, b1, eps_ln)[0]
    vs = v if mask is None else v * mask.to(x.dtype)[..., None]
    vs32 = vs.float()
    return (vs32 * vs32).sum(dim=1)


def _reference_apply(x, shortcut, ln_scale, ln_bias, w1, b1, grn_gamma, grn_beta, w2, b2,
                     ss, mask, eps_ln, eps_grn) -> torch.Tensor:
    cdt = x.dtype
    v = _ln_fc1_gelu(x, ln_scale, ln_bias, w1, b1, eps_ln)[0]
    nx = _grn_coeffs(ss, eps_grn)[2][:, None, :]
    t = v * nx.to(cdt)
    y = (grn_gamma.float() * t.float() + grn_beta.float() + v.float()).to(cdt)
    z = torch.matmul(y.float(), w2.to(cdt).float().t()).to(cdt) + b2.to(cdt)
    if mask is not None:
        z = z * mask.to(cdt)[..., None]
    return shortcut + z


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
    ss = _reference_ss(x, ln_scale, ln_bias, w1, b1, mask, eps_ln)
    return _reference_apply(x, shortcut, ln_scale, ln_bias, w1, b1, grn_gamma, grn_beta, w2, b2,
                            ss, mask, eps_ln, eps_grn)


def reference_mlp_grn_bwd(
    x: torch.Tensor,
    g: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    grn_gamma: torch.Tensor,
    grn_beta: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    ss: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    eps_ln: float = 1e-6,
    eps_grn: float = 1e-6,
) -> tuple[torch.Tensor, ...]:
    """Plain backward, op for op the JAX ``_bwd`` (passes C and D with the
    (B, M) glue between them): from the output cotangent ``g`` and the
    forward's sum of squares ``ss``, return ``(dx, dshortcut, dln_scale,
    dln_bias, dw1, db1, dgrn_gamma, dgrn_beta, dw2, db2)``.

    Rounding sites: dz = g in the compute dtype (times the mask), y rounded
    before d fc2, du rounded before d fc1 and dln, every parameter gradient
    accumulated in float32, dx in the compute dtype, dshortcut = g."""
    cdt = x.dtype
    c, m = x.shape[-1], w1.shape[0]
    nx = _grn_coeffs(ss, eps_grn)[2][:, None, :]
    v, u, ln, xhat, rstd = _ln_fc1_gelu(x, ln_scale, ln_bias, w1, b1, eps_ln)
    dz = g.to(cdt)
    mk = None if mask is None else mask.to(cdt)[..., None]
    if mk is not None:
        dz = dz * mk
    # pass C
    dy = torch.matmul(dz.float(), w2.to(cdt).float())
    v32 = v.float()
    y = (grn_gamma.float() * (v * nx.to(cdt)).float() + grn_beta.float() + v32).to(cdt)
    p = (dy * v32).sum(dim=1)
    dbg = dy.sum(dim=(0, 1))
    dw2 = torch.matmul(dz.float().reshape(-1, c).t(), y.float().reshape(-1, m))
    db2 = dz.float().sum(dim=(0, 1))
    # glue
    coef1, coef2, dgg = _grn_bwd_coeffs(p, ss, grn_gamma, eps_grn)
    # pass D: the statistics path saw v * mask, so its cotangent carries mask^2
    stats_v = v32 if mk is None else v32 * (mk.float() * mk.float())
    dv32 = dy * coef1[:, None, :] + stats_v * coef2[:, None, :]
    du32 = dv32 * _gelu_grad_f32(u.float())
    du = du32.to(cdt)
    dw1 = torch.matmul(du.float().reshape(-1, m).t(), ln.float().reshape(-1, c))
    db1 = du32.sum(dim=(0, 1))
    dln = torch.matmul(du.float(), w1.to(cdt).float())
    dls = (dln * xhat).sum(dim=(0, 1))
    dlb = dln.sum(dim=(0, 1))
    dxhat = dln * ln_scale.float()
    mean_d = dxhat.mean(dim=-1, keepdim=True)
    mean_dx = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (dxhat - mean_d - xhat * mean_dx)).to(cdt)
    return dx, g.to(cdt), dls, dlb, dw1, db1, dgg, dbg, dw2, db2


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
        ll = ctypes.c_longlong
        lib.fmg_fwd_geometry.argtypes = [p]
        lib.fmg_fwd_geometry.restype = None
        lib.fmg_fwd_prep.argtypes = [i, p, p, p, p, ll, i, f, p]
        lib.fmg_fwd_prep.restype = i
        lib.fmg_fwd_stats.argtypes = [i, *[p] * 6, i, i, i, i, p]
        lib.fmg_fwd_stats.restype = i
        lib.fmg_fwd_apply.argtypes = [i, i, *[p] * 9, i, i, i, i, p]
        lib.fmg_fwd_apply.restype = i
        lib.fmg_bwd_geometry.argtypes = [p]
        lib.fmg_bwd_geometry.restype = None
        lib.fmg_bwd_prep.argtypes = [i, *[p] * 10, ll, i, f, p]
        lib.fmg_bwd_prep.restype = i
        lib.fmg_bwd_front.argtypes = [i, i, *[p] * 14, i, i, i, i, p]
        lib.fmg_bwd_front.restype = i
        lib.fmg_bwd_gemm.argtypes = [i, i, p, ll, p, ll, p, i, i, i, i, i, p]
        lib.fmg_bwd_gemm.restype = i
        lib.fmg_bwd_lnb.argtypes = [i, *[p] * 8, ll, i, p]
        lib.fmg_bwd_lnb.restype = i
        for geometry, want in (
            (lib.fmg_fwd_geometry, (FWD_ROW_TILE, FWD_HIDDEN_TILE, FWD_APPLY_ROWS, BWD_LN_ROWS)),
            (lib.fmg_bwd_geometry, (BWD_ROW_TILE, BWD_TILE, BWD_K_STEP, BWD_LN_ROWS)),
        ):
            geo = (ctypes.c_int * 4)()
            geometry(geo)
            if tuple(geo) != want:
                raise RuntimeError(f"kernel library tiles {tuple(geo)} differ from the wrapper's plan")
        _lib = lib
    return _lib


def _check_cuda_args(x, other, params, mask):
    """Validate kernel inputs; returns the float mask in the compute dtype's
    values (or None)."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16 activations, got {x.dtype}")
    if other.dtype != x.dtype or other.device != x.device:
        raise ValueError("shortcut / cotangent must match x in dtype and device")
    if not (x.is_contiguous() and other.is_contiguous()):
        raise ValueError("activations must be contiguous (B, S, C)")
    bsz, _, c = x.shape
    ln_s, ln_b, w1, b1, gg, gb, w2, b2 = params
    m = w1.shape[0]
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
        _check_param(name, t, shape, x.device)
    if not 0 < bsz <= 65535:
        raise ValueError(f"batch {bsz} outside the kernel's grid range (1..65535)")
    if mask is None:
        return None
    # the kernels multiply in the compute dtype, as the flax block does
    return mask.to(device=x.device, dtype=x.dtype).float().contiguous()


@dataclass(frozen=True)
class FwdPlan:
    """Grid sizes and scratch shapes of the forward kernels for one call.

    Prep: ``ln_blocks`` blocks of ``BWD_LN_ROWS`` rows write the LayerNorm
    output (``ln_shape``). Pass A: ``row_tiles`` tiles of ``FWD_ROW_TILE``
    rows (``tiles_per_sample`` per sample, none straddling two samples) by
    ``hidden_tiles`` tiles of ``FWD_HIDDEN_TILE`` hidden columns; row tile
    ``y`` writes its rows of the GELU output (``v_shape``) and row ``y`` of
    the ``(row_tiles, M)`` column partials of ``(v * mask)^2``. Pass B:
    ``apply_row_tiles`` tiles of ``FWD_APPLY_ROWS`` rows over all B S rows
    (a tile may straddle samples) by ``apply_col_tiles`` tiles of
    ``apply_cols`` output columns."""

    tiles_per_sample: int
    row_tiles: int
    hidden_tiles: int
    apply_row_tiles: int
    apply_cols: int
    apply_col_tiles: int
    ln_blocks: int
    ln_shape: tuple[int, int]
    v_shape: tuple[int, int]

    def sample_sums(self, part: torch.Tensor) -> torch.Tensor:
        """(B, M) per-sample sums of pass A's (row_tiles, M) partials, each
        over its sample's tiles in tile order: a fixed order."""
        return part.view(-1, self.tiles_per_sample, part.shape[-1]).sum(dim=1)


def _apply_cols(rows: int, c: int, n_sm: int) -> int:
    """Pass B's tile width: of ``FWD_APPLY_COLS``, the one whose grid takes
    the least time counted as waves of two blocks per SM, each block's work
    its output columns plus the v tile it loads and turns into y (as many
    again as its rows); the wider on a tie, which forms each y tile fewer
    times. On an H100, 128-column tiles alone made pass B 46 % slower at
    (B, S, C, M) = (49, 6400, 480, 1920), where this picks 256."""

    def cost(bn: int) -> int:
        blocks = -(-rows // FWD_APPLY_ROWS) * -(-c // bn)
        return -(-blocks // (2 * n_sm)) * (bn + FWD_APPLY_ROWS)

    return min(sorted(FWD_APPLY_COLS, reverse=True), key=cost)


def fwd_plan(bsz: int, s: int, c: int, m: int, n_sm: int) -> FwdPlan:
    """The forward's plan at (B, S, C, M) on a card with ``n_sm`` SMs."""
    n = bsz * s
    tps = -(-s // FWD_ROW_TILE)
    cols = _apply_cols(n, c, n_sm)
    return FwdPlan(
        tiles_per_sample=tps,
        row_tiles=bsz * tps,
        hidden_tiles=-(-m // FWD_HIDDEN_TILE),
        apply_row_tiles=-(-n // FWD_APPLY_ROWS),
        apply_cols=cols,
        apply_col_tiles=-(-c // cols),
        ln_blocks=-(-n // BWD_LN_ROWS),
        ln_shape=(n, c),
        v_shape=(n, m),
    )


def samples_per_launch(s: int, m: int) -> int:
    """The most samples one launch of the forward and backward kernels takes
    at (S, M): every grid's row tiles within ``MAX_ROW_TILES`` and B M below
    2^31. A larger batch is split into launches of at most this many
    samples, which is exact: the GRN statistics are per sample (a whole
    1024^2 frame at batch 32 under a (1, 2, 2) stem takes three)."""
    per = min(
        MAX_ROW_TILES // -(-s // FWD_ROW_TILE),  # pass A
        MAX_ROW_TILES * FWD_APPLY_ROWS // s,  # pass B
        MAX_ROW_TILES // -(-s // BWD_ROW_TILE),  # the front products
        MAX_ROW_TILES * BWD_TILE // s,  # dln
        (2**31 - 1) // m,
    )
    if per < 1:
        raise ValueError(f"(S, M) = {(s, m)} exceeds the kernels' grid for even one sample")
    return per


def _fused_cuda(x, shortcut, params, mask_f, eps_ln, eps_grn, mark=None):
    """Prep, pass A, the (B, M) glue and pass B; returns ``(out, ss)``; a
    batch above :func:`samples_per_launch` runs as several such launches.

    Prep writes the LayerNorm output; pass A writes the GELU output v to an
    M-wide scratch that lives for the call and the per-row-tile partials of
    ``(v * mask)^2`` (:func:`fwd_plan`), which the glue sums per sample in
    a fixed order (no float atomics: two runs give bit-identical outputs)
    before forming ``nx``; pass B forms ``y = GRN(v)`` on each v tile it
    loads, multiplies by fc2 and writes ``out`` once. ``mark(stage)``, if
    given, is called after each stage is enqueued (for timing).
    """
    global launches, masked_launches
    ln_s, ln_b, w1, b1, gg, gb, w2, b2 = params
    bsz, s, c = x.shape
    m = w1.shape[0]
    per = samples_per_launch(s, m)
    if bsz > per:
        parts = [_fused_cuda(x[i:i + per], shortcut[i:i + per], params,
                             None if mask_f is None else mask_f[i:i + per], eps_ln, eps_grn, mark)
                 for i in range(0, bsz, per)]
        return torch.cat([o for o, _ in parts]), torch.cat([q for _, q in parts])
    dev = x.device
    lib = _library()
    code = _DTYPE_CODE[x.dtype]
    mark = mark or (lambda stage: None)

    def check(rc, what):
        if rc:
            raise RuntimeError(f"fused_mlp_grn {what} failed to launch (cudaError {rc})")

    with torch.cuda.device(dev):
        plan = fwd_plan(bsz, s, c, m, torch.cuda.get_device_properties(dev).multi_processor_count)
        # weights in the compute dtype, as JAX's _fwd casts them (no copy in f32)
        w1c, w2c = w1.to(x.dtype), w2.to(x.dtype)
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        ln = torch.empty(plan.ln_shape, dtype=x.dtype, device=dev)
        check(lib.fmg_fwd_prep(code, _ptr(x), _ptr(ln_s), _ptr(ln_b), _ptr(ln), bsz * s, c, eps_ln,
                               stream), "prep")
        mark("prep")
        v = torch.empty(plan.v_shape, dtype=x.dtype, device=dev)
        part = torch.empty((plan.row_tiles, m), dtype=torch.float32, device=dev)
        check(lib.fmg_fwd_stats(code, _ptr(ln), _ptr(w1c), _ptr(mask_f), _ptr(b1), _ptr(v),
                                _ptr(part), bsz, s, c, m, stream), "pass A")
        launches += 1
        masked_launches += mask_f is not None
        mark("pass A")
        del ln
        ss = plan.sample_sums(part)
        nx = _grn_coeffs(ss, eps_grn)[2].contiguous()
        mark("glue")
        out = torch.empty_like(x)
        check(lib.fmg_fwd_apply(code, plan.apply_cols, _ptr(v), _ptr(w2c), _ptr(shortcut),
                                _ptr(mask_f), _ptr(nx), _ptr(gg), _ptr(gb), _ptr(b2), _ptr(out),
                                bsz, s, c, m, stream), "pass B")
        launches += 1
        masked_launches += mask_f is not None
        mark("pass B")
    return out, ss


@torch.library.custom_op(
    "viscy_tpu_torch::fused_mlp_grn_fwd",
    mutates_args=(),
    device_types="cuda",
    schema="(Tensor x, Tensor shortcut, Tensor? mask_f, Tensor ln_s, Tensor ln_b, Tensor w1, Tensor b1, "
    "Tensor gg, Tensor gb, Tensor w2, Tensor b2, float eps_ln, float eps_grn) -> (Tensor, Tensor)",
)
def fused_fwd_op(x, shortcut, mask_f, ln_s, ln_b, w1, b1, gg, gb, w2, b2, eps_ln, eps_grn):
    """:func:`_fused_cuda` as an operator: ``torch.export`` records it as one
    node (its fake gives the shapes), and a loaded program runs the kernels
    through it wherever this module is imported. CUDA tensors only."""
    return _fused_cuda(x, shortcut, (ln_s, ln_b, w1, b1, gg, gb, w2, b2), mask_f, eps_ln, eps_grn)


@fused_fwd_op.register_fake
def _fused_fwd_fake(x, shortcut, mask_f, ln_s, ln_b, w1, b1, gg, gb, w2, b2, eps_ln, eps_grn):
    return torch.empty_like(x), x.new_empty((x.shape[0], w1.shape[0]), dtype=torch.float32)


@dataclass(frozen=True)
class BwdPlan:
    """Grid sizes and scratch shapes of the backward kernels for one call.

    ``row_tiles`` front-product row tiles (``tiles_per_sample`` per sample,
    none straddling two samples) each own one slot of the (row_tiles, M)
    column partials; the weight-gradient products split their K = B S rows
    into ``splits`` ranges of ``k_per_split`` (a multiple of the K step),
    each owning one (I, J) partial; ``ln_blocks`` blocks of ``BWD_LN_ROWS``
    rows each own one C-wide partial of the row kernels. Every partial is
    summed in torch over its leading axis, a fixed order."""

    tiles_per_sample: int
    row_tiles: int
    splits: int
    k_per_split: int
    ln_blocks: int


def _split_k(k: int, tiles: int, n_sm: int) -> tuple[int, int]:
    """``(splits, rows per split)`` for a product of ``tiles`` output tiles
    over ``k`` rows: at least two blocks per SM where the rows allow, the
    count of splits (up to four times that) that fills its last wave best,
    whole K steps and at least ``BWD_MIN_SPLIT_ROWS`` rows per split."""

    def split(n: int) -> tuple[int, int]:
        per = -(-(-(-k // n)) // BWD_K_STEP) * BWD_K_STEP
        return -(-k // per), per

    def fill(n: int) -> float:
        return tiles * n / (-(-tiles * n // n_sm) * n_sm)

    most = max(1, min(-(-8 * n_sm // tiles), k // BWD_MIN_SPLIT_ROWS))
    least = min(most, max(1, -(-2 * n_sm // tiles)))
    return max((split(n) for n in range(least, most + 1)), key=lambda sp: (fill(sp[0]), -sp[0]))


def bwd_plan(bsz: int, s: int, c: int, m: int, n_sm: int) -> BwdPlan:
    """The backward's plan at (B, S, C, M) on a card with ``n_sm`` SMs."""
    tps = -(-s // BWD_ROW_TILE)
    tiles = -(-c // BWD_TILE) * -(-m // BWD_TILE)  # d fc2 (C, M) and d fc1 (M, C) alike
    splits, per = _split_k(bsz * s, tiles, n_sm)
    return BwdPlan(tps, bsz * tps, splits, per, -(-(bsz * s) // BWD_LN_ROWS))


def _fused_bwd_cuda(x, g, params, mask_f, ss, eps_ln, eps_grn, mark=None):
    """Passes C and D with the (B, M) glue between them; returns the ten
    gradients of :func:`reference_mlp_grn_bwd`.

    Pass C: prep (LayerNorm output, dz, row statistics, d fc2 bias
    partials), front C (y to an M-wide scratch, P and d grn_beta partials),
    d fc2. Pass D: front D (du to an M-wide scratch, d fc1 bias partials),
    d fc1, dln, the LayerNorm backward. Every cross-block sum goes through
    per-block partials (:func:`bwd_plan`) summed in a fixed order: no float
    atomics, so two runs give bit-identical gradients. ``mark(stage)``, if
    given, is called after each stage is enqueued (for timing). A batch
    above :func:`samples_per_launch` runs as several such launches, whose
    parameter gradients are summed in launch order.
    """
    global bwd_launches, masked_bwd_launches
    ln_s, ln_b, w1, b1, gg, gb, w2, b2 = params
    bsz, s, c = x.shape
    m = w1.shape[0]
    per = samples_per_launch(s, m)
    if bsz > per:
        parts = [_fused_bwd_cuda(x[i:i + per], g[i:i + per], params,
                                 None if mask_f is None else mask_f[i:i + per], ss[i:i + per],
                                 eps_ln, eps_grn, mark)
                 for i in range(0, bsz, per)]
        grads = list(parts[0])
        for part in parts[1:]:
            grads[2:] = [a + b for a, b in zip(grads[2:], part[2:])]
        return (torch.cat([p[0] for p in parts]), g, *grads[2:])
    n = bsz * s
    dev = x.device
    lib = _library()
    code = _DTYPE_CODE[x.dtype]
    f32 = dict(dtype=torch.float32, device=dev)
    mark = mark or (lambda stage: None)

    def check(rc, what):
        if rc:
            raise RuntimeError(f"fused_mlp_grn backward {what} failed to launch (cudaError {rc})")

    with torch.cuda.device(dev):
        plan = bwd_plan(bsz, s, c, m, torch.cuda.get_device_properties(dev).multi_processor_count)
        w1c, w2c = w1.to(x.dtype), w2.to(x.dtype)
        nx = _grn_coeffs(ss, eps_grn)[2].contiguous()
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

        def front(mode, hout, part0, part1, coef1=None, coef2=None):
            check(lib.fmg_bwd_front(
                code, mode, _ptr(ln), _ptr(dz), _ptr(w1c), _ptr(w2c), _ptr(mask_f), _ptr(b1),
                _ptr(nx), _ptr(gg), _ptr(gb), _ptr(coef1), _ptr(coef2), _ptr(hout), _ptr(part0),
                _ptr(part1), bsz, s, c, m, stream,
            ), f"front {'CD'[mode]}")

        def gemm(kind, a, b, out, i, j, k, kps, splits):
            check(lib.fmg_bwd_gemm(code, kind, _ptr(a), a.shape[1], _ptr(b), b.shape[1], _ptr(out),
                                   i, j, k, kps, splits, stream), "product")

        # pass C
        ln, dz = torch.empty_like(x), torch.empty_like(x)
        mu, rstd = torch.empty((n,), **f32), torch.empty((n,), **f32)
        db2_part = torch.empty((plan.ln_blocks, c), **f32)
        check(lib.fmg_bwd_prep(code, _ptr(x), _ptr(g), _ptr(mask_f), _ptr(ln_s), _ptr(ln_b),
                               _ptr(ln), _ptr(dz), _ptr(mu), _ptr(rstd), _ptr(db2_part), n, c,
                               eps_ln, stream), "prep")
        mark("prep")
        ln, dz = ln.view(n, c), dz.view(n, c)
        y = torch.empty((n, m), dtype=x.dtype, device=dev)
        p_part = torch.empty((plan.row_tiles, m), **f32)
        dbg_part = torch.empty((plan.row_tiles, m), **f32)
        front(0, y, p_part, dbg_part)
        mark("front C")
        dw2_part = torch.empty((plan.splits, c, m), **f32)
        gemm(0, dz, y, dw2_part, c, m, n, plan.k_per_split, plan.splits)
        mark("d fc2")
        bwd_launches += 1
        masked_bwd_launches += mask_f is not None
        del y
        # glue
        p = p_part.view(bsz, plan.tiles_per_sample, m).sum(dim=1)
        coef1, coef2, dgg = _grn_bwd_coeffs(p, ss, gg, eps_grn)
        coef1, coef2 = coef1.contiguous(), coef2.contiguous()
        mark("glue")
        # pass D
        du = torch.empty((n, m), dtype=x.dtype, device=dev)
        db1_part = torch.empty((plan.row_tiles, m), **f32)
        front(1, du, db1_part, None, coef1, coef2)
        mark("front D")
        dw1_part = torch.empty((plan.splits, m, c), **f32)
        gemm(0, du, ln, dw1_part, m, c, n, plan.k_per_split, plan.splits)
        mark("d fc1")
        dln = torch.empty((n, c), **f32)
        gemm(1, du, w1c, dln, n, c, m, -(-m // BWD_K_STEP) * BWD_K_STEP, 1)
        del du
        dx = torch.empty_like(x)
        dls_part = torch.empty((plan.ln_blocks, c), **f32)
        dlb_part = torch.empty((plan.ln_blocks, c), **f32)
        check(lib.fmg_bwd_lnb(code, _ptr(x), _ptr(dln), _ptr(mu), _ptr(rstd), _ptr(ln_s),
                              _ptr(dx), _ptr(dls_part), _ptr(dlb_part), n, c, stream),
              "LayerNorm backward")
        mark("dln + LN backward")
        bwd_launches += 1
        masked_bwd_launches += mask_f is not None
    return (
        dx, g, dls_part.sum(dim=0), dlb_part.sum(dim=0), dw1_part.sum(dim=0),
        db1_part.sum(dim=0), dgg, dbg_part.sum(dim=0), dw2_part.sum(dim=0), db2_part.sum(dim=0),
    )


class FusedMlpGrn(torch.autograd.Function):
    """The fused block segment with its hand-derived gradient (the JAX
    ``custom_vjp``). CUDA tensors run kernels in both directions, CPU
    tensors the plain versions; the mask gets no gradient."""

    @staticmethod
    def forward(ctx, x, shortcut, mask, ln_s, ln_b, w1, b1, gg, gb, w2, b2, eps_ln, eps_grn):
        params = (ln_s, ln_b, w1, b1, gg, gb, w2, b2)
        if x.device.type == "cuda":
            mask_f = _check_cuda_args(x, shortcut, params, mask)
            out, ss = fused_fwd_op(x, shortcut, mask_f, *params, eps_ln, eps_grn)
        elif x.device.type == "cpu":
            ss = _reference_ss(x, ln_s, ln_b, w1, b1, mask, eps_ln)
            out = _reference_apply(x, shortcut, *params, ss, mask, eps_ln, eps_grn)
        else:
            raise RuntimeError(f"fused_mlp_grn runs on cuda (kernel) or cpu (plain), not {x.device}")
        ctx.save_for_backward(x, mask, ss, *params)
        ctx.eps = (eps_ln, eps_grn)
        return out

    @staticmethod
    def backward(ctx, g):
        x, mask, ss, *params = ctx.saved_tensors
        eps_ln, eps_grn = ctx.eps
        g = g.to(x.dtype).contiguous()
        if x.device.type == "cuda":
            mask_f = _check_cuda_args(x, g, params, mask)
            grads = _fused_bwd_cuda(x, g, params, mask_f, ss, eps_ln, eps_grn)
        else:
            grads = reference_mlp_grn_bwd(
                x, g, *params, ss, mask=mask, eps_ln=eps_ln, eps_grn=eps_grn
            )
        dx, dsc, *dparams = grads
        return (dx, dsc, None, *dparams, None, None)


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
    the residual add. CUDA tensors go through the kernels (any ``S``; the
    ragged last tile is masked in the kernels), CPU tensors through the
    plain versions; any other device raises. The result is differentiable
    in every argument but the mask.
    """
    if x.ndim != 3 or shortcut.shape != x.shape:
        raise ValueError(f"expected (B, S, C) pairs, got {tuple(x.shape)} / {tuple(shortcut.shape)}")
    if mask is not None and tuple(mask.shape) != tuple(x.shape[:2]):
        raise ValueError(f"mask must be (B, S), got {tuple(mask.shape)}")
    if x.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"fused_mlp_grn runs on cuda (kernel) or cpu (plain), not {x.device}")
    return FusedMlpGrn.apply(
        x, shortcut, mask, ln_scale, ln_bias, w1, b1, grn_gamma, grn_beta, w2, b2, eps_ln, eps_grn
    )
