"""The port's CUDA kernel against its plain version, and its build.

This file imports no JAX, so it also runs where the card is (JAX is not
installed there):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_kernels.py

The ``gpu`` tests skip where ``torch.cuda.is_available()`` is False.
Tolerances, relative to the plain output's range: 1e-4 in float32 with
TF32 off; 1.5e-2 and Pearson r > 0.9999 in bfloat16 (one bf16 ulp of a
rounded intermediate can flip between differently ordered f32 sums).
"""

import pytest
import torch

from viscy_tpu_torch.ops import _build
from viscy_tpu_torch.ops import fused_block as tfb

from _torch_port_helpers import assert_rel_close, block_args, torch_block_args


def test_build_names_libraries_by_source_and_needs_nvcc(monkeypatch, tmp_path):
    """The library name carries a hash of source and flags; with no nvcc the
    build raises instead of loading anything stale."""
    src, lib = _build._target("fused_mlp_grn")
    assert src.exists() and lib.parent == _build.BUILD_DIR
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-DVARIANT"))
    assert _build._target("fused_mlp_grn")[1] != lib
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
    with pytest.raises(FileNotFoundError):
        _build._target("no_such_kernel")


def test_build_reuses_a_built_library_with_its_nvcc_log(monkeypatch, tmp_path):
    """An up-to-date library is not rebuilt (no nvcc needed) and comes back
    with the ptxas lines of the build that made it."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    _, lib = _build._target("fused_mlp_grn")
    lib.write_bytes(b"")
    lib.with_name(lib.name + ".log").write_text("ptxas info    : Used 128 registers\n")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    (result,) = _build.build_all(["fused_mlp_grn"])
    assert result.cached and result.path == lib and result.seconds == 0.0
    assert "Used 128 registers" in result.log


def _card_case(s, c, m, dtype, masked, b=3, seed=0):
    a = block_args(b=b, s=s, c=c, m=m, seed=seed)
    args = torch_block_args(a, dtype, device="cuda")
    mask = torch.from_numpy(a["mask"]).cuda() if masked else None
    return args, mask


# (9, 96, 384) at B = 5: S under one row tile, so pass A's row tiles stop at
# each sample's end and pass B's tiles straddle samples; (21, 38, 151): rows
# not a multiple of 16 bytes (tiles load without cp.async) and an odd M;
# (2304, 192, 768) at B = 16 (a training shape): 256-wide pass-B tiles on an
# H100 (the other shapes fit one wave of 128-wide tiles)
FWD_SHAPES = [(70, 40, 160), (100, 96, 384), (33, 200, 800), (47, 768, 3072), (9, 96, 384),
              (21, 38, 151), (2304, 192, 768)]
FWD_BATCH = {(9, 96, 384): 5, (2304, 192, 768): 16}


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize(
    "dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 1.5e-2)], ids=["f32", "bf16"]
)
@pytest.mark.parametrize("s,c,m", FWD_SHAPES)
def test_kernel_matches_plain_on_card(s, c, m, dtype, rel, masked):
    """Ragged S tiles; C and M off the tile widths (C = 40, 200; M = 160,
    800); both pass-B tile widths; samples under one row tile; unaligned
    rows and an odd M."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        args, mask = _card_case(s, c, m, dtype, masked, b=FWD_BATCH.get((s, c, m), 3))
        before = tfb.launches
        got = tfb.fused_mlp_grn(*args, mask=mask)
        want = tfb.reference_mlp_grn(*args, mask=mask)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert tfb.launches == before + 2
    assert got.dtype == dtype
    assert_rel_close(
        got.float().cpu().numpy(),
        want.float().cpu().numpy(),
        rel,
        0.9999 if dtype == torch.bfloat16 else None,
    )


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_runs_are_bit_identical_on_card(dtype):
    """No float atomics: two forward calls give the same output and ``ss``
    to the bit (masked, several row tiles per sample, ragged tiles)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, mask = _card_case(200, 96, 384, dtype, True)
    x, sc, *params = args
    mask_f = tfb._check_cuda_args(x, sc, params, mask)
    out1, ss1 = tfb._fused_cuda(x, sc, params, mask_f, 1e-6, 1e-6)
    out2, ss2 = tfb._fused_cuda(x, sc, params, mask_f, 1e-6, 1e-6)
    torch.cuda.synchronize()
    assert torch.equal(out1, out2) and torch.equal(ss1, ss2)


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, _ = _card_case(40, 32, 128, torch.float32, False)
    with pytest.raises(TypeError):
        tfb.fused_mlp_grn(*(a.half() for a in args[:2]), *args[2:])
    with pytest.raises(TypeError):
        tfb.fused_mlp_grn(*args[:4], args[4].double(), *args[5:])
    with pytest.raises(ValueError):
        tfb.fused_mlp_grn(args[0], args[1], *args[2:4], args[4].t(), *args[5:])
    with pytest.raises(ValueError):
        tfb.fused_mlp_grn(args[0], args[1], *args[2:4], args[4].t().contiguous().t(), *args[5:])


def _grads_case(s, c, m, dtype, masked, b=3, seed=0):
    args, mask = _card_case(s, c, m, dtype, masked, b=b, seed=seed)
    g = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(seed + 1)).to(
        device="cuda", dtype=dtype
    )
    return args, mask, g


# (9, 96, 384) at B = 5: S under one row tile and B S not a multiple of it,
# so row tiles must stop at each sample's end, and the split-K tail is short;
# (21, 38, 151): rows not a multiple of 16 bytes (tiles load without
# cp.async) and an odd M (y and du stored one element at a time)
BWD_SHAPES = [(70, 40, 160), (100, 96, 384), (33, 480, 1920), (47, 768, 3072), (9, 96, 384),
              (21, 38, 151)]
BWD_BATCH = {(9, 96, 384): 5}
GRAD_NAMES = ("dx", "dshortcut", "dln_scale", "dln_bias", "dw1", "db1", "dgrn_gamma",
              "dgrn_beta", "dw2", "db2")


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize(
    "dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 1.5e-2)], ids=["f32", "bf16"]
)
@pytest.mark.parametrize("s,c,m", BWD_SHAPES)
def test_bwd_kernels_match_plain_on_card(s, c, m, dtype, rel, masked):
    """Passes C and D against ``reference_mlp_grn_bwd`` on the same ``ss``:
    ragged S; C % 16 != 0; S below one row tile; unaligned rows; every
    gradient.
    Same tolerances as the forward; Pearson r > 0.999 in bf16 (a du
    rounded one bf16 ulp apart moves a whole weight-gradient product)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        args, mask, g = _grads_case(s, c, m, dtype, masked, b=BWD_BATCH.get((s, c, m), 3))
        x, _, *params = args
        ss = tfb._reference_ss(x, *params[:4], mask, 1e-6)
        mask_f = tfb._check_cuda_args(x, g, params, mask)
        before = tfb.bwd_launches
        got = tfb._fused_bwd_cuda(x, g, params, mask_f, ss, 1e-6, 1e-6)
        again = tfb._fused_bwd_cuda(x, g, params, mask_f, ss, 1e-6, 1e-6)
        want = tfb.reference_mlp_grn_bwd(x, g, *params, ss, mask=mask)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert tfb.bwd_launches == before + 4
    for name, a, b2, w in zip(GRAD_NAMES, got, again, want):
        assert torch.equal(a, b2), f"{name} differs between two runs"
        assert a.shape == w.shape and a.dtype == w.dtype, name
        assert_rel_close(a.float().cpu().numpy(), w.float().cpu().numpy(), rel,
                         0.999 if dtype == torch.bfloat16 else None)


@pytest.mark.gpu
def test_cuda_output_carries_grad_fn_and_plain_gradients():
    """Under grad the CUDA path stays in the autograd graph and its
    gradients are the plain backward's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, mask, g = _grads_case(64, 96, 384, torch.float32, False)
    leaves = [a.clone().requires_grad_(True) for a in args]
    out = tfb.fused_mlp_grn(*leaves)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, g)
    x, _, *params = args
    ss = tfb._reference_ss(x, *params[:4], None, 1e-6)
    want = tfb.reference_mlp_grn_bwd(x, g, *params, ss)
    for name, a, w in zip(GRAD_NAMES, got, want):
        assert_rel_close(a.cpu().numpy(), w.cpu().numpy(), 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize(
    "in_shape,out_shape,offset",
    [((8, 40, 36), (6, 32, 30), (0.5, 0.0, -0.5)), ((20, 60, 60), (15, 38, 38), "per-sample")],
    ids=["non-square", "crop"],
)
def test_warp_kernel_matches_plain_on_card(in_shape, out_shape, offset, mode):
    """The warp kernel rounds where the plain version rounds: the two agree
    to 1e-6 of the input range on the same matrices (non-square planes,
    tuple and per-sample offsets, flips)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from viscy_tpu_torch.ops import warp as tw
    from viscy_tpu_torch.ops import warp3d

    gen = torch.Generator().manual_seed(3)
    b = 4
    vol = torch.rand((b, 3, *in_shape), generator=gen)
    rot = (torch.rand((b, 3), generator=gen) - 0.5) * torch.tensor([6.28, 0.3, 0.3])
    scale = 0.6 + 0.9 * torch.rand((b, 3), generator=gen)
    shear = (torch.rand((b, 6), generator=gen) - 0.5) * 0.1
    mats = tw.compose_affine_3d(rotation=rot, scale=scale, shear=shear)
    off = (torch.rand((b, 3), generator=gen) - 0.5) * 4 if offset == "per-sample" else offset
    signs = torch.where(torch.rand((b, 3), generator=gen) < 0.5, -1.0, 1.0)
    for flips in (None, signs):
        dev = lambda t: t.cuda() if isinstance(t, torch.Tensor) else t
        before = warp3d.launches
        got = warp3d.affine_warp_3d(vol.cuda(), mats.cuda(), out_shape, mode, dev(off), dev(flips))
        want = tw.affine_warp_3d(vol.cuda(), mats.cuda(), out_shape, mode, dev(off), dev(flips))
        torch.cuda.synchronize()
        assert warp3d.launches == before + 1
        assert got.shape == (b, 3, *out_shape)
        assert float((got - want).abs().max()) <= 1e-6
