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


def _warp_keys_case(in_shape, b, seed, scale=None):
    """Two keys (1 and 2 channels), production-range maps (or the given
    per-axis scale), per-sample offsets, flip signs, an apply mask that
    leaves samples 1 and 3 alone."""
    from viscy_tpu_torch.ops import warp as tw

    gen = torch.Generator().manual_seed(seed)
    keys = [torch.rand((b, 1, *in_shape), generator=gen), torch.rand((b, 2, *in_shape), generator=gen)]
    rot = (torch.rand((b, 3), generator=gen) - 0.5) * torch.tensor([6.28, 0.0, 0.0])
    if scale is None:
        lo, hi = torch.tensor([0.7, 0.5, 0.5]), torch.tensor([1.3, 1.5, 1.5])
        scale = lo + (hi - lo) * torch.rand((b, 3), generator=gen)
    else:
        scale = torch.tensor(scale).expand(b, 3)
    shear = torch.zeros((b, 6))
    shear[:, 1:3] = (torch.rand((b, 2), generator=gen) - 0.5) * torch.tensor([0.1 * in_shape[0] / in_shape[1], 0.1])
    mats = tw.compose_affine_3d(rotation=rot, scale=scale, shear=shear)
    off = (torch.rand((b, 3), generator=gen) - 0.5) * 2
    signs = torch.where(torch.rand((b, 3), generator=gen) < 0.5, -1.0, 1.0)
    mask = torch.ones(b, dtype=torch.bool)
    mask[1::2] = False
    return keys, mats, off, signs, mask


def _check_warp_keys_on_card(keys, mats, out_shape, mode, off, signs, mask):
    """Kernel vs plain on the card: max|d| <= 1e-6 (inputs in [0, 1]), one
    launch, two runs bit-identical, direct-path blocks as the plan says.
    Returns the kernel's counters."""
    from viscy_tpu_torch.ops import warp as tw
    from viscy_tpu_torch.ops import warp3d

    dev = lambda t: None if t is None else t.cuda()
    cuda_keys = [k.cuda() for k in keys]
    vec = keys[0].shape[-1] % 4 == 0 and all(k.data_ptr() % 16 == 0 for k in cuda_keys)
    args = (cuda_keys, mats.cuda(), out_shape, mode, dev(off), dev(signs))
    counters = warp3d.direct_counter("cuda")
    counters.zero_()
    before = warp3d.launches
    got = warp3d.affine_warp_3d_keys(*args, apply_mask=dev(mask))
    torch.cuda.synchronize()
    assert warp3d.launches == before + 1
    seen = counters.cpu().tolist()
    again = warp3d.affine_warp_3d_keys(*args, apply_mask=dev(mask))
    want = tw.affine_warp_3d_keys(*args, apply_mask=dev(mask))
    torch.cuda.synchronize()
    for g, a, w, k in zip(got, again, want, keys):
        assert g.shape == (k.shape[0], k.shape[1], *out_shape)
        assert torch.equal(g, a)
        assert float((g - w).abs().max()) <= 1e-6
    plan = warp3d.warp_plan(mats, keys[0].shape[-3:], out_shape, mode, off, signs,
                            channels=sum(k.shape[1] for k in keys), vec=vec)
    applied = torch.ones(len(mats), dtype=torch.bool) if mask is None else mask
    assert seen[0] == int(plan.direct_blocks[applied].sum())
    assert seen[2] == int(applied.sum())
    return seen


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
@pytest.mark.parametrize(
    "in_shape,out_shape",
    [((9, 50, 41), (6, 45, 38)), ((20, 60, 64), (15, 38, 41))],
    ids=["ragged-4B", "crop-16B"],
)
def test_warp_keys_kernel_matches_plain_on_card(in_shape, out_shape, mode, flip):
    """Two keys (1 + 2 channels) in one launch, an apply mask leaving two
    samples as exact crops, tiles ragged at both edges; the 4-byte (Xi =
    41) and 16-byte (Xi = 64) staging."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    keys, mats, off, signs, mask = _warp_keys_case(in_shape, b=4, seed=5)
    seen = _check_warp_keys_on_card(keys, mats, out_shape, mode, off, signs if flip else None, mask)
    if mode != "reflection":
        assert seen[0] == 0 and seen[1] == 0  # production-range maps stage every read


@pytest.mark.gpu
@pytest.mark.parametrize("zoom", [3, 10])
def test_warp_kernel_large_boxes_match_plain_on_card(zoom):
    """Zoomed out 3x in y and x, a tile's box holds one slice's planes of
    one channel but not of three: the blocks stage one channel per pass.
    At 10x it holds neither: interior blocks take the direct path. The
    result is the plain version's either way; an unaligned source takes
    the 4-byte staging."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    keys, mats, off, signs, mask = _warp_keys_case((10, 200, 200), b=3, seed=6,
                                                   scale=[0.7, 1 / zoom, 1 / zoom])
    from viscy_tpu_torch.ops import warp3d

    plan = warp3d.warp_plan(mats, (10, 200, 200), (8, 48, 48), "zeros", off, signs, channels=3)
    assert (plan.cpass == 1).any()
    seen = _check_warp_keys_on_card(keys, mats, (8, 48, 48), "zeros", off, signs, None)
    assert (seen[0] > 0) == (zoom == 10)
    flat = torch.empty(keys[1].numel() + 1, device="cuda")
    shifted = flat[1:].view(keys[1].shape)  # 4 bytes off 16-byte alignment
    shifted.copy_(keys[1])
    _check_warp_keys_on_card([keys[0], shifted], mats, (8, 48, 48), "border", off, signs, mask)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "channels,in_shape,out_shape",
    [((1,), (9, 50, 44), (6, 45, 38)), ((2,), (9, 50, 44), (6, 45, 38)),
     ((1, 3), (9, 50, 44), (6, 45, 38)), ((2, 3), (9, 50, 44), (6, 45, 38)),
     ((1, 2), (134, 30, 28), (130, 20, 18))],
    ids=["1ch", "2ch", "4ch", "5ch-any-count", "130-slices"],
)
def test_warp_kernel_channel_counts_and_long_runs_on_card(channels, in_shape, out_shape):
    """Every instance of the kernel (1-4 channels, and any count) and a run
    of output slices longer than a block has threads (the slice table is
    filled in strides), against the plain version with an apply mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, mats, off, signs, mask = _warp_keys_case(in_shape, b=4, seed=7)
    gen = torch.Generator().manual_seed(8)
    keys = [torch.rand((4, c, *in_shape), generator=gen) for c in channels]
    seen = _check_warp_keys_on_card(keys, mats, out_shape, "zeros", off, signs, mask)
    assert seen[0] == 0 and seen[1] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("fused", ["none", "flip", "randcrop"])
def test_warp_kernel_on_the_recipe_member_with_a_bool_mask_on_card(monkeypatch, fused):
    """The VSCyto3D fit recipe's affine (in == out (15, 64, 64)) with a
    bool ``fg_mask`` key beside source and target: as the recipe runs it
    (the member's apply mask), with a fused in-plane flip, and with a fused
    random crop to (7, 47, 45) (odd S - R on every axis). With a fusion the
    apply mask goes into the maps: an unapplied sample is warped by the
    identity, so it is its input (random crop) exactly, flipped where its
    draw says. One launch; the kernel equals the plain version on the card
    on the arguments the member passed, floats to 1e-6 and the bool key
    exactly (nonzero -> True after the f32 warp)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from viscy_tpu_torch import transforms as T
    from viscy_tpu_torch.ops import warp as tw
    from viscy_tpu_torch.ops import warp3d
    from viscy_tpu_torch.transforms import affine as taffine

    calls = []

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return warp3d.affine_warp_3d_keys(*args, **kwargs)

    monkeypatch.setattr(taffine, "affine_warp_3d_keys", spy)
    keys = ["source", "target", "fg_mask"]
    members = [T.BatchedRandAffined(keys=keys, prob=0.5, rotate_range=[3.14, 0.0, 0.0],
                                    scale_range=[[1.0, 1.3], [0.75, 1.3], [0.75, 1.3]])]
    if fused == "flip":
        members.append(T.BatchedRandFlipd(keys=keys, spatial_axes=(1, 2), prob=0.5))
    elif fused == "randcrop":
        members.append(T.BatchedRandSpatialCropd(keys=keys, roi_size=[7, 47, 45]))
    compose = T.Compose(members)
    assert len(compose) == 1
    member = compose.transforms[0]
    gen = torch.Generator(device="cuda").manual_seed(9)
    b, shape = 8, (15, 64, 64)
    data = {"source": torch.rand((b, 1, *shape), generator=gen, device="cuda"),
            "target": torch.rand((b, 2, *shape), generator=gen, device="cuda"),
            "fg_mask": torch.rand((b, 1, *shape), generator=gen, device="cuda") > 0.7}
    draws = member.draw(data, gen)
    draws["mask"][:2] = False
    draws["mask"][2:4] = True
    if fused == "flip":
        draws["flips"][:2] = torch.tensor([[True, False], [True, True]], device="cuda")
    before = warp3d.launches
    got = member(dict(data), draws=draws)
    torch.cuda.synchronize()
    assert warp3d.launches == before + 1 and len(calls) == 1
    args, kwargs = calls[0]
    # the mask went into the maps exactly when a flip or random crop is fused
    assert (kwargs.get("apply_mask") is None) == (fused != "none")
    want = dict(zip(keys, tw.affine_warp_3d_keys(*args, **kwargs)))
    for k in keys:
        assert got[k].dtype == data[k].dtype and got[k].shape == want[k].shape
        if k == "fg_mask":
            assert torch.equal(got[k], want[k])
        else:
            assert float((got[k] - want[k]).abs().max()) <= 1e-6
    for k in keys:
        if fused == "randcrop":
            crops = T.batched_crop_at(data[k], draws["starts"], (7, 47, 45))
            assert torch.equal(got[k][:2], crops[:2])
        elif fused == "flip":
            assert torch.equal(got[k][0], data[k][0].flip(-2))
            assert torch.equal(got[k][1], data[k][1].flip(-2, -1))
        else:
            assert torch.equal(got[k][:2], data[k][:2])


# the FCMAE pretraining encoder's (S, C, M) at 256^2 with a (5, 4, 4) stem;
# B = 2 so pass A's row tiles stop at each sample's end (at S = 64 every
# tile is ragged) and pass B's tiles straddle the two samples
PRETRAIN_SHAPES = [(4096, 96, 384), (1024, 192, 768), (256, 384, 1536), (64, 768, 3072)]


def _pretrain_keep(s: int, b: int = 2, seed: int = 0) -> torch.Tensor:
    """(B, S) bool keep mask of the pretraining encoder at S tokens: an 8 x 8
    mask grid at ratio 0.5 (``generate_mask``), upsampled to the stage's
    grid, True where tokens are kept."""
    from viscy_tpu_torch.models.components.stems import upsample_mask_2d
    from viscy_tpu_torch.models.unet.fcmae import generate_mask

    side = int(round(s**0.5))
    low = generate_mask(torch.Generator(device="cuda").manual_seed(seed), b, (256, 256), 32, 0.5)
    return (~upsample_mask_2d(low, (side, side))).reshape(b, s)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 1.5e-2)], ids=["f32", "bf16"]
)
@pytest.mark.parametrize("s,c,m", PRETRAIN_SHAPES)
def test_masked_kernels_at_the_pretraining_shapes_on_card(s, c, m, dtype, rel):
    """The masked forward and backward against their plain versions with the
    pretraining encoder's patch mask (bool, as the blocks pass it); each
    launch counted as masked too. Tolerances as the tests above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        args, _, g = _grads_case(s, c, m, dtype, False, b=2, seed=s)
        keep = _pretrain_keep(s, seed=c)
        before = (tfb.launches, tfb.masked_launches)
        got = tfb.fused_mlp_grn(*args, mask=keep)
        want = tfb.reference_mlp_grn(*args, mask=keep)
        x, _, *params = args
        ss = tfb._reference_ss(x, *params[:4], keep, 1e-6)
        mask_f = tfb._check_cuda_args(x, g, params, keep)
        bwd_before = (tfb.bwd_launches, tfb.masked_bwd_launches)
        grads = tfb._fused_bwd_cuda(x, g, params, mask_f, ss, 1e-6, 1e-6)
        want_grads = tfb.reference_mlp_grn_bwd(x, g, *params, ss, mask=keep)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert (tfb.launches, tfb.masked_launches) == (before[0] + 2, before[1] + 2)
    assert (tfb.bwd_launches, tfb.masked_bwd_launches) == (bwd_before[0] + 2, bwd_before[1] + 2)
    r_min = 0.9999 if dtype == torch.bfloat16 else None
    assert_rel_close(got.float().cpu().numpy(), want.float().cpu().numpy(), rel, r_min)
    for name, a, w in zip(GRAD_NAMES, grads, want_grads):
        assert a.shape == w.shape, name
        assert_rel_close(a.float().cpu().numpy(), w.float().cpu().numpy(), rel,
                         0.999 if dtype == torch.bfloat16 else None)


@pytest.mark.gpu
@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
def test_warp_kernel_at_depth_one_on_card(flip):
    """The 2-D fine-tune's affine (rotation about z, YX scale 0.75-1.3) on
    (B, C, 1, Y, X) stacks, in == out, an apply mask: the rotation's z
    coordinate is 0 up to rounding, and the kernel weights the one plane as
    the plain version does (max|d| <= 1e-6, one launch, bit-identical
    repeats, direct-path blocks as ``warp_plan`` says)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from viscy_tpu_torch.ops import warp as tw

    b, shape = 6, (1, 96, 96)
    gen = torch.Generator().manual_seed(11)
    keys = [torch.rand((b, 1, *shape), generator=gen), torch.rand((b, 2, *shape), generator=gen)]
    rot = (torch.rand((b, 3), generator=gen) - 0.5) * torch.tensor([6.28, 0.0, 0.0])
    yx = 0.75 + 0.55 * torch.rand((b, 2), generator=gen)
    mats = tw.compose_affine_3d(rotation=rot, scale=torch.cat([torch.ones((b, 1)), yx], dim=1))
    signs = torch.where(torch.rand((b, 3), generator=gen) < 0.5, -1.0, 1.0) if flip else None
    mask = torch.ones(b, dtype=torch.bool)
    mask[::3] = False
    _check_warp_keys_on_card(keys, mats, shape, "zeros", None, signs, mask)


def test_samples_per_launch_keeps_every_grid_within_its_limit():
    """The fine-tune's stage 0 on whole 1024^2 frames ((1, 2, 2) stem: S =
    512^2, C = 96, M = 384) takes at most 15 samples a launch: at 15 every
    row-tile grid fits, at 16 pass B's does not."""
    s, m = 512 * 512, 384
    per = tfb.samples_per_launch(s, m)
    assert per == 15

    def tiles(b):
        plan = tfb.fwd_plan(b, s, 96, m, 132)
        return (plan.row_tiles, plan.apply_row_tiles, tfb.bwd_plan(b, s, 96, m, 132).row_tiles,
                -(-b * s // tfb.BWD_TILE))

    assert max(tiles(per)) <= tfb.MAX_ROW_TILES < max(tiles(per + 1))
    assert tfb.samples_per_launch(64, 3072) == tfb.MAX_ROW_TILES
    with pytest.raises(ValueError, match="even one sample"):
        tfb.samples_per_launch(2**23, 384)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 1.5e-2)], ids=["f32", "bf16"]
)
def test_batch_above_the_grid_runs_as_several_launches_on_card(dtype, rel):
    """B = 16 at the fine-tune's stage 0 on whole 1024^2 frames, one sample
    above :func:`samples_per_launch`: the forward and backward run as two
    launches each (15 + 1 samples) and match their plain versions, masked.
    Tolerances as the tests above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    s, c, m, b = 512 * 512, 96, 384, 16
    assert tfb.samples_per_launch(s, m) == b - 1
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        args, mask, g = _grads_case(s, c, m, dtype, True, b=b, seed=5)
        before = (tfb.launches, tfb.masked_launches, tfb.bwd_launches)
        got = tfb.fused_mlp_grn(*args, mask=mask)
        want = tfb.reference_mlp_grn(*args, mask=mask)
        x, _, *params = args
        ss = tfb._reference_ss(x, *params[:4], mask, 1e-6)
        mask_f = tfb._check_cuda_args(x, g, params, mask)
        grads = tfb._fused_bwd_cuda(x, g, params, mask_f, ss, 1e-6, 1e-6)
        want_grads = tfb.reference_mlp_grn_bwd(x, g, *params, ss, mask=mask)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert (tfb.launches, tfb.masked_launches, tfb.bwd_launches) == (
        before[0] + 4, before[1] + 4, before[2] + 4)
    r_min = 0.9999 if dtype == torch.bfloat16 else None
    assert_rel_close(got.float().cpu().numpy(), want.float().cpu().numpy(), rel, r_min)
    for name, a, w in zip(GRAD_NAMES, grads, want_grads):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        assert_rel_close(a.float().cpu().numpy(), w.float().cpu().numpy(), rel,
                         0.999 if dtype == torch.bfloat16 else None)


# UNeXt2 at the released VSCyto3D config (1 -> 2 channels, depth 5, stem (5, 4, 4)):
# encoder stage 0 (C = 96) and the last decoder stage (C = (5 + 2) * 2 * 4 * 4 = 224,
# M = 896) at 384^2 training patches (S = 96^2) and 320^2 predict tiles (S = 80^2), and
# the last decoder stage on a full 2048^2 frame (S = 512^2, B = 1)
UNEXT2_SHAPES = [(9216, 96, 384), (9216, 224, 896), (6400, 224, 896), (262144, 224, 896)]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 1.5e-2)], ids=["f32", "bf16"]
)
@pytest.mark.parametrize("s,c,m", UNEXT2_SHAPES)
def test_kernels_at_the_unext2_shapes_on_card(s, c, m, dtype, rel):
    """The forward and backward kernels against their plain versions at the
    UNeXt2 path's shapes (B = 2; 1 on the full frame), two backward runs
    bit-identical. Tolerances as the tests above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        args, _, g = _grads_case(s, c, m, dtype, False, b=1 if s > 10**5 else 2, seed=c)
        before = (tfb.launches, tfb.bwd_launches)
        got = tfb.fused_mlp_grn(*args)
        want = tfb.reference_mlp_grn(*args)
        x, _, *params = args
        ss = tfb._reference_ss(x, *params[:4], None, 1e-6)
        grads = tfb._fused_bwd_cuda(x, g, params, None, ss, 1e-6, 1e-6)
        again = tfb._fused_bwd_cuda(x, g, params, None, ss, 1e-6, 1e-6)
        want_grads = tfb.reference_mlp_grn_bwd(x, g, *params, ss)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert (tfb.launches, tfb.bwd_launches) == (before[0] + 2, before[1] + 4)
    r_min = 0.9999 if dtype == torch.bfloat16 else None
    assert_rel_close(got.float().cpu().numpy(), want.float().cpu().numpy(), rel, r_min)
    for name, a, b2, w in zip(GRAD_NAMES, grads, again, want_grads):
        assert torch.equal(a, b2), f"{name} differs between two runs"
        assert a.shape == w.shape, name
        assert_rel_close(a.float().cpu().numpy(), w.float().cpu().numpy(), rel,
                         0.999 if dtype == torch.bfloat16 else None)


# -- the device transforms without a kernel of their own: card against CPU ------------------------


# the cross-modal joint encoders (convnextv2_tiny at 224^2 under a (5, 4, 4)
# stem, batch 32): their largest (S = 56^2, C = 96) and smallest (S = 7^2,
# C = 768) row counts
JOINT_SHAPES = [(3136, 96, 384), (49, 768, 3072)]
JOINT_BATCH = 32


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 1.5e-2)], ids=["f32", "bf16"]
)
@pytest.mark.parametrize("s,c,m", JOINT_SHAPES)
def test_kernels_at_the_joint_encoder_shapes_on_card(s, c, m, dtype, rel):
    """The forward and backward kernels against their plain versions at
    the joint encoders' largest and smallest row counts at batch 32, two
    backward runs bit-identical, the launches as the batch split gives
    them. Tolerances as the tests above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        args, _, g = _grads_case(s, c, m, dtype, False, b=JOINT_BATCH, seed=c + 1)
        before = (tfb.launches, tfb.bwd_launches)
        got = tfb.fused_mlp_grn(*args)
        want = tfb.reference_mlp_grn(*args)
        x, _, *params = args
        ss = tfb._reference_ss(x, *params[:4], None, 1e-6)
        grads = tfb._fused_bwd_cuda(x, g, params, None, ss, 1e-6, 1e-6)
        again = tfb._fused_bwd_cuda(x, g, params, None, ss, 1e-6, 1e-6)
        want_grads = tfb.reference_mlp_grn_bwd(x, g, *params, ss)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    calls = -(-JOINT_BATCH // tfb.samples_per_launch(s, m))
    assert (tfb.launches, tfb.bwd_launches) == (before[0] + 2 * calls, before[1] + 4 * calls)
    r_min = 0.9999 if dtype == torch.bfloat16 else None
    assert_rel_close(got.float().cpu().numpy(), want.float().cpu().numpy(), rel, r_min)
    for name, a, b2, w in zip(GRAD_NAMES, grads, again, want_grads):
        assert torch.equal(a, b2), f"{name} differs between two runs"
        assert a.shape == w.shape, name
        assert_rel_close(a.float().cpu().numpy(), w.float().cpu().numpy(), rel,
                         0.999 if dtype == torch.bfloat16 else None)


def _new_members():
    from viscy_tpu_torch import transforms as T

    both, src = dict(keys=["source", "target"]), dict(keys=["source"])
    return {
        "elastic": T.BatchedRand3DElasticd(**both, sigma_range=(2.0, 3.0), magnitude_range=(2.0, 4.0), prob=0.7),
        "elastic-zeros": T.BatchedRand3DElasticd(**both, sigma_range=(4.0, 5.0), magnitude_range=(5.0, 9.0),
                                                 prob=1.0, padding_mode="zeros"),
        "z-shift": T.BatchedRandZStackShiftd(**both, max_shift=3, prob=0.8, cval=-1.0),
        "histogram-shift": T.BatchedRandHistogramShiftd(**src, prob=0.8),
        "sharpen": T.BatchedRandSharpend(**src, prob=0.8),
        "pixel-shuffle": T.BatchedRandLocalPixelShufflingd(**both, prob=0.8),
        "invert": T.BatchedRandInvertIntensityd(**src, prob=0.5),
        "invert-per-call": T.RandInvertIntensityd(**src, prob=1.0),
        "noise-per-call": T.RandGaussianNoiseTensord(**both, prob=1.0, std=0.3),
        "percentiles": T.BatchedScaleIntensityRangePercentilesd(**both, lower=1, upper=99, b_min=0, b_max=1),
        "weighted-crop": T.BatchedRandWeightedCropd(**both, w_key="target", spatial_size=(8, 64, 64)),
        "z-reduction": T.BatchedChannelWiseZReductiond(**both),
        "zoom-linear-aa": T.BatchedZoomd(**both, scale_factor=(1.0, 0.5, 0.5), mode="linear", antialias=True),
        "zoom-cubic": T.BatchedZoomd(**both, scale_factor=(0.5, 1.5, 0.7), mode="bicubic"),
        "zoom-nearest": T.BatchedZoomd(**both, scale_factor=(1.0, 0.75, 1.25), mode="nearest"),
    }


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_new_members()))
def test_new_device_member_on_card_matches_cpu(name):
    """Each device transform that has no kernel of its own (plain PyTorch on
    the batch's device), its draws taken once on the CPU and handed to both
    runs: max|d| <= 1e-5 of the output's range in float32, TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t = _new_members()[name]
    g = torch.Generator().manual_seed(3)
    batch = {"source": torch.rand((4, 1, 15, 96, 96), generator=g),
             "target": torch.rand((4, 2, 15, 96, 96), generator=g)}
    draws = t.draw(batch, torch.Generator().manual_seed(4)) if t.is_random else None
    call = (lambda d, dr: t(d, draws=dr)) if t.is_random else (lambda d, dr: t(d))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = call(dict(batch), draws)
        got = call(_to(batch, "cuda"), _to(draws, "cuda"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for k, w in want.items():
        assert got[k].is_cuda and got[k].shape == w.shape, k
        span = float(w.max() - w.min()) or 1.0
        assert float((got[k].cpu() - w).abs().max()) <= 1e-5 * span, k
