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


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize(
    "dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 1.5e-2)], ids=["f32", "bf16"]
)
@pytest.mark.parametrize(
    "s,c,m", [(70, 40, 160), (100, 96, 384), (33, 200, 800), (47, 768, 3072)]
)
def test_kernel_matches_plain_on_card(s, c, m, dtype, rel, masked):
    """Ragged S tiles; C % 16 != 0 (CUDA-core path in bf16 too); 64- and
    32-row tensor-core tiles in bf16 (C = 96 and C = 768)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        args, mask = _card_case(s, c, m, dtype, masked)
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
