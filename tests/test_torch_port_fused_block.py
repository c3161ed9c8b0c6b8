"""viscy_tpu_torch.ops.fused_block against viscy_tpu.ops.pallas.fused_block.

The same numpy-seeded inputs go through the port's plain version and the
JAX package's Pallas kernel (interpret mode, several S tiles) and its jnp
oracle. Tolerances, relative to the output range: 1e-4 in float32 (sum
order only); 2e-2 in bfloat16 (a rounded intermediate may land one bf16
ulp apart when two f32 sums are ordered differently). The kernel itself
runs only on a card: see ``test_torch_port_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu.ops.pallas import fused_block as jfb
from viscy_tpu_torch.ops import fused_block as tfb

from _torch_port_helpers import assert_rel_close, block_args, torch_block_args


def _jax_args(a, dtype):
    act = lambda v: jnp.asarray(v).astype(dtype)
    return (
        act(a["x"]), act(a["shortcut"]),
        *(jnp.asarray(a[k]) for k in ("ln_scale", "ln_bias", "w1", "b1", "grn_gamma", "grn_beta", "w2", "b2")),
    )


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize(
    "jdt,tdt,rel",
    [(jnp.float32, torch.float32, 1e-4), (jnp.bfloat16, torch.bfloat16, 2e-2)],
    ids=["f32", "bf16"],
)
def test_reference_matches_jax_kernel_and_oracle(jdt, tdt, rel, masked):
    a = block_args()
    jmask = jnp.asarray(a["mask"]) if masked else None
    tmask = torch.from_numpy(a["mask"]) if masked else None
    got = tfb.reference_mlp_grn(*torch_block_args(a, tdt), mask=tmask)
    assert got.dtype == tdt
    got = got.float().numpy()
    # fwd_tile_cap=32 splits S=96 into three tiles: the GRN statistics
    # accumulate across tiles in the JAX kernel
    pallas = jfb.fused_mlp_grn(*_jax_args(a, jdt), mask=jmask, fwd_tile_cap=32, interpret=True)
    oracle = jfb.reference_mlp_grn(*_jax_args(a, jdt), mask=jmask)
    assert_rel_close(got, np.asarray(pallas, np.float32), rel)
    assert_rel_close(got, np.asarray(oracle, np.float32), rel)


def test_cpu_wrapper_runs_the_plain_version():
    a = block_args(s=40)
    args = torch_block_args(a, torch.float32)
    before = tfb.launches
    out = tfb.fused_mlp_grn(*args, mask=torch.from_numpy(a["mask"]))
    want = tfb.reference_mlp_grn(*args, mask=torch.from_numpy(a["mask"]))
    assert torch.equal(out, want)
    assert tfb.launches == before  # only kernel launches count


def test_wrapper_refuses_other_devices_and_bad_shapes():
    args = torch_block_args(block_args(s=8), torch.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        tfb.fused_mlp_grn(*(t.to("meta") for t in args))
    with pytest.raises(ValueError):
        tfb.fused_mlp_grn(args[0][0], args[1][0], *args[2:])
    with pytest.raises(ValueError):
        tfb.fused_mlp_grn(*args, mask=torch.ones(2, 7))


def test_grn_coeffs_match_jax():
    ss = np.random.default_rng(1).random((3, 48)).astype(np.float32) * 10
    got = tfb._grn_coeffs(torch.from_numpy(ss), 1e-6)
    want = jfb._grn_coeffs(jnp.asarray(ss), None, 1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)], ids=["f32", "bf16"])
def test_gelu_matches_jax(jdt, tdt):
    """Same rounding sites as the JAX kernel's GELU; erf itself differs by
    <= 4.2e-7 (torch.erf vs XLA's polynomial), invisible after bf16 rounding."""
    u = np.linspace(-6, 6, 4001, dtype=np.float32)
    got = tfb._gelu_exact(torch.from_numpy(u).to(tdt)).float().numpy()
    want = np.asarray(jfb._gelu_exact(jnp.asarray(u).astype(jdt)), np.float32)
    if tdt == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)
