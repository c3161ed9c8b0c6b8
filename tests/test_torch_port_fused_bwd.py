"""The port's fused MLP+GRN gradient (passes C and D) against viscy_tpu.

``FusedMlpGrn`` on CPU tensors runs the plain forward and backward
(``reference_mlp_grn_bwd``); its ten gradients are compared with
``jax.grad`` of the JAX Pallas kernel (interpret mode, several S tiles, so
the TPU kernels' cross-tile accumulation is exercised) on the same
numpy-seeded inputs and cotangent. Tolerances, relative to each gradient's
range: 1e-4 in float32 (sum order only); 2e-2 and Pearson r > 0.999 in
bfloat16 (a rounded du may land one bf16 ulp apart when two f32 sums are
ordered differently, moving a whole product of a weight gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu.ops.pallas import fused_block as jfb
from viscy_tpu_torch.ops import fused_block as tfb

from _torch_port_helpers import assert_rel_close, block_args, torch_block_args

PARAM_KEYS = ("ln_scale", "ln_bias", "w1", "b1", "grn_gamma", "grn_beta", "w2", "b2")
NAMES = ("x", "shortcut", *PARAM_KEYS)


def _cotangent(shape, seed=7):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _jax_grads(a, g, jdt, masked):
    act = lambda v: jnp.asarray(v).astype(jdt)
    mask = jnp.asarray(a["mask"]) if masked else None

    def f(x, sc, *params):
        out = jfb.fused_mlp_grn(x, sc, *params, mask=mask, fwd_tile_cap=16, bwd_tile_cap=16,
                                interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g))

    args = (act(a["x"]), act(a["shortcut"]), *(jnp.asarray(a[k]) for k in PARAM_KEYS))
    return jax.grad(f, argnums=tuple(range(10)))(*args)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize(
    "jdt,tdt,rel,r_min",
    [(jnp.float32, torch.float32, 1e-4, None), (jnp.bfloat16, torch.bfloat16, 2e-2, 0.999)],
    ids=["f32", "bf16"],
)
def test_fused_grads_match_jax_kernel(jdt, tdt, rel, r_min, masked):
    """S = 40 runs through five 8-row tiles in the JAX kernels."""
    a = block_args(b=2, s=40, c=16, m=48, seed=3)
    g = _cotangent(a["x"].shape)
    want = _jax_grads(a, g, jdt, masked)
    leaves = [t.clone().requires_grad_(True) for t in torch_block_args(a, tdt)]
    mask = torch.from_numpy(a["mask"]) if masked else None
    out = tfb.fused_mlp_grn(*leaves, mask=mask)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(tdt))
    for name, gt, w in zip(NAMES, got, want):
        w = np.asarray(w, np.float32)
        gt = gt.float().numpy()
        if name in ("w1", "w2"):
            gt = gt.T  # torch (out, in) layout
        assert gt.shape == w.shape, name
        assert_rel_close(gt, w, rel, r_min)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_reference_bwd_matches_autograd_of_reference(masked):
    """The hand-derived plain backward equals autograd of the plain forward
    (float32, 1e-5 of each gradient's range)."""
    a = block_args(b=2, s=37, c=24, m=96, seed=5)
    leaves = [t.clone().requires_grad_(True) for t in torch_block_args(a, torch.float32)]
    mask = torch.from_numpy(a["mask"][:, :37]) if masked else None
    g = torch.from_numpy(_cotangent(leaves[0].shape))
    out = tfb.reference_mlp_grn(*leaves, mask=mask)
    want = torch.autograd.grad(out, leaves, g)
    x, _, *params = (t.detach() for t in leaves)
    ss = tfb._reference_ss(x, *params[:4], mask, 1e-6)
    got = tfb.reference_mlp_grn_bwd(x, g, *params, ss, mask=mask)
    for gt, w in zip(got, want):
        assert_rel_close(gt.numpy(), w.numpy(), 1e-5)


def test_cpu_output_keeps_the_graph_and_counts_no_launches():
    """The repair: under grad the wrapper's output carries a grad_fn (a CUDA
    result written through ctypes would not), and CPU runs launch nothing."""
    a = block_args(s=24)
    leaves = [t.clone().requires_grad_(True) for t in torch_block_args(a, torch.float32)]
    before = (tfb.launches, tfb.bwd_launches)
    out = tfb.fused_mlp_grn(*leaves)
    assert isinstance(out.grad_fn.__class__, type) and "FusedMlpGrn" in type(out.grad_fn).__name__
    out.sum().backward()
    assert all(t.grad is not None for t in leaves)
    assert (tfb.launches, tfb.bwd_launches) == before
    with torch.no_grad():
        assert tfb.fused_mlp_grn(*leaves).grad_fn is None
