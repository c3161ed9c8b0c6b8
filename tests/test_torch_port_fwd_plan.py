"""The forward kernels' host-side plan (``fused_block.fwd_plan``), on the CPU.

The kernels take their grids and the partials' shape from this plan, so it
has to cover every row once: each pass-A row tile lies inside one sample
and the tiles of a sample cover its rows exactly once, the hidden tiles
cover M, pass B's row tiles cover the B S rows and its column tiles C. The
per-row-tile partials of ``(v * mask)^2`` must reduce, through the
wrapper's own reduction (``FwdPlan.sample_sums``), to the per-sample ``ss``
of ``_reference_ss`` and of the JAX package's stats pass. The
block-to-rows arithmetic below is the kernels' own (``stats_kernel``,
``apply_kernel`` and the prep in ``csrc/fused_mlp_grn.cu``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu.ops.pallas import fused_block as jfb
from viscy_tpu_torch.ops import fused_block as tfb

from _torch_port_helpers import assert_rel_close, block_args, torch_block_args

# (B, S, C, M): the backward's edge case (a sample under one row tile), the
# flagship's five shapes at serving (B = 49, tile 320) with the deepest
# stage's ragged training shape, and edges (odd M, unaligned C, one row,
# one row past a tile)
SHAPES = [
    (5, 9, 96, 384),
    (49, 6400, 96, 384), (49, 1600, 192, 768), (49, 400, 384, 1536), (49, 100, 768, 3072),
    (49, 6400, 480, 1920), (16, 144, 768, 3072),
    (3, 21, 38, 151), (1, 1, 8, 32), (2, 129, 16, 64),
]


def _sample_tile_rows(plan, s, y):
    """First row and row count of pass-A row tile ``y`` (``stats_kernel``)."""
    b, t = divmod(y, plan.tiles_per_sample)
    tile = tfb.FWD_ROW_TILE
    return b * s + t * tile, min(tile, s - t * tile)


@pytest.mark.parametrize("bsz,s,c,m", SHAPES)
def test_plan_covers_every_row_once(bsz, s, c, m):
    plan = tfb.fwd_plan(bsz, s, c, m, 132)
    n = bsz * s
    assert plan.tiles_per_sample == -(-s // tfb.FWD_ROW_TILE)
    assert plan.row_tiles == bsz * plan.tiles_per_sample
    hits = np.zeros(n, dtype=np.int64)
    for y in range(plan.row_tiles):
        r0, rows = _sample_tile_rows(plan, s, y)
        assert 0 < rows <= tfb.FWD_ROW_TILE
        assert r0 // s == (r0 + rows - 1) // s == y // plan.tiles_per_sample  # inside one sample
        hits[r0:r0 + rows] += 1
    assert (hits == 1).all()
    # pass A's hidden tiles, pass B's row and column tiles, the prep's blocks:
    # tile i covers [i * width, min(extent, (i + 1) * width)), none empty
    for tiles, width, extent in (
        (plan.hidden_tiles, tfb.FWD_HIDDEN_TILE, m),
        (plan.apply_row_tiles, tfb.FWD_APPLY_ROWS, n),
        (plan.apply_col_tiles, plan.apply_cols, c),
        (plan.ln_blocks, tfb.BWD_LN_ROWS, n),
    ):
        assert (tiles - 1) * width < extent <= tiles * width
    assert plan.apply_cols in tfb.FWD_APPLY_COLS
    assert max(plan.row_tiles, plan.apply_row_tiles) <= tfb.MAX_ROW_TILES
    assert plan.ln_shape == (n, c) and plan.v_shape == (n, m)


@pytest.mark.parametrize(
    "bsz,s,c,want",
    [
        (49, 6400, 480, 256),  # the serving forward's largest call: half the y transforms
        (16, 9216, 480, 256),
        (16, 144, 768, 128),  # 36 row tiles: 256-wide tiles would leave SMs idle
        (49, 6400, 96, 128),  # a 256-wide tile would be mostly padding
        (16, 2304, 192, 256),
    ],
)
def test_apply_width_fills_the_card(bsz, s, c, want):
    """Pass B's width: waves of two blocks per SM weighted by each block's
    work; the wider on a tie."""
    assert tfb.fwd_plan(bsz, s, c, 4 * c, 132).apply_cols == want


def _masked_v_squares(a, bsz, s, m, masked):
    x, _, ln_s, ln_b, w1, b1, *_ = torch_block_args(a, torch.float32)
    mask = torch.from_numpy(a["mask"]) if masked else None
    v = tfb._ln_fc1_gelu(x, ln_s, ln_b, w1, b1, 1e-6)[0]
    vm = v if mask is None else v * mask[..., None]
    return (vm * vm).reshape(bsz * s, m), (x, ln_s, ln_b, w1, b1, mask)


def _partials(plan, s, sq):
    """Pass A's (row_tiles, M) partials: each tile's column sums."""
    part = torch.empty((plan.row_tiles, sq.shape[1]), dtype=sq.dtype)
    for y in range(plan.row_tiles):
        r0, rows = _sample_tile_rows(plan, s, y)
        part[y] = sq[r0:r0 + rows].sum(dim=0)
    return part


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("bsz,s,c,m", [(5, 9, 96, 384), (49, 100, 768, 3072)])
def test_partials_reduce_to_reference_ss(bsz, s, c, m, masked):
    a = block_args(b=bsz, s=s, c=c, m=m, seed=3)
    sq, (x, ln_s, ln_b, w1, b1, mask) = _masked_v_squares(a, bsz, s, m, masked)
    plan = tfb.fwd_plan(bsz, s, c, m, 132)
    got = plan.sample_sums(_partials(plan, s, sq))
    want = tfb._reference_ss(x, ln_s, ln_b, w1, b1, mask, 1e-6)
    assert got.shape == (bsz, m)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("bsz,s,c,m,cap", [(3, 72, 40, 160, 24), (5, 16, 96, 384, 8)])
def test_partials_reduce_to_jax_stats_pass(bsz, s, c, m, cap, masked):
    """The same sums against the JAX stats pass (Pallas, interpret mode,
    several S tiles carried across grid steps), f32; 1e-5 of the range
    (sum order and erf only)."""
    a = block_args(b=bsz, s=s, c=c, m=m, seed=4)
    sq, _ = _masked_v_squares(a, bsz, s, m, masked)
    plan = tfb.fwd_plan(bsz, s, c, m, 132)
    got = plan.sample_sums(_partials(plan, s, sq))
    args = [jnp.asarray(a[k]) for k in ("x", "shortcut")]
    mask = jnp.asarray(a["mask"]) if masked else None
    params = [jnp.asarray(a[k]) for k in ("ln_scale", "ln_bias", "w1", "b1", "grn_gamma", "grn_beta", "w2", "b2")]
    _, res = jfb._fwd((1e-6, 1e-6, cap, 256, True), *args, mask, *params)
    assert_rel_close(got.numpy(), np.asarray(res[-1]), 1e-5)
