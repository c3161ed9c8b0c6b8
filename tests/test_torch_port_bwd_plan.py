"""The backward kernels' host-side plan (``fused_block.bwd_plan``), on the CPU.

The kernels take their grids and partial shapes from this plan, so it has to
cover every row once: each front-product row tile lies inside one sample and
the tiles of a sample cover its rows exactly once; the split-K ranges of the
weight-gradient products partition the B S rows, each a whole number of K
steps; the row kernels' blocks cover every row once. The block-to-rows
arithmetic below is the kernels' own (``front_kernel``, ``gemm_kernel``,
``prep_kernel`` / ``lnb_kernel`` in ``csrc/fused_mlp_grn.cu``).
"""

import numpy as np
import pytest
import torch

from viscy_tpu_torch.ops import fused_block as tfb

# the flagship train step's five (S, C, M) at batch 16, the card tests'
# shapes, and edge cases (one row, S one past a tile, a sample under a tile)
SHAPES = [
    (16, 9216, 480, 1920), (16, 9216, 96, 384), (16, 2304, 192, 768), (16, 576, 384, 1536),
    (16, 144, 768, 3072), (3, 70, 40, 160), (3, 33, 480, 1920), (5, 9, 96, 384), (1, 1, 8, 32),
    (2, 129, 16, 64), (49, 6400, 480, 1920),
]


@pytest.mark.parametrize("bsz,s,c,m", SHAPES)
@pytest.mark.parametrize("n_sm", [132, 7])
def test_plan_covers_every_row_once(bsz, s, c, m, n_sm):
    plan = tfb.bwd_plan(bsz, s, c, m, n_sm)
    tile = tfb.BWD_ROW_TILE
    # front products: block row y -> sample y // tps, rows of tile y % tps
    assert plan.tiles_per_sample == -(-s // tile) and plan.row_tiles == bsz * plan.tiles_per_sample
    hits = np.zeros(bsz * s, dtype=np.int64)
    for y in range(plan.row_tiles):
        b, t = divmod(y, plan.tiles_per_sample)
        rows = min(tile, s - t * tile)
        assert 0 < rows <= tile
        r0 = b * s + t * tile
        assert r0 // s == (r0 + rows - 1) // s == b  # inside one sample
        hits[r0:r0 + rows] += 1
    assert (hits == 1).all()
    # weight-gradient products: split z covers [z * kps, min(K, (z + 1) * kps))
    k, kps = bsz * s, plan.k_per_split
    assert kps % tfb.BWD_K_STEP == 0 and 1 <= plan.splits <= 65535
    starts = [z * kps for z in range(plan.splits)]
    assert starts[-1] < k <= plan.splits * kps  # no empty split, nothing left over
    if plan.splits > 1:
        assert kps >= tfb.BWD_MIN_SPLIT_ROWS
    # row kernels: block i covers rows [i * LN_ROWS, ...)
    assert (plan.ln_blocks - 1) * tfb.BWD_LN_ROWS < k <= plan.ln_blocks * tfb.BWD_LN_ROWS


@pytest.mark.parametrize("tiles", [1, 3, 60, 144, 132, 264, 1000])
def test_split_count_fills_the_card(tiles):
    """About two blocks per SM or more where the rows allow (whole K steps per
    split may drop a few), the last wave at least as full as with the fewest
    splits that reach that, and never more than eight blocks per SM."""
    n_sm, k = 132, 16 * 9216
    splits, per = tfb._split_k(k, tiles, n_sm)
    blocks = tiles * splits
    assert blocks >= 0.9 * min(2 * n_sm, tiles * (k // tfb.BWD_MIN_SPLIT_ROWS))
    assert splits == 1 or blocks <= 8 * n_sm + tiles

    def fill(s):
        return tiles * s / (-(-tiles * s // n_sm) * n_sm)

    least = min(max(1, -(-2 * n_sm // tiles)), k // tfb.BWD_MIN_SPLIT_ROWS)
    per_least = -(-(-(-k // least)) // tfb.BWD_K_STEP) * tfb.BWD_K_STEP
    assert fill(splits) >= fill(-(-k // per_least)) - 1e-12


def test_partials_reduce_to_per_sample_sums():
    """The wrapper's fixed-order reduction of the per-row-tile partials
    (``view(B, tiles_per_sample, M).sum(1)``) gives each sample's own sum."""
    bsz, s, m = 3, 300, 5
    plan = tfb.bwd_plan(bsz, s, 16, m, 132)
    vals = torch.from_numpy(np.random.default_rng(0).normal(size=(bsz * s, m)))
    part = torch.zeros((plan.row_tiles, m), dtype=vals.dtype)
    for y in range(plan.row_tiles):
        b, t = divmod(y, plan.tiles_per_sample)
        r0 = b * s + t * tfb.BWD_ROW_TILE
        part[y] = vals[r0:min(r0 + tfb.BWD_ROW_TILE, (b + 1) * s)].sum(0)
    got = part.view(bsz, plan.tiles_per_sample, m).sum(dim=1)
    torch.testing.assert_close(got, vals.view(bsz, s, m).sum(dim=1))
