"""Shared helpers for the ``viscy_tpu_torch`` tests: seeded numpy inputs and
parameters handed to both packages, and the relative-error checks the
port's tolerances are stated in. Imports no JAX at module level, so the
card-only tests can use it where JAX is not installed."""

from __future__ import annotations

import math
import os
from collections.abc import Mapping

import numpy as np
import torch


def _share_the_cores() -> None:
    """Under pytest-xdist every worker process would otherwise start one
    torch intra-op thread per core: six workers on eight cores run 48
    spinning OpenMP threads, and the port's CPU tests slow down several
    times over. Each worker takes its share of the cores instead. (Every
    worker collects every test file, so this runs in all of them.)"""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if workers > 1:
        cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count() or 1
        torch.set_num_threads(max(1, cores // workers))


_share_the_cores()

# narrow stand-in for the flagship FCMAE-UNeXt2: same structure (4 stages,
# 15-deep stem folding c*3+d, 1->2 channels, two decoder blocks per stage)
NARROW = dict(
    in_channels=1,
    out_channels=2,
    encoder_blocks=(1, 1, 2, 1),
    dims=(24, 48, 96, 192),
    stem_kernel_size=(5, 4, 4),
    in_stack_depth=15,
    decoder_conv_blocks=2,
    pretraining=False,
)


def block_args(b=2, s=96, c=16, m=48, seed=0) -> dict:
    """Seeded inputs of one fused MLP+GRN block, weights in flax layout
    (``w1`` (C, M), ``w2`` (M, C)); GRN gamma/beta and LN scale away from
    their identity values so a broken statistics pass shows."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x=rng.normal(0, 1, (b, s, c)).astype(f32),
        shortcut=rng.normal(0, 1, (b, s, c)).astype(f32),
        ln_scale=rng.normal(1, 0.1, (c,)).astype(f32),
        ln_bias=rng.normal(0, 0.1, (c,)).astype(f32),
        w1=(rng.normal(0, 1, (c, m)) / math.sqrt(c)).astype(f32),
        b1=rng.normal(0, 0.02, (m,)).astype(f32),
        grn_gamma=rng.normal(0.5, 0.2, (m,)).astype(f32),
        grn_beta=rng.normal(0, 0.05, (m,)).astype(f32),
        w2=(rng.normal(0, 1, (m, c)) / math.sqrt(m)).astype(f32),
        b2=rng.normal(0, 0.02, (c,)).astype(f32),
        mask=(rng.random((b, s)) > 0.4).astype(f32),
    )


def torch_block_args(a: dict, dtype, device="cpu") -> tuple:
    """``block_args`` as the port's ``fused_mlp_grn`` takes them: activations
    in ``dtype``, float32 parameters, weights in torch layout (out, in)."""
    act = lambda v: torch.from_numpy(v).to(device=device, dtype=dtype)
    par = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return (
        act(a["x"]), act(a["shortcut"]),
        par(a["ln_scale"]), par(a["ln_bias"]),
        par(a["w1"].T), par(a["b1"]),
        par(a["grn_gamma"]), par(a["grn_beta"]),
        par(a["w2"].T), par(a["b2"]),
    )


def seeded_params(tree, seed: int):
    """Replace every leaf of a flax params tree (arrays, or the shape
    structs of ``jax.eval_shape``) with numpy draws from ``seed``: kernels
    ~ N(0, 1/fan_in), biases ~ N(0, 0.02), LayerNorm scales ~ N(1, 0.1),
    GRN gamma/beta non-zero."""
    rng = np.random.default_rng(seed)

    def draw(name: str, shape: tuple) -> np.ndarray:
        if name == "kernel":
            std = 1.0 / math.sqrt(max(1, math.prod(shape[:-1])))
            return rng.normal(0.0, std, shape)
        if name == "scale":
            return rng.normal(1.0, 0.1, shape)
        if name == "gamma":
            return rng.normal(0.0, 0.5, shape)
        if name == "beta":
            return rng.normal(0.0, 0.1, shape)
        return rng.normal(0.0, 0.02, shape)

    def walk(node):
        return {
            k: walk(v) if isinstance(v, Mapping) else draw(k, tuple(v.shape)).astype(np.float32)
            for k, v in sorted(node.items())
        }

    return walk(tree)


def flax_params(module, seed: int, *args):
    """Seeded numpy params for ``module`` applied to ``args`` (shapes from
    ``jax.eval_shape``: nothing is initialized or compiled)."""
    import jax

    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]
    return seeded_params(shapes, seed)


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want| / range(want), Pearson r), both in float64."""
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    err = np.abs(got - want).max() / max(want.max() - want.min(), 1e-30)
    r = np.corrcoef(got, want)[0, 1]
    return float(err), float(r)


def assert_rel_close(got, want, rel: float, r_min: float | None = None) -> None:
    assert np.shape(got) == np.shape(want), (np.shape(got), np.shape(want))
    assert np.isfinite(np.asarray(got, np.float64)).all()
    err, r = rel_err(got, want)
    assert err <= rel, f"max|d| = {err:.3e} of range > {rel}"
    if r_min is not None:
        assert r > r_min, f"Pearson r = {r:.8f} <= {r_min}"
