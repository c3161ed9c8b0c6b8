"""The transport's ``Sampler`` and ``CELLDiff3DVS`` in the port against
viscy_tpu.

Every random draw is the JAX package's, handed to the port: the SDE's
noise and the likelihood's Rademacher probes (JAX splits its key once a
step and draws from the second half), the training step's times and noise,
and each generated window's noise (one split of the key a tile). Network
weights are numpy-seeded and carried across by
``celldiff_state_dict_from_flax``. Tolerances (float32): through the
network, max|d| <= 2e-3 of the range with Pearson r > 0.9999 (the port's
parity bound); through the smooth stand-in field, 1e-4 of the range (the
denoised and noise models divide by sigma_t^2 near the ends of the
interval, where XLA's fused float32 arithmetic and torch's part by about
1e-5 of the range).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu.apps.dynacell import celldiff_wrapper as jwrap
from viscy_tpu.models.celldiff import celldiff_net as jnet
from viscy_tpu.models.celldiff import transport as jtransport
from viscy_tpu_torch.apps.dynacell import celldiff_wrapper as twrap
from viscy_tpu_torch.models.celldiff import celldiff_net as tnet
from viscy_tpu_torch.models.celldiff import transport as ttransport
from viscy_tpu_torch.training.convert import celldiff_state_dict_from_flax

from _torch_port_helpers import assert_rel_close, flax_params

# a narrow stand-in for configs/celldiff_fit.yml's net_config
NET = dict(in_channels=1, out_channels=1, dims=(8, 16), num_res_block=(1,), hidden_size=32, num_heads=2,
           dim_head=16, num_hidden_layers=1, patch_size=2)
SHAPE = (2, 1, 4, 8, 8)
FIELD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_tf32():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _field(x, t):
    """A smooth nonlinear stand-in for a network's output."""
    mod = jnp if isinstance(x, jnp.ndarray) else torch
    t = t.reshape((-1,) + (1,) * (x.ndim - 1))
    return mod.tanh(x) * (1.0 - t) + 0.3 * mod.sin(3.0 * x) * t + 0.1


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(got, want, rel):
    assert_rel_close(_np(got), _np(want), rel, 0.9999)


def _key_draws(key, n: int, shape, kind: str) -> np.ndarray:
    """The JAX sampler's per-step draws: ``k, sub = split(k)`` then a normal
    or Rademacher draw from ``sub``."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        if kind == "normal":
            out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
        else:
            out.append(np.asarray(jax.random.randint(sub, shape, 0, 2).astype(jnp.float32) * 2 - 1))
    return np.stack(out)


TRANSPORTS = [("Linear", "velocity"), ("GVP", "score"), ("VP", "noise"), ("Linear", "denoised")]


@pytest.mark.parametrize("path,pred", TRANSPORTS)
@pytest.mark.parametrize("method", ["euler", "heun", "rk4", "dopri5"])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_sample_ode_matches_jax(path, pred, method, reverse):
    """Each ODE method, forward and reversed, on four transports (times in
    the input's dtype, ``dopri5`` as RK4)."""
    kw = dict(path_type=path, prediction=pred)
    jtr, ttr = jtransport.create_transport(**kw), ttransport.create_transport(**kw)
    x0 = _x((2, 1, 2, 4, 4), 1)
    jsample = jtransport.Sampler(jtr).sample_ode(sampling_method=method, num_steps=5, reverse=reverse)
    tsample = ttransport.Sampler(ttr).sample_ode(sampling_method=method, num_steps=5, reverse=reverse)
    want = jax.jit(lambda a: jsample(a, _field))(jnp.asarray(x0))
    _close(tsample(torch.from_numpy(x0), _field), want, FIELD_TOL)


SDE_CASES = [(m, last, form) for m in ("Euler", "Heun") for last in (None, "Mean", "Tweedie", "Euler")
             for form in ("SBDM", "sigma")] + [("Euler", "Mean", f) for f in
                                                ("constant", "linear", "decreasing", "increasing-decreasing")]


@pytest.mark.parametrize("method,last,form", SDE_CASES)
def test_sample_sde_matches_jax_with_its_noise(method, last, form):
    """Euler and Heun with every last step and diffusion form, on a score
    model (GVP path, eps 1e-3, so every last step and form stays finite),
    from the noise the JAX sampler drew."""
    jtr, ttr = (m.create_transport("GVP", "score") for m in (jtransport, ttransport))
    kw = dict(sampling_method=method, diffusion_form=form, diffusion_norm=0.7, last_step=last,
              last_step_size=0.05, num_steps=4)
    x0 = _x((2, 1, 2, 4, 4), 2)
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda a: jtransport.Sampler(jtr).sample_sde(**kw)(a, _field, key))(jnp.asarray(x0))
    noise = torch.from_numpy(_key_draws(key, 4, x0.shape, "normal"))
    got = ttransport.Sampler(ttr).sample_sde(**kw)(torch.from_numpy(x0), _field, noise=noise)
    _close(got, want, FIELD_TOL)


@pytest.mark.parametrize("path,pred", [("Linear", "velocity"), ("GVP", "score"), ("VP", "velocity")])
def test_ode_likelihood_matches_jax_with_its_probes(path, pred):
    """``logp`` (float32) and ``z``, the divergence from the JAX sampler's
    Rademacher probes (one VJP here against JAX's ``jvp``)."""
    jtr, ttr = (m.create_transport(path, pred) for m in (jtransport, ttransport))
    x = _x((3, 1, 2, 4, 4), 4)
    key = jax.random.PRNGKey(5)
    jlogp, jz = jax.jit(lambda a: jtransport.Sampler(jtr).sample_ode_likelihood(num_steps=6)(a, _field, key))(
        jnp.asarray(x))
    probes = torch.from_numpy(_key_draws(key, 6, x.shape, "rademacher"))
    logp, z = ttransport.Sampler(ttr).sample_ode_likelihood(num_steps=6)(torch.from_numpy(x), _field, probes=probes)
    assert logp.dtype == torch.float32 and logp.shape == (3,)
    _close(z, jz, FIELD_TOL)
    _close(logp, jlogp, FIELD_TOL)


def test_sampler_draws_from_a_generator_and_refuses_bad_arguments():
    s = ttransport.Sampler(ttransport.create_transport())
    x = torch.from_numpy(_x((2, 1, 2, 4, 4), 6))
    g = lambda: torch.Generator().manual_seed(7)
    a = s.sample_sde(num_steps=3)(x, _field, g())
    assert torch.equal(a, s.sample_sde(num_steps=3)(x, _field, g())) and bool(torch.isfinite(a).all())
    logp, _ = s.sample_ode_likelihood(num_steps=2)(x, _field, g())
    assert bool(torch.isfinite(logp).all())
    with pytest.raises(ValueError, match="Generator"):
        s.sample_sde(num_steps=3)(x, _field)
    with pytest.raises(ValueError, match="ODE sampling method"):
        s.sample_ode(sampling_method="midpoint")
    with pytest.raises(ValueError, match="SDE sampling method"):
        s.sample_sde(sampling_method="euler")
    with pytest.raises(NotImplementedError):
        s.sample_sde(last_step="Median")


# -- through the network ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def net():
    """The narrow CELLDiffNet in both packages with the same seeded weights."""
    x, cond = _x(SHAPE, 10), _x(SHAPE, 11)
    jmod = jnet.CELLDiffNet(**NET)
    params = flax_params(jmod, 12, jnp.asarray(x), jnp.asarray(cond), jnp.zeros((SHAPE[0],)))
    tmod = tnet.CELLDiffNet(**NET, generator=torch.Generator().manual_seed(0)).eval()
    tmod.load_state_dict(celldiff_state_dict_from_flax(params, NET["patch_size"]), strict=True)
    return jmod, {"params": jax.tree_util.tree_map(jnp.asarray, params)}, tmod, cond


def test_sampler_methods_through_the_network_match_jax(net):
    """RK4 and reversed Heun, SDE Euler (Mean) and Heun (Tweedie), and the
    likelihood, each on the narrow CELLDiffNet conditioned on a source."""
    jmod, variables, tmod, cond = net
    jfn = lambda a, t: jmod.apply(variables, a, jnp.asarray(cond), t)
    tfn = lambda a, t: tmod(a, torch.from_numpy(cond), t)
    jtr, ttr = (m.create_transport() for m in (jtransport, ttransport))
    js, ts = jtransport.Sampler(jtr), ttransport.Sampler(ttr)
    x0 = _x(SHAPE, 13)
    key = jax.random.PRNGKey(14)
    with torch.no_grad():
        for kw in (dict(sampling_method="rk4", num_steps=2), dict(sampling_method="heun", num_steps=2,
                                                                   reverse=True)):
            want = jax.jit(lambda a: js.sample_ode(**kw)(a, jfn))(jnp.asarray(x0))
            _close(ts.sample_ode(**kw)(torch.from_numpy(x0), tfn), want, 2e-3)
        for kw in (dict(sampling_method="Euler", last_step="Mean", num_steps=2),
                   dict(sampling_method="Heun", last_step="Tweedie", num_steps=2)):
            want = jax.jit(lambda a: js.sample_sde(**kw)(a, jfn, key))(jnp.asarray(x0))
            noise = torch.from_numpy(_key_draws(key, 2, SHAPE, "normal"))
            _close(ts.sample_sde(**kw)(torch.from_numpy(x0), tfn, noise=noise), want, 2e-3)
    jlogp, jz = jax.jit(lambda a: js.sample_ode_likelihood(num_steps=2)(a, jfn, key))(jnp.asarray(x0))
    probes = torch.from_numpy(_key_draws(key, 2, SHAPE, "rademacher"))
    logp, z = ts.sample_ode_likelihood(num_steps=2)(torch.from_numpy(x0), tfn, probes=probes)
    _close(z, jz, 2e-3)
    _close(logp, jlogp, 2e-3)


def _wrappers(net):
    jmod, variables, tmod, _ = net
    jw = jwrap.CELLDiff3DVS(net=jmod)
    tw = twrap.CELLDiff3DVS(net=tmod, device="cpu").eval()
    return jw, variables, tw


def test_celldiff3dvs_loss_generate_and_trajectory_match_jax(net):
    """``loss`` with the times and noise JAX drew from its key, ``generate``
    and ``generate_trajectory`` from its noise; the trajectory's first entry
    is the noise and its last equals ``generate``'s sample."""
    jw, variables, tw = _wrappers(net)
    phase, target = _x(SHAPE, 15), _x(SHAPE, 16)
    key = jax.random.PRNGKey(17)
    jt, jx0, _ = jw.transport.sample(key, jnp.asarray(target))
    want = jax.jit(jw.loss)(variables, jnp.asarray(phase), jnp.asarray(target), key)
    with torch.no_grad():
        got = tw.loss(torch.from_numpy(phase), torch.from_numpy(target), t=torch.from_numpy(np.array(jt)),
                      x0=torch.from_numpy(np.array(jx0)))
        assert abs(float(got) - float(want)) <= 2e-3 * abs(float(want))
        x0 = torch.from_numpy(np.array(jax.random.normal(key, SHAPE, jnp.float32)))
        want = jax.jit(lambda v, p, k: jw.generate(v, p, k, num_steps=3))(variables, jnp.asarray(phase), key)
        sample = tw.generate(torch.from_numpy(phase), 3, x0=x0)
        _close(sample, want, 2e-3)
        want = jax.jit(lambda v, p, k: jw.generate_trajectory(v, p, k, num_steps=3))(variables, jnp.asarray(phase),
                                                                                     key)
        traj = tw.generate_trajectory(torch.from_numpy(phase), 3, x0=x0)
    assert traj.shape == (4, *SHAPE)
    _close(traj, want, 2e-3)
    assert torch.equal(traj[0], x0) and torch.equal(traj[-1], sample)


def test_sliding_window_snaps_the_last_tile_and_matches_jax(net):
    """A (1, 1, 4, 12, 20) FOV in (4, 8, 8) tiles: origins (0, 4) in Y and
    (0, 8, 12) in X, the last tiles overlapping their neighbours and
    overwriting them, each tile from the noise of one split of JAX's key."""
    jw, variables, tw = _wrappers(net)
    phase = _x((1, 1, 4, 12, 20), 18)
    key = jax.random.PRNGKey(19)
    assert twrap.tile_origins(12, 8) == [0, 4] and twrap.tile_origins(20, 8) == [0, 8, 12]
    want = jw.generate_sliding_window(variables, phase, key, num_steps=2, patch_size=(4, 8, 8))
    x0s, k = [], key
    for _ in range(6):
        k, sub = jax.random.split(k)
        x0s.append(torch.from_numpy(np.array(jax.random.normal(sub, (1, 1, 4, 8, 8), jnp.float32))))
    with torch.no_grad():
        got = tw.generate_sliding_window(torch.from_numpy(phase), 2, (4, 8, 8), x0s=x0s)
        _close(got, want, 2e-3)
        # the last tile is generate() on its crop from its own noise
        last = tw.generate(torch.from_numpy(phase[..., 4:12, 12:20]), 2, x0=x0s[-1])
    assert torch.equal(got[..., 4:12, 12:20], last)
    drawn = tw.generate_sliding_window(torch.from_numpy(phase), 1, (4, 8, 8), torch.Generator().manual_seed(0))
    assert drawn.shape == phase.shape and bool(torch.isfinite(drawn).all())


def test_celldiff3dvs_builds_from_a_config_dict():
    """``net`` as the config's dict (lists become tuples), on the CPU; the
    default device is the card."""
    cfg = {k: list(v) if isinstance(v, tuple) else v for k, v in NET.items()}
    tw = twrap.CELLDiff3DVS(net=cfg, device="cpu")
    assert tw.net.input_spatial_size is None and tw.net.out_channels == 1
    with pytest.raises(ValueError, match="patch_size"):
        tw.generate_sliding_window(torch.zeros(SHAPE), 1, generator=torch.Generator())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            twrap.CELLDiff3DVS(net=cfg)
