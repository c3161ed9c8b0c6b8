"""The port's MS-SSIM, MixedLoss and AdamW + WarmupCosine against viscy_tpu.

- ``ms_ssim_25d`` / ``MixedLoss``: value and gradient (w.r.t. the
  prediction) against ``jax.grad`` on the same numpy inputs. float32: value
  to 1e-5 relative, gradient to 1e-4 of its range. bfloat16 inputs (the
  flagship's ``bf16_loss``): the math is float32 in both, but the pyramid
  is re-rounded to bf16 after each pooling and the gradient is rounded to
  bf16, so a different sum order can move a value by one bf16 ulp: value to
  1e-4 relative, gradient to 5e-3 of its range with Pearson r > 0.9999.
- AdamW + WarmupCosine: parameters after three steps with fixed gradients
  against optax, 1e-6 relative; the learning rates against the optax
  schedule at every count, 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from viscy_tpu.ops import ssim as jssim
from viscy_tpu.training.losses.mixed_loss import MixedLoss as JMixedLoss
from viscy_tpu.training.optimizers import configure_adamw_scheduler as jconfigure
from viscy_tpu_torch.ops import ssim as tssim
from viscy_tpu_torch.training.losses.mixed_loss import MixedLoss
from viscy_tpu_torch.training.optimizers import configure_adamw_scheduler

from _torch_port_helpers import assert_rel_close


def _pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.random(shape, np.float32)
    p = (0.7 * t + 0.3 * rng.random(shape, np.float32)).astype(np.float32)
    return p, t


CASES = {
    "ms_ssim": (lambda p, t: 1 - jssim.ms_ssim_25d(p, t, clamp=True),
                lambda p, t: 1 - tssim.ms_ssim_25d(p, t, clamp=True)),
    "ms_ssim-unclamped-window7": (lambda p, t: jssim.ms_ssim_25d(p, t, (7, 7)),
                                  lambda p, t: tssim.ms_ssim_25d(p, t, (7, 7))),
    "ssim": (lambda p, t: jssim.ssim_25d(p, t).sum(), lambda p, t: tssim.ssim_25d(p, t).sum()),
    "mixed": (JMixedLoss(0.5, 0.0, 0.5), MixedLoss(0.5, 0.0, 0.5)),
    "mixed-l2": (JMixedLoss(0.3, 0.4, 0.3), MixedLoss(0.3, 0.4, 0.3)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_value_and_grad_match_jax(case, dtype):
    """(2, 2, 5, 100, 92): four MS-SSIM scales (the fifth is truncated)."""
    jfn, tfn = CASES[case]
    p, t = _pair((2, 2, 5, 100, 92))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jt = jnp.asarray(t).astype(jdt)
    jval, jgrad = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(p).astype(jdt), jt)
    tp = torch.from_numpy(p).to(tdt).requires_grad_(True)
    tval = tfn(tp, torch.from_numpy(t).to(tdt))
    (tgrad,) = torch.autograd.grad(tval, tp)
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5 if f32 else 1e-4)
    assert_rel_close(tgrad.float().numpy(), np.asarray(jgrad, np.float32),
                     1e-4 if f32 else 5e-3, None if f32 else 0.9999)


def test_uniform_filter_and_pool_match_jax():
    x = np.random.default_rng(1).random((2, 1, 4, 30, 26), np.float32)
    for k in ((4, 11, 11), (1, 5, 3), (2, 30, 1)):
        np.testing.assert_allclose(tssim._uniform_filter(torch.from_numpy(x), k).numpy(),
                                   np.asarray(jssim._uniform_filter(jnp.asarray(x), k)), atol=1e-6)
    with pytest.raises(ValueError):
        tssim.ssim_25d(torch.zeros(2, 3, 4), torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        MixedLoss(0, 0, 0)


@pytest.mark.parametrize("schedule,warmup", [("WarmupCosine", 2), ("WarmupCosine", None), ("Constant", None)])
def test_adamw_schedule_matches_optax(schedule, warmup):
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(0, 1, (4, 3)).astype(np.float32), "b": rng.normal(0, 1, (3,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 0.1, v.shape).astype(np.float32) for k, v in params.items()} for _ in range(3)]
    total = 5
    tx, sched = jconfigure(lr=1e-2, schedule=schedule, total_steps=total, warmup_steps=warmup)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt, scheduler, tsched = configure_adamw_scheduler(
        list(tp.values()), lr=1e-2, schedule=schedule, total_steps=total, warmup_steps=warmup
    )
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        scheduler.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    for count in range(total + 2):
        # optax evaluates the schedule in float32
        np.testing.assert_allclose(tsched(count), float(sched(count)), rtol=1e-6, atol=1e-8)
