"""FCMAE masked pretraining and the encoder-only fine-tune in the port
against viscy_tpu.

Inputs are numpy-seeded; weights are seeded flax trees carried across by
the weight bridge (``fcmae_state_dict_from_flax``). JAX threefry and torch
Philox draw different numbers, so the token masks JAX drew (read off its
full-resolution mask at the mask grid) and its drop-path keep masks (read
off its ``DropPath`` outputs) are handed to the port. Every mask grid is at
least 2 x 2 cells, so a ratio of 0.5 masks something. The block, stage and
encoder run JAX's fused Pallas kernel in interpret mode; the whole model,
the gradients and the trainer run JAX's unfused modules. Tolerances
(float32, TF32 off): masks bit for bit; outputs and every gradient within
2e-3 of the range with Pearson r > 0.9999 (the repo's f32 bound) or
tighter where stated; losses to 1e-5 relative.
"""

from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from viscy_tpu.apps.cytoland import engine as jengine
from viscy_tpu.models.components import stems as jstems
from viscy_tpu.models.components.blocks import DropPath as JDropPath
from viscy_tpu.models.unet import fcmae as jfcmae
from viscy_tpu.ops.pallas import fused_block as jfb
from viscy_tpu.training.trainer import Trainer as JTrainer
from viscy_tpu import transforms as J
from viscy_tpu_torch import transforms as T
from viscy_tpu_torch.apps.cytoland import engine as tengine
from viscy_tpu_torch.models.components.stems import MaskedAdaptiveProjection, upsample_mask_2d
from viscy_tpu_torch.models.unet import fcmae as tfcmae
from viscy_tpu_torch.ops import fused_block as tfb
from viscy_tpu_torch.training import cli
from viscy_tpu_torch.training.convert import fcmae_state_dict_from_flax, load_flax_params
from viscy_tpu_torch.training.trainer import Trainer
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

from _torch_port_helpers import assert_rel_close, flax_params

ROOT = Path(__file__).resolve().parents[1]
# a narrow pretraining FCMAE (3-D stem, total stride 32): 64^2 inputs give
# a 2 x 2 mask grid
TINY = dict(
    in_channels=1,
    out_channels=1,
    encoder_blocks=(1, 1, 2, 1),
    dims=(16, 32, 64, 128),
    stem_kernel_size=(5, 4, 4),
    in_stack_depth=5,
    decoder_conv_blocks=1,
    pretraining=True,
)
STRIDE = 32
UNBRIDGED = {"encoder.stem.conv2d.weight", "encoder.stem.conv2d.bias"}


@pytest.fixture(autouse=True)
def _no_tf32():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


@pytest.fixture
def interpret():
    jfb.FORCE_INTERPRET = True
    yield
    jfb.FORCE_INTERPRET = False


def _close(got: torch.Tensor, want, rel=2e-3) -> None:
    assert_rel_close(got.detach().numpy(), np.asarray(want), rel, 0.9999)


def _jit_apply(module: nn.Module, params: dict, *args, rngs=None, **static):
    """``module.apply`` compiled as one program (far quicker on the CPU than
    op by op, the fused kernel's interpret mode included); ``static``
    keywords are fixed."""
    call = lambda p, r, *a: module.apply({"params": p}, *a, rngs=r, **static)
    return jax.jit(call)(jax.tree_util.tree_map(jnp.asarray, params), rngs, *args)


def _load_part(module: torch.nn.Module, tree: dict, wrap, prefix: str) -> None:
    """Load the flax subtree ``tree`` of a model part into the port's part:
    ``wrap`` places it in a whole-model tree, ``prefix`` is the part's name
    in the port's state dict."""
    state = module.state_dict()
    for key, value in fcmae_state_dict_from_flax(wrap(tree)).items():
        name = key[len(prefix):]
        assert state[name].shape == value.shape, name
        state[name] = value
    module.load_state_dict(state)


def _low_res(full_mask) -> torch.Tensor:
    """The (B, 1, H/32, W/32) mask grid of a full-resolution JAX mask."""
    return torch.from_numpy(np.asarray(full_mask)[:, :, ::STRIDE, ::STRIDE].copy())


def _source(n=2, seed=0, yx=(64, 64)):
    return np.random.default_rng(seed).random((n, 1, 5, *yx), np.float32)


# -- masks -----------------------------------------------------------------------


@pytest.mark.parametrize("hw,ratio", [((64, 64), 0.5), ((256, 192), 0.6), ((64, 96), 0.75)])
def test_generate_mask_masks_exactly_its_share_per_sample(hw, ratio):
    """Shape, exactly ``int(numel * ratio)`` masked cells in every sample (as
    JAX's), one draw per generator seed, and no global RNG touched."""
    before = torch.random.get_rng_state()
    a = tfcmae.generate_mask(torch.Generator().manual_seed(3), 6, hw, STRIDE, ratio)
    b = tfcmae.generate_mask(torch.Generator().manual_seed(3), 6, hw, STRIDE, ratio)
    c = tfcmae.generate_mask(torch.Generator().manual_seed(4), 6, hw, STRIDE, ratio)
    j = jfcmae.generate_mask(jax.random.PRNGKey(0), 6, hw, STRIDE, ratio)
    numel = (hw[0] // STRIDE) * (hw[1] // STRIDE)
    assert a.shape == tuple(j.shape) == (6, 1, hw[0] // STRIDE, hw[1] // STRIDE) and a.dtype == torch.bool
    assert a.flatten(1).sum(1).tolist() == [int(numel * ratio)] * 6
    assert np.asarray(j).reshape(6, -1).sum(1).tolist() == [int(numel * ratio)] * 6
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(torch.random.get_rng_state(), before)


def test_upsample_mask_2d_matches_jax():
    m = np.random.default_rng(1).random((3, 1, 2, 3)) > 0.5
    got = upsample_mask_2d(torch.from_numpy(m), (8, 12))
    assert np.array_equal(got.numpy(), np.asarray(jstems.upsample_mask_2d(jnp.asarray(m), (8, 12))))
    assert torch.equal(upsample_mask_2d(torch.from_numpy(m), (2, 3)), torch.from_numpy(m[:, 0]))
    with pytest.raises(ValueError, match="divisible"):
        upsample_mask_2d(torch.from_numpy(m), (8, 13))


# -- model parts against JAX ------------------------------------------------------


@pytest.mark.parametrize("depth,kernel", [(5, (5, 4, 4)), (1, (1, 2, 2))], ids=["3d", "2d"])
def test_masked_stem_matches_jax(depth, kernel):
    """Dense conv, LayerNorm, then masked positions set to 0 with ``where``:
    a non-finite input patch under the mask still gives exact zeros."""
    jmod = jstems.MaskedAdaptiveProjection(1, 16, kernel_size_2d=kernel[1:], kernel_depth=kernel[0],
                                           in_stack_depth=depth)
    x = np.random.default_rng(2).random((2, 1, depth, 32, 32), np.float32)
    unmasked = np.random.default_rng(3).random((2, 1, 4, 4)) > 0.5
    cell = np.argwhere(~unmasked[0, 0])[0] * (32 // 4)  # a masked cell of sample 0
    x[0, 0, :, cell[0], cell[1]] = np.inf
    params = flax_params(jmod, 5, jnp.zeros_like(x), jnp.asarray(unmasked))
    want = _jit_apply(jmod, params, jnp.asarray(x), jnp.asarray(unmasked))
    tmod = MaskedAdaptiveProjection(1, 16, torch.Generator().manual_seed(0), kernel_size_2d=kernel[1:],
                                    kernel_depth=kernel[0], in_stack_depth=depth)
    _load_part(tmod, params, lambda t: {"encoder": {"stem": t}}, "encoder.stem.")
    got = tmod(torch.from_numpy(x), torch.from_numpy(unmasked)).detach()
    keep = upsample_mask_2d(torch.from_numpy(unmasked), got.shape[1:3])
    assert torch.all(got[~keep] == 0) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_masked_block_and_stage_match_jax_fused(interpret):
    """A masked block (the fused kernel with the mask) and a masked stage
    with its downsample, against JAX's ``fused_mlp=True`` in interpret mode."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32)
    keep = rng.random((2, 8, 8)) > 0.4
    jblock = jfcmae.MaskedConvNeXtV2Block(16, fused_mlp=True)
    params = flax_params(jblock, 6, jnp.asarray(x), jnp.asarray(keep))
    want = _jit_apply(jblock, params, jnp.asarray(x), jnp.asarray(keep))
    tblock = tfcmae.MaskedConvNeXtV2Block(16, torch.Generator().manual_seed(0))
    _load_part(tblock, params, lambda t: {"encoder": {"stage0": {"block0": t}}}, "encoder.stages.0.blocks.0.")
    _close(tblock(torch.from_numpy(x), mask2d=torch.from_numpy(keep)), want)

    y = rng.normal(0, 1, (2, 16, 16, 16)).astype(np.float32)
    unmasked = rng.random((2, 1, 4, 4)) > 0.5
    jstage = jfcmae.MaskedConvNeXtV2Stage(16, 32, stride=2, num_blocks=2, fused_mlp=True)
    params = flax_params(jstage, 7, jnp.asarray(y), jnp.asarray(unmasked))
    want = _jit_apply(jstage, params, jnp.asarray(y), jnp.asarray(unmasked))
    tstage = tfcmae.MaskedConvNeXtV2Stage(16, 32, torch.Generator().manual_seed(0), stride=2, num_blocks=2)
    _load_part(tstage, params, lambda t: {"encoder": {"stage1": t}}, "encoder.stages.1.")
    _close(tstage(torch.from_numpy(y), unmasked=torch.from_numpy(unmasked)), want)


def test_masked_encoder_matches_jax_fused(interpret):
    """The encoder draws its mask at the total stride (2 x 2 cells at 64^2,
    one of the four masked at ratio 0.5... two here, ``int(4 * 0.5)``);
    the port takes JAX's draw and returns the same full-resolution mask."""
    cfg = dict(in_channels=1, stage_blocks=(1, 1, 1, 1), dims=(8, 16, 32, 64), stem_kernel_size=(5, 4, 4),
               in_stack_depth=5, fused_mlp=True)
    jenc = jfcmae.MaskedMultiscaleEncoder(**cfg)
    x = _source(seed=8)
    params = flax_params(jenc, 9, jnp.asarray(x))
    feats, full = _jit_apply(jenc, params, jnp.asarray(x), rngs={"mask": jax.random.PRNGKey(1)}, mask_ratio=0.5)
    assert np.asarray(full).mean() == 0.5
    tenc = tfcmae.MaskedMultiscaleEncoder(1, torch.Generator().manual_seed(0), stage_blocks=(1, 1, 1, 1),
                                          dims=(8, 16, 32, 64))
    _load_part(tenc, params, lambda t: {"encoder": t}, "encoder.")
    got, got_mask = tenc(torch.from_numpy(x), mask=_low_res(full))
    assert np.array_equal(got_mask.numpy(), np.asarray(full))
    for g, w in zip(got, feats):
        _close(g, w)


@pytest.fixture(scope="module")
def params():
    return flax_params(jfcmae.FullyConvolutionalMAE(**TINY), 21, jnp.zeros((1, 1, 5, 64, 64)))


def _jax_engine(params, **cfg):
    jmod = jengine.FcmaeUNet(fit_mask_ratio=0.5, model_config=dict(TINY, fused_mlp=False, **cfg),
                             loss_function=jengine.MaskedMSELoss(), lr=1e-3, schedule="WarmupCosine",
                             warmup_steps=1)
    jmod.init_variables = lambda rng, batch: {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    return jmod


class _HandedMasks(tengine.FcmaeUNet):
    """The port's engine with the token masks JAX drew handed in, in order."""

    def __init__(self, masks, **kw):
        super().__init__(**kw)
        self.masks = list(masks)

    def forward_fit_fcmae(self, batch, generator=None, drop_path_masks=None, mask=None):
        return super().forward_fit_fcmae(batch, generator, drop_path_masks, self.masks.pop(0))


def _torch_engine(params, masks=(), **cfg):
    tmod = _HandedMasks(masks, fit_mask_ratio=0.5, model_config=dict(TINY, **cfg),
                        loss_function=tengine.MaskedMSELoss(), lr=1e-3, schedule="WarmupCosine", warmup_steps=1,
                        device="cpu")
    load_flax_params(tmod.model, params)
    return tmod


def test_pretraining_model_without_a_mask_is_the_supervised_model(params):
    """At ratio 0 (no mask given) the pretraining model returns ``(pred,
    None)`` with ``pred`` the supervised model's output, bit for bit; a
    ratio above 0 without a generator or a mask raises."""
    x = torch.from_numpy(_source(seed=10))
    pre, sup = tfcmae.FullyConvolutionalMAE(**TINY), tfcmae.FullyConvolutionalMAE(**dict(TINY, pretraining=False))
    load_flax_params(pre, params)
    load_flax_params(sup, params)
    with torch.no_grad():
        pred, mask = pre(x)
        assert mask is None and torch.equal(pred, sup(x))
        with pytest.raises(ValueError, match="mask_generator"):
            pre(x, mask_ratio=0.5)


def test_masked_mse_loss_matches_jax():
    rng = np.random.default_rng(11)
    pred, orig = rng.normal(0, 1, (2, 2, 5, 16, 16)).astype(np.float32), rng.random((2, 2, 5, 16, 16), np.float32)
    mask = (rng.random((2, 1, 16, 16)) > 0.5).astype(np.float32)
    loss = tengine.MaskedMSELoss()
    for m in (mask, np.zeros_like(mask)):
        want = float(jengine.MaskedMSELoss()(jnp.asarray(pred), jnp.asarray(orig), jnp.asarray(m)))
        got = float(loss(torch.from_numpy(pred), torch.from_numpy(orig), torch.from_numpy(m)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


class _Drawn(Exception):
    pass


def _jax_mask(call, monkeypatch) -> torch.Tensor:
    """The low-resolution token mask a JAX forward draws: ``call`` runs it,
    stopped right after ``generate_mask``."""
    drawn = []

    def grab(*args, **kwargs):
        drawn.append(generate(*args, **kwargs))
        raise _Drawn

    generate = jfcmae.generate_mask
    with monkeypatch.context() as m:
        m.setattr(jfcmae, "generate_mask", grab)
        with pytest.raises(_Drawn):
            call()
    return torch.from_numpy(np.asarray(drawn[0]))


def _drop_path_outputs():
    """An interceptor that collects every active ``DropPath`` output (traced
    values too) into the list it returns beside it."""
    outs = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, JDropPath) and context.module.rate > 0 and context.method_name == "__call__":
            outs.append(out)
        return out

    return record, outs


def _keep_masks(outs) -> list[torch.Tensor]:
    """Per-block (B,) keep masks from the blocks' DropPath outputs (a dropped
    sample's branch is all zeros)."""
    return [torch.from_numpy(np.asarray(o).reshape(o.shape[0], -1).any(axis=1)) for o in outs]


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_pretraining_forward_loss_and_every_gradient_match_jax(params, rate):
    """``FullyConvolutionalMAE(pretraining=True)`` through the engine at
    128 x 64 (a 4 x 2 mask grid): the prediction, the (B, 1, H, W) mask, the
    masked loss against the SOURCE (the batch's target differs and is not
    read) and every parameter gradient against ``jax.grad``, with JAX's
    token and keep masks handed in."""
    batch = {"source": _source(4, seed=12, yx=(128, 64)), "target": 2.0 + _source(4, seed=13, yx=(128, 64))}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jmod = _jax_engine(params, encoder_drop_path_rate=rate)
    rng = jax.random.PRNGKey(1)  # drops 2 of the 20 (block, sample) branches at 0.1

    def loss_fn(p, b):  # JAX's FcmaeUNet.training_loss, written out to return the forward too
        record, outs = _drop_path_outputs()
        with nn.intercept_methods(record):
            pred, target, mask = jmod.forward_fit_fcmae({"params": p}, b, rng, return_target=True)
        return jmod.loss_function(pred, target, mask.astype(jnp.float32)), (pred, mask, outs)

    (jloss, (jpred, jfull, outs)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams, jbatch)
    keeps = None
    if rate:
        keeps = _keep_masks(outs)
        flat = torch.cat(keeps)
        assert len(keeps) == sum(TINY["encoder_blocks"]) and flat.any() and not flat.all()
    tmod = _torch_engine(params, [_low_res(jfull)], encoder_drop_path_rate=rate).train()
    pred, target, mask = tmod.forward_fit_fcmae({k: torch.from_numpy(v) for k, v in batch.items()},
                                                drop_path_masks=keeps)
    assert mask.shape == (4, 1, 128, 64) and np.array_equal(mask.numpy(), np.asarray(jfull))
    assert float(mask.float().mean()) == 0.5
    _close(pred, jpred)
    assert np.array_equal(target.numpy(), batch["source"])
    loss = tmod._masked_loss(pred, target, mask)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    off_target = tengine.MaskedMSELoss()(pred.detach(), torch.from_numpy(batch["target"]), mask.float())
    assert float(off_target) > 2 * float(jloss)
    want = fcmae_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {n: p.grad for n, p in tmod.model.named_parameters()}
    assert set(got) - set(want) == UNBRIDGED
    for name, w in want.items():
        assert got[name] is not None, name
        assert_rel_close(got[name].numpy(), w.numpy(), 2e-3, 0.9999)


def test_engine_losses_match_jax(params, monkeypatch):
    """``FcmaeUNet.training_loss`` / ``validation_loss`` (the masks JAX drew
    from the same rng handed in) against JAX's, on a batch whose target is
    not its source; the validation forward draws a mask too."""
    batch = {"source": _source(2, seed=14), "target": 2.0 + _source(2, seed=15)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmod = _jax_engine(params)
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    rngs = [jax.random.PRNGKey(20), jax.random.PRNGKey(21)]
    masks = [_jax_mask(lambda: jmod.forward_fit_fcmae(jvars, jbatch, r), monkeypatch) for r in rngs]
    assert not torch.equal(masks[0], masks[1])
    want = jax.jit(lambda v, b: (jmod.training_loss(v, b, rngs[0])[0], jmod.validation_loss(v, b, rngs[1])[0]))(
        jvars, jbatch)
    tmod = _torch_engine(params, masks)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = float(tmod.training_loss(tbatch, torch.Generator()).detach())
    np.testing.assert_allclose(got, float(want[0]), rtol=1e-5)
    with torch.no_grad():
        got = float(tmod.eval().validation_loss(tbatch, torch.Generator()))
    np.testing.assert_allclose(got, float(want[1]), rtol=1e-5)
    assert not tmod.training  # validation restores eval mode


class _Data:
    def __init__(self, train, val=None):
        self.train, self.val = train, val

    def prepare_data(self):
        pass

    def setup(self, stage):
        pass

    def train_dataloader(self):
        return list(self.train)

    def val_dataloader(self):
        return None if self.val is None else list(self.val)


def test_two_fit_steps_match_two_jax_steps(params, tmp_path, monkeypatch):
    """Two ``Trainer.fit`` steps and one validation batch of the pretraining
    engine against the JAX ``Trainer``'s: the masks JAX's step keys draw
    (seed + 1, split per step, then per validation batch) handed in; the
    losses, the validation loss and every parameter after AdamW."""
    train = [{"source": _source(2, seed=30 + i), "target": _source(2, seed=40 + i)} for i in range(2)]
    val = [{"source": _source(2, seed=50), "target": _source(2, seed=51)}]
    jmod = _jax_engine(params)
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    rng, masks = jax.random.PRNGKey(1), []
    for b in train + val:
        rng, step = jax.random.split(rng)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        masks.append(_jax_mask(lambda: jmod.forward_fit_fcmae(jvars, jb, step), monkeypatch))
    jtrainer = JTrainer(max_steps=2, default_root_dir=tmp_path / "j", use_tensorboard=False, seed=0,
                        log_every_n_steps=1, checkpoint_every_n_epochs=10**6)
    jtrainer.fit(jmod, _Data(train, val))
    tmod = _torch_engine(params, masks)
    trainer = Trainer(max_steps=2, default_root_dir=tmp_path / "t", seed=0, log_every_n_steps=1,
                      checkpoint_every_n_epochs=10**6, device="cpu")
    trainer.fit(tmod, _Data(train, val))
    assert not tmod.masks
    for key in ("loss/train", "loss/validate"):
        np.testing.assert_allclose(trainer.logged_metrics[key], jtrainer.logged_metrics[key], rtol=1e-5)
    want = fcmae_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jtrainer.state.params))
    for name, p in tmod.model.named_parameters():
        if name not in UNBRIDGED:
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)


def test_trainer_draws_masks_from_its_own_seeded_generators(tmp_path):
    """Without handed masks the trainer's seeded step generators draw them
    (training and validation): the same seed gives the same fit, bit for
    bit, and global RNG stays."""
    train = [{"source": _source(2, seed=60), "target": _source(2, seed=60)}]

    def fit():
        mod = tengine.FcmaeUNet(fit_mask_ratio=0.5, model_config=dict(TINY, dims=(8, 16, 32, 64)),
                                loss_function=tengine.MaskedMSELoss(), device="cpu")
        trainer = Trainer(max_steps=1, default_root_dir=tmp_path, seed=3, log_every_n_steps=1,
                          checkpoint_every_n_epochs=10**6, device="cpu")
        trainer.fit(mod, _Data(train, train))
        return trainer.logged_metrics

    before = torch.random.get_rng_state()
    a, b = fit(), fit()
    assert a["loss/train"] == b["loss/train"] and a["loss/validate"] == b["loss/validate"]
    assert torch.equal(torch.random.get_rng_state(), before)


# -- encoder-only transfer ---------------------------------------------------------


def _pretrained_ckpt(tmp_path, **cfg) -> tuple[Path, dict]:
    mod = tengine.FcmaeUNet(fit_mask_ratio=0.5, model_config=dict(TINY, **cfg), device="cpu", seed=5)
    with torch.no_grad():
        for p in mod.model.parameters():  # away from any fresh initialization
            p.add_(0.01)
    state = {k: v.clone() for k, v in mod.model.state_dict().items()}
    path = tmp_path / "pretrain.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in state.items()}}, path)
    return path, state


def _finetune(path, **cfg):
    return tengine.FcmaeUNet(encoder_only=True, ckpt_path=str(path), model_config=dict(TINY, **cfg), device="cpu")


def test_encoder_only_transfer_copies_the_encoder_bit_for_bit(tmp_path):
    """out_channels 1 -> 2: every ``encoder.*`` tensor equals the
    checkpoint's, the decoder and head keep the fine-tune model's own
    initialization; the trainer calls the hook once, before a resume."""
    path, state = _pretrained_ckpt(tmp_path)
    mod = _finetune(path, out_channels=2, pretraining=False, decoder_conv_blocks=2)
    fresh = {k: v.clone() for k, v in mod.model.state_dict().items()}
    mod.load_pretrained()
    got = mod.model.state_dict()
    enc = [k for k in got if k.startswith("encoder.")]
    assert enc and all(torch.equal(got[k], state[k]) for k in enc)
    rest = [k for k in got if not k.startswith("encoder.")]
    assert rest and all(torch.equal(got[k], fresh[k]) for k in rest)
    assert any(k in state and state[k].shape == got[k].shape and not torch.equal(got[k], state[k]) for k in rest)
    calls = []
    mod.load_pretrained = lambda: calls.append(1)
    trainer = Trainer(device="cpu", default_root_dir=tmp_path)
    trainer._load_pretrained(mod)
    trainer._load_pretrained(mod)
    assert calls == [1]


def test_encoder_only_refuses_a_stem_of_another_kernel(tmp_path):
    """A 3-D pretraining stem (5, 4, 4) under a 2-D fine-tune (1, 2, 2), as
    the two shipped configs have them, raises and names the stem kernels
    (the JAX engine's encoder swap fails at its first use); the model keeps
    its weights. With the fine-tune's stem pretrained, every encoder tensor
    is copied."""
    path, _ = _pretrained_ckpt(tmp_path)
    mod = _finetune(path, out_channels=2, pretraining=False, stem_kernel_size=(1, 2, 2), in_stack_depth=1)
    fresh = {k: v.clone() for k, v in mod.model.state_dict().items()}
    with pytest.raises(ValueError, match=r"stem kernels differ \(encoder.stem.conv2d.weight"):
        mod.load_pretrained()
    assert all(torch.equal(v, fresh[k]) for k, v in mod.model.state_dict().items())
    path, state = _pretrained_ckpt(tmp_path, stem_kernel_size=(1, 2, 2), in_stack_depth=1)
    mod.load_pretrained()
    got = mod.model.state_dict()
    assert all(torch.equal(got[k], state[k]) for k in got if k.startswith("encoder."))


def test_encoder_only_refusals(tmp_path):
    with pytest.raises(ValueError, match="requires ckpt_path"):
        tengine.FcmaeUNet(encoder_only=True, model_config=dict(TINY), device="cpu")
    with pytest.raises(ValueError, match="requires ckpt_path"):
        jengine.FcmaeUNet(encoder_only=True, model_config=dict(TINY))
    bare = tmp_path / "decoder_only.ckpt"
    mod = tengine.FcmaeUNet(model_config=dict(TINY), device="cpu")
    torch.save({k: v for k, v in mod.model.state_dict().items() if not k.startswith("encoder.")}, bare)
    with pytest.raises(KeyError, match="no encoder"):
        _finetune(bare).load_pretrained()
    with pytest.raises(ValueError, match="fcmae_state_dict_from_flax"):
        _finetune(tmp_path).load_pretrained()
    path, _ = _pretrained_ckpt(tmp_path, dims=(8, 16, 32, 64))
    with pytest.raises(ValueError, match="does not fit"):
        _finetune(path).load_pretrained()


def test_pretraining_default_follows_the_jax_rule():
    """``FcmaeUNet`` defaults to ``"fcmae"``, so ``pretraining`` defaults
    to true; ``pretraining: false`` (the fine-tune config) turns it off."""
    cfg = {k: v for k, v in TINY.items() if k != "pretraining"}
    assert tengine.FcmaeUNet(model_config=dict(cfg), device="cpu").model.pretraining
    assert jengine.FcmaeUNet(model_config=dict(cfg)).model.pretraining
    assert not tengine.FcmaeUNet(model_config=dict(cfg, pretraining=False), device="cpu").model.pretraining


# -- the two configs through the CLI ------------------------------------------------

NARROW = dict(encoder_blocks=[1, 1, 1, 1], dims=[8, 16, 32, 64], dtype="float32")


def _crop():
    """A random 64^2 crop, put first (the shipped configs have none)."""
    return {"class_path": "viscy_transforms.BatchedRandSpatialCropd",
            "init_args": {"keys": ["source", "target"], "roi_size": [-1, 64, 64]}}


def test_pretrain_then_finetune_through_the_cli(tmp_path):
    """``fit -c`` derived from ``configs/fcmae_pretrain.yml`` (data path,
    narrow widths, the CPU, a 64^2 crop); the fine-tune derived from
    ``configs/vscyto2d_finetune.yml`` with ``ckpt_path`` at its ``last``
    refuses it (the shipped pair's stems differ: (5, 4, 4) at depth 5
    against (1, 2, 2) at depth 1); pretrained again with the fine-tune's
    stem, the fine-tune trains from that run's encoder, every tensor of it."""
    plate = build_hcs_plate(tmp_path / "plate.zarr", ["Phase3D", "Nuclei", "Membrane"], zyx_shape=(6, 96, 96),
                            num_timepoints=1, rows=("A",), cols=("1",), fovs=("0", "1", "2"), seed=3, norm_meta=True)
    trainer_cfg = {"device": "cpu", "max_epochs": 1, "limit_train_batches": 1, "limit_val_batches": 1}
    data = {"data_path": str(plate), "batch_size": 2, "num_workers": 0, "yx_patch_size": [64, 64]}
    pre_augs = yaml.safe_load((ROOT / "configs/fcmae_pretrain.yml").read_text())["data"]["init_args"]["augmentations"]
    base = yaml.safe_load((ROOT / "configs/vscyto2d_finetune.yml").read_text())
    augs = base["data"]["init_args"]["augmentations"]

    def fit(name, config, model, extra_data=None):
        path = tmp_path / f"{name}.yml"
        path.write_text(yaml.safe_dump({
            "base": [str(ROOT / "configs" / config)],
            "model": {"init_args": model},
            "data": {"init_args": dict(data, augmentations=[_crop()] + (pre_augs if "pretrain" in config else augs),
                                       **(extra_data or {}))},
            "trainer": dict(trainer_cfg, default_root_dir=str(tmp_path / name)),
        }))
        return cli.main(["fit", "-c", str(path)])

    t1 = fit("pre", "fcmae_pretrain.yml", {"model_config": NARROW})
    ckpt = tmp_path / "pre" / "checkpoints" / "last"
    assert ckpt.exists() and np.isfinite(t1.logged_metrics["loss/validate"])
    with pytest.raises(ValueError, match="stem kernels differ"):
        fit("ft_shipped", "vscyto2d_finetune.yml", {"model_config": NARROW, "ckpt_path": str(ckpt)})
    stem_2d = dict(NARROW, stem_kernel_size=[1, 2, 2], in_stack_depth=1)
    t1 = fit("pre2d", "fcmae_pretrain.yml", {"model_config": stem_2d}, {"z_window_size": 1})
    ckpt = tmp_path / "pre2d" / "checkpoints" / "last"
    assert np.isfinite(t1.logged_metrics["loss/validate"])
    loaded = []
    orig = tengine.FcmaeUNet.load_pretrained
    before = tfb.launches
    try:
        tengine.FcmaeUNet.load_pretrained = lambda self: (orig(self), loaded.append(
            {k: v.clone() for k, v in self.model.state_dict().items()}))
        t2 = fit("ft", "vscyto2d_finetune.yml", {"model_config": NARROW, "ckpt_path": str(ckpt)})
    finally:
        tengine.FcmaeUNet.load_pretrained = orig
    assert tfb.launches == before  # the CPU runs the plain versions
    assert np.isfinite(t2.logged_metrics["loss/validate"]) and (tmp_path / "ft/checkpoints/last").exists()
    pre_state = torch.load(ckpt.resolve(), weights_only=True)["state_dict"]
    (at_load,) = loaded
    enc = [k for k in at_load if k.startswith("encoder.")]
    assert enc and all(torch.equal(at_load[k], pre_state[f"model.{k}"]) for k in enc)
    ft_state = torch.load((tmp_path / "ft/checkpoints/last").resolve(), weights_only=True)["state_dict"]
    assert ft_state["model.decoder.decoder_stages.0.conv.blocks.1.conv_dw.weight"] is not None
    # one step of AdamW at lr 2e-4 (warmup) moves no weight far from where it started
    for k in ("model.encoder.stages.2.blocks.0.mlp.fc1.weight", "model.encoder.stem.conv2d.weight"):
        assert float((ft_state[k] - pre_state[k]).abs().max()) < 1e-3


# -- the fine-tune's affine at depth 1 ----------------------------------------------


def test_depth_one_affine_matches_jax():
    """The fine-tune's ``BatchedRandAffined`` (rotation about z, YX scale
    0.75-1.3) on (B, C, 1, Y, X) stacks, JAX's draws handed in: max|d| <=
    1e-5 (inputs in [0, 1]); the rotation's z coordinate, 0 up to
    rounding, weights no plane that does not exist."""
    kw = dict(keys=["source", "target"], prob=0.9, rotate_range=[3.14, 0.0, 0.0],
              scale_range=[[1.0, 1.0], [0.75, 1.3], [0.75, 1.3]])
    jt, tt = J.BatchedRandAffined(**kw), T.BatchedRandAffined(**kw)
    rng = np.random.default_rng(16)
    batch = {"source": rng.random((4, 1, 1, 48, 48), np.float32), "target": rng.random((4, 2, 1, 48, 48), np.float32)}
    jdata = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(9)
    k_mask, k_params = jax.random.split(key)
    rot, scale, shear, trans = jt._sample_params(k_params, 4, (1, 48, 48))
    as_t = lambda v: None if v is None else torch.from_numpy(np.array(v))
    draws = dict(mask=as_t(jt._apply_mask(k_mask, 4)), rotation=as_t(rot), scale=as_t(scale), shear=as_t(shear),
                 translate=as_t(trans))
    assert draws["mask"].any() and not draws["mask"].all()
    want = jax.jit(jt)(jdata, key)
    got = tt({k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws)
    for k in batch:
        assert got[k].shape == batch[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0, err_msg=k)
        # a plain in-plane warp of the single plane: no darkening from z
        plane = float(got[k][~draws["mask"]].sub(torch.from_numpy(batch[k])[~draws["mask"]]).abs().max())
        assert plane == 0.0
