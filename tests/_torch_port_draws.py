"""The draws of every random JAX transform as the port's ``draw`` returns
them, read off the PRNG keys the JAX transform (and the JAX ``Compose``)
splits: the members of ``test_torch_port_augment.jax_draws`` and
``test_torch_port_flip_crop._draws`` and the rest (histogram shift,
inversion, noise per call, sharpen, pixel shuffling, Z shift, elastic,
weighted crop). ``raw_draws`` and ``compose_draws`` are pure JAX, so a
whole pipeline's draws can be traced into one ``jax.jit``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch


def raw_draws(member, data: dict, key) -> dict:
    """The draws ``member`` (a JAX transform, possibly fused: then ``key``
    is its stack of subkeys) makes from ``key`` on ``data``, as JAX arrays."""
    name = type(member).__name__
    first = data[member.first_key(data)]
    b, spatial = first.shape[0], first.shape[-3:]
    if name == "BatchedRandAffined":
        keys = [key] if getattr(member, "n_random_keys", 1) == 1 else list(key)
        k_mask, k_params = jax.random.split(keys[0])
        rot, scale, shear, trans = member._sample_params(k_params, b, spatial)
        d = dict(mask=member._apply_mask(k_mask, b), rotation=rot, scale=scale, shear=shear, translate=trans)
        rest = keys[1:]
        if member._rand_crop_size is not None:
            roi = tuple(s if r < 0 else min(r, s) for r, s in zip(member._rand_crop_size, spatial))
            d["starts"] = _crop_starts(rest.pop(0), b, spatial, roi)
        if member._flip_axes is not None:
            d["flips"] = jax.random.uniform(rest.pop(0), (b, len(member._flip_axes))) < member._flip_prob
        return d
    if name == "BatchedRandFlipd":
        return dict(flips=jax.random.uniform(key, (b, len(member.spatial_axes))) < member.prob)
    if name == "BatchedRandSpatialCropd":
        roi = tuple(s if r < 0 else min(r, s) for r, s in zip(member.roi_size, spatial))
        if member.random_center:
            return dict(starts=_crop_starts(key, b, spatial, roi))
        return dict(starts=jnp.broadcast_to(jnp.array([(s - r) // 2 for s, r in zip(spatial, roi)]), (b, 3)))
    if name == "BatchedRandWeightedCropd":
        w = data[member.w_key]
        cz, cy, cx = member.spatial_size
        k_yx, k_z = jax.random.split(key)
        wm = jnp.clip(w.sum(axis=(1, 2)), 0, None).astype(jnp.float32)
        pooled = jax.lax.reduce_window(wm, 0.0, jax.lax.add, (1, cy, cx), (1, 1, 1), "VALID")
        flat = pooled.reshape(b, -1)
        flat = jnp.where(flat.sum(axis=1, keepdims=True) > 0, flat, 1.0)
        index = jax.random.categorical(k_yx, jnp.log(jnp.maximum(flat, 1e-30)), axis=1)
        z = w.shape[2]
        z_starts = jnp.zeros((b,), jnp.int32) if cz >= z else jax.random.randint(k_z, (b,), 0, z - cz + 1)
        return dict(index=index, z_starts=z_starts)
    if name == "BatchedRandInvertIntensityd":
        return dict(mask=member._apply_mask(key, b))
    if name == "RandInvertIntensityd":
        return dict(do=jax.random.uniform(key, ()) < member.prob)
    if name in ("BatchedRandGaussianNoised", "RandGaussianNoiseTensord"):
        k_mask, k_std, k_noise = jax.random.split(key, 3)
        noise = [jax.random.normal(jax.random.fold_in(k_noise, i), data[k].shape, data[k].dtype)
                 for i, k in enumerate(member.key_iterator(data))]
        shape = (b,) if name == "BatchedRandGaussianNoised" else ()
        std = (jax.random.uniform(k_std, shape, minval=0.0, maxval=member.std) if member.sample_std
               else jnp.full(shape, member.std, jnp.float32))
        if name == "RandGaussianNoiseTensord":
            return dict(do=jax.random.uniform(k_mask, ()) < member.prob, std=std, noise=noise)
        return dict(mask=member._apply_mask(k_mask, b), std=std, noise=noise)
    if name == "BatchedRandLocalPixelShufflingd":
        k_mask, k_shift, k_blocks = jax.random.split(key, 3)
        bs = member.block_size
        gy, gx = max(1, spatial[1] // bs), max(1, spatial[2] // bs)
        frac = min(1.0, member.num_blocks / (gy * gx))
        return dict(mask=member._apply_mask(k_mask, b),
                    shifts=jax.random.randint(k_shift, (b, 2), -bs // 2, bs // 2 + 1),
                    blocks=jax.random.uniform(k_blocks, (b, 1, 1, gy, gx)) < frac)
    if name == "BatchedRand3DElasticd":
        k_mask, k_mag, k_field = jax.random.split(key, 3)
        lo, hi = member.magnitude_range
        return dict(mask=member._apply_mask(k_mask, b),
                    magnitude=jax.random.uniform(k_mag, (b, 1, 1, 1, 1), minval=lo, maxval=hi).reshape(b),
                    noise=jax.random.normal(k_field, (b, 3, *spatial)))
    k_mask, k_p = jax.random.split(key)
    d = dict(mask=member._apply_mask(k_mask, b))
    if name == "BatchedRandAdjustContrastd":
        d["gamma"] = jax.random.uniform(k_p, (b,), minval=member.gamma_range[0], maxval=member.gamma_range[1])
    elif name == "BatchedRandScaleIntensityd":
        d["factor"] = jax.random.uniform(k_p, (b,), minval=member.factors[0], maxval=member.factors[1])
    elif name == "BatchedRandGaussianSmoothd":
        lo = jnp.array([s[0] for s in member.sigma_ranges])
        hi = jnp.array([s[1] for s in member.sigma_ranges])
        d["sigmas"] = jax.random.uniform(k_p, (b, 3)) * (hi - lo) + lo
    elif name == "BatchedRandHistogramShiftd":
        n = member.num_control_points
        d["jitter"] = jax.random.uniform(k_p, (b, n), minval=-0.5 / (n - 1), maxval=0.5 / (n - 1))
    elif name == "BatchedRandSharpend":
        d["alpha"] = jax.random.uniform(k_p, (b,), minval=member.alpha[0], maxval=member.alpha[1])
    elif name == "BatchedRandZStackShiftd":
        d["shifts"] = jax.random.randint(k_p, (b,), -member.max_shift, member.max_shift + 1)
    else:
        raise KeyError(name)
    return d


def _crop_starts(key, b, spatial, roi):
    maxs = jnp.array([s - r for s, r in zip(spatial, roi)])
    return jnp.minimum((jax.random.uniform(key, (b, 3)) * (maxs[None] + 1)).astype(jnp.int32), maxs[None])


def to_torch(tree):
    """JAX arrays (in dicts and lists; None kept) as torch tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v) for v in tree]
    return None if tree is None else torch.from_numpy(np.array(tree))


def jax_draws(member, data: dict, key) -> dict:
    """``raw_draws`` as the port's draws dict (torch tensors)."""
    return to_torch(raw_draws(member, data, key))


def compose_draws(compose, data: dict, key):
    """The JAX ``Compose``'s output and the draws of each random member,
    split from ``key`` as ``Compose`` splits it (pure JAX)."""
    counts = [getattr(t, "n_random_keys", 1) if t.is_random else 0 for t in compose]
    subkeys = jax.random.split(key, sum(counts)) if sum(counts) else []
    draws, ki = [], 0
    for t, c in zip(compose, counts):
        if c == 0:
            data = t(data)
            continue
        k = subkeys[ki] if c == 1 else subkeys[ki : ki + c]
        draws.append(raw_draws(t, data, k))
        data = t(data, k)
        ki += c
    return data, draws


def run_jax_compose(compose, data: dict, key):
    """``compose_draws`` with the draws as torch tensors."""
    out, draws = compose_draws(compose, data, key)
    return out, to_torch(draws)
