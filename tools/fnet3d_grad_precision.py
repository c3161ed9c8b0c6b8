#!/usr/bin/env python3
"""Where a U-Net's f32 gradients lose precision, card against CPU.

    python3 tools/fnet3d_grad_precision.py [--arch FNet3D] [--shape 2,1,16,128,128] [--device cuda]

One ``VSUNet(arch)`` train-mode step (``FNet3D``, or the legacy ``2D`` /
``2.5D`` U-Net at the JAX defaults with dropout 0, so no draw differs; the
engine's seeded weights, as in ``chip_smoke.py`` phases 15 (a) and 16 (a),
and a seeded batch) is taken in f64 on the CPU as the reference
and then in f32 by several variants: the CPU; the card with cuDNN (as the
engine trains; also in f64), with ``cudnn.deterministic``, without cuDNN (PyTorch's own
CUDA convolutions) and with TF32 allowed. For each variant it prints the
error against f64 of every leaf module's output in the forward (max |d|
over the f64 range, the worst three), of the loss, and of the parameter
gradients (per parameter: max |d| over the range, ||d|| / ||ref|| and
Pearson r, the worst three; over all of them at once: ||d|| / ||ref||), once for the engine's loss (``MixedLoss`` L1 +
L2) and once for an L2-only loss (the L1 term's sign flips where the
prediction meets the target). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    span = float(want.max() - want.min())
    return float((got - want).abs().max()) / (span if span > 0 else max(float(want.abs().max()), 1e-30))


@contextlib.contextmanager
def backends(cudnn: bool = True, deterministic: bool = False, tf32: bool = False):
    before = (torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic,
              torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic = cudnn, deterministic
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic,
         torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = before


def run(module, batch: dict, loss_fn, device: str, dtype: torch.dtype) -> tuple[float, dict, dict]:
    """One train-mode step: (loss, leaf outputs, parameter gradients)."""
    outs, hooks = {}, []
    for name, mod in module.model.named_modules():
        if not list(mod.children()):
            hooks.append(mod.register_forward_hook(
                lambda m, i, o, name=name: outs.__setitem__(name, o.detach().cpu().double())))
    module.train()
    module.zero_grad(set_to_none=True)
    loss = loss_fn(module, {k: v.to(device, dtype) for k, v in batch.items()})
    loss.backward()
    for h in hooks:
        h.remove()
    grads = {n: p.grad.detach().cpu().double() for n, p in module.named_parameters()}
    return float(loss.detach()), outs, grads


def pearson(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.flatten() - a.mean(), b.flatten() - b.mean()
    return float((a * b).sum() / (a.norm() * b.norm()).clamp_min(1e-300))


def report(tag: str, got: tuple, ref: tuple) -> None:
    """The forward's and the gradients' errors against ``ref``: per leaf,
    max |d| over the range and ||d|| / ||ref|| (the worst three each) and
    Pearson r (the lowest); over every gradient at once, ||d|| / ||ref||."""
    loss, outs, grads = got
    names = [k for k in ref[2] if not k.endswith("proj.bias")]  # FNet3D: 0 up to rounding before a BatchNorm
    out_err = sorted(((rel(outs[k], ref[1][k]), k) for k in ref[1]), reverse=True)
    of_range = sorted(((rel(grads[k], ref[2][k]), k) for k in names), reverse=True)
    l2 = sorted((((grads[k] - ref[2][k]).norm() / ref[2][k].norm(), k) for k in names), reverse=True)
    r = sorted((pearson(grads[k], ref[2][k]), k) for k in names if grads[k].numel() > 1)
    d = torch.cat([(grads[k] - ref[2][k]).flatten() for k in names])
    total = float(d.norm() / torch.cat([ref[2][k].flatten() for k in names]).norm())
    pad = " " * (len(tag) + 4)
    print(f"  {tag}: loss rel {abs(loss - ref[0]) / abs(ref[0]):.2e}; forward outputs of range worst "
          + ", ".join(f"{k} {e:.2e}" for e, k in out_err[:3]))
    print(f"{pad}gradients: every one ||d||/||ref|| {total:.3e}; of range worst "
          + ", ".join(f"{k} {e:.2e}" for e, k in of_range[:3]))
    print(f"{pad}||d||/||ref|| worst " + ", ".join(f"{k} {float(e):.2e}" for e, k in l2[:3])
          + f"; lowest r {r[0][1]} {r[0][0]:.8f}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="FNet3D", choices=["FNet3D", "2D", "2.5D"])
    ap.add_argument("--shape", default="2,1,16,128,128")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from viscy_tpu_torch.apps.cytoland.engine import VSUNet
    from viscy_tpu_torch.training.losses.mixed_loss import MixedLoss

    shape = tuple(int(s) for s in args.shape.split(","))
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
        print(f"card: {smi}")
    g = torch.Generator().manual_seed(1502)
    config = {"FNet3D": dict(in_stack_depth=shape[2]),
              "2D": dict(in_channels=shape[1], out_channels=2, task="reg", dropout=0.0),
              "2.5D": dict(in_channels=shape[1], out_channels=2, in_stack_depth=shape[2], task="reg", dropout=0.0)}
    out_shape = (shape[0], 2 if args.arch != "FNet3D" else shape[1], 1 if args.arch == "2.5D" else shape[2], *shape[3:])
    batch = {"source": torch.randn(shape, generator=g), "target": torch.randn(out_shape, generator=g)}

    def build(device: str, dtype: torch.dtype):
        m = VSUNet(args.arch, dict(config[args.arch]), device="cpu",
                   loss_function=MixedLoss(l1_alpha=0.5, l2_alpha=0.5, ms_dssim_alpha=0.0))
        return m.to(device, dtype)

    base = build("cpu", torch.float32).model.state_dict()
    losses = {"engine (L1 + L2)": lambda m, b: m.training_loss(b),
              "L2 only": lambda m, b: (m.model(b["source"]) - b["target"]).square().mean()}
    f32, f64 = torch.float32, torch.float64
    variants = [("CPU f32", "cpu", f32, {})]
    if args.device == "cuda":
        variants += [("card f64 cuDNN", "cuda", f64, {}), ("card f32 cuDNN", "cuda", f32, {}),
                     ("card f32 cuDNN deterministic", "cuda", f32, {"deterministic": True}),
                     ("card f32 no cuDNN", "cuda", f32, {"cudnn": False}), ("card TF32 cuDNN", "cuda", f32, {"tf32": True})]
    for loss_name, loss_fn in losses.items():
        print(f"VSUNet('{args.arch}') train-mode step at {shape}, {loss_name}, error against the CPU's f64 (of range):")
        ref_mod = build("cpu", f64)
        ref_mod.model.load_state_dict(base)
        ref = run(ref_mod, batch, loss_fn, "cpu", f64)
        for tag, device, dtype, flags in variants:
            m = build(device, dtype)
            m.model.load_state_dict(base)
            with backends(**flags):
                report(tag, run(m, batch, loss_fn, device, dtype), ref)
            del m
    return 0


if __name__ == "__main__":
    sys.exit(main())
