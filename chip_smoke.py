#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. env     torch/CUDA versions and ``nvidia-smi`` name and power limit.
2. build   compile every ``viscy_tpu_torch/csrc/*.cu`` with nvcc (one process
           per source, started together); print seconds and ``-Xptxas -v``.
3. kernel  for every distinct (S, C, M) the flagship gives the fused
           ConvNeXt-v2 MLP+GRN kernel at tile 320 and the slice's tile batch:
           kernel vs ``reference_mlp_grn`` in f32 (TF32 off) and bf16, one
           masked case, and CUDA-event medians of kernel and plain.
4. slice   the flagship VSUNet (FCMAE UNeXt2, dims 96-768, bf16, seeded
           weights with non-zero GRN gamma/beta) serves three 2048^2 x 15
           FOVs through ``Trainer.predict`` with YX tiling, in five timed
           rounds; checks shapes, finiteness and the kernel launch count
           over all rounds; prints each round's FOVs/s; profiles one more
           request (device time by kernel, device busy share); then one f32
           two-tile batch on the card (kernel) against the CPU (plain version).

The last two lines are a JSON ``kernels`` record and the JSON result line.
Needs ``torch.cuda.is_available()`` and the repo's ``viscy_tpu_torch``
beside this file. Imports nothing of JAX or ``viscy_tpu``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

FLAGSHIP = dict(
    in_channels=1,
    out_channels=2,
    encoder_blocks=(3, 3, 9, 3),
    dims=(96, 192, 384, 768),
    decoder_conv_blocks=2,
    stem_kernel_size=(5, 4, 4),
    in_stack_depth=15,
    pretraining=False,
    dtype="bfloat16",
    fused_mlp=True,
)
TILE = 320
# all 49 tiles of a 2048^2 FOV (7 x 7 at 32 px overlap) in one forward:
# about 5 GB of bf16 activations, well inside the card's 80 GB
TILE_BATCH = 49
FOV_SHAPE = (1, 1, 15, 2048, 2048)
N_REQUESTS = 3
# timed rounds of N_REQUESTS each, so the rate comes with its spread
N_ROUNDS = 5
# H100 SXM data sheet: HBM rate and dense peaks (bf16 tensor core, f32 CUDA core)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TIMED_RUNS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_shapes(cfg: dict, tile: int) -> list[tuple[int, int, int]]:
    """(S, C, M) of every fused block call in one forward, in call order."""
    r = tile // cfg["stem_kernel_size"][-1]
    dims = cfg["dims"]
    shapes = []
    for i, (n, d) in enumerate(zip(cfg["encoder_blocks"], dims)):
        shapes += [((r >> i) ** 2, d, 4 * d)] * n
    dec = list(dims[::-1])
    dec[-1] = cfg["out_channels"] * cfg["in_stack_depth"] * cfg["stem_kernel_size"][-1] ** 2
    for i in range(len(dims) - 1):
        side = r >> (len(dims) - 2 - i)
        shapes += [(side * side, dec[i + 1], 4 * dec[i + 1])] * cfg["decoder_conv_blocks"]
    return shapes


def pearson(a: torch.Tensor, b: torch.Tensor) -> float:
    a = a.double().flatten()
    b = b.double().flatten()
    a = a - a.mean()
    b = b - b.mean()
    return float((a * b).sum() / (a.norm() * b.norm()).clamp_min(1e-30))


def cuda_median_ms(fn, runs: int = TIMED_RUNS) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def block_inputs(b, s, c, m, dtype, seed, masked=False):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def normal(shape, mean, std, dt=torch.float32):
        return (torch.randn(shape, generator=g, device="cuda") * std + mean).to(dt)

    args = (
        normal((b, s, c), 0.0, 1.0, dtype),  # x
        normal((b, s, c), 0.0, 1.0, dtype),  # shortcut
        normal((c,), 1.0, 0.1),  # ln scale (not 1)
        normal((c,), 0.0, 0.1),  # ln bias
        normal((m, c), 0.0, 1.0 / math.sqrt(c)),  # fc1 weight
        normal((m,), 0.0, 0.02),  # fc1 bias
        normal((m,), 0.5, 0.2),  # GRN gamma (non-zero)
        normal((m,), 0.0, 0.05),  # GRN beta (non-zero)
        normal((c, m), 0.0, 1.0 / math.sqrt(m)),  # fc2 weight
        normal((c,), 0.0, 0.02),  # fc2 bias
    )
    mask = None
    if masked:
        mask = (torch.rand((b, s), generator=g, device="cuda") > 0.4).float()
    return args, mask


def block_bound_ms(b, s, c, m, dtype, masked=False) -> tuple[float, str]:
    """Least time for one call: each input read once, the output written once,
    4 B S C M operations (fc1 once, fc2 once: what the function needs, not
    the kernel's recompute of fc1) at the dtype's peak."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = 3 * b * s * c * elem + 4 * (2 * c * m + 3 * m + 3 * c) + (4 * b * s if masked else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * b * s * c * m / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_env() -> str:
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[env] device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    card = card_line()
    log(f"[env] nvidia-smi: {card}")
    return card


def phase_build() -> None:
    from viscy_tpu_torch.ops import _build

    t0 = time.perf_counter()
    results = _build.build_all()
    log(f"[build] {len(results)} source(s) in {time.perf_counter() - t0:.2f} s")
    for r in results:
        cached = " (library already built; ptxas lines from the build that made it)" if r.cached else ""
        log(f"[build] {r.name}: {r.seconds:.2f} s -> {r.path.name}{cached}")
        for line in r.log.splitlines():
            if "ptxas" in line:
                log(f"[build]   {line.strip()}")


def phase_kernel() -> dict:
    from viscy_tpu_torch.ops import fused_block as fb

    batch = TILE_BATCH
    per_forward = kernel_shapes(FLAGSHIP, TILE)
    distinct = sorted(set(per_forward), key=per_forward.index)
    rows = {}
    worst_bf16 = 0.0
    for k, (s, c, m) in enumerate(distinct):
        masked_cases = [False, True] if k == 1 else [False]
        for masked in masked_cases:
            for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 1.5e-2)):
                args, mask = block_inputs(batch, s, c, m, dtype, seed=100 + k, masked=masked)
                got = fb.fused_mlp_grn(*args, mask=mask)
                want = fb.reference_mlp_grn(*args, mask=mask)
                torch.cuda.synchronize()
                gotf, wantf = got.float(), want.float()
                err = float((gotf - wantf).abs().max())
                rng = float(wantf.max() - wantf.min())
                r = pearson(gotf, wantf)
                ok = torch.isfinite(gotf).all().item() and err <= rel * rng
                if dtype == torch.bfloat16:
                    ok = ok and r > 0.9999
                    worst_bf16 = max(worst_bf16, err)
                tag = f"S={s} C={c} M={m} B={batch} {str(dtype)[6:]}{' masked' if masked else ''}"
                log(
                    f"[kernel] {tag}: max|d|={err:.3e} range={rng:.3e} "
                    f"({err / max(rng, 1e-30):.2e} of range, bound {rel:g}) r={r:.7f}"
                )
                if not ok:
                    raise AssertionError(f"kernel disagrees with the plain version at {tag}")
                del got, want, gotf, wantf
        # timing at the flagship dtype, unmasked
        args, _ = block_inputs(batch, s, c, m, torch.bfloat16, seed=200 + k)
        kernel_ms = cuda_median_ms(lambda: fb.fused_mlp_grn(*args))
        plain_ms = cuda_median_ms(lambda: fb.reference_mlp_grn(*args))
        bound, bound_by = block_bound_ms(batch, s, c, m, torch.bfloat16)
        n = per_forward.count((s, c, m))
        rows[(s, c, m)] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, n=n)
        log(
            f"[kernel] time S={s} C={c} M={m} B={batch} bf16 x{n}/forward: kernel {kernel_ms:.3f} ms "
            f"plain {plain_ms:.3f} ms bound {bound:.4f} ms ({bound_by}) "
            f"= {bound / kernel_ms:.3f} of bound, library n/a"
        )
        del args
        torch.cuda.empty_cache()
    total = {key: sum(v[key] * v["n"] for v in rows.values()) for key in ("ms", "plain_ms", "bound_ms")}
    by_ops = sum(v["bound_ms"] * v["n"] for v in rows.values() if v["bound_by"] == "operations")
    log(
        f"[kernel] per forward ({len(per_forward)} calls, B={batch}): kernel {total['ms']:.3f} ms "
        f"plain {total['plain_ms']:.3f} ms bound {total['bound_ms']:.3f} ms"
    )
    return dict(
        total,
        bound_by="operations" if by_ops >= total["bound_ms"] / 2 else "bytes",
        max_abs_err=worst_bf16,
    )


class _FovDataModule:
    """In-memory stand-in for the HCS prediction datamodule: ``n`` seeded
    uniform FOVs in host memory, one per request, drawn up front (set-up,
    outside the timed run)."""

    def __init__(self, n: int, seed: int) -> None:
        g = torch.Generator().manual_seed(seed)
        self.fovs = [torch.rand(FOV_SHAPE, generator=g) for _ in range(n)]

    def setup(self, stage: str) -> None:
        pass

    def predict_dataloader(self):
        for fov in self.fovs:
            yield {"source": fov}


def _request_timer():
    from viscy_tpu_torch.training.callbacks.base import Callback

    class RequestTimer(Callback):
        def on_predict_start(self, trainer, module) -> None:
            torch.cuda.synchronize()
            self.latencies = []
            self._last = self.start = time.perf_counter()

        def write_on_batch_end(self, trainer, module, prediction, batch, batch_idx) -> None:
            torch.cuda.synchronize()
            now = time.perf_counter()
            self.latencies.append(now - self._last)
            self._last = now

    return RequestTimer()


def profile_request(trainer, module) -> None:
    """Device time by kernel over one more request, from torch.profiler's
    CUDA activity; the wall time includes the profiler's own overhead."""
    from torch.profiler import ProfilerActivity, profile

    data = _FovDataModule(1, seed=40)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.predict(module, data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        log("[profile] torch.profiler recorded no device time: breakdown not measured")
        return
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    fused_ms = sum(e.self_device_time_total for e in events if "fmg_kernel" in e.key) / 1e3
    log(f"[profile] one request: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.1%} of wall), fused MLP+GRN kernel {fused_ms:.1f} ms "
        f"({fused_ms / busy_ms:.1%} of busy)")
    for e in events[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<4d} {e.key[:100]}")


def phase_slice(card: str) -> dict:
    from viscy_tpu_torch.apps.cytoland.engine import VSUNet
    from viscy_tpu_torch.apps.cytoland.prediction import tile_positions
    from viscy_tpu_torch.models.components.blocks import GRN
    from viscy_tpu_torch.ops import fused_block as fb
    from viscy_tpu_torch.training.trainer import Trainer

    module = VSUNet(
        architecture="fcmae",
        model_config=FLAGSHIP,
        tile_yx=(TILE, TILE),
        tile_batch=TILE_BATCH,
        seed=0,
        device="cuda",
    )
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, GRN):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=g) * 0.5)
                mod.bias.copy_(torch.randn(mod.bias.shape, generator=g) * 0.1)
    n_params = sum(p.numel() for p in module.parameters())
    log(f"[slice] VSUNet fcmae dims {FLAGSHIP['dims']} bf16: {n_params} parameters, "
        f"tile {TILE}x{TILE}, tile_batch {TILE_BATCH}")
    timer = _request_timer()
    trainer = Trainer(callbacks=[timer], device="cuda")

    trainer.predict(module, _FovDataModule(1, seed=10))
    log(f"[slice] warm-up request: {timer.latencies[0]:.3f} s")

    n_tiles = len(tile_positions(FOV_SHAPE[-2], TILE)) * len(tile_positions(FOV_SHAPE[-1], TILE))
    forwards_per_request = math.ceil(n_tiles / TILE_BATCH)
    requests = _FovDataModule(N_REQUESTS, seed=20)
    torch.cuda.reset_peak_memory_stats()
    rates, latencies = [], []
    fb.launches = 0
    for rnd in range(N_ROUNDS):
        preds = trainer.predict(module, requests, return_predictions=True)
        wall = timer._last - timer.start  # first request in to last prediction out
        for i, p in enumerate(preds):
            if tuple(p.shape) != (1, 2, *FOV_SHAPE[2:]) or p.dtype != torch.float32:
                raise AssertionError(f"round {rnd} request {i}: prediction {tuple(p.shape)} {p.dtype}")
            if not torch.isfinite(p).all():
                raise AssertionError(f"round {rnd} request {i}: non-finite prediction")
        del preds
        rates.append(N_REQUESTS / wall)
        latencies += timer.latencies
        log(f"[slice] round {rnd}: latencies {', '.join(f'{t:.4f}' for t in timer.latencies)} s; "
            f"{rates[-1]:.4f} FOVs/s")
    launches = fb.launches
    per_forward = 2 * len(kernel_shapes(FLAGSHIP, TILE))
    expected = per_forward * forwards_per_request * N_REQUESTS * N_ROUNDS
    log(f"[slice] fused_mlp_grn launches {launches}, expected {per_forward} x "
        f"{forwards_per_request * N_REQUESTS * N_ROUNDS} forwards = {expected}")
    if launches != expected:
        raise AssertionError(f"main path launched the kernel {launches} times, expected {expected}")
    log(f"[slice] outputs (1, 2, {', '.join(map(str, FOV_SHAPE[2:]))}) float32, finite; "
        f"{N_ROUNDS} rounds of {N_REQUESTS} requests: FOVs/s median {statistics.median(rates):.4f} "
        f"(min {min(rates):.4f}, max {max(rates):.4f}); request latency median "
        f"{statistics.median(latencies):.4f} s (min {min(latencies):.4f}, max {max(latencies):.4f}); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    profile_request(trainer, module)

    # cross-check: the same weights in f32, two tiles, card (kernel) vs CPU (plain)
    cfg32 = dict(FLAGSHIP, dtype="float32")
    on_card = VSUNet("fcmae", cfg32, device="cuda")
    on_card.load_state_dict(module.state_dict())
    on_cpu = VSUNet("fcmae", cfg32, device="cpu")
    on_cpu.load_state_dict(module.state_dict())
    tiles = torch.rand((2, 1, 15, TILE, TILE), generator=torch.Generator().manual_seed(30))
    with torch.inference_mode():
        got = on_card(tiles.cuda()).cpu()
        t0 = time.perf_counter()
        want = on_cpu(tiles)
        cpu_s = time.perf_counter() - t0
    err = float((got - want).abs().max())
    rng = float(want.max() - want.min())
    r = pearson(got, want)
    log(f"[slice] f32 cross-check (2,1,15,{TILE},{TILE}) card kernel vs CPU plain: "
        f"max|d|={err:.3e} range={rng:.3e} ({err / rng:.2e} of range, bound 2e-3) r={r:.8f} "
        f"(CPU forward {cpu_s:.1f} s)")
    if not (err <= 2e-3 * rng and r > 0.9999):
        raise AssertionError("f32 card forward disagrees with the CPU plain forward")
    return dict(launches=launches)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False")
    if not (ROOT / "viscy_tpu_torch").is_dir():
        raise RuntimeError(f"viscy_tpu_torch/ not found beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    # f32 comparisons run in full f32 (cuBLAS and cuDNN would otherwise use TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = phase_env()
    phase_build()
    kern = phase_kernel()
    sl = phase_slice(card)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    record = dict(
        name="fused_mlp_grn_fwd",
        route="cuda",
        source="viscy_tpu_torch/csrc/fused_mlp_grn.cu",
        replaces="viscy_tpu/ops/pallas/fused_block.py:164,183",
        launches=sl["launches"],
        max_abs_err=kern["max_abs_err"],
        ms=kern["ms"],
        plain_ms=kern["plain_ms"],
        bound_ms=kern["bound_ms"],
        bound_by=kern["bound_by"],
        library_ms=None,
    )
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
