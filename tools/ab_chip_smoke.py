#!/usr/bin/env python3
"""Run phases of ``chip_smoke.py`` from two source trees in turns on one card.

    python3 tools/ab_chip_smoke.py OLD_TREE NEW_TREE [--phases kernel,slice,train] [--out DIR]

Each tree is a directory holding its own ``chip_smoke.py`` and
``viscy_tpu_torch/`` (for example ``git archive`` of a commit unpacked into
a git-ignored directory). The turns run old, new, new, old, each in a fresh
process started in its tree (so each imports its own package and builds
its own kernels), with TF32 off as ``chip_smoke.main`` sets it. A turn's
whole output goes to ``DIR/ab_<turn>_<old|new>.log`` (default ``ab_logs``);
the lines that carry the compared numbers are printed here. Exits non-zero
if any turn fails.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

KEEP = ("[env] nvidia-smi", "per step", "per forward", "time S=", "stage S=", "stages sum",
        "patches/s median", "FOVs/s median", "[profile] one train step", "[profile] one request",
        "[warp]", "[train] warp", "[dynaclr-cli]", "[celldiff]", "[legacy]", "[gan]", "[vae]", "[done]")
# phases that take the card's name, those that also take a scratch directory,
# and those that also take phase 9's fit plate (written first) or phase 14's
# plate and tracks
CARD_PHASES = ("train", "slice")
TMP_PHASES = ("dynaclr_cli", "celldiff")
PLATE_PHASES = ("legacy", "gan")
TRACK_PHASES = ("vae",)


def turn_code(phases: list[str]) -> str:
    calls = []
    for p in phases:
        if p in TMP_PHASES + PLATE_PHASES + TRACK_PHASES:
            calls += ["with tempfile.TemporaryDirectory(prefix='ab-') as tmp:",
                      "    tmp = pathlib.Path(tmp)"]
            if p in PLATE_PHASES:
                calls.append(f"    cs.phase_{p}(card, tmp, cs.seeded_fit_plate(tmp, card))")
            elif p in TRACK_PHASES:
                calls.append(f"    cs.phase_{p}(card, tmp, *cs.dynaclr_plate(tmp, card))")
            else:
                calls.append(f"    cs.phase_{p}(card, tmp)")
        else:
            calls.append(f"cs.phase_{p}(card)" if p in CARD_PHASES else f"cs.phase_{p}()")
    return "\n".join([
        "import pathlib, sys, tempfile, time, torch",
        "sys.path.insert(0, '.')",
        "import chip_smoke as cs",
        "torch.backends.cuda.matmul.allow_tf32 = False",
        "torch.backends.cudnn.allow_tf32 = False",
        "t0 = time.perf_counter()",
        "card = cs.phase_env()",
        "cs.phase_build()",
        *calls,
        "cs.log(f'[done] {time.perf_counter() - t0:.1f} s')",
    ])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--phases", default="kernel_bwd,train")
    ap.add_argument("--out", type=Path, default=Path("ab_logs"))
    args = ap.parse_args()
    out_dir = args.out.resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    code = turn_code(args.phases.split(","))
    failed = 0
    for i, (label, tree) in enumerate([("old", args.old), ("new", args.new), ("new", args.new),
                                        ("old", args.old)]):
        log_path = out_dir / f"ab_{i}_{label}.log"
        with open(log_path, "w") as f:
            proc = subprocess.run([sys.executable, "-c", code], cwd=tree, stdout=f,
                                  stderr=subprocess.STDOUT, text=True)
        text = log_path.read_text()
        print(f"=== turn {i} ({label}, {tree}): exit {proc.returncode}", flush=True)
        for line in text.splitlines():
            if any(k in line for k in KEEP):
                print(f"  {line}", flush=True)
        if proc.returncode:
            failed += 1
            print("\n".join(text.splitlines()[-15:]), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
