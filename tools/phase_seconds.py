#!/usr/bin/env python3
"""Run a tree's ``chip_smoke.py`` with the wall seconds of each phase recorded.

    python3 tools/phase_seconds.py TREE [--out FILE]

``TREE`` holds its own ``chip_smoke.py`` and ``viscy_tpu_torch/`` (for
example ``git archive`` of a commit unpacked into a git-ignored directory).
Every phase function that ``chip_smoke.main`` calls is wrapped in a timer
before ``main`` runs in this process, so a tree whose script does not print
its own ``{"phase_seconds": ...}`` line is measured the same way as one that
does. After ``main`` returns, one JSON line ``{"phase_seconds": {name:
seconds}}`` is printed (and written to ``FILE``); a function called more than
once sums its calls, and a phase that runs inside another (phase 22 (a)-(b)
inside the build) is also inside that phase's seconds.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
from pathlib import Path

PHASES = (
    "phase_build", "phase_celldiff_sampling", "phase_kernel", "phase_kernel_bwd", "phase_warp", "phase_slice",
    "phase_train", "phase_fit", "phase_cli", "phase_stages", "phase_dynacell_eval", "phase_qc", "phase_pretrain",
    "phase_unext2", "phase_legacy", "phase_gan", "phase_ddp", "phase_tta", "phase_seg", "phase_transforms",
    "phase_datamodules", "phase_dynaclr", "phase_dynaclr_cli", "phase_callbacks", "foundation_leg",
    "classification_leg", "phase_dynaclr_eval", "phase_joint", "phase_vae", "phase_celldiff",
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", type=Path)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    tree = args.tree.resolve()
    out = args.out.resolve() if args.out else None
    os.chdir(tree)
    sys.path.insert(0, str(tree))
    import chip_smoke as cs

    seconds: dict[str, float] = {}

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

        return run

    for name in PHASES:
        if hasattr(cs, name):
            setattr(cs, name, timed(name, getattr(cs, name)))
    t0 = time.perf_counter()
    try:
        cs.main()
    finally:
        seconds["total"] = time.perf_counter() - t0
        line = json.dumps({"phase_seconds": {k: round(v, 1) for k, v in seconds.items()}})
        print(line, flush=True)
        if out is not None:
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(line + "\n")


if __name__ == "__main__":
    main()
