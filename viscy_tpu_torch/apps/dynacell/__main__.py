"""``dynacell`` command line, the virtual-staining benchmark (counterpart of
``viscy_tpu/apps/dynacell/__main__.py``):

    python -m viscy_tpu_torch.apps.dynacell [--device cuda|cpu] <subcommand> ...

    python -m viscy_tpu_torch.apps.dynacell fit -c unetvit3d/fit.yml
    python -m viscy_tpu_torch.apps.dynacell precompute-gt -c eval.yml
    python -m viscy_tpu_torch.apps.dynacell evaluate -c eval.yml
    python -m viscy_tpu_torch.apps.dynacell evaluate-grouped -c grouped.yml
    python -m viscy_tpu_torch.apps.dynacell cross-condition-probe -d eval_mock -d eval_denv -o probe.csv

``fit``, ``predict``, ``test`` and ``validate`` run ``viscy-torch``'s
subcommand. The evaluation subcommands read JAX's plain YAML configs
(:mod:`viscy_tpu_torch.apps.dynacell.eval.pipeline`) and compute on
``--device``: the card unless ``cpu``; without a card ``cuda`` raises. The
subcommands of later slices raise with their name and what they wait for.
"""

from __future__ import annotations

import json
from pathlib import Path

import click
import yaml


@click.group()
@click.option("--device", default="cuda", show_default=True, help="where the evaluation computes: cuda or cpu")
@click.pass_context
def main(ctx: click.Context, device: str) -> None:
    """dynacell: virtual-staining benchmark framework."""
    ctx.obj = {"device": device}


def _device() -> str:
    return click.get_current_context().obj["device"]


def _config(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


@main.command()
@click.option("--config", "-c", required=True, type=click.Path(exists=True))
def evaluate(config: str) -> None:
    """Run the three-tier evaluation of one leaf config."""
    from viscy_tpu_torch.apps.dynacell.eval.pipeline import evaluate_model

    pixel, mask, feature = evaluate_model(_config(config), device=_device())
    click.echo(f"evaluated: {len(pixel)} pixel rows, {len(mask)} mask rows, {len(feature)} feature rows")


@main.command("evaluate-grouped")
@click.option("--config", "-c", required=True, type=click.Path(exists=True))
def evaluate_grouped(config: str) -> None:
    """Evaluate every condition of a group, then run the cross-condition probe."""
    from viscy_tpu_torch.apps.dynacell.eval.pipeline import evaluate_predictions_grouped

    results = evaluate_predictions_grouped(_config(config), device=_device())
    click.echo(f"evaluated conditions: {[name for name, _ in results]}")


@main.command("precompute-gt")
@click.option("--config", "-c", required=True, type=click.Path(exists=True))
def precompute_gt(config: str) -> None:
    """Fill the GT artifact cache so that evaluate runs hit it."""
    from viscy_tpu_torch.apps.dynacell.eval.pipeline import precompute_gt_artifacts

    click.echo(json.dumps(precompute_gt_artifacts(_config(config), device=_device()), indent=2))


@main.command("cross-condition-probe")
@click.option("--eval-dirs", "-d", multiple=True, required=True, type=click.Path(exists=True))
@click.option("--out", "-o", required=True, type=click.Path())
@click.option("--n-splits", default=5, type=int)
@click.option("--rng-seed", default=2020, type=int)
def cross_condition_probe(eval_dirs, out, n_splits, rng_seed) -> None:
    """Probe condition pairs across finished eval dirs (long-form CSV)."""
    from viscy_tpu_torch.apps.dynacell.eval.cross_condition import run

    path = run([Path(d) for d in eval_dirs], Path(out), n_splits=n_splits, rng_seed=rng_seed, device=_device())
    click.echo(f"wrote {path}")


WAITING = {
    "report": "tables.py (model-comparison tables) and a plotting library (matplotlib, absent on the card's machine)",
    "spectral-eval": "spectral_eval.py and decorr.py (the per-position spectral time series)",
    "simulate-beads": "simulate_beads.py (its figures need matplotlib, absent on the card's machine)",
    "spectral-diagnostic": "diagnostics.py and decorr.py (matplotlib, absent on the card's machine)",
    "spectral-plot-combined": "diagnostics.py (matplotlib, absent on the card's machine)",
    "shading-analysis": "diagnostics.py (matplotlib, absent on the card's machine)",
}


def _waiting(name: str):
    @main.command(name, context_settings={"ignore_unknown_options": True, "allow_extra_args": True},
                  help=f"Not ported yet: waits for {WAITING[name]}.")
    def _cmd():
        raise NotImplementedError(f"dynacell {name} is not ported to viscy_tpu_torch yet: it waits for "
                                  f"{WAITING[name]} (ROADMAP.md Queue 1)")

    return _cmd


for _name in WAITING:
    _waiting(_name)


def _training(sub: str):
    @main.command(sub, context_settings={"ignore_unknown_options": True},
                  help=f"Run viscy-torch's `{sub}`.")
    @click.argument("args", nargs=-1, type=click.UNPROCESSED)
    def _cmd(args) -> None:
        from viscy_tpu_torch.training.cli import main as viscy_main

        return viscy_main([sub, *args])

    return _cmd


for _sub in ("fit", "predict", "test", "validate"):
    _training(_sub)


if __name__ == "__main__":
    main()
