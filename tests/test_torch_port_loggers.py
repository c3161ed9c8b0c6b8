"""The port's metric sinks against viscy_tpu's: the TensorBoard event file
(written by hand, ``training/tb_events.py``) and the W&B logger factory.

The same ``log_metrics`` calls go to the port's ``CSVLogger`` and to the
JAX one (tensorboardX's ``SummaryWriter``); read back with tensorboard's
own event-file loader (its CRC checks included), both files hold the file
version record and the same tags, steps and values in the same order, and
the CSV lines are equal. ``build_loggers_from_config`` maps the same
configs to the same sinks on both sides: none for TensorBoard / CSV
configs, none with a log line for W&B without the package or credentials,
and with them (a stand-in ``wandb`` module, ``WANDB_MODE=offline``) one
logger that calls ``wandb.init`` with the same run name, group and job
type. A failing extra sink does not stop the logger."""

import json
import logging
import sys
import types

import pytest

from viscy_tpu.training import loggers as jloggers
from viscy_tpu.training.trainer import CSVLogger as JCSVLogger
from viscy_tpu_torch.training import loggers as tloggers
from viscy_tpu_torch.training.trainer import CSVLogger

CALLS = [
    ({"loss/train": 0.8125, "lr": 2e-5, "step_time_ms": 153.25}, 1),
    ({"loss/train": 0.5, "lr": 3.1e-5, "step_time_ms": 140.0}, 2),
    ({"loss/validate": 0.61}, 2),
    ({"test/metrics/ssim": 0.25, "test/loss": -1.5e-7}, 0),
]


def _events(log_dir):
    # the stub keeps the loader from importing TensorFlow when it is installed
    sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))
    from tensorboard.backend.event_processing.event_file_loader import LegacyEventFileLoader

    (path,) = log_dir.glob("events.out.tfevents.*")
    events = list(LegacyEventFileLoader(str(path)).Load())
    assert events[0].file_version == "brain.Event:2"
    return [(e.step, v.tag, v.simple_value) for e in events[1:] for v in e.summary.value]


def test_event_file_equals_tensorboardx(tmp_path):
    port, jax_side = CSVLogger(tmp_path / "port"), JCSVLogger(tmp_path / "jax", use_tensorboard=True)
    for metrics, step in CALLS:
        port.log_metrics(metrics, step)
        jax_side.log_metrics(metrics, step)
    port.close()
    jax_side.close()
    got, want = _events(tmp_path / "port"), _events(tmp_path / "jax")
    assert got == want and len(got) == 9
    assert (tmp_path / "port" / "metrics.csv").read_text() == (tmp_path / "jax" / "metrics.csv").read_text()


def test_extra_sinks_get_every_line_and_a_failing_one_is_logged(tmp_path, caplog):
    seen = []

    class Sink:
        def log_metrics(self, metrics, step):
            seen.append((step, dict(metrics)))

        def close(self):
            seen.append("closed")

    class Broken:
        def log_metrics(self, metrics, step):
            raise OSError("network down")

        def close(self):
            pass

    logger = CSVLogger(tmp_path, use_tensorboard=False, extra=[Broken(), Sink()])
    with caplog.at_level(logging.WARNING, logger="viscy_tpu_torch"):
        for metrics, step in CALLS:
            logger.log_metrics(metrics, step)
    logger.close()
    assert seen == [(s, m) for m, s in CALLS] + ["closed"]
    assert "failed" in caplog.text and not list(tmp_path.glob("events.out.tfevents.*"))
    assert [json.loads(x)["step"] for x in (tmp_path / "metrics.csv").read_text().splitlines()] == [1, 2, 2, 0]


CONFIGS = [
    None,
    {"class_path": "lightning.pytorch.loggers.TensorBoardLogger", "init_args": {"save_dir": "logs"}},
    [{"class_path": "lightning.pytorch.loggers.CSVLogger"}, "not a dict"],
    {"class_path": "lightning.pytorch.loggers.WandbLogger", "init_args": {"project": "vs", "name": "run1"}},
    [{"class_path": "pytorch_lightning.loggers.WandbLogger"}, {"class_path": "my.pkg.WandbLogger"}],
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=["none", "tensorboard", "csv+junk", "wandb", "two-wandb"])
def test_no_wandb_maps_every_config_to_the_built_in_sinks(cfg, monkeypatch, caplog):
    monkeypatch.delenv("WANDB_API_KEY", raising=False)
    monkeypatch.delenv("WANDB_MODE", raising=False)
    with caplog.at_level(logging.INFO):
        got, want = tloggers.build_loggers_from_config(cfg, "fit"), jloggers.build_loggers_from_config(cfg, "fit")
    assert got == want == []
    assert tloggers.wandb_available() is jloggers.wandb_available() is False
    wandb_cfg = "Wandb" in json.dumps(cfg)
    assert ("wandb is unavailable" in caplog.text) is wandb_cfg


@pytest.mark.parametrize("cfg", CONFIGS, ids=["none", "tensorboard", "csv+junk", "wandb", "two-wandb"])
def test_with_wandb_both_sides_start_the_same_runs(cfg, monkeypatch):
    calls = []

    class Run:
        def __init__(self, kw):
            self.kw, self.logged = kw, []

        def log(self, values, step):
            self.logged.append((step, values))

        def finish(self):
            pass

    def init(**kw):
        calls.append(kw)
        return Run(kw)

    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(init=init))
    monkeypatch.setenv("WANDB_MODE", "offline")
    monkeypatch.setenv("VISCY_WANDB_GROUP", "sweep-7")
    got = tloggers.build_loggers_from_config(cfg, "test")
    port_calls, calls[:] = list(calls), []
    want = jloggers.build_loggers_from_config(cfg, "test")
    assert len(got) == len(want) >= 1 and all(s.active for s in got)
    strip = lambda kw: {k: (v[16:] if k == "name" else v) for k, v in kw.items()}  # the timestamp prefix
    assert [strip(c) for c in port_calls] == [strip(c) for c in calls]
    assert all(c["group"] == "sweep-7" and c["job_type"] == "test" for c in port_calls)
    got[0].log_metrics({"loss": 1}, 3)
    assert got[0]._run.logged == [(3, {"loss": 1.0})]


def test_run_names_are_stamped_once():
    for name in ("run", "20260101-120000_run"):
        assert tloggers.prefix_run_name(name, "20261017-090000") == jloggers.prefix_run_name(name, "20261017-090000")
    assert tloggers.prefix_run_name("20260101-120000_run") == "20260101-120000_run"
