"""The port's metric sinks against the JAX package's: `WandbSink` logs on
without wandb when `wandb.init` fails (no network, no credentials), as
`omnibiote_tpu/training/metrics.py` does, and mirrors each record with its
token count as the step when it works. A fake `wandb` module stands in."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import sys
import types
import warnings

import pytest

from omnibiote_tpu.training import metrics as jax_metrics
from omnibiote_tpu_torch.training import metrics as port_metrics


def _fake_wandb(monkeypatch, init):
    mod = types.ModuleType("wandb")
    mod.init = init
    monkeypatch.setitem(sys.modules, "wandb", mod)


class _Run:
    def __init__(self):
        self.logged, self.finished = [], False

    def log(self, record, step=None):
        self.logged.append((record, step))

    def finish(self):
        self.finished = True


@pytest.mark.parametrize("module", [jax_metrics, port_metrics], ids=["jax", "port"])
def test_wandb_sink_carries_on_when_init_raises(monkeypatch, module):
    def init(**_):
        raise RuntimeError("no network")

    _fake_wandb(monkeypatch, init)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sink = module.WandbSink(project="p", enabled=True)
    assert sink._run is None
    sink.log({"loss": 1.0, "tokens": 8})
    sink.close()


@pytest.mark.parametrize("module", [jax_metrics, port_metrics], ids=["jax", "port"])
def test_wandb_sink_logs_to_a_working_run(monkeypatch, module):
    run = _Run()
    seen = {}
    _fake_wandb(monkeypatch, lambda **kw: seen.update(kw) or run)
    sink = module.WandbSink(project="omnibiota-test", enabled=True)
    record = {"loss": 2.5, "tokens": 4096}
    sink.log(record)
    sink.close()
    assert seen == {"project": "omnibiota-test"}
    assert run.logged == [(record, 4096)] and run.finished


def test_wandb_sink_is_off_by_default_in_the_port(monkeypatch):
    def init(**_):
        raise AssertionError("wandb.init called")

    _fake_wandb(monkeypatch, init)
    sink = port_metrics.WandbSink()
    sink.log({"tokens": 1})
    sink.close()
    assert sink._run is None
