"""The comparison that decides ``correct`` fails the faults a cell can
have, with the cells' own limits: the harness runs at a tiny size on the
CPU (past its look for a card) with the timed path broken underneath;
and the control, the reference computed in fp8 in the program's place,
fails them too."""
from __future__ import annotations

import json
import sys
import textwrap

import pytest
import torch

from _tiny import context, run

TRAIN_CELLS = ("unet.train", "moe_dit.train")


def unchanged(monkeypatch):
    """Every update leaves the state as it was: no parameter or moment
    moves."""
    from igm_tpu_torch.core.optim import OptimizerSet
    monkeypatch.setattr(OptimizerSet, "_apply", lambda self, *a, **k: None)


def half_batch(monkeypatch):
    """The loss is the mean over the first half of the batch alone."""
    from igm_tpu_torch.models.ddpm import DDPM
    loss = DDPM.loss

    def half(self, x_start, t, noise, y=None):
        h = x_start.shape[0] // 2
        return loss(self, x_start[:h], t[:h], noise[:h], None if y is None else y[:h])

    monkeypatch.setattr(DDPM, "loss", half)


def no_exchange(monkeypatch):
    """The ranks' gradients are not averaged: each applies its own."""
    from igm_tpu_torch.core.optim import OptimizerSet
    monkeypatch.setattr(OptimizerSet, "reduce_grads", lambda self, grads, params=(): grads)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "no_exchange": no_exchange}


class _Patch:
    def __init__(self):
        self.undo = []

    def setattr(self, owner, name, value):
        self.undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)


def _broken_rank(device, ctx, out, fault):
    from perfbench.generators import train
    FAULTS[fault](_Patch())
    train._spawned(device, ctx, out)


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("fault", ("unchanged", "half_batch"))
def test_train_fault_fails(cell, fault, monkeypatch):
    torch.set_num_threads(1)
    FAULTS[fault](monkeypatch)
    result = run(context(cell))
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("fault", ("unchanged", "half_batch", "no_exchange"))
def test_four_rank_fault_fails(fault, tmp_path):
    from igm_tpu_torch.parallel.launch import spawn
    out = tmp_path / "result.json"
    spawn(_broken_rank, 4, torch.device("cpu"), args=(context("moe_dit.train_dp4"),
                                                       str(out), fault), timeout=600)
    result = json.loads(out.read_text())
    assert result["correct"] is False, result["compared"]


def test_altered_answer_fails(monkeypatch):
    """The service's process adds 0.1 to every answer it produces."""
    from perfbench.generators import serve

    class Altered(serve.Server):
        command = (sys.executable, "-c", textwrap.dedent("""
            from igm_tpu_torch.tools.serve import SamplerService
            sample = SamplerService.sample
            SamplerService.sample = lambda self, seed: sample(self, seed) + 0.1
            from perfbench.generators.serve import server_main
            server_main()
        """))

    monkeypatch.setattr(serve, "Server", Altered)
    result = run(context("unet.serve"))
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("cell", TRAIN_CELLS + ("moe_dit.train_dp4",))
def test_control_fails(cell):
    """The reference in fp8 against the reference in float32, at the tiny
    size, fails the cell's limits."""
    from perfbench.generators import train
    torch.set_num_threads(1)
    ctx = context(cell)
    batch = int(ctx["mix"]["batch_size"])
    want = train.follow(ctx, torch.device("cpu"), batch)
    got = train.follow(ctx, torch.device("cpu"), batch, precision="fp8")
    from perfbench.harness.report import passed
    assert not passed(train.compare([got], want, ctx["cell"]["limits"]))


def test_serving_control_fails():
    from perfbench.harness.report import checks, passed
    from perfbench.generators import serve
    torch.set_num_threads(1)
    ctx = context("unet.serve")
    worst = {}
    for req in serve.request_seeds(2, 11):
        want = serve.reference_images(ctx, req, torch.device("cpu")).numpy()
        got = serve.reference_images(ctx, req, torch.device("cpu"), "fp8").numpy()
        for k, v in serve.gaps(got, want).items():
            worst[k] = max(worst.get(k, 0.0), v)
    assert not passed(checks(worst, ctx["cell"]["limits"]))
