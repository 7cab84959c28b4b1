"""The check fails what it has to fail: a run with its timed path broken
underneath comes out not correct, once for each fault a cell can have, and
so does the control, the reference in the precision below the
configuration's put in the program's place (here at a small size; on the
card at the cell's own size by ``benchmark.control``)."""
import pytest
import torch

import importlib

import numpy as np

from benchmark import inputs, reference
from benchmark.common import Ctx
from benchmark.run import run_cell

TRAIN = ["intrinsic_cat.train_blocks", "viewdep_intrinsic_blob.train_blocks"]
RENDER = "intrinsic_cat.render_orbit"
GATHERED = "intrinsic_cat.train_full_shuffle"


def _state_unchanged(orig):
    def step(*args, **kwargs):
        return None  # the step leaves params, moments and sums as they were
    return step


def _half_batch(orig):
    def step(layout, params, m, v, hyper_all, order, i, feats, targets, B, *rest, **kw):
        # the same block's first half, its mean over those rows
        return orig(layout, params, m, v, hyper_all, order * 2, i, feats, targets, B // 2,
                    *rest, **kw)
    return step


def _order_ignored(orig):
    def step(layout, params, m, v, hyper_all, order, i, *rest, **kw):
        # block i, not block order[i]
        return orig(layout, params, m, v, hyper_all, torch.arange(len(order)).to(order), i,
                    *rest, **kw)
    return step


def _hyper_row0(orig):
    def step(layout, params, m, v, hyper_all, order, i, *rest, **kw):
        # every step of the epoch with its first step's bias corrections
        return orig(layout, params, m, v, hyper_all[:1].expand_as(hyper_all), order, i,
                    *rest, **kw)
    return step


def test_the_check_epoch_order_is_not_the_identity(small_bench):
    _, reg = small_bench
    for w in TRAIN:  # so that _order_ignored changes what the epoch trains
        cfg = reg.config(reg.workload(w)["config"])
        nb = cfg["train_data"]["num_hits"] // cfg["training"]["batch_size"]
        assert not np.array_equal(inputs.epoch_order(21, nb), np.arange(nb))


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _order_ignored, _hyper_row0])
def test_train_fault_is_not_correct(small_bench, monkeypatch, workload, fault):
    from intrinsic_neural_fields_tpu_torch.train import steps

    _, reg = small_bench
    monkeypatch.setattr(steps, "fused_train_adam_step", fault(steps.fused_train_adam_step))
    out, _ = run_cell(reg, workload, 21, 0.2, 0, torch.device("cpu"))
    assert not out.correct, out.checks


def _answer_altered(orig):
    def infer(self, trace, bg, dev=None):
        rgb, valid = orig(self, trace, bg, dev)
        return torch.roll(rgb, 64, 0), valid  # every colour lands 64 rays off
    return infer


def _half_rays(orig):
    def infer(self, trace, bg, dev=None):
        rgb, valid = orig(self, trace, bg, dev)
        rgb = rgb.clone()
        rgb[::2] = 255 if rgb.dtype == torch.uint8 else bg  # half the rays never shaded
        return rgb, valid
    return infer


@pytest.mark.parametrize("fault", [_answer_altered, _half_rays])
def test_render_fault_is_not_correct(small_bench, monkeypatch, fault):
    from intrinsic_neural_fields_tpu_torch.render.renderer import Renderer

    _, reg = small_bench
    monkeypatch.setattr(Renderer, "_infer", fault(Renderer._infer))
    out, _ = run_cell(reg, RENDER, 22, 0.3, 0, torch.device("cpu"))
    assert not out.correct, out.checks


def _ctx(reg, workload, seed):
    w = reg.workload(workload)
    return Ctx(cfg=reg.config(w["config"]), traffic=reg.traffic(w["traffic"]),
               limits=reg.limits(workload), seed=seed, seconds=0.2, trace=False,
               device=torch.device("cpu"))


@pytest.mark.parametrize("workload", TRAIN + [RENDER, GATHERED])
def test_control_and_planted_faults_are_not_correct(small_bench, workload):
    _, reg = small_bench
    ctx = _ctx(reg, workload, 23)
    readings = importlib.import_module(f"benchmark.{ctx.traffic['generator']}").readings(
        ctx, program=False)
    for kind, numbers in readings.items():
        assert any(v > ctx.limits[k] for k, v in numbers.items()), (kind, numbers)


def test_fp8_rounds_to_e4m3_under_one_scale():
    x = torch.tensor([448.0, 1.0, 0.3, -7.0])
    assert torch.equal(reference.fp8(x), torch.tensor([448.0, 1.0, 0.3125, -7.0]))
    y = reference.fp8(x * 1e-6) / 1e-6  # the scale follows the largest magnitude
    assert torch.allclose(y, torch.tensor([448.0, 1.0, 0.3125, -7.0]), rtol=1e-5)
