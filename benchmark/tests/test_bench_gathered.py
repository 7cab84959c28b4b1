"""The gathered train cell (train_gathered_cell.py) at a small size: a run
is correct and checks what its limits name, a run with its timed path
broken underneath is not, and its readers read what the train readers
read."""
import numpy as np
import pytest
import torch

from benchmark import work
from benchmark.registry import Registry
from benchmark.run import run_cell

CELL = "intrinsic_cat.train_full_shuffle"


def test_gathered_cell_is_correct(small_bench):
    _, reg = small_bench
    out, metrics = run_cell(reg, CELL, 2**31 + 31, 0.2, 0, torch.device("cpu"))
    assert out.correct, out.checks
    assert set(out.checks) == set(reg.limits(CELL))
    assert set(metrics) == {"gathered_train_rays_per_s", "setup_s"}
    assert out.attempted > 0 and out.record["steps"] == out.attempted * 100


def test_check_rows_are_permutations(small_bench):
    """The check steps train their blocks' rows, each in an order that is
    not the identity; the check epoch every record once."""
    from benchmark.common import Ctx
    from benchmark.train_gathered_cell import TrainGatheredCell

    _, reg = small_bench
    w = reg.workload(CELL)
    ctx = Ctx(cfg=reg.config(w["config"]), traffic=reg.traffic(w["traffic"]),
              limits=reg.limits(CELL), seed=2**31 + 32, seconds=0.1, trace=False,
              device=torch.device("cpu"))
    cell = TrainGatheredCell(ctx)
    cell.draw({"w": (4, 4)})
    B, n = cell.B, len(cell.arrays["rgbs"])
    rows = cell.step_rows(cell.order)
    assert len(rows) == 3 + n // B
    for b, r in zip(cell.blocks, rows[:3]):
        assert sorted(r) == list(range(b * B, (b + 1) * B)) and list(r) != sorted(r)
    assert sorted(np.concatenate(rows[3:])) == list(range(n))
    assert not np.array_equal(cell.order, np.arange(n))


def _state_unchanged(steps):
    def adam(*args, **kwargs):
        return None  # params and moments stay as they were
    return {"fused_adam_apply": adam}


def _half_batch(steps):
    orig = steps.fused_train_grads

    def grads(layout, params, x, gt, block, B, *rest, **kw):
        # the mean over the first half of the gathered rows
        return orig(layout, params, x[:B // 2], gt[:B // 2], block, B // 2, *rest, **kw)
    return {"fused_train_grads": grads}


def _order_ignored(steps):
    orig = steps.batch_at

    def batch_at(data, order, i, B, blocks, start=0):
        # the records in turn, not in the epoch's permutation
        return orig(data, torch.arange(len(order)).clamp(max=data.n - 1).to(order), i, B,
                    blocks, start)
    return {"batch_at": batch_at}


def _hyper_row0(steps):
    orig = steps.epoch_hyper_rows

    def rows(state, num_batches):
        # every step of the epoch with its first step's bias corrections
        r = orig(state, num_batches)
        return r[:1].expand_as(r)
    return {"epoch_hyper_rows": rows}


def _block0(steps):
    orig = steps.batch_at

    def batch_at(data, order, i, B, blocks, start=0):
        return orig(data, order, 0, B, blocks, start)  # the first B records every step
    return {"batch_at": batch_at}


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _order_ignored, _hyper_row0,
                                   _block0])
def test_gathered_fault_is_not_correct(small_bench, monkeypatch, fault):
    from intrinsic_neural_fields_tpu_torch.train import steps

    _, reg = small_bench
    for name, fn in fault(steps).items():
        monkeypatch.setattr(steps, name, fn)
    out, _ = run_cell(reg, CELL, 2**31 + 33, 0.2, 0, torch.device("cpu"))
    assert not out.correct, out.checks


def test_gathered_readers_read_the_train_readers():
    cfg = Registry().config("intrinsic_cat")
    kind = "NVIDIA H100 80GB HBM3"
    run = {"kind": "train", "cfg": cfg, "batch": 4096, "steps": 1024, "window_s": 2.0,
           "launches": {"fused_mlp_fwd_bwd": 1024, "fused_mlp_wgrad": 1024, "fused_adam": 1024},
           "device_kind": kind, "dev": [("k", 0, 1)], "busy_s": 1.5, "traced_s": 2.0}
    read = Registry().reader
    mfu = 100.0 * 1_443_072 * 4096 * 1024 / (2.0 * work.PEAKS[kind]["bf16_flops"])
    assert read("gathered.train_mfu")(run) == pytest.approx(mfu)
    assert read("gathered.idle_share")(run) == pytest.approx(25.0)
    assert read("gathered.launches_per_step")(run) == pytest.approx(3.0)
    for name, train_name in (("gathered.train_mfu", "train_mfu"),
                             ("gathered.idle_share", "train.idle_share"),
                             ("gathered.launches_per_step", "train.launches_per_step")):
        assert read(name)(run) == read(train_name)(run)
        assert read(name)({"kind": "render"}) is None
