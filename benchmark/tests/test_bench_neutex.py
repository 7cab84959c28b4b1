"""NeuTex's cell (train_neutex_cell.py) at a small size: the reference
against the port's NeuTex, a run that is correct and checks what its
limits name, a run with its timed path broken underneath that is not, the
control and the planted faults, the work count, the readers, and a
reference that imports nothing of the program."""
import os
import subprocess
import sys

import pytest
import torch

from benchmark import inputs, reference, reference_neutex, train_neutex_cell, work_neutex
from benchmark.common import Ctx
from benchmark.registry import ROOT, Registry
from benchmark.run import run_cell
from benchmark.tests.conftest import edit_json, make_small_bench

CELL = "neutex_cat.train_full_shuffle"
SEED = 2**31 + 61
B, BLOCKS = 512, 300

torch.set_num_threads(4)


@pytest.fixture
def neutex_bench(tmp_path):
    """The benchmark at small scale with NeuTex at its own widths: 300
    blocks of 512 hits on a 320-face blob. The epoch is long enough for a
    check epoch that reads every step's first hyper row to shrink its
    steps past the limits (the fault's effect grows with the epoch's
    steps: at 100 blocks it reads 0.03-0.04 in epoch_change_scale_gap),
    the batch large enough for the float32 chaos of the check epoch
    (train_neutex_cell.py) to stay inside them (at 256 rows a batch one
    seed in six of the program's own read 0.053 there)."""
    root, _ = make_small_bench(tmp_path)

    def small(d):
        d["training"]["batch_size"] = B
        d["train_data"] = {"mesh": {"kind": "blob", "subdivisions": 2, "bump": 0.15},
                           "num_hits": B * BLOCKS}
    edit_json(root / "benchmark" / "configs" / "neutex_cat.json", small)
    return root, Registry(root=str(root))


def _ctx(reg, seed):
    w = reg.workload(CELL)
    return Ctx(cfg=reg.config(w["config"]), traffic=reg.traffic(w["traffic"]),
               limits=reg.limits(CELL), seed=seed, seconds=0.2, trace=False,
               device=torch.device("cpu"))


def test_reference_matches_the_port(neutex_bench):
    """Loss and every gradient of the reference against the port's
    NeuTexTrainWrapper on seeded weights (biases drawn too, so each bias
    term is checked) at 512 rows."""
    _, reg = neutex_bench
    cfg = reg.config("neutex_cat")
    cell = train_neutex_cell.NeuTexCell(_ctx(reg, SEED))
    model = cell.program_model("cpu")
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    p = inputs.initial_weights(shapes, inputs.generator(3, "cpu"), "cpu")
    g = inputs.generator(4, "cpu")
    p = {k: v if v.dim() == 2 else 0.1 * torch.randn(v.shape, generator=g) for k, v in p.items()}
    model.load_state_dict(p)
    a = train_neutex_cell.train_arrays(cfg, 5, "cpu")
    x = reference.interpolate(a["vertices"], a["vids"][:512], a["bary"][:512])
    y = a["rgbs"][:512]
    want, _ = model.loss_and_rgbs(x, y)
    want_g = torch.autograd.grad(want, list(model.parameters()))
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    got = reference_neutex.loss(leaves, cfg, x, y)
    got_g = torch.autograd.grad(got, list(leaves.values()), allow_unused=True)
    # the same f32 operations in another order (F.linear's addmm against
    # x @ W^T + b, autograd's accumulation of the sphere point's three uses):
    # a few ulps of the loss, and of each gradient's largest element
    assert abs(got.item() - want.item()) <= 1e-6 * abs(want.item())
    for (name, _), gw, gg in zip(model.named_parameters(), want_g, got_g):
        gg = torch.zeros_like(gw) if gg is None else gg
        assert float((gg - gw).abs().max()) <= 1e-5 * float(gw.abs().max()) + 1e-12, name


def test_small_cell_is_correct(neutex_bench):
    _, reg = neutex_bench
    out, metrics = run_cell(reg, CELL, SEED, 0.2, 0, torch.device("cpu"))
    assert out.correct, out.checks
    assert set(out.checks) == set(reg.limits(CELL))
    assert set(metrics) == {"gathered_train_rays_per_s", "setup_s"}
    assert out.attempted > 0 and out.record["steps"] == out.attempted * BLOCKS


def _state_unchanged(steps):
    return {"fused_adam_apply": lambda *args, **kwargs: None}  # params and moments stay


def _half_batch(steps):
    orig = steps.self_loss_fn

    def self_loss_fn(model, layout, xyz, gt):
        # the model's loss over the first half of the gathered rows
        half = orig(model, layout, xyz[:len(xyz) // 2], gt[:len(gt) // 2])

        def loss_and_pred(p):
            loss, pred = half(p)
            return loss, torch.cat([pred, pred])
        return loss_and_pred
    return {"self_loss_fn": self_loss_fn}


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
def test_fault_in_the_step_is_not_correct(neutex_bench, monkeypatch, fault):
    from intrinsic_neural_fields_tpu_torch.train import steps

    _, reg = neutex_bench
    for name, fn in fault(steps).items():
        monkeypatch.setattr(steps, name, fn)
    out, _ = run_cell(reg, CELL, SEED + 1, 0.2, 0, torch.device("cpu"))
    assert not out.correct, out.checks


def test_cycle_dropped_is_not_correct(neutex_bench, monkeypatch):
    from intrinsic_neural_fields_tpu_torch.models.neutex import NeuTexTrainWrapper

    def colour_only(self, xyz, expected_rgbs):
        rgbs = self.neutex(xyz, compute_inverse_mapping=False)["rgbs"]
        return ((rgbs - expected_rgbs) ** 2).mean(), rgbs  # no cycle term: the atlas untrained

    _, reg = neutex_bench
    monkeypatch.setattr(NeuTexTrainWrapper, "loss_and_rgbs", colour_only)
    out, _ = run_cell(reg, CELL, SEED + 2, 0.2, 0, torch.device("cpu"))
    assert not out.correct, out.checks


def test_control_and_planted_faults_are_not_correct(neutex_bench):
    _, reg = neutex_bench
    ctx = _ctx(reg, SEED + 3)
    readings = train_neutex_cell.readings(ctx, program=False)
    assert set(readings) == {"control", *train_neutex_cell.NEUTEX_FAULTS}
    for kind, numbers in readings.items():
        assert any(v > ctx.limits[k] for k, v in numbers.items()), (kind, numbers)


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -(1.0 + 2.0**-12), 3.0])
    want = torch.tensor([1.0 + 2.0**-10, 1.0, 1.0 + 2.0**-9, -1.0, 3.0])
    assert torch.equal(reference_neutex.tf32(x), want)  # ties to even


def test_work_matches_the_hand_count():
    """Forward 790,656 MACs a ray: the inverse map 3*128 + 2*128*128 +
    128*4 = 33,664, the atlas 3*512 + 2*512*512 + 512*3 = 527,360, the
    texture network 1023*128 + 6*128*128 + 128*3 = 229,632. A step adds
    the weight gradients (the same again) and the input gradients of every
    layer but the inverse map's first (790,656 - 384): 2 (2 * 790,656 +
    790,272) = 4,743,168 FLOPs."""
    cfg = Registry().config("neutex_cat")
    assert work_neutex.forward_macs(cfg) == 790_656
    assert work_neutex.train_flops_per_ray(cfg) == 4_743_168
    assert work_neutex.f32_peak("NVIDIA H100 80GB HBM3") == 67e12
    assert work_neutex.f32_peak("cpu") is None


def test_readers(monkeypatch):
    from intrinsic_neural_fields_tpu_torch.ops import launches

    MS = 1_000_000
    cfg = Registry().config("neutex_cat")
    kind = "NVIDIA H100 80GB HBM3"
    records = [{"name": "train.epoch", "id": 1, "parent": None, "start_ns": 0, "end_ns": 100 * MS,
                "attrs": {"steps": 4}}]
    for i, (s, e) in enumerate([(0, 10), (20, 40), (50, 56), (70, 90)]):
        records.append({"name": "train.autograd", "id": 2 + i, "parent": 1, "start_ns": s * MS,
                        "end_ns": e * MS, "attrs": {"rows": 4096}})
    monkeypatch.setattr(launches, "spans", lambda t0, t1: (records, 0))
    # the device busy in [5, 25) and [80, 100) of a 100-ms window: idle
    # inside train.autograd in [0, 5), [25, 40), [50, 56), [70, 80)
    run = {"kind": "train", "cfg": cfg, "batch": 4096, "steps": 4, "window_s": 0.1,
           "device_kind": kind, "dev": [("k", 5 * MS, 25 * MS), ("k", 80 * MS, 100 * MS),
                                        ("late", 150 * MS, 160 * MS)],
           "t0": 0, "t1": 100 * MS, "busy_s": 0.04, "traced_s": 0.1}
    read = Registry().reader
    assert read("neutex.train_mfu")(run) == pytest.approx(
        100.0 * 4_743_168 * 4096 * 4 / (0.1 * 67e12))
    assert read("neutex.autograd_ms")(run) == pytest.approx(15.0)  # 10, 20, 6, 20
    assert read("neutex.idle_in_autograd_share")(run) == pytest.approx(36.0)
    assert read("neutex.device_ops_per_step")(run) == pytest.approx(0.5)
    for name in ("neutex.train_mfu", "neutex.autograd_ms", "neutex.idle_in_autograd_share",
                 "neutex.device_ops_per_step"):
        assert read(name)({"kind": "render"}) is None
    assert read("neutex.train_mfu")({**run, "cfg": Registry().config("intrinsic_cat")}) is None
    # a program without these spans (the parent of the change that added them)
    monkeypatch.setattr(launches, "spans", lambda t0, t1: (records[:1], 0))
    assert read("neutex.train_mfu")(run) is None
    assert read("neutex.autograd_ms")(run) is None
    assert read("neutex.idle_in_autograd_share")(run) is None


def test_reference_imports_no_program_and_no_jax():
    code = ("import sys, benchmark.reference_neutex, benchmark.work_neutex\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', "
            "'optax', 'intrinsic_neural_fields_tpu', 'intrinsic_neural_fields_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=300, env={**os.environ, "USE_FLAX": "0"})
    assert out.stdout.strip().splitlines()[-1] == "[]"
