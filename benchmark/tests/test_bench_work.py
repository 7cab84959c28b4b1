"""The work counts against the hand counts."""
import json
import os

import pytest

from benchmark import work

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


# intrinsic_cat: forward 1023*128 (input) + 3 * 128*128 (hidden) + 128*128 +
# 1023*128 (skip) + 128*3 (head) = 327,808 MACs; input gradients of the four
# hidden-input layers and the head 4 * 16,384 + 384 = 65,920; per ray
# 2 (2 * 327,808 + 65,920) = 1,443,072 FLOPs.
# viewdep_intrinsic_blob: spatial 512*128 + 3 * 128*128 + 128*128 + 512*128
# + 128*128 (bottleneck) = 212,992, directional (128 + 9)*128 + 128*3 =
# 17,920: 230,912 MACs; input gradients 5 * 16,384 (hidden inputs) + 128*128
# (the bottleneck rows of the directional layer) + 384 = 98,688; per ray
# 2 (2 * 230,912 + 98,688) = 1,121,024 FLOPs.
HAND = {
    "intrinsic_cat": dict(fwd=327_808, igrad=65_920, train=1_443_072, params=328_579),
    "viewdep_intrinsic_blob": dict(fwd=230_912, igrad=98_688, train=1_121_024,
                                   params=231_939),
}


@pytest.mark.parametrize("name", sorted(HAND))
def test_counts_match_the_hand_counts(name):
    cfg, h = config(name), HAND[name]
    assert work.forward_macs(cfg) == h["fwd"]
    assert work.input_grad_macs(cfg) == h["igrad"]
    assert work.train_flops_per_ray(cfg) == h["train"]
    assert work.forward_flops_per_ray(cfg) == 2 * h["fwd"]
    assert work.param_count(cfg) == h["params"]


@pytest.mark.parametrize("name", sorted(HAND))
def test_param_count_matches_the_port_model(name):
    import numpy as np
    from types import SimpleNamespace

    from intrinsic_neural_fields_tpu_torch.models import make_model

    cfg = config(name)
    mesh = SimpleNamespace(face_normals=np.ones((4, 3)))
    model = make_model({**cfg["model"], "k": cfg["k"]}, device="cpu", mesh=mesh)
    assert sum(p.numel() for p in model.parameters()) == work.param_count(cfg)


def test_cat_step_is_compute_bound_at_the_hand_count():
    cfg = config("intrinsic_cat")
    B = cfg["training"]["batch_size"]
    # 4096 rows of 1023 bf16 features + f32 targets, and 328,579 f32
    # parameters with two Adam moments, each read and written
    assert work.train_step_bytes(cfg, B) == 4096 * (1023 * 2 + 12) + 24 * 328_579
    t = work.least_seconds(1_443_072 * B, work.train_step_bytes(cfg, B),
                           "NVIDIA H100 80GB HBM3")
    assert t == pytest.approx(1_443_072 * 4096 / 989e12)


def test_a_card_without_peaks_has_no_roofline():
    cfg = config("intrinsic_cat")
    assert work.peaks("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    assert work.peaks("cpu") is None
    assert work.least_seconds(1.0, 1.0, "another card") is None
