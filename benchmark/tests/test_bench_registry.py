"""A configuration, a traffic mix, a per-layer metric and a cell added as
new files and entries are found by name; no harness file changes."""
import json
import shutil

import torch

from benchmark.registry import Registry
from benchmark.run import result_line, run_cell


def test_new_files_and_entries_are_found(small_bench):
    root, _ = small_bench
    b = root / "benchmark"
    shutil.copy(b / "configs" / "intrinsic_cat.json", b / "configs" / "intrinsic_cat_wide.json")
    with open(b / "configs" / "intrinsic_cat_wide.json") as f:
        cfg = json.load(f)
    cfg["train_data"]["num_hits"] = cfg["training"]["batch_size"] * 90
    with open(b / "configs" / "intrinsic_cat_wide.json", "w") as f:
        json.dump(cfg, f)
    with open(b / "traffic" / "train_blocks.json") as f:
        traffic = json.load(f)
    traffic["check_steps"] = 2
    with open(b / "traffic" / "train_two_checks.json", "w") as f:
        json.dump(traffic, f)
    (b / "metrics" / "train.epochs_in_window.py").write_text(
        "def read(run):\n    return run['steps'] / 90 if run['kind'] == 'train' else None\n")
    shutil.copy(b / "limits" / "intrinsic_cat.train_blocks.json",
                b / "limits" / "intrinsic_cat_wide.train_two_checks.json")
    with open(root / "BENCHMARK.json") as f:
        spec = json.load(f)
    spec["configs"].append({"name": "intrinsic_cat_wide", "source": "a test",
                            "file": "benchmark/configs/intrinsic_cat_wide.json", "reduced": [],
                            "why": "a test"})
    cell = "intrinsic_cat_wide.train_two_checks"
    spec["workloads"].append({"name": cell, "config": "intrinsic_cat_wide",
                              "traffic": "train_two_checks", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_rays_per_s":
            m["workloads"].append(cell)
    spec["per_layer"].append({"name": "train.epochs_in_window", "unit": "epochs",
                              "better": "higher", "source": "program_counter",
                              "layer": "train/steps.py epoch (EpochGraph)",
                              "moves": "train_rays_per_s", "workloads": [cell]})
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(spec, f)

    reg = Registry(root=str(root))
    out, metrics = run_cell(reg, cell, 5, 0.2, 0, torch.device("cpu"))
    assert set(metrics) == {"train_rays_per_s", "setup_s"}
    assert out.correct and set(out.checks) == set(reg.limits(cell))
    out, metrics = run_cell(reg, cell, 5, 0.2, 1, torch.device("cpu"))
    assert metrics["train.epochs_in_window"]["value"] == out.record["steps"] / 90
    assert out.record["steps"] % 90 == 0  # 90 blocks per epoch
    line = result_line(out, metrics, {})
    assert line["correct"] is True
