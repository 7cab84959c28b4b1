#!/usr/bin/env python
"""The README's 400-epoch HQ recipe over several seeds, for one or more
trees of the port, on one NVIDIA GPU.

  python tools/port_recipe_seeds.py --seeds 0,1,2,3 [--tree NAME=DIR ...]
      [--epochs 400] [--config configs/synthetic/<recipe>.yaml] [--out DIR]

Makes the recipe's data once in this tree (``data/synthetic_hq`` through
the README's generator, eigenfunction and cache CLIs; skipped when its test
cache exists). Then, for each seed, trains and evaluates
``configs/synthetic/intrinsic_blob_hq.yaml`` (or the recipe --config names,
on the same data) with ``seed`` set to it (the seed draws the initial
weights, an RFF field's projection and every epoch's batch order) through each
tree's own ``python -m`` CLIs, run from that tree's root. The trees of one
seed run side by side as concurrent processes: the chain is deterministic,
so a result does not depend on what else runs (the times do). ``--tree``
defaults to ``this=<this tree>``; a second tree is e.g. an earlier commit
unpacked by ``git archive`` into an ignored directory.

Prints one JSON line per run (tree, seed, test PSNR and DSSIM from the
eval CLI, train seconds), one per tree with the mean, sample standard
deviation, min and max test PSNR, then the card's name and power limit.
Logs and outputs go under ``--out`` (default ``out/recipe_seeds``).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

import yaml

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = "intrinsic_neural_fields_tpu_torch"
CONFIG = os.path.join(ROOT, "configs", "synthetic", "intrinsic_blob_hq.yaml")
DATA = os.path.join(ROOT, "data", "synthetic_hq")


def _run(cmd, cwd, log):
    with open(log, "w") as f:
        subprocess.run(cmd, cwd=cwd, stdout=f, stderr=subprocess.STDOUT, check=True)


def make_data(out):
    """The README's preprocessing steps, once."""
    if os.path.isdir(os.path.join(DATA, "preprocessed", "test")):
        return
    py = [sys.executable, "-m"]
    steps = [[*py, f"{PKG}.make_synthetic_dataset", DATA, "--H", "256", "--W", "256",
              "--n_train", "20", "--subdivisions", "5"],
             [*py, f"{PKG}.preprocess_eigenfunctions", f"{DATA}/efuncs", f"{DATA}/blob.obj",
              "512"]]
    steps += [[*py, f"{PKG}.preprocess_dataset", f"{DATA}/preprocessed", f"{DATA}/blob.obj",
               DATA, split] for split in ("train", "val", "test")]
    for i, cmd in enumerate(steps):
        _run(cmd, ROOT, os.path.join(out, f"prep_{i}.log"))


def write_config(path, out_dir, seed, epochs, config=CONFIG):
    """The HQ config (or another recipe's, `config`) with this seed, its
    data paths absolute, its outputs in out_dir (which the train CLI must
    not find), written to path."""
    with open(config) as f:
        cfg = yaml.safe_load(f)
    cfg["seed"] = seed
    cfg["training"]["epochs"] = epochs
    cfg["training"]["out_dir"] = out_dir
    data = cfg["data"]
    for key, val in data.items():
        if isinstance(val, str) and val.startswith("data/"):
            data[key] = os.path.join(ROOT, val)
    data["eval_render_input_paths"] = [os.path.join(ROOT, p)
                                       for p in data["eval_render_input_paths"]]
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def run_seed(trees, seed, epochs, out, config=CONFIG):
    """Train every tree on this seed concurrently, then evaluate each."""
    runs = {}
    for name, root in trees.items():
        run_dir = os.path.join(out, f"{name}_s{seed}")
        cfg = write_config(os.path.join(out, f"{name}_s{seed}.yaml"), run_dir, seed, epochs,
                           config)
        log = open(os.path.join(out, f"{name}_s{seed}_train.log"), "w")
        p = subprocess.Popen([sys.executable, "-m", f"{PKG}.train", cfg], cwd=root, stdout=log,
                             stderr=subprocess.STDOUT)
        runs[name] = (root, run_dir, cfg, log, p, time.perf_counter())
    rows = []
    for name, (root, run_dir, cfg, log, p, t0) in runs.items():
        if p.wait() != 0:
            raise RuntimeError(f"{name} seed {seed}: train failed, see {log.name}")
        train_s = time.perf_counter() - t0
        log.close()
        eval_log = os.path.join(out, f"{name}_s{seed}_eval.log")
        _run([sys.executable, "-m", f"{PKG}.eval", os.path.join(run_dir, "test_eval"), cfg, DATA,
              "test"], root, eval_log)
        with open(eval_log) as f:
            m = re.findall(r"PSNR: ([-0-9.einf]+), DSSIM: ([-0-9.einf]+)", f.read())
        if not m:
            raise RuntimeError(f"{name} seed {seed}: no PSNR line in {eval_log}")
        rows.append({"tree": name, "seed": seed, "test_psnr": float(m[-1][0]),
                     "dssim": float(m[-1][1]), "train_s": train_s})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--tree", action="append", default=None, help="NAME=DIR (repeatable)")
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--config", default=CONFIG, help="the recipe's YAML (default: the HQ one)")
    ap.add_argument("--out", default=os.path.join(ROOT, "out", "recipe_seeds"))
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree) if args.tree else {"this": ROOT}
    trees = {name: os.path.abspath(root) for name, root in trees.items()}
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    make_data(out)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        for r in run_seed(trees, seed, args.epochs, out, os.path.abspath(args.config)):
            print(json.dumps(r), flush=True)
            rows.append(r)
    for name in trees:
        psnr = [r["test_psnr"] for r in rows if r["tree"] == name]
        print(json.dumps({"tree": name, "seeds": len(psnr), "mean_test_psnr": statistics.mean(psnr),
                          "std_test_psnr": statistics.stdev(psnr) if len(psnr) > 1 else None,
                          "min_test_psnr": min(psnr), "max_test_psnr": max(psnr)}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
