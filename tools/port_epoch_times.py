#!/usr/bin/env python
"""Trainer epoch times of a tree of the port, and the epoch order's draw
beside torch.randperm, on one NVIDIA GPU.

  python tools/port_epoch_times.py --prepare DIR
  python tools/port_epoch_times.py --tree TREE --data DIR [--epochs 8]

--prepare makes the HQ recipe's data in DIR with chip_smoke.py's hq_prep and
hq_pipeline phases (the 20,480-face blob, k=512 eigenfunctions, 753,701
train rays from 20 views at 256^2).

--tree imports the port from TREE (a checkout of any commit of it: one
call can time a parent and a change) and trains through its Trainer, on
DIR's data, for --epochs epochs each:
  - hq_full: configs/synthetic/intrinsic_blob_hq.yaml (k=512, 6 x 128,
    skip 3, L1, batch 4096, bf16 table, fused_mlp) with `shuffle: full`,
    the default of every config that sets no shuffle
    (configs/texture_reconstruction/*): each epoch draws a permutation of
    every ray on the card and gathers its batches;
  - viewdep_blocks: configs/synthetic/viewdep_intrinsic_blob.yaml on the
    same data (`shuffle: blocks`, one graph replay per epoch).
One JSON line per leg: the Trainer's own "Train Rays-per-sec" and epoch
seconds per epoch (its clock from the epoch's call to its loss on the
host: the order's draw included), and their median past the first epoch.
Where TREE draws JAX's orders (utils/jax_random.py), one more line: the
full shuffle's draw, permutation(fold_in(PRNGKey(0), e), n) on the card,
beside torch.randperm(n) on the card, host milliseconds to a synchronised
result and CUDA-event milliseconds, each the median of 20 calls. Then the
card's name and power limit (nvidia-smi).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
HQ = {"num_layers": 6, "mlp_hidden_dim": 128, "skip_layer_idx": 3}
VIEWDEP = {"bottleneck_vec_dim": 128, "include_view_dir": True, "embed_size": 4,
           "directional_hidden_dim": 128, "in_dim_view_dir": 1, "strategy": "intrinsic"}


def prepare(out):
    sys.path.insert(0, ROOT)
    import chip_smoke
    from intrinsic_neural_fields_tpu_torch.ops import _build

    _build.BUILD_DIR = os.path.abspath(out)  # hq_prep writes under BUILD_DIR/hq_pipeline
    prep = chip_smoke.phase_hq_prep()
    chip_smoke.phase_hq_preprocess(prep)
    keep = {k: prep[k] for k in ("root", "data", "mesh_path", "efuncs_path")}
    keep["pre"] = os.path.join(prep["root"], "preprocessed")
    with open(os.path.join(out, "prep.json"), "w") as f:
        json.dump(keep, f)
    print(json.dumps({"prepared": keep}), flush=True)


def config(p, out_dir, epochs, shuffle, viewdep):
    cfg = {
        "seed": 0,
        "data": {
            "precompute_dtype": "bfloat16",
            "preproc_data_path_train": os.path.join(p["pre"], "train"),
            "preproc_data_path_eval": os.path.join(p["pre"], "val"),
            "preproc_data_path_test": os.path.join(p["pre"], "test"),
            "eigenfunctions_path": p["efuncs_path"], "mesh_path": p["mesh_path"],
            "img_height": 256, "img_width": 256,
            "eval_render_input_paths": [], "eval_render_img_names": [],
        },
        "model": {"k": 512, **HQ},
        "training": {
            "out_dir": out_dir, "batch_size": 4096, "lr": 0.0001, "loss_type": "L1",
            "render_every": 100, "print_every": 100, "epochs": epochs,
            "checkpoint_every": 1000, "shuffle": shuffle, "fused_mlp": True,
        },
    }
    if viewdep:
        cfg["model"]["view_dependence"] = dict(VIEWDEP)
    return cfg


class Recorder:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, global_step=None):
        self.scalars.append((tag, float(value)))

    def add_image(self, *args, **kwargs):
        pass

    def values(self, tag):
        return [v for t, v in self.scalars if t == tag]


def time_tree(tree, data_dir, epochs):
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from intrinsic_neural_fields_tpu_torch.data.sampler import num_train_batches
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh
    from intrinsic_neural_fields_tpu_torch.train import (Trainer, get_data, get_model_and_optim,
                                                         get_renderer)

    with open(os.path.join(data_dir, "prep.json")) as f:
        p = json.load(f)
    mesh = load_mesh(p["mesh_path"])
    n = None
    for leg, shuffle, viewdep in (("hq_full", "full", False),
                                  ("viewdep_blocks", "blocks", True)):
        out_dir = os.path.join(data_dir, f"out_{leg}")
        shutil.rmtree(out_dir, ignore_errors=True)  # no checkpoint of an earlier run to resume
        cfg = config(p, out_dir, epochs, shuffle, viewdep)
        model, optimizer = get_model_and_optim(cfg, mesh)
        data = get_data(cfg, mesh)
        n = data["train"].n
        rec = Recorder()
        trainer = Trainer(model, optimizer, "L1", get_renderer(cfg, model, mesh), data, mesh,
                          cfg, writer=rec)
        trainer.train()
        torch.cuda.synchronize()
        rays = rec.values("Train Rays-per-sec")
        epoch_s = [num_train_batches(n, 4096, trainer.drop_last) * 4096 / r for r in rays]
        print(json.dumps({"leg": leg, "tree": tree, "n": n, "shuffle": shuffle,
                          "train_rays_per_s": rays, "epoch_s": epoch_s,
                          "median_rays_per_s": float(np.median(rays[1:])),
                          "median_epoch_ms": 1e3 * float(np.median(epoch_s[1:]))}), flush=True)
        del trainer, model, data
    try:
        from intrinsic_neural_fields_tpu_torch.utils.jax_random import (PRNGKey, fold_in,
                                                                        permutation)
    except ImportError:
        return
    dev = torch.device("cuda")

    def timed(fn):
        host, card = [], []
        for e in range(22):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            fn(e)
            end.record()
            torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t0))
            card.append(start.elapsed_time(end))
        return float(np.median(host[2:])), float(np.median(card[2:]))

    perm = timed(lambda e: permutation(fold_in(PRNGKey(0), e), n, device=dev))
    randperm = timed(lambda e: torch.randperm(n, device=dev))
    print(json.dumps({"draw": "full_shuffle", "tree": tree, "n": n,
                      "permutation_host_ms": perm[0], "permutation_card_ms": perm[1],
                      "randperm_host_ms": randperm[0], "randperm_card_ms": randperm[1]}),
          flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--prepare", metavar="DIR")
    parser.add_argument("--tree")
    parser.add_argument("--data", metavar="DIR")
    parser.add_argument("--epochs", type=int, default=8)
    args = parser.parse_args(argv)
    if args.prepare:
        os.makedirs(args.prepare, exist_ok=True)
        prepare(args.prepare)
    else:
        time_tree(args.tree, args.data, args.epochs)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
