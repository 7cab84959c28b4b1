#!/usr/bin/env python
"""Why one f32 BatchNorm train step of the port lies where it does from
the exact (f64) step, on the CPU.

  python tools/port_bn_step_precision.py [--seed 0] [--rows 4096]
      [--loss L1|L2] [--variance flax|f64] [--threads 4]

The HQ field with `batchnorm: true` (k=512, 6 x 128, skip 3; make_model's
weights for --seed) takes one eager step on --rows seeded rows (a random
2,000-vertex table scaled by 0.05, bf16 hit features): on one device;
data-parallel over two CPU replicas (sync-BN); on one device with the rows
permuted and with them reversed. Each step's gradient (Adam's first moment
over 0.1) is held to the f64 autograd gradient of the same loss on the same
rows. For each step the JSON line gives:

  - max_err_rel: its largest error over the largest f64 gradient entry,
    and the parameter it sits in;
  - relu_flips: the hidden entries whose ReLU branch in the f32 forward
    differs from the f64 forward's (a pre-activation within rounding of 0);
  - max_err_rel_own_branches: the error against the f64 step taken along
    the f32 forward's own branches (chip_smoke.relu_branches).

`--variance f64` takes the batch moments and the variance E[h^2] - E[h]^2
in f64 (the port's BatchNorm, as flax's, takes them in f32); `--loss L2`
trains on the squared error. If a step's error came from the variance's
cancellation or from an L1 residual's sign, these would move it; if it
comes from a ReLU branch, the error along the step's own branches falls to
f32 rounding. --threads fixes how the CPU splits the sums.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import replace

import numpy as np
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def f64_variance(tf):
    """Patch the port's BatchNorm to take its batch moments and variance in
    f64 (the normalised rows stay f32)."""
    stats = tf.BatchNorm.batch_stats
    tf.batch_moments = lambda h: torch.stack((h.double().mean(0), (h.double() ** 2).mean(0)))

    def batch_stats(self, moments):
        mean, var = stats(self, moments)
        if self.weight.dtype == torch.float32:
            mean, var = mean.float(), var.float()
        return mean, var

    tf.BatchNorm.batch_stats = batch_stats


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rows", type=int, default=4096)
    parser.add_argument("--loss", choices=("L1", "L2"), default="L1")
    parser.add_argument("--variance", choices=("flax", "f64"), default="flax")
    parser.add_argument("--threads", type=int, default=4,
                        help="torch CPU threads (they split the sums)")
    args = parser.parse_args(argv)
    torch.set_num_threads(args.threads)
    sys.path.insert(0, ROOT)
    from chip_smoke import relu_branches
    from intrinsic_neural_fields_tpu_torch.data.sampler import RayData, precompute_hit_features
    from intrinsic_neural_fields_tpu_torch.models import make_model
    from intrinsic_neural_fields_tpu_torch.models import texture_field as tf
    from intrinsic_neural_fields_tpu_torch.parallel import make_dp_epoch_fns
    from intrinsic_neural_fields_tpu_torch.parallel.data_parallel import HIT_FIELDS
    from intrinsic_neural_fields_tpu_torch.train.losses import get_loss_fn
    from intrinsic_neural_fields_tpu_torch.train.steps import (AdamHyper, create_train_state,
                                                               make_epoch_fns)

    if args.variance == "f64":
        f64_variance(tf)
    cfg = {"k": 512, "num_layers": 6, "mlp_hidden_dim": 128, "skip_layer_idx": 3,
           "batchnorm": True}
    n, V, D = args.rows, 2000, 2
    rng = np.random.default_rng(args.seed)
    data = precompute_hit_features(RayData(
        torch.from_numpy((rng.normal(size=(V, 512)) * 0.05).astype(np.float32)), "efuncs",
        torch.from_numpy(rng.integers(0, V, (n, 3))),
        torch.from_numpy(rng.dirichlet(np.ones(3), n).astype(np.float32)),
        torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32))), dtype=torch.bfloat16)
    model = make_model(cfg, seed=args.seed, device="cpu")
    rows = {"one_device": torch.arange(n), "data_parallel": torch.arange(n),
            "reversed": torch.arange(n - 1, -1, -1),
            "permuted": torch.randperm(n, generator=torch.Generator().manual_seed(args.seed))}

    def step(kind):
        """The f32 step's gradient and its ReLU masks per layer, in the
        table's row order."""
        st = create_train_state(model, AdamHyper(1e-4), "cpu")
        idx = rows[kind]
        with relu_branches() as masks:
            if kind == "data_parallel":
                train, _ = make_dp_epoch_fns(model, args.loss, ["cpu"] * D, shuffle="blocks")
                train(st, np.zeros((D, 1), np.int64), data, 1, n)
            else:
                train, _ = make_epoch_fns(model, args.loss, shuffle="blocks")
                train(st, np.zeros(1, np.int64),
                      replace(data, **{f: getattr(data, f)[idx] for f in HIT_FIELDS
                                       if getattr(data, f) is not None}), 1, n)
        if kind == "data_parallel":  # replica d's layer l is call l D + d
            masks = [torch.cat(masks[i * D:(i + 1) * D]) for i in range(len(masks) // D)]
        own = []
        for m in masks:
            o = torch.empty_like(m)
            o[idx] = m
            own.append(o)
        return st.layout.state_dict(st.mu / 0.1, "cpu"), own

    def exact(force=None):
        """The f64 gradient, and the f64 forward's ReLU masks."""
        m64 = make_model(cfg, seed=args.seed, device="cpu").double().train()
        with relu_branches(force) as masks:
            pred = m64(data.hit_features.to(torch.float64), train=True)
        get_loss_fn(args.loss)(pred, data.expected_rgbs.to(torch.float64)).backward()
        return {k: p.grad for k, p in m64.named_parameters()}, masks

    g64, masks64 = exact()
    scale = max(float(g.abs().max()) for g in g64.values())

    def err(g, ref):
        return max((float((g[k].double() - ref[k]).abs().max()) / scale, k) for k in ref)

    out = {"rows": n, "seed": args.seed, "loss": args.loss, "variance": args.variance,
           "largest_f64_gradient": scale}
    for kind in rows:
        g, masks = step(kind)
        e, name = err(g, g64)
        e_own, _ = err(g, exact(masks)[0])
        out[kind] = {"max_err_rel": e, "in": name,
                     "relu_flips": int(sum((a != b).sum() for a, b in zip(masks, masks64))),
                     "max_err_rel_own_branches": e_own}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
