#!/usr/bin/env python
"""Data-parallel training and the D-way render of the port across distinct
cards, against the same run with one card repeated in the device list and
against one device.

  python tools/port_dp_cards.py [--devices 4] [--device cuda] [--rows 753664]
      [--k 512] [--epochs 2] [--views 8] [--size 256]

On the HQ recipe's network (6 x 128, skip 3, k=512, L1, Adam lr 1e-4,
batch 4096, a bf16 table streamed in blocks, fused_mlp) over `--rows` random
records (the HQ train split's 184 blocks of 4096 by default: a random
[V=10242, k] feature table, random hits, targets a fixed sigmoid map of the
features):
  - DP epochs over cuda:0 ... cuda:D-1 ("cards") and over D times cuda:0
    ("repeated"), the same block orders: params, moments and losses of the
    two equal to the bit, every replica equal to the bit, each kernel
    launched once per replica per step; epoch wall times (host clock to a
    sync of every card) beside the one-device graph epoch's;
  - the all-reduce of the flat gradient (host clock over 50 calls, every
    card synchronised) on the cards and on the repeated card;
  - one sync-BN DP step (batchnorm: true, the eager step) on the cards and
    on the repeated card: replicas equal to the bit, the loss and running
    statistics equal to the bit across the two lists, the gradient within
    chip_smoke.py's DP gates (autograd sums cross-replica contributions in
    the order its per-device threads finish);
  - `--views` ring views of a seeded 6 x 128 field on the 20,480-face blob
    (random k-wide vertex features) rendered D-way on the cards and on one
    device: images and hit sets equal to the bit, the forward kernel
    launched as often.
`--device cpu` rehearses the same steps with D CPU replicas on both lists
(use a small --rows and --k). Prints one JSON line per step, then the first
card's name and power limit (nvidia-smi). Exits non-zero when a check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

HQ = {"num_layers": 6, "mlp_hidden_dim": 128, "skip_layer_idx": 3}
B = 4096
LR = 1e-4


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"port_dp_cards: {msg}")


def emit(step, **fields):
    print(json.dumps({"step": step, **fields}), flush=True)


def sync(devices):
    for dev in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(dev)


def make_data(rows, k, device, seed=0):
    """Random records: features, hits, a bf16 table of the interpolated
    rows and targets sigmoid(row @ W) of the table's rows, on `device`."""
    from dataclasses import replace

    from intrinsic_neural_fields_tpu_torch.data.sampler import RayData, precompute_hit_features

    g = torch.Generator().manual_seed(seed)
    V = 10242
    e = -torch.log(torch.rand(rows, 3, generator=g))  # Dirichlet(1, 1, 1) barycentrics
    data = RayData(torch.randn(V, k, generator=g).to(device), "efuncs",
                   torch.randint(0, V, (rows, 3), generator=g).to(device),
                   (e / e.sum(1, keepdim=True)).to(device), torch.zeros(rows, 3, device=device))
    data = precompute_hit_features(data, dtype=torch.bfloat16)
    W = (torch.randn(k, 3, generator=g) * (0.3 / np.sqrt(k / 16))).to(device)
    rgbs = torch.cat([torch.sigmoid(data.hit_features[s:s + 65536].float() @ W)
                      for s in range(0, rows, 65536)])
    return replace(data, expected_rgbs=rgbs)


def dp_run(cfg, devices, data, epochs, nb):
    """DP epochs from the seeded model; (state, losses, epoch seconds,
    launches, replicas equal)."""
    from intrinsic_neural_fields_tpu_torch.models import make_model
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.parallel import make_dp_epoch_fns
    from intrinsic_neural_fields_tpu_torch.train.steps import AdamHyper, create_train_state
    from intrinsic_neural_fields_tpu_torch.utils.jax_random import PRNGKey, fold_in

    model = make_model(cfg, seed=0, device=devices[0])
    train, _ = make_dp_epoch_fns(model, "L1", devices, shuffle="blocks", fused=True)
    state = create_train_state(model, AdamHyper(LR), devices[0])
    losses, secs = [], []
    reset_kernel_launches()
    for e in range(epochs):
        sync(devices)
        t0 = time.perf_counter()
        state, m = train(state, fold_in(PRNGKey(0), e), data, nb, B)
        losses.append(float(m["loss"]))
        sync(devices)
        secs.append(time.perf_counter() - t0)
    launches = kernel_launches()
    reps = train.replicas.states
    equal = all(torch.equal(getattr(r, n).cpu(), getattr(reps[0], n).cpu())
                for r in reps[1:] for n in ("params", "mu", "nu"))
    return state, losses, secs, launches, equal


def graph_run(cfg, device, data, epochs, nb):
    """The one-device graph epochs' seconds (fused_adam: true)."""
    from intrinsic_neural_fields_tpu_torch.models import make_model
    from intrinsic_neural_fields_tpu_torch.train.steps import (AdamHyper, create_train_state,
                                                               make_epoch_fns)
    from intrinsic_neural_fields_tpu_torch.utils.jax_random import PRNGKey, fold_in

    model = make_model(cfg, seed=0, device=device)
    train, _ = make_epoch_fns(model, "L1", shuffle="blocks", fused=True)
    state = create_train_state(model, AdamHyper(LR), device)
    secs = []
    for e in range(epochs):
        sync([device])
        t0 = time.perf_counter()
        state, m = train(state, fold_in(PRNGKey(0), e), data, nb, B)
        float(m["loss"])
        secs.append(time.perf_counter() - t0)
    return secs


def allreduce_ms(devices, n, iters=50):
    from intrinsic_neural_fields_tpu_torch.parallel.data_parallel import mean_all_reduce

    g = [torch.randn(n, device=dev) for dev in devices]
    mean_all_reduce(g)
    sync(devices)
    t0 = time.perf_counter()
    for _ in range(iters):
        mean_all_reduce(g)
    sync(devices)
    return 1e3 * (time.perf_counter() - t0) / iters


def bn_step(cfg, devices, data):
    from intrinsic_neural_fields_tpu_torch.models import make_model
    from intrinsic_neural_fields_tpu_torch.parallel import make_dp_epoch_fns
    from intrinsic_neural_fields_tpu_torch.train.steps import AdamHyper, create_train_state

    model = make_model({**cfg, "batchnorm": True}, seed=0, device=devices[0])
    train, _ = make_dp_epoch_fns(model, "L1", devices, shuffle="blocks")
    state = create_train_state(model, AdamHyper(LR), devices[0])
    state, m = train(state, np.zeros((len(devices), 1), np.int64), data, 1, B)
    reps = train.replicas.states
    equal = all(torch.equal(getattr(r, n).cpu(), getattr(reps[0], n).cpu())
                for r in reps[1:] for n in ("params", "mu", "nu")) and all(
        torch.equal(r.batch_stats[k].cpu(), reps[0].batch_stats[k].cpu())
        for r in reps[1:] for k in reps[0].batch_stats)
    return state, float(m["loss"]), equal


def render_check(k, devices, views, size):
    from intrinsic_neural_fields_tpu_torch.geometry.synthetic import (blob_mesh, pinhole_K,
                                                                      ring_cameras)
    from intrinsic_neural_fields_tpu_torch.models import make_model
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.render.renderer import Renderer

    mesh = blob_mesh(5)
    efuncs = np.random.default_rng(1).normal(size=(mesh.num_vertices, k)).astype(np.float32)
    model = make_model({"k": k, **HQ}, seed=3, device=devices[0])
    K = pinhole_K(size, size)
    out = {}
    for name, devs in (("one", None), ("dway", devices)):
        r = Renderer(model, mesh, efuncs, H=size, W=size, device=devices[0], devices=devs)
        reset_kernel_launches()
        sync(devices)
        t0 = time.perf_counter()
        out[name] = [r.render(cam, K, eval_render=True) for cam in ring_cameras(views)]
        sync(devices)
        out[name + "_s"] = time.perf_counter() - t0
        out[name + "_launches"] = kernel_launches()["fused_mlp_fwd"]
    equal = [bool(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))
             for a, b in zip(out["one"], out["dway"])]
    return equal, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rows", type=int, default=184 * B)
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    args = ap.parse_args(argv)
    from intrinsic_neural_fields_tpu_torch.devices import resolve_devices

    D = args.devices
    if args.device == "cuda":
        from intrinsic_neural_fields_tpu_torch.ops._build import build_all

        build_all(["fused_mlp_fwd", "fused_mlp_train", "fused_adam"])  # in parallel

        cards, repeated = resolve_devices(D), resolve_devices(["cuda:0"] * D)
    else:
        cards = repeated = resolve_devices(["cpu"] * D)
    check(args.rows % B == 0, "--rows must be a multiple of 4096")
    nb = args.rows // B
    cfg = {"k": args.k, **HQ}
    data = make_data(args.rows, args.k, cards[0])
    emit("setup", cards=[str(d) for d in cards], rows=args.rows, k=args.k, steps_per_epoch=nb,
         torch=torch.__version__, cuda=torch.version.cuda)

    runs = {}
    for name, devs in (("cards", cards), ("repeated", repeated)):
        state, losses, secs, launches, equal = dp_run(cfg, devs, data, args.epochs, nb)
        runs[name] = state
        check(equal, f"{name}: the replicas differ")
        if args.device == "cuda":  # the CPU runs the plain twins
            check(all(launches[n] == args.epochs * nb * D for n in
                      ("fused_mlp_fwd_bwd", "fused_mlp_wgrad", "fused_adam")),
                  f"{name}: launches {launches}")
        check(losses[-1] < losses[0], f"{name}: loss did not fall {losses}")
        emit("dp_epochs", devices=name, losses=losses, epoch_s=secs,
             step_wall_ms=[1e3 * s / nb for s in secs], replicas_bit_equal=equal,
             launches={n: v for n, v in launches.items() if v})
    same = all(torch.equal(getattr(runs["cards"], n).cpu(), getattr(runs["repeated"], n).cpu())
               for n in ("params", "mu", "nu"))
    check(same, "the cards' run differs from the repeated card's")
    secs = graph_run(cfg, cards[0], data, args.epochs, nb)
    emit("one_device_graph", epoch_s=secs, step_wall_ms=[1e3 * s / nb for s in secs],
         cards_equal_repeated_to_the_bit=same)
    n = runs["cards"].layout.n
    emit("allreduce", n=n, cards_ms=allreduce_ms(cards, n), repeated_ms=allreduce_ms(repeated, n))

    bn = {name: bn_step(cfg, devs, data) for name, devs in (("cards", cards),
                                                            ("repeated", repeated))}
    (a, loss_a, reps_equal), (b, loss_b, _) = bn["cards"], bn["repeated"]
    stats_same = all(torch.equal(v.cpu(), b.batch_stats[key].cpu())
                     for key, v in a.batch_stats.items())
    mu_rel = float((a.mu.cpu() - b.mu.cpu()).abs().max() / b.mu.abs().max().cpu())
    params_max = float((a.params.cpu() - b.params.cpu()).abs().max())
    # The forward (and so the running statistics and the loss) is the same
    # arithmetic on either list. The backward's gradient contributions that
    # cross replicas are summed by autograd's per-device threads in the
    # order they finish, so on distinct cards the gradient may differ from
    # the repeated card's by f32 rounding: held to chip_smoke.py's DP gates
    # (first moment 1e-4 of its largest entry, params 2 lr + 1e-6).
    check(reps_equal and stats_same and loss_a == loss_b and mu_rel <= 1e-4
          and params_max <= 2 * LR + 1e-6,
          f"sync-BN: the cards' step departs from the repeated card's: {reps_equal}, "
          f"{stats_same}, {loss_a} vs {loss_b}, {mu_rel}, {params_max}")
    emit("sync_bn_step", loss=loss_a, replicas_bit_equal=reps_equal,
         stats_equal_repeated_to_the_bit=stats_same,
         params_equal_repeated_to_the_bit=torch.equal(a.params.cpu(), b.params.cpu()),
         mu_rel_vs_repeated=mu_rel, params_max_abs_vs_repeated=params_max)

    equal, out = render_check(args.k, cards, args.views, args.size)
    check(all(equal) and out["one_launches"] == out["dway_launches"]
          and (out["one_launches"] > 0 or args.device == "cpu"),
          f"the D-way render differs from the one-device render: {equal}, "
          f"{out['one_launches']} vs {out['dway_launches']}")
    emit("dway_render", views=args.views, size=args.size, bit_equal=equal,
         launches=out["dway_launches"], one_device_launches=out["one_launches"],
         dway_s=out["dway_s"], one_device_s=out["one_s"])
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
