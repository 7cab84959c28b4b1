#!/usr/bin/env python
"""Where the fwd_bwd kernel and its plain twin part on one batch: the
bf16 activations each rounds differently, on one NVIDIA GPU.

  python tools/port_fwd_bwd_flips.py [--shapes 1x1023,64x1023,65x1023]
      [--dtypes bf16,f32] [--seed 1]

Each shape is set up as tests/test_torch_port_cuda.py's
test_fwd_bwd_kernel_matches_plain_twin sets up the plain field (6 x 128,
skip 3; make_model(seed) weights; features and targets from a CUDA
generator seeded `seed`), the kernel launched in L2 mode beside the twin.
Per shape and init it prints one JSON line:

  - loss_rel: the kernel's loss sum against the twin's;
  - mismatches: per hidden layer, the bf16 activations that differ, and the
    largest distance between the two in bf16 ulps;
  - first_layer: at the first layer that differs (its inputs equal in both),
    each differing entry's pre-activation in f64, and its distance to the
    midpoint between the kernel's and the twin's bf16 values, in f32 ulps
    of the pre-activation: the f32 sums of the two orders round to either
    side of that midpoint only when it is a few ulps away;
  - loss_rel_own_acts: the kernel's loss sum against the twin's epilogue
    (head, sigmoid, L2) run on the kernel's own last activations.

`--init` also runs the weights the port drew before it drew JAX's
(Xavier-uniform from torch.Generator(seed) in module order, zero biases),
as a control. Card only; a few seconds.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def torch_init(model, seed):
    """The port's init before it drew the JAX package's."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Linear):
                fan_out, fan_in = mod.weight.shape
                bound = (6.0 / (fan_in + fan_out)) ** 0.5
                mod.weight.uniform_(-bound, bound, generator=g)
                mod.bias.zero_()


def bf16_ulps(a, b):
    """Distance between bf16 values in bf16 ulps (same sign assumed; relu
    outputs are >= 0)."""
    ia = a.to(torch.bfloat16).view(torch.int16).to(torch.int64)
    ib = b.to(torch.bfloat16).view(torch.int16).to(torch.int64)
    return (ia - ib).abs()


def one(B, k, dtype, seed, init):
    from intrinsic_neural_fields_tpu_torch.models import make_model
    from intrinsic_neural_fields_tpu_torch.ops import fused_mlp as F
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import FusedMLPSpec, ParamLayout

    cuda = torch.device("cuda")
    cfg = {"k": k, "num_layers": 6, "mlp_hidden_dim": 128, "skip_layer_idx": 3}
    layout = ParamLayout(FusedMLPSpec(6, k, 128, 3))
    model = make_model(cfg, seed=seed, device="cpu")
    if init == "torch":
        torch_init(model, seed)
    params = layout.flat_from_state_dict(model.state_dict(), cuda)
    g = torch.Generator(device=cuda).manual_seed(seed)
    N = B + 64
    feats = (torch.rand(N, k, generator=g, device=cuda) - 0.5).to(dtype)
    gt = torch.rand(N, 3, generator=g, device=cuda)[:B].contiguous()
    sc = F.make_train_scratch(layout, B, params)
    F._launch_fwd_bwd(layout, params, feats, 0, B, gt, F.LOSS_MODES["L2"], 1 / (3 * B), sc)
    acts_t, _, _, loss_t, _ = F.fwd_bwd_plain(layout, params, feats[:B], gt, "L2")
    torch.cuda.synchronize()
    nblk, nh, H = -(-B // 64), len(layout.layers), 128
    loss_k = sc.loss_part.view(nblk, 2).sum(0)[0].item()
    A_k = sc.acts[:nh * B * H].float().view(nh, B, H)
    A_t = acts_t.float().view(nh, B, H)
    diff = [(A_k[i] != A_t[i]) for i in range(nh)]
    out = {"B": B, "k": k, "dtype": str(dtype).split(".")[-1], "init": init,
           "loss_rel": abs(loss_k / loss_t.item() - 1),
           "mismatches": [[int(d.sum()), int(bf16_ulps(A_k[i][d], A_t[i][d]).max())
                           if d.any() else 0] for i, d in enumerate(diff)]}
    first = next((i for i, d in enumerate(diff) if d.any()), None)
    if first is not None:
        mats = [m.to(torch.float64) for m in layout.mats(params)]
        mats = [F._bf16(m.float()).double() for m in mats]
        biases = [b.double() for b in layout.biases(params)]
        lay = layout.layers[first]
        ins, ws = [], []
        if lay.h is not None:
            e, r0, n = lay.h
            ins.append(A_t[first - 1].double())
            ws.append(mats[e][r0:r0 + n])
        if lay.ext is not None:
            e, r0, n, _ = lay.ext
            ins.append(F._bf16(feats[:B, :k].float()).double())
            ws.append(mats[e][r0:r0 + n])
        z = torch.cat(ins, 1) @ torch.cat(ws, 0)
        for bi in lay.biases:
            z = z + biases[bi]
        rows, cols = torch.nonzero(diff[first], as_tuple=True)
        zz = z[rows, cols]
        mid = (A_k[first][rows, cols].double() + A_t[first][rows, cols].double()) / 2
        ulp32 = torch.from_numpy(np.spacing(zz.float().abs().cpu().numpy())).double()
        out["first_layer"] = {"layer": first, "entries": [
            {"pre_f64": float(a), "kernel": float(b), "twin": float(c),
             "f32_ulps_from_midpoint": float(d)}
            for a, b, c, d in zip(zz.tolist(), A_k[first][rows, cols].tolist(),
                                  A_t[first][rows, cols].tolist(),
                                  ((zz - mid).abs().cpu() / ulp32).tolist())][:16]}
    mats32 = [F._bf16(m) for m in layout.mats(params)]
    z = A_k[nh - 1] @ mats32[layout.head] + layout.biases(params)[layout.head]
    loss_own, _, _ = F._loss_and_grad("L2", torch.sigmoid(z[:, :3]), gt, 1.0 / (B * 3))
    out["loss_rel_own_acts"] = abs(loss_k / loss_own.sum().item() - 1)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shapes", default="1x1023,64x1023,65x1023")
    parser.add_argument("--dtypes", default="bf16,f32")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--init", default="jax,torch")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    for shape in args.shapes.split(","):
        B, k = (int(v) for v in shape.split("x"))
        for dt in args.dtypes.split(","):
            for init in args.init.split(","):
                print(json.dumps(one(B, k, dtypes[dt], args.seed, init)), flush=True)
    import subprocess

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
