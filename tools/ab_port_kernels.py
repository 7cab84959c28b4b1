#!/usr/bin/env python
"""A/B of design choices in the port's hand-written kernels, on one NVIDIA GPU.

  python tools/ab_port_kernels.py [--out FILE]

fwd_bwd (``csrc/fused_mlp_train.cu``): builds variants that take back one
part of its design at a time and times each against the kernel as shipped
on the same inputs (k=512, B=4096, the HQ layout and its view-dependent
tail):

  - ``sync_loads``: every cp.async copy becomes a synchronous 16-byte load
    and store (the weight tiles and feature chunks no longer overlap the
    products);
  - ``f32_weights``: the weight tiles are read from the f32 master and
    rounded to bf16 in the kernel (synchronously), not from the bf16 copy;
  - ``sync_f32``: both;
  - grid fill: the shipped kernel at B=2048 (32 clusters, 64 CTAs, half the
    card) beside B=4096 (64 clusters, 128 CTAs).

Every variant must give the shipped kernel's bits (the loads change, not the
arithmetic). The variants are made by replacing source text of the kernel,
and the script stops if a text to replace is not found exactly once.

The sort (``csrc/bitonic_argsort.cu``): above 2^18 keys, the plan's run size
(``ops/sort.py:sort_plan``'s ``run_log``, 2^11..2^18 words) on dense random
keys of 2^18+1, 2^20 and 2^22; each plan's order must equal
torch.sort(stable=True), and its CUDA launches the plan's.

Prints one JSON line per row, then the card's name and power limit. Needs
nvcc and a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from intrinsic_neural_fields_tpu_torch.models import make_model  # noqa: E402
from intrinsic_neural_fields_tpu_torch.ops import _build  # noqa: E402
from intrinsic_neural_fields_tpu_torch.ops import fused_mlp as F  # noqa: E402
from intrinsic_neural_fields_tpu_torch.ops import sort as S  # noqa: E402

SORT_SIZES = ((1 << 18) + 1, 1 << 20, 1 << 22)
SORT_RUN_LOGS = (11, 12, 14, 16, 18)
SYNC_CP16 = '''__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes = 16) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (src_bytes) v = *reinterpret_cast<const uint4*>(src);
  *reinterpret_cast<uint4*>(dst) = v;
}'''
F32_CPW = '''  __device__ __forceinline__ void cpw(void* dst, const __nv_bfloat16* src) const {
    const float* s = wf + (src - wb);
    const float4 a = *reinterpret_cast<const float4*>(s);
    const float4 b = *reinterpret_cast<const float4*>(s + 4);
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                                                pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
  }'''


def _variant_sources(src):
    """{name: source} with the substitutions made (each must apply)."""
    start = src.index("__device__ __forceinline__ void cp16(")
    cp16 = src[start:src.index("}\n", start) + 1]
    cpw = [ln for ln in src.splitlines() if "void cpw(" in ln]
    if len(cpw) != 1:
        raise RuntimeError("csrc/fused_mlp_train.cu: no single cpw() to ablate")

    def f32(code):  # the tiles read the f32 master (the kernel's params) instead of wb
        for old, new in (("  const __nv_bfloat16* wb;\n",
                          "  const __nv_bfloat16* wb;\n  const float* wf;\n"),
                         ("  f.wb = wb;\n", "  f.wb = wb;\n  f.wf = params;\n"),
                         (cpw[0], F32_CPW)):
            if code.count(old) != 1:
                raise RuntimeError(f"csrc/fused_mlp_train.cu: cannot ablate at {old!r}")
            code = code.replace(old, new)
        return code

    sync = src.replace(cp16, SYNC_CP16)
    return {"shipped": src, "sync_loads": sync, "f32_weights": f32(src), "sync_f32": f32(sync)}


def _build_variants():
    """Compile every variant in parallel into _build/ablate/; {name: path}."""
    with open(_build.SOURCES["fused_mlp_train"]) as f:
        sources = _variant_sources(f.read())
    out_dir = os.path.join(_build.BUILD_DIR, "ablate")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, code in sources.items():
        cu = os.path.join(out_dir, f"fused_mlp_train_{name}.cu")
        with open(cu, "w") as f:
            f.write(code)
        so = os.path.join(out_dir, f"libfused_mlp_train_{name}.so")
        procs[name] = (so, subprocess.Popen([_build._nvcc(), *_build._flags("fused_mlp_train"),
                                             "-o", so, cu], stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True))
    paths = {}
    for name, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{err}")
        paths[name] = so
    return paths


def cuda_ms(fn, iters=50, warmup=5):
    """Mean device time of fn() in ms (CUDA events around `iters` calls
    queued behind a device sleep, as chip_smoke.py times kernels)."""
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _case(viewdep, B, k=512, seed=0):
    """A seeded HQ-layout network (with the view-dependent tail), a bf16
    feature table of B rows (uniform in [-0.5, 0.5], as rescaled features),
    targets in [0, 1]; returns (layout, params, feats, vencs, gt)."""
    cfg = {"k": k, "num_layers": 6, "mlp_hidden_dim": 128, "skip_layer_idx": 3}
    mesh = None
    if viewdep:
        from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere

        mesh = icosphere(2)
        cfg["view_dependence"] = {"bottleneck_vec_dim": 128, "include_view_dir": True,
                                  "embed_size": 4, "directional_hidden_dim": 128,
                                  "in_dim_view_dir": 1, "strategy": "intrinsic"}
    model = make_model(cfg, seed=seed, device="cuda", mesh=mesh)
    layout = F.layout_for_model(model)
    params = layout.flat_from_state_dict(model.state_dict())
    g = torch.Generator(device="cuda").manual_seed(seed)
    feats = (torch.rand(B, k, generator=g, device="cuda") - 0.5).to(torch.bfloat16)
    vencs = None
    if viewdep:
        vencs = torch.zeros(B, layout.tail.venc_w, device="cuda", dtype=torch.bfloat16)
        vencs[:, :layout.tail.venc_in] = (torch.rand(B, layout.tail.venc_in, generator=g,
                                                     device="cuda") - 0.5).to(torch.bfloat16)
    gt = torch.rand(B, 3, generator=g, device="cuda")
    return layout, params, feats, vencs, gt


def sort_rows():
    """The sort on each plan: the module's sort_plan is swapped for one
    with the run size fixed while the wrapper runs it."""
    plan_of, rows = S.sort_plan, []
    g = torch.Generator(device="cuda").manual_seed(0)
    try:
        for E in SORT_SIZES:
            keys = torch.randint(0, E // 8, (E,), generator=g, device="cuda", dtype=torch.int32)
            want = torch.sort(keys, stable=True).indices
            for run_log in SORT_RUN_LOGS:
                S.sort_plan = lambda n, max_ctas=None, r=run_log: plan_of(n, max_ctas, r)
                try:
                    plan = S.sort_plan(E, S.device_max_ctas())
                except ValueError:  # a cooperative run whose CTAs the card cannot hold
                    rows.append({"sort_E": E, "run_log": run_log, "fits": False})
                    continue
                c0 = S.bitonic_argsort_vmem.cuda_launches
                got = S.bitonic_argsort_vmem(keys)
                torch.cuda.synchronize()
                launched = S.bitonic_argsort_vmem.cuda_launches - c0
                rows.append({"sort_E": E, "run_log": run_log, "ctas": plan.ctas,
                             "launches": launched,
                             "launches_as_planned": launched == len(plan.launches),
                             "equal_to_sort": torch.equal(got.long(), want),
                             "ms": cuda_ms(lambda: S.bitonic_argsort_vmem(keys))})
            rows.append({"sort_E": E, "torch_sort_ms": cuda_ms(
                lambda: torch.sort(keys, stable=True))})
    finally:
        S.sort_plan = plan_of
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_port_kernels: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    paths = _build_variants()
    rows = [{"build_s": time.perf_counter() - t0, "card": torch.cuda.get_device_name(0)}]
    cases = {(vd, B): _case(vd, B) for vd, B in ((False, 4096), (True, 4096), (False, 2048))}
    outputs = {}
    for name, path in paths.items():
        _build._loaded["fused_mlp_train"] = ctypes.CDLL(path)
        for (vd, B), (layout, params, feats, vencs, gt) in cases.items():
            if name != "shipped" and B != 4096:
                continue
            sc = F.make_train_scratch(layout, B, params)

            def launch():
                F._launch_fwd_bwd(layout, params, feats, 0, B, gt, F.LOSS_MODES["L1"],
                                  1.0 / (3 * B), sc, vencs)
            launch()
            torch.cuda.synchronize()
            bits = [t.clone() for t in (sc.acts, sc.deltas, sc.bias_part, sc.loss_part)]
            ref = outputs.setdefault((vd, B), bits)
            row = {"variant": name, "viewdep": vd, "B": B, "k": 512,
                   "ctas": F.last_fwd_bwd_launch()["ctas"],
                   "bit_equal_to_shipped": all(torch.equal(a, b) for a, b in zip(bits, ref)),
                   "ms": cuda_ms(launch)}
            rows.append(row)
    _build._loaded.pop("fused_mlp_train", None)
    rows += sort_rows()
    lines = [json.dumps(r) for r in rows]
    for ln in lines:
        print(ln, flush=True)
    print(smi, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines + [smi]) + "\n")
    if not all(r.get("bit_equal_to_shipped", True) for r in rows):
        raise SystemExit("ab_port_kernels: a variant changed the kernel's bits")
    if not all(r.get("equal_to_sort", True) and r.get("launches_as_planned", True)
               for r in rows):
        raise SystemExit("ab_port_kernels: a sort plan mis-sorted or launched off its plan")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
