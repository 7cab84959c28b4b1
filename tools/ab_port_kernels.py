#!/usr/bin/env python
"""A/B of design choices in the port's hand-written kernels, on one NVIDIA GPU.

  python tools/ab_port_kernels.py [--parent DIR] [--sections S,...] [--out FILE]

Sections (all by default):

``fwd_bwd`` (``csrc/fused_mlp_train.cu``): variants that take back one part
of its design at a time, timed against the kernel as shipped on the same
inputs (k=512, B=4096, the HQ layout and its view-dependent tail):
``sync_loads`` (every cp.async copy a synchronous 16-byte load and store),
``f32_weights`` (weight tiles read from the f32 master and rounded in the
kernel), ``sync_f32`` (both); and the grid: B=2048 (64 CTAs) beside B=4096.
Every variant must give the shipped kernel's bits.

``wgrad``: the kernel as shipped beside ``global_partials``, the same
kernel with its split partials summed through a buffer in device memory
instead of the cluster's shared memory (it must give the same bits), at
k=512 (plain and tail) and k=1023, B=4096.

``fwd``: the forward as shipped (its CTA height and feature tile chosen
by shared memory) beside forced 64-row and 128-row CTAs and
``streamed`` (128-row CTAs whose skip layer reads the features from
device memory again, as at k_w >= ~1500), at k=512, B=8192, plain and
view-dependent (every variant must give the shipped kernel's bits).

``parent`` (needs ``--parent``, a checkout of another tree of the port,
e.g. ``git archive`` of it unpacked into an ignored directory): each
tree's own Python entry points, in subprocesses that import that tree's
package (which builds its kernels from its own sources), in the order
parent, this, this, parent, on the same seeded inputs: ``fused_apply``
and ``fused_apply_viewdep`` (k=512, B=8192; k=1023 plain), the train
kernels (``fused_train_grads``: fwd_bwd + wgrad) and wgrad alone
(``_launch_wgrad`` on this tree's fwd_bwd outputs) at k=512 plain and
tail and k=1023, B=4096; with each output's largest difference to this
tree's.

``step`` (needs ``--parent`` for the comparison; alone it runs this tree
twice): the train step end to end through each tree's ``make_epoch_fns``
(blocks, fused), in subprocesses that import that tree, in the order
parent, this, this, parent, on the same seeded data: the HQ shapes (k=512,
184 steps of B=4096, bf16 table), the view-dependent ones (the same with
the intrinsic view tail) and the bench shapes (k=1023, N=2^21, 512 steps);
per step the wall ms (host clock around an epoch ending in a device sync,
best and median of 5 epochs after a warm-up) and the device ms and busy
share of one profiled epoch (torch.profiler). In a tree whose epoch is a
graph replay it also runs the same epoch as the loop of its two launches
per step from the host, without the graph (``loop``), so the graph's
share is measured apart from the kernels'. Each epoch's loss is reported.

``sort`` (``csrc/bitonic_argsort.cu``): above 2^18 keys, the plan's run size
(``ops/sort.py:sort_plan``'s ``run_log``, 2^11..2^18 words) on dense random
keys of 2^18+1, 2^20 and 2^22; each plan's order must equal
torch.sort(stable=True), and its CUDA launches the plan's.

Variants are made by replacing source text in a copy of ``csrc/``; the
script stops if a text to replace is not found exactly once. Prints one JSON line
per row, then the card's name and power limit. Needs nvcc and a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
# The port's modules, from this tree or the one given by --time-tree.
F = S = _build = make_model = None

SECTIONS = ("fwd_bwd", "wgrad", "fwd", "parent", "step", "sort")
# (leg, k, table rows, vertices, view tail) of the step section
STEP_LEGS = (("hq", 512, 184 * 4096, 20_480, False), ("viewdep", 512, 184 * 4096, 20_480, True),
             ("bench", 1023, 1 << 21, 30_000, False))
STEP_EPOCHS = 5
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

# wgrad's split partials through device memory (one slot per CTA, room for
# GLOBAL_PARTIAL_CTAS CTAs), summed in the same rank order.
GLOBAL_PARTIAL_CTAS = 512
WGPART_DECL = f"""
__device__ float4 g_wpart[{GLOBAL_PARTIAL_CTAS} * PART_F4];
"""
WGPART_SUM_OLD = """    float4 s = *cl.map_shared_rank(red + idx, 0);
    for (int q = 1; q < S; ++q) {
      const float4 v = *cl.map_shared_rank(red + idx, q);
"""
WGPART_SUM_NEW = """    const float4* p0 = g_wpart + (size_t)(blockIdx.x - rank) * PART_F4 + idx;
    float4 s = __ldcg(p0);
    for (int q = 1; q < S; ++q) {
      const float4 v = __ldcg(p0 + (size_t)q * PART_F4);
"""


def _use_port(root):
    """Import the port's package from the tree at root."""
    global F, S, _build, make_model
    sys.path.insert(0, root)
    from intrinsic_neural_fields_tpu_torch.models import make_model
    from intrinsic_neural_fields_tpu_torch.ops import _build
    from intrinsic_neural_fields_tpu_torch.ops import fused_mlp as F
    from intrinsic_neural_fields_tpu_torch.ops import sort as S


def _replace(files, fname, old, new):
    if files[fname].count(old) != 1:
        raise RuntimeError(f"{fname}: cannot make the variant at {old[:60]!r}")
    files[fname] = files[fname].replace(old, new)


def _build_variants(csrc, target, variants):
    """Compile variants of csrc/<target>.cu in parallel, each in its own
    copy of the csrc directory under _build/ablate/ (a directory per
    target and variant: a library path is loaded once per process):
    variants = {name: edit(files) or None}, files = {file name: text}.
    Returns {name: ctypes library}."""
    procs = {}
    for name, edit in variants.items():
        files = {os.path.basename(p): open(p).read()
                 for p in glob.glob(os.path.join(csrc, "*.cu*"))}
        if edit is not None:
            edit(files)
        out_dir = os.path.join(_build.BUILD_DIR, "ablate", f"{target}_{name}")
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        for fname, text in files.items():
            with open(os.path.join(out_dir, fname), "w") as f:
                f.write(text)
        so = os.path.join(out_dir, f"lib{target}.so")
        cmd = [_build._nvcc(), *_build._flags(target), "-o", so,
               os.path.join(out_dir, f"{target}.cu")]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True))
    libs = {}
    for name, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {target} {name} variant:\n{err}")
        libs[name] = ctypes.CDLL(so)
    return libs


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


def _fwd_bwd_outputs(case):
    """fwd_bwd (this tree's kernel) on a case: its scratch, ready for wgrad."""
    layout, params, feats, vencs, gt = case
    B = feats.shape[0]
    sc = F.make_train_scratch(layout, B, params)
    F._launch_fwd_bwd(layout, params, feats, 0, B, gt, F.LOSS_MODES["L1"], 1.0 / (3 * B), sc,
                      vencs)
    torch.cuda.synchronize()
    return sc


def fwd_bwd_rows(csrc):
    def sync(files):
        text = files["mlp_tiles.cuh"]
        start = text.index("__device__ __forceinline__ void cp16(")
        _replace(files, "mlp_tiles.cuh", text[start:text.index("}\n", start) + 1], SYNC_CP16)

    def f32(files):
        cpw = [ln for ln in files["fused_mlp_train.cu"].splitlines() if "void cpw(" in ln]
        if len(cpw) != 1:
            raise RuntimeError("csrc/fused_mlp_train.cu: no single cpw() to ablate")
        for old, new in (("  const __nv_bfloat16* wb;\n",
                          "  const __nv_bfloat16* wb;\n  const float* wf;\n"),
                         ("  f.wb = wb;\n", "  f.wb = wb;\n  f.wf = params;\n"),
                         (cpw[0], F32_CPW)):
            _replace(files, "fused_mlp_train.cu", old, new)

    libs = _build_variants(csrc, "fused_mlp_train", {
        "shipped": None, "sync_loads": sync, "f32_weights": f32,
        "sync_f32": lambda fs: (sync(fs), f32(fs))})
    cases = {(vd, B): _case(vd, B) for vd, B in ((False, 4096), (True, 4096), (False, 2048))}
    rows, outputs = [], {}
    for name, lib in libs.items():
        _build._loaded["fused_mlp_train"] = lib
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
            rows.append({"kernel": "fwd_bwd", "variant": name, "viewdep": vd, "B": B, "k": 512,
                         "ctas": F.last_fwd_bwd_launch()["ctas"],
                         "bit_equal_to_shipped": all(torch.equal(a, b)
                                                     for a, b in zip(bits, ref)),
                         "ms": cuda_ms(launch)})
    _build._loaded.pop("fused_mlp_train", None)
    return rows


def wgrad_rows(csrc):
    def global_partials(files):
        f = "fused_mlp_train.cu"
        decl = next(ln for ln in files[f].splitlines() if ln.startswith("constexpr int PART_F4"))
        _replace(files, f, decl + "\n", decl + "\n" + WGPART_DECL)
        _replace(files, f, "  float4* red = reinterpret_cast<float4*>(smem_raw);\n",
                 "  float4* red = g_wpart + (size_t)blockIdx.x * PART_F4;\n")
        _replace(files, f, "  cl.sync();\n  // the r-th share", "  __threadfence();\n  cl.sync();\n"
                 "  // the r-th share")
        _replace(files, f, WGPART_SUM_OLD, WGPART_SUM_NEW)

    libs = _build_variants(csrc, "fused_mlp_train", {"shipped": None,
                                                     "global_partials": global_partials})
    rows = []
    for vd, k in ((False, 512), (True, 512), (False, 1023)):
        case = _case(vd, 4096, k)
        layout, params, feats, vencs, gt = case
        sc = _fwd_bwd_outputs(case)
        ref = None
        for name, lib in libs.items():
            _build._loaded["fused_mlp_train"] = lib
            grads, sums = torch.empty(layout.n, device="cuda"), torch.empty(2, device="cuda")

            def launch():
                F._launch_wgrad(layout, feats, 0, 4096, sc, grads, sums, vencs)
            if name != "shipped" and rows[-1]["launch"]["ctas"] > GLOBAL_PARTIAL_CTAS:
                raise RuntimeError(f"wgrad {name}: {rows[-1]['launch']['ctas']} CTAs, room "
                                   f"for {GLOBAL_PARTIAL_CTAS}")
            launch()
            torch.cuda.synchronize()
            bits = torch.cat([grads, sums]).clone()
            ref = bits if ref is None else ref
            rows.append({"kernel": "wgrad", "variant": name, "viewdep": vd, "B": 4096, "k": k,
                         "launch": F.last_wgrad_launch(),
                         "bit_equal_to_shipped": torch.equal(bits, ref), "ms": cuda_ms(launch)})
    _build._loaded.pop("fused_mlp_train", None)
    return rows


def _fwd_inputs(vd, B, k=512, seed=0):
    """The forward's operands on a seeded network: (weights, x, venc) with
    x f32 features (uniform in [-0.5, 0.5]) and venc f32 view encodings."""
    layout, params, _, _, _ = _case(vd, 8, k, seed)
    fw = layout.pack(params)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.rand(B, k, generator=g, device="cuda") - 0.5
    venc = (torch.rand(B, layout.tail.venc_in, generator=g, device="cuda") - 0.5) if vd else None
    return fw, x, venc


def fwd_rows(csrc):
    def forced(wg, x_res):
        return lambda files: _replace(files, "fused_mlp_fwd.cu", "  const int rows = BM * wg;\n",
                                      f"  wg = {wg};\n  x_res = {x_res};\n"
                                      "  const int rows = BM * wg;\n")

    libs = _build_variants(csrc, "fused_mlp_fwd", {
        "shipped": None, "rows64": forced(1, 1), "rows128": forced(2, 1),
        "streamed": forced(2, 0)})
    rows = []
    for vd in (False, True):
        fw, x, venc = _fwd_inputs(vd, 8192)
        ref = None
        for name, lib in libs.items():
            _build._loaded["fused_mlp_fwd"] = lib

            def launch():
                return F.fused_apply_viewdep(fw, x, venc) if vd else F.fused_apply(fw, x)
            out = launch()
            torch.cuda.synchronize()
            ref = out if ref is None else ref
            rows.append({"kernel": "fwd", "variant": name, "viewdep": vd, "B": 8192, "k": 512,
                         "launch": F.last_fwd_launch(), "bit_equal_to_shipped": torch.equal(out, ref),
                         "ms": cuda_ms(launch)})
    _build._loaded.pop("fused_mlp_fwd", None)
    return rows


def entry_rows(out_pt):
    """This process's tree: its entry points timed on the seeded cases, their
    outputs saved to out_pt for the comparison across trees."""
    rows, outs = [], {}
    for vd, k in ((False, 512), (True, 512), (False, 1023)):
        case = _case(vd, 4096, k)
        layout, params, feats, vencs, gt = case
        sc = _fwd_bwd_outputs(case)
        grads, sums = torch.empty(layout.n, device="cuda"), torch.empty(2, device="cuda")

        def wgrad():
            F._launch_wgrad(layout, feats, 0, 4096, sc, grads, sums, vencs)

        def train():
            return F.fused_train_grads(layout, params, feats, gt, 0, 4096, "L1", sc, vencs)
        wgrad()
        outs[f"wgrad_vd{int(vd)}_k{k}"] = torch.cat([grads, sums]).cpu()
        g, loss, sq = train()
        outs[f"train_vd{int(vd)}_k{k}"] = torch.cat([g, loss[None], sq[None]]).cpu()
        base = {"viewdep": vd, "k": k, "B": 4096}
        rows += [{"entry": "_launch_wgrad", **base, "ms": cuda_ms(wgrad)},
                 {"entry": "fused_train_grads", **base, "ms": cuda_ms(train)}]
        # the standalone Adam with the bf16 copy on this layout's flat buffer
        g = torch.Generator(device="cuda").manual_seed(7)
        p_, m_, v_ = params.clone(), torch.randn(layout.n, generator=g, device="cuda") * 1e-4, \
            torch.rand(layout.n, generator=g, device="cuda") * 1e-6
        wb = torch.empty(layout.n, dtype=torch.bfloat16, device="cuda")
        hyper = F.adam_hyper_rows(torch.tensor([1000]), 1e-4, device="cuda")[0]
        F.fused_adam_apply(p_, m_, v_, hyper, grads, wb)
        outs[f"adam_vd{int(vd)}_k{k}"] = torch.cat([p_, m_, v_, wb.float()]).cpu()
        rows.append({"entry": "fused_adam_apply", **base, "n": layout.n,
                     "ms": cuda_ms(lambda: F.fused_adam_apply(p_, m_, v_, hyper, grads, wb))})
    for vd, k in ((False, 512), (True, 512), (False, 1023)):
        fw, x, venc = _fwd_inputs(vd, 8192, k)

        def fwd():
            return F.fused_apply_viewdep(fw, x, venc) if vd else F.fused_apply(fw, x)
        outs[f"fwd_vd{int(vd)}_k{k}"] = fwd().cpu()
        rows.append({"entry": "fused_apply_viewdep" if vd else "fused_apply", "viewdep": vd,
                     "k": k, "B": 8192, "ms": cuda_ms(fwd)})
    torch.save(outs, out_pt)
    return rows


def parent_rows(parent):
    """Both trees' entry points, each tree in its own processes."""
    tmp = os.path.join(_build.BUILD_DIR, "ablate", "trees")
    os.makedirs(tmp, exist_ok=True)
    rows, outs = [], {}
    for i, (tree, root) in enumerate((("parent", parent), ("this", ROOT), ("this", ROOT),
                                      ("parent", parent))):
        out_pt = os.path.join(tmp, f"run{i}.pt")
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-tree",
                            os.path.abspath(root), "--out", out_pt], capture_output=True,
                           text=True, cwd=root)
        if p.returncode != 0:
            raise RuntimeError(f"ab_port_kernels: the {tree} tree's run failed:\n{p.stderr}")
        rows += [{"tree": tree, "run": i, **json.loads(ln)} for ln in p.stdout.splitlines()
                 if ln.startswith("{")]
        outs.setdefault(tree, torch.load(out_pt))
    for name, mine in outs["this"].items():
        rows.append({"output": name, "max_abs_diff_parent_to_this":
                     (outs["parent"][name] - mine).abs().max().item()})
    return rows


def _step_case(k, N, V, vd, seed=0):
    """A seeded model of the HQ layout (with the intrinsic view tail) and its
    data on the card: random normal features of V vertices, N hits with
    random vertices and Dirichlet(1,1,1) weights, uniform targets, bf16
    hit-feature table (and view-encoding table)."""
    from intrinsic_neural_fields_tpu_torch.data.sampler import (RayData, precompute_hit_features,
                                                                precompute_hit_vencs)
    from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
    from intrinsic_neural_fields_tpu_torch.models import view_encoder_apply

    cfg = {"k": k, "num_layers": 6, "mlp_hidden_dim": 128, "skip_layer_idx": 3}
    mesh = icosphere(3)
    if vd:
        cfg["view_dependence"] = {"bottleneck_vec_dim": 128, "include_view_dir": True,
                                  "embed_size": 4, "directional_hidden_dim": 128,
                                  "in_dim_view_dir": 1, "strategy": "intrinsic"}
    model = make_model(cfg, seed=seed, device="cuda", mesh=mesh if vd else None)
    g = torch.Generator(device="cuda").manual_seed(seed)
    feats = torch.randn(V, k, generator=g, device="cuda")
    vids = torch.randint(0, V, (N, 3), generator=g, device="cuda")
    e = -torch.log(torch.rand(N, 3, generator=g, device="cuda").clamp_min(1e-12))
    rgbs = torch.rand(N, 3, generator=g, device="cuda")
    dirs = torch.randn(N, 3, generator=g, device="cuda")
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    fids = torch.randint(0, mesh.num_faces, (N,), generator=g, device="cuda")
    data = precompute_hit_features(RayData(feats, "efuncs", vids, e / e.sum(1, keepdim=True),
                                           rgbs, dirs, fids), dtype=torch.bfloat16)
    if vd:
        data = precompute_hit_vencs(view_encoder_apply(model), data,
                                    F.layout_for_model(model).tail.venc_w, dtype=torch.bfloat16)
    return model, data


def _loop_epoch_fn(loss_type="L1"):
    """This tree's blocks + fused_adam epoch as a loop of its two launches
    per step from the host (fused_train_adam_step on the epoch graph's
    buffers), without the graph; None where the tree has no such step."""
    from intrinsic_neural_fields_tpu_torch.train import steps

    if not hasattr(steps, "EpochBuffers"):
        return None
    bufs = {}

    def epoch(state, perm, data, nb, B):
        params = state.params
        b = bufs.get((nb, B))
        if b is None:
            b = bufs[(nb, B)] = steps.EpochBuffers.make(state.layout, B, nb, params)
        F._sync_wb(b.scratch, params)
        b.order.copy_(perm.to(torch.int32))
        h = state.hyper
        b.hyper.copy_(F.adam_hyper_rows(state.count + 1 + torch.arange(nb), h.learning_rate, h.b1,
                                        h.b2, h.eps, h.eps_root, device=params.device))
        b.acc.zero_()
        vencs = data.hit_vencs if state.layout.tail is not None else None
        for i in range(nb):
            F.fused_train_adam_step(state.layout, params, state.mu, state.nu, b.hyper, b.order,
                                    i, data.hit_features, data.expected_rgbs, B, loss_type,
                                    b.scratch, b.sums, b.acc, vencs)
        state.count += nb
        # the epoch's division (by a device tensor: a correctly rounded quotient)
        return b.acc[0] / torch.full((), float(nb * B), device=params.device)
    return epoch


def step_rows_of_tree(out_pt):
    """This process's tree: the step section's legs (see the docstring);
    each variant's final params, moments and losses saved to out_pt."""
    from torch.profiler import ProfilerActivity, profile

    from intrinsic_neural_fields_tpu_torch.train.steps import (AdamHyper, create_train_state,
                                                               make_epoch_fns)

    B, rows, outs = 4096, [], {}
    for leg, k, N, V, vd in STEP_LEGS:
        model, data = _step_case(k, N, V, vd)
        nb = N // B
        train_epoch, _ = make_epoch_fns(model, "L1", shuffle="blocks", fused=True)
        loop = _loop_epoch_fn()
        variants = [("epoch", lambda st, perm: train_epoch(st, perm, data, nb, B)[1]["loss"])]
        if loop is not None:
            variants.append(("loop", lambda st, perm: loop(st, perm, data, nb, B)))
        for variant, run in variants:
            state = create_train_state(model, AdamHyper(1e-4), "cuda")
            perms = [torch.randperm(nb, generator=torch.Generator().manual_seed(e))
                     for e in range(STEP_EPOCHS + 2)]
            run(state, perms[0])  # warm-up: builds, captures
            torch.cuda.synchronize()
            walls, losses = [], []
            for e in range(1, STEP_EPOCHS + 1):
                t0 = time.perf_counter()
                loss = float(run(state, perms[e]))
                walls.append((time.perf_counter() - t0) * 1e3 / nb)
                losses.append(loss)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                float(run(state, perms[-1]))
                wall_us = 1e6 * (time.perf_counter() - t0)
            dev_us = 0.0
            for ev in prof.key_averages():
                us = getattr(ev, "self_device_time_total", None)
                us = ev.self_cuda_time_total if us is None else us
                if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
                    dev_us += us
            outs[f"{leg}_{variant}"] = torch.cat([state.params, state.mu, state.nu,
                                                  torch.tensor(losses, device="cuda")]).cpu()
            walls_sorted = sorted(walls)
            rows.append({"step": leg, "variant": variant, "k": k, "B": B, "steps": nb,
                         "wall_ms_best": walls_sorted[0],
                         "wall_ms_median": walls_sorted[len(walls) // 2],
                         "rays_per_s_best": B / walls_sorted[0] * 1e3,
                         "device_ms_per_step": dev_us / 1e3 / nb,
                         "busy_share": dev_us / wall_us, "losses": losses})
        del data, model
        torch.cuda.empty_cache()
    torch.save(outs, out_pt)
    return rows


def step_rows(parent):
    """Both trees' train steps, each tree in its own processes; then each
    final state's and loss list's largest difference to this tree's epoch
    (params, m, v and the 5 losses, concatenated)."""
    tmp = os.path.join(_build.BUILD_DIR, "ablate", "trees")
    os.makedirs(tmp, exist_ok=True)
    rows, outs = [], {}
    order = (("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent))
    if parent is None:
        order = (("this", ROOT), ("this", ROOT))
    for i, (tree, root) in enumerate(order):
        out_pt = os.path.join(tmp, f"step{i}.pt")
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-step-tree",
                            os.path.abspath(root), "--out", out_pt], capture_output=True,
                           text=True, cwd=root)
        if p.returncode != 0:
            raise RuntimeError(f"ab_port_kernels: the {tree} tree's step run failed:\n{p.stderr}")
        rows += [{"tree": tree, "run": i, **json.loads(ln)} for ln in p.stdout.splitlines()
                 if ln.startswith("{")]
        outs.setdefault(tree, torch.load(out_pt))
    for tree, got in outs.items():
        for name, t in got.items():
            ref = outs["this"][name.split("_")[0] + "_epoch"]
            d = (t - ref).abs()
            rows.append({"state": name, "tree": tree, "max_abs_diff_to_this_epoch":
                         d[:-STEP_EPOCHS].max().item(),
                         "loss_max_abs_diff": d[-STEP_EPOCHS:].max().item()})
    return rows


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
    ap.add_argument("--parent", default=None, help="checkout of an earlier tree to compare with")
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help=f"comma-separated subset of {','.join(SECTIONS)}")
    ap.add_argument("--out", default=None, help="also write the JSON lines to this file")
    ap.add_argument("--time-tree", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--time-step-tree", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    _use_port(args.time_tree or args.time_step_tree or ROOT)
    if args.time_tree:  # one tree's entry points (the parent section's subprocess)
        for r in entry_rows(args.out):
            print(json.dumps(r), flush=True)
        return 0
    if args.time_step_tree:  # one tree's train steps (the step section's subprocess)
        for r in step_rows_of_tree(args.out):
            print(json.dumps(r), flush=True)
        return 0
    sections = args.sections.split(",")
    if not set(sections) <= set(SECTIONS):
        raise SystemExit(f"ab_port_kernels: unknown section in {args.sections}")
    if "parent" in sections and args.parent is None:
        sections.remove("parent")
    if not torch.cuda.is_available():
        raise SystemExit("ab_port_kernels: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    csrc = os.path.dirname(_build.SOURCES["fused_mlp_train"])
    rows = [{"card": torch.cuda.get_device_name(0), "sections": sections}]
    for name, fn in (("fwd_bwd", lambda: fwd_bwd_rows(csrc)), ("wgrad", lambda: wgrad_rows(csrc)),
                     ("fwd", lambda: fwd_rows(csrc)), ("parent", lambda: parent_rows(args.parent)),
                     ("step", lambda: step_rows(args.parent)), ("sort", sort_rows)):
        if name in sections:
            t0 = time.perf_counter()
            new = fn()
            for r in new:
                print(json.dumps(r), flush=True)
            rows += new + [{"section": name, "s": time.perf_counter() - t0}]
    lines = [json.dumps(r) for r in rows]
    print(smi, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines + [smi]) + "\n")
    if not all(r.get("bit_equal_to_shipped", True) and r.get("bit_equal_to_this_tree", True)
               for r in rows):
        raise SystemExit("ab_port_kernels: a variant changed the kernel's bits")
    if not all(r.get("equal_to_sort", True) and r.get("launches_as_planned", True)
               for r in rows):
        raise SystemExit("ab_port_kernels: a sort plan mis-sorted or launched off its plan")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
