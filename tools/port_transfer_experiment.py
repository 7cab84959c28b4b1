#!/usr/bin/env python
"""The HQ texture-transfer experiment (scripts/run_transfer.sh) and the
baseline families (scripts/run_model_families.sh's xyz, tf_rff, hks and
shot recipes) through the port's `-m` CLIs on one NVIDIA GPU.

  python tools/port_transfer_experiment.py [--seed 0] [--epochs 400]
      [--targets coarse dense cloud deformed]
      [--families xyz_blob tf_rff_blob hks_blob shot_blob]
      [--out out/transfer_experiment]

1. The README's HQ recipe: its data (``data/synthetic_hq``, made once, as
   tools/port_recipe_seeds.py makes it), then
   ``configs/synthetic/intrinsic_blob_hq.yaml`` trained for --epochs at
   --seed and evaluated on the test split (the source row).
2. Each of --families (``configs/synthetic/<name>.yaml``) trained and
   evaluated the same way (one row each); shot_blob's SHOT matrix is made
   first by ``compute_shot`` (``data/synthetic_hq/efuncs/blob_shot.npy``,
   as scripts/run_model_families.sh makes it).
3. ``make_transfer_targets`` for the targets (1024-function target bases,
   the carried-texture test views of ``deformed``).
4. ``texture_transfer --eval_dataset`` onto each target: the source
   dataset's test views for the re-discretizations, the carried-texture
   views for ``deformed``; the point cloud (``cloud.ply``, locally
   triangulated) with ``--laplacian_type pc_vert_robust``.
5. The control rows through ``eval_on_mesh`` (no functional map): the xyz
   field (when xyz_blob is among --families) on the deformed target and
   on the dense one, and the HQ field with the dense target's own basis
   (the direct swap).

Prints one JSON line per row (test PSNR and DSSIM x100 from the eval's
metrics pickle, the JAX CLIs' figures from RESULTS.md beside them and
whether the two differ by more than 0.3 dB, seconds), then the card's
name and power limit. Everything else goes under --out.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from port_recipe_seeds import DATA, PKG, ROOT, make_data, write_config  # noqa: E402

# RESULTS.md's tables (the JAX package's CLIs): test PSNR, DSSIM x100 — the
# transfer rows (:150-157) and the families (:105-108)
JAX_ROWS = {"source": (57.03, 0.013), "coarse": (50.20, 0.032), "dense": (45.95, 0.021),
            "cloud": (57.02, 0.013), "deformed": (56.45, 0.014),
            "deformed_xyz": (18.40, 2.603), "dense_xyz": (55.23, 0.017),
            "dense_directswap": (15.59, 4.207), "xyz_blob": (55.31, 0.017),
            "tf_rff_blob": (34.83, 1.807), "hks_blob": (17.54, 4.885),
            "shot_blob": (18.98, 12.546)}
FAMILIES = ("xyz_blob", "tf_rff_blob", "hks_blob", "shot_blob")
TARGETS = ("coarse", "dense", "cloud", "deformed")
SHOT = os.path.join(DATA, "efuncs", "blob_shot.npy")


def _run(cmd, log):
    t0 = time.perf_counter()
    with open(log, "w") as f:
        subprocess.run(cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, check=True)
    return time.perf_counter() - t0


def _metrics(eval_dir):
    with open(os.path.join(eval_dir, "evaluation_metrics.pkl"), "rb") as f:
        per_view = pickle.load(f)
    n = len(per_view)
    return (sum(m["psnr"] for m in per_view.values()) / n,
            sum(m["dssim_rescaled"] for m in per_view.values()) / n, n)


def _row(name, eval_dir, seconds):
    psnr, dssim, n = _metrics(eval_dir)
    jax_psnr, jax_dssim = JAX_ROWS[name]
    return {"row": name, "views": n, "test_psnr": psnr, "dssim_rescaled": dssim,
            "jax_test_psnr": jax_psnr, "jax_dssim_rescaled": jax_dssim,
            "differs_by_more_than_0.3_dB": bool(abs(psnr - jax_psnr) > 0.3), "seconds": seconds}


def _train_and_eval(py, out, name, recipe, seed, epochs):
    """Train `recipe` at this seed and epochs, evaluate it on the test
    split; print its row; returns its config path."""
    cfg = write_config(os.path.join(out, f"{name}.yaml"), os.path.join(out, name), seed, epochs,
                       config=recipe)
    train_s = _run([*py, f"{PKG}.train", cfg], os.path.join(out, f"train_{name}.log"))
    eval_dir = os.path.join(out, f"eval_{name}")
    eval_s = _run([*py, f"{PKG}.eval", eval_dir, cfg, DATA, "test"],
                  os.path.join(out, f"eval_{name}.log"))
    print(json.dumps(dict(_row(name, eval_dir, eval_s), seed=seed, epochs=epochs,
                          train_s=train_s)), flush=True)
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--targets", nargs="*", default=list(TARGETS), choices=TARGETS)
    ap.add_argument("--families", nargs="*", default=list(FAMILIES), choices=FAMILIES)
    ap.add_argument("--out", default=os.path.join(ROOT, "out", "transfer_experiment"))
    args = ap.parse_args(argv)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    py = [sys.executable, "-m"]
    make_data(out)
    if "shot_blob" in args.families and not os.path.exists(SHOT):
        _run([*py, f"{PKG}.compute_shot", SHOT, os.path.join(DATA, "blob.obj")],
             os.path.join(out, "compute_shot.log"))

    recipes = os.path.join(ROOT, "configs", "synthetic")
    cfg = _train_and_eval(py, out, "source", os.path.join(recipes, "intrinsic_blob_hq.yaml"),
                          args.seed, args.epochs)
    family_cfgs = {f: _train_and_eval(py, out, f, os.path.join(recipes, f"{f}.yaml"), args.seed,
                                      args.epochs) for f in args.families}
    if not args.targets:
        print(smi, flush=True)
        return 0

    tdir = os.path.join(out, "targets")
    src_efuncs = os.path.join(DATA, "efuncs", "eigenfunctions_cotan_kmax512_skip_first_efuncs.npy")
    targets_s = _run([*py, f"{PKG}.make_transfer_targets", "--out_dir", tdir, "--src_dataset",
                      DATA, "--src_efuncs", src_efuncs, "--targets", *args.targets],
                     os.path.join(out, "targets.log"))
    print(json.dumps({"make_transfer_targets_s": targets_s, "targets": args.targets}), flush=True)
    views = {name: os.path.join(tdir, "deformed_views") if name == "deformed" else DATA
             for name in args.targets}
    for name in args.targets:
        eval_dir = os.path.join(out, f"transfer_{name}")
        mesh, lap = ("cloud.ply", "pc_vert_robust") if name == "cloud" else (f"{name}.obj",
                                                                             "cotan")
        seconds = _run([*py, f"{PKG}.texture_transfer", "--config_path", cfg, "--target_mesh",
                        os.path.join(tdir, mesh), "--laplacian_type", lap, "--source_efuncs_full",
                        os.path.join(tdir, "source_efuncs_full.npy"), "--target_efuncs_full",
                        os.path.join(tdir, f"efuncs_full_{name}.npy"), "--correspondence",
                        os.path.join(tdir, f"corr_{name}.npy"), "--eval_dataset", views[name],
                        "--eval_split", "test", "--out_dir", eval_dir],
                       os.path.join(out, f"transfer_{name}.log"))
        print(json.dumps(_row(name, eval_dir, seconds)), flush=True)

    # the controls: no functional map
    controls = []
    if "xyz_blob" in family_cfgs:
        controls += [(f"{t}_xyz", family_cfgs["xyz_blob"], t, []) for t in ("deformed", "dense")
                     if t in args.targets]
    if "dense" in args.targets:
        controls.append(("dense_directswap", cfg, "dense",
                         ["--efuncs", os.path.join(tdir, "efuncs_skip_dense.npy")]))
    for row, config, target, extra in controls:
        eval_dir = os.path.join(out, row)
        seconds = _run([*py, f"{PKG}.eval_on_mesh", "--config_path", config, "--target_mesh",
                        os.path.join(tdir, f"{target}.obj"), "--eval_dataset", views[target],
                        "--eval_split", "test", "--out_dir", eval_dir, *extra],
                       os.path.join(out, f"{row}.log"))
        print(json.dumps(_row(row, eval_dir, seconds)), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(argv=None))
