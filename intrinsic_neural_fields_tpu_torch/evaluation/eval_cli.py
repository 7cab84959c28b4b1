"""Evaluation loop: render every view of a split, compute masked PSNR,
DSSIM and LPIPS, optionally save images + a metrics pickle, return the
split means (the JAX package's evaluation/eval_cli.py).

Masking follows the reference: the metric mask is the logical AND of the
dataset's object mask and the renderer's ray-hit mask; both images get a
white background outside it. LPIPS needs a local weights npz
(`lpips_weights_path`); without one its column is NaN, as in the JAX
package. A Meshroom split (data.type: meshroom_radial_k3) renders each view
through its undistorted pixel coordinates.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ..utils.pipeline import pipelined_foreach
from .lpips import LPIPS
from .metrics import dssim, psnr


def evaluate_views(output_path, config, dataset_or_views, split="test",
                   renderer=None, background="white", lpips_weights_path=None):
    """dataset_or_views: a MeshViews dataset directory (its `split` list is
    read) or an iterable of view dicts with camCv2world, K, img [H,W,3] and
    obj_mask_1d (and, for a distorted view, distortion_params and
    distortion_type). renderer: a pre-built Renderer (default: built from
    the config and its out_dir's model.pt or model.ckpt, on the GPU). output_path:
    where PNGs and evaluation_metrics.pkl go; None writes nothing.
    lpips_weights_path: an LPIPS AlexNet npz (see evaluation/lpips.py).

    Returns (means, per_view) with keys psnr, dssim_rescaled, lpips_rescaled."""
    H, W = config["data"]["img_height"], config["data"]["img_width"]
    if isinstance(dataset_or_views, (str, os.PathLike)):
        from ..data.datasets import MeshroomRadialK3Dataset, MeshViewsDataset

        dataset_type = config["data"].get("type")
        if dataset_type is None:
            views = MeshViewsDataset(dataset_or_views, split, H=H, W=W, background=background)
        elif dataset_type == "meshroom_radial_k3":
            views = MeshroomRadialK3Dataset(dataset_or_views, split, H=H, W=W)
        else:
            raise NotImplementedError(f"Unknown dataset type: {dataset_type}")
    else:
        views = dataset_or_views
    if renderer is None:
        from ..render.renderer import make_renderer_from_config

        renderer = make_renderer_from_config(config)
    renderer.background = background
    lpips_fn = LPIPS(lpips_weights_path, device=renderer.device)
    if not lpips_fn.available():
        print("WARNING: LPIPS weights not found; LPIPS column will be NaN.")
    if output_path is not None:
        from ..utils.io import imwrite

        os.makedirs(output_path, exist_ok=True)

    results = {}
    totals = {"psnr": 0.0, "dssim_rescaled": 0.0, "lpips_rescaled": 0.0}

    def _finish(item, handle):
        i, view = item
        view_id = f"{i:03d}"
        fake_img, hit_ray_idxs = renderer.render_fetch(handle)
        hit_ray_mask = np.zeros(H * W, dtype=bool)
        hit_ray_mask[hit_ray_idxs] = True
        obj_mask_1d = hit_ray_mask & np.asarray(view["obj_mask_1d"]).reshape(-1)
        fake_img_raw = fake_img.copy()

        bg = ~obj_mask_1d
        fake_img = fake_img.reshape(-1, 3)
        fake_img[bg] = 1.0
        fake_img = fake_img.reshape(H, W, 3)
        real_img = np.array(view["img"], dtype=np.float32).reshape(-1, 3)
        real_img[bg] = 1.0
        real_img = real_img.reshape(H, W, 3)

        metrics = {
            "psnr": psnr(fake_img, real_img, obj_mask_1d),
            "dssim_rescaled": dssim(fake_img, real_img) * 100.0,
            "lpips_rescaled": (lpips_fn(fake_img, real_img) * 100.0 if lpips_fn.available()
                               else float("nan")),
        }
        for k in totals:
            totals[k] += metrics[k]
        results[view_id] = metrics
        if output_path is not None:
            imwrite(os.path.join(output_path, f"{view_id}_fake_raw.png"), fake_img_raw)
            imwrite(os.path.join(output_path, f"{view_id}_fake.png"), fake_img)
            imwrite(os.path.join(output_path, f"{view_id}_real.png"), real_img)

    def _dispatch(item):
        _, view = item
        return renderer.render_async(view["camCv2world"], view["K"], eval_render=True,
                                     distortion_coeffs=view.get("distortion_params"),
                                     distortion_type=view.get("distortion_type"))

    n = pipelined_foreach(enumerate(views), _dispatch, _finish, depth=1)
    if n == 0:
        raise ValueError("no views to evaluate")
    if output_path is not None:
        with open(os.path.join(output_path, "evaluation_metrics.pkl"), "wb") as f:
            pickle.dump(results, f)
    means = {k: v / n for k, v in totals.items()}
    print(f"PSNR: {means['psnr']}, DSSIM: {means['dssim_rescaled']}, "
          f"LPIPS: {means['lpips_rescaled']}")
    return means, results
