"""The Meshroom (AliceVision radial-k3) path after preprocessing: the port's
Renderer traces undistorted pixel coordinates, its eval CLI reads a
Meshroom split and its Trainer renders the Meshroom vis views, each held to
the JAX package on the same files and weights (JAX renderer: infer="xla")."""
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch
import yaml

from intrinsic_neural_fields_tpu.models import init_model
from intrinsic_neural_fields_tpu.models import make_model as jax_make_model
from intrinsic_neural_fields_tpu.render.renderer import Renderer as JaxRenderer

from intrinsic_neural_fields_tpu_torch.geometry.mesh_io import write_obj
from intrinsic_neural_fields_tpu_torch.geometry.synthetic import (blob_mesh, look_at_cam,
                                                                  pinhole_K, render_gt_view)
from intrinsic_neural_fields_tpu_torch.models import make_model
from intrinsic_neural_fields_tpu_torch.render.renderer import Renderer
from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import (
    compute_first_k_eigenfunctions)
from intrinsic_neural_fields_tpu_torch.spectral.features import postprocess_eigenfunctions
from intrinsic_neural_fields_tpu_torch.utils.io import imwrite
from intrinsic_neural_fields_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(2)

H, W = 24, 32          # non-square, as Meshroom frames are
K_EF = 8
CFG = {"k": K_EF, "num_layers": 4, "mlp_hidden_dim": 32, "skip_layer_idx": 2}
COEFFS = [0.05, -0.02, 0.01]
EYES = [(0.3, -2.8, 0.6), (2.6, 0.8, -0.3)]


def write_meshroom_split(root, mesh, split, distortion):
    """<root>/<split>_data.json (shared K, radial-k3 coefficients, 4x4
    cam2world per view), PNG images and .npy object masks; the GT is the
    procedural texture on the pinhole trace."""
    os.makedirs(root, exist_ok=True)
    K = pinhole_K(H, W)
    views = []
    for i, eye in enumerate(EYES):
        cam = look_at_cam(np.array(eye))
        img, mask = render_gt_view(mesh, cam, K, H, W, tracer="host")
        imwrite(os.path.join(root, f"{split}{i}.png"), img)
        np.save(os.path.join(root, f"{split}{i}_mask.npy"), mask)
        cam44 = np.eye(4)
        cam44[:3] = cam
        views.append({"view_file": f"{split}{i}.png", "obj_mask_file": f"{split}{i}_mask.npy",
                      "cam2world": cam44.tolist()})
    with open(os.path.join(root, f"{split}_data.json"), "w") as f:
        json.dump({"K": np.asarray(K)[:3, :3].tolist(), "distortion_params": distortion,
                   "views": views}, f)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The blob, its eigenfunctions, JAX weights and the port model on the
    same weights, a reference-layout model.pt and a Meshroom split."""
    root = str(tmp_path_factory.mktemp("meshroom"))
    mesh = blob_mesh(2)
    mesh_path = os.path.join(root, "blob.obj")
    write_obj(mesh_path, mesh.vertices, mesh.faces)
    raw = compute_first_k_eigenfunctions(mesh, K_EF).astype(np.float32)
    ef_path = os.path.join(root, "efuncs.npy")
    np.save(ef_path, raw)
    jmodel = jax_make_model(CFG)
    variables = init_model(jmodel, CFG)
    model = make_model(CFG, device="cpu")
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]), CFG))
    out_dir = os.path.join(root, "run")
    os.makedirs(out_dir)
    torch.save(model.state_dict(), os.path.join(out_dir, "model.pt"))
    write_meshroom_split(os.path.join(root, "data"), mesh, "test", COEFFS)
    return {"root": root, "mesh": mesh, "mesh_path": mesh_path, "ef_path": ef_path,
            "efuncs": postprocess_eigenfunctions(raw), "jmodel": jmodel,
            "variables": variables, "model": model, "out_dir": out_dir}


def _renderers(scene):
    from intrinsic_neural_fields_tpu.geometry.mesh import load_mesh as jax_load_mesh

    jr = JaxRenderer(scene["jmodel"], scene["variables"], jax_load_mesh(scene["mesh_path"]),
                     eigenfunctions=scene["efuncs"], H=H, W=W, infer="xla")
    pr = Renderer(scene["model"], scene["mesh"], scene["efuncs"], H=H, W=W, device="cpu")
    return jr, pr


def test_distorted_render_matches_jax(scene):
    """Both renderers undistort the same pixels in f64 and trace the f32
    coordinates: the coordinates are equal to the bit, the valid masks are
    equal, and the colours agree within 2e-3 (the port's CPU forward rounds
    matmul operands to bf16, the JAX CPU forward is f32; both ship f16)."""
    jr, pr = _renderers(scene)
    K = pinhole_K(H, W)
    kw = dict(eval_render=True, distortion_coeffs=COEFFS, distortion_type="meshroom_radial_k3")
    for eye in EYES:
        cam = look_at_cam(np.array(eye))
        img_ref, hit_ref = jr.render(cam, K, **kw)
        img, hit = pr.render(cam, K, **kw)
        np.testing.assert_array_equal(np.sort(hit), np.sort(hit_ref))
        assert 0 < len(hit) < H * W
        np.testing.assert_allclose(img, img_ref, rtol=0, atol=2e-3)
        pinhole, hit_p = pr.render(cam, K, eval_render=True)
        assert not np.array_equal(np.sort(hit_p), np.sort(hit))  # the lens moved the rays
    (pc, phull), = pr._coords_cache.values()
    (jc, jhull), = jr._coords_cache.values()
    L = pc.shape[0]
    np.testing.assert_array_equal(pc.numpy()[np.argsort(pr._pixel_cache[next(iter(
        pr._pixel_cache))].pix_idx)], np.asarray(jc)[:L][np.argsort(
            jr._pixel_cache[next(iter(jr._pixel_cache))].pix_idx)])
    np.testing.assert_array_equal(phull, jhull)


def test_zero_coefficients_equal_the_pinhole_render(scene):
    """With k1 = k2 = k3 = 0 the undistorted coordinates are the pixel grid
    up to the bisection's 1e-8 tolerance: the same valid mask as the pinhole
    render and colours within one f16 step (4.9e-4)."""
    _, pr = _renderers(scene)
    K = pinhole_K(H, W)
    for eye in EYES:
        cam = look_at_cam(np.array(eye))
        img_p, hit_p = pr.render(cam, K, eval_render=True)
        img_z, hit_z = pr.render(cam, K, eval_render=True, distortion_coeffs=[0.0, 0.0, 0.0],
                                 distortion_type="meshroom_radial_k3")
        np.testing.assert_array_equal(hit_z, hit_p)
        np.testing.assert_allclose(img_z, img_p, rtol=0, atol=4.9e-4)


def test_cache_key_is_never_served_for_other_coefficients(scene):
    """A trace cached under a cache_key for one set of coefficients is not
    reused for another: the second render equals a fresh one."""
    _, pr = _renderers(scene)
    _, fresh = _renderers(scene)
    K = pinhole_K(H, W)
    cam = look_at_cam(np.array(EYES[0]))
    other = [-0.08, 0.03, 0.0]
    pr.render(cam, K, distortion_coeffs=COEFFS, distortion_type="meshroom_radial_k3",
              cache_key="v0")
    got = pr.render(cam, K, distortion_coeffs=other, distortion_type="meshroom_radial_k3",
                    cache_key="v0")
    want = fresh.render(cam, K, distortion_coeffs=other, distortion_type="meshroom_radial_k3")
    np.testing.assert_array_equal(got, want)
    assert len(pr._trace_cache) == 2 and len(pr._coords_cache) == 2
    with pytest.raises(ValueError, match="Unknown distortion type"):
        pr.render(cam, K, distortion_coeffs=COEFFS, distortion_type="fisheye")


def test_set_height_and_width_clear_the_view_caches(scene):
    """set_height / set_width (JAX render/renderer.py:380-393) drop the
    traces, pixel bundles and undistorted coordinates made for the old
    size, and the next render is the size asked for, equal to a renderer
    built at that size."""
    _, pr = _renderers(scene)
    K = pinhole_K(H, W)
    cam = look_at_cam(np.array(EYES[1]))
    pr.render(cam, K, distortion_coeffs=COEFFS, distortion_type="meshroom_radial_k3",
              cache_key="a")
    pr.set_height(16)
    pr.set_width(20)
    assert not (pr._trace_cache or pr._pixel_cache or pr._coords_cache)
    K2 = pinhole_K(16, 20)
    img = pr.render(cam, K2)
    want = Renderer(scene["model"], scene["mesh"], scene["efuncs"], H=16, W=20,
                    device="cpu").render(cam, K2)
    assert img.shape == (16, 20, 3)
    np.testing.assert_array_equal(img, want)


def _config(scene, **data):
    return {"seed": 0,
            "data": {"mesh_path": scene["mesh_path"], "eigenfunctions_path": scene["ef_path"],
                     "img_height": H, "img_width": W, "type": "meshroom_radial_k3", **data},
            "model": dict(CFG), "training": {"out_dir": scene["out_dir"]}}


def test_eval_cli_on_a_meshroom_split_matches_jax(scene, tmp_path):
    """`python -m ...eval` on a Meshroom split (data.type:
    meshroom_radial_k3) against the JAX package's evaluate_views on the
    same split and model.pt: per-view PSNR within 0.1 dB and DSSIM x100
    within 0.05 (the forward's bf16 operand rounding), LPIPS NaN on both."""
    from intrinsic_neural_fields_tpu.evaluation.eval_cli import (
        evaluate_views as jax_evaluate_views)

    from intrinsic_neural_fields_tpu_torch.eval import main as eval_main

    config = _config(scene)
    cfg_path = str(tmp_path / "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)
    data = os.path.join(scene["root"], "data")
    eval_main([str(tmp_path / "port"), cfg_path, data, "test", "--device", "cpu"])
    with open(tmp_path / "port" / "evaluation_metrics.pkl", "rb") as f:
        got = pickle.load(f)
    _, want = jax_evaluate_views(str(tmp_path / "jax"), config, data, "test")
    assert set(got) == set(want) == {"000", "001"}
    for view in want:
        assert np.isfinite(got[view]["psnr"])
        assert got[view]["psnr"] == pytest.approx(want[view]["psnr"], abs=0.1)
        assert got[view]["dssim_rescaled"] == pytest.approx(want[view]["dssim_rescaled"],
                                                            abs=0.05)
        assert np.isnan(got[view]["lpips_rescaled"]) and np.isnan(want[view]["lpips_rescaled"])


class Recorder:
    def __init__(self):
        self.scalars, self.images = [], []

    def add_scalar(self, tag, value, global_step=None):
        self.scalars.append((tag, float(value), global_step))

    def add_image(self, tag, img, global_step=None):
        self.images.append((tag, np.asarray(img).shape, global_step))


def _write_ray_cache(path, n, V, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "vids_of_hit_faces.npy"),
            rng.integers(0, V, size=(n, 3)).astype(np.int32))
    bary = rng.random((n, 3)).astype(np.float32)
    np.save(os.path.join(path, "barycentric_coords.npy"), bary / bary.sum(1, keepdims=True))
    np.save(os.path.join(path, "expected_rgbs.npy"), rng.random((n, 3)).astype(np.float32))


def test_trainer_meshroom_vis_scalars_match_jax(scene):
    """The Trainer on data.type: meshroom_radial_k3 renders every view of
    data.vis_split through the undistorted coordinates (JAX
    train/trainer.py:389-418): on the same weights both Trainers log the
    same tags, PSNR within 0.05 dB and the summed absolute distance within
    0.5% (bf16 operands against f32)."""
    from intrinsic_neural_fields_tpu.geometry.mesh import load_mesh as jax_load_mesh
    from intrinsic_neural_fields_tpu.train import Trainer as JaxTrainer
    from intrinsic_neural_fields_tpu.train import get_data as jax_get_data
    from intrinsic_neural_fields_tpu.train import get_renderer as jax_get_renderer

    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh
    from intrinsic_neural_fields_tpu_torch.train import (AdamHyper, Trainer, create_train_state,
                                                         get_data, get_model_and_optim,
                                                         get_renderer)

    root = scene["root"]
    for split, seed in (("train", 1), ("val", 2)):
        _write_ray_cache(os.path.join(root, "rays", split), 512, scene["mesh"].num_vertices, seed)

    def config(out):
        cfg = _config(scene, vis_dataset_path=os.path.join(root, "data"), vis_split="test",
                      preproc_data_path_train=os.path.join(root, "rays", "train"),
                      preproc_data_path_eval=os.path.join(root, "rays", "val"))
        cfg["training"] = {"out_dir": os.path.join(root, out), "batch_size": 128, "lr": 1e-3,
                           "loss_type": "L1", "render_every": 1, "print_every": 1, "epochs": 1}
        return cfg

    jcfg = config("vis_jax")
    jmesh = jax_load_mesh(jcfg["data"]["mesh_path"])
    variables = scene["variables"]
    from intrinsic_neural_fields_tpu.train import get_model_and_optim as jax_model_and_optim

    jmodel, _, jopt = jax_model_and_optim(jcfg, jmesh)
    jt = JaxTrainer(jmodel, variables, jopt, "L1",
                    jax_get_renderer(jcfg, jmodel, variables, jmesh),
                    jax_get_data(jcfg, jmesh), jmesh, jcfg)
    jt.writer = Recorder()
    jt._visualize(0)

    pcfg = config("vis_port")
    mesh = load_mesh(pcfg["data"]["mesh_path"])
    model, opt = get_model_and_optim(pcfg, mesh, device="cpu")
    model.load_state_dict(scene["model"].state_dict())
    pt = Trainer(model, opt, "L1", get_renderer(pcfg, model, mesh, device="cpu"),
                 get_data(pcfg, mesh, device="cpu"), mesh, pcfg, writer=Recorder(),
                 device="cpu")
    pt.state = create_train_state(model, AdamHyper(1e-3), "cpu")
    pt._visualize(0)

    got = {tag: v for tag, v, _ in pt.writer.scalars}
    want = {tag: v for tag, v, _ in jt.writer.scalars}
    tags = {f"meshroom_radial_k3_view_{i}_{s}" for i in range(2) for s in ("psnr", "dist")}
    assert set(got) == set(want) == tags
    assert sorted(pt.writer.images) == sorted(jt.writer.images)
    for tag in tags:
        assert np.isfinite(got[tag])
        if tag.endswith("psnr"):
            assert got[tag] == pytest.approx(want[tag], abs=0.05), tag
        else:
            assert got[tag] == pytest.approx(want[tag], rel=5e-3), tag
