"""The port's eval CLI on a MeshViews dataset on disk, against the JAX
package's evaluate_views on the same dataset, config and model.pt."""
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

from intrinsic_neural_fields_tpu.evaluation.eval_cli import (
    evaluate_views as jax_evaluate_views,
)

from intrinsic_neural_fields_tpu_torch.utils.io import imwrite
from intrinsic_neural_fields_tpu_torch.eval import main as eval_main
from intrinsic_neural_fields_tpu_torch.geometry.mesh_io import write_obj
from intrinsic_neural_fields_tpu_torch.geometry.synthetic import (
    blob_mesh,
    look_at_cam,
    pinhole_K,
    procedural_texture,
)
from intrinsic_neural_fields_tpu_torch.models import make_model
from intrinsic_neural_fields_tpu_torch.ops.interpolate import interpolate_vertex_features
from intrinsic_neural_fields_tpu_torch.ops.ray_gen import pixel_grid_coords
from intrinsic_neural_fields_tpu_torch.ops.raster import intersect_coords_pinhole
from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import (
    compute_first_k_eigenfunctions,
)

torch.set_num_threads(2)

H = W = 24
K_EF = 8


def _write_dataset(root, mesh):
    """Two posed views in the MeshViews layout, GT colored by the
    procedural texture at the traced hit points."""
    K = pinhole_K(H, W)
    names = []
    for i, eye in enumerate([(0.3, -2.8, 0.6), (2.6, 0.8, -0.3)]):
        cam = look_at_cam(np.array(eye))
        hits = intersect_coords_pinhole(mesh.vertices, mesh.faces, cam, K,
                                        pixel_grid_coords(H, W), W=W, H=H, device="cpu")
        vids = torch.as_tensor(mesh.faces.astype(np.int64))[hits.face_idx.clamp(min=0)]
        pts = interpolate_vertex_features(torch.as_tensor(mesh.vertices), vids, hits.bary)
        mask = hits.valid.numpy()
        img = np.ones((H * W, 3))
        img[mask] = procedural_texture(pts.numpy()[mask])
        view = os.path.join(root, f"view{i}")
        os.makedirs(os.path.join(view, "depth"))
        os.makedirs(os.path.join(view, "image"))
        np.savez(os.path.join(view, "depth", "cameras.npz"), world_mat_0=cam, camera_mat_0=K)
        imwrite(os.path.join(view, "depth", "mask.png"),
                (mask.reshape(H, W) * 255).astype(np.uint8))
        imwrite(os.path.join(view, "image", "000.png"), img.reshape(H, W, 3).astype(np.float32))
        names.append(f"view{i}")
    with open(os.path.join(root, "test.lst"), "w") as f:
        f.write("\n".join(names) + "\n")


def test_eval_cli_matches_jax_evaluate_views(tmp_path):
    """Same dataset and weights: equal hit masks, so PSNR differs only by
    the MLP's rounding (the JAX CPU path is f32, the port's plain twin
    rounds operands to bf16): per-view PSNR within 0.1 dB, DSSIM x100
    within 0.05; LPIPS NaN on both sides."""
    mesh = blob_mesh(2)
    data = tmp_path / "data"
    data.mkdir()
    mesh_path = str(tmp_path / "blob.obj")
    write_obj(mesh_path, mesh.vertices, mesh.faces)
    ef_path = str(tmp_path / "efuncs.npy")
    np.save(ef_path, compute_first_k_eigenfunctions(mesh, K_EF).astype(np.float32))
    _write_dataset(str(data), mesh)

    model_cfg = {"k": K_EF, "num_layers": 4, "mlp_hidden_dim": 32, "skip_layer_idx": 2}
    out_dir = tmp_path / "run"
    out_dir.mkdir()
    torch.save(make_model(model_cfg, seed=3, device="cpu").state_dict(), out_dir / "model.pt")
    config = {"data": {"mesh_path": mesh_path, "eigenfunctions_path": ef_path,
                       "img_height": H, "img_width": W},
              "model": {**model_cfg, "k": {"ranges": [[0, K_EF]]}},
              "training": {"out_dir": str(out_dir)}}
    cfg_path = str(tmp_path / "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)

    port_out = tmp_path / "port_eval"
    eval_main([str(port_out), cfg_path, str(data), "test", "--device", "cpu"])
    with open(port_out / "evaluation_metrics.pkl", "rb") as f:
        got = pickle.load(f)
    assert sorted(os.listdir(port_out)) == sorted(
        ["evaluation_metrics.pkl"] + [f"00{i}_{s}.png" for i in range(2)
                                      for s in ("fake_raw", "fake", "real")])

    jax_config = {**config, "model": {**model_cfg, "k": K_EF}}
    _, want = jax_evaluate_views(str(tmp_path / "jax_eval"), jax_config, str(data), "test")
    assert set(got) == set(want) == {"000", "001"}
    for view in want:
        assert got[view]["psnr"] == pytest.approx(want[view]["psnr"], abs=0.1)
        assert got[view]["dssim_rescaled"] == pytest.approx(
            want[view]["dssim_rescaled"], abs=0.05)
        assert np.isnan(got[view]["lpips_rescaled"])


def test_evaluate_views_refuses_a_non_white_background(tmp_path):
    """Both packages build the MeshViews dataset with the caller's
    background, and the dataset takes only white: evaluate_views on a
    dataset directory with background="black" raises its AssertionError
    before anything is rendered."""
    (tmp_path / "test.lst").write_text("view0\n")
    config = {"data": {"img_height": H, "img_width": W}, "model": {}, "training": {}}
    from intrinsic_neural_fields_tpu_torch.evaluation.eval_cli import evaluate_views

    with pytest.raises(AssertionError, match="white background"):
        evaluate_views(None, config, str(tmp_path), "test", background="black")
    with pytest.raises(AssertionError, match="white background"):
        jax_evaluate_views(None, config, str(tmp_path), "test", background="black")
