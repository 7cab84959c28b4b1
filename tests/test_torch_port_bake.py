"""Texture baking through the port: the OBJ-with-UV reader and the grid
mesh against the JAX package's, the port's bake (its plain forward twin on
the CPU) against the JAX bake on the JAX bake test's grid setup, the bake
CLI and the eval CLI's --uv_mesh_path."""
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from intrinsic_neural_fields_tpu.geometry.mesh_io import read_obj_with_uv as jax_read_obj_with_uv
from intrinsic_neural_fields_tpu.geometry.primitives import grid_mesh as jax_grid_mesh

from intrinsic_neural_fields_tpu_torch.geometry.mesh_io import read_obj_with_uv
from intrinsic_neural_fields_tpu_torch.geometry.primitives import grid_mesh
from intrinsic_neural_fields_tpu_torch.utils.io import imread
from intrinsic_neural_fields_tpu_torch.utils.weights import state_dict_from_flax

from tests.test_bake_transfer import bake_setup  # noqa: F401  (the JAX bake test's fixture)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def port_setup(bake_setup):  # noqa: F811
    """The JAX bake test's out_dir also gets the same weights as a
    reference-layout model.pt, which the port reads (the JAX side keeps
    reading its model.ckpt)."""
    cfg = {"k": 8, "num_layers": 4, "mlp_hidden_dim": 32, "skip_layer_idx": 2}
    sd = state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, bake_setup["variables"]["params"]), cfg)
    with open(bake_setup["config_path"]) as f:
        out_dir = yaml.safe_load(f)["training"]["out_dir"]
    torch.save(sd, os.path.join(out_dir, "model.pt"))
    return bake_setup


@pytest.mark.parametrize("n,scale", [(2, 1.0), (8, 1.0), (13, 2.5)])
def test_grid_mesh_matches_jax(n, scale):
    got, want = grid_mesh(n, scale), jax_grid_mesh(n, scale)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.faces.dtype == want.faces.dtype


def test_read_obj_with_uv_matches_jax(port_setup, tmp_path):
    """Exact on the grid's UV mesh and on a file with a seam (one vertex
    with two texture coordinates, split into two), a quad (fan
    triangulated), negative indices and a corner without a vt."""
    seam = tmp_path / "seam.obj"
    seam.write_text("mtllib seam.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 2 0 0\n"
                    "vt 0 0\nvt 0.5 0\nvt 0.5 0.5\nvt 0 0.5\nvt 0.9 0.1\n"
                    "f 1/1 2/2 3/3 4/4\nf 2/5 5/2 -3/3\nf 1 2/2 5/5\n")
    for path in (port_setup["uv_path"], str(seam)):
        got, want = read_obj_with_uv(path), jax_read_obj_with_uv(path)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        assert got[3] == want[3]
    v, f, uv, _ = read_obj_with_uv(str(seam))
    assert v.shape[0] == 8 and f.shape == (4, 3)  # vertex 2 split by its two vts


def test_bake_matches_jax(port_setup):
    """The port's bake (plain forward twin, which rounds operands to bf16)
    against the JAX bake (f32 on the CPU): same texel coverage, the baked
    texture within 2/255 per channel on every texel, the debug colormap
    within 6/255 (the port's viridis is a polynomial fit of matplotlib's
    table), and the copied .obj/.mtl files."""
    from intrinsic_neural_fields_tpu.bake import bake_texture as jax_bake_texture

    from intrinsic_neural_fields_tpu_torch.bake import bake_texture

    tmp = port_setup["tmp"]
    for size in (None, 48):
        tag = "existing" if size is None else str(size)
        got_path = bake_texture(os.path.join(tmp, f"port_{tag}"), port_setup["uv_path"],
                                port_setup["config_path"], texture_size=size, device="cpu")
        want_path = jax_bake_texture(os.path.join(tmp, f"jax_{tag}"), port_setup["uv_path"],
                                     port_setup["config_path"], texture_size=size)
        got, want = imread(got_path).astype(int), imread(want_path).astype(int)
        assert got.shape == want.shape == ((64, 64, 3) if size is None else (48, 48, 3))
        np.testing.assert_array_equal(got.any(-1), want.any(-1))
        assert np.abs(got - want).max() <= 2
        cm = [imread(p.replace("baked", "colormap")).astype(int) for p in (got_path, want_path)]
        assert np.abs(cm[0] - cm[1]).max() <= 6
        for sub in ("baked", "colormap"):
            assert sorted(os.listdir(os.path.join(tmp, f"port_{tag}", sub))) == sorted(
                os.listdir(os.path.join(tmp, f"jax_{tag}", sub)))


def test_field_rgbs_chunks_and_refusals(port_setup):
    """_field_rgbs evaluates ragged 8,192-point chunks like one call (the
    plain twin is row-independent), refuses view dependence as the JAX bake
    does, and chunks a sine field's module forward the same way (the
    families bake: tests/test_torch_port_families.py)."""
    from intrinsic_neural_fields_tpu_torch.bake.bake import _field_rgbs
    from intrinsic_neural_fields_tpu_torch.train.config import load_config

    config = load_config(port_setup["config_path"])
    mesh = port_setup["mesh"]
    rng = np.random.default_rng(0)
    n = 8192 + 1000
    vids = mesh.faces[rng.integers(0, mesh.num_faces, n)]
    bary = rng.random((n, 3))
    bary /= bary.sum(1, keepdims=True)
    chunked = _field_rgbs(mesh, config, vids, bary, device="cpu")
    whole = _field_rgbs(mesh, config, vids, bary, chunk=n, device="cpu")
    assert chunked.shape == (n, 3) and chunked.dtype == np.float32
    np.testing.assert_array_equal(chunked, whole)
    with pytest.raises(ValueError, match="needs CUDA"):
        _field_rgbs(mesh, config, vids, bary, device="cpu", infer="kernel")
    vd = dict(config, model=dict(config["model"], view_dependence={"strategy": "intrinsic"}))
    with pytest.raises(NotImplementedError, match="view dependence"):
        _field_rgbs(mesh, vd, vids, bary, device="cpu")
    sine = dict(config, model=dict(config["model"], activation="sine"))
    np.testing.assert_array_equal(_field_rgbs(mesh, sine, vids, bary, device="cpu"),
                                  _field_rgbs(mesh, sine, vids, bary, chunk=n, device="cpu"))


def test_viridis_fit():
    """The debug colormap's polynomial stays within 0.02 of matplotlib's
    256-entry viridis table (whose own steps are ~0.005-0.01)."""
    import matplotlib.pyplot as plt

    from intrinsic_neural_fields_tpu_torch.bake.bake import viridis

    t = np.linspace(0, 1, 4097)
    assert np.abs(viridis(t) - plt.cm.viridis(t)[:, :3]).max() < 0.02


def _grid_view(root, mesh, H, W):
    """One MeshViews view of the grid from above, GT by the host tracer."""
    from intrinsic_neural_fields_tpu_torch.geometry.synthetic import (look_at_cam, pinhole_K,
                                                                      render_gt_view)
    from intrinsic_neural_fields_tpu_torch.utils.io import imwrite

    cam = look_at_cam(np.array([0.5, 0.45, 2.2]), target=np.array([0.5, 0.5, 0.0]),
                      up=np.array([0.0, 1.0, 0.0]))
    K = pinhole_K(H, W)
    img, mask = render_gt_view(mesh, cam, K, H, W, tracer="host")
    view = os.path.join(root, "view0")
    os.makedirs(os.path.join(view, "depth"))
    os.makedirs(os.path.join(view, "image"))
    np.savez(os.path.join(view, "depth", "cameras.npz"), world_mat_0=cam, camera_mat_0=K)
    imwrite(os.path.join(view, "depth", "mask.png"), (mask * 255).astype(np.uint8))
    imwrite(os.path.join(view, "image", "000.png"), img)
    with open(os.path.join(root, "test.lst"), "w") as f:
        f.write("view0\n")
    return mask


def test_bake_cli_and_eval_uv_mesh_path(port_setup, tmp_path):
    """`python -m ...bake_texture_field` writes the baked texture the
    library call writes, and `python -m ...eval --uv_mesh_path` bakes into
    output_path before it scores the split (root eval.py:37-41)."""
    import pickle

    from intrinsic_neural_fields_tpu_torch import bake_texture_field
    from intrinsic_neural_fields_tpu_torch.bake import bake_texture
    from intrinsic_neural_fields_tpu_torch.eval import main as eval_main

    uv, cfg = port_setup["uv_path"], port_setup["config_path"]
    cli = bake_texture_field.main(["--uv_mesh", uv, "--config_path", cfg, "--out_dir",
                                   str(tmp_path / "cli"), "--texture_size", "32",
                                   "--device", "cpu"])
    lib = bake_texture(str(tmp_path / "lib"), uv, cfg, texture_size=32, device="cpu")
    np.testing.assert_array_equal(imread(cli), imread(lib))

    data = str(tmp_path / "views")
    mask = _grid_view(data, port_setup["mesh"], 32, 32)  # the config's size
    assert mask.any()
    out = tmp_path / "eval"
    eval_main([str(out), cfg, data, "test", "--uv_mesh_path", uv, "--device", "cpu"])
    assert os.path.exists(out / "baked" / "texture.png")
    assert os.path.exists(out / "colormap" / "texture.png")
    with open(out / "evaluation_metrics.pkl", "rb") as f:
        metrics = pickle.load(f)
    assert list(metrics) == ["000"] and np.isfinite(metrics["000"]["psnr"])
