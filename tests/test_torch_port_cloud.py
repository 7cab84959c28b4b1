"""The point-cloud path through the port against the JAX package, on the
CPU at a small size: a faceless PLY -> local triangulation ->
pc_vert_robust operator -> eigenbasis -> ray caches -> training, the
eigenfunction CLI on it, and the transfer experiment's cloud target
(make_transfer_targets --targets cloud, texture_transfer with
--laplacian_type pc_vert_robust).

Tolerances: eigenvalues within 1e-8 relative and eigenfunctions within
1e-6 up to sign (the same scipy arithmetic on equal operators); the ray
caches through the f64 host intersector equal to the bit, and through the
raster tracer within chip_smoke.py's AGREE_MIN: face ids equal on >= 0.999
of the rays (a locally triangulated cloud is a soup of overlapping
triangles, and an f32 hit on a shared edge may land on either face:
measured 1 of 5,396 rays, 7.4e-5 from the edge), on those rays vertex ids
equal and barycentrics within 2e-4 (tests/test_torch_port_preprocess.py's
raster gate), colours and ray directions equal on every ray;
files written by both tools equal; the transferred field's features
within 1e-6 and colours within 2e-3 (tests/test_torch_port_transfer.py's
gates)."""
import filecmp
import os
import sys

import numpy as np
import pytest
import torch
import yaml

import preprocess_dataset as jax_preprocess_cli
import texture_transfer as root_tt
from intrinsic_neural_fields_tpu.data.preprocess import MeshViewPreProcessor as JaxPreProcessor
from intrinsic_neural_fields_tpu.geometry.mesh import load_mesh as jax_load_mesh
from intrinsic_neural_fields_tpu.spectral.eigensolver import (
    EigenfuncsProcessor as JaxEigenfuncsProcessor)
from tools import make_transfer_targets as tools_mtt

from intrinsic_neural_fields_tpu_torch import (make_transfer_targets, preprocess_dataset,
                                               preprocess_eigenfunctions, texture_transfer)
from intrinsic_neural_fields_tpu_torch.data.datasets import read_split_list
from intrinsic_neural_fields_tpu_torch.data.preprocess import MeshViewPreProcessor
from intrinsic_neural_fields_tpu_torch.geometry.mesh import is_pointcloud_file, load_mesh
from intrinsic_neural_fields_tpu_torch.geometry.synthetic import (blob_mesh, look_at_cam,
                                                                  make_dataset, pinhole_K)
from intrinsic_neural_fields_tpu_torch.models import make_model
from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import (
    EigenfuncsProcessor, compute_first_k_eigenfunctions)

torch.set_num_threads(2)

H = W = 48
K = 24
AGREE_MIN = 0.999
CACHE = ("face_idxs", "vids_of_hit_faces", "barycentric_coords", "expected_rgbs",
         "unit_ray_dirs")


@pytest.fixture(scope="module")
def cloud(tmp_path_factory):
    """Views of the subdivision-3 blob and its 642 vertices as a faceless
    binary PLY (make_transfer_targets' writer)."""
    root = str(tmp_path_factory.mktemp("cloud"))
    data = os.path.join(root, "data")
    make_dataset(data, H=H, W=W, n_train=4, n_val=1, n_test=1, n_vis=1, subdivisions=3)
    cloud_path = os.path.join(root, "cloud.ply")
    make_transfer_targets.write_cloud_ply(cloud_path, blob_mesh(3).vertices)
    return {"root": root, "data": data, "cloud": cloud_path}


def _cache(path):
    return {n: np.load(os.path.join(path, f"{n}.npy")) for n in CACHE}


def test_preprocess_eigenfunctions_cli_on_a_faceless_ply(cloud, tmp_path, monkeypatch, capsys):
    """The port's CLI and the JAX CLI on the cloud with pc_vert_robust:
    the same file names, eigenvalues and functions; "pointcloud" printed;
    chefsi on the CPU to the shift-invert oracle (1e-4 of the largest)."""
    import preprocess_eigenfunctions as jax_cli
    from intrinsic_neural_fields_tpu.utils import compile_cache

    assert is_pointcloud_file(cloud["cloud"])
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    preprocess_eigenfunctions.main([str(port_dir), cloud["cloud"], str(K), "--laplacian_type",
                                    "pc_vert_robust"])
    assert "eigenfunctions of a pointcloud" in capsys.readouterr().out
    monkeypatch.setattr(compile_cache, "enable_persistent_compile_cache", lambda: None)
    monkeypatch.setattr(sys, "argv", ["preprocess_eigenfunctions.py", str(jax_dir),
                                      cloud["cloud"], str(K), "--laplacian_type",
                                      "pc_vert_robust"])
    jax_cli.main()
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    base = f"pc_vert_robust_kmax{K}_skip_first_efuncs"
    ev, jev = (np.load(d / f"eigenvalues_{base}.npy") for d in (port_dir, jax_dir))
    ef, jef = (np.load(d / f"eigenfunctions_{base}.npy") for d in (port_dir, jax_dir))
    assert ef.dtype == np.float32 and ef.shape == jef.shape == (642, K)
    np.testing.assert_allclose(ev, jev, rtol=1e-8)
    np.testing.assert_allclose(ef * np.sign(np.sum(ef * jef, axis=0)), jef, atol=1e-6)

    chefsi_dir = tmp_path / "chefsi"
    preprocess_eigenfunctions.main([str(chefsi_dir), cloud["cloud"], str(K), "--laplacian_type",
                                    "pc_vert_robust", "--method", "chefsi", "--device", "cpu"])
    ev_c = np.load(chefsi_dir / f"eigenvalues_{base}.npy")
    assert np.abs(ev_c - jev).max() < 1e-4 * np.abs(jev).max()


def test_cloud_pipeline_end_to_end(cloud, tmp_path):
    """EigenfuncsProcessor on the cloud (the JAX package's eigenvalues to
    1e-8), preprocess_dataset on the locally triangulated cloud through the
    raster tracer and the host intersector (the JAX package's caches),
    then three epochs of the fused recipe through the Trainer: loss falls."""
    from intrinsic_neural_fields_tpu_torch.train import (Trainer, get_data, get_model_and_optim,
                                                         get_renderer)

    proc = EigenfuncsProcessor(cloud["cloud"], K, "pc_vert_robust")
    jproc = JaxEigenfuncsProcessor(cloud["cloud"], K, "pc_vert_robust")
    np.testing.assert_allclose(proc.get_eigenvalues(), jproc.get_eigenvalues(), rtol=1e-8)
    assert proc.get_eigenvalues().min() > -1e-6
    np.testing.assert_array_equal(proc.mesh.faces, jproc.mesh.faces)
    ef_path = str(tmp_path / "efuncs_pc.npy")
    np.save(ef_path, proc.get_eigenfunctions())

    pp = str(tmp_path / "pre")
    for split in ("train", "val"):
        preprocess_dataset.preprocess_dataset(split, cloud["data"], cloud["cloud"], pp, None,
                                              False, device="cpu")
    views = read_split_list(cloud["data"], "train")
    host = str(tmp_path / "host")
    pre = MeshViewPreProcessor(cloud["cloud"], host, intersector="host", device="cpu")
    preprocess_dataset.preprocess_views(pre, views, cloud["data"])
    for intersector, path in (("device", os.path.join(pp, "train")), ("host", host)):
        jp = JaxPreProcessor(cloud["cloud"], str(tmp_path / f"jax_{intersector}"),
                             intersector=intersector)
        jax_preprocess_cli.preprocess_views(jp, views, cloud["data"])
        got, want = _cache(path), _cache(str(tmp_path / f"jax_{intersector}"))
        assert got["face_idxs"].shape[0] > 1000
        for n in CACHE:
            assert got[n].dtype == want[n].dtype and got[n].shape == want[n].shape, n
        if intersector == "host":
            for n in CACHE:
                np.testing.assert_array_equal(got[n], want[n], err_msg=n)
            continue
        for n in ("expected_rgbs", "unit_ray_dirs"):
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        same = got["face_idxs"] == want["face_idxs"]
        assert same.mean() >= AGREE_MIN, same.mean()
        np.testing.assert_array_equal(got["vids_of_hit_faces"][same],
                                      want["vids_of_hit_faces"][same])
        np.testing.assert_allclose(got["barycentric_coords"][same],
                                   want["barycentric_coords"][same], atol=2e-4)

    config = {"seed": 0,
              "data": {"preproc_data_path_train": os.path.join(pp, "train"),
                       "preproc_data_path_eval": os.path.join(pp, "val"),
                       "eigenfunctions_path": ef_path, "mesh_path": cloud["cloud"],
                       "img_height": H, "img_width": W, "precompute_dtype": "bfloat16",
                       "eval_render_input_paths": [], "eval_render_img_names": []},
              "model": {"k": K, "num_layers": 4, "mlp_hidden_dim": 128, "skip_layer_idx": 2},
              "training": {"out_dir": str(tmp_path / "out"), "batch_size": 512, "lr": 3e-3,
                           "loss_type": "L1", "render_every": 1000, "print_every": 1000,
                           "epochs": 3, "shuffle": "blocks", "fused_mlp": True}}
    mesh = load_mesh(cloud["cloud"])
    data = get_data(config, mesh, device="cpu")
    model, opt = get_model_and_optim(config, mesh, device="cpu")

    class Rec:
        rows = []

        def add_scalar(self, tag, value, global_step=None):
            self.rows.append((tag, float(value)))

        def add_image(self, tag, img, global_step=None):
            pass
    rec = Rec()
    Trainer(model, opt, "L1", get_renderer(config, model, mesh, device="cpu"), data, mesh,
            config, writer=rec, device="cpu").train()
    losses = [v for tag, v in rec.rows if tag == "Train_Loss"]
    assert len(losses) == 3 and losses[-1] < losses[0], losses


def test_cloud_transfer_target_matches_the_tools_module(cloud, tmp_path):
    """make_transfer_targets --targets cloud writes the JAX tool's cloud.ply
    (bytes) and corr_cloud.npy, and its basis within 1e-6; texture_transfer
    onto cloud.ply with --laplacian_type pc_vert_robust renders like the
    root CLI's transferred renderer."""
    src = blob_mesh(2)
    k_ef, k_basis = 8, 12
    ef_path = str(tmp_path / "efuncs.npy")
    np.save(ef_path, compute_first_k_eigenfunctions(src, k_ef).astype(np.float32))
    out = str(tmp_path / "targets")
    make_transfer_targets.main(["--out_dir", out, "--src_dataset", cloud["data"], "--src_efuncs",
                                ef_path, "--src_subdivisions", "2", "--k_basis", str(k_basis),
                                "--targets", "cloud"])
    assert sorted(os.listdir(out)) == ["cloud.ply", "corr_cloud.npy", "efuncs_full_cloud.npy",
                                       "efuncs_skip_cloud.npy", "source_efuncs_full.npy"]
    want_ply = str(tmp_path / "jax_cloud.ply")
    tools_mtt.write_cloud_ply(want_ply, src.vertices)
    assert filecmp.cmp(os.path.join(out, "cloud.ply"), want_ply, shallow=False)
    np.testing.assert_array_equal(np.load(os.path.join(out, "corr_cloud.npy")),
                                  np.arange(src.num_vertices, dtype=np.int64))
    want, _ = tools_mtt.spliced_full_basis(jax_load_mesh(want_ply), k_basis, "pc_vert_robust")
    got = np.load(os.path.join(out, "efuncs_full_cloud.npy"))
    np.testing.assert_allclose(got * np.sign(np.sum(got * want, axis=0)), want, rtol=0,
                               atol=1e-6)

    cfg = {"k": k_ef, "num_layers": 4, "mlp_hidden_dim": 32, "skip_layer_idx": 2}
    run = str(tmp_path / "run")
    os.makedirs(run)
    torch.save(make_model(cfg, seed=7, device="cpu").state_dict(), os.path.join(run, "model.pt"))
    mesh_path = str(tmp_path / "src.obj")
    from intrinsic_neural_fields_tpu_torch.geometry.mesh_io import write_obj

    write_obj(mesh_path, src.vertices, src.faces)
    config = {"seed": 0, "data": {"mesh_path": mesh_path, "eigenfunctions_path": ef_path,
                                  "img_height": H, "img_width": W},
              "model": cfg, "training": {"out_dir": run}}
    args = (os.path.join(out, "cloud.ply"), os.path.join(out, "source_efuncs_full.npy"),
            os.path.join(out, "efuncs_full_cloud.npy"), os.path.join(out, "corr_cloud.npy"))
    pr = texture_transfer.build_transferred_renderer(config, *args, "pc_vert_robust",
                                                     device="cpu")
    jr = root_tt.build_transferred_renderer(config, *args, "pc_vert_robust")
    np.testing.assert_allclose(pr.features.numpy(), np.asarray(jr.features), rtol=0, atol=1e-6)
    Kmat = pinhole_K(H, W)
    for eye in [(0.3, -2.8, 0.6), (2.6, 0.8, -0.3)]:
        cam = look_at_cam(np.array(eye))
        img, hit = pr.render(cam, Kmat, eval_render=True)
        img_ref, hit_ref = jr.render(cam, Kmat, eval_render=True)
        np.testing.assert_array_equal(np.sort(hit), np.sort(hit_ref))
        assert len(hit) > 0
        np.testing.assert_allclose(img, img_ref, rtol=0, atol=2e-3)

    cfg_path = str(tmp_path / "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)
    means = texture_transfer.main(["--config_path", cfg_path, "--target_mesh", args[0],
                                   "--source_efuncs_full", args[1], "--target_efuncs_full",
                                   args[2], "--correspondence", args[3], "--laplacian_type",
                                   "pc_vert_robust", "--eval_dataset", cloud["data"],
                                   "--out_dir", str(tmp_path / "eval"), "--device", "cpu"])
    assert np.isfinite(means["psnr"]) and os.path.exists(tmp_path / "eval" / "000_fake.png")
