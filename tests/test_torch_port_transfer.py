"""Texture transfer through the port: the functional-map functions, the
degenerate-shell guard, load_correspondence, build_transferred_renderer,
the texture_transfer and make_transfer_targets CLIs, each against the JAX
package (and the root CLI / tools module) on the same inputs."""
import os
import pickle

import numpy as np
import pytest
import scipy.io
import torch
import yaml

import intrinsic_neural_fields_tpu.transfer as jfm
import texture_transfer as root_tt
from tools import make_transfer_targets as tools_mtt

import intrinsic_neural_fields_tpu_torch.transfer as pfm
from intrinsic_neural_fields_tpu_torch import make_transfer_targets, texture_transfer
from intrinsic_neural_fields_tpu_torch.evaluation.metrics import psnr
from intrinsic_neural_fields_tpu_torch.geometry.laplacian import voronoi_mass_matrix
from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh
from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
from intrinsic_neural_fields_tpu_torch.geometry.synthetic import (look_at_cam, make_dataset,
                                                                  pinhole_K)
from intrinsic_neural_fields_tpu_torch.models import make_model
from intrinsic_neural_fields_tpu_torch.render.renderer import make_renderer_from_config
from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import (
    compute_first_k_eigenfunctions)
from intrinsic_neural_fields_tpu_torch.spectral.features import postprocess_eigenfunctions

torch.set_num_threads(2)

K_EF = 8          # the trained field's k
K_BASIS = 12      # the targets' non-constant basis
H = W = 32


def _full_basis(mesh, k):
    return compute_first_k_eigenfunctions(mesh, k, skip_first_efunc=False)


def test_functional_map_functions_match_jax():
    """The five functions on the same numpy inputs give the same arrays,
    to the bit (the port's module is a copy): the P2P matrix, the map C,
    the mapped features (first-k and index-list selection), the guard's
    pass on the spliced basis and the ground-truth map variant."""
    mesh = icosphere(2)
    E = _full_basis(mesh, K_EF + 4)
    perm = np.random.default_rng(0).permutation(mesh.num_vertices)
    M = voronoi_mass_matrix(mesh.vertices, mesh.faces)
    Q = pfm.p2p_matrix(perm, mesh.num_vertices, mesh.num_vertices)
    np.testing.assert_array_equal(Q.toarray(), jfm.p2p_matrix(
        perm, mesh.num_vertices, mesh.num_vertices).toarray())
    np.testing.assert_array_equal(pfm.functional_map_from_p2p(E, M, Q, E),
                                  jfm.functional_map_from_p2p(E, M, Q, E))
    for k in (K_EF, [0, 2, 5, 9]):
        for rescale in (True, False):
            got = pfm.map_eigenfunctions_p2p(E, E, M, perm, k, rescale=rescale)
            want = jfm.map_eigenfunctions_p2p(E, E, M, perm, k, rescale=rescale)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    trained = postprocess_eigenfunctions(E[:, 1:K_EF + 1])
    assert pfm.check_source_basis_matches_trained(E, trained, K_EF) is None
    assert jfm.check_source_basis_matches_trained(E, trained, K_EF) is None
    np.testing.assert_array_equal(pfm.get_remapped_efuncs_with_fm_gt(E[:, 1:], M, E[:, 1:]),
                                  jfm.get_remapped_efuncs_with_fm_gt(E[:, 1:], M, E[:, 1:]))


def test_guard_rejects_an_independently_resolved_basis():
    """A rotated degenerate shell and a lone sign flip (what a re-solve
    does) raise in both packages, naming the splice recipe."""
    mesh = icosphere(3)
    k = 15
    E = _full_basis(mesh, k + 2)
    trained = postprocess_eigenfunctions(E[:, 1:k + 1])
    th = 0.7
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    rotated = E.copy()
    rotated[:, 1:4] = rotated[:, 1:4] @ R
    flipped = E.copy()
    flipped[:, 7] *= -1.0
    for bad in (rotated, flipped):
        for mod in (pfm, jfm):
            with pytest.raises(ValueError, match="splice"):
                mod.check_source_basis_matches_trained(bad, trained, k)
    with pytest.raises(ValueError, match="vertices"):
        pfm.check_source_basis_matches_trained(E[:-1], trained, k)


def test_load_correspondence_mat_and_npy(tmp_path):
    """The reference's .mat layout (struct P, second field, 1-based) and a
    .npy give the root CLI's arrays."""
    corr = np.random.default_rng(1).integers(0, 500, size=37)
    mat = str(tmp_path / "corr.mat")
    scipy.io.savemat(mat, {"P": {"evecs": np.zeros((2, 2)), "P": (corr + 1).reshape(-1, 1)}})
    npy = str(tmp_path / "corr.npy")
    np.save(npy, corr.astype(np.int32))
    for path in (mat, npy):
        got = texture_transfer.load_correspondence(path)
        np.testing.assert_array_equal(got, root_tt.load_correspondence(path))
        np.testing.assert_array_equal(got, corr)
        assert got.dtype == np.int64
    with pytest.raises(ValueError, match="Unsupported"):
        texture_transfer.load_correspondence(str(tmp_path / "corr.txt"))


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A trained-field stand-in on the subdivision-2 blob (random weights,
    its k=8 basis), the source dataset and the transfer targets written by
    the port's make_transfer_targets CLI (host tracer)."""
    root = str(tmp_path_factory.mktemp("transfer"))
    data = os.path.join(root, "data")
    make_dataset(data, H=H, W=W, n_train=2, subdivisions=2)
    mesh_path = os.path.join(data, "blob.obj")
    src = load_mesh(mesh_path)
    ef_path = os.path.join(root, "efuncs.npy")
    np.save(ef_path, compute_first_k_eigenfunctions(src, K_EF).astype(np.float32))
    cfg = {"k": K_EF, "num_layers": 4, "mlp_hidden_dim": 32, "skip_layer_idx": 2}
    out_dir = os.path.join(root, "run")
    os.makedirs(out_dir)
    torch.save(make_model(cfg, seed=7, device="cpu").state_dict(),
               os.path.join(out_dir, "model.pt"))
    config = {"seed": 0,
              "data": {"mesh_path": mesh_path, "eigenfunctions_path": ef_path,
                       "img_height": H, "img_width": W},
              "model": cfg, "training": {"out_dir": out_dir}}
    cfg_path = os.path.join(root, "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)
    targets = os.path.join(root, "targets")
    make_transfer_targets.main(["--out_dir", targets, "--src_dataset", data, "--src_efuncs",
                                ef_path, "--src_subdivisions", "2", "--k_basis", str(K_BASIS),
                                "--targets", "coarse", "deformed", "--tracer", "host"])
    return {"root": root, "data": data, "config": config, "cfg_path": cfg_path,
            "targets": targets, "ef_path": ef_path, "src": src}


def test_make_transfer_targets_matches_the_tools_module(experiment, tmp_path):
    """The port's CLI against tools/make_transfer_targets.py's functions on
    the same meshes: the correspondences exactly, the spliced bases within
    1e-6 (the same deterministic solve), the source basis exactly, and the
    carried-texture GT views of `deformed` equal to the bit; `cloud`
    raises, naming its queue item."""
    from tools.make_synthetic_dataset import blob_mesh as tools_blob

    t = experiment["targets"]
    src = tools_blob(subdivisions=2)
    coarse = tools_blob(subdivisions=1)
    np.testing.assert_array_equal(np.load(os.path.join(t, "corr_coarse.npy")),
                                  np.arange(coarse.num_vertices))
    np.testing.assert_array_equal(np.load(os.path.join(t, "corr_deformed.npy")),
                                  np.arange(src.num_vertices))
    want, _ = tools_mtt.spliced_full_basis(coarse, K_BASIS, "cotan")
    np.testing.assert_allclose(np.load(os.path.join(t, "efuncs_full_coarse.npy")), want,
                               rtol=0, atol=1e-6)
    deformed_v = tools_mtt.twist_deform(src.vertices, rate=0.6)
    np.testing.assert_array_equal(load_mesh(os.path.join(t, "deformed.obj")).vertices,
                                  load_mesh(_write_tools_obj(tmp_path, deformed_v,
                                                             src.faces)).vertices)
    from intrinsic_neural_fields_tpu.geometry.mesh import Mesh as JaxMesh

    deformed = JaxMesh(vertices=deformed_v, faces=src.faces.copy())
    want, M = tools_mtt.spliced_full_basis(deformed, K_BASIS, "cotan")
    np.testing.assert_allclose(np.load(os.path.join(t, "efuncs_full_deformed.npy")), want,
                               rtol=0, atol=1e-6)
    src_full = np.load(os.path.join(t, "source_efuncs_full.npy"))
    _, M_src = tools_mtt.build_laplacian(src, "cotan")
    np.testing.assert_array_equal(src_full[:, 0], tools_mtt.constant_eigenfunction(M_src))
    np.testing.assert_array_equal(src_full[:, 1:], np.load(experiment["ef_path"]))
    np.testing.assert_array_equal(
        make_transfer_targets.nearest_vertex_correspondence(tools_blob(3).vertices, src.vertices),
        tools_mtt.nearest_vertex_correspondence(tools_blob(3).vertices, src.vertices))

    jax_views = str(tmp_path / "jax_views")
    tools_mtt.make_deformed_views(jax_views, deformed, src.vertices, experiment["data"], "test",
                                  tracer="host")
    port_views = os.path.join(t, "deformed_views")
    with open(os.path.join(jax_views, "test.lst")) as f:
        names = f.read().split()
    assert open(os.path.join(port_views, "test.lst")).read().split() == names
    from intrinsic_neural_fields_tpu_torch.utils.io import imread

    for name in names:
        for rel in (("image", "000.png"), ("depth", "mask.png")):
            np.testing.assert_array_equal(imread(os.path.join(port_views, name, *rel)),
                                          imread(os.path.join(jax_views, name, *rel)))
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        make_transfer_targets.main(["--out_dir", str(tmp_path / "c"), "--targets", "cloud"])


def _write_tools_obj(tmp_path, v, f):
    from intrinsic_neural_fields_tpu.geometry.mesh_io import write_obj

    path = str(tmp_path / "tools_deformed.obj")
    write_obj(path, v, f)
    return path


def _transfer_args(experiment, target):
    t = experiment["targets"]
    return (os.path.join(t, f"{target}.obj"), os.path.join(t, "source_efuncs_full.npy"),
            os.path.join(t, f"efuncs_full_{target}.npy"), os.path.join(t, f"corr_{target}.npy"))


@pytest.mark.parametrize("target", ["coarse", "deformed"])
def test_build_transferred_renderer_matches_jax(experiment, target):
    """The port's transferred renderer against the root CLI's on the same
    files: the mapped feature tables to 1e-6, the valid masks equal, and
    the colours within 2e-3 (the port's CPU forward rounds matmul operands
    to bf16, the JAX CPU forward is f32; both ship f16)."""
    config = experiment["config"]
    args = _transfer_args(experiment, target)
    pr = texture_transfer.build_transferred_renderer(config, *args, device="cpu")
    jr = root_tt.build_transferred_renderer(config, *args)
    np.testing.assert_allclose(pr.features.numpy(), np.asarray(jr.features), rtol=0, atol=1e-6)
    assert pr.mesh.num_vertices == jr.mesh.num_vertices
    K = pinhole_K(H, W)
    for eye in [(0.3, -2.8, 0.6), (2.6, 0.8, -0.3)]:
        cam = look_at_cam(np.array(eye))
        img, hit = pr.render(cam, K, eval_render=True)
        img_ref, hit_ref = jr.render(cam, K, eval_render=True)
        np.testing.assert_array_equal(np.sort(hit), np.sort(hit_ref))
        assert len(hit) > 0
        np.testing.assert_allclose(img, img_ref, rtol=0, atol=2e-3)


def test_identity_self_transfer_reproduces_the_source_render(experiment, tmp_path):
    """The source mesh, the spliced source basis and the identity
    correspondence: the transferred field renders as the source field does
    (equal valid masks; PSNR >= 50 dB, the map's f64 round trip may move a
    feature by an ulp)."""
    t = experiment["targets"]
    corr = str(tmp_path / "identity.npy")
    np.save(corr, np.arange(experiment["src"].num_vertices))
    full = str(tmp_path / "src_full.npy")
    np.save(full, np.load(os.path.join(t, "source_efuncs_full.npy")))
    config = experiment["config"]
    pr = texture_transfer.build_transferred_renderer(
        config, config["data"]["mesh_path"], full, full, corr, device="cpu")
    src = make_renderer_from_config(config, device="cpu")
    K = pinhole_K(H, W)
    cam = look_at_cam(np.array([0.3, -2.8, 0.6]))
    img, hit = pr.render(cam, K, eval_render=True)
    want, hit_w = src.render(cam, K, eval_render=True)
    np.testing.assert_array_equal(hit, hit_w)
    mask = np.zeros(H * W, bool)
    mask[hit] = True
    assert psnr(img, want, mask) >= 50.0


def test_texture_transfer_cli(experiment, tmp_path):
    """`python -m ...texture_transfer --eval_dataset` onto `deformed`
    against its carried-texture views scores like the JAX package's
    evaluate_views on the root CLI's renderer (per-view PSNR within 0.1 dB,
    DSSIM x100 within 0.05); render mode writes one PNG per camera; the
    robust Laplacians fail loudly."""
    from intrinsic_neural_fields_tpu.evaluation.eval_cli import (
        evaluate_views as jax_evaluate_views)

    t = experiment["targets"]
    mesh, src_full, tgt_full, corr = _transfer_args(experiment, "deformed")
    argv = ["--config_path", experiment["cfg_path"], "--target_mesh", mesh,
            "--source_efuncs_full", src_full, "--target_efuncs_full", tgt_full,
            "--correspondence", corr, "--device", "cpu"]
    views = os.path.join(t, "deformed_views")
    texture_transfer.main(argv + ["--eval_dataset", views, "--out_dir", str(tmp_path / "ev")])
    with open(tmp_path / "ev" / "evaluation_metrics.pkl", "rb") as f:
        got = pickle.load(f)
    jr = root_tt.build_transferred_renderer(experiment["config"], mesh, src_full, tgt_full, corr)
    _, want = jax_evaluate_views(str(tmp_path / "jax"), experiment["config"], views, "test",
                                 renderer=jr)
    assert set(got) == set(want) and got
    for view in want:
        assert got[view]["psnr"] == pytest.approx(want[view]["psnr"], abs=0.1)
        assert got[view]["dssim_rescaled"] == pytest.approx(want[view]["dssim_rescaled"],
                                                            abs=0.05)

    cams = str(tmp_path / "cams.npz")
    np.savez(cams, world_mat_0=look_at_cam(np.array([0.3, -2.8, 0.6])),
             camera_mat_0=pinhole_K(H, W), world_mat_1=look_at_cam(np.array([2.6, 0.8, -0.3])),
             camera_mat_1=pinhole_K(H, W))
    texture_transfer.main(argv + ["--cameras_path", cams, "--out_dir", str(tmp_path / "r"),
                                  "--render_source_too"])
    assert sorted(os.listdir(tmp_path / "r")) == [
        "source_000.png", "source_001.png", "transfer_000.png", "transfer_001.png"]
    for lap in ("robust", "pc_vert_robust"):
        with pytest.raises(NotImplementedError, match="not ported"):
            texture_transfer.main(argv + ["--cameras_path", cams, "--laplacian_type", lap,
                                          "--out_dir", str(tmp_path / lap)])
