"""The port's render_view and render_video CLIs against the root CLIs'
camera fitting and the JAX package's Renderer on the same weights and
poses (JAX renderer: infer="xla" on the CPU)."""
import os

import numpy as np
import pytest
import torch
import yaml

import render_video as root_rv

from intrinsic_neural_fields_tpu_torch import render_video, render_view
from intrinsic_neural_fields_tpu_torch.geometry.mesh_io import write_obj
from intrinsic_neural_fields_tpu_torch.geometry.synthetic import blob_mesh, look_at_cam, pinhole_K
from intrinsic_neural_fields_tpu_torch.models import make_model
from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import (
    compute_first_k_eigenfunctions)
from intrinsic_neural_fields_tpu_torch.utils.io import imread

torch.set_num_threads(2)

H = W = 64


@pytest.mark.parametrize("size,res", [((256, 256), "720p"), ((512, 512), "1080p"),
                                      ((64, 64), "720p"), ((480, 640), "2160p"),
                                      ((360, 640), "720p")])
def test_fit_camera_to_resolution_matches_the_root_cli(size, res):
    """Exact: the same Fraction arithmetic, K to the bit, the same asserts."""
    h, w = size
    K = np.array([[1.2 * w, 0, (w - 1) / 2, 0], [0, 1.2 * w, (h - 1) / 2, 0], [0, 0, 1, 0]],
                 np.float32)
    cam = {"K": K, "height": h, "width": w}
    got = render_video.fit_camera_to_resolution(cam, render_video.resolutions[res])
    want = root_rv.fit_camera_to_resolution(cam, root_rv.resolutions[res])
    assert (got["height"], got["width"]) == (want["height"], want["width"])
    assert (got["width"], got["height"]) == render_video.resolutions[res]
    np.testing.assert_array_equal(got["K"], want["K"])
    assert got["K"].dtype == want["K"].dtype


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("views"))
    mesh = blob_mesh(2)
    mesh_path = os.path.join(root, "blob.obj")
    write_obj(mesh_path, mesh.vertices, mesh.faces)
    ef_path = os.path.join(root, "efuncs.npy")
    np.save(ef_path, compute_first_k_eigenfunctions(mesh, 8).astype(np.float32))
    cfg = {"k": 8, "num_layers": 4, "mlp_hidden_dim": 32, "skip_layer_idx": 2}
    out_dir = os.path.join(root, "run")
    os.makedirs(out_dir)
    torch.save(make_model(cfg, seed=11, device="cpu").state_dict(),
               os.path.join(out_dir, "model.pt"))
    config = {"data": {"mesh_path": mesh_path, "eigenfunctions_path": ef_path,
                       "img_height": H, "img_width": W},
              "model": cfg, "training": {"out_dir": out_dir}}
    cfg_dir = os.path.join(root, "blob_exp")
    os.makedirs(cfg_dir)
    cfg_path = os.path.join(cfg_dir, "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)
    cams = os.path.join(root, "cameras.npz")
    np.savez(cams, world_mat_0=look_at_cam(np.array([0.4, -2.6, 0.9])),
             camera_mat_0=pinhole_K(H, W))
    return {"root": root, "config": config, "cfg_path": cfg_path, "cams": cams}


def _jax_renderer(config, **kw):
    from intrinsic_neural_fields_tpu.render.renderer import make_renderer_with_trained_model

    return make_renderer_with_trained_model(config, infer="xla", **kw)


def test_render_video_three_frames_match_jax(experiment, monkeypatch):
    """`python -m ...render_video --fps 3 --duration 1` at a 160x90
    resolution (added to the table for the test: 720p frames take over a
    minute on the CPU; the card runs 720p in chip_smoke.py): 3 frames at
    the root CLI's turntable poses, each within one 8-bit step of the JAX
    Renderer's uint8 frame at the same pose (bf16 operands against f32 can
    move a colour across a rounding edge); the frames are written as
    NNNN.jpg, with the ffmpeg command printed when ffmpeg is not installed."""
    import intrinsic_neural_fields_tpu_torch.utils.io as port_io
    from intrinsic_neural_fields_tpu.geometry.cameras import load_extr_and_intr_camera

    frames = {}
    real_imwrite = port_io.imwrite

    def recording_imwrite(path, img):
        frames[os.path.basename(path)] = np.array(img)
        real_imwrite(path, img)

    monkeypatch.setattr(port_io, "imwrite", recording_imwrite)
    monkeypatch.setattr("shutil.which", lambda name: None)
    monkeypatch.setitem(render_video.resolutions, "90p", (160, 90))
    out = os.path.join(experiment["root"], "video")
    n = render_video.main(["--out_dir", out, "--config_path", experiment["cfg_path"],
                           "--cameras_path", experiment["cams"], "--resolution", "90p",
                           "--fps", "3", "--duration", "1", "--turns", "1", "--device", "cpu"])
    assert n == 3 and sorted(frames) == ["0000.jpg", "0001.jpg", "0002.jpg"]
    folder = os.path.join(out, "images", "blob_exp_90p")
    assert sorted(os.listdir(folder)) == sorted(frames)
    assert imread(os.path.join(folder, "0001.jpg")).shape == (90, 160, 3)

    jr = _jax_renderer(experiment["config"], wire_u8=True)
    camCv2world, K = load_extr_and_intr_camera(experiment["cams"])
    cam = root_rv.fit_camera_to_resolution({"K": K, "height": H, "width": W}, (160, 90))
    jr.set_height(cam["height"])
    jr.set_width(cam["width"])
    cam44 = np.eye(4, dtype=np.float32)
    cam44[:3, :4] = camCv2world[:3, :4]
    for i, a in enumerate(np.linspace(0, 360, 3)):
        st, ct = np.sin(np.deg2rad(a)), np.cos(np.deg2rad(a))
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = np.array([[ct, -st, 0], [st, ct, 0], [0, 0, 1]])
        want = jr.render((pose @ cam44)[:3], cam["K"])
        got = frames[f"{i:04d}.jpg"]
        assert got.shape == want.shape == (90, 160, 3)
        assert np.abs(got - want).max() <= 1.0 / 255 + 1e-6
        assert (got < 1).any()  # the blob is in frame


def test_render_view_matches_jax(experiment, tmp_path):
    """`python -m ...render_view --height 48 --width 80`: K resized from the
    config's 64x64 (principal-point offset kept), the PNG within one 8-bit
    step of the JAX Renderer's image rounded as the root CLI rounds it."""
    from intrinsic_neural_fields_tpu.geometry.cameras import cam_resize, load_extr_and_intr_camera

    out = str(tmp_path / "view.png")
    view = render_view.main(["--output_path", out, "--config_path", experiment["cfg_path"],
                             "--cameras_path", experiment["cams"], "--height", "48",
                             "--width", "80", "--device", "cpu"])
    got = imread(out).astype(int)
    assert got.shape == view.shape == (48, 80, 3)
    jr = _jax_renderer(experiment["config"])
    camCv2world, K = load_extr_and_intr_camera(experiment["cams"])
    cam = cam_resize({"K": K, "height": H, "width": W}, 48, 80)
    jr.set_height(48)
    jr.set_width(80)
    want = (jr.render(camCv2world, cam["K"]) * 255.0 + 0.5).clip(0, 255).astype(int)
    assert np.abs(got - want).max() <= 1
    assert (got < 255).any()


def test_view_clis_default_to_the_gpu(experiment, tmp_path):
    """Without --device both CLIs run on CUDA: here, without a card, they
    raise before rendering anything."""
    for main, argv in ((render_view.main, ["--output_path", str(tmp_path / "v.png")]),
                       (render_video.main, ["--out_dir", str(tmp_path / "v"), "--fps", "1",
                                            "--duration", "1"])):
        assert main.__module__.startswith("intrinsic_neural_fields_tpu_torch.")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                main(argv + ["--config_path", experiment["cfg_path"], "--cameras_path",
                             experiment["cams"]])
