"""The port's LPIPS (torch convolutions) against the JAX package's
lpips_jax on the same random AlexNet weights (the repo holds no trained
LPIPS weights), and the eval CLI's LPIPS column with and without them."""
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

from intrinsic_neural_fields_tpu.evaluation.lpips_jax import LPIPS as JaxLPIPS

from intrinsic_neural_fields_tpu_torch.evaluation.lpips import ALEX_CFG, LPIPS

torch.set_num_threads(2)


def _random_weights(seed=0):
    """conv{i}_w/_b and lin{i}_w arrays of AlexNet's shapes (the layout the
    JAX package's convert_torch_weights writes)."""
    rng = np.random.default_rng(seed)
    arrays, in_ch = {}, 3
    for i, (out_ch, k, _, _, _) in enumerate(ALEX_CFG):
        arrays[f"conv{i}_w"] = rng.normal(scale=0.05, size=(out_ch, in_ch, k, k)).astype(np.float32)
        arrays[f"conv{i}_b"] = rng.normal(scale=0.02, size=out_ch).astype(np.float32)
        arrays[f"lin{i}_w"] = np.abs(rng.normal(size=(1, out_ch, 1, 1))).astype(np.float32)
        in_ch = out_ch
    return arrays


@pytest.fixture(scope="module")
def weights_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_alex.npz")
    np.savez(path, **_random_weights())
    return path


@pytest.mark.parametrize("H,W", [(64, 64), (96, 128)])
def test_lpips_matches_jax_on_random_weights(weights_path, H, W):
    """Same weights and images: the distance within 1e-5 relative of the
    JAX metric (both f32; only the convolutions' summation order differs)."""
    rng = np.random.default_rng(H + W)
    a = rng.random((H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    got = LPIPS(weights_path, device="cpu")(a, b)
    want = JaxLPIPS(weights_path)(a, b)
    assert np.isfinite(got) and got > 0
    assert got == pytest.approx(want, rel=1e-5)
    assert LPIPS(weights_path, device="cpu")(a, a) == 0.0


def test_lpips_unavailable_without_weights(tmp_path):
    """No npz, no metric: available() is False (the eval CLI then reports
    NaN), and a call raises instead of inventing a number."""
    for path in (None, str(tmp_path / "missing.npz")):
        lp = LPIPS(path, device="cpu")
        assert not lp.available()
        with pytest.raises(RuntimeError, match="no LPIPS weights"):
            lp(np.zeros((64, 64, 3), np.float32), np.zeros((64, 64, 3), np.float32))


def test_lpips_defaults_to_the_gpu(weights_path):
    if torch.cuda.is_available():
        assert LPIPS(weights_path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LPIPS(weights_path)


def _write_views(root, mesh, H, W):
    """Two posed MeshViews-layout views, GT by the host tracer."""
    from intrinsic_neural_fields_tpu_torch.geometry.synthetic import (look_at_cam, pinhole_K,
                                                                      render_gt_view)
    from intrinsic_neural_fields_tpu_torch.utils.io import imwrite

    K = pinhole_K(H, W)
    names = []
    for i, eye in enumerate([(0.3, -2.8, 0.6), (2.6, 0.8, -0.3)]):
        cam = look_at_cam(np.array(eye))
        img, mask = render_gt_view(mesh, cam, K, H, W, tracer="host")
        view = os.path.join(root, f"view{i}")
        os.makedirs(os.path.join(view, "depth"))
        os.makedirs(os.path.join(view, "image"))
        np.savez(os.path.join(view, "depth", "cameras.npz"), world_mat_0=cam, camera_mat_0=K)
        imwrite(os.path.join(view, "depth", "mask.png"), (mask * 255).astype(np.uint8))
        imwrite(os.path.join(view, "image", "000.png"), img)
        names.append(f"view{i}")
    with open(os.path.join(root, "test.lst"), "w") as f:
        f.write("\n".join(names) + "\n")


def test_eval_cli_lpips_column(weights_path, tmp_path):
    """`python -m ...eval --lpips_weights` fills the LPIPS column (64x64
    views: AlexNet's three pools need ~64 pixels); each view's value
    equals the JAX evaluate_views' on the same split and model.pt within
    1e-3 relative (the two renders differ only by the forward's bf16
    operand rounding); without weights the column is NaN."""
    from intrinsic_neural_fields_tpu.evaluation.eval_cli import (
        evaluate_views as jax_evaluate_views)

    from intrinsic_neural_fields_tpu_torch.eval import main as eval_main
    from intrinsic_neural_fields_tpu_torch.geometry.mesh_io import write_obj
    from intrinsic_neural_fields_tpu_torch.geometry.synthetic import blob_mesh
    from intrinsic_neural_fields_tpu_torch.models import make_model
    from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import (
        compute_first_k_eigenfunctions)

    H = W = 64
    mesh = blob_mesh(2)
    data = str(tmp_path / "data")
    mesh_path = str(tmp_path / "blob.obj")
    write_obj(mesh_path, mesh.vertices, mesh.faces)
    ef_path = str(tmp_path / "efuncs.npy")
    np.save(ef_path, compute_first_k_eigenfunctions(mesh, 8).astype(np.float32))
    _write_views(data, mesh, H, W)
    model_cfg = {"k": 8, "num_layers": 4, "mlp_hidden_dim": 32, "skip_layer_idx": 2}
    out_dir = tmp_path / "run"
    out_dir.mkdir()
    torch.save(make_model(model_cfg, seed=5, device="cpu").state_dict(), out_dir / "model.pt")
    config = {"data": {"mesh_path": mesh_path, "eigenfunctions_path": ef_path,
                       "img_height": H, "img_width": W},
              "model": model_cfg, "training": {"out_dir": str(out_dir)}}
    cfg_path = str(tmp_path / "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)

    def port_eval(name, *extra):
        eval_main([str(tmp_path / name), cfg_path, data, "test", "--device", "cpu", *extra])
        with open(tmp_path / name / "evaluation_metrics.pkl", "rb") as f:
            return pickle.load(f)

    got = port_eval("port", "--lpips_weights", weights_path)
    _, want = jax_evaluate_views(str(tmp_path / "jax"), config, data, "test",
                                 lpips_weights_path=weights_path)
    assert set(got) == set(want) == {"000", "001"}
    for view in want:
        assert np.isfinite(got[view]["lpips_rescaled"]) and got[view]["lpips_rescaled"] > 0
        assert got[view]["lpips_rescaled"] == pytest.approx(want[view]["lpips_rescaled"],
                                                            rel=1e-3)
    assert all(np.isnan(m["lpips_rescaled"]) for m in port_eval("nan").values())
