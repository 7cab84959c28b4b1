"""The port stands alone: importing every module of
intrinsic_neural_fields_tpu_torch (and chip_smoke.py) loads no jax, flax,
optax, msgpack or intrinsic_neural_fields_tpu module. Checked in a fresh interpreter,
because the test process itself imports the JAX package as the oracle."""
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import intrinsic_neural_fields_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
banned = ("jax", "flax", "optax", "msgpack", "intrinsic_neural_fields_tpu")
bad = sorted(m for m in sys.modules
             if any(m == b or m.startswith(b + ".") for b in banned))
new = ["ops.sort", "ops.launches", "geometry.cameras", "utils.exr", "utils.io",
       "data.preprocess", "native", "preprocess_dataset", "preprocess_eigenfunctions",
       "make_synthetic_dataset", "evaluation.lpips", "transfer", "transfer.functional_map",
       "bake", "bake.bake", "texture_transfer", "bake_texture_field", "render_view",
       "render_video", "make_transfer_targets", "eval_on_mesh", "models.encoders",
       "geometry.pointcloud", "geometry.intrinsic_delaunay", "geometry.shot",
       "spectral.eigensolver", "compute_shot", "models.neutex", "pretrain_neutex_mapping",
       "parallel", "parallel.data_parallel", "bench", "utils.flax_msgpack", "utils.jax_random"]
missing = [m for m in new if pkg.__name__ + "." + m not in names]
print(len(names), "modules;", "banned:", bad, "missing:", missing)
sys.exit(1 if bad or missing or len(names) < 30 else 0)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_eval_cli_parses_arguments():
    from intrinsic_neural_fields_tpu_torch.eval import parse_args

    args = parse_args(["out", "cfg.yaml", "data", "test", "--weights", "m.pt"])
    assert (args.output_path, args.split, args.weights, args.device, args.num_devices) == (
        "out", "test", "m.pt", "cuda", 1)


@pytest.mark.parametrize("module,argv,want", [
    ("preprocess_dataset", ["out", "m.obj", "data", "train"],
     {"device": "cuda", "intersector": "device", "tracer": "raster", "dataset_type": None}),
    ("preprocess_eigenfunctions", ["out", "m.obj", "512"],
     {"k_max": 512, "laplacian_type": "cotan", "method": "shift_invert",
      "keep_first_efunc": False, "device": "cuda"}),
    ("compute_shot", ["out.npy", "m.obj"], {"radius": None, "min_neighbors": 5}),
    ("pretrain_neutex_mapping", ["m.obj", "out.npz"],
     {"iterations": 200_000, "points": 25_000, "max_mesh_points": 30_000, "lr": 1e-4,
      "seed": 0, "print_every": 500, "steps_per_call": 50, "device": "cuda"}),
    ("make_synthetic_dataset", ["out"],
     {"H": 128, "W": 128, "n_train": 10, "subdivisions": 4, "tracer": "host",
      "device": "cuda"}),
])
def test_preprocessing_clis_parse_the_reference_arguments(module, argv, want):
    import importlib

    args = importlib.import_module(f"intrinsic_neural_fields_tpu_torch.{module}").parse_args(argv)
    assert {k: getattr(args, k) for k in want} == want


@pytest.mark.parametrize("module,argv,want", [
    ("render_view", ["--output_path", "v.png"], {"device": "cuda", "height": None,
                                                  "num_devices": 1}),
    ("render_video", ["--out_dir", "o"],
     {"device": "cuda", "resolution": "720p", "fps": 60, "duration": 15, "turns": 2,
      "num_devices": 1}),
    ("bake_texture_field", ["--config_path", "c.yaml", "--out_dir", "o"],
     {"device": "cuda", "texture_size": None}),
    ("texture_transfer", ["--config_path", "c", "--target_mesh", "t", "--source_efuncs_full",
                          "s", "--target_efuncs_full", "t", "--correspondence", "c",
                          "--out_dir", "o"],
     {"device": "cuda", "laplacian_type": "cotan", "eval_split": "test"}),
    ("make_transfer_targets", [],
     {"device": "cuda", "tracer": "device", "k_basis": 1024,
      "targets": ["coarse", "dense", "cloud", "deformed"]}),
    ("eval", ["out", "cfg.yaml", "data", "test"],
     {"device": "cuda", "uv_mesh_path": None, "lpips_weights": None, "num_devices": 1}),
    ("train.__main__", ["cfg.yaml"],
     {"device": "cuda", "num_devices": 1, "allow_checkpoint_loading": False}),
    ("eval_on_mesh", ["--config_path", "c", "--target_mesh", "t", "--eval_dataset", "d",
                      "--out_dir", "o"],
     {"device": "cuda", "eval_split": "test", "efuncs": None, "background": "white"}),
])
def test_user_clis_parse_the_reference_arguments(module, argv, want):
    """The root CLIs' arguments, and the card by default."""
    import importlib

    args = importlib.import_module(f"intrinsic_neural_fields_tpu_torch.{module}").parse_args(argv)
    assert {k: getattr(args, k) for k in want} == want


@pytest.mark.parametrize("kwargs,exc,match", [
    ({"method": "arpack"}, ValueError, "Unknown eigensolver method"),
    ({"laplacian_type": "igl"}, RuntimeError, "not implemented"),
    ({"method": "chefsi"}, RuntimeError, "CUDA is not available"),
    ({"method": "dense"}, RuntimeError, "CUDA is not available"),
])
def test_eigenfunction_processor_refuses_what_it_cannot_run(tmp_path, monkeypatch, kwargs, exc,
                                                            match):
    """An unknown method or Laplacian raises as in the JAX package, and a
    device method on "cuda" without a card (hidden here) raises."""
    from intrinsic_neural_fields_tpu_torch.geometry.mesh_io import write_obj
    from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
    from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import EigenfuncsProcessor

    m = icosphere(1)
    write_obj(str(tmp_path / "m.obj"), m.vertices, m.faces)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(exc, match=match):
        EigenfuncsProcessor(str(tmp_path / "m.obj"), 8, **kwargs)


def test_preprocessor_defaults_to_the_gpu(tmp_path):
    """The device intersector runs on CUDA unless asked for the CPU: here,
    without a card, the default raises before anything is traced."""
    from intrinsic_neural_fields_tpu_torch.data.preprocess import MeshViewPreProcessor
    from intrinsic_neural_fields_tpu_torch.geometry.mesh_io import write_obj
    from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere

    m = icosphere(1)
    write_obj(str(tmp_path / "m.obj"), m.vertices, m.faces)
    if torch.cuda.is_available():
        assert MeshViewPreProcessor(str(tmp_path / "m.obj"), None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MeshViewPreProcessor(str(tmp_path / "m.obj"), None)
