"""Port parity of BatchNorm texture fields on the CPU: the forward in train
and eval mode and the running-statistics update against the JAX package's
TextureField(batchnorm=True) on weights carried by state_dict_from_flax
(including a batch so small that the unbiased variance fails the same
gate), the view-dependent field's flag, the single-device eager epoch
against the JAX XLA epoch, a BatchNorm model.pt through the JAX package's
convert_reference_state_dict, and the port's `-m` CLIs training
(data-parallel, sync-BN), resuming, evaluating and rendering a BatchNorm
field."""
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from intrinsic_neural_fields_tpu.geometry.primitives import icosphere as jax_icosphere
from intrinsic_neural_fields_tpu.models import init_model
from intrinsic_neural_fields_tpu.models import make_model as jax_make_model
from intrinsic_neural_fields_tpu.train.steps import create_train_state as jax_create_state
from intrinsic_neural_fields_tpu.train.steps import make_epoch_fns as jax_epoch_fns
from intrinsic_neural_fields_tpu.utils.torch_convert import convert_reference_state_dict

from intrinsic_neural_fields_tpu_torch.geometry.mesh_io import write_obj
from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
from intrinsic_neural_fields_tpu_torch.geometry.synthetic import blob_mesh, look_at_cam, pinhole_K
from intrinsic_neural_fields_tpu_torch.models import make_model
from intrinsic_neural_fields_tpu_torch.models.texture_field import BN_EPS, BN_MOMENTUM
from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import compute_first_k_eigenfunctions
from intrinsic_neural_fields_tpu_torch.train.steps import (AdamHyper, create_train_state,
                                                           make_epoch_fns)
from intrinsic_neural_fields_tpu_torch.utils.jax_random import PRNGKey
from intrinsic_neural_fields_tpu_torch.utils.weights import (load_reference_weights,
                                                             state_dict_from_flax)

from tests.test_torch_port_eval_cli import H, W, _write_dataset
from tests.test_torch_port_parallel import SMALL, _datasets

torch.set_num_threads(2)

BN = {**SMALL, "batchnorm": True}
VD = {"bottleneck_vec_dim": 32, "in_dim_view_dir": 1, "include_view_dir": True,
      "embed_size": 4, "directional_hidden_dim": 32, "strategy": "intrinsic"}
TOL = 1e-5  # measured <= 2e-7 on outputs and statistics (f32 sums in another order)


def _pair(cfg, seed=1):
    """A JAX BatchNorm field with non-trivial statistics and affine
    parameters, and the port's field on the same variables."""
    viewdep = "view_dependence" in cfg
    jmodel = jax_make_model(cfg, mesh=jax_icosphere(2) if viewdep else None)
    variables = jax.tree_util.tree_map(np.asarray, init_model(
        jmodel, cfg, seed=seed, mesh=jax_icosphere(2) if viewdep else None))
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32), variables)
    tmodel = make_model(cfg, device="cpu", mesh=icosphere(2) if viewdep else None)
    tmodel.load_state_dict(state_dict_from_flax(variables, cfg))
    return jmodel, variables, tmodel


def _batch(rows, viewdep, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, 16)).astype(np.float32)
    dirs = rng.normal(size=(rows, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    faces = rng.integers(0, 320, rows)
    jb = {"eigenfunctions": jnp.asarray(x)}
    args = (torch.from_numpy(x),)
    if viewdep:
        jb.update(unit_ray_dirs=jnp.asarray(dirs), hit_face_idxs=jnp.asarray(faces))
        args += (torch.from_numpy(dirs), torch.from_numpy(faces))
    return jb, args


@pytest.mark.parametrize("viewdep", [False, True])
@pytest.mark.parametrize("rows", [3, 256])
@pytest.mark.parametrize("train", [False, True])
def test_forward_and_running_statistics_match_jax(train, rows, viewdep):
    """Eval mode normalises with the running statistics; train mode with
    the batch's biased variance, and updates the running ones as flax
    does (0.9 running + 0.1 batch). Outputs and statistics within 1e-5. At
    3 rows torch's unbiased running variance would miss the same gate."""
    cfg = {**BN, "view_dependence": VD} if viewdep else BN
    jmodel, variables, tmodel = _pair(cfg)
    jb, args = _batch(rows, viewdep)
    if train:
        want, mutated = jmodel.apply(variables, jb, train=True, mutable=["batch_stats"])
    else:
        want, mutated = jmodel.apply(variables, jb, train=False), {
            "batch_stats": variables["batch_stats"]}
    got = tmodel(*args, train=train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=0)
    stats = state_dict_from_flax({"params": variables["params"],
                                  "batch_stats": jax.device_get(mutated["batch_stats"])}, cfg)
    sd = tmodel.state_dict()
    keys = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * (cfg["num_layers"] - 1)
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), stats[k].numpy(), atol=TOL, rtol=0)
    if train and rows == 3:
        # the first BatchNorm's input, and torch's own update of its statistics
        prefix = "spatial_mlp." if viewdep else ""
        first = getattr(tmodel, "spatial_mlp", tmodel).layers[0]
        h = first[1](first[0](args[0])).detach()
        init = state_dict_from_flax(variables, cfg)
        rm, rv = (init[prefix + "layers.0.2." + s].clone() for s in ("running_mean",
                                                                      "running_var"))
        torch.nn.functional.batch_norm(h, rm, rv, training=True, momentum=1 - BN_MOMENTUM,
                                       eps=BN_EPS)
        key = prefix + "layers.0.2.running_var"
        assert float((rv - stats[key]).abs().max()) > 10 * TOL


def test_bn_state_dict_keys_are_the_reference_names():
    sd = make_model(BN, device="cpu").state_dict()
    for i in (0, 1):
        for s in ("weight", "bias", "running_mean", "running_var", "num_batches_tracked"):
            assert f"layers.{i}.2.{s}" in sd
    assert "layers.2.batchnorm.running_var" in sd and "layers.3.2.weight" not in sd
    assert int(sd["layers.0.2.num_batches_tracked"]) == 0


def test_bn_eager_epochs_match_the_jax_epochs():
    """Two single-device epochs, full shuffle with a ragged tail (its
    clamped duplicates in the batch statistics on both sides), L2, JAX's
    permutation replayed: loss 1e-5, params and running statistics within
    1e-5 absolute plus 1e-5 relative (the perturbed weights put running
    variances near 100), then the val epochs (running statistics) 1e-5."""
    jd, td = _datasets(1000, None)
    jmodel, variables, tmodel = _pair(BN, seed=3)
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    j_train, j_val = jax_epoch_fns(jmodel, opt, "L2", shuffle="full")
    t_train, t_val = make_epoch_fns(tmodel, "L2", shuffle="full")
    jst = jax_create_state(jax.tree_util.tree_map(jnp.array, variables), opt)
    st = create_train_state(tmodel, AdamHyper(1e-3), "cpu")
    for e in range(2):
        key = jax.random.PRNGKey(e)
        jst, jm = j_train(jst, key, jd, 4, 256)
        st, m = t_train(st, np.asarray(jax.random.permutation(key, 1000)), td, 4, 256)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jax.device_get(
        {"params": jst.params, "batch_stats": jst.batch_stats})), BN)
    got = st.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(t_val(st, td, 256)["loss"]),
                               float(j_val(jst, jd, 256)["loss"]), rtol=1e-5)


def test_fused_mlp_refuses_a_bn_field():
    with pytest.raises(ValueError, match="without BatchNorm"):
        make_epoch_fns(make_model(BN, device="cpu"), "L1", shuffle="blocks", fused=True)


@pytest.fixture(scope="module")
def bn_experiment(tmp_path_factory):
    """A blob mesh and its eigenfunctions, random ray caches, a MeshViews
    test split and a BatchNorm config (fused_mlp false, full shuffle)."""
    root = str(tmp_path_factory.mktemp("bn"))
    mesh = blob_mesh(2)
    mesh_path = os.path.join(root, "blob.obj")
    write_obj(mesh_path, mesh.vertices, mesh.faces)
    ef_path = os.path.join(root, "efuncs.npy")
    np.save(ef_path, compute_first_k_eigenfunctions(mesh, 16).astype(np.float32))
    rng = np.random.default_rng(5)
    for split, n in (("train", 1024), ("val", 200), ("test", 200)):
        path = os.path.join(root, split)
        os.makedirs(path)
        np.save(os.path.join(path, "vids_of_hit_faces.npy"),
                rng.integers(0, mesh.num_vertices, (n, 3)).astype(np.int32))
        np.save(os.path.join(path, "barycentric_coords.npy"),
                rng.dirichlet(np.ones(3), n).astype(np.float32))
        np.save(os.path.join(path, "expected_rgbs.npy"), rng.uniform(size=(n, 3)).astype(
            np.float32))
    data = os.path.join(root, "views")
    os.makedirs(data)
    _write_dataset(data, mesh)
    cams = os.path.join(root, "cameras.npz")
    np.savez(cams, world_mat_0=look_at_cam(np.array([0.4, -2.6, 0.9])),
             camera_mat_0=pinhole_K(H, W))

    def config(out_name, epochs):
        cfg = {"seed": 1,
               "data": {"preproc_data_path_train": os.path.join(root, "train"),
                        "preproc_data_path_eval": os.path.join(root, "val"),
                        "preproc_data_path_test": os.path.join(root, "test"),
                        "eigenfunctions_path": ef_path, "mesh_path": mesh_path,
                        "img_height": H, "img_width": W},
               "model": dict(BN),
               "training": {"out_dir": os.path.join(root, out_name), "batch_size": 256,
                            "lr": 1e-3, "loss_type": "L1", "render_every": 100,
                            "print_every": 1, "epochs": epochs, "checkpoint_every": 1,
                            "shuffle": "full", "fused_mlp": False}}
        path = os.path.join(root, f"{out_name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path, cfg

    return {"root": root, "config": config, "data": data, "cams": cams}


def test_bn_clis_train_resume_evaluate_and_render(bn_experiment):
    """`-m train --num_devices 2` (sync-BN over two CPU replicas) for 2
    epochs; a run resumed from its checkpoint.pt for a third epoch equals
    the uninterrupted 3-epoch run to the bit, running statistics included;
    `-m eval` and `-m render_view` with --num_devices 2 equal their
    one-device runs to the bit (at 24^2 pixels one shard holds every ray:
    the sharding itself is held to the bit in test_torch_port_parallel)."""
    from intrinsic_neural_fields_tpu_torch import render_view
    from intrinsic_neural_fields_tpu_torch.eval import main as eval_main
    from intrinsic_neural_fields_tpu_torch.train.__main__ import main as train_main

    root, config = bn_experiment["root"], bn_experiment["config"]
    two = ["--device", "cpu", "--num_devices", "2"]
    path, _ = config("bn2", 2)
    train_main([path, *two])
    shutil.copytree(os.path.join(root, "bn2"), os.path.join(root, "bn_resumed"))
    resumed_path, _ = config("bn_resumed", 3)
    train_main([resumed_path, "--allow_checkpoint_loading", *two])
    straight_path, straight_cfg = config("bn_straight", 3)
    train_main([straight_path, *two])
    a = load_reference_weights(os.path.join(root, "bn_resumed", "model_last_epoch.pt"))
    b = load_reference_weights(os.path.join(root, "bn_straight", "model_last_epoch.pt"))
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert float(b["layers.1.2.running_var"].sub(1).abs().max()) > 0  # the statistics moved

    metrics = {}
    for d in ("1", "2"):
        out = os.path.join(root, f"eval{d}")
        eval_main([out, straight_path, bn_experiment["data"], "test", "--device", "cpu",
                   "--num_devices", d])
        with open(os.path.join(out, "evaluation_metrics.pkl"), "rb") as f:
            metrics[d] = pickle.load(f)
    assert set(metrics["1"]) == set(metrics["2"]) == {"000", "001"}
    for view, m in metrics["1"].items():
        assert np.isfinite(m["psnr"]) and all(m[k] == metrics["2"][view][k]
                                              for k in ("psnr", "dssim_rescaled"))
    views = [render_view.main(["--output_path", os.path.join(root, f"view{d}.png"),
                               "--config_path", straight_path, "--cameras_path",
                               bn_experiment["cams"], "--device", "cpu", "--num_devices", d])
             for d in ("1", "2")]
    np.testing.assert_array_equal(views[0], views[1])
    assert (views[0] < 1).any()


def test_bn_model_pt_round_trips_through_the_jax_converter(bn_experiment, tmp_path):
    """A BatchNorm model.pt the port wrote, read by the JAX package's
    convert_reference_state_dict: the JAX field's eval forward equals the
    port's within 1e-5, and the converted statistics are the port's."""
    from intrinsic_neural_fields_tpu_torch.utils.checkpoint import save_model

    tmodel = make_model(BN, seed=4, device="cpu")
    state = create_train_state(tmodel, AdamHyper(1e-3), "cpu")
    _, td = _datasets(512, None)
    train, _ = make_epoch_fns(tmodel, "L1")
    state, _ = train(state, PRNGKey(0), td, 2, 256)
    path = str(tmp_path / "model.pt")
    save_model(path, state.state_dict())
    sd = torch.load(path, weights_only=True)
    variables = convert_reference_state_dict({k: v.numpy() for k, v in sd.items()})
    assert set(variables) == {"params", "batch_stats"}
    back = state_dict_from_flax(variables, BN)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    tmodel.load_state_dict(sd)
    jb, args = _batch(300, False, seed=2)
    want = jax_make_model(BN).apply(jax.tree_util.tree_map(jnp.asarray, variables), jb)
    np.testing.assert_allclose(tmodel(*args).detach().numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
