"""Port parity of the training slice against the JAX package on the CPU:
train_epoch on the kernels' path (plain twins here) vs make_epoch_fns(
fused=True, fused_adam=True) with the same block order replayed, the eager
path with a ragged tail vs the XLA step, val_epoch, the optimizer-state
carry, checkpoint.pt read by the JAX package, and the Trainer end to end
with resume.

Sizes follow tests/test_fused_adam.py (4 layers x 128, skip 1, k=60); the
JAX side runs as its own tests run it (Pallas in interpret mode)."""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from intrinsic_neural_fields_tpu.data.sampler import RayData as JaxRayData
from intrinsic_neural_fields_tpu.data.sampler import precompute_hit_features as jax_precompute
from intrinsic_neural_fields_tpu.models import init_model
from intrinsic_neural_fields_tpu.models import make_model as jax_make_model
from intrinsic_neural_fields_tpu.train.steps import create_train_state as jax_create_state
from intrinsic_neural_fields_tpu.train.steps import make_epoch_fns as jax_epoch_fns

from intrinsic_neural_fields_tpu_torch.data.sampler import RayData, precompute_hit_features
from intrinsic_neural_fields_tpu_torch.geometry.mesh_io import write_obj
from intrinsic_neural_fields_tpu_torch.geometry.synthetic import blob_mesh, pinhole_K, ring_cameras
from intrinsic_neural_fields_tpu_torch.models import make_model
from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import kernel_launches
from intrinsic_neural_fields_tpu_torch.train.steps import (
    AdamHyper,
    TrainState,
    create_train_state,
    eager_step,
    make_epoch_fns,
)
from intrinsic_neural_fields_tpu_torch.utils.checkpoint import (
    load_train_checkpoint,
    save_train_checkpoint,
)
from intrinsic_neural_fields_tpu_torch.utils.weights import (
    adam_state_from_optax,
    state_dict_from_flax,
)

torch.set_num_threads(2)

K, L, SKIP = 60, 4, 1
CFG = {"k": K, "num_layers": L, "mlp_hidden_dim": 128, "skip_layer_idx": SKIP}
LR = 1e-3


def _arrays(n, v, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(v, K)).astype(np.float32),
            rng.integers(0, v, size=(n, 3)).astype(np.int32),
            rng.dirichlet(np.ones(3), size=n).astype(np.float32),
            rng.uniform(size=(n, 3)).astype(np.float32))


def _datasets(n, v, seed, table_dtype):
    """The same records as a JAX RayData and a port RayData (CPU); with a
    precomputed hit-feature table when table_dtype is not "none"."""
    feats, vids, bary, rgbs = _arrays(n, v, seed)
    jd = JaxRayData(features=jnp.asarray(feats), feature_strategy="efuncs",
                    vertex_idxs_of_hit_faces=jnp.asarray(vids),
                    barycentric_coords=jnp.asarray(bary), expected_rgbs=jnp.asarray(rgbs),
                    unit_ray_dirs=None, face_idxs=None)
    td = RayData(features=torch.from_numpy(feats), feature_strategy="efuncs",
                 vertex_idxs_of_hit_faces=torch.from_numpy(vids).long(),
                 barycentric_coords=torch.from_numpy(bary), expected_rgbs=torch.from_numpy(rgbs))
    if table_dtype == "bfloat16":
        jd, td = jax_precompute(jd, dtype=jnp.bfloat16), precompute_hit_features(td, dtype=torch.bfloat16)
    elif table_dtype == "float32":
        jd, td = jax_precompute(jd), precompute_hit_features(td)
    return jd, td


@pytest.fixture(scope="module")
def models():
    jmodel = jax_make_model(CFG)
    variables = init_model(jmodel, CFG, seed=2)
    tmodel = make_model(CFG, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]), CFG))
    return jmodel, variables, tmodel


def _jax_state(variables, optimizer):
    return jax_create_state(jax.tree_util.tree_map(jnp.array, variables), optimizer)


def _params_sd(jstate):
    return state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jax.device_get(jstate.params)),
                                CFG)


def _diffs(port_sd, ref_sd):
    return np.concatenate([np.abs(port_sd[k].numpy() - ref_sd[k].numpy()).ravel()
                           for k in ref_sd])


def test_one_step_epoch_is_near_exact(models):
    """One batch through the kernels' path (plain twins) vs the JAX fused
    in-kernel-Adam epoch: loss to 1e-5, params to 1e-6, count 1."""
    jmodel, variables, tmodel = models
    jd, td = _datasets(256, 256, 0, "bfloat16")
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    j_epoch, _ = jax_epoch_fns(jmodel, opt, "L1", shuffle="blocks", fused=True, fused_adam=True)
    jst, jm = j_epoch(_jax_state(variables, opt), jax.random.PRNGKey(0), jd, 1, 256)

    t_epoch, _ = make_epoch_fns(tmodel, "L1", shuffle="blocks", fused=True, fused_adam=True)
    st = create_train_state(tmodel, AdamHyper(LR), "cpu")
    before = eager_step.launches
    st, m = t_epoch(st, np.asarray(jax.random.permutation(jax.random.PRNGKey(0), 1)), td, 1, 256)
    assert eager_step.launches == before  # the kernels' path, not the eager step
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["sq_err_per_sample"]), float(jm["sq_err_per_sample"]),
                               rtol=1e-5)
    assert _diffs(st.state_dict(), _params_sd(jst)).max() <= 1e-6
    assert st.count == 1 == int(jst.opt_state.inner_state[0].count)


@pytest.mark.parametrize("fused_adam", [True, False])
def test_two_epochs_track_the_reference(models, fused_adam):
    """Two epochs of 4 blocks each with JAX's block orders replayed. Held to
    the JAX package's own tracking bounds for its two fused paths
    (tests/test_fused_adam.py: losses rtol 2e-3, params and mu atol 2.5e-3
    — a gradient near 0 whose sign flips under rounding noise moves a
    weight by up to 2*lr per Adam step)."""
    jmodel, variables, tmodel = models
    jd, td = _datasets(1024, 120, 1, "bfloat16")
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    j_epoch, _ = jax_epoch_fns(jmodel, opt, "L1", shuffle="blocks", fused=True,
                               fused_adam=fused_adam)
    t_epoch, _ = make_epoch_fns(tmodel, "L1", shuffle="blocks", fused=True,
                                fused_adam=fused_adam)
    jst = _jax_state(variables, opt)
    st = create_train_state(tmodel, AdamHyper(LR), "cpu")
    for e in range(2):
        key = jax.random.PRNGKey(e)
        jst, jm = j_epoch(jst, key, jd, 4, 256)
        st, m = t_epoch(st, np.asarray(jax.random.permutation(key, 4)), td, 4, 256)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-3)
    assert _diffs(st.state_dict(), _params_sd(jst)).max() <= 2.5e-3
    adam = adam_state_from_optax(jax.device_get(jst.opt_state), CFG)
    assert _diffs(st.layout.state_dict(st.mu), adam["mu"]).max() <= 2.5e-3
    assert st.count == adam["count"] == 8


def test_two_epochs_with_an_lr_change_track_the_reference(models, monkeypatch):
    """Two blocks epochs through the step's index arithmetic (block
    order[i], targets and hyper row read at step i) with an explicit block
    permutation each and the lr lowered between them (as the plateau
    scheduler does), against the JAX package's blocks + fused + fused_adam
    epoch on the same permutations: the steps take the blocks in the
    permutation's order; losses and params held as in
    test_two_epochs_track_the_reference."""
    jmodel, variables, tmodel = models
    checked = _check_weight_copy_every_step(monkeypatch)
    jd, td = _datasets(1024, 120, 1, "bfloat16")
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    j_epoch, _ = jax_epoch_fns(jmodel, opt, "L1", shuffle="blocks", fused=True, fused_adam=True)
    t_epoch, _ = make_epoch_fns(tmodel, "L1", shuffle="blocks", fused=True, fused_adam=True)
    jst = _jax_state(variables, opt)
    st = create_train_state(tmodel, AdamHyper(LR), "cpu")
    perms = []
    for e in range(2):
        if e:
            jst.opt_state.hyperparams["learning_rate"] = jnp.asarray(LR / 4, jnp.float32)
            st.set_lr(LR / 4)
        key = jax.random.PRNGKey(10 + e)
        perms.append(np.asarray(jax.random.permutation(key, 4)))
        jst, jm = j_epoch(jst, key, jd, 4, 256)
        st, m = t_epoch(st, perms[-1], td, 4, 256)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-3)
    assert checked == [int(b) for p in perms for b in p]
    assert _diffs(st.state_dict(), _params_sd(jst)).max() <= 2.5e-3
    assert st.count == 8


def _check_weight_copy_every_step(monkeypatch):
    """Wrap train/steps.py's fused_train_adam_step (the epoch's step, its
    block found at order[i]): after each step the scratch's bf16 weight
    copy (what the fwd_bwd kernel reads) must equal the params rounded to bf16,
    bit for bit. Returns the list of checked blocks."""
    from intrinsic_neural_fields_tpu_torch.train import steps

    checked, inner = [], steps.fused_train_adam_step

    def step(layout, params, m, v, hyper_all, order, i, feats, targets, B, loss_type, scratch,
             sums, acc, vencs=None):
        inner(layout, params, m, v, hyper_all, order, i, feats, targets, B, loss_type, scratch,
              sums, acc, vencs)
        assert scratch is not None and scratch.wb.dtype == torch.bfloat16
        assert torch.equal(scratch.wb, params.to(torch.bfloat16))
        checked.append(int(order[i]))

    monkeypatch.setattr(steps, "fused_train_adam_step", step)
    return checked


def test_bf16_weight_copy_equals_params_after_every_step(models, monkeypatch):
    """Two epochs of 4 blocks through make_epoch_fns (the kernels' path,
    plain twins on the CPU): the Adam step keeps the copy current."""
    _, _, tmodel = models
    checked = _check_weight_copy_every_step(monkeypatch)
    _, td = _datasets(1024, 120, 1, "bfloat16")
    t_epoch, _ = make_epoch_fns(tmodel, "L1", shuffle="blocks", fused=True)
    st = create_train_state(tmodel, AdamHyper(LR), "cpu")
    for e in range(2):
        st, _ = t_epoch(st, np.arange(4)[::-1].copy() if e else np.arange(4), td, 4, 256)
    assert len(checked) == 8 and st.count == 8


def test_adam_twin_with_and_without_the_weight_copy():
    """fused_adam_apply with a bf16 copy gives the same f32 params, m and v
    as without one; the copy is the new params rounded to bf16."""
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import adam_hyper_rows, fused_adam_apply

    rng = np.random.default_rng(4)
    p, m, v, g = (torch.from_numpy(rng.normal(size=5000).astype(np.float32)) for _ in range(4))
    v = v.abs() * 1e-4
    hyper = adam_hyper_rows(torch.tensor([7]), 1e-3)[0]
    with_copy = [t.clone() for t in (p, m, v)]
    wb = torch.zeros(5000, dtype=torch.bfloat16)
    fused_adam_apply(*with_copy, hyper, g, wb)
    fused_adam_apply(p, m, v, hyper, g)
    for a, b in zip(with_copy, (p, m, v)):
        assert torch.equal(a, b)
    assert torch.equal(wb, p.to(torch.bfloat16))


@pytest.mark.parametrize("move", ["in_place_edit", "adam_without_copy", "other_tensor"])
def test_stale_weight_copy_is_rounded_again(models, move):
    """The scratch's bf16 weight copy follows the params it was made from:
    after an in-place write (a load_state_dict, a manual edit, an Adam step
    that does not write the copy) or for another params tensor, _sync_wb
    rounds the params again; for the same unchanged tensor it keeps the
    copy it has."""
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (
        _sync_wb, adam_hyper_rows, fused_adam_apply, layout_for_model, make_train_scratch)

    _, _, tmodel = models
    layout = layout_for_model(tmodel)
    params = layout.flat_from_state_dict(tmodel.state_dict())
    sc = make_train_scratch(layout, 256, params)
    assert torch.equal(sc.wb, params.to(torch.bfloat16))
    sc.wb.zero_()  # a marker: the same unchanged params are not rounded again
    _sync_wb(sc, params)
    assert not sc.wb.any()
    if move == "in_place_edit":
        params.mul_(0.5)
    elif move == "adam_without_copy":
        g = torch.from_numpy(np.random.default_rng(3).normal(size=layout.n).astype(np.float32))
        fused_adam_apply(params, torch.zeros_like(params), torch.zeros_like(params),
                         adam_hyper_rows(torch.tensor([1]), 1e-2)[0], g)
    else:
        params = params * 2.0
    _sync_wb(sc, params)
    assert sc.wb.any() and torch.equal(sc.wb, params.to(torch.bfloat16))


def test_eager_ragged_tail_matches_xla_step(models):
    """shuffle full, no table, 1000 records at batch 256 with the ragged
    tail (train_drop_last: false): the eager f32 step with the reference's
    weighted mean vs the JAX XLA step on JAX's permutation. Both in f32 on
    the CPU: loss to 1e-5, params to 1e-5."""
    jmodel, variables, tmodel = models
    jd, td = _datasets(1000, 120, 2, "none")
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    j_epoch, _ = jax_epoch_fns(jmodel, opt, "L2", shuffle="full", fused=False)
    t_epoch, _ = make_epoch_fns(tmodel, "L2", shuffle="full", fused=True)
    key = jax.random.PRNGKey(4)
    jst, jm = j_epoch(_jax_state(variables, opt), key, jd, 4, 256)
    st = create_train_state(tmodel, AdamHyper(LR), "cpu")
    before = eager_step.launches
    st, m = t_epoch(st, np.asarray(jax.random.permutation(key, 1000)), td, 4, 256)
    assert eager_step.launches == before + 4  # a ragged epoch never takes the kernels
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["sq_err_per_sample"]), float(jm["sq_err_per_sample"]),
                               rtol=1e-5)
    assert _diffs(st.state_dict(), _params_sd(jst)).max() <= 1e-5


def test_val_epoch_matches(models):
    """f32 forward over all 1000 records, the last batch ragged: f32 sums
    in another order (rtol 1e-5)."""
    jmodel, variables, tmodel = models
    jd, td = _datasets(1000, 120, 3, "float32")
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    _, j_val = jax_epoch_fns(jmodel, opt, "cauchy")
    _, t_val = make_epoch_fns(tmodel, "cauchy")
    want = j_val(_jax_state(variables, opt), jd, 256)
    got = t_val(create_train_state(tmodel, AdamHyper(LR), "cpu"), td, 256)
    for key in ("loss", "sq_err_per_sample"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5)


def test_optax_state_carry_and_checkpoint_interchange(models, tmp_path):
    """A JAX-trained state carried into the port (adam_state_from_optax)
    continues exactly like JAX for one step, and the port's checkpoint.pt
    reads back through the JAX package's load_reference_train_checkpoint
    with equal weights, moments, count and hyperparameters."""
    from intrinsic_neural_fields_tpu.utils.torch_convert import load_reference_train_checkpoint

    jmodel, variables, tmodel = models
    jd, td = _datasets(256, 256, 5, "bfloat16")
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR, b1=0.8, b2=0.95)
    j_epoch, _ = jax_epoch_fns(jmodel, opt, "L1", shuffle="blocks", fused=True)
    t_epoch, _ = make_epoch_fns(tmodel, "L1", shuffle="blocks", fused=True)
    jst, _ = j_epoch(_jax_state(variables, opt), jax.random.PRNGKey(0), jd, 1, 256)

    adam = adam_state_from_optax(jax.device_get(jst.opt_state), CFG)
    assert (adam["count"], adam["b1"], adam["b2"]) == (1, np.float32(0.8), np.float32(0.95))
    assert adam["lr"] == np.float32(LR) and adam["eps_root"] == 0.0
    st = TrainState.from_torch(create_train_state(tmodel, AdamHyper(LR), "cpu").layout,
                               _params_sd(jst), adam, "cpu")
    assert _diffs(st.layout.state_dict(st.nu), adam["nu"]).max() == 0.0

    jst, jm = j_epoch(jst, jax.random.PRNGKey(1), jd, 1, 256)
    st, m = t_epoch(st, np.zeros(1, np.int64), td, 1, 256)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert _diffs(st.state_dict(), _params_sd(jst)).max() <= 1e-6

    path = str(tmp_path / "checkpoint.pt")
    save_train_checkpoint(path, 7, st)
    info = load_reference_train_checkpoint(path)
    assert info["epoch"] == 7
    ref = info["adam"]
    assert ref["count"] == st.count == 2
    for ours, theirs in (("learning_rate", "lr"), ("b1", "b1"), ("b2", "b2"), ("eps", "eps")):
        assert np.float32(ref[theirs]) == np.float32(getattr(st.hyper, ours))
    for tree, flat in ((info["variables"]["params"], st.params), (ref["mu"], st.mu),
                       (ref["nu"], st.nu)):
        want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree), CFG)
        assert _diffs(st.layout.state_dict(flat), want).max() == 0.0
    # and the port reads its own file back to the same state
    back = load_train_checkpoint(path)
    st2 = TrainState.from_torch(st.layout, back["model_state_dict"], back["adam"], "cpu")
    for a, b in ((st2.params, st.params), (st2.mu, st.mu), (st2.nu, st.nu)):
        assert torch.equal(a, b)
    assert (st2.count, st2.hyper) == (st.count, st.hyper)


# ------------------------------------------------------------------ Trainer


class Recorder:
    """In-memory stand-in for tensorboardX's SummaryWriter."""

    def __init__(self):
        self.scalars, self.images = [], []

    def add_scalar(self, tag, value, global_step=None):
        self.scalars.append((tag, float(value), global_step))

    def add_image(self, tag, img, global_step=None):
        self.images.append((tag, np.asarray(img).shape, global_step))


def _write_split(path, n, v, seed):
    _, vids, bary, rgbs = _arrays(n, v, seed)
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "vids_of_hit_faces.npy"), vids)
    np.save(os.path.join(path, "barycentric_coords.npy"), bary)
    np.save(os.path.join(path, "expected_rgbs.npy"), rgbs)


def _write_vis_view(path, H, W):
    import imageio.v2 as imageio

    os.makedirs(os.path.join(path, "depth"), exist_ok=True)
    os.makedirs(os.path.join(path, "image"), exist_ok=True)
    np.savez(os.path.join(path, "depth", "cameras.npz"), world_mat_0=ring_cameras(3)[1],
             camera_mat_0=pinhole_K(H, W))
    mask = np.zeros((H, W), np.uint8)
    mask[2:-2, 3:-3] = 255
    imageio.imwrite(os.path.join(path, "depth", "mask.png"), mask)
    rgb = np.random.default_rng(0).integers(0, 255, size=(H, W, 3)).astype(np.uint8)
    imageio.imwrite(os.path.join(path, "image", "000.png"), rgb)


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A tiny experiment on disk: blob mesh, eigenfunction file, train /
    val / test ray caches and one vis view; returns a config factory."""
    root = str(tmp_path_factory.mktemp("exp"))
    mesh = blob_mesh(subdivisions=1)
    V = mesh.num_vertices
    write_obj(os.path.join(root, "blob.obj"), mesh.vertices, mesh.faces)
    np.save(os.path.join(root, "efuncs.npy"),
            np.random.default_rng(9).normal(size=(V, K + 4)).astype(np.float32))
    for split, n, seed in (("train", 1024, 11), ("val", 300, 12), ("test", 200, 13)):
        _write_split(os.path.join(root, split), n, V, seed)
    _write_vis_view(os.path.join(root, "vis000"), 16, 16)

    def config(out_name, epochs, **training):
        return {
            "seed": 3,
            "data": {
                "precompute_dtype": "bfloat16",
                "preproc_data_path_train": os.path.join(root, "train"),
                "preproc_data_path_eval": os.path.join(root, "val"),
                "preproc_data_path_test": os.path.join(root, "test"),
                "eigenfunctions_path": os.path.join(root, "efuncs.npy"),
                "mesh_path": os.path.join(root, "blob.obj"),
                "img_height": 16, "img_width": 16,
                "eval_render_input_paths": [os.path.join(root, "vis000")],
                "eval_render_img_names": ["vis000"],
            },
            "model": dict(CFG),
            "training": {
                "out_dir": os.path.join(root, out_name), "batch_size": 256, "lr": LR,
                "loss_type": "L1", "render_every": 1, "print_every": 1, "epochs": epochs,
                "checkpoint_every": 1, "shuffle": "blocks", "fused_mlp": True,
                "fused_interleave": 4, **training,
            },
        }

    return root, config


def _port_trainer(config, writer):
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh
    from intrinsic_neural_fields_tpu_torch.train import (Trainer, get_data,
                                                         get_model_and_optim, get_renderer)

    mesh = load_mesh(config["data"]["mesh_path"])
    model, opt = get_model_and_optim(config, mesh, device="cpu")
    return Trainer(model, opt, config["training"]["loss_type"],
                   get_renderer(config, model, mesh, device="cpu"),
                   get_data(config, mesh, device="cpu"), mesh, config, writer=writer,
                   device="cpu")


def test_trainer_runs_resumes_bit_exactly_and_logs_the_reference_tags(experiment):
    """Two epochs through the port's Trainer (kernels' path, plain twins on
    the CPU): losses fall, every checkpoint kind is written, a run resumed
    from checkpoint.pt equals the uninterrupted run to the bit, and the
    scalar and image tags are the JAX Trainer's on the same config."""
    root, config = experiment
    first = Recorder()
    t = _port_trainer(config("run2", 2), first)
    before = dict(kernel_launches(), eager=eager_step.launches)
    t.train()
    assert eager_step.launches == before["eager"]
    train_losses = [v for tag, v, _ in first.scalars if tag == "Train_Loss"]
    assert len(train_losses) == 2 and train_losses[1] < train_losses[0]
    for name in ("model.pt", "checkpoint.pt", "model_last_epoch.pt"):
        assert os.path.exists(os.path.join(root, "run2", name))

    # resume: run2's checkpoint.pt holds epoch 1; go on to epoch 2
    shutil.copytree(os.path.join(root, "run2"), os.path.join(root, "resumed"))
    resumed = _port_trainer(config("resumed", 3), Recorder())
    resumed.train()
    straight = _port_trainer(config("straight", 3), Recorder())
    straight.train()
    for a, b in ((resumed.state.params, straight.state.params),
                 (resumed.state.mu, straight.state.mu), (resumed.state.nu, straight.state.nu)):
        assert torch.equal(a, b)
    assert resumed.state.count == straight.state.count == 12

    # the JAX Trainer on the same experiment (its XLA step: the tags do not
    # depend on the step) logs the same tags
    from intrinsic_neural_fields_tpu.geometry.mesh import load_mesh
    from intrinsic_neural_fields_tpu.train import (Trainer, get_data, get_model_and_optim,
                                                   get_renderer)

    jcfg = config("jax_run", 2, fused_mlp=False)
    mesh = load_mesh(jcfg["data"]["mesh_path"])
    model, variables, opt = get_model_and_optim(jcfg, mesh)
    jt = Trainer(model, variables, opt, "L1", get_renderer(jcfg, model, variables, mesh),
                 get_data(jcfg, mesh), mesh, jcfg)
    jt.writer = Recorder()
    jt.train()
    assert sorted({s[0] for s in first.scalars}) == sorted({s[0] for s in jt.writer.scalars})
    assert sorted(set(first.images)) == sorted(set(jt.writer.images))


def test_trainer_vis_renders_use_an_f32_table_like_the_jax_trainer(experiment):
    """Under precompute_dtype: bfloat16 the training table is bf16, but the
    Trainer's vis renderer holds an f32 feature table, as the JAX Trainer's
    does. On the same weights and vis view the two Trainers log the same
    img000 scalars: PSNR within 0.05 dB and the summed absolute distance
    within 0.5% (the port's CPU forward rounds matmul operands to bf16, the
    JAX CPU forward is f32)."""
    from intrinsic_neural_fields_tpu.geometry.mesh import load_mesh
    from intrinsic_neural_fields_tpu.train import (Trainer, get_data, get_model_and_optim,
                                                   get_renderer)

    _, config = experiment
    jcfg = config("vis_jax", 1, fused_mlp=False)
    mesh = load_mesh(jcfg["data"]["mesh_path"])
    model, variables, opt = get_model_and_optim(jcfg, mesh)
    jt = Trainer(model, variables, opt, "L1", get_renderer(jcfg, model, variables, mesh),
                 get_data(jcfg, mesh), mesh, jcfg)
    jt.writer = Recorder()
    jt._visualize(0)

    pt = _port_trainer(config("vis_port", 1), Recorder())
    assert pt.train_data.hit_features.dtype == torch.bfloat16
    assert pt.renderer.features.dtype == torch.float32
    pt.model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]), CFG))
    pt.state = create_train_state(pt.model, AdamHyper(LR), "cpu")
    pt._visualize(0)

    got = {tag: v for tag, v, _ in pt.writer.scalars}
    want = {tag: v for tag, v, _ in jt.writer.scalars}
    assert set(got) == set(want) == {"img000_psnr", "img000_dist"}
    assert got["img000_psnr"] == pytest.approx(want["img000_psnr"], abs=0.05)
    assert got["img000_dist"] == pytest.approx(want["img000_dist"], rel=5e-3)


def test_bf16_weight_copy_after_resume(experiment, monkeypatch):
    """A run resumed from checkpoint.pt makes its copy from the restored
    params and keeps it current on every step of the resumed epoch."""
    root, config = experiment
    _port_trainer(config("wb_run", 1), Recorder()).train()
    shutil.copytree(os.path.join(root, "wb_run"), os.path.join(root, "wb_resumed"))
    checked = _check_weight_copy_every_step(monkeypatch)
    resumed = _port_trainer(config("wb_resumed", 2), Recorder())
    resumed.train()
    assert len(checked) == 4 and resumed.state.count == 8


def test_cli_trains_on_the_cpu(experiment):
    import yaml

    from intrinsic_neural_fields_tpu_torch.train.__main__ import main
    from intrinsic_neural_fields_tpu_torch.utils.weights import load_reference_weights

    root, config = experiment
    cfg = config("cli", 1, checkpoint_every=None)
    cfg["data"]["eval_render_input_paths"] = []  # writes tensorboardX logs itself
    path = os.path.join(root, "cli.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    main([path, "--device", "cpu"])
    sd = load_reference_weights(os.path.join(root, "cli", "model.pt"))
    make_model(CFG, device="cpu").load_state_dict(sd)
    with pytest.raises(RuntimeError, match="exists"):
        main([path, "--device", "cpu"])


def test_cli_trains_without_tensorboardx(experiment, monkeypatch):
    """Without tensorboardX the CLI logs every scalar, under the reference's
    tags, as JSON lines in <out_dir>/logs/scalars.jsonl."""
    import json
    import sys

    import yaml

    from intrinsic_neural_fields_tpu_torch.train.__main__ import main

    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # import raises ImportError
    root, config = experiment
    cfg = config("cli_notb", 2, checkpoint_every=None)
    path = os.path.join(root, "cli_notb.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    main([path, "--device", "cpu"])
    with open(os.path.join(root, "cli_notb", "logs", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for tag in ("Train Rays-per-sec", "Train_Loss", "Train Epoch-PSNR", "Val_Loss",
                "Val Epoch-PSNR"):
        assert [r["step"] for r in rows if r["tag"] == tag] == [0, 1], tag
    assert all(np.isfinite(r["value"]) for r in rows)
    assert [r["tag"] for r in rows][-1] == "Test Loss"


def test_entry_points_default_to_cuda(experiment):
    from intrinsic_neural_fields_tpu_torch.train import get_data, get_model_and_optim

    if torch.cuda.is_available():
        pytest.skip("the CUDA default is exercised on the card")
    _, config = experiment
    cfg = config("nocuda", 1)
    for call in (lambda: get_data(cfg), lambda: get_model_and_optim(cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # a BatchNorm model builds and trains, through the eager step (one per
    # batch), its running statistics moved and carried into model.pt
    bn = config("bn", 1, fused_mlp=False)
    bn["model"]["batchnorm"] = True
    t = _port_trainer(bn, Recorder())
    before = eager_step.launches
    t.train()
    assert eager_step.launches == before + 4
    sd = torch.load(os.path.join(bn["training"]["out_dir"], "model.pt"), weights_only=True)
    assert float((sd["layers.0.2.running_var"] - 1).abs().max()) > 0
