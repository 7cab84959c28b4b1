"""Port parity of data-parallel training and the D-way render on the CPU.

The port's make_dp_epoch_fns over ["cpu"] * D against the JAX package's
make_dp_epoch_fns over make_device_mesh(D) (the 8 virtual CPU devices of
tests/conftest.py), on the same replayed orders: the gather path with a
ragged tail, the blocks path, the blocks path with fused and fused_adam
(Pallas in interpret mode on the JAX side, the plain twins on the port's).
Sync-BN under DP against the single-device BatchNorm epoch on one global
batch (the port's twin of tests/test_sharding.py's), the view-dependent
fused DP step against the single-device kernel step on one global block,
replicas equal to the bit, the D-way render equal to the single-device
render (the twin of tests/test_render_regressions.py's), and the device
list's errors. Sizes are tests/test_sharding.py's (k=16, 4 layers x 32,
n <= 4096; the fused cases at 4 x 128 and n = 8192)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from intrinsic_neural_fields_tpu.data.sampler import precompute_hit_features as jax_precompute
from intrinsic_neural_fields_tpu.models import init_model
from intrinsic_neural_fields_tpu.models import make_model as jax_make_model
from intrinsic_neural_fields_tpu.parallel import make_device_mesh
from intrinsic_neural_fields_tpu.parallel import make_dp_epoch_fns as jax_dp_epoch_fns
from intrinsic_neural_fields_tpu.train.steps import create_train_state as jax_create_state

from intrinsic_neural_fields_tpu_torch.data.sampler import (RayData, precompute_hit_features,
                                                            precompute_hit_vencs)
from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
from intrinsic_neural_fields_tpu_torch.models import make_model, view_encoder_apply
from intrinsic_neural_fields_tpu_torch.models.neutex import NeuTexTrainWrapper
from intrinsic_neural_fields_tpu_torch.devices import cli_devices, resolve_devices
from intrinsic_neural_fields_tpu_torch.parallel import make_dp_epoch_fns
from intrinsic_neural_fields_tpu_torch.render.renderer import Renderer
from intrinsic_neural_fields_tpu_torch.train.steps import (AdamHyper, create_train_state,
                                                           make_epoch_fns)
from intrinsic_neural_fields_tpu_torch.utils.jax_random import PRNGKey
from intrinsic_neural_fields_tpu_torch.utils.weights import state_dict_from_flax

from tests.test_render_regressions import _look_at_cam, _simple_K
from tests.test_sharding import _synthetic_raydata

torch.set_num_threads(2)

LR = 1e-3
SMALL = {"k": 16, "num_layers": 4, "mlp_hidden_dim": 32, "skip_layer_idx": 2}
WIDE = {"k": 16, "num_layers": 4, "mlp_hidden_dim": 128, "skip_layer_idx": 2}


def _datasets(n, table, seed=0):
    """tests/test_sharding.py's records as a JAX RayData and a port RayData
    (CPU); with a precomputed hit-feature table of dtype `table` unless
    None."""
    jd = _synthetic_raydata(n=n, seed=seed)
    td = RayData(features=torch.from_numpy(np.array(jd.features)), feature_strategy="efuncs",
                 vertex_idxs_of_hit_faces=torch.from_numpy(
                     np.array(jd.vertex_idxs_of_hit_faces)).long(),
                 barycentric_coords=torch.from_numpy(np.array(jd.barycentric_coords)),
                 expected_rgbs=torch.from_numpy(np.array(jd.expected_rgbs)))
    if table is not None:
        jd = jax_precompute(jd, dtype=jnp.bfloat16 if table == "bfloat16" else None)
        td = precompute_hit_features(td, dtype=torch.bfloat16 if table == "bfloat16" else None)
    return jd, td


def _models(cfg, seed=0):
    jmodel = jax_make_model(cfg)
    variables = jax.tree_util.tree_map(np.asarray, init_model(jmodel, cfg, seed=seed))
    tmodel = make_model(cfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(variables, cfg))
    return jmodel, variables, tmodel


def _max_param_diff(st, jst, cfg):
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jax.device_get(jst.params)),
                                cfg)
    got = st.state_dict()
    return max(float(np.abs(got[k].numpy() - want[k].numpy()).max()) for k in want)


def _equal_replicas(train_epoch):
    states = train_epoch.replicas.states
    return all(torch.equal(getattr(s, name), getattr(states[0], name))
               for s in states[1:] for name in ("params", "mu", "nu")) and all(
        torch.equal(s.batch_stats[k], states[0].batch_stats[k])
        for s in states[1:] for k in states[0].batch_stats)


# name: (config, n, batch, D, shuffle, table, fused, epochs, loss rtol, params atol);
# gather_sync_bn: a BatchNorm field, sync-BN on both sides, the statistics
# taken over every replica's rows, padded tail rows included (JAX :192-194)
# The f32 paths differ by f32 summation order only: loss 1e-5, params
# 1e-5. The fused paths round matmul operands to bf16 on both sides and sum
# in another order: the JAX package's own bounds for its fused paths (loss
# rtol 2e-3; params 2.5e-3, as a gradient near 0 whose sign flips under
# rounding noise moves a weight by up to 2 lr per Adam step).
CASES = {
    "gather_ragged_tail": (SMALL, 4096 + 123, 512, 4, "full", None, False, 2, 1e-5, 1e-5),
    "blocks": (SMALL, 4096, 512, 4, "blocks", "float32", False, 2, 1e-5, 1e-5),
    "blocks_fused_adam": (WIDE, 8192, 1024, 4, "blocks", "bfloat16", True, 2, 2e-3, 2.5e-3),
    "gather_sync_bn": ({**SMALL, "batchnorm": True}, 2048 + 77, 512, 4, "full", None, False, 2,
                       1e-5, 1e-5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dp_epochs_match_the_jax_dp_epochs(case):
    """Both packages' DP epochs on the same records, weights and orders:
    JAX's permutation(key, n) on the gather path, its per-device
    permutation(fold_in(key, d), num_batches) on the blocks path. Per
    epoch the train loss and squared error, then the params; the port's
    replicas stay equal to the bit."""
    cfg, n, B, D, shuffle, table, fused, epochs, loss_rtol, param_atol = CASES[case]
    jd, td = _datasets(n, table)
    jmodel, variables, tmodel = _models(cfg)
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    j_train, j_val = jax_dp_epoch_fns(jmodel, opt, "L1", make_device_mesh(D), shuffle=shuffle,
                                      fused=fused, fused_adam=True)
    t_train, t_val = make_dp_epoch_fns(tmodel, "L1", ["cpu"] * D, shuffle=shuffle, fused=fused)
    jst = jax_create_state(jax.tree_util.tree_map(jnp.array, variables), opt)
    st = create_train_state(tmodel, AdamHyper(LR), "cpu")
    nb = -(-n // B)
    for e in range(epochs):
        key = jax.random.PRNGKey(e)
        if shuffle == "blocks":
            order = np.stack([np.asarray(jax.random.permutation(jax.random.fold_in(key, d), nb))
                              for d in range(D)])
        else:
            order = np.asarray(jax.random.permutation(key, n))
        jst, jm = j_train(jst, key, jd, nb, B)
        st, m = t_train(st, order, td, nb, B)
        for name in ("loss", "sq_err_per_sample"):
            np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=loss_rtol)
    assert _max_param_diff(st, jst, cfg) <= param_atol
    if cfg.get("batchnorm"):  # the running statistics, replicated on both sides
        want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jax.device_get(
            {"params": jst.params, "batch_stats": jst.batch_stats})), cfg)
        for k, v in st.batch_stats.items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=param_atol, rtol=0)
    assert st.count == epochs * nb
    assert _equal_replicas(t_train)
    if not fused:  # both f32 forwards, on params within 1e-5: rtol 1e-4
        got, want = t_val(st, td, B), j_val(jst, jd, B)
        for name in ("loss", "sq_err_per_sample"):
            np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-4)


def test_dp_val_with_a_ragged_tail_matches_the_single_device_val():
    """Each replica walks a contiguous ceil(n / D) range, the last one
    ragged: the sums equal the single-device epoch's (f32 order, 1e-5)."""
    _, td = _datasets(4096 + 37, None)
    _, _, tmodel = _models(SMALL)
    _, dp_val = make_dp_epoch_fns(tmodel, "L1", ["cpu"] * 8)
    _, sd_val = make_epoch_fns(tmodel, "L1")
    st = create_train_state(tmodel, AdamHyper(LR), "cpu")
    got, want = dp_val(st, td, 512), sd_val(st, td, 512)
    for name in ("loss", "sq_err_per_sample"):
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5)


def test_sync_bn_dp_matches_the_single_device_bn_epoch():
    """One global batch per epoch: the mean of the replicas' moments is the
    whole batch's, so DP tracks the single-device BatchNorm run step for
    step (tests/test_sharding.py's twin, its bounds: loss rtol 1e-4, params
    and running statistics atol 1e-5 + rtol 1e-4), the running statistics
    move and stay equal to the bit on every replica, and the val epochs
    (running statistics) agree."""
    _, td = _datasets(512, None)
    cfg = {**SMALL, "batchnorm": True}
    tmodel = make_model(cfg, seed=2, device="cpu")
    dp_train, dp_val = make_dp_epoch_fns(tmodel, "L1", ["cpu"] * 8)
    sd_train, sd_val = make_epoch_fns(tmodel, "L1")
    st_dp = create_train_state(tmodel, AdamHyper(LR), "cpu")
    st_sd = create_train_state(tmodel, AdamHyper(LR), "cpu")
    for e in range(4):
        perm = torch.randperm(512, generator=torch.Generator().manual_seed(e))
        st_dp, m_dp = dp_train(st_dp, perm, td, 1, 512)
        st_sd, m_sd = sd_train(st_sd, perm, td, 1, 512)
        np.testing.assert_allclose(float(m_dp["loss"]), float(m_sd["loss"]), rtol=1e-4)
    np.testing.assert_allclose(st_dp.params.numpy(), st_sd.params.numpy(), atol=1e-5, rtol=1e-4)
    assert set(st_dp.batch_stats) == set(st_sd.batch_stats) and st_dp.batch_stats
    for k, v in st_sd.batch_stats.items():
        np.testing.assert_allclose(st_dp.batch_stats[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-4)
    assert float(st_dp.batch_stats["layers.0.2.running_mean"].abs().max()) > 0
    assert _equal_replicas(dp_train)
    np.testing.assert_allclose(float(dp_val(st_dp, td, 512)["loss"]),
                               float(sd_val(st_sd, td, 512)["loss"]), rtol=1e-4)


def _viewdep_data(n, model, seed=0):
    """Records with ray directions and face ids, a bf16 table and the
    model's pre-encoded view directions (as the Trainer streams them)."""
    rng = np.random.default_rng(seed)
    v, f = 300, model.face_normals.shape[0]
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    data = RayData(features=torch.from_numpy(rng.normal(size=(v, 16)).astype(np.float32)),
                   feature_strategy="efuncs",
                   vertex_idxs_of_hit_faces=torch.from_numpy(rng.integers(0, v, (n, 3))),
                   barycentric_coords=torch.from_numpy(
                       rng.dirichlet(np.ones(3), n).astype(np.float32)),
                   expected_rgbs=torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32)),
                   unit_ray_dirs=torch.from_numpy(dirs),
                   face_idxs=torch.from_numpy(rng.integers(0, f, n)))
    data = precompute_hit_features(data, dtype=torch.bfloat16)
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import layout_for_model

    return precompute_hit_vencs(view_encoder_apply(model), data,
                                layout_for_model(model).tail.venc_w, dtype=torch.bfloat16)


def test_viewdep_fused_dp_step_matches_the_single_device_kernel_step():
    """A fused view-dependent field, one global block of 2048 rows: the DP
    step (each replica's tail kernels on its 1024-row half, the mean of the
    gradients, Adam) against the single-device kernel step (fused_adam
    false: the same grads kernels, then Adam) on the whole block. The
    gradients differ by f32 summation order only: Adam's first moment
    (0.1 g after one step) within 1e-5 of its largest entry, the loss to
    1e-5."""
    mesh = icosphere(2)
    cfg = {**WIDE, "view_dependence": {"bottleneck_vec_dim": 128, "in_dim_view_dir": 1,
                                       "include_view_dir": True, "embed_size": 4,
                                       "directional_hidden_dim": 128, "strategy": "intrinsic"}}
    model = make_model(cfg, seed=1, device="cpu", mesh=mesh)
    data = _viewdep_data(2048, model)
    dp_train, _ = make_dp_epoch_fns(model, "L1", ["cpu"] * 2, shuffle="blocks", fused=True)
    sd_train, _ = make_epoch_fns(model, "L1", shuffle="blocks", fused=True, fused_adam=False)
    st_dp = create_train_state(model, AdamHyper(LR), "cpu")
    st_sd = create_train_state(model, AdamHyper(LR), "cpu")
    st_dp, m_dp = dp_train(st_dp, np.zeros((2, 1), np.int64), data, 1, 2048)
    st_sd, m_sd = sd_train(st_sd, np.zeros(1, np.int64), data, 1, 2048)
    np.testing.assert_allclose(float(m_dp["loss"]), float(m_sd["loss"]), rtol=1e-5)
    scale = float(st_sd.mu.abs().max())
    assert scale > 0 and float((st_dp.mu - st_sd.mu).abs().max()) <= 1e-5 * scale
    assert _equal_replicas(dp_train)


def test_replicas_stay_bit_equal_over_three_devices_and_resync():
    """D = 3 (not a power of two) on the fused blocks path, two epochs: the
    replicas' params and moments are equal to the bit after each; a state
    changed outside the epochs is copied to the replicas again."""
    _, td = _datasets(3 * 1024, "bfloat16")
    _, _, tmodel = _models(WIDE)
    train, _ = make_dp_epoch_fns(tmodel, "L2", ["cpu"] * 3, shuffle="blocks", fused=True)
    st = create_train_state(tmodel, AdamHyper(LR), "cpu")
    for e in range(2):
        st, _ = train(st, PRNGKey(e), td, 4, 768)
        assert _equal_replicas(train)
    with torch.no_grad():
        st.params.mul_(0.5)
    st, _ = train(st, PRNGKey(2), td, 4, 768)
    assert _equal_replicas(train) and st.count == 12


def test_batch_not_divisible_by_the_devices_raises():
    _, td = _datasets(1024, None)
    _, _, tmodel = _models(SMALL)
    train, val = make_dp_epoch_fns(tmodel, "L1", ["cpu"] * 8)
    st = create_train_state(tmodel, AdamHyper(LR), "cpu")
    with pytest.raises(ValueError, match="not divisible by 8 devices"):
        train(st, PRNGKey(0), td, 2, 100)
    with pytest.raises(ValueError, match="not divisible by 8 devices"):
        val(st, td, 100)


# name: (the model, the message both epoch factories refuse `fused` with)
INELIGIBLE = {
    "batchnorm_field": (lambda: make_model({**SMALL, "batchnorm": True}, device="cpu"),
                        "without BatchNorm"),
    "neutex": (lambda: NeuTexTrainWrapper(num_freqs=4), "self-loss model"),
    "encoder_field": (lambda: make_model({**WIDE, "feature_strategy": "rff", "embed_std": 4.0},
                                         device="cpu"), "fused_mlp needs a plain TextureField"),
    "viewdep_unequal_widths": (lambda: make_model(
        {**WIDE, "view_dependence": {"bottleneck_vec_dim": 256, "include_view_dir": True,
                                     "embed_size": 2, "directional_hidden_dim": 128,
                                     "in_dim_view_dir": 3, "strategy": "extrinsic"}},
        device="cpu"), "widths equal to the hidden width"),
}


@pytest.mark.parametrize("case", sorted(INELIGIBLE))
def test_one_device_and_dp_refuse_fused_for_a_model_the_kernels_cannot_take(case):
    """fused=True on a model the train kernels cannot compute raises at
    construction, in make_epoch_fns and in make_dp_epoch_fns alike, with
    the same message (one check serves both)."""
    make, match = INELIGIBLE[case]
    model = make()
    messages = []
    for build in (lambda: make_epoch_fns(model, "L1", shuffle="blocks", fused=True),
                  lambda: make_dp_epoch_fns(model, "L1", ["cpu"] * 2, shuffle="blocks",
                                            fused=True)):
        with pytest.raises(ValueError, match=match) as err:
            build()
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_device_lists_and_their_errors():
    """A count asks for that many CUDA devices and raises without them; a
    list may repeat a device; --num_devices 1 means no list."""
    assert resolve_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert cli_devices("cpu", 1) is None
    assert cli_devices("cpu", 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="at least 1"):
        cli_devices("cpu", 0)
    if not torch.cuda.is_available():
        for call in (lambda: resolve_devices(2), lambda: cli_devices("cuda", 2)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


@pytest.mark.parametrize("batchnorm", [False, True])
def test_d_way_render_bit_equal_to_the_single_device_render(batchnorm):
    """Renderer(devices=["cpu"] * 3) against the single-device Renderer on
    the same field: the image and the hit set equal to the bit, full view
    and masked (tests/test_render_regressions.py's twin). 160^2 pixels, so
    the shards (multiples of the 8192-ray inference chunk) are not empty;
    the BatchNorm field renders through its module forward."""
    H = W = 160
    mesh = icosphere(3)
    efuncs = np.random.default_rng(0).normal(size=(mesh.num_vertices, 16)).astype(np.float32)
    cfg = {**(SMALL if batchnorm else WIDE), "batchnorm": batchnorm}
    model = make_model(cfg, device="cpu")
    single = Renderer(model, mesh, efuncs, H=H, W=W, device="cpu")
    sharded = Renderer(model, mesh, efuncs, H=H, W=W, device="cpu", devices=["cpu"] * 3)
    assert single.infer_mode == ("module" if batchnorm else "plain")
    cam, K = _look_at_cam(np.array([0.4, -2.2, 0.7])), _simple_K(H, W)
    img_s, hits_s = single.render(cam, K, eval_render=True)
    img_m, hits_m = sharded.render(cam, K, eval_render=True)
    assert len(sharded._shards(H * W)) == 2 and 0 < len(hits_s) < H * W
    np.testing.assert_array_equal(img_s, img_m)
    np.testing.assert_array_equal(hits_s, hits_m)
    mask = np.zeros(H * W, dtype=bool)
    mask[H * W // 8:H * W * 7 // 8] = True
    np.testing.assert_array_equal(single.render(cam, K, obj_mask_1d=mask),
                                  sharded.render(cam, K, obj_mask_1d=mask))
    # new weights reach every device's copy
    sd = {k: (v * 0.5 if v.is_floating_point() else v) for k, v in model.state_dict().items()}
    single.update_variables(sd)
    sharded.update_variables(sd)
    np.testing.assert_array_equal(single.render(cam, K), sharded.render(cam, K))
