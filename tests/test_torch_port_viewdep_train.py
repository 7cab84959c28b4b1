"""Port parity of the view-dependent field's training against the JAX
package on the CPU: the tail-mode train twins against
make_fused_train_grads(tail=...) (gathered and streaming) and
make_fused_train_adam(tail=...), precompute_hit_vencs, train_epoch on the
kernels' path against the JAX fused epoch with the block order replayed,
the eager step and val_epoch against the XLA step, the weight / Adam-state
carry and checkpoint.pt through the JAX package's loader, and the Trainer
with resume.

Inputs come from numpy seeds and cross between the frameworks as numpy;
the JAX side runs as its own tests run it (Pallas in interpret mode).
Sizes follow tests/test_fused_viewdep.py: 4 layers x 128, k=32, icosphere(2)."""
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
from intrinsic_neural_fields_tpu.data.sampler import precompute_hit_vencs as jax_precompute_vencs
from intrinsic_neural_fields_tpu.geometry.primitives import icosphere as jax_icosphere
from intrinsic_neural_fields_tpu.models import init_model
from intrinsic_neural_fields_tpu.models import make_model as jax_make_model
from intrinsic_neural_fields_tpu.models.texture_field import (
    view_encoder_apply as jax_view_encoder_apply,
)
from intrinsic_neural_fields_tpu.ops.fused_mlp import FusedMLPSpec as JaxSpec
from intrinsic_neural_fields_tpu.ops.fused_mlp import ViewDepTailSpec as JaxTail
from intrinsic_neural_fields_tpu.ops.fused_mlp import adam_hyper_rows as jax_hyper_rows
from intrinsic_neural_fields_tpu.ops.fused_mlp import (
    make_fused_train_adam,
    make_fused_train_grads,
    viewdep_grads_to_padded,
    viewdep_params_to_list,
    viewdep_unpad_flax_params,
)
from intrinsic_neural_fields_tpu.train.steps import create_train_state as jax_create_state
from intrinsic_neural_fields_tpu.train.steps import make_epoch_fns as jax_epoch_fns

from intrinsic_neural_fields_tpu_torch.data.sampler import (
    RayData,
    precompute_hit_features,
    precompute_hit_vencs,
)
from intrinsic_neural_fields_tpu_torch.geometry.mesh_io import write_obj
from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
from intrinsic_neural_fields_tpu_torch.geometry.synthetic import blob_mesh
from intrinsic_neural_fields_tpu_torch.models import make_model, view_encoder_apply
from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (
    adam_hyper_rows,
    fused_train_adam,
    fused_train_grads,
    kernel_launches,
    layout_for_model,
)
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

K, TILE, LR = 32, 128, 1e-3
# Gradients: both sides round the same operands to bf16 and sum in f32 in
# other orders, which now and then moves a hidden value or delta to the
# neighbouring bf16; per tensor max|d|/max|g| stays under ~1e-6 here
# (measured), held to the plain tail-less tests' 2e-3.
GRAD_TOL = 2e-3


def _cfg(strategy="intrinsic", skip=1):
    return {"k": K, "num_layers": 4, "mlp_hidden_dim": 128, "skip_layer_idx": skip,
            "view_dependence": {"bottleneck_vec_dim": 128, "include_view_dir": True,
                                "embed_size": 4, "directional_hidden_dim": 128,
                                "in_dim_view_dir": 1 if strategy == "intrinsic" else 3,
                                "strategy": strategy}}


@pytest.fixture(scope="module", params=["intrinsic", "extrinsic"])
def setup(request):
    cfg = _cfg(request.param)
    jmodel = jax_make_model(cfg, mesh=jax_icosphere(2))
    variables = init_model(jmodel, cfg, seed=1, mesh=jax_icosphere(2))
    model = make_model(cfg, device="cpu", mesh=icosphere(2))
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]), cfg))
    lay = layout_for_model(model)
    rng = np.random.default_rng(7)
    n = 1024
    feats = rng.normal(size=(n, K)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    fids = rng.integers(0, jax_icosphere(2).num_faces, size=n).astype(np.int32)
    gt = rng.uniform(size=(n, 3)).astype(np.float32)
    venc = np.array(jax_view_encoder_apply(jmodel)(jnp.asarray(dirs), jnp.asarray(fids)))
    jspec = JaxSpec(num_layers=4, k_in=K, hidden=128, skip_idx=1, out_dim=128)
    jtail = JaxTail(venc_in=venc.shape[1], d_hidden=128)
    return {"cfg": cfg, "jmodel": jmodel, "variables": variables, "model": model, "lay": lay,
            "flat": lay.flat_from_state_dict(model.state_dict()), "feats": feats, "dirs": dirs,
            "fids": fids, "gt": gt, "venc": venc, "jspec": jspec, "jtail": jtail,
            "wb": viewdep_params_to_list(jspec, jtail, variables["params"])}


def _jax_sd(s, grad_list):
    """A JAX tail-layout grad/param list -> torch-layout state dict."""
    tree = viewdep_unpad_flax_params(s["jspec"], s["jtail"],
                                     viewdep_grads_to_padded(s["jspec"], grad_list))
    return state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree), s["cfg"])


def _assert_grads_close(got, want, tol=GRAD_TOL):
    for name in want:
        scale = float(want[name].abs().max())
        err = float((got[name] - want[name]).abs().max())
        assert err <= tol * max(scale, 1e-30), (name, err, scale)


def _pad(a, width, dtype=jnp.float32):
    return jnp.pad(jnp.asarray(a, dtype), ((0, 0), (0, width - a.shape[1])))


def test_tail_grads_gathered_match_pallas(setup):
    """A gathered [B, k] batch and its [B, venc_w] zero-padded encodings:
    loss sums to 1e-5 (one f32 sum in another order), grads to GRAD_TOL.
    The train wrappers take the table's venc_w width only."""
    s, B = setup, 256
    run = make_fused_train_grads(s["jspec"], "L1", batch_tile=TILE, tail=s["jtail"],
                                 interpret=True)
    g_ref, l_ref, sq_ref = run(s["wb"], _pad(s["feats"][:B], 128), _pad(s["venc"][:B], 128),
                               jnp.asarray(s["gt"][:B]))
    venc = torch.from_numpy(np.array(_pad(s["venc"][:B], s["lay"].tail.venc_w)))
    grads, loss_sum, sq_sum = fused_train_grads(
        s["lay"], s["flat"], torch.from_numpy(s["feats"][:B]), torch.from_numpy(s["gt"][:B]),
        loss_type="L1", vencs=venc)
    np.testing.assert_allclose(float(loss_sum), float(l_ref), rtol=1e-5)
    np.testing.assert_allclose(float(sq_sum), float(sq_ref), rtol=1e-5)
    _assert_grads_close(s["lay"].state_dict(grads), _jax_sd(s, g_ref))
    with pytest.raises(ValueError, match="vencs"):
        fused_train_grads(s["lay"], s["flat"], torch.from_numpy(s["feats"][:B]),
                          torch.from_numpy(s["gt"][:B]))
    with pytest.raises(ValueError, match="vencs"):
        fused_train_grads(s["lay"], s["flat"], torch.from_numpy(s["feats"][:B]),
                          torch.from_numpy(s["gt"][:B]), vencs=torch.from_numpy(s["venc"][:B]))


def _tables(s):
    """The bf16 feature table and the bf16 [N, venc_w] encodings (JAX: padded
    to its 128 lanes), the same values on both sides."""
    table = s["feats"].astype(jnp.bfloat16)
    vt = s["venc"].astype(jnp.bfloat16)
    w = s["lay"].tail.venc_w
    t_table = torch.from_numpy(np.asarray(table, np.float32)).to(torch.bfloat16)
    t_vt = torch.zeros(len(vt), w, dtype=torch.bfloat16)
    t_vt[:, :vt.shape[1]] = torch.from_numpy(np.asarray(vt, np.float32)).to(torch.bfloat16)
    return (_pad(table, 128, jnp.bfloat16), _pad(vt, 128, jnp.bfloat16)), (t_table, t_vt)


def test_tail_grads_streaming_bf16_match_pallas(setup):
    """The streaming contract: bf16 tables, the batch and its encodings at
    the same block offset."""
    s, B, blk = setup, 256, 2
    (j_table, j_vt), (t_table, t_vt) = _tables(s)
    run = make_fused_train_grads(s["jspec"], "L1", batch_tile=TILE, tail=s["jtail"],
                                 interpret=True, stream=True)
    gt = s["gt"][blk * B:(blk + 1) * B]
    g_ref, l_ref, _ = run(s["wb"], j_table, j_vt, jnp.asarray(gt), blk * (B // TILE), B)
    grads, loss_sum, _ = fused_train_grads(s["lay"], s["flat"], t_table, torch.from_numpy(gt),
                                           blk, B, vencs=t_vt)
    np.testing.assert_allclose(float(loss_sum), float(l_ref), rtol=1e-5)
    _assert_grads_close(s["lay"].state_dict(grads), _jax_sd(s, g_ref))


@pytest.mark.parametrize("steps", [1, 3])
def test_tail_train_adam_matches_pallas(setup, steps):
    """fused_train_adam with vencs vs make_fused_train_adam(tail=...) over
    `steps` chained steps at the recipe's lr (1e-4): loss sums to 1e-5 at
    every step, params to atol 1e-6 after one step and 3e-6 after three (the
    JAX package's own chained bound), except that an element whose gradient
    is ~0 and flips sign under the bf16 rounding noise moves up to 2*lr per
    step: at most 0.1% of the elements may do so, none by more. (At lr 5e-3
    such a jump, 1e-2, changes the next step's loss by ~1e-4 relative and
    the chains part: measured on the extrinsic field, 32% of the weights
    beyond 3e-6 after three steps; at 1e-4, none.)"""
    s, B = setup, 256
    lay, lr = s["lay"], 1e-4
    (j_table, j_vt), (t_table, t_vt) = _tables(s)
    run = make_fused_train_adam(s["jspec"], "L1", batch_tile=TILE, tail=s["jtail"],
                                interpret=True)
    wb = list(s["wb"])
    jm = [jnp.zeros_like(w) for w in wb]
    jv = [jnp.zeros_like(w) for w in wb]
    p, m, v = s["flat"].clone(), torch.zeros(lay.n), torch.zeros(lay.n)
    hyper = adam_hyper_rows(torch.arange(1, steps + 1), lr)
    for t in range(steps):
        blk = (t * 3) % 4
        gt = s["gt"][blk * B:(blk + 1) * B]
        wb, jm, jv, l_ref, _ = run(wb, jm, jv, jax_hyper_rows(jnp.array([t + 1]), lr)[0:1],
                                   j_table, j_vt, jnp.asarray(gt), blk * (B // TILE), B)
        loss_sum, _ = fused_train_adam(lay, p, m, v, hyper[t], t_table, torch.from_numpy(gt),
                                       blk, B, vencs=t_vt)
        np.testing.assert_allclose(float(loss_sum), float(l_ref), rtol=1e-5)
    atol = 1e-6 if steps == 1 else 3e-6
    want, got = _jax_sd(s, wb), lay.state_dict(p)
    diff = np.concatenate([np.abs(got[k].numpy() - want[k].numpy()).ravel() for k in want])
    assert (diff > atol).mean() <= 1e-3, (diff > atol).sum()
    assert diff.max() <= 2 * lr * steps
    # the moments carry across the same way (Adam over the longer buffer)
    mu_want = _jax_sd(s, jm)
    assert max(float((lay.state_dict(m)[k] - mu_want[k]).abs().max()) for k in mu_want) <= 1e-3


def test_precompute_hit_vencs_matches_jax(setup):
    """Both encode every cached hit in chunks: the port at its venc_w lanes,
    JAX at 128; the first venc_in lanes agree (the view encoder's 5e-5, see
    test_torch_port_viewdep), the pads are zero, the dtype is the storage
    dtype."""
    s = setup
    n = len(s["feats"])
    vids = np.random.default_rng(3).integers(0, 100, size=(n, 3)).astype(np.int32)
    bary = np.full((n, 3), 1.0 / 3.0, np.float32)
    jd = JaxRayData(features=jnp.zeros((100, K)), feature_strategy="efuncs",
                    vertex_idxs_of_hit_faces=jnp.asarray(vids), barycentric_coords=jnp.asarray(bary),
                    expected_rgbs=jnp.asarray(s["gt"]), unit_ray_dirs=jnp.asarray(s["dirs"]),
                    face_idxs=jnp.asarray(s["fids"]))
    want = np.asarray(jax_precompute_vencs(jax_view_encoder_apply(s["jmodel"]), jd, 128,
                                           chunk=300).hit_vencs)
    td = RayData(torch.zeros(100, K), "efuncs", torch.from_numpy(vids).long(),
                 torch.from_numpy(bary), torch.from_numpy(s["gt"]), torch.from_numpy(s["dirs"]),
                 torch.from_numpy(s["fids"]).long())
    w, vin = s["lay"].tail.venc_w, s["lay"].tail.venc_in
    got = precompute_hit_vencs(view_encoder_apply(s["model"]), td, w, chunk=300).hit_vencs
    assert got.shape == (n, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got[:, :vin].numpy(), want[:, :vin], rtol=0, atol=5e-5)
    assert not got[:, vin:].any() and not want[:, vin:].any()
    bf = precompute_hit_vencs(view_encoder_apply(s["model"]), td, w, dtype=torch.bfloat16)
    assert bf.hit_vencs.dtype == torch.bfloat16
    assert torch.equal(bf.hit_vencs, got.to(torch.bfloat16))


# --------------------------------------------------------------- epochs


def _datasets(n, seed, mesh_faces, table=True):
    """The same records as a JAX RayData and a port RayData (CPU), with
    ray directions and face ids; bf16 hit-feature tables when `table`."""
    rng = np.random.default_rng(seed)
    V = 120
    feats = rng.normal(size=(V, K)).astype(np.float32)
    vids = rng.integers(0, V, size=(n, 3)).astype(np.int32)
    bary = rng.dirichlet(np.ones(3), size=n).astype(np.float32)
    rgbs = rng.uniform(size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    fids = rng.integers(0, mesh_faces, size=n).astype(np.int32)
    jd = JaxRayData(features=jnp.asarray(feats), feature_strategy="efuncs",
                    vertex_idxs_of_hit_faces=jnp.asarray(vids), barycentric_coords=jnp.asarray(bary),
                    expected_rgbs=jnp.asarray(rgbs), unit_ray_dirs=jnp.asarray(dirs),
                    face_idxs=jnp.asarray(fids))
    td = RayData(torch.from_numpy(feats), "efuncs", torch.from_numpy(vids).long(),
                 torch.from_numpy(bary), torch.from_numpy(rgbs), torch.from_numpy(dirs),
                 torch.from_numpy(fids).long())
    if table:
        jd, td = jax_precompute(jd, dtype=jnp.bfloat16), precompute_hit_features(
            td, dtype=torch.bfloat16)
    return jd, td


def _with_jax_vencs(s, jd, td):
    """JAX's bf16 encodings on both sides (the encoders' ~1e-6 difference
    would flip some bf16 roundings; their parity is tested above)."""
    jd = jax_precompute_vencs(jax_view_encoder_apply(s["jmodel"]), jd, 128, dtype=jnp.bfloat16)
    w = s["lay"].tail.venc_w
    vt = np.asarray(jd.hit_vencs.astype(jnp.float32))[:, :w]
    td.hit_vencs = torch.from_numpy(np.ascontiguousarray(vt)).to(torch.bfloat16)
    return jd, td


def _jax_state(s, opt):
    return jax_create_state(jax.tree_util.tree_map(jnp.array, s["variables"]), opt)


def _params_sd(s, jstate):
    return state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jax.device_get(jstate.params)),
                                s["cfg"])


def _diffs(port_sd, ref_sd):
    return np.concatenate([np.abs(port_sd[k].numpy() - ref_sd[k].numpy()).ravel()
                           for k in ref_sd])


def test_one_step_epoch_is_near_exact(setup):
    """One block through the tail kernels' path (plain twins) vs the JAX
    fused in-kernel-Adam epoch: loss to 1e-5, count 1, params to 1e-6
    except where Adam's first step, lr * g / (|g| + eps), divides a
    gradient that cancels to ~1e-7 by itself: there an absolute difference
    at the gradients' rounding level (~5e-8) is a large relative one
    (measured up to 2.5e-5 on 3 elements); at most 0.1% of the elements,
    none by more than 2*lr."""
    s = setup
    jd, td = _with_jax_vencs(s, *_datasets(256, 0, jax_icosphere(2).num_faces))
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    j_epoch, _ = jax_epoch_fns(s["jmodel"], opt, "L1", shuffle="blocks", fused=True,
                               fused_adam=True)
    jst, jm = j_epoch(_jax_state(s, opt), jax.random.PRNGKey(0), jd, 1, 256)
    t_epoch, _ = make_epoch_fns(s["model"], "L1", shuffle="blocks", fused=True)
    st = create_train_state(s["model"], AdamHyper(LR), "cpu")
    before = eager_step.launches
    st, m = t_epoch(st, np.zeros(1, np.int64), td, 1, 256)
    assert eager_step.launches == before  # the kernels' path, not the eager step
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["sq_err_per_sample"]), float(jm["sq_err_per_sample"]),
                               rtol=1e-5)
    diff = _diffs(st.state_dict(), _params_sd(s, jst))
    assert (diff > 1e-6).mean() <= 1e-3 and diff.max() <= 2 * LR
    assert st.count == 1 == int(jst.opt_state.inner_state[0].count)


@pytest.mark.parametrize("fused_adam", [True, False])
def test_two_epochs_track_the_reference(setup, fused_adam):
    """Two epochs of 4 blocks each with JAX's block orders replayed: losses
    to rtol 2e-3 (the plain field's bound, tighter than the JAX package's
    own fused-vs-XLA bound for this family, tests/test_fused_viewdep.py:
    rtol 0.04); params and mu to atol 2.5e-3 except where a gradient near 0
    flips sign under rounding noise (an L1 seed flip moves every gradient a
    little), which moves a weight by up to 2*lr per Adam step: at most 1% of
    the elements (measured 0.017% on the intrinsic field, none on the
    extrinsic), none by more than 2*lr*steps."""
    s = setup
    jd, td = _with_jax_vencs(s, *_datasets(1024, 1, jax_icosphere(2).num_faces))
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    j_epoch, _ = jax_epoch_fns(s["jmodel"], opt, "L1", shuffle="blocks", fused=True,
                               fused_adam=fused_adam)
    t_epoch, _ = make_epoch_fns(s["model"], "L1", shuffle="blocks", fused=True,
                                fused_adam=fused_adam)
    jst = _jax_state(s, opt)
    st = create_train_state(s["model"], AdamHyper(LR), "cpu")
    for e in range(2):
        key = jax.random.PRNGKey(e)
        jst, jm = j_epoch(jst, key, jd, 4, 256)
        st, m = t_epoch(st, np.asarray(jax.random.permutation(key, 4)), td, 4, 256)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-3)
    diff = _diffs(st.state_dict(), _params_sd(s, jst))
    assert (diff > 2.5e-3).mean() <= 1e-2 and diff.max() <= 2 * LR * 8
    adam = adam_state_from_optax(jax.device_get(jst.opt_state), s["cfg"])
    assert _diffs(st.layout.state_dict(st.mu), adam["mu"]).max() <= 2.5e-3
    assert st.count == adam["count"] == 8


def test_two_epochs_with_an_lr_change_track_the_reference(setup, monkeypatch):
    """The tail layout through the step's index arithmetic: two blocks
    epochs, an explicit block permutation each, the lr lowered between
    them, against the JAX package's blocks + fused + fused_adam epoch on
    the same permutations; the steps take the blocks in the permutation's
    order; losses and params held as in test_two_epochs_track_the_reference."""
    s = setup
    checked = _check_weight_copy_every_step(monkeypatch)
    jd, td = _with_jax_vencs(s, *_datasets(1024, 1, jax_icosphere(2).num_faces))
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    j_epoch, _ = jax_epoch_fns(s["jmodel"], opt, "L1", shuffle="blocks", fused=True,
                               fused_adam=True)
    t_epoch, _ = make_epoch_fns(s["model"], "L1", shuffle="blocks", fused=True, fused_adam=True)
    jst = _jax_state(s, opt)
    st = create_train_state(s["model"], AdamHyper(LR), "cpu")
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
    diff = _diffs(st.state_dict(), _params_sd(s, jst))
    assert (diff > 2.5e-3).mean() <= 1e-2 and diff.max() <= 2 * LR * 8
    assert st.count == 8


def test_tail_wgrad_adam_plain_is_wgrad_then_adam(setup):
    """The tail layout's twin of wgrad with its Adam epilogue equals
    wgrad_viewdep_plain then adam_apply_plain, with the bf16 copy and the
    accumulators, to the bit; m and v random over the whole flat buffer
    (pads included), every m entry moves."""
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (adam_apply_plain,
                                                                 fwd_bwd_viewdep_plain,
                                                                 wgrad_adam_plain,
                                                                 wgrad_viewdep_plain)

    s, B = setup, 256
    lay, flat = s["lay"], s["flat"]
    _, (t_table, t_vt) = _tables(s)
    x, venc = t_table[:B], t_vt[:B]
    acts, deltas, bsum, l, q = fwd_bwd_viewdep_plain(lay, flat, x, venc,
                                                     torch.from_numpy(s["gt"][:B]), "L1")
    rng = np.random.default_rng(3)
    m = torch.from_numpy(rng.normal(size=lay.n).astype(np.float32)) * 1e-4
    v = torch.from_numpy(rng.uniform(size=lay.n).astype(np.float32)) * 1e-6
    hyper = adam_hyper_rows(torch.tensor([2]), 1e-3)[0]
    want = adam_apply_plain(flat, m, v, hyper,
                            wgrad_viewdep_plain(lay, x, venc, acts, deltas, bsum))
    p2, m2, v2 = flat.clone(), m.clone(), v.clone()
    wb = torch.zeros(lay.n, dtype=torch.bfloat16)
    acc = torch.tensor([1.0, 2.0])
    wgrad_adam_plain(lay, x, acts, deltas, bsum, (l, q), p2, m2, v2, hyper, wb, acc, venc)
    for got, w in zip((p2, m2, v2), want):
        assert torch.equal(got, w)
    assert torch.equal(wb, want[0].to(torch.bfloat16))
    assert torch.equal(acc, torch.tensor([1.0, 2.0]) + torch.stack((l / torch.tensor(3.0), q)))
    assert (m2 != m).all()


def _check_weight_copy_every_step(monkeypatch):
    """Wrap train/steps.py's fused_train_adam_step (the epoch's step, its
    block found at order[i]): after each step the scratch's bf16 weight
    copy (what the tail fwd_bwd kernel reads) must equal the params rounded to bf16,
    bit for bit. Returns the list of checked blocks."""
    from intrinsic_neural_fields_tpu_torch.train import steps

    checked, inner = [], steps.fused_train_adam_step

    def step(layout, params, m, v, hyper_all, order, i, feats, targets, B, loss_type, scratch,
             sums, acc, vencs=None):
        inner(layout, params, m, v, hyper_all, order, i, feats, targets, B, loss_type, scratch,
              sums, acc, vencs)
        assert layout.tail is not None and vencs is not None
        assert torch.equal(scratch.wb, params.to(torch.bfloat16))
        checked.append(int(order[i]))

    monkeypatch.setattr(steps, "fused_train_adam_step", step)
    return checked


def test_bf16_weight_copy_equals_params_after_every_step(setup, monkeypatch):
    """Two epochs of 4 blocks of the tail layout through make_epoch_fns (the
    tail kernels' path, plain twins on the CPU)."""
    s = setup
    checked = _check_weight_copy_every_step(monkeypatch)
    _, td = _with_jax_vencs(s, *_datasets(1024, 1, jax_icosphere(2).num_faces))
    t_epoch, _ = make_epoch_fns(s["model"], "L1", shuffle="blocks", fused=True)
    st = create_train_state(s["model"], AdamHyper(LR), "cpu")
    for e in range(2):
        st, _ = t_epoch(st, np.arange(4)[::-1].copy() if e else np.arange(4), td, 4, 256)
    assert len(checked) == 8 and st.count == 8


def test_eager_ragged_tail_and_val_match_xla(setup):
    """The view-dependent eager path (shuffle full, no table, a ragged tail
    of 1000 records at batch 256: the f32 forward encodes dirs and face ids
    itself) vs the JAX XLA step on JAX's permutation, and val_epoch vs the
    JAX val epoch. All f32 on the CPU: loss to 1e-5, params to 1e-5."""
    s = setup
    jd, td = _datasets(1000, 2, jax_icosphere(2).num_faces, table=False)
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    j_epoch, j_val = jax_epoch_fns(s["jmodel"], opt, "L2", shuffle="full", fused=False)
    t_epoch, t_val = make_epoch_fns(s["model"], "L2", shuffle="full", fused=True)
    key = jax.random.PRNGKey(4)
    jst, jm = j_epoch(_jax_state(s, opt), key, jd, 4, 256)
    st = create_train_state(s["model"], AdamHyper(LR), "cpu")
    before = eager_step.launches
    st, m = t_epoch(st, np.asarray(jax.random.permutation(key, 1000)), td, 4, 256)
    assert eager_step.launches == before + 4  # no table: never the kernels
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["sq_err_per_sample"]), float(jm["sq_err_per_sample"]),
                               rtol=1e-5)
    assert _diffs(st.state_dict(), _params_sd(s, jst)).max() <= 1e-5
    want = j_val(jst, jd, 256)
    got = t_val(st, td, 256)
    for key_ in ("loss", "sq_err_per_sample"):
        np.testing.assert_allclose(float(got[key_]), float(want[key_]), rtol=1e-5)


def test_state_carry_and_checkpoint_read_by_jax(setup, tmp_path):
    """A JAX-trained view-dependent state carried into the port
    (adam_state_from_optax on the {"spatial_mlp", "Dense_0", "Dense_1"}
    tree) equals it exactly, and the port's checkpoint.pt reads back through
    the JAX package's load_reference_train_checkpoint with equal weights,
    moments, count and hyperparameters; the weights apply in the JAX model
    as in the port's."""
    from intrinsic_neural_fields_tpu.utils.torch_convert import load_reference_train_checkpoint

    s = setup
    jd, td = _with_jax_vencs(s, *_datasets(256, 5, jax_icosphere(2).num_faces))
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR, b1=0.8, b2=0.95)
    j_epoch, _ = jax_epoch_fns(s["jmodel"], opt, "L1", shuffle="blocks", fused=True)
    jst, _ = j_epoch(_jax_state(s, opt), jax.random.PRNGKey(0), jd, 1, 256)
    adam = adam_state_from_optax(jax.device_get(jst.opt_state), s["cfg"])
    assert (adam["count"], adam["b1"], adam["b2"]) == (1, np.float32(0.8), np.float32(0.95))
    st = TrainState.from_torch(s["lay"], _params_sd(s, jst), adam, "cpu")
    assert _diffs(st.layout.state_dict(st.nu), adam["nu"]).max() == 0.0

    path = str(tmp_path / "checkpoint.pt")
    save_train_checkpoint(path, 7, st)
    info = load_reference_train_checkpoint(path)
    assert info["epoch"] == 7 and info["adam"]["count"] == 1
    assert np.float32(info["adam"]["b1"]) == np.float32(0.8)
    for tree, flat in ((info["variables"]["params"], st.params), (info["adam"]["mu"], st.mu),
                       (info["adam"]["nu"], st.nu)):
        want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree), s["cfg"])
        assert _diffs(st.layout.state_dict(flat), want).max() == 0.0
    back = load_train_checkpoint(path)
    st2 = TrainState.from_torch(st.layout, back["model_state_dict"], back["adam"], "cpu")
    for a, b in ((st2.params, st.params), (st2.mu, st.mu), (st2.nu, st.nu)):
        assert torch.equal(a, b)
    batch = {"eigenfunctions": jnp.asarray(s["feats"][:64]),
             "unit_ray_dirs": jnp.asarray(s["dirs"][:64]),
             "hit_face_idxs": jnp.asarray(s["fids"][:64])}
    ref = np.asarray(s["jmodel"].apply(info["variables"], batch))
    s["model"].load_state_dict(st.state_dict())
    out = s["model"](torch.from_numpy(s["feats"][:64]), torch.from_numpy(s["dirs"][:64]),
                     torch.from_numpy(s["fids"][:64])).detach().numpy()
    s["model"].load_state_dict(s["lay"].state_dict(s["flat"]))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


# ------------------------------------------------------------------ Trainer


class Recorder:
    """In-memory stand-in for tensorboardX's SummaryWriter."""

    def __init__(self):
        self.scalars, self.images = [], []

    def add_scalar(self, tag, value, global_step=None):
        self.scalars.append((tag, float(value), global_step))

    def add_image(self, tag, img, global_step=None):
        self.images.append((tag, np.asarray(img).shape, global_step))


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A tiny view-dependent experiment on disk: blob mesh, eigenfunctions,
    train / val / test ray caches with ray directions and face ids."""
    root = str(tmp_path_factory.mktemp("vdexp"))
    mesh = blob_mesh(subdivisions=1)
    V, F = mesh.num_vertices, mesh.num_faces
    write_obj(os.path.join(root, "blob.obj"), mesh.vertices, mesh.faces)
    np.save(os.path.join(root, "efuncs.npy"),
            np.random.default_rng(9).normal(size=(V, K + 4)).astype(np.float32))
    for split, n, seed in (("train", 1024, 11), ("val", 300, 12), ("test", 200, 13)):
        rng = np.random.default_rng(seed)
        fids = rng.integers(0, F, size=n)
        dirs = rng.normal(size=(n, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        path = os.path.join(root, split)
        os.makedirs(path)
        for name, arr in (("vids_of_hit_faces", mesh.faces[fids].astype(np.int32)),
                          ("barycentric_coords",
                           rng.dirichlet(np.ones(3), size=n).astype(np.float32)),
                          ("expected_rgbs", rng.uniform(size=(n, 3)).astype(np.float32)),
                          ("unit_ray_dirs", dirs), ("face_idxs", fids.astype(np.int32))):
            np.save(os.path.join(path, f"{name}.npy"), arr)

    def config(out_name, epochs):
        cfg = _cfg("intrinsic", skip=2)
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
                "eval_render_input_paths": [], "eval_render_img_names": [],
            },
            "model": cfg,
            "training": {
                "out_dir": os.path.join(root, out_name), "batch_size": 256, "lr": LR,
                "loss_type": "L1", "render_every": 1, "print_every": 1, "epochs": epochs,
                "checkpoint_every": 1, "shuffle": "blocks", "fused_mlp": True,
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


def test_trainer_runs_and_resumes_bit_exactly(experiment):
    """Two epochs of the view-dependent field through the port's Trainer
    (tail kernels' path, plain twins on the CPU): hit_vencs are
    pre-encoded in bf16, the loss falls, no eager step, every checkpoint
    kind is written, and a run resumed from checkpoint.pt equals the
    uninterrupted one to the bit; the model.pt loads into the model."""
    from intrinsic_neural_fields_tpu_torch.utils.weights import load_reference_weights

    root, config = experiment
    rec = Recorder()
    t = _port_trainer(config("run2", 2), rec)
    assert t.train_data.hit_vencs.dtype == torch.bfloat16
    assert t.train_data.hit_vencs.shape == (1024, 16)
    before = dict(kernel_launches(), eager=eager_step.launches)
    t.train()
    assert eager_step.launches == before["eager"]
    losses = [v for tag, v, _ in rec.scalars if tag == "Train_Loss"]
    assert len(losses) == 2 and losses[1] < losses[0]
    for name in ("model.pt", "checkpoint.pt", "model_last_epoch.pt"):
        assert os.path.exists(os.path.join(root, "run2", name))
    t.model.load_state_dict(load_reference_weights(os.path.join(root, "run2", "model.pt")))

    shutil.copytree(os.path.join(root, "run2"), os.path.join(root, "resumed"))
    resumed = _port_trainer(config("resumed", 3), Recorder())
    resumed.train()
    straight = _port_trainer(config("straight", 3), Recorder())
    straight.train()
    for a, b in ((resumed.state.params, straight.state.params),
                 (resumed.state.mu, straight.state.mu), (resumed.state.nu, straight.state.nu)):
        assert torch.equal(a, b)
    assert resumed.state.count == straight.state.count == 12


def test_bf16_weight_copy_after_resume(experiment, monkeypatch):
    """A view-dependent run resumed from checkpoint.pt makes its copy from
    the restored params and keeps it current on every step."""
    root, config = experiment
    _port_trainer(config("wb_run", 1), Recorder()).train()
    shutil.copytree(os.path.join(root, "wb_run"), os.path.join(root, "wb_resumed"))
    checked = _check_weight_copy_every_step(monkeypatch)
    resumed = _port_trainer(config("wb_resumed", 2), Recorder())
    resumed.train()
    assert len(checked) == 4 and resumed.state.count == 8
