"""The NeuTex baseline through the port, against the JAX package on the
same inputs (numpy seeds) on the CPU: the forward, the uv normalization and
mixture weights, both loss terms, the pretrained mapping's .npz and .pt
loads, chamfer, train and validation epochs from the same weights and
permutations (the eager step with the Adam kernel's plain twin against the
JAX XLA step under optax.inject_hyperparams(optax.adam)), the checkpoint
round trip and the Adam state carried from optax, the module-mode render
and bake, the factory's and the epoch functions' refusals, the Trainer's
resume, and the mapping pretraining CLI.

Weights cross from the JAX NeuTexTrainWrapper, initialized from
PRNGKey(0), through utils/weights.state_dict_from_flax. Widths are the
model's own except the texture encoding's, cut to num_freqs 4 (27 columns).
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from intrinsic_neural_fields_tpu.data.sampler import RayData as JaxRayData
from intrinsic_neural_fields_tpu.data.sampler import precompute_hit_features as jax_precompute
from intrinsic_neural_fields_tpu.models.neutex import NeuTex as JaxNeuTex
from intrinsic_neural_fields_tpu.models.neutex import NeuTexTrainWrapper as JaxWrapper
from intrinsic_neural_fields_tpu.models.neutex import chamfer_distance as jax_chamfer
from intrinsic_neural_fields_tpu.models.neutex import load_pretrained_mapping as jax_load_mapping
from intrinsic_neural_fields_tpu.models.neutex import sample_sphere_points as jax_sample_sphere
from intrinsic_neural_fields_tpu.train.steps import create_train_state as jax_create_state
from intrinsic_neural_fields_tpu.train.steps import make_epoch_fns as jax_epoch_fns
from intrinsic_neural_fields_tpu.utils.checkpoint import load_npz_pytree as jax_load_npz
from intrinsic_neural_fields_tpu.utils.checkpoint import save_npz_pytree as jax_save_npz

from intrinsic_neural_fields_tpu_torch.data.sampler import RayData, precompute_hit_features
from intrinsic_neural_fields_tpu_torch.evaluation.metrics import psnr
from intrinsic_neural_fields_tpu_torch.geometry.mesh_io import write_obj
from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
from intrinsic_neural_fields_tpu_torch.geometry.synthetic import blob_mesh, look_at_cam, pinhole_K
from intrinsic_neural_fields_tpu_torch.models import make_model
from intrinsic_neural_fields_tpu_torch.models.neutex import (
    NeuTexTrainWrapper,
    chamfer_distance,
    load_pretrained_mapping,
    sample_sphere_points,
)
from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (
    fused_mlp_eligible,
    fused_pre_embed_eligible,
    fused_viewdep_eligible,
    kernel_launches,
)
from intrinsic_neural_fields_tpu_torch.render.renderer import Renderer
from intrinsic_neural_fields_tpu_torch.train.steps import (
    AdamHyper,
    ModuleLayout,
    TrainState,
    create_train_state,
    eager_step,
    make_epoch_fns,
)
from intrinsic_neural_fields_tpu_torch.utils.checkpoint import (
    load_train_checkpoint,
    save_npz_pytree,
    save_train_checkpoint,
)
from intrinsic_neural_fields_tpu_torch.utils.jax_random import PRNGKey
from intrinsic_neural_fields_tpu_torch.utils.weights import (
    adam_state_from_optax,
    load_reference_weights,
    state_dict_from_flax,
)

torch.set_num_threads(2)

NUM_FREQS = 4
LR = 1e-4  # configs/synthetic/neutex_blob.yaml's
CFG = {"type": "neutex", "feature_strategy": "xyz", "k": NUM_FREQS, "use_logspace": True}
MAPPING = ("net_inverse_atlasnet_3d_to_uv", "net_atlasnet_uv_to_3d")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOB_MAPPING = os.path.join(REPO, "pretrained", "blob_pretrained_neutex_mapping.npz")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_wrapper(seed=0):
    """The JAX wrapper and its variables (numpy), initialized through
    loss_and_rgbs so the mapping decoder exists (as init_model does)."""
    model = JaxWrapper(num_freqs=NUM_FREQS)
    batch = {"xyz": jnp.zeros((5, 3), jnp.float32),
             "expected_rgbs": jnp.zeros((5, 3), jnp.float32)}
    variables = model.init({"params": jax.random.PRNGKey(seed)}, batch,
                           method=model.loss_and_rgbs)
    return model, _np(variables)


def _port(variables):
    tm = NeuTexTrainWrapper(num_freqs=NUM_FREQS)
    tm.load_state_dict(state_dict_from_flax(variables, CFG))
    return tm


def _xyz(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


def _mapping_npz(path, variables):
    root = variables["params"]["neutex"]
    jax_save_npz(path, {k: root[k] for k in MAPPING})
    return path


# ------------------------------------------------------------------ the model


def test_forward_matches_jax():
    """The wrapper's forward (RGB only) on 300 positions: within 1e-5 of the
    JAX wrapper's (f32 on both sides, other summation orders); every key
    of the flax tree lands in the port's state dict."""
    jmodel, variables = _jax_wrapper()
    tm = _port(variables)
    assert set(tm.state_dict()) == set(state_dict_from_flax(variables, CFG))
    assert sum(p.numel() for p in tm.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(variables["params"]))
    x = _xyz(300, 1)
    want = np.asarray(jmodel.apply(variables, {"xyz": jnp.asarray(x),
                                               "expected_rgbs": jnp.zeros((300, 3))}))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (300, 3) and (got > 0).all() and (got < 1).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_uv_on_the_sphere_and_weights_one():
    """The inverse mapping's uv have norm 1 (within 2 f32 ulps) and agree
    with JAX's within 1e-5; the softmax over one primitive is exactly 1."""
    _, variables = _jax_wrapper()
    tm = _port(variables)
    x = _xyz(300, 2)
    with torch.no_grad():
        uv, w, _ = tm.neutex.net_inverse_atlasnet_3d_to_uv(torch.from_numpy(x))
    norms = torch.linalg.vector_norm(uv, dim=-1).numpy()
    np.testing.assert_allclose(norms, 1.0, rtol=0, atol=2.4e-7)
    assert torch.equal(w, torch.ones_like(w))
    juv, jw, _ = JaxNeuTex(num_freqs=NUM_FREQS).apply(
        {"params": variables["params"]["neutex"]}, jnp.asarray(x), method=JaxNeuTex.invert_points)
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jw), 1.0)


def test_loss_terms_match_jax():
    """Color MSE and the inverse-mapping cycle loss each within 1e-5
    relative of the JAX terms; loss_and_rgbs returns their sum and the
    forward's RGB."""
    jmodel, variables = _jax_wrapper()
    tm = _port(variables)
    x = _xyz(256, 3)
    gt = np.random.default_rng(4).uniform(size=(256, 3)).astype(np.float32)
    jout = JaxNeuTex(num_freqs=NUM_FREQS).apply({"params": variables["params"]["neutex"]},
                                                {"xyz": jnp.asarray(x)})
    with torch.no_grad():
        out = tm.neutex(torch.from_numpy(x))
        loss, rgbs = tm.loss_and_rgbs(torch.from_numpy(x), torch.from_numpy(gt))

    color = float(((out["rgbs"] - torch.from_numpy(gt)) ** 2).mean())
    inverse = float((((out["points_original"][:, None, :] - out["points_inverse"]) ** 2).sum(-1)
                     * out["points_inverse_primitive_weights"]).sum(-1).mean())
    j_color = float(np.mean((np.asarray(jout["rgbs"]) - gt) ** 2))
    j_inverse = float(np.mean(np.sum(np.sum(
        (x[:, None, :] - np.asarray(jout["points_inverse"])) ** 2, -1)
        * np.asarray(jout["points_inverse_primitive_weights"]), -1)))
    np.testing.assert_allclose(color, j_color, rtol=1e-5)
    np.testing.assert_allclose(inverse, j_inverse, rtol=1e-5)
    j_loss, _ = jmodel.apply(variables, {"xyz": jnp.asarray(x), "expected_rgbs": jnp.asarray(gt)},
                             method=jmodel.loss_and_rgbs)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), color + inverse, rtol=1e-6)
    assert torch.equal(rgbs, out["rgbs"])


def test_npz_mapping_loads_to_the_bit_in_both_packages(tmp_path):
    """A mapping .npz written by the JAX package's save_npz_pytree loads into
    the port's mapping networks equal to the bit (weight = kernel^T), and
    one written by the port's save_npz_pytree loads into the JAX package
    equal to the bit; the texture network is left as it was."""
    _, src = _jax_wrapper(seed=0)
    _, other = _jax_wrapper(seed=7)
    path = _mapping_npz(str(tmp_path / "m.npz"), src)
    tm = _port(other)
    tex_before = {k: v.clone() for k, v in tm.state_dict().items() if ".net_texture." in k}
    load_pretrained_mapping(tm, path)
    want = state_dict_from_flax(src, CFG)
    got = tm.state_dict()
    for k, v in want.items():
        if ".net_texture." in k:
            assert torch.equal(got[k], tex_before[k])
        else:
            assert torch.equal(got[k], v), k
    # the port's writer, read by the JAX package
    port_path = str(tmp_path / "port.npz")
    save_npz_pytree(port_path, jax_load_npz(path))
    restored = jax_load_mapping(jax.tree_util.tree_map(jnp.array, other), port_path)
    for net in MAPPING:
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               _np(restored["params"]["neutex"][net]),
                               src["params"]["neutex"][net])


def test_pt_mapping_loads_to_the_bit_in_both_packages(tmp_path):
    """The reference's torch .pt format ({net_inverse_atlasnet_3d_to_uv,
    net_atlasnet_uv_to_3d} state dicts, synthesized from seeded weights):
    both packages load the same weights to the bit; a wrong shape or a
    missing key is refused."""
    _, src = _jax_wrapper(seed=3)
    _, other = _jax_wrapper(seed=8)
    donor = _port(src)
    path = str(tmp_path / "ref.pt")
    torch.save({net: getattr(donor.neutex, net).state_dict() for net in MAPPING}, path)
    tm = _port(other)
    load_pretrained_mapping(tm, path)
    restored = _np(jax_load_mapping(jax.tree_util.tree_map(jnp.array, other), path))
    want = state_dict_from_flax(restored, CFG)
    for k, v in tm.state_dict().items():
        if ".net_texture." not in k:
            assert torch.equal(v, want[k]), k
            assert torch.equal(v, donor.state_dict()[k]), k
    state = torch.load(path, weights_only=True)
    bad = dict(state, net_atlasnet_uv_to_3d={
        k: (v[:, :2] if k.endswith("linear1.weight") else v)
        for k, v in state["net_atlasnet_uv_to_3d"].items()})
    torch.save(bad, str(tmp_path / "bad.pt"))
    with pytest.raises(ValueError, match="shape"):
        load_pretrained_mapping(tm, str(tmp_path / "bad.pt"))
    short = dict(state, net_inverse_atlasnet_3d_to_uv={
        k: v for k, v in state["net_inverse_atlasnet_3d_to_uv"].items()
        if "last_linear" not in k})
    torch.save(short, str(tmp_path / "short.pt"))
    with pytest.raises(ValueError, match="keys differ"):
        load_pretrained_mapping(tm, str(tmp_path / "short.pt"))


def test_chamfer_matches_jax():
    """Chunked chamfer (ragged last chunk against the 1e6 sentinel) within
    1e-5 relative of JAX's and of the dense numpy distance; its gradient
    within 1e-4 relative (norm) of jax.grad's; exact zero for equal sets."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(100, 3)).astype(np.float32)
    y = rng.normal(size=(77, 3)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    got = chamfer_distance(xt, torch.from_numpy(y), chunk=16)
    want = float(jax_chamfer(jnp.asarray(x), jnp.asarray(y), chunk=16))
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5)
    dm = np.linalg.norm(x[:, None].astype(np.float64) - y[None], axis=-1) ** 2
    np.testing.assert_allclose(float(got.detach()), dm.min(1).mean() + dm.min(0).mean(),
                               rtol=1e-5)
    got.backward()
    jg = np.asarray(jax.grad(lambda a: jax_chamfer(a, jnp.asarray(y), chunk=16))(jnp.asarray(x)))
    assert np.linalg.norm(xt.grad.numpy() - jg) <= 1e-4 * np.linalg.norm(jg)
    a = torch.tensor([[0.0, 0, 0], [1, 0, 0]])
    assert float(chamfer_distance(a, a.clone())) == 0.0
    c = torch.tensor([[0.0, 0, 0.5], [1, 0, 0.5]])
    np.testing.assert_allclose(float(chamfer_distance(a, c)), 0.5, atol=1e-6)


def test_sample_sphere_points_on_the_sphere():
    """The port's samples from a key are the JAX package's from the same
    key (within 1e-6: the normal draw's few ulps, then the normalization),
    on the unit sphere."""
    pts = sample_sphere_points(PRNGKey(0), 500)
    want = np.asarray(jax_sample_sphere(jax.random.PRNGKey(0), 500))
    np.testing.assert_allclose(pts.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(torch.linalg.vector_norm(pts, dim=-1).numpy(), 1.0, atol=1e-6)
    assert pts.shape == (500, 3) and abs(float(pts.mean())) < 0.1


# ------------------------------------------------------------------ epochs


def _toy_data(n=1000, seed=0):
    """The same records as a JAX RayData and a port RayData over the blob's
    vertex table (subdivision 2; feature_strategy xyz), hit positions on
    its faces precomputed."""
    rng = np.random.default_rng(seed)
    m = blob_mesh(2)
    verts = np.asarray(m.vertices, np.float32)
    vids = np.asarray(m.faces, np.int32)[rng.integers(0, m.num_faces, n)]
    bary = rng.dirichlet(np.ones(3), size=n).astype(np.float32)
    rgbs = rng.uniform(size=(n, 3)).astype(np.float32)
    jd = JaxRayData(features=jnp.asarray(verts), feature_strategy="xyz",
                    vertex_idxs_of_hit_faces=jnp.asarray(vids),
                    barycentric_coords=jnp.asarray(bary), expected_rgbs=jnp.asarray(rgbs),
                    unit_ray_dirs=None, face_idxs=None)
    td = RayData(features=torch.from_numpy(verts), feature_strategy="xyz",
                 vertex_idxs_of_hit_faces=torch.from_numpy(vids).long(),
                 barycentric_coords=torch.from_numpy(bary), expected_rgbs=torch.from_numpy(rgbs))
    return jax_precompute(jd), precompute_hit_features(td)


def _max_param_diff(port_state, jax_params):
    want = state_dict_from_flax(_np(jax_params), CFG)
    got = port_state.state_dict()
    return max(float((got[k] - want[k]).abs().max()) for k in want)


def _pretrained_wrapper():
    """The JAX wrapper from PRNGKey(0) with the repo's blob mapping loaded,
    as the JAX package's init_model builds a NeuTex model."""
    jmodel, variables = _jax_wrapper()
    return jmodel, _np(jax_load_mapping(jax.tree_util.tree_map(jnp.array, variables),
                                        BLOB_MAPPING))


def _epochs(shuffle, n_batches, epochs=3, seed=11):
    """Run `epochs` epochs on both sides from the same weights (the
    pretrained mapping on the blob's hits: the recipe's start) and the same
    JAX permutations; returns (port state, port metrics, JAX state, JAX
    metrics, the val fns, the data, the port model)."""
    jmodel, variables = _pretrained_wrapper()
    tm = _port(variables)
    jd, td = _toy_data()
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    j_epoch, j_val = jax_epoch_fns(jmodel, opt, "L1", shuffle=shuffle)
    jst = jax_create_state(jax.tree_util.tree_map(jnp.array, variables), opt)
    t_epoch, t_val = make_epoch_fns(tm, "L1", shuffle=shuffle)
    st = create_train_state(tm, AdamHyper(LR), "cpu")
    blocks = shuffle == "blocks"
    tm_, jm_ = [], []
    for e in range(epochs):
        key = jax.random.PRNGKey(seed + e)
        jst, jm = j_epoch(jst, key, jd, n_batches, 256)
        order = np.asarray(jax.random.permutation(key, n_batches if blocks else jd.n))
        before = eager_step.launches
        st, m = t_epoch(st, order, td, n_batches, 256)
        assert eager_step.launches == before + n_batches
        tm_.append(m)
        jm_.append(jm)
    return st, tm_, jst, jm_, (t_val, j_val), (td, jd), tm


@pytest.mark.parametrize("shuffle,drop_last", [("full", True), ("full", False),
                                               ("blocks", True)])
def test_train_epochs_match_jax(shuffle, drop_last):
    """Three epochs (1000 records, batch 256: 3 batches with drop_last, 4
    with a ragged tail whose loss is the mean over all 256 rows, duplicates
    included, as in the JAX self-loss branch) of the eager step with the
    Adam kernel's plain twin against the JAX XLA step on the same
    permutations, from the recipe's start (the pretrained mapping, hits on
    the blob). Step one's gradients agree with JAX's and with an f64
    autograd to ~2e-6 per tensor, but Adam's first steps move every
    coordinate by ~lr * sign(g), so coordinates whose gradient is at
    rounding level part by up to 2 lr and the runs drift apart: measured
    over three epochs, epoch losses within 1.7e-4 relative (the first
    within 5e-6), the parameter updates within 1.4% (norm) and 3.3e-4 (max)
    of JAX's. Gates: the first epoch's loss 2e-5, every epoch's loss and
    squared error 1e-3 relative, the updates 5% (norm) and 5 lr (max)."""
    st, tms, jst, jms, _, _, tm = _epochs(shuffle, 3 if drop_last else 4)
    np.testing.assert_allclose(float(tms[0]["loss"]), float(jms[0]["loss"]), rtol=2e-5)
    for m, jm in zip(tms, jms):
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-3)
        np.testing.assert_allclose(float(m["sq_err_per_sample"]),
                                   float(jm["sq_err_per_sample"]), rtol=1e-3)
    _, start = _pretrained_wrapper()
    p0 = state_dict_from_flax(start, CFG)
    want = state_dict_from_flax(_np(jst.params), CFG)
    got = st.state_dict()
    d_jax = torch.cat([(want[k] - p0[k]).reshape(-1) for k in want])
    d_port = torch.cat([(got[k] - p0[k]).reshape(-1) for k in want])
    assert float((d_port - d_jax).norm()) <= 0.05 * float(d_jax.norm())
    assert float((d_port - d_jax).abs().max()) <= 5 * LR
    assert st.count == int(jst.opt_state.inner_state[0].count)
    assert float(tms[-1]["loss"]) < float(tms[0]["loss"])


def test_gradient_near_the_origin_matches_f64():
    """At hits near the origin the random-init inverse mapping's raw uv is
    small (|raw| ~ 0.007) and uv = raw / |raw| amplifies rounding: the
    port's f32 gradient of the NeuTex loss and the JAX package's op-by-op
    one (jax.disable_jit) both lie within 2e-5 (norm) of the f64 gradient
    in the inverse network (measured 4.0e-6 and 4.4e-6). The JAX
    package's jitted gradient on the CPU lies 8.0e-3 off there (XLA's
    fused kernels; a tolerance note of the reference, ROADMAP queue 3),
    so the epoch tests start from the pretrained mapping on the blob,
    where all three agree to ~2e-6."""
    jmodel, variables = _jax_wrapper()
    rng = np.random.default_rng(0)
    verts = rng.uniform(-1, 1, (120, 3))
    x = np.einsum("nk,nkd->nd", rng.dirichlet(np.ones(3), size=256),
                  verts[rng.integers(0, 120, (256, 3))]).astype(np.float32)
    gt = rng.uniform(size=(256, 3)).astype(np.float32)

    def loss_of(p):
        return jmodel.apply({"params": p}, {"xyz": jnp.asarray(x), "expected_rgbs":
                                            jnp.asarray(gt)}, method=jmodel.loss_and_rgbs)[0]

    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    with jax.disable_jit():
        eager = state_dict_from_flax({"params": _np(jax.grad(loss_of)(params))}, CFG)

    def port_grad(dtype):
        tm = _port(variables).to(dtype)
        layout = ModuleLayout(tm)
        flat = layout.flat_from_state_dict(tm.state_dict()).to(dtype).requires_grad_()
        loss, _ = torch.func.functional_call(tm, layout.views(flat), (
            torch.from_numpy(x).to(dtype), torch.from_numpy(gt).to(dtype)))
        loss.backward()
        return layout.state_dict(flat.grad)

    g64, g32 = port_grad(torch.float64), port_grad(torch.float32)
    key = "neutex.net_inverse_atlasnet_3d_to_uv.encoders.0.linear_list.0.weight"

    def rel(g):
        return float((g[key].double() - g64[key]).norm() / g64[key].norm())

    assert rel(g32) <= 2e-5 and rel(eager) <= 2e-5


def test_val_epoch_and_adam_state_match_jax(tmp_path):
    """val_epoch under L1 (the forward's RGB only, ragged last batch) within
    1e-5 relative of JAX's; the optax state carried by
    adam_state_from_optax equals the JAX moments to the bit and, after one
    more epoch on both sides from it, the states agree as in the epoch
    test; checkpoint.pt round-trips the state to the bit, its Adam state[i]
    following named_parameters()."""
    st, _, jst, _, (t_val, j_val), (td, jd), tm = _epochs("full", 3, epochs=1)
    got, want = t_val(st, td, 256), j_val(jst, jd, 256)
    for k in ("loss", "sq_err_per_sample"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)

    carried = TrainState.from_torch(ModuleLayout(tm), state_dict_from_flax(_np(jst.params), CFG),
                                    adam_state_from_optax(_np(jst.opt_state), CFG), "cpu")
    j_mu = state_dict_from_flax(_np(jst.opt_state.inner_state[0].mu), CFG)
    for k, v in carried.layout.state_dict(carried.mu).items():
        assert torch.equal(v, j_mu[k]), k
    assert carried.count == st.count == 3

    path = str(tmp_path / "checkpoint.pt")
    save_train_checkpoint(path, 0, st)
    raw = torch.load(path, weights_only=True)
    names = [n for n, _ in tm.named_parameters()]
    assert list(raw["model_state_dict"]) == names
    assert list(raw["optimizer_state_dict"]["state"]) == list(range(len(names)))
    ck = load_train_checkpoint(path)
    back = TrainState.from_torch(st.layout, ck["model_state_dict"], ck["adam"], "cpu")
    for a, b in ((back.params, st.params), (back.mu, st.mu), (back.nu, st.nu)):
        assert torch.equal(a, b)
    assert back.count == st.count and back.hyper == st.hyper


def test_self_loss_model_refuses_the_kernels_and_the_kernels_refuse_it():
    """fused_mlp on a NeuTex model raises (the kernels cannot compute it);
    the eligibility checks say no without raising."""
    _, variables = _jax_wrapper()
    tm = _port(variables)
    assert not (fused_mlp_eligible(tm) or fused_pre_embed_eligible(tm)
                or fused_viewdep_eligible(tm))
    with pytest.raises(ValueError, match="fused_mlp"):
        make_epoch_fns(tm, "L1", shuffle="blocks", fused=True)


# ------------------------------------------------------------------ factory


def test_factory_builds_the_blob_recipe(monkeypatch):
    """neutex_blob.yaml's model: the wrapper with the repo's mapping loaded
    to the bit (k=170: a 1,023-wide encoding, 793,482 parameters) on the
    CPU when asked, on CUDA by default (which raises without a card)."""
    with open(os.path.join(REPO, "configs", "synthetic", "neutex_blob.yaml")) as f:
        model_cfg = yaml.safe_load(f)["model"]
    model_cfg["pretrained_path"] = BLOB_MAPPING
    tm = make_model(model_cfg, device="cpu")
    assert isinstance(tm, NeuTexTrainWrapper) and tm.computes_loss
    assert tm.neutex.net_texture.textures[0].dense[0].in_features == 1023
    assert ModuleLayout(tm).n == 793_482
    want = state_dict_from_flax({"neutex": {**jax_load_npz(BLOB_MAPPING),
                                            "net_texture": {}}}, {"type": "neutex"})
    sd = tm.state_dict()
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    again = make_model(model_cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tm.state_dict().values(),
                                                 again.state_dict().values()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_model(model_cfg)


def test_factory_refuses_a_missing_mapping(tmp_path):
    with pytest.raises(ValueError, match="pretrained_path"):
        make_model(dict(CFG), device="cpu")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        make_model({**CFG, "pretrained_path": str(tmp_path / "none.npz")}, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        make_model({**CFG, "type": "nerf"}, device="cpu")


# ------------------------------------------------------------------ render, bake


def test_render_matches_jax_xla_renderer():
    """The port's Renderer runs a NeuTex model through its module forward on
    the interpolated positions (infer "module", no kernel launch) against
    the JAX renderer's infer="xla" on the same mesh, weights and views:
    masks and background equal, colours within 1e-3 (f32 on both sides, f16
    on both wires), PSNR >= 60 dB over the hits; an explicit kernel or
    plain mode is refused."""
    from intrinsic_neural_fields_tpu.geometry.primitives import icosphere as jax_icosphere
    from intrinsic_neural_fields_tpu.render.renderer import Renderer as JaxRenderer

    H = W = 40
    jmodel, variables = _jax_wrapper(seed=4)
    tm = _port(variables)
    jr = JaxRenderer(jmodel, variables, jax_icosphere(3), feature_strategy="xyz", H=H, W=W,
                     infer="xla")
    pr = Renderer(tm, icosphere(3), None, H=H, W=W, device="cpu")
    assert pr.infer_mode == "module" and pr.weights is None and pr.feature_strategy == "xyz"
    K = pinhole_K(H, W)
    before = kernel_launches()
    for eye in ((0.4, -2.8, 0.7), (2.5, 0.5, -0.4)):
        cam = look_at_cam(np.array(eye))
        img_ref, hit_ref = jr.render(cam, K, eval_render=True)
        img, hit = pr.render(cam, K, eval_render=True)
        np.testing.assert_array_equal(np.sort(hit), np.sort(hit_ref))
        mask = np.zeros(H * W, bool)
        mask[hit_ref] = True
        assert mask.any() and (~mask).any()
        np.testing.assert_array_equal(img.reshape(-1, 3)[~mask], img_ref.reshape(-1, 3)[~mask])
        np.testing.assert_allclose(img, img_ref, rtol=0, atol=1e-3)
        assert psnr(img, img_ref, mask) >= 60.0
    assert kernel_launches() == before
    for infer in ("plain", "kernel"):
        with pytest.raises(ValueError):
            Renderer(tm, icosphere(3), None, H=H, W=W, device="cpu", infer=infer)


def test_bake_field_rgbs_matches_jax(tmp_path):
    """The bake's field evaluation of a NeuTex out_dir (ragged 8,192-point
    chunks, the module forward on interpolated positions) within 1e-5 of
    the JAX bake's _field_rgbs."""
    from intrinsic_neural_fields_tpu.bake import bake as jax_bake
    from intrinsic_neural_fields_tpu.geometry.mesh import load_mesh as jax_load_mesh
    from intrinsic_neural_fields_tpu.utils.checkpoint import save_checkpoint

    from intrinsic_neural_fields_tpu_torch.bake.bake import _field_rgbs
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh

    m = icosphere(2)
    mesh_path = str(tmp_path / "m.obj")
    write_obj(mesh_path, m.vertices, m.faces)
    _, variables = _jax_wrapper(seed=5)
    _, other = _jax_wrapper(seed=6)
    cfg = {**CFG, "pretrained_path": _mapping_npz(str(tmp_path / "map.npz"), other)}
    out_dir = str(tmp_path / "run")
    os.makedirs(out_dir)
    save_checkpoint(os.path.join(out_dir, "model.ckpt"), variables)
    torch.save(state_dict_from_flax(variables, cfg), os.path.join(out_dir, "model.pt"))
    config = {"seed": 0, "data": {"mesh_path": mesh_path, "img_height": 32, "img_width": 32},
              "model": cfg, "training": {"out_dir": out_dir}}
    rng = np.random.default_rng(3)
    n = 8192 + 777
    vids = m.faces[rng.integers(0, m.num_faces, n)]
    bary = rng.dirichlet(np.ones(3), size=n)
    got = _field_rgbs(load_mesh(mesh_path), config, vids, bary, device="cpu")
    want = jax_bake._field_rgbs(jax_load_mesh(mesh_path), config, vids, bary)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ------------------------------------------------------------------ Trainer, CLIs


class Recorder:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, global_step=None):
        self.scalars.append((tag, float(value), global_step))

    def add_image(self, tag, img, global_step=None):
        pass


@pytest.fixture(scope="module")
def neutex_experiment(tmp_path_factory):
    """A tiny NeuTex experiment on disk: an icosphere, train / val / test
    ray caches over its vertices and a mapping .npz from the JAX init;
    returns a config factory (the recipe's schema, batch 256, blocks)."""
    root = str(tmp_path_factory.mktemp("neutex"))
    mesh = icosphere(1)
    write_obj(os.path.join(root, "m.obj"), mesh.vertices, mesh.faces)
    for split, n, seed in (("train", 1024, 31), ("val", 300, 32), ("test", 200, 33)):
        rng = np.random.default_rng(seed)
        d = os.path.join(root, split)
        os.makedirs(d)
        np.save(os.path.join(d, "vids_of_hit_faces.npy"),
                rng.integers(0, mesh.num_vertices, (n, 3)).astype(np.int32))
        np.save(os.path.join(d, "barycentric_coords.npy"),
                rng.dirichlet(np.ones(3), size=n).astype(np.float32))
        np.save(os.path.join(d, "expected_rgbs.npy"), rng.uniform(size=(n, 3)).astype(np.float32))
    _, variables = _jax_wrapper(seed=2)
    mapping = _mapping_npz(os.path.join(root, "map.npz"), variables)

    def config(out_name, epochs, **training):
        return {
            "seed": 1,
            "data": {"preproc_data_path_train": os.path.join(root, "train"),
                     "preproc_data_path_eval": os.path.join(root, "val"),
                     "preproc_data_path_test": os.path.join(root, "test"),
                     "mesh_path": os.path.join(root, "m.obj"),
                     "img_height": 16, "img_width": 16},
            "model": {**CFG, "pretrained_path": mapping},
            "training": {"out_dir": os.path.join(root, out_name), "batch_size": 256, "lr": LR,
                         "loss_type": "L1", "render_every": 100, "print_every": 1,
                         "epochs": epochs, "checkpoint_every": 1, "shuffle": "blocks",
                         **training},
        }

    return root, config


def _trainer(config):
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh
    from intrinsic_neural_fields_tpu_torch.train import (Trainer, get_data,
                                                         get_model_and_optim, get_renderer)

    mesh = load_mesh(config["data"]["mesh_path"])
    model, opt = get_model_and_optim(config, mesh, device="cpu")
    return Trainer(model, opt, config["training"]["loss_type"],
                   get_renderer(config, model, mesh, device="cpu"),
                   get_data(config, mesh, device="cpu"), mesh, config, writer=Recorder(),
                   device="cpu")


def test_trainer_trains_and_resumes_bit_exactly(neutex_experiment):
    """The Trainer on a NeuTex config: a ModuleLayout state, never
    pre-embedded, one eager step (one Adam call) per batch; the losses
    fall; model.pt loads into the port's model; a run resumed from
    checkpoint.pt equals the uninterrupted run to the bit."""
    root, config = neutex_experiment
    t = _trainer(config("run2", 2))
    assert isinstance(t.state.layout, ModuleLayout) and t.epoch_model is t.model
    assert t.renderer.infer_mode == "module"
    before = eager_step.launches
    t.train()
    assert eager_step.launches == before + 2 * 4
    losses = [v for tag, v, _ in t.writer.scalars if tag == "Train_Loss"]
    assert len(losses) == 2 and losses[1] < losses[0]
    assert any(tag == "Test Loss" for tag, _, _ in t.writer.scalars)
    make_model(config("x", 1)["model"], device="cpu").load_state_dict(
        load_reference_weights(os.path.join(root, "run2", "model.pt")))

    shutil.copytree(os.path.join(root, "run2"), os.path.join(root, "res"))
    resumed = _trainer(config("res", 3))
    resumed.train()
    straight = _trainer(config("straight", 3))
    straight.train()
    for a, b in ((resumed.state.params, straight.state.params),
                 (resumed.state.mu, straight.state.mu), (resumed.state.nu, straight.state.nu)):
        assert torch.equal(a, b)
    assert resumed.state.count == straight.state.count == 12


def test_trainer_refuses_fused_mlp(neutex_experiment):
    _, config = neutex_experiment
    with pytest.raises(ValueError, match="fused_mlp"):
        _trainer(config("fused", 1, fused_mlp=True))


def test_pretrain_cli_writes_a_mapping_both_packages_load(tmp_path):
    """`python -m ...pretrain_neutex_mapping` on the CPU (a few iterations
    at 512 points): chamfer and cycle fall; the .npz has the JAX package's
    keys, loads into the port's factory and into the JAX package to the
    bit."""
    from intrinsic_neural_fields_tpu_torch import pretrain_neutex_mapping

    m = icosphere(2)
    mesh_path = str(tmp_path / "m.obj")
    write_obj(mesh_path, m.vertices, m.faces)
    out = str(tmp_path / "map.npz")
    hist = pretrain_neutex_mapping.main([mesh_path, out, "--iterations", "40", "--points", "512",
                                         "--steps_per_call", "20", "--print_every", "20",
                                         "--lr", "1e-3", "--device", "cpu"])
    assert hist.shape == (40, 3) and np.isfinite(hist).all()
    assert hist[-5:, 1].mean() < hist[:5, 1].mean() and hist[-5:, 2].mean() < hist[:5, 2].mean()
    loaded = jax_load_npz(out)
    assert set(loaded) == set(MAPPING)
    assert set(loaded["net_inverse_atlasnet_3d_to_uv"]["encoder_0"]) == {
        "linear1", "linear_0", "linear_1", "last_linear"}
    tm = make_model({**CFG, "pretrained_path": out}, device="cpu")
    _, variables = _jax_wrapper()
    restored = _np(jax_load_mapping(jax.tree_util.tree_map(jnp.array, variables), out))
    want = state_dict_from_flax(restored, CFG)
    for k, v in tm.state_dict().items():
        if ".net_texture." not in k:
            assert torch.equal(v, want[k]), k
