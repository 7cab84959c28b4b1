"""The input families of the texture field through the port, each against
the JAX package on the same inputs (numpy seeds), on the CPU: the FF and
RFF encoders, pre_embed_ray_data, the forward of the xyz / ff / rff and
sine fields (plain and view-dependent), one train epoch of each path
(pre-embedded xyz and rff through the kernels' plain twins against the
JAX fused step in interpret mode; sine and encoder fields in the eager
step against the XLA step; sorted_gather read and ignored), renders, the bake, eval_on_mesh,
the HKS recipe's model, and the Trainer's pre-embedding, re-embed on
restore, profile_dir and resume.

Weights and RFF's B cross from the JAX variables through
utils/weights.state_dict_from_flax. Widths are cut (4 layers x 128, skip 2;
k for ff / rff small) so that the JAX Pallas kernels run in interpret mode
within seconds."""
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from intrinsic_neural_fields_tpu.data.sampler import RayData as JaxRayData
from intrinsic_neural_fields_tpu.data.sampler import pre_embed_ray_data as jax_pre_embed
from intrinsic_neural_fields_tpu.data.sampler import precompute_hit_features as jax_precompute
from intrinsic_neural_fields_tpu.models import init_model
from intrinsic_neural_fields_tpu.models import make_model as jax_make_model
from intrinsic_neural_fields_tpu.models.encoders import FourierFeatEnc as JaxFF
from intrinsic_neural_fields_tpu.models.encoders import RandomFourierFeatEnc as JaxRFF
from intrinsic_neural_fields_tpu.models.texture_field import (
    input_encoder_apply as jax_input_encoder_apply,
)
from intrinsic_neural_fields_tpu.models.texture_field import mlp_core_view as jax_core_view
from intrinsic_neural_fields_tpu.train.steps import create_train_state as jax_create_state
from intrinsic_neural_fields_tpu.train.steps import make_epoch_fns as jax_epoch_fns

from intrinsic_neural_fields_tpu_torch.data.sampler import (
    RayData,
    pre_embed_ray_data,
    precompute_hit_features,
)
from intrinsic_neural_fields_tpu_torch.evaluation.metrics import psnr
from intrinsic_neural_fields_tpu_torch.geometry.mesh_io import write_obj
from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
from intrinsic_neural_fields_tpu_torch.geometry.synthetic import look_at_cam, pinhole_K
from intrinsic_neural_fields_tpu_torch.models import make_model
from intrinsic_neural_fields_tpu_torch.models.encoders import FourierFeatEnc, RandomFourierFeatEnc
from intrinsic_neural_fields_tpu_torch.models.texture_field import (
    input_encoder_apply,
    mlp_core_view,
)
from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (
    fused_mlp_eligible,
    fused_pre_embed_eligible,
    kernel_launches,
)
from intrinsic_neural_fields_tpu_torch.render.renderer import Renderer
from intrinsic_neural_fields_tpu_torch.train.steps import (
    AdamHyper,
    create_train_state,
    eager_step,
    make_epoch_fns,
)
from intrinsic_neural_fields_tpu_torch.utils.jax_random import PRNGKey, rff_projection
from intrinsic_neural_fields_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(2)

LR = 1e-3
BASE = {"num_layers": 4, "mlp_hidden_dim": 128, "skip_layer_idx": 2}
# the families at cut widths: ff k=3 (21 columns), rff k=16 (35), std 4
FAMILY = {
    "xyz": {"feature_strategy": "xyz"},
    "ff": {"feature_strategy": "ff", "k": 3, "use_logspace": True},
    "ff_lin": {"feature_strategy": "ff", "k": 3, "use_logspace": False, "max_freq": 3.0},
    "rff": {"feature_strategy": "rff", "k": 16, "embed_std": 4.0},
    "efuncs": {"k": 12},
}
VIEWDEP = {"bottleneck_vec_dim": 128, "include_view_dir": True, "embed_size": 2,
           "directional_hidden_dim": 128, "in_dim_view_dir": 3, "strategy": "extrinsic"}


def _cfg(family, activation="relu", viewdep=False, **extra):
    cfg = {**BASE, **FAMILY[family], "activation": activation, **extra}
    if viewdep:
        cfg["view_dependence"] = dict(VIEWDEP)
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _models(cfg, mesh=None, seed=0):
    """The JAX model and variables, and the port model with the same
    weights (and B) carried through state_dict_from_flax."""
    from intrinsic_neural_fields_tpu.geometry.primitives import icosphere as jax_icosphere

    jmesh = mesh if mesh is not None else jax_icosphere(1)
    jmodel = jax_make_model(cfg, mesh=jmesh)
    variables = init_model(jmodel, cfg, seed=seed, mesh=jmesh)
    tmodel = make_model(cfg, device="cpu", mesh=jmesh)
    tmodel.load_state_dict(state_dict_from_flax(_np(variables), cfg))
    return jmodel, variables, tmodel


def _ulps(a, b):
    """The largest distance in f32 ulps between two f32 arrays."""
    ia, ib = (np.asarray(v, np.float32).view(np.int32).astype(np.int64) for v in (a, b))
    return int(np.abs(ia - ib).max())


def _rff_atol(x, B):
    """Two f32 ulps of the largest RFF phase: XLA contracts (2 pi x) @ B in
    its own order, the port sums the three products in order, so a phase
    may land one ulp apart (3.05e-5 at std 8, where phases reach ~300
    rad), and cos / sin move by as much."""
    arg = (2 * np.pi * np.asarray(x, np.float64)) @ np.asarray(B, np.float64)
    return 2 * float(np.spacing(np.float32(np.abs(arg).max())))


# ------------------------------------------------------------------ encoders


@pytest.mark.parametrize("logspace", [True, False])
def test_fourier_encoder_matches_jax(logspace):
    """FourierFeatEnc (log- and linspace bands): the same f32 products,
    cos and sin within 1e-7 (measured 6e-8, an ulp of 1 is 1.2e-7)."""
    x = np.random.default_rng(0).uniform(-1, 1, (2048, 3)).astype(np.float32)
    kw = dict(k=8, include_input=True, use_logspace=logspace,
              max_freq=None if logspace else 6.0)
    want = np.asarray(JaxFF(**kw).apply({}, jnp.asarray(x)))
    enc = FourierFeatEnc(**kw)
    got = enc(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2048, enc.out_dim) == (2048, 51)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got[:, -3:], x)  # [cos | sin | x]
    assert list(enc.state_dict()) == []  # the bands are constants


@pytest.mark.parametrize("std", [1.0, 8.0])
def test_random_fourier_encoder_matches_jax(std):
    """RandomFourierFeatEnc with the JAX B carried over: within two ulps of
    the largest phase (see _rff_atol); B is a persistent buffer."""
    x = np.random.default_rng(1).uniform(-1, 1, (2048, 3)).astype(np.float32)
    jenc = JaxRFF(256, std=std)
    variables = jenc.init({"buffers": jax.random.PRNGKey(3)}, jnp.asarray(x))
    B = np.asarray(variables["buffers"]["B"])
    want = np.asarray(jenc.apply(variables, jnp.asarray(x)))
    enc = RandomFourierFeatEnc(256, std=std)
    enc.load_state_dict({"B": torch.from_numpy(B.copy())})
    got = enc(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2048, 515)
    np.testing.assert_allclose(got, want, rtol=0, atol=_rff_atol(x, B))
    # drawn from the same "buffers" key, B is the JAX module's within the
    # normal draw's bound (4 ulps, utils/jax_random.normal)
    drawn = rff_projection(PRNGKey(3), 256, std)
    assert drawn.shape == (3, 256) and _ulps(drawn, B) <= 4
    assert not enc.B.requires_grad and list(enc.state_dict()) == ["B"]


# ------------------------------------------------------------------ data


def _toy_arrays(n, v, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (v, 3)).astype(np.float32),
            rng.integers(0, v, (n, 3)).astype(np.int32),
            rng.dirichlet(np.ones(3), size=n).astype(np.float32),
            rng.uniform(size=(n, 3)).astype(np.float32))


def _toy_data(strategy, n=512, v=40, seed=0):
    """The same records as a JAX RayData and a port RayData over a [V, 3]
    vertex table (strategy xyz / ff / rff), hit positions precomputed."""
    verts, vids, bary, rgbs = _toy_arrays(n, v, seed)
    jd = JaxRayData(features=jnp.asarray(verts), feature_strategy=strategy,
                    vertex_idxs_of_hit_faces=jnp.asarray(vids),
                    barycentric_coords=jnp.asarray(bary), expected_rgbs=jnp.asarray(rgbs),
                    unit_ray_dirs=None, face_idxs=None)
    td = RayData(features=torch.from_numpy(verts), feature_strategy=strategy,
                 vertex_idxs_of_hit_faces=torch.from_numpy(vids).long(),
                 barycentric_coords=torch.from_numpy(bary), expected_rgbs=torch.from_numpy(rgbs))
    return jax_precompute(jd), precompute_hit_features(td)


def _efuncs_data(n, v, seed, k=12):
    """JAX and port RayData over a random [V, k] eigenfunction table, hit
    features precomputed in f32."""
    _, vids, bary, rgbs = _toy_arrays(n, v, seed)
    feats = np.random.default_rng(seed + 100).normal(size=(v, k)).astype(np.float32)
    jd = JaxRayData(jnp.asarray(feats), "efuncs", jnp.asarray(vids), jnp.asarray(bary),
                    jnp.asarray(rgbs), None, None)
    td = RayData(torch.from_numpy(feats), "efuncs", torch.from_numpy(vids).long(),
                 torch.from_numpy(bary), torch.from_numpy(rgbs))
    return jax_precompute(jd), precompute_hit_features(td)


@pytest.mark.parametrize("family", ["xyz", "ff", "rff"])
def test_pre_embed_rows_match_jax(family):
    """pre_embed_ray_data: the embedded rows against the JAX function's
    (JAX interpolates in its jitted chunk, the port in eager torch: a hit
    position may differ by an ulp, ~6e-8, which the encoding multiplies by
    up to its largest frequency; xyz within 2e-7, ff within 1e-5 (bands
    to 4 pi), rff within 1e-4 (|2 pi B| to ~70, plus the phase ulps)). The
    split reports "efuncs" and a [1, emb_dim] placeholder table; bf16
    storage rounds the f32 rows once."""
    cfg = _cfg(family)
    jmodel, variables, tmodel = _models(cfg)
    jd, td = _toy_data(family, n=300)
    want = jax_pre_embed(jax_input_encoder_apply(jmodel, variables), jd, chunk=128)
    got = pre_embed_ray_data(input_encoder_apply(tmodel), td, chunk=128)
    atol = {"xyz": 2e-7, "ff": 1e-5, "rff": 1e-4}[family]
    np.testing.assert_allclose(got.hit_features.numpy(), np.asarray(want.hit_features),
                               rtol=0, atol=atol)
    assert got.feature_strategy == want.feature_strategy == "efuncs"
    assert tuple(got.features.shape) == tuple(want.features.shape) == (1, tmodel.in_dim)
    b16 = pre_embed_ray_data(input_encoder_apply(tmodel), td, chunk=128, dtype=torch.bfloat16)
    assert torch.equal(b16.hit_features, got.hit_features.to(torch.bfloat16))


def test_family_ray_data_uses_the_vertex_table(tmp_path):
    """create_ray_data of an xyz / ff / rff split: the mesh's f32 vertices
    as the table, the same load-time permutation as an efuncs split, and
    the hit positions precomputed; the split's batches carry "xyz"."""
    from intrinsic_neural_fields_tpu_torch.data.sampler import create_ray_data, gather_batch
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh

    mesh = icosphere(1)
    write_obj(str(tmp_path / "m.obj"), mesh.vertices, mesh.faces)
    _, vids, bary, rgbs = _toy_arrays(200, mesh.num_vertices, 5)
    for name, a in (("vids_of_hit_faces", vids), ("barycentric_coords", bary),
                    ("expected_rgbs", rgbs)):
        np.save(str(tmp_path / f"{name}.npy"), a)
    d = create_ray_data(str(tmp_path), None, None, "rff", mesh=load_mesh(str(tmp_path / "m.obj")),
                        seed=4, device="cpu")
    np.testing.assert_array_equal(d.features.numpy(), mesh.vertices.astype(np.float32))
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(4), 200))
    np.testing.assert_array_equal(d.expected_rgbs.numpy(), rgbs[perm])
    assert d.hit_features.shape == (200, 3)
    batch = gather_batch(d, torch.arange(5))
    assert set(batch) == {"expected_rgbs", "xyz"}
    with pytest.raises(ValueError, match="needs the mesh"):
        create_ray_data(str(tmp_path), None, None, "xyz", device="cpu")


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("family,activation,viewdep", [
    ("xyz", "relu", False), ("ff", "relu", False), ("ff_lin", "relu", False),
    ("rff", "relu", False), ("xyz", "sine", False), ("rff", "sine", False),
    ("efuncs", "sine", False),
    ("xyz", "relu", True), ("ff", "relu", True), ("rff", "relu", True),
    ("xyz", "sine", True), ("efuncs", "sine", True),
])
def test_forward_matches_jax(family, activation, viewdep):
    """The port module's f32 forward against model.apply on the same
    weights and inputs (RFF's B carried through state_dict_from_flax):
    within 1e-5 (f32 sums in another order; rff phases within _rff_atol);
    an encoder family's mlp_core_view on the pre-embedded rows gives the
    module's output, and eligibility follows the JAX predicates."""
    cfg = _cfg(family, activation, viewdep)
    jmodel, variables, tmodel = _models(cfg)
    rng = np.random.default_rng(2)
    n = 257
    x = (rng.uniform(-1, 1, (n, 3)) if family != "efuncs"
         else rng.normal(size=(n, 12))).astype(np.float32)
    key = "eigenfunctions" if family == "efuncs" else "xyz"
    batch = {key: jnp.asarray(x)}
    args = [torch.from_numpy(x)]
    if viewdep:
        dirs = rng.normal(size=(n, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        faces = rng.integers(0, 20, n).astype(np.int32)
        batch.update(unit_ray_dirs=jnp.asarray(dirs), hit_face_idxs=jnp.asarray(faces))
        args += [torch.from_numpy(dirs), torch.from_numpy(faces).long()]
    want = np.asarray(jmodel.apply(variables, batch))
    with torch.no_grad():
        got = tmodel(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if family in ("xyz", "ff", "ff_lin", "rff") and not viewdep:
        with torch.no_grad():
            core = mlp_core_view(tmodel)(input_encoder_apply(tmodel)(args[0])).numpy()
        np.testing.assert_array_equal(core, got)
        assert fused_pre_embed_eligible(tmodel) == (activation == "relu")
    assert fused_mlp_eligible(tmodel) == (family == "efuncs" and not viewdep
                                          and activation == "relu")


def test_state_dict_carries_the_rff_projection():
    """buffers/RandomFourierFeatEnc_0/B -> embedding.B, under spatial_mlp.
    for a view-dependent field; make_model draws B from seed + 1."""
    for viewdep, key in ((False, "embedding.B"), (True, "spatial_mlp.embedding.B")):
        cfg = _cfg("rff", viewdep=viewdep)
        _, variables, tmodel = _models(cfg)
        scope = variables["buffers"]["spatial_mlp"] if viewdep else variables["buffers"]
        np.testing.assert_array_equal(tmodel.state_dict()[key].numpy(),
                                      np.asarray(scope["RandomFourierFeatEnc_0"]["B"]))
    a, b = make_model(_cfg("rff"), seed=3, device="cpu"), make_model(_cfg("rff"), seed=3,
                                                                     device="cpu")
    assert torch.equal(a.embedding.B, b.embedding.B)
    _, seeded, _ = _models(_cfg("rff"), seed=3)  # B from PRNGKey(seed + 1), as in JAX
    assert _ulps(a.embedding.B.numpy(),
                 np.asarray(seeded["buffers"]["RandomFourierFeatEnc_0"]["B"])) <= 4
    # an RFF field with BatchNorm builds (B and the statistics both carried)
    # and trains through the eager step as the JAX XLA epoch does: loss 1e-5
    cfg = {**_cfg("rff"), "batchnorm": True}
    jmodel, variables, tmodel = _models(cfg)
    jd, td = _toy_data("rff")
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    key = jax.random.PRNGKey(1)
    jst, jm = jax_epoch_fns(jmodel, opt, "L1")[0](
        jax_create_state(jax.tree_util.tree_map(jnp.array, variables), opt), key, jd, 2, 256)
    st, m = make_epoch_fns(tmodel, "L1")[0](create_train_state(tmodel, AdamHyper(LR), "cpu"),
                                            np.asarray(jax.random.permutation(key, 512)), td,
                                            2, 256)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert "embedding.B" in st.buffers and "layers.0.2.running_mean" in st.batch_stats


# ------------------------------------------------------------------ epochs


def _jax_state(variables, opt, with_buffers=True):
    v = jax.tree_util.tree_map(jnp.array, variables)
    if not with_buffers:
        v = {"params": v["params"]}
    return jax_create_state(v, opt)


def _max_param_diff(port_state, jax_params, cfg):
    want = state_dict_from_flax(_np(jax_params), cfg)
    got = port_state.state_dict()
    return max(float(np.abs(got[k].numpy() - want[k].numpy()).max()) for k in want)


@pytest.mark.parametrize("family", ["xyz", "rff"])
def test_pre_embedded_fused_epoch_matches_jax(family):
    """One blocks epoch (4 blocks of 128) of the pre-embedded field through
    the kernels' path (plain twins, Adam in the step) against the JAX
    fused step with in-kernel Adam (interpret mode) on its own pre-embedded
    rows, the JAX block order replayed. Held to the JAX package's tracking
    bounds for its fused paths (tests/test_fused_adam.py): loss rtol 2e-3,
    params atol 2.5e-3."""
    cfg = _cfg(family)
    jmodel, variables, tmodel = _models(cfg, seed=1)
    jd, td = _toy_data(family, n=512, seed=3)
    jemb = jax_pre_embed(jax_input_encoder_apply(jmodel, variables), jd)
    temb = pre_embed_ray_data(input_encoder_apply(tmodel), td)
    assert temb.hit_features.dtype == torch.float32  # no precompute_dtype: f32 rows
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    j_epoch, _ = jax_epoch_fns(jax_core_view(jmodel), opt, "L1", shuffle="blocks", fused=True,
                               fused_adam=True)
    key = jax.random.PRNGKey(5)
    jst, jm = j_epoch(_jax_state(variables, opt, with_buffers=False), key, jemb, 4, 128)

    t_epoch, _ = make_epoch_fns(mlp_core_view(tmodel), "L1", shuffle="blocks", fused=True)
    st = create_train_state(tmodel, AdamHyper(LR), "cpu")
    before = eager_step.launches
    st, m = t_epoch(st, np.asarray(jax.random.permutation(key, 4)), temb, 4, 128)
    assert eager_step.launches == before
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-3)
    assert _max_param_diff(st, jst.params, cfg) <= 2.5e-3
    assert st.count == 4
    if family == "rff":  # the buffer rides along untouched
        assert torch.equal(st.buffers["embedding.B"], tmodel.embedding.B)


@pytest.mark.parametrize("family,activation,viewdep", [
    ("rff", "sine", False), ("xyz", "relu", False), ("ff", "relu", False),
    ("efuncs", "sine", False), ("xyz", "relu", True),
])
def test_eager_epoch_matches_jax_xla_step(family, activation, viewdep):
    """Full shuffle with a ragged tail (1000 records, batch 256): the
    eager f32 step (the model's own encoding of each batch's positions,
    sin for a sine field) against the JAX XLA step on JAX's permutation:
    loss rtol 1e-5, params atol 1e-5 (f32 on both sides, another summation
    order)."""
    cfg = _cfg(family, activation, viewdep)
    jmodel, variables, tmodel = _models(cfg, seed=2)
    if family == "efuncs":
        jd, td = _efuncs_data(1000, 120, 7)
    else:
        jd, td = _toy_data(family, n=1000, v=120, seed=4)
    if viewdep:
        rng = np.random.default_rng(8)
        dirs = rng.normal(size=(1000, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        faces = rng.integers(0, 20, 1000).astype(np.int32)
        jd.unit_ray_dirs, jd.face_idxs = jnp.asarray(dirs), jnp.asarray(faces)
        td.unit_ray_dirs, td.face_idxs = torch.from_numpy(dirs), torch.from_numpy(faces).long()
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    j_epoch, _ = jax_epoch_fns(jmodel, opt, "L2", shuffle="full", fused=False)
    key = jax.random.PRNGKey(6)
    jst, jm = j_epoch(_jax_state(variables, opt), key, jd, 4, 256)
    t_epoch, _ = make_epoch_fns(tmodel, "L2", shuffle="full")
    st = create_train_state(tmodel, AdamHyper(LR), "cpu")
    before = eager_step.launches
    st, m = t_epoch(st, np.asarray(jax.random.permutation(key, 1000)), td, 4, 256)
    assert eager_step.launches == before + 4
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert _max_param_diff(st, jst.params, cfg) <= 1e-5


def test_fused_refuses_a_field_the_kernels_do_not_compute():
    """training.fused_mlp on a sine field or an encoder field that was not
    pre-embedded raises, as the JAX package's make_epoch_fns asserts."""
    for cfg in (_cfg("efuncs", "sine"), _cfg("rff")):
        with pytest.raises(ValueError, match="fused_mlp needs"):
            make_epoch_fns(make_model(cfg, device="cpu"), "L1", fused=True)


@pytest.mark.parametrize("fused", [False, True])
def test_sorted_gather_is_ignored_and_matches_jax(fused):
    """training.sorted_gather is read and ignored: on the JAX side it only
    reorders each full-shuffle batch's rows, so the port's unsorted epochs
    equal the JAX sorted_gather epochs up to the f32 summation order. Two
    epochs on JAX's permutations: the eager path with a ragged tail (1000
    records) against the JAX XLA step, loss rtol 1e-5 and params atol 1e-5
    (f32 on both sides), or the kernels' gathered path on full batches
    against the JAX fused step (interpret mode), held to the JAX package's
    tracking bounds for its fused paths: loss rtol 2e-3, params atol
    2.5e-3."""
    cfg = _cfg("efuncs")
    jmodel, variables, tmodel = _models(cfg, seed=3)
    n = 1024 if fused else 1000
    jd, td = _efuncs_data(n, 120, 9)
    keys = [jax.random.PRNGKey(10 + e) for e in range(2)]
    t_epoch, _ = make_epoch_fns(tmodel, "L1", shuffle="full", fused=fused)
    st = create_train_state(tmodel, AdamHyper(LR), "cpu")
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    j_epoch, _ = jax_epoch_fns(jmodel, opt, "L1", shuffle="full", fused=fused,
                               sorted_gather=True)
    jst = _jax_state(variables, opt)
    rtol, atol = (2e-3, 2.5e-3) if fused else (1e-5, 1e-5)
    for k in keys:
        st, m = t_epoch(st, np.asarray(jax.random.permutation(k, n)), td, 4, 256)
        jst, jm = j_epoch(jst, k, jd, 4, 256)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=rtol)
    assert _max_param_diff(st, jst.params, cfg) <= atol


# ------------------------------------------------------------------ render, bake


def _blob_and_views(H=40, W=40):
    from intrinsic_neural_fields_tpu.geometry.primitives import icosphere as jax_icosphere

    cams = [look_at_cam(np.array(e)) for e in ((0.4, -2.8, 0.7), (2.5, 0.5, -0.4))]
    return jax_icosphere(3), icosphere(3), cams, pinhole_K(H, W)


@pytest.mark.parametrize("family,activation,viewdep", [
    ("xyz", "relu", False), ("rff", "relu", False), ("ff", "relu", False),
    ("xyz", "relu", True), ("rff", "relu", True), ("rff", "sine", False),
])
def test_render_matches_jax(family, activation, viewdep):
    """The port's Renderer (the kernel's plain twin on the encoded chunk;
    the module's f32 forward for a sine field) against the JAX Renderer
    (its fused kernel in interpret mode on the pre-embedded chunk; its XLA
    path for the sine field and for a view-dependent rff field, which the
    JAX renderer does not pre-embed while the port does) on the same mesh,
    weights and views: the valid
    masks equal, background pixels equal, colours within 2e-3 (bf16-operand
    matmuls in another order, f16 on both wires; the sine field: f32 on
    both sides) and PSNR >= 60 dB over the hits."""
    from intrinsic_neural_fields_tpu.render.renderer import Renderer as JaxRenderer

    H = W = 40
    jmesh, mesh, cams, K = _blob_and_views(H, W)
    cfg = _cfg(family, activation, viewdep)
    jmodel, variables, tmodel = _models(cfg, mesh=jmesh, seed=4)
    strategy = cfg["feature_strategy"]
    jax_fused = activation == "relu" and not (family == "rff" and viewdep)
    jr = JaxRenderer(jmodel, variables, jmesh, feature_strategy=strategy, H=H, W=W,
                     infer="fused" if jax_fused else "xla")
    pr = Renderer(tmodel, mesh, None, H=H, W=W, device="cpu")
    assert pr.infer_mode == ("plain" if activation == "relu" else "module")
    before = kernel_launches()
    for cam in cams:
        img_ref, hit_ref = jr.render(cam, K, eval_render=True)
        img, hit = pr.render(cam, K, eval_render=True)
        np.testing.assert_array_equal(np.sort(hit), np.sort(hit_ref))
        mask = np.zeros(H * W, bool)
        mask[hit_ref] = True
        assert mask.any() and (~mask).any()
        np.testing.assert_array_equal(img.reshape(-1, 3)[~mask], img_ref.reshape(-1, 3)[~mask])
        np.testing.assert_allclose(img, img_ref, rtol=0, atol=2e-3)
        assert psnr(img, img_ref, mask) >= 60.0
    assert kernel_launches() == before  # CPU tensors: the plain twins, never a launch


@pytest.mark.parametrize("infer", ["kernel", "plain"])
def test_explicit_infer_refuses_a_field_the_kernels_do_not_compute(infer, tmp_path):
    """A sine field runs its module's forward only when infer is left
    unset; asking for the kernel (on a CUDA device: the check comes before
    anything touches the card) or its plain twin raises, as the JAX
    renderer's infer="fused" asserts: in FieldInfer and, for "plain", in
    the Renderer and the bake that call it."""
    from intrinsic_neural_fields_tpu_torch.bake.bake import _field_rgbs
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh
    from intrinsic_neural_fields_tpu_torch.ops.field_infer import FieldInfer

    cfg = _cfg("xyz", "sine")
    _, variables, tmodel = _models(cfg, seed=4)
    dev = torch.device("cuda" if infer == "kernel" else "cpu")
    with pytest.raises(ValueError, match="do not compute this field"):
        FieldInfer(tmodel, dev, infer)
    assert FieldInfer(tmodel, torch.device("cpu")).mode == "module"
    if infer == "kernel":
        return
    m = icosphere(1)
    with pytest.raises(ValueError, match="do not compute this field"):
        Renderer(tmodel, m, None, H=8, W=8, device="cpu", infer=infer)
    mesh_path = str(tmp_path / "m.obj")
    write_obj(mesh_path, m.vertices, m.faces)
    config, _ = _trained_out_dir(str(tmp_path), cfg, variables, mesh_path)
    with pytest.raises(ValueError, match="do not compute this field"):
        _field_rgbs(load_mesh(mesh_path), config, m.faces[:4], np.full((4, 3), 1 / 3),
                    device="cpu", infer=infer)


def _trained_out_dir(root, cfg, variables, mesh_path, extra_data=None):
    """An out_dir holding the same weights as the JAX model.ckpt and the
    port's reference-layout model.pt, and its config."""
    from intrinsic_neural_fields_tpu.utils.checkpoint import save_checkpoint

    out_dir = os.path.join(root, "run")
    os.makedirs(out_dir, exist_ok=True)
    save_checkpoint(os.path.join(out_dir, "model.ckpt"), jax.device_get(variables))
    torch.save(state_dict_from_flax(_np(variables), cfg), os.path.join(out_dir, "model.pt"))
    config = {"seed": 0, "data": {"mesh_path": mesh_path, "img_height": 32, "img_width": 32,
                                  **(extra_data or {})},
              "model": cfg, "training": {"out_dir": out_dir}}
    path = os.path.join(root, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return config, path


@pytest.mark.parametrize("family,activation", [("xyz", "relu"), ("rff", "relu"),
                                               ("ff", "sine")])
def test_bake_field_rgbs_matches_jax(family, activation, tmp_path):
    """The bake's field evaluation at surface points (ragged 8,192-point
    chunks) against the JAX bake's _field_rgbs (f32 model.apply): through
    the kernel's plain twin within 4e-3, mean 5e-4 (its bf16 operands
    round each of rff's 35 input columns by up to 2^-9 relative: measured
    2.1e-3 at worst), through a sine field's module forward within 1e-5."""
    from intrinsic_neural_fields_tpu.bake import bake as jax_bake
    from intrinsic_neural_fields_tpu.geometry.mesh import load_mesh as jax_load_mesh

    from intrinsic_neural_fields_tpu_torch.bake.bake import _field_rgbs
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh

    m = icosphere(2)
    mesh_path = str(tmp_path / "m.obj")
    write_obj(mesh_path, m.vertices, m.faces)
    cfg = _cfg(family, activation)
    jmodel, variables, _ = _models(cfg, seed=5)
    config, _ = _trained_out_dir(str(tmp_path), cfg, variables, mesh_path)
    rng = np.random.default_rng(3)
    n = 8192 + 777
    vids = m.faces[rng.integers(0, m.num_faces, n)]
    bary = rng.dirichlet(np.ones(3), size=n)
    got = _field_rgbs(load_mesh(mesh_path), config, vids, bary, device="cpu")
    want = jax_bake._field_rgbs(jax_load_mesh(mesh_path), config, vids, bary)
    if activation == "relu":
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-3)
        assert np.abs(got - want).mean() <= 5e-4
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_eval_on_mesh_matches_the_jax_tool(tmp_path, monkeypatch):
    """`python -m ...eval_on_mesh` against tools/eval_on_mesh.py on the same
    files: an xyz field on a twisted copy of the source mesh (its
    positions moved) and an intrinsic field with the target's own basis
    (the direct swap), each scored on the source dataset's test views:
    per-view PSNR within 0.1 dB and DSSIM x100 within 0.05 (the port's
    plain twin rounds operands to bf16, the JAX CPU renderer is f32)."""
    import pickle

    from intrinsic_neural_fields_tpu_torch import eval_on_mesh
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh
    from intrinsic_neural_fields_tpu_torch.geometry.synthetic import make_dataset
    from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import (
        compute_first_k_eigenfunctions)

    root = str(tmp_path)
    data = os.path.join(root, "data")
    make_dataset(data, H=32, W=32, n_train=2, subdivisions=2)
    src = load_mesh(os.path.join(data, "blob.obj"))
    v = src.vertices.copy()
    ang = 0.6 * v[:, 2]
    v[:, 0], v[:, 1] = (np.cos(ang) * src.vertices[:, 0] - np.sin(ang) * src.vertices[:, 1],
                        np.sin(ang) * src.vertices[:, 0] + np.cos(ang) * src.vertices[:, 1])
    target = os.path.join(root, "twisted.obj")
    write_obj(target, v, src.faces)
    basis = os.path.join(root, "efuncs_skip_target.npy")
    np.save(basis, compute_first_k_eigenfunctions(load_mesh(target), 8).astype(np.float32))
    np.save(os.path.join(root, "efuncs_src.npy"),
            compute_first_k_eigenfunctions(src, 8).astype(np.float32))

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
    import eval_on_mesh as jax_tool

    for name, cfg, efuncs in (("xyz", {**BASE, "feature_strategy": "xyz"}, None),
                              ("swap", {**BASE, "k": 8}, basis)):
        run = os.path.join(root, name)
        os.makedirs(run)
        jmodel, variables, _ = _models(cfg, seed=6)
        extra = {} if efuncs is None else {"eigenfunctions_path":
                                           os.path.join(root, "efuncs_src.npy")}
        _, cfg_path = _trained_out_dir(run, cfg, variables, os.path.join(data, "blob.obj"), extra)
        argv = ["--config_path", cfg_path, "--target_mesh", target, "--eval_dataset", data,
                "--eval_split", "test"] + ([] if efuncs is None else ["--efuncs", efuncs])
        eval_on_mesh.main(argv + ["--out_dir", os.path.join(run, "port"), "--device", "cpu"])
        monkeypatch.setattr(sys, "argv", ["eval_on_mesh.py", *argv, "--out_dir",
                                          os.path.join(run, "jax")])
        jax_tool.main()
        got, want = [pickle.load(open(os.path.join(run, side, "evaluation_metrics.pkl"), "rb"))
                     for side in ("port", "jax")]
        assert sorted(got) == sorted(want) and len(got) > 0
        for view in want:
            assert got[view]["psnr"] == pytest.approx(want[view]["psnr"], abs=0.1)
            assert got[view]["dssim_rescaled"] == pytest.approx(want[view]["dssim_rescaled"],
                                                                abs=0.05)
    with pytest.raises(ValueError, match="--efuncs required"):
        eval_on_mesh.main(["--config_path", os.path.join(root, "swap", "config.yaml"),
                           "--target_mesh", target, "--eval_dataset", data, "--out_dir",
                           os.path.join(root, "none"), "--device", "cpu"])


# ------------------------------------------------------------------ HKS


@pytest.mark.parametrize("embed", ["hks", "gps"])
def test_hks_recipe_epoch_and_render_match_jax(tmp_path, embed):
    """configs/synthetic/hks_blob.yaml's model (HKS features of 128
    timesteps from the eigenfunctions, no fused_mlp: the eager step) cut
    to 4 layers and 16 eigenfunctions, and the same with GPS features (16
    columns): the features against the JAX package's (rtol 1e-6), a blocks
    epoch against the JAX XLA step on its block order (loss rtol 1e-5,
    params atol 1e-5, f32 on both sides) and a render against the JAX XLA
    renderer (equal masks, colours within 2e-3: the port's plain twin
    rounds operands to bf16)."""
    from intrinsic_neural_fields_tpu.render.renderer import Renderer as JaxRenderer
    from intrinsic_neural_fields_tpu.spectral.features import (
        load_first_k_eigenfunctions as jax_load)

    from intrinsic_neural_fields_tpu_torch.spectral.features import load_first_k_eigenfunctions

    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "configs/synthetic/hks_blob.yaml")) as f:
        recipe = yaml.safe_load(f)
    assert recipe["data"]["embed_strategy"] == "hks" and "fused_mlp" not in recipe["training"]
    jmesh, mesh, cams, K = _blob_and_views()
    rng = np.random.default_rng(11)
    V = mesh.num_vertices
    ef_path, ev_path = str(tmp_path / "ef.npy"), str(tmp_path / "ev.npy")
    np.save(ef_path, rng.normal(size=(V, 16)).astype(np.float32))
    np.save(ev_path, np.sort(rng.uniform(0.5, 40.0, 16)).astype(np.float32))
    kw = dict(rescale_strategy="standard", embed_strategy=embed, eigenvalues_path=ev_path,
              ts=recipe["model"]["hks_timesteps"])
    E = load_first_k_eigenfunctions(ef_path, 16, **kw)
    np.testing.assert_allclose(E, jax_load(ef_path, 16, **kw), rtol=1e-6, atol=1e-7)
    cfg = {**BASE, "k": 16}
    if embed == "hks":
        cfg["hks_timesteps"] = recipe["model"]["hks_timesteps"]
    jmodel, variables, tmodel = _models(cfg, mesh=jmesh, seed=7)
    assert tmodel.in_dim == (128 if embed == "hks" else 16) == E.shape[1]

    _, vids, bary, rgbs = _toy_arrays(1024, V, 12)
    jd = jax_precompute(JaxRayData(jnp.asarray(E), "efuncs", jnp.asarray(vids),
                                   jnp.asarray(bary), jnp.asarray(rgbs), None, None))
    td = precompute_hit_features(RayData(torch.from_numpy(np.asarray(E, np.float32)), "efuncs",
                                         torch.from_numpy(vids).long(),
                                         torch.from_numpy(bary), torch.from_numpy(rgbs)))
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=recipe["training"]["lr"])
    j_epoch, _ = jax_epoch_fns(jmodel, opt, "L1", shuffle="blocks")
    key = jax.random.PRNGKey(13)
    jst, jm = j_epoch(_jax_state(variables, opt), key, jd, 4, 256)
    t_epoch, _ = make_epoch_fns(tmodel, "L1", shuffle="blocks")
    st = create_train_state(tmodel, AdamHyper(recipe["training"]["lr"]), "cpu")
    before = eager_step.launches
    st, m = t_epoch(st, np.asarray(jax.random.permutation(key, 4)), td, 4, 256)
    assert eager_step.launches == before + 4
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert _max_param_diff(st, jst.params, cfg) <= 1e-5

    jr = JaxRenderer(jmodel, variables, jmesh, eigenfunctions=np.asarray(E), H=40, W=40,
                     infer="xla")
    pr = Renderer(tmodel, mesh, E, H=40, W=40, device="cpu")
    img_ref, hit_ref = jr.render(cams[0], K, eval_render=True)
    img, hit = pr.render(cams[0], K, eval_render=True)
    np.testing.assert_array_equal(np.sort(hit), np.sort(hit_ref))
    np.testing.assert_allclose(img, img_ref, rtol=0, atol=2e-3)


# ------------------------------------------------------------------ Trainer


class Recorder:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, global_step=None):
        self.scalars.append((tag, float(value), global_step))

    def add_image(self, tag, img, global_step=None):
        pass


@pytest.fixture(scope="module")
def family_experiment(tmp_path_factory):
    """A tiny experiment on disk for the families: an icosphere mesh and
    train / val / test ray caches over its vertices; returns a config
    factory (fused_mlp, blocks, f32 embedded tables as the YAMLs imply)."""
    root = str(tmp_path_factory.mktemp("families"))
    mesh = icosphere(1)
    write_obj(os.path.join(root, "m.obj"), mesh.vertices, mesh.faces)
    for split, n, seed in (("train", 1024, 21), ("val", 300, 22), ("test", 200, 23)):
        _, vids, bary, rgbs = _toy_arrays(n, mesh.num_vertices, seed)
        d = os.path.join(root, split)
        os.makedirs(d)
        np.save(os.path.join(d, "vids_of_hit_faces.npy"), vids)
        np.save(os.path.join(d, "barycentric_coords.npy"), bary)
        np.save(os.path.join(d, "expected_rgbs.npy"), rgbs)

    def config(out_name, family, epochs, **training):
        return {
            "seed": 1,
            "data": {"preproc_data_path_train": os.path.join(root, "train"),
                     "preproc_data_path_eval": os.path.join(root, "val"),
                     "preproc_data_path_test": os.path.join(root, "test"),
                     "mesh_path": os.path.join(root, "m.obj"),
                     "img_height": 16, "img_width": 16},
            "model": _cfg(family),
            "training": {"out_dir": os.path.join(root, out_name), "batch_size": 256, "lr": LR,
                         "loss_type": "L1", "render_every": 100, "print_every": 1,
                         "epochs": epochs, "checkpoint_every": 1, "shuffle": "blocks",
                         "fused_mlp": True, **training},
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


@pytest.mark.parametrize("family", ["xyz", "rff"])
def test_trainer_pre_embeds_and_resumes_bit_exactly(family_experiment, family):
    """The Trainer on an xyz / rff recipe with fused_mlp: every split is
    embedded (f32, at the model's width) and the epochs take the kernels'
    path (plain twins here; the eager step never); losses fall; model.pt
    and checkpoint.pt carry embedding.B; a run resumed from checkpoint.pt
    equals the uninterrupted run to the bit."""
    from intrinsic_neural_fields_tpu_torch.utils.weights import load_reference_weights

    root, config = family_experiment
    t = _trainer(config(f"{family}_run2", family, 2))
    for d in (t.train_data, t.val_data, t.test_data):
        assert d.feature_strategy == "efuncs" and d.hit_features.shape[1] == t.model.in_dim
        assert d.hit_features.dtype == torch.float32
    assert t.epoch_model is not t.model and t.fused_mlp
    before = eager_step.launches
    t.train()
    assert eager_step.launches == before
    losses = [v for tag, v, _ in t.writer.scalars if tag == "Train_Loss"]
    assert len(losses) == 2 and losses[1] < losses[0]
    sd = load_reference_weights(os.path.join(root, f"{family}_run2", "model.pt"))
    if family == "rff":
        assert torch.equal(sd["embedding.B"], t.model.embedding.B)
        ck = torch.load(os.path.join(root, f"{family}_run2", "checkpoint.pt"), weights_only=True)
        assert torch.equal(ck["model_state_dict"]["embedding.B"], t.model.embedding.B)
    make_model(_cfg(family), device="cpu").load_state_dict(sd)

    shutil.copytree(os.path.join(root, f"{family}_run2"), os.path.join(root, f"{family}_res"))
    resumed = _trainer(config(f"{family}_res", family, 3))
    resumed.train()
    straight = _trainer(config(f"{family}_straight", family, 3))
    straight.train()
    for a, b in ((resumed.state.params, straight.state.params),
                 (resumed.state.mu, straight.state.mu), (resumed.state.nu, straight.state.nu)):
        assert torch.equal(a, b)
    assert resumed.state.count == straight.state.count == 12


def test_trainer_re_embeds_after_restoring_another_projection(family_experiment, capsys):
    """A checkpoint.pt whose embedding.B differs from the one the splits
    were embedded with (a reference-trained run brings its own): the
    Trainer takes the restored B into its model and embeds every split
    again, so the rows equal a fresh embedding with that B, as the JAX
    Trainer does."""
    from intrinsic_neural_fields_tpu_torch.utils.checkpoint import save_train_checkpoint

    root, config = family_experiment
    cfg = config("rff_swap", "rff", 2)
    t = _trainer(cfg)
    other = make_model(_cfg("rff"), seed=9, device="cpu")
    assert not torch.equal(other.embedding.B, t.model.embedding.B)
    st = create_train_state(other, AdamHyper(LR), "cpu")
    save_train_checkpoint(os.path.join(cfg["training"]["out_dir"], "checkpoint.pt"), 0, st)
    stale = t.train_data.hit_features.clone()
    t.train()
    assert "re-embedding splits" in capsys.readouterr().out
    assert torch.equal(t.model.embedding.B, other.embedding.B)
    assert torch.equal(t.state.buffers["embedding.B"], other.embedding.B)
    fresh = pre_embed_ray_data(input_encoder_apply(other), t._raw_splits[0])
    assert torch.equal(t.train_data.hit_features, fresh.hit_features)
    assert not torch.equal(stale, fresh.hit_features)


def test_trainer_keeps_the_in_forward_path_over_budget(family_experiment, monkeypatch, capsys):
    """When all splits' embedded tables would exceed the precompute budget
    the Trainer says so and trains the model itself in the eager step."""
    import intrinsic_neural_fields_tpu_torch.train.trainer as trainer_mod

    root, config = family_experiment
    monkeypatch.setattr(trainer_mod, "PRECOMPUTE_BYTES_LIMIT", 1000)
    t = _trainer(config("rff_budget", "rff", 1))
    assert "exceed the precompute budget" in capsys.readouterr().out
    assert not t.fused_mlp and t.epoch_model is t.model
    assert t.train_data.feature_strategy == "rff"
    before = eager_step.launches
    t.train()
    assert eager_step.launches == before + 4


def test_trainer_profile_dir_writes_a_trace(family_experiment):
    """training.profile_dir: a torch.profiler trace of profile_epoch is
    written there (a Chrome trace JSON with events), the run goes on."""
    import json

    root, config = family_experiment
    prof = os.path.join(root, "prof")
    t = _trainer(config("xyz_prof", "xyz", 2, profile_dir=prof, profile_epoch=1,
                        sorted_gather=True))
    t.train()
    assert os.listdir(prof) == ["epoch_0001.pt.trace.json"]
    with open(os.path.join(prof, "epoch_0001.pt.trace.json")) as f:
        assert len(json.load(f)["traceEvents"]) > 0
