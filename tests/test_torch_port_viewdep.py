"""Port parity of the view-dependent texture field against the JAX package
on the CPU: the Fourier encoding and view encoder, the module and its
weight carry, the layout, the forward kernel's plain twin against
make_fused_apply_viewdep (Pallas in interpret mode), a render against the
JAX Renderer(infer="fused"), and the mesh-transform normal refresh.

Inputs come from numpy seeds and cross between the frameworks as numpy.
Sizes follow tests/test_fused_viewdep.py: 4 layers x 128, k=32, B=512,
icosphere(2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsic_neural_fields_tpu.geometry.primitives import icosphere as jax_icosphere
from intrinsic_neural_fields_tpu.models import init_model
from intrinsic_neural_fields_tpu.models import make_model as jax_make_model
from intrinsic_neural_fields_tpu.models.encoders import FourierFeatEnc
from intrinsic_neural_fields_tpu.models.texture_field import (
    view_encoder_apply as jax_view_encoder_apply,
)
from intrinsic_neural_fields_tpu.ops.fused_mlp import FusedMLPSpec as JaxSpec
from intrinsic_neural_fields_tpu.ops.fused_mlp import ViewDepTailSpec as JaxTail
from intrinsic_neural_fields_tpu.ops.fused_mlp import (
    make_fused_apply_viewdep,
    viewdep_params_to_list,
)
from intrinsic_neural_fields_tpu.render.renderer import Renderer as JaxRenderer

from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
from intrinsic_neural_fields_tpu_torch.models import (
    TextureFieldWithViewDependency,
    make_model,
    view_encoder_apply,
)
from intrinsic_neural_fields_tpu_torch.models.encoders import fourier_feat_enc
from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (
    ViewDepTailSpec,
    fused_apply_viewdep,
    fused_apply_viewdep_plain,
    kernel_launches,
    layout_for_model,
)
from intrinsic_neural_fields_tpu_torch.render.renderer import Renderer
from intrinsic_neural_fields_tpu_torch.utils.weights import state_dict_from_flax

from tests.test_render_regressions import _look_at_cam, _simple_K

torch.set_num_threads(2)

K, B = 32, 512
STRATEGIES = [("intrinsic", 1), ("extrinsic", 3)]


def _cfg(strategy, in_dim, k=K, skip=1):
    return {"k": k, "num_layers": 4, "mlp_hidden_dim": 128, "skip_layer_idx": skip,
            "view_dependence": {"bottleneck_vec_dim": 128, "include_view_dir": True,
                                "embed_size": 4, "directional_hidden_dim": 128,
                                "in_dim_view_dir": in_dim, "strategy": strategy}}


def _models(strategy, in_dim, seed=0):
    """The JAX model + variables and the port model carrying its weights."""
    cfg = _cfg(strategy, in_dim)
    jmodel = jax_make_model(cfg, mesh=jax_icosphere(2))
    variables = init_model(jmodel, cfg, seed=seed, mesh=jax_icosphere(2))
    model = make_model(cfg, device="cpu", mesh=icosphere(2))
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]), cfg))
    return cfg, jmodel, variables, model


def _batch(num_faces, seed=0, n=B):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, K)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    fids = rng.integers(0, num_faces, size=n).astype(np.int32)
    return feats, dirs, fids


@pytest.mark.parametrize("in_dim,use_logspace", [(1, True), (3, True), (3, False)])
def test_fourier_encoding_matches_jax(in_dim, use_logspace):
    """Same bands (f64 rounded once to f32) and the JAX column order
    (input-dim-major, then [cos | sin | x]); cos/sin of the same f32
    arguments differ by the two libraries' rounding only (atol 2e-6)."""
    x = np.random.default_rng(1).uniform(-1, 1, size=(64, in_dim)).astype(np.float32)
    kw = dict(include_input=True, use_logspace=use_logspace,
              max_freq=None if use_logspace else 6.0)
    want = np.asarray(FourierFeatEnc(5, **kw).apply({}, jnp.asarray(x)))
    got = fourier_feat_enc(torch.from_numpy(x), 5, **kw).numpy()
    assert got.shape == want.shape == (64, in_dim * 11)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("strategy,in_dim", STRATEGIES)
def test_view_encoder_and_module_match_jax(strategy, in_dim):
    """view_encoder_apply vs the JAX one (intrinsic: f32 normals from the
    same mesh, the clipped arccos of the cosine; arccos amplifies a 1-ulp
    cosine difference near 0 and pi, hence atol 5e-5 on the angle's
    features), and the f32 module on the carried weights vs model.apply
    (f32 summation order only, atol 1e-5)."""
    cfg, jmodel, variables, model = _models(strategy, in_dim)
    feats, dirs, fids = _batch(jax_icosphere(2).num_faces)
    want = np.asarray(jax_view_encoder_apply(jmodel)(jnp.asarray(dirs), jnp.asarray(fids)))
    got = view_encoder_apply(model)(torch.from_numpy(dirs), torch.from_numpy(fids)).numpy()
    assert got.shape == want.shape == (B, 9 if strategy == "intrinsic" else 27)
    assert model.venc_dim == got.shape[1]
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)

    batch = {"eigenfunctions": jnp.asarray(feats), "unit_ray_dirs": jnp.asarray(dirs),
             "hit_face_idxs": jnp.asarray(fids)}
    ref = np.asarray(jmodel.apply(variables, batch))
    out = model(torch.from_numpy(feats), torch.from_numpy(dirs),
                torch.from_numpy(fids)).detach().numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_state_dict_is_upstream_and_normals_are_a_buffer():
    cfg, _, _, model = _models("intrinsic", 1)
    keys = list(model.state_dict())
    assert keys[0] == "spatial_mlp.layers.0.0.weight"
    assert keys[-4:] == ["directional_mlp.0.weight", "directional_mlp.0.bias",
                         "directional_mlp.2.weight", "directional_mlp.2.bias"]
    assert "face_normals" not in " ".join(keys)
    assert model.face_normals.dtype == torch.float32
    assert model.face_normals.shape == (icosphere(2).num_faces, 3)
    with pytest.raises(ValueError, match="mesh"):
        make_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="in_dim_view_dir"):
        make_model(_cfg("extrinsic", 1), device="cpu")


@pytest.mark.parametrize("strategy,in_dim", STRATEGIES)
def test_layout_round_trip(strategy, in_dim):
    """Flat layout with the tail: the state dict round-trips, the concat
    matrix's view rows are padded to venc_w (16 or 32) with zeros, the
    spatial head is a [128, 128] bottleneck and the RGB head 16 wide."""
    _, _, _, model = _models(strategy, in_dim)
    lay = layout_for_model(model)
    tail = lay.tail
    assert tail == ViewDepTailSpec(venc_in=model.venc_dim, d_hidden=128)
    assert tail.venc_w == (16 if strategy == "intrinsic" else 32)
    flat = lay.flat_from_state_dict(model.state_dict())
    back = lay.state_dict(flat)
    assert list(back) == list(model.state_dict())
    for name, t in model.state_dict().items():
        assert torch.equal(back[name], t), name
    roles = [e.role for e in lay.entries]
    assert roles[-3:] == ["bneck", "cat", "rgb"]
    cat = lay.mats(flat)[-2]
    assert cat.shape == (128 + tail.venc_w, 128)
    assert not cat[128 + tail.venc_in:].any()
    assert lay.mats(flat)[-3].shape == (128, 128) and lay.mats(flat)[-1].shape == (128, 16)
    assert len(lay.layers) == 5 and lay.layers[-1].ext[3] == "v"


@pytest.mark.parametrize("strategy,in_dim", STRATEGIES)
def test_forward_twin_matches_pallas(strategy, in_dim):
    """fused_apply_viewdep_plain vs make_fused_apply_viewdep (interpret):
    the same bf16 operands and f32 sums in another order, which can move a
    hidden value to the neighbouring bf16 (atol 2e-3, as the plain forward
    twin's test)."""
    cfg, jmodel, variables, model = _models(strategy, in_dim)
    feats, dirs, fids = _batch(jax_icosphere(2).num_faces, seed=2)
    venc = np.array(jax_view_encoder_apply(jmodel)(jnp.asarray(dirs), jnp.asarray(fids)))
    spec = JaxSpec(num_layers=4, k_in=K, hidden=128, skip_idx=1, out_dim=128)
    tail = JaxTail(venc_in=venc.shape[1], d_hidden=128)
    apply = make_fused_apply_viewdep(spec, tail, batch_tile=256, interpret=True)
    want = np.asarray(apply(viewdep_params_to_list(spec, tail, variables["params"]),
                            jnp.pad(jnp.asarray(feats), ((0, 0), (0, spec.k_pad - K))),
                            jnp.pad(jnp.asarray(venc), ((0, 0), (0, tail.venc_pad - venc.shape[1])))))
    lay = layout_for_model(model)
    fw = lay.pack(lay.flat_from_state_dict(model.state_dict()))
    got = fused_apply_viewdep_plain(fw, torch.from_numpy(feats), torch.from_numpy(venc)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    # the wrapper on CPU tensors is the twin, and counts no launch; it
    # takes the encoding at venc_in lanes only, not zero-padded to venc_w
    before = kernel_launches()
    np.testing.assert_array_equal(
        fused_apply_viewdep(fw, torch.from_numpy(feats), torch.from_numpy(venc)).numpy(), got)
    assert kernel_launches() == before
    with pytest.raises(ValueError, match="venc"):
        fused_apply_viewdep(fw, torch.from_numpy(feats), torch.zeros(B, lay.tail.venc_w))


def _viewdep_renderers(strategy, in_dim, H=40, W=40, k=16):
    cfg = _cfg(strategy, in_dim, k=k, skip=2)
    jm = jax_icosphere(3)
    efuncs = np.random.default_rng(0).normal(size=(jm.num_vertices, k)).astype(np.float32)
    jmodel = jax_make_model(cfg, mesh=jm)
    variables = init_model(jmodel, cfg, mesh=jm)
    jr = JaxRenderer(jmodel, variables, jm, eigenfunctions=efuncs, H=H, W=W, infer="fused")
    assert jr._fused is not None
    m = icosphere(3)
    model = make_model(cfg, device="cpu", mesh=m)
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]), cfg))
    return jr, Renderer(model, m, efuncs, H=H, W=W, device="cpu")


@pytest.mark.parametrize("strategy,in_dim", STRATEGIES)
def test_render_matches_jax_fused_renderer(strategy, in_dim):
    """The port's view-dependent render (plain twin) vs the JAX Renderer
    with the fused Pallas kernel: equal hit sets, background bit-equal, RGB
    within 2e-3 (bf16-operand matmuls in another order, an f16 wire on both
    sides; the view encodings differ by ~1e-6, see above). Original face
    ids are looked up: a Morton-sorted id would pick wrong normals."""
    jr, pr = _viewdep_renderers(strategy, in_dim)
    assert pr.viewdep and pr.infer_mode == "plain"
    cam = _look_at_cam(np.array([0.4, -2.8, 0.7]))
    K_ = _simple_K(40, 40)
    img_ref, hits_ref = jr.render(cam, K_, eval_render=True)
    img, hits = pr.render(cam, K_, eval_render=True)
    np.testing.assert_array_equal(np.sort(hits), np.sort(hits_ref))
    bg = np.ones(40 * 40, bool)
    bg[hits_ref] = False
    assert (~bg).any() and bg.any()
    np.testing.assert_array_equal(img.reshape(-1, 3)[bg], img_ref.reshape(-1, 3)[bg])
    np.testing.assert_allclose(img, img_ref, rtol=0, atol=2e-3)
    t = pr.trace_view(cam, K_)
    faces = pr.mesh.faces[t.face_idxs[t.valid].numpy()]
    np.testing.assert_array_equal(np.sort(faces, 1), np.sort(t.vids[t.valid].numpy(), 1))
    np.testing.assert_allclose(t.dirs.norm(dim=1).numpy(), 1.0, atol=1e-6)


def test_mesh_transform_refreshes_normals():
    """Twin of tests/test_render_regressions.py's normal-refresh test:
    after apply_mesh_transform the model's face normals follow the mesh
    (a 90-degree rotation changes every one), and the JAX Renderer given
    the same transform renders the same image."""
    jr, pr = _viewdep_renderers("intrinsic", 1, H=24, W=24)
    T = np.eye(4)
    T[:3, :3] = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    old = pr.model.face_normals.clone()
    pr.apply_mesh_transform(T)
    jr.apply_mesh_transform(T)
    new = pr.model.face_normals
    np.testing.assert_allclose(new.numpy(), np.asarray(pr.mesh.face_normals), atol=1e-6)
    assert not torch.allclose(new, old)
    cam = _look_at_cam(np.array([0.0, -2.5, 0.3]))
    K_ = _simple_K(24, 24)
    img_ref, hits_ref = jr.render(cam, K_, eval_render=True)
    img, hits = pr.render(cam, K_, eval_render=True)
    np.testing.assert_array_equal(np.sort(hits), np.sort(hits_ref))
    np.testing.assert_allclose(img, img_ref, rtol=0, atol=2e-3)


def test_viewdep_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the CUDA default is exercised on the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_model(_cfg("intrinsic", 1), mesh=icosphere(2))
    model = make_model(_cfg("intrinsic", 1), device="cpu", mesh=icosphere(2))
    assert isinstance(model, TextureFieldWithViewDependency)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(model, icosphere(2), np.zeros((icosphere(2).num_vertices, K), np.float32),
                 H=8, W=8)
