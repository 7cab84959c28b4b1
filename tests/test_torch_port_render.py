"""Port parity: the port's Renderer (CPU, plain MLP twin) vs the JAX
Renderer with the fused Pallas kernel (interpret mode), plus twins of the
renderer regression tests (pixel cache, pipelined render, cache-key
mismatch, empty mask) and the CUDA-by-default rule."""
import numpy as np
import pytest
import torch
import jax

from intrinsic_neural_fields_tpu.geometry.primitives import icosphere as jax_icosphere
from intrinsic_neural_fields_tpu.models import init_model
from intrinsic_neural_fields_tpu.models import make_model as jax_make_model
from intrinsic_neural_fields_tpu.render.renderer import Renderer as JaxRenderer

from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
from intrinsic_neural_fields_tpu_torch.models import make_model
from intrinsic_neural_fields_tpu_torch.render.renderer import Renderer
from intrinsic_neural_fields_tpu_torch.utils.weights import state_dict_from_flax

from tests.test_render_regressions import _look_at_cam, _simple_K

torch.set_num_threads(2)


def _port_renderer(H=48, W=48, k=16, hidden=32, seed=0):
    m = icosphere(3)
    efuncs = np.random.default_rng(seed).normal(size=(m.num_vertices, k)).astype(np.float32)
    cfg = {"k": k, "num_layers": 4, "mlp_hidden_dim": hidden, "skip_layer_idx": 2}
    return Renderer(make_model(cfg, seed=seed, device="cpu"), m, efuncs, H=H, W=W, device="cpu")


def test_render_matches_jax_fused_renderer():
    """Same mesh, features and weights. Background pixels bit-equal (the
    valid masks agree); RGB within 2e-3: both sides run bf16-operand /
    f32-accumulate matmuls and ship f16, only the summation order differs."""
    H = W = 40
    k = 16
    cfg = {"k": k, "num_layers": 4, "mlp_hidden_dim": 128, "skip_layer_idx": 2}
    jm = jax_icosphere(3)
    efuncs = np.random.default_rng(0).normal(size=(jm.num_vertices, k)).astype(np.float32)
    jmodel = jax_make_model(cfg)
    variables = init_model(jmodel, cfg)
    jr = JaxRenderer(jmodel, variables, jm, eigenfunctions=efuncs, H=H, W=W, infer="fused")

    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model = make_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, cfg))
    pr = Renderer(model, icosphere(3), efuncs, H=H, W=W, device="cpu")
    assert pr.infer_mode == "plain"

    cam = _look_at_cam(np.array([0.4, -2.8, 0.7]))
    K = _simple_K(H, W)
    img_ref, hits_ref = jr.render(cam, K, eval_render=True)
    img, hits = pr.render(cam, K, eval_render=True)
    np.testing.assert_array_equal(np.sort(hits), np.sort(hits_ref))
    bg = np.ones(H * W, bool)
    bg[hits_ref] = False
    assert (~bg).any() and bg.any()
    np.testing.assert_array_equal(img.reshape(-1, 3)[bg], img_ref.reshape(-1, 3)[bg])
    np.testing.assert_allclose(img, img_ref, rtol=0, atol=2e-3)


def test_pixel_cache_reuse_and_mask_safety():
    r = _port_renderer(32, 32)
    K = _simple_K(32, 32)
    cams = [_look_at_cam(np.array([0.4, -2.8, 0.7])),
            _look_at_cam(np.array([2.5, 0.5, -0.4]))]
    for c in cams:
        r.render(c, K)
    assert len(r._pixel_cache) == 1

    mask_a = np.zeros(32 * 32, dtype=bool)
    mask_a[: 32 * 32 // 2] = True
    mask_b = ~mask_a
    img_a = r.render(cams[0], K, obj_mask_1d=mask_a)
    img_b = r.render(cams[0], K, obj_mask_1d=mask_b)
    assert len(r._pixel_cache) == 3
    r.render(cams[1], K, obj_mask_1d=mask_a)
    assert len(r._pixel_cache) == 3

    fresh = _port_renderer(32, 32)
    np.testing.assert_array_equal(img_a, fresh.render(cams[0], K, obj_mask_1d=mask_a))
    np.testing.assert_array_equal(img_b, fresh.render(cams[0], K, obj_mask_1d=mask_b))


def test_pixel_cache_digest_collision_rebuilds():
    """A cache hit is confirmed on the packed mask bytes, not the digest:
    a forged entry under the right key with other bytes is rebuilt."""
    r = _port_renderer(32, 32)
    K = _simple_K(32, 32)
    cam = _look_at_cam(np.array([0.4, -2.8, 0.7]))
    mask_a = np.zeros(32 * 32, dtype=bool)
    mask_a[: 300] = True
    key, entry = r._pixels_for_view(mask_a)
    mask_b = np.zeros(32 * 32, dtype=bool)
    mask_b[500:] = True
    _, entry_b = r._pixels_for_view(mask_b)
    r._pixel_cache[key] = entry_b  # simulate a digest collision
    img = r.render(cam, K, obj_mask_1d=mask_a)
    np.testing.assert_array_equal(img, _port_renderer(32, 32).render(cam, K, obj_mask_1d=mask_a))


def test_pipelined_async_render_identical_to_serial():
    r = _port_renderer()
    K = _simple_K(r.H, r.W)
    cams = [_look_at_cam(np.array([0.4, -2.8, 0.7])),
            _look_at_cam(np.array([2.5, 0.5, -0.4])),
            _look_at_cam(np.array([-1.8, 1.8, 1.0]))]
    serial = [r.render(c, K) for c in cams]
    handles = [r.render_async(c, K) for c in cams]
    for img, h in zip(serial, handles):
        np.testing.assert_array_equal(img, r.render_fetch(h))
    se = [r.render(c, K, eval_render=True) for c in cams]
    hs = [r.render_async(c, K, eval_render=True) for c in cams]
    for (img, idxs), h in zip(se, hs):
        img2, idxs2 = r.render_fetch(h)
        np.testing.assert_array_equal(img, img2)
        np.testing.assert_array_equal(idxs, idxs2)


def test_trace_cache_mask_mismatch_raises():
    r = _port_renderer()
    cam = _look_at_cam(np.array([0.0, -2.5, 0.3]))
    K = _simple_K(48, 48)
    mask = np.zeros(48 * 48, bool)
    mask[: 48 * 24] = True
    first = r.render(cam, K, obj_mask_1d=mask, cache_key="v")
    np.testing.assert_array_equal(first, r.render(cam, K, obj_mask_1d=mask, cache_key="v"))
    with pytest.raises(ValueError, match="different object mask"):
        r.render(cam, K, obj_mask_1d=~mask, cache_key="v")


def test_empty_mask_renders_background():
    r = _port_renderer()
    cam = _look_at_cam(np.array([0.0, -2.5, 0.3]))
    K = _simple_K(48, 48)
    img, hit_idx = r.render(cam, K, obj_mask_1d=np.zeros(48 * 48, bool), eval_render=True)
    assert img.shape == (48, 48, 3)
    assert (img == 1.0).all()
    assert hit_idx.size == 0


def test_wire_u8_matches_8bit_quantized_f16():
    r = _port_renderer()
    r8 = Renderer(r.model, r.mesh, r.features.numpy(), H=48, W=48, wire_u8=True, device="cpu")
    cam = _look_at_cam(np.array([0.4, -2.8, 0.7]))
    K = _simple_K(48, 48)
    a = np.round(np.clip(r.render(cam, K), 0, 1) * 255).astype(np.uint8)
    b = np.round(np.clip(r8.render(cam, K), 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(a, b)


def test_non_pinhole_K_rejected_on_every_render():
    r = _port_renderer()
    cam = _look_at_cam(np.array([0.4, -2.8, 0.7]))
    bad = _simple_K(48, 48)
    bad[1, 0] = 2.0
    with pytest.raises(ValueError, match="pinhole intrinsics"):
        r.render(cam, bad)


def test_renderer_requires_cuda_unless_cpu_is_asked(monkeypatch):
    m = icosphere(1)
    cfg = {"k": 4, "num_layers": 3, "mlp_hidden_dim": 8, "skip_layer_idx": 1}
    efuncs = np.zeros((m.num_vertices, 4), np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(make_model(cfg, device="cpu"), m, efuncs, H=8, W=8)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        Renderer(make_model(cfg, device="cpu"), m, efuncs, H=8, W=8, device="cpu",
                 infer="kernel")


def test_make_model_requires_cuda_unless_cpu_is_asked(monkeypatch):
    cfg = {"k": 4, "num_layers": 3, "mlp_hidden_dim": 8, "skip_layer_idx": 1}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_model(cfg)
    # Seeded weights are drawn on the CPU: the same seed gives the same model.
    a, b = make_model(cfg, seed=7, device="cpu"), make_model(cfg, seed=7, device="cpu")
    assert a.layers[0][0].weight.device.type == "cpu"
    for key, val in a.state_dict().items():
        assert torch.equal(val, b.state_dict()[key])


def test_trace_view_matches_render_hits():
    """The public trace_view traces every pixel: its valid pixel ids are
    the hit set render(eval_render=True) reports, exactly."""
    r = _port_renderer()
    cam = _look_at_cam(np.array([0.4, -2.8, 0.7]))
    K = _simple_K(r.H, r.W)
    vids, bary, valid, pix_idx, _, _ = r.trace_view(cam, K)
    assert vids.shape == (r.H * r.W, 3) and bary.shape == (r.H * r.W, 3)
    assert sorted(pix_idx.tolist()) == list(range(r.H * r.W))
    _, hit_idx = r.render(cam, K, eval_render=True)
    np.testing.assert_array_equal(np.sort(pix_idx[valid].numpy()), np.sort(hit_idx))
    np.testing.assert_allclose(bary[valid].sum(-1).numpy(), 1.0, rtol=0, atol=1e-6)


def test_renderer_keeps_its_face_table_until_the_mesh_changes():
    """The Renderer builds its tracer's face table at the first view and
    reuses it (raster.bin's mesh_hit 0, then 1); set_mesh and
    apply_mesh_transform drop it, and the next view builds it anew and
    renders the image a fresh Renderer of that mesh renders."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from intrinsic_neural_fields_tpu_torch.geometry.mesh import Mesh
    from intrinsic_neural_fields_tpu_torch.ops import launches

    r = _port_renderer()
    cam, K = _look_at_cam(np.array([0.4, -2.8, 0.7])), _simple_K(r.H, r.W)
    efuncs = r.features.numpy()

    def render():
        launches.reset_kernel_launches()
        with profile(activities=[ProfilerActivity.CPU]):
            img = r.render(cam, K)
        bins = [s for s in launches.spans(0, 2 ** 63 - 1)[0] if s["name"] == "raster.bin"]
        return img, [s["attrs"]["mesh_hit"] for s in bins]

    def fresh():
        return Renderer(r.model, copy.deepcopy(r.mesh), efuncs, H=r.H, W=r.W,
                        device="cpu").render(cam, K)

    assert render()[1] == [0]
    img, hit = render()
    assert hit == [1]
    np.testing.assert_array_equal(img, fresh())

    v = r.mesh.vertices
    r.set_mesh(Mesh(vertices=v * (1.0 + 0.1 * np.sin(3 * v[:, :1])), faces=r.mesh.faces))
    before, (img, hit) = img, render()
    assert hit == [0] and render()[1] == [1] and not np.array_equal(img, before)
    np.testing.assert_array_equal(img, fresh())

    T = np.eye(4)
    T[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    T[:3, 3] = [0.05, -0.1, 0.0]
    r.apply_mesh_transform(T)
    before, (img, hit) = img, render()
    assert hit == [0] and render()[1] == [1] and not np.array_equal(img, before)
    np.testing.assert_array_equal(img, fresh())
