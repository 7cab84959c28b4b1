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


def _numpy_scatter(preds, valid, mask, bg, wire_u8, eval_render, H, W):
    """The image (and hit indices) as the renderer made them before its
    wire image left the device in raster order: the composite on the
    device, then the host's u8 -> f32 pass and its scatter through the
    Morton permutation (and the mask)."""
    from intrinsic_neural_fields_tpu_torch.ops.morton import pixel_morton_order

    pix_idx = np.nonzero(mask)[0] if mask is not None else np.arange(H * W)
    morton = pixel_morton_order(np.stack([pix_idx % W, pix_idx // W], axis=-1))
    rgb = torch.where(valid[:, None], preds.to(torch.float16),
                      torch.tensor(bg, dtype=torch.float16))
    if wire_u8:
        rgb = torch.round(rgb.to(torch.float32).clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    rgb_m, valid_m = rgb.numpy(), valid.numpy()
    L = len(pix_idx)
    if rgb_m.dtype == np.uint8:
        rgb_m = rgb_m.astype(np.float32) / 255.0
    img_masked = np.empty((L, 3), dtype=np.float32)
    img_masked[morton] = np.float32(rgb_m)
    if mask is not None:
        img = np.full((H * W, 3), bg, dtype=np.float32)
        img[mask] = img_masked
    else:
        img = img_masked
    img = img.reshape(H, W, 3)
    if eval_render:
        hit = np.empty_like(valid_m)
        hit[morton] = valid_m
        return img, np.nonzero(hit)[0]
    return img


def _wire_mask(kind, H, W):
    if kind == "none":
        return None
    mask = np.zeros(H * W, bool)
    if kind == "single":
        mask[(H // 2) * W + W // 2] = True  # on the sphere
    else:
        mask[np.random.default_rng(3).uniform(size=H * W) < 0.6] = True
        mask[: W * 4] = True  # rows of background the mask keeps
    return mask


@pytest.mark.parametrize("devices", ["one", "two"])
@pytest.mark.parametrize("background", ["white", "black"])
@pytest.mark.parametrize("eval_render", [False, True], ids=["image", "eval"])
@pytest.mark.parametrize("mask_kind", ["none", "partial", "single"])
@pytest.mark.parametrize("wire_u8", [True, False], ids=["u8", "f16"])
def test_wire_image_equals_the_numpy_scatter(monkeypatch, wire_u8, mask_kind, eval_render,
                                             background, devices):
    """The raster-order wire image and its one host conversion give, to
    the bit, the image and hit indices that the numpy scatter gave from the
    same colours: every wire, mask, background and D. With two CPU devices
    the inference chunk is cut so that the view really is two shards."""
    from intrinsic_neural_fields_tpu_torch.render import renderer as RM

    H = W = 48
    if devices == "two":
        monkeypatch.setattr(RM, "_INFER_CHUNK", 256)
    base = _port_renderer(H, W)
    r = Renderer(base.model, base.mesh, base.features.numpy(), background=background, H=H, W=W,
                 wire_u8=wire_u8, device="cpu",
                 devices=["cpu", "cpu"] if devices == "two" else None)
    seen, inner = [], RM.compose_wire

    def spy(preds, valid, *args):
        seen.append((preds.clone(), valid.clone()))
        return inner(preds, valid, *args)

    monkeypatch.setattr(RM, "compose_wire", spy)
    mask = _wire_mask(mask_kind, H, W)
    cam = _look_at_cam(np.array([0.4, -2.8, 0.7]))
    out = r.render(cam, _simple_K(H, W), obj_mask_1d=mask, eval_render=eval_render)
    (preds, valid), = seen
    if devices == "two" and mask_kind != "single":
        assert len(r._shards(preds.shape[0])) == 2
    assert valid.any() and (mask_kind == "single" or not valid.all())
    bg = 1.0 if background == "white" else 0.0
    want = _numpy_scatter(preds, valid, mask, bg, wire_u8, eval_render, H, W)
    img, want_img = (out[0], want[0]) if eval_render else (out, want)
    assert img.dtype == want_img.dtype == np.float32 and img.shape == (H, W, 3)
    np.testing.assert_array_equal(img.view(np.uint32), want_img.view(np.uint32))
    if eval_render:
        assert out[1].dtype == want[1].dtype
        np.testing.assert_array_equal(out[1], want[1])


def test_compose_wire_plain_on_hand_built_slot_maps():
    """compose_wire_plain against values worked out by hand: rows reach
    their raster pixels through the slot map; a miss, a pixel outside the
    mask (-1) and a slot past the rows show the background; the u8 wire
    rounds half to even after the f16 rounding and clamps; the hit plane
    is 1 only where a hit reached its pixel."""
    from intrinsic_neural_fields_tpu_torch.ops.wire import compose_wire, compose_wire_plain

    preds = torch.tensor([[0.5, -0.25, 1.5],
                          [0.3, 0.7, 0.9],      # not hit
                          [2.5 / 255, 3.5 / 255, 1.0],
                          [0.1, 0.2, 0.3]], dtype=torch.float32)
    valid = torch.tensor([True, False, True, True])
    slot = torch.tensor([2, -1, 0, 1, 4, 3, 0], dtype=torch.int32)
    rgb, plane = compose_wire_plain(preds, valid, slot, 1.0, True, True)
    # In f16, 2.5/255 and 3.5/255 times 255 are 2.49996 and 3.49995, and 0.1
    # and 0.3 are 25.494 and 76.512: the f16 rounding decides before the
    # rounding to an integer; 0.5 gives 127.5, rounded to 128.
    want = [[2, 3, 255], [255, 255, 255], [128, 0, 255], [255, 255, 255], [255, 255, 255],
            [25, 51, 77], [128, 0, 255]]
    assert rgb.dtype == torch.uint8 and rgb.tolist() == want
    assert plane.dtype == torch.uint8 and plane.tolist() == [1, 0, 1, 0, 0, 1, 1]
    rgb16, none = compose_wire_plain(preds, valid, slot, 0.0, False, False)
    assert none is None and rgb16.dtype == torch.float16
    f16 = preds.to(torch.float16)
    want16 = torch.stack([f16[2], torch.zeros(3), f16[0], torch.zeros(3), torch.zeros(3),
                          f16[3], f16[0]]).to(torch.float16)
    assert torch.equal(rgb16, want16)
    assert all(torch.equal(a, b) for a, b in zip(
        compose_wire(preds, valid, slot, 1.0, True, True), (rgb, plane)))
    empty = torch.zeros(0, dtype=torch.int32)
    assert compose_wire_plain(preds, valid, empty, 1.0, True, True)[0].shape == (0, 3)


def _bad_wire_operands(case):
    preds = torch.zeros(6, 3)
    valid = torch.zeros(6, dtype=torch.bool)
    slot = torch.full((10,), -1, dtype=torch.int32)
    if case == "preds_f16":
        preds = preds.half()
    elif case == "preds_width":
        preds = torch.zeros(6, 4)
    elif case == "preds_strided":
        preds = torch.zeros(3, 6).t()
    elif case == "valid_u8":
        valid = valid.to(torch.uint8)
    elif case == "valid_length":
        valid = valid[:5]
    elif case == "slot_i64":
        slot = slot.long()
    elif case == "slot_2d":
        slot = slot.reshape(2, 5)
    elif case == "slot_strided":
        slot = torch.zeros(20, dtype=torch.int32)[::2]
    elif case == "slot_device":
        slot = torch.empty(10, dtype=torch.int32, device="meta")
    elif case == "meta_device":
        preds, valid, slot = (t.to("meta") for t in (preds, valid, slot))
    return preds, valid, slot


@pytest.mark.parametrize("case", ["preds_f16", "preds_width", "preds_strided", "valid_u8",
                                  "valid_length", "slot_i64", "slot_2d", "slot_strided",
                                  "slot_device", "meta_device"])
def test_compose_wire_refuses_bad_operands(case):
    """The wrapper checks every operand's type, shape, contiguity and
    device, and the device itself, before any launch."""
    from intrinsic_neural_fields_tpu_torch.ops.wire import compose_wire

    match = "unsupported device" if case == "meta_device" else "must be contiguous"
    with pytest.raises(ValueError, match=match):
        compose_wire(*_bad_wire_operands(case), 1.0, True, False)
