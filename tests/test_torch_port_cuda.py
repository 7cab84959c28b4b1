"""Tests of the port that need an NVIDIA GPU: the sm_90a kernels (the fused
MLP forward, the train forward/backward and weight gradients, Adam, and the
view-dependent field's tail kernels, the bitonic argsort) against their
plain twins, their launch counters and input checks, the tracer with every
sort method, and the tracer, renderer, preprocessing and a training epoch
on the card against the same code on the CPU.
They skip without CUDA. This file imports only the
port, so it also runs where JAX is not installed:

  python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""
import numpy as np
import pytest
import torch

from intrinsic_neural_fields_tpu_torch.geometry.synthetic import (
    blob_mesh,
    pinhole_K,
    ring_cameras,
)
from intrinsic_neural_fields_tpu_torch.models import make_model
from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (
    FusedMLPSpec,
    ParamLayout,
    adam_apply_plain,
    adam_hyper_rows,
    apply_vjp_plain,
    fused_adam_apply,
    fused_apply,
    fused_apply_plain,
    fused_apply_trainable,
    fused_train_adam,
    fused_train_grads,
    kernel_launches,
    pack_weights,
    train_grads_plain,
)
from intrinsic_neural_fields_tpu_torch.ops.ray_gen import pixel_grid_coords
from intrinsic_neural_fields_tpu_torch.ops.raster import intersect_coords_pinhole
from intrinsic_neural_fields_tpu_torch.render.renderer import Renderer

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _fwd_launch_as_designed(layout, B):
    """The forward's launch shape against its design: 2-CTA clusters of
    128-row CTAs (two warpgroups) when such a CTA's shared memory (weight
    ring, resident bf16 feature tile, view tile, exchange slots, tile
    program) fits in 227 KB, else of 64-row CTAs if theirs fits, else of
    128-row CTAs whose feature tile is a ring of two 64-lane chunks."""
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import last_fwd_launch

    k_w, vd = layout.spec.k_w, layout.tail is not None
    n_tiles = 2 * (k_w // 64) + 2 * (len(layout.layers) - 1) + vd + 1

    def smem(wg, x_chunks):
        return (3 * 8192 + 64 * wg * 64 * 2 * x_chunks + (64 * wg * 64 * 2 if vd else 0)
                + 2 * wg * 8192 + 24 * n_tiles)
    wg, x_res = 2, 1
    if smem(2, k_w // 64) > 227 * 1024:
        if smem(1, k_w // 64) <= 227 * 1024:
            wg = 1
        else:
            x_res = 0
    assert last_fwd_launch() == {"ctas": 2 * -(-B // (64 * wg)), "cluster": 2,
                                 "threads": 128 * wg,
                                 "smem_bytes": smem(wg, k_w // 64 if x_res else 2),
                                 "rows": 64 * wg, "x_resident": x_res}


@pytest.mark.parametrize("k,B", [(512, 8192), (1023, 8192), (512, 1000), (512, 1), (16, 1),
                                 (2048, 8192), (2048, 1000), (3, 8192), (3, 1000), (3, 1),
                                 (515, 8192), (515, 1000), (515, 1)])
def test_kernel_matches_plain_twin(cuda, k, B):
    """HQ layout (6 x 128, skip 3), feature-like inputs (range 1 per
    column). Tolerance 2e-3: f32 summation order and rare bf16
    re-rounding of a hidden activation only. Two launches give the same
    bits; the launch has the designed shape (k=2048: the skip layer
    streams the features again). k=3 and 515 are the xyz and tf_rff_blob
    fields' embedded widths (3 real columns of a 64-wide chunk; rows off
    16-byte boundaries)."""
    cfg = {"k": k, "num_layers": 6, "mlp_hidden_dim": 128, "skip_layer_idx": 3}
    fw = pack_weights(FusedMLPSpec(6, k, 128, 3), make_model(cfg, seed=4).state_dict(),
                      device=cuda)
    x = torch.from_numpy(
        np.random.default_rng(5).uniform(-0.5, 0.5, size=(B, k)).astype(np.float32)).to(cuda)
    before = kernel_launches()["fused_mlp_fwd"]
    got = fused_apply(fw, x)
    torch.cuda.synchronize()
    assert kernel_launches()["fused_mlp_fwd"] == before + 1
    want = fused_apply_plain(fw, x)
    assert got.shape == (B, 3)
    assert (got - want).abs().max().item() <= 2e-3
    _fwd_launch_as_designed(fw.layout, B)
    assert torch.equal(fused_apply(fw, x), got)


def test_kernel_rejects_bad_input(cuda):
    cfg = {"k": 32, "num_layers": 4, "mlp_hidden_dim": 128, "skip_layer_idx": 2}
    fw = pack_weights(FusedMLPSpec(4, 32, 128, 2), make_model(cfg).state_dict(), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_apply(fw, torch.zeros((8, 31), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        fused_apply(fw, torch.zeros((32, 8), device=cuda).t())


def test_tracer_on_card_matches_cpu(cuda):
    """Same torch code on both devices: equal valid masks, face ids equal
    except on exact-t ties, t within 1e-5 relative."""
    mesh = blob_mesh(4)
    H = W = 96
    cam, K = ring_cameras(3)[1], pinhole_K(H, W)
    coords = pixel_grid_coords(H, W)
    hits = {d: intersect_coords_pinhole(mesh.vertices, mesh.faces, cam, K, coords,
                                        W=W, H=H, device=d) for d in ("cuda", "cpu")}
    v = hits["cpu"].valid.numpy()
    np.testing.assert_array_equal(hits["cuda"].valid.cpu().numpy(), v)
    same = hits["cuda"].face_idx.cpu().numpy()[v] == hits["cpu"].face_idx.numpy()[v]
    assert same.mean() > 0.999
    np.testing.assert_allclose(hits["cuda"].t.cpu().numpy()[v], hits["cpu"].t.numpy()[v],
                               rtol=1e-5)


def test_renderer_kernel_matches_plain(cuda):
    """The default CUDA renderer (kernel) vs infer='plain' on the card:
    equal hit sets, images within 2e-3 (the kernel tolerance; the f16 wire
    adds at most ~5e-4)."""
    mesh = blob_mesh(3)
    k = 64
    efuncs = np.random.default_rng(0).uniform(-0.5, 0.5, size=(mesh.num_vertices, k))
    model = make_model({"k": k, "num_layers": 6, "mlp_hidden_dim": 128, "skip_layer_idx": 3})
    r_k = Renderer(model, mesh, efuncs, H=64, W=64)
    r_p = Renderer(model, mesh, efuncs, H=64, W=64, infer="plain")
    assert r_k.infer_mode == "kernel"
    cam, K = ring_cameras(4)[0], pinhole_K(64, 64)
    img_k, hit_k = r_k.render(cam, K, eval_render=True)
    img_p, hit_p = r_p.render(cam, K, eval_render=True)
    np.testing.assert_array_equal(hit_k, hit_p)
    np.testing.assert_allclose(img_k, img_p, rtol=0, atol=2e-3)


# Train kernels vs their plain twins. The two sum in f32 in different
# orders, which moves some bf16-rounded activations and deltas by one bf16
# step; the same plain twin run on the CPU and on the card differs from
# itself by up to 2.0e-2 per tensor in max|d|/max|g| for the same reason
# (measured on an H100 at k=512, B=4096). Held to: loss and squared-error
# sums rel 1e-5, per tensor max|d|/max|g| <= 5e-2 and ||d||/||g|| <= 1e-2.
GRAD_MAX_REL, GRAD_NORM_REL = 5e-2, 1e-2


def _train_setup(cuda, k, N, dtype, L=6, skip=3, seed=1):
    cfg = {"k": k, "num_layers": L, "mlp_hidden_dim": 128, "skip_layer_idx": skip}
    layout = ParamLayout(FusedMLPSpec(L, k, 128, skip))
    params = layout.flat_from_state_dict(make_model(cfg, seed=seed, device=cuda).state_dict())
    g = torch.Generator(device=cuda).manual_seed(seed)
    feats = (torch.rand(N, k, generator=g, device=cuda) - 0.5).to(dtype)
    gt = torch.rand(N, 3, generator=g, device=cuda)
    return layout, params, feats, gt


def _assert_grads_close(layout, got, want):
    for a, b in zip(layout.mats(got) + layout.biases(got), layout.mats(want) + layout.biases(want)):
        scale = b.abs().max().clamp_min(1e-30)
        assert (a - b).abs().max() <= GRAD_MAX_REL * scale
        assert (a - b).norm() <= GRAD_NORM_REL * b.norm().clamp_min(1e-30)


@pytest.mark.parametrize("k,N,B,dtype,loss_type", [
    (512, 8192, 4096, torch.bfloat16, "L1"),
    (1023, 8192, 4096, torch.bfloat16, "L2"),
    (100, 3000, 1000, torch.float32, "cauchy"),
])
def test_train_grads_kernel_matches_plain_twin(cuda, k, N, B, dtype, loss_type):
    layout, params, feats, gt = _train_setup(cuda, k, N, dtype)
    blk = 1
    gt_b = gt[blk * B:(blk + 1) * B].contiguous()
    before = kernel_launches()
    grads, loss_sum, sq_sum = fused_train_grads(layout, params, feats, gt_b, blk, B, loss_type)
    torch.cuda.synchronize()
    after = kernel_launches()
    assert after["fused_mlp_fwd_bwd"] == before["fused_mlp_fwd_bwd"] + 1
    assert after["fused_mlp_wgrad"] == before["fused_mlp_wgrad"] + 1
    want, loss_w, sq_w = train_grads_plain(layout, params, feats[blk * B:(blk + 1) * B], gt_b,
                                           loss_type)
    assert abs(loss_sum.item() / loss_w.item() - 1) <= 1e-5
    assert abs(sq_sum.item() / sq_w.item() - 1) <= 1e-5
    _assert_grads_close(layout, grads, want)
    # pads stay exactly zero; the same inputs give the same bits
    for e, m in zip(layout.entries, layout.mats(grads)):
        assert not m[e.rows:].any() and not m[:, e.cols:].any()
    again, _, _ = fused_train_grads(layout, params, feats, gt_b, blk, B, loss_type)
    assert torch.equal(again, grads)


def test_adam_kernel_equals_plain_twin(cuda):
    layout, params, _, _ = _train_setup(cuda, 512, 8, torch.float32)
    g = torch.Generator(device=cuda).manual_seed(3)
    grads = torch.randn(layout.n, generator=g, device=cuda) * 1e-3
    m = torch.randn(layout.n, generator=g, device=cuda) * 1e-4
    v = torch.rand(layout.n, generator=g, device=cuda) * 1e-6
    hyper = adam_hyper_rows(torch.tensor([9]), 1e-4, device=cuda)[0]
    want = adam_apply_plain(params, m, v, hyper, grads)
    copies = [t.clone() for t in (params, m, v)]
    before = kernel_launches()["fused_adam"]
    fused_adam_apply(params, m, v, hyper, grads)
    torch.cuda.synchronize()
    assert kernel_launches()["fused_adam"] == before + 1
    for got, w in zip((params, m, v), want):  # -fmad=false: the same roundings
        assert torch.equal(got, w)
    # with the train kernels' bf16 weight copy: the same f32 results, and
    # the copy equals the twin's new params rounded to bf16
    wb = torch.zeros(layout.n, dtype=torch.bfloat16, device=cuda)
    fused_adam_apply(*copies, hyper, grads, wb)
    for got, w in zip(copies, want):
        assert torch.equal(got, w)
    assert torch.equal(wb, want[0].to(torch.bfloat16))


def test_train_adam_launches_three_kernels(cuda):
    """A train step with Adam: since Adam moved into wgrad's epilogue, two
    launches (fwd_bwd, wgrad_adam), no grads-only wgrad and no Adam kernel."""
    layout, params, feats, gt = _train_setup(cuda, 512, 4096, torch.bfloat16)
    m, v = torch.zeros_like(params), torch.zeros_like(params)
    p_ref = params.clone()
    hyper = adam_hyper_rows(torch.tensor([1]), 1e-4, device=cuda)[0]
    before = kernel_launches()
    fused_train_adam(layout, params, m, v, hyper, feats, gt[:1024].contiguous(), 2, 1024)
    torch.cuda.synchronize()
    after = kernel_launches()
    for name, n in (("fused_mlp_fwd_bwd", 1), ("fused_mlp_wgrad_adam", 1),
                    ("fused_mlp_wgrad", 0), ("fused_adam", 0)):
        assert after[name] == before[name] + n
    # one Adam step from zero moments moves every real weight by about lr
    assert 0 < (params - p_ref).abs().max().item() <= 1.01e-4


def test_forward_vjp_kernel_matches_plain_twin(cuda):
    layout, params, feats, _ = _train_setup(cuda, 512, 4096, torch.float32)
    cot = torch.randn(4096, 3, generator=torch.Generator(device=cuda).manual_seed(2),
                      device=cuda)
    p = params.clone().requires_grad_()
    (fused_apply_trainable(layout, p, feats) * cot).sum().backward()
    _assert_grads_close(layout, p.grad, apply_vjp_plain(layout, params, feats, cot))


def test_train_wrappers_reject_bad_input(cuda):
    layout, params, feats, gt = _train_setup(cuda, 64, 512, torch.bfloat16, L=4, skip=2)
    gt256 = gt[:256].contiguous()
    bad = [
        (params.double(), feats, gt256, 0, "params"),
        (params, feats.to(torch.float16), gt256, 0, "feats"),
        (params, feats[:, :63].contiguous(), gt256, 0, "feats"),
        (params, feats, gt256.t().contiguous().t(), 0, "target"),
        (params, feats, gt[:255].contiguous(), 0, "target"),
        (params, feats.cpu(), gt256, 0, "feats"),
        (params, feats, gt256, 2, "outside"),
    ]
    for p, f, t, blk, match in bad:
        with pytest.raises(ValueError, match=match):
            fused_train_grads(layout, p, f, t, blk, 256)
    hyper = adam_hyper_rows(torch.tensor([1]), 1e-4, device=cuda)[0]
    with pytest.raises(ValueError, match="hyper"):
        fused_adam_apply(params, params.clone(), params.clone(), hyper[:7], params.clone())
    with pytest.raises(ValueError, match="grads"):
        fused_adam_apply(params, params.clone(), params.clone(), hyper, params[:-1])


def test_train_epoch_on_card_tracks_cpu(cuda):
    """One blocks epoch through the kernels vs the same epoch on the CPU
    (plain twins), same block order: losses rtol 1e-3; params held to the
    rule of the CPU parity tests: Adam moves a weight by about lr per step
    whatever its gradient's size, so one whose gradient is ~0 and flips sign
    under rounding noise ends up to 2*lr per step away. At most 0.1% of the
    weights may be more than 2.5e-3 away, none more than 2*lr*steps."""
    from intrinsic_neural_fields_tpu_torch.data.sampler import RayData, precompute_hit_features
    from intrinsic_neural_fields_tpu_torch.train.steps import (AdamHyper, create_train_state,
                                                               eager_step, make_epoch_fns)

    rng = np.random.default_rng(0)
    k, n, V = 128, 8192, 500
    arrays = (rng.normal(size=(V, k)).astype(np.float32), rng.integers(0, V, size=(n, 3)),
              rng.dirichlet(np.ones(3), size=n).astype(np.float32),
              rng.uniform(size=(n, 3)).astype(np.float32))
    cfg = {"k": k, "num_layers": 6, "mlp_hidden_dim": 128, "skip_layer_idx": 3}
    results = {}
    for dev in ("cuda", "cpu"):
        f, vids, bary, rgbs = (torch.as_tensor(a).to(dev) for a in arrays)
        data = precompute_hit_features(RayData(f, "efuncs", vids.long(), bary, rgbs),
                                       dtype=torch.bfloat16)
        model = make_model(cfg, seed=1, device=dev)
        train_epoch, _ = make_epoch_fns(model, "L1", shuffle="blocks", fused=True)
        state = create_train_state(model, AdamHyper(1e-3), dev)
        before = eager_step.launches
        state, m = train_epoch(state, np.arange(8)[::-1].copy(), data, 8, 1024)
        assert eager_step.launches == before
        results[dev] = (float(m["loss"]), state.params.cpu())
    assert abs(results["cuda"][0] / results["cpu"][0] - 1) <= 1e-3
    diff = (results["cuda"][1] - results["cpu"][1]).abs()
    assert (diff > 2.5e-3).float().mean() <= 1e-3
    assert diff.max() <= 2 * 1e-3 * 8


# The fwd_bwd kernel alone against its plain twin on every shape its
# contract takes: batch sizes from one row to 64 clusters (ragged ones too),
# feature widths that are and are not whole 16-byte rows (16, 100, 512,
# 1023), bf16 and f32 tables, the plain and the view-dependent chain. L2
# mode: loss and squared-error sums rel 1e-5, activations ||d||/||x|| <=
# 1e-3 (ACT_TOL of chip_smoke.py); cotangent mode (a continuous seed): the
# deltas <= 5e-2 and the bias sums <= 2e-2 (DELTA_TOL, BIAS_TOL); a second
# run gives the same bits.
FB_SHAPES = ([(B, k) for B in (1, 64, 65, 1000, 4096) for k in (16, 100, 512, 1023)]
             # the xyz and tf_rff_blob fields' embedded widths
             + [(B, k) for B in (1, 1000, 4096) for k in (3, 515)])


@pytest.mark.parametrize("vd", [False, True], ids=["plain", "viewdep"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("B,k", FB_SHAPES)
def test_fwd_bwd_kernel_matches_plain_twin(cuda, B, k, dtype, vd):
    from intrinsic_neural_fields_tpu_torch.ops import fused_mlp as F

    N = B + 64
    if vd:
        layout, params, feats, _, vtable, gt = _vd_setup(cuda, "intrinsic", k=k, N=N, dtype=dtype)
    else:
        layout, params, feats, gt = _train_setup(cuda, k, N, dtype)
        vtable = None
    gt, cot = gt[:B].contiguous(), torch.randn(B, 3, device=cuda,
                                               generator=torch.Generator(device=cuda).manual_seed(k))
    sc = F.make_train_scratch(layout, B, params)
    nh, H, nblk = len(layout.layers), 128, -(-B // 64)
    x, v = feats[:B], (vtable[:B] if vd else None)
    twin = F.fwd_bwd_viewdep_plain if vd else (lambda lay, p, x_, _v, t, lt: F.fwd_bwd_plain(
        lay, p, x_, t, lt))

    def norm_rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()

    name = "fused_mlp_fwd_bwd_viewdep" if vd else "fused_mlp_fwd_bwd"
    before = kernel_launches()[name]
    F._launch_fwd_bwd(layout, params, feats, 0, B, gt, F.LOSS_MODES["L2"], 1 / (3 * B), sc, vtable)
    acts, _, _, loss, sq = twin(layout, params, x, v, gt, "L2")
    torch.cuda.synchronize()
    assert kernel_launches()[name] == before + 1
    lsum = sc.loss_part.view(nblk, 2).sum(0)
    assert abs(lsum[0].item() / loss.item() - 1) <= 1e-5
    assert abs(lsum[1].item() / sq.item() - 1) <= 1e-5
    assert norm_rel(sc.acts.view(nh, -1), acts.view(nh, -1)) <= 1e-3

    F._launch_fwd_bwd(layout, params, feats, 0, B, cot, F.COTANGENT_MODE, 1 / (3 * B), sc, vtable)
    _, deltas, bsum, _, _ = twin(layout, params, x, v, cot, None)
    torch.cuda.synchronize()
    first = [t.clone() for t in (sc.acts, sc.deltas, sc.bias_part)]
    assert norm_rel(sc.deltas[:nh * B * H], deltas[:nh * B * H]) <= 5e-2
    assert norm_rel(sc.deltas[nh * B * H:], deltas[nh * B * H:]) <= 5e-2
    assert norm_rel(sc.bias_part.view(nblk, -1).sum(0), bsum) <= 2e-2
    F._launch_fwd_bwd(layout, params, feats, 0, B, cot, F.COTANGENT_MODE, 1 / (3 * B), sc, vtable)
    torch.cuda.synchronize()
    for a, b in zip(first, (sc.acts, sc.deltas, sc.bias_part)):
        assert torch.equal(a, b)
    cfg = F.last_fwd_bwd_launch()  # the shape the last launch ran with
    assert cfg["ctas"] == 2 * nblk and cfg["cluster"] == 2


def test_train_step_refreshes_a_stale_weight_copy(cuda):
    """A scratch made before the params moved (an in-place edit; an Adam
    step that does not write the copy) gives the bits of a fresh scratch:
    fwd_bwd never reads stale bf16 weights."""
    from intrinsic_neural_fields_tpu_torch.ops import fused_mlp as F

    layout, params, feats, gt = _train_setup(cuda, 512, 8192, torch.bfloat16)
    B = 4096
    gt_b = gt[:B].contiguous()
    sc = F.make_train_scratch(layout, B, params)
    params.mul_(0.5)
    got, _, _ = fused_train_grads(layout, params, feats, gt_b, 0, B, "L1", sc)
    want, _, _ = fused_train_grads(layout, params, feats, gt_b, 0, B, "L1")
    assert torch.equal(got, want)
    m, v = torch.zeros_like(params), torch.zeros_like(params)
    hyper = adam_hyper_rows(torch.tensor([1]), 1e-2, device=cuda)[0]
    fused_adam_apply(params, m, v, hyper, want)  # the copy is not written
    fresh = [t.clone() for t in (params, m, v)]
    fused_train_adam(layout, params, m, v, hyper, feats, gt_b, 0, B, "L1", sc)
    fused_train_adam(layout, *fresh, hyper, feats, gt_b, 0, B, "L1")
    torch.cuda.synchronize()
    for a, b in zip((params, m, v), fresh):
        assert torch.equal(a, b)
    assert torch.equal(sc.wb, params.to(torch.bfloat16))


# The view-dependent field's tail kernels vs their plain twins (the same
# tolerances: forward 2e-3 max abs on seeded weights, train grads as above).

def _vd_setup(cuda, strategy, k=512, N=8192, dtype=torch.bfloat16, seed=1):
    from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
    from intrinsic_neural_fields_tpu_torch.models import view_encoder_apply
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import layout_for_model

    mesh = icosphere(3)
    cfg = {"k": k, "num_layers": 6, "mlp_hidden_dim": 128, "skip_layer_idx": 3,
           "view_dependence": {"bottleneck_vec_dim": 128, "include_view_dir": True,
                               "embed_size": 4, "directional_hidden_dim": 128,
                               "in_dim_view_dir": 1 if strategy == "intrinsic" else 3,
                               "strategy": strategy}}
    model = make_model(cfg, seed=seed, device=cuda, mesh=mesh)
    layout = layout_for_model(model)
    params = layout.flat_from_state_dict(model.state_dict())
    g = torch.Generator(device=cuda).manual_seed(seed)
    feats = (torch.rand(N, k, generator=g, device=cuda) - 0.5).to(dtype)
    dirs = torch.randn(N, 3, generator=g, device=cuda)
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    fids = torch.randint(0, mesh.num_faces, (N,), generator=g, device=cuda)
    venc = view_encoder_apply(model)(dirs, fids)
    vtable = torch.zeros(N, layout.tail.venc_w, device=cuda, dtype=dtype)
    vtable[:, :layout.tail.venc_in] = venc.to(dtype)
    gt = torch.rand(N, 3, generator=g, device=cuda)
    return layout, params, feats, venc.contiguous(), vtable, gt


@pytest.mark.parametrize("strategy,B,k", [("intrinsic", 8192, 512), ("intrinsic", 1000, 512),
                                          ("intrinsic", 1, 512), ("extrinsic", 8192, 512),
                                          ("intrinsic", 8192, 2048), ("extrinsic", 1000, 2048),
                                          ("extrinsic", 8192, 3), ("intrinsic", 1000, 3),
                                          ("extrinsic", 1, 3)])
def test_viewdep_forward_kernel_matches_plain_twin(cuda, strategy, B, k):
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (fused_apply_viewdep,
                                                                 fused_apply_viewdep_plain)

    layout, params, feats, venc, _, _ = _vd_setup(cuda, strategy, k=k, dtype=torch.float32)
    fw = layout.pack(params)
    x, v = feats[:B].contiguous(), venc[:B].contiguous()
    before = kernel_launches()
    got = fused_apply_viewdep(fw, x, v)
    torch.cuda.synchronize()
    after = kernel_launches()
    assert after["fused_mlp_fwd_viewdep"] == before["fused_mlp_fwd_viewdep"] + 1
    assert after["fused_mlp_fwd"] == before["fused_mlp_fwd"]
    assert got.shape == (B, 3)
    assert (got - fused_apply_viewdep_plain(fw, x, v)).abs().max().item() <= 2e-3
    _fwd_launch_as_designed(layout, B)
    assert torch.equal(fused_apply_viewdep(fw, x, v), got)


@pytest.mark.parametrize("strategy,loss_type", [("intrinsic", "L1"), ("extrinsic", "L2")])
def test_viewdep_train_kernels_match_plain_twin(cuda, strategy, loss_type):
    layout, params, feats, _, vtable, gt = _vd_setup(cuda, strategy)
    B, blk = 4096, 1
    gt_b = gt[blk * B:(blk + 1) * B].contiguous()
    before = kernel_launches()
    grads, loss_sum, sq_sum = fused_train_grads(layout, params, feats, gt_b, blk, B, loss_type,
                                                vencs=vtable)
    torch.cuda.synchronize()
    after = kernel_launches()
    for name in ("fused_mlp_fwd_bwd_viewdep", "fused_mlp_wgrad_viewdep"):
        assert after[name] == before[name] + 1
    for name in ("fused_mlp_fwd_bwd", "fused_mlp_wgrad"):
        assert after[name] == before[name]
    sl = slice(blk * B, (blk + 1) * B)
    want, loss_w, sq_w = train_grads_plain(layout, params, feats[sl], gt_b, loss_type,
                                           vtable[sl])
    assert abs(loss_sum.item() / loss_w.item() - 1) <= 1e-5
    assert abs(sq_sum.item() / sq_w.item() - 1) <= 1e-5
    _assert_grads_close(layout, grads, want)
    cat = layout.mats(grads)[-2]  # the concat matrix: its view-row pads stay zero
    assert not cat[128 + layout.tail.venc_in:].any()
    again, _, _ = fused_train_grads(layout, params, feats, gt_b, blk, B, loss_type,
                                    vencs=vtable)
    assert torch.equal(again, grads)


def test_viewdep_train_adam_launches_three_kernels(cuda):
    layout, params, feats, _, vtable, gt = _vd_setup(cuda, "intrinsic")
    m, v = torch.zeros_like(params), torch.zeros_like(params)
    p_ref = params.clone()
    hyper = adam_hyper_rows(torch.tensor([1]), 1e-4, device=cuda)[0]
    before = kernel_launches()
    fused_train_adam(layout, params, m, v, hyper, feats, gt[:1024].contiguous(), 2, 1024,
                     vencs=vtable)
    torch.cuda.synchronize()
    after = kernel_launches()  # two launches: Adam is wgrad_adam's epilogue
    for name, n in (("fused_mlp_fwd_bwd_viewdep", 1), ("fused_mlp_wgrad_adam_viewdep", 1),
                    ("fused_mlp_wgrad_viewdep", 0), ("fused_adam", 0)):
        assert after[name] == before[name] + n
    assert 0 < (params - p_ref).abs().max().item() <= 1.01e-4


def test_viewdep_wrappers_reject_bad_input(cuda):
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import fused_apply_viewdep

    layout, params, feats, venc, vtable, gt = _vd_setup(cuda, "intrinsic", k=64, N=512)
    gt256 = gt[:256].contiguous()
    bad = [
        (vtable.float(), "vencs"),                     # not the table's dtype
        (vtable[:, :5].contiguous(), "vencs"),         # not venc_w wide
        (vtable[:, :layout.tail.venc_in].contiguous(), "vencs"),  # venc_in: the forward's width
        (vtable[:256].contiguous(), "vencs"),          # not the table's rows
        (vtable.cpu(), "vencs"),
        (None, "vencs"),                               # a tail needs its encodings
    ]
    for vt, match in bad:
        with pytest.raises(ValueError, match=match):
            fused_train_grads(layout, params, feats, gt256, 0, 256, vencs=vt)
    plain_layout, plain_params, plain_feats, _ = _train_setup(cuda, 64, 512, torch.bfloat16,
                                                              L=4, skip=2)
    with pytest.raises(ValueError, match="vencs"):
        fused_train_grads(plain_layout, plain_params, plain_feats, gt256, 0, 256, vencs=vtable)
    fw = layout.pack(params)
    x = feats.float()
    with pytest.raises(ValueError, match="venc"):
        fused_apply_viewdep(fw, x, venc[:100].contiguous())
    with pytest.raises(ValueError, match="venc"):
        fused_apply_viewdep(fw, x, venc.double())
    with pytest.raises(ValueError, match="venc"):
        fused_apply_viewdep(fw, x, vtable.float())  # venc_w: the train tables' width
    with pytest.raises(ValueError, match="fused_apply_viewdep"):
        fused_apply(fw, x)
    with pytest.raises(ValueError, match="tail"):
        fused_apply_viewdep(plain_layout.pack(plain_params), x, venc)


def test_viewdep_epoch_on_card_tracks_cpu(cuda):
    """One blocks epoch of the view-dependent field through the tail
    kernels vs the same epoch on the CPU (plain twins), same block order;
    the bounds of test_train_epoch_on_card_tracks_cpu."""
    from intrinsic_neural_fields_tpu_torch.data.sampler import (RayData, precompute_hit_features,
                                                                precompute_hit_vencs)
    from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
    from intrinsic_neural_fields_tpu_torch.models import view_encoder_apply
    from intrinsic_neural_fields_tpu_torch.train.steps import (AdamHyper, create_train_state,
                                                               eager_step, make_epoch_fns)

    rng = np.random.default_rng(0)
    mesh = icosphere(3)
    k, n, V = 128, 8192, mesh.num_vertices
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    arrays = (rng.normal(size=(V, k)).astype(np.float32), rng.integers(0, V, size=(n, 3)),
              rng.dirichlet(np.ones(3), size=n).astype(np.float32),
              rng.uniform(size=(n, 3)).astype(np.float32), dirs,
              rng.integers(0, mesh.num_faces, size=n))
    cfg = {"k": k, "num_layers": 6, "mlp_hidden_dim": 128, "skip_layer_idx": 3,
           "view_dependence": {"bottleneck_vec_dim": 128, "include_view_dir": True,
                               "embed_size": 4, "directional_hidden_dim": 128,
                               "in_dim_view_dir": 1, "strategy": "intrinsic"}}
    results = {}
    for dev in ("cuda", "cpu"):
        f, vids, bary, rgbs, d, fid = (torch.as_tensor(a).to(dev) for a in arrays)
        model = make_model(cfg, seed=1, device=dev, mesh=mesh)
        data = precompute_hit_features(RayData(f, "efuncs", vids.long(), bary, rgbs, d,
                                               fid.long()), dtype=torch.bfloat16)
        data = precompute_hit_vencs(view_encoder_apply(model), data, 16, dtype=torch.bfloat16)
        train_epoch, _ = make_epoch_fns(model, "L1", shuffle="blocks", fused=True)
        state = create_train_state(model, AdamHyper(1e-3), dev)
        before = eager_step.launches
        state, m = train_epoch(state, np.arange(8)[::-1].copy(), data, 8, 1024)
        assert eager_step.launches == before
        results[dev] = (float(m["loss"]), state.params.cpu())
    assert abs(results["cuda"][0] / results["cpu"][0] - 1) <= 1e-3
    diff = (results["cuda"][1] - results["cpu"][1]).abs()
    assert (diff > 2.5e-3).float().mean() <= 1e-3
    assert diff.max() <= 2 * 1e-3 * 8


# The bitonic argsort kernel (csrc/bitonic_argsort.cu) and the tracer's
# sort methods. Every method returns the permutation of a stable sort, so
# the kernel, its plain twin and torch.sort(stable=True) agree to the bit.

@pytest.mark.parametrize("n", [1, 255, 1000, 4096, 4097, 5000, 1 << 14, (1 << 14) + 1, 1 << 15,
                               1 << 16, 1 << 17, 1 << 18, (1 << 18) + 1, 1 << 20])
def test_bitonic_kernel_matches_twin_and_sort(cuda, n):
    """1 to 128 CTAs (2^14 to 2^18 keys: cooperative launches): one CUDA
    launch per call up to 2^18, the plan's launches above."""
    from intrinsic_neural_fields_tpu_torch.ops.sort import (bitonic_argsort,
                                                            bitonic_argsort_vmem,
                                                            device_max_ctas, sort_plan)

    plan = sort_plan(n, device_max_ctas())
    assert n > 1 << 18 or len(plan.launches) == 1
    g = torch.Generator(device="cuda").manual_seed(n)
    for hi in (max(2, n // 8), 1 << 30):  # dense duplicates, then nearly unique keys
        keys = torch.randint(0, hi, (n,), generator=g, device=cuda, dtype=torch.int32)
        before = kernel_launches()["bitonic_argsort"]
        cuda_before = bitonic_argsort_vmem.cuda_launches
        got = bitonic_argsort_vmem(keys, 31)
        torch.cuda.synchronize()
        assert kernel_launches()["bitonic_argsort"] == before + 1
        assert bitonic_argsort_vmem.cuda_launches - cuda_before == len(plan.launches)
        assert got.dtype == torch.int32 and got.device.type == "cuda"
        assert torch.equal(got.long(), torch.sort(keys, stable=True).indices)
        assert torch.equal(got, bitonic_argsort(keys, 31))


def test_bitonic_kernel_rejects_bad_input(cuda):
    from intrinsic_neural_fields_tpu_torch.ops.sort import bitonic_argsort_vmem

    with pytest.raises(ValueError, match="int32"):
        bitonic_argsort_vmem(torch.arange(8, device=cuda), 31)
    with pytest.raises(ValueError, match="contiguous"):
        bitonic_argsort_vmem(torch.arange(16, device=cuda, dtype=torch.int32)[::2], 31)
    assert bitonic_argsort_vmem(torch.empty(0, device=cuda, dtype=torch.int32), 31).numel() == 0


def test_trace_bit_identical_across_sort_methods_on_card(cuda):
    from intrinsic_neural_fields_tpu_torch.ops.morton import pixel_morton_order

    mesh = blob_mesh(4)
    H = W = 128
    cam, K = ring_cameras(3)[1], pinhole_K(H, W)
    coords = pixel_grid_coords(H, W)
    coords = coords[pixel_morton_order(coords)]
    hits = {}
    for method in ("argsort", "radix", "bitonic", "bitonic_vmem"):
        before = kernel_launches()["bitonic_argsort"]
        hits[method] = intersect_coords_pinhole(mesh.vertices, mesh.faces, cam, K, coords,
                                                W=W, H=H, sort_method=method)
        torch.cuda.synchronize()
        launched = kernel_launches()["bitonic_argsort"] - before
        assert launched == (2 if method == "bitonic_vmem" else 0)
    for method, h in hits.items():
        for field in ("valid", "face_idx", "t", "bary"):
            assert torch.equal(getattr(h, field), getattr(hits["argsort"], field)), (method, field)


def test_preprocessing_on_card_matches_cpu(cuda, tmp_path):
    """The device intersector on the card (raster tracer, pipelined fetch)
    vs the same code on the CPU: the same rays in each cache, face ids
    equal except on exact-t ties, barycentrics within 2e-4."""
    import os

    from intrinsic_neural_fields_tpu_torch import preprocess_dataset
    from intrinsic_neural_fields_tpu_torch.geometry.synthetic import make_dataset

    data = str(tmp_path / "data")
    make_dataset(data, H=64, W=64, n_train=4, subdivisions=3)
    mesh = os.path.join(data, "blob.obj")
    caches = {}
    for dev in ("cuda", "cpu"):
        preprocess_dataset.main([str(tmp_path / dev), mesh, data, "train", "--device", dev])
        caches[dev] = {n: np.load(str(tmp_path / dev / "train" / f"{n}.npy"))
                       for n in ("face_idxs", "barycentric_coords", "unit_ray_dirs")}
    np.testing.assert_array_equal(caches["cuda"]["unit_ray_dirs"], caches["cpu"]["unit_ray_dirs"])
    assert (caches["cuda"]["face_idxs"] == caches["cpu"]["face_idxs"]).mean() > 0.999
    same = caches["cuda"]["face_idxs"] == caches["cpu"]["face_idxs"]
    np.testing.assert_allclose(caches["cuda"]["barycentric_coords"][same],
                               caches["cpu"]["barycentric_coords"][same], atol=2e-4)


# The wgrad kernel alone against its plain twin, both on the kernel's own
# fwd_bwd outputs: k=512 and 1023 (rows on and off 16-byte boundaries), B =
# 4096, 1000 and 64, a batch whose 47 chunks of 64 rows do not divide evenly
# over the cluster's 8 CTAs (3000), bf16 tables and f32 batches, the plain
# and the view-dependent chain. Held to chip_smoke.py's WGRAD_TOL: per
# tensor max|d|/max|g| <= 1e-4 (the same products summed in another order);
# the loss sums to the per-block partials' sum rel 1e-6; a second launch
# gives the same bits; the launch has the designed shape: one cluster of
# min(8, B/64) CTAs per 128-row gradient tile.
WG_CASES = ([(k, B, torch.bfloat16) for k in (512, 1023) for B in (4096, 1000, 64)]
            + [(512, 4096, torch.float32), (512, 3000, torch.bfloat16)]
            # the xyz and tf_rff_blob fields: f32 tables at k_in 3 and 515
            + [(k, B, torch.float32) for k in (3, 515) for B in (4096, 1000, 1)])


@pytest.mark.parametrize("vd", [False, True], ids=["plain", "viewdep"])
@pytest.mark.parametrize("k,B,dtype", WG_CASES)
def test_wgrad_kernel_matches_plain_twin(cuda, k, B, dtype, vd):
    from intrinsic_neural_fields_tpu_torch.ops import fused_mlp as F

    N = B + 64
    if vd:
        layout, params, feats, _, vtable, gt = _vd_setup(cuda, "intrinsic", k=k, N=N, dtype=dtype)
    else:
        layout, params, feats, gt = _train_setup(cuda, k, N, dtype)
        vtable = None
    gt = gt[:B].contiguous()
    sc = F.make_train_scratch(layout, B, params)
    nh, nblk = len(layout.layers), -(-B // 64)
    F._launch_fwd_bwd(layout, params, feats, 0, B, gt, F.LOSS_MODES["L1"], 1 / (3 * B), sc, vtable)
    grads, sums = torch.empty(layout.n, device=cuda), torch.empty(2, device=cuda)
    name = "fused_mlp_wgrad_viewdep" if vd else "fused_mlp_wgrad"
    before = kernel_launches()[name]
    F._launch_wgrad(layout, feats, 0, B, sc, grads, sums, vtable)
    torch.cuda.synchronize()
    assert kernel_launches()[name] == before + 1
    bsum = sc.bias_part.view(nblk, 128 * nh + 16).sum(0)
    want = F._wgrad(layout, feats[:B], None if vtable is None else vtable[:B], sc.acts, sc.deltas,
                    bsum)
    for a, b in zip(layout.mats(grads) + layout.biases(grads),
                    layout.mats(want) + layout.biases(want)):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max().clamp_min(1e-30)
    lsum = sc.loss_part.view(nblk, 2).sum(0)
    assert torch.allclose(sums, lsum, rtol=1e-6, atol=0)
    first = torch.cat([grads, sums]).clone()
    F._launch_wgrad(layout, feats, 0, B, sc, grads, sums, vtable)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([grads, sums]), first)
    tiles = 1  # the head
    for lay in layout.layers:
        tiles += 0 if lay.h is None else 1
        if lay.ext is not None:
            rows = layout.spec.k_w if lay.ext[3] == "x" else layout.tail.venc_w
            tiles += -(-rows // 128)
    split = min(8, nblk)
    assert F.last_wgrad_launch() == {"ctas": tiles * split, "cluster": split, "threads": 256,
                                     "smem_bytes": 3 * 32768, "tiles": tiles}


# Adam in wgrad's epilogue (fused_mlp_wgrad_adam[_viewdep]) and the epoch as
# one CUDA graph. The epilogue's Adam is held to the bit: against the plain
# Adam twin (with its bf16 copy and the accumulators) applied to the
# gradients and loss sums of the grads-only wgrad launched on the same
# scratch, which test_wgrad_kernel_matches_plain_twin holds to wgrad_plain.
# m and v start random over the whole flat buffer, pads included, so an
# entry the epilogue skips or updates twice shows.

def _random_moments(layout, cuda, seed=5):
    g = torch.Generator(device=cuda).manual_seed(seed)
    m = torch.randn(layout.n, generator=g, device=cuda) * 1e-4
    v = torch.rand(layout.n, generator=g, device=cuda) * 1e-6
    return m, v


@pytest.mark.parametrize("vd", [False, True], ids=["plain", "viewdep"])
@pytest.mark.parametrize("k,dtype,B", [(512, torch.bfloat16, 4096), (1023, torch.bfloat16, 4096),
                                       (512, torch.float32, 4096), (1023, torch.float32, 4096)]
                         + [(k, torch.float32, B) for k in (3, 515) for B in (4096, 1000, 1)])
def test_wgrad_adam_kernel_equals_twin(cuda, k, dtype, B, vd):
    from intrinsic_neural_fields_tpu_torch.ops import fused_mlp as F

    blk = 1
    N = 2 * B
    if vd:
        layout, params, feats, _, vtable, gt = _vd_setup(cuda, "intrinsic", k=k, N=N, dtype=dtype)
    else:
        layout, params, feats, gt = _train_setup(cuda, k, N, dtype)
        vtable = None
    gt_b = gt[blk * B:(blk + 1) * B].contiguous()
    m, v = _random_moments(layout, cuda)
    hyper_all = adam_hyper_rows(torch.arange(1, 4), 1e-3, device=cuda)
    sc = F.make_train_scratch(layout, B, params)
    F._launch_fwd_bwd(layout, params, feats, blk * B, B, gt_b, F.LOSS_MODES["L1"], 1 / (3 * B),
                      sc, vtable)
    grads, sums = torch.empty(layout.n, device=cuda), torch.empty(2, device=cuda)
    F._launch_wgrad(layout, feats, blk * B, B, sc, grads, sums, vtable)
    acc0 = torch.tensor([0.25, 0.5], device=cuda)
    want = [t.clone() for t in (params, m, v)]
    for dst, src in zip(want, adam_apply_plain(params, m, v, hyper_all[2], grads)):
        dst.copy_(src)
    want_acc = acc0.clone()
    F.accumulate_loss(want_acc, sums[0], sums[1])
    p2, m2, v2, acc = params.clone(), m.clone(), v.clone(), acc0.clone()
    sums2 = torch.empty(2, device=cuda)
    name = "fused_mlp_wgrad_adam" + ("_viewdep" if vd else "")
    before = kernel_launches()[name]
    F._launch_wgrad_adam(layout, feats, blk * B, B, sc, p2, m2, v2, hyper_all, sums2, acc, vtable,
                         step=2)
    torch.cuda.synchronize()
    assert kernel_launches()[name] == before + 1
    for got, w in zip((p2, m2, v2), want):
        assert torch.equal(got, w)
    assert torch.equal(sc.wb, want[0].to(torch.bfloat16))
    assert torch.equal(sums2, sums) and torch.equal(acc, want_acc)
    # the grads-only kernel's shape: clusters of min(8, B/64) CTAs
    assert F.last_wgrad_launch()["ctas"] % min(8, -(-B // 64)) == 0


@pytest.mark.parametrize("vd", [False, True], ids=["plain", "viewdep"])
def test_step_with_device_indices_equals_host_step(cuda, vd):
    """fused_train_adam_step (block, targets and hyper row read on the
    device) gives the bits of fused_train_adam on the same block."""
    from intrinsic_neural_fields_tpu_torch.ops import fused_mlp as F

    B = 1024
    if vd:
        layout, params, feats, _, vtable, gt = _vd_setup(cuda, "intrinsic", N=4 * B)
    else:
        layout, params, feats, gt = _train_setup(cuda, 512, 4 * B, torch.bfloat16)
        vtable = None
    m, v = _random_moments(layout, cuda)
    hyper_all = adam_hyper_rows(torch.arange(1, 5), 1e-3, device=cuda)
    order = torch.tensor([3, 0, 2, 1], dtype=torch.int32, device=cuda)
    p2, m2, v2 = params.clone(), m.clone(), v.clone()
    sc = F.make_train_scratch(layout, B, p2)
    sums, acc = torch.empty(2, device=cuda), torch.zeros(2, device=cuda)
    F.fused_train_adam_step(layout, p2, m2, v2, hyper_all, order, 2, feats, gt, B, "L1", sc,
                            sums, acc, vtable)
    ls, ss = fused_train_adam(layout, params, m, v, hyper_all[2], feats,
                              gt[2 * B:3 * B].contiguous(), 2, B, "L1", vencs=vtable)
    torch.cuda.synchronize()
    for a, b in zip((p2, m2, v2), (params, m, v)):
        assert torch.equal(a, b)
    assert torch.equal(sums, torch.stack((ls, ss)))


def _epoch_data(cuda, vd, n=8192, k=128, seed=0):
    from intrinsic_neural_fields_tpu_torch.data.sampler import (RayData, precompute_hit_features,
                                                                precompute_hit_vencs)
    from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
    from intrinsic_neural_fields_tpu_torch.models import view_encoder_apply

    rng = np.random.default_rng(seed)
    mesh = icosphere(3)
    V = mesh.num_vertices
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    cfg = {"k": k, "num_layers": 6, "mlp_hidden_dim": 128, "skip_layer_idx": 3}
    if vd:
        cfg["view_dependence"] = {"bottleneck_vec_dim": 128, "include_view_dir": True,
                                  "embed_size": 4, "directional_hidden_dim": 128,
                                  "in_dim_view_dir": 1, "strategy": "intrinsic"}
    f, vids, bary, rgbs, d, fid = (torch.as_tensor(a).to(cuda) for a in (
        rng.normal(size=(V, k)).astype(np.float32), rng.integers(0, V, size=(n, 3)),
        rng.dirichlet(np.ones(3), size=n).astype(np.float32),
        rng.uniform(size=(n, 3)).astype(np.float32), dirs,
        rng.integers(0, mesh.num_faces, size=n)))
    model = make_model(cfg, seed=1, device=cuda, mesh=mesh)
    data = precompute_hit_features(RayData(f, "efuncs", vids.long(), bary, rgbs, d, fid.long()),
                                   dtype=torch.bfloat16)
    if vd:
        data = precompute_hit_vencs(view_encoder_apply(model), data, 16, dtype=torch.bfloat16)
    return model, data


@pytest.mark.parametrize("vd", [False, True], ids=["plain", "viewdep"])
def test_graph_epoch_equals_three_launch_loop(cuda, vd):
    """Two blocks epochs with an lr change between them: the graph-replayed
    epoch (fused_adam=True: 2 launches per step, one replay) and the
    per-step loop of fwd_bwd, grads-only wgrad and the Adam kernel
    (fused_adam=False) give the same params, m, v, bf16 copy and metrics,
    to the bit."""
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import reset_kernel_launches
    from intrinsic_neural_fields_tpu_torch.train.steps import (AdamHyper, create_train_state,
                                                               make_epoch_fns)

    model, data = _epoch_data(cuda, vd)
    tail = "_viewdep" if vd else ""
    nb, B = 8, 1024
    out = {}
    for fused_adam in (True, False):
        train_epoch, _ = make_epoch_fns(model, "L1", shuffle="blocks", fused=True,
                                        fused_adam=fused_adam)
        state = create_train_state(model, AdamHyper(1e-3), cuda)
        metrics = []
        for e, order in enumerate((np.arange(nb)[::-1].copy(), np.array([2, 5, 0, 7, 1, 4, 6, 3]))):
            if e:
                state.set_lr(3e-4)
            reset_kernel_launches()
            state, m = train_epoch(state, order, data, nb, B)
            torch.cuda.synchronize()
            launches = kernel_launches()
            metrics.append((m["loss"].clone(), m["sq_err_per_sample"].clone()))
            if fused_adam:
                assert launches["fused_mlp_fwd_bwd" + tail] == nb
                assert launches["fused_mlp_wgrad_adam" + tail] == nb
                assert launches["fused_adam"] == launches["fused_mlp_wgrad" + tail] == 0
                assert train_epoch.graph.replays == e + 1 and train_epoch.graph.captures == 1
            else:
                assert launches["fused_adam"] == launches["fused_mlp_wgrad" + tail] == nb
        wb = train_epoch.graph.bufs.scratch.wb.clone() if fused_adam else None
        out[fused_adam] = (state, metrics, wb)
    (s1, m1, wb), (s0, m0, _) = out[True], out[False]
    for a, b in ((s1.params, s0.params), (s1.mu, s0.mu), (s1.nu, s0.nu)):
        assert torch.equal(a, b)
    assert torch.equal(wb, s1.params.to(torch.bfloat16))
    for (l1, q1), (l0, q0) in zip(m1, m0):
        assert torch.equal(l1, l0) and torch.equal(q1, q0)
    assert s1.count == s0.count == 2 * nb


def test_graph_epoch_recaptures_on_resume(cuda):
    """A state rebuilt from its tensors (what a resume from checkpoint.pt
    does) has new pointers: the graph is captured again, and the resumed
    epoch equals the uninterrupted one to the bit."""
    from intrinsic_neural_fields_tpu_torch.train.steps import (AdamHyper, TrainState,
                                                               create_train_state, make_epoch_fns)

    model, data = _epoch_data(cuda, False)
    nb, B = 8, 1024
    train_epoch, _ = make_epoch_fns(model, "L1", shuffle="blocks", fused=True)
    state = create_train_state(model, AdamHyper(1e-3), cuda)
    state, _ = train_epoch(state, np.arange(nb), data, nb, B)
    resumed = TrainState(state.layout, state.params.clone(), state.mu.clone(), state.nu.clone(),
                         state.count, AdamHyper(1e-3))
    order = np.arange(nb)[::-1].copy()
    state, m = train_epoch(state, order, data, nb, B)
    assert train_epoch.graph.captures == 1
    resumed, mr = train_epoch(resumed, order, data, nb, B)
    torch.cuda.synchronize()
    assert train_epoch.graph.captures == 2
    for a, b in ((resumed.params, state.params), (resumed.mu, state.mu), (resumed.nu, state.nu)):
        assert torch.equal(a, b)
    assert torch.equal(mr["loss"], m["loss"])


@pytest.mark.parametrize("n", [1, 3, 5, 4097, 234_515])
def test_adam_kernel_with_a_tail_equals_twin(cuda, n):
    """The standalone Adam kernel on n % 4 != 0 entries (its float4 body
    and scalar tail): the twin's bits, its bf16 copy too; buffers off
    16-byte boundaries are refused."""
    g = torch.Generator(device=cuda).manual_seed(n)
    p, grads, m = (torch.randn(n, generator=g, device=cuda) for _ in range(3))
    v = torch.rand(n, generator=g, device=cuda) * 1e-6
    wb = torch.zeros(n, dtype=torch.bfloat16, device=cuda)
    hyper = adam_hyper_rows(torch.tensor([4]), 1e-3, device=cuda)[0]
    want = adam_apply_plain(p, m, v, hyper, grads)
    fused_adam_apply(p, m, v, hyper, grads, wb)
    torch.cuda.synchronize()
    for got, w in zip((p, m, v), want):
        assert torch.equal(got, w)
    assert torch.equal(wb, want[0].to(torch.bfloat16))
    off = torch.zeros(n + 1, device=cuda)[1:]
    with pytest.raises(ValueError, match="aligned"):
        fused_adam_apply(off, m, v, hyper, grads)


# What users do with a trained field: bake, transfer, Meshroom renders and
# LPIPS on the card, through the forward kernel, against the plain twin.

def _trained_out_dir(tmp_path, mesh, k, seed=3, H=64, W=64):
    """A config, an eigenfunction file and a random reference-layout
    model.pt (k features, 6x128 skip 3) for `mesh`."""
    import yaml

    from intrinsic_neural_fields_tpu_torch.geometry.mesh_io import write_obj
    from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import (
        compute_first_k_eigenfunctions)

    mesh_path = str(tmp_path / "mesh.obj")
    write_obj(mesh_path, mesh.vertices, mesh.faces)
    ef_path = str(tmp_path / "efuncs.npy")
    np.save(ef_path, compute_first_k_eigenfunctions(mesh, k).astype(np.float32))
    cfg = {"k": k, "num_layers": 6, "mlp_hidden_dim": 128, "skip_layer_idx": 3}
    out_dir = tmp_path / "run"
    out_dir.mkdir()
    torch.save(make_model(cfg, seed=seed, device="cpu").state_dict(), out_dir / "model.pt")
    config = {"data": {"mesh_path": mesh_path, "eigenfunctions_path": ef_path,
                       "img_height": H, "img_width": W},
              "model": cfg, "training": {"out_dir": str(out_dir)}}
    cfg_path = str(tmp_path / "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)
    return config, cfg_path


def test_bake_kernel_matches_plain_twin(cuda, tmp_path):
    """A grid's UV bake at 256^2 through the forward kernel against the
    same bake through the plain twin: every texel within 2/255 (one
    colour may land across an 8-bit edge either way); the kernel launched
    once per 8,192-texel chunk, the last one ragged."""
    from intrinsic_neural_fields_tpu_torch.bake import bake_texture
    from intrinsic_neural_fields_tpu_torch.geometry.primitives import grid_mesh
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import reset_kernel_launches
    from intrinsic_neural_fields_tpu_torch.utils.io import imread

    mesh = grid_mesh(20)
    _, cfg_path = _trained_out_dir(tmp_path, mesh, 32)
    uv = str(tmp_path / "grid_uv.obj")
    with open(uv, "w") as f:
        f.write("mtllib grid_uv.obj.mtl\n")
        f.writelines(f"v {v[0]} {v[1]} {v[2]}\n" for v in mesh.vertices)
        f.writelines(f"vt {v[0]} {v[1]}\n" for v in mesh.vertices)
        f.writelines(f"f {a + 1}/{a + 1} {b + 1}/{b + 1} {c + 1}/{c + 1}\n"
                     for a, b, c in mesh.faces)
    with open(uv + ".mtl", "w") as f:
        f.write("newmtl material_0\nmap_Kd texture.png\n")
    reset_kernel_launches()
    got = imread(bake_texture(str(tmp_path / "k"), uv, cfg_path, texture_size=256)).astype(int)
    torch.cuda.synchronize()
    launches = kernel_launches()["fused_mlp_fwd"]
    want = imread(bake_texture(str(tmp_path / "p"), uv, cfg_path, texture_size=256,
                               infer="plain")).astype(int)
    assert kernel_launches()["fused_mlp_fwd"] == launches
    assert np.abs(got - want).max() <= 2
    assert launches == -(-_hit_texels(uv, 256) // 8192)


def _hit_texels(uv_path, size):
    """Texels inside a UV triangle (the bake's own host lookup)."""
    from intrinsic_neural_fields_tpu_torch.bake.bake import find_containing_triangles
    from intrinsic_neural_fields_tpu_torch.geometry.mesh_io import read_obj_with_uv

    _, faces, uvs, _ = read_obj_with_uv(uv_path)
    p = np.stack([(size - 1) * uvs[:, 0], (size - 1) * (1.0 - uvs[:, 1])], -1)
    PX, PY = np.meshgrid(np.arange(size), np.arange(size))
    pts = np.stack([PX.ravel(), PY.ravel()], -1).astype(np.float64)
    idx = find_containing_triangles(pts, p[faces[:, 0]], p[faces[:, 1]], p[faces[:, 2]])
    return int((idx >= 0).sum())


def test_transfer_kernel_matches_plain_twin(cuda, tmp_path):
    """The transferred field (icosphere 3 -> icosphere 2, an exact prefix
    correspondence) rendered through the kernel and through the plain
    twin: equal valid masks, PSNR >= 50 dB."""
    from intrinsic_neural_fields_tpu_torch.evaluation.metrics import psnr
    from intrinsic_neural_fields_tpu_torch.geometry.mesh_io import write_obj
    from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
    from intrinsic_neural_fields_tpu_torch.make_transfer_targets import (constant_eigenfunction,
                                                                         spliced_full_basis)
    from intrinsic_neural_fields_tpu_torch.geometry.laplacian import build_laplacian
    from intrinsic_neural_fields_tpu_torch.texture_transfer import build_transferred_renderer

    src, tgt = icosphere(3), icosphere(2)
    config, _ = _trained_out_dir(tmp_path, src, 32)
    _, M = build_laplacian(src, "cotan")
    src_full = np.concatenate([constant_eigenfunction(M)[:, None],
                               np.load(config["data"]["eigenfunctions_path"])], 1)
    np.save(tmp_path / "src_full.npy", src_full)
    np.save(tmp_path / "tgt_full.npy", spliced_full_basis(tgt, 48, "cotan")[0])
    np.save(tmp_path / "corr.npy", np.arange(tgt.num_vertices))
    write_obj(str(tmp_path / "tgt.obj"), tgt.vertices, tgt.faces)
    args = (config, str(tmp_path / "tgt.obj"), str(tmp_path / "src_full.npy"),
            str(tmp_path / "tgt_full.npy"), str(tmp_path / "corr.npy"))
    rk = build_transferred_renderer(*args)
    rp = build_transferred_renderer(*args, infer="plain")
    assert rk.infer_mode == "kernel" and rp.infer_mode == "plain"
    K = pinhole_K(64, 64)
    for cam in ring_cameras(3):
        img_k, hit_k = rk.render(cam, K, eval_render=True)
        img_p, hit_p = rp.render(cam, K, eval_render=True)
        np.testing.assert_array_equal(hit_k, hit_p)
        mask = np.zeros(64 * 64, bool)
        mask[hit_k] = True
        assert mask.any() and psnr(img_k, img_p, mask) >= 50.0


def test_distorted_render_on_card_matches_cpu(cuda):
    """A radial-k3 render (1280x720, the coefficients of chip_smoke.py's
    Meshroom phase) on the card through the kernel against the CPU render
    through the plain twin: equal valid masks, colours within 2e-3."""
    H, W = 720, 1280
    mesh = blob_mesh(3)
    efuncs = np.random.default_rng(0).normal(size=(mesh.num_vertices, 64)).astype(np.float32)
    model = make_model({"k": 64, "num_layers": 6, "mlp_hidden_dim": 128, "skip_layer_idx": 3},
                       seed=1, device="cpu")
    K = np.array([[1.2 * H, 0, (W - 1) / 2], [0, 1.2 * H, (H - 1) / 2], [0, 0, 1]], np.float32)
    cam = ring_cameras(4)[1]
    kw = dict(eval_render=True, distortion_coeffs=[0.05, -0.02, 0.01],
              distortion_type="meshroom_radial_k3")
    img_g, hit_g = Renderer(model.to("cuda"), mesh, efuncs, H=H, W=W).render(cam, K, **kw)
    img_c, hit_c = Renderer(model.to("cpu"), mesh, efuncs, H=H, W=W,
                            device="cpu").render(cam, K, **kw)
    np.testing.assert_array_equal(hit_g, hit_c)
    assert np.abs(img_g - img_c).max() <= 2e-3


def test_lpips_on_card_matches_cpu(cuda, tmp_path):
    """LPIPS on the card (TF32 off in its convolutions) equals the CPU
    metric within 1e-4 relative, at 256^2 with random AlexNet weights."""
    from intrinsic_neural_fields_tpu_torch.evaluation.lpips import ALEX_CFG, LPIPS

    rng = np.random.default_rng(0)
    arrays, in_ch = {}, 3
    for i, (out_ch, k, _, _, _) in enumerate(ALEX_CFG):
        arrays[f"conv{i}_w"] = rng.normal(scale=0.05, size=(out_ch, in_ch, k, k)).astype(np.float32)
        arrays[f"conv{i}_b"] = rng.normal(scale=0.02, size=out_ch).astype(np.float32)
        arrays[f"lin{i}_w"] = np.abs(rng.normal(size=(1, out_ch, 1, 1))).astype(np.float32)
        in_ch = out_ch
    path = str(tmp_path / "w.npz")
    np.savez(path, **arrays)
    a = rng.random((256, 256, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1).astype(np.float32)
    torch.backends.cudnn.allow_tf32 = True  # the metric must not depend on it
    try:
        got = LPIPS(path)(a, b)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    want = LPIPS(path, device="cpu")(a, b)
    assert abs(got / want - 1) <= 1e-4


def _eig_gates(L, M, k, ev, phi, rel_tol, orth_tol):
    from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import shift_invert_eigenpairs

    ev_h, phi_h = shift_invert_eigenpairs(L, M, k)
    Md = M.diagonal()
    assert np.abs(ev - ev_h).max() / np.abs(ev_h).max() < rel_tol
    assert np.abs((phi * Md[:, None]).T @ phi - np.eye(k)).max() < orth_tol
    return ev_h, phi_h


@pytest.mark.parametrize("budget,refine_filter", [(2 << 30, "device"), (1 << 12, "host")],
                         ids=["one_shot_device_polish", "chunked_host_polish"])
def test_chefsi_on_card_matches_shift_invert(cuda, budget, refine_filter):
    """CheFSI's device loop on the card (f32, TF32 off), at icosphere(4),
    k=64: eigenvalues within 1e-4 of the largest (the device-filtered
    polish's gate; the host polish reaches 1e-8), M-orthonormal to 1e-10,
    principal angles below 1 degree."""
    from intrinsic_neural_fields_tpu_torch.geometry.laplacian import build_laplacian
    from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
    from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import (
        solve_generalized_eigenproblem)

    L, M = build_laplacian(icosphere(4), "cotan")
    stats = {}
    ev, phi = solve_generalized_eigenproblem(L, M, 64, method="chefsi", device="cuda",
                                             spmv_bytes_budget=budget,
                                             refine_filter=refine_filter, stats=stats)
    ev_h, phi_h = _eig_gates(L, M, 64, ev, phi, 1e-8 if refine_filter == "host" else 1e-4,
                             1e-10)
    s = np.linalg.svd((phi_h * M.diagonal()[:, None]).T @ phi, compute_uv=False)
    assert np.degrees(np.arccos(np.clip(s, 0.0, 1.0))).max() < 1.0
    assert stats["device_spmv_calls"] > 0 and stats["device_s"] > 0


def test_ell_spmv_on_card_matches_scipy(cuda):
    """The gather product on the card, one-shot and chunked, against
    scipy's f64 CSR product: within f32 rounding of dmax terms."""
    import scipy.sparse as sparse

    from intrinsic_neural_fields_tpu_torch.geometry.laplacian import build_laplacian
    from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import _ell_arrays, ell_spmv

    L, M = build_laplacian(blob_mesh(4), "cotan")
    inv_sqrt = 1.0 / np.sqrt(M.diagonal())
    idx, w = _ell_arrays(L, inv_sqrt)
    C = (sparse.diags(inv_sqrt) @ L @ sparse.diags(inv_sqrt)).tocsr()
    X = np.random.default_rng(0).standard_normal((L.shape[0], 80)).astype(np.float32)
    want = C @ X.astype(np.float64)
    for budget in (2 << 30, 1 << 12):
        spmv, _ = ell_spmv(idx, w, 80, budget, cuda)
        got = spmv(torch.from_numpy(X).to(cuda)).cpu().numpy()
        assert np.abs(got - want).max() < 1e-5 * np.abs(C).max() * np.abs(X).max() * idx.shape[1]


def test_lobpcg_on_card_matches_shift_invert(cuda):
    """torch.lobpcg on a sparse CUDA tensor, f32, at icosphere(2), k=10:
    tests/test_spectral.py's gate (rtol 1e-3, atol 1e-4)."""
    from intrinsic_neural_fields_tpu_torch.geometry.laplacian import build_laplacian
    from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
    from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import (
        shift_invert_eigenpairs, solve_generalized_eigenproblem)

    L, M = build_laplacian(icosphere(2), "cotan")
    ev, _ = solve_generalized_eigenproblem(L, M, 10, method="lobpcg", tol=1e-7, device="cuda")
    np.testing.assert_allclose(ev, shift_invert_eigenpairs(L, M, 10)[0], rtol=1e-3, atol=1e-4)


def test_dense_window_on_card(cuda):
    """5,041 rows (a 70x70 grid), inside the dense path's device window:
    the f32 eigh on the card; eigenvalues within 1e-4 of the largest,
    M-orthonormal to 1e-4 (f32 eigenvectors)."""
    from intrinsic_neural_fields_tpu_torch.geometry.laplacian import build_laplacian
    from intrinsic_neural_fields_tpu_torch.geometry.primitives import grid_mesh
    from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import (
        DENSE_DEVICE_WINDOW, solve_generalized_eigenproblem)

    L, M = build_laplacian(grid_mesh(70), "cotan")
    assert DENSE_DEVICE_WINDOW[0] < L.shape[0] <= DENSE_DEVICE_WINDOW[1]
    ev, phi = solve_generalized_eigenproblem(L, M, 20, method="dense", device="cuda")
    _eig_gates(L, M, 20, ev, phi, 1e-4, 1e-4)


def test_cloud_eigenbasis_on_card(cuda, tmp_path):
    """preprocess_eigenfunctions on a faceless PLY with pc_vert_robust and
    chefsi on the card: eigenvalues within 1e-4 of the largest of the
    shift-invert CLI's."""
    from intrinsic_neural_fields_tpu_torch import make_transfer_targets, preprocess_eigenfunctions

    cloud = str(tmp_path / "cloud.ply")
    make_transfer_targets.write_cloud_ply(cloud, blob_mesh(3).vertices)
    base = "pc_vert_robust_kmax24_skip_first_efuncs"
    evs = {}
    for method in ("shift_invert", "chefsi"):
        out = tmp_path / method
        preprocess_eigenfunctions.main([str(out), cloud, "24", "--laplacian_type",
                                        "pc_vert_robust", "--method", method])
        evs[method] = np.load(out / f"eigenvalues_{base}.npy")
    assert np.abs(evs["chefsi"] - evs["shift_invert"]).max() < 1e-4 * evs["shift_invert"].max()
