"""The port's bench (intrinsic_neural_fields_tpu_torch/bench.py) against
root bench.py and the JAX package on the CPU, at small sizes: the same
arrays to the bit, the train leg against the JAX fused blocks epoch (the
Pallas kernels in interpret mode), the render leg against the port
Renderer and the JAX Renderer, and the JSON line of main.

Sizes: V=120, k=15, N=1024, batch 256 (4 blocks), the bench's 6x128
skip-3 network; the render at 32^2 over the blob at icosphere 2."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench as jax_bench
from intrinsic_neural_fields_tpu.data.sampler import RayData as JaxRayData
from intrinsic_neural_fields_tpu.data.sampler import precompute_hit_features as jax_precompute
from intrinsic_neural_fields_tpu.models import init_model
from intrinsic_neural_fields_tpu.models import make_model as jax_make_model
from intrinsic_neural_fields_tpu.render.renderer import Renderer as JaxRenderer
from intrinsic_neural_fields_tpu.train.steps import create_train_state as jax_create_state
from intrinsic_neural_fields_tpu.train.steps import make_epoch_fns as jax_epoch_fns
from tools.make_synthetic_dataset import blob_mesh as jax_blob_mesh

from intrinsic_neural_fields_tpu_torch import bench
from intrinsic_neural_fields_tpu_torch.models import make_model
from intrinsic_neural_fields_tpu_torch.train.steps import eager_step
from intrinsic_neural_fields_tpu_torch.utils.weights import (
    adam_state_from_optax,
    state_dict_from_flax,
)

torch.set_num_threads(2)

SMALL_V, SMALL_K, SMALL_N, SMALL_B = 120, 15, 1024, 256
CFG = bench.model_config(SMALL_K)
LR = 1e-4  # bench.py's Adam


@pytest.fixture(scope="module")
def models():
    """The JAX model with bench.py's init_model weights, and the port's
    TextureField carrying them."""
    jmodel = jax_make_model(CFG)
    variables = init_model(jmodel, CFG)
    tmodel = make_model(CFG, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]), CFG))
    return jmodel, variables, tmodel


def _flat(sd):
    return np.concatenate([np.asarray(sd[k]).ravel() for k in sorted(sd)])


def test_make_arrays_equals_bench_py(monkeypatch):
    """The same numpy draws as root bench.py's make_arrays, to the bit."""
    for name, value in (("V", 64), ("K", 15), ("N", 1024)):
        monkeypatch.setattr(jax_bench, name, value)
    want = jax_bench.make_arrays()
    got = bench.make_arrays(V=64, K=15, N=1024)
    assert [a.shape for a in got] == [(64, 15), (1024, 3), (1024, 3), (1024, 3)]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_train_leg_tracks_the_jax_fused_blocks_epoch(models):
    """bench.py's bench_ours on the JAX package (fused blocks epochs, Pallas
    in interpret mode) against the port's train_leg on the same arrays and
    weights, the same epoch keys (the leg draws JAX's block orders from
    PRNGKey(0) and fold_in(key, 1), as bench.py does), a warm epoch and
    one timed group of one epoch each. The leg runs the kernels' plain twins, not the eager
    step. Losses agree to rtol 2e-3 (tests/test_torch_port_train.py's
    bound) and the loss drop between the epochs to rtol 5e-2. At bench.py's
    lr of 1e-4 over 8 steps a weight moves by at most 8e-4, so the weights
    are held by what the leg changed: the update (params minus the initial
    weights) and Adam's mu each within 5e-2 of JAX's in L2 norm relative to
    JAX's (measured 2.4e-2 and 1.7e-2: Adam's update of a gradient near 0
    whose sign flips under rounding noise is up to lr either way). A leg
    that left the weights alone, or stepped at twice the lr, is off by 1."""
    jmodel, variables, tmodel = models
    arrays = bench.make_arrays(V=SMALL_V, K=SMALL_K, N=SMALL_N)
    feats, vids, bary, rgbs = arrays
    jd = jax_precompute(JaxRayData(
        features=jnp.asarray(feats), feature_strategy="efuncs",
        vertex_idxs_of_hit_faces=jnp.asarray(vids), barycentric_coords=jnp.asarray(bary),
        expected_rgbs=jnp.asarray(rgbs), unit_ray_dirs=None, face_idxs=None),
        dtype=jnp.bfloat16)
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    j_epoch, _ = jax_epoch_fns(jmodel, opt, "L1", shuffle="blocks", fused=True)
    jst = jax_create_state(jax.tree_util.tree_map(jnp.array, variables), opt)
    nb = SMALL_N // SMALL_B
    key = jax.random.PRNGKey(0)
    keys = [key, jax.random.fold_in(key, 1)]  # bench_ours: the warm epoch, then epoch 1
    jlosses = []
    for k in keys:
        jst, jm = j_epoch(jst, k, jd, nb, SMALL_B)
        jlosses.append(float(jm["loss"]))

    before = eager_step.launches
    leg = bench.train_leg(arrays, device="cpu", epochs=1, group=1, batch=SMALL_B, model=tmodel)
    assert eager_step.launches == before
    assert leg.steps_per_epoch == nb and len(leg.epoch_s) == 1
    assert leg.rays_per_s_best > 0 and leg.launches_per_step == {}
    np.testing.assert_allclose(leg.losses, jlosses, rtol=2e-3)
    np.testing.assert_allclose(np.diff(leg.losses), np.diff(jlosses), rtol=5e-2)
    st = leg.state
    init = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables["params"]), CFG)
    jparams = jax.tree_util.tree_map(np.asarray, jax.device_get(jst.params))
    dp = _flat(st.state_dict()) - _flat(init)
    dj = _flat(state_dict_from_flax(jparams, CFG)) - _flat(init)
    assert np.linalg.norm(dj) > 0
    assert np.linalg.norm(dp - dj) <= 5e-2 * np.linalg.norm(dj)
    adam = adam_state_from_optax(jax.device_get(jst.opt_state), CFG)
    mp, mj = _flat(st.layout.state_dict(st.mu)), _flat(adam["mu"])
    assert np.linalg.norm(mp - mj) <= 5e-2 * np.linalg.norm(mj)
    assert st.count == adam["count"] == 2 * nb


@pytest.fixture(scope="module")
def render(models):
    return bench.render_leg(device="cpu", frames=2, H=32, subdivisions=2, k=SMALL_K,
                            model=models[2])


def test_render_leg_frames_equal_the_port_renderer(render):
    """Each pipelined frame is the port Renderer's render of its camera, to
    the bit; bench.py's orbit and intrinsics."""
    assert len(render.images) == len(render.cams) == 2
    assert render.renderer.infer_mode == "plain" and render.launches_per_frame == [0, 0]
    assert render.rays_per_s_best > 0 and len(render.pass_s) == 3
    np.testing.assert_array_equal(render.K, np.array(
        [[1.2 * 32, 0, 15.5], [0, 1.2 * 32, 15.5], [0, 0, 1]], np.float32))
    for cam, img in zip(render.cams, render.images):
        np.testing.assert_array_equal(img, render.renderer.render(cam, render.K))


def test_render_leg_agrees_with_the_jax_renderer(models, render):
    """bench.py's bench_render_ours on the JAX package (the fused forward in
    interpret mode) at the same size: the same mesh, basis, weights,
    cameras and bf16 table. On the f16 wire, the port Renderer built as the
    leg builds it is within 2e-3 of JAX, tests/test_torch_port_render.py's
    bound (both sides run bf16-operand, f32-accumulate matmuls; only the
    summation order differs), with equal background pixels. On the u8 wire
    the leg's frames are within one 8-bit step of JAX's: rounding to 8 bits
    can carry two values 2e-3 apart onto neighbouring steps."""
    jmodel, variables, tmodel = models
    mesh = jax_blob_mesh(subdivisions=2)
    np.testing.assert_array_equal(mesh.vertices, render.renderer.mesh.vertices)
    efuncs = np.random.default_rng(0).normal(size=(mesh.vertices.shape[0], SMALL_K))
    efuncs = efuncs.astype(np.float32)
    port_f16 = bench.Renderer(tmodel, render.renderer.mesh, efuncs, H=32, W=32,
                              feature_dtype="bfloat16", device="cpu")
    for wire_u8 in (False, True):
        jr = JaxRenderer(jmodel, variables, mesh, eigenfunctions=efuncs, H=32, W=32,
                         feature_dtype="bfloat16", wire_u8=wire_u8, infer="fused")
        for cam, img in zip(render.cams, render.images):
            ref, hits = jr.render(cam, render.K, eval_render=True)
            if not wire_u8:
                img, port_hits = port_f16.render(cam, render.K, eval_render=True)
                np.testing.assert_array_equal(np.sort(port_hits), np.sort(hits))
            bg = np.ones(32 * 32, bool)
            bg[hits] = False
            bg = bg.reshape(32, 32)
            assert bg.any() and (~bg).any()
            np.testing.assert_array_equal(img[bg], ref[bg])
            # one 8-bit step, and the f32 rounding of k / 255
            np.testing.assert_allclose(img, ref, rtol=0,
                                       atol=1 / 255 + 1e-6 if wire_u8 else 2e-3)


def test_main_prints_bench_py_line_last(monkeypatch, capsys):
    """main(["--device", "cpu"]) at a small size: the last line is one JSON
    object with bench.py's eight keys, every number finite and positive;
    the legs' lines come before it."""
    for name, value in (("V", SMALL_V), ("K", SMALL_K), ("N", 4096), ("BATCH", 64),
                        ("EPOCHS", 2), ("GROUP", 1), ("FRAMES", 2), ("RENDER_H", 32),
                        ("SUBDIVISIONS", 2)):
        monkeypatch.setattr(bench, name, value)
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu"
    legs = [json.loads(ln)["leg"] for ln in lines[1:-1]]
    assert legs == ["baseline", "train", "render"]
    line = json.loads(lines[-1])
    assert sorted(line) == sorted(["metric", "value", "unit", "vs_baseline", "median_value",
                                   "median_vs_baseline", "render_rays_per_sec",
                                   "render_vs_baseline"])
    assert (line["metric"], line["unit"]) == ("train_rays_per_sec", "rays/s")
    nums = [v for k, v in line.items() if k not in ("metric", "unit")]
    assert all(np.isfinite(v) and v > 0 for v in nums), line


def test_cuda_device_raises_without_a_card():
    """--device cuda (the default) never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
