"""Port parity of the training kernels' plain twins against the reference
Pallas kernels (interpret mode on the CPU): the train-grads body, Adam
alone and composed, the forward's VJP, the hyper rows. The CUDA kernels
themselves are held to these twins on the card (test_torch_port_cuda.py).

Inputs come from numpy seeds and cross between the frameworks as numpy.
Sizes follow tests/test_fused_adam.py: 4 layers x 128, skip 1, k=60."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from intrinsic_neural_fields_tpu.models import init_model
from intrinsic_neural_fields_tpu.models import make_model as jax_make_model
from intrinsic_neural_fields_tpu.ops.fused_mlp import FusedMLPSpec as JaxSpec
from intrinsic_neural_fields_tpu.ops.fused_mlp import (
    adam_hyper_rows as jax_hyper_rows,
    grads_to_flax,
    make_fused_adam_apply,
    make_fused_apply,
    make_fused_train_adam,
    make_fused_train_grads,
    params_to_list,
)

from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (
    FusedMLPSpec,
    ParamLayout,
    adam_apply_plain,
    adam_hyper_rows,
    fused_adam_apply,
    fused_apply_plain,
    fused_apply_trainable,
    accumulate_loss,
    fused_train_adam,
    fused_train_adam_step,
    fused_train_grads,
    fwd_bwd_plain,
    kernel_launches,
    make_train_scratch,
    pack_weights,
    train_grads_plain,
    wgrad_adam_plain,
    wgrad_plain,
)
from intrinsic_neural_fields_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(2)  # xdist runs several workers on the same cores

K, L, SKIP, N, B, TILE = 60, 4, 1, 1024, 256, 128
CFG = {"k": K, "num_layers": L, "mlp_hidden_dim": 128, "skip_layer_idx": SKIP}
# Gradients: both sides round the same operands to bf16 and sum in f32 in
# different orders, which now and then moves a hidden activation or delta
# to the neighbouring bf16 value; per tensor max|d|/max|g| stays under
# ~5e-4 here (measured), held to 2e-3.
GRAD_TOL = 2e-3


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    variables = init_model(jax_make_model(CFG), CFG, seed=1)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    jspec = JaxSpec(num_layers=L, k_in=K, hidden=128, skip_idx=SKIP)
    layout = ParamLayout(FusedMLPSpec(L, K, 128, SKIP))
    flat = layout.flat_from_state_dict(state_dict_from_flax(params, CFG))
    feats = rng.normal(size=(N, K)).astype(np.float32)
    gt = rng.uniform(size=(N, 3)).astype(np.float32)
    return {"jspec": jspec, "wb": params_to_list(jspec, variables["params"]),
            "layout": layout, "flat": flat, "feats": feats, "gt": gt}


def _port_grads_of(layout, flat_grads):
    """Flat port grads -> torch-layout dict (real rows/cols only)."""
    return layout.state_dict(flat_grads)


def _jax_grads_of(jspec, grad_list):
    flax = jax.tree_util.tree_map(np.asarray, grads_to_flax(jspec, grad_list))
    return state_dict_from_flax(flax, CFG)


def _assert_grads_close(got, want, tol=GRAD_TOL):
    for name in want:
        scale = float(want[name].abs().max())
        err = float((got[name] - want[name]).abs().max())
        assert err <= tol * max(scale, 1e-30), (name, err, scale)


@pytest.mark.parametrize("loss_type", ["L1", "L2", "cauchy"])
def test_train_grads_gathered_matches_pallas(setup, loss_type):
    s = setup
    x = s["feats"][:B]
    run = make_fused_train_grads(s["jspec"], loss_type, batch_tile=TILE, interpret=True)
    g_ref, l_ref, sq_ref = run(s["wb"], jnp.pad(jnp.asarray(x), ((0, 0), (0, 128 - K))),
                               jnp.asarray(s["gt"][:B]))
    grads, loss_sum, sq_sum = fused_train_grads(
        s["layout"], s["flat"], torch.from_numpy(x), torch.from_numpy(s["gt"][:B]),
        loss_type=loss_type)
    # loss sums: one f32 sum over 768 elements in another order (rtol 1e-5)
    np.testing.assert_allclose(float(loss_sum), float(l_ref), rtol=1e-5)
    np.testing.assert_allclose(float(sq_sum), float(sq_ref), rtol=1e-5)
    _assert_grads_close(_port_grads_of(s["layout"], grads), _jax_grads_of(s["jspec"], g_ref))


def test_train_grads_streaming_bf16_table_matches_pallas(setup):
    """The streaming contract: a bf16 [N, k] table, the batch at a block
    offset given in batch units."""
    s = setup
    table = s["feats"].astype(jnp.bfloat16)
    run = make_fused_train_grads(s["jspec"], "L1", batch_tile=TILE, interpret=True,
                                 stream=True)
    blk = 2
    gt = s["gt"][blk * B:(blk + 1) * B]
    g_ref, l_ref, _ = run(s["wb"], jnp.pad(jnp.asarray(table), ((0, 0), (0, 128 - K))),
                          jnp.asarray(gt), blk * (B // TILE), B)
    t_table = torch.from_numpy(np.asarray(table, np.float32)).to(torch.bfloat16)
    grads, loss_sum, _ = fused_train_grads(s["layout"], s["flat"], t_table,
                                           torch.from_numpy(gt), blk, B)
    np.testing.assert_allclose(float(loss_sum), float(l_ref), rtol=1e-5)
    _assert_grads_close(_port_grads_of(s["layout"], grads), _jax_grads_of(s["jspec"], g_ref))
    # pads of the flat gradient are exactly zero (lanes past k_in, head cols past 3)
    lay = s["layout"]
    assert not lay.mats(grads)[0][K:].any() and not lay.mats(grads)[-1][:, 3:].any()
    assert not lay.biases(grads)[-1][3:].any()


def test_adam_plain_matches_pallas_adam_apply(setup):
    """Same f32 expressions in the same order: equal within a few ulp of
    each tensor's scale (XLA's CPU code may fuse a product and a sum into
    one multiply-add; torch rounds each, as the CUDA kernel built with
    -fmad=false does; where (1-b1)g and b1*m cancel, an ulp of the terms
    is a larger share of the result)."""
    s = setup
    rng = np.random.default_rng(3)
    lay, flat = s["layout"], s["flat"]
    g = torch.from_numpy(rng.normal(size=lay.n).astype(np.float32)) * 1e-3
    m = torch.from_numpy(rng.normal(size=lay.n).astype(np.float32)) * 1e-4
    v = torch.from_numpy(rng.uniform(size=lay.n).astype(np.float32)) * 1e-6
    # keep the pads at zero, as the layout guarantees
    mask = lay.flat_from_state_dict({k: torch.ones_like(t) for k, t in lay.state_dict(flat).items()})
    g, m, v = g * mask, m * mask, v * mask
    hyper = adam_hyper_rows(torch.tensor([5]), 3e-3)[0]
    new = adam_apply_plain(flat, m, v, hyper, g)

    def to_list(t):
        sd = lay.state_dict(t)
        return params_to_list(s["jspec"], _flax_from_sd(sd))

    ref = make_fused_adam_apply(s["jspec"], interpret=True)(
        to_list(flat), to_list(m), to_list(v), jax_hyper_rows(jnp.array([5]), 3e-3)[0:1],
        to_list(g))
    for got, want in zip(new, ref):
        want_sd = _jax_grads_of(s["jspec"], want)
        got_sd = lay.state_dict(got)
        for name in want_sd:
            w = want_sd[name].numpy()
            np.testing.assert_allclose(got_sd[name].numpy(), w, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(w).max()))
    # the in-place wrapper on the CPU is the plain twin
    p2, m2, v2 = flat.clone(), m.clone(), v.clone()
    before = kernel_launches()["fused_adam"]
    fused_adam_apply(p2, m2, v2, hyper, g)
    assert kernel_launches()["fused_adam"] == before
    for a, b in zip((p2, m2, v2), new):
        assert torch.equal(a, b)


def _flax_from_sd(sd):
    """Torch-layout state dict -> flax TextureField params (CFG)."""
    out, c = {}, 0
    for i in range(L):
        prefixes = [f"layers.{i}.Lx", f"layers.{i}.Ly"] if i == SKIP else [f"layers.{i}.0"]
        for p in prefixes:
            out[f"Dense_{c}"] = {"kernel": jnp.asarray(sd[p + ".weight"].numpy().T),
                                 "bias": jnp.asarray(sd[p + ".bias"].numpy())}
            c += 1
    return out


def test_hyper_rows_match_reference():
    got = adam_hyper_rows(torch.arange(1, 9), 1e-4)
    want = np.asarray(jax_hyper_rows(jnp.arange(1, 9), 1e-4))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-7)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_adam_matches_pallas_train_adam(setup, steps):
    """fused_train_adam vs make_fused_train_adam on a bf16 table, chained
    over `steps` steps: the loss sums to 1e-5 at every step, the params to
    atol 1e-6 after one step and to the JAX package's own chained bound
    (tests/test_fused_adam.py: atol 3e-6) after three — except that Adam's
    first steps move every weight by about lr whatever the size of its
    gradient, so an element whose gradient is ~0 and flips sign under the
    bf16 rounding noise (see GRAD_TOL) ends up to 2*lr per step away. At
    most 0.1% of the elements may do so, and none by more than that."""
    s = setup
    lay = s["layout"]
    table = s["feats"].astype(jnp.bfloat16)
    j_table = jnp.pad(jnp.asarray(table), ((0, 0), (0, 128 - K)))
    t_table = torch.from_numpy(np.asarray(table, np.float32)).to(torch.bfloat16)
    lr = 5e-3
    run = make_fused_train_adam(s["jspec"], "L1", batch_tile=TILE, interpret=True)
    wb = list(s["wb"])
    jm = [jnp.zeros_like(w) for w in wb]
    jv = [jnp.zeros_like(w) for w in wb]
    p, m, v = s["flat"].clone(), torch.zeros(lay.n), torch.zeros(lay.n)
    hyper = adam_hyper_rows(torch.arange(1, steps + 1), lr)
    for t in range(steps):
        blk = (t * 3) % (N // B)
        gt = s["gt"][blk * B:(blk + 1) * B]
        wb, jm, jv, l_ref, _ = run(wb, jm, jv, jax_hyper_rows(jnp.array([t + 1]), lr)[0:1],
                                   j_table, jnp.asarray(gt), blk * (B // TILE), B)
        loss_sum, _ = fused_train_adam(lay, p, m, v, hyper[t], t_table, torch.from_numpy(gt),
                                       blk, B)
        np.testing.assert_allclose(float(loss_sum), float(l_ref), rtol=1e-5)
    atol = 1e-6 if steps == 1 else 3e-6
    want = _jax_grads_of(s["jspec"], wb)
    got = lay.state_dict(p)
    diff = np.concatenate([np.abs(got[k].numpy() - want[k].numpy()).ravel() for k in want])
    assert (diff > atol).mean() <= 1e-3, (diff > atol).sum()
    assert diff.max() <= 2 * lr * steps


def test_apply_vjp_matches_pallas_custom_vjp(setup):
    """The autograd backward of fused_apply_trainable (CPU: the plain twin
    of the cotangent-seeded kernels) vs jax.vjp of make_fused_apply."""
    s = setup
    rng = np.random.default_rng(11)
    x = s["feats"][:B]
    cot = rng.normal(size=(B, 3)).astype(np.float32)
    apply = make_fused_apply(s["jspec"], batch_tile=TILE, interpret=True)
    x_pad = jnp.pad(jnp.asarray(x), ((0, 0), (0, 128 - K)))
    out_ref, vjp = jax.vjp(lambda wb: apply(wb, x_pad), s["wb"])
    (g_ref,) = vjp(jnp.asarray(cot))

    p = s["flat"].clone().requires_grad_()
    out = fused_apply_trainable(s["layout"], p, torch.from_numpy(x))
    # forward: the plain twin of the forward kernel (tolerance as in
    # test_torch_port_fused_mlp: bf16 re-rounding of a hidden value)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), atol=2e-3)
    (out * torch.from_numpy(cot)).sum().backward()
    _assert_grads_close(_port_grads_of(s["layout"], p.grad), _jax_grads_of(s["jspec"], g_ref))


def test_layout_round_trip_and_packing(setup):
    lay, flat = setup["layout"], setup["flat"]
    sd = lay.state_dict(flat)
    assert torch.equal(lay.flat_from_state_dict(sd), flat)
    fw, fw2 = lay.pack(flat), pack_weights(lay.spec, sd)
    assert torch.equal(fw.w, fw2.w) and torch.equal(fw.b, fw2.b)
    x = torch.from_numpy(setup["feats"][:64])
    assert torch.equal(fused_apply_plain(fw, x), fused_apply_plain(fw2, x))
    assert lay.n == lay.n_w + sum(e.cols_pad for e in lay.entries)


def test_gathered_plain_twin_is_the_wrapper_on_cpu(setup):
    s = setup
    x = torch.from_numpy(s["feats"][:B]).to(torch.bfloat16)
    gt = torch.from_numpy(s["gt"][:B])
    before = kernel_launches()
    got = fused_train_grads(s["layout"], s["flat"], x, gt, loss_type="L2")
    want = train_grads_plain(s["layout"], s["flat"], x, gt, "L2")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert kernel_launches() == before


def test_optax_matches_adam_plain_after_grads(setup):
    """make_fused_train_grads + optax's own update == the plain grads + the
    plain Adam: the Adam twin is optax under inject_hyperparams."""
    s = setup
    lr = 1e-3
    x = s["feats"][:B]
    run = make_fused_train_grads(s["jspec"], "L1", batch_tile=TILE, interpret=True)
    g_ref, _, _ = run(s["wb"], jnp.pad(jnp.asarray(x), ((0, 0), (0, 128 - K))),
                      jnp.asarray(s["gt"][:B]))
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=lr)
    upd, _ = opt.update(g_ref, opt.init(s["wb"]), s["wb"])
    want = _jax_grads_of(s["jspec"], optax.apply_updates(s["wb"], upd))
    lay = s["layout"]
    # feed the reference's gradients to the plain Adam: only Adam differs
    g = lay.flat_from_state_dict(_jax_grads_of(s["jspec"], g_ref))
    p, _, _ = adam_apply_plain(s["flat"], torch.zeros(lay.n), torch.zeros(lay.n),
                               adam_hyper_rows(torch.tensor([1]), lr)[0], g)
    got = lay.state_dict(p)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=0, atol=1e-7)


def _random_moments(n, seed):
    """Adam moments random over the whole flat buffer, pads included: an
    entry an update skips keeps its m, one it updates twice gets another."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=n).astype(np.float32)) * 1e-4,
            torch.from_numpy(rng.uniform(size=n).astype(np.float32)) * 1e-6)


@pytest.mark.parametrize("table_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_wgrad_adam_plain_is_wgrad_then_adam(setup, table_dtype):
    """The twin of wgrad with its Adam epilogue equals wgrad_plain then
    adam_apply_plain, with the bf16 copy and the epoch accumulators, to the
    bit; every m entry moves (none skipped)."""
    s = setup
    lay, flat = s["layout"], s["flat"]
    x = torch.from_numpy(s["feats"][:B]).to(table_dtype)
    acts, deltas, bsum, l, q = fwd_bwd_plain(lay, flat, x, torch.from_numpy(s["gt"][:B]), "L1")
    m, v = _random_moments(lay.n, 1)
    hyper = adam_hyper_rows(torch.tensor([3]), 1e-3)[0]
    want = adam_apply_plain(flat, m, v, hyper, wgrad_plain(lay, x, acts, deltas, bsum))
    p2, m2, v2 = flat.clone(), m.clone(), v.clone()
    wb = torch.zeros(lay.n, dtype=torch.bfloat16)
    acc = torch.tensor([0.25, 0.5])
    wgrad_adam_plain(lay, x, acts, deltas, bsum, (l, q), p2, m2, v2, hyper, wb, acc)
    for got, w in zip((p2, m2, v2), want):
        assert torch.equal(got, w)
    assert torch.equal(wb, want[0].to(torch.bfloat16))
    assert torch.equal(acc, torch.tensor([0.25, 0.5]) + torch.stack((l / torch.tensor(3.0), q)))
    assert (m2 != m).all()


def test_step_with_device_indices_equals_host_step(setup):
    """fused_train_adam_step finds step i's block at order[i] * B, its
    targets in the whole table and its hyper row at hyper_all[i]: four
    steps give the bits of fused_train_adam on blocks order[0..3], and the
    accumulators those of accumulate_loss on its sums."""
    s = setup
    lay = s["layout"]
    table = torch.from_numpy(s["feats"]).to(torch.bfloat16)
    targets = torch.from_numpy(s["gt"])
    order = torch.tensor([3, 1, 0, 2])
    hyper_all = adam_hyper_rows(torch.arange(1, 5), 1e-3)
    m, v = _random_moments(lay.n, 2)
    p1, m1, v1 = s["flat"].clone(), m.clone(), v.clone()
    p2, m2, v2 = s["flat"].clone(), m.clone(), v.clone()
    sc1, sc2 = make_train_scratch(lay, B, p1), make_train_scratch(lay, B, p2)
    sums, acc, want_acc = torch.zeros(2), torch.zeros(2), torch.zeros(2)
    for i in range(4):
        fused_train_adam_step(lay, p1, m1, v1, hyper_all, order, i, table, targets, B, "L1",
                              sc1, sums, acc)
        blk = int(order[i])
        ls, ss = fused_train_adam(lay, p2, m2, v2, hyper_all[i], table,
                                  targets[blk * B:(blk + 1) * B], blk, B, "L1", sc2)
        accumulate_loss(want_acc, ls, ss)
        assert torch.equal(sums, torch.stack((ls, ss)))
    for a, b in ((p1, p2), (m1, m2), (v1, v2), (sc1.wb, sc2.wb), (acc, want_acc)):
        assert torch.equal(a, b)


def test_epoch_graph_key_follows_the_tensors(setup):
    """The key an epoch graph is cached on: equal for the same tensors, B
    and block count; another params tensor (a resume builds new ones),
    other buffers, B or block count give another key."""
    from types import SimpleNamespace

    from intrinsic_neural_fields_tpu_torch.train.steps import (AdamHyper, EpochBuffers, TrainState,
                                                               epoch_graph_key)

    s = setup
    lay = s["layout"]
    params = s["flat"].clone()
    state = TrainState(lay, params, torch.zeros(lay.n), torch.zeros(lay.n), 0, AdamHyper(1e-3))
    data = SimpleNamespace(hit_features=torch.from_numpy(s["feats"]).to(torch.bfloat16),
                           expected_rgbs=torch.from_numpy(s["gt"]))
    bufs = EpochBuffers.make(lay, B, 4, params)
    key = epoch_graph_key(state, data, bufs, B, 4, None)
    assert epoch_graph_key(state, data, bufs, B, 4, None) == key
    state.params = params.clone()
    assert epoch_graph_key(state, data, bufs, B, 4, None) != key
    state.params = params
    assert epoch_graph_key(state, data, bufs, B, 4, None) == key
    assert epoch_graph_key(state, data, EpochBuffers.make(lay, B, 4, params), B, 4, None) != key
    assert epoch_graph_key(state, data, bufs, B, 3, None) != key
    assert epoch_graph_key(state, data, bufs, 128, 4, None) != key
    data.hit_features = data.hit_features.float()
    assert epoch_graph_key(state, data, bufs, B, 4, None) != key


def test_epoch_graph_counts_what_its_capture_recorded(setup, monkeypatch):
    """An epoch graph's replay adds the launches the kernel wrappers counted
    while it was captured, whatever they were, and the capture itself adds
    none: a step that also launched the Adam kernel shows at every replay.
    The capture and the replay are faked (no card here); the step is
    replaced by one whose wrappers count two launches, and an Adam launch
    at step 1."""
    from contextlib import nullcontext
    from types import SimpleNamespace

    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import reset_kernel_launches
    from intrinsic_neural_fields_tpu_torch.train import steps

    class FakeGraph:
        def replay(self):
            pass

    def step(layout, params, m, v, hyper_all, order, i, *rest):
        counts = steps._launches
        counts["fused_mlp_fwd_bwd"] += 1
        counts["fused_mlp_wgrad_adam"] += 1
        counts["fused_adam"] += i == 1

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph: nullcontext())
    monkeypatch.setattr(steps, "prepare_train_kernels", lambda: None)
    monkeypatch.setattr(steps, "fused_train_adam_step", step)
    s, nb = setup, 4
    lay = s["layout"]
    state = steps.TrainState(lay, s["flat"].clone(), torch.zeros(lay.n), torch.zeros(lay.n), 0,
                             steps.AdamHyper(1e-3))
    data = SimpleNamespace(hit_features=torch.from_numpy(s["feats"]).to(torch.bfloat16),
                           expected_rgbs=torch.from_numpy(s["gt"]))
    hyper_all = adam_hyper_rows(torch.arange(1, nb + 1), 1e-3)
    graph = steps.EpochGraph()
    reset_kernel_launches()
    for epoch in (1, 2):
        graph.run(state, torch.arange(nb), data, nb, B, hyper_all, "L1", None)
        counts = {k: n for k, n in kernel_launches().items() if n}
        assert counts == {"fused_mlp_fwd_bwd": epoch * nb, "fused_mlp_wgrad_adam": epoch * nb,
                          "fused_adam": epoch}
    assert graph.captures == 1 and graph.replays == 2
    assert graph.launches == {"fused_mlp_fwd_bwd": nb, "fused_mlp_wgrad_adam": nb,
                              "fused_adam": 1}
