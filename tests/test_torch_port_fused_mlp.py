"""Port parity: the fused MLP's plain twin vs the reference Pallas kernel
(interpret mode), the port's TextureField vs the flax module, the weight
carry. The kernel itself is checked on the card by test_torch_port_cuda.py.

Inputs come from numpy seeds and cross between the frameworks as numpy."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from intrinsic_neural_fields_tpu.models import init_model
from intrinsic_neural_fields_tpu.models import make_model as jax_make_model
from intrinsic_neural_fields_tpu.ops.fused_mlp import FusedMLPSpec as JaxSpec
from intrinsic_neural_fields_tpu.ops.fused_mlp import make_fused_apply, params_to_list

from intrinsic_neural_fields_tpu_torch.models import make_model
from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (
    KC,
    OUT_PAD,
    FusedMLPSpec,
    fused_apply,
    fused_apply_plain,
    kernel_launches,
    pack_weights,
)
from intrinsic_neural_fields_tpu_torch.utils.weights import (
    load_reference_weights,
    state_dict_from_flax,
)

torch.set_num_threads(2)  # xdist runs several workers on the same cores


def _flax_setup(k, num_layers=4, hidden=128, skip=2, seed=1):
    cfg = {"k": k, "num_layers": num_layers, "mlp_hidden_dim": hidden,
           "skip_layer_idx": skip}
    model = jax_make_model(cfg)
    variables = init_model(model, cfg, seed=seed)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return cfg, model, variables, params


@pytest.mark.parametrize("k", [16, 130])
def test_plain_twin_matches_pallas_kernel(k):
    """Tolerance 2e-3: both sides round the same operands to bf16 and sum
    in f32; only the summation order differs, which can rarely flip the
    bf16 rounding of an h element (130 exercises the K padding)."""
    cfg, _, variables, params = _flax_setup(k)
    x = np.random.default_rng(0).normal(size=(512, k)).astype(np.float32)
    spec = JaxSpec(num_layers=4, k_in=k, hidden=128, skip_idx=2)
    x_pad = jnp.pad(jnp.asarray(x), ((0, 0), (0, spec.k_pad - k)))
    ref = make_fused_apply(spec, batch_tile=256, interpret=True)(
        params_to_list(spec, variables["params"]), x_pad)

    fw = pack_weights(FusedMLPSpec(4, k, 128, 2), state_dict_from_flax(params, cfg))
    got = fused_apply_plain(fw, torch.from_numpy(x))
    assert got.shape == (512, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-3)


def test_fused_apply_on_cpu_is_the_plain_twin():
    cfg, _, _, params = _flax_setup(40)
    fw = pack_weights(FusedMLPSpec(4, 40, 128, 2), state_dict_from_flax(params, cfg))
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(77, 40)).astype(np.float32))
    before = kernel_launches()["fused_mlp_fwd"]
    np.testing.assert_array_equal(fused_apply(fw, x).numpy(),
                                  fused_apply_plain(fw, x).numpy())
    # the counter counts kernel launches only
    assert kernel_launches()["fused_mlp_fwd"] == before


def test_texture_field_matches_flax():
    """The f32 module on weights carried by state_dict_from_flax: only f32
    summation order differs (tolerance 1e-5)."""
    cfg, model, variables, params = _flax_setup(24, num_layers=6, hidden=64, skip=3)
    x = np.random.default_rng(3).normal(size=(256, 24)).astype(np.float32)
    ref = np.asarray(model.apply(variables, {"eigenfunctions": jnp.asarray(x)}))
    tm = make_model(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_flax(params, cfg))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_reference_export_loads_into_port(tmp_path):
    """A model.pt written from the JAX package's export_reference_state_dict
    loads with load_reference_weights and equals state_dict_from_flax."""
    from intrinsic_neural_fields_tpu.utils.torch_convert import export_reference_state_dict

    cfg, _, variables, params = _flax_setup(12)
    sd_ref = export_reference_state_dict(jax.device_get(variables), cfg)
    path = tmp_path / "model.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd_ref.items()}, path)
    loaded = load_reference_weights(str(path))
    carried = state_dict_from_flax(params, cfg)
    assert set(loaded) == set(carried)
    for key in carried:
        np.testing.assert_array_equal(loaded[key].numpy(), carried[key].numpy())
    make_model(cfg, device="cpu").load_state_dict(loaded)  # keys and shapes fit the module


def test_pack_weights_layout():
    spec = FusedMLPSpec(6, 130, 128, 3)
    sd = make_model({"k": 130, "num_layers": 6, "mlp_hidden_dim": 128,
                     "skip_layer_idx": 3}, device="cpu").state_dict()
    fw = pack_weights(spec, sd)
    assert spec.k_w % KC == 0 and spec.k_w >= 130
    shapes = [tuple(m.shape) for m in fw.mats]
    assert shapes == [(spec.k_w, 128), (128, 128), (128, 128), (128, 128),
                      (spec.k_w, 128), (128, 128), (128, OUT_PAD)]
    assert fw.w.dtype == torch.bfloat16 and fw.b.dtype == torch.float32
    # zero padding: padded input rows and head columns carry nothing
    assert not fw.mats[0][130:].any() and not fw.mats[-1][:, 3:].any()
    assert not fw.biases[-1][3:].any()
