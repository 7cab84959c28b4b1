"""The plain reference against the port's CPU path at a small size."""
import numpy as np
import pytest
import torch

from benchmark import inputs, reference
from benchmark.common import Ctx
from benchmark.train_cell import model_config


def _port_model(cfg, mesh):
    from intrinsic_neural_fields_tpu_torch.models import make_model

    model = make_model(model_config(cfg), seed=0, device="cpu", mesh=mesh)
    p = inputs.initial_weights({k: tuple(v.shape) for k, v in model.state_dict().items()},
                               inputs.generator(3, "cpu"), "cpu")
    model.load_state_dict(p)
    return model, p


@pytest.mark.parametrize("name", ["intrinsic_cat", "viewdep_intrinsic_blob"])
def test_field_forward_matches_the_port_module(small_bench, name):
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import Mesh
    from intrinsic_neural_fields_tpu_torch.models.texture_field import view_encoder_apply

    _, reg = small_bench
    cfg = reg.config(name)
    a = inputs.train_arrays(cfg, 4, "cpu")
    mesh = Mesh(a["vertices"], a["faces"]) if "vertices" in a else None
    model, p = _port_model(cfg, mesh)
    x = reference.interpolate(a["basis"], a["vids"][:512], a["bary"][:512])
    vd = cfg["model"].get("view_dependence")
    with torch.no_grad():
        if vd is None:
            want, venc = model(x), None
        else:
            dirs, faces = a["dirs"][:512], a["face_idxs"][:512]
            want = model(x, dirs, faces)
            normals = torch.as_tensor(inputs.face_normals(a["vertices"], a["faces"]),
                                      dtype=torch.float32)
            venc = reference.view_encoding(dirs, normals[faces], vd)
            assert torch.allclose(venc, view_encoder_apply(model)(dirs, faces), atol=2e-6)
        got = reference.field_forward(p, cfg, x, venc)
    assert torch.allclose(got, want, atol=1e-6)


def test_tracer_matches_the_port_tracer():
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import Mesh
    from intrinsic_neural_fields_tpu_torch.models import make_model
    from intrinsic_neural_fields_tpu_torch.render.renderer import Renderer

    v, f = inputs.blob(3)
    H = W = 64
    K = inputs.intrinsics(H, W, 1.2)
    cam = inputs.orbit({"views": 5, "radius": 3.0, "height": 0.35}, 1)[2]
    model = make_model({"k": 8, "num_layers": 4, "mlp_hidden_dim": 128, "skip_layer_idx": 2},
                       device="cpu")
    r = Renderer(model, Mesh(v, f), np.zeros((len(v), 8), np.float32), H=H, W=W, device="cpu")
    tr = r.trace_view(cam, K)
    port_face = torch.full((H * W,), -1, dtype=torch.int64)
    port_face[tr.pix_idx] = torch.where(tr.valid, tr.face_idxs, torch.full_like(tr.face_idxs, -1))
    port_bary = torch.zeros(H * W, 3)
    port_bary[tr.pix_idx] = tr.bary
    face, bary, amb = reference.trace_view(torch.as_tensor(v), torch.as_tensor(f), cam, K, H, W)
    ok = ~amb
    assert int(amb.sum()) < 0.01 * H * W
    assert (face >= 0).sum() > 0.2 * H * W
    assert torch.equal(face[ok], port_face[ok])
    hit = ok & (face >= 0)
    assert torch.allclose(bary[hit].float(), port_bary[hit], atol=2e-4)


@pytest.mark.parametrize("name", ["intrinsic_cat", "viewdep_intrinsic_blob"])
def test_program_steps_follow_the_reference(small_bench, name):
    """The port's CPU train path (its kernels' plain twins, bf16 operands)
    against the f32 reference over the check steps and the check epoch:
    within the limits, and the f32 reference put in the program's place
    reads nought."""
    from benchmark.train_cell import TrainCell

    _, reg = small_bench
    w = reg.workload(f"{name}.train_blocks")
    ctx = Ctx(cfg=reg.config(name), traffic=reg.traffic(w["traffic"]),
              limits=reg.limits(w["name"]), seed=12, seconds=0.1, trace=False,
              device=torch.device("cpu"))
    cell = TrainCell(ctx)
    cell.setup()
    cell.window(0.1)
    numbers = cell.check()
    assert all(v <= ctx.limits[k] for k, v in numbers.items()), numbers
    same = cell.check(q=lambda t: t)
    assert all(v < 1e-5 for v in same.values()), same
