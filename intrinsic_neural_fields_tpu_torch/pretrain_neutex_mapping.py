"""NeuTex mapping pretraining through the port (the counterpart of
tools/pretrain_neutex_mapping.py, same flags and loss): the sphere ->
surface decoder (Atlasnet) and the surface -> sphere inverse
(InverseAtlasnet) are optimized jointly with the symmetric chamfer
distance between the mesh's vertices and the decoded sphere samples plus
the uv cycle loss, Adam at --lr.

  python -m intrinsic_neural_fields_tpu_torch.pretrain_neutex_mapping mesh.obj out.npz \
      [--iterations 200000] [--points 25000] [--max_mesh_points 30000] [--lr 1e-4] \
      [--seed 0] [--print_every 500] [--steps_per_call 50] [--device cuda]

A plain loop: each iteration is an f32 autograd step through
``torch.func.functional_call`` on views of the flat mapping parameters
(train/steps.py:ModuleLayout), then the standalone Adam kernel
(``fused_adam_apply``) on the flat gradient. The losses stay on the device;
the host reads them every --steps_per_call iterations (the JAX tool's
iterations per jitted call), so ceil(iterations / steps_per_call) *
steps_per_call iterations run, as there. The draws are the JAX tool's
(utils/jax_random.py): the initial weights its flax init under
PRNGKey(--seed), the sphere samples of iteration i of call c
``normal(split(fold_in(PRNGKey(--seed), c), --steps_per_call)[i], (points,
3))``, computed on the device, and the mesh subsample numpy's
default_rng(--seed).

The output .npz has the JAX package's '/'-joined flax keys
(net_inverse_atlasnet_3d_to_uv/encoder_0/linear1/kernel, ...), so it plugs
into model.pretrained_path of a ``type: neutex`` config in either package.
"""
import argparse
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("mesh_path")
    p.add_argument("out_path", help=".npz mapping checkpoint")
    p.add_argument("--iterations", type=int, default=200_000)
    p.add_argument("--points", type=int, default=25_000,
                   help="sphere samples per iteration (reference: 25000)")
    p.add_argument("--max_mesh_points", type=int, default=30_000,
                   help="subsample mesh vertices above this for the chamfer target")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--print_every", type=int, default=500)
    p.add_argument("--steps_per_call", type=int, default=50,
                   help="iterations between host reads of the losses")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _mapping_module():
    import torch

    from .models.neutex import Atlasnet, InverseAtlasnet, chamfer_distance

    class MappingPretrainer(torch.nn.Module):
        """The two mapping networks and the pretraining loss."""

        def __init__(self):
            super().__init__()
            self.net_inverse_atlasnet_3d_to_uv = InverseAtlasnet()
            self.net_atlasnet_uv_to_3d = Atlasnet()

        def forward(self, uv, verts):
            """uv [N, 3] sphere samples, verts [V, 3] -> (loss, chamfer, cycle)."""
            points3d = self.net_atlasnet_uv_to_3d(uv[:, None, :])[:, 0, :]
            chamfer = chamfer_distance(verts, points3d)
            inv_uv, _, _ = self.net_inverse_atlasnet_3d_to_uv(points3d)
            cycle = ((uv - inv_uv[:, 0, :]) ** 2).sum(-1).mean()
            return chamfer + cycle, chamfer, cycle

    return MappingPretrainer()


def main(argv=None):
    """Returns the losses of every iteration, [iterations, 3] float32
    (loss, chamfer, cycle)."""
    import torch

    from . import resolve_device
    from .geometry.mesh import load_mesh
    from .models.factory import neutex_params
    from .models.neutex import (MAPPING_NETS, mapping_state_dicts_from_flax,
                                mapping_tree_from_module, sample_sphere_points)
    from .ops.fused_mlp import adam_hyper_rows, fused_adam_apply
    from .train.steps import ModuleLayout
    from .utils.checkpoint import save_npz_pytree
    from .utils.jax_random import PRNGKey, fold_in, split

    args = parse_args(argv)
    dev = resolve_device(args.device)
    verts = np.asarray(load_mesh(args.mesh_path).vertices, dtype=np.float32)
    if verts.shape[0] > args.max_mesh_points:
        sel = np.random.default_rng(args.seed).choice(verts.shape[0], args.max_mesh_points,
                                                      replace=False)
        verts = verts[sel]
    verts_d = torch.as_tensor(verts, device=dev)

    model = _mapping_module()
    key = PRNGKey(args.seed)
    init = neutex_params(key, prefix=(), texture=False)
    for net, sd in zip(MAPPING_NETS, mapping_state_dicts_from_flax(*(init[n] for n in
                                                                     MAPPING_NETS))):
        getattr(model, net).load_state_dict(sd)
    model.to(dev)
    layout = ModuleLayout(model)
    params = layout.flat_from_state_dict(model.state_dict(), dev)
    m, v = torch.zeros_like(params), torch.zeros_like(params)

    spc = args.steps_per_call
    n_calls = -(-args.iterations // spc)
    hist = torch.zeros((n_calls * spc, 3), dtype=torch.float32, device=dev)
    t0 = time.time()
    for call in range(n_calls):
        hyper = adam_hyper_rows(call * spc + 1 + torch.arange(spc), args.lr, device=dev)
        for i, k in enumerate(split(fold_in(key, call), spc)):
            uv = sample_sphere_points(k, args.points, dev)
            p = params.detach().requires_grad_()
            loss, chamfer, cycle = torch.func.functional_call(model, layout.views(p),
                                                              (uv, verts_d))
            loss.backward()
            fused_adam_apply(params, m, v, hyper[i], p.grad)
            hist[call * spc + i] = torch.stack((loss, chamfer, cycle)).detach()
        it = (call + 1) * spc
        if it % args.print_every < spc:
            loss, chamfer, cycle = hist[it - 1].tolist()
            print(f"Iteration {it:7d}/{args.iterations:7d}  Loss: {loss:.6f}  "
                  f"Chamfer: {chamfer:.6f}  Cycle: {cycle:.6f}  "
                  f"({it / (time.time() - t0):.0f} it/s)", flush=True)

    model.load_state_dict(layout.state_dict(params))
    save_npz_pytree(args.out_path, {net: mapping_tree_from_module(getattr(model, net))
                                    for net in MAPPING_NETS})
    print(f"Saved pretrained mapping to {args.out_path}")
    return hist.cpu().numpy()


if __name__ == "__main__":
    main()
