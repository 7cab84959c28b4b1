"""Evaluate a trained field on another mesh with no functional-map
alignment: the control rows of the transfer experiment (JAX package
tools/eval_on_mesh.py).

  python -m intrinsic_neural_fields_tpu_torch.eval_on_mesh \
      --config_path out/synthetic/xyz_blob/config.yaml \
      --target_mesh data/transfer_hq/deformed.obj \
      --eval_dataset data/transfer_hq/deformed_views --eval_split test \
      --out_dir out/transfer_hq/deformed_xyz [--efuncs target_basis.npy] [--device cuda]

- An extrinsic field (xyz / ff / rff) reads the target's vertex positions.
  On a re-discretisation of the same surface the positions are unchanged
  and the texture survives; on a deformed shape they moved and it cannot.
- An intrinsic field needs --efuncs: the target's own skip-first basis,
  standard rescale, swapped in with no alignment (the direct-swap row);
  sign and rotation ambiguity inside degenerate eigenvalue shells is what
  it fails on.
"""
import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config_path", required=True)
    p.add_argument("--target_mesh", required=True)
    p.add_argument("--eval_dataset", required=True)
    p.add_argument("--eval_split", default="test")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--efuncs",
                   help="target's own skip-first basis .npy (intrinsic direct-swap "
                        "baseline); omit for extrinsic fields")
    p.add_argument("--background", default="white")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def renderer_on_mesh(config, target_mesh_path, efuncs_path=None, device="cuda", infer=None):
    """The trained field of `config` (its out_dir's model.pt, or model.ckpt)
    rendered on the target mesh: its vertices for an extrinsic field, the basis at `efuncs_path`
    (first k functions, standard rescale) for an intrinsic one."""
    from .geometry.mesh import load_mesh
    from .render.renderer import make_renderer_from_config
    from .spectral.features import load_first_k_eigenfunctions

    target = load_mesh(target_mesh_path)
    renderer = make_renderer_from_config(config, device=device, infer=infer)
    renderer.set_mesh(target)
    if config["model"].get("feature_strategy", "efuncs") == "efuncs":
        if not efuncs_path:
            raise ValueError("--efuncs required for an intrinsic field")
        E = load_first_k_eigenfunctions(
            efuncs_path, config["model"]["k"],
            rescale_strategy=config["data"].get("rescale_strategy", "standard"))
        if E.shape[0] != target.num_vertices:
            raise ValueError(f"--efuncs has {E.shape[0]} rows, the target "
                             f"{target.num_vertices} vertices")
        renderer.set_eigenfunctions(E)
    return renderer


def main(argv=None):
    import os

    from .evaluation.eval_cli import evaluate_views
    from .train.config import load_config

    args = parse_args(argv)
    config = load_config(args.config_path)
    renderer = renderer_on_mesh(config, args.target_mesh, args.efuncs, device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    means, _ = evaluate_views(args.out_dir, config, args.eval_dataset, args.eval_split,
                              background=args.background, renderer=renderer)
    return means


if __name__ == "__main__":
    main()
