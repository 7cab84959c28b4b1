"""Texture transfer CLI of the port (root texture_transfer.py): render a
trained field on a DIFFERENT shape by mapping its eigenbasis through a
functional map built from a point-to-point correspondence.

  python -m intrinsic_neural_fields_tpu_torch.texture_transfer \
      --config_path cfg.yaml --target_mesh target.obj \
      --source_efuncs_full source_efuncs_full.npy \
      --target_efuncs_full efuncs_full_target.npy \
      --correspondence corr_target.npy --out_dir out/transfer \
      (--cameras_path cameras.npz | --eval_dataset DIR [--eval_split test]) \
      [--device cuda]

The correspondence is a .npy int array (target -> source vertex ids) or a
.mat in the reference's format (key "P", 1-based, cell [0,0][1]).
--eval_dataset evaluates the transferred field against a MeshViews dataset
of ground-truth views of the TARGET shape (masked PSNR / DSSIM / LPIPS,
images and the metrics pickle) instead of rendering bare cameras.

--source_efuncs_full must be the EXACT basis the model was trained on with
the constant eigenfunction spliced in front (an independent re-solve
rotates degenerate eigenvalue shells; `build_transferred_renderer` refuses
it). `python -m intrinsic_neural_fields_tpu_torch.make_transfer_targets`
writes both sides in this format. --laplacian_type keeps the root CLI's
choices; only cotan is ported (robust and pc_vert_robust raise).
"""
import argparse
import os

import numpy as np


def load_correspondence(path):
    if path.endswith(".npy"):
        return np.load(path).reshape(-1).astype(np.int64)
    if path.endswith(".mat"):
        import scipy.io

        mat = scipy.io.loadmat(path)
        # Reference notebooks: P = mat["P"][0,0][1] - 1 (1-based MATLAB ids).
        return (np.asarray(mat["P"][0, 0][1]).reshape(-1) - 1).astype(np.int64)
    raise ValueError(f"Unsupported correspondence format: {path}")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config_path", required=True)
    p.add_argument("--target_mesh", required=True)
    p.add_argument("--source_efuncs_full", required=True,
                   help=".npy UNRESCALED basis incl. constant (keep_first_efunc)")
    p.add_argument("--target_efuncs_full", required=True)
    p.add_argument("--correspondence", required=True, help=".npy or .mat (target->source)")
    p.add_argument("--cameras_path",
                   help="npz with world_mat_i / camera_mat_i entries (render mode)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--render_source_too", action="store_true")
    p.add_argument("--laplacian_type", default="cotan",
                   choices=("cotan", "robust", "pc_vert_robust"),
                   help="target mass matrix for the functional map — must "
                        "match the Laplacian the target basis was solved with")
    p.add_argument("--eval_dataset",
                   help="MeshViewsDataset dir of GT views of the TARGET shape "
                        "-> quantitative eval instead of bare renders")
    p.add_argument("--eval_split", default="test")
    p.add_argument("--background", default="white")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def build_transferred_renderer(config, target_mesh_path, source_efuncs_full,
                               target_efuncs_full, correspondence,
                               laplacian_type="cotan", device="cuda", infer=None):
    """Renderer for the trained field of `config` evaluated ON the target
    shape: same weights, target geometry, P2P-functional-map-aligned basis.
    infer: as for Renderer ("kernel" on the card by default)."""
    from .geometry.laplacian import build_laplacian
    from .geometry.mesh import load_mesh
    from .render.renderer import make_renderer_from_config
    from .transfer import check_source_basis_matches_trained, map_eigenfunctions_p2p

    strategy = config["model"].get("feature_strategy", "efuncs")
    if strategy != "efuncs":
        raise ValueError(f"a {strategy} field has no basis to map: evaluate it on the target "
                         "with eval_on_mesh")
    k = config["model"]["k"]
    target_mesh = load_mesh(target_mesh_path)
    E_src_full = np.load(source_efuncs_full)
    E_tgt_full = np.load(target_efuncs_full)
    _, M_tgt = build_laplacian(target_mesh, laplacian_type)
    corr = load_correspondence(correspondence) if isinstance(
        correspondence, str) else np.asarray(correspondence)

    # The degenerate-shell guard: the supplied full basis must reproduce
    # the trained features under identity selection before anything is
    # rendered. Only the plain-efuncs / standard-rescale path is checkable.
    if (config["model"].get("feature_strategy", "efuncs") == "efuncs"
            and config["data"].get("embed_strategy") is None
            and config["data"].get("rescale_strategy", "standard") == "standard"):
        from .spectral.features import load_first_k_eigenfunctions

        trained = load_first_k_eigenfunctions(config["data"]["eigenfunctions_path"], k)
        check_source_basis_matches_trained(E_src_full, trained, k)

    mapped = map_eigenfunctions_p2p(E_src_full, E_tgt_full, M_tgt, corr, k)

    renderer = make_renderer_from_config(config, device=device, infer=infer)
    # Swap geometry + basis: same trained weights, new shape.
    renderer.set_mesh(target_mesh)
    renderer.set_eigenfunctions(mapped)
    return renderer


def main(argv=None):
    from .render.renderer import make_renderer_from_config
    from .train.config import load_config
    from .utils.io import imwrite

    args = parse_args(argv)
    config = load_config(args.config_path)

    os.makedirs(args.out_dir, exist_ok=True)
    if args.render_source_too and not args.cameras_path:
        raise SystemExit(
            "--render_source_too needs --cameras_path: source views are "
            "rendered at explicit poses (the --eval_dataset split drives "
            "only the transferred-field eval)"
        )
    if args.render_source_too:
        src_renderer = make_renderer_from_config(config, device=args.device)
        cameras = np.load(args.cameras_path)
        n_cams = len([k for k in cameras.keys() if k.startswith("world_mat_")])
        for i in range(n_cams):
            view = src_renderer.render(cameras[f"world_mat_{i}"], cameras[f"camera_mat_{i}"])
            imwrite(os.path.join(args.out_dir, f"source_{i:03d}.png"), view)

    renderer = build_transferred_renderer(
        config, args.target_mesh, args.source_efuncs_full,
        args.target_efuncs_full, args.correspondence, args.laplacian_type,
        device=args.device,
    )

    if args.eval_dataset:
        from .evaluation.eval_cli import evaluate_views

        means, _ = evaluate_views(args.out_dir, config, args.eval_dataset, args.eval_split,
                                  background=args.background, renderer=renderer)
        return means

    assert args.cameras_path, "--cameras_path required without --eval_dataset"
    cameras = np.load(args.cameras_path)
    n_cams = len([key for key in cameras.keys() if key.startswith("world_mat_")])
    for i in range(n_cams):
        view = renderer.render(cameras[f"world_mat_{i}"], cameras[f"camera_mat_{i}"])
        imwrite(os.path.join(args.out_dir, f"transfer_{i:03d}.png"), view)
    print(f"Wrote {n_cams} transferred views to {args.out_dir}")


if __name__ == "__main__":
    main()
