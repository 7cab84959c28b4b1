"""Evaluation CLI of the port (root eval.py): renders a split on the GPU,
computes masked PSNR / DSSIM / LPIPS, writes PNGs + evaluation_metrics.pkl
and prints the split means.

  python -m intrinsic_neural_fields_tpu_torch.eval output_path config.yaml \
      dataset_path split [--weights model.pt] [--background white] \
      [--uv_mesh_path UV.obj] [--lpips_weights lpips_alex.npz] [--device cpu] \
      [--num_devices 1]

--uv_mesh_path bakes the field into that UV layout first (into
output_path, which must not exist yet). The LPIPS column is NaN unless
--lpips_weights names an AlexNet npz (evaluation/lpips.py). --num_devices D
> 1 renders each view D-way over cuda:0 ... cuda:D-1 (the CPU D times with
--device cpu); it raises when fewer devices exist.

--weights names a weights file of either package: a torch model.pt or a
JAX package's flax msgpack .ckpt (model.ckpt, checkpoint.ckpt, ...), told
apart by their first bytes. Without it the out_dir's are read:
<training.out_dir>/model.pt, or the JAX package's model.ckpt when there
is no model.pt, so a JAX-trained out_dir evaluates as it is.
"""
import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("output_path", type=str)
    parser.add_argument("config_path", type=str)
    parser.add_argument("dataset_path", type=str)
    parser.add_argument("split", type=str)
    parser.add_argument("--weights", type=str, default=None,
                        help="a model.pt or a JAX .ckpt (default: "
                        "<training.out_dir>/model.pt, else its model.ckpt)")
    parser.add_argument("--background", type=str, default="white")
    parser.add_argument("--uv_mesh_path", type=str, default=None,
                        help="bake the field into this UV mesh's layout before the eval")
    parser.add_argument("--lpips_weights", type=str, default=None,
                        help="LPIPS AlexNet weights (.npz); without it the column is NaN")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--num_devices", type=int, default=1,
                        help="render each view D-way over this many devices")
    return parser.parse_args(argv)


def load_config(path):
    """Experiment YAML (the reference schema). The compact eigenfunction
    index spec `k: {ranges: [[a, b], ...]}` (half-open ranges) expands to
    the explicit index list, as in the reference package."""
    import yaml

    with open(path) as f:
        config = yaml.safe_load(f)
    k = config.get("model", {}).get("k")
    if isinstance(k, dict) and "ranges" in k:
        config["model"]["k"] = [i for a, b in k["ranges"] for i in range(a, b)]
    return config


def main(argv=None):
    from .devices import cli_devices
    from .evaluation.eval_cli import evaluate_views
    from .render.renderer import make_renderer_from_config

    args = parse_args(argv)
    devices = cli_devices(args.device, args.num_devices)
    if args.uv_mesh_path is not None:
        from .bake.bake import bake_texture

        print("Baking texture into UV-map...")
        bake_texture(args.output_path, args.uv_mesh_path, args.config_path, device=args.device)
        print("Done.")
    config = load_config(args.config_path)
    renderer = make_renderer_from_config(config, weights_path=args.weights,
                                         device=args.device, devices=devices)
    evaluate_views(args.output_path, config, args.dataset_path, args.split,
                   renderer=renderer, background=args.background,
                   lpips_weights_path=args.lpips_weights)


if __name__ == "__main__":
    main()
