"""Training CLI of the port (reference train.py):

  python -m intrinsic_neural_fields_tpu_torch.train config.yaml \
      [--allow_checkpoint_loading] [--device cuda]

Trains on one GPU (the kernels' path when training.fused_mlp is set);
``--device cpu`` runs the plain twins on the CPU. Writes model.pt,
checkpoint.pt and the TensorBoard logs under training.out_dir.
"""
import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train a texture field")
    parser.add_argument("config_path", type=str)
    parser.add_argument("--allow_checkpoint_loading", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def main(argv=None):
    from .. import resolve_device
    from ..geometry.mesh import load_mesh
    from . import (Trainer, get_data, get_loss_fn, get_model_and_optim, get_renderer,
                   load_config_file)

    args = parse_args(argv)
    resolve_device(args.device)  # fail before touching out_dir
    config = load_config_file(args.config_path, args.allow_checkpoint_loading)
    mesh = load_mesh(config["data"]["mesh_path"])
    data = get_data(config, mesh=mesh, device=args.device)
    model, optimizer = get_model_and_optim(config, mesh, device=args.device)
    renderer = get_renderer(config, model, mesh, device=args.device)
    loss_type = config["training"]["loss_type"]
    get_loss_fn(loss_type)  # validate early
    Trainer(model, optimizer, loss_type, renderer, data, mesh, config,
            device=args.device).train()


if __name__ == "__main__":
    main()
