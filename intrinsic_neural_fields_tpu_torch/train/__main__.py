"""Training CLI of the port (reference train.py):

  python -m intrinsic_neural_fields_tpu_torch.train config.yaml \
      [--allow_checkpoint_loading] [--device cuda] [--num_devices 1]

Trains on one GPU (the kernels' path when training.fused_mlp is set);
``--device cpu`` runs the plain twins on the CPU. ``--num_devices D`` > 1
trains data-parallel over cuda:0 ... cuda:D-1 (``parallel/``; with
``--device cpu``, D replicas on the CPU) and raises when fewer devices
exist. Writes model.pt, checkpoint.pt and the TensorBoard logs under
training.out_dir.
"""
import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train a texture field")
    parser.add_argument("config_path", type=str)
    parser.add_argument("--allow_checkpoint_loading", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--num_devices", type=int, default=1,
                        help="data-parallel training over this many devices (1: one)")
    return parser.parse_args(argv)


def main(argv=None):
    from .. import resolve_device
    from ..geometry.mesh import load_mesh
    from ..devices import cli_devices
    from ..parallel import parallelize_trainer
    from . import (Trainer, get_data, get_loss_fn, get_model_and_optim, get_renderer,
                   load_config_file)

    args = parse_args(argv)
    resolve_device(args.device)  # fail before touching out_dir
    devices = cli_devices(args.device, args.num_devices)
    device = args.device if devices is None else devices[0]
    config = load_config_file(args.config_path, args.allow_checkpoint_loading)
    mesh = load_mesh(config["data"]["mesh_path"])
    data = get_data(config, mesh=mesh, device=device)
    model, optimizer = get_model_and_optim(config, mesh, device=device)
    renderer = get_renderer(config, model, mesh, device=device)
    loss_type = config["training"]["loss_type"]
    get_loss_fn(loss_type)  # validate early
    trainer = Trainer(model, optimizer, loss_type, renderer, data, mesh, config, device=device)
    if devices is not None:
        parallelize_trainer(trainer, devices)
    trainer.train()


if __name__ == "__main__":
    main()
