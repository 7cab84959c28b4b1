"""Render one camera view of a trained field at a chosen resolution (root
render_view.py).

  python -m intrinsic_neural_fields_tpu_torch.render_view --output_path view.png \
      --config_path cfg.yaml --cameras_path cameras.npz [--height H] [--width W] \
      [--device cuda] [--num_devices 1]

cameras.npz holds world_mat_0 / camera_mat_0; K is resized from the
config's resolution to --height x --width (principal-point offset kept).
--num_devices D > 1 renders the view D-way over cuda:0 ... cuda:D-1 (the
CPU D times with --device cpu); it raises when fewer devices exist.
"""
import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_path", type=str)
    parser.add_argument("--config_path", type=str)
    parser.add_argument("--cameras_path", type=str)
    parser.add_argument("--height", nargs="?", type=int, default=None)
    parser.add_argument("--width", nargs="?", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--num_devices", type=int, default=1)
    return parser.parse_args(argv)


def main(argv=None):
    import numpy as np

    from .devices import cli_devices
    from .geometry.cameras import cam_resize, load_extr_and_intr_camera
    from .render.renderer import make_renderer_from_config
    from .train.config import load_config
    from .utils.io import imwrite

    args = parse_args(argv)
    devices = cli_devices(args.device, args.num_devices)
    config = load_config(args.config_path)
    renderer = make_renderer_from_config(config, device=args.device, devices=devices)
    camCv2world, K = load_extr_and_intr_camera(args.cameras_path)
    cam_intrinsic = {"K": K, "height": config["data"]["img_height"],
                     "width": config["data"]["img_width"]}
    height = args.height if args.height is not None else config["data"]["img_height"]
    width = args.width if args.width is not None else config["data"]["img_width"]
    cam = cam_resize(cam_intrinsic, height, width)

    renderer.set_height(cam["height"])
    renderer.set_width(cam["width"])
    view = renderer.render(camCv2world, cam["K"])
    # the root CLI's cv2.imwrite((view * 255 + 0.5).clip(0, 255).astype(uint8))
    imwrite(args.output_path, (view * 255.0 + 0.5).clip(0, 255).astype(np.uint8))
    return view


if __name__ == "__main__":
    main()
