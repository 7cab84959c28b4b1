"""Turntable video of a trained field (root render_video.py): fit the
trained camera's intrinsics into a target resolution by exact Fraction
scaling plus symmetric crop-padding (centered principal point, square
pixels), render `turns` rotations of the object about z, pipelined two
frames deep with uint8 colors on the wire, and encode with ffmpeg when it is
installed (else the frames stay on disk and the command is printed).

  python -m intrinsic_neural_fields_tpu_torch.render_video --out_dir out \
      --config_path cfg.yaml --cameras_path cameras.npz [--resolution 720p] \
      [--turns 2] [--duration 15] [--fps 60] [--device cuda] [--num_devices 1]

int(fps * duration) frames at angles linspace(0, 360 * turns), written to
<out_dir>/images/<config dir name>_<resolution>/NNNN.jpg. --num_devices D
> 1 renders each frame D-way over cuda:0 ... cuda:D-1 (the CPU D times
with --device cpu); it raises when fewer devices exist.
"""
import argparse
import os
import shlex
import shutil
import subprocess
from fractions import Fraction
from os.path import basename, dirname, join

import numpy as np

resolutions = {
    "2160p": (3840, 2160),
    "1080p": (1920, 1080),
    "720p": (1280, 720),
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out_dir", type=str)
    parser.add_argument("--config_path", type=str)
    parser.add_argument("--cameras_path", type=str)
    parser.add_argument("--resolution", choices=tuple(resolutions.keys()), default="720p")
    parser.add_argument("--turns", type=float, default=2)
    parser.add_argument("--duration", type=float, default=15)
    parser.add_argument("--fps", type=int, default=60)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--num_devices", type=int, default=1)
    return parser.parse_args(argv)


def fit_camera_to_resolution(cam_orig, res):
    """Scale-then-pad so the original FOV sits centered in `res` with square
    pixels and a centered principal point (reference render_video.py:78-109)."""
    from .geometry.cameras import cam_crop, cam_resize

    factor = min(
        Fraction(res[0], cam_orig["width"]), Fraction(res[1], cam_orig["height"])
    )
    new_width = cam_orig["width"] * factor
    new_height = cam_orig["height"] * factor
    assert int(new_width) == new_width and int(new_height) == new_height
    new_width, new_height = int(new_width), int(new_height)
    assert (res[0] - new_width) % 2 == 0 and (res[1] - new_height) % 2 == 0
    pad_w = (res[0] - new_width) // 2
    pad_h = (res[1] - new_height) // 2

    cam_resized = cam_resize(cam_orig, height=new_height, width=new_width)
    cam_render = cam_crop(cam_resized, height=res[1], width=res[0], col=-pad_w, row=-pad_h)

    assert cam_render["K"][0, 0] == cam_render["K"][1, 1]
    assert cam_render["width"] * 0.5 - 0.5 == cam_render["K"][0, 2]
    assert cam_render["height"] * 0.5 - 0.5 == cam_render["K"][1, 2]
    return cam_render


def turntable_pose(cam44, angle_deg):
    """The camera [3,4] after turning the object by angle_deg about z."""
    st, ct = np.sin(np.deg2rad(angle_deg)), np.cos(np.deg2rad(angle_deg))
    pose_obj = np.eye(4, dtype=np.float32)
    pose_obj[:3, :3] = np.array([[ct, -st, 0], [st, ct, 0], [0, 0, 1]])
    return (pose_obj @ cam44)[:3]


def render_turntable(renderer, camCv2world, K, angles, finish, depth=2):
    """Render one frame per angle; finish(index, [H,W,3] image) in order,
    `depth` frames behind the dispatches. Returns the frame count."""
    from .utils.pipeline import pipelined_foreach

    cam44 = np.eye(4, dtype=np.float32)
    cam44[:3, :4] = np.asarray(camCv2world)[:3, :4]
    return pipelined_foreach(
        enumerate(angles), lambda item: renderer.render_async(turntable_pose(cam44, item[1]), K),
        lambda item, handle: finish(item[0], renderer.render_fetch(handle)), depth=depth)


def main(argv=None):
    from .devices import cli_devices
    from .geometry.cameras import load_extr_and_intr_camera
    from .render.renderer import make_renderer_from_config
    from .train.config import load_config
    from .utils.io import imwrite

    args = parse_args(argv)
    devices = cli_devices(args.device, args.num_devices)
    config = load_config(args.config_path)
    # uint8 colors on the wire: video frames are 8-bit anyway
    renderer = make_renderer_from_config(config, device=args.device, wire_u8=True,
                                         devices=devices)

    camCv2world, K = load_extr_and_intr_camera(args.cameras_path)
    cam_orig = {"K": K, "height": config["data"]["img_height"],
                "width": config["data"]["img_width"]}
    cam_render = fit_camera_to_resolution(cam_orig, resolutions[args.resolution])
    renderer.set_height(cam_render["height"])
    renderer.set_width(cam_render["width"])

    folder_name = basename(dirname(args.config_path))
    image_folder = join(args.out_dir, "images", f"{folder_name}_{args.resolution}")
    os.makedirs(image_folder, exist_ok=True)

    num_images = int(args.fps * args.duration)
    angles = np.linspace(0, args.turns * 360, num_images)
    n = render_turntable(renderer, camCv2world, cam_render["K"], angles,
                         lambda idx, img: imwrite(join(image_folder, f"{idx:04d}.jpg"), img))

    video_name = join(args.out_dir, f"{folder_name}_{args.resolution}.mp4")
    cmd = ["ffmpeg", "-y", "-framerate", str(args.fps), "-pattern_type", "glob", "-i",
           f"{image_folder}/*.jpg", "-c:v", "libx264", "-crf", "17", "-pix_fmt", "yuv420p",
           video_name]
    if shutil.which("ffmpeg") is None:
        print(f"ffmpeg not found — frames left in {image_folder}; encode with:\n  "
              f"{shlex.join(cmd)}")
    else:
        subprocess.run(cmd)
    return n


if __name__ == "__main__":
    main()
