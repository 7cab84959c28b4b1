"""Texture baking CLI of the port (root bake_texture_field.py): bake a
trained field into the UV layout of a MeshLab-exported tri mesh.

  python -m intrinsic_neural_fields_tpu_torch.bake_texture_field \
      --uv_mesh mesh_uv.obj --config_path cfg.yaml --out_dir out/bake \
      [--texture_size 1024] [--device cuda]

The field is evaluated by the forward kernel on the card, by its plain twin
with --device cpu.
"""
import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--uv_mesh", type=str,
        help="Mesh with UV map (MeshLab tri export with tex-coordinates; its "
        ".mtl must sit next to it as <mesh>.mtl with a map_Kd entry)")
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--texture_size", type=int, default=None,
                        help="Bake at this resolution instead of the existing map's")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def main(argv=None):
    from .bake.bake import bake_texture

    args = parse_args(argv)
    return bake_texture(args.out_dir, args.uv_mesh, args.config_path,
                        texture_size=args.texture_size, device=args.device)


if __name__ == "__main__":
    main()
