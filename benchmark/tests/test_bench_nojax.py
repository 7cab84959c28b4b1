"""The no-JAX check compares whole top-level names."""
import pytest

from benchmark.run import forbidden_modules


@pytest.mark.parametrize("modules,found", [
    (["intrinsic_neural_fields_tpu_torch", "intrinsic_neural_fields_tpu_torch.ops"], []),
    (["intrinsic_neural_fields_tpu.ops.fused_mlp"], ["intrinsic_neural_fields_tpu"]),
    (["jax.numpy", "jaxtyping", "flax_like"], ["jax"]),
    (["optax", "jaxlib.xla_client", "flax.linen"], ["flax", "jaxlib", "optax"]),
    (["torch", "numpy"], []),
])
def test_whole_top_level_names(modules, found):
    assert forbidden_modules(modules) == found


def test_harness_imports_no_jax():
    """The harness, its readers and the port load no forbidden package."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    code = ("import benchmark.run, benchmark.train_cell, benchmark.render_cell, "
            "benchmark.control, intrinsic_neural_fields_tpu_torch.train.steps, "
            "intrinsic_neural_fields_tpu_torch.render.renderer\n"
            "from benchmark.registry import Registry\n"
            "r = Registry()\n"
            "[r.reader(m['name']) for m in r.spec['per_layer']]\n"
            "from benchmark.run import forbidden_modules\n"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         check=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]"
