"""Write the JAX package's own checkpoint files for the HQ recipe's model, the
fixture the PyTorch port's checkpoint reader is held to.

  JAX_PLATFORMS=cpu python tools/make_jax_checkpoint_fixture.py \
      [--out tests/data/jax_checkpoint_hq] [--seed 0]

The model is configs/synthetic/intrinsic_blob_hq.yaml's at full width
(k=512, 6 x 128, skip at 3), initialised from the seed and trained for
EPOCHS epochs of STEPS steps of the JAX package's XLA step (L1, Adam at the
recipe's lr, batch 4096) on seeded numpy rays, so that Adam's moments and
count are not zero. Written through the JAX package's save_checkpoint:

  model.ckpt       make_variables(state), as the JAX Trainer writes it;
  checkpoint.ckpt  the JAX Trainer's payload {epoch, params, buffers,
                   opt_state, batch_stats, rng_key} at the last epoch;
  expected.npz     the JAX package's fused forward (make_fused_apply, the
                   Pallas kernel in interpret mode: bf16 operands, f32 sums)
                   on ROWS feature rows drawn as
                   np.random.default_rng(seed).normal(size=(ROWS, 512)) in
                   float32 (`rgb`), the rows' float64 sum (`rows_sum`, to
                   catch a numpy that draws other rows), `seed`, `epoch`,
                   `count` and `lr`.

Needs JAX, flax and optax; runs on the CPU in about ten seconds.
"""
import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "synthetic", "intrinsic_blob_hq.yaml")
ROWS = 8192          # the forward's rows: one render chunk of the port
EPOCHS, STEPS = 3, 2  # JAX train epochs and steps per epoch before the checkpoint
V, BATCH = 2048, 4096


def fixture_rows(seed, rows=ROWS, k=512):
    """The feature rows the expected forward is computed on."""
    return np.random.default_rng(seed).normal(size=(rows, k)).astype(np.float32)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(REPO, "tests", "data", "jax_checkpoint_hq"))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)

    import jax
    import jax.numpy as jnp
    import optax
    import yaml

    from intrinsic_neural_fields_tpu.data.sampler import RayData
    from intrinsic_neural_fields_tpu.models import init_model, make_model
    from intrinsic_neural_fields_tpu.ops.fused_mlp import (FusedMLPSpec, make_fused_apply,
                                                           params_to_list)
    from intrinsic_neural_fields_tpu.train.steps import (create_train_state, make_epoch_fns,
                                                         make_variables)
    from intrinsic_neural_fields_tpu.utils.checkpoint import save_checkpoint

    with open(CONFIG) as f:
        config = yaml.safe_load(f)
    cfg, lr = config["model"], config["training"]["lr"]
    model = make_model(cfg)
    variables = init_model(model, cfg, seed=args.seed)
    optimizer = optax.inject_hyperparams(optax.adam)(learning_rate=lr)
    state = create_train_state(variables, optimizer)

    rng = np.random.default_rng(args.seed + 1)
    n = STEPS * BATCH
    data = RayData(features=jnp.asarray(rng.normal(size=(V, cfg["k"])).astype(np.float32)),
                   feature_strategy="efuncs",
                   vertex_idxs_of_hit_faces=jnp.asarray(rng.integers(0, V, (n, 3)), jnp.int32),
                   barycentric_coords=jnp.asarray(rng.dirichlet(np.ones(3), n), jnp.float32),
                   expected_rgbs=jnp.asarray(rng.uniform(size=(n, 3)), jnp.float32),
                   unit_ray_dirs=None, face_idxs=None)
    train_epoch, _ = make_epoch_fns(model, optimizer, config["training"]["loss_type"],
                                    shuffle="full")
    base_key = jax.random.PRNGKey(args.seed)
    for epoch in range(EPOCHS):
        state, metrics = train_epoch(state, jax.random.fold_in(base_key, epoch), data, STEPS,
                                     BATCH)
        print(f"epoch {epoch}: loss {float(metrics['loss']):.6f}")

    os.makedirs(args.out, exist_ok=True)
    save_checkpoint(os.path.join(args.out, "model.ckpt"), jax.device_get(make_variables(state)))
    save_checkpoint(os.path.join(args.out, "checkpoint.ckpt"), {
        "epoch": np.int64(EPOCHS - 1), "params": state.params, "buffers": state.buffers,
        "opt_state": state.opt_state, "batch_stats": state.batch_stats, "rng_key": base_key})

    spec = FusedMLPSpec(num_layers=cfg["num_layers"], k_in=cfg["k"], hidden=cfg["mlp_hidden_dim"],
                        skip_idx=cfg["skip_layer_idx"])
    rows = fixture_rows(args.seed, k=cfg["k"])
    x = jnp.pad(jnp.asarray(rows), ((0, 0), (0, spec.k_pad - cfg["k"])))
    rgb = make_fused_apply(spec, batch_tile=512, interpret=True)(
        params_to_list(spec, state.params), x)
    count = int(state.opt_state.inner_state[0].count)
    np.savez(os.path.join(args.out, "expected.npz"), rgb=np.asarray(rgb, np.float32),
             rows_sum=np.float64(rows.astype(np.float64).sum()), seed=np.int64(args.seed),
             epoch=np.int64(EPOCHS - 1), count=np.int64(count), lr=np.float32(lr))
    sizes = {f: os.path.getsize(os.path.join(args.out, f)) for f in sorted(os.listdir(args.out))}
    print(f"wrote {args.out}: {sizes} (count {count})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
