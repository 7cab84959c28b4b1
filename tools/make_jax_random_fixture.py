"""Write the JAX package's random draws for the HQ recipe, the fixture the
PyTorch port's utils/jax_random.py is held to where there is no JAX (on the
card, by chip_smoke.py's jax_random phase).

  JAX_PLATFORMS=cpu python tools/make_jax_random_fixture.py \
      [--out tests/data/jax_random/expected.npz]

For configs/synthetic/intrinsic_blob_hq.yaml's model (k=512, 6 x 128, skip
at 3), its seed (0) and batch (4096), and a train split of N records,
expected.npz holds:

  init/<flax path>  init_model's params ('/'-joined keys, e.g.
                    init/Dense_0/kernel), the JAX package's initial weights;
  n, batch, seed    N, the batch and the seed;
  perm_head, perm_tail, perm_sha256
                    the first and last HEAD entries of
                    jax.random.permutation(PRNGKey(seed), N), the load-time
                    shuffle of the split (JAX data/sampler.py:246), and the
                    SHA-256 of the whole permutation as little-endian int32;
  block_orders      [EPOCHS, N // batch]: permutation(fold_in(PRNGKey(seed),
                    e), N // batch), the JAX Trainer's block orders of epochs
                    0 .. EPOCHS - 1 (train/trainer.py:444, steps.py:341).

N is above the ~1,600 records where a permutation takes a second round of
sort keys, as the recipe's ~750k rays do. Needs JAX and flax; runs on the
CPU in a few seconds.
"""
import argparse
import hashlib
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "synthetic", "intrinsic_blob_hq.yaml")
N = 750_000
EPOCHS = 3
HEAD = 64


def flatten(tree, prefix):
    """{'/'-joined path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        out.update(flatten(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def perm_digest(perm):
    return hashlib.sha256(np.asarray(perm, dtype="<i4").tobytes()).hexdigest()


def jax_draws(config):
    """The fixture's arrays from the JAX package and jax.random."""
    import jax

    from intrinsic_neural_fields_tpu.models import init_model, make_model

    seed, batch = config.get("seed", 0), config["training"]["batch_size"]
    variables = init_model(make_model(config["model"]), config["model"], seed=seed)
    key = jax.random.PRNGKey(seed)
    perm = np.asarray(jax.random.permutation(key, N))
    orders = [np.asarray(jax.random.permutation(jax.random.fold_in(key, e), N // batch))
              for e in range(EPOCHS)]
    return {**flatten(jax.device_get(variables["params"]), "init"),
            "n": np.int64(N), "batch": np.int64(batch), "seed": np.int64(seed),
            "perm_head": perm[:HEAD].astype(np.int32), "perm_tail": perm[-HEAD:].astype(np.int32),
            "perm_sha256": np.array(perm_digest(perm)),
            "block_orders": np.stack(orders).astype(np.int32)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(REPO, "tests", "data", "jax_random",
                                                      "expected.npz"))
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    import yaml

    with open(CONFIG) as f:
        config = yaml.safe_load(f)
    arrays = jax_draws(config)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes, "
          f"{sum(1 for k in arrays if k.startswith('init/'))} init arrays")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
