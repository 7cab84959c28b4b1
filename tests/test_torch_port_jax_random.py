"""The port's random draws (utils/jax_random.py, no jax, no flax) against
jax.random and the JAX package, on the CPU.

- PRNGKey, split, fold_in, random_bits, uniform and permutation are equal
  to jax.random to the bit, on the host (numpy) and through the torch
  path (int64 lanes) alike; the permutation at n from 1 to 100,000
  covers one and two rounds of sort keys.
- normal is within NORMAL_ULPS of jax.random.normal: XLA's erf_inv
  polynomial and multiply-add contraction are reproduced, its log1p is the
  host's (up to 2 ulps from XLA's on the CPU).
- init_params and make_model give the JAX package's init_model variables
  to the bit for every family (RFF's B within NORMAL_ULPS), and the
  pretraining tool's NeuTex init and sphere samples.
- The slice as a whole: the port's Trainer.train and the JAX Trainer.train
  on the same config and seed, no order injected: the same initial state
  and load-time shuffle, the same epoch keys and orders, final params
  within the existing parity tests' bounds.
- A resume from the committed tests/data/jax_checkpoint_hq/checkpoint.ckpt
  carries its rng_key (the JAX Trainer's next-epoch order), and so does
  the checkpoint.pt the port writes then.
- The data-parallel orders, the eigensolvers' start blocks, CheFSI from
  the JAX start block against the JAX filter, and the fixture
  tests/data/jax_random/expected.npz that stands in for JAX on the card.
"""
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsic_neural_fields_tpu.models import init_model
from intrinsic_neural_fields_tpu.models import make_model as jax_make_model

from intrinsic_neural_fields_tpu_torch.geometry.mesh_io import write_obj
from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
from intrinsic_neural_fields_tpu_torch.geometry.synthetic import blob_mesh
from intrinsic_neural_fields_tpu_torch.models import factory, make_model
from intrinsic_neural_fields_tpu_torch.utils import jax_random as jr
from intrinsic_neural_fields_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "jax_random", "expected.npz")
CKPT_FIXTURE = os.path.join(REPO, "tests", "data", "jax_checkpoint_hq", "checkpoint.ckpt")
NORMAL_ULPS = 4        # jax_random.normal against jax.random.normal (measured: 3)
NORMAL_SHARE = 0.03    # at most this share of normal draws differ at all (measured: 1.3%)
PARAM_TOL_FUSED = 2.5e-3  # tests/test_torch_port_train.py: the fused paths over two epochs
PARAM_TOL_EAGER = 1e-5    # the f32 eager step against the XLA step
LOSS_RTOL_FUSED, LOSS_RTOL_EAGER = 2e-3, 1e-5

SEEDS = [0, 1, 5, 2**31 - 1, -1, 2**32 + 3]
PERM_NS = [1, 2, 184, 1_600, 1_700, 100_000]
HQ = {"k": 512, "num_layers": 6, "mlp_hidden_dim": 128, "skip_layer_idx": 3}
SMALL = {"num_layers": 4, "mlp_hidden_dim": 128, "skip_layer_idx": 2}
VD_INTRINSIC = {"bottleneck_vec_dim": 128, "in_dim_view_dir": 1, "include_view_dir": True,
                "embed_size": 4, "directional_hidden_dim": 128, "strategy": "intrinsic"}
VD_EXTRINSIC = {"bottleneck_vec_dim": 64, "in_dim_view_dir": 3, "include_view_dir": False,
                "embed_size": 2, "directional_hidden_dim": 32, "strategy": "extrinsic"}
BLOB_MAPPING = os.path.join(REPO, "pretrained", "blob_pretrained_neutex_mapping.npz")
FAMILIES = {
    "hq": HQ,
    "viewdep": {**SMALL, "k": 16, "view_dependence": VD_INTRINSIC},
    "viewdep_extrinsic_rff": {**SMALL, "k": 8, "feature_strategy": "rff", "embed_std": 4.0,
                              "view_dependence": VD_EXTRINSIC},
    "rff": {**SMALL, "k": 16, "feature_strategy": "rff", "embed_std": 8.0},
    "ff": {**SMALL, "k": 4, "feature_strategy": "ff", "use_logspace": True},
    "xyz": {**SMALL, "feature_strategy": "xyz"},
    "batchnorm": {**SMALL, "k": 16, "batchnorm": True},
    "sine": {**SMALL, "k": 16, "activation": "sine"},
    "hks": {**SMALL, "k": 16, "hks_timesteps": 24},
    "neutex": {"type": "neutex", "feature_strategy": "xyz", "k": 170, "use_logspace": False,
               "max_freq": 6, "pretrained_path": BLOB_MAPPING},
}


def _ulps(a, b):
    """Per-element distance in f32 ulps."""
    ia, ib = (np.asarray(v, np.float32).view(np.int32).astype(np.int64) for v in (a, b))
    return np.abs(ia - ib)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


# ------------------------------------------------------------------ keys and bits


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_fold_in_are_jax(seed):
    key, jkey = jr.PRNGKey(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key.data, jkey)
    for num in (2, 3, 7):
        np.testing.assert_array_equal(np.stack([k.data for k in jr.split(key, num)]),
                                      jax.random.split(jkey, num))
    for data in (0, 1, 123, 2**32 - 1):
        np.testing.assert_array_equal(jr.fold_in(key, data).data, jax.random.fold_in(jkey, data))
    assert jr.Key.of(np.asarray(jkey)) == key


@pytest.mark.parametrize("shape", [(1,), (7,), (33, 17), (3, 512)])
def test_random_bits_are_jax(shape):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(9), shape, jnp.uint32))
    got = jr.random_bits(jr.PRNGKey(9), shape)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jr.random_bits(jr.PRNGKey(9), shape, "cpu").numpy(), want)


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-1.0, 1.0), (-0.3, 0.3), (2.5, 7.25),
                                    (-0.1083, 0.1083)])
def test_uniform_is_jax(bounds):
    """Bit-equal on both paths, the scale-and-shift an f32 multiply-add
    rounded once as XLA contracts it (an odd span shows the difference)."""
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (300, 70), jnp.float32, *bounds))
    got = jr.uniform(jr.PRNGKey(4), (300, 70), *bounds)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jr.uniform(jr.PRNGKey(4), (300, 70), *bounds,
                                             device="cpu").numpy(), want)


@pytest.mark.parametrize("n", PERM_NS)
def test_permutation_is_jax(n):
    key = jax.random.fold_in(jax.random.PRNGKey(3), n)
    want = np.asarray(jax.random.permutation(key, n))
    got = jr.permutation(jr.Key.of(key), n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jr.permutation(jr.Key.of(key), n, device="cpu").numpy(), want)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_normal_within_the_stated_ulps(device):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (400, 500)))
    got = jr.normal(jr.PRNGKey(11), (400, 500), device=device)
    got = got if device is None else got.numpy()
    assert got.dtype == np.float32
    d = _ulps(got, want)
    assert d.max() <= NORMAL_ULPS and (d > 0).mean() <= NORMAL_SHARE


def test_flax_key_is_flax_make_rng():
    """The key flax's make_rng gives a module at a path: a Dense's kernel
    drawn with a recording initializer inside a nested module."""
    import flax.linen as nn

    seen = {}

    def record(name):
        def init(key, shape, dtype=jnp.float32):
            seen[name] = np.asarray(key)
            return jnp.zeros(shape, dtype)
        return init

    class Inner(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = nn.Dense(4, kernel_init=record("a"))(x)
            return nn.Dense(4, kernel_init=record("b"), bias_init=record("b_bias"))(x)

    class Outer(nn.Module):
        @nn.compact
        def __call__(self, x):
            return Inner(name="inner")(x)

    Outer().init(jax.random.PRNGKey(5), jnp.zeros((1, 3)))
    root = jr.PRNGKey(5)
    assert np.array_equal(seen["a"], jr.flax_key(root, "inner", "Dense_0", 1).data)
    assert np.array_equal(seen["b"], jr.flax_key(root, "inner", "Dense_1", 1).data)
    assert np.array_equal(seen["b_bias"], jr.flax_key(root, "inner", "Dense_1", 2).data)


# ------------------------------------------------------------------ initial weights


def _mesh():
    from intrinsic_neural_fields_tpu.geometry.primitives import icosphere as jax_icosphere

    return jax_icosphere(1)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_params_is_init_model(family):
    """models/factory.init_params against the JAX package's init_model,
    leaf by leaf: equal to the bit (RFF's B within NORMAL_ULPS)."""
    cfg = FAMILIES[family]
    mesh = _mesh()
    want = _leaves(jax.device_get(init_model(jax_make_model(cfg, mesh=mesh), cfg, seed=3,
                                             mesh=mesh)))
    if family == "neutex":  # init_model loads the pretrained mapping; compare the init
        jm = jax_make_model(cfg, mesh=mesh)
        batch = {"xyz": jnp.zeros((4, 3)), "unit_ray_dirs": jnp.zeros((4, 3)),
                 "hit_face_idxs": jnp.zeros((4,), jnp.int32), "expected_rgbs": jnp.zeros((4, 3))}
        want = _leaves(jax.device_get(jm.init({"params": jax.random.PRNGKey(3),
                                               "buffers": jax.random.PRNGKey(4)}, batch,
                                              method=jm.loss_and_rgbs)))
    got = _leaves(factory.init_params(cfg, seed=3))
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and got[name].shape == w.shape, name
        if name.endswith("RandomFourierFeatEnc_0/B"):
            assert _ulps(got[name], w).max() <= NORMAL_ULPS, name
        else:
            np.testing.assert_array_equal(got[name], w, err_msg=name)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_make_model_is_init_model(family):
    """make_model(config, seed) holds init_model's weights (the pretrained
    NeuTex mapping loaded in both), through state_dict_from_flax."""
    cfg = FAMILIES[family]
    mesh = _mesh()
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(
        init_model(jax_make_model(cfg, mesh=mesh), cfg, seed=0, mesh=mesh)))
    want = state_dict_from_flax(variables, cfg)
    got = make_model(cfg, seed=0, device="cpu", mesh=mesh).state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        if name.endswith("embedding.B"):
            assert _ulps(got[name].numpy(), w.numpy()).max() <= NORMAL_ULPS
        else:
            assert torch.equal(got[name], w), name


def test_pretraining_init_and_sphere_samples_are_the_jax_tools():
    """tools/pretrain_neutex_mapping.py: NeuTex().init({"params": key}) of
    the two mapping networks at the root, and the sphere samples of
    iteration i of call c from split(fold_in(key, c), steps_per_call)[i]."""
    from intrinsic_neural_fields_tpu.models.neutex import NeuTex as JaxNeuTex
    from intrinsic_neural_fields_tpu.models.neutex import sample_sphere_points as jax_sphere

    from intrinsic_neural_fields_tpu_torch.models.neutex import sample_sphere_points

    key = jax.random.PRNGKey(2)

    def both_nets(mdl, uv_points, points_3d):
        return mdl.map_uvs_to_3d(uv_points), mdl.invert_points(points_3d)

    uv0 = jax_sphere(key, 64)[:, None, :]
    want = _leaves(jax.device_get(JaxNeuTex().init({"params": key}, uv0, jnp.zeros((4, 3)),
                                                   method=both_nets)["params"]))
    got = _leaves(factory.neutex_params(jr.PRNGKey(2), prefix=(), texture=False))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    for call in (0, 3):
        jkeys = jax.random.split(jax.random.fold_in(key, call), 5)
        keys = jr.split(jr.fold_in(jr.PRNGKey(2), call), 5)
        np.testing.assert_array_equal(np.stack([k.data for k in keys]), jkeys)
        np.testing.assert_allclose(sample_sphere_points(keys[4], 300).numpy(),
                                   np.asarray(jax_sphere(jkeys[4], 300)), rtol=0, atol=1e-6)


# ------------------------------------------------------------------ orders


def _toy(n=1024, v=200, k=16, seed=0):
    from intrinsic_neural_fields_tpu_torch.data.sampler import RayData, precompute_hit_features

    rng = np.random.default_rng(seed)
    d = RayData(torch.from_numpy(rng.normal(size=(v, k)).astype(np.float32)), "efuncs",
                torch.from_numpy(rng.integers(0, v, (n, 3))),
                torch.from_numpy(rng.dirichlet(np.ones(3), n).astype(np.float32)),
                torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32)))
    return precompute_hit_features(d, dtype=torch.bfloat16)


@pytest.mark.parametrize("shuffle,fused", [("blocks", True), ("full", False)])
def test_epoch_from_a_key_is_the_epoch_on_jax_order(shuffle, fused):
    """train_epoch(key) draws what the JAX epoch draws from the key
    (permutation(key, num_batches) of the blocks, permutation(key, n) of
    the records): the same state, to the bit, as the epoch on that
    permutation passed explicitly."""
    from intrinsic_neural_fields_tpu_torch.train.steps import (AdamHyper, create_train_state,
                                                               make_epoch_fns)

    data, cfg = _toy(), {**SMALL, "k": 16}
    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    states = []
    for order in (jr.Key.of(key), np.asarray(jax.random.permutation(
            key, 4 if shuffle == "blocks" else data.n))):
        model = make_model(cfg, seed=1, device="cpu")
        train, _ = make_epoch_fns(model, "L1", shuffle=shuffle, fused=fused)
        st, _ = train(create_train_state(model, AdamHyper(1e-3), "cpu"), order, data, 4, 256)
        states.append(st)
    assert torch.equal(states[0].params, states[1].params)
    assert torch.equal(states[0].mu, states[1].mu)


@pytest.mark.parametrize("shuffle", ["blocks", "full"])
def test_prefetched_order_is_the_drawn_one(shuffle, monkeypatch):
    """train_epoch.prefetch(key, ...) draws the blocks epoch's order ahead
    (the Trainer calls it while the running epoch replays): the epoch
    given that key draws nothing more and ends, to the bit, where the
    epoch on jax.random.permutation(key, num_batches) ends; a full
    shuffle's epoch draws its own."""
    from intrinsic_neural_fields_tpu_torch.train import steps
    from intrinsic_neural_fields_tpu_torch.train.steps import (AdamHyper, create_train_state,
                                                               make_epoch_fns)

    draws = []
    order_of = steps.epoch_order
    monkeypatch.setattr(steps, "epoch_order",
                        lambda *a, **kw: draws.append(a[1]) or order_of(*a, **kw))
    data, cfg = _toy(), {**SMALL, "k": 16}
    key = jax.random.fold_in(jax.random.PRNGKey(0), 5)
    nb = 4 if shuffle == "blocks" else data.n
    states = []
    for order in (jr.Key.of(key), np.asarray(jax.random.permutation(key, nb))):
        model = make_model(cfg, seed=1, device="cpu")
        train, _ = make_epoch_fns(model, "L1", shuffle=shuffle, fused=shuffle == "blocks")
        train.prefetch(jr.Key.of(key), data, 4, 256)
        train.prefetch(jr.Key.of(key), data, 4, 256)  # a second draw replaces the first
        del draws[:]
        st, _ = train(create_train_state(model, AdamHyper(1e-3), "cpu"), order, data, 4, 256)
        states.append(st)
        assert draws == ([] if shuffle == "blocks" and not isinstance(order, np.ndarray)
                         else [nb])
    assert torch.equal(states[0].params, states[1].params)
    assert torch.equal(states[0].mu, states[1].mu)


def test_data_parallel_orders_are_jax():
    """Per replica d, permutation(fold_in(key, d), num_batches) (JAX
    parallel/data_parallel.py:408-409); the gather path permutes the n
    records with the key itself (:495): the same states, to the bit, as on
    those orders passed explicitly."""
    from intrinsic_neural_fields_tpu_torch.parallel import make_dp_epoch_fns
    from intrinsic_neural_fields_tpu_torch.parallel.data_parallel import _block_orders
    from intrinsic_neural_fields_tpu_torch.train.steps import AdamHyper, create_train_state

    key = jax.random.PRNGKey(6)
    orders = _block_orders(jr.Key.of(key), 4, 10)
    want = [np.asarray(jax.random.permutation(jax.random.fold_in(key, d), 10)) for d in range(4)]
    for got, w in zip(orders, want):
        np.testing.assert_array_equal(got.numpy(), w)
    data, cfg = _toy(), {**SMALL, "k": 16}
    for shuffle, explicit in (("blocks", np.stack([np.asarray(jax.random.permutation(
            jax.random.fold_in(key, d), 2)) for d in range(2)])),
            ("full", np.asarray(jax.random.permutation(key, data.n)))):
        states = []
        for order in (jr.Key.of(key), explicit):
            model = make_model(cfg, seed=1, device="cpu")
            train, _ = make_dp_epoch_fns(model, "L1", ["cpu"] * 2, shuffle=shuffle)
            st, _ = train(create_train_state(model, AdamHyper(1e-3), "cpu"), order, data, 2, 512)
            states.append(st)
        assert torch.equal(states[0].params, states[1].params), shuffle


def test_load_time_shuffle_is_the_jax_samplers(tmp_path):
    """create_ray_data(seed=s) permutes the records by
    permutation(PRNGKey(s), n), as the JAX package's sampler does."""
    from intrinsic_neural_fields_tpu.data.sampler import create_ray_data as jax_create

    from intrinsic_neural_fields_tpu_torch.data.sampler import create_ray_data

    mesh = icosphere(1)
    rng = np.random.default_rng(2)
    n, k = 3000, 8
    arrays = {"efuncs": rng.normal(size=(mesh.num_vertices, k)).astype(np.float32),
              "vids_of_hit_faces": mesh.faces[rng.integers(0, len(mesh.faces), n)]
              .astype(np.int32),
              "barycentric_coords": rng.dirichlet(np.ones(3), n).astype(np.float32),
              "expected_rgbs": rng.uniform(size=(n, 3)).astype(np.float32)}
    for name, a in arrays.items():
        np.save(str(tmp_path / f"{name}.npy"), a)
    got = create_ray_data(str(tmp_path), str(tmp_path / "efuncs.npy"), k, seed=7, device="cpu")
    want = jax_create(str(tmp_path), str(tmp_path / "efuncs.npy"), k, "efuncs", None, seed=7)
    np.testing.assert_array_equal(got.expected_rgbs.numpy(), np.asarray(want.expected_rgbs))
    np.testing.assert_array_equal(got.vertex_idxs_of_hit_faces.numpy(),
                                  np.asarray(want.vertex_idxs_of_hit_faces))


# ------------------------------------------------------------------ the slice as a whole


class Recorder:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, global_step=None):
        self.scalars.append((tag, float(value), global_step))

    def add_image(self, tag, img, global_step=None):
        pass


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A blob mesh, a random eigenfunction table (k=512, so the HQ
    checkpoint fixture fits), train / val ray caches; a config factory."""
    root = str(tmp_path_factory.mktemp("jax_random"))
    mesh = blob_mesh(1)
    write_obj(os.path.join(root, "blob.obj"), mesh.vertices, mesh.faces)
    rng = np.random.default_rng(0)
    np.save(os.path.join(root, "efuncs.npy"),
            rng.normal(size=(mesh.num_vertices, 512)).astype(np.float32))
    faces = np.asarray(mesh.faces, np.int32)
    for split, n in (("train", 1024), ("val", 256)):
        d = os.path.join(root, split)
        os.makedirs(d)
        np.save(os.path.join(d, "vids_of_hit_faces.npy"), faces[rng.integers(0, len(faces), n)])
        np.save(os.path.join(d, "barycentric_coords.npy"),
                rng.dirichlet(np.ones(3), n).astype(np.float32))
        np.save(os.path.join(d, "expected_rgbs.npy"), rng.uniform(size=(n, 3)).astype(np.float32))

    def config(out_name, model, epochs, seed=1, **training):
        return {
            "seed": seed,
            "data": {"preproc_data_path_train": os.path.join(root, "train"),
                     "preproc_data_path_eval": os.path.join(root, "val"),
                     "eigenfunctions_path": os.path.join(root, "efuncs.npy"),
                     "mesh_path": os.path.join(root, "blob.obj"),
                     "img_height": 24, "img_width": 24, "precompute_dtype": "bfloat16"},
            "model": model,
            "training": {"out_dir": os.path.join(root, out_name), "batch_size": 256,
                         "lr": 1e-3, "loss_type": "L1", "render_every": 100, "print_every": 1,
                         "epochs": epochs, "checkpoint_every": 1, **training},
        }

    return root, config


def _port_trainer(config):
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh
    from intrinsic_neural_fields_tpu_torch.train import (Trainer, get_data,
                                                         get_model_and_optim, get_renderer)

    mesh = load_mesh(config["data"]["mesh_path"])
    model, opt = get_model_and_optim(config, mesh, device="cpu")
    return Trainer(model, opt, config["training"]["loss_type"],
                   get_renderer(config, model, mesh, device="cpu"),
                   get_data(config, mesh, device="cpu"), mesh, config, writer=Recorder(),
                   device="cpu")


def _jax_trainer(config):
    from intrinsic_neural_fields_tpu.geometry.mesh import load_mesh
    from intrinsic_neural_fields_tpu.train import (Trainer, get_data, get_model_and_optim,
                                                   get_renderer)

    mesh = load_mesh(config["data"]["mesh_path"])
    model, variables, opt = get_model_and_optim(config, mesh)
    t = Trainer(model, variables, opt, "L1", get_renderer(config, model, variables, mesh),
                get_data(config, mesh), mesh, config)
    t.writer = Recorder()
    return t


def _record_epochs(trainer):
    """(epoch key data, the order the epoch walks) of every epoch `trainer`
    (either package's) trains. The order is what each package's step draws
    from the key: the port's steps.epoch_order, jax.random.permutation."""
    from intrinsic_neural_fields_tpu_torch.train.steps import epoch_order

    seen, fn = [], trainer.train_epoch_fn

    def spy(state, key, data, num_batches, batch_size):
        blocks = trainer.shuffle == "blocks" if hasattr(trainer, "shuffle") else (
            trainer.config["training"].get("shuffle", "full") == "blocks")
        size = num_batches if blocks else data.n
        if isinstance(key, jr.Key):
            seen.append((key.data, epoch_order(key, size).numpy()))
        else:
            seen.append((np.asarray(key), np.asarray(jax.random.permutation(key, size))))
        return fn(state, key, data, num_batches, batch_size)

    trainer.train_epoch_fn = spy
    return seen


def _jax_params_sd(jt, cfg):
    from intrinsic_neural_fields_tpu.train.steps import make_variables

    return state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jax.device_get(
        make_variables(jt.state))), cfg)


@pytest.mark.parametrize("shuffle,fused", [("blocks", True), ("full", False)])
def test_trainer_is_the_jax_trainer(experiment, shuffle, fused):
    """Two epochs of the port's Trainer.train and the JAX Trainer.train on
    one config and seed, nothing injected: the same initial weights and
    load-time shuffle (to the bit), the same epoch keys and orders (to the
    bit), train losses and final params within the parity tests' bounds
    (the fused blocks path: tests/test_torch_port_train.py's 2e-3 / 2.5e-3;
    the f32 eager step on the full shuffle: 1e-5 / 1e-5)."""
    _, config = experiment
    model = {**SMALL, "k": 16}
    cfg = config(f"port_{shuffle}", model, 2, shuffle=shuffle, fused_mlp=fused)
    jcfg = config(f"jax_{shuffle}", model, 2, shuffle=shuffle, fused_mlp=fused)
    t, jt = _port_trainer(cfg), _jax_trainer(jcfg)
    init = t.state.state_dict()
    jinit = _jax_params_sd(jt, model)
    assert set(init) == set(jinit) and all(torch.equal(init[k], jinit[k]) for k in init)
    np.testing.assert_array_equal(t.train_data.expected_rgbs.numpy(),
                                  np.asarray(jt.train_data.expected_rgbs))
    seen, jseen = _record_epochs(t), _record_epochs(jt)
    t.train()
    jt.train()
    assert len(seen) == len(jseen) == 2
    for (key, order), (jkey, jorder) in zip(seen, jseen):
        np.testing.assert_array_equal(key, jkey)
        np.testing.assert_array_equal(order, jorder)
    loss = [v for tag, v, _ in t.writer.scalars if tag == "Train_Loss"]
    jloss = [v for tag, v, _ in jt.writer.scalars if tag == "Train_Loss"]
    rtol, atol = (LOSS_RTOL_FUSED, PARAM_TOL_FUSED) if fused else (LOSS_RTOL_EAGER,
                                                                   PARAM_TOL_EAGER)
    np.testing.assert_allclose(loss, jloss, rtol=rtol)
    got, want = t.state.state_dict(), _jax_params_sd(jt, model)
    assert max(float((got[k] - want[k]).abs().max()) for k in want) <= atol


def test_resume_from_the_committed_jax_checkpoint_carries_its_rng_key(experiment):
    """tests/data/jax_checkpoint_hq/checkpoint.ckpt (epoch 2, rng_key
    PRNGKey(0)) in an out_dir whose config says seed 7: the port resumes at
    epoch 3 with the file's key, so its epoch-3 key and block order are the
    ones the JAX Trainer resumed from the same file uses (not PRNGKey(7)'s).
    The checkpoint.pt it writes keeps the key, and a second resume from
    that file goes on with it; a checkpoint.pt without one (the upstream
    trainer's) falls back to PRNGKey(config seed)."""
    from intrinsic_neural_fields_tpu_torch.utils.checkpoint import (load_train_checkpoint,
                                                                    save_train_checkpoint)

    _, config = experiment
    runs = {}
    for who in ("port", "jax"):
        cfg = config(f"resume_{who}", dict(HQ), 4, seed=7, shuffle="blocks")
        os.makedirs(cfg["training"]["out_dir"])
        shutil.copy(CKPT_FIXTURE, cfg["training"]["out_dir"])
        t = (_port_trainer if who == "port" else _jax_trainer)(cfg)
        runs[who] = (cfg, t, _record_epochs(t))
        t.train()
    (cfg, t, seen), (_, _, jseen) = runs["port"], runs["jax"]
    file_key = jax.random.PRNGKey(0)
    assert len(seen) == len(jseen) == 1
    np.testing.assert_array_equal(seen[0][0], jseen[0][0])
    np.testing.assert_array_equal(seen[0][0], jax.random.fold_in(file_key, 3))
    np.testing.assert_array_equal(seen[0][1], jseen[0][1])
    np.testing.assert_array_equal(seen[0][1], jax.random.permutation(
        jax.random.fold_in(file_key, 3), 4))
    assert not np.array_equal(seen[0][1], np.asarray(jax.random.permutation(
        jax.random.fold_in(jax.random.PRNGKey(7), 3), 4)))

    ckpt = os.path.join(cfg["training"]["out_dir"], "checkpoint.pt")
    assert load_train_checkpoint(ckpt)["rng_key"] == jr.Key.of(file_key)
    cfg5 = config("resume_port", dict(HQ), 5, seed=7, shuffle="blocks")
    t5 = _port_trainer(cfg5)
    seen5 = _record_epochs(t5)
    t5.train()
    np.testing.assert_array_equal(seen5[0][0], jax.random.fold_in(file_key, 4))

    # the same state, stored without a key: the config seed's key
    save_train_checkpoint(ckpt, 4, t5.state)
    assert load_train_checkpoint(ckpt)["rng_key"] is None
    cfg6 = config("resume_port", dict(HQ), 6, seed=7, shuffle="blocks")
    t6 = _port_trainer(cfg6)
    seen6 = _record_epochs(t6)
    t6.train()
    np.testing.assert_array_equal(seen6[0][0], jax.random.fold_in(jax.random.PRNGKey(7), 5))


# ------------------------------------------------------------------ eigensolvers


def test_eigensolver_start_blocks_are_jax():
    """LOBPCG's start normal(PRNGKey(seed), (n, k)) and CheFSI's two,
    normal(key, (n, 1)) and normal(fold_in(key, 1), (n, m)) (JAX
    spectral/eigensolver.py:136, 256-267, 315), computed on a device:
    within NORMAL_ULPS of jax.random.normal."""
    key = jax.random.PRNGKey(0)
    for got, want in (
            (jr.normal(jr.PRNGKey(0), (642, 40), device="cpu"),
             jax.random.normal(key, (642, 40), jnp.float32)),
            (jr.normal(jr.PRNGKey(0), (642, 1), device="cpu"), jax.random.normal(key, (642, 1))),
            (jr.normal(jr.fold_in(jr.PRNGKey(0), 1), (642, 80), device="cpu"),
             jax.random.normal(jax.random.fold_in(key, 1), (642, 80)))):
        assert _ulps(got.numpy(), np.asarray(want)).max() <= NORMAL_ULPS


def test_chefsi_on_the_jax_start_block_matches_the_jax_filter():
    """CheFSI with the default device pre-filter (refine_filter="device")
    from the same start block in both packages, on icosphere(4) at k=64:
    against shift-invert, the port's largest relative eigenvalue error is
    within a factor 2 of the JAX filter's (or below 1e-6), and both are
    under the JAX gate of 1e-4 (tests/test_spectral.py)."""
    from intrinsic_neural_fields_tpu.spectral import eigensolver as jeig

    from intrinsic_neural_fields_tpu_torch.geometry.laplacian import build_laplacian
    from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import (
        solve_generalized_eigenproblem as solve)

    L, M = build_laplacian(icosphere(4), "cotan")
    k = 64
    ev_ref, _ = solve(L, M, k)
    ev_jax, _ = jeig.solve_generalized_eigenproblem(L, M, k, method="chefsi")
    ev_port, _ = solve(L, M, k, method="chefsi", refine_filter="device", device="cpu")
    scale = np.abs(ev_ref).max()
    err_jax = np.abs(np.asarray(ev_jax) - ev_ref).max() / scale
    err_port = np.abs(np.asarray(ev_port) - ev_ref).max() / scale
    assert err_port <= max(2 * err_jax, 1e-6) and max(err_port, err_jax) < 1e-4


# ------------------------------------------------------------------ the card's fixture


def test_fixture_is_the_jax_draws_and_the_ports():
    """tests/data/jax_random/expected.npz (tools/make_jax_random_fixture.py)
    equals the draws recomputed with JAX, and the port's draws equal it:
    the HQ model's initial weights at seed 0, the load-time permutation of
    its n records (ends and SHA-256, on the host and through the torch
    path), the first epochs' block orders."""
    import yaml

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_jax_random_fixture import CONFIG, jax_draws, perm_digest

    with open(CONFIG) as f:
        config = yaml.safe_load(f)
    fixture = dict(np.load(FIXTURE))
    want = jax_draws(config)
    assert set(fixture) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(fixture[name], w, err_msg=name)

    seed, n, batch = int(fixture["seed"]), int(fixture["n"]), int(fixture["batch"])
    init = _leaves(factory.init_params(config["model"], seed)["params"], "init")
    assert set(init) == {k for k in fixture if k.startswith("init/")}
    for name, w in init.items():
        np.testing.assert_array_equal(w, fixture[name], err_msg=name)
    for device in (None, "cpu"):
        perm = jr.permutation(jr.PRNGKey(seed), n, device=device)
        perm = np.asarray(perm if device is None else perm.numpy())
        head = len(fixture["perm_head"])
        assert perm_digest(perm) == str(fixture["perm_sha256"])
        np.testing.assert_array_equal(perm[:head], fixture["perm_head"])
        np.testing.assert_array_equal(perm[-head:], fixture["perm_tail"])
    for e, order in enumerate(fixture["block_orders"]):
        np.testing.assert_array_equal(
            jr.permutation(jr.fold_in(jr.PRNGKey(seed), e), n // batch), order)
