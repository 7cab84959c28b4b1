"""The JAX package's own checkpoint files in the port, on the CPU.

The JAX Trainer writes flax msgpack files (model.ckpt, checkpoint.ckpt);
the port reads them with its own decoder (utils/flax_msgpack.py, no flax
and no msgpack) and maps them with utils/weights.py. For each family at a
small width (efuncs on the kernels' path, view-dependent, tf_rff,
BatchNorm, NeuTex, hks) one JAX Trainer epoch writes the files; then:

  - the port's decoding equals flax's msgpack_restore leaf by leaf;
  - the port's module loaded from model.ckpt gives the JAX model's
    forward within 1e-5 (f32 on both sides);
  - a port Trainer on an out_dir holding only checkpoint.ckpt starts at
    epoch + 1 with the decoded state, and its update over one epoch
    (params after minus params resumed) is nonzero and within 5e-2 of the
    JAX Trainer's update from the same file, in norm relative to JAX's.
    Both Trainers see the same rows in the same order: the port draws the
    JAX package's load-time shuffle and, from the file's rng_key, its
    epoch keys (utils/jax_random.py).

Then the format's corners (every msgpack form, chunked arrays, bfloat16,
malformed files), the weights-file resolution, the eval and bake CLIs on a
JAX out_dir, and the committed fixture tests/data/jax_checkpoint_hq
(tools/make_jax_checkpoint_fixture.py)."""
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import serialization

from intrinsic_neural_fields_tpu.models.neutex import NeuTexTrainWrapper as JaxWrapper
from intrinsic_neural_fields_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from intrinsic_neural_fields_tpu.utils.checkpoint import save_npz_pytree as jax_save_npz

from intrinsic_neural_fields_tpu_torch.geometry.mesh_io import write_obj
from intrinsic_neural_fields_tpu_torch.geometry.synthetic import blob_mesh
from intrinsic_neural_fields_tpu_torch.models import make_model
from intrinsic_neural_fields_tpu_torch.utils.checkpoint import (
    is_torch_checkpoint,
    load_jax_train_checkpoint,
    load_trained_weights,
    resolve_weights_path,
    save_model,
)
from intrinsic_neural_fields_tpu_torch.utils.flax_msgpack import load_flax_msgpack
from intrinsic_neural_fields_tpu_torch.utils.jax_random import Key
from intrinsic_neural_fields_tpu_torch.utils.weights import adam_state_from_optax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "jax_checkpoint_hq")
LR = 1e-3
SEED = 1
K = 16
FWD_TOL = 1e-5      # f32 forwards, other summation orders
UPDATE_TOL = 5e-2   # ||port update - JAX update|| / ||JAX update||
BASE = {"num_layers": 4, "mlp_hidden_dim": 128, "skip_layer_idx": 2}
VIEWDEP = {"bottleneck_vec_dim": 64, "include_view_dir": True, "embed_size": 2,
           "directional_hidden_dim": 64, "in_dim_view_dir": 1, "strategy": "intrinsic"}
# family -> (model section, data section additions, training section additions)
FAMILIES = {
    "efuncs": ({**BASE, "k": K}, {"precompute_dtype": "bfloat16"},
               {"shuffle": "blocks", "fused_mlp": True}),
    "viewdep": ({**BASE, "k": K, "view_dependence": VIEWDEP}, {}, {"shuffle": "full"}),
    "tf_rff": ({**BASE, "feature_strategy": "rff", "k": 8, "embed_std": 4.0,
                "embed_include_input": True}, {}, {"shuffle": "blocks", "fused_mlp": True}),
    "batchnorm": ({**BASE, "k": K, "batchnorm": True}, {}, {"shuffle": "full"}),
    "neutex": ({"type": "neutex", "feature_strategy": "xyz", "k": 4, "use_logspace": True},
               {}, {"shuffle": "blocks"}),
    "hks": ({**BASE, "k": K, "hks_timesteps": 16}, {"embed_strategy": "hks"},
            {"shuffle": "blocks"}),
}


class Recorder:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, global_step=None):
        self.scalars.append((tag, float(value), global_step))

    def add_image(self, tag, img, global_step=None):
        pass


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A blob mesh, its eigenfunctions and eigenvalues (random), train / val
    / test ray caches with ray directions and face ids, a NeuTex mapping
    from the JAX init; returns a config factory per family."""
    root = str(tmp_path_factory.mktemp("jax_ckpt"))
    mesh = blob_mesh(1)
    write_obj(os.path.join(root, "blob.obj"), mesh.vertices, mesh.faces)
    rng = np.random.default_rng(0)
    np.save(os.path.join(root, "efuncs.npy"),
            rng.normal(size=(mesh.num_vertices, K)).astype(np.float32))
    np.save(os.path.join(root, "evals.npy"), np.sort(rng.uniform(0.5, 40.0, K)).astype(np.float32))
    faces = np.asarray(mesh.faces, np.int32)
    for split, n in (("train", 1024), ("val", 256), ("test", 256)):
        d = os.path.join(root, split)
        os.makedirs(d)
        fid = rng.integers(0, len(faces), n).astype(np.int32)
        dirs = rng.normal(size=(n, 3))
        np.save(os.path.join(d, "face_idxs.npy"), fid)
        np.save(os.path.join(d, "vids_of_hit_faces.npy"), faces[fid])
        np.save(os.path.join(d, "barycentric_coords.npy"),
                rng.dirichlet(np.ones(3), n).astype(np.float32))
        np.save(os.path.join(d, "expected_rgbs.npy"), rng.uniform(size=(n, 3)).astype(np.float32))
        np.save(os.path.join(d, "unit_ray_dirs.npy"),
                (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32))
    wrapper = JaxWrapper(num_freqs=FAMILIES["neutex"][0]["k"])
    variables = wrapper.init({"params": jax.random.PRNGKey(2)},
                             {"xyz": jnp.zeros((5, 3)), "expected_rgbs": jnp.zeros((5, 3))},
                             method=wrapper.loss_and_rgbs)
    mapping = os.path.join(root, "mapping.npz")
    jax_save_npz(mapping, {k: variables["params"]["neutex"][k] for k in (
        "net_inverse_atlasnet_3d_to_uv", "net_atlasnet_uv_to_3d")})

    def config(family, out_name, epochs):
        model, data, training = FAMILIES[family]
        model = dict(model, pretrained_path=mapping) if family == "neutex" else dict(model)
        return {
            "seed": SEED,
            "data": {"preproc_data_path_train": os.path.join(root, "train"),
                     "preproc_data_path_eval": os.path.join(root, "val"),
                     "preproc_data_path_test": os.path.join(root, "test"),
                     "eigenfunctions_path": os.path.join(root, "efuncs.npy"),
                     "eigenvalues_path": os.path.join(root, "evals.npy"),
                     "mesh_path": os.path.join(root, "blob.obj"),
                     "img_height": 24, "img_width": 24, **data},
            "model": model,
            "training": {"out_dir": os.path.join(root, out_name), "batch_size": 256, "lr": LR,
                         "loss_type": "L1", "render_every": 100, "print_every": 1,
                         "epochs": epochs, "checkpoint_every": 1, **training},
        }

    return root, config


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


@pytest.fixture(scope="module")
def jax_run(experiment):
    """family -> the out_dir of one JAX Trainer epoch (model.ckpt,
    checkpoint.ckpt of epoch 0) and that Trainer; made once per family."""
    root, config = experiment
    runs = {}

    def run(family):
        if family not in runs:
            cfg = config(family, f"jax_{family}", 1)
            t = _jax_trainer(cfg)
            t.train()
            runs[family] = (cfg["training"]["out_dir"], t)
        return runs[family]

    return run


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_same_tree(got, want):
    """Equal structure, and per leaf equal value, dtype and shape."""
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    for key, b in w.items():
        a = g[key]
        if isinstance(b, (np.ndarray, np.generic)):
            assert isinstance(a, (np.ndarray, np.generic)), key
            assert a.dtype == b.dtype and np.shape(a) == np.shape(b), key
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            assert type(a) is type(b) and a == b, key


# ------------------------------------------------------------------ families


@pytest.mark.parametrize("family", list(FAMILIES))
def test_decoder_gives_flax_restore(jax_run, family):
    """model.ckpt and checkpoint.ckpt as the JAX Trainer wrote them: the
    port's decoding is flax's msgpack_restore, leaf by leaf."""
    out_dir, _ = jax_run(family)
    for name in ("model.ckpt", "checkpoint.ckpt", "model_last_epoch.ckpt"):
        with open(os.path.join(out_dir, name), "rb") as f:
            data = f.read()
        assert not is_torch_checkpoint(data)
        _assert_same_tree(load_flax_msgpack(data), serialization.msgpack_restore(data))


def _forward_inputs(family, model, n=300, seed=2):
    """(JAX batch, port args) on seeded inputs of the family's width."""
    rng = np.random.default_rng(seed)
    if family == "neutex":
        x = rng.normal(size=(n, 3)).astype(np.float32)
        return {"xyz": jnp.asarray(x), "expected_rgbs": jnp.zeros((n, 3))}, (torch.from_numpy(x),)
    if family == "tf_rff":
        x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        return {"xyz": jnp.asarray(x)}, (torch.from_numpy(x),)
    x = rng.normal(size=(n, model.in_dim)).astype(np.float32)
    batch, args = {"eigenfunctions": jnp.asarray(x)}, (torch.from_numpy(x),)
    if family == "viewdep":
        dirs = rng.normal(size=(n, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        faces = rng.integers(0, 80, n)
        batch.update(unit_ray_dirs=jnp.asarray(dirs), hit_face_idxs=jnp.asarray(faces))
        args += (torch.from_numpy(dirs), torch.from_numpy(faces))
    return batch, args


@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_ckpt_forward_matches_jax(jax_run, experiment, family):
    """The port's module on load_trained_weights(model.ckpt) (chosen by its
    bytes) against the JAX model on flax's restore of the same file,
    within 1e-5; a BatchNorm field in eval mode reads the file's running
    statistics, an RFF field its B."""
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh

    out_dir, jt = jax_run(family)
    _, config = experiment
    cfg = config(family, "unused", 1)
    path = os.path.join(out_dir, "model.ckpt")
    with open(path, "rb") as f:
        variables = serialization.msgpack_restore(f.read())
    model = make_model(cfg["model"], device="cpu", mesh=load_mesh(cfg["data"]["mesh_path"]))
    model.load_state_dict(load_trained_weights(path, cfg["model"]))
    model.eval()
    batch, args = _forward_inputs(family, model)
    want = np.asarray(jt.model.apply(variables, batch))
    with torch.no_grad():
        got = model(*args).numpy()
    assert got.shape == want.shape == (300, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)


def _port_trainer(config, mesh=None):
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh
    from intrinsic_neural_fields_tpu_torch.train import (Trainer, get_data,
                                                         get_model_and_optim, get_renderer)

    mesh = load_mesh(config["data"]["mesh_path"]) if mesh is None else mesh
    model, opt = get_model_and_optim(config, mesh, device="cpu")
    return Trainer(model, opt, config["training"]["loss_type"],
                   get_renderer(config, model, mesh, device="cpu"),
                   get_data(config, mesh, device="cpu"), mesh, config, writer=Recorder(),
                   device="cpu")


def _record_epoch_keys(trainer):
    """The key of every epoch `trainer` (either package's) trains, as JAX
    key data, in order."""
    keys, fn = [], trainer.train_epoch_fn

    def spy(state, key, *args):
        keys.append(key.data if isinstance(key, Key) else np.asarray(key))
        return fn(state, key, *args)

    trainer.train_epoch_fn = spy
    return keys


@pytest.mark.parametrize("family", list(FAMILIES))
def test_trainer_resumes_from_a_jax_checkpoint(jax_run, experiment, family):
    """An out_dir holding only the JAX Trainer's checkpoint.ckpt (epoch 0):
    the port's Trainer restores the decoded params, moments, count and lr
    to the bit, trains epoch 1 only, from the JAX Trainer's epoch key, and
    its update is within 5e-2 of the JAX Trainer's resumed epoch in
    relative norm (nonzero); it writes checkpoint.pt, which a later resume
    takes before the .ckpt."""
    from intrinsic_neural_fields_tpu.train.steps import make_variables
    from intrinsic_neural_fields_tpu_torch.utils.weights import state_dict_from_flax

    root, config = experiment
    out_dir, _ = jax_run(family)
    cfg = config(family, f"port_{family}", 2)
    os.makedirs(cfg["training"]["out_dir"])
    shutil.copy(os.path.join(out_dir, "checkpoint.ckpt"), cfg["training"]["out_dir"])
    decoded = load_jax_train_checkpoint(os.path.join(out_dir, "checkpoint.ckpt"), cfg["model"])
    assert decoded["epoch"] == 0 and decoded["adam"]["count"] == 4

    t = _port_trainer(cfg)
    keys = _record_epoch_keys(t)
    restored = {}
    load = t._init_or_load_checkpoint

    def spy():
        start = load()
        restored.update(start=start, params=t.state.params.clone(), mu=t.state.mu.clone(),
                        nu=t.state.nu.clone(), count=t.state.count, hyper=t.state.hyper)
        return start

    t._init_or_load_checkpoint = spy
    t.train()
    assert restored["start"] == 1 and len(keys) == 1
    layout = t.state.layout
    want_flat = layout.flat_from_state_dict(decoded["model_state_dict"], "cpu")
    assert torch.equal(restored["params"], want_flat)
    for name in ("mu", "nu"):
        want = layout.flat_from_state_dict(decoded["adam"][name], "cpu")
        assert torch.equal(restored[name], want)
    assert restored["count"] == 4 and restored["hyper"].learning_rate == np.float32(LR)
    assert [s for tag, _, s in t.writer.scalars if tag == "Train_Loss"] == [1]
    assert t.state.count == 8
    assert os.path.exists(os.path.join(cfg["training"]["out_dir"], "checkpoint.pt"))

    # the JAX Trainer resumed from the same file, one epoch
    jcfg = config(family, f"jax_resumed_{family}", 2)
    os.makedirs(jcfg["training"]["out_dir"])
    shutil.copy(os.path.join(out_dir, "checkpoint.ckpt"), jcfg["training"]["out_dir"])
    jt = _jax_trainer(jcfg)
    jax_keys = _record_epoch_keys(jt)
    jt.train()
    np.testing.assert_array_equal(keys[0], jax_keys[0])
    np.testing.assert_array_equal(keys[0], jax.random.fold_in(jax.random.PRNGKey(SEED), 1))
    after = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jax.device_get(
        make_variables(jt.state))), cfg["model"])
    jax_update = layout.flat_from_state_dict(after, "cpu") - want_flat
    port_update = t.state.params - restored["params"]
    ref = float(jax_update.norm())
    assert ref > 0 and float(port_update.norm()) > 0
    assert float((port_update - jax_update).norm()) <= UPDATE_TOL * ref

    # a second resume takes the port's checkpoint.pt (epoch 1), not the .ckpt
    cfg3 = config(family, f"port_{family}", 3)
    t3 = _port_trainer(cfg3)
    t3.train()
    assert [s for tag, _, s in t3.writer.scalars if tag == "Train_Loss"] == [2]
    assert t3.state.count == 12


# ------------------------------------------------------------------ the format


def _msgpack_forms():
    """A tree with every msgpack form flax's packer can write."""
    return {
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33,
                 -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
        "floats": [0.0, -1.5, 1e300, float("inf")],
        "none": None, "yes": True, "no": False,
        "strs": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "é" * 3],
        "bins": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
        "arrays": [list(range(15)), list(range(16)), list(range(70000))],
        "maps": {"fix": {str(i): i for i in range(15)}, "m16": {str(i): i for i in range(16)},
                 "m32": {str(i): i for i in range(70000)}},
    }


def test_every_msgpack_form_decodes_as_msgpack_does():
    data = msgpack.packb(_msgpack_forms(), use_bin_type=True)
    assert load_flax_msgpack(data) == msgpack.unpackb(data, raw=False)


@pytest.mark.parametrize("shape", [(), (0, 3), (5,), (2, 3, 4), (70000,)])
def test_array_leaves_decode_as_flax_does(shape):
    """ndarrays (ext 1, in fixext, ext8, ext16 or ext32 by payload size)
    and numpy scalars (ext 3) of every dtype a checkpoint may hold."""
    rng = np.random.default_rng(0)
    tree = {}
    for dtype in ("float32", "float64", "int64", "int32", "uint32", "uint8", "bool", "float16"):
        a = (rng.normal(size=shape) * 100).astype(dtype)
        tree[dtype] = {"array": a,
                       "scalar": a.reshape(-1)[0] if a.size else np.dtype(dtype).type(0)}
    data = serialization.msgpack_serialize(tree)
    _assert_same_tree(load_flax_msgpack(data), serialization.msgpack_restore(data))


def test_fixext_payloads_decode():
    """Array payloads of exactly 16 bytes (fixext 16) and of 252 (ext8)."""
    for n, form in ((5, 0xd8), (240, 0xc7)):
        a = np.arange(n, dtype=np.uint8)
        data = serialization.msgpack_serialize({"a": a})
        assert data[1 + 2] == form  # fixmap, fixstr "a", then the leaf
        np.testing.assert_array_equal(load_flax_msgpack(data)["a"], a)


def test_bfloat16_leaf_is_a_torch_bfloat16_tensor():
    """flax names the dtype "bfloat16"; the port gives a torch.bfloat16
    tensor of the same bits, and the weight carry reads it."""
    a = jnp.asarray(np.random.default_rng(1).normal(size=(4, 6)), jnp.bfloat16)
    data = serialization.msgpack_serialize({"a": np.asarray(a)})
    got = load_flax_msgpack(data)["a"]
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(a, np.float32))


def test_chunked_array_decodes(monkeypatch):
    """An array over flax's MAX_CHUNK_SIZE is written as a chunked map (the
    limit lowered on the writing side only); the port joins its chunks."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    a = np.random.default_rng(2).normal(size=(70, 9)).astype(np.float32)  # 2,520 bytes: 3 chunks
    data = serialization.msgpack_serialize({"params": {"w": a, "small": np.ones(3, np.float32)}})
    assert b"__msgpack_chunked_array__" in data
    got = load_flax_msgpack(data)
    np.testing.assert_array_equal(got["params"]["w"], a)
    assert got["params"]["w"].dtype == np.float32
    _assert_same_tree(got, serialization.msgpack_restore(data))


def _valid_file():
    return serialization.msgpack_serialize({"params": {"w": np.arange(6, dtype=np.float32)},
                                            "epoch": np.int64(3)})


@pytest.mark.parametrize("case,match", [
    ("truncated", "truncated"),
    ("trailing", "trailing"),
    ("type_byte", "unknown type byte 0xc1"),
    ("ext_code", "unknown ext code 7"),
    ("complex", "ext 2"),
    ("payload", "20 bytes for float32"),
])
def test_malformed_files_raise_at_their_offset(case, match):
    data = _valid_file()
    if case == "truncated":
        data = data[:-5]
    elif case == "trailing":
        data = data + b"\x00"
    elif case == "type_byte":
        data = msgpack.packb({"a": 1})[:-1] + b"\xc1"
    elif case == "ext_code":
        data = msgpack.packb({"a": msgpack.ExtType(7, b"abc")})
    elif case == "complex":
        data = serialization.msgpack_serialize({"a": 1 + 2j})
    else:  # 6 floats declared, 5 given
        payload = msgpack.packb(((6,), "float32", b"\x00" * 20), use_bin_type=True)
        data = msgpack.packb({"a": msgpack.ExtType(1, payload)})
    with pytest.raises(ValueError, match=match) as e:
        load_flax_msgpack(data)
    assert "offset" in str(e.value)


def test_adam_state_from_the_file_equals_the_optax_object(jax_run):
    """adam_state_from_optax reads the decoded dict as it reads the optax
    state itself."""
    out_dir, jt = jax_run("efuncs")
    cfg = FAMILIES["efuncs"][0]
    tree = load_flax_msgpack(os.path.join(out_dir, "checkpoint.ckpt"))
    got = adam_state_from_optax(tree["opt_state"], cfg)
    # one epoch ran, so the Trainer's state is the checkpoint's
    want = adam_state_from_optax(jax.device_get(jt.state.opt_state), cfg)
    assert {k: got[k] for k in ("count", "lr", "b1", "b2", "eps", "eps_root")} == {
        k: want[k] for k in ("count", "lr", "b1", "b2", "eps", "eps_root")}
    for name in ("mu", "nu"):
        assert set(got[name]) == set(want[name])
        assert all(torch.equal(got[name][k], want[name][k]) for k in want[name])
    with pytest.raises(ValueError, match="inject_hyperparams"):
        adam_state_from_optax({"count": 0, "inner_state": {"0": {"count": 0}}}, cfg)


# ------------------------------------------------------------------ the out_dir


def test_weights_resolution_never_swaps_a_named_file(tmp_path):
    """Default: model.pt, else the JAX package's model.ckpt. A named file
    is that file: missing, it raises FileNotFoundError; a file of neither
    format raises ValueError."""
    cfg = {**BASE, "k": K}
    out = str(tmp_path)
    assert resolve_weights_path(out) == os.path.join(out, "model.pt")
    params = jax.tree_util.tree_map(np.asarray, _flax_params(cfg))
    jax_save_checkpoint(os.path.join(out, "model.ckpt"), {"params": params})
    assert resolve_weights_path(out) == os.path.join(out, "model.ckpt")
    sd = load_trained_weights(resolve_weights_path(out), cfg)
    save_model(os.path.join(out, "model.pt"), {k: v + 1 for k, v in sd.items()})
    assert resolve_weights_path(out) == os.path.join(out, "model.pt")
    assert resolve_weights_path(out, "model_last_epoch.ckpt") == os.path.join(
        out, "model_last_epoch.ckpt")
    with pytest.raises(FileNotFoundError):
        load_trained_weights(resolve_weights_path(out, "model_last_epoch.ckpt"), cfg)
    got = load_trained_weights(os.path.join(out, "model.pt"), cfg)
    assert all(torch.equal(got[k], sd[k] + 1) for k in sd)
    with open(os.path.join(out, "junk.bin"), "wb") as f:
        f.write(b"\x01\x02\x03")
    with pytest.raises(ValueError, match="neither"):
        load_trained_weights(os.path.join(out, "junk.bin"), cfg)


def _flax_params(cfg, seed=0):
    from intrinsic_neural_fields_tpu.models import init_model
    from intrinsic_neural_fields_tpu.models import make_model as jax_make_model

    return init_model(jax_make_model(cfg), cfg, seed=seed)["params"]


def _scores(metrics):
    """Per view (PSNR, DSSIM); LPIPS is NaN without its weights."""
    return {view: (m["psnr"], m["dssim_rescaled"]) for view, m in metrics.items()}


def test_eval_and_bake_read_a_jax_out_dir(jax_run, experiment, tmp_path):
    """The eval CLI on an out_dir holding only the JAX Trainer's model.ckpt
    equals, to the bit, the eval of a model.pt the port saved from the
    same decoded weights; --weights takes a .ckpt; the bake's field
    colours likewise; a named missing --weights raises."""
    from intrinsic_neural_fields_tpu_torch.bake.bake import _field_rgbs
    from intrinsic_neural_fields_tpu_torch.eval import main as eval_main
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh
    from tests.test_torch_port_eval_cli import _write_dataset

    root, config = experiment
    out_dir, _ = jax_run("efuncs")
    mesh = load_mesh(os.path.join(root, "blob.obj"))
    data = str(tmp_path / "views")
    os.makedirs(data)
    _write_dataset(data, mesh)
    metrics, rgbs = {}, {}
    for name in ("ckpt", "pt"):
        cfg = config("efuncs", f"eval_{name}", 1)
        os.makedirs(cfg["training"]["out_dir"])
        if name == "ckpt":
            shutil.copy(os.path.join(out_dir, "model.ckpt"), cfg["training"]["out_dir"])
        else:
            save_model(os.path.join(cfg["training"]["out_dir"], "model.pt"), load_trained_weights(
                os.path.join(out_dir, "model.ckpt"), cfg["model"]))
        path = str(tmp_path / f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        eval_main([str(tmp_path / f"out_{name}"), path, data, "test", "--device", "cpu"])
        with open(tmp_path / f"out_{name}" / "evaluation_metrics.pkl", "rb") as f:
            metrics[name] = pickle.load(f)
        vids = np.asarray(mesh.faces[:50])
        rgbs[name] = _field_rgbs(mesh, cfg, vids, np.full((50, 3), 1 / 3, np.float32),
                                 device="cpu")
    assert _scores(metrics["ckpt"]) == _scores(metrics["pt"]) and len(metrics["pt"]) == 2
    assert all(np.isfinite(v) for view in _scores(metrics["pt"]).values() for v in view)
    np.testing.assert_array_equal(rgbs["ckpt"], rgbs["pt"])
    eval_main([str(tmp_path / "out_named"), path, data, "test", "--device", "cpu", "--weights",
               os.path.join(out_dir, "model.ckpt")])
    with open(tmp_path / "out_named" / "evaluation_metrics.pkl", "rb") as f:
        assert _scores(pickle.load(f)) == _scores(metrics["pt"])
    with pytest.raises(FileNotFoundError):
        eval_main([str(tmp_path / "out_missing"), path, data, "test", "--device", "cpu",
                   "--weights", os.path.join(out_dir, "model_best.ckpt")])


# ------------------------------------------------------------------ the committed fixture


def test_committed_fixture_decodes_as_flax_does():
    """tests/data/jax_checkpoint_hq: the HQ recipe's model (k=512, 6 x 128,
    skip 3) after a few JAX train steps; both files decode equal to
    flax's restore, and the train checkpoint's state is what expected.npz
    records (epoch, a nonzero count, lr; nonzero moments)."""
    expected = np.load(os.path.join(FIXTURE, "expected.npz"))
    cfg = {"k": 512, "num_layers": 6, "mlp_hidden_dim": 128, "skip_layer_idx": 3}
    for name in ("model.ckpt", "checkpoint.ckpt"):
        with open(os.path.join(FIXTURE, name), "rb") as f:
            data = f.read()
        _assert_same_tree(load_flax_msgpack(data), serialization.msgpack_restore(data))
    ck = load_jax_train_checkpoint(os.path.join(FIXTURE, "checkpoint.ckpt"), cfg)
    assert ck["epoch"] == int(expected["epoch"]) and ck["adam"]["count"] == int(expected["count"])
    assert ck["adam"]["count"] > 0 and np.float32(ck["adam"]["lr"]) == expected["lr"]
    assert all(float(v.abs().max()) > 0 for v in ck["adam"]["nu"].values())
    sd = load_trained_weights(os.path.join(FIXTURE, "model.ckpt"), cfg)
    assert all(torch.equal(sd[k], ck["model_state_dict"][k]) for k in sd)
    make_model(cfg, device="cpu").load_state_dict(sd)


def test_committed_fixture_forward_is_the_jax_forward():
    """expected.npz's rgb is the JAX package's fused forward (Pallas in
    interpret mode) on the fixture's rows, within 1e-6; the rows are
    drawn as the fixture tool draws them (their sum recorded)."""
    import sys

    from intrinsic_neural_fields_tpu.ops.fused_mlp import FusedMLPSpec as JaxSpec
    from intrinsic_neural_fields_tpu.ops.fused_mlp import make_fused_apply, params_to_list

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_jax_checkpoint_fixture import fixture_rows

    expected = np.load(os.path.join(FIXTURE, "expected.npz"))
    rows = fixture_rows(int(expected["seed"]))
    assert rows.astype(np.float64).sum() == expected["rows_sum"]
    with open(os.path.join(FIXTURE, "model.ckpt"), "rb") as f:
        params = serialization.msgpack_restore(f.read())["params"]
    spec = JaxSpec(num_layers=6, k_in=512, hidden=128, skip_idx=3)
    got = make_fused_apply(spec, batch_tile=512, interpret=True)(
        params_to_list(spec, jax.tree_util.tree_map(jnp.asarray, params)), jnp.asarray(rows))
    np.testing.assert_allclose(np.asarray(got), expected["rgb"], rtol=0, atol=1e-6)
    assert expected["rgb"].shape == (8192, 3)


def test_committed_fixture_plain_twin_is_within_the_kernel_tolerance():
    """The port's forward on the CPU (the kernel's plain twin, bf16
    operands) on model.ckpt's weights against expected.npz, within the
    smoke's kernel tolerance (2e-3)."""
    import sys

    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (FusedMLPSpec, fused_apply,
                                                                 pack_weights)

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_jax_checkpoint_fixture import fixture_rows

    expected = np.load(os.path.join(FIXTURE, "expected.npz"))
    cfg = {"k": 512, "num_layers": 6, "mlp_hidden_dim": 128, "skip_layer_idx": 3}
    fw = pack_weights(FusedMLPSpec(6, 512, 128, 3),
                      load_trained_weights(os.path.join(FIXTURE, "model.ckpt"), cfg))
    got = fused_apply(fw, torch.from_numpy(fixture_rows(int(expected["seed"])))).numpy()
    np.testing.assert_allclose(got, expected["rgb"], rtol=0, atol=2e-3)
