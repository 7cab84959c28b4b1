"""Port parity of the ray-cache loader and the sampler: the 5-npy contract,
the one-time global shuffle (replaying jax.random.permutation), the
precomputed hit-feature table (bf16 storage, f32 interpolation) and the
batch assembly, against the JAX package on the same files."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsic_neural_fields_tpu.data import sampler as jax_sampler
from intrinsic_neural_fields_tpu.data.load import load_preprocessed_data as jax_load

from intrinsic_neural_fields_tpu_torch.data import sampler
from intrinsic_neural_fields_tpu_torch.data.load import load_preprocessed_data

torch.set_num_threads(2)

V, K, N = 200, 24, 1000
TERM_ULP = 2.0 ** -22  # two f32 ulps relative to the largest interpolated term


def _term_scale(data):
    return float(data.features.abs().max())


def write_cache(path, n=N, v=V, k=K, seed=0, views=True):
    """A random 5-npy ray cache and a [v, k+1] eigenfunction file."""
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "vids_of_hit_faces.npy"),
            rng.integers(0, v, size=(n, 3)).astype(np.int32))
    np.save(os.path.join(path, "barycentric_coords.npy"),
            rng.dirichlet(np.ones(3), size=n).astype(np.float32))
    np.save(os.path.join(path, "expected_rgbs.npy"), rng.uniform(size=(n, 3)).astype(np.float32))
    if views:
        dirs = rng.normal(size=(n, 3))
        np.save(os.path.join(path, "unit_ray_dirs.npy"),
                (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32))
        np.save(os.path.join(path, "face_idxs.npy"), rng.integers(0, 50, size=n).astype(np.int32))
    efuncs = os.path.join(path, "efuncs.npy")
    np.save(efuncs, rng.normal(size=(v, k + 1)).astype(np.float32))
    return efuncs


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cache"))
    return path, write_cache(path)


def test_load_contract_matches(cache):
    path, _ = cache
    got, want = load_preprocessed_data(path), jax_load(path)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("dtype", ["bfloat16", None])
def test_create_ray_data_replays_the_shuffle_and_table(cache, dtype):
    """With the JAX permutation replayed, every record equals the JAX
    package's bit for bit. Both interpolate in f32 as b0*f0 + b1*f1 + b2*f2,
    but XLA's CPU code contracts that chain into fused multiply-adds, so an
    f32 table entry may differ by an ulp of its largest term (TERM_ULP);
    rounded to bf16 that changes an entry only when it sits that close to a
    bf16 tie (none do here)."""
    path, efuncs = cache
    ref = jax_sampler.create_ray_data(path, efuncs, K, "efuncs", None, precompute_dtype=dtype,
                                      seed=3)
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(3), N))
    got = sampler.create_ray_data(path, efuncs, K, precompute_dtype=dtype, perm=perm,
                                  device="cpu")
    assert got.n == ref.n == N
    for name in ("vertex_idxs_of_hit_faces", "barycentric_coords", "expected_rgbs",
                 "unit_ray_dirs", "face_idxs", "features"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    want = np.asarray(ref.hit_features, np.float32)
    have = got.hit_features.to(torch.float32).numpy()
    if dtype == "bfloat16":
        assert got.hit_features.dtype == torch.bfloat16
        np.testing.assert_array_equal(have, want)
    else:
        assert got.hit_features.dtype == torch.float32
        np.testing.assert_allclose(have, want, rtol=0, atol=TERM_ULP * _term_scale(got))


def test_default_shuffle_is_seeded(cache):
    path, efuncs = cache
    a = sampler.create_ray_data(path, efuncs, K, seed=5, device="cpu")
    b = sampler.create_ray_data(path, efuncs, K, seed=5, device="cpu")
    c = sampler.create_ray_data(path, efuncs, K, seed=6, device="cpu")
    raw = sampler.create_ray_data(path, efuncs, K, shuffle_once=False, device="cpu")
    assert torch.equal(a.expected_rgbs, b.expected_rgbs)
    assert not torch.equal(a.expected_rgbs, c.expected_rgbs)
    # a permutation of the records: the same rows in another order
    assert sorted(map(tuple, a.expected_rgbs.tolist())) == sorted(
        map(tuple, raw.expected_rgbs.tolist()))
    np.testing.assert_allclose(a.expected_rgbs.sum(0).numpy(), raw.expected_rgbs.sum(0).numpy(),
                               rtol=1e-5)


def test_precompute_budget_rule(cache, monkeypatch):
    """Above PRECOMPUTE_BYTES_LIMIT (table bytes in the storage dtype) the
    table is not built and batches interpolate per step, as in JAX."""
    path, efuncs = cache
    monkeypatch.setattr(sampler, "PRECOMPUTE_BYTES_LIMIT", N * K * 2)
    assert sampler.create_ray_data(path, efuncs, K, precompute_dtype="bfloat16",
                                   device="cpu").hit_features is not None
    assert sampler.create_ray_data(path, efuncs, K, precompute_dtype="float32",
                                   device="cpu").hit_features is None
    assert sampler.create_ray_data(path, efuncs, K, precompute=True, precompute_dtype="float32",
                                   device="cpu").hit_features is not None


def test_batches_match(cache):
    path, efuncs = cache
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(0), N))
    ref = jax_sampler.create_ray_data(path, efuncs, K, "efuncs", None, seed=0)
    ref_noprec = jax_sampler.create_ray_data(path, efuncs, K, "efuncs", None, seed=0,
                                             precompute=False)
    got = sampler.create_ray_data(path, efuncs, K, perm=perm, device="cpu")
    got_noprec = sampler.create_ray_data(path, efuncs, K, perm=perm, precompute=False,
                                         device="cpu")
    idx = np.random.default_rng(1).integers(0, N, size=77)
    for r, g in ((ref, got), (ref_noprec, got_noprec)):
        want = jax_sampler.gather_batch(r, jnp.asarray(idx))
        have = sampler.gather_batch(g, torch.from_numpy(idx))
        assert set(have) == set(want)
        for key in want:
            np.testing.assert_allclose(have[key].numpy(), np.asarray(want[key]), rtol=0,
                                       atol=1e-6)
    want = jax_sampler.slice_batch(ref, 256, 256)
    have = sampler.slice_batch(got, 256, 256)
    for key in want:  # f32 table rows (see above)
        np.testing.assert_allclose(have[key].numpy(), np.asarray(want[key]), rtol=0,
                                   atol=TERM_ULP * _term_scale(got))
    with pytest.raises(ValueError):
        sampler.slice_batch(got, N - 10, 256)
    for n, b, drop in ((1000, 256, True), (1000, 256, False), (1024, 256, False)):
        assert sampler.num_train_batches(n, b, drop) == jax_sampler.num_train_batches(n, b, drop)


def test_entry_point_defaults_to_cuda(cache):
    path, efuncs = cache
    if torch.cuda.is_available():
        pytest.skip("the CUDA default is exercised on the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sampler.create_ray_data(path, efuncs, K)
