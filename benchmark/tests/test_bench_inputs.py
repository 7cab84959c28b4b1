"""The inputs and the traffic repeat from the seed and change with it."""
import json
import os

import numpy as np
import pytest
import torch

from benchmark import inputs

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SMALL_CAT = {"k": 16, "train_data": {"num_vertices": 50, "num_hits": 300}, "model": {}}
SMALL_VD = {"k": 16, "train_data": {"mesh": {"kind": "blob", "subdivisions": 1},
                                    "num_hits": 300}, "model": {}}


@pytest.mark.parametrize("cfg", [SMALL_CAT, SMALL_VD])
def test_train_arrays_repeat_from_the_seed(cfg):
    seed = 2**31 + 3
    a, b = (inputs.train_arrays(cfg, seed, "cpu") for _ in range(2))
    c = inputs.train_arrays(cfg, seed + 1, "cpu")
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k]), k
    assert not torch.equal(a["basis"], c["basis"])
    assert torch.allclose(a["bary"].sum(1), torch.ones(300)) and (a["bary"] >= 0).all()
    assert int(a["vids"].max()) < a["basis"].shape[0]
    if "dirs" in a:
        n = torch.as_tensor(inputs.face_normals(a["vertices"], a["faces"]), dtype=torch.float32)
        assert ((a["dirs"] * n[a["face_idxs"]]).sum(1) <= 0).all()
        assert torch.equal(a["vids"], torch.as_tensor(a["faces"])[a["face_idxs"]])


def test_orbit_and_samples_repeat_from_the_seed():
    with open(os.path.join(ROOT, "benchmark", "traffic", "render_orbit.json")) as f:
        tr = json.load(f)
    a, b, c = inputs.orbit(tr, 7), inputs.orbit(tr, 7), inputs.orbit(tr, 8)
    assert len(a) == len(c) == tr["views"]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    # every view looks at the origin from the ring's radius
    for cam in a:
        assert np.isclose(np.linalg.norm(cam[:, 3]), tr["radius"] * np.hypot(1, tr["height"]),
                          rtol=1e-5)
        assert np.allclose(cam[:, 2], -cam[:, 3] / np.linalg.norm(cam[:, 3]), atol=1e-5)
    s = inputs.sample_frames(7, tr["sample_below"], tr["sample_frames"])
    assert s == inputs.sample_frames(7, tr["sample_below"], tr["sample_frames"])
    assert len(set(s)) == tr["sample_frames"] and max(s) < tr["sample_below"]
    blocks = inputs.check_rows(9, 512, 3)
    assert blocks == inputs.check_rows(9, 512, 3) and len(set(blocks)) == 3


def test_weights_repeat_and_follow_xavier():
    shapes = {"a.weight": (128, 1023), "a.bias": (128,), "b.weight": (3, 128)}
    w1 = inputs.initial_weights(shapes, inputs.generator(5, "cpu"), "cpu")
    w2 = inputs.initial_weights(shapes, inputs.generator(5, "cpu"), "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in shapes)
    assert float(w1["a.bias"].abs().max()) == 0.0
    bound = (6.0 / (128 + 1023)) ** 0.5
    assert float(w1["a.weight"].abs().max()) <= bound
    assert float(w1["a.weight"].std()) == pytest.approx(bound / 3 ** 0.5, rel=0.02)


@pytest.mark.parametrize("subdivisions", [0, 1, 3])
def test_icosphere_is_closed_and_matches_the_face_count(subdivisions):
    v, f = inputs.icosphere(subdivisions)
    assert len(f) == 20 * 4 ** subdivisions and len(v) == 10 * 4 ** subdivisions + 2
    assert np.allclose(np.linalg.norm(v, axis=1), 1.0)
    e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    assert (counts == 2).all()  # every edge shared by two faces
    n = inputs.face_normals(v, f)
    centroid = v[f].mean(1)
    assert ((n * centroid).sum(1) > 0).all()  # outward, counter-clockwise faces
