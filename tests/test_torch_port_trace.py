"""The port's spans and counters (ops/launches.py): off without a profiler,
recorded under one, kept out of the profiler's own events, and placed at
the render's and the train epoch's stages."""
import contextlib
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from intrinsic_neural_fields_tpu_torch.data.sampler import RayData, precompute_hit_features
from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
from intrinsic_neural_fields_tpu_torch.models import make_model
from intrinsic_neural_fields_tpu_torch.ops import launches
from intrinsic_neural_fields_tpu_torch.ops.launches import add, reset_kernel_launches, span, spans
from intrinsic_neural_fields_tpu_torch.render.renderer import Renderer
from intrinsic_neural_fields_tpu_torch.train.steps import (
    AdamHyper,
    create_train_state,
    make_epoch_fns,
)
from intrinsic_neural_fields_tpu_torch.utils.jax_random import PRNGKey, fold_in
from intrinsic_neural_fields_tpu_torch.utils.pipeline import pipelined_foreach

torch.set_num_threads(2)

ALL = (0, 2**63 - 1)  # every start time


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


def test_off_without_a_profiler():
    """No profiler: span returns the one shared null context, add and the
    block leave no record."""
    reset_kernel_launches()
    assert span("a") is span("b", x=1)
    assert isinstance(span("a"), contextlib.nullcontext)
    with span("a", x=1):
        add("x", 5)
    assert spans(*ALL) == ([], 0)


def test_records_under_a_profiler():
    """Names, parents, clocks, add (a number and a device tensor, read as
    an int) and the window filter."""
    reset_kernel_launches()
    with _profiled():
        t0 = time.time_ns()
        with span("outer", frame=7):
            add("n", 2)
            with span("inner"):
                add("n", 3)
                add("n", torch.tensor(4))
                time.sleep(0.002)
            add("n", 1)
        t1 = time.time_ns()
        time.sleep(0.001)
        with span("late"):
            pass
    records, dropped = spans(t0, t1)
    assert dropped == 0
    by = _by_name(records)
    assert set(by) == {"outer", "inner"}  # "late" started after t1
    (outer,), (inner,) = by["outer"], by["inner"]
    assert outer["parent"] is None and inner["parent"] == outer["id"]
    assert outer["attrs"] == {"frame": 7, "n": 3} and inner["attrs"] == {"n": 7}
    assert isinstance(inner["attrs"]["n"], int)
    assert t0 <= outer["start_ns"] <= inner["start_ns"] < inner["end_ns"] <= outer["end_ns"] <= t1
    assert inner["end_ns"] - inner["start_ns"] >= 2_000_000
    assert [r["name"] for r in records] == ["inner", "outer"]  # in the order they closed
    assert [r["name"] for r in spans(*ALL)[0]] == ["inner", "outer", "late"]


def test_ring_bound_and_dropped_count():
    """The ring keeps the last RING records and counts the ones it let go,
    for a window they may have started in."""
    reset_kernel_launches()
    extra = 5
    with _profiled():
        for i in range(launches.RING + extra):
            with span("s", i=i):
                if i == extra:
                    after_dropped = time.time_ns()
    records, dropped = spans(*ALL)
    assert len(records) == launches.RING and dropped == extra
    assert records[0]["attrs"]["i"] == extra
    assert spans(after_dropped, ALL[1])[1] == 0
    reset_kernel_launches()
    assert spans(*ALL) == ([], 0)


def _renderer(H, W):
    m = icosphere(3)
    efuncs = np.random.default_rng(0).normal(size=(m.num_vertices, 16)).astype(np.float32)
    cfg = {"k": 16, "num_layers": 4, "mlp_hidden_dim": 32, "skip_layer_idx": 2}
    return Renderer(make_model(cfg, seed=0, device="cpu"), m, efuncs, H=H, W=W, device="cpu")


def _look_at(eye):
    z = -np.asarray(eye, float) / np.linalg.norm(eye)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    cam = np.eye(4)[:3]
    cam[:, 0], cam[:, 1], cam[:, 2], cam[:, 3] = x, np.cross(z, x), z, eye
    return cam.astype(np.float32)


def _blocks_epoch(n=1024, B=256, k=16, seed=0):
    rng = np.random.default_rng(seed)
    data = precompute_hit_features(RayData(
        features=torch.from_numpy(rng.normal(size=(60, k)).astype(np.float32)),
        feature_strategy="efuncs",
        vertex_idxs_of_hit_faces=torch.from_numpy(rng.integers(0, 60, size=(n, 3))),
        barycentric_coords=torch.from_numpy(rng.dirichlet(np.ones(3), size=n).astype(np.float32)),
        expected_rgbs=torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32))),
        dtype=torch.bfloat16)
    model = make_model({"k": k, "num_layers": 4, "mlp_hidden_dim": 128, "skip_layer_idx": 1},
                       seed=seed, device="cpu")
    train_epoch, _ = make_epoch_fns(model, "L1", shuffle="blocks", fused=True)
    return train_epoch, create_train_state(model, AdamHyper(1e-3), "cpu"), data, n // B, B


def test_render_frames_carry_their_spans():
    """Frames through pipelined_foreach at depth 2: one render.async and
    one render.fetch per frame, the fetch of frame i after the dispatch of
    frame i + 1; render.infer's rays H*W and hits the frame's valid pixels,
    chunk steps > 0; every stage under its frame's span."""
    H = W = 32
    r = _renderer(H, W)
    K = np.array([[1.2 * W, 0, W / 2], [0, 1.2 * W, H / 2], [0, 0, 1]], np.float32)
    cams = [_look_at([3 * np.cos(a), 3 * np.sin(a), 0.6]) for a in (0.0, 1.0, 2.0, 3.0, 4.0)]
    hits = [len(r.render(c, K, eval_render=True)[1]) for c in cams]
    assert all(0 < h < H * W for h in hits)
    reset_kernel_launches()
    with _profiled():
        pipelined_foreach(range(len(cams)), lambda i: r.render_async(cams[i], K),
                          lambda i, h: r.render_fetch(h), depth=2)
    records, dropped = spans(*ALL)
    assert dropped == 0
    by = _by_name(records)
    ids = {rec["id"]: rec for rec in records}
    dispatches, fetches = by["render.async"], by["render.fetch"]
    assert len(dispatches) == len(fetches) == len(cams)
    assert all(d["parent"] is None and d["attrs"] == {} for d in dispatches + fetches)
    for i in range(len(cams) - 1):  # depth 2: frame i + 1 is dispatched before frame i's fetch
        assert dispatches[i + 1]["end_ns"] <= fetches[i]["start_ns"]
    for name, parent in (("render.trace", "render.async"), ("render.infer", "render.async"),
                         ("raster.bin", "render.trace"), ("raster.sync", "render.trace"),
                         ("render.fetch.copy", "render.fetch"),
                         ("render.fetch.scatter", "render.fetch")):
        assert len(by[name]) == len(cams), name
        assert all(ids[rec["parent"]]["name"] == parent for rec in by[name]), name
    frame_of = {d["id"]: i for i, d in enumerate(sorted(dispatches, key=lambda d: d["start_ns"]))}
    infer_hits = {frame_of[i["parent"]]: i["attrs"]["hits"] for i in by["render.infer"]}
    assert [infer_hits[f] for f in range(len(cams))] == hits
    assert all(i["attrs"]["rays"] == H * W for i in by["render.infer"])
    assert all(set(t["attrs"]) == {"chunk_steps"} and t["attrs"]["chunk_steps"] > 0
               for t in by["render.trace"])


def test_blocks_epoch_and_prefetch_spans():
    """A CPU blocks epoch: train.epoch (steps) with a train.hyper_rows
    child; prefetch gives train.prefetch."""
    train_epoch, state, data, nb, B = _blocks_epoch()
    reset_kernel_launches()
    with _profiled():
        train_epoch.prefetch(fold_in(PRNGKey(0), 1), data, nb, B)
        state, m = train_epoch(state, fold_in(PRNGKey(0), 1), data, nb, B)
        float(m["loss"])
    by = _by_name(spans(*ALL)[0])
    (epoch,), (rows,), (pre,) = by["train.epoch"], by["train.hyper_rows"], by["train.prefetch"]
    assert epoch["attrs"] == {"steps": nb} and rows["parent"] == epoch["id"]
    assert pre["parent"] is None and pre["end_ns"] <= epoch["start_ns"]


def test_no_span_among_the_profiler_events():
    """The spans are no record_function ranges: none of their names is
    among the profiler's own events, though they were recorded."""
    H = W = 24
    r = _renderer(H, W)
    K = np.array([[1.2 * W, 0, W / 2], [0, 1.2 * W, H / 2], [0, 0, 1]], np.float32)
    train_epoch, state, data, nb, B = _blocks_epoch(n=512)
    reset_kernel_launches()
    with _profiled() as p:
        r.render(_look_at([0.0, -3.0, 0.5]), K)
        train_epoch(state, np.arange(nb), data, nb, B)
    names = {rec["name"] for rec in spans(*ALL)[0]}
    assert {"render.async", "raster.sync", "render.fetch", "train.epoch"} <= names
    seen = {e.name() for e in p.profiler.kineto_results.events()}
    assert seen and not names & seen
