"""The port's bench: root bench.py's train and render legs on the card.

  python -m intrinsic_neural_fields_tpu_torch.bench [--device cuda]

The same workloads, arrays and JSON line as root ``bench.py`` (which drives
the JAX package), run through the port's own entry points and kernels:

  - train: V=30k vertices x k=1023 eigenfunctions, 2^21 cached hits stored
    as a bf16 table, batch 4096, L1, Adam lr 1e-4, a 6x128 skip-3
    TextureField; blocks epochs through ``train/steps.py:make_epoch_fns``
    (on the card one CUDA-graph replay per epoch, two kernel launches per
    step: ``fused_mlp_fwd_bwd`` and ``fused_mlp_wgrad_adam``);
  - render: 512^2 over the 81,920-face blob, a random k=1023 basis, a bf16
    feature table and the u8 wire, 10 frames through a depth-2 pipeline
    (``fused_mlp_fwd`` is the network in every 8192-ray chunk);
  - baseline: the reference's per-batch torch hot loop on the CPU.

Earlier lines of output say what ran (the card's name and power limit, per
leg launches, graph replays, set-up seconds, peak memory, a frame's stage
times); the last line is one JSON object with bench.py's eight keys. A leg
that fails raises: there is no CPU fallback, and ``--device cuda`` without
a card raises. ``--device cpu`` runs the kernels' plain twins (for tests at
small sizes; its numbers are CPU numbers).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import resolve_device
from .data.sampler import RayData, precompute_hit_features
from .geometry.synthetic import blob_mesh, pinhole_K, ring_cameras
from .models import make_model
from .ops.fused_mlp import kernel_launches, reset_kernel_launches
from .render.renderer import Renderer
from .train.steps import AdamHyper, create_train_state, make_epoch_fns
from .utils.jax_random import PRNGKey, fold_in
from .utils.pipeline import pipelined_foreach

# bench.py:26-33, the workload of configs/texture_reconstruction/intrinsic_cat.yaml
V = 30_000
K = 1023
N = 1 << 21  # precomputed [N,K] hit features stored bf16: 4.3 GB on the card
BATCH = 4096
HIDDEN = 128
LAYERS = 6
SKIP = 3
SEED = 0
# bench.py's leg sizes: timed train epochs in groups, render frames at H^2
# over the blob at this icosphere subdivision, pipeline depth
EPOCHS = 48
GROUP = 16
FRAMES = 10
RENDER_H = 512
SUBDIVISIONS = 6
DEPTH = 2
# The render baseline: the rays/s of the reference's render loop (Embree
# host trace + torch-CPU inference, reference renderer.py:112-119), measured
# by the JAX package's tools/bench_render.py on that machine's host CPU
# (bench.py:171). It is not a number of this card; there is no Embree here
# to measure it again.
REF_RENDER_RAYS_PER_S = 32_000.0


def model_config(k=K):
    return {"k": k, "num_layers": LAYERS, "mlp_hidden_dim": HIDDEN, "skip_layer_idx": SKIP}


def make_arrays(seed=SEED, V=V, K=K, N=N):
    """bench.py:make_arrays: the same numpy draws, so both benches read the
    same bytes: features [V,K], hit vertex ids [N,3], barycentrics [N,3],
    target colors [N,3]."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(V, K)).astype(np.float32)
    vids = rng.integers(0, V, size=(N, 3)).astype(np.int32)
    bary = rng.dirichlet(np.ones(3), size=N).astype(np.float32)
    rgbs = rng.uniform(size=(N, 3)).astype(np.float32)
    return feats, vids, bary, rgbs


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_mem_gb(dev):
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None


@dataclass
class TrainLeg:
    """What train_leg ran and measured; the state, table and epoch function
    stay usable (chip_smoke.py checks and profiles them)."""

    rays_per_s_best: float
    rays_per_s_median: float
    epoch_s: list          # per timed group: its wall seconds per epoch
    losses: list           # every epoch's mean L1, the warm epoch first
    launches: dict         # kernel launches over every epoch, the warm one included
    graph_replays_per_epoch: float
    graph_captures: int
    graph_capture_s: float
    precompute_s: float
    peak_mem_gb: float | None
    steps_per_epoch: int
    batch: int
    state: object = field(repr=False)
    data: object = field(repr=False)
    train_epoch: object = field(repr=False)

    @property
    def launches_per_step(self):
        steps = len(self.losses) * self.steps_per_epoch
        return {n: c / steps for n, c in self.launches.items() if c}

    def summary(self):
        return {"leg": "train", "k": int(self.data.hit_features.shape[1]), "N": self.data.n,
                "batch": self.batch, "steps_per_epoch": self.steps_per_epoch,
                "rays_per_s_best": self.rays_per_s_best,
                "rays_per_s_median": self.rays_per_s_median, "epoch_s": self.epoch_s,
                "launches_per_step": self.launches_per_step,
                "graph_replays_per_epoch": self.graph_replays_per_epoch,
                "graph_captures": self.graph_captures, "graph_capture_s": self.graph_capture_s,
                "precompute_s": self.precompute_s, "peak_mem_gb": self.peak_mem_gb,
                "loss_first": self.losses[0], "loss_last": self.losses[-1]}


def train_leg(arrays, device="cuda", epochs=EPOCHS, group=GROUP, batch=BATCH, model=None):
    """bench.py:bench_ours on the port: the hit features precomputed once
    into a bf16 table, then blocks epochs of N // batch steps of the fused
    train step with Adam. One warm epoch (on the card it captures the
    epoch's CUDA graph), then max(epochs // group, 1) timed groups of
    `group` epochs, each closed by one synchronize. Epoch e shuffles its
    blocks as bench.py's do: the warm epoch from key = PRNGKey(SEED), epoch
    e from fold_in(key, e) (utils/jax_random.py). model: a
    TextureField to train (default: make_model(model_config(k), seed=0)).

    On the card every epoch must be one graph replay of two launches per
    step, fused_mlp_fwd_bwd and fused_mlp_wgrad_adam, and nothing else
    (counted by ops/launches.py); the leg raises otherwise, and on a
    non-finite loss."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    feats, vids, bary, rgbs = (torch.from_numpy(a).to(dev) for a in arrays)
    t0 = time.perf_counter()
    data = precompute_hit_features(RayData(feats, "efuncs", vids.long(), bary, rgbs),
                                   dtype=torch.bfloat16)
    _sync(dev)
    precompute_s = time.perf_counter() - t0
    if model is None:
        model = make_model(model_config(feats.shape[1]), seed=0, device=dev)
    state = create_train_state(model, AdamHyper(1e-4), dev)
    train_epoch, _ = make_epoch_fns(model, "L1", shuffle="blocks", fused=True)
    nb = data.n // batch

    reset_kernel_launches()
    replays0 = train_epoch.graph.replays
    key = PRNGKey(SEED)
    state, m = train_epoch(state, key, data, nb, batch)
    losses = [m["loss"]]
    _sync(dev)
    # Chain the epochs of a group with ONE final sync: a real training run
    # never blocks the device on a per-epoch host fetch either. Best of
    # groups: the card may be shared, and a contended group's wall time can
    # double; the minimum is the least-polluted estimate of what the card
    # delivers (the median is reported beside it).
    times = []
    e = 0
    for _ in range(max(epochs // group, 1)):
        t0 = time.perf_counter()
        for _ in range(group):
            e += 1
            state, m = train_epoch(state, fold_in(key, e), data, nb, batch)
            losses.append(m["loss"])
        _sync(dev)
        times.append((time.perf_counter() - t0) / group)
    losses = [float(x) for x in losses]
    if not np.isfinite(losses).all():
        raise RuntimeError(f"bench train leg: non-finite epoch losses {losses}")

    steps = (1 + e) * nb
    launches = kernel_launches()
    replays = train_epoch.graph.replays - replays0
    if dev.type == "cuda" and not (
            launches["fused_mlp_fwd_bwd"] == launches["fused_mlp_wgrad_adam"] == steps
            and sum(launches.values()) == 2 * steps and replays == 1 + e):
        raise RuntimeError("bench train leg: the epochs were not one graph replay of two "
                           f"launches per step ({1 + e} epochs of {nb} steps): {launches}, "
                           f"{replays} replays")
    rays = nb * batch
    return TrainLeg(
        rays_per_s_best=rays / min(times), rays_per_s_median=rays / float(np.median(times)),
        epoch_s=times, losses=losses, launches={n: c for n, c in launches.items() if c},
        graph_replays_per_epoch=replays / (1 + e), graph_captures=train_epoch.graph.captures,
        graph_capture_s=train_epoch.graph.capture_s, precompute_s=precompute_s,
        peak_mem_gb=_peak_mem_gb(dev), steps_per_epoch=nb, batch=batch, state=state,
        data=data, train_epoch=train_epoch)


@dataclass
class RenderLeg:
    """What render_leg ran and measured; the renderer, cameras, intrinsics
    and the last pass's frames stay usable."""

    rays_per_s_best: float
    rays_per_s_median: float
    pass_s: list           # wall seconds of each pipelined pass
    launches_per_frame: list  # fused_mlp_fwd launches of each frame, last pass
    trace_ms: float
    infer_ms: float
    fetch_ms: float
    peak_mem_gb: float | None
    renderer: object = field(repr=False)
    cams: list = field(repr=False)
    K: np.ndarray = field(repr=False)
    images: list = field(repr=False)

    def summary(self):
        r = self.renderer
        return {"leg": "render", "H": r.H, "W": r.W, "faces": r.mesh.num_faces,
                "k": int(r.features.shape[1]), "frames": len(self.cams),
                "infer": r.infer_mode, "rays_per_s_best": self.rays_per_s_best,
                "rays_per_s_median": self.rays_per_s_median,
                "frame_ms_best": 1e3 * min(self.pass_s) / len(self.cams),
                "launches_per_frame": self.launches_per_frame, "trace_ms": self.trace_ms,
                "infer_ms": self.infer_ms, "fetch_ms": self.fetch_ms,
                "peak_mem_gb": self.peak_mem_gb}


def render_leg(device="cuda", frames=FRAMES, H=RENDER_H, subdivisions=SUBDIVISIONS, k=K,
               model=None):
    """bench.py:bench_render_ours on the port: the blob at `subdivisions`
    (6: 81,920 faces), a basis rng.normal(size=(V_mesh, k)) from
    default_rng(SEED) (not rescaled, as bench.py has it), an H x H Renderer
    with a bf16 feature table and the u8 wire, `frames` cameras on
    ring_cameras' orbit. One warm render, then the best of 3 passes of
    pipelined_foreach with lookahead DEPTH; then one frame split into its
    stages (host clock around synchronized work: the trace alone, inference
    and composite on the cached trace, the fetch). model: a TextureField
    (default: make_model(model_config(k), seed=0)).

    On the card the network of every chunk is the fused_mlp_fwd kernel,
    each trace one raster_traverse and three raster_bin launches, and each
    frame's wire image one render_wire launch: the leg raises unless every
    frame of every pass launched the forward, each pass traced and built
    its wire image once a frame, and no other kernel of the port ran."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mesh = blob_mesh(subdivisions=subdivisions)
    efuncs = np.random.default_rng(SEED).normal(size=(mesh.num_vertices, k)).astype(np.float32)
    if model is None:
        model = make_model(model_config(k), seed=0, device=dev)
    r = Renderer(model, mesh, efuncs, H=H, W=H, feature_dtype="bfloat16", wire_u8=True,
                 device=dev)
    Kmat = pinhole_K(H, H)
    cams = ring_cameras(frames)
    if not np.isfinite(r.render(cams[0], Kmat)).all():
        raise RuntimeError("bench render leg: non-finite warm render")

    times = []
    for _ in range(3):
        launches, images = [], []

        def dispatch(cam):
            before = kernel_launches()["fused_mlp_fwd"]
            pending = r.render_async(cam, Kmat)
            launches.append(kernel_launches()["fused_mlp_fwd"] - before)
            return pending

        reset_kernel_launches()
        t0 = time.perf_counter()
        pipelined_foreach(cams, dispatch, lambda _c, h: images.append(r.render_fetch(h)),
                          depth=DEPTH)
        times.append(time.perf_counter() - t0)
        counted = kernel_launches()
        others = {n: c for n, c in counted.items() if c and n not in (
            "fused_mlp_fwd", "raster_traverse", "raster_bin", "render_wire")}
        if dev.type == "cuda" and (min(launches) == 0 or others
                                   or counted["raster_traverse"] != len(cams)
                                   or counted["raster_bin"] != 3 * len(cams)
                                   or counted["render_wire"] != len(cams)):
            raise RuntimeError("bench render leg: a frame did not launch fused_mlp_fwd, one "
                               "raster_traverse, three raster_bin and one render_wire, or "
                               f"another kernel ran: {launches}, {counted}")

    cam = cams[1 % frames]
    r.render(cam, Kmat, cache_key="stages")
    _sync(dev)
    t0 = time.perf_counter()
    r.trace_view(cam, Kmat)
    _sync(dev)
    t1 = time.perf_counter()
    pending = r.render_async(cam, Kmat, cache_key="stages")
    _sync(dev)
    t2 = time.perf_counter()
    r.render_fetch(pending)
    t3 = time.perf_counter()
    rays = frames * H * H
    return RenderLeg(
        rays_per_s_best=rays / min(times), rays_per_s_median=rays / float(np.median(times)),
        pass_s=times, launches_per_frame=launches, trace_ms=1e3 * (t1 - t0),
        infer_ms=1e3 * (t2 - t1), fetch_ms=1e3 * (t3 - t2), peak_mem_gb=_peak_mem_gb(dev),
        renderer=r, cams=cams, K=Kmat, images=images)


def bench_torch_cpu(feats, vids, bary, rgbs, steps=30):
    """bench.py:bench_torch_cpu, the reference-equivalent hot loop on the
    CPU: index_select gather + bmm barycentric interpolation + nn.Sequential
    MLP + Adam step (reference ray_dataloader.py:115-145, trainer.py:71-84),
    on the hardware the reference supports. Returns rays/s."""
    torch.manual_seed(SEED)
    n, k = vids.shape[0], feats.shape[1]
    feats_t = torch.from_numpy(feats)
    vids_t = torch.from_numpy(vids.astype(np.int64))
    bary_t = torch.from_numpy(bary)
    rgbs_t = torch.from_numpy(rgbs)

    layers = []
    for i in range(LAYERS - 1):
        if i == 0:
            layers.append(torch.nn.Linear(k, HIDDEN))
        elif i == SKIP:
            layers.append((torch.nn.Linear(HIDDEN, HIDDEN), torch.nn.Linear(k, HIDDEN)))
        else:
            layers.append(torch.nn.Linear(HIDDEN, HIDDEN))
    head = torch.nn.Linear(HIDDEN, 3)
    params = [p for l in layers for p in (l.parameters() if not isinstance(l, tuple)
              else [*l[0].parameters(), *l[1].parameters()])] + list(head.parameters())
    optim = torch.optim.Adam(params, lr=1e-4)

    def forward(x):
        h = x
        for l in layers:
            if isinstance(l, tuple):
                h = torch.relu(l[0](h) + l[1](x))
            else:
                h = torch.relu(l(h))
        return torch.sigmoid(head(h))

    def step(idx):
        v = vids_t[idx].reshape(-1)
        tri = feats_t[v].reshape(-1, 3, k)
        x = torch.bmm(bary_t[idx].unsqueeze(1), tri).squeeze(1)
        pred = forward(x)
        loss = torch.nn.functional.l1_loss(pred, rgbs_t[idx])
        optim.zero_grad(set_to_none=True)
        loss.backward()
        optim.step()

    perm = torch.randperm(n)
    for i in range(3):  # warmup
        step(perm[i * BATCH:(i + 1) * BATCH])
    t0 = time.perf_counter()
    for i in range(3, 3 + steps):
        step(perm[i * BATCH:(i + 1) * BATCH])
    dt = time.perf_counter() - t0
    return steps * BATCH / dt


def bench_line(baseline, train_best, train_median, render_rays):
    """bench.py's JSON line: the best group's train rays/s as the headline
    (least pollution on a shared card) and the median beside it, each over
    the torch-CPU baseline; the pipelined render's rays/s over the
    reference render loop's."""
    return {
        "metric": "train_rays_per_sec",
        "value": round(train_best, 1),
        "unit": "rays/s",
        "vs_baseline": round(train_best / baseline, 2),
        "median_value": round(train_median, 1),
        "median_vs_baseline": round(train_median / baseline, 2),
        "render_rays_per_sec": round(render_rays, 1),
        "render_vs_baseline": round(render_rays / REF_RENDER_RAYS_PER_S, 2),
    }


def card_name(dev):
    """nvidia-smi's "name, power limit" of the card, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[dev.index or 0]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    print(card_name(dev), flush=True)
    arrays = make_arrays(SEED, V=V, K=K, N=N)
    baseline = bench_torch_cpu(*arrays)
    print(json.dumps({"leg": "baseline", "torch_cpu_rays_per_s": baseline,
                      "ref_render_rays_per_s": REF_RENDER_RAYS_PER_S}), flush=True)
    train = train_leg(arrays, device=dev, epochs=EPOCHS, group=GROUP, batch=BATCH)
    print(json.dumps(train.summary()), flush=True)
    best, median = train.rays_per_s_best, train.rays_per_s_median
    del arrays, train  # the render leg runs without the 4.3 GB table
    render = render_leg(device=dev, frames=FRAMES, H=RENDER_H, subdivisions=SUBDIVISIONS, k=K)
    print(json.dumps(render.summary()), flush=True)
    print(json.dumps(bench_line(baseline, best, median, render.rays_per_s_best)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
