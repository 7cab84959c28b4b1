"""The render cells' generator (traffic generator "render_cell"): a closed loop of
frames on an orbit of look-at cameras around the configuration's mesh,
through the program's ``Renderer.render_async`` / ``render_fetch`` in
``pipelined_foreach`` at the traffic's depth, as render_video's turntable
runs them. The frames cycle the orbit for the whole window.

Set-up builds the Renderer from the benchmark's seeded mesh, basis and
weights and warms it with the whole orbit once, through the window's own
dispatch and fetch: each view's hits and bins have sizes of their own, and
the window's first pass over the orbit would otherwise meet them (its
first frames then take ~1.4x the median). The check keeps the images of a
few window frames drawn from the seed and of the last one, and compares
each, once the window has closed, with the plain reference's image of its
view: the reference's own rays, hits, interpolation, forward and
composite.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import inputs, reference
from .common import Outcome, device_kind, peak_bytes, read_trace
from .train_cell import model_config


class RenderCell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.cfg
        self.tr = ctx.traffic
        self.H, self.W = self.cfg["data"]["img_height"], self.cfg["data"]["img_width"]

    def setup(self):
        from intrinsic_neural_fields_tpu_torch.geometry.mesh import Mesh
        from intrinsic_neural_fields_tpu_torch.models import make_model
        from intrinsic_neural_fields_tpu_torch.render.renderer import Renderer

        ctx, cfg, tr, dev = self.ctx, self.cfg, self.tr, self.ctx.device
        ctx.phase("imports")
        if cfg["model"].get("view_dependence") is not None:
            raise ValueError("render_orbit renders a plain field")
        v, f = inputs.mesh_arrays(cfg["render_data"]["mesh"])
        self.vertices, self.faces = v, f
        g = inputs.generator(ctx.seed, dev)
        self.basis = torch.randn(len(v), cfg["k"], generator=g, device=dev)
        model = make_model(model_config(cfg), seed=0, device=dev)
        self.p0 = inputs.initial_weights(
            {k: tuple(t.shape) for k, t in model.state_dict().items()},
            inputs.generator(ctx.seed + 1, dev), dev)
        model.load_state_dict(self.p0)
        self.renderer = Renderer(model, Mesh(v, f), self.basis.cpu().numpy(), H=self.H, W=self.W,
                                 background=tr["background"],
                                 feature_dtype=cfg["data"]["precompute_dtype"],
                                 wire_u8=tr["wire_u8"], device=dev)
        ctx.sync()
        ctx.phase("inputs_weights_renderer")
        self.cams = inputs.orbit(tr, ctx.seed)
        self.K = inputs.intrinsics(self.H, self.W, tr["focal"])
        self.keep = set(inputs.sample_frames(ctx.seed, tr["sample_below"], tr["sample_frames"]))
        self.pipeline(range(len(self.cams)))  # every view once: each traces to other sizes
        ctx.sync()
        ctx.phase("warm_orbit")

    def pipeline(self, frames, dispatch=None, finish=None):
        """Frames i of `frames` (view i mod the orbit) through
        pipelined_foreach at the traffic's depth: render_async, then
        render_fetch; `dispatch(i)` and `finish(i, image)` are called around
        them."""
        from intrinsic_neural_fields_tpu_torch.utils.pipeline import pipelined_foreach

        ctx, r, K, n = self.ctx, self.renderer, self.K, len(self.cams)

        def send(i):
            if dispatch is not None:
                dispatch(i)
            with ctx.span("dispatch"):
                return r.render_async(self.cams[i % n], K)

        def fetch(i, handle):
            with ctx.span("fetch"):
                img = r.render_fetch(handle)
            if finish is not None:
                finish(i, img)

        pipelined_foreach(frames, send, fetch, depth=self.tr["depth"])

    def window(self, seconds):
        from intrinsic_neural_fields_tpu_torch.ops.launches import (
            kernel_launches, reset_kernel_launches)

        ctx = self.ctx
        sent, done, kept, last = [], [], {}, [None]
        t0 = None

        def frames():
            i = 0
            while time.perf_counter() - t0 < seconds:
                yield i
                i += 1

        def dispatch(i):
            sent.append(time.perf_counter())

        def finish(i, img):
            done.append(time.perf_counter())
            if i in self.keep:
                kept[i] = img
            last[0] = (i, img)

        reset_kernel_launches()
        with ctx.window() as tracer:
            t0 = time.perf_counter()
            self.pipeline(frames(), dispatch, finish)
            ctx.sync()
            wall = time.perf_counter() - t0
        if last[0] is not None:  # the last frame is due in the window too
            kept[last[0][0]] = last[0][1]
        self.wall, self.tracer = wall, tracer
        self.frame_s = [b - a for a, b in zip(sent, done)]
        self.launches = {k: v for k, v in kernel_launches().items() if v}
        self.kept = kept
        self.frames = len(done)

    def stage_split(self):
        """Each orbit view's stages, on the host clock around synchronized
        work: the trace alone, the render on a cached trace (interpolation,
        forward, composite), the fetch."""
        ctx, r, K = self.ctx, self.renderer, self.K
        stages = {"trace": [], "infer": [], "fetch": []}
        for i, cam in enumerate(self.cams):
            key = ("stages", i)
            r.render(cam, K, cache_key=key)
            ctx.sync()
            t0 = time.perf_counter()
            r.trace_view(cam, K)
            ctx.sync()
            t1 = time.perf_counter()
            pending = r.render_async(cam, K, cache_key=key)
            ctx.sync()
            t2 = time.perf_counter()
            r.render_fetch(pending)
            t3 = time.perf_counter()
            stages["trace"].append(1e3 * (t1 - t0))
            stages["infer"].append(1e3 * (t2 - t1))
            stages["fetch"].append(1e3 * (t3 - t2))
        return stages

    def free_program(self):
        self.renderer = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_trace(self, i):
        """The reference's (face, bary, ambiguous) of view i."""
        dev = self.ctx.device
        verts = torch.as_tensor(self.vertices, dtype=torch.float64, device=dev)
        faces = torch.as_tensor(self.faces, dtype=torch.int64, device=dev)
        return reference.trace_view(verts, faces, self.cams[i % len(self.cams)], self.K,
                                    self.H, self.W)

    def reference_view(self, i, q=None):
        """(u8 image [H*W,3], ambiguous [H*W]) of view i by the reference, its
        field in the precision q (None: float32)."""
        face, bary, amb = self.reference_trace(i)
        faces = torch.as_tensor(self.faces, dtype=torch.int64, device=face.device)
        bg = 1.0 if self.tr["background"] == "white" else 0.0
        return reference.render_u8(self.p0, self.cfg, self.basis, faces, face, bary, bg, q), amb

    def check(self):
        """The widest gap, in 8-bit levels, between a kept frame and the
        reference's image of its view, over the pixels that are not
        ambiguous."""
        worst = 0.0
        for i, img in self.kept.items():
            ref, amb = self.reference_view(i)
            prog = torch.as_tensor(np.round(np.asarray(img).reshape(-1, 3) * 255.0),
                                   device=ref.device)
            worst = max(worst, float((prog - ref.float()).abs().amax(1)[~amb].max()))
        return {"pixel_gap_u8": worst}


def run(ctx):
    cell = RenderCell(ctx)
    cell.setup()
    setup_s = ctx.setup_done()
    cell.window(ctx.seconds)
    mem = peak_bytes(ctx.device)
    H, W = cell.H, cell.W
    print("first frames (ms): " + ", ".join(f"{1e3 * s:.1f}" for s in cell.frame_s[:8])
          + f"; median {1e3 * float(np.median(cell.frame_s)):.1f}", file=sys.stderr)
    record = {"kind": "render", "cfg": ctx.cfg, "frames": cell.frames, "window_s": cell.wall,
              "launches": cell.launches, "pixels": H * W,
              "device_kind": device_kind(ctx.device)}
    out = Outcome(e2e={"render_rays_per_s": cell.frames * H * W / cell.wall,
                       "frame_ms_p95": 1e3 * float(np.percentile(cell.frame_s, 95)),
                       "setup_s": setup_s},
                  attempted=cell.frames, failed=0, checks={}, record=record,
                  memory_peak_bytes=mem)
    if cell.tracer is not None:
        read_trace(cell.tracer, record, out)
        record["stage_ms"] = cell.stage_split()
    cell.free_program()
    if ctx.trace:
        n = len(cell.cams)
        hits = []
        for i in range(n):  # hit pixels: strict hits and the ambiguous edge pixels
            face, _, amb = cell.reference_trace(i)
            hits.append(int(((face >= 0) | amb).sum()))
        record["hit_rays"] = sum(hits[i % n] for i in range(cell.frames))
    t0 = time.perf_counter()
    numbers = cell.check()
    out.check_s = time.perf_counter() - t0
    out.checks = {k: (v, ctx.limits[k]) for k, v in numbers.items()}
    return out


def readings(ctx, program=True):
    """The readings a limit is set from (benchmark/control.py): the
    program's widest gap over the frames a run keeps, after a window of
    ctx.seconds; or, on the orbit's first four views, the control's (the
    reference's field in the precision below the configuration's) and each
    fault's a frame can have, planted in the reference's image: every second
    hit pixel left at the background, or the colours shifted by one
    8,192-ray chunk."""
    cell = RenderCell(ctx)
    cell.setup()
    if program:
        cell.window(ctx.seconds)
        cell.free_program()
        return {"program": cell.check(), "frames_compared": len(cell.kept)}
    cell.free_program()
    views = range(min(4, len(cell.cams)))
    q = reference.PRECISIONS[ctx.cfg["precision"]["control"]]
    out = {kind: {"pixel_gap_u8": 0.0} for kind in ("control", "half_rays", "shifted_chunk")}
    for i in views:
        ref, amb = cell.reference_view(i)
        alts = {"control": cell.reference_view(i, q)[0]}
        for fault in ("half_rays", "shifted_chunk"):
            alts[fault] = plant_render_fault(ref, fault, cell.tr["background"])
        for kind, img in alts.items():
            gap = float((img.float() - ref.float()).abs().amax(1)[~amb].max())
            out[kind]["pixel_gap_u8"] = max(out[kind]["pixel_gap_u8"], gap)
    return out


def plant_render_fault(img, fault, background, chunk=8192):
    """The reference's u8 image [P,3] with a fault planted: every second hit
    pixel left at the background, or the colours rolled by one chunk."""
    bad = img.clone()
    if fault == "half_rays":
        bg = 255 if background == "white" else 0
        hit = (img != bg).any(1).nonzero().squeeze(1)
        bad[hit[::2]] = bg
    else:
        bad = torch.roll(bad, chunk, 0)
    return bad
