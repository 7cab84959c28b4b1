"""The train cells' generator (traffic generator "train_cell"): a closed
loop of epochs, each as the program's Trainer.train runs it: the epoch
function that ``train/steps.py:make_epoch_fns`` builds for the
configuration, the prefetch of the next epoch's order, and the fetch of the
epoch's loss.

Set-up builds the train state once, from the benchmark's seeded inputs and
weights, and drives it through that same epoch function: first
`check_steps` steps on distinct blocks of the table, one step per call, so
that the state after each can be read; then the check epoch, one epoch over
the whole table in an order the benchmark draws from the seed. The check
epoch is the warm-up: it captures the graph the window replays (the graph
holds the order's buffer, not its values), and its loss, parameters and
Adam moments are read back. The state goes on to the window. Once the
window has closed, the plain reference (reference.py) follows every one of
those steps and the check compares the two.
"""
from __future__ import annotations

import time
from dataclasses import replace
import numpy as np
import torch

from . import inputs, reference
from .common import Outcome, device_kind, peak_bytes, read_trace, train_numbers

FAULTS = ("unchanged", "half_batch", "order_ignored", "hyper_row0", "block0")


def model_config(cfg):
    """The model section as the program's make_model takes it: k resolved."""
    return {**cfg["model"], "k": cfg["k"]}


class TrainCell:
    SHUFFLE = "blocks"  # the walk this generator drives: an order of blocks
    RATE = "train_rays_per_s"  # the end-to-end metric of its window

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = cfg = ctx.cfg
        self.vd = cfg["model"].get("view_dependence")
        self.B = cfg["training"]["batch_size"]
        if ctx.traffic["shuffle"] != self.SHUFFLE:
            raise ValueError(f"{type(self).__name__} drives the {self.SHUFFLE} shuffle")
        self.n_check = ctx.traffic["check_steps"]
        self.ref = None

    # ------------------------------------------------------------ set-up

    def draw(self, field_shapes):
        """The seed's inputs, the initial weights for `field_shapes`, the
        check steps' blocks and the check epoch's order."""
        ctx = self.ctx
        self.arrays = a = inputs.train_arrays(self.cfg, ctx.seed, ctx.device)
        self.p0 = inputs.initial_weights(field_shapes, inputs.generator(ctx.seed + 1, ctx.device),
                                         ctx.device)
        self.nb = len(a["rgbs"]) // self.B
        self.blocks = inputs.check_rows(ctx.seed, self.nb, self.n_check)
        self.order = inputs.epoch_order(ctx.seed, self.nb)

    def setup(self):
        from intrinsic_neural_fields_tpu_torch.data.sampler import (
            RayData, parse_precompute_dtype, precompute_hit_features, precompute_hit_vencs)
        from intrinsic_neural_fields_tpu_torch.models.texture_field import view_encoder_apply
        from intrinsic_neural_fields_tpu_torch.train.steps import AdamHyper, create_train_state

        ctx, cfg, dev = self.ctx, self.cfg, self.ctx.device
        ctx.phase("imports")
        model = self.program_model(dev)
        self.draw({k: tuple(v.shape) for k, v in model.state_dict().items()})
        model.load_state_dict(self.p0)
        ctx.sync()
        ctx.phase("inputs_and_weights")
        a = self.arrays
        dtype = parse_precompute_dtype(cfg["data"]["precompute_dtype"])
        data = RayData(a["basis"], "efuncs", a["vids"], a["bary"], a["rgbs"],
                       a.get("dirs"), a.get("face_idxs"))
        data = precompute_hit_features(data, dtype=dtype)
        self.state = create_train_state(model, AdamHyper(cfg["training"]["lr"]), dev)
        if self.vd is not None:
            data = precompute_hit_vencs(view_encoder_apply(model), data,
                                        self.state.layout.tail.venc_w, dtype=dtype)
        self.data = data
        ctx.sync()
        ctx.phase("tables")
        self.train_epoch = self.epoch_fn(model)
        self.check_steps()
        ctx.phase("check_steps")
        self.check_epoch()
        ctx.sync()
        ctx.phase("check_epoch")

    def epoch_fn(self, model):
        """The program's train_epoch for the configuration on this
        generator's walk (``make_epoch_fns``)."""
        from intrinsic_neural_fields_tpu_torch.train.steps import make_epoch_fns

        t = self.cfg["training"]
        return make_epoch_fns(model, t["loss_type"], shuffle=self.SHUFFLE,
                              fused=t["fused_mlp"])[0]

    def program_model(self, device):
        """The program's field for the configuration (its mesh: the
        view-dependent field's face normals)."""
        from intrinsic_neural_fields_tpu_torch.geometry.mesh import Mesh
        from intrinsic_neural_fields_tpu_torch.models import make_model

        mesh = None
        if self.vd is not None:
            mesh = Mesh(*inputs.mesh_arrays(self.cfg["train_data"]["mesh"]))
        return make_model(model_config(self.cfg), seed=0, device=device, mesh=mesh)

    def block_view(self, b):
        """The data cut to block b's rows: an epoch of one step over it
        trains exactly that block."""
        s = slice(b * self.B, (b + 1) * self.B)
        d = self.data
        cut = lambda t: None if t is None else t[s]  # noqa: E731
        return replace(d, vertex_idxs_of_hit_faces=d.vertex_idxs_of_hit_faces[s],
                       barycentric_coords=d.barycentric_coords[s],
                       expected_rgbs=d.expected_rgbs[s], unit_ray_dirs=cut(d.unit_ray_dirs),
                       face_idxs=cut(d.face_idxs), hit_features=cut(d.hit_features),
                       hit_vencs=cut(d.hit_vencs))

    def check_steps(self):
        """The first steps, one call each on one block's rows (a one-step
        epoch trains block 0 of what it is given), read back after each:
        the losses, Adam's first moment after step 1, the parameters before
        and after."""
        st = self.state
        prog = {"params0": st.state_dict(), "losses": []}
        for j, b in enumerate(self.blocks):
            st, m = self.train_epoch(st, self.check_order(j), self.block_view(b), 1, self.B)
            prog["losses"].append(float(m["loss"]))
            if j == 0:
                prog["mu1"] = st.layout.state_dict(st.mu)
        prog["params_check"] = st.state_dict()
        self.prog = prog
        self.state = st

    def check_order(self, j):
        """The order check step j gives its one-step epoch: its one block."""
        return np.array([0])

    def check_epoch(self):
        """The window's epoch over the whole table in the seed's order (the
        warm-up: the window replays the graph it captures), read back; then
        the window's first order drawn ahead, as every epoch's is."""
        from intrinsic_neural_fields_tpu_torch.utils.jax_random import PRNGKey, fold_in

        self.state, m = self.train_epoch(self.state, self.order, self.data, self.nb, self.B)
        st = self.state
        self.prog.update(epoch_loss=float(m["loss"]), params_end=st.state_dict(),
                         mu_end=st.layout.state_dict(st.mu))
        self.key = PRNGKey(self.ctx.seed)
        self.epoch = 0
        prefetch = getattr(self.train_epoch, "prefetch", None)
        if prefetch is not None:
            prefetch(fold_in(self.key, 0), self.data, self.nb, self.B)

    def run_epoch(self):
        """One epoch as Trainer.train runs it; returns its mean loss."""
        from intrinsic_neural_fields_tpu_torch.utils.jax_random import fold_in

        ctx = self.ctx
        with ctx.span("epoch"):
            self.state, m = self.train_epoch(self.state, fold_in(self.key, self.epoch),
                                             self.data, self.nb, self.B)
        prefetch = getattr(self.train_epoch, "prefetch", None)
        if prefetch is not None:
            with ctx.span("prefetch"):
                prefetch(fold_in(self.key, self.epoch + 1), self.data, self.nb, self.B)
        with ctx.span("loss_fetch"):
            loss = float(m["loss"])
        self.epoch += 1
        return loss

    # ------------------------------------------------------------ window

    def window(self, seconds):
        from intrinsic_neural_fields_tpu_torch.ops.launches import (
            kernel_launches, reset_kernel_launches)

        ctx = self.ctx
        losses = []
        reset_kernel_launches()
        with ctx.window() as tracer:
            t0 = time.perf_counter()
            while True:
                losses.append(self.run_epoch())
                if time.perf_counter() - t0 >= seconds:
                    break
            ctx.sync()
            wall = time.perf_counter() - t0
        self.losses, self.wall, self.tracer = losses, wall, tracer
        self.launches = {k: v for k, v in kernel_launches().items() if v}

    # ------------------------------------------------------------ check

    def reference_batches(self, blocks, order):
        """The rows of every step the program took before the window, as
        the reference works them out from the benchmark's inputs
        (interpolated features, the view encoding, the targets): the check
        steps' `blocks`, then the check epoch's blocks in `order`. Made one
        step at a time."""
        a, B, vd = self.arrays, self.B, self.vd
        normals = None
        if vd is not None:
            normals = torch.as_tensor(inputs.face_normals(a["vertices"], a["faces"]),
                                      dtype=torch.float32, device=a["basis"].device)
        for b in list(blocks) + [int(i) for i in order]:
            rows = slice(b * B, (b + 1) * B)
            x = reference.interpolate(a["basis"], a["vids"][rows], a["bary"][rows])
            venc = None if vd is None else reference.view_encoding(
                a["dirs"][rows], normals[a["face_idxs"][rows]], vd)
            yield x, venc, a["rgbs"][rows]

    def reference_steps(self, q=None, fault=None):
        """The reference's steps, with a fault planted where one is named:
        "order_ignored" trains the epoch's blocks in turn, "block0" trains
        block 0 at every step of the epoch; the others are
        reference.train_steps'."""
        order = self.order
        if fault == "order_ignored":
            order, fault = np.arange(len(order)), None
        elif fault == "block0":
            order, fault = np.zeros_like(order), None
        return reference.train_steps(self.p0, self.cfg,
                                     self.reference_batches(self.blocks, order), q=q,
                                     fault=fault, keep=(self.n_check,),
                                     epoch_from=self.n_check + 1)

    def free_program(self):
        """Drop the program's state, tables and epoch function (the
        reference runs after them)."""
        self.state = self.data = self.train_epoch = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, q=None, fault=None):
        """The check's numbers: the program's steps (or, with q or fault,
        the reference put in its place) against the reference."""
        if self.ref is None:
            self.ref = self.reference_steps()
        if q is None and fault is None:
            return train_numbers(self.prog, self.ref, self.n_check)
        alt = self.reference_steps(q, fault)
        n = self.n_check
        # Adam's first moment after step 1: (1 - b1) g1, nought if the state stays as it was
        mu1_scale = 0.0 if fault == "unchanged" else 1.0 - 0.9
        prog = {"losses": alt["losses"][:n], "params0": self.p0,
                "mu1": {k: mu1_scale * v for k, v in alt["grad1"].items()},
                "params_check": alt["params"][n],
                "epoch_loss": float(np.mean(alt["losses"][n:])),
                "params_end": alt["params_end"], "mu_end": alt["mu_end"]}
        return train_numbers(prog, self.ref, n)


def run(ctx, cell_class=TrainCell):
    cell = cell_class(ctx)
    cell.setup()
    setup_s = ctx.setup_done()
    cell.window(ctx.seconds)
    mem = peak_bytes(ctx.device)
    epochs = len(cell.losses)
    steps = epochs * cell.nb
    rays = steps * cell.B
    failed = int(sum(not np.isfinite(v) for v in cell.losses))
    record = {"kind": "train", "cfg": ctx.cfg, "batch": cell.B, "steps": steps,
              "window_s": cell.wall, "launches": cell.launches,
              "device_kind": device_kind(ctx.device)}
    out = Outcome(e2e={cell.RATE: rays / cell.wall, "setup_s": setup_s},
                  attempted=epochs, failed=failed, checks={}, record=record,
                  memory_peak_bytes=mem)
    if cell.tracer is not None:
        read_trace(cell.tracer, record, out)
    cell.free_program()
    t0 = time.perf_counter()
    numbers = cell.check()
    out.check_s = time.perf_counter() - t0
    out.checks = {k: (v, ctx.limits[k]) for k, v in numbers.items()}
    return out


def readings(ctx, program=True, cell_class=TrainCell):
    """The readings a limit is set from (benchmark/control.py): the
    program's numbers after a window of ctx.seconds, or those of the control
    (the reference in the precision below the configuration's) and of each
    fault a train cell can have, planted in the reference put in the
    program's place."""
    cell = cell_class(ctx)
    if program:
        cell.setup()
        cell.window(ctx.seconds)
        cell.free_program()
        return {"program": cell.check()}
    shapes = {k: tuple(v.shape) for k, v in cell.program_model("cpu").state_dict().items()}
    cell.draw(shapes)
    out = {"control": cell.check(q=reference.PRECISIONS[ctx.cfg["precision"]["control"]])}
    for fault in FAULTS:
        out[fault] = cell.check(fault=fault)
    return out
