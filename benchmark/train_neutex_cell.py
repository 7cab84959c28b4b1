"""The NeuTex train cell's generator (traffic generator "train_neutex_cell"):
the gathered train cells' closed loop of full-shuffle epochs
(train_gathered_cell.py) on NeuTex, the self-loss model of the program's
models/neutex.py, as ``Trainer`` trains
configs/texture_reconstruction/neutex_cat.yaml: the train_epoch that
``make_epoch_fns(model, "L1", shuffle="full", fused=False)`` builds, whose
every step is the eager one (the float32 forward of the three networks and
the model's own loss under autograd, then the Adam kernel).

What changes from train_gathered_cell.py is the model and its data. The
model is ``NeuTexTrainWrapper`` at the configuration's k, use_logspace and
max_freq, with the benchmark's seeded weights in all three networks (the
recipe's pretrained mapping is not in the repository). Its split is an xyz
split as ``data/sampler.py:create_ray_data`` builds one for this recipe:
the mesh's float32 vertex table, and every hit's interpolated position
precomputed in float32 (the recipe sets no precompute_dtype). The hits lie
on the configuration's mesh: face ids uniform, barycentrics Dirichlet(1,
1, 1), targets uniform, from the seed. The reference is
reference_neutex.py; its control rounds every matmul operand to TF32, and
it has a fault of its own, "cycle_dropped", which trains without the cycle
term.

What the check compares changes too, because NeuTex's float32 training is
chaotic. Adam's first steps move every weight by about the learning rate
whatever its gradient's size, and the inverse map's gradient, summed
through the encoding's bands of up to 2^6 pi, carries rounding noise large
against its smallest elements; so two float32 runs part within a few
steps, the reference as much as the program: the reference with each
batch's rows in another order, or in float64, ends the check epoch with
Adam's first moments agreeing in sign at chance, and the reference in
float64 ends it, on one seed in ten, up to 0.34 from the float32 one in a
leaf's change and 9% in mean loss (PERF.md, section 2). So the check
steps come before that: each is a one-step epoch over the whole table in a
permutation of every record drawn from the seed, which trains the
permutation's first B records, so that an epoch that ignored its order
would train other records there. train_cell's numbers are kept, each
limit above what the reference reads against itself; Adam's first moment
after the check epoch is not compared; and one number is added,
``epoch_change_scale_gap``, the median leaf's ratio of its change's norm to
the reference's, less 1: chaos turns a leaf's change, but leaves its size,
while an epoch that reads its first hyper row throughout shrinks every
leaf's steps alike.
"""
from __future__ import annotations

import statistics

import numpy as np
import torch

from . import inputs, reference, reference_neutex, train_cell
from .common import moved_leaves, train_numbers
from .train_gathered_cell import SALT, TrainGatheredCell

NEUTEX_FAULTS = train_cell.FAULTS + ("cycle_dropped",)


def train_arrays(cfg, seed, device):
    """The cached training hits on the configuration's mesh, on `device`:
    {"vertices" [V, 3] f32, "vids" [N, 3] int64, "bary" [N, 3] f32, "rgbs"
    [N, 3] f32}."""
    td = cfg["train_data"]
    v, f = inputs.mesh_arrays(td["mesh"])
    g = inputs.generator(seed, device)
    N = td["num_hits"]
    face_idxs = torch.randint(0, len(f), (N,), generator=g, device=device)
    e = torch.empty(N, 3, device=device).exponential_(generator=g)
    return {"vertices": torch.as_tensor(v, dtype=torch.float32, device=device),
            "vids": torch.as_tensor(f, device=device)[face_idxs],
            "bary": e / e.sum(1, keepdim=True),
            "rgbs": torch.rand(N, 3, generator=g, device=device)}


def change_scale_gap(params, ref, p0, leaves):
    """|m - 1|, m the median over `leaves` of norm(params - p0) /
    norm(ref - p0): how far the typical leaf's change differs in size from
    the reference's, which chaos leaves alone and an epoch whose Adam steps
    shrink or grow moves in every leaf alike."""
    return abs(statistics.median(
        float(torch.linalg.vector_norm(params[k].double() - p0[k].double()))
        / float(torch.linalg.vector_norm(ref[k].double() - p0[k].double())) for k in leaves) - 1.0)


class NeuTexCell(TrainGatheredCell):

    def program_model(self, device):
        """The program's NeuTex train wrapper at the configuration's encoding."""
        from intrinsic_neural_fields_tpu_torch.models.neutex import NeuTexTrainWrapper

        m = self.cfg["model"]
        return NeuTexTrainWrapper(num_freqs=m["k"], use_logspace=m["use_logspace"],
                                  max_freq=m["max_freq"]).to(device)

    def draw(self, field_shapes):
        """The seed's hits and initial weights, each check step's
        permutation of every record, and the check epoch's."""
        ctx = self.ctx
        self.arrays = a = train_arrays(self.cfg, ctx.seed, ctx.device)
        self.p0 = inputs.initial_weights(field_shapes, inputs.generator(ctx.seed + 1, ctx.device),
                                         ctx.device)
        n = len(a["rgbs"])
        self.nb = n // self.B
        self.blocks = list(range(self.n_check))
        rng = np.random.default_rng((int(ctx.seed) + SALT) % (1 << 63))
        self.step_perms = [rng.permutation(n) for _ in self.blocks]
        self.order = rng.permutation(n)

    def block_view(self, b):
        """The data check step b's one-step epoch walks: the whole table
        (its order, a permutation of every record, picks the B records)."""
        return self.data

    def step_rows(self, order, checks=None):
        """The record ids of every step before the window: the first B of
        each check step's permutation (`checks`, the drawn ones by
        default), then `order` a batch at a time."""
        B = self.B
        rows = [p[:B] for p in (self.step_perms if checks is None else checks)]
        return rows + [order[i * B:(i + 1) * B] for i in range(len(order) // B)]

    def setup(self):
        from intrinsic_neural_fields_tpu_torch.data.sampler import (
            RayData, precompute_hit_features)
        from intrinsic_neural_fields_tpu_torch.train.steps import (
            AdamHyper, EpochPath, create_train_state, epoch_path)

        ctx, cfg, dev = self.ctx, self.cfg, self.ctx.device
        ctx.phase("imports")
        model = self.program_model(dev)
        self.draw({k: tuple(v.shape) for k, v in model.state_dict().items()})
        model.load_state_dict(self.p0)
        ctx.sync()
        ctx.phase("inputs_and_weights")
        a = self.arrays
        data = RayData(a["vertices"], cfg["model"]["feature_strategy"], a["vids"], a["bary"],
                       a["rgbs"])
        self.data = precompute_hit_features(data)
        self.state = create_train_state(model, AdamHyper(cfg["training"]["lr"]), dev)
        ctx.sync()
        ctx.phase("tables")
        self.train_epoch = self.epoch_fn(model)
        path = epoch_path(model, self.SHUFFLE, cfg["training"]["fused_mlp"], self.data, self.nb,
                          self.B)
        if path != EpochPath("eager", False):
            raise RuntimeError(f"NeuTex's full-shuffle epoch took the path {path}, "
                               "not the eager step on gathered batches")
        self.check_steps()
        ctx.phase("check_steps")
        self.check_epoch()
        ctx.sync()
        ctx.phase("check_epoch")

    def reference_batches(self, rows):
        """(positions interpolated from the mesh's vertices, None, targets)
        of each step's records; made one step at a time."""
        a = self.arrays
        for r in rows:
            r = torch.as_tensor(r, device=a["vertices"].device)
            x = reference.interpolate(a["vertices"], a["vids"][r], a["bary"][r])
            yield x, None, a["rgbs"][r]

    def reference_steps(self, q=None, fault=None):
        """The reference's steps, with a fault planted where one is named:
        "order_ignored" trains every epoch's records in turn (each check
        step the first B records), "block0" trains the permutation's first
        B records at every step of the epoch; the others are
        reference_neutex.train_steps'."""
        order, checks = self.order, None
        if fault == "order_ignored":
            order, fault = np.arange(len(order)), None
            checks = [order] * self.n_check
        elif fault == "block0":
            order, fault = np.tile(order[:self.B], len(order) // self.B), None
        return reference_neutex.train_steps(self.p0, self.cfg,
                                            self.reference_batches(self.step_rows(order, checks)),
                                            q=q, fault=fault, keep=(self.n_check,),
                                            epoch_from=self.n_check + 1)

    def check(self, q=None, fault=None):
        """The check's numbers (the module's docstring): the program's
        steps (or, with q or fault, the reference put in its place) against
        the reference."""
        if self.ref is None:
            self.ref = self.reference_steps()
        n, ref = self.n_check, self.ref
        if q is None and fault is None:
            prog = self.prog
        else:
            alt = self.reference_steps(q, fault)
            # Adam's first moment after step 1: (1 - b1) g1, nought if the state stays as it was
            mu1_scale = 0.0 if fault == "unchanged" else 1.0 - 0.9
            prog = {"losses": alt["losses"][:n], "params0": self.p0,
                    "mu1": {k: mu1_scale * v for k, v in alt["grad1"].items()},
                    "params_check": alt["params"][n],
                    "epoch_loss": float(np.mean(alt["losses"][n:])),
                    "params_end": alt["params_end"], "mu_end": alt["mu_end"]}
        numbers = train_numbers(prog, ref, n)
        del numbers["epoch_mu_sign_share"]
        numbers["epoch_change_scale_gap"] = change_scale_gap(
            prog["params_end"], ref["params_end"], self.p0, moved_leaves(ref["grad1"]))
        return numbers


def run(ctx):
    return train_cell.run(ctx, NeuTexCell)


def readings(ctx, program=True):
    """The readings a limit is set from (benchmark/control.py): the
    program's numbers after a window of ctx.seconds, or those of the control
    (the reference with TF32 matmul operands) and of each fault, planted in
    the reference put in the program's place."""
    if program:
        return train_cell.readings(ctx, True, NeuTexCell)
    cell = NeuTexCell(ctx)
    cell.draw({k: tuple(v.shape) for k, v in cell.program_model("cpu").state_dict().items()})
    out = {"control": cell.check(q=reference_neutex.PRECISIONS[ctx.cfg["precision"]["control"]])}
    for fault in NEUTEX_FAULTS:
        out[fault] = cell.check(fault=fault)
    return out
