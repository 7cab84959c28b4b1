"""The gathered train cells' generator (traffic generator
"train_gathered_cell"): the train cells' closed loop of epochs
(train_cell.py) on the full shuffle, the walk ``Trainer`` takes by default.
Each epoch draws a permutation of every record on the card from its key
(``fold_in(key, epoch)``, as ``Trainer.train`` gives it) and gathers each
step's rows from the hit-feature table; the host issues every step.

What changes from train_cell.py is the rows each step trains. The check
steps are one-step epochs over the rows of distinct blocks, each in a
permutation of its rows drawn from the seed; the check epoch is one epoch
over every record in a permutation of them all drawn from the seed here.
The reference trains the rows perm[i B:(i + 1) B] at step i of that epoch.
Inputs, the reference's batches and its steps are methods of their own,
so that a configuration with another model can subclass this generator.
"""
from __future__ import annotations

import numpy as np
import torch

from . import reference, train_cell

SALT = 0x6A7E  # the seed's offset for this module's permutations


class TrainGatheredCell(train_cell.TrainCell):
    SHUFFLE = "full"
    RATE = "gathered_train_rays_per_s"

    def __init__(self, ctx):
        super().__init__(ctx)
        if self.vd is not None:
            raise ValueError("the gathered walk's kernels train a plain field")

    def draw(self, field_shapes):
        """train_cell's inputs and check blocks; then a permutation of each
        check step's B rows, and the check epoch's permutation of every
        record (`order`)."""
        super().draw(field_shapes)
        rng = np.random.default_rng((int(self.ctx.seed) + SALT) % (1 << 63))
        self.step_perms = [rng.permutation(self.B) for _ in self.blocks]
        self.order = rng.permutation(len(self.arrays["rgbs"]))

    def check_order(self, j):
        return self.step_perms[j]

    def check_epoch(self):
        """train_cell's check epoch in the record order; then one record
        permutation drawn on the card, as the window's epochs draw theirs
        (its sort and gathers run before the window)."""
        from intrinsic_neural_fields_tpu_torch.train.steps import epoch_order
        from intrinsic_neural_fields_tpu_torch.utils.jax_random import PRNGKey

        super().check_epoch()
        epoch_order(PRNGKey(self.ctx.seed), len(self.order), self.ctx.device)

    def step_rows(self, order):
        """The record ids of every step before the window: the check steps'
        blocks in their permutations, then `order` a batch at a time."""
        B = self.B
        rows = [b * B + p for b, p in zip(self.blocks, self.step_perms)]
        return rows + [order[i * B:(i + 1) * B] for i in range(len(order) // B)]

    def reference_batches(self, rows):
        """(interpolated features, None, targets) of each step's records, as
        the reference works them out from the benchmark's inputs; made one
        step at a time."""
        a = self.arrays
        for r in rows:
            r = torch.as_tensor(r, device=a["basis"].device)
            yield reference.interpolate(a["basis"], a["vids"][r], a["bary"][r]), None, a["rgbs"][r]

    def reference_steps(self, q=None, fault=None):
        """The reference's steps, with a fault planted where one is named:
        "order_ignored" trains the epoch's records in turn, "block0" trains
        the permutation's first B records at every step of the epoch; the
        others are reference.train_steps'."""
        order = self.order
        if fault == "order_ignored":
            order, fault = np.arange(len(order)), None
        elif fault == "block0":
            order, fault = np.tile(order[:self.B], len(order) // self.B), None
        return reference.train_steps(self.p0, self.cfg,
                                     self.reference_batches(self.step_rows(order)), q=q,
                                     fault=fault, keep=(self.n_check,),
                                     epoch_from=self.n_check + 1)


def run(ctx):
    return train_cell.run(ctx, TrainGatheredCell)


def readings(ctx, program=True):
    return train_cell.readings(ctx, program, TrainGatheredCell)
