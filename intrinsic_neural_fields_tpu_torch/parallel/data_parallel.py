"""Data-parallel training over a list of devices, in one process (JAX
parallel/data_parallel.py): the work that exists only across replicas.
Every other decision of an epoch is ``train/steps.py``'s, the same
functions the one-device epoch calls: whether the model takes ``fused``
(``check_epoch_options``), the path an epoch takes (``epoch_path``, which
for DP never puts Adam in the kernel and takes the kernels on the blocks
walk only), step i's batch and its position weights (``batch_at``), the
model kind's forward (``forward_fn``) and the validation sums
(``val_sums``).

The JAX package runs its epoch under shard_map over a device mesh: the
model is replicated, the ray batch is sharded, gradients are pmean'd and
every device applies the same Adam update. The port keeps that shape in
one process over a device list, in which a device may repeat (["cpu"] * D
in the tests, ["cuda:0", "cuda:0"] on one card, cuda:0 ... cuda:D-1 from
``--num_devices D``). What this module adds:

  - the data. On the blocks walk (JAX :235-490) every per-hit array, the
    [N, k] hit-feature table and the encoded view directions among them,
    is cut once into D contiguous n_used / D row shards, one on each
    device (cut at first use and kept); each device walks its own
    permutation of its local_b = B / D row blocks, JAX's
    ``permutation(fold_in(key, d), num_batches)`` for device d (``order``:
    a utils/jax_random.Key, or an explicit [D, num_batches] tensor). On
    the gathered walk and with a ragged tail (JAX :492-528) one global
    permutation (``order``: a Key, drawn as ``permutation(key, n)`` on
    devices[0] as JAX draws it, or the explicit [n] permutation) is
    padded with index 0 past n and cut into D contiguous parts; every
    device holds the replicated records and gathers its own part's
    batches;
  - the loss terms. Each replica's loss is sum(w l) * D / sum over all
    replicas of w, so the mean of the replicas' gradients is the global
    weighted mean's. A self-loss model (NeuTex) scales its batch-mean loss
    by sum(w) / global sum(w) * D (JAX :181-190). A BatchNorm field runs
    sync-BN (JAX :116-123): the replicas' forwards run in step
    (``models.texture_field.run_fields_synced``); at each BatchNorm every
    replica's batch moments E[x], E[x^2] are averaged over the replicas,
    and every replica normalises and updates its running statistics with
    that global statistic. The moments travel with ``.to()``, which
    autograd differentiates, and one backward over the sum of the
    replicas' losses gives each replica its share of the cross-replica
    gradient;
  - the reduction and Adam. Per step every replica takes its gradient
    (the kernels' grads on the blocks walk under ``fused``, else
    autograd's), then the mean all-reduce of the flat gradients, then the
    standalone Adam kernel on every replica: Adam cannot sit in wgrad's
    epilogue here, because the reduction comes between them (JAX :65-73).
    A per-step host loop, no CUDA graph;
  - ``Replicas``: one train state per device, replica 0 the caller's.

The collective (``mean_all_reduce``) sums the replicas' buffers onto
devices[0] in replica order, divides by D there and copies the result back
to each replica's device, so every replica receives the same bits and
applies the same kernel: the replicas stay equal to the bit (JAX's pmean
keeps them replicated the same way). It is plain torch: peer copies
between distinct cards. On distinct cards the kernel path equals the
run with one card repeated to the bit; the eager path's backward sums the
gradient contributions that cross replicas in the order autograd's
per-device threads finish, so a sync-BN gradient may differ from the
repeated card's by f32 rounding (``tools/port_dp_cards.py``).

val_epoch (JAX :530-571): each device runs ``val_sums`` over a contiguous
ceil(n / D) range of the replicated records; the sums are added.
"""
from __future__ import annotations

import copy
from dataclasses import replace

import numpy as np
import torch
from torch import nn

from ..devices import device_of, device_scope, resolve_devices
from ..models.texture_field import run_fields_synced
from ..ops.fused_mlp import (accumulate_loss, fused_adam_apply, fused_train_grads,
                             make_train_scratch)
from ..train.losses import elementwise_loss
from ..train.steps import (
    TrainState,
    batch_at,
    check_epoch,
    check_epoch_options,
    epoch_hyper_rows,
    epoch_order,
    epoch_path,
    forward_fn,
    layout_of,
    module_inputs_fn,
    module_variables,
    uses_module_layout,
    val_sums,
)
from ..utils.jax_random import Key, fold_in, permutation


def sum_to_first(tensors):
    """The replicas' tensors summed, in replica order, on the first one's
    device (differentiable)."""
    dev0 = tensors[0].device
    total = tensors[0]
    for t in tensors[1:]:
        total = total + t.to(dev0)
    return total


def _copies(t, like):
    """t on each device of `like` (t itself where it already lives)."""
    return [t if x.device == t.device else t.to(x.device) for x in like]


def sum_all_reduce(tensors):
    """psum over the replicas: one copy of sum_to_first on each replica's
    device (the same tensor for a replica on the first device)."""
    return _copies(sum_to_first(tensors), tensors)


def mean_all_reduce(tensors):
    """pmean over the replicas: their sum on the first one's device,
    divided by D there, then one copy on each replica's device: every
    replica receives the same bits. Differentiable."""
    return _copies(sum_to_first(tensors) / len(tensors), tensors)


class _InStep(nn.ModuleList):
    """One copy of a BatchNorm field per device, their forwards run in step
    (sync-BN); called through functional_call with replica d's variables
    under the prefix "d."."""

    def forward(self, inputs, mean_moments):
        return run_fields_synced([m.steps(*a) for m, a in zip(self, inputs)], mean_moments)


class Replicas:
    """One TrainState per device. Replica 0 is the caller's state; the
    others are copies of it, made anew whenever the caller's tensors
    changed outside these epochs (a restore, a test)."""

    def __init__(self, devices):
        self.devices = devices
        self.states = None
        self._mark = None

    @staticmethod
    def _mark_of(state):
        """The state's tensors with their version counters, and its count."""
        ts = (state.params, state.mu, state.nu, *state.batch_stats.values())
        return [(t, t._version) for t in ts], state.count

    def _current(self, state):
        if self._mark is None:
            return False
        (was, count), (now, count_now) = self._mark, self._mark_of(state)
        return count == count_now and len(was) == len(now) and all(
            a is b and va == vb for (a, va), (b, vb) in zip(was, now))

    def sync(self, state):
        """The replicas for an epoch that starts from `state`."""
        if device_of(state.params) != self.devices[0]:
            raise ValueError(f"the train state lives on {state.params.device}; the device "
                             f"list starts with {self.devices[0]}")
        if not (self.states is not None and self.states[0] is state and self._current(state)):
            self.states = [state] + [replicate_state(state, dev) for dev in self.devices[1:]]
        return self.states

    def mark(self):
        self._mark = self._mark_of(self.states[0])


def replicate_state(state, dev):
    """A copy of a train state on `dev` (always a copy, on the same device
    too)."""
    cp = lambda t: t.to(dev, copy=True)  # noqa: E731
    return TrainState(state.layout, cp(state.params), cp(state.mu), cp(state.nu), state.count,
                      copy.copy(state.hyper), {k: cp(v) for k, v in state.buffers.items()},
                      {k: cp(v) for k, v in state.batch_stats.items()})


# RayData's per-hit arrays (the rest is the per-vertex table)
HIT_FIELDS = ("vertex_idxs_of_hit_faces", "barycentric_coords", "expected_rgbs",
              "unit_ray_dirs", "face_idxs", "hit_features", "hit_vencs")


def shard_ray_data(data, D, n_used, devices):
    """D RayData: device d holds rows [d n_used/D, (d+1) n_used/D) of every
    per-hit array (a copy on its device) and the per-vertex table."""
    per = n_used // D
    shards = []
    for d, dev in enumerate(devices):
        cut = {f: (None if getattr(data, f) is None
                   else getattr(data, f)[d * per:(d + 1) * per].to(dev, copy=True))
               for f in HIT_FIELDS}
        shards.append(replace(data, features=data.features.to(dev), **cut))
    return shards


def replicate_ray_data(data, dev):
    """The records on `dev`: the data itself when it lives there."""
    if device_of(data.expected_rgbs) == dev:
        return data
    move = {f: (None if getattr(data, f) is None else getattr(data, f).to(dev))
            for f in HIT_FIELDS}
    return replace(data, features=data.features.to(dev), **move)


def _block_orders(order, D, num_batches):
    if isinstance(order, Key):
        return [torch.from_numpy(permutation(fold_in(order, d), num_batches)) for d in range(D)]
    t = torch.as_tensor(np.array(order), dtype=torch.int64)
    if t.shape != (D, num_batches):
        raise ValueError(f"the block orders must have shape ({D}, {num_batches}), "
                         f"got {tuple(t.shape)}")
    if not (0 <= int(t.min()) and int(t.max()) < num_batches):
        raise ValueError(f"block ids must lie in [0, {num_batches})")
    return list(t)


def make_dp_epoch_fns(model, loss_type, devices, shuffle="full", fused=False):
    """(train_epoch, val_epoch) with the single-device signatures of
    train.steps.make_epoch_fns, data-parallel over `devices` (a list, or a
    count of CUDA devices; see the module docstring).

    train_epoch(state, key_or_order, data, num_batches, batch_size)
      updates `state` (replica 0) and the other replicas in place;
      ``train_epoch.replicas.states`` are the D train states.
      batch_size % D != 0 raises. ``fused`` needs a model the kernels
      compute (raises otherwise, as the single-device epochs do); the
      kernels take the grads on the streaming blocks walk, and Adam always
      runs on its own, after the reduction.
    val_epoch(state, data, batch_size) -> {"loss", "sq_err_per_sample"}
    """
    devices = resolve_devices(devices)
    D = len(devices)
    dev0 = devices[0]
    check_epoch_options(model, shuffle, fused)
    loss_elem = elementwise_loss(loss_type)
    layout = layout_of(model)
    module = uses_module_layout(model)
    computes_loss = getattr(model, "computes_loss", False)
    inputs_of = module_inputs_fn(model)
    # replica d's module: a copy of a ModuleLayout model on its device
    copies = _InStep(copy.deepcopy(model).to(dev) for dev in devices) if module else [model] * D
    forwards = [forward_fn(m, layout) for m in copies]
    replicas = Replicas(devices)
    shards_cache = {}
    data_cache = {}

    def shards_of(data, n_used):
        key = (id(data), n_used)
        if key not in shards_cache:
            shards_cache.clear()
            shards_cache[key] = (data, shard_ray_data(data, D, n_used, devices))
        return shards_cache[key][1]

    def replicated(data):
        key = id(data)
        if key not in data_cache:
            data_cache[key] = (data, [replicate_ray_data(data, dev) for dev in devices])
        return data_cache[key][1]

    def losses(states, ps, batches, ws, n_b):
        """Each replica's loss term (its weighted loss sum times D over the
        global weight), its predictions, per replica."""
        gts = [b["expected_rgbs"] for b in batches]
        if computes_loss:
            out = []
            for d, st in enumerate(states):
                loss, pred = torch.func.functional_call(
                    copies[d], module_variables(layout, ps[d], st),
                    inputs_of(batches[d]) + (gts[d],))
                out.append((loss * (ws[d].sum() / n_b[d]) * D, pred))
            return out
        if module:
            variables = {f"{d}.{k}": v for d, st in enumerate(states)
                         for k, v in module_variables(layout, ps[d], st).items()}
            preds = torch.func.functional_call(
                copies, variables, ([inputs_of(b) for b in batches], mean_all_reduce))
        else:
            preds = [forwards[d](ps[d], st, b) for d, (st, b) in enumerate(zip(states, batches))]
        return [((loss_elem(pred, gt).mean(-1) * w).sum() * (D / nb), pred)
                for pred, gt, w, nb in zip(preds, gts, ws, n_b)]

    def eager_dp_step(states, hypers, batches, ws):
        """One step on every replica: the loss terms, one backward over
        their sum, the mean all-reduce of the gradients, the Adam kernel on
        every replica. Returns (global loss, global weight, squared error)
        on devices[0]."""
        n_b = sum_all_reduce([w.sum() for w in ws])  # the global weight, on every device
        ps = [st.params.detach().requires_grad_() for st in states]
        terms = losses(states, ps, batches, ws, n_b)
        total = sum_to_first([t for t, _ in terms])
        total.backward()
        grads = mean_all_reduce([p.grad for p in ps])
        for st, h, g in zip(states, hypers, grads):
            with device_scope(st.params.device):
                fused_adam_apply(st.params, st.mu, st.nu, h, g)
        sq = sum_to_first([(((pred.detach() - b["expected_rgbs"]) ** 2).sum(-1) * w).sum()
                           for (_, pred), b, w in zip(terms, batches, ws)])
        return total.detach() / D, n_b[0], sq

    def train_epoch(state, order, data, num_batches, batch_size):
        n, B = data.n, batch_size
        if B % D:
            raise ValueError(f"batch_size {B} not divisible by {D} devices")
        check_epoch(state, layout, data, num_batches, B)
        lb, n_used = B // D, num_batches * B
        path = epoch_path(model, shuffle, fused, data, num_batches, B, data_parallel=True)
        states = replicas.sync(state)
        hyper0 = epoch_hyper_rows(state, num_batches)
        hypers = [hyper0 if dev == dev0 else hyper0.to(dev) for dev in devices]
        acc = torch.zeros(2, dtype=torch.float32, device=dev0)  # loss, squared error
        acc_n = torch.zeros((), dtype=torch.float32, device=dev0)
        if path.blocks:  # replica d walks its own block order over its shard
            walks, parts = _block_orders(order, D, num_batches), shards_of(data, n_used)
            starts = [0] * D
        else:  # replica d walks part d of the padded global order
            perm = epoch_order(order, n, dev0)
            perm = torch.cat([perm, perm.new_zeros(n_used - n)]) if n_used > n else perm[:n_used]
            per_dev = n_used // D
            walks = [perm[d * per_dev:(d + 1) * per_dev].to(dev) for d, dev in enumerate(devices)]
            parts, starts = replicated(data), [d * per_dev for d in range(D)]
        if path.step == "grads":
            scratch = [make_train_scratch(layout, lb, st.params) for st in states]
            for i in range(num_batches):
                grads, loss_sums, sq_sums = [], [], []
                for d, (st, sh) in enumerate(zip(states, parts)):
                    blk = int(walks[d][i])
                    with device_scope(devices[d]):
                        g, ls, ss = fused_train_grads(
                            layout, st.params, sh.hit_features,
                            sh.expected_rgbs[blk * lb:(blk + 1) * lb], blk, lb, loss_type,
                            scratch[d], sh.hit_vencs if layout.tail is not None else None)
                    grads.append(g)
                    loss_sums.append(ls)
                    sq_sums.append(ss)
                # Adam also writes the next step's bf16 weight copy
                for st, sc, h, g in zip(states, scratch, hypers, mean_all_reduce(grads)):
                    with device_scope(st.params.device):
                        fused_adam_apply(st.params, st.mu, st.nu, h[i], g, wb=sc.wb)
                    sc.wb_of = (st.params, st.params._version)
                accumulate_loss(acc, sum_to_first(loss_sums), sum_to_first(sq_sums))
            acc_n = torch.full((), float(n_used), dtype=torch.float32, device=dev0)
        else:
            for i in range(num_batches):
                batches, ws = zip(*(batch_at(parts[d], walks[d], i, lb, path.blocks, starts[d])
                                    for d in range(D)))
                loss, n_b, sq = eager_dp_step(states, [h[i] for h in hypers], batches, ws)
                acc += torch.stack((loss * n_b, sq))
                acc_n = acc_n + n_b
        for st in states:
            st.count += num_batches
        replicas.mark()
        means = acc / acc_n
        return state, {"loss": means[0], "sq_err_per_sample": means[1]}

    @torch.no_grad()
    def val_epoch(state, data, batch_size):
        if batch_size % D:
            raise ValueError(f"batch_size {batch_size} not divisible by {D} devices")
        n = data.n
        per_dev = -(-n // D)
        lb = batch_size // D
        reps = replicated(data)
        total = sum_to_first([
            val_sums(forwards[d], state if dev == device_of(state.params)
                     else replicate_state(state, dev), reps[d], d * per_dev,
                     min((d + 1) * per_dev, n), lb, -(-per_dev // lb), loss_elem)
            for d, dev in enumerate(devices)])
        return {"loss": total[0] / n, "sq_err_per_sample": total[1] / n}

    train_epoch.graph = None  # a per-step host loop
    train_epoch.replicas = replicas
    train_epoch.devices = devices
    return train_epoch, val_epoch


def parallelize_trainer(trainer, devices):
    """Swap a Trainer's epoch functions for data-parallel ones over
    `devices` (a count of CUDA devices or a device list starting with the
    Trainer's device), as the JAX package's parallelize_trainer does; the
    epochs run the Trainer's epoch_model (its mlp_core_view when it
    pre-embedded the splits)."""
    devs = resolve_devices(devices)
    trainer.train_epoch_fn, trainer.val_epoch_fn = make_dp_epoch_fns(
        trainer.epoch_model, trainer.loss_type, devs, shuffle=trainer.shuffle,
        fused=trainer.fused_mlp)
    print(f"Data-parallel training over {len(devs)} devices: {[str(d) for d in devs]}")
    return trainer
