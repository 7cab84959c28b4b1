"""Training and validation epochs, for one device and, through
``parallel/data_parallel.py``, for D replicas.

The train state is the network's parameters and optax-Adam moments as flat
f32 buffers in the kernels' padded layout (``ops/fused_mlp.ParamLayout``),
updated in place, plus the step count and the hyperparameters. A model
the kernels cannot compute (a self-loss model, NeuTex, or a field with
BatchNorm) holds every parameter in module order (``ModuleLayout``).

Each decision about an epoch lives here once, and both
``make_epoch_fns`` (one device, every model kind) and
``parallel.make_dp_epoch_fns`` (D replicas) call it:
``check_epoch_options`` refuses a model that cannot take ``fused``, at
construction; ``epoch_path`` picks an epoch's path; ``batch_at`` gives
step i's batch and position weights; ``forward_fn`` and ``eager_loss_fn``
are the model kind's f32 forward and eager loss; ``val_sums`` is the
validation pass; ``check_epoch``, ``epoch_order`` and ``epoch_hyper_rows``
check an epoch's operands, draw its order and make its Adam hyper rows.

The paths (``EpochPath``: the step, and whether the epoch walks blocks):

  - "adam" on blocks, a blocks shuffle + ``fused`` (the HQ recipe): each
    step streams one shuffled batch-sized block of the precomputed
    hit-feature table through the train kernels, Adam in wgrad's epilogue
    (``fused_train_adam_step``: the step finds its block, targets and hyper
    row on the device). On the card the whole epoch is one CUDA graph of
    those launches, two per step, captured on first use (``EpochGraph``)
    and replayed: one host dispatch per epoch;
  - "grads" on blocks, the same with ``fused_adam=False`` or under DP: the
    gradients leave the kernel and the Adam kernel runs as its own call,
    per step from the host (on one device the same numbers to the bit);
  - "grads" on gathered batches, a full shuffle + ``fused`` on one device:
    the batch rows are gathered, then the same kernels run on them (the
    plain field only: the view-dependent field takes its tail kernels on
    the blocks walk only, streaming the pre-encoded view directions
    ``hit_vencs`` that the Trainer precomputes);
  - "eager", anything else, and every epoch with a ragged tail batch
    (``train_drop_last: false``): the model's f32 forward with autograd,
    the weighted mean loss of the reference (a self-loss model's own batch
    mean over all B rows, a ragged tail's duplicates included, as in JAX
    train/steps.py:591-601), then the Adam kernel (``eager_step``). On the
    CPU every kernel call runs its plain twin.

Under the profiler a gathered step's ``batch_at`` is span train.gather, and
an eager step's forward and backward span train.autograd (attribute rows:
the batch's rows of nonzero weight) and its Adam kernel span train.adam,
each inside the epoch's train.epoch.

The kernels take a field as it is only when it is ``fused_mlp_eligible``
(or ``fused_viewdep_eligible``): relu, no encoder. The Trainer makes an
xyz / ff / rff field eligible by pre-embedding its splits and training
its ``mlp_core_view``.

Adam numerics are ``optax.inject_hyperparams(optax.adam)``'s: per-step
hyper rows (lr, bias corrections) come from ``adam_hyper_rows``, the lr is
read from the state every epoch (the plateau scheduler writes it there).
The shuffle order is an argument: a ``utils/jax_random.Key`` (the
Trainer's ``fold_in(base_key, epoch)``), from which the epoch draws what
the JAX epoch draws from its key, ``permutation(key, num_batches)`` of the
blocks or ``permutation(key, n)`` of the records (JAX train/steps.py:
340-343), or an explicit permutation.

Validation runs the f32 forward over every record, the last batch padded
and its padding masked as in the JAX val epoch (a BatchNorm field on its
running statistics, JAX :662; a self-loss model through its forward, RGB
only, under the config's ``loss_type``), and reports the reference's
per-sample metrics (its "epoch PSNR" uses the per-sample MSE summed over
the 3 channels).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.graph import increment_version

from ..data.sampler import gather_batch, slice_batch
from ..models.texture_field import input_encoder_apply, view_encoder_apply
from ..ops.fused_mlp import (
    LOSS_MODES,
    ParamLayout,
    _launches,
    _sync_wb,
    accumulate_loss,
    adam_hyper_rows,
    check_epoch_operands,
    fused_adam_apply,
    fused_mlp_eligible,
    fused_train_adam_step,
    fused_train_grads,
    fused_viewdep_eligible,
    kernel_launches,
    layout_for_model,
    make_train_scratch,
    prepare_train_kernels,
    spec_for_model,
)
from ..ops.launches import span
from ..utils.jax_random import Key, permutation
from .losses import elementwise_loss

@dataclass
class AdamHyper:
    """Hyperparameters of ``optax.inject_hyperparams(optax.adam)``; each
    value is held as the f32 number optax holds."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0

    def __post_init__(self):
        for name in ("learning_rate", "b1", "b2", "eps", "eps_root"):
            setattr(self, name, float(np.float32(getattr(self, name))))


class ModuleLayout:
    """The flat f32 layout of any module's parameters: ``named_parameters()``
    in module order, each parameter's elements contiguous, no padding. The
    buffer is allocated whole (16-byte aligned, as the Adam kernel needs);
    the part of ``ParamLayout``'s interface the train state, the Trainer
    and the checkpoints use: ``n``, ``spec`` (comparable), ``state_dict``,
    ``flat_from_state_dict``, ``param_names`` and per-parameter ``views``."""

    def __init__(self, model):
        self.names, self.shapes = [], []
        for name, p in model.named_parameters():
            self.names.append(name)
            self.shapes.append(tuple(p.shape))
        self.sizes = [int(np.prod(s)) for s in self.shapes]
        self.n = sum(self.sizes)
        self.spec = (type(model).__name__, tuple(zip(self.names, self.shapes)))

    def param_names(self):
        return list(self.names)

    def views(self, flat):
        """{name: view of flat at the parameter's shape}; one split, so the
        autograd backward of all views is one concatenation into the flat
        gradient."""
        return {name: t.view(shape) for name, shape, t in
                zip(self.names, self.shapes, flat.split(self.sizes))}

    @torch.no_grad()
    def flat_from_state_dict(self, state_dict, device=None):
        """Torch state dict -> flat f32 (every parameter must be present)."""
        device = (state_dict[self.names[0]].device if device is None
                  else torch.device(device))
        flat = torch.empty(self.n, dtype=torch.float32, device=device)
        for name, v in self.views(flat).items():
            w = state_dict[name]
            if tuple(w.shape) != v.shape:
                raise ValueError(f"{name}: shape {tuple(w.shape)}, the model's {tuple(v.shape)}")
            v.copy_(w.detach().to(device=device, dtype=torch.float32))
        return flat

    @torch.no_grad()
    def state_dict(self, flat, device=None):
        """Flat buffer -> state dict of contiguous copies, in module order."""
        return {name: v.clone().to(device) for name, v in self.views(flat).items()}


@dataclass
class TrainState:
    layout: ParamLayout    # or a ModuleLayout (a self-loss model)
    params: torch.Tensor   # flat f32, padded layout
    mu: torch.Tensor       # Adam first moment, same layout
    nu: torch.Tensor       # Adam second moment
    count: int             # Adam steps taken
    hyper: AdamHyper
    # the model's buffers that are part of its state dict (RFF's
    # embedding.B): fixed, carried into model.pt and checkpoint.pt
    buffers: dict = field(default_factory=dict)
    # the BatchNorms' running statistics (running_mean, running_var,
    # num_batches_tracked under the reference names), updated in place by
    # the train step; carried into model.pt and checkpoint.pt
    batch_stats: dict = field(default_factory=dict)

    def state_dict(self, device=None):
        """The parameters, buffers and running statistics as a torch-layout
        state dict (contiguous copies)."""
        sd = {k: v.detach().clone().to(device)
              for k, v in {**self.buffers, **self.batch_stats}.items()}
        sd.update(self.layout.state_dict(self.params, device))
        return sd

    def set_lr(self, lr):
        self.hyper.learning_rate = float(np.float32(lr))

    @classmethod
    def from_torch(cls, layout, model_state_dict, adam, device):
        """From a torch-layout state dict and an Adam dict {count, mu, nu
        (torch-layout state dicts), lr, b1, b2, eps[, eps_root]}."""
        flat = lambda sd: layout.flat_from_state_dict(sd, device)  # noqa: E731
        hyper = AdamHyper(adam["lr"], adam["b1"], adam["b2"], adam["eps"],
                          adam.get("eps_root", 0.0))
        return cls(layout, flat(model_state_dict), flat(adam["mu"]), flat(adam["nu"]),
                   int(adam["count"]), hyper, buffers_of(layout, model_state_dict, device),
                   batch_stats_of(model_state_dict, device))


BN_STATS = (".running_mean", ".running_var", ".num_batches_tracked")


def buffers_of(layout, state_dict, device=None):
    """The entries of a torch-layout state dict that are neither the
    layout's parameters nor BatchNorm statistics (RFF's embedding.B), as
    f32 copies on `device`."""
    params = set(layout.param_names())
    return {k: v.detach().to(device=device, dtype=torch.float32).clone()
            for k, v in state_dict.items() if k not in params and not k.endswith(BN_STATS)}


def batch_stats_of(state_dict, device=None):
    """The BatchNorm statistics of a torch-layout state dict, as copies on
    `device` (the running mean and variance f32, the counter as it is)."""
    return {k: v.detach().to(device=device, dtype=v.dtype if v.dtype == torch.int64
                             else torch.float32).clone()
            for k, v in state_dict.items() if k.endswith(BN_STATS)}


def uses_module_layout(model):
    """A model the kernels cannot compute, trained on the flat parameters
    in module order (ModuleLayout): a self-loss model or a field with
    BatchNorm."""
    return getattr(model, "computes_loss", False) or getattr(model, "batchnorm", False)


def layout_of(model):
    """The flat layout of the model's train state: a ModuleLayout for a
    self-loss or BatchNorm model, else the kernels' padded ParamLayout."""
    return ModuleLayout(model) if uses_module_layout(model) else layout_for_model(model)


def create_train_state(model, optimizer, device=None):
    """Fresh state: the model's weights, buffers and running statistics,
    zero moments, count 0; a self-loss or BatchNorm model's in a
    ModuleLayout, any other's in the kernels' padded ParamLayout."""
    layout = layout_of(model)
    sd = model.state_dict()
    params = layout.flat_from_state_dict(sd, device)
    return TrainState(layout, params, torch.zeros_like(params), torch.zeros_like(params),
                      0, AdamHyper(**vars(optimizer)), buffers_of(layout, sd, params.device),
                      batch_stats_of(sd, params.device))


def forward_f32(layout, params, x, venc=None, activation="relu"):
    """The model's forward in full f32 on the flat parameters (views, so
    autograd gives the flat gradient with zeros at the pads), in the
    module's expression order: the skip layer is Lx(h) + Ly(x), the
    view-dependent concat layer one Linear on [bottleneck | venc].
    activation: "relu" or "sine" on the hidden and directional layers
    (the bottleneck head stays relu, as in the module)."""
    mats, biases = layout.mats(params), layout.biases(params)
    src = {"x": x, "v": venc}
    act = torch.sin if activation == "sine" else torch.relu
    bneck = None if layout.tail is None else len(layout.layers) - 2
    h = None
    for li, lay in enumerate(layout.layers):
        if lay.h is None:  # the input layer
            e, r0, n, s = lay.ext
            pre = src[s][:, :n] @ mats[e][r0:r0 + n] + biases[e]
        elif lay.ext is None:
            e, r0, n = lay.h
            pre = h @ mats[e][r0:r0 + n] + biases[e]
        elif len(lay.biases) == 2:  # the skip layer: two Linears
            (e, r0, n), (ex, x0, nx, s) = lay.h, lay.ext
            pre = (h @ mats[e][r0:r0 + n] + biases[e]) + (
                src[s][:, :nx] @ mats[ex][x0:x0 + nx] + biases[ex])
        else:  # the concat layer: one Linear on [h | venc]
            (e, r0, n), (_, x0, nx, s) = lay.h, lay.ext
            pre = torch.cat([h, src[s][:, :nx]], 1) @ torch.cat(
                [mats[e][r0:r0 + n], mats[e][x0:x0 + nx]]) + biases[e]
        h = torch.relu(pre) if li == bneck else act(pre)
    e = layout.head
    out = 3 if layout.tail is None else layout.tail.rgb_dim
    return torch.sigmoid(h @ mats[e][:, :out] + biases[e][:out])


def eager_step(state, hyper_row, loss_and_pred, gt, w):
    """One autograd step on a gathered batch: loss_and_pred(p) -> (loss,
    pred [B, 3]) on a leaf copy p of the flat parameters (the forward reads
    views of it, so autograd gives the flat gradient), then Adam in place
    (the standalone kernel). w masks the duplicated rows of a ragged tail
    in the squared error. Returns (loss, sum over rows of w times the
    per-sample squared error, sum of w)."""
    p = state.params.detach().requires_grad_()
    n_w = w.sum()
    with span("train.autograd", rows=n_w):
        loss, pred = loss_and_pred(p)
        loss.backward()
    with span("train.adam"):
        fused_adam_apply(state.params, state.mu, state.nu, hyper_row, p.grad)
    eager_step.launches += 1
    sq = (((pred.detach() - gt) ** 2).sum(-1) * w).sum()
    return loss.detach(), sq, n_w


eager_step.launches = 0  # eager steps since the last reset


def self_loss_fn(model, layout, xyz, gt):
    """loss_and_pred for a self-loss model (NeuTex): its ``loss_and_rgbs``
    on the batch, through ``torch.func.functional_call`` on views of the
    flat parameters (the batch mean over every row)."""
    return lambda p: torch.func.functional_call(model, layout.views(p), (xyz, gt))


def module_variables(layout, params, state):
    """What functional_call substitutes into a ModuleLayout model: views of
    the flat params, the state's buffers and its running statistics (which
    a train-mode forward updates in place)."""
    return {**layout.views(params), **state.buffers, **state.batch_stats}


def module_inputs_fn(model):
    """batch -> the positional inputs of the model's module forward:
    (positions,) for a self-loss model; (features or positions[, ray
    directions, face ids]) in f32 for a texture field (its module encodes
    them itself)."""
    name = type(model).__name__
    if getattr(model, "computes_loss", False):
        def xyz_of(batch):
            if "xyz" not in batch:
                raise ValueError(f"{name} reads the hit positions ('xyz' rows, "
                                 "feature_strategy: xyz), the split holds "
                                 f"{sorted(k for k in batch if k != 'expected_rgbs')}")
            return (batch["xyz"].to(torch.float32),)
        return xyz_of
    key = "eigenfunctions" if input_encoder_apply(model) is None else "xyz"
    viewdep = hasattr(model, "spatial_mlp")

    def inputs_of(batch):
        if key not in batch:
            raise ValueError(f"the model takes {key!r} rows, the split holds "
                             f"{sorted(k for k in batch if k in ('eigenfunctions', 'xyz'))}")
        if viewdep and "unit_ray_dirs" not in batch:
            raise ValueError("the view-dependent field needs the cached ray directions and "
                             "face ids (unit_ray_dirs.npy, face_idxs.npy)")
        x = batch[key].to(torch.float32)
        return (x, batch["unit_ray_dirs"], batch["hit_face_idxs"]) if viewdep else (x,)
    return inputs_of


def forward_fn(model, layout, train=False):
    """(params, state, batch) -> the model's f32 RGB on the batch through
    the flat parameters `params`. A texture field: ``forward_f32`` on its
    MLP input rows (eigenfunction or pre-embedded rows, or its encoder's
    encoding of the positions) and, with a view-dependent tail, the
    encoding of the batch's ray directions and face ids. A ModuleLayout
    model: its module through ``functional_call``, a BatchNorm field in
    train mode when `train` (the batch's statistics; the running ones
    updated in place in ``state.batch_stats``), else on the running ones."""
    inputs_of = module_inputs_fn(model)
    if uses_module_layout(model):
        kwargs = {} if getattr(model, "computes_loss", False) else {"train": train}
        return lambda params, state, batch: torch.func.functional_call(
            model, module_variables(layout, params, state), inputs_of(batch), kwargs)
    encode = input_encoder_apply(model)
    view_fn = view_encoder_apply(model) if hasattr(model, "spatial_mlp") else None

    def forward(params, state, batch):
        x, *dirs_and_faces = inputs_of(batch)
        venc = None if view_fn is None else view_fn(*dirs_and_faces)
        return forward_f32(layout, params, x if encode is None else encode(x), venc,
                           model.activation)
    return forward


def eager_loss_fn(model, layout, loss_elem):
    """(state, batch, w) -> the eager step's loss_and_pred, by model kind: a
    self-loss model's own loss (``self_loss_fn``); any other model's f32
    forward (``forward_fn``, a BatchNorm field in train mode) and the
    weighted mean of the per-sample loss, sum(l w) / sum(w) (w masks the
    duplicated rows of a ragged tail)."""
    if getattr(model, "computes_loss", False):
        xyz_of = module_inputs_fn(model)
        return lambda state, batch, w: self_loss_fn(model, layout, xyz_of(batch)[0],
                                                    batch["expected_rgbs"])
    forward = forward_fn(model, layout, train=True)

    def loss_fn(state, batch, w):
        gt = batch["expected_rgbs"]

        def loss_and_pred(p):
            pred = forward(p, state, batch)
            return (loss_elem(pred, gt).mean(-1) * w).sum() / w.sum(), pred
        return loss_and_pred
    return loss_fn


def check_epoch_options(model, shuffle, fused):
    """Refuse, at construction, a shuffle other than "full" or "blocks",
    and ``fused`` for a model the train kernels cannot compute, as the JAX
    package asserts (:292-298): a self-loss model, a field with BatchNorm
    (the kernels keep no batch statistics), a field that is neither
    ``fused_mlp_eligible`` nor ``fused_viewdep_eligible``, and a
    view-dependent field whose bottleneck and directional widths differ
    from its hidden width."""
    if shuffle not in ("full", "blocks"):
        raise ValueError(f"shuffle must be 'full' or 'blocks', got {shuffle!r}")
    if not fused:
        return
    if getattr(model, "computes_loss", False):
        raise ValueError("training.fused_mlp: the kernels cannot compute a self-loss model "
                         f"({type(model).__name__}: three networks and its own loss); it "
                         "trains through the eager step")
    if getattr(model, "batchnorm", False):
        raise ValueError("training.fused_mlp needs a model without BatchNorm (the kernels "
                         "keep no batch statistics); set fused_mlp: false")
    if not (fused_mlp_eligible(model) or fused_viewdep_eligible(model)):
        raise ValueError(
            "training.fused_mlp needs a plain TextureField (eigenfunction input, relu, "
            "sigmoid RGB head, hidden width a multiple of 128; an xyz/ff/rff field once the "
            "Trainer pre-embeds it) or a fused-eligible view-dependent field")
    if hasattr(model, "spatial_mlp"):
        sp = spec_for_model(model)
        if not sp.hidden == sp.out_dim == model.directional_hidden_dim:
            raise ValueError("training.fused_mlp on a view-dependent field needs its "
                             "bottleneck and directional widths equal to the hidden width")


class EpochPath(NamedTuple):
    """How an epoch runs. step: "adam" (the train kernels with Adam in
    wgrad's epilogue), "grads" (the kernels' gradients, then the Adam
    kernel) or "eager" (autograd, then the Adam kernel). blocks: the epoch
    walks shuffled batch-sized blocks of the hit-feature table, else it
    gathers batches of permuted records."""
    step: str
    blocks: bool


def epoch_path(model, shuffle, fused, data, num_batches, batch_size, fused_adam=True,
               data_parallel=False):
    """The path of an epoch of `model` on `data`, from what the epoch can
    observe. It walks blocks on a blocks shuffle over a precomputed
    hit-feature table without a ragged tail. It takes the kernels under
    ``fused`` without a ragged tail; a view-dependent field only on the
    blocks walk, with pre-encoded view directions and no encoder on its
    spatial input (the tail kernels stream both as they are). Adam runs in
    the kernel under ``fused_adam`` on one device. A data-parallel epoch
    takes the kernels on the blocks walk only, and never Adam in them: the
    reduction comes between the gradients and Adam (JAX :65-86)."""
    whole = num_batches * batch_size <= data.n
    blocks = shuffle == "blocks" and data.hit_features is not None and whole
    kernels = fused and whole
    if hasattr(model, "spatial_mlp"):
        kernels = (kernels and blocks and data.hit_vencs is not None
                   and input_encoder_apply(model) is None)
    if kernels and blocks:
        return EpochPath("adam" if fused_adam and not data_parallel else "grads", True)
    if kernels and not data_parallel:
        return EpochPath("grads", False)
    return EpochPath("eager", blocks)


def check_epoch(state, layout, data, num_batches, batch_size):
    """Raise unless num_batches batches of batch_size cover the records
    (whole, or the last one ragged) and `state` is in the model's layout."""
    n = data.n
    if not (0 < num_batches and (num_batches * batch_size <= n
                                 or num_batches == -(-n // batch_size))):
        raise ValueError(f"num_batches {num_batches} inconsistent with n={n}, "
                         f"batch={batch_size}")
    if state.layout.spec != layout.spec:
        raise ValueError("the state's layout is not this model's")


def epoch_order(order, size, device=None):
    """The epoch's permutation of `size` as an int64 tensor: drawn from
    `order` when it is a jax_random.Key (on the host, or on `device`: the
    full shuffle's n records), else `order` itself."""
    if isinstance(order, Key):
        return (torch.from_numpy(permutation(order, size)) if device is None
                else permutation(order, size, device=device))
    t = torch.as_tensor(np.array(order), dtype=torch.int64)
    if t.shape != (size,):
        raise ValueError(f"the shuffle order must have shape ({size},), got {tuple(t.shape)}")
    return t


def epoch_hyper_rows(state, num_batches):
    """The Adam hyper rows of the epoch's num_batches steps, from the
    state's count and hyperparameters, on the state's device."""
    h = state.hyper
    with span("train.hyper_rows"):
        return adam_hyper_rows(state.count + 1 + torch.arange(num_batches), h.learning_rate,
                               h.b1, h.b2, h.eps, h.eps_root, device=state.params.device)


def batch_at(data, order, i, batch_size, blocks, start=0):
    """Step i's batch of `data` and its position weights [batch_size]. On
    the blocks walk: the contiguous block order[i] of the table (views;
    `order` the block order, on the host), every weight 1. On the gathered
    walk: the records order[i B:(i + 1) B] (`order` the epoch's record
    order padded past n, on the data's device; `start` its first position
    in the epoch's whole order), weight 1 at a position before n and 0
    past it."""
    B = batch_size
    dev = data.expected_rgbs.device
    if blocks:
        return (slice_batch(data, int(order[i]) * B, B),
                torch.ones(B, dtype=torch.float32, device=dev))
    with span("train.gather"):
        pos = start + i * B + torch.arange(B, device=dev)
        return gather_batch(data, order[i * B:(i + 1) * B]), (pos < data.n).to(torch.float32)


def val_sums(forward, state, data, start, stop, batch_size, num_batches, loss_elem):
    """The validation sums [loss, squared error] over records [start, stop)
    of `data`: num_batches batches of batch_size from `start` through
    forward(params, state, batch) (``forward_fn``), the rows past `stop`
    masked by position weights (past n, copies of the last record). The
    per-sample loss is the channel mean, the squared error the channel sum
    (the reference's accounting)."""
    dev = data.expected_rgbs.device
    acc = torch.zeros(2, dtype=torch.float32, device=dev)
    for i in range(num_batches):
        idx = start + i * batch_size + torch.arange(batch_size, device=dev)
        w = (idx < stop).to(torch.float32)
        batch = gather_batch(data, torch.clamp(idx, max=data.n - 1))
        gt = batch["expected_rgbs"]
        pred = forward(state.params, state, batch)
        acc += torch.stack(((loss_elem(pred, gt).mean(-1) * w).sum(),
                            (((pred - gt) ** 2).sum(-1) * w).sum()))
    return acc


@dataclass(eq=False)
class EpochBuffers:
    """What an epoch graph reads and writes besides the state and the
    tables: the train kernels' scratch, the block order (int32), the hyper
    rows [num_batches, 128], the last step's loss sums and the epoch's
    accumulators (loss, squared error)."""
    scratch: object
    order: torch.Tensor
    hyper: torch.Tensor
    sums: torch.Tensor
    acc: torch.Tensor

    @classmethod
    def make(cls, layout, B, num_batches, params):
        f32 = dict(dtype=torch.float32, device=params.device)
        return cls(make_train_scratch(layout, B, params),
                   torch.zeros(num_batches, dtype=torch.int32, device=params.device),
                   torch.zeros(num_batches, 128, **f32), torch.zeros(2, **f32),
                   torch.zeros(2, **f32))


def epoch_graph_key(state, data, bufs, B, num_batches, vencs):
    """What an epoch graph bakes in: every tensor its launches address, by
    pointer and dtype, and B and num_batches. A graph is replayed only for
    an equal key; a new params tensor (a resume builds new ones) or any
    other moved buffer gives another key, and the epoch is captured again."""
    sc = bufs.scratch
    ts = (state.params, state.mu, state.nu, data.hit_features, data.expected_rgbs, vencs,
          sc.wb, sc.acts, sc.deltas, sc.bias_part, sc.loss_part, bufs.order, bufs.hyper,
          bufs.sums, bufs.acc)
    return (B, num_batches) + tuple(None if t is None else (t.data_ptr(), t.dtype) for t in ts)


class EpochGraph:
    """The blocks + fused + fused_adam epoch on the card: num_batches steps
    of ``fused_train_adam_step`` (fwd_bwd, then wgrad with Adam) captured
    once into a ``torch.cuda.CUDAGraph`` and replayed, one host dispatch per
    epoch. The graph is captured on first use and again whenever
    ``epoch_graph_key`` changes. Per epoch the host writes the block order
    and this epoch's hyper rows (the lr may have changed) into the static
    buffers and zeroes the accumulators, then replays. The kernel wrappers
    count the launches they record during the capture; those counts
    (``launches``) are taken back from the totals then and added again at
    every replay, which runs them. ``captures``, ``capture_s`` (the last
    capture's seconds) and ``replays`` say what it did."""

    def __init__(self):
        self.key = self.graph = self.bufs = None
        self.launches = {}
        self.captures, self.capture_s, self.replays = 0, 0.0, 0

    def run(self, state, perm, data, num_batches, B, hyper_all, loss_type, vencs):
        """One epoch; returns the accumulators [2] (the static buffer, which
        the next replay overwrites)."""
        layout, params = state.layout, state.params
        b = self.bufs
        if (b is None or b.scratch.B != B or b.order.numel() != num_batches
                or b.acc.device != params.device):
            b = self.bufs = EpochBuffers.make(layout, B, num_batches, params)
        _sync_wb(b.scratch, params)
        b.order.copy_(perm.to(torch.int32))
        b.hyper.copy_(hyper_all)
        b.acc.zero_()
        key = epoch_graph_key(state, data, b, B, num_batches, vencs)
        if key != self.key:
            self.graph = self.key = None
            self.graph = self._capture(state, data, num_batches, B, loss_type, vencs)
            self.key = key
        with span("train.replay"):
            self.graph.replay()
        self.replays += 1
        for t in (params, state.mu, state.nu, b.scratch.wb):
            increment_version(t)  # the graph's kernels wrote them in place
        b.scratch.wb_of = (params, params._version)
        for name, n in self.launches.items():
            _launches[name] += n
        return b.acc

    def _capture(self, state, data, num_batches, B, loss_type, vencs):
        b = self.bufs
        prepare_train_kernels()  # nothing but launches inside the capture
        before = kernel_launches()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with span("train.capture"), torch.cuda.graph(graph):
            for i in range(num_batches):
                fused_train_adam_step(state.layout, state.params, state.mu, state.nu, b.hyper,
                                      b.order, i, data.hit_features, data.expected_rgbs, B,
                                      loss_type, b.scratch, b.sums, b.acc, vencs)
        # what the wrappers counted went into the graph, not onto the card
        after = kernel_launches()
        self.launches = {k: n - before[k] for k, n in after.items() if n != before[k]}
        _launches.update(before)
        self.capture_s = time.perf_counter() - t0
        self.captures += 1
        return graph


def make_epoch_fns(model, loss_type, shuffle="full", fused=False, fused_adam=True):
    """(train_epoch, val_epoch) on one device for any model the port
    trains: a texture field (plain or view-dependent), a BatchNorm field or
    a self-loss model. `fused` needs a model the kernels compute
    (``check_epoch_options`` raises otherwise, as the JAX package asserts).

    train_epoch(state, key_or_order, data, num_batches, batch_size)
        -> (state, {"loss", "sq_err_per_sample"}: 0-dim device tensors)
      updates `state` in place. key_or_order: a utils/jax_random.Key, or
      the permutation itself — of the num_batches blocks when the epoch
      streams blocks, else of the n records. ``train_epoch.graph``: the
      ``EpochGraph`` of its blocks + fused_adam epochs on the card.
      ``train_epoch.prefetch(key, data, num_batches, batch_size)`` draws
      the block order of the epoch given `key` ahead of it.
    val_epoch(state, data, batch_size) -> {"loss", "sq_err_per_sample"}
    """
    check_epoch_options(model, shuffle, fused)
    loss_elem = elementwise_loss(loss_type)
    layout = layout_of(model)
    forward = forward_fn(model, layout)
    loss_fn = eager_loss_fn(model, layout, loss_elem)
    graph = EpochGraph()
    ahead = {}  # (key, num_batches) -> the block order prefetch drew

    def path_of(data, num_batches, B):
        return epoch_path(model, shuffle, fused, data, num_batches, B, fused_adam)

    def adam_blocks_epoch(state, perm, data, num_batches, B, hyper_all, vencs):
        """The blocks + fused_adam epoch: two launches per step, Adam in
        wgrad's epilogue; on the card one graph replay. Returns acc [2]."""
        params = state.params
        if params.device.type == "cuda":
            check_epoch_operands(layout, params, state.mu, state.nu, data.hit_features,
                                 data.expected_rgbs, B, num_batches, vencs)
            if loss_type not in LOSS_MODES:
                raise ValueError(f"unknown loss_type {loss_type!r}")
            return graph.run(state, perm, data, num_batches, B, hyper_all, loss_type, vencs)
        scratch = make_train_scratch(layout, B, params)
        sums = torch.zeros(2, dtype=torch.float32)
        acc = torch.zeros(2, dtype=torch.float32)
        for i in range(num_batches):
            fused_train_adam_step(layout, params, state.mu, state.nu, hyper_all, perm, i,
                                  data.hit_features, data.expected_rgbs, B, loss_type, scratch,
                                  sums, acc, vencs)
        return acc

    def grads_blocks_epoch(state, perm, data, num_batches, B, hyper_all, vencs):
        """fused_adam=False: per step from the host, fwd_bwd and the
        grads-only wgrad on the block, then the standalone Adam kernel and
        the accumulators in torch. Returns acc [2]."""
        acc = torch.zeros(2, dtype=torch.float32, device=state.params.device)
        scratch = make_train_scratch(layout, B, state.params)
        for i in range(num_batches):
            blk = int(perm[i])
            gt = data.expected_rgbs[blk * B:(blk + 1) * B]
            grads, loss_sum, sq_sum = fused_train_grads(
                layout, state.params, data.hit_features, gt, blk, B, loss_type, scratch, vencs)
            fused_adam_apply(state.params, state.mu, state.nu, hyper_all[i], grads)
            accumulate_loss(acc, loss_sum, sq_sum)
        return acc

    def train_epoch(state, order, data, num_batches, batch_size):
        n, B = data.n, batch_size
        check_epoch(state, layout, data, num_batches, B)
        path = path_of(data, num_batches, B)
        perm = ahead.pop((order, num_batches), None) if isinstance(order, Key) else None
        if perm is None or not path.blocks:
            perm = (epoch_order(order, num_batches) if path.blocks
                    else epoch_order(order, n, state.params.device))
        dev = state.params.device
        hyper_all = epoch_hyper_rows(state, num_batches)
        if path.blocks and path.step != "eager":
            # stream block perm[i] of the table through the kernels
            if not (0 <= int(perm.min()) and int(perm.max()) < num_batches):
                raise ValueError(f"block ids must lie in [0, {num_batches})")
            vencs = data.hit_vencs if layout.tail is not None else None
            blocks_epoch = adam_blocks_epoch if path.step == "adam" else grads_blocks_epoch
            acc = blocks_epoch(state, perm, data, num_batches, B, hyper_all, vencs)
            state.count += num_batches
            means = acc / torch.full((), float(num_batches * B), dtype=torch.float32, device=dev)
            return state, {"loss": means[0], "sq_err_per_sample": means[1]}
        if not path.blocks:  # a ragged tail's rows repeat the last record
            perm = perm.to(dev)[torch.clamp(torch.arange(num_batches * B, device=dev), max=n - 1)]
        acc = torch.zeros(2, dtype=torch.float32, device=dev)  # loss, squared error
        acc_n = torch.zeros((), dtype=torch.float32, device=dev)
        scratch = make_train_scratch(layout, B, state.params) if path.step == "grads" else None
        for i in range(num_batches):
            batch, w = batch_at(data, perm, i, B, path.blocks)
            gt = batch["expected_rgbs"]
            if path.step == "grads":  # gathered rows through the kernels
                x = batch["eigenfunctions"]
                if x.dtype not in (torch.bfloat16, torch.float32):
                    x = x.to(torch.float32)
                grads, loss_sum, sq_sum = fused_train_grads(
                    layout, state.params, x.contiguous(), gt, 0, B, loss_type, scratch)
                fused_adam_apply(state.params, state.mu, state.nu, hyper_all[i], grads)
                accumulate_loss(acc, loss_sum, sq_sum)
                acc_n = acc_n + float(B)
            else:
                loss, sq, n_b = eager_step(state, hyper_all[i], loss_fn(state, batch, w), gt, w)
                acc += torch.stack((loss * n_b, sq))
                acc_n = acc_n + n_b
        state.count += num_batches
        means = acc / acc_n
        return state, {"loss": means[0], "sq_err_per_sample": means[1]}

    @torch.no_grad()
    def val_epoch(state, data, batch_size):
        n = data.n
        acc = val_sums(forward, state, data, 0, n, batch_size, -(-n // batch_size), loss_elem)
        return {"loss": acc[0] / n, "sq_err_per_sample": acc[1] / n}

    def prefetch(key, data, num_batches, batch_size):
        """Draw the block order `key` gives an epoch on these operands
        before that epoch (host work the Trainer overlaps with the running
        epoch's replay); the epoch given `key` then takes it."""
        with span("train.prefetch"):
            ahead.clear()
            if path_of(data, num_batches, batch_size).blocks:
                ahead[(key, num_batches)] = epoch_order(key, num_batches)

    train_epoch = _traced(train_epoch)
    train_epoch.graph = graph
    train_epoch.prefetch = prefetch
    return train_epoch, val_epoch


def _traced(epoch):
    """The epoch function inside a train.epoch span (attribute steps)."""
    def train_epoch(state, order, data, num_batches, batch_size):
        with span("train.epoch", steps=num_batches):
            return epoch(state, order, data, num_batches, batch_size)
    return train_epoch
