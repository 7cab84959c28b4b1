"""Training and validation epochs.

The train state is the network's parameters and optax-Adam moments as flat
f32 buffers in the kernels' padded layout (``ops/fused_mlp.ParamLayout``),
updated in place, plus the step count and the hyperparameters. A model
that computes its own loss (``computes_loss``: NeuTex) is no kernel chain:
its state holds every parameter in module order (``ModuleLayout``). An
epoch:

  - blocks shuffle + ``fused`` (the HQ recipe): each step streams one
    shuffled batch-sized block of the precomputed hit-feature table through
    the train kernels, Adam in wgrad's epilogue (``fused_train_adam_step``:
    the step finds its block, targets and hyper row on the device). On the
    card the whole epoch is one CUDA graph of those launches, two per step,
    captured on first use (``EpochGraph``) and replayed: one host dispatch
    per epoch. With ``fused_adam=False`` the gradients leave the kernel and
    the Adam kernel runs as its own call, per step from the host: the same
    numbers to the bit;
  - full shuffle + ``fused``: the batch rows are gathered, then the same
    kernels run on the gathered batch (the plain field only);
  - the view-dependent field takes the kernels (in tail mode) on the
    streaming blocks path when the data carries pre-encoded view
    directions (``hit_vencs``, the Trainer precomputes them), streamed at
    the same block offset as the features; otherwise the eager step;
  - anything else, and every epoch with a ragged tail batch
    (``train_drop_last: false``): the eager step — an f32 forward with
    autograd and the weighted mean loss of the reference (the
    view-dependent field encodes the batch's ray directions and face ids
    itself, as its module does; a field over xyz / ff / rff encodes the
    batch's positions with its own encoder unless the split was
    pre-embedded; a sine field takes sin), then the Adam kernel. On the
    CPU every kernel call runs its plain twin.

A self-loss model (NeuTex) always takes the eager step: autograd through
its ``loss_and_rgbs`` by ``torch.func.functional_call`` on views of the
flat parameters, then the Adam kernel on the flat gradient (one launch per
step). Its loss is the batch mean over all B rows, a ragged tail's
duplicates included, as in the JAX package's self-loss branch (JAX
train/steps.py:591-601); the squared error is still weighted by the row
mask. It validates through its forward (RGB only) under the config's
``loss_type``; ``fused`` raises for it.

A field with BatchNorm (``batchnorm: true``) is no kernel chain either: its
state is a ModuleLayout plus ``batch_stats``, the BatchNorms' running
statistics under the reference names. Its eager step runs the module's
forward in train mode through ``functional_call`` (the statistics of the
batch, a ragged tail's duplicates included, as in JAX; the running
statistics updated in place in ``state.batch_stats``), the weighted mean
loss, then the Adam kernel; it validates with the running statistics (JAX
:662). ``fused`` raises for it, as the JAX package asserts (:292-298).

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

Validation runs the f32 forward over every record (the last batch ragged)
and reports the reference's per-sample metrics (its "epoch PSNR" uses the
per-sample MSE summed over the 3 channels).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

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
)
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


def create_train_state(model, optimizer, device=None):
    """Fresh state: the model's weights, buffers and running statistics,
    zero moments, count 0; a self-loss or BatchNorm model's in a
    ModuleLayout, any other's in the kernels' padded ParamLayout."""
    layout = ModuleLayout(model) if uses_module_layout(model) else layout_for_model(model)
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
    loss, pred = loss_and_pred(p)
    loss.backward()
    fused_adam_apply(state.params, state.mu, state.nu, hyper_row, p.grad)
    eager_step.launches += 1
    sq = (((pred.detach() - gt) ** 2).sum(-1) * w).sum()
    return loss.detach(), sq, w.sum()


def weighted_loss_fn(layout, x, gt, w, loss_elem, venc=None, activation="relu"):
    """loss_and_pred for a texture field: its f32 forward on the flat
    parameters, the weighted mean of the per-sample loss (w masks the
    duplicated rows of a ragged tail)."""
    def fn(p):
        pred = forward_f32(layout, p, x.to(torch.float32), venc, activation)
        return (loss_elem(pred, gt).mean(-1) * w).sum() / w.sum(), pred
    return fn


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


def module_loss_fn(model, layout, state, inputs, gt, w, loss_elem):
    """loss_and_pred for a BatchNorm field: its module forward in train
    mode on the batch's inputs, the weighted mean of the per-sample loss."""
    def fn(p):
        pred = torch.func.functional_call(model, module_variables(layout, p, state), inputs,
                                          {"train": True})
        return (loss_elem(pred, gt).mean(-1) * w).sum() / w.sum(), pred
    return fn


def field_batch_fns(model):
    """(features_of, venc_of) for a texture field's flat-parameter forward:
    batch -> the MLP input rows (eigenfunction or pre-embedded rows, or the
    model's encoding of its positions), and batch -> the view encoding
    (None without a view-dependent tail)."""
    encode = input_encoder_apply(model)
    view_fn = view_encoder_apply(model) if hasattr(model, "spatial_mlp") else None

    def venc_of(batch):
        if view_fn is None:
            return None
        if "unit_ray_dirs" not in batch:
            raise ValueError("the view-dependent field needs the cached ray directions and "
                             "face ids (unit_ray_dirs.npy, face_idxs.npy)")
        return view_fn(batch["unit_ray_dirs"], batch["hit_face_idxs"])

    def features_of(batch):
        key = "eigenfunctions" if encode is None else "xyz"
        if key not in batch:
            raise ValueError(f"the model takes {key!r} rows, the split holds "
                             f"{sorted(k for k in batch if k in ('eigenfunctions', 'xyz'))}")
        x = batch[key]
        return x if encode is None else encode(x.to(torch.float32))

    return features_of, venc_of


def module_inputs_fn(model):
    """batch -> the positional inputs of a ModuleLayout model's forward:
    (positions,) for a self-loss model; (features or positions[, ray
    directions, face ids]) in f32 for a BatchNorm field (its module
    encodes them itself)."""
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


eager_step.launches = 0  # eager steps since the last reset


def _order(order, size, device=None):
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
    capture's seconds) and ``replays`` say what it did; ``events``, a pair
    of CUDA events or None, are recorded just before and after each replay."""

    def __init__(self):
        self.key = self.graph = self.bufs = None
        self.launches = {}
        self.captures, self.capture_s, self.replays = 0, 0.0, 0
        self.events = None

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
        if self.events is not None:
            self.events[0].record()
        self.graph.replay()
        if self.events is not None:
            self.events[1].record()
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
        with torch.cuda.graph(graph):
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
    """(train_epoch, val_epoch) for a TextureField or a
    TextureFieldWithViewDependency. `fused` needs a fused_mlp_eligible or
    fused_viewdep_eligible model (raises otherwise, as the JAX package
    asserts).

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
    if shuffle not in ("full", "blocks"):
        raise ValueError(f"shuffle must be 'full' or 'blocks', got {shuffle!r}")
    if uses_module_layout(model):
        return _module_epoch_fns(model, loss_type, shuffle, fused)
    loss_elem = elementwise_loss(loss_type)
    layout = layout_for_model(model)
    viewdep = layout.tail is not None
    encode = input_encoder_apply(model)
    features_of, venc_of = field_batch_fns(model)
    activation = model.activation
    if fused and not (fused_mlp_eligible(model) or fused_viewdep_eligible(model)):
        raise ValueError(
            "training.fused_mlp needs a plain TextureField (eigenfunction input, relu, "
            "sigmoid RGB head, hidden width a multiple of 128; an xyz/ff/rff field once the "
            "Trainer pre-embeds it) or a fused-eligible view-dependent field")
    if fused and viewdep:
        sp = layout.spec
        if not sp.hidden == sp.out_dim == layout.tail.d_hidden:
            raise ValueError("training.fused_mlp on a view-dependent field needs its "
                             "bottleneck and directional widths equal to the hidden width")

    graph = EpochGraph()
    ahead = {}  # (key, num_batches) -> the block order prefetch drew

    def streams_blocks(data, num_batches, B):
        return (shuffle == "blocks" and data.hit_features is not None
                and num_batches * B <= data.n)

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
        _check_epoch(data, num_batches, B)
        if state.layout.spec != layout.spec:
            raise ValueError("the state's layout is not this model's")
        has_tail = num_batches * B > n
        use_blocks = streams_blocks(data, num_batches, B)
        perm = ahead.pop((order, num_batches), None) if isinstance(order, Key) else None
        if perm is None or not use_blocks:
            perm = (_order(order, num_batches) if use_blocks
                    else _order(order, n, state.params.device))
        use_fused = fused and not has_tail
        if viewdep:  # the tail kernels stream pre-encoded view directions and
            # the spatial input as it is (an encoder family trains eagerly)
            use_fused = (use_fused and use_blocks and data.hit_vencs is not None
                         and encode is None)
        vencs = data.hit_vencs if viewdep else None
        dev = state.params.device
        hyper_all = _adam_rows(state, num_batches)
        if use_fused and use_blocks:
            # stream block perm[i] of the table through the kernels
            if not (0 <= int(perm.min()) and int(perm.max()) < num_batches):
                raise ValueError(f"block ids must lie in [0, {num_batches})")
            if fused_adam:
                acc = adam_blocks_epoch(state, perm, data, num_batches, B, hyper_all, vencs)
            else:
                acc = grads_blocks_epoch(state, perm, data, num_batches, B, hyper_all, vencs)
            state.count += num_batches
            means = acc / torch.full((), float(num_batches * B), dtype=torch.float32, device=dev)
            return state, {"loss": means[0], "sq_err_per_sample": means[1]}
        acc = torch.zeros(2, dtype=torch.float32, device=dev)  # loss, squared error
        acc_n = torch.zeros((), dtype=torch.float32, device=dev)
        perm_dev = perm.to(dev)
        scratch = make_train_scratch(layout, B, state.params) if use_fused else None
        for i in range(num_batches):
            if use_blocks:
                batch = slice_batch(data, int(perm[i]) * B, B)
                w = torch.ones(B, dtype=torch.float32, device=dev)
            else:
                pos = i * B + torch.arange(B, device=dev)
                w = (pos < n).to(torch.float32)
                batch = gather_batch(data, perm_dev[torch.clamp(pos, max=n - 1)])
            gt = batch["expected_rgbs"]
            if use_fused:
                x = batch["eigenfunctions"]
                if x.dtype not in (torch.bfloat16, torch.float32):
                    x = x.to(torch.float32)
                grads, loss_sum, sq_sum = fused_train_grads(
                    layout, state.params, x.contiguous(), gt, 0, B, loss_type, scratch)
                fused_adam_apply(state.params, state.mu, state.nu, hyper_all[i], grads)
                accumulate_loss(acc, loss_sum, sq_sum)
                acc_n = acc_n + float(B)
            else:
                loss, sq, n_b = eager_step(state, hyper_all[i], weighted_loss_fn(
                    layout, features_of(batch), gt, w, loss_elem, venc_of(batch), activation),
                    gt, w)
                acc += torch.stack((loss * n_b, sq))
                acc_n = acc_n + n_b
        state.count += num_batches
        means = acc / acc_n
        return state, {"loss": means[0], "sq_err_per_sample": means[1]}

    @torch.no_grad()
    def val_epoch(state, data, batch_size):
        n = data.n
        dev = state.params.device
        acc_loss = torch.zeros((), dtype=torch.float32, device=dev)
        acc_sq = torch.zeros((), dtype=torch.float32, device=dev)
        for s in range(0, n, batch_size):
            batch = gather_batch(data, torch.arange(s, min(s + batch_size, n), device=dev))
            gt = batch["expected_rgbs"]
            pred = forward_f32(layout, state.params, features_of(batch).to(torch.float32),
                               venc_of(batch), activation)
            # per-sample loss = channel mean (the reference's accounting)
            acc_loss = acc_loss + loss_elem(pred, gt).mean(-1).sum()
            acc_sq = acc_sq + ((pred - gt) ** 2).sum(-1).sum()
        return {"loss": acc_loss / n, "sq_err_per_sample": acc_sq / n}

    def prefetch(key, data, num_batches, batch_size):
        """Draw the block order `key` gives an epoch on these operands
        before that epoch (host work the Trainer overlaps with the running
        epoch's replay); the epoch given `key` then takes it."""
        ahead.clear()
        if streams_blocks(data, num_batches, batch_size):
            ahead[(key, num_batches)] = _order(key, num_batches)

    train_epoch.graph = graph
    train_epoch.prefetch = prefetch
    return train_epoch, val_epoch


def _adam_rows(state, num_batches):
    h = state.hyper
    return adam_hyper_rows(state.count + 1 + torch.arange(num_batches), h.learning_rate, h.b1,
                           h.b2, h.eps, h.eps_root, device=state.params.device)


def _check_epoch(data, num_batches, batch_size):
    n = data.n
    if not (0 < num_batches and (num_batches * batch_size <= n
                                 or num_batches == -(-n // batch_size))):
        raise ValueError(f"num_batches {num_batches} inconsistent with n={n}, "
                         f"batch={batch_size}")


def _module_epoch_fns(model, loss_type, shuffle, fused):
    """make_epoch_fns for a ModuleLayout model (a self-loss model, or a
    field with BatchNorm): the eager step on its module's forward."""
    name = type(model).__name__
    computes_loss = getattr(model, "computes_loss", False)
    if fused and computes_loss:
        raise ValueError("training.fused_mlp: the kernels cannot compute a self-loss model "
                         f"({name}: three networks and its own loss); it trains through the "
                         "eager step")
    if fused:
        raise ValueError("training.fused_mlp needs a model without BatchNorm (the kernels "
                         "keep no batch statistics); set fused_mlp: false")
    loss_elem = elementwise_loss(loss_type)
    layout = ModuleLayout(model)
    inputs_of = module_inputs_fn(model)
    val_kwargs = {} if computes_loss else {"train": False}

    def train_epoch(state, order, data, num_batches, batch_size):
        n, B = data.n, batch_size
        _check_epoch(data, num_batches, B)
        if state.layout.spec != layout.spec:
            raise ValueError("the state's layout is not this model's")
        use_blocks = (shuffle == "blocks" and data.hit_features is not None
                      and num_batches * B <= n)
        perm = (_order(order, num_batches) if use_blocks
                else _order(order, n, state.params.device))
        dev = state.params.device
        hyper_all = _adam_rows(state, num_batches)
        acc = torch.zeros(2, dtype=torch.float32, device=dev)  # loss, squared error
        acc_n = torch.zeros((), dtype=torch.float32, device=dev)
        perm_dev = perm.to(dev)
        for i in range(num_batches):
            if use_blocks:
                batch = slice_batch(data, int(perm[i]) * B, B)
                w = torch.ones(B, dtype=torch.float32, device=dev)
            else:
                pos = i * B + torch.arange(B, device=dev)
                w = (pos < n).to(torch.float32)
                batch = gather_batch(data, perm_dev[torch.clamp(pos, max=n - 1)])
            gt = batch["expected_rgbs"]
            inputs = inputs_of(batch)
            fn = (self_loss_fn(model, layout, inputs[0], gt) if computes_loss
                  else module_loss_fn(model, layout, state, inputs, gt, w, loss_elem))
            loss, sq, n_b = eager_step(state, hyper_all[i], fn, gt, w)
            acc += torch.stack((loss * n_b, sq))
            acc_n = acc_n + n_b
        state.count += num_batches
        means = acc / acc_n
        return state, {"loss": means[0], "sq_err_per_sample": means[1]}

    @torch.no_grad()
    def val_epoch(state, data, batch_size):
        n = data.n
        dev = state.params.device
        variables = module_variables(layout, state.params, state)
        acc_loss = torch.zeros((), dtype=torch.float32, device=dev)
        acc_sq = torch.zeros((), dtype=torch.float32, device=dev)
        for s in range(0, n, batch_size):
            batch = gather_batch(data, torch.arange(s, min(s + batch_size, n), device=dev))
            gt = batch["expected_rgbs"]
            pred = torch.func.functional_call(model, variables, inputs_of(batch), val_kwargs)
            acc_loss = acc_loss + loss_elem(pred, gt).mean(-1).sum()
            acc_sq = acc_sq + ((pred - gt) ** 2).sum(-1).sum()
        return {"loss": acc_loss / n, "sq_err_per_sample": acc_sq / n}

    train_epoch.graph = None  # no CUDA graph: one eager step per batch
    return train_epoch, val_epoch
