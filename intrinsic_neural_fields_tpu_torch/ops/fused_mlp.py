"""Fused skip-MLP of the texture field: CUDA kernels + plain twins.

Inference: ``fused_apply(weights, x)`` runs the whole network (relu hidden
layers, one input re-injection, sigmoid RGB head) on a [B, k_in] f32
feature batch; ``fused_apply_viewdep(weights, x, venc)`` runs the
view-dependent field (the spatial network with a relu bottleneck head, then
[bottleneck | encoded view direction] -> relu -> sigmoid RGB).

Training (flat f32 parameters in the kernels' padded layout, ``ParamLayout``,
with the directional tail when a ``ViewDepTailSpec`` is given):
  - ``fused_train_grads``: forward, L1/L2/cauchy loss sums and the weight
    and bias gradients of the mean loss over one batch (``vencs=``: the
    encoded view directions beside the features, for the tail);
  - ``fused_adam_apply``: the optax Adam update, in place on params, m, v;
  - ``fused_train_adam_step``: the two composed, one training step with
    its batch found on the device (row0 = order[i] * B, the targets and the
    hyper row read at step i); on the card two launches, fwd_bwd then wgrad
    with Adam in its epilogue (``fused_mlp_wgrad_adam``), the gradients
    never stored. Its launch arguments do not depend on the block order, so
    ``train/steps.py`` captures an epoch of them as one CUDA graph;
    ``fused_train_adam`` is one such step on a given block, its operands
    checked;
  - ``fused_apply_trainable``: the forward as a ``torch.autograd.Function``
    whose backward runs the train kernels seeded by the output cotangent.

On a CUDA tensor every wrapper launches its hand-written sm_90a kernels
(``csrc/fused_mlp_fwd.cu``, ``csrc/fused_mlp_train.cu``,
``csrc/fused_adam.cu``; the tail has its own entry points in the first
two) or raises; on a CPU tensor it runs the plain torch twin beside it (the
same arithmetic: bf16-rounded matmul operands, f32 products and sums).
Each kernel's Python launcher counts its launches (``kernel_launches``).

The kernels see every network as a chain of 128-wide relu layers and one
16-wide sigmoid head. A layer applies its matrix to the previous layer's
output and, at the input layer, the skip layer and the tail's concat layer,
a second matrix to rows read straight from a table (the features, or the
encoded view directions); the tail adds the bottleneck and concat layers
to the chain (``ParamLayout.layers``).

The numerics are the reference Pallas kernels': every matmul operand is
rounded to bf16, sums are f32, saved activations and the deltas fed to the
backward matmuls are bf16, bias gradients are f32 column sums of the f32
deltas, and the loss gradient is that of the mean over the B*3 real outputs.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.autograd.graph import increment_version

from .launches import _launches, kernel_launches, register, reset_kernel_launches  # noqa: F401

KC = 64         # K-chunk of the kernels (input rows are padded to it)
OUT_PAD = 16    # padded head width of the kernels
KERNEL_HIDDEN = 128
BLOCK_ROWS = 64  # batch rows per block of the train kernels
LOSS_MODES = {"L1": 0, "L2": 1, "cauchy": 2}
COTANGENT_MODE = 3
CAUCHY_C2 = (20.0 / 255.0) ** 2
VENC_K = 16     # the concat layer's view rows are padded to this (one wmma k-step)
VENC_MAX = 64   # most encoded view lanes the kernels take (one chunk of their x tile)
KERNELS = ("fused_mlp_fwd", "fused_mlp_fwd_bwd", "fused_mlp_wgrad", "fused_adam",
           "fused_mlp_fwd_viewdep", "fused_mlp_fwd_bwd_viewdep", "fused_mlp_wgrad_viewdep",
           "fused_mlp_wgrad_adam", "fused_mlp_wgrad_adam_viewdep")
register(*KERNELS)


def _round_up(x, m):
    return -(-x // m) * m


@dataclass(frozen=True)
class FusedMLPSpec:
    num_layers: int      # total Linear depth incl. the output layer
    k_in: int            # input feature dim (unpadded)
    hidden: int          # hidden width
    skip_idx: int        # layer index with the input re-injection
    out_dim: int = 3

    def __post_init__(self):
        if not (self.num_layers > 2 and 0 < self.skip_idx < self.num_layers - 1):
            raise ValueError(
                f"need num_layers > 2 and 0 < skip_idx < num_layers-1, got "
                f"{self.num_layers}, {self.skip_idx}"
            )

    @property
    def k_w(self):
        """Rows of the packed input / skip-x matrices."""
        return _round_up(self.k_in, KC)

    def weight_names(self):
        """(state-dict prefix, role) per Linear, in the reference kernel's
        operand order; the skip layer has two (Lx on h, then Ly on x)."""
        names = []
        for i in range(self.num_layers - 1):
            if i == self.skip_idx:
                names.append((f"layers.{i}.Lx", "skip_h"))
                names.append((f"layers.{i}.Ly", "skip_x"))
            else:
                names.append((f"layers.{i}.0", "hidden" if i else "input"))
        names.append((f"layers.{self.num_layers - 1}.0", "out"))
        return names


@dataclass(frozen=True)
class ViewDepTailSpec:
    """Directional tail of TextureFieldWithViewDependency: [bottleneck |
    encoded view direction] -> Linear(d_hidden), relu -> Linear(3),
    sigmoid. The spatial FusedMLPSpec's out_dim is the bottleneck width."""
    venc_in: int     # encoded view-direction width (unpadded)
    d_hidden: int    # directional hidden width
    rgb_dim: int = 3

    @property
    def venc_w(self):
        """Rows of the concat matrix's view part (zero-padded)."""
        return _round_up(self.venc_in, VENC_K)


def spec_for_model(model):
    """FusedMLPSpec of a TextureField, or of the spatial field of a
    view-dependent one (out_dim = its bottleneck)."""
    m = getattr(model, "spatial_mlp", model)
    return FusedMLPSpec(num_layers=m.num_layers, k_in=m.in_dim, hidden=m.hidden_dim,
                        skip_idx=m.skip_layer_idx, out_dim=m.out_dim)


def fused_mlp_eligible(model):
    """A plain TextureField the kernels compute as it is: features taken as
    they are (no encoder), relu, sigmoid RGB head, 3 outputs, no BatchNorm,
    hidden width a multiple of 128 (JAX train/steps.py:57-72)."""
    return _plain_field(model) and model.input_feature_embed is None and _relu_rgb_field(model)


def fused_pre_embed_eligible(model):
    """A TextureField over xyz / ff / rff positions that the kernels compute
    once its input is embedded (``models.texture_field.mlp_core_view`` on
    ``input_encoder_apply`` rows; JAX train/steps.py:75-92)."""
    return (_plain_field(model) and model.input_feature_embed in ("xyz", "ff", "rff")
            and _relu_rgb_field(model))


def _plain_field(model):
    """A TextureField: not a view-dependent one, and not a model that
    computes its own loss (NeuTex), which no kernel computes."""
    return not (hasattr(model, "spatial_mlp") or getattr(model, "computes_loss", False))


def fused_viewdep_eligible(model):
    """A TextureFieldWithViewDependency the view-dependent kernels compute:
    relu, no BatchNorm, hidden, bottleneck and directional widths multiples of 128 (JAX
    train/steps.py:95-117). An encoder family's spatial input is embedded
    before the kernel, as for fused_pre_embed_eligible."""
    return (hasattr(model, "spatial_mlp") and model.activation == "relu"
            and not model.batchnorm and model.hidden_dim % 128 == 0
            and model.bottleneck_vec_dim % 128 == 0 and model.directional_hidden_dim % 128 == 0)


def _relu_rgb_field(model):
    return (model.activation == "relu" and model.return_rgb and model.out_dim == 3
            and not model.batchnorm and model.hidden_dim % 128 == 0)


def tail_for_model(model):
    if not hasattr(model, "spatial_mlp"):
        return None
    return ViewDepTailSpec(venc_in=model.venc_dim, d_hidden=model.directional_hidden_dim)


def layout_for_model(model):
    return ParamLayout(spec_for_model(model), tail_for_model(model))


class _Entry(NamedTuple):
    prefix: str
    role: str
    w_off: int    # offset of the [rows_pad, cols_pad] matrix in the flat buffer
    rows_pad: int
    cols_pad: int
    rows: int     # real rows (input dim)
    cols: int     # real cols (output dim)
    b_off: int    # offset of the bias (cols_pad long) in the flat buffer


class _Layer(NamedTuple):
    """One relu layer of the kernels' chain: ``h`` = (entry, row0, rows) of
    the matrix applied to the previous layer's output (None at layer 0),
    ``ext`` = (entry, row0, rows, "x" | "v") of the matrix applied to table
    rows (the features or the encoded view directions), ``biases`` the
    entries whose biases are added, in this order."""
    h: tuple
    ext: tuple
    biases: tuple


class ParamLayout:
    """The flat f32 parameter layout of the train kernels.

    Matrices come first, in ``weight_names`` order (then, with a tail, the
    concat matrix ``directional_mlp.0`` and the RGB head
    ``directional_mlp.2``), each [in_pad, out_pad] row-major (the transpose
    of torch's Linear weight): the input and skip-x matrices zero-padded to
    ``k_w`` rows, the RGB head to 16 columns, the concat matrix as
    [bottleneck rows ; view rows zero-padded to ``venc_w``]. The biases
    follow in the same order (the RGB head's padded to 16). The forward
    kernel's packed operands are the bf16 cast of the matrix region and the
    bias region as it is. Pads are zero, get zero gradients and stay zero
    under Adam."""

    def __init__(self, spec, tail=None):
        self.spec, self.tail = spec, tail
        h, kw = spec.hidden, spec.k_w
        pfx = "" if tail is None else "spatial_mlp."
        shapes = []
        for prefix, role in spec.weight_names():
            rows, rows_pad = (spec.k_in, kw) if role in ("input", "skip_x") else (h, h)
            if role == "out" and tail is not None:
                role, cols, cols_pad = "bneck", spec.out_dim, spec.out_dim
            elif role == "out":
                cols, cols_pad = spec.out_dim, OUT_PAD
            else:
                cols, cols_pad = h, h
            shapes.append((pfx + prefix, role, rows_pad, cols_pad, rows, cols))
        if tail is not None:
            bn, d = spec.out_dim, tail.d_hidden
            shapes.append(("directional_mlp.0", "cat", bn + tail.venc_w, d, bn + tail.venc_in, d))
            shapes.append(("directional_mlp.2", "rgb", d, OUT_PAD, d, tail.rgb_dim))
        self.n_w = sum(r * c for _, _, r, c, _, _ in shapes)
        entries, wo, bo = [], 0, self.n_w
        for prefix, role, rows_pad, cols_pad, rows, cols in shapes:
            entries.append(_Entry(prefix, role, wo, rows_pad, cols_pad, rows, cols, bo))
            wo += rows_pad * cols_pad
            bo += cols_pad
        self.entries = entries
        self.n = bo
        # the kernels' chain of relu layers, then the sigmoid head
        layers, j = [], 0
        for i in range(spec.num_layers - 1):
            if i == spec.skip_idx:
                layers.append(_Layer((j, 0, h), (j + 1, 0, spec.k_in, "x"), (j, j + 1)))
                j += 2
            else:
                layers.append(_Layer((j, 0, h) if i else None,
                                     None if i else (j, 0, spec.k_in, "x"), (j,)))
                j += 1
        if tail is not None:
            layers.append(_Layer((j, 0, h), None, (j,)))                       # bottleneck
            layers.append(_Layer((j + 1, 0, spec.out_dim),
                                 (j + 1, spec.out_dim, tail.venc_in, "v"), (j + 1,)))  # concat
            j += 2
        self.layers, self.head = layers, j

    def param_names(self):
        """The state-dict keys of the parameters, in entry order."""
        return [e.prefix + s for e in self.entries for s in (".weight", ".bias")]

    def mats(self, flat):
        """[rows_pad, cols_pad] views of the matrices, in entry order."""
        return [flat[e.w_off:e.w_off + e.rows_pad * e.cols_pad].view(e.rows_pad, e.cols_pad)
                for e in self.entries]

    def biases(self, flat):
        return [flat[e.b_off:e.b_off + e.cols_pad] for e in self.entries]

    @torch.no_grad()
    def flat_from_state_dict(self, state_dict, device=None):
        """Torch-layout state dict (Linear weights [out, in]) -> flat f32."""
        first = state_dict[self.entries[0].prefix + ".weight"]
        device = first.device if device is None else torch.device(device)
        flat = torch.zeros(self.n, dtype=torch.float32, device=device)
        for e, W, b in zip(self.entries, self.mats(flat), self.biases(flat)):
            w = state_dict[e.prefix + ".weight"].detach().t().to(device=device,
                                                                 dtype=torch.float32)
            W[:e.rows, :e.cols] = w
            b[:e.cols] = state_dict[e.prefix + ".bias"].detach().to(
                device=device, dtype=torch.float32)
        return flat

    @torch.no_grad()
    def state_dict(self, flat, device=None):
        """Flat buffer -> torch-layout state dict of contiguous copies."""
        sd = {}
        for e, W, b in zip(self.entries, self.mats(flat), self.biases(flat)):
            w = W[:e.rows, :e.cols]
            sd[e.prefix + ".weight"] = w.t().contiguous().to(device)
            sd[e.prefix + ".bias"] = b[:e.cols].clone().to(device)
        return sd

    def pack(self, flat):
        """FusedWeights for the forward kernel: bf16 matrices, f32 biases."""
        w = flat[:self.n_w].detach().to(torch.bfloat16)
        b = flat[self.n_w:].detach().clone()
        mats = [w[e.w_off:e.w_off + e.rows_pad * e.cols_pad].view(e.rows_pad, e.cols_pad)
                for e in self.entries]
        biases = [b[e.b_off - self.n_w:e.b_off - self.n_w + e.cols_pad] for e in self.entries]
        return FusedWeights(self.spec, w, b, mats, biases, self)


class FusedWeights(NamedTuple):
    spec: FusedMLPSpec
    w: torch.Tensor        # packed bf16 matrices (kernel operand)
    b: torch.Tensor        # packed f32 biases (kernel operand)
    mats: list             # views of w: [in_padded, out_padded] bf16
    biases: list           # views of b
    layout: ParamLayout    # the flat layout the pack was cut from


@torch.no_grad()
def pack_weights(spec, state_dict, device=None):
    """Port/reference state dict (torch Linear [out, in]) -> FusedWeights."""
    layout = ParamLayout(spec)
    return layout.pack(layout.flat_from_state_dict(state_dict, device))


def _bf16(t):
    """Round to bf16 (nearest-even) and widen back: products of two such
    values are exact in f32, so an f32 matmul on them is a bf16-operand,
    f32-accumulate product."""
    return t.to(torch.bfloat16).to(torch.float32)


def _forward_plain(layout, mats, biases, x, venc):
    """The kernels' chain on bf16-valued f32 matrices: (post-relu bf16-valued
    activations of every layer, head pre-activation [B, 16])."""
    spec = layout.spec
    xb = _bf16(x[:, :spec.k_in].to(torch.float32))
    vb = None if venc is None else _bf16(venc[:, :layout.tail.venc_in].to(torch.float32))
    h, acts = None, []
    for lay in layout.layers:
        ins, ws = [], []
        if lay.h is not None:
            e, r0, n = lay.h
            ins.append(h)
            ws.append(mats[e][r0:r0 + n])
        if lay.ext is not None:
            e, r0, n, src = lay.ext
            ins.append(xb if src == "x" else vb)
            ws.append(mats[e][r0:r0 + n])
        # one [h | rows] . [Wh ; Wrows] contraction, as the reference kernels
        pre = ins[0] @ ws[0] if len(ins) == 1 else torch.cat(ins, 1) @ torch.cat(ws, 0)
        for bi in lay.biases:
            pre = pre + biases[bi]
        h = _bf16(torch.relu(pre))
        acts.append(h)
    return acts, h @ mats[layout.head] + biases[layout.head]


def fused_apply_plain(fw, x):
    """Plain torch twin of the kernel (any device): [B, k_in] f32 -> [B, 3]."""
    layout = fw.layout
    if layout.tail is not None:
        raise ValueError("fused_apply_plain: view-dependent weights need "
                         "fused_apply_viewdep_plain")
    mats = [m.to(torch.float32) for m in fw.mats]
    _, z = _forward_plain(layout, mats, fw.biases, x, None)
    return torch.sigmoid(z)[:, :fw.spec.out_dim]


def fused_apply_viewdep_plain(fw, x, venc):
    """Plain torch twin of the view-dependent kernel (any device): x [B,
    k_in] f32 features, venc [B, venc_in] f32 encoded view directions ->
    [B, 3]."""
    layout = fw.layout
    if layout.tail is None:
        raise ValueError("fused_apply_viewdep_plain: weights have no view-dependent tail")
    if venc.dim() != 2 or venc.shape[1] != layout.tail.venc_in:
        raise ValueError(f"fused_apply_viewdep_plain: venc must be [B, {layout.tail.venc_in}], "
                         f"got {tuple(venc.shape)}")
    mats = [m.to(torch.float32) for m in fw.mats]
    _, z = _forward_plain(layout, mats, fw.biases, x, venc)
    return torch.sigmoid(z)[:, :layout.tail.rgb_dim]


def _check_kernel_spec(layout, what):
    spec, tail = layout.spec, layout.tail
    if tail is None:
        ok = spec.hidden == KERNEL_HIDDEN and spec.out_dim == 3
    else:
        ok = (spec.hidden == spec.out_dim == tail.d_hidden == KERNEL_HIDDEN
              and tail.rgb_dim == 3 and 0 < tail.venc_in <= VENC_MAX)
    if not ok:
        raise ValueError(
            f"{what}: the kernels take hidden={KERNEL_HIDDEN} and out_dim=3 (a tail: "
            f"bottleneck and directional width {KERNEL_HIDDEN}, at most {VENC_MAX} view "
            f"lanes); got {spec}, {tail}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_consts(lib, consts):
    for const, want in consts:
        getattr(lib, const).restype = ctypes.c_int
        if getattr(lib, const)() != want:
            raise RuntimeError(f"{const} disagrees with the Python layout")


def _fwd_lib():
    from ._build import load

    lib = load("fused_mlp_fwd")
    if lib.fused_mlp_fwd.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.fused_mlp_fwd.argtypes = [P] * 4 + [I] * 5 + [P, P]
        lib.fused_mlp_fwd_viewdep.argtypes = [P] * 5 + [I] * 7 + [P, P]
        lib.fused_mlp_fwd.restype = lib.fused_mlp_fwd_viewdep.restype = I
        _check_consts(lib, (("fused_mlp_fwd_kc", KC), ("fused_mlp_fwd_out_pad", OUT_PAD),
                            ("fused_mlp_fwd_venc_max", VENC_MAX)))
    return lib


def _check_rows(name, t, B, widths, dev, what):
    if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != B
            or t.shape[1] not in widths or t.device != dev):
        raise ValueError(f"{what}: {name} must be [B, {' or '.join(map(str, widths))}] "
                         f"float32 on {dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")


def _check_packed(fw, dev, what):
    for name, t, dt in (("w", fw.w, torch.bfloat16), ("b", fw.b, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{what}: packed {name} must be contiguous {dt} on {dev}")


def fused_apply(fw, x):
    """[B, k_in] f32 features -> [B, 3] f32 RGB through the fused MLP.

    CPU tensor: the plain twin. CUDA tensor: the sm_90a kernel on the
    current stream, or an error — never a fallback."""
    if x.device.type == "cpu":
        return fused_apply_plain(fw, x)
    if x.device.type != "cuda":
        raise ValueError(f"fused_apply: unsupported device {x.device}")
    spec, layout = fw.spec, fw.layout
    if layout.tail is not None:
        raise ValueError("fused_apply: view-dependent weights need fused_apply_viewdep")
    _check_kernel_spec(layout, "fused_apply")
    _check_rows("x", x, x.shape[0] if x.dim() else -1, (spec.k_in,), x.device, "fused_apply")
    _check_packed(fw, x.device, "fused_apply")
    B = x.shape[0]
    out = torch.empty((B, spec.out_dim), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    rc = _fwd_lib().fused_mlp_fwd(x.data_ptr(), fw.w.data_ptr(), fw.b.data_ptr(),
                                  out.data_ptr(), B, spec.k_in, spec.k_w, spec.num_layers,
                                  spec.skip_idx, _FWD_LAUNCHED, _stream(x))
    if rc != 0:
        raise RuntimeError(f"fused_mlp_fwd launch failed: cudaError {rc}")
    _launches["fused_mlp_fwd"] += 1
    return out


def fused_apply_viewdep(fw, x, venc):
    """View-dependent field: [B, k_in] f32 features and [B, venc_in] f32
    encoded view directions -> [B, 3] f32 RGB.

    CPU tensor: the plain twin. CUDA tensor: the sm_90a kernel
    ``fused_mlp_fwd_viewdep`` on the current stream, or an error."""
    if x.device.type == "cpu":
        return fused_apply_viewdep_plain(fw, x, venc)
    if x.device.type != "cuda":
        raise ValueError(f"fused_apply_viewdep: unsupported device {x.device}")
    spec, layout = fw.spec, fw.layout
    tail = layout.tail
    if tail is None:
        raise ValueError("fused_apply_viewdep: weights have no view-dependent tail")
    what = "fused_apply_viewdep"
    _check_kernel_spec(layout, what)
    B = x.shape[0] if x.dim() else -1
    _check_rows("x", x, B, (spec.k_in,), x.device, what)
    _check_rows("venc", venc, B, (tail.venc_in,), x.device, what)
    _check_packed(fw, x.device, what)
    out = torch.empty((B, tail.rgb_dim), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    rc = _fwd_lib().fused_mlp_fwd_viewdep(
        x.data_ptr(), venc.data_ptr(), fw.w.data_ptr(), fw.b.data_ptr(), out.data_ptr(), B,
        spec.k_in, spec.k_w, spec.num_layers, spec.skip_idx, tail.venc_in, tail.venc_w,
        _FWD_LAUNCHED, _stream(x))
    if rc != 0:
        raise RuntimeError(f"fused_mlp_fwd_viewdep launch failed: cudaError {rc}")
    _launches["fused_mlp_fwd_viewdep"] += 1
    return out


# The shape of the last forward launch (either field), written by the C
# entry point.
_FWD_LAUNCHED = (ctypes.c_int * 6)()


def last_fwd_launch():
    """The shape the last forward launch (either field) ran with: {"ctas",
    "cluster", "threads", "smem_bytes", "rows", "x_resident"} (batch rows
    per CTA; 1 if the bf16 feature tile stayed in shared memory, 0 if the
    skip layer streamed the features again)."""
    return dict(zip(("ctas", "cluster", "threads", "smem_bytes", "rows", "x_resident"),
                    _FWD_LAUNCHED))


# ----------------------------------------------------------------- training

def _loss_and_grad(loss_type, pred, gt, inv_n):
    """Elementwise loss, squared error and d(mean loss)/d pred, f32, in the
    reference kernel's expression order."""
    diff = pred - gt
    if loss_type == "L1":
        return diff.abs(), diff * diff, torch.sign(diff) * inv_n
    if loss_type == "L2":
        return diff * diff, diff * diff, 2.0 * diff * inv_n
    if loss_type == "cauchy":
        c2 = CAUCHY_C2
        return (c2 * torch.log1p(diff * diff / c2), diff * diff,
                (2.0 * diff / (1.0 + diff * diff / c2)) * inv_n)
    raise ValueError(f"unknown loss_type {loss_type!r}")


def _check_uniform(layout):
    spec, tail = layout.spec, layout.tail
    if tail is not None and not spec.hidden == spec.out_dim == tail.d_hidden:
        raise ValueError("the train kernels' scratch needs bottleneck and directional "
                         f"widths equal to the hidden width, got {spec}, {tail}")


def _fwd_bwd(layout, params, x, venc, target, loss_type):
    _check_uniform(layout)
    out_dim = 3 if layout.tail is None else layout.tail.rgb_dim
    B = x.shape[0]
    mats = [_bf16(m) for m in layout.mats(params.detach())]
    biases = layout.biases(params.detach())
    acts, z = _forward_plain(layout, mats, biases, x, venc)
    p = torch.sigmoid(z[:, :out_dim])
    target = target.to(torch.float32)
    if loss_type is None:
        loss_sum = sq_sum = None
        g = target
    else:
        loss, sq, g = _loss_and_grad(loss_type, p, target, 1.0 / (B * out_dim))
        loss_sum, sq_sum = loss.sum(), sq.sum()
    d = torch.nn.functional.pad(g * p * (1.0 - p), (0, OUT_PAD - out_dim))
    nh = len(layout.layers)
    deltas, sums = [None] * nh, [None] * nh
    dout, dsum = _bf16(d), d.sum(0)
    dh = dout @ mats[layout.head].t()
    for i in range(nh - 1, -1, -1):
        dl = dh * (acts[i] > 0)
        deltas[i], sums[i] = _bf16(dl), dl.sum(0)
        if i > 0:
            e, r0, n = layout.layers[i].h
            dh = deltas[i] @ mats[e][r0:r0 + n].t()
    to_bf16 = lambda ts: torch.cat([t.reshape(-1) for t in ts]).to(torch.bfloat16)  # noqa: E731
    return (to_bf16(acts), to_bf16(deltas + [dout]), torch.cat(sums + [dsum]),
            loss_sum, sq_sum)


def fwd_bwd_plain(layout, params, x, target, loss_type):
    """Plain twin of the fwd_bwd kernel. x: [B, >=k_in] rows (bf16 or f32);
    target: [B, 3] ground truth, or the output cotangent when loss_type is
    None. Returns what the kernel leaves for wgrad, in its scratch layout:
    (acts [nh*B*H] bf16 post-relu activations of the nh relu layers, deltas
    [nh*B*H + B*16] bf16 deltas of every layer then the head, bias_sums
    [H*nh+16] f32 column sums of the f32 deltas, loss_sum, sq_sum)."""
    return _fwd_bwd(layout, params, x, None, target, loss_type)


def fwd_bwd_viewdep_plain(layout, params, x, venc, target, loss_type):
    """Plain twin of the view-dependent fwd_bwd kernel: as fwd_bwd_plain,
    with venc [B, venc_w] the encoded view directions beside x (lanes past
    venc_in are not read); the nh relu layers include the bottleneck and
    the concat layer."""
    return _fwd_bwd(layout, params, x, venc, target, loss_type)


def _wgrad(layout, x, venc, acts, deltas, bias_sums):
    _check_uniform(layout)
    spec, H = layout.spec, layout.spec.hidden
    nh, B = len(layout.layers), x.shape[0]
    src = {"x": _bf16(x[:, :spec.k_in].to(torch.float32))}
    if venc is not None:
        src["v"] = _bf16(venc[:, :layout.tail.venc_in].to(torch.float32))
    A = acts.to(torch.float32).view(nh, B, H)
    D = deltas[:nh * B * H].to(torch.float32).view(nh, B, H)
    Dout = deltas[nh * B * H:].to(torch.float32).view(B, OUT_PAD)
    grads = torch.zeros(layout.n, dtype=torch.float32, device=acts.device)
    gm, gb = layout.mats(grads), layout.biases(grads)
    for i, lay in enumerate(layout.layers):
        if lay.h is not None:
            e, r0, n = lay.h
            gm[e][r0:r0 + n] = A[i - 1].t() @ D[i]
        if lay.ext is not None:
            e, r0, n, s = lay.ext
            gm[e][r0:r0 + n] = src[s].t() @ D[i]
        for bi in lay.biases:
            gb[bi][:] = bias_sums[H * i:H * (i + 1)]
    gm[layout.head][:] = A[nh - 1].t() @ Dout
    gb[layout.head][:] = bias_sums[H * nh:]
    return grads


def wgrad_plain(layout, x, acts, deltas, bias_sums):
    """Plain twin of the wgrad kernel on fwd_bwd's outputs (either twin's):
    the flat gradient, dW = A^T . D over the batch, biases from bias_sums."""
    return _wgrad(layout, x, None, acts, deltas, bias_sums)


def wgrad_viewdep_plain(layout, x, venc, acts, deltas, bias_sums):
    """Plain twin of the view-dependent wgrad kernel: as wgrad_plain, the
    concat matrix's view rows contracted with venc."""
    return _wgrad(layout, x, venc, acts, deltas, bias_sums)


def accumulate_loss(acc, loss_sum, sq_sum):
    """The epoch's accumulators, in place: acc[0] += loss_sum / 3 (the
    batch's mean loss times B), acc[1] += sq_sum; f32, the division by a
    device tensor (a correctly rounded quotient, as the kernel's: torch on
    the card multiplies by the reciprocal of a Python scalar divisor)."""
    three = torch.full((), 3.0, dtype=torch.float32, device=acc.device)
    acc += torch.stack((loss_sum / three, sq_sum))


def wgrad_adam_plain(layout, x, acts, deltas, bias_sums, sums, params, m, v, hyper, wb,
                     acc=None, venc=None):
    """Plain twin of the wgrad kernel with its Adam epilogue (either
    layout; venc: the view rows, with a tail): ``wgrad_plain`` (or
    ``wgrad_viewdep_plain``), then ``adam_apply_plain`` IN PLACE on params,
    m, v with the new params rounded to bf16 into wb (if given); sums (loss_sum,
    sq_sum) go into acc by ``accumulate_loss`` when acc is given."""
    grads = _wgrad(layout, x, venc, acts, deltas, bias_sums)
    for dst, src in zip((params, m, v), adam_apply_plain(params, m, v, hyper, grads)):
        dst.copy_(src)
    if wb is not None:
        wb.copy_(params)
    if acc is not None:
        accumulate_loss(acc, *sums)


def train_grads_plain(layout, params, x, gt, loss_type="L1", venc=None):
    """Plain twin of ``fused_train_grads`` on a gathered [B, k_in] batch
    (and its [B, venc_w] view encodings with a tail): fwd_bwd then
    wgrad, (flat grads, loss_sum, sq_sum)."""
    acts, deltas, bias_sums, loss_sum, sq_sum = _fwd_bwd(layout, params, x, venc, gt, loss_type)
    return _wgrad(layout, x, venc, acts, deltas, bias_sums), loss_sum, sq_sum


def apply_vjp_plain(layout, params, x, g):
    """Plain twin of the forward's VJP: flat weight/bias grads of
    sum(g * fused_apply(x)); no input gradient."""
    return train_grads_plain(layout, params, x, g, None)[0]


@dataclass(eq=False)
class TrainScratch:
    """Per-batch-size device scratch of the train kernels (allocate once
    per epoch): the bf16 copy of the flat params that fwd_bwd reads its
    weights from (``wb``, round to nearest even), bf16 activations and
    deltas, per-64-row bias and loss partial sums.
    ``wb_of``: the params tensor ``wb`` was rounded from and its
    version counter then; the train kernels round the params again when
    either differs (see ``_sync_wb``)."""
    B: int
    wb: torch.Tensor
    acts: torch.Tensor
    deltas: torch.Tensor
    bias_part: torch.Tensor
    loss_part: torch.Tensor
    wb_of: tuple = (None, -1)


def _sync_wb(scratch, params):
    """Make ``scratch.wb`` params rounded to bf16: round them unless the copy
    was made from this tensor at its current version. Every in-place write
    to params bumps its version counter (``fused_adam_apply`` bumps it for
    its kernel's writes), so a copy made before such a write is refreshed;
    writes through ``params.data`` escape the counter, as they escape
    autograd."""
    src, version = scratch.wb_of
    if src is not params or version != params._version:
        scratch.wb.copy_(params.detach())
        scratch.wb_of = (params, params._version)


def make_train_scratch(layout, B, params):
    """Scratch for batches of B rows on params' device; ``wb`` is filled
    from params."""
    spec = layout.spec
    n_hid = len(layout.layers)
    nblk = -(-B // BLOCK_ROWS)
    nbp = spec.hidden * n_hid + OUT_PAD
    kw = dict(device=params.device)
    return TrainScratch(
        B=B,
        wb=params.detach().to(torch.bfloat16),
        wb_of=(params, params._version),
        acts=torch.empty(n_hid * B * spec.hidden, dtype=torch.bfloat16, **kw),
        deltas=torch.empty(n_hid * B * spec.hidden + B * OUT_PAD, dtype=torch.bfloat16, **kw),
        bias_part=torch.empty(nblk * nbp, dtype=torch.float32, **kw),
        loss_part=torch.empty(nblk * 2, dtype=torch.float32, **kw),
    )


def _train_lib():
    from ._build import load

    lib = load("fused_mlp_train")
    if lib.fused_mlp_fwd_bwd.argtypes is None:
        P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.fused_mlp_fwd_bwd.argtypes = [P, I, P, I, LL, I, I, P, P, I, I, I, P, LL, I, F, P,
                                          P, P, P, P, P]
        lib.fused_mlp_wgrad.argtypes = [P, I, LL, I, I, I, I, I] + [P] * 8
        lib.fused_mlp_fwd_bwd_viewdep.argtypes = (
            [P, I, P, I, LL, I, I, P, P, I, I, I, P, I, I, P, LL, I, F, P, P, P, P, P, P])
        lib.fused_mlp_wgrad_viewdep.argtypes = [P, I, LL, I, I, I, I, I, P, I, I] + [P] * 8
        lib.fused_mlp_wgrad_adam.argtypes = [P, I, P, I, LL, I, I, I, I, I] + [P] * 13
        lib.fused_mlp_wgrad_adam_viewdep.argtypes = (
            [P, I, P, I, LL, I, I, I, I, I, P, I, I] + [P] * 13)
        lib.fused_mlp_train_prepare.argtypes = []
        for fn in (lib.fused_mlp_fwd_bwd, lib.fused_mlp_wgrad, lib.fused_mlp_fwd_bwd_viewdep,
                   lib.fused_mlp_wgrad_viewdep, lib.fused_mlp_wgrad_adam,
                   lib.fused_mlp_wgrad_adam_viewdep, lib.fused_mlp_train_prepare):
            fn.restype = I
        _check_consts(lib, (("fused_mlp_train_kc", KC), ("fused_mlp_train_out_pad", OUT_PAD),
                            ("fused_mlp_train_block_rows", BLOCK_ROWS),
                            ("fused_mlp_train_venc_max", VENC_MAX)))
    return lib


def _check_flat(layout, name, t, dev, what):
    if (t.device != dev or t.dtype != torch.float32 or t.shape != (layout.n,)
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{what}: {name} must be contiguous 16-byte aligned float32 "
                         f"[{layout.n}] on {dev} (the kernels read it in vectors)")


def _check_train_operands(layout, params, feats, target, row0, B, what, vencs=None):
    spec, tail = layout.spec, layout.tail
    _check_kernel_spec(layout, what)
    dev = params.device
    _check_flat(layout, "params", params, dev, what)
    if (feats.device != dev or feats.dtype not in (torch.bfloat16, torch.float32)
            or feats.dim() != 2 or feats.shape[1] != spec.k_in or not feats.is_contiguous()):
        raise ValueError(
            f"{what}: feats must be a contiguous bf16/f32 [N, {spec.k_in}] tensor on "
            f"{dev}, got {tuple(feats.shape)} {feats.dtype} on {feats.device}")
    if (target.device != dev or target.dtype != torch.float32
            or target.shape != (B, 3) or not target.is_contiguous()):
        raise ValueError(f"{what}: target must be contiguous float32 [{B}, 3] on {dev}")
    if B <= 0 or row0 < 0 or row0 + B > feats.shape[0]:
        raise ValueError(f"{what}: rows [{row0}, {row0 + B}) outside feats [0, {feats.shape[0]})")
    if (tail is None) != (vencs is None):
        raise ValueError(f"{what}: vencs must be given exactly when the layout has a tail")
    if vencs is not None and (
            vencs.device != dev or vencs.dtype != feats.dtype or vencs.dim() != 2
            or vencs.shape[0] != feats.shape[0]
            or vencs.shape[1] != tail.venc_w or not vencs.is_contiguous()):
        raise ValueError(
            f"{what}: vencs must be a contiguous [{feats.shape[0]}, {tail.venc_w}] "
            f"{feats.dtype} tensor on {dev} (the feature table's rows and dtype, lanes "
            f"past {tail.venc_in} zero), got {tuple(vencs.shape)} {vencs.dtype} on "
            f"{vencs.device}")


def _venc_args(layout, vencs):
    """The tail's C arguments: (venc pointer, venc_in, venc_w = its row stride)."""
    t = layout.tail
    return (vencs.data_ptr(), t.venc_in, t.venc_w)


def check_epoch_operands(layout, params, m, v, feats, targets, B, num_batches, vencs=None):
    """The operands of an epoch of ``fused_train_adam_step`` on the card,
    checked once: the flat buffers, the tables (targets: the whole [N, 3]
    ground truth beside the [N, k_in] feature table) and the blocks."""
    what = "train epoch"
    _check_train_operands(layout, params, feats, targets[:B], 0, B, what, vencs)
    for name, t in (("m", m), ("v", v)):
        _check_flat(layout, name, t, params.device, what)
    if (targets.dtype != torch.float32 or targets.shape != (feats.shape[0], 3)
            or not targets.is_contiguous()):
        raise ValueError(f"{what}: targets must be contiguous float32 [{feats.shape[0]}, 3]")
    if num_batches * B > feats.shape[0]:
        raise ValueError(f"{what}: {num_batches} blocks of {B} rows outside feats "
                         f"[0, {feats.shape[0]})")


def _launch_fwd_bwd(layout, params, feats, row0, B, target, mode, inv_n, scratch, vencs=None,
                    order=None, step=0, target_row0=None):
    """One launch of csrc/fused_mlp_train.cu:fused_mlp_fwd_bwd[_viewdep]: the
    batch at row0, or with order (int32 block ids on the device) at
    order[step] * B. target: f32 rows of 3 whose first row belongs to row
    target_row0 of feats (None: row0, target is the batch's [B, 3])."""
    spec = layout.spec
    lib = _train_lib()
    head = (feats.data_ptr(), int(feats.dtype == torch.bfloat16),
            None if order is None else order.data_ptr(), step, row0, B, spec.k_in,
            params.data_ptr(), scratch.wb.data_ptr(), spec.k_w, spec.num_layers, spec.skip_idx)
    rest = (target.data_ptr(), row0 if target_row0 is None else target_row0, mode, inv_n,
            scratch.acts.data_ptr(), scratch.deltas.data_ptr(), scratch.bias_part.data_ptr(),
            scratch.loss_part.data_ptr(), _FB_LAUNCHED, _stream(params))
    if layout.tail is None:
        name, rc = "fused_mlp_fwd_bwd", lib.fused_mlp_fwd_bwd(*head, *rest)
    else:
        name = "fused_mlp_fwd_bwd_viewdep"
        rc = lib.fused_mlp_fwd_bwd_viewdep(*head, *_venc_args(layout, vencs), *rest)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    _launches[name] += 1


# The shape of the last fwd_bwd launch, written by the C entry point.
_FB_LAUNCHED = (ctypes.c_int * 5)()


def last_fwd_bwd_launch():
    """The shape the last fwd_bwd launch (either field) ran with: {"ctas",
    "cluster", "threads", "smem_bytes", "x_resident"}."""
    return dict(zip(("ctas", "cluster", "threads", "smem_bytes", "x_resident"), _FB_LAUNCHED))


def _launch_wgrad(layout, feats, row0, B, scratch, grads, sums, vencs=None):
    """One launch of csrc/fused_mlp_train.cu:fused_mlp_wgrad[_viewdep]."""
    spec = layout.spec
    lib = _train_lib()
    head = (feats.data_ptr(), int(feats.dtype == torch.bfloat16), row0, B, spec.k_in,
            spec.k_w, spec.num_layers, spec.skip_idx)
    rest = (scratch.acts.data_ptr(), scratch.deltas.data_ptr(), scratch.bias_part.data_ptr(),
            scratch.loss_part.data_ptr(), grads.data_ptr(), sums.data_ptr(), _WG_LAUNCHED,
            _stream(grads))
    if layout.tail is None:
        name, rc = "fused_mlp_wgrad", lib.fused_mlp_wgrad(*head, *rest)
    else:
        name = "fused_mlp_wgrad_viewdep"
        rc = lib.fused_mlp_wgrad_viewdep(*head, *_venc_args(layout, vencs), *rest)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    _launches[name] += 1


def _launch_wgrad_adam(layout, feats, row0, B, scratch, params, m, v, hyper, sums, acc=None,
                       vencs=None, order=None, step=0):
    """One launch of csrc/fused_mlp_train.cu:fused_mlp_wgrad_adam[_viewdep]:
    Adam in place on params, m, v from the batch's gradients, the bf16 copy
    into scratch.wb, the loss sums into sums [2] (and acc [2], if given).
    The batch at row0, or with order at order[step] * B; hyper: the [*, 128]
    hyper rows, of which row `step` is read."""
    spec = layout.spec
    lib = _train_lib()
    head = (feats.data_ptr(), int(feats.dtype == torch.bfloat16),
            None if order is None else order.data_ptr(), step, row0, B, spec.k_in, spec.k_w,
            spec.num_layers, spec.skip_idx)
    rest = (scratch.acts.data_ptr(), scratch.deltas.data_ptr(), scratch.bias_part.data_ptr(),
            scratch.loss_part.data_ptr(), params.data_ptr(), m.data_ptr(), v.data_ptr(),
            scratch.wb.data_ptr(), hyper.data_ptr(), sums.data_ptr(),
            None if acc is None else acc.data_ptr(), _WG_LAUNCHED, _stream(params))
    if layout.tail is None:
        name, rc = "fused_mlp_wgrad_adam", lib.fused_mlp_wgrad_adam(*head, *rest)
    else:
        name = "fused_mlp_wgrad_adam_viewdep"
        rc = lib.fused_mlp_wgrad_adam_viewdep(*head, *_venc_args(layout, vencs), *rest)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    _launches[name] += 1


def prepare_train_kernels():
    """Load the train kernels and raise their shared-memory ceilings, so no
    later launch makes a CUDA call besides the launch itself (call before
    capturing launches into a CUDA graph)."""
    rc = _train_lib().fused_mlp_train_prepare()
    if rc != 0:
        raise RuntimeError(f"fused_mlp_train_prepare failed: cudaError {rc}")


# The shape of the last wgrad launch, written by the C entry point.
_WG_LAUNCHED = (ctypes.c_int * 5)()


def last_wgrad_launch():
    """The shape the last wgrad launch (either field) ran with: {"ctas",
    "cluster", "threads", "smem_bytes", "tiles"} (128-row gradient tiles;
    a cluster per tile)."""
    return dict(zip(("ctas", "cluster", "threads", "smem_bytes", "tiles"), _WG_LAUNCHED))


def _train_kernels(layout, params, feats, row0, B, target, mode, scratch, grads, vencs=None):
    """fwd_bwd + wgrad on scratch (None: a new one); its bf16 weight copy is
    made to match params first."""
    if scratch is None:
        scratch = make_train_scratch(layout, B, params)
    elif scratch.B != B:
        raise ValueError(f"scratch was made for B={scratch.B}, not {B}")
    else:
        _sync_wb(scratch, params)
    sums = torch.empty(2, dtype=torch.float32, device=params.device)
    inv_n = 1.0 / (B * 3)
    _launch_fwd_bwd(layout, params, feats, row0, B, target, mode, inv_n, scratch, vencs)
    _launch_wgrad(layout, feats, row0, B, scratch, grads, sums, vencs)
    return sums


def fused_train_grads(layout, params, feats, gt, block=0, batch_size=None,
                      loss_type="L1", scratch=None, vencs=None):
    """Gradients of the mean loss over one batch, plus the loss and
    squared-error SUMS over its B*3 elements.

    feats: a [N, k_in] bf16/f32 hit-feature table, of which the batch is
    rows [block*B, (block+1)*B) (the streaming path: the offset is given in
    batch units, so a misaligned row cannot be expressed), or a gathered
    [B, k_in] batch (block 0). vencs (layouts with a tail only): the
    [N, venc_w] encoded view directions of the same rows (lanes past
    venc_in zero), same dtype, read at the same offset. gt: [B, 3] f32. Returns (grads
    [layout.n] f32, loss_sum, sq_sum) with 0-dim sums.
    CPU: the plain twin. CUDA: fwd_bwd + wgrad kernels, or an error."""
    B = feats.shape[0] if batch_size is None else int(batch_size)
    row0 = int(block) * B
    if params.device.type == "cpu":
        if (layout.tail is None) != (vencs is None):
            raise ValueError("fused_train_grads: vencs must be given exactly when the "
                             "layout has a tail")
        if vencs is not None and (vencs.dim() != 2 or vencs.shape[1] != layout.tail.venc_w):
            raise ValueError(f"fused_train_grads: vencs must be [N, {layout.tail.venc_w}], "
                             f"got {tuple(vencs.shape)}")
        venc = None if vencs is None else vencs[row0:row0 + B]
        return train_grads_plain(layout, params, feats[row0:row0 + B], gt, loss_type, venc)
    if loss_type not in LOSS_MODES:
        raise ValueError(f"unknown loss_type {loss_type!r}")
    _check_train_operands(layout, params, feats, gt, row0, B, "fused_train_grads", vencs)
    grads = torch.empty(layout.n, dtype=torch.float32, device=params.device)
    sums = _train_kernels(layout, params, feats, row0, B, gt, LOSS_MODES[loss_type],
                          scratch, grads, vencs)
    return grads, sums[0], sums[1]


# --------------------------------------------------------------------- Adam

def adam_hyper_rows(counts, learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                    device=None):
    """[T, 128] f32 hyper rows, one per step: (lr, 1/(1-b1^t), 1/(1-b2^t),
    b1, b2, eps, eps_root) in lanes 0..6 for the 1-based step counts t.
    Computed in f32 like optax under inject_hyperparams (its betas are f32)."""
    t = torch.as_tensor(counts, device=device).to(torch.float32)[:, None]
    # constants filled on the device (no host-to-device copy each)
    f32 = lambda v: torch.full((), float(v), dtype=torch.float32, device=t.device)  # noqa: E731
    c1 = 1.0 / (1.0 - torch.pow(f32(b1), t))
    c2 = 1.0 / (1.0 - torch.pow(f32(b2), t))
    cols = [f32(learning_rate).expand_as(t), c1, c2] + [
        f32(v).expand_as(t) for v in (b1, b2, eps, eps_root)]
    return torch.cat(cols + [torch.zeros(t.shape[0], 121, device=t.device)], dim=1)


def adam_apply_plain(params, m, v, hyper, grads):
    """Plain twin of the Adam kernel: returns new (params, m, v). optax's
    expression order: m=(1-b1)g+b1*m, v=(1-b2)g^2+b2*v,
    upd=(lr*(m*c1))/(sqrt(v*c2+eps_root)+eps), every step rounded in f32."""
    h = hyper.reshape(-1)
    lr, c1, c2, b1, b2, eps, eps_root = (h[i] for i in range(7))
    m_new = (1.0 - b1) * grads + b1 * m
    v_new = (1.0 - b2) * (grads * grads) + b2 * v
    upd = (lr * (m_new * c1)) / (torch.sqrt(v_new * c2 + eps_root) + eps)
    return params - upd, m_new, v_new


def _adam_fn():
    from ._build import load

    fn = load("fused_adam").fused_adam
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@torch.no_grad()
def fused_adam_apply(params, m, v, hyper, grads, wb=None):
    """The Adam update over the flat buffers, IN PLACE on params, m and v
    (the port updates in place where the reference donated its buffers).
    hyper: one [128] (or [1, 128]) row of ``adam_hyper_rows``. wb: a bf16
    buffer like params that receives the new params rounded to bf16 (the
    train kernels' weight copy), or None.
    CPU: the plain twin. CUDA: csrc/fused_adam.cu, or an error."""
    if params.device.type == "cpu":
        for dst, src in zip((params, m, v), adam_apply_plain(params, m, v, hyper, grads)):
            dst.copy_(src)
        if wb is not None:
            wb.copy_(params)
        return
    n = params.numel()
    if wb is not None and (wb.device != params.device or wb.dtype != torch.bfloat16
                           or wb.numel() != n or not wb.is_contiguous() or wb.data_ptr() % 8):
        raise ValueError(f"fused_adam_apply: wb must be contiguous 8-byte aligned bfloat16 "
                         f"[{n}] on {params.device}")
    for name, t in (("params", params), ("m", m), ("v", v), ("grads", grads)):
        if (t.device != params.device or t.dtype != torch.float32 or t.numel() != n
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"fused_adam_apply: {name} must be contiguous 16-byte aligned "
                             f"float32 [{n}] on {params.device} (the kernel reads float4s)")
    if (hyper.device != params.device or hyper.dtype != torch.float32
            or hyper.numel() != 128 or not hyper.is_contiguous()):
        raise ValueError("fused_adam_apply: hyper must be one contiguous float32 [128] row")
    rc = _adam_fn()(params.data_ptr(), m.data_ptr(), v.data_ptr(), grads.data_ptr(),
                    hyper.data_ptr(), n, None if wb is None else wb.data_ptr(), _stream(params))
    if rc != 0:
        raise RuntimeError(f"fused_adam launch failed: cudaError {rc}")
    _launches["fused_adam"] += 1
    for t in (params, m, v) if wb is None else (params, m, v, wb):
        increment_version(t)  # the kernel wrote them in place


def _step_plain(layout, params, m, v, hyper, feats, gt, row0, B, loss_type, scratch, acc,
                vencs):
    """The plain twin of a train step on rows [row0, row0 + B): fwd_bwd's
    twin, then ``wgrad_adam_plain``. Returns (loss_sum, sq_sum)."""
    venc = None if vencs is None else vencs[row0:row0 + B]
    x = feats[row0:row0 + B]
    acts, deltas, bias_sums, loss_sum, sq_sum = _fwd_bwd(layout, params, x, venc, gt, loss_type)
    wgrad_adam_plain(layout, x, acts, deltas, bias_sums, (loss_sum, sq_sum), params, m, v,
                     hyper, scratch.wb, acc, venc)
    scratch.wb_of = (params, params._version)
    return loss_sum, sq_sum


def fused_train_adam(layout, params, m, v, hyper, feats, gt, block, batch_size,
                     loss_type="L1", scratch=None, vencs=None):
    """One training step on the streamed batch (rows [block*B, (block+1)*B)
    of feats, ground truth gt [B, 3]): the gradients of
    ``fused_train_grads``, then the Adam update in place on params, m, v
    (hyper: one [128] row). Returns (loss_sum, sq_sum), 0-dim. The operands
    are checked, then it is one ``fused_train_adam_step`` (order [block],
    step 0, gt the targets of the block's rows): on the card fwd_bwd, then
    wgrad with Adam in its epilogue, the new params' bf16 copy left in the
    scratch's ``wb`` for the next step. CPU: the plain twins."""
    B = int(batch_size)
    row0 = int(block) * B
    dev = params.device
    what = "fused_train_adam"
    if (layout.tail is None) != (vencs is None):
        raise ValueError(f"{what}: vencs must be given exactly when the layout has a tail")
    if dev.type != "cpu":
        if loss_type not in LOSS_MODES:
            raise ValueError(f"unknown loss_type {loss_type!r}")
        _check_train_operands(layout, params, feats, gt, row0, B, what, vencs)
        for name, t in (("m", m), ("v", v)):
            _check_flat(layout, name, t, dev, what)
        if (hyper.device != dev or hyper.dtype != torch.float32 or hyper.numel() != 128
                or not hyper.is_contiguous()):
            raise ValueError(f"{what}: hyper must be one contiguous float32 [128] row")
    if scratch is None:
        scratch = make_train_scratch(layout, B, params)
    elif scratch.B != B:
        raise ValueError(f"scratch was made for B={scratch.B}, not {B}")
    else:
        _sync_wb(scratch, params)
    sums = torch.empty(2, dtype=torch.float32, device=dev)
    order = torch.full((1,), int(block), dtype=torch.int32, device=dev)
    fused_train_adam_step(layout, params, m, v, hyper.reshape(1, 128), order, 0, feats, gt, B,
                          loss_type, scratch, sums, None, vencs, targets_row0=row0)
    return sums[0], sums[1]


def fused_train_adam_step(layout, params, m, v, hyper_all, order, i, feats, targets, B,
                          loss_type, scratch, sums, acc, vencs=None, targets_row0=0):
    """Step i of an epoch of train steps with Adam, its batch found where
    the TPU kernel finds it: rows [order[i] * B, +B) of feats (and vencs),
    their ground truth at the same rows of targets (f32 rows of 3, the
    first of them row targets_row0: the whole [N, 3] table by default),
    hyper row hyper_all[i]. params, m, v updated in place, scratch.wb
    rewritten (and ``wb_of`` set), the loss sums into sums [2] and, when acc
    [2] is given, acc[0] += loss_sum / 3, acc[1] += sq_sum.

    Unchecked: the caller checks its operands (``check_epoch_operands``)
    and makes scratch.wb current. CPU: the plain twins, order a CPU int
    tensor. CUDA: fwd_bwd and wgrad with Adam, two launches whose arguments
    hold pointers and i only (order: int32 on the device), so an epoch of
    them can be captured and replayed."""
    if params.device.type == "cpu":
        row0 = int(order[i]) * B
        t0 = row0 - targets_row0
        loss_sum, sq_sum = _step_plain(layout, params, m, v, hyper_all[i], feats,
                                       targets[t0:t0 + B], row0, B, loss_type, scratch, acc,
                                       vencs)
        sums.copy_(torch.stack((loss_sum, sq_sum)))
        return
    _launch_fwd_bwd(layout, params, feats, 0, B, targets, LOSS_MODES[loss_type], 1.0 / (B * 3),
                    scratch, vencs, order, i, targets_row0)
    _launch_wgrad_adam(layout, feats, 0, B, scratch, params, m, v, hyper_all, sums, acc, vencs,
                       order, i)
    for t in (params, m, v, scratch.wb):
        increment_version(t)  # the kernels wrote them in place
    scratch.wb_of = (params, params._version)


# ------------------------------------------------------ forward with a VJP

class _FusedApply(torch.autograd.Function):
    """fused_apply with a backward: weight and bias grads from the output
    cotangent (the forward is recomputed, as the reference's backward
    kernel does); no input gradient."""

    @staticmethod
    def forward(ctx, params, x, layout):
        ctx.layout = layout
        ctx.save_for_backward(params, x)
        return fused_apply(layout.pack(params), x)

    @staticmethod
    def backward(ctx, g):
        params, x = ctx.saved_tensors
        layout = ctx.layout
        g = g.to(torch.float32).contiguous()
        if params.device.type == "cpu":
            return apply_vjp_plain(layout, params, x, g), None, None
        _check_train_operands(layout, params, x, g, 0, x.shape[0], "fused_apply backward")
        grads = torch.empty(layout.n, dtype=torch.float32, device=params.device)
        _train_kernels(layout, params.detach(), x, 0, x.shape[0], g, COTANGENT_MODE,
                       None, grads)
        return grads, None, None


def fused_apply_trainable(layout, params, x):
    """[B, k_in] f32 -> [B, 3] through the forward kernel, differentiable in
    the flat params (``params.requires_grad``); plain layouts only (the
    view-dependent forward has no VJP in the reference either)."""
    if layout.tail is not None:
        raise ValueError("fused_apply_trainable: the view-dependent forward has no VJP")
    return _FusedApply.apply(params, x, layout)
