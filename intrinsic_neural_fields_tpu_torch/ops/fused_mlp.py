"""Fused skip-MLP of the texture field: CUDA kernels + plain twins.

Inference: ``fused_apply(weights, x)`` runs the whole network (relu hidden
layers, one input re-injection, sigmoid RGB head) on a [B, k_in] f32
feature batch.

Training (flat f32 parameters in the kernels' padded layout, ``ParamLayout``):
  - ``fused_train_grads``: forward, L1/L2/cauchy loss sums and the weight
    and bias gradients of the mean loss over one batch;
  - ``fused_adam_apply``: the optax Adam update, in place on params, m, v;
  - ``fused_train_adam``: the two composed, one training step;
  - ``fused_apply_trainable``: the forward as a ``torch.autograd.Function``
    whose backward runs the train kernels seeded by the output cotangent.

On a CUDA tensor every wrapper launches its hand-written sm_90a kernels
(``csrc/fused_mlp_fwd.cu``, ``csrc/fused_mlp_train.cu``,
``csrc/fused_adam.cu``) or raises; on a CPU tensor it runs the plain torch
twin beside it (the same arithmetic: bf16-rounded matmul operands, f32
products and sums). Each kernel's Python launcher counts its launches.

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

KC = 64         # K-chunk of the kernels (input rows are padded to it)
OUT_PAD = 16    # padded head width of the kernels
KERNEL_HIDDEN = 128
BLOCK_ROWS = 64  # batch rows per block of the train kernels
WGRAD_SPLIT = 8  # wgrad blocks sharing one gradient tile's batch
LOSS_MODES = {"L1": 0, "L2": 1, "cauchy": 2}
COTANGENT_MODE = 3
CAUCHY_C2 = (20.0 / 255.0) ** 2


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


def spec_for_model(model):
    return FusedMLPSpec(num_layers=model.num_layers, k_in=model.in_dim,
                        hidden=model.hidden_dim, skip_idx=model.skip_layer_idx,
                        out_dim=model.out_dim)


class _Entry(NamedTuple):
    prefix: str
    role: str
    w_off: int    # offset of the [rows_pad, cols_pad] matrix in the flat buffer
    rows_pad: int
    cols_pad: int
    rows: int     # real rows (input dim)
    cols: int     # real cols (output dim)
    b_off: int    # offset of the bias (cols_pad long) in the flat buffer


class ParamLayout:
    """The flat f32 parameter layout of the train kernels.

    Matrices come first, in ``weight_names`` order, each [in_pad, out_pad]
    row-major (the transpose of torch's Linear weight): the input and skip-x
    matrices zero-padded to ``k_w`` rows, the head to 16 columns. The
    biases follow in the same order (the head's padded to 16). The forward
    kernel's packed operands are the bf16 cast of the matrix region and the
    bias region as it is. Pads are zero, get zero gradients and stay zero
    under Adam."""

    def __init__(self, spec):
        self.spec = spec
        h, kw = spec.hidden, spec.k_w
        shapes = []
        for prefix, role in spec.weight_names():
            rows, rows_pad = (spec.k_in, kw) if role in ("input", "skip_x") else (h, h)
            cols, cols_pad = (spec.out_dim, OUT_PAD) if role == "out" else (h, h)
            shapes.append((prefix, role, rows_pad, cols_pad, rows, cols))
        self.n_w = sum(r * c for _, _, r, c, _, _ in shapes)
        entries, wo, bo = [], 0, self.n_w
        for prefix, role, rows_pad, cols_pad, rows, cols in shapes:
            entries.append(_Entry(prefix, role, wo, rows_pad, cols_pad, rows, cols, bo))
            wo += rows_pad * cols_pad
            bo += cols_pad
        self.entries = entries
        self.n = bo

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
            W[:e.rows, :e.cols] = state_dict[e.prefix + ".weight"].detach().t().to(
                device=device, dtype=torch.float32)
            b[:e.cols] = state_dict[e.prefix + ".bias"].detach().to(
                device=device, dtype=torch.float32)
        return flat

    @torch.no_grad()
    def state_dict(self, flat, device=None):
        """Flat buffer -> torch-layout state dict of contiguous copies."""
        sd = {}
        for e, W, b in zip(self.entries, self.mats(flat), self.biases(flat)):
            sd[e.prefix + ".weight"] = W[:e.rows, :e.cols].t().contiguous().to(device)
            sd[e.prefix + ".bias"] = b[:e.cols].clone().to(device)
        return sd

    def pack(self, flat):
        """FusedWeights for the forward kernel: bf16 matrices, f32 biases."""
        w = flat[:self.n_w].detach().to(torch.bfloat16)
        b = flat[self.n_w:].detach().clone()
        mats = [w[e.w_off:e.w_off + e.rows_pad * e.cols_pad].view(e.rows_pad, e.cols_pad)
                for e in self.entries]
        biases = [b[e.b_off - self.n_w:e.b_off - self.n_w + e.cols_pad] for e in self.entries]
        return FusedWeights(self.spec, w, b, mats, biases)


class FusedWeights(NamedTuple):
    spec: FusedMLPSpec
    w: torch.Tensor        # packed bf16 matrices (kernel operand)
    b: torch.Tensor        # packed f32 biases (kernel operand)
    mats: list             # views of w: [in_padded, out_padded] bf16
    biases: list           # views of b


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


def fused_apply_plain(fw, x):
    """Plain torch twin of the kernel (any device): [B, k_in] f32 -> [B, 3]."""
    spec = fw.spec
    xb = _bf16(x.to(torch.float32))
    mats = [m.to(torch.float32) for m in fw.mats]
    it = iter(zip(spec.weight_names(), mats, fw.biases))
    h = xb
    for i in range(spec.num_layers - 1):
        (_, role), W, b = next(it)
        if i == spec.skip_idx:
            _, Wx, bx = next(it)
            # one [h | x] . [Wh ; Wx] contraction, as the reference kernel
            hx = torch.cat([_bf16(h), xb], dim=1)
            Wcat = torch.cat([W, Wx[:spec.k_in]], dim=0)
            h = torch.relu(hx @ Wcat + b + bx)
        else:
            if role == "input":
                W = W[:spec.k_in]
            h = torch.relu(_bf16(h) @ W + b)
    _, Wo, bo = next(it)
    z = _bf16(h) @ Wo + bo
    return torch.sigmoid(z)[:, :spec.out_dim]


def _check_kernel_spec(spec, what):
    if spec.hidden != KERNEL_HIDDEN or spec.out_dim != 3:
        raise ValueError(
            f"{what}: the kernels take hidden={KERNEL_HIDDEN}, out_dim=3; got "
            f"hidden={spec.hidden}, out_dim={spec.out_dim}"
        )


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd_kernel():
    from ._build import load

    lib = load("fused_mlp_fwd")
    fn = lib.fused_mlp_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for const, want in (("fused_mlp_fwd_kc", KC), ("fused_mlp_fwd_out_pad", OUT_PAD)):
            getattr(lib, const).restype = ctypes.c_int
            if getattr(lib, const)() != want:
                raise RuntimeError(f"{const} disagrees with the Python packing")
    return fn


def fused_apply(fw, x):
    """[B, k_in] f32 features -> [B, 3] f32 RGB through the fused MLP.

    CPU tensor: the plain twin. CUDA tensor: the sm_90a kernel on the
    current stream, or an error — never a fallback."""
    if x.device.type == "cpu":
        return fused_apply_plain(fw, x)
    if x.device.type != "cuda":
        raise ValueError(f"fused_apply: unsupported device {x.device}")
    spec = fw.spec
    _check_kernel_spec(spec, "fused_apply")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != spec.k_in:
        raise ValueError(
            f"fused_apply: x must be [B, {spec.k_in}] float32, got "
            f"{tuple(x.shape)} {x.dtype}"
        )
    if not x.is_contiguous():
        raise ValueError("fused_apply: x must be contiguous")
    for name, t, dt in (("w", fw.w, torch.bfloat16), ("b", fw.b, torch.float32)):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"fused_apply: packed {name} must be contiguous {dt} on {x.device}")
    B = x.shape[0]
    out = torch.empty((B, spec.out_dim), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    fn = _fwd_kernel()
    rc = fn(x.data_ptr(), fw.w.data_ptr(), fw.b.data_ptr(), out.data_ptr(),
            B, spec.k_in, spec.k_w, spec.num_layers, spec.skip_idx, _stream(x))
    if rc != 0:
        raise RuntimeError(f"fused_mlp_fwd launch failed: cudaError {rc}")
    fused_apply.launches += 1
    return out


fused_apply.launches = 0  # kernel launches since the last reset


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


def fwd_bwd_plain(layout, params, x, target, loss_type):
    """Plain twin of the fwd_bwd kernel. x: [B, >=k_in] rows (bf16 or f32);
    target: [B, 3] ground truth, or the output cotangent when loss_type is
    None. Returns what the kernel leaves for wgrad, in its scratch layout:
    (acts [(L-1)*B*H] bf16 post-relu activations, deltas [(L-1)*B*H + B*16]
    bf16 deltas of every layer then the head, bias_sums [H*(L-1)+16] f32
    column sums of the f32 deltas, loss_sum, sq_sum)."""
    spec = layout.spec
    L, skip, k = spec.num_layers, spec.skip_idx, spec.k_in
    B = x.shape[0]
    xb = _bf16(x[:, :k].to(torch.float32))
    mats = [_bf16(m) for m in layout.mats(params.detach())]
    biases = layout.biases(params.detach())
    acts, hmats, j, h = [], [], 0, xb
    for i in range(L - 1):
        if i == skip:
            pre = torch.cat([h, xb], 1) @ torch.cat([mats[j], mats[j + 1][:k]], 0)
            h = _bf16(torch.relu(pre + biases[j] + biases[j + 1]))
            hmats.append(mats[j])
            j += 2
        else:
            W = mats[j][:k] if i == 0 else mats[j]
            h = _bf16(torch.relu(h @ W + biases[j]))
            hmats.append(mats[j])
            j += 1
        acts.append(h)
    z = h @ mats[j] + biases[j]
    p = torch.sigmoid(z[:, :spec.out_dim])
    target = target.to(torch.float32)
    if loss_type is None:
        loss_sum = sq_sum = None
        g = target
    else:
        loss, sq, g = _loss_and_grad(loss_type, p, target, 1.0 / (B * spec.out_dim))
        loss_sum, sq_sum = loss.sum(), sq.sum()
    d = torch.nn.functional.pad(g * p * (1.0 - p), (0, OUT_PAD - spec.out_dim))
    deltas, sums = [None] * (L - 1), [None] * (L - 1)
    dout, dsum = _bf16(d), d.sum(0)
    dh = dout @ mats[j].t()
    for i in range(L - 2, -1, -1):
        dl = dh * (acts[i] > 0)
        deltas[i], sums[i] = _bf16(dl), dl.sum(0)
        if i > 0:
            dh = deltas[i] @ hmats[i].t()
    to_bf16 = lambda ts: torch.cat([t.reshape(-1) for t in ts]).to(torch.bfloat16)  # noqa: E731
    return (to_bf16(acts), to_bf16(deltas + [dout]), torch.cat(sums + [dsum]),
            loss_sum, sq_sum)


def wgrad_plain(layout, x, acts, deltas, bias_sums):
    """Plain twin of the wgrad kernel on fwd_bwd's outputs (either twin's):
    the flat gradient, dW = A^T . D over the batch, biases from bias_sums."""
    spec = layout.spec
    L, skip, k, H = spec.num_layers, spec.skip_idx, spec.k_in, spec.hidden
    B = x.shape[0]
    xb = _bf16(x[:, :k].to(torch.float32))
    A = acts.to(torch.float32).view(L - 1, B, H)
    D = deltas[:(L - 1) * B * H].to(torch.float32).view(L - 1, B, H)
    Dout = deltas[(L - 1) * B * H:].to(torch.float32).view(B, OUT_PAD)
    grads = torch.zeros(layout.n, dtype=torch.float32, device=acts.device)
    gm, gb = layout.mats(grads), layout.biases(grads)
    j = 0
    for i in range(L - 1):
        a_in = xb if i == 0 else A[i - 1]
        gm[j][:a_in.shape[1]] = a_in.t() @ D[i]
        gb[j][:] = bias_sums[H * i:H * (i + 1)]
        j += 1
        if i == skip:
            gm[j][:k] = xb.t() @ D[i]
            gb[j][:] = bias_sums[H * i:H * (i + 1)]
            j += 1
    gm[j][:] = A[L - 2].t() @ Dout
    gb[j][:] = bias_sums[H * (L - 1):]
    return grads


def train_grads_plain(layout, params, x, gt, loss_type="L1"):
    """Plain twin of ``fused_train_grads`` on a gathered [B, k_in] batch:
    fwd_bwd_plain then wgrad_plain, (flat grads, loss_sum, sq_sum)."""
    acts, deltas, bias_sums, loss_sum, sq_sum = fwd_bwd_plain(layout, params, x, gt, loss_type)
    return wgrad_plain(layout, x, acts, deltas, bias_sums), loss_sum, sq_sum


def apply_vjp_plain(layout, params, x, g):
    """Plain twin of the forward's VJP: flat weight/bias grads of
    sum(g * fused_apply(x)); no input gradient."""
    return train_grads_plain(layout, params, x, g, None)[0]


class TrainScratch(NamedTuple):
    """Per-batch-size device scratch of the train kernels (allocate once
    per epoch): bf16 activations and deltas, per-block bias and loss
    partial sums, the flat gradient, wgrad's partial tiles and its
    per-tile arrival counters (zero between launches)."""
    B: int
    acts: torch.Tensor
    deltas: torch.Tensor
    bias_part: torch.Tensor
    loss_part: torch.Tensor
    grads: torch.Tensor
    wpart: torch.Tensor
    counters: torch.Tensor


def make_train_scratch(layout, B, device):
    spec = layout.spec
    n_hid = spec.num_layers - 1
    nblk = -(-B // BLOCK_ROWS)
    nbp = spec.hidden * n_hid + OUT_PAD
    kw = dict(device=device)
    return TrainScratch(
        B=B,
        acts=torch.empty(n_hid * B * spec.hidden, dtype=torch.bfloat16, **kw),
        deltas=torch.empty(n_hid * B * spec.hidden + B * OUT_PAD, dtype=torch.bfloat16, **kw),
        bias_part=torch.empty(nblk * nbp, dtype=torch.float32, **kw),
        loss_part=torch.empty(nblk * 2, dtype=torch.float32, **kw),
        grads=torch.empty(layout.n, dtype=torch.float32, **kw),
        wpart=torch.empty(WGRAD_SPLIT * layout.n_w, dtype=torch.float32, **kw),
        counters=torch.zeros(layout.n_w // (BLOCK_ROWS * OUT_PAD), dtype=torch.int32, **kw),
    )


def _train_lib():
    from ._build import load

    lib = load("fused_mlp_train")
    if lib.fused_mlp_fwd_bwd.argtypes is None:
        P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.fused_mlp_fwd_bwd.argtypes = [P, I, LL, I, I, P, I, I, I, P, I, F, P, P, P, P, P]
        lib.fused_mlp_wgrad.argtypes = [P, I, LL, I, I, I, I, I, P, P, P, P, P, P, P, P, P]
        lib.fused_mlp_fwd_bwd.restype = lib.fused_mlp_wgrad.restype = I
        for const, want in (("fused_mlp_train_kc", KC), ("fused_mlp_train_out_pad", OUT_PAD),
                            ("fused_mlp_train_block_rows", BLOCK_ROWS),
                            ("fused_mlp_train_nsplit", WGRAD_SPLIT)):
            getattr(lib, const).restype = I
            if getattr(lib, const)() != want:
                raise RuntimeError(f"{const} disagrees with the Python layout")
    return lib


def _check_train_operands(layout, params, feats, target, row0, B, what):
    spec = layout.spec
    _check_kernel_spec(spec, what)
    dev = params.device
    if (params.dtype != torch.float32 or params.shape != (layout.n,)
            or not params.is_contiguous() or params.data_ptr() % 16):
        raise ValueError(f"{what}: params must be contiguous 16-byte aligned float32 "
                         f"[{layout.n}] (the kernels read it in float4 vectors)")
    if (feats.device != dev or feats.dtype not in (torch.bfloat16, torch.float32)
            or feats.dim() != 2 or feats.shape[1] != spec.k_in or not feats.is_contiguous()):
        raise ValueError(
            f"{what}: feats must be a contiguous bf16/f32 [N, {spec.k_in}] tensor on "
            f"{dev}, got {tuple(feats.shape)} {feats.dtype} on {feats.device}")
    if (target.device != dev or target.dtype != torch.float32
            or target.shape != (B, spec.out_dim) or not target.is_contiguous()):
        raise ValueError(f"{what}: target must be contiguous float32 [{B}, 3] on {dev}")
    if B <= 0 or row0 < 0 or row0 + B > feats.shape[0]:
        raise ValueError(f"{what}: rows [{row0}, {row0 + B}) outside feats [0, {feats.shape[0]})")


def _launch_fwd_bwd(layout, params, feats, row0, B, target, mode, inv_n, scratch):
    """One launch of csrc/fused_mlp_train.cu:fused_mlp_fwd_bwd."""
    spec = layout.spec
    lib = _train_lib()
    rc = lib.fused_mlp_fwd_bwd(
        feats.data_ptr(), int(feats.dtype == torch.bfloat16), row0, B, spec.k_in,
        params.data_ptr(), spec.k_w, spec.num_layers, spec.skip_idx,
        target.data_ptr(), mode, inv_n, scratch.acts.data_ptr(), scratch.deltas.data_ptr(),
        scratch.bias_part.data_ptr(), scratch.loss_part.data_ptr(), _stream(params))
    if rc != 0:
        raise RuntimeError(f"fused_mlp_fwd_bwd launch failed: cudaError {rc}")
    _launch_fwd_bwd.launches += 1


def _launch_wgrad(layout, feats, row0, B, scratch, grads, sums):
    """One launch of csrc/fused_mlp_train.cu:fused_mlp_wgrad."""
    spec = layout.spec
    lib = _train_lib()
    rc = lib.fused_mlp_wgrad(
        feats.data_ptr(), int(feats.dtype == torch.bfloat16), row0, B, spec.k_in,
        spec.k_w, spec.num_layers, spec.skip_idx, scratch.acts.data_ptr(),
        scratch.deltas.data_ptr(), scratch.bias_part.data_ptr(),
        scratch.loss_part.data_ptr(), grads.data_ptr(), sums.data_ptr(),
        scratch.wpart.data_ptr(), scratch.counters.data_ptr(), _stream(grads))
    if rc != 0:
        raise RuntimeError(f"fused_mlp_wgrad launch failed: cudaError {rc}")
    _launch_wgrad.launches += 1


_launch_fwd_bwd.launches = 0
_launch_wgrad.launches = 0


def _train_kernels(layout, params, feats, row0, B, target, mode, scratch, grads):
    if scratch is None:
        scratch = make_train_scratch(layout, B, params.device)
    elif scratch.B != B:
        raise ValueError(f"scratch was made for B={scratch.B}, not {B}")
    sums = torch.empty(2, dtype=torch.float32, device=params.device)
    inv_n = 1.0 / (B * layout.spec.out_dim)
    _launch_fwd_bwd(layout, params, feats, row0, B, target, mode, inv_n, scratch)
    _launch_wgrad(layout, feats, row0, B, scratch, grads, sums)
    return sums


def fused_train_grads(layout, params, feats, gt, block=0, batch_size=None,
                      loss_type="L1", scratch=None):
    """Gradients of the mean loss over one batch, plus the loss and
    squared-error SUMS over its B*3 elements.

    feats: a [N, k_in] bf16/f32 hit-feature table, of which the batch is
    rows [block*B, (block+1)*B) (the streaming path: the offset is given in
    batch units, so a misaligned row cannot be expressed), or a gathered
    [B, k_in] batch (block 0). gt: [B, 3] f32. Returns (grads [layout.n]
    f32, loss_sum, sq_sum) with 0-dim sums.
    CPU: the plain twin. CUDA: fwd_bwd + wgrad kernels, or an error."""
    B = feats.shape[0] if batch_size is None else int(batch_size)
    row0 = int(block) * B
    if params.device.type == "cpu":
        return train_grads_plain(layout, params, feats[row0:row0 + B], gt, loss_type)
    if loss_type not in LOSS_MODES:
        raise ValueError(f"unknown loss_type {loss_type!r}")
    _check_train_operands(layout, params, feats, gt, row0, B, "fused_train_grads")
    grads = torch.empty(layout.n, dtype=torch.float32, device=params.device)
    sums = _train_kernels(layout, params, feats, row0, B, gt, LOSS_MODES[loss_type],
                          scratch, grads)
    return grads, sums[0], sums[1]


# --------------------------------------------------------------------- Adam

def adam_hyper_rows(counts, learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                    device=None):
    """[T, 128] f32 hyper rows, one per step: (lr, 1/(1-b1^t), 1/(1-b2^t),
    b1, b2, eps, eps_root) in lanes 0..6 for the 1-based step counts t.
    Computed in f32 like optax under inject_hyperparams (its betas are f32)."""
    t = torch.as_tensor(counts, device=device).to(torch.float32)[:, None]
    f32 = lambda v: torch.tensor(float(v), dtype=torch.float32, device=t.device)  # noqa: E731
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
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@torch.no_grad()
def fused_adam_apply(params, m, v, hyper, grads):
    """The Adam update over the flat buffers, IN PLACE on params, m and v
    (the port updates in place where the reference donated its buffers).
    hyper: one [128] (or [1, 128]) row of ``adam_hyper_rows``.
    CPU: the plain twin. CUDA: csrc/fused_adam.cu, or an error."""
    if params.device.type == "cpu":
        for dst, src in zip((params, m, v), adam_apply_plain(params, m, v, hyper, grads)):
            dst.copy_(src)
        return
    n = params.numel()
    for name, t in (("params", params), ("m", m), ("v", v), ("grads", grads)):
        if (t.device != params.device or t.dtype != torch.float32 or t.numel() != n
                or not t.is_contiguous()):
            raise ValueError(f"fused_adam_apply: {name} must be contiguous float32 "
                             f"[{n}] on {params.device}")
    if (hyper.device != params.device or hyper.dtype != torch.float32
            or hyper.numel() != 128 or not hyper.is_contiguous()):
        raise ValueError("fused_adam_apply: hyper must be one contiguous float32 [128] row")
    rc = _adam_fn()(params.data_ptr(), m.data_ptr(), v.data_ptr(), grads.data_ptr(),
                    hyper.data_ptr(), n, _stream(params))
    if rc != 0:
        raise RuntimeError(f"fused_adam launch failed: cudaError {rc}")
    fused_adam_apply.launches += 1


fused_adam_apply.launches = 0


def fused_train_adam(layout, params, m, v, hyper, feats, gt, block, batch_size,
                     loss_type="L1", scratch=None):
    """One training step: ``fused_train_grads`` on the streamed batch, then
    ``fused_adam_apply`` in place. Returns (loss_sum, sq_sum), 0-dim.
    On the card: fwd_bwd, wgrad, adam — three launches, no host sync."""
    if params.device.type == "cpu":
        grads, loss_sum, sq_sum = fused_train_grads(
            layout, params, feats, gt, block, batch_size, loss_type)
        fused_adam_apply(params, m, v, hyper, grads)
        return loss_sum, sq_sum
    B = int(batch_size)
    if loss_type not in LOSS_MODES:
        raise ValueError(f"unknown loss_type {loss_type!r}")
    _check_train_operands(layout, params, feats, gt, int(block) * B, B, "fused_train_adam")
    if scratch is None:
        scratch = make_train_scratch(layout, B, params.device)
    sums = _train_kernels(layout, params, feats, int(block) * B, B, gt,
                          LOSS_MODES[loss_type], scratch, scratch.grads)
    fused_adam_apply(params, m, v, hyper, scratch.grads)
    return sums[0], sums[1]


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
    the flat params (``params.requires_grad``)."""
    return _FusedApply.apply(params, x, layout)


# --------------------------------------------------------------- counters

def kernel_launches():
    """{kernel: launches since the last reset} for every kernel of the module."""
    return {"fused_mlp_fwd": fused_apply.launches,
            "fused_mlp_fwd_bwd": _launch_fwd_bwd.launches,
            "fused_mlp_wgrad": _launch_wgrad.launches,
            "fused_adam": fused_adam_apply.launches}


def reset_kernel_launches():
    for fn in (fused_apply, _launch_fwd_bwd, _launch_wgrad, fused_adam_apply):
        fn.launches = 0
