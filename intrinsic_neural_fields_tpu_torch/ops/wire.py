"""The render's wire image: the background composited, the colours
quantized to the wire's type and put in raster order, on the device.

A view's rays are traced and inferred in Morton order over its masked
pixels; the image leaves the device in raster order, ready to use. A slot
map, one int32 per raster pixel (the row of the Morton-ordered records that
traced it, -1 outside the mask), carries the permutation and the mask. The
composite is the renderer's: f32 -> f16 (round to nearest even), the
background's f16 where nothing was hit or the pixel is outside the mask;
on the u8 wire then f32, clamp to [0, 1], x 255, round half to even, u8.

``compose_wire`` launches ``csrc/render_wire.cu`` once for CUDA tensors
and runs ``compose_wire_plain``, the same steps by torch indexing, for CPU
tensors; both give the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from .launches import _launches, register

register("render_wire")


def _check_operands(preds, valid, slot):
    dev = preds.device

    def tensor(name, t, dtype, shape):
        if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"compose_wire: {name} must be contiguous {dtype} {list(shape)} on "
                             f"{dev}, got {t.dtype} {list(t.shape)} on {t.device}")

    L = preds.shape[0] if preds.dim() == 2 else -1
    tensor("preds", preds, torch.float32, (L, 3))
    tensor("valid", valid, torch.bool, (L,))
    tensor("slot", slot, torch.int32, (slot.numel(),))
    if L >= 2 ** 31 or slot.numel() >= 2 ** 31 - 4096:
        raise ValueError(f"compose_wire: {L} rays and {slot.numel()} pixels must be below 2^31")


def compose_wire_plain(preds, valid, slot, bg, wire_u8, with_valid):
    """The wire image in plain torch (the kernel's twin and the CPU path):
    ([P, 3] u8 or f16 in raster order, the [P] u8 hit plane or None).
    preds [L, 3] f32 and valid [L] bool in trace order; slot [P] int32, a
    row of them per raster pixel (outside [0, L): outside the mask); bg the
    background (0.0 or 1.0); wire_u8: the u8 wire, else f16; with_valid:
    also the hit plane (0 outside the mask)."""
    L = preds.shape[0]
    # Row L is a ray that hit nothing: what a pixel outside the mask shows.
    preds = torch.cat([preds, preds.new_zeros(1, 3)])
    valid = torch.cat([valid, valid.new_zeros(1)])
    rgb = torch.where(valid[:, None], preds.to(torch.float16),
                      torch.tensor(bg, dtype=torch.float16, device=preds.device))
    if wire_u8:
        rgb = torch.round(rgb.to(torch.float32).clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    rows = torch.where((slot >= 0) & (slot < L), slot, L).long()
    return rgb[rows], valid[rows].to(torch.uint8) if with_valid else None


def _wire_lib():
    from ._build import load

    lib = load("render_wire")
    fn = lib.render_wire
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, I, ctypes.c_float, I, P, P, P]
        fn.restype = I
    return fn


def _launch(preds, valid, slot, bg, wire_u8, out, plane):
    """One launch of csrc/render_wire.cu into `out` (and `plane`) on the
    current stream of the operands' device; raises if it was refused."""
    rc = _wire_lib()(
        preds.data_ptr(), valid.data_ptr(), slot.data_ptr(), slot.numel(), preds.shape[0],
        float(bg), int(wire_u8), out.data_ptr(), None if plane is None else plane.data_ptr(),
        torch.cuda.current_stream(preds.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"render_wire launch failed: cudaError {rc}")
    _launches["render_wire"] += 1


def compose_wire(preds, valid, slot, bg, wire_u8, with_valid):
    """The wire image of one view (arguments and result as for
    ``compose_wire_plain``). CPU tensors: the twin. CUDA tensors: one launch
    of ``csrc/render_wire.cu`` on the current stream, with the twin's bits
    and no device->host read, or an error."""
    _check_operands(preds, valid, slot)
    dev = preds.device
    if dev.type == "cpu":
        return compose_wire_plain(preds, valid, slot, bg, wire_u8, with_valid)
    if dev.type != "cuda":
        raise ValueError(f"compose_wire: unsupported device {dev}")
    P = slot.numel()
    out = torch.empty((P, 3), dtype=torch.uint8 if wire_u8 else torch.float16, device=dev)
    plane = torch.empty(P, dtype=torch.uint8, device=dev) if with_valid else None
    _launch(preds, valid, slot, bg, wire_u8, out, plane)
    return out, plane
