"""Full-view rendering on a GPU (or D of them): ray generation, the raster tracer,
feature interpolation and the fused MLP kernel, with the background
composited on the device and f16 (or uint8) colors on the wire, in raster
order.

The view-dependent field also needs each hit's unit ray direction and
original face id (the tracer's faces are Morton-sorted; the id is mapped
back before the face-normal lookup); its view encoding runs in plain torch
beside the kernel, as in the reference renderer.

The host selects masked pixels up front (Morton-ordered, cached per pixel
set, with a slot map from each raster pixel to its Morton row); one launch
a frame (ops/wire.py) composites, quantizes and puts the colors in raster
order on the device, so the host only converts the wire's type. Dispatch is
asynchronous (`render_async` / `render_fetch`), so an eval or video loop
can overlap one view's fetch with the next view's device work.

Meshroom (AliceVision radial-k3) views are traced through undistorted,
non-integer pixel coordinates: undistorted in f64 on the host, cast to f32
and uploaded once per (pixel set, K, coefficients), as the JAX package's
`Renderer._coords_for_view` (render/renderer.py:443-466) does.

The xyz / ff / rff fields take the mesh's f32 vertex positions as their
per-vertex table (it follows the mesh through set_mesh and
apply_mesh_transform): each chunk's interpolated positions are encoded by
the model's own encoder, then run through the forward kernel at the
embedded width (JAX render/renderer.py:221-262, 283-300), the
view-dependent kernel for a view-dependent field. How the field runs is
``ops/field_infer.FieldInfer``'s decision: a field the kernels do not
compute (a sine field) runs its module's f32 forward when ``infer`` is
left unset, as the JAX renderer's ``infer="auto"`` takes its XLA path,
and an explicit ``infer="kernel"`` for it raises.

The D-way render (``devices=[...]``, JAX render/renderer.py:100-114,
148-178, 353-378): the geometry, the feature table and the field are
replicated on every device of the list (a device may repeat), each view's
masked rays are cut into D contiguous shards of a multiple of the
inference chunk (so a shard's tracer packets and inference chunks are the
single-device render's), each shard is traced and inferred on its own
device, and the colours are gathered in order on devices[0]. Every shard is
traced against the WHOLE view's pixel hull, never its own: the hull sizes
the binning tables, and so the exact-t tie-breaks (JAX :511-516). The
image and the hit set are the single-device render's, to the bit.
"""
from __future__ import annotations

import copy
import hashlib
from collections import OrderedDict
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..devices import device_of, device_scope, resolve_devices
from ..geometry.cameras import DistortionTypes, undistort_pixels_meshroom_radial_k3
from ..ops.field_infer import FieldInfer
from ..ops.interpolate import interpolate_vertex_features
from ..ops.launches import add, span, tracing
from ..ops.morton import face_morton_order, pixel_morton_order
from ..ops.raster import MeshTable, check_pinhole_K, intersect_coords_pinhole_core
from ..ops.wire import compose_wire

_INFER_CHUNK = 1 << 13     # rays per feature-gather + MLP launch
_TRACE_CACHE_MAX = 8       # LRU bound on cached per-view traces
_PIXEL_CACHE_MAX = 8       # LRU bound on cached per-view pixel bundles
                           # (and on cached undistorted coordinates)


class _PixelEntry(NamedTuple):
    """Per-(H, W, mask) pixel bundle, shared by every camera pose that
    renders the same pixel set."""
    mask_bits: bytes   # packed mask (b"" when unmasked): compared on a hit
    pix_idx: object    # [L] host masked pixel ids in Morton order
    L: int
    hull: object       # [2,2] f32 (cmin; cmax) pixel hull
    idx_dev: object    # [L] int64 masked pixel ids in Morton order, on device
    slot_dev: object   # [H*W] int32 Morton row of each raster pixel (-1 outside
                       # the mask), on device


class ViewTrace(NamedTuple):
    """One traced view, in trace order: hit vertex ids [L,3], barycentrics
    [L,3], valid [L], the row-major pixel id of each ray [L], the unit ray
    directions [L,3] and the original mesh face id of each hit [L] (0 where
    nothing was hit)."""
    vids: object
    bary: object
    valid: object
    pix_idx: object
    dirs: object
    face_idxs: object


class _PendingRender(NamedTuple):
    """An in-flight render: the raster-order wire image [H*W,3] and, for
    eval_render, the hit plane [H*W] on the device (None for an empty
    mask), plus what the host needs to finish it."""
    rgb_dev: object
    valid_dev: object
    obj_mask_1d: object
    bg: float
    H: int
    W: int
    eval_render: bool


def make_renderer_from_config(config, weights_path=None, device="cuda", wire_u8=False,
                              infer=None, devices=None):
    """Renderer for an experiment config (the reference YAML schema) and a
    weights file: `weights_path` as named, else the out_dir's
    (utils/checkpoint.resolve_weights_path: <training.out_dir>/model.pt, or
    the JAX package's model.ckpt when there is no model.pt); either
    package's format (utils/checkpoint.load_trained_weights). wire_u8 and
    infer: as for Renderer; devices: a device list (or a count of CUDA
    devices) for the D-way render, its first device replacing `device`."""
    if devices is not None:
        devices = resolve_devices(devices)
        device = devices[0]

    from ..geometry.mesh import load_mesh
    from ..models.factory import make_model
    from ..spectral.features import load_first_k_eigenfunctions
    from ..utils.checkpoint import load_trained_weights, resolve_weights_path

    data, model_cfg = config["data"], config["model"]
    mesh = load_mesh(data["mesh_path"])
    efuncs = None
    if model_cfg.get("feature_strategy", "efuncs") == "efuncs":
        efuncs = load_first_k_eigenfunctions(
            data["eigenfunctions_path"], model_cfg.get("k"),
            rescale_strategy=data.get("rescale_strategy", "standard"),
            embed_strategy=data.get("embed_strategy"),
            eigenvalues_path=data.get("eigenvalues_path"),
            ts=model_cfg.get("hks_timesteps", 128),
        )
    model = make_model(model_cfg, device=device, mesh=mesh)
    if weights_path is None:
        weights_path = resolve_weights_path(config["training"]["out_dir"])
    model.load_state_dict(load_trained_weights(weights_path, model_cfg))
    return Renderer(
        model, mesh, efuncs, H=data["img_height"], W=data["img_width"],
        feature_dtype=data.get("precompute_dtype"), wire_u8=wire_u8, infer=infer,
        device=device, devices=devices,
    )


class Renderer:
    """Renders views of a trained texture field (plain or view-dependent)."""

    def __init__(self, model, mesh, eigenfunctions=None, background="white", *, H, W,
                 feature_dtype=None, wire_u8=False, infer=None, device="cuda", devices=None):
        """model: a TextureField, TextureFieldWithViewDependency (its
        weights are packed for the kernel here and on every
        update_variables) or NeuTex train wrapper (its module forward on
        the hit positions). eigenfunctions: [V, k] per-vertex features of an
        eigenfunction field (None for xyz / ff / rff, which read the mesh's
        vertices). feature_dtype: "bfloat16" stores the eigenfunction table
        in bf16 (as a precompute_dtype: bfloat16 training run saw it);
        interpolation stays f32, and positions stay f32. wire_u8: ship uint8
        colors instead of f16 (8-bit sinks). infer: "kernel" (default on
        CUDA) or "plain" (default on CPU, the kernel's plain torch twin);
        unset, a field the kernels do not compute runs its module's f32
        forward, and an explicit "kernel" or "plain" for it raises
        (ops/field_infer.py). devices: a device list (or a count of CUDA
        devices) for the D-way render; its first device must be `device`,
        where the model lives."""
        self.device = resolve_device(device)
        self.devices = None
        if devices is not None:
            self.devices = resolve_devices(devices)
            if self.devices[0] != device_of(torch.empty(0, device=self.device)):
                raise ValueError(f"the device list starts with {self.devices[0]}, the renderer "
                                 f"is on {self.device}")
            self.device = self.devices[0]
        self._device_copies = None
        self.field = FieldInfer(model, self.device, infer)
        self.viewdep = self.field.viewdep
        self.feature_strategy = ("efuncs" if self.field.encode is None
                                 else getattr(model, "spatial_mlp", model).input_feature_embed)
        self.model = model
        self.mesh = mesh
        self.H, self.W = H, W
        self.background = background
        self._wire_u8 = bool(wire_u8)
        self._feature_dtype = (
            torch.bfloat16 if feature_dtype in ("bfloat16", torch.bfloat16)
            else torch.float32
        )
        if self.feature_strategy == "efuncs":
            self.set_eigenfunctions(eigenfunctions)
        elif eigenfunctions is not None:
            raise ValueError(f"a {self.feature_strategy} field reads the mesh's vertices, "
                             "not an eigenfunction table")
        self._pixel_cache = OrderedDict()
        self._coords_cache = OrderedDict()
        self._refresh_geometry()

    def set_height(self, height):
        """Render at another height; the cached traces, pixel bundles and
        undistorted coordinates were made for the old one."""
        self.H = height
        self._clear_view_caches()

    def set_width(self, width):
        """Render at another width (see set_height)."""
        self.W = width
        self._clear_view_caches()

    def _clear_view_caches(self):
        self._trace_cache.clear()
        self._pixel_cache.clear()
        self._coords_cache.clear()

    # ------------------------------------------------------------ state

    @property
    def infer_mode(self):
        """How the field runs: "kernel", "plain" or "module"
        (ops/field_infer.py)."""
        return self.field.mode

    @property
    def weights(self):
        """The kernel's packed weights (None in "module" mode)."""
        return self.field.weights

    def update_variables(self, state_dict):
        """Point the renderer at new weights (the model's whole state dict,
        RFF's embedding.B and BatchNorm statistics included): see
        FieldInfer.update_variables. The other devices' copies follow."""
        self.field.update_variables(state_dict)
        self._device_copies = None

    def set_eigenfunctions(self, eigenfunctions):
        """Swap the per-vertex feature table (same k)."""
        if self.feature_strategy != "efuncs":
            raise ValueError(f"a {self.feature_strategy} field reads the mesh's vertices: "
                             "use set_mesh")
        E = torch.as_tensor(np.asarray(eigenfunctions, np.float32))
        if E.ndim != 2 or E.shape[1] != self.model.in_dim:
            raise ValueError(
                f"eigenfunctions must be [V, {self.model.in_dim}], got {tuple(E.shape)}"
            )
        self.features = E.to(device=self.device, dtype=self._feature_dtype)
        self._device_copies = None

    def _refresh_geometry(self):
        # The intrinsic view strategy reads the model's face normals: after a
        # mesh transform they must follow the mesh, or every view angle (and
        # so every colour) is computed against stale normals.
        if getattr(self.model, "view_dir_strategy", None) == "intrinsic":
            self.model.face_normals = torch.as_tensor(
                np.asarray(self.mesh.face_normals, np.float32), device=self.device)
        self._verts = torch.as_tensor(
            np.asarray(self.mesh.vertices, np.float32), device=self.device)
        if self.feature_strategy != "efuncs":
            self.features = self._verts  # positions: f32, whatever feature_dtype says
        # Faces sorted spatially (Morton) so tracer packets stay compact;
        # _face_orig_ids maps a sorted hit id back to the mesh's face id.
        order = face_morton_order(self.mesh.vertices, self.mesh.faces)
        self._faces_sorted = torch.as_tensor(
            self.mesh.faces[order].astype(np.int64), device=self.device)
        self._face_orig_ids = torch.as_tensor(order.astype(np.int64), device=self.device)
        # The tracer's face table, built by the first view that traces.
        self._mesh_table = MeshTable(self._verts, self._faces_sorted)
        # Geometry-dependent per-view traces, keyed on (cache_key, H, W).
        self._trace_cache = OrderedDict()
        self._device_copies = None

    def _on(self, dev):
        """What a shard on `dev` reads: the geometry with its face table,
        the feature table and the field, the renderer's own on its device,
        else copies made from them (again after any of them changed)."""
        if dev == self.device:
            return SimpleNamespace(device=dev, field=self.field, verts=self._verts,
                                   faces_sorted=self._faces_sorted,
                                   face_orig_ids=self._face_orig_ids, features=self.features,
                                   mesh_table=self._mesh_table)
        if self._device_copies is None:
            self._device_copies = {}
        if dev not in self._device_copies:
            mode = self.field.mode
            verts, faces = self._verts.to(dev), self._faces_sorted.to(dev)
            self._device_copies[dev] = SimpleNamespace(
                device=dev,
                field=FieldInfer(copy.deepcopy(self.model).to(dev), dev,
                                 None if mode == "module" else mode),
                verts=verts, faces_sorted=faces, face_orig_ids=self._face_orig_ids.to(dev),
                features=self.features.to(dev), mesh_table=MeshTable(verts, faces))
        return self._device_copies[dev]

    def _shards(self, L):
        """(device, row slice) of each shard that holds rays: one shard on
        one device, else D contiguous shards of S rays, S the least multiple
        of the inference chunk with D S >= L."""
        if self.devices is None:
            return [(self.device, slice(0, L))]
        D = len(self.devices)
        S = -(-L // (D * _INFER_CHUNK)) * _INFER_CHUNK
        return [(dev, slice(d * S, min((d + 1) * S, L)))
                for d, dev in enumerate(self.devices) if d * S < L]

    # ------------------------------------------------------------ stages

    def _pixels_for_view(self, obj_mask_1d):
        """LRU-cached pixel bundle. The key carries a digest of the packed
        mask, and a hit is confirmed by comparing the packed bytes, so a
        digest collision rebuilds instead of serving another mask's pixels."""
        H, W = self.H, self.W
        bits = b"" if obj_mask_1d is None else np.packbits(obj_mask_1d).tobytes()
        key = (H, W, hashlib.blake2b(bits, digest_size=16).digest())
        entry = self._pixel_cache.get(key)
        if entry is not None and entry.mask_bits == bits:
            self._pixel_cache.move_to_end(key)
            return key, entry
        if obj_mask_1d is not None:
            pix_idx = np.nonzero(obj_mask_1d)[0]
        else:
            pix_idx = np.arange(H * W)
        xy = np.stack([pix_idx % W, pix_idx // W], axis=-1)
        morton = pixel_morton_order(xy)
        hull = np.stack([xy.min(0), xy.max(0)]).astype(np.float32)
        pix_idx = pix_idx[morton]
        idx_dev = torch.as_tensor(pix_idx.astype(np.int64), device=self.device)
        slot = np.full(H * W, -1, np.int32)
        slot[pix_idx] = np.arange(len(pix_idx), dtype=np.int32)
        entry = _PixelEntry(mask_bits=bits, pix_idx=pix_idx, L=len(pix_idx), hull=hull,
                            idx_dev=idx_dev, slot_dev=torch.as_tensor(slot, device=self.device))
        self._pixel_cache[key] = entry
        self._pixel_cache.move_to_end(key)
        while len(self._pixel_cache) > _PIXEL_CACHE_MAX:
            self._pixel_cache.popitem(last=False)
        return key, entry

    def _coords_for_view(self, pix_key, px, K, distortion_coeffs):
        """LRU-cached undistorted pixel coordinates [L,2] f32 on the device
        and their [2,2] hull. Undistortion depends on the pixel set, K and
        the coefficients, not on the pose: a sweep with one intrinsic block
        undistorts and uploads once (JAX render/renderer.py:443-466)."""
        key = (pix_key, px.mask_bits, np.asarray(K, np.float64).tobytes(),
               np.asarray(distortion_coeffs, np.float64).tobytes())
        hit = self._coords_cache.get(key)
        if hit is not None:
            self._coords_cache.move_to_end(key)
            return hit
        coords = np.stack([px.pix_idx % self.W, px.pix_idx // self.W], axis=-1).astype(np.float64)
        coords = undistort_pixels_meshroom_radial_k3(coords, K, distortion_coeffs)
        coords = coords.astype(np.float32)
        hull = np.stack([coords.min(0), coords.max(0)])
        entry = (torch.as_tensor(coords, device=self.device), hull)
        self._coords_cache[key] = entry
        while len(self._coords_cache) > _PIXEL_CACHE_MAX:
            self._coords_cache.popitem(last=False)
        return entry

    def _trace(self, px, camCv2world, K, with_dirs, coords=None, dev=None, rows=None):
        """Pixel bundle + camera -> (vids [L,3], bary [L,3], dirs [L,3],
        original face ids [L], valid [L]); dirs and face ids are None
        unless with_dirs (only the view-dependent field reads them).
        coords: (undistorted [L,2] coordinates, their hull) to trace in
        place of the bundle's integer pixel grid. dev, rows: trace only
        those rays, on that device (a shard), against the whole view's hull."""
        W = self.W
        if coords is None:
            x = (px.idx_dev % W).to(torch.float32)
            y = torch.div(px.idx_dev, W, rounding_mode="floor").to(torch.float32)
            coords = (torch.stack([x, y], dim=-1), px.hull)
        g = self._on(self.device if dev is None else dev)
        c = coords[0] if rows is None else coords[0][rows].to(g.device)
        out = intersect_coords_pinhole_core(
            g.verts, g.faces_sorted, np.asarray(camCv2world, np.float32),
            np.asarray(K, np.float32), c, W=W, H=self.H, coord_hull=coords[1],
            return_dirs=with_dirs, mesh_table=g.mesh_table,
        )
        hits, dirs = out if with_dirs else (out, None)
        safe_face = torch.where(hits.valid, hits.face_idx, torch.zeros_like(hits.face_idx))
        faces = g.face_orig_ids[safe_face] if with_dirs else None
        return g.faces_sorted[safe_face], hits.bary, dirs, faces, hits.valid

    def _infer(self, trace, bg, dev=None):
        """Hit records -> ([L,3] f32 rgb, [L] valid), on the trace's device.
        bg is not read (the wire kernel composites the background); the
        benchmark's fault tests (benchmark/tests/test_bench_faults.py) plant
        their faults through this signature."""
        g = self._on(self.device if dev is None else dev)
        vids, bary, dirs, faces, valid = trace
        L = vids.shape[0]
        with span("render.infer", rays=L):
            if tracing():
                add("hits", valid.sum())
            preds = torch.empty((L, 3), dtype=torch.float32, device=g.device)
            for s in range(0, L, _INFER_CHUNK):
                sl = slice(s, s + _INFER_CHUNK)
                feats = interpolate_vertex_features(g.features, vids[sl], bary[sl])
                preds[sl] = (g.field(feats, dirs[sl], faces[sl]) if self.viewdep
                             else g.field(feats))
        return preds, valid

    # ------------------------------------------------------------ API

    def trace_view(self, camCv2world, K):
        """Trace every pixel of one view on the device, for callers that
        shade the hits themselves (a ViewTrace, in trace order)."""
        check_pinhole_K(K)
        _, px = self._pixels_for_view(None)
        vids, bary, dirs, faces, valid = self._trace(px, camCv2world, K, with_dirs=True)
        return ViewTrace(vids, bary, valid, px.idx_dev, dirs, faces)

    def set_mesh(self, mesh):
        """Render the same field on another mesh (texture transfer,
        eval_on_mesh): an eigenfunction field's caller swaps in a feature
        table for it with set_eigenfunctions; an xyz / ff / rff field reads
        the new mesh's vertices."""
        self.mesh = mesh
        self._refresh_geometry()

    def apply_mesh_transform(self, transform):
        """Transform the mesh in place (4x4) and refresh everything derived
        from it: vertices, the face order and table and, for the intrinsic
        view strategy, the model's face normals; cached traces are
        dropped."""
        self.mesh.apply_transform(transform)
        self._refresh_geometry()

    def render(self, camCv2world, K, obj_mask_1d=None, eval_render=False,
               distortion_coeffs=None, distortion_type=None, cache_key=None):
        """Render one view: an [H,W,3] float32 image, or (image,
        hit_ray_idxs) when eval_render=True (hit_ray_idxs index the
        masked-pixel array, all pixels if no mask).

        distortion_type: None (pinhole) or "meshroom_radial_k3", with its
        three distortion_coeffs: the rays go through the undistorted pixel
        coordinates.

        cache_key: optional hashable naming this (camera, mask) view; its
        trace is reused by later renders of the same key and the same
        distortion (only inference reruns). Reusing a key with another mask
        raises."""
        return self.render_fetch(self.render_async(
            camCv2world, K, obj_mask_1d=obj_mask_1d, eval_render=eval_render,
            distortion_coeffs=distortion_coeffs, distortion_type=distortion_type,
            cache_key=cache_key,
        ))

    def render_async(self, camCv2world, K, obj_mask_1d=None, eval_render=False,
                     distortion_coeffs=None, distortion_type=None, cache_key=None):
        """Enqueue one view's device work and return a pending handle;
        render_fetch(handle) completes it."""
        with span("render.async"):
            if distortion_type is not None:
                if distortion_coeffs is None:
                    raise ValueError(f"distortion_type {distortion_type!r} needs distortion_coeffs")
                if distortion_type != DistortionTypes.MESHROOM_RADIAL_K3:
                    raise ValueError(f"Unknown distortion type: {distortion_type}")
            # The binning projection assumes pinhole intrinsics: checked on every
            # render, the trace below would silently mis-bin otherwise.
            check_pinhole_K(K)
            H, W = self.H, self.W
            if self.background not in ("white", "black"):
                raise ValueError(f"background must be 'white' or 'black', got {self.background!r}")
            bg = 1.0 if self.background == "white" else 0.0
            if obj_mask_1d is not None:
                obj_mask_1d = np.asarray(obj_mask_1d, dtype=bool).reshape(-1)
                if obj_mask_1d.shape[0] != H * W:
                    raise ValueError(f"mask has {obj_mask_1d.shape[0]} pixels, view {H}x{W}")
                if not obj_mask_1d.any():
                    # Empty object mask: an all-background image, nothing to trace.
                    return _PendingRender(
                        rgb_dev=None, valid_dev=None, obj_mask_1d=obj_mask_1d, bg=bg, H=H, W=W,
                        eval_render=eval_render,
                    )
            pix_key, px = self._pixels_for_view(obj_mask_1d)

            # The coefficients are part of the key: a trace made through one
            # set of undistorted coordinates is never served for another.
            dist_key = (None if distortion_type is None
                        else (distortion_type, np.asarray(distortion_coeffs, np.float64).tobytes()))
            full_key = None if cache_key is None else (cache_key, H, W, dist_key)
            trace = None
            if full_key is not None and full_key in self._trace_cache:
                cached_key, cached_bits, trace = self._trace_cache[full_key]
                if cached_key != pix_key or cached_bits != px.mask_bits:
                    raise ValueError(
                        f"render cache_key {cache_key!r} reused with a different "
                        "object mask — use a new cache_key per distinct view selection"
                    )
                self._trace_cache.move_to_end(full_key)
            if trace is None:
                coords = (None if distortion_type is None
                          else self._coords_for_view(pix_key, px, K, distortion_coeffs))
                # one (device, trace) per shard; the trace keeps no weights
                trace = []
                for dev, rows in self._shards(px.L):
                    with device_scope(dev), span("render.trace"):
                        trace.append((dev, self._trace(px, camCv2world, K, with_dirs=self.viewdep,
                                                       coords=coords, dev=dev, rows=rows)))
                if full_key is not None:
                    self._trace_cache[full_key] = (pix_key, px.mask_bits, trace)
                    while len(self._trace_cache) > _TRACE_CACHE_MAX:
                        self._trace_cache.popitem(last=False)

            parts = []
            for dev, tr in trace:
                with device_scope(dev):
                    parts.append(self._infer(tr, bg, dev))
            if len(parts) == 1:
                preds, valid = parts[0]
            else:  # gathered in shard order on devices[0]
                preds, valid = (torch.cat([p[i].to(self.device) for p in parts])
                                for i in (0, 1))
            # The wire image in raster order, background composited. f16
            # quantization (~5e-4 in [0,1]) is far below the 8-bit image grid.
            rgb_dev, valid_dev = compose_wire(preds, valid, px.slot_dev, bg, self._wire_u8,
                                              eval_render)
            return _PendingRender(
                rgb_dev=rgb_dev, valid_dev=valid_dev, obj_mask_1d=obj_mask_1d, bg=bg, H=H, W=W,
                eval_render=eval_render,
            )

    def render_fetch(self, pending):
        """Complete a render_async dispatch: one device->host copy of the
        raster-order wire image, then one conversion to f32 on the host."""
        with span("render.fetch"):
            H, W = pending.H, pending.W
            if pending.rgb_dev is None:  # empty mask: the background, no hit
                img = np.full((H, W, 3), pending.bg, dtype=np.float32)
                return (img, np.zeros(0, np.int64)) if pending.eval_render else img
            with span("render.fetch.copy"):
                rgb = pending.rgb_dev.cpu().numpy()
                hit = pending.valid_dev.cpu().numpy() if pending.eval_render else None
            with span("render.fetch.convert"):
                # one pass: u8 / 255 divided in f32, or f16 widened
                img = (np.divide(rgb, np.float32(255.0), dtype=np.float32)
                       if rgb.dtype == np.uint8 else rgb.astype(np.float32)).reshape(H, W, 3)
                if pending.eval_render:
                    mask = pending.obj_mask_1d
                    return img, np.nonzero(hit if mask is None else hit[mask])[0]
                return img
