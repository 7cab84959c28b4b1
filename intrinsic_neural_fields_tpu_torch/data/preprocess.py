"""Offline view preprocessing: posed views -> the 5-array ray cache.

The JAX package's MeshViewPreProcessor (reference mesh.py:431-570) on
torch: rays through the masked pixels of each view are traced on the card
(``intersector="device"``: the projective-binning tracer ``tracer="raster"``
over Morton-ordered pixels, or the cone tracer ``tracer="cone"``) or on the
host in float64 (``intersector="host"``: the native BVH, else the numpy
oracle). Hits are filtered with numpy masks and written as the same five
.npy files, so caches interoperate with the JAX package's.

Views are pipelined two deep: a view's trace is dispatched, its
face_idx/bary/valid (and t for the depth check) start down by non-blocking
copies into pinned host memory behind a CUDA event, and the host filters
the view two places behind. Unit ray directions for the cache are
recomputed on the host (same math, numpy).
"""
from __future__ import annotations

import os
from collections import deque

import numpy as np
import torch

from ..geometry.cameras import DistortionTypes, undistort_pixels_meshroom_radial_k3
from ..geometry.mesh import load_mesh
from ..ops.intersect import HostBVH, intersect_rays, intersect_rays_numpy
from ..ops.morton import pixel_morton_order
from ..ops.raster import MeshTable, check_pinhole_K, intersect_coords_pinhole_core
from ..ops.ray_gen import pixel_grid_coords, ray_origins_and_directions, unit_ray_dirs_numpy

_PIPELINE_DEPTH = 2


class MeshViewPreProcessor:
    """Accumulates per-view ray hits and writes the npy cache. The device
    intersector runs on `device` (the GPU unless "cpu" is asked for); the
    host intersector needs no device."""

    def __init__(self, path_to_mesh, out_directory, intersector="device", tracer="raster",
                 device="cuda"):
        from .. import resolve_device

        if intersector not in ("device", "host"):
            raise ValueError(f"intersector must be 'device' or 'host', got {intersector!r}")
        if tracer not in ("raster", "cone"):
            raise ValueError(f"tracer must be 'raster' or 'cone', got {tracer!r}")
        self.out_dir = out_directory
        self.mesh = load_mesh(path_to_mesh)
        self.intersector = intersector
        self.tracer = tracer
        if intersector == "device":
            self.device = resolve_device(device)
            self._verts = torch.as_tensor(np.asarray(self.mesh.vertices, np.float32),
                                          device=self.device)
            self._faces = torch.as_tensor(np.asarray(self.mesh.faces, np.int64),
                                          device=self.device)
            # The raster tracer's face table, built by the first view.
            self._mesh_table = MeshTable(self._verts, self._faces)
        self._host_bvh = None
        self._pending = deque()

        self.cache_face_idxs = []
        self.cache_vertex_idxs_of_hit_faces = []
        self.cache_barycentric_coords = []
        self.cache_expected_rgbs = []
        self.cache_unit_ray_dirs = []

    def _intersect_host(self, origins, dirs):
        # Native BVH when buildable, built once and reused across views;
        # the numpy oracle otherwise.
        if self._host_bvh is None:
            try:
                self._host_bvh = HostBVH(self.mesh.vertices, self.mesh.faces)
            except RuntimeError:
                self._host_bvh = False
        if self._host_bvh:
            return self._host_bvh.trace(origins, dirs)
        return intersect_rays_numpy(self.mesh.vertices, self.mesh.faces, origins, dirs)

    def cache_single_view(self, camCv2world, K, mask, img, depth_check=None,
                          distortion_coeffs=None, distortion_type=None):
        """Cast rays through masked pixels, intersect, filter, accumulate
        (reference mesh.py:451-526). The device intersector only dispatches
        the trace here; views older than the pipeline depth are filtered
        first (and all of them at write_to_disk)."""
        camCv2world = np.asarray(camCv2world, dtype=np.float32)
        K = np.asarray(K, dtype=np.float32)
        mask = np.asarray(mask)
        H, W = mask.shape
        mask = mask.reshape(-1)
        img = np.asarray(img, dtype=np.float32).reshape(H * W, -1)

        expected_rgbs = img[mask]  # L x 3

        coords = pixel_grid_coords(H, W)[mask]
        if distortion_type is not None:
            assert distortion_coeffs is not None
            if distortion_type == DistortionTypes.MESHROOM_RADIAL_K3:
                coords = undistort_pixels_meshroom_radial_k3(coords, K, distortion_coeffs)
            else:
                raise ValueError(f"Unknown distortion type: {distortion_type}")

        unit_ray_dirs = unit_ray_dirs_numpy(camCv2world, K, coords)
        L = coords.shape[0]

        if L == 0:
            # Fully masked-out view: nothing to trace, cache nothing.
            self._finalize_view(camCv2world, None, np.zeros(0, np.int32),
                                np.zeros((0, 3), np.float32), np.zeros(0, bool),
                                expected_rgbs, unit_ray_dirs, mask, None)
            return

        if self.intersector == "host":
            origins = np.broadcast_to(camCv2world[:3, 3].astype(np.float64), (L, 3))
            t, face_idx, bary, valid = self._intersect_host(origins, unit_ray_dirs)
            self._finalize_view(camCv2world, t, face_idx, bary, valid,
                                expected_rgbs, unit_ray_dirs, mask, depth_check)
            return

        hits, order = self._dispatch_trace(camCv2world, K, coords, H, W)
        fields = (hits.face_idx, hits.bary, hits.valid)
        if depth_check is not None:
            fields += (hits.t,)
        self._pending.append((self._start_fetch(fields), order, camCv2world, expected_rgbs,
                              unit_ray_dirs, mask, depth_check))
        while len(self._pending) > _PIPELINE_DEPTH:
            self._drain_one()

    def _dispatch_trace(self, camCv2world, K, coords, H, W):
        """Dispatch one view's ray generation and trace on the device;
        returns device Hits for the L coords and the permutation applied to
        them (None for the cone tracer). The JAX package edge-pads the rays
        to a multiple of 2^15 so that jit compiles once per bucket; eager
        torch needs no buckets, and the tracers pad each packet by repeating
        the last ray themselves, so every real ray sees the same packets and
        hull as there. The raster path Z-orders the coords first, so its
        1024-ray packets cover compact tile spans."""
        coords = np.asarray(coords, np.float32)
        if self.tracer == "raster":
            check_pinhole_K(K)
            order = pixel_morton_order(np.clip(coords, 0, [W - 1, H - 1]))
            c = torch.from_numpy(np.ascontiguousarray(coords[order])).to(self.device)
            hits = intersect_coords_pinhole_core(self._verts, self._faces, camCv2world, K, c,
                                                 W=W, H=H, mesh_table=self._mesh_table)
            return hits, order
        c = torch.from_numpy(coords).to(self.device)
        origins, dirs = ray_origins_and_directions(camCv2world, K, c)
        return intersect_rays(self._verts, self._faces, origins, dirs, shared_origin=True), None

    def _start_fetch(self, fields):
        """Start the device-to-host copies of a view's hit fields; returns
        (host tensors, the CUDA event that marks them done or None)."""
        if self.device.type != "cuda":
            return fields, None
        host = tuple(torch.empty(f.shape, dtype=f.dtype, pin_memory=True) for f in fields)
        for h, f in zip(host, fields):
            h.copy_(f, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    @staticmethod
    def _unpermute(order, *arrays):
        if order is None:
            return arrays
        out = []
        for a in arrays:
            u = np.empty_like(a)
            u[order] = a
            out.append(u)
        return tuple(out)

    def _intersect_coords(self, camCv2world, K, coords, H=None, W=None):
        """Synchronous device trace of one view's pixel coords: (t,
        face_idx, bary, valid) numpy arrays in the input coord order. H/W
        default to the coord hull (the raster tile grid only needs to cover
        the coords)."""
        if H is None or W is None:
            W = int(np.ceil(coords[:, 0].max())) + 1
            H = int(np.ceil(coords[:, 1].max())) + 1
        hits, order = self._dispatch_trace(camCv2world, K, coords, H, W)
        return self._unpermute(order, *(x.cpu().numpy() for x in
                                        (hits.t, hits.face_idx, hits.bary, hits.valid)))

    def _drain_one(self):
        ((host, event), order, camCv2world, expected_rgbs, unit_ray_dirs, mask,
         depth_check) = self._pending.popleft()
        if event is not None:
            event.synchronize()
        arrays = self._unpermute(order, *(h.numpy() for h in host))
        face_idx, bary, valid = arrays[:3]
        t = arrays[3] if depth_check is not None else None
        self._finalize_view(camCv2world, t, face_idx, bary, valid,
                            expected_rgbs, unit_ray_dirs, mask, depth_check)

    def _finalize_view(self, camCv2world, t, face_idx, bary, valid,
                       expected_rgbs, unit_ray_dirs, mask, depth_check):
        if depth_check is not None:
            # Reject hits whose ray-traced depth deviates from the dataset's
            # GT depth by more than 1% of the mean (reference mesh.py:479-499).
            depth_masked = np.asarray(depth_check).reshape(-1)[mask]
            cam44 = np.eye(4, dtype=np.float64)
            cam44[:3, :4] = camCv2world[:3, :4]
            world2cam = np.linalg.inv(cam44)
            origins = np.broadcast_to(
                camCv2world[:3, 3].astype(np.float64), unit_ray_dirs.shape
            )
            p_world = origins + t[:, None] * unit_ray_dirs
            z_cam = (p_world @ world2cam[2, :3]) + world2cam[2, 3]
            outlier_thres = np.mean(depth_masked[valid]) * 1e-2
            depth_error = np.abs(z_cam - depth_masked)
            inlier = depth_error < outlier_thres
            removed = int((valid & ~inlier).sum())
            if removed:
                frac = 100.0 * removed / max(int(valid.sum()), 1)
                print(f"DEPTH CHECK: Removed {removed} = {frac:6.3f} % of points")
            valid = valid & inlier

        face_idx = face_idx[valid]
        self.cache_face_idxs.append(face_idx.astype(np.int32))
        self.cache_vertex_idxs_of_hit_faces.append(
            self.mesh.faces[face_idx].astype(np.int32)
        )
        self.cache_barycentric_coords.append(bary[valid].astype(np.float32))
        self.cache_expected_rgbs.append(expected_rgbs[valid].astype(np.float32))
        self.cache_unit_ray_dirs.append(unit_ray_dirs[valid].astype(np.float32))

    def write_to_disk(self):
        while self._pending:
            self._drain_one()
        os.makedirs(self.out_dir, exist_ok=True)

        def _save(name, chunks):
            arr = np.concatenate(chunks, axis=0)
            print(f"{name}: shape={arr.shape}, dtype={arr.dtype}")
            np.save(os.path.join(self.out_dir, name), arr, allow_pickle=False)

        _save("face_idxs.npy", self.cache_face_idxs)
        _save("vids_of_hit_faces.npy", self.cache_vertex_idxs_of_hit_faces)
        _save("barycentric_coords.npy", self.cache_barycentric_coords)
        _save("expected_rgbs.npy", self.cache_expected_rgbs)
        _save("unit_ray_dirs.npy", self.cache_unit_ray_dirs)
