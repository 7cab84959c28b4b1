"""Loading of the preprocessed 5-array ray cache (reference dataset.py:12-33).

The on-disk contract is byte-compatible with the reference so preprocessed
datasets are interchangeable between the two implementations:
  vids_of_hit_faces.npy   int32   [N,3]
  barycentric_coords.npy  float32 [N,3]
  expected_rgbs.npy       float32 [N,3]
  unit_ray_dirs.npy       float32 [N,3]  (optional pair)
  face_idxs.npy           int32   [N]    (optional pair)
"""
from __future__ import annotations

import os

import numpy as np


def load_preprocessed_data(preproc_data_path):
    data = {}
    data["vertex_idxs_of_hit_faces"] = np.load(
        os.path.join(preproc_data_path, "vids_of_hit_faces.npy")
    ).astype(np.int32)
    data["barycentric_coords"] = np.load(
        os.path.join(preproc_data_path, "barycentric_coords.npy")
    ).astype(np.float32)
    data["expected_rgbs"] = np.load(
        os.path.join(preproc_data_path, "expected_rgbs.npy")
    ).astype(np.float32)

    unit_ray_dirs_path = os.path.join(preproc_data_path, "unit_ray_dirs.npy")
    face_idxs_path = os.path.join(preproc_data_path, "face_idxs.npy")
    if os.path.exists(unit_ray_dirs_path) and os.path.exists(face_idxs_path):
        data["unit_ray_dirs"] = np.load(unit_ray_dirs_path).astype(np.float32)
        data["face_idxs"] = np.load(face_idxs_path).astype(np.int32)
    return data
