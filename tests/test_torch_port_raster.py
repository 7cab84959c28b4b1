"""Port parity: ray generation and the raster tracer vs the JAX package.

Twins of tests/test_raster.py's cases at a small size, holding the port's
torch tracer to the JAX tracer on the same mesh, camera and pixels:
valid masks equal; face ids equal except on exact-t ties (there the hit
points must coincide); t within rtol 1e-5; barycentrics within 2e-4.
The slack is f32 rounding only: XLA contracts the face-data dot products
into FMAs where eager torch rounds each product, and the ~1-ulp difference
in a face's plane offset is amplified by the cancellation in t = tnum/dn
and by the dual-basis magnitude (~1/edge) in u = oa + t*dA.

The lockstep traversal (traverse_plain, the twin of the card's traversal
kernel) is held to the bit to the JAX package's per-packet walk, written
here in numpy, with the chunk counts it reports; the kernel wrapper's
operand checks and its CPU path are checked here too."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from intrinsic_neural_fields_tpu.geometry.primitives import icosphere as jax_icosphere
from intrinsic_neural_fields_tpu.ops.morton import face_morton_order, pixel_morton_order
from intrinsic_neural_fields_tpu.ops.ray_gen import (
    ray_origins_and_directions as jax_ray_origins_and_directions,
)
from intrinsic_neural_fields_tpu.ops.raster import (
    intersect_coords_pinhole as jax_intersect_coords_pinhole,
)

from intrinsic_neural_fields_tpu_torch.ops import launches
from intrinsic_neural_fields_tpu_torch.ops import raster as R
from intrinsic_neural_fields_tpu_torch.ops.intersect import B_EPS, T_EPS
from intrinsic_neural_fields_tpu_torch.ops.raster import intersect_coords_pinhole
from intrinsic_neural_fields_tpu_torch.ops.ray_gen import (
    pixel_grid_coords,
    ray_origins_and_directions,
)

from tests.test_intersect import _look_at_cam, _simple_K

torch.set_num_threads(2)


def _compare(mesh, cam, K, coords, H, W):
    ref = jax_intersect_coords_pinhole(mesh.vertices, mesh.faces, cam, K, coords, W=W, H=H)
    got = intersect_coords_pinhole(mesh.vertices, mesh.faces, cam, K, coords,
                                   W=W, H=H, device="cpu")
    ref_v = np.asarray(ref.valid)
    got_v = got.valid.numpy()
    np.testing.assert_array_equal(got_v, ref_v)
    f_ref = np.asarray(ref.face_idx)[ref_v]
    f_got = got.face_idx.numpy()[ref_v]
    same = f_ref == f_got
    assert same.size == 0 or same.mean() > 0.999, same.mean()
    np.testing.assert_allclose(got.t.numpy()[ref_v], np.asarray(ref.t)[ref_v],
                               rtol=1e-5, atol=1e-6)
    bary_ref = np.asarray(ref.bary)[ref_v]
    bary_got = got.bary.numpy()[ref_v]
    if not same.all():  # exact-t ties on shared edges: same hit point
        tri = np.asarray(mesh.vertices)[np.asarray(mesh.faces)]
        p_ref = np.einsum("bj,bjk->bk", bary_ref[~same], tri[f_ref[~same]])
        p_got = np.einsum("bj,bjk->bk", bary_got[~same], tri[f_got[~same]])
        np.testing.assert_allclose(p_got, p_ref, atol=2e-4)
    np.testing.assert_allclose(bary_got[same], bary_ref[same], atol=2e-4)
    return ref, got


def _sorted_blob(subdiv):
    m = jax_icosphere(subdiv)
    v = np.asarray(m.vertices)
    r = 1.0 + 0.15 * (np.sin(3 * v[:, 0]) * np.cos(2 * v[:, 1]))
    m.vertices = (v * r[:, None]).astype(np.float64)
    m._cache.clear()
    m.faces = m.faces[face_morton_order(m.vertices, m.faces)]
    return m


def _morton_grid(H, W):
    coords = pixel_grid_coords(H, W)
    return coords[pixel_morton_order(coords)]


def test_ray_origins_and_directions_match_jax():
    """Same f32 FMA chain for R K^-1 and the same per-ray contraction:
    within 1e-6 (observed bit-equal)."""
    H, W = 33, 47
    cam = _look_at_cam(np.array([0.4, -2.7, 0.9]))
    K = _simple_K(H, W)
    coords = pixel_grid_coords(H, W)
    o_ref, d_ref = jax_ray_origins_and_directions(cam, K, coords)
    o, d = ray_origins_and_directions(cam, K, torch.from_numpy(coords))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=0, atol=1e-6)


def test_full_view():
    m = _sorted_blob(3)
    H = W = 48
    _compare(m, _look_at_cam(np.array([0.4, -2.7, 0.9])), _simple_K(H, W),
             _morton_grid(H, W), H, W)


def test_masked_morton_subset():
    """A Z-ordered masked subset padded by edge-repeat: packets span
    several screen tiles."""
    m = _sorted_blob(3)
    H = W = 48
    coords = pixel_grid_coords(H, W)
    rng = np.random.default_rng(0)
    mask = rng.uniform(size=coords.shape[0]) < 0.35
    mask[: H * W // 2] |= rng.uniform(size=H * W // 2) < 0.4
    sub = coords[mask]
    sub = sub[pixel_morton_order(sub)]
    pad = -(-sub.shape[0] // 1024) * 1024 - sub.shape[0]
    sub = np.pad(sub, ((0, pad), (0, 0)), mode="edge")
    _compare(m, _look_at_cam(np.array([0.0, -2.5, 0.4])), _simple_K(H, W), sub, H, W)


def test_low_poly_all_overflow():
    """icosphere(1): every face projects wider than 2x2 tiles, so all land
    in the overflow segment (the exact brute-force path)."""
    m = jax_icosphere(1)
    m.faces = m.faces[face_morton_order(m.vertices, m.faces)]
    H = W = 48
    _compare(m, _look_at_cam(np.array([0.0, -2.2, 0.0])), _simple_K(H, W),
             _morton_grid(H, W), H, W)


def test_camera_inside_mesh():
    m = _sorted_blob(3)
    H = W = 32
    cam = _look_at_cam(np.array([0.2, -0.1, 0.05]), target=np.array([1.0, 0.0, 0.0]))
    ref, _ = _compare(m, cam, _simple_K(H, W), _morton_grid(H, W), H, W)
    assert np.asarray(ref.valid).all()


def test_straddling_face_found_with_one_sided_hull():
    """A camera-plane-straddling face goes to overflow and is found for a
    one-sided pixel hull; a face entirely behind the camera is culled."""
    W = H = 512
    K = np.array([[500.0, 0, 256], [0, 500.0, 256], [0, 0, 1]], np.float32)
    cam = np.eye(3, 4, dtype=np.float32)
    verts = np.array([[0.2, -0.01, 1.0], [0.2, 0.01, 1.0], [0.0, 0.0, -1.0]], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    xs, ys = np.meshgrid(np.arange(400, 512), np.arange(250, 262))
    coords = np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1).astype(np.float32) + 0.5

    class M:
        pass

    m = M()
    m.vertices, m.faces = verts, faces
    ref, got = _compare(m, cam, K, coords, H, W)
    assert got.valid.any()

    m.vertices = verts.copy()
    m.vertices[:, 2] = -np.abs(m.vertices[:, 2]) - 0.1
    _, got_b = _compare(m, cam, K, coords, H, W)
    assert not got_b.valid.any()


def test_non_pinhole_K_rejected():
    verts = np.eye(3, dtype=np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    cam = np.eye(3, 4, dtype=np.float32)
    coords = np.zeros((4, 2), np.float32)
    bad = np.array([[500.0, 0, 8], [3.0, 500.0, 8], [0, 0, 1]], np.float32)
    with pytest.raises(ValueError, match="pinhole intrinsics"):
        intersect_coords_pinhole(verts, faces, cam, bad, coords, W=16, H=16, device="cpu")


def _numpy_walk(tables, origins, dirs, coords, Tx, Ty):
    """The JAX package's _traverse design in numpy, packet by packet: each
    1024-ray packet (the last one padded by repeating its last ray) walks
    its tile span, testing a chunk only when its depth bound is below the
    packet-wide frontier max(min(best_t, cap)), then the overflow segment up
    to the first chunk whose bound is not. Every f32 operation is the twin's
    and rounds alone. Returns (best_t, best_e, chunks reached, tested)."""
    f32, inf = np.float32, np.float32(np.inf)
    ed = tables.ed_rows.numpy()
    offsets, cze, czo = tables.offsets.numpy(), tables.czmin_e.numpy(), tables.czmin_o.numpy()
    smin, smax = tables.scene_min.numpy(), tables.scene_max.numpy()
    n_e = tables.e_pad // R.CHUNK
    n = origins.shape[0]
    pad = -(-n // R.RAY_TILE) * R.RAY_TILE - n
    o, d, c = (np.pad(np.ascontiguousarray(x.numpy()), ((0, pad), (0, 0)), mode="edge")
               for x in (origins, dirs, coords))

    def spread(v):
        v = v & 0xFFFF
        for shift, mask in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
            v = (v | (v << shift)) & mask
        return v

    def tile(x, m):
        return np.clip(np.clip(x / f32(R.TILE_PX), -1, m).astype(np.int32), 0, m - 1)

    best_t, best_e, reached, tested = [], [], 0, 0
    for p0 in range(0, n + pad, R.RAY_TILE):
        op, dp, cp = (x[p0:p0 + R.RAY_TILE] for x in (o, d, c))
        tid = spread(tile(cp[:, 0], Tx)) | (spread(tile(cp[:, 1], Ty)) << 1)
        c0 = offsets[tid.min()] // R.CHUNK
        c1 = min((offsets[tid.max() + 1] + R.CHUNK - 1) // R.CHUNK, n_e)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            d_safe = np.where(np.abs(dp) > f32(1e-12), dp,
                              np.where(dp < 0, f32(-1e-12), f32(1e-12)))
            t1, t2 = (smin - op) / d_safe, (smax - op) / d_safe
        t_near = np.minimum(t1, t2).max(axis=1)
        t_far = np.maximum(t1, t2).min(axis=1)
        cap = np.where(t_far >= np.maximum(t_near, f32(0)),
                       t_far * f32(1 + 1e-5) + f32(1e-4), -inf)
        bt = np.full(R.RAY_TILE, inf, f32)
        be = np.full(R.RAY_TILE, -1, np.int64)

        def test(s):
            e = ed[s:s + R.CHUNK]

            def dot(k):
                return (dp[:, 0:1] * e[:, k] + dp[:, 1:2] * e[:, k + 1]) + dp[:, 2:3] * e[:, k + 2]

            dn, dA, dB = dot(0), dot(3), dot(6)
            with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
                t = e[:, 9] / dn
                u = e[:, 10] + t * dA
                v = e[:, 11] + t * dB
                hit = ((np.abs(dn) > f32(1e-12)) & (t > f32(T_EPS)) & (u >= f32(-B_EPS))
                       & (v >= f32(-B_EPS)) & (u + v <= f32(1.0 + B_EPS)))
            tm = np.where(hit, t, inf)
            j = tm.argmin(axis=1)  # the first minimum
            t_c = tm[np.arange(R.RAY_TILE), j]
            better = t_c < bt
            bt[better], be[better] = t_c[better], s + j[better]

        for k in range(c0, c1):
            reached += 1
            if cze[k] < np.minimum(bt, cap).max():
                tested += 1
                test(k * R.CHUNK)
        for k in range(int(tables.o_chunks)):
            reached += 1
            if not czo[k] < np.minimum(bt, cap).max():
                break
            tested += 1
            test(tables.e_pad + k * R.CHUNK)
        best_t.append(bt)
        best_e.append(be)
    return np.concatenate(best_t)[:n], np.concatenate(best_e)[:n], reached, tested


def _masked_subset(H, W, seed=0):
    """A Z-ordered masked subset, not padded: packets span several screen
    tiles and the last one is ragged."""
    coords = pixel_grid_coords(H, W)
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=coords.shape[0]) < 0.35
    mask[: H * W // 2] |= rng.uniform(size=H * W // 2) < 0.4
    sub = coords[mask]
    return sub[pixel_morton_order(sub)]


def _overflow_mesh():
    m = jax_icosphere(1)
    m.faces = m.faces[face_morton_order(m.vertices, m.faces)]
    return m


WALK_SCENES = {
    "full_view": lambda: (_sorted_blob(3), _look_at_cam(np.array([0.4, -2.7, 0.9])), 48,
                          _morton_grid(48, 48)),
    "masked_subset": lambda: (_sorted_blob(3), _look_at_cam(np.array([0.0, -2.5, 0.4])), 48,
                              _masked_subset(48, 48)),
    "all_overflow": lambda: (_overflow_mesh(), _look_at_cam(np.array([0.0, -2.2, 0.0])), 48,
                             _morton_grid(48, 48)),
    "camera_inside": lambda: (_sorted_blob(3), _look_at_cam(np.array([0.2, -0.1, 0.05]),
                                                            target=np.array([1.0, 0.0, 0.0])),
                              32, _morton_grid(32, 32)),
}


def _walk_inputs(scene):
    mesh, cam, H, coords = WALK_SCENES[scene]()
    verts = torch.as_tensor(np.asarray(mesh.vertices, np.float32))
    faces = torch.as_tensor(np.asarray(mesh.faces, np.int64))
    tables, origins, dirs, _ = R.bin_view(verts, faces, cam, _simple_K(H, H),
                                          torch.from_numpy(coords), W=H, H=H)
    return tables, origins, dirs, torch.from_numpy(coords), -(-H // R.TILE_PX)


@pytest.mark.parametrize("scene", list(WALK_SCENES))
def test_lockstep_twin_equals_the_per_packet_walk(scene):
    """The lockstep twin against the JAX package's per-packet walk, written
    here in numpy: the same (best_t, best_e) to the bit, and the chunks the
    walks reached and tested that it adds to the open span, the counts the
    card's kernel adds."""
    tables, origins, dirs, coords, T = _walk_inputs(scene)
    want_t, want_e, reached, tested = _numpy_walk(tables, origins, dirs, coords, T, T)
    launches.reset_kernel_launches()
    with profile(activities=[ProfilerActivity.CPU]):
        with launches.span("walk"):
            got_t, got_e = R.traverse_plain(tables, origins, dirs, coords, Tx=T, Ty=T)
    (walk,) = [r for r in launches.spans(0, 2 ** 63 - 1)[0] if r["name"] == "walk"]
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    assert np.isfinite(want_t).any()
    assert walk["attrs"]["chunks"] == reached and walk["attrs"]["chunks_tested"] == tested
    assert 0 < tested <= reached
    assert walk["attrs"]["chunk_steps"] > 0


def test_traverse_on_cpu_tensors_takes_the_twin():
    """CPU tensors: traverse is the twin, and no raster_traverse launch is
    counted."""
    tables, origins, dirs, coords, T = _walk_inputs("masked_subset")
    before = launches.kernel_launches()
    got = R.traverse(tables, origins, dirs, coords, Tx=T, Ty=T)
    want = R.traverse_plain(tables, origins, dirs, coords, Tx=T, Ty=T)
    assert launches.kernel_launches() == before and "raster_traverse" in before
    assert all(torch.equal(g, w) for g, w in zip(got, want))


BAD_OPERANDS = {
    "dirs_column_major": lambda t, o, d, c: (t, o, d.t().contiguous().t(), c),
    "coords_f64": lambda t, o, d, c: (t, o, d, c.double()),
    "coords_short": lambda t, o, d, c: (t, o, d, c[:-1]),
    "origins_stride_6": lambda t, o, d, c: (t, torch.cat([o, o], 1)[:, :3], d, c),
    "offsets_short": lambda t, o, d, c: (t._replace(offsets=t.offsets[:-1]), o, d, c),
    "czmin_e_f64": lambda t, o, d, c: (t._replace(czmin_e=t.czmin_e.double()), o, d, c),
    "ed_rows_ragged": lambda t, o, d, c: (t._replace(ed_rows=t.ed_rows[:-1]), o, d, c),
}


@pytest.mark.parametrize("bad", list(BAD_OPERANDS))
def test_kernel_operand_checks_refuse_bad_input(bad):
    """The checks the wrapper runs before it hands pointers to the kernel:
    the view's own operands pass (with the shared origin broadcast), and
    each bad one raises."""
    tables, origins, dirs, coords, T = _walk_inputs("masked_subset")
    assert origins.stride(0) == 0
    R._check_traverse_operands(tables, origins, dirs, coords, T, T)
    with pytest.raises(ValueError, match="traverse: "):
        R._check_traverse_operands(*BAD_OPERANDS[bad](tables, origins, dirs, coords), T, T)


def test_traverse_refuses_other_devices():
    tables, origins, dirs, coords, T = _walk_inputs("masked_subset")
    meta = [x.to("meta") for x in (origins, dirs, coords)]
    with pytest.raises(ValueError, match="unsupported device"):
        R.traverse(tables, *meta, Tx=T, Ty=T)


def _binned(scene, mesh_table=None):
    """bin_view of a walk scene under torch.profiler: (tables, the
    raster.bin span's attributes)."""
    mesh, cam, H, coords = WALK_SCENES[scene]()
    verts = torch.as_tensor(np.asarray(mesh.vertices, np.float32))
    faces = torch.as_tensor(np.asarray(mesh.faces, np.int64))
    if mesh_table is not None:
        mesh_table = mesh_table(verts, faces)
    launches.reset_kernel_launches()
    with profile(activities=[ProfilerActivity.CPU]):
        tables = R.bin_view(verts, faces, cam, _simple_K(H, H), torch.from_numpy(coords),
                            W=H, H=H, mesh_table=mesh_table)[0]
    (rec,) = [r for r in launches.spans(0, 2 ** 63 - 1)[0] if r["name"] == "raster.bin"]
    return tables, rec["attrs"]


@pytest.mark.parametrize("scene", list(WALK_SCENES))
def test_kept_face_table_bins_as_one_built_in_the_call(scene):
    """Binning with a face table built before the view (and kept) gives
    the tables of binning that builds it in the call, field by field; the
    span says which it was, and counts the twin's two sort calls."""
    def prebuilt(verts, faces):
        table = R.MeshTable(verts, faces)
        table.get()
        return table

    built, b_attrs = _binned(scene)
    kept, k_attrs = _binned(scene, prebuilt)
    for field, g, w in zip(kept._fields, kept, built):
        assert (torch.equal(g, w) if isinstance(g, torch.Tensor) else g == w), field
    assert b_attrs == {"mesh_hit": 0, "launches": 2}
    assert k_attrs == {"mesh_hit": 1, "launches": 2}
    assert launches.kernel_launches()["raster_bin"] == 0  # the twin launches nothing


def test_entry_cap_demotes_whole_faces_and_loses_no_hit():
    """128 triangles around one tile corner emit four entries each, twice
    the ~2F cap: the faces that miss it go whole to the overflow segment,
    and the trace's hits are the brute-force sweep's (intersect_rays
    without culling, the same per-pair arithmetic), to the bit."""
    from intrinsic_neural_fields_tpu_torch.ops.intersect import intersect_rays

    from tests.test_torch_port_cuda import corner_stack

    mesh, cam, K = corner_stack()
    H = W = 64
    coords = torch.from_numpy(_morton_grid(H, W))
    verts, faces = torch.from_numpy(mesh.vertices), torch.from_numpy(mesh.faces)
    tables = R.bin_view(verts, faces, cam, K, coords, W=W, H=H)[0]
    assert int(tables.lost_faces) == 64 and int(tables.o_chunks) == 1
    got = R.intersect_coords_pinhole_core(verts, faces, cam, K, coords, W=W, H=H)
    origins, dirs = ray_origins_and_directions(cam, K, coords)
    want = intersect_rays(verts, faces, origins, dirs, cull=False, shared_origin=True)
    for field in ("valid", "face_idx", "t", "bary"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert (got.face_idx >= 64).sum() > 100  # the demoted faces are the nearest


def test_bin_faces_refuses_other_devices():
    _, cam, H, coords = WALK_SCENES["masked_subset"]()
    table = R.FaceTable(*(torch.empty(0, device="meta") for _ in R.FaceTable._fields))
    hull = np.stack([coords.min(0), coords.max(0)])
    with pytest.raises(ValueError, match="unsupported device"):
        R.bin_faces(table, cam, _simple_K(H, H), hull, H, H)


BAD_TABLES = {
    "c_short": lambda t, h: (t._replace(c=t.c[:-1]), h),
    "tri_f64": lambda t, h: (t._replace(tri=t.tri.double()), h),
    "ok_int": lambda t, h: (t._replace(ok=t.ok.int()), h),
    "a_column_major": lambda t, h: (t._replace(a=t.a.t().contiguous().t()), h),
    "hull_3x2": lambda t, h: (t, torch.zeros(3, 2)),
}


@pytest.mark.parametrize("bad", list(BAD_TABLES))
def test_bin_kernel_operand_checks_refuse_bad_input(bad):
    """The checks the kernels' wrapper runs before it hands pointers to the
    card (they run on any device): each bad face table or hull raises."""
    mesh, cam, H, coords = WALK_SCENES["masked_subset"]()
    table = R.face_table(torch.as_tensor(np.asarray(mesh.vertices, np.float32)),
                         torch.as_tensor(np.asarray(mesh.faces, np.int64)))
    hull = torch.as_tensor(np.stack([coords.min(0), coords.max(0)]))
    table, hull = BAD_TABLES[bad](table, hull)
    with pytest.raises(ValueError, match="bin_faces: "):
        R.bin_faces_kernel(table, cam, _simple_K(H, H), hull, H, H)
