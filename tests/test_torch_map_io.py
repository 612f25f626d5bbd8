"""The port's map IO (``openvslam_tpu_torch/io/``, ``System.save_map_database``
/ ``load_map_database``), as tests/test_map_io.py, tests/test_msgpack_compat.py
and tests/test_camera_database.py::test_map_io_preserves_cameras hold the
JAX package's, at test_map_io's point: the plane scene, 25 frames, 416x320,
600 keypoints, 4 levels.  One map is built, by a port ``System(device="cpu")``;
its state is copied attribute by attribute into a JAX ``MapDatabase`` (the
attribute names are the same) for the interop tests:

* a map written by either package, in either schema, loads in the other,
  and ``convert.map_state`` of the two loads is equal column by column
  (the bearings of a reference-schema load to 1e-6: the port recomputes
  them from the raw keypoints, the JAX loader from the undistorted ones,
  identical inputs for this undistorted camera but not the same float32
  operations);
* the files the two packages write from one map state are byte-identical,
  in both schemas;
* the reference schema's rotations: the loaded rotation is the rotation of
  the unit quaternion the file stores (Eigen's conversion, the reference's
  and the JAX package's), within 1e-6.  When the saved float32 matrix has
  drifted off SO(3), that rotation is not the matrix, and not exactly its
  projection onto SO(3) either: the JAX package's
  ``test_roundtrip_into_fresh_db`` holds the loaded rotation to the raw
  matrix at 1e-5 and fails on its map, whose first keyframe's rotation has
  a diagonal entry of 1.000012 (1.18e-5 from the loaded one).  Here the
  loaded rotation is held to the quaternion's rotation (1e-6) and to the
  SO(3) projection within the saved matrix's own distance from SO(3).
"""
import copy
import os
import sys

import msgpack
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from openvslam_tpu.config import Config as JConfig  # noqa: E402
from openvslam_tpu.data.map_database import MapDatabase as JMapDatabase  # noqa: E402
from openvslam_tpu.io import map_database_io as jio  # noqa: E402
from openvslam_tpu.io import msgpack_compat as jmc  # noqa: E402
from openvslam_tpu.io import trajectory_io as jtio  # noqa: E402
from openvslam_tpu_torch.config import Config  # noqa: E402
from openvslam_tpu_torch.convert import map_database_from_state, map_state  # noqa: E402
from openvslam_tpu_torch.data.map_database import MapDatabase  # noqa: E402
from openvslam_tpu_torch.io import map_database_io as pio  # noqa: E402
from openvslam_tpu_torch.io import msgpack_compat as mc  # noqa: E402
from openvslam_tpu_torch.io import msgpack_codec  # noqa: E402
from openvslam_tpu_torch.io import trajectory_io as ptio  # noqa: E402
from openvslam_tpu_torch.module.tracking_module import TrackerState  # noqa: E402
from openvslam_tpu_torch.system import System  # noqa: E402
from openvslam_tpu_torch.utils import synthetic  # noqa: E402

CFG = {"Camera": {"name": "synthetic", "setup": "monocular", "model": "perspective",
                  "fx": 350.0, "fy": 350.0, "cx": 208.0, "cy": 160.0, "cols": 416,
                  "rows": 320, "fps": 20},
       "Feature": {"max_num_keypts": 600, "num_levels": 4, "scale_factor": 1.2},
       "LoopDetector": {"enabled": False}}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mapped():
    cfg = Config.from_dict(copy.deepcopy(CFG))
    cam = cfg.camera
    scene = synthetic.PlaneSceneRenderer(np.random.default_rng(21), x_range=(-5, 8),
                                         y_range=(-5, 5), plane_z=7.0, rows=cam.rows,
                                         cols=cam.cols)
    poses = np.stack([synthetic.lookat_pose_cw((x, 0, 0), (x, 0, 7))
                      for x in np.linspace(0.0, 4.0, 25)])
    s = System(cfg, vocab_path="default", device="cpu")
    s.startup()
    for i in range(len(poses)):
        s.feed_monocular_frame(scene.render(cam, poses[i]), i / 20.0)
    s.shutdown()
    return s, cfg, scene, poses


def _jax_db(db):
    """A JAX MapDatabase holding the port map's state."""
    jdb = JMapDatabase(kpt_capacity=db.K, max_kfs=1, max_lms=1)
    state = map_state(db)
    assert set(state) == set(vars(jdb))
    for k, v in state.items():
        setattr(jdb, k, v)
    return jdb


def _assert_states_equal(a, b, close=()):
    """map_state dicts equal entry by entry (``close``: float columns held
    to 1e-6)."""
    assert set(a) == set(b)
    for k in a:
        _assert_equal(a[k], b[k], k, k in close)


def _assert_equal(x, y, where, close):
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype, where
        if close:
            np.testing.assert_allclose(x, y, atol=1e-6, err_msg=where)
        else:
            assert np.array_equal(x, y), where
    elif isinstance(x, (list, tuple)):
        assert isinstance(y, (list, tuple)) and len(x) == len(y), where
        for i, (u, v) in enumerate(zip(x, y)):
            _assert_equal(u, v, f"{where}[{i}]", close)
    elif isinstance(x, dict):
        assert isinstance(y, dict) and list(x) == list(y), where
        for k in x:
            _assert_equal(x[k], y[k], f"{where}[{k}]", close)
    else:
        assert x == y, (where, x, y)


def _load_both(path, loader_p, loader_j, K):
    pdb, jdb = MapDatabase(kpt_capacity=K), JMapDatabase(kpt_capacity=K)
    loader_p(pdb, path)
    loader_j(jdb, path)
    return pdb, jdb


def _localize(s2, scene, cam, frames):
    s2.disable_mapping_module()
    s2.startup()
    s2.tracker.state = TrackerState.LOST
    before = (s2.map_db.n_kfs, len(s2.map_db.valid_lm_ids()))
    tracked = sum(s2.feed_monocular_frame(scene.render(cam, scene_pose), 100 + i / 20.0)
                  is not None for i, scene_pose in frames)
    s2.shutdown()
    assert (s2.map_db.n_kfs, len(s2.map_db.valid_lm_ids())) == before
    return tracked


# --- tests/test_map_io.py ---------------------------------------------------
def test_save_load_roundtrip(mapped, tmp_path):
    s, cfg, _, _ = mapped
    path = str(tmp_path / "map.msg")
    s.save_map_database(path)
    s2 = System(cfg, vocab_path=None, device="cpu")
    s2.load_map_database(path)
    db1, db2 = s.map_db, s2.map_db
    assert len(db2.valid_kf_ids()) == len(db1.valid_kf_ids())
    assert len(db2.valid_lm_ids()) == len(db1.valid_lm_ids())
    k1, k2 = int(db1.valid_kf_ids()[0]), int(db2.valid_kf_ids()[0])
    np.testing.assert_allclose(db1.kf_pose_cw[k1], db2.kf_pose_cw[k2], atol=1e-6)
    np.testing.assert_array_equal(db1.kf_desc_u32[k1], db2.kf_desc_u32[k2])
    l1, l2 = int(db1.valid_lm_ids()[5]), int(db2.valid_lm_ids()[5])
    assert db1.lm_num_obs[l1] == db2.lm_num_obs[l2]
    assert len(db2.covis[k2]) == len(db1.covis[k1])
    # every column, up to id compaction (chip_smoke phase 9's comparison),
    # and the rebuilt BoW database equal to the saving session's
    diff = chip_smoke.native_map_diff(db1, db2)
    diff.pop("stale_covis")
    assert not any(diff.values()), diff
    assert chip_smoke.bow_diff(db1, s.global_optimizer.bow_db, s2.global_optimizer.bow_db,
                               compacted=False)["ok"]


def test_localization_mode(mapped, tmp_path):
    s, cfg, scene, poses = mapped
    path = str(tmp_path / "map2.msg")
    s.save_map_database(path)
    s2 = System(cfg, vocab_path="default", device="cpu")
    s2.load_map_database(path)
    tracked = _localize(s2, scene, cfg.camera, [(i, poses[i]) for i in range(8, 16)])
    assert tracked >= 6, tracked
    _, poses1, _ = s.tracked_poses()
    _, poses2, _ = s2.tracked_poses()
    c1 = -poses1[10][:3, :3].T @ poses1[10][:3, 3]
    c2 = -poses2[2][:3, :3].T @ poses2[2][:3, 3]
    assert np.linalg.norm(c1 - c2) < 0.1


def test_localization_mode_pipelined(mapped, tmp_path):
    s, cfg, scene, poses = mapped
    cam = cfg.camera
    path = str(tmp_path / "map3.msg")
    s.save_map_database(path)
    s2 = System(cfg, vocab_path="default", device="cpu")
    s2.load_map_database(path)
    s2.disable_mapping_module()
    s2.startup()
    s2.tracker.state = TrackerState.LOST
    before = (s2.map_db.n_kfs, len(s2.map_db.valid_lm_ids()))
    out = list(s2.feed_sequence(((scene.render(cam, poses[i]), 100 + i / 20.0)
                                 for i in range(6, 18)), kind="monocular", depth=2))
    s2.shutdown()
    assert len(out) == 12
    assert sum(p is not None for _, p in out) >= 9
    assert s2._fused_frames > 0, "localization never used the fused path"
    assert (s2.map_db.n_kfs, len(s2.map_db.valid_lm_ids())) == before


# --- tests/test_msgpack_compat.py --------------------------------------------
def test_quat_codec_roundtrip():
    rng = np.random.default_rng(3)
    for _ in range(50):
        w = rng.standard_normal(3)
        th = np.linalg.norm(w)
        k = w / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
        q = mc.rot_to_quat_xyzw(R)
        assert q == jmc.rot_to_quat_xyzw(R)
        np.testing.assert_allclose(mc.quat_xyzw_to_rot(q), R, atol=1e-9)


def test_desc_codec_roundtrip():
    row = np.random.default_rng(4).integers(0, 2 ** 32, 8, dtype=np.uint32)
    buf = mc.desc_u32_to_bytes(row)
    assert isinstance(buf, bytes) and len(buf) == 32 and buf == jmc.desc_u32_to_bytes(row)
    np.testing.assert_array_equal(mc.desc_bytes_to_u32(buf), row)
    one = np.zeros(8, np.uint32)
    one[0] = 1
    assert mc.desc_u32_to_bytes(one)[0] == 0x01
    one[0] = 0x80
    assert mc.desc_u32_to_bytes(one)[0] == 0x80
    one[0] = 0x100
    assert mc.desc_u32_to_bytes(one)[1] == 0x01


def test_schema_shape(mapped, tmp_path):
    s, _, _, _ = mapped
    path = str(tmp_path / "ref_format.msg")
    s.save_map_database(path, format="openvslam")
    raw = open(path, "rb").read()
    blob = msgpack_codec.unpackb(raw)
    assert blob == msgpack.unpackb(raw, raw=False)
    for key in ("cameras", "keyframes", "landmarks", "frame_next_id", "keyframe_next_id",
                "landmark_next_id"):
        assert key in blob, key
    assert "format" not in blob and isinstance(blob["keyframes"], dict)
    kf = next(iter(blob["keyframes"].values()))
    for key in ("ts", "cam", "rot_cw", "trans_cw", "n_keypts", "keypts", "undists", "x_rights",
                "depths", "descs", "lm_ids", "span_parent", "span_children", "loop_edges",
                "n_scale_levels", "scale_factor"):
        assert key in kf, key
    assert len(kf["rot_cw"]) == 4 and len(kf["trans_cw"]) == 3
    assert kf["n_keypts"] == len(kf["keypts"]) == len(kf["descs"]) == len(kf["lm_ids"])
    assert isinstance(kf["descs"][0], bytes) and len(kf["descs"][0]) == 32
    assert set(kf["keypts"][0]) == {"pt", "ang", "oct"}
    lm = next(iter(blob["landmarks"].values()))
    for key in ("1st_keyfrm", "pos_w", "ref_keyfrm", "n_vis", "n_fnd"):
        assert key in lm, key
    cam_j = next(iter(blob["cameras"].values()))
    assert cam_j["model_type"] == "Perspective" and cam_j["setup_type"] == "Monocular"
    assert {"fx", "fy", "cx", "cy", "cols", "rows", "fps"} <= set(cam_j)


def test_roundtrip_into_fresh_db(mapped, tmp_path):
    s, cfg, _, _ = mapped
    path = str(tmp_path / "ref_roundtrip.msg")
    s.save_map_database(path, format="openvslam")
    assert mc.is_openvslam_format(path)
    s2 = System(cfg, vocab_path=None, device="cpu")
    s2.load_map_database(path)
    db1, db2 = s.map_db, s2.map_db
    ids1, ids2 = db1.valid_kf_ids(), db2.valid_kf_ids()
    assert len(ids1) == len(ids2) and len(db1.valid_lm_ids()) == len(db2.valid_lm_ids())
    drift = 0.0
    for k1, k2 in zip(ids1, ids2):
        T1, T2 = db1.kf_pose_cw[int(k1)].astype(np.float64), db2.kf_pose_cw[int(k2)]
        R1 = T1[:3, :3]
        proj = chip_smoke.so3_projection(R1)
        d = float(np.abs(R1 - proj).max())
        drift = max(drift, d)
        np.testing.assert_allclose(T2[:3, :3], mc.quat_xyzw_to_rot(mc.rot_to_quat_xyzw(R1)),
                                   atol=1e-6)
        assert float(np.abs(T2[:3, :3] - proj).max()) <= max(d, 1e-6)
        np.testing.assert_allclose(T2[:3, 3], T1[:3, 3], atol=1e-6)
    assert drift > 0.0        # float32 poses are never exactly on SO(3)
    row = chip_smoke.ref_map_diff(db1, db2)
    assert row["rot_vs_quaternion"] <= 1e-6 and row["trans"] <= 1e-6
    assert row["desc_multiset_kfs_differing"] == 0 and row["obs_count_multiset_equal"]
    k1, k2 = int(ids1[0]), int(ids2[0])
    assert len(db2.covis[k2]) == len(db1.covis[k1])
    assert (db2.parent[int(ids2[1])] >= 0) == (db1.parent[int(ids1[1])] >= 0)
    l2 = int(db2.valid_lm_ids()[0])
    assert db2.lm_max_dist[l2] > db2.lm_min_dist[l2] > 0
    assert abs(np.linalg.norm(db2.lm_normal[l2]) - 1) < 1e-4
    assert chip_smoke.bow_diff(db1, s.global_optimizer.bow_db, s2.global_optimizer.bow_db,
                               compacted=True)["ok"]


def test_localization_on_ref_format_map(mapped, tmp_path):
    s, cfg, scene, poses = mapped
    path = str(tmp_path / "ref_loc.msg")
    s.save_map_database(path, format="openvslam")
    s2 = System(cfg, vocab_path="default", device="cpu")
    s2.load_map_database(path)
    tracked = _localize(s2, scene, cfg.camera, [(i, poses[i]) for i in range(8, 16)])
    assert tracked >= 6, tracked
    _, poses1, _ = s.tracked_poses()
    _, poses2, _ = s2.tracked_poses()
    c1 = -poses1[10][:3, :3].T @ poses1[10][:3, 3]
    c2 = -poses2[2][:3, :3].T @ poses2[2][:3, 3]
    assert np.linalg.norm(c1 - c2) < 0.1


def test_camera_spec_conversion_all_models():
    for model, extra in (
            ("perspective", {"fx": 300, "fy": 300, "cx": 160, "cy": 120, "k1": -0.1,
                             "k2": 0.01, "p1": 1e-4, "p2": -1e-4, "k3": 0.0}),
            ("fisheye", {"fx": 250, "fy": 250, "cx": 160, "cy": 120, "k1": 0.02,
                         "k2": -0.003, "k3": 1e-4, "k4": -1e-5}),
            ("equirectangular", {})):
        spec = {"model": model, "setup": "monocular", "cols": 320, "rows": 240, "fps": 25.0,
                **extra}
        ref = mc.camera_spec_to_ref(spec)
        assert ref == jmc.camera_spec_to_ref(spec) and ref["model_type"].lower() == model
        back = mc.camera_spec_from_ref(ref)
        assert back == jmc.camera_spec_from_ref(ref) and back["model"] == model
        for k, v in extra.items():
            assert back[k] == pytest.approx(float(v))


def _stereo_db(cam_spec, K=64, n=10):
    """A port database holding one keyframe of ``n`` valid keypoints (of
    ``K``) with stereo columns, for the schema's column tests."""
    db = MapDatabase(kpt_capacity=K, max_kfs=8, max_lms=64)
    db.register_camera("st", cam_spec, make_default=True)
    rng = np.random.default_rng(0)
    kf = 0
    db.n_kfs = 1
    db.kf_valid[kf] = True
    db.kf_pose_cw[kf] = np.eye(4, dtype=np.float32)
    db.kf_timestamp[kf] = 1.25
    db.kf_src_frame[kf] = 3
    val = np.zeros(K, bool)
    val[:n] = True
    db.kf_kpt_valid[kf] = val
    db.kf_xy[kf] = rng.uniform(20, 200, (K, 2)).astype(np.float32)
    db.kf_level[kf] = np.zeros(K, np.int32)
    db.kf_angle[kf] = rng.uniform(-3, 3, K).astype(np.float32)
    db.kf_desc_u32[kf] = rng.integers(0, 2 ** 32, (K, 8), dtype=np.uint32)
    db.kf_desc_i8[kf] = pio.unpack_desc_i8(db.kf_desc_u32[kf])
    xr = np.full(K, -1.0, np.float32)
    xr[:n] = rng.uniform(10, 150, n)
    dep = np.full(K, -1.0, np.float32)
    dep[:n] = rng.uniform(0.5, 20, n)
    db.kf_x_right[kf], db.kf_depth[kf] = xr, dep
    db.kf_lm_idx[kf] = np.full(K, -1, np.int32)
    db.kf_camera[kf] = "st"
    cam = db.get_camera("st")
    xy = torch.from_numpy(db.kf_xy[kf])
    db.kf_xy_undist[kf] = cam.undistort_keypoints(xy).numpy()
    db.kf_bearing[kf] = cam.keypoints_to_bearings(xy).numpy()
    db.covis[kf], db.covis_ordered[kf] = {}, np.zeros(0, np.int32)
    db.children[kf], db.loop_edges[kf] = set(), set()
    db.parent[kf] = -1
    db.origin_kf = kf
    return db


def _stereo_cfg(**cam):
    return Config.from_dict({
        "Camera": {"name": "st", "setup": "stereo", "model": "perspective", "fx": 350.0,
                   "fy": 350.0, "cx": 160.0, "cy": 120.0, "cols": 320, "rows": 240, "fps": 20,
                   "focal_x_baseline": 40.0, **cam},
        "Feature": {"max_num_keypts": 64, "num_levels": 2}})


def test_stereo_columns_roundtrip(tmp_path):
    from openvslam_tpu_torch.camera.base import camera_to_config

    cfg = _stereo_cfg()
    db = _stereo_db(camera_to_config(cfg.camera))
    path = str(tmp_path / "stereo.msg")
    mc.save_map_openvslam(db, cfg, path)
    db2 = MapDatabase(kpt_capacity=64, max_kfs=8, max_lms=64)
    cam_j, _ = mc.load_map_openvslam(db2, path)
    assert db2.n_kfs == 1 and db2.kf_kpt_valid[0].sum() == 10
    np.testing.assert_allclose(db2.kf_x_right[0][:10], db.kf_x_right[0][:10], rtol=1e-6)
    np.testing.assert_allclose(db2.kf_depth[0][:10], db.kf_depth[0][:10], rtol=1e-6)
    np.testing.assert_array_equal(db2.kf_desc_u32[0][:10], db.kf_desc_u32[0][:10])
    cj = next(iter(cam_j.values()))
    assert cj["setup_type"] == "Stereo" and cj["focal_x_baseline"] == pytest.approx(40.0)


def test_reference_schema_bearings_come_from_the_raw_keypoints(tmp_path):
    """With a distorted camera the port's reference-schema load gives back
    the saving session's bearings (from the raw keypoints, as a frame
    computes them); the JAX loader passes the undistorted keypoints through
    the distortion model again and lands elsewhere (a reference-side
    condition of its loader)."""
    from openvslam_tpu_torch.camera.base import camera_to_config

    cfg = _stereo_cfg(k1=-0.3, k2=0.1, p1=1e-3, p2=-1e-3)
    db = _stereo_db(camera_to_config(cfg.camera))
    path = str(tmp_path / "distorted.msg")
    mc.save_map_openvslam(db, cfg, path)
    db2 = MapDatabase(kpt_capacity=64, max_kfs=8, max_lms=64)
    mc.load_map_openvslam(db2, path)
    np.testing.assert_allclose(db2.kf_bearing[0][:10], db.kf_bearing[0][:10], atol=1e-6)
    jdb = JMapDatabase(kpt_capacity=64, max_kfs=8, max_lms=64)
    jmc.load_map_openvslam(jdb, path)
    assert float(np.abs(jdb.kf_bearing[0][:10] - db.kf_bearing[0][:10]).max()) > 1e-3


# --- tests/test_camera_database.py::test_map_io_preserves_cameras ----------------
def test_map_io_preserves_cameras(mapped, tmp_path):
    """The map with a second copy of itself captured by another camera
    (camB, fx 300), merged: a session whose own camera collides by name
    with the map's (synthetic, fx 999) loads both cameras, suffixed and
    remapped, and keeps its own."""
    s, cfg, _, _ = mapped
    dbA = map_database_from_state(map_state(s.map_db))
    dbB = map_database_from_state(map_state(s.map_db))
    spec = dict(dbB.cameras["synthetic"], fx=300.0, fy=300.0)
    dbB.cameras = {"camB": spec}
    dbB.default_camera = "camB"
    dbB.kf_camera = ["camB" if c is not None else None for c in dbB.kf_camera]
    dbA.absorb(dbB)
    p = str(tmp_path / "multi.msg")
    pio.save_map(dbA, cfg, p)
    raw = dict(copy.deepcopy(CFG))
    raw["Camera"] = dict(CFG["Camera"], fx=999.0, fy=999.0)
    s2 = System(Config.from_dict(raw), device="cpu")
    s2.load_map_database(p)
    db2 = s2.map_db
    names = {db2.kf_camera[int(k)] for k in db2.valid_kf_ids()}
    assert len(names) == 2
    assert sorted(float(db2.get_camera(n).fx) for n in names) == [300.0, 350.0]
    assert float(db2.get_camera("synthetic").fx) == 999.0


# --- the two packages ----------------------------------------------------------
SCHEMAS = {"native": (pio.save_map, jio.save_map, pio.load_map, jio.load_map),
           "openvslam": (mc.save_map_openvslam, jmc.save_map_openvslam, mc.load_map_openvslam,
                         jmc.load_map_openvslam)}
# the bearings of a reference-schema load are recomputed (see the module
# docstring); every other column is exact
CLOSE = {"native": (), "openvslam": ("kf_bearing",)}


@pytest.mark.parametrize("schema", sorted(SCHEMAS))
def test_files_of_both_packages_are_byte_identical(mapped, tmp_path, schema):
    s, cfg, _, _ = mapped
    save_p, save_j, _, _ = SCHEMAS[schema]
    jdb = _jax_db(s.map_db)
    pp, pj = str(tmp_path / "port.msg"), str(tmp_path / "jax.msg")
    save_p(s.map_db, cfg, pp)
    save_j(jdb, JConfig.from_dict(copy.deepcopy(CFG)), pj)
    a, b = open(pp, "rb").read(), open(pj, "rb").read()
    assert a == b
    assert msgpack_codec.unpackb(a) == msgpack.unpackb(b, raw=False)


@pytest.mark.parametrize("schema", sorted(SCHEMAS))
def test_jax_written_map_loads_in_the_port(mapped, tmp_path, schema):
    s, _, _, _ = mapped
    _, save_j, load_p, load_j = SCHEMAS[schema]
    path = str(tmp_path / "jax.msg")
    save_j(_jax_db(s.map_db), JConfig.from_dict(copy.deepcopy(CFG)), path)
    pdb, jdb = _load_both(path, load_p, load_j, s.map_db.K)
    assert len(pdb.valid_kf_ids()) == len(s.map_db.valid_kf_ids())
    _assert_states_equal(map_state(pdb), map_state(jdb), close=CLOSE[schema])


@pytest.mark.parametrize("schema", sorted(SCHEMAS))
def test_port_written_map_loads_in_jax(mapped, tmp_path, schema):
    s, cfg, _, _ = mapped
    save_p, _, load_p, load_j = SCHEMAS[schema]
    path = str(tmp_path / "port.msg")
    save_p(s.map_db, cfg, path)
    pdb, jdb = _load_both(path, load_p, load_j, s.map_db.K)
    assert len(jdb.valid_lm_ids()) == len(s.map_db.valid_lm_ids())
    _assert_states_equal(map_state(jdb), map_state(pdb), close=CLOSE[schema])


def test_trajectory_files(mapped, tmp_path):
    """The System's trajectory writers: TUM and KITTI files that the port's
    readers read back (chip_smoke phase 9's check), byte-identical to the
    JAX package's writers on the same poses."""
    s, _, _, _ = mapped
    p = {n: str(tmp_path / n) for n in ("f.tum", "f.kitti", "k.tum", "j.tum", "j.kitti")}
    s.save_frame_trajectory(p["f.tum"], "TUM")
    s.save_frame_trajectory(p["f.kitti"], "KITTI")
    s.save_keyframe_trajectory(p["k.tum"])
    ts, poses, mask = s.composed_poses()
    assert chip_smoke.trajectory_readback(poses[mask], ts[mask], p["f.tum"], p["f.kitti"])["ok"]
    ids = s.map_db.valid_kf_ids()
    assert chip_smoke.trajectory_readback(s.map_db.kf_pose_cw[ids], s.map_db.kf_timestamp[ids],
                                          p["k.tum"])["ok"]
    jtio.save_trajectory_tum(p["j.tum"], list(ts[mask]), poses[mask])
    jtio.save_trajectory_kitti(p["j.kitti"], poses[mask])
    assert open(p["f.tum"]).read() == open(p["j.tum"]).read()
    assert open(p["f.kitti"]).read() == open(p["j.kitti"]).read()
    t_read, _ = ptio.load_trajectory_tum(p["f.tum"])
    assert len(t_read) == int(mask.sum()) >= 20
    with pytest.raises(ValueError):
        s.save_frame_trajectory(str(tmp_path / "x"), "EuRoC")
