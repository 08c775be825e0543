"""The port's KITTI360 data preparation (``text2pos_torch/data/{ply,voxel,
native,cluster,prepare,legacy,images,prepare_images}.py``) against the JAX
package's on the same inputs, and the ``--dataset K360`` / ``--base_path``
paths it opens (``utils/cli.py``, the server's CLI, the evaluator's).

Tolerances: none. PLY arrays, voxel indices, DBSCAN labels (element for
element: the descriptions read the numbering), host-FPS indices, and the
golden scene's objects' points are equal bit for bit; cells, poses and
descriptions compare field by field with ``==`` / ``array_equal``.
"""

import io
import json
import os
import os.path as osp
import pickle
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from test_prepare_golden import SCENE, _write_fixture
from text2pos_tpu.config import PrepareConfig as JPrepareConfig
from text2pos_tpu.data import native as jnative
from text2pos_tpu.data.cluster import dbscan_labels as jdbscan
from text2pos_tpu.data.ply import read_ply as jread_ply
from text2pos_tpu.data.prepare import prepare_scene as jprepare_scene
from text2pos_tpu.data.prepare import save_dataset as jsave_dataset
from text2pos_tpu.data.voxel import voxel_downsample_indices as jvoxel
from text2pos_tpu.utils.cli import load_split as jload_split
from text2pos_torch.config import PrepareConfig
from text2pos_torch.constants import (SCENE_NAMES_TEST, SCENE_NAMES_TRAIN,
                                      SCENE_NAMES_VAL)
from text2pos_torch.data import cluster, legacy, native, prepare
from text2pos_torch.data.ply import load_points, read_ply
from text2pos_torch.data.structs import Cell, Pose
from text2pos_torch.data.voxel import voxel_downsample_indices

torch.set_num_threads(2)

GOLDEN = dict(cell_size=30.0, cell_dist=10.0, pose_dist=10.0, pose_count=1,
              shift_poses=True, grid_cells=True, num_mentioned=6,
              describe_by="all", seed=4096)


def _clusters(rng, n_blobs=6, per=120, noise=40):
    """Gaussian blobs (some touching) plus uniform noise, f64."""
    centers = rng.uniform(-8, 8, size=(n_blobs, 3))
    pts = [c + rng.normal(scale=0.6, size=(per, 3)) for c in centers]
    pts.append(rng.uniform(-12, 12, size=(noise, 3)))
    return rng.permutation(np.concatenate(pts))


def _write_ply(path, cols, fmt):
    """A PLY with the given vertex columns [(name, ply type, array)]."""
    n = len(cols[0][2])
    header = (f"ply\nformat {fmt} 1.0\nelement vertex {n}\n"
              + "".join(f"property {t} {name}\n" for name, t, _ in cols)
              + "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if fmt == "ascii":
            for i in range(n):
                f.write((" ".join(str(c[2][i]) for c in cols) + "\n")
                        .encode())
        else:
            np_t = {"float": "<f4", "uchar": "u1", "int": "<i4",
                    "double": "<f8", "ushort": "<u2"}
            rec = np.zeros(n, [(name, np_t[t]) for name, t, _ in cols])
            for name, _, a in cols:
                rec[name] = a
            f.write(rec.tobytes())


@pytest.mark.parametrize("fmt", ["binary_little_endian", "ascii"])
def test_ply_round_trip_matches_jax(tmp_path, fmt):
    rng = np.random.default_rng(0)
    n = 57
    xyz = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    cols = [("x", "float", xyz[:, 0]), ("y", "float", xyz[:, 1]),
            ("z", "float", xyz[:, 2])]
    cols += [(c, "uchar", rng.integers(0, 256, n).astype(np.uint8))
             for c in ("red", "green", "blue")]
    cols += [("semanticID", "int", rng.integers(0, 45, n).astype(np.int32)),
             ("instanceID", "int", rng.integers(0, 9, n).astype(np.int32))]
    path = str(tmp_path / f"s.{fmt}.ply")
    _write_ply(path, cols, fmt)
    got, want = read_ply(path), jread_ply(path)
    assert got.keys() == want.keys() == {c[0] for c in cols}
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    for name, _, a in cols:
        np.testing.assert_array_equal(got[name], a)
    x, rgb, sem, inst = load_points(path)
    np.testing.assert_array_equal(x, xyz.astype(np.float64))
    assert rgb.max() <= 1.0
    np.testing.assert_array_equal(sem, cols[6][2])
    np.testing.assert_array_equal(inst, cols[7][2])


def test_ply_rejects_short_ascii_rows(tmp_path):
    path = tmp_path / "bad.ply"
    path.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 2\n"
                     b"property float x\nproperty float y\nend_header\n"
                     b"1 2\n3\n")
    with pytest.raises(ValueError):
        read_ply(str(path))


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """JAX's own C++ library, built with its own Makefile into a private
    directory, so that the parity tests compare with its C++ rather than
    its quiet NumPy fallback. Its loader builds ``native/`` in place with
    no lock and remembers a failed load: test workers that collect
    ``tests/test_native.py`` at once race on that file, and one that loads
    it half written gets no library."""
    src = jnative._NATIVE_DIR
    dst = tmp_path_factory.mktemp("jax_native")
    for name in ("Makefile", "t2p_native.cpp"):
        shutil.copy(osp.join(src, name), dst / name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_NATIVE_DIR", str(dst))
        mp.setattr(jnative, "_LIB_PATH", str(dst / "libt2p_native.so"))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_load_attempted", False)
        assert jnative.get_lib() is not None, "JAX's native library"
        yield jnative


@pytest.mark.parametrize("voxel", [0.1, 0.25, 1.0])
def test_voxel_native_numpy_and_jax_equal(voxel, jax_native):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-20, 20, (5000, 3))
    pts[::7] = pts[::7].round(1)       # points on voxel faces
    got = voxel_downsample_indices(pts, voxel)
    np.testing.assert_array_equal(
        got, voxel_downsample_indices(pts, voxel, force_numpy=True))
    np.testing.assert_array_equal(got, jvoxel(pts, voxel))
    np.testing.assert_array_equal(got, jvoxel(pts, voxel, force_numpy=True))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dbscan_labels_equal_jax_element_for_element(seed, jax_native):
    """The port's C++ and NumPy labels and JAX's (its ``auto``: its own C++
    library) are the same array; sklearn's is the same partition."""
    rng = np.random.default_rng(seed)
    pts = _clusters(rng)
    got = cluster.dbscan_labels(pts)
    want = jdbscan(pts)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, cluster.dbscan_labels(pts,
                                                             backend="numpy"))
    np.testing.assert_array_equal(got, cluster.dbscan_labels(
        pts, force_numpy=True))
    np.testing.assert_array_equal(got, native.dbscan_labels(pts, 0.75, 5))
    sk = cluster.dbscan_labels(pts, backend="sklearn")
    core = (sk >= 0) & (got >= 0)
    assert np.array_equal(sk < 0, got < 0)
    same = lambda a: a[:, None] == a[None, :]
    np.testing.assert_array_equal(same(sk)[core][:, core],
                                  same(got)[core][:, core])
    assert got.max() >= 2                   # real clusters were found


def test_dbscan_backends_and_native_build():
    """``auto`` is the C++ library, built into ``_build/host-*`` (never the
    JAX package's ``native/``); unknown backends raise."""
    from text2pos_torch.ops import _build

    lib = native.get_lib()
    assert "host-" in lib._name and "text2pos_torch" in lib._name
    assert osp.dirname(jnative._LIB_PATH) not in lib._name
    with pytest.raises(ValueError, match="backend"):
        cluster.dbscan_labels(np.zeros((3, 3)), backend="open3d")
    assert cluster.dbscan_labels(np.zeros((0, 3))).shape == (0,)
    assert _build.HOST_SRC.name == "native"


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No quiet fallback: a compiler that fails raises with its message."""
    from text2pos_torch.ops import _build

    bad = tmp_path / "native"
    bad.mkdir()
    (bad / "t2p_native.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "HOST_SRC", bad)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for t2p_native"):
        native.get_lib()


@pytest.mark.parametrize("n, s, start", [(1, 1, 0), (500, 64, 0),
                                         (777, 100, 13)])
def test_host_fps_matches_jax(n, s, start, jax_native):
    rng = np.random.default_rng(n)
    pts = rng.normal(size=(n, 3))
    pts[n // 2:] = pts[: n - n // 2]           # duplicates: ties
    got = native.fps_indices(pts, s, start)
    np.testing.assert_array_equal(got, jnative.fps_indices(pts, s, start))
    np.testing.assert_array_equal(got, native.fps_indices_numpy(pts, s, start))


def _objects_equal(a, b):
    assert (a.id, a.instance_id, a.label) == (b.id, b.instance_id, b.label)
    np.testing.assert_array_equal(a.xyz, b.xyz)
    np.testing.assert_array_equal(a.rgb, b.rgb)


def assert_cells_equal(got, want):
    assert [c.id for c in got] == [c.id for c in want]
    for c, w in zip(got, want):
        assert type(c).__module__ == "text2pos_torch.data.structs"
        assert (c.scene_name, c.cell_size) == (w.scene_name, w.cell_size)
        np.testing.assert_array_equal(c.bbox_w, w.bbox_w)
        assert len(c.objects) == len(w.objects)
        for a, b in zip(c.objects, w.objects):
            _objects_equal(a, b)


DESC_FIELDS = ("object_id", "object_instance_id", "object_label",
               "object_color_rgb", "object_color_text", "direction",
               "offset_center", "offset_closest", "closest_point",
               "is_matched", "best_offset_center", "best_offset_closest")


def assert_poses_equal(got, want):
    assert len(got) == len(want)
    for p, w in zip(got, want):
        assert (p.cell_id, p.scene_name, p.described_by) == (
            w.cell_id, w.scene_name, w.described_by)
        np.testing.assert_array_equal(p.pose, w.pose)
        np.testing.assert_array_equal(p.pose_w, w.pose_w)
        assert len(p.descriptions) == len(w.descriptions)
        for d, e in zip(p.descriptions, w.descriptions):
            for f in DESC_FIELDS:
                a, b = getattr(d, f, None), getattr(e, f, None)
                if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
                    np.testing.assert_array_equal(a, b, err_msg=f)
                else:
                    assert a == b, f


def _prepare_both(root, scene=SCENE):
    """The golden scene written twice (the objects cache is per input
    directory) and prepared by each package."""
    out = {}
    for name, cfg_cls, prep in (("jax", JPrepareConfig, jprepare_scene),
                                ("torch", PrepareConfig,
                                 prepare.prepare_scene)):
        path = osp.join(root, name)
        _write_fixture_as(path, scene)
        out[name] = prep(cfg_cls(path_in=path, scene_name=scene, **GOLDEN))
    return out


def _write_fixture_as(path, scene):
    """The golden KITTI360-layout scene under the drive name ``scene``."""
    _write_fixture(path)
    if scene != SCENE:
        for sub in ("data_3d_semantics", "data_poses"):
            os.rename(osp.join(path, sub, SCENE), osp.join(path, sub, scene))


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    return _prepare_both(str(tmp_path_factory.mktemp("golden")))


def test_golden_scene_cells_and_poses_equal_jax(golden):
    """Locations, cells and poses of the hand-written KITTI360 scene, with
    its stuff objects split by DBSCAN: the objects' points bit for bit,
    every description field equal."""
    (jc, jp), (tc, tp) = golden["jax"], golden["torch"]
    assert len(tc) == 7 and len(tp) == 15
    assert_cells_equal(tc, jc)
    assert_poses_equal(tp, jp)
    assert any(o.label == "road" for c in tc for o in c.objects)


def test_prepare_cli_and_objects_cache(tmp_path):
    """``python -m text2pos_torch.data.prepare`` writes the pickles under
    ``dirname``; a second run reads the objects cache through the
    restricted unpickler, as does a cache JAX wrote."""
    path = str(tmp_path / "in")
    _write_fixture(path)
    argv = ["--path_in", path, "--path_out", str(tmp_path / "out"),
            "--scene_name", SCENE, "--pose_count", "1", "--shift_poses",
            "--grid_cells"]
    out_dir = prepare.main(argv)
    cfg = PrepareConfig(path_in=path, scene_name=SCENE, pose_count=1,
                        shift_poses=True, grid_cells=True)
    assert out_dir == osp.join(str(tmp_path / "out"), cfg.dirname)
    first = legacy.load_reference_scene(out_dir, SCENE)
    assert osp.isfile(osp.join(path, f"objects_{SCENE}.pkl"))
    again = prepare.prepare_scene(cfg)
    assert_cells_equal(again[0], first[0])
    assert_poses_equal(again[1], first[1])
    # JAX's objects cache read by the port.
    jpath = str(tmp_path / "jin")
    _write_fixture(jpath)
    jcells, jposes = jprepare_scene(JPrepareConfig(
        path_in=jpath, scene_name=SCENE, pose_count=1, shift_poses=True,
        grid_cells=True))
    tcells, tposes = prepare.prepare_scene(PrepareConfig(
        path_in=jpath, scene_name=SCENE, pose_count=1, shift_poses=True,
        grid_cells=True))
    assert_cells_equal(tcells, jcells)
    assert_poses_equal(tposes, jposes)


def _as_reference(obj, mod):
    """``obj`` re-made as an instance of the reference class of its name
    in module ``mod`` (attribute bags, as the reference's classes are)."""
    if isinstance(obj, list):
        return [_as_reference(o, mod) for o in obj]
    name = type(obj).__name__
    if name not in ("Object3d", "Cell", "Pose", "DescriptionBestCell",
                    "DescriptionPoseCell"):
        return obj
    x = getattr(mod, name).__new__(getattr(mod, name))
    if hasattr(obj, "__slots__"):
        state = {k: getattr(obj, k) for k in obj.__slots__}
    else:
        state = dict(obj.__dict__)
    if name == "Cell":
        state = dict(scene_name=obj.scene_name, id=obj.id,
                     objects=_as_reference(obj.objects, mod),
                     cell_size=obj.cell_size, bbox_w=obj.bbox_w)
    if name == "Pose":
        state["descriptions"] = _as_reference(obj.descriptions, mod)
    x.__dict__.update(state)
    return x


@pytest.mark.parametrize("module", ["datapreparation.kitti360pose.imports",
                                    "datapreparation.kitti360.imports"])
def test_load_scenes_reference_pickles(golden, tmp_path, module):
    """Pickles of the reference's own classes (under either of its module
    paths) load as the port's structs equal to the originals; no module is
    left in ``sys.modules``."""
    tc, tp = golden["torch"]
    parts = module.split(".")
    made = []
    for i in range(1, len(parts) + 1):
        name = ".".join(parts[:i])
        if name not in sys.modules:
            sys.modules[name] = types.ModuleType(name)
            made.append(name)
    mod = sys.modules[module]
    saved = {}
    for cls in ("Object3d", "Cell", "Pose", "DescriptionBestCell"):
        saved[cls] = getattr(mod, cls, None)
        setattr(mod, cls, type(cls, (), {"__module__": module}))
    try:
        for sub, data in (("cells", tc), ("poses", tp)):
            os.makedirs(tmp_path / sub)
            with open(tmp_path / sub / f"{SCENE}.pkl", "wb") as f:
                pickle.dump(_as_reference(data, mod), f)
    finally:
        for cls, old in saved.items():
            if old is None:
                delattr(mod, cls)
            else:
                setattr(mod, cls, old)
        for name in made:
            del sys.modules[name]
    before = set(sys.modules)
    cells, poses = legacy.load_scenes(str(tmp_path), [SCENE])
    assert set(sys.modules) == before
    assert isinstance(cells[0], Cell) and isinstance(poses[0], Pose)
    assert_cells_equal(cells, tc)
    assert_poses_equal(poses, tp)


def test_load_scenes_jax_pickles_and_unique_ids(golden, tmp_path):
    """Pickles JAX's ``save_dataset`` wrote load as the port's structs;
    the same scene twice trips the check that cell ids are unique; any
    other global is refused."""
    jc, jp = golden["jax"]
    jsave_dataset(jc, jp, str(tmp_path), SCENE)
    cells, poses = legacy.load_scenes(str(tmp_path), [SCENE])
    assert_cells_equal(cells, jc)
    assert_poses_equal(poses, jp)
    with pytest.raises(AssertionError, match="cell ids repeat"):
        legacy.load_scenes(str(tmp_path), [SCENE, SCENE])
    bad = tmp_path / "bad.pkl"
    bad.write_bytes(pickle.dumps(os.system))
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        legacy.load_pickle(str(bad))


@pytest.fixture(scope="module")
def k360_base(tmp_path_factory):
    """The golden scene prepared by the port under every scene name of the
    three splits, in one ``--base_path``."""
    root = tmp_path_factory.mktemp("k360")
    base = str(root / "prepared")
    for scene in SCENE_NAMES_TRAIN + SCENE_NAMES_VAL + SCENE_NAMES_TEST:
        path = str(root / "in" / scene)
        _write_fixture_as(path, scene)
        cells, poses = prepare.prepare_scene(PrepareConfig(
            path_in=path, scene_name=scene, **GOLDEN))
        prepare.save_dataset(cells, poses, base, scene)
    return base


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_load_split_k360_matches_jax(k360_base, split):
    from text2pos_torch.config import TrainConfig
    from text2pos_torch.utils.cli import load_split
    from text2pos_tpu.config import TrainConfig as JTrainConfig

    cells, poses = load_split(TrainConfig(dataset="K360", base_path=k360_base,
                                          device="cpu"), split)
    jcells, jposes = jload_split(JTrainConfig(dataset="K360",
                                              base_path=k360_base), split)
    assert len({c.scene_name for c in cells}) == {
        "train": len(SCENE_NAMES_TRAIN), "val": 1,
        "test": len(SCENE_NAMES_TEST)}[split]
    assert_cells_equal(cells, jcells)
    assert_poses_equal(poses, jposes)


@pytest.fixture(scope="module")
def tiny_checkpoints(synthetic_data, tmp_path_factory):
    from test_torch_port_eval import save_tiny_checkpoints

    cells, poses = synthetic_data
    return save_tiny_checkpoints(cells, poses,
                                 tmp_path_factory.mktemp("k360ck"))


def test_evaluator_cli_k360_on_cpu(k360_base, tiny_checkpoints, capsys):
    """``python -m text2pos_torch.evaluation.pipeline --dataset K360``
    evaluates the prepared val scene (and the test scenes with
    ``--use_test_set``) and prints JAX's tables."""
    from text2pos_torch.evaluation import pipeline

    pc, pf = tiny_checkpoints
    common = ["--dataset", "K360", "--base_path", k360_base, "--device",
              "cpu", "--path_coarse", pc, "--path_fine", pf, "--batch_size",
              "4", "--pad_size", "8", "--pointnet_numpoints", "32",
              "--coarse_max_objects", "16", "--max_hint_len", "12",
              "--top_k", "1", "3"]
    pipeline.main(common)
    out = capsys.readouterr().out
    for table in ("Coarse", "Fine (mean)", "Fine (offsets)",
                  "Fine (mean-conf)"):
        assert table in out
    pipeline.main(common + ["--use_test_set", "--coarse_only"])
    assert "Coarse" in capsys.readouterr().out


def test_server_cli_base_path_on_cpu(k360_base, tiny_checkpoints,
                                     monkeypatch, capsys):
    """``python -m text2pos_torch.serving --base_path --scenes`` serves the
    prepared scenes: its stream equals an in-process server's on the same
    map, queries made from the prepared poses' descriptions."""
    from text2pos_torch import serving
    from text2pos_torch.config import ServeConfig
    from text2pos_torch.data.hints import create_hint_description

    pc, pf = tiny_checkpoints
    scenes = SCENE_NAMES_VAL + SCENE_NAMES_TEST[:1]
    cells, poses = legacy.load_scenes(k360_base, scenes)
    proto = dict(pad_size=8, num_mentioned=6, coarse_max_objects=16,
                 pointnet_numpoints=32, max_hint_len=12, max_text_len=64)
    hints = [create_hint_description(p) for p in poses[:6]]
    lines = [json.dumps({"hints": h, "id": i}) for i, h in enumerate(hints)]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines)))
    serving.main(["--path_coarse", pc, "--path_fine", pf, "--device", "cpu",
                  "--dtype", "float32", "--top_k", "3", "--batch", "4",
                  "--base_path", k360_base, "--scenes", ",".join(scenes),
                  *[a for k, v in proto.items() for a in (f"--{k}", str(v))]])
    got = [json.loads(line) for line in
           capsys.readouterr().out.strip().splitlines()]
    srv = serving.LocalizationServer(
        pc, pf, cells, cfg=ServeConfig(top_k=(1, 5, 3), **proto), top_k=3,
        dtype=None, device="cpu")
    want = [srv.localize(hints[:4]), srv.localize(hints[4:])]
    assert [r["id"] for r in got] == list(range(6))
    pos = np.concatenate([w["positions"] for w in want])
    ids = sum((list(w["cell_ids"]) for w in want), [])
    np.testing.assert_array_equal(np.array([r["position"] for r in got]),
                                  pos.astype(np.float64))
    assert [r["cell_id"] for r in got] == ids


def test_prepare_images_matches_jax(tmp_path):
    from text2pos_tpu.data.prepare_images import (
        create_poses_and_images as jcreate)
    from text2pos_torch.data.prepare_images import (create_poses_and_images,
                                                    save_splits)

    _write_fixture(str(tmp_path))
    got = create_poses_and_images(str(tmp_path), SCENE, 10.0, 3.0)
    want = jcreate(str(tmp_path), SCENE, 10.0, 3.0)
    for split in ("db", "query"):
        for k in ("frames", "poses"):
            np.testing.assert_array_equal(got[split][k], want[split][k])
        assert got[split]["images"] == want[split]["images"]
    assert len(got["db"]["frames"]) > 1 and len(got["query"]["frames"]) > 0
    save_splits(got, str(tmp_path / "out"), SCENE)
    back = legacy.load_pickle(str(tmp_path / "out" / f"{SCENE}_visloc.pkl"))
    np.testing.assert_array_equal(back["db"]["poses"], got["db"]["poses"])


def test_images_render_and_datasets_match_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from text2pos_tpu.data import images as jimages
    from text2pos_torch.data import images

    rng = np.random.default_rng(5)
    xyz = rng.uniform(-5, 5, (400, 3)) + np.array([10.0, 0, 1])
    rgb = rng.random((400, 3))
    kw = dict(eye=np.zeros(3), look_dir=np.array([1.0, 0.2, 0.0]),
              size=(64, 80), fov_deg=80.0, point_px=3)
    got = images.render_view(xyz, rgb, **kw)
    np.testing.assert_array_equal(got, jimages.render_view(xyz, rgb, **kw))
    assert got.any()
    root = tmp_path / "visloc" / SCENE / "db"
    root.mkdir(parents=True)
    poses = rng.normal(size=(3, 3))
    with open(root / "poses.pkl", "wb") as f:
        pickle.dump(poses, f)
    for i in range(3):
        cv2.imwrite(str(root / f"{i:05d}.png"),
                    rng.integers(0, 255, (8, 8, 3)).astype(np.uint8))
    ds = images.Kitti360ImageCompareDataset(str(tmp_path), SCENE, "db")
    jds = jimages.Kitti360ImageCompareDataset(str(tmp_path), SCENE, "db")
    assert len(ds) == len(jds) == 3
    for i in range(3):
        np.testing.assert_array_equal(ds[i]["poses"], jds[i]["poses"])
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"])


def test_drawing_matches_jax(golden):
    """``utils/drawing.py``'s images equal JAX's, pixel for pixel."""
    pytest.importorskip("cv2")
    from text2pos_tpu.utils import drawing as jdrawing
    from text2pos_torch.utils import drawing

    (jc, jp), (tc, tp) = golden["jax"], golden["torch"]
    cell = {c.id: c for c in tc}[tp[0].cell_id]
    jcell = {c.id: c for c in jc}[jp[0].cell_id]
    matches = np.array([0, -1, 2, 1] + [-1] * (len(cell.objects) - 4))
    for got, want in (
            (drawing.plot_cell(cell, 96, tp[0].pose),
             jdrawing.plot_cell(jcell, 96, jp[0].pose)),
            (drawing.plot_pose_in_best_cell(cell, tp[0], 96),
             jdrawing.plot_pose_in_best_cell(jcell, jp[0], 96)),
            (drawing.plot_matches_in_best_cell(cell, tp[0], matches, 96),
             jdrawing.plot_matches_in_best_cell(jcell, jp[0], matches, 96)),
            (drawing.plot_cells_and_poses(tc, tp, 120),
             jdrawing.plot_cells_and_poses(jc, jp, 120))):
        np.testing.assert_array_equal(got, want)
    retrievals = [[tc[(i + k) % len(tc)].id for k in range(3)]
                  for i in range(len(tp))]
    got = drawing.plot_retrievals(retrievals, tc, tp, count=2, size=64)
    want = jdrawing.plot_retrievals(retrievals, jc, jp, count=2, size=64)
    assert [ok for ok, _ in got] == [ok for ok, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_evaluator_plot_retrievals(k360_base, tiny_checkpoints, tmp_path,
                                   monkeypatch, capsys):
    """``--plot_retrievals`` writes the success and failure examples (then
    stops); without ``cv2`` it raises an ``ImportError`` naming it."""
    pytest.importorskip("cv2")
    from text2pos_torch.evaluation import pipeline

    pc, pf = tiny_checkpoints
    argv = ["--dataset", "K360", "--base_path", k360_base, "--device", "cpu",
            "--path_coarse", pc, "--path_fine", pf, "--batch_size", "4",
            "--pointnet_numpoints", "32", "--coarse_max_objects", "16",
            "--pad_size", "8", "--max_hint_len", "12", "--top_k", "1", "3",
            "--plot_retrievals"]
    monkeypatch.chdir(tmp_path)
    pipeline.main(argv)
    out = capsys.readouterr().out
    assert "wrote retrieval examples" in out and "Fine (mean)" not in out
    pngs = sorted(p.name for p in (tmp_path / "plots" / "retrievals").iterdir())
    assert pngs and all(p.startswith(("success_", "fail_")) for p in pngs)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        pipeline.main(argv)
