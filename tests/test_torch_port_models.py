"""The port's checkpoint IO and modules against the JAX package.

msgpack reading against ``flax.serialization``; ``encode_text``,
``encode_hints`` and ``match_encoded`` against the flax modules at small
widths with seeded weights and randomized calibrated statistics, and once on
the committed ``bench_fine`` weights; the package's isolation from JAX and
its CUDA default.
"""

import ast
import os
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2pos_tpu.models.cell_retrieval import CellRetrievalNetwork as JCell
from text2pos_tpu.models.matcher import SuperGlueMatch as JMatch
from text2pos_torch.models.cell_retrieval import CellRetrievalNetwork
from text2pos_torch.models.matcher import SuperGlueMatch
from text2pos_torch.train.state import load_checkpoint
from text2pos_torch.utils.convert_jax import load_jax_params, module_to_jax
from text2pos_torch.utils.msgpack_io import msgpack_restore

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FINE = os.path.join(ROOT, "checkpoints", "bench_fine.msgpack")
COARSE = os.path.join(ROOT, "checkpoints", "bench_coarse.msgpack")
DB = os.path.join(ROOT, "checkpoints", "bench_db_cache.npz")
F32_TOL = 1e-4


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)):
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape, path
        if w.dtype.name == "bfloat16":   # the port widens bf16 to f32
            w = w.astype(np.float32)
        assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


class TestMsgpack:
    def test_synthetic_tree_matches_flax(self, monkeypatch):
        rng = np.random.default_rng(0)
        tree = {
            "f32": rng.standard_normal((3, 4)).astype(np.float32),
            "f64": rng.standard_normal(5),
            "i8": rng.integers(-128, 127, 7).astype(np.int8),
            "u8": rng.integers(0, 255, (2, 2, 2)).astype(np.uint8),
            "i64": np.array([-(2 ** 40), 2 ** 40]),
            "bool": np.array([True, False]),
            "bf16": np.asarray(jnp.asarray([1.5, -2.25, 3e5], jnp.bfloat16)),
            "empty": np.zeros((0, 3), np.float32),
            "scalar": np.float32(2.5),
            "iscalar": np.int64(-7),
            "cplx": complex(1.5, -2.0),
            "ints": [0, 127, 128, 255, 65536, 2 ** 33, -1, -33, -129,
                     -40000, -(2 ** 40)],
            "floats": [0.5, -1e300],
            "strs": ["", "a" * 40, "é" * 300, "x" * 70000],
            "bin": b"\x00\x01" * 200,
            "misc": [None, True, False, {"nested": [1, {"x": 2}]}],
            "big_map": {str(i): i for i in range(20)},
            "chunked": np.arange(1000, dtype=np.float32).reshape(10, 100),
        }
        # Force flax to chunk the large leaf as it does arrays over 1 GiB.
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
        data = flax.serialization.msgpack_serialize(tree)
        _assert_tree_equal(msgpack_restore(data),
                           flax.serialization.msgpack_restore(data))

    def test_bench_fine_checkpoint_matches_flax(self):
        with open(FINE, "rb") as f:
            data = f.read()
        _assert_tree_equal(msgpack_restore(data),
                           flax.serialization.msgpack_restore(data))

    def test_db_cache_batch_stats_match_flax(self):
        with np.load(DB) as z:
            data = z["batch_stats"].tobytes()
        got = msgpack_restore(data)
        _assert_tree_equal(got, flax.serialization.msgpack_restore(data))
        bn = got["superglue"]["gnn"]["layer_0"]["mlp"]["bn_0"]
        assert bn["mean"].shape == (2, 256)


def _count(tree):
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    return int(np.asarray(tree).size)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree).shape}


class TestConvert:
    def test_fine_round_trip(self):
        ck = load_checkpoint(FINE)
        with np.load(DB) as z:
            stats = msgpack_restore(z["batch_stats"].tobytes())
        model = SuperGlueMatch(32, 128, num_layers=6)
        unused = load_jax_params(model, ck["params"], stats)
        # Only PointNet's class and colour heads, which encoding never
        # reads, stay behind.
        heads = ("class_classifier", "color_classifier")
        assert unused and all(u.split("/")[-2] in heads for u in unused)
        params, back_stats = module_to_jax(model)
        want = {k: ck["params"][k] for k in params}
        pointnet = want["object_encoder"]["pointnet"]
        want["object_encoder"] = dict(want["object_encoder"], pointnet={
            k: v for k, v in pointnet.items() if k not in heads})
        assert _count(params) == _count(want) == sum(
            p.numel() for p in model.parameters())
        assert _shapes(params) == _shapes(want)
        _assert_tree_equal(params, jax.tree.map(
            lambda a: np.asarray(a, np.float32), want))
        assert _shapes(back_stats) == _shapes(stats)

    def test_coarse_round_trip(self):
        ck = load_checkpoint(COARSE)
        model = CellRetrievalNetwork(32, 256)
        load_jax_params(model, ck["params"], ck["batch_stats"])
        params, _ = module_to_jax(model)
        _assert_tree_equal(params["language_encoder"],
                           ck["params"]["language_encoder"])


def _randomize_stats(stats, seed):
    """Non-trivial per-set statistics (init gives mean 0 / var 1)."""
    rng = np.random.default_rng(seed)

    def f(path, v):
        v = np.asarray(v)
        if path[-1].key == "var":
            return rng.uniform(0.3, 2.0, v.shape).astype(np.float32)
        return (0.3 * rng.standard_normal(v.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, stats)


def _tokens(rng, B, T, vocab, H=None):
    shape = (B, T) if H is None else (B, H, T)
    lengths = rng.integers(1, T + 1, shape[:-1]).astype(np.int32)
    tokens = rng.integers(0, vocab, shape).astype(np.int32)
    tokens[np.arange(T) >= lengths[..., None]] = 0
    return tokens, lengths


class TestModules:
    VOCAB, E, LAYERS = 20, 32, 2

    def test_encode_text_matches_jax(self):
        rng = np.random.default_rng(0)
        tokens, lengths = _tokens(rng, 9, 12, self.VOCAB)
        jm = JCell(vocab_size=self.VOCAB, embed_dim=self.E, num_classes=4,
                   num_colors=3)
        variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens),
                            jnp.asarray(lengths), method=JCell.encode_text)
        want = np.asarray(jm.apply(variables, jnp.asarray(tokens),
                                   jnp.asarray(lengths),
                                   method=JCell.encode_text))
        tm = CellRetrievalNetwork(self.VOCAB, self.E)
        # The flax tree of encode_text holds the text tower only.
        load_jax_params(tm.language_encoder,
                        jax.device_get(variables["params"])["language_encoder"])
        got = tm.encode_text(torch.from_numpy(tokens),
                             torch.from_numpy(lengths)).detach().numpy()
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)

    @pytest.fixture(scope="class")
    def small_matcher(self):
        """flax SuperGlueMatch (calibrated eval mode, bn_stat_groups=2)
        with seeded weights and randomized per-set statistics."""
        rng = np.random.default_rng(1)
        tokens, lengths = _tokens(rng, 3, 8, self.VOCAB, H=6)
        jm = JMatch(vocab_size=self.VOCAB, embed_dim=self.E,
                    num_layers=self.LAYERS, sinkhorn_iters=20,
                    eval_batch_stats=False, bn_stat_groups=2)
        key = jax.random.PRNGKey(1)
        v_h = jm.init(key, jnp.asarray(tokens), jnp.asarray(lengths),
                      method=JMatch.encode_hints)
        obj = jnp.asarray(rng.standard_normal((3, 16, self.E)), jnp.float32)
        v_m = jm.init(key, obj, jnp.ones((3, 6, self.E)), train=False,
                      method=JMatch.match_encoded)
        params = {**jax.device_get(v_m["params"]),
                  **jax.device_get(v_h["params"])}
        stats = _randomize_stats(jax.device_get(v_m["batch_stats"]), 2)
        return jm, params, stats

    def _inputs(self, seed, B=5):
        rng = np.random.default_rng(seed)
        tokens, lengths = _tokens(rng, B, 8, self.VOCAB, H=6)
        obj = rng.standard_normal((B, 16, self.E)).astype(np.float32)
        return tokens, lengths, obj / np.linalg.norm(obj, axis=-1,
                                                    keepdims=True)

    def _compare(self, jm, params, stats, dtype, tokens, lengths, obj,
                 tol_p, tol_off=F32_TOL):
        variables = {"params": params, "batch_stats": stats}
        jm = jm.clone(dtype=dtype)
        j_hint = jm.apply(variables, jnp.asarray(tokens), jnp.asarray(lengths),
                          method=JMatch.encode_hints)
        want = jm.apply(variables, jnp.asarray(obj), j_hint, train=False,
                        method=JMatch.match_encoded)
        tm = SuperGlueMatch(
            params["language_encoder"]["word_embedding"]["embedding"]
            .shape[0], obj.shape[-1], num_layers=jm.num_layers,
            sinkhorn_iters=jm.sinkhorn_iters,
            dtype=None if dtype is None else torch.bfloat16)
        # The flax trees of encode_hints and match_encoded hold no object
        # tower.
        for name in ("language_encoder", "superglue", "mlp_offsets"):
            load_jax_params(getattr(tm, name), params[name],
                            stats.get(name))
        with torch.no_grad():
            t_hint = tm.encode_hints(torch.from_numpy(tokens),
                                     torch.from_numpy(lengths))
            np.testing.assert_allclose(t_hint.numpy(), np.asarray(j_hint),
                                       atol=F32_TOL, rtol=F32_TOL)
            got = tm.match_encoded(torch.from_numpy(obj), t_hint)
        np.testing.assert_allclose(got["P"].numpy(), np.asarray(want["P"]),
                                   atol=tol_p)
        np.testing.assert_allclose(got["offsets"].numpy(),
                                   np.asarray(want["offsets"]), atol=tol_off,
                                   rtol=tol_off)
        return got, want

    def test_match_encoded_f32_matches_jax(self, small_matcher):
        got, want = self._compare(*small_matcher, None, *self._inputs(3),
                                  tol_p=F32_TOL)
        for key in ("matches0", "matches1"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
        for key in ("matching_scores0", "matching_scores1", "log_P"):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), atol=1e-3)

    def test_match_encoded_bf16_close_to_jax(self, small_matcher):
        """bf16 bodies: the two frameworks round at slightly different
        points (bf16 products inside JAX's attention sums, bias adds), so
        transport probabilities agree to 2e-2 absolute."""
        self._compare(*small_matcher, jnp.bfloat16, *self._inputs(4),
                      tol_p=2e-2)

    def test_bench_fine_weights_few_pairs(self):
        """The committed fine checkpoint with its calibrated statistics, on
        six pairs from the fine bank."""
        with open(FINE, "rb") as f:
            ck = flax.serialization.msgpack_restore(f.read())
        with np.load(DB) as z:
            stats = flax.serialization.msgpack_restore(
                z["batch_stats"].tobytes())
            obj = z["fine_bank_enc"][[0, 5, 77, 300, 1024, 2047]]
        rng = np.random.default_rng(5)
        tokens, lengths = _tokens(rng, 6, 16, 32, H=6)
        jm = JMatch(vocab_size=32, embed_dim=128, num_layers=6,
                    sinkhorn_iters=50, eval_batch_stats=False,
                    bn_stat_groups=2)
        got, want = self._compare(jm, ck["params"], stats, None, tokens,
                                  lengths, obj, tol_p=F32_TOL)
        np.testing.assert_array_equal(got["matches0"].numpy(),
                                      np.asarray(want["matches0"]))


PKG = os.path.join(ROOT, "text2pos_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "text2pos_tpu"}


def test_package_imports_no_jax():
    """No import statement of the package or of ``chip_smoke.py`` names JAX
    or the JAX package, and the whole package and ``chip_smoke`` import with
    ``jax`` made unimportable."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        paths += [os.path.join(dirpath, fn) for fn in files
                  if fn.endswith(".py")]
    modules = []
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        modules.append(rel.removesuffix(".__init__"))
    code = ("import sys\n"
            "for m in %r: sys.modules[m] = None\n"
            "import importlib\n"
            "for m in %r: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in %r "
            "and sys.modules[m] is not None]\n"
            "assert not bad, bad\n" % (sorted(FORBIDDEN), sorted(modules),
                                       sorted(FORBIDDEN)))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from text2pos_torch import resolve_device
    from text2pos_torch.data.bench import bench_cell_bank, make_bench_dataset
    from text2pos_torch.evaluation.pipeline import (LocalizationPipeline,
                                                    encode_database)

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        LocalizationPipeline.from_checkpoints(COARSE, FINE, DB)
    bank = bench_cell_bank(make_bench_dataset(num_scenes=1, grid=2)[0])
    with pytest.raises(RuntimeError, match="cuda"):
        encode_database(COARSE, FINE, DB, bank)
    assert resolve_device("cpu") == torch.device("cpu")
