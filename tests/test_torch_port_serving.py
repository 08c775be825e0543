"""The port's serving front end (``text2pos_torch/serving.py``): its host
side against ``text2pos_tpu/serving.py`` on the same inputs (calibration
hints, the JSON-lines batcher, the result decode, the cascade's argument
checks), and ``tests/test_serving.py``'s properties on the port, end to end
on the CPU at that file's tiny configuration with random-init checkpoints
from the JAX trainers."""

import functools
import io
import json
import os
import pickle
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from text2pos_tpu import serving as jserving
from text2pos_tpu.config import EvalConfig, TrainConfig
from text2pos_tpu.data.hints import (Vocabulary, build_vocabulary,
                                     create_hint_description)
from text2pos_torch import serving
from text2pos_torch.config import ServeConfig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(batch_size=4, embed_dim=16, num_layers=2, sinkhorn_iters=10,
            pointnet_numpoints=32, coarse_max_objects=16, pad_size=8,
            num_mentioned=6, max_text_len=48, max_hint_len=12)
PROTO = ("pad_size", "num_mentioned", "coarse_max_objects",
         "pointnet_numpoints", "max_hint_len", "max_text_len")


@pytest.fixture(scope="module")
def server(synthetic_data, tmp_path_factory):
    """The port's calibrated f32 server on the CPU, its checkpoints and
    configuration."""
    from text2pos_tpu.data.loaders import CoarseLoader, FineLoader
    from text2pos_tpu.train.coarse import CoarseTrainer
    from text2pos_tpu.train.fine import FineTrainer
    from text2pos_tpu.train.state import save_checkpoint

    cells, poses = synthetic_data
    cfg = TrainConfig(**TINY)
    vocab = Vocabulary(build_vocabulary(
        [create_hint_description(p) for p in poses]))
    rng = jax.random.PRNGKey(0)
    loader = CoarseLoader(cells, poses, vocab, cfg.batch_size,
                          cfg.coarse_max_objects, cfg.pointnet_numpoints,
                          cfg.max_text_len)
    cstate = CoarseTrainer(cfg, vocab).init_state(
        next(loader.epoch(seed=0)), rng, 1)
    floader = FineLoader(cells, poses, vocab, cfg.batch_size, cfg.pad_size,
                         cfg.num_mentioned, cfg.pointnet_numpoints,
                         cfg.max_hint_len)
    fstate = FineTrainer(cfg, vocab).init_state(
        next(floader.epoch(seed=0)), rng, 1)
    d = tmp_path_factory.mktemp("srv")
    pc, pf = str(d / "coarse.msgpack"), str(d / "fine.msgpack")
    save_checkpoint(pc, cstate, extra={
        "known_words": vocab.known_words, "embed_dim": cfg.embed_dim,
        "variation": 0, "use_features": list(cfg.use_features)})
    save_checkpoint(pf, fstate, extra={
        "known_words": vocab.known_words, "embed_dim": cfg.embed_dim,
        "num_layers": cfg.num_layers, "sinkhorn_iters": cfg.sinkhorn_iters,
        "use_features": list(cfg.use_features)})
    scfg = ServeConfig(top_k=(1, 3), **{f: TINY[f] for f in PROTO})
    srv = serving.LocalizationServer(pc, pf, cells, cfg=scfg, top_k=3,
                                     dtype=None, device="cpu")
    cells_path = str(d / "map.pkl")
    with open(cells_path, "wb") as f:
        pickle.dump(cells, f)
    return srv, cells, poses, (pc, pf, cells_path)


def _jax_stub(srv):
    """A stand-in for ``text2pos_tpu.serving.LocalizationServer`` carrying
    the port server's configuration, map and vocabulary, so that JAX's host
    methods run on the same inputs without building JAX models."""
    stub = types.SimpleNamespace(
        cfg=EvalConfig(top_k=(1, 3), threshs=(5, 10, 15),
                       **{f: TINY[f] for f in PROTO}),
        bank=srv.bank, vocab=srv.vocab)
    stub._hint_tokens = functools.partial(
        jserving.LocalizationServer._hint_tokens, stub)
    return stub


def _cli_args(pc, pf, *extra):
    return ["--path_coarse", pc, "--path_fine", pf, "--device", "cpu",
            "--dtype", "float32", "--top_k", "3", *extra,
            *[a for f in PROTO for a in (f"--{f}", str(TINY[f]))]]


# ---------------------------------------------------------------------------
# Host side against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("given", [False, True])
def test_calibration_tokens_match_jax(server, given):
    """Fabricated hints (``np.random.default_rng(seed)`` draws) and given
    ones, short lists repeated: the same lists and tokens as JAX's."""
    srv, _, poses, _ = server
    hints = ([create_hint_description(p)[:k]
              for p, k in zip(poses[:5], (6, 2, 1, 6, 3))] if given else None)
    stub = _jax_stub(srv)
    want = jserving.LocalizationServer._calibration_tokens(stub, hints)
    got = srv._calibration_tokens(hints)
    assert got[0].shape[0] == (5 if given else 32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert srv._cal_hint_lists == stub._cal_hint_lists


def test_iter_query_batches_match_jax():
    """Errors reported at the same lines with the same messages, the same
    batches, padding and ids."""
    lines = ["not json", json.dumps({"hints": []}), json.dumps(["a", "b"]),
             json.dumps({"hints": ["a", 3]}), "",
             json.dumps({"hints": ["h1", "h2", "h3"], "id": "x"}),
             json.dumps([f"hint {i}" for i in range(4)]),
             json.dumps({"id": "nohints"}),
             json.dumps({"hints": ["a", "b", "c"]})]
    for batch, min_hints in ((2, 3), (3, 0), (1, 0)):
        out = []
        for mod in (jserving, serving):
            errs = []
            got = list(mod._iter_query_batches(
                io.StringIO("\n".join(lines)), batch,
                on_error=lambda *e, errs=errs: errs.append(e),
                min_hints=min_hints))
            out.append((got, errs))
        assert out[0] == out[1]
    for mod in (jserving, serving):
        with pytest.raises(ValueError, match="line 0"):
            list(mod._iter_query_batches(io.StringIO("not json"), 2))


def test_finalize_matches_jax(server):
    """World positions, best cell ids, cells and counts from one fetched
    batch (int16 cells, f16 offsets, u8 counts, padded rows dropped)."""
    srv = server[0]
    rng = np.random.default_rng(3)
    C = srv.bank.num_cells
    fetched = [rng.integers(0, C, (5, 3)).astype(np.int16),
               rng.random((5, 3, 2)).astype(np.float16),
               rng.random((5, 3, 2)).astype(np.float16),
               rng.integers(0, 6, (5, 3)).astype(np.uint8)]
    want = jserving.LocalizationServer._finalize(_jax_stub(srv), fetched, 4)
    got = srv._finalize(fetched, 4)
    assert got.keys() == want.keys()
    for k in want:
        if k == "cell_ids":
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("prune_m,rerank_k", [
    (10, 128),   # prune_m == top_k
    (5, 128),    # prune_m < top_k
    (128, 128),  # prune_m == rerank_k
    (200, 128),  # prune_m > rerank_k
    (24, 0),     # cascade without re-ranking pool
])
def test_invalid_prune_bounds_raise(prune_m, rerank_k):
    """The cases of ``tests/test_serving_validation.py``: both packages
    raise the same error before any checkpoint is read."""
    msgs = []
    for mod in (jserving, serving):
        with pytest.raises(ValueError, match="top_k < prune_m < rerank_k"
                           ) as e:
            mod.LocalizationServer("nope_coarse.msgpack",
                                   "nope_fine.msgpack", cells=[], top_k=10,
                                   rerank_k=rerank_k, prune_m=prune_m)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_prune_zero_is_always_allowed():
    with pytest.raises(FileNotFoundError):
        serving.LocalizationServer("nope_coarse.msgpack", "nope_fine.msgpack",
                                   cells=[], top_k=10, rerank_k=128,
                                   prune_m=0, device="cpu")


def test_not_ported_options_raise(server, monkeypatch):
    """JAX's two refusals of data-parallel serving (the int8 cheap bank,
    batch statistics) and the KITTI360 reader raise, naming the missing
    piece; nothing falls back."""
    srv, cells, _, (pc, pf, _) = server
    for kw, msg in (({"int8_cheap_bank": True}, "single-device only"),
                    ({"calibrate": False}, "requires calibrate=True")):
        with pytest.raises(ValueError, match=msg):
            serving.LocalizationServer(pc, pf, cells, device="cpu",
                                       data_parallel=2, **kw)
    with pytest.raises(ValueError, match="prune_layers=3 exceeds"):
        serving.LocalizationServer(pc, pf, cells, cfg=srv.cfg, top_k=3,
                                   rerank_k=8, prune_m=5, prune_layers=3,
                                   device="cpu")
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    with pytest.raises(ValueError, match="data/legacy.py"):
        serving.main(_cli_args(pc, pf, "--base_path", "/nonexistent"))


# ---------------------------------------------------------------------------
# tests/test_serving.py's properties on the port
# ---------------------------------------------------------------------------
def test_localize_shapes_and_geometry(server):
    srv, _, poses, _ = server
    out = srv.localize([create_hint_description(p) for p in poses[:5]])
    Q, K = 5, min(3, srv.bank.num_cells)
    assert out["positions"].shape == (Q, 3)
    assert out["top_cells"].shape == (Q, K)
    assert out["positions_k"].shape == (Q, K, 3)
    assert out["confidences"].shape == (Q, K)
    assert len(out["cell_ids"]) == Q
    assert np.all(np.isfinite(out["positions"]))
    # Offsets are unclipped: one cell size of margin, as the JAX test.
    lo = srv.bank.bbox_w[out["top_cells"]][..., 0:2]
    hi = srv.bank.bbox_w[out["top_cells"]][..., 3:5]
    size = srv.bank.cell_size[out["top_cells"]][..., None]
    p = out["positions_k"][..., 0:2]
    assert np.all(p >= lo - size) and np.all(p <= hi + size)


def test_short_queries(server):
    """Fewer hints than num_mentioned raise; with pad_short_queries they
    repeat the query's own hints."""
    srv, _, poses, _ = server
    q = create_hint_description(poses[0])[:2]
    with pytest.raises(ValueError, match="fewer than num_mentioned"):
        srv.localize([q])
    H = srv.cfg.num_mentioned
    padded = srv.localize([q], pad_short_queries=True)
    explicit = srv.localize([(q * (H // len(q) + 1))[:H]])
    np.testing.assert_array_equal(padded["top_cells"], explicit["top_cells"])
    np.testing.assert_allclose(padded["positions"], explicit["positions"],
                               atol=1e-6)


def test_batch_independence_with_calibration(server):
    srv, _, poses, _ = server
    queries = [create_hint_description(p) for p in poses[:6]]
    full = srv.localize(queries)
    solo = srv.localize(queries[:1])
    np.testing.assert_allclose(solo["positions"][0], full["positions"][0],
                               atol=1e-5)
    np.testing.assert_array_equal(solo["top_cells"][0], full["top_cells"][0])


def test_stream_matches_per_batch_localize(server):
    srv, _, poses, _ = server
    batches = [[create_hint_description(p) for p in poses[i:i + 3]]
               for i in (0, 3, 6)]
    streamed = list(srv.localize_stream(batches))
    assert len(streamed) == len(batches)
    for got, batch in zip(streamed, batches):
        want = srv.localize(batch)
        np.testing.assert_array_equal(got["top_cells"], want["top_cells"])
        np.testing.assert_allclose(got["positions"], want["positions"])
        np.testing.assert_array_equal(got["confidences"],
                                      want["confidences"])
        assert got["cell_ids"] == want["cell_ids"]
    assert list(srv.localize_stream([])) == []


def test_cascade_server_draws_from_the_wide_pool(server, monkeypatch):
    """A cascade server (int8 cheap bank) returns top_k cells from the
    coarse top-rerank_k pool, with the same shapes."""
    srv, _, poses, _ = server
    queries = [create_hint_description(p) for p in poses[:4]]
    k_all = min(8, srv.bank.num_cells)
    for name, v in (("rerank_k", k_all), ("prune_m", 5),
                    ("cheap_bank", serving.quantize_fine_bank(
                        srv.fine_bank[0]))):
        monkeypatch.setattr(srv, name, v)
    out = srv.localize(queries)
    assert out["top_cells"].shape == (4, 3)
    (tk, ln, _, _), _ = srv._prepare(queries, False)
    with torch.no_grad():
        enc = srv.pipe.coarse.encode_text(torch.as_tensor(tk),
                                          torch.as_tensor(ln))
    wide = serving.topk_retrieval(enc, srv.cell_enc, k_all)[1].numpy()
    for q in range(4):
        assert set(out["top_cells"][q]) <= set(wide[q])


def test_jsonl_cli_end_to_end(server, monkeypatch, capsys):
    """One result line per query, ids in order, a partial last batch; the
    map from a pickle of the JAX package's Cells."""
    _, _, poses, (pc, pf, cells_path) = server
    lines = [json.dumps({"hints": create_hint_description(p), "id": f"q{i}"})
             for i, p in enumerate(poses[:5])]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines)))
    serving.main(_cli_args(pc, pf, "--cells_pickle", cells_path,
                           "--no_calibrate", "--batch", "4"))
    out = [json.loads(line) for line in
           capsys.readouterr().out.strip().splitlines()]
    assert [r["id"] for r in out] == [f"q{i}" for i in range(5)]
    for r in out:
        assert len(r["position"]) == 3
        assert all(np.isfinite(v) for v in r["position"])
        assert isinstance(r["cell_id"], str) and r["confidence"] >= 0


def test_malformed_lines_reported_not_fatal(server, monkeypatch, capsys):
    _, _, poses, (pc, pf, _) = server
    good = create_hint_description(poses[0])
    lines = [json.dumps({"hints": good, "id": "ok0"}), "{not json",
             json.dumps({"id": "nohints"}),
             json.dumps({"hints": "a string", "id": "badtype"}),
             json.dumps({"hints": good[:2], "id": "short"}),
             json.dumps({"hints": good, "id": "ok1"})]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines)))
    serving.main(_cli_args(pc, pf, "--synthetic_seed", "0", "--batch", "2"))
    captured = capsys.readouterr()
    by_id = {r["id"]: r for r in map(json.loads,
                                     captured.out.strip().splitlines())}
    assert "invalid JSON" in by_id[1]["error"]
    assert "hints" in by_id["nohints"]["error"]
    assert "hints" in by_id["badtype"]["error"]
    assert "--pad_short" in by_id["short"]["error"]
    assert [k for k, r in by_id.items() if "position" in r] == ["ok0", "ok1"]
    stats = json.loads(next(line for line in captured.err.splitlines()
                            if line.startswith("# stats "))[len("# stats "):])
    assert stats["queries"] == 2 and stats["rejected"] == 4
    assert stats["device"] == "cpu"
    assert stats["p99_ms"] >= stats["p50_ms"] > 0 and stats["qps"] > 0


def test_cells_pickle_loads_without_the_jax_package(server, tmp_path):
    """Pickled ``text2pos_tpu.data.structs.Cell``s load as the port's own
    structs, in a process that never imports the JAX package; any other
    global in the pickle is refused."""
    _, cells, _, (_, _, cells_path) = server
    code = (
        "import sys\n"
        "from text2pos_torch.serving import load_cells\n"
        f"cells = load_cells({cells_path!r})\n"
        "assert type(cells[0]).__module__ == 'text2pos_torch.data.structs'\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('text2pos_tpu', 'jax', 'flax')]\n"
        "print(len(cells), cells[0].id, len(cells[0].objects))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(len(cells)), cells[0].id,
                                  str(len(cells[0].objects))]
    bad = tmp_path / "bad.pkl"
    bad.write_bytes(pickle.dumps(os.system))
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        serving.load_cells(str(bad))
