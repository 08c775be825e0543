"""The port's BN calibration (``calibrated_for_serving``) and its serving on
batch statistics against the JAX pipeline's, at the tiny configuration of
``tests/test_serving.py``: random-init weights from the JAX trainers, saved
as checkpoints that both packages load, the synthetic map, and JAX's random
draws handed to the port (the frameworks' generators differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2pos_tpu.config import EvalConfig, TrainConfig
from text2pos_tpu.data.hints import (Vocabulary, build_vocabulary,
                                     create_hint_description)
from text2pos_torch.data.dense import CellBank
from text2pos_torch.evaluation.pipeline import DB_CHUNK, LocalizationPipeline
from text2pos_torch.config import ServeConfig

torch.set_num_threads(2)

TINY = dict(batch_size=4, embed_dim=16, num_layers=2, sinkhorn_iters=10,
            pointnet_numpoints=32, coarse_max_objects=16, pad_size=8,
            num_mentioned=6, max_text_len=48, max_hint_len=12)
TOP_K, Q = 3, 8
BANK_FIELDS = ("points_xyz", "points_rgb", "point_count", "centers",
               "colors", "class_idx", "color_idx", "mask")


def _draws(key, n, pad, P):
    """JAX's draws for ``n`` cells under ``key`` (``_pad_filled_cell_
    tensors`` and ``prepare_object_points``): (u, pad_pts) as torch."""
    pad_pts = jax.random.uniform(key, (n, pad, 8, 3)) * 0.001
    k_sample, _ = jax.random.split(jax.random.fold_in(key, 1))
    u = jax.random.uniform(k_sample, (n, pad, P))
    return (torch.from_numpy(np.array(u, np.float32)),
            torch.from_numpy(np.array(pad_pts, np.float32)))


@pytest.fixture(scope="module")
def tiny(synthetic_data, tmp_path_factory):
    """JAX's uncalibrated pipeline and inputs, the port's pipeline from the
    same checkpoints (f32, CPU) with JAX's cell encodings."""
    return make_tiny(synthetic_data, tmp_path_factory.mktemp("cal"), TINY)


def make_tiny(synthetic_data, d, config):
    """``tiny``'s pipelines and inputs at the configuration ``config``
    (``TrainConfig`` fields), checkpoints written under ``d``."""
    from text2pos_tpu.data.loaders import CoarseLoader, FineLoader
    from text2pos_tpu.evaluation.pipeline import LocalizationPipeline as JP
    from text2pos_tpu.ops.retrieval import topk_retrieval
    from text2pos_tpu.train.coarse import CoarseTrainer
    from text2pos_tpu.train.fine import FineTrainer
    from text2pos_tpu.train.state import save_checkpoint

    cells, poses = synthetic_data
    cfg = TrainConfig(**config)
    vocab = Vocabulary(build_vocabulary(
        [create_hint_description(p) for p in poses]))
    rng = jax.random.PRNGKey(0)
    loader = CoarseLoader(cells, poses, vocab, cfg.batch_size,
                          cfg.coarse_max_objects, cfg.pointnet_numpoints,
                          cfg.max_text_len)
    ct = CoarseTrainer(cfg, vocab)
    cstate = ct.init_state(next(loader.epoch(seed=0)), rng, 1)
    fl = FineLoader(cells, poses, vocab, cfg.batch_size, cfg.pad_size,
                    cfg.num_mentioned, cfg.pointnet_numpoints,
                    cfg.max_hint_len)
    ft = FineTrainer(cfg, vocab)
    fstate = ft.init_state(next(fl.epoch(seed=0)), rng, 1)
    pc, pf = str(d / "coarse.msgpack"), str(d / "fine.msgpack")
    save_checkpoint(pc, cstate, extra={
        "known_words": vocab.known_words, "embed_dim": cfg.embed_dim,
        "variation": 0, "use_features": list(cfg.use_features)})
    save_checkpoint(pf, fstate, extra={
        "known_words": vocab.known_words, "embed_dim": cfg.embed_dim,
        "num_layers": cfg.num_layers, "sinkhorn_iters": cfg.sinkhorn_iters,
        "use_features": list(cfg.use_features)})

    ecfg = EvalConfig(top_k=(1, TOP_K), threshs=(5, 10, 15),
                      pad_size=cfg.pad_size, num_mentioned=cfg.num_mentioned,
                      max_hint_len=cfg.max_hint_len,
                      max_text_len=cfg.max_text_len,
                      coarse_max_objects=cfg.coarse_max_objects,
                      pointnet_numpoints=cfg.pointnet_numpoints)
    jpipe = JP(ct, cstate, ft, fstate, ecfg)
    bank = loader.bank
    bank_dev = {k: jnp.asarray(getattr(bank, k)) for k in BANK_FIELDS}
    tokens, lengths = loader.all_query_tokens()
    H, Th = cfg.num_mentioned, cfg.max_hint_len
    htk = np.zeros((Q, H, Th), np.int32)
    hln = np.ones((Q, H), np.int32)
    for i, p in enumerate(poses[:Q]):
        tk, ln = vocab.encode_batch(create_hint_description(p)[:H], Th)
        htk[i, :len(tk)] = tk
        hln[i, :len(ln)] = ln
    cell_enc = np.asarray(ct.encode_all_cells(cstate, bank,
                                              jax.random.PRNGKey(0)))
    text_enc = ct.encode_all_queries(cstate, loader)[:Q]
    _, cal_idx = topk_retrieval(jnp.asarray(text_enc), jnp.asarray(cell_enc),
                                TOP_K)
    scfg = ServeConfig(
        top_k=(1, TOP_K), pad_size=cfg.pad_size,
        num_mentioned=cfg.num_mentioned, max_hint_len=cfg.max_hint_len,
        max_text_len=cfg.max_text_len,
        coarse_max_objects=cfg.coarse_max_objects,
        pointnet_numpoints=cfg.pointnet_numpoints)
    port = LocalizationPipeline.from_checkpoints(
        pc, pf, None, dtype="float32", device="cpu", cfg=scfg)
    port = port.with_database(torch.from_numpy(cell_enc), None, None)
    tbank = CellBank(**{f: getattr(bank, f) for f in
                        CellBank.__dataclass_fields__})
    serve_args = (tokens[:Q].astype(np.int32), lengths[:Q].astype(np.int32),
                  htk, hln)
    return dict(jpipe=jpipe, bank=bank, bank_dev=bank_dev, tbank=tbank,
                port=port, htk=htk, hln=hln, cal_idx=np.asarray(cal_idx),
                cell_enc=cell_enc, args=serve_args, cfg=cfg)


def _bank_draws(t):
    """``precompute_fine_bank``'s draws: one key a 64-cell step."""
    cfg, C = t["cfg"], t["bank"].num_cells
    root = jax.random.PRNGKey(0)
    return [_draws(jax.random.fold_in(root, i), DB_CHUNK, cfg.pad_size,
                   cfg.pointnet_numpoints) for i in range(0, C, DB_CHUNK)]


@pytest.fixture(scope="module")
def calibrated(tiny):
    t = tiny
    jcal, jbank = t["jpipe"].calibrated_for_serving(
        t["bank"], t["bank_dev"], t["htk"], t["hln"], t["cal_idx"])
    cfg = t["cfg"]
    n = min(t["bank"].num_cells, 128)
    tcal = t["port"].calibrated_for_serving(
        t["tbank"], t["htk"], t["hln"], t["cal_idx"],
        sample_draws=_draws(jax.random.PRNGKey(0), n, cfg.pad_size,
                            cfg.pointnet_numpoints),
        bank_draws=_bank_draws(t))
    return jcal, jbank, tcal


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree, np.float64)


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree, np.float64)


def test_calibrated_statistics_match_jax(calibrated):
    """Every BN statistics leaf after the three steps within 1e-4 of its
    largest magnitude (f32 sums in other orders); the object encoder's
    from step 1, the GNN's per-set rows from step 3."""
    jcal, _, tcal = calibrated
    got = tcal.batch_stats()
    n = 0
    for path, want in _leaves(jax.device_get(jcal.fine_state.batch_stats)):
        g = _get(got, path)
        assert g.shape == want.shape, path
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg="/".join(path))
        n += 1
    # mean and var of 14 object-encoder BNs (6 in the set abstractions, 2
    # in the global one, 6 in the encoder's MLPs) and of 4 GNN block BNs
    assert n == 36


def test_calibrated_fine_bank_matches_jax(calibrated):
    _, jbank, tcal = calibrated
    np.testing.assert_allclose(tcal.fine_bank_enc.numpy(),
                               np.asarray(jbank[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tcal.fine_bank_centers.numpy(),
                               np.asarray(jbank[1]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("rerank", [(), (6, 2.0, 1.0)])
def test_calibrated_serving_matches_jax(tiny, calibrated, rerank):
    """f32 serving from the calibrated pipelines: identical top_idx and
    match counts, positions within one f16 step."""
    jcal, jbank, tcal = calibrated
    want = jcal.serve_batch(jcal.coarse_state, jcal.fine_state,
                            *map(jnp.asarray, tiny["args"]),
                            jnp.asarray(tiny["cell_enc"]), TOP_K, jbank[0],
                            jbank[1], *rerank)
    got = tcal.serve_batch(*tiny["args"], TOP_K, *rerank)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[2].float().numpy(),
                               np.asarray(want[2], np.float32),
                               atol=2.0 ** -11, rtol=0)


def test_batch_statistics_serving_matches_jax(tiny):
    """The uncalibrated model (``calibrate=False``): the fine bank encoded
    on each 64-cell step's batch statistics (the last step filled up with
    cell 0, as JAX fills it) and serving with the GNN's statistics taken
    over the batch's pose-cell pairs, both against JAX's on JAX's draws."""
    from text2pos_torch.evaluation.pipeline import (bank_tensors,
                                                    encode_all_fine)

    t = tiny
    jp = t["jpipe"]
    jbank = jp.precompute_fine_bank(t["bank"], t["bank_dev"])
    port = t["port"]
    assert port.fine.superglue.eval_batch_stats
    with torch.no_grad():
        tb = encode_all_fine(port.fine, bank_tensors(t["tbank"], "cpu"),
                             t["cfg"].pad_size,
                             num_points=t["cfg"].pointnet_numpoints,
                             draws=_bank_draws(t))
    np.testing.assert_allclose(tb[0].numpy(), np.asarray(jbank[0]), rtol=0,
                               atol=1e-4)
    want = jp.serve_batch(jp.coarse_state, jp.fine_state,
                          *map(jnp.asarray, t["args"]),
                          jnp.asarray(t["cell_enc"]), TOP_K, jbank[0],
                          jbank[1])
    got = port.with_database(port.cell_enc, torch.from_numpy(
        np.asarray(jbank[0])), torch.from_numpy(np.asarray(jbank[1]))
    ).serve_batch(*t["args"], TOP_K)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[2].float().numpy(),
                               np.asarray(want[2], np.float32),
                               atol=2.0 ** -11, rtol=0)


def test_with_calibrated_stats_restores_the_calibration(tiny, calibrated):
    """``with_calibrated_stats`` with a calibrated pipeline's statistics
    turns the uncalibrated one into the same eval-mode model: the same
    statistics and the same served outputs."""
    _, _, tcal = calibrated
    stats = tcal.batch_stats()
    back = tiny["port"].with_database(
        tcal.cell_enc, tcal.fine_bank_enc,
        tcal.fine_bank_centers).with_calibrated_stats(stats)
    assert not back.fine.superglue.eval_batch_stats
    assert tiny["port"].fine.superglue.eval_batch_stats
    for (path, a), (_, b) in zip(_leaves(stats), _leaves(back.batch_stats())):
        np.testing.assert_array_equal(a, b, err_msg="/".join(path))
    for g, w in zip(back.serve_batch(*tiny["args"], TOP_K),
                    tcal.serve_batch(*tiny["args"], TOP_K)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_calibrating_drops_the_kernels_stale_fold():
    """After ``blocks.calibrating`` a SuperGlue's cached kernel fold is
    stale (the statistics were written in place, which its key sees): the
    fold taken after calibration holds the new statistics, bit-equal to one
    folded from scratch."""
    import copy

    from text2pos_torch.models.blocks import (calibrating,
                                              set_eval_batch_stats)
    from text2pos_torch.models.superglue import SuperGlue

    torch.manual_seed(0)
    sg = SuperGlue(16, num_layers=1, stat_groups=2).eval()
    before = sg.packed_kernel_params()
    set_eval_batch_stats(sg, True)
    with torch.no_grad(), calibrating(sg):
        sg(torch.randn(4, 8, 16), torch.randn(4, 6, 16))
    set_eval_batch_stats(sg, False)
    after = sg.packed_kernel_params()
    fresh = copy.deepcopy(sg)
    fresh._packed = None
    assert not torch.equal(after["t0"], before["t0"])
    for k, v in fresh.packed_kernel_params().items():
        torch.testing.assert_close(after[k], v, rtol=0, atol=0, msg=k)
