"""Write the evaluation fixture that the PyTorch port is checked against.

Runs the JAX package's evaluator (``text2pos_tpu/evaluation/pipeline.py``,
``evaluation/fine.py``) in float32 on the CPU over the bench map of
``bench.py`` (2048 cells, 2048 queries) with the committed checkpoints
``checkpoints/bench_{coarse,fine}.msgpack`` at the CLI's defaults (top-k
1/5/10, thresholds 5/10/15 m, batches of 32, fine chunks of 8), and saves
to ``text2pos_torch/fixtures/bench_eval.npz``:

- ``coarse_top_idx`` (int16 [2048, 10]) and ``coarse_acc`` of
  ``run_coarse``;
- ``fine_{mean,offsets,conf}_acc`` of ``run_fine`` with the cache;
- ``rerank_{coarse,mean,offsets,conf}_acc`` with ``--rerank 128
  --rerank_gamma 6``;
- ``calibrated_{mean,offsets,conf}_acc`` of ``run_fine`` on the pipeline
  built in bfloat16 and calibrated by ``calibrated_for_serving`` (128
  cells; every query's hints against its ``coarse_top_idx`` cells), with
  the fine bank it returns;
- ``coarse_random_top_idx`` and ``coarse_random_acc``; the fine oracle's
  ``oracle_exact_acc`` and ``oracle_random_acc`` on ``coarse_top_idx``;
- ``fine_eval_stats`` (``FINE_EVAL_STATS`` order), ``fine_eval_thresh``
  ([6, 3]) of ``evaluation.fine.run_fine`` on SYNTHETIC-FINE's
  validation split with ``bench_fine``, as its CLI runs it (the cells'
  own size), and its resampling draws
  ``fine_eval_idx`` (uint8 [batches, 32, 16, 256]) for the port to take.

Each accuracy array is [len(top_k), len(threshs)]. This script imports JAX
and the JAX package; it is not part of the port, which only reads the
file (``chip_smoke.py`` phase 8). Run from the repository root:

    JAX_PLATFORMS=cpu python scripts/make_torch_port_eval_fixture.py

Like ``make_torch_port_fixture.py`` it keeps every array the file already
holds and computes only the parts it lacks; delete the file to write it
from scratch.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "text2pos_torch", "fixtures", "bench_eval.npz")
CKPT = [os.path.join(ROOT, "checkpoints", f"bench_{s}.msgpack")
        for s in ("coarse", "fine")]
RERANK, RERANK_GAMMA = 128, 6.0
CALIBRATION_CELLS = 128
FINE_EVAL_STATS = ("recall", "precision", "mid", "mean", "offsets",
                   "matching_oracle", "offset_oracle", "both_oracle")


def acc_array(accs) -> np.ndarray:
    return np.array([[accs[k][t] for t in accs[k]] for k in accs])


def bench_setup():
    import bench
    from text2pos_tpu.config import EvalConfig
    from text2pos_tpu.data.loaders import CoarseLoader
    from text2pos_tpu.evaluation.pipeline import \
        build_pipeline_from_checkpoints

    cfg = EvalConfig()
    pipe, vocab, fine_vocab = build_pipeline_from_checkpoints(cfg, *CKPT)
    cells, poses = bench.make_bench_dataset()
    loader = CoarseLoader(cells, poses, vocab, cfg.batch_size,
                          cfg.coarse_max_objects, cfg.pointnet_numpoints,
                          cfg.max_text_len)
    return pipe, loader, poses, fine_vocab


def with_cfg(pipe, **kw):
    import dataclasses

    from text2pos_tpu.evaluation.pipeline import LocalizationPipeline

    return LocalizationPipeline(pipe.coarse, pipe.coarse_state, pipe.fine,
                                pipe.fine_state,
                                dataclasses.replace(pipe.cfg, **kw))


def part_coarse_fine(s, have):
    pipe, loader, poses, fine_vocab = s
    out = {}
    t0 = time.time()
    top_idx, accs = pipe.run_coarse(loader, poses)
    out.update(coarse_top_idx=top_idx.astype(np.int16),
               coarse_acc=acc_array(accs))
    print(f"coarse: {acc_array(accs).tolist()} ({time.time() - t0:.0f} s)",
          flush=True)
    t0 = time.time()
    m, o, c = pipe.run_fine(loader, poses, top_idx, fine_vocab)
    out.update(fine_mean_acc=acc_array(m), fine_offsets_acc=acc_array(o),
               fine_conf_acc=acc_array(c))
    print(f"fine: mean {acc_array(m).tolist()} offsets "
          f"{acc_array(o).tolist()} conf {acc_array(c).tolist()} "
          f"({time.time() - t0:.0f} s)", flush=True)
    return out


def part_oracles(s, have):
    pipe, loader, poses, _ = s
    top_idx = have["coarse_top_idx"].astype(np.int64)
    rand_top, rand_acc = with_cfg(pipe, coarse_random=True).run_coarse(
        loader, poses)
    return dict(coarse_random_top_idx=rand_top.astype(np.int16),
                coarse_random_acc=acc_array(rand_acc),
                oracle_exact_acc=acc_array(pipe.run_fine_oracle(
                    loader, poses, top_idx)),
                oracle_random_acc=acc_array(pipe.run_fine_oracle(
                    loader, poses, top_idx, random_oracle=True)))


def part_rerank(s, have):
    pipe, loader, poses, fine_vocab = s
    rp = with_cfg(pipe, rerank=RERANK, rerank_gamma=RERANK_GAMMA)
    t0 = time.time()
    top_idx, accs = rp.run_coarse(loader, poses)
    m, o, c = rp.run_fine(loader, poses, top_idx, fine_vocab)
    print(f"rerank@{RERANK} (gamma {RERANK_GAMMA}): mean "
          f"{acc_array(m).tolist()} ({time.time() - t0:.0f} s)", flush=True)
    return dict(rerank_coarse_acc=acc_array(accs), rerank_mean_acc=
                acc_array(m), rerank_offsets_acc=acc_array(o),
                rerank_conf_acc=acc_array(c))


def part_calibrated(s, have):
    import jax.numpy as jnp

    from text2pos_tpu.config import EvalConfig
    from text2pos_tpu.data.hints import create_hint_description
    from text2pos_tpu.evaluation.pipeline import \
        build_pipeline_from_checkpoints

    _, loader, poses, fine_vocab = s
    cfg = EvalConfig()
    pipe = build_pipeline_from_checkpoints(cfg, *CKPT, dtype="bfloat16")[0]
    bank = loader.bank
    H, T = cfg.num_mentioned, cfg.max_hint_len
    hint_tokens = np.zeros((len(poses), H, T), np.int32)
    hint_lengths = np.ones((len(poses), H), np.int32)
    for i, p in enumerate(poses):
        tk, ln = fine_vocab.encode_batch(create_hint_description(p)[:H], T)
        hint_tokens[i, :len(tk)] = tk
        hint_lengths[i, :len(ln)] = ln
    bank_dev = {k: jnp.asarray(getattr(bank, k)) for k in (
        "points_xyz", "points_rgb", "point_count", "centers", "colors",
        "class_idx", "color_idx", "mask")}
    top_idx = have["coarse_top_idx"].astype(np.int64)
    t0 = time.time()
    cal, fine_bank = pipe.calibrated_for_serving(
        bank, bank_dev, hint_tokens, hint_lengths, top_idx,
        max_cells=CALIBRATION_CELLS)
    m, o, c = cal.run_fine(loader, poses, top_idx, fine_vocab,
                           fine_bank=fine_bank)
    print(f"calibrated bf16: mean {acc_array(m).tolist()} conf "
          f"{acc_array(c).tolist()} ({time.time() - t0:.0f} s)", flush=True)
    return dict(calibrated_mean_acc=acc_array(m),
                calibrated_offsets_acc=acc_array(o),
                calibrated_conf_acc=acc_array(c))


def part_fine_eval(s, have):
    import jax
    import jax.numpy as jnp

    from text2pos_tpu.config import EvalConfig, TrainConfig
    from text2pos_tpu.data.hints import Vocabulary
    from text2pos_tpu.data.loaders import FineLoader
    from text2pos_tpu.evaluation.fine import run_fine
    from text2pos_tpu.train.fine import FineTrainer
    from text2pos_tpu.train.state import TrainState, load_checkpoint
    from text2pos_tpu.utils.cli import load_split

    cfg = EvalConfig(dataset="SYNTHETIC-FINE")
    cells, poses = load_split(cfg, "val")
    payload = load_checkpoint(CKPT[1])
    vocab = Vocabulary(payload["extra"]["known_words"])
    tcfg = TrainConfig(batch_size=cfg.batch_size, embed_dim=128,
                       num_layers=6, sinkhorn_iters=50,
                       pointnet_numpoints=256, num_mentioned=6, pad_size=16)
    trainer = FineTrainer(tcfg, vocab)
    state = TrainState.create_eval(payload["params"], payload["batch_stats"])
    loader = FineLoader(cells, poses, vocab, cfg.batch_size, cfg.pad_size,
                        cfg.num_mentioned, cfg.pointnet_numpoints,
                        tcfg.max_hint_len)
    res = run_fine(trainer, state, loader, cell_size=cells[0].cell_size,
                   log=lambda m: None)
    key, idx = jax.random.PRNGKey(0), []
    for i, b in enumerate(loader.epoch(seed=0, shuffle=False,
                                       drop_last=False)):
        # fixed_points' indices, in JAX's f32 arithmetic
        k_sample, _ = jax.random.split(jax.random.fold_in(key, i))
        u = jax.random.uniform(k_sample, b["points_xyz"].shape[:-2] + (256,))
        ii = jnp.clip(jnp.floor(u * jnp.asarray(b["point_count"])[..., None])
                      .astype(jnp.int32), 0, b["points_xyz"].shape[-2] - 1)
        idx.append(np.asarray(ii).astype(np.uint8))
    print(f"fine in isolation: {res['stats']}", flush=True)
    return dict(fine_eval_stats=np.array([res["stats"][k]
                                          for k in FINE_EVAL_STATS]),
                fine_eval_thresh=acc_array(res["thresh"]),
                fine_eval_idx=np.stack(idx))


PARTS = [
    (("coarse_top_idx", "coarse_acc", "fine_mean_acc", "fine_offsets_acc",
      "fine_conf_acc"), part_coarse_fine),
    (("coarse_random_top_idx", "coarse_random_acc", "oracle_exact_acc",
      "oracle_random_acc"), part_oracles),
    (("rerank_coarse_acc", "rerank_mean_acc", "rerank_offsets_acc",
      "rerank_conf_acc"), part_rerank),
    (("calibrated_mean_acc", "calibrated_offsets_acc",
      "calibrated_conf_acc"), part_calibrated),
    (("fine_eval_stats", "fine_eval_thresh", "fine_eval_idx"),
     part_fine_eval),
]


def main() -> None:
    have = dict(np.load(OUT)) if os.path.isfile(OUT) else {}
    setup = None
    for keys, fn in PARTS:
        if all(k in have for k in keys):
            continue
        if setup is None:
            setup = bench_setup()
        for k, v in fn(setup, have).items():
            have.setdefault(k, v)
        np.savez_compressed(OUT, **have)
    print(f"wrote {OUT}: {sorted(have)} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
