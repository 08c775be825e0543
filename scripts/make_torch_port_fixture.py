"""Write the bench-query fixture that the PyTorch port is checked against.

Builds the 2048 benchmark queries of ``bench.py`` (``make_bench_dataset``),
restores the committed calibrated DB cache, serves every query through the
JAX pipeline's ``serve_batch`` in float32 on the CPU at top_k=10, and saves
inputs, accuracy metadata and the JAX outputs to
``text2pos_torch/fixtures/bench_queries.npz``.

This script imports JAX and the JAX package; it is not part of the port.
The port (``chip_smoke.py``, ``tests/test_torch_port_serve.py``) only reads
the file. Run from the repository root:

    JAX_PLATFORMS=cpu python scripts/make_torch_port_fixture.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "text2pos_torch", "fixtures", "bench_queries.npz")
TOP_K = 10
CHUNK = 256
RERANK_K, RERANK_LAMBDA, RERANK_GAMMA = 128, 4.0, 6.0


def main() -> None:
    import flax
    import jax
    import jax.numpy as jnp

    import bench
    from text2pos_tpu.config import EvalConfig
    from text2pos_tpu.data.hints import create_hint_description
    from text2pos_tpu.data.loaders import CoarseLoader
    from text2pos_tpu.evaluation.metrics import calc_accuracies
    from text2pos_tpu.evaluation.pipeline import build_pipeline_from_checkpoints

    os.chdir(ROOT)
    cells, poses = bench.make_bench_dataset()
    ecfg = EvalConfig(top_k=(1, 5, TOP_K), threshs=(5, 10, 15), pad_size=16,
                      num_mentioned=6, pointnet_numpoints=256)
    pipe, vocab, _ = build_pipeline_from_checkpoints(
        ecfg, bench.CKPT_COARSE, bench.CKPT_FINE, dtype="float32")
    loader = CoarseLoader(cells, poses, vocab, pipe.coarse.cfg.batch_size,
                          pipe.coarse.cfg.coarse_max_objects,
                          pipe.coarse.cfg.pointnet_numpoints,
                          pipe.coarse.cfg.max_text_len)
    bank = loader.bank

    tokens, lengths = loader.all_query_tokens()
    H, Th = ecfg.num_mentioned, ecfg.max_hint_len
    hint_tokens = np.zeros((len(poses), H, Th), np.int32)
    hint_lengths = np.ones((len(poses), H), np.int32)
    for i, p in enumerate(poses):
        tk, ln = vocab.encode_batch(create_hint_description(p)[:H], Th)
        hint_tokens[i, : len(tk)] = tk
        hint_lengths[i, : len(ln)] = ln

    with np.load(bench.DB_CACHE) as z:
        cell_enc = jnp.asarray(z["cell_enc"], jnp.float32)
        fb0 = jnp.asarray(z["fine_bank_enc"], jnp.float32)
        fb1 = jnp.asarray(z["fine_bank_centers"], jnp.float32)
        stats = flax.serialization.msgpack_restore(z["batch_stats"].tobytes())
    pipe = pipe.with_calibrated_stats(jax.tree.map(jnp.asarray, stats))

    Q = len(poses)
    pose_xy = np.array([p.pose_w[0:2] for p in poses], np.float64)
    pose_scene = np.array([p.cell_id.split("_")[0] for p in poses])
    cell_scene = np.array([cid.split("_")[0] for cid in bank.cell_ids])

    def serve(*rerank):
        top_idx = np.zeros((Q, TOP_K), np.int32)
        pos_offsets = np.zeros((Q, TOP_K, 2), np.float16)
        t0 = time.time()
        for s in range(0, Q, CHUNK):
            sl = slice(s, min(s + CHUNK, Q))
            ti, _, po, _ = pipe.serve_batch(
                pipe.coarse_state, pipe.fine_state, jnp.asarray(tokens[sl]),
                jnp.asarray(lengths[sl]), jnp.asarray(hint_tokens[sl]),
                jnp.asarray(hint_lengths[sl]), cell_enc, TOP_K, fb0, fb1,
                *rerank)
            top_idx[sl] = np.asarray(ti)
            pos_offsets[sl] = np.asarray(po)
        accs = calc_accuracies(
            pose_xy, bank.bbox_w[top_idx][..., 0:2], bank.cell_size[top_idx],
            pos_offsets.astype(np.float32),
            cell_scene[top_idx] == pose_scene[:, None], (1, 5, TOP_K),
            (5, 10, 15))
        print(f"# JAX f32 rerank={rerank or None}: {Q} queries in "
              f"{time.time() - t0:0.1f}s, top-{TOP_K}@15m="
              f"{accs[TOP_K][15]:0.4f} top-1@15m={accs[1][15]:0.4f}",
              flush=True)
        return top_idx, pos_offsets, accs

    top_idx, pos_offsets, accs = serve()
    rr_idx, _, rr_accs = serve(RERANK_K, RERANK_LAMBDA, RERANK_GAMMA)

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(
        OUT,
        tokens=tokens.astype(np.int32), lengths=lengths.astype(np.int32),
        hint_tokens=hint_tokens, hint_lengths=hint_lengths,
        pose_xy=pose_xy, pose_scene=pose_scene,
        cell_bbox_xy=np.asarray(bank.bbox_w[:, 0:2], np.float64),
        cell_size=np.asarray(bank.cell_size, np.float64),
        cell_scene=cell_scene,
        jax_top_idx=top_idx, jax_pos_offsets=pos_offsets,
        jax_top10_at_15m=np.float64(accs[TOP_K][15]),
        jax_top1_at_15m=np.float64(accs[1][15]),
        jax_rerank_top_idx=rr_idx,
        jax_rerank_top10_at_15m=np.float64(rr_accs[TOP_K][15]),
        rerank=np.array([RERANK_K, RERANK_LAMBDA, RERANK_GAMMA]),
        top_k=np.int32(TOP_K))
    print(f"# wrote {OUT} ({os.path.getsize(OUT) / 1e6:0.2f} MB)")


if __name__ == "__main__":
    main()
