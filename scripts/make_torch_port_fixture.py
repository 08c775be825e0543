"""Write the bench-query fixture that the PyTorch port is checked against.

Builds the 2048 benchmark queries of ``bench.py`` (``make_bench_dataset``),
restores the committed calibrated DB cache, serves every query through the
JAX pipeline's ``serve_batch`` in float32 on the CPU at top_k=10 (plain,
rerank@128 and the cascade 128 → 24 with one block pair and 6 Sinkhorn
iterations in the cheap pass on the int8 bank of ``quantize_fine_bank``,
λ=4, γ=6), and saves inputs, accuracy metadata and the JAX outputs to
``text2pos_torch/fixtures/bench_queries.npz``.

This script imports JAX and the JAX package; it is not part of the port.
The port (``chip_smoke.py``, ``tests/test_torch_port_serve.py``) only reads
the file. Run from the repository root:

    JAX_PLATFORMS=cpu python scripts/make_torch_port_fixture.py

JAX's f32 CPU serving is not bit-reproducible from machine to machine: a
rerun elsewhere moved 5 of the 20,480 headline in-cell positions (by up to
0.2017 of a cell; near-ties in match extraction) and nothing else. So the
script keeps every array the file already holds, byte for byte, and
computes and adds only the ones it lacks; to write it from scratch, delete
the file first.

Beside the served outputs it stores the re-rank score ``conf + λ·sim −
γ·spread`` of every candidate of each stage, so that a check on another
machine can tell a near-tie flip from an error: rerank@128's over the
coarse top-128 (``jax_rerank_cands``, ``jax_rerank_scores``), the cascade's
cheap pass over the same candidates (``jax_cascade_cheap_scores``) and its
full pass over the survivors (``jax_cascade_kept``, ``jax_cascade_scores``).
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
PRUNE_M, PRUNE_LAYERS, PRUNE_SINKHORN = 24, 1, 6


def main() -> None:
    have = dict(np.load(OUT)) if os.path.isfile(OUT) else {}

    import flax
    import jax
    import jax.numpy as jnp

    import bench
    from text2pos_tpu.config import EvalConfig
    from text2pos_tpu.data.hints import create_hint_description
    from text2pos_tpu.data.loaders import CoarseLoader
    from text2pos_tpu.evaluation.metrics import calc_accuracies
    from text2pos_tpu.evaluation.pipeline import (
        build_pipeline_from_checkpoints, quantize_fine_bank)
    from text2pos_tpu.ops.retrieval import topk_retrieval

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

    def serve(*rerank, **cascade):
        top_idx = np.zeros((Q, TOP_K), np.int32)
        pos_offsets = np.zeros((Q, TOP_K, 2), np.float16)
        t0 = time.time()
        for s in range(0, Q, CHUNK):
            sl = slice(s, min(s + CHUNK, Q))
            ti, _, po, _ = pipe.serve_batch(
                pipe.coarse_state, pipe.fine_state, jnp.asarray(tokens[sl]),
                jnp.asarray(lengths[sl]), jnp.asarray(hint_tokens[sl]),
                jnp.asarray(hint_lengths[sl]), cell_enc, TOP_K, fb0, fb1,
                *rerank, **cascade)
            top_idx[sl] = np.asarray(ti)
            pos_offsets[sl] = np.asarray(po)
        accs = calc_accuracies(
            pose_xy, bank.bbox_w[top_idx][..., 0:2], bank.cell_size[top_idx],
            pos_offsets.astype(np.float32),
            cell_scene[top_idx] == pose_scene[:, None], (1, 5, TOP_K),
            (5, 10, 15))
        print(f"# JAX f32 rerank={rerank or None} cascade="
              f"{bool(cascade)}: {Q} queries in "
              f"{time.time() - t0:0.1f}s, top-{TOP_K}@15m="
              f"{accs[TOP_K][15]:0.4f} top-1@15m={accs[1][15]:0.4f}",
              flush=True)
        return top_idx, pos_offsets, accs

    qb, qs = quantize_fine_bank(fb0)
    fine, coarse = pipe.fine.model, pipe.coarse.model

    def gather(b, idx):
        return b[idx.reshape(-1)].reshape(*idx.shape, *b.shape[1:])

    def score(conf, spread, sims):   # _compact_results' arithmetic
        return (conf.astype(jnp.float32) + RERANK_LAMBDA * sims
                - RERANK_GAMMA * spread.astype(jnp.float32))

    @jax.jit
    def stage_scores(tok, ln, htk, hln):
        """Each stage's candidates and re-rank scores, as serve_batch
        computes them."""
        text_enc = coarse.apply(
            {"params": pipe.coarse_state.params,
             "batch_stats": pipe.coarse_state.batch_stats},
            tok, ln, method=type(coarse).encode_text)
        sims, wide = topk_retrieval(text_enc, cell_enc, RERANK_K)
        fs = pipe.fine_state
        hint_enc = fine.apply({"params": fs.params,
                               "batch_stats": fs.batch_stats}, htk, hln,
                              method=type(fine).encode_hints)
        ctr = gather(fb1, wide)
        *_, cs, sp = pipe._match_from_enc(fs, gather(fb0, wide), ctr,
                                          hint_enc)
        obj_c = (gather(qb, wide).astype(jnp.float32)
                 * gather(qs, wide).astype(jnp.float32))
        *_, ccs, csp = pipe._match_from_enc(
            fs, obj_c, ctr, hint_enc,
            model=pipe._cheap_matcher(PRUNE_LAYERS, PRUNE_SINKHORN))
        cheap = score(ccs, csp, sims)
        keep = jnp.argsort(-cheap, axis=1, stable=True)[:, :PRUNE_M]
        kept = jnp.take_along_axis(wide, keep, axis=1)
        *_, fcs, fsp = pipe._match_from_enc(fs, gather(fb0, kept),
                                            gather(fb1, kept), hint_enc)
        return (wide, score(cs, sp, sims), cheap, kept,
                score(fcs, fsp, jnp.take_along_axis(sims, keep, axis=1)))

    def all_stage_scores():
        parts = [stage_scores(*(jnp.asarray(a[s:s + CHUNK]) for a in (
            tokens, lengths, hint_tokens, hint_lengths)))
            for s in range(0, Q, CHUNK)]
        wide, rr, cheap, kept, final = (
            np.concatenate([np.asarray(p[i]) for p in parts])
            for i in range(5))
        return dict(jax_rerank_cands=wide.astype(np.int16),
                    jax_rerank_scores=rr.astype(np.float32),
                    jax_cascade_cheap_scores=cheap.astype(np.float32),
                    jax_cascade_kept=kept.astype(np.int16),
                    jax_cascade_scores=final.astype(np.float32))

    def top_of(cands, scores):
        order = np.argsort(-scores, axis=1, kind="stable")[:, :TOP_K]
        return np.take_along_axis(cands.astype(np.int32), order, axis=1)

    out = {}
    if "jax_top_idx" not in have:
        top_idx, pos_offsets, accs = serve()
        out.update(
            tokens=tokens.astype(np.int32), lengths=lengths.astype(np.int32),
            hint_tokens=hint_tokens, hint_lengths=hint_lengths,
            pose_xy=pose_xy, pose_scene=pose_scene,
            cell_bbox_xy=np.asarray(bank.bbox_w[:, 0:2], np.float64),
            cell_size=np.asarray(bank.cell_size, np.float64),
            cell_scene=cell_scene,
            jax_top_idx=top_idx, jax_pos_offsets=pos_offsets,
            jax_top10_at_15m=np.float64(accs[TOP_K][15]),
            jax_top1_at_15m=np.float64(accs[1][15]), top_k=np.int32(TOP_K))
    if "jax_rerank_top_idx" not in have:
        rr_idx, _, rr_accs = serve(RERANK_K, RERANK_LAMBDA, RERANK_GAMMA)
        out.update(
            jax_rerank_top_idx=rr_idx,
            jax_rerank_top10_at_15m=np.float64(rr_accs[TOP_K][15]),
            rerank=np.array([RERANK_K, RERANK_LAMBDA, RERANK_GAMMA]))
    if "jax_cascade_top_idx" not in have:
        cc_idx, _, cc_accs = serve(
            RERANK_K, RERANK_LAMBDA, RERANK_GAMMA, PRUNE_M, PRUNE_LAYERS,
            PRUNE_SINKHORN, cheap_bank=qb, cheap_scale=qs)
        out.update(
            jax_cascade_top_idx=cc_idx,
            jax_cascade_top10_at_15m=np.float64(cc_accs[TOP_K][15]),
            jax_cascade_top1_at_15m=np.float64(cc_accs[1][15]),
            cascade=np.array([RERANK_K, PRUNE_M, PRUNE_LAYERS,
                              PRUNE_SINKHORN, RERANK_LAMBDA, RERANK_GAMMA]))
    if "jax_rerank_scores" not in have:
        out.update(all_stage_scores())
        done = {**have, **out}
        for stage, cands, scores in (
                ("rerank", "jax_rerank_cands", "jax_rerank_scores"),
                ("cascade", "jax_cascade_kept", "jax_cascade_scores")):
            same = (top_of(done[cands], done[scores])
                    == done[f"jax_{stage}_top_idx"]).all(1).mean()
            print(f"# {stage} stage scores: their top-{TOP_K} equals the "
                  f"served top_idx on {same:.4f} of the queries", flush=True)

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **have, **out)
    print(f"# wrote {OUT} ({os.path.getsize(OUT) / 1e6:0.2f} MB)")


if __name__ == "__main__":
    main()
