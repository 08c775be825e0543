#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own ``#`` lines; any failure exits non-zero:

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build: every hand-written kernel under ``text2pos_torch/csrc`` with
   ``nvcc``, all at once; fails if ``ptxas`` reports register spills in any
   of them.
3. Kernels vs plain: each kernel's wrapper against its plain PyTorch version
   on the inputs the serving path gives it (the committed checkpoints and
   bench queries): max abs error with its tolerance, median times (CUDA
   events) of kernel, plain version and, where one exists, a one-call
   PyTorch equivalent, and the least time the card could take (bound).
   The LSTM: one launch per encoder (both directions), its time beside the
   encoder stage's (token tables + kernel) and cuDNN's packed bidirectional
   ``nn.LSTM`` with its projections. Sinkhorn: the fused dustbin kernel on
   the headline scores, its bound at the special-function units' rate
   beside the earlier all-f32 formula.
   For the GNN also: the bf16 (tensor cores) and f32 (CUDA cores) kernels'
   times side by side with their ratio, ragged pair counts around a CTA's
   load against the plain version, and bit-identical score columns for every
   headline pair whose query holds duplicate hints.
   The FPS and PointConv kernels are checked at the three set-abstraction
   levels of both object towers on the bench map's first DB-encode step of
   64 cells (JAX's draws from ``fixtures/bench_db_subset.npz``): the fine
   tower's 1024 objects and the coarse tower's valid objects; these are the
   six launches of PointConv in the DB encode's first step, and its two
   of FPS (one a PointNet++ forward, all three levels). FPS: indices and
   centroids bit-identical to the plain loop, level by level (one launch
   a level) and through the levels entry the model calls, and an object of
   one repeated point; its bound is latency, so the time per dependent
   step of each level is printed beside the latency floor (the steps
   times the dependent chain a step cannot avoid, a clock64
   microbenchmark). PointConv: bf16 (tensor cores) and f32 (CUDA cores).
4. End to end: ``LocalizationPipeline.serve_batch`` on the 2048 committed
   bench queries at top_k=10, bf16 bodies (the headline, whose kernel launch
   counts are read) and f32, then the rerank@128 batch (λ=4, γ=6);
   throughput, accuracies and agreement with the JAX outputs stored in the
   fixture; each in-cell position more than 0.01 from JAX's is classified
   (``classify_positions``: another cell than JAX's, a match-extraction
   near-tie, or unexplained; in f32 none may be unexplained). Wall times
   are medians of synchronized calls (5 for the headline, 3 for rerank). Then one f32 rerank@128 batch, whose
   ``top_idx`` must equal JAX's f32 one on every query or differ only by
   near-ties below 1e-5: where JAX's own scores of two swapped candidates
   are one (the fixture holds JAX's re-rank score of every candidate), or
   where a candidate's score moved and taking one of its match-extraction
   decisions within 1e-5 the other way gives JAX's stored score
   (``explain_stage``). Then the cascade 128 → 24 (one block pair, 6
   Sinkhorn iterations, int8 bank, λ=4, γ=6) in bf16 and f32 against JAX's
   f32 cascade, with the same rule in f32: q/s (median of 3), accuracies,
   the kernel launches of one batch (GNN, Sinkhorn and LSTM twice each),
   its profile by stage (``serve.*`` ranges), a soft cheap pass and a
   0-block one; the cascade's GNN (cheap depth, 0 blocks, full depth) and
   Sinkhorn kernels against their plain versions on the full batch's
   inputs of each pass, the cheap pass's kernel times at that width and
   the device time of its int8 dequantization.
5. Offline DB encode: the bench map rebuilt by the port's copy of the
   generator (checked against the fixture's cell boxes, sizes and scenes);
   its first 64 cells encoded with JAX's draws and held against JAX's f32
   and bf16 encodings; all 2048 cells encoded, coarse and fine, in bf16
   (``LocalizationPipeline.encode_database``, whose FPS and PointConv
   launches are read; wall time of three calls, cells/s, each tower apart, a
   profile by stage); then the 2048 queries served from the rebuilt database, and from
   one rebuilt with other draws (resampling noise between two databases).
6. Calibrate and serve: ``calibrated_for_serving`` from the checkpoints
   alone on the rebuilt map (phase 5's cell encodings) with the bench's
   calibration set (the 2048 queries' hints, the model's own top-10, 128
   cells): wall time, kernel launches, its statistics against the DB
   cache's (printed only: other draws), serving from it (headline, gated
   like phase 5, and the cascade); ``LocalizationServer`` from the bench
   Cells (build time, ``localize`` in batches of 256 with its accuracy
   gated, ``localize_stream`` equal to per-batch ``localize``) and the
   JSON-lines CLI in-process on a small synthetic map, calibrated and not.
7. Train: the recipe's training scene (seed 100) and validation scene
   (seed 77) rebuilt by the port's generator. The LSTM and Sinkhorn
   autograd Functions at the training shapes: forward (the kernel) against
   the plain version, gradients against plain autograd's. For each stage,
   from the committed checkpoint: one f32 step on the fixture's batch
   (``fixtures/bench_train_step.npz``, 32 cells / 16 poses) with JAX's
   draws, its loss, gradient leaves and BN statistics held against JAX's
   (coarse) or against the same step in float64 on the host, taken on the
   f32 step's ReLU, max, FPS and ball choices, each choice it would have
   made otherwise a near-tie (fine; JAX's f32 step read against it), and
   non-zero gradients to the language encoder (the GNN and ``bin_score``
   too, fine); the evaluation epoch on JAX's draws against
   JAX's accuracies (coarse top-k, fine recall and precision, within one
   query); 20 steps at the recipe's batch (64 / 32) with ms a step and one
   step's profile by range (``train.forward``, ``train.backward``,
   ``train.optimizer``, the plain recomputation ``*.backward_plain``, the
   kernels' device time, the device's busy share); a resume file after 10
   steps, reloaded bit for bit, and the last 10 again from it; the
   evaluation of the trained
   state against a model reloaded from its ``save_checkpoint``.
8. Evaluation: JAX's evaluator at its CLI's defaults (f32, top-k 1/5/10,
   5/10/15 m, batches of 32, fine chunks of 8) on the bench map and
   checkpoints: ``run_coarse`` (the LSTM, FPS and PointConv kernels), the
   fine bank on batch statistics and ``run_fine`` with the cache (LSTM,
   Sinkhorn and FPS kernels; the GNN as PyTorch ops, as JAX runs it),
   re-ranked at 128 (γ = 6), each stage's synchronized wall time, launches
   and queries/s; every accuracy within 2 points of JAX's at top-1/5/10
   @15m (``fixtures/bench_eval.npz``), ``coarse_random`` and the fine
   oracles equal to JAX's; a calibrated bf16 pipeline's ``run_fine`` (the
   GNN kernel must launch; its accuracies within 2 points of JAX's
   calibrated bf16 run); the uncached path (chunk 1) on 16 queries beside
   the cached rate; ``evaluation.fine`` on JAX's draws (within 2e-3 of
   JAX's stats; two controls, the LSTM kernel dropping each hint's last
   token and Sinkhorn stopping after one iteration, must read above
   that); both evaluation CLIs as subprocesses, their tables parsed.
   Every stage keeps a copy of its kernels' inputs at their first
   shapes, and each wrapper is then held against its plain version on
   them; the cached ``run_fine`` and the fine bank are profiled (device
   busy time against wall time).
9. The recipe's training (``scripts/train_bench_ckpts.py``) on phase 7's
   training scene: PointNet++ pretraining from ``bench_pointnet`` (10
   steps at batch 64, ms a step, the checkpoint written and read back, and
   the validation of the committed weights on JAX's draws within one
   object of JAX's, ``fixtures/bench_recipe.npz``); the fused coarse
   trainer with the negative bank (batch 64, embed 256; segments of 4
   steps, the bank refreshed at the start of an 8-step epoch and before
   its second segment; two epochs from the pretraining's checkpoint): its
   assembly equal to
   ``CoarseLoader``'s batch, a step equal to the host step within the
   host's run-to-run spread, the inactive bank equal to no bank, the
   refresh equal to ``encode_all_cells`` and the bank loss to float64
   within 1e-6, the step with the bank at 32 cells held to float64 on its
   own choices; the fused fine trainer with the rank-aware loss (batch 32,
   R = 4; one epoch): equal to the host step, held to float64 at 32 poses;
   ``--remat`` on both (gradients and statistics as without, peak memory
   and ms); the offsets trainer (10 steps at batch 32, a validation pass).
   Each fused segment is profiled: no synchronization and no
   host-to-device copy between steps, and the device's busy share, beside
   the host-loader steps on the same number of batches, the loader's
   host time taken alone. Launches of one step, one refresh and one rank
   step against the code's count; every kernel against its plain version
   on each stage's inputs. Last, the four training CLIs (pretraining, the
   fused coarse trainer with ``--neg_bank --remat``, the fused fine one
   with ``--rank_weight 1 --remat``, offsets) run at once as subprocesses
   on the card, each in its own directory: exit 0, finite losses, and the
   checkpoints ``train()`` keeps (pretraining's one best, named by its
   validation accuracy, each earlier best removed).
10. Data parallelism (``parallel/dp.py``) on a mesh of max(2, min(4,
   cards)) shards, card 0 repeated on a machine with fewer cards (the
   line says so; the shards then run one after another, and the times
   are no scaling figure): ``dp_serve_batch`` on the 2048 bench queries
   (headline, rerank@128, the cascade 128 → 24) in bf16 and f32 against
   ``serve_batch`` (f32 top_idx identical, bf16 top-10@15m equal), the
   DB-sharded ring at the same settings in f32 (top_idx identical) and
   its bf16 headline, ``dp_encode_all_cells`` of the bench map in f32
   against ``encode_all_coarse``'s steps on the same draws, and one DP
   step a stage at the recipe's per-device batch against the mean of the
   shards' single-device steps (phase 7's limits); ms of each beside the
   single-device run, the launches of each path, every kernel against its
   plain version on the path's inputs.
11. A ``{"kernels": [...]}`` line (each entry also with its launches by
   path: headline, cascade, DB encode, calibration, server, the two
   evaluation epochs, the two trainings, phase 8's stages,
   ``evaluator_*``, phase 9's, ``recipe_*``, phase 10's, ``dp_*``, and
   phase 12's, ``wide_*`` and ``variant_*``, phase 13's, ``k360_*``,
   ``converted_*`` and ``transformer_*``, and phase 14's, ``widest_*``,
   with the errors on phase 9's,
   phase 10's and phase 13's inputs under ``max_abs_err_by_training_path``,
   ``max_abs_err_by_dp_path`` and ``max_abs_err_by_last_modules_path`` and
   phase 12's readings under ``widths``),
   the card's name and power limit, and ``{"ok": true, "device": {...}}``
   as the last line; ``superglue_gnn_any`` (the GNN's second form) has the
   E=300 headline's launches and times, and under ``routes`` each of its
   routes (``superglue_gnn_any``: bf16 on the tensor cores, f32 on the
   CUDA cores; ``superglue_gnn_any_wide``) with every phase-12.1 and
   phase-14 timing that ran on it, its share of the bound and its launches
   by path; ``lstm_grid`` (the LSTM's form past H = 512) and
   ``sinkhorn_wide`` (Sinkhorn's form past 32 x 16 couplings) have phase
   14's path launches, times and bounds.
12. JAX's default widths and the variants (run before the line of 11):
   models at embed_dim 300 from seeded generators, the bench map
   encoded and calibrated, then 12.1 the widened kernels against their
   plain versions on the E=300 serving path's inputs (LSTM both encoders
   beside cuDNN, the GNN's second form in bf16 and f32 with ragged counts
   around its pairs a CTA and ties, Sinkhorn) and on seeded random inputs
   at LSTM H in {96, 300, 384, 512} beside cuDNN, GNN (E, T0, T1) in
   {(300, 16, 6), (128, 24, 6), (256, 32, 8)} and, on the wide route,
   (300, 32, 32) f32 and (512, 32, 32), each launch counted under its
   route (bf16 at E <= 320 on the tensor cores), and FPS N in {512, 1024,
   2048, 4096} at 1024 objects and N = 40,000 at 4 (minima in global
   memory);
   then the GNN's second form in bf16 at 12 blocks on the E=300 bf16
   pipelines at pad_size 16 and 24 ((300, 16, 6), (300, 24, 6) and
   (300, 32, 32), the latter two in CTAs of 4 m-tiles), each held per pair
   against a float64 evaluation beside the plain f32 version and, cut to
   its first two blocks, to the plain version (``depth_gate``), its ragged
   pair counts bit for bit against the whole batch; 12.2 the E=300
   headline in bf16 and f32 (q/s, launches: no tuned-GNN launch); 12.3
   the f32 headline, rerank@128 and cascade against the same pipeline
   with every kernel wrapper rebound to its plain version (differing rows
   only as near-ties), and the fine model at pad_size 24; 12.4 one f32
   coarse and fine step at E=300 against the plain versions' on the same
   choices, at phase 7's limits; 12.5 one step of each variant of the
   object encoder, and a class-embedding model's DB encode (no PointConv
   or FPS launch) and serving.
13. The last modules (run before the line of 11). 13.1: a seeded
   KITTI360-layout drive named ``2013_05_28_drive_0010_sync`` (the val
   split) over its ``SCENE_SIZES`` x extent, y cut to 3 of its 6 streets
   (printed), binary PLYs and ``poses.txt``, prepared by ``python -m
   text2pos_torch.data.prepare`` in a subprocess (the port's C++ host
   library: voxels and DBSCAN; its wall time, cells and poses), the C++
   library's voxel, DBSCAN and host-FPS outputs on the scene's objects
   equal to their numpy twins; then from ``--base_path`` with the bench
   checkpoints the evaluator with ``--dataset K360`` in f32 (tables parsed,
   wall time; accuracy only read: the weights never saw the drive) and the
   server's CLI with ``--base_path --scenes`` on queries from the prepared
   poses' descriptions, its stream equal to ``localize`` (``serve_batch``)
   on the same server; the LSTM kernel on the server's calibration text
   within 2e-5 of a float64 evaluation in both forms (W_hh in shared
   memory, and zero-padded to H = 300, from L2). 13.2: reference-style whole-model pickles at the
   bench widths and a PointNet++ state dict from seeds, BN statistics
   calibrated on a synthetic map (``utils/reference_models.py``),
   converted by the port's two CLIs; the GNN kernel on the converted
   weights against the reference module's own forward (interleaved heads);
   the bench map encoded with the converted towers and PointNet++,
   calibrated and served (2048 queries, top-10) in bf16 (ms beside phase
   4's) and f32 (``top_idx`` against the plain versions' but for phase 4's
   relative near-ties), every kernel against its plain version on the
   served inputs; the converted coarse tower's text and cell encodings
   against the reference module's own forward in float64, and its
   similarities' spread. 13.3: ``python -m text2pos_torch.train.transformer``
   at JAX's default widths (E=300, 6 blocks, 50 iterations, batch 32) for a
   few steps (exit 0, finite losses); in process one f32 step against the
   plain versions' on its choices (phase 7's limits), ms a step, busy
   share, launches, the LSTM, Sinkhorn and FPS kernels against their plain
   versions on the step's inputs. 13.4: calibrated f32 serving with
   ``T2P_FAST_GRAPH=1`` gives the same ``top_idx`` (the calibration's wall
   time with the switch off and on, in turns); ``--plot_retrievals``
   without ``cv2`` raises an ``ImportError`` naming it (a checked note).
14. Widths past JAX's defaults (run before the line of 11): a seeded dense
   map (one scene of 16 x 16 cells of 30 m at 48 objects an area; most
   cells past 48 objects) and 128 of its poses' descriptions; coarse and
   fine models at embed_dim 768, pad_size 48, 6 block pairs, from seeded
   generators (``wide_models``, ``wide_pipeline``): the DB encode,
   ``calibrated_for_serving`` and ``serve_batch`` at top-10 in bf16 and
   f32 (launches of a batch exactly: the LSTM's grid form twice, the GNN's
   wide route and Sinkhorn's wide form once each; q/s), the f32 serve
   against the plain versions' (differing rows only as near-ties). 14.2:
   the kernels on the path's inputs: the LSTM (H = 768, both encoders)
   beside cuDNN and, with the bench text encoder zero-padded to 768 and
   1024, within LSTM_F64_TOL of float64; the GNN at (768, 48, 6) in bf16
   through ``depth_gate`` with ragged counts bit for bit and ties, in f32
   within GNN_REL_TOL, and ``depth_gate`` again on at least
   WIDEST_GATE_PAIRS pairs (every pose of the map against its top cells);
   Sinkhorn on [N, 49, 7] beside its time before the redesign and its
   plan's route. 14.3: seeded random inputs: the LSTM at H in {544, 768,
   1024, 2048} (2048 queries x 64 tokens) beside cuDNN, the GNN at (516,
   16, 6), (768, 16, 6), (1024, 64, 16), (300, 48, 6), (300, 64, 64) and
   (128, 128, 6) in both dtypes.

Needs the repository checkout (the package, ``checkpoints/`` and the
fixtures) and a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import io
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT_COARSE = os.path.join(ROOT, "checkpoints", "bench_coarse.msgpack")
CKPT_FINE = os.path.join(ROOT, "checkpoints", "bench_fine.msgpack")
DB_CACHE = os.path.join(ROOT, "checkpoints", "bench_db_cache.npz")
FIXTURE = os.path.join(ROOT, "text2pos_torch", "fixtures",
                       "bench_queries.npz")
DB_FIXTURE = os.path.join(ROOT, "text2pos_torch", "fixtures",
                          "bench_db_subset.npz")
TOP_K = 10

# Published H100 SXM peaks (dense): f32 outside the tensor cores, bf16
# tensor cores, HBM bandwidth.
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# exp2/log2 on the special-function units: 16 a clock an SM on compute
# capability 9.0 (CUDA C Programming Guide, arithmetic instruction
# throughput), at the 1.98 GHz that the f32 peak implies (67e12 / (132 SMs x
# 128 FMA lanes x 2)): 132 x 16 x 1.98e9.
PEAK_SFU = 132 * 16 * 1.98e9

# Tolerances, kernel vs plain version on the same card and inputs. Both run
# f32 arithmetic in different summation orders. The GNN's tolerances are
# relative to the largest score (about 50 on the bench weights): in bf16 a
# sum that lands on the other side of a rounding boundary moves a value by
# one bf16 step (2^-8 relative), and the 12 residual blocks carry it on.
TOL = {"lstm": 1e-4, "sinkhorn": 1e-4}
GNN_REL_TOL = {"f32": 1e-5, "bf16": 1e-2}
# The gate of the GNN's second form in bf16 at serving depth (12 blocks),
# ``depth_gate``. There the plain f32 version itself lies 0.86-1.57 of
# GNN_REL_TOL from the float64 evaluation (PERF.md §6), so the kernel is
# held per pair against float64 beside the plain version: its median no
# larger, its 99.9th percentile within DEPTH_P999_RATIO of the plain
# version's, its largest within DEPTH_MAX_REL of GNN_REL_TOL; and, cut to
# its first DEPTH_CUT_BLOCKS blocks (views of the same pack), within
# GNN_REL_TOL of the plain version on every pair, where a wrong weight,
# mask or tile shows far above the rounding noise.
DEPTH_P999_RATIO = 1.05
DEPTH_MAX_REL = 2.0
DEPTH_CUT_BLOCKS = 2
ACC_SLACK = 0.01   # headline top-10@15m within 1 point of the JAX value
# PointConv kernel vs plain, relative to the largest output: f32 sums in
# another order; in bf16 that can move a value by one bf16 step.
POINTCONV_REL_TOL = {"f32": 1e-5, "bf16": 1e-2}
# Offline DB encode of the fixture's 64 cells against JAX's CPU outputs on
# the same draws: f32 max abs error on the L2-normalized encodings; bf16
# cosine of every row (the frameworks round bf16 at other places). Serving
# from the rebuilt database (the port's own draws, not JAX's) must keep
# top-10@15m within 2 points of JAX's.
DB_F32_TOL = 1e-4
DB_BF16_MIN_COS = 0.999
DB_ACC_SLACK = 0.02
# A served top_idx that differs from JAX's f32 one passes only where it is a
# near-tie (relative margin below this) that f32 sums in another order can
# flip: in JAX's re-rank scores of the two swapped candidates, or in a match
# extraction decision of a candidate whose score moved, when taking that
# decision the other way gives JAX's stored score (explain_stage).
SWAP_REL_TOL = 1e-5
# The plain GNN on this many pairs at a time (a few GiB of f32 activations).
CHUNK_PAIRS = 65536

KERNEL_SOURCES = {
    "lstm": ("text2pos_torch/csrc/lstm.cu",
             "text2pos_tpu/ops/lstm_pallas.py:60"),
    "sinkhorn": ("text2pos_torch/csrc/sinkhorn.cu",
                 "text2pos_tpu/ops/sinkhorn_pallas.py:51"),
    "superglue_gnn": ("text2pos_torch/csrc/superglue_gnn.cu",
                      "text2pos_tpu/ops/superglue_gnn_pallas.py:253"),
    "superglue_gnn_any": ("text2pos_torch/csrc/superglue_gnn_any.cu",
                          "text2pos_tpu/ops/superglue_gnn_pallas.py:253"),
    "pointconv": ("text2pos_torch/csrc/pointconv.cu",
                  "text2pos_tpu/ops/pointconv_pallas.py:91"),
    "fps": ("text2pos_torch/csrc/fps.cu",
            "text2pos_tpu/ops/fps.py:21 (lax.fori_loop; no Pallas kernel)"),
    # The LSTM's grid form (H > 512) and Sinkhorn's wide form (couplings
    # past 32 x 16): kernels of their own in the same sources.
    "lstm_grid": ("text2pos_torch/csrc/lstm.cu",
                  "text2pos_tpu/ops/lstm_pallas.py:60"),
    "sinkhorn_wide": ("text2pos_torch/csrc/sinkhorn.cu",
                      "text2pos_tpu/ops/sinkhorn_pallas.py:51"),
}


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn()`` in ms, one CUDA event pair per rep."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, launches: int = 50, reps: int = 5) -> float:
    """Device time of one ``fn()`` (kernel launches into buffers it owns,
    no allocation) in ms: a CUDA graph of ``launches`` calls, captured once
    and replayed between two events, over ``launches``. Launches back to
    back without the host's gaps, for kernels of tens of microseconds,
    whose issue from Python could otherwise hold the card back."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    return cuda_ms(g.replay, reps=reps) / launches


def kernel_name(mangled: str) -> str:
    """A kernel's own name in its mangled entry name, with its template
    arguments as mangled (``lstm_grid_kernel<Li2ELb0>``: 2, false)."""
    for m in re.finditer(r"\d+", mangled):
        name = mangled[m.end():m.end() + int(m.group())]
        if name.endswith("kernel") and len(name) == int(m.group()):
            args = re.match(r"I(\w*?)EE", mangled[m.end() + len(name):])
            return name + (f"<{args.group(1)}>" if args else "")
    return mangled


def bound_ms(flops_by_rate, nbytes: float, overlap: bool = False):
    """``(ms, by)``: max(bytes / HBM rate, Σ operations / peak rate of their
    type) and which of the two it is, "bytes" or "operations". With
    ``overlap`` the operation classes run on separate units at once (SFU
    beside the FMA pipe): the largest of their times instead of the sum."""
    times = [f / rate for f, rate in flops_by_rate]
    t_ops = max(times) if overlap else sum(times)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes > t_ops else "operations"


def sum_bound(res: dict, bnd: float, by: str) -> None:
    """Adds one launch's bound to a kernel's entry that sums several
    (``bound_ms_by``: the sum split by what bounds each launch); the entry
    is bound by what bounds the larger part of the sum."""
    res["bound_ms"] += bnd
    part = res.setdefault("bound_ms_by", {"bytes": 0.0, "operations": 0.0})
    part[by] += bnd
    res["bound_by"] = max(part, key=part.get)


def max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def check(name: str, err: float, tol: float, failures: list) -> None:
    ok = err <= tol and math.isfinite(err)
    log(f"  {name}: max_abs_err={err:.3e} (tolerance {tol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{name}: max_abs_err {err} > {tol}")


def lstm_checks(pipe, fx, failures):
    """Kernel vs plain for the two LSTM launches of one serve_batch (coarse
    text and fine hints, both directions a launch); the encoder stage
    (token tables + kernel + mean) beside cuDNN's packed bidirectional
    nn.LSTM on the embedded tokens, input projections included."""
    from text2pos_torch.ops.lstm import _lstm_kernel, lstm_final_hidden_plain

    dev = pipe.device
    out = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "max_abs_err": 0.0, "stage_ms": 0.0, "detail": []}
    encoders = (
        ("coarse", pipe.coarse.language_encoder,
         torch.as_tensor(fx["tokens"]), torch.as_tensor(fx["lengths"])),
        ("fine", pipe.fine.language_encoder,
         torch.as_tensor(fx["hint_tokens"]).flatten(0, 1),
         torch.as_tensor(fx["hint_lengths"]).flatten()))
    for label, enc, tokens, lengths in encoders:
        tokens, lengths = tokens.to(dev), lengths.to(dev)
        B, T = tokens.shape
        with torch.inference_mode():
            tables = enc.token_tables()
            w_hh = [enc._params(d).w_hh for d in ("fwd", "bwd")]
            V, H4 = tables[0].shape
            H, E = H4 // 4, enc.word_embedding.weight.shape[1]
            got = _lstm_kernel(tables, w_hh, tokens, lengths)
            want = lstm_final_hidden_plain(tables, w_hh, tokens, lengths)
            torch.cuda.synchronize()
            err = max_err(got, want)
            check(f"lstm {label} T={T} B={B} H={H} V={V} (both directions)",
                  err, TOL["lstm"], failures)
            ms = cuda_ms(lambda: _lstm_kernel(tables, w_hh, tokens, lengths))
            stage_ms = cuda_ms(lambda: enc(tokens, lengths))
            plain_ms = cuda_ms(lambda: lstm_final_hidden_plain(
                tables, w_hh, tokens, lengths), reps=3)
            x = enc.word_embedding(tokens) * (tokens != 0)[..., None]
            lib = torch.nn.LSTM(E, H, bidirectional=True).to(dev)
            packed = torch.nn.utils.rnn.pack_padded_sequence(
                x.transpose(0, 1).float(), lengths.clamp(1, T).cpu(),
                enforce_sorted=False)
            lib_ms = cuda_ms(lambda: lib(packed))
        steps = float(lengths.clamp(0, T).sum())
        # The kernel: the recurrent products of the valid steps, both
        # directions, in the arithmetic it uses, 3xTF32 (three TF32 passes
        # at the tensor cores' rate); the table products of the stage (V x
        # E x 4H each) in f32. Bytes: tokens, lengths, both tables and W_hh,
        # the [2, B, H] output; the stage adds embedding, W_ih and bias.
        flops = 2 * 2.0 * steps * H * H4
        nbytes = 4.0 * (B * T + B + 2 * V * H4 + 2 * H * H4 + 2 * B * H)
        bnd, by = bound_ms([(3 * flops, PEAK_TF32)], nbytes)
        stage_bnd, _ = bound_ms([(3 * flops, PEAK_TF32),
                                 (2 * 2.0 * V * E * H4, PEAK_F32)],
                                nbytes + 4.0 * 2 * (V * E + E * H4 + H4))
        f32_bnd, _ = bound_ms([(flops, PEAK_F32)], nbytes)
        log(f"  lstm {label}: kernel {ms:.3f} ms (bound {bnd:.4f} ms: 3 TF32 "
            f"passes at {PEAK_TF32 / 1e12:.0f} TFLOP/s; one f32 pass at "
            f"{PEAK_F32 / 1e12:.0f} TFLOP/s {f32_bnd:.4f} ms), stage (tables "
            f"+ kernel + mean) {stage_ms:.3f} ms (bound {stage_bnd:.4f} ms), "
            f"cuDNN nn.LSTM (bidirectional, packed, projections included) "
            f"{lib_ms:.3f} ms, plain {plain_ms:.3f} ms; {steps:.0f} valid "
            "steps")
        out["ms"] += ms
        out["plain_ms"] += plain_ms
        out["stage_ms"] += stage_ms
        sum_bound(out, bnd, by)
        out["library_ms"] += lib_ms
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["detail"].append({"encoder": label, "T": T, "B": B, "H": H,
                              "V": V, "ms": ms, "stage_ms": stage_ms,
                              "plain_ms": plain_ms, "bound_ms": bnd,
                              "stage_bound_ms": stage_bnd,
                              "bound_ms_f32_fma": f32_bnd, "bound_by": by,
                              "library_ms": lib_ms, "max_abs_err": err})
    return out


def gnn_bound(d0, d1, packed, label: str):
    """(bound ms, what bounds it, TFLOP) of one GNN kernel launch on
    d0 [N, T0, E], d1 [N, T1, E] with the blocks of ``packed``, at the real
    widths: a padded pack's zero rows and columns are work and bytes no
    caller needs."""
    N, T0, E = d0.shape
    T1 = d1.shape[1]
    L = packed["wqkv"].shape[0]
    P = T0 + T1
    # Per pair: projections, merge and block MLPs of all rows in every
    # block plus the final projection (matmuls, compute dtype); the
    # attention contractions (QK^T and PV over real tokens: self blocks
    # 16x16 and 6x6, cross blocks 16x6 twice) and the score matrix, whose
    # operands are rounded to the compute dtype too (f32 accumulation).
    mm = 2.0 * P * (E * 3 * E + E * E + 2 * E * 2 * E + 2 * E * E) * L \
        + 2.0 * P * E * E
    attn = 2 * 2.0 * E * (L // 2) * (T0 * T0 + T1 * T1 + 2 * T0 * T1) \
        + 2.0 * E * T0 * T1
    # Weights at the real width: 10·E² matmul values and 13·E vector
    # values a block (f32), then the final projection.
    size = packed["wqkv"].element_size()
    wbytes = L * (10 * E * E * size + 13 * E * 4) + E * E * size + E * 4
    nbytes = d0.numel() * 4 + d1.numel() * 4 + wbytes + N * T0 * T1 * 4
    rate = PEAK_BF16 if label == "bf16" else PEAK_F32
    return (*bound_ms([(N * (mm + attn), rate)], nbytes),
            N * (mm + attn) / 1e12)


def gnn_route(E: int, T0: int, T1: int, dtype):
    """(launch name, pairs a CTA, first hint row or None) of the GNN kernel
    that takes this shape: the tuned kernel at its shape, else the second
    form's plan (``any_plan``). The first hint row is that of the
    tensor-core layouts (objects of the CTA's pairs, then their hints, in
    16-row tiles); the f32 routes keep rows pair by pair."""
    from text2pos_torch.ops.superglue_gnn import (KERNEL_SHAPE, TC_PAIRS,
                                                  any_plan)

    if (E, T0, T1) == KERNEL_SHAPE:
        bf16 = dtype == torch.bfloat16
        return "superglue_gnn", TC_PAIRS, TC_PAIRS * T0 if bf16 else None
    plan = any_plan(E, T0, T1, dtype)
    return plan.route, plan.pairs, plan.hint_row


def sinkhorn_bound(B: int, M: int, N: int, iters: int):
    """(bound ms, what bounds it) of one fused Sinkhorn launch on [B, M-1,
    N-1] scores. exp2 of 2·M·N values and log2 of M + N sums an iteration
    on the SFUs; on the FMA pipe add, max, subtract, scale and sum per
    value and pass (10 f32 operations); the two units run at once. Bytes:
    the scores in, the [B, M, N] log transport out."""
    sfu = float(iters) * B * (2 * M * N + M + N)
    nbytes = 4.0 * (B * (M - 1) * (N - 1) + B * M * N)
    return bound_ms([(sfu, PEAK_SFU), (10.0 * iters * B * M * N, PEAK_F32)],
                    nbytes, overlap=True)


def pair_descriptors(pipe, fx, top):
    """The GNN's inputs for the pose-cell pairs of ``top`` [Q, K] (cell
    indices of each query's candidates): the cells' descriptors d0 [Q·K,
    T0, E] from ``pipe``'s fine bank and the queries' hint encodings d1
    [Q·K, T1, E], each repeated K times, as ``serve_batch`` pairs them."""
    dev = pipe.device
    idx = torch.as_tensor(top.astype("int64"), device=dev).reshape(-1)
    with torch.inference_mode():
        hint_enc = pipe.fine.encode_hints(
            torch.as_tensor(fx["hint_tokens"], device=dev),
            torch.as_tensor(fx["hint_lengths"], device=dev))
        d1 = hint_enc.repeat_interleave(top.shape[1], dim=0).contiguous()
        d0 = pipe.fine_bank_enc[idx].contiguous()
    return d0, d1


def gnn_sinkhorn_checks(pipe_bf16, pipe_f32, fx, failures, top_idx=None,
                        reps=5):
    """Kernel vs plain for the GNN (bf16 and f32) and Sinkhorn at the
    headline serve's pose-cell pairs (the JAX top-10 cells, or ``top_idx``
    [Q, K] of a path without JAX's): within GNN_REL_TOL of the plain
    version with ragged pair counts against it, but the second form's bf16
    routes (the E=300 and wider pipelines), which take ``gnn_depth_check``
    with ragged counts bit for bit against the whole batch. The kernel's
    time: the median of ``reps`` calls."""
    from text2pos_torch.ops import _build
    from text2pos_torch.ops.superglue_gnn import (_gnn_kernel,
                                                  gnn_scores_plain)

    top = fx["jax_top_idx"] if top_idx is None else top_idx
    d0, d1 = pair_descriptors(pipe_bf16, fx, top)
    N, T0, E = d0.shape
    T1 = d1.shape[1]
    results = {}
    scores_bf16 = None
    for label, pipe in (("bf16", pipe_bf16), ("f32", pipe_f32)):
        packed = pipe.fine.superglue.packed_kernel_params()
        route = gnn_route(E, T0, T1, packed["wqkv"].dtype)[0]
        before = _build.LAUNCHES[route]
        with torch.inference_mode():
            got = _gnn_kernel(d0, d1, packed)
            torch.cuda.synchronize()
        if _build.LAUNCHES[route] != before + 1:
            failures.append(f"GNN {label} at {E}, {T0}x{T1}: no launch of "
                            f"{route}")
        what = (f"{route} {label} N={N} {T0}x{T1} E={E} "
                f"blocks={packed['wqkv'].shape[0]}")
        # The second form's bf16 routes at serving depth (the E=300
        # pipelines of phase 12.1, phase 14's) take the depth gate.
        at_depth = label == "bf16" and route != "superglue_gnn"
        if at_depth:
            gate = gnn_depth_check(what, got, d0, d1, packed, failures)
            err = gate["max_abs_err"]
        else:
            with torch.inference_mode():
                want = gnn_scores_plain(d0, d1, packed)
            err = max_err(got, want)
            scale = float(want.abs().max())
            check(f"{what} (|scores| max {scale:.2f})", err,
                  GNN_REL_TOL[label] * scale, failures)
        ms = cuda_ms(lambda: _gnn_kernel(d0, d1, packed), reps=reps,
                     warmup=2 if reps > 1 else 0)
        with torch.inference_mode():
            plain_ms = cuda_ms(lambda: gnn_scores_plain(d0, d1, packed),
                               reps=3, warmup=1)
        bnd, by, tflop = gnn_bound(d0, d1, packed, label)
        log(f"  {route} {label}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bnd:.4f} ms "
            f"({tflop:.3f} TFLOP; {100 * bnd / ms:.1f}% of the bound)")
        results[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                          "bound_by": by, "library_ms": None,
                          "max_abs_err": err, "route": route,
                          "bound_share": bnd / ms}
        if at_depth:
            results[label]["depth_gate"] = gate
        gnn_edge_checks(label, d0, d1, packed, got, failures, depth=at_depth)
        if label == "bf16":
            scores_bf16 = got
    ratio = results["f32"]["ms"] / results["bf16"]["ms"]
    log(f"  GNN at N={N}, E={E}: f32 ({results['f32']['route']}) "
        f"{results['f32']['ms']:.3f} ms, bf16 ({results['bf16']['route']}) "
        f"{results['bf16']['ms']:.3f} ms, f32 / bf16 = {ratio:.2f}")

    results["sinkhorn"] = sinkhorn_checks(pipe_bf16, scores_bf16, failures)
    return results


def sinkhorn_checks(pipe, scores, failures):
    """The fused dustbin kernel on the headline's scores against its plain
    version; bound by the new (SFU) and the earlier (all f32) formula."""
    from text2pos_torch.ops.sinkhorn import (_lot_kernel,
                                             log_optimal_transport_plain)

    sg = pipe.fine.superglue
    alpha = sg.bin_score.detach()
    iters = sg.sinkhorn_iterations
    B, M, N = scores.shape[0], scores.shape[1] + 1, scores.shape[2] + 1
    with torch.inference_mode():
        want = log_optimal_transport_plain(scores, alpha, iters)
        got = _lot_kernel(scores, alpha, iters)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(f"sinkhorn B={B} {M}x{N} iters={iters} dustbins in the kernel",
              err, TOL["sinkhorn"], failures)
        ms = cuda_ms(lambda: _lot_kernel(scores, alpha, iters), reps=20)
        device_ms = graph_ms(lambda: _lot_kernel(scores, alpha, iters))
        plain_ms = cuda_ms(lambda: log_optimal_transport_plain(
            scores, alpha, iters), reps=5)
    bnd, by = sinkhorn_bound(B, M, N, iters)
    # The formula before this slice: exp as one f32 operation, all at the
    # f32 rate, couplings and marginals in.
    old, _ = bound_ms([(10.0 * iters * B * M * N, PEAK_F32)],
                      4.0 * (2 * B * M * N + B * (M + N)))
    log(f"  sinkhorn (fused dustbins): kernel {ms:.3f} ms (device "
        f"{device_ms:.4f} ms in a CUDA graph), plain "
        f"{plain_ms:.3f} ms, bound {bnd:.4f} ms "
        f"({float(iters) * B * (2 * M * N + M + N):.3g} SFU "
        f"operations at {PEAK_SFU / 1e12:.2f}e12/s; by the earlier all-f32 "
        f"formula {old:.4f} ms)")
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": None,
            "max_abs_err": err, "bound_ms_all_f32": old}


def depth_gate(got, plain, ref64, cut_got, cut_plain):
    """The gate of the second form's bf16 scores at serving depth: ``got``
    the kernel's, ``plain`` the plain f32 version's and ``ref64`` the
    float64 evaluation's (``gnn_scores_plain(..., acc=torch.float64)``, the
    same rounding points) scores [N, T0, T1] of the same inputs, and
    ``cut_got``, ``cut_plain`` the kernel's and the plain version's after
    the first DEPTH_CUT_BLOCKS blocks. Per pair, d is the largest |score -
    float64 score| over GNN_REL_TOL of the float64 scores' largest. Passes
    only if (a) the kernel's median d is no larger than the plain
    version's, (b) its 99.9th percentile no larger than DEPTH_P999_RATIO
    times the plain version's, (c) its largest d at most DEPTH_MAX_REL, and
    (d) the cut scores lie within GNN_REL_TOL of the plain version's
    (relative to their largest) on every pair. Also reads the earlier
    gates: the largest error against the plain version over GNN_REL_TOL of
    its largest score and the pairs past it (``old_ok``), and that or no
    farther from float64 than the plain version in the largest d and the
    pairs past 1 (``old_f64_ok``). Returns (ok, readings)."""
    rel = GNN_REL_TOL["bf16"]

    def per_pair(x, ref):
        ref = ref.double()
        return (x.double() - ref).abs().amax((1, 2)) / (
            rel * float(ref.abs().max()))

    dk, dp = per_pair(got, ref64), per_pair(plain, ref64)
    dc, do = per_pair(cut_got, cut_plain), per_pair(got, plain)
    q = torch.tensor([0.5, 0.999], dtype=torch.float64, device=dk.device)
    (mk, pk), (mp, pp) = (torch.quantile(d, q).tolist() for d in (dk, dp))
    r = {"median": mk, "plain_median": mp, "p999": pk, "plain_p999": pp,
         "max": float(dk.max()), "plain_max": float(dp.max()),
         "pairs_past": int((dk > 1).sum()),
         "plain_pairs_past": int((dp > 1).sum()),
         "cut_max": float(dc.max()), "cut_pairs_past": int((dc > 1).sum()),
         "old_max": float(do.max()), "old_pairs_past": int((do > 1).sum())}
    r["a"] = mk <= mp
    r["b"] = pk <= DEPTH_P999_RATIO * pp
    r["c"] = r["max"] <= DEPTH_MAX_REL
    r["d"] = r["cut_max"] <= 1.0
    r["old_ok"] = r["old_max"] <= 1.0
    r["old_f64_ok"] = r["old_ok"] or (
        r["max"] <= r["plain_max"]
        and r["pairs_past"] <= r["plain_pairs_past"])
    return all(r[k] for k in "abcd"), r


def depth_gate_line(r) -> str:
    """``depth_gate``'s readings, printed on one line."""
    mark = lambda k: "ok" if r[k] else "FAIL"
    return (f"(a) median {r['median']:.4f} against the plain version's "
            f"{r['plain_median']:.4f} {mark('a')}; (b) p99.9 {r['p999']:.4f}"
            f" against {r['plain_p999']:.4f} (x{DEPTH_P999_RATIO:g}) "
            f"{mark('b')}; (c) largest {r['max']:.3f} (limit "
            f"{DEPTH_MAX_REL:g}; the plain version's {r['plain_max']:.3f}; "
            f"pairs past 1: {r['pairs_past']}, the plain version's "
            f"{r['plain_pairs_past']}) {mark('c')}; (d) at "
            f"{DEPTH_CUT_BLOCKS} blocks {r['cut_max']:.3f} of GNN_REL_TOL "
            f"from the plain version ({r['cut_pairs_past']} pairs past) "
            f"{mark('d')}; earlier gates (readings): {r['old_max']:.3f} of "
            f"GNN_REL_TOL from the plain version, {r['old_pairs_past']} "
            f"pairs past, {'pass' if r['old_ok'] else 'fail'}; with the "
            f"float64 escape {'pass' if r['old_f64_ok'] else 'fail'}")


def first_blocks(packed, blocks: int = DEPTH_CUT_BLOCKS):
    """The pack cut to its first ``blocks`` blocks: views of the stacked
    weights, the final projection shared (as ``packed_kernel_params``
    cuts a model's depth)."""
    from text2pos_torch.ops.superglue_gnn import UNSTACKED

    return {k: v if k in UNSTACKED else v[:blocks] for k, v in packed.items()}


def f64_scores(d0, d1, packed):
    """``gnn_scores_plain(..., acc=torch.float64)`` in chunks of 4096
    pairs."""
    from text2pos_torch.ops.superglue_gnn import gnn_scores_plain

    return torch.cat([gnn_scores_plain(d0[i:i + 4096], d1[i:i + 4096],
                                       packed, acc=torch.float64)
                      for i in range(0, len(d0), 4096)])


def gnn_depth_check(name, got, d0, d1, packed, failures):
    """``depth_gate`` of the second form's bf16 scores ``got`` at serving
    depth on d0, d1 with ``packed``, the kernel launched again on them at
    DEPTH_CUT_BLOCKS blocks. Logs the readings, adds a failure where the
    gate fails, returns the readings with ``ok``."""
    from text2pos_torch.ops.superglue_gnn import _gnn_kernel, gnn_scores_plain

    cut = first_blocks(packed)
    with torch.inference_mode():
        cut_got = _gnn_kernel(d0, d1, cut)
        plain = gnn_scores_plain(d0, d1, packed)
        ref = f64_scores(d0, d1, packed)
        cut_plain = gnn_scores_plain(d0, d1, cut)
        torch.cuda.synchronize()
    ok, r = depth_gate(got, plain, ref, cut_got, cut_plain)
    log(f"  {name}, {len(d0)} pairs: {depth_gate_line(r)}: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{name}: the depth gate fails: {r}")
    return dict(r, ok=ok, max_abs_err=float((got - plain).abs().max()))


def gnn_edge_checks(label, d0, d1, packed, got, failures, depth=False):
    """Ragged pair counts around a CTA's load against the plain version
    (with ``depth``, bit for bit against the same pairs of the whole
    batch ``got``, which sit in the same CTA slots: a pair's sums do not
    depend on its CTA's other pairs, and the batch itself is held to
    ``gnn_depth_check``), and exact ties: wherever a headline pair's query
    holds equal hints, their score columns must be bit-identical (match
    extraction then takes the first, as JAX does), whichever tiles of the
    kernel's layout they lie in."""
    from text2pos_torch.ops.superglue_gnn import (_gnn_kernel, f32_pairs,
                                                  gnn_scores_plain)

    N, T0, E = d0.shape
    T1 = d1.shape[1]
    route, G, objr = gnn_route(E, T0, T1, packed["wqkv"].dtype)
    counts = {1, max(G - 1, 1), G + 1}
    tuned_f32 = route == "superglue_gnn" and label == "f32"
    if tuned_f32 and N > 1:
        # Few pairs take one a CTA; the batch less one pair ends in a
        # partial CTA of the form the whole batch takes: bit for bit
        # against those pairs of the whole batch.
        counts.add(N - 1)
    for n in sorted(counts):
        pairs = f32_pairs(n, d0.device) if tuned_f32 else G
        name = f"{route} {label} ragged N={n} ({pairs} pairs a CTA)"
        with torch.inference_mode():
            g = _gnn_kernel(d0[:n].contiguous(), d1[:n].contiguous(), packed)
            torch.cuda.synchronize()
        if depth or n == N - 1:
            same = bool(torch.equal(g, got[:n]))
            log(f"  {name}: bit-identical to those pairs of the whole batch "
                f"{'ok' if same else 'FAIL'}")
            if not same:
                failures.append(f"{name}: differs from the whole batch")
            continue
        with torch.inference_mode():
            w = gnn_scores_plain(d0[:n], d1[:n], packed)
            torch.cuda.synchronize()
        check(name, max_err(g, w), GNN_REL_TOL[label] * float(w.abs().max()),
              failures)
    # Equal hint rows (i < j) of a pair, over all pairs.
    i, j = torch.triu_indices(T1, T1, 1, device=d1.device)
    same = (d1[:, i] == d1[:, j]).all(-1)                     # [N, pairs]
    col_same = (got[:, :, i] == got[:, :, j]).all(1)          # [N, pairs]
    broken = int((same & ~col_same).sum())
    # The 16-row tile of hint j of a pair in a tensor-core CTA: its hint
    # rows follow the CTA's object rows, pair by pair.
    across = 0
    if objr is not None:
        pair = torch.arange(d1.shape[0], device=d1.device)[:, None]
        tiles = (objr + T1 * (pair % G)
                 + torch.arange(T1, device=d1.device)) // 16
        across = int((same & (tiles[:, i] != tiles[:, j])).sum())
    log(f"  {route} {label} exact ties: {int(same.sum())} duplicate "
        f"hint pairs in {int(same.any(-1).sum())} of {d1.shape[0]} pose-cell "
        f"pairs ({across} across two 16-row tiles), {broken} with differing "
        f"score columns {'ok' if broken == 0 else 'FAIL'}")
    if broken:
        failures.append(f"{route} {label}: {broken} duplicate hint "
                        "pairs lost their exact tie")
    if not int(same.sum()):
        failures.append(f"{route} {label}: the headline inputs hold "
                        "no duplicate hints to check ties on")


def serve_all(pipe, fx, top_k, *rerank, reps: int = 1, **cascade):
    """Serve every fixture query in one batch; returns numpy results and
    the median wall time of ``reps`` synchronized runs."""
    args = [torch.as_tensor(fx[k]).to(pipe.device)
            for k in ("tokens", "lengths", "hint_tokens", "hint_lengths")]
    times, res = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipe.serve_batch(*args, top_k, *rerank, **cascade)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    top_idx, _, pos_offsets, _ = (r.cpu().numpy() for r in res)
    return top_idx.astype("int64"), pos_offsets.astype("float32"), \
        statistics.median(times)


def profile_serve(pipe, fx) -> None:
    """Device time of one headline serve_batch by stage (the ``serve.*``
    profiler ranges) and by kernel (torch.profiler), the device's busy
    share of the call's wall time, and the GEMMs PyTorch launches."""
    prof = profile_ranges(lambda: serve_all(pipe, fx, TOP_K), "serve.")
    log_ranges("profile of one headline serve_batch", prof)
    if prof is not None:
        gemms = [(ms, n, key) for key, (ms, n) in prof[2].items()
                 if "gemm" in key.lower()]
        log(f"  GEMM kernels in the profile: {len(gemms)}; "
            + "; ".join(f"{ms:.3f} ms {n}x {key[:70]}"
                        for ms, n, key in gemms))


def subset_points(bt, dbx, dev):
    """The fine tower's input for the bench map's first cells, built from
    JAX's draws in the DB fixture."""
    from text2pos_torch.evaluation.pipeline import fine_cell_points

    n, pad = dbx["fine_u"].shape[:2]
    return fine_cell_points(
        bt, torch.arange(n, device=dev), pad,
        u=torch.as_tensor(dbx["fine_u"], device=dev),
        pad_pts=torch.as_tensor(dbx["fine_pad_pts"], device=dev))


def tower_points(bt, dbx, dev):
    """(tower, points [B, 256, 3], colours) of the DB encode's first step on
    JAX's draws: the fine tower's 1024 objects, the coarse tower's valid
    ones."""
    from text2pos_torch.evaluation.pipeline import coarse_cell_points

    n = dbx["fine_u"].shape[0]
    xyz, rgb, _, _ = subset_points(bt, dbx, dev)
    with torch.inference_mode():
        cxyz, crgb = coarse_cell_points(
            bt, torch.arange(n, device=dev),
            u=torch.as_tensor(dbx["coarse_u"], device=dev))[:2]
    return (("fine", xyz.flatten(0, 1), rgb.flatten(0, 1)),
            ("coarse", cxyz, crgb))


def fps_checks(bt, dbx, failures):
    """The FPS kernel against the plain loop on a DB-encode step's points of
    both towers. Each level alone (``t2p_fps``, JAX's per-level contract;
    each level on the centroids of the level before): indices and
    centroids bit for bit, one wrapper call between two events (the host's
    work in the wrapper included, as for every kernel here) and the
    device's time a launch from a CUDA graph of 50 launches (``graph_ms``:
    preallocated outputs, no wrapper, no host gaps; issued from the host,
    the launches of sa2 and sa3 wait on it). Then the levels entry the
    model calls (one launch
    a forward for the three levels): bit for bit against the per-level
    plain loop, one wrapper call, the device's time a launch in a graph,
    and the time per dependent step of each level, read as the difference
    between launches of its first one, two and three levels; beside it the
    latency floor, the steps times the dependent chain a step cannot avoid
    (``chain_step_time``, a clock64 microbenchmark). Then an object of one
    repeated point (every step ties everywhere) through both entries."""
    from text2pos_torch.ops.fps import (_buffers, _fps_kernel,
                                        _fps_levels_kernel, _launch,
                                        chain_step_time,
                                        farthest_point_sampling_plain,
                                        level_sizes)

    dev = torch.device("cuda")
    ratios = (0.5, 0.5, 0.5)
    chain = sorted(chain_step_time(dev) for _ in range(3))[1]
    log(f"  fps dependent chain a step (shuffle, sub, mul, 2 FMA, min, warp "
        f"max, ballot, ffs; clock64 over 65,536 steps of one warp): "
        f"{chain[0]:.1f} clocks = {chain[1]:.2f} ns")
    res = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "library_ms": None, "max_abs_err": 0.0, "latency_floor_ms": 0.0,
           "chain_clocks_per_step": chain[0], "chain_ns_per_step": chain[1],
           "levels": [], "per_level": []}
    for tower, pos0, _ in tower_points(bt, dbx, dev):
        B, N, _ = pos0.shape
        sizes = level_sizes(N, ratios)
        pos, wants = pos0, []
        for level, S in zip(("sa1", "sa2", "sa3"), sizes):
            N = pos.shape[1]
            with torch.inference_mode():
                idx, cent = _fps_kernel(pos, S)
                widx, wcent = farthest_point_sampling_plain(pos, S)
                torch.cuda.synchronize()
                ms = cuda_ms(lambda: _fps_kernel(pos, S), reps=20)
                bufs = _buffers(pos, (S,))[:3]
                dev_ms = graph_ms(lambda: _launch(pos, *bufs, (S,)))
                plain_ms = cuda_ms(lambda: farthest_point_sampling_plain(
                    pos, S), reps=3, warmup=1)
            same = int((idx == widx).all(-1).sum())
            err = max_err(cent, wcent)
            ok = same == B and err == 0.0
            # Bytes: points in, int64 indices and f32 centroids out;
            # operations: 3 subtractions, a product, 2 FMAs, a min and a
            # compare per point and step, at the f32 rate.
            bnd, by = bound_ms([(8.0 * B * N * (S - 1), PEAK_F32)],
                               4.0 * 3 * B * N + (8 + 12) * B * S)
            step_us = 1e3 * dev_ms / max(S - 1, 1)
            log(f"  fps {tower} {level} B={B} N={N} S={S}: {same}/{B} "
                f"objects with bit-identical indices, centroid max abs err "
                f"{err:.1e} {'ok' if ok else 'FAIL'}; one level a launch: "
                f"kernel {ms:.4f} ms a call, {dev_ms:.4f} ms a launch in a "
                f"graph = {step_us:.3f} us per dependent step, plain "
                f"{plain_ms:.3f} ms, bound {bnd:.5f} ms ({by})")
            if not ok:
                failures.append(f"fps {tower} {level}: {B - same} objects "
                                f"differ from the plain loop, centroid error "
                                f"{err}")
            res["plain_ms"] += plain_ms
            sum_bound(res, bnd, by)
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["per_level"].append({
                "level": f"{tower} {level}", "B": B, "N": N, "S": S,
                "ms": ms, "device_ms": dev_ms, "us_per_step": step_us,
                "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                "identical": same})
            wants.append((widx, wcent))
            pos = wcent
        with torch.inference_mode():
            got = _fps_levels_kernel(pos0, ratios)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: _fps_levels_kernel(pos0, ratios), reps=20)
            bufs = _buffers(pos0, sizes)[:3]
            lv_ms = [graph_ms(lambda: _launch(pos0, *bufs, sizes[:L]))
                     for L in (1, 2, 3)]
        same = [int(((i == wi).all(-1) & (c == wc).all(-1).all(-1)).sum())
                for (i, c), (wi, wc) in zip(got, wants)]
        err = max(max_err(c, wc) for (_, c), (_, wc) in zip(got, wants))
        ok = same == [B] * 3 and err == 0.0
        step_us = [1e3 * (t - (lv_ms[l - 1] if l else 0.0)) / max(S - 1, 1)
                   for l, (t, S) in enumerate(zip(lv_ms, sizes))]
        floor = sum(S - 1 for S in sizes) * chain[1] * 1e-6
        log(f"  fps levels {tower} B={B} N={pos0.shape[1]} S={sizes}: "
            f"{same} objects bit-identical to the per-level plain loop, "
            f"centroid max abs err {err:.1e} {'ok' if ok else 'FAIL'}; "
            f"kernel {ms:.4f} ms a call, {lv_ms[-1]:.4f} ms a launch in a "
            f"graph (first level {lv_ms[0]:.4f}, two {lv_ms[1]:.4f}); us per "
            f"dependent step "
            + ", ".join(f"{u:.3f}" for u in step_us)
            + f"; latency floor {floor:.4f} ms")
        if not ok:
            failures.append(f"fps levels {tower}: {same} of {B} objects "
                            f"equal the plain loop, centroid error {err}")
        res["ms"] += ms
        res["device_ms"] += lv_ms[-1]
        res["latency_floor_ms"] += floor
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["levels"].append({"tower": tower, "B": B, "sizes": sizes,
                              "ms": ms, "device_ms": lv_ms[-1],
                              "device_ms_first_levels": lv_ms[:2],
                              "us_per_step": step_us,
                              "latency_floor_ms": floor, "identical": same})
    log(f"  fps a DB-encode step (two launches of the levels entry): kernel "
        f"{res['ms']:.4f} ms in two calls, {res['device_ms']:.4f} ms of "
        f"device time; latency floor {res['latency_floor_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.5f} ms ({res['bound_by']})")
    one = torch.full((3, 256, 3), 0.25, device=dev)
    one[1] = torch.randn(256, 3, device=dev)
    idx, cent = _fps_kernel(one, 128)
    widx, wcent = farthest_point_sampling_plain(one, 128)
    got = _fps_levels_kernel(one, ratios)
    ok = bool((idx == widx).all()) and bool((idx[0] == 0).all()) and \
        bool((cent == wcent).all()) and torch.equal(got[0][0], widx) and \
        all(bool((i[0] == 0).all()) for i, _ in got)
    log(f"  fps, an object of one repeated point: every index 0 and equal "
        f"to the plain loop's, one level and the levels entry "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("fps: the all-duplicate object differs")
    return res


def pointconv_checks(pipe_bf16, pipe_f32, bt, dbx, failures):
    """Kernel vs plain at the three SA levels of both towers on the
    fixture's 64 cells, the DB encode's first step (fine: 1024 objects;
    coarse: the cells' valid objects), each level fed by the kernel's output
    of the level before, bf16 then f32. Times are summed over the six
    levels: one step of the main path."""
    from text2pos_torch.models.pointnet2 import K_CAP
    from text2pos_torch.ops.neighbors import pairwise_sqdist
    from text2pos_torch.ops.pointconv import (_pointconv_kernel,
                                              pointconv_max_plain)

    towers = tower_points(bt, dbx, pipe_bf16.device)
    results = {}
    for label, pipe in (("bf16", pipe_bf16), ("f32", pipe_f32)):
        res = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "library_ms": None, "max_abs_err": 0.0, "detail": []}
        for tower, pos, x in towers:
            pn = getattr(pipe, tower).object_encoder.pointnet
            for name in ("sa1", "sa2", "sa3"):
                lvl = pointconv_level(getattr(pn, name), x, pos, label,
                                      f"{tower} {name}", K_CAP,
                                      pairwise_sqdist, _pointconv_kernel,
                                      pointconv_max_plain, failures)
                x, pos = lvl.pop("out")
                for k in ("ms", "plain_ms"):
                    res[k] += lvl[k]
                sum_bound(res, lvl["bound_ms"], lvl["bound_by"])
                res["max_abs_err"] = max(res["max_abs_err"],
                                         lvl["max_abs_err"])
                res["detail"].append(lvl)
        results[label] = res
    return dict(results["bf16"], f32=results["f32"])


def pointconv_level(sa, x, pos, label, where, k_cap, pairwise_sqdist,
                    kernel, plain, failures):
    """One SA level's kernel against its plain version: error, times and
    bound; ``out`` is the kernel's output and the level's centroids. The
    kernel is called as the model calls it (bf16: W2 packed once)."""
    r = sa.radius
    with torch.inference_mode():
        args = sa.pointconv_args(x, pos)
        w2f = sa.w2_fragments() if label == "bf16" else None
        got = kernel(*args, r, k_cap, w2f)
        want = plain(*args, r, k_cap)
        torch.cuda.synchronize()
        a, p, c, cent, _, w2, _, _ = args
        in_ball = pairwise_sqdist(cent, p) <= r * r
        before = torch.cumsum(in_ball, -1) - in_ball.int()
        rows = float((in_ball & (before < k_cap)).sum())
    B, N, C1 = a.shape
    S, C2 = cent.shape[1], w2.shape[1]
    err = max_err(got, want)
    scale = float(want.float().abs().max())
    check(f"pointconv {label} {where} B={B} N={N} S={S} C1={C1} C2={C2} "
          f"r={r} (|out| max {scale:.2f})", err,
          POINTCONV_REL_TOL[label] * scale, failures)
    with torch.inference_mode():
        ms = cuda_ms(lambda: kernel(*args, r, k_cap, w2f))
        plain_ms = cuda_ms(lambda: plain(*args, r, k_cap), reps=3, warmup=1)
    # The second layer on the selected rows (compute dtype), building each
    # row (subtract, BN, ReLU: 4 f32 operations a channel) and its epilogue
    # (bias, BN, ReLU, max: 5 a column); bytes: a, pos, c, cent, W2, the
    # five f32 vectors and out.
    es = a.element_size()
    rate = PEAK_BF16 if label == "bf16" else PEAK_F32
    nbytes = (es * (B * N * C1 + B * S * C1 + C1 * C2 + B * S * C2)
              + 4 * (3 * B * N + 3 * B * S + 2 * C1 + 3 * C2))
    bnd, by = bound_ms([(2.0 * rows * C1 * C2, rate),
                        (rows * (4.0 * C1 + 5.0 * C2), PEAK_F32)], nbytes)
    log(f"  pointconv {label} {where}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bnd:.4f} ms ({rows:.0f} neighbour rows, "
        f"{rows / (B * S):.1f} per centroid)")
    return {"level": where, "B": B, "N": N, "S": S, "C1": C1, "C2": C2,
            "rows": rows, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": by, "max_abs_err": err, "out": (got, cent)}


def db_subset_checks(pipe_bf16, pipe_f32, bt, dbx, failures):
    """The fixture's 64 cells encoded on JAX's draws against JAX's CPU
    outputs: f32 max abs error, bf16 cosine of every row."""
    from text2pos_torch.evaluation.pipeline import (encode_coarse_cells,
                                                    fine_cell_points)

    dev = pipe_bf16.device
    n = dbx["fine_u"].shape[0]
    idx = torch.arange(n, device=dev)
    xyz, rgb, centers, colors = subset_points(bt, dbx, dev)
    u = torch.as_tensor(dbx["coarse_u"], device=dev)
    for label, pipe in (("f32", pipe_f32), ("bf16", pipe_bf16)):
        with torch.inference_mode():
            got = {"fine_bank_enc": pipe.fine.encode_cell_objects(
                       xyz, rgb, centers, colors),
                   "fine_bank_centers": centers[..., 0:2],
                   "cell_enc": encode_coarse_cells(pipe.coarse, bt, idx,
                                                   u=u)}
        for name, g in got.items():
            want = torch.as_tensor(dbx[f"{label}_{name}"], device=dev)
            g = g.float()
            if not bool(torch.isfinite(g).all()) or g.shape != want.shape:
                failures.append(f"db subset {label} {name}: malformed")
                continue
            if label == "f32" or name == "fine_bank_centers":
                check(f"db subset {label} {name} {tuple(g.shape)} vs JAX",
                      max_err(g, want), DB_F32_TOL, failures)
                continue
            cos = torch.nn.functional.cosine_similarity(g, want, dim=-1)
            worst = float(cos.min())
            ok = worst >= DB_BF16_MIN_COS
            log(f"  db subset bf16 {name} {tuple(g.shape)} vs JAX: row "
                f"cosine min {worst:.6f} median {float(cos.median()):.6f} "
                f"(gate {DB_BF16_MIN_COS}) {'ok' if ok else 'FAIL'}; max "
                f"abs err {max_err(g, want):.3e}")
            if not ok:
                failures.append(f"db subset bf16 {name}: row cosine {worst}")


def encode_split(pipe, bt, seed: int):
    """Synchronized wall time of the coarse and the fine encode of every
    cell, apart (the loops ``encode_database`` runs)."""
    from text2pos_torch.evaluation.pipeline import (encode_all_coarse,
                                                    encode_all_fine)

    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    out = {}
    with torch.inference_mode():
        for label, fn in (
                ("coarse", lambda: encode_all_coarse(pipe.coarse, bt, gen)),
                ("fine", lambda: encode_all_fine(pipe.fine, bt,
                                                 pipe.cfg.pad_size, gen))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[label] = time.perf_counter() - t0
    return out


def profile_ranges(fn, prefix: str):
    """Run ``fn()`` under torch.profiler; returns (wall ms, {range: [host
    ms, launches, device ms]}, {kernel: [device ms, launches]}) for the
    profiler ranges named ``prefix``*, "other" holding kernels launched
    outside them, or None when the profiler recorded no device time. The
    profiler puts each range on the device's timeline too; a kernel belongs
    to the range whose device span holds its start."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            acc_events=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    spans, kernels = [], []
    stages = collections.defaultdict(lambda: [0.0, 0, 0.0])
    for e in prof.events():
        on_device = "CUDA" in str(getattr(e, "device_type", ""))
        if e.name.startswith(prefix):
            if on_device:
                spans.append((e.time_range.start, e.time_range.end, e.name))
            else:
                stages[e.name][0] += e.cpu_time_total / 1e3
        elif on_device:
            kernels.append(e)
    if not kernels:
        return None
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for k in kernels:
        t = k.time_range.elapsed_us() / 1e3
        stage = next((n for a, b, n in spans if a <= k.time_range.start < b),
                     "other")
        stages[stage][1] += 1
        stages[stage][2] += t
        by_name[k.name][0] += t
        by_name[k.name][1] += 1
    return wall, dict(stages), dict(by_name)


def log_ranges(what: str, prof) -> None:
    if prof is None:
        log(f"  {what}: the profiler recorded no device time (not "
            "measured)")
        return
    wall, stages, by_name = prof
    busy = sum(v[2] for v in stages.values())
    log(f"  {what} (torch.profiler): wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f}%), "
        f"{sum(v[1] for v in stages.values())} launches of {len(by_name)} "
        "kernels")
    for stage in sorted(stages):
        host, n, dev = stages[stage]
        log(f"    stage {stage}: host {host:.3f} ms, {n} launches, "
            f"{dev:.3f} ms on the device ({100 * dev / max(busy, 1e-9):.1f}%"
            " of the device time)")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :8]:
        log(f"    {t:9.3f} ms  {n:5d}x  {name[:90]}")


def profile_db(pipe, bt) -> None:
    """Where one step's coarse and fine encode spends its time: per
    PointNet++ stage (the ``pointnet.*`` profiler ranges; "other" is the
    rest: resampling, the object encoder's MLPs, EdgeConv), the host's time
    in the ranges and the device time of the kernels launched inside them;
    the top kernels; the device's busy share of the wall time."""
    from text2pos_torch.evaluation.pipeline import (DB_CHUNK,
                                                    encode_coarse_cells,
                                                    encode_fine_cells)

    chunk = min(DB_CHUNK, bt["mask"].shape[0])
    idx = torch.arange(chunk, device=pipe.device)
    gen = torch.Generator(device=pipe.device).manual_seed(2)

    def step():
        encode_coarse_cells(pipe.coarse, bt, idx, gen)
        encode_fine_cells(pipe.fine, bt, idx, pipe.cfg.pad_size, gen)

    log_ranges(f"db profile, coarse + fine encode of {chunk} cells",
               profile_ranges(step, "pointnet."))


def timed_encode(pipe, bank, seed):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db = pipe.encode_database(bank, seed=seed)
    torch.cuda.synchronize()
    return db, time.perf_counter() - t0


def db_encode_and_serve(pipe_bf16, bank, bt, fx, cache_top_idx, failures):
    """Phase 5's main path: every cell encoded in bf16, then the bench
    queries served from that database. Returns the kernel launches of the
    first encode and its cell encodings."""
    from text2pos_torch.evaluation.metrics import served_accuracies
    from text2pos_torch.ops import _build

    C = bank.num_cells
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    (cell_enc, fb_enc, fb_ctr), wall = timed_encode(pipe_bf16, bank, 0)
    launches = dict(_build.LAUNCHES)
    log(f"  encode_database bf16: {C} cells (coarse + fine) in {wall:.3f} s "
        f"= {C / wall:.1f} cells/s; kernel launches {launches}")
    for name in ("fps", "pointconv"):
        if launches.get(name, 0) < 1:
            failures.append(f"kernel {name} was not launched by the DB "
                            "encode")
    # One FPS launch a PointNet++ forward, whose three levels each launch
    # the PointConv kernel.
    if 3 * launches.get("fps", 0) != launches.get("pointconv", 0):
        failures.append(f"the DB encode made {launches.get('fps', 0)} FPS "
                        f"launches for {launches.get('pointconv', 0)} "
                        "PointConv launches, not one a forward")
    # Two more calls with other draws: the spread of the wall time, and a
    # second database for the resampling noise below.
    walls = [wall]
    other = None
    for seed in (1, 2):
        db, w = timed_encode(pipe_bf16, bank, seed)
        walls.append(w)
        other = other or db
    log("  encode_database bf16, three calls (seeds 0, 1, 2): "
        + ", ".join(f"{w:.3f} s" for w in walls))
    for seed in (3, 4):
        split = encode_split(pipe_bf16, bt, seed)
        log(f"  apart (seed {seed}): coarse {split['coarse']:.3f} s = "
            f"{C / split['coarse']:.1f} cells/s; fine {split['fine']:.3f} s "
            f"= {C / split['fine']:.1f} cells/s")
    profile_db(pipe_bf16, bt)

    finite = all(bool(torch.isfinite(t).all())
                 for t in (cell_enc, fb_enc, fb_ctr))
    if not finite or cell_enc.shape != pipe_bf16.cell_enc.shape or \
            fb_enc.shape != pipe_bf16.fine_bank_enc.shape:
        failures.append("encode_database: malformed output")
        return launches, cell_enc

    def cosines(label, ref):
        cos = {n: torch.nn.functional.cosine_similarity(a, b, dim=-1)
               for n, a, b in (("cell_enc", cell_enc, ref[0]),
                               ("fine_bank_enc", fb_enc, ref[1]))}
        log(f"  rebuilt (seed 0) vs {label}: row cosine "
            + ", ".join(f"{n} median {float(c.median()):.5f} min "
                        f"{float(c.min()):.5f} 1st percentile "
                        f"{float(c.flatten().quantile(0.01)):.5f}"
                        for n, c in cos.items())
            + f"; fine_bank_centers max abs diff {max_err(fb_ctr, ref[2]):.3g}")

    cosines("the committed DB cache (JAX's draws)",
            (pipe_bf16.cell_enc, pipe_bf16.fine_bank_enc,
             pipe_bf16.fine_bank_centers))
    cosines("the port's seed-1 database", other)
    ti, po, sec = serve_all(pipe_bf16.with_database(cell_enc, fb_enc, fb_ctr),
                            fx, TOP_K, reps=3)
    ti1, _, _ = serve_all(pipe_bf16.with_database(*other), fx, TOP_K)
    accs = served_accuracies(fx, ti, po, (1, 5, TOP_K))
    jax_t10 = float(fx["jax_top10_at_15m"])
    log(f"  serve bf16 from the rebuilt database: {len(ti)} queries in "
        f"{sec * 1e3:.2f} ms; top-10@15m {accs[TOP_K][15]:.4f} (JAX "
        f"{jax_t10:.4f}, gate +-{DB_ACC_SLACK}), top-1@15m "
        f"{accs[1][15]:.4f}; top_idx identical to the cache-served run "
        f"{float((ti == cache_top_idx).mean()):.4f}, to the run served "
        f"from the seed-1 database {float((ti == ti1).mean()):.4f}")
    if not np.isfinite(po).all():
        failures.append("serve from the rebuilt database: non-finite")
    if abs(accs[TOP_K][15] - jax_t10) > DB_ACC_SLACK:
        failures.append(f"serve from the rebuilt database: top-10@15m "
                        f"{accs[TOP_K][15]} vs JAX {jax_t10}")
    return launches, cell_enc


def near_tie_flips(z: torch.Tensor, threshold: float,
                   tol: float = SWAP_REL_TOL):
    """Each match-extraction decision of one pair whose relative margin is
    below SWAP_REL_TOL, taken the other way: yields (what, margin, z') with
    z' the log transport z [M+1, N+1] (f32) moved by that margin at one
    entry and at its copies in bit-identical rows and columns (duplicate
    hints give equal columns, here as in JAX). The decisions are each
    row's and each column's largest transport against its second largest
    (the mutual max: raise the second just above the first, or lower the
    first just below the second) and each row's largest against the
    threshold (moved just across it). ``tol`` replaces SWAP_REL_TOL."""
    p = z[:-1, :-1].exp()
    M, N = p.shape
    up, down = torch.tensor(math.inf), torch.tensor(-math.inf)

    def moved(at, value):
        rows = [k for k in range(M) if torch.equal(z[k], z[at[0]])]
        cols = [k for k in range(N) if torch.equal(z[:, k], z[:, at[1]])]
        zz = z.clone()
        for i in rows:
            zz[i, cols] = value
        return zz

    pairs = [(f"row {i}", (i, int(j[0])), (i, int(j[1])))
             for i, j in enumerate(p.topk(2, dim=1).indices)]
    pairs += [(f"column {j}", (int(i[0]), j), (int(i[1]), j))
              for j, i in enumerate(p.topk(2, dim=0).indices.T)]
    for what, hi, lo in pairs:
        margin = float((p[hi] - p[lo]) / p[hi])
        if margin < tol:
            for at, to, way in ((lo, hi, up), (hi, lo, down)):
                yield (f"{what}'s {hi} against {lo}", margin,
                       moved(at, torch.nextafter(z[to], way)))
    for i, j in enumerate(p.argmax(1).tolist()):
        margin = abs(float(p[i, j]) - threshold) / threshold
        if margin < tol:
            v, above = z[i, j], bool(p[i, j] > threshold)
            while bool(v.exp() > threshold) == above:
                v = torch.nextafter(v, down if above else up)
            yield (f"row {i}'s match against the threshold", margin,
                   moved((i, j), v))


def candidate_score(pipe, z, offsets, ctr, sim, lam, gam) -> float:
    """``conf + λ·sim − γ·spread`` of one candidate from its log transport
    z [M+1, N+1], hint offsets [H, 2] and object centers [pad, 2], by
    ``serve_batch``'s arithmetic."""
    from text2pos_torch.evaluation.pipeline import (_match_confidence_scores,
                                                    _match_vote_spread)
    from text2pos_torch.ops.sinkhorn import extract_matches

    out = extract_matches(z[None], pipe.fine.superglue.match_threshold)
    conf = _match_confidence_scores(out["matches0"][None],
                                    out["matching_scores0"][None])
    spread = _match_vote_spread(out["matches1"][None], offsets[None, None],
                                ctr[None, None])
    return float(conf.float() + lam * sim - gam * spread.float())


def stage_candidates(pipe, fx, r: int, kept=None, cheap=None):
    """The port's data of query r's candidates in one stage, as
    ``serve_batch`` computes them (each pair's kernels do not depend on its
    batch): over the coarse top-rerank_k, or over ``kept`` [K'] cells; with
    ``cheap`` = (q, scale, layers, iters) the cascade's cheap pass on the
    int8 bank. Returns a dict of cells, re-rank scores (numpy), and sims,
    log transports Z, hint offsets and object centers, one row a cell."""
    from text2pos_torch.ops.retrieval import topk_retrieval

    rk, lam, gam = fx["rerank"]
    dev = pipe.device
    q = [torch.as_tensor(fx[k][r:r + 1], device=dev)
         for k in ("tokens", "lengths", "hint_tokens", "hint_lengths")]
    with torch.inference_mode():
        sims, cells = topk_retrieval(pipe.coarse.encode_text(q[0], q[1]),
                                     pipe.cell_enc, int(rk))
        if kept is not None:
            pos = {int(c): i for i, c in enumerate(cells[0])}
            sel = torch.as_tensor([pos[int(c)] for c in kept], device=dev)
            cells, sims = cells[:, sel], sims[:, sel]
        hint_enc = pipe.fine.encode_hints(q[2], q[3])
        layers = iters = None
        if cheap is not None:
            qb, qs, layers, iters = cheap
            dt = pipe.fine.superglue.dtype or torch.float32
            obj = (pipe._gather(cells, qb).to(dt)
                   * pipe._gather(cells, qs).to(dt))
        else:
            obj = pipe._gather(cells, pipe.fine_bank_enc)
        ctr = pipe._gather(cells, pipe.fine_bank_centers)
        *_, conf, spread = pipe._match_from_enc(obj, ctr, hint_enc, layers,
                                                iters)
        out = pipe.fine.match_encoded(obj[0], hint_enc.expand(
            obj.shape[1], -1, -1), layers, iters)
        score = conf.float() + float(lam) * sims.float() \
            - float(gam) * spread.float()
    return {"cells": cells[0].cpu().numpy(), "scores": score[0].cpu().numpy(),
            "sims": sims[0].float().cpu(), "Z": out["log_P"].float().cpu(),
            "offsets": out["offsets"].float().cpu(),
            "ctr": ctr[0].float().cpu()}


def explain_stage(pipe, fx, got_row, want_row, st, jcands, jscores,
                  excused=frozenset(), tol: float = SWAP_REL_TOL):
    """Whether the port's ranking ``got_row`` of one stage differs from
    JAX's ``want_row`` only by near-ties; returns (ok, notes). ``st`` is
    the port's stage (``stage_candidates``), ``jcands``/``jscores`` JAX's
    candidates and re-rank scores of it. Every candidate at a differing
    position must have the port's score within SWAP_REL_TOL of JAX's, or a
    match-extraction decision within SWAP_REL_TOL (``near_tie_flips``)
    that, taken the other way, gives JAX's score within SWAP_REL_TOL: the
    witness is JAX's stored score, not the port's transport. With those
    witnessed scores in place of the port's, the stable re-rank of the
    port's candidates must give JAX's ranking, but at positions where
    JAX's own scores of the two candidates differ by less than SWAP_REL_TOL.
    Cells in ``excused`` (dropped at an earlier, explained stage) are
    skipped. ``tol`` replaces SWAP_REL_TOL throughout."""
    _, lam, gam = (float(v) for v in fx["rerank"])
    jscore = {int(c): float(s) for c, s in zip(jcands, jscores)}
    pos = {int(c): i for i, c in enumerate(st["cells"])}
    score = [float(s) for s in st["scores"]]
    ok, notes = True, []

    def near(x, y):
        return abs(x - y) <= tol * max(abs(y), 1e-30)

    def ranking(s):
        order = sorted(range(len(s)), key=lambda i: -s[i])      # stable
        return [int(st["cells"][i]) for i in order[:len(want_row)]]

    if ranking(score) != [int(c) for c in got_row]:
        return False, ["the port's scores of the stage recomputed here do "
                       "not give the served ranking"]
    moved = sorted({int(c) for g, w in zip(got_row, want_row) if g != w
                    for c in (g, w)} - set(excused))
    for c in moved:
        if c not in pos or c not in jscore:
            ok = False
            notes.append(f"candidate {c} is not among both sides' candidates")
            continue
        i = pos[c]
        args = (st["offsets"][i], st["ctr"][i], float(st["sims"][i]), lam,
                gam)
        mine, theirs = score[i], jscore[c]
        if not near(candidate_score(pipe, st["Z"][i], *args), mine):
            ok = False
            notes.append(f"candidate {c}: its score recomputed from its "
                         f"transport differs from the served {mine:.6f}")
            continue
        if near(mine, theirs):
            continue
        for what, margin, z in near_tie_flips(st["Z"][i],
                                              pipe.fine.superglue
                                              .match_threshold, tol):
            flipped = candidate_score(pipe, z, *args)
            if near(flipped, theirs):
                score[i] = flipped
                notes.append(f"candidate {c}'s score {mine:.6f} here, "
                             f"{theirs:.6f} in JAX; {what} (margin "
                             f"{margin:.3e}) taken the other way gives "
                             f"{flipped:.6f}")
                break
        else:
            ok = False
            notes.append(f"candidate {c}'s score {mine:.6f} here, "
                         f"{theirs:.6f} in JAX, and no match-extraction "
                         f"decision within {tol:g} explains it")
    for a, b in zip(ranking(score), want_row):
        b = int(b)
        if a == b or a in excused or b in excused:
            continue
        gap = (abs(jscore[a] - jscore[b]) / max(abs(jscore[a]),
                                                abs(jscore[b]), 1e-30)
               if a in jscore and b in jscore else math.inf)
        notes.append(f"{a} before {b}: JAX's scores of the two differ by "
                     f"{gap:.3e} relative")
        ok = ok and gap < tol
    return ok, notes


def explain_swaps(pipe, fx, got, stage: str, cheap=None):
    """Rows where the served ``got`` [Q, K] differs from JAX's f32
    ``top_idx`` of ``stage`` ("rerank" or "cascade"), each with (row, ok,
    notes) from ``explain_stage``. In the cascade, a cheap pass that kept
    other cells than JAX's is explained first (its 24 survivors against
    JAX's, on the cheap scores), then the full pass on the port's
    survivors, where cells that JAX dropped are excused."""
    want = fx[f"jax_{stage}_top_idx"]
    out = []
    for r in np.flatnonzero((got != want).any(1)):
        r = int(r)
        jc = fx["jax_rerank_cands"][r]
        if stage == "rerank":
            ok, notes = explain_stage(pipe, fx, got[r], want[r],
                                      stage_candidates(pipe, fx, r), jc,
                                      fx["jax_rerank_scores"][r])
            out.append((r, ok, notes))
            continue
        jkept = [int(c) for c in fx["jax_cascade_kept"][r]]
        st = stage_candidates(pipe, fx, r, cheap=cheap)
        order = np.argsort(-st["scores"], kind="stable")[:len(jkept)]
        kept = [int(c) for c in st["cells"][order]]
        ok, notes, excused = True, [], frozenset()
        if set(kept) != set(jkept):
            ok, notes = explain_stage(pipe, fx, kept, jkept, st, jc,
                                      fx["jax_cascade_cheap_scores"][r])
            notes = [f"cheap pass: {n}" for n in notes]
            excused = frozenset(kept) ^ frozenset(jkept)
        ok2, notes2 = explain_stage(
            pipe, fx, got[r], want[r], stage_candidates(pipe, fx, r, kept),
            jkept, fx["jax_cascade_scores"][r], excused)
        out.append((r, ok and ok2, notes + [f"full pass: {n}"
                                            for n in notes2]))
    return out


def report_swaps(label: str, swaps, n: int, failures: list,
                 against: str = "JAX's") -> None:
    """Logs each differing row and why it is a near-tie; fails on a row
    that is not one. ``against`` names the reference ("JAX" in the notes
    of ``explain_stage``)."""
    log(f"  {label}: top_idx identical to {against} on {n - len(swaps)} of "
        f"{n} queries; {len(swaps)} differ")
    for r, ok, notes in swaps:
        log(f"    query {r}: {'; '.join(notes)}: "
            f"{'near-ties' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{label}: query {r} differs from {against} "
                            f"without a near-tie ({notes})")


# Phase 4 reads the share of served in-cell positions within this of JAX's
# (a cell's side is 1).
POS_CLOSE = 1e-2


def classify_positions(pipe, fx, ti, po):
    """Each served in-cell position of the headline (``ti``, ``po`` from
    ``serve_all``) farther than POS_CLOSE from JAX's ``jax_pos_offsets``,
    classified: "another cell" where the served candidate is not JAX's;
    "near-tie" where a match-extraction decision of the pair within
    SWAP_REL_TOL (``near_tie_flips``), taken the other way, puts the
    position within POS_CLOSE of JAX's (the witness is JAX's stored
    position); else "unexplained". The pairs are recomputed in one batch
    as ``serve_batch`` computes them. Returns {class: [(query, candidate,
    error, note)]} and the largest difference of a recomputed position,
    rounded to float16 as ``serve_batch`` returns positions, from the
    served one, in float16 steps of the served value."""
    from text2pos_torch.models.matcher import get_pos_in_cell
    from text2pos_torch.ops.retrieval import topk_retrieval
    from text2pos_torch.ops.sinkhorn import extract_matches

    want = fx["jax_pos_offsets"].astype(np.float32)
    err = np.abs(po - want).max(-1)
    out = {"another cell": [], "near-tie": [], "unexplained": []}
    flagged = [(int(r), int(k)) for r, k in np.argwhere(err > POS_CLOSE)]
    if not flagged:
        return out, 0.0
    dev, K = pipe.device, ti.shape[1]
    q = [torch.as_tensor(fx[k], device=dev)
         for k in ("tokens", "lengths", "hint_tokens", "hint_lengths")]
    with torch.inference_mode():
        cells = topk_retrieval(pipe.coarse.encode_text(q[0], q[1]),
                               pipe.cell_enc, K)[1]
        obj = pipe._gather(cells, pipe.fine_bank_enc)
        ctr = pipe._gather(cells, pipe.fine_bank_centers)
        m = pipe.fine.match_encoded(obj.flatten(0, 1), pipe.fine.encode_hints(
            q[2], q[3]).repeat_interleave(K, dim=0))
    thr = pipe.fine.superglue.match_threshold
    replay = 0.0
    for r, k in flagged:
        if ti[r, k] != fx["jax_top_idx"][r, k]:
            out["another cell"].append((r, k, float(err[r, k]),
                                        f"cell {ti[r, k]} for "
                                        f"{fx['jax_top_idx'][r, k]}"))
            continue
        i = r * K + k
        z = m["log_P"][i].float().cpu()
        off, c = m["offsets"][i].float().cpu(), ctr[r, k].float().cpu()

        def position(zz):
            m0 = extract_matches(zz[None], thr)["matches0"]
            return get_pos_in_cell(c[None], m0, off[None])[0].numpy()

        served = po[r, k].astype(np.float16)
        replay = max(replay, float((np.abs(position(z).astype(np.float16)
                                           - served)
                                    / np.spacing(np.abs(served))).max()))
        best = (math.inf, "no match-extraction decision within "
                f"{SWAP_REL_TOL:g}")
        for what, margin, zz in near_tie_flips(z, thr):
            e = float(np.abs(position(zz) - want[r, k]).max())
            if e < best[0]:
                best = (e, f"{what} (margin {margin:.3e}) taken the other "
                           f"way: {e:.3e} from JAX's")
        kind = "near-tie" if best[0] <= POS_CLOSE else "unexplained"
        out[kind].append((r, k, float(err[r, k]), best[1]))
    return out, replay


def f32_rerank_check(pipe_f32, fx, failures):
    """One f32 rerank@128 batch of the 2048 queries against JAX's f32
    ``top_idx``: identical, or each differing row explained by near-ties
    (``explain_stage``)."""
    rk, lam, gam = fx["rerank"]
    ti, _, sec = serve_all(pipe_f32, fx, TOP_K, int(rk), float(lam),
                           float(gam))
    log(f"  serve f32 rerank@{int(rk)}: {len(ti)} queries in "
        f"{sec * 1e3:.1f} ms")
    report_swaps(f"f32 rerank@{int(rk)}",
                 explain_swaps(pipe_f32, fx, ti, "rerank"), len(ti),
                 failures)


def cascade_kernel_checks(pipe, fx, casc, cheap, failures):
    """The cascade's kernels against their plain versions on the inputs of
    its batch of all 2048 queries: the cheap pass's GNN at its depth and at
    0 blocks and its Sinkhorn at the cheap iterations on the int8 bank's
    262,144 pairs, the full pass's GNN (12 blocks) and Sinkhorn (50
    iterations) on its 49,152 survivors (the plain GNN in slices of
    CHUNK_PAIRS pairs to bound its memory; the kernel on all at once). Also
    the cheap pass's kernel times and bounds at that width, and the device
    time of its descriptors' gather, int8 dequantization and f32 widening
    before the GNN kernel."""
    from text2pos_torch.evaluation.pipeline import _take
    from text2pos_torch.ops.retrieval import topk_retrieval
    from text2pos_torch.ops.sinkhorn import (_lot_kernel,
                                             log_optimal_transport_plain)
    from text2pos_torch.ops.superglue_gnn import (_gnn_kernel,
                                                  gnn_scores_plain)

    rk, lam, gam, m, L, S = casc
    sg = pipe.fine.superglue
    dt = sg.dtype or torch.float32
    label = "bf16" if dt == torch.bfloat16 else "f32"
    qb, qs = cheap
    dev = pipe.device
    with torch.inference_mode():
        tokens, lengths = (torch.as_tensor(fx[k], device=dev)
                           for k in ("tokens", "lengths"))
        sims, wide = topk_retrieval(pipe.coarse.encode_text(tokens, lengths),
                                    pipe.cell_enc, rk)
        hint_enc = pipe.fine.encode_hints(
            torch.as_tensor(fx["hint_tokens"], device=dev),
            torch.as_tensor(fx["hint_lengths"], device=dev))
        keep = pipe._cheap_keep(wide, sims, hint_enc, m, L, S, False, qb, qs,
                                lam, gam)
        kept = _take(wide, keep).reshape(-1)
        flat = wide.reshape(-1)

        def dequant():
            return (qb[flat].to(dt) * qs[flat].to(dt)).float().contiguous()

        d0 = dequant()
        d1 = hint_enc.repeat_interleave(rk, dim=0).contiguous()
        f0 = pipe.fine_bank_enc[kept].contiguous()
        f1 = hint_enc.repeat_interleave(m, dim=0).contiguous()
    alpha = sg.bin_score.detach()
    out = {}
    for where, x0, x1, layers, iters in (
            ("cheap pass", d0, d1, L, S), ("cheap pass", d0, d1, 0, None),
            ("full pass", f0, f1, sg.num_layers, sg.sinkhorn_iterations)):
        packed = sg.packed_kernel_params(layers)
        N = x0.shape[0]
        with torch.inference_mode():
            got = _gnn_kernel(x0, x1, packed)
            err = scale = 0.0
            for s in range(0, N, CHUNK_PAIRS):
                want = gnn_scores_plain(x0[s:s + CHUNK_PAIRS],
                                        x1[s:s + CHUNK_PAIRS], packed)
                err = max(err, max_err(got[s:s + CHUNK_PAIRS], want))
                scale = max(scale, float(want.abs().max()))
                del want
            torch.cuda.synchronize()
        check(f"superglue_gnn {label} {where} blocks={2 * layers} N={N} "
              f"(|scores| max {scale:.2f})", err,
              GNN_REL_TOL[label] * scale, failures)
        if iters is None:
            continue
        with torch.inference_mode():
            err = max_err(_lot_kernel(got, alpha, iters),
                          log_optimal_transport_plain(got, alpha, iters))
            torch.cuda.synchronize()
        check(f"sinkhorn {where} B={N} iters={iters}", err, TOL["sinkhorn"],
              failures)
    packed = sg.packed_kernel_params(L)
    with torch.inference_mode():
        out["dequant_ms"] = cuda_ms(dequant, reps=5)
        out["gnn_ms"] = cuda_ms(lambda: _gnn_kernel(d0, d1, packed), reps=5)
        scores = _gnn_kernel(d0, d1, packed)
        out["sinkhorn_ms"] = cuda_ms(lambda: _lot_kernel(scores, alpha, S),
                                     reps=5)
    N = d0.shape[0]
    out["gnn_bound_ms"] = gnn_bound(d0, d1, packed, label)[0]
    out["sinkhorn_bound_ms"] = sinkhorn_bound(N, scores.shape[1] + 1,
                                              scores.shape[2] + 1, S)[0]
    log(f"  cheap pass {label} at full width, N={N} pairs: descriptors' "
        f"gather, dequantization and f32 widening {out['dequant_ms']:.3f} ms, "
        f"GNN kernel ({2 * L} blocks) {out['gnn_ms']:.3f} ms (bound "
        f"{out['gnn_bound_ms']:.4f} ms), Sinkhorn kernel ({S} iterations) "
        f"{out['sinkhorn_ms']:.3f} ms (bound "
        f"{out['sinkhorn_bound_ms']:.4f} ms)")
    return out


def cascade_checks(pipe_bf16, pipe_f32, fx, failures):
    """The cascade 128 → 24 (one block pair, 6 Sinkhorn iterations, int8
    bank, λ=4, γ=6) on the 2048 queries in bf16 and f32: q/s (median of 3),
    accuracies, top_idx against JAX's f32 cascade; the kernel launches of
    one bf16 batch; its profile; a soft cheap pass and a 0-block one."""
    from text2pos_torch.evaluation.metrics import served_accuracies
    from text2pos_torch.evaluation.pipeline import quantize_fine_bank
    from text2pos_torch.ops import _build

    rk, m, L, S, lam, gam = fx["cascade"]
    casc = (int(rk), float(lam), float(gam), int(m), int(L), int(S))
    jax_t10 = float(fx["jax_cascade_top10_at_15m"])
    res = {"launches": {}}
    cheap = {}
    for label, pipe in (("bf16", pipe_bf16), ("f32", pipe_f32)):
        cheap[label] = quantize_fine_bank(pipe.fine_bank_enc)
        kw = dict(cheap_bank=cheap[label][0], cheap_scale=cheap[label][1])
        serve_all(pipe, fx, TOP_K, *casc, **kw)               # warm-up
        if label == "bf16":
            _build.LAUNCHES.clear()
            serve_all(pipe, fx, TOP_K, *casc, **kw)     # the cascade path
            res["launches"] = dict(_build.LAUNCHES)
            log(f"  kernel launches in one cascade batch: "
                f"{res['launches']}")
            for name in ("superglue_gnn", "sinkhorn", "lstm"):
                if res["launches"].get(name, 0) != 2:
                    failures.append(f"cascade: {name} launched "
                                    f"{res['launches'].get(name, 0)} times "
                                    "in a batch, not 2")
            log_ranges("profile of one bf16 cascade batch", profile_ranges(
                lambda: serve_all(pipe, fx, TOP_K, *casc, **kw), "serve."))
        ti, po, sec = serve_all(pipe, fx, TOP_K, *casc, reps=3, **kw)
        accs = served_accuracies(fx, ti, po, (1, 5, TOP_K))
        same = float((ti == fx["jax_cascade_top_idx"]).mean())
        Q = len(ti)
        log(f"  serve {label} cascade@{casc[0]}->m{casc[3]} "
            f"(L{casc[4]}:S{casc[5]}, int8 bank, lambda={lam:g}, "
            f"gamma={gam:g}): {Q} queries in {sec * 1e3:.2f} ms = "
            f"{Q / sec:.1f} q/s; top-10@15m {accs[TOP_K][15]:.4f} (JAX f32 "
            f"{jax_t10:.4f}), top-1@15m {accs[1][15]:.4f} (JAX f32 "
            f"{float(fx['jax_cascade_top1_at_15m']):.4f}); identical top_idx "
            f"{same:.4f}")
        res[label] = {"ms": sec * 1e3, "qps": Q / sec,
                      "top10_at_15m": accs[TOP_K][15],
                      "top1_at_15m": accs[1][15], "identical": same}
        if not np.isfinite(po).all() or ti.shape != (Q, TOP_K):
            failures.append(f"cascade {label}: malformed output")
        if abs(accs[TOP_K][15] - jax_t10) > ACC_SLACK:
            failures.append(f"cascade {label}: top-10@15m "
                            f"{accs[TOP_K][15]} vs JAX {jax_t10}")
        if label == "f32":
            report_swaps("f32 cascade", explain_swaps(
                pipe, fx, ti, "cascade", (*cheap[label], casc[4], casc[5])),
                Q, failures)
    for label, pipe, variant in (
            ("bf16", pipe_bf16, "soft"), ("bf16", pipe_bf16, "L0"),
            ("f32", pipe_f32, "L0")):
        c = list(casc)
        if variant == "L0":
            c[4] = 0
        _build.LAUNCHES.clear()
        ti, po, sec = serve_all(pipe, fx, TOP_K, *c,
                                prune_soft=variant == "soft",
                                cheap_bank=cheap[label][0],
                                cheap_scale=cheap[label][1])
        n_gnn = _build.LAUNCHES.get("superglue_gnn", 0)
        accs = served_accuracies(fx, ti, po, (1, 5, TOP_K))
        log(f"  serve {label} cascade, {variant} cheap pass "
            f"(L{c[4]}:S{c[5]}, int8 bank): {sec * 1e3:.2f} ms; "
            f"top-10@15m {accs[TOP_K][15]:.4f}, top-1@15m "
            f"{accs[1][15]:.4f}; GNN kernel launches {n_gnn}")
        res[f"{label}_{variant}_top10_at_15m"] = accs[TOP_K][15]
        if not np.isfinite(po).all() or n_gnn != 2:
            failures.append(f"cascade {label} {variant}: malformed output "
                            f"or {n_gnn} GNN launches")
    res["kernels"] = {label: cascade_kernel_checks(
        pipe, fx, casc, cheap[label], failures)
        for label, pipe in (("bf16", pipe_bf16), ("f32", pipe_f32))}
    return res


def stats_vs_cache(got, want, path=()):
    """(leaf path, median, max) of |got − want| / max|want| over every BN
    statistics leaf of the JAX-layout tree ``want``."""
    if isinstance(want, dict):
        for k, v in want.items():
            yield from stats_vs_cache(got[k], v, path + (k,))
        return
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(g - w) / max(np.abs(w).max(), 1e-30)
    yield "/".join(path), float(np.median(d)), float(d.max())


def world_accuracy(fx, out, k: int = TOP_K, thresh: float = 15.0) -> float:
    """Top-k accuracy of a server's world positions: the best of the first
    k within ``thresh`` m of the pose, in the pose's scene."""
    d = np.linalg.norm(out["positions_k"][:, :k, 0:2]
                       - fx["pose_xy"][:, None, :], axis=-1)
    same = fx["cell_scene"][out["top_cells"][:, :k]] == \
        fx["pose_scene"][:, None]
    return float((np.where(same, d, np.inf) <= thresh).any(1).mean())


def calibrate_and_serve(cells, poses, bank, cell_enc, fx, failures):
    """Phase 6. ``calibrated_for_serving`` on the card from the committed
    checkpoints alone and the port's rebuilt map (phase 5's cell
    encodings), on the bench's calibration set: the 2048 queries' hints and
    the model's own top-10 retrievals, 128 cells; its statistics against
    the DB cache's (the port's draws against JAX's: printed only); serving
    from it; then ``LocalizationServer`` end to end and its JSON-lines CLI.
    Returns the kernel launches of the calibration and of the server's
    ``localize`` calls."""
    import contextlib
    import io

    from text2pos_torch import serving
    from text2pos_torch.data.hints import create_hint_description
    from text2pos_torch.evaluation.metrics import served_accuracies
    from text2pos_torch.evaluation.pipeline import (LocalizationPipeline,
                                                    quantize_fine_bank)
    from text2pos_torch.ops import _build
    from text2pos_torch.ops.retrieval import topk_retrieval
    from text2pos_torch.utils.msgpack_io import msgpack_restore

    jax_t10 = float(fx["jax_top10_at_15m"])
    dev = cell_enc.device
    base = LocalizationPipeline.from_checkpoints(
        CKPT_COARSE, CKPT_FINE, None, dtype="bfloat16", device=dev)
    base = base.with_database(cell_enc, None, None)
    with torch.inference_mode():
        enc = base.coarse.encode_text(
            torch.as_tensor(fx["tokens"], device=dev),
            torch.as_tensor(fx["lengths"], device=dev))
        cal_idx = topk_retrieval(enc, cell_enc, TOP_K)[1]
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    cal = base.calibrated_for_serving(bank, fx["hint_tokens"],
                                      fx["hint_lengths"], cal_idx,
                                      max_cells=128)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"calibrate": dict(_build.LAUNCHES)}
    log(f"  calibrated_for_serving bf16 (128 cells, {len(cal_idx)} queries "
        f"x top-{TOP_K}, {bank.num_cells} cells re-encoded): {wall:.3f} s; "
        f"kernel launches {launches['calibrate']}")
    with np.load(DB_CACHE) as z:
        cache = msgpack_restore(z["batch_stats"].tobytes())
    rows = list(stats_vs_cache(cal.batch_stats(), cache))
    log(f"  calibrated statistics vs the DB cache's (JAX's draws and "
        f"calibration), |diff| / max|cache| per leaf, {len(rows)} leaves: "
        f"median of medians {np.median([r[1] for r in rows]):.4f}, largest "
        f"max {max(r[2] for r in rows):.4f}")
    for name, med, mx in rows:
        log(f"    {name}: median {med:.4f} max {mx:.4f}")
    ti, po, sec = serve_all(cal, fx, TOP_K, reps=3)
    accs = served_accuracies(fx, ti, po, (1, 5, TOP_K))
    log(f"  serve bf16 from the port's own calibration: {len(ti)} queries "
        f"in {sec * 1e3:.2f} ms = {len(ti) / sec:.1f} q/s; top-10@15m "
        f"{accs[TOP_K][15]:.4f} (JAX {jax_t10:.4f}, gate +-{DB_ACC_SLACK}),"
        f" top-1@15m {accs[1][15]:.4f}")
    if not np.isfinite(po).all() or \
            abs(accs[TOP_K][15] - jax_t10) > DB_ACC_SLACK:
        failures.append(f"serve from the port's calibration: top-10@15m "
                        f"{accs[TOP_K][15]} vs JAX {jax_t10}")
    rk, m, L, S, lam, gam = fx["cascade"]
    qb, qs = quantize_fine_bank(cal.fine_bank_enc)
    ti, po, sec = serve_all(cal, fx, TOP_K, int(rk), float(lam), float(gam),
                            int(m), int(L), int(S), reps=3, cheap_bank=qb,
                            cheap_scale=qs)
    accs = served_accuracies(fx, ti, po, (1, 5, TOP_K))
    log(f"  serve bf16 cascade from the port's own calibration: "
        f"{sec * 1e3:.2f} ms = {len(ti) / sec:.1f} q/s; top-10@15m "
        f"{accs[TOP_K][15]:.4f} (JAX f32 from the cache "
        f"{float(fx['jax_cascade_top10_at_15m']):.4f}), top-1@15m "
        f"{accs[1][15]:.4f}")

    # LocalizationServer: the map from the Cells, calibrated on the bench
    # queries' hints (the bench's calibration set).
    hints = [create_hint_description(p) for p in poses]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv = serving.LocalizationServer(CKPT_COARSE, CKPT_FINE, cells,
                                     calibration_hints=hints, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batches = [hints[i:i + 256] for i in range(0, len(hints), 256)]
    srv.localize(batches[0])                                  # warm-up
    _build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [srv.localize(b) for b in batches]
    wall = time.perf_counter() - t0
    launches["server"] = dict(_build.LAUNCHES)
    merged = {k: np.concatenate([o[k] for o in outs])
              for k in ("top_cells", "positions_k")}
    acc = world_accuracy(fx, merged)
    log(f"  LocalizationServer: built in {build_s:.2f} s (map bank, cell "
        f"encode, calibration); localize of {len(hints)} queries in "
        f"{len(batches)} batches of 256 in {wall * 1e3:.1f} ms = "
        f"{len(hints) / wall:.1f} q/s (host decode included); top-10@15m "
        f"{acc:.4f} (JAX {jax_t10:.4f}, gate +-{DB_ACC_SLACK}); kernel "
        f"launches {launches['server']}")
    if abs(acc - jax_t10) > DB_ACC_SLACK:
        failures.append(f"LocalizationServer: top-10@15m {acc} vs JAX "
                        f"{jax_t10}")
    streamed = list(srv.localize_stream(batches))
    equal = len(streamed) == len(outs) and all(
        np.array_equal(a[k], b[k]) for a, b in zip(streamed, outs)
        for k in ("top_cells", "positions_k", "confidences"))
    log(f"  localize_stream over the {len(batches)} batches equals "
        f"per-batch localize: {equal} {'ok' if equal else 'FAIL'}")
    if not equal:
        failures.append("localize_stream differs from per-batch localize")

    # The CLI in-process on a small synthetic map, calibrated and not.
    from text2pos_torch.data.synthetic import make_synthetic_dataset

    _, spose = make_synthetic_dataset(seed=3)
    lines = [json.dumps({"hints": create_hint_description(p), "id": i})
             for i, p in enumerate(spose[:10])]
    for extra in ([], ["--no_calibrate"]):
        sys_stdin, out, err = sys.stdin, io.StringIO(), io.StringIO()
        sys.stdin = io.StringIO("\n".join(lines))
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                serving.main(["--path_coarse", CKPT_COARSE, "--path_fine",
                              CKPT_FINE, "--synthetic_seed", "3", "--batch",
                              "4", "--device", str(dev), *extra])
        finally:
            sys.stdin = sys_stdin
        res = [json.loads(x) for x in out.getvalue().splitlines()]
        ok = [r["id"] for r in res] == list(range(len(lines))) and all(
            math.isfinite(v) for r in res for v in r["position"])
        stats = [x for x in err.getvalue().splitlines()
                 if x.startswith("# stats")]
        log(f"  CLI {' '.join(extra) or '(calibrated)'} on the seed-3 "
            f"synthetic map: {len(res)} results for {len(lines)} lines "
            f"{'ok' if ok else 'FAIL'}; {stats[0] if stats else 'no stats'}")
        if not ok:
            failures.append(f"CLI {extra}: bad results")
    return launches


# Phase 7: training. The recipe of the committed checkpoints
# (scripts/train_bench_ckpts.py): coarse batch 64, embed 256, 24 object
# slots, lr 1e-3 decaying by 0.9 an epoch; fine batch 32, embed 128, 6 block
# pairs, 50 Sinkhorn iterations, lr 3e-4 after the warm-up. The fixture's
# steps take half the recipe's batches (32 cells, 16 poses: the size of
# JAX's reference on the CPU); the float64 parity runs at both sizes.
TRAIN_FIXTURE = os.path.join(ROOT, "text2pos_torch", "fixtures",
                             "bench_train_step.npz")
TRAIN_RECIPE = {
    "coarse": dict(batch_size=64, embed_dim=256, learning_rate=1e-3,
                   lr_gamma=0.9, coarse_max_objects=24,
                   pointnet_numpoints=256, pad_size=16, num_mentioned=6),
    "fine": dict(batch_size=32, embed_dim=128, learning_rate=3e-4,
                 num_layers=6, sinkhorn_iters=50, coarse_max_objects=24,
                 pointnet_numpoints=256, pad_size=16, num_mentioned=6)}
STEP_BATCH = {"coarse": 32, "fine": 16}
TRAIN_STEPS = 20
# One f32 step on the card from the checkpoint, held at these limits: the
# loss (relative), every gradient leaf (relative L2 of the full leaf, or of
# its norm where only that is stored; a leaf whose reference norm is under
# 1e-4 of the global norm, a bias before BatchNorm whose exact gradient is
# zero, is held absolutely within 1e-5 of the global norm), and the BN
# running statistics after the step (relative to each leaf's scale). Held
# to the same step in float64 (the plain path with every f32 pin widened,
# ``utils/float64.py``, which the CPU tests tie to JAX's float64 step),
# taken on the f32 step's piecewise choices (``Decisions``): f32 rounding
# moves ReLU inputs and maxima that sit within 1e-6 of a tie to the other
# side, which moves whole rows of gradient (5.2e-3 of a GNN leaf on the
# fine fixture batch). Each choice the float64 step would have made
# otherwise must be such a near-tie: within NEAR_TIE_TOL of its tensor's
# largest magnitude (the encodings entering the GNN are 9e-7 off float64
# in f32). At the fixture's batch (JAX's draws) the coarse step is also
# held to JAX's f32 step, and JAX's f32 step is read against the float64
# step. The coarse recipe batch is not held to float64: its float64 step
# would need more memory than the card has.
PARITY_BATCHES = {"coarse": (32,), "fine": (16, 32)}
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-3
ZERO_GRAD_FRACTION = 1e-4
ZERO_GRAD_TOL = 1e-5
TRAIN_BN_TOL = 1e-5
NEAR_TIE_TOL = 1e-5
# Resume after 10 steps against the straight run: the reloaded state
# (parameters, BN statistics, Adam's moments and count, step) equals the
# straight run's at the save bit for bit, and so does the first resumed
# step's loss (its forward pass has no atomics). The losses of the 10 steps
# agree within RESUME_LOSS_TOL (relative): CUDA's atomics (the gathers'
# backward) make the gradients differ in the last bits, and the coarse
# step's kNN graph and hinges turn that into jumps (readings over four
# runs: coarse 4.9e-6 to 1.2e-3, fine 2.1e-7 to 4.2e-7).
RESUME_LOSS_TOL = {"coarse": 1e-2, "fine": 1e-5}


def train_data():
    """The recipe's training scene (seed 100, tag "7") and the seed-77
    validation scene, by the port's generator; the checkpoints' vocab."""
    from text2pos_torch.data.hints import Vocabulary
    from text2pos_torch.data.synthetic import make_synthetic_dataset
    from text2pos_torch.train.state import load_checkpoint

    train = make_synthetic_dataset(
        seed=100, scene_name="7100", extent=30.0 * 16, cell_size=30.0,
        poses_per_cell=3, objects_per_cell_area=12)
    val = make_synthetic_dataset(
        seed=77, scene_name="7077", extent=30.0 * 16, cell_size=30.0,
        poses_per_cell=1, objects_per_cell_area=12)
    vocab = Vocabulary(load_checkpoint(CKPT_COARSE)["extra"]["known_words"])
    return train, val, vocab


def make_trainer(stage, vocab, **kw):
    from text2pos_torch.config import TrainConfig
    from text2pos_torch.train.coarse import CoarseTrainer
    from text2pos_torch.train.fine import FineTrainer

    ckpt = CKPT_COARSE if stage == "coarse" else CKPT_FINE
    cfg = TrainConfig(**{**TRAIN_RECIPE[stage], "continue_path": ckpt,
                         "device": "cuda", **kw})
    cls = CoarseTrainer if stage == "coarse" else FineTrainer
    return cls(cfg, vocab)


def stage_loader(stage, split, vocab, batch):
    from text2pos_torch.data.loaders import CoarseLoader, FineLoader

    if stage == "coarse":
        return CoarseLoader(*split, vocab, batch, 24, 256, 64,
                            shuffle_hints=True, flip_poses=True, seed=0)
    return FineLoader(*split, vocab, batch, 16, 6, 256, 16, seed=0)


def flat_tree(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flat_tree(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def step_grads(stage, trainer, state, batch, draws):
    """One step's forward and backward: (loss, {leaf: gradient},
    {leaf: BN statistic after the step}), in the JAX layout, numpy."""
    from text2pos_torch.utils.convert_jax import module_to_jax, params_to_jax

    out = trainer.forward_backward(state, batch, draws=draws)
    model = state.model
    grads = dict(flat_tree(params_to_jax(model, {
        n: torch.zeros_like(p) if p.grad is None else p.grad
        for n, p in model.named_parameters()})))
    stats = dict(flat_tree(module_to_jax(model)[1]))
    return float(out if stage == "coarse" else out[0]), grads, stats


def float64_step(stage, vocab, batch, draws, decisions):
    """``step_grads`` in float64 (``utils/float64.py``) on the piecewise
    choices ``decisions`` recorded: the plain path, the LSTM's and the
    Sinkhorn's forward included (their kernels take f32 only; FPS is
    replayed)."""
    import text2pos_torch.ops.lstm as lstm
    import text2pos_torch.ops.sinkhorn as sinkhorn
    from text2pos_torch.utils.float64 import float64_pins

    trainer = make_trainer(stage, vocab)
    state = trainer.init_state(1)
    kernels = lstm._lstm_kernel, sinkhorn._lot_kernel
    lstm._lstm_kernel = lstm.lstm_final_hidden_plain
    sinkhorn._lot_kernel = sinkhorn.log_optimal_transport_plain
    try:
        with float64_pins(), decisions.replay():
            state.model.double()
            return step_grads(stage, trainer, state, batch, draws)
    finally:
        lstm._lstm_kernel, sinkhorn._lot_kernel = kernels


def leaf_errors(got, ref, total):
    """Relative L2 error of each leaf of ``got`` against ``ref`` ({leaf:
    array}; a missing leaf counts as zeros). A leaf whose reference norm
    is under ZERO_GRAD_FRACTION of ``total``, the global gradient norm, is
    measured absolutely, in units of ZERO_GRAD_TOL times ``total``, so that
    each error is held to 1 there. Returns (worst relative error, its leaf,
    worst zero-leaf error, its leaf)."""
    worst, worst_zero = (0.0, ""), (0.0, "")
    for k, r in ref.items():
        r = np.asarray(r, np.float64)
        g = np.asarray(got[k], np.float64) if k in got else np.zeros_like(r)
        n, d = float(np.linalg.norm(r)), float(np.linalg.norm(g - r))
        if n > ZERO_GRAD_FRACTION * total:
            worst = max(worst, (d / n, k))
        else:
            worst_zero = max(worst_zero, (d / (ZERO_GRAD_TOL * total), k))
    return worst + worst_zero


def bn_error(got, ref):
    return max(float(np.abs(np.ravel(got[k]).astype(np.float64)
                            - np.ravel(v)).max()
                     / max(1.0, float(np.abs(v).max())))
               for k, v in ref.items())


def summary(step, full=None):
    """A step's (loss, {leaf: its gradient's norm as a 1-array}, {leaf:
    gradient} for the leaves ``full`` (all by default), {leaf: BN
    statistic}): the form of JAX's step in the fixture."""
    loss, grads, stats = step
    norms = {k: np.array([np.linalg.norm(np.asarray(v, np.float64))])
             for k, v in grads.items()}
    return loss, norms, {k: grads[k] for k in (full or grads)}, stats


def fixture_step(stage, tx):
    """JAX's f32 step from the fixture, as ``summary`` gives it: every
    leaf's norm, a few leaves whole."""
    norms = {k: np.array([v]) for k, v in
             zip(tx[f"{stage}_leaf_names"], tx[f"{stage}_leaf_norms"])}
    full = {k[len(stage) + 6:]: v for k, v in tx.items()
            if k.startswith(f"{stage}_grad/")}
    sizes = tx[f"{stage}_stat_sizes"]
    stats = dict(zip(tx[f"{stage}_stat_names"], np.split(
        tx[f"{stage}_stats"], np.cumsum(sizes)[:-1])))
    return float(tx[f"{stage}_loss"]), norms, full, stats


def compare_steps(got, ref):
    """Two ``summary``s, ``got`` against ``ref``: {loss (relative), worst
    leaf (relative, over the norms and the full leaves), its name, worst
    zero leaf (in ZERO_GRAD_TOL of the global norm), its name, BN}."""
    total = math.sqrt(sum(float(v[0]) ** 2 for v in ref[1].values()))
    a = leaf_errors(got[1], ref[1], total)
    b = leaf_errors(got[2], ref[2], total)
    worst, leaf = max(a[:2], b[:2])
    zero, zleaf = max(a[2:], b[2:])
    return {"loss": abs(got[0] - ref[0]) / abs(ref[0]), "leaf": worst,
            "leaf_name": leaf, "zero": zero, "zero_name": zleaf,
            "bn": bn_error(got[3], ref[3])}


def describe(c):
    return (f"loss rel {c['loss']:.2e}, worst gradient leaf {c['leaf']:.2e} "
            f"({c['leaf_name']}), zero-gradient leaves "
            f"{c['zero'] * ZERO_GRAD_TOL:.2e} of the global norm "
            f"({c['zero_name'] or 'none'}), BN statistics {c['bn']:.2e}")


def gate_step(stage, label, c, failures):
    ok = (c["loss"] <= TRAIN_LOSS_TOL and c["leaf"] <= TRAIN_GRAD_TOL
          and c["zero"] <= 1.0 and c["bn"] <= TRAIN_BN_TOL)
    log(f"  train {stage} parity, {label}: {describe(c)} (tolerances "
        f"{TRAIN_LOSS_TOL:g}, {TRAIN_GRAD_TOL:g}, {ZERO_GRAD_TOL:g}, "
        f"{TRAIN_BN_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"train {stage} parity, {label}: {describe(c)}")


def train_parity(stage, train, vocab, tx, failures):
    """One f32 step on the card from the checkpoint at each of
    PARITY_BATCHES, held to the float64 step on its own choices; at the
    fixture's batch (JAX's draws) the coarse step is also held to JAX's
    f32 step, and JAX's f32 step is read against the float64 step; the
    gradients that must not be zero."""
    from text2pos_torch.ops.transforms import sample_indices
    from text2pos_torch.train.coarse import step_generator
    from text2pos_torch.utils.float64 import Decisions

    jax = fixture_step(stage, tx)
    report = {}
    for batch_size in PARITY_BATCHES[stage]:
        trainer = make_trainer(stage, vocab)
        state = trainer.init_state(1)
        batch = next(stage_loader(stage, train, vocab, batch_size).epoch(
            seed=1))
        if batch_size == STEP_BATCH[stage]:
            tok = "tokens" if stage == "coarse" else "hint_tokens"
            same = (np.array_equal(batch[tok], tx[f"{stage}_{tok}"])
                    and np.array_equal(batch["pose_idx"],
                                       tx[f"{stage}_pose_idx"]))
            log(f"  train {stage}: the loader's batch of {batch_size} "
                f"equals the fixture's: {same}")
            if not same:
                failures.append(f"train {stage}: the loader's batch "
                                "differs from the fixture's")
            draws = {"idx": tx[f"{stage}_idx"].astype(np.int64),
                     "angles": tx[f"{stage}_angles"]}
            label = f"batch {batch_size}, JAX's draws"
        else:
            obj = (trainer.objects(batch) if stage == "coarse"
                   else trainer.tensors(batch))
            counts = obj["point_count"].cpu()
            gen = step_generator(torch.device("cpu"), 6, batch_size)
            draws = {"idx": sample_indices(counts, 256, obj[
                "points_xyz"].shape[-2], gen).numpy(),
                "angles": (torch.rand(counts.shape, generator=gen) * 240.0
                           - 120.0).numpy()}
            label = f"batch {batch_size} (the recipe's), the port's draws"
        decisions = Decisions()
        with decisions.record():
            port = step_grads(stage, trainer, state, batch, draws)
        t0 = time.time()
        ref = float64_step(stage, vocab, batch, draws, decisions)
        near = decisions.margin <= NEAR_TIE_TOL
        log(f"  train {stage} {label}: the float64 step took "
            f"{time.time() - t0:.1f} s on the card, on the f32 step's "
            f"{len(decisions.log)} recorded choices; left to itself it "
            f"would have chosen otherwise at {decisions.flips} entries, each "
            f"a near-tie within {decisions.margin:.2e} of the tensor's "
            f"largest magnitude (tolerance {NEAR_TIE_TOL:g}) "
            f"{'ok' if near else 'FAIL'}")
        if not near:
            failures.append(f"train {stage} {label}: a choice of the f32 "
                            f"step is {decisions.margin} from a tie")
        rep = {"flips": decisions.flips, "flip_margin": decisions.margin}
        del decisions
        rep["port_vs_float64"] = c = compare_steps(summary(port),
                                                   summary(ref))
        gate_step(stage, f"the card's f32 step vs the float64 step, {label}",
                  c, failures)
        if batch_size == STEP_BATCH[stage]:
            if stage == "coarse":
                rep["port_vs_jax"] = c = compare_steps(summary(port, jax[2]),
                                                       jax)
                gate_step(stage, f"the card's f32 step vs JAX's f32 step, "
                          f"{label}", c, failures)
            rep["jax_vs_float64"] = c = compare_steps(jax,
                                                      summary(ref, jax[2]))
            log(f"  train {stage}: JAX's f32 step (fixture) vs the float64 "
                f"step, {label} (on the port's choices; printed, not "
                f"gated): {describe(c)}")
        report[f"batch_{batch_size}"] = rep
    named = dict(state.model.named_parameters())
    nonzero = ["language_encoder.lstm_fwd_w_hh",
               "language_encoder.word_embedding.weight"]
    if stage == "fine":
        nonzero += ["superglue.gnn.layer_0.attn.proj_q.weight",
                    "superglue.gnn.layer_11.mlp.dense_1.weight",
                    "superglue.bin_score"]
    zero = [n for n in nonzero if named[n].grad is None
            or float(named[n].grad.abs().sum()) == 0.0]
    log(f"  train {stage}: non-zero gradients to {', '.join(nonzero)}: "
        f"{'ok' if not zero else 'FAIL ' + str(zero)}")
    if zero:
        failures.append(f"train {stage}: zero gradient to {zero}")
    return report


def function_checks(failures):
    """The two autograd Functions on the card at the training shapes:
    forward (the kernel) against the plain version, gradients against plain
    autograd's on the card."""
    from text2pos_torch.ops.lstm import (LSTMFinalHidden,
                                         lstm_final_hidden_plain)
    from text2pos_torch.ops.sinkhorn import (LogOptimalTransport,
                                             log_optimal_transport_plain)

    g = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for name, (B, T, H) in {"coarse": (64, 64, 256),
                            "fine": (192, 16, 128)}.items():
        V = 31 + 1
        tables = [(0.5 * torch.randn(V, 4 * H, device="cuda", generator=g)
                   ).requires_grad_() for _ in range(2)]
        w_hh = [(torch.randn(H, 4 * H, device="cuda", generator=g)
                 / math.sqrt(H)).requires_grad_() for _ in range(2)]
        tok = torch.randint(1, V, (B, T), device="cuda", generator=g)
        ln = torch.randint(1, T + 1, (B,), device="cuda", generator=g)
        w = torch.randn(2, B, H, device="cuda", generator=g)
        got = LSTMFinalHidden.apply(tok, ln, *tables, *w_hh)
        gg = torch.autograd.grad((got * w).sum(), (*tables, *w_hh))
        ref = lstm_final_hidden_plain(tables, w_hh, tok, ln)
        gr = torch.autograd.grad((ref * w).sum(), (*tables, *w_hh))
        fwd = max_err(got, ref)
        grad = max(float((a - b).norm() / b.norm()) for a, b in zip(gg, gr))
        check(f"LSTM Function forward, {name} training shape [{B}, {T}], "
              f"H={H}", fwd, TOL["lstm"], failures)
        check(f"LSTM Function gradients vs plain autograd (relative L2), "
              f"{name}", grad, 1e-4, failures)
        out[f"lstm_{name}"] = {"forward_err": fwd, "grad_rel_err": grad}
    scores = (5 * torch.randn(32, 16, 6, device="cuda", generator=g)
              ).requires_grad_()
    alpha = torch.tensor(1.0, device="cuda", requires_grad=True)
    w = torch.randn(32, 17, 7, device="cuda", generator=g)
    got = LogOptimalTransport.apply(scores, alpha, 50)
    gg = torch.autograd.grad((got * w).sum(), (scores, alpha))
    ref = log_optimal_transport_plain(scores, alpha, 50)
    gr = torch.autograd.grad((ref * w).sum(), (scores, alpha))
    fwd = max_err(got, ref)
    grad = max(float((a - b).norm() / b.norm()) for a, b in zip(gg, gr))
    check("Sinkhorn Function forward, training shape [32, 17, 7], 50 "
          "iterations", fwd, TOL["sinkhorn"], failures)
    check("Sinkhorn Function gradients vs plain autograd (relative L2)",
          grad, 1e-4, failures)
    out["sinkhorn_fine"] = {"forward_err": fwd, "grad_rel_err": grad}
    return out


def eval_checks(stage, trainer, state, val, vocab, tx, failures,
                label="committed checkpoint"):
    """The evaluation epoch on the validation scene with JAX's draws:
    coarse top-k accuracy, fine recall and precision, against the
    fixture's within one query."""
    if stage == "coarse":
        from text2pos_torch.data.loaders import CoarseLoader

        loader = CoarseLoader(*val, vocab, 64, 24, 256, 64, seed=0)
        offs = tx["coarse_eval_offsets"]
        draws = [tx["coarse_eval_idx"][a:b].astype(np.int64)
                 for a, b in zip(offs[:-1], offs[1:])]
        acc, close, _ = trainer.eval_epoch(state, loader, (1, 3, 5),
                                           draws=draws)
        want = tx["coarse_eval_acc"]
        q = len(loader)
        diff = max(abs(acc[k] - w) for k, w in zip((1, 3, 5), want))
        log(f"  eval coarse ({label}): top-1/3/5 "
            f"{acc[1]:.4f}/{acc[3]:.4f}/{acc[5]:.4f} vs JAX "
            f"{want[0]:.4f}/{want[1]:.4f}/{want[2]:.4f} on JAX's draws "
            f"({q} queries; the checkpoint's stored val_acc 0.7368, other "
            "draws)")
        if diff > 1.0 / q + 1e-9:
            failures.append(f"eval coarse: accuracy {acc} vs JAX {want}")
        return acc
    loader = stage_loader("fine", val, vocab, 32)
    draws = [{"idx": d.astype(np.int64)} for d in tx["fine_eval_idx"]]
    rows = []
    for i, b in enumerate(loader.epoch(seed=0, shuffle=False,
                                       drop_last=False)):
        B = b["gt_obj_for_hint"].shape[0]
        b["sample_mask"] = np.arange(B) < int(b["num_real"])
        m, _ = trainer.eval_step(state, b, draws=draws[i])
        rows.append([float(m["recall"]), float(m["precision"])])
    rows = np.array(rows)
    want = tx["fine_eval_metrics"][:, :2]
    per_query = np.abs(rows - want) * tx["fine_eval_real"][:, None]
    log(f"  eval fine ({label}): recall {rows[:, 0].mean():.4f} precision "
        f"{rows[:, 1].mean():.4f} (mean {rows.mean():.4f}) vs JAX "
        f"{want[:, 0].mean():.4f} {want[:, 1].mean():.4f} (mean "
        f"{want.mean():.4f}); the checkpoint's stored val_acc 0.8775 (other "
        f"draws); largest batch difference {per_query.max():.3f} queries")
    if per_query.max() > 1.0 + 1e-6:
        failures.append(f"eval fine: recall/precision differ from JAX's by "
                        f"{per_query.max()} queries")
    return rows.mean(0)


def profile_train_step(stage, trainer, state, batch, generator):
    """One training step under torch.profiler, its three ranges apart
    (``train.forward``, ``train.backward``, ``train.optimizer``, each run
    to a synchronization): {range: (wall ms, device ms)} and {kernel or
    ``*.backward_plain`` range: device ms}; None when the profiler
    recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    held = {}

    def forward():
        out = trainer.forward_loss(state, batch, generator)
        held["loss"] = out if stage == "coarse" else out[0]

    phases = {"train.forward": forward,
              "train.backward": lambda: held["loss"].backward(),
              "train.optimizer": state.apply_gradients}
    ranges, detail = {}, collections.defaultdict(float)
    for name, fn in phases.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        spans, kernels = [], []
        events = prof.events()
        on_host = {e.name for e in events
                   if "CUDA" not in str(getattr(e, "device_type", ""))}
        for e in events:
            if "CUDA" not in str(getattr(e, "device_type", "")):
                continue
            if e.name.endswith(".backward_plain"):
                spans.append((e.time_range.start, e.time_range.end, e.name))
            elif e.name not in on_host:     # not a range's device span
                kernels.append(e)
        dev = 0.0
        for k in kernels:
            t = k.time_range.elapsed_us() / 1e3
            dev += t
            for a, b, n in spans:
                if a <= k.time_range.start < b:
                    detail[n] += t
            if "lstm" in k.name or "sinkhorn" in k.name:
                detail["kernel " + ("lstm" if "lstm" in k.name
                                    else "sinkhorn")] += t
        ranges[name] = (wall, dev)
    if not any(dev for _, dev in ranges.values()):
        return None
    return ranges, dict(detail)


def state_snapshot(state):
    """Copies of a training state's parameters (``param/``), BN statistics
    (``buffer/``), Adam's moments (``mu/``, ``nu/``), count and step."""
    opt = state.optimizer
    snap = {f"param/{n}": p.detach().clone()
            for n, p in state.model.named_parameters()}
    snap.update({f"buffer/{n}": b.detach().clone()
                 for n, b in state.model.named_buffers()})
    for p in opt.param_groups[0]["params"]:
        for m in ("mu", "nu"):
            snap[f"{m}/{opt.names[p]}"] = opt.state[p][m].detach().clone()
    snap["count"] = torch.tensor([opt.count, state.step])
    return snap


def train_steps(stage, train, vocab, gpu, scratch, failures,
                steps=TRAIN_STEPS):
    """``steps`` training steps at the recipe's width from the checkpoint:
    losses finite, ms a step (median of the last 15, synchronized), one
    step's profile; a resume file after step 10 and the last 10 steps again
    from it. Returns (trainer, state, launches by kernel, report)."""
    from text2pos_torch.ops import _build
    from text2pos_torch.train.coarse import step_generator
    from text2pos_torch.train.state import (load_resume_checkpoint,
                                            save_resume_checkpoint)

    trainer = make_trainer(stage, vocab)
    loader = stage_loader(stage, train, vocab, TRAIN_RECIPE[stage][
        "batch_size"])
    state = trainer.init_state(loader.num_batches(True))
    batches = list(itertools.islice(itertools.chain.from_iterable(
        loader.epoch(seed=e) for e in range(1, steps + 1)), steps))
    gen = lambda i: step_generator(trainer.device, 5, i)
    step = lambda i: trainer.train_step(state, batches[i], gen(i))
    resume = os.path.join(scratch, f"train_{stage}_resume.msgpack")
    losses, times = [], []
    _build.LAUNCHES.clear()
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(i)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(out if stage == "coarse" else out["loss"]))
        if i + 1 == steps // 2:
            save_resume_checkpoint(resume, state, 0, -1.0, None)
            saved = state_snapshot(state)
    launches = dict(_build.LAUNCHES)
    ms = statistics.median(times[5:] or times)
    finite = all(math.isfinite(x) for x in losses)
    log(f"  train {stage}: {steps} steps at batch "
        f"{TRAIN_RECIPE[stage]['batch_size']}, losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, all finite {finite}; {ms:.2f} ms a step (median "
        f"of the last {steps - 5}; first {times[0]:.0f} ms) on {gpu}; "
        f"launches {launches}")
    if not finite:
        failures.append(f"train {stage}: a loss is not finite: {losses}")
    for k in ("lstm", "fps") + (("sinkhorn",) if stage == "fine" else ()):
        if launches.get(k, 0) < steps:
            failures.append(f"train {stage}: kernel {k} launched "
                            f"{launches.get(k, 0)} times in {steps} steps")
    prof = profile_train_step(stage, trainer, state, batches[steps - 1],
                              gen(steps - 1))
    report = {"ms_per_step": ms, "losses": losses}
    if prof is None:
        log(f"  train {stage} profile: no device time recorded (not "
            "measured)")
    else:
        ranges, detail = prof
        wall = sum(w for w, _ in ranges.values())
        busy = sum(d for _, d in ranges.values())
        log(f"  train {stage} profile of one step (torch.profiler, ranges "
            f"run apart, {gpu}): wall {wall:.2f} ms, device busy "
            f"{busy:.2f} ms ({100 * busy / wall:.1f}%); " + ", ".join(
                f"{k} wall {w:.2f} ms device {d:.2f} ms"
                for k, (w, d) in ranges.items()) + "; device time of " +
            ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(detail.items())))
        report.update(profile_wall_ms=wall, device_busy_ms=busy,
                      by_range=ranges, detail=detail)
    # Resume after half the steps and run the rest again.
    trainer2 = make_trainer(stage, vocab)
    state2, _, _, _ = load_resume_checkpoint(
        resume, trainer2.init_state(loader.num_batches(True)))
    loaded = state_snapshot(state2)
    unequal = [k for k in saved if k not in loaded
               or not torch.equal(saved[k], loaded[k])]
    log(f"  train {stage}: the resume file after {steps // 2} steps reloads "
        f"the straight run's parameters, BN statistics, Adam's moments, count"
        f" and step bit for bit ({len(saved)} tensors): "
        f"{'ok' if not unequal else 'FAIL'}")
    if unequal or set(saved) != set(loaded):
        failures.append(f"train {stage}: the reloaded state differs from "
                        f"the saved one: {unequal[:5]}")
    again = []
    for i in range(steps // 2, steps):
        out = trainer2.train_step(state2, batches[i], gen(i))
        again.append(float(out if stage == "coarse" else out["loss"]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(again,
                                                  losses[steps // 2:]))
    first = again[0] == losses[steps // 2]
    log(f"  train {stage}: resumed after {steps // 2} steps, the first "
        f"resumed loss equals the straight run's: {first}; the last "
        f"{steps - steps // 2} losses within {rel:.2e} (relative) of the "
        f"straight run's (tolerance {RESUME_LOSS_TOL[stage]:g})")
    if rel > RESUME_LOSS_TOL[stage] or not first:
        failures.append(f"train {stage}: resume differs by {rel} (first "
                        f"step equal: {first})")
    report["resume_loss_rel_err"] = rel
    return trainer, state, launches, report


def after_training(stage, trainer, state, val, vocab, scratch, failures):
    """Eval of the trained state against a fresh model loaded from its
    ``save_checkpoint``: equal encodings and metrics show that the kernels
    see the updated weights (no stale W2 fragments or GNN fold)."""
    from text2pos_torch.train.coarse import step_generator
    from text2pos_torch.train.state import save_checkpoint

    path = os.path.join(scratch, f"train_{stage}.msgpack")
    save_checkpoint(path, state)
    fresh_trainer = make_trainer(stage, vocab, continue_path=path)
    fresh = fresh_trainer.init_state(1)
    if stage == "coarse":
        from text2pos_torch.data.loaders import CoarseLoader

        loader = CoarseLoader(*val, vocab, 64, 24, 256, 64, seed=0)
        a = trainer.eval_epoch(state, loader, (1, 3, 5), True)
        b = fresh_trainer.eval_epoch(fresh, loader, (1, 3, 5), True)
        diff = max(float(np.abs(a[3] - b[3]).max()),
                   float(np.abs(a[4] - b[4]).max()))
        same = a[0] == b[0] and diff == 0.0
        log(f"  eval coarse after {TRAIN_STEPS} steps: top-1/3/5 "
            f"{a[0][1]:.4f}/{a[0][3]:.4f}/{a[0][5]:.4f}; a model reloaded "
            f"from save_checkpoint gives {b[0][1]:.4f}/{b[0][3]:.4f}/"
            f"{b[0][5]:.4f}, encodings max difference {diff:.2e}: "
            f"{'equal' if same else 'FAIL'}")
    else:
        loader = stage_loader("fine", val, vocab, 32)
        rows = []
        for tr, st in ((trainer, state), (fresh_trainer, fresh)):
            res = []
            for i, b in enumerate(loader.epoch(seed=0, shuffle=False,
                                               drop_last=False)):
                B = b["gt_obj_for_hint"].shape[0]
                b["sample_mask"] = np.arange(B) < int(b["num_real"])
                _, out = tr.eval_step(st, b, step_generator(tr.device, 3,
                                                            0, i))
                res.append(out["log_P"])
            rows.append(torch.cat(res))
        diff = float((rows[0] - rows[1]).abs().max())
        same = diff == 0.0
        log(f"  eval fine after {TRAIN_STEPS} steps: log transport of the "
            f"trained state vs a model reloaded from save_checkpoint, max "
            f"difference {diff:.2e}: {'equal' if same else 'FAIL'}")
    if not same:
        failures.append(f"eval {stage} after training differs from the "
                        "reloaded checkpoint's")


def train_phase(gpu, failures):
    """Phase 7. Returns ({path: launches}, report). Checkpoints go to a
    temporary directory in the checkout, removed at the end."""
    import tempfile

    from text2pos_torch.ops import _build

    if not os.path.isfile(TRAIN_FIXTURE):
        failures.append(f"missing {TRAIN_FIXTURE}")
        return {}, {}
    tx = dict(np.load(TRAIN_FIXTURE))
    t0 = time.time()
    train, val, vocab = train_data()
    log(f"  training data rebuilt in {time.time() - t0:.1f} s: "
        f"{len(train[0])} cells / {len(train[1])} poses, validation "
        f"{len(val[0])} / {len(val[1])}")
    report = {"functions": function_checks(failures)}
    by_path = {}
    scratch = tempfile.TemporaryDirectory(dir=ROOT, prefix=".train_smoke_")
    for stage in ("coarse", "fine"):
        report[f"{stage}_parity"] = train_parity(stage, train, vocab, tx,
                                                 failures)
        trainer = make_trainer(stage, vocab)
        state = trainer.init_state(1)
        _build.LAUNCHES.clear()
        eval_checks(stage, trainer, state, val, vocab, tx, failures)
        by_path[f"eval_{stage}"] = dict(_build.LAUNCHES)
        trainer, state, launches, rep = train_steps(
            stage, train, vocab, gpu, scratch.name, failures)
        by_path[f"train_{stage}"] = launches
        report[f"{stage}_steps"] = rep
        after_training(stage, trainer, state, val, vocab, scratch.name,
                       failures)
    scratch.cleanup()
    if by_path["eval_coarse"].get("pointconv", 0) < 1:
        failures.append("the coarse eval epoch launched no PointConv kernel")
    return by_path, report


# Phase 8: evaluation. JAX's evaluator at its CLI's defaults (f32, top-k
# 1/5/10, thresholds 5/10/15 m, batches of 32, fine chunks of 8) on the
# bench map and checkpoints; its CPU outputs are in the fixture
# (scripts/make_torch_port_eval_fixture.py). The port draws its own points,
# which moves the encodings statistically (phase 5), so each accuracy is
# held within EVAL_ACC_SLACK at top-1, 5 and 10 @15 m; the numpy oracles on
# a given top_idx must equal JAX's exactly.
EVAL_FIXTURE = os.path.join(ROOT, "text2pos_torch", "fixtures",
                            "bench_eval.npz")
EVAL_ACC_SLACK = 0.02
# evaluation.fine on JAX's own draws: every stat and threshold accuracy
# within EVAL_FINE_TOL of JAX's. One flipped match moves recall or
# precision by about 1 / (32 poses x 6 hints) / 2 batches = 2.6e-3 and a
# threshold accuracy by 1 / 64, so the gate admits f32 rounding (the port
# on the CPU reads 6e-8) and no flipped decision.
EVAL_FINE_TOL = 2e-3
UNCACHED_QUERIES = 16
PROFILE_QUERIES = 64
# The kernel wrappers whose inputs phase 8 keeps, with their plain
# versions: (kernel, module under text2pos_torch.ops, wrapper, plain).
EVAL_WRAPPERS = (
    ("lstm", "lstm", "_lstm_kernel", "lstm_final_hidden_plain"),
    ("sinkhorn", "sinkhorn", "_lot_kernel", "log_optimal_transport_plain"),
    ("sinkhorn", "sinkhorn", "_sinkhorn_kernel", "log_sinkhorn_plain"),
    ("fps", "fps", "_fps_kernel", "farthest_point_sampling_plain"),
    ("fps", "fps", "_fps_levels_kernel",
     "farthest_point_sampling_levels_plain"),
    ("pointconv", "pointconv", "_pointconv_kernel", "pointconv_max_plain"),
    ("superglue_gnn", "superglue_gnn", "_gnn_kernel", "gnn_scores_plain"),
)
CAPTURE_SHAPES = 3   # input shapes a wrapper keeps a stage: an SA step


def detached_copy(x):
    """A copy of a wrapper's argument: tensors cloned, containers rebuilt."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (list, tuple)):
        return type(x)(detached_copy(v) for v in x)
    if isinstance(x, dict):
        return {k: detached_copy(v) for k, v in x.items()}
    return x


@contextlib.contextmanager
def kept_inputs(store: dict):
    """While inside, each wrapper of EVAL_WRAPPERS keeps a copy of its
    arguments for each of the first CAPTURE_SHAPES input shapes it meets:
    ``store[(module, wrapper)][shapes] = args``. One shape check a call and
    a few copies a stage are all it adds to the stage's time."""
    patched = []
    for _, mod, wrapper, _ in EVAL_WRAPPERS:
        m = importlib.import_module(f"text2pos_torch.ops.{mod}")
        orig = getattr(m, wrapper)
        seen = store.setdefault((mod, wrapper), {})

        def keep(*args, _orig=orig, _seen=seen):
            key = tuple(tuple(a.shape) for a in args
                        if isinstance(a, torch.Tensor))
            if key not in _seen and len(_seen) < CAPTURE_SHAPES:
                _seen[key] = detached_copy(args)
            return _orig(*args)

        setattr(m, wrapper, keep)
        patched.append((m, wrapper, orig))
    try:
        yield store
    finally:
        for m, wrapper, orig in patched:
            setattr(m, wrapper, orig)


def kept_checks(stage: str, store: dict, failures: list) -> dict:
    """Each kept launch's inputs through its wrapper and its plain version:
    LSTM and Sinkhorn to TOL, PointConv and the GNN to their relative
    tolerances of the output's largest magnitude, FPS's indices and
    centroids bit for bit. Returns {kernel: largest error}."""
    errs = {}
    for kernel, mod, wrapper, plain in EVAL_WRAPPERS:
        m = importlib.import_module(f"text2pos_torch.ops.{mod}")
        for shapes, args in store.get((mod, wrapper), {}).items():
            with torch.inference_mode():
                got = getattr(m, wrapper)(*args)
                want = getattr(m, plain)(
                    *(args[:10] if kernel == "pointconv" else args))
                torch.cuda.synchronize()
            if kernel == "fps":
                pairs = (zip(got, want, strict=True)
                         if isinstance(got, list) else [(got, want)])
                err = sum(max_err(g[1], w[1]) + float((g[0] != w[0]).sum())
                          for g, w in pairs)
                tol, what = 0.0, "differing indices + centroid error"
            elif kernel in ("pointconv", "superglue_gnn"):
                dt = (args[2]["wqkv"] if kernel == "superglue_gnn"
                      else args[0]).dtype
                label = "bf16" if dt == torch.bfloat16 else "f32"
                rel = (GNN_REL_TOL if kernel == "superglue_gnn"
                       else POINTCONV_REL_TOL)[label]
                err = max_err(got, want)
                tol = rel * float(want.float().abs().max())
                what = f"{label}, {rel:g} of |out| max"
            else:
                err, tol, what = max_err(got, want), TOL[kernel], "abs"
            check(f"{stage} {wrapper} on its inputs {list(shapes)} vs "
                  f"{plain} ({what})", err, tol, failures)
            errs[kernel] = max(errs.get(kernel, 0.0), err)
    return errs


def acc_at15(accs) -> list:
    """[top-1, 5, 10 (or 1)]@15m of an accuracy dict, rounded."""
    return [round(float(accs[k][15]), 4) for k in accs]


def gate_accs(label, accs, want, failures, exact=False):
    """Hold ``accs`` (a dict) against JAX's [k, t] array ``want``: each
    top-k@15m within EVAL_ACC_SLACK, or every entry equal."""
    got = np.array([[accs[k][t] for t in accs[k]] for k in accs])
    if exact:
        ok = np.array_equal(got, want)
        err = float(np.abs(got - want).max())
    else:
        err = float(np.abs(got[:, -1] - want[:, -1]).max())
        ok = err <= EVAL_ACC_SLACK
    log(f"    {label}: @15m {[round(float(x), 4) for x in got[:, -1]]} "
        f"(JAX {[round(float(x), 4) for x in want[:, -1]]}); max |diff| "
        f"{err:.4f} ({'equal' if exact else f'gate {EVAL_ACC_SLACK}'}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"eval {label}: {got.tolist()} vs JAX "
                        f"{want.tolist()}")


def timed(fn, store=None):
    """(result, synchronized wall seconds, kernel launches) of ``fn()``;
    with ``store``, its kernels' inputs kept there (``kept_inputs``)."""
    from text2pos_torch.ops import _build

    with kept_inputs(store) if store is not None else \
            contextlib.nullcontext():
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(_build.LAUNCHES)


def parse_tables(text: str) -> dict:
    """{table name: [accuracies]} of the evaluation CLI's output."""
    out, name = {}, None
    for line in text.splitlines():
        s = line.strip()
        if s.endswith(":") and not s[0].isdigit():
            name = s[:-1]
        elif name and s[:1].isdigit() and ":" in s:
            out[name] = [float(v) for part in s.split(":", 1)[1].split()
                         for v in part.split("/")]
    return out


def eval_cli_checks(failures):
    """Both evaluation CLIs as subprocesses on the card (the SYNTHETIC
    validation scenes, the bench checkpoints); their tables parsed."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    runs = {
        "pipeline": (["--dataset", "SYNTHETIC", "--path_coarse",
                      CKPT_COARSE, "--path_fine", CKPT_FINE],
                     ("Coarse", "Fine (mean)", "Fine (offsets)",
                      "Fine (mean-conf)")),
        "fine": (["--dataset", "SYNTHETIC-FINE", "--path_fine", CKPT_FINE],
                 ()),
    }
    for mod, (args, tables) in runs.items():
        t0 = time.time()
        p = subprocess.run([sys.executable, "-m",
                            f"text2pos_torch.evaluation.{mod}", *args],
                           cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=300)
        wall = time.time() - t0
        if mod == "pipeline":
            parsed = parse_tables(p.stdout)
            ok = p.returncode == 0 and all(
                len(parsed.get(t, [])) in (3, 9)
                and all(0.0 <= v <= 1.0 for v in parsed[t]) for t in tables)
            shown = {t: parsed.get(t) for t in tables}
        else:
            vals = {}
            for line in p.stdout.splitlines():
                k, _, v = line.strip().partition(": ")
                try:
                    vals[k] = float(v)
                except ValueError:
                    pass
            ok = p.returncode == 0 and all(
                0.0 <= vals.get(k, -1.0) <= 1.0
                for k in ("recall", "precision"))
            shown = {k: vals.get(k) for k in ("recall", "precision", "mean",
                                              "offsets")}
        log(f"  CLI python -m text2pos_torch.evaluation.{mod} "
            f"{' '.join(args[:2])}: exit {p.returncode} in {wall:.1f} s; "
            f"{shown} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"evaluation CLI {mod}: exit {p.returncode}; "
                            f"{p.stderr[-2000:]}")


def fine_isolation(draws):
    """``evaluation.fine``'s ``main`` in-process on JAX's draws, its table
    unprinted; returns (stats in the fixture's order, threshold accuracies
    [variant, threshold])."""
    from text2pos_torch.evaluation import fine as efine

    with contextlib.redirect_stdout(io.StringIO()):
        res = efine.main(["--dataset", "SYNTHETIC-FINE", "--path_fine",
                          CKPT_FINE], draws)
    return (np.array([res["stats"][k]
                      for k in ("recall", "precision") + efine.VARIANTS]),
            np.array([list(d.values()) for d in res["thresh"].values()]))


def eval_phase(cells, poses, failures):
    """Phase 8. The evaluator (``run_coarse``, ``run_fine`` cached and
    re-ranked, the oracles) on the checkpoints' pipeline in f32; a
    calibrated bf16 pipeline's ``run_fine`` (the GNN kernel); the uncached
    path on the first queries; ``evaluation.fine`` on JAX's draws and its
    controls; both CLIs. Each stage's kernels are held against their plain
    versions on the inputs it gave them. Returns ({path: launches},
    {kernel: {path: largest error on the path's inputs}})."""
    import dataclasses

    from text2pos_torch.config import EvalConfig
    from text2pos_torch.data.hints import create_hint_description
    from text2pos_torch.data.loaders import CoarseLoader
    from text2pos_torch.evaluation.pipeline import (
        LocalizationPipeline, build_pipeline_from_checkpoints, hint_arrays)
    from text2pos_torch.ops import lstm, sinkhorn

    if not os.path.isfile(EVAL_FIXTURE):
        failures.append(f"missing {EVAL_FIXTURE}")
        return {}, {}
    ex = dict(np.load(EVAL_FIXTURE))
    cfg = EvalConfig()
    pipe, vocab, fvocab = build_pipeline_from_checkpoints(
        cfg, CKPT_COARSE, CKPT_FINE)
    t0 = time.time()
    loader = CoarseLoader(cells, poses, vocab, cfg.batch_size,
                          cfg.coarse_max_objects, cfg.pointnet_numpoints,
                          cfg.max_text_len)
    Q = len(poses)
    log(f"  checkpoints' pipeline, f32, JAX's CLI defaults; CoarseLoader "
        f"of the bench map built in {time.time() - t0:.1f} s")
    by_path, errs = {}, collections.defaultdict(dict)

    def stage(path, fn):
        """``fn()`` timed as path ``path``, its launches recorded and its
        kernels' kept inputs checked; returns (result, wall s)."""
        kept = {}
        out, wall, by_path[path] = timed(fn, kept)
        for kernel, err in kept_checks(path, kept, failures).items():
            errs[kernel][path] = err
        return out, wall

    (top_idx, caccs), t_coarse = stage(
        "evaluator_coarse", lambda: pipe.run_coarse(loader, poses))
    same = float((top_idx == ex["coarse_top_idx"]).all(1).mean())
    log(f"  run_coarse: {Q} queries x {cfg.batch_size}-query steps, "
        f"{loader.bank.num_cells} cells in {cfg.batch_size}-cell steps: "
        f"{t_coarse:.3f} s; launches {by_path['evaluator_coarse']}; rows "
        f"equal to JAX's top_idx {same:.4f}")
    gate_accs("coarse", caccs, ex["coarse_acc"], failures)
    fbank, t_bank = stage("evaluator_fine_bank",
                          lambda: pipe.precompute_fine_bank(loader.bank))
    log(f"  precompute_fine_bank (batch statistics, 64-cell steps): "
        f"{t_bank:.3f} s; launches {by_path['evaluator_fine_bank']}")
    (m, o, c), t_fine = stage(
        "evaluator_fine", lambda: pipe.run_fine(loader, poses, top_idx,
                                                fvocab, fine_bank=fbank))
    total = t_coarse + t_bank + t_fine
    log(f"  run_fine cached, chunks of 8 x top-{top_idx.shape[1]}: "
        f"{t_fine:.3f} s; launches {by_path['evaluator_fine']}; evaluation "
        f"{total:.3f} s = {Q / total:.1f} queries/s")
    gate_accs("fine mean", m, ex["fine_mean_acc"], failures)
    gate_accs("fine offsets", o, ex["fine_offsets_acc"], failures)
    gate_accs("fine mean-conf", c, ex["fine_conf_acc"], failures)
    for name in ("lstm", "sinkhorn", "fps", "pointconv"):
        n = sum(by_path[p].get(name, 0) for p in
                ("evaluator_coarse", "evaluator_fine_bank", "evaluator_fine"))
        if n < 1:
            failures.append(f"the evaluation launched no {name} kernel")

    # Where the two slow stages spend their time: the device's busy time
    # (torch.profiler) against the wall time of the same call unprofiled.
    pq = PROFILE_QUERIES
    sub = lambda: pipe.run_fine(loader, poses[:pq], top_idx[:pq], fvocab,
                                fine_bank=fbank)
    _, t_sub, _ = timed(sub)
    log(f"  run_fine cached on the first {pq} queries ({pq // 8} chunks): "
        f"{t_sub * 1e3:.2f} ms unprofiled")
    log_ranges(f"profile of run_fine cached, first {pq} queries",
               profile_ranges(sub, "evaluator."))
    log_ranges(f"profile of precompute_fine_bank ({t_bank * 1e3:.1f} ms "
               "unprofiled above; by PointNet++ stage)", profile_ranges(
                   lambda: pipe.precompute_fine_bank(loader.bank),
                   "pointnet."))

    rcfg = dataclasses.replace(cfg, rerank=128, rerank_gamma=6.0)
    rpipe = LocalizationPipeline(pipe.coarse, pipe.fine, vocab, fvocab,
                                 cfg=rcfg)
    (rtop, raccs), t_rc, _ = timed(lambda: rpipe.run_coarse(loader, poses))
    (rm, ro, rc), t_rf = stage(
        "evaluator_rerank", lambda: rpipe.run_fine(loader, poses, rtop,
                                                   fvocab, fine_bank=fbank))
    log(f"  rerank@128 (gamma 6): run_coarse {t_rc:.3f} s, run_fine of {Q} "
        f"queries x 128 {t_rf:.3f} s = {Q / t_rf:.1f} queries/s; launches "
        f"{by_path['evaluator_rerank']}")
    gate_accs("rerank coarse", raccs, ex["rerank_coarse_acc"], failures)
    gate_accs("rerank fine mean", rm, ex["rerank_mean_acc"], failures)
    gate_accs("rerank fine offsets", ro, ex["rerank_offsets_acc"], failures)
    gate_accs("rerank fine mean-conf", rc, ex["rerank_conf_acc"], failures)

    rtop_rand, rand_acc = LocalizationPipeline(
        pipe.coarse, pipe.fine, vocab, fvocab,
        cfg=dataclasses.replace(cfg, coarse_random=True)).run_coarse(
            loader, poses)
    eq = np.array_equal(rtop_rand, ex["coarse_random_top_idx"])
    log(f"  coarse_random top_idx equal to JAX's: {eq} "
        f"{'ok' if eq else 'FAIL'}")
    if not eq:
        failures.append("coarse_random top_idx differs from JAX's")
    gate_accs("coarse_random", rand_acc, ex["coarse_random_acc"], failures,
              exact=True)
    jtop = ex["coarse_top_idx"].astype(np.int64)
    for rnd, key in ((False, "oracle_exact_acc"), (True,
                                                    "oracle_random_acc")):
        gate_accs(f"fine oracle ({'random' if rnd else 'exact'}) on JAX's "
                  f"top_idx", pipe.run_fine_oracle(loader, poses, jtop, rnd),
                  ex[key], failures, exact=True)

    base = build_pipeline_from_checkpoints(cfg, CKPT_COARSE, CKPT_FINE,
                                           "bfloat16")[0]
    htk, hln = hint_arrays(fvocab, [create_hint_description(p)
                                    for p in poses], cfg.num_mentioned,
                           cfg.max_hint_len)
    cal, t_cal, _ = timed(lambda: base.calibrated_for_serving(
        loader.bank, htk, hln, top_idx, max_cells=128))
    (km, ko, kc), t_kf = stage(
        "evaluator_calibrated",
        lambda: cal.run_fine(loader, poses, top_idx, fvocab))
    log(f"  calibrated pipeline, bf16: calibrated in {t_cal:.3f} s; "
        f"run_fine cached (bank re-encoded) {t_kf:.3f} s = {Q / t_kf:.1f} "
        f"queries/s; launches {by_path['evaluator_calibrated']}")
    gate_accs("calibrated fine mean", km, ex["calibrated_mean_acc"],
              failures)
    gate_accs("calibrated fine offsets", ko, ex["calibrated_offsets_acc"],
              failures)
    gate_accs("calibrated fine mean-conf", kc, ex["calibrated_conf_acc"],
              failures)
    if by_path["evaluator_calibrated"].get("superglue_gnn", 0) < 1:
        failures.append("the calibrated evaluation launched no GNN kernel")

    uq = UNCACHED_QUERIES
    (um, _, _), t_u = stage(
        "evaluator_uncached",
        lambda: pipe.run_fine(loader, poses[:uq], top_idx[:uq], fvocab,
                              chunk=1, use_cache=False))
    (cm, _, _), t_c, _ = timed(
        lambda: pipe.run_fine(loader, poses[:uq], top_idx[:uq], fvocab,
                              chunk=1, fine_bank=fbank))
    log(f"  uncached path (every candidate re-encoded, chunk 1), {uq} "
        f"queries: {t_u:.3f} s = {uq / t_u:.2f} queries/s against the "
        f"cached {uq / t_c:.1f} queries/s (same chunks, bank given); "
        f"launches {by_path['evaluator_uncached']}; top-10@15m uncached "
        f"{um[10][15]:.4f}, cached {cm[10][15]:.4f}")

    draws = [{"idx": a.astype(np.int64)} for a in ex["fine_eval_idx"]]
    (got, thresh), t_fe = stage("evaluator_fine_isolation",
                                lambda: fine_isolation(draws))
    diffs = lambda got, thresh: (
        float(np.abs(got - ex["fine_eval_stats"]).max()),
        float(np.abs(thresh - ex["fine_eval_thresh"]).max()))
    err, terr = diffs(got, thresh)
    ok = err <= EVAL_FINE_TOL and terr <= EVAL_FINE_TOL
    log(f"  evaluation.fine on SYNTHETIC-FINE val (JAX's draws; its CLI's "
        f"main in-process): {t_fe:.3f} s; recall {got[0]:.6f} precision "
        f"{got[1]:.6f} (JAX {ex['fine_eval_stats'][0]:.6f} "
        f"{ex['fine_eval_stats'][1]:.6f}); max |diff| of the stats "
        f"{err:.3e}, of the threshold accuracies {terr:.3e} (gate "
        f"{EVAL_FINE_TOL:g}) {'ok' if ok else 'FAIL'}; launches "
        f"{by_path['evaluator_fine_isolation']}")
    if not ok:
        failures.append(f"evaluation.fine: {got.tolist()} vs JAX "
                        f"{ex['fine_eval_stats'].tolist()}")
    # Controls: the same run with a kernel deliberately wrong; the gate
    # must see each. (Sinkhorn at half its iterations moves the couplings
    # by up to 0.5 but flips one match of 1024, a near-tie that the
    # kernel's rounding keeps: it reads like the true run. One iteration
    # flips 41.)
    controls = (
        ("the LSTM kernel dropping each hint's last token", lstm,
         "_lstm_kernel", lambda k: lambda t, w, tok, ln: k(
             t, w, tok, (ln - 1).clamp(min=0))),
        ("the Sinkhorn kernel stopping after one iteration", sinkhorn,
         "_lot_kernel", lambda k: lambda z, a, it: k(z, a, 1)))
    for what, mod, wrapper, wrong in controls:
        right = getattr(mod, wrapper)
        setattr(mod, wrapper, wrong(right))
        try:
            cerr, cterr = diffs(*fine_isolation(draws))
        finally:
            setattr(mod, wrapper, right)
        seen = max(cerr, cterr) > EVAL_FINE_TOL
        log(f"  control, {what}: max |diff| of the stats {cerr:.3e}, of the "
            f"threshold accuracies {cterr:.3e}; above the gate {seen} "
            f"{'ok' if seen else 'FAIL'}")
        if not seen:
            failures.append(f"evaluation.fine's gate does not see {what}")
    eval_cli_checks(failures)
    return by_path, dict(errs)


# Phase 9: the checkpoints' three-stage recipe (scripts/train_bench_ckpts.py)
# on the card, on phase 7's training scene: PointNet++ pretraining from the
# committed checkpoint (batch 64, 256 points), the fused coarse trainer with
# the negative bank (batch 64, embed 256, 24 objects; T2P_FUSED_SEG=4, so an
# 8-step epoch has two segments and the bank is refreshed before each),
# the fused fine trainer with the rank-aware loss (batch 32, embed 128, 6
# block pairs, 50 iterations, R = 4), --remat, and the offsets trainer
# (batch 32). Limits:
# - fused ≡ host: the assembly equals CoarseLoader's batch exactly; a fused
#   step's loss equals the host step's within RECIPE_LOSS_TOL (relative;
#   both run the same kernels on the same inputs) and each gradient leaf
#   lies within the host step's run-to-run spread (the host step run twice;
#   CUDA's atomics in the gathers' backward), at most SPREAD_FACTOR times
#   the largest spread of a leaf, or SPREAD_FLOOR where that reads lower;
# - the bank: refresh rows against encode_all_cells on the same draws, and
#   the bank loss against a float64 recomputation, within BANK_TOL;
# - float64 replays at phase 7's limits (TRAIN_*_TOL): the rank-aware fine step
#   at 32 poses and the fused coarse step with the bank at 32 cells;
# - remat: gradients and BN statistics as the no-remat step's within the
#   spread rule above, the statistics moved once, and a lower peak;
# - the pretraining's validation accuracy on JAX's draws with the committed
#   weights within one object of JAX's (fixtures/bench_recipe.npz).
RECIPE_FIXTURE = os.path.join(ROOT, "text2pos_torch", "fixtures",
                              "bench_recipe.npz")
CKPT_POINTNET = os.path.join(ROOT, "checkpoints", "bench_pointnet.msgpack")
PRETRAIN = dict(batch_size=64, pointnet_numpoints=256, learning_rate=1e-3,
                lr_gamma=0.95)
PRETRAIN_STEPS = 10
FUSED_SEG = "4"
COARSE_EPOCHS = 2
RANK = dict(rank_weight=1.0, rank_negatives=4)
BANK = dict(neg_bank=True, neg_bank_warmup=0, neg_bank_refresh=3)
OFFSETS_STEPS = 10
CLI_PRETRAIN_EPOCHS = 4
RECIPE_LOSS_TOL = 1e-6
SPREAD_FACTOR = 2.0
SPREAD_FLOOR = 1e-6
HOST_RUNS = 4      # runs of the host step: its spread over their 6 pairs
BANK_TOL = 1e-6
F64_CELLS = 32
# Launches a single call makes, as the code predicts them (the refresh's
# per chunk of cells).
PREDICTED = {"fused coarse step": {"lstm": 1, "fps": 1, "pointconv": 0},
             "refresh": {"pointconv": 3, "fps": 1},
             "rank step": {"sinkhorn": 5, "lstm": 1, "fps": 1}}


def grads_stats(model):
    """({leaf: gradient}, {leaf: BN statistic}) in the JAX layout, numpy;
    a parameter without a gradient counts as zeros."""
    from text2pos_torch.utils.convert_jax import module_to_jax, params_to_jax

    grads = dict(flat_tree(params_to_jax(model, {
        n: torch.zeros_like(p) if p.grad is None else p.grad
        for n, p in model.named_parameters()})))
    return grads, dict(flat_tree(module_to_jax(model)[1]))


def leaf_diffs(a, b):
    """({leaf: relative L2 difference of a's leaf from b's} for the leaves
    whose norm is above ZERO_GRAD_FRACTION of b's global norm, {leaf: the
    difference's norm over the global norm} for the others: a bias before
    BatchNorm, whose exact gradient is zero, has only rounding left)."""
    total = math.sqrt(sum(float(np.sum(np.square(np.asarray(
        v, np.float64)))) for v in b.values())) or 1.0
    rel, small = {}, {}
    for k, v in b.items():
        v = np.asarray(v, np.float64)
        n = float(np.linalg.norm(v))
        d = float(np.linalg.norm(np.asarray(a[k], np.float64) - v))
        if n > ZERO_GRAD_FRACTION * total:
            rel[k] = d / n
        else:
            small[k] = d / total
    return rel, small


def gate_spread(label, got, ref, runs, failures):
    """``got`` against ``ref`` (loss, grads, stats): each gradient leaf and
    BN statistic within SPREAD_FACTOR times the largest difference of its
    kind (relative, or of a leaf near zero over the global norm) between
    any two of ``runs`` (one step run HOST_RUNS times: the spread of a
    single pair of runs read low once in three chip_smoke runs), or
    SPREAD_FLOOR where that reads lower. Returns the readings."""
    worst = lambda d: max(d.items(), key=lambda kv: kv[1], default=("", 0.0))
    spreads = [max(w) for w in zip(*(
        [worst(d)[1] for d in leaf_diffs(b[1], a[1]) + leaf_diffs(b[2], a[2])]
        for a, b in itertools.combinations(runs, 2)))]
    errs = [worst(d) for d in leaf_diffs(got[1], ref[1])
            + leaf_diffs(got[2], ref[2])]
    tols = [max(SPREAD_FACTOR * sp, SPREAD_FLOOR) for sp in spreads]
    loss = abs(got[0] - ref[0]) / abs(ref[0])
    ok = loss <= RECIPE_LOSS_TOL and all(e[1] <= t for e, t in
                                         zip(errs, tols))
    kinds = ("gradient leaves", "gradient leaves near zero (of the global "
             "norm)", "BN statistics", "BN statistics near zero")
    log(f"  {label}: loss {got[0]:.7f} vs {ref[0]:.7f} (rel {loss:.2e}, "
        f"tolerance {RECIPE_LOSS_TOL:g}); " + "; ".join(
            f"{k} {e[1]:.2e} ({e[0] or 'none'}), the reference's run-to-run "
            f"spread {sp:.2e}, tolerance {t:.2e}"
            for k, e, sp, t in zip(kinds, errs, spreads, tols)) +
        f" {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{label}: loss {loss}, errors {errs}, spreads "
                        f"{spreads}")
    return {"loss_rel": loss, "errors": [e[1] for e in errs],
            "spreads": spreads}


def replay_float64(run, decisions):
    """``run(True)`` in float64 on the choices ``decisions`` recorded, the
    LSTM's and Sinkhorn's forwards on their plain versions (their kernels
    take f32 only)."""
    import text2pos_torch.ops.lstm as lstm
    import text2pos_torch.ops.sinkhorn as sinkhorn
    from text2pos_torch.utils.float64 import float64_pins

    kernels = lstm._lstm_kernel, sinkhorn._lot_kernel
    lstm._lstm_kernel = lstm.lstm_final_hidden_plain
    sinkhorn._lot_kernel = sinkhorn.log_optimal_transport_plain
    try:
        with float64_pins(), decisions.replay():
            return run(True)
    finally:
        lstm._lstm_kernel, sinkhorn._lot_kernel = kernels


def gate_float64(label, run, failures):
    """The f32 step ``run(False)`` against its float64 replay, at phase 7's
    limits; each choice the float64 step would have made otherwise a
    near-tie within NEAR_TIE_TOL."""
    from text2pos_torch.utils.float64 import Decisions

    decisions = Decisions()
    with decisions.record():
        got = run(False)
    t0 = time.time()
    ref = replay_float64(run, decisions)
    near = decisions.margin <= NEAR_TIE_TOL
    log(f"  {label}: float64 replay in {time.time() - t0:.1f} s on "
        f"{len(decisions.log)} recorded choices; {decisions.flips} would "
        f"have gone the other way, each within {decisions.margin:.2e} of a "
        f"tie (tolerance {NEAR_TIE_TOL:g}) {'ok' if near else 'FAIL'}")
    if not near:
        failures.append(f"{label}: a choice {decisions.margin} from a tie")
    c = compare_steps(summary(got), summary(ref))
    gate_step("recipe", label + ", f32 vs float64", c, failures)
    return dict(c, flips=decisions.flips, flip_margin=decisions.margin)


@contextlib.contextmanager
def dev_float64(trainer, on):
    """The fused trainer's device-resident floats in float64 while on."""
    if not on:
        yield
        return
    saved = trainer.dev
    trainer.dev = {k: v.double() if v.is_floating_point() else v
                   for k, v in saved.items()}
    try:
        yield
    finally:
        trainer.dev = saved


def busy_profile(fn):
    """``fn()`` under torch.profiler, the device's activity only (kernels,
    copies and the CUDA runtime calls; the trace is read from the raw
    events, which keeps a trace of 100,000 launches quick to read):
    {wall_ms (the device's span from an event before to one after),
    busy_ms, h2d (host-to-device copies), syncs (stream, event or device
    synchronizations and blocking copies between the first and the last
    launch), launches, read_s}, or None when the profiler recorded no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        a.record()
        fn()
        b.record()
    b.synchronize()
    t1 = time.perf_counter()
    events = [(e.name(), "CUDA" in str(e.device_type()), e.start_ns(),
               e.duration_ns()) for e in prof.profiler.kineto_results.events()]
    kernels = [d for n, dev, _, d in events if dev and "Memcpy" not in n
               and "Memset" not in n]
    if not kernels:
        return None
    launches = [t for n, dev, t, _ in events if not dev
                and "LaunchKernel" in n]
    syncs = [n for n, dev, t, _ in events if not dev and n in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize", "cudaMemcpy") and launches
        and min(launches) <= t <= max(launches)]
    return {"wall_ms": a.elapsed_time(b), "busy_ms": sum(kernels) / 1e6,
            "h2d": sum(dev and "Memcpy" in n and "HtoD" in n
                       for n, dev, _, _ in events),
            "syncs": len(syncs) if launches else None,
            "sync_names": dict(collections.Counter(syncs)),
            "launches": len(kernels), "read_s": time.perf_counter() - t1}


def no_host_work(label, steps, failures):
    """``steps()`` (a segment of fused steps) profiled: no synchronization
    and no host-to-device copy between the steps. Returns the profile."""
    prof = busy_profile(steps)
    ok = prof is not None and prof["h2d"] == 0 and prof["syncs"] == 0
    if prof is None:
        log(f"  {label}: no device time in the profile (not measured) FAIL")
    else:
        log(f"  {label} (torch.profiler): wall {prof['wall_ms']:.2f} ms, "
            f"device busy {prof['busy_ms']:.2f} ms "
            f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%), "
            f"{prof['launches']} launches, host-to-device copies "
            f"{prof['h2d']}, synchronizations {prof['syncs']} "
            f"{prof['sync_names']}; the trace read in {prof['read_s']:.1f} "
            f"s; no host work between the steps {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{label}: host work between steps ({prof})")
    return prof


def fresh_state(trainer, weights, remat=False):
    """A state of ``trainer``'s model with ``weights`` loaded, on the card,
    no gradients, ``remat`` set."""
    from text2pos_torch.train.state import TrainState

    model = trainer.model.to(trainer.device)
    model.load_state_dict(weights)
    model.remat = remat
    for p in model.parameters():
        p.grad = None
    return TrainState(model)


def host_segment(label, trainer, weights, make_batches, n):
    """The host-loader path, for comparison with a fused segment: the
    loader's host work timed on its own (``make_batches()`` builds ``n``
    batches), then ``train_step`` on those batches profiled. Returns the
    profile with ``loader_ms``, the loader's ms a batch."""
    from text2pos_torch.train.coarse import step_generator
    from text2pos_torch.train.state import make_optimizer

    t = time.perf_counter()
    batches = make_batches()
    loader_ms = 1e3 * (time.perf_counter() - t) / n
    state = fresh_state(trainer, weights)
    state.optimizer = make_optimizer(state.model, 1e-4)
    gen = step_generator(trainer.device, 14)
    prof = busy_profile(lambda: [trainer.train_step(state, b, gen)
                                 for b in batches])
    log(f"  {label}: the loader builds a batch in {loader_ms:.2f} ms on the "
        "host (timed alone)")
    if prof is None:
        log(f"  {label}: no device time in the profile (not measured)")
        return {"loader_ms": loader_ms}
    log(f"  {label} (torch.profiler): wall {prof['wall_ms']:.2f} ms, "
        f"device busy {prof['busy_ms']:.2f} ms "
        f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%), "
        f"{prof['launches']} launches, host-to-device copies "
        f"{prof['h2d']}, synchronizations {prof['syncs']}; the trace "
        f"read in {prof['read_s']:.1f} s; with the loader, "
        f"{prof['wall_ms'] / n + loader_ms:.2f} ms a step")
    return dict(prof, loader_ms=loader_ms)


def gate_launches(label, launches, failures, units=1):
    want = {k: units * n for k, n in PREDICTED[label].items()}
    got = {k: launches.get(k, 0) for k in want}
    ok = got == want
    log(f"  launches of one {label}: {dict(launches)}; predicted {want} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{label}: launches {got}, predicted {want}")


def timed_steps(fn, n):
    """(median synchronized ms of ``fn(i)`` over i < n, results)."""
    times, out = [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.append(fn(i))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times[1:] or times), out


def pretrain_stage(train, val, gpu, scratch, by_path, errs, failures):
    """PointNet++ pretraining from the committed checkpoint: steps, the
    checkpoint written and read back, the validation on JAX's draws."""
    from text2pos_torch.config import TrainConfig
    from text2pos_torch.models.pointnet2 import PointNet2
    from text2pos_torch.ops import _build
    from text2pos_torch.train.coarse import step_generator
    from text2pos_torch.train.pointnet2 import (ObjectsDataset,
                                                PointNet2Trainer)
    from text2pos_torch.train.state import (load_checkpoint, load_variables,
                                            save_checkpoint)

    fx = dict(np.load(RECIPE_FIXTURE))
    cfg = TrainConfig(**PRETRAIN, device="cuda")
    ds = ObjectsDataset(train[0], 256, seed=0)
    trainer = PointNet2Trainer(cfg)
    state = trainer.init_state(len(ds) // 64)
    load_variables(state.model, load_checkpoint(CKPT_POINTNET))
    batches = list(itertools.islice(ds.epoch(64, 1), PRETRAIN_STEPS))
    kept = {}
    with kept_inputs(kept):
        _build.LAUNCHES.clear()
        ms, out = timed_steps(lambda i: trainer.train_step(
            state, batches[i], step_generator(trainer.device, 9, 0, 1, i)),
            len(batches))
        by_path["recipe_pretrain"] = dict(_build.LAUNCHES)
    losses = [float(l) for l, _ in out]
    finite = all(math.isfinite(x) for x in losses)
    log(f"  pretraining: {len(ds)} objects; {len(batches)} steps at batch "
        f"64 from bench_pointnet: losses {losses[0]:.4f} -> {losses[-1]:.4f}"
        f", all finite {finite}; {ms:.2f} ms a step (median) on {gpu}; "
        f"launches {by_path['recipe_pretrain']}")
    if not finite:
        failures.append(f"pretraining: a loss is not finite: {losses}")
    path = os.path.join(scratch, "pointnet_acc0.00.msgpack")
    save_checkpoint(path, state, extra={"val_acc": 0.0})
    back = PointNet2(heads=(state.model.class_classifier.out_features,
                            state.model.color_classifier.out_features))
    load_variables(back, load_checkpoint(path))
    same = all(torch.equal(a.cpu(), b) for a, b in zip(
        state.model.state_dict().values(), back.state_dict().values()))
    log(f"  pretraining checkpoint written ({os.path.getsize(path)} bytes) "
        f"and read back equal: {same} {'ok' if same else 'FAIL'}")
    if not same:
        failures.append("pretraining: the checkpoint reads back different")
    # Validation of the committed weights on JAX's draws.
    vds = ObjectsDataset(val[0], 256, seed=0)
    vstate = trainer.init_state(1)
    load_variables(vstate.model, load_checkpoint(CKPT_POINTNET))
    idx = fx["pretrain_val_idx"].astype(np.int64)
    kept_eval = {}
    with kept_inputs(kept_eval):
        def evaluate():
            return [trainer.predictions(vstate, b, draws={
                "idx": idx[i * 64:(i + 1) * 64]})
                for i, b in enumerate(vds.epoch(64, 0, shuffle=False))]
        preds, t_eval, by_path["recipe_pretrain_eval"] = timed(evaluate)
    preds = torch.cat(preds).cpu().numpy()
    labels = vds.classes[:len(preds)]
    acc = float(np.mean(preds == labels))
    diff = int((preds != fx["pretrain_val_pred"]).sum())
    ok = abs(acc - float(fx["pretrain_val_acc"])) * len(preds) <= 1 + 1e-9
    log(f"  pretraining validation of bench_pointnet on JAX's draws: "
        f"{len(preds)} objects in {len(preds) // 64} batches, {t_eval:.3f} s"
        f"; accuracy {acc:.6f} vs JAX {float(fx['pretrain_val_acc']):.6f}; "
        f"{diff} predictions differ (gate: within one object) "
        f"{'ok' if ok else 'FAIL'}; launches "
        f"{by_path['recipe_pretrain_eval']}")
    if not ok:
        failures.append(f"pretraining validation {acc} vs JAX "
                        f"{fx['pretrain_val_acc']}")
    if by_path["recipe_pretrain_eval"].get("pointconv", 0) < 1:
        failures.append("the pretraining's evaluation launched no PointConv "
                        "kernel")
    for path_name, store in (("recipe_pretrain", kept),
                             ("recipe_pretrain_eval", kept_eval)):
        for k, e in kept_checks(path_name, store, failures).items():
            errs[k][path_name] = e
    return path, {"ms_per_step": ms, "losses": losses, "val_acc": acc,
                  "val_differ": diff, "eval_s": t_eval}


def coarse_stage(train, vocab, pointnet_path, gpu, by_path, errs, failures):
    """The fused coarse trainer with the bank: its gates, then two epochs."""
    from text2pos_torch.config import TrainConfig
    from text2pos_torch.data.loaders import CoarseLoader
    from text2pos_torch.ops import _build
    from text2pos_torch.ops.transforms import sample_indices
    from text2pos_torch.train.coarse import CoarseTrainer, step_generator
    from text2pos_torch.train.fused_coarse import (FusedCoarseTrainer,
                                                   epoch_plan)

    recipe = dict(TRAIN_RECIPE["coarse"], device="cuda",
                  pointnet_path=pointnet_path)
    t0 = time.time()
    tr = FusedCoarseTrainer(TrainConfig(**recipe, **BANK, fused=True),
                            vocab, *train)
    cfg = tr.cfg
    B, O, P = cfg.batch_size, cfg.coarse_max_objects, cfg.pointnet_numpoints
    state = tr.init_state(tr.num_poses // B)
    weights = {k: v.clone() for k, v in state.model.state_dict().items()}
    host = CoarseTrainer(TrainConfig(**recipe), vocab)
    loader = CoarseLoader(*train, vocab, B, O, P, cfg.max_text_len, seed=0)
    log(f"  fused coarse trainer (bank, hint tokens, swap tables on the "
        f"card) and the host loader built in {time.time() - t0:.1f} s")
    rep = {}

    def fresh(trainer, remat=False):
        return fresh_state(trainer, weights, remat)

    g = step_generator(tr.device, 12)
    pose_idx = torch.arange(B, device=tr.device)
    counts = tr.dev["point_count"][tr.dev["pose_cell_idx"][pose_idx]]
    draws = tr.draw(B, counts, g)
    F = tr.num_objects(np.arange(B))
    a = tr.assemble(pose_idx, F, draws)
    hb = loader.batch_with(np.arange(B), draws["perm"].cpu().numpy(),
                           draws["flips"].cpu().numpy())
    valid = hb["flat_valid"]
    same = (np.array_equal(a["tokens"].cpu().numpy(), hb["tokens"])
            and np.array_equal(a["lengths"].cpu().numpy(), hb["lengths"])
            and all(np.array_equal(a[k].cpu().numpy(), hb[k][valid])
                    for k in ("points_xyz", "centers", "cell_idx",
                              "slot_idx")))
    log(f"  fused assembly of {B} poses ({F} objects, "
        f"{int(draws['flips'].sum())} flips) equals CoarseLoader's batch "
        f"for the same flips and hint order (tokens, lengths, flipped "
        f"points and centres, slots): {same} {'ok' if same else 'FAIL'}")
    if not same:
        failures.append("fused coarse assembly differs from CoarseLoader's")
    hdraws = {"idx": a["idx"].cpu().numpy(), "angles": a["angles"].cpu()
              .numpy()}

    def host_step():
        st = fresh(host)
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = host.forward_backward(st, hb, draws=hdraws)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        return (float(loss),) + grads_stats(st.model) + (ms,)

    def fused_step(weight, remat=False, idx=pose_idx, d=None, n=F):
        tr.neg_weight = weight
        st = fresh(tr, remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        loss = tr.fused_forward_loss(st, idx, n, draws=d or draws)
        loss.backward()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated() - base
        return (float(loss.detach()),) + grads_stats(st.model) + (ms, peak)

    hs = [host_step() for _ in range(HOST_RUNS)]
    h1, h2 = hs[:2]
    fz = fused_step(0.0)
    rep["fused_vs_host"] = gate_spread(
        f"fused coarse step (bank weight 0) vs CoarseTrainer's step, {B} "
        "cells, the same draws", fz, h1, hs, failures)
    log(f"  forward+backward ms, one call each: host {h1[3]:.2f}, "
        f"{h2[3]:.2f}; fused {fz[3]:.2f} (the loader's host work not "
        f"included in the host's)")
    nobank = FusedCoarseTrainer(TrainConfig(**recipe, fused=True), vocab,
                                *train)
    st = fresh(nobank)
    l0 = float(nobank.fused_forward_loss(st, pose_idx, F,
                                         draws=draws).detach())
    rep["inactive_bank_equal"] = eq = l0 == fz[0]
    log(f"  bank inactive (weight 0) vs no bank: loss {fz[0]!r} vs {l0!r} "
        f"{'equal ok' if eq else 'FAIL'}")
    if not eq:
        failures.append("the inactive bank moves the fused coarse loss")
    del nobank

    # The bank: refresh against encode_all_cells on the same draws.
    rstate = fresh(tr)
    _build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t = time.perf_counter()
    tr.refresh_neg_bank(rstate)
    torch.cuda.synchronize()
    rep["refresh_ms"] = 1e3 * (time.perf_counter() - t)
    by_path["recipe_refresh"] = dict(_build.LAUNCHES)
    chunks = tr.refresh_chunks()
    gate_launches("refresh", _build.LAUNCHES, failures, len(chunks))
    u = torch.rand((B, O, P), generator=step_generator(tr.device, 8),
                   device=tr.device)
    bank = tr.bank
    cdraws = []
    for c in chunks:
        idx = sample_indices(torch.from_numpy(bank.point_count[c]).to(
            tr.device), P, P, u=u).cpu().numpy()
        cdraws.append(idx[bank.mask[c]])
    direct = host.encode_all_cells(rstate, bank, cdraws)
    rerr = float(np.abs(tr.dev["neg_bank"].cpu().numpy() - direct).max())
    ok = rerr <= BANK_TOL
    log(f"  refresh_neg_bank ({len(chunks)} chunks of {B} cells, eval mode) "
        f"in {rep['refresh_ms']:.2f} ms: rows vs encode_all_cells on the "
        f"same draws max |diff| {rerr:.2e} (tolerance {BANK_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"refresh_neg_bank differs from encode_all_cells by "
                        f"{rerr}")
    rep["refresh_err"] = rerr
    # The bank loss against float64.
    with torch.no_grad():
        text = torch.nn.functional.normalize(torch.randn(
            B, cfg.embed_dim, device=tr.device, generator=g), dim=-1)
        cells = torch.nn.functional.normalize(torch.randn(
            B, cfg.embed_dim, device=tr.device, generator=g), dim=-1)
        cell_idx = tr.dev["pose_cell_idx"][pose_idx]
        got = float(tr._neg_bank_loss(pose_idx, cell_idx, text, cells))
        with dev_float64(tr, True):
            want = float(tr._neg_bank_loss(pose_idx, cell_idx,
                                           text.double(), cells.double()))
    berr = abs(got - want) / abs(want)
    ok = berr <= BANK_TOL
    log(f"  bank loss {got:.7f} vs float64 {want:.7f} (rel {berr:.2e}, "
        f"tolerance {BANK_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"bank loss {got} vs float64 {want}")
    rep["bank_loss_rel_err"] = berr

    # Remat against no remat, with the bank active.
    p1, p2 = fused_step(1.0), fused_step(1.0)
    rm = fused_step(1.0, remat=True)
    rep["remat"] = gate_spread("remat vs no remat (BN statistics moved once "
                               "if equal), fused coarse step with "
                               f"the bank, {B} cells", rm, p1, (p1, p2),
                               failures)
    rep["remat"].update(ms=rm[3], peak_gb=rm[4] / 2 ** 30, plain_ms=p1[3],
                        plain_peak_gb=p1[4] / 2 ** 30)
    ok = rm[4] < p1[4]
    log(f"  remat, coarse: peak {rm[4] / 2 ** 30:.2f} GiB vs "
        f"{p1[4] / 2 ** 30:.2f} GiB without ({100 * rm[4] / max(p1[4], 1):.1f}%), "
        f"forward+backward {rm[3]:.2f} ms vs {p1[3]:.2f} ms; lower peak "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("remat does not lower the coarse step's peak")

    # Float64 replay of the fused step with the bank at 32 cells.
    idx32 = pose_idx[:F64_CELLS]
    d32 = {"flips": draws["flips"][:F64_CELLS],
           "perm": draws["perm"][:F64_CELLS],
           "idx": draws["idx"][:F64_CELLS],
           "angles": draws["angles"][:F64_CELLS]}
    F32 = tr.num_objects(np.arange(F64_CELLS))

    def f64_run(f64):
        tr.neg_weight = 1.0
        st = fresh(tr)
        if f64:
            st.model.double()
        with dev_float64(tr, f64):
            loss = tr.fused_forward_loss(st, idx32, F32, draws=d32)
            loss.backward()
        return (float(loss),) + grads_stats(st.model)

    rep["float64"] = gate_float64(
        f"fused coarse step with the bank, {F64_CELLS} cells", f64_run,
        failures)
    tr.model.remat = False
    tr.model.double().float()
    state.model.load_state_dict(weights)

    # Launches of one step; one segment with no host work; two epochs.
    tr.neg_weight = 1.0
    _build.LAUNCHES.clear()
    tr.fused_train_step(state, pose_idx, F, g)
    gate_launches("fused coarse step", _build.LAUNCHES, failures)
    n = int(FUSED_SEG)
    seg = torch.arange(n * B, device=tr.device).view(n, B)
    nobj = [tr.num_objects(np.arange(i * B, (i + 1) * B)) for i in range(n)]
    rep["segment_profile"] = no_host_work(
        f"fused coarse segment ({n} steps)", lambda: [
            tr.fused_train_step(state, seg[i], nobj[i], g)
            for i in range(n)], failures)
    hosted = CoarseLoader(*train, vocab, B, O, P, cfg.max_text_len,
                          shuffle_hints=True, flip_poses=True, seed=0)
    rep["host_profile"] = host_segment(
        f"host-loader coarse steps ({n}, CoarseTrainer.train_step)", host,
        weights,
        lambda: list(itertools.islice(hosted.epoch(seed=1), n)), n)
    saved = os.environ.get("T2P_FUSED_SEG")
    os.environ["T2P_FUSED_SEG"] = FUSED_SEG
    refresh, refresh_ms = tr.refresh_neg_bank, []

    def timed_refresh(st):
        torch.cuda.synchronize()
        t = time.perf_counter()
        refresh(st)
        torch.cuda.synchronize()
        refresh_ms.append(1e3 * (time.perf_counter() - t))
    tr.refresh_neg_bank = timed_refresh
    want = sum(1 + len(epoch_plan(tr.num_poses, B, cfg.seed, e,
                                  cfg.neg_bank_refresh)[2])
               for e in range(1, COARSE_EPOCHS + 1))
    kept = {}
    try:
        with kept_inputs(kept):
            _build.LAUNCHES.clear()
            walls, losses = [], []
            for epoch in range(1, COARSE_EPOCHS + 1):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, loss = tr.fused_train_epoch(state, epoch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
                losses.append(loss)
            by_path["recipe_fused_coarse"] = dict(_build.LAUNCHES)
    finally:
        tr.refresh_neg_bank = refresh
        if saved is None:
            os.environ.pop("T2P_FUSED_SEG")
        else:
            os.environ["T2P_FUSED_SEG"] = saved
    steps = COARSE_EPOCHS * (tr.num_poses // B)
    ms = 1e3 * (sum(walls) - sum(refresh_ms) / 1e3) / steps
    finite = all(math.isfinite(x) for x in losses)
    log(f"  fused coarse: {COARSE_EPOCHS} epochs of {steps // COARSE_EPOCHS}"
        f" steps in segments of {FUSED_SEG}, {len(refresh_ms)} bank "
        f"refreshes ({statistics.median(refresh_ms):.2f} ms median); epoch "
        f"losses {[round(x, 5) for x in losses]}, finite {finite}; "
        f"{ms:.2f} ms a step (epochs' wall less the refreshes) on {gpu}; "
        f"launches {by_path['recipe_fused_coarse']}")
    if not finite:
        failures.append(f"fused coarse: a loss is not finite: {losses}")
    if len(refresh_ms) != want:
        failures.append(f"fused coarse: {len(refresh_ms)} refreshes, not "
                        f"{want}")
    for k, e in kept_checks("recipe_fused_coarse", kept, failures).items():
        errs[k]["recipe_fused_coarse"] = e
    rep.update(ms_per_step=ms, epoch_losses=losses, refreshes_ms=refresh_ms)
    return rep


def fine_stage(train, vocab, pointnet_path, gpu, by_path, errs, failures):
    """The fused fine trainer with the rank-aware loss: its gates, then one
    epoch."""
    from text2pos_torch.config import TrainConfig
    from text2pos_torch.ops import _build
    from text2pos_torch.train.coarse import step_generator
    from text2pos_torch.train.fine import FineTrainer
    from text2pos_torch.data.loaders import FineLoader
    from text2pos_torch.ops.transforms import sample_indices
    from text2pos_torch.train.fused_fine import FusedFineTrainer

    recipe = dict(TRAIN_RECIPE["fine"], **RANK, device="cuda",
                  pointnet_path=pointnet_path)
    t0 = time.time()
    tr = FusedFineTrainer(TrainConfig(**recipe, fused=True), vocab, *train)
    B, P = tr.cfg.batch_size, tr.cfg.pointnet_numpoints
    state = tr.init_state(tr.num_poses // B)
    weights = {k: v.clone() for k, v in state.model.state_dict().items()}
    host = FineTrainer(TrainConfig(**recipe), vocab)
    log(f"  fused fine trainer ({tr.num_poses} samples on the card) built "
        f"in {time.time() - t0:.1f} s")
    rep = {}

    def fresh(trainer, remat=False):
        return fresh_state(trainer, weights, remat)

    g = step_generator(tr.device, 13)
    pose_idx = torch.arange(B, device=tr.device)
    counts = tr.dev["point_count"][pose_idx]
    draws = {"idx": sample_indices(counts, P, tr.dev["points_xyz"].shape[2],
                                   g),
             "angles": torch.rand(counts.shape, generator=g,
                                  device=tr.device) * 240.0 - 120.0}
    hbatch = {k: v.cpu().numpy() for k, v in tr.batch(pose_idx).items()}
    hdraws = {k: v.cpu().numpy() for k, v in draws.items()}

    def step(trainer, batch, d, remat=False):
        st = fresh(trainer, remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        loss = trainer.forward_backward(st, batch, draws=d)[0]
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated() - base
        return (float(loss.detach()),) + grads_stats(st.model) + (ms, peak)

    hs = [step(host, hbatch, hdraws) for _ in range(HOST_RUNS)]
    h1, h2 = hs[:2]
    fz = step(tr, tr.batch(pose_idx), draws)
    rep["fused_vs_host"] = gate_spread(
        f"fused fine step vs FineTrainer's step (rank-aware, R = "
        f"{tr.rank_negatives}), {B} poses, the same samples and draws", fz,
        h1, hs, failures)
    log(f"  forward+backward ms, one call each: host {h1[3]:.2f}, "
        f"{h2[3]:.2f}; fused {fz[3]:.2f}")
    rm = step(tr, tr.batch(pose_idx), draws, remat=True)
    rep["remat"] = gate_spread(f"remat vs no remat, fused fine step, {B} "
                               "poses (the host step's spread)", rm, fz,
                               hs, failures)
    rep["remat"].update(ms=rm[3], peak_gb=rm[4] / 2 ** 30, plain_ms=fz[3],
                        plain_peak_gb=fz[4] / 2 ** 30)
    ok = rm[4] < fz[4]
    log(f"  remat, fine: peak {rm[4] / 2 ** 30:.2f} GiB vs "
        f"{fz[4] / 2 ** 30:.2f} GiB without ({100 * rm[4] / max(fz[4], 1):.1f}%), "
        f"forward+backward {rm[3]:.2f} ms vs {fz[3]:.2f} ms; lower peak "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("remat does not lower the fine step's peak")

    def f64_run(f64):
        st = fresh(tr)
        if f64:
            st.model.double()
        with dev_float64(tr, f64):
            d = {k: v.double() if f64 and v.is_floating_point() else v
                 for k, v in draws.items()}
            loss = tr.forward_backward(st, tr.batch(pose_idx), draws=d)[0]
        return (float(loss),) + grads_stats(st.model)

    rep["float64"] = gate_float64(
        f"rank-aware fine step, {B} poses, R = {tr.rank_negatives}",
        f64_run, failures)
    tr.model.remat = False
    tr.model.double().float()
    state.model.load_state_dict(weights)

    _build.LAUNCHES.clear()
    tr.fused_train_step(state, pose_idx, g)
    gate_launches("rank step", _build.LAUNCHES, failures)
    n = int(FUSED_SEG)
    seg = torch.randperm(tr.num_poses, generator=torch.Generator()
                         .manual_seed(0))[:n * B].view(n, B).to(tr.device)
    rep["segment_profile"] = no_host_work(
        f"fused fine segment ({n} rank steps)", lambda: [
            tr.fused_train_step(state, seg[i], g) for i in range(n)],
        failures)
    floader = FineLoader(*train, vocab, B, tr.cfg.pad_size,
                         tr.cfg.num_mentioned, P, tr.cfg.max_hint_len, seed=0)
    rep["host_profile"] = host_segment(
        f"host-loader rank-aware fine steps ({n}, FineTrainer.train_step)",
        host, weights,
        lambda: list(itertools.islice(floader.epoch(seed=1), n)), n)
    saved = os.environ.get("T2P_FUSED_SEG")
    os.environ["T2P_FUSED_SEG"] = FUSED_SEG
    kept = {}
    try:
        with kept_inputs(kept):
            _build.LAUNCHES.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, loss = tr.fused_train_epoch(state, 0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            by_path["recipe_fused_fine"] = dict(_build.LAUNCHES)
    finally:
        if saved is None:
            os.environ.pop("T2P_FUSED_SEG")
        else:
            os.environ["T2P_FUSED_SEG"] = saved
    steps = tr.num_poses // B
    ok = math.isfinite(loss)
    log(f"  fused fine, rank-aware: one epoch of {steps} steps in segments "
        f"of {FUSED_SEG}: loss {loss:.5f}, finite {ok}; "
        f"{1e3 * wall / steps:.2f} ms a step on {gpu}; launches "
        f"{by_path['recipe_fused_fine']}")
    if not ok:
        failures.append(f"fused fine: loss {loss}")
    for k, e in kept_checks("recipe_fused_fine", kept, failures).items():
        errs[k]["recipe_fused_fine"] = e
    rep.update(ms_per_step=1e3 * wall / steps, epoch_loss=loss)
    return rep


def offsets_stage(train, val, vocab, gpu, by_path, errs, failures):
    from text2pos_torch.config import TrainConfig
    from text2pos_torch.data.loaders import FineLoader
    from text2pos_torch.ops import _build
    from text2pos_torch.train.offsets import OffsetsTrainer

    cfg = TrainConfig(batch_size=32, regressor_dim=128, pad_size=16,
                      num_mentioned=6, pointnet_numpoints=256,
                      device="cuda")
    tr = OffsetsTrainer(cfg, vocab)
    loader = FineLoader(*train, vocab, 32, 16, 6, 256, 16)
    state = tr.init_state(loader.num_batches(True))
    batches = list(itertools.islice(loader.epoch(seed=0), OFFSETS_STEPS))
    kept = {}
    vloader = FineLoader(*val, vocab, 32, 16, 6, 256, 16)
    with kept_inputs(kept):
        _build.LAUNCHES.clear()
        ms, losses = timed_steps(lambda i: tr.train_step(state, batches[i]),
                                 len(batches))
        launches = collections.Counter(_build.LAUNCHES)
        losses = [float(x) for x in losses]
        val_out, t_val, vl = timed(lambda: [
            tr.eval_step(state, b) for b in vloader.epoch(seed=0,
                                                          shuffle=False)])
        by_path["recipe_offsets"] = dict(launches + collections.Counter(vl))
    mse = float(np.mean([float(m) for m, _ in val_out]))
    err = float(np.mean([float(e) for _, e in val_out]))
    ok = all(math.isfinite(x) for x in losses + [mse])
    log(f"  offsets: {len(batches)} steps at batch 32, losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; {ms:.2f} ms a step on {gpu};"
        f" validation ({len(val_out)} batches, {t_val:.3f} s): mse {mse:.4f}"
        f", intersection error {err:.4f}; finite {ok}; launches "
        f"{by_path['recipe_offsets']}")
    if not ok:
        failures.append(f"offsets: a loss is not finite: {losses}, {mse}")
    for k, e in kept_checks("recipe_offsets", kept, failures).items():
        errs[k]["recipe_offsets"] = e
    return {"ms_per_step": ms, "losses": losses, "val_mse": mse,
            "val_err": err}


def epoch_losses(stdout):
    """The per-epoch losses a training CLI printed ("epoch N loss X ...")."""
    return [float(line.split(" loss ")[1].split()[0])
            for line in stdout.splitlines()
            if line.startswith("epoch ") and " loss " in line]


def recipe_cli_checks(pointnet_path, scratch, failures):
    """The recipe's four CLIs as subprocesses on the card, all at once, each
    in its own directory (its ./checkpoints): PointNet++ pretraining
    (CLI_PRETRAIN_EPOCHS epochs from scratch: one best checkpoint left,
    named by the best validation accuracy, each earlier best removed), the
    fused coarse trainer with the bank and remat and the fused rank-aware
    fine trainer with remat (both from ``pointnet_path``), and the offsets
    trainer; each on the SYNTHETIC dataset at the recipe's widths."""
    env = dict(os.environ, PYTHONPATH=ROOT, T2P_FUSED_SEG="1",
               T2P_FUSED_VERBOSE="1")
    stage = lambda k: [f"--{a}={v}" for a, v in TRAIN_RECIPE[k].items()]
    runs = {
        "pointnet2": ["--dataset", "SYNTHETIC", "--epochs",
                      str(CLI_PRETRAIN_EPOCHS), "--batch_size", "64",
                      "--pointnet_numpoints", "256", "--learning_rate",
                      "1e-3"],
        "coarse": ["--dataset", "SYNTHETIC", "--fused", "--neg_bank",
                   "--neg_bank_warmup", "0", "--neg_bank_refresh", "2",
                   "--remat", "--epochs", "2", "--pointnet_path",
                   pointnet_path, *stage("coarse")],
        "fine": ["--dataset", "SYNTHETIC", "--fused", "--rank_weight", "1",
                 "--rank_negatives", "4", "--remat", "--epochs", "1",
                 "--pointnet_path", pointnet_path, *stage("fine")],
        "offsets": ["--dataset", "SYNTHETIC", "--epochs", "1",
                    "--batch_size", "32", "--regressor_dim", "128"],
    }
    t0 = time.time()
    procs = {}
    for mod, args in runs.items():
        cwd = os.path.join(scratch, f"cli_{mod}")
        os.makedirs(cwd)
        procs[mod] = (cwd, subprocess.Popen(
            [sys.executable, "-m", f"text2pos_torch.train.{mod}", *args],
            cwd=cwd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = {}
    for mod, (cwd, p) in procs.items():
        try:
            out, err = p.communicate(timeout=max(1.0, 300 - (time.time()
                                                             - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        outs[mod] = (cwd, p.returncode, out, err)
    wall = time.time() - t0
    for mod, (cwd, rc, out, err) in outs.items():
        losses = epoch_losses(out)
        kept = sorted(f for f in os.listdir(os.path.join(cwd, "checkpoints"))
                      ) if os.path.isdir(os.path.join(cwd, "checkpoints")) \
            else []
        ok = rc == 0 and bool(losses) and all(map(math.isfinite, losses))
        note = ""
        if mod == "pointnet2":
            accs = [float(line.split("val-acc ")[1]) for line in
                    out.splitlines() if "val-acc " in line]
            bests = {f"pointnet_acc{a:0.2f}.msgpack" for i, a in
                     enumerate(accs) if a > max(accs[:i], default=-1.0)}
            want = [f"pointnet_acc{max(accs):0.2f}.msgpack"] if accs else []
            said = out.split("best checkpoint:")[-1].strip()
            ok = ok and bool(want) and kept == want \
                and os.path.basename(said) == want[0] and len(bests) >= 2
            note = (f"; val-acc {accs}: {len(bests)} bests written, "
                    f"left {kept} (want {want}, the earlier "
                    f"{len(bests) - 1} removed)")
        elif mod in ("coarse", "fine"):
            ok = ok and len(kept) == 1 and kept[0].startswith(f"{mod}_acc") \
                and "best checkpoint:" in out and "seg 1 " in out
            note = f"; checkpoint {kept}"
        shown = " ".join(a for a in runs[mod] if "=" not in a
                         and a != pointnet_path)
        log(f"  CLI python -m text2pos_torch.train.{mod} {shown} (the "
            f"recipe's widths): exit {rc}; epoch losses {losses}{note} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"training CLI {mod}: exit {rc}; {note}; "
                            f"{out[-1500:]} {err[-2000:]}")
    log(f"  the four CLIs, run at once, took {wall:.1f} s")
    return wall


def recipe_phase(gpu, failures):
    """Phase 9. Returns ({path: launches}, {kernel: {path: largest error
    on the path's inputs}}, report). Checkpoints go to a temporary
    directory in the checkout, removed at the end."""
    import tempfile

    if not os.path.isfile(RECIPE_FIXTURE):
        failures.append(f"missing {RECIPE_FIXTURE}")
        return {}, {}, {}
    train, val, vocab = train_data()
    by_path, errs = {}, collections.defaultdict(dict)
    scratch = tempfile.TemporaryDirectory(dir=ROOT, prefix=".train_smoke_")
    report = {}
    try:
        t0 = time.time()
        path, report["pretrain"] = pretrain_stage(train, val, gpu,
                                                  scratch.name, by_path,
                                                  errs, failures)
        log(f"  9.1 took {time.time() - t0:.1f} s")
        t0 = time.time()
        report["coarse"] = coarse_stage(train, vocab, path, gpu, by_path,
                                        errs, failures)
        log(f"  9.2 took {time.time() - t0:.1f} s")
        t0 = time.time()
        report["fine"] = fine_stage(train, vocab, path, gpu, by_path, errs,
                                    failures)
        log(f"  9.3-9.4 took {time.time() - t0:.1f} s")
        t0 = time.time()
        report["offsets"] = offsets_stage(train, val, vocab, gpu, by_path,
                                          errs, failures)
        log(f"  9.5 took {time.time() - t0:.1f} s")
        report["cli_s"] = recipe_cli_checks(path, scratch.name, failures)
    finally:
        scratch.cleanup()
    return by_path, dict(errs), report



# Phase 10: data parallelism (text2pos_torch/parallel/dp.py) on a mesh of
# max(2, min(4, cards)) shards: cards 0 … D-1, or card 0 D times on a machine
# with fewer (the shards then run one after another on its stream, so the
# times are no scaling figure). Each DP path against its single-device run
# on the card: query-sharded serving of the 2048 bench queries (headline,
# rerank@128, the cascade 128 → 24 without the int8 bank, which DP serving
# refuses as JAX does): f32 top_idx identical, bf16 top-10@15m equal; the
# DB-sharded ring at the same settings in f32: top_idx identical; the
# evaluator's dp_encode_all_cells on the bench map in f32 against
# encode_all_coarse's steps on the same resampling draws (DP_ENC_TOL, f32
# sums in other batch shapes); one DP step a stage at the recipe's
# per-device batch against the mean of its shards' single-device steps
# (phase 7's limits: the same computation, summed in another order).
DP_REPS = 3
DP_ENC_TOL = 1e-5
DP_ENC_BATCH = 32      # cells a shard a step: the evaluator's batch_size
DP_OPTS = ("rerank_k", "rerank_lambda", "rerank_gamma", "prune_m",
           "prune_layers", "prune_sinkhorn")
# The kernels each DP path must launch.
DP_PATH_KERNELS = {
    "dp_serve": ("lstm", "sinkhorn", "superglue_gnn"),
    "dp_ring": ("lstm", "sinkhorn", "superglue_gnn"),
    "dp_encode": ("fps", "pointconv"),
    "dp_train_coarse": ("lstm", "fps"),
    "dp_train_fine": ("lstm", "sinkhorn", "fps")}


def sync_mesh(mesh) -> None:
    for dev in set(mesh.devices):
        torch.cuda.synchronize(dev)


def mesh_timed(mesh, fn, reps=1, store=None):
    """(result of the last run, median synchronized wall ms over ``reps``
    runs, launches of the first run); with ``store`` the first run's
    kernel inputs are kept there."""
    from text2pos_torch.ops import _build

    times, launches = [], None
    for r in range(reps):
        with kept_inputs(store) if store is not None and r == 0 else \
                contextlib.nullcontext():
            sync_mesh(mesh)
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            out = fn()
            sync_mesh(mesh)
            times.append(1e3 * (time.perf_counter() - t0))
        launches = launches or dict(_build.LAUNCHES)
    return out, statistics.median(times), launches


def dp_serving_checks(mesh, pipes, fx, by_path, stores, report, failures):
    """10.1-10.2: query-sharded and ring serving against serve_batch."""
    from text2pos_torch.evaluation.metrics import served_accuracies
    from text2pos_torch.parallel import dp

    rk, lam, gam = fx["rerank"]
    modes = {"headline": (), "rerank": (int(rk), float(lam), float(gam)),
             "cascade": (int(rk), float(lam), float(gam), 24, 1, 6)}
    for label in ("bf16", "f32"):
        pipe = pipes[label]
        args = [torch.as_tensor(fx[k]).to(pipe.device)
                for k in ("tokens", "lengths", "hint_tokens", "hint_lengths")]
        C = pipe.cell_enc.shape[0]
        pad = (-C) % mesh.size
        z = lambda a: torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
        padded = pipe.with_database(z(pipe.cell_enc), z(pipe.fine_bank_enc),
                                    z(pipe.fine_bank_centers))
        for mode, opts in modes.items():
            kw = dict(zip(DP_OPTS, opts))
            dp_serve = dp.dp_serve_batch(pipe, mesh, TOP_K, **kw)
            serves = {"single": lambda: pipe.serve_batch(*args, TOP_K, **kw),
                      "dp": lambda: dp_serve(*args)}
            if label == "f32" or mode == "headline":
                ring = dp.dp_serve_batch_dbsharded(padded, mesh, TOP_K,
                                                   num_real_cells=C, **kw)
                serves["ring"] = lambda: ring(*args)
            outs, ms = {}, {}
            for name, fn in serves.items():
                headline = label == "bf16" and mode == "headline"
                path = {"dp": "dp_serve", "ring": "dp_ring"}.get(name)
                store = stores.setdefault(path, {}) if headline and path \
                    else None
                out, ms[name], launches = mesh_timed(mesh, fn, DP_REPS,
                                                     store)
                if store is not None:
                    by_path[path] = launches
                outs[name] = [o.cpu().numpy() for o in out]
            single = outs["single"]
            for name in [n for n in outs if n != "single"]:
                ti, po = outs[name][0], outs[name][2].astype("float32")
                same = float((ti == single[0]).all(1).mean())
                a = served_accuracies(fx, ti.astype("int64"), po,
                                      (1, 5, TOP_K))[TOP_K][15]
                b = served_accuracies(fx, single[0].astype("int64"),
                                      single[2].astype("float32"),
                                      (1, 5, TOP_K))[TOP_K][15]
                ok = bool(np.isfinite(po).all()) and ti.shape == \
                    single[0].shape and (same == 1.0 if label == "f32"
                                         else a == b)
                log(f"  10 {name} {label} {mode}: {ti.shape[0]} queries in "
                    f"{ms[name]:.2f} ms (single device {ms['single']:.2f} "
                    f"ms); rows with top_idx equal to the single device's "
                    f"{same:.4f}; top-10@15m {a:.4f} (single {b:.4f}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"DP {name} {label} {mode}: top_idx "
                                    f"rows equal {same}, top-10@15m {a} vs "
                                    f"{b}")
                report[f"{name}_{label}_{mode}_ms"] = ms[name]
            report[f"single_{label}_{mode}_ms"] = ms["single"]


def dp_encode_checks(mesh, pipe, bank, by_path, stores, report, failures):
    """10.3: dp_encode_all_cells against encode_all_coarse's steps
    (encode_coarse_cells, DB_CHUNK cells a step) on the same resampling
    draws, f32."""
    from text2pos_torch.config import TrainConfig
    from text2pos_torch.evaluation.pipeline import (DB_CHUNK, bank_tensors,
                                                    encode_coarse_cells)
    from text2pos_torch.ops.transforms import sample_indices
    from text2pos_torch.parallel import dp
    from text2pos_torch.train.coarse import CoarseTrainer
    from text2pos_torch.train.state import TrainState

    dev = pipe.device
    bt = bank_tensors(bank, dev)
    counts = bt["mask"].sum(1)
    first = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).tolist()
    cell, slot = bt["mask"].nonzero(as_tuple=True)
    P, stored = 256, bt["points_xyz"].shape[2]
    u = torch.rand(len(cell), P, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(10))
    idx = sample_indices(bt["point_count"][cell, slot], P, stored, u=u)
    rows = lambda cells: torch.cat([torch.arange(first[c], first[c + 1])
                                    for c in cells])
    C = bank.num_cells
    with torch.inference_mode():
        want, single_ms, _ = mesh_timed(mesh, lambda: torch.cat([
            encode_coarse_cells(pipe.coarse, bt, torch.arange(
                i, min(i + DB_CHUNK, C), device=dev),
                u=u[first[i]:first[min(i + DB_CHUNK, C)]])
            for i in range(0, C, DB_CHUNK)]))
    D, B = mesh.size, DP_ENC_BATCH
    draws = []
    for i in range(0, C, B * D):
        cells = list(range(i, min(i + B * D, C)))
        cells += [0] * (B * D - len(cells))
        draws.append([idx[rows(cells[d * B:(d + 1) * B])].cpu().numpy()
                      for d in range(D)])
    trainer = CoarseTrainer(TrainConfig(
        batch_size=B, embed_dim=pipe.coarse.embed_dim, pointnet_numpoints=P,
        coarse_max_objects=bank.mask.shape[1], device=dev.type), pipe.vocab,
        model=pipe.coarse)
    got, dp_ms, by_path["dp_encode"] = mesh_timed(
        mesh, lambda: dp.dp_encode_all_cells(
            trainer, TrainState(pipe.coarse), bank, mesh, draws),
        store=stores.setdefault("dp_encode", {}))
    err = float(np.abs(got - want.cpu().numpy()).max())
    ok = got.shape == tuple(want.shape) and err <= DP_ENC_TOL
    log(f"  10.3 dp_encode_all_cells, {C} cells in steps of {B} a shard, "
        f"f32: {dp_ms:.1f} ms = {C / dp_ms * 1e3:.0f} cells/s (single "
        f"device, {DB_CHUNK}-cell steps: {single_ms:.1f} ms); max abs error "
        f"against encode_all_coarse's steps on the same draws {err:.3e} "
        f"(tolerance {DP_ENC_TOL:g}); launches {by_path['dp_encode']} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"dp_encode_all_cells: error {err}")
    report.update(dp_encode_ms=dp_ms, single_encode_ms=single_ms,
                  dp_encode_err=err)


class KeptGradients:
    """A stand-in optimizer: keeps the gradients the step hands it."""

    def __init__(self, model):
        self.model, self.grads = model, None

    def step(self):
        self.grads = {n: torch.zeros_like(p) if p.grad is None
                      else p.grad.detach().clone()
                      for n, p in self.model.named_parameters()}

    def zero_grad(self, set_to_none=True):
        for p in self.model.parameters():
            p.grad = None


def host_draws(stage, batch, rng):
    """Sample indices and angles of a batch, drawn on the host, so that a
    shard on any card and its single-device reference take the same."""
    P = TRAIN_RECIPE[stage]["pointnet_numpoints"]
    count = batch["point_count"]
    if stage == "coarse":
        count = count[batch["flat_valid"].astype(bool)]
    stored = batch["points_xyz"].shape[-2]
    u = rng.random(count.shape + (P,), dtype=np.float32)
    idx = np.clip(np.floor(u * count[..., None]), 0, stored - 1)
    return {"idx": idx.astype(np.int64),
            "angles": rng.uniform(-120, 120, count.shape).astype(np.float32)}


def dp_train_checks(mesh, train, vocab, by_path, stores, report, failures):
    """10.4: one DP step a stage against the mean of its shards'
    single-device steps."""
    from text2pos_torch.parallel import dp
    from text2pos_torch.train.state import TrainState
    from text2pos_torch.utils.convert_jax import module_to_jax, params_to_jax

    D = mesh.size
    for stage in ("coarse", "fine"):
        B = TRAIN_RECIPE[stage]["batch_size"]
        loader = stage_loader(stage, train, vocab, B)
        batches = list(itertools.islice(loader.epoch(seed=1), D))
        rng = np.random.default_rng(5)
        draws = [host_draws(stage, b, rng) for b in batches]
        trainer = make_trainer(stage, vocab)
        model = trainer.init_state(1).model
        state = TrainState(model, KeptGradients(model))
        make = (dp.dp_coarse_train_step if stage == "coarse"
                else dp.dp_fine_train_step)
        step = make(trainer, mesh)
        stacked = dp.stack_microbatches(batches)
        loss, ms, by_path[f"dp_train_{stage}"] = mesh_timed(
            mesh, lambda: step(state, stacked, draws=draws),
            store=stores.setdefault(f"dp_train_{stage}", {}))
        grads = dict(flat_tree(params_to_jax(model, state.optimizer.grads)))
        stats = dict(flat_tree(module_to_jax(model)[1]))
        _, ms2, _ = mesh_timed(mesh, lambda: step(state, stacked,
                                                  draws=draws))
        refs, ref_ms = [], 0.0
        for d in range(D):
            rt = make_trainer(stage, vocab)
            rs = rt.init_state(1)
            _, t, _ = mesh_timed(mesh, lambda: rt.forward_backward(
                rs, batches[d], draws=draws[d]))
            # the step again, on a fresh model, for its gradients
            rt = make_trainer(stage, vocab)
            refs.append(step_grads(stage, rt, rt.init_state(1), batches[d],
                                   draws[d]))
            ref_ms += t
        mean = lambda xs: {k: sum(x[k] for x in xs) / D for k in xs[0]}
        ref = (float(np.mean([r[0] for r in refs])),
               mean([r[1] for r in refs]), mean([r[2] for r in refs]))
        c = compare_steps(summary((float(loss), grads, stats)), summary(ref))
        gate_step(stage, f"DP step of {D} shards x {B} vs the mean of the "
                  f"shards' single-device steps", c, failures)
        log(f"  10.4 DP {stage} step, {D} shards x {B}: {ms2:.1f} ms "
            f"(first {ms:.1f}, with the replicas' copies; the shards' "
            f"single-device forward and backward {ref_ms:.1f} ms "
            f"together); launches "
            f"{by_path[f'dp_train_{stage}']}")
        report.update({f"dp_{stage}_step_ms": ms2,
                       f"single_{stage}_steps_ms": ref_ms})


def dp_phase(gpu, pipe_bf16, pipe_f32, bank, fx, failures):
    """Phase 10. Returns ({path: launches}, {kernel: {path: largest error
    on the path's inputs}}, report)."""
    from text2pos_torch.parallel import dp

    D = max(2, min(4, torch.cuda.device_count()))
    mesh = dp.make_mesh(D, "cuda", log=log)
    cards = len(set(mesh.devices))
    log(f"  mesh of {D} shards: {[str(d) for d in mesh.devices]} ({gpu})")
    if cards < 2:
        log("  not exercised here: shards on a second card (the device "
            "guard, peer copies); this machine has one card, so every "
            "shard runs on cuda:0, one after another")
    by_path, stores, report = {}, {}, {"shards": D, "cards": cards}
    t0 = time.time()
    dp_serving_checks(mesh, {"bf16": pipe_bf16, "f32": pipe_f32}, fx,
                      by_path, stores, report, failures)
    log(f"  10.1-10.2 took {time.time() - t0:.1f} s")
    t0 = time.time()
    dp_encode_checks(mesh, pipe_f32, bank, by_path, stores, report, failures)
    train, _, vocab = train_data()
    dp_train_checks(mesh, train, vocab, by_path, stores, report, failures)
    log(f"  10.3-10.4 took {time.time() - t0:.1f} s")
    for path, kernels in DP_PATH_KERNELS.items():
        for name in kernels:
            if by_path.get(path, {}).get(name, 0) < 1:
                failures.append(f"kernel {name} was not launched on {path}")
    want = {"lstm": 2 * D, "sinkhorn": D, "superglue_gnn": D}
    if {k: by_path["dp_serve"].get(k, 0) for k in want} != want:
        failures.append(f"dp_serve launches {by_path['dp_serve']}, not "
                        f"{want} (one batch a shard)")
    errs = collections.defaultdict(dict)
    for path, store in stores.items():
        for kernel, err in kept_checks(path, store, failures).items():
            errs[kernel][path] = err
    return by_path, dict(errs), report


# Phase 12: JAX's default widths and the model variants. Models at JAX's
# default embed_dim 300 (coarse; fine with 6 block pairs and 50 Sinkhorn
# iterations, pad_size 16, num_mentioned 6) initialised by
# ``train.state.init_parameters`` from seeded generators, the bench map and
# its 2048 queries. Limits: each widened kernel against its plain version at
# its phase-3 tolerance (TOL, GNN_REL_TOL; FPS bit for bit); the f32 serving
# modes' top_idx equal to the same pipeline's with every kernel wrapper
# rebound to its plain version (``plain_kernels``), a differing row passing
# only as near-ties: the coarse similarities' for the headline
# (``headline_swaps``), ``explain_stage``'s rule for rerank and the cascade
# with the plain pipeline's scores where phase 4 reads JAX's
# (``wide_explain``, ``BatchStages``), at WIDE_SWAP_TOL; one f32 training
# step of each stage
# against the same step on the plain versions, on the kernel step's piecewise
# choices (``Decisions``), at phase 7's limits; each variant of the object
# encoder trains (finite loss and gradients), and a class-embedding model
# encodes the map and serves with no PointNet++ launch.
WIDE_E = 300
WIDE_SEED = 300
# ``explain_stage``'s tolerance in phase 12 (phase 4's SWAP_REL_TOL, set on
# the bench's trained weights against JAX, is 1e-5). At E=300 on these
# random weights the kernels' and the plain versions' re-rank scores of one
# candidate differ by up to 1.3e-4 relative without a flipped decision
# (0.733101 against 0.733196 in one cascade row: the GNN's f32 sums in
# another order, 3.8e-4 on scores of 150, carried through Sinkhorn into the
# match confidences; chip_smoke phase 12's runs on an H100); a little over
# twice that.
WIDE_SWAP_TOL = 3e-4
WIDE_LSTM = (96, 300, 384, 512)
WIDE_GNN_PAIRS = 4096      # pairs of the random-weight GNN shapes
WIDE_GNN = tuple((E, T0, T1, WIDE_GNN_PAIRS)
                 for E, T0, T1 in ((300, 16, 6), (128, 24, 6), (256, 32, 8)))
# Shapes of the second form's wide route (a pair's rows past shared memory:
# f32 at E = 300 with 64 rows, bf16 past E = 448 with both sets over 16),
# at fewer pairs: it runs a CTA a pair.
WIDE_GNN_WIDE = ((300, 32, 32, 512), (512, 32, 32, 512))
WIDE_GNN_BLOCKS = 4
# FPS (B, N, S) past the DB encode's 256 points: a warp an object up to
# 1024, a CTA an object up to 4096, then the minima in global memory.
WIDE_FPS = ((1024, 512, 256), (1024, 1024, 512), (1024, 2048, 1024),
            (1024, 4096, 2048), (4, 40000, 256))
VARIANTS = {"coarse": {"variation 1": dict(variation=1),
                       "class_embed": dict(class_embed=True),
                       "color_embed": dict(color_embed=True),
                       "use_features class position":
                           dict(use_features=("class", "position")),
                       "use_features color": dict(use_features=("color",)),
                       "pointnet_features 0": dict(pointnet_features=0),
                       "pointnet_features 1": dict(pointnet_features=1)},
            "fine": {"class_embed color_embed":
                         dict(class_embed=True, color_embed=True),
                     "use_features class position, pointnet_features 1":
                         dict(use_features=("class", "position"),
                              pointnet_features=1)}}


def _chunked_gnn_plain(d0, d1, packed):
    from text2pos_torch.ops.superglue_gnn import gnn_scores_plain

    return torch.cat([gnn_scores_plain(d0[i:i + CHUNK_PAIRS],
                                       d1[i:i + CHUNK_PAIRS], packed)
                      for i in range(0, len(d0), CHUNK_PAIRS)])


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper of the serving and training paths rebound to its
    plain version (the GNN's over CHUNK_PAIRS pairs at a time): the
    reference the kernels' pipeline is held to."""
    import text2pos_torch.ops.fps as fps
    import text2pos_torch.ops.lstm as lstm
    import text2pos_torch.ops.sinkhorn as sinkhorn
    import text2pos_torch.ops.superglue_gnn as gnn

    saved = [(lstm, "_lstm_kernel", lstm.lstm_final_hidden_plain),
             (sinkhorn, "_lot_kernel", sinkhorn.log_optimal_transport_plain),
             (gnn, "_gnn_kernel", _chunked_gnn_plain),
             (fps, "_fps_kernel", fps.farthest_point_sampling_plain),
             (fps, "_fps_levels_kernel",
              fps.farthest_point_sampling_levels_plain)]
    saved = [(m, n, getattr(m, n), f) for m, n, f in saved]
    for m, n, _, f in saved:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, old, _ in saved:
            setattr(m, n, old)


class BatchStages:
    """Every candidate's stage data (``stage_candidates``' fields) of the
    fixture's queries in one batch, as ``serve_batch`` computes them: the
    coarse top-rerank_k, the re-rank pass over them, and with ``cheap``
    (q, scale, layers, iters) the cascade's cheap pass on the int8 bank,
    its ``prune_m`` survivors (``kept``) and the full pass over those. A
    row of a batch is the served computation's own, where a query
    recomputed alone is not: the coarse similarities and the offset head
    take other cuBLAS kernels at another batch size."""

    def __init__(self, pipe, fx, cheap=None):
        from text2pos_torch.ops.retrieval import topk_retrieval

        rk, self.lam, self.gam = (float(v) for v in fx["rerank"])
        self.pipe = pipe
        q = [torch.as_tensor(fx[k], device=pipe.device)
             for k in ("tokens", "lengths", "hint_tokens", "hint_lengths")]
        with torch.inference_mode():
            sims, cells = topk_retrieval(pipe.coarse.encode_text(q[0], q[1]),
                                         pipe.cell_enc, int(rk))
            self.hint_enc = pipe.fine.encode_hints(q[2], q[3])
            self.stages = {"rerank": self._stage(cells, sims)}
            if cheap is not None:
                qb, qs, layers, iters = cheap
                ch = self._stage(cells, sims, (qb, qs), layers, iters)
                keep = torch.sort(-ch["scores"], dim=1, stable=True).indices[
                    :, :int(fx["cascade"][1])]
                self.stages["cheap"] = ch
                self.stages["cascade"] = self._stage(
                    torch.gather(cells, 1, keep), torch.gather(sims, 1, keep))

    def _stage(self, cells, sims, cheap_bank=None, layers=None, iters=None):
        from text2pos_torch.evaluation.pipeline import _match_results

        pipe = self.pipe
        if cheap_bank is None:
            obj = pipe._gather(cells, pipe.fine_bank_enc)
        else:
            dt = pipe.fine.superglue.dtype or torch.float32
            obj = (pipe._gather(cells, cheap_bank[0]).to(dt)
                   * pipe._gather(cells, cheap_bank[1]).to(dt))
        ctr = pipe._gather(cells, pipe.fine_bank_centers)
        B, K = cells.shape
        out = pipe.fine.match_encoded(
            obj.flatten(0, 1), self.hint_enc.repeat_interleave(K, dim=0),
            layers, iters)
        *_, conf, spread = _match_results(out, ctr)
        score = conf.float() + self.lam * sims.float() \
            - self.gam * spread.float()
        return {"cells": cells, "scores": score, "sims": sims,
                "Z": out["log_P"].unflatten(0, (B, K)),
                "offsets": out["offsets"].unflatten(0, (B, K)), "ctr": ctr}

    def row(self, r: int, stage: str) -> dict:
        st = self.stages[stage]
        return {"cells": st["cells"][r].cpu().numpy(),
                "scores": st["scores"][r].cpu().numpy(),
                "sims": st["sims"][r].float().cpu(),
                "Z": st["Z"][r].float().cpu(),
                "offsets": st["offsets"][r].float().cpu(),
                "ctr": st["ctr"][r].float().cpu()}


def wide_explain(fx, got, want, mode, kernels: BatchStages,
                 plain: BatchStages):
    """``explain_swaps`` for phase 12: rows where the served ``got``
    differs from the plain pipeline's ``want``, each with (row, ok, notes)
    from ``explain_stage`` at WIDE_SWAP_TOL, the plain pipeline's batch
    standing where phase 4 reads JAX's fixture ("JAX" in the notes)."""
    pipe, out = kernels.pipe, []
    for r in np.flatnonzero((got != want).any(1)):
        r = int(r)
        if mode == "rerank":
            p = plain.row(r, "rerank")
            ok, notes = explain_stage(pipe, fx, got[r], want[r],
                                      kernels.row(r, "rerank"), p["cells"],
                                      p["scores"], tol=WIDE_SWAP_TOL)
            out.append((r, ok, notes))
            continue
        kc, pc = kernels.row(r, "cheap"), plain.row(r, "cheap")
        kept = [int(c) for c in kernels.row(r, "cascade")["cells"]]
        pf = plain.row(r, "cascade")
        pkept = [int(c) for c in pf["cells"]]
        ok, notes, excused = True, [], frozenset()
        if set(kept) != set(pkept):
            ok, notes = explain_stage(pipe, fx, kept, pkept, kc, pc["cells"],
                                      pc["scores"], tol=WIDE_SWAP_TOL)
            notes = [f"cheap pass: {n}" for n in notes]
            excused = frozenset(kept) ^ frozenset(pkept)
        ok2, notes2 = explain_stage(pipe, fx, got[r], want[r],
                                    kernels.row(r, "cascade"), pkept,
                                    pf["scores"], excused, tol=WIDE_SWAP_TOL)
        out.append((r, ok and ok2,
                    notes + [f"full pass: {n}" for n in notes2]))
    return out


def wide_models(pipe, dtype, seed=WIDE_SEED, coarse_opts=None,
                fine_opts=None, width=WIDE_E):
    """Coarse and fine models at embed_dim ``width`` (300) on the card,
    the bench vocabularies, weights from ``init_parameters`` with seeds
    ``seed`` and ``seed + 1``; the fine one uncalibrated (batch statistics,
    two statistics rows a GNN BN)."""
    from text2pos_torch.models.cell_retrieval import CellRetrievalNetwork
    from text2pos_torch.models.matcher import SuperGlueMatch
    from text2pos_torch.train.state import init_parameters

    rows = lambda m: m.language_encoder.word_embedding.weight.shape[0]
    coarse = CellRetrievalNetwork(rows(pipe.coarse), width, dtype=dtype,
                                  **(coarse_opts or {}))
    fine = SuperGlueMatch(rows(pipe.fine), width, num_layers=6,
                          sinkhorn_iters=50, dtype=dtype, stat_groups=2,
                          eval_batch_stats=True, **(fine_opts or {}))
    return (init_parameters(coarse, seed).to(pipe.device),
            init_parameters(fine, seed + 1).to(pipe.device))


def wide_pipeline(pipe, bank, fx, dtype, pad=16, width=WIDE_E, **opts):
    """A calibrated serving pipeline of ``wide_models`` at ``width`` and
    ``pad`` on the map ``bank`` (the bench map, phase 14's dense one): the
    DB encode (launches read), then ``calibrated_for_serving`` on the
    queries' hints of ``fx`` and the model's own top-10 cells, 128 cells.
    Returns (pipeline, DB-encode launches, DB-encode s, calibration s)."""
    from text2pos_torch.config import ServeConfig
    from text2pos_torch.evaluation.pipeline import LocalizationPipeline
    from text2pos_torch.ops import _build
    from text2pos_torch.ops.retrieval import topk_retrieval

    coarse, fine = wide_models(pipe, dtype, width=width, **opts)
    base = LocalizationPipeline(coarse, fine, pipe.vocab, pipe.fine_vocab,
                                cfg=ServeConfig(pad_size=pad))
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    with torch.inference_mode():
        cell_enc = base.encode_database(bank)[0]
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    db_launches = dict(_build.LAUNCHES)
    base = base.with_database(cell_enc, None, None)
    with torch.inference_mode():
        cal_idx = topk_retrieval(base.coarse.encode_text(
            torch.as_tensor(fx["tokens"], device=pipe.device),
            torch.as_tensor(fx["lengths"], device=pipe.device)), cell_enc,
            TOP_K)[1]
    t0 = time.perf_counter()
    cal = base.calibrated_for_serving(bank, fx["hint_tokens"],
                                      fx["hint_lengths"], cal_idx,
                                      max_cells=128)
    torch.cuda.synchronize()
    return cal, db_launches, enc_s, time.perf_counter() - t0


def headline_swaps(pipe, fx, got, want):
    """Rows where the headline ``got`` differs from the plain pipeline's
    ``want``, each with (row, ok, notes): the headline's order is the coarse
    retrieval's, so a differing row passes only where the plain pipeline's
    similarities of the candidates at the differing positions are within
    ``SWAP_REL_TOL`` of each other, relative to the larger of the two."""
    from text2pos_torch.ops.retrieval import topk_retrieval

    out = []
    for r in np.flatnonzero((got != want).any(1)):
        r = int(r)
        with torch.inference_mode(), plain_kernels():
            q = [torch.as_tensor(fx[k][r:r + 1], device=pipe.device)
                 for k in ("tokens", "lengths")]
            sims, cells = topk_retrieval(pipe.coarse.encode_text(*q),
                                         pipe.cell_enc, pipe.cell_enc.shape[0])
        sim = dict(zip(cells[0].tolist(), sims[0].float().tolist()))
        top = float(sims[0].float().abs().max())
        notes, ok = [], True
        for a, b in zip(got[r], want[r]):
            if a != b:
                sa, sb = sim[int(a)], sim[int(b)]
                gap = abs(sa - sb) / max(abs(sa), abs(sb), 1e-30)
                notes.append(f"{int(a)} for {int(b)}: the plain pipeline's "
                             f"similarities ({sa:.6g}, {sb:.6g}; the row's "
                             f"largest {top:.6g}) differ by {gap:.3e} "
                             "relative")
                ok = ok and gap < SWAP_REL_TOL
        out.append((r, ok, notes))
    return out


def wide_serving(pipe_bf16, bank, fx, failures):
    """12.2-12.3: serving at embed_dim 300 (headline q/s in bf16 and f32,
    launches, f32 headline, rerank@128 and cascade against the plain
    pipeline), then the fine model at pad_size 24. Returns (report,
    {path: launches}, the f32 and bf16 pipelines)."""
    from text2pos_torch.evaluation.metrics import served_accuracies
    from text2pos_torch.evaluation.pipeline import quantize_fine_bank
    from text2pos_torch.ops import _build

    report, by_path, pipes = {}, {}, {}
    rk, lam, gam = fx["rerank"]
    rr = (int(rk), float(lam), float(gam))
    crk, cm, cL, cS, clam, cgam = fx["cascade"]
    casc = (int(crk), float(clam), float(cgam), int(cm), int(cL), int(cS))
    for label, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        pipe, db, enc_s, cal_s = wide_pipeline(pipe_bf16, bank, fx, dtype)
        pipes[label] = pipe
        serve_all(pipe, fx, TOP_K)                              # warm-up
        _build.LAUNCHES.clear()
        ti, po, _ = serve_all(pipe, fx, TOP_K)
        launches = dict(_build.LAUNCHES)
        by_path[f"wide_serve_{label}"] = launches
        by_path[f"wide_db_encode_{label}"] = db
        ti, po, sec = serve_all(pipe, fx, TOP_K, reps=5)
        accs = served_accuracies(fx, ti, po, (1, 5, TOP_K))
        log(f"  12.2 E={WIDE_E} {label}: DB encode {enc_s:.3f} s (launches "
            f"{db}), calibration {cal_s:.3f} s; headline {len(ti)} queries x "
            f"top-{TOP_K} in {sec * 1e3:.2f} ms = {len(ti) / sec:.1f} q/s; "
            f"top-10@15m {accs[TOP_K][15]:.4f} (random weights); launches "
            f"of one batch {launches}")
        report[f"headline_{label}"] = {"ms": sec * 1e3,
                                       "qps": len(ti) / sec,
                                       "launches": launches,
                                       "db_encode_s": enc_s,
                                       "calibrate_s": cal_s}
        if not np.isfinite(po).all() or ti.shape != (len(fx["tokens"]),
                                                     TOP_K):
            failures.append(f"wide serve {label}: malformed output")
        want = {"lstm": 2, "superglue_gnn_any": 1, "sinkhorn": 1}
        if any(launches.get(k, 0) != n for k, n in want.items()) or \
                launches.get("superglue_gnn", 0):
            failures.append(f"wide serve {label}: launches {launches}, "
                            f"want {want} and no tuned GNN launch")
    pipe = pipes["f32"]
    cheap = quantize_fine_bank(pipe.fine_bank_enc)
    cheap4 = (*cheap, casc[4], casc[5])
    kst = BatchStages(pipe, fx, cheap4)
    with plain_kernels():
        pst = BatchStages(pipe, fx, cheap4)
    modes = (("headline", (), {}), ("rerank", rr, {}),
             ("cascade", casc, dict(cheap_bank=cheap[0],
                                    cheap_scale=cheap[1])))
    for mode, args, kw in modes:
        ti, po, sec = serve_all(pipe, fx, TOP_K, *args, **kw)
        with plain_kernels():
            pti, ppo, psec = serve_all(pipe, fx, TOP_K, *args, **kw)
        swaps = (headline_swaps(pipe, fx, ti, pti) if mode == "headline"
                 else wide_explain(fx, ti, pti, mode, kst, pst))
        log(f"  12.3 f32 {mode} at E={WIDE_E}: kernels {sec * 1e3:.1f} ms, "
            f"plain versions {psec * 1e3:.1f} ms; positions max difference "
            f"{float(np.abs(po - ppo).max()):.3e}")
        report_swaps(f"wide f32 {mode} (\"JAX\" in the notes: the plain "
                     "versions)", swaps, len(ti), failures,
                     "the plain versions'")
        report[f"f32_{mode}"] = {"ms": sec * 1e3, "plain_ms": psec * 1e3,
                                 "rows_differing": len(swaps)}
    pipe24, db24, _, _ = wide_pipeline(pipe_bf16, bank, fx, None, pad=24)
    serve_all(pipe24, fx, TOP_K)
    _build.LAUNCHES.clear()
    ti, po, sec = serve_all(pipe24, fx, TOP_K)
    by_path["wide_serve_pad24_f32"] = launches = dict(_build.LAUNCHES)
    with plain_kernels():
        pti, ppo, _ = serve_all(pipe24, fx, TOP_K)
    log(f"  12.3 f32 headline at E={WIDE_E}, pad_size 24: {sec * 1e3:.1f} "
        f"ms; launches {launches}; positions max difference from the plain "
        f"versions {float(np.abs(po - ppo).max()):.3e}")
    report_swaps("wide f32 headline, pad_size 24",
                 headline_swaps(pipe24, fx, ti, pti), len(ti), failures,
                 "the plain versions'")
    if launches.get("superglue_gnn_any", 0) != 1:
        failures.append(f"wide serve pad_size 24: launches {launches}")
    report["pad24_ms"] = sec * 1e3
    return report, by_path, pipes


def lstm_random_check(H, tokens, lengths, g, failures, tag):
    """The LSTM kernel at hidden width H on seeded random tables and W_hh
    over ``tokens`` [B, T] and ``lengths``, against its plain version, with
    its time, the plain version's, cuDNN's bidirectional ``nn.LSTM`` (E =
    H, packed) and its bound. Returns the readings; ``tag`` leads each log
    line (the phase)."""
    from text2pos_torch.ops.lstm import (CLUSTER_HIDDEN, _lstm_kernel,
                                         kernel_width,
                                         lstm_final_hidden_plain)

    dev = tokens.device
    B, T = tokens.shape
    V = int(tokens.max()) + 1
    tables = [torch.randn(V, 4 * H, device=dev, generator=g) * 0.3
              for _ in range(2)]
    w_hh = [(torch.rand(H, 4 * H, device=dev, generator=g) * 2 - 1)
            / math.sqrt(H) for _ in range(2)]
    form = "lstm_grid" if kernel_width(H) > CLUSTER_HIDDEN else "lstm"
    with torch.inference_mode():
        got = _lstm_kernel(tables, w_hh, tokens, lengths)
        want = lstm_final_hidden_plain(tables, w_hh, tokens, lengths)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(f"{tag} {form} T={T} B={B} H={H} V={V} (random weights)", err,
              TOL["lstm"], failures)
        ms = cuda_ms(lambda: _lstm_kernel(tables, w_hh, tokens, lengths))
        plain_ms = cuda_ms(lambda: lstm_final_hidden_plain(
            tables, w_hh, tokens, lengths), reps=3, warmup=1)
        x = torch.randn(B, T, H, device=dev, generator=g)
        lib = torch.nn.LSTM(H, H, bidirectional=True).to(dev)
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x.transpose(0, 1), lengths.clamp(1, T).cpu(),
            enforce_sorted=False)
        lib_ms = cuda_ms(lambda: lib(packed))
    steps = float(lengths.clamp(0, T).sum())
    flops = 2 * 2.0 * steps * H * 4 * H
    nbytes = 4.0 * (B * T + B + 2 * V * 4 * H + 2 * H * 4 * H + 2 * B * H)
    bnd, by = bound_ms([(3 * flops, PEAK_TF32)], nbytes)
    log(f"  {tag} {form} H={H} B={B} T={T}: kernel {ms:.3f} ms, bound "
        f"{bnd:.4f} ms ({by}), plain {plain_ms:.3f} ms, cuDNN nn.LSTM "
        f"(bidirectional, packed, E=H, projections included) {lib_ms:.3f} ms "
        f"({'faster' if ms < lib_ms else 'SLOWER'} than cuDNN)")
    return {"H": H, "B": B, "T": T, "form": form, "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
            "max_abs_err": err}


def gnn_random_check(E, T0, T1, d0, d1, label, failures, tag,
                     blocks=WIDE_GNN_BLOCKS):
    """The GNN kernel at (E, T0, T1) in ``label``'s dtype on descriptors d0,
    d1 with seeded random weights of ``blocks`` blocks, against its plain
    version within GNN_REL_TOL, its launch counted under ``any_plan``'s
    route, with its time, the plain version's and its bound. Returns the
    readings."""
    from text2pos_torch.ops import _build
    from text2pos_torch.ops.superglue_gnn import (_gnn_kernel,
                                                  gnn_scores_plain,
                                                  pack_gnn_params,
                                                  random_folded_params)

    dt = torch.bfloat16 if label == "bf16" else torch.float32
    route = gnn_route(E, T0, T1, dt)[0]
    N = len(d0)
    packed = pack_gnn_params(random_folded_params(
        blocks, seed=E + T0, width=E), dt, d0.device)
    before = _build.LAUNCHES[route]
    with torch.inference_mode():
        got = _gnn_kernel(d0, d1, packed)
        want = gnn_scores_plain(d0, d1, packed)
        torch.cuda.synchronize()
        if _build.LAUNCHES[route] != before + 1:
            failures.append(f"{tag} GNN {label} at {E}, {T0}x{T1}: no launch "
                            f"of {route}")
        err = max_err(got, want)
        scale = float(want.abs().max())
        check(f"{tag} {route} {label} N={N} {T0}x{T1} E={E} blocks={blocks} "
              f"(random weights; |scores| max {scale:.2f})", err,
              GNN_REL_TOL[label] * scale, failures)
        ms = cuda_ms(lambda: _gnn_kernel(d0, d1, packed), reps=5)
        plain_ms = cuda_ms(lambda: gnn_scores_plain(d0, d1, packed),
                           reps=3, warmup=1)
    bnd, by, tflop = gnn_bound(d0, d1, packed, label)
    log(f"  {tag} {route} {label} E={E} T0={T0} T1={T1} N={N}: kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"({'faster' if ms < plain_ms else 'SLOWER'} than plain), bound "
        f"{bnd:.4f} ms ({by}, {tflop:.3f} TFLOP; {100 * bnd / ms:.1f}% of "
        "the bound)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "max_abs_err": err, "route": route, "bound_share": bnd / ms}


def random_descs(N, T0, T1, E, g, device="cuda"):
    """L2-normalized seeded descriptors [N, T0, E] and [N, T1, E] on the
    card, as the encoders give them."""
    dev = torch.device(device)
    d0 = torch.nn.functional.normalize(torch.randn(
        N, T0, E, device=dev, generator=g), dim=-1)
    d1 = torch.nn.functional.normalize(torch.randn(
        N, T1, E, device=dev, generator=g), dim=-1)
    return d0, d1


def wide_kernel_checks(pipes, fx, failures):
    """12.1: the kernels on the E=300 serving path's inputs (``lstm_checks``
    and ``gnn_sinkhorn_checks`` on the wide pipelines), then at the other
    phase-12 shapes on random inputs from seeds: the LSTM at WIDE_LSTM
    on the bench text and at WIDE_E on its hints beside cuDNN, the GNN at
    WIDE_GNN in bf16 and f32, FPS at WIDE_FPS."""
    from text2pos_torch.ops.fps import (_fps_kernel,
                                        farthest_point_sampling_plain)

    dev = torch.device("cuda")
    out = {"lstm": lstm_checks(pipes["bf16"], fx, failures),
           "gnn": gnn_sinkhorn_checks(pipes["bf16"], pipes["f32"], fx,
                                      failures),
           "lstm_widths": [], "gnn_shapes": [], "fps_widths": []}
    tokens = torch.as_tensor(fx["tokens"], device=dev)
    lengths = torch.as_tensor(fx["lengths"], device=dev)
    g = torch.Generator(device=dev).manual_seed(12)
    for H in WIDE_LSTM:
        out["lstm_widths"].append(lstm_random_check(H, tokens, lengths, g,
                                                    failures, "12.1"))
    # The E = 300 headline's hint launch (12,288 hints of 16 tokens), the
    # L2 form's slowest serving shape.
    out["lstm_widths"].append(lstm_random_check(
        WIDE_E, torch.as_tensor(fx["hint_tokens"], device=dev).flatten(0, 1),
        torch.as_tensor(fx["hint_lengths"], device=dev).flatten(), g,
        failures, "12.1"))
    for E, T0, T1, N in WIDE_GNN + WIDE_GNN_WIDE:
        d0, d1 = random_descs(N, T0, T1, E, g)
        row = {"E": E, "T0": T0, "T1": T1, "N": N}
        for label, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            route = gnn_route(E, T0, T1, dt)[0]
            if (E, T0, T1, N) in WIDE_GNN_WIDE and \
                    route != "superglue_gnn_any_wide":
                continue
            if label == "bf16" and E <= 320 and route != "superglue_gnn_any":
                failures.append(f"12.1 GNN bf16 at {E}, {T0}x{T1} ran "
                                f"{route}, not the tensor-core route")
            row[label] = gnn_random_check(E, T0, T1, d0, d1, label, failures,
                                          "12.1")
        out["gnn_shapes"].append(row)
    for Bo, N, S in WIDE_FPS:
        base = torch.randn(Bo, 200, 3, device=dev, generator=g)
        pick = torch.randint(0, 200, (Bo, N), device=dev, generator=g)
        pos = torch.gather(base, 1, pick[..., None].expand(Bo, N, 3))
        with torch.inference_mode():
            idx, cent = _fps_kernel(pos, S)
            widx, wcent = farthest_point_sampling_plain(pos, S)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: _fps_kernel(pos, S), reps=10)
            plain_ms = cuda_ms(lambda: farthest_point_sampling_plain(pos, S),
                               reps=2, warmup=1)
        same = int((idx == widx).all(-1).sum())
        err = max_err(cent, wcent)
        ok = same == Bo and err == 0.0
        bnd, by = bound_ms([(8.0 * Bo * N * (S - 1), PEAK_F32)],
                           4.0 * 3 * Bo * N + (8 + 12) * Bo * S)
        log(f"  12.1 fps B={Bo} N={N} S={S}: {same}/{Bo} objects with "
            f"bit-identical indices, centroid max abs err {err:.1e} "
            f"{'ok' if ok else 'FAIL'}; kernel {ms:.3f} ms = "
            f"{1e3 * ms / (S - 1):.3f} us per dependent step, plain "
            f"{plain_ms:.1f} ms, bound {bnd:.5f} ms ({by})")
        if not ok:
            failures.append(f"12.1 fps N={N}: {Bo - same} objects differ")
        out["fps_widths"].append({"N": N, "B": Bo, "S": S, "ms": ms,
                                  "plain_ms": plain_ms, "bound_ms": bnd,
                                  "bound_by": by, "max_abs_err": err})
    return out


def wide_pad_gnn_checks(pipes, pipe_bf16, bank, fx, failures):
    """12.1: the second form in bf16 at serving depth (12 blocks) on the
    E=300 bf16 serving pipelines' inputs, at ``gnn_depth_check``'s gate
    with ragged pair counts and exact ties: (300, 16, 6), the headline's
    pose-cell pairs (JAX's top-10 cells) with their hints at pad_size 16
    (CTAs of 3 m-tiles, also gated so by ``gnn_sinkhorn_checks``); then on
    a pipeline at pad_size 24, whose
    CTAs hold 4 m-tiles, (300, 24, 6) the same way and (300, 32, 32): 32
    object rows (the cell's 24 and 8 of the next pair's cell; the bench
    map holds at most 28 objects a cell, so no pipeline serves pad_size 32
    on it, in JAX either) against 32 mentioned objects (the hints of the
    pair's query and of the next five queries, cut to 32). Timed against
    the plain version. Returns the readings."""
    from text2pos_torch.ops import _build
    from text2pos_torch.ops.superglue_gnn import (_gnn_kernel,
                                                  gnn_scores_plain)

    dev = pipe_bf16.device
    idx = torch.as_tensor(fx["jax_top_idx"].astype("int64"),
                          device=dev).reshape(-1)
    K = fx["jax_top_idx"].shape[1]
    pipe24 = wide_pipeline(pipe_bf16, bank, fx, torch.bfloat16, pad=24)[0]
    inputs = {}
    for pad, pipe in ((16, pipes["bf16"]), (24, pipe24)):
        enc = pipe.fine_bank_enc
        with torch.inference_mode():
            hints = pipe.fine.encode_hints(
                torch.as_tensor(fx["hint_tokens"], device=dev),
                torch.as_tensor(fx["hint_lengths"], device=dev))
        inputs[f"pad_size {pad} path"] = (
            pipe, enc[idx], hints.repeat_interleave(K, dim=0))
    with torch.inference_mode():
        hints32 = torch.cat([hints.roll(-q, 0) for q in range(6)], 1)
        inputs["pad_size 24 path, 32 objects and hints"] = (
            pipe24, torch.cat([enc[idx], enc[idx.roll(-1)][:, :8]], 1),
            hints32[:, :32].repeat_interleave(K, dim=0))
    out = []
    for what, (pipe, d0, d1) in inputs.items():
        packed = pipe.fine.superglue.packed_kernel_params()
        d0, d1 = d0.contiguous(), d1.contiguous()
        N, T0, E = d0.shape
        T1 = d1.shape[1]
        route = gnn_route(E, T0, T1, torch.bfloat16)[0]
        before = _build.LAUNCHES[route]
        with torch.inference_mode():
            got = _gnn_kernel(d0, d1, packed)
            torch.cuda.synchronize()
        if _build.LAUNCHES[route] != before + 1:
            failures.append(f"12.1 GNN bf16 {what}: no launch of {route}")
        if route != "superglue_gnn_any":
            failures.append(f"12.1 GNN bf16 at {E}, {T0}x{T1} ran {route}, "
                            "not the tensor-core route")
        errs = gnn_depth_check(
            f"12.1 {route} bf16 {what} N={N} {T0}x{T1} E={E} "
            f"blocks={packed['wqkv'].shape[0]}", got, d0, d1, packed,
            failures)
        gnn_edge_checks("bf16", d0, d1, packed, got, failures, depth=True)
        with torch.inference_mode():
            ms = cuda_ms(lambda: _gnn_kernel(d0, d1, packed), reps=5)
            plain_ms = cuda_ms(lambda: gnn_scores_plain(d0, d1, packed),
                               reps=3, warmup=1)
        bnd, by, tflop = gnn_bound(d0, d1, packed, "bf16")
        log(f"  12.1 {route} bf16 {what} E={E} T0={T0} T1={T1} N={N}: "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
            f"({'faster' if ms < plain_ms else 'SLOWER'} than plain), bound "
            f"{bnd:.4f} ms ({by}, {tflop:.3f} TFLOP; {100 * bnd / ms:.1f}% "
            "of the bound)")
        out.append({"E": E, "T0": T0, "T1": T1, "N": N, "inputs": what,
                    "bf16": dict(errs, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bnd, bound_by=by, route=route,
                                 bound_share=bnd / ms)})
    return out


def wide_train_checks(train, vocab, failures):
    """12.4: one f32 step of each stage at embed_dim 300 (phase 7's step
    batches, weights from ``init_parameters``), its kernels against the same
    step with ``plain_kernels`` on the kernel step's piecewise choices, at
    phase 7's limits; the launches of the kernel step."""
    from text2pos_torch.config import TrainConfig
    from text2pos_torch.ops import _build
    from text2pos_torch.train.coarse import CoarseTrainer
    from text2pos_torch.train.fine import FineTrainer
    from text2pos_torch.utils.float64 import Decisions

    report, launches = {}, {}
    for stage, cls in (("coarse", CoarseTrainer), ("fine", FineTrainer)):
        cfg = TrainConfig(**dict(TRAIN_RECIPE[stage], embed_dim=WIDE_E,
                                 batch_size=STEP_BATCH[stage],
                                 device="cuda"))
        batch = next(stage_loader(stage, train, vocab,
                                  STEP_BATCH[stage]).epoch(seed=1))
        rng = np.random.default_rng(3)
        draws = host_draws(stage, batch, rng)
        steps = []
        decisions = Decisions()
        for plain in (False, True):
            trainer = cls(cfg, vocab)
            state = trainer.init_state(1)
            if plain:
                with plain_kernels(), decisions.replay():
                    steps.append(step_grads(stage, trainer, state, batch,
                                            draws))
            else:
                _build.LAUNCHES.clear()
                with decisions.record():
                    steps.append(step_grads(stage, trainer, state, batch,
                                            draws))
                torch.cuda.synchronize()
                launches[f"wide_train_{stage}"] = dict(_build.LAUNCHES)
        c = compare_steps(summary(steps[0]), summary(steps[1]))
        log(f"  12.4 train {stage} E={WIDE_E} batch {STEP_BATCH[stage]}: "
            f"loss {steps[0][0]:.6f}, plain versions {steps[1][0]:.6f}; "
            f"launches {launches[f'wide_train_{stage}']}; the plain step "
            f"would have chosen otherwise at {decisions.flips} entries "
            f"(margin {decisions.margin:.2e})")
        gate_step(stage, f"E={WIDE_E}, the kernels' step vs the plain "
                  "versions' on its choices", c, failures)
        want = ("lstm", "fps") + (("sinkhorn",) if stage == "fine" else ())
        if any(launches[f"wide_train_{stage}"].get(k, 0) < 1 for k in want):
            failures.append(f"12.4 train {stage}: a kernel of {want} did "
                            "not launch")
        report[stage] = dict(c, flips=decisions.flips)
    return report, launches


def variant_checks(pipe_bf16, bank, fx, train, vocab, failures):
    """12.5: one f32 training step of each variant of the object encoder
    (VARIANTS; finite loss and gradients, the id embeddings trained), then
    a class-embedding model's DB encode, calibration and headline serve:
    no PointConv and no FPS launch, finite outputs."""
    from text2pos_torch.config import TrainConfig
    from text2pos_torch.ops import _build
    from text2pos_torch.train.coarse import CoarseTrainer
    from text2pos_torch.train.fine import FineTrainer

    report, launches = {}, {}
    for stage, variants in VARIANTS.items():
        cls = CoarseTrainer if stage == "coarse" else FineTrainer
        batch = next(stage_loader(stage, train, vocab,
                                  STEP_BATCH[stage]).epoch(seed=2))
        draws = host_draws(stage, batch, np.random.default_rng(4))
        for name, opts in variants.items():
            cfg = TrainConfig(**dict(TRAIN_RECIPE[stage],
                                     batch_size=STEP_BATCH[stage],
                                     device="cuda", **opts))
            trainer = cls(cfg, vocab)
            state = trainer.init_state(1)
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            loss, grads, _ = step_grads(stage, trainer, state, batch, draws)
            state.apply_gradients()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            finite = math.isfinite(loss) and all(
                np.isfinite(np.asarray(v)).all() for v in grads.values())
            emb = [k for k in grads if "_embedding/" in k and
                   "word_embedding" not in k]
            moved = all(float(np.abs(grads[k]).sum()) > 0 for k in emb)
            ok = finite and moved
            log(f"  12.5 {stage} variant {name}: a step in {ms:.1f} ms, loss "
                f"{loss:.6f}, launches {dict(_build.LAUNCHES)}; finite "
                f"{finite}, id embeddings {emb or 'none'} with gradient "
                f"{moved} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"12.5 {stage} variant {name}: loss {loss}, "
                                f"finite {finite}, embeddings moved {moved}")
            report[f"{stage} {name}"] = {"loss": loss, "ms": ms}
    opts = dict(coarse_opts=dict(class_embed=True),
                fine_opts=dict(class_embed=True))
    pipe, db, enc_s, cal_s = wide_pipeline(pipe_bf16, bank, fx,
                                           torch.bfloat16, **opts)
    launches["variant_db_encode"] = db
    serve_all(pipe, fx, TOP_K)
    _build.LAUNCHES.clear()
    ti, po, sec = serve_all(pipe, fx, TOP_K)
    launches["variant_serve"] = dict(_build.LAUNCHES)
    ok = (db.get("pointconv", 0) == 0 and db.get("fps", 0) == 0
          and np.isfinite(po).all() and launches["variant_serve"].get(
              "superglue_gnn_any", 0) == 1)
    log(f"  12.5 class_embed model (E={WIDE_E}, bf16): DB encode {enc_s:.3f} "
        f"s with launches {db} (no PointConv, no FPS), calibration "
        f"{cal_s:.3f} s, headline {sec * 1e3:.2f} ms with launches "
        f"{launches['variant_serve']} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"12.5 class_embed model: DB-encode launches {db}, "
                        f"serve {launches['variant_serve']}")
    report["class_embed_serve_ms"] = sec * 1e3
    return report, launches


def widths_phase(pipe_bf16, bank, fx, failures):
    """Phase 12: JAX's default widths and the variants. Returns
    ({path: launches}, the kernel readings, the report)."""
    train, _, vocab = train_data()
    report, by_path, pipes = wide_serving(pipe_bf16, bank, fx, failures)
    kernels = wide_kernel_checks(pipes, fx, failures)
    kernels["gnn_pad_paths"] = wide_pad_gnn_checks(pipes, pipe_bf16, bank,
                                                   fx, failures)
    report["train"], launches = wide_train_checks(train, vocab, failures)
    by_path.update(launches)
    report["variants"], launches = variant_checks(pipe_bf16, bank, fx, train,
                                                  vocab, failures)
    by_path.update(launches)
    return by_path, kernels, report


def gnn_routes(wide, by_path, widest):
    """The second form's routes: for each, every timing of phases 12.1 and
    14 that ran on it (the E=300 serving path's inputs, the random shapes,
    the E=768 pad_size 48 path's inputs, phase 14's random shapes) with its
    share of the bound, and its launches by path."""
    runs = [("E300 path", {"E": WIDE_E}, wide["gnn"])] + [
        ("E300 bf16 " + row["inputs"], row, row)
        for row in wide["gnn_pad_paths"]] + [
        ("random", row, row) for row in wide["gnn_shapes"]] + [
        (f"E{WIDEST_E} pad_size {WIDEST_PAD} path", {"E": WIDEST_E},
         widest["gnn"])] + [
        ("widest random", row, row) for row in widest["gnn_shapes"]]
    routes = {}
    for what, shape, res in runs:
        for label in ("bf16", "f32"):
            r = res.get(label)
            if not r:
                continue
            entry = routes.setdefault(r["route"], {"runs": []})
            entry["runs"].append(dict(
                inputs=what, dtype=label, ms=r["ms"], bound_ms=r["bound_ms"],
                bound_share=r["bound_share"], plain_ms=r["plain_ms"],
                **{k: shape[k] for k in ("E", "T0", "T1", "N") if k in shape},
                **{k: r[k] for k in ("N",) if k in r}))
    for name, entry in routes.items():
        entry["launches_by_path"] = {p: n.get(name, 0)
                                     for p, n in by_path.items()
                                     if n.get(name, 0)}
    return routes


# Phase 13: the last modules. A seeded KITTI360-layout drive prepared by the
# port's data preparation (its C++ host library) and evaluated and served
# from --base_path; reference-style checkpoints made from seeds, converted
# and served; the transformer matcher ablation at JAX's default widths; the
# fast module form of the GNN and the drawing tools' cv2 check.
K360_SCENE = "2013_05_28_drive_0010_sync"     # the val split's one drive
K360_STREET_GAP = 240.0   # streets of the serpentine drive, metres apart
K360_ROAD_HALF = 6.0
# The extent holds 6 streets; the host's prepare takes about 70 s at 3 of
# them (cells at the sampled locations, one pose a location and method) and
# grows with the square of the streets (cells x points each one scans).
K360_STREETS = 3
K360_PREPARE = {"shift_poses": True, "pose_count": 1}
K360_PREPARE_FLAGS = tuple(a for k, v in K360_PREPARE.items()
                           for a in ((f"--{k}",) if v is True
                                     else (f"--{k}", str(v))))
K360_SERVE_QUERIES = 256
# The transformer ablation at JAX's default widths (text2pos_tpu/config.py)
TRANSFORMER = dict(embed_dim=300, num_layers=6, sinkhorn_iters=50,
                   batch_size=32, pad_size=16, num_mentioned=6,
                   pointnet_numpoints=256, max_hint_len=16)
TRANSFORMER_STEPS = 8
TRANSFORMER_CLI_BATCHES = 4
# The GNN kernel on the converted weights against the fabricated reference
# module's own forward (Conv1d projections, interleaved heads), f32:
# relative to the largest score, f32 sums in another order through 12
# blocks.
CONVERTED_GNN_REL_TOL = 1e-4
# The converted coarse tower against the reference module's forward in
# float64: f32 unit encodings (the DB encode's gate, tests/
# test_torch_port_db.py), on the first 64 cells of the bench map.
CONVERTED_REF_TOL = 1e-4
CONVERTED_REF_CELLS = 64
# A query's similarities must spread: the near-tie rule below is relative.
CONVERTED_MIN_SPREAD = 1e-2


def _ply(path, xyz, rgb, sem, inst):
    """A binary little-endian PLY in KITTI360's vertex layout."""
    dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                   ("red", "u1"), ("green", "u1"), ("blue", "u1"),
                   ("semanticID", "<i4"), ("instanceID", "<i4")])
    rec = np.zeros(len(xyz), dt)
    rec["x"], rec["y"], rec["z"] = xyz.T
    rec["red"], rec["green"], rec["blue"] = rgb.T
    rec["semanticID"], rec["instanceID"] = sem, inst
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(rec)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              "property int semanticID\nproperty int instanceID\n"
              "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def write_k360_scene(root, streets, seed=0):
    """A seeded KITTI360-layout drive over SCENE_SIZES[K360_SCENE]'s x
    extent: ``streets`` streets K360_STREET_GAP apart joined into one
    serpentine drive, with road and sidewalk strips, vegetation and terrain
    patches (stuff, instance 0 as in KITTI360) and buildings, poles, lamps,
    signs, traffic lights, small poles, trash bins and boxes (instances)
    along them; binary PLYs of 250 m of x each under
    data_3d_semantics/<scene>/static/ (objects span files) and the
    trajectory, a frame every 2 m, in data_poses/<scene>/poses.txt. Returns
    (points, frames)."""
    from text2pos_torch.constants import CLASS_TO_LABEL, SCENE_SIZES

    rng = np.random.default_rng(seed)
    X = SCENE_SIZES[K360_SCENE][0]
    ys = K360_STREET_GAP / 2 + K360_STREET_GAP * np.arange(streets)
    x0, x1 = 20.0, X - 20.0
    parts, next_id = [], [1000]

    def add(xyz, rgb, label, instance=None):
        if instance is None:
            instance, next_id[0] = next_id[0], next_id[0] + 1
        col = np.clip(np.asarray(rgb) + rng.normal(0, 8, (len(xyz), 3)),
                      0, 255)
        parts.append((xyz, col.astype(np.uint8), CLASS_TO_LABEL[label],
                      instance))

    def box(cx, cy, w, d, h, density):
        n = max(int(w * d * max(h, 0.3) * density), 30)
        return rng.random((n, 3)) * [w, d, h] + [cx - w / 2, cy - d / 2, 0]

    furniture = ("pole", "lamp", "traffic sign", "smallpole", "trash bin",
                 "box", "traffic light")
    for si, y in enumerate(ys):
        L = x1 - x0
        n = int(L * 2 * K360_ROAD_HALF * 3)
        add(np.stack([x0 + rng.random(n) * L,
                      y + (rng.random(n) * 2 - 1) * K360_ROAD_HALF,
                      rng.normal(0, 0.03, n)], 1), (128, 64, 128), "road", 0)
        for side in (-1, 1):
            n = int(L * 3 * 3)
            add(np.stack([x0 + rng.random(n) * L,
                          y + side * (K360_ROAD_HALF + rng.random(n) * 3),
                          0.15 + rng.normal(0, 0.03, n)], 1),
                (244, 35, 232), "sidewalk", 0)
            for bx in np.arange(x0 + 10, x1 - 10, 30.0) + rng.uniform(-4, 4):
                w, d, h = (rng.uniform(8, 16), rng.uniform(6, 10),
                           rng.uniform(5, 12))
                add(box(bx, y + side * (K360_ROAD_HALF + 5 + d / 2), w, d, h,
                        0.6), rng.integers(40, 200, 3), "building")
            for j, fx_ in enumerate(np.arange(x0 + 3, x1 - 3, 7.0)):
                lab = furniture[(j + si + (side > 0)) % len(furniture)]
                fy = y + side * (K360_ROAD_HALF + 1.5)
                tall = lab in ("pole", "lamp", "smallpole", "traffic light")
                add(box(fx_, fy, 0.3, 0.3, rng.uniform(3, 7), 150) if tall
                    else box(fx_, fy, rng.uniform(0.5, 1.2),
                             rng.uniform(0.5, 1.2), rng.uniform(0.6, 1.5),
                             150), rng.integers(0, 255, 3), lab)
            for vx in np.arange(x0 + 25, x1 - 25, 60.0):
                vy = y + side * (K360_ROAD_HALF + 21 + rng.uniform(0, 6))
                add(box(vx, vy, 12, 8, 4, 1.5), (107, 142, 35), "vegetation",
                    0)
                add(box(vx + 20, vy, 14, 10, 0.2, 12), (152, 251, 152),
                    "terrain", 0)
    xyz = np.concatenate([p[0] for p in parts]).astype(np.float32)
    rgb = np.concatenate([p[1] for p in parts])
    sem = np.concatenate([np.full(len(p[0]), p[2], np.int32) for p in parts])
    ins = np.concatenate([np.full(len(p[0]), p[3], np.int32) for p in parts])
    static = os.path.join(root, "data_3d_semantics", K360_SCENE, "static")
    os.makedirs(static, exist_ok=True)
    key = np.floor(xyz[:, 0] / 250.0).astype(int)
    for k in np.unique(key):
        m = key == k
        _ply(os.path.join(static, f"{k * 1000:010d}_{k * 1000 + 999:010d}"
                                  ".ply"), xyz[m], rgb[m], sem[m], ins[m])
    track = []
    for si, y in enumerate(ys):
        xs = np.arange(x0, x1, 2.0)[::(-1 if si % 2 else 1)]
        track.append(np.stack([xs, y + 1.5 * np.sin(xs / 40.0),
                               np.full(len(xs), 1.7)], 1))
        if si + 1 < streets:
            yy = np.arange(y, ys[si + 1], 2.0)[1:]
            track.append(np.stack([np.full(len(yy), xs[-1]), yy,
                                   np.full(len(yy), 1.7)], 1))
    track = np.concatenate(track)
    rows = [np.concatenate([[i], np.hstack([np.eye(3), t[:, None]]).ravel()])
            for i, t in enumerate(track)]
    pose_dir = os.path.join(root, "data_poses", K360_SCENE)
    os.makedirs(pose_dir, exist_ok=True)
    np.savetxt(os.path.join(pose_dir, "poses.txt"), np.array(rows))
    return len(xyz), len(track)


def _popen(args, cwd):
    return subprocess.Popen([sys.executable, "-m", *args], cwd=cwd,
                            env=dict(os.environ, PYTHONPATH=ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(label, proc, t0, failures, timeout=600):
    """(stdout, wall s) of a started subprocess; a non-zero exit fails."""
    try:
        out, err = proc.communicate(timeout=max(1.0, timeout -
                                                (time.time() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        failures.append(f"{label}: timed out")
    wall = time.time() - t0
    if proc.returncode != 0:
        failures.append(f"{label}: exit {proc.returncode}; {err[-2000:]}")
    return out, wall


def _cli(argv_fn, argv, stdin_text=""):
    """``argv_fn(argv)`` in-process with stdin, stdout and stderr captured:
    (stdout, stderr)."""
    sys_stdin, out, err = sys.stdin, io.StringIO(), io.StringIO()
    sys.stdin = io.StringIO(stdin_text)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            argv_fn(argv)
    finally:
        sys.stdin = sys_stdin
    return out.getvalue(), err.getvalue()


def fabricate_reference(scratch, words):
    """Reference-style whole-model pickles at the bench widths
    (``CellRetrievalNetwork`` E=256; ``SuperGlueMatch`` E=128, 6 block
    pairs, 50 Sinkhorn iterations) and a PointNet++ state dict, from seeds
    (``utils/reference_models.py``), both models holding that PointNet++;
    returns their paths and the coarse and fine models."""
    from text2pos_torch.utils import reference_models as rm

    paths = {k: os.path.join(scratch, f"ref_{k}.pth")
             for k in ("coarse", "fine", "pointnet")}
    pn = rm.make_pointnet_state_dict(seed=13)
    torch.save(pn, paths["pointnet"])
    coarse, reg = rm.make_coarse_model(256, words, seed=11, pointnet=pn)
    rm.save_whole_model(coarse, reg, paths["coarse"])
    fine, reg = rm.make_fine_model(128, 6, words, seed=12, pointnet=pn)
    rm.save_whole_model(fine, reg, paths["fine"])
    return paths, coarse, fine


def converted_gnn_check(fine_ref, conv_fine, failures, device):
    """The GNN kernel (f32, the tuned form) on the converted SuperGlue's
    packed weights against the fabricated reference module's own forward
    on the card: the reference's interleaved heads must reach the kernel's
    pack through ``_attn_head_perm``."""
    from text2pos_torch.models.superglue import SuperGlue
    from text2pos_torch.ops import _build
    from text2pos_torch.train.state import load_checkpoint
    from text2pos_torch.utils.convert_jax import load_jax_params

    payload = load_checkpoint(conv_fine)
    sg = SuperGlue(128, 6, 50).eval()
    unused = load_jax_params(sg, payload["params"]["superglue"],
                             payload["batch_stats"]["superglue"])
    sg = sg.to(device)
    gen = torch.Generator(device=device).manual_seed(5)
    d0 = torch.randn(512, 16, 128, device=device, generator=gen)
    d1 = torch.randn(512, 6, 128, device=device, generator=gen)
    ref = fine_ref.superglue.to(device).eval()
    with torch.inference_mode():
        _build.LAUNCHES.clear()
        got = sg.scores(d0, d1)
        launched = _build.LAUNCHES.get("superglue_gnn", 0)
        x0, x1 = d0.transpose(1, 2), d1.transpose(1, 2)
        for i, lyr in enumerate(ref.gnn.layers):
            s0, s1 = (x1, x0) if i % 2 else (x0, x1)
            m = [_ref_attention(lyr, a, b) for a, b in ((x0, s0), (x1, s1))]
            x0 = x0 + lyr.mlp(torch.cat([x0, m[0]], 1))
            x1 = x1 + lyr.mlp(torch.cat([x1, m[1]], 1))
        want = torch.einsum("bdm,bdn->bmn", ref.final_proj(x0),
                            ref.final_proj(x1)) / 128 ** 0.5
    err = max_err(got, want)
    check("13.2 the GNN kernel on the converted weights vs the reference "
          "module's forward (f32, 512 pairs, 12 blocks; "
          f"{CONVERTED_GNN_REL_TOL:g} of |score| max; launches {launched})",
          err, CONVERTED_GNN_REL_TOL * float(want.abs().max()), failures)
    if launched != 1 or unused:
        failures.append(f"13.2 converted GNN: {launched} launches, unused "
                        f"{unused}")
    return err


def converted_coarse_check(coarse_ref, base, bank, fx, failures, device):
    """The converted coarse tower (f32, its kernels) against the fabricated
    reference module's own forward in float64 on the card: the bench
    queries' text encodings and the first ``CONVERTED_REF_CELLS`` cells'
    encodings on the same prepared points (``reference_models``' forward:
    the reference's modules, the port's sampling decisions). Returns the
    largest error and the coarse similarities' spread."""
    import copy

    from text2pos_torch.evaluation.pipeline import (bank_tensors,
                                                    coarse_cell_points)
    from text2pos_torch.utils import reference_models as rm

    ref = copy.deepcopy(coarse_ref).to(device, torch.float64).eval()
    bt = bank_tensors(bank, device)
    idx = torch.arange(CONVERTED_REF_CELLS, device=device)
    gen = torch.Generator(device=device).manual_seed(7)
    with torch.inference_mode():
        tok, ln = (torch.as_tensor(fx[k], device=device)
                   for k in ("tokens", "lengths"))
        text = base.coarse.encode_text(tok, ln)
        rtext = rm.reference_encode_text(ref, tok, ln)
        flat = coarse_cell_points(bt, idx, gen,
                                  num_points=base.cfg.pointnet_numpoints)
        cells = base.coarse.encode_objects(*flat, len(idx),
                                           bt["mask"].shape[1])
        rcells = rm.reference_encode_cells(
            ref, *(t.double() for t in flat[:4]), flat[4], len(idx))
        sims = text @ base.cell_enc.T
    err = {"text": max_err(text, rtext), "cells": max_err(cells, rcells)}
    rows = {"text": len(rtext), "cells": len(idx)}
    for k, e in err.items():
        check(f"13.2 converted coarse tower vs the reference module's "
              f"forward in float64: {k} ({rows[k]} rows, unit encodings)",
              e, CONVERTED_REF_TOL, failures)
    off = cells @ cells.T - 2 * torch.eye(len(idx), device=device)
    spread = float((sims.amax(1) - sims.amin(1)).median())
    log(f"    coarse similarities: {float(sims.min()):.4f} to "
        f"{float(sims.max()):.4f}, a query's spread (median) {spread:.4f}; "
        f"cells' largest cosine {float(off.max()):.4f}")
    if spread < CONVERTED_MIN_SPREAD:
        failures.append(f"13.2 converted coarse similarities degenerate: a "
                        f"query's spread {spread:.3e}")
    return max(err.values()), spread


def _ref_attention(lyr, x, src, heads=4):
    """The reference's MultiHeadedAttention (its superglue.py:103-115):
    Conv1d projections, ``view(B, dim, heads, N)``, merge. [B, D, N]."""
    B, D, _ = x.shape
    dim = D // heads
    q = lyr.attn.proj[0](x).view(B, dim, heads, -1)
    k = lyr.attn.proj[1](src).view(B, dim, heads, -1)
    v = lyr.attn.proj[2](src).view(B, dim, heads, -1)
    prob = torch.softmax(torch.einsum("bdhn,bdhm->bhnm", q, k) / dim ** 0.5,
                         dim=-1)
    out = torch.einsum("bhnm,bdhm->bdhn", prob, v)
    return lyr.attn.merge(out.contiguous().view(B, dim * heads, -1))


def converted_pipeline(paths, dtype, bank, fx, device):
    """The converted checkpoints served: the converted PointNet++ loaded
    into both towers, the bench map encoded, calibrated on the bench's
    calibration set. Returns (pipeline, {path: launches}, encode s,
    calibrate s)."""
    from text2pos_torch.evaluation.pipeline import LocalizationPipeline
    from text2pos_torch.ops.retrieval import topk_retrieval
    from text2pos_torch.train.state import load_checkpoint
    from text2pos_torch.utils.convert_jax import load_jax_params

    base = LocalizationPipeline.from_checkpoints(
        paths["coarse"], paths["fine"], None, dtype=dtype, device=device)
    pn = load_checkpoint(paths["pointnet"])
    for tower in (base.coarse, base.fine):
        unused = load_jax_params(tower.object_encoder.pointnet, pn["params"],
                                 pn["batch_stats"])
        assert all(u.split("/")[1] in ("class_classifier", "color_classifier")
                   for u in unused), unused
    (cell_enc, _, _), enc_s, db = timed(lambda: base.encode_database(bank))
    base = base.with_database(cell_enc, None, None)
    with torch.inference_mode():
        enc = base.coarse.encode_text(
            torch.as_tensor(fx["tokens"], device=device),
            torch.as_tensor(fx["lengths"], device=device))
        cal_idx = topk_retrieval(enc, cell_enc, TOP_K)[1]
    pipe, cal_s, cal = timed(lambda: base.calibrated_for_serving(
        bank, fx["hint_tokens"], fx["hint_lengths"], cal_idx, max_cells=128))
    return pipe, base, cal_idx, {"db_encode": db, "calibrate": cal}, enc_s, \
        cal_s


def converted_checks(paths, coarse_ref, fine_ref, bank, fx, headline_ms,
                     by_path, errs, report, failures, device):
    """13.2 and 13.4's fast graph: the converted checkpoints encoded,
    calibrated and served in bf16 and f32, every kernel against its plain
    version on the served inputs."""
    report["converted_gnn_err"] = converted_gnn_check(fine_ref,
                                                      paths["conv_fine"],
                                                      failures, device)
    conv = {"coarse": paths["conv_coarse"], "fine": paths["conv_fine"],
            "pointnet": paths["conv_pointnet"]}
    bases = {}
    for label, dtype in (("bf16", "bfloat16"), ("f32", "float32")):
        pipe, base, cal_idx, launches, enc_s, cal_s = converted_pipeline(
            conv, dtype, bank, fx, device)
        bases[label] = (base, cal_idx, pipe)
        for k, v in launches.items():
            by_path[f"converted_{k}_{label}"] = v
        serve_all(pipe, fx, TOP_K)                             # warm-up
        store = {}
        (ti, po, _), _, launches = timed(lambda: serve_all(pipe, fx, TOP_K),
                                         store)
        by_path[f"converted_serve_{label}"] = launches
        errs[f"converted_serve_{label}"] = kept_checks(
            f"13.2 converted serve {label}", store, failures)
        _, _, sec = serve_all(pipe, fx, TOP_K, reps=5)
        log(f"  13.2 converted {label}: DB encode {enc_s:.3f} s (launches "
            f"{by_path[f'converted_db_encode_{label}']}), calibration "
            f"{cal_s:.3f} s; headline {len(ti)} queries x top-{TOP_K} in "
            f"{sec * 1e3:.2f} ms = {len(ti) / sec:.1f} q/s (phase 4's bench "
            f"weights: {headline_ms[label]:.2f} ms); launches {launches}")
        report[f"headline_{label}_ms"] = sec * 1e3
        if not np.isfinite(po).all() or ti.shape != fx["jax_top_idx"].shape:
            failures.append(f"13.2 converted serve {label}: malformed")
        for k in ("lstm", "superglue_gnn", "sinkhorn"):
            if launches.get(k, 0) < 1:
                failures.append(f"13.2 converted serve {label}: {k} did not "
                                "launch")
        if label == "f32":
            with plain_kernels():
                pti, ppo, _ = serve_all(pipe, fx, TOP_K)
            report["converted_ref_err"], report["converted_spread"] = \
                converted_coarse_check(coarse_ref, base, bank, fx, failures,
                                       device)
            report_swaps("13.2 converted f32 headline (\"JAX\" in the notes:"
                         " the plain versions)",
                         headline_swaps(pipe, fx, ti, pti),
                         len(ti), failures, "the plain versions'")
            log(f"    positions max difference from the plain versions "
                f"{float(np.abs(po - ppo).max()):.3e}")
            fast_graph_check(bank, fx, base, cal_idx, pipe, ti, po, report,
                             failures)


def fast_graph_check(bank, fx, base, cal_idx, plain, ti, po, report,
                     failures):
    """13.4: calibrated f32 serving with ``T2P_FAST_GRAPH=1`` (the GNN's
    fast module form in the batch-statistics calibration; the kernel reads
    the same folded weights) gives the same ``top_idx``; the calibration's
    wall time with the switch off and on, in turns."""
    def calibrate(on):
        if on:
            os.environ["T2P_FAST_GRAPH"] = "1"
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe = base.calibrated_for_serving(
                bank, fx["hint_tokens"], fx["hint_lengths"], cal_idx,
                max_cells=128)
            torch.cuda.synchronize()
            return pipe, time.perf_counter() - t0
        finally:
            os.environ.pop("T2P_FAST_GRAPH", None)

    walls = {False: [], True: []}
    for on in (False, True, True, False):
        pipe, wall = calibrate(on)
        walls[on].append(wall)
        if on:
            fast = pipe
    log(f"  13.4 calibrated_for_serving wall s, in turns: plain form "
        f"{walls[False]}, T2P_FAST_GRAPH=1 {walls[True]}")
    fti, fpo, _ = serve_all(fast, fx, TOP_K)
    stats = max(r[2] for r in stats_vs_cache(fast.batch_stats(),
                                             plain.batch_stats()))
    same = bool(np.array_equal(fti, ti))
    dpos = float(np.abs(fpo - po).max())
    log(f"  13.4 T2P_FAST_GRAPH=1: calibrated f32 serving, the GNN in the "
        f"fast form ({fast.fine.superglue.fast_graph}): top_idx equal to the "
        f"plain form's: {same}; calibrated statistics at most {stats:.3e} "
        f"of each leaf's scale apart; positions max difference {dpos:.3e} "
        f"{'ok' if same else 'FAIL'}")
    report["fast_graph"] = {"top_idx_equal": same, "positions_max": dpos,
                            "statistics_max": stats,
                            "calibrate_s": {"plain": walls[False],
                                            "fast": walls[True]}}
    if not same or not fast.fine.superglue.fast_graph:
        failures.append("13.4 T2P_FAST_GRAPH=1 changed the served top_idx")


def transformer_checks(by_path, errs, report, failures, device):
    """13.3 in process: one f32 step at JAX's default widths against the
    same step with the plain versions on its choices (phase 7's limits);
    ms a step, busy share, the launches of one step, the LSTM, Sinkhorn and
    FPS kernels against their plain versions on the step's inputs."""
    from text2pos_torch.config import TrainConfig
    from text2pos_torch.data.hints import (Vocabulary, build_vocabulary,
                                           create_hint_description)
    from text2pos_torch.data.loaders import FineLoader
    from text2pos_torch.train.coarse import step_generator
    from text2pos_torch.train.transformer import TransformerTrainer
    from text2pos_torch.utils.cli import load_split
    from text2pos_torch.utils.float64 import Decisions

    cfg = TrainConfig(**TRANSFORMER, dataset="SYNTHETIC-FINE",
                      device=device)
    cells, poses = load_split(cfg, "train")
    vocab = Vocabulary(build_vocabulary([create_hint_description(p)
                                         for p in poses]))
    loader = FineLoader(cells, poses, vocab, cfg.batch_size, cfg.pad_size,
                        cfg.num_mentioned, cfg.pointnet_numpoints,
                        cfg.max_hint_len)
    batches = list(itertools.islice(loader.epoch(seed=1),
                                    TRANSFORMER_STEPS))
    draws = host_draws("fine", batches[0], np.random.default_rng(3))
    steps, decisions = [], Decisions()
    for plain in (False, True):
        trainer = TransformerTrainer(cfg, vocab)
        state = trainer.init_state(1)
        with (plain_kernels() if plain else contextlib.nullcontext()), \
                (decisions.replay() if plain else decisions.record()):
            steps.append(step_grads("fine", trainer, state, batches[0],
                                    draws))
    c = compare_steps(summary(steps[0]), summary(steps[1]))
    log(f"  13.3 transformer E={cfg.embed_dim}, {cfg.num_layers} blocks, "
        f"{cfg.sinkhorn_iters} iterations, batch {cfg.batch_size}: loss "
        f"{steps[0][0]:.6f}, plain versions {steps[1][0]:.6f}; the plain "
        f"step would have chosen otherwise at {decisions.flips} entries "
        f"(margin {decisions.margin:.2e})")
    gate_step("transformer", "the kernels' step vs the plain versions' on "
              "its choices", c, failures)
    trainer = TransformerTrainer(cfg, vocab)
    state = trainer.init_state(len(batches))
    gen = lambda i: step_generator(trainer.device, 6, 0, 0, i)
    store = {}
    _, _, launches = timed(lambda: trainer.train_step(state, batches[0],
                                                      gen(0)), store)
    by_path["transformer_step"] = launches
    errs["transformer_step"] = kept_checks("13.3 transformer step", store,
                                           failures)
    ms, out = timed_steps(lambda i: trainer.train_step(
        state, batches[i % len(batches)], gen(i)), TRANSFORMER_STEPS)
    losses = [float(m["loss"]) for m in out]
    prof = busy_profile(lambda: trainer.train_step(state, batches[1],
                                                   gen(99)))
    busy = None if prof is None else prof["busy_ms"] / prof["wall_ms"]
    log(f"  13.3 transformer train_step: {ms:.1f} ms a step (median of the "
        f"last {TRANSFORMER_STEPS - 1} of {TRANSFORMER_STEPS}); busy "
        f"{'not measured' if busy is None else f'{busy:.3f}'} of a step's "
        f"wall; launches of one step {launches}; losses "
        f"{[round(x, 4) for x in losses]}")
    report["transformer"] = dict(c, step_ms=ms, busy=busy,
                                 launches=launches, flips=decisions.flips)
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"13.3 transformer: losses {losses}")
    for k in ("lstm", "sinkhorn", "fps"):
        if launches.get(k, 0) < 1:
            failures.append(f"13.3 transformer step: {k} did not launch")


def k360_checks(scratch, prep_dir, by_path, errs, report, failures, device):
    """13.1 on the prepared drive: the C++ host library against its numpy
    twins on the scene's objects, the evaluator with ``--dataset K360``
    (f32, its tables parsed) and the server's CLI with ``--base_path``
    (its stream against ``localize``, i.e. ``serve_batch``, on the same
    server), then 13.4's ``--plot_retrievals``."""
    from text2pos_torch import serving
    from text2pos_torch.data import cluster, legacy, native
    from text2pos_torch.data.hints import create_hint_description
    from text2pos_torch.data.ply import load_points
    from text2pos_torch.data.voxel import voxel_downsample_indices
    from text2pos_torch.evaluation import pipeline

    lib = native.get_lib()
    objects = legacy.load_pickle(os.path.join(scratch, "k360_in",
                                              f"objects_{K360_SCENE}.pkl"))
    static = os.path.join(scratch, "k360_in", "data_3d_semantics",
                          K360_SCENE, "static")
    raw = load_points(os.path.join(static, sorted(os.listdir(static))[0]))
    def patch(label):
        """A 30 m cell's worth of the stuff object ``label``, as
        ``create_cell`` crops it before DBSCAN."""
        xyz = next(o for o in objects if o.label == label).xyz
        return xyz[(np.abs(xyz[:, :2] - xyz[0, :2]) <= 15).all(1)]

    road, veg = patch("road"), patch("vegetation")
    bld = max((o for o in objects if o.label == "building"),
              key=lambda o: len(o.xyz))
    t0 = time.perf_counter()
    pairs = {
        "voxel (0.25 m, a file's points)": (
            voxel_downsample_indices(raw[0], 0.25),
            voxel_downsample_indices(raw[0], 0.25, force_numpy=True)),
        "DBSCAN (a cell's road)": (
            cluster.dbscan_labels(road),
            cluster.dbscan_labels(road, backend="numpy")),
        "DBSCAN (a cell's vegetation)": (
            cluster.dbscan_labels(veg),
            cluster.dbscan_labels(veg, backend="numpy")),
        "host FPS (256 of a building)": (
            native.fps_indices(bld.xyz, 256),
            native.fps_indices_numpy(bld.xyz, 256)),
    }
    host_s = time.perf_counter() - t0
    for what, (got, want) in pairs.items():
        same = bool(np.array_equal(got, want))
        log(f"  13.1 {what}: the C++ library ({len(got)} outputs) equals "
            f"its numpy twin: {same} {'ok' if same else 'FAIL'}")
        if not same:
            failures.append(f"13.1 {what} differs from the numpy twin")
    log(f"    (the C++ library {lib._name}; with the twins {host_s:.1f} s)")

    argv = ["--dataset", "K360", "--base_path", prep_dir, "--path_coarse",
            CKPT_COARSE, "--path_fine", CKPT_FINE, "--dtype", "float32",
            "--device", device]
    store = {}
    (text, _), wall, launches = timed(lambda: _cli(pipeline.main, argv),
                                      store)
    by_path["k360_eval"] = launches
    errs["k360_eval"] = kept_checks("13.1 K360 evaluator", store, failures)
    tables = parse_tables(text)
    want = ("Coarse", "Fine (mean)", "Fine (offsets)", "Fine (mean-conf)")
    ok = all(len(tables.get(t, [])) in (3, 9) and
             all(0.0 <= v <= 1.0 for v in tables[t]) for t in want)
    log(f"  13.1 evaluator --dataset K360 (f32, JAX's CLI defaults, the "
        f"bench checkpoints: they never saw this drive): {wall:.2f} s; "
        f"{ {t: tables.get(t) for t in want} } {'ok' if ok else 'FAIL'}; "
        f"launches {launches}")
    report["k360_eval"] = {"wall_s": wall, "tables": tables}
    if not ok:
        failures.append(f"13.1 K360 evaluator tables: {text[-2000:]}")

    cells, poses = legacy.load_scenes(prep_dir, [K360_SCENE])
    lines = [json.dumps({"hints": create_hint_description(p), "id": i})
             for i, p in enumerate(poses[:K360_SERVE_QUERIES])]
    made = []

    class Recorded(serving.LocalizationServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    real, serving.LocalizationServer = serving.LocalizationServer, Recorded
    store = {}
    try:
        (cli, _), wall, launches = timed(lambda: _cli(serving.main, [
            "--path_coarse", CKPT_COARSE, "--path_fine", CKPT_FINE,
            "--base_path", prep_dir, "--scenes", K360_SCENE, "--batch",
            "64", "--device", device], "\n".join(lines)), store)
    finally:
        serving.LocalizationServer = real
    by_path["k360_server"] = launches
    errs["k360_server"] = kept_checks("13.1 K360 server", store, failures)
    report["k360_lstm_forms"] = lstm_forms_check(store, failures)
    res = [json.loads(x) for x in cli.splitlines()]
    srv = made[0]
    hints = [json.loads(x)["hints"] for x in lines]
    outs = [srv.localize(hints[i:i + 64]) for i in range(0, len(hints), 64)]
    pos = np.concatenate([o["positions"] for o in outs])
    ids = sum((list(o["cell_ids"]) for o in outs), [])
    equal = (len(res) == len(lines)
             and [r["id"] for r in res] == list(range(len(lines)))
             and np.array_equal(np.array([r["position"] for r in res]),
                                pos.astype(np.float64))
             and [r["cell_id"] for r in res] == ids)
    log(f"  13.1 server CLI --base_path --scenes {K360_SCENE} (bf16, "
        f"calibrated): {len(cells)} cells, {len(res)} answers to "
        f"{len(lines)} queries from the prepared poses' descriptions in "
        f"{wall:.2f} s (build included); stream equal to localize "
        f"(serve_batch) on the same server: {equal} "
        f"{'ok' if equal else 'FAIL'}; launches {launches}")
    if not equal:
        failures.append("13.1 K360 server stream differs from localize")

    cwd = os.getcwd()
    os.chdir(scratch)
    try:
        _cli(pipeline.main, argv + ["--plot_retrievals"])
        pngs = os.listdir(os.path.join(scratch, "plots", "retrievals"))
        log(f"  13.4 --plot_retrievals: cv2 present, {len(pngs)} images")
        if not pngs:
            failures.append("13.4 --plot_retrievals wrote no image")
    except ImportError as e:
        named = "cv2" in str(e)
        log(f"  13.4 --plot_retrievals without cv2 raises ImportError "
            f"naming cv2 ({e}): {'ok (checked note)' if named else 'FAIL'}")
        if not named:
            failures.append(f"13.4 --plot_retrievals: {e}")
    finally:
        os.chdir(cwd)


# The LSTM kernel's distance from a float64 evaluation on the K360 server's
# coarse inputs, its calibration text: the shared-memory form 1.284e-5 and
# the plain f32 version 8.144e-6, where an earlier arithmetic (big parts
# truncated, three accumulator chains) lay 1.396e-4 (H100 80GB HBM3,
# 700.00 W). Both forms of the kernel now share the first arithmetic.
LSTM_F64_TOL = 2e-5


def lstm_forms_check(store, failures):
    """13.1: the LSTM kernel's two forms on the K360 server's kept coarse
    inputs (H = 256) against the plain version evaluated in float64, the
    plain f32 version beside them: as they are (W_hh in shared memory) and
    zero-padded to H = 300 (W_hh read from L2; the padded units stay 0 and
    add nothing to the real ones), each held within LSTM_F64_TOL. Returns
    {form: largest error}."""
    from text2pos_torch.ops import lstm as m
    from text2pos_torch.utils.float64 import float64_pins

    worst = {"shared": 0.0, "l2_padded_300": 0.0, "plain_f32": 0.0}
    for args in store.get(("lstm", "_lstm_kernel"), {}).values():
        tables, w_hh, tokens, lengths = args
        if w_hh[0].shape[0] != 256:
            continue
        with torch.inference_mode():
            with float64_pins():
                ref = m.lstm_final_hidden_plain(
                    [t.double() for t in tables], [w.double() for w in w_hh],
                    tokens, lengths)
            outs = {
                "shared": m._lstm_kernel(tables, w_hh, tokens, lengths),
                "l2_padded_300": m._lstm_kernel(
                    [m.pad_gates(t, 256, 300) for t in tables],
                    [m.pad_w_hh(w, 256, 300) for w in w_hh], tokens,
                    lengths)[..., :256],
                "plain_f32": m.lstm_final_hidden_plain(tables, w_hh, tokens,
                                                       lengths)}
        for k, v in outs.items():
            worst[k] = max(worst[k], float((v.double() - ref).abs().max()))
    if not worst["plain_f32"]:
        failures.append("13.1 the K360 server kept no coarse LSTM inputs")
    check(f"13.1 the LSTM kernel's shared-memory form on the K360 server's "
          f"coarse inputs against float64 (plain f32 "
          f"{worst['plain_f32']:.3e})", worst["shared"], LSTM_F64_TOL,
          failures)
    check("13.1 its L2 form on them, zero-padded to H = 300, against "
          "float64", worst["l2_padded_300"], LSTM_F64_TOL, failures)
    return worst


def last_modules_phase(bank, fx, headline_ms, failures, device="cuda"):
    """Phase 13 (``device`` "cpu" for a dry run of its pieces). Returns ({path: launches}, {path: {kernel: error}},
    report)."""
    import tempfile

    from text2pos_torch.train.state import load_checkpoint

    from text2pos_torch.config import PrepareConfig
    from text2pos_torch.constants import SCENE_SIZES

    by_path, errs, report = {}, {}, {}
    # The transformer CLI below runs in a process of its own on the same
    # card: hand back the cached blocks of the phases before.
    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory(dir=ROOT, prefix=".train_smoke_k360_")
    scratch = tmp.name
    try:
        t0 = time.time()
        points, frames = write_k360_scene(os.path.join(scratch, "k360_in"),
                                          K360_STREETS)
        X, Y, _ = SCENE_SIZES[K360_SCENE]
        log(f"  13.1 scene {K360_SCENE}: {points} points, {frames} frames "
            f"in {time.time() - t0:.1f} s; x spans the drive's {X} m, y cut "
            f"to {K360_STREETS} of its {int(Y // K360_STREET_GAP)} streets "
            f"({K360_STREETS * K360_STREET_GAP:.0f} of {Y} m: the host's "
            "prepare grows with the square of the streets)")
        t_prep = time.time()
        prep = _popen(["text2pos_torch.data.prepare", "--path_in",
                       os.path.join(scratch, "k360_in"), "--path_out",
                       os.path.join(scratch, "k360_out"), "--scene_name",
                       K360_SCENE, *K360_PREPARE_FLAGS], ROOT)
        words = load_checkpoint(CKPT_COARSE)["extra"]["known_words"]
        paths, coarse_ref, fine_ref = fabricate_reference(scratch, words)
        t_conv = time.time()
        convs = {}
        mods = {"coarse": "convert_whole_model",
                "fine": "convert_whole_model", "pointnet": "convert_torch"}
        for k, mod in mods.items():
            paths[f"conv_{k}"] = os.path.join(scratch, f"conv_{k}.msgpack")
            convs[k] = _popen([f"text2pos_torch.utils.{mod}", "--path_in",
                               paths[k], "--path_out", paths[f"conv_{k}"]],
                              ROOT)
        t_tf = time.time()
        tf = _popen(["text2pos_torch.train.transformer", "--dataset",
                     "SYNTHETIC-FINE", "--epochs", "1", "--max_batches",
                     str(TRANSFORMER_CLI_BATCHES),
                     "--device", device,
                     *[a for k, v in TRANSFORMER.items()
                       for a in (f"--{k}", str(v))]], ROOT)
        for k, p in convs.items():
            out, wall = _finish(f"13.2 converter {k}", p, t_conv, failures)
            log(f"  13.2 python -m text2pos_torch.utils.{mods[k]} ({k}): exit {p.returncode} in {wall:.1f} s: "
                f"{out.strip()[-160:]}")
        out, wall = _finish("13.3 transformer CLI", tf, t_tf, failures)
        losses = [float(ln.split()[3]) for ln in out.splitlines()
                  if ln.startswith("epoch ")]
        ok = tf.returncode == 0 and losses and all(map(math.isfinite,
                                                        losses))
        log(f"  13.3 python -m text2pos_torch.train.transformer (E="
            f"{TRANSFORMER['embed_dim']}, {TRANSFORMER['num_layers']} blocks,"
            f" batch {TRANSFORMER['batch_size']}, {TRANSFORMER_CLI_BATCHES} "
            f"steps, SYNTHETIC-FINE): exit {tf.returncode} in {wall:.1f} s; "
            f"losses {losses} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"13.3 transformer CLI: {out[-500:]}")

        if all(p.returncode == 0 for p in convs.values()):
            converted_checks(paths, coarse_ref, fine_ref, bank, fx,
                             headline_ms, by_path, errs, report, failures,
                             device)
        transformer_checks(by_path, errs, report, failures, device)

        out, wall = _finish("13.1 prepare", prep, t_prep, failures)
        counts = [ln for ln in out.splitlines() if ln.startswith("created")]
        log(f"  13.1 python -m text2pos_torch.data.prepare "
            f"{' '.join(K360_PREPARE_FLAGS)}: exit {prep.returncode} in "
            f"{wall:.1f} s (beside 13.2-13.3 on the same host); {counts}")
        report["prepare_s"] = wall
        prep_dir = os.path.join(scratch, "k360_out",
                                PrepareConfig(**K360_PREPARE).dirname)
        if not os.path.isdir(os.path.join(prep_dir, "cells")):
            failures.append(f"13.1 prepare wrote no {prep_dir}/cells")
        elif prep.returncode == 0:
            k360_checks(scratch, prep_dir, by_path, errs, report, failures,
                        device)
        for k in ("k360_eval", "k360_server"):
            if k not in by_path:
                failures.append(f"13.1 the {k} path was not run")
    finally:
        tmp.cleanup()
    return by_path, errs, report


# Phase 14: widths past JAX's defaults. A model at embed_dim 768 (the
# LSTM's grid form, H > 512; the GNN's second form on its wide route at
# E = 768) and pad_size 48 (cells of up to 48 objects: the wide route past
# 32 objects, Sinkhorn's wide form past 32 rows) from seeded generators, on
# a seeded map dense enough that most cells fill the 48 slots (48 objects
# an area: 180 of its 256 cells hold more than 48, at most 56), served at
# top-10 on 128 of its poses' descriptions. The map is one scene of the
# bench's 16 x 16 grid of 30 m cells, at 4x the bench's density.
WIDEST_E = 768
WIDEST_PAD = 48
WIDEST_SEED = 768
WIDEST_MAP = dict(seed=17, scene_name="9917", extent=480.0, cell_size=30.0,
                  poses_per_cell=1, objects_per_cell_area=48)
WIDEST_QUERIES = 128
# The larger depth gate (``widest_gate``): every pose of the map (253)
# against enough of its top cells for at least this many pose-cell pairs
# (41 cells: 10,373 pairs).
WIDEST_GATE_PAIRS = 10240
WIDEST_LSTM = (544, 768, 1024, 2048)
# Random GNN shapes: E past 512 on the tensor-core route (516, 768 at 16
# objects), E = 1024 with 64 objects, pad_size 48 and 64 at E = 300, 128
# objects at the bench width; pairs by route (the counts of PERF.md's
# kernel-table rows).
WIDEST_GNN = ((516, 16, 6), (768, 16, 6), (1024, 64, 16), (300, 48, 6),
              (300, 64, 64), (128, 128, 6))
WIDEST_GNN_PAIRS = {"superglue_gnn_any": 4096, "superglue_gnn_any_wide": 512}
# The path's launches of one serve_batch: both encoders on the LSTM's grid
# form, the GNN on its wide route, Sinkhorn's wide form; no other form.
WIDEST_LAUNCHES = {"lstm_grid": 2, "superglue_gnn_any_wide": 1,
                   "sinkhorn_wide": 1}
# The wide route's times before its redesign (a CTA a pair on scalar FMAs)
# on the path's 1,280 pairs at 12 blocks, ms by dtype: PERF.md's kernel
# table (this phase on an H100 80GB HBM3 at 700 W).
WIDEST_PARENT_MS = {"bf16": 2821.0, "f32": 727.0}
# Sinkhorn's wide form on the path's couplings before its redesign (a warp
# a coupling re-reading its scores, its duals in global memory), ms a call:
# PERF.md's kernel table (this phase on an H100 80GB HBM3 at 700 W). Only
# the log line reads it.
SINKHORN_WIDE_PARENT_MS = 0.394


def widest_map(pipe):
    """Phase 14's map and queries: the seeded dense scene (WIDEST_MAP), its
    bank of WIDEST_PAD object slots (256 points an object, seed 0) and its
    poses' descriptions tokenized as the server does (``tokenize_queries``:
    the bench vocabularies, fixed widths). Returns (bank, the first
    WIDEST_QUERIES poses' query arrays, objects a cell, every pose's query
    arrays)."""
    from text2pos_torch.data.dense import build_cell_bank
    from text2pos_torch.data.hints import create_hint_description
    from text2pos_torch.data.synthetic import make_synthetic_dataset

    cells, poses = make_synthetic_dataset(**WIDEST_MAP)
    bank = build_cell_bank(cells, WIDEST_PAD, 256, seed=0)
    hints = [create_hint_description(p) for p in poses]
    every = dict(zip(("tokens", "lengths", "hint_tokens", "hint_lengths"),
                     pipe.tokenize_queries(hints)))
    fx = {k: v[:WIDEST_QUERIES] for k, v in every.items()}
    return bank, fx, np.array([len(c.objects) for c in cells]), every


def widest_gate_pairs(pipe, every):
    """The larger depth gate's inputs: every pose of phase 14's map against
    its top-K cells of ``pipe``'s retrieval, K the fewest that give
    WIDEST_GATE_PAIRS pairs (``serve_batch`` at top-K: each cell at most
    once a pose), as ``pair_descriptors`` pairs them. Returns (d0, d1,
    top_idx [poses, K])."""
    K = -(-WIDEST_GATE_PAIRS // len(every["tokens"]))
    top = serve_all(pipe, every, K)[0]
    if any(len(set(row)) != K for row in top.tolist()):
        raise AssertionError("a pose's top cells repeat a cell")
    return (*pair_descriptors(pipe, every, top), top)


def widest_gate(pipe, every, failures):
    """14.2: ``depth_gate`` of the wide route's bf16 scores at 12 blocks on
    the top cells of every pose of the map (``widest_gate_pairs``: at least
    WIDEST_GATE_PAIRS pairs, where the 1,280 pairs of the served batch
    leave the 99.9th percentile to the two largest pairs), beside the gate
    on the served pairs. Returns its readings with the pairs and the
    seconds the reading took."""
    from text2pos_torch.ops.superglue_gnn import _gnn_kernel

    t0 = time.time()
    d0, d1, top = widest_gate_pairs(pipe, every)
    packed = pipe.fine.superglue.packed_kernel_params()
    N, T0, E = d0.shape
    route = gnn_route(E, T0, d1.shape[1], packed["wqkv"].dtype)[0]
    with torch.inference_mode():
        got = _gnn_kernel(d0, d1, packed)
    gate = gnn_depth_check(
        f"14.2 {route} bf16 every pose x top-{top.shape[1]} N={N} "
        f"{T0}x{d1.shape[1]} E={E} blocks={packed['wqkv'].shape[0]}", got,
        d0, d1, packed, failures)
    torch.cuda.synchronize()
    sec = time.time() - t0
    log(f"  14.2 the gate on {N} pairs took {sec:.1f} s (serving the "
        f"{len(every['tokens'])} poses at top-{top.shape[1]}, the kernel "
        f"at 12 and {DEPTH_CUT_BLOCKS} blocks, the plain version and the "
        f"float64 evaluation in chunks of 4096 pairs)")
    return dict(gate, pairs=N, seconds=sec)


def widest_lstm_f64(pipe, fx, pipe_bench, fx_bench, failures):
    """14.2: the LSTM's grid form against the plain recurrence evaluated in
    float64, the plain f32 version beside it, each within LSTM_F64_TOL: on
    the phase-14 path's text and hints (H = 768) and on the bench coarse
    text encoder (H = 256) zero-padded to 768 and 1024 over the 2048 bench
    queries (the padded units stay 0 and add nothing to the real ones).
    Returns {input: (kernel, plain f32) largest error}."""
    from text2pos_torch.ops import lstm as m
    from text2pos_torch.utils.float64 import float64_pins

    dev = pipe.device
    cases = {}
    for label, enc, tok, ln in (
            ("path text", pipe.coarse.language_encoder, fx["tokens"],
             fx["lengths"]),
            ("path hints", pipe.fine.language_encoder,
             fx["hint_tokens"].reshape(-1, fx["hint_tokens"].shape[-1]),
             fx["hint_lengths"].reshape(-1))):
        with torch.inference_mode():
            tables = enc.token_tables()
            w_hh = [enc._params(d).w_hh for d in ("fwd", "bwd")]
        cases[label] = (tables, w_hh, torch.as_tensor(tok, device=dev),
                        torch.as_tensor(ln, device=dev), None)
    enc = pipe_bench.coarse.language_encoder
    with torch.inference_mode():
        tables = enc.token_tables()
        w_hh = [enc._params(d).w_hh for d in ("fwd", "bwd")]
    H = w_hh[0].shape[0]
    for width in (768, 1024):
        cases[f"bench text padded from {H} to {width}"] = (
            [m.pad_gates(t, H, width) for t in tables],
            [m.pad_w_hh(w, H, width) for w in w_hh],
            torch.as_tensor(fx_bench["tokens"], device=dev),
            torch.as_tensor(fx_bench["lengths"], device=dev), H)
    out = {}
    for label, (tables, w_hh, tok, ln, real) in cases.items():
        with torch.inference_mode():
            with float64_pins():
                ref = m.lstm_final_hidden_plain(
                    [t.double() for t in tables], [w.double() for w in w_hh],
                    tok, ln)[..., :real]
            got = m._lstm_kernel(tables, w_hh, tok, ln)[..., :real]
            plain = m.lstm_final_hidden_plain(tables, w_hh, tok,
                                              ln)[..., :real]
        err = float((got.double() - ref).abs().max())
        perr = float((plain.double() - ref).abs().max())
        check(f"14.2 lstm_grid H={w_hh[0].shape[0]} on {label} "
              f"(B={len(tok)}, T={tok.shape[1]}) against float64 (plain "
              f"f32 {perr:.3e})", err, LSTM_F64_TOL, failures)
        out[label] = (err, perr)
    return out


def widest_sinkhorn_line(r, B, M, N):
    """14.2: ``sinkhorn_wide`` on the path's B couplings of M x N beside its
    time before the redesign, its bound and the plain version's, with its
    plan's route."""
    from text2pos_torch.ops.sinkhorn import wide_plan

    p = wide_plan(M, N)
    before = SINKHORN_WIDE_PARENT_MS
    log(f"  14.2 sinkhorn_wide [{B}, {M}, {N}]: {r['ms']:.4f} ms a call "
        f"({r['device_ms']:.4f} ms of device in a CUDA graph) against "
        f"{before:.3f} a call before the redesign (PERF.md; "
        f"{before / r['ms']:.1f}x), bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}; "
        f"{100 * r['bound_ms'] / r['ms']:.1f}%), plain {r['plain_ms']:.3f} "
        f"ms; route {p.route}, {p.couplings} couplings a CTA, {p.smem} B of "
        "shared memory")


def widest_route_line(gnn, N, T1):
    """14.2: the wide route on the path's N pose-cell pairs of T1 hints, by
    dtype: its plan (pairs a CTA, rows), its workspace and the part of it
    its CTAs re-read within a product, its time beside the plain
    version's, its bound and the route's time before its redesign
    (WIDEST_PARENT_MS)."""
    from text2pos_torch.ops import superglue_gnn as tgnn

    out = {}
    for label, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        plan = tgnn.any_plan(WIDEST_E, WIDEST_PAD, T1, dt)
        r = gnn[label]
        ws = tgnn.any_workspace_bytes(WIDEST_E, WIDEST_PAD, T1, plan, N,
                                      int(dt == torch.bfloat16),
                                      torch.device("cuda"))
        hot = tgnn.wide_hot_bytes(plan.width, plan.rows, dt)
        log(f"  14.2 {plan.route} {label} ({WIDEST_E}, {WIDEST_PAD}, {T1}), "
            f"{N} pairs: {plan.pairs} pairs a CTA, {plan.rows} rows, "
            f"workspace {ws / 1e6:.1f} MB ({hot / 1e6:.1f} MB re-read "
            f"within a product); kernel {r['ms']:.2f} ms, plain "
            f"{r['plain_ms']:.2f} ms, bound {r['bound_ms']:.2f} ms "
            f"({100 * r['bound_share']:.1f}%); before the redesign "
            f"{WIDEST_PARENT_MS[label]:.1f} ms (PERF.md)")
        out[label] = {"pairs": plan.pairs, "rows": plan.rows,
                      "workspace_bytes": ws, "reread_bytes": hot,
                      "ms": r["ms"], "plain_ms": r["plain_ms"],
                      "bound_ms": r["bound_ms"],
                      "parent_ms": WIDEST_PARENT_MS[label]}
    return out


def widest_phase(pipe_bf16, fx_bench, failures, device="cuda"):
    """Phase 14 (see the module's docstring; ``device`` "cpu" and a bench
    pipeline on the CPU for a dry run of its pieces). Returns ({path:
    launches}, the kernel readings, the report)."""
    from text2pos_torch.ops import _build

    t0 = time.time()
    bank, fx, counts, every = widest_map(pipe_bf16)
    Q, T = fx["tokens"].shape
    log(f"  14.1 map {WIDEST_MAP}: {bank.num_cells} cells, objects a cell "
        f"median {np.median(counts):.0f}, most {counts.max()}, "
        f"{int((counts > WIDEST_PAD).sum())} cells past {WIDEST_PAD} (cut to "
        f"the pad), {int(bank.mask.sum())} objects in the bank; {Q} queries "
        f"of {int(fx['lengths'].min())}-{int(fx['lengths'].max())} tokens, "
        f"hints {fx['hint_tokens'].shape}; built in {time.time() - t0:.1f} s")
    if counts.max() <= WIDEST_PAD:
        failures.append(f"14.1 no cell of the map holds more than "
                        f"{WIDEST_PAD} objects")
    report, by_path, pipes, served = {}, {}, {}, {}
    for label, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        pipe, db, enc_s, cal_s = wide_pipeline(pipe_bf16, bank, fx, dtype,
                                               pad=WIDEST_PAD,
                                               width=WIDEST_E,
                                               seed=WIDEST_SEED)
        pipes[label] = pipe
        by_path[f"widest_db_encode_{label}"] = db
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        ti, po, first_s = serve_all(pipe, fx, TOP_K)        # the path's run
        launches = dict(_build.LAUNCHES)
        by_path[f"widest_serve_{label}"] = launches
        ti, po, sec = serve_all(pipe, fx, TOP_K, reps=2)
        served[label] = ti
        log(f"  14.1 E={WIDEST_E} pad_size {WIDEST_PAD} {label}: DB encode "
            f"{enc_s:.3f} s (launches {db}), calibration {cal_s:.3f} s; "
            f"{Q} queries x top-{TOP_K} in {sec * 1e3:.1f} ms = "
            f"{Q / sec:.2f} q/s (first call {first_s * 1e3:.1f} ms); "
            f"launches of one batch {launches}")
        report[f"serve_{label}"] = {"ms": sec * 1e3, "qps": Q / sec,
                                    "first_ms": first_s * 1e3,
                                    "launches": launches,
                                    "db_encode_s": enc_s,
                                    "calibrate_s": cal_s}
        if not np.isfinite(po).all() or ti.shape != (Q, TOP_K):
            failures.append(f"14.1 serve {label}: malformed output")
        if any(launches.get(k, 0) != n for k, n in WIDEST_LAUNCHES.items()) \
                or any(launches.get(k, 0) for k in (
                    "lstm", "sinkhorn", "superglue_gnn", "superglue_gnn_any")):
            failures.append(f"14.1 serve {label}: launches {launches}, want "
                            f"{WIDEST_LAUNCHES} and no other form")
        if db.get("pointconv", 0) < 1 or db.get("fps", 0) < 1:
            failures.append(f"14.1 DB encode {label}: launches {db}")
    pipe = pipes["f32"]
    with plain_kernels():
        pti, ppo, psec = serve_all(pipe, fx, TOP_K)
    ti, po, _ = serve_all(pipe, fx, TOP_K)
    log(f"  14.1 f32 headline against the plain versions: kernels "
        f"{report['serve_f32']['ms']:.1f} ms, plain versions "
        f"{psec * 1e3:.1f} ms; positions max difference "
        f"{float(np.abs(po - ppo).max()):.3e}")
    report_swaps("widest f32 headline (\"JAX\" in the notes: the plain "
                 "versions)", headline_swaps(pipe, fx, ti, pti), len(ti),
                 failures, "the plain versions'")
    report["f32_plain_ms"] = psec * 1e3

    readings = {"lstm": lstm_checks(pipes["bf16"], fx, failures)}
    readings["lstm_f64"] = widest_lstm_f64(pipes["bf16"], fx, pipe_bf16,
                                           fx_bench, failures)
    readings["gnn"] = gnn_sinkhorn_checks(pipes["bf16"], pipes["f32"], fx,
                                          failures, top_idx=served["bf16"],
                                          reps=1)
    readings["gnn_wide"] = widest_route_line(readings["gnn"],
                                             served["bf16"].size,
                                             fx["hint_tokens"].shape[1])
    readings["gnn_gate"] = widest_gate(pipes["bf16"], every, failures)
    widest_sinkhorn_line(readings["gnn"]["sinkhorn"],
                         served["bf16"].size, WIDEST_PAD + 1,
                         fx["hint_tokens"].shape[1] + 1)
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(14)
    tokens = torch.as_tensor(fx_bench["tokens"], device=dev)
    lengths = torch.as_tensor(fx_bench["lengths"], device=dev)
    readings["lstm_widths"] = [
        lstm_random_check(H, tokens, lengths, g, failures, "14.3")
        for H in WIDEST_LSTM]
    readings["gnn_shapes"] = []
    for E, T0, T1 in WIDEST_GNN:
        pairs = {label: WIDEST_GNN_PAIRS[gnn_route(E, T0, T1, dt)[0]]
                 for label, dt in (("bf16", torch.bfloat16),
                                   ("f32", torch.float32))}
        d0, d1 = random_descs(max(pairs.values()), T0, T1, E, g, dev)
        row = {"E": E, "T0": T0, "T1": T1}
        for label, N in pairs.items():
            row[label] = dict(gnn_random_check(
                E, T0, T1, d0[:N].contiguous(), d1[:N].contiguous(), label,
                failures, "14.3"), N=N)
        readings["gnn_shapes"].append(row)
    return by_path, readings, report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 2
    missing = [p for p in (CKPT_COARSE, CKPT_FINE, DB_CACHE, FIXTURE,
                           DB_FIXTURE, TRAIN_FIXTURE, EVAL_FIXTURE,
                           CKPT_POINTNET, RECIPE_FIXTURE)
               if not os.path.isfile(p)]
    try:
        from text2pos_torch.data.bench import (bench_cell_bank,
                                               make_bench_dataset)
        from text2pos_torch.evaluation.metrics import served_accuracies
        from text2pos_torch.evaluation.pipeline import (LocalizationPipeline,
                                                        bank_tensors)
        from text2pos_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the text2pos_torch package is missing ({e}); "
              "run from a checkout of the repository", file=sys.stderr)
        return 2
    if missing:
        print(f"chip_smoke: missing {missing}", file=sys.stderr)
        return 2
    assert "jax" not in sys.modules, "the port imported jax"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures: list = []
    t_start = time.time()

    gpu = gpu_line()
    log(f"phase 1 device: {gpu}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t0 = time.time()
    took = _build.build_all()
    log(f"phase 2 build: {len(took)} kernels built in {time.time() - t0:.1f}"
        f" s ({', '.join(f'{k} {v:.1f}s' for k, v in took.items())}) into "
        f"{_build.build_dir()}")
    for name in _build.SOURCES:
        kernel = ""
        for line in _build.build_log(name).splitlines():
            found = re.search(r"Compiling entry function '(\w+)'", line)
            if found:
                kernel = kernel_name(found.group(1))
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name} {kernel}: {line.strip()}")
                if "spill" in line and \
                        "0 bytes spill stores, 0 bytes spill loads" not in line:
                    failures.append(f"ptxas reports spills in {name} "
                                    f"{kernel}: {line.strip()}")

    fx = dict(np.load(FIXTURE))
    t0 = time.time()
    pipe_bf16 = LocalizationPipeline.from_checkpoints(
        CKPT_COARSE, CKPT_FINE, DB_CACHE, dtype="bfloat16", device="cuda")
    pipe_f32 = LocalizationPipeline.from_checkpoints(
        CKPT_COARSE, CKPT_FINE, DB_CACHE, dtype="float32", device="cuda")
    log(f"checkpoints loaded by the port's reader in "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    cells, poses = make_bench_dataset()
    bank = bench_cell_bank(cells)
    scenes = np.array([c.split("_")[0] for c in bank.cell_ids])
    same_map = (np.array_equal(bank.bbox_w[:, 0:2], fx["cell_bbox_xy"])
                and np.array_equal(bank.cell_size, fx["cell_size"])
                and np.array_equal(scenes, fx["cell_scene"]))
    log(f"bench map rebuilt by the port's generator in {time.time() - t0:.1f}"
        f" s: {bank.num_cells} cells, {int(bank.mask.sum())} objects; cell "
        f"boxes, sizes and scenes equal the fixture's: {same_map}")
    if not same_map:
        failures.append("the rebuilt bench map differs from the fixture's")
    bt = bank_tensors(bank, pipe_bf16.device)
    dbx = dict(np.load(DB_FIXTURE))

    log("phase 3 kernels vs plain (the serving and DB-encode paths' inputs)")
    lstm = lstm_checks(pipe_bf16, fx, failures)
    gs = gnn_sinkhorn_checks(pipe_bf16, pipe_f32, fx, failures)
    fps = fps_checks(bt, dbx, failures)
    pointconv = pointconv_checks(pipe_bf16, pipe_f32, bt, dbx, failures)

    log("phase 4 end to end: serve_batch on the committed bench queries")
    Q = fx["tokens"].shape[0]
    serve_all(pipe_bf16, fx, TOP_K)                      # warm-up
    _build.LAUNCHES.clear()
    top_idx, pos, _ = serve_all(pipe_bf16, fx, TOP_K)    # the main path
    launches = dict(_build.LAUNCHES)
    log(f"  kernel launches in one headline serve_batch: {launches}")
    profile_serve(pipe_bf16, fx)
    for name in ("lstm", "sinkhorn", "superglue_gnn"):
        if launches.get(name, 0) < 1:
            failures.append(f"kernel {name} was not launched on the main "
                            "path")
    if launches.get("lstm", 0) != 2:
        failures.append(f"the LSTM kernel ran {launches.get('lstm', 0)} "
                        "times in a headline batch, not 2 (one per encoder)")
    jax_t10 = float(fx["jax_top10_at_15m"])
    headline_ms = {}
    for label, pipe in (("bf16", pipe_bf16), ("f32", pipe_f32)):
        ti, po, sec = serve_all(pipe, fx, TOP_K, reps=5)
        headline_ms[label] = sec * 1e3
        accs = served_accuracies(fx, ti, po, (1, 5, TOP_K))
        same = float((ti == fx["jax_top_idx"]).mean())
        dpos = np.abs(po - fx["jax_pos_offsets"].astype(np.float32)).max(-1)
        perr = float(dpos.max())
        close = float((dpos <= POS_CLOSE).mean())
        finite = bool(np.isfinite(po).all())
        log(f"  serve {label}: {Q} queries x top-{TOP_K} in {sec * 1e3:.2f}"
            f" ms = {Q / sec:.1f} q/s; top-10@15m {accs[TOP_K][15]:.4f} "
            f"(JAX {jax_t10:.4f}), top-1@15m {accs[1][15]:.4f} (JAX "
            f"{float(fx['jax_top1_at_15m']):.4f}); identical top_idx "
            f"{same:.4f}; in-cell positions vs JAX: max error {perr:.4g}, "
            f"share within 0.01 {close:.4f}")
        kinds, replay = classify_positions(pipe, fx, ti, po)
        log(f"  serve {label}: in-cell positions past {POS_CLOSE:g} of "
            f"JAX's: " + ", ".join(f"{k} {len(v)}" for k, v in
                                   kinds.items())
            + f" (recomputed positions within {replay:g} float16 steps "
            "of the served)")
        for kind, rows in kinds.items():
            for r, k, e, note in rows if label == "f32" else rows[:5]:
                log(f"    query {r} candidate {k} ({kind}): {e:.4g} from "
                    f"JAX's; {note}")
        if label == "f32" and (kinds["unexplained"] or replay > 1):
            failures.append(f"serve {label}: in-cell positions past "
                            f"{POS_CLOSE:g} of JAX's that no near-tie "
                            f"explains: {kinds['unexplained']} (recomputed "
                            f"within {replay:g} float16 steps of the "
                            "served)")
        if not finite or ti.shape != fx["jax_top_idx"].shape:
            failures.append(f"serve {label}: malformed output")
        if abs(accs[TOP_K][15] - jax_t10) > ACC_SLACK:
            failures.append(f"serve {label}: top-10@15m {accs[TOP_K][15]} "
                            f"vs JAX {jax_t10}")
        if label == "f32" and same < 1.0:
            failures.append(f"serve f32: top_idx differs from JAX ({same})")
    gnn_f32 = gs["f32"]["ms"]
    log(f"  headlines (median of 5): bf16 {headline_ms['bf16']:.2f} ms, f32 "
        f"{headline_ms['f32']:.2f} ms; the tuned f32 GNN kernel on its "
        f"pairs {gnn_f32:.2f} ms ({100 * gnn_f32 / headline_ms['f32']:.1f}% "
        "of the f32 headline)")

    rk, lam, gam = fx["rerank"]
    ti, po, sec = serve_all(pipe_bf16, fx, TOP_K, int(rk), float(lam),
                            float(gam), reps=3)
    accs = served_accuracies(fx, ti, po, (1, 5, TOP_K))
    jax_rr = float(fx["jax_rerank_top10_at_15m"])
    log(f"  serve bf16 rerank@{int(rk)} (lambda={lam:g}, gamma={gam:g}): "
        f"{Q} queries in {sec * 1e3:.1f} ms = {Q / sec:.1f} q/s; "
        f"top-10@15m {accs[TOP_K][15]:.4f} (JAX {jax_rr:.4f}); identical "
        f"top_idx {float((ti == fx['jax_rerank_top_idx']).mean()):.4f}")
    if abs(accs[TOP_K][15] - jax_rr) > ACC_SLACK:
        failures.append(f"rerank: top-10@15m {accs[TOP_K][15]} vs JAX "
                        f"{jax_rr}")
    f32_rerank_check(pipe_f32, fx, failures)
    cascade = cascade_checks(pipe_bf16, pipe_f32, fx, failures)

    log("phase 5 offline DB encode")
    db_subset_checks(pipe_bf16, pipe_f32, bt, dbx, failures)
    db, cell_enc = db_encode_and_serve(pipe_bf16, bank, bt, fx, top_idx,
                                       failures)
    by_path = {"serve": dict(launches), "cascade": cascade["launches"],
               "db_encode": db}
    for name in ("fps", "pointconv"):
        launches[name] = db.get(name, 0)

    log("phase 6 calibrate and serve")
    by_path.update(calibrate_and_serve(cells, poses, bank, cell_enc, fx,
                                       failures))

    log("phase 7 train")
    t0 = time.time()
    train_paths, train_report = train_phase(gpu, failures)
    by_path.update(train_paths)
    log(f"  phase 7 took {time.time() - t0:.1f} s")

    log("phase 8 evaluation")
    t0 = time.time()
    eval_paths, eval_errs = eval_phase(cells, poses, failures)
    by_path.update(eval_paths)
    log(f"  phase 8 took {time.time() - t0:.1f} s")

    log("phase 9 the recipe's training")
    t0 = time.time()
    recipe_paths, recipe_errs, _ = recipe_phase(gpu, failures)
    by_path.update(recipe_paths)
    log(f"  phase 9 took {time.time() - t0:.1f} s")

    log("phase 10 data parallelism")
    t0 = time.time()
    dp_paths, dp_errs, dp_report = dp_phase(gpu, pipe_bf16, pipe_f32, bank,
                                            fx, failures)
    by_path.update(dp_paths)
    log(f"  phase 10 took {time.time() - t0:.1f} s; "
        f"{json.dumps(dp_report)}")

    log("phase 12 JAX's default widths and the variants")
    t0 = time.time()
    wide_paths, wide, wide_report = widths_phase(pipe_bf16, bank, fx,
                                                 failures)
    by_path.update(wide_paths)
    launches["superglue_gnn_any"] = wide_paths["wide_serve_bf16"].get(
        "superglue_gnn_any", 0)
    log(f"  phase 12 took {time.time() - t0:.1f} s; "
        f"{json.dumps(wide_report, default=float)}")

    log("phase 13 the last modules")
    t0 = time.time()
    last_paths, last_errs, last_report = last_modules_phase(
        bank, fx, headline_ms, failures)
    by_path.update(last_paths)
    log(f"  phase 13 took {time.time() - t0:.1f} s; "
        f"{json.dumps(last_report, default=float)}")

    log("phase 14 widths past JAX's defaults")
    t0 = time.time()
    widest_paths, widest, widest_report = widest_phase(pipe_bf16, fx,
                                                       failures)
    by_path.update(widest_paths)
    for name in ("lstm_grid", "sinkhorn_wide"):
        launches[name] = widest_paths["widest_serve_bf16"].get(name, 0)
    log(f"  phase 14 took {time.time() - t0:.1f} s; "
        f"{json.dumps(widest_report, default=float)}")

    gnn = dict(gs["bf16"], f32=gs["f32"], cascade_cheap_pass={
        k: {"ms": v["gnn_ms"], "bound_ms": v["gnn_bound_ms"],
            "dequant_ms": v["dequant_ms"]}
        for k, v in cascade["kernels"].items()})
    sinkhorn = dict(gs["sinkhorn"], cascade_cheap_pass={
        k: {"ms": v["sinkhorn_ms"], "bound_ms": v["sinkhorn_bound_ms"]}
        for k, v in cascade["kernels"].items()})
    fn = train_report.get("functions", {})
    lstm = dict(lstm, train_function={
        k[5:]: v for k, v in fn.items() if k.startswith("lstm_")})
    sinkhorn = dict(sinkhorn, train_function=fn.get("sinkhorn_fine"))
    lstm["widths"] = {"path_E300": wide["lstm"],
                      "random": wide["lstm_widths"]}
    fps["widths"] = wide["fps_widths"]
    gnn_any = dict(wide["gnn"]["bf16"], f32=wide["gnn"]["f32"],
                   widths=wide["gnn_shapes"],
                   pad_paths=wide["gnn_pad_paths"],
                   sinkhorn_E300=wide["gnn"]["sinkhorn"],
                   routes=gnn_routes(wide, by_path, widest))
    lstm_grid = dict(widest["lstm"], widths=widest["lstm_widths"],
                     float64={k: {"max_abs_err": e, "plain_f32": p}
                              for k, (e, p) in widest["lstm_f64"].items()})
    per_kernel = {"lstm": lstm, "sinkhorn": sinkhorn,
                  "superglue_gnn": gnn, "superglue_gnn_any": gnn_any,
                  "pointconv": pointconv, "fps": fps, "lstm_grid": lstm_grid,
                  "sinkhorn_wide": widest["gnn"]["sinkhorn"]}
    kernels = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches.get(name, 0),
                 "launches_by_path": {p: n.get(name, 0)
                                      for p, n in by_path.items()},
                 "max_abs_err_by_evaluator_path": eval_errs.get(name, {}),
                 "max_abs_err_by_training_path": recipe_errs.get(name, {}),
                 "max_abs_err_by_dp_path": dp_errs.get(name, {}),
                 "max_abs_err_by_last_modules_path": {
                     p: e[name] for p, e in last_errs.items() if name in e}}
        entry.update(per_kernel[name])
        kernels.append(entry)
    log(f"total {time.time() - t_start:.1f} s; failures: {failures or 'none'}")
    if failures:
        for f in failures:
            print(f"chip_smoke: FAIL {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
