#!/usr/bin/env python3
"""The GNN second form's wide route (``csrc/superglue_gnn_any.cu``,
namespace ``wide``) against a float64 evaluation where it serves: chip_smoke
phase 14's path inputs, the E = 768, pad_size 48 pipelines
(``widest_map``, ``wide_pipeline``) of two model seeds (WIDEST_SEED and
WIDEST_SEED + 10: 768, 778), at (768, 48, 6), 12 blocks, on two sets of
pose-cell pairs: the 1,280 of the bf16 headline's top-10 (128 poses), and
10,373: every pose of the map (253) against its top-41 cells of the bf16
pipeline's retrieval (``widest_gate_pairs``, phase 14's larger gate),
where the 99.9th percentile of the per-pair errors no longer rests on the
two largest pairs. For this tree's build, and
for another tree's ``csrc`` built beside it when one is given (the parent's,
unpacked with ``git archive <commit> text2pos_torch/csrc``), prints the
bf16 scores' ``depth_gate`` readings (a)-(d) (median, 99.9th percentile
and largest per-pair error against the float64 evaluation, beside the
plain f32 version's, and the 2-block cut against the plain version) and
the f32 scores' largest error against the plain version and against
float64, with each launch's wall time and each reading's (inputs, the
kernel, the plain version and the float64 evaluation in chunks).

    python3 scripts/check_gnn_wide_sums.py [OTHER_CSRC]

Needs a CUDA card and ``nvcc``; exits 1 if a gate of this tree's build
fails.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from text2pos_torch.evaluation.pipeline import LocalizationPipeline  # noqa: E402
from text2pos_torch.ops import _build  # noqa: E402
from text2pos_torch.ops import superglue_gnn as tgnn  # noqa: E402


def other_library(csrc: Path) -> ctypes.CDLL:
    """``superglue_gnn_any.cu`` of another tree's ``csrc``, built as the
    port builds its own."""
    tmp = tempfile.mkdtemp()
    for name in ("superglue_gnn_any.cu", "mma_bf16.cuh"):
        shutil.copy(csrc / name, tmp)
    so = os.path.join(tmp, "libother.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
                           os.path.join(tmp, "superglue_gnn_any.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    return ctypes.CDLL(so)


def readings(seed, d0, d1, pipes, libs, own, t0):
    """Prints the bf16 depth gate and the f32 errors on the pairs d0, d1
    for each library; returns the gates of this tree's build that fail."""
    failed = []
    N = len(d0)
    for label in ("bf16", "f32"):
        packed = pipes[label].fine.superglue.packed_kernel_params()
        cut = cs.first_blocks(packed)
        with torch.inference_mode():
            plain = tgnn.gnn_scores_plain(d0, d1, packed)
            cut_plain = tgnn.gnn_scores_plain(d0, d1, cut)
            ref = cs.f64_scores(d0, d1, packed)
        for name, lib in libs.items():
            # The wrapper launches whichever library the build cache
            # holds under the source's name.
            _build._LIBS["superglue_gnn_any"] = lib
            with torch.inference_mode():
                t1 = time.time()
                got = tgnn._gnn_kernel(d0, d1, packed)
                torch.cuda.synchronize()
                ms = 1e3 * (time.time() - t1)
                if label == "bf16":
                    cut_got = tgnn._gnn_kernel(d0, d1, cut)
                    torch.cuda.synchronize()
            _build._LIBS["superglue_gnn_any"] = own
            took = time.time() - t0
            if label == "bf16":
                ok, r = cs.depth_gate(got, plain, ref, cut_got, cut_plain)
                print(f"seed {seed}, {N} pairs, bf16 {name}: {ms:.0f} ms; "
                      f"depth gate {'pass' if ok else 'FAIL'} (median ratio "
                      f"{r['median'] / r['plain_median']:.4f}; reading "
                      f"{took:.1f} s): {cs.depth_gate_line(r)}", flush=True)
                if not ok and name == "this tree":
                    failed.append(f"seed {seed} {N} pairs bf16")
                continue
            tol = cs.GNN_REL_TOL["f32"]
            e = float((got - plain).abs().max()) / (
                tol * float(plain.abs().max()))
            e64, p64 = (float((x.double() - ref).abs().max()) / (
                tol * float(ref.abs().max())) for x in (got, plain))
            print(f"seed {seed}, {N} pairs, f32 {name}: {ms:.0f} ms; from "
                  f"the plain version {e:.3f} of GNN_REL_TOL, from float64 "
                  f"{e64:.3f} (the plain version {p64:.3f}; reading "
                  f"{took:.1f} s)", flush=True)
            if e > 1 and name == "this tree":
                failed.append(f"seed {seed} {N} pairs f32")
    return failed


def main(argv) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_line())
    _build.build_all()
    own = _build.library("superglue_gnn_any")
    libs = {"this tree": own}
    if argv:
        libs["other tree"] = other_library(Path(argv[0]))
    bench = LocalizationPipeline.from_checkpoints(
        cs.CKPT_COARSE, cs.CKPT_FINE, cs.DB_CACHE, dtype="bfloat16",
        device="cuda")
    bank, qx, _, every = cs.widest_map(bench)
    failed = []
    for seed in (cs.WIDEST_SEED, cs.WIDEST_SEED + 10):
        pipes = {label: cs.wide_pipeline(bench, bank, qx, dt,
                                         pad=cs.WIDEST_PAD,
                                         width=cs.WIDEST_E, seed=seed)[0]
                 for label, dt in (("bf16", torch.bfloat16), ("f32", None))}
        for count in ("served", "every pose"):
            t0 = time.time()
            if count == "served":
                top = cs.serve_all(pipes["bf16"], qx, cs.TOP_K)[0]
                d0, d1 = cs.pair_descriptors(pipes["bf16"], qx, top)
            else:
                d0, d1, _ = cs.widest_gate_pairs(pipes["bf16"], every)
            failed += readings(seed, d0, d1, pipes, libs, own, t0)
    print(f"gates failed: {failed or 'none'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
