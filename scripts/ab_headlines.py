#!/usr/bin/env python3
"""The earlier paths of two source trees, held against each other on one
card: the bench bf16 and f32 headlines and the E = 300 bf16 headline (chip_smoke's
``serve_all`` after a warm-up, the median of 5 synchronized
``serve_batch`` calls of the 2048 bench queries at top-10; the E = 300
pipeline is chip_smoke's ``wide_pipeline``) and the LSTM kernel's cluster
forms at H = 128, 256, 300, 384 and 512 on seeded random weights over the
bench queries' tokens.

    cd TREE && python3 PATH/TO/scripts/ab_headlines.py TAG OUTDIR
    python3 scripts/ab_headlines.py --compare OUTDIR

The first form runs in the root of a tree (this checkout, or another
commit's ``text2pos_torch`` and ``chip_smoke.py`` unpacked with ``git
archive``, with its ``checkpoints`` linked to this one's): it builds that
tree's kernels, prints one JSON line with the build's seconds and the
headlines' ms, and saves the outputs to ``OUTDIR/ab_TAG.pt``. Run it for
the two trees in turns (A, B, B, A) in one process each on one card. The
second form compares every saved run with the first by name: whether the
LSTM outputs and the headlines' ``top_idx`` and positions are
bit-identical.

Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import time


def run(tag: str, outdir: str) -> None:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from text2pos_torch.data.bench import bench_cell_bank, make_bench_dataset
    from text2pos_torch.evaluation.pipeline import LocalizationPipeline
    from text2pos_torch.ops import _build
    from text2pos_torch.ops import lstm as tlstm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    _build.build_all()
    res = {"tag": tag, "build_s": time.time() - t0}
    fx = dict(np.load(cs.FIXTURE))
    dev = torch.device("cuda")
    saved = {}
    tokens = torch.as_tensor(fx["tokens"], device=dev)
    lengths = torch.as_tensor(fx["lengths"], device=dev)
    V = int(tokens.max()) + 1
    with torch.inference_mode():
        for H in (128, 256, 300, 384, 512):
            g = torch.Generator(device=dev).manual_seed(H)
            tables = [torch.randn(V, 4 * H, device=dev, generator=g) * 0.3
                      for _ in range(2)]
            w_hh = [(torch.rand(H, 4 * H, device=dev, generator=g) * 2 - 1)
                    / H ** 0.5 for _ in range(2)]
            saved[f"lstm_{H}"] = tlstm._lstm_kernel(tables, w_hh, tokens,
                                                    lengths).cpu()
    pipe = LocalizationPipeline.from_checkpoints(
        cs.CKPT_COARSE, cs.CKPT_FINE, cs.DB_CACHE, dtype="bfloat16",
        device="cuda")
    cs.serve_all(pipe, fx, cs.TOP_K)
    ti, po, sec = cs.serve_all(pipe, fx, cs.TOP_K, reps=5)
    res["bench_bf16_ms"] = sec * 1e3
    saved["bench_top_idx"], saved["bench_pos"] = (torch.as_tensor(ti),
                                                  torch.as_tensor(po))
    pipe32 = LocalizationPipeline.from_checkpoints(
        cs.CKPT_COARSE, cs.CKPT_FINE, cs.DB_CACHE, dtype="float32",
        device="cuda")
    cs.serve_all(pipe32, fx, cs.TOP_K)
    ti, po, sec = cs.serve_all(pipe32, fx, cs.TOP_K, reps=5)
    res["bench_f32_ms"] = sec * 1e3
    saved["bench_f32_top_idx"], saved["bench_f32_pos"] = (
        torch.as_tensor(ti), torch.as_tensor(po))
    del pipe32
    cells, _ = make_bench_dataset()
    wide = cs.wide_pipeline(pipe, bench_cell_bank(cells), fx,
                            torch.bfloat16)[0]
    cs.serve_all(wide, fx, cs.TOP_K)
    ti, po, sec = cs.serve_all(wide, fx, cs.TOP_K, reps=5)
    res["e300_bf16_ms"] = sec * 1e3
    saved["e300_top_idx"], saved["e300_pos"] = (torch.as_tensor(ti),
                                                torch.as_tensor(po))
    os.makedirs(outdir, exist_ok=True)
    torch.save(saved, os.path.join(outdir, f"ab_{tag}.pt"))
    print(json.dumps(res))


def compare(outdir: str) -> None:
    import torch

    runs = {os.path.basename(p)[3:-3]: torch.load(p)
            for p in sorted(glob.glob(os.path.join(outdir, "ab_*.pt")))}
    tags = sorted(runs)
    ref = runs[tags[0]]
    for t in tags[1:]:
        print(t, "vs", tags[0], {k: bool(torch.equal(runs[t][k], ref[k]))
                                 for k in ref})


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--compare":
        compare(sys.argv[2])
    elif len(sys.argv) == 3:
        run(sys.argv[1], sys.argv[2])
    else:
        sys.exit(__doc__)
