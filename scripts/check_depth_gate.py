#!/usr/bin/env python3
"""Seeded defects in the inputs of the GNN's second form (bf16 route, 12
blocks), read by the earlier 12-block gates and by chip_smoke's
``depth_gate``: whether the new gate catches every defect the old one did.

    python3 scripts/check_depth_gate.py

Builds the port's kernels, the bench pipeline and chip_smoke's E = 300
bf16 serving pipelines at pad_size 16 and 24 (``wide_pipeline``: seeded
models calibrated on the bench map), then takes the headline's 20,480
pose-cell pairs (the fixture's top-10 cells) with their hints. For each
pad_size, the inputs as they are, then each defect applied to the
kernel's inputs only (the plain f32 version and the float64 evaluation
keep the untouched ones; no program file changes):

1. the query columns of head 0 (weights and bias) of one block scaled by
   1.01, in block 0 (inside the cut depth) and in block 10;
2. one block's merge bias moved along a seeded direction by 1% of its
   norm or, where that is smaller (the seeded models' biases are 0), of
   the norm a unit-norm message row gets through the merge weights, in
   block 1 and in block 11;
3. hint row 0 of pair N/2 zeroed;
4. pair N/2 given pair N/2 + 1's object descriptors.

For each it prints the old gate's verdict (pad_size 16: within GNN_REL_TOL
of the plain version, the earlier ``gnn_sinkhorn_checks``; pad_size 24:
that, or no farther from float64 than the plain version in the largest
per-pair error and the pairs past the tolerance, the earlier
``gnn_depth_check``), the new gate's readings and verdict, how far the
defect moved the kernel's scores (per pair, the largest change over
GNN_REL_TOL of the float64 scores' largest: median and largest), and a
table at the end. The old gate catches a defect where it fails the
defective inputs and passes the inputs as they are. Exits 1 if the
inputs as they are fail the new gate, or if a defect that the old gate
catches passes it.

Needs a CUDA card and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from text2pos_torch.ops import superglue_gnn as tgnn  # noqa: E402

SEED = 16


def _frag(w: torch.Tensor) -> torch.Tensor:
    """Row-major [K, N] → fragment order (``to_fragment_order``)."""
    k, n = (torch.as_tensor(i, device=w.device)
            for i in tgnn._fragment_index(*w.shape))
    return w[k[None], n[:, None, :, None]]


def head_scaled(packed, block: int, scale: float = 1.01):
    """The pack with head 0's query weights and bias in ``block`` scaled."""
    out = dict(packed)
    Dp = tgnn.packed_width(packed) // tgnn.HEADS
    w = tgnn.from_fragment_order(packed["wqkv"][block])
    w[:, :Dp] = (w[:, :Dp].float() * scale).to(w.dtype)
    out["wqkv"] = packed["wqkv"].clone()
    out["wqkv"][block] = _frag(w)
    out["bqkv"] = packed["bqkv"].clone()
    out["bqkv"][block, :Dp] *= scale
    return out


def bias_moved(packed, block: int, share: float = 0.01):
    """The pack with ``block``'s merge bias moved along a seeded unit
    direction over the real channels by ``share`` of the larger of its norm
    and the norm a unit-norm message row gets through the merge weights
    (their Frobenius norm over sqrt(E)): the seeded models' biases are 0,
    where ``share`` of the bias's own norm would move nothing."""
    out = dict(packed)
    E = tgnn.real_width(packed)
    g = torch.Generator().manual_seed(SEED + block)
    u = torch.randn(E, generator=g).to(packed["bm"].device)
    out["bm"] = packed["bm"].clone()
    b = out["bm"][block, :E]
    wm = tgnn.gnn_weights(packed)["wm"][block]
    b += share * max(float(b.norm()), float(wm.norm()) / E ** 0.5) \
        * u / u.norm()
    return out


def defects(d0, d1, packed):
    """(name, kernel's d0, d1, pack) of each defect."""
    p = len(d0) // 2
    hint0 = d1.clone()
    hint0[p, 0] = 0
    swapped = d0.clone()
    swapped[p] = d0[p + 1]
    return [("none", d0, d1, packed)] + [
        (f"1. head 0's queries x1.01, block {b}", d0, d1,
         head_scaled(packed, b)) for b in (0, 10)] + [
        (f"2. merge bias moved by 1%, block {b}", d0, d1,
         bias_moved(packed, b)) for b in (1, 11)] + [
        (f"3. hint row 0 of pair {p} zeroed", d0, hint0, packed),
        (f"4. pair {p} given pair {p + 1}'s objects", swapped, d1, packed)]


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from text2pos_torch.data.bench import bench_cell_bank, make_bench_dataset
    from text2pos_torch.evaluation.pipeline import LocalizationPipeline
    from text2pos_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"# {gpu}; kernels built from {_build.CSRC}", flush=True)
    _build.build_all()
    fx = dict(np.load(cs.FIXTURE))
    pipe = LocalizationPipeline.from_checkpoints(
        cs.CKPT_COARSE, cs.CKPT_FINE, cs.DB_CACHE, dtype="bfloat16",
        device="cuda")
    bank = bench_cell_bank(make_bench_dataset()[0])
    idx = torch.as_tensor(fx["jax_top_idx"].astype("int64"),
                          device="cuda").reshape(-1)
    K = fx["jax_top_idx"].shape[1]
    rows, bad = [], 0
    for pad in (16, 24):
        wide = cs.wide_pipeline(pipe, bank, fx, torch.bfloat16, pad=pad)[0]
        packed = wide.fine.superglue.packed_kernel_params()
        with torch.inference_mode():
            d0 = wide.fine_bank_enc[idx].contiguous()
            d1 = wide.fine.encode_hints(
                torch.as_tensor(fx["hint_tokens"], device="cuda"),
                torch.as_tensor(fx["hint_lengths"], device="cuda")
            ).repeat_interleave(K, dim=0).contiguous()
            cut = cs.first_blocks(packed)
            plain = tgnn.gnn_scores_plain(d0, d1, packed)
            ref = cs.f64_scores(d0, d1, packed)
            cut_plain = tgnn.gnn_scores_plain(d0, d1, cut)
        old_key = "old_ok" if pad == 16 else "old_f64_ok"
        tol = cs.GNN_REL_TOL["bf16"] * float(ref.abs().max())
        for name, k0, k1, kp in defects(d0, d1, packed):
            with torch.inference_mode():
                got = tgnn._gnn_kernel(k0, k1, kp)
                cut_got = tgnn._gnn_kernel(k0, k1, cs.first_blocks(kp))
                torch.cuda.synchronize()
            ok, r = cs.depth_gate(got, plain, ref, cut_got, cut_plain)
            old = r[old_key]
            if name == "none":
                clean, old_clean = got, old
            moved = (got - clean).abs().amax((1, 2)) / tol
            caught = old_clean and not old
            print(f"pad_size {pad}, {name}: moved the scores by median "
                  f"{float(moved.median()):.3f}, largest "
                  f"{float(moved.max()):.3f}; old gate "
                  f"{'pass' if old else 'fail'}; new gate "
                  f"{'pass' if ok else 'fail'}: {cs.depth_gate_line(r)}",
                  flush=True)
            rows.append((pad, name, old, ok, r, moved))
            if name == "none" and not ok or caught and ok:
                bad += 1
    print("\n| pad | defect | moved: median, largest | old gate | new gate "
          "| fails | median / plain | p99.9 / plain | largest | cut |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for pad, name, old, ok, r, moved in rows:
        print(f"| {pad} | {name} | {float(moved.median()):.3f}, "
              f"{float(moved.max()):.3f} | {'pass' if old else 'fail'} | "
              f"{'pass' if ok else 'fail'} | "
              f"{' '.join(k for k in 'abcd' if not r[k]) or '-'} | "
              f"{r['median'] / r['plain_median']:.4f} | "
              f"{r['p999'] / r['plain_p999']:.4f} | {r['max']:.3f} | "
              f"{r['cut_max']:.3f} |")
    print(f"{bad} rows against the rule (the inputs as they are pass the "
          "new gate; every defect the old gate catches, failing it where "
          "it passes the inputs as they are, fails the new gate)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
