#!/usr/bin/env python3
"""Where the PointConv kernel's time goes, on one NVIDIA GPU.

    python3 scripts/check_pointconv_kernel.py [--f32 [--other OTHER_CSRC]]

Needs the repository checkout (checkpoints, the DB fixture) and ``nvcc``.
It builds ``csrc/pointconv.cu`` three times at once (as the port builds it,
with ``-DT2P_STAGE_CLOCKS`` and, for the f32 route, the timing-only
``-DT2P_PC_W2_SMEM``, which reads W2 from shared memory instead of L2 and
L1) and runs them on the six set-abstraction levels of the bench map's
first DB-encode step in bf16, then in f32 (only f32 with ``--f32``; the inputs
``chip_smoke.py`` checks: JAX's draws, the fine tower's 1024 objects and the
coarse tower's valid ones), W2 packed once as the model packs it. For each
level it prints:

- the kernel's time three ways: one wrapper call between two CUDA events
  (as ``chip_smoke.py`` times it, the host's work in the wrapper included),
  20 calls back to back between two events (the device's time, the host
  running ahead), and the host's time a call (50 calls, no synchronize);
- the instrumented build's time and its error against the plain version;
- the share of the warps' clocks in each stage of the kernel (W2 staging,
  selection, building the rows, issuing the product, the epilogue; the
  epilogue waits for the products' results) and the clocks a centroid;
- with ``--other``, the f32 route of another tree's ``pointconv.cu`` (for
  example the parent commit's ``csrc``, unpacked with ``git archive`` into
  a gitignored directory), built beside the rest: both trees' device time
  a call, timed this, other, other, this, and whether this tree's output is
  bit for bit the other's (the script fails if it is not).

About a minute of command on the card (the builds, the bench map rebuilt
on the host, the timing).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from text2pos_torch.ops import _build  # noqa: E402
from text2pos_torch.ops import pointconv as tpc  # noqa: E402

STAGES = ("W2 staging", "selection", "rows", "product", "epilogue")
F32_STAGES = ("selection", "rows", "product and epilogue", "output")
DEFINE = "T2P_STAGE_CLOCKS"
# A timing-only build of the f32 route (wrong results, the same products):
# W2 read from shared memory, no L2 or L1 reads of it.
F32_ABLATION = "T2P_PC_W2_SMEM"


def build_variants(other=None) -> dict:
    """``pointconv.cu`` with the stage clocks and as the f32 ablation, and
    ``other``'s ``pointconv.cu`` as the port builds it, built beside the
    port's own build (all nvcc at once): {define or "other": CDLL}."""
    out_dir = _build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {define: ([f"-D{define}"], _build.CSRC / "pointconv.cu")
            for define in (DEFINE, F32_ABLATION)}
    if other:
        jobs["other"] = ([], os.path.join(os.path.abspath(other),
                                          "pointconv.cu"))
    procs = {}
    for key, (flags, src) in jobs.items():
        so = out_dir / f"libpointconv_{key}.so"
        procs[key] = so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(so),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.library("pointconv")
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {key} failed:\n{log}")
        libs[key] = ctypes.CDLL(str(so))
    return libs


@contextlib.contextmanager
def using(lib: ctypes.CDLL):
    """The wrapper's calls go to ``lib`` inside the block."""
    port = _build.library("pointconv")
    _build._LIBS["pointconv"] = lib
    try:
        yield
    finally:
        _build._LIBS["pointconv"] = port


def stage_clocks(lib, run, f32=False):
    """The stage clocks of one ``run()`` on the instrumented ``lib``."""
    fn = (lib.t2p_pointconv_f32_stage_clocks if f32
          else lib.t2p_pointconv_stage_clocks)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    with using(lib):
        _build.check(fn(None, 1), "stage clocks reset")
        out = run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * len(F32_STAGES if f32 else STAGES))()
        _build.check(fn(buf, 0), "stage clocks read")
    return out, [float(v) for v in buf]


def times(fn):
    """(ms of one call between two events, device ms a call over 20 calls
    back to back, host µs a call over 50 calls); medians of 5."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    one, dev, host = [], [], []
    for _ in range(5):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        one.append(a.elapsed_time(b))
        a.record()
        for _ in range(20):
            fn()
        b.record()
        b.synchronize()
        dev.append(a.elapsed_time(b) / 20)
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        host.append((time.perf_counter() - t0) / 50 * 1e6)
        torch.cuda.synchronize()
    return tuple(statistics.median(x) for x in (one, dev, host))


def main() -> int:
    if not torch.cuda.is_available():
        print("check_pointconv_kernel: needs a CUDA device", file=sys.stderr)
        return 2
    from text2pos_torch.data.bench import bench_cell_bank, make_bench_dataset
    from text2pos_torch.evaluation.pipeline import (LocalizationPipeline,
                                                    bank_tensors)
    from text2pos_torch.models.pointnet2 import K_CAP

    argv = sys.argv[1:]
    other = argv[argv.index("--other") + 1] if "--other" in argv else None
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.gpu_line())
    libs = build_variants(other)
    clocks = libs[DEFINE]
    bt = dbx = None
    failures = []
    labels = ("f32",) if "--f32" in argv else ("bf16", "f32")
    for label in labels:
        f32 = label == "f32"
        pipe = LocalizationPipeline.from_checkpoints(
            chip_smoke.CKPT_COARSE, chip_smoke.CKPT_FINE, chip_smoke.DB_CACHE,
            dtype="float32" if f32 else "bfloat16", device="cuda")
        if bt is None:
            bt = bank_tensors(bench_cell_bank(make_bench_dataset()[0]),
                              pipe.device)
            dbx = dict(np.load(chip_smoke.DB_FIXTURE))
        total = {"one": 0.0, "dev": 0.0, "host": 0.0, "abl": 0.0,
                 "this": 0.0, "other": 0.0}
        for tower, pos, x in chip_smoke.tower_points(bt, dbx, pipe.device):
            pn = getattr(pipe, tower).object_encoder.pointnet
            for name in ("sa1", "sa2", "sa3"):
                sa = getattr(pn, name)
                r = sa.radius
                with torch.inference_mode():
                    args = sa.pointconv_args(x, pos)
                    w2f = None if f32 else sa.w2_fragments()

                    def run():
                        return tpc.pointconv_max(*args, r, K_CAP, w2f=w2f)

                    want = tpc.pointconv_max_plain(*args, r, K_CAP)
                    scale = float(want.float().abs().max())
                    one, dev, host = times(run)
                    got = run()
                    got_i, cyc = stage_clocks(clocks, run, f32)
                    with using(clocks):
                        _, dev_i, _ = times(run)
                    abl = ab = None
                    if f32:
                        with using(libs[F32_ABLATION]):
                            _, abl, _ = times(run)
                    if f32 and other:
                        ab = {"this": [], "other": []}
                        for k in ("this", "other", "other", "this"):
                            with using(libs[k] if k == "other"
                                       else _build.library("pointconv")):
                                ab[k].append(times(run)[1])
                        with using(libs["other"]):
                            same = torch.equal(got, run())
                B, S = args[3].shape[:2]
                C1, C2 = args[5].shape
                err = max(chip_smoke.max_err(got, want),
                          chip_smoke.max_err(got_i, want)) / scale
                print(f"{label} {tower} {name} B={B} S={S} C1={C1} C2={C2}: "
                      f"one call {one:.3f} ms, device {dev:.3f} ms a call, "
                      f"host {host:.1f} us a call; instrumented "
                      f"{dev_i:.3f} ms; "
                      + ("" if abl is None else
                         f"W2 from shared memory {abl:.3f} ms "
                         f"({abl / dev - 1:+.1%}); ")
                      + ("" if ab is None else
                         "this tree {:.3f} ms, the other {:.3f} ms, "
                         "bit-identical: {}; ".format(
                             *(statistics.mean(v) for v in ab.values()),
                             same))
                      + f"error {err:.2e} of the largest output; "
                      f"{sum(cyc) / (B * S):.0f} warp clocks a centroid: "
                      + ", ".join(f"{k} {100 * c / sum(cyc):.1f}%" for k, c
                                  in zip(F32_STAGES if f32 else STAGES, cyc)))
                if not err <= chip_smoke.POINTCONV_REL_TOL[label]:
                    failures.append((label, tower, name, err))
                if ab is not None:
                    if not same:
                        failures.append((label, tower, name, "other tree"))
                    for k, v in ab.items():
                        total[k] += statistics.mean(v)
                for k, t in zip(("one", "dev", "host", "abl"),
                                (one, dev, host, abl or 0.0)):
                    total[k] += t
                x, pos = got, args[3]
        print(f"{label} six levels: one call each {total['one']:.3f} ms, "
              f"device {total['dev']:.3f} ms, host {total['host']:.1f} us"
              + (f", W2 from shared memory {total['abl']:.3f} ms" if f32
                 else "")
              + (f"; this tree {total['this']:.3f} ms, the other "
                 f"{total['other']:.3f} ms (this/other "
                 f"{total['this'] / total['other']:.4f})"
                 if f32 and other else ""))
    if failures:
        print("FAILURES:", failures, file=sys.stderr)
        return 1
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
