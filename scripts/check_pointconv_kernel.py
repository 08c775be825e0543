#!/usr/bin/env python3
"""Where the bf16 PointConv kernel's time goes, on one NVIDIA GPU.

    python3 scripts/check_pointconv_kernel.py

Needs the repository checkout (checkpoints, the DB fixture) and ``nvcc``.
It builds ``csrc/pointconv.cu`` twice at once (as the port builds it, and
with ``-DT2P_STAGE_CLOCKS``) and runs both on the six set-abstraction
levels of the bench map's first DB-encode step in bf16 (the inputs
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
  epilogue waits for the products' results) and the clocks a centroid.

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
DEFINE = "T2P_STAGE_CLOCKS"


def build_instrumented() -> ctypes.CDLL:
    """``pointconv.cu`` with the stage clocks, built beside the port's own
    build (both nvcc at once)."""
    out_dir = _build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libpointconv_clocks.so"
    proc = subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-D{DEFINE}", "-o", str(so),
         str(_build.CSRC / "pointconv.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.library("pointconv")
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc -D{DEFINE} failed:\n{log}")
    return ctypes.CDLL(str(so))


@contextlib.contextmanager
def using(lib: ctypes.CDLL):
    """The wrapper's calls go to ``lib`` inside the block."""
    port = _build.library("pointconv")
    _build._LIBS["pointconv"] = lib
    try:
        yield
    finally:
        _build._LIBS["pointconv"] = port


def stage_clocks(lib, run):
    """The stage clocks of one ``run()`` on the instrumented ``lib``."""
    fn = lib.t2p_pointconv_stage_clocks
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    with using(lib):
        _build.check(fn(None, 1), "stage clocks reset")
        out = run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * len(STAGES))()
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

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.gpu_line())
    clocks = build_instrumented()
    pipe = LocalizationPipeline.from_checkpoints(
        chip_smoke.CKPT_COARSE, chip_smoke.CKPT_FINE, chip_smoke.DB_CACHE,
        dtype="bfloat16", device="cuda")
    bt = bank_tensors(bench_cell_bank(make_bench_dataset()[0]), pipe.device)
    dbx = dict(np.load(chip_smoke.DB_FIXTURE))
    failures = []
    total = {"one": 0.0, "dev": 0.0, "host": 0.0}
    for tower, pos, x in chip_smoke.tower_points(bt, dbx, pipe.device):
        pn = getattr(pipe, tower).object_encoder.pointnet
        for name in ("sa1", "sa2", "sa3"):
            sa = getattr(pn, name)
            r = sa.radius
            with torch.inference_mode():
                args = sa.pointconv_args(x, pos)
                w2f = sa.w2_fragments()

                def run():
                    return tpc.pointconv_max(*args, r, K_CAP, w2f=w2f)

                want = tpc.pointconv_max_plain(*args, r, K_CAP)
                scale = float(want.float().abs().max())
                one, dev, host = times(run)
                got = run()
                got_i, cyc = stage_clocks(clocks, run)
                with using(clocks):
                    _, dev_i, _ = times(run)
            B, S = args[3].shape[:2]
            C1, C2 = args[5].shape
            err = max(chip_smoke.max_err(got, want),
                      chip_smoke.max_err(got_i, want)) / scale
            print(f"{tower} {name} B={B} S={S} C1={C1} C2={C2}: one call "
                  f"{one:.3f} ms, device {dev:.3f} ms a call, host "
                  f"{host:.1f} us a call; instrumented {dev_i:.3f} ms; error "
                  f"{err:.2e} of the largest output; "
                  f"{sum(cyc) / (B * S):.0f} warp clocks a centroid: "
                  + ", ".join(f"{k} {100 * c / sum(cyc):.1f}%"
                              for k, c in zip(STAGES, cyc)))
            if not err <= chip_smoke.POINTCONV_REL_TOL["bf16"]:
                failures.append((tower, name, err))
            for k, t in zip(("one", "dev", "host"), (one, dev, host)):
                total[k] += t
            x, pos = got, args[3]
    print(f"six levels: one call each {total['one']:.3f} ms, device "
          f"{total['dev']:.3f} ms, host {total['host']:.1f} us")
    if failures:
        print("FAILURES:", failures, file=sys.stderr)
        return 1
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
