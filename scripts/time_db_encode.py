#!/usr/bin/env python3
"""Where the PyTorch port's offline DB encode spends its wall time, on one
CUDA device:

    python3 scripts/time_db_encode.py

For each DB-encode step size in ``CHUNKS`` (``pipeline.DB_CHUNK``; the
sizes alternate, ``REPS`` rounds) it times
``LocalizationPipeline.encode_database`` of the 2048 bench cells in bf16
(synchronized wall time), and profiles one step of that size: the CUDA
kernels it launches and their summed device time. It
also times the host's cost of one launch (a loop of one-element adds), so
that the wall time can be set against launches x host cost and against the
device time. Prints ``#`` lines only; writes nothing.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CHUNKS = (64, 128, 256)
REPS = 2


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


def host_us_per_launch(dev, n: int = 5000) -> float:
    """Host time of one tiny kernel launch in µs (median of 5 loops)."""
    x = torch.zeros(1, device=dev)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            x.add_(1.0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(times)


def profile_step(pipe, bt, chunk: int):
    """Kernels launched by one step of ``chunk`` cells (coarse + fine) and
    their summed device time in ms."""
    from torch.profiler import ProfilerActivity, profile

    from text2pos_torch.evaluation.pipeline import (encode_coarse_cells,
                                                    encode_fine_cells)

    idx = torch.arange(chunk, device=pipe.device)
    gen = torch.Generator(device=pipe.device).manual_seed(9)
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        encode_coarse_cells(pipe.coarse, bt, idx, gen)
        encode_fine_cells(pipe.fine, bt, idx, pipe.cfg.pad_size, gen)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if "CUDA" in str(getattr(e, "device_type", ""))]
    return len(kernels), sum(e.time_range.elapsed_us()
                             for e in kernels) / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("time_db_encode: needs a CUDA device", file=sys.stderr)
        return 2
    from text2pos_torch.data.bench import bench_cell_bank, make_bench_dataset
    from text2pos_torch.evaluation import pipeline as pl
    from text2pos_torch.ops import _build

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    log(f"device: {gpu}; torch {torch.__version__}; {os.cpu_count()} "
        "host cores")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    ck = os.path.join(ROOT, "checkpoints")
    pipe = pl.LocalizationPipeline.from_checkpoints(
        os.path.join(ck, "bench_coarse.msgpack"),
        os.path.join(ck, "bench_fine.msgpack"),
        os.path.join(ck, "bench_db_cache.npz"), dtype="bfloat16",
        device="cuda")
    bank = bench_cell_bank(make_bench_dataset()[0])
    bt = pl.bank_tensors(bank, pipe.device)
    C = bank.num_cells
    pipe.encode_database(bank, seed=0)                  # warm-up
    walls = {c: [] for c in CHUNKS}
    hosts = []
    for r in range(REPS):
        for c in CHUNKS:
            pl.DB_CHUNK = c
            hosts.append(host_us_per_launch(pipe.device))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.encode_database(bank, seed=r + 1)
            torch.cuda.synchronize()
            walls[c].append(time.perf_counter() - t0)
    log(f"host cost of one launch: {', '.join(f'{h:.2f}' for h in hosts)} "
        "us (a loop of one-element adds, before each timed encode)")
    for c in CHUNKS:
        steps = -(-C // c)
        n, dev_ms = profile_step(pipe, bt, c)
        w = statistics.median(walls[c])
        log(f"step of {c} cells: {steps} steps; encode_database "
            f"{', '.join(f'{x:.3f}' for x in walls[c])} s (median {w:.3f} s "
            f"= {C / w:.1f} cells/s, {1e3 * w / steps:.1f} ms a step); one "
            f"step launches {n} kernels, {dev_ms:.2f} ms on the device "
            f"(profiled); wall a launch {1e6 * w / (steps * n):.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
