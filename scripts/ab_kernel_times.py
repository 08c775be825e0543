#!/usr/bin/env python3
"""Device times of the LSTM and FPS kernels built from two source trees, in
one process on one card, in the order A, B, B, A.

    python3 scripts/ab_kernel_times.py OTHER_CSRC_DIR

A is this checkout's ``text2pos_torch/csrc``, B the other directory (for
example the parent commit's ``text2pos_torch/csrc``, unpacked with
``git archive``). Each side's ``lstm.cu`` and ``fps.cu`` are built with the
port's ``nvcc`` flags. Shapes: the LSTM at the bench serving encoders'
(2048 queries x 64 tokens at H = 256; 12,288 hints x 16 tokens at H = 128;
seeded random weights, the bench's lengths are not needed for a timing),
FPS at the six launches of a DB-encode step (1024 and 787 objects at 256,
128 and 64 points, half sampled, points with duplicates). Prints the
median device time a launch (10 repeats of 20 launches back to back
between two CUDA events) and the card's name and power limit. Needs a CUDA
card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from text2pos_torch.ops import _build  # noqa: E402


def build(csrc: Path, out: Path, tag: str):
    procs = {}
    for name in ("lstm", "fps"):
        so = out / f"lib{name}_{tag}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {tag} {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    libs["wide_lstm"] = "wpack_f" in (csrc / "lstm.cu").read_text()
    return libs


def timed(fn, reps=10, launches=20):
    """Median over ``reps`` of the device time a launch, ``launches``
    launches back to back between two events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / launches)
    return statistics.median(out)


def lstm_call(libs, B, T, H, V=512, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    tables = [torch.randn(V, 4 * H, device="cuda", generator=g) * 0.3
              for _ in range(2)]
    w_hh = [(torch.rand(H, 4 * H, device="cuda", generator=g) * 2 - 1)
            / H ** 0.5 for _ in range(2)]
    tokens = torch.randint(0, V, (B, T), device="cuda", generator=g,
                           dtype=torch.int32)
    lengths = torch.randint(T // 2, T + 1, (B,), device="cuda", generator=g,
                            dtype=torch.int32)
    out = torch.empty(2, B, H, device="cuda")
    fn = libs["lstm"].t2p_lstm_final_hidden
    extra = [None, None] if libs["wide_lstm"] else []
    fn.argtypes = [ctypes.c_void_p] * (7 + len(extra)) + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    args = [t.data_ptr() for t in (*tables, *w_hh)] + extra + [
        t.data_ptr() for t in (tokens, lengths, out)] + [V, T, B, H]

    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"lstm launch: CUDA error {err}")
    return call


def fps_call(libs, B, N, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.randn(B, 60, 3, device="cuda", generator=g)
    pick = torch.randint(0, 60, (B, N), device="cuda", generator=g)
    pts = torch.gather(base, 1, pick[..., None].expand(B, N, 3)).contiguous()
    S = N // 2
    idx = torch.empty(B, S, dtype=torch.long, device="cuda")
    cent = torch.empty(B, S, 3, device="cuda")
    fn = libs["fps"].t2p_fps
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]

    def call():
        err = fn(pts.data_ptr(), idx.data_ptr(), cent.data_ptr(), B, N, S,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"fps launch: CUDA error {err}")
    return call


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as d:
        sides = {"A": build(_build.CSRC, Path(d), "A"),
                 "B": build(other, Path(d), "B")}
        cases = [(f"lstm B={B} T={T} H={H}", lambda L, a=(B, T, H):
                  lstm_call(L, *a))
                 for B, T, H in ((2048, 64, 256), (12288, 16, 128))]
        cases += [(f"fps B={B} N={N}", lambda L, a=(B, N): fps_call(L, *a))
                  for B in (1024, 787) for N in (256, 128, 64)]
        print(f"# {gpu}; A = {_build.CSRC}, B = {other}")
        for label, make in cases:
            calls = {k: make(v) for k, v in sides.items()}
            ms = {k: [] for k in calls}
            for k in ("A", "B", "B", "A"):
                ms[k].append(timed(calls[k]))
            a, b = (statistics.mean(ms[k]) for k in ("A", "B"))
            print(f"{label}: A {ms['A'][0]:.4f} {ms['A'][1]:.4f} ms, "
                  f"B {ms['B'][0]:.4f} {ms['B'][1]:.4f} ms, A/B "
                  f"{a / b:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
