#!/usr/bin/env python3
"""Where the LSTM kernel's time goes, which the card's tools cannot say.

    python3 scripts/check_lstm_kernel.py

Needs one NVIDIA GPU and ``nvcc``. Takes the serving path's tokens and
lengths from ``text2pos_torch/fixtures/bench_queries.npz`` (coarse: 2048
descriptions, T = 64, H = 256; fine: 12,288 hints, T = 16, H = 128) and
random tables and W_hh from a seed. It builds ``csrc/lstm.cu`` four times at
once: as the port builds it, with ``-DT2P_LSTM_NO_EXCHANGE`` (no h sent
between the CTAs of a cluster), with ``-DT2P_LSTM_NO_PRODUCT`` (no recurrent
product) and with both; the ablated builds give wrong results and serve only
as timings. For each encoder it prints the four times (CUDA events), the
port's build's error against the plain version, and how many clusters the
card holds at once (the number of waves follows). What the product, the
exchange and the rest cost is read off the differences.

About half a minute, most of it the builds.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from text2pos_torch.ops import _build  # noqa: E402
from text2pos_torch.ops import lstm as tlstm  # noqa: E402

FIXTURE = os.path.join(ROOT, "text2pos_torch", "fixtures", "bench_queries.npz")
BUILDS = {"port": (), "no exchange": ("T2P_LSTM_NO_EXCHANGE",),
          "no product": ("T2P_LSTM_NO_PRODUCT",),
          "neither": ("T2P_LSTM_NO_EXCHANGE", "T2P_LSTM_NO_PRODUCT")}


def build_variants():
    """The four builds, compiled side by side; returns {name: CDLL}."""
    out_dir = _build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, defines in BUILDS.items():
        so = out_dir / f"liblstm_{name.replace(' ', '_')}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS,
               *(f"-D{d}" for d in defines), "-o", str(so),
               str(_build.CSRC / "lstm.cu")]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc ({name}) failed:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def launcher(lib, tables, w_hh, tokens, lengths, out):
    fn = lib.t2p_lstm_final_hidden
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    V, H4 = tables[0].shape
    B, T = tokens.shape
    args = [t.data_ptr() for t in (*tables, *w_hh)] + [None, None] \
        + [t.data_ptr() for t in (tokens, lengths, out)]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(*args, V, T, B, H4 // 4, stream)
        if err:
            raise RuntimeError(f"lstm launch failed: CUDA error {err}")
    return call


def event_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("check_lstm_kernel: needs a CUDA device", file=sys.stderr)
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"# {gpu}; torch {torch.__version__}")
    libs = build_variants()
    fx = np.load(FIXTURE)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for label, tok, ln, H in (
            ("coarse", fx["tokens"], fx["lengths"], 256),
            ("fine", fx["hint_tokens"].reshape(-1, fx["hint_tokens"].shape[-1]),
             fx["hint_lengths"].reshape(-1), 128)):
        V = int(tok.max()) + 1
        tokens = torch.as_tensor(tok, dtype=torch.int32, device=dev)
        lengths = torch.as_tensor(ln, dtype=torch.int32, device=dev)
        tables = [torch.randn(V, 4 * H, device=dev, generator=g)
                  for _ in range(2)]
        w_hh = [torch.randn(H, 4 * H, device=dev, generator=g) / H ** 0.5
                for _ in range(2)]
        B, T = tokens.shape
        out = torch.empty(2, B, H, device=dev)
        clusters = ctypes.c_int()
        fn = libs["port"].t2p_lstm_max_active_clusters
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        if fn(H, B, ctypes.byref(clusters)):
            raise RuntimeError("cudaOccupancyMaxActiveClusters failed")
        launcher(libs["port"], tables, w_hh, tokens, lengths, out)()
        want = tlstm.lstm_final_hidden_plain(tables, w_hh, tokens, lengths)
        err = float((out - want).abs().max())
        worst = max(worst, err)
        total = 2 * ((B + 31) // 32)
        print(f"# {label}: B={B} T={T} H={H}, {total} clusters of {H // 32}"
              f" CTAs, {clusters.value} at once ({-(-total // clusters.value)}"
              f" waves); port build vs plain max_abs_err {err:.3e}")
        times = {name: event_ms(launcher(lib, tables, w_hh, tokens, lengths,
                                         out))
                 for name, lib in libs.items()}
        print(f"# {label}: " + ", ".join(f"{n} {t:.3f} ms"
                                         for n, t in times.items()))
    if not worst < 1e-4:
        print(f"check_lstm_kernel: FAIL max_abs_err {worst}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
