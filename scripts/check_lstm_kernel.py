#!/usr/bin/env python3
"""Where the LSTM kernel's time goes, which the card's tools cannot say.

    python3 scripts/check_lstm_kernel.py [OTHER_CSRC]

Needs one NVIDIA GPU and ``nvcc``. Takes the serving path's tokens and
lengths from ``text2pos_torch/fixtures/bench_queries.npz`` (the text: 2048
descriptions, T = 64, 48-54 tokens; the hints: 12,288, T = 16, 8-9 tokens)
and random tables and W_hh from a seed. Shapes: the bench encoders' (text
at H = 256, hints at H = 128: the shared form, W_hh on chip), the E = 300
serving path's (text and hints at H = 300, padded to 320: the L2 form, W_hh
read from L2), and 2048 x 64 with random lengths of 32-64 tokens (as
``scripts/ab_kernel_times.py`` draws them) at H = 300, 384 and 512.

It builds ``csrc/lstm.cu`` seven times at once: as the port builds it,
with ``-DT2P_LSTM_NO_EXCHANGE`` (no h sent between the CTAs of a cluster),
``-DT2P_LSTM_NO_PRODUCT`` (no recurrent product), both, and, for the L2
form, ``-DT2P_LSTM_W_SMEM`` (W_hh's fragments read from shared memory: its
loads from L2 dropped, the splits and the product kept),
``-DT2P_LSTM_NO_WSPLIT`` (the per-step splits of W dropped) and both of
those. The ablated builds give wrong results and serve only as timings.
With OTHER_CSRC (another tree's ``text2pos_torch/csrc``, for example the
parent commit's, unpacked with ``git archive``) it also builds that tree's
``lstm.cu`` as the port does.

For each shape it prints the clusters the launch has, how many the card
holds at once and the waves that follow, the port's build's error against
the plain version, each build's time (CUDA events, 20 launches back to
back) and the time a step of the longest tile (waves x steps), and whether
the other tree's build gives bit-identical outputs. What the product,
W_hh's loads, W's splits, the exchange and the rest cost is read off the
differences.

About a minute and a half, half of it the builds.
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
          "neither": ("T2P_LSTM_NO_EXCHANGE", "T2P_LSTM_NO_PRODUCT"),
          "W from smem": ("T2P_LSTM_W_SMEM",),
          "no W split": ("T2P_LSTM_NO_WSPLIT",),
          "W smem no split": ("T2P_LSTM_W_SMEM", "T2P_LSTM_NO_WSPLIT")}
# Builds that change only the L2 form (256 < H <= 512).
L2_ONLY = ("W from smem", "no W split", "W smem no split")


def build_variants(other=None):
    """The builds, compiled side by side; returns {name: CDLL}."""
    out_dir = _build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {name: (defines, _build.CSRC / "lstm.cu")
            for name, defines in BUILDS.items()}
    if other is not None:
        srcs["other"] = ((), other / "lstm.cu")
    procs = {}
    for name, (defines, src) in srcs.items():
        so = out_dir / f"liblstm_{name.replace(' ', '_')}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS,
               *(f"-D{d}" for d in defines), "-o", str(so), str(src)]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc ({name}) failed:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
        print(f"# ptxas {name}: " + " | ".join(
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln))
    return libs


def launcher(lib, tables, w_hh, tokens, lengths, out):
    """A launch as the port's wrapper makes it (H padded to a multiple of
    32; past 256 W_hh also in fragment order); ``out`` is [2, B, Hp]."""
    fn = lib.t2p_lstm_final_hidden
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    V, H4 = tables[0].shape
    H = H4 // 4
    Hp = tlstm.kernel_width(H)
    tables = [tlstm.pad_gates(t, H, Hp).contiguous() for t in tables]
    w_hh = [tlstm.pad_w_hh(w, H, Hp).contiguous() for w in w_hh]
    wpack = [tlstm.w_hh_fragments(w) for w in w_hh] \
        if Hp > tlstm.SMEM_HIDDEN else None
    B, T = tokens.shape
    args = [t.data_ptr() for t in (*tables, *w_hh)] \
        + ([None, None] if wpack is None else [w.data_ptr() for w in wpack]) \
        + [t.data_ptr() for t in (tokens, lengths, out)]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(*args, V, T, B, Hp, stream)
        if err:
            raise RuntimeError(f"lstm launch failed: CUDA error {err}")
    call.keep = (tables, w_hh, wpack)
    return call


def resident(lib, Hp, B):
    """Clusters of the launch the card holds at once."""
    n = ctypes.c_int()
    fn = lib.t2p_lstm_max_active_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    err = fn(Hp, B, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: {err}")
    return n.value


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
    other = None
    if len(sys.argv) > 1:
        from pathlib import Path
        other = Path(sys.argv[1]).resolve()
    libs = build_variants(other)
    fx = np.load(FIXTURE)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    text = (fx["tokens"], fx["lengths"])
    hints = (fx["hint_tokens"].reshape(-1, fx["hint_tokens"].shape[-1]),
             fx["hint_lengths"].reshape(-1))
    rng = np.random.default_rng(0)
    rand = (rng.integers(0, 512, (2048, 64)),
            rng.integers(32, 65, 2048))
    worst = 0.0
    for label, (tok, ln), H in (
            ("text", text, 256), ("hints", hints, 128),
            ("E=300 text", text, 300), ("E=300 hints", hints, 300),
            ("random", rand, 300), ("random", rand, 384),
            ("random", rand, 512)):
        V = int(tok.max()) + 1
        tokens = torch.as_tensor(tok, dtype=torch.int32, device=dev)
        lengths = torch.as_tensor(ln, dtype=torch.int32, device=dev)
        tables = [torch.randn(V, 4 * H, device=dev, generator=g) * 0.3
                  for _ in range(2)]
        w_hh = [(torch.rand(H, 4 * H, device=dev, generator=g) * 2 - 1)
                / H ** 0.5 for _ in range(2)]
        B, T = tokens.shape
        Hp = tlstm.kernel_width(H)
        l2 = Hp > tlstm.SMEM_HIDDEN
        total = 2 * ((B + 31) // 32)
        steps = int(lengths.reshape(-1, 32).max(1).values.max()) \
            if B % 32 == 0 else T
        out = torch.empty(2, B, Hp, device=dev)
        launcher(libs["port"], tables, w_hh, tokens, lengths, out)()
        want = tlstm.lstm_final_hidden_plain(tables, w_hh, tokens, lengths)
        err = float((out[..., :H] - want).abs().max())
        worst = max(worst, err)
        runs = {n: lib for n, lib in libs.items() if l2 or n not in L2_ONLY}
        res = {n: resident(lib, Hp, B) for n, lib in runs.items()}
        waves = {n: -(-total // r) for n, r in res.items()}
        print(f"# {label}: B={B} T={T} H={H} (Hp {Hp}), {total} clusters of "
              f"{Hp // 32} CTAs, up to {steps} steps; at once (waves): "
              + ", ".join(f"{n} {res[n]} ({waves[n]})" for n in res
                          if n in ("port", "other", "W from smem"))
              + f"; port build vs plain max_abs_err {err:.3e}")
        outs, times = {}, {}
        for n, lib in runs.items():
            o = torch.empty(2, B, Hp, device=dev)
            times[n] = event_ms(launcher(lib, tables, w_hh, tokens, lengths,
                                         o))
            outs[n] = o
        print(f"# {label} H={H}: " + ", ".join(
            f"{n} {t:.3f} ms ({1e3 * t / (waves[n] * steps):.2f} us a step)"
            for n, t in times.items()))
        if "other" in outs:
            print(f"# {label} H={H}: the other tree's build bit-identical: "
                  f"{torch.equal(outs['other'], outs['port'])}")
    if not worst < 1e-4:
        print(f"check_lstm_kernel: FAIL max_abs_err {worst}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
