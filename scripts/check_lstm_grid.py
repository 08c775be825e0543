#!/usr/bin/env python3
"""The LSTM kernel's grid form (``csrc/lstm.cu``, past H = 512) built two
ways in one process on one card: as the port builds it (two k-steps of the
recurrent product in flight) and with one k-step in flight (``#pragma
unroll 1`` on its product loop). Prints each build's ``ptxas`` line of the
grid kernel (registers, spills) and, at H = 768 (128 x 64 and 2048 x 64
tokens), 1024 and 2048 (2048 x 64), each build's device time a call
(launch and workspace zeroing, 10 repeats, builds in turns A B B A) and
its largest error against the plain version, and whether the two builds'
outputs are bit-identical.

    python3 scripts/check_lstm_grid.py

Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from text2pos_torch.ops import _build  # noqa: E402
from text2pos_torch.ops import lstm as tlstm  # noqa: E402

KERNEL = "lstm_grid_kernel(const GridArgs a)"


def builds():
    src = (ROOT / "text2pos_torch" / "csrc" / "lstm.cu").read_text()
    head, tail = src.split(KERNEL)
    one = head + KERNEL + tail.replace("#pragma unroll 2", "#pragma unroll 1",
                                       1)
    assert one != src
    out, procs = {}, {}
    tmp = tempfile.mkdtemp()
    for name, text in (("two k-steps in flight", src),
                       ("one k-step in flight", one)):
        cu = os.path.join(tmp, f"lstm_{len(procs)}.cu")
        Path(cu).write_text(text)
        so = cu[:-3] + ".so"
        procs[name] = (subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(log)
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "lstm_grid_kernel" in ln:
                print(name, "|", " ".join(x.strip() for x in lines[i + 1:i + 3]))
        out[name] = ctypes.CDLL(so)
    return out


def caller(lib, H, B, T, seed, keep):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    V = 32
    tables = [torch.randn(V, 4 * H, device=dev, generator=g) * 0.3
              for _ in range(2)]
    w_hh = [(torch.rand(H, 4 * H, device=dev, generator=g) * 2 - 1)
            / H ** 0.5 for _ in range(2)]
    tokens = torch.randint(0, V, (B, T), device=dev, generator=g,
                           dtype=torch.int32)
    lengths = torch.randint(1, T + 1, (B,), device=dev, generator=g,
                            dtype=torch.int32)
    wpack = [tlstm.w_hh_fragments(w) for w in w_hh]
    out = torch.empty(2, B, H, device=dev)
    size = lib.t2p_lstm_grid_workspace
    size.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    size.restype = ctypes.c_int
    n = ctypes.c_longlong(0)
    if size(H, B, 0, ctypes.byref(n)):
        raise RuntimeError("t2p_lstm_grid_workspace failed")
    ws = torch.zeros(n.value, dtype=torch.uint8, device=dev)
    fn = lib.t2p_lstm_final_hidden_grid
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # Every tensor whose pointer a launch takes stays alive with the call.
    keep.append((tables, w_hh, tokens, lengths, wpack, out, ws))

    def call():
        ws.zero_()
        err = fn(tables[0].data_ptr(), tables[1].data_ptr(),
                 wpack[0].data_ptr(), wpack[1].data_ptr(), tokens.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), ws.data_ptr(), V, T, B,
                 H, 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"t2p_lstm_final_hidden_grid: CUDA error {err}")
        return out

    return call, tlstm.lstm_final_hidden_plain(tables, w_hh, tokens, lengths)


def timed(call, reps=10):
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = builds()
    keep = []
    for H, B, T in ((768, 128, 64), (768, 2048, 64), (1024, 2048, 64),
                    (2048, 2048, 64)):
        calls = {k: caller(lib, H, B, T, H + B, keep)
                 for k, lib in libs.items()}
        ms = {k: [] for k in libs}
        for k in list(libs) + list(libs)[::-1]:
            ms[k].append(timed(calls[k][0]))
        errs = {k: float((c[0]() - c[1]).abs().max())
                for k, c in calls.items()}
        first = next(iter(calls.values()))[0]().clone()
        same = all(torch.equal(c[0](), first) for c in calls.values())
        print(f"H={H} B={B} T={T}: " + "; ".join(
            f"{k}: {min(v):.3f}/{max(v):.3f} ms, err {errs[k]:.1e}"
            for k, v in ms.items()) + f"; bit-identical {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
