#!/usr/bin/env python3
"""The LSTM kernel's grid form (``csrc/lstm.cu``, past H = 512): device
times with four ablations, built in one process on one card.

    python3 scripts/check_lstm_grid.py [OTHER_CSRC]

Builds this tree's ``lstm.cu`` as the port does and four ablation builds
of its grid form (wrong results, timing only), made by editing its source:
W_hh's fragments and h's values made up from the loop index instead of
loaded (no W_hh load, no h load), ``__syncthreads`` in place of the
group's barrier (no barrier), the product's loop left out (no product).
With OTHER_CSRC (another tree's ``text2pos_torch/csrc``, for example the
parent commit's, unpacked with ``git archive``), builds its ``lstm.cu``
and the same ablations too, where its source holds the edited lines.

Shapes: chip_smoke phase 14's two launches at H = 768 (128 texts of 64
tokens, 768 hints of 16) and 2048 x 64 at H = 544, 768, 1024 and 2048
(14.3), with the bench fixture's lengths (texts 48-54 tokens, hints 8-9:
the steps a launch runs), seeded random tables and W_hh. Prints each
build's ``ptxas`` line of the grid kernel (registers, spills), and for
each shape and build the median device time of a call (5 calls a turn,
builds in turns A B ... B A), the time a step, the largest error against
the plain version (the full builds) and whether the two trees' full builds
give bit-identical outputs.

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

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from text2pos_torch.ops import _build  # noqa: E402
from text2pos_torch.ops import lstm as tlstm  # noqa: E402

FIXTURE = ROOT / "text2pos_torch" / "fixtures" / "bench_queries.npz"
SHAPES = (("path text", 128, 64, 768), ("path hints", 768, 16, 768),
          ("14.3", 2048, 64, 544), ("14.3", 2048, 64, 768),
          ("14.3", 2048, 64, 1024), ("14.3", 2048, 64, 2048))
KERNEL = "lstm_grid_kernel(const GridArgs a)"
# The ablations: (text, its replacement) in the grid kernel.
EDITS = {
    "no W_hh load": (
        "const float4 w = __ldg(wa + (kk * 2 + mt) * 4 * 32);",
        "const float4 w = make_float4(__int_as_float(0x3c000000 + kk), "
        "__int_as_float(0x3c000000 + mt), 0.5f, 0.25f);"),
    "no h load": (
        "const float2 hv = __ldcg(\n                  reinterpret_cast"
        "<const float2*>(hs + (kk * BT + nt * 8) * 8));",
        "const float2 hv = make_float2(__int_as_float(0x3c000000 + kk), "
        "__int_as_float(0x3c000000 + nt));"),
    "no barrier": ("group_sync(a.count + group, ++epoch * (unsigned)CS);",
                   "__syncthreads();"),
    "no product": ("if (s > 0) {                             // h = 0 "
                   "before step 0", "if (false) {"),
}


def variants(csrc: Path, tag: str):
    """{build name: source text} of one tree: its own and its ablations."""
    src = (csrc / "lstm.cu").read_text()
    out = {tag: src}
    head, tail = src.split(KERNEL)
    for k, (old, new) in EDITS.items():
        if old in tail:
            out[f"{tag} {k}"] = head + KERNEL + tail.replace(old, new, 1)
        else:
            print(f"# {tag}: no edit for {k!r} (source differs)")
    return out


def build(builds):
    """Compiles every build at once; returns {name: CDLL}."""
    tmp = tempfile.mkdtemp()
    procs = {}
    for i, (name, text) in enumerate(builds.items()):
        cu = os.path.join(tmp, f"lstm_{i}.cu")
        Path(cu).write_text(text)
        so = cu[:-3] + ".so"
        procs[name] = (subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}:\n{log}")
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "lstm_grid" in ln and "Compiling" in ln:
                print(f"# ptxas {name} |",
                      " ".join(x.strip() for x in lines[i + 1:i + 3]))
        libs[name] = ctypes.CDLL(so)
    return libs


def inputs(B, T, H, lengths, seed):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    V = 512
    tables = [torch.randn(V, 4 * H, device=dev, generator=g) * 0.3
              for _ in range(2)]
    w_hh = [(torch.rand(H, 4 * H, device=dev, generator=g) * 2 - 1)
            / H ** 0.5 for _ in range(2)]
    tokens = torch.randint(0, V, (B, T), device=dev, generator=g,
                           dtype=torch.int32)
    return tables, w_hh, tokens, torch.as_tensor(
        lengths, dtype=torch.int32, device=dev)


def caller(lib, args, keep):
    """A call of one build's grid entry on ``args`` (W_hh in fragment
    order, the workspace zeroed before each call, as the wrapper's)."""
    tables, w_hh, tokens, lengths = args
    dev = tokens.device
    B, T = tokens.shape
    V, H = tables[0].shape[0], w_hh[0].shape[0]
    wpack = [tlstm.w_hh_fragments(w) for w in w_hh]
    out = torch.empty(2, B, H, device=dev)
    n = ctypes.c_longlong(0)
    size = lib.t2p_lstm_grid_workspace
    size.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    if size(H, B, 0, ctypes.byref(n)):
        raise RuntimeError("t2p_lstm_grid_workspace failed")
    ws = torch.zeros(n.value, dtype=torch.uint8, device=dev)
    fn = lib.t2p_lstm_final_hidden_grid
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    keep.append((wpack, out, ws))

    def call():
        ws.zero_()
        err = fn(tables[0].data_ptr(), tables[1].data_ptr(),
                 wpack[0].data_ptr(), wpack[1].data_ptr(), tokens.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), ws.data_ptr(), V, T, B,
                 H, 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"t2p_lstm_final_hidden_grid: CUDA error {err}")
        return out

    return call


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


def main(argv) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    builds = variants(_build.CSRC, "A")
    if argv:
        builds.update(variants(Path(argv[0]), "B"))
    libs = build(builds)
    fx = np.load(FIXTURE)
    text, hints = fx["lengths"], fx["hint_lengths"].reshape(-1)
    keep = []
    for label, B, T, H in SHAPES:
        lengths = (text if T == 64 else hints)[:B]
        args = inputs(B, T, H, lengths, H + B)
        steps = int(lengths.max())
        calls = {k: caller(lib, args, keep) for k, lib in libs.items()}
        ms = {k: [] for k in calls}
        for k in list(calls) + list(calls)[::-1]:
            ms[k].append(timed(calls[k], reps=5))
        want = tlstm.lstm_final_hidden_plain(*args)
        outs = {k: c().clone() for k, c in calls.items()
                if k in ("A", "B")}
        print(f"{label} B={B} T={T} H={H} ({steps} steps):")
        for k, v in ms.items():
            t = statistics.median(v)
            err = (f", error against plain "
                   f"{float((outs[k] - want).abs().max()):.1e}"
                   if k in outs else "")
            print(f"  {k}: {t:.3f} ms ({1e3 * t / steps:.2f} us a step; "
                  f"{min(v):.3f}-{max(v):.3f}){err}", flush=True)
        if len(outs) == 2:
            print(f"  A and B bit-identical: "
                  f"{torch.equal(outs['A'], outs['B'])}")
        keep.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
