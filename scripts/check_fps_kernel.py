#!/usr/bin/env python3
"""Where the FPS kernel's time goes, on one NVIDIA GPU.

    python3 scripts/check_fps_kernel.py

Builds ``csrc/fps.cu`` as the port does and prints the card's name and
power limit, the registers ``ptxas`` reports, then the device time a launch
of the levels entry two ways: from a CUDA graph of 20 launches replayed
between two events (no host gaps; median of 10) and 20 launches back to
back from the host (median of 10), each launch bit for bit against the
plain loop. Cases: 1024 and 787 objects (the DB encode's towers) with
duplicates, of 64 points one level (S = 32) and three (64 -> 32 -> 16 ->
8), and of 256 points the forward's levels 128, 64, 32 and their first one
and two levels, from which the time per dependent step of each level is
read. Then the dependent chain a step cannot avoid (``chain_step_time``)
and the latency floor of a forward's levels. About half a minute of
command on the card.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from text2pos_torch.ops import _build  # noqa: E402
from text2pos_torch.ops import fps as tfps  # noqa: E402


def points(B, N, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.randn(B, 60, 3, device="cuda", generator=g)
    pick = torch.randint(0, 60, (B, N), device="cuda", generator=g)
    return torch.gather(base, 1, pick[..., None].expand(B, N, 3)).contiguous()


def timed(fn, reps=10, launches=20):
    """(graph, host loop): the median device time a launch, from a CUDA
    graph of ``launches`` calls replayed between two events, and from
    ``launches`` calls issued back to back by the host."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    out = {"graph": [], "loop": []}
    for _ in range(reps):
        for key, run in (("graph", g.replay),
                         ("loop", lambda: [fn() for _ in range(launches)])):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            run()
            b.record()
            b.synchronize()
            out[key].append(a.elapsed_time(b) / launches)
    return statistics.median(out["graph"]), statistics.median(out["loop"])


def levels_case(label, pts, sizes):
    """((graph ms, loop ms) a launch of ``sizes`` chained levels, whether
    they equal the plain loop level by level), printed."""
    fn = _build.entry("fps", "t2p_fps_levels", [ctypes.c_void_p] * 4
                      + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    B, N, _ = pts.shape
    idx, cent, scratch, got = tfps._buffers(pts, sizes)
    S = list(sizes) + [0] * (tfps.MAX_LEVELS - len(sizes))
    args = [pts.data_ptr(), idx.data_ptr(), cent.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, N,
            len(sizes), *S]

    def call():
        _build.check(fn(*args, torch.cuda.current_stream().cuda_stream),
                     "fps levels")
    call()
    src, same = pts, True
    for (i, c), s in zip(got, sizes):
        wi, wc = tfps.farthest_point_sampling_plain(src, s)
        same &= torch.equal(i, wi) and torch.equal(c, wc)
        src = wc
    g, h = timed(call)
    steps = sum(s - 1 for s in sizes)
    print(f"{label} S={list(sizes)} ({steps} steps): {g:.4f} ms a launch "
          f"in a graph ({1e3 * g / steps:.3f} us a step), {h:.4f} from the "
          f"host; bit-identical to plain: {same}")
    return (g, h), same


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"# {gpu}")
    _build.build_all(("fps",))
    regs = sorted({line.split("Used")[1].split(",")[0].strip()
                   for line in _build.build_log("fps").splitlines()
                   if "Used" in line})
    print(f"# ptxas: {', '.join(regs)}")
    ok = True
    with torch.inference_mode():
        for B in (1024, 787):
            pts = points(B, 64, B)
            for sizes in ((32,), (32, 16, 8)):
                ok &= levels_case(f"B={B} N=64", pts, sizes)[1]
        for B in (1024, 787):
            pts = points(B, 256, B)
            full = (128, 64, 32)
            t = [levels_case(f"B={B} N=256", pts, full[:L])
                 for L in (1, 2, 3)]
            ok &= all(same for _, same in t)
            g = [0.0] + [r[0] for r, _ in t]
            print(f"  B={B} us per dependent step by level (graph): "
                  + ", ".join(f"{1e3 * (g[l + 1] - g[l]) / (S - 1):.3f}"
                              for l, S in enumerate(full)))
        clocks, ns = sorted(tfps.chain_step_time(torch.device("cuda"))
                            for _ in range(3))[1]
        floor = sum(s - 1 for s in (128, 64, 32)) * ns * 1e-6
        print(f"dependent chain a step: {clocks:.1f} clocks = {ns:.2f} ns; "
              f"latency floor of a forward's levels (221 steps) "
              f"{floor:.4f} ms")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
