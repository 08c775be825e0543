#!/usr/bin/env python3
"""The GNN second form's wide route (``csrc/superglue_gnn_any.cu``,
namespace ``wide``) against variants of its own source, at chip_smoke phase
14's shape: 1,280 pairs of (768, 48, 6), 12 blocks, seeded random weights
and L2-normalized descriptors. Each variant is the source with one design
choice undone, built with the port's ``nvcc`` flags beside the port's own
build and launched through ctypes:

- ``one k-step``: the products' k-step loop not unrolled;
- ``predicated tiles``: every product tile on the predicated path (no
  full-tile instantiation);
- ``inlined products``: ``gemm_tc`` inlined into the kernel;
- ``4-column f32 tiles``: f32 thread tiles of 8 x 4 instead of 8 x 8;
- ``stage clocks``: built with ``-DT2P_STAGE_CLOCKS`` (each stage's share
  of the first thread's clocks, summed over CTAs);
- ablations, whose scores are wrong by design: ``no products`` (the MMAs
  replaced by register moves of their operands) and ``no copies`` (no
  cp.async of rows or weights into the ring).

Prints the card's name and power limit, each build's ``ptxas`` lines of
the two wide kernels (registers, spills), whether its scores are
bit-identical to the source's, and the median device time a launch (3
launches between CUDA events) at 1, 2 and 3 pairs a CTA for the source and
at the plan's pairs for the variants.

    python3 scripts/check_gnn_wide_route.py

Needs a CUDA card and ``nvcc`` (a few minutes, most of it the builds).
"""

from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from text2pos_torch.ops import _build  # noqa: E402
from text2pos_torch.ops import superglue_gnn as tgnn  # noqa: E402

E, T0, T1, N, L = 768, 48, 6, 1280, 12
GNN_WEIGHTS = ("wqkv", "bqkv", "wm", "bm", "w0", "s0", "t0", "w1", "b1",
               "wf", "bf")
STAGES = ("load", "qkv", "attention", "merge", "W0", "W1", "final", "scores")
# (name, [(text in the source, its replacement)], extra nvcc flags, exact):
# exact variants must give the source's scores bit for bit.
VARIANTS = [
    ("one k-step", [("#pragma unroll 2\n    for (int kk = 0; kk < KK;",
                     "#pragma unroll 1\n    for (int kk = 0; kk < KK;")],
     [], True),
    ("predicated tiles", [("if (mt == 8 && ntc == 16)", "if (false)"),
                          ("if (mt == 4 && ntc == 32)", "if (false)")],
     [], True),
    ("inlined products", [("__device__ __noinline__ void gemm_tc(",
                           "__device__ __forceinline__ void gemm_tc(")],
     [], True),
    ("4-column f32 tiles", [("constexpr int CTW = 2;",
                             "constexpr int CTW = 1;")], [], True),
    ("stage clocks", [], ["-DT2P_STAGE_CLOCKS"], True),
    ("no products", [(
        "if (FULL || wn * 4 + j < ntc) mma_zero(d[j], a[i], b[j].x, b[j].y);",
        "if (FULL || wn * 4 + j < ntc) {\n"
        "              d[j][0] = __uint_as_float(a[i][0] ^ b[j].x);\n"
        "              d[j][1] = __uint_as_float(a[i][1] ^ b[j].y);\n"
        "              d[j][2] = __uint_as_float(a[i][2]);\n"
        "              d[j][3] = __uint_as_float(a[i][3]);\n"
        "            }")], [], False),
    ("no copies", [("i < mt * 2 * KSL; i += NT)", "i < 0; i += NT)"),
                   ("i < ntc * KSL; i += NT)", "i < 0; i += NT)"),
                   ("i < mr * 4; i += NT)", "i < 0; i += NT)"),
                   ("i < FKSL * nc4; i += NT)", "i < 0; i += NT)")],
     [], False),
]


def build_variants(tmp: Path):
    """{name: (library, ptxas lines of the wide kernels)}."""
    csrc = _build.CSRC
    src = (csrc / "superglue_gnn_any.cu").read_text()
    procs = {}
    for name, reps, flags, _ in VARIANTS:
        text = src
        for old, new in reps:
            if old not in text:
                raise RuntimeError(f"{name}: the source has no {old!r}")
            text = text.replace(old, new)
        d = tmp / name.replace(" ", "_")
        d.mkdir()
        shutil.copy(csrc / "mma_bf16.cuh", d)
        (d / "superglue_gnn_any.cu").write_text(text)
        procs[name] = (subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
             str(d / "lib.so"), str(d / "superglue_gnn_any.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d)
    _build.build_all(("superglue_gnn_any",))
    out = {"source": (_build.library("superglue_gnn_any"),
                      wide_ptxas(_build.build_log("superglue_gnn_any")))}
    for name, (proc, d) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = (ctypes.CDLL(str(d / "lib.so")), wide_ptxas(log))
    return out


def wide_ptxas(log: str):
    """The ptxas lines of the wide kernels: {dtype: 'spills | registers'}."""
    lines = log.splitlines()
    out = {}
    for i, ln in enumerate(lines):
        if "Function properties for" in ln and "wide11wide_kernel" in ln:
            dt = "bf16" if "ILb1" in ln else "f32"
            out[dt] = (lines[i + 1].strip() + " | "
                       + lines[i + 2].split(":", 1)[-1].strip())
    return out


def launcher(lib, d0, d1, packed, G):
    """A launch of the wide route of ``lib`` at G pairs a CTA."""
    dt = packed["wqkv"].dtype
    bf16 = int(dt == torch.bfloat16)
    Ep = tgnn.packed_width(packed)
    size, fn = lib.t2p_superglue_gnn_any_workspace, lib.t2p_superglue_gnn_any
    size.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p] * 3
    nbytes = ctypes.c_longlong(0)
    _build.check(size(E, Ep, T0, T1, bf16, 1, G, N, ctypes.byref(nbytes)),
                 "workspace")
    ws = torch.empty(nbytes.value, dtype=torch.uint8, device="cuda")
    out = torch.empty(N, T0, T1, device="cuda")
    args = [d0.data_ptr(), d1.data_ptr(),
            *(packed[k].data_ptr() for k in GNN_WEIGHTS),
            L, N, E, Ep, T0, T1, bf16, 1, G, ws.data_ptr(), out.data_ptr()]

    def call():
        _build.check(fn(*args, torch.cuda.current_stream().cuda_stream),
                     "superglue_gnn_any_wide")
        return out
    call.keep = (d0, d1, packed, ws, out)   # the launch reads their memory
    return call


def ms_of(call, reps=3) -> float:
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            call()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"# {gpu}; (E, T0, T1) = ({E}, {T0}, {T1}), {N} pairs, {L} blocks")
    with tempfile.TemporaryDirectory() as d:
        libs = build_variants(Path(d))
        for name, (_, ptxas) in libs.items():
            for dt, line in ptxas.items():
                print(f"# ptxas {name} {dt}: {line}")
        g = torch.Generator(device="cuda").manual_seed(18)
        d0 = torch.nn.functional.normalize(torch.randn(
            N, T0, E, device="cuda", generator=g), dim=-1)
        d1 = torch.nn.functional.normalize(torch.randn(
            N, T1, E, device="cuda", generator=g), dim=-1)
        exact = {name: ex for name, _, _, ex in VARIANTS}
        for label, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            packed = tgnn.pack_gnn_params(
                tgnn.random_folded_params(L, seed=18, width=E), dt, "cuda")
            plan = tgnn.any_plan(E, T0, T1, dt)
            src_lib = libs["source"][0]
            with torch.inference_mode():
                src = launcher(src_lib, d0, d1, packed, plan.pairs)
                ref = src().clone()
                times = ", ".join(
                    f"G = {G} {ms_of(launcher(src_lib, d0, d1, packed, G)):.2f}"
                    " ms" for G in (1, 2, 3))
                print(f"{label} source (plan: {plan.pairs} pairs a CTA, "
                      f"{plan.rows} rows): {times}", flush=True)
                for name, (lib, _) in libs.items():
                    if name == "source" or (label == "bf16"
                                            and name.startswith("4-column")):
                        continue
                    call = launcher(lib, d0, d1, packed, plan.pairs)
                    same = bool(torch.equal(call(), ref))
                    line = (f"{label} {name}: {ms_of(call):.2f} ms; "
                            + (f"bit-identical to the source: {same}"
                               if exact[name] else "scores wrong by design"))
                    if name == "stage clocks":
                        clocks = lib.t2p_superglue_gnn_any_stage_clocks
                        clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
                        buf = (ctypes.c_ulonglong * len(STAGES))()
                        clocks(buf, 1)
                        call()
                        torch.cuda.synchronize()
                        clocks(buf, 0)
                        total = sum(buf)
                        line += "; stages: " + ", ".join(
                            f"{s} {100 * v / total:.1f}%"
                            for s, v in zip(STAGES, buf))
                    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
