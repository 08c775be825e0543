#!/usr/bin/env python3
"""What the card's tools cannot say of the SuperGlue-GNN kernels.

    python3 scripts/check_gnn_kernel.py [--f32]

Needs one NVIDIA GPU and ``nvcc``; random weights and descriptors from a
seed, no checkpoint. It builds ``csrc/superglue_gnn.cu`` as the port
builds it, with ``-DT2P_EXACT_SOFTMAX``, with ``-DT2P_STAGE_CLOCKS`` and as
the f32 route's timing-only builds below, and the second form
``csrc/superglue_gnn_any.cu`` twice more (``-DT2P_STAGE_CLOCKS``, and that
with ``-DT2P_NO_WEIGHT_LOADS``), all at once, and prints what neither
``tests/test_torch_port_kernels*.py`` nor ``chip_smoke.py`` gives:

- **Error at full depth.** At 12 blocks, 37 and 512 pairs, the largest
  difference relative to the largest score between: the kernel and the plain
  version; the exact-softmax build (``expf``, IEEE division) and the plain
  version; the two builds; and the plain version on the card and on the CPU,
  two runs of the same arithmetic that differ only in the order of their
  f32 sums. With random weights the scores reach several hundred and a sum
  that lands on the other side of a bf16 rounding boundary is carried on
  through every later block, so these are readings beside the 1e-2 that the
  tests hold the kernel to at 2 and 4 blocks and ``chip_smoke.py`` at 12
  blocks on the trained weights; only the f32 kernel (1e-5) and non-finite
  values fail the script.
- **Clocks by stage.** The share of the bf16 kernel's clocks spent in each
  of its stages at the headline serve's size (20,480 pairs, 12 blocks). The
  instrumented build adds a barrier after every stage and is a few percent
  slower; its time is printed beside the plain build's.
- **The second form at E = 300** (JAX's default width, heads padded to
  80 in bf16 and 76 in f32): the same error readings at 12 blocks
  (T0 = 16, T1 = 6), and the shared route's clocks by stage at the E = 300
  headline's size (20,480 pairs, 12 blocks), bf16 and f32, with the
  weight waits: the
  build whose weight loads are register values does the same products,
  so its stage clocks subtracted from the instrumented build's are the
  clocks spent waiting for weights from L2.

- **The f32 route's split.** At the headline's 20,480 pairs x 12 blocks,
  the cascade's cheap pass (262,144 x 2) and the evaluator's chunk (80 x
  12): the port's build, the build with ``-DT2P_STAGE_CLOCKS`` and two
  timing-only ablations (``-DT2P_GNN_W_SMEM``: the weights read from a
  tile already in shared memory, no L2 or L1 weight reads;
  ``-DT2P_GNN_NO_ATTENTION``: no attention), and the share of the clocks
  in each stage; beside the port's build, which picks its pairs a CTA by
  the launch's size, the timing-only builds with each form forced
  (``-DT2P_GNN_F32_PAIRS=1``, ``2``, ``4``).

About two minutes, most of it the builds; with ``--f32`` only the error
readings and the f32 route's split (the second form is not built).
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from text2pos_torch.ops import _build  # noqa: E402
from text2pos_torch.ops import superglue_gnn as tgnn  # noqa: E402

REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
STAGES = ("load", "qkv", "attention", "merge", "W0", "W1", "final", "scores")
ANY_BUILDS = {"T2P_STAGE_CLOCKS": ("-DT2P_STAGE_CLOCKS",),
              "T2P_NO_WEIGHT_LOADS": ("-DT2P_STAGE_CLOCKS",
                                      "-DT2P_NO_WEIGHT_LOADS")}
WIDE_E = 300
# Timing-only builds of the f32 route (wrong results, the same products):
# its weights read from a tile already in shared memory instead of from L2,
# and no attention.
F32_ABLATIONS = ("T2P_GNN_W_SMEM", "T2P_GNN_NO_ATTENTION")
# Builds of the f32 route with its pairs a CTA forced at every size (for
# timing; the scores do not depend on it).
F32_FORMS = tuple(f"T2P_GNN_F32_PAIRS={g}" for g in (1, 2, 4))
# The f32 route's shapes: the bench headline, the cascade's cheap pass and
# the evaluator's chunk (pairs, blocks).
F32_SHAPES = ((20480, 12), (262144, 2), (80, 12))
WEIGHTS = ("wqkv", "bqkv", "wm", "bm", "w0", "s0", "t0", "w1", "b1", "wf",
           "bf")


def build_variants(f32_only=False):
    """The port's own libraries and the diagnostic builds, compiled side
    by side; returns {define or "": CDLL} for ``superglue_gnn.cu`` and
    {"any " + define: CDLL} for the second form (not with ``f32_only``)."""
    out_dir = _build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {define: ("superglue_gnn", (f"-D{define}",))
            for define in ("T2P_EXACT_SOFTMAX", "T2P_STAGE_CLOCKS")
            + F32_ABLATIONS + F32_FORMS}
    if not f32_only:
        jobs.update({f"any {k}": ("superglue_gnn_any", v)
                     for k, v in ANY_BUILDS.items()})
    procs = {}
    for key, (name, flags) in jobs.items():
        so = out_dir / f"lib{name}_{key.split()[-1].replace('=', '')}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags,
               "-o", str(so), str(_build.CSRC / f"{name}.cu")]
        procs[key] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    _build.build_all(("superglue_gnn",) if f32_only
                     else ("superglue_gnn", "superglue_gnn_any"))
    libs = {"": _build.library("superglue_gnn")}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {key} failed:\n{log}")
        libs[key] = ctypes.CDLL(str(so))
    return libs


def launch(lib, d0, d1, packed):
    """The kernel of ``lib`` on contiguous f32 descriptors, as the port's
    wrapper calls it."""
    fn = lib.t2p_superglue_gnn
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    out = torch.empty(d0.shape[0], 16, 6, device=d0.device)
    _build.launch(fn, d0.device, "superglue_gnn", d0.data_ptr(),
                  d1.data_ptr(), *(packed[k].data_ptr() for k in WEIGHTS),
                  packed["wqkv"].shape[0], d0.shape[0],
                  int(packed["wqkv"].dtype == torch.bfloat16),
                  out.data_ptr())
    return out


def launch_any(lib, d0, d1, packed):
    """The second form of ``lib`` on contiguous f32 descriptors, on the
    route and pairs a CTA that ``any_plan`` gives, as the port's wrapper
    calls it."""
    N, T0, E = d0.shape
    T1 = d1.shape[1]
    dt = packed["wqkv"].dtype
    plan = tgnn.any_plan(E, T0, T1, dt)
    bf16, route = int(dt == torch.bfloat16), int(plan.route.endswith("wide"))
    size = lib.t2p_superglue_gnn_any_workspace
    size.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    size.restype = ctypes.c_int
    nbytes = ctypes.c_longlong(0)
    _build.check(size(E, plan.width, T0, T1, bf16, route, plan.pairs, N,
                      ctypes.byref(nbytes)), "workspace")
    ws = torch.empty(max(nbytes.value, 1), dtype=torch.uint8,
                     device=d0.device)
    fn = lib.t2p_superglue_gnn_any
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    out = torch.empty(N, T0, T1, device=d0.device)
    _build.launch(fn, d0.device, plan.route, d0.data_ptr(), d1.data_ptr(),
                  *(packed[k].data_ptr() for k in WEIGHTS),
                  packed["wqkv"].shape[0], N, E, plan.width, T0, T1, bf16,
                  route, plan.pairs, ws.data_ptr(), out.data_ptr())
    return out


def descs(n, device, seed, E=128, T0=16, T1=6):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, T0, E, generator=g).to(device),
            torch.randn(n, T1, E, generator=g).to(device))


def cuda_ms(fn, reps=5, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def depth_readings(libs, dev, blocks=12):
    """Prints the full-depth differences; returns the failures."""
    failures = []
    folded = tgnn.random_folded_params(blocks)
    for dtype in (torch.bfloat16, torch.float32):
        packed = tgnn.pack_gnn_params(folded, dtype, dev)
        on_cpu = {k: v.cpu() for k, v in packed.items()}
        for n in (37, 512):
            d0, d1 = descs(n, dev, 100 * blocks + n)
            plain = tgnn.gnn_scores_plain(d0, d1, packed)
            runs = {"kernel": launch(libs[""], d0, d1, packed),
                    "plain on the CPU": tgnn.gnn_scores_plain(
                        d0.cpu(), d1.cpu(), on_cpu).to(dev)}
            if dtype == torch.bfloat16:
                runs["exact-softmax build"] = launch(
                    libs["T2P_EXACT_SOFTMAX"], d0, d1, packed)
            torch.cuda.synchronize()
            scale = float(plain.abs().max())
            name = str(dtype)[6:]
            print(f"{name} L={blocks} N={n}: |scores| max {scale:.1f}, "
                  f"tolerance {REL_TOL[dtype]:g} of it")
            for what, got in runs.items():
                rel = float((got - plain).abs().max()) / scale
                print(f"  {what} vs plain on the card: {rel:.3e} "
                      f"({rel / REL_TOL[dtype]:.2f} of the tolerance)")
                bad = not bool(torch.isfinite(got).all()) or (
                    dtype == torch.float32 and what == "kernel"
                    and rel > REL_TOL[dtype])
                if bad:
                    failures.append((name, n, what, rel))
            if dtype == torch.bfloat16:
                rel = float((runs["kernel"] - runs["exact-softmax build"])
                            .abs().max()) / scale
                print(f"  kernel vs exact-softmax build: {rel:.3e}")
    return failures


def stage_clocks(libs, dev, pairs=20480, blocks=12):
    d0, d1 = descs(pairs, dev, 7)
    packed = tgnn.pack_gnn_params(tgnn.random_folded_params(blocks),
                                  torch.bfloat16, dev)
    lib = libs["T2P_STAGE_CLOCKS"]
    clocks = lib.t2p_superglue_gnn_stage_clocks
    clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    clocks.restype = ctypes.c_int
    ms = cuda_ms(lambda: launch(libs[""], d0, d1, packed))
    ms_i = cuda_ms(lambda: launch(lib, d0, d1, packed))
    _build.check(clocks(None, 1), "stage clocks reset")
    launch(lib, d0, d1, packed)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * len(STAGES))()
    _build.check(clocks(buf, 0), "stage clocks read")
    total = float(sum(buf))
    ctas = -(-pairs // tgnn.TC_PAIRS)
    print(f"bf16 kernel N={pairs} L={blocks}: {ms:.3f} ms, with stage clocks "
          f"{ms_i:.3f} ms, {total / ctas:.0f} clocks a CTA; "
          + ", ".join(f"{k} {100 * v / total:.1f}%"
                      for k, v in zip(STAGES, buf)))


def f32_split(libs, dev, pairs, blocks):
    """The tuned f32 route at ``pairs`` x ``blocks``: the time of the
    port's build, the instrumented build and each ablation, and the share
    of the clocks in each stage (a unit: a CTA's pairs)."""
    d0, d1 = descs(pairs, dev, 7)
    packed = tgnn.pack_gnn_params(tgnn.random_folded_params(blocks),
                                  torch.float32, dev)
    reps = 3 if pairs * blocks > 100000 else 10
    ms = {k: cuda_ms(lambda lib=libs[k]: launch(lib, d0, d1, packed),
                     reps=reps)
          for k in ("", "T2P_STAGE_CLOCKS") + F32_ABLATIONS}
    lib = libs["T2P_STAGE_CLOCKS"]
    clocks = lib.t2p_superglue_gnn_f32_stage_clocks
    clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    clocks.restype = ctypes.c_int
    _build.check(clocks(None, 1), "stage clocks reset")
    launch(lib, d0, d1, packed)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * len(STAGES))()
    _build.check(clocks(buf, 0), "stage clocks read")
    total = float(sum(buf))
    ctas = -(-pairs // tgnn.f32_pairs(pairs))
    forced = [cuda_ms(lambda lib=libs[k]: launch(lib, d0, d1, packed),
                      reps=reps) for k in F32_FORMS]
    print(f"f32 kernel N={pairs} L={blocks}: {ms['']:.3f} ms ("
          f"{tgnn.f32_pairs(pairs)} pairs a CTA; with 1, 2, 4: "
          + ", ".join(f"{v:.3f}" for v in forced)
          + f" ms), with stage clocks {ms['T2P_STAGE_CLOCKS']:.3f} ms, "
          + ", ".join(f"{k[8:].lower()} {ms[k]:.3f} ms ({ms[k] / ms[''] - 1:+.1%})"
                      for k in F32_ABLATIONS)
          + f"; {total / ctas:.0f} clocks a CTA: "
          + ", ".join(f"{k} {100 * v / total:.1f}%"
                      for k, v in zip(STAGES, buf)))


def any_depth_readings(dev, blocks=12):
    """The second form at E = 300 and 12 blocks against the plain version
    on the card (and the plain version on the CPU); returns the failures
    (non-finite scores, f32 over its tolerance)."""
    failures = []
    folded = tgnn.random_folded_params(blocks, width=WIDE_E)
    for dtype in (torch.bfloat16, torch.float32):
        packed = tgnn.pack_gnn_params(folded, dtype, dev)
        on_cpu = {k: v.cpu() for k, v in packed.items()}
        for n in (37, 512):
            d0, d1 = descs(n, dev, 100 * blocks + n, E=WIDE_E)
            plain = tgnn.gnn_scores_plain(d0, d1, packed)
            runs = {"kernel": tgnn._gnn_kernel(d0, d1, packed),
                    "plain on the CPU": tgnn.gnn_scores_plain(
                        d0.cpu(), d1.cpu(), on_cpu).to(dev)}
            torch.cuda.synchronize()
            scale = float(plain.abs().max())
            name = str(dtype)[6:]
            plan = tgnn.any_plan(WIDE_E, 16, 6, dtype)
            print(f"second form {name} E={WIDE_E} L={blocks} N={n} "
                  f"({plan.route}, {plan.pairs} pairs a CTA, width "
                  f"{plan.width}): |scores| max {scale:.1f}")
            for what, got in runs.items():
                rel = float((got - plain).abs().max()) / scale
                print(f"  {what} vs plain on the card: {rel:.3e} "
                      f"({rel / REL_TOL[dtype]:.2f} of the tolerance)")
                if not bool(torch.isfinite(got).all()) or (
                        dtype == torch.float32 and what == "kernel"
                        and rel > REL_TOL[dtype]):
                    failures.append((f"any {name}", n, what, rel))
    return failures


def any_stage_clocks(libs, dev, dtype, pairs=20480, blocks=12):
    """The shared route's clocks by stage at the E = 300 headline's size
    (a unit: the pairs of a CTA), with and without weight loads."""
    d0, d1 = descs(pairs, dev, 7, E=WIDE_E)
    packed = tgnn.pack_gnn_params(tgnn.random_folded_params(
        blocks, width=WIDE_E), dtype, dev)
    ms = cuda_ms(lambda: tgnn._gnn_kernel(d0, d1, packed), reps=3)
    plan = tgnn.any_plan(WIDE_E, 16, 6, dtype)
    ctas = -(-pairs // plan.pairs)
    readings = {}
    for key in ANY_BUILDS:
        lib = libs[f"any {key}"]
        clocks = lib.t2p_superglue_gnn_any_stage_clocks
        clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
        clocks.restype = ctypes.c_int
        ms_i = cuda_ms(lambda: launch_any(lib, d0, d1, packed), reps=3)
        _build.check(clocks(None, 1), "stage clocks reset")
        launch_any(lib, d0, d1, packed)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * len(STAGES))()
        _build.check(clocks(buf, 0), "stage clocks read")
        readings[key] = (ms_i, [float(v) for v in buf])
    ms_c, clk = readings["T2P_STAGE_CLOCKS"]
    ms_n, clk_n = readings["T2P_NO_WEIGHT_LOADS"]
    total = sum(clk)
    print(f"second form {str(dtype)[6:]} E={WIDE_E} N={pairs} L={blocks}: "
          f"{ms:.3f} ms "
          f"({plan.pairs} pairs a CTA, {plan.rows} rows, {ctas} CTA units), "
          f"with stage clocks {ms_c:.3f} ms, without weight loads "
          f"{ms_n:.3f} ms; {total / ctas:.0f} clocks a unit: "
          + ", ".join(f"{k} {100 * v / total:.1f}%"
                      for k, v in zip(STAGES, clk)))
    waits = {k: max(a - b, 0.0) for k, a, b in zip(STAGES, clk, clk_n)
             if k in ("qkv", "merge", "W0", "W1", "final")}
    print("  weight waits (stage clocks less the build without weight "
          "loads), share of all clocks: "
          + ", ".join(f"{k} {100 * v / total:.1f}%" for k, v in waits.items())
          + f"; all {100 * sum(waits.values()) / total:.1f}%")


def main() -> int:
    if not torch.cuda.is_available():
        print("check_gnn_kernel: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    f32_only = "--f32" in sys.argv[1:]
    libs = build_variants(f32_only)
    failures = depth_readings(libs, dev)
    for pairs, blocks in F32_SHAPES:
        f32_split(libs, dev, pairs, blocks)
    if f32_only:
        if failures:
            print("FAILURES:", failures, file=sys.stderr)
            return 1
        print("ok")
        return 0
    stage_clocks(libs, dev)
    failures += any_depth_readings(dev)
    for dtype in (torch.bfloat16, torch.float32):
        any_stage_clocks(libs, dev, dtype)
    if failures:
        print("FAILURES:", failures, file=sys.stderr)
        return 1
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
