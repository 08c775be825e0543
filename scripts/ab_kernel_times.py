#!/usr/bin/env python3
"""Device times of the port's kernels built from two source trees, in one
process on one card, in the order A, B, B, A.

    python3 scripts/ab_kernel_times.py OTHER_CSRC_DIR

A is this checkout's ``text2pos_torch/csrc``, B the other directory (for
example the parent commit's ``text2pos_torch/csrc``, unpacked with
``git archive``). Each side's ``csrc/*.cu`` are built with the port's
``nvcc`` flags. Shapes: the LSTM at the bench serving encoders'
(2048 queries x 64 tokens at H = 256; 12,288 hints x 16 tokens at H = 128;
both at H = 300, JAX's default width, where W_hh is read from L2 (the L2
form), with the bench fixture's lengths (the E = 300 serving path's
steps) and with random ones, and the queries at H = 288, 320, 384, 416
and 512; seeded random weights and, but where named, lengths;
each side's error and the plain f32 version's against a float64
evaluation), and the bench's bf16 headline and the E = 300 one
(chip_smoke's ``wide_pipeline``) with each side's LSTM (the other kernels
A's),
FPS at the six levels of a DB-encode step (1024 and 787 objects at 256,
128 and 64 points, half sampled, points with duplicates) one launch a
level (``t2p_fps``), then a forward's three levels as the model runs them:
one ``t2p_fps_levels`` launch where the side has it, else three
``t2p_fps`` launches, each on the last one's centroids; Sinkhorn at the
headline's 20,480 pairs (16 x 6 scores, dustbins, 50 iterations); the
LSTM's grid form (H > 512) at chip_smoke phase 14's two launches (128
texts of 64 tokens, 768 hints of 16, H = 768, the bench fixture's
lengths) and at 2048 x 64 for H = 768, 1024 and 2048; Sinkhorn's
wide form on phase 14's 1,280 couplings of 48 x 6 scores (dustbins, 50
iterations; also 0 and 1 iterations, and 50 on 128 and 5,120 couplings),
with whether the two sides' outputs are bit-identical;
PointConv at the DB encode's sa1 level (1024 objects, 256 -> 128 points,
32 -> 64 channels) in bf16 and f32; the tuned GNN
(``superglue_gnn.cu``) at the bench headline's 20,480 pairs of (128, 16, 6)
in bf16 and f32, and the GNN's second form (``superglue_gnn_any.cu``) at
the E = 300 headline's size in bf16 and f32 and at pad_size 24 in bf16
(its CTAs hold 4 m-tiles), and its wide route at chip_smoke phase 14's
path shape, 1,280 pairs of (768, 48, 6), in bf16 and f32 (12 blocks, seeded random
weights; each side gets the weight layout its own source reads: the
padded pack of ``pack_gnn_params``, or the unpadded row-major one of the
form before it). Prints the
median device time a launch (10 repeats of 20 launches back to back
between two CUDA events; for the second form 3 of 2; for FPS, whose
launches take tens of microseconds, from a CUDA graph of the 20) and the
card's name
and power limit, and for the second form each side's largest error and
the plain f32 version's against a float64 evaluation of the same inputs
(``gnn_scores_plain(..., acc=torch.float64)``, the same rounding points).

Then the drift readings of the second form's bf16 route: each side's GNN
and the plain f32 version against the float64 evaluation on the E = 300
serving path's own inputs (chip_smoke's ``wide_pipeline`` at pad_size 16
and 24: seeded E = 300 models calibrated on the bench map, the
headline's 20,480 pose-cell pairs, 12 blocks), over draws of the hint
encodings: the pipelines built and the hints encoded with side B's LSTM,
side A's and the plain LSTM, and, with side A's, the hints of every
query in seeded permutations (which move the readings by little: the
kernel sums a query's keys in one exact tensor-core sum) and models from
other seeds. For each draw and each of the three: the largest per-pair
error (over GNN_REL_TOL of the float64 scores' largest), the pairs past
it, the median and the 99.9th percentile of the per-pair errors, and the
largest error against the plain f32 version (over GNN_REL_TOL of its
largest score, the earlier ``gnn_sinkhorn_checks`` rule), and for each
side the verdict of chip_smoke's ``depth_gate`` (the second form's bf16
gate at serving depth) with the conditions that fail and its reading at
the cut depth. With ``--drift`` only these readings run, with
``--no-drift`` all but these; ``--only=PREFIX[,PREFIX...]`` keeps the
kernel cases whose label starts so (no headlines). Each LSTM case
also says whether the two sides' outputs are bit-identical, and the
header prints each side's ``ptxas`` lines of ``lstm.cu`` (registers,
spills).

Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
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


KERNELS = ("lstm", "sinkhorn", "superglue_gnn", "superglue_gnn_any",
           "pointconv", "fps")
GNN_WEIGHTS = ("wqkv", "bqkv", "wm", "bm", "w0", "s0", "t0", "w1", "b1",
               "wf", "bf")


def build(csrc: Path, out: Path, tag: str):
    procs = {}
    for name in KERNELS:
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
        if name == "lstm":
            libs["lstm_ptxas"] = [ln.strip() for ln in log.splitlines()
                                  if "registers" in ln or "spill" in ln]
    libs["wide_lstm"] = "wpack_f" in (csrc / "lstm.cu").read_text()
    libs["padded_gnn"] = ("int pairs_per_cta"
                          in (csrc / "superglue_gnn_any.cu").read_text())
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


def graph_timed(fn, reps=10, launches=20):
    """``timed`` from a CUDA graph of ``launches`` calls replayed between
    two events: the device's time without the host's gaps, for kernels
    short enough that issuing them from Python could hold the card back."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    return timed(g.replay, reps, 1) / launches


def lstm_call(libs, B, T, H, lengths=None, V=512, seed=0):
    """A launch at hidden width H, run as the port's wrapper runs it:
    padded to a multiple of 32 and, past 256, W_hh also in fragment order
    for the L2 form. ``lengths`` (numpy) default to random ones in [T/2,
    T]. ``call.inputs`` and ``call.out`` (its [2, B, H] view) for
    ``lstm_f64_errors``."""
    from text2pos_torch.ops import lstm as tlstm

    g = torch.Generator(device="cuda").manual_seed(seed)
    tables = [torch.randn(V, 4 * H, device="cuda", generator=g) * 0.3
              for _ in range(2)]
    w_hh = [(torch.rand(H, 4 * H, device="cuda", generator=g) * 2 - 1)
            / H ** 0.5 for _ in range(2)]
    tokens = torch.randint(0, V, (B, T), device="cuda", generator=g,
                           dtype=torch.int32)
    lengths = (torch.randint(T // 2, T + 1, (B,), device="cuda", generator=g,
                             dtype=torch.int32) if lengths is None else
               torch.as_tensor(lengths, dtype=torch.int32, device="cuda"))
    Hp = tlstm.kernel_width(H)
    ptab = [tlstm.pad_gates(t, H, Hp).contiguous() for t in tables]
    pw = [tlstm.pad_w_hh(w, H, Hp).contiguous() for w in w_hh]
    wpack = ([tlstm.w_hh_fragments(w) for w in pw]
             if Hp > tlstm.SMEM_HIDDEN else None)
    out = torch.empty(2, B, Hp, device="cuda")
    fn = libs["lstm"].t2p_lstm_final_hidden
    extra = ([None, None] if wpack is None else
             [w.data_ptr() for w in wpack]) if libs["wide_lstm"] else []
    fn.argtypes = [ctypes.c_void_p] * (7 + len(extra)) + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    args = [t.data_ptr() for t in (*ptab, *pw)] + extra + [
        t.data_ptr() for t in (tokens, lengths, out)] + [V, T, B, Hp]

    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"lstm launch: CUDA error {err}")
    call.keep = (ptab, pw, wpack, out)
    call.inputs, call.out = (tables, w_hh, tokens, lengths), out[..., :H]
    return call


def lstm_grid_call(libs, B, T, H, lengths=None, V=512, seed=0):
    """A launch of the grid form (H > 512, a multiple of 32) on seeded
    random weights, run as the port's wrapper runs it (W_hh in fragment
    order, a zeroed workspace). ``lengths`` (numpy) default to random ones
    in [T/2, T]."""
    from text2pos_torch.ops import lstm as tlstm

    g = torch.Generator(device="cuda").manual_seed(seed)
    tables = [torch.randn(V, 4 * H, device="cuda", generator=g) * 0.3
              for _ in range(2)]
    w_hh = [(torch.rand(H, 4 * H, device="cuda", generator=g) * 2 - 1)
            / H ** 0.5 for _ in range(2)]
    tokens = torch.randint(0, V, (B, T), device="cuda", generator=g,
                           dtype=torch.int32)
    lengths = (torch.randint(T // 2, T + 1, (B,), device="cuda", generator=g,
                             dtype=torch.int32) if lengths is None else
               torch.as_tensor(lengths, dtype=torch.int32, device="cuda"))
    lib = libs["lstm"]
    wpack = [tlstm.w_hh_fragments(w) for w in w_hh]
    out = torch.empty(2, B, H, device="cuda")
    size = lib.t2p_lstm_grid_workspace
    size.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    n = ctypes.c_longlong(0)
    _build.check(size(H, B, 0, ctypes.byref(n)), "lstm_grid workspace")
    ws = torch.zeros(n.value, dtype=torch.uint8, device="cuda")
    fn = lib.t2p_lstm_final_hidden_grid
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    args = [t.data_ptr() for t in (*tables, *wpack, tokens, lengths, out,
                                   ws)] + [V, T, B, H, 0]

    def call():
        ws.zero_()
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"lstm_grid launch: CUDA error {err}")
    call.keep = (wpack, out, ws)
    call.inputs, call.out = (tables, w_hh, tokens, lengths), out
    return call


def lstm_f64_errors(calls):
    """Each side's final h (its last launch) and the plain f32 version's
    largest error against the plain version evaluated in float64 on the
    same inputs."""
    from text2pos_torch.ops import lstm as tlstm
    from text2pos_torch.utils.float64 import float64_pins

    tables, w_hh, tokens, lengths = calls["A"].inputs
    with torch.inference_mode():
        with float64_pins():
            ref = tlstm.lstm_final_hidden_plain(
                [t.double() for t in tables], [w.double() for w in w_hh],
                tokens, lengths)
        outs = {k: c.out for k, c in calls.items()}
        outs["plain"] = tlstm.lstm_final_hidden_plain(tables, w_hh, tokens,
                                                      lengths)
    return {k: float((v.double() - ref).abs().max()) for k, v in outs.items()}


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


def fps_levels_call(libs, B, N=256, seed=0):
    """A forward's three levels (S = N/2, N/4, N/8): one launch of the
    levels entry, or three of ``t2p_fps`` where the side lacks it."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.randn(B, 60, 3, device="cuda", generator=g)
    pick = torch.randint(0, 60, (B, N), device="cuda", generator=g)
    pts = torch.gather(base, 1, pick[..., None].expand(B, N, 3)).contiguous()
    sizes = (N // 2, N // 4, N // 8)
    idx = [torch.empty(B, S, dtype=torch.long, device="cuda") for S in sizes]
    cent = [torch.empty(B, S, 3, device="cuda") for S in sizes]
    lib = libs["fps"]
    if hasattr(lib, "t2p_fps_levels"):
        fn = lib.t2p_fps_levels
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        # One buffer each, level-major, as the kernel writes them.
        idx = torch.empty(B * sum(sizes), dtype=torch.long, device="cuda")
        cent = torch.empty(3 * B * sum(sizes), device="cuda")

        def call():
            err = fn(pts.data_ptr(), idx.data_ptr(), cent.data_ptr(), None,
                     B, N, 3, *sizes, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"fps levels launch: CUDA error {err}")
        return call
    fn = lib.t2p_fps
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]

    def call():
        src, n = pts, N
        for i, c, S in zip(idx, cent, sizes):
            err = fn(src.data_ptr(), i.data_ptr(), c.data_ptr(), B, n, S,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"fps launch: CUDA error {err}")
            src, n = c, S
    return call


def sinkhorn_call(libs, B=20480, M=16, N=6, iters=50, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    scores = torch.randn(B, M, N, device="cuda", generator=g) * 5
    alpha = torch.ones(1, device="cuda")
    out = torch.empty(B, M + 1, N + 1, device="cuda")
    fn = libs["sinkhorn"].t2p_log_sinkhorn
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]

    def call():
        err = fn(scores.data_ptr(), None, None, alpha.data_ptr(),
                 out.data_ptr(), B, M + 1, N + 1, iters, 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"sinkhorn launch: CUDA error {err}")
    return call


def sinkhorn_wide_call(libs, B=1280, M=48, N=6, iters=50, seed=0):
    """The wide form on phase 14's couplings: [B, M, N] scores, dustbins
    (an [M+1, N+1] coupling), 50 iterations; a workspace of duals for
    whichever side reads one."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    scores = torch.randn(B, M, N, device="cuda", generator=g) * 5
    alpha = torch.ones(1, device="cuda")
    out = torch.empty(B, M + 1, N + 1, device="cuda")
    duals = torch.empty(B, M + N + 2, device="cuda")
    fn = libs["sinkhorn"].t2p_log_sinkhorn_wide
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]

    def call():
        err = fn(scores.data_ptr(), None, None, alpha.data_ptr(),
                 out.data_ptr(), duals.data_ptr(), B, M + 1, N + 1, iters, 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"sinkhorn_wide launch: CUDA error {err}")
    call.keep = (scores, alpha, duals)
    call.out = out
    return call


POINTCONV_LEVELS = (("sa1", (256, 128, 32, 64, 0.2)),
                    ("sa2", (128, 64, 128, 128, 0.3)),
                    ("sa3", (64, 32, 256, 256, 0.4)))


def pointconv_call(libs, dtype, B=1024, N=256, S=128, C1=32, C2=64,
                   radius=0.2, seed=0):
    """One SA level (sa1's by default): resampled points (duplicates), the
    first S as centroids, random projections and BN affines; bf16 W2 in
    fragment order, as both sides' sources read it."""
    from text2pos_torch.ops.pointconv import w2_fragments

    g = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.rand(B, 60, 3, device="cuda", generator=g) - 0.5
    pick = torch.randint(0, 60, (B, N), device="cuda", generator=g)
    pos = torch.gather(base, 1, pick[..., None].expand(B, N, 3)).contiguous()
    cent = pos[:, :S].contiguous()
    a = torch.randn(B, N, C1, device="cuda", generator=g).to(dtype)
    c = (0.3 * torch.randn(B, S, C1, device="cuda", generator=g)).to(dtype)
    w2 = (torch.randn(C1, C2, device="cuda", generator=g) / C1 ** 0.5).to(
        dtype)
    if dtype == torch.bfloat16:
        w2 = w2_fragments(w2)
    vecs = [torch.rand(n, device="cuda", generator=g) + o for n, o in
            ((C1, 0.5), (C1, -0.5), (C2, -0.5), (C2, 0.5), (C2, -0.5))]
    out = torch.empty(B, S, C2, device="cuda", dtype=dtype)
    fn = libs["pointconv"].t2p_pointconv_max
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 \
        + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    args = [t.data_ptr() for t in (a, pos, c, cent, vecs[0], vecs[1], w2,
                                   vecs[2], vecs[3], vecs[4], out)] + [
        B, N, S, C1, C2, radius * radius, 32, int(dtype == torch.bfloat16)]

    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"pointconv launch: CUDA error {err}")
    call.keep = (a, pos, c, cent, w2, vecs, out)
    call.out = out
    return call


def gnn_descs(N, T0, T1, E, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.nn.functional.normalize(torch.randn(
        N, T, E, device="cuda", generator=g), dim=-1) for T in (T0, T1))


def tuned_gnn_call(libs, dtype, N=20480, L=12):
    from text2pos_torch.ops import superglue_gnn as tgnn

    E, T0, T1 = tgnn.KERNEL_SHAPE
    d0, d1 = gnn_descs(N, T0, T1, E, 5)
    packed = tgnn.pack_gnn_params(tgnn.random_folded_params(L, width=E),
                                  dtype, "cuda")
    out = torch.empty(N, T0, T1, device="cuda")
    fn = libs["superglue_gnn"].t2p_superglue_gnn
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 2
    args = [d0.data_ptr(), d1.data_ptr(),
            *(packed[k].data_ptr() for k in GNN_WEIGHTS), L, N,
            int(dtype == torch.bfloat16), out.data_ptr()]

    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"superglue_gnn launch: CUDA error {err}")
    call.keep = (d0, d1, packed, out)
    call.out = out
    return call


def any_gnn_call(libs, dtype, N=20480, L=12, E=300, T0=16, T1=6):
    """The second form at (E, T0, T1): the padded pack and the wrapper's
    plan for a side built from this checkout's kind of source, the
    unpadded row-major weights for the form before it."""
    from text2pos_torch.ops import superglue_gnn as tgnn

    d0, d1 = gnn_descs(N, T0, T1, E, 6)
    packed = tgnn.pack_gnn_params(tgnn.random_folded_params(L, width=E),
                                  dtype, "cuda")
    lib = libs["superglue_gnn_any"]
    bf16 = int(dtype == torch.bfloat16)
    out = torch.empty(N, T0, T1, device="cuda")
    nbytes = ctypes.c_longlong(0)
    size, fn = lib.t2p_superglue_gnn_any_workspace, lib.t2p_superglue_gnn_any
    if libs["padded_gnn"]:
        plan = tgnn.any_plan(E, T0, T1, dtype)
        route = int(plan.route.endswith("wide"))
        size.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
        _build.check(size(E, plan.width, T0, T1, bf16, route, plan.pairs, N,
                          ctypes.byref(nbytes)), "workspace")
        weights = packed
        ints = [L, N, E, plan.width, T0, T1, bf16, route, plan.pairs]
    else:
        size.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        _build.check(size(E, T0, T1, bf16, N, ctypes.byref(nbytes)),
                     "workspace")
        weights = {k: (v.to(dtype) if k in tgnn.MATMUL_WEIGHTS else v)
                   .contiguous()
                   for k, v in tgnn.gnn_weights(packed).items()}
        ints = [L, N, E, T0, T1, bf16]
    ws = torch.empty(max(nbytes.value, 1), dtype=torch.uint8, device="cuda")
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * len(ints) \
        + [ctypes.c_void_p] * 3
    args = [d0.data_ptr(), d1.data_ptr(),
            *(weights[k].data_ptr() for k in GNN_WEIGHTS), *ints,
            ws.data_ptr(), out.data_ptr()]

    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"superglue_gnn_any launch: CUDA error {err}")
    call.keep = (d0, d1, weights, ws, out)
    call.inputs, call.out = (d0, d1, packed), out
    return call


def f64_errors(calls):
    """Each side's scores (its last launch) and the plain f32 version's
    against the float64 evaluation of the same inputs and weights
    (``gnn_scores_plain(..., acc=torch.float64)``), as the largest error
    over the checks' tolerance (1% of the largest score in bf16, 1e-5 in
    f32) and the pairs past it."""
    import chip_smoke as cs
    from text2pos_torch.ops import superglue_gnn as tgnn

    d0, d1, packed = calls["A"].inputs
    rel = 1e-2 if packed["wqkv"].dtype == torch.bfloat16 else 1e-5
    with torch.inference_mode():
        ref = cs.f64_scores(d0, d1, packed)
        outs = {k: c.out for k, c in calls.items()}
        outs["plain"] = tgnn.gnn_scores_plain(d0, d1, packed)
    tol = rel * float(ref.abs().max())
    out = {}
    for k, v in outs.items():
        d = (v - ref).abs().amax((1, 2))
        out[k] = (float(d.max()) / tol, int((d > tol).sum()))
    return out


DRIFT_PERMUTATIONS = (1, 2)
DRIFT_SEEDS = (310, 320, 330, 340)


def drift_readings(sides, fx=None, bank=None, device="cuda"):
    """The second form's bf16 drift on the E = 300 serving inputs (see the
    module's docstring); prints a line a draw and pad_size. ``fx``,
    ``bank`` and ``device`` (the bench fixture, the bench map, the card by
    default) let a dry run on the CPU cut them."""
    import numpy as np

    import chip_smoke as cs
    from text2pos_torch.data.bench import bench_cell_bank, make_bench_dataset
    from text2pos_torch.evaluation.pipeline import LocalizationPipeline
    from text2pos_torch.ops import lstm as tlstm
    from text2pos_torch.ops import superglue_gnn as tgnn

    _build._LIBS.update({k: sides["A"][k] for k in KERNELS})
    fx = dict(np.load(cs.FIXTURE)) if fx is None else fx
    pipe = LocalizationPipeline.from_checkpoints(
        cs.CKPT_COARSE, cs.CKPT_FINE, cs.DB_CACHE, dtype="bfloat16",
        device=device)
    bank = bench_cell_bank(make_bench_dataset()[0]) if bank is None else bank
    idx = torch.as_tensor(fx["jax_top_idx"].astype("int64"),
                          device=device).reshape(-1)
    K = fx["jax_top_idx"].shape[1]
    kernel = tlstm._lstm_kernel
    rel = cs.GNN_REL_TOL["bf16"]

    def readings(got, ref, plain, cut=None):
        d = (got - ref).abs().amax((1, 2)).double()
        tol = rel * float(ref.abs().max())
        q = torch.quantile(d, torch.tensor([0.5, 0.999], device=d.device,
                                           dtype=d.dtype))
        gate = float((got - plain).abs().max()) / (
            rel * float(plain.abs().max()))
        out = (f"{float(d.max()) / tol:.3f} {int((d > tol).sum())} "
               f"{float(q[0]) / tol:.4f} {float(q[1]) / tol:.4f} "
               f"{gate:.3f}")
        if cut is None:
            return out
        ok, r = cs.depth_gate(got, plain, ref, *cut)
        return (out + f" [depth gate {'pass' if ok else 'FAIL'}: "
                + " ".join(k for k in "abcd" if not r[k])
                + f" cut {r['cut_max']:.3f}]")

    print("drift of the second form's bf16 route against the float64 "
          "evaluation, 20,480 pairs, 12 blocks; per side: largest per-pair "
          "error / tol, pairs past tol, median / tol, 99.9th percentile / "
          "tol, largest error against the plain f32 version / its tol, "
          "and chip_smoke's depth_gate: its verdict, the conditions that "
          f"fail, the largest error at {cs.DEPTH_CUT_BLOCKS} blocks against "
          "the plain version / GNN_REL_TOL")
    draws = [(lstm, None, None) for lstm in ("B", "A", "plain")]
    draws += [("A", None, perm) for perm in DRIFT_PERMUTATIONS]
    draws += [("A", seed, None) for seed in DRIFT_SEEDS]
    for lstm, seed, perm in draws:
        if lstm == "plain":
            tlstm._lstm_kernel = tlstm.lstm_final_hidden_plain
        else:
            _build._LIBS["lstm"] = sides[lstm]["lstm"]
        try:
            for pad in (16, 24):
                wide = cs.wide_pipeline(pipe, bank, fx, torch.bfloat16,
                                        pad=pad, **({} if seed is None else
                                                    {"seed": seed}))[0]
                packed = wide.fine.superglue.packed_kernel_params()
                d0 = wide.fine_bank_enc[idx].contiguous()
                ht, hl = fx["hint_tokens"], fx["hint_lengths"]
                if perm is not None:
                    order = np.random.default_rng(perm).permuted(
                        np.tile(np.arange(ht.shape[1]), (len(ht), 1)),
                        axis=1)
                    ht = np.take_along_axis(ht, order[..., None], 1)
                    hl = np.take_along_axis(hl, order, 1)
                with torch.inference_mode():
                    d1 = wide.fine.encode_hints(
                        torch.as_tensor(ht, device=device),
                        torch.as_tensor(hl, device=device)
                    ).repeat_interleave(K, dim=0).contiguous()
                    ref = cs.f64_scores(d0, d1, packed)
                    plain = tgnn.gnn_scores_plain(d0, d1, packed)
                    cut = cs.first_blocks(packed)
                    cut_plain = tgnn.gnn_scores_plain(d0, d1, cut)
                    outs, cuts = {}, {}
                    for side in ("A", "B"):
                        _build._LIBS["superglue_gnn_any"] = \
                            sides[side]["superglue_gnn_any"]
                        outs[side] = tgnn._gnn_any_kernel(d0, d1, packed)
                        cuts[side] = (tgnn._gnn_any_kernel(d0, d1, cut),
                                      cut_plain)
                    _build._LIBS["superglue_gnn_any"] = \
                        sides["A"]["superglue_gnn_any"]
                draw = f"LSTM {lstm}" + (
                    "" if perm is None else f", hints permuted (seed {perm})"
                ) + ("" if seed is None else f", model seed {seed}")
                print(f"  pad_size {pad}, {draw}: " + "; ".join(
                    f"{k} {readings(v, ref, plain, cuts.get(k))}" for k, v in
                    (*outs.items(), ("plain", plain))), flush=True)
        finally:
            tlstm._lstm_kernel = kernel
            _build._LIBS["lstm"] = sides["A"]["lstm"]


def headline_ms(sides):
    """chip_smoke phase 4's bf16 headline (the bench fixture's 2048
    queries, top-10, one ``serve_batch``; the median of 5) and phase 12.2's
    at E = 300 (``wide_pipeline``, pad_size 16, built with A's kernels),
    each with each side's LSTM library, in the order A, B, B, A; the other
    kernels are A's."""
    import numpy as np

    import chip_smoke as cs
    from text2pos_torch.data.bench import bench_cell_bank, make_bench_dataset
    from text2pos_torch.evaluation.pipeline import LocalizationPipeline

    _build._LIBS.update({k: sides["A"][k] for k in KERNELS})
    fx = dict(np.load(cs.FIXTURE))
    pipe = LocalizationPipeline.from_checkpoints(
        cs.CKPT_COARSE, cs.CKPT_FINE, cs.DB_CACHE, dtype="bfloat16",
        device="cuda")
    wide = cs.wide_pipeline(pipe, bench_cell_bank(make_bench_dataset()[0]),
                            fx, torch.bfloat16)[0]
    out = {}
    for what, p in (("bench", pipe), ("E=300", wide)):
        ms = out[what] = {"A": [], "B": []}
        for k in ("A", "B", "B", "A"):
            _build._LIBS["lstm"] = sides[k]["lstm"]
            cs.serve_all(p, fx, cs.TOP_K)
            ms[k].append(cs.serve_all(p, fx, cs.TOP_K, reps=5)[2] * 1e3)
    _build._LIBS["lstm"] = sides["A"]["lstm"]
    return out


def main() -> int:
    only = [a.split("=", 1)[1].split(",") for a in sys.argv[1:]
            if a.startswith("--only=")]
    args = [a for a in sys.argv[1:] if a not in ("--drift", "--no-drift")
            and not a.startswith("--only=")]
    if len(args) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(args[0]).resolve()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as d:
        sides = {"A": build(_build.CSRC, Path(d), "A"),
                 "B": build(other, Path(d), "B")}
        fx = np.load(ROOT / "text2pos_torch" / "fixtures"
                     / "bench_queries.npz")
        text, hints = fx["lengths"], fx["hint_lengths"].reshape(-1)
        cases = [(f"lstm B={B} T={T} H={H}{note}",
                  lambda L, a=(B, T, H, ln): lstm_call(L, *a))
                 for B, T, H, ln, note in (
                     (2048, 64, 256, None, ""), (12288, 16, 128, None, ""),
                     (2048, 64, 300, text, " (the E = 300 text's lengths)"),
                     (12288, 16, 300, hints, " (its hints' lengths)"),
                     (2048, 64, 300, None, ""), (12288, 16, 300, None, ""),
                     (2048, 64, 288, None, ""), (2048, 64, 320, None, ""),
                     (2048, 64, 384, None, ""), (2048, 64, 416, None, ""),
                     (2048, 64, 512, None, ""))]
        cases += [(f"fps B={B} N={N}", lambda L, a=(B, N): fps_call(L, *a))
                  for B in (1024, 787) for N in (256, 128, 64)]
        cases += [(f"fps three levels B={B} N=256",
                   lambda L, b=B: fps_levels_call(L, b)) for B in (1024, 787)]
        cases += [(f"lstm_grid B={B} T={T} H={H}{note}",
                   lambda L, a=(B, T, H, ln): lstm_grid_call(L, *a))
                  for B, T, H, ln, note in (
                      (128, 64, 768, text[:128], " (phase 14's text)"),
                      (768, 16, 768, hints[:768], " (phase 14's hints)"),
                      (2048, 64, 768, text, ""), (2048, 64, 1024, text, ""),
                      (2048, 64, 2048, text, ""))]
        cases += [("sinkhorn N=20480 (16, 6) 50 iterations", sinkhorn_call)]
        # Phase 14's couplings, then what sets their time: the copy in and
        # out alone (0 iterations), one iteration, and the 50 iterations on
        # a tenth of the couplings (a warp on 132 SMs' 528 sub-partitions
        # at most: the chain's latency) and on four times as many.
        cases += [(f"sinkhorn_wide N={B} (48, 6) {n} iterations",
                   lambda L, b=B, n=n: sinkhorn_wide_call(L, B=b, iters=n))
                  for B, n in ((1280, 50), (1280, 0), (1280, 1), (128, 50),
                               (5120, 50))]
        cases += [(f"pointconv {str(dt)[6:]} B=1024 sa1",
                   lambda L, d=dt: pointconv_call(L, d))
                  for dt in (torch.bfloat16, torch.float32)]
        # The f32 route at the other levels of a DB-encode step (fine 1024
        # objects, coarse 787; sa1, sa2, sa3), summed over the six below.
        cases += [(f"pointconv float32 B={B} {lvl}", lambda L, a=(
                    B, *shape): pointconv_call(L, torch.float32, *a))
                  for B in (1024, 787) for lvl, shape in POINTCONV_LEVELS
                  if (B, lvl) != (1024, "sa1")]
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt)[6:]
            cases += [(f"superglue_gnn {name} N=20480 (128, 16, 6) L=12",
                       lambda L, d=dt: tuned_gnn_call(L, d)),
                      (f"superglue_gnn_any {name} N=20480 (300, 16, 6) L=12",
                       lambda L, d=dt: any_gnn_call(L, d))]
        # The tuned f32 route at the cascade's cheap pass, the evaluator's
        # chunk and the card tests' ragged size.
        cases += [(f"superglue_gnn float32 N={N} (128, 16, 6) L={L}",
                   lambda lib, a=(N, L): tuned_gnn_call(lib, torch.float32,
                                                        *a))
                  for N, L in ((262144, 2), (80, 12), (37, 4))]
        cases += [("superglue_gnn_any bfloat16 N=20480 (300, 24, 6) L=12",
                   lambda L: any_gnn_call(L, torch.bfloat16, T0=24))]
        cases += [(f"superglue_gnn_any_wide {str(dt)[6:]} N=1280 (768, 48, "
                   "6) L=12", lambda L, d=dt: any_gnn_call(
                       L, d, N=1280, E=768, T0=48))
                  for dt in (torch.bfloat16, torch.float32)]
        print(f"# {gpu}; A = {_build.CSRC}, B = {other}")
        for k, v in sides.items():
            print(f"# ptxas lstm.cu {k}: " + " | ".join(v["lstm_ptxas"]))
        if "--drift" in sys.argv:
            cases = []
        if only:
            cases = [c for c in cases if c[0].startswith(tuple(only[0]))]
        step = {"A": 0.0, "B": 0.0}
        for label, make in cases:
            calls = {k: make(v) for k, v in sides.items()}
            ms = {k: [] for k in calls}
            slow = label.startswith("superglue_gnn_any") or "262144" in label
            how = graph_timed if label.startswith("fps") else timed
            for k in ("A", "B", "B", "A"):
                ms[k].append(how(calls[k], reps=3 if slow else 10,
                                 launches=2 if slow else 20))
            a, b = (statistics.mean(ms[k]) for k in ("A", "B"))
            print(f"{label}: A {ms['A'][0]:.4f} {ms['A'][1]:.4f} ms, "
                  f"B {ms['B'][0]:.4f} {ms['B'][1]:.4f} ms, A/B "
                  f"{a / b:.4f}")
            if label.startswith("lstm"):
                print("  largest error against float64: " + ", ".join(
                    f"{k} {e:.3e}" for k, e in lstm_f64_errors(calls).items())
                    + "; A and B bit-identical: "
                    + str(torch.equal(calls["A"].out, calls["B"].out)))
            if label.startswith("pointconv float32"):
                for k in step:
                    step[k] += statistics.mean(ms[k])
            if label.startswith(("sinkhorn_wide", "superglue_gnn ",
                                 "pointconv")):
                d = float((calls["A"].out.float()
                           - calls["B"].out.float()).abs().max())
                print(f"  A and B bit-identical: "
                      f"{torch.equal(calls['A'].out, calls['B'].out)} "
                      f"(largest difference {d:.3e})")
            if label.startswith("superglue_gnn_any"):
                errs = f64_errors(calls)
                print("  against the float64 evaluation (largest error "
                      "over the tolerance, pairs past it): " + ", ".join(
                          f"{k} {e:.3f} ({n})" for k, (e, n) in errs.items()))
        if step["B"]:
            print(f"pointconv float32, the six levels summed: A "
                  f"{step['A']:.4f} ms, B {step['B']:.4f} ms, A/B "
                  f"{step['A'] / step['B']:.4f}")
        if cases and not only:
            for what, ms in headline_ms(sides).items():
                print(f"{what} bf16 headline (2048 queries, top-10) with "
                      "each side's LSTM: " + ", ".join(
                          f"{k} {v[0]:.3f} {v[1]:.3f} ms"
                          for k, v in ms.items()))
        if "--no-drift" not in sys.argv:
            drift_readings(sides)
    return 0


if __name__ == "__main__":
    sys.exit(main())
