#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own ``#`` lines; any failure exits non-zero:

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build: every hand-written kernel under ``text2pos_torch/csrc`` with
   ``nvcc``, all at once.
3. Kernels vs plain: each kernel's wrapper against its plain PyTorch version
   on the inputs the serving path gives it (the committed checkpoints and
   bench queries): max abs error with its tolerance, median times (CUDA
   events) of kernel, plain version and, where one exists, a one-call
   PyTorch equivalent, and the least time the card could take (bound).
4. End to end: ``LocalizationPipeline.serve_batch`` on the 2048 committed
   bench queries at top_k=10, bf16 bodies (the headline, whose kernel launch
   counts are read) and f32, then one rerank@128 batch (λ=4, γ=6);
   throughput, accuracies and agreement with the JAX outputs stored in the
   fixture.
5. A ``{"kernels": [...]}`` line, the card's name and power limit, and
   ``{"ok": true, "device": {...}}`` as the last line.

Needs the repository checkout (the package, ``checkpoints/`` and the
fixture) and a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT_COARSE = os.path.join(ROOT, "checkpoints", "bench_coarse.msgpack")
CKPT_FINE = os.path.join(ROOT, "checkpoints", "bench_fine.msgpack")
DB_CACHE = os.path.join(ROOT, "checkpoints", "bench_db_cache.npz")
FIXTURE = os.path.join(ROOT, "text2pos_torch", "fixtures",
                       "bench_queries.npz")
TOP_K = 10

# Published H100 SXM peaks (dense): f32 outside the tensor cores, bf16
# tensor cores, HBM bandwidth.
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

# Tolerances, kernel vs plain version on the same card and inputs. Both run
# f32 arithmetic in different summation orders. The GNN's tolerances are
# relative to the largest score (about 50 on the bench weights): in bf16 a
# sum that lands on the other side of a rounding boundary moves a value by
# one bf16 step (2^-8 relative), and the 12 residual blocks carry it on.
TOL = {"lstm": 1e-4, "sinkhorn": 1e-4}
GNN_REL_TOL = {"f32": 1e-5, "bf16": 1e-2}
ACC_SLACK = 0.01   # headline top-10@15m within 1 point of the JAX value

KERNEL_SOURCES = {
    "lstm": ("text2pos_torch/csrc/lstm.cu",
             "text2pos_tpu/ops/lstm_pallas.py:60"),
    "sinkhorn": ("text2pos_torch/csrc/sinkhorn.cu",
                 "text2pos_tpu/ops/sinkhorn_pallas.py:51"),
    "superglue_gnn": ("text2pos_torch/csrc/superglue_gnn.cu",
                      "text2pos_tpu/ops/superglue_gnn_pallas.py:253"),
}


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn()`` in ms, one CUDA event pair per rep."""
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


def bound_ms(flops_by_rate, nbytes: float) -> float:
    """max(bytes / HBM rate, Σ operations / peak rate of their type)."""
    t_ops = sum(f / rate for f, rate in flops_by_rate)
    return 1e3 * max(nbytes / PEAK_BYTES, t_ops)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, err: float, tol: float, failures: list) -> None:
    ok = err <= tol and math.isfinite(err)
    log(f"  {name}: max_abs_err={err:.3e} (tolerance {tol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{name}: max_abs_err {err} > {tol}")


def lstm_checks(pipe, fx, failures):
    """Kernel vs plain for the four LSTM launches of one serve_batch."""
    from text2pos_torch.ops.lstm import (_lstm_kernel,
                                         lstm_final_hidden_plain)

    dev = pipe.device
    out = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "max_abs_err": 0.0, "detail": []}
    encoders = (
        ("coarse", pipe.coarse.language_encoder,
         torch.as_tensor(fx["tokens"]), torch.as_tensor(fx["lengths"])),
        ("fine", pipe.fine.language_encoder,
         torch.as_tensor(fx["hint_tokens"]).flatten(0, 1),
         torch.as_tensor(fx["hint_lengths"]).flatten()))
    for label, enc, tokens, lengths in encoders:
        tokens, lengths = tokens.to(dev), lengths.to(dev)
        with torch.inference_mode():
            x = enc.word_embedding(tokens) * (tokens != 0)[..., None]
            xt = x.transpose(0, 1).float()
            T, B, E = xt.shape
            H = E
            lib = torch.nn.LSTM(E, H).to(dev)
            packed = torch.nn.utils.rnn.pack_padded_sequence(
                xt, lengths.clamp_min(1).cpu(), enforce_sorted=False)
            lib_ms = cuda_ms(lambda: lib(packed))
            for d, rev in (("fwd", False), ("bwd", True)):
                p = enc._params(d)
                xp = torch.matmul(xt, p.w_ih) + p.b
                got = _lstm_kernel(xp, p.w_hh, lengths, rev)
                want = lstm_final_hidden_plain(xp, p.w_hh, lengths, rev)
                torch.cuda.synchronize()
                err = max_err(got, want)
                check(f"lstm {label} {d} T={T} B={B} H={H}", err,
                      TOL["lstm"], failures)
                ms = cuda_ms(lambda: _lstm_kernel(xp, p.w_hh, lengths, rev))
                plain_ms = cuda_ms(lambda: lstm_final_hidden_plain(
                    xp, p.w_hh, lengths, rev), reps=3)
                steps = float(lengths.clamp(0, T).sum())
                # Recurrent matmul FLOPs of the valid steps; bytes: the
                # valid steps' projections, W_hh, lengths and h.
                bnd = bound_ms([(2.0 * steps * H * 4 * H, PEAK_F32)],
                               steps * 4 * H * 4 + H * 4 * H * 4 + B * 4
                               + B * H * 4)
                log(f"  lstm {label} {d}: kernel {ms:.3f} ms, plain "
                    f"{plain_ms:.3f} ms, cuDNN nn.LSTM (1 dir, packed) "
                    f"{lib_ms:.3f} ms, bound {bnd:.4f} ms")
                out["ms"] += ms
                out["plain_ms"] += plain_ms
                out["bound_ms"] += bnd
                out["library_ms"] += lib_ms
                out["max_abs_err"] = max(out["max_abs_err"], err)
                out["detail"].append({"encoder": label, "direction": d,
                                      "T": T, "B": B, "H": H, "ms": ms,
                                      "plain_ms": plain_ms, "bound_ms": bnd,
                                      "library_ms": lib_ms,
                                      "max_abs_err": err})
    return out


def gnn_sinkhorn_checks(pipe_bf16, pipe_f32, fx, failures):
    """Kernel vs plain for the GNN (bf16 and f32) and Sinkhorn at the
    headline serve's pose-cell pairs (the JAX top-10 cells)."""
    from text2pos_torch.ops.sinkhorn import (_sinkhorn_kernel,
                                             dustbin_couplings,
                                             log_sinkhorn_plain)
    from text2pos_torch.ops.superglue_gnn import (_gnn_kernel,
                                                  gnn_scores_plain)

    dev = pipe_bf16.device
    idx = torch.as_tensor(fx["jax_top_idx"].astype("int64"),
                          device=dev).reshape(-1)
    K = fx["jax_top_idx"].shape[1]
    with torch.inference_mode():
        hint_enc = pipe_bf16.fine.encode_hints(
            torch.as_tensor(fx["hint_tokens"], device=dev),
            torch.as_tensor(fx["hint_lengths"], device=dev))
        d1 = hint_enc.repeat_interleave(K, dim=0).contiguous()
        d0 = pipe_bf16.fine_bank_enc[idx].contiguous()
    N, T0, E = d0.shape
    T1 = d1.shape[1]
    results = {}
    scores_bf16 = None
    for label, pipe in (("bf16", pipe_bf16), ("f32", pipe_f32)):
        packed = pipe.fine.superglue.packed_kernel_params()
        with torch.inference_mode():
            got = _gnn_kernel(d0, d1, packed)
            want = gnn_scores_plain(d0, d1, packed)
            torch.cuda.synchronize()
        err = max_err(got, want)
        scale = float(want.abs().max())
        check(f"superglue_gnn {label} N={N} {T0}x{T1} E={E} "
              f"blocks={packed['wqkv'].shape[0]} (|scores| max {scale:.2f})",
              err, GNN_REL_TOL[label] * scale, failures)
        ms = cuda_ms(lambda: _gnn_kernel(d0, d1, packed), reps=5)
        with torch.inference_mode():
            plain_ms = cuda_ms(lambda: gnn_scores_plain(d0, d1, packed),
                               reps=3, warmup=1)
        L = packed["wqkv"].shape[0]
        P = T0 + T1
        # Per pair: projections, merge and block MLPs of all rows in every
        # block plus the final projection (matmuls, compute dtype); the
        # attention contractions (QK^T and PV over real tokens: self blocks
        # 16x16 and 6x6, cross blocks 16x6 twice) and the score matrix, f32.
        mm = 2.0 * P * (E * 3 * E + E * E + 2 * E * 2 * E + 2 * E * E) * L \
            + 2.0 * P * E * E
        attn = 2 * 2.0 * E * (L // 2) * (T0 * T0 + T1 * T1 + 2 * T0 * T1) \
            + 2.0 * E * T0 * T1
        wbytes = sum(t.numel() * t.element_size() for t in packed.values())
        nbytes = d0.numel() * 4 + d1.numel() * 4 + wbytes + N * T0 * T1 * 4
        rate = PEAK_BF16 if label == "bf16" else PEAK_F32
        bnd = bound_ms([(N * mm, rate), (N * attn, PEAK_F32)], nbytes)
        log(f"  superglue_gnn {label}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bnd:.4f} ms "
            f"({N * (mm + attn) / 1e12:.3f} TFLOP)")
        results[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                          "library_ms": None, "max_abs_err": err}
        if label == "bf16":
            scores_bf16 = got

    # Sinkhorn on the headline's couplings.
    sg = pipe_bf16.fine.superglue
    Z, mu, nu, _ = dustbin_couplings(scores_bf16, sg.bin_score.detach())
    M, Nn = Z.shape[1:]
    iters = sg.sinkhorn_iterations
    got = _sinkhorn_kernel(Z, mu, nu, iters)
    want = log_sinkhorn_plain(Z, mu, nu, iters)
    torch.cuda.synchronize()
    err = max_err(got, want)
    check(f"sinkhorn B={N} {M}x{Nn} iters={iters}", err, TOL["sinkhorn"],
          failures)
    ms = cuda_ms(lambda: _sinkhorn_kernel(Z, mu, nu, iters), reps=20)
    plain_ms = cuda_ms(lambda: log_sinkhorn_plain(Z, mu, nu, iters), reps=5)
    # Per iteration and element: add, max, subtract, exp, add for the row
    # pass and again for the column pass (10 f32 operations, exp counted
    # as one); bytes: Z and the marginals in, the result out.
    bnd = bound_ms([(10.0 * iters * N * M * Nn, PEAK_F32)],
                   4.0 * (2 * N * M * Nn + N * (M + Nn)))
    log(f"  sinkhorn: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bnd:.4f} ms")
    results["sinkhorn"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                           "library_ms": None, "max_abs_err": err}
    return results


def serve_all(pipe, fx, top_k, *rerank, reps: int = 1):
    """Serve every fixture query in one batch; returns numpy results and
    the median wall time of ``reps`` synchronized runs."""
    args = [torch.as_tensor(fx[k]).to(pipe.device)
            for k in ("tokens", "lengths", "hint_tokens", "hint_lengths")]
    times, res = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipe.serve_batch(*args, top_k, *rerank)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    top_idx, _, pos_offsets, _ = (r.cpu().numpy() for r in res)
    return top_idx.astype("int64"), pos_offsets.astype("float32"), \
        statistics.median(times)


def profile_serve(pipe, fx) -> None:
    """Device time of one headline serve_batch by kernel (torch.profiler)
    and the device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        _, _, wall = serve_all(pipe, fx, TOP_K)
    rows = []
    for e in prof.key_averages():
        # Kernels only: an operator's entry repeats its kernels' time.
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            rows.append((t / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if not rows:
        log("  profile: the profiler recorded no device time (not measured)")
        return
    log(f"  profile of one headline serve_batch (torch.profiler): wall "
        f"{wall * 1e3:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / (wall * 1e3):.1f}%), {len(rows)} device ops")
    for ms, n, key in sorted(rows, reverse=True)[:12]:
        log(f"    {ms:9.3f} ms  {n:4d}x  {key[:90]}")
    torch.cuda.synchronize()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 2
    missing = [p for p in (CKPT_COARSE, CKPT_FINE, DB_CACHE, FIXTURE)
               if not os.path.isfile(p)]
    try:
        from text2pos_torch.evaluation.metrics import served_accuracies
        from text2pos_torch.evaluation.pipeline import LocalizationPipeline
        from text2pos_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the text2pos_torch package is missing ({e}); "
              "run from a checkout of the repository", file=sys.stderr)
        return 2
    if missing:
        print(f"chip_smoke: missing {missing}", file=sys.stderr)
        return 2
    assert "jax" not in sys.modules, "the port imported jax"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures: list = []
    t_start = time.time()

    gpu = gpu_line()
    log(f"phase 1 device: {gpu}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t0 = time.time()
    took = _build.build_all()
    log(f"phase 2 build: {len(took)} kernels built in {time.time() - t0:.1f}"
        f" s ({', '.join(f'{k} {v:.1f}s' for k, v in took.items())}) into "
        f"{_build.build_dir()}")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    fx = dict(np.load(FIXTURE))
    t0 = time.time()
    pipe_bf16 = LocalizationPipeline.from_checkpoints(
        CKPT_COARSE, CKPT_FINE, DB_CACHE, dtype="bfloat16", device="cuda")
    pipe_f32 = LocalizationPipeline.from_checkpoints(
        CKPT_COARSE, CKPT_FINE, DB_CACHE, dtype="float32", device="cuda")
    log(f"checkpoints loaded by the port's reader in "
        f"{time.time() - t0:.1f} s")

    log("phase 3 kernels vs plain (the serving path's inputs)")
    lstm = lstm_checks(pipe_bf16, fx, failures)
    gs = gnn_sinkhorn_checks(pipe_bf16, pipe_f32, fx, failures)

    log("phase 4 end to end: serve_batch on the committed bench queries")
    Q = fx["tokens"].shape[0]
    serve_all(pipe_bf16, fx, TOP_K)                      # warm-up
    _build.LAUNCHES.clear()
    top_idx, pos, _ = serve_all(pipe_bf16, fx, TOP_K)    # the main path
    launches = dict(_build.LAUNCHES)
    log(f"  kernel launches in one headline serve_batch: {launches}")
    profile_serve(pipe_bf16, fx)
    for name in KERNEL_SOURCES:
        if launches.get(name, 0) < 1:
            failures.append(f"kernel {name} was not launched on the main "
                            "path")
    jax_t10 = float(fx["jax_top10_at_15m"])
    for label, pipe in (("bf16", pipe_bf16), ("f32", pipe_f32)):
        ti, po, sec = serve_all(pipe, fx, TOP_K, reps=5)
        accs = served_accuracies(fx, ti, po, (1, 5, TOP_K))
        same = float((ti == fx["jax_top_idx"]).mean())
        dpos = np.abs(po - fx["jax_pos_offsets"].astype(np.float32)).max(-1)
        perr = float(dpos.max())
        close = float((dpos <= 1e-2).mean())
        finite = bool(np.isfinite(po).all())
        log(f"  serve {label}: {Q} queries x top-{TOP_K} in {sec * 1e3:.2f}"
            f" ms = {Q / sec:.1f} q/s; top-10@15m {accs[TOP_K][15]:.4f} "
            f"(JAX {jax_t10:.4f}), top-1@15m {accs[1][15]:.4f} (JAX "
            f"{float(fx['jax_top1_at_15m']):.4f}); identical top_idx "
            f"{same:.4f}; in-cell positions vs JAX: max error {perr:.4g}, "
            f"share within 0.01 {close:.4f}")
        if not finite or ti.shape != fx["jax_top_idx"].shape:
            failures.append(f"serve {label}: malformed output")
        if abs(accs[TOP_K][15] - jax_t10) > ACC_SLACK:
            failures.append(f"serve {label}: top-10@15m {accs[TOP_K][15]} "
                            f"vs JAX {jax_t10}")
        if label == "f32" and same < 1.0:
            failures.append(f"serve f32: top_idx differs from JAX ({same})")

    rk, lam, gam = fx["rerank"]
    ti, po, sec = serve_all(pipe_bf16, fx, TOP_K, int(rk), float(lam),
                            float(gam))
    accs = served_accuracies(fx, ti, po, (1, 5, TOP_K))
    jax_rr = float(fx["jax_rerank_top10_at_15m"])
    log(f"  serve bf16 rerank@{int(rk)} (lambda={lam:g}, gamma={gam:g}): "
        f"{Q} queries in {sec * 1e3:.1f} ms = {Q / sec:.1f} q/s; "
        f"top-10@15m {accs[TOP_K][15]:.4f} (JAX {jax_rr:.4f}); identical "
        f"top_idx {float((ti == fx['jax_rerank_top_idx']).mean()):.4f}")
    if abs(accs[TOP_K][15] - jax_rr) > ACC_SLACK:
        failures.append(f"rerank: top-10@15m {accs[TOP_K][15]} vs JAX "
                        f"{jax_rr}")

    gnn = dict(gs["bf16"], f32=gs["f32"])
    per_kernel = {"lstm": lstm, "sinkhorn": gs["sinkhorn"],
                  "superglue_gnn": gnn}
    kernels = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches.get(name, 0)}
        entry.update(per_kernel[name])
        kernels.append(entry)
    log(f"total {time.time() - t_start:.1f} s; failures: {failures or 'none'}")
    if failures:
        for f in failures:
            print(f"chip_smoke: FAIL {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
