"""Log-domain Sinkhorn with learned dustbins (counterpart of
``text2pos_tpu/ops/sinkhorn.py``).

``log_optimal_transport`` adds the dustbin row and column, the marginals and
the ``- norm`` scaling around ``iters`` alternating row/column updates. On
the card all of it is one launch of the hand-written CUDA kernel
``csrc/sinkhorn.cu`` (replacing the Pallas kernel
``text2pos_tpu/ops/sinkhorn_pallas.py:51``), which reads the scores and
builds the dustbins in registers; ``log_sinkhorn`` takes given couplings and
marginals through the same kernel. Couplings up to ``MAX_ROWS`` x
``MAX_COLS`` (dustbins included) stay in registers (launch ``sinkhorn``);
larger ones, which JAX's kernel takes as it takes any, run the kernel's
wide form (launch ``sinkhorn_wide``): a warp a coupling, copied into shared
memory with its duals, every lane of the warp in both passes; a coupling
too large for shared memory keeps its duals in a workspace the wrapper
allocates (``wide_plan``). ``extract_matches`` is plain PyTorch: mutual max,
threshold, first index on argmax ties. All f32.

Where grad mode is on and the scores or the dustbin score require grad (a
training step), ``log_optimal_transport`` goes through
``LogOptimalTransport``, a ``torch.autograd.Function`` whose forward is the
fused kernel (the plain version on the CPU) and whose backward recomputes
``log_optimal_transport_plain`` under autograd (profiler range
``sinkhorn.backward_plain``): the kernel has no backward
of its own, and JAX trains through its XLA loop
(``text2pos_tpu/models/superglue.py:221``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch
from torch.profiler import record_function

from text2pos_torch.ops import _build

# The register forms' largest coupling (csrc/sinkhorn.cu): pad_size 31 and
# 15 hints, with the dustbins.
MAX_ROWS, MAX_COLS = 32, 16
WIDE_WARPS = 4          # couplings a CTA of the wide form at most
SMEM_OPTIN = 232448     # shared memory a CTA may take on the H100


class WidePlan(NamedTuple):
    """The wide form's plan: ``route`` ("smem": the couplings copied into
    shared memory; "workspace": read from global memory, duals in a
    workspace), ``couplings`` a CTA and ``smem`` bytes a CTA."""

    route: str
    couplings: int
    smem: int


@functools.lru_cache(maxsize=None)
def wide_plan(M: int, N: int, smem_max: int = SMEM_OPTIN) -> WidePlan:
    """The wide form's plan for an M x N coupling, dustbins included
    (``t2p_sinkhorn_wide_plan`` mirrored): Z at a row stride of N | 1, u,
    v and the marginals in shared memory, WIDE_WARPS couplings a CTA,
    halved until they fit ``smem_max`` bytes, else the workspace route."""
    per = 4 * (M * (N | 1) + 2 * (M + N))
    w = WIDE_WARPS
    while w > 1 and w * per > smem_max:
        w //= 2
    if w * per > smem_max:
        return WidePlan("workspace", WIDE_WARPS, 0)
    return WidePlan("smem", w, w * per)


def log_sinkhorn_plain(Z: torch.Tensor, log_mu: torch.Tensor,
                       log_nu: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain PyTorch Sinkhorn: Z [B, M, N], log_mu [B, M], log_nu [B, N]."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(Z + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(Z + u[:, :, None], dim=1)
    return Z + u[:, :, None] + v[:, None, :]


def _sinkhorn_launch(z, log_mu, log_nu, alpha, M, N, iters, bins):
    """One launch on ``z`` ([B, M, N] couplings, or [B, M-1, N-1] scores
    with ``bins``); returns [B, M, N]."""
    B = z.shape[0]
    if M < 1 or N < 1 or (bins and (M < 2 or N < 2)):
        raise ValueError(f"Sinkhorn kernel: no [{M}, {N}] coupling"
                         + (" with dustbins" if bins else ""))
    if iters < 0:
        raise ValueError("Sinkhorn kernel: negative iteration count")
    args = [t for t in (z, log_mu, log_nu, alpha) if t is not None]
    if any(t.dtype != torch.float32 for t in args):
        raise TypeError("the Sinkhorn kernel takes float32 inputs")
    if any(t.device != z.device for t in args):
        raise ValueError("Sinkhorn kernel: inputs on different devices")
    z, log_mu, log_nu, alpha = (t if t is None else t.contiguous()
                                for t in (z, log_mu, log_nu, alpha))
    out = torch.empty(B, M, N, device=z.device, dtype=torch.float32)
    if B == 0:
        return out
    ptr = [t if t is None else t.data_ptr() for t in (log_mu, log_nu, alpha)]
    if M > MAX_ROWS or N > MAX_COLS:
        optin = torch.cuda.get_device_properties(
            z.device).shared_memory_per_block_optin
        duals = (torch.empty(B, M + N, device=z.device, dtype=torch.float32)
                 if wide_plan(M, N, optin).route == "workspace" else None)
        fn = _build.entry("sinkhorn", "t2p_log_sinkhorn_wide",
                          [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                          + [ctypes.c_void_p])
        _build.launch(fn, z.device, "sinkhorn_wide", z.data_ptr(), *ptr,
                      out.data_ptr(), duals if duals is None
                      else duals.data_ptr(), B, M, N, int(iters), int(bins))
        _build.LAUNCHES["sinkhorn_wide"] += 1
        return out
    fn = _build.entry("sinkhorn", "t2p_log_sinkhorn",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p])
    _build.launch(fn, z.device, "log_sinkhorn", z.data_ptr(), *ptr,
                  out.data_ptr(), B, M, N, int(iters), int(bins))
    _build.LAUNCHES["sinkhorn"] += 1
    return out


def _sinkhorn_kernel(Z, log_mu, log_nu, iters):
    _build.refuse_grad("Sinkhorn kernel", Z, log_mu, log_nu)
    B, M, N = Z.shape
    if tuple(log_mu.shape) != (B, M) or tuple(log_nu.shape) != (B, N):
        raise ValueError("Sinkhorn kernel: marginal shapes do not match Z")
    return _sinkhorn_launch(Z, log_mu, log_nu, None, M, N, iters, False)


def _lot_kernel(scores, alpha, iters):
    """The fused ``log_optimal_transport``: scores [B, M, N] → [B, M+1,
    N+1], dustbins, marginals and ``- norm`` in the kernel."""
    _build.refuse_grad("Sinkhorn kernel", scores, alpha)
    M, N = scores.shape[1:]
    if isinstance(alpha, torch.Tensor) and alpha.device != scores.device:
        raise ValueError("Sinkhorn kernel: inputs on different devices")
    alpha = torch.as_tensor(alpha, device=scores.device).float().reshape(1)
    return _sinkhorn_launch(scores, None, None, alpha, M + 1, N + 1, iters,
                            True)


def log_sinkhorn(Z: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                 iters: int) -> torch.Tensor:
    """Sinkhorn normalization in log space; the CUDA kernel on the card,
    the plain version on the CPU."""
    if Z.is_cuda:
        return _sinkhorn_kernel(Z, log_mu, log_nu, iters)
    return log_sinkhorn_plain(Z, log_mu, log_nu, iters)


def dustbin_couplings(scores: torch.Tensor, alpha: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 float]:
    """Sinkhorn's inputs for [B, M, N] scores: the [B, M+1, N+1] couplings
    with dustbin score ``alpha``, the log marginals [B, M+1] and [B, N+1],
    and ``norm`` = -log(M+N). f32, or f64 for f64 scores."""
    B, M, N = scores.shape
    dt = torch.float64 if scores.dtype == torch.float64 else torch.float32
    alpha = torch.as_tensor(alpha, dtype=dt, device=scores.device)
    couplings = alpha.expand(B, M + 1, N + 1).clone()
    couplings[:, :M, :N] = scores.to(dt)
    norm = -math.log(M + N)
    # Made on the device: an element set from a Python number is a host
    # copy that the host waits for.
    full = lambda n, v: torch.full((n,), v, device=scores.device, dtype=dt)
    log_mu = torch.cat([full(M, norm), full(1, math.log(N) + norm)])
    log_nu = torch.cat([full(N, norm), full(1, math.log(M) + norm)])
    return (couplings, log_mu.expand(B, M + 1).contiguous(),
            log_nu.expand(B, N + 1).contiguous(), norm)


def log_optimal_transport_plain(scores: torch.Tensor, alpha: torch.Tensor,
                                iters: int) -> torch.Tensor:
    """The fused kernel's plain version: dustbin couplings, plain Sinkhorn,
    ``- norm``."""
    Z, log_mu, log_nu, norm = dustbin_couplings(scores, alpha)
    return log_sinkhorn_plain(Z, log_mu, log_nu, iters) - norm


class LogOptimalTransport(torch.autograd.Function):
    """``log_optimal_transport`` with a gradient to the scores and the
    dustbin score: forward is the fused kernel on CUDA tensors (the plain
    version on the CPU), backward recomputes the plain version and
    differentiates it. Arguments: scores [B, M, N], alpha (a 0-d tensor),
    iters."""

    @staticmethod
    def forward(ctx, scores, alpha, iters):
        ctx.save_for_backward(scores, alpha)
        ctx.iters = iters
        if scores.is_cuda:
            return _lot_kernel(scores.float(), alpha, iters)
        return log_optimal_transport_plain(scores, alpha, iters)

    @staticmethod
    def backward(ctx, grad):
        scores, alpha = ctx.saved_tensors
        with torch.enable_grad(), record_function("sinkhorn.backward_plain"):
            leaves = [scores.detach().requires_grad_(),
                      alpha.detach().requires_grad_()]
            out = log_optimal_transport_plain(*leaves, ctx.iters)
            g_scores, g_alpha = torch.autograd.grad(out, leaves, grad)
        return (g_scores if ctx.needs_input_grad[0] else None,
                g_alpha if ctx.needs_input_grad[1] else None, None)


def log_optimal_transport(scores: torch.Tensor, alpha: torch.Tensor,
                          iters: int) -> torch.Tensor:
    """[B, M, N] scores → [B, M+1, N+1] log transport (dustbins included),
    scaled by M+N; one kernel launch on the card, the plain version on the
    CPU; through ``LogOptimalTransport`` where a gradient is wanted."""
    if torch.is_grad_enabled() and (scores.requires_grad or (
            isinstance(alpha, torch.Tensor) and alpha.requires_grad)):
        return LogOptimalTransport.apply(scores, alpha, iters)
    if scores.is_cuda:
        return _lot_kernel(scores.float(), alpha, iters)
    return log_optimal_transport_plain(scores, alpha, iters)


def extract_matches(Z: torch.Tensor, match_threshold: float = 0.2
                    ) -> Dict[str, torch.Tensor]:
    """Mutual-max + threshold match extraction from [B, M+1, N+1] log
    transport: matches0 [B, M], matches1 [B, N] (-1 unmatched) and
    matching_scores0/1."""
    z = Z[:, :-1, :-1]
    M, N = z.shape[1], z.shape[2]
    # torch.max(dim) does not promise the first index on ties; argmax of
    # the row maximum's first occurrence does.
    max0 = z.amax(dim=2)
    idx0 = _first_argmax(z, dim=2)                       # [B, M]
    idx1 = _first_argmax(z, dim=1)                       # [B, N]
    ar_m = torch.arange(M, device=z.device)[None]
    ar_n = torch.arange(N, device=z.device)[None]
    mutual0 = torch.gather(idx1, 1, idx0) == ar_m
    mutual1 = torch.gather(idx0, 1, idx1) == ar_n
    zero = z.new_zeros(())
    ms0 = torch.where(mutual0, max0.exp(), zero)
    ms1 = torch.where(mutual1, torch.gather(ms0, 1, idx1), zero)
    valid0 = mutual0 & (ms0 > match_threshold)
    valid1 = mutual1 & torch.gather(valid0, 1, idx1)
    neg1 = torch.full_like(idx0, -1)
    return {
        "matches0": torch.where(valid0, idx0, neg1),
        "matches1": torch.where(valid1, idx1, torch.full_like(idx1, -1)),
        "matching_scores0": ms0,
        "matching_scores1": ms1,
    }


def _first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first maximum along ``dim`` (``jnp.argmax``'s rule)."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    ar = torch.arange(n, device=x.device).view(shape)
    is_max = x == x.amax(dim=dim, keepdim=True)
    return torch.where(is_max, ar, n).amin(dim=dim)
