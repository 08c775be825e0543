"""Length-masked bidirectional LSTM (counterpart of ``text2pos_tpu/ops/lstm.py``).

The recurrence of both directions is one launch of the hand-written CUDA
kernel ``csrc/lstm.cu``, which replaces the Pallas kernel
``text2pos_tpu/ops/lstm_pallas.py:60``. It takes its gate inputs from a
per-direction table ``[V, 4H]`` by token id: for token embeddings,
``emb[tok]·W_ih + b`` is ``(emb·W_ih + b)[tok]`` (``token_tables``). The
generic ``bilstm_final_hidden(x, ...)`` feeds the same kernel ``x·W_ih + b``
as a table of ``B·T`` rows with running indices. Each direction's final
hidden state is that of its true last token (packed-sequence semantics):
steps with ``t >= length`` leave h and c unchanged, and the backward
direction runs over the reversed padded sequence with reversed validity. All
f32, as in JAX.

The kernel takes any H, as JAX's does. The wrapper pads H to a multiple
of 32 (``kernel_width``) with zero gate columns and zero W_hh rows, which
keep the padded units at exactly 0 (``pad_gates``, ``pad_w_hh``), and cuts
the padding off the result: JAX's default width 300 runs at 320. Past 256
it also hands the kernel W_hh in fragment order (``w_hh_fragments``), which
the wider forms read from global memory each step. Up to
``CLUSTER_HIDDEN`` units the CTAs of a batch tile form one thread-block
cluster (launch ``lstm``: the shared form up to ``SMEM_HIDDEN``, the L2
form past it; ``cluster_plan`` gives their CTAs' threads and shared
memory); past it they exchange h through global memory in one cooperative
launch (the grid form, launch ``lstm_grid``), on a zeroed workspace the
wrapper allocates.

On CPU tensors ``lstm_final_hidden`` runs its plain PyTorch version; on CUDA
tensors it launches the kernel or raises. Where grad mode is on and the
tables or ``w_hh`` require grad (a training step), it goes through
``LSTMFinalHidden``, a ``torch.autograd.Function`` whose forward is the
kernel (the plain version on the CPU) and whose backward recomputes the
plain version under autograd (profiler range ``lstm.backward_plain``), as
JAX's ``custom_vjp`` takes its gradients from the XLA scan
(``text2pos_tpu/ops/lstm.py:89-113``). The kernel has no
backward of its own; the token tables stay PyTorch ops outside the
Function, so gradients reach the embedding, W_ih and b through them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from text2pos_torch.ops import _build


class LSTMParams(NamedTuple):
    """One direction's weights, JAX layout (gate order i, f, g, o)."""

    w_ih: torch.Tensor  # [E, 4H]
    w_hh: torch.Tensor  # [H, 4H]
    b: torch.Tensor     # [4H]


def lstm_recurrence_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                          lengths: torch.Tensor, reverse: bool = False
                          ) -> torch.Tensor:
    """Plain PyTorch recurrence: x_proj [T, B, 4H] (bias added), w_hh
    [H, 4H], lengths [B] → final h [B, H] f32. ``reverse`` visits
    t = T-1 … 0."""
    T, B, H4 = x_proj.shape
    H = H4 // 4
    h = x_proj.new_zeros(B, H)
    c = x_proj.new_zeros(B, H)
    steps = range(T - 1, -1, -1) if reverse else range(T)
    for t in steps:
        gates = x_proj[t] + h @ w_hh
        i, f, g, o = gates.split(H, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        v = (t < lengths)[:, None]
        h = torch.where(v, h_new, h)
        c = torch.where(v, c_new, c)
    return h


def lstm_final_hidden_plain(tables: Sequence[torch.Tensor],
                            w_hh: Sequence[torch.Tensor],
                            tokens: torch.Tensor, lengths: torch.Tensor
                            ) -> torch.Tensor:
    """The kernel's plain version: gate inputs ``tables[d][tokens]``, then
    the recurrence, forward (d = 0) and backward (d = 1) → [2, B, H].
    Steps past a sequence's length never read the table."""
    T = tokens.shape[1]
    lengths = lengths.to(tokens.device).clamp(0, T)
    valid = torch.arange(T, device=tokens.device)[None, :] < lengths[:, None]
    tok = torch.where(valid, tokens.long(), 0).t()                # [T, B]
    return torch.stack([
        lstm_recurrence_plain(tables[d][tok], w_hh[d], lengths, d == 1)
        for d in (0, 1)])


CLUSTER_HIDDEN = 512  # a cluster of 16 CTAs of 32 units; the grid form past
SMEM_HIDDEN = 256     # W_hh's slices in the cluster's shared memory up to here
CTA_UNITS = 32        # hidden units a CTA of the cluster forms
TILE = 32             # sequences a cluster


def cluster_plan(width: int) -> tuple:
    """A CTA of the cluster forms at kernel width ``width`` (a multiple of
    32 up to ``CLUSTER_HIDDEN``): (threads, bytes of dynamic shared memory),
    as ``csrc/lstm.cu``'s ``cluster_plan`` computes them. The shared form
    (up to ``SMEM_HIDDEN``): 8 warps, its W_hh slice and two h buffers. The
    L2 form: 4 warps (a warp takes 8 units and all 32 sequences), one h
    buffer and the cell states of its 32 units, so three CTAs share an
    H100 SM at every width."""
    if width % 32 or not 32 <= width <= CLUSTER_HIDDEN:
        raise ValueError(f"the cluster forms take widths 32..512 in steps "
                         f"of 32, not {width}")
    if width <= SMEM_HIDDEN:
        return 256, width * CTA_UNITS * 16 + 2 * width * TILE * 4
    return 128, (width * TILE + CTA_UNITS * TILE) * 4


def kernel_width(hidden: int) -> int:
    """The width the kernel runs at: ``hidden`` padded to a multiple of 32
    (a CTA's 32 units)."""
    return 32 * -(-hidden // 32)


def check_kernel_width(hidden: int) -> None:
    """Raise ``ValueError`` unless the kernel takes hidden width ``hidden``:
    any width of at least 1, run padded to a multiple of 32."""
    if hidden < 1:
        raise ValueError(
            f"the LSTM kernel takes a hidden width (embed_dim) of at least "
            f"1, not {hidden}")


def pad_gates(x: torch.Tensor, hidden: int, width: int) -> torch.Tensor:
    """``[..., 4·hidden]`` gate columns (i|f|g|o) → ``[..., 4·width]``, each
    gate block padded with zero columns."""
    if width == hidden:
        return x
    return F.pad(x.unflatten(-1, (4, hidden)), (0, width - hidden)).flatten(-2)


def pad_w_hh(w: torch.Tensor, hidden: int, width: int) -> torch.Tensor:
    """W_hh ``[hidden, 4·hidden]`` → ``[width, 4·width]``: zero gate columns
    and zero rows. A padded unit then stays exactly 0 (its gates are σ(0),
    tanh(0) = 0, so c and h stay 0) and adds nothing to the real units'
    sums."""
    return F.pad(pad_gates(w, hidden, width), (0, 0, 0, width - hidden))


def w_hh_fragments(w: torch.Tensor) -> torch.Tensor:
    """W_hh ``[H, 4H]`` (H a multiple of 32) in the kernel's A-fragment
    order ``[H/32][H/8][2][4][32][4]``, flat: the order in which
    ``csrc/lstm.cu`` stores CTA r's slice in shared memory (its fill loop),
    one slice after the other, and what the wider forms read from global
    memory. One permutation of W_hh's axes, on W_hh's device: k = 8·k8 +
    4·kh + kl and column gate·H + 32·r + 8·u8 + ul with gate = 2·mt + gl go
    to [r][k8][mt][u8][lane = 4·ul + kl][2·kh + gl]."""
    H = w.shape[0]
    return (w.reshape(H // 8, 2, 4, 2, 2, H // 32, 4, 8)
            .permute(5, 0, 3, 6, 7, 2, 1, 4).reshape(-1))


def _lstm_kernel(tables, w_hh, tokens, lengths, ctas: int = 0):
    """The kernel on CUDA tensors: the cluster forms up to
    ``CLUSTER_HIDDEN`` units, the grid form past it (``ctas`` > 0 caps the
    CTAs of its groups, so that a CTA owns several 32-unit slices)."""
    _build.refuse_grad("LSTM kernel", *tables, *w_hh)
    dev = tokens.device
    B, T = tokens.shape
    V, H4 = tables[0].shape
    H = H4 // 4
    for t in (*tables, *w_hh):
        if t.dtype != torch.float32:
            raise TypeError("the LSTM kernel takes float32 tables and w_hh")
        if t.device != dev:
            raise ValueError("LSTM kernel: tables, w_hh and tokens lie on "
                             "different devices")
    if len(tables) != 2 or len(w_hh) != 2 or tables[1].shape != (V, H4) \
            or any(tuple(w.shape) != (H, H4) for w in w_hh) or H4 % 4 \
            or H < 1:
        raise ValueError(
            f"LSTM kernel: unsupported tables {[tuple(t.shape) for t in tables]}"
            f" / w_hh {[tuple(w.shape) for w in w_hh]} (two directions, "
            f"[V, 4H] and [H, 4H], H of at least 1)")
    Hp = kernel_width(H)
    tables = [pad_gates(t, H, Hp).contiguous() for t in tables]
    w_hh = [pad_w_hh(w, H, Hp).contiguous() for w in w_hh]
    if tokens.dtype not in (torch.int32, torch.int64) or \
            tuple(lengths.shape) != (B,):
        raise ValueError("LSTM kernel: tokens must be [B, T] integers and "
                         "lengths [B]")
    if lengths.device != dev:
        raise ValueError("LSTM kernel: tokens and lengths lie on different "
                         "devices")
    tokens = tokens.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty(2, B, Hp, device=dev, dtype=torch.float32)
    if Hp > CLUSTER_HIDDEN:
        _lstm_grid(tables, [w_hh_fragments(w) for w in w_hh], tokens,
                   lengths, out, V, T, B, Hp, ctas)
        return out if Hp == H else out[..., :H]
    wpack = ([w_hh_fragments(w) for w in w_hh] if Hp > SMEM_HIDDEN
             else None)
    fn = _build.entry("lstm", "t2p_lstm_final_hidden",
                      [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])
    _build.launch(fn, dev, "lstm_final_hidden", tables[0].data_ptr(),
                  tables[1].data_ptr(), w_hh[0].data_ptr(),
                  w_hh[1].data_ptr(),
                  *((None, None) if wpack is None
                    else (wpack[0].data_ptr(), wpack[1].data_ptr())),
                  tokens.data_ptr(), lengths.data_ptr(), out.data_ptr(), V, T,
                  B, Hp)
    _build.LAUNCHES["lstm"] += 1
    return out if Hp == H else out[..., :H]


def _lstm_grid(tables, wpack, tokens, lengths, out, V, T, B, Hp, ctas):
    """The grid form's launch, on a zeroed workspace of the size its plan
    asks (h buffers, c and barrier counters of each group of CTAs)."""
    dev = tokens.device
    nbytes = ctypes.c_longlong(0)
    size = _build.entry("lstm", "t2p_lstm_grid_workspace",
                        [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        _build.check(size(Hp, B, ctas, ctypes.byref(nbytes)),
                     "lstm_grid workspace")
    ws = torch.zeros(nbytes.value, dtype=torch.uint8, device=dev)
    fn = _build.entry("lstm", "t2p_lstm_final_hidden_grid",
                      [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p])
    _build.launch(fn, dev, "lstm_grid", tables[0].data_ptr(),
                  tables[1].data_ptr(), wpack[0].data_ptr(),
                  wpack[1].data_ptr(), tokens.data_ptr(), lengths.data_ptr(),
                  out.data_ptr(), ws.data_ptr(), V, T, B, Hp, ctas)
    _build.LAUNCHES["lstm_grid"] += 1


class LSTMFinalHidden(torch.autograd.Function):
    """``lstm_final_hidden`` with a gradient: forward runs the kernel on
    CUDA tensors (the plain version on the CPU), backward recomputes the
    plain version and differentiates it. Arguments: tokens, lengths, the
    two tables, the two ``w_hh``."""

    @staticmethod
    def forward(ctx, tokens, lengths, table_f, table_b, w_hh_f, w_hh_b):
        ctx.save_for_backward(tokens, lengths, table_f, table_b, w_hh_f,
                              w_hh_b)
        tables, w_hh = (table_f, table_b), (w_hh_f, w_hh_b)
        if tokens.is_cuda:
            return _lstm_kernel(tables, w_hh, tokens, lengths)
        return lstm_final_hidden_plain(tables, w_hh, tokens, lengths)

    @staticmethod
    def backward(ctx, grad):
        tokens, lengths, *weights = ctx.saved_tensors
        with torch.enable_grad(), record_function("lstm.backward_plain"):
            leaves = [w.detach().requires_grad_() for w in weights]
            out = lstm_final_hidden_plain(leaves[:2], leaves[2:], tokens,
                                          lengths)
            grads = torch.autograd.grad(out, leaves, grad)
        return (None, None, *(g if ctx.needs_input_grad[i + 2] else None
                              for i, g in enumerate(grads)))


def lstm_final_hidden(tables: Sequence[torch.Tensor],
                      w_hh: Sequence[torch.Tensor], tokens: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Final hidden states of both directions, [2, B, H] f32, of a
    length-masked LSTM whose step-t input for sequence b is
    ``tables[d][tokens[b, t]]`` (the input projection with its bias, [V,
    4H] per direction d, forward then backward; ``w_hh`` [H, 4H] each). The
    CUDA kernel on the card, the plain version on the CPU; through
    ``LSTMFinalHidden`` where a gradient is wanted."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (*tables, *w_hh)):
        return LSTMFinalHidden.apply(tokens, lengths, *tables, *w_hh)
    if tokens.is_cuda:
        return _lstm_kernel(tables, w_hh, tokens, lengths)
    return lstm_final_hidden_plain(tables, w_hh, tokens, lengths)


def token_tables(embedding: torch.Tensor, fwd: LSTMParams, bwd: LSTMParams
                 ) -> list:
    """Per-direction gate-input tables ``emb·W_ih + b`` [V, 4H] f32, with
    the embedding's row 0 (unk/pad) taken as zero, as the encoder zeroes
    token 0's embedding: row 0 of each table is the bias alone."""
    emb = embedding.float()
    emb = torch.cat([emb.new_zeros(1, emb.shape[1]), emb[1:]])
    return [torch.addmm(p.b, emb, p.w_ih) for p in (fwd, bwd)]


def bilstm_tokens(tables: Sequence[torch.Tensor], fwd: LSTMParams,
                  bwd: LSTMParams, tokens: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Mean of the two directions' final hidden states [B, H] over token
    ids [B, T] and their ``token_tables``."""
    h = lstm_final_hidden(tables, (fwd.w_hh, bwd.w_hh), tokens, lengths)
    return 0.5 * (h[0] + h[1])


def bilstm_final_hidden(x: torch.Tensor, lengths: torch.Tensor,
                        fwd: LSTMParams, bwd: LSTMParams) -> torch.Tensor:
    """Mean of the two directions' final hidden states over any input.

    x: [B, T, E]; lengths: [B] true lengths (≥ 1). Returns [B, H] float32.
    The projections ``x·W_ih + b`` form tables of B·T rows, read by running
    indices.
    """
    B, T, E = x.shape
    xf = x.reshape(B * T, E).float()
    tables = [torch.addmm(p.b, xf, p.w_ih) for p in (fwd, bwd)]
    idx = torch.arange(B * T, device=x.device, dtype=torch.int32)
    return bilstm_tokens(tables, fwd, bwd, idx.view(B, T), lengths)
