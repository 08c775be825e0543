"""Length-masked bidirectional LSTM (counterpart of ``text2pos_tpu/ops/lstm.py``).

The input projections ``x·W_ih + b`` for every step are one ``torch.matmul``
(hoisted as in JAX); the T-step recurrence is the hand-written CUDA kernel
``csrc/lstm.cu``, which replaces the Pallas kernel
``text2pos_tpu/ops/lstm_pallas.py:60``. Each direction's final hidden state
is that of its true last token (packed-sequence semantics): steps with
``t >= length`` leave h and c unchanged, and the backward direction runs over
the reversed padded sequence with reversed validity. All f32, as in JAX.

On a CPU tensor ``lstm_final_hidden`` runs its plain PyTorch version; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from text2pos_torch.ops import _build


class LSTMParams(NamedTuple):
    """One direction's weights, JAX layout (gate order i, f, g, o)."""

    w_ih: torch.Tensor  # [E, 4H]
    w_hh: torch.Tensor  # [H, 4H]
    b: torch.Tensor     # [4H]


def lstm_final_hidden_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
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


def _lstm_kernel(x_proj, w_hh, lengths, reverse):
    T, B, H4 = x_proj.shape
    H = H4 // 4
    if x_proj.dtype != torch.float32 or w_hh.dtype != torch.float32:
        raise TypeError("the LSTM kernel takes float32 x_proj and w_hh")
    if w_hh.device != x_proj.device:
        raise ValueError("LSTM kernel: w_hh is not on x_proj's device")
    if tuple(w_hh.shape) != (H, H4) or H % 32 or not 32 <= H <= 256:
        raise ValueError(f"LSTM kernel: unsupported w_hh {tuple(w_hh.shape)}"
                         f" for x_proj {tuple(x_proj.shape)} (H must be a "
                         "multiple of 32 in [32, 256])")
    x_proj = x_proj.contiguous()
    w_hh = w_hh.contiguous()
    lengths = lengths.to(device=x_proj.device, dtype=torch.int32).contiguous()
    out = torch.empty(B, H, device=x_proj.device, dtype=torch.float32)
    fn = _build.entry("lstm", "t2p_lstm_final_hidden",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])
    _build.check(fn(x_proj.data_ptr(), w_hh.data_ptr(), lengths.data_ptr(),
                    out.data_ptr(), T, B, H, int(reverse),
                    _build.stream_ptr(x_proj.device)), "lstm_final_hidden")
    _build.LAUNCHES["lstm"] += 1
    return out


def lstm_final_hidden(x_proj: torch.Tensor, w_hh: torch.Tensor,
                      lengths: torch.Tensor, reverse: bool = False
                      ) -> torch.Tensor:
    """Final hidden state of a length-masked LSTM over precomputed input
    projections; the CUDA kernel on the card, the plain version on the CPU."""
    if x_proj.is_cuda:
        return _lstm_kernel(x_proj, w_hh, lengths, reverse)
    return lstm_final_hidden_plain(x_proj, w_hh, lengths, reverse)


def bilstm_final_hidden(x: torch.Tensor, lengths: torch.Tensor,
                        fwd: LSTMParams, bwd: LSTMParams) -> torch.Tensor:
    """Mean of the two directions' final hidden states.

    x: [B, T, E] embedded tokens; lengths: [B] true lengths (≥ 1).
    Returns [B, H] float32.
    """
    xt = x.transpose(0, 1).float()                       # [T, B, E]
    proj_f = torch.matmul(xt, fwd.w_ih) + fwd.b          # hoisted matmuls
    proj_b = torch.matmul(xt, bwd.w_ih) + bwd.b
    h_f = lstm_final_hidden(proj_f, fwd.w_hh, lengths, reverse=False)
    h_b = lstm_final_hidden(proj_b, bwd.w_hh, lengths, reverse=True)
    return 0.5 * (h_f + h_b)
