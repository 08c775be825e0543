"""The LSTM kernel's L2 form (``csrc/lstm.cu`` ``lstm_l2_kernel``, widths
256 < H <= 512) on the CPU, where it cannot run:

- ``ops.lstm.cluster_plan``, the mirror of the C side's plan (threads and
  shared memory a CTA): the L2 form's 4 warps, one h buffer and the cell
  states of its 32 units, three CTAs to an H100 SM at every width; the
  shared form's 8 warps, W_hh's slice and two h buffers below; the card
  tests hold the C side to it (``tests/test_torch_port_kernels_wide.py``).
- The form's tiling, followed index for index: a warp takes 8 units and
  all 32 sequences of the tile, reads its W fragments where
  ``w_hh_fragments`` put them and h where the h buffer's layout puts it;
  its ``mma.sync.m16n8k8`` tiles, evaluated exactly, give W^T·h for every
  unit, gate and sequence of the CTA.
- Seeded inputs at L2 widths (288 and 416, ragged lengths with a zero
  one) through JAX's Pallas kernel (``text2pos_tpu/ops/lstm_pallas.py``,
  interpret mode) and the port's plain version, within 1e-5 of each other;
  the kernel's arithmetic (``lstm_emulated`` of
  ``test_torch_port_tc_arith.py``) within 2e-5 of the float64 recurrence.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_tc_arith import lstm_emulated
from text2pos_tpu.ops.lstm_pallas import lstm_final_hidden_pallas
from text2pos_torch.ops import lstm as tlstm

torch.set_num_threads(2)

SMEM_SM = 233472       # an H100 SM's shared memory (228 KiB)
RESERVED = 1024        # the runtime's reserve a CTA
STATIC = 256           # the kernels' static shared memory, rounded up
BT = 32


@pytest.mark.parametrize("width", range(288, 513, 32))
def test_cluster_plan_l2_form(width):
    """4 warps, one h buffer and c of 32 units x 32 sequences; three CTAs
    fit an SM at every L2 width (the earlier form's two buffers and 8
    warps held one past 448)."""
    threads, smem = tlstm.cluster_plan(width)
    assert threads == 128
    assert smem == 4 * (width * BT + 32 * BT)
    assert 3 * (smem + RESERVED + STATIC) <= SMEM_SM


@pytest.mark.parametrize("width", [32, 128, 256])
def test_cluster_plan_shared_form(width):
    threads, smem = tlstm.cluster_plan(width)
    assert threads == 256
    assert smem == width * 32 * 16 + 2 * width * BT * 4


@pytest.mark.parametrize("width", [0, 300, 544])
def test_cluster_plan_refuses(width):
    with pytest.raises(ValueError):
        tlstm.cluster_plan(width)


def _hpos(u):
    """``csrc/lstm.cu`` hpos: where unit u's h of sequence 0 lies in the h
    buffer [H/8][BT][8]."""
    return ((u >> 3) * BT) * 8 + 2 * (u & 3) + ((u >> 2) & 1)


@pytest.mark.parametrize("H", [288, 300, 512])
def test_l2_form_tiles_its_product(H):
    """Every CTA r of the cluster, warp ug, lane, n-tile nt, m-tile mt and
    k-step k as the kernel indexes them: A from the fragment-ordered W
    (``wa + (k * 2 + mt) * 4 * 32``, ``wa`` at CTA r's slice, warp ug and
    lane), B from the h buffer (``hs + (k * BT + nt * 8) * 8``, ``hs`` at
    gid * 8 + 2 * tid), C's rows gid / gid + 8 the gates (2mt, 2mt + 1) of
    unit 32r + 8ug + gid and its columns 2tid, 2tid + 1 the sequences
    8nt + 2tid + e. Evaluated in float64, the tiles' sums equal W^T·h."""
    Hp = tlstm.kernel_width(H)
    rng = np.random.default_rng(H)
    w = rng.standard_normal((Hp, 4 * Hp))
    h = rng.standard_normal((BT, Hp))
    frag = tlstm.w_hh_fragments(torch.as_tensor(w)).numpy().reshape(-1, 4)
    hbuf = np.zeros(Hp * BT)
    u = np.arange(Hp)
    for q in range(BT):
        hbuf[_hpos(u) + q * 8] = h[q]
    want = h @ w                                          # [BT, 4Hp]
    lane = np.arange(32)
    gid, tid = lane >> 2, lane & 3
    got = np.full((BT, 4 * Hp), np.nan)
    for r in range(Hp // 32):
        for ug in range(4):
            for mt in range(2):
                C = np.zeros((4, 16, 8))                  # [nt, rows, cols]
                for k in range(Hp // 8):
                    a = frag[r * Hp * 32 + (k * 2 + mt) * 4 * 32 + ug * 32
                             + lane]                      # [lane, 4]
                    A = np.zeros((16, 8))
                    A[gid, tid], A[gid + 8, tid] = a[:, 0], a[:, 1]
                    A[gid, tid + 4], A[gid + 8, tid + 4] = a[:, 2], a[:, 3]
                    for nt in range(4):
                        at = gid * 8 + 2 * tid + (k * BT + nt * 8) * 8
                        Bm = np.zeros((8, 8))
                        Bm[tid, gid], Bm[tid + 4, gid] = hbuf[at], hbuf[at + 1]
                        C[nt] += A @ Bm
                unit = 32 * r + 8 * ug + np.arange(8)
                for nt in range(4):
                    for half in range(2):                 # rows gid, gid+8
                        col = (2 * mt + half) * Hp + unit
                        got[nt * 8:nt * 8 + 8, col] = \
                            C[nt, half * 8:half * 8 + 8].T
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("H", [288, 416])
def test_l2_widths_match_jax_and_hold_float64(H):
    """One direction at an L2 width on seeded inputs with ragged lengths (a
    zero one): JAX's Pallas kernel (interpret mode) and the port's plain
    version within 1e-5; the kernel's 3xTF32 arithmetic, emulated at the
    padded width, within 2e-5 of the float64 recurrence."""
    rng = np.random.default_rng(H)
    B, T, V = 24, 9, 17
    table = (rng.standard_normal((V, 4 * H)) * 0.3).astype(np.float32)
    w = ((rng.random((H, 4 * H)) * 2 - 1) / H ** 0.5).astype(np.float32)
    tokens = rng.integers(0, V, (B, T))
    lengths = rng.integers(1, T + 1, B)
    lengths[[0, 5]] = 0, T
    valid = np.arange(T)[None] < lengths[:, None]
    x = table[np.where(valid, tokens, 0).T]               # [T, B, 4H]
    jh = np.asarray(lstm_final_hidden_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(valid.T), interpret=True))
    port = tlstm.lstm_recurrence_plain(
        torch.as_tensor(x), torch.as_tensor(w),
        torch.as_tensor(lengths)).numpy()
    ref = tlstm.lstm_recurrence_plain(
        torch.as_tensor(x, dtype=torch.float64),
        torch.as_tensor(w, dtype=torch.float64),
        torch.as_tensor(lengths)).numpy()
    np.testing.assert_allclose(port, jh, rtol=0, atol=1e-5)
    Hp = tlstm.kernel_width(H)
    tp = tlstm.pad_gates(torch.as_tensor(table), H, Hp).numpy()
    wp = tlstm.pad_w_hh(torch.as_tensor(w), H, Hp).numpy()
    emu = lstm_emulated(tp.astype(np.float64), wp.astype(np.float64),
                        tokens, lengths)
    assert np.all(emu[:, H:] == 0)
    assert np.abs(emu[:, :H] - ref).max() <= 2e-5
    assert np.all(emu[lengths == 0] == 0)
