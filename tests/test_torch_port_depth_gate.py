"""chip_smoke's ``depth_gate``, the gate of the GNN second form's bf16
route at serving depth, held on the CPU at a narrow width (E = 64, 3
blocks, 128 pairs of 16 objects and 6 hints, seeded descriptors of unit
norm): what it passes and what it fails.

The float64 evaluation and the plain f32 version come from
``gnn_scores_plain``; the kernel's arithmetic from the numpy emulation of
the tensor cores (``tests/test_torch_port_tc_arith.py``), and the seeded
defects from ``scripts/check_depth_gate.py``, which runs the same defects
on the card at E = 300. A defect is applied to the kernel's inputs only,
run here by the plain f32 version: the reference keeps the untouched
inputs.
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

import chip_smoke
from test_torch_port_tc_arith import (KERNEL, _descriptors, gnn_emulated,
                                      padded_weights)
from text2pos_torch.ops import superglue_gnn as tgnn

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "scripts"))
import check_depth_gate  # noqa: E402

torch.set_num_threads(2)
E, L, N = 64, 3, 128


def _case(seed):
    """(packed, d0, d1 as numpy float64 and as f32 tensors, the plain f32
    scores, the float64 scores, the plain f32 scores at the cut depth)."""
    packed = tgnn.pack_gnn_params(tgnn.random_folded_params(L, seed, E),
                                  torch.bfloat16, "cpu")
    d0, d1 = _descriptors(N, 16, 6, E, seed)
    t0, t1 = torch.tensor(d0).float(), torch.tensor(d1).float()
    cut = chip_smoke.first_blocks(packed)
    return (packed, d0, d1, t0, t1, tgnn.gnn_scores_plain(t0, t1, packed),
            chip_smoke.f64_scores(t0, t1, packed),
            tgnn.gnn_scores_plain(t0, t1, cut))


def _defect(seed, kernel_inputs):
    """``depth_gate`` of the plain f32 version run on the defective inputs
    that ``kernel_inputs(packed, t0, t1)`` returns."""
    packed, _, _, t0, t1, plain, ref, cut_plain = _case(seed)
    k0, k1, kp = kernel_inputs(packed, t0, t1)
    return chip_smoke.depth_gate(
        tgnn.gnn_scores_plain(k0, k1, kp), plain, ref,
        tgnn.gnn_scores_plain(k0, k1, chip_smoke.first_blocks(kp)),
        cut_plain)


def test_depth_gate_passes_the_plain_version_against_itself():
    _, _, _, _, _, plain, ref, cut_plain = _case(0)
    ok, r = chip_smoke.depth_gate(plain, plain, ref, cut_plain, cut_plain)
    assert ok, r
    assert r["median"] == r["plain_median"] and r["cut_max"] == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_depth_gate_passes_the_route_arithmetic(seed):
    """The bf16 route's arithmetic (``gnn_emulated`` with ``KERNEL``), at
    full depth and cut to its first two blocks in the same run."""
    packed, d0, d1, _, _, plain, ref, cut_plain = _case(seed)
    got, cut_got = gnn_emulated(d0, d1, padded_weights(packed), E, KERNEL,
                                cut=chip_smoke.DEPTH_CUT_BLOCKS)
    ok, r = chip_smoke.depth_gate(torch.tensor(got), plain, ref,
                                  torch.tensor(cut_got), cut_plain)
    assert ok, r


@pytest.mark.parametrize("block", [0, L - 1])
def test_depth_gate_fails_a_head_scaled_by_1_01(block):
    """Head 0's query weights and bias in one block scaled by 1.01, inside
    the cut depth and past it. On these inputs such a head in block 0 puts
    the cut scores 0.37 of GNN_REL_TOL from the plain version's, three
    times the route arithmetic's 0.09-0.12 but under the tolerance, and
    its largest error stays under 0.4: neither (c) nor (d) tells it from
    rounding noise. The per-pair statistics do: the median error (0.23 in
    block 0, 0.15 in block 2) is far above the plain version's (under
    1e-4)."""
    ok, r = _defect(0, lambda p, t0, t1: (
        t0, t1, check_depth_gate.head_scaled(p, block)))
    assert not ok and not r["a"], r


@pytest.mark.parametrize("seed", [0, 1])
def test_depth_gate_fails_a_corrupted_pair(seed):
    """One pair given its neighbour's object descriptors: caught by the
    largest per-pair error (c) or at the cut depth (d), not only by the
    statistics."""
    def swap(p, t0, t1):
        t0 = t0.clone()
        t0[N // 2] = t0[N // 2 + 1]
        return t0, t1, p

    ok, r = _defect(seed, swap)
    assert not ok and not (r["c"] and r["d"]), r
