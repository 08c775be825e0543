"""The plan of Sinkhorn's wide form (``text2pos_torch/csrc/sinkhorn.cu``),
mirrored in Python (``ops.sinkhorn.wide_plan``): the route each coupling
takes (shared memory or the workspace), its couplings a CTA and its shared
memory, on the H100's 232,448 bytes a CTA and at the edges where the plan
halves its couplings. The card tests hold the C side's plan to this mirror
(``tests/test_torch_port_kernels_wide.py``)."""

import pytest

from text2pos_torch.ops import sinkhorn as tsink

SMEM = 232448

# (M, N): (route, couplings a CTA, shared-memory bytes a CTA).
WIDE = {(49, 7): ("smem", 4, 4 * 4 * (49 * 7 + 2 * 56)),
        (65, 17): ("smem", 4, 4 * 4 * (65 * 17 + 2 * 82)),
        (33, 33): ("smem", 4, 4 * 4 * (33 * 33 + 2 * 66)),
        (120, 120): ("smem", 2, 2 * 4 * (120 * 121 + 2 * 240)),
        (201, 200): ("smem", 1, 4 * (201 * 201 + 2 * 401)),
        (300, 300): ("workspace", 4, 0)}


@pytest.mark.parametrize("M,N", sorted(WIDE))
def test_sinkhorn_wide_plan(M, N):
    p = tsink.wide_plan(M, N)
    assert tuple(p) == WIDE[M, N]
    assert p.smem <= SMEM


# (M, N, bytes a CTA may take): the plan at the edges of its halving. A
# [49, 7] coupling takes 1,820 bytes (Z at row stride 7, u, v and the
# marginals), a [120, 120] one 60,000 (row stride 121).
EDGES = {(49, 7, 7280): ("smem", 4, 7280),
         (49, 7, 7279): ("smem", 2, 3640),
         (49, 7, 3639): ("smem", 1, 1820),
         (120, 120, 60000): ("smem", 1, 60000),
         (120, 120, 59999): ("workspace", 4, 0)}


@pytest.mark.parametrize("M,N,smem_max", sorted(EDGES))
def test_sinkhorn_wide_plan_halves_to_fit(M, N, smem_max):
    """Four couplings a CTA where they fit, halved until they do, the
    workspace where one coupling does not."""
    p = tsink.wide_plan(M, N, smem_max)
    assert tuple(p) == EDGES[M, N, smem_max]
    assert p.smem <= smem_max
