"""The port's hand-written CUDA kernels against their plain PyTorch versions.

Imports only torch and numpy, so it also runs on a card machine without JAX:

    python -m pytest --noconftest tests/test_torch_port_kernels.py -q

Without a CUDA device every test skips (the kernels have no CPU mode).
"""

import numpy as np
import pytest
import torch

from text2pos_torch.ops import _build
from text2pos_torch.ops import lstm as tlstm
from text2pos_torch.ops import sinkhorn as tsink
from text2pos_torch.ops import superglue_gnn as tgnn

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launches(name, fn):
    before = _build.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("T,B,H", [(9, 37, 32), (64, 40, 256), (16, 19, 128)])
def test_lstm_kernel_matches_plain(cuda, T, B, H):
    g = torch.Generator().manual_seed(T)
    xp = torch.randn(T, B, 4 * H, generator=g).to(cuda)
    w_hh = ((torch.rand(H, 4 * H, generator=g) - 0.5) / H ** 0.5).to(cuda)
    lengths = torch.randint(1, T + 1, (B,), generator=g).to(cuda)
    for rev in (False, True):
        got = _launches("lstm", lambda: tlstm.lstm_final_hidden(
            xp, w_hh, lengths, rev))
        want = tlstm.lstm_final_hidden_plain(xp, w_hh, lengths, rev)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


def test_lstm_kernel_rejects_unsupported_width(cuda):
    xp = torch.zeros(3, 2, 4 * 48, device=cuda)
    with pytest.raises(ValueError):
        tlstm.lstm_final_hidden(xp, torch.zeros(48, 192, device=cuda),
                                torch.ones(2, device=cuda))


def test_sinkhorn_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    B, M, N = 1000, 17, 7
    Z = torch.tensor(3 * rng.standard_normal((B, M, N)), dtype=torch.float32)
    mu = torch.tensor(np.log(rng.dirichlet(np.ones(M), B)),
                      dtype=torch.float32)
    nu = torch.tensor(np.log(rng.dirichlet(np.ones(N), B)),
                      dtype=torch.float32)
    args = [a.to(cuda) for a in (Z, mu, nu)]
    got = _launches("sinkhorn", lambda: tsink.log_sinkhorn(*args, 50))
    want = tsink.log_sinkhorn_plain(*args, 50)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _packed(dtype, device, L=4):
    rng = np.random.default_rng(1)
    E = tgnn.KERNEL_SHAPE[0]
    shapes = {"wq": (L, E, E), "wk": (L, E, E), "wv": (L, E, E),
              "wm": (L, E, E), "w0": (L, 2 * E, 2 * E), "w1": (L, 2 * E, E),
              "wf": (E, E), "bq": (L, E), "bk": (L, E), "bv": (L, E),
              "bm": (L, E), "b1": (L, E), "bf": (E,), "s0": (L, 2, 2 * E),
              "t0": (L, 2, 2 * E)}
    folded = {k: (rng.standard_normal(s) / np.sqrt(s[-2]) if k[0] == "w"
                  else rng.random(s)).astype(np.float32)
              for k, s in shapes.items()}
    return tgnn.pack_gnn_params(folded, dtype, device)


@pytest.mark.parametrize("dtype,rel_tol", [(torch.float32, 1e-5),
                                           (torch.bfloat16, 1e-2)])
def test_gnn_kernel_matches_plain(cuda, dtype, rel_tol):
    """Tolerance relative to the largest score: both sides sum in f32 in
    different orders; in bf16 that can move a value by one bf16 step."""
    packed = _packed(dtype, cuda)
    g = torch.Generator().manual_seed(2)
    d0 = torch.randn(37, 16, 128, generator=g).to(cuda)   # odd: a half CTA
    d1 = torch.randn(37, 6, 128, generator=g).to(cuda)
    got = _launches("superglue_gnn", lambda: tgnn.gnn_scores(d0, d1, packed))
    want = tgnn.gnn_scores_plain(d0, d1, packed)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=rel_tol * float(want.abs().max()))


def test_gnn_kernel_keeps_exact_ties(cuda):
    """Identical hints must give bit-identical score columns (mutual-max
    extraction then takes the first, as JAX does)."""
    packed = _packed(torch.bfloat16, cuda)
    g = torch.Generator().manual_seed(3)
    d0 = torch.randn(8, 16, 128, generator=g).to(cuda)
    d1 = torch.randn(8, 6, 128, generator=g).to(cuda)
    d1[:, 4] = d1[:, 1]
    s = tgnn.gnn_scores(d0, d1, packed)
    torch.testing.assert_close(s[:, :, 4], s[:, :, 1], atol=0, rtol=0)
