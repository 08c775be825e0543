"""The evaluation entry points on the card: which hand-written kernels they
launch, on the committed bench checkpoints over a 64-cell slice of the
bench map (16 queries, top-k 1/5/10, re-rank of 32).

Imports only torch and numpy, so it runs on a card machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_eval_cuda.py

Without a CUDA device every test skips (the kernels have no CPU mode).
"""

import os

import numpy as np
import pytest
import torch

from text2pos_torch.config import EvalConfig
from text2pos_torch.ops import _build

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = [os.path.join(ROOT, "checkpoints", f"bench_{s}.msgpack")
        for s in ("coarse", "fine")]


class SliceLoader:
    """What the evaluator reads of a ``CoarseLoader``: the bank, each
    pose's cell and the joined query texts."""

    def __init__(self, bank, poses, vocab):
        from text2pos_torch.data.hints import create_hint_description

        self.bank = bank
        ids = {c: i for i, c in enumerate(bank.cell_ids)}
        self.pose_cell_idx = np.array([ids[p.cell_id] for p in poses],
                                      np.int32)
        self.texts = [" ".join(create_hint_description(p)) for p in poses]
        self.vocab = vocab

    def all_query_tokens(self):
        return self.vocab.encode_batch(self.texts, 64)


@pytest.fixture(scope="module")
def bench():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from text2pos_torch.data.bench import bench_cell_bank, make_bench_dataset
    from text2pos_torch.data.dense import CellBank
    from text2pos_torch.evaluation.pipeline import \
        build_pipeline_from_checkpoints

    cfg = EvalConfig(top_k=(1, 5, 10), rerank=32, rerank_gamma=6.0)
    pipe, vocab, fine_vocab = build_pipeline_from_checkpoints(cfg, *CKPT)
    cells, poses = make_bench_dataset()
    full = bench_cell_bank(cells)
    bank = CellBank(**{f: getattr(full, f)[:64]
                       for f in CellBank.__dataclass_fields__})
    poses = poses[:16]
    return pipe, SliceLoader(bank, poses, vocab), poses, fine_vocab


def launched(fn):
    _build.LAUNCHES.clear()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_build.LAUNCHES)


def test_run_coarse_launches_lstm_fps_pointconv(bench):
    pipe, loader, poses, _ = bench
    (top_idx, accs), n = launched(lambda: pipe.run_coarse(loader, poses))
    assert top_idx.shape == (16, 32)
    assert 0.0 <= accs[10][15] <= 1.0
    # 16 queries in one step of 32; 64 cells in two: one FPS launch a
    # PointNet forward, 3 PointConv levels
    assert n.get("lstm") == 1 and n.get("fps") == 2 and n.get("pointconv") == 6


def test_run_fine_batch_statistics_launches(bench):
    """On the checkpoints' pipeline the fine BNs take batch statistics:
    the GNN runs as PyTorch ops, the LSTM, Sinkhorn and FPS kernels run."""
    pipe, loader, poses, fine_vocab = bench
    top_idx = pipe.run_coarse(loader, poses)[0]
    accs, n = launched(lambda: pipe.run_fine(loader, poses, top_idx,
                                             fine_vocab))
    assert set(accs[2]) == {1}
    assert n.get("lstm") == 2 and n.get("sinkhorn") == 2   # 2 chunks of 8
    assert n.get("fps") == 1 and not n.get("superglue_gnn")
    assert not n.get("pointconv")


def test_run_fine_calibrated_launches_gnn(bench):
    """A calibrated pipeline runs the GNN and PointConv kernels too."""
    from text2pos_torch.evaluation.pipeline import hint_arrays
    from text2pos_torch.data.hints import create_hint_description

    pipe, loader, poses, fine_vocab = bench
    top_idx = pipe.run_coarse(loader, poses)[0]
    htk, hln = hint_arrays(fine_vocab, [create_hint_description(p)
                                        for p in poses], 6, 16)
    cal = pipe.calibrated_for_serving(loader.bank, htk, hln, top_idx[:, :10])
    _, n = launched(lambda: cal.run_fine(loader, poses, top_idx, fine_vocab))
    assert n.get("superglue_gnn") == 2 and n.get("pointconv") == 3
    assert n.get("sinkhorn") == 2 and n.get("lstm") == 2


def test_fine_in_isolation_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from text2pos_torch.evaluation.fine import main

    out, n = launched(lambda: main(["--dataset", "SYNTHETIC-FINE",
                                    "--path_fine", CKPT[1]]))
    assert 0.0 <= out["stats"]["recall"] <= 1.0
    # 64 validation poses in two batches of 32, one FPS launch a batch
    assert n.get("lstm") == 2 and n.get("sinkhorn") == 2
    assert n.get("fps") == 2
