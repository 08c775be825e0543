"""The port's cascade (``serve_batch(prune_m=...)``) against the JAX
pipeline's, on the committed checkpoints, DB cache and bench queries, f32 on
the CPU; the int8 bank and the soft cheap scores against JAX's functions;
and the fixture that the card checks read."""

import hashlib
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2pos_tpu.config import EvalConfig
from text2pos_tpu.evaluation.pipeline import (build_pipeline_from_checkpoints,
                                              quantize_fine_bank as jquantize)
from text2pos_tpu.train.losses import soft_mass_and_spread as jsoft
from text2pos_torch.evaluation.pipeline import (LocalizationPipeline,
                                                quantize_fine_bank)
from text2pos_torch.train.losses import soft_mass_and_spread

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COARSE = os.path.join(ROOT, "checkpoints", "bench_coarse.msgpack")
FINE = os.path.join(ROOT, "checkpoints", "bench_fine.msgpack")
DB = os.path.join(ROOT, "checkpoints", "bench_db_cache.npz")
FIXTURE = os.path.join(ROOT, "text2pos_torch", "fixtures",
                       "bench_queries.npz")
TOP_K, Q = 10, 16
RR = (128, 4.0, 6.0)           # rerank_k, λ, γ: the bench's cascade
F16_STEP = 2.0 ** -11

# sha256 of each array the fixture held before the cascade's were added
# (scripts/make_torch_port_fixture.py keeps them byte for byte).
FIXTURE_SHA256 = {
    "tokens": "eebd24c579ad13f320140c5352e8d7cd66e2c86fdc47b4b62101248a014e03d2",
    "lengths": "a04189ee59b83132d7270ad3e02475a541155164cf43cd4e8013a97f38e96a80",
    "hint_tokens": "76ec0a202ceb16289d2dcd75838ee4d482f10e3cb6fb76678ba6e0e17e3d0628",
    "hint_lengths": "8f8ec111b81800558ec1817c5a5327f52865a8d88ca28bf3974bd4907252e534",
    "pose_xy": "f2e72a6dbd062fbc2197c57628811dadde78eda3524016a16d637fc89d94b224",
    "pose_scene": "d830d542c6cd30b7f93225a651b8e5350d5e94a198a515ed2507b11fa4a93da2",
    "cell_bbox_xy": "c50a16bd445741ca0204117892ccb96fec844c56a1ecbf927da745ec38a3ae60",
    "cell_size": "d98684e0ec0890e33fee8ba381c309677d76e50a35073c88662b3b532d43c412",
    "cell_scene": "b5ce042694be9e38c2ebb955e1759632d6fca581f1f5f88cb3ccdef351a9f86a",
    "jax_top_idx": "594a8ac34030201379f3801bf25cb578518362b22a79ad024d994d6ce4896033",
    "jax_pos_offsets": "c72e17dc03852dd0344f50c50cfd0e4a5932e97c0c0b73838a788269abbacf0c",
    "jax_top10_at_15m": "b91b18a2c0ed1b71119b940c5bf1c6b9ccae87d45f5ba0e854036ae2e985729e",
    "jax_top1_at_15m": "2459d77a43c871b3b73b1790a36db1059106a780e59aafe8211550d9b0c0e043",
    "jax_rerank_top_idx": "dd8553a72717440f7dae03327e96053db423c666dd0e79f6c5830b862cbf0532",
    "jax_rerank_top10_at_15m": "85f40b814492b00935be5d914bcdeed3e8d959237d1a8bc00795dc3de1ab09c1",
    "rerank": "69ef7dec7472e88ee73c01cea25ee2fb74dcdea7b68cb352bb6cf451a689d599",
    "top_k": "075de2b906dbd7066da008cab735bee896370154603579a50122f9b88545bd45",
}


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIXTURE))


@pytest.fixture(scope="module")
def jax_pipe():
    """JAX's f32 serving pipeline on the calibrated DB and its int8 bank."""
    ecfg = EvalConfig(top_k=(1, 5, TOP_K), threshs=(5, 10, 15), pad_size=16,
                      num_mentioned=6, pointnet_numpoints=256)
    with np.load(DB) as z:
        db = (jnp.asarray(z["cell_enc"]), jnp.asarray(z["fine_bank_enc"]),
              jnp.asarray(z["fine_bank_centers"]))
        stats = flax.serialization.msgpack_restore(z["batch_stats"].tobytes())
    pipe, _, _ = build_pipeline_from_checkpoints(ecfg, COARSE, FINE,
                                                 dtype="float32")
    pipe = pipe.with_calibrated_stats(jax.tree.map(jnp.asarray, stats))
    return pipe, db, jquantize(db[1])


@pytest.fixture(scope="module")
def port():
    pipe = LocalizationPipeline.from_checkpoints(COARSE, FINE, DB,
                                                 dtype="float32",
                                                 device="cpu")
    return pipe, quantize_fine_bank(pipe.fine_bank_enc)


def _queries(fx, n=Q, start=0):
    return [fx[k][start:start + n] for k in ("tokens", "lengths",
                                             "hint_tokens", "hint_lengths")]


def test_fixture_keeps_its_arrays(fx):
    """The arrays written before the cascade's are byte-identical; the
    cascade's are there at the bench's setting."""
    for k, want in FIXTURE_SHA256.items():
        assert hashlib.sha256(fx[k].tobytes()).hexdigest() == want, k
    assert fx["jax_cascade_top_idx"].shape == fx["jax_top_idx"].shape
    np.testing.assert_array_equal(fx["cascade"], [128, 24, 1, 6, 4.0, 6.0])


def test_int8_bank_bit_equal(jax_pipe, port):
    """int8 values and per-object scales bit-equal to JAX's
    ``quantize_fine_bank`` on the whole DB cache bank."""
    _, _, (jq, js) = jax_pipe
    (tq, ts) = port[1]
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_soft_mass_and_spread_matches_jax():
    """Within 1e-6 relative (f32 sums in another order)."""
    rng = np.random.default_rng(7)
    P = rng.dirichlet(np.ones(7), (3, 5, 17)).astype(np.float32)
    P[0, 1] = 0.0                           # a pair with no mass: 1e-9 floor
    ctr = rng.random((3, 5, 16, 2)).astype(np.float32)
    off = rng.normal(size=(3, 5, 6, 2)).astype(np.float32)
    want = jsoft(jnp.asarray(P), jnp.asarray(ctr), jnp.asarray(off))
    got = soft_mass_and_spread(torch.from_numpy(P), torch.from_numpy(ctr),
                               torch.from_numpy(off))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("layers,soft,int8", [
    (1, False, True),          # the bench's cascade: L1:S6 on the int8 bank
    (0, False, False),         # no block: final projection and scores only
    (1, True, False),          # soft cheap scores
], ids=["L1S6-int8", "L0S6", "L1S6-soft"])
def test_cascade_matches_jax(fx, jax_pipe, port, layers, soft, int8):
    """128 → 24 (λ=4, γ=6), 6 Sinkhorn iterations in the cheap pass:
    top_idx and match counts identical, served positions within one f16
    step."""
    jp, (cell_enc, fb0, fb1), (jq, js) = jax_pipe
    tp, (tq, ts) = port
    q = _queries(fx, start=500)
    casc = (24, layers, 6, soft)
    want = jp.serve_batch(jp.coarse_state, jp.fine_state,
                          *map(jnp.asarray, q), cell_enc, TOP_K, fb0, fb1,
                          *RR, *casc, cheap_bank=jq if int8 else None,
                          cheap_scale=js if int8 else None)
    got = tp.serve_batch(*q, TOP_K, *RR, *casc,
                         cheap_bank=tq if int8 else None,
                         cheap_scale=ts if int8 else None)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[2].float().numpy(),
                               np.asarray(want[2], np.float32),
                               atol=F16_STEP, rtol=0)
    if int8:
        np.testing.assert_array_equal(
            got[0].numpy(), fx["jax_cascade_top_idx"][500:500 + Q])


def test_full_depth_cheap_pass_equals_brute_rerank(fx, port):
    """With the cheap pass at the model's full depth its score is the full
    score, so the cascade returns brute-force rerank@128's outputs."""
    tp, _ = port
    q = _queries(fx, start=700)
    sg = tp.fine.superglue
    brute = tp.serve_batch(*q, TOP_K, *RR)
    casc = tp.serve_batch(*q, TOP_K, *RR, 24, sg.num_layers,
                          sg.sinkhorn_iterations)
    for a, b in zip(brute, casc):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cascade_bounds(fx, port):
    """Outside top_k < prune_m < rerank_k the cascade is skipped, as JAX
    skips it (the server raises instead); a cheap pass deeper than the
    matcher raises."""
    tp, _ = port
    q = _queries(fx, n=2)
    brute = tp.serve_batch(*q, TOP_K, *RR)
    for m in (TOP_K, 128):
        for a, b in zip(brute, tp.serve_batch(*q, TOP_K, *RR, m, 1, 6)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="block pairs"):
        tp.serve_batch(*q, TOP_K, *RR, 24, tp.fine.superglue.num_layers + 1)
