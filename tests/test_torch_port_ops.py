"""The port's ops (``text2pos_torch/ops``) against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function (XLA
reference, or the Pallas kernel in interpret mode) and through the port's
plain PyTorch version, which is what the port's wrappers run on a CPU
tensor. The kernels themselves are held against the plain versions on the
card by ``test_torch_port_kernels.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2pos_tpu.ops.lstm import LSTMParams as JLSTMParams
from text2pos_tpu.ops.lstm import _bilstm_xla
from text2pos_tpu.ops.lstm import bilstm_final_hidden as jbilstm
from text2pos_tpu.ops.lstm_pallas import (bilstm_final_hidden_pallas,
                                          lstm_final_hidden_pallas)
from text2pos_tpu.ops.retrieval import topk_retrieval as jtopk
from text2pos_tpu.ops.sinkhorn import extract_matches as jextract
from text2pos_tpu.ops.sinkhorn import log_optimal_transport as jlot
from text2pos_tpu.ops.sinkhorn import log_sinkhorn as jsinkhorn
from text2pos_tpu.ops.sinkhorn_pallas import log_sinkhorn_pallas
from text2pos_tpu.ops.superglue_gnn_pallas import fold_gnn_params as jfold
from text2pos_tpu.ops.superglue_gnn_pallas import gnn_scores_pallas
from text2pos_torch.ops import lstm as tlstm
from text2pos_torch.ops import sinkhorn as tsink
from text2pos_torch.ops import superglue_gnn as tgnn
from text2pos_torch.ops.retrieval import topk_retrieval

torch.set_num_threads(2)

F32_TOL = 1e-4   # f32 on both sides, different summation order
TABLE_TOL = 1e-5  # f32 token-table gather vs the projected input: the same
                  # products, reassociated (values of h lie in (-1, 1))


def _t(a):
    return torch.from_numpy(np.array(a))


def _lstm_params(rng, E, H):
    s = 1.0 / np.sqrt(H)
    return [rng.uniform(-s, s, shape).astype(np.float32)
            for shape in ((E, 4 * H), (H, 4 * H), (4 * H,))]


class TestLSTM:
    @pytest.mark.parametrize("B,T,E", [(10, 7, 16), (33, 12, 32)])
    def test_bilstm_matches_jax(self, B, T, E):
        rng = np.random.default_rng(B)
        fwd, bwd = _lstm_params(rng, E, E), _lstm_params(rng, E, E)
        x = rng.standard_normal((B, T, E)).astype(np.float32)
        lengths = np.concatenate([np.arange(1, T + 1),
                                  rng.integers(1, T + 1, B - T)]
                                 ).astype(np.int32)
        want_xla = np.asarray(_bilstm_xla(
            jnp.asarray(x), jnp.asarray(lengths), JLSTMParams(*fwd),
            JLSTMParams(*bwd)))
        want_pallas = np.asarray(bilstm_final_hidden_pallas(
            jnp.asarray(x), jnp.asarray(lengths), JLSTMParams(*fwd),
            JLSTMParams(*bwd), block_b=8, interpret=True))
        got = tlstm.bilstm_final_hidden(
            _t(x), _t(lengths), tlstm.LSTMParams(*map(_t, fwd)),
            tlstm.LSTMParams(*map(_t, bwd))).numpy()
        np.testing.assert_allclose(got, want_xla, atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(got, want_pallas, atol=F32_TOL,
                                   rtol=F32_TOL)

    @pytest.mark.parametrize("reverse", [False, True])
    def test_one_direction_masking(self, reverse):
        """Each direction against the Pallas recurrence on the same
        projections (a table of T·B rows read by running indices); the
        backward one runs over the reversed sequence with reversed
        validity."""
        rng = np.random.default_rng(5)
        T, B, H = 6, 7, 8
        xp = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
        w_hh = _lstm_params(rng, H, H)[1]
        lengths = np.array([1, 2, 3, 4, 5, 6, 3], np.int32)
        valid = np.arange(T)[:, None] < lengths[None, :]
        jx, jv = (xp[::-1], valid[::-1]) if reverse else (xp, valid)
        want = np.asarray(lstm_final_hidden_pallas(
            jnp.asarray(jx.copy()), jnp.asarray(w_hh), jnp.asarray(jv.copy()),
            block_b=8, interpret=True))
        table, tokens = _running_table(xp)
        got = tlstm.lstm_final_hidden([table, table], [_t(w_hh)] * 2, tokens,
                                      _t(lengths))[int(reverse)].numpy()
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)

    def test_steps_past_length_are_ignored(self):
        rng = np.random.default_rng(6)
        T, B, H = 5, 4, 8
        xp = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
        w_hh = [_t(_lstm_params(rng, H, H)[1])] * 2
        lengths = torch.tensor([1, 3, 5, 2])
        garbage = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
        long = np.concatenate([xp, garbage])
        a = tlstm.lstm_final_hidden([_running_table(xp)[0]] * 2, w_hh,
                                    _running_table(xp)[1], lengths)
        table, tokens = _running_table(long)
        b = tlstm.lstm_final_hidden([table] * 2, w_hh, tokens, lengths)
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def _running_table(xp):
    """x_proj [T, B, 4H] as a table of B·T rows and the [B, T] indices
    that read it back."""
    T, B, H4 = xp.shape
    table = _t(np.ascontiguousarray(xp.transpose(1, 0, 2)).reshape(B * T, H4))
    return table, torch.arange(B * T, dtype=torch.int32).view(B, T)


class TestTokenTableLSTM:
    """The encoder's path: token ids gather rows of emb·W_ih + b (row 0
    from the zeroed unk/pad embedding), against JAX's bilstm_final_hidden
    on the embedded tokens and the port's generic path (tolerance
    TABLE_TOL)."""

    @pytest.mark.parametrize("H,B,T", [(32, 37, 9), (128, 19, 16)])
    def test_token_table_matches_jax_and_generic(self, H, B, T):
        rng = np.random.default_rng(H + B)
        V = 23
        emb = rng.standard_normal((V, H)).astype(np.float32)   # row 0 != 0
        fwd, bwd = _lstm_params(rng, H, H), _lstm_params(rng, H, H)
        tokens = rng.integers(0, V, (B, T)).astype(np.int32)
        tokens[:, 0] = 0                      # unk inside the valid length
        tokens[3, :] = 0                      # a sequence of unk only
        lengths = rng.integers(1, T + 1, B).astype(np.int32)
        lengths[:3] = (1, T, 2)               # length 1 and length T
        tokens[2, 1] = 0                      # unk as the last valid token
        x = emb[tokens] * (tokens != 0)[..., None]
        want = np.asarray(jbilstm(jnp.asarray(x), jnp.asarray(lengths),
                                  JLSTMParams(*fwd), JLSTMParams(*bwd)))
        tf, tb = (tlstm.LSTMParams(*map(_t, p)) for p in (fwd, bwd))
        tables = tlstm.token_tables(_t(emb), tf, tb)
        np.testing.assert_array_equal(tables[0][0].numpy(), fwd[2])
        np.testing.assert_array_equal(tables[1][0].numpy(), bwd[2])
        got = tlstm.bilstm_tokens(tables, tf, tb, _t(tokens),
                                  _t(lengths)).numpy()
        generic = tlstm.bilstm_final_hidden(_t(x), _t(lengths), tf,
                                            tb).numpy()
        np.testing.assert_allclose(got, want, atol=TABLE_TOL, rtol=TABLE_TOL)
        np.testing.assert_allclose(got, generic, atol=TABLE_TOL,
                                   rtol=TABLE_TOL)

    def test_padding_tokens_are_never_read(self):
        """Steps past a sequence's length may hold any id, even one outside
        the table: the plain version, like the kernel, never looks them
        up."""
        rng = np.random.default_rng(9)
        H, V, B, T = 32, 7, 5, 6
        tables = [_t(rng.standard_normal((V, 4 * H)).astype(np.float32))
                  for _ in range(2)]
        w_hh = [_t(_lstm_params(rng, H, H)[1]) for _ in range(2)]
        tokens = torch.as_tensor(rng.integers(0, V, (B, T)), dtype=torch.int32)
        lengths = torch.tensor([1, 6, 3, 2, 4])
        bad = tokens.clone()
        bad[torch.arange(T)[None] >= lengths[:, None]] = 10 ** 6
        a = tlstm.lstm_final_hidden(tables, w_hh, tokens, lengths)
        b = tlstm.lstm_final_hidden(tables, w_hh, bad, lengths)
        torch.testing.assert_close(a, b, atol=0, rtol=0)


class TestSinkhorn:
    def _inputs(self, B=9, M=17, N=7, seed=0):
        rng = np.random.default_rng(seed)
        Z = (3 * rng.standard_normal((B, M, N))).astype(np.float32)
        mu = np.log(rng.dirichlet(np.ones(M), B)).astype(np.float32)
        nu = np.log(rng.dirichlet(np.ones(N), B)).astype(np.float32)
        return Z, mu, nu

    def test_log_sinkhorn_matches_jax(self):
        Z, mu, nu = self._inputs()
        want = np.asarray(jsinkhorn(*map(jnp.asarray, (Z, mu, nu)), 50))
        want_p = np.asarray(log_sinkhorn_pallas(
            *map(jnp.asarray, (Z, mu, nu)), 50, block_b=4, interpret=True))
        got = tsink.log_sinkhorn(_t(Z), _t(mu), _t(nu), 50).numpy()
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(got, want_p, atol=F32_TOL, rtol=F32_TOL)

    def test_log_optimal_transport_matches_jax(self):
        rng = np.random.default_rng(1)
        scores = (4 * rng.standard_normal((5, 16, 6))).astype(np.float32)
        want = np.asarray(jlot(jnp.asarray(scores), jnp.asarray(1.3), 50,
                               impl="xla"))
        got = tsink.log_optimal_transport(_t(scores), torch.tensor(1.3),
                                          50).numpy()
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)

    @pytest.mark.parametrize("B,M,N,iters,scale", [
        (33, 16, 6, 50, 60.0),     # the serving coupling, scores to +-60
        (4, 1, 1, 50, 5.0),        # the smallest
        (3, 31, 15, 50, 10.0),     # the largest register coupling
        (6, 16, 6, 0, 5.0), (6, 16, 6, 1, 5.0)])
    def test_fused_dustbin_plain_matches_jax(self, B, M, N, iters, scale):
        """The fused kernel's plain twin (dustbins, marginals and - norm
        around the plain Sinkhorn) against JAX's log_optimal_transport."""
        rng = np.random.default_rng(M * N + iters)
        scores = np.clip(scale / 3 * rng.standard_normal((B, M, N)), -scale,
                         scale).astype(np.float32)
        scores[0, 0, 0] = scale
        want = np.asarray(jlot(jnp.asarray(scores), jnp.asarray(0.7), iters,
                               impl="xla"))
        got = tsink.log_optimal_transport_plain(
            _t(scores), torch.tensor(0.7), iters).numpy()
        assert got.shape == (B, M + 1, N + 1)
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)

    def test_extract_matches_matches_jax_with_ties(self):
        rng = np.random.default_rng(2)
        Z = np.log(rng.uniform(0.01, 1.0, (6, 9, 5))).astype(np.float32)
        Z[0, 2, :2] = Z[0, 2, 3]          # argmax ties along rows
        Z[1, :4, 1] = Z[1, 5, 1]          # and along columns
        Z[2, 3, 1] = Z[2, 3, 2] = 0.0     # a tied pair of maxima
        Z[3] = Z[3, :, :1]                # a whole row of ties
        want = jextract(jnp.asarray(Z), 0.2)
        got = tsink.extract_matches(_t(Z), 0.2)
        for key in ("matches0", "matches1"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
        for key in ("matching_scores0", "matching_scores1"):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), atol=1e-6)


def test_topk_ties_match_lax_top_k():
    rng = np.random.default_rng(3)
    text = rng.standard_normal((6, 8)).astype(np.float32)
    cells = rng.standard_normal((40, 8)).astype(np.float32)
    cells[[3, 7, 21, 30]] = cells[12]        # four duplicates of one cell
    cells[[5, 6]] = cells[33]
    text[2] = 0.0                            # every score ties
    want_s, want_i = jtopk(jnp.asarray(text), jnp.asarray(cells), 10)
    got_s, got_i = topk_retrieval(_t(text), _t(cells), 10)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5)


class TestGNN:
    E, T0, T1, LAYERS = 32, 16, 6, 1

    @pytest.fixture(scope="class")
    def trees(self):
        """JAX-layout SuperGlue params and randomized per-set [2, 2E]
        calibrated statistics, from a seed."""
        rng = np.random.default_rng(0)
        E = self.E

        def dense(i, o):
            return {"kernel": (rng.standard_normal((i, o)) / np.sqrt(i)
                               ).astype(np.float32),
                    "bias": (0.1 * rng.standard_normal(o)).astype(np.float32)}

        gnn, stats = {}, {}
        for i in range(2 * self.LAYERS):
            gnn[f"layer_{i}"] = {
                "attn": {n: dense(E, E) for n in
                         ("proj_q", "proj_k", "proj_v", "merge")},
                "mlp": {"dense_0": dense(2 * E, 2 * E),
                        "dense_1": dense(2 * E, E),
                        "bn_0": {"scale": rng.uniform(0.5, 1.5, 2 * E
                                                      ).astype(np.float32),
                                 "bias": (0.1 * rng.standard_normal(2 * E)
                                          ).astype(np.float32)}}}
            stats[f"layer_{i}"] = {"mlp": {"bn_0": {
                "mean": (0.3 * rng.standard_normal((2, 2 * E))
                         ).astype(np.float32),
                "var": rng.uniform(0.2, 2.0, (2, 2 * E)).astype(np.float32)}}}
        params = {"superglue": {"gnn": gnn, "final_proj": dense(E, E),
                                "bin_score": np.float32(1.0)}}
        return params, {"superglue": {"gnn": stats}}

    def _descs(self, N, seed):
        rng = np.random.default_rng(seed)
        return (rng.standard_normal((N, self.T0, self.E)).astype(np.float32),
                rng.standard_normal((N, self.T1, self.E)).astype(np.float32))

    def test_fold_matches_jax(self, trees):
        got = tgnn.fold_gnn_params(*trees, self.LAYERS)
        want = jfold(*trees, self.LAYERS)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)

    def test_plain_matches_pallas_f32(self, trees):
        d0, d1 = self._descs(5, 7)
        folded = jfold(*trees, self.LAYERS)
        want = np.asarray(gnn_scores_pallas(
            jnp.asarray(d0), jnp.asarray(d1),
            {k: jnp.asarray(v) for k, v in folded.items()}, self.LAYERS,
            pairs_per_program=4, dtype=jnp.float32, interpret=True))
        packed = tgnn.pack_gnn_params(tgnn.fold_gnn_params(*trees,
                                                           self.LAYERS),
                                      torch.float32, "cpu")
        got = tgnn.gnn_scores(_t(d0), _t(d1), packed).numpy()
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)

    def test_plain_bf16_close_to_pallas_bf16(self, trees):
        """bf16 bodies round at slightly different points in the two
        formulations (the Pallas kernel keeps the residual in bf16, the
        port in f32 as the XLA eval path does): agreement to 5% of the
        score scale, the JAX package's own bf16 bound."""
        d0, d1 = self._descs(4, 8)
        folded = jfold(*trees, self.LAYERS)
        want = np.asarray(gnn_scores_pallas(
            jnp.asarray(d0), jnp.asarray(d1),
            {k: jnp.asarray(v) for k, v in folded.items()}, self.LAYERS,
            pairs_per_program=4, dtype=jnp.bfloat16, interpret=True))
        packed = tgnn.pack_gnn_params(folded, torch.bfloat16, "cpu")
        got = tgnn.gnn_scores(_t(d0), _t(d1), packed).numpy()
        assert np.abs(got - want).max() / np.abs(want).max() < 0.05
