"""Numpy emulations of the tensor-core arithmetic of two hand-written
kernels, held to float64 evaluations on the CPU.

The kernels cannot run here, but their arithmetic can: every value they
round is a float32 (or bf16) value, every product of two such values is
exact in float64, and the tensor cores' summation follows a rule that
``scripts/probe_mma_rounding.py`` reads bit for bit on the card. The
emulations below follow the kernels' sources step by step:

- ``tc_sum``: one ``mma.sync`` on its accumulator: the products and the
  accumulator aligned to the largest exponent among them, each truncated
  below that exponent's 24-bit significand, added exactly, and the sum
  truncated toward zero to f32 (the tensor cores' rounding toward zero).
- ``lstm_emulated``: ``csrc/lstm.cu``'s recurrence in 3xTF32
  (``mma.sync.m16n8k8`` on TF32 operands), in its arithmetic (both TF32
  parts rounded to nearest, small·big and big·small in one chain, each
  k-step's big·big product from zero added in f32) and in the one its L2
  form had before its repair (big truncated, small left for the tensor
  cores to truncate, three chains), which the kernel no longer has.
- ``gnn_tc_emulated``: the bf16 route of ``csrc/superglue_gnn_any.cu``
  (``mma.sync.m16n8k16``, each k-step's sum added to the running sum in
  f32, bf16 rounding points of ``gnn_scores_plain``), with the options
  its arithmetic had and has: the k-steps' sums of 16 or of 8 products,
  the logit scale by a reciprocal multiply or a division, and the softmax
  by ``__expf`` and one reciprocal a row or by ``expf`` and a division an
  element.

Tests (tolerances stated at each):

- ``tc_sum`` reproduces bit for bit the card's bf16 and TF32 ``mma``
  outputs that the probe recorded (``text2pos_torch/fixtures/
  mma_rounding.npz``, 16 tiles of each case: zero and random
  accumulators, operand exponents spread over 2^0 to 2^6).
- On the bench text encoder (``checkpoints/bench_coarse.msgpack``) and
  the first queries of the bench fixture with a seeded share of unknown
  words (the card test's input), zero-padded to H = 300, the emulated
  L2-form recurrence and JAX's f32 recurrence (``text2pos_tpu/ops/
  lstm.py``) both lie within 2e-5 of the float64 recurrence, and the
  earlier arithmetic at least 5x farther than the current one.
- A few blocks deep at a narrow width, the emulated GNN bf16 arithmetic is
  no farther from the float64 evaluation than ``gnn_scores_plain`` in f32.

Run as a script (``JAX_PLATFORMS=cpu python
tests/test_torch_port_tc_arith.py``) it prints, for the GNN at E = 300, the bf16 roundings each option's
arithmetic flips against the float64 evaluation, stage by stage, each
stage fed the float64 evaluation's inputs, and the per-pair score errors
at full depth.
"""

from __future__ import annotations

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2pos_tpu.ops.lstm import LSTMParams as JLSTMParams
from text2pos_tpu.ops.lstm import _lstm_scan
from text2pos_torch.ops import lstm as tlstm
from text2pos_torch.ops import superglue_gnn as tgnn

torch.set_num_threads(2)

# The tensor cores' summation, as scripts/probe_mma_rounding.py read it bit
# for bit on an H100 (bf16 m16n8k16 and m16n8k8, TF32 m16n8k8): terms
# aligned to the largest exponent (a product's: its operands' exponents
# added), truncated TC_EXTRA_BITS below that exponent's 24-bit significand,
# the sum truncated toward zero; products summed TC_BLOCK at a time.
TC_EXTRA_BITS = 2
TC_BLOCK = {"bf16": 16, "tf32": 8}
PROBE = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                     "text2pos_torch", "fixtures", "mma_rounding.npz")


# ---------------------------------------------------------------------------
# Rounding. Arrays are float64 holding f32 (or bf16, TF32) values.
# ---------------------------------------------------------------------------

def rn32(x):
    """To f32, to nearest."""
    return np.asarray(x, np.float64).astype(np.float32).astype(np.float64)


def rz32(x):
    """To f32, toward zero."""
    x = np.asarray(x, np.float64)
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(r, np.float32(0)), r).astype(
        np.float64)


def _bits(x):
    return rn32(x).astype(np.float32).view(np.uint32).astype(np.uint64)


def _from_bits(u):
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def round_bits(x, keep: int):
    """f32 values to ``keep`` stored mantissa bits, to nearest, ties to
    even (7: bf16, the port's ``rnd``)."""
    u = _bits(x)
    drop = 23 - keep
    half = (1 << (drop - 1)) - 1 + ((u >> drop) & 1)
    return _from_bits((u + half) >> drop << drop)


def bf16(x):
    return round_bits(x, 7)


def tf32_round_half_up(x):
    """The kernel's TF32 rounding: add half an ulp and clear (ties away)."""
    return _from_bits((_bits(x) + 0x1000) & 0xFFFFE000)


def tf32_trunc(x):
    return _from_bits(_bits(x) & 0xFFFFE000)


# ---------------------------------------------------------------------------
# The tensor cores.
# ---------------------------------------------------------------------------

def _floor_log2(x):
    """floor(log2|x|) of f32 values; a very small one for 0."""
    m, e = np.frexp(x)
    return np.where(m != 0, e - 1, -1000)


def tc_sum(a, b, block: int, acc=None):
    """One ``mma`` on each output: the products a·b of the operands
    a, b [..., k] (bf16 or TF32 values, broadcast), in k order, on the f32
    accumulator ``acc`` [...] (0 if None). Each block of ``block`` products
    joins the running value, all aligned to the largest of their exponents
    (a product's: the sum of its operands' exponents), truncated
    TC_EXTRA_BITS below that exponent's 24-bit significand, summed exactly
    and truncated toward zero to f32."""
    prods = a * b
    exps = _floor_log2(a) + _floor_log2(b)
    acc = np.zeros(prods.shape[:-1]) if acc is None else acc
    for k0 in range(0, prods.shape[-1], block):
        t = np.concatenate([acc[..., None], prods[..., k0:k0 + block]], -1)
        e = np.concatenate([_floor_log2(acc)[..., None],
                            exps[..., k0:k0 + block]], -1)
        q = np.exp2(e.max(-1) - 23 - TC_EXTRA_BITS)[..., None]
        acc = rz32((np.trunc(t / q) * q).sum(-1))
    return acc


def tc_matmul(x, w, k: int = 16, mode: str = "tc", rows: int = 64):
    """x [..., R, K] @ w [K, N] (bf16 values) as the kernel sums it: a
    zeroed accumulator per k-step of ``k`` products, its result added to
    the running sum in f32 (to nearest), k-steps in order. ``mode`` "tc":
    the tensor cores' sum (``tc_sum``); "exact": each k-step's sum exact,
    rounded to nearest; "compensated": the tensor cores' sums, added with
    the error of each add kept in a second f32 sum (two-sum), which joins
    at the end."""
    lead, (R, K), N = x.shape[:-2], x.shape[-2:], w.shape[-1]
    x = x.reshape(-1, K)
    pad = -K % k
    if pad:
        x = np.concatenate([x, np.zeros((len(x), pad))], 1)
        w = np.concatenate([w, np.zeros((pad, N))], 0)
    ks = x.shape[1] // k
    out = np.empty((len(x), N))
    for r0 in range(0, len(x), rows):
        xr = x[r0:r0 + rows].reshape(-1, ks, k)
        if mode == "exact":
            parts = rn32(np.einsum("rsk,skn->rns", xr, w.reshape(ks, k, N)))
        else:
            parts = tc_sum(xr[:, None], w.reshape(ks, k, N).transpose(
                2, 0, 1)[None], TC_BLOCK["bf16"])           # [r, N, ks]
        acc = np.zeros(parts.shape[:2])
        comp = np.zeros(parts.shape[:2])
        for s in range(ks):
            p = parts[..., s]
            total = rn32(acc + p)
            if mode == "compensated":
                back = rn32(total - acc)
                comp = rn32(comp + rn32(rn32(acc - rn32(total - back))
                                        + rn32(p - back)))
            acc = total
        out[r0:r0 + rows] = rn32(acc + comp) if mode == "compensated" \
            else acc
    return out.reshape(*lead, R, N)


# ---------------------------------------------------------------------------
# The LSTM (csrc/lstm.cu).
# ---------------------------------------------------------------------------

def _sigmoid32(x):
    return rn32(1.0 / rn32(1.0 + rn32(np.exp(-x))))


def _fma32(a, b, c):
    return rn32(a * b + c)


def lstm_emulated(table, w_hh, tokens, lengths, arithmetic: str = "rounded",
                  reverse: bool = False):
    """Final h [B, H] of one direction as ``csrc/lstm.cu`` computes it: the
    gate sums W^T·h in 3xTF32 on ``mma.sync.m16n8k8`` (k-steps of 8), on
    top of the gate inputs ``table[tokens]``. ``arithmetic`` "rounded"
    (both forms): both parts rounded, small·big and big·small in one
    chain from zero, each k-step's big·big product from zero added in f32,
    the chain added last; "truncated" (the L2 form before its repair, no
    longer in the kernel): big truncated,
    small = x - big (truncated by the tensor cores), small·big, big·small
    and big·big in three chains, big·big's on top of the gate inputs."""
    B, T = tokens.shape
    H = w_hh.shape[0]
    W = rn32(w_hh)
    if arithmetic == "rounded":
        wb = tf32_round_half_up(W)
        ws = tf32_round_half_up(rn32(W - wb))
    else:
        wb = tf32_trunc(W)
        ws = tf32_trunc(rn32(W - wb))
    ks = H // 8
    blk = TC_BLOCK["tf32"]

    h = np.zeros((B, H))
    c = np.zeros((B, H))
    steps = range(T - 1, -1, -1) if reverse else range(T)
    for t in steps:
        valid = t < lengths
        xin = rn32(table[np.where(valid, tokens[:, t], 0)])     # [B, 4H]
        if arithmetic == "rounded":
            hb = tf32_round_half_up(h)
            hs = tf32_round_half_up(rn32(h - hb))
        else:
            hb = tf32_trunc(h)
            hs = tf32_trunc(rn32(h - hb))
        hb3, hs3 = hb.reshape(B, ks, 8), hs.reshape(B, ks, 8)
        wb3, ws3 = wb.reshape(ks, 8, 4 * H), ws.reshape(ks, 8, 4 * H)

        def prods(a, b, s):
            # h [B, k] x W [k, 4H] as operand pairs [B, 4H, k].
            return a[:, s, None, :], b[s].T[None]

        if arithmetic == "rounded":
            acc, acc2 = xin, np.zeros((B, 4 * H))
            for s in range(ks):
                acc2 = tc_sum(*prods(hb3, ws3, s), blk, acc2)
                acc2 = tc_sum(*prods(hs3, wb3, s), blk, acc2)
                acc = rn32(acc + tc_sum(*prods(hb3, wb3, s), blk))
            gates = rn32(acc + acc2)
        else:
            acc, acc2, acc3 = xin, np.zeros((B, 4 * H)), np.zeros((B, 4 * H))
            for s in range(ks):
                acc2 = tc_sum(*prods(hb3, ws3, s), blk, acc2)
                acc3 = tc_sum(*prods(hs3, wb3, s), blk, acc3)
                acc = tc_sum(*prods(hb3, wb3, s), blk, acc)
            gates = rn32(acc + rn32(acc2 + acc3))
        i, f, g, o = np.split(gates, 4, axis=-1)
        ig, fg, og = _sigmoid32(i), _sigmoid32(f), _sigmoid32(o)
        gg = rn32(np.tanh(g))
        cn = _fma32(fg, c, rn32(ig * gg))
        hn = rn32(og * rn32(np.tanh(cn)))
        h = np.where(valid[:, None], hn, h)
        c = np.where(valid[:, None], cn, c)
    return h


# ---------------------------------------------------------------------------
# The GNN's second form, bf16 route (csrc/superglue_gnn_any.cu, namespace tc).
# ---------------------------------------------------------------------------

# The route's arithmetic: each k-step's sum added to the running sum by a
# rounded f32 add; TWO_SUM keeps those adds' errors in a second sum.
KERNEL = {"mm": "tc16", "scale": "reciprocal", "softmax": "fast"}
TWO_SUM = dict(KERNEL, mm="tc16c")
FLOAT64 = {"mm": "f64", "scale": "f64", "softmax": "f64"}
LOG2E = float(np.float32(math.log2(math.e)))


def padded_weights(packed):
    """A bf16 pack (``pack_gnn_params``, on the CPU) as float64 arrays at
    the padded width: the matmul weights row-major [.., K, N] in the
    kernel's layout (q|k|v and the messages by head), the rest as they
    are."""
    out = {k: v.double().numpy() for k, v in packed.items()
           if k not in tgnn.MATMUL_WEIGHTS and k != "width"}
    for k in tgnn.MATMUL_WEIGHTS:
        out[k] = tgnn.from_fragment_order(packed[k]).double().numpy()
    return out


def _matmul(x, w, mode):
    """x [..., R, K] @ w [K, N] or [..., K, N] in the arithmetic ``mode``:
    "f64" float64; "f32" numpy's f32 product; "tc16" / "tc8" k-steps of 16
    or 8 products on the tensor cores, each added to the running sum in
    f32; "exact16" those k-steps summed exactly and rounded to nearest;
    "tc16c" k-steps of 16 added by two-sum; "tc32c" two k-steps chained in
    the tensor cores (the second on the first's result), then two-sum."""
    if mode == "f64":
        return x @ w
    if mode == "f32":
        return (x.astype(np.float32) @ w.astype(np.float32)).astype(
            np.float64)
    k = {"tc8": 8, "tc32c": 32}.get(mode, 16)
    if w.ndim == 2:
        return tc_matmul(x, w, k, {"exact16": "exact", "tc16c": "compensated",
                                   "tc32c": "compensated"}.get(mode, "tc"))
    # One weight matrix a leading index (the attention's keys and values).
    lead = x.shape[:-2]
    xs, ws = x.reshape(-1, *x.shape[-2:]), w.reshape(-1, *w.shape[-2:])
    return np.stack([_matmul(a, b, mode) for a, b in zip(xs, ws)]).reshape(
        *lead, x.shape[-2], w.shape[-1])


def _round32(x, arith):
    return x if arith["mm"] == "f64" else rn32(x)



def _softmax(s, nk, D, arith):
    """The attention's probabilities, bf16, from the logits s [..., q, 32]
    (keys past ``nk`` masked), in ``arith``'s scale and softmax."""
    s = s.copy()
    if arith["scale"] == "f64":
        s = s / math.sqrt(D)
    elif arith["scale"] == "reciprocal":
        s = rn32(s * rn32(1.0 / rn32(math.sqrt(D))))
    else:
        s = rn32(s / rn32(math.sqrt(D)))
    s[..., nk:] = -np.inf
    x = s - s.max(-1, keepdims=True)
    if arith["softmax"] == "f64":
        e = np.exp(x)
        return bf16(e / e.sum(-1, keepdims=True))
    x = rn32(x)
    e = rn32(np.exp2(rn32(x * LOG2E))) if arith["softmax"] == "fast" \
        else rn32(np.exp(x))
    # A quad's lanes: lane t sums keys 16·kc + 8·nt + 2t + {0, 1} in
    # pairs, then two butterfly adds.
    lanes = []
    for t in range(4):
        acc = np.zeros(e.shape[:-1])
        for kc in range(2):
            for nt in range(2):
                j = 16 * kc + 8 * nt + 2 * t
                acc = rn32(acc + rn32(e[..., j] + e[..., j + 1]))
        lanes.append(acc)
    total = rn32(rn32(lanes[0] + lanes[1]) + rn32(lanes[2] + lanes[3]))
    if arith["softmax"] == "fast":
        return bf16(rn32(e * rn32(1.0 / total)[..., None]))
    return bf16(rn32(e / total[..., None]))


def gnn_emulated(d0, d1, W, E, arith, trace=None, record=None, cut=None):
    """Scores [N, T0, T1] of the GNN in the arithmetic ``arith`` (KERNEL,
    FLOAT64 or a variant of KERNEL), at the pack's padded width with the
    kernel's layout: the same bf16 rounding points as ``gnn_scores_plain``
    (``FLOAT64`` is its float64 evaluation). With ``trace`` (a ``record``
    of another run), each stage takes that run's inputs, and ``record``
    collects every stage's output by block. With ``cut``, returns also the
    scores after the first ``cut`` blocks (the pack cut to that depth, its
    final projection shared), from the same run."""
    N, T0, _ = d0.shape
    T1 = d1.shape[1]
    Ep = W["bf"].shape[-1]
    Dp, D, L = Ep // 4, E // 4, W["wqkv"].shape[0]
    R = T0 + T1
    res = np.zeros((N, R, Ep))
    res[..., :E] = np.concatenate([d0, d1], 1)
    mm = lambda x, w: _matmul(x, w, arith["mm"])
    r32 = lambda x: _round32(x, arith)

    def stage(name, l, fn, *inputs):
        if trace is not None:
            inputs = trace[(name, l)][0]
        out = fn(*inputs)
        if record is not None:
            record[(name, l)] = (inputs, out)
        return out

    sets = ((slice(0, T0), slice(T0, R)), (slice(T0, R), slice(0, T0)))
    scores = lambda res: _final_scores(res, W, E, T0, arith)
    for l in range(L):
        a = bf16(res)
        qkv = stage("qkv", l, lambda a: bf16(r32(mm(a, W["wqkv"][l])
                                                 + W["bqkv"][l])), a)

        def attend(qkv):
            msg = np.zeros((N, R, Ep))
            for h in range(4):
                q, k, v = (qkv[..., o + h * Dp:o + (h + 1) * Dp]
                           for o in (0, Ep, 2 * Ep))
                for own, other in sets:
                    src = other if l % 2 else own
                    ks, vs = k[:, src], v[:, src]
                    nk = ks.shape[1]
                    kp = np.zeros((N, 32, Dp))
                    kp[:, :nk] = ks
                    vp = np.zeros((N, 32, Dp))
                    vp[:, :nk] = vs
                    s = mm(q[:, own], kp.transpose(0, 2, 1))
                    p = _softmax(s, nk, D, arith)
                    msg[:, own, h * Dp:(h + 1) * Dp] = bf16(mm(p, vp))
            return msg

        msg = stage("msg", l, attend, qkv)
        m = stage("m", l, lambda msg: bf16(r32(mm(msg, W["wm"][l])
                                               + W["bm"][l])), msg)

        def ffn(a, m):
            h = mm(np.concatenate([a, m], -1), W["w0"][l])
            s0 = np.where(np.arange(R)[:, None] >= T0, W["s0"][l, 1],
                          W["s0"][l, 0])
            t0 = np.where(np.arange(R)[:, None] >= T0, W["t0"][l, 1],
                          W["t0"][l, 0])
            return bf16(np.maximum(r32(r32(h * s0) + t0), 0.0))

        h1 = stage("h1", l, ffn, a, m)
        upd = stage("upd", l, lambda h1: bf16(r32(mm(h1, W["w1"][l])
                                                  + W["b1"][l])), h1)
        res = r32(res + upd)
        if l + 1 == cut:
            cut_scores = scores(res)
    return scores(res) if cut is None else (scores(res), cut_scores)


def _final_scores(res, W, E, T0, arith):
    """The final projection of the residual ``res`` [N, T0 + T1, Ep] and
    the score matrix scaled by 1/sqrt(E), in ``arith``."""
    r32 = lambda x: _round32(x, arith)
    md = bf16(r32(_matmul(bf16(res), W["wf"], arith["mm"]) + W["bf"]))
    if arith["mm"] == "f64":
        return md[:, :T0] @ md[:, T0:].transpose(0, 2, 1) / math.sqrt(E)
    dot = np.zeros((res.shape[0], T0, res.shape[1] - T0))
    for c in range(res.shape[2]):               # fmaf, channel by channel
        dot = rn32(md[:, :T0, None, c] * md[:, None, T0:, c] + dot)
    return rn32(dot / rn32(math.sqrt(E)))


PLAIN_F32 = {"mm": "f32", "scale": "divide", "softmax": "exact"}
VARIANTS = {
    "the route (rounded k-step adds)": KERNEL,
    "(a) k-step sums exact": dict(KERNEL, mm="exact16"),
    "(a) k-steps of 8 on the tensor cores": dict(KERNEL, mm="tc8"),
    "(b) logits divided": dict(KERNEL, scale="divide"),
    "(c) expf, a division an element": dict(KERNEL, softmax="exact"),
    "two-sum k-step adds": TWO_SUM,
    "two k-steps chained in the tensor cores, then two-sum":
        dict(KERNEL, mm="tc32c"),
    "plain f32 (numpy's f32 products)": PLAIN_F32,
}


def _descriptors(N, T0, T1, E, seed):
    rng = np.random.default_rng(seed)
    out = []
    for T in (T0, T1):
        x = rng.standard_normal((N, T, E))
        out.append(rn32(x / np.linalg.norm(x, axis=-1, keepdims=True)))
    return out


def local_flips(E=300, T0=16, T1=6, N=16, L=2, seed=0):
    """{variant: {stage: flips per million values}}: each stage of each
    block fed the float64 evaluation's inputs, its bf16 outputs against the
    float64 evaluation's."""
    packed = tgnn.pack_gnn_params(tgnn.random_folded_params(L, seed, E),
                                  torch.bfloat16, "cpu")
    W = padded_weights(packed)
    d0, d1 = _descriptors(N, T0, T1, E, seed)
    ref = {}
    gnn_emulated(d0, d1, W, E, FLOAT64, record=ref)
    out = {}
    for name, arith in VARIANTS.items():
        rec = {}
        gnn_emulated(d0, d1, W, E, arith, trace=ref, record=rec)
        flips = {}
        for (stage, l), (_, got) in rec.items():
            want = ref[(stage, l)][1]
            n, f = flips.get(stage, (0, 0))
            flips[stage] = (n + want.size, f + int((got != want).sum()))
        out[name] = {k: 1e6 * f / n for k, (n, f) in flips.items()}
    return out


def depth_errors(E=300, T0=16, T1=6, N=8, L=12, seed=0):
    """{variant: per-pair largest score error} at full depth against the
    float64 evaluation, over GNN_REL_TOL (1% of its largest score); the
    plain version (``gnn_scores_plain`` in f32) beside them."""
    packed = tgnn.pack_gnn_params(tgnn.random_folded_params(L, seed, E),
                                  torch.bfloat16, "cpu")
    W = padded_weights(packed)
    d0, d1 = _descriptors(N, T0, T1, E, seed)
    t0, t1 = torch.tensor(d0).float(), torch.tensor(d1).float()
    ref = tgnn.gnn_scores_plain(t0, t1, packed, acc=torch.float64).numpy()
    tol = 1e-2 * np.abs(ref).max()
    outs = {"gnn_scores_plain f32": tgnn.gnn_scores_plain(t0, t1, packed)
            .double().numpy()}
    for name, arith in VARIANTS.items():
        outs[name] = gnn_emulated(d0, d1, W, E, arith)
    return {k: np.abs(v - ref).max((1, 2)) / tol for k, v in outs.items()}


# ---------------------------------------------------------------------------
# Tests.
# ---------------------------------------------------------------------------

PROBE_CASES = [f"{kind} spread 2^{spread} c 0"
               for kind, spreads in (("bf16 k16", (0, 3, 6)),
                                     ("bf16 k8", (0, 3, 6)),
                                     ("tf32 k8", (0, 3)))
               for spread in spreads] + [
    f"{kind} spread 2^3 c random" for kind in ("bf16 k16", "bf16 k8",
                                              "tf32 k8")]


@pytest.mark.parametrize("case", PROBE_CASES)
def test_tc_sum_matches_the_card_bit_for_bit(case):
    """c + a·b of one ``mma`` a tile (a [16, k], b [k, 8]) as the card
    computed it (scripts/probe_mma_rounding.py): every output equal, no
    tolerance."""
    probe = np.load(PROBE)
    a, b, c, got = (probe[f"{case}|{i}"].astype(np.float64) for i in range(4))
    block = TC_BLOCK["bf16"] if "k16" in case else 8
    emu = tc_sum(a[:, :, None, :], b.transpose(0, 2, 1)[:, None], block, c)
    assert np.array_equal(emu, got)


def _bench_lstm(n, direction):
    """Tables, W_hh, tokens, lengths of the card test's text (its first n
    queries), one direction, as float64 arrays of f32 values."""
    from test_torch_port_kernels_wide import _bench_text

    tables, w_hh, tokens, lengths = _bench_text()
    return (tables[direction].double().numpy(),
            w_hh[direction].double().numpy(),
            tokens[:n].numpy().astype(np.int64),
            lengths[:n].numpy().astype(np.int64))


@pytest.mark.parametrize("direction", [0, 1])
def test_lstm_l2_arithmetic_holds_float64(direction):
    """The L2 form's arithmetic (W_hh zero-padded from 256 to 300 units, the
    kernel's width 320) on 8 queries: within 2e-5 of the plain recurrence
    in float64, as JAX's f32 recurrence is (on the KITTI360 text the card
    read 1.284e-5 for the shared form's identical arithmetic and 8.1e-6 for
    the plain f32 version); the earlier arithmetic at least 5x farther
    (the card read 1.396e-4 there). The "truncated" arm emulates that
    earlier arithmetic, which ``csrc/lstm.cu`` no longer has (both forms
    round both parts since the L2 form's repair): it stays as the record
    of what the repair removed."""
    table, w, tokens, lengths = _bench_lstm(8, direction)
    T = tokens.shape[1]
    valid = np.arange(T)[None] < lengths[:, None]
    x = table[np.where(valid, tokens, 0).T]                  # [T, B, 4H]
    ref = tlstm.lstm_recurrence_plain(
        torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(lengths),
        direction == 1).numpy()
    order = slice(None, None, -1 if direction else 1)
    jh, _ = _lstm_scan(jnp.asarray(x[order], jnp.float32),
                       JLSTMParams(None, jnp.asarray(w, jnp.float32), None),
                       jnp.asarray(valid.T[order]))
    Hp = tlstm.kernel_width(300)
    tp = tlstm.pad_gates(torch.as_tensor(table), 256, Hp).numpy()
    wp = tlstm.pad_w_hh(torch.as_tensor(w), 256, Hp).numpy()
    err = {ar: float(np.abs(lstm_emulated(tp, wp, tokens, lengths, ar,
                                          direction == 1)[:, :256]
                            - ref).max())
           for ar in ("rounded", "truncated")}
    jax_err = float(np.abs(np.asarray(jh, np.float64) - ref).max())
    assert err["rounded"] <= 2e-5, err
    assert jax_err <= 2e-5, jax_err
    assert err["truncated"] >= 5 * err["rounded"], err


@pytest.mark.parametrize("seed", [0, 1])
def test_gnn_tc_arithmetic_no_farther_than_plain(seed):
    """The route's arithmetic (KERNEL) at E = 64, 3 blocks, 128 pairs of
    (16, 6): its per-pair score errors against the float64 evaluation
    (``gnn_scores_plain(..., acc=torch.float64)``) no larger than the plain
    f32 version's, in their mean and their largest (no tolerance: a flipped
    bf16 rounding moves a pair by up to a few tenths of 1% of the largest
    score, and both sides flip some)."""
    E, L, N = 64, 3, 128
    packed = tgnn.pack_gnn_params(tgnn.random_folded_params(L, seed, E),
                                  torch.bfloat16, "cpu")
    d0, d1 = _descriptors(N, 16, 6, E, seed)
    t0, t1 = torch.tensor(d0).float(), torch.tensor(d1).float()
    ref = tgnn.gnn_scores_plain(t0, t1, packed, acc=torch.float64).numpy()
    plain = tgnn.gnn_scores_plain(t0, t1, packed).double().numpy()
    got = gnn_emulated(d0, d1, padded_weights(packed), E, KERNEL)
    assert got.shape == (N, 16, 6) and np.isfinite(got).all()
    err = np.abs(got - ref).max((1, 2))
    plain_err = np.abs(plain - ref).max((1, 2))
    assert err.mean() <= plain_err.mean(), (err.mean(), plain_err.mean())
    assert err.max() <= plain_err.max(), (err.max(), plain_err.max())


if __name__ == "__main__":
    print("bf16 roundings flipped per million against the float64 "
          "evaluation, each stage fed its inputs (E = 300, 64 pairs, "
          "2 blocks):")
    for name, flips in local_flips(N=64).items():
        print(f"  {name}: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in flips.items()))
    print("per-pair score error over GNN_REL_TOL at 12 blocks (16 pairs):")
    for name, err in depth_errors(N=16).items():
        print(f"  {name}: median {np.median(err):.4f}, largest "
              f"{err.max():.4f}")
