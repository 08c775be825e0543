"""A float64 reference of the port's plain (CPU) path.

The model code pins float32 where the JAX package does (``torch.float32``,
``Tensor.float()``: BN statistics, the bias-ReLU chains, the point
preparation), so ``module.double()`` alone still rounds to f32 there.
``float64_pins()`` makes those names mean float64 for the block, and the
default dtype with them: a model moved to float64 then computes the same
function as in f32 with every value kept in f64. An f32 step (the kernels on
the card, or the plain path) is held against it to see its own rounding;
the JAX package's float32 step can be held against it the same way. The
float64 form is tied to the JAX package's by
``tests/test_torch_port_train_{coarse,fine}.py`` (JAX with ``jax_enable_x64``
and its own pins widened the same way).

    with float64_pins():
        model.double()
        loss = trainer.forward_backward(state, batch, draws=draws)

CPU tensors only: the CUDA kernels take float32 and raise otherwise.

``Decisions`` records the piecewise choices of an f32 step and replays
them in the float64 step, so that the two are compared on the same piece
of a piecewise-linear loss.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator

import torch


@contextlib.contextmanager
def float64_pins() -> Iterator[None]:
    f32, to_float = torch.float32, torch.Tensor.float
    default = torch.get_default_dtype()
    torch.float32 = torch.float64
    torch.Tensor.float = torch.Tensor.double
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.float32 = f32
        torch.Tensor.float = to_float
        torch.set_default_dtype(default)


class Decisions:
    """The piecewise choices of a training step, in call order: the sign of
    each ReLU's input, the maximizers of each max (``Tensor.amax``), FPS's
    indices, the ball queries' neighbours and EdgeConv's kNN graphs.
    ``record()`` keeps a run's; ``replay()`` imposes them on a second run of
    the same step, so that the two are compared on the same piece of the
    loss: a ReLU input or a max within rounding of a tie may fall either
    way, and the gradient jumps with it. The replay counts the ReLU and max
    choices the second run would have made otherwise (``flips``) and the
    largest margin by which it would have (``margin``, relative to the
    largest magnitude in that tensor): a flip is a near-tie only where that
    margin is small."""

    def __init__(self):
        self.log, self.flips, self.margin = [], 0, 0.0

    @staticmethod
    @contextlib.contextmanager
    def _patched(relu, amax, fps, levels, ball, knn):
        import text2pos_torch.models.cell_retrieval as cr
        import text2pos_torch.models.pointnet2 as pn

        saved = (torch.relu, torch.Tensor.amax, pn.farthest_point_sampling,
                 pn.farthest_point_sampling_levels, pn.ball_neighbors,
                 cr.masked_knn)
        torch.relu, torch.Tensor.amax = relu, amax
        pn.farthest_point_sampling, pn.ball_neighbors = fps, ball
        pn.farthest_point_sampling_levels, cr.masked_knn = levels, knn
        try:
            yield
        finally:
            (torch.relu, torch.Tensor.amax, pn.farthest_point_sampling,
             pn.farthest_point_sampling_levels, pn.ball_neighbors,
             cr.masked_knn) = saved

    def record(self):
        import text2pos_torch.models.cell_retrieval as cr
        import text2pos_torch.models.pointnet2 as pn

        relu, amax = torch.relu, torch.Tensor.amax
        fps, ball = pn.farthest_point_sampling, pn.ball_neighbors
        levels, knn = pn.farthest_point_sampling_levels, cr.masked_knn

        def rec_relu(x):
            self.log.append(("relu", x.detach() > 0))
            return relu(x)

        def rec_amax(x, dim=(), keepdim=False):
            m = amax(x, dim, keepdim=True)
            self.log.append(("amax", x.detach() == m.detach()))
            return m if keepdim else m.squeeze(dim)

        def rec_fps(pos, n):
            idx, cent = fps(pos, n)
            self.log.append(("fps", idx))
            return idx, cent

        def rec_levels(pos, ratios):
            out = levels(pos, ratios)
            self.log.extend(("fps", idx) for idx, _ in out)
            return out

        def rec_ball(*a):
            out = ball(*a)
            self.log.append(("ball", out))
            return out

        def rec_knn(*a):
            out = knn(*a)
            self.log.append(("knn", out))
            return out
        return self._patched(rec_relu, rec_amax, rec_fps, rec_levels,
                             rec_ball, rec_knn)

    def _next(self, kind, shape=None):
        k, v = self.log[self._i]
        self._i += 1
        if k != kind or (shape is not None and tuple(v.shape) != shape):
            raise RuntimeError(f"replayed decision {self._i}: {k} where the "
                               f"run asks for {kind} {shape}")
        return v

    def _flip(self, where, gap, x):
        n = int(where.sum())
        if n:
            real = x.abs()[x.abs() < 1e29]         # not masked_max's fill
            self.flips += n
            self.margin = max(self.margin, float(gap[where].max())
                              / float(real.max()))

    def replay(self):
        amax = torch.Tensor.amax
        self._i = 0
        zero = lambda x: torch.zeros((), dtype=x.dtype)

        def rep_relu(x):
            mask = self._next("relu", tuple(x.shape))
            self._flip((x > 0) != mask, x.detach().abs(), x.detach())
            return torch.where(mask, x, zero(x))

        def rep_amax(x, dim=(), keepdim=False):
            mask = self._next("amax", tuple(x.shape))
            xd = x.detach()
            own = amax(xd, dim, keepdim=True)
            chosen = amax(torch.where(mask, xd, torch.full(
                (), -math.inf, dtype=x.dtype)), dim, keepdim=True)
            self._flip((xd == own) != mask, (own - chosen).expand_as(xd), xd)
            m = (torch.where(mask, x, zero(x)).sum(dim, keepdim=True)
                 / mask.sum(dim, keepdim=True))
            return m if keepdim else m.squeeze(dim)

        def rep_fps(pos, n):
            idx = self._next("fps")
            return idx, torch.gather(pos, 1, idx[..., None].expand(
                *idx.shape, 3))

        def rep_levels(pos, ratios):
            out = []
            for _ in ratios:
                out.append(rep_fps(pos, None))
                pos = out[-1][1]
            return out

        def rep_ball(*a):
            return self._next("ball")

        def rep_knn(*a):
            return self._next("knn")
        return self._patched(rep_relu, rep_amax, rep_fps, rep_levels,
                             rep_ball, rep_knn)
