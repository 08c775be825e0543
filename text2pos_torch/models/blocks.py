"""Building blocks (counterpart of ``text2pos_tpu/models/blocks.py``).
In eval mode BatchNorm reads its running statistics, or with
``eval_batch_stats`` normalizes by the batch's own (the JAX fine model's
default); ``calibrating`` makes the batch-statistics BNs of a module write
what they compute into their running statistics, as an eval forward of the
JAX model with a mutable ``batch_stats`` collection does. In train mode
(``train_mode``: JAX's ``train=True``) every BN normalizes by the batch's
statistics and moves its running statistics towards them by momentum 0.1,
the variance unbiased; the port never runs an initializing forward, so
nothing updates while weights are made (JAX's ``is_initializing``).

Module and attribute names follow the flax parameter tree (``dense_0``,
``bn_0``, …) so that ``utils/convert_jax.py`` maps a checkpoint by name.
``dense`` applies a flax ``nn.Dense(dtype=...)`` the way XLA compiles it,
which keeps f32 between matmuls ("excess precision"): callers round to the
compute dtype only where XLA stores a value (a matmul's input, a module's
output).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence, Tuple

import torch
from torch import nn


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12
                 ) -> torch.Tensor:
    """``x / max(||x||, eps)`` (torch ``F.normalize``). In bf16 the sum of
    squares and the norm are each rounded to bf16, as the JAX package's
    compiled ``l2_normalize`` stores them."""
    if x.dtype != torch.bfloat16:
        return x / torch.linalg.vector_norm(x, dim=dim,
                                            keepdim=True).clamp_min(eps)
    sq = (x.float() * x.float()).sum(dim, keepdim=True).to(x.dtype)
    norm = torch.sqrt(sq.float()).to(x.dtype).float()
    return (x.float() / norm.clamp_min(eps)).to(x.dtype)


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``nn.Dense(dtype)`` as XLA's CPU backend runs it, returned in f32:
    input and kernel in ``dtype`` (f32 when None), the product rounded to
    ``dtype``, the bias (in ``dtype``) added in f32. XLA fuses the bias add
    into the elementwise ops that follow (BN, ReLU, a residual add) and
    computes that chain in f32, rounding only where a value is stored.
    Measured on a bf16 set-abstraction level: 3e-5 of the outputs differ
    from the JAX package's by a bf16 step, against 0.19-0.41 when every
    flax op rounds."""
    dt = dtype or torch.float32
    y = nn.functional.linear(x.to(dt), layer.weight.to(dt)).float()
    return y + layer.bias.to(dt).float()


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the last axis with ``stat_groups`` rows of running
    statistics; ``stat_group`` picks the row. Computed in f32, returned in
    the input dtype (eps 1e-5).

    With ``eval_batch_stats`` (``set_eval_batch_stats``) it normalizes by the
    batch's statistics: the mean and biased variance over every row (the
    rows where ``mask`` is true, when given) in f32; the running statistics
    are left alone unless ``calibrate`` is set (``calibrating``), which
    overwrites the ``stat_group`` row with them, no momentum (JAX's
    one-shot calibration). With ``train_stats`` (``train_mode``) it
    normalizes by the same statistics and updates the row as
    ``(1 - momentum)·old + momentum·batch``, the variance made unbiased by
    ``n / max(n - 1, 1)`` over the n rows counted. ``hold_stats``
(``checkpointed``'s recompute) keeps the running statistics as they are
whatever the mode."""

    def __init__(self, features: int, stat_groups: int = 1,
                 eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.stat_groups = stat_groups
        self.eps = eps
        self.momentum = momentum
        self.eval_batch_stats = False
        self.train_stats = False
        self.calibrate = False
        self.hold_stats = False
        shape = (features,) if stat_groups == 1 else (stat_groups, features)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(shape))
        self.register_buffer("running_var", torch.ones(shape))

    def batch_stats(self, x: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, stat_group: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, biased variance) [C] f32 over the rows of x [..., C]
        where ``mask`` (x's leading shape) holds; with ``calibrate`` they
        are also written into the running statistics' ``stat_group``
        row."""
        xf = x.float().flatten(0, -2)
        if mask is None:
            # A Python count: a tensor made from it would be a host copy.
            count = float(xf.shape[0])
            mean = xf.mean(0)
            var = ((xf - mean) ** 2).mean(0)
        else:
            m = mask.reshape(-1, 1).float()
            count = m.sum().clamp_min(1.0)
            mean = (xf * m).sum(0) / count
            var = (((xf - mean) ** 2) * m).sum(0) / count
        if (self.calibrate or self.train_stats) and not self.hold_stats:
            with torch.no_grad():
                rows = ((self.running_mean, self.running_var)
                        if self.stat_groups == 1 else
                        (self.running_mean[stat_group],
                         self.running_var[stat_group]))
                if self.train_stats:
                    unbiased = var * count / (
                        max(count - 1.0, 1.0) if mask is None
                        else (count - 1.0).clamp_min(1.0))
                    new = [(1 - self.momentum) * old + self.momentum * b
                           for old, b in zip(rows, (mean, unbiased))]
                else:
                    new = (mean, var)
                for old, b in zip(rows, new):
                    old.copy_(b)
        return mean, var

    def forward(self, x: torch.Tensor, stat_group: int = 0,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.eval_batch_stats or self.train_stats:
            mean, var = self.batch_stats(x, mask, stat_group)
        else:
            mean, var = self.running_mean, self.running_var
            if self.stat_groups > 1:
                mean, var = mean[stat_group], var[stat_group]
        inv = 1.0 / torch.sqrt(var + self.eps)
        out = (x.float() - mean) * inv * self.weight + self.bias
        return out.to(x.dtype)


def set_eval_batch_stats(module: nn.Module, on: bool) -> nn.Module:
    """Switch every BN of ``module`` to batch statistics (on) or to its
    running statistics (off), as JAX clones a model with
    ``eval_batch_stats``; so are the modules that run a kernel only in eval
    mode (``SetAbstraction``, ``SuperGlue``: they carry the same flag).
    Returns ``module``."""
    for m in module.modules():
        if hasattr(m, "eval_batch_stats"):
            m.eval_batch_stats = on
    return module


@contextlib.contextmanager
def train_mode(module: nn.Module, on: bool = True) -> Iterator[nn.Module]:
    """Within the block, every BN of ``module`` runs in train mode (``on``)
    or not, and so do the modules that run a kernel only in eval mode
    (``SetAbstraction``, ``SuperGlue``: they carry the same flag); on exit
    each flag is restored."""
    mods = [m for m in module.modules() if hasattr(m, "train_stats")]
    before = [m.train_stats for m in mods]
    for m in mods:
        m.train_stats = on
    try:
        yield module
    finally:
        for m, b in zip(mods, before):
            m.train_stats = b


@contextlib.contextmanager
def calibrating(module: nn.Module) -> Iterator[nn.Module]:
    """Within the block, each batch-statistics BN of ``module`` overwrites
    its running statistics, in place, with the statistics of the batch it
    sees (a cached fold of them keyed by ``weights_key`` is then stale)."""
    bns = [m for m in module.modules() if isinstance(m, MaskedBatchNorm)]
    for bn in bns:
        bn.calibrate = True
    try:
        yield module
    finally:
        for bn in bns:
            bn.calibrate = False


def checkpointed(module: nn.Module, *args) -> torch.Tensor:
    """``module(*args)`` with its activations recomputed in the backward
    pass instead of kept (``torch.utils.checkpoint``, non-reentrant): JAX's
    ``nn.remat``. The recompute runs with the modes the forward ran in
    (``train_mode``'s flags and ``eval_batch_stats``, which the forward's
    ``train_mode`` block has restored by then), and with every BN's running
    statistics held (``hold_stats``), so that they move once a step, as
    under ``nn.remat``."""
    from torch.utils.checkpoint import checkpoint

    flags = [(m, m.train_stats, getattr(m, "eval_batch_stats", None))
             for m in module.modules() if hasattr(m, "train_stats")]

    @contextlib.contextmanager
    def recompute():
        before = [(m, m.train_stats, getattr(m, "eval_batch_stats", None),
                   getattr(m, "hold_stats", None)) for m, _, _ in flags]
        for m, train, ebs in flags:
            m.train_stats = train
            if ebs is not None:
                m.eval_batch_stats = ebs
            if isinstance(m, MaskedBatchNorm):
                m.hold_stats = True
        try:
            yield
        finally:
            for m, train, ebs, hold in before:
                m.train_stats = train
                if ebs is not None:
                    m.eval_batch_stats = ebs
                if hold is not None:
                    m.hold_stats = hold

    return checkpoint(module, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          recompute()))


def tensor_slots(module: nn.Module) -> list:
    """(dict, name) of every parameter and buffer of ``module``: looked up
    anew at each ``weights_key``, they follow ``module.to`` and
    ``load_state_dict`` without walking the module tree again."""
    return [(m._parameters if kind == 0 else m._buffers, n)
            for kind in (0, 1) for m in module.modules()
            for n, t in (m._parameters if kind == 0 else m._buffers).items()
            if t is not None]


def weights_key(slots) -> tuple:
    """What a cache of values derived from the tensors at ``slots``
    (``tensor_slots``) is valid for: their storage and ``_version`` counters
    (an in-place update, such as ``optimizer.step()``, ``load_state_dict``
    or a BN statistics write, bumps the counter; moving the module changes
    the storage). Inference tensors keep no counter; they cannot be updated
    in place outside ``torch.inference_mode``."""
    out = []
    for d, n in slots:
        t = d[n]
        out.append((t.data_ptr(), None if t.is_inference() else t._version))
    return tuple(out)

def bn_affine(bn: MaskedBatchNorm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BN as ``x·scale + shift`` (f32): scale = γ/√(σ²+ε),
    shift = β − μ·scale."""
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return scale, bn.bias - bn.running_mean * scale


class MLP(nn.Module):
    """``get_mlp``: (Dense → BN → ReLU) per layer, trailing ReLU included.
    Each chain of bias, BN and ReLU runs in f32 (``dense``); the output is
    stored in ``dtype`` (f32 when None)."""

    def __init__(self, in_features: int, channels: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.n = len(channels)
        for i, ch in enumerate(channels):
            self.add_module(f"dense_{i}", nn.Linear(in_features, ch))
            self.add_module(f"bn_{i}", MaskedBatchNorm(ch))
            in_features = ch

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.n):
            x = dense(getattr(self, f"dense_{i}"), x, self.dtype)
            x = torch.relu(getattr(self, f"bn_{i}")(x, mask=mask))
        return x.to(self.dtype or torch.float32)


class HeadMLP(nn.Module):
    """Dense layers with ReLU between, bare final layer (offset head)."""

    def __init__(self, in_features: int, channels: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.n = len(channels)
        for i, ch in enumerate(channels):
            self.add_module(f"dense_{i}", nn.Linear(in_features, ch))
            in_features = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = dense(getattr(self, f"dense_{i}"), x, self.dtype)
            if i < self.n - 1:
                x = torch.relu(x)
        return x.to(self.dtype or torch.float32)


class SuperGlueMLP(nn.Module):
    """Dense → BN → ReLU between layers only, bare final layer. The output
    stays f32: XLA fuses the final bias add into the residual add."""

    def __init__(self, in_features: int, channels: Sequence[int],
                 dtype: Optional[torch.dtype] = None, stat_groups: int = 1):
        super().__init__()
        self.dtype = dtype
        self.n = len(channels)
        for i, ch in enumerate(channels):
            self.add_module(f"dense_{i}", nn.Linear(in_features, ch))
            if i < self.n - 1:
                self.add_module(f"bn_{i}", MaskedBatchNorm(ch, stat_groups))
            in_features = ch

    def forward(self, x: torch.Tensor, stat_group: int = 0) -> torch.Tensor:
        for i in range(self.n):
            x = dense(getattr(self, f"dense_{i}"), x, self.dtype)
            if i < self.n - 1:
                x = torch.relu(getattr(self, f"bn_{i}")(x, stat_group))
        return x


class DenseParams(nn.Linear):
    """An ``nn.Linear`` whose owner fuses it with others instead of applying
    it (JAX's ``DenseParams``: ``nn.Dense``'s parameter tree, not applied):
    calling it returns ``(kernel [in, out], bias)``. Its state and its JAX
    tree are ``nn.Linear``'s, so a checkpoint loads into either form."""

    def forward(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.weight.t(), self.bias


class FastSuperGlueMLP(SuperGlueMLP):
    """Concat-free ``SuperGlueMLP((2E, E))`` of the fast graph (JAX's
    ``FastSuperGlueMLP``): ``x·W0[:E] + msg·W0[E:] + b0`` instead of
    ``dense_0(concat([x, msg]))``, two K=E products summed in f32 instead of
    one K=2E product, each rounded to the compute dtype. The same
    parameters as ``SuperGlueMLP`` (``dense_0``, ``bn_0``, ``dense_1``)."""

    def __init__(self, feature_dim: int, dtype: Optional[torch.dtype] = None,
                 stat_groups: int = 1):
        super().__init__(2 * feature_dim, (2 * feature_dim, feature_dim),
                         dtype, stat_groups)
        self.dense_0 = DenseParams(2 * feature_dim, 2 * feature_dim)
        self.feature_dim = feature_dim

    def forward(self, x: torch.Tensor, msg: torch.Tensor,
                stat_group: int = 0) -> torch.Tensor:
        E, dt = self.feature_dim, self.dtype or torch.float32
        k0, b0 = self.dense_0()
        k0 = k0.to(dt)
        h = ((x.to(dt) @ k0[:E]).float() + (msg.to(dt) @ k0[E:]).float()
             + b0.to(dt).float())
        h = torch.relu(self.bn_0(h, stat_group))
        return dense(self.dense_1, h, self.dtype)

