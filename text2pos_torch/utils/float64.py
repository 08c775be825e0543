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
"""

from __future__ import annotations

import contextlib
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
