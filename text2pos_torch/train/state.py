"""Train state, the optimizer and checkpoints (counterpart of
``text2pos_tpu/train/state.py``).

``TrainState`` holds the model (parameters and BN running statistics), the
optimizer and the step count. ``OptaxAdam`` is ``optax.adam`` step for step
(b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias correction by
the step count, the learning rate a schedule of the count), with
``optax.multi_transform``'s frozen group (zero updates, no moments) for
``freeze_paths``. Checkpoints are flax msgpack files in the JAX package's
layout: ``params`` and ``batch_stats`` trees (``utils/convert_jax.py``
maps the names), ``extra`` metadata, and for a resume file ``opt_state``
as ``flax.serialization.to_state_dict`` writes optax's state (Adam's
``count``/``mu``/``nu`` under ``"0"``, the schedule's ``count`` under
``"1"``, both under ``inner_states/train/inner_state`` when freezing), so
each package resumes the other's runs.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from text2pos_torch.models.blocks import MaskedBatchNorm
from text2pos_torch.utils.convert_jax import (jax_to_params, load_jax_params,
                                              module_to_jax, param_paths,
                                              params_to_jax)
from text2pos_torch.utils.msgpack_io import msgpack_restore, msgpack_serialize

Schedule = Callable[[int], float]


def constant_schedule(learning_rate: float) -> Schedule:
    return lambda count: float(np.float32(learning_rate))


def epoch_decay_schedule(learning_rate: float, lr_gamma: float,
                         steps_per_epoch: int) -> Schedule:
    """``learning_rate · lr_gamma^(count // steps_per_epoch)`` in f32, as
    ``text2pos_tpu/train/state.py``'s ``make_optimizer`` computes it."""
    def sched(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        return float(np.float32(learning_rate)
                     * np.float32(lr_gamma) ** np.float32(epoch))
    return sched


class OptaxAdam(torch.optim.Optimizer):
    """``optax.adam(schedule)``, optionally inside ``multi_transform`` with a
    frozen group (``frozen``: parameter names). Parameters whose gradient
    is None take a zero gradient, as JAX's are for unused leaves.

    ``schedule_state``: whether optax keeps a schedule count (a callable
    learning rate), which only changes the checkpoint layout.
    """

    def __init__(self, named_params: Sequence[Tuple[str, nn.Parameter]],
                 schedule: Schedule, schedule_state: bool,
                 frozen: Sequence[str] = (), b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        frozen = set(frozen)
        train = [(n, p) for n, p in named_params if n not in frozen]
        groups = [{"params": [p for _, p in train], "frozen": False}]
        if frozen:
            groups.append({"params": [p for n, p in named_params
                                      if n in frozen], "frozen": True})
        super().__init__(groups, {"b1": b1, "b2": b2, "eps": eps})
        self.names = {p: n for n, p in named_params}
        self.schedule, self.schedule_state = schedule, schedule_state
        self.freezing = bool(frozen)
        self.count = 0           # Adam's (and the schedule's) step count
        for p in groups[0]["params"]:
            self.state[p] = {"mu": torch.zeros_like(p),
                             "nu": torch.zeros_like(p)}

    @torch.no_grad()
    def step(self, closure=None):
        group = self.param_groups[0]
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        params = group["params"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        mu = [self.state[p]["mu"] for p in params]
        nu = [self.state[p]["nu"] for p in params]
        # mu = (1-b1)·g + b1·mu; nu = (1-b2)·g² + b2·nu (optax's order).
        g1 = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g1)
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        # update = -lr · (mu / bc1) / (sqrt(nu / bc2) + eps)
        upd = torch._foreach_div(mu, bc1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, float(np.float32(-lr)))
        torch._foreach_add_(params, upd)

    # -- optax's state-dict layout -------------------------------------
    def to_optax(self, module: nn.Module) -> Dict:
        """``flax.serialization.to_state_dict`` of the optax state."""
        trained = self.param_groups[0]["params"]
        mu = {self.names[p]: self.state[p]["mu"] for p in trained}
        nu = {self.names[p]: self.state[p]["nu"] for p in trained}
        count = np.asarray(self.count, np.int32)
        inner = {"0": {"count": count, "mu": params_to_jax(module, mu, {}),
                       "nu": params_to_jax(module, nu, {})},
                 "1": {"count": count.copy()} if self.schedule_state else {}}
        if not self.freezing:
            return inner
        return {"inner_states": {"freeze": {"inner_state": {}},
                                 "train": {"inner_state": inner}}}

    def load_optax(self, module: nn.Module, tree: Dict) -> None:
        """Restore from ``to_optax``'s layout (either package's file)."""
        if self.freezing != ("inner_states" in tree):
            raise ValueError("resume file and optimizer disagree on frozen "
                             "parameters")
        if self.freezing:
            tree = tree["inner_states"]["train"]["inner_state"]
        adam = tree["0"]
        mu, nu = jax_to_params(module, adam["mu"]), jax_to_params(
            module, adam["nu"])
        for p in self.param_groups[0]["params"]:
            name = self.names[p]
            self.state[p]["mu"] = mu[name].to(p.device)
            self.state[p]["nu"] = nu[name].to(p.device)
        self.count = int(np.asarray(adam["count"]))


def parameter_names(module: nn.Module, freeze_paths: Sequence[str] = ()
                    ) -> Tuple[list, list]:
    """(named parameters, names of those whose JAX path, '/'-joined,
    contains one of ``freeze_paths``)."""
    paths = param_paths(module)
    named = list(module.named_parameters())
    frozen = [n for n, _ in named
              if any(fp in "/".join(paths[n][0]) for fp in freeze_paths)]
    return named, frozen


def make_optimizer(module: nn.Module, learning_rate: float,
                   lr_gamma: float = 1.0, steps_per_epoch: int = 1,
                   freeze_paths: Sequence[str] = (),
                   schedule: Optional[Schedule] = None) -> OptaxAdam:
    """Adam with per-epoch exponential decay (``lr_gamma``), or with
    ``schedule``; ``freeze_paths`` as ``text2pos_tpu``'s (e.g.
    ``("object_encoder/pointnet",)`` for ``--pointnet_freeze``)."""
    named, frozen = parameter_names(module, freeze_paths)
    if schedule is not None:
        return OptaxAdam(named, schedule, True, frozen)
    if lr_gamma == 1.0:
        return OptaxAdam(named, constant_schedule(learning_rate), False,
                         frozen)
    return OptaxAdam(named, epoch_decay_schedule(
        learning_rate, lr_gamma, steps_per_epoch), True, frozen)


@dataclass
class TrainState:
    """Model (parameters and BN running statistics), optimizer (None for
    evaluation) and the number of optimizer steps taken."""

    model: nn.Module
    optimizer: Optional[OptaxAdam] = None
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer step on the gradients in ``.grad``; clears them."""
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1


def init_parameters(module: nn.Module, seed: int) -> nn.Module:
    """Fresh weights drawn as flax initializes the JAX modules, from a
    ``torch.Generator`` seeded with ``seed``: Dense kernels LeCun-normal
    (truncated at two standard deviations), biases zero, embeddings
    N(0, 1/E), LSTM weights U(±1/√E), BN scale 1 and bias 0 with running
    statistics (0, 1), the dustbin score 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in module.named_modules():
            if isinstance(mod, nn.Linear):
                fan_in = mod.weight.shape[1]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w = torch.empty(mod.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                mod.weight.copy_(w)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                e = mod.weight.shape[1]
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen)
                                 / math.sqrt(e))
            elif isinstance(mod, MaskedBatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
            for pname, p in mod.named_parameters(recurse=False):
                if pname.startswith("lstm_"):
                    bound = 1.0 / math.sqrt(p.shape[0] if p.dim() == 2
                                            else p.shape[0] // 4)
                    p.copy_(torch.rand(p.shape, generator=gen) * 2 * bound
                            - bound)
                elif pname == "bin_score":
                    p.fill_(1.0)
    return module


def _payload(state: TrainState, extra: Optional[Dict]) -> Dict:
    params, stats = module_to_jax(state.model)
    return {"params": params, "batch_stats": stats, "extra": extra or {}}


def _write(path: str, payload: Dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(payload))
    os.replace(tmp, path)


def save_checkpoint(path: str, state: TrainState,
                    extra: Optional[Dict] = None) -> None:
    """Msgpack checkpoint: params, batch_stats and ``extra`` metadata, the
    file ``text2pos_tpu``'s ``load_checkpoint`` reads."""
    _write(path, _payload(state, extra))


def save_resume_checkpoint(path: str, state: TrainState, epoch: int,
                           best_acc: float, best_path: Optional[str],
                           extra: Optional[Dict] = None) -> None:
    """Full state (params, BN, optimizer, progress), written atomically
    (tmp + rename) so a crash mid-write never corrupts the resume point."""
    payload = _payload(state, extra)
    payload.update({
        "opt_state": state.optimizer.to_optax(state.model),
        "step": int(state.step), "epoch": int(epoch),
        "best_acc": float(best_acc), "best_path": best_path or ""})
    _write(path, payload)


def load_resume_checkpoint(path: str, state: TrainState
                           ) -> Tuple[TrainState, int, float, Optional[str]]:
    """Restore a resume file (either package's) into ``state``. Returns
    ``(state, epoch, best_acc, best_path)``, ``epoch`` the last one the
    interrupted run completed."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    load_variables(state.model, payload)
    state.optimizer.load_optax(state.model, payload["opt_state"])
    state.step = int(payload["step"])
    return (state, int(payload["epoch"]), float(payload["best_acc"]),
            payload.get("best_path") or None)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """``{"params": tree, "batch_stats": tree, "extra": dict}`` of numpy
    leaves from a flax msgpack checkpoint."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    payload.setdefault("batch_stats", {})
    payload.setdefault("extra", {})
    return payload


def restore_variables(path: str) -> Dict[str, Any]:
    """A checkpoint as ``{"params": ..., "batch_stats": ...}`` trees."""
    payload = load_checkpoint(path)
    return {"params": payload["params"], "batch_stats": payload["batch_stats"]}


def load_variables(module: nn.Module, variables: Dict[str, Any]) -> None:
    """Load ``{"params", "batch_stats"}`` trees into ``module`` (on its
    device); every leaf must be used."""
    unused = load_jax_params(module, variables["params"],
                             variables.get("batch_stats", {}))
    if unused:
        raise ValueError(f"checkpoint leaves the model does not hold: "
                         f"{unused[:5]}")
