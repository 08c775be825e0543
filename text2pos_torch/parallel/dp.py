"""Data parallelism over several devices (counterpart of
``text2pos_tpu/parallel/dp.py``).

JAX's module is single-controller: one process, a 1-D ``('dp',)`` mesh over
its devices, each program ``shard_map``-ped over it. The port keeps that
shape. One process drives a ``Mesh``, an ordered list of ``torch.device``s
(one a shard), and the collectives are plain functions over one tensor a
shard:

- ``all_gather``: the shards' tensors concatenated, on every shard's device;
- ``pmean``: their mean, taken on the first device and copied back to each;
- ``ppermute``: each shard's tensor moved to the next shard's device,
  ``devices[(i + 1) % D]``.

Devices may repeat. A mesh of D shards on one card runs them one after
another on its stream, with the results of D cards, and ``[cpu] * D`` is
how the tests run it; a copy to the device a tensor is already on is no
copy. PyTorch launches asynchronously and nothing here synchronizes, so
shards on distinct cards overlap.

What runs over a mesh, as in JAX:

- ``dp_serve_batch``: queries split over the mesh, each shard served by a
  replica of a calibrated pipeline (``serve_batch``: the LSTM, GNN and
  Sinkhorn kernels), the outputs gathered on the leading axis;
- ``dp_serve_batch_dbsharded``: queries and the map split over the mesh; a
  ring pass of retrieval keeps each query's running top-k by (score, global
  index), a second ring pass gathers the winners' fine-bank rows, then the
  cascade and the fine matching run locally;
- ``dp_encode_cells`` / ``dp_encode_all_cells``: the evaluation's DB-cell
  encode, cells split over the mesh (the FPS and PointConv kernels);
- ``dp_coarse_train_step`` (with ``global_negatives``), ``dp_fine_train_step``
  and ``dp_train_epoch``: each shard's batch runs on a replica of the model
  that starts the step from the master's parameters and BN statistics; the
  gradients, the updated statistics and the loss are averaged into the
  master, which takes one Adam step.

Draws are arguments, one set a shard (``torch.Generator``s or given
arrays), as in every step of the port; JAX splits one key a step.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from text2pos_torch.device import resolve_device
from text2pos_torch.ops.retrieval import two_key_topk

Device = Union[str, torch.device]


def _canonical(device: Device) -> torch.device:
    """``device`` with its CUDA index made explicit (``cuda`` is the current
    card), as a tensor's ``.device`` reads."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: one device a shard, in shard order (repeats allowed)."""

    devices: Tuple[torch.device, ...]
    axis: str = "dp"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(num_devices: Optional[int] = None,
              devices: Union[Device, Sequence[Device], None] = None,
              log=print) -> Mesh:
    """A mesh of ``num_devices`` shards. ``devices`` is one device a shard,
    or one device spec: ``"cpu"`` repeats the CPU; ``"cuda"`` (the
    default, or ``"cuda:i"``) takes ``num_devices`` cards from card i on
    when the machine has them, and otherwise repeats card i, saying so
    through ``log``. With no ``num_devices``, every card (one CPU)."""
    if devices is not None and not isinstance(devices, (str, torch.device)):
        devs = tuple(_canonical(resolve_device(d)) for d in devices)
        if num_devices not in (None, len(devs)):
            raise ValueError(f"{num_devices} shards over {len(devs)} "
                             "devices")
        return Mesh(devs)
    base = resolve_device(devices or "cuda")
    if base.type == "cpu":
        return Mesh((base,) * (num_devices or 1))
    base = _canonical(base)
    count = torch.cuda.device_count()
    n = num_devices or count - base.index
    if base.index + n <= count:
        return Mesh(tuple(torch.device("cuda", base.index + i)
                          for i in range(n)))
    log(f"# mesh: {n} shards on {count} card(s): all on {base}")
    return Mesh((base,) * n)


# ----------------------------------------------------------------------
# Collectives over one tensor a shard.
# ----------------------------------------------------------------------
def all_gather(xs: Sequence[torch.Tensor], mesh: Mesh, dim: int = 0
               ) -> List[torch.Tensor]:
    """JAX's tiled ``all_gather``: for each shard, ``cat(xs, dim)`` on its
    device (one concatenation a distinct device, shared by its shards).
    Differentiable."""
    out: Dict[torch.device, torch.Tensor] = {}
    for dev in mesh.devices:
        if dev not in out:
            out[dev] = torch.cat([x.to(dev) for x in xs], dim)
    return [out[dev] for dev in mesh.devices]


def pmean(xs: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """JAX's ``pmean``: the shards' mean (their sum in shard order over D,
    on the first device), on every shard's device."""
    dev0 = mesh.devices[0]
    total = xs[0].to(dev0)
    for x in xs[1:]:
        total = total + x.to(dev0)
    mean = total / len(xs)
    return [mean.to(dev) for dev in mesh.devices]


def ppermute(xs: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """JAX's ``ppermute`` with pairs (i, i+1 mod D): shard i's tensor moves
    to shard i+1's device."""
    D = mesh.size
    return [xs[(i - 1) % D].to(mesh.devices[i]) for i in range(D)]


def stack_microbatches(batches: List[Dict[str, np.ndarray]],
                       skip=("num_real", "pose_idx")) -> Dict[str, np.ndarray]:
    """Stack D per-device batches into [D, ...] arrays (JAX's)."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]
            if k not in skip}


def unstack(stacked: Dict[str, np.ndarray], d: int) -> Dict[str, np.ndarray]:
    """Shard d's batch of a ``stack_microbatches`` stack."""
    return {k: v[d] for k, v in stacked.items()}


def module_device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def replicate(module: nn.Module, mesh: Mesh) -> List[nn.Module]:
    """One module a shard for eval-mode work: ``module`` itself on its own
    device and on every repeat of it (eval mode mutates nothing), one copy
    on each other device (its own weights and kernel folds there)."""
    out = {module_device(module): module}
    for dev in mesh.devices:
        if dev not in out:
            out[dev] = copy.deepcopy(module).to(dev)
    return [out[dev] for dev in mesh.devices]


def on_shard(trainer, device: torch.device):
    """The trainer's helpers (points, batch tensors, losses) working on
    ``device``: a shallow copy with that device."""
    tr = copy.copy(trainer)
    tr.device = device
    return tr


# ----------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------
def replicate_pipeline(pipe, mesh: Mesh) -> list:
    """One serving pipeline a shard: ``pipe`` itself on its device and its
    repeats, elsewhere a pipeline of copied models with the database
    tensors on that device."""
    from text2pos_torch.evaluation.pipeline import LocalizationPipeline

    out = {pipe.device: pipe}
    for dev in mesh.devices:
        if dev not in out:
            db = [None if t is None else t.to(dev) for t in (
                pipe.cell_enc, pipe.fine_bank_enc, pipe.fine_bank_centers)]
            out[dev] = LocalizationPipeline(
                copy.deepcopy(pipe.coarse).to(dev),
                copy.deepcopy(pipe.fine).to(dev), pipe.vocab,
                pipe.fine_vocab, *db, pipe.cfg)
    return [out[dev] for dev in mesh.devices]


def _check_calibrated(pipe) -> None:
    if pipe.fine.superglue.eval_batch_stats:
        raise ValueError("data-parallel serving needs a calibrated pipeline "
                         "(calibrated_for_serving or a DB cache): with "
                         "batch-statistics BN a shard's result depends on "
                         "its sub-batch")


def _split(x, D: int, d: int):
    q = len(x) // D
    return x[d * q:(d + 1) * q]


def _check_queries(Q: int, D: int) -> None:
    if Q % D:
        raise ValueError(f"{Q} queries do not divide over {D} shards")


def dp_serve_batch(pipe, mesh: Mesh, top_k: int, rerank_k: int = 0,
                   rerank_lambda: float = 0.0, rerank_gamma: float = 0.0,
                   prune_m: int = 0, prune_layers: int = 1,
                   prune_sinkhorn: int = 10, prune_soft: bool = False):
    """Serving with the queries split over the mesh and the database
    replicated (JAX's ``dp_serve_batch``). ``pipe`` must be calibrated:
    with frozen statistics each query's result is its single-device one.

    Returns ``serve(tokens, lengths, hint_tokens, hint_lengths) ->
    (top_idx, pos_mean, pos_offsets, confidences)``, ``serve_batch``'s
    outputs gathered on the first device; the query count must divide by
    the mesh size."""
    _check_calibrated(pipe)
    replicas = replicate_pipeline(pipe, mesh)
    D, dev0 = mesh.size, mesh.devices[0]

    def serve(tokens, lengths, hint_tokens, hint_lengths):
        _check_queries(len(tokens), D)
        outs = [rep.serve_batch(
            *(_split(x, D, d) for x in (tokens, lengths, hint_tokens,
                                        hint_lengths)),
            top_k, rerank_k, rerank_lambda, rerank_gamma, prune_m,
            prune_layers, prune_sinkhorn, prune_soft)
            for d, rep in enumerate(replicas)]
        return tuple(torch.cat([o[j].to(dev0) for o in outs])
                     for j in range(4))

    return serve


def dp_serve_batch_dbsharded(pipe, mesh: Mesh, top_k: int,
                             rerank_k: int = 0,
                             num_real_cells: Optional[int] = None,
                             rerank_lambda: float = 0.0,
                             rerank_gamma: float = 0.0,
                             prune_m: int = 0, prune_layers: int = 1,
                             prune_sinkhorn: int = 10,
                             prune_soft: bool = False):
    """Serving with the queries AND the map split over the mesh (JAX's
    ``dp_serve_batch_dbsharded``), for a map larger than one card.

    ``pipe`` is calibrated and holds the whole database, its cell count a
    multiple of the mesh size (zero rows appended); ``num_real_cells`` is
    the true count, and the dummies are scored −inf by global index so
    they never win. Shard d keeps cells [d·C/D, (d+1)·C/D) of the cell
    encodings and the fine bank on its device. Two ring passes
    (``ppermute``):

    1. retrieval: the cell shards rotate; each shard scores its queries
       against the visiting shard and keeps a running top-k by score and
       then global index (``two_key_topk``: the ring visits shards in the
       order d, d-1, …, so only that order gives single-device top-k's
       lowest index on exact ties);
    2. gather: the fine-bank shards rotate; each shard takes its winners'
       rows as their home shard passes (a masked clamp-gather).

    The cascade (hard or ``prune_soft``) and the fine matching then run
    locally on the gathered candidates, then the re-rank and compact
    outputs. Returns ``serve(tokens, lengths, hint_tokens, hint_lengths)``
    as ``dp_serve_batch``'s."""
    from text2pos_torch.evaluation.pipeline import _compact_results, _take

    _check_calibrated(pipe)
    D, dev0 = mesh.size, mesh.devices[0]
    C = pipe.cell_enc.shape[0]
    if C % D:
        raise ValueError(f"pad the DB to a multiple of {D} cells ({C})")
    C_real = num_real_cells or C
    if C_real > C:
        raise ValueError(f"{C_real} real cells in a DB of {C}")
    Cs = C // D
    k_all = rerank_k if rerank_k > top_k else top_k
    k_loc = min(k_all, C_real)
    eff_rerank = rerank_k if k_loc > top_k else 0
    cascade = bool(prune_m) and top_k < prune_m < k_loc
    replicas = replicate_pipeline(pipe.with_database(None, None, None), mesh)
    shard = lambda t: [t[d * Cs:(d + 1) * Cs].to(dev)
                       for d, dev in enumerate(mesh.devices)]
    cell_shards = shard(pipe.cell_enc)
    bank_shards = (shard(pipe.fine_bank_enc), shard(pipe.fine_bank_centers))

    @torch.inference_mode()
    def serve(tokens, lengths, hint_tokens, hint_lengths):
        _check_queries(len(tokens), D)
        q = len(tokens) // D
        devs = mesh.devices
        with record_function("serve.encode"):
            text = [rep.coarse.encode_text(
                rep._as_tensor(_split(tokens, D, d)),
                rep._as_tensor(_split(lengths, D, d)))
                for d, rep in enumerate(replicas)]
        with record_function("serve.ring_retrieval"):
            best_v = [torch.full((q, k_loc), -torch.inf, device=dev)
                      for dev in devs]
            best_i = [torch.zeros(q, k_loc, dtype=torch.long, device=dev)
                      for dev in devs]
            cells, src = cell_shards, list(range(D))
            for step in range(D):
                for d in range(D):
                    scores = torch.matmul(text[d].float(),
                                          cells[d].float().T)
                    gidx = src[d] * Cs + torch.arange(Cs, device=devs[d])
                    scores = torch.where(gidx < C_real, scores, -torch.inf)
                    best_v[d], best_i[d] = two_key_topk(
                        torch.cat([best_v[d], scores], 1),
                        torch.cat([best_i[d], gidx.expand(q, Cs)], 1),
                        k_loc)
                if step < D - 1:
                    cells = ppermute(cells, mesh)
                    src = [(s + D - 1) % D for s in src]
        with record_function("serve.ring_gather"):
            banks, src = bank_shards, list(range(D))
            got = [[b.new_zeros((q, k_loc) + b.shape[1:]) for b in
                    (banks[0][d], banks[1][d])] for d in range(D)]
            for step in range(D):
                for d in range(D):
                    loc = best_i[d] - src[d] * Cs
                    inside = ((loc >= 0) & (loc < Cs))[..., None, None]
                    loc = loc.clamp(0, Cs - 1)
                    got[d] = [torch.where(inside, b[d][loc], g)
                              for b, g in zip(banks, got[d])]
                if step < D - 1:
                    banks = tuple(ppermute(b, mesh) for b in banks)
                    src = [(s + D - 1) % D for s in src]
        outs = []
        for d, rep in enumerate(replicas):
            top_idx, sims, (obj, ctr) = best_i[d], best_v[d], got[d]
            with record_function("serve.encode"):
                hint_enc = rep.fine.encode_hints(
                    rep._as_tensor(_split(hint_tokens, D, d)),
                    rep._as_tensor(_split(hint_lengths, D, d)))
            rerank = eff_rerank
            if cascade:
                with record_function("serve.cheap_pass"):
                    keep = rep._cheap_order(obj, ctr, sims, hint_enc, prune_m,
                                            prune_layers, prune_sinkhorn,
                                            prune_soft, rerank_lambda,
                                            rerank_gamma)
                    top_idx, sims, obj, ctr = (_take(x, keep) for x in (
                        top_idx, sims, obj, ctr))
                rerank = prune_m
            with record_function("serve.full_pass"):
                pos_mean, pos_offsets, confidences, conf_scores, spreads = (
                    rep._match_from_enc(obj, ctr, hint_enc))
            outs.append(_compact_results(
                top_idx, pos_mean, pos_offsets, confidences, conf_scores,
                min(top_k, C_real), rerank, C_real, sims=sims,
                rerank_lambda=rerank_lambda, spreads=spreads,
                rerank_gamma=rerank_gamma))
        return tuple(torch.cat([o[j].to(dev0) for o in outs])
                     for j in range(4))

    return serve


# ----------------------------------------------------------------------
# The evaluation's DB-cell encode
# ----------------------------------------------------------------------
def dp_encode_cells(trainer, state, mesh: Mesh, cells_per_device: int):
    """The DB-cell encode with the cells split over the mesh (JAX's
    ``dp_encode_cells``): eval-mode object towers on ``replicate``'s
    modules. Returns ``encode(stacked, generators=None, draws=None) ->
    [D · cells_per_device, E]`` on the first device, for ``stacked``
    flat-packed cell batches of ``cells_per_device`` cells a shard
    (``flatten_bank_slice``, ``stack_microbatches``); shard d draws its
    sample indices from ``generators[d]`` or takes ``draws[d]``."""
    models = replicate(state.model, mesh)

    @torch.no_grad()
    def encode(stacked, generators=None, draws=None):
        encs = [on_shard(trainer, dev).encode_cells(
            models[d], unstack(stacked, d), cells_per_device,
            None if generators is None else generators[d],
            None if draws is None else draws[d])
            for d, dev in enumerate(mesh.devices)]
        return all_gather(encs, mesh)[0]

    return encode


def dp_encode_all_cells(trainer, state, bank, mesh: Mesh,
                        draws: Optional[Sequence[Sequence[np.ndarray]]] = None
                        ) -> np.ndarray:
    """Every cell of ``bank`` encoded over the mesh (JAX's
    ``dp_encode_all_cells``), ``batch_size`` cells a shard a step: [C, E]
    as ``CoarseTrainer.encode_all_cells`` gives. The last group is filled
    up with cell 0 and cut. Group g's shard d draws from a generator
    seeded by (1, seed, first cell of g, d), or takes ``draws[g][d]``."""
    from text2pos_torch.data.dense import flatten_bank_slice
    from text2pos_torch.train.coarse import step_generator

    cfg = trainer.cfg
    D, B = mesh.size, cfg.batch_size
    flat_cap = B * cfg.coarse_max_objects
    encode = dp_encode_cells(trainer, state, mesh, B)
    group = B * D
    out = []
    for g, i in enumerate(range(0, bank.num_cells, group)):
        idx = np.arange(i, min(i + group, bank.num_cells))
        real = len(idx)
        idx = np.concatenate([idx, np.zeros(group - real, np.int64)])
        micro = [flatten_bank_slice(bank, idx[d * B:(d + 1) * B], flat_cap)
                 for d in range(D)]
        gens = [step_generator(dev, 1, cfg.seed, i, d)
                for d, dev in enumerate(mesh.devices)]
        enc = encode(stack_microbatches(micro), gens,
                     None if draws is None else draws[g])
        out.append(enc[:real])
    return torch.cat(out).cpu().numpy()


# ----------------------------------------------------------------------
# Training
# ----------------------------------------------------------------------
class TrainReplicas:
    """The master model (shard 0's, whose parameters the optimizer holds)
    and one copy a further shard on its device. The copies are distinct
    modules even on a repeated device, so that each shard's train-mode BN
    updates start from the master's statistics."""

    def __init__(self, master: nn.Module, mesh: Mesh):
        if module_device(master) != mesh.devices[0]:
            raise ValueError(f"the model lies on {module_device(master)}, "
                             f"the mesh's first shard on {mesh.devices[0]}")
        self.master = master
        self.models = [master] + [copy.deepcopy(master).to(dev)
                                  for dev in mesh.devices[1:]]

    @torch.no_grad()
    def sync(self) -> None:
        """Every copy's parameters and BN statistics set to the master's."""
        src = list(self.master.parameters()) + list(self.master.buffers())
        for m in self.models[1:]:
            for dst, s in zip(list(m.parameters()) + list(m.buffers()), src):
                dst.copy_(s, non_blocking=True)

    @torch.no_grad()
    def reduce(self) -> None:
        """JAX's ``pmean`` of the gradients and of the updated statistics,
        into the master; the copies' gradients are dropped."""
        params = [list(m.parameters()) for m in self.models]
        for ps in zip(*params):
            grads = [p.grad for p in ps if p.grad is not None]
            if grads:
                ps[0].grad = _mean(grads, ps[0].device, len(ps))
            for p in ps[1:]:
                p.grad = None
        for bs in zip(*(list(m.buffers()) for m in self.models)):
            bs[0].copy_(_mean(bs, bs[0].device, len(bs)))


def _mean(xs, device: torch.device, n: int) -> torch.Tensor:
    """Sum of ``xs`` in shard order over ``n`` (a missing gradient counts
    as zeros), on ``device``."""
    total = xs[0].to(device)
    for x in xs[1:]:
        total = total + x.to(device)
    return total / n


def _dp_step(trainer, mesh: Mesh, shard_losses):
    """A DP train step around ``shard_losses(state, replicas, shards,
    generators, draws) -> [loss a shard]``: the copies take the master's
    weights, the sum of the shards' losses is differentiated once (a
    shard's loss reaches another shard's towers only through
    ``all_gather``), the gradients and statistics are averaged into the
    master (``TrainReplicas.reduce``) and the optimizer steps. Returns
    ``step(state, stacked, generators=None, draws=None) -> loss`` (the
    shards' mean, on the first device, not synchronized); ``generators``
    and ``draws`` one a shard."""
    reps = None

    def step(state, stacked, generators=None, draws=None):
        nonlocal reps
        if reps is None or reps.master is not state.model:
            reps = TrainReplicas(state.model, mesh)
        with record_function("dp.sync"):
            reps.sync()
        shards = [unstack(stacked, d) for d in range(mesh.size)]
        gens = generators or [None] * mesh.size
        drw = draws or [None] * mesh.size
        losses = shard_losses(reps.models, shards, gens, drw)
        dev0 = mesh.devices[0]
        with record_function("train.backward"):
            total = losses[0]
            for x in losses[1:]:
                total = total + x.to(dev0)
            total.backward()
        with record_function("dp.reduce"):
            reps.reduce()
        with record_function("train.optimizer"):
            state.apply_gradients()
        return pmean([x.detach() for x in losses], mesh)[0]

    return step


def dp_coarse_train_step(trainer, mesh: Mesh, global_negatives: bool = False):
    """The coarse DP train step (JAX's ``dp_coarse_train_step``): each
    shard runs both towers on its batch in train mode; with
    ``global_negatives`` both towers are ``all_gather``-ed, so every
    shard's ranking loss is over the global batch. See ``_dp_step``."""
    from text2pos_torch.train.state import TrainState

    def shard_losses(models, shards, gens, draws):
        towers = [on_shard(trainer, dev).forward_towers(
            TrainState(models[d]), shards[d], gens[d], draws[d])
            for d, dev in enumerate(mesh.devices)]
        text, cells = (list(t) for t in zip(*towers))
        if global_negatives:
            text, cells = all_gather(text, mesh), all_gather(cells, mesh)
        return [trainer.loss(t, c) for t, c in zip(text, cells)]

    return _dp_step(trainer, mesh, shard_losses)


def dp_fine_train_step(trainer, mesh: Mesh):
    """The fine DP train step (JAX's ``dp_fine_train_step``): the matching
    NLL plus 5 · the offsets MSE on each shard's batch. See ``_dp_step``."""
    from text2pos_torch.train.state import TrainState

    def shard_losses(models, shards, gens, draws):
        return [on_shard(trainer, dev).forward_loss(
            TrainState(models[d]), shards[d], gens[d], draws[d])[0]
            for d, dev in enumerate(mesh.devices)]

    return _dp_step(trainer, mesh, shard_losses)


def dp_train_epoch(step, trainer, state, loader, epoch: int, mesh: Mesh,
                   use: int) -> Tuple[object, float]:
    """One DP epoch (JAX's ``dp_train_epoch``): the loader's batches in
    groups of D, one ``step`` a group, the trailing short group dropped;
    at most ``max_batches`` steps. Step i's shard d draws from a generator
    seeded by (``use``, seed, epoch, i, d): ``use`` 0 coarse, 2 fine, as
    the single-device epochs. Returns (state, the steps' mean loss)."""
    from text2pos_torch.train.coarse import step_generator

    cfg = trainer.cfg
    losses, micro, i = [], [], 0
    for batch in loader.epoch(seed=cfg.seed * 10_000 + epoch):
        micro.append(batch)
        if len(micro) == mesh.size:
            gens = [step_generator(dev, use, cfg.seed, epoch, i, d)
                    for d, dev in enumerate(mesh.devices)]
            losses.append(step(state, stack_microbatches(micro), gens))
            i += 1
            micro = []
        if cfg.max_batches is not None and i >= cfg.max_batches:
            break
    if not losses:
        return state, float("nan")
    return state, float(np.mean(torch.stack(losses).cpu().numpy()))
