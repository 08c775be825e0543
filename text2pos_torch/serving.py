"""Serving front end: checkpoints + map → world positions (counterpart of
``text2pos_tpu/serving.py``).

    server = LocalizationServer("coarse.msgpack", "fine.msgpack", cells)
    result = server.localize([["the pose is east of a gray building",
                               "it is north of a green vegetation"], ...])
    result["positions"]   # [Q, 3] world coordinates (best cell)

Setup packs the map into a cell bank, encodes its cells for retrieval and,
with ``calibrate`` (the default), freezes the fine stage's BatchNorms on
population statistics (``LocalizationPipeline.calibrated_for_serving``):
serving then runs every stage through the port's kernels and each query's
result is independent of its batch. ``calibrate=False`` keeps the
reference's batch statistics; the GNN and the set-abstraction levels then
run as PyTorch ops (the pipeline module says why). ``data_parallel=N``
splits each batch's queries over a mesh of N shards (``parallel.dp``:
cards 0 … N-1, or card 0 N times on a machine with fewer), and with
``shard_db`` the map too, served by two ring passes; both need
``calibrate``. ``python -m text2pos_torch.serving`` serves JSON lines from
stdin; its map is a cells pickle, prepared KITTI360 scenes
(``--base_path`` with ``--scenes``, in the reference's format or either
package's, read by ``data/legacy.py``) or a synthetic map.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from text2pos_torch.config import ServeConfig
from text2pos_torch.data.dense import build_cell_bank
from text2pos_torch.data.legacy import load_pickle
from text2pos_torch.evaluation.pipeline import (LocalizationPipeline,
                                                bank_tensors,
                                                encode_all_coarse,
                                                quantize_fine_bank)
from text2pos_torch.ops.retrieval import topk_retrieval


class LocalizationServer:
    """End-to-end text→position serving against a static cell map."""

    def __init__(self, path_coarse: str, path_fine: str, cells: Sequence,
                 cfg: Optional[ServeConfig] = None, top_k: int = 10,
                 dtype: Optional[str] = "bfloat16", calibrate: bool = True,
                 calibration_hints: Optional[Sequence[Sequence[str]]] = None,
                 data_parallel: int = 1, rerank_k: int = 0,
                 shard_db: bool = False, rerank_lambda: float = 0.0,
                 rerank_gamma: float = 0.0, prune_m: int = 0,
                 prune_layers: int = 1, prune_sinkhorn: int = 10,
                 prune_soft: bool = False, int8_cheap_bank: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        """Arguments as ``text2pos_tpu.serving.LocalizationServer``'s:

            path_coarse/path_fine: flax msgpack checkpoints.
            cells: the map (``data.structs.Cell`` objects).
            top_k: retrieved cells per query.
            rerank_k, rerank_lambda, rerank_gamma: fine-confidence
                re-ranking of ``rerank_k`` candidates by
                ``conf + λ·sim − γ·spread``.
            prune_m, prune_layers, prune_sinkhorn, prune_soft: the
                cascade (``top_k < prune_m < rerank_k``): a cheap pass of
                ``prune_layers`` block pairs and ``prune_sinkhorn``
                Sinkhorn iterations keeps the ``prune_m`` best for the full
                pass.
            int8_cheap_bank: the cheap pass reads the int8 fine bank.
            dtype: compute dtype of the model bodies.
            calibrate: serve on calibrated statistics (True) or on batch
                statistics (False).
            calibration_hints: hint lists to calibrate the GNN on; by
                default fabricated from the map's class and colour
                vocabulary.
            data_parallel: shards of the mesh the queries are split over
                (each batch padded to a multiple of it); needs calibrate.
            shard_db: with data_parallel > 1, the map split over the mesh
                too (zero rows appended to a multiple of it).
            device: where the models run (the card unless "cpu").
        """
        self.cfg = cfg or ServeConfig(top_k=(1, 5, top_k))
        self.top_k = top_k
        self.rerank_k = rerank_k
        self.rerank_lambda = float(rerank_lambda)
        self.rerank_gamma = float(rerank_gamma)
        self.prune_m = int(prune_m)
        self.prune_layers = int(prune_layers)
        self.prune_sinkhorn = int(prune_sinkhorn)
        self.prune_soft = bool(prune_soft)
        if prune_m and not (top_k < prune_m < rerank_k):
            raise ValueError(f"cascaded re-ranking needs top_k < prune_m "
                             f"< rerank_k, got {top_k}/{prune_m}/{rerank_k}")
        # JAX's two refusals, made before any work.
        if int8_cheap_bank and data_parallel > 1:
            raise ValueError("int8_cheap_bank is single-device only")
        if data_parallel > 1 and not calibrate:
            raise ValueError("data_parallel serving requires calibrate=True "
                             "(batch-statistics BN is not shard-invariant)")
        cfg = self.cfg
        pipe = LocalizationPipeline.from_checkpoints(
            path_coarse, path_fine, None, dtype, device, cfg)
        if self.prune_m and self.prune_layers > pipe.fine.superglue.num_layers:
            raise ValueError(f"prune_layers={self.prune_layers} exceeds the "
                             f"matcher's {pipe.fine.superglue.num_layers} "
                             "block pairs")
        self.vocab = pipe.vocab
        self.bank = build_cell_bank(list(cells), cfg.coarse_max_objects,
                                    cfg.pointnet_numpoints, seed=cfg.seed)

        with torch.inference_mode():
            if calibrate:
                gen = torch.Generator(device=pipe.device).manual_seed(
                    cfg.seed)
                self.cell_enc = encode_all_coarse(
                    pipe.coarse, bank_tensors(self.bank, pipe.device), gen,
                    cfg.pointnet_numpoints)
                htk, hln = self._calibration_tokens(calibration_hints)
                # Calibration retrievals from the model itself over the
                # calibration hints' joined texts.
                tk, ln = self.vocab.encode_batch(
                    [" ".join(h) for h in self._cal_hint_lists],
                    cfg.max_text_len)
                enc = pipe.coarse.encode_text(pipe._as_tensor(tk),
                                              pipe._as_tensor(ln))
                _, cal_idx = topk_retrieval(
                    enc, self.cell_enc, min(top_k, self.bank.num_cells))
        if calibrate:
            pipe = pipe.with_database(self.cell_enc, None, None)
            pipe = pipe.calibrated_for_serving(self.bank, htk, hln, cal_idx)
        else:
            pipe = pipe.with_database(*pipe.encode_database(self.bank))
            self.cell_enc = pipe.cell_enc
        self.fine_bank = (pipe.fine_bank_enc, pipe.fine_bank_centers)
        self.pipe = pipe
        self.cheap_bank = (quantize_fine_bank(self.fine_bank[0])
                           if int8_cheap_bank else (None, None))

        self._dp_serve = None
        if data_parallel > 1:
            from text2pos_torch.parallel.dp import (dp_serve_batch,
                                                    dp_serve_batch_dbsharded,
                                                    make_mesh)

            self._dp = data_parallel
            mesh = make_mesh(data_parallel, pipe.device)
            C = self.bank.num_cells
            k, rk = min(top_k, C), min(rerank_k, C)
            opts = dict(rerank_lambda=self.rerank_lambda,
                        rerank_gamma=self.rerank_gamma, prune_m=self.prune_m,
                        prune_layers=self.prune_layers,
                        prune_sinkhorn=self.prune_sinkhorn,
                        prune_soft=self.prune_soft)
            if shard_db:
                # Zero rows up to a multiple of the mesh size; the serve
                # masks them by global index, so none is ever retrieved.
                padn = (-C) % data_parallel
                z = lambda a: torch.cat([a, a.new_zeros((padn,)
                                                        + a.shape[1:])])
                self.cell_enc = z(self.cell_enc)
                self.fine_bank = (z(self.fine_bank[0]), z(self.fine_bank[1]))
                self._dp_serve = dp_serve_batch_dbsharded(
                    pipe.with_database(self.cell_enc, *self.fine_bank), mesh,
                    k, rk, num_real_cells=C, **opts)
            else:
                self._dp_serve = dp_serve_batch(pipe, mesh, k, rk, **opts)

    # ------------------------------------------------------------------
    def _calibration_tokens(self, calibration_hints):
        """Tokenize calibration hints (or fabricate neutral ones from the
        map's class/colour vocabulary when none are given; the same draws
        as JAX's, from ``np.random.default_rng(cfg.seed)``)."""
        if calibration_hints is None:
            from text2pos_torch.constants import (CLASS_TO_LABEL,
                                                  COLOR_NAMES, DIRECTIONS)

            labels = sorted(CLASS_TO_LABEL)
            rng = np.random.default_rng(self.cfg.seed)
            calibration_hints = []
            for _ in range(min(256, max(self.bank.num_cells, 32))):
                hints = []
                for _o in range(self.cfg.num_mentioned):
                    d = DIRECTIONS[rng.integers(len(DIRECTIONS))]
                    col = COLOR_NAMES[rng.integers(len(COLOR_NAMES))]
                    cls = labels[rng.integers(len(labels))]
                    hints.append(f"The pose is {d} of a {col} {cls}.")
                calibration_hints.append(hints)
        self._cal_hint_lists = [list(h)[: self.cfg.num_mentioned]
                                for h in calibration_hints]
        # Calibration only gathers BN statistics; repeating short hint
        # lists is always acceptable there.
        return self._hint_tokens(self._cal_hint_lists, pad_short=True)

    def _hint_tokens(self, hint_lists: Sequence[Sequence[str]],
                     pad_short: bool = False):
        """Tokenize per-query hint lists to the static [Q, H, T] layout.

        The matcher has no hint-validity mask, so a query with fewer than
        ``num_mentioned`` hints is never padded with empty pseudo-hints:
        it raises, or with ``pad_short`` repeats its own hints cyclically.
        """
        Q = len(hint_lists)
        H, Th = self.cfg.num_mentioned, self.cfg.max_hint_len
        htk = np.zeros((Q, H, Th), np.int32)
        hln = np.ones((Q, H), np.int32)
        short = [i for i, h in enumerate(hint_lists) if len(list(h)) < H]
        if short and not pad_short:
            raise ValueError(
                f"queries {short[:8]}{'…' if len(short) > 8 else ''} have "
                f"fewer than num_mentioned={H} hints; the matcher expects "
                f"exactly {H} hints per query. Pass pad_short_queries=True "
                "to pad by repeating each query's own hints.")
        for i, hints in enumerate(hint_lists):
            hints = list(hints)[:H]
            if not hints:
                raise ValueError(f"query {i} has no hints")
            if len(hints) < H:
                hints = (hints * (H // len(hints) + 1))[:H]
            tk, ln = self.vocab.encode_batch(hints, Th)
            htk[i, : len(tk)] = tk
            hln[i, : len(ln)] = ln
        return htk, hln

    # ------------------------------------------------------------------
    def _prepare(self, hint_lists: Sequence[Sequence[str]],
                 pad_short_queries: bool):
        """Tokenize a query batch to static arrays."""
        hint_lists = list(hint_lists)
        texts = [" ".join(h) for h in hint_lists]
        tk, ln = self.vocab.encode_batch(texts, self.cfg.max_text_len)
        htk, hln = self._hint_tokens(hint_lists, pad_short=pad_short_queries)
        if self._dp_serve is not None:
            pad = (-len(hint_lists)) % self._dp
            if pad:  # the queries must divide over the mesh
                tk, ln, htk, hln = (np.concatenate(
                    [a, np.repeat(a[-1:], pad, 0)]) for a in (tk, ln, htk,
                                                               hln))
        return (tk, ln, htk, hln), len(hint_lists)

    def _dispatch(self, tk, ln, htk, hln):
        """Enqueue one batch on the device(s); returns unfetched tensors."""
        if self._dp_serve is not None:
            return self._dp_serve(tk, ln, htk, hln)
        C = self.bank.num_cells
        return self.pipe.serve_batch(
            tk, ln, htk, hln, min(self.top_k, C), min(self.rerank_k, C),
            self.rerank_lambda, self.rerank_gamma, self.prune_m,
            self.prune_layers, self.prune_sinkhorn, self.prune_soft,
            cheap_bank=self.cheap_bank[0], cheap_scale=self.cheap_bank[1])

    def localize(self, hint_lists: Sequence[Sequence[str]],
                 pad_short_queries: bool = False) -> Dict:
        """Localize a batch of queries, each a list of hint sentences
        (exactly ``cfg.num_mentioned``; extra ones are cut, fewer raise
        unless ``pad_short_queries``).

        Returns dict with
            positions   [Q, 3]      world position from the best cell
            cell_ids    [Q]         best retrieved cell id
            top_cells   [Q, K]      retrieved cell indices
            positions_k [Q, K, 3]   per-retrieval world positions
            confidences [Q, K]      matched-object counts
        """
        args, Q = self._prepare(hint_lists, pad_short_queries)
        return self._finalize(self._fetch(self._dispatch(*args)), Q)

    def localize_stream(self, batches, pad_short_queries: bool = False):
        """Pipelined serving over an iterable of query batches: batch i+1
        is tokenized and enqueued on the device before batch i's results
        are copied back, so the host's work overlaps the device's. Yields
        one ``localize``-shaped dict per input batch, in order."""
        pending = None                       # (device tensors, real Q)
        for hint_lists in batches:
            args, Q = self._prepare(hint_lists, pad_short_queries)
            out = self._dispatch(*args)
            if pending is not None:
                yield self._finalize(self._fetch(pending[0]), pending[1])
            pending = (out, Q)
        if pending is not None:
            yield self._finalize(self._fetch(pending[0]), pending[1])

    @staticmethod
    def _fetch(out):
        return [o.cpu().numpy() for o in out]

    def _finalize(self, fetched, num_queries: int) -> Dict:
        """Host-side decode of one fetched serving batch."""
        top_idx, _, pos_offsets, conf = [
            np.asarray(o)[:num_queries] for o in fetched]
        top_idx = top_idx.astype(np.int64)
        lo = self.bank.bbox_w[top_idx][..., 0:3]          # [Q, K, 3]
        size = self.bank.cell_size[top_idx][..., None]
        pos_w = lo.copy()
        pos_w[..., 0:2] += np.asarray(pos_offsets) * size
        pos_w[..., 2] += 0.5 * (self.bank.bbox_w[top_idx][..., 5]
                                - self.bank.bbox_w[top_idx][..., 2])
        return {
            "positions": pos_w[:, 0],
            "cell_ids": [self.bank.cell_ids[i] for i in top_idx[:, 0]],
            "top_cells": top_idx,
            "positions_k": pos_w,
            "confidences": np.asarray(conf),
        }


# ----------------------------------------------------------------------
# Maps pickled by either package.
# ----------------------------------------------------------------------
def load_cells(path: str):
    """The map pickled at ``path`` (a list of ``Cell``s), read by the
    restricted unpickler of ``data/legacy.py``: the data structs of either
    package resolve to ``text2pos_torch.data.structs`` (so no JAX-package
    module is imported), numpy arrays to numpy; any other global is
    refused."""
    return load_pickle(path)


# ----------------------------------------------------------------------
# CLI: JSON-lines serving over stdin/stdout.
# ----------------------------------------------------------------------
def _iter_query_batches(stream, batch: int, on_error=None,
                        min_hints: int = 0):
    """Group stdin JSON lines into fixed-size hint-list batches.

    Each line is either ``{"hints": [...], "id": ...}`` or a bare JSON
    array of hint strings. Yields ``(hint_lists, ids, real)`` with the
    final partial batch padded by repeating its last query.

    Malformed lines (invalid JSON, missing/ill-typed ``hints``, or fewer
    than ``min_hints`` hints) never take the stream down: with
    ``on_error(lineno, id_or_None, message)`` they are reported and
    skipped; without it a ``ValueError`` naming the line is raised."""
    import json

    def _bad(lineno, qid, msg):
        if on_error is None:
            raise ValueError(f"stdin line {lineno}: {msg}")
        on_error(lineno, qid, msg)

    buf, ids = [], []
    for lineno, line in enumerate(stream):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError as e:
            _bad(lineno, None, f"invalid JSON: {e}")
            continue
        if isinstance(rec, dict):
            qid = rec.get("id", lineno)
            hints = rec.get("hints")
        else:
            qid, hints = lineno, rec
        if (not isinstance(hints, list) or not hints
                or not all(isinstance(h, str) for h in hints)):
            _bad(lineno, qid,
                 "expected {\"hints\": [str, ...]} or a JSON array of "
                 "hint strings")
            continue
        if len(hints) < min_hints:
            _bad(lineno, qid,
                 f"query has {len(hints)} hints, the model needs "
                 f"{min_hints} (rerun with --pad_short to self-repeat "
                 f"short queries)")
            continue
        buf.append(hints)
        ids.append(qid)
        if len(buf) == batch:
            yield buf, ids, batch
            buf, ids = [], []
    if buf:
        real = len(buf)
        buf = buf + [buf[-1]] * (batch - real)
        yield buf, ids, real


def main(argv=None):
    """``python -m text2pos_torch.serving``: text→position, JSON lines.

    Reads one query per stdin line, writes one JSON result line per
    query: {"id", "position", "cell_id", "confidence"}; a malformed line
    gets {"id", "error"}. Batches of ``--batch`` queries are served
    pipelined (``localize_stream``); a ``# stats`` line on stderr gives the
    batches' latency percentiles (the first batch apart, as warm-up).
    """
    import argparse
    import json
    import sys
    import time

    ap = argparse.ArgumentParser(
        description="Text2Pos serving: JSON-lines text→position")
    ap.add_argument("--path_coarse", required=True)
    ap.add_argument("--path_fine", required=True)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--cells_pickle",
                     help="pickle of prepared Cell objects (the map)")
    src.add_argument("--base_path",
                     help="reference-format dataset dir (with --scenes)")
    src.add_argument("--synthetic_seed", type=int,
                     help="serve a synthetic demo map built from this seed")
    ap.add_argument("--scenes", default="",
                    help="comma-separated scene names for --base_path")
    ap.add_argument("--top_k", type=int, default=10)
    ap.add_argument("--rerank_k", type=int, default=0,
                    help="fine-confidence re-ranking: retrieve this many "
                         "coarse candidates, fine-match all, return the "
                         "top_k best (0 = off)")
    ap.add_argument("--rerank_lambda", type=float, default=0.0,
                    help="weight of the coarse similarity in the "
                         "re-ranking score (conf + λ·sim)")
    ap.add_argument("--rerank_gamma", type=float, default=0.0,
                    help="weight of the matched position votes' spread "
                         "in the re-ranking score (− γ·spread)")
    ap.add_argument("--prune_m", type=int, default=0,
                    help="cascaded re-ranking: cheap-score all rerank_k "
                         "candidates, full fine-match only the best "
                         "prune_m (0 = off; needs top_k < prune_m < "
                         "rerank_k)")
    ap.add_argument("--prune_layers", type=int, default=1,
                    help="GNN self/cross pairs in the cascade's cheap pass")
    ap.add_argument("--prune_sinkhorn", type=int, default=10,
                    help="Sinkhorn iterations in the cascade's cheap pass")
    ap.add_argument("--prune_soft", action="store_true",
                    help="cheap pass scores from the soft transport mass "
                         "and vote spread (no hard match extraction)")
    ap.add_argument("--int8_cheap_bank", action="store_true",
                    help="int8-quantized fine bank for the cheap pass")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--pad_short", action="store_true",
                    help="self-repeat hints of short queries instead of "
                         "rejecting them")
    ap.add_argument("--no_calibrate", action="store_true")
    ap.add_argument("--data_parallel", type=int, default=1,
                    help="split each batch's queries over this many "
                         "shards (cards 0..N-1, or card 0 N times)")
    ap.add_argument("--shard_db", action="store_true",
                    help="with --data_parallel N: shard the map over the "
                         "mesh too (ring retrieval and gather)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    proto = ServeConfig()
    for f in ("pad_size", "num_mentioned", "coarse_max_objects",
              "pointnet_numpoints", "max_hint_len", "max_text_len"):
        ap.add_argument(f"--{f}", type=int, default=getattr(proto, f))
    args = ap.parse_args(argv)

    if args.cells_pickle:
        cells = load_cells(args.cells_pickle)
    elif args.base_path:
        from text2pos_torch.data.legacy import load_scenes

        cells, _ = load_scenes(args.base_path,
                               [s for s in args.scenes.split(",") if s])
    else:
        from text2pos_torch.data.synthetic import make_synthetic_dataset

        cells, _ = make_synthetic_dataset(seed=args.synthetic_seed)

    cfg = ServeConfig(
        top_k=(1, 5, args.top_k), pad_size=args.pad_size,
        num_mentioned=args.num_mentioned,
        coarse_max_objects=args.coarse_max_objects,
        pointnet_numpoints=args.pointnet_numpoints,
        max_hint_len=args.max_hint_len, max_text_len=args.max_text_len)
    server = LocalizationServer(
        args.path_coarse, args.path_fine, cells, cfg=cfg, top_k=args.top_k,
        dtype=None if args.dtype == "float32" else args.dtype,
        calibrate=not args.no_calibrate, data_parallel=args.data_parallel,
        rerank_k=args.rerank_k, shard_db=args.shard_db,
        rerank_lambda=args.rerank_lambda, rerank_gamma=args.rerank_gamma,
        prune_m=args.prune_m, prune_layers=args.prune_layers,
        prune_sinkhorn=args.prune_sinkhorn, prune_soft=args.prune_soft,
        int8_cheap_bank=args.int8_cheap_bank, device=args.device)
    print(f"# serving {server.bank.num_cells} cells, top_k={args.top_k}, "
          f"batch={args.batch}", file=sys.stderr, flush=True)

    errors = 0

    def on_error(lineno, qid, msg):
        # One JSON line per rejected query on the result stream, plus a
        # note on stderr; the stream keeps serving.
        nonlocal errors
        errors += 1
        print(json.dumps({"id": lineno if qid is None else qid,
                          "error": msg}), flush=True)
        print(f"# line {lineno}: {msg}", file=sys.stderr, flush=True)

    batches = _iter_query_batches(
        sys.stdin, args.batch, on_error=on_error,
        min_hints=0 if args.pad_short else args.num_mentioned)
    metas = []          # (ids, real) per in-flight batch, FIFO

    def gen():
        for hint_lists, ids, real in batches:
            metas.append((ids, real))
            yield hint_lists

    served, latencies_ms = 0, []
    t_start = t_batch = time.time()
    for out in server.localize_stream(gen(), pad_short_queries=args.pad_short):
        ids, real = metas.pop(0)
        for q in range(real):
            print(json.dumps({
                "id": ids[q],
                "position": [float(v) for v in out["positions"][q]],
                "cell_id": str(out["cell_ids"][q]),
                "confidence": int(out["confidences"][q][0]),
            }), flush=True)
        now = time.time()
        latencies_ms.append((now - t_batch) * 1e3)
        t_batch = now
        served += real

    if latencies_ms:
        steady = latencies_ms[1:] if len(latencies_ms) > 1 else latencies_ms
        p50, p90, p99 = np.percentile(steady, (50, 90, 99))
        print("# stats " + json.dumps({
            "device": str(server.pipe.device),
            "queries": served,
            "rejected": errors,
            "batches": len(latencies_ms),
            "warmup_ms": round(latencies_ms[0], 1),
            "p50_ms": round(float(p50), 1),
            "p90_ms": round(float(p90), 1),
            "p99_ms": round(float(p99), 1),
            "qps": round(served / max(time.time() - t_start, 1e-9), 1),
        }), file=sys.stderr, flush=True)
    elif errors:
        print(f"# stats: no servable queries ({errors} rejected)",
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
