"""Image-retrieval (NetVLAD-style) baseline (a copy of
``text2pos_tpu/evaluation/visloc.py``, numpy and scipy only): given
database and query image features computed elsewhere and their poses, the
accuracy of predicting each query's pose as the poses of its top-k
nearest database images in feature space.

    python -m text2pos_torch.evaluation.visloc --db_path db.pkl \\
        --query_path query.pkl [--device cpu]

reads ``{"features": [N, F], "poses": [N, 2 or 3]}`` pickles written by
the feature extractor and prints the accuracy table. Like the port's other
entry points the CLI asks for the card by default (``--device``, through
``resolve_device``) and raises without one unless given ``--device cpu``;
its arithmetic is numpy's either way.
"""

from __future__ import annotations

import pickle
from typing import Dict, Sequence

import numpy as np


def evaluate_features(db_features: np.ndarray, db_poses: np.ndarray,
                      query_features: np.ndarray, query_poses: np.ndarray,
                      top_k: Sequence[int] = (1, 5, 10),
                      threshs: Sequence[float] = (5, 10, 15)) -> Dict:
    """Top-k / threshold accuracies of feature-distance retrieval.

    Args:
        db_features:    [D, F]
        db_poses:       [D, 2 or 3] world positions of database images
        query_features: [Q, F]
        query_poses:    [Q, 2 or 3]
    """
    from scipy.spatial.distance import cdist

    db_poses = np.asarray(db_poses)[:, 0:2]
    query_poses = np.asarray(query_poses)[:, 0:2]

    dists_feat = cdist(query_features, db_features)          # [Q, D]
    max_k = max(top_k)
    order = np.argsort(dists_feat, axis=1)[:, :max_k]        # [Q, max_k]

    pred = db_poses[order]                                   # [Q, max_k, 2]
    err = np.linalg.norm(pred - query_poses[:, None, :], axis=2)

    accs = {k: {t: float(np.mean(np.min(err[:, :k], axis=1) <= t))
                for t in threshs}
            for k in top_k}
    return accs


def evaluate_pickled(db_path: str, query_path: str,
                     top_k=(1, 5, 10), threshs=(5, 10, 15)) -> Dict:
    """Load {features, poses} pickles for both sides and evaluate."""
    with open(db_path, "rb") as f:
        db = pickle.load(f)
    with open(query_path, "rb") as f:
        query = pickle.load(f)
    return evaluate_features(np.asarray(db["features"]),
                             np.asarray(db["poses"]),
                             np.asarray(query["features"]),
                             np.asarray(query["poses"]), top_k, threshs)


def main(argv=None) -> Dict:
    import argparse

    from text2pos_torch.device import resolve_device
    from text2pos_torch.evaluation.metrics import print_accuracies

    parser = argparse.ArgumentParser()
    parser.add_argument("--db_path", required=True)
    parser.add_argument("--query_path", required=True)
    parser.add_argument("--top_k", type=int, nargs="+", default=[1, 5, 10])
    parser.add_argument("--threshs", type=int, nargs="+", default=[5, 10, 15])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    accs = evaluate_pickled(args.db_path, args.query_path,
                            tuple(args.top_k), tuple(args.threshs))
    print_accuracies(accs, "VisLoc (image features)")
    return accs


if __name__ == "__main__":
    main()
