"""Data loading for the training and evaluation entry points (counterpart
of ``text2pos_tpu/utils/cli.py``).

``--dataset SYNTHETIC`` and ``SYNTHETIC-FINE`` generate the JAX package's
synthetic datasets with the port's copy of the generator (the same cells
and poses from the same seeds). ``K360`` (the default) reads prepared
KITTI360 scenes from ``--base_path`` (``data/legacy.py``: the reference's
pickles or either package's) under the standard scene splits.
"""

from __future__ import annotations


def load_split(cfg, split: str):
    """Return (cells, poses) for 'train' | 'val' | 'test'."""
    dataset = cfg.dataset.upper()
    seed = {"train": 0, "val": 1, "test": 2}[split]
    if dataset == "SYNTHETIC-FINE":
        from text2pos_torch.data.synthetic import make_synthetic_fine_dataset

        describe_by = getattr(cfg, "describe_by", "closest")
        return make_synthetic_fine_dataset(
            seed=seed, length=256 if split == "train" else 64,
            num_mentioned=cfg.num_mentioned,
            pad_size=getattr(cfg, "pad_size", 16),
            num_distractors=getattr(cfg, "num_distractors", "all"),
            describe_by="closest" if describe_by == "all" else describe_by)
    if dataset == "SYNTHETIC":
        from text2pos_torch.data.synthetic import make_synthetic_dataset

        return make_synthetic_dataset(
            seed=seed, scene_name=f"999{seed}",
            extent=240.0 if split == "train" else 120.0,
            num_mentioned=cfg.num_mentioned, poses_per_cell=3)
    from text2pos_torch.constants import (SCENE_NAMES_TEST,
                                          SCENE_NAMES_TRAIN, SCENE_NAMES_VAL)
    from text2pos_torch.data.legacy import load_scenes

    scenes = {"train": SCENE_NAMES_TRAIN, "val": SCENE_NAMES_VAL,
              "test": SCENE_NAMES_TEST}[split]
    return load_scenes(cfg.base_path, scenes)
