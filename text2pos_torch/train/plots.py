"""Metric-curve plotting (a copy of ``text2pos_tpu/train/plots.py``): a grid
of subplots, one per metric, one line per run key, saved as PNG.
matplotlib is imported when a plot is drawn; where it is not installed, the
plot is skipped with a note on standard error."""

from __future__ import annotations

import os
import os.path as osp
import sys
from typing import Dict

import numpy as np


def plot_metrics(metrics: Dict[str, Dict], file_path: str,
                 size: float = 8.0) -> None:
    """metrics: {metric_name: {run_key: [values per epoch]}}; file_path:
    the PNG written."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: {file_path} not drawn",
              file=sys.stderr)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = int(np.round(np.sqrt(len(metrics))))
    cols = int(np.ceil(len(metrics) / rows))

    fig = plt.figure(figsize=(cols * size / 2, rows * size / 2))
    for i, (name, curves) in enumerate(metrics.items()):
        ax = fig.add_subplot(rows, cols, i + 1)
        for key, values in curves.items():
            ax.plot(values, label=str(key))
        ax.set_title(name)
        ax.legend(fontsize=6)
        ax.grid(alpha=0.3)
    fig.tight_layout()
    os.makedirs(osp.dirname(osp.abspath(file_path)), exist_ok=True)
    fig.savefig(file_path, dpi=120)
    plt.close(fig)
