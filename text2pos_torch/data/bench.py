"""The bench map: the synthetic database that ``bench.py`` serves from.

``make_bench_dataset`` repeats ``bench.py``'s ``make_bench_dataset`` with its
default constants (8 scenes named ``9900``…``9907``, a 16×16 grid of 30 m
cells each, 2 poses per cell, 12 objects per cell area) through the port's
copy of the generator; with the same ``np.random.default_rng`` streams the
cells come out bit-identical. ``bench_cell_bank`` packs them as the JAX
bench's ``CoarseLoader`` does: 28 object slots of 256 stored points, seed 0.
"""

from __future__ import annotations

from typing import List, Tuple

from text2pos_torch.data.dense import CellBank, build_cell_bank
from text2pos_torch.data.structs import Cell, Pose
from text2pos_torch.data.synthetic import make_synthetic_dataset

NUM_SCENES = 8
NUM_CELLS_GRID = 16
CELL_SIZE = 30.0
NUM_QUERIES = 2048
MAX_OBJECTS = 28          # coarse_max_objects of the JAX EvalConfig
POINTS_PER_OBJECT = 256   # pointnet_numpoints


def make_bench_dataset(num_scenes: int = NUM_SCENES,
                       grid: int = NUM_CELLS_GRID,
                       num_queries: int = NUM_QUERIES
                       ) -> Tuple[List[Cell], List[Pose]]:
    """``num_scenes`` synthetic scenes of ``grid``×``grid`` cells and
    ``num_queries`` poses (repeated when the scenes hold fewer)."""
    cells, poses = [], []
    for s in range(num_scenes):
        c, p = make_synthetic_dataset(
            seed=s, scene_name=f"99{s:02d}", extent=CELL_SIZE * grid,
            cell_size=CELL_SIZE, poses_per_cell=2, objects_per_cell_area=12)
        cells += c
        poses += p
    while len(poses) < num_queries:
        poses = poses + poses
    return cells, poses[:num_queries]


def bench_cell_bank(cells: List[Cell]) -> CellBank:
    """The dense bank the bench encodes (``CoarseLoader``'s, seed 0)."""
    return build_cell_bank(cells, MAX_OBJECTS, POINTS_PER_OBJECT, seed=0)
