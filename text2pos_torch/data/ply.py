"""Minimal PLY reader for KITTI360 semantic point clouds (counterpart of
``text2pos_tpu/data/ply.py``).

Replaces the reference's ``plyfile`` dependency
(the Text2Pos reference code,
datapreparation/kitti360pose/prepare.py:56-67). KITTI360's
``data_3d_semantics/*/static/*.ply`` files are binary-little-endian with
per-vertex properties including x/y/z (float), red/green/blue (uchar),
semanticID/instanceID (typically int). This reader handles the general
binary-LE / ASCII vertex-element case.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the vertex element of a PLY file as {property: array}."""
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header_lines.append(line)
            if line == "end_header":
                break
            if len(header_lines) > 500:
                raise ValueError(f"{path}: header too long / not a PLY file")

        if header_lines[0] != "ply":
            raise ValueError(f"{path}: missing 'ply' magic")

        fmt = None
        elements = []  # [(name, count, [(prop_name, dtype_str)])]
        for line in header_lines[1:]:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append((parts[-1], "list", parts[2], parts[3]))
                else:
                    elements[-1][2].append((parts[-1], _PLY_DTYPES[parts[1]]))

        if fmt not in ("binary_little_endian", "ascii"):
            raise ValueError(f"{path}: unsupported PLY format {fmt}")

        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            if any(p[1] == "list" for p in props):
                if name == "vertex":
                    raise ValueError(f"{path}: list properties on vertex")
                break  # faces etc. — not needed, stop parsing
            if fmt == "binary_little_endian":
                dt = np.dtype([(p, "<" + d) for p, d in props])
                data = np.fromfile(f, dtype=dt, count=count)
            else:
                rows = np.loadtxt(
                    [f.readline() for _ in range(count)], ndmin=2)
                if rows.shape[1] != len(props):
                    # zip(props, rows.T) would silently zero-fill trailing
                    # properties on short rows; reject malformed input the
                    # way np.core.records.fromarrays used to.
                    raise ValueError(
                        f"{path}: element '{name}' declares {len(props)} "
                        f"properties but data rows have {rows.shape[1]} "
                        "columns")
                dt = np.dtype([(p, d) for p, d in props])
                data = np.zeros(count, dt)
                for (p, d), col in zip(props, rows.T):
                    data[p] = col.astype(d)
            if name == "vertex":
                for p, _ in props:
                    out[p] = np.ascontiguousarray(data[p])
        return out


def load_points(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(xyz [N,3] f64, rgb [N,3] f64 ∈[0,1], semantic_id [N], instance_id [N]).

    Mirrors reference prepare.py:56-67: colors scaled to [0,1].
    """
    v = read_ply(path)
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    rgb = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.float64)
    if rgb.max() > 1.0:
        rgb /= 255.0
    sem_key = "semantic" if "semantic" in v else "semanticID"
    inst_key = "instance" if "instance" in v else "instanceID"
    sem = v.get(sem_key, np.zeros(len(xyz), np.int64)).astype(np.int64)
    inst = v.get(inst_key, np.zeros(len(xyz), np.int64)).astype(np.int64)
    return xyz, rgb, sem, inst
