"""Minimal PLY reader/writer (no external deps): the port's copy of the
JAX package's ``utils/plyio.py`` (``read_ply_vertices`` :27,
``read_point_cloud`` :115, ``write_point_cloud`` :125).

Replaces the reference's `plyfile` usage (reference utils.py:200-210 reads
`structure.ply` vertices; utils.py:855-865 writes colored point clouds).
Supports ASCII and binary little/big-endian, multiple elements, and list
properties (skipped on read; only the `vertex` element is materialized).
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_TYPE_MAP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply_vertices(path) -> np.ndarray:
    """Read the `vertex` element of a PLY file.

    Returns a structured numpy array with one field per scalar vertex
    property (e.g. x, y, z[, red, green, blue]).
    """
    path = Path(path)
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        elements = []  # list of (name, count, [(prop_name, dtype_str)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tokens = line.decode("ascii").strip().split()
            if not tokens:
                continue
            if tokens[0] == "comment" or tokens[0] == "obj_info":
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                cur = (tokens[1], int(tokens[2]), [])
                elements.append(cur)
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    cur[2].append((tokens[-1], ("list", _TYPE_MAP[tokens[2]], _TYPE_MAP[tokens[3]])))
                else:
                    cur[2].append((tokens[-1], _TYPE_MAP[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        if fmt is None:
            raise ValueError("PLY header missing format line")
        body = f.read()

    endian = "<" if fmt != "binary_big_endian" else ">"
    vertex_out = None
    offset = 0
    if fmt == "ascii":
        text_rows = body.decode("ascii").split("\n")
        row_i = 0
        for name, count, props in elements:
            scalar = [(p, t) for p, t in props if not isinstance(t, tuple)]
            rows = []
            for _ in range(count):
                while row_i < len(text_rows) and not text_rows[row_i].strip():
                    row_i += 1
                vals = text_rows[row_i].split()
                row_i += 1
                if name == "vertex":
                    rows.append(vals[: len(scalar)])
            if name == "vertex":
                dtype = np.dtype([(p, t) for p, t in scalar])
                arr = np.empty(count, dtype=dtype)
                for ci, (p, t) in enumerate(scalar):
                    arr[p] = np.asarray([r[ci] for r in rows], dtype=t)
                vertex_out = arr
    else:
        for name, count, props in elements:
            has_list = any(isinstance(t, tuple) for _, t in props)
            if not has_list:
                dtype = np.dtype([(p, endian + t) for p, t in props])
                nbytes = dtype.itemsize * count
                if name == "vertex":
                    vertex_out = np.frombuffer(body[offset:offset + nbytes], dtype=dtype).copy()
                offset += nbytes
            else:
                # variable-length rows: walk element by element
                for _ in range(count):
                    for p, t in props:
                        if isinstance(t, tuple):
                            _, cnt_t, item_t = t
                            cnt_size = np.dtype(cnt_t).itemsize
                            (n_items,) = struct.unpack_from(
                                endian + {"i1": "b", "u1": "B", "i2": "h", "u2": "H",
                                          "i4": "i", "u4": "I"}[cnt_t], body, offset)
                            offset += cnt_size + n_items * np.dtype(item_t).itemsize
                        else:
                            offset += np.dtype(t).itemsize
    if vertex_out is None:
        raise ValueError(f"{path} has no vertex element")
    return vertex_out


def read_point_cloud(path) -> np.ndarray:
    """SfM point cloud as homogeneous coordinates, shape (N, 4) float32.

    Parity: reference utils.py:200-210 (appends 1.0 to each xyz vertex).
    """
    v = read_ply_vertices(path)
    pts = np.stack([v["x"], v["y"], v["z"], np.ones_like(v["x"])], axis=-1)
    return pts.astype(np.float32)


def write_point_cloud(path, point_cloud: np.ndarray) -> None:
    """Write an (N, 6) xyzrgb array as an ASCII PLY.

    Parity: reference utils.py:855-865 (same header: float x/y/z,
    uchar red/green/blue, ASCII format).
    """
    point_cloud = np.asarray(point_cloud).reshape(-1, 6)
    n = point_cloud.shape[0]
    header = (
        "ply\nformat ascii 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    xyz = point_cloud[:, :3].astype(np.float32)
    rgb = np.clip(point_cloud[:, 3:], 0, 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write(header)
        for i in range(n):
            f.write(f"{xyz[i,0]} {xyz[i,1]} {xyz[i,2]} {rgb[i,0]} {rgb[i,1]} {rgb[i,2]}\n")
