"""Minimal PLY point-cloud I/O (ascii + binary little/big endian).

A copy of ``roreg_tpu/data/ply.py``: vertex x/y/z are read without open3d,
and clouds are written as binary little-endian float32.
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_ply", "write_ply"]

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> np.ndarray:
    """Read vertex x/y/z from a PLY file -> (N, 3) float64."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype_str)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                cur = (tok[1], int(tok[2]), [])
                elements.append(cur)
            elif tok[0] == "property":
                if tok[1] == "list":
                    cur[2].append((tok[4], "list", tok[2], tok[3]))
                else:
                    cur[2].append((tok[2], _PLY_DTYPES[tok[1]]))
            elif tok[0] == "end_header":
                break

        endian = "<" if fmt == "binary_little_endian" else ">"
        for name, count, props in elements:
            if name != "vertex":
                # skip non-vertex elements that precede vertex (rare)
                continue
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    rows.append(f.readline().split())
                arr = np.asarray(rows, dtype=np.float64)
                names = [p[0] for p in props]
                ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
                return arr[:, [ix, iy, iz]]
            else:
                if any(p[1] == "list" for p in props):
                    raise ValueError("list property in vertex element unsupported")
                dt = np.dtype([(p[0], endian + p[1]) for p in props])
                arr = np.frombuffer(f.read(count * dt.itemsize), dtype=dt, count=count)
                return np.stack(
                    [arr["x"], arr["y"], arr["z"]], axis=-1
                ).astype(np.float64)
        raise ValueError(f"{path}: no vertex element")


def write_ply(path: str, points: np.ndarray) -> None:
    """Write (N, 3) points as binary little-endian PLY."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "end_header\n"
        )
        f.write(header.encode("ascii"))
        f.write(pts.tobytes())
