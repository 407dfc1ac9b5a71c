"""Minimal, dependency-free PLY reader/writer.

Handles ascii and binary_little_endian PLYs with scalar properties — enough
for (a) COLMAP/SfM input point clouds (x,y,z[,normals][,colors]) and (b) the
3DGS ecosystem interchange format the reference emits
(reference: scene/gaussian_model.py:177-208): binary little-endian, one
``vertex`` element with float32 properties in the exact order
``x y z nx ny nz f_dc_0..2 f_rest_0..44 opacity scale_0..2 rot_0..3``.
The writer is byte-compatible with that layout (see
:mod:`gsjax_torch.models.gaussians` for the gaussian-specific
(de)serialization). A numpy copy of ``gsjax.data.ply``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "i2",
    "int16": "i2",
    "ushort": "u2",
    "uint16": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}
_INV_DTYPES = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int", "u4": "uint"}


def read_ply(path) -> Dict[str, Dict[str, np.ndarray]]:
    """Read a PLY file -> {element_name: {property_name: (N,) array}}.

    Supports ascii and binary_little_endian with scalar properties only
    (list properties are rejected — not used by any 3DGS artifact).
    """
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            tokens = line.decode("ascii").strip().split()
            if not tokens or tokens[0] == "comment":
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append((tokens[1], int(tokens[2]), []))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    raise ValueError(f"{path}: list properties unsupported")
                elements[-1][2].append((tokens[2], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"{path}: unsupported PLY format {fmt}")

        out: Dict[str, Dict[str, np.ndarray]] = {}
        for name, count, props in elements:
            dtype = np.dtype([(p, "<" + d) for p, d in props])
            if fmt == "binary_little_endian":
                data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype)
            else:
                rows = [f.readline().split() for _ in range(count)]
                arr2d = np.asarray(rows, dtype=np.float64)
                data = np.zeros(count, dtype=dtype)
                for j, (p, _) in enumerate(props):
                    data[p] = arr2d[:, j]
            out[name] = {p: np.ascontiguousarray(data[p]) for p, _ in props}
        return out


def write_ply(path, properties: Dict[str, np.ndarray], element: str = "vertex"):
    """Write a single-element binary_little_endian PLY.

    ``properties`` is an ordered {name: (N,) array} mapping; property order in
    the file follows dict insertion order (callers control byte layout).
    """
    names = list(properties)
    n = len(properties[names[0]])
    cols = []
    for name in names:
        a = np.asarray(properties[name])
        if a.shape != (n,):
            raise ValueError(f"property {name}: expected shape ({n},), got {a.shape}")
        cols.append(a)
    dtype = np.dtype(
        [(name, "<" + a.dtype.str[1:]) for name, a in zip(names, cols)]
    )
    rec = np.empty(n, dtype=dtype)
    for name, a in zip(names, cols):
        rec[name] = a
    header = ["ply", "format binary_little_endian 1.0", f"element {element} {n}"]
    for name, a in zip(names, cols):
        header.append(f"property {_INV_DTYPES[a.dtype.str[1:]]} {name}")
    header.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())


def write_point_cloud_ply(path, xyz, rgb=None, normals=None):
    """Write an x,y,z[,nx,ny,nz][,red,green,blue] point cloud PLY.

    Layout matches the reference's storePly (scene/dataset_readers.py:115-130):
    float32 xyz + normals, uchar colors.
    """
    xyz = np.asarray(xyz, dtype=np.float32)
    props = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]}
    normals = (
        np.zeros_like(xyz) if normals is None else np.asarray(normals, np.float32)
    )
    props.update({"nx": normals[:, 0], "ny": normals[:, 1], "nz": normals[:, 2]})
    if rgb is not None:
        rgb = np.asarray(rgb)
        if rgb.dtype != np.uint8:
            rgb = np.clip(rgb * 255.0 if rgb.max() <= 1.0 else rgb, 0, 255).astype(
                np.uint8
            )
        props.update({"red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2]})
    write_ply(path, props)


def read_point_cloud_ply(path):
    """Read xyz / rgb / normals from a point-cloud PLY.

    Matches reference fetchPly (scene/dataset_readers.py:107-113): colors are
    rescaled from uint8 to [0, 1]; missing colors/normals default to mid-gray
    and zeros.
    """
    v = read_ply(path)["vertex"]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    if "red" in v:
        rgb = np.stack([v["red"], v["green"], v["blue"]], axis=1)
        if rgb.dtype == np.uint8:
            rgb = rgb.astype(np.float64) / 255.0
    else:
        rgb = np.full_like(xyz, 0.5)
    if "nx" in v:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float64)
    else:
        normals = np.zeros_like(xyz)
    return xyz, rgb, normals
