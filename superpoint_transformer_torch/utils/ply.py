"""The binary PLY writer of the submission files; counterpart of
`write_ply` in `superpoint_transformer_tpu/utils/ply.py` (same header and
type names, so the files are byte-equal). The reader comes with the
DALES, KITTI-360 and ScanNet datasets."""
import numpy as np

__all__ = ['write_ply']

_PLY_TYPES = {
    'char': 'i1', 'uchar': 'u1', 'short': 'i2', 'ushort': 'u2',
    'int': 'i4', 'uint': 'u4', 'int8': 'i1', 'uint8': 'u1',
    'int16': 'i2', 'uint16': 'u2', 'int32': 'i4', 'uint32': 'u4',
    'float': 'f4', 'double': 'f8', 'float32': 'f4', 'float64': 'f8'}


def write_ply(path, vertex_dict, comments=()):
    """Write a binary-little-endian PLY with a single 'vertex' element
    from a dict of same-length 1D arrays."""
    names = list(vertex_dict.keys())
    n = len(vertex_dict[names[0]])
    inv = {v: k for k, v in _PLY_TYPES.items()}
    cols = {k: np.ascontiguousarray(v) for k, v in vertex_dict.items()}
    dt = np.dtype([(k, '<' + cols[k].dtype.str[1:]) for k in names])
    rec = np.zeros(n, dtype=dt)
    for k in names:
        rec[k] = cols[k]
    with open(path, 'wb') as f:
        f.write(b'ply\nformat binary_little_endian 1.0\n')
        for c in comments:
            f.write(f'comment {c}\n'.encode())
        f.write(f'element vertex {n}\n'.encode())
        for k in names:
            f.write(f'property {inv[cols[k].dtype.str[1:]]} {k}\n'.encode())
        f.write(b'end_header\n')
        rec.tofile(f)
