"""A minimal PLY reader (ascii, binary little and big endian) for the
DALES, KITTI-360 and ScanNet raw files, and the binary PLY writer of the
submission files; counterparts of `read_ply` and `write_ply` in
`superpoint_transformer_tpu/utils/ply.py` (same arrays read, same bytes
written)."""
import numpy as np

__all__ = ['read_ply', 'write_ply']

_PLY_TYPES = {
    'char': 'i1', 'uchar': 'u1', 'short': 'i2', 'ushort': 'u2',
    'int': 'i4', 'uint': 'u4', 'int8': 'i1', 'uint8': 'u1',
    'int16': 'i2', 'uint16': 'u2', 'int32': 'i4', 'uint32': 'u4',
    'float': 'f4', 'double': 'f8', 'float32': 'f4', 'float64': 'f8'}


def _header(f):
    """(format, [[name, count, props]]) of the PLY header at `f`'s start;
    a prop is (name, dtype) or, for a list, (name, 'list', count dtype,
    item dtype)."""
    if f.readline().strip() != b'ply':
        raise ValueError('not a PLY file')
    fmt, elements = None, []
    while True:
        line = f.readline()
        if not line:
            raise ValueError('unexpected EOF in header')
        tokens = line.strip().split()
        if not tokens:
            continue
        key = tokens[0]
        if key == b'format':
            fmt = tokens[1].decode()
        elif key == b'element':
            elements.append([tokens[1].decode(), int(tokens[2]), []])
        elif key == b'property':
            if tokens[1] == b'list':
                elements[-1][2].append(
                    (tokens[4].decode(), 'list',
                     _PLY_TYPES[tokens[2].decode()],
                     _PLY_TYPES[tokens[3].decode()]))
            else:
                elements[-1][2].append(
                    (tokens[2].decode(), _PLY_TYPES[tokens[1].decode()]))
        elif key == b'end_header':
            return fmt, elements


def read_ply(path):
    """{element name: structured ndarray} of the PLY file at `path`. An
    ascii element with a list property comes as its rows, each a list of
    byte tokens; binary list properties raise NotImplementedError. The
    arrays are writable copies (`np.frombuffer` alone gives read-only
    ones, which `torch.from_numpy` warns about)."""
    with open(path, 'rb') as f:
        fmt, elements = _header(f)
        out = {}
        for name, count, props in elements:
            has_list = any(len(p) == 4 for p in props)
            if fmt == 'ascii' and has_list:
                out[name] = [f.readline().split() for _ in range(count)]
            elif fmt == 'ascii':
                arr = np.loadtxt([f.readline() for _ in range(count)],
                                 dtype=np.float64, ndmin=2)
                rec = np.zeros(count, dtype=np.dtype(list(props)))
                for j, p in enumerate(props):
                    rec[p[0]] = arr[:, j]
                out[name] = rec
            elif has_list:
                raise NotImplementedError(
                    'binary list properties unsupported')
            else:
                endian = '<' if 'little' in fmt else '>'
                dt = np.dtype([(p[0], endian + p[1]) for p in props])
                out[name] = np.frombuffer(
                    f.read(dt.itemsize * count), dtype=dt).copy()
        return out


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
