"""Convert NAG HDF5 files from the v2.1.0 layout to the v3 layout that
the port and the reference v3 read (reference
src/utils/backwards_compatibility/convert_nag_v2_to_v3.py); counterpart
of `superpoint_transformer_tpu/utils/backwards_compatibility.py`.

v2 layout: top-level groups ``partition_<i>`` holding
  - plain datasets per key (the same array codec as v3),
  - ``_csr_/<key>``: CSR-packed dense arrays (pointers/columns/values/
    shape),
  - ``_cluster_/<key>``: pointers + 'points' (Cluster),
  - ``_instance_data_/<key>``: pointers + integer-named value datasets
    '0','1','2' = obj/count/y (InstanceData; the reference's
    Old_InstanceData falls back to integer keys,
    convert_nag_v2_to_v3.py:268-272),
  - batch bookkeeping keys (``_slice_dict``/``_inc_dict``/
    ``_num_graphs``/``_not_indexable_``), which are dropped.

v3 layout: ``level_<i>`` groups as `NAG.save` writes them.

h5py is imported inside the functions only: the package imports
without it.

Usage:
    python -m superpoint_transformer_torch.utils.backwards_compatibility \
        nag_v2.h5 [--output-path nag_v3.h5]
"""
import numpy as np

__all__ = ['load_nag_v2', 'convert_nag_v2_to_v3']

_SKIP_KEYS = ('_not_indexable_', '_slice_dict', '_inc_dict',
              '_num_graphs')


def _load_data_v2(g, keys=None):
    from ..data.csr import Cluster, InstanceData
    from ..data.data import Data
    from ..data.io import load_array, load_csr_to_dense

    store = {}
    for k in g.keys():
        if k in _SKIP_KEYS:
            continue
        if k == '_csr_':
            for sk in g[k].keys():
                store[sk] = load_csr_to_dense(g[k][sk], non_fp_to_long=True)
        elif k == '_cluster_':
            for sk in g[k].keys():
                sg = g[k][sk]
                store[sk] = Cluster(
                    load_array(sg, 'pointers').astype(np.int64),
                    load_array(sg, 'points').astype(np.int64))
        elif k == '_instance_data_':
            for sk in g[k].keys():
                sg = g[k][sk]
                vals = [load_array(sg, str(i)).astype(np.int64)
                        for i in range(3) if str(i) in sg]
                store[sk] = InstanceData(
                    load_array(sg, 'pointers').astype(np.int64), *vals)
        elif keys is None or k in keys:
            store[k] = load_array(g, k, non_fp_to_long=False)
    # rgb and mean_rgb stay bytes on disk, as the reference keeps them
    for k in ('rgb', 'mean_rgb'):
        v = store.get(k)
        if v is not None and np.issubdtype(np.asarray(v).dtype, np.floating):
            store[k] = np.clip(np.asarray(v) * 255, 0, 255).astype(np.uint8)
    return Data(**store)


def load_nag_v2(path, low=0, high=-1, keys=None):
    """Read a v2-format NAG file into an in-memory `NAG`."""
    import h5py
    from ..data.nag import NAG

    with h5py.File(path, 'r') as f:
        levels = sorted(int(k[len('partition_'):]) for k in f.keys()
                        if k.startswith('partition_'))
        if not levels:
            raise ValueError(
                f'{path} has no partition_<i> groups: not a v2 NAG')
        low = max(low, levels[0])
        high = levels[-1] if high < 0 else min(high, levels[-1])
        data_list = [_load_data_v2(f[f'partition_{i}'], keys=keys)
                     for i in range(low, high + 1)]
    return NAG(data_list)


def convert_nag_v2_to_v3(input_path, output_path=None):
    """Convert a v2 NAG file to the v3 `level_<i>` layout. Returns the
    output path (default: `<input>_v3.h5`)."""
    output_path = output_path or input_path.replace('.h5', '_v3.h5')
    load_nag_v2(input_path).save(output_path)
    return output_path


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description='Convert NAG files from v2.1.0 to v3 layout')
    p.add_argument('input_path')
    p.add_argument('--output-path', default=None)
    a = p.parse_args(argv)
    print(f'wrote {convert_nag_v2_to_v3(a.input_path, a.output_path)}')


if __name__ == '__main__':
    main()
