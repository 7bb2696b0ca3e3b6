"""The port needs none of jax, flax, optax, orbax, h5py, yaml or the JAX
package: in a fresh interpreter where importing any of them fails, the
port still imports every module, builds a model and runs a CPU forward,
builds the semantic task and takes a CPU training step, preprocesses
a synthetic room and serves it through `prepare_batch` and `infer_nag`,
runs the panoptic path (instance ids, a panoptic training step and
`validate_panoptic`), fits the flagship task for one epoch with the
`Trainer` on an in-memory dataset (checkpoints and CSV metrics written),
runs EZ-SP's two stages (`fit_partition`, then `preprocess_cloud`
with the frozen CNN of its checkpoint and the greedy contour-prior
partition), reads DALES, KITTI-360 and ScanNet raw files, serving a
preprocessed DALES tile with SPT-3, and serves whole clouds (the device
KNN on the CPU, the stacked forward, a reference checkpoint imported).
No module of the port imports the JAX package, jax, flax,
optax or orbax, even inside a function.
Its native library is its own build of `native/*.cpp`, never the prebuilt
`native/libspt_native.so`, and a failed build raises."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from superpoint_transformer_torch.ops import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent('''
    import sys

    BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'h5py', 'yaml',
               'superpoint_transformer_tpu')

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split('.')[0] in BLOCKED:
                raise ImportError(f'{name} is blocked')
            return None

    sys.meta_path.insert(0, Block())

    import importlib
    import json
    import pkgutil

    import torch
    import superpoint_transformer_torch as port
    for mod in pkgutil.walk_packages(port.__path__, port.__name__ + '.'):
        importlib.import_module(mod.name)
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.experiment import (
        FLAGSHIP_CFG, build_model, build_task)
    from superpoint_transformer_torch.inference import infer_batch
    from superpoint_transformer_torch.models.semantic import (
        SemanticSegmentationModel)
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.utils.synthetic import (
        random_padded_nag)

    model = SemanticSegmentationModel(
        build_model(FLAGSHIP_CFG, num_graphs=2, device='cpu'), 13)
    init_weights(model, torch.Generator().manual_seed(0)).eval()
    batch = from_numpy(random_padded_nag(seed=0, num_graphs=2,
                                         n_points=500, n_l1=40, n_l2=10),
                       'cpu', 'bfloat16')
    pred = infer_batch(model, batch)
    assert pred.shape == (batch[1].num_nodes,)
    assert pred.min() >= 0 and pred.max() < 13

    task = build_task(FLAGSHIP_CFG, num_graphs=2, total_steps=10,
                      device='cpu')
    init_weights(task.model, torch.Generator().manual_seed(0))
    host = random_padded_nag(seed=1, num_graphs=2, n_points=500, n_l1=40,
                             n_l2=10)
    metrics = task.train_step(from_numpy(host, 'cpu', 'bfloat16',
                                         train=True))
    assert bool(torch.isfinite(metrics['loss'])) and task.step == 1

    from superpoint_transformer_torch.inference import infer_nag
    from superpoint_transformer_torch.transforms.prepare import (
        BatchConfig, prepare_batch)
    from superpoint_transformer_torch.transforms.preprocess import (
        preprocess_cloud)
    from superpoint_transformer_torch.utils.synthetic import (
        synthetic_room_cloud)

    nag = preprocess_cloud(synthetic_room_cloud(seed=0, n_points=5_000),
                           voxel=0.1, knn=25, knn_r=10.0,
                           knn_min_search=10)
    cfg = BatchConfig(sample_graph_r=-1, sample_segment_ratio=0)
    host = prepare_batch([nag], cfg, train=False)
    assert host.levels[1].num_nodes == nag[1].num_nodes
    pred = infer_nag(model, nag, cfg)
    assert pred.shape == (nag[1].num_nodes,)
    assert pred.min() >= 0 and pred.max() < 13

    # the panoptic path: instance ids through preprocessing, the
    # instance graph, a training step and a validation epoch
    import numpy as np
    from superpoint_transformer_torch.data.csr import InstanceData
    from superpoint_transformer_torch.experiment import PANOPTIC_CFG
    from superpoint_transformer_torch.trainer import validate_panoptic

    raw = synthetic_room_cloud(seed=1, n_points=5_000)
    raw['obj'] = (raw.y * 2 + (raw.pos[:, 0] % 2 < 1)).astype(np.int64)
    nag = preprocess_cloud(raw, voxel=0.1, knn=25, knn_r=10.0,
                           knn_min_search=10, with_instances=True)
    assert isinstance(nag[1].obj, InstanceData)
    pcfg = BatchConfig(sample_graph_r=-1, sample_segment_ratio=0,
                       instance=True)
    ptask = build_task(PANOPTIC_CFG, num_graphs=2, total_steps=10,
                       device='cpu')
    init_weights(ptask.model, torch.Generator().manual_seed(0))
    host = prepare_batch([nag, nag], pcfg, train=True,
                         rng=np.random.default_rng(0))
    assert host.levels[1].obj_edge_mask.any()
    metrics = ptask.train_step(from_numpy(host, 'cpu', 'bfloat16',
                                          train=True))
    assert bool(torch.isfinite(metrics['loss'])) and ptask.step == 1
    out = validate_panoptic(ptask, [[nag, nag]], pcfg, 13,
                            grid_search=True)
    assert 0 <= out['pq'] <= 100 and out['n_pred_instances'] > 0
    print('PANOPTIC_OK')

    # the Trainer on an in-memory S3DIS (no HDF5 file): one epoch of fit
    # with a validation, checkpoints and CSV metrics
    import os
    import tempfile
    from superpoint_transformer_torch.datasets import S3DIS, DataLoader
    from superpoint_transformer_torch.trainer import Trainer

    class MemoryS3DIS(S3DIS):
        def __init__(self, clouds, **kw):
            self.clouds = clouds
            super().__init__('unused', **kw)

        @property
        def all_cloud_ids(self):
            return {'train': ['a', 'b'], 'val': ['a'], 'test': ['b']}

        def process(self):
            pass

        def load(self, cloud_id):
            return self.clouds[cloud_id]

    clouds = {'a': nag, 'b': nag}
    train = MemoryS3DIS(clouds, stage='train')
    ftask = build_task(FLAGSHIP_CFG, num_graphs=1, total_steps=2,
                       class_weight=train.get_class_weight(),
                       device='cpu')
    out_dir = tempfile.mkdtemp()
    trainer = Trainer(ftask, BatchConfig(), output_dir=out_dir,
                      max_epochs=1, check_val_every_n_epoch=1)
    trainer.fit(DataLoader(train, batch_size=1, shuffle=True),
                DataLoader(MemoryS3DIS(clouds, stage='val')))
    assert ftask.step == 2 and trainer.best_miou >= 0
    for name in ('last', 'best'):
        assert os.path.exists(os.path.join(out_dir, 'checkpoints', name,
                                           'state.pt'))
    assert len(open(os.path.join(out_dir, 'metrics.csv')).readlines()) == 3
    print('FIT_OK')

    # EZ-SP: stage 1 (the partition task) on random NAGs, then stage-2
    # preprocessing with its checkpoint's frozen CNN on the CPU
    from superpoint_transformer_torch.trainer import fit_partition
    from superpoint_transformer_torch.utils.synthetic import random_nag
    from superpoint_transformer_torch.models.partition import (
        PartitionModel, PartitionTask)
    nags = [random_nag(seed=s, n_points=400) for s in range(2)]
    stask = PartitionTask(PartitionModel(8, channels=(8, 8), num_graphs=2),
                          total_steps=2)
    ezsp_dir = tempfile.mkdtemp()
    fit_partition(stask, [nags], BatchConfig(), output_dir=ezsp_dir,
                  max_epochs=2)
    assert stask.step == 2
    ezsp = preprocess_cloud(
        synthetic_room_cloud(seed=2, n_points=5_000), voxel=0.1, knn=25,
        knn_r=10.0, knn_min_search=10, partition_mode='contour_prior',
        pretrained_cnn_ckpt_path=os.path.join(ezsp_dir, 'checkpoints',
                                              'last'),
        pretrained_cnn_channels=(8, 8), device='cpu')
    assert ezsp[0].num_nodes > ezsp[1].num_nodes > 1
    print('EZSP_OK')

    # the DALES, KITTI-360 and ScanNet readers on the port's synthetic
    # raw files, a DALES tile preprocessed as experiment=semantic/dales
    # says and served by SPT-3 at full width, and build_datasets for the
    # three datasets
    from superpoint_transformer_torch.datasets.dales import read_dales_tile
    from superpoint_transformer_torch.datasets.kitti360 import (
        read_kitti360_window)
    from superpoint_transformer_torch.datasets.scannet import (
        read_scannet_scan)
    from superpoint_transformer_torch.experiment import (
        DALES_CFG, KITTI360_CFG, PANOPTIC_SCANNET_CFG,
        _pre_transform_config, build_batch_config, build_datasets)
    from superpoint_transformer_torch.utils import synthetic as syn
    raw_dir = tempfile.mkdtemp()
    aerial, _ = syn.synthetic_aerial_cloud(seed=0, n_points=4_000)
    syn.write_dales_tile(os.path.join(raw_dir, 'tile.ply'), aerial)
    syn.write_kitti360_window(os.path.join(raw_dir, 'win.ply'), aerial)
    syn.write_scannet_scan(os.path.join(raw_dir, 'scene0000_00'),
                           synthetic_room_cloud(seed=0, n_points=4_000))
    tile = read_dales_tile(os.path.join(raw_dir, 'tile.ply'))
    assert read_kitti360_window(os.path.join(raw_dir, 'win.ply')
                                ).rgb.dtype == np.uint8
    assert (read_scannet_scan(os.path.join(raw_dir, 'scene0000_00'),
                              instances=True).obj == -1).any()
    dnag = preprocess_cloud(tile, num_classes=8,
                            **_pre_transform_config(DALES_CFG))
    assert dnag.num_levels == 4 and 'intensity' in dnag[0].keys()
    spt3 = SemanticSegmentationModel(
        build_model(DALES_CFG, num_graphs=1, device='cpu'), 8)
    init_weights(spt3, torch.Generator().manual_seed(0)).eval()
    pred = infer_nag(spt3, dnag, build_batch_config(DALES_CFG))
    assert pred.shape == (dnag[1].num_nodes,) and pred.max() < 8
    for c in (DALES_CFG, KITTI360_CFG, PANOPTIC_SCANNET_CFG):
        c = dict(c, datamodule=dict(c['datamodule'], data_dir=raw_dir),
                 device='cpu')
        assert sorted(build_datasets(c)) == ['test', 'train', 'val']
    print('READERS_OK')

    # whole-cloud serving: the device KNN (on the CPU here), the stacked
    # forward, the eigen features on tensors, a reference-format
    # checkpoint imported, the run utilities
    from superpoint_transformer_torch.inference import (
        e2e_inference, infer_nags_stacked)
    from superpoint_transformer_torch.ops.geometry import geometric_features
    from superpoint_transformer_torch.utils.import_ckpt import (
        flax_path, import_reference_checkpoint, reference_key_for)
    from superpoint_transformer_torch.utils.memory import (
        device_memory_stats, is_oom_error)
    from superpoint_transformer_torch.utils.profiling import Timings
    import superpoint_transformer_torch.utils.memory as memory
    assert memory._MALLOC_TUNED and not port.is_debug_enabled()
    dknn = preprocess_cloud(synthetic_room_cloud(seed=3, n_points=5_000),
                            voxel=0.1, knn=25, knn_r=10.0,
                            knn_min_search=10, knn_backend='device',
                            device='cpu')
    assert dknn.num_levels == 4
    preds = infer_nags_stacked(model, [dknn] * 3, cfg,
                               max_tiles_per_program=2, warmup=True)
    one = infer_nag(model, dknn, cfg)
    assert len(preds) == 3 and all((p == one).all() for p in preds)
    raw = synthetic_room_cloud(seed=4, n_points=5_000)
    full, info = e2e_inference(model, raw,
                               pre_cfg=dict(voxel=0.1, knn=25, knn_r=10.0,
                                            knn_min_search=10,
                                            knn_backend='device',
                                            device='cpu'))
    assert full.shape == (raw.num_nodes,) and full.min() >= 0
    from superpoint_transformer_torch.ops.device_preprocess import (
        grid_knn_device)
    pos = torch.from_numpy(dknn[0].pos)
    nb, _ = grid_knn_device(pos, torch.ones(pos.shape[0], dtype=torch.bool),
                            0.5, 8, cell_cap=64)
    feats = geometric_features(pos, nb.long(), nb >= 0)
    assert feats['normal'].shape == (pos.shape[0], 3)
    state = {reference_key_for(flax_path(name, p)): p.detach().clone()
             for name, p in model.named_parameters()}
    twin = SemanticSegmentationModel(
        build_model(FLAGSHIP_CFG, num_graphs=2, device='cpu'), 13)
    report = import_reference_checkpoint(state, twin)
    assert not report['missing'] and not report['unused_reference_keys']
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 twin.parameters()))
    assert is_oom_error(MemoryError()) and device_memory_stats() == {}
    assert Timings().summary() == ''
    print('SERVING_OK')

    loaded = sorted(m for m in sys.modules
                    if m.split('.')[0] in BLOCKED)
    assert not loaded, loaded
    with open('/proc/self/maps') as f:
        libs = sorted({line.split()[-1] for line in f
                       if 'libspt_native' in line})
    print('NATIVE_LIBS', json.dumps(libs))
    print('PORT_OK')
''')


@pytest.fixture(scope='module')
def blocked_run():
    # one thread for torch and OpenMP: the suite runs its files in
    # parallel processes, and a thread a core each oversubscribes the CPU
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    return subprocess.run([sys.executable, '-c', SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_runs_without_jax_flax_h5py_yaml(blocked_run):
    assert blocked_run.returncode == 0, blocked_run.stderr
    assert 'PORT_OK' in blocked_run.stdout


def test_panoptic_runs_without_jax_flax_h5py_yaml(blocked_run):
    """Instance ids through `preprocess_cloud(with_instances=True)`, a
    panoptic training step and `validate_panoptic` with its grid search,
    with the same imports blocked."""
    assert blocked_run.returncode == 0, blocked_run.stderr
    assert 'PANOPTIC_OK' in blocked_run.stdout


def test_trainer_fit_runs_without_jax_flax_optax_h5py_yaml(blocked_run):
    """One epoch of `Trainer.fit` with a validation on an in-memory
    dataset, with the same imports blocked."""
    assert blocked_run.returncode == 0, blocked_run.stderr
    assert 'FIT_OK' in blocked_run.stdout


def test_ezsp_runs_without_jax_flax_orbax_h5py_yaml(blocked_run):
    """EZ-SP's stage 1 (`fit_partition`, checkpoints written) and stage-2
    preprocessing from its checkpoint, with the same imports blocked."""
    assert blocked_run.returncode == 0, blocked_run.stderr
    assert 'EZSP_OK' in blocked_run.stdout


def test_readers_and_spt3_run_without_jax_flax_h5py_yaml(blocked_run):
    """The DALES, KITTI-360 and ScanNet readers on the port's synthetic
    raw files, a DALES tile preprocessed into 4 levels and served by
    SPT-3 at full width, and `build_datasets` for the three datasets,
    with the same imports blocked."""
    assert blocked_run.returncode == 0, blocked_run.stderr
    assert 'READERS_OK' in blocked_run.stdout


def _imports(path):
    import ast
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


PORT_FILES = sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, fs in os.walk(os.path.join(REPO, 'superpoint_transformer_torch'))
    for f in fs if f.endswith('.py'))


@pytest.mark.parametrize('path', PORT_FILES)
def test_no_port_module_imports_the_jax_package(path):
    """Every import statement of every module of the port, those inside
    functions included: none names jax, flax, optax, orbax or the JAX
    package."""
    banned = ('jax', 'jaxlib', 'flax', 'optax', 'orbax',
              'superpoint_transformer_tpu')
    bad = [m for m in _imports(os.path.join(REPO, path))
           if m.split('.')[0] in banned]
    assert not bad, bad


def test_whole_cloud_serving_runs_without_jax_flax_h5py_yaml(blocked_run):
    """`preprocess_cloud(knn_backend='device')` on CPU tensors,
    `infer_nags_stacked` with a filled chunk and its warm-up,
    `e2e_inference` with the device KNN, the eigen features on tensors,
    a reference-format checkpoint imported into the flagship, and the
    allocator tuned at package import, with the same imports blocked."""
    assert blocked_run.returncode == 0, blocked_run.stderr
    assert 'SERVING_OK' in blocked_run.stdout


def test_native_library_is_the_ports_own_build(blocked_run):
    """The process that preprocessed the room mapped exactly one
    libspt_native: the port's build under `_build/`."""
    assert blocked_run.returncode == 0, blocked_run.stderr
    line = next(s for s in blocked_run.stdout.splitlines()
                if s.startswith('NATIVE_LIBS'))
    libs = json.loads(line[len('NATIVE_LIBS'):])
    assert libs == [os.path.join(REPO, 'superpoint_transformer_torch',
                                 '_build', 'libspt_native.so')], libs


BLOCKER = textwrap.dedent('''
    import sys

    BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'orbax',
               'superpoint_transformer_tpu')

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split('.')[0] in BLOCKED:
                raise ImportError(f'{name} is blocked')
            return None

    sys.meta_path.insert(0, Block())
''')

RANKS_SCRIPT = textwrap.dedent('''
    import sys
    import numpy as np
    from superpoint_transformer_torch import tune
    from superpoint_transformer_torch.parallel import (
        launch_multihost_dryrun, run_ranks)
    from superpoint_transformer_torch.parallel.multihost import worker_main

    if __name__ == '__main__':
        try:
            import jax  # noqa: F401
        except ImportError:
            pass
        else:
            raise SystemExit('the blocker is not installed')
        assert tune.sample({'a': tune.parse_space('uniform(0,1)')},
                           np.random.default_rng(0))['a'] < 1
        results = launch_multihost_dryrun(n_proc=1, n_dev=2, timeout=240)
        assert len(results) == 2 and results[0]['world_size'] == 2
        print('RANKS_OK', results[0]['loss'])
''')


def test_spawned_ranks_run_without_jax_flax(tmp_path):
    """Two spawned gloo ranks on the CPU, whose interpreters (and their
    parent's) cannot import jax, flax, optax, orbax or the JAX package
    (a `sitecustomize` on their PYTHONPATH blocks them), import
    `parallel/` and `tune.py` and run the all-reduces of one data-parallel
    step of the flagship (`launch_multihost_dryrun`)."""
    (tmp_path / 'sitecustomize.py').write_text(BLOCKER)
    script = tmp_path / 'ranks.py'
    script.write_text(RANKS_SCRIPT)
    env = dict(os.environ, OMP_NUM_THREADS='1',
               PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))
    out = subprocess.run([sys.executable, str(script)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'RANKS_OK' in out.stdout


NO_OPENMP_CXX = """#!/bin/sh
for a in "$@"; do
  if [ "$a" = -fopenmp ]; then
    echo "fatal error: cannot read spec file 'libgomp.spec'" >&2; exit 1
  fi
done
exec g++ "$@"
"""


def test_native_builds_without_openmp_where_the_compiler_has_none(
        tmp_path, monkeypatch):
    """A compiler without an OpenMP runtime (as on a machine whose g++
    lacks libgomp) still builds the library, without -fopenmp and with a
    warning, and the command that built it is recorded beside it."""
    cxx = tmp_path / 'cxx'
    cxx.write_text(NO_OPENMP_CXX)
    cxx.chmod(0o755)
    monkeypatch.setenv('CXX', str(cxx))
    with pytest.warns(UserWarning, match='no OpenMP runtime'):
        lib = native.build(build_dir=tmp_path, force=True)
    cmd = (tmp_path / 'libspt_native.so.cmd').read_text()
    assert lib.exists() and cmd.startswith(str(cxx))
    assert '-fopenmp' not in cmd and '-O3' in cmd and str(lib) in cmd


@pytest.mark.parametrize('cxx', ['/nonexistent/c++', 'false'],
                         ids=['missing_compiler', 'failing_compiler'])
def test_native_build_failure_raises(cxx, tmp_path, monkeypatch):
    """No silent fallback: a compiler that is missing or fails makes the
    build raise, naming the compiler or its command."""
    monkeypatch.setenv('CXX', cxx)
    with pytest.raises(RuntimeError, match='cannot build') as err:
        native.build(build_dir=tmp_path, force=True)
    assert cxx in str(err.value)
    assert not (tmp_path / 'libspt_native.so').exists()
