"""The port needs none of jax, flax, optax, h5py, yaml or the JAX
package: in a fresh interpreter where importing any of them fails, the
port still imports every module, builds a model and runs a CPU forward,
and builds the semantic task and takes a CPU training step."""
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent('''
    import sys

    BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'h5py', 'yaml',
               'superpoint_transformer_tpu')

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split('.')[0] in BLOCKED:
                raise ImportError(f'{name} is blocked')
            return None

    sys.meta_path.insert(0, Block())

    import importlib
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
        build_model(FLAGSHIP_CFG, num_graphs=2), 13)
    init_weights(model, torch.Generator().manual_seed(0)).eval()
    batch = from_numpy(random_padded_nag(seed=0, num_graphs=2,
                                         n_points=500, n_l1=40, n_l2=10),
                       'cpu', 'bfloat16')
    pred = infer_batch(model, batch)
    assert pred.shape == (batch[1].num_nodes,)
    assert pred.min() >= 0 and pred.max() < 13

    task = build_task(FLAGSHIP_CFG, num_graphs=2, total_steps=10)
    init_weights(task.model, torch.Generator().manual_seed(0))
    host = random_padded_nag(seed=1, num_graphs=2, n_points=500, n_l1=40,
                             n_l2=10)
    metrics = task.train_step(from_numpy(host, 'cpu', 'bfloat16',
                                         train=True))
    assert bool(torch.isfinite(metrics['loss'])) and task.step == 1
    loaded = sorted(m for m in sys.modules
                    if m.split('.')[0] in BLOCKED)
    assert not loaded, loaded
    print('PORT_OK')
''')


def test_port_runs_without_jax_flax_h5py_yaml():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, '-c', SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert 'PORT_OK' in res.stdout
