"""What a run loads: nothing of JAX or the JAX package, and the plain
reference nothing of the measured program; and without a card the run
command prints no result and exits non-zero, never falling back to the
CPU."""
import json
import os
import subprocess
import sys

from benchmark import run as run_py

from bench_util import REPO

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax',
             'superpoint_transformer_tpu')


def _python(code, env=None):
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def _env(**kw):
    env = dict(os.environ)
    env.pop('JAX_PLATFORMS', None)
    env.update(kw)
    return env


def test_the_forbidden_list_is_the_run_commands():
    assert set(run_py.FORBIDDEN) == set(FORBIDDEN)


def test_a_run_loads_nothing_of_jax_or_the_jax_package(tmp_path):
    code = f'''
import json, sys, time
sys.path.insert(0, {REPO!r}); sys.path.insert(0, {REPO + "/benchmark/tests"!r})
from bench_util import bench, tiny_root, clock
import pathlib
from benchmark.harness.runner import run_cell
root = tiny_root(pathlib.Path({str(tmp_path)!r}))
run_cell(bench(), 'spt2_s3dis.train', 3, 0.3, 1, 'cpu', clock(), root=root)
run_cell(bench(), 'spt3_dales.serve', 3, 0.3, 0, 'cpu', clock(), root=root)
from benchmark.run import loaded_forbidden
print(json.dumps(loaded_forbidden()))
'''
    assert json.loads(_python(code, _env())) == []


def test_the_reference_loads_nothing_of_the_program():
    code = f'''
import json, sys
sys.path.insert(0, {REPO!r})
import benchmark.reference.spt
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
'''
    tops = set(json.loads(_python(code, _env())))
    assert 'superpoint_transformer_torch' not in tops
    assert not tops & set(FORBIDDEN)


def test_without_a_card_the_run_prints_nothing_and_fails():
    # hide any card, so that this holds on a machine with one too
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload',
         'spt2_s3dis.train', '--seed', '1', '--seconds', '1', '--trace', '0'],
        cwd=REPO, env=_env(CUDA_VISIBLE_DEVICES=''), capture_output=True,
        text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
    assert 'CUDA' in out.stderr


def test_in_a_directory_of_the_benchmark_alone_the_run_fails(tmp_path):
    import shutil
    shutil.copy(os.path.join(REPO, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(os.path.join(REPO, 'benchmark'), tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload',
         'spt3_dales.serve', '--seed', '1', '--seconds', '1', '--trace', '0'],
        cwd=tmp_path, env=_env(PYTHONPATH=''), capture_output=True,
        text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
