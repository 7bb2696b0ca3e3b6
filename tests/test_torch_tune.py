"""The port's hyperparameter search (`superpoint_transformer_torch/
tune.py`) against the JAX package's `tune.py`: the same space grammar and
the same draws for a seed, and a 2-trial search over the port's training
entry point (the JAX tests/test_cli.py:105)."""
import json

import numpy as np
import pytest

import tune as jtune
from superpoint_transformer_torch import tune as ttune
from test_cli import _overrides
from test_datasets import make_raw_s3dis
from test_torch_trainer import one_torch_thread  # noqa: F401

SPECS = {'model.optimizer.lr': 'loguniform(1e-3, 0.5)',
         'model.optimizer.weight_decay': 'choice(1e-4,1e-3,1e-2)',
         'model.transformer_lr_scale': 'uniform(0.05,0.2)',
         'model.loss_type': 'choice(ce_kl, "wce_kl", 3)'}
# narrow SPT-2 in f32 on the CPU, as tests/test_torch_cli.py runs it
NARROW = ['model._point_mlp=[16,32,32]', 'model._down_dim=[32,32]',
          'model._up_dim=[32]', 'model.net.down_num_heads=4',
          'model.net.up_num_heads=4', 'trainer.precision=32', 'device=cpu']


@pytest.mark.parametrize('key', sorted(SPECS))
def test_parse_space_matches_jax(key):
    assert ttune.parse_space(SPECS[key]) == jtune.parse_space(SPECS[key])


@pytest.mark.parametrize('spec', ['normal(0,1)', 'uniform', 'lr=0.1'])
def test_parse_space_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError):
        jtune.parse_space(spec)
    with pytest.raises(ValueError):
        ttune.parse_space(spec)


@pytest.mark.parametrize('seed', [0, 7])
def test_sample_draws_the_jax_trials(seed):
    """Ten draws of the whole space from one seed: the same values, in
    the same order, as JAX's `sample`."""
    space = {k: jtune.parse_space(v) for k, v in SPECS.items()}
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(10):
        assert ttune.sample(space, rt) == jtune.sample(space, rj)


def test_failed_trial_is_kept_with_no_score(tmp_path):
    """A trial that raises is recorded with score None and the search
    goes on; the best of the others is returned. Every trial gets its
    own output_dir and the passthrough overrides."""
    seen = []

    def train_main(overrides):
        seen.append(overrides)
        if len(seen) == 1:
            raise RuntimeError('diverged')
        return 0.5 * len(seen)

    best = ttune.main(['n_trials=3', f'tune_dir={tmp_path}', 'seed=3',
                       'trainer.max_epochs=1',
                       'space.model.optimizer.lr=uniform(0.1,0.2)'],
                      train_main=train_main)
    res = json.load(open(tmp_path / 'tune_results.json'))
    assert [r['score'] for r in res] == [None, 1.0, 1.5]
    assert best == res[2]
    assert seen[1][:2] == ['seed=3', 'trainer.max_epochs=1']
    assert seen[1][-1] == f'output_dir={tmp_path}/trial_1'
    with pytest.raises(SystemExit):
        ttune.main(['n_trials=1'], train_main=train_main)


def test_tune_random_search(tmp_path):
    """2 trials through the port's `train.main` on a tiny S3DIS tree:
    tune_results.json holds both, their learning rates are JAX's draws
    for seed 0, and the best trial is the highest score."""
    root = str(tmp_path / 's3dis')
    make_raw_s3dis(root)
    best = ttune.main(
        _overrides(root, str(tmp_path / 'out')) + NARROW
        + ['n_trials=2', f'tune_dir={tmp_path}/tune',
           'space.model.optimizer.lr=loguniform(1e-3,1e-1)'])
    res = json.load(open(tmp_path / 'tune' / 'tune_results.json'))
    assert len(res) == 2 and all(np.isfinite(r['score']) for r in res)
    assert best == max(res, key=lambda r: r['score'])
    rng = np.random.default_rng(0)
    space = {'model.optimizer.lr': jtune.parse_space('loguniform(1e-3,1e-1)')}
    assert [r['params'] for r in res] == [jtune.sample(space, rng)
                                          for _ in range(2)]
    assert (tmp_path / 'tune' / 'trial_1' / 'checkpoints' / 'last'
            / 'state.pt').exists()
