"""Hyperparameter search over the port's training entry point; the
counterpart of the JAX package's `tune.py`, with its grammar:

    python -m superpoint_transformer_torch.tune experiment=semantic/s3dis \
        n_trials=8 'space.model.optimizer.lr=loguniform(1e-3,0.5)' \
        'space.model.optimizer.weight_decay=choice(1e-4,1e-3,1e-2)' \
        [trainer.max_epochs=50 ...] [device=cpu]

Random search: each trial draws the declared space, runs `train.main`
with the drawn overrides, and the best trial (the highest score `main`
returns: the best validation mIoU, or PQ) is printed and returned. Every
trial's parameters and score go to `<tune_dir>/tune_results.json`
(`tune_dir` defaults to `outputs/tune`); a trial that raises is kept with
`score: None`.
"""
import json
import os
import os.path as osp
import re
import sys

import numpy as np

__all__ = ['parse_space', 'sample', 'main']


def parse_space(spec):
    """'loguniform(a,b)' | 'uniform(a,b)' | 'choice(x,y,...)' ->
    (kind, (lo, hi)) or (kind, [values])."""
    m = re.fullmatch(r'(\w+)\((.*)\)', spec.strip())
    if not m:
        raise ValueError(f'bad search-space spec: {spec}')
    kind, args = m.group(1), [a.strip() for a in m.group(2).split(',')]
    if kind in ('uniform', 'loguniform'):
        return kind, (float(args[0]), float(args[1]))
    if kind == 'choice':
        vals = []
        for a in args:
            try:
                vals.append(json.loads(a))
            except ValueError:
                vals.append(a)
        return kind, vals
    raise ValueError(f'unknown space kind: {kind}')


def sample(space, rng):
    """One draw of every key of `space` from the numpy generator `rng`,
    in the space's order (the JAX `sample`'s draws, so a seed gives the
    same trials in both packages)."""
    out = {}
    for key, (kind, arg) in space.items():
        if kind == 'uniform':
            out[key] = float(rng.uniform(*arg))
        elif kind == 'loguniform':
            lo, hi = np.log(arg[0]), np.log(arg[1])
            out[key] = float(np.exp(rng.uniform(lo, hi)))
        else:
            out[key] = arg[int(rng.integers(len(arg)))]
    return out


def main(argv=None, train_main=None):
    """Run the search of `argv`; returns the best trial's record
    ({'trial', 'params', 'score'}), or None when every trial failed.
    `train_main(overrides)` runs one trial and returns its score; the
    port's `train.main` by default."""
    argv = list(argv if argv is not None else sys.argv[1:])
    space, passthrough, n_trials, seed = {}, [], 10, 0
    out_root = 'outputs/tune'
    for a in argv:
        key, _, val = a.partition('=')
        if key == 'n_trials':
            n_trials = int(val)
        elif key == 'tune_dir':
            out_root = val
        elif key == 'seed':
            seed = int(val)
            passthrough.append(a)
        elif key.startswith('space.'):
            space[key[len('space.'):]] = parse_space(val)
        else:
            passthrough.append(a)
    if not space:
        raise SystemExit('declare at least one space.<key>=... range')
    if train_main is None:
        from .train import main as train_main

    rng = np.random.default_rng(seed)
    results = []
    for t in range(n_trials):
        params = sample(space, rng)
        overrides = passthrough + [f'{k}={v}' for k, v in params.items()] \
            + [f'output_dir={out_root}/trial_{t}']
        print(f'[trial {t}] {params}')
        try:
            score = train_main(overrides)
        except Exception as e:  # noqa: BLE001 - a failed trial is data
            print(f'[trial {t}] FAILED: {type(e).__name__}: {e}')
            score = None
        results.append({'trial': t, 'params': params,
                         'score': None if score is None else float(score)})
        os.makedirs(out_root, exist_ok=True)
        with open(osp.join(out_root, 'tune_results.json'), 'w') as f:
            json.dump(results, f, indent=1)
    ok = [r for r in results if r['score'] is not None]
    if not ok:
        return None
    best = max(ok, key=lambda r: r['score'])
    print(f"best trial {best['trial']}: score={best['score']:.4f} "
          f"params={best['params']}")
    return best


if __name__ == '__main__':
    main()
