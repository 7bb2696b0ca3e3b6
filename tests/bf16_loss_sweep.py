"""How far the bf16 training loss lands from JAX's f32 loss, over several
room batches and weight draws: JAX jitted, JAX eager and the port, each in
bf16, and the port in f32, for the narrow semantic and panoptic tasks of
tests/test_torch_panoptic.py. It reads whether the port's bf16 loss is
farther from f32 than JAX's bf16 loss by a margin of its own, or as far
as JAX's two bf16 runs are from each other.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/bf16_loss_sweep.py \
        [--pairs 2] [--seeds 4]

from the repository's root (about 10 minutes on a CPU).

Prints one line per (room pair, weight seed, task), with each run's
signed distance, and a summary of the absolute distances.
"""
import argparse

import numpy as np
import torch

import jax

from superpoint_transformer_tpu.models.semantic import (
    SemanticTask as JSemantic)
from superpoint_transformer_tpu.models.spt import SPT as JSPT
from superpoint_transformer_tpu.transforms import prepare as jprep
from superpoint_transformer_torch.data.padded import from_numpy
from superpoint_transformer_torch.models.semantic import (
    SemanticTask as TSemantic)
from superpoint_transformer_torch.models.spt import SPT as TSPT
from superpoint_transformer_torch.utils.jax_params import load_jax_params
from test_torch_panoptic import (NUM_CLASSES, _jax_task, _port_task,
                                 _prepare, _room_pair)
from test_torch_train import HPARAMS, NARROW


def draw_params(model, batch, seed):
    """tests/test_torch_train.py's `_params`, from numpy seed `seed`."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), batch, train=False))['params']
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        r = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == 'kernel':
            return r / np.float32(np.sqrt(leaf.shape[0]))
        return r * np.float32(0.1) + np.float32(name in ('weight',
                                                         'mean_scale'))

    return jax.tree_util.tree_map_with_path(draw, shapes)


TASKS = {
    'semantic': (
        lambda cd: JSemantic(net=JSPT(compute_dtype=cd, **NARROW),
                             num_classes=NUM_CLASSES, **HPARAMS),
        lambda cd: TSemantic(TSPT(compute_dtype=cd, **NARROW),
                             num_classes=NUM_CLASSES, **HPARAMS)),
    'panoptic': (_jax_task, _port_task),
}


def losses(task_name, batch, seed):
    """{run: training loss at the drawn weights}."""
    make_jax, make_port = TASKS[task_name]
    params = draw_params(make_jax(None).model, batch, seed)
    rng = jax.random.PRNGKey(0)
    out = {}
    for cd, tag in ((None, 'f32'), ('bfloat16', 'bf16')):
        task = make_jax(cd)
        fn = lambda p: task._loss_fn(p, batch, rng)[0]  # noqa: E731
        out[f'jax {tag} jit'] = float(jax.jit(fn)(params))
        if cd is not None:
            with jax.disable_jit():
                out[f'jax {tag} eager'] = float(fn(params))
        port = make_port(cd)
        load_jax_params(port.model, params)
        port.model.train()
        with torch.no_grad():
            out[f'port {tag}'] = port.loss(
                from_numpy(batch, 'cpu', cd, train=True))[0].item()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--pairs', type=int, default=2,
                    help='room pairs (seeds 2i, 2i+1)')
    ap.add_argument('--seeds', type=int, default=4, help='weight draws')
    args = ap.parse_args()
    keys = ('jax bf16 jit', 'jax bf16 eager', 'port bf16', 'port f32')
    dist = {t: {k: [] for k in keys} for t in TASKS}
    for pair in range(args.pairs):
        rooms = [_room_pair(2 * pair), _room_pair(2 * pair + 1)]
        batch = _prepare(jprep, [r[0] for r in rooms], train=False)
        for seed in range(args.seeds):
            for t in TASKS:
                out = losses(t, batch, seed)
                ref = out['jax f32 jit']
                d = {k: out[k] - ref for k in keys}
                for k in keys:
                    dist[t][k].append(abs(d[k]))
                print(f'rooms {2 * pair},{2 * pair + 1} weights {seed} '
                      f'{t}: f32 loss {ref:.4f}; loss - f32 loss: '
                      + ', '.join(f'{k} {d[k]:+.4f}' for k in keys),
                      flush=True)
    for t in TASKS:
        print(f'{t}: ' + '; '.join(
            f'{k} mean {np.mean(v):.4f} max {np.max(v):.4f}'
            for k, v in dist[t].items()))
        port, jit = np.array(dist[t]['port bf16']), np.array(
            dist[t]['jax bf16 jit'])
        print(f'{t}: port bf16 farther than JAX jitted bf16 in '
              f'{int((port > jit).sum())} of {len(port)} draws, beyond '
              f'1.5x of it in {int((port > 1.5 * jit).sum())}')


if __name__ == '__main__':
    main()
