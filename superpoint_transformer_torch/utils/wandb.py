"""Weights & Biases run logging; counterpart of `WandbRun`,
`confusion_matrix_figure` and `save_confusion_matrix_png` in
`superpoint_transformer_tpu/utils/wandb.py`.

The `wandb` package is used when it imports; otherwise, as in JAX, a
local run writes the same rows to `<output_dir>/wandb/history.jsonl` and
the figures as PNG files, so a run never needs the network.
"""
import json
import os
import os.path as osp

import numpy as np

__all__ = ['WandbRun', 'confusion_matrix_figure',
           'save_confusion_matrix_png']


def confusion_matrix_figure(cm, class_names=None, normalize='true'):
    """Row-normalized confusion-matrix heatmap with count annotations
    (matplotlib, imported here)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    cm = np.asarray(cm, dtype=np.float64)
    n = cm.shape[0]
    names = list(class_names) if class_names else [str(i) for i in range(n)]
    shown = cm / np.maximum(cm.sum(1, keepdims=True), 1) \
        if normalize == 'true' else cm
    fig, ax = plt.subplots(figsize=(max(6, n * 0.6), max(5, n * 0.55)))
    im = ax.imshow(shown, cmap='viridis', vmin=0, vmax=shown.max() or 1)
    ax.set_xticks(range(n))
    ax.set_yticks(range(n))
    ax.set_xticklabels(names, rotation=45, ha='right', fontsize=8)
    ax.set_yticklabels(names, fontsize=8)
    ax.set_xlabel('predicted')
    ax.set_ylabel('ground truth')
    thresh = (shown.max() or 1) / 2
    for i in range(n):
        for j in range(n):
            if cm[i, j]:
                ax.text(j, i, f'{int(cm[i, j])}', ha='center',
                        va='center', fontsize=7,
                        color='white' if shown[i, j] < thresh else 'black')
    fig.colorbar(im, ax=ax, shrink=0.8)
    fig.tight_layout()
    return fig


def save_confusion_matrix_png(cm, path, class_names=None):
    """Write `confusion_matrix_figure(cm)` to the PNG file `path` (its
    directory made if needed); returns `path`. Needs matplotlib."""
    import matplotlib.pyplot as plt
    fig = confusion_matrix_figure(cm, class_names=class_names)
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


class WandbRun:
    """A wandb run when the package imports, else local JSONL and PNG
    files under `<output_dir>/wandb/`."""

    def __init__(self, output_dir, project='spt', name=None, config=None):
        self.dir = osp.join(output_dir, 'wandb')
        os.makedirs(self.dir, exist_ok=True)
        self._wb = None
        try:
            import wandb
            self._wb = wandb.init(
                project=project, name=name, config=config or {},
                dir=self.dir, mode=os.environ.get('WANDB_MODE', 'offline'))
        except Exception:
            self._history = open(osp.join(self.dir, 'history.jsonl'), 'a')
            if config:
                with open(osp.join(self.dir, 'config.json'), 'w') as f:
                    json.dump(dict(config), f, indent=2, default=str)

    def log(self, row, step=None):
        row = {k: (float(v) if isinstance(v, (int, float, np.floating,
                                              np.integer)) else v)
               for k, v in row.items() if not hasattr(v, 'savefig')}
        if self._wb is not None:
            self._wb.log(row, step=step)
            return
        if step is not None:
            row = {**row, '_step': int(step)}
        self._history.write(json.dumps(row, default=str) + '\n')
        self._history.flush()

    def log_figure(self, name, fig, step=None):
        if self._wb is not None:
            import wandb
            self._wb.log({name: wandb.Image(fig)}, step=step)
            return
        tag = f'_{step}' if step is not None else ''
        fig.savefig(osp.join(self.dir, f'{name.replace("/", "_")}{tag}.png'),
                    dpi=120)

    def finish(self):
        if self._wb is not None:
            self._wb.finish()
        elif hasattr(self, '_history'):
            self._history.close()
