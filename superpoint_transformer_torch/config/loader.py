"""Hydra-style YAML config composition; counterpart of
`superpoint_transformer_tpu/config/loader.py`, with the same grammar:

  - `defaults:` lists (compose group files, `override /group: file`)
  - `${a.b.c}` interpolation
  - `${eval:'<python expr>'}` arithmetic/list-comprehension resolver
  - dotted CLI overrides `model.optimizer.lr=0.1`,
    `experiment=semantic/s3dis`

Values are parsed by PyYAML's `safe_load` (YAML 1.1), so `1e-2`, which
has no dot, stays a string, as in JAX; `build_task` converts. PyYAML is
imported by `load_config` only: the package imports without it.
"""
import copy
import os.path as osp
import re

__all__ = ['Config', 'load_config']

_INTERP = re.compile(r'\$\{([^${}]+)\}')


class Config(dict):
    """dict with attribute access and dotted-path get/set."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def get_path(self, path, default=None):
        node = self
        for part in path.split('.'):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, path, value):
        parts = path.split('.')
        node = self
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = value


def _to_config(obj):
    if isinstance(obj, dict):
        return Config({k: _to_config(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_to_config(v) for v in obj]
    return obj


def _merge(base, new):
    """Deep-merge new into base (new wins)."""
    for k, v in new.items():
        if (k in base and isinstance(base[k], dict)
                and isinstance(v, dict)):
            _merge(base[k], v)
        else:
            base[k] = copy.deepcopy(v)
    return base


def _load_yaml_file(config_dir, rel):
    import yaml
    path = osp.join(config_dir, rel)
    if not path.endswith('.yaml'):
        path += '.yaml'
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return raw


def _compose(config_dir, rel, overrides_defaults=None):
    """Load a YAML file and recursively compose its `defaults:`."""
    raw = _load_yaml_file(config_dir, rel)
    package = raw.pop('_package_', None)
    defaults = raw.pop('defaults', [])
    out = Config()
    group_dir = osp.dirname(rel)
    for d in defaults:
        if d == '_self_':
            _merge(out, _to_config(raw))
            raw = {}
            continue
        if isinstance(d, str):
            # '/group/name' resolves from the config root
            rel_d = d[1:] if d.startswith('/') else osp.join(group_dir, d)
            sub = _compose(config_dir, rel_d)
            _merge(out, sub)
            continue
        # {group: name} or {override /group: name}
        (key, name), = d.items()
        if name is None:
            continue
        key = key.replace('override ', '')
        if key.startswith('/'):
            group, target = key[1:], key[1:]
            sub_rel = osp.join(group, name)
        else:
            group = key
            sub_rel = osp.join(group_dir, group, name) \
                if not key.startswith('/') else osp.join(key[1:], name)
            target = group
        sub = _compose(config_dir, sub_rel)
        # place under the group key unless the file is @_global_
        node = Config()
        node.set_path(target.replace('/', '.'), sub)
        _merge(out, node if not sub.pop('_global_', False) else sub)
    _merge(out, _to_config(raw))
    if package:
        node = Config()
        node.set_path(package, out)
        return node
    return out


def _resolve(cfg, root=None, depth=0):
    """Resolve ${...} interpolations to fixpoint."""
    root = root if root is not None else cfg
    if depth > 20:
        return cfg

    def resolve_value(v):
        if isinstance(v, str):
            return _resolve_str(v, root)
        if isinstance(v, dict):
            return Config({k: resolve_value(x) for k, x in v.items()})
        if isinstance(v, list):
            return [resolve_value(x) for x in v]
        return v

    out = resolve_value(cfg)
    if repr(out) != repr(cfg):
        return _resolve(out, root, depth + 1)
    return out


def _resolve_str(s, root):
    # eval resolver
    m = re.fullmatch(r"\$\{eval:'(.*)'\}", s, re.DOTALL) or \
        re.fullmatch(r'\$\{eval:"(.*)"\}', s, re.DOTALL) or \
        re.fullmatch(r'\$\{eval:(.*)\}', s, re.DOTALL)
    if m:
        expr = m.group(1)
        expr = _INTERP.sub(lambda mm: repr(
            root.get_path(mm.group(1))), expr)
        try:
            return eval(expr, {'__builtins__': {}},
                        {'ListConfig': list, 'None': None,
                         'min': min, 'max': max, 'sum': sum,
                         'len': len, 'list': list, 'set': set,
                         'sorted': sorted, 'int': int, 'float': float})
        except Exception:
            return s
    # full-string reference: preserve type
    m = re.fullmatch(_INTERP, s)
    if m:
        v = root.get_path(m.group(1))
        return v if v is not None else s
    # embedded references in a string

    def repl(mm):
        v = root.get_path(mm.group(1))
        return str(v) if v is not None else mm.group(0)

    return _INTERP.sub(repl, s)


def _parse_override_value(v):
    import yaml
    try:
        return yaml.safe_load(v)
    except Exception:
        return v


def load_config(config_dir, name='train', overrides=()):
    """Compose `<config_dir>/<name>.yaml` + overrides, resolve
    interpolations. `experiment=<x>` overrides compose
    `experiment/<x>.yaml` on top (reference CLI grammar)."""
    cfg = _compose(config_dir, name)
    kv = []
    for ov in overrides:
        key, _, val = ov.partition('=')
        if key == 'experiment':
            exp = _compose(config_dir, osp.join('experiment', val))
            _merge(cfg, exp)
        else:
            kv.append((key, _parse_override_value(val)))
    for key, val in kv:
        cfg.set_path(key, _to_config(val))
    return _resolve(cfg)
