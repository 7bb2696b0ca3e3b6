"""The port covers the JAX package's public surface: for every module of
`superpoint_transformer_tpu/` with an `__all__`, each name in it has a
counterpart of the same name in the module at the same path under
`superpoint_transformer_torch/` (defined or imported there), and each
public method or property of each class in it has one of the same name on
the port's class (its own or inherited from a port class). What has no
counterpart of that name is in MAPPED, with where the port does it and
why. So a new JAX export, or a method added to an exported class, fails
here by name until it is ported or mapped.

Both packages are parsed with `ast`; nothing is imported. The package
`__init__` files re-export names without an `__all__` and are not part of
the checked surface; the port's import from the modules themselves."""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(REPO, 'superpoint_transformer_tpu')
PORT = os.path.join(REPO, 'superpoint_transformer_torch')

# 'JAX module:name' or 'JAX module:Class.method' -> (the port's
# counterparts as 'port module:name', the reason it has another name)
MAPPED = {
    'ops/pallas_attention.py:dense_attention_pallas': (
        ['ops/attention.py:dense_attention'],
        'the Pallas K1 forward; its CUDA port is the K1 wrapper'),
    'ops/pallas_attention.py:dense_attention_pallas_trainable': (
        ['ops/attention.py:dense_attention_trainable'],
        "K1 with JAX's closed-form VJP: the CUDA forward and backward"),
    'nn/attention.py:dense_graph_attention': (
        ['ops/attention.py:dense_attention_reference'],
        "JAX's XLA attention over dense neighbors: K1's plain version "
        '(without the unused nbr_idx argument)'),
    'parallel/mesh.py:stack_batches': (
        ['parallel/mesh.py:make_dp_train_step'],
        'no stacked device axis over torch.distributed: each rank passes '
        'its own batch to the step'),
    'parallel/mesh.py:shard_batch': (
        ['data/padded.py:from_numpy', 'parallel/mesh.py:make_data_mesh'],
        "each rank puts its own batch on its own device (the mesh's)"),
    'models/semantic.py:TrainState': (
        ['models/semantic.py:SemanticTask.state_dict',
         'models/semantic.py:SemanticTask.load_state_dict'],
        'the task owns its parameters, optimizer and step counts; their '
        'state is the task state_dict'),
    'models/semantic.py:SemanticTask.init_state': (
        ['models/semantic.py:SemanticTask.__init__',
         'nn/mlp.py:init_weights'],
        'the task builds its model and optimizer when it is made; '
        'init_weights draws weights from a torch.Generator'),
    'models/partition.py:PartitionTask.init_state': (
        ['models/partition.py:PartitionTask.__init__',
         'nn/mlp.py:init_weights'],
        'as SemanticTask.init_state'),
    'utils/jax_setup.py:setup_jax': (
        [], 'configures JAX (its compilation cache and platform) only'),
    'utils/profiling.py:timer': (
        ['utils/profiling.py:Timings'],
        'a block timer that printed its seconds, with no caller in the '
        'port; Timings.track times a block, annotate names it in a trace'),
}


def _parse(path):
    """(`__all__` or None, top-level names, {class: (base names, public
    method names)}) of a module."""
    tree = ast.parse(open(path).read())
    exported, names, classes = None, set(), {}
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == '__all__':
                        exported = [e.value for e in node.value.elts]
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            bases = [b.id if isinstance(b, ast.Name) else
                     getattr(b, 'attr', None) for b in node.bases]
            methods = {b.name for b in node.body
                       if isinstance(b, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
            classes[node.name] = (bases, methods)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                names.add((a.asname or a.name).split('.')[0])
    return exported, names, classes


def _modules(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith('.py'):
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = _parse(p)
    return out


JAX_MODULES = _modules(JAX)
PORT_MODULES = _modules(PORT)
# every class of the port by name, to follow inheritance across modules
PORT_CLASSES = {}
for _, _, _classes in PORT_MODULES.values():
    for _name, _cls in _classes.items():
        PORT_CLASSES.setdefault(_name, []).append(_cls)


def _port_methods(name, seen=()):
    """The methods of the port's class `name` and of its port bases."""
    out = set()
    for bases, methods in PORT_CLASSES.get(name, []):
        out |= methods
        for b in bases:
            if b and b not in seen:
                out |= _port_methods(b, seen + (name,))
    return out


def _surface(mod):
    """The checked keys of JAX module `mod`: 'mod:name' for each name of
    its `__all__` and 'mod:Class.method' for each public method of each
    class there."""
    exported, _, classes = JAX_MODULES[mod]
    keys = []
    for name in exported or ():
        keys.append(f'{mod}:{name}')
        for m in sorted(classes.get(name, ((), ()))[1]):
            if not m.startswith('_'):
                keys.append(f'{mod}:{name}.{m}')
    return keys


def _in_port(key):
    mod, name = key.split(':')
    if mod not in PORT_MODULES:
        return False
    _, names, classes = PORT_MODULES[mod]
    if '.' not in name:
        return name in names
    cls, method = name.split('.')
    # the class may be defined in the module or imported into it
    return cls in names and method in _port_methods(cls)


def _mapped(key):
    """`key`, or the class it is a method of, is in MAPPED."""
    return key in MAPPED or key.split('.')[0] in MAPPED


EXPORTING = sorted(m for m, (exported, _, _) in JAX_MODULES.items()
                   if exported)
SURFACE = [k for mod in EXPORTING for k in _surface(mod)]


@pytest.mark.parametrize('mod', EXPORTING)
def test_jax_public_names_have_port_counterparts(mod):
    missing = [k for k in _surface(mod) if not _mapped(k)
               and not _in_port(k)]
    assert not missing, (
        f'no counterpart of that name in the port for {missing}: port '
        'them, or map them in MAPPED with the reason')


@pytest.mark.parametrize('key', sorted(MAPPED))
def test_mapping_is_needed_and_points_at_the_port(key):
    """Each mapped JAX name is on the checked surface, has no port
    counterpart of its own name, and each counterpart it names exists."""
    targets, reason = MAPPED[key]
    assert key in SURFACE, f'{key} is not a JAX export (stale entry)'
    assert not _in_port(key), f'{key} is ported under its name: unmap it'
    assert reason
    for t in targets:
        assert _in_port(t), f'{key}: the counterpart {t} does not exist'


def test_surface_is_large():
    """The walk sees the whole package (a broken parse would pass every
    case above vacuously)."""
    assert len(EXPORTING) > 70 and len(SURFACE) > 400
