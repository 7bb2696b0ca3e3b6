"""The bound arithmetic of `chip_smoke.py`, without a card: the bytes and
FLOPs of one call of each kernel at the flagship shapes, and which of the
two bounds it. The script imports nothing but the standard library at
module level, so it imports here."""
import contextlib
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

FLAGSHIP = dict(H=16, D=4, C=64)


@pytest.mark.parametrize('grad', [None, 0, 1, 2, 3],
                         ids=['exact', 'dq', 'dk', 'dv', 'dscale'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_hold_k1_backward_catches_each_gradient(monkeypatch, dtype, grad):
    """`hold_k1_backward` on the CPU (the closed form vs autograd of the
    plain version) passes as it is and raises when one of dq, dk, dv,
    dscale is 5% off, in both dtypes."""
    import torch
    from superpoint_transformer_torch.ops import attention
    gen = torch.Generator().manual_seed(0)
    args = chip_smoke.k1_inputs(gen, N=64, K=20, H=4, D=4, CH=4,
                                q_per_edge=True, masked_rows=4,
                                dtype=getattr(torch, dtype), dev='cpu')
    if grad is None:
        chip_smoke.hold_k1_backward('exact', args, gen)
        return
    bwd = attention.dense_attention_bwd

    def off(*a, **kw):
        out = list(bwd(*a, **kw))
        out[grad] = (out[grad].float() * 1.05).to(out[grad].dtype)
        return tuple(out)

    monkeypatch.setattr(attention, 'dense_attention_bwd', off)
    with pytest.raises(AssertionError):
        chip_smoke.hold_k1_backward('off', args, gen)


@pytest.mark.parametrize('name, shape, mbytes, gflop', [
    # serving level 1: kvg 12 KB, ef 3 KB, q, mask, scale, f32 out a node
    ('K2', dict(N=10_240, K=48, De=32), 162, 6.26),
    # training level 1, per-edge q: q, k, v 6 KB each a node
    ('K1', dict(N=5_120, K=48), 96, 0.0786),
    # K2's inputs, out, lse and g in; dq, dkg, dvg, d_ef out
    ('K3', dict(N=5_120, K=48, De=32), 162, 9.23)],
    ids=['K2', 'K1', 'K3'])
def test_flagship_bytes_and_flops(name, shape, mbytes, gflop):
    nbytes, prod, other = chip_smoke.kernel_cost(name, **shape, **FLAGSHIP)
    assert nbytes / 1e6 == pytest.approx(mbytes, rel=1e-2)
    assert (prod + other) / 1e9 == pytest.approx(gflop, rel=1e-2)
    ms, by = chip_smoke.bound(name, **shape, **FLAGSHIP)
    assert by == 'bytes'
    assert ms == pytest.approx(nbytes / chip_smoke.PEAK_BYTES_S * 1e3)


def test_k1_query_per_node_reads_one_query_row_a_node():
    shape = dict(N=5_120, K=48, **FLAGSHIP)
    edge = chip_smoke.kernel_cost('K1', **shape)[0]
    node = chip_smoke.kernel_cost('K1', **shape, q_per_edge=False)[0]
    assert edge - node == 5_120 * (48 - 1) * 64 * 2


def test_bound_takes_operations_when_they_dominate(monkeypatch):
    """On a card whose memory were 100x faster, K2's projections on the
    tensor cores and its f32 work would bound it."""
    shape = dict(N=10_240, K=48, De=32, **FLAGSHIP)
    monkeypatch.setattr(chip_smoke, 'PEAK_BYTES_S', 335e12)
    nbytes, prod, other = chip_smoke.kernel_cost('K2', **shape)
    ms, by = chip_smoke.bound('K2', **shape)
    op_ms = (prod / chip_smoke.PEAK_BF16_FLOP_S
             + other / chip_smoke.PEAK_F32_FLOP_S) * 1e3
    assert by == 'operations' and ms == pytest.approx(op_ms)
    assert op_ms > nbytes / 335e12 * 1e3


@pytest.fixture(scope='module')
def flagship_cpu():
    """The flagship model (eval) and task on the CPU, and a small random
    3-graph batch for each."""
    import torch
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.experiment import (
        FLAGSHIP_CFG, build_model, build_task)
    from superpoint_transformer_torch.models.semantic import (
        SemanticSegmentationModel)
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.utils.synthetic import (
        random_padded_nag)
    model = SemanticSegmentationModel(build_model(
        FLAGSHIP_CFG, num_graphs=3, device='cpu'), 13, device='cpu')
    init_weights(model, torch.Generator().manual_seed(0))
    task = build_task(FLAGSHIP_CFG, num_graphs=3, device='cpu')
    host = random_padded_nag(seed=0, num_graphs=3, n_points=400, n_l1=50,
                             n_l2=12)
    cd = model.net.compute_dtype
    return (model.eval(), task, from_numpy(host, 'cpu', cd),
            from_numpy(host, 'cpu', cd, train=True))


@pytest.mark.parametrize('name, fn', [
    ('K2', 'dense_attention_rpe'), ('K1', 'dense_attention_trainable')],
    ids=['K2_serving', 'K1_training'])
def test_widest_call_keeps_level1_inputs(flagship_cpu, monkeypatch, name,
                                         fn):
    """`widest_call` keeps the arguments of the level-1 call (the most
    rows) of the path's kernel, puts the block's function back, and
    `hold_on_path` holds the kernel's wrapper to its plain version on
    them (on the CPU the wrapper runs the plain version)."""
    import torch
    from superpoint_transformer_torch.inference import infer_batch
    from superpoint_transformer_torch.nn import attention as block
    model, task, batch, train_batch = flagship_cpu
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda: None)
    before = getattr(block, fn)
    with chip_smoke.widest_call(fn) as kept:
        if name == 'K2':
            infer_batch(model, batch)
        else:
            task.train_step(train_batch)
    assert getattr(block, fn) is before
    mask = next(a for a in kept if a.dtype == torch.bool)
    assert mask.shape == batch[1].nbr_mask.shape
    assert not any(a.requires_grad for a in kept)
    chip_smoke.hold_on_path(name, kept)


def test_random_twins_at_the_batch_counts(flagship_cpu):
    """The random twins have the batch's node counts, one at its own
    bucketed capacities and one at the batch's."""
    batch = flagship_cpu[2]
    n, caps, _ = chip_smoke.level_counts(batch)
    twins = chip_smoke.random_twins(batch, 1, 3, None, train=False)
    own, same = (chip_smoke.level_counts(twins[k])
                 for k in ('random, own caps', 'random, same caps'))
    assert same[1] == caps
    for counts_ in (own[0], same[0]):
        assert all(abs(a - b) <= 0.25 * b for a, b in zip(counts_, n))


def _rehearse_on_the_cpu(monkeypatch):
    """Stub the card-only calls of the phases (synchronize, the
    profiler, the memory statistics) and count each CPU call of an
    attention entry point as a launch of its kernel, as the wrapper
    counts one on the card."""
    import torch
    from superpoint_transformer_torch.nn import attention as block
    from superpoint_transformer_torch.ops import attention, attention_rpe
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda: None)
    monkeypatch.setattr(chip_smoke, 'settle', lambda: None)
    monkeypatch.setattr(chip_smoke, 'profiled_fit',
                        lambda: contextlib.nullcontext({}))
    for name, kernel in (('dense_attention_rpe',
                          attention_rpe.dense_attention_rpe),
                         ('dense_attention_trainable',
                          attention.dense_attention)):
        def counted(*args, _fn=getattr(block, name), _kernel=kernel):
            _kernel.launches += 1
            return _fn(*args)
        monkeypatch.setattr(block, name, counted)


def test_whole_cloud_phase_rehearsal_on_the_cpu(monkeypatch):
    """`phase_whole_cloud` end to end on the CPU at rooms of 6,000 raw
    points: the device preprocessing held to its CPU and host
    counterparts, `preprocess_cloud` and `e2e_inference` with the device
    KNN, stacked vs loop serving of 3 rooms (bit-equal), the checkpoint
    round trip, K2 held on a stacked tile's inputs, the dataset
    preprocessing one by one and through the workers' task; the card-only
    calls (synchronize, the sync debug mode, the memory statistics, the
    allocator subprocesses) stubbed, and the workers run in this
    process."""
    import torch
    from superpoint_transformer_torch.transforms.preprocess import (
        preprocess_cloud)
    from superpoint_transformer_torch.utils.synthetic import (
        synthetic_room_cloud)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _rehearse_on_the_cpu(monkeypatch)
    monkeypatch.setattr(chip_smoke, 'HOST_ROOM_POINTS', 6_000)
    monkeypatch.setattr(chip_smoke, 'sync_count', lambda fn: (fn(), 0))
    monkeypatch.setattr(chip_smoke, 'allocator_runs', lambda card: {})
    from superpoint_transformer_torch.datasets import base
    pools = []

    def in_process(fn, items, n_workers, card=False):
        pools.append((len(items), n_workers, card))
        return [fn(x) for x in items]

    monkeypatch.setattr(base, 'map_in_workers', in_process)
    held, hold = [], chip_smoke.hold_on_path

    def holding(name, args, path):
        held.append((name, args[10].storage_offset(), path))
        hold(name, args, path)

    monkeypatch.setattr(chip_smoke, 'hold_on_path', holding)
    from superpoint_transformer_torch.utils import memory
    monkeypatch.setattr(memory, 'device_memory_stats', lambda: {
        'cuda:0': dict.fromkeys(('allocated_bytes.all.peak',
                                 'reserved_bytes.all.peak',
                                 'allocated_bytes.all.current',
                                 'num_alloc_retries', 'num_ooms'), 0)})
    nags = [preprocess_cloud(synthetic_room_cloud(seed=s, n_points=6_000))
            for s in range(3)]
    try:
        served = chip_smoke.phase_whole_cloud(torch.device('cpu'), 'cpu',
                                              nags)
    finally:
        torch.set_num_threads(threads)
    # 7 K2 a forward: e2e (warm-up and forward), 3 rooms x (loop, stacked,
    # stacked, loop), the two sync-counted runs, the round trip's 2
    assert served == 7 * (2 + 3 * 4 + 3 * 2 + 2)
    assert pools == [(3, 3, True), (3, 3, False)]
    # held once, on the third tile of the stacked chunk
    (name, offset, path), = held
    assert name == 'K2' and path == 'whole-cloud path' and offset > 0


def test_parallel_phase_rehearsal_on_the_cpu(monkeypatch):
    """`phase_parallel` end to end on the CPU: two spawned gloo ranks on
    the CPU (the ranks' card-only calls stubbed by
    `torch_ranks.rehearsal`) at small crops and a room of 6,000 raw
    points: the data-parallel step bit-equal to the single-process one
    and to its rerun, the sharded forward and train step held to the
    unsharded ones, and the launches of both paths; 2 graphs a batch
    and one timing round, in the ranks too."""
    import torch
    from superpoint_transformer_torch.parallel import run_ranks
    from superpoint_transformer_torch.transforms.preprocess import (
        preprocess_cloud)
    from superpoint_transformer_torch.utils.synthetic import (
        synthetic_room_cloud)
    import torch_ranks
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _rehearse_on_the_cpu(monkeypatch)
    constants = dict(TRAIN_GRAPHS=2, PARALLEL_ROUNDS=1,
                     CROP=dict(n_points=2_000, n_l1=128, n_l2=32))
    for k, v in constants.items():
        monkeypatch.setattr(chip_smoke, k, v)
    # the bf16 limits of the sharded path are the card's readings on a
    # 250k-point room; this room has 406 level-1 nodes, and the CPU's
    # bf16 reads agreement 0.98522, mean 2.956e-2 and a confusion matrix
    # 2.38% of the label mass off. The f32 limits stay the card's.
    for k, v in (('SHARDED_BF16_ARGMAX_AGREEMENT', 0.97),
                 ('SHARDED_BF16_LOGIT_MEAN_MAX', 5e-2),
                 ('SHARDED_BF16_CONFMAT_OFF', 5e-2)):
        monkeypatch.setattr(chip_smoke, k, v)
    monkeypatch.setattr(chip_smoke, 'launch_ranks', lambda fn, args: (
        run_ranks(torch_ranks.rehearsal, chip_smoke.PARALLEL_RANKS,
                  args=(fn.__name__, args, constants), timeout=240)))
    nags = [preprocess_cloud(synthetic_room_cloud(seed=0, n_points=6_000))]
    try:
        paths = chip_smoke.phase_parallel(torch.device('cpu'), 'cpu', nags)
    finally:
        torch.set_num_threads(threads)
    # 7 a step or a forward, in each rank; the sharded forward and step
    # in f32 and bf16
    assert paths == {'data-parallel': {'K1': 2 * 7},
                     'graph-sharded': {'K1': 2 * 2 * 7, 'K2': 2 * 2 * 7}}


def test_allocator_runs_time_fresh_processes_of_each_setting(monkeypatch,
                                                             capsys):
    """`allocator_runs` starts fresh processes with the allocator tuned
    and with SPT_NO_MALLOC_TUNING=1, which each report their setting and
    the preprocess phase's seconds."""
    monkeypatch.setattr(chip_smoke, 'HOST_ROOM_POINTS', 3_000)
    monkeypatch.setattr(chip_smoke, 'ALLOCATOR_PAIRS', 1)
    out = chip_smoke.allocator_runs('cpu')
    assert sorted(out) == [False, True]
    assert all(len(v) == 1 and v[0] > 0 for v in out.values())
    assert '1 pairs in alternating order' in capsys.readouterr().out


def test_recall_counts_shared_neighbors():
    ref = np.array([[1, 2, -1], [0, 2, 3], [-1, -1, -1]])
    got = np.array([[2, 3, 1], [0, -1, -1], [1, -1, -1]])
    assert chip_smoke.recall(ref, got) == 3 / 5


def test_reference_state_dict_round_trips_the_flagship():
    import torch
    from superpoint_transformer_torch.experiment import (FLAGSHIP_CFG,
                                                         build_model)
    from superpoint_transformer_torch.models.semantic import (
        SemanticSegmentationModel)
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.utils.import_ckpt import (
        import_reference_checkpoint)
    a, b = (init_weights(SemanticSegmentationModel(
        build_model(FLAGSHIP_CFG, num_graphs=1, device='cpu'), 13),
        torch.Generator().manual_seed(s)) for s in (0, 1))
    state = chip_smoke.reference_state_dict(a)
    assert 'net.down_stages.0.transformer_blocks.0.sa.qkv.weight' in state
    report = import_reference_checkpoint(state, b)
    assert not report['missing'] and not report['unused_reference_keys']
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)


def test_ezsp_phase_rehearsal_on_the_cpu(monkeypatch, tmp_path):
    """`phase_ezsp` end to end on the CPU after a 1-epoch `phase_fit` on
    tiny rooms (whose clouds stage 1 reuses): stage 1 for 2 epochs, the
    embeddings held card (here the CPU) against the CPU, stage-2
    preprocessing with the stage-1 checkpoint, one stage-2 epoch with
    its validation and an evaluation, K1 and K2 held on their widest
    launches, with the card-only calls stubbed."""
    import tempfile
    import torch
    threads = torch.get_num_threads()
    # one intra-op thread: the suite runs its files in parallel processes
    torch.set_num_threads(1)
    _rehearse_on_the_cpu(monkeypatch)
    dev = torch.device('cpu')
    rooms = tempfile.TemporaryDirectory(dir=tmp_path)
    try:
        chip_smoke.phase_fit(dev, 'cpu', room_points=3_000, epochs=1,
                             tmp=rooms)
        out = chip_smoke.phase_ezsp(dev, 'cpu', rooms)
    finally:
        torch.set_num_threads(threads)
        rooms.cleanup()
    # one stage-2 epoch of 2 steps (7 K1 each); its validation of 2
    # areas and their evaluation (7 K2 a forward)
    assert out == {'K1': 7 * 2, 'K2': 7 * (2 + 2)}


def test_fit_phase_rehearsal_on_the_cpu(monkeypatch):
    """`phase_fit` end to end on the CPU at tiny rooms and 1 epoch (+ the
    resumed one): its datasets, entry points, checks and printing run;
    the card-only calls are stubbed (synchronize, the profiler, the
    memory statistics) and each CPU call of an attention entry point
    counts as a launch of its kernel, as the wrapper counts one on the
    card."""
    import torch
    threads = torch.get_num_threads()
    # one intra-op thread: the suite runs its files in parallel processes
    torch.set_num_threads(1)
    _rehearse_on_the_cpu(monkeypatch)
    try:
        out = chip_smoke.phase_fit(torch.device('cpu'), 'cpu',
                                   room_points=3_000, epochs=1)
    finally:
        torch.set_num_threads(threads)
    # 1 + 1 epochs of 2 steps (7 K1 each) and 2 accumulation micro-steps;
    # 2 validations of 2 areas, 2 evaluations of them, 3 TTA passes of
    # the test area (7 K2 each)
    assert out == {'K1': 7 * (4 + 0), 'K2': 7 * (4 + 4 + 3)}


def test_nano_phase_rehearsal_on_the_cpu(monkeypatch, tmp_path):
    """`phase_nano` end to end on the CPU after a 1-epoch `phase_fit` on
    tiny rooms (whose raw files the nano datasets read again, from level
    1 up), with 2 tiny panoptic rooms preprocessed as the panoptic phase
    preprocesses them (instances, segment means): serving, training
    steps, the panoptic nano evaluation and step, train and evaluate;
    the card-only calls and the timings stubbed."""
    import tempfile
    import torch
    from superpoint_transformer_torch.experiment import NANO_CFG
    from superpoint_transformer_torch.transforms.preprocess import (
        preprocess_cloud)
    from superpoint_transformer_torch.utils.synthetic import (
        room_instances, synthetic_room_cloud)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _rehearse_on_the_cpu(monkeypatch)
    monkeypatch.setattr(chip_smoke, 'cuda_ms', lambda fn, iters, warmup=3:
                        (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, 'time_on_path', lambda name, args: (
        1.0, 1.0, 1.0, 'bytes', {'N': args[0].shape[0]}, {}))
    pan = []
    for seed in range(2):
        raw = synthetic_room_cloud(seed=seed, n_points=3_000)
        raw['obj'] = room_instances(raw)
        pan.append(preprocess_cloud(
            raw, voxel=0.1, knn=12, knn_r=1.0, with_instances=True,
            segment_mean_hf=NANO_CFG['datamodule']['segment_mean_hf']))
    dev = torch.device('cpu')
    rooms = tempfile.TemporaryDirectory(dir=tmp_path)
    try:
        chip_smoke.phase_fit(dev, 'cpu', room_points=3_000, epochs=1,
                             tmp=rooms)
        out, timing = chip_smoke.phase_nano(dev, 'cpu', rooms, pan)
    finally:
        torch.set_num_threads(threads)
        rooms.cleanup()
    # 7 K2 a forward: 3 requests, the panoptic evaluation, the
    # validation of 2 areas and their evaluation; 7 K1 a step: 2 train
    # steps, the panoptic step and 2 fit steps
    assert out == {'K1': 7 * (2 + 1 + 2), 'K2': 7 * (3 + 1 + 2 + 2)}
    assert set(timing) == {'K1', 'K2'}


def test_datasets_phase_rehearsal_on_the_cpu(monkeypatch, tmp_path):
    """`phase_datasets` end to end on the CPU at 4,000 raw points a
    DALES tile, KITTI-360 window and ScanNet scan and one DALES epoch
    (SPT-3 at full width):
    the raw files in the three formats, the readers and the in-memory
    datasets, fit and evaluate on DALES and KITTI-360, DALES serving and
    `e2e_inference`, ScanNet's panoptic validation and step, and every
    hold against the plain attention; the card-only calls and the
    timings stubbed."""
    import tempfile
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _rehearse_on_the_cpu(monkeypatch)
    monkeypatch.setattr(chip_smoke, 'cuda_ms', lambda fn, iters, warmup=3:
                        (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, 'time_on_path', lambda name, args: (
        1.0, 1.0, 1.0, 'bytes', {'N': args[0].shape[0]}, {}))
    for name in ('DALES_TILE_POINTS', 'KITTI360_WINDOW_POINTS',
                 'SCANNET_SCAN_POINTS'):
        monkeypatch.setattr(chip_smoke, name, 4_000)
    monkeypatch.setattr(chip_smoke, 'DALES_EPOCHS', 1)
    tmp = tempfile.TemporaryDirectory(dir=tmp_path)
    try:
        out, timing = chip_smoke.phase_datasets(torch.device('cpu'), 'cpu',
                                                tmp)
    finally:
        torch.set_num_threads(threads)
        tmp.cleanup()
    # 11 K1 a step, 11 K2 a forward. dales: 1 epoch of 1 step, a
    # validation of 2 tiles, their evaluation, 3 requests, the e2e tile
    # (warm-up and forward), and the 4 served tiles through the per-tile
    # loop and twice stacked; kitti360: 1 step, 1 validation forward and
    # its evaluation; scannet: 1 validation forward, 1 step
    assert out == {'dales': {'K1': 11, 'K2': 11 * (2 + 2 + 3 + 2 + 12)},
                   'kitti360': {'K1': 11, 'K2': 11 * 2},
                   'scannet': {'K1': 11, 'K2': 11}}
    assert sorted(timing) == ['K1', 'K2']
