"""Datasets on the host: stage and fold handling, the hash-addressed
preprocessing cache, loaders and submission files. Counterparts of
`BaseDataset`, `DataLoader`, `PreparedDataLoader` and `make_submission`
in `superpoint_transformer_tpu/datasets/base.py`.

Directory layout (the JAX package's, so either package reads a cache
that the other wrote):
  <root>/raw/...                                   raw dataset files
  <root>/processed/<stage>/<hash>/<cloud_id>.h5    preprocessed NAGs

`<hash>` is the md5 of the repr of the sorted preprocessing config, as in
JAX. The files are written and read by the port's `NAG.save` / `NAG.load`
(h5py is imported there only).
"""
import hashlib
import os
import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from ..data.nag import NAG
from ..transforms.preprocess import (preprocess_cloud,
                                     sample_recursive_main_xy_axis_tiling,
                                     sample_xy_tiling)

__all__ = ['BaseDataset', 'DataLoader', 'PreparedDataLoader',
           'make_submission']


def _worker_init(card=False):
    """Preprocessing and batch-preparation workers run numpy and the
    native library, one OpenMP thread each (the fan-out over workers is
    the parallelism). They see no card, unless `card` (preprocessing that
    runs its KNN or CNN there: each worker then opens its own context)."""
    if not card:
        os.environ['CUDA_VISIBLE_DEVICES'] = ''
    os.environ.setdefault('OMP_NUM_THREADS', '1')


def map_in_workers(fn, items, n_workers, card=False):
    """`[fn(x) for x in items]` over `n_workers` spawned processes
    (`_worker_init(card)`), one item at a time."""
    import multiprocessing as mp
    ctx = mp.get_context('spawn')
    with ctx.Pool(n_workers, initializer=_worker_init,
                  initargs=(card,)) as pool:
        return pool.map(fn, items, chunksize=1)


class BaseDataset:
    """Subclasses define:
      - `class_names` (list, with a trailing 'ignored')
      - `num_classes` (int, without the ignored class)
      - `all_cloud_ids` -> {'train': [...], 'val': [...], 'test': [...]}
      - `read_single_raw_cloud(raw_path) -> Data`
      - `id_to_relative_raw_path(cloud_id) -> str`
    Optional: `stuff_classes`, `val_mixed_in_train`, `test_mixed_in_val`,
    `xy_tiling` ((nx, ny) grid) or `pc_tiling` (recursive principal-axis
    halvings) of each cloud at preprocessing.
    """
    class_names: List[str] = []
    num_classes: int = 0
    stuff_classes: List[int] = []
    val_mixed_in_train = False
    test_mixed_in_val = False
    xy_tiling: Optional[tuple] = None
    pc_tiling: Optional[int] = None
    download_instructions: str = None

    def __init__(self, root, stage='train', pre_transform_config=None,
                 point_load_keys=None, segment_load_keys=None,
                 nano=False, in_memory=False, host_id=0, num_hosts=1,
                 num_workers=1, xy_tiling=None, pc_tiling=None,
                 verbose=False, device=None):
        if stage not in ('train', 'val', 'trainval', 'test'):
            raise ValueError(f'unknown stage {stage!r}')
        self.root = root
        self.stage = stage
        self.pre_transform_config = dict(pre_transform_config or {})
        self.point_load_keys = point_load_keys
        self.segment_load_keys = segment_load_keys
        self.nano = nano
        self.in_memory = in_memory
        self.host_id = host_id
        self.num_hosts = num_hosts
        # worker processes for `process()`; <= 0: one per CPU core
        self.num_workers = (num_workers if num_workers > 0
                            else (os.cpu_count() or 1))
        if xy_tiling is not None:
            self.xy_tiling = xy_tiling
        if pc_tiling is not None:
            self.pc_tiling = pc_tiling
        self.verbose = verbose
        # where preprocessing runs EZ-SP's frozen stage-1 CNN and the
        # device KNN (None: the card); not part of the cache's hash
        self.device = device
        self._cache = {}

    # ----- to be overridden -------------------------------------------
    @property
    def all_cloud_ids(self) -> Dict[str, List[str]]:
        raise NotImplementedError

    def read_single_raw_cloud(self, raw_path):
        raise NotImplementedError

    def id_to_relative_raw_path(self, cloud_id):
        return cloud_id + '.ply'

    # ----- paths --------------------------------------------------------
    @property
    def raw_dir(self):
        return osp.join(self.root, 'raw')

    @property
    def processed_dir(self):
        return osp.join(self.root, 'processed')

    @property
    def pre_transform_hash(self):
        cfg = repr(sorted(self.pre_transform_config.items()))
        return hashlib.md5(cfg.encode()).hexdigest()

    @property
    def cloud_ids(self):
        if self.stage == 'trainval':
            ids = self.all_cloud_ids['train'] + self.all_cloud_ids['val']
        else:
            ids = self.all_cloud_ids[self.stage]
        return [t for c in ids for t in self._tiles_of(c)]

    def _tiles_of(self, cloud_id):
        if self.xy_tiling is not None:
            tx, ty = self.xy_tiling if not np.isscalar(self.xy_tiling) \
                else (self.xy_tiling, self.xy_tiling)
            return [f'{cloud_id}__TILE_{i}-{j}'
                    for i in range(tx) for j in range(ty)]
        if self.pc_tiling:
            return [f'{cloud_id}__PCTILE_{t}'
                    for t in range(1 << self.pc_tiling)]
        return [cloud_id]

    @staticmethod
    def _split_tile_id(cloud_id):
        """-> (raw cloud id, tile spec or None)."""
        if '__TILE_' in cloud_id:
            base, tile = cloud_id.split('__TILE_')
            i, j = tile.split('-')
            return base, ('xy', int(i), int(j))
        if '__PCTILE_' in cloud_id:
            base, t = cloud_id.split('__PCTILE_')
            return base, ('pc', int(t))
        return cloud_id, None

    def _stage_of(self, cloud_id):
        cloud_id, _ = self._split_tile_id(cloud_id)
        for s in ('train', 'val', 'test'):
            if cloud_id in self.all_cloud_ids[s]:
                if s == 'val' and self.val_mixed_in_train:
                    return 'train'
                if s == 'test' and self.test_mixed_in_val:
                    return 'val'
                return s
        return self.stage

    def processed_path(self, cloud_id):
        return osp.join(self.processed_dir, self._stage_of(cloud_id),
                        self.pre_transform_hash, f'{cloud_id}.h5')

    @property
    def processed_paths(self):
        return [self.processed_path(c) for c in self.cloud_ids]

    # ----- processing ---------------------------------------------------
    def download(self):
        """The raw data is placed by hand: say where it goes."""
        raise RuntimeError(self.download_instructions or (
            f'{type(self).__name__}: raw data not found under '
            f'{self.raw_dir}. Download the dataset and extract it so that '
            '`id_to_relative_raw_path(cloud_id)` resolves.'))

    def process(self):
        """Preprocess every cloud whose file is missing (resumable). This
        host takes its share of the clouds; `num_workers > 1` spreads them
        over spawned worker processes, which see the card where the
        preprocessing runs there (`_needs_card`)."""
        todo = [c for c in self.cloud_ids
                if not osp.exists(self.processed_path(c))]
        todo = todo[self.host_id::self.num_hosts]
        if not todo:
            return
        first_raw = osp.join(self.raw_dir, self.id_to_relative_raw_path(
            self._split_tile_id(todo[0])[0]))
        if not osp.exists(first_raw) and not osp.exists(self.raw_dir):
            self.download()
        n_workers = min(self.num_workers, len(todo))
        if n_workers > 1:
            map_in_workers(self._process_single_cloud, todo, n_workers,
                           card=self._needs_card)
        else:
            for cloud_id in todo:
                self._process_single_cloud(cloud_id)

    @property
    def _needs_card(self):
        """Whether preprocessing runs on a card: EZ-SP's frozen CNN, or
        the device KNN."""
        cfg = self.pre_transform_config
        on_device = ((cfg.get('partition_mode') == 'contour_prior'
                      and bool(cfg.get('pretrained_cnn_ckpt_path')))
                     or cfg.get('knn_backend') == 'device')
        return on_device and str(self.device or 'cuda').startswith('cuda')

    def process_cloud(self, cloud_id):
        """The preprocessed NAG of `cloud_id` (a tile id reads its cloud
        and cuts the tile first)."""
        raw_id, tile = self._split_tile_id(cloud_id)
        data = self.read_single_raw_cloud(
            osp.join(self.raw_dir, self.id_to_relative_raw_path(raw_id)))
        if tile is not None:
            if tile[0] == 'xy':
                data = sample_xy_tiling(data, tiling=self.xy_tiling,
                                        tile=(tile[1], tile[2]))
            else:
                data = sample_recursive_main_xy_axis_tiling(
                    data, steps=self.pc_tiling, tile=tile[1])
        if self.verbose:
            print(f'preprocessing {cloud_id}: {data.num_nodes} points')
        return preprocess_cloud(data, num_classes=self.num_classes,
                                device=self.device or 'cuda',
                                **self.pre_transform_config)

    def _process_single_cloud(self, cloud_id):
        path = self.processed_path(cloud_id)
        if osp.exists(path):
            return
        os.makedirs(osp.dirname(path), exist_ok=True)
        self.process_cloud(cloud_id).save(path, pos_dtype=np.float32,
                                          fp_dtype=np.float16)

    # ----- loading ------------------------------------------------------
    def __len__(self):
        return len(self.cloud_ids)

    def load(self, cloud_id):
        """The processed NAG of `cloud_id`, as training reads it."""
        return NAG.load(
            self.processed_path(cloud_id), low=1 if self.nano else 0,
            keys_low=self.point_load_keys, keys=self.segment_load_keys,
            non_fp_to_long=True, rgb_to_float=True)

    def __getitem__(self, idx):
        cloud_id = self.cloud_ids[idx]
        if self.in_memory and cloud_id in self._cache:
            return self._cache[cloud_id]
        nag = self.load(cloud_id)
        if self.in_memory:
            self._cache[cloud_id] = nag
        return nag

    def get_class_weight(self, smooth='sqrt'):
        """Per-class loss weights from the label counts of this split."""
        counts = np.zeros(self.num_classes, dtype=np.float64)
        for i in range(len(self)):
            y = self[i][1].y
            if y is None:
                continue
            counts += np.asarray(y)[:, :self.num_classes].sum(0)
        counts = np.maximum(counts, 1)
        if smooth == 'sqrt':
            counts = np.sqrt(counts)
        elif smooth == 'log':
            counts = np.log(counts + 1)
        w = 1.0 / counts
        return (w / w.sum() * self.num_classes).astype(np.float32)


class DataLoader:
    """Yields lists of NAGs (batching happens in `prepare_batch`).
    `prefetch > 0` loads upcoming batches on a background thread, so file
    reads overlap the step (h5py releases the GIL). After `shard(rank,
    world_size)` it yields the batches of one data-parallel rank only."""

    def __init__(self, dataset, batch_size=1, shuffle=False, seed=0,
                 drop_last=False, prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0
        self.rank, self.world_size = 0, 1

    def shard(self, rank, world_size):
        """From now on yield rank `rank`'s batches of each epoch: global
        step s takes batch `s * world_size + rank` of the epoch's order,
        and a trailing group of fewer than `world_size` batches is
        dropped (the JAX Trainer's data-parallel grouping)."""
        self.rank, self.world_size = int(rank), int(world_size)
        return self

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        """[(batch number in the epoch, sample indices)] of this epoch's
        batches of this rank."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        out = []
        for i in range(0, n, self.batch_size):
            idx = order[i:i + self.batch_size]
            if self.drop_last and idx.shape[0] < self.batch_size:
                break
            out.append(idx)
        full = len(out) // self.world_size * self.world_size
        return [(b, out[b]) for b in range(self.rank, full, self.world_size)]

    def __iter__(self):
        if self.prefetch <= 0:
            for _, idx in self._batches():
                yield [self.dataset[int(j)] for j in idx]
            return
        import queue
        import threading
        q = queue.Queue(maxsize=self.prefetch)
        end = object()

        def worker():
            try:
                for _, idx in self._batches():
                    q.put([self.dataset[int(j)] for j in idx])
            finally:
                q.put(end)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is end:
                break
            yield item


def _prepared_worker(dataset, batch_cfg, train, task_q, result_q):
    """Worker-process loop: load the NAGs of a batch and prepare it into
    a `PaddedNAG` with numpy leaves (no torch tensor, no device)."""
    _worker_init()
    from ..transforms.prepare import prepare_batch
    while True:
        item = task_q.get()
        if item is None:
            break
        gen, bid, idx, seed = item
        nags = [dataset[int(j)] for j in idx]
        out = prepare_batch(nags, batch_cfg, train=train,
                            rng=np.random.default_rng(seed))
        result_q.put((gen, bid, out))


class PreparedDataLoader(DataLoader):
    """A `DataLoader` that also runs `prepare_batch`, in spawned worker
    processes when `num_workers > 0`, and yields `PaddedNAG`s of tensors
    on `device` (label histograms kept).

    Workers run numpy only and send numpy batches; the main process
    copies each batch to the device from pinned memory (`from_numpy`).
    The pool is spawned, never forked, so a CUDA context in the main
    process cannot leak into it. Batch capacities must be pinned
    (`discover_caps`) so every batch has one padded shape. Each batch has
    its own seed, so its content does not depend on the worker count.
    Workers persist across epochs; `close` stops them."""

    def __init__(self, dataset, batch_cfg, batch_size=1, shuffle=False,
                 seed=0, drop_last=False, train=True, num_workers=0,
                 prefetch=4, device='cpu', compute_dtype=None,
                 timeout=300):
        super().__init__(dataset, batch_size=batch_size, shuffle=shuffle,
                         seed=seed, drop_last=drop_last, prefetch=prefetch)
        self.batch_cfg = batch_cfg
        self.train = train
        self.num_workers = num_workers
        self.device = device
        self.compute_dtype = compute_dtype
        self.timeout = timeout
        self._pool = None
        # epoch generation: results of an abandoned epoch are dropped
        self._generation = 0

    def _ensure_pool(self):
        if self._pool is not None:
            return
        import multiprocessing as mp
        ctx = mp.get_context('spawn')
        self._task_q = ctx.Queue()
        # bound the prepared batches in flight
        self._result_q = ctx.Queue(maxsize=max(2 * self.num_workers, 4))
        self._pool = [ctx.Process(
            target=_prepared_worker,
            args=(self.dataset, self.batch_cfg, self.train, self._task_q,
                  self._result_q), daemon=True)
            for _ in range(self.num_workers)]
        for p in self._pool:
            p.start()

    def close(self):
        if self._pool is None:
            return
        for _ in self._pool:
            self._task_q.put(None)
        for p in self._pool:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        self._pool = None

    def _to_device(self, host):
        from ..data.padded import from_numpy
        return from_numpy(host, self.device, self.compute_dtype, train=True)

    def __iter__(self):
        import queue
        import time
        batches = self._batches()
        # one seed a batch of the epoch, whichever rank takes it
        seeds = np.random.SeedSequence(
            self.seed + 7919 * self.epoch).generate_state(max(len(self), 1))
        batches = [(idx, int(seeds[b])) for b, idx in batches]
        if self.num_workers <= 0:
            from ..transforms.prepare import prepare_batch
            for idx, seed in batches:
                nags = [self.dataset[int(j)] for j in idx]
                yield self._to_device(prepare_batch(
                    nags, self.batch_cfg, train=self.train,
                    rng=np.random.default_rng(seed)))
            return
        self._ensure_pool()
        self._generation += 1
        gen = self._generation
        for bid, (idx, seed) in enumerate(batches):
            self._task_q.put((gen, bid, np.asarray(idx), seed))
        pending = {}
        for next_bid in range(len(batches)):
            waited = time.monotonic()
            while next_bid not in pending:
                try:
                    rgen, bid, out = self._result_q.get(timeout=5)
                except queue.Empty:
                    dead = [p for p in self._pool if not p.is_alive()]
                    if dead:
                        raise RuntimeError(
                            f'{len(dead)} PreparedDataLoader worker '
                            'process(es) died: see their stderr')
                    if time.monotonic() - waited > self.timeout:
                        raise TimeoutError(
                            f'PreparedDataLoader: no batch in '
                            f'{self.timeout} s')
                    continue
                if rgen == gen:
                    pending[bid] = out
            yield self._to_device(pending.pop(next_bid))


def make_submission(dataset, cloud_id, full_res_pred, submission_dir):
    """Write the held-out predictions of `cloud_id` in the dataset's
    benchmark format (`submission_format`): 'labels_txt' (one int label
    per line, after the optional `submission_id_map`), 'kitti360_npy'
    (uint8 label ids in a file named after the sequence and window) or
    'labels_ply' (binary PLY with one 'class' property). Returns the
    path."""
    os.makedirs(submission_dir, exist_ok=True)
    fmt = getattr(dataset, 'submission_format', 'labels_txt')
    pred = np.asarray(full_res_pred).astype(np.int32)
    idmap = getattr(dataset, 'submission_id_map', None)
    if fmt == 'labels_txt':
        if idmap is not None:
            pred = np.asarray(idmap)[np.clip(pred, 0, len(idmap) - 1)]
        out = osp.join(submission_dir, f'{osp.basename(cloud_id)}.txt')
        np.savetxt(out, pred, fmt='%d')
    elif fmt == 'kitti360_npy':
        if idmap is not None:
            pred = np.asarray(idmap)[pred]
        pred = pred.astype(np.uint8)
        seq, win = cloud_id.split('/')
        seqno = seq.split('_')[-2]
        start, end = win.split('_')
        out = osp.join(submission_dir,
                       f'{seqno:0>4}_{start:0>10}_{end:0>10}.npy')
        np.save(out, pred)
    elif fmt == 'labels_ply':
        from ..utils.ply import write_ply
        out = osp.join(submission_dir, f'{cloud_id}.ply')
        write_ply(out, {'class': pred})
    else:
        raise ValueError(f'unknown submission format {fmt}')
    return out
