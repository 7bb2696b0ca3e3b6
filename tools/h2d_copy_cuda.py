"""Host-to-card copy of one training batch by `data.padded.from_numpy`:
from pageable memory (each leaf copied, then cast on the card) against
`pin_memory=True` (each leaf cast on the host, copied into pinned memory,
then one asynchronous copy), at the size of `chip_smoke.py`'s fit
batches (one S3DIS area of two rooms: ~320k level-0, ~10.6k level-1,
~1.9k level-2 nodes) and at 4x that.

    python tools/h2d_copy_cuda.py [--rounds 5] [--iters 10]

Runs on a CUDA card only. Each round times both variants, alternating
which goes first, over `iters` copies each (host clock, the card
synchronized after every copy); prints the card's name and power limit,
the batch's bytes and the median ms of each variant."""
import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--rounds', type=int, default=5)
    ap.add_argument('--iters', type=int, default=10)
    args = ap.parse_args()
    import numpy as np
    import torch
    from superpoint_transformer_torch.data import padded
    from superpoint_transformer_torch.utils.synthetic import (
        random_padded_nag)
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    dev = torch.device('cuda', 0)

    def copy_ms(batch, pin):
        ts = []
        for _ in range(args.iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            padded.from_numpy(batch, dev, 'bf16', train=True,
                              pin_memory=pin)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    for scale in (1, 4):
        batch = random_padded_nag(seed=0, num_graphs=1,
                                  n_points=320_000 * scale,
                                  n_l1=10_600 * scale, n_l2=1_900 * scale)
        nbytes = sum(np.asarray(v).nbytes for lvl in batch.levels
                     for f, v in vars(lvl).items()
                     if v is not None and f != 'num_nodes')
        copy_ms(batch, False), copy_ms(batch, True)  # warm-up
        got = {'pageable': [], 'pinned': []}
        for r in range(args.rounds):
            order = (('pageable', False), ('pinned', True))
            for name, pin in order if r % 2 == 0 else order[::-1]:
                got[name].append(copy_ms(batch, pin))
        print(f'from_numpy of a {scale}x fit batch ({nbytes / 2**20:.1f} MiB '
              f'of numpy leaves) on {card}: pageable '
              f'{np.median(got["pageable"]):.3f} ms, pinned '
              f'{np.median(got["pinned"]):.3f} ms; rounds {got} (host clock, '
              f'median of {args.iters} copies a round)')


if __name__ == '__main__':
    main()
