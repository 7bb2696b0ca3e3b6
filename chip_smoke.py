#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the flagship SPT-2 semantic model (S3DIS,
bf16 compute, 8 graphs per batch, random weights from a seed) serving
three synthetic requests at the "demo room x8" size, and checks every
CUDA kernel on that path against its plain PyTorch version:

1. prints the card, its power limit and the toolchain;
2. builds the kernels from the sources in this checkout (timed);
3. compares each kernel with its plain version on the card, at the
   shapes the main path gives it, in f32 and bf16;
4. serves the requests through `infer_batch`, counting kernel launches,
   checks the logits and predictions, compares the logits with the same
   model on the plain attention, and times the forward with CUDA events;
5. prints the kernel table as JSON, the card line, and as the last line
   `{"ok": true, "device": {...}}`.

Any failed phase raises, so the script exits non-zero without printing
the last line. It needs no network and fails without a CUDA device or
outside a checkout of the repository.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
NUM_GRAPHS = 8
# per graph: one S3DIS demo room after preprocessing
ROOM = dict(n_points=41_500, n_l1=1_250, n_l2=350)
FLAGSHIP_PARAMS = 213_434         # the JAX model's count (CPU-tested)
K2_LAUNCHES_PER_FORWARD = 7       # 3 + 3 down blocks, 1 up block
# kernel vs plain version: the JAX kernel test's own tolerance; both
# compute in f32 from the same inputs, in another summation order
K2_RTOL, K2_ATOL = 2e-4, 2e-5
# whole model, kernel vs plain attention. The forward is not bitwise
# reproducible: the f32 atomics of the GraphNorm segment sums add in a
# varying order, and the random-weight network amplifies that (the same
# model run twice: logits |x| ~20 differ by up to ~1.6e-2 in f32 and
# ~1.1 in bf16, argmax agreement ~0.98 in bf16). So in f32 the limit is
# absolute, and in bf16 the kernel must agree with the plain version as
# closely as the model agrees with itself run to run.
F32_LOGIT_MAX_ABS = 5e-2
F32_ARGMAX_AGREEMENT = 0.999
BF16_MEAN_ERR_RATIO = 2.0
BF16_MEAN_ERR_FLOOR = 1e-3      # in case a run happens to be reproducible
BF16_ARGMAX_AGREEMENT = 0.95


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def logit_diff(a, b):
    """(max abs difference, mean abs difference, argmax agreement)."""
    d = (a - b).abs()
    agree = (a.argmax(1) == b.argmax(1)).float().mean()
    return d.max().item(), d.mean().item(), agree.item()


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of `fn()` over `iters` runs, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k2_inputs(gen, N, K, H, D, C, De, masked_rows, dtype, dev):
    import torch

    def mk(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dev, dtype)

    args = [mk(N, H, D), mk(N, K, H * D), mk(N, K, C), mk(N, K, De),
            mk(De, H * D, scale=0.3), mk(H * D, scale=0.1),
            mk(De, H * D, scale=0.3), mk(H * D, scale=0.1),
            mk(De, C, scale=0.3), mk(C, scale=0.1)]
    mask = torch.rand(N, K, generator=gen) < 0.7
    mask[:, 0] = True
    if masked_rows:
        mask[-masked_rows:] = False
    scale = torch.rand(N, generator=gen) * 0.5 + 0.2
    return args + [mask.to(dev), scale.to(dev)]


def phase_kernels(dev):
    """K2 vs its plain version at the flagship level-1 shape, a ragged
    shape and a batch with fully masked rows, in f32 and bf16."""
    import torch
    from superpoint_transformer_torch.ops import attention_rpe as k2

    gen = torch.Generator().manual_seed(SEED)
    flagship = dict(N=10_240, K=48, H=16, D=4, C=64, De=32)
    cases = [('flagship', dict(flagship, masked_rows=0)),
             ('ragged', dict(N=1000, K=37, H=4, D=4, C=32, De=8,
                             masked_rows=0)),
             ('masked_rows', dict(flagship, N=4096, masked_rows=512))]
    worst = 0.0
    for name, shape in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = k2_inputs(gen, dtype=dtype, dev=dev, **shape)
            out, lse = k2.dense_attention_rpe(*args, with_lse=True)
            ref, ref_lse = k2.dense_attention_rpe_reference(
                *args, with_lse=True)
            torch.cuda.synchronize()
            valid = args[10].any(1)
            err = (out - ref).abs().max().item()
            rel = ((out - ref).abs() / ref.abs().clamp(min=1e-3)).max().item()
            lse_err = (lse[:, valid] - ref_lse[:, valid]).abs().max().item()
            print(f'K2 {name:11s} {str(dtype):14s} N={shape["N"]} '
                  f'K={shape["K"]}: max_abs_err={err:.3e} '
                  f'max_rel_err={rel:.3e} lse_max_abs_err={lse_err:.3e} '
                  f'(rtol {K2_RTOL}, atol {K2_ATOL})')
            torch.testing.assert_close(out, ref, rtol=K2_RTOL, atol=K2_ATOL)
            torch.testing.assert_close(lse[:, valid], ref_lse[:, valid],
                                       rtol=K2_RTOL, atol=K2_ATOL)
            check(torch.all(out[~valid] == 0),
                  'fully masked rows must give 0')
            worst = max(worst, err)

    # time at the flagship level-1 shape in bf16, the serving dtype
    args = k2_inputs(gen, dtype=torch.bfloat16, dev=dev, masked_rows=0,
                     **flagship)
    plain_ms = cuda_ms(lambda: k2.dense_attention_rpe_reference(*args), 20)
    ms = cuda_ms(lambda: k2.dense_attention_rpe(*args), 20)
    plain_ms2 = cuda_ms(lambda: k2.dense_attention_rpe_reference(*args), 20)
    ms2 = cuda_ms(lambda: k2.dense_attention_rpe(*args), 20)
    print(f'K2 flagship bf16 N=10240 K=48: kernel {ms:.4f} / {ms2:.4f} ms, '
          f'plain {plain_ms:.4f} / {plain_ms2:.4f} ms (two rounds, '
          f'CUDA events, 20 launches each)')
    return dict(max_abs_err=worst, ms=min(ms, ms2),
                plain_ms=min(plain_ms, plain_ms2))


def phase_serving(dev, card):
    import numpy as np
    import torch
    from superpoint_transformer_torch.data.padded import from_numpy
    from superpoint_transformer_torch.experiment import (FLAGSHIP_CFG,
                                                         build_model)
    from superpoint_transformer_torch.inference import infer_batch
    from superpoint_transformer_torch.models.semantic import (
        SemanticSegmentationModel)
    from superpoint_transformer_torch.nn.mlp import init_weights
    from superpoint_transformer_torch.ops.attention_rpe import (
        dense_attention_rpe)
    from superpoint_transformer_torch.utils.synthetic import (
        random_padded_nag)

    def flagship(compute_dtype='auto', plain_attention=False):
        m = SemanticSegmentationModel(build_model(
            FLAGSHIP_CFG, num_graphs=NUM_GRAPHS, compute_dtype=compute_dtype,
            plain_attention=plain_attention), 13)
        init_weights(m, torch.Generator().manual_seed(SEED))
        return m.to(dev).eval()

    model = flagship()
    n_params = sum(p.numel() for p in model.parameters())
    print(f'flagship SPT-2: {n_params} parameters')
    check(n_params == FLAGSHIP_PARAMS,
          f'{n_params} parameters, the JAX model has {FLAGSHIP_PARAMS}')
    compute_dtype = model.net.compute_dtype

    requests = []
    for i in range(3):
        t0 = time.perf_counter()
        host = random_padded_nag(seed=SEED + 1 + i, num_graphs=NUM_GRAPHS,
                                 **ROOM)
        requests.append((host, time.perf_counter() - t0))

    # the main path: every launch counted from here
    dense_attention_rpe.launches = 0
    served = []
    for host, gen_s in requests:
        before = dense_attention_rpe.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = from_numpy(host, dev, compute_dtype)
        pred = infer_batch(model, batch)
        req_s = time.perf_counter() - t0
        launched = dense_attention_rpe.launches - before
        served.append((batch, pred))
        n = [lvl.num_nodes for lvl in batch.levels]
        print(f'request: {n[0]} points, {n[1]} level-1, {n[2]} level-2 '
              f'nodes, K={batch[1].nbr_idx.shape[1]}/'
              f'{batch[2].nbr_idx.shape[1]}; made in {gen_s:.3f} s, '
              f'served in {req_s * 1e3:.1f} ms (host to predictions); '
              f'{launched} K2 launches')
        check(launched == K2_LAUNCHES_PER_FORWARD,
              f'{launched} K2 launches in one forward, expected '
              f'{K2_LAUNCHES_PER_FORWARD}')
        check(pred.shape == (n[1],) and pred.dtype == np.int64
              and pred.min() >= 0 and pred.max() < 13,
              'predictions are not a class per level-1 node')
    launches = dense_attention_rpe.launches
    print(f'main path: 3 requests answered, {launches} K2 launches')

    # what comes out: finite logits on valid rows, close to those of the
    # same model on the plain attention, in f32 and in the served bf16
    host = requests[0][0]
    batch, pred = served[0]
    for cd in (None, compute_dtype):
        kern = model if cd == compute_dtype else flagship(cd)
        plain = flagship(cd, plain_attention=True)
        b = batch if cd == compute_dtype else from_numpy(host, dev, cd)
        with torch.inference_mode():
            logits, again, ref = kern(b), kern(b), plain(b)
        for i in range(len(logits)):
            lvl = b[i + 1]
            lg, lg2, rf = (t[i][lvl.node_mask] for t in (logits, again, ref))
            check(lg.shape == (lvl.num_nodes, 13)
                  and bool(torch.isfinite(lg).all()),
                  f'level {i + 1} logits: shape {tuple(lg.shape)} or not '
                  'finite')
            err, mean, agree = logit_diff(lg, rf)
            err2, mean2, agree2 = logit_diff(lg, lg2)
            print(f'{cd or "float32"} level-{i + 1} logits (|x| max '
                  f'{rf.abs().max().item():.3f}): kernel vs plain attention '
                  f'max_abs_err={err:.3e} mean={mean:.3e} argmax agreement='
                  f'{agree:.5f}; same model run twice max={err2:.3e} '
                  f'mean={mean2:.3e} agreement={agree2:.5f}')
            if cd is None:
                check(err <= F32_LOGIT_MAX_ABS
                      and agree >= F32_ARGMAX_AGREEMENT,
                      f'f32 level {i + 1} logits: kernel vs plain beyond '
                      f'{F32_LOGIT_MAX_ABS} / {F32_ARGMAX_AGREEMENT}')
            else:
                limit = BF16_MEAN_ERR_RATIO * mean2 + BF16_MEAN_ERR_FLOOR
                check(mean <= limit and agree >= BF16_ARGMAX_AGREEMENT,
                      f'bf16 level {i + 1} logits: kernel vs plain beyond '
                      f'{BF16_MEAN_ERR_RATIO}x the run-to-run spread or '
                      f'agreement below {BF16_ARGMAX_AGREEMENT}')
    # the served predictions are a forward's level-1 argmax in NAG order
    n1 = batch[1].num_nodes
    agree = (pred[batch.level1_node_id[:n1]]
             == logits[0][:n1].argmax(1).cpu().numpy()).mean()
    check(agree >= BF16_ARGMAX_AGREEMENT,
          f'served predictions vs level-1 argmax in NAG order: {agree}')

    # forward time, kernel vs plain attention, in turns
    def forward(m):
        with torch.inference_mode():
            m(batch)

    times = {}
    for name, m in (('kernel', model), ('plain', plain), ('plain', plain),
                    ('kernel', model)):
        times.setdefault(name, []).append(cuda_ms(lambda: forward(m), 10))
    n0 = batch[0].num_nodes
    ms = min(times['kernel'])
    print(f'flagship forward on {card}: {ms:.3f} ms '
          f'({n0 / ms * 1e3:.4g} level-0 points/s); with the plain '
          f'attention {min(times["plain"]):.3f} ms; rounds '
          f'{times} (CUDA events, 10 forwards each, after 3 warm-up)')
    print(f'peak device memory: '
          f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB')
    return launches


def main():
    check(os.path.isdir(os.path.join(HERE, 'superpoint_transformer_torch')),
          'run from a checkout of the repository (the port package '
          'superpoint_transformer_torch/ is not beside this script)')
    sys.path.insert(0, HERE)
    import torch
    check(torch.cuda.is_available(), 'no CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    nvcc = subprocess.run(
        [os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                      'bin', 'nvcc'), '--version'],
        capture_output=True, text=True).stdout.strip().splitlines()
    print(f'card: {card}')
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{nvcc[-1] if nvcc else "nvcc not found"}')
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)

    from superpoint_transformer_torch.ops import attention_rpe
    t0 = time.perf_counter()
    report = attention_rpe.build(force=True)
    print(f'built {attention_rpe.NVCC_FLAGS} in '
          f'{time.perf_counter() - t0:.2f} s')
    print(report.strip())

    k2 = phase_kernels(dev)
    launches = phase_serving(dev, card)
    check(launches > 0, 'the main path launched no K2 kernel')
    print(json.dumps({'kernels': [{
        'name': 'dense_attention_rpe',
        'route': 'cuda',
        'source': 'superpoint_transformer_torch/csrc/dense_attention_rpe.cu',
        'replaces': 'superpoint_transformer_tpu/ops/pallas_attention.py:256',
        'launches': launches,
        'max_abs_err': k2['max_abs_err'],
        'ms': k2['ms'],
        'plain_ms': k2['plain_ms']}]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
