#!/usr/bin/env python3
"""Time variants of the K3 CUDA kernel (`dense_attention_rpe_bwd`) against
each other on one NVIDIA GPU, and measure their f32 and bf16 errors.

    python tools/k3_variants_cuda.py [NAME=PATH.cu ...] [--patch P,...]
        [--rounds R] [--sweep-f64 S] [--bf16-precision S]

Each NAME=PATH.cu is a version of `csrc/dense_attention_rpe_bwd.cu` (for
example an older commit's, from `git show <rev>:<path> > PATH.cu`); the
checkout's own kernel is always built as `tree`. Sources compile with the
package's nvcc flags (and `-I csrc`, for `node_tiles.cuh`) into
`superpoint_transformer_torch/_build/variants/`, one nvcc each, all at
once. `--patch` adds, for every source in which a named patch applies,
a copy with each patch and one with all of them:

- `no_wgrad_fma`: without the FMAs of the block's weight and bias
  gradients (in the bf16 tile kernel and the f32 kernel, or in an older
  source's shared kernel);
- `warps4`: the bf16 tile kernel with at most 4 warps a block, not 8.

(Earlier versions had `no_def_fma` and `no_wgrad_mma`: the bf16 kernel's
edge-feature gradient has been on the tensor cores since d_ef moved there,
and no source has tensor-core weight gradients.)

A `no_wgrad_fma` copy computes wrong gradients: it is only timed. Every variant
is timed at the flagship training level-1 shape (N=5120, K=48, H=16,
D=4, C=64, De=32) in bf16, then in f32, as a CUDA graph of 20 calls, in
R rounds that go forward and back over the variants; the best round is
reported. Then:

- `--sweep-f64 S`: the `tree` kernel in f32 at that shape over seeds
  0..S-1 (the card test's inputs), against autograd of the plain version
  in f64: the worst |error| / (atol + rtol |ref|) under K3's tolerance;
  beside it the same for the kernel given the f64 forward's out and lse,
  for autograd of the f32 plain version, and kernel vs that autograd;
- `--bf16-precision S`: the weight gradients of every unpatched variant
  in bf16 over seeds 0..S-1, against the plain version in f32 and in f64.

Prints the card and its power limit first. Needs a CUDA device and nvcc.
"""
import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tests'))

CSRC = os.path.join(ROOT, 'superpoint_transformer_torch', 'csrc')
OUT = os.path.join(ROOT, 'superpoint_transformer_torch', '_build',
                   'variants')
PATCHES = {
    'no_wgrad_fma': [
        ('acc[it][ee] = fma_acc(er[ee], gr, acc[it][ee]);', ';'),
        ('acc[it][ee][cc] = fmaf(efv[ee], gcol[cc],\n'
         '                                           acc[it][ee][cc]);', ';'),
        ('acc[it][0][0] += gv4.x;', ';'), ('acc[it][0][1] += gv4.y;', ';'),
        ('acc[it][0][2] += gv4.z;', ';'), ('acc[it][0][3] += gv4.w;', ';')],
    'warps4': [('constexpr int MAX_BLOCK_WARPS = 8;',
                'constexpr int MAX_BLOCK_WARPS = 4;')],
}
# the blocks query of sources before the bf16 tile kernel: N alone
OLD_BLOCKS = 'dense_attention_rpe_bwd_blocks(int N)'
SHAPE = dict(N=5120, K=48, H=16, D=4, C=64, De=32)
K3_TOL = dict(rtol=2e-3, atol=2e-4)


def patched(text, p):
    """`text` with every rule of patch `p` that applies, or None."""
    out = text
    for old, new in PATCHES[p]:
        out = out.replace(old, new)
    return out if out != text else None


def sources(named, patches):
    """{variant name: source text} for the named files and their patched
    copies."""
    out = {}
    for name, path in named.items():
        with open(path) as f:
            text = f.read()
        out[name] = text
        applied = []
        for p in patches:
            copy = patched(text, p)
            if copy is not None:
                out[f'{name}:{p}'] = copy
                applied.append(p)
        if len(applied) > 1:
            both = text
            for p in applied:
                both = patched(both, p)
            out[f'{name}:{"+".join(applied)}'] = both
    return out


def build(texts):
    """Compile every source at once; {name: (library path, whether its
    blocks query takes N alone)}."""
    from superpoint_transformer_torch.ops import cuda_build
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for i, (name, text) in enumerate(texts.items()):
        src = os.path.join(OUT, f'v{i}.cu')
        with open(src, 'w') as f:
            f.write(text)
        lib = os.path.join(OUT, f'libv{i}.so')
        jobs[name] = (subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, '-I', CSRC, '-o',
             lib, src], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), lib, OLD_BLOCKS in text)
    libs = {}
    for name, (proc, lib, old) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on {name}:\n{err}')
        report(name, err)
        libs[name] = (lib, old)
    return libs


def report(name, text):
    """The registers and spills of the flagship instantiations (the bf16
    tile kernel <8, 2, 1> or an older source's bf16 kernel, and the f32
    kernel with two column tiles a lane) from nvcc's -Xptxas -v report."""
    import re
    kernel = None
    flagship = ('tiles_kernelILi8ELi2ELi1E', 'bwd_kernelIfLi2E',
                'bwd_kernelILi2E', 'bwd_kernelI13__nv_bfloat16Li2E')
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = next((f for f in flagship if f in m.group(1)), None)
        elif kernel and ('registers' in line or 'spill' in line):
            info = re.sub(r'^ptxas info\s*:\s*', '', line.strip())
            print(f'  {name} <{kernel}>: {info}')


def bind(path, old_blocks):
    lib = ctypes.CDLL(path)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    blocks = lib.dense_attention_rpe_bwd_blocks
    blocks.argtypes = [i] if old_blocks else [i] * 7
    blocks.restype = i
    fn = lib.dense_attention_rpe_bwd_launch
    fn.argtypes = ([i, p, p, ll, p, ll] + [p] * 18 + [i] * 6 + [p])
    fn.restype = i
    if old_blocks:
        return (lambda is_bf16, N, *shape: blocks(N)), fn
    return blocks, fn


def use(k3, launcher):
    """Route the wrapper `dense_attention_rpe_bwd` to `launcher`."""
    k3._bwd_launcher = lambda: launcher


def worst_ratio(got, ref):
    """(worst |got - ref| / (atol + rtol |ref|), its flat index, |err|)."""
    err = (got.double() - ref.double()).abs()
    r = err / (K3_TOL['atol'] + K3_TOL['rtol'] * ref.double().abs())
    i = int(r.argmax())
    return r.flatten()[i].item(), i, err.flatten()[i].item()


def timing(dev, launchers, rounds, dtype):
    import torch
    import chip_smoke as cs
    from superpoint_transformer_torch.ops import attention_rpe as k3
    gen = torch.Generator().manual_seed(7)
    args = cs.k2_inputs(gen, dtype=dtype, dev=dev, masked_rows=0, **SHAPE)
    g = torch.randn(SHAPE['N'], SHAPE['H'], SHAPE['C'] // SHAPE['H'],
                    generator=gen).to(dev)
    out, lse = k3.dense_attention_rpe(*args, with_lse=True)
    names = list(launchers)
    times = {n: [] for n in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            use(k3, launchers[name])
            times[name].append(cs.graph_ms(
                lambda: k3.dense_attention_rpe_bwd(*args, out, lse, g), 20))
    label = 'bf16' if dtype == torch.bfloat16 else 'f32'
    for name in names:
        print(f'K3 {label} N={SHAPE["N"]} K={SHAPE["K"]} {name}: '
              f'{min(times[name]):.4f} ms; rounds '
              f'{[round(t, 4) for t in times[name]]}', flush=True)
    # every unpatched variant's ten gradients against the tree's, bit for
    # bit (a variant that only reorders the code gives the same bits)
    grads = {}
    for name in names:
        if ':' not in name:
            use(k3, launchers[name])
            grads[name] = k3.dense_attention_rpe_bwd(*args, out, lse, g)
    for name, got in grads.items():
        if name != 'tree':
            same = all(torch.equal(a, b) for a, b in zip(got, grads['tree']))
            print(f'K3 {label} {name} bit-equal to tree: {same}', flush=True)


def fwd64(args):
    """out and lse of the plain forward in f64, rounded to f32."""
    from superpoint_transformer_torch.ops import attention_rpe as k3
    out, lse = k3.dense_attention_rpe_reference(
        *[a.double() for a in args[:10]], *args[10:], with_lse=True)
    return out.float(), lse.float().contiguous()


def sweep_f64(dev, launcher, seeds):
    import torch
    from test_torch_cuda import K3_GRADS, _inputs, _randn
    from superpoint_transformer_torch.ops import attention_rpe as k3
    use(k3, launcher)
    worst = (0.0,)
    for seed in range(seeds):
        args = _inputs(dev, torch.float32, seed=seed, masked_rows=100,
                       **SHAPE)
        g = _randn(dev, seed, SHAPE['N'], SHAPE['H'],
                   SHAPE['C'] // SHAPE['H'])
        out, lse = k3.dense_attention_rpe(*args, with_lse=True)
        grads = k3.dense_attention_rpe_bwd(*args, out, lse, g)
        exact = k3.dense_attention_rpe_bwd(*args, *fwd64(args), g)
        leaves = [a.double().requires_grad_() for a in args[:10]]
        (k3.dense_attention_rpe_reference(*leaves, *args[10:])
         * g.double()).sum().backward()
        l32 = [a.clone().requires_grad_() for a in args[:10]]
        (k3.dense_attention_rpe_reference(*l32, *args[10:]) * g).sum() \
            .backward()
        rows = sorted((worst_ratio(a, t.grad), name)
                      for name, a, t in zip(K3_GRADS, grads, leaves))
        (r, i, err), name = rows[-1]
        others = [max(worst_ratio(a, b)[0] for a, b in pairs) for pairs in (
            zip(exact, (t.grad for t in leaves)),
            zip((t.grad for t in l32), (t.grad for t in leaves)),
            zip(grads, (t.grad for t in l32)))]
        print(f'f32 vs f64 seed {seed}: worst {name} [flat {i}] |err| '
              f'{err:.3e}, {r:.4f} of the tolerance; next {rows[-2][1]} '
              f'{rows[-2][0][0]:.4f}. Worst over the ten gradients: the '
              f'kernel from an f64 out/lse {others[0]:.4f}, autograd in f32 '
              f'vs f64 {others[1]:.4f}, the kernel vs autograd in f32 '
              f'{others[2]:.4f}', flush=True)
        worst = max(worst, (r, seed, name, i, err))
    print(f'f32 vs f64 over {seeds} seeds: worst {worst}', flush=True)


def bf16_precision(dev, launchers, seeds):
    import torch
    from test_torch_cuda import _inputs, _randn
    from superpoint_transformer_torch.ops import attention_rpe as k3
    for seed in range(seeds):
        args = _inputs(dev, torch.bfloat16, seed=seed, masked_rows=64,
                       **SHAPE)
        g = _randn(dev, seed, SHAPE['N'], SHAPE['H'],
                   SHAPE['C'] // SHAPE['H'])
        out, lse = k3.dense_attention_rpe(*args, with_lse=True)
        ref32 = k3.dense_attention_rpe_bwd_reference(*args, out, lse, g)
        ref64 = k3.dense_attention_rpe_bwd_reference(
            *[a.double() for a in args[:10]], *args[10:], out, lse, g)
        line = [f'bf16 weight gradients seed {seed}: plain f32 vs f64 '
                f'{max(worst_ratio(a, b)[0] for a, b in zip(ref32[4:], ref64[4:])):.3f}']
        for name, launcher in launchers.items():
            use(k3, launcher)
            got = k3.dense_attention_rpe_bwd(*args, out, lse, g)[4:]
            r32 = max(worst_ratio(a, b)[0] for a, b in zip(got, ref32[4:]))
            r64 = max(worst_ratio(a, b)[0] for a, b in zip(got, ref64[4:]))
            line.append(f'{name} vs f32 {r32:.3f}, vs f64 {r64:.3f}')
        print('; '.join(line), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('variants', nargs='*', help='NAME=PATH.cu')
    ap.add_argument('--patch', default='',
                    help=f'comma-separated, of {sorted(PATCHES)}')
    ap.add_argument('--rounds', type=int, default=4,
                    help='timing rounds (0: no timing)')
    ap.add_argument('--sweep-f64', type=int, default=0)
    ap.add_argument('--bf16-precision', type=int, default=0)
    opt = ap.parse_args()
    import torch
    import chip_smoke as cs
    from superpoint_transformer_torch.ops import attention_rpe as k3
    if not torch.cuda.is_available():
        raise SystemExit('k3_variants_cuda: no CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda', 0)
    print(f'card: {cs.card_line()}', flush=True)
    named = dict(v.split('=', 1) for v in opt.variants)
    named['tree'] = os.path.join(CSRC, 'dense_attention_rpe_bwd.cu')
    patches = [p for p in opt.patch.split(',') if p]
    for p in patches:
        if p not in PATCHES:
            raise SystemExit(f'unknown patch {p}')
    launchers = {n: bind(*lib) for n, lib in
                 build(sources(named, patches)).items()}
    if opt.rounds:
        for dtype in (torch.bfloat16, torch.float32):
            timing(dev, launchers, opt.rounds, dtype)
    if opt.bf16_precision:
        bf16_precision(dev, {n: launchers[n] for n in named},
                       opt.bf16_precision)
    if opt.sweep_f64:
        sweep_f64(dev, launchers['tree'], opt.sweep_f64)


if __name__ == '__main__':
    main()
