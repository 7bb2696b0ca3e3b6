"""What the metric readers (`metrics/<name>.py`) share. A reader takes
the run's record (`kinds/*.py`) and returns a number, or None where the
run has nothing to read (no trace, no card in the table of peaks, no
launch of the kernel)."""
import sys

from .cost import attention_launches, batch_flops, kernel_bound_s, peaks

__all__ = ['points_per_s', 'mfu', 'h2d_ms', 'launches', 'roofline',
           'idle_pct']


def points_per_s(run, train):
    """Valid level-0 points of every step or request of the window over
    the window's seconds."""
    if run['train'] != train:
        return None
    return float(sum(run['points'])) / run['window_s']


def mfu(run, train):
    """Model FLOPs of every step or request of the window (the
    benchmark's own count at the valid sizes) over the window's seconds,
    as a share of the card's bf16 peak, in %."""
    peak = peaks(run['kind_name'])
    if run['train'] != train or peak is None:
        return None
    flops = sum(batch_flops(run['model'], run['sizes'][i], train)
                for i in run['order'])
    return 100.0 * flops / run['window_s'] / peak['bf16_flop_s']


def h2d_ms(run, train):
    """Device time of host-to-device copies a step or request in the
    traced stretch, in ms."""
    t = run['trace']
    if t is None or run['train'] != train:
        return None
    return 1e3 * t.device_seconds('gpu_memcpy', 'HtoD') / t.steps


def launches(run, train):
    """Device kernel launches a step or request in the traced stretch."""
    t = run['trace']
    if t is None or run['train'] != train:
        return None
    return t.count('kernel') / t.steps


def roofline(run, train, kernel, pattern):
    """The summed least time of the stretch's calls of `kernel` (at the
    valid sizes of each launch) over the summed device time of the
    kernels whose name matches `pattern`, in %, over the steps or
    requests of the stretch whose launches of it the trace holds, as
    many as the cost model counts. None where no step or request has
    them all."""
    t, peak = run['trace'], peaks(run['kind_name'])
    if t is None or peak is None or run['train'] != train:
        return None
    found = t.per_step('kernel', pattern)
    if len(found) != len(run['stretch']):
        print(f'roofline: {len(found)} step spans in the trace, '
              f'{len(run["stretch"])} steps run; not read', file=sys.stderr)
        return None
    bound, seconds, short = 0.0, 0.0, []
    for i, durations in zip(run['stretch'], found):
        expect = len(attention_launches(run['model'], run['sizes'][i]))
        if len(durations) != expect:
            short.append(f'{len(durations)} of {expect}')
            continue
        bound += kernel_bound_s(kernel, run['model'], run['sizes'][i], peak)
        seconds += sum(durations)
    if short:
        print(f'roofline: {kernel} launches found in {len(short)} of '
              f'{len(found)} steps differ from the cost model\'s count '
              f'({", ".join(short)}); those steps are left out',
              file=sys.stderr)
    return 100.0 * bound / seconds if seconds > 0 else None


def idle_pct(run, train):
    """The share of the traced window in which no kernel or copy ran on
    the device, in %."""
    t = run['trace']
    if t is None or run['train'] != train:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
