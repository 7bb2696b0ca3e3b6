"""setup_s (s, lower is better): process start to the first timed step or
request: imports, the card's context, kernel build or load, weights, the
pool of batches, warm-up."""


def read(run):
    return run['setup_s']
