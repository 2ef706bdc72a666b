"""train_pairs_per_s: path-pairs whose value and every requested gradient
the window's calls computed, over the window's seconds (host clock)."""


def read(run):
    return run.pairs / run.window_s if run.calls else None
