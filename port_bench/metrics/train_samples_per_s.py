"""train_samples_per_s: samples through the optimizer steps completed in
the window, all ranks, over the window's seconds (host clock,
synchronised at both ends)."""


def read(run):
    if run.kind != "train" or not run.window_s:
        return None
    return run.units / run.window_s
