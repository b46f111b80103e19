"""device_idle_pct.sample: the share of the traced stretch in which no kernel
or copy ran on the card (the union of the profiler's device intervals,
averaged over the cards)."""


def read(run):
    t = run.trace
    if t is None or run.kind != "sample":
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
