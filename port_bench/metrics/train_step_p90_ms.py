"""train_step_p90_ms: the 90th percentile of every window step's duration,
the gap between CUDA events recorded at the ends of consecutive steps with
no synchronisation added (rank 0's)."""

import statistics


def read(run):
    if run.kind != "train" or not run.round_ms or len(run.round_ms) < 10:
        return None
    return statistics.quantiles(run.round_ms, n=10, method="inclusive")[-1]
