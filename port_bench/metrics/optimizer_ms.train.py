"""optimizer_ms.train: device ms a step of the AdamW and EMA kernels
(multi-tensor and Adam kernels by name), rank 0's traced steps."""


def read(run):
    t = run.trace
    if t is None or run.kind != "train" or not t.has("optimizer"):
        return None
    return t.kernel_seconds("optimizer") / t.rounds * 1e3
