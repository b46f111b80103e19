"""nccl_ms.train: device ms a step of NCCL's kernels, rank 0's traced
steps."""


def read(run):
    t = run.trace
    if t is None or run.kind != "train" or not t.has("nccl"):
        return None
    return t.kernel_seconds("nccl") / t.rounds * 1e3
