"""geglu_roofline.train: the least time of the kernels of kinds geglu
(count/kernels.py, from the shapes that the plain reference's calls present)
over their device time, in rank 0's traced train rounds."""

KINDS = ("geglu",)


def read(run):
    t = run.trace
    if t is None or run.kind != "train" or not t.has(*KINDS):
        return None
    bound = sum(t.bounds_per_round.get(k, 0.0) for k in KINDS) * t.rounds
    return 100.0 * bound / t.kernel_seconds(*KINDS)
