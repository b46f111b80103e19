"""unet_fwd_ms.sample: mean device ms of one estimator call in the traced
chunk, between CUDA events in forward hooks at its entry and exit."""


def read(run):
    t = run.trace
    if t is None or run.kind != "sample" or not t.hooks.get("unet"):
        return None
    return sum(t.hooks["unet"]) / len(t.hooks["unet"])
