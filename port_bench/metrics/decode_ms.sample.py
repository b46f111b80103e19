"""decode_ms.sample: mean device ms of one chunk's decode, between CUDA
events in forward hooks at the VAE decoder's first and last block."""


def read(run):
    t = run.trace
    if t is None or run.kind != "sample" or not t.hooks.get("decode"):
        return None
    return sum(t.hooks["decode"]) / len(t.hooks["decode"])
