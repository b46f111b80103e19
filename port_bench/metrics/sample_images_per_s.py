"""sample_images_per_s: decoded images completed in the window over the
window's seconds (host clock, synchronised at both ends)."""


def read(run):
    if run.kind != "sample" or not run.window_s:
        return None
    return run.units / run.window_s
