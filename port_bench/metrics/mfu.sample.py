"""mfu.sample: model FLOPs done in the traced stretch (count/work.py, on the
plain reference) over the chips' bf16 peak for its seconds."""

from port_bench.count.peaks import H100


def read(run):
    t = run.trace
    if t is None or run.kind != "sample":
        return None
    flops = t.flops_per_round * t.rounds * t.chips
    return 100.0 * flops / (t.chips * H100["bf16_flops_per_s"] * t.window_s)
