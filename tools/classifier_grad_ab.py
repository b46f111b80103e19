#!/usr/bin/env python3
"""Time the classifier-guidance gradient call of one tree of the repository
on a CUDA card: the chest classifier (model channels 64, f32, seeded
weights) with each attending pool, ``make_classifier_grad`` at the guided
sampler's B=8 on the 32^2 x 8 latent. Prints, for each pool, the best of
three runs of 50 eager calls (CUDA events) and the device time of a call
split into the attention backward kernels, the attention forward and the
rest (``torch.profiler``, 5 calls). To hold two trees against each other,
run them in turns on one card (parent, change, change, parent):

    git archive HEAD | tar -x -C _chip/parent_tree
    for t in _chip/parent_tree . . _chip/parent_tree; do
        python3 tools/classifier_grad_ab.py $t; done
"""

import argparse
import sys


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("tree", help="root of the tree whose port to import")
    args = parser.parse_args()
    sys.path.insert(0, args.tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("classifier_grad_ab: no CUDA device")
    from medfusion_tpu_torch.cli.presets import PRESETS, seeded
    from medfusion_tpu_torch.cli.train_classifier import build_classifier
    from medfusion_tpu_torch.ops import build
    from medfusion_tpu_torch.pipelines.diffusion import make_classifier_grad

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for pool in ("adaptive", "attention"):
        with seeded(torch.device("cuda"), 0):
            clf = build_classifier(PRESETS["chest"], 64, pool).eval()
        x = torch.randn((8, 8, 32, 32), generator=gen, device="cuda")
        t = torch.full((8,), 500, device="cuda")
        fn = make_classifier_grad(clf, torch.ones(8, dtype=torch.long, device="cuda"))
        for _ in range(5):
            fn(x, t)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        best = float("inf")
        for _ in range(3):
            start.record()
            for _ in range(50):
                fn(x, t)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 50)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn(x, t)
            torch.cuda.synchronize()
        device = {"attention backward": 0.0, "attention forward": 0.0, "other": 0.0}
        for ev in prof.key_averages():
            kind = ("attention backward" if "flash_bwd" in ev.key
                    else "attention forward" if "flash_fwd" in ev.key else "other")
            device[kind] += ev.self_device_time_total / 1e3 / 5
        print(f"{args.tree} {pool} pool: {best:.4f} ms a call (best of 3 x 50); device ms "
              + ", ".join(f"{k} {v:.4f}" for k, v in device.items()), flush=True)


if __name__ == "__main__":
    main()
