"""The whole step's share of the chip's peak: DIN's model operations done
in the window (``flops.din_model_flops``; a training step's forward and
backward count three times the forward) over the window's host-clock
seconds times the published dense peak of the precision the path computes
in, %."""


def read(run):
    s = run["window"]["seconds"]
    return 100.0 * run["flops"] / (s * run["peak_flops"]) if s > 0 and run["flops"] else None
