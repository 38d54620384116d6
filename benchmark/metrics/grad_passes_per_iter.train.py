"""The update's gradient passes (num_grad_passes) per iteration, mean over
the window's iterations: it shows where the KL stop, not the speed,
changed the work."""
from harness import readers


def read(ctx):
    return readers.per_iteration(ctx, 'grad_passes')
