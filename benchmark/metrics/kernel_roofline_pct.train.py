"""kernel_roofline_pct of the train cells: see harness/readers.py."""
from harness import readers


def read(ctx):
    return readers.kernel_roofline_pct(ctx)
