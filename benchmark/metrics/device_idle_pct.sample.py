"""device_idle_pct of the sample cells: see harness/readers.py."""
from harness import readers


def read(ctx):
    return readers.device_idle_pct(ctx)
