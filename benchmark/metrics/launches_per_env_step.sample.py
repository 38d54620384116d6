"""launches_per_env_step of the sample cells: see harness/readers.py."""
from harness import readers


def read(ctx):
    return readers.launches_per_env_step(ctx)
