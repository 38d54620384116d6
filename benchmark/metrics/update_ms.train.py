"""Host-clock ms of compute_ppo_data plus the update, ended by a
synchronize, mean over the window's iterations."""
from harness import readers


def read(ctx):
    return readers.mean_ms(ctx, 'update_s')
