"""Host-clock ms of a PPO iteration's rollout, ended by a synchronize, mean
over the window's iterations."""
from harness import readers


def read(ctx):
    return readers.mean_ms(ctx, 'rollout_s')
