"""Model factory (counterpart of molgym_tpu/tools/model_util.py); the port
has the covariant agent only."""
from __future__ import annotations

from torch import nn

from molgym_tpu_torch.device import DeviceLike
from molgym_tpu_torch.spaces import ObservationSpace


def build_model(config: dict, observation_space: ObservationSpace,
                device: DeviceLike = None) -> nn.Module:
    """The agent of `config['model']` on `device` (cuda unless named), for
    a config that arg_parser.check_supported accepts."""
    if config['model'] != 'covariant':
        raise NotImplementedError(
            f"model '{config['model']}' is not yet ported (ROADMAP.md "
            'Queue 2 item 6)')
    from molgym_tpu_torch.agents.covariant import CovariantAC
    beta = config.get('beta')
    return CovariantAC(
        zs=tuple(observation_space.zs),
        canvas_size=observation_space.canvas_size,
        network_width=config['network_width'],
        maxl=config['maxl'],
        num_cg_levels=config['num_cg_levels'],
        num_channels_hidden=config['num_channels_hidden'],
        num_channels_per_element=config['num_channels_per_element'],
        num_gaussians=config['num_gaussians'],
        bag_scale=config['bag_scale'],
        min_max_distance=(config['min_mean_distance'],
                          config['max_mean_distance']),
        beta=float(beta) if beta is not None else None,
        encoder_dtype=config.get('encoder_dtype'),
        device=device)
