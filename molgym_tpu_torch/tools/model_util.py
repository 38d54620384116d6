"""Model factory (counterpart of molgym_tpu/tools/model_util.py)."""
from __future__ import annotations

from torch import nn

from molgym_tpu_torch.device import DeviceLike
from molgym_tpu_torch.spaces import ObservationSpace


def build_model(config: dict, observation_space: ObservationSpace,
                device: DeviceLike = None) -> nn.Module:
    """The agent of `config['model']` (internal, mlp or covariant) on
    `device` (cuda unless named), for a config that
    arg_parser.check_supported accepts."""
    model = config['model']
    min_max = (config['min_mean_distance'], config['max_mean_distance'])
    if model == 'internal':
        from molgym_tpu_torch.agents.schnet import make_schnet_agent
        return make_schnet_agent(
            num_zs=observation_space.num_zs,
            canvas_size=observation_space.canvas_size,
            network_width=config['network_width'],
            min_max_distance=min_max,
            n_interactions=config.get('num_interactions', 3), device=device)
    if model == 'mlp':
        from molgym_tpu_torch.agents.internal import make_mlp_internal_agent
        return make_mlp_internal_agent(
            num_zs=observation_space.num_zs,
            canvas_size=observation_space.canvas_size,
            network_width=config['network_width'],
            min_max_distance=min_max, device=device)
    if model != 'covariant':
        raise RuntimeError(f"Model '{model}' is not available.")
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
        min_max_distance=min_max,
        beta=float(beta) if beta is not None else None,
        encoder_dtype=config.get('encoder_dtype'),
        device=device)
