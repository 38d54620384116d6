"""Why does a trained policy's greedy evaluation end short? (counterpart of
experiments/stochastic_pm6/diagnose_seed2.py)

    python -m molgym_tpu_torch.tools.diagnose_greedy <model path> \\
        [--num_sampled N] [--seed S] [--device cpu]

The model path is the port's own checkpoint file (its run's configuration
read from `<run>/logs/<tag>.json` beside `<run>/models/`) or a JAX orbax
directory `<tag>_steps-<n>.model`, read from its committed
archive (ModelIO.load), whose metadata holds the run's configuration. The
run's evaluation env, reward and agent are built from that configuration
by the builders its driver uses (tools/driver.py's, run_stochastic's,
run_solvation's, run_scaffold's), on the card unless --device names
another device.

Two rollouts of the evaluation env, each from a torch.Generator seeded
with --seed, every env playing one episode of each evaluation formula in
turn (the protocol of chip_smoke.py's phase 14 and of
tests/test_torch_driver_checkpoints.py):
  * greedy, over GREEDY_ENVS envs: the mean return (phase 14's number),
    and the greedy episode step by step (env 0's first episode, and every
    episode that does not place its whole bag): the element placed, the
    focus atom, the distance, the nearest atom to the new position (the
    contact the action makes), the smallest interatomic distance with the
    new atom, the reward and done. This shows which action ends a short
    episode;
  * sampled, over --num_sampled envs (--eval_sample_k semantics): the mean
    episode length, the fraction of episodes that place every atom of
    their bag, the mean return and the best (a formula's best episode,
    averaged over the formulas: the eval stream's return_best_mean);
  * for an internal agent, its learned log-stds of the distance, angle and
    dihedral heads (the sampled policy's spread).

Each finding is printed on a line of its own; the last line is one JSON
object {"diagnose_greedy": {...}} with every number (`diagnose` returns it).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from molgym_tpu_torch.device import DeviceLike, resolve_device
from molgym_tpu_torch.periodic import CHEMICAL_SYMBOLS
from molgym_tpu_torch.rl.rollout import make_rollout_fn
from molgym_tpu_torch.spaces import ObservationSpace, symbols_to_zs
from molgym_tpu_torch.tools import driver
from molgym_tpu_torch.tools.model_io import (ModelIO, find_archive,
                                             read_archive_metadata)
from molgym_tpu_torch.tools.model_util import build_model

ASSETS = ('initial_structure', 'scaffold')
GREEDY_ENVS = 8
# (focus, element, distance) columns of each family's flat action
ACTION_COLUMNS = {'covariant': (0, 1, 2), 'internal': (1, 2, 3),
                  'mlp': (1, 2, 3)}


def run_config(model_path: str) -> dict:
    """The configuration of the run that wrote `model_path`: the archive's
    metadata of a JAX directory, or `<run>/logs/<tag>.json`. An
    asset (the solvation's solute, the scaffold) is looked up in the run's
    directory by its recorded path (an absolute one as it is) and then by
    its name."""
    model_path = os.path.normpath(model_path)
    run_dir = os.path.dirname(os.path.dirname(os.path.abspath(model_path)))
    if os.path.isdir(model_path):
        config = read_archive_metadata(find_archive(model_path))['config']
    else:
        tag = os.path.basename(model_path).split(ModelIO._steps_string)[0]
        with open(os.path.join(run_dir, 'logs', tag + '.json')) as f:
            config = json.load(f)
    for key in ASSETS:
        path = config.get(key)
        for candidate in ([os.path.join(run_dir, path),
                           os.path.join(run_dir, os.path.basename(path))]
                          if path else []):
            if os.path.exists(candidate):
                config[key] = candidate
                break
    return config


def env_builder(config: dict):
    """(the run's env builder, whether its reward has the solvation
    penalty), as the run's driver chose them."""
    if config.get('size_range'):
        from molgym_tpu_torch.run_stochastic import stochastic_envs
        return stochastic_envs, False
    if config.get('initial_structure'):
        from molgym_tpu_torch.run_solvation import solvation_envs
        return solvation_envs, True
    if config.get('scaffold'):
        from molgym_tpu_torch.run_scaffold import scaffold_envs
        return scaffold_envs, False
    return driver.standard_envs, False


class _PositionRecorder(nn.Module):
    """The agent, keeping each act's Cartesian positions: a rollout's
    trajectory holds the flat actions, not where an atom would go when the
    env refuses it."""

    def __init__(self, agent: nn.Module):
        super().__init__()
        self.agent = agent
        self.positions: List[torch.Tensor] = []

    def act(self, obs, generator, deterministic=False):
        out = self.agent.act(obs, generator, deterministic)
        self.positions.append(out.position)
        return out


def contacts(elements: np.ndarray, positions: np.ndarray,
             new_position: np.ndarray):
    """(the new position's distance to the nearest atom on the canvas, the
    smallest interatomic distance of the canvas with the new atom); nan
    where the canvas is empty (or holds one atom and no new one)."""
    occupied = positions[elements != 0]
    nearest = (float(np.linalg.norm(occupied - new_position, axis=-1).min())
               if len(occupied) else float('nan'))
    pairs = np.concatenate([occupied, new_position[None]])
    d = np.linalg.norm(pairs[:, None] - pairs[None], axis=-1)
    d = d[np.triu_indices(len(pairs), k=1)]
    return nearest, float(d.min()) if len(d) else float('nan')


def split_episodes(traj, positions: np.ndarray, zs: Sequence[int],
                   model: str, keep_steps) -> List[List[dict]]:
    """Each env's complete episodes, in order: length, return, atoms
    placed, whether the bag was emptied, the closest contact any of its
    actions made (nan for an episode of one atom), and, where
    `keep_steps(env, episode index, episode)` holds, its steps."""
    rewards = traj.rewards.cpu().numpy()
    terminals = traj.terminals.cpu().numpy()
    actions = traj.actions.cpu().numpy()
    elements = traj.obs.elements.cpu().numpy()
    obs_positions = traj.obs.positions.cpu().numpy()
    next_elements = traj.next_obs.elements.cpu().numpy()
    next_bag = traj.next_obs.bag.cpu().numpy()
    focus_col, element_col, distance_col = ACTION_COLUMNS[model]
    num_steps, num_envs = rewards.shape
    out = []
    for b in range(num_envs):
        episodes, steps = [], []
        for t in range(num_steps):
            nearest, min_dist = contacts(elements[t, b], obs_positions[t, b],
                                         positions[t, b])
            steps.append(dict(
                t=len(steps) + 1,
                element=CHEMICAL_SYMBOLS[zs[int(actions[t, b,
                                                        element_col])]],
                focus=int(actions[t, b, focus_col]),
                distance=float(actions[t, b, distance_col]),
                nearest=nearest, min_dist=min_dist,
                reward=float(rewards[t, b]), done=bool(terminals[t, b]),
                placed=bool((next_elements[t, b] != 0).sum()
                            > (elements[t, b] != 0).sum())))
            if not terminals[t, b]:
                continue
            start = t + 1 - len(steps)
            near = [s['nearest'] for s in steps if np.isfinite(s['nearest'])]
            episode = dict(
                length=len(steps), ret=float(sum(s['reward'] for s in steps)),
                atoms=int((next_elements[t, b] != 0).sum()
                          - (elements[start, b] != 0).sum()),
                complete=bool(next_bag[t, b].sum() == 0),
                closest_contact=min(near) if near else float('nan'))
            if keep_steps(b, len(episodes), episode):
                episode['steps'] = steps
            episodes.append(episode)
            steps = []
        out.append(episodes)
    return out


def play(env, agent, num_envs: int, num_formulas: int, deterministic: bool,
         seed: int, zs, model: str, keep_steps=lambda *_: False):
    """(episodes, trajectory): `num_envs` envs, each through one episode of
    every formula, greedy or sampled, from a generator seeded with `seed`;
    the first `num_formulas` episodes of each env (split_episodes)."""
    recorder = _PositionRecorder(agent)
    num_steps = num_formulas * (env.canvas_size + 1)
    gen = torch.Generator(device=env.device).manual_seed(seed)
    states = env.init_states(num_envs, gen)
    _states, traj = make_rollout_fn(env, agent, num_steps, deterministic)(
        recorder, states, gen)
    positions = torch.stack(recorder.positions[:num_steps]).cpu().numpy()
    episodes = split_episodes(traj, positions, zs, model, keep_steps)
    if any(len(e) < num_formulas for e in episodes):
        raise RuntimeError(f'an env ended fewer than {num_formulas} episodes '
                           f'in {num_steps} steps')
    return [e[:num_formulas] for e in episodes], traj


def load_run(model_path: str, device: DeviceLike = None):
    """(configuration, evaluation env, agent with the checkpoint's weights,
    steps) of `model_path`, on `device` (cuda unless named)."""
    dev = resolve_device(device)
    config = run_config(model_path)
    builder, solvation = env_builder(config)
    space = ObservationSpace(config['canvas_size'],
                             symbols_to_zs(config['symbols']))
    reward_fn, _host = driver.make_reward_fn(config, solvation=solvation)
    _train_env, env = builder(config, space, reward_fn, dev)
    agent = build_model(config, space, device=dev)
    state, steps = ModelIO(os.path.dirname(os.path.abspath(model_path)),
                           'unused').load(model_path, dev,
                                          family=config['model'],
                                          template=agent.state_dict())
    agent.load_state_dict(state['model'])
    return config, env, agent, steps


def diagnose(model_path: str, num_sampled: int = 16, seed: int = 1,
             device: DeviceLike = None) -> dict:
    """The greedy and sampled evaluation of `model_path` (see the module
    docstring) as a dict; `print_report` prints it."""
    config, env, agent, steps = load_run(model_path, device)
    zs = symbols_to_zs(config['symbols'])
    formulas = (config.get('eval_formulas') or config['formulas']).split(',')
    model = config['model']

    def short_or_first(b, i, episode):
        return (b == 0 and i == 0) or not episode['complete']

    greedy, _traj = play(env, agent, GREEDY_ENVS, len(formulas), True, seed,
                         zs, model, short_or_first)
    sampled, _traj = play(env, agent, num_sampled, len(formulas), False,
                          seed, zs, model)
    returns = np.array([[e['ret'] for e in env_eps] for env_eps in sampled])
    flat = [e for env_eps in sampled for e in env_eps]
    # the internal agents' learned log-stds of distance, angle and dihedral
    log_stds = getattr(agent, 'log_stds', None)
    return dict(
        model_path=model_path, steps=steps, model=model, formulas=formulas,
        device=str(env.device), seed=seed,
        log_stds=None if log_stds is None else log_stds.tolist(),
        greedy=dict(
            envs=GREEDY_ENVS,
            mean=float(np.mean([[e['ret'] for e in g] for g in greedy])),
            episodes=greedy),
        sampled=dict(
            envs=num_sampled,
            mean_length=float(np.mean([e['length'] for e in flat])),
            complete_fraction=float(np.mean([e['complete'] for e in flat])),
            mean=float(returns.mean()),
            best=float(returns.max(axis=0).mean()),
            best_by_formula=[float(r) for r in returns.max(axis=0)],
            mean_by_formula=[float(r) for r in returns.mean(axis=0)]))


def _step_line(s: dict) -> str:
    return (f'  step {s["t"]}: element {s["element"]} focus {s["focus"]} '
            f'distance {s["distance"]:.4f} nearest {s["nearest"]:.4f} '
            f'min_dist {s["min_dist"]:.4f} reward {s["reward"]:.5f} '
            f'done {s["done"]} placed {s["placed"]}')


def report_lines(result: dict) -> List[str]:
    """The lines `print_report` prints, the JSON line last."""
    g, s = result['greedy'], result['sampled']
    lines = [f'diagnose_greedy: {result["model_path"]} ({result["steps"]} '
             f'steps, {result["model"]}, formulas '
             f'{",".join(result["formulas"])}) on {result["device"]}, seed '
             f'{result["seed"]}',
             f'greedy: {g["envs"]} envs x {len(result["formulas"])} '
             f'episodes: mean return {g["mean"]:.6f}, lengths '
             + ' '.join(','.join(str(e['length']) for e in env_eps)
                        for env_eps in g['episodes'])]
    for b, env_eps in enumerate(g['episodes']):
        for i, e in enumerate(env_eps):
            if 'steps' not in e:
                continue
            lines.append(
                f'greedy episode: env {b} formula {result["formulas"][i]}: '
                f'length {e["length"]} return {e["ret"]:.5f} atoms '
                f'{e["atoms"]} complete {e["complete"]} closest contact '
                f'{e["closest_contact"]:.4f}')
            lines += [_step_line(step) for step in e['steps']]
    lines.append(
        f'sampled: {s["envs"]} envs x {len(result["formulas"])} episodes: '
        f'mean length {s["mean_length"]:.3f}, complete fraction '
        f'{s["complete_fraction"]:.3f}, mean return {s["mean"]:.6f}, best '
        f'{s["best"]:.6f}')
    if result['log_stds'] is not None:
        lines.append('log_stds (distance, angle, dihedral): ' + ' '.join(
            f'{x:.6f}' for x in result['log_stds']))
    lines.append(json.dumps({'diagnose_greedy': result}))
    return lines


def print_report(result: dict) -> None:
    for line in report_lines(result):
        print(line, flush=True)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Greedy and sampled evaluation of a trained policy, the '
                    'greedy episode step by step')
    parser.add_argument('model_path', help='the port\'s checkpoint file or '
                        'a JAX orbax directory <tag>_steps-<n>.model')
    parser.add_argument('--num_sampled', type=int, default=16,
                        help='sampled episodes of each formula (default 16)')
    parser.add_argument('--seed', type=int, default=1,
                        help='seed of both rollouts\' generators (default 1)')
    parser.add_argument('--device', default=None,
                        help='torch device (default: cuda)')
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    result = diagnose(args.model_path, num_sampled=args.num_sampled,
                      seed=args.seed, device=args.device)
    print_report(result)
    return result


if __name__ == '__main__':
    main()
