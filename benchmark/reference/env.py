"""Plain reference of the MolGym environment's step (Simm et al., ICML
2020) with the device Lennard-Jones reward, and of what a reset must give.

`transition` recomputes, for each env, the step from an observation and the
policy's flat action: where the new atom goes, whether the action is valid,
the reward, the next canvas and bag, and whether the episode ends.
`reset_ok` says whether an observation is a fresh episode of the
configuration: an empty canvas and a bag of its formula, or a bag the
stochastic sampler may draw (its size in range, only the formula's
elements, an even total valence). Nothing of the program is imported.
"""
from __future__ import annotations

from typing import Dict, List

import torch

SYMBOLS = ('X H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr '
           'Mn Fe Co Ni Cu Zn Ga Ge As Se Br Kr').split()
# covalent radii in Angstrom (Cordero et al. 2008), 1.5 for the others
COVALENT_RADII = {0: 0.20, 1: 0.31, 2: 0.28, 3: 1.28, 4: 0.96, 5: 0.84,
                  6: 0.76, 7: 0.71, 8: 0.66, 9: 0.57, 10: 0.58, 11: 1.66,
                  12: 1.41, 13: 1.21, 14: 1.11, 15: 1.07, 16: 1.05, 17: 1.02,
                  18: 1.06, 19: 2.03, 20: 1.76, 35: 1.20}
# elements that must lie near a heavy atom (H, F, Cl, Br)
SOLO_ZS = (1, 9, 17, 35)
# valences of the stochastic bag's parity rule
BOND_COUNT = {1: 1, 5: 3, 6: 4, 7: 3, 8: 2, 9: 1}
LJ_EPSILON = 0.15


def symbols_to_zs(symbols: str) -> List[int]:
    return [SYMBOLS.index(s.strip()) for s in symbols.split(',')]


def formula_counts(formula: str, zs: List[int]) -> List[int]:
    """'C2H6O' -> counts per entry of zs."""
    counts = [0] * len(zs)
    i = 0
    while i < len(formula):
        j = i + 1
        while j < len(formula) and formula[j].islower():
            j += 1
        k = j
        while k < len(formula) and formula[k].isdigit():
            k += 1
        counts[zs.index(SYMBOLS.index(formula[i:j]))] += int(formula[j:k] or 1)
        i = k
    return counts


def settings(config: dict) -> dict:
    zs = symbols_to_zs(config['symbols'])
    size = config.get('size_range')
    return dict(zs=zs, canvas=int(config['canvas_size']),
                formula=formula_counts(config['formulas'].split(',')[0], zs),
                min_distance=float(config['min_atomic_distance']),
                solo_distance=float(config['max_solo_distance']),
                min_reward=float(config['min_reward']),
                size_range=(tuple(int(x) for x in size.split(','))
                            if size else None))


def lennard_jones(positions, zs_atomic, new_pos, new_z, valid, dtype=torch.float32):
    """-sum over the canvas of 4 eps ((s/r)^12 - (s/r)^6), s at the sum of
    covalent radii over 2^(1/6); computed in `dtype`."""
    device = positions.device
    sigma = torch.tensor([2 * COVALENT_RADII.get(z, 1.5) / 2 ** (1 / 6)
                          for z in range(36)], device=device, dtype=dtype)
    d = positions.to(dtype) - new_pos.to(dtype)[:, None]
    r2 = (d * d).sum(-1).clamp(min=1e-4)
    s = 0.5 * (sigma[zs_atomic.clamp(0, 35)] + sigma[new_z.clamp(0, 35)][:, None])
    s6 = (s * s / r2) ** 3
    e = torch.where(zs_atomic > 0, 4 * LJ_EPSILON * (s6 * s6 - s6),
                    torch.zeros_like(s6)).sum(-1)
    return torch.where(valid, -e, torch.zeros_like(e)).float()


def transition(s: dict, elements, positions, bag, actions,
               reward_dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The step of every env from (elements, positions, bag) under the flat
    actions: the next canvas, bag, reward and end, and `margin`, how near
    the step lies to one of its thresholds (a distance limit, the least
    reward), where float rounding may decide either way."""
    device = positions.device
    B, N = elements.shape
    zs = torch.tensor(s['zs'], device=device)
    rows = torch.arange(B, device=device)
    slots = torch.arange(N, device=device)[None]
    n = (elements != 0).sum(-1)
    focus = torch.round(actions[:, 0]).long()
    element = torch.round(actions[:, 1]).long()
    new = positions[rows, focus] + actions[:, 2:3] * actions[:, 3:6]
    new = torch.where((n == 0)[:, None], torch.zeros_like(new), new)

    occupied = slots < n[:, None]
    d = positions - new[:, None]
    dist = torch.sqrt((d * d).sum(-1).clamp(min=1e-12))
    solo = torch.tensor([z in SOLO_ZS for z in s['zs']], device=device)
    heavy = occupied & ~solo[elements]
    valid = ~(occupied & (dist < s['min_distance'])).any(-1)
    valid &= (n == 0) | ~solo[element] | (heavy & (dist < s['solo_distance'])).any(-1)
    valid &= (bag[rows, element] > 0) & (n < N)
    stop = zs[element] == 0
    raw = lennard_jones(positions, zs[elements] * occupied, new, zs[element],
                        ~stop & valid, reward_dtype)
    reward = torch.where(stop, torch.zeros_like(raw),
                         torch.where(valid, raw.clamp(min=s['min_reward']),
                                     torch.full_like(raw, s['min_reward'])))
    place = valid & ~stop
    at = place[:, None] & (slots == n[:, None])
    next_elements = torch.where(at, element[:, None], elements)
    next_positions = torch.where(at[..., None], new[:, None], positions)
    next_bag = bag - place[:, None].long() * torch.nn.functional.one_hot(
        element, bag.shape[1])
    done = (stop | ~valid | (place & (raw < s['min_reward']))
            | (n + place.long() >= N) | (next_bag.sum(-1) == 0))
    near = torch.minimum((dist - s['min_distance']).abs(),
                         (dist - s['solo_distance']).abs())
    near = torch.where(occupied, near, torch.full_like(near, 1e9)).amin(-1)
    margin = torch.minimum(near, torch.where(place, (raw - s['min_reward']).abs(),
                                             torch.full_like(raw, 1e9)))
    return dict(elements=next_elements, positions=next_positions, bag=next_bag,
                reward=reward, done=done, new=new, margin=margin)


def reset_ok(s: dict, elements, positions, bag) -> torch.Tensor:
    """Per env: is this observation a fresh episode of the configuration?"""
    empty = (elements == 0).all(-1) & (positions == 0).all(-1).all(-1)
    formula = torch.tensor(s['formula'], device=bag.device)
    if s['size_range'] is None:
        return empty & (bag == formula).all(-1)
    lo, hi = s['size_range']
    size = bag.sum(-1)
    valence = torch.tensor([BOND_COUNT.get(z, 0) for z in s['zs']],
                           device=bag.device)
    in_support = ((bag == 0) | (formula > 0)).all(-1) & (bag >= 0).all(-1)
    return (empty & in_support & (size >= lo) & ((size < hi) | (size == lo))
            & ((bag * valence).sum(-1) % 2 == 0))
