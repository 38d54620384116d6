"""Host-side utilities of the experiment driver (counterpart of
molgym_tpu/tools/util.py), with the same artifact formats: JSON-lines metric
streams `{tag}_{train|opt|eval}.txt`, pickled rollouts
`{tag}_steps-{n}_{info}.pkl`, the run tag `{name}_run-{seed}`, a JSON config
snapshot per run and a stream + file logger."""
from __future__ import annotations

import json
import logging
import os
import pickle
import sys
from typing import List

import numpy as np
import torch
from torch import nn


def get_tag(config: dict) -> str:
    return '{exp}_run-{seed}'.format(exp=config['name'], seed=config['seed'])


def save_config(config: dict, directory: str, tag: str) -> None:
    formatted = json.dumps(config, indent=4, sort_keys=True, default=str)
    logging.info(formatted)
    with open(os.path.join(directory, tag + '.json'), mode='w') as f:
        f.write(formatted)


def create_directories(directories: List[str]) -> None:
    for directory in directories:
        os.makedirs(directory, exist_ok=True)


def setup_logger(config: dict, directory: str, tag: str) -> None:
    logger = logging.getLogger()
    logger.setLevel(config.get('log_level', 'INFO'))
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    formatter = logging.Formatter(
        '%(asctime)s.%(msecs)03d %(levelname)s: %(message)s',
        datefmt='%Y-%m-%d %H:%M:%S')
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setFormatter(formatter)
    logger.addHandler(ch)
    fh = logging.FileHandler(os.path.join(directory, tag + '.log'))
    fh.setFormatter(formatter)
    logger.addHandler(fh)


def set_seeds(seed: int) -> None:
    """Seeds numpy and torch (the default generator of every device, which
    the model's initialization draws from)."""
    np.random.seed(seed)
    torch.manual_seed(seed)


class RolloutSaver:
    """Pickles rollouts (host numpy copies) as `{tag}_steps-{n}_{info}.pkl`."""

    def __init__(self, directory: str, tag: str) -> None:
        self.directory = directory
        self.tag = tag

    def save(self, obj: object, num_steps: int, info: str) -> None:
        path = os.path.join(self.directory,
                            f'{self.tag}_steps-{num_steps}_{info}.pkl')
        logging.debug(f'Saving rollout: {path}')
        with open(path, mode='wb') as f:
            pickle.dump(obj, f)


class InfoSaver:
    """Appends JSON lines to `{tag}_{name}.txt` (the JAX package's optional
    TensorBoard mirror is not ported)."""

    def __init__(self, directory: str, tag: str) -> None:
        self.directory = directory
        self.tag = tag

    def save(self, obj: dict, name: str) -> None:
        path = os.path.join(self.directory, f'{self.tag}_{name}.txt')
        logging.debug(f'Saving info: {path}')
        clean = {k: v.item() if isinstance(v, (np.generic, torch.Tensor))
                 else v for k, v in obj.items()}
        with open(path, mode='a') as f:
            f.write(json.dumps(clean))
            f.write('\n')


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
