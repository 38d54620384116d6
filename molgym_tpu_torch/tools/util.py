"""Host-side utilities of the experiment driver (counterpart of
molgym_tpu/tools/util.py), with the same artifact formats: JSON-lines metric
streams `{tag}_{train|opt|eval}.txt`, pickled rollouts
`{tag}_steps-{n}[_rank-{r}]_{info}.pkl`, the run tag `{name}_run-{seed}`, a
JSON config snapshot per run, a stream + file logger and an optional
TensorBoard mirror of the metric streams."""
from __future__ import annotations

import json
import logging
import os
import pickle
import sys
from typing import List, Optional

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


def setup_logger(config: dict, directory: Optional[str], tag: str) -> None:
    """Logs at config's level to stdout and to `{directory}/{tag}.log`
    (stdout only without a directory)."""
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
    if directory is not None:
        fh = logging.FileHandler(os.path.join(directory, tag + '.log'))
        fh.setFormatter(formatter)
        logger.addHandler(fh)


def set_seeds(seed: int) -> None:
    """Seeds numpy and torch (the default generator of every device, which
    the model's initialization draws from)."""
    np.random.seed(seed)
    torch.manual_seed(seed)


class RolloutSaver:
    """Pickles rollouts (host numpy copies) as `{tag}_steps-{n}_{info}.pkl`,
    `{tag}_steps-{n}_rank-{rank}_{info}.pkl` with a rank (each process of a
    --multihost run; tools/analysis.py parses the tag)."""

    def __init__(self, directory: str, tag: str,
                 rank: Optional[int] = None) -> None:
        self.directory = directory
        self.tag = tag
        self.rank = rank

    def save(self, obj: object, num_steps: int, info: str) -> None:
        rank = '' if self.rank is None else f'_rank-{self.rank}'
        path = os.path.join(self.directory,
                            f'{self.tag}_steps-{num_steps}{rank}_{info}.pkl')
        logging.debug(f'Saving rollout: {path}')
        with open(path, mode='wb') as f:
            pickle.dump(obj, f)


class InfoSaver:
    """Appends JSON lines to `{tag}_{name}.txt`. With a `tensorboard_dir`
    it also mirrors each record's finite numbers as scalars `{name}/{key}`
    at step total_num_steps through torch.utils.tensorboard, into
    `{tensorboard_dir}/{tag}`; without the tensorboard package it warns and
    writes JSON lines only, as the JAX package does without tensorboardX."""

    def __init__(self, directory: str, tag: str,
                 tensorboard_dir: Optional[str] = None) -> None:
        self.directory = directory
        self.tag = tag
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                logging.warning('tensorboard not available; JSONL only')
            else:
                self._tb = SummaryWriter(os.path.join(tensorboard_dir, tag))

    def save(self, obj: dict, name: str) -> None:
        path = os.path.join(self.directory, f'{self.tag}_{name}.txt')
        logging.debug(f'Saving info: {path}')
        clean = {k: v.item() if isinstance(v, (np.generic, torch.Tensor))
                 else v for k, v in obj.items()}
        with open(path, mode='a') as f:
            f.write(json.dumps(clean))
            f.write('\n')
        if self._tb is not None:
            step = clean.get('total_num_steps', 0)
            for key, value in clean.items():
                if (key != 'total_num_steps'
                        and isinstance(value, (int, float))
                        and np.isfinite(value)):
                    self._tb.add_scalar(f'{name}/{key}', value, step)
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


class MemoryInfoSaver:
    """An InfoSaver that keeps the records in memory, as (name, record)
    pairs in `lines`, for a caller of batch_ppo that reads them back."""

    def __init__(self) -> None:
        self.lines: List[tuple] = []

    def save(self, obj: dict, name: str) -> None:
        self.lines.append((name, dict(obj)))


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
