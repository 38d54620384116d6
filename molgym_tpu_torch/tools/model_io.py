"""Checkpoint save/load with the file naming of molgym_tpu/tools/model_io.py:
`{tag}_steps-{n}.model`, the previous one deleted unless `keep`, resume by
the step count in the name. A checkpoint is one `torch.save` file holding the
model's state_dict, the optimizer's state (rl.ppo.Optimizer.state_dict) and
the step count.

Data-parallel runs save per process, as the JAX package's --multihost does:
the replicas hold the same state, so only a writer rank saves a full copy
(rank 0; under --multihost the first rank of each process, into that
process's own --model_dir), and every rank reads the checkpoint it resumes
from."""
from __future__ import annotations

import logging
import os
import re
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
from torch import nn


@dataclass
class ModelPathInfo:
    path: str
    tag: str
    num_steps: int


class ModelIO:
    _steps_string = '_steps-'
    _suffix = '.model'

    def __init__(self, directory: str, tag: str, keep: bool = False) -> None:
        self.directory = os.path.abspath(directory)
        self.tag = tag
        self.keep = keep
        self.old_path: Optional[str] = None

    def _get_model_filename(self, num_steps: int) -> str:
        return f'{self.tag}{self._steps_string}{num_steps}{self._suffix}'

    def _parse_model_path(self, path: str) -> Optional[ModelPathInfo]:
        name = os.path.basename(os.path.normpath(path))
        match = re.fullmatch(
            rf'(?P<tag>.+){self._steps_string}(?P<num_steps>\d+){self._suffix}',
            name)
        if not match:
            return None
        return ModelPathInfo(path=path, tag=match.group('tag'),
                             num_steps=int(match.group('num_steps')))

    def _list_checkpoints(self) -> Sequence[ModelPathInfo]:
        if not os.path.isdir(self.directory):
            return []
        infos = [self._parse_model_path(os.path.join(self.directory, name))
                 for name in os.listdir(self.directory)]
        return [info for info in infos if info and info.tag == self.tag]

    def save(self, model: nn.Module, optimizer=None, num_steps: int = 0) -> str:
        if not self.keep and self.old_path and os.path.exists(self.old_path):
            logging.debug(f'Deleting old model: {self.old_path}')
            os.remove(self.old_path)
        path = os.path.join(self.directory, self._get_model_filename(num_steps))
        logging.debug(f'Saving model: {path}')
        state = {'model': model.state_dict(), 'num_steps': num_steps}
        if optimizer is not None:
            state['optimizer'] = optimizer.state_dict()
        torch.save(state, path)
        self.old_path = path
        return path

    def load(self, path: str, map_location=None) -> Tuple[dict, int]:
        """Returns ({'model': ..., 'optimizer': ...?, 'num_steps': n}, n),
        tensors on `map_location` (where they were saved by default)."""
        info = self._parse_model_path(path)
        if info is None or not os.path.exists(path):
            raise RuntimeError(f"Cannot find model '{path}'")
        logging.info(f'Loading model: {info.path}')
        state = torch.load(path, map_location=map_location, weights_only=True)
        return state, info.num_steps

    def load_latest(self, map_location=None) -> Tuple[dict, int]:
        infos = self._list_checkpoints()
        if not infos:
            raise RuntimeError(f"Cannot find model to load in '{self.directory}'")
        latest = max(infos, key=lambda info: info.num_steps)
        return self.load(latest.path, map_location=map_location)
