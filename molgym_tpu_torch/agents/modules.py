"""Shared NN building blocks (counterpart of molgym_tpu/agents/modules.py):
an orthogonally initialised MLP with zero biases, relu gates between layers
and a linear output."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class MLP(nn.Module):

    def __init__(self, input_dim: int, output_dims: Sequence[int]):
        super().__init__()
        dims = [input_dim] + list(output_dims)
        self.layers = nn.ModuleList(
            nn.Linear(d_in, d_out) for d_in, d_out in zip(dims[:-1], dims[1:]))
        for layer in self.layers:
            nn.init.orthogonal_(layer.weight)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x
