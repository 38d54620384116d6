"""A recorded run of `molgym_tpu_torch.run` trained in full by two
data-parallel ranks on one card: two gloo processes, both on cuda:0. That
is a mode make_mesh keeps for tests, and no driver flag reaches it
(--num_devices=2 needs a card a rank). The record's flags come from
tools/recorded_run.py, then any flags given after it, which win; rank 0
writes the run's logs, results and models as the driver does.

    python3 -m tests.torch_full_run_w2 \\
        experiments/sf6_bf16/logs/sf6bf16_run-1.json --seed=1 \\
        --log_dir=out/logs --results_dir=out/results \\
        --model_dir=/tmp/models --data_dir=/tmp/data

`--device=cpu` runs both ranks on the CPU instead. The module imports
torch and the port only, so that a rank starts without JAX; pytest does
not collect it (tests/test_torch_recorded_run_device.py runs it)."""
import json
import sys
from typing import Optional, Sequence

from molgym_tpu_torch.parallel.mesh import (Launch, free_port, make_mesh,
                                            shard_size, spawn)
from molgym_tpu_torch.tools import recorded_run
from molgym_tpu_torch.tools.arg_parser import (build_default_argparser,
                                               check_supported)
from molgym_tpu_torch.tools.driver import _train, standard_envs

WORLD = 2


def train_rank(config: dict, device: str) -> dict:
    """One rank's part of the run; returns where and how it ran."""
    with make_mesh(WORLD, device, backend='gloo') as mesh:
        _train(config, standard_envs, mesh.device, False, mesh)
        return dict(rank=mesh.rank, world_size=mesh.world_size,
                    backend=mesh.backend, device=str(mesh.device))


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Trains the record argv[0] with the flags after it at W = 2 and
    returns each rank's train_rank dict."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0].startswith('-'):
        raise SystemExit(__doc__)
    module, flags = recorded_run.recorded_argv(argv[0])
    if module != 'molgym_tpu_torch.run':
        raise ValueError(f'{argv[0]} runs through {module}; this helper '
                         'trains records of molgym_tpu_torch.run only')
    config = vars(build_default_argparser().parse_args(flags + argv[1:]))
    check_supported(config)
    shard_size(config['num_envs'], WORLD)
    device = 'cpu' if config['device'] == 'cpu' else 'cuda:0'
    config.update(num_devices=WORLD, device=device)
    ranks = spawn(train_rank, Launch(WORLD, WORLD, 0, 'localhost',
                                     free_port()), (config, device))
    print(json.dumps(ranks))
    return ranks


if __name__ == '__main__':
    main()
