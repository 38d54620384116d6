"""CLI flags of the port (counterpart of molgym_tpu/tools/arg_parser.py):
the same names and defaults, so that a command of the JAX package means the
same thing here. `--device` picks `cuda` (the default) or `cpu`.

Choices the port does not run are still accepted by the parser, so that
such a command is recognized, and then refused by `check_supported` with the
reason; none is ever ignored or replaced by another."""
from __future__ import annotations

import argparse


def build_default_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Command line tool of molgym-tpu (PyTorch port)')

    # Name and seed
    parser.add_argument('--name', help='experiment name', required=True)
    parser.add_argument('--seed', help='run ID', type=int, default=0)

    # Directories
    parser.add_argument('--log_dir', help='directory for log files', type=str,
                        default='logs')
    parser.add_argument('--model_dir', help='directory for model files',
                        type=str, default='models')
    parser.add_argument('--data_dir', help='directory for saved rollouts',
                        type=str, default='data')
    parser.add_argument('--results_dir', help='directory for results',
                        type=str, default='results')

    # Device
    parser.add_argument('--device', help='select device', type=str,
                        choices=['cuda', 'cpu'], default='cuda')
    parser.add_argument('--num_devices',
                        help='data-parallel ranks over all processes, one '
                             'card each (with --device=cpu: gloo processes '
                             'on the CPU); 0 or 1: one process',
                        type=int, default=0)

    # Spaces
    parser.add_argument('--canvas_size',
                        help='maximum number of atoms on the canvas',
                        type=int, default=25)
    parser.add_argument('--symbols',
                        help='chemical symbols on canvas and in bag '
                             '(comma separated, X first)',
                        type=str, default='X,H,C,N,O,F')

    # Environment
    parser.add_argument('--formulas',
                        help='list of formulas for the environment '
                             '(comma separated)', type=str, required=True)
    parser.add_argument('--eval_formulas',
                        help='formulas used for evaluation (comma separated)',
                        type=str, required=False)
    parser.add_argument('--bag_scale', help='maximum bag size', type=int,
                        required=True)
    parser.add_argument('--min_atomic_distance',
                        help='minimum allowed atomic distance (Angstrom)',
                        type=float, default=0.6)
    parser.add_argument('--max_solo_distance',
                        help='maximum distance hydrogen/halogens can be from '
                             'the nearest heavy atom', type=float, default=2.0)
    parser.add_argument('--min_reward', help='minimum reward', type=float,
                        default=-0.6)

    # Reward backend
    parser.add_argument('--reward',
                        help='reward backend: pm6 (native NDDO SCF on the '
                             'host), sparrow (PM6 via scine when installed), '
                             'eht (native extended Hückel), lj/morse (native '
                             'pair potentials on the host), '
                             'device_lj/device_morse (on the device)',
                        type=str, default='sparrow',
                        choices=['sparrow', 'pm6', 'eht', 'lj', 'morse',
                                 'device_lj', 'device_morse'])
    parser.add_argument('--host_reward_mode',
                        help='host reward transport: loop overlaps the '
                             'host reward with the next policy forward '
                             '(pipelined); callback and loop_serial call '
                             'the host inside the env step, strictly in '
                             'order; auto times both on the first warm '
                             'iterations and keeps the faster',
                        type=str, default='auto',
                        choices=['auto', 'callback', 'loop', 'loop_serial'])
    parser.add_argument('--num_reward_threads',
                        help='host reward evaluator threads', type=int,
                        default=8)

    # Model
    parser.add_argument('--model', help='model representation', type=str,
                        default='internal',
                        choices=['internal', 'covariant', 'mlp'])
    parser.add_argument('--min_mean_distance', help='minimum mean distance',
                        type=float, default=0.8)
    parser.add_argument('--max_mean_distance', help='maximum mean distance',
                        type=float, default=1.8)
    parser.add_argument('--network_width', help='width of FC layers', type=int,
                        default=128)
    parser.add_argument('--maxl', help='max L in spherical expansion',
                        type=int, default=4)
    parser.add_argument('--num_cg_levels', help='number of CG layers',
                        type=int, default=3)
    parser.add_argument('--num_channels_hidden',
                        help='hidden channels in CG layers', type=int, default=10)
    parser.add_argument('--num_channels_per_element',
                        help='channels per element', type=int, default=4)
    parser.add_argument('--num_gaussians', help='number of GMM components',
                        type=int, default=3)
    parser.add_argument('--beta', help='beta of the spherical distribution',
                        required=False, default=None)
    parser.add_argument('--num_interactions',
                        help='SchNet interaction blocks (internal model)',
                        type=int, default=3)
    parser.add_argument('--encoder_dtype',
                        help='compute dtype of the covariant CG stack '
                        '(bfloat16: the bf16 versions of the encoder\'s '
                        'kernels; parameters and heads stay float32)',
                        type=str, choices=['float32', 'bfloat16'],
                        default='float32')

    parser.add_argument('--load_latest', help='load latest checkpoint',
                        action='store_true', default=False)
    parser.add_argument('--load_model', help='load checkpoint file',
                        type=str, default=None)
    parser.add_argument('--save_freq', help='save model every <n> iterations',
                        type=int, default=10)
    parser.add_argument('--eval_freq', help='evaluate every <n> iterations',
                        type=int, default=10)
    parser.add_argument('--num_eval_episodes',
                        help='episodes per evaluation '
                             '(default: one per eval formula)',
                        type=int, default=None)
    parser.add_argument('--eval_sample_k',
                        help='0 (default): greedy evaluation. K>0: sampled '
                             'evaluation with K episodes per formula; adds '
                             'return_best_mean to the eval stream',
                        type=int, default=0)

    # Training algorithm
    parser.add_argument('--optimizer', help='optimizer', type=str,
                        default='adam', choices=['adam', 'amsgrad'])
    parser.add_argument('--discount', help='discount factor', type=float,
                        default=1.0)
    parser.add_argument('--num_steps', dest='max_num_steps',
                        help='maximum number of steps', type=int, default=50000)
    parser.add_argument('--num_steps_per_iter',
                        help='env steps per iteration', type=int, default=128)
    parser.add_argument('--mini_batch_size', help='mini batch size', type=int,
                        default=64)
    parser.add_argument('--num_envs', help='number of environment copies',
                        type=int, default=8)
    parser.add_argument('--clip_ratio', help='PPO clip ratio', type=float,
                        default=0.2)
    parser.add_argument('--learning_rate', help='Adam learning rate',
                        type=float, default=3e-4)
    parser.add_argument('--vf_coef', help='value loss coefficient', type=float,
                        default=0.5)
    parser.add_argument('--entropy_coef', help='entropy loss coefficient',
                        type=float, default=0.01)
    parser.add_argument('--max_num_train_iters',
                        help='max optimization epochs per iteration', type=int,
                        default=7)
    parser.add_argument('--gradient_clip', help='max gradient norm',
                        type=float, default=0.5)
    parser.add_argument('--lam', help='GAE lambda', type=float, default=0.97)
    parser.add_argument('--target_kl', help='KL early-stop target', type=float,
                        default=0.01)

    # Logging
    parser.add_argument('--log_level', help='log level', type=str,
                        default='INFO')
    parser.add_argument('--keep_models', help='keep all checkpoints',
                        action='store_true', default=False)
    parser.add_argument('--save_rollouts', help='which rollouts to save',
                        type=str, default='none',
                        choices=['none', 'train', 'eval', 'all'])
    parser.add_argument('--tensorboard', help='also write TensorBoard scalars '
                        '(to {log_dir}/tb)', action='store_true', default=False)
    parser.add_argument('--profile', help='torch.profiler trace of the second '
                        'training iteration (to {log_dir}/profile)',
                        action='store_true', default=False)
    parser.add_argument('--agg_backend',
                        help='backend of the covariant edge aggregation: '
                             'auto = the CUDA kernel on the card, the plain '
                             'version on the CPU (the only one ported)',
                        type=str, default='auto',
                        choices=['auto', 'einsum', 'pallas'])
    parser.add_argument('--multihost',
                        help='data parallelism over several processes: '
                             'MOLGYM_COORDINATOR_ADDRESS, '
                             'MOLGYM_NUM_PROCESSES and MOLGYM_PROCESS_ID '
                             'place this one (else torchrun\'s variables)',
                        action='store_true', default=False)

    return parser


def check_supported(config: dict) -> None:
    """Raises NotImplementedError for every option value the port does not
    run (the bf16 encoder with an internal model; an agg_backend other than
    auto), with the reason."""
    refused = []
    if (config.get('model') in ('internal', 'mlp')
            and config.get('encoder_dtype', 'float32') != 'float32'):
        refused.append(f"encoder_dtype '{config['encoder_dtype']}' with model "
                       f"'{config['model']}' (the bf16 path is the covariant "
                       'encoder\'s; the JAX package ignores the flag there)')
    if config.get('agg_backend', 'auto') != 'auto':
        refused.append(f"agg_backend '{config['agg_backend']}' (the port has "
                       'one aggregate: the CUDA kernel on the card)')
    if refused:
        raise NotImplementedError('not yet ported: ' + '; '.join(refused))
