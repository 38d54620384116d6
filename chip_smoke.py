"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:
  1. the card's name and power limit (nvidia-smi);
  2. build the port's CUDA kernels from molgym_tpu_torch/csrc, all nvcc
     processes at once;
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes of both main paths, forward and backward (each backward also
     against a second run of itself: the same bits), and time the kernel,
     the plain version and one library call computing the same function (a
     yardstick the port never calls):
       - fused CG aggregate at SF6 levels 0 and 1-2, B = 140, 70 and 9, and
         the tri-fold CG square at tau = 10 and 12, B = 140 and 70 (70: a
         data-parallel rank's half of the minibatch, phase 13; timed,
         forward and backward, beside 140); both again at the
         stochastic configuration's M = 16, N = 10, and the square at the
         QM9 agent's tau = 24 (6 elements x 4 channels; its aggregates and
         products have SF6's shapes) (library: torch.einsum on
         complex tensors, and its torch.autograd.grad). Both forwards are
         also timed at the rollout's batch (10) and an evaluation's (1),
         their resources (channels or rows per block, shared bytes, blocks
         per SM) are logged, and the aggregate's level-0 backward at N = 10
         must not be slower than its library call;
       - the channel-wise CG product of the policy's mixer, (1,25,25) and
         (25,25,375) at 560 rows, 40 rows and 4 rows, the stochastic
         configuration's M = 16, and a row count no tile divides (library:
         one complex einsum against the dense table); its backward must give
         the same bits on a second run, and its resources (rows per tile,
         chunks, threads, shared bytes, blocks per SM) at 560, 40 and 4
         rows are logged;
       - the fused masked categorical head of the focus and element heads
         (masked softmax, index, log-prob and entropy in one kernel, and one
         backward) at [140,7], [140,3], [140,10], [140,4], the internal
         agent's kappa head's [140,2] and [10,2], [8192,128] and [33,200],
         the internal agent's focus on a canvas of 12 at [140,12],
         [10,12], [128,12] and [8,12] and its element head [128,4] and
         [8,4] (the solvation and scaffold runs), and the QM9 agent's
         element head [140,6] and [10,6],
         every 7th row fully masked, in each of its four modes
         (probs only, given, greedy, sample): probs, logp and ent within
         1e-6 absolute and relative, indices equal but where the best two
         Gumbel scores (greedy: probabilities) are within 1e-5 (counted and
         logged), the backward within 1e-5 of max |ref| for six sets of
         incoming gradients, the same bits twice, and through autograd
         (library: torch.softmax of the masked_fill-ed logits);
       - the bf16 versions of the aggregate, the square and their
         backwards at the SF6 and stochastic shapes, B = 140 (the forwards
         also at 10 and 1), each within one bf16 ulp of its plain version
         on the same bf16 operands (library: the complex64 einsum on the
         upcast operands, torch having no bf16 complex type);
     Bounds count operands and outputs at their size (2 bytes in bf16),
     the operations at the f32 rate the kernels compute at, and a
     contraction's table as the function needs it (8 bytes a nonzero, the
     group offsets, the square's pairs), the same for f32 and bf16;
  4. the main path: a 140-env x 14-step rollout of the SF6 covariant agent
     (bench.py's configuration, random weights from a seed) with the
     Lennard-Jones reward, through make_rollout_fn; the kernels' launch
     counts are zeroed just before it and read just after;
  5. the rollout's outputs: finite rewards, log-probs and values, every
     episode ended within SF6's 7 atoms, and the agent on the card agrees
     with the same agent on the CPU (plain versions) on the rollout's data;
  6. bench.py's loss on a minibatch of 140 at SF6 width, and the same loss
     at the stochastic-bag configuration's width: every parameter's
     gradient on the card within 1e-3 of that leaf's max |g| on the CPU,
     none missing; the median ms of one fwd+bwd, and its launches and the
     device's idle share under torch.profiler;
  7. the training path: 3 PPO iterations of the canonical SF6 run
     (README.md's command with the device LJ reward) through
     molgym_tpu_torch.run into a temporary directory, with the launch
     counts zeroed just before and read just after: finite losses, a step in
     every update, changed weights, a checkpoint that loads back equal, and
     launch counts equal to what the iterations imply;
  8. the second configuration, the stochastic-bag run at its recorded width
     (experiments/stochastic/logs/stoch_run-1.json: X,H,C,O; canvas 10;
     maxl 3; 2 CG levels; bags of 4-8 atoms sampled around C2H6O): a 140-env
     x 14-step rollout with finite outputs, every bag of 4-8 atoms with even
     total valence, more than one distinct bag, exact launch counts and the
     agent on the card against itself on the CPU; then 2 PPO iterations
     through molgym_tpu_torch.run_stochastic with the checks of phase 7;
  9. the third path, SF6 with the bf16 encoder (--encoder_dtype=bfloat16,
     experiments/sf6_bf16): bench.py's loss with every gradient on the card
     within 0.03 of that leaf's max |g| on the CPU, none missing, its
     median ms, device ms and launches per fwd+bwd; the bf16 agent against
     the f32 agent on the card (values within 0.15, the same greedy focus
     and element wherever the f32 agent's choice is not a tie); 2 PPO
     iterations through molgym_tpu_torch.run with the checks of phase 7,
     the encoder's launches all on the bf16 counters and none on the f32
     ones;
 10. the fourth path, SF6 with the PM6 reward on the host
     (experiments/sf6_pm6/logs/sf6pm6_run-1.json): the native library
     built by g++ on this host from the port's own sources
     (molgym_tpu_torch/csrc/host/*.cpp) into molgym_tpu_torch/_build (its
     seconds, name (the source hash), compiler and the host's cores
     logged; nothing of the repository's csrc/ is read); a 10-env x 14-step rollout of the SF6 agent at
     full width through the pipelined and the in-step transports from one
     generator state (the in-step one is also the serial host loop, and
     meets the energy cache the pipelined one filled), every field of the
     two trajectories and the generator's final state the same bits, each
     placed atom's reward computed again by a fresh calculator equal to
     the trajectory's in float32, and exact launch counts with the
     pipelined transport's recomputed forwards; the same comparison with
     the host LJ at epsilon 40, where the pipelined transport's low-reward
     fix-up must fire; then 2 PPO iterations of the recorded run through
     molgym_tpu_torch.run with --host_reward_mode=loop and the checks of
     phase 7, recomputes included in the launch counts, and reward_time
     and transport in every train record;
 10b. the same with the EHT reward (molgym_tpu_torch/csrc/host/eht.cpp;
     the reward of experiments/sf6_eht and experiments/h2o_eht): the SF6
     agent's 10-env x 14-step rollout through both transports with phase
     10's checks (the same bits, the rewards recomputed, exact launch
     counts), then 2 PPO iterations of experiments/sf6_eht/README.md's
     command through molgym_tpu_torch.run with the checks of phase 7 under
     --host_reward_mode=auto, whose first two probes are the pipelined
     and the in-step transport (each iteration's transport, its
     evaluation's (pipelined until the selector has chosen) and its
     recomputed forwards checked; so for every run below under auto); the
     host reward's share of the rollouts and the host's cores logged;
 10c. that build, on this host, against the reference's golden PM6
     values (tests/test_nddo.py's): the H (doublet), C and O atoms within
     1e-8 Ha, H2 at 1.2 A and the H2O fixture within 5e-8 Ha, the H2O
     gradients within 5e-7 Ha/bohr; against the port's numpy oracle
     (molgym_tpu_torch/calculators/nddo_ref.py) within 2e-9 Ha on the H2O
     fixture, on SF6 at 1.561 A (the d shell of S) and on the six seeded
     random molecules of tests/test_nddo.py::test_random_molecules, each
     trial's outcome printed (equal, a basin flip held to functional
     parity, an outcome flip, neither converged) and judged as that test
     judges it (at most one outcome flip and one basin flip, at least four
     converged in both); and EHT's external anchors
     (tests/test_eht.py::TestEHTExternalAnchors: H2's Wolfsberg-Helmholz
     relation within 1e-6, CH4's t2 degeneracy within 1e-6 eV and its
     Koopmans IPs, N2's gap); every reading beside its gate;
 10d. the measured transport (rl/rollout.py's AutoTransportRollout):
     the recorded PM6 run (experiments/sf6_pm6/logs/sf6pm6_run-1.json)
     under its --host_reward_mode=auto for 5 iterations, an evaluation
     after each, through molgym_tpu_torch.run with the checks of phase 7
     (exact launch counts, each iteration's recomputed forwards in them):
     the training transports pipelined, in_step, pipelined, in_step and
     then the choice, the choice the faster of the two timed probes in the
     run's log, the evaluations pipelined before the choice and the choice
     after it;
 11. the fifth path, the internal (SchNet) agent at SF6 full width
     (experiments/sf6_internal/logs/sf6int_run-1.json: X,S,F; canvas 7;
     width 128; 3 interactions; 64 atom features): a 140-env x 14-step
     rollout with the device LJ reward through make_rollout_fn with phase
     5's checks and exact launch counts (3 fused heads an `act`: focus,
     element, kappa; no other kernel), the host ms of one `act` and one
     profiled rollout (launches a step, idle share); bench.py's loss on a
     minibatch of 140 with every gradient on the card within 1e-3 of that
     leaf's max |g| on the CPU, none missing, its median ms, device ms,
     launches and idle share, and one counted pass of 3 head forwards and 3
     head backwards, kappa's without an entropy gradient; 2 PPO iterations
     of the recorded run through molgym_tpu_torch.run with the checks of
     phase 7; then 2 iterations of the mlp model at its recorded width
     (experiments/host_loop/logs/hostloop_run-1.json: O2, canvas 3, width
     32, the host LJ reward, --host_reward_mode=auto's first two probes)
     the same way;
 12. the sixth to eighth paths, each from its recorded configuration at
     full width, through its driver: the solvation run
     (experiments/solvation/logs/solv_run-1.json: the internal agent,
     width 64, X,H,C,O, canvas 12, CO pre-placed from solute.xyz, H2O
     refilled twice, device LJ less 0.01 |x|), the scaffold run with PM6
     (experiments/scaffold_pm6/logs/scafpm6_run-1.json: the internal
     agent, width 128, X,H,O,Ar, the 8 Ar of cube.xyz pre-placed, 8 envs x
     32 steps, minibatch 128, here with --host_reward_mode=loop) and the
     QM9 run with PM6 (experiments/qm9_pm6/logs/qm9pm6_run-1.json: the
     covariant agent at full width over X,H,C,N,O,F, canvas 7, its bag set
     drawn from qm9_sample.tar.gz, --host_reward_mode=auto's first two
     probes): for each, a rollout at the run's envs
     and steps through the driver's env builder with exact launch counts,
     finite outputs, the agent card vs CPU, the host ms of one `act` and
     one profiled rollout (launches a step, idle share), every atom the
     scaffold rollout placed inside the cube's hull; the gradients of the
     QM9 agent, as the driver builds it, card vs CPU; 2 PPO iterations of
     each through molgym_tpu_torch.run_solvation, run_scaffold and run_qm9
     with the checks of phase 7 (every rollout of the solvation and scaffold runs
     saved: some solvation episode refilled its bag; every scaffold canvas
     keeps its Ar and every atom placed beside them satisfies A x + b <=
     1e-5, with a logged gap when the greedy evaluations placed no atom;
     the QM9 run drew the recorded CNH,COH2,CFH3,CO2H2); then the
     covariant agent's covariance on the card
     (molgym_tpu_torch/equivariance.py, the check of
     tests/test_torch_covariance.py::test_agent_is_covariant_on_the_card):
     the JAX test's agent on H2O, CH3 and CH4 and the SF6 agent at full
     width on partial SF6 canvases, two random rotations each, the
     coefficients of the rotated canvas within 1e-5 of apply_wigner of the
     unrotated ones, and their invariants within 1e-5;
 13. data parallelism (molgym_tpu_torch/parallel/mesh.py) on the canonical
     SF6 run at full width, random weights from SEED, cut to 2 iterations,
     each case in ranks spawned for it: (a) one rank over NCCL on cuda:0,
     batch_ppo(mesh=make_mesh(1, 'cuda')) against plain batch_ppo from the
     same weights and seed in that process: the same bits in every
     parameter and every train, opt and eval record but the times, and
     exact launch counts; (b) two ranks on this one card over gloo:
     finite records and a step
     in every update on both ranks, the parameters the same bits on both
     after each iteration, each rank's exact launch counts (rank 0, the
     writer, also evaluates), and rank 0's first reduced gradient of
     iteration 1 within 1e-5 of each leaf's max |g| of one process's
     make_train_fn from the same gathered trajectory, parameters,
     optimizer and generator state, with the same number of steps; and,
     the run not depending on W, (b)'s first gathered training rollout and
     its parameters after the 2 iterations against (a)'s plain run from
     the same seed and weights, at tests/test_torch_parallel_draws.py's
     gates (DP_RUN_TOL; the largest differences logged); then
     (a) and (b) each time 2 more iterations alike, with no evaluation and
     no writes on any rank: each rank's iteration ms and the env-steps/s
     of both together beside (a)'s; (d) molgym_tpu_torch.run --multihost
     as one process of one NCCL rank (MOLGYM_* variables), the driver's
     spawn, writer and checkpoint path, against the same run in one
     process from the same weights: phase 7's checks on each (the rank's
     launch counts read from the rank), _rank-0 on the rank's rollouts,
     and the two checkpoints the same bits; (c) with two cards, 2
     iterations of molgym_tpu_torch.run --num_devices=2 over NCCL with
     finite records, a step in every update and a checkpoint of the right
     step count and optimizer count; with one card, a line saying it did
     not run; (e) the bf16 encoder (--encoder_dtype=bfloat16): one
     iteration at two ranks on this card over gloo against the same in
     one process, the same number of steps, the differences of the first
     rollout and the parameters logged, not gated;
 14. the JAX package's trained checkpoints (fourteen: the run-1 checkpoints
     of thirteen experiments, stochastic, sf6_bf16, sf6_pm6, sf6_internal,
     sf6_internal_pm6, solvation, scaffold_pm6, qm9_pm6, organics,
     halides_pm6, organics_pm6, solvation_pm6 and stochastic_pm6, and
     stochastic_pm6's run-2), each loaded through ModelIO.load from its
     experiments/ orbax path (the committed archive of
     molgym_tpu_torch/checkpoints, its sha256 held against the directory's
     files, a round-1 layout migrated): (a) its env, reward and agent built
     from the recorded configuration at recorded width by the driver's
     builders, 8 envs playing one greedy episode per formula on the card
     with exact launch counts, the mean return within its test's gate of
     the CPU port's value (TRAINED: 1e-4 for the internal agents, whose
     greedy act draws nothing; a covariant agent's draw spread otherwise)
     and of the run's last recorded eval, one gradient pass of log-prob,
     entropy and value over the trajectory with exact launch counts and
     finite gradients, and, with PM6, a sampled training rollout of the
     recorded envs and steps through each transport, timed with the host
     reward's share; over the fourteen, every f32 kernel's counters moved
     (#1-#7, forward and backward), the encoder's bf16 ones for sf6_bf16
     (and none of its f32 ones), only the fused head's for the internal
     agents; (b) the resume of sf6pm6_run-1 (its archive keeps the
     optimizer state) through molgym_tpu_torch.run --load_model at the
     recorded flags with --num_steps=15400 and --host_reward_mode=loop: the
     checks of phase 7 (finite losses, exact launch counts, a checkpoint at
     15,400 that loads back equal) and the optimizer's count continued from
     the archive's; (c) molgym_tpu_torch.tools.diagnose_greedy of
     stochpm6_run-2 (8 greedy envs, 16 sampled): every greedy episode ends
     at its third action, an O refused within 0.1 A of another atom, as on
     the CPU and in the reference's probe, the greedy mean within its gate
     of the CPU port's, and some sampled episode places every atom; (d) the
     nine covariant checkpoints of (a) (all but the internal agents'),
     evaluated by (a)'s protocol with the greedy distance taken from shared
     candidates (molgym_tpu_torch/tools/shared_draws.py) instead of the
     best of 128 draws, so that the evaluation is a deterministic function
     of the weights: every env's focus and element at every step equal to
     the CPU port's and the mean within 1e-4 of it (SHARED, measured by
     tests/test_torch_shared_draws.py and _pm6.py, which hold the CPU port
     against the JAX package at float tolerance; sf6_bf16 within those
     tests' bf16 tolerance of 0.02), with exact launch counts;
 15. the port's bench (molgym_tpu_torch/bench.py, the counterpart of the
     JAX system's bench.py) in this process at small --iters and --reps
     (BENCH_SMOKE): its gradient gates (each configuration's gradients on
     the card against the CPU's at B = 140 within MODEL_TOL, the bf16
     encoder's within BF16_MODEL_TOL, every gradient finite at 2240; the
     two host transports the same trajectory with PM6 and with EHT) before
     its timings, then every name of its record with a number (the
     headline, ms_headline_rerun, the three mfu estimates, ms_batch_2240,
     ms_bf16, ms_bf16_2240, ms_internal_agent and the PM6 and EHT
     env-steps/s of both transports) finite and positive, the transport
     --host_reward_mode=auto keeps for PM6 and for EHT
     (auto_transport_pm6, _eht) one of the port's two, bench.py's names
     without a counterpart listed, and the card's name in the record; the
     record logged;
 16. the port's fwd+bwd profiler (molgym_tpu_torch/profile_minibatch.py,
     the counterpart of the JAX system's experiments/perf/
     profile_minibatch.py) in this process: --trace at B = 140 (f32) and
     the whole sweep (B = 140, 560, 2240), its lines logged: the trace's
     launches a step equal to bench.profile_grad's launches of one call of
     the same program (exact), its device ms a step within PROFILE_BUSY_TOL
     of profile_grad's busy ms, each of the port's eight f32 kernels of
     the fwd+bwd in its kernel list with launches a step equal to that
     kernel's launch count over one call, and the sweep's rows finite,
     B = 2240 the slowest, the ms per 140 rows falling with B (B = 140 and
     560 take the same time within the host clock's spread), every MFU at
     most 100%;
 17. the four recorded runs with a device reward that the port trains in
     full (PERF.md section 5): experiments/sf6_bf16's, organics', solvation's
     and scaffold's commands as molgym_tpu_torch/tools/recorded_run.py
     resolves them (scaffold's from its table UNLOGGED, README.md's
     command), at full width, cut to 2 iterations by --num_steps, each
     through its driver's main with the checks of phase 7 (records, a
     model at the last step that loads back equal, exact launch counts);
     the counters that moved exactly RECORDED_KERNELS': the encoder's bf16
     ones for sf6_bf16, the f32 ones for organics, the fused head's alone
     for the two internal agents (solvation, scaffold);
 18. the solvation and scaffold runs' sampled heads and rollouts, each at
     its recorded configuration (molgym_tpu_torch/tools/head_draws.py, the
     card's side of tests/test_torch_solvation_training.py and
     test_torch_scaffold_training.py): one rollout at random weights from
     a seed on the card, with exact launch counts (3 fused heads an act),
     replayed by the CPU port's env and agent from the same states with the
     element and position each card step was given: the observations,
     every discrete field of every state (elements, bags, atom counts,
     refill counts, formula cursors), the terminals and the refused
     placements equal, positions and rewards within 1e-5, logp, v and the
     bootstrap value within MODEL_TOL; then, at the trained weights of the
     committed JAX archives (solv_run-1, and scafpm6_run-1 for the scaffold,
     the kappa head's output layer scaled), 4,096 sampled actions at each
     of the family's observations of that rollout (the solute alone,
     mid-bag, after a refill; the cube alone, partway through the bag) on
     the card, 512 rows an act (the fused head's sample mode on the card's
     uniforms, the continuous heads on its normals), with exact launch
     counts, and as many on the CPU: each set held to the distributions the
     CPU port gives at its actions (focus and element by chi-square, each
     continuous sub-action by KS and its scale, kappa given the continuous
     ones; molgym_tpu_torch/tools/sampling_checks.py) and the two sets to
     each other by the same statistics' two-sample forms, every p-value at
     or above 1e-3;
 19. the solvation run at the TPU's default matmul precision
     (molgym_tpu_torch/tools/tpu_precision.py: every product of the
     internal agent on bf16-rounded operands, f32 accumulation): a rollout
     at full width and random weights from a seed on the card, then
     `evaluate` at its 140 rows and 32 samples' loss gradients (one sample
     a loss) under the emulation on the card and on the CPU, at least
     PRECISION_BULK of the samples of logp, ent, v and the gradients within
     PRECISION_BULK_TOL of their scale (a quantity's RMS, a gradient's
     norm), and the card outside the emulation at most PRECISION_NONE
     within it (logp, v, gradients); then 2 iterations of the record's
     command through the tool, its tag marked `_tpudefault`, with the
     checks of phase 7 (records, a model that loads back equal, exact
     launch counts of the fused head, the only counters moved) and rounded
     products and focus rows counted in the run.

The line before the last two is {"kernels": [...]}, then the card's name and
power limit, and the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from molgym_tpu_torch import bench
from molgym_tpu_torch.bench import BF16_MODEL_TOL, MODEL_TOL
from molgym_tpu_torch.equivariance import (COVARIANCE_AGENT,
                                           COVARIANCE_FORMULA, SF6_AGENT,
                                           SF6_FORMULA)
from molgym_tpu_torch.timing import time_ms

SEED = 0
NUM_ENVS = 140
NUM_STEPS = 14
KERNEL_TOL = 1e-4   # f32, another summation order: relative to max |ref|
# MODEL_TOL (logp / v of the whole agent, and each gradient of its leaf's
# max |g|, card vs CPU) and BF16_MODEL_TOL (the bf16 encoder's gradients)
# are the bench's gates (molgym_tpu_torch/bench.py)
BF16 = torch.bfloat16
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
STOCH_AGENT = dict(zs=(0, 1, 6, 8), canvas_size=10, network_width=128, maxl=3,
                   num_cg_levels=2, num_channels_hidden=10,
                   num_channels_per_element=4, num_gaussians=3, bag_scale=6,
                   min_max_distance=(0.9, 1.8), beta=-10.0)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def max_err(outs, refs):
    abs_err = max(float((o.float() - r.float()).abs().max())
                  for o, r in zip(outs, refs))
    scale = max(float(r.float().abs().max()) for r in refs)
    return abs_err, abs_err / max(scale, 1e-30)


def check_close(what, outs, refs):
    """A kernel's outputs against its plain version's on the same operands:
    f32 within KERNEL_TOL of max |ref|; bf16 (both round their f32 sums
    once, so another summation order moves a rounding by one ulp at most)
    within one bf16 ulp everywhere, |k - p| <= 2^-7 |p| + 1e-5 max |p|.
    Returns the errors; raises if they are too large."""
    abs_err, rel_err = max_err(outs, refs)
    res = dict(max_abs_err=abs_err, max_rel_err=rel_err)
    if outs[0].dtype == torch.float32:
        if not rel_err <= KERNEL_TOL:
            raise AssertionError(f'{what}: rel err {rel_err}')
        return res
    scale = max(float(r.float().abs().max()) for r in refs)
    share = max(float(((o.float() - r.float()).abs() /
                       (2.0 ** -7 * r.float().abs() + 1e-5 * scale)).max())
                for o, r in zip(outs, refs))
    if not (outs[0].dtype == BF16 and share <= 1.0):
        raise AssertionError(f'{what}: {share} of one bf16 ulp')
    return dict(res, max_ulp_share=share)


def table_bytes(nnz, *index_arrays):
    """A contraction's table as the function needs it: 8 bytes a nonzero
    (its index and f32 coefficient) and the index arrays named (the group
    offsets; the square's (m, n) of each pair it reads), not the padding of
    the kernels' warp-padded entries. The same for f32 and bf16 operands."""
    return 8 * nnz + nbytes(*index_arrays)


def _tag(dtype):
    return ' bf16' if dtype == BF16 else ''


def bound_ms(n_bytes, n_flops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def check_aggregate(dev, B, atom_n_ells, maxl=4, N=7, tau=10,
                    dtype=torch.float32):
    from molgym_tpu_torch.ops import cg, fused_agg
    n_ells = maxl + 1
    m1, m2 = n_ells ** 2, atom_n_ells ** 2
    gen = torch.Generator(device=dev).manual_seed(SEED + B + atom_n_ells + N)
    sph = torch.randn((B, N, N, m1, 2), generator=gen, device=dev).to(dtype)
    rad = torch.randn((B, N, N, tau, n_ells), generator=gen,
                      device=dev).to(dtype)
    q_r = torch.randn((B, N, tau, m2), generator=gen, device=dev).to(dtype)
    q_i = torch.randn((B, N, tau, m2), generator=gen, device=dev).to(dtype)
    table3, _sl = cg._fused_cg_table(n_ells, atom_n_ells, maxl)
    g = cg.fused_cg_table_grouped(n_ells, atom_n_ells, maxl)
    grouped = None if g is None else (g[0], g[1])
    args = (sph, rad, q_r, q_i, table3)

    out = fused_agg.cg_aggregate_edge_fused_ri(*args, grouped=grouped)
    torch.cuda.synchronize()
    ref = fused_agg.cg_aggregate_edge_fused_ri_plain(*args, grouped=grouped)
    what = f'aggregate B={B} M2={m2}{_tag(dtype)}'
    res = dict(shape=f'B={B} N={N} tau={tau} M1={m1} M2={m2} K={out[0].shape[-1]}'
               f' {"grouped" if grouped else "dense"}{_tag(dtype)}',
               **check_close(what, out, ref))
    # timed at the update's minibatch (140) and a data-parallel rank's half
    # of it (70)
    if B not in (140, 70):
        return res
    res['ms'] = time_ms(lambda: fused_agg.cg_aggregate_edge_fused_ri(
        *args, grouped=grouped))
    if B == 140:
        # the same kernel at the rollout's batch (--num_envs=10) and at an
        # evaluation's (one env): most of a run's launches
        for small in (10, 1):
            few = tuple(x[:small].contiguous() for x in args[:4]) + (table3, )
            got = fused_agg.cg_aggregate_edge_fused_ri(*few, grouped=grouped)
            check_close(f'{what} at B={small}', got, [r[:small] for r in ref])
            res[f'ms_b{small}'] = time_ms(
                lambda: fused_agg.cg_aggregate_edge_fused_ri(*few,
                                                             grouped=grouped))
    res['resources'] = fused_agg.aggregate_kernel_resources(
        B, N, tau, n_ells, m2, table3, grouped, dev)
    res['plain_ms'] = time_ms(lambda: fused_agg.cg_aggregate_edge_fused_ri_plain(
        *args, grouped=grouped))
    # library yardstick: the contraction as ONE complex64 einsum against the
    # dense table (edge rep built outside the timed call, K left unpermuted;
    # torch has no bf16 complex type, so bf16 operands are upcast)
    e = (rad.float()[..., fused_agg._l_of_m(n_ells, dev)][..., None] *
         sph.float()[:, :, :, None, :, :])
    e_c = torch.complex(e[..., 0], e[..., 1]).contiguous()
    q_c = torch.complex(q_r.float(), q_i.float())
    c_c = torch.from_numpy(table3).to(dev).to(torch.complex64)
    res['library_ms'] = time_ms(
        lambda: torch.einsum('bijtm,bjtn,mnk->bitk', e_c, q_c, c_c))
    tabs = fused_agg._kernel_tables('aggregate', table3, grouped, None, dev)
    nnz = tabs['nnz']
    # operands and outputs at their size (2 bytes in bf16), f32 operations
    res['bound_ms'], res['bound_by'] = bound_ms(
        nbytes(sph, rad, q_r, q_i, *out) + table_bytes(nnz, tabs['fwd_ptr']),
        bench.aggregate_ops(B, N, tau, m1, m2, tabs))
    return res


def check_square(dev, tau, maxl=4, N=7, dtype=torch.float32, B=140):
    from molgym_tpu_torch.ops import cg, fused_agg
    n_ells = maxl + 1
    m = n_ells ** 2
    gen = torch.Generator(device=dev).manual_seed(SEED + tau + N)
    a_r = torch.randn((B, N, tau, m), generator=gen, device=dev).to(dtype)
    a_i = torch.randn((B, N, tau, m), generator=gen, device=dev).to(dtype)
    table3, _sl = cg._fused_cg_table(n_ells, n_ells, maxl)
    pairs, groups, perm, _si = cg.fused_cg_table_tri(n_ells, maxl)
    tri = (pairs, groups)
    out = fused_agg.cg_square_fused_ri(a_r, a_i, table3, tri=tri)
    torch.cuda.synchronize()
    ref = fused_agg.cg_square_fused_ri_plain(a_r, a_i, table3, tri=tri)
    what = f'square tau={tau} M={m}{_tag(dtype)}'
    res = dict(shape=f'B={B} N={N} tau={tau} M={m} P={len(pairs)} '
               f'K={out[0].shape[-1]} tri{_tag(dtype)}',
               **check_close(what, out, ref))
    res['ms'] = time_ms(lambda: fused_agg.cg_square_fused_ri(a_r, a_i, table3,
                                                              tri=tri))
    # the same kernel at the rollout's batch (--num_envs=10) and at an
    # evaluation's (one env): most of a run's launches
    for small in ((10, 1) if B == 140 else ()):
        few = (a_r[:small].contiguous(), a_i[:small].contiguous())
        got = fused_agg.cg_square_fused_ri(*few, table3, tri=tri)
        check_close(f'{what} at B={small}', got, [r[:small] for r in ref])
        res[f'ms_b{small}'] = time_ms(
            lambda: fused_agg.cg_square_fused_ri(*few, table3, tri=tri))
    res['resources'] = {
        f'B={b}': fused_agg.square_kernel_resources(b * N * tau, table3, None,
                                                    tri, dev)
        for b in ((140, 10, 1) if B == 140 else (B, ))}
    res['plain_ms'] = time_ms(lambda: fused_agg.cg_square_fused_ri_plain(
        a_r, a_i, table3, tri=tri))
    a_c = torch.complex(a_r.float(), a_i.float())     # complex64, upcast
    c_c = torch.from_numpy(table3).to(dev).to(torch.complex64)
    res['library_ms'] = time_ms(
        lambda: torch.einsum('...m,...n,mnk->...k', a_c, a_c, c_c))
    tabs = fused_agg._kernel_tables('square', table3, None, tri, dev)
    res['bound_ms'], res['bound_by'] = bound_ms(
        nbytes(a_r, a_i, *out) + table_bytes(tabs['nnz'], tabs['fwd_ptr'],
                                             tabs['slot_mn']),
        bench.square_ops(B * N * tau, tabs))
    return res


def _library_grad_ms(fn, leaves, grads):
    """Device ms of torch.autograd.grad of `fn(*leaves)` (the library
    yardstick's backward), the forward run once outside the timed call.
    Autograd runs each backward op on its forward op's stream, so the
    forward runs on the stream the backward is captured on."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = fn(*leaves)
        grads = grads.clone()
    return time_ms(lambda: torch.autograd.grad(out, leaves, grads,
                                               retain_graph=True),
                   stream=side)


def check_same_bits(what, got, again):
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f'{what}: a second run gave other bits')


def check_aggregate_bwd(dev, B, atom_n_ells, maxl=4, N=7, tau=10,
                        dtype=torch.float32):
    """The aggregate's backward kernel against its plain backward, and
    against a second run of itself."""
    from molgym_tpu_torch.ops import cg, fused_agg
    n_ells = maxl + 1
    m1, m2 = n_ells ** 2, atom_n_ells ** 2
    gen = torch.Generator(device=dev).manual_seed(SEED + 7 * B + atom_n_ells
                                                  + N)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    sph, rad = randn(B, N, N, m1, 2), randn(B, N, N, tau, n_ells)
    q_r, q_i = randn(B, N, tau, m2), randn(B, N, tau, m2)
    table3, _sl = cg._fused_cg_table(n_ells, atom_n_ells, maxl)
    g = cg.fused_cg_table_grouped(n_ells, atom_n_ells, maxl)
    grouped = None if g is None else (g[0], g[1])
    tabs = fused_agg._kernel_tables('aggregate', table3, grouped, None, dev)
    k = tabs['k']
    g_r, g_i = randn(B, N, tau, k), randn(B, N, tau, k)
    args = (sph, rad, q_r, q_i, g_r, g_i, table3, grouped)

    out = fused_agg._aggregate_bwd_kernel(*args)
    again = fused_agg._aggregate_bwd_kernel(*args)
    torch.cuda.synchronize()
    ref = fused_agg.cg_aggregate_edge_fused_ri_bwd_plain(*args)
    what = f'aggregate bwd B={B} M2={m2}{_tag(dtype)}'
    res = dict(shape=f'B={B} N={N} tau={tau} M1={m1} M2={m2} K={k}'
               f' {"grouped" if grouped else "dense"}{_tag(dtype)}',
               **check_close(what, out, ref))
    check_same_bits(what, out, again)
    res['same_bits'] = True
    if B not in (140, 70):
        return res
    res['ms'] = time_ms(lambda: fused_agg._aggregate_bwd_kernel(*args))
    res['plain_ms'] = time_ms(
        lambda: fused_agg.cg_aggregate_edge_fused_ri_bwd_plain(*args))
    # library yardstick: autograd of the forward's complex64 einsum (bf16
    # operands upcast)
    e = (rad.float()[..., fused_agg._l_of_m(n_ells, dev)][..., None] *
         sph.float()[:, :, :, None, :, :])
    e_c = torch.complex(e[..., 0], e[..., 1]).contiguous().requires_grad_()
    q_c = torch.complex(q_r.float(), q_i.float()).requires_grad_()
    c_c = torch.from_numpy(table3).to(dev).to(torch.complex64)
    def library():
        return _library_grad_ms(
            lambda a, b: torch.einsum('bijtm,bjtn,mnk->bitk', a, b, c_c),
            (e_c, q_c), torch.complex(g_r.float(), g_i.float()))
    res['library_ms'] = library()
    if m2 == 1 and N == 10 and dtype == torch.float32:
        # the one shape at which the first version of this kernel lost to
        # its library call: three readings of each, in turns
        mine, theirs = [res['ms']], [res['library_ms']]
        for _ in range(2):
            mine.append(time_ms(lambda: fused_agg._aggregate_bwd_kernel(*args)))
            theirs.append(library())
        spread = max(max(mine) - min(mine), max(theirs) - min(theirs))
        res['ms_readings'], res['library_ms_readings'] = mine, theirs
        if min(mine) > min(theirs) + spread:
            raise AssertionError(
                f'FINDING: aggregate bwd, dense level-0 table, N=10: the '
                f'kernel ({mine} ms) is slower than its library call '
                f'({theirs} ms) by more than the spread of three readings')
    nnz = tabs['nnz']
    res['bound_ms'], res['bound_by'] = bound_ms(
        nbytes(sph, rad, q_r, q_i, g_r, g_i, *out) +
        table_bytes(nnz, tabs['bwd_ptr']),
        bench.aggregate_ops(B, N, tau, m1, m2, tabs, backward=True))
    return res


def check_square_bwd(dev, tau, maxl=4, N=7, dtype=torch.float32, B=140):
    """The square's backward kernel against its plain backward (tri pairs,
    the main path's table mode), and against a second run of itself."""
    from molgym_tpu_torch.ops import cg, fused_agg
    n_ells = maxl + 1
    m = n_ells ** 2
    gen = torch.Generator(device=dev).manual_seed(SEED + 3 * tau + N)
    table3, _sl = cg._fused_cg_table(n_ells, n_ells, maxl)
    pairs, groups, _perm, _si = cg.fused_cg_table_tri(n_ells, maxl)
    tri = (pairs, groups)
    tabs = fused_agg._kernel_tables('square', table3, None, tri, dev)
    k = tabs['k']
    a_r, a_i = (torch.randn((B, N, tau, m), generator=gen, device=dev).to(dtype)
                for _ in range(2))
    g_r, g_i = (torch.randn((B, N, tau, k), generator=gen, device=dev).to(dtype)
                for _ in range(2))
    args = (a_r, a_i, g_r, g_i, table3, None, tri)
    out = fused_agg._square_bwd_kernel(*args)
    again = fused_agg._square_bwd_kernel(*args)
    torch.cuda.synchronize()
    ref = fused_agg.cg_square_fused_ri_bwd_plain(*args)
    what = f'square bwd tau={tau} M={m}{_tag(dtype)}'
    res = dict(shape=f'B={B} N={N} tau={tau} M={m} P={len(pairs)} K={k} '
               f'tri{_tag(dtype)}', **check_close(what, out, ref))
    check_same_bits(what, out, again)
    res['same_bits'] = True
    res['ms'] = time_ms(lambda: fused_agg._square_bwd_kernel(*args))
    res['plain_ms'] = time_ms(lambda: fused_agg.cg_square_fused_ri_bwd_plain(
        *args))
    a_c = torch.complex(a_r.float(), a_i.float()).requires_grad_()
    c_c = torch.from_numpy(table3).to(dev).to(torch.complex64)
    res['library_ms'] = _library_grad_ms(
        lambda a: torch.einsum('...m,...n,mnk->...k', a, a, c_c), (a_c, ),
        torch.complex(g_r.float(), g_i.float()))
    res['bound_ms'], res['bound_by'] = bound_ms(
        nbytes(a_r, a_i, g_r, g_i, *out) +
        table_bytes(tabs['nnz'], tabs['bwd_ptr'], tabs['slot_mn']),
        bench.square_ops(B * N * tau, tabs, backward=True))
    return res


def check_contract(dev, lead, n1, n2, maxl):
    """The channel-wise CG product's forward and backward kernels against
    their plain versions at rows = prod(lead), the backward also against a
    second run of itself (the same bits); (forward, backward) results."""
    from molgym_tpu_torch.ops import cg, fused_cg
    m1, m2 = n1 * n1, n2 * n2
    rows = int(np.prod(lead))
    gen = torch.Generator(device=dev).manual_seed(SEED + rows + m1 + m2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    table3, _sl = cg._fused_cg_table(n1, n2, maxl)
    k = table3.shape[2]
    ops = (randn(*lead, m1), randn(*lead, m1), randn(*lead, m2),
           randn(*lead, m2))
    g_r, g_i = randn(*lead, k), randn(*lead, k)
    tabs = fused_cg.kernel_tables(table3, dev)
    nnz = tabs['nnz']                                # without the padding
    # the table as the function needs it: an 8-byte (pair, coefficient)
    # word for each nonzero and the offsets of its groups; not the padding
    # of the kernels' warp-padded entries nor the backward's line tables
    fwd_table = 8 * nnz + nbytes(tabs['fwd_ptr'])
    bwd_table = 8 * nnz + nbytes(tabs['bwd_ptr'])
    shape = f'rows={rows} M1={m1} M2={m2} K={k} nnz={nnz}'

    out = fused_cg.cg_contract_ri(*ops, table3)
    torch.cuda.synchronize()
    ref = fused_cg.cg_contract_ri_plain(*ops, table3)
    abs_err, rel_err = max_err(out, ref)
    if not rel_err <= KERNEL_TOL:
        raise AssertionError(f'contract {shape}: rel err {rel_err}')
    fwd = dict(shape=shape, max_abs_err=abs_err, max_rel_err=rel_err)
    fwd['ms'] = time_ms(lambda: fused_cg.cg_contract_ri(*ops, table3))
    fwd['plain_ms'] = time_ms(
        lambda: fused_cg.cg_contract_ri_plain(*ops, table3))
    # library yardstick: ONE complex einsum against the dense table
    a_c = torch.complex(ops[0], ops[1]).reshape(rows, m1)
    b_c = torch.complex(ops[2], ops[3]).reshape(rows, m2)
    c_c = torch.from_numpy(table3).to(dev).to(torch.complex64)
    fwd['library_ms'] = time_ms(
        lambda: torch.einsum('rm,rn,mnk->rk', a_c, b_c, c_c))
    fwd['bound_ms'], fwd['bound_by'] = bound_ms(
        nbytes(*ops, *out) + fwd_table, bench.product_ops(rows, tabs))

    got = fused_cg._bwd_kernel(*ops, g_r, g_i, table3)
    again = fused_cg._bwd_kernel(*ops, g_r, g_i, table3)
    torch.cuda.synchronize()
    ref = fused_cg.cg_contract_ri_bwd_plain(*ops, g_r, g_i, table3)
    abs_err, rel_err = max_err(got, ref)
    if not rel_err <= KERNEL_TOL:
        raise AssertionError(f'contract bwd {shape}: rel err {rel_err}')
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f'contract bwd {shape}: a second run gave '
                             'other bits')
    bwd = dict(shape=shape, max_abs_err=abs_err, max_rel_err=rel_err,
               same_bits=True)
    bwd['ms'] = time_ms(lambda: fused_cg._bwd_kernel(*ops, g_r, g_i, table3))
    bwd['plain_ms'] = time_ms(
        lambda: fused_cg.cg_contract_ri_bwd_plain(*ops, g_r, g_i, table3))
    bwd['library_ms'] = _library_grad_ms(
        lambda a, b: torch.einsum('rm,rn,mnk->rk', a, b, c_c),
        (a_c.requires_grad_(), b_c.requires_grad_()),
        torch.complex(g_r, g_i).reshape(rows, k))
    bwd['bound_ms'], bwd['bound_by'] = bound_ms(
        nbytes(*ops, g_r, g_i, *got) + bwd_table,
        bench.product_ops(rows, tabs, backward=True))
    if rows == 560:
        fwd['resources'] = {
            f'rows={n}': fused_cg.product_kernel_resources(n, table3, dev)
            for n in (560, 40, 4)}
    return fwd, bwd


HEAD_TOL = 1e-6       # probs, logp, ent: f32, another summation order
HEAD_BWD_TOL = 1e-5   # dlogits, relative to max |ref|
# Gumbel scores (greedy: probabilities) this close may order either way:
# logf and torch.log, and two sums of a row, may differ by an ulp
HEAD_TIE = 1e-5
HEAD_MODES = ('probs', 'given', 'greedy', 'sample')


def check_head(dev, rows, n):
    """The fused masked categorical head's forward kernel in each of its
    four modes and its backward kernel against their plain versions on the
    card, every 7th row fully masked; (forward, backward) results. The
    row's ms: the forward in sample mode (the rollout's), the backward with
    the gradients of logp and ent (the training's); the plain ms: the plain
    head chain and the plain backward formula on the card."""
    from molgym_tpu_torch.ops import fused_softmax as fs
    gen = torch.Generator(device=dev).manual_seed(SEED + rows + n)
    logits = 3.0 * torch.randn((rows, n), generator=gen, device=dev)
    mask = torch.rand((rows, n), generator=gen, device=dev) > 0.4
    mask[::7] = False
    u = torch.rand((rows, n), generator=gen, device=dev)
    given = torch.randint(0, n, (rows, ), generator=gen, device=dev)
    g_probs = torch.randn((rows, n), generator=gen, device=dev)
    g_logp = torch.randn(rows, generator=gen, device=dev)
    g_ent = torch.randn(rows, generator=gen, device=dev)
    shape = f'rows={rows} N={n}'
    kwargs = dict(probs={}, given=dict(index=given), greedy=dict(greedy=True),
                  sample=dict(u=u))

    fwd = dict(shape=shape, max_abs_err=0.0, ties={}, ms_modes={},
               plain_ms_modes={}, bound_ms_modes={})
    for mode in HEAD_MODES:
        kw = kwargs[mode]
        got = fs.masked_categorical(logits, mask, **kw)
        torch.cuda.synchronize()
        ref = fs.masked_categorical_plain(logits, mask, **kw)
        for what, g, r in zip(('probs', 'logp', 'ent'), got[::2] + got[3:],
                              ref[::2] + ref[3:]):
            if r is None:
                continue
            err = (g - r).abs()
            if (not torch.isfinite(g).all()
                    or (err > HEAD_TOL + HEAD_TOL * r.abs()).any()):
                raise AssertionError(f'head {shape} {mode}: {what} off by '
                                     f'{float(err.max())}')
            fwd['max_abs_err'] = max(fwd['max_abs_err'], float(err.max()))
        if got[0][~mask].any() or got[0][::7].any():
            raise AssertionError(f'head {shape} {mode}: a masked entry is '
                                 'not zero')
        if mode == 'given' and not torch.equal(got[1], given):
            raise AssertionError(f'head {shape}: the given index changed')
        if mode in ('greedy', 'sample'):
            scores = ref[0] if mode == 'greedy' else (
                torch.log(ref[0].clamp(min=1e-10)) +
                torch.where(ref[0] > 0, 0.0, -1e9) + fs.gumbel_from_uniform(u))
            top2 = scores.topk(2, dim=-1).values
            tie = top2[:, 0] - top2[:, 1] <= HEAD_TIE
            differ = got[1] != ref[1]
            if (differ & ~tie).any():
                raise AssertionError(f'head {shape} {mode}: '
                                     f'{int((differ & ~tie).sum())} indices '
                                     'differ from the plain version\'s')
            fwd['ties'][mode] = int((differ & tie).sum())
        fwd['ms_modes'][mode] = time_ms(
            lambda kw=kw: fs.masked_categorical(logits, mask, **kw))
        fwd['plain_ms_modes'][mode] = time_ms(
            lambda kw=kw: fs.masked_categorical_plain(logits, mask, **kw))
        # bytes: logits, mask, u or the given index, probs and 16 a row
        # (index, logp, ent) unless probs only; operations: ~20 an entry
        # sampling, ~10 else
        ins = [t for t in (logits, mask, kw.get('u'), kw.get('index'))
               if t is not None]
        fwd['bound_ms_modes'][mode] = bound_ms(
            nbytes(*ins, *(t for t in got if t is not None)),
            rows * n * (20 if mode == 'sample' else 10))[0]
    if any(fwd['ties'].values()):
        log(f'head {shape}: index ties taken the other way', fwd['ties'])
    fwd['ms'] = fwd['ms_modes']['sample']
    fwd['plain_ms'] = fwd['plain_ms_modes']['sample']
    # library yardstick: torch.softmax of the masked_fill-ed logits
    fwd['library_ms'] = time_ms(
        lambda: torch.softmax(logits.masked_fill(~mask, -1e9), dim=-1))
    fwd['bound_ms'], fwd['bound_by'] = bound_ms(
        nbytes(logits, mask, u) + nbytes(*fs.masked_categorical(
            logits, mask, u=u)), rows * n * 20)

    probs, index, _logp, _ent = fs.masked_categorical(logits, mask, u=u)
    bwd = dict(shape=shape, max_abs_err=0.0, max_rel_err=0.0)
    variants = dict(logp_ent=(None, g_logp, g_ent),
                    all=(g_probs, g_logp, g_ent), probs=(g_probs, None, None),
                    logp=(None, g_logp, None), ent=(None, None, g_ent),
                    broadcast=(None, g_logp[:1].expand(rows),
                               g_ent[:1].expand(rows)))
    for name, grads in variants.items():
        got = fs._bwd_kernel(probs, index, *grads)
        again = fs._bwd_kernel(probs, index, *grads)
        torch.cuda.synchronize()
        ref = fs.masked_categorical_bwd_plain(probs, index, *grads)
        abs_err, rel_err = max_err([got], [ref])
        if (not rel_err <= HEAD_BWD_TOL or got[~mask].any()
                or not torch.isfinite(got).all()):
            raise AssertionError(f'head bwd {shape} {name}: rel err '
                                 f'{rel_err}, or a masked entry not zero')
        check_same_bits(f'head bwd {shape} {name}', [got], [again])
        bwd['max_abs_err'] = max(bwd['max_abs_err'], abs_err)
        bwd['max_rel_err'] = max(bwd['max_rel_err'], rel_err)
    # autograd through the head's Function reaches the backward kernel
    x = logits.clone().requires_grad_()
    _p, i, lp, en = fs.masked_categorical(x, mask, index=index)
    (got, ) = torch.autograd.grad((lp, en), x, (g_logp, g_ent))
    ref = fs.masked_categorical_bwd_plain(probs, index, None, g_logp, g_ent)
    if not max_err([got], [ref])[1] <= HEAD_BWD_TOL:
        raise AssertionError(f'head bwd {shape}: autograd off the plain '
                             'formula')
    bwd['ms'] = time_ms(lambda: fs._bwd_kernel(probs, index, None, g_logp,
                                               g_ent))
    bwd['plain_ms'] = time_ms(lambda: fs.masked_categorical_bwd_plain(
        probs, index, None, g_logp, g_ent))
    bwd['library_ms'] = _library_grad_ms(
        lambda x: torch.softmax(x.masked_fill(~mask, -1e9), dim=-1),
        (logits.clone().requires_grad_(), ), g_probs)
    # bytes: probs, index, g_logp, g_ent, dlogits; ~10 operations an entry
    bwd['bound_ms'], bwd['bound_by'] = bound_ms(
        nbytes(probs, index, g_logp, g_ent, got), rows * n * 10)
    return fwd, bwd


def _bench_obs(agent_kwargs, device):
    """The bench's minibatch of 140 (bench.make_batch, seed SEED) at the
    canvas and elements of `agent_kwargs`, on `device`."""
    return bench.observation(bench.make_batch(
        SEED, 140, agent_kwargs['canvas_size'], len(agent_kwargs['zs'])),
        device)


def check_agent_grads(dev, agent_kwargs, encoder_dtype=None, build=None):
    """bench.py's loss on a minibatch of 140 at the width of `agent_kwargs`:
    every gradient on the card (through the kernels) against the same
    agent's on the CPU (plain versions), within MODEL_TOL of the leaf's max
    |g| (BF16_MODEL_TOL with the bf16 encoder), then the time of one
    fwd+bwd and, under torch.profiler, its launches and the device's idle
    share. `build(device)` makes the agent (default: the covariant agent of
    `agent_kwargs`). One more fwd+bwd counts its kernels' launches and
    records which gradients each head's backward received."""
    from molgym_tpu_torch.agents.covariant import CovariantAC
    from molgym_tpu_torch.ops import fused_agg, fused_softmax

    tol = MODEL_TOL if encoder_dtype is None else BF16_MODEL_TOL
    if build is None:
        def build(device):
            return CovariantAC(**agent_kwargs, encoder_dtype=encoder_dtype,
                               device=device)
    torch.manual_seed(SEED)
    agents = {'cuda': build(dev)}
    agents['cpu'] = build('cpu')
    agents['cpu'].load_state_dict(agents['cuda'].state_dict())
    obs = {name: _bench_obs(agent_kwargs, d)
           for name, d in (('cuda', dev), ('cpu', 'cpu'))}
    with torch.no_grad():
        actions = agents['cuda'].act(
            obs['cuda'], torch.Generator(device=dev).manual_seed(SEED)
        ).action_flat
    acts = {'cuda': actions, 'cpu': actions.cpu()}

    def fwd_bwd(name):
        agent = agents[name]
        loss = bench.bench_loss(*agent.evaluate(obs[name], acts[name]))
        agent.zero_grad(set_to_none=True)
        loss.backward()
        return {k: p.grad for k, p in agent.named_parameters()}

    grads = {name: fwd_bwd(name) for name in ('cuda', 'cpu')}
    worst = bench.check_grads('the card', grads['cuda'], grads['cpu'], tol)

    # one counted pass; each head's backward: its rows, its N and the
    # gradients it received (probs, logp, ent)
    head_bwd, bwd_kernel = [], fused_softmax._bwd_kernel

    def recorded(probs, index, g_probs, g_logp, g_ent):
        head_bwd.append([list(probs.shape)] + [
            g is not None for g in (g_probs, g_logp, g_ent)])
        return bwd_kernel(probs, index, g_probs, g_logp, g_ent)
    torch.cuda.synchronize()
    fused_agg.reset_launch_counts()
    fused_softmax._bwd_kernel = recorded
    try:
        fwd_bwd('cuda')
    finally:
        fused_softmax._bwd_kernel = bwd_kernel
    torch.cuda.synchronize()
    counts = {k: v for k, v in fused_agg.launch_counts.items() if v}

    for _ in range(3):
        fwd_bwd('cuda')
    times = bench.sample_ms(lambda: fwd_bwd('cuda'), 20)
    prof = bench.profile_grad(lambda: fwd_bwd('cuda'))
    device_ms = prof['device_busy_ms']
    median = float(np.median(times))

    # the other part of a gradient pass's epoch: one optimizer step
    from molgym_tpu_torch.rl.ppo import PPOConfig, make_optimizer
    optimizer = make_optimizer(PPOConfig(), agents['cuda'])
    step_times = []
    for i in range(13):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimizer.step(grads['cuda'])
        torch.cuda.synchronize()
        if i >= 3:
            step_times.append((time.perf_counter() - t0) * 1e3)
    return dict(num_params=len(grads['cpu']), max_grad_err_share=worst,
                fwd_bwd_ms_median=median,
                fwd_bwd_ms_min=min(times), fwd_bwd_ms_max=max(times),
                profiled_wall_ms=prof['wall_ms'], device_busy_ms=device_ms,
                device_idle_share_profiled=prof['device_idle_share'],
                device_idle_share_vs_median=1.0 - device_ms / median,
                launches_per_fwd_bwd=prof['launches_per_fwd_bwd'],
                kernel_counts_per_fwd_bwd=counts, head_backwards=head_bwd,
                optimizer_step_ms_median=float(np.median(step_times)))


def compare_bf16_to_f32(dev, agent_kwargs):
    """The same parameters in an agent with the bf16 encoder and in one
    with the f32 encoder, both on the card, on bench.py's minibatch of 140:
    greedy values within 0.15 (and 0.15 relative), and the same greedy
    focus and element wherever the f32 agent's choice is decided, its top
    two probabilities further apart than twice the largest difference of
    any probability between the two agents (exact ties among the random
    canvases' equivalent atoms go either way); the JAX package's gates for
    this comparison (tests/covariant/test_covariant_agent.py)."""
    from molgym_tpu_torch.agents.covariant import CovariantAC

    torch.manual_seed(SEED)
    f32 = CovariantAC(**agent_kwargs, device=dev)
    bf16 = CovariantAC(**agent_kwargs, encoder_dtype='bfloat16', device=dev)
    bf16.load_state_dict(f32.state_dict())
    obs = _bench_obs(agent_kwargs, dev)
    with torch.no_grad():
        out32, d32 = f32.act_with_dists(
            obs, torch.Generator(device=dev).manual_seed(SEED), True)
        out16, d16 = bf16.act_with_dists(
            obs, torch.Generator(device=dev).manual_seed(SEED), True)
    if out16.v.dtype != torch.float32:
        raise AssertionError(f'bf16 agent: values of {out16.v.dtype}')
    dv = (out16.v - out32.v).abs()
    if not (dv <= 0.15 + 0.15 * out32.v.abs()).all():
        raise AssertionError(f'bf16 vs f32 agent: |d v| up to {float(dv.max())}')
    res = dict(max_abs_dv=float(dv.max()))
    for col, key in ((0, 'focus_probs'), (1, 'element_probs')):
        p32, p16 = d32[key], d16[key]
        top2 = p32.topk(2, dim=-1).values
        decided = top2[:, 0] - top2[:, 1] > 2 * float((p16 - p32).abs().max())
        differ = out16.action_flat[:, col] != out32.action_flat[:, col]
        if (differ & decided).any():
            raise AssertionError(f'bf16 vs f32 agent: {key} differs on '
                                 f'{int((differ & decided).sum())} decided rows')
        res[key] = dict(max_abs_dp=float((p16 - p32).abs().max()),
                        decided=int(decided.sum()), differ_at_ties=int(differ.sum()))
    return res


CANONICAL = ['--name=sf6', '--formulas=SF6', '--canvas_size=7',
             '--symbols=X,S,F', '--bag_scale=5', '--model=covariant',
             '--beta=-10', '--min_mean_distance=1.10',
             '--max_mean_distance=2.10', '--num_envs=10',
             '--num_steps_per_iter=140', '--mini_batch_size=140',
             '--reward=device_lj', '--num_steps=420', '--log_level=WARNING']
# the canonical run with the bf16 encoder (experiments/sf6_bf16), cut to 2
# iterations
CANONICAL_BF16 = [a for a in CANONICAL if not a.startswith('--num_steps=')] + [
    '--num_steps=280', '--encoder_dtype=bfloat16']
# experiments/stochastic/logs/stoch_run-1.json, cut to 2 iterations
STOCHASTIC = ['--name=stoch', '--formulas=C2H6O', '--size_range=4,9',
              '--canvas_size=10', '--symbols=X,H,C,O', '--bag_scale=6',
              '--model=covariant', '--maxl=3', '--num_cg_levels=2',
              '--beta=-10', '--min_mean_distance=0.9',
              '--max_mean_distance=1.8', '--num_envs=10',
              '--num_steps_per_iter=140', '--mini_batch_size=140',
              '--reward=device_lj', '--num_steps=280', '--seed=1',
              '--log_level=WARNING']


# experiments/sf6_pm6/logs/sf6pm6_run-1.json, cut to 2 iterations, with the
# pipelined host loop
SF6_PM6 = ['--name=sf6pm6', '--formulas=SF6', '--canvas_size=7',
           '--symbols=X,S,F', '--bag_scale=5', '--model=covariant',
           '--beta=-10', '--min_mean_distance=1.1', '--max_mean_distance=2.1',
           '--num_envs=10', '--num_steps_per_iter=140',
           '--mini_batch_size=140', '--reward=pm6', '--num_eval_episodes=1',
           '--save_rollouts=eval', '--seed=1', '--num_steps=280',
           '--host_reward_mode=loop', '--log_level=WARNING']
PM6_ENVS = 10   # the recorded run's --num_envs
# experiments/sf6_eht/README.md's command, cut to 2 iterations: the first
# two probes of --host_reward_mode=auto, pipelined and then in step
SF6_EHT = ['--name=sf6eht', '--formulas=SF6', '--canvas_size=7',
           '--symbols=X,S,F', '--bag_scale=5', '--model=covariant',
           '--beta=-10', '--min_mean_distance=1.10',
           '--max_mean_distance=2.10', '--num_envs=10',
           '--num_steps_per_iter=140', '--mini_batch_size=140',
           '--reward=eht', '--seed=1', '--num_steps=280',
           '--log_level=WARNING']


# phase 10d: experiments/sf6_pm6/logs/sf6pm6_run-1.json under its
# recorded --host_reward_mode=auto, cut to 5 iterations, an evaluation
# after each: the selector probes pipelined, in_step, pipelined, in_step
# and keeps the faster of its two timed probes for the fifth; logged at
# INFO, so that the probes' ms are in the run's log
SF6_PM6_AUTO = [a for a in SF6_PM6 if not a.startswith(
    ('--num_steps=', '--host_reward_mode=', '--log_level='))] + [
        '--num_steps=700', '--host_reward_mode=auto', '--eval_freq=1',
        '--log_level=INFO']
PROBE_ORDER = ['pipelined', 'in_step'] * 2
# an auto run of 2 iterations: the first two probes
PROBES_2 = PROBE_ORDER[:2]


def selector_probes(config, tag):
    """The selector's line in the log of a run under
    --host_reward_mode=auto (curve_summary.selector_probes): its choice and
    the ms of its two timed probes."""
    from molgym_tpu_torch.curve_summary import selector_probes as probes
    found = probes(os.path.join(config['log_dir'], tag + '.log'))
    if found is None or set(found['probe_ms']) != set(PROBE_ORDER):
        raise AssertionError(f'the selector\'s line in the log: {found}')
    return found


def run_selector(dev):
    """Phase 10d: SF6_PM6_AUTO through molgym_tpu_torch.run with the checks
    of phase 7 (exact launch counts, each iteration's transport and
    recomputed forwards in them); the training transports must read
    PROBE_ORDER and then the choice, the choice the faster of the two
    logged probes, and the evaluations pipelined until the choice (after
    the fourth iteration's rollout) and the choice after it."""
    from molgym_tpu_torch import run
    from molgym_tpu_torch.tools.arg_parser import build_default_argparser
    res = run_training(dev, run, build_default_argparser, SF6_PM6_AUTO,
                       iterations=5, transport=None, inspect=selector_probes)
    choice, probes = res['choice'], res['probe_ms']
    if (choice != min(probes, key=probes.get)
            or res['transports'] != PROBE_ORDER + [choice]
            or res['eval_transports'] != ['pipelined'] * 3 + [choice] * 2):
        raise AssertionError(f'phase 10d: choice {choice} of {probes}, '
                             f'transports {res["transports"]}, evaluations '
                             f'{res["eval_transports"]}')
    return res


def per_forward_launches(agent, encoder_dtype='float32'):
    """{(counter, suffix): launches} of one policy forward of `agent`. A
    covariant forward launches one aggregate and one square per CG level
    (their bf16 versions with the bf16 encoder, and then no f32 one) and,
    on the heads, two CG products (the mixer) and two fused categorical
    heads (focus, element, counted as masked_softmax), in f32 either way;
    an internal forward (SchNet or mlp) three fused heads (focus, element,
    kappa) and no CG kernel."""
    from molgym_tpu_torch.agents.internal import InternalAC
    if isinstance(agent, InternalAC):
        return {('masked_softmax', ''): 3}
    encoder = '_bf16' if encoder_dtype == 'bfloat16' else ''
    levels = agent.encoder.num_cg_levels
    return {('cg_aggregate_edge_fused_ri', encoder): levels,
            ('cg_square_fused_ri', encoder): levels,
            ('cg_contract_ri', ''): 2, ('masked_softmax', ''): 2}


def expected_launches(per_forward, forwards, passes):
    """The launch counts, of every counter, of `forwards` policy forwards
    and `passes` gradient passes with `per_forward` (per_forward_launches)
    launches a forward; a gradient pass is one forward and as many
    backward launches."""
    from molgym_tpu_torch.ops.kernel_common import launch_counts
    out = dict.fromkeys(launch_counts, 0)
    for (name, suffix), n in per_forward.items():
        out[name + suffix] = n * (forwards + passes)
        out[name + '_bwd' + suffix] = n * passes
    return out


# a data-parallel rank that a driver spawns (start method spawn) imports
# this module anew, as __mp_main__; during run_training it writes its launch
# counts into the directory this variable names when it exits, and
# run_training adds them to its own process's
RANK_COUNTS_DIR = 'CHIP_SMOKE_RANK_COUNTS_DIR'


def _write_rank_counts():
    from molgym_tpu_torch.ops.kernel_common import launch_counts
    with open(os.path.join(os.environ[RANK_COUNTS_DIR],
                           f'{os.getpid()}.json'), 'w') as f:
        json.dump(launch_counts, f)


if __name__ == '__mp_main__' and os.environ.get(RANK_COUNTS_DIR):
    import atexit
    atexit.register(_write_rank_counts)


def run_training(dev, entry, build_parser, argv, iterations,
                 transport='in_step', inspect=None, env=None,
                 load_model=None):
    """`iterations` PPO iterations of the run `argv` describes through the
    main of the module `entry` (`build_parser` makes its parser, for the
    configuration the checks read), from a checkpoint of random
    weights written first, so that the initial weights are known, or, with
    `load_model`, resumed from that checkpoint (--load_model), whose
    optimizer count the run must continue; the launch
    counts are zeroed just before and read just after, this process's and
    those of the data-parallel ranks the run spawns, added. Every training
    rollout must name `transport` (a list: each iteration's in turn, as
    --host_reward_mode=auto probes pipelined, in_step, pipelined, in_step;
    None: the caller checks the result's `transports`), and a host
    reward's its reward_time; every evaluation the same transport where
    `transport` is one name, and where it is a list pipelined, the
    selector's before it has chosen (the result's `eval_transports`).
    `inspect(config, tag)`, called while the run's directories exist, adds
    its dict to the result. `env` holds environment variables set for the
    run only. On the CPU (a rehearsal) the counts are not checked: only a
    kernel launch counts."""
    import tempfile

    from molgym_tpu_torch.ops import fused_agg
    from molgym_tpu_torch.rl.ppo import eval_rollout_size
    from molgym_tpu_torch.spaces import ObservationSpace, symbols_to_zs
    from molgym_tpu_torch.tools import util
    from molgym_tpu_torch.tools.model_io import ModelIO
    from molgym_tpu_torch.tools.model_util import build_model

    with tempfile.TemporaryDirectory() as tmp:
        argv = argv + [f'--{d}_dir={tmp}/{d}' for d in
                       ('log', 'model', 'data', 'results')] + (
            ['--load_latest'] if load_model is None
            else [f'--load_model={load_model}'])
        config = vars(build_parser().parse_args(argv))
        util.create_directories([config['model_dir']])
        tag = util.get_tag(config)
        space = ObservationSpace(config['canvas_size'],
                                 symbols_to_zs(config['symbols']))
        torch.manual_seed(SEED + 1)
        init = build_model(config, space, device=dev)
        start_count = 0
        if load_model is None:
            ModelIO(config['model_dir'], tag).save(init, num_steps=0)
        else:
            state, _steps = ModelIO(config['model_dir'], tag).load(
                load_model, dev, family=config['model'],
                template=init.state_dict())
            init.load_state_dict(state['model'])
            start_count = state['optimizer']['count']
        before = {k: v.clone() for k, v in init.state_dict().items()}

        rank_counts = os.path.join(tmp, 'rank_counts')
        os.makedirs(rank_counts)
        env = dict(env or {}, **{RANK_COUNTS_DIR: rank_counts})
        saved = {k: os.environ.get(k) for k in env}
        _sync(dev)
        fused_agg.reset_launch_counts()
        t0 = time.perf_counter()
        os.environ.update(env)
        try:
            # stdout carries only the result lines: a driver's prints go to
            # stderr
            with contextlib.redirect_stdout(sys.stderr):
                agent, optimizer = entry.main(argv)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        _sync(dev)
        seconds = time.perf_counter() - t0
        counts = dict(fused_agg.launch_counts)
        for name in sorted(os.listdir(rank_counts)):
            with open(os.path.join(rank_counts, name)) as f:
                for k, n in json.load(f).items():
                    counts[k] += n

        def lines(name):
            path = f'{config["results_dir"]}/{tag}_{name}.txt'
            with open(path) as f:
                return [json.loads(line) for line in f]
        opt, train, evals = lines('opt'), lines('train'), lines('eval')
        if len(opt) != iterations or len(train) != iterations:
            raise AssertionError(f'{len(opt)} updates, {len(train)} rollouts')
        for rec in opt + train + evals:
            bad = [k for k, v in rec.items()
                   if not isinstance(v, str) and not np.isfinite(v)]
            if bad:
                raise AssertionError(f'non-finite {bad} in {rec}')
        host = config['reward'] not in ('device_lj', 'device_morse')
        transports = [r['transport'] for r in train]
        eval_transports = [r['transport'] for r in evals]
        if isinstance(transport, str):
            expected = ([transport] * len(train), [transport] * len(evals))
        elif transport is not None:
            expected = (list(transport), ['pipelined'] * len(evals))
        if transport is not None and expected != (transports,
                                                  eval_transports):
            raise AssertionError(f'transports {transports}, evaluations '
                                 f'{eval_transports}: expected {expected}')
        for rec in train + evals:
            if ('recomputes' in rec) != (rec['transport'] == 'pipelined'):
                raise AssertionError(f'info {rec}: recomputes where the '
                                     'transport was not pipelined')
        for rec in train:
            if host != ('reward_time' in rec):
                raise AssertionError(f'train info {rec}: reward_time with '
                                     'a device reward, or none with a host '
                                     'one')
        if min(r['num_opt_steps'] for r in opt) < 1:
            raise AssertionError(f'an update took no step: {opt}')
        if optimizer.count != start_count + sum(r['num_opt_steps']
                                                for r in opt):
            raise AssertionError(f'optimizer count {optimizer.count} after '
                                 f'{start_count} and the updates {opt}')
        after = agent.state_dict()
        if all(torch.equal(before[k], v) for k, v in after.items()):
            raise AssertionError('training changed no parameter')

        state, steps = ModelIO(config['model_dir'], tag).load_latest(dev)
        if (steps != config['max_num_steps']
                or state['optimizer']['count'] != optimizer.count):
            raise AssertionError(f'checkpoint at {steps} steps, count '
                                 f'{state["optimizer"]["count"]}')
        for k, v in after.items():
            if not torch.equal(state['model'][k], v):
                raise AssertionError(f'checkpoint differs in {k}')
        for key in ('mu', 'nu'):
            for k, v in state['optimizer'][key].items():
                if not torch.equal(v, getattr(optimizer, key)[k]):
                    raise AssertionError(f'checkpoint {key} differs in {k}')
        extra = inspect(config, tag) if inspect is not None else {}
        # the formulas the run trained on (run_qm9 draws them)
        with open(os.path.join(config['log_dir'], tag + '.json')) as f:
            run_config = json.load(f)

    # forwards: a rollout of T steps per env makes T + 1 (the bootstrap), an
    # eval rollout the steps batch_ppo sizes it to (eval_rollout_size; one
    # episode per eval formula unless --num_eval_episodes says) and the
    # bootstrap; every gradient pass (an epoch's minibatch) makes one
    # forward and one backward; a pipelined rollout computes a forward
    # again after a low reward
    samples = config['num_steps_per_iter']
    minibatches = -(-samples // min(config['mini_batch_size'], samples))
    passes = minibatches * sum(r['num_grad_passes'] for r in opt)
    recomputes = sum(r.get('recomputes', 0) for r in train + evals)
    steps_per_env = config['num_steps_per_iter'] // config['num_envs']
    eval_formulas = run_config['eval_formulas'] or run_config['formulas']
    _episodes, eval_steps = eval_rollout_size(
        run_config['num_eval_episodes'] or len(eval_formulas.split(',')),
        run_config['eval_sample_k'] or 0, config['canvas_size'])
    forwards = (len(train) * (steps_per_env + 1)
                + len(evals) * (eval_steps + 1) + recomputes)
    expected = expected_launches(
        per_forward_launches(agent, config['encoder_dtype']), forwards,
        passes)
    if dev.type == 'cuda' and counts != expected:
        raise AssertionError(f'launches {counts}, expected {expected}')
    return dict(seconds=seconds, counts=counts, grad_passes=passes,
                opt_steps=[r['num_opt_steps'] for r in opt],
                rollout_ms=[r['time'] * 1e3 for r in train],
                update_ms=[r['time'] * 1e3 for r in opt],
                iteration_ms=[r['iteration_time'] * 1e3 for r in opt],
                total_loss=[r['total_loss'] for r in opt],
                approx_kl=[r['approx_kl'] for r in opt],
                return_mean=[r['return_mean'] for r in train],
                eval_return_mean=[r['return_mean'] for r in evals],
                recomputes=recomputes, transports=transports,
                eval_transports=eval_transports,
                recomputes_by_iteration=[r.get('recomputes') for r in train],
                reward_time_s=[r.get('reward_time') for r in train],
                start_count=start_count, count=optimizer.count, **extra)


def run_rollout(dev, env, agent, build, max_episode_len):
    """A NUM_ENVS x NUM_STEPS rollout of `agent` in `env` through
    make_rollout_fn, with the launch counts zeroed just before and read just
    after: exact forward-only launch counts, finite outputs, no episode
    longer than `max_episode_len`, and the agent on the card against itself
    on the CPU (plain versions; `build(device)` makes an agent of its
    kind) on the rollout's data."""
    from molgym_tpu_torch.ops import fused_agg
    from molgym_tpu_torch.rl.rollout import make_rollout_fn

    gen = torch.Generator(device=dev).manual_seed(SEED)
    # warm-up: builds the tables and allocator pools outside the timed run
    make_rollout_fn(env, agent, 2)(agent, env.init_states(NUM_ENVS, gen), gen)
    torch.cuda.synchronize()

    rollout = make_rollout_fn(env, agent, NUM_STEPS)
    states = env.init_states(NUM_ENVS, gen)
    torch.cuda.synchronize()
    fused_agg.reset_launch_counts()
    t0 = time.perf_counter()
    states, traj = rollout(agent, states, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(fused_agg.launch_counts)

    # the rollout runs forwards only: no backward kernel may launch
    expected = expected_launches(per_forward_launches(agent), NUM_STEPS + 1, 0)
    if counts != expected:
        raise AssertionError(f'launches {counts}, expected {expected}')
    for name in ('rewards', 'logps', 'values', 'actions', 'bootstrap_value'):
        if not torch.isfinite(getattr(traj, name)).all():
            raise AssertionError(f'non-finite {name}')
    # a step either places an atom of the bag or ends the episode, so every
    # episode ends within the bag's size in steps
    term = traj.terminals.cpu().numpy()
    n_next = (traj.next_obs.elements != 0).sum(-1).cpu().numpy()
    if (n_next > max_episode_len).any():
        raise AssertionError(f'a canvas holds more than {max_episode_len} atoms')
    for b in range(NUM_ENVS):
        ends = np.flatnonzero(term[:, b])
        if (not len(ends) or ends[0] > max_episode_len - 1
                or (np.diff(ends) > max_episode_len).any()):
            raise AssertionError(f'env {b}: episode longer than '
                                 f'{max_episode_len} steps')

    cpu_agent = build('cpu')
    cpu_agent.load_state_dict(agent.state_dict())
    idx = slice(0, 16)
    obs = traj.obs.map(lambda x: x[3, idx])
    actions = traj.actions[3, idx]
    with torch.no_grad():
        g_logp, _g_ent, g_v = agent.evaluate(obs, actions)
        c_logp, _c_ent, c_v = cpu_agent.evaluate(obs.map(lambda x: x.cpu()),
                                                 actions.cpu())
    model_err = max(float((g_logp.cpu() - c_logp).abs().max()),
                    float((g_v.cpu() - c_v).abs().max()))
    if not model_err <= MODEL_TOL:
        raise AssertionError(f'card vs CPU agent: max |d logp|, |d v| = '
                             f'{model_err}')
    return traj, dict(seconds=seconds, counts=counts, model_err=model_err,
                      episodes=int(term.sum()),
                      mean_reward=float(traj.rewards.mean()),
                      ms_per_step=seconds * 1e3 / NUM_STEPS,
                      env_steps_per_s=NUM_ENVS * NUM_STEPS / seconds)


def run_main_path(dev):
    """The SF6 rollout: 7 atoms, so no episode is longer than 7 steps."""
    from molgym_tpu_torch.agents.covariant import CovariantAC
    from molgym_tpu_torch.envs.environment import MolecularEnv
    from molgym_tpu_torch.envs.reward import make_lennard_jones_reward
    from molgym_tpu_torch.formula import string_to_formula
    from molgym_tpu_torch.spaces import ObservationSpace

    torch.manual_seed(SEED)
    space = ObservationSpace(canvas_size=7, zs=list(SF6_AGENT['zs']))
    bag = space.bag_from_formula(string_to_formula('SF6'))
    env = MolecularEnv(make_lennard_jones_reward(), space, bag[None],
                       device=dev)
    agent = CovariantAC(**SF6_AGENT, device=dev)
    _traj, res = run_rollout(dev, env, agent,
                             lambda d: CovariantAC(**SF6_AGENT, device=d),
                             max_episode_len=7)
    return res


def run_stochastic_rollout(dev):
    """The stochastic-bag configuration at its recorded width: the training
    env that run_stochastic.stochastic_envs makes, 140 envs. Every bag an episode starts
    from has 4-8 atoms and an even total valence, and the batch holds more
    than one distinct bag."""
    from molgym_tpu_torch import run_stochastic
    from molgym_tpu_torch.agents.covariant import CovariantAC
    from molgym_tpu_torch.envs.reward import make_lennard_jones_reward
    from molgym_tpu_torch.periodic import Z_TO_BOND_COUNT
    from molgym_tpu_torch.spaces import ObservationSpace

    config = vars(run_stochastic.build_parser().parse_args(STOCHASTIC))
    space = ObservationSpace(canvas_size=STOCH_AGENT['canvas_size'],
                             zs=list(STOCH_AGENT['zs']))
    env, _eval_env = run_stochastic.stochastic_envs(
        config, space, make_lennard_jones_reward(), dev)
    torch.manual_seed(SEED + 2)
    agent = CovariantAC(**STOCH_AGENT, device=dev)
    traj, res = run_rollout(dev, env, agent,
                            lambda d: CovariantAC(**STOCH_AGENT, device=d),
                            max_episode_len=8)

    # the bag an episode starts from: step 0, and the step after a terminal
    term = traj.terminals
    fresh = torch.cat([torch.ones_like(term[:1]), term[:-1]])
    bags = traj.obs.bag[fresh].cpu().numpy()
    sizes = bags.sum(-1)
    valence = bags @ np.array([Z_TO_BOND_COUNT.get(z, 0)
                               for z in STOCH_AGENT['zs']])
    distinct = len({tuple(b) for b in bags})
    if sizes.min() < 4 or sizes.max() > 8 or (valence % 2).any():
        raise AssertionError(f'bag sizes {sizes.min()}-{sizes.max()}, '
                             f'{int((valence % 2).sum())} of odd valence')
    if bags[:, 0].any() or distinct < 2:
        raise AssertionError(f'{distinct} distinct bags, or a bag holds X')
    first = traj.obs.bag[0].cpu().numpy()
    return dict(res, bags_sampled=len(bags), distinct_bags=distinct,
                distinct_bags_at_step_0=len({tuple(b) for b in first}),
                bag_size_min=int(sizes.min()), bag_size_max=int(sizes.max()),
                bag_size_mean=float(sizes.mean()))


def build_host_library():
    """The native library from the port's sources (molgym_tpu_torch/csrc/
    host/) into molgym_tpu_torch/_build, timed, with the compiler and the
    host's cores (the library's pool takes one thread a core)."""
    from molgym_tpu_torch import host_build
    t0 = time.perf_counter()
    path = host_build.build()
    seconds = time.perf_counter() - t0
    compiler = subprocess.run([host_build._compiler(), '--version'],
                              capture_output=True, text=True).stdout
    return dict(seconds=seconds, library=os.path.relpath(path),
                sources=os.path.relpath(host_build.CSRC),
                compiler=compiler.splitlines()[0],
                nproc=len(os.sched_getaffinity(0)), cpu_count=os.cpu_count())


# phase 10c: the reference's golden PM6 values (tests/test_nddo.py, from
# the reference's tests/test_sparrow.py and tests/resources/h2o.xyz,
# energy.dat, gradients.dat): (symbol, spin multiplicity, Hartree)
GOLDEN_ATOMS = (('H', 2, -0.4133180865), ('C', 1, -4.162353543),
                ('O', 1, -10.37062419))
GOLDEN_ATOM_TOL = 1e-8
GOLDEN_H2 = -0.9379853016   # H2 at 1.2 A, singlet
GOLDEN_H2O_POS = np.array([[-0.27939703, 0.83823215, 0.00973345],
                           [-0.52040310, 1.77677325, 0.21391146],
                           [0.54473632, 0.90669722, -0.53501306]])
GOLDEN_H2O = -11.72459668
GOLDEN_H2O_GRADIENTS = np.array(
    [[-8.700857e-03, -1.502556e-02, 5.081632e-03],
     [-4.048210e-03, 1.437334e-02, 3.364464e-03],
     [1.274907e-02, 6.522202e-04, -8.446095e-03]])
GOLDEN_TOL = 5e-8            # H2 and H2O, Hartree
GOLDEN_GRADIENT_TOL = 5e-7   # H2O, Hartree/bohr
ORACLE_TOL = 2e-9            # C++ against the numpy oracle, Hartree
SF6_BOND = 1.561             # Angstrom, the experimental S-F bond


def _pm6_calc(symbols, positions, multiplicity=0):
    from molgym_tpu_torch.calculators.native import NativeCalc
    calc = NativeCalc(method='PM6')
    calc.set_elements(symbols)
    calc.set_positions(np.asarray(positions, np.float64))
    calc.set_settings({'molecular_charge': 0,
                       'spin_multiplicity': multiplicity})
    return calc


def _gate(readings, what, value, gate, error):
    readings.append(dict(what=what, value=value, error=error, gate=gate))
    if not error <= gate:
        raise AssertionError(f'{what}: {value!r}, error {error!r} over '
                             f'{gate!r}')


def random_molecules_against_oracle():
    """tests/test_nddo.py::TestOracleParity::test_random_molecules on this
    host's build: six seeded clusters of H, C, N, O, F, each C++ energy
    within ORACLE_TOL of the numpy oracle's where both converge, a basin
    flip (both converge, energies apart) held to functional parity (the
    oracle's energy of the C++ density equal to the C++ energy, that
    density stationary under the oracle's Fock), and at most one outcome
    flip and one basin flip; every trial is returned."""
    from molgym_tpu_torch.calculators import nddo_ref
    from molgym_tpu_torch.calculators.native import nddo_scf_density
    rng = np.random.default_rng(7)
    trials = []
    for _ in range(6):
        n = int(rng.integers(2, 6))
        zs = [int(rng.choice([1, 6, 7, 8, 9])) for _ in range(n)]
        pos = rng.uniform(-1.0, 1.0, (n, 3)) * 1.4
        pos[:, 0] += np.arange(n) * 1.6
        e_cpp = _pm6_calc(zs, pos).calculate_energy()
        oracle = nddo_ref.NDDO(zs, pos)
        e_py, conv_py = oracle.scf()
        trial = dict(zs=zs, cpp=e_cpp, oracle=float(e_py),
                     oracle_converged=bool(conv_py))
        if conv_py and not np.isnan(e_cpp):
            trial['error'] = abs(e_cpp - e_py)
            if trial['error'] <= ORACLE_TOL:
                trial['outcome'] = 'equal'
            else:
                e_dens, pa, pb = nddo_scf_density(zs, pos)
                e_func, stat = oracle.energy_of_density(pa, pb)
                trial.update(outcome='basin flip', density_energy=e_dens,
                             functional=float(e_func),
                             stationarity=float(stat))
                if not (abs(e_dens - e_cpp) <= 1e-9
                        and abs(e_func - e_cpp) <= 1e-8 and stat < 1e-5):
                    raise AssertionError(f'functional parity broken: {trial}')
        elif conv_py != (not np.isnan(e_cpp)):
            trial['outcome'] = 'outcome flip'
        else:
            trial['outcome'] = 'neither converged'
        trials.append(trial)
    outcomes = [t['outcome'] for t in trials]
    if (outcomes.count('outcome flip') > 1 or outcomes.count('basin flip') > 1
            or sum('error' in t for t in trials) < 4):
        raise AssertionError(f'random molecules: {outcomes}')
    return trials


def check_host_golden():
    """Phase 10c: the host library this process loaded, built on this host
    from the port's sources, held to the reference's golden PM6 values, to
    the port's numpy oracle (calculators/nddo_ref.py) on the H2O fixture,
    on SF6 (where the d shell of S is reached) and on six random molecules,
    and to the EHT anchors of tests/test_eht.py::TestEHTExternalAnchors.
    Raises on the first reading past its gate; returns every reading beside
    its gate. Runs on any host: `chip_smoke.check_host_golden()`."""
    from molgym_tpu_torch.calculators import nddo_ref
    from molgym_tpu_torch.calculators.native import eht_orbital_energies
    t0 = time.perf_counter()
    readings = []
    for symbol, mult, golden in GOLDEN_ATOMS:
        e = _pm6_calc([symbol], [(0, 0, 0)], mult).calculate_energy()
        _gate(readings, f'{symbol} atom (multiplicity {mult})', e,
              GOLDEN_ATOM_TOL, abs(e - golden))
    e = _pm6_calc(['H', 'H'], [(0, 0, 0), (1.2, 0, 0)], 1).calculate_energy()
    _gate(readings, 'H2 at 1.2 A', e, GOLDEN_TOL, abs(e - GOLDEN_H2))
    h2o = _pm6_calc(['O', 'H', 'H'], GOLDEN_H2O_POS, 1)
    e, g = h2o.calculate_energy(), h2o.calculate_gradients()
    _gate(readings, 'H2O fixture', e, GOLDEN_TOL, abs(e - GOLDEN_H2O))
    _gate(readings, 'H2O gradients, max |error|', g.tolist(),
          GOLDEN_GRADIENT_TOL, float(np.abs(g - GOLDEN_H2O_GRADIENTS).max()))
    oracle_h2o = nddo_ref.energy([8, 1, 1], GOLDEN_H2O_POS)
    _gate(readings, 'H2O fixture against the oracle', e, ORACLE_TOL,
          abs(e - oracle_h2o))
    d = SF6_BOND
    sf6 = [[0, 0, 0], [d, 0, 0], [-d, 0, 0], [0, d, 0], [0, -d, 0],
           [0, 0, d], [0, 0, -d]]
    e = _pm6_calc(['S'] + ['F'] * 6, sf6).calculate_energy()
    _gate(readings, f'SF6 at {d} A against the oracle', e, ORACLE_TOL,
          abs(e - nddo_ref.energy([16] + [9] * 6, sf6)))
    trials = random_molecules_against_oracle()

    # EHT: the Wolfsberg-Helmholz two-level relation of H2 (one overlap S
    # from both eigenvalues), CH4's t2 degeneracy and Koopmans IPs, N2's
    # HOMO-LUMO gap (tests/test_eht.py::TestEHTExternalAnchors)
    eps, n_elec = eht_orbital_energies([1, 1], [[0, 0, 0], [0.74, 0, 0]])
    h_ii, k = -13.6, 1.75
    s_bond = (eps[0] - h_ii) / (k * h_ii - eps[0])
    s_anti = (eps[1] - h_ii) / (eps[1] - k * h_ii)
    if not (n_elec == 2 and len(eps) == 2 and 0.0 < s_bond < 1.0
            and eps[0] < h_ii < eps[1]):
        raise AssertionError(f'EHT H2: {eps}, {n_elec}, S {s_bond}')
    _gate(readings, 'EHT H2 overlap from both levels', s_bond, 1e-6,
          abs(s_bond - s_anti))
    r = 1.09 / np.sqrt(3.0)
    eps, n_elec = eht_orbital_energies(
        [6, 1, 1, 1, 1], [[0, 0, 0], [r, r, r], [r, -r, -r], [-r, r, -r],
                          [-r, -r, r]])
    _gate(readings, 'EHT CH4 t2 degeneracy (eV)', eps[1:4].tolist(), 1e-6,
          float(max(abs(eps[1] - eps[2]), abs(eps[2] - eps[3]))))
    if not (n_elec == 8 and len(eps) == 8 and eps[3] < eps[4] - 1.0
            and -16.5 < eps[1] < -12.5 and -26.5 < eps[0] < -21.0):
        raise AssertionError(f'EHT CH4: {eps}, {n_elec}')
    eht = dict(h2_overlap=float(s_bond), ch4_2a1_ev=float(eps[0]),
               ch4_t2_ev=float(eps[1]), ch4_gap_ev=float(eps[4] - eps[3]))
    eps, n_elec = eht_orbital_energies([7, 7], [[0, 0, 0], [1.10, 0, 0]])
    if not (n_elec == 10 and eps[5] - eps[4] > 1.0
            and -19.0 < eps[4] < -12.0):
        raise AssertionError(f'EHT N2: {eps}, {n_elec}')
    eht.update(n2_homo_ev=float(eps[4]), n2_gap_ev=float(eps[5] - eps[4]))
    return dict(readings=readings, random_molecules=trials, eht=eht,
                seconds=time.perf_counter() - t0)


def recompute_rewards(traj, space, calculator, min_reward):
    """Every placed atom's reward computed again by `calculator` from the
    trajectory's float32 canvases and positions, clamped at min_reward in
    float32 as the env does; the number of placed atoms, and the largest
    difference from the trajectory's rewards (0: the same bits)."""
    zs_table = np.asarray(space.zs)
    elements = traj.obs.elements.cpu().numpy()
    positions = traj.obs.positions.cpu().numpy()
    next_el = traj.next_obs.elements.cpu().numpy()
    next_pos = traj.next_obs.positions.cpu().numpy()
    n_obs, n_next = (elements != 0).sum(-1), (next_el != 0).sum(-1)
    t_idx, b_idx = np.nonzero(n_next > n_obs)
    slot = n_obs[t_idx, b_idx]
    raw = calculator.batch_reward(
        zs_table[elements[t_idx, b_idx]], positions[t_idx, b_idx],
        n_obs[t_idx, b_idx], zs_table[next_el[t_idx, b_idx, slot]],
        next_pos[t_idx, b_idx, slot], np.ones(len(t_idx), np.uint8))
    want = np.maximum(raw.astype(np.float32), np.float32(min_reward))
    got = traj.rewards.cpu().numpy()[t_idx, b_idx]
    return len(t_idx), float(np.abs(got - want).max(initial=0.0))


def run_host_transports(dev, method, epsilon):
    """A PM6_ENVS x NUM_STEPS rollout of the SF6 agent (full width, random
    weights from a seed) with the host reward `method`, through the
    pipelined and then the in-step transport from one generator state; the
    launch counts zeroed before each and read after. The library's energy
    cache is the process's: the in-step run meets the geometries the
    pipelined one computed. Every field of the trajectories and the
    generator's final state the same bits, each placed atom's reward
    computed again by a fresh calculator equal to the trajectory's, and
    exact launch counts (T + 1 forwards, and one for each recompute)."""
    from molgym_tpu_torch.agents.covariant import CovariantAC
    from molgym_tpu_torch.calculators import native
    from molgym_tpu_torch.calculators.reward_host import (
        TimedBatchCalculator, make_host_reward)
    from molgym_tpu_torch.envs.environment import MolecularEnv
    from molgym_tpu_torch.formula import string_to_formula
    from molgym_tpu_torch.ops import fused_agg
    from molgym_tpu_torch.rl import rollout as rl
    from molgym_tpu_torch.spaces import ObservationSpace

    space = ObservationSpace(canvas_size=7, zs=list(SF6_AGENT['zs']))
    bag = space.bag_from_formula(string_to_formula('SF6'))
    calc = TimedBatchCalculator(native.NativeBatchCalculator(method, epsilon))
    env = MolecularEnv(make_host_reward(calc), space, bag[None], device=dev)
    torch.manual_seed(SEED + 3)
    agent = CovariantAC(**SF6_AGENT, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    rl.make_rollout_fn(env, agent, 2)(agent, env.init_states(PM6_ENVS, gen),
                                      gen)   # warm-up: tables, allocator

    def one(name, fn):
        torch.cuda.synchronize()
        fused_agg.reset_launch_counts()
        res, run = bench.run_transport(fn, agent, env, calc, PM6_ENVS, SEED,
                                       dev)
        res['counts'] = dict(fused_agg.launch_counts)
        expected = expected_launches(per_forward_launches(agent),
                                     NUM_STEPS + 1 + res['recomputes'], 0)
        if res['counts'] != expected:
            raise AssertionError(f'{name}: launches {res["counts"]}, '
                                 f'expected {expected}')
        if res['reward_calls'] != NUM_STEPS:
            raise AssertionError(f'{name}: {res["reward_calls"]} reward calls')
        return res, run

    runs = {'pipelined': one('pipelined', rl.make_pipelined_host_rollout_fn(
                env, agent, calc, NUM_STEPS)),
            'in_step': one('in_step', rl.make_rollout_fn(env, agent,
                                                         NUM_STEPS))}
    bench.check_same_rollout(f'method {method}', runs['pipelined'][1],
                             runs['in_step'][1])
    ref = runs['in_step'][1][1]
    if not torch.isfinite(ref.rewards).all():
        raise AssertionError('non-finite rewards')
    placed, err = recompute_rewards(
        ref, space, native.NativeBatchCalculator(method, epsilon),
        env.min_reward)
    if err != 0.0 or placed == 0:
        raise AssertionError(f'recomputed rewards of {placed} placed atoms '
                             f'differ by {err}')
    return dict(placed_atoms=placed,
                steps_at_min_reward=int((ref.rewards <= env.min_reward).sum()),
                mean_reward=float(ref.rewards.mean()),
                counts=runs['pipelined'][0]['counts'],
                pool_evals_batches=calc.pool_stats(),
                transports={n: {k: v for k, v in r.items() if k != 'counts'}
                            for n, (r, _t) in runs.items()})


# experiments/sf6_internal/logs/sf6int_run-1.json: the internal (SchNet)
# agent, X,S,F, canvas 7, width 128, 3 interactions, 64 atom features
INTERNAL_SF6 = dict(zs=(0, 16, 9), canvas_size=7)
SF6_INTERNAL = ['--name=sf6int', '--formulas=SF6', '--canvas_size=7',
                '--symbols=X,S,F', '--bag_scale=5', '--model=internal',
                '--network_width=128', '--num_interactions=3',
                '--min_mean_distance=1.1', '--max_mean_distance=2.1',
                '--num_envs=10', '--num_steps_per_iter=140',
                '--mini_batch_size=140', '--reward=device_lj',
                '--num_eval_episodes=1', '--save_rollouts=eval', '--seed=1',
                '--num_steps=280', '--log_level=WARNING']
# experiments/host_loop/logs/hostloop_run-1.json: the mlp model, O2 on a
# canvas of 3, width 32, the host LJ reward, cut to 2 iterations
HOST_LOOP_MLP = ['--name=hostloop', '--formulas=O2', '--canvas_size=3',
                 '--symbols=X,O', '--bag_scale=2', '--model=mlp',
                 '--network_width=32', '--min_mean_distance=0.8',
                 '--max_mean_distance=1.8', '--num_envs=8',
                 '--num_steps_per_iter=128', '--mini_batch_size=64',
                 '--reward=lj', '--eval_freq=4', '--num_eval_episodes=1',
                 '--save_rollouts=none', '--seed=1', '--num_steps=256',
                 '--log_level=WARNING']


def make_internal_agent(device):
    """The SF6 internal agent of SF6_INTERNAL, random weights."""
    from molgym_tpu_torch.agents.schnet import make_schnet_agent
    return make_schnet_agent(num_zs=len(INTERNAL_SF6['zs']),
                             canvas_size=INTERNAL_SF6['canvas_size'],
                             network_width=128, min_max_distance=(1.1, 2.1),
                             n_interactions=3, device=device)


def run_internal_rollout(dev):
    """The fifth path's rollout: the SF6 internal agent at full width, 140
    envs x 14 steps with the device LJ reward, through run_rollout's checks
    (3 fused heads a forward, no other kernel); then the host ms of one
    `act`, an env step and an auto-reset, and one profiled rollout (launches
    a step, the device's idle share)."""
    from molgym_tpu_torch import profile_rollout
    from molgym_tpu_torch.envs.environment import MolecularEnv
    from molgym_tpu_torch.envs.reward import make_lennard_jones_reward
    from molgym_tpu_torch.formula import string_to_formula
    from molgym_tpu_torch.rl.rollout import make_rollout_fn
    from molgym_tpu_torch.spaces import ObservationSpace

    space = ObservationSpace(canvas_size=INTERNAL_SF6['canvas_size'],
                             zs=list(INTERNAL_SF6['zs']))
    bag = space.bag_from_formula(string_to_formula('SF6'))
    env = MolecularEnv(make_lennard_jones_reward(), space, bag[None],
                       device=dev)
    torch.manual_seed(SEED + 4)
    agent = make_internal_agent(dev)
    _traj, res = run_rollout(dev, env, agent, make_internal_agent,
                             max_episode_len=7)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    phases = profile_rollout.phase_ms(env, agent, NUM_ENVS, gen)
    prof = profile_rollout.profile_rollout(
        make_rollout_fn(env, agent, NUM_STEPS), env, agent, NUM_ENVS,
        NUM_STEPS, gen)
    return dict(res, phases=phases, profile=prof)


# the sixth to eighth paths, each from its recorded configuration, its
# assets by absolute path, cut to 2 PPO iterations
EXPERIMENTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'experiments')
# experiments/solvation/logs/solv_run-1.json; every rollout is saved (the
# run saved its evaluations') so that the refills can be counted
SOLVATION = ['--name=solv', '--formulas=H2O',
             '--initial_structure=' + os.path.join(EXPERIMENTS, 'solvation',
                                                   'solute.xyz'),
             '--num_refills=2', '--distance_penalty=0.01', '--canvas_size=12',
             '--symbols=X,H,C,O', '--bag_scale=4', '--model=internal',
             '--network_width=64', '--num_interactions=3', '--num_envs=10',
             '--num_steps_per_iter=140', '--mini_batch_size=140',
             '--reward=device_lj', '--num_eval_episodes=1',
             '--save_rollouts=all', '--seed=1', '--num_steps=280',
             '--log_level=WARNING']
# experiments/scaffold_pm6/logs/scafpm6_run-1.json, with the pipelined host
# loop; every rollout is saved (the run saved its evaluations') so that the
# hull check sees the training's placements too
SCAFFOLD_PM6 = ['--name=scafpm6', '--formulas=H2O',
                '--scaffold=' + os.path.join(EXPERIMENTS, 'scaffold_pm6',
                                             'cube.xyz'),
                '--canvas_size=12', '--symbols=X,H,O,Ar', '--bag_scale=3',
                '--model=internal', '--network_width=128',
                '--num_interactions=3', '--num_envs=8',
                '--num_steps_per_iter=256', '--mini_batch_size=128',
                '--reward=pm6', '--host_reward_mode=loop', '--eval_freq=3',
                '--save_rollouts=all', '--seed=1', '--num_steps=512',
                '--log_level=WARNING']
# experiments/qm9_pm6/logs/qm9pm6_run-1.json: its bag set is drawn from the
# committed sample, and the recorded run drew QM9_FORMULAS
QM9_PM6 = ['--name=qm9pm6',
           '--qm9_dataset=' + os.path.join(EXPERIMENTS, 'qm9_pm6',
                                           'qm9_sample.tar.gz'),
           '--qm9_num_formulas=4', '--canvas_size=7', '--symbols=X,H,C,N,O,F',
           '--reward=pm6', '--model=covariant', '--beta=-10', '--bag_scale=6',
           '--num_envs=10', '--num_steps_per_iter=140',
           '--mini_batch_size=140', '--save_rollouts=eval', '--seed=1',
           '--num_steps=280', '--log_level=WARNING']
QM9_FORMULAS = 'CNH,COH2,CFH3,CO2H2'
COVARIANCE_TOL = 1e-5   # the JAX test's, float32


def run_driver_rollout(dev, config, env_builder, solvation=False):
    """The rollout of the run `config` describes, through the driver's env
    builder and make_reward_fn, its agent at the recorded width with random
    weights from a seed, at the run's num_envs and steps per env: exact
    forward-only launch counts with the counters zeroed just before, finite
    outputs, the agent on the card against itself on the CPU on the
    rollout's data; then the host ms of one `act`, an env step and an
    auto-reset, and one profiled rollout (launches a step, idle share)."""
    from molgym_tpu_torch import profile_rollout
    from molgym_tpu_torch.ops import fused_agg
    from molgym_tpu_torch.rl.rollout import make_rollout_fn
    from molgym_tpu_torch.spaces import ObservationSpace, symbols_to_zs
    from molgym_tpu_torch.tools.driver import make_reward_fn
    from molgym_tpu_torch.tools.model_util import build_model

    space = ObservationSpace(config['canvas_size'],
                             symbols_to_zs(config['symbols']))
    reward_fn, _calc = make_reward_fn(config, solvation=solvation)
    env, _eval_env = env_builder(config, space, reward_fn, dev)
    torch.manual_seed(SEED + 6)
    agent = build_model(config, space, device=dev)
    num_envs = config['num_envs']
    steps = config['num_steps_per_iter'] // num_envs
    gen = torch.Generator(device=dev).manual_seed(SEED)
    make_rollout_fn(env, agent, 2)(agent, env.init_states(num_envs, gen),
                                   gen)   # warm-up: tables, allocator
    rollout = make_rollout_fn(env, agent, steps)
    states = env.init_states(num_envs, gen)
    torch.cuda.synchronize()
    fused_agg.reset_launch_counts()
    t0 = time.perf_counter()
    states, traj = rollout(agent, states, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(fused_agg.launch_counts)
    expected = expected_launches(per_forward_launches(agent), steps + 1, 0)
    if counts != expected:
        raise AssertionError(f'launches {counts}, expected {expected}')
    for name in ('rewards', 'logps', 'values', 'actions', 'bootstrap_value'):
        if not torch.isfinite(getattr(traj, name)).all():
            raise AssertionError(f'non-finite {name}')

    cpu_agent = build_model(config, space, device='cpu')
    cpu_agent.load_state_dict(agent.state_dict())
    obs = traj.obs.map(lambda x: x[steps // 2])
    actions = traj.actions[steps // 2]
    with torch.no_grad():
        g_logp, _g_ent, g_v = agent.evaluate(obs, actions)
        c_logp, _c_ent, c_v = cpu_agent.evaluate(obs.map(lambda x: x.cpu()),
                                                 actions.cpu())
    model_err = max(float((g_logp.cpu() - c_logp).abs().max()),
                    float((g_v.cpu() - c_v).abs().max()))
    if not model_err <= MODEL_TOL:
        raise AssertionError(f'card vs CPU agent: max |d logp|, |d v| = '
                             f'{model_err}')
    extra = {}
    if env.n_scaffold:
        placed, worst = hull_violation(
            traj.next_obs.elements.cpu().numpy(),
            traj.next_obs.positions.cpu().numpy(), env.n_scaffold,
            int(env.initial_elements[0]), env.hull_a.cpu().numpy(),
            env.hull_b.cpu().numpy())
        if worst > 1e-5:
            raise AssertionError(f'an atom {worst} outside the hull')
        extra = dict(atoms_in_hull=placed, max_halfspace_value=worst)
    phases = profile_rollout.phase_ms(env, agent, num_envs, gen)
    prof = profile_rollout.profile_rollout(rollout, env, agent, num_envs,
                                           steps, gen)
    return traj, env, dict(num_envs=num_envs, steps=steps, seconds=seconds,
                           ms_per_step=seconds * 1e3 / steps, counts=counts,
                           model_err=model_err,
                           episodes=int(traj.terminals.sum()),
                           mean_reward=float(traj.rewards.mean()),
                           phases=phases, profile=prof, **extra)


def _rollouts(config, tag):
    """The rollouts the run saved, as RolloutSaver pickled them."""
    import glob
    import pickle
    out = []
    for path in sorted(glob.glob(os.path.join(config['data_dir'],
                                              f'{tag}_steps-*.pkl'))):
        with open(path, 'rb') as f:
            out.append((os.path.basename(path), pickle.load(f)))
    if not out:
        raise AssertionError(f'no rollouts saved in {config["data_dir"]}')
    return out


def check_refills(config, tag):
    """Some episode of the solvation run placed more atoms than its first
    bag (H2O) holds: its bag was refilled."""
    bag = 3
    solute = 2
    most = max(int(((r['next_obs']['elements'] != 0).sum(-1) - solute).max())
               for _name, r in _rollouts(config, tag))
    if most <= bag:
        raise AssertionError(f'no episode refilled its bag (most atoms '
                             f'placed: {most})')
    return dict(most_atoms_placed=most)


def hull_violation(elements, positions, n_scaffold, scaffold_z, a, b):
    """Canvases [..., N] of a scaffold run: raises unless each holds the
    scaffold in its first n_scaffold slots; (atoms placed beside it, the
    largest value of A x + b over them, 0 when there are none)."""
    n = elements.shape[-1]
    elements = elements.reshape(-1, n)
    positions = positions.reshape(-1, n, 3)
    if not (elements[:, :n_scaffold] == scaffold_z).all():
        raise AssertionError('a canvas lost its scaffold')
    new = positions[:, n_scaffold:][elements[:, n_scaffold:] != 0]
    return len(new), float((new @ a.T + b).max()) if len(new) else 0.0


def check_hull(config, tag):
    """Every canvas of the scaffold run's training and evaluation rollouts
    holds the cube's 8 Ar in its first slots, and every atom placed beside
    them satisfies A x + b <= 1e-5 for the cube's hull halfspaces; some atom
    was placed. Greedy evaluations at random weights may place none: then
    `gap` says that the evaluations' half of the check checked nothing."""
    from molgym_tpu_torch.atoms import read_xyz
    from molgym_tpu_torch.envs.environment import scaffold_halfspaces
    cube = read_xyz(config['scaffold'])
    a, b = scaffold_halfspaces(cube.positions)
    ar = config['symbols'].split(',').index('Ar')
    placed = {'train': 0, 'eval': 0}
    worst = None
    for name, r in _rollouts(config, tag):
        n, w = hull_violation(r['next_obs']['elements'],
                              r['next_obs']['positions'], len(cube), ar, a, b)
        placed['eval' if name.endswith('_eval.pkl') else 'train'] += n
        if n:
            worst = w if worst is None else max(worst, w)
    if worst is None or worst > 1e-5:
        raise AssertionError(f'atoms placed {placed}, the largest A x + b '
                             f'{worst}')
    out = dict(atoms_in_hull=placed, max_halfspace_value=worst)
    if not placed['eval']:
        out['gap'] = ('the evaluations placed no atom: only training '
                      'placements were checked against the hull')
    return out


def check_formulas(config, tag):
    """The QM9 run drew the recorded bag set (its config snapshot)."""
    with open(os.path.join(config['log_dir'], tag + '.json')) as f:
        formulas = json.load(f)['formulas']
    if formulas != QM9_FORMULAS:
        raise AssertionError(f'QM9 formulas {formulas}, recorded '
                             f'{QM9_FORMULAS}')
    return dict(formulas=formulas)


def run_covariance(dev):
    """The covariant agent's placement density under rotation on the card:
    for the JAX test's agent and molecules (H2O, CH3, CH4) and for the SF6
    agent at full width on partial SF6 canvases, two random rotations each,
    the coefficients of the rotated canvas against apply_wigner of the
    unrotated ones, and their invariants, within COVARIANCE_TOL."""
    from molgym_tpu_torch.agents.covariant import CovariantAC
    from molgym_tpu_torch.equivariance import (MOLECULES, SF6_MOLECULES,
                                               covariance_errors)
    from molgym_tpu_torch.spaces import ObservationSpace
    out = {}
    for name, kwargs, molecules, formula in (
            ('jax_test_agent', COVARIANCE_AGENT, MOLECULES,
             COVARIANCE_FORMULA),
            ('sf6_agent', SF6_AGENT, SF6_MOLECULES, SF6_FORMULA)):
        torch.manual_seed(SEED + 7)
        agent = CovariantAC(**kwargs, device=dev)
        space = ObservationSpace(kwargs['canvas_size'], list(kwargs['zs']))
        errors = [e for seed in (0, 1) for e in covariance_errors(
            agent, space, molecules, formula, seed=seed)]
        worst = max(max(e['covariance'], e['invariance']) for e in errors)
        if not worst < COVARIANCE_TOL:
            raise AssertionError(f'{name}: not covariant on the card: '
                                 f'{errors}')
        out[name] = dict(max_err=worst, errors=errors)
    return out


# phase 13: the canonical SF6 run, cut to 2 iterations, in data-parallel
# ranks; the ranks' functions are this module's, which each spawned rank
# imports anew
DP_RUN = [a for a in CANONICAL if not a.startswith('--num_steps=')] + [
    '--num_steps=280']
DP_GRAD_TOL = 1e-5   # rank 0's reduced gradient against one process's
# W = 2 against W = 1 from the same seed and weights, at the gates of
# tests/test_torch_parallel_draws.py: the first training rollout's discrete
# sub-actions (the covariant agent's focus and element), terminals,
# elements and bags equal, its continuous sub-actions and positions within
# DP_RUN_TOL, its rewards, values and log-probs within DP_RUN_TOL of
# max(1, |value|); the parameters after the run by assert_params_close's
# rule (every element within 2 lr per step + DP_RUN_TOL, at most 1% beyond
# DP_RUN_TOL)
DP_RUN_TOL = 1e-5
DP_DISCRETE = (0, 1)


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _dp_setup(dev, argv):
    """The config, envs, PPO arguments and a fresh agent of random weights
    from SEED on `dev` of the run `argv` describes, as the driver builds
    them."""
    from molgym_tpu_torch.spaces import ObservationSpace, symbols_to_zs
    from molgym_tpu_torch.tools.arg_parser import build_default_argparser
    from molgym_tpu_torch.tools.driver import (make_reward_fn,
                                               ppo_config_from, standard_envs)
    from molgym_tpu_torch.tools.model_util import build_model
    config = vars(build_default_argparser().parse_args(argv))
    space = ObservationSpace(config['canvas_size'],
                             symbols_to_zs(config['symbols']))
    envs, eval_envs = standard_envs(config, space, make_reward_fn(config)[0],
                                    dev)
    torch.manual_seed(SEED)
    agent = build_model(config, space, device=dev)
    kwargs = dict(num_envs=config['num_envs'],
                  num_steps_per_iter=config['num_steps_per_iter'],
                  max_num_steps=config['max_num_steps'],
                  config=ppo_config_from(config),
                  eval_freq=config['eval_freq'],
                  num_eval_episodes=len(config['formulas'].split(',')),
                  seed=config['seed'])
    return config, envs, eval_envs, agent, kwargs


def _cpu_params(agent):
    return {k: v.detach().cpu().clone() for k, v in agent.named_parameters()}


def _timed_iterations(mesh, envs, agent, kwargs):
    """The iteration ms of the run's iterations through
    batch_ppo(mesh=...) with no evaluation and no writes but the records
    in memory, on every rank alike: the timing that W = 1 and W = 2 share
    (an evaluation, or a snapshot to the host, on one rank would stall the
    other in the next gather)."""
    from molgym_tpu_torch.rl.ppo import batch_ppo
    from molgym_tpu_torch.tools.util import MemoryInfoSaver
    records = MemoryInfoSaver()
    batch_ppo(envs, None, agent, info_saver=records, mesh=mesh, **kwargs)
    return [r['iteration_time'] * 1e3 for n, r in records.lines if n == 'opt']


def _dp_expected(config, agent, records, evaluates):
    """The launch counts of a rank's 2 iterations, as phase 7 computes
    them: each rollout of its envs makes T + 1 forwards, an evaluation (the
    writer's) the steps batch_ppo sizes it to plus the bootstrap, and every
    gradient pass one forward and one backward of the rank's chunk of each
    minibatch."""
    from molgym_tpu_torch.rl.ppo import eval_rollout_size
    opt = [r for n, r in records if n == 'opt']
    evals = [r for n, r in records if n == 'eval'] if evaluates else []
    steps_per_env = config['num_steps_per_iter'] // config['num_envs']
    _episodes, eval_steps = eval_rollout_size(
        len(config['formulas'].split(',')), 0, config['canvas_size'])
    samples = config['num_steps_per_iter']
    minibatches = -(-samples // min(config['mini_batch_size'], samples))
    return expected_launches(
        per_forward_launches(agent),
        len(opt) * (steps_per_env + 1) + len(evals) * (eval_steps + 1),
        minibatches * sum(r['num_grad_passes'] for r in opt))


class _FirstRollout:
    """A rollout saver that keeps the run's first training rollout."""

    def __init__(self):
        self.arrays = None

    def save(self, obj, num_steps, info):
        if info == 'train' and self.arrays is None:
            self.arrays = obj


def dp_w1_rank(device, argv):
    """Phase 13a, in one spawned rank on `device` (cuda: cuda:0 over
    NCCL): the iterations of `argv`'s run through plain batch_ppo, then
    through batch_ppo(mesh=make_mesh(1, device)) from the same weights and
    seed, with the launch counts of each and the first training rollout;
    then the timed iterations."""
    from molgym_tpu_torch.ops import fused_agg
    from molgym_tpu_torch.parallel.mesh import make_mesh
    from molgym_tpu_torch.rl.ppo import batch_ppo
    from molgym_tpu_torch.tools.util import MemoryInfoSaver
    with make_mesh(1, device) as mesh:
        config, envs, eval_envs, agent, kwargs = _dp_setup(mesh.device, argv)
        init = {k: v.clone() for k, v in agent.state_dict().items()}
        out = dict(backend=mesh.backend, device=str(mesh.device))
        for name, m in (('plain', None), ('mesh', mesh)):
            agent.load_state_dict(init)
            records, first = MemoryInfoSaver(), _FirstRollout()
            _sync(mesh.device)
            fused_agg.reset_launch_counts()
            t0 = time.perf_counter()
            batch_ppo(envs, eval_envs, agent, info_saver=records, mesh=m,
                      rollout_saver=first, save_train_rollout=True,
                      save_eval_rollout=False, **kwargs)
            _sync(mesh.device)
            out[name] = dict(
                seconds=time.perf_counter() - t0, records=records.lines,
                counts=dict(fused_agg.launch_counts),
                expected=_dp_expected(config, agent, records.lines, True),
                params=_cpu_params(agent), first_rollout=first.arrays)
        out['timed_ms'] = _timed_iterations(mesh, envs, agent, kwargs)
        return out


def _trajectory_from(arrays, dev):
    from molgym_tpu_torch.rl.buffer import Trajectory
    from molgym_tpu_torch.spaces import Observation

    def obs(d):
        return Observation(**{k: torch.from_numpy(v).to(dev)
                              for k, v in d.items()})
    return Trajectory(obs=obs(arrays['obs']), next_obs=obs(arrays['next_obs']),
                      **{k: torch.from_numpy(arrays[k]).to(dev)
                         for k in ('actions', 'rewards', 'terminals',
                                   'values', 'logps', 'bootstrap_value')})


def _grad_err(grads, ref):
    """Max over leaves of |g - ref| over the leaf's max |ref| (a leaf below
    1e-3 of the largest leaf's held against 1e-3 of that), as phase 6."""
    return max(bench.grad_errs(grads, ref).values())


def dp_w2_rank(device, argv):
    """Phase 13b, in each of two spawned ranks, both on `device` (cuda:0)
    over gloo: the iterations of `argv`'s run through batch_ppo(mesh=...),
    rank 0 the writer (it evaluates);
    the parameters after each iteration, the records and launch counts,
    then the timed iterations; on rank 0 also iteration 1's first reduced
    gradient against one process's make_train_fn from the same gathered
    trajectory, parameters, optimizer state and generator state (so the
    same permutation)."""
    from molgym_tpu_torch.ops import fused_agg
    from molgym_tpu_torch.parallel.mesh import make_mesh
    from molgym_tpu_torch.rl.buffer import compute_ppo_data
    from molgym_tpu_torch.rl.ppo import (batch_ppo, make_loss_fn,
                                         make_optimizer, make_train_fn)
    from molgym_tpu_torch.tools.util import MemoryInfoSaver
    with make_mesh(2, device, backend='gloo') as mesh:
        config, envs, eval_envs, agent, kwargs = _dp_setup(mesh.device, argv)
        ppo_config = kwargs['config']
        optimizer = make_optimizer(ppo_config, agent)
        steps, perm_states, snapshots, per_iteration = [], [], {}, []
        optimizer_step, randperm = optimizer.step, torch.randperm

        def step_spy(grads):
            steps.append({k: g.detach().clone() for k, g in grads.items()})
            optimizer_step(grads)

        def randperm_spy(*args, generator=None, **kw):
            perm_states.append(generator.get_state())
            return randperm(*args, generator=generator, **kw)

        class Saver:   # the global training rollout, just before the update
            def save(self, obj, num_steps, info):
                snapshots[num_steps] = (
                    obj, {k: v.clone() for k, v in agent.state_dict().items()},
                    {k: ({n: t.clone() for n, t in v.items()}
                         if isinstance(v, dict) else v)
                     for k, v in optimizer.state_dict().items()})

        class Handler:   # the parameters after each iteration
            def save(self, model, opt, num_steps):
                per_iteration.append(_cpu_params(model))

        optimizer.step = step_spy
        torch.randperm = randperm_spy
        records = MemoryInfoSaver()
        writer = mesh.rank == 0
        _sync(mesh.device)
        fused_agg.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            batch_ppo(envs, eval_envs if writer else None, agent,
                      optimizer=optimizer, info_saver=records,
                      rollout_saver=Saver(), save_train_rollout=True,
                      save_eval_rollout=False, model_handler=Handler(),
                      save_freq=1, mesh=mesh, **kwargs)
        finally:
            torch.randperm = randperm
        _sync(mesh.device)
        out = dict(rank=mesh.rank, seconds=time.perf_counter() - t0,
                   records=records.lines,
                   counts=dict(fused_agg.launch_counts),
                   expected=_dp_expected(config, agent, records.lines,
                                         writer),
                   per_iteration=per_iteration,
                   first_rollout=snapshots[0][0])
        out['timed_ms'] = _timed_iterations(mesh, envs, agent, kwargs)
        if not writer:
            return out

        # one process's update of iteration 1 from the same state
        opt = [r for n, r in records.lines if n == 'opt']
        arrays, state, opt_state = snapshots[config['num_steps_per_iter']]
        data = compute_ppo_data(_trajectory_from(arrays, mesh.device),
                                ppo_config.gamma, ppo_config.lam)
        ref_agent = _dp_setup(mesh.device, argv)[3]
        ref_agent.load_state_dict(state)
        ref_opt = make_optimizer(ppo_config, ref_agent)
        ref_opt.load_state_dict(opt_state)
        ref_steps, ref_step = [], ref_opt.step

        def ref_spy(grads):
            ref_steps.append({k: g.detach().clone() for k, g in grads.items()})
            ref_step(grads)
        ref_opt.step = ref_spy
        generator = torch.Generator(device=mesh.device)
        first = opt[0]['num_grad_passes']   # iteration 1's first draw
        generator.set_state(perm_states[first])
        ref_info = make_train_fn(ref_agent, ref_opt, ppo_config,
                                 config['num_steps_per_iter'])(data,
                                                               generator)
        dp_grads = steps[opt[0]['num_opt_steps']]
        # the same epoch as two chunks of 70 in this process, summed in
        # rank order: what only the data-parallel mechanics could change
        generator.set_state(perm_states[first])
        perm = randperm(config['num_steps_per_iter'], generator=generator,
                        device=mesh.device)
        ref_agent.load_state_dict(state)
        loss_fn = make_loss_fn(ref_agent, ppo_config)
        chunked = {k: torch.zeros_like(p)
                   for k, p in ref_agent.named_parameters()}
        for i in torch.tensor_split(perm, 2):
            ref_agent.zero_grad(set_to_none=True)
            w = torch.ones(len(i), device=mesh.device)
            loss, _info = loss_fn(data['obs'].map(lambda x: x[i]),
                                  data['act'][i], data['logp'][i],
                                  data['adv'][i], data['ret'][i], w,
                                  torch.tensor(float(len(perm)),
                                               device=mesh.device))
            loss.backward()
            for k, p in ref_agent.named_parameters():
                if p.grad is not None:
                    chunked[k] += p.grad
        out.update(grad_err=_grad_err(dp_grads, ref_steps[0]),
                   grad_err_same_chunks=_grad_err(dp_grads, chunked),
                   ref_num_opt_steps=ref_info['num_opt_steps'],
                   num_opt_steps=opt[1]['num_opt_steps'])
        return out


def dp_rollout_err(got, want):
    """The differences of a data-parallel run's first training rollout
    (numpy, as a rollout saver gets it) from one process's: `parted`, the
    discrete sub-actions, terminals, elements and bags that differ; the
    largest |difference| of the continuous sub-actions and positions; and
    of the rewards, values, log-probs and bootstrap values, each over
    max(1, |value|)."""
    parted = int((got['actions'][..., DP_DISCRETE]
                  != want['actions'][..., DP_DISCRETE]).sum())
    parted += int((got['terminals'] != want['terminals']).sum())
    out = dict(actions=float(np.abs(got['actions']
                                    - want['actions']).max()),
               positions=0.0)
    for o in ('obs', 'next_obs'):
        for f in ('elements', 'bag'):
            parted += int((got[o][f] != want[o][f]).sum())
        out['positions'] = max(out['positions'], float(np.abs(
            got[o]['positions'] - want[o]['positions']).max()))
    for f in ('rewards', 'values', 'logps', 'bootstrap_value'):
        out[f] = float((np.abs(got[f] - want[f])
                        / np.maximum(1.0, np.abs(want[f]))).max())
    return dict(parted=parted, **out)


def dp_params_err(params, ref, lr, steps):
    """assert_params_close's rule between two parameter sets: the largest
    |difference|, its bound 2 lr per step + DP_RUN_TOL, and the share of
    elements beyond DP_RUN_TOL (at most 0.01)."""
    diffs = [(p - ref[k]).abs() for k, p in params.items()]
    return dict(max_diff=max(float(d.max()) for d in diffs),
                bound=2 * lr * steps + DP_RUN_TOL,
                off_share=sum(int((d > DP_RUN_TOL).sum()) for d in diffs)
                / sum(d.numel() for d in diffs))


def dp_run_ok(rollout, params):
    return (rollout['parted'] == 0
            and all(v <= DP_RUN_TOL for k, v in rollout.items()
                    if k != 'parted')
            and params['max_diff'] <= params['bound']
            and params['off_share'] <= 0.01)


def dp_bf16_rank(device, argv):
    """Phase 13e, in each of two spawned ranks, both on `device` (cuda:0)
    over gloo: one iteration of `argv`'s run (the bf16 encoder) through
    make_dp_ppo_iteration; rank 0 first runs the same iteration in one
    process (mesh=None) from the same weights and seed, and returns both
    first rollouts and parameters."""
    from molgym_tpu_torch.parallel.mesh import make_dp_ppo_iteration, make_mesh
    with make_mesh(2, device, backend='gloo') as mesh:
        config, envs, _eval_envs, agent, kwargs = _dp_setup(mesh.device,
                                                            argv)
        init = {k: v.clone() for k, v in agent.state_dict().items()}
        out = {}
        for name, m in (('single', None), ('mesh', mesh)):
            if m is None and mesh.rank != 0:
                continue
            agent.load_state_dict(init)
            init_fn, iteration = make_dp_ppo_iteration(
                envs, agent, kwargs['config'], config['num_envs'],
                config['num_steps_per_iter'], m)
            states, optimizer, generator = init_fn(config['seed'])
            _states, traj, info = iteration(states, generator)
            out[name] = dict(rollout=traj.to_numpy(),
                             params=_cpu_params(agent),
                             steps=optimizer.count)
        return out if mesh.rank == 0 else None


def run_cli_data_parallel(device, argv):
    """Phase 13d: the run `argv` describes through molgym_tpu_torch.run
    (run_training's checks: the streams, the exact launch counts, the
    checkpoint against the state the run returns, on the run's device),
    once with --multihost as one process of one rank (the MOLGYM_*
    variables: run_experiment spawns that rank, over NCCL on cuda:0) and
    once as a single process without a process group, from the same
    weights: the rank's rollouts carry _rank-0 and the single process's no
    tag, and the two checkpoints hold the same bits, parameters and
    optimizer state (W = 1 computes what one process does)."""
    from molgym_tpu_torch import run
    from molgym_tpu_torch.parallel.mesh import free_port
    from molgym_tpu_torch.tools.arg_parser import build_default_argparser
    from molgym_tpu_torch.tools.model_io import ModelIO
    dev = torch.device(device)
    argv = argv + ['--save_rollouts=train']
    states = {}

    def inspect(name, rank_tag):
        def check(config, tag):
            files = sorted(os.listdir(config['data_dir']))
            want = sorted(f'{tag}_steps-{n}{rank_tag}_train.pkl' for n in
                          range(0, config['max_num_steps'],
                                config['num_steps_per_iter']))
            if files != want:
                raise AssertionError(f'13d {name}: rollouts {files}, '
                                     f'expected {want}')
            states[name] = ModelIO(config['model_dir'], tag).load_latest(
                'cpu')[0]
            return dict(rollouts=files)
        return check

    out = {}
    env = dict(MOLGYM_COORDINATOR_ADDRESS=f'localhost:{free_port()}',
               MOLGYM_NUM_PROCESSES='1', MOLGYM_PROCESS_ID='0')
    for name, extra, rank_tag, env_ in (
            ('multihost', ['--multihost'], '_rank-0', env),
            ('single', [], '', None)):
        out[name] = run_training(dev, run, build_default_argparser,
                                 argv + extra, iterations=2,
                                 inspect=inspect(name, rank_tag), env=env_)
    one, other = states['multihost'], states['single']
    differ = [k for k, v in one['model'].items()
              if not torch.equal(v, other['model'][k])]
    differ += [f'{key}/{k}' for key in ('mu', 'nu')
               for k, v in one['optimizer'][key].items()
               if not torch.equal(v, other['optimizer'][key][k])]
    if differ or one['optimizer']['count'] != other['optimizer']['count']:
        raise AssertionError(f'13d: the --multihost rank\'s checkpoint '
                             f'differs from one process\'s in '
                             f'{differ or "the count"}')
    for key in ('opt_steps', 'total_loss', 'approx_kl', 'return_mean',
                'eval_return_mean'):
        if json.dumps(out['multihost'][key]) != json.dumps(out['single'][key]):
            raise AssertionError(f'13d: {key} {out["multihost"][key]} '
                                 f'against {out["single"][key]}')
    return out


def run_data_parallel(device='cuda', argv=DP_RUN):
    """Phase 13: (a) W = 1 over NCCL against plain batch_ppo, the same
    bits; (b) W = 2 over gloo, both ranks on this card; (d) --multihost
    as one NCCL rank through molgym_tpu_torch.run against the same run
    in one process; (c) W = 2 over NCCL through molgym_tpu_torch.run
    when there are two cards. `device` cpu and a tiny `argv` with
    --device=cpu rehearse (a), (b) and (d) on the CPU."""
    from molgym_tpu_torch.parallel.mesh import Launch, free_port, spawn

    from molgym_tpu_torch.tools.arg_parser import build_default_argparser

    def launch(n):
        return Launch(n, n, 0, 'localhost', free_port())
    samples = build_default_argparser().parse_args(argv).num_steps_per_iter
    res = {}
    a = spawn(dp_w1_rank, launch(1), (device, argv), timeout=600)[0]
    plain, dp = a['plain'], a['mesh']
    # the launch counts where kernels launch (on the CPU: plain versions)
    counted = device != 'cpu'
    for name, run_ in (('plain', plain), ('mesh', dp)):
        if counted and run_['counts'] != run_['expected']:
            raise AssertionError(f'13a {name}: launches {run_["counts"]}, '
                                 f'expected {run_["expected"]}')
    differ = [k for k, v in plain['params'].items()
              if not torch.equal(v, dp['params'][k])]
    untimed = [[(n, {k: v for k, v in r.items()
                     if k not in ('time', 'iteration_time')})
                for n, r in x['records']] for x in (plain, dp)]
    if differ or json.dumps(untimed[0]) != json.dumps(untimed[1]):
        raise AssertionError(f'13a: W = 1 over NCCL differs from plain '
                             f'batch_ppo in {differ or "the records"}')
    res['w1'] = dict(backend=a['backend'], device=a['device'],
                     same_bits=True, counts=dp['counts'],
                     **{f'{n}_iteration_ms': [r['iteration_time'] * 1e3
                                              for k, r in x['records']
                                              if k == 'opt']
                        for n, x in (('plain', plain), ('mesh', dp))},
                     timed_ms=a['timed_ms'])

    b = spawn(dp_w2_rank, launch(2),
              ('cuda:0' if device == 'cuda' else device, argv), timeout=600)
    for r in b:
        opt = [x for n, x in r['records'] if n == 'opt']
        if len(opt) != 2 or min(x['num_opt_steps'] for x in opt) < 1:
            raise AssertionError(f'13b rank {r["rank"]}: updates {opt}')
        for _n, rec in r['records']:
            bad = [k for k, v in rec.items()
                   if not isinstance(v, str) and not np.isfinite(v)]
            if bad:
                raise AssertionError(f'13b rank {r["rank"]}: non-finite '
                                     f'{bad}')
        if counted and r['counts'] != r['expected']:
            raise AssertionError(f'13b rank {r["rank"]}: launches '
                                 f'{r["counts"]}, expected {r["expected"]}')
    for it, (p0, p1) in enumerate(zip(b[0]['per_iteration'],
                                      b[1]['per_iteration'])):
        if not all(torch.equal(v, p1[k]) for k, v in p0.items()):
            raise AssertionError(f'13b: the replicas differ after iteration '
                                 f'{it}')
    r0 = b[0]
    if len(r0['per_iteration']) != 2:
        raise AssertionError('13b: 2 iterations expected')
    # the run does not depend on W: W = 2 against 13a's plain W = 1 run
    lr = build_default_argparser().parse_args(argv).learning_rate
    steps = sum(x['num_opt_steps'] for n, x in plain['records'] if n == 'opt')
    against_w1 = [dict(rollout=dp_rollout_err(r['first_rollout'],
                                              plain['first_rollout']),
                       params=dp_params_err(r['per_iteration'][-1],
                                            plain['params'], lr, steps))
                  for r in b]
    log('phase 13b against 13a (W = 2 against W = 1, the first training '
        'rollout and the parameters after 2 iterations):',
        json.dumps(against_w1))
    for r, err in zip(b, against_w1):
        if not dp_run_ok(err['rollout'], err['params']):
            raise AssertionError(f'13b rank {r["rank"]}: W = 2 differs from '
                                 f'W = 1 beyond the gates: {err}')
    if (r0['grad_err'] > DP_GRAD_TOL
            or r0['num_opt_steps'] != r0['ref_num_opt_steps']):
        raise AssertionError(
            f'13b: rank 0\'s reduced gradient {r0["grad_err"]} of a leaf\'s '
            f'max |g| from one process\'s (the same chunks in one process: '
            f'{r0["grad_err_same_chunks"]}); {r0["num_opt_steps"]} steps, one '
            f'process {r0["ref_num_opt_steps"]}')
    # the checked run's times (rank 0 evaluates and both snapshot to the
    # host) beside the timed run's (no evaluation, no writes, on every rank
    # as at W = 1); the throughput from the timed runs, a W = 2 iteration
    # lasting as long as its slower rank
    ms = [[x['iteration_time'] * 1e3 for n, x in r['records'] if n == 'opt']
          for r in b]
    res['w2'] = dict(
        backend='gloo', device='both ranks on one', same_bits=True,
        grad_err=r0['grad_err'],
        grad_err_same_chunks=r0['grad_err_same_chunks'],
        num_opt_steps=r0['num_opt_steps'], checked_iteration_ms=ms,
        timed_ms=[r['timed_ms'] for r in b],
        env_steps_per_s=[samples * 1e3 / max(a_, b_)
                         for a_, b_ in zip(*(r['timed_ms'] for r in b))],
        counts=[r['counts'] for r in b], against_w1=against_w1)
    res['w1']['env_steps_per_s'] = [samples * 1e3 / t
                                    for t in res['w1']['timed_ms']]
    res['w2']['ratio_to_w1'] = [w2 / w1 for w2, w1 in zip(
        res['w2']['env_steps_per_s'], res['w1']['env_steps_per_s'])]
    res['cli'] = run_cli_data_parallel(device, argv)

    # the bf16 encoder, W = 2 against one process: measured, not gated
    bf16 = spawn(dp_bf16_rank, launch(2),
                 ('cuda:0' if device == 'cuda' else device,
                  argv + ['--encoder_dtype=bfloat16']), timeout=600)[0]
    lr_steps = (lr, bf16['single']['steps'])
    if bf16['mesh']['steps'] != bf16['single']['steps']:
        raise AssertionError(f'13e: {bf16["mesh"]["steps"]} steps at W = 2, '
                             f'{bf16["single"]["steps"]} in one process')
    res['bf16_against_w1'] = dict(
        rollout=dp_rollout_err(bf16['mesh']['rollout'],
                               bf16['single']['rollout']),
        params=dp_params_err(bf16['mesh']['params'],
                             bf16['single']['params'], *lr_steps))
    log('phase 13e, the bf16 encoder, W = 2 against one process (one '
        'iteration; measured, not gated):', json.dumps(res['bf16_against_w1']))

    if device != 'cuda' or torch.cuda.device_count() < 2:
        log('phase 13c not run: one card visible, NCCL across two cards '
            'needs two')
        res['w2_nccl'] = 'not run: one card'
        return res
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        argv = DP_RUN + [f'--{d}_dir={tmp}/{d}' for d in
                         ('log', 'model', 'data', 'results')] + [
                             '--num_devices=2']
        proc = subprocess.run([sys.executable, '-m', 'molgym_tpu_torch.run']
                              + argv, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode:
            raise AssertionError(f'13c failed:\n{proc.stdout}\n{proc.stderr}')
        with open(f'{tmp}/results/sf6_run-0_opt.txt') as f:
            opt = [json.loads(line) for line in f]
        if (len(opt) != 2 or min(r['num_opt_steps'] for r in opt) < 1
                or not all(np.isfinite(r['total_loss']) for r in opt)):
            raise AssertionError(f'13c: updates {opt}')
        from molgym_tpu_torch.tools.model_io import ModelIO
        state, steps = ModelIO(f'{tmp}/model', 'sf6_run-0').load_latest()
        if steps != 280 or state['optimizer']['count'] != sum(
                r['num_opt_steps'] for r in opt):
            raise AssertionError(f'13c: checkpoint at {steps} steps')
        res['w2_nccl'] = dict(iteration_ms=[r['iteration_time'] * 1e3
                                            for r in opt])
    return res


# phase 15: the bench's settings, small enough for a smoke
BENCH_SMOKE = dict(iters=3, iters_2240=2, samples=10, reps=1)

# phase 16: the trace's device ms a step against profile_grad's busy ms of
# one call (the profiler's own readings of the same program)
PROFILE_BUSY_TOL = 0.15


def run_profiler():
    """Phase 16: profile_minibatch's --trace at B = 140 and --sweep in this
    process, checked against bench.profile_grad and the launch counts of
    one call of the same program (see the module docstring)."""
    from molgym_tpu_torch import profile_minibatch as pm
    from molgym_tpu_torch.ops.kernel_common import launch_counts

    start = time.perf_counter()
    fn, _cpu_fn = pm.build_grad_fn(pm.BATCH)
    fn()
    torch.cuda.synchronize()
    before = dict(launch_counts)
    fn()
    torch.cuda.synchronize()
    per_call = {k: launch_counts[k] - before[k] for k in pm.PORT_KERNELS}
    prof = bench.profile_grad(fn)
    with contextlib.redirect_stdout(sys.stderr):
        summary = pm.run_trace(pm.BATCH, 'f32')
        rows = pm.run_sweep()
    if summary['launches_per_step'] != prof['launches_per_fwd_bwd']:
        raise AssertionError(
            f'profiler: {summary["launches_per_step"]} launches a step in the '
            f'trace, profile_grad {prof["launches_per_fwd_bwd"]}')
    busy_err = (abs(summary['device_ms_per_step'] - prof['device_busy_ms'])
                / prof['device_busy_ms'])
    if not busy_err <= PROFILE_BUSY_TOL:
        raise AssertionError(
            f'profiler: {summary["device_ms_per_step"]} device ms a step, '
            f'profile_grad {prof["device_busy_ms"]} busy ms')
    traced = pm.port_kernel_launches(summary)
    if traced != per_call or not all(per_call.values()):
        raise AssertionError(f'profiler: the port\'s kernels {traced} '
                             f'launches a step, {per_call} counted a call')
    # B = 140 and 560 take the same host time, within its spread (on an
    # H100 at 700 W, 560 read 61.05 ms against 140's 67.48 in one sweep):
    # the largest batch takes the longest, and the ms per 140 rows fall
    ms = [r['ms'] for r in rows]
    per_140 = [r['ms_per_140_rows'] for r in rows]
    if not (all(np.isfinite([v for r in rows for v in r.values()]))
            and [r['batch'] for r in rows] == list(pm.SWEEP)
            and ms[-1] > max(ms[:-1])
            and all(a > b for a, b in zip(per_140, per_140[1:]))
            and all(0 < r['mfu_pct'] <= 100 for r in rows)):
        raise AssertionError(f'profiler: sweep rows {rows}')
    return dict(trace={k: v for k, v in summary.items()
                       if k not in ('kernels', 'rollup')},
                top_kernels=summary['kernels'][:12],
                rollup=summary['rollup'][:12], sweep=rows,
                profile_grad=prof, busy_err=busy_err, port_kernels=per_call,
                gate=pm.gate('f32'), seconds=time.perf_counter() - start)


# phase 17: the recorded runs with a device reward, as
# tools/recorded_run.py resolves them (a log JSON, or an experiment that
# its UNLOGGED table names), and the counters each one's path moves
RECORDED = {
    'sf6_bf16': os.path.join(EXPERIMENTS, 'sf6_bf16', 'logs',
                             'sf6bf16_run-1.json'),
    'organics': os.path.join(EXPERIMENTS, 'organics', 'logs',
                             'organics_run-1.json'),
    'solvation': os.path.join(EXPERIMENTS, 'solvation', 'logs',
                              'solv_run-1.json'),
    'scaffold': os.path.join(EXPERIMENTS, 'scaffold'),
}
_COVARIANT = ('cg_aggregate_edge_fused_ri', 'cg_aggregate_edge_fused_ri_bwd',
              'cg_square_fused_ri', 'cg_square_fused_ri_bwd')
_HEADS = ('masked_softmax', 'masked_softmax_bwd')
_MIXER = ('cg_contract_ri', 'cg_contract_ri_bwd') + _HEADS
RECORDED_KERNELS = {
    'sf6_bf16': tuple(k + '_bf16' for k in _COVARIANT) + _MIXER,
    'organics': _COVARIANT + _MIXER,
    'solvation': _HEADS,
    'scaffold': _HEADS,
}
RECORDED_ITERATIONS = 2


def run_recorded(dev):
    """Phase 17: each of RECORDED's commands, from recorded_run, for
    RECORDED_ITERATIONS iterations through its driver (run_training's
    checks); on the card the counters that moved must be RECORDED_KERNELS'.
    Returns run_training's result by name."""
    import importlib

    from molgym_tpu_torch.tools import recorded_run
    out = {}
    for name, record in RECORDED.items():
        module, argv = recorded_run.recorded_argv(record)
        samples = recorded_run.parser_of(module).parse_args(
            argv).num_steps_per_iter
        argv += [f'--num_steps={RECORDED_ITERATIONS * samples}',
                 '--log_level=WARNING']
        res = run_training(dev, importlib.import_module(module),
                           lambda m=module: recorded_run.parser_of(m), argv,
                           iterations=RECORDED_ITERATIONS)
        moved = sorted(k for k, n in res['counts'].items() if n)
        if dev.type == 'cuda' and moved != sorted(RECORDED_KERNELS[name]):
            raise AssertionError(f'phase 17 {name}: counters {moved} moved, '
                                 f'expected {sorted(RECORDED_KERNELS[name])}')
        out[name] = dict(res, module=module)
    return out


# phase 18: the solvation and scaffold runs' sampled heads on the card
# against the CPU port, and one rollout of each replayed on the CPU
REPLAY_REWARD_TOL = 1e-5
REPLAY_POSITION_TOL = 1e-5


def _states_on(states, device):
    import dataclasses
    return dataclasses.replace(states, **{
        f.name: getattr(states, f.name).to(device)
        for f in dataclasses.fields(states)})


def _check_states(got, want, where):
    """Every discrete field of two EnvStates equal, the positions within
    REPLAY_POSITION_TOL."""
    for name in ('elements', 'bag', 'n_atoms', 'formula_cursor',
                 'refill_count'):
        if not torch.equal(getattr(got, name).cpu(),
                           getattr(want, name).cpu()):
            raise AssertionError(f'{where}: {name} differs')
    err = float((got.positions.cpu() - want.positions.cpu()).abs().max())
    if not err <= REPLAY_POSITION_TOL:
        raise AssertionError(f'{where}: positions {err} apart')


def replay_on_cpu(env, agent, start, steps, traj, end):
    """A rollout that `steps` (head_draws.StepRecorder's) recorded on the
    card, stepped again by the CPU port's `env` from the same `start` with
    the element and position each card step was given, and scored by the
    CPU `agent`: the observations, every discrete field of every state and
    which placements were refused equal, positions and rewards within
    1e-5, logp, v and the bootstrap value within MODEL_TOL. Returns the
    largest differences and the cases the rollout went through."""
    from molgym_tpu_torch.spaces import Observation
    states, obs = env.reset(_states_on(start, 'cpu'))
    cases = dict(refills=0, refused=0, hull_refusals=0, resets=0)
    model_err = reward_err = 0.0
    for t, rec in enumerate(steps):
        where = f'replay step {t}'
        want = Observation(traj.obs.elements[t], traj.obs.positions[t],
                           traj.obs.bag[t])
        if not (torch.equal(obs.elements, want.elements.cpu())
                and torch.equal(obs.bag, want.bag.cpu())):
            raise AssertionError(f'{where}: observation differs')
        with torch.no_grad():
            logp, _ent, v = agent.evaluate(obs, traj.actions[t].cpu())
        model_err = max(model_err,
                        float((logp - traj.logps[t].cpu()).abs().max()),
                        float((v - traj.values[t].cpu()).abs().max()))
        element, position = rec['element'].cpu(), rec['position'].cpu()
        valid = env.reward_inputs(states, element.long(), position)[1]
        if not torch.equal(valid, rec['valid'].cpu()):
            raise AssertionError(f'{where}: refused placements differ')
        result = env.step(states, element, position)
        reward_err = max(reward_err, float(
            (result.reward - traj.rewards[t].cpu()).abs().max()))
        if not torch.equal(result.done, traj.terminals[t].cpu()):
            raise AssertionError(f'{where}: terminals differ')
        _check_states(result.state, rec['state'], where)
        cases['refills'] += int((result.state.refill_count
                                 > states.refill_count).sum())
        cases['refused'] += int((~valid).sum())
        if env.hull_a is not None:
            outside = ((position @ env.hull_a.T + env.hull_b) > 1e-6).any(-1)
            cases['hull_refusals'] += int((~valid & outside).sum())
        cases['resets'] += int(result.done.sum())
        states, obs = env.reset_if_terminal(result.state, result.done)
        _check_states(states, rec['reset'], f'{where}: auto-reset')
    _check_states(states, end, 'replay: the final states')
    with torch.no_grad():
        v = agent.evaluate(obs, torch.zeros_like(traj.actions[0].cpu()))[2]
    model_err = max(model_err, float(
        (v - traj.bootstrap_value.cpu()).abs().max()))
    if not reward_err <= REPLAY_REWARD_TOL:
        raise AssertionError(f'replay: rewards {reward_err} apart')
    if not model_err <= MODEL_TOL:
        raise AssertionError(f'replay: logp / v {model_err} apart')
    return dict(steps=len(steps), model_err=model_err,
                reward_err=reward_err, **cases)


def run_sampled_heads(dev):
    """Phase 18: for the solvation and scaffold runs (head_draws.FAMILIES)
    at their recorded configurations, (ii) one rollout on `dev` at random
    weights from a seed, with exact launch counts, replayed on the CPU
    (replay_on_cpu); (i) at the trained weights (head_draws.trained_state),
    draws_per_observation sampled actions at each of the family's
    observations of that rollout on `dev` (the fused head's sample mode on
    the card's uniforms, the continuous heads on its normals), CHUNK rows an
    `act`, with exact launch counts, and as many on the CPU; each set
    against the distributions the CPU port's head_distributions gives at
    its actions, and the two sets against each other
    (sampling_checks.check_draws and compare_draws), every p-value at or
    above P_MIN. Returns each family's numbers."""
    from molgym_tpu_torch.ops.kernel_common import (launch_counts,
                                                    reset_launch_counts)
    from molgym_tpu_torch.rl.rollout import make_rollout_fn
    from molgym_tpu_torch.spaces import ObservationSpace, symbols_to_zs
    from molgym_tpu_torch.tools import head_draws, sampling_checks
    from molgym_tpu_torch.tools.model_util import build_model

    out = {}
    for name, spec in head_draws.FAMILIES.items():
        _module, config = head_draws.recorded_config(name)
        space = ObservationSpace(config['canvas_size'],
                                 symbols_to_zs(config['symbols']))
        env = head_draws.family_env(name, config, dev)
        cpu_env = head_draws.family_env(name, config, 'cpu')
        num_envs = config['num_envs']
        steps = config['num_steps_per_iter'] // num_envs
        torch.manual_seed(SEED + 7)
        cpu_agent = build_model(config, space, device='cpu')
        agent = build_model(config, space, device=dev)
        agent.load_state_dict(cpu_agent.state_dict())

        recorder = head_draws.StepRecorder(env)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        start = env.init_states(num_envs, gen)
        _sync(dev)
        reset_launch_counts()
        end, traj = make_rollout_fn(env, agent, steps)(agent, start, gen)
        _sync(dev)
        rollout_counts = dict(launch_counts)
        expected = expected_launches(per_forward_launches(agent), steps + 1,
                                     0)
        if dev.type == 'cuda' and rollout_counts != expected:
            raise AssertionError(f'phase 18 {name} rollout: launches '
                                 f'{rollout_counts}, expected {expected}')
        replay = replay_on_cpu(cpu_env, cpu_agent, start, recorder.take(),
                               traj, end)

        state = head_draws.trained_state(name)
        agent.load_state_dict(state)
        cpu_agent.load_state_dict(state)
        rows, ids = head_draws.repeat_rows(
            head_draws.select_observations(name, traj.obs),
            spec['draws_per_observation'])
        rows = rows.map(lambda x: x.cpu())
        _sync(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        card = head_draws.draw_actions(
            agent, rows, torch.Generator(device=dev).manual_seed(SEED + 1))
        _sync(dev)
        draw_seconds = time.perf_counter() - t0
        draw_counts = dict(launch_counts)
        acts = -(-len(ids) // head_draws.CHUNK)
        expected = expected_launches(per_forward_launches(agent), acts, 0)
        if dev.type == 'cuda' and draw_counts != expected:
            raise AssertionError(f'phase 18 {name} draws: launches '
                                 f'{draw_counts}, expected {expected}')
        cpu = head_draws.draw_actions(cpu_agent, rows,
                                      torch.Generator().manual_seed(SEED + 1))
        card_heads = head_draws.head_distributions(cpu_agent, rows, card)
        cpu_heads = head_draws.head_distributions(cpu_agent, rows, cpu)
        p_values = dict(
            card=sampling_checks.check_draws(card, ids, card_heads),
            cpu=sampling_checks.check_draws(cpu, ids, cpu_heads),
            card_vs_cpu=sampling_checks.compare_draws(
                card, card_heads, cpu, cpu_heads, ids, ids))
        failed = {k: sampling_checks.failures(p) for k, p in p_values.items()
                  if sampling_checks.failures(p)}
        if failed:
            raise AssertionError(f'phase 18 {name}: draws below P_MIN '
                                 f'{sampling_checks.P_MIN}: {failed}')
        out[name] = dict(replay=replay, rollout_counts=rollout_counts,
                         draws=len(ids), acts=acts, draw_counts=draw_counts,
                         draw_seconds=draw_seconds,
                         min_p={k: min(p.values())
                                for k, p in p_values.items()},
                         p_values=p_values)
    return out


# phase 19: the solvation record's internal agent at the TPU's default
# matmul precision (molgym_tpu_torch/tools/tpu_precision.py), the card
# against the CPU, both emulating, at full width. A sample whose
# intermediate lies within an f32 ulp or two of a bf16 rounding boundary
# rounds apart on the two, and the difference grows through its later
# roundings to the size of the f32-to-bf16 one: the bulk of the samples is
# held (tests/test_torch_tpu_precision.py's measure; at this width the CPU
# port against the interpreted JAX package keeps 0.63-1.0 of them)
PRECISION_BULK_TOL = 1e-5   # of the quantity's RMS, of a gradient's norm
PRECISION_BULK = 0.5        # the samples within it, card against CPU
PRECISION_NONE = 0.1        # the f32 card's samples within it, at most
PRECISION_GRAD_SAMPLES = 32
PRECISION_ITERATIONS = 2


def _precision_outputs(agent, loss_fn, data, emulate):
    """`evaluate`'s (logp, ent, v) at every row of `data` and the first
    PRECISION_GRAD_SAMPLES rows' loss gradients, one sample a loss
    (flattened, the agent's parameter order), all on the CPU, under
    tpu_default_precision where `emulate`."""
    from molgym_tpu_torch.tools.tpu_precision import tpu_default_precision
    device = next(agent.parameters()).device
    data = {k: v.map(lambda x: x.to(device)) if k == 'obs' else v.to(device)
            for k, v in data.items()}
    with (tpu_default_precision() if emulate else contextlib.nullcontext()):
        with torch.no_grad():
            evaluated = [x.cpu().double() for x in agent.evaluate(
                data['obs'], data['act'])]
        grads = []
        for i in range(PRECISION_GRAD_SAMPLES):
            agent.zero_grad(set_to_none=True)
            rows = slice(i, i + 1)
            loss, _info = loss_fn(
                data['obs'].map(lambda x: x[rows]), data['act'][rows],
                data['logp'][rows], data['adv'][rows], data['ret'][rows],
                torch.ones(1, device=device))
            loss.backward()
            grads.append(torch.cat([p.grad.reshape(-1) for p in
                                    agent.parameters()]).cpu().double())
    agent.zero_grad(set_to_none=True)
    return evaluated, grads


def precision_agreement(got, want):
    """name -> (the share of samples within PRECISION_BULK_TOL, the largest
    difference): evaluate's logp, ent and v, each of its RMS over the
    samples, and each sample's gradient, of its norm."""
    out = {}
    for name, g, w in zip(('logp', 'ent', 'v'), got[0], want[0]):
        err = (g - w).abs() / w.square().mean().sqrt()
        out[name] = ((err <= PRECISION_BULK_TOL).double().mean().item(),
                     err.max().item())
    err = torch.stack([(g - w).norm() / w.norm()
                       for g, w in zip(got[1], want[1])])
    out['grad'] = ((err <= PRECISION_BULK_TOL).double().mean().item(),
                   err.max().item())
    return out


def run_precision(dev):
    """Phase 19: (i) a rollout of the solvation record's agent at full width
    on `dev` at random weights from a seed (f32), then `evaluate` at its 140
    rows and PRECISION_GRAD_SAMPLES samples' loss gradients under the
    emulation on `dev` and on the CPU: at least PRECISION_BULK of the
    samples within PRECISION_BULK_TOL in each, all finite; the same on `dev`
    outside the emulation at most PRECISION_NONE within it (logp, v and the
    gradients; teeth). (ii) PRECISION_ITERATIONS iterations of the record's
    command through the tool (tpu_precision.emulated_argv and run) with
    run_training's checks (records, a model that loads back equal, exact
    launch counts: the fused head's alone on the card), its tag marked,
    rounded products and focus rows counted in the run."""
    import types

    from molgym_tpu_torch.rl import buffer, ppo
    from molgym_tpu_torch.rl.rollout import make_rollout_fn
    from molgym_tpu_torch.spaces import ObservationSpace, symbols_to_zs
    from molgym_tpu_torch.tools import head_draws, recorded_run
    from molgym_tpu_torch.tools import tpu_precision as tp
    from molgym_tpu_torch.tools.driver import ppo_config_from
    from molgym_tpu_torch.tools.model_util import build_model

    t0 = time.perf_counter()
    _module, config = head_draws.recorded_config('solvation')
    space = ObservationSpace(config['canvas_size'],
                             symbols_to_zs(config['symbols']))
    env = head_draws.family_env('solvation', config, dev)
    num_envs = config['num_envs']
    torch.manual_seed(SEED + 9)
    cpu_agent = build_model(config, space, device='cpu')
    agent = build_model(config, space, device=dev)
    agent.load_state_dict(cpu_agent.state_dict())
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    _end, traj = make_rollout_fn(
        env, agent, config['num_steps_per_iter'] // num_envs)(
            agent, env.init_states(num_envs, gen), gen)
    ppo_config = ppo_config_from(config)
    data = buffer.compute_ppo_data(traj, ppo_config.gamma, ppo_config.lam)
    outputs = {
        name: _precision_outputs(a, ppo.make_loss_fn(a, ppo_config), data,
                                 emulate)
        for name, a, emulate in (('card', agent, True),
                                 ('cpu', cpu_agent, True),
                                 ('card_f32', agent, False))}
    for name, (evaluated, grads) in outputs.items():
        if not all(torch.isfinite(x).all() for x in evaluated + grads):
            raise AssertionError(f'phase 19: non-finite outputs on {name}')
    agreement = precision_agreement(outputs['card'], outputs['cpu'])
    teeth = precision_agreement(outputs['card_f32'], outputs['cpu'])
    short = {k: v for k, v in agreement.items() if v[0] < PRECISION_BULK}
    if short:
        raise AssertionError(f'phase 19: the card under the emulation '
                             f'against the CPU, {short} of the samples '
                             f'within {PRECISION_BULK_TOL}: {agreement}')
    alike = {k: teeth[k] for k in ('logp', 'v', 'grad')
             if teeth[k][0] > PRECISION_NONE}
    if alike:
        raise AssertionError(f'phase 19: the f32 card agrees with the '
                             f'emulated CPU in {alike}: {teeth}')
    checks_seconds = time.perf_counter() - t0

    record = RECORDED['solvation']
    samples = config['num_steps_per_iter']
    module, argv = tp.emulated_argv(record, [
        f'--num_steps={PRECISION_ITERATIONS * samples}',
        '--log_level=WARNING'])
    before = dict(tp.product_counts)
    res = run_training(dev, types.SimpleNamespace(
        main=lambda a: tp.run(module, a)),
        lambda: recorded_run.parser_of(module), argv,
        iterations=PRECISION_ITERATIONS,
        inspect=lambda cfg, tag: dict(tag=tag))
    products = {k: n - before.get(k, 0) for k, n in tp.product_counts.items()
                if n != before.get(k, 0)}
    if not res['tag'].startswith('solv' + tp.TAG_SUFFIX):
        raise AssertionError(f'phase 19: the run\'s tag {res["tag"]}')
    if not products.get('linear') or not products.get('focus'):
        raise AssertionError(f'phase 19: rounded products {products}')
    moved = sorted(k for k, n in res['counts'].items() if n)
    if dev.type == 'cuda' and moved != sorted(_HEADS):
        raise AssertionError(f'phase 19: counters {moved} moved, expected '
                             f'{sorted(_HEADS)}')
    return dict(res, module=module, agreement=agreement, f32=teeth,
                products=products, checks_seconds=checks_seconds,
                rows=int(data['act'].shape[0]))


# phase 14: the JAX package's trained checkpoints of thirteen experiments,
# loaded through ModelIO.load from their experiments/ orbax paths (read from
# the committed archives of molgym_tpu_torch/checkpoints): experiment ->
# its run's tag, the CPU port's greedy mean over TRAINED_ENVS envs (the
# protocol of tests/test_torch_driver_checkpoints.py, which gives the
# value that `test` measures; `experiment` where the name is not the
# experiment's) and `gate`, that test's tolerance on it: an
# internal agent's greedy act draws nothing; a covariant agent's greedy
# distance is the best of 128 draws, which the card makes from another
# generator than the CPU. `recorded_gate` bounds the distance to the run's
# last recorded eval (the nearer formula's mean where that eval played one
# formula's episode).
_CKPT_TEST = 'tests/test_torch_checkpoint.py'
_HOST_TEST = 'tests/test_torch_host_rollout.py'
_DRIVER_TEST = 'tests/test_torch_driver_checkpoints.py'
TRAINED = {
    'stochastic': dict(tag='stoch_run-1', cpu=1.2443466, gate=0.02,
                       recorded_gate=0.02, test=_CKPT_TEST),
    'sf6_bf16': dict(tag='sf6bf16_run-1', cpu=1.5432367, gate=0.05,
                     recorded_gate=0.05, test=_CKPT_TEST),
    'sf6_pm6': dict(tag='sf6pm6_run-1', cpu=0.6829187, gate=5e-4,
                    recorded_gate=5e-4, test=_HOST_TEST),
    'sf6_internal': dict(tag='sf6int_run-1', cpu=0.9733276, gate=1e-4,
                         recorded_gate=0.01, test=_CKPT_TEST),
    'sf6_internal_pm6': dict(tag='sf6int_pm6_run-1', cpu=0.6664897,
                             gate=1e-4, recorded_gate=5e-4, test=_HOST_TEST),
    'solvation': dict(tag='solv_run-1', cpu=0.8467106, gate=1e-4,
                      recorded_gate=0.01, test=_DRIVER_TEST),
    'scaffold_pm6': dict(tag='scafpm6_run-1', cpu=0.5257388, gate=1e-4,
                         recorded_gate=0.01, test=_DRIVER_TEST),
    'qm9_pm6': dict(tag='qm9pm6_run-1', cpu=0.4011654, gate=0.005,
                    recorded_gate=0.005, test=_DRIVER_TEST),
    'organics': dict(tag='organics_run-1', cpu=1.0234561, gate=0.02,
                     recorded_gate=0.02, test=_DRIVER_TEST),
    'halides_pm6': dict(tag='halo_run-1', cpu=0.5729221, gate=1e-3,
                        recorded_gate=1e-3, test=_DRIVER_TEST),
    # the PM6 families' recorded evals of solvation_pm6 and stochastic_pm6
    # came from the round-3 PM6 constants, which the C++ no longer holds:
    # `recorded_gate` is their measured distance, rounded up. organics_pm6:
    # C2H2O2's greedy episode ends in one of two modes as the best draw
    # falls, each env's change of mode moving the mean by 0.0336, so the
    # mean may move by all eight's (`gate`) and each episode is held within
    # `modes_gate` of one of its formula's `modes` (the CPU port's; the
    # good mode's episodes spread over 0.472-0.489 on the CPU and the
    # card); its recorded eval played one episode of each formula, which
    # some two of the card's episodes give (`recorded_pairs`)
    'organics_pm6': dict(tag='orgpm6_run-1', cpu=0.5642886, gate=0.27,
                         modes=((0.8556, ), (0.4746, -0.0630)),
                         modes_gate=0.03, recorded_gate=0.005,
                         recorded_pairs=True, test=_DRIVER_TEST),
    'solvation_pm6': dict(tag='solvpm6_run-1', cpu=0.8247942, gate=1e-4,
                          recorded_gate=0.15, test=_DRIVER_TEST),
    'stochastic_pm6': dict(tag='stochpm6_run-1', cpu=0.656253, gate=0.015,
                           recorded_gate=0.08, test=_DRIVER_TEST),
    # every greedy episode ends at its third action (the reference's
    # greedy-mode pathology): diagnosed below, DIAGNOSED
    'stochastic_pm6-run-2': dict(experiment='stochastic_pm6',
                                 tag='stochpm6_run-2', cpu=-0.2569615,
                                 gate=0.005, recorded_gate=0.06,
                                 test=_DRIVER_TEST),
}
# 14c: molgym_tpu_torch.tools.diagnose_greedy of stochpm6_run-2 on the card,
# beside the CPU port's (tests/test_torch_diagnose_greedy.py,
# tests/test_torch_driver_checkpoints.py): every greedy episode 3 steps
# long, its last action an O within `contact` A of another atom (CPU
# 0.0747-0.0784), refused; the sampled policy places every atom in some of
# its episodes
DIAGNOSED = dict(run='stochastic_pm6-run-2', length=3, contact=0.1,
                 cpu_contacts=(0.0747, 0.0784), sampled=16)
TRAINED_ENVS = 8
TRAINED_SEED = 1
# 14b: experiments/sf6_pm6/logs/sf6pm6_run-1.json resumed from its 15,120
# steps for 2 iterations, with the pipelined host loop
SF6_PM6_RESUME = [a for a in SF6_PM6 if not a.startswith('--num_steps=')] + [
    '--num_steps=15400']


def trained_checkpoint(name):
    """The experiments/ orbax path of TRAINED[name]'s checkpoint."""
    import glob
    run = TRAINED[name]
    paths = glob.glob(os.path.join(EXPERIMENTS, run.get('experiment', name),
                                   'models', run['tag'] + '_steps-*.model'))
    if len(paths) != 1:
        raise AssertionError(f'{name}: checkpoints {paths}')
    return paths[0]


def episode_returns(rewards, terminals, k):
    """[B, k] returns of each env's first k episodes."""
    episode = np.cumsum(terminals, axis=0) - terminals   # episode of a step
    if not (terminals.sum(axis=0) >= k).all():
        raise AssertionError(f'an env ended fewer than {k} episodes')
    return np.stack([(rewards * (episode == i)).sum(axis=0)
                     for i in range(k)], axis=1)


def trained_setup(dev, experiment):
    """(orbax path, recorded configuration, solvation, host calculator or
    None, evaluation env, agent, steps, load ms, evaluation formulas) of
    TRAINED[experiment]: the env (the driver's builder's evaluation env),
    reward (make_reward_fn, the solvation penalty included) and agent from
    the recorded configuration, the weights through ModelIO.load of the
    orbax path."""
    from molgym_tpu_torch.spaces import ObservationSpace, symbols_to_zs
    from molgym_tpu_torch.tools.diagnose_greedy import env_builder, run_config
    from molgym_tpu_torch.tools.driver import make_reward_fn
    from molgym_tpu_torch.tools.model_io import ModelIO
    from molgym_tpu_torch.tools.model_util import build_model

    path = trained_checkpoint(experiment)
    config = run_config(path)
    builder, solvation = env_builder(config)
    space = ObservationSpace(config['canvas_size'],
                             symbols_to_zs(config['symbols']))
    reward_fn, host_calc = make_reward_fn(config, solvation=solvation)
    _train_env, env = builder(config, space, reward_fn, dev)
    agent = build_model(config, space, device=dev)
    t0 = time.perf_counter()
    state, steps = ModelIO(os.path.dirname(path),
                           TRAINED[experiment]['tag']).load(
        path, dev, family=config['model'], template=agent.state_dict())
    agent.load_state_dict(state['model'])
    load_ms = (time.perf_counter() - t0) * 1e3
    formulas = (config.get('eval_formulas') or config['formulas']).split(',')
    return (path, config, solvation, host_calc, env, agent, steps, load_ms,
            formulas)


def evaluate_trained(dev, experiment):
    """14a for one run: its env (the driver's builder's evaluation env),
    reward (make_reward_fn, the solvation penalty included) and agent from
    the recorded configuration, the weights through ModelIO.load of the
    orbax path; TRAINED_ENVS envs play as many greedy episodes as the run
    has formulas, with the launch counts zeroed just before and read just
    after (exact: the rollout's forwards); the mean return within `gate`
    of the CPU port's and `recorded_gate` of the recorded eval, and each
    episode within `modes_gate` of one of its formula's `modes` where the
    run has them; then one gradient pass of log-prob, entropy and value
    over the trajectory, its launch counts exact and its gradients finite;
    with a host reward, a sampled rollout of the recorded run's envs and
    steps through each transport, from generators of their own (other
    draws: the energy cache meets new geometries), timed with the host
    reward's share."""
    from molgym_tpu_torch.ops import fused_agg
    from molgym_tpu_torch.rl import rollout as rl
    from molgym_tpu_torch.tools.driver import distance_penalty

    run = TRAINED[experiment]
    (path, config, solvation, host_calc, env, agent, steps, load_ms,
     formulas) = trained_setup(dev, experiment)
    encoder_dtype = config.get('encoder_dtype') or 'float32'
    per_forward = per_forward_launches(agent, encoder_dtype)
    num_steps = len(formulas) * (config['canvas_size'] + 1)
    gen = torch.Generator(device=dev).manual_seed(TRAINED_SEED)
    states = env.init_states(TRAINED_ENVS, gen)
    _sync(dev)
    fused_agg.reset_launch_counts()
    t0 = time.perf_counter()
    _states, traj = rl.make_rollout_fn(env, agent, num_steps,
                                       deterministic=True)(agent, states, gen)
    _sync(dev)
    eval_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(fused_agg.launch_counts)
    returns = episode_returns(traj.rewards.cpu().numpy(),
                              traj.terminals.cpu().numpy(), len(formulas))
    if not np.isfinite(returns).all():
        raise AssertionError(f'{experiment}: non-finite returns')
    mean = float(returns.mean())
    per_formula = [float(m) for m in returns.mean(axis=0)]
    with open(os.path.join(os.path.dirname(os.path.dirname(path)),
                           'results', run['tag'] + '_eval.txt')) as f:
        recorded = json.loads(f.readlines()[-1])['return_mean']
    if run.get('recorded_pairs'):
        recorded_err = float(np.abs((returns[:, None, 0]
                                     + returns[None, :, 1]) / 2
                                    - recorded).min())
    elif config.get('num_eval_episodes') == 1 and len(formulas) > 1:
        recorded_err = min(abs(m - recorded) for m in per_formula)
    else:
        recorded_err = abs(mean - recorded)
    cpu_err = abs(mean - run['cpu']) if run['cpu'] is not None else None
    modes_err = (float(max(min(abs(r - m) for m in modes)
                           for f, modes in enumerate(run['modes'])
                           for r in returns[:, f]))
                 if 'modes' in run else 0.0)
    if ((cpu_err is not None and not cpu_err <= run['gate'])
            or not recorded_err <= run['recorded_gate']
            or not modes_err <= run.get('modes_gate', 0.0)):
        raise AssertionError(
            f'{experiment}: greedy mean {mean} against the CPU port\'s '
            f'{run["cpu"]} (gate {run["gate"]}) and the recorded {recorded} '
            f'(gate {run["recorded_gate"]}, off by {recorded_err}); an '
            f'episode {modes_err} from its formula\'s modes; returns '
            f'{returns.tolist()}')

    # one gradient pass at the trained weights over the trajectory
    obs = traj.obs.map(lambda x: x.flatten(0, 1))
    actions = traj.actions.flatten(0, 1)
    agent.zero_grad(set_to_none=True)
    _sync(dev)
    fused_agg.reset_launch_counts()
    logp, ent, value = agent.evaluate(obs, actions)
    (logp.sum() + ent.sum() + value.sum()).backward()
    _sync(dev)
    grad_counts = dict(fused_agg.launch_counts)
    bad = [k for k, p in agent.named_parameters()
           if p.grad is not None and not torch.isfinite(p.grad).all()]
    if bad:
        raise AssertionError(f'{experiment}: non-finite gradients {bad}')
    if dev.type == 'cuda':
        for what, got, want in (
                ('greedy rollout', counts,
                 expected_launches(per_forward, num_steps + 1, 0)),
                ('gradient pass', grad_counts,
                 expected_launches(per_forward, 0, 1))):
            if got != want:
                raise AssertionError(f'{experiment} {what}: launches {got}, '
                                     f'expected {want}')
    res = dict(steps=steps, model=config['model'],
               encoder_dtype=encoder_dtype, formulas=formulas,
               envs=TRAINED_ENVS, episodes_per_env=len(formulas),
               mean=mean, per_formula=per_formula, modes_err=modes_err,
               cpu=run['cpu'], cpu_err=cpu_err, gate=run['gate'],
               recorded=recorded, recorded_err=recorded_err, load_ms=load_ms,
               eval_ms=eval_ms,
               mean_episode_atoms=float(
                   (traj.next_obs.elements != 0).sum(-1)[
                       traj.terminals.bool()].float().mean()),
               counts=counts, grad_rows=int(actions.shape[0]),
               grad_counts=grad_counts)
    if host_calc is None:
        return res

    # the recorded run's training rollout at the trained weights, sampled,
    # through both transports
    num_envs = config['num_envs']
    steps_per_env = config['num_steps_per_iter'] // num_envs
    res['transports'] = {}
    for i, (name, fn) in enumerate((
            ('in_step', rl.make_rollout_fn(env, agent, steps_per_env)),
            ('pipelined', rl.make_pipelined_host_rollout_fn(
                env, agent, host_calc, steps_per_env,
                distance_penalty=distance_penalty(config, solvation))))):
        gen = torch.Generator(device=dev).manual_seed(SEED + 20 + i)
        states = env.init_states(num_envs, gen)
        reward_s0, evals0 = host_calc.total_time, host_calc.pool_stats()[0]
        _sync(dev)
        t0 = time.perf_counter()
        _states, traj = fn(agent, states, gen)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        if not torch.isfinite(traj.rewards).all():
            raise AssertionError(f'{experiment} {name}: non-finite rewards')
        reward_ms = (host_calc.total_time - reward_s0) * 1e3
        placed = (traj.next_obs.elements != 0).sum(-1).float()
        res['transports'][name] = dict(
            envs=num_envs, steps=steps_per_env, ms=ms, reward_ms=reward_ms,
            reward_share=reward_ms / ms,
            energy_evaluations=host_calc.pool_stats()[0] - evals0,
            recomputes=getattr(fn, 'recomputes', 0),
            mean_canvas_atoms=float(placed.mean()),
            episodes=int(traj.terminals.sum()))
    return res


def diagnose_trained(dev):
    """14c: the greedy and sampled evaluation of DIAGNOSED's run through
    molgym_tpu_torch.tools.diagnose_greedy (TRAINED_ENVS greedy envs, the
    protocol of 14a, and DIAGNOSED['sampled'] sampled ones): every greedy
    episode DIAGNOSED['length'] steps long and ended by a refused action
    closer than DIAGNOSED['contact'] to an atom, the greedy mean within
    the run's gate of the CPU port's, and some sampled episode placing
    every atom."""
    from molgym_tpu_torch.tools import diagnose_greedy
    name = DIAGNOSED['run']
    result = diagnose_greedy.diagnose(
        trained_checkpoint(name), num_sampled=DIAGNOSED['sampled'],
        seed=TRAINED_SEED, device=dev)
    episodes = [e for env_eps in result['greedy']['episodes']
                for e in env_eps]
    lengths = [e['length'] for e in episodes]
    contacts = [e['closest_contact'] for e in episodes]
    ends = [e['steps'][-1] for e in episodes if 'steps' in e]
    if (lengths != [DIAGNOSED['length']] * len(episodes)
            or not max(contacts) < DIAGNOSED['contact']
            or len(ends) != len(episodes)
            or any(end['placed'] or not end['done'] for end in ends)
            or not abs(result['greedy']['mean'] - TRAINED[name]['cpu'])
            <= TRAINED[name]['gate']
            or not result['sampled']['complete_fraction'] > 0):
        raise AssertionError(f'phase 14c: {name} diagnosed as {lengths}, '
                             f'contacts {contacts}, greedy mean '
                             f'{result["greedy"]["mean"]}, sampled '
                             f'{result["sampled"]}')
    return dict(result, lengths=lengths, contacts=contacts,
                cpu_contacts=DIAGNOSED['cpu_contacts'])


def run_trained(dev='cuda', experiments=tuple(TRAINED)):
    """Phase 14: (a) evaluate_trained for each run; then every f32
    kernel's counters moved over the covariant f32 runs, the encoder's
    bf16 ones (and no f32 one of the encoder) over sf6_bf16, and only the
    fused head's over the internal agents; (b) the resume of sf6pm6_run-1
    at 15,400 steps through molgym_tpu_torch.run with the checks of phase
    7 and the optimizer's count continued from the archive's. `dev` cpu
    (a rehearsal) runs (a) with the plain versions and prints each greedy
    mean, the value that fills TRAINED's `cpu`."""
    from molgym_tpu_torch import run
    from molgym_tpu_torch.tools.arg_parser import build_default_argparser
    dev = torch.device(dev)
    t0 = time.perf_counter()
    evals = {name: evaluate_trained(dev, name) for name in experiments}
    seconds_a = time.perf_counter() - t0
    moved = {}
    for name, res in evals.items():
        for k, n in list(res['counts'].items()) + list(
                res['grad_counts'].items()):
            group = (res['model'] if res['model'] != 'covariant'
                     else res['encoder_dtype'])
            moved.setdefault(group, dict.fromkeys(res['counts'], 0))[k] += n
    if dev.type == 'cuda':
        f32 = [k for k in moved['float32'] if not k.endswith('_bf16')]
        idle = [k for k in f32 if not moved['float32'][k]]
        bf16 = moved['bfloat16']
        idle += [k + ' (bf16 run)' for k in bf16 if (bf16[k] == 0) ==
                 (k.endswith('_bf16') or k.startswith(('cg_contract',
                                                       'masked_softmax')))]
        for family in ('internal', 'mlp'):
            idle += [f'{k} ({family})'
                     for k, n in moved.get(family, {}).items()
                     if (n == 0) == k.startswith('masked_softmax')]
        if idle:
            raise AssertionError(f'phase 14: counters {idle} moved not as '
                                 f'expected: {moved}')
    out = dict(evaluations=evals, counts_by_family=moved,
               seconds_evaluations=seconds_a)
    if DIAGNOSED['run'] in experiments:
        t0 = time.perf_counter()
        out['diagnosis'] = diagnose_trained(dev)
        out['seconds_diagnosis'] = time.perf_counter() - t0
    if dev.type == 'cuda' and 'sf6_pm6' in experiments:
        t0 = time.perf_counter()
        out['resume'] = run_training(
            dev, run, build_default_argparser, SF6_PM6_RESUME, iterations=2,
            transport='pipelined',
            load_model=trained_checkpoint('sf6_pm6'))
        out['seconds_resume'] = time.perf_counter() - t0
    return out


# 14d: the nine covariant checkpoints of TRAINED evaluated greedily (14a's
# protocol) with the greedy distance from shared candidates
# (molgym_tpu_torch/tools/shared_draws.py), so that the evaluation is a
# deterministic function of the weights: name -> the CPU port's mean and
# its discrete actions, every env's (focus:element a step, all envs alike),
# both measured by tests/test_torch_shared_draws.py and
# tests/test_torch_shared_draws_pm6.py, which hold them against the JAX
# package. The card holds the actions equal and the mean within
# SHARED_TOL (float order), sf6_bf16 within SHARED_BF16_TOL, the tests'
# bf16 tolerance on a return (bf16 rounds at other places on the card)
SHARED = {
    'stochastic': dict(
        cpu=1.2506981,
        actions='0:3 0:2 1:2 2:1 2:1 2:1 1:1 1:1 1:1 0:3 0:2'),
    'sf6_bf16': dict(
        cpu=1.5290735,
        actions='0:1 0:2 0:2 0:2 0:2 0:2 0:2 0:1'),
    'sf6_pm6': dict(
        cpu=0.6829676,
        actions='0:1 0:2 0:2 0:2 0:2 0:2 0:2 0:1'),
    'qm9_pm6': dict(
        cpu=0.4010152,
        actions=('0:2 0:4 0:1 0:1 0:2 0:5 0:1 0:1 0:1 0:2 0:4 '
                 '0:4 0:1 0:2 0:1 0:3 0:2 0:4 0:1 0:1 0:2 0:5 '
                 '0:1 0:1 0:1 0:2 0:4 0:4 0:1 0:2 0:1 0:3')),
    'organics': dict(
        cpu=1.0227005,
        actions=('0:4 0:4 0:1 0:1 0:2 1:2 0:4 0:1 0:1 0:1 0:2 '
                 '0:3 0:4 0:4 0:1 0:1 0:2 1:2 0:4 0:1 0:1 0:1')),
    'halides_pm6': dict(
        cpu=0.5726286,
        actions=('0:2 0:1 0:1 0:1 0:4 0:2 0:1 0:1 0:1 0:3 0:2 '
                 '0:1 0:1 0:1')),
    'organics_pm6': dict(
        cpu=0.6650000,
        actions=('0:4 0:2 1:2 2:1 2:1 2:4 0:4 0:2 1:1 1:1 1:1 '
                 '1:3 0:4 0:2 1:2 2:1 2:1 2:4 0:4 0:2 1:1 1:1')),
    'stochastic_pm6': dict(
        cpu=0.6540313,
        actions='0:2 0:2 0:3 1:1 0:1 1:1 1:1 1:1 0:1 0:2 0:2'),
    'stochastic_pm6-run-2': dict(
        cpu=-0.2564908,
        actions='0:2 0:2 0:3 0:2 0:2 0:3 0:2 0:2 0:3 0:2 0:2'),
}
SHARED_TOL = 1e-4
SHARED_BF16_TOL = 0.02


def discrete_actions(traj) -> str:
    """The focus and element of every step of a trajectory's env 0, as
    'focus:element' words; every env must have the same."""
    actions = traj.actions[..., :2].round().long().cpu().numpy()
    words = [' '.join(f'{f}:{e}' for f, e in actions[:, b])
             for b in range(actions.shape[1])]
    if len(set(words)) != 1:
        raise AssertionError(f'the envs act differently: {words}')
    return words[0]


def evaluate_shared(dev, name):
    """14d for one run: TRAINED_ENVS envs of its evaluation env play as many
    greedy episodes as it has formulas with the greedy distance from shared
    candidates, the launch counts zeroed just before and read just after
    (exact: the rollout's forwards); the mean and the discrete actions
    against SHARED's (on the card; a CPU rehearsal returns them)."""
    from molgym_tpu_torch.ops import fused_agg
    from molgym_tpu_torch.rl import rollout as rl
    from molgym_tpu_torch.tools.shared_draws import shared_greedy_draws
    (_path, config, _solvation, _calc, env, agent, _steps, _load_ms,
     formulas) = trained_setup(dev, name)
    num_steps = len(formulas) * (config['canvas_size'] + 1)
    gen = torch.Generator(device=dev).manual_seed(TRAINED_SEED)
    states = env.init_states(TRAINED_ENVS, gen)
    _sync(dev)
    fused_agg.reset_launch_counts()
    t0 = time.perf_counter()
    with shared_greedy_draws():
        _states, traj = rl.make_rollout_fn(env, agent, num_steps,
                                           deterministic=True)(
            agent, states, gen)
    _sync(dev)
    eval_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(fused_agg.launch_counts)
    returns = episode_returns(traj.rewards.cpu().numpy(),
                              traj.terminals.cpu().numpy(), len(formulas))
    if not np.isfinite(returns).all():
        raise AssertionError(f'14d {name}: non-finite returns')
    res = dict(mean=float(returns.mean()), actions=discrete_actions(traj),
               eval_ms=eval_ms, counts=counts,
               encoder_dtype=config.get('encoder_dtype') or 'float32')
    if dev.type != 'cuda':
        return res
    want = expected_launches(per_forward_launches(agent, res['encoder_dtype']),
                             num_steps + 1, 0)
    tol = (SHARED_BF16_TOL if res['encoder_dtype'] == 'bfloat16'
           else SHARED_TOL)
    res.update(cpu=SHARED[name]['cpu'], tol=tol,
               cpu_err=abs(res['mean'] - SHARED[name]['cpu']))
    if (counts != want or res['actions'] != SHARED[name]['actions']
            or not res['cpu_err'] <= tol):
        raise AssertionError(
            f'14d {name}: greedy mean {res["mean"]} against the CPU port\'s '
            f'{SHARED[name]["cpu"]} (tolerance {tol}); actions '
            f'{res["actions"]} against {SHARED[name]["actions"]}; launches '
            f'{counts}, expected {want}')
    return res


def run_shared_draws(dev='cuda', names=None):
    """Phase 14d: evaluate_shared for each of SHARED's runs (`names`: all),
    and the seconds it took. `dev` cpu (a rehearsal) returns each mean and
    its actions, the values of SHARED."""
    dev = torch.device(dev)
    t0 = time.perf_counter()
    out = {name: evaluate_shared(dev, name) for name in names or SHARED}
    return dict(evaluations=out, seconds=time.perf_counter() - t0)


def main() -> int:
    if not torch.cuda.is_available():
        log('chip_smoke: no CUDA device is visible')
        return 2
    from molgym_tpu_torch import cuda_build, run, run_stochastic
    from molgym_tpu_torch.tools.arg_parser import build_default_argparser

    card = bench.card_line()
    log('card:', card)
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = cuda_build.build()
    log(f'kernels built in {time.perf_counter() - t0:.1f} s')
    for name, info in built.items():
        log(f'  {name}: {info["seconds"]:.1f} s')
        for line in info['ptxas']:
            log('    ' + line)

    # B = 70: a rank's half of the minibatch of 140 at two data-parallel
    # ranks (phase 13)
    agg = {(B, n): check_aggregate(dev, B, n) for B in (140, 70, 9)
           for n in (1, 5)}
    sq = {tau: check_square(dev, tau) for tau in (10, 12)}
    agg_bwd = {(B, n): check_aggregate_bwd(dev, B, n)
               for B in (140, 70, 9) for n in (1, 5)}
    sq_bwd = {tau: check_square_bwd(dev, tau) for tau in (10, 12)}
    for tau in (10, 12):
        sq[('b70', tau)] = check_square(dev, tau, B=70)
        sq_bwd[('b70', tau)] = check_square_bwd(dev, tau, B=70)
    # the same four kernels at the stochastic configuration's shapes: maxl 3
    # (M = 16), canvas 10, levels 0 and 1, square at tau 10 and 16
    stoch = dict(maxl=3, N=10)
    for n in (1, 4):
        agg[('stoch', n)] = check_aggregate(dev, 140, n, **stoch)
        agg_bwd[('stoch', n)] = check_aggregate_bwd(dev, 140, n, **stoch)
    for tau in (10, 16):
        sq[('stoch', tau)] = check_square(dev, tau, **stoch)
        sq_bwd[('stoch', tau)] = check_square_bwd(dev, tau, **stoch)
    # the QM9 run's covariant agent has 6 elements: its last level's square
    # (forward and backward) meets tau = 24; its aggregates and products
    # have SF6's shapes (tau = 10 hidden channels, 4 channels an element)
    sq[('qm9', 24)] = check_square(dev, 24)
    sq_bwd[('qm9', 24)] = check_square_bwd(dev, 24)
    # the bf16 versions of the same four kernels at the same shapes, B = 140
    # (the forwards also at 10 and 1), within one bf16 ulp of their plain
    # versions on the same bf16 operands
    agg16, agg_bwd16, sq16, sq_bwd16 = {}, {}, {}, {}
    for cfg, levels, taus in (('sf6', (1, 5), (10, 12)),
                              ('stoch', (1, 4), (10, 16))):
        shape = stoch if cfg == 'stoch' else {}
        for n in levels:
            agg16[(cfg, n)] = check_aggregate(dev, 140, n, dtype=BF16, **shape)
            agg_bwd16[(cfg, n)] = check_aggregate_bwd(dev, 140, n, dtype=BF16,
                                                      **shape)
        for tau in taus:
            sq16[(cfg, tau)] = check_square(dev, tau, dtype=BF16, **shape)
            sq_bwd16[(cfg, tau)] = check_square_bwd(dev, tau, dtype=BF16,
                                                    **shape)
    # the mixer's two products at SF6 (140 envs x 4 channels, then 10 envs
    # and one), at the stochastic configuration (M = 16), and 111 rows
    contract = {case: check_contract(dev, *case) for case in (
        ((140, 4), 5, 5, 4), ((140, 4), 1, 5, 4), ((10, 4), 5, 5, 4),
        ((1, 4), 5, 5, 4), ((1, 4), 1, 5, 4), ((140, 4), 4, 4, 3),
        ((140, 4), 1, 4, 3), ((37, 3), 5, 5, 4))}
    # the heads' shapes: SF6 focus [140,7], element [140,3], the
    # stochastic configuration's [140,10] and [140,4], the internal agent's
    # kappa [140,2] and [10,2] (its element head is [140,3]), two shapes
    # past the policy's; then the new paths': the internal agent's focus on
    # a canvas of 12 at the solvation run's 140 and 10 rows and the
    # scaffold run's 128 and 8, its element head there [128,4] and [8,4],
    # and the QM9 agent's element head [140,6] and [10,6]
    softmax = {case: check_head(dev, *case) for case in (
        (140, 7), (140, 3), (140, 10), (140, 4), (140, 2), (10, 2),
        (8192, 128), (33, 200), (140, 12), (10, 12), (128, 12), (8, 12),
        (128, 4), (8, 4), (140, 6), (10, 6))}
    for k, v in (list(agg.items()) + list(sq.items()) +
                 list(agg_bwd.items()) + list(sq_bwd.items()) +
                 list(agg16.items()) + list(sq16.items()) +
                 list(agg_bwd16.items()) + list(sq_bwd16.items())):
        log('parity', k, json.dumps(v))
    for k, v in agg.items():
        if 'resources' in v:
            log('aggregate resources', k, json.dumps(v['resources']))
    for k, v in sq.items():
        log('square resources', k, json.dumps(v['resources']))
    b70 = {'aggregate levels 1-2': (agg[(140, 5)], agg[(70, 5)]),
           'aggregate level 0': (agg[(140, 1)], agg[(70, 1)]),
           'square tau 10': (sq[10], sq[('b70', 10)]),
           'square tau 12': (sq[12], sq[('b70', 12)]),
           'aggregate bwd levels 1-2': (agg_bwd[(140, 5)], agg_bwd[(70, 5)]),
           'aggregate bwd level 0': (agg_bwd[(140, 1)], agg_bwd[(70, 1)]),
           'square bwd tau 10': (sq_bwd[10], sq_bwd[('b70', 10)]),
           'square bwd tau 12': (sq_bwd[12], sq_bwd[('b70', 12)])}
    for k, (full, half) in b70.items():
        log(f'{k}: B=140 {full["ms"]:.5f} ms (bound {full["bound_ms"]:.5f}), '
            f'B=70 {half["ms"]:.5f} ms (bound {half["bound_ms"]:.5f}, plain '
            f'{half["plain_ms"]:.5f}, library {half["library_ms"]:.5f}) on '
            f'{card}')
    for k, (fwd, _bwd) in contract.items():
        if 'resources' in fwd:
            log('product resources', k, json.dumps(fwd['resources']))
    for k, (fwd, bwd) in list(contract.items()) + list(softmax.items()):
        log('parity', k, 'fwd', json.dumps(fwd))
        log('parity', k, 'bwd', json.dumps(bwd))

    main_path = run_main_path(dev)
    log('main path:', json.dumps(main_path))
    log(f'rollout {NUM_ENVS} envs x {NUM_STEPS} steps: '
        f'{main_path["ms_per_step"]:.3f} ms/step, '
        f'{main_path["env_steps_per_s"]:.1f} env-steps/s on {card}')

    agent_grads = check_agent_grads(dev, SF6_AGENT)
    log('agent gradients:', json.dumps(agent_grads))
    log(f'fwd+bwd of the SF6 agent, minibatch 140: '
        f'{agent_grads["fwd_bwd_ms_median"]:.3f} ms (median of 20), '
        f'{agent_grads["launches_per_fwd_bwd"]} launches (before the fused '
        f'head: 2,756) on {card}')

    training = run_training(dev, run, build_default_argparser, CANONICAL,
                            iterations=3)
    log('training:', json.dumps(training))

    stoch_rollout = run_stochastic_rollout(dev)
    log('stochastic rollout:', json.dumps(stoch_rollout))
    stoch_grads = check_agent_grads(dev, STOCH_AGENT)
    log('stochastic agent gradients:', json.dumps(stoch_grads))
    stoch_training = run_training(dev, run_stochastic,
                                  run_stochastic.build_parser, STOCHASTIC,
                                  iterations=2)
    log('stochastic training:', json.dumps(stoch_training))

    # the third path: the SF6 run with the bf16 encoder
    bf16_grads = check_agent_grads(dev, SF6_AGENT, encoder_dtype='bfloat16')
    log('bf16 agent gradients:', json.dumps(bf16_grads))
    log(f'fwd+bwd of the SF6 agent, bf16 encoder, minibatch 140: '
        f'{bf16_grads["fwd_bwd_ms_median"]:.3f} ms (median of 20), '
        f'{bf16_grads["device_busy_ms"]:.3f} ms of device time, '
        f'{bf16_grads["launches_per_fwd_bwd"]} launches on {card}')
    bf16_vs_f32 = compare_bf16_to_f32(dev, SF6_AGENT)
    log('bf16 vs f32 agent:', json.dumps(bf16_vs_f32))
    bf16_training = run_training(dev, run, build_default_argparser,
                                 CANONICAL_BF16, iterations=2)
    log('bf16 training:', json.dumps(bf16_training))

    # the fourth path: SF6 with the PM6 reward on the host
    from molgym_tpu_torch.calculators.native import (METHOD_EHT, METHOD_LJ,
                                                     METHOD_PM6)
    host_lib = build_host_library()
    log('host library:', json.dumps(host_lib))
    pm6 = run_host_transports(dev, METHOD_PM6, 0.0)
    log('pm6 transports:', json.dumps(pm6))
    log(f'pm6 rollout {PM6_ENVS} envs x {NUM_STEPS} steps: ' + ', '.join(
        f'{n} {r["ms"]:.1f} ms (reward {r["reward_ms"]:.1f} ms, '
        f'{r["recomputes"]} recomputes)' for n, r in pm6['transports'].items())
        + f' (in_step on a warm energy cache) on {card}, nproc '
        f'{host_lib["nproc"]}')
    fixup = run_host_transports(dev, METHOD_LJ, 40.0)
    log('lj epsilon 40 transports:', json.dumps(fixup))
    if fixup['transports']['pipelined']['recomputes'] < 1:
        raise AssertionError('the low-reward fix-up did not fire')
    pm6_training = run_training(dev, run, build_default_argparser, SF6_PM6,
                                iterations=2, transport='pipelined')
    log('pm6 training:', json.dumps(pm6_training))

    # phase 10b: SF6 with the EHT reward on the host
    t0 = time.perf_counter()
    eht = run_host_transports(dev, METHOD_EHT, 0.0)
    log('eht transports:', json.dumps(eht))
    eht_training = run_training(dev, run, build_default_argparser, SF6_EHT,
                                iterations=2, transport=PROBES_2)
    log('eht training:', json.dumps(eht_training))
    eht_seconds = time.perf_counter() - t0
    log(f'eht rollout {PM6_ENVS} envs x {NUM_STEPS} steps: ' + ', '.join(
        f'{n} {r["ms"]:.1f} ms (reward {r["reward_ms"]:.1f} ms, '
        f'{r["recomputes"]} recomputes)' for n, r in eht['transports'].items())
        + '; 2 iterations (pipelined, in step) ' + ' / '.join(
            f'{t:.1f}' for t in eht_training['iteration_ms'])
        + ' ms, host reward share of the rollouts ' + ', '.join(
            f'{r / t:.3f}' for r, t in zip(
                [x * 1e3 for x in eht_training['reward_time_s']],
                eht_training['rollout_ms']))
        + f'; phase 10b {eht_seconds:.1f} s on {card}, nproc '
        f'{host_lib["nproc"]}')

    # phase 10c: this host's build of the port's sources against the
    # reference's golden values, the numpy oracle and the EHT anchors
    golden = check_host_golden()
    log('host golden:', json.dumps(golden))
    for reading in golden['readings']:
        log(f'  {reading["what"]}: error {reading["error"]:.3e} (gate '
            f'{reading["gate"]:.0e})')
    for trial in golden['random_molecules']:
        log(f'  random molecule {trial["zs"]}: {trial["outcome"]}'
            + (f', error {trial["error"]:.3e}' if 'error' in trial else ''))
    log(f'phase 10c {golden["seconds"]:.1f} s; the library '
        f'{host_lib["library"]} from {host_lib["sources"]} built in '
        f'{host_lib["seconds"]:.1f} s by {host_lib["compiler"]}, nproc '
        f'{host_lib["nproc"]}, on {card}')

    # phase 10d: the measured transport (--host_reward_mode=auto) over 5
    # iterations of the recorded PM6 run
    t0 = time.perf_counter()
    selector = run_selector(dev)
    log('selector training:', json.dumps(selector))
    log(f'phase 10d: transports {selector["transports"]}, evaluations '
        f'{selector["eval_transports"]}; kept {selector["choice"]!r}, timed '
        'probes ' + ', '.join(f'{n} {ms:.3f} ms' for n, ms in
                              selector['probe_ms'].items())
        + ', recomputes by iteration '
        f'{selector["recomputes_by_iteration"]}; iterations ' + ' / '.join(
            f'{t:.1f}' for t in selector['iteration_ms'])
        + f' ms; {time.perf_counter() - t0:.1f} s on {card}, nproc '
        f'{host_lib["nproc"]}')

    # the fifth path: the internal (SchNet) agent at SF6, and the mlp model
    internal_rollout = run_internal_rollout(dev)
    log('internal rollout:', json.dumps(internal_rollout))
    internal_grads = check_agent_grads(dev, INTERNAL_SF6,
                                       build=make_internal_agent)
    log('internal agent gradients:', json.dumps(internal_grads))
    # three heads a pass, each one forward and one backward; kappa's
    # entropy enters no loss, so its backward gets no entropy gradient
    rows = NUM_ENVS
    want = dict(masked_softmax=3, masked_softmax_bwd=3)
    want_bwd = [[[rows, 7], False, True, True], [[rows, 3], False, True, True],
                [[rows, 2], False, True, False]]
    if (internal_grads['kernel_counts_per_fwd_bwd'] != want
            or sorted(internal_grads['head_backwards'], reverse=True)
            != want_bwd):
        raise AssertionError('internal fwd+bwd: launches '
                             f'{internal_grads["kernel_counts_per_fwd_bwd"]}, '
                             f'head backwards {internal_grads["head_backwards"]}')
    log(f'SF6 internal agent: act {internal_rollout["phases"]["act_ms"]:.3f} '
        f'ms at {NUM_ENVS} envs, rollout '
        f'{internal_rollout["ms_per_step"]:.3f} ms/step, '
        f'{internal_rollout["profile"]["kernel_launches_per_step"]:.1f} '
        f'launches a step; fwd+bwd {internal_grads["fwd_bwd_ms_median"]:.3f} '
        f'ms (median of 20), {internal_grads["device_busy_ms"]:.3f} ms of '
        f'device time, {internal_grads["launches_per_fwd_bwd"]} launches on '
        f'{card}')
    internal_training = run_training(dev, run, build_default_argparser,
                                     SF6_INTERNAL, iterations=2)
    log('internal training:', json.dumps(internal_training))
    mlp_training = run_training(dev, run, build_default_argparser,
                                HOST_LOOP_MLP, iterations=2,
                                transport=PROBES_2)
    log('mlp training:', json.dumps(mlp_training))

    # the sixth to eighth paths: the solvation, scaffold and QM9 drivers
    from molgym_tpu_torch import run_qm9, run_scaffold, run_solvation
    from molgym_tpu_torch.spaces import ObservationSpace, symbols_to_zs
    from molgym_tpu_torch.tools.driver import standard_envs
    from molgym_tpu_torch.tools.model_util import build_model
    qm9_config = run_qm9.config_from(QM9_PM6)
    new_paths = {}
    for name, config, builder, solvation in (
            ('solvation', vars(run_solvation.build_parser().parse_args(
                SOLVATION)), run_solvation.solvation_envs, True),
            ('scaffold', vars(run_scaffold.build_parser().parse_args(
                SCAFFOLD_PM6)), run_scaffold.scaffold_envs, False),
            ('qm9', qm9_config, standard_envs, False)):
        _traj, _env, res = run_driver_rollout(dev, config, builder, solvation)
        new_paths[name] = res
        log(f'{name} rollout:', json.dumps(res))
    # the QM9 run's covariant agent, as the driver builds it: 6 elements, so
    # the last CG level's square meets tau = 24 (6 x 4 channels)
    qm9_space = ObservationSpace(qm9_config['canvas_size'],
                                 symbols_to_zs(qm9_config['symbols']))
    qm9_grads = check_agent_grads(
        dev, dict(zs=tuple(qm9_space.zs), canvas_size=qm9_space.canvas_size),
        build=lambda d: build_model(qm9_config, qm9_space, device=d))
    log('qm9 agent gradients:', json.dumps(qm9_grads))
    solv_training = run_training(dev, run_solvation,
                                 run_solvation.build_parser, SOLVATION,
                                 iterations=2, inspect=check_refills)
    log('solvation training:', json.dumps(solv_training))
    scaf_training = run_training(dev, run_scaffold, run_scaffold.build_parser,
                                 SCAFFOLD_PM6, iterations=2,
                                 transport='pipelined', inspect=check_hull)
    log('scaffold training:', json.dumps(scaf_training))
    if 'gap' in scaf_training:
        log('scaffold hull check: gap:', scaf_training['gap'])
    qm9_training = run_training(dev, run_qm9, run_qm9.build_parser, QM9_PM6,
                                iterations=2, transport=PROBES_2,
                                inspect=check_formulas)
    log('qm9 training:', json.dumps(qm9_training))
    covariance = run_covariance(dev)
    log('covariance on the card:', json.dumps(covariance))

    # phase 13: data parallelism
    data_parallel = run_data_parallel()
    log('data parallel:', json.dumps(data_parallel))
    w1, w2 = data_parallel['w1'], data_parallel['w2']
    cli = data_parallel['cli']

    def ms(values):
        return ' / '.join(f'{t:.1f}' for t in values)
    log(f'data parallel, 2 SF6 iterations: W=1 NCCL ms '
        f'{ms(w1["mesh_iteration_ms"])} (plain batch_ppo '
        f'{ms(w1["plain_iteration_ms"])}); timed without evaluation or '
        f'writes: W=1 NCCL {ms(w1["timed_ms"])} ms, env-steps/s '
        f'{ms(w1["env_steps_per_s"])}; W=2 gloo on one card: rank 0 '
        f'{ms(w2["timed_ms"][0])} ms, rank 1 {ms(w2["timed_ms"][1])} ms, '
        f'both ranks together {ms(w2["env_steps_per_s"])} env-steps/s, '
        f'{" / ".join(f"{r:.3f}" for r in w2["ratio_to_w1"])} x W=1; '
        f'reduced gradient {w2["grad_err"]:.3g} of a leaf\'s max |g| from '
        f'one process ({w2["grad_err_same_chunks"]:.3g} from the same '
        f'chunks); molgym_tpu_torch.run --multihost (one NCCL rank) '
        f'{ms(cli["multihost"]["iteration_ms"])} ms, one process '
        f'{ms(cli["single"]["iteration_ms"])} ms, the same bits, on {card}')
    for name, trained in (('solvation', solv_training),
                          ('scaffold', scaf_training), ('qm9', qm9_training)):
        res = new_paths[name]
        log(f'{name} path: act {res["phases"]["act_ms"]:.3f} ms at '
            f'{res["num_envs"]} envs, rollout {res["ms_per_step"]:.3f} ms a '
            f'step, {res["profile"]["kernel_launches_per_step"]:.1f} launches '
            f'a step, idle {res["profile"]["device_idle_share"]:.3f}; '
            'iterations ' + ' / '.join(f'{t:.1f}'
                                       for t in trained['iteration_ms'])
            + f' ms on {card}')
    log(f'QM9 fwd+bwd {qm9_grads["fwd_bwd_ms_median"]:.3f} ms (median of '
        f'20), {qm9_grads["launches_per_fwd_bwd"]} launches; covariance on '
        'the card: max err ' + ', '.join(
            f'{k} {v["max_err"]:.3g}' for k, v in covariance.items())
        + f' on {card}')

    # phase 14: the JAX package's trained checkpoints on the card
    trained = run_trained()
    log('trained checkpoints:', json.dumps(trained))
    for name, res in trained['evaluations'].items():
        log(f'{name} ({res["model"]}, {res["encoder_dtype"]}, '
            f'{res["steps"]} steps): greedy mean {res["mean"]:.6f} over '
            f'{res["envs"]} envs x {res["episodes_per_env"]} episodes (CPU '
            f'port {res["cpu"]}, off by {res["cpu_err"]:.3g}, gate '
            f'{res["gate"]}; recorded {res["recorded"]:.6f}, off by '
            f'{res["recorded_err"]:.3g}), {res["mean_episode_atoms"]:.2f} '
            f'atoms an episode, load {res["load_ms"]:.1f} ms, evaluation '
            f'{res["eval_ms"]:.1f} ms on {card}')
        for tname, t in res.get('transports', {}).items():
            log(f'  {tname}, sampled, {t["envs"]} envs x {t["steps"]} steps: '
                f'{t["ms"]:.1f} ms, host reward {t["reward_ms"]:.1f} ms '
                f'({t["reward_share"]:.3f}), {t["energy_evaluations"]} '
                f'energy evaluations, {t["mean_canvas_atoms"]:.2f} atoms a '
                f'canvas, {t["recomputes"]} recomputes, on {card}, nproc '
                f'{host_lib["nproc"]}')
    diagnosis = trained['diagnosis']
    log(f'{DIAGNOSED["run"]} diagnosed: greedy lengths '
        f'{diagnosis["lengths"]}, closest contacts '
        + ', '.join(f'{c:.4f}' for c in diagnosis['contacts'])
        + f' A (CPU {diagnosis["cpu_contacts"][0]}-'
        f'{diagnosis["cpu_contacts"][1]}), greedy mean '
        f'{diagnosis["greedy"]["mean"]:.6f}; sampled '
        f'{diagnosis["sampled"]["envs"]}: mean length '
        f'{diagnosis["sampled"]["mean_length"]:.3f}, complete fraction '
        f'{diagnosis["sampled"]["complete_fraction"]:.3f}, mean '
        f'{diagnosis["sampled"]["mean"]:.6f}, best '
        f'{diagnosis["sampled"]["best"]:.6f}; '
        f'{trained["seconds_diagnosis"]:.1f} s on {card}')
    resume = trained['resume']
    log(f'sf6pm6_run-1 resumed at 15,120 steps for 2 iterations: optimizer '
        f'count {resume["start_count"]} -> {resume["count"]}, losses '
        f'{resume["total_loss"]}, iterations '
        + ' / '.join(f'{t:.1f}' for t in resume['iteration_ms'])
        + f' ms; phase 14: {trained["seconds_evaluations"]:.1f} s of '
        f'evaluations, {trained["seconds_resume"]:.1f} s of resume on {card}')

    # phase 14d: the covariant checkpoints' greedy evaluations from shared
    # draws, against the CPU port's
    shared = run_shared_draws()
    log('shared-draw evaluations:', json.dumps(shared))
    for name, res in shared['evaluations'].items():
        log(f'{name} from shared draws: greedy mean {res["mean"]:.7f} (CPU '
            f'port {res["cpu"]:.7f}, off by {res["cpu_err"]:.3g}, tolerance '
            f'{res["tol"]}), every focus and element as on the CPU, '
            f'{res["eval_ms"]:.1f} ms on {card}')
    log(f'phase 14d: {shared["seconds"]:.1f} s on {card}')

    # phase 15: the port's bench, in this process, at small --iters/--reps
    t0 = time.perf_counter()
    bench_record = bench.run(**BENCH_SMOKE)
    bench.check_record(bench_record)
    if bench_record['extra']['device']['name'] != torch.cuda.get_device_name(0):
        raise AssertionError(f'bench: device {bench_record["extra"]["device"]}')
    log('bench record:', json.dumps(bench_record))
    extra = bench_record['extra']
    log(f'phase 15, the bench at {json.dumps(BENCH_SMOKE)}: fwd+bwd '
        f'{bench_record["value"]:.3f} ms (p50 {extra["fwd_bwd_ms_p50"]:.3f}, '
        f'p90 {extra["fwd_bwd_ms_p90"]:.3f}), bf16 {extra["ms_bf16"]:.3f}, '
        f'internal {extra["ms_internal_agent"]:.3f}, B = 2240 '
        f'{extra["ms_batch_2240"]:.3f} / bf16 {extra["ms_bf16_2240"]:.3f} ms; '
        'env-steps/s PM6 pipelined / in step '
        f'{extra["env_steps_per_sec_pm6"]:.1f} / '
        f'{extra["env_steps_per_sec_pm6_serial"]:.1f}, EHT '
        f'{extra["env_steps_per_sec_eht"]:.1f} / '
        f'{extra["env_steps_per_sec_eht_serial"]:.1f}; auto keeps '
        f'{extra["auto_transport_pm6"]} (PM6) and '
        f'{extra["auto_transport_eht"]} (EHT), timed probes '
        f'{json.dumps(extra["auto_transport_probe_ms"])} ms; '
        f'{time.perf_counter() - t0:.1f} s on {card}, nproc {extra["nproc"]}')

    # phase 16: the port's fwd+bwd profiler, in this process
    profiler = run_profiler()
    log('profiler:', json.dumps(profiler))
    sweep = ', '.join(f'B = {r["batch"]} {r["ms"]:.3f} ms (MFU '
                      f'{r["mfu_pct"]:.3f}%, {r["ms_per_140_rows"]:.3f} ms per '
                      '140 rows)' for r in profiler['sweep'])
    log(f'phase 16, the profiler: trace at B = 140 '
        f'{profiler["trace"]["launches_per_step"]:g} launches and '
        f'{profiler["trace"]["device_ms_per_step"]:.3f} device ms a step '
        f'(profile_grad {profiler["profile_grad"]["launches_per_fwd_bwd"]} '
        f'and {profiler["profile_grad"]["device_busy_ms"]:.3f}), idle share '
        f'{profiler["trace"]["idle_share"]:.3f}, grouped by '
        f'{profiler["trace"]["grouped_by"]}; sweep {sweep}; '
        f'{profiler["seconds"]:.1f} s on {card}')

    # phase 17: the four recorded runs with a device reward, 2 iterations
    recorded = run_recorded(dev)
    log('recorded runs:', json.dumps(recorded))
    log('phase 17, ' + '; '.join(
        f'{name} ({r["module"]}): {r["seconds"]:.1f} s, iteration ms '
        f'{" / ".join(f"{t:.1f}" for t in r["iteration_ms"])}, counters '
        f'{", ".join(k for k, n in r["counts"].items() if n)}'
        for name, r in recorded.items()) + f' on {card}')

    # phase 18: the solvation and scaffold runs' sampled heads and rollouts
    sampled = run_sampled_heads(dev)
    log('phase 18, ' + '; '.join(
        f'{name}: rollout replayed on the CPU ({r["replay"]["steps"]} steps, '
        f'refills {r["replay"]["refills"]}, hull refusals '
        f'{r["replay"]["hull_refusals"]}, logp/v within '
        f'{r["replay"]["model_err"]:.2e}, rewards within '
        f'{r["replay"]["reward_err"]:.2e}), {r["draws"]} draws in '
        f'{r["acts"]} acts ({r["draw_seconds"]:.2f} s), least p card '
        f'{r["min_p"]["card"]:.4f}, CPU {r["min_p"]["cpu"]:.4f}, card vs '
        f'CPU {r["min_p"]["card_vs_cpu"]:.4f}'
        for name, r in sampled.items()) + f' on {card}')

    # phase 19: the solvation record at the TPU's default matmul precision
    precision = run_precision(dev)
    log('phase 19, the solvation agent under tpu_default_precision: card '
        'against CPU, the samples within '
        f'{PRECISION_BULK_TOL} (the largest difference) '
        + ', '.join(f'{k} {a:.3f} ({m:.2e})'
                    for k, (a, m) in precision['agreement'].items())
        + '; the f32 card ' + ', '.join(
            f'{k} {a:.3f} ({m:.2e})' for k, (a, m) in precision['f32'].items())
        + f' ({precision["checks_seconds"]:.1f} s); {PRECISION_ITERATIONS} '
        f'iterations of {precision["tag"]}: {precision["seconds"]:.1f} s, '
        'iteration ms '
        + ' / '.join(f'{t:.1f}' for t in precision['iteration_ms'])
        + f', rounded products {json.dumps(precision["products"])}, '
        'counters ' + ', '.join(k for k, n in precision['counts'].items()
                                 if n) + f' on {card}')
    shared_counts = {k: sum(r['counts'][k]
                            for r in shared['evaluations'].values())
                     for k in training['counts']}

    def entry(name, source, replaces, main, others, path=training, **extra):
        """A kernel's line: `launches` from the run of its main path (the
        SF6 training for the f32 kernels, the bf16 SF6 training for the
        bf16 ones), the other paths' counts beside it."""
        return dict(name=name, route='cuda', source=source, replaces=replaces,
                    launches=path['counts'][name],
                    max_abs_err=max(r['max_abs_err'] for r in others),
                    ms=main['ms'], plain_ms=main['plain_ms'],
                    bound_ms=main['bound_ms'], bound_by=main['bound_by'],
                    library_ms=main['library_ms'], at=main['shape'],
                    checked=[r['shape'] for r in others],
                    rollout_launches=main_path['counts'][name],
                    stochastic_rollout_launches=stoch_rollout['counts'][name],
                    stochastic_training_launches=stoch_training['counts'][name],
                    bf16_training_launches=bf16_training['counts'][name],
                    pm6_rollout_launches=pm6['counts'][name],
                    pm6_training_launches=pm6_training['counts'][name],
                    eht_rollout_launches=eht['counts'][name],
                    eht_training_launches=eht_training['counts'][name],
                    internal_rollout_launches=internal_rollout['counts'][name],
                    internal_training_launches=internal_training['counts'][
                        name],
                    mlp_training_launches=mlp_training['counts'][name],
                    solvation_training_launches=solv_training['counts'][name],
                    scaffold_training_launches=scaf_training['counts'][name],
                    qm9_training_launches=qm9_training['counts'][name],
                    trained_launches={
                        family: counts[name] for family, counts in
                        trained['counts_by_family'].items()},
                    resume_launches=resume['counts'][name],
                    shared_draws_launches=shared_counts[name],
                    recorded_training_launches={
                        family: r['counts'][name]
                        for family, r in recorded.items()},
                    sampled_heads_launches={
                        family: r['draw_counts'][name]
                        for family, r in sampled.items()},
                    replayed_rollout_launches={
                        family: r['rollout_counts'][name]
                        for family, r in sampled.items()},
                    precision_training_launches=precision['counts'][name],
                    **extra)

    def entry16(name, source, replaces, main, others, **extra):
        return entry(name + '_bf16', source, replaces, main, others,
                     path=bf16_training, dtype='bfloat16',
                     library='complex64 einsum on the upcast operands',
                     max_ulp_share=max(r['max_ulp_share'] for r in others),
                     **extra)

    def at_b70(res, prefix=''):
        """A kernel's numbers at a data-parallel rank's B = 70."""
        return {f'{prefix}{k}_b70': res[k] for k in ('ms', 'bound_ms',
                                                     'plain_ms', 'library_ms')}

    csrc = 'molgym_tpu_torch/csrc/'
    pallas = 'molgym_tpu/ops/'
    contract_main, softmax_main = contract[((140, 4), 5, 5, 4)], softmax[(140, 7)]
    kernels = [
        entry('cg_aggregate_edge_fused_ri', csrc + 'cg_aggregate.cu',
              pallas + 'pallas_agg.py:334', agg[(140, 5)],
              [r for (_b, n), r in agg.items() if n != 1],
              ms_b10=agg[(140, 5)]['ms_b10'], ms_b1=agg[(140, 5)]['ms_b1'],
              **at_b70(agg[(70, 5)])),
        # the same kernel and launch counter on the dense (ungrouped) table
        # of level 0: what the TPU's row-fallback kernel computes
        entry('cg_aggregate_edge_fused_ri', csrc + 'cg_aggregate.cu',
              pallas + 'pallas_agg.py:91', agg[(140, 1)],
              [r for (_b, n), r in agg.items() if n == 1],
              counter_shared_with=pallas + 'pallas_agg.py:334',
              ms_b10=agg[(140, 1)]['ms_b10'], ms_b1=agg[(140, 1)]['ms_b1'],
              **at_b70(agg[(70, 1)])),
        entry('cg_square_fused_ri', csrc + 'cg_square.cu',
              pallas + 'pallas_agg.py:91', sq[10], list(sq.values()),
              ms_b10=sq[10]['ms_b10'], ms_b1=sq[10]['ms_b1'],
              qm9_tau24_ms=sq[('qm9', 24)]['ms'],
              qm9_tau24_bound_ms=sq[('qm9', 24)]['bound_ms'],
              **at_b70(sq[('b70', 10)])),
        entry('cg_aggregate_edge_fused_ri_bwd', csrc + 'cg_aggregate_bwd.cu',
              pallas + 'pallas_agg.py:392', agg_bwd[(140, 5)],
              list(agg_bwd.values()), **at_b70(agg_bwd[(70, 5)]),
              level0_ms=agg_bwd[(140, 1)]['ms'],
              **at_b70(agg_bwd[(70, 1)], 'level0_')),
        entry('cg_square_fused_ri_bwd', csrc + 'cg_square_bwd.cu',
              pallas + 'pallas_agg.py:132', sq_bwd[10], list(sq_bwd.values()),
              qm9_tau24_ms=sq_bwd[('qm9', 24)]['ms'],
              qm9_tau24_bound_ms=sq_bwd[('qm9', 24)]['bound_ms'],
              **at_b70(sq_bwd[('b70', 10)])),
        entry('cg_contract_ri', csrc + 'cg_product.cu',
              pallas + 'pallas_cg.py:40', contract_main[0],
              [f for f, _b in contract.values()],
              ms_b10=contract[((10, 4), 5, 5, 4)][0]['ms'],
              ms_b1=contract[((1, 4), 5, 5, 4)][0]['ms']),
        entry('cg_contract_ri_bwd', csrc + 'cg_product_bwd.cu',
              pallas + 'pallas_cg.py:60', contract_main[1],
              [b for _f, b in contract.values()]),
        entry('masked_softmax', csrc + 'masked_softmax.cu',
              pallas + 'pallas_softmax.py:29', softmax_main[0],
              [f for f, _b in softmax.values()],
              kappa_ms=softmax[(140, 2)][0]['ms'],
              kappa_ms_b10=softmax[(10, 2)][0]['ms'],
              canvas12_ms=softmax[(140, 12)][0]['ms'],
              qm9_element_ms=softmax[(140, 6)][0]['ms']),
        entry('masked_softmax_bwd', csrc + 'masked_softmax.cu',
              pallas + 'pallas_softmax.py:29', softmax_main[1],
              [b for _f, b in softmax.values()],
              kappa_ms=softmax[(140, 2)][1]['ms'],
              kappa_ms_b10=softmax[(10, 2)][1]['ms'],
              canvas12_ms=softmax[(140, 12)][1]['ms'],
              qm9_element_ms=softmax[(140, 6)][1]['ms']),
        entry16('cg_aggregate_edge_fused_ri', csrc + 'cg_aggregate.cu',
                pallas + 'pallas_agg.py:334', agg16[('sf6', 5)],
                [r for (_c, n), r in agg16.items() if n != 1],
                ms_b10=agg16[('sf6', 5)]['ms_b10'],
                ms_b1=agg16[('sf6', 5)]['ms_b1']),
        entry16('cg_aggregate_edge_fused_ri', csrc + 'cg_aggregate.cu',
                pallas + 'pallas_agg.py:91', agg16[('sf6', 1)],
                [r for (_c, n), r in agg16.items() if n == 1],
                counter_shared_with=pallas + 'pallas_agg.py:334',
                ms_b10=agg16[('sf6', 1)]['ms_b10'],
                ms_b1=agg16[('sf6', 1)]['ms_b1']),
        entry16('cg_square_fused_ri', csrc + 'cg_square.cu',
                pallas + 'pallas_agg.py:91', sq16[('sf6', 10)],
                list(sq16.values()), ms_b10=sq16[('sf6', 10)]['ms_b10'],
                ms_b1=sq16[('sf6', 10)]['ms_b1']),
        entry16('cg_aggregate_edge_fused_ri_bwd', csrc + 'cg_aggregate_bwd.cu',
                pallas + 'pallas_agg.py:392', agg_bwd16[('sf6', 5)],
                list(agg_bwd16.values())),
        entry16('cg_square_fused_ri_bwd', csrc + 'cg_square_bwd.cu',
                pallas + 'pallas_agg.py:132', sq_bwd16[('sf6', 10)],
                list(sq_bwd16.values())),
    ]

    def by_shape(results):
        return {f['shape']: dict(fwd=f, bwd=b) for f, b in results.values()}
    print(json.dumps({'main_path': main_path, 'aggregate_level0': agg[(140, 1)],
                      'square_tau12': sq[12],
                      'aggregate_levels12': agg[(140, 5)],
                      'aggregate_stochastic_level0': agg[('stoch', 1)],
                      'aggregate_stochastic_level1': agg[('stoch', 4)],
                      'aggregate_bwd_level0': agg_bwd[('stoch', 1)],
                      'aggregate_bwd_level0_sf6': agg_bwd[(140, 1)],
                      'aggregate_bwd_levels12': agg_bwd[(140, 5)],
                      'aggregate_bwd_stochastic_level1': agg_bwd[('stoch', 4)],
                      'square_bwd_tau12': sq_bwd[12],
                      'contract': by_shape(contract),
                      'softmax': by_shape(softmax),
                      'agent_grads': agent_grads, 'training': training,
                      'stochastic_rollout': stoch_rollout,
                      'stochastic_agent_grads': stoch_grads,
                      'stochastic_training': stoch_training,
                      'bf16_kernels': {
                          'aggregate': {str(k): v for k, v in agg16.items()},
                          'aggregate_bwd': {str(k): v
                                            for k, v in agg_bwd16.items()},
                          'square': {str(k): v for k, v in sq16.items()},
                          'square_bwd': {str(k): v
                                         for k, v in sq_bwd16.items()}},
                      'bf16_agent_grads': bf16_grads,
                      'bf16_vs_f32': bf16_vs_f32,
                      'bf16_training': bf16_training,
                      'host_library': host_lib, 'pm6_transports': pm6,
                      'lj_fixup_transports': fixup,
                      'pm6_training': pm6_training,
                      'eht_transports': eht, 'eht_training': eht_training,
                      'selector_training': selector,
                      'internal_rollout': internal_rollout,
                      'internal_agent_grads': internal_grads,
                      'internal_training': internal_training,
                      'mlp_training': mlp_training,
                      'square_qm9_tau24': sq[('qm9', 24)],
                      'square_bwd_qm9_tau24': sq_bwd[('qm9', 24)],
                      'new_path_rollouts': new_paths,
                      'qm9_agent_grads': qm9_grads,
                      'solvation_training': solv_training,
                      'scaffold_training': scaf_training,
                      'qm9_training': qm9_training,
                      'covariance': covariance,
                      'b70_kernels': {k: dict(b140=v[0], b70=v[1])
                                      for k, v in b70.items()},
                      'data_parallel': data_parallel,
                      'trained': trained, 'shared_draws': shared,
                      'bench': bench_record, 'profiler': profiler,
                      'recorded': recorded, 'sampled_heads': sampled,
                      'precision': precision}))
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
