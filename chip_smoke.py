#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pointcloud_rl_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py               # all phases, one card
    python3 chip_smoke.py --kernels-only
    python3 chip_smoke.py --only dmc    # the kernel phase, then only the named phases
                                        # (graphs, runs, encoders, conv, modules, dmc, dp, hosts, hosts-nccl,
                                        # replay-io, maniskill, pipeline);
                                        # no result line
    python3 chip_smoke.py --only dp,hosts-nccl --dp-nccl-ranks 4   # on a host of 4 cards

Phases (any failure exits non-zero and prints no result):

1. The card: ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. Build the CUDA kernels from ``pointcloud_rl_torch/csrc`` with nvcc.
   ``cuobjdump -sass`` of the built library: the count of ``HGMMA`` (and
   ``HMMA``) instructions in each kernel; the body kernels of both entry
   points must hold ``HGMMA`` (the tensor cores' warpgroup products).
3. Each kernel against its plain PyTorch version on the same inputs, at the
   training slices' encoder shapes (SAC f32, DrQ f32 and bf16, the
   recurrent target's 64 x 9 windows in f32; the recurrent critic's 64 x 8
   rows are DrQ's 512; a data-parallel rank's 128 rows of SAC's 256 at 2
   ranks, 64 at 4), the act encode's (4 env workers, f32 and bf16),
   the walker encoder's (f32 and bf16), the walker act's (16 env
   workers, bf16), the DrQ walker recipe's update encodes (512 rows, bf16)
   and the ManiSkill configs' 9-channel clouds (SAC's 256 rows, DrQ's 512,
   the act's 4, f32), each 4-row act shape also at 2 rows (the pipelined
   rollout acts on 4 env workers as 2 groups of 2), then at edge shapes (one
   batch row, one point, ragged tails, widths that are no multiple of 16):
   pooled values, winner indices (the kernel's winner must attain the plain
   max), bitwise-equal repeated calls, a cloud of three copies of the same
   points in different chunks (the winners must equal the plain first-index
   argmax exactly), gradients of ``FusedPointNetBody`` against autograd
   through the plain body, and ms per call of kernel and plain version
   beside the least time the card could take (``bound_ms``).  The winner
   backward (``pointnet_fused_bwd``) against the plain ``_winner_backward``
   with TF32 off at every training shape of the main path (``BWD_SHAPES``):
   the ten parameter gradients within ``BWD_TOL``, repeat calls bitwise
   equal, ms per call beside its f32 FFMA bound; its kernels must hold no
   tensor-core instruction.  Every training run below must launch it, and
   no evaluation.
3b. The update programs as CUDA graphs (``graphs``), in this process,
   each against the eager step it captures, bitwise, from one state (two
   agents, the eager twin loaded from the graphed one): (1) the walker
   recipe ``pn_walker_tpu.py`` at full width (bf16, batch 256) over its
   packed ``DeviceReplayMemory`` of 100000 filled with 4096 seeded
   transitions, rounds of ``update_parameters_scan`` of 16, 3, 16, 3
   updates (the interval-2 gates' phases 0, 0, 1, 1): round 0 runs each
   program eagerly, round 1 captures and replays, 2048 more transitions
   are pushed, round 2 replays; after every scan the parameters, target,
   optimizer state, ``log_alpha``, update counter, the agent's and the
   replay's generators and the summed metric vector must be bitwise the
   eager twin's; (2) the same for the DrQ walker recipe
   ``pn_shift_tpu.py`` (512 rows, its shift drawn inside the graph);
   (3) the SAC slice (f32, 256 x 1200 x 8) on host batches through
   ``update_parameters_lazy`` (the one-update program, the batch copied
   into its static inputs), 8 updates; the walker's act-fused forwards
   (``set_fused_updates``: 16 updates then the explore act on 16 envs in
   one program) against 16 eager updates then the eager act, actions
   bitwise; one replay of the 16-update program under ``torch.profiler``:
   the body kernels in its trace must equal the launches it adds to
   ``launch_counts``.  Per update, eager and graphed: host ms until the
   call returns, ms until the card is done, device busy ms and the idle
   share; capture ms per program and the memory its pool reserved.
4. The slices through the CLI a user runs, in subprocesses, each at its
   config's full widths: it trains a few thousand env steps on the card,
   evaluates from ``model_final`` and resumes with ``--auto-resume``.
   ``sac``: SAC + PointNet on ``configs/mfrl/sac/synthetic/pn_fake_manipulation.py``
   with a host replay.  ``drq_host``: DrQ (``num_aug=2``, a jitter on xyz;
   the encoders run at 512 rows) on
   ``configs/mfrl/drq/synthetic/pn_jitter_fake_manipulation.py`` with a host
   replay.  ``drq_device``: the same DrQ on a ``DeviceReplayMemory`` of the
   config's 100000 transitions on the card, stored packed in bf16, with the
   bf16 agent flag (the kernels' bf16 path).  ``drq_voxel``: DrQ with the
   voxel encoder (``SparseCNN``, dense 32^3 grid, a shift on xyz) on
   ``configs/mfrl/drq/synthetic/sparse_conv_shift_fake_manipulation.py``
   with a host replay, in f32.  ``sac_rnn``: recurrent SAC on the SAC
   config with ``pn_rnn.py``'s recurrent settings (a GRU of 128 between
   PointNet and the heads, batch 64, ``TStepTransition`` windows of 8 on
   the host replay).  ``ddpg``: DDPG/TD3 on the SAC config.  The voxel run
   takes 1000 env steps, the others 1200.  ``sac`` runs alone, its first
   40 env steps traced (``run_rl --profile``: device busy ms per env step,
   the idle share of its main loop); the other five go two at a time
   (``RUNS_AT_ONCE``), so their rates are those of a shared card and host.
   The updates replay CUDA graphs (``train_rl``'s lazy updates: the
   one-update program on the host batch, or over the card's replay for
   ``drq_device``).  Each run starts a fresh
   process and resets its kernel launch counts to 0 just before it trains
   or evaluates; it writes them to ``run_summary.json``.  The PointNet runs
   must have launched both kernels in training (and the max-only one in
   evaluation); the voxel run, which has no PointNet, must have launched
   neither.  Every 3D convolution must have run on the conv3d kernels: in
   the voxel run each kind's launches (``conv3d_launches``) equal its calls
   (``conv_calls``) and are above 0 (in evaluation the forward's alone);
   in the PointNet runs both are 0.  Each run also lists there the
   ``pointcloud_rl_tpu`` modules it loaded, which must be none, and its
   replay (``drq_device``: a ``DeviceReplayMemory`` on ``cuda`` with its
   bytes).  The loss of each run must be logged and finite.
5. Each run's three checkpoints act on 32 environment observations on the
   card (fused kernel, or the voxel encoder's torch ops) and on the CPU
   (plain versions): the eval-mode actions
   must agree (f32 runs to ``ACTION_ATOL``, the bf16 run to
   ``ACTION_ATOL_BF16``); the count of bf16 rounding flips that reach an
   action is printed.  The recurrent run acts on them as 8 steps of 4
   envs, its GRU state threaded from step to step and reset for two envs
   after the fourth.
6. The encoders that have no hand kernel (the voxel CNN, dense and
   sparse, VN, the 2D CNNs, PointNet with its STNs), each at the shape its
   config and algorithm give it: built once from a seeded generator, the
   same state dict on the card and on the CPU; the card's forward output
   on the whole batch (its first ``GRAD_ROWS`` rows against the CPU's) and
   every parameter's gradient on those rows must agree (``ENC_TOL``; VN
   ``VN_TOL``); ms per forward and
   per forward + backward (CUDA events) beside the FLOP count
   (``pointcloud_rl_torch/utils/flops.py`` on ``torch.utils.flop_counter``:
   the products, matmuls and convolutions; the dense voxel CNN's 3D
   convolutions run the port's kernels through ctypes, which the counter
   cannot see, so each of their calls is counted from its shapes,
   ``card_flops``) and the least time the card could take in f32 and in
   TF32.
6b. The voxel encoder's 3D convolutions (``conv``): the port's kernels of
   ``csrc/conv3d.cu`` (``ops/conv.py``) at the ``drq_voxel`` cell's three
   shapes (512 clouds; 32^3 x 32 -> 16^3 x 64 -> 8^3 x 64 -> 4^3 x 128, k 4,
   s 2), each kind (fprop, dgrad, wgrad with the bias) against the f64
   plain version on the card: the gap (largest error over the largest f64
   value) within the tests' tolerance (``tests/test_torch_conv3d.py``: n u,
   n the longest sum into one output, and at most twice cuDNN's own f32
   gap); whether the forward has cuDNN's f32 bits (reported, not held:
   another cuDNN may sum in another order); ms per call (CUDA events)
   beside the least time at the 67 TFLOP/s f32 FMA peak (or the bytes at
   HBM's rate), and cuDNN's ms for the same call as ``library_ms`` (the
   yardstick only: the port never calls it).  ``cuobjdump -sass`` of the
   library: no ``HMMA``/``HGMMA`` and no float ``RED``/``ATOM``.
7. The modules of the recurrent and DDPG slices, each built once, the same
   state dict on the card and on the CPU: the GRU's forward and backward at
   the recurrent update's ``[64, 9, 160]`` (and its ms per call), one
   discrete-SAC update at batch 256, one DDPG update at the SAC config's
   full width (its noise injected on both), and six steps of each
   optimizer branch; outputs, metrics and parameters must agree.
8. The DMC path's device ops (``dmc-modules``), card vs CPU on the same
   inputs and the same injected draws at the walker run's size (16 envs x
   3 frames x 84 x 84 renders of the stand-in below, 512 points per frame
   of which 128 ground): ``dmc_raw_to_pointcloud`` (xyz within
   ``XYZ_ATOL``, rgb and frame channel identical, ground/body label flips
   counted by the ``FLIP_BAND`` rule), ``fuse_camera_pointclouds`` (the
   three frames as three cameras), ``seg_balanced_downsample`` and
   ``uniform_downsample`` (indices identical); ms per call on the card.
9. The DMC walker run (``dmc``), in this process: the agent of
   ``configs/mfrl/sac/dm_control/pn_walker_tpu.py`` at full width (bf16,
   fused PointNet [64, 128, 256] -> 50, heads 1024 x 1024, batch 256, the
   pos_encoding block re-synthesized on the card, a float16 act upload) on
   a ``DeviceReplayMemory`` of the config's 100000 packed bf16
   transitions.  The env side is ``WalkerRawStandIn``, defined here only:
   16 envs (threads) whose raw renders (depth, rgb, camera row, as
   ``DMCEnv`` ships them in ``obs_mode="raw"``) are ray-cast from a seeded
   procedural scene, fused on the card by the port's ``ServerObsVectorEnv``
   (3 frames), collected by the port's ``Rollout`` and pushed, then 16 env
   steps and one ``update_parameters_scan`` of 16 updates (a CUDA graph) per
   cycle, as ``train_rl`` does without its hook, the metrics fetched once, for
   the config's 1000 warm-up steps and 22 cycles (the last 2 under
   ``torch.profiler``).  The kernel launch counts are reset just before and
   read just after; both kernels must have launched.  Updates/s, env
   steps/s, device busy ms per update and the device's idle share; then the
   trained agent's eval actions on 32 fused observations, card vs CPU
   (``ACTION_ATOL_BF16``, flips counted).  dm_control, MuJoCo and EGL are
   absent from the card's machine, hence the stand-in.
10. Data parallel (``dp``), each run a fresh process (``--dp-worker``):
   (a) two ranks on cuda:0 over gloo (NCCL runs one rank per GPU), (b) an
   NCCL world of one (``--dp-nccl-ranks N`` on a host of N cards: N NCCL
   ranks, one per card, which join with ``init_distributed`` from the
   launcher environment, and then ``run_rl --num-devices N``), (a') the
   two gloo ranks with a planted fault, the update's draws left unsharded,
   and the plain 1-rank agent.  Each holds the SAC slice's agent at full
   width (fused, global batch 256, f32) and a ``DeviceReplayMemory`` fed by
   the lead's collection through ``replicate_rollout`` (seeded full-width
   transitions, ``DPStubRollout``), then takes ``DP_UPDATES`` updates with
   the noise on: the ranks' parameters must be bitwise equal; each update
   must agree with the 1-rank update from the same state on the same
   global batch (``DP_TOL`` but for Adam's flips, at most ``DP_FLIPS``
   elements; metrics to ``UPDATE_METRIC_RTOL``), and every update of the
   planted fault must fail that check; the free runs' gaps are printed; each rank must
   launch each kernel once per update, on its rows.  The NCCL ranks and
   the 1-rank agent replay CUDA graphs (their all-reduces captured), the
   gloo ranks run eagerly; the NCCL world of one must be bitwise the 1-rank
   agent (the mean over one rank is the identity).  Then ``DP_TIMED``
   updates: ms per update of each world, the gloo ranks' gradient
   all-reduces per update (host clock), the NCCL kernels inside one replay
   (``torch.profiler``: a capture may not sync) and the transition
   broadcast per cycle.  Each NCCL rank then runs the graphs phase's
   checks (3b) with both twins ranks of its world, the graphed one's
   all-reduces captured, the eager one's eager: the walker recipe's scans,
   its act-fused forwards (and the body kernels inside one replay against
   ``launch_counts``) and the SAC slice's host batches, bitwise, with host
   and device ms per update, graphed against eager.  Every rank frees its
   programs before it leaves the process group: NCCL frees a communicator
   only once no graph holds its collectives (``end_world``).
   (c) ``run_rl --profile 5`` on the SAC slice: its ``torch.profiler``
   trace must name both body kernels.
   (e) Updates interleaved with collection on a world (``--interleave-worker``):
   the pipelined DrQ walker ``pn_shift_tpu.py`` at full width (global
   batch 256, its replay cut to ``INTERLEAVE_CAPACITY``) through
   ``train_rl``, 1000 warm-up steps and ``INTERLEAVE_CYCLES`` cycles of 16
   env steps and 16 updates, rank 0 collecting over ``WalkerRawStandIn``:
   as 2 gloo ranks on cuda:0 (eager), with ``--dp-nccl-ranks N`` >= 2 as N
   graphed NCCL ranks, and outside a process group.  The ranks of a world
   must end bitwise equal, every rank's scans (with the buffer each
   sampled) must be those outside a group, the chunk on the buffer before
   its cycle's push; both kernels launched on every rank; updates/s and
   rank 0's device idle share (``torch.profiler`` over the last cycle).
11. A world across hosts (``hosts``), each host a fresh process
   (``--hosts-worker``) with torchrun's variables (``GROUP_RANK`` h,
   ``LOCAL_RANK`` 0, ``LOCAL_WORLD_SIZE`` 1) that joins a gloo world on
   cuda:0 itself (NCCL refuses two ranks on one GPU) and calls the port's
   ``run_rl.main``, as a rank started by torchrun would: (a) two hosts
   train the SAC slice at full width (fused, global batch 256 = 128 rows
   per rank, f32, 4 env workers per host, 512 warm-up + 128 env steps),
   each collecting with the same seeds: both replays must be bitwise equal,
   the parameters bitwise equal, each of ``HOSTS_UPDATES`` updates from the
   trained state within ``DP_TOL`` of the 1-rank update (as in ``dp``),
   both kernels launched on each rank, ``run_summary.json`` written by rank
   0 alone (2 hosts; host 1's work dir stays empty); updates/s per host
   and ms per update in lockstep (gloo stages each all-reduce through the
   host).  (b) full-episode collection with host 1 slowed in this script
   (its env steps followed by a sleep): the straggler vote must cut host 1
   with its partial episodes flushed, every collection must push between
   0.8 x and 1 x its quota, and both hosts must leave the loop at one step.
   (c) ``hosts-nccl``, only with ``--dp-nccl-ranks N`` >= 2: two
   ``torch.distributed.run`` agents on localhost (``--nnodes 2``, static
   rendezvous), ``run_rl --device cuda --gpu-ids h`` over NCCL, checked
   from the run's files.
12. Replay persistence (``replay-io``), in this process, at the walker
   recipe's full width: a ``DeviceReplayMemory`` of the config's 100000
   packed bf16 transitions filled past one wrap by pushes of one seeded
   host block of 4096 raw transitions whose rewards carry their global
   index; the ``save_replay=50000`` snapshot through ``train_rl``'s own
   ``replay_snapshot`` (the newest transitions in push order on the host,
   held bitwise against the packed pushes and the indices; gather + D2H
   timed); the restore into a fresh ring through ``load_hdf5``'s chunk loop
   (``push_in_chunks``, 4096 rows, timed; the ring bitwise equal to the
   snapshot); the restored rewards then set to seeded values on the
   walker's scale ([0, 1]); one update from that ring card vs CPU from one state
   on one batch, the noise pinned to zero (metrics to ``ACTION_ATOL_BF16``
   relative); then ``train_rl`` offline (no rollout, ``n_steps=0``,
   ``warm_steps=0``) for 20 x 16 updates, timed with CUDA events, both
   kernels launched, every logged metric finite.  The HDF5 file between
   snapshot and restore is host code that needs h5py, which the card's
   machine lacks: ``tests/test_torch_replay_io.py`` holds it on the CPU.
13. The ManiSkill path (``maniskill``) over ``ManiSkillRawStandIn``, defined
   here only and written with stand-in ``sapien``, ``mani_skill.env`` and
   ``gym`` modules into a directory on the children's ``PYTHONPATH`` (the
   env workers start from a forkserver, which sees no module put into this
   process): (a) SAC on ``configs/mfrl/sac/maniskill/pn.py`` and (b) DrQ on
   ``configs/mfrl/drq/maniskill/pn_shift.py`` through ``run_rl`` at full
   width (fused PointNet [128, 128, 256] -> 128 on 9 channels, heads 1024 x
   1024, batch 256, f32, the config's 4 env workers and host replay of
   100000), 512 warm-up steps then 1200 (a) or 400 (b) env steps, the
   first 40 under ``torch.profiler``: every env must have been made by
   ``pointcloud_rl_torch.env.maniskill`` (the stand-in records who calls
   ``gym.make``), both kernels launched, no JAX module loaded; env steps/s,
   updates/s and the device's idle share (busy ms per env step in the
   trace against the main loop's wall).  Then ``build_env`` here must give
   the port's ``ManiSkillObsWrapper`` with obs xyz (3, 1200), rgb (3, 1200)
   uint8, seg (3, 1200), state (38,).  (c) the port's ``mani.Evaluator``
   over 4 levels of the stand-in built by ``build_env``, with a policy that
   calls (a)'s trained agent's deterministic act on the card: the
   ``eval_info`` shares and the CSV.
14. The pipelined collection path (``pipeline``), in this process: (a)
   ``forward_async`` of the SAC agent (``pn_fake_manipulation.py``, 4 x 1200
   x 8, f32) and of the walker agent (``pn_walker_tpu.py``, 16 x 1536 x 9,
   bf16, float16 act upload) at full width: in eval mode its actions must
   be bitwise ``forward``'s, its handles must carry a CUDA event, two
   handles in flight must hold their own actions; host ms to dispatch, ms
   until ``is_ready()``, ``forward``'s ms and the longest poll.  (b) The DrQ
   walker recipe ``configs/mfrl/drq/dm_control/pn_shift_tpu.py`` through
   ``train_rl`` at full width (DrQ, 2 shifted copies, bf16, fused PointNet,
   a packed ``DeviceReplayMemory`` of 100000, 16 envs in one group, 16 env
   steps : 16 updates, ``action_lag=1``, its ``stall_timeout``) over
   ``WalkerRawStandIn`` behind ``ServerObsVectorEnv`` (cheetah needs
   dm_control): the config's 1000 warm-up steps, then 20 timed and 2
   profiled cycles; every applied action must be, bitwise, the action
   dispatched one group-step earlier; every cycle's 16 updates must run as
   one chunk after its act dispatch, on the buffer before its push; every
   metric vector finite; both kernels launched.  Then the same with
   ``action_lag=0`` (each step's own action), and with ``action_lag=1``
   and ``train_rl(..., act_fused_updates=True)`` (each cycle's 16 updates
   inside the act's program).  Env steps/s, updates/s and
   the device's idle share (``torch.profiler`` over the 2 cycles against
   the timed cycles' wall).
15. One JSON line describing the encoders, one the convolutions, one describing the modules, one
   each for the graphs phase, the DMC modules, the DMC run, the dp, hosts,
   replay-io, maniskill and pipeline phases, the script's total time, one line
   describing the kernels (the two TPU kernels' entry points, the winner
   backward and the three conv3d kernels, each with its launches by run,
   ms, bound and library ms), the card's name and power limit, then the
   result line ``{"ok": true, "device": {...}}``.

Every time printed here was measured in this run, on the card named in
phase 1.  The plain versions run with TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``), i.e. in full f32; the
encoders' convolutions are f32 by their own setting (``ops/conv.py``).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import csv
import json
import math
import os
import os.path as osp
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from pointcloud_rl_torch.utils.trace import reset_counters

REPO = osp.dirname(osp.abspath(__file__))
SLICE_CONFIG = "configs/mfrl/sac/synthetic/pn_fake_manipulation.py"
DRQ_CONFIG = "configs/mfrl/drq/synthetic/pn_jitter_fake_manipulation.py"
VOXEL_CONFIG = "configs/mfrl/drq/synthetic/sparse_conv_shift_fake_manipulation.py"
FUSED = "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.fused=True"
# pn_rnn.py's recurrent settings on the SAC config.
RNN_OPTS = ["agent_cfg.actor_cfg.nn_cfg.rnn_cfg.type=GRU", "agent_cfg.actor_cfg.nn_cfg.rnn_cfg.hidden_size=128",
            "agent_cfg.batch_size=64", "replay_cfg.sampling_cfg.type=TStepTransition",
            "replay_cfg.sampling_cfg.horizon=8"]
# The training runs of phase 4: (name, config, its --cfg-options, metric
# prefix, whether its encoder is the fused PointNet: the runs that are must
# launch both forward entries and the winner backward, the others none; env steps, checkpointed at half
# and at the end).  The PointNet runs are cut to 1200 steps and the voxel
# run, the slowest per update, to 1000 to keep the script inside its time
# (a run must pass 1000 steps: it logs every 500 after the 512-step warm-up).
RUNS = [
    ("sac", SLICE_CONFIG, [FUSED, "replay_cfg.capacity=20000"], "sac", True, 1200),
    # the slowest first, so that the pair of runs ends close together
    ("drq_voxel", VOXEL_CONFIG, ["replay_cfg.capacity=20000"], "drq", False, 1000),
    ("sac_rnn", SLICE_CONFIG, [FUSED, *RNN_OPTS, "replay_cfg.capacity=20000"], "sac", True, 1200),
    ("ddpg", SLICE_CONFIG, [FUSED, "agent_cfg.type=DDPG", "replay_cfg.capacity=20000"], "ddpg", True, 1200),
    ("drq_host", DRQ_CONFIG, [FUSED, "replay_cfg.capacity=20000"], "drq", True, 1200),
    ("drq_device", DRQ_CONFIG, [FUSED, "replay_cfg.type=DeviceReplayMemory",
                                "replay_cfg.transfer_cfg.pack_features=True", "agent_cfg.bf16=True"], "drq", True, 1200),
]
RUNS_AT_ONCE = 2  # runs of the runs phase that share the card and the host at a time, after the SAC run alone
RUNS_PROFILE_STEPS = 40  # env steps of the SAC run under torch.profiler: the device's busy time
KERNEL_SOURCE = "pointcloud_rl_torch/csrc/pointnet_fused.cu"
TPU_KERNELS = {
    "pointnet_fused_fwd_idx": "pointcloud_rl_tpu/ops/pointnet_fused.py:113",
    "pointnet_fused_fwd_max": "pointcloud_rl_tpu/ops/pointnet_fused.py:138",
}
# The winner backward (``pointnet_fused.bwd_launch_counts``): plain jnp ops
# in the JAX package, a hand-written kernel chain (winner_bwd_*) here.
BWD_KERNEL = "pointnet_fused_bwd"
BWD_REPLACES = "pointcloud_rl_tpu/ops/pointnet_fused.py:228"
# What a PointNet training run launches: both forward entries and the backward.
TRAIN_KERNELS = [*TPU_KERNELS, BWD_KERNEL]
# The voxel encoder's 3D convolutions: XLA's convolutions in the JAX package,
# hand-written f32 FFMA kernels here, one launch a call: kernel -> (its key of
# ``conv3d_launches``, the key of ``conv_calls`` it must equal).
CONV_SOURCE = "pointcloud_rl_torch/csrc/conv3d.cu"
CONV_REPLACES = "pointcloud_rl_tpu/models/voxel.py:72"
CONV_KERNELS = {
    "conv3d_fprop_kernel": ("conv3d_fprop_launches", "conv3d_fwd"),
    "conv3d_dgrad_kernel": ("conv3d_dgrad_launches", "conv3d_dgrad"),
    "conv3d_wgrad_kernel": ("conv3d_wgrad_launches", "conv3d_wgrad"),
}
CONV_BOUND_FORMULA = "max(ops, bytes): ops = FLOP/67e12 s (f32 FFMA), FLOP = 2 * output sites * C_out * C_in * 64"
# (name, B, N, C_in, widths, compute dtype name): the main path's shapes,
# timed (SAC's and DDPG's update encodes at B=256, a data-parallel rank's
# 128 of them at 2 ranks and 64 at 4, DrQ's at 2 x 256 rows
# in f32 and in bf16, which are also the recurrent critic's 64 x 8 window
# rows, the recurrent target's 64 x 9, the act encode at 4 env workers in
# f32 and in bf16, the walker encoder of the dmc run's updates, and its act
# encode at 16 env workers, the DrQ walker recipe's update encodes of the
# pipeline phase (2 x 256 rows), the ManiSkill configs' 9-channel clouds (xyz,
# rgb and 3 seg masks) at SAC's 256 rows, DrQ's 512 and the act's 4 env
# workers; the pipelined rollout acts on 4 env workers as 2 groups of 2, so
# each act shape of 4 rows has its 2-row twin), then edge shapes, checked only.
SHAPES = [
    ("slice_f32", 256, 1200, 8, (128, 128, 256), "float32"),
    ("dp_rank_f32", 128, 1200, 8, (128, 128, 256), "float32"),
    ("dp_rank4_f32", 64, 1200, 8, (128, 128, 256), "float32"),
    ("drq_f32", 512, 1200, 8, (128, 128, 256), "float32"),
    ("rnn_target_f32", 576, 1200, 8, (128, 128, 256), "float32"),
    ("drq_bf16", 512, 1200, 8, (128, 128, 256), "bfloat16"),
    ("act_f32", 4, 1200, 8, (128, 128, 256), "float32"),
    ("act_bf16", 4, 1200, 8, (128, 128, 256), "bfloat16"),
    ("act2_f32", 2, 1200, 8, (128, 128, 256), "float32"),
    ("act2_bf16", 2, 1200, 8, (128, 128, 256), "bfloat16"),
    ("walker_f32", 256, 1536, 9, (64, 128, 256), "float32"),
    ("walker_bf16", 256, 1536, 9, (64, 128, 256), "bfloat16"),
    ("act_walker_bf16", 16, 1536, 9, (64, 128, 256), "bfloat16"),
    ("walker_drq_bf16", 512, 1536, 9, (64, 128, 256), "bfloat16"),
    ("maniskill_f32", 256, 1200, 9, (128, 128, 256), "float32"),
    ("maniskill_drq_f32", 512, 1200, 9, (128, 128, 256), "float32"),
    ("maniskill_act_f32", 4, 1200, 9, (128, 128, 256), "float32"),
    ("maniskill_act2_f32", 2, 1200, 9, (128, 128, 256), "float32"),
]
# The winner backward at the shapes the main path trains at (names of
# SHAPES): the SAC slice, the data-parallel ranks, DrQ in f32 and bf16 (the
# recurrent critic's rows too), the walker's updates and its DrQ recipe's,
# and the ManiSkill SAC and DrQ encodes.  The act and target encodes run
# without grad and never reach it.
BWD_SHAPES = ["slice_f32", "dp_rank_f32", "dp_rank4_f32", "drq_f32", "drq_bf16", "walker_bf16",
              "walker_drq_bf16", "maniskill_f32", "maniskill_drq_f32"]
EDGE_SHAPES = [
    ("b1_n1", 1, 1, 8, (128, 128, 256), "float32"),
    ("b1_n63", 1, 63, 9, (64, 128, 256), "float32"),
    ("b2_n1201", 2, 1201, 8, (128, 128, 256), "float32"),
    ("b1_n1201_bf16", 1, 1201, 9, (64, 128, 256), "bfloat16"),
    ("odd_widths_f32", 3, 300, 8, (40, 72, 200), "float32"),
    ("odd_widths_bf16", 3, 300, 8, (40, 72, 200), "bfloat16"),
    ("narrow_f32", 2, 100, 8, (32, 64, 128), "float32"),  # f32 weights resident in shared memory
]
# Published dense peaks of one H100 SXM at 700 W (NVIDIA H100 datasheet).
PEAK_TF32 = 495e12   # FLOP/s; f32 runs as 3xTF32, 3 products per FLOP
PEAK_BF16 = 989e12   # FLOP/s
PEAK_BYTES = 3.35e12  # bytes/s of HBM3
BOUND_FORMULA = ("max(ops, bytes): ops = 3*FLOP/495e12 s (f32 as 3xTF32) or FLOP/989e12 s (bf16), "
                 "FLOP = 2*B*N*(C_in*c1 + c1*c2 + c2*c3); bytes = x + W + biases/LN read once, "
                 "pooled (+idx) written once, over 3.35e12 B/s")
# Tolerances of kernel vs plain.  f32: the kernel sums each dot product in
# another order than cuBLAS, and LayerNorm divides by a per-row std, so
# values agree to a few f32 ulps times the depth; 1e-4 absolute on O(1)
# features.  bf16: both sides round h1/h2/h3 to bf16 (8 bits of mantissa),
# and a different f32 sum can land on the other side of a rounding step,
# so one element may move by an ulp of bf16 (0.4% relative) per layer.
POOLED_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 2e-2)}  # (atol, rtol)
# Gradients: f32 winner-row recompute vs autograd through cuBLAS f32 and
# per-element sums over the batch; compared relative to each tensor's scale.
GRAD_RTOL = 1e-3
# The winner backward against the plain ``_winner_backward``, both in f32
# with TF32 off: each gradient's worst element over the tensor's largest.
# The H100 gives under 1e-6 at every shape of BWD_SHAPES; a TF32 product
# moves them by 1e-4 and more.
BWD_TOL = 1e-5
BWD_BOUND_FORMULA = ("max(ops, bytes): ops = FLOP/67e12 s (f32 FFMA), FLOP = 3 * 2*B*c3*(C_in*c1 + c1*c2 + c2*c3) "
                     "(the winner rows' forward again, then the products of their backward); bytes = the "
                     "winner rows of x, idx and g read once, over 3.35e12 B/s")
# Trained agent, kernel on the card vs plain body on the CPU: f32 features
# that differ by ~1e-6, through the 1024-wide head and a tanh (slope <= 1).
ACTION_ATOL = 1e-4
# The bf16 agent: the card and the CPU round to bf16 at the same points
# (each product, each bias add, h1..h3 in the body), but their f32 sums run
# in another order, and a sum that lands on the other side of a rounding
# step moves that value by one bf16 ulp.  A flip upstream moves the next
# layer's f32 sums by far less than an ulp, so what reaches the action is
# in the main a flip of the bf16 action mean itself: one ulp times the
# tanh's slope, at most 2^-7 * sech^2(1) = 3.3e-3 over all means.  The
# limit admits two such flips in one action element: 7e-3.  The flips seen
# are counted and printed (actions that differ by more than FLIP_ABS).
ACTION_ATOL_BF16 = 7e-3
FLIP_ABS = 1e-5  # above the f32 noise of the tanh (~1e-7)
REF_OBS = 32  # environment observations per checkpoint in phase 5
REF_ENVS = 4  # a recurrent agent acts on them as REF_OBS // REF_ENVS steps of this many envs


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_inputs(B, N, c_in, widths, seed: int = 0):
    """x and the 10 body params on the card, from a seeded generator."""
    import torch

    g = torch.Generator().manual_seed(seed)
    c1, c2, c3 = widths

    def uni(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        return (torch.rand(shape, generator=g) * 2 - 1) * bound

    def near(shape, center, scale):
        return center + scale * torch.randn(shape, generator=g)

    x = torch.randn((B, N, c_in), generator=g)
    params = (
        uni((c_in, c1), c_in), uni((c1,), c_in),
        uni((c1, c2), c1), uni((c2,), c1), near((c2,), 1.0, 0.1), near((c2,), 0.0, 0.1),
        uni((c2, c3), c2), uni((c3,), c2), near((c3,), 1.0, 0.1), near((c3,), 0.0, 0.1),
    )
    return x.cuda(), tuple(p.cuda() for p in params)


def check_close(name, got, want, atol, rtol) -> float:
    import torch

    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        fail(f"{name}: {int(bad.sum())} elements outside atol={atol} rtol={rtol}; "
             f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def bound_ms(B, N, c_in, widths, dname, with_idx: bool):
    """The least time the card could take for one call: the larger of the
    operations over the peak rate of their type and the bytes over HBM's
    rate.  Returns (ms, "operations" or "bytes")."""
    c1, c2, c3 = widths
    flop = 2 * B * N * (c_in * c1 + c1 * c2 + c2 * c3)
    esz = 4 if dname == "float32" else 2
    nbytes = (B * N * c_in + c_in * c1 + c1 * c2 + c2 * c3) * esz + 4 * (c1 + 3 * c2 + 3 * c3)
    nbytes += B * c3 * (8 if with_idx else 4)
    ops_s = 3 * flop / PEAK_TF32 if dname == "float32" else flop / PEAK_BF16
    mem_s = nbytes / PEAK_BYTES
    return 1e3 * max(ops_s, mem_s), ("operations" if ops_s >= mem_s else "bytes")


def sass_counts(lib_path: str) -> dict:
    """{kernel name: (HGMMA count, HMMA count)} from ``cuobjdump -sass``."""
    from pointcloud_rl_torch.ops import build as kbuild

    cuobjdump = osp.join(osp.dirname(kbuild.find_nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += " HMMA" in line
    return {k: tuple(v) for k, v in counts.items()}


def phase_sass(lib_path: str) -> dict:
    counts = sass_counts(lib_path)
    per_entry = {}
    for entry, body in (("pointnet_fused_fwd_idx", "pointnet_body_idx_kernel"),
                        ("pointnet_fused_fwd_max", "pointnet_body_max_kernel")):
        kern = {k: v for k, v in counts.items() if body in k}
        if len(kern) != 3:  # the chunked body in f32 and bf16, the persistent one in bf16
            fail(f"expected an f32 and a bf16 {body} and a bf16 {body}_persistent in the library, found {sorted(kern)}")
        labels = {k: ("bf16" if "bfloat16" in k else "f32") + ("_persistent" if "persistent" in k else "") for k in kern}
        for k, (hgmma, hmma) in sorted(kern.items()):
            print(f"[sass] {entry} {body}<{labels[k]}>: {hgmma} HGMMA, {hmma} HMMA", flush=True)
            if hgmma == 0:
                fail(f"{body}<{labels[k]}> holds no HGMMA instruction: the tensor cores are unused")
        per_entry[entry] = {labels[k]: v[0] for k, v in kern.items()}
    for k, (hgmma, hmma) in sorted(counts.items()):
        if "pointnet_body" not in k:
            print(f"[sass] {k}: {hgmma} HGMMA, {hmma} HMMA", flush=True)
    # the winner backward is f32 FFMA: a tensor-core product in it would be TF32
    bwd = {k: v for k, v in counts.items() if "winner_bwd" in k}
    if not any("winner_bwd_kernel" in k for k in bwd) or any(sum(v) for v in bwd.values()):
        fail(f"expected winner_bwd kernels without HGMMA or HMMA in the library, found {bwd}")
    per_entry[BWD_KERNEL] = {("bf16" if "bfloat16" in k else "f32"): v[0] for k, v in bwd.items()
                             if "winner_bwd_kernel" in k}
    return per_entry


def check_shape(pf, name, B, N, c_in, widths, dname, seed=0):
    """Both entry points against the plain version at one shape; returns
    (inputs, compute dtype, errors, share of identical indices)."""
    import torch

    dtype = getattr(torch, dname)
    cdt = None if dtype == torch.float32 else dtype
    atol, rtol = POOLED_TOL[dname]
    x, params = make_inputs(B, N, c_in, widths, seed=seed)
    with torch.no_grad():
        want_h3 = pf._body_rows(x.reshape(B * N, c_in), params, cdt).reshape(B, N, -1).float()
        want = want_h3.max(dim=1).values
        got_idx_pooled, got_idx = pf._forward_kernel(x, params, cdt, with_idx=True)
        got_max, _ = pf._forward_kernel(x, params, cdt, with_idx=False)
        again_pooled, again_idx = pf._forward_kernel(x, params, cdt, with_idx=True)
        again_max, _ = pf._forward_kernel(x, params, cdt, with_idx=False)
        torch.cuda.synchronize()
        e_idx = check_close(f"{name} fwd_idx pooled", got_idx_pooled, want, atol, rtol)
        e_max = check_close(f"{name} fwd_max pooled", got_max, want, atol, rtol)
        if not torch.equal(got_idx_pooled, got_max):
            fail(f"{name}: the two entry points disagree on pooled")
        if not (torch.equal(again_pooled, got_idx_pooled) and torch.equal(again_idx, got_idx)
                and torch.equal(again_max, got_max)):
            fail(f"{name}: two calls on the same inputs are not bitwise equal")
        if int(got_idx.min()) < 0 or int(got_idx.max()) >= N:
            fail(f"{name}: winner index out of range")
        # The kernel's winner must attain the plain max (robust to near-ties).
        at_winner = torch.gather(want_h3, 1, got_idx.long()[:, None, :])[:, 0, :]
        e_arg = check_close(f"{name} argmax", at_winner, want, atol, rtol)
        same = float((got_idx == pf._tile_max_argmax(want_h3)[1]).float().mean())
    del want_h3
    return (x, params), cdt, (e_idx, e_max, e_arg), same


def check_copies(pf, dname: str) -> None:
    """Three copies of the same 400 points at the act shape, each copy in
    other chunks than the rest: the winners must equal the plain first-index
    argmax exactly, and all be first copies."""
    import torch

    dtype = getattr(torch, dname)
    cdt = None if dtype == torch.float32 else dtype
    x, params = make_inputs(4, 400, 8, (128, 128, 256), seed=3)
    x = torch.cat([x, x, x], dim=1).contiguous()
    lib = pf.load_library()
    bf16 = int(cdt is not None)
    tile = lib.pointnet_fused_tile_rows(bf16, 8, 128, 128, 256)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    if lib.pointnet_fused_persistent(bf16, 8, 128, 128, 256):  # runs of (batch row, tile) pairs
        chunks, per = pf.choose_runs(4, 1200, tile, n_sm)
        per_chunk = per * tile
    else:
        chunks = pf.choose_chunks(4, 1200, tile, n_sm)
        per_chunk = -(-(-(-1200 // tile)) // chunks) * tile
    if per_chunk > 400:
        fail(f"copies: {chunks} chunks of {per_chunk} points do not separate the copies")
    with torch.no_grad():
        _, idx = pf._forward_kernel(x, params, cdt, with_idx=True)
        _, want = pf._forward_plain(x, params, cdt, with_idx=True)
        torch.cuda.synchronize()
    if int(idx.max()) >= 400 or not torch.equal(idx, want):
        fail(f"copies ({dname}): winners differ from the plain first-index argmax on "
             f"{int((idx != want).sum())} of {idx.numel()} channels")
    print(f"[kernels] copies in different chunks ({dname}, {chunks} chunks of {per_chunk} points): "
          f"winners equal the plain first-index argmax on all {idx.numel()} channels", flush=True)


def phase_kernels(pf, report: dict, card: str) -> None:
    import torch

    for name, B, N, c_in, widths, dname in SHAPES:
        (x, params), cdt, (e_idx, e_max, e_arg), same = check_shape(pf, name, B, N, c_in, widths, dname)
        with torch.no_grad():
            ms_idx = time_ms(lambda: pf._forward_kernel(x, params, cdt, with_idx=True))
            ms_max = time_ms(lambda: pf._forward_kernel(x, params, cdt, with_idx=False))
            plain_idx = time_ms(lambda: pf._forward_plain(x, params, cdt, with_idx=True))
            plain_max = time_ms(lambda: pf._forward_plain(x, params, cdt, with_idx=False))
        b_idx = bound_ms(B, N, c_in, widths, dname, True)
        b_max = bound_ms(B, N, c_in, widths, dname, False)
        print(f"[kernels] {name} B={B} N={N} C_in={c_in} widths={widths}: "
              f"max abs err fwd_idx {e_idx:.3e} fwd_max {e_max:.3e} argmax {e_arg:.3e}, "
              f"idx identical to plain {same:.4%}; ms/call fwd_idx {ms_idx:.4f} "
              f"(plain {plain_idx:.3f}, bound {b_idx[0]:.4f}) fwd_max {ms_max:.4f} "
              f"(plain {plain_max:.3f}, bound {b_max[0]:.4f}) on {card}", flush=True)
        for kname, err, ms, pms, bnd in (
                ("pointnet_fused_fwd_idx", max(e_idx, e_arg), ms_idx, plain_idx, b_idx),
                ("pointnet_fused_fwd_max", e_max, ms_max, plain_max, b_max)):
            rec = report.setdefault(kname, {"max_abs_err": 0.0, "shapes": {}})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["shapes"][name] = {"ms": ms, "plain_ms": pms, "bound_ms": bnd[0], "bound_by": bnd[1]}
        del x, params

    for name, B, N, c_in, widths, dname in EDGE_SHAPES:
        _, _, errs, same = check_shape(pf, name, B, N, c_in, widths, dname, seed=4)
        print(f"[kernels] edge {name} B={B} N={N} C_in={c_in} widths={widths} {dname}: "
              f"max abs err {max(errs):.3e}, idx identical to plain {same:.4%}, repeat bitwise equal",
              flush=True)
    for dname in ("float32", "bfloat16"):
        check_copies(pf, dname)

    # Gradients of the fused body at the slice's shape vs autograd through
    # the plain body (f32; the slice trains in f32).
    name, B, N, c_in, widths, _ = SHAPES[0]
    x, params = make_inputs(B, N, c_in, widths, seed=1)
    w = torch.randn((B, widths[-1]), generator=torch.Generator().manual_seed(2)).cuda()
    leaves = [x.clone().requires_grad_(True)] + [p.clone().requires_grad_(True) for p in params]
    (pf.FusedPointNetBody.apply(*leaves, None) * w).sum().backward()
    ref = [t.detach().clone().requires_grad_(True) for t in leaves]
    h3 = pf._body_rows(ref[0].reshape(B * N, c_in), tuple(ref[1:]), None).reshape(B, N, -1)
    (h3.max(dim=1).values * w).sum().backward()
    names = ["dx", "dw1", "db1", "dw2", "db2", "dg2", "dbe2", "dw3", "db3", "dg3", "dbe3"]
    worst = 0.0
    for gname, a, b in zip(names, leaves, ref):
        scale = float(b.grad.abs().max()) + 1e-12
        rel = float((a.grad - b.grad).abs().max()) / scale
        if not math.isfinite(rel) or rel > GRAD_RTOL:
            fail(f"gradient {gname}: max abs err / max abs = {rel:.3e} > {GRAD_RTOL}")
        worst = max(worst, rel)
    print(f"[kernels] FusedPointNetBody gradients at {name}: worst max-err/scale {worst:.3e} "
          f"(limit {GRAD_RTOL})", flush=True)


def bwd_bound_ms(B, c_in, widths, dname):
    """The least time the winner backward could take at one shape (no dx),
    as BWD_BOUND_FORMULA says.  Returns (ms, "operations" or "bytes")."""
    c1, c2, c3 = widths
    rows = B * c3
    ops_s = 3 * 2 * rows * (c_in * c1 + c1 * c2 + c2 * c3) / PEAK_F32
    mem_s = rows * (c_in * (4 if dname == "float32" else 2) + 8) / PEAK_BYTES
    return 1e3 * max(ops_s, mem_s), ("operations" if ops_s >= mem_s else "bytes")


def phase_bwd_kernel(pf, card: str) -> dict:
    """The winner-backward kernel against the plain ``_winner_backward`` at
    each shape of BWD_SHAPES (winners from the with-argmax forward, a random
    cotangent): the ten parameter gradients within BWD_TOL of each tensor's
    largest, two calls bitwise equal, and ms per call of both beside
    ``bwd_bound_ms``.  Returns {"max_gap": worst gap, "shapes": {...}}."""
    import torch

    shapes = {s[0]: s[1:] for s in SHAPES}
    names = ["dw1", "db1", "dw2", "db2", "dg2", "dbe2", "dw3", "db3", "dg3", "dbe3"]
    rec: dict = {"max_gap": 0.0, "shapes": {}}
    for name in BWD_SHAPES:
        B, N, c_in, widths, dname = shapes[name]
        x, params = make_inputs(B, N, c_in, widths, seed=7)
        cdt = None if dname == "float32" else getattr(torch, dname)
        x = x.to(cdt or torch.float32)
        with torch.no_grad():
            _, idx = pf._forward_kernel(x, params, cdt, with_idx=True)
            g = torch.randn(idx.shape, generator=torch.Generator("cuda").manual_seed(8), device="cuda")
            _, want = pf._winner_backward(x, params, idx, g)
            _, got = pf._winner_backward_kernel(x, params, idx, g, False)
            _, again = pf._winner_backward_kernel(x, params, idx, g, False)
            torch.cuda.synchronize()
            gaps = {}
            for gname, a, b in zip(names, got, want):
                gaps[gname] = float((a - b).abs().max() / b.abs().max())
                if not math.isfinite(gaps[gname]) or gaps[gname] > BWD_TOL:
                    fail(f"winner backward {name} {gname}: max abs err / max abs = {gaps[gname]:.3e} > {BWD_TOL}")
            if not all(torch.equal(a, b) for a, b in zip(again, got)):
                fail(f"winner backward {name}: two calls on the same inputs are not bitwise equal")
            ms = time_ms(lambda: pf._winner_backward_kernel(x, params, idx, g, False))
            plain = time_ms(lambda: pf._winner_backward(x, params, idx, g), iters=5)
        bound, by = bwd_bound_ms(B, c_in, widths, dname)
        worst = max(gaps.values())
        rec["max_gap"] = max(rec["max_gap"], worst)
        rec["shapes"][name] = {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by, "max_gap": worst}
        print(f"[kernels] winner backward {name} B={B} N={N} C_in={c_in} widths={widths} {dname}: worst gap "
              f"{worst:.3e} (limit {BWD_TOL}), repeat bitwise equal; ms/call {ms:.4f} (plain {plain:.3f}, "
              f"bound {bound:.4f}, {bound / ms:.1%} of it) on {card}", flush=True)
        del x, params, idx, g, want, got, again
    return rec


def run_cli(config: str, args, log_path: str, timeout: int, env=None) -> None:
    cmd = [sys.executable, "-m", "pointcloud_rl_torch.apis.run_rl", config, *args]
    print("[run] $ " + " ".join(cmd[1:]), flush=True)
    t0 = time.monotonic()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True, env=env)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
            rc = "timeout"
    if rc != 0:
        with open(log_path) as f:
            tail = f.read()[-4000:]
        fail(f"run_rl exited with {rc}:\n{tail}")
    print(f"[run]   done in {time.monotonic() - t0:.1f} s", flush=True)


def read_summary(wd: str) -> dict:
    """The run's ``run_summary.json``; the run must have loaded nothing of
    the JAX package."""
    with open(osp.join(wd, "run_summary.json")) as f:
        summary = json.load(f)
    if summary.get("pointcloud_rl_tpu_modules") != []:
        fail(f"the run loaded modules of the JAX package: {summary.get('pointcloud_rl_tpu_modules')}")
    return summary


def read_metrics(path: str):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        fail(f"{path} has no rows")
    for row in rows:
        for k, v in row.items():
            if v not in ("", None) and not math.isfinite(float(v)):
                fail(f"{path}: {k}={v} at step {row.get('step')}")
    return rows


def check_launches(name: str, stage: str, launches: dict, pointnet: bool, kernels) -> None:
    """A PointNet run launches each of ``kernels``; any other run none."""
    for kname in kernels:
        n = launches[kname]
        if pointnet and n <= 0:
            fail(f"{kname} was never launched by the {name} {stage} run")
        if not pointnet and n != 0:
            fail(f"{kname} launched {n} times in the {name} {stage} run, whose encoder is not PointNet")


def launched(pf) -> dict:
    """The launches counted since the last reset: both forward entries and the winner backward."""
    return {**pf.launch_counts, **pf.bwd_launch_counts}


def run_launches(summary: dict) -> dict:
    """A ``run_summary.json``'s launches, the winner backward's and the conv kernels' with them."""
    return {**summary["launches"], **summary["bwd_launches"], **summary["conv3d_launches"]}


def check_conv_launches(name: str, stage: str, summary: dict, kinds) -> None:
    """Every 3D convolution of the run went through the port's kernels: each
    kind's launches (``conv3d_launches``) equal its calls (``conv_calls``),
    above 0 for the kernels in ``kinds`` and 0 for the others."""
    for kname, (launch_key, call_key) in CONV_KERNELS.items():
        n, calls = summary["conv3d_launches"][launch_key], summary["conv_calls"][call_key]
        if n != calls or (n > 0) != (kname in kinds):
            fail(f"the {name} {stage} run launched {kname} {n} times for {calls} {call_key} calls; "
                 f"expected {'as many, above 0' if kname in kinds else 'none'}")


def checkpoints(total: int):
    return (f"model_{total // 2}", f"model_{total}", "model_final")


def phase_train(work: str, name: str, config: str, opts, prefix: str, pointnet: bool, total: int,
                profile: int = 0) -> dict:
    """Train, evaluate and auto-resume one run; returns its summary.  With
    ``profile``, the first that many env steps of the training run are
    traced (``run_rl --profile``): the device's busy ms per env step and
    its idle share over the main loop."""
    root = osp.join(work, name)
    wd = osp.join(root, "0")  # run_rl appends the seed to --work-dir
    common = ["--work-dir", root, "--seed", "0", "--device", "cuda"]
    opts = list(opts) + ["train_cfg.warm_steps=512", "train_cfg.exp_logger_cfg.type=csv", "train_cfg.n_log=500",
                         f"train_cfg.n_checkpoint={total // 2}", "eval_cfg.save_video=False", "eval_cfg.num=2"]
    traced = ["--profile", str(profile)] if profile else []
    run_cli(config, common + traced + ["--cfg-options", *opts, f"train_cfg.total_steps={total}"],
            osp.join(work, f"{name}_train.log"), timeout=420)
    summary = read_summary(wd)
    if profile:
        busy_ms, _ = trace_busy_ms(osp.join(wd, "profile", "trace.json"))
        summary["device_busy_ms_per_env_step"] = busy_ms / profile
        summary["device_idle_share"] = 1.0 - busy_ms / profile * summary["env_steps_per_s"] / 1e3
    if not summary["device"].startswith("cuda"):
        fail(f"{name} ran on {summary['device']}")
    check_launches(name, "training", run_launches(summary), pointnet, TRAIN_KERNELS)
    voxel = config == VOXEL_CONFIG
    check_conv_launches(name, "training", summary, CONV_KERNELS if voxel else ())
    for ckpt in checkpoints(total):
        if not osp.isfile(osp.join(wd, "models", ckpt)):
            fail(f"{name}: checkpoint {ckpt} missing")
    rows = read_metrics(osp.join(wd, "logs", "metrics.csv"))
    if not any(r.get(f"train/{prefix}/critic_loss") for r in rows):
        fail(f"{name}: no train/{prefix}/critic_loss was logged")
    replay = summary["replay"]
    print(f"[{name}] train: {summary['steps']} env steps, {summary['grad_steps']} updates on "
          f"{summary['device_name']}; kernel launches {run_launches(summary)}; replay {replay}", flush=True)

    run_cli(config, common + ["--evaluation", "--resume-from", osp.join(wd, "models", "model_final"),
                              "--cfg-options", *opts], osp.join(work, f"{name}_eval.log"), timeout=180)
    ev = read_summary(wd)
    if not ev["eval"] or not all(math.isfinite(v) for v in ev["eval"].values()):
        fail(f"{name}: evaluation returned {ev['eval']}")
    check_launches(name, "evaluation", ev["launches"], pointnet, ["pointnet_fused_fwd_max"])
    check_conv_launches(name, "evaluation", ev, ["conv3d_fprop_kernel"] if voxel else ())
    if ev["bwd_launches"][BWD_KERNEL] != 0:
        fail(f"{name}: the evaluation launched the winner backward {ev['bwd_launches'][BWD_KERNEL]} times")
    print(f"[{name}] eval from model_final: {ev['eval']}", flush=True)

    # a cold resume refills min(warm-up, 200) = 200 steps with the policy
    # first: 50 per env worker, one whole 50-step episode each, so the
    # recurrent run has windows to draw
    run_cli(config, common + ["--auto-resume", "--cfg-options", *opts, f"train_cfg.total_steps={total + 200}"],
            osp.join(work, f"{name}_resume.log"), timeout=180)
    rs = read_summary(wd)
    if rs["resume_steps"] != total or rs["steps"] != total + 200:
        fail(f"{name}: auto-resume went from {rs['resume_steps']} to {rs['steps']}, expected {total} -> {total + 200}")
    print(f"[{name}] auto-resume: model_{total} -> {rs['steps']} env steps", flush=True)
    summary["models_dir"] = osp.join(wd, "models")
    return summary


def env_frames(env_cfg: dict, n: int, seed: int) -> dict:
    """``n`` observations of the environment under random actions, stacked."""
    import numpy as np

    from pointcloud_rl_torch.env import build_env

    env = build_env(env_cfg)
    env.seed(seed)
    frames = [env.reset()]
    while len(frames) < n:
        o, _, done, _ = env.step(env.action_space.sample())
        frames.append(env.reset() if done else o)
    env.close()
    return {k: np.stack([f[k] for f in frames]) for k in frames[0]}


def resolved_agent_cfg(config: str, opts):
    """(agent config with the run's ``agent_cfg.`` options, env info, env config)."""
    from pointcloud_rl_torch.apis.run_rl import load_config, resolve_agent_placeholders
    from pointcloud_rl_torch.config import DictAction
    from pointcloud_rl_torch.env import get_env_info

    agent_opts = {k: DictAction._parse_value(v) for k, v in (o.split("=", 1) for o in opts)
                  if k.startswith("agent_cfg.")}
    cfg = load_config(osp.join(REPO, config), agent_opts)
    env_cfg = dict(cfg["env_cfg"])
    info = get_env_info(env_cfg)
    resolve_agent_placeholders(cfg, info)
    return dict(cfg["agent_cfg"]), info, env_cfg


def eval_actions(agent, obs):
    """Eval-mode actions on ``obs``; a recurrent agent takes them as steps
    of ``REF_ENVS`` envs, its state threaded and reset for envs 0 and 2
    after the fourth step."""
    import numpy as np

    if not agent.model.is_recurrent:
        return agent.forward(obs, mode="eval")
    agent.reset_rnn_states()
    acts = []
    for t in range(REF_OBS // REF_ENVS):
        acts.append(agent.forward({k: v[t * REF_ENVS:(t + 1) * REF_ENVS] for k, v in obs.items()}, mode="eval"))
        if t == 3:
            agent.reset_rnn_states(np.array([[True], [False], [True], [False]]))
    return np.concatenate(acts)


def phase_reference(name: str, config: str, opts, models_dir: str, atol: float, total: int) -> float:
    """Each checkpoint of the run on the card (fused kernel) against the
    same checkpoint on the CPU (plain PyTorch body): eval-mode actions on
    ``REF_OBS`` of the environment's own observations."""
    import numpy as np

    from pointcloud_rl_torch.algorithms import build_agent
    from pointcloud_rl_torch.utils.checkpoint import load_checkpoint

    agent_cfg, info, env_cfg = resolved_agent_cfg(config, opts)
    obs = env_frames(env_cfg, REF_OBS, seed=1)
    agents = {device: build_agent(dict(agent_cfg, env_params=info, seed=0, device=device))
              for device in ("cuda", "cpu")}
    worst = 0.0
    for ckpt in checkpoints(total):
        acts = {}
        for device, agent in agents.items():
            agent.load_state_dict(load_checkpoint(osp.join(models_dir, ckpt), device))
            acts[device] = eval_actions(agent, obs)
        diff = np.abs(acts["cuda"] - acts["cpu"])
        if acts["cuda"].shape != (REF_OBS, info["action_shape"]) or not np.isfinite(acts["cuda"]).all():
            fail(f"actions of shape {acts['cuda'].shape} from {ckpt}")
        err = float(diff.max())
        how = f"{REF_OBS // REF_ENVS} steps of {REF_ENVS} envs" if agents["cpu"].model.is_recurrent else "one batch"
        print(f"[reference] {name} {ckpt}: card (kernel) vs CPU (plain) eval actions on {REF_OBS} env "
              f"observations ({how}): max abs diff {err:.3e} (limit {atol}); {int((diff > FLIP_ABS).sum())} of "
              f"{diff.size} elements differ by more than {FLIP_ABS}", flush=True)
        if err > atol:
            fail(f"{name} {ckpt}: card vs CPU eval actions differ by {err:.3e} > {atol}")
        worst = max(worst, err)
    return worst


# Card vs CPU, both f32: cuDNN / cuBLAS and the CPU's kernels sum in other
# orders, scatter-means add with atomics on the card, and LayerNorms divide
# by per-row stds: a few ulps per layer on O(1) features, 1e-4 absolute and
# relative on the forward; the gradients sum over the rows in other orders
# too, 1e-3 of each gradient's largest element.  (atol, rtol, gradient rtol)
ENC_TOL = (1e-4, 1e-4, 1e-3)
# VN at vn.py's widths is ill-conditioned in f32: VNLeakyReLU divides by
# |d|^2 + 1e-8 of learned directions that can be near 0, and each block
# feeds the next, so f32 rounding grows through the blocks.  On 8 clouds of
# this phase the CPU's f32 output is 4.7e-4 from its f64 output (scale 2.9,
# after the final LayerNorm) and its gradients 1.6e-3 of scale
# (``tools/vn_f32_gap.py``).  Card and CPU each sit about that far from
# f64, so their gap is up to twice it; the limits are ~3x.
VN_TOL = (3e-3, 3e-3, 1e-2)
# Phase 6: the encoders without a hand kernel, at the shapes their configs
# and algorithms give them (DrQ's 512 rows for the voxel CNN, SAC's 256 for
# the rest; NatureCNN and IMPALA at the shapes of tests/test_models.py).
# (name, config file or None, config overrides, input, batch, tolerances).
ENCODERS = [
    ("sparse_cnn_dense", "configs/_base_/net_sparse_conv_maniskill.py", {}, "cloud", 512, ENC_TOL),
    ("sparse_cnn_sparse", "configs/_base_/net_sparse_conv_maniskill.py", {"impl": "sparse"}, "cloud", 512, ENC_TOL),
    ("vn_pointnet", "configs/mfrl/sac/maniskill/vn.py", {}, "lattice_cloud", 256, VN_TOL),
    ("dmc_encoder", "configs/_base_/net_cnn_dmc.py", {}, ("rgb", 9, 84), 256, ENC_TOL),
    ("nature_cnn", None, dict(type="NatureCNN", in_channels=9, image_size=(84, 84), out_channels=256),
     ("rgb", 9, 84), 256, ENC_TOL),
    ("impala", None, dict(type="IMPALA", in_channel=3, num_pixels=64 * 64, out_feature_size=128),
     ("rgb", 3, 64), 256, ENC_TOL),
    ("pointnet_stn", "configs/_base_/net_pn_maniskill.py", {"feature_transform": [1, 2]}, "cloud", 256, ENC_TOL),
]
PLACEHOLDERS = {"pcd_all_channel": 8, "image_channels": 9, "image_size": (84, 84)}
PEAK_F32 = 67e12  # FLOP/s of plain f32 outside the tensor cores (H100 SXM datasheet)
GRAD_ROWS = 32  # rows of the batch whose features and parameter gradients are compared, card vs CPU


def encoder_cfg(path, overrides) -> dict:
    """The visual encoder config of ``path`` (placeholders filled as the
    env shapes fill them) with ``overrides``; or ``overrides`` alone."""
    if path is None:
        return dict(overrides)
    from pointcloud_rl_torch.config import Config

    cfg = dict(Config.fromfile(osp.join(REPO, path))["agent_cfg"]["actor_cfg"]["nn_cfg"]["visual_nn_cfg"])
    cfg = {k: PLACEHOLDERS.get(v, v) if isinstance(v, str) else v for k, v in cfg.items()}
    cfg.update(overrides)
    return cfg


def encoder_inputs(kind, B: int) -> dict:
    """CPU inputs: ``cloud``, B clouds of the voxel config's env (random
    actions); ``lattice_cloud``, those clouds on a 1/64 lattice, each point
    paired with its negation, so the mean is exactly 0 and every squared
    distance of VN's k-NN is exact on both devices (the neighbours, ties
    included, are the same); or seeded uint8 images ``(rgb, C, H)``."""
    import numpy as np
    import torch

    if isinstance(kind, tuple):
        _, c, hw = kind
        g = torch.Generator().manual_seed(5)
        return {"rgb": torch.randint(0, 256, (B, c, hw, hw), generator=g, dtype=torch.uint8)}
    from pointcloud_rl_torch.config import Config

    obs = env_frames(dict(Config.fromfile(osp.join(REPO, VOXEL_CONFIG))["env_cfg"]), B, seed=2)
    obs = {k: obs[k] for k in ("xyz", "rgb", "seg")}
    if kind == "lattice_cloud":
        half = obs["xyz"].shape[-1] // 2
        xyz = np.round(obs["xyz"][..., :half] * 64) / 64
        obs = {"xyz": np.concatenate([xyz, -xyz], -1).astype(np.float32),
               **{k: np.concatenate([obs[k][..., :half]] * 2, -1) for k in ("rgb", "seg")}}
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in obs.items()}


def sparse_needed_flop(net, obs) -> int:
    """FLOP of the sparse path's products that these inputs need: the stem,
    2 * C_in * C_out per (valid output site, tap) that finds a valid input
    voxel, and the final Dense.  (The implementation multiplies every slot
    of the table by every tap, valid or not.)"""
    import torch

    from pointcloud_rl_torch.models.pointnet import preprocess_pointcloud
    from pointcloud_rl_torch.ops.sparse_conv import _coord_key, downsample_sites, tap_offsets
    from pointcloud_rl_torch.ops.voxelize import INT32_MAX, voxelize_sparse

    with torch.no_grad():
        feature = preprocess_pointcloud(obs)
        B, N, c = feature.shape
        spec = net.MLP_0.spec
        flop = 2 * B * N * sum(a * b for a, b in zip(spec[:-1], spec[1:]))
        cap = net.sparse_capacity or N
        _, coords, valid = voxelize_sparse(feature[..., :3], feature[..., :1], net.voxel_size, cap)
        c_in = spec[-1]
        for c_out in net.widths:
            out_c, out_v = downsample_sites(coords, valid, net.stride, cap)
            sorted_key = torch.where(valid, _coord_key(coords), INT32_MAX).sort(dim=1).values
            hits = torch.zeros((), dtype=torch.long, device=coords.device)
            for off in tap_offsets(net.kernel_size, coords.device):
                q = _coord_key(out_c * net.stride + off)
                pos = torch.searchsorted(sorted_key, q).clamp(0, cap - 1)
                hits += ((sorted_key.gather(1, pos) == q) & out_v).sum()
            flop += 2 * c_in * c_out * int(hits)
            coords, valid, c_in = out_c, out_v, c_out
        return flop + 2 * B * c_in * net.out_channels


def card_flops(fn, *args) -> float:
    """``estimate_flops(fn, *args)`` on the card, with the products of the
    port's conv3d kernels added: they run through ctypes, where
    ``FlopCounterMode`` sees no op.  Each call counts as ``F.conv3d`` or
    ``convolution_backward`` would: 2 x (output or dy) elements x C_in k^3."""
    from pointcloud_rl_torch.ops import conv as tconv
    from pointcloud_rl_torch.utils.flops import estimate_flops

    tally = [0]
    kernels = tconv._fprop, tconv._dgrad, tconv._wgrad

    def fprop(x, weight, *rest):
        out = kernels[0](x, weight, *rest)
        tally[0] += 2 * out.numel() * weight[0].numel()
        return out

    def of_grad(kernel):
        def call(grad, x, weight, *rest):
            tally[0] += 2 * grad.numel() * weight[0].numel()
            return kernel(grad, x, weight, *rest)
        return call

    tconv._fprop, tconv._dgrad, tconv._wgrad = fprop, of_grad(kernels[1]), of_grad(kernels[2])
    try:
        flop = estimate_flops(fn, *args)
    finally:
        tconv._fprop, tconv._dgrad, tconv._wgrad = kernels
    return flop + tally[0]


def encoder_bounds(flop: int, nbytes: int) -> dict:
    mem = nbytes / PEAK_BYTES
    return {"flop": flop, "bytes": nbytes, "bound_f32_ms": 1e3 * max(flop / PEAK_F32, mem),
            "bound_tf32_ms": 1e3 * max(flop / PEAK_TF32, mem)}


def phase_encoders(card: str) -> list:
    import copy

    import torch

    from pointcloud_rl_torch.models import build_all

    results = []
    for name, path, overrides, kind, B, (atol, rtol, grad_rtol) in ENCODERS:
        cfg = encoder_cfg(path, overrides)
        cpu_net = build_all(cfg, generator=torch.Generator().manual_seed(0))
        net = copy.deepcopy(cpu_net).cuda()
        obs_cpu = encoder_inputs(kind, B)
        obs = {k: v.cuda() for k, v in obs_cpu.items()}
        # the card's forward on the whole batch; its first rows against the CPU's
        with torch.no_grad():
            got = net(obs)
        rows = {k: v[:GRAD_ROWS] for k, v in obs_cpu.items()}
        want = cpu_net(rows)
        out_dim = want.shape[-1]
        err = check_close(f"{name} forward, card vs CPU", got[:GRAD_ROWS].cpu(), want.detach(), atol, rtol)
        # parameter gradients of a fixed weighted sum of those rows' features
        w = torch.randn((B, out_dim), generator=torch.Generator().manual_seed(6))
        (want * w[:GRAD_ROWS]).sum().backward()
        (net({k: v.cuda() for k, v in rows.items()}) * w[:GRAD_ROWS].cuda()).sum().backward()
        worst = 0.0
        for (pname, a), b in zip(net.named_parameters(), cpu_net.parameters()):
            rel = float((a.grad.cpu() - b.grad).abs().max()) / (float(b.grad.abs().max()) + 1e-12)
            if not math.isfinite(rel) or rel > grad_rtol:
                fail(f"{name} gradient of {pname}: card vs CPU max-err/scale {rel:.3e} > {grad_rtol}")
            worst = max(worst, rel)
        del cpu_net, want, got
        w = w.cuda()

        def fwd_bwd():
            net.zero_grad(set_to_none=True)
            (net(obs) * w).sum().backward()

        with torch.no_grad():
            fwd_ms = time_ms(lambda: net(obs), iters=10)
        step_ms = time_ms(fwd_bwd, iters=10)
        with torch.no_grad():
            fwd_flop = card_flops(net, obs)
        step_flop = card_flops(fwd_bwd)
        in_bytes = sum(v.numel() * v.element_size() for v in obs.values())
        p_bytes = sum(p.numel() * 4 for p in net.parameters())
        out_bytes = B * out_dim * 4
        rec = {"name": name, "type": cfg["type"], "batch": B,
               "input": {k: list(v.shape) for k, v in obs.items()}, "max_abs_err": err,
               "grad_max_err_over_scale": worst, "fwd_ms": fwd_ms, "fwd_bwd_ms": step_ms,
               "fwd": encoder_bounds(fwd_flop, in_bytes + p_bytes + out_bytes),
               "fwd_bwd": encoder_bounds(step_flop, in_bytes + 2 * p_bytes + out_bytes)}
        if cfg.get("impl") == "sparse":
            need = sparse_needed_flop(net, obs)
            rec["fwd_needed"] = encoder_bounds(need, in_bytes + p_bytes + out_bytes)
            rec["fwd_bwd_needed"] = encoder_bounds(3 * need, in_bytes + 2 * p_bytes + out_bytes)
        results.append(rec)
        f, fb = rec["fwd"], rec["fwd_bwd"]
        print(f"[encoders] {name} ({cfg['type']}) B={B} {rec['input']}: card vs CPU forward max abs err "
              f"{err:.3e}, gradients max-err/scale {worst:.3e}; fwd {fwd_ms:.3f} ms ({f['flop']:.3e} FLOP, bound "
              f"f32 {f['bound_f32_ms']:.3f} / TF32 {f['bound_tf32_ms']:.3f} ms), fwd+bwd {step_ms:.3f} ms "
              f"({fb['flop']:.3e} FLOP, bound f32 {fb['bound_f32_ms']:.3f} / TF32 {fb['bound_tf32_ms']:.3f} ms)"
              + (f"; needed by these inputs {rec['fwd_needed']['flop']:.3e} FLOP fwd" if "fwd_needed" in rec else "")
              + f" on {card}", flush=True)
        del net, obs, w
        torch.cuda.empty_cache()
    print(json.dumps({"encoders": results}), flush=True)
    return results


# Phase 7.  The GRU at the recurrent update's windows: 64 x (8 + 1) steps
# of the PointNet feature (128) and the robot state (32).
GRU_SHAPE = (64, 9, 160)
GRU_HIDDEN = 128
# Card vs CPU after one update (or six optimizer steps) from one state:
# where a gradient element is ~0, f32 noise can flip the sign of Adam's
# first bias-corrected step (+-lr whatever |g|), so an element may differ
# by up to 2 lr; a fault moves most elements (tests/test_torch_sac.py).
UPDATE_METRIC_RTOL = 1e-3
OPTIMIZER_TOL = (1e-5, 1e-6)  # (rtol, atol): six steps of f32 elementwise updates
DISCRETE_CFG = dict(  # discrete SAC on a flat state (no env of the repo's configs is discrete)
    type="SAC", batch_size=256, env_params=dict(is_discrete=True, obs_shape=32, action_shape=6, action_space=None),
    actor_cfg=dict(type="DiscreteActor", head_cfg=dict(type="DiscreteBaseHead"),
                   nn_cfg=dict(type="LinearMLP", norm_cfg=None, mlp_spec=[32, 1024, 1024, 6], inactivated_output=True),
                   optim_cfg=dict(type="Adam", lr=1e-3)),
    critic_cfg=dict(type="DiscreteCritic", num_heads=2,
                    nn_cfg=dict(type="LinearMLP", norm_cfg=None, mlp_spec=[32, 1024, 1024, 6],
                                inactivated_output=True),
                    optim_cfg=dict(type="Adam", lr=1e-3)),
)
OPTIMIZERS = {
    "adam": dict(type="Adam", lr=1e-3, betas=(0.5, 0.999)),
    "adam_weight_decay": dict(type="Adam", lr=1e-3, weight_decay=0.1),
    "adamw": dict(type="AdamW", lr=1e-3, weight_decay=0.05),
    "sgd_nesterov": dict(type="SGD", lr=0.05, momentum=0.9, nesterov=True),
    "sgd": dict(type="SGD", lr=0.05),
    "rmsprop": dict(type="RMSprop", lr=1e-3, momentum=0.5),
    "adam_clipped": dict(type="Adam", lr=1e-3, max_grad_norm=1.0),
}


def compare_agents(name: str, cpu_agent, gpu_agent, cpu_metrics: dict, gpu_metrics: dict, lr: float,
                   metric_rtol: float = UPDATE_METRIC_RTOL) -> dict:
    """Metrics of one update to ``metric_rtol``; every parameter inside
    the Adam envelope and >90% of each tensor's elements within 1e-4."""
    metric_gap = 0.0
    for key, want in cpu_metrics.items():
        got = gpu_metrics[key]
        if not math.isfinite(got) or abs(got - want) > metric_rtol * (1 + abs(want)):
            fail(f"{name}: {key} card {got} vs CPU {want}")
        metric_gap = max(metric_gap, abs(got - want) / (1 + abs(want)))
    envelope, worst, tight = 2 * lr * 1.01, 0.0, 1.0
    for which in ("model", "target"):
        gpu_sd = getattr(gpu_agent, which).state_dict()
        for pname, want in getattr(cpu_agent, which).state_dict().items():
            diff = (gpu_sd[pname].cpu() - want).abs()
            share = float((diff < 1e-4).float().mean())
            if float(diff.max()) > envelope or share <= 0.9:
                fail(f"{name}: {which}.{pname} card vs CPU max diff {float(diff.max()):.3e}, {share:.2%} tight")
            worst, tight = max(worst, float(diff.max())), min(tight, share)
    return {"name": name, "metrics_checked": len(cpu_metrics), "metric_max_rel_diff": metric_gap,
            "param_max_abs_diff": worst, "least_tight_share": tight}


def twin_agents(cfg: dict):
    """The same agent on the CPU and on the card, from one state dict."""
    from pointcloud_rl_torch.algorithms import build_agent

    cpu = build_agent(dict(cfg, seed=0, device="cpu"))
    gpu = build_agent(dict(cfg, seed=0, device="cuda"))
    gpu.load_state_dict({k: v for k, v in cpu.state_dict().items() if not k.startswith("generator")})
    return cpu, gpu


class _Batch:
    """A memory whose ``sample`` returns one fixed host batch."""

    def __init__(self, batch):
        self.batch = batch

    def sample(self, batch_size):
        return dict(self.batch)


def phase_modules(card: str) -> list:
    import copy

    import numpy as np
    import torch

    from pointcloud_rl_torch.algorithms import ddpg as ddpg_mod
    from pointcloud_rl_torch.algorithms.optim import Optimizer
    from pointcloud_rl_torch.models import build_all

    results = []
    # -- the GRU, forward and backward, card vs CPU, and its time on the card
    B, T, D = GRU_SHAPE
    g = torch.Generator().manual_seed(7)
    cpu_gru = build_all(dict(type="GRU", hidden_size=GRU_HIDDEN, in_features=D), generator=g)
    gru = copy.deepcopy(cpu_gru).cuda()
    x, w = torch.randn((B, T, D), generator=g), torch.randn((B, T, GRU_HIDDEN), generator=g)
    xc, xg = x.clone().requires_grad_(True), x.cuda().requires_grad_(True)
    want = cpu_gru(xc)
    (want * w).sum().backward()
    got = gru(xg)
    (got * w.cuda()).sum().backward()
    atol, rtol, grad_rtol = ENC_TOL
    err = check_close("GRU forward, card vs CPU", got.detach().cpu(), want.detach(), atol, rtol)
    worst = 0.0
    for (pname, a), b in zip([("input", xg)] + list(gru.named_parameters()), [xc] + list(cpu_gru.parameters())):
        rel = float((a.grad.cpu() - b.grad).abs().max()) / (float(b.grad.abs().max()) + 1e-12)
        if not math.isfinite(rel) or rel > grad_rtol:
            fail(f"GRU gradient of {pname}: card vs CPU max-err/scale {rel:.3e} > {grad_rtol}")
        worst = max(worst, rel)
    xg = x.cuda()
    wg = w.cuda()

    def fwd_bwd():
        gru.zero_grad(set_to_none=True)
        (gru(xg) * wg).sum().backward()

    with torch.no_grad():
        fwd_ms = time_ms(lambda: gru(xg), iters=20)
    step_ms = time_ms(fwd_bwd, iters=20)
    flop = 2 * B * T * 3 * (D + GRU_HIDDEN) * GRU_HIDDEN  # six products per step
    results.append({"name": "gru", "shape": list(GRU_SHAPE), "hidden": GRU_HIDDEN, "max_abs_err": err,
                    "grad_max_err_over_scale": worst, "fwd_ms": fwd_ms, "fwd_bwd_ms": step_ms, "fwd_flop": flop,
                    "fwd_bound_f32_ms": 1e3 * flop / PEAK_F32})
    print(f"[modules] GRU {list(GRU_SHAPE)} -> {GRU_HIDDEN}: card vs CPU forward max abs err {err:.3e}, gradients "
          f"max-err/scale {worst:.3e}; fwd {fwd_ms:.3f} ms, fwd+bwd {step_ms:.3f} ms ({flop:.3e} FLOP fwd, f32 bound "
          f"{1e3 * flop / PEAK_F32:.4f} ms) on {card}", flush=True)
    del cpu_gru, gru

    # -- one discrete-SAC update at batch 256 (its update draws nothing)
    rs = np.random.RandomState(8)
    n = DISCRETE_CFG["batch_size"]
    batch = dict(obs=rs.randn(n, 32).astype(np.float32), next_obs=rs.randn(n, 32).astype(np.float32),
                 actions=rs.randint(0, 6, (n, 1)), rewards=rs.randn(n, 1).astype(np.float32),
                 dones=rs.rand(n, 1) < 0.1, episode_dones=np.zeros((n, 1), bool))
    cpu, gpu = twin_agents(DISCRETE_CFG)
    rec = compare_agents("discrete_sac", cpu, gpu, cpu.update_parameters(_Batch(batch), 0),
                         gpu.update_parameters(_Batch(batch), 0), lr=1e-3)
    results.append(rec)
    print(f"[modules] discrete SAC update, batch {n}, card vs CPU: {rec}", flush=True)

    # -- one DDPG update at the SAC config's full width, on env observations,
    # TD3's smoothing noise injected on both sides
    agent_cfg, info, env_cfg = resolved_agent_cfg(SLICE_CONFIG, [FUSED, "agent_cfg.type=DDPG"])
    n = agent_cfg["batch_size"]
    frames = env_frames(env_cfg, 2 * n, seed=3)
    batch = dict(obs={k: v[:n] for k, v in frames.items()}, next_obs={k: v[n:] for k, v in frames.items()},
                 actions=rs.uniform(-1, 1, (n, info["action_shape"])).astype(np.float32),
                 rewards=rs.randn(n, 1).astype(np.float32), dones=rs.rand(n, 1) < 0.1,
                 episode_dones=np.zeros((n, 1), bool))
    noise = torch.randn((n, info["action_shape"]), generator=torch.Generator().manual_seed(9))
    draw = ddpg_mod.standard_normal
    ddpg_mod.standard_normal = lambda like, generator: noise.to(like.device)
    try:
        cpu, gpu = twin_agents(dict(agent_cfg, env_params=info))
        rec = compare_agents("ddpg", cpu, gpu, cpu.update_parameters(_Batch(batch), 0),
                             gpu.update_parameters(_Batch(batch), 0), lr=1e-3)
    finally:
        ddpg_mod.standard_normal = draw
    results.append(rec)
    print(f"[modules] DDPG update, batch {n} x 1200 x 8 (fused kernel on the card), card vs CPU: {rec}", flush=True)
    del cpu, gpu

    # -- six steps of each optimizer branch
    shapes = [(1024, 160), (1024,), (6, 1024)]
    for oname, ocfg in OPTIMIZERS.items():
        g = torch.Generator().manual_seed(10)
        init = [torch.randn(sh, generator=g) for sh in shapes]
        grads = [[torch.randn(sh, generator=g) * (3.0 if step % 2 else 0.1) for sh in shapes] for step in range(6)]
        out = {}
        for device in ("cpu", "cuda"):
            params = [p.clone().to(device) for p in init]
            opt = Optimizer(dict(ocfg), [(f"p{i}", p) for i, p in enumerate(params)])
            for step_grads in grads:
                opt.step([gr.to(device) for gr in step_grads])
            out[device] = params
        worst = 0.0
        for a, b in zip(out["cuda"], out["cpu"]):
            worst = max(worst, check_close(f"optimizer {oname}, card vs CPU", a.cpu(), b,
                                           OPTIMIZER_TOL[1], OPTIMIZER_TOL[0]))
        results.append({"name": f"optimizer_{oname}", "steps": 6, "max_abs_err": worst})
    print(f"[modules] optimizers {sorted(OPTIMIZERS)}: 6 steps card vs CPU, max abs err "
          f"{max(r['max_abs_err'] for r in results if r['name'].startswith('optimizer_')):.3e}", flush=True)
    print(json.dumps({"modules": results}), flush=True)
    return results


# ---------------------------------------------------------------- the DMC path
# The walker recipe (``pn_walker_tpu.py`` over ``pn.py``): dmc_walker_walk's
# defaults (``env/dmc.py``: 384 body + 128 ground points per frame, ground_eps
# 8e-3, max_depth 5.0, frame_skip 2, 84 x 84 renders from a camera of fovy
# 45), three stacked frames: xyz / rgb / pos_encoding [3, 1536], action dim 6.
WALKER_CONFIG = "configs/mfrl/sac/dm_control/pn_walker_tpu.py"
WALKER = dict(n_points=512, num_ground=128, ground_eps=8e-3, max_depth=5.0, image_size=(84, 84), fovy=45.0,
              frames=3, action_dim=6, envs=16, frame_skip=2, episode_length=1000)
DMC_SEED = 0
DMC_CYCLES = 20  # cycles of 16 env steps and 16 updates, after the config's 1000-step warm-up
DMC_PROFILED_CYCLES = 2  # more cycles, under torch.profiler: device busy ms and the idle share
# Module phase.  obs_fuse: the card and the CPU compute each point with the
# same separately rounded f32 multiplies and adds (``ops/obs_fuse.py``), so
# xyz should agree bitwise; the limit is 1e-5 absolute.  camera: one einsum,
# cuBLAS f32 (TF32 off) vs the CPU's, a few ulps of O(5 m) coordinates:
# 1e-5 absolute.  Sampling and fusion indices, rgb, seg: identical.
XYZ_ATOL = 1e-5
# A ground/body label flip between the card and the CPU counts as f32
# rounding when the point's height lies within this distance of the
# frame's threshold (a few ulps of the ~1 m heights); a flip farther away
# is a fault.  Frames with a rounding flip are counted and reported, and
# compared apart from the rest (their outputs may rightly differ).
FLIP_BAND = 1e-5


class WalkerRawStandIn:
    """A raw-render stand-in for ``dmc_walker_walk`` in ``obs_mode="raw"``:
    what ``DMCEnv.get_obs`` ships there (depth ``[1, H, W]`` f32, rgb
    ``[3, H, W]`` u8, the camera row ``[1, 1, 12]``), ray-cast with numpy from
    a procedural scene: the ground plane z = 0 seen from a camera pitched 25
    degrees down that tracks the body, a body of eight spheres (torso,
    pelvis, two thighs, shins and feet; the feet touch the ground) that the
    actions and a seeded jitter move, and sky beyond ``max_depth``.  It has
    the attributes ``ServerObsVectorEnv`` reads.  Nothing in the package
    uses it; it stands in for dm_control, which the card's machine lacks."""

    SPHERES = np.array([  # x, z offsets from the torso, radius
        [0.0, 1.15, 0.20], [0.0, 0.85, 0.16], [-0.10, 0.58, 0.11], [0.10, 0.58, 0.11],
        [-0.12, 0.30, 0.09], [0.12, 0.30, 0.09], [-0.14, 0.07, 0.07], [0.14, 0.07, 0.07]], np.float64)

    def __init__(self, obs_mode="raw", image_size=(84, 84), n_points=512, num_ground=128, ground_eps=8e-3,
                 max_depth=5.0, fovy=45.0, frame_skip=2, **kwargs):
        from pointcloud_rl_torch.env.spaces import Box

        assert obs_mode == "raw", obs_mode
        self.obs_mode = obs_mode
        self.image_size = np.asarray(image_size)
        self.n_points, self.num_ground, self.ground_eps = n_points, num_ground, ground_eps
        self.max_depth, self.frame_skip = max_depth, frame_skip
        self.z_to_world, self.fix_base_z = True, None
        self.action_space = Box(-np.ones(6, np.float32), np.ones(6, np.float32))
        w, h = int(self.image_size[0]), int(self.image_size[1])
        focal = 0.5 * h / np.tan(fovy * np.pi / 360.0)
        c = (self.image_size - 1) / 2.0
        self.inv_intrinsic = np.linalg.inv(np.array([[focal, 0, c[0]], [0, focal, c[1]], [0, 0, 1.0]]))
        pitch = np.deg2rad(25.0)
        fwd = np.array([0.0, np.cos(pitch), -np.sin(pitch)])
        right = np.array([1.0, 0.0, 0.0])
        self.cam_rot = np.stack([right, np.cross(fwd, right), fwd], axis=1)  # OpenCV camera -> world
        v, u = np.indices((h, w))
        uv1 = np.stack([u + 0.5, v + 0.5, np.ones((h, w))], -1).reshape(-1, 3)
        self._dirs = uv1 @ self.inv_intrinsic.T @ self.cam_rot.T  # world direction per unit depth
        self.rs = np.random.RandomState(0)

    def seed(self, seed):
        self.rs = np.random.RandomState(seed)
        self.action_space.seed(seed)

    def reset(self, **kwargs):
        self.x = 0.0
        self.pose = self.rs.uniform(-0.03, 0.03, (8, 2))
        return self.get_obs()

    def step(self, action):
        a = np.clip(np.asarray(action, np.float64), -1, 1)
        x0 = self.x
        for _ in range(self.frame_skip):
            self.x += 0.01 * (1.0 + a[0])
            self.pose = 0.9 * self.pose + 0.02 * np.repeat(a[1:5], 2)[:8, None] + self.rs.normal(0, 0.01, (8, 2))
        reward = 10.0 * (self.x - x0) - 1e-3 * float(a @ a)
        return self.get_obs(), reward, False, {}

    def render_ids(self):
        """Depth per pixel and what it hit: -1 sky, 0 ground, 1 + sphere."""
        cam = np.array([self.x, -2.2, 1.2])
        d = self._dirs
        depth = np.full(len(d), 10.0)
        hit = np.full(len(d), -1)
        down = d[:, 2] < 0
        t = np.where(down, -cam[2] / np.where(down, d[:, 2], -1.0), np.inf)
        depth = np.where(down, t, depth)
        hit[down] = 0
        centres = np.stack([self.x + self.SPHERES[:, 0] + self.pose[:, 0], np.zeros(8),
                            self.SPHERES[:, 1] + self.pose[:, 1]], -1)
        a = (d * d).sum(-1)
        for i, (c, r) in enumerate(zip(centres, self.SPHERES[:, 2])):
            oc = cam - c
            b = d @ oc
            disc = b * b - a * (oc @ oc - r * r)
            tt = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
            near = (disc > 0) & (tt > 0) & (tt < depth)
            depth[near], hit[near] = tt[near], i + 1
        h, w = int(self.image_size[1]), int(self.image_size[0])
        return depth.reshape(h, w).astype(np.float32), hit.reshape(h, w), cam

    def get_obs(self):
        depth, hit, cam = self.render_ids()
        h, w = depth.shape
        world = cam + self._dirs * depth.reshape(-1, 1)
        checker = ((np.floor(world[:, 0] * 4) + np.floor(world[:, 1] * 4)) % 2).reshape(h, w)
        rgb = np.empty((h, w, 3), np.uint8)
        rgb[:] = (120, 170, 230)  # sky
        ground = hit == 0
        rgb[ground] = np.where(checker[ground, None] > 0, (90, 110, 90), (60, 80, 60))
        body = hit > 0
        rgb[body] = np.stack([200 - 10 * hit[body], 120 + 5 * hit[body], 60 + 0 * hit[body]], -1)
        cm = np.zeros(12, np.float32)
        cm[:9] = self.cam_rot.reshape(-1)
        cm[9] = cam[2]
        return {"depth": depth[None], "rgb": np.ascontiguousarray(rgb.transpose(2, 0, 1)), "cam": cm.reshape(1, 1, 12)}

    def render(self, mode="rgb_array", **kwargs):
        return self.get_obs()["rgb"].transpose(1, 2, 0)

    def close(self):
        pass


def build_walker_standin(obs_mode="raw", stack_frame=1, horizon=None, **kwargs):
    """The wrapper chain ``make_gym_env`` builds, around the stand-in
    (registered in the port's env registry as ``WalkerRawStandIn``)."""
    from pointcloud_rl_torch.env.api import ExtendedEnv, FrameStackWrapper, TimeLimit

    env = WalkerRawStandIn(obs_mode=obs_mode, **kwargs)
    if stack_frame > 1:
        env = FrameStackWrapper(env, stack_frame)
    env = TimeLimit(env, horizon or (WALKER["episode_length"] + WALKER["frame_skip"] - 1) // WALKER["frame_skip"])
    env = ExtendedEnv(env)
    env.obs_mode = obs_mode
    return env


def walker_env_cfg() -> dict:
    from pointcloud_rl_torch.env.builder import ENVS

    if "WalkerRawStandIn" not in ENVS:
        ENVS.register_module(name="WalkerRawStandIn", module=build_walker_standin)
    return dict(type="WalkerRawStandIn", obs_mode="pointcloud", stack_frame=WALKER["frames"], server_obs=True,
                **{k: WALKER[k] for k in ("image_size", "n_points", "num_ground", "ground_eps", "max_depth",
                                          "fovy", "frame_skip")})


def walker_raw_frames(n_envs: int, seed: int):
    """``n_envs`` stand-in envs, each reset and stepped ``frames - 1`` times
    with seeded actions: depth [B, S, H, W], rgb [B, 3S, H, W], cam
    [B, S, 1, 12], hit ids [B, S, H, W] and camera positions [B, S, 3]."""
    rs = np.random.RandomState(seed)
    out = {k: [] for k in ("depth", "rgb", "cam", "hit", "pos")}
    for i in range(n_envs):
        env = WalkerRawStandIn(**{k: WALKER[k] for k in ("image_size", "n_points", "num_ground", "ground_eps",
                                                          "max_depth", "fovy", "frame_skip")})
        env.seed(seed * 1000 + i)
        frames = [env.reset()]
        ids = [env.render_ids()]
        for _ in range(WALKER["frames"] - 1):
            frames.append(env.step(rs.uniform(-1, 1, 6))[0])
            ids.append(env.render_ids())
        out["depth"].append(np.concatenate([f["depth"] for f in frames]))
        out["rgb"].append(np.concatenate([f["rgb"] for f in frames]))
        out["cam"].append(np.concatenate([f["cam"] for f in frames]))
        out["hit"].append(np.stack([h for _, h, _ in ids]))
        out["pos"].append(np.stack([c for _, _, c in ids]))
    inv_k = np.asarray(env.inv_intrinsic, np.float32)
    return {k: np.stack(v) for k, v in out.items()}, inv_k, env.cam_rot


def fusion_labels(depth, cam, inv_k):
    """Per-pixel heights z [B, S, HW], validity and the frame thresholds, as
    ``dmc_raw_to_pointcloud`` computes them (the same functions)."""
    import torch

    from pointcloud_rl_torch.ops.obs_fuse import _rotate, unproject_rays

    B, S, H, W = depth.shape
    cm = cam.reshape(B, S, 12).float()
    xyz = _rotate(unproject_rays(H, W, inv_k).reshape(H * W, 3) * depth.reshape(B, S, H * W, 1),
                  cm[..., :9].reshape(B, S, 3, 3))
    z = xyz[..., 2] + cm[..., 9, None]
    valid = (depth <= WALKER["max_depth"]).reshape(B, S, H * W)
    thr = torch.where(valid, z, torch.full_like(z, 1e9)).amin(-1, keepdim=True) + WALKER["ground_eps"]
    return z, valid, thr


def phase_dmc_modules(card: str) -> list:
    """The device point-cloud ops card vs CPU on the same inputs and the same
    draws, at the walker path's size, and their ms per call on the card."""
    import torch

    from pointcloud_rl_torch.ops import (fuse_camera_pointclouds, seg_balanced_downsample,
                                         uniform_downsample)
    from pointcloud_rl_torch.ops.obs_fuse import dmc_raw_to_pointcloud

    raw, inv_k, cam_rot = walker_raw_frames(WALKER["envs"], seed=DMC_SEED + 11)
    cpu = {k: torch.from_numpy(v) for k, v in raw.items()}
    gpu = {k: v.cuda() for k, v in cpu.items()}
    k_cpu = torch.from_numpy(inv_k)
    B, S, H, W = raw["depth"].shape
    g = torch.Generator().manual_seed(DMC_SEED + 12)
    draws = (torch.rand((B, S, H * W), generator=g), torch.rand((B, S, H * W), generator=g))
    kw = {k: WALKER[k] for k in ("n_points", "num_ground", "ground_eps", "max_depth")}
    results = []

    # -- dmc_raw_to_pointcloud, and the ground/body labels behind it
    want = dmc_raw_to_pointcloud(cpu["depth"], cpu["rgb"], cpu["cam"], k_cpu, draws=draws, z_to_world=True, **kw)

    def fuse():
        return dmc_raw_to_pointcloud(gpu["depth"], gpu["rgb"], gpu["cam"], k_cpu.cuda(),
                                     draws=tuple(d.cuda() for d in draws), z_to_world=True, **kw)

    got = {k: v.cpu() for k, v in fuse().items()}
    z_c, valid_c, thr_c = fusion_labels(cpu["depth"], cpu["cam"], k_cpu)
    z_g, valid_g, thr_g = (t.cpu() for t in fusion_labels(gpu["depth"], gpu["cam"], k_cpu.cuda()))
    flips = (valid_c & (z_c <= thr_c)) != (valid_g & (z_g <= thr_g))
    near = (z_c - thr_c).abs() <= FLIP_BAND
    if bool((flips & ~near).any()):
        fail(f"obs_fuse: {int((flips & ~near).sum())} ground/body labels differ card vs CPU away from the threshold")
    flip_frames = flips.any(-1)  # [B, S]
    P = WALKER["n_points"]
    ok = ~flip_frames[..., None].expand(B, S, P).reshape(B, 1, S * P)
    xyz_err = float(((got["xyz"] - want["xyz"]).abs() * ok).max())
    if xyz_err > XYZ_ATOL or not torch.equal(got["rgb"] * ok, want["rgb"] * ok) \
            or not torch.equal(got["pos_encoding"], want["pos_encoding"]):
        fail(f"obs_fuse card vs CPU: xyz max abs err {xyz_err:.3e} (limit {XYZ_ATOL}) or rgb / pos_encoding differ")
    bitwise = torch.equal(got["xyz"], want["xyz"])
    ground_share = float((valid_c & (z_c <= thr_c)).float().sum() / valid_c.float().sum())
    fuse_ms = time_ms(fuse, iters=20)
    rec = {"name": "dmc_raw_to_pointcloud", "shape": [B, S, H, W], "n_points": P, "max_abs_err": xyz_err,
           "xyz_bitwise_equal": bitwise, "label_flips": int(flips.sum()), "frames_with_flips": int(flip_frames.sum()),
           "valid_pixels_share": float(valid_c.float().mean()), "ground_share_of_valid": ground_share,
           "ms": fuse_ms}
    results.append(rec)
    print(f"[dmc-modules] dmc_raw_to_pointcloud {B} envs x {S} frames x {H}x{W} -> [{B}, 3, {S * P}]: card vs CPU "
          f"xyz max abs err {xyz_err:.3e} (bitwise equal: {bitwise}), rgb and pos_encoding identical; ground/body "
          f"label flips at the threshold {rec['label_flips']} in {rec['frames_with_flips']} frames (rule: a flip "
          f"counts as rounding within {FLIP_BAND} of the threshold, else fails); {fuse_ms:.3f} ms per call on {card}",
          flush=True)

    # -- fuse_camera_pointclouds: the three frames as three cameras of each env
    focal = 1.0 / inv_k[0, 0]
    K = torch.tensor([[focal, 0, (W - 1) / 2], [0, focal, (H - 1) / 2], [0, 0, 1]], dtype=torch.float32)
    pose = torch.eye(4).repeat(B, S, 1, 1)
    pose[..., :3, :3] = torch.from_numpy(cam_rot).float()
    pose[..., :3, 3] = cpu["pos"].float()
    rgbs = cpu["rgb"].reshape(B, S, 3, H, W).permute(0, 1, 3, 4, 2).contiguous()
    hit = cpu["hit"]
    segs = torch.stack([(hit == 1) | (hit == 2), hit >= 3], -1)  # torso + pelvis, legs
    c_args = (cpu["depth"], rgbs, K, pose, segs)
    g_args = tuple(a.cuda() for a in c_args)
    w_xyz, w_rgb, w_seg = fuse_camera_pointclouds(*c_args)
    g_xyz, g_rgb, g_seg = (t.cpu() for t in fuse_camera_pointclouds(*g_args))
    cam_err = check_close("fuse_camera_pointclouds xyz, card vs CPU", g_xyz, w_xyz, XYZ_ATOL, 0.0)
    if not (torch.equal(g_rgb, w_rgb) and torch.equal(g_seg, w_seg)):
        fail("fuse_camera_pointclouds: rgb or seg differ card vs CPU")
    cam_ms = time_ms(lambda: fuse_camera_pointclouds(*g_args), iters=20)
    results.append({"name": "fuse_camera_pointclouds", "shape": [B, S, H, W], "max_abs_err": cam_err, "ms": cam_ms})

    # -- the two downsamplers on the fused cloud (the CPU's, on both devices)
    N = S * H * W
    rank, order = torch.rand((B, N, 3), generator=g), torch.rand((B, N), generator=g)
    uni = torch.rand((B, N), generator=g)
    sb_kw = dict(n_points=P, min_pts=50, fg_pts=P - WALKER["num_ground"], ground_eps=1e-3)
    xg, sg = w_xyz.cuda(), w_seg.cuda()
    for name, fn_cpu, fn_gpu in (
            ("seg_balanced_downsample",
             lambda: seg_balanced_downsample(w_xyz, w_seg, draws=(rank, order), **sb_kw),
             lambda: seg_balanced_downsample(xg, sg, draws=(rank.cuda(), order.cuda()), **sb_kw)),
            ("uniform_downsample",
             lambda: uniform_downsample(w_xyz, P, draws=uni),
             lambda: uniform_downsample(xg, P, draws=uni.cuda()))):
        want_idx, got_idx = fn_cpu(), fn_gpu().cpu()
        if not torch.equal(got_idx, want_idx):
            fail(f"{name}: indices differ card vs CPU on {int((got_idx != want_idx).sum())} of {want_idx.numel()}")
        ms = time_ms(fn_gpu, iters=20)
        results.append({"name": name, "shape": [B, N, 3], "n_points": P, "indices_identical": True, "ms": ms})
    print(f"[dmc-modules] fuse_camera_pointclouds {B} envs x {S} cameras x {H}x{W}: card vs CPU xyz max abs err "
          f"{cam_err:.3e} (limit {XYZ_ATOL}), rgb and seg identical, {cam_ms:.3f} ms; seg_balanced_downsample and "
          f"uniform_downsample of [{B}, {N}, 3] to {P}: indices identical, "
          f"{results[-2]['ms']:.3f} / {results[-1]['ms']:.3f} ms per call on {card}", flush=True)
    print(json.dumps({"dmc_modules": results}), flush=True)
    return results


def walker_agent_cfg(config: str = WALKER_CONFIG):
    """(agent config of ``config``, ``pn_walker_tpu.py`` by default,
    resolved against the walker's obs shapes, env info, the config)."""
    from pointcloud_rl_torch.apis.run_rl import load_config, resolve_agent_placeholders
    from pointcloud_rl_torch.env.spaces import Box

    n = WALKER["n_points"] * WALKER["frames"]
    ones = np.ones(WALKER["action_dim"], np.float32)
    info = dict(obs_shape={"xyz": (3, n), "rgb": (3, n), "pos_encoding": (WALKER["frames"], n)},
                action_shape=WALKER["action_dim"], action_space=Box(-ones, ones), is_discrete=False)
    cfg = load_config(osp.join(REPO, config))
    resolve_agent_placeholders(cfg, info)
    return dict(cfg["agent_cfg"]), info, cfg


def profiled(fn, acts) -> tuple:
    """(host ms, device busy ms) of ``fn()`` under torch.profiler."""
    import torch

    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    busy = 0.0
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False) or "#" in evt.key:
            continue
        dt = getattr(evt, "self_device_time_total", None)
        if dt is None:
            dt = evt.self_cuda_time_total
        if dt and evt.device_type is not None and "CUDA" in str(evt.device_type):
            busy += dt / 1e3
    return host, busy


def phase_dmc(pf, card: str) -> dict:
    """The walker recipe on the card: raw stand-in renders fused by the port's
    ``ServerObsVectorEnv``, the agent of ``pn_walker_tpu.py`` at full width
    on a ``DeviceReplayMemory`` of packed bf16 features, collection and
    updates through the calls ``train_rl`` makes."""
    import torch

    from pointcloud_rl_torch.algorithms import build_agent
    from pointcloud_rl_torch.env import build_replay, build_rollout
    from pointcloud_rl_torch.env.server_env import ServerObsVectorEnv
    from pointcloud_rl_torch.utils.tree_ops import tree_leaves

    agent_cfg, info, cfg = walker_agent_cfg()
    train_cfg = dict(cfg["train_cfg"])
    n_steps, n_updates, warm = train_cfg["n_steps"], train_cfg["n_updates"], train_cfg["warm_steps"]
    rollout_cfg = dict(cfg["rollout_cfg"], env_cfg=walker_env_cfg(), base_seed=DMC_SEED, vec_backend="thread",
                       device="cuda")
    t0 = time.monotonic()
    rollout = build_rollout(rollout_cfg)
    try:
        server = rollout.vec_env.vec_env
        if not (isinstance(server, ServerObsVectorEnv) and server.device.type == "cuda"):
            fail(f"dmc: the rollout's vec env is {type(server).__name__}, not a ServerObsVectorEnv on cuda")
        obs = rollout.recent_obs
        shapes = {k: tuple(v.shape[1:]) for k, v in obs.items()}
        if shapes != info["obs_shape"] or obs["rgb"].dtype != np.uint8:
            fail(f"dmc: fused obs shapes {shapes}, expected {info['obs_shape']}")
        agent = build_agent(dict(agent_cfg, env_params=info, seed=DMC_SEED, device="cuda"))
        replay = build_replay(cfg["replay_cfg"], dict(seed=DMC_SEED), device=agent.device)
        spec = agent.obs_transfer
        print(f"[dmc] {WALKER_CONFIG}: {type(agent).__name__} ({agent.num_params:,} params, bf16, fused PointNet "
              f"{agent_cfg['actor_cfg']['nn_cfg']['visual_nn_cfg']['mlp_spec']} -> "
              f"{agent_cfg['actor_cfg']['nn_cfg']['visual_nn_cfg']['out_channels']}), batch {agent.batch_size}; "
              f"obs transfer {spec}; {rollout.num_envs} stand-in envs behind ServerObsVectorEnv(num_frames="
              f"{server.num_frames}) on {server.device}; set-up {time.monotonic() - t0:.1f} s", flush=True)
        reset_counters()
        t_warm = time.monotonic()
        rollout.forward_with_policy(None, warm, replay)
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t_warm
        storage = replay.storage
        if not (type(replay).__name__ == "DeviceReplayMemory" and replay.device.type == "cuda"
                and set(storage["obs"]) == {"pcd"} and storage["obs"]["pcd"].dtype == torch.bfloat16):
            fail(f"dmc: the replay is {type(replay).__name__} on {replay.device}, obs "
                 f"{ {k: (tuple(v.shape), v.dtype) for k, v in storage['obs'].items()} }")
        storage_gb = sum(x.nbytes for x in tree_leaves(storage)) / 1e9
        updates, vecs = 0, []

        def collect():  # one collection cycle, then its updates, as train_rl runs them without the hook
            agent.eval()
            rollout.forward_with_policy(agent, n_steps, replay)

        def update():  # one program of the cycle's updates; the metrics stay on the card
            nonlocal updates
            agent.train()
            vecs.append(agent.update_parameters_scan(replay, n_updates))
            updates += n_updates

        collect_s = update_s = 0.0
        t_loop = time.monotonic()
        for _ in range(DMC_CYCLES):
            t1 = time.monotonic()
            collect()
            t2 = time.monotonic()
            update()
            t3 = time.monotonic()
            collect_s, update_s = collect_s + t2 - t1, update_s + t3 - t2
        torch.cuda.synchronize()
        loop_s = time.monotonic() - t_loop
        acts = torch.profiler.ProfilerActivity
        prof = {"collect": [0.0, 0.0], "update": [0.0, 0.0]}  # host ms, device busy ms
        for _ in range(DMC_PROFILED_CYCLES):
            for part, fn in (("collect", collect), ("update", update)):
                host, busy = profiled(fn, acts)
                prof[part][0] += host
                prof[part][1] += busy
        torch.cuda.synchronize()
        launches = launched(pf)
    finally:
        rollout.close()
    for kname in TRAIN_KERNELS:
        if launches[kname] <= 0:
            fail(f"{kname} was never launched by the dmc run")
    if not bool(torch.isfinite(torch.stack(vecs)).all()):
        fail("dmc: non-finite update metrics")
    metrics = agent.reduce_metric_vecs(torch.stack(vecs).sum(0), updates)  # the one fetch, as at log time
    cycles = DMC_CYCLES + DMC_PROFILED_CYCLES
    busy_update = prof["update"][1] / (DMC_PROFILED_CYCLES * n_updates)
    busy_cycle = (prof["collect"][1] + prof["update"][1]) / DMC_PROFILED_CYCLES
    wall_cycle = 1e3 * loop_s / DMC_CYCLES
    rec = {
        "name": "dmc", "config": WALKER_CONFIG, "envs": rollout.num_envs, "warm_steps": warm,
        "cycles": cycles, "updates": updates, "env_steps": warm + cycles * n_steps,
        "launches": launches, "replay_storage_gb": storage_gb, "warm_up_s": warm_s,
        "updates_per_s": DMC_CYCLES * n_updates / loop_s, "env_steps_per_s": DMC_CYCLES * n_steps / loop_s,
        "collect_ms_per_cycle": 1e3 * collect_s / DMC_CYCLES, "update_ms_per_update": 1e3 * update_s / (DMC_CYCLES * n_updates),
        "device_busy_ms_per_update": busy_update,
        "device_busy_ms_per_collection": prof["collect"][1] / DMC_PROFILED_CYCLES,
        "device_idle_share": 1.0 - busy_cycle / wall_cycle,
        "profiled_host_ms_per_cycle": (prof["collect"][0] + prof["update"][0]) / DMC_PROFILED_CYCLES,
        "critic_loss_mean": metrics["sac/critic_loss"], "programs": program_stats(agent),
    }
    print(f"[dmc] trained {updates} updates over {rec['env_steps']} env steps ({warm} warm-up, then {cycles} cycles "
          f"of {n_steps} env steps + {n_updates} updates); kernel launches {launches}; replay "
          f"{storage_gb:.2f} GB on the card", flush=True)
    print(f"[dmc] {rec['updates_per_s']:.1f} updates/s and {rec['env_steps_per_s']:.1f} env steps/s over "
          f"{DMC_CYCLES} unprofiled cycles ({wall_cycle:.1f} ms per cycle: collection {rec['collect_ms_per_cycle']:.1f}, "
          f"updates {rec['update_ms_per_update']:.2f} ms each); device busy {busy_update:.2f} ms per update and "
          f"{rec['device_busy_ms_per_collection']:.2f} ms per collection; device idle {rec['device_idle_share']:.1%} "
          f"of the unprofiled cycle on {card}", flush=True)
    rec["reference"] = dmc_reference(agent, agent_cfg, info)
    return rec


def dmc_reference(agent, agent_cfg, info) -> dict:
    """The trained card agent (fused kernels, bf16) against the same state on
    the CPU (plain versions): eval actions on 32 fused observations, each
    side packing the act upload in float16 as its spec asks."""
    from pointcloud_rl_torch.algorithms import build_agent
    from pointcloud_rl_torch.env import build_vec_env

    env = build_vec_env(walker_env_cfg(), WALKER["envs"], base_seed=DMC_SEED + 100, vec_backend="thread",
                        device="cuda")
    try:
        first = env.reset()
        second = env.step(np.stack([env.single_action_space.sample() for _ in range(WALKER["envs"])]))[0]
    finally:
        env.close()
    obs = {k: np.concatenate([first[k], second[k]]) for k in first}
    cpu = build_agent(dict(agent_cfg, env_params=info, seed=DMC_SEED, device="cpu"))
    cpu.model.load_state_dict(agent.model.state_dict())
    want, got = cpu.forward(obs, mode="eval"), agent.forward(obs, mode="eval")
    diff = np.abs(got - want)
    if got.shape != (REF_OBS, info["action_shape"]) or not np.isfinite(got).all():
        fail(f"dmc: actions of shape {got.shape}")
    err = float(diff.max())
    flips = int((diff > FLIP_ABS).sum())
    print(f"[reference] dmc: card (kernel, bf16) vs CPU (plain, bf16) eval actions on {REF_OBS} fused observations, "
          f"float16 act upload on both: max abs diff {err:.3e} (limit {ACTION_ATOL_BF16}); {flips} of {diff.size} "
          f"elements differ by more than {FLIP_ABS}", flush=True)
    if err > ACTION_ATOL_BF16:
        fail(f"dmc: card vs CPU eval actions differ by {err:.3e} > {ACTION_ATOL_BF16}")
    return {"obs": REF_OBS, "max_abs_diff": err, "flips": flips, "limit": ACTION_ATOL_BF16}


DP_UPDATES = 20  # updates of each data-parallel run, each held to a 1-rank update from the same state
DP_TIMED = 10  # then updates in lockstep with nothing between them: ms per update
DP_CAPACITY = 2048
DP_FILL = (8, 128)  # pushes of 128 transitions before the updates
DP_CYCLES = (10, 4)  # then collection cycles of 4 transitions (the config's n_steps): the broadcast per cycle
DP_TOL = (2e-4, 2e-5)  # (rtol, atol) of tests/test_parallel.py: the mesh update against the single-device one
DP_FREE_RUN = (1, 2, 3, 5, 10, 20)  # updates after which the free runs of a world and of 1 rank are compared
DP_PROFILE_STEPS = 5
# Each of a world's DP_UPDATES updates is held to the 1-rank update from the
# same train state on the same global batch: the world's rank 0 keeps its
# state (and its replay's index generator) before every update, and the
# 1-rank process loads each one, takes one update and compares.  The two
# differ only in the order of their f32 sums, which Adam turns into up to a
# whole step (+-lr) on an element whose gradient is at the f32 noise floor:
# so all but DP_FLIPS elements of every update must lie within DP_TOL, and
# the update metrics within UPDATE_METRIC_RTOL.  The planted fault (the gloo
# ranks again from the same start, each drawing its update's noise for its
# own rows only) must fail the same check.  Two free runs (each from its own previous
# state) are only reported: Adam and the max-pool's winners make their
# difference grow after a few updates, as between any two f32 orders of one
# training.  On the H100 (PERF.md) an honest world left at most 9 elements
# of an update outside DP_TOL (4 NCCL ranks), the planted fault at least 483
# (its first update, where Adam's step is lr * sign(g)): DP_FLIPS sits near
# their geometric mean, 7x from each.
DP_FLIPS = 64  # elements of an update (of 6.2 M) that may lie outside DP_TOL


class DPStubRollout:
    """The lead's collection in the dp phase: seeded transitions at the SAC
    config's full width (1200 points, the env's obs shapes), pushed as a
    rollout pushes them; ``replicate_rollout`` broadcasts each push."""

    num_envs = 4
    pipeline_groups = 1

    def __init__(self, obs_shape, seed: int = 0):
        rs = np.random.RandomState(seed)
        n = DP_FILL[0] * DP_FILL[1] + DP_CYCLES[0] * DP_CYCLES[1]

        def obs():
            out = {}
            for k, shape in obs_shape.items():
                shape = (n,) + ((shape,) if isinstance(shape, int) else tuple(shape))
                out[k] = (rs.randint(0, 256, shape).astype(np.uint8) if k == "rgb"
                          else (rs.rand(*shape) < 0.3).astype(np.float32) if k == "seg"
                          else rs.randn(*shape).astype(np.float32))
            return out

        ends = (np.arange(n) % 50 == 49)[:, None]
        self.data = dict(obs=obs(), next_obs=obs(), actions=np.clip(rs.randn(n, 8), -1, 1).astype(np.float32),
                         rewards=rs.randn(n, 1).astype(np.float32), dones=ends, episode_dones=ends)
        self.at = 0

    def forward_with_policy(self, pi, num: int, replay=None, **kwargs):
        lo, self.at = self.at, self.at + num
        replay.push_batch({k: ({kk: vv[lo:self.at] for kk, vv in v.items()} if isinstance(v, dict) else v[lo:self.at])
                           for k, v in self.data.items()})
        return {}


def train_state_on_host(agent) -> dict:
    """The agent's whole train state (parameters, target, alpha, optimizers,
    update counter, generator), copied to the host."""
    import torch

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().clone()
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, list):
            return [host(v) for v in x]
        return x

    return host(agent.state_dict())


def param_gap(got: dict, want: dict) -> tuple:
    """(largest gap, its tensor, elements outside DP_TOL, elements) between
    two train states' parameters, target and alpha."""
    rtol, atol = DP_TOL
    worst, worst_key, n_out, total = 0.0, None, 0, 0
    for part in ("model", "target"):
        for key, x in got[part].items():
            y = want[part][key].double()
            err = (x.double() - y).abs()
            n_out += int((~(err <= atol + rtol * y.abs())).sum())  # a NaN counts as outside
            total += err.numel()
            if float(err.max()) > worst:
                worst, worst_key = float(err.max()), f"{part}.{key}"
    err = abs(float(got["log_alpha"]) - float(want["log_alpha"]))
    n_out += int(not err <= atol + rtol * abs(float(want["log_alpha"])))
    return worst, worst_key, n_out, total + 1


def metric_gap(got: dict, want: dict) -> float:
    return max(abs(x - want[k]) / (1 + abs(want[k])) for k, x in got.items())


def index_state(replay):
    """The state of the replay's index draws: a ``DeviceReplayMemory``'s
    generator, a host replay's sampler."""
    return replay.generator.get_state() if hasattr(replay, "generator") else replay.sampling.rng.get_state()


def set_index_state(replay, state) -> None:
    if hasattr(replay, "generator"):
        replay.generator.set_state(state)
    else:
        replay.sampling.rng.set_state(state)


def stepwise_gaps(agent, replay, w_steps: list, w_metrics: list) -> list:
    """Each of a world's updates against one update of this 1-rank agent
    from the world's state before it, on the same global batch."""
    out = []
    for u in range(len(w_metrics)):
        state, index_gen = w_steps[u]
        agent.load_state_dict(state)
        set_index_state(replay, index_gen)
        metrics = agent.update_parameters(replay, u + 1)
        out.append((u + 1, *param_gap(train_state_on_host(agent), w_steps[u + 1][0]),
                    metric_gap(w_metrics[u], metrics)))
    return out


def check_worlds(agent, replay, steps: list, worlds: dict) -> dict:
    """In the 1-rank process: each world's updates against one update of this
    agent from the world's state before it, and the free runs compared."""
    import torch

    out = {}
    for label, path in worlds.items():
        world = torch.load(path, weights_only=False)
        w_steps = torch.load(path + ".steps", weights_only=False)
        free = [(n, *param_gap(w_steps[n][0], steps[n][0])) for n in DP_FREE_RUN]
        out[label] = {"stepwise": stepwise_gaps(agent, replay, w_steps, world["metrics"]), "free": free}
    return out


def take_updates(agent, replay, rank: int, n: int = DP_UPDATES) -> tuple:
    """(metrics, states): ``n`` updates with the noise on; rank 0 keeps the
    train state and the replay's index draws before each update and after
    the last."""
    metrics, steps = [], []
    for u in range(n):
        if rank == 0:
            steps.append((train_state_on_host(agent), index_state(replay)))
        metrics.append(agent.update_parameters(replay, u + 1))
    if rank == 0:
        steps.append((train_state_on_host(agent), index_state(replay)))
    return metrics, steps


def fault_path(out_path: str) -> str:
    return out_path[:-len(".pt")] + "_fault.pt"


def dp_worker(mode: str, out_path: str) -> None:
    """One process of the dp phase (``--dp-worker MODE OUT``): ``gloo`` a
    rank on cuda:0 over gloo, ``nccl`` rank r on cuda:r over NCCL (a world
    of one included; more ranks join with ``init_distributed`` from the
    launcher environment), ``single`` the plain 1-rank agent.  Fills a
    ``DeviceReplayMemory`` through the lead's collection (replicated by
    ``replicate_rollout`` in a world), runs ``DP_UPDATES`` updates with the
    noise on, counting the fused kernels' launches and the rows of each,
    then ``DP_TIMED`` timed ones.  A gloo rank then goes back to its state
    before the first update and takes the same updates with a planted fault
    (its draws left unsharded), written to ``fault_path(OUT)``.  Rank 0
    writes its train state before each update beside each result
    (``.steps``); the 1-rank process checks the worlds named in
    ``DP_WORLDS`` against them."""
    import torch
    import torch.distributed as dist

    from pointcloud_rl_torch.algorithms import build_agent
    from pointcloud_rl_torch.env import build_replay
    from pointcloud_rl_torch.ops import pointnet_fused as pf
    from pointcloud_rl_torch.parallel import init_distributed, replicate_rollout, setup_data_parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    world = int(os.environ["WORLD_SIZE"])
    if mode == "gloo":  # gloo over CUDA tensors: two ranks on one card
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
                                world_size=world, rank=int(os.environ["RANK"]))
    elif mode == "nccl":
        torch.cuda.set_device(int(os.environ["RANK"]))
        if world == 1:  # init_distributed joins nothing for a world of one
            dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
                                    world_size=1, rank=0)
        elif not init_distributed(device="cuda"):
            fail("dp: init_distributed did not join the NCCL world from the environment")
    agent_cfg, info, _ = resolved_agent_cfg(SLICE_CONFIG, [FUSED])
    agent = build_agent(dict(agent_cfg, env_params=info, seed=0, device="cuda"))
    replay = build_replay(dict(type="DeviceReplayMemory", capacity=DP_CAPACITY), dict(seed=0), device=agent.device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    stub = DPStubRollout(info["obs_shape"]) if rank == 0 else None
    rollout, reduce_s = stub, []
    reduce_calls = [0]  # the all-reduce calls the update makes in Python (eager runs and captures)
    if mode != "single":
        dp = setup_data_parallel(agent, dist.get_world_size(), replay=replay)
        rollout = replicate_rollout(stub)
        reduce = dp.allreduce_grads

        def timed_reduce(grads):  # the gradient all-reduce of an optimizer step, host clock
            reduce_calls[0] += 1
            if agent._graphed():  # a capture may not sync: a graphed rank's all-reduces are timed from a trace
                return reduce(grads)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = reduce(grads)
            torch.cuda.synchronize()
            reduce_s.append(time.perf_counter() - t0)
            return out

        dp.allreduce_grads = timed_reduce
    for _ in range(DP_FILL[0]):
        rollout.forward_with_policy(None, DP_FILL[1], replay)
    broadcast_s = [rollout.forward_with_policy(None, DP_CYCLES[1], replay).get("_stats", {}).get("broadcast_time", 0.0)
                   for _ in range(DP_CYCLES[0])]

    rows: list = []
    launch = pf._forward_kernel

    def counted(x, params, compute_dtype, with_idx):
        rows.append(("pointnet_fused_fwd_idx" if with_idx else "pointnet_fused_fwd_max", int(x.shape[0])))
        return launch(x, params, compute_dtype, with_idx)

    start = (train_state_on_host(agent), index_state(replay))
    pf._forward_kernel = counted
    reset_counters()
    metrics, steps = take_updates(agent, replay, rank)
    launches = dict(pf.launch_counts)
    pf._forward_kernel = launch
    final = train_state_on_host(agent)

    del reduce_s[:]
    t_update = []
    for u in range(DP_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agent.update_parameters(replay, DP_UPDATES + u + 1)
        torch.cuda.synchronize()
        t_update.append(time.perf_counter() - t0)
    result = {"final": {k: final[k] for k in ("model", "target", "log_alpha")}, "metrics": metrics,
              "launches": launches, "rows": rows, "graphed": agent._graphed(),
              "ms_per_update": 1e3 * float(np.median(t_update)),
              "replay_len": len(replay), "allreduce_ms_per_update": 1e3 * sum(reduce_s) / DP_TIMED,
              "allreduce_calls_per_update": len(reduce_s) / DP_TIMED, "allreduce_python_calls": reduce_calls[0],
              "broadcast_ms_per_cycle": 1e3 * float(np.median(broadcast_s)),
              "backend": dist.get_backend() if dist.is_initialized() else None,
              "world": dist.get_world_size() if dist.is_initialized() else 1}
    if mode == "nccl":  # the collectives inside one replay of the one-update program, from a trace
        trace = collective_trace(lambda: agent.update_parameters_lazy(replay, 0),
                                 torch.profiler.ProfilerActivity)
        result.update(allreduce_ms_per_update=trace["nccl_ms"], allreduce_calls_per_update=trace["nccl_kernels"],
                      device_ms_per_update=trace["busy_ms"])
    if mode == "single":
        worlds = dict(w.split("=", 1) for w in os.environ["DP_WORLDS"].split(","))
        result["checks"] = check_worlds(agent, replay, steps, worlds)
    elif rank == 0:
        torch.save(steps, out_path + ".steps")
    if mode == "nccl":  # (b) the graphed rank against its eager twin, as the graphs phase holds them
        result["twins"] = dp_twins()
    torch.save(result, out_path)
    if mode == "gloo":  # (a') the planted fault, from the same start: each rank draws for its own rows only
        agent.load_state_dict(start[0])
        set_index_state(replay, start[1])
        dp.sharded_draws = contextlib.nullcontext
        f_metrics, f_steps = take_updates(agent, replay, rank)
        f_final = train_state_on_host(agent)
        torch.save({"final": {k: f_final[k] for k in ("model", "target", "log_alpha")}, "metrics": f_metrics},
                   fault_path(out_path))
        if rank == 0:
            torch.save(f_steps, fault_path(out_path) + ".steps")
    end_world(agent)


# (e) updates interleaved with collection on a world: the pipelined DrQ
# walker (the pipeline phase's run, pn_shift_tpu.py) at full width, its
# replay cut to INTERLEAVE_CAPACITY and its run to the warm-up and
# INTERLEAVE_CYCLES cycles (the first two hold the programs' eager runs and
# captures, the last runs under torch.profiler).
INTERLEAVE_CAPACITY = 20000
INTERLEAVE_CYCLES = 6


def interleave_worker(mode: str, out_path: str) -> None:
    """One process of dp (e) (``--interleave-worker MODE OUT``): ``gloo`` a
    rank on cuda:0 over gloo, ``nccl`` rank r on cuda:r over NCCL (N >= 2
    cards), ``single`` the agent outside a process group.  Rank 0 collects
    with the walker stand-in; ``train_rl`` runs the config's 1000 warm-up
    steps and ``INTERLEAVE_CYCLES`` cycles of 16 env steps with the 16
    updates interleaved (on a world, in lockstep with rank 0's collection).
    Writes the scans with the buffer each sampled, the final train state,
    the kernel launches and the cycles' times."""
    import torch
    import torch.distributed as dist

    from pointcloud_rl_torch.algorithms import build_agent
    from pointcloud_rl_torch.apis.train_rl import train_rl
    from pointcloud_rl_torch.env import build_replay, build_rollout
    from pointcloud_rl_torch.ops import pointnet_fused as pf
    from pointcloud_rl_torch.parallel import init_distributed, replicate_rollout, setup_data_parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    if mode == "gloo":
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
                                world_size=int(os.environ["WORLD_SIZE"]), rank=int(os.environ["RANK"]))
    elif mode == "nccl":
        torch.cuda.set_device(int(os.environ["RANK"]))
        if not init_distributed(device="cuda"):
            fail("dp (e): init_distributed did not join the NCCL world from the environment")
    rank = dist.get_rank() if dist.is_initialized() else 0
    agent_cfg, info, cfg = walker_agent_cfg(PIPELINE_CONFIG)
    train_cfg = dict(cfg["train_cfg"])
    n_steps, n_updates, warm = train_cfg["n_steps"], train_cfg["n_updates"], train_cfg["warm_steps"]
    agent = build_agent(dict(agent_cfg, env_params=info, seed=PIPE_SEED, device="cuda"))
    replay = build_replay(dict(cfg["replay_cfg"], capacity=INTERLEAVE_CAPACITY), dict(seed=PIPE_SEED),
                          device=agent.device)
    rollout = None
    if rank == 0:
        rollout = build_rollout(dict(cfg["rollout_cfg"], env_cfg=walker_env_cfg(), base_seed=PIPE_SEED,
                                     vec_backend="thread", device="cuda"))
    if dist.is_initialized():
        setup_data_parallel(agent, dist.get_world_size(), replay=replay)
        rollout = replicate_rollout(rollout)
    scans, vecs, cycles = [], [], []
    scan, collect = agent.update_parameters_scan, rollout.forward_with_policy
    acts = torch.profiler.ProfilerActivity

    def recorded_scan(memory, n):
        scans.append((len(memory), n))
        vec = scan(memory, n)
        vecs.append(vec)
        return vec

    def timed_collect(pi, num, replay=None, **kwargs):
        if pi is None:  # the warm-up
            return collect(pi, num, replay, **kwargs)
        if len(cycles) == INTERLEAVE_CYCLES - 1:
            box = {}
            host, busy = profiled(lambda: box.update(out=collect(pi, num, replay, **kwargs)), acts)
            cycles.append((host / 1e3, busy))
            return box["out"]
        t0 = time.perf_counter()
        out = collect(pi, num, replay, **kwargs)
        cycles.append((time.perf_counter() - t0, None))
        return out

    agent.update_parameters_scan, rollout.forward_with_policy = recorded_scan, timed_collect
    work = osp.join(osp.dirname(out_path), f"interleave_{mode}_{rank}")
    try:
        reset_counters()
        out = train_rl(agent, rollout, None, replay, work_dir=work, total_steps=warm + INTERLEAVE_CYCLES * n_steps,
                       warm_steps=warm, n_steps=n_steps, n_updates=n_updates, n_log=10 ** 9, n_eval=-1,
                       n_checkpoint=-1)
        torch.cuda.synchronize()
        launches = dict(pf.launch_counts)
    finally:
        rollout.close()
    final = train_state_on_host(agent)
    wall = float(np.mean([w for w, _ in cycles[2:-1]]))
    torch.save({"final": {k: final[k] for k in ("model", "target", "log_alpha")}, "scans": scans,
                "finite": bool(torch.isfinite(torch.stack(vecs)).all()), "launches": launches,
                "graphed": agent._graphed(), "grad_steps": out["grad_steps"], "warm": warm, "n_steps": n_steps,
                "n_updates": n_updates, "ms_per_cycle": 1e3 * wall, "updates_per_s": n_updates / wall,
                "device_busy_ms_per_cycle": cycles[-1][1], "device_idle_share": 1.0 - cycles[-1][1] / (1e3 * wall),
                "world": dist.get_world_size() if dist.is_initialized() else 1}, out_path)
    end_world(agent)


def dp_interleave(work: str, card: str, nccl_ranks: int) -> dict:
    """(e) The pipelined DrQ walker through ``train_rl`` as 2 gloo ranks on
    one card (eager), with ``nccl_ranks`` >= 2 as that many graphed NCCL
    ranks, and outside a process group: the ranks of a world bitwise equal
    at the end; every rank's scans, with the buffer each sampled, those of
    the agent outside a group (each cycle's 16 updates as one chunk after
    its act dispatch, on the buffer before its push); both kernels launched
    on every rank; updates/s and rank 0's idle share."""
    worlds = {"gloo": run_dp_workers(work, "gloo", 2, phase="interleave")}
    if nccl_ranks > 1:
        worlds["nccl"] = run_dp_workers(work, "nccl", nccl_ranks, phase="interleave")
    one, = run_dp_workers(work, "single", 1, phase="interleave")
    want = [(one["warm"] + c * one["n_steps"], one["n_updates"]) for c in range(INTERLEAVE_CYCLES)]
    if one["scans"] != want:
        fail(f"dp (e): the agent outside a group scanned {one['scans']}, expected {want}")
    rec = {"single": {k: one[k] for k in ("updates_per_s", "ms_per_cycle", "device_idle_share", "graphed")},
           "launches": dict(one["launches"])}
    for name, ranks in worlds.items():
        for r, res in enumerate(ranks):
            if res["scans"] != one["scans"] or not res["finite"] or res["grad_steps"] != one["grad_steps"]:
                fail(f"dp (e) {name} rank {r}: scans {res['scans']} (finite metrics {res['finite']}, "
                     f"{res['grad_steps']} updates), the agent outside a group {one['scans']}")
            if res["graphed"] != (name == "nccl"):
                fail(f"dp (e) {name} rank {r}: graphed {res['graphed']}")
            for kname in TPU_KERNELS:
                if res["launches"][kname] <= 0:
                    fail(f"dp (e) {name} rank {r}: {kname} was never launched")
        for r, res in enumerate(ranks[1:], 1):
            dp_bitwise(dict(res, metrics=None), dict(ranks[0], metrics=None), f"(e) {name} rank {r} vs rank 0")
        r0 = ranks[0]
        rec[name] = {"ranks": len(ranks), "updates_per_s": r0["updates_per_s"], "ms_per_cycle": r0["ms_per_cycle"],
                     "device_idle_share": r0["device_idle_share"], "graphed": r0["graphed"],
                     "launches": {k: sum(res["launches"][k] for res in ranks) for k in TPU_KERNELS}}
        print(f"[dp] (e) {PIPELINE_CONFIG} at full width (global batch 256, replay {INTERLEAVE_CAPACITY}), "
              f"{len(ranks)} {name} ranks ({'graphed' if r0['graphed'] else 'eager'}), {r0['warm']} warm-up steps then "
              f"{INTERLEAVE_CYCLES} cycles of {r0['n_steps']} env steps: every rank's {len(r0['scans'])} chunks of "
              f"{r0['n_updates']} on the buffer before its cycle's push ({[s for s, _ in r0['scans']]}), as outside "
              f"a group; the ranks bitwise equal; {r0['updates_per_s']:.1f} updates/s ({r0['ms_per_cycle']:.1f} ms "
              f"per cycle), rank 0's device idle {r0['device_idle_share']:.1%}; outside a group (graphed) "
              f"{one['updates_per_s']:.1f} updates/s, idle {one['device_idle_share']:.1%}; kernel launches per rank "
              f"{r0['launches']} on {card}", flush=True)
        for k in TPU_KERNELS:
            rec["launches"][k] += rec[name]["launches"][k]
    return rec


def end_world(agent) -> None:
    """Free every captured update program (NCCL frees a communicator only
    once no graph holds its collectives), then leave the process group."""
    import gc

    import torch.distributed as dist

    agent.drop_programs()
    gc.collect()  # the twins' programs, in reference cycles with their agents
    if dist.is_initialized():
        dist.destroy_process_group()


def collective_trace(fn, acts, n: int = 1) -> dict:
    """Per update of ``fn()`` (``n`` updates) under torch.profiler: the NCCL
    kernels and their device ms, and the device busy ms."""
    import torch

    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    nccl_ms = busy = 0.0
    kernels = 0
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False) or "#" in evt.key:
            continue
        dt = getattr(evt, "self_device_time_total", None)
        if dt is None:
            dt = evt.self_cuda_time_total
        if not dt or evt.device_type is None or "CUDA" not in str(evt.device_type):
            continue
        busy += dt / 1e3
        if "nccl" in evt.key.lower():
            nccl_ms += dt / 1e3
            kernels += evt.count
    return {"nccl_ms": nccl_ms / n, "nccl_kernels": kernels / n, "busy_ms": busy / n}


def dp_twins() -> dict:
    """(b) On an NCCL rank: the graphs phase's checks with both twins ranks
    of the world, the graphed one's all-reduces captured in its programs,
    the eager one's run eagerly: the walker recipe's scans of 16 and 3 at
    both gate phases and its act-fused forwards, the SAC slice's host
    batches, each bitwise; host and device ms per update, graphed against
    eager, and the NCCL kernels inside one replay of 16 updates."""
    import torch

    from pointcloud_rl_torch.ops import pointnet_fused as pf

    acts = torch.profiler.ProfilerActivity
    card = torch.cuda.get_device_name()
    rec: dict = {}
    rec["walker"], graphed, eager, replay = graphs_storage(pf, "dp walker", WALKER_CONFIG, card, acts, ranks=True)
    rec["act_fused"] = graphs_act_fused(pf, graphed, eager, replay, card, acts)
    n = GRAPH_FUSED_CHUNK
    rec["collectives"] = collective_trace(lambda: graphed.update_parameters_scan(replay, n), acts, n)
    del graphed, eager, replay
    torch.cuda.empty_cache()
    rec["host_batch"] = graphs_host_batch(pf, card, acts, ranks=True)
    return rec


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


DP_WORKER_TIMEOUT = 600  # seconds a world's processes may take: 4 NCCL ranks run the twins' checks too


def run_dp_workers(work: str, mode: str, n: int, extra_env=None, phase: str = "dp") -> list:
    """``n`` processes of ``dp_worker(mode)`` (``phase="hosts"``:
    ``hosts_worker(mode)``, each rank a host of its own in torchrun's
    variables), started together; their results."""
    import torch

    port = str(_free_port())
    procs, outs = [], []
    for rank in range(n):
        out = osp.join(work, f"{phase}_{mode}_{rank}.pt")
        log = open(osp.join(work, f"{phase}_{mode}_{rank}.log"), "w")
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE=str(n), RANK=str(rank),
                   OMP_NUM_THREADS="1", **(extra_env or {}))  # as run_rl's ranks: host threads of two ranks contend
        if phase == "hosts":
            env.update(GROUP_RANK=str(rank), LOCAL_RANK="0", LOCAL_WORLD_SIZE="1")
        procs.append((subprocess.Popen([sys.executable, osp.abspath(__file__), f"--{phase}-worker", mode, out],
                                       cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
                                       start_new_session=True), log))
        outs.append(out)
    for proc, log in procs:
        try:
            rc = proc.wait(timeout=DP_WORKER_TIMEOUT)
        except subprocess.TimeoutExpired:
            for p, _ in procs:
                os.killpg(p.pid, 9)
                p.wait()
            rc = "timeout"
        log.close()
        if rc != 0:
            tails = []
            for rank, (_, rank_log) in enumerate(procs):
                with open(rank_log.name) as f:
                    tails.append(f"--- rank {rank}:\n{f.read()[-2500:]}")
            fail(f"{phase} worker {mode} exited with {rc}:\n" + "\n".join(tails))
    return [torch.load(o, weights_only=False) for o in outs]


def dp_bitwise(a: dict, b: dict, name: str) -> None:
    """Two ranks' parameters, target, alpha and metrics must be bitwise equal."""
    import torch

    for part in ("model", "target"):
        for key, x in a["final"][part].items():
            if not torch.equal(x, b["final"][part][key]):
                fail(f"dp {name}: {part}.{key} is not bitwise equal")
    if not torch.equal(a["final"]["log_alpha"], b["final"]["log_alpha"]) or a["metrics"] != b["metrics"]:
        fail(f"dp {name}: log_alpha or the metrics differ")


def check_dp_launches(name: str, res: dict, rows_per_launch: int) -> None:
    """Exactly one critic encode (with the argmax) and one next-obs encode
    (max only) per update, each on this rank's rows.  An agent outside a
    process group, and an NCCL rank, replay captured graphs: the wrapper
    sees the launches of each program's eager run and of its capture, and
    a replay repeats the captured launches (``launch_counts`` counts them),
    so there every launch the wrapper sees must be on the rows, and of both
    kernels."""
    want = {"pointnet_fused_fwd_idx": DP_UPDATES, "pointnet_fused_fwd_max": DP_UPDATES}
    if res["launches"] != want:
        fail(f"dp {name}: kernel launches {res['launches']}, expected {want}")
    bad = [r for r in res["rows"] if r[1] != rows_per_launch]
    seen = len(res["rows"]) if not res["graphed"] else 2 * DP_UPDATES * (set(r[0] for r in res["rows"]) == set(want))
    if bad or seen != 2 * DP_UPDATES:
        fail(f"dp {name}: launches at {sorted(set(res['rows']))}, expected {rows_per_launch} rows each")


def report_world(label: str, checks: dict, tag: str = "dp") -> dict:
    """Print a world's gaps to 1 rank; ``agrees``: each update from the same
    state within DP_TOL but for DP_FLIPS elements, its metrics within
    UPDATE_METRIC_RTOL."""
    for n, worst, key, n_out, total in checks["free"]:
        print(f"[{tag}] {label}, free runs after {n} updates: largest gap to 1 rank {worst:.3e} ({key}); "
              f"{n_out} of {total} elements outside rtol {DP_TOL[0]} atol {DP_TOL[1]}", flush=True)
    step = checks["stepwise"]
    u, worst, key, _, total, _ = max(step, key=lambda s: s[1])
    n_out, most_out, least_out = sum(s[3] for s in step), max(s[3] for s in step), min(s[3] for s in step)
    over = sum(s[3] > DP_FLIPS for s in step)
    m = max(s[5] for s in step)
    agrees = most_out <= DP_FLIPS and m <= UPDATE_METRIC_RTOL
    print(f"[{tag}] {label}, each of {len(step)} updates against 1 rank from the same state: largest gap {worst:.3e} "
          f"({key}, update {u}); {n_out} elements outside rtol {DP_TOL[0]} atol {DP_TOL[1]} in {len(step)} x "
          f"{total} ({least_out} to {most_out} in one update, limit {DP_FLIPS}, {over} updates over it); "
          f"largest update-metric gap "
          f"{m:.3e} relative (limit {UPDATE_METRIC_RTOL}): {'agrees' if agrees else 'differs'}", flush=True)
    return {"agrees": agrees, "stepwise_max_gap": worst, "stepwise_outside_tol": n_out,
            "stepwise_outside_tol_per_update": [least_out, most_out], "updates_over_limit": over,
            "stepwise_metric_gap": m,
            "free_run": {n: {"max": w, "outside_tol": o} for n, w, _, o, _ in checks["free"]}}


def phase_dp(card: str, nccl_ranks: int = 1) -> dict:
    """Data parallel: (a) two ranks on cuda:0 over gloo against one rank,
    (b) ``nccl_ranks`` NCCL ranks, one per card (a world of one on one
    card), through the same path, (c) ``run_rl --profile`` on the SAC
    config, (d) with more than one card, ``run_rl --num-devices``; (a')
    the gloo ranks' planted fault against one rank."""
    import torch

    work = tempfile.mkdtemp(prefix="chip_smoke_dp_", dir=osp.join(REPO, "build"))
    try:
        t0 = time.monotonic()
        gloo = run_dp_workers(work, "gloo", 2)
        ranks = run_dp_workers(work, "nccl", nccl_ranks)
        fault = [torch.load(fault_path(osp.join(work, f"dp_gloo_{r}.pt")), weights_only=False) for r in (0, 1)]
        one, = run_dp_workers(work, "single", 1, {"DP_WORLDS": f"gloo={work}/dp_gloo_0.pt,nccl={work}/dp_nccl_0.pt,"
                                                                f"gloo_fault={fault_path(f'{work}/dp_gloo_0.pt')}"})
        runs_s = time.monotonic() - t0
        r0, nccl = gloo[0], ranks[0]
        print(f"[dp] ms per update (correctness runs; gloo stages through the host): world 1 "
              f"{one['ms_per_update']:.2f} (graphed), world 2 gloo {r0['ms_per_update']:.2f} / "
              f"{gloo[1]['ms_per_update']:.2f} (eager), world {nccl_ranks} NCCL {nccl['ms_per_update']:.2f} "
              f"({'graphed' if nccl['graphed'] else 'eager'}; PR 7's 4 eager NCCL ranks: 11.0 / 19.0); gradient "
              f"all-reduce {r0['allreduce_ms_per_update']:.2f} ms per update over "
              f"{r0['allreduce_calls_per_update']:.0f} calls (gloo, host clock), NCCL kernels inside one replay "
              f"{nccl['allreduce_ms_per_update']:.3f} device ms per update over {nccl['allreduce_calls_per_update']:.0f} "
              f"kernels ({nccl_ranks} ranks, of {nccl['device_ms_per_update']:.2f} device ms); transition broadcast "
              f"{r0['broadcast_ms_per_cycle']:.2f} ms per cycle of {DP_CYCLES[1]} (gloo), "
              f"{nccl['broadcast_ms_per_cycle']:.2f} (NCCL, {nccl_ranks} ranks); workers {runs_s:.1f} s on {card}",
              flush=True)
        if not all(res["graphed"] for res in ranks) or any(res["graphed"] for res in gloo) or not one["graphed"]:
            fail(f"dp: graphed NCCL {[res['graphed'] for res in ranks]}, gloo {[res['graphed'] for res in gloo]}, "
                 f"1 rank {one['graphed']}: NCCL ranks and 1 rank replay graphs, gloo ranks run eagerly")
        if nccl_ranks == 1:  # a world of one: the mean all-reduce is the identity
            dp_bitwise(nccl, one, "the graphed NCCL world of one vs the agent outside a process group")
        for i, res in enumerate(ranks):
            tw = res["twins"]
            print(f"[dp] (b) NCCL rank {i} of {nccl_ranks}, graphed vs its eager twin (both ranks, the all-reduces "
                  f"captured vs eager): bitwise after the walker's scans {tw['walker']['scans']} x "
                  f"{tw['walker']['rounds']} rounds, {tw['act_fused']['forwards']} act-fused forwards and the SAC "
                  f"slice's host batches; walker per update eager {tw['walker']['eager_host_ms_per_update']:.2f} "
                  f"host ms ({tw['walker']['eager_wall_ms_per_update']:.2f} to done, device "
                  f"{tw['walker']['eager_device_ms_per_update']:.2f}) vs graphed "
                  f"{tw['walker']['graphed_host_ms_per_update']:.3f} host ms "
                  f"({tw['walker']['graphed_wall_ms_per_update']:.2f} to done, device "
                  f"{tw['walker']['graphed_device_ms_per_update']:.2f}); SAC host batch eager "
                  f"{tw['host_batch']['eager_wall_ms_per_update']:.2f} vs graphed "
                  f"{tw['host_batch']['graphed_wall_ms_per_update']:.2f} ms to done; one replay of "
                  f"{GRAPH_FUSED_CHUNK} walker updates: {tw['collectives']['nccl_kernels']:.0f} NCCL kernels, "
                  f"{tw['collectives']['nccl_ms']:.3f} device ms per update; body kernels in the replay "
                  f"{tw['act_fused']['replay_kernels_traced']} on {card}", flush=True)
        want_len = DP_FILL[0] * DP_FILL[1] + DP_CYCLES[0] * DP_CYCLES[1]
        if any(res["replay_len"] != want_len for res in (*gloo, *ranks, one)):
            fail(f"dp: replay lengths {[res['replay_len'] for res in (*gloo, *ranks, one)]}, expected {want_len}")
        dp_bitwise(r0, gloo[1], "gloo rank 0 vs rank 1")
        dp_bitwise(fault[0], fault[1], "planted fault, gloo rank 0 vs rank 1")
        for i, other in enumerate(ranks[1:], 1):
            dp_bitwise(nccl, other, f"NCCL rank 0 vs rank {i}")
        for name, res, rows in (("gloo rank 0", r0, 128), ("gloo rank 1", gloo[1], 128), ("single", one, 256),
                                *((f"NCCL rank {i}", res, 256 // nccl_ranks) for i, res in enumerate(ranks))):
            check_dp_launches(name, res, rows)
        if not (r0["backend"] == "gloo" and r0["world"] == 2 and nccl["backend"] == "nccl"
                and nccl["world"] == nccl_ranks):
            fail(f"dp: backends {r0['backend']}/{nccl['backend']}")
        if r0["allreduce_calls_per_update"] <= 0 or min(res["allreduce_python_calls"] for res in ranks) <= 0:
            fail("dp: no gradient all-reduce ran")
        if nccl_ranks > 1 and min(res["allreduce_calls_per_update"] for res in ranks) <= 0:
            fail("dp: the replays of the NCCL ranks' programs hold no NCCL kernel")
        bad = [(u, k) for res in (r0, one, nccl) for u, m in enumerate(res["metrics"]) for k, v in m.items()
               if not math.isfinite(v)]
        if bad:
            fail(f"dp: non-finite metrics {bad[:5]}")
        gaps = {"gloo": report_world("2 gloo ranks", one["checks"]["gloo"]),
                "nccl": report_world(f"{nccl_ranks} NCCL ranks", one["checks"]["nccl"]),
                "planted_fault": report_world("2 gloo ranks, draws unsharded (planted fault)",
                                              one["checks"]["gloo_fault"])}
        for name in ("gloo", "nccl"):
            if not gaps[name]["agrees"]:
                fail(f"dp {name}: updates from the same state differ from 1 rank")
        if gaps["planted_fault"]["updates_over_limit"] != DP_UPDATES:
            fail(f"dp: the check passed {DP_UPDATES - gaps['planted_fault']['updates_over_limit']} updates of the "
                 "planted fault (unsharded draws)")
        print(f"[dp] SAC slice at full width ({SLICE_CONFIG}, fused, global batch 256, f32), {DP_UPDATES} updates "
              f"with the noise on, a DeviceReplayMemory per rank fed by the lead's {DP_FILL[0]} + {DP_CYCLES[0]} "
              f"pushes: the ranks bitwise equal; kernel launches per gloo rank {r0['launches']} at 128 rows, per "
              f"NCCL rank {nccl['launches']} at {256 // nccl_ranks} rows", flush=True)

        # (c) --profile on the SAC slice: the trace must name both kernels
        root = osp.join(work, "profile_run")
        run_cli(SLICE_CONFIG, ["--work-dir", root, "--seed", "0", "--device", "cuda", "--profile",
                               str(DP_PROFILE_STEPS), "--cfg-options", FUSED, "replay_cfg.capacity=4096",
                               "train_cfg.warm_steps=512", "train_cfg.total_steps=540", "train_cfg.n_log=500",
                               "train_cfg.n_checkpoint=-1", "train_cfg.exp_logger_cfg.type=csv",
                               "eval_cfg.save_video=False", "eval_cfg.num=1"],
                osp.join(work, "profile_run.log"), timeout=240)
        with open(osp.join(root, "0", "profile", "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        kernels = {}
        for e in events:
            if e.get("cat") == "kernel":
                for kname in ("pointnet_body_idx_kernel", "pointnet_body_max_kernel"):
                    if kname in e.get("name", ""):
                        kernels[kname] = kernels.get(kname, 0) + 1
        if set(kernels) != {"pointnet_body_idx_kernel", "pointnet_body_max_kernel"}:
            fail(f"dp: the --profile trace names the fused kernels {kernels}, not both")
        n_kernel = sum(1 for e in events if e.get("cat") == "kernel")
        print(f"[dp] run_rl --profile {DP_PROFILE_STEPS}: {len(events)} trace events, {n_kernel} device kernels, "
              f"fused body kernels {kernels}", flush=True)
        if nccl_ranks > 1:  # (d) the CLI's own ranks, one per card
            root = osp.join(work, "ranks_run")
            run_cli(SLICE_CONFIG, ["--work-dir", root, "--seed", "0", "--device", "cuda", "--num-devices",
                                   str(nccl_ranks), "--cfg-options", FUSED, "replay_cfg.capacity=4096",
                                   "train_cfg.warm_steps=512", "train_cfg.total_steps=640", "train_cfg.n_log=64",
                                   "train_cfg.n_checkpoint=576", "train_cfg.n_eval=576",
                                   "train_cfg.exp_logger_cfg.type=csv", "eval_cfg.save_video=False", "eval_cfg.num=1"],
                    osp.join(work, "ranks_run.log"), timeout=300)
            summary = read_summary(osp.join(root, "0"))
            if summary["world_size"] != nccl_ranks or summary["steps"] != 640:
                fail(f"dp: run_rl --num-devices {nccl_ranks} summary {summary}")
            check_launches("ranks", "training", run_launches(summary), True, TRAIN_KERNELS)
            models = sorted(os.listdir(osp.join(root, "0", "models")))
            if models != ["model_576", "model_final"]:
                fail(f"dp: run_rl --num-devices {nccl_ranks} wrote {models}")
            print(f"[dp] run_rl --num-devices {nccl_ranks} --device cuda: {summary['steps']} env steps, "
                  f"{summary['grad_steps']} updates, {summary['updates_per_s']:.1f} updates/s, rank 0's launches "
                  f"{summary['launches']}, checkpoints {models}, eval at 576 on {card}", flush=True)
        interleave = dp_interleave(work, card, nccl_ranks)  # (e)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"world2_gloo": {k: r0[k] for k in ("launches", "ms_per_update", "allreduce_ms_per_update",
                                                 "broadcast_ms_per_cycle")},
            "world2_gloo_rank1_ms_per_update": gloo[1]["ms_per_update"],
            "world1_ms_per_update": one["ms_per_update"],
            f"world{nccl_ranks}_nccl": {k: nccl[k] for k in ("launches", "ms_per_update", "allreduce_ms_per_update",
                                                            "allreduce_calls_per_update", "device_ms_per_update",
                                                            "broadcast_ms_per_cycle", "graphed")},
            "twins": [{k: res["twins"][k] for k in ("walker", "act_fused", "collectives", "host_batch")}
                      for res in ranks],
            "gaps": gaps, "profile_kernel_events": kernels, "interleave": interleave,
            "launches": {k: sum(res["launches"][k] for res in (*gloo, *ranks)) + interleave["launches"][k]
                         for k in TPU_KERNELS}}


# ------------------------------------------------------------------ hosts
# A world launched from outside across hosts (phase 11): each rank a host
# of its own in torchrun's variables, so each collects, as the JAX
# package's hosts do.  Two hosts share cuda:0 here over gloo (NCCL refuses
# two ranks on one GPU), started as torchrun starts ranks, each calling the
# port's ``run_rl.main``.
# One pipeline group: with the default two, a collection pushes its two groups' rows in the order
# their env workers finish, which may differ between the hosts, while (a) holds the hosts' replays
# bitwise equal and each update to the 1-rank update on rank 0's replica.
HOSTS_OPTS = [FUSED, "replay_cfg.capacity=4096", "train_cfg.warm_steps=512", "train_cfg.n_checkpoint=-1",
              "train_cfg.n_eval=-1", "train_cfg.exp_logger_cfg.type=csv", "eval_cfg.save_video=False", "eval_cfg.num=1",
              "rollout_cfg.pipeline_groups=1"]
HOSTS_TOTAL = 640  # the config's 4 env workers per host: 512 warm-up steps, then 32 cycles of 4 steps and 1 update
HOSTS_UPDATES = 6  # updates from the trained state, each held to the 1-rank update from the same state
HOSTS_TIMED = 10  # then updates in lockstep: ms per update
# (b) full-episode collection: the random warm-up leaves every env at the
# start of an episode of 50 steps, so a collection of 248 holds 200
# transitions of full episodes after 50 steps, past 0.8 x 248, and the last
# 48 after 100.  Host 1, at about 2/3 of host 0's speed, is some 66 steps in
# when host 0 is done: the vote cuts it there and flushes its partial episodes.
VOTE_NUM = 248
VOTE_TOTAL = 512 + 2 * VOTE_NUM


def replay_digest(replay) -> str:
    """sha256 of a host replay's stored transitions, in storage order."""
    import hashlib

    from pointcloud_rl_torch.utils.tree_ops import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves(replay.memory):
        h.update(np.ascontiguousarray(leaf[:len(replay)]).tobytes())
    return h.hexdigest()


def hosts_worker(mode: str, out_path: str) -> None:
    """One host of the hosts phase (``--hosts-worker MODE OUT``): joins
    the gloo world on cuda:0, then runs ``run_rl.main`` on the SAC slice
    at full width, with ``train_rl`` wrapped to keep this rank's result
    just after it trains: the kernel launches, updates/s, the replay's
    digest and the parameters.  ``train``: then ``HOSTS_UPDATES`` updates
    from the trained state (rank 0 keeps each state and holds each update
    to its own 1-rank update from it, on the same global batch) and
    ``HOSTS_TIMED`` timed ones.  ``vote``: a full-episode rollout, each
    collection's env steps, pushes and flushed partial episodes recorded;
    host 1 steps its envs at about 2/3 of host 0's speed (each
    ``step_dict`` followed by a sleep of half its time), so the straggler
    vote cuts it."""
    import torch
    import torch.distributed as dist

    from pointcloud_rl_torch.apis import run_rl
    from pointcloud_rl_torch.env.rollout import Rollout
    from pointcloud_rl_torch.ops import pointnet_fused as pf
    from pointcloud_rl_torch.parallel import DataParallel

    torch.backends.cuda.matmul.allow_tf32 = False
    host = int(os.environ["GROUP_RANK"])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
                            world_size=int(os.environ["WORLD_SIZE"]), rank=int(os.environ["RANK"]))
    result: dict = {"calls": []}
    train_rl = run_rl.train_rl

    def recorded(**kwargs):
        out = train_rl(**kwargs)
        torch.cuda.synchronize()
        result["launches"] = launched(pf)  # run_rl set them to 0 just before training
        agent, replay = kwargs["agent"], kwargs["replay"]
        state = train_state_on_host(agent)
        result.update(out, updates_per_s=out["grad_steps"] / out["main_loop_s"], replay_len=len(replay),
                      replay_digest=replay_digest(replay),
                      final={k: state[k] for k in ("model", "target", "log_alpha")})
        if mode == "train":
            result["metrics"], steps = take_updates(agent, replay, dist.get_rank(), HOSTS_UPDATES)
            times = []
            for u in range(HOSTS_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                agent.update_parameters(replay, HOSTS_UPDATES + u + 1)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            result["ms_per_update"] = 1e3 * float(np.median(times))
            if dist.get_rank() == 0:  # the same agent as a world of one, from each of the world's states
                agent.set_data_parallel(DataParallel())
                result["checks"] = {"stepwise": stepwise_gaps(agent, replay, steps, result["metrics"]), "free": []}
        return out

    run_rl.train_rl = recorded
    if mode == "vote":
        full = Rollout._forward_full_episodes

        def voting(self, pi, num, replay, recent_replay=None):
            call = {"num": num, "env_steps": 0, "flushed": 0, "voted": False}
            step, flush, before = self.vec_env.step_dict, replay.push_cached_trajectories, replay.running_count

            def slowed(actions):
                t0 = time.perf_counter()
                out = step(actions)
                call["env_steps"] += 1
                if host == 1:
                    time.sleep(0.5 * (time.perf_counter() - t0))
                return out

            def flushed(max_push=-1):
                n = flush(max_push=max_push)
                call.update(voted=True, flushed=call["flushed"] + n)
                return n

            self.vec_env.step_dict, replay.push_cached_trajectories = slowed, flushed
            try:
                return full(self, pi, num, replay, recent_replay)
            finally:
                del self.vec_env.step_dict, replay.push_cached_trajectories
                call["pushed"] = replay.running_count - before
                result["calls"].append(call)

        Rollout._forward_full_episodes = voting
        opts = HOSTS_OPTS + ["rollout_cfg.full_episode=True", f"train_cfg.n_steps={VOTE_NUM}",
                             f"train_cfg.total_steps={VOTE_TOTAL}", f"train_cfg.n_log={VOTE_NUM}"]
    else:
        opts = HOSTS_OPTS + [f"train_cfg.total_steps={HOSTS_TOTAL}", "train_cfg.n_log=64"]
    # a work dir per host in (a), so that what host 1 writes shows; a shared one in (b)
    root = osp.join(osp.dirname(out_path), f"{mode}_wd" + (f"_host{host}" if mode == "train" else ""))
    run_rl.main([SLICE_CONFIG, "--work-dir", root, "--seed", "0", "--device", "cuda", "--cfg-options", *opts])
    result["work_dir"] = osp.join(root, "0")
    torch.save(result, out_path)


def hosts_bitwise(a: dict, b: dict, name: str) -> None:
    import torch

    for part in ("model", "target"):
        for key, x in a["final"][part].items():
            if not torch.equal(x, b["final"][part][key]):
                fail(f"hosts {name}: {part}.{key} is not bitwise equal across the hosts")
    if not torch.equal(a["final"]["log_alpha"], b["final"]["log_alpha"]):
        fail(f"hosts {name}: log_alpha is not bitwise equal across the hosts")


def phase_hosts(card: str) -> dict:
    """A world across hosts: (a) two hosts of one rank on cuda:0 over gloo
    train the SAC slice with ``run_rl``, each collecting; (b) the same with
    full-episode collection and host 1 slowed, which the straggler vote
    must cut."""
    work = tempfile.mkdtemp(prefix="chip_smoke_hosts_", dir=osp.join(REPO, "build"))
    try:
        t0 = time.monotonic()
        h0, h1 = run_dp_workers(work, "train", 2, phase="hosts")
        train_s = time.monotonic() - t0
        if h0["replay_digest"] != h1["replay_digest"] or {h0["replay_len"], h1["replay_len"]} != {HOSTS_TOTAL}:
            fail(f"hosts: the hosts' replays differ ({h0['replay_len']} / {h1['replay_len']} transitions), though "
                 "both collect with the same seeds")
        hosts_bitwise(h0, h1, "after training")
        if h0["metrics"] != h1["metrics"]:
            fail("hosts: the update metrics differ across the hosts")
        for name, res in (("host 0", h0), ("host 1", h1)):
            check_launches(f"hosts {name}", "training", res["launches"], True, TRAIN_KERNELS)
            if res["steps"] != HOSTS_TOTAL or res["grad_steps"] != (HOSTS_TOTAL - 512) // 4:
                fail(f"hosts {name}: {res['steps']} env steps, {res['grad_steps']} updates")
        gaps = report_world("2 hosts x 1 rank, gloo", h0["checks"], tag="hosts")
        if not gaps["agrees"]:
            fail("hosts: updates from the same state differ from 1 rank")
        summary = read_summary(h0["work_dir"])
        if (summary["hosts"], summary["ranks_per_host"], summary["world_size"]) != (2, [1, 1], 2) or \
                summary["collected_steps_per_host"] != [HOSTS_TOTAL, HOSTS_TOTAL]:
            fail(f"hosts: run_summary.json says {summary}")
        models = sorted(os.listdir(osp.join(h0["work_dir"], "models")))
        host1_files = [osp.relpath(osp.join(d, f), h1["work_dir"])
                       for d, _, files in os.walk(h1["work_dir"]) for f in files]
        if models != ["model_final"] or host1_files:
            fail(f"hosts: rank 0 wrote {models}, host 1's rank {host1_files} (it must write nothing)")
        read_metrics(osp.join(h0["work_dir"], "logs", "metrics.csv"))
        print(f"[hosts] (a) 2 hosts x 1 rank on cuda:0 over gloo (gloo stages each all-reduce through the host), "
              f"run_rl on the SAC slice at full width ({SLICE_CONFIG}, fused, global batch 256 = 128 rows per rank, "
              f"f32, 4 env workers per host): {HOSTS_TOTAL} env steps and {h0['grad_steps']} updates per host, both "
              f"replays bitwise equal ({h0['replay_len']} transitions, each host collecting with the same seeds), "
              f"parameters bitwise equal; kernel launches host 0 {h0['launches']}, host 1 {h1['launches']}; "
              f"updates/s over the main loop host 0 {h0['updates_per_s']:.1f}, host 1 {h1['updates_per_s']:.1f}; "
              f"ms per update in lockstep host 0 {h0['ms_per_update']:.2f}, host 1 {h1['ms_per_update']:.2f}; "
              f"{train_s:.1f} s on {card}", flush=True)

        t1 = time.monotonic()
        v0, v1 = run_dp_workers(work, "vote", 2, phase="hosts")
        vote_s = time.monotonic() - t1
        for name, res in (("host 0", v0), ("host 1", v1)):
            check_launches(f"hosts vote {name}", "training", res["launches"], True, TRAIN_KERNELS)
            bad = [c for c in res["calls"] if not 0.8 * c["num"] <= c["pushed"] <= c["num"]]
            if bad:
                fail(f"hosts vote {name}: collections pushed outside [0.8 num, num]: {bad}")
        if (v0["steps"], v0["grad_steps"], len(v0["calls"])) != (v1["steps"], v1["grad_steps"], len(v1["calls"])):
            fail(f"hosts vote: the hosts left the loop out of step: {v0['steps']} / {v1['steps']} env steps")
        cut = [(a, b) for a, b in zip(v0["calls"], v1["calls"]) if b["voted"] and b["env_steps"] < a["env_steps"]]
        if not cut or not any(b["flushed"] > 0 for _, b in cut):
            fail(f"hosts vote: host 1 was not cut with partial episodes flushed: host 0 {v0['calls']}, "
                 f"host 1 {v1['calls']}")
        vote_summary = read_summary(v0["work_dir"])
        print(f"[hosts] (b) full-episode collection of {VOTE_NUM} per cycle, host 1 stepping at 2/3 speed: host 0 "
              f"{[(c['env_steps'], c['pushed']) for c in v0['calls']]}, host 1 "
              f"{[(c['env_steps'], c['pushed'], c['flushed']) for c in v1['calls']]} (env steps, pushes[, flushed "
              f"partial-episode transitions]); the vote cut host 1 in {len(cut)} of {len(v1['calls'])} collections; "
              f"collected per host {vote_summary['collected_steps_per_host']}; both at {v0['steps']} env steps, "
              f"{v0['grad_steps']} updates; {vote_s:.1f} s on {card}", flush=True)
        print(f"[time] hosts phase: {time.monotonic() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"train": {f"host{h}": {k: r[k] for k in ("launches", "updates_per_s", "ms_per_update", "steps",
                                                   "grad_steps")} for h, r in enumerate((h0, h1))},
            "gaps": gaps, "train_s": train_s,
            "vote": {f"host{h}": r["calls"] for h, r in enumerate((v0, v1))}, "vote_s": vote_s,
            "launches": {k: sum(r["launches"][k] for r in (h0, h1, v0, v1)) for k in TRAIN_KERNELS}}


def phase_hosts_nccl(card: str) -> dict:
    """(c): ``torchrun --nnodes 2`` twice on this machine (static
    rendezvous), one rank per "host" on its own card over NCCL."""
    work = tempfile.mkdtemp(prefix="chip_smoke_hosts_nccl_", dir=osp.join(REPO, "build"))
    try:
        port = str(_free_port())
        root = osp.join(work, "torchrun_wd")
        opts = HOSTS_OPTS + [f"train_cfg.total_steps={HOSTS_TOTAL}", "train_cfg.n_log=64"]
        procs = []
        for host in (0, 1):
            cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2", "--node-rank", str(host),
                   "--nproc-per-node", "1", "--master-addr", "127.0.0.1", "--master-port", port,
                   "-m", "pointcloud_rl_torch.apis.run_rl", SLICE_CONFIG, "--work-dir", root, "--seed", "0",
                   "--device", "cuda", "--gpu-ids", str(host), "--cfg-options", *opts]
            log = open(osp.join(work, f"torchrun_{host}.log"), "w")
            procs.append((subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
                                           env=dict(os.environ, OMP_NUM_THREADS="1")), log))
        t0 = time.monotonic()
        for proc, log in procs:
            try:
                rc = proc.wait(timeout=300)
            except subprocess.TimeoutExpired:
                for p, _ in procs:
                    os.killpg(p.pid, 9)
                    p.wait()
                rc = "timeout"
            log.close()
            if rc != 0:
                with open(log.name) as f:
                    fail(f"hosts: torchrun node exited with {rc}:\n{f.read()[-4000:]}")
        summary = read_summary(osp.join(root, "0"))
        if (summary["hosts"], summary["world_size"], summary["steps"]) != (2, 2, HOSTS_TOTAL) or \
                summary["collected_steps_per_host"] != [HOSTS_TOTAL, HOSTS_TOTAL]:
            fail(f"hosts: the torchrun world's run_summary.json says {summary}")
        summary["launches"] = run_launches(summary)
        check_launches("hosts torchrun", "training", summary["launches"], True, TRAIN_KERNELS)
        if sorted(os.listdir(osp.join(root, "0", "models"))) != ["model_final"]:
            fail("hosts: the torchrun world wrote other checkpoints than model_final")
        read_metrics(osp.join(root, "0", "logs", "metrics.csv"))
        print(f"[hosts] (c) torchrun --nnodes 2 on localhost, NCCL, cuda:0 and cuda:1: {summary['steps']} env steps, "
              f"{summary['grad_steps']} updates, {summary['updates_per_s']:.1f} updates/s over rank 0's main loop, "
              f"collected per host {summary['collected_steps_per_host']}, rank 0's launches {summary['launches']}; "
              f"{time.monotonic() - t0:.1f} s on {card}", flush=True)
        return {k: summary[k] for k in ("updates_per_s", "launches", "collected_steps_per_host", "grad_steps")}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------------ replay I/O
# The walker recipe's replay persistence below the file (phase 12): the
# ring of its config (100000 packed bf16 transitions) filled past one wrap,
# the ``save_replay`` snapshot of its newest 50000 transitions, the restore
# into a fresh ring through ``load_hdf5``'s chunk loop, then offline updates
# of the walker agent from the restored ring.  The HDF5 write and read are
# host code (h5py, absent from the card's machine): tests/test_torch_replay_io.py
# holds them on the CPU.
REPLAY_IO_BLOCK = 4096  # rows of the one seeded host block every fill push reuses
REPLAY_IO_STEPS = 20  # offline train_rl iterations of the recipe's 16 updates
REPLAY_IO_SEED = 0


def walker_raw_block(n: int, seed: int) -> dict:
    """``n`` raw full-width walker transitions as the rollout pushes them:
    3 frames x 512 points, xyz f32, rgb uint8 and FrameStack's one-hot
    pos_encoding (which the ring strips and re-synthesizes)."""
    rs = np.random.RandomState(seed)
    points = WALKER["n_points"] * WALKER["frames"]
    pe = np.repeat(np.eye(WALKER["frames"], dtype=np.float32), WALKER["n_points"], axis=-1)

    def obs():
        return {"xyz": rs.uniform(-2, 2, (n, 3, points)).astype(np.float32),
                "rgb": rs.randint(0, 256, (n, 3, points)).astype(np.uint8),
                "pos_encoding": np.ascontiguousarray(np.broadcast_to(pe, (n,) + pe.shape))}

    return dict(obs=obs(), next_obs=obs(), actions=rs.uniform(-1, 1, (n, WALKER["action_dim"])).astype(np.float32),
                rewards=np.zeros((n, 1), np.float32), dones=rs.rand(n, 1) < 0.01, episode_dones=np.zeros((n, 1), bool))


def same_bits(a, b) -> bool:
    import torch

    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


class _MetricLog:
    """An experiment logger that keeps what ``train_rl`` logs."""

    def __init__(self):
        self.rows = []

    def log(self, values, step=None, tag=None):
        self.rows.append(dict(values))

    def close(self):
        pass


def phase_replay_io(pf, card: str) -> dict:
    """Fill, snapshot, restore and train offline, at the walker recipe's
    full width on the card, through the calls ``train_rl`` and ``run_rl``
    make."""
    import torch

    from pointcloud_rl_torch.algorithms.obs_transfer import pack_device_features
    from pointcloud_rl_torch.apis.train_rl import replay_snapshot, train_rl
    from pointcloud_rl_torch.env import build_replay
    from pointcloud_rl_torch.env.device_replay import CHUNK
    from pointcloud_rl_torch.models import heads
    from pointcloud_rl_torch.models import distributions as dist
    from pointcloud_rl_torch.utils.tree_ops import tree_leaves, tree_map, tree_slice

    agent_cfg, info, cfg = walker_agent_cfg()
    n_snap, n_updates = cfg["train_cfg"]["save_replay"], cfg["train_cfg"]["n_updates"]
    replay_cfg = cfg["replay_cfg"]
    capacity = replay_cfg["capacity"]
    pushes = capacity // REPLAY_IO_BLOCK + 2  # past one wrap, position not 0
    t0 = time.monotonic()
    block = walker_raw_block(REPLAY_IO_BLOCK, REPLAY_IO_SEED)
    ring = build_replay(replay_cfg, dict(seed=REPLAY_IO_SEED), device="cuda")
    torch.cuda.synchronize()
    t_fill = time.monotonic()
    for p in range(pushes):
        block["rewards"][:, 0] = p * REPLAY_IO_BLOCK + np.arange(REPLAY_IO_BLOCK)
        ring.push_batch(block)
    torch.cuda.synchronize()
    fill_s = time.monotonic() - t_fill
    total = pushes * REPLAY_IO_BLOCK
    if not (len(ring) == capacity and ring.position == total % capacity != 0
            and set(ring.storage["obs"]) == {"pcd"} and ring.storage["obs"]["pcd"].dtype == torch.bfloat16):
        fail(f"replay-io: the ring holds {len(ring)} at position {ring.position}, obs "
             f"{ {k: (tuple(v.shape), v.dtype) for k, v in ring.storage['obs'].items()} }")
    storage_gb = sum(x.nbytes for x in tree_leaves(ring.storage)) / 1e9
    row_bytes = sum(x[0].nbytes for x in tree_leaves(ring.storage))
    print(f"[replay-io] {WALKER_CONFIG}: ring of {capacity} packed bf16 transitions on the card, filled by {pushes} "
          f"pushes of {REPLAY_IO_BLOCK} raw full-width transitions ({total}, position {ring.position}) in "
          f"{fill_s:.2f} s; {row_bytes} bytes per stored transition", flush=True)

    # -- the snapshot: the N newest transitions in push order, on the host
    gather = []
    real_tail = ring.tail

    def timed_tail(num):  # replay_snapshot's own gather: device gather + device-to-host copy, in chunks
        torch.cuda.synchronize()
        t = time.monotonic()
        out = real_tail(num)
        gather.append(time.monotonic() - t)
        return out

    ring.tail = timed_tail
    try:
        t1 = time.monotonic()
        snap = replay_snapshot(ring, n_snap).get_all()
        snapshot_s = time.monotonic() - t1
    finally:
        del ring.tail
    if len(gather) != 1:
        fail(f"replay-io: replay_snapshot gathered {len(gather)} times, expected once")
    gather_s = gather[0]
    want_idx = np.arange(total - n_snap, total)
    if not np.array_equal(snap["rewards"][:, 0].numpy(), want_idx.astype(np.float32)):
        fail("replay-io: the snapshot's rewards are not the newest transitions' global indices in push order")
    rows = torch.as_tensor(want_idx % REPLAY_IO_BLOCK)
    packed = {}
    with torch.no_grad():
        for key in ("obs", "next_obs"):
            obs = {k: torch.as_tensor(v).cuda() for k, v in block[key].items() if k != "pos_encoding"}
            packed[key] = pack_device_features(obs, torch.bfloat16, synth_pos=(WALKER["frames"], WALKER["n_points"]))
            if not same_bits(snap[key]["pcd"], packed[key]["pcd"].cpu()[rows]):
                fail(f"replay-io: the snapshot's {key} differ from the packed pushes (bitwise)")
    for key in ("actions", "dones", "episode_dones"):
        if not same_bits(snap[key], torch.as_tensor(block[key])[rows]):
            fail(f"replay-io: the snapshot's {key} differ from the pushes (bitwise)")
    snap_gb = sum(x.nbytes for x in (snap["obs"]["pcd"], snap["next_obs"]["pcd"])) / 1e9
    print(f"[replay-io] save_replay={n_snap} snapshot (train_rl's replay_snapshot): the newest {n_snap} in push "
          f"order, bitwise (bf16 bits and reward indices {want_idx[0]}..{want_idx[-1]}); gather + D2H "
          f"{1e3 * gather_s:.1f} ms ({snap_gb:.2f} GB of obs), replay_snapshot in all (with the host replay's copy) "
          f"{1e3 * snapshot_s:.1f} ms "
          f"on {card}", flush=True)
    print("[replay-io] the HDF5 write and read of the snapshot are host code (h5py is not on this machine): "
          "tests/test_torch_replay_io.py and tests/test_torch_offline.py hold that round trip on the CPU", flush=True)

    # -- the restore: load_hdf5's chunk loop, from the host tree
    fresh = build_replay(replay_cfg, dict(seed=REPLAY_IO_SEED + 1), device="cuda")
    torch.cuda.synchronize()
    t1 = time.monotonic()
    fresh.push_in_chunks(n_snap, lambda sl: tree_slice(snap, sl))  # CHUNK rows, as load_hdf5
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t1
    chunks = -(-n_snap // CHUNK)
    if len(fresh) != n_snap or fresh.position != n_snap:
        fail(f"replay-io: the restored ring holds {len(fresh)} at position {fresh.position}, expected {n_snap}")
    for key, leaf in (("obs", "pcd"), ("next_obs", "pcd"), ("actions", None), ("rewards", None), ("dones", None)):
        got = fresh.storage[key][leaf] if leaf else fresh.storage[key]
        want = snap[key][leaf] if leaf else snap[key]
        for a in range(0, n_snap, CHUNK):
            b = min(a + CHUNK, n_snap)
            if not same_bits(got[a:b], want[a:b].cuda()):
                fail(f"replay-io: the restored {key} differ from the snapshot at rows {a}.. (bitwise)")
    print(f"[replay-io] restore through load_hdf5's chunk loop (push_in_chunks): {chunks} chunks of "
          f"{CHUNK} rows in {1e3 * restore_s:.1f} ms ({1e3 * restore_s / chunks:.2f} ms per chunk); "
          f"the ring equals the snapshot bitwise, obs stored packed as they came", flush=True)
    del snap
    # The rewards carried each transition's index (to ~1e5) for the order
    # checks; train on a walker's own scale (DMC rewards lie in [0, 1]).
    rewards = np.random.RandomState(REPLAY_IO_SEED).uniform(0, 1, (n_snap, 1)).astype(np.float32)
    fresh.storage["rewards"][:n_snap].copy_(torch.as_tensor(rewards))

    # -- offline updates from the restored ring: first one card vs CPU
    agent_cpu, agent = twin_agents(dict(agent_cfg, env_params=info))
    first = fresh.sample(agent.batch_size)
    noisy = heads.tanh_normal_rsample_with_log_prob

    def zero_noise(generator, mean, std, scale, bias, epsilon=1e-6):
        return dist.tanh_transform(mean, scale, bias), dist.tanh_log_prob_with_logit(mean, mean, std, scale, epsilon)

    heads.tanh_normal_rsample_with_log_prob = zero_noise  # the same draw (none) on both devices
    try:
        t1 = time.monotonic()
        cpu_metrics = agent_cpu.update_parameters(_Batch(tree_map(lambda t: t.cpu(), first)), 0)
        cpu_s = time.monotonic() - t1
        ref = compare_agents("replay_io_first_update", agent_cpu, agent, cpu_metrics,
                             agent.update_parameters(_Batch(first), 0), lr=1e-3, metric_rtol=ACTION_ATOL_BF16)
    finally:
        heads.tanh_normal_rsample_with_log_prob = noisy
    print(f"[replay-io] first update from the restored ring, card (kernels, bf16) vs CPU (plain, bf16), the "
          f"noise pinned to zero on both: {ref} (metrics to {ACTION_ATOL_BF16} relative; CPU {cpu_s:.1f} s)",
          flush=True)
    del agent_cpu

    work = tempfile.mkdtemp(prefix="chip_smoke_replay_io_", dir=osp.join(REPO, "build"))
    log = _MetricLog()
    try:
        reset_counters()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = train_rl(agent, None, None, fresh, work_dir=work, total_steps=REPLAY_IO_STEPS, warm_steps=0,
                       n_steps=0, n_updates=n_updates, n_log=REPLAY_IO_STEPS // 4, n_eval=-1, n_checkpoint=-1,
                       exp_logger=log)
        end.record()
        torch.cuda.synchronize()
        launches = launched(pf)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ms = start.elapsed_time(end)
    updates = out["grad_steps"]
    for kname in TRAIN_KERNELS:
        if launches[kname] <= 0:
            fail(f"{kname} was never launched by the offline updates of the replay-io phase")
    bad = [(i, k) for i, row in enumerate(log.rows) for k, v in row.items()
           if isinstance(v, float) and not math.isfinite(v)]
    if bad or updates != REPLAY_IO_STEPS * n_updates or not any("sac/critic_loss" in r for r in log.rows):
        fail(f"replay-io: {updates} updates, non-finite or missing metrics {bad[:5]}")
    rec = {
        "name": "replay_io", "config": WALKER_CONFIG, "capacity": capacity, "filled": total,
        "position": ring.position, "storage_gb": storage_gb, "fill_s": fill_s, "snapshot_rows": n_snap,
        "snapshot_obs_gb": snap_gb, "gather_d2h_ms": 1e3 * gather_s, "snapshot_ms": 1e3 * snapshot_s,
        "restore_chunks": chunks, "restore_ms": 1e3 * restore_s, "restore_ms_per_chunk": 1e3 * restore_s / chunks,
        "first_update_vs_cpu": ref, "updates": updates, "launches": launches,
        "offline_ms_per_update": ms / updates, "offline_updates_per_s": 1e3 * updates / ms,
        "main_loop_ms_per_update": 1e3 * out["main_loop_s"] / updates,
        "critic_loss_last": log.rows[-1].get("sac/critic_loss"), "phase_s": time.monotonic() - t0,
    }
    print(f"[replay-io] offline train_rl (rollout None, n_steps 0, warm_steps 0) from the restored ring: {updates} "
          f"updates in {ms:.1f} ms (CUDA events around the call, its final checkpoint included): "
          f"{rec['offline_ms_per_update']:.2f} ms per update, {rec['offline_updates_per_s']:.1f} updates/s; "
          f"{rec['main_loop_ms_per_update']:.2f} ms per update over train_rl's main loop; kernel launches "
          f"{launches}; metrics finite; phase {rec['phase_s']:.1f} s on {card}", flush=True)
    return rec


MANISKILL_SAC = "configs/mfrl/sac/maniskill/pn.py"
MANISKILL_DRQ = "configs/mfrl/drq/maniskill/pn_shift.py"
# (name, config, metric prefix, env steps after the 512-step warm-up): SAC
# takes 1200 env steps (300 updates at the config's 4 steps per update),
# DrQ 400 (100 updates); both at the configs' full widths.
MANISKILL_RUNS = [("maniskill_sac", MANISKILL_SAC, "sac", 1200), ("maniskill_drq", MANISKILL_DRQ, "drq", 400)]
MANISKILL_PROFILE_STEPS = 40  # env steps of each run under torch.profiler: the device's busy time
MANISKILL_LEVELS = (0, 1, 2, 3)  # the evaluator's levels
MANISKILL_OBS = {"xyz": ((3, 1200), "float32"), "rgb": ((3, 1200), "uint8"), "seg": ((3, 1200), "bool"),
                 "state": ((38,), "float32")}
STANDIN_LOG_ENV = "PCRL_MANISKILL_STANDIN_LOG"


class ManiSkillRawStandIn:
    """A stand-in for a ManiSkill task as ``gym.make`` returns it once
    ``mani_skill.env`` is imported: the fused SAPIEN observation
    ``{"pointcloud": {"xyz" [n_raw, 3] f32, "rgb" [n_raw, 3] f32 in [0, 1],
    "seg" [n_raw, 3] bool}, "agent": [38] f32}``, ``set_env_mode``,
    ``reset(level=)`` and ``info["eval_info"]``.  The scene is procedural
    and seeded by its level: ground points at z = 0 (which ``pcd_base``
    drops), three segment clusters (a handle on an object, the object, the
    robot) and background points; the actions move the robot, the robot
    pushes the object when it is close, and a seeded jitter moves every
    point above the ground.  An episode ends after ``HORIZON`` steps, or
    at success unless ``no_early_stop``.  ``ego_mode`` expresses the points
    in the robot's frame; ``with_ext_torque`` and ``cos_sin_representation``
    are accepted and change nothing here.  PushChair and MoveBucket take 22
    actions (the dual-arm robot), OpenCabinet 13.  The action space is the
    port's own ``Box``.  Nothing in the package uses this class; it stands
    in for sapien and mani_skill, which the card's machine lacks."""

    N_GROUND = 1500
    SEGMENTS = (300, 600, 1100)  # points of the handle, the object and the robot
    N_BACKGROUND = 2500
    HORIZON = 200
    STATE_DIM = 38

    def __init__(self, env_name, ego_mode=False, no_early_stop=False, with_ext_torque=False,
                 cos_sin_representation=False):
        from pointcloud_rl_torch.env.spaces import Box

        self.env_name = env_name
        self.ego_mode, self.no_early_stop = ego_mode, no_early_stop
        self.action_dim = 13 if env_name.startswith("OpenCabinet") else 22
        ones = np.ones(self.action_dim, np.float32)
        self.action_space = Box(-ones, ones)
        self.obs_mode, self.reward_type = "pointcloud", "dense"
        self.rs = np.random.RandomState(0)
        self.n_raw = self.N_GROUND + sum(self.SEGMENTS) + self.N_BACKGROUND

    def set_env_mode(self, obs_mode=None, reward_type=None):
        if obs_mode not in (None, "pointcloud", "state"):
            raise ValueError(f"the stand-in renders no {obs_mode!r} observations")
        self.obs_mode = obs_mode or self.obs_mode
        self.reward_type = reward_type or self.reward_type

    def seed(self, seed=None):
        self.rs = np.random.RandomState(seed)
        self.action_space.seed(seed)

    def reset(self, level=None):
        self.level = int(self.rs.randint(2**31)) if level is None else int(level)
        scene = np.random.RandomState(self.level)
        self.robot = np.array([*scene.uniform(-0.8, -0.4, 2), 0.5])
        self.obj = np.array([*scene.uniform(-0.3, 0.3, 2), 0.4])
        self.target = np.array([*scene.uniform(0.4, 0.8, 2), 0.4])
        self.vel = np.zeros(3)
        self.last_action = np.zeros(self.action_dim)
        self.t = 0
        self.shapes = [scene.normal(0, s, (n, 3)) for n, s in zip(self.SEGMENTS, (0.02, 0.15, 0.12))]
        self.ground = np.concatenate([scene.uniform(-2, 2, (self.N_GROUND, 2)), np.zeros((self.N_GROUND, 1))], 1)
        self.background = scene.uniform((-2, -2, 0.05), (2, 2, 1.5), (self.N_BACKGROUND, 3))
        self.colors = np.concatenate([np.full((n, 3), c) for n, c in zip(
            (self.N_GROUND, *self.SEGMENTS, self.N_BACKGROUND),
            ((0.4, 0.4, 0.4), (0.9, 0.8, 0.1), (0.6, 0.3, 0.1), (0.2, 0.4, 0.9), (0.7, 0.7, 0.7)))])
        return self._obs()

    def _state(self):
        act = np.zeros(19)
        act[:min(19, self.action_dim)] = self.last_action[:19]
        return np.concatenate([self.robot, self.vel, self.obj, self.target, self.obj - self.robot,
                               self.target - self.obj, [self.t / self.HORIZON], act]).astype(np.float32)

    def _obs(self):
        state = self._state()
        if self.obs_mode == "state":
            return state
        handle = self.obj + np.array([-0.18, 0.0, 0.1])
        above = np.concatenate([handle + self.shapes[0], self.obj + self.shapes[1], self.robot + self.shapes[2],
                                self.background])
        above = above + self.rs.normal(0, 0.003, above.shape)
        above[:, 2] = np.maximum(above[:, 2], 0.01)
        xyz = np.concatenate([self.ground, above])
        if self.ego_mode:
            xyz = xyz - np.array([self.robot[0], self.robot[1], 0.0])
        seg = np.zeros((self.n_raw, 3), bool)
        start = self.N_GROUND
        for i, n in enumerate(self.SEGMENTS):
            seg[start:start + n, i] = True
            start += n
        rgb = np.clip(self.colors + self.rs.uniform(-0.05, 0.05, self.colors.shape), 0, 1)
        return {"pointcloud": {"xyz": xyz.astype(np.float32), "rgb": rgb.astype(np.float32), "seg": seg},
                "agent": state}

    def step(self, action):
        a = np.clip(np.asarray(action, np.float64).reshape(-1), -1, 1)
        self.last_action = a
        before = self.robot.copy()
        self.robot = self.robot + 0.03 * a[:3] * np.array([1.0, 1.0, 0.3])
        self.robot[2] = np.clip(self.robot[2], 0.2, 0.8)
        self.vel = self.robot - before
        if np.linalg.norm((self.obj - self.robot)[:2]) < 0.35:  # pushed along the robot's motion
            self.obj[:2] += 0.8 * self.vel[:2]
        self.t += 1
        dist = float(np.linalg.norm((self.obj - self.target)[:2]))
        reach = float(np.linalg.norm((self.obj - self.robot)[:2]))
        success = dist < 0.2
        reward = -dist - 0.5 * reach + (1.0 if success else 0.0)
        timeout = self.t >= self.HORIZON
        done = timeout or (success and not self.no_early_stop)
        info = {"eval_info": {"success": success, "close_to_target": dist < 0.4, "robot_close": reach < 0.35},
                "TimeLimit.truncated": timeout and not success}
        return self._obs(), reward, done, info

    def close(self):
        pass


_STANDIN_GYM = '''"""Stand-in for classic gym as mani_skill registers its tasks into it:
``make`` builds chip_smoke.ManiSkillRawStandIn and, when the environment
names a log file, records which module called it."""
import json
import os
import sys

sys.path.insert(0, {repo!r})
from chip_smoke import ManiSkillRawStandIn  # noqa: E402


def make(env_name, **kwargs):
    log = os.environ.get({log_env!r})
    if log:
        with open(log, "a") as f:
            f.write(json.dumps({{"pid": os.getpid(), "caller": sys._getframe(1).f_globals.get("__name__"),
                                "env_name": env_name, "kwargs": kwargs}}) + "\\n")
    return ManiSkillRawStandIn(env_name, **kwargs)
'''


def write_maniskill_standin(root: str) -> str:
    """Write importable ``sapien``, ``mani_skill.env`` and ``gym`` stand-ins
    into ``root`` (to go on ``sys.path`` and ``PYTHONPATH``); returns it."""
    for pkg in ("sapien", "mani_skill"):
        os.makedirs(osp.join(root, pkg), exist_ok=True)
        with open(osp.join(root, pkg, "__init__.py"), "w") as f:
            f.write('"""Stand-in: the simulator is absent; chip_smoke.ManiSkillRawStandIn plays its tasks."""\n')
    with open(osp.join(root, "mani_skill", "env.py"), "w") as f:
        f.write('"""Stand-in: importing it registers nothing; gym.make builds the stand-in task."""\n')
    with open(osp.join(root, "gym.py"), "w") as f:
        f.write(_STANDIN_GYM.format(repo=REPO, log_env=STANDIN_LOG_ENV))
    return root


def standin_env(root: str, log: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([root, REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env[STANDIN_LOG_ENV] = log
    return env


def trace_busy_ms(path: str) -> tuple:
    """(device busy ms, device kernel events) of a ``torch.profiler`` chrome
    trace: the union of its kernel, memcpy and memset intervals."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "ts" in e)
    busy, end = 0.0, -math.inf
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3, sum(1 for e in events if e.get("cat") == "kernel")


def maniskill_env_cfg(config: str) -> tuple:
    """(the config's env config, its eval env config), as ``run_rl`` builds them."""
    from pointcloud_rl_torch.apis.run_rl import load_config

    cfg = load_config(osp.join(REPO, config))
    env_cfg = cfg["env_cfg"].to_dict() if hasattr(cfg["env_cfg"], "to_dict") else dict(cfg["env_cfg"])
    eval_env = dict(env_cfg, **dict(dict(cfg["eval_cfg"]).get("env_cfg", {})))
    return env_cfg, eval_env


def check_maniskill_env(env, name: str) -> dict:
    """The env must be the port's ``ManiSkillObsWrapper`` around the
    stand-in; returns the observation's shapes and dtypes."""
    inner, chain = env, []
    while True:
        chain.append(f"{type(inner).__module__}.{type(inner).__name__}")
        if type(inner).__name__ == "ManiSkillObsWrapper" or not hasattr(inner, "env"):
            break
        inner = inner.env
    if chain[-1] != "pointcloud_rl_torch.env.maniskill.ManiSkillObsWrapper" or \
            type(inner.env).__name__ != "ManiSkillRawStandIn":
        fail(f"{name}: the env was built as {chain}, not by pointcloud_rl_torch.env.maniskill around the stand-in")
    obs = env.reset()
    got = {k: (tuple(v.shape), str(v.dtype)) for k, v in obs.items()}
    if got != MANISKILL_OBS:
        fail(f"{name}: observation {got}, expected {MANISKILL_OBS}")
    return got


def phase_maniskill(card: str) -> dict:
    """The ManiSkill configs over the stand-in: (a) SAC on ``sac/maniskill/pn.py``
    and (b) DrQ on ``drq/maniskill/pn_shift.py`` through ``run_rl`` with the
    config's 4 env workers, (c) the port's ``mani.Evaluator`` with (a)'s agent."""
    import torch

    from pointcloud_rl_torch.ops import pointnet_fused as pf

    work = tempfile.mkdtemp(prefix="chip_smoke_maniskill_", dir=osp.join(REPO, "build"))
    root = osp.join(work, "standin")
    rec: dict = {"runs": {}, "launches": {k: 0 for k in TRAIN_KERNELS}}
    try:
        write_maniskill_standin(root)
        t0 = time.monotonic()
        for name, config, prefix, steps in MANISKILL_RUNS:
            t_run = time.monotonic()
            log = osp.join(work, f"{name}_standin.jsonl")
            run_root = osp.join(work, name)
            run_cli(config, ["--work-dir", run_root, "--seed", "0", "--device", "cuda",
                             "--profile", str(MANISKILL_PROFILE_STEPS), "--cfg-options", FUSED,
                             "train_cfg.warm_steps=512", f"train_cfg.total_steps={512 + steps}", "train_cfg.n_log=200",
                             "train_cfg.n_eval=-1", "train_cfg.n_checkpoint=-1", "train_cfg.exp_logger_cfg.type=csv",
                             "eval_cfg.save_video=False"],
                    osp.join(work, f"{name}.log"), timeout=300, env=standin_env(root, log))
            wd = osp.join(run_root, "0")
            summary = read_summary(wd)
            if not summary["device"].startswith("cuda") or summary.get("jax_modules") != []:
                fail(f"{name}: ran on {summary['device']} with JAX modules {summary.get('jax_modules')}")
            summary["launches"] = run_launches(summary)
            check_launches(name, "training", summary["launches"], True, TRAIN_KERNELS)
            rows = read_metrics(osp.join(wd, "logs", "metrics.csv"))
            if not any(r.get(f"train/{prefix}/critic_loss") for r in rows):
                fail(f"{name}: no train/{prefix}/critic_loss was logged")
            with open(log) as f:
                made = [json.loads(line) for line in f]
            env_cfg, eval_env = maniskill_env_cfg(config)
            # what make_gym_env and build_maniskill_env leave for gym.make: the ManiSkill kwargs
            want = [{k: v for k, v in c.items() if k not in ("type", "env_name", "obs_mode", "reward_scale")}
                    for c in (env_cfg, eval_env)]
            callers = sorted({m["caller"] for m in made})
            if callers != ["pointcloud_rl_torch.env.maniskill"] or any(m["kwargs"] not in want for m in made) \
                    or len({m["pid"] for m in made}) < 5:
                fail(f"{name}: the stand-in was made by {callers} in {len({m['pid'] for m in made})} processes "
                     f"with {[m['kwargs'] for m in made][:2]}, expected pointcloud_rl_torch.env.maniskill in the "
                     f"run and its 4 env workers with one of {want}")
            busy_ms, n_kernels = trace_busy_ms(osp.join(wd, "profile", "trace.json"))
            busy_step = busy_ms / MANISKILL_PROFILE_STEPS
            idle = 1.0 - busy_step * summary["env_steps_per_s"] / 1e3
            run = {"config": config, "env_name": env_cfg["env_name"], "steps": summary["steps"],
                   "updates": summary["grad_steps"], "env_steps_per_s": summary["env_steps_per_s"],
                   "updates_per_s": summary["updates_per_s"], "main_loop_s": summary["main_loop_s"],
                   "device_busy_ms_per_env_step": busy_step, "device_idle_share": idle,
                   "launches": summary["launches"], "replay": summary["replay"],
                   "stand_in_made_by": callers[0], "stand_in_processes": len({m["pid"] for m in made}),
                   "pointcloud_rl_tpu_modules": summary["pointcloud_rl_tpu_modules"],
                   "jax_modules": summary["jax_modules"], "s": time.monotonic() - t_run}
            rec["runs"][name] = run
            for k in TRAIN_KERNELS:
                rec["launches"][k] += summary["launches"][k]
            print(f"[maniskill] {name}: {config} ({env_cfg['env_name']}) at full width (fused PointNet, 4 env "
                  f"workers, host replay {summary['replay']['capacity']}): {summary['steps']} env steps, "
                  f"{summary['grad_steps']} updates; the stand-in made by {callers[0]} in "
                  f"{run['stand_in_processes']} processes; {run['env_steps_per_s']:.1f} env steps/s, "
                  f"{run['updates_per_s']:.1f} updates/s over the main loop ({summary['main_loop_s']:.1f} s); device "
                  f"busy {busy_step:.3f} ms per env step under the profiler ({n_kernels} kernels in "
                  f"{MANISKILL_PROFILE_STEPS} env steps), idle {idle:.1%} of the main loop; kernel launches "
                  f"{summary['launches']}; JAX modules loaded {summary['jax_modules'] + summary['pointcloud_rl_tpu_modules']}; "
                  f"{run['s']:.1f} s on {card}", flush=True)

        # the env, built here by the port's build_env: the port's wrapper, the obs shapes
        sys.path.insert(0, root)
        from pointcloud_rl_torch.env import build_env

        for name, config, _, _ in MANISKILL_RUNS:
            env_cfg, _ = maniskill_env_cfg(config)
            env = build_env(env_cfg)
            try:
                rec["runs"][name]["obs"] = shapes = check_maniskill_env(env, name)
            finally:
                env.close()
            print(f"[maniskill] {name}: build_env({env_cfg['env_name']!r}) -> pointcloud_rl_torch.env.maniskill."
                  f"ManiSkillObsWrapper around the stand-in ({ManiSkillRawStandIn.N_GROUND + sum(ManiSkillRawStandIn.SEGMENTS) + ManiSkillRawStandIn.N_BACKGROUND} raw points, "
                  f"{ManiSkillRawStandIn.N_GROUND} on the ground); obs {shapes}", flush=True)

        # (c) the evaluator over 4 levels with (a)'s trained agent, deterministic
        from pointcloud_rl_torch.algorithms import build_agent
        from pointcloud_rl_torch.mani import BasePolicy, Evaluator
        from pointcloud_rl_torch.utils.checkpoint import load_checkpoint

        name, config = MANISKILL_RUNS[0][:2]
        agent_cfg, info, _ = resolved_agent_cfg(config, [FUSED])
        agent = build_agent(dict(agent_cfg, env_params=info, seed=0, device="cuda"))
        agent.load_state_dict(load_checkpoint(osp.join(work, name, "0", "models", "model_final"), "cuda"))
        agent.eval()

        class TrainedPolicy(BasePolicy):
            def act(self, observation):
                return agent.forward({k: v[None] for k, v in observation.items()}, mode="eval")[0]

        env_cfg, eval_env = maniskill_env_cfg(config)
        ev = Evaluator(env_name=env_cfg["env_name"], policy=TrainedPolicy(),
                       env_cfg={k: v for k, v in eval_env.items() if k not in ("type", "env_name")})
        try:
            check_maniskill_env(ev.env, "evaluator")
            reset_counters()
            t_ev = time.monotonic()
            result = ev.run(level_list=MANISKILL_LEVELS, max_steps=ManiSkillRawStandIn.HORIZON)
            torch.cuda.synchronize()
            ev_s = time.monotonic() - t_ev
            launches = dict(pf.launch_counts)
            csv_path = osp.join(work, "maniskill_eval.csv")
            ev.export_to_csv(csv_path)
        finally:
            ev.close()
        with open(csv_path) as f:
            csv_text = f.read()
        if launches["pointnet_fused_fwd_max"] <= 0 or set(result) != {"success", "close_to_target", "robot_close"} \
                or not all(0.0 <= v <= 1.0 for v in result.values()):
            fail(f"maniskill evaluator: result {dict(result)}, launches {launches}")
        for k in TPU_KERNELS:
            rec["launches"][k] += launches[k]
        rec["evaluator"] = {"levels": list(MANISKILL_LEVELS), "result": dict(result), "csv": csv_text,
                            "launches": launches, "s": ev_s}
        print(f"[maniskill] (c) mani.Evaluator on {env_cfg['env_name']} levels {list(MANISKILL_LEVELS)} with "
              f"{name}'s agent (model_final, deterministic act on the card): eval_info shares {dict(result)}; "
              f"kernel launches {launches}; {ev_s:.1f} s; CSV:\n{csv_text.strip()}", flush=True)
        print(f"[time] maniskill phase: {time.monotonic() - t0:.1f} s", flush=True)
    finally:
        if root in sys.path:
            sys.path.remove(root)
        for mod in ("gym", "sapien", "mani_skill", "mani_skill.env", "chip_smoke"):
            sys.modules.pop(mod, None)
        keep = osp.join(REPO, "build", "chip_smoke_maniskill_logs")
        shutil.rmtree(keep, ignore_errors=True)
        shutil.copytree(work, keep, ignore=shutil.ignore_patterns("models", "*.py", "standin", "profile"))
        shutil.rmtree(work, ignore_errors=True)
    return rec


PIPELINE_CONFIG = "configs/mfrl/drq/dm_control/pn_shift_tpu.py"
PIPE_SEED = 0
PIPE_CYCLES = 20  # timed cycles of 16 env steps and 16 updates, after the config's 1000-step warm-up
PIPE_PROFILED_CYCLES = 2  # more cycles, under torch.profiler: device busy ms and the idle share
PIPE_LOG_EVERY = 11 * 16  # env steps between the loop's log lines (one inside the run: reduce_metric_vecs)
ASYNC_REPEATS = 20  # timed forward_async / forward calls per agent


def async_check(name: str, agent, batches, card: str) -> dict:
    """``forward_async`` of a card agent: in eval mode its actions are
    bitwise ``forward``'s, two handles in flight hold their own actions,
    ``is_ready()`` never waits; host ms to dispatch, ms until ready and
    ``forward``'s ms."""
    import torch

    agent.eval()
    for obs in batches:  # first calls: cuBLAS handles, allocator
        agent.forward(obs, mode="eval")
    torch.cuda.synchronize()
    first, second = (agent.forward_async(obs, mode="eval") for obs in batches)
    events = [h._event for h in (first, second)]
    if not all(isinstance(e, torch.cuda.Event) for e in events):
        fail(f"pipeline {name}: forward_async of a card agent returned handles without a CUDA event: {events}")
    got = [np.asarray(first), np.asarray(second)]
    want = [agent.forward(obs, mode="eval") for obs in batches]
    if not all(np.array_equal(g, w) for g, w in zip(got, want)) or np.array_equal(got[0], got[1]):
        fail(f"pipeline {name}: forward_async's actions differ from forward's, or two handles share them")
    dispatch, ready, polls, fwd = [], [], [], []
    for _ in range(ASYNC_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = agent.forward_async(batches[0], mode="eval")
        t1 = time.perf_counter()
        while True:
            p0 = time.perf_counter()
            done = handle.is_ready()
            polls.append(time.perf_counter() - p0)
            if done:
                break
        t2 = time.perf_counter()
        if not np.array_equal(np.asarray(handle), want[0]):
            fail(f"pipeline {name}: a repeated forward_async gave other actions")
        dispatch.append(t1 - t0)
        ready.append(t2 - t0)
    for _ in range(ASYNC_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agent.forward(batches[0], mode="eval")
        fwd.append(time.perf_counter() - t0)
    rec = {"rows": int(want[0].shape[0]), "dispatch_ms": 1e3 * float(np.median(dispatch)),
           "ready_ms": 1e3 * float(np.median(ready)), "forward_ms": 1e3 * float(np.median(fwd)),
           "max_poll_ms": 1e3 * max(polls), "polls": len(polls)}
    print(f"[pipeline] (a) {name}: forward_async bitwise equal to forward in eval mode, two handles in flight "
          f"hold their own actions; median of {ASYNC_REPEATS}: {rec['dispatch_ms']:.3f} host ms to dispatch, "
          f"{rec['ready_ms']:.3f} ms until ready, forward {rec['forward_ms']:.3f} ms; the longest of "
          f"{rec['polls']} is_ready() polls {rec['max_poll_ms']:.4f} ms on {card}", flush=True)
    return rec


def pipeline_run(pf, lag: int, work: str, card: str, fused: bool = False) -> dict:
    """``pn_shift_tpu.py`` through ``train_rl`` with ``action_lag=lag`` (and
    ``act_fused_updates=fused``) over the walker stand-in: the dispatched
    and the applied actions, the buffer each update chunk sampled, the
    metric vectors and the kernel launches are recorded and checked."""
    import torch

    from pointcloud_rl_torch.algorithms import build_agent
    from pointcloud_rl_torch.apis.train_rl import train_rl
    from pointcloud_rl_torch.env import build_replay, build_rollout

    agent_cfg, info, cfg = walker_agent_cfg(PIPELINE_CONFIG)
    train_cfg = dict(cfg["train_cfg"])
    n_steps, n_updates, warm = train_cfg["n_steps"], train_cfg["n_updates"], train_cfg["warm_steps"]
    rollout_cfg = dict(cfg["rollout_cfg"], action_lag=lag, env_cfg=walker_env_cfg(), base_seed=PIPE_SEED,
                       vec_backend="thread", device="cuda")
    rollout = build_rollout(rollout_cfg)
    agent = build_agent(dict(agent_cfg, env_params=info, seed=PIPE_SEED, device="cuda"))
    replay = build_replay(cfg["replay_cfg"], dict(seed=PIPE_SEED), device=agent.device)
    events, dispatched, vecs, cycles = [], [], [], []
    acts = torch.profiler.ProfilerActivity
    forward_async, push_batch, scan = agent.forward_async, replay.push_batch, agent.update_parameters_scan
    fused_dispatch, finish_fused = agent._fused_act_dispatch, agent.finish_fused_updates
    collect = rollout.forward_with_policy

    def recorded_forward_async(obs, mode="explore", **kwargs):
        handle = forward_async(obs, mode=mode, **kwargs)
        dispatched.append(handle)
        return handle

    def recorded_push(batch):
        events.append(("push", len(replay), np.array(batch["actions"])))
        return push_batch(batch)

    def recorded_scan(memory, n):
        events.append(("scan", len(memory), n))
        vec = scan(memory, n)
        vecs.append(vec)
        return vec

    def recorded_fused_dispatch(obs):  # a chunk of updates inside the act, recorded as the hook's scans are
        size, chunk = len(replay), agent._fused_plan["chunk"]
        actions = fused_dispatch(obs)
        if actions is not None:
            events.append(("scan", size, chunk))
        return actions

    def recorded_finish():
        vec, done = finish_fused()
        if vec is not None:
            vecs.append(vec)
        return vec, done

    def timed_collect(pi, num, replay=None, **kwargs):
        if pi is None:  # the warm-up
            return collect(pi, num, replay, **kwargs)
        if len(cycles) >= PIPE_CYCLES:
            box = {}
            host, busy = profiled(lambda: box.update(out=collect(pi, num, replay, **kwargs)), acts)
            cycles.append((host / 1e3, busy))
            return box["out"]
        t0 = time.perf_counter()
        out = collect(pi, num, replay, **kwargs)
        cycles.append((time.perf_counter() - t0, None))
        return out

    agent.forward_async, replay.push_batch, agent.update_parameters_scan = (
        recorded_forward_async, recorded_push, recorded_scan)
    agent._fused_act_dispatch, agent.finish_fused_updates = recorded_fused_dispatch, recorded_finish
    rollout.forward_with_policy = timed_collect
    total = warm + (PIPE_CYCLES + PIPE_PROFILED_CYCLES) * n_steps
    try:
        reset_counters()
        out = train_rl(agent, rollout, None, replay, work_dir=work, total_steps=total, warm_steps=warm,
                       n_steps=n_steps, n_updates=n_updates, n_log=PIPE_LOG_EVERY, n_eval=-1, n_checkpoint=-1,
                       stall_timeout=train_cfg["stall_timeout"], act_fused_updates=fused)
        torch.cuda.synchronize()
        launches = launched(pf)
    finally:
        rollout.close()
    # the applied actions: the dispatch of the previous group-step (lag 1) or their own (lag 0)
    pushes = [e for e in events if e[0] == "push"][1:]  # after the warm-up's one push
    n_cycles = PIPE_CYCLES + PIPE_PROFILED_CYCLES
    if len(pushes) != n_cycles or len(dispatched) != n_cycles:
        fail(f"pipeline lag {lag}: {len(pushes)} pushes and {len(dispatched)} act dispatches for {n_cycles} cycles")
    actions = [np.asarray(h) for h in dispatched]
    for c, (_, _, applied) in enumerate(pushes):
        src = max(c - lag, 0)
        if not np.array_equal(applied, actions[src]):
            fail(f"pipeline lag {lag}: cycle {c} applied other actions than dispatch {src}")
    if lag and any(np.array_equal(actions[c], actions[c - 1]) for c in range(1, n_cycles)):
        fail("pipeline: two dispatches gave the same actions")
    # each cycle's updates: one chunk of 16 after its act dispatch, on the buffer before its push
    want = []
    for c in range(n_cycles):
        size = warm + c * n_steps
        want += [("scan", size, n_updates), ("push", size)]
    got = [e[:3] if e[0] == "scan" else e[:2] for e in events[1:]]
    if got != want:
        fail(f"pipeline lag {lag}: the updates and pushes ran as {got[:6]}..., expected {want[:6]}...")
    vec_sum = torch.stack(vecs).sum(0)
    if not bool(torch.isfinite(torch.stack(vecs)).all()):
        fail(f"pipeline lag {lag}: non-finite update metrics")
    metrics = agent.reduce_metric_vecs(vec_sum, n_cycles * n_updates)
    for kname in TRAIN_KERNELS:
        if launches[kname] <= 0:
            fail(f"{kname} was never launched by the pipeline run (lag {lag})")
    timed = [w for w, busy in cycles[2:PIPE_CYCLES]]  # the first two hold first calls, the eager run and the capture
    wall_cycle = float(np.mean(timed))
    busy_cycle = float(np.mean([busy for _, busy in cycles[PIPE_CYCLES:]]))
    rec = {"config": PIPELINE_CONFIG, "action_lag": lag, "act_fused_updates": fused, "envs": rollout.num_envs,
           "pipeline_groups": rollout.pipeline_groups, "warm_steps": warm, "cycles": n_cycles,
           "updates": out["grad_steps"], "env_steps": out["steps"], "launches": launches,
           "env_steps_per_s": n_steps / wall_cycle, "updates_per_s": n_updates / wall_cycle,
           "ms_per_cycle": 1e3 * wall_cycle, "device_busy_ms_per_cycle": busy_cycle,
           "device_idle_share": 1.0 - busy_cycle / (1e3 * wall_cycle),
           "critic_loss_mean": metrics["drq/critic_loss"], "main_loop_s": out["main_loop_s"],
           "programs": program_stats(agent)}
    where = "inside the act's program (act_fused_updates)" if fused else "after the act dispatch"
    print(f"[pipeline] (b) action_lag={lag}: {rec['env_steps']} env steps ({warm} warm-up, then {n_cycles} cycles "
          f"of {n_steps} env steps in {rec['pipeline_groups']} group with {n_updates} updates {where}), "
          f"{rec['updates']} updates; every applied action row is the dispatch of "
          f"{'the group-step before' if lag else 'its own step'} (bitwise); every cycle's {n_updates} updates "
          f"sampled the buffer before its push; metric vectors finite (mean critic loss "
          f"{rec['critic_loss_mean']:.4g}); kernel launches {launches}", flush=True)
    print(f"[pipeline] (b) action_lag={lag}{', act-fused' if fused else ''}: {rec['env_steps_per_s']:.1f} env steps/s "
          f"and {rec['updates_per_s']:.1f} "
          f"updates/s over cycles 3-{PIPE_CYCLES} ({rec['ms_per_cycle']:.1f} ms per cycle); device busy "
          f"{busy_cycle:.2f} ms per cycle over {PIPE_PROFILED_CYCLES} profiled cycles, idle "
          f"{rec['device_idle_share']:.1%} of the unprofiled cycle on {card}", flush=True)
    del agent, replay, vecs
    torch.cuda.empty_cache()
    return rec


def phase_pipeline(pf, card: str) -> dict:
    """(a) ``forward_async`` of the SAC agent and of the walker agent on the
    card; (b) the DrQ walker recipe ``pn_shift_tpu.py`` through
    ``train_rl``: the pipelined rollout with ``action_lag`` 1 (the config's)
    and 0, updates interleaved with the collection."""
    import torch

    from pointcloud_rl_torch.algorithms import build_agent
    from pointcloud_rl_torch.env import build_vec_env

    t0 = time.monotonic()
    rec: dict = {"forward_async": {}, "runs": {}, "launches": {k: 0 for k in TRAIN_KERNELS}}
    agent_cfg, info, env_cfg = resolved_agent_cfg(SLICE_CONFIG, [FUSED])
    frames = env_frames(env_cfg, 8, seed=2)
    sac = build_agent(dict(agent_cfg, env_params=info, seed=0, device="cuda"))
    batches = [{k: v[i:i + 4] for k, v in frames.items()} for i in (0, 4)]
    rec["forward_async"]["sac"] = async_check(f"SAC {SLICE_CONFIG} (4 x 1200 x 8, f32)", sac, batches, card)
    del sac
    agent_cfg, info, _ = walker_agent_cfg()
    walker = build_agent(dict(agent_cfg, env_params=info, seed=DMC_SEED, device="cuda"))
    env = build_vec_env(walker_env_cfg(), WALKER["envs"], base_seed=DMC_SEED + 200, vec_backend="thread",
                        device="cuda")
    try:
        first = env.reset()
        second = env.step(np.stack([env.single_action_space.sample() for _ in range(WALKER["envs"])]))[0]
    finally:
        env.close()
    rec["forward_async"]["walker"] = async_check(
        f"walker {WALKER_CONFIG} (16 x 1536 x 9, bf16, float16 act upload)", walker, [first, second], card)
    del walker
    _, _, cfg = walker_agent_cfg(PIPELINE_CONFIG)
    steps = cfg["train_cfg"]["warm_steps"] + (PIPE_CYCLES + PIPE_PROFILED_CYCLES) * cfg["train_cfg"]["n_steps"]
    print(f"[pipeline] cuts of {PIPELINE_CONFIG}: env dmc_cheetah_run-v0 -> chip_smoke.WalkerRawStandIn behind "
          f"ServerObsVectorEnv (no dm_control on this machine); total_steps {cfg['train_cfg']['total_steps']} -> "
          f"{steps}; n_log -> {PIPE_LOG_EVERY}; replay capacity {cfg['replay_cfg']['capacity']} (not cut)",
          flush=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_pipeline_", dir=osp.join(REPO, "build"))
    try:
        for lag, fused in ((1, False), (0, False), (1, True)):
            run = pipeline_run(pf, lag, osp.join(work, f"lag{lag}_{fused}"), card, fused)
            rec["runs"][f"action_lag_{lag}" + ("_act_fused" if fused else "")] = run
            for k in TRAIN_KERNELS:
                rec["launches"][k] += run["launches"][k]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec["s"] = time.monotonic() - t0
    print(f"[time] pipeline phase: {rec['s']:.1f} s", flush=True)
    return rec


GRAPH_FILL = 4096  # seeded full-width transitions in the replay before the graphs phase's updates
GRAPH_PUSH = 2048  # pushed between the captures and the replays: the replay's size grows under the graphs
GRAPH_SCANS = (16, 3, 16, 3)  # a round of scans: the interval-2 gates' phases 0, 0, 1, 1
GRAPH_ROUNDS = 3  # round 0 runs each program eagerly, round 1 captures and replays, round 2 replays
GRAPH_TIMED = 10  # timed calls of each program, eager and graphed, host clock and torch.profiler
GRAPH_FUSED_CHUNK = 16  # act-fused chunk: the walker recipe's 16 updates per act of its 16 envs


def train_state_mismatch(a, b) -> list:
    """The parts of two agents' train states that differ bitwise:
    parameters, target, alpha, every optimizer state tensor, the update
    counter and the agent's generator."""
    import torch

    sa, sb = a.state_dict(), b.state_dict()
    bad = [f"{part}.{k}" for part in ("model", "target") for k, v in sa[part].items()
           if not torch.equal(v, sb[part][k])]
    if not torch.equal(sa["log_alpha"], sb["log_alpha"]):
        bad.append("log_alpha")
    for opt in ("actor_opt", "critic_opt", "alpha_opt"):
        for i, st in sa[opt]["state"].items():
            bad += [f"{opt}[{i}].{k}" for k, v in st.items() if not torch.equal(v, sb[opt]["state"][i][k])]
    if sa["updates"] != sb["updates"]:
        bad.append(f"updates {sa['updates']} vs {sb['updates']}")
    if not torch.equal(sa["generator"], sb["generator"]):
        bad.append("generator")
    return bad


def graph_twins(agent_cfg: dict, info: dict, ranks: bool = False):
    """Two agents on the card in one state: one runs the update programs
    (CUDA graphs), the other calls the eager step they capture; with
    ``ranks``, both are ranks of the process group."""
    from pointcloud_rl_torch.algorithms import build_agent

    graphed = build_agent(dict(agent_cfg, env_params=info, seed=0, device="cuda"))
    eager = build_agent(dict(agent_cfg, env_params=info, seed=0, device="cuda"))
    eager.load_state_dict(graphed.state_dict())
    if ranks:
        import torch.distributed as dist

        from pointcloud_rl_torch.parallel import setup_data_parallel

        for agent in (graphed, eager):
            setup_data_parallel(agent, dist.get_world_size())
        if not graphed._graphed():
            fail(f"dp: a {dist.get_backend()} rank's updates are not graphed")
    return graphed, eager


def graph_check(name: str, what: str, graphed, eager, got, want, replay=None, after=None) -> None:
    import torch

    bad = train_state_mismatch(graphed, eager)
    if not torch.equal(got, want):
        bad.append(f"the summed metric vectors ({(got - want).abs().max().item():.3e} apart)")
    if replay is not None and not torch.equal(replay.generator.get_state(), after):
        bad.append("the replay's generator")
    if bad:
        fail(f"graphs {name}: {what}: the graphed update differs from the eager one bitwise in {bad[:6]}")


def graph_timing(fn_eager, fn_graphed, n: int, acts) -> dict:
    """Per update, eager vs graphed: host ms until the call returns, ms until
    the card is done (host clock around ``synchronize``), device busy ms
    (``torch.profiler``); medians of ``GRAPH_TIMED`` calls."""
    import torch

    out = {}
    for label, fn in (("eager", fn_eager), ("graphed", fn_graphed)):
        host, wall = [], []
        for _ in range(GRAPH_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            host.append(t1 - t0)
            wall.append(time.perf_counter() - t0)
        _, busy = profiled(fn, acts)
        out[f"{label}_host_ms_per_update"] = 1e3 * float(np.median(host)) / n
        out[f"{label}_wall_ms_per_update"] = 1e3 * float(np.median(wall)) / n
        out[f"{label}_device_ms_per_update"] = busy / n
    out["graphed_idle_share"] = 1.0 - out["graphed_device_ms_per_update"] / out["graphed_wall_ms_per_update"]
    out["eager_idle_share"] = 1.0 - out["eager_device_ms_per_update"] / out["eager_wall_ms_per_update"]
    return out


def program_stats(agent) -> dict:
    stats = agent._programs.stats()
    progs = stats["programs"]
    return {"programs": stats, "capture_ms": {k: v["capture_ms"] for k, v in progs.items()},
            "pool_mb": sum(v["pool_bytes"] for v in progs.values()) / 2**20}


def graphs_storage(pf, name: str, config: str, card: str, acts, ranks: bool = False) -> dict:
    """(1) / (2): scans over the recipe's packed ``DeviceReplayMemory``, at
    both gate phases, graphed against eager from one state; the replay
    grows between the captures and the replays.  ``ranks``: both agents
    are ranks of the process group."""
    import torch

    from pointcloud_rl_torch.env import build_replay

    agent_cfg, info, cfg = walker_agent_cfg(config)
    replay = build_replay(cfg["replay_cfg"], dict(seed=0), device="cuda")
    replay.push_batch(walker_raw_block(GRAPH_FILL, seed=1))
    graphed, eager = graph_twins(agent_cfg, info, ranks)
    n_updates = cfg["train_cfg"]["n_updates"]
    scans = tuple(n_updates if k == 16 else k for k in GRAPH_SCANS)
    sizes = []
    for rnd in range(GRAPH_ROUNDS):
        for n in scans:
            start = replay.generator.get_state()
            got = graphed.update_parameters_scan(replay, n)
            after = replay.generator.get_state()
            replay.generator.set_state(start)
            want = eager._update_vecs(replay, n)
            graph_check(name, f"round {rnd}, a scan of {n} at update {eager.updates - n}", graphed, eager, got,
                        want, replay, after)
        sizes.append(len(replay))
        if rnd == 1:
            replay.push_batch(walker_raw_block(GRAPH_PUSH, seed=2))
    print(f"[graphs] {name} ({config}, {type(graphed).__name__}): rounds of scans {scans} over the packed replay of "
          f"{sizes} transitions (pushed after the captures): graphed == eager bitwise after every scan (parameters, "
          f"target, the optimizers' state, log_alpha, the update counter, the generators, the summed metrics); "
          f"{len(graphed._programs.programs)} programs", flush=True)
    timing = graph_timing(lambda: eager._update_vecs(replay, n_updates),
                          lambda: graphed.update_parameters_scan(replay, n_updates), n_updates, acts)
    rec = {"config": config, "scans": list(scans), "rounds": GRAPH_ROUNDS, "replay_sizes": sizes,
           "updates": graphed.updates, **timing, **program_stats(graphed)}
    print(f"[graphs] {name}: per update, eager {timing['eager_host_ms_per_update']:.2f} host ms "
          f"({timing['eager_wall_ms_per_update']:.2f} ms to done, device {timing['eager_device_ms_per_update']:.2f}, "
          f"idle {timing['eager_idle_share']:.1%}) vs graphed {timing['graphed_host_ms_per_update']:.3f} host ms "
          f"({timing['graphed_wall_ms_per_update']:.2f} ms to done, device "
          f"{timing['graphed_device_ms_per_update']:.2f}, idle {timing['graphed_idle_share']:.1%}); captures "
          f"{ {k: round(v, 1) for k, v in rec['capture_ms'].items()} } ms, pool {rec['pool_mb']:.1f} MB on {card}",
          flush=True)
    return rec, graphed, eager, replay


def graphs_act_fused(pf, graphed, eager, replay, card: str, acts) -> dict:
    """The walker agent's act-fused forwards (16 updates, then the explore
    act on 16 envs) against 16 eager updates then the eager act; then one
    replay of the scan program under ``torch.profiler``: the body kernels
    in its trace against the launches it adds to ``launch_counts``."""
    import torch

    # the timed calls drew other replay rows for each; a host copy, so that
    # the twins' optimizer states share no tensor
    eager.load_state_dict(train_state_on_host(graphed))
    obs = walker_raw_block(WALKER["envs"], seed=3)["obs"]
    chunk = GRAPH_FUSED_CHUNK
    if not graphed.set_fused_updates(replay, chunk, 4 * chunk):
        fail("graphs: set_fused_updates refused the walker's device replay")
    for step in range(4):  # eager, capture + replay, replay, replay
        start = replay.generator.get_state()
        got = graphed.forward(obs, mode="explore")
        after = replay.generator.get_state()
        replay.generator.set_state(start)
        vec = eager._update_vecs(replay, chunk)
        with torch.no_grad():
            want = eager.act(eager._upload_obs(obs), "explore").cpu().numpy()
        if not np.array_equal(got, want):
            fail(f"graphs act_fused: forward {step}: the fused actions differ from the eager ones bitwise "
                 f"(max {np.abs(got - want).max():.3e})")
        graph_check("act_fused", f"forward {step}", graphed, eager, vec, vec, replay, after)
    vec, done = graphed.finish_fused_updates()
    if done != 4 * chunk or not bool(torch.isfinite(vec).all()):
        fail(f"graphs act_fused: {done} updates, metrics finite {bool(torch.isfinite(vec).all())}")
    print(f"[graphs] act_fused: 4 explore forwards of {WALKER['envs']} envs, each {chunk} updates then the act in one "
          f"program: actions and train state bitwise the eager {chunk} updates then act", flush=True)

    # the launches inside one replay: the profiler's kernels against launch_counts
    graphed.update_parameters_scan(replay, chunk)  # phase 0 again
    torch.cuda.synchronize()
    before = dict(pf.launch_counts)
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
        graphed.update_parameters_scan(replay, chunk)
        torch.cuda.synchronize()
    added = {k: pf.launch_counts[k] - before[k] for k in before}
    with tempfile.TemporaryDirectory(dir=osp.join(REPO, "build")) as tmp:
        prof.export_chrome_trace(osp.join(tmp, "trace.json"))
        with open(osp.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    traced = {k: 0 for k in before}
    for evt in events:
        for kname, body in (("pointnet_fused_fwd_idx", "pointnet_body_idx_kernel"),
                            ("pointnet_fused_fwd_max", "pointnet_body_max_kernel")):
            if evt.get("cat") == "kernel" and body in evt.get("name", ""):
                traced[kname] += 1
    if traced != added or not all(added.values()):
        fail(f"graphs: one replay of the {chunk}-update program traced the body kernels {traced} times, "
             f"launch_counts added {added}")
    print(f"[graphs] one replay of the {chunk}-update program: torch.profiler traced the body kernels {traced} times, "
          f"launch_counts added {added} on {card}", flush=True)
    return {"chunk": chunk, "forwards": 4, "replay_kernels_traced": traced, "launch_counts_added": added}


def graphs_host_batch(pf, card: str, acts, ranks: bool = False) -> dict:
    """(3): the SAC slice (f32, 256 x 1200 x 8) on host batches: the
    one-update program, each batch copied into its static inputs, against
    the eager update on the same batch, at both gate phases."""
    agent_cfg, info, _ = resolved_agent_cfg(SLICE_CONFIG, [FUSED])
    graphed, eager = graph_twins(agent_cfg, info, ranks)
    rs = np.random.RandomState(4)
    B = graphed.batch_size

    def obs():
        out = {}
        for k, shape in info["obs_shape"].items():
            shape = (B,) + ((shape,) if isinstance(shape, int) else tuple(shape))
            out[k] = (rs.randint(0, 256, shape).astype(np.uint8) if k == "rgb"
                      else rs.uniform(-1, 1, shape).astype(np.float32))
        return out

    def batch():
        return dict(obs=obs(), next_obs=obs(), actions=rs.uniform(-1, 1, (B, info["action_shape"])).astype(np.float32),
                    rewards=rs.uniform(0, 1, (B, 1)).astype(np.float32), dones=rs.rand(B, 1) < 0.05)

    batches = [batch() for _ in range(2)]
    for u in range(8):  # phases 0, 1 eager; then captures; then replays
        b = batches[u % 2]
        got = graphed.update_parameters_lazy(_Batch(b), u)
        want = eager._batch_update_vec(eager._prepare_batch(dict(b)))
        graph_check("host_batch", f"update {u}", graphed, eager, got, want)
    print(f"[graphs] host_batch ({SLICE_CONFIG}, f32, {B} x 1200 x 8): 8 one-update programs on host batches copied "
          f"into the graph's static inputs, graphed == eager bitwise after each", flush=True)
    timing = graph_timing(lambda: eager._batch_update_vec(eager._prepare_batch(dict(batches[0]))),
                          lambda: graphed.update_parameters_lazy(_Batch(batches[0]), 0), 1, acts)
    rec = {"config": SLICE_CONFIG, "updates": graphed.updates, **timing, **program_stats(graphed)}
    print(f"[graphs] host_batch: per update (the batch's upload included), eager "
          f"{timing['eager_host_ms_per_update']:.2f} host ms ({timing['eager_wall_ms_per_update']:.2f} to done, device "
          f"{timing['eager_device_ms_per_update']:.2f}) vs graphed {timing['graphed_host_ms_per_update']:.2f} host ms "
          f"({timing['graphed_wall_ms_per_update']:.2f} to done, device {timing['graphed_device_ms_per_update']:.2f}); "
          f"captures { {k: round(v, 1) for k, v in rec['capture_ms'].items()} } ms, pool {rec['pool_mb']:.1f} MB "
          f"on {card}", flush=True)
    return rec


def phase_graphs(pf, card: str) -> dict:
    """The update programs as CUDA graphs against the eager step they
    capture, on the card, bitwise: (1) the walker recipe's scans, (2) the
    DrQ walker recipe's, (3) the SAC slice's one-update program on host
    batches, the walker's act-fused forwards, and the kernels inside one
    replay; host and device ms per update, capture ms, the pool's memory."""
    import torch

    t0 = time.monotonic()
    acts = torch.profiler.ProfilerActivity
    rec: dict = {}
    reset_counters()
    rec["walker"], graphed, eager, replay = graphs_storage(pf, "walker", WALKER_CONFIG, card, acts)
    rec["act_fused"] = graphs_act_fused(pf, graphed, eager, replay, card, acts)
    del graphed, eager, replay
    torch.cuda.empty_cache()
    rec["drq_walker"], graphed, eager, replay = graphs_storage(pf, "drq_walker", PIPELINE_CONFIG, card, acts)
    del graphed, eager, replay
    torch.cuda.empty_cache()
    rec["host_batch"] = graphs_host_batch(pf, card, acts)
    rec["launches"] = launched(pf)
    rec["s"] = time.monotonic() - t0
    print(f"[time] graphs phase: {rec['s']:.1f} s", flush=True)
    return rec


CONV_LAYERS = {"conv0": (32, 32, 64), "conv1": (64, 16, 64), "conv2": (64, 8, 128)}  # C_in, grid side, C_out
CONV_CLOUDS = 512  # DrQ's 256 rows x 2 shifted copies
U_F32 = 2.0**-24


def conv_sass(lib_path: str) -> dict:
    """{kernel: counts of HMMA/HGMMA and of float RED/ATOM} of the conv library."""
    from pointcloud_rl_torch.ops import build as kbuild

    cuobjdump = osp.join(osp.dirname(kbuild.find_nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True, timeout=120,
                         check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            counts[fn] = {"mma": 0, "float_atomic": 0, "ffma": 0}
        elif fn is not None:
            counts[fn]["mma"] += "HMMA" in line or "HGMMA" in line
            counts[fn]["float_atomic"] += ("RED" in line or "ATOM" in line) and (".F32" in line or ".FADD" in line)
            counts[fn]["ffma"] += "FFMA" in line
    return counts


def phase_conv(card: str) -> dict:
    """The voxel encoder's convolutions through the port's kernels at the
    cell's shapes: gaps to f64, whether the forward has cuDNN's bits, ms
    beside the bound and cuDNN's ms.  Returns {"<kind>.<layer>": {...},
    "sass": {kernel: counts}}."""
    import torch
    import torch.nn.functional as F

    from pointcloud_rl_torch.ops import build as kbuild
    from pointcloud_rl_torch.ops import conv as tconv

    t0 = time.monotonic()
    lib_path = kbuild.build_library("conv3d", verbose=True)
    tconv.load_library()
    print(f"[build] conv3d built and loaded in {time.monotonic() - t0:.1f} s", flush=True)
    sass = conv_sass(str(lib_path))
    for k, v in sorted(sass.items()):
        print(f"[sass] {k}: {v}", flush=True)
    if not sass or any(v["mma"] or v["float_atomic"] for v in sass.values()) or not all(v["ffma"] for v in sass.values()):
        fail(f"the conv3d kernels must be f32 FFMA with no tensor-core or float atomic instruction: {sass}")
    cl = torch.channels_last_3d
    s, pad, k = 2, (1, 1, 1), 4
    out = {}
    for layer, (c_in, n, c_out) in CONV_LAYERS.items():
        g = torch.Generator(device="cuda").manual_seed(7)
        x = torch.randn(CONV_CLOUDS, c_in, n, n, n, device="cuda", generator=g).contiguous(memory_format=cl)
        w = torch.randn(c_out, c_in, k, k, k, device="cuda", generator=g) / (c_in * k**3) ** 0.5
        b = torch.randn(c_out, device="cuda", generator=g) * 0.1
        m = n // 2
        dy = torch.randn(CONV_CLOUDS, c_out, m, m, m, device="cuda", generator=g).contiguous(memory_format=cl)
        flop = 2 * CONV_CLOUDS * m**3 * c_out * c_in * k**3
        kernels = {
            "fprop": lambda: tconv._fprop(x, w, b, (s,) * 3, pad),
            "dgrad": lambda: tconv._dgrad(dy, x, w, (s,) * 3, pad),
            "wgrad": lambda: tconv._wgrad(dy, x, w, (s,) * 3, pad, True),
        }
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            library = {
                "fprop": lambda: F.conv3d(x, w, b, s, pad),
                "dgrad": lambda: torch.ops.aten.convolution_backward(
                    dy, x, w, None, [s] * 3, list(pad), [1] * 3, False, [0] * 3, 1, [True, False, False])[0],
                "wgrad": lambda: torch.ops.aten.convolution_backward(
                    dy, x, w, [c_out], [s] * 3, list(pad), [1] * 3, False, [0] * 3, 1, [False, True, True])[1:],
            }
            x64, w64, b64, dy64 = x.double(), w.double(), b.double(), dy.double()
            y64 = F.conv3d(x64, w64, b64, s, pad)
            dx64, dw64, db64 = torch.ops.aten.convolution_backward(
                dy64, x64, w64, [c_out], [s] * 3, list(pad), [1] * 3, False, [0] * 3, 1, [True, True, True])
            exact = {"fprop": (y64,), "dgrad": (dx64,), "wgrad": (dw64, db64)}
            plan = tconv.wgrad_plan(x, w, dy)
            chain = {"fprop": k**3 * c_in, "dgrad": 8 * c_out, "wgrad": plan["chunk_len"] + plan["chunks"]}
            for kind in ("fprop", "dgrad", "wgrad"):
                got, lib_got = kernels[kind](), library[kind]()
                got = got if isinstance(got, tuple) else (got,)
                lib_got = lib_got if isinstance(lib_got, tuple) else (lib_got,)
                gaps, yards = [], []
                for a, c, e in zip(got, lib_got, exact[kind]):
                    scale = e.abs().max().clamp_min(1e-300)
                    gaps.append(float((a.double() - e).abs().max() / scale))
                    yards.append(float((c.double() - e).abs().max() / scale))
                rec = {"gap": max(gaps), "library_gap": max(yards), "tolerance": chain[kind] * U_F32}
                for gap, yard in zip(gaps, yards):
                    if not gap <= chain[kind] * U_F32 or not gap <= 2 * yard + 2 * U_F32:
                        fail(f"conv3d {kind} {layer}: gap {gap:.3e} past n u = {chain[kind] * U_F32:.3e} "
                             f"or twice cuDNN's {yard:.3e}")
                if kind == "fprop":  # reported: the kernels are held to f64 and cuDNN's gap, not its bits
                    rec["bitwise_library"] = bool(torch.equal(got[0], lib_got[0].contiguous(memory_format=cl)))
                again = kernels[kind]()
                again = again if isinstance(again, tuple) else (again,)
                if not all(torch.equal(a, c) for a, c in zip(got, again)):
                    fail(f"conv3d {kind} {layer}: two calls differ")
                ms, lib_ms = time_ms(kernels[kind], iters=10), time_ms(library[kind], iters=10)
                nbytes = 4 * (x.numel() + w.numel() + dy.numel())
                bound = 1e3 * max(flop / PEAK_F32, nbytes / PEAK_BYTES)
                rec.update(ms=ms, bound_ms=bound, bound_by="ops" if flop / PEAK_F32 >= nbytes / PEAK_BYTES else "bytes", share_of_bound=bound / ms, library_ms=lib_ms,
                           tflop_s=flop / ms / 1e9, gflop=flop / 1e9)
                out[f"{kind}.{layer}"] = rec
                print(f"[conv] {kind} {layer}: {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s), bound {bound:.3f} ms "
                      f"({bound / ms:.1%}), cuDNN {lib_ms:.3f} ms; gap {rec['gap']:.2e} (cuDNN {rec['library_gap']:.2e})"
                      f" on {card}", flush=True)
        del x, w, b, dy, x64, w64, b64, dy64, y64, dx64, dw64, db64, exact
        torch.cuda.empty_cache()
    out["sass"] = sass
    return out


def main() -> int:
    t_start = time.monotonic()
    if not osp.isdir(osp.join(REPO, "pointcloud_rl_torch")):
        fail(f"the port's package is not beside {__file__}; run from a checkout of the repo")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    argv = sys.argv[1:]
    for flag, worker in (("--dp-worker", dp_worker), ("--hosts-worker", hosts_worker),
                         ("--interleave-worker", interleave_worker)):
        if flag in argv:  # a process of the dp or the hosts phase
            at = argv.index(flag)
            worker(argv[at + 1], argv[at + 2])
            return 0
    kernels_only = "--kernels-only" in argv
    # --only PHASE[,PHASE]: graphs, runs, encoders, conv, modules, dmc, dp, hosts, hosts-nccl, replay-io,
    # maniskill, pipeline (the kernel phase always runs)
    only = set(argv[argv.index("--only") + 1].split(",")) if "--only" in argv else None

    def wanted(phase: str) -> bool:
        return not kernels_only and (only is None or phase in only)

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    card = f"{kind} ({smi})"
    print(f"[card] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    from pointcloud_rl_torch.ops import build as kbuild
    from pointcloud_rl_torch.ops import pointnet_fused as pf

    t0 = time.monotonic()
    lib_path = kbuild.build_library("pointnet_fused", verbose=True)
    pf.load_library()
    print(f"[build] {KERNEL_SOURCE} built and loaded in {time.monotonic() - t0:.1f} s", flush=True)
    hgmma = phase_sass(str(lib_path))

    report: dict = {}
    phase_kernels(pf, report, card)
    bwd = phase_bwd_kernel(pf, card)
    print(f"[time] build and kernel phases: {time.monotonic() - t0:.1f} s", flush=True)

    by_run: dict = {}
    if wanted("graphs"):
        graphs = phase_graphs(pf, card)
        by_run["graphs"] = graphs["launches"]
        print(json.dumps({"graphs": graphs}), flush=True)
        print(f"[time] through the graphs phase: {time.monotonic() - t0:.1f} s", flush=True)
    if wanted("runs"):
        work = tempfile.mkdtemp(prefix="chip_smoke_", dir=osp.join(REPO, "build"))
        summaries = {}

        def one_run(name, config, opts, prefix, pointnet, total, profile=0):
            t_run = time.monotonic()
            summary = phase_train(work, name, config, opts, prefix, pointnet, total, profile)
            replay = summary["replay"]
            if name == "drq_device" and not (replay["type"] == "DeviceReplayMemory"
                                             and replay["device"].startswith("cuda")
                                             and replay["storage_bytes"] > 0):
                fail(f"drq_device: the replay is {replay}, not a DeviceReplayMemory on cuda")
            phase_reference(name, config, opts, summary["models_dir"],
                            ACTION_ATOL_BF16 if "agent_cfg.bf16=True" in opts else ACTION_ATOL, total)
            print(f"[time] run {name}: {time.monotonic() - t_run:.1f} s", flush=True)
            return summary

        try:
            # the SAC slice alone, its first env steps traced; then the others
            # RUNS_AT_ONCE at a time: their process starts, warm-ups and
            # evaluations are most of the phase; a failure in one (fail's
            # SystemExit) is raised here by result()
            summaries[RUNS[0][0]] = one_run(*RUNS[0], profile=RUNS_PROFILE_STEPS)
            with concurrent.futures.ThreadPoolExecutor(RUNS_AT_ONCE) as pool:
                futures = {run[0]: pool.submit(one_run, *run) for run in RUNS[1:]}
                for name, future in futures.items():
                    summaries[name] = future.result()
        finally:
            keep = osp.join(REPO, "build", "chip_smoke_logs")
            shutil.rmtree(keep, ignore_errors=True)
            shutil.copytree(work, keep, ignore=shutil.ignore_patterns("models", "*.py"))
            shutil.rmtree(work, ignore_errors=True)
        for name, summary in summaries.items():
            by_run[name] = run_launches(summary)
            idle = (f"; device busy {summary['device_busy_ms_per_env_step']:.2f} ms per env step over the first "
                    f"{RUNS_PROFILE_STEPS} (traced), idle {summary['device_idle_share']:.1%} of the main loop, alone"
                    if "device_idle_share" in summary else f", {RUNS_AT_ONCE} runs at a time")
            print(f"[{name}] {summary['env_steps_per_s']:.1f} env steps/s, "
                  f"{summary['updates_per_s']:.1f} updates/s over the main loop "
                  f"({summary['main_loop_s']:.1f} s){idle} on {card}", flush=True)
        print(json.dumps({"runs": {name: {k: summary.get(k) for k in (
            "env_steps_per_s", "updates_per_s", "main_loop_s", "launches", "bwd_launches", "conv_calls",
            "conv3d_launches", "device_busy_ms_per_env_step", "device_idle_share")} for name, summary in summaries.items()}}), flush=True)
        print(f"[time] through the training runs: {time.monotonic() - t0:.1f} s", flush=True)
    if wanted("encoders"):
        phase_encoders(card)
        print(f"[time] through the encoder phase: {time.monotonic() - t0:.1f} s", flush=True)
    conv = None
    if wanted("conv"):
        conv = phase_conv(card)
        print(json.dumps({"conv": conv}), flush=True)
        print(f"[time] through the conv phase: {time.monotonic() - t0:.1f} s", flush=True)
    if wanted("modules"):
        phase_modules(card)
        print(f"[time] through the module phase: {time.monotonic() - t0:.1f} s", flush=True)
    dmc = None
    if wanted("dmc"):
        phase_dmc_modules(card)
        print(f"[time] through the dmc module phase: {time.monotonic() - t0:.1f} s", flush=True)
        dmc = phase_dmc(pf, card)
        by_run["dmc"] = dmc["launches"]
        print(json.dumps({"dmc": dmc}), flush=True)
        print(f"[time] through the dmc run: {time.monotonic() - t0:.1f} s", flush=True)
    # --dp-nccl-ranks N: the dp phase's NCCL runs span N cards (one per rank), with a run_rl
    # --num-devices N; with N >= 2 the hosts-nccl phase runs two torchrun agents over NCCL
    nccl_ranks = int(argv[argv.index("--dp-nccl-ranks") + 1]) if "--dp-nccl-ranks" in argv else 1
    if torch.cuda.device_count() < nccl_ranks:
        fail(f"--dp-nccl-ranks {nccl_ranks}: {torch.cuda.device_count()} cards")
    if wanted("dp"):
        dp = phase_dp(card, nccl_ranks)
        by_run["dp"] = dp["launches"]
        print(json.dumps({"dp": dp}), flush=True)
        print(f"[time] through the dp phase: {time.monotonic() - t0:.1f} s", flush=True)
    if wanted("hosts"):
        hosts = phase_hosts(card)
        by_run["hosts"] = hosts["launches"]
        print(json.dumps({"hosts": hosts}), flush=True)
        print(f"[time] through the hosts phase: {time.monotonic() - t0:.1f} s", flush=True)
    if wanted("hosts-nccl") and nccl_ranks > 1:  # (c) two torchrun agents, a card each, over NCCL
        hosts_nccl = phase_hosts_nccl(card)
        by_run["hosts_nccl"] = hosts_nccl["launches"]
        print(json.dumps({"hosts_nccl": hosts_nccl}), flush=True)
        print(f"[time] through the hosts-nccl phase: {time.monotonic() - t0:.1f} s", flush=True)
    if wanted("replay-io"):
        rio = phase_replay_io(pf, card)
        by_run["replay_io"] = rio["launches"]
        print(json.dumps({"replay_io": rio}), flush=True)
        print(f"[time] through the replay-io phase: {time.monotonic() - t0:.1f} s", flush=True)
    if wanted("maniskill"):
        mani = phase_maniskill(card)
        by_run["maniskill"] = mani["launches"]
        print(json.dumps({"maniskill": mani}), flush=True)
        print(f"[time] through the maniskill phase: {time.monotonic() - t0:.1f} s", flush=True)
    if wanted("pipeline"):
        pipe = phase_pipeline(pf, card)
        by_run["pipeline"] = pipe["launches"]
        print(json.dumps({"pipeline": pipe}), flush=True)
        print(f"[time] through the pipeline phase: {time.monotonic() - t0:.1f} s", flush=True)

    launches = {k: (sum(run[k] for run in by_run.values()) if by_run else None) for k in TPU_KERNELS}
    kernels = []
    for kname, rec in report.items():
        shp = rec["shapes"]
        slice_t = shp["slice_f32"]
        kernels.append({
            "name": kname, "route": "cuda", "source": KERNEL_SOURCE, "replaces": TPU_KERNELS[kname],
            "launches": launches[kname], "max_abs_err": rec["max_abs_err"],
            "ms": slice_t["ms"], "plain_ms": slice_t["plain_ms"],
            "bound_ms": slice_t["bound_ms"], "bound_by": slice_t["bound_by"],
            "bound_formula": BOUND_FORMULA, "share_of_bound": slice_t["bound_ms"] / slice_t["ms"],
            "library_ms": None,  # no single PyTorch call computes body + LayerNorm + max-pool
            "launches_by_run": {name: run[kname] for name, run in by_run.items()},
            **{f"{shape}_{key}": shp[shape][key]
               for shape in ("drq_f32", "drq_bf16", "rnn_target_f32", "act_f32", "act_bf16", "act_walker_bf16",
                             "dp_rank_f32", "dp_rank4_f32", "maniskill_f32", "maniskill_drq_f32", "maniskill_act_f32",
                             "walker_drq_bf16", "act2_f32", "act2_bf16", "maniskill_act2_f32")
               for key in ("ms", "plain_ms", "bound_ms")},
            "walker_f32_ms": shp["walker_f32"]["ms"],
            "walker_bf16_ms": shp["walker_bf16"]["ms"],
            "walker_bf16_plain_ms": shp["walker_bf16"]["plain_ms"],
            "walker_bf16_bound_ms": shp["walker_bf16"]["bound_ms"],
            "hgmma": hgmma[kname],
        })
    bwd_runs = {name: run[BWD_KERNEL] for name, run in by_run.items() if BWD_KERNEL in run}
    shp = bwd["shapes"]
    kernels.append({
        "name": BWD_KERNEL, "route": "cuda", "source": KERNEL_SOURCE, "replaces": BWD_REPLACES,
        "launches": sum(bwd_runs.values()) if bwd_runs else None, "max_gap": bwd["max_gap"],
        "ms": shp["slice_f32"]["ms"], "plain_ms": shp["slice_f32"]["plain_ms"],
        "bound_ms": shp["slice_f32"]["bound_ms"], "bound_by": shp["slice_f32"]["bound_by"],
        "bound_formula": BWD_BOUND_FORMULA, "share_of_bound": shp["slice_f32"]["bound_ms"] / shp["slice_f32"]["ms"],
        "library_ms": None,  # no single PyTorch call computes the winner rows' backward
        "launches_by_run": bwd_runs,
        **{f"{shape}_{key}": shp[shape][key] for shape in BWD_SHAPES[1:] for key in ("ms", "plain_ms", "bound_ms")},
        "hgmma": hgmma[BWD_KERNEL],
    })
    for kname, (launch_key, _) in CONV_KERNELS.items():
        conv_runs = {name: run[launch_key] for name, run in by_run.items() if launch_key in run}
        calls = {layer: conv[f"{kname.split('_')[1]}.{layer}"] for layer in CONV_LAYERS} if conv else {}
        kernels.append({
            "name": kname, "route": "cuda", "source": CONV_SOURCE, "replaces": CONV_REPLACES,
            "launches": sum(conv_runs.values()) if conv_runs else None,
            "max_gap": max(c["gap"] for c in calls.values()) if calls else None,
            # one call at each of the cell's three layers, 512 clouds
            **{key: sum(c[key] for c in calls.values()) if calls else None
               for key in ("ms", "bound_ms", "library_ms")},
            "bound_by": ",".join(sorted({c["bound_by"] for c in calls.values()})) if calls else None,
            "bound_formula": CONV_BOUND_FORMULA,
            "share_of_bound": sum(c["bound_ms"] for c in calls.values()) / sum(c["ms"] for c in calls.values())
            if calls else None,
            "launches_by_run": conv_runs,
            **{f"{layer}_{key}": c[key] for layer, c in calls.items() for key in ("ms", "bound_ms", "library_ms")},
            "hgmma": sum(v["mma"] for k, v in conv["sass"].items() if kname in k) if conv else None,
        })
    print(f"[time] total: {time.monotonic() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    if kernels_only or only is not None:
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
