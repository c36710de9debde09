#!/usr/bin/env python3
"""Drive the PyTorch port once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from deep_q_learning_tpu_torch/csrc with nvcc,
     one nvcc per source, all started together with g++ for the host
     replay buffer (deep_q_learning_tpu_torch/native); print each kernel's
     registers and shared memory from ptxas, and fail on a spill;
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it (the TD kernels at B = 256, 1024, 4096,
     300 and 37, both targets, the clip case, rows that are not 16-byte
     aligned; the backward writing q_both's (2B, A) gradient), check that
     the TD forward's loss is bitwise stable over 100 calls at B = 4096 and
     its ticket counter is 0 after a CUDA-graph replay; the PER slot kernel
     at (N, C, B) = (1024, 512, 1024), (128, 4096, 256), (4096, 128, 4096),
     (5, 37, 64) on rows that are not 16-byte aligned and (3, 20000, 64)
     (the chunk loop), on dyadic and random priorities, the edge cases (u =
     0, 1.0 and 1.5, an all-zero row, rows outside [0, N)) on every path,
     and its slots bitwise stable over 100 calls and a CUDA-graph replay;
     time kernel and plain version with CUDA events, and print each
     kernel's bound, its share of it, and its launches per superstep on
     each preset; then the member axis of a population: the TD kernels at
     (M, B, A) = (8, 256, 4), (10, 256, 4), (8, 1024, 4) and (3, 37, 4) on
     rows that are not 16-byte aligned, each member equal bitwise to its own
     unbatched call, and at M = 1 on every shape above; the forward bitwise
     stable over 100 calls at M = 8 and its ticket counter 0 after a graph
     replay; the PER slot kernel over every member's rows at (M·N, C, M·B) =
     (1024, 4096, 2048) in one launch, equal to 8 per-member calls; and
     their times beside their bounds; then S1, the jointed solver's step,
     against its plain version (``assembly_step_reference``) at N = 128,
     1024 and 37 with (120, 40) passes, N = 2 with (180, 60), the ragged
     N = 3, 33 and 129 (a group of lanes or a block part-full) and N = 1024
     and 33 on the ``vel_tol = 1e-3`` branch (its count of passes exact), on
     states of a flight of 128 landers near the ground, under the gates of
     tests/test_torch_lander_solver.py and bit for bit on every lane and
     flag; bitwise over 100 calls and a graph replay; its device time
     against the plain version's as a CUDA graph, beside its bound (the
     operations the states need: ``solver_kernels.needed_work``); the
     plain solver's kernel launches at 128 landers; then R1, the rigid
     lander's step: the card's sinf, sincosf and tanhf bitwise torch's over
     3.2M values, the kernel through ``step_env`` and ``reset_env`` against
     ``step_env_reference`` and ``reset_env_reference`` bit for bit on every
     lane at N = 1, 128, 1024 and 8192, wind off and on, on states of a
     300-frame flight of 1024 landers (``envs/heuristic.py::lander_step_inputs``:
     touchdowns, rests, hull hits, leg overloads, landers off the screen,
     truncations, all counted) and on the reset frame, one launch a call and
     no plain call; R1's vector step (``VectorEnv._step`` with a reset
     pool: the step, ``done``, the auto-reset's selects and the time
     feature in one launch) against its plain composition on the card
     (``measure.composed_rigid_lander``) bit for bit on every lane at the
     same N, wind off and on, the time feature off and on; both bitwise
     over 100 calls and a graph replay; their device times against the
     plain versions' as CUDA graphs, beside their bounds, and the vector
     step alone as a graph of one call, one kernel;
     then J1, the jointed lander's frame around S1: the kernel through
     ``step_env`` and ``reset_env`` against ``step_env_reference`` and
     ``reset_env_reference``, with the plain solver inside them and again
     with S1, bit for bit on every lane at N = 1, 37, 128 and 1024, wind off and on, on states of a 300-frame
     flight of 1024 jointed landers (flight, touchdowns, joint limits, hull
     hits, landers off the screen, asleep and at rest, truncations, all
     counted) and on the reset frame, one launch a call, no plain call and
     no S1 launch; bitwise over 100 calls and a graph replay, the step and
     the reset frame; its device time against the plain version's as CUDA
     graphs, beside its bound; then A1, C1 and M1, the classic envs'
     kernels: each through ``step_env`` and through ``VectorEnv._step``
     without a pool (the resets from their draws, the time feature off and
     on) against ``step_env_reference`` and the plain composition
     (``measure.composed_classic``) bit for bit on every lane at N = 1,
     128, 4096 and 8192, on states of a flight (``measure.
     classic_step_inputs``: terminations, truncations and steps that go
     on, counted), one launch a call and no plain call; bitwise over 100
     calls and a graph replay; the vector step's device time against the
     plain composition's as CUDA graphs, beside its bound, and the two
     alone as graphs of one call, in turns;
  4. run the ``lunar_per`` slice at full width through ``Trainer``
     (``algos/superstep.py::GraphedLearner``): 5 supersteps (640 vector
     steps of 128 envs), the first three frame by frame as CUDA graph
     launches (the frame's graph with the actor, the vector step and the
     replay write, the learner update's graph L), the fourth capturing the
     steady superstep as one graph (P2g: the draws, the cadence and the
     sync inside) and the fifth, under the profiler, one replay of it;
     check that the TD kernels ran on the device once per learner update
     and R1 once per vector step and reset pool there (counted in the
     trace: a graph's replay passes no wrapper's counter) and no plain
     version ran, the vector step's own graph one kernel (R1's), the
     host's launches per vector step (kernels, graphs, copies and fills; at most
     ``WHOLE_HOST_LAUNCHES``) and the device's busy share, the counters
     (the Adam count on the device equal to its mirror), the loss is finite, the online net trained, the target
     followed by Polyak averaging, peak memory under 1 GiB, and a greedy
     evaluation returns finite returns; the evaluator's check
     (``eval_pair``): the graphed evaluator (each eval step one CUDA
     graph) and its eager form in turns over 128 whole episodes, bitwise
     (returns, lengths, ``truncated``), each evaluation's seconds, the step
     graph's replay (phases 7, 8, 9 and 10 (a) run it too); F5's pair: ``epsilon_greedy`` with
     a float ε and with a device tensor equal over 2^20 draws at four ε,
     and the eager learner from the same seed bitwise the graphed one after
     the same 640 exploring frames; then the same trainer frame by frame
     (``max_graphs = 0``) from the same seed, bitwise after each
     superstep, and ``whole_vs_frames``: a steady superstep of each
     traced (host launches a vector step, busy share), env-steps/s in
     turns, the superstep graph's nodes, capture and instantiation
     seconds, peak memory; then the first training frames of
     a one-frame superstep frame by frame against the eager learner (the
     Adam count 1 after the first, the runners bitwise after every
     frame); then an
     eager-learner ``Trainer`` restored from the graphed one's checkpoint,
     one superstep each bitwise, and env-steps/s in three alternating
     pairs; each graph's replay on the device, its kernels and its capture
     time, the superstep's graph last; then one learner update on the
     card is held against the same update on the CPU;
  5. run ``lunar_per_scaled(1024)`` with ``use_pallas_sampler=True`` at
     full width through ``Trainer``'s graphed learner: 4 supersteps (512
     vector steps of 1024 envs), and check that the PER slot kernel and the
     TD kernels ran on the device once per learner update and R1 once per
     vector step and reset pool in the fourth, profiled, one replay of the
     superstep's graph, and no plain version ran;
  6. drive the same configuration through the command line: ``train`` one
     superstep with a checkpoint, ``train --resume`` one more, ``eval``;
  7. run ``lunar_jointed_per`` (the jointed 3-body lander, solver
     iterations (120, 40)) at full width through ``Trainer``, each frame
     as the graphed learner's CUDA graphs (the vector step inside the
     frame's) and the reset pool as one (``envs/graphed.py``): 2
     supersteps of 16 vector steps of 128 envs, learning from 1792 stored
     transitions; check the TD kernels ran once per learner update with no
     plain call and J1 once per vector step and per reset pool on the
     device in the second superstep (profiled), S1 never on its own (its
     body runs inside J1) and no plain version, the
     counters, a finite loss, the online net trained and
     the target followed, peak memory under 1 GiB; print each graph's
     eager warm-up and capture apart from the supersteps; then 8 graphed
     vector steps against 8 eager ones from clones of the runner's envs
     and generator, bitwise (pool, obs, states, transitions), the graphed
     frame's time against the eager frame's, the replay alone on the
     device (CUDA events), its kernels and its launch on the host, the
     kernels one graphed step runs on the card (the replay's and the
     draws') equal by name and count to the eager step's, every launch
     matched to its kernel in the profiler's trace, J1 once among them, S1
     not at all, and fewer in all than the plain solver alone launches, J1
     once in a replay of the reset pool; then an eager ``Trainer`` restored from the
     graphed one's checkpoint: one superstep each, runners bitwise equal,
     then env-steps/s in three alternating pairs (K1/K2 once per update,
     no plain call); a greedy evaluation cut at 4 frames, then the
     evaluator's check over whole episodes, J1 once in the eval step's
     graph; then one jointed
     frame of 64 landers from a short flight near the ground (touchdowns,
     contacts, crashes) on the card (J1) against the same frame on the CPU
     (the plain version); then P2g: the trainer from seed 0 and the same
     trainer frame by frame, bitwise after each of 4 supersteps (the
     third the steady superstep's capture), ``whole_vs_frames``, J1 once
     a frame and once for the pool in the traced replay, S1 not on its own;
  8. the uniform replay and classic control on the card:
     ``cartpole_vector``, ``acrobot_vector``, ``mountain_car_vector`` and
     ``lunar_dddqn_vector`` at full width through ``Trainer``, cut in depth
     only (``CLASSIC_RUNS``), each frame as CUDA graph launches
     (``GraphedLearner``: the classic envs inject their resets' draw, the
     uniform sample scales its uniforms by the device fill), superstep by
     superstep in turns with the eager learner and the graphed learner
     frame by frame (``max_graphs = 0``) from the same seed: metrics and
     runners bitwise equal after each, the last superstep the capture of
     the steady superstep's graph (P2g); the counters (env steps,
     updates equal to the trained frames times ``updates_per_step``, the
     replay's and Adam's device counters equal to their mirrors), a finite
     loss, completed episodes, the online net trained, no TD or sampler
     kernel (all four run the plain TD loss, ``use_pallas=False``), the
     resets as each env draws them (a classic env's every frame, the
     lander's pool once a superstep, the superstep graph's at its capture);
     in the traced replay of a steady superstep the env's kernel once a
     vector step (A1, C1 or M1; the lander's J1, and once for the pool) and
     no plain call of any env, a classic env's vector step alone one kernel
     in its CUDA graph; ``whole_vs_frames``
     (the host's launches per vector step of a steady superstep as one
     replay, at most ``WHOLE_SUPERSTEP_LAUNCHES`` a superstep, and frame by
     frame, at most ``CLASSIC_HOST_LAUNCHES``); env-steps/s graphed and
     eager, each
     graph's replay on the device; then one step of each classic env on
     the card (its kernel's step entry) against the same step on the CPU
     (the plain version), from the same states;
     the evaluator's check on ``cartpole_vector``;
  9. a population at full width: ``lunar_per`` with 8 members of 128 rigid
     landers, dueling (256, 256), PER (128, 4096) a member, batch 256 and
     ``use_pallas_sampler=True`` through ``PopulationTrainer``, cut in depth
     only (``POP_CUTS``), each frame as CUDA graph launches
     (``GraphedPopulation``): each kernel once per update round for all
     members and R1 once per vector step and reset pool of all members'
     landers in the profiler's trace of a steady superstep and no plain
     call, every member's counters exact (the Adam counts on the device)
     and its loss finite, a greedy evaluation of every member; aggregate
     env-steps/s, host launches per vector step, busy share and peak
     memory; the evaluator's check on every member's 16 envs; the eager
     population restored from its checkpoint, both with
     mixed gates and new learning rates (the graphs captured anew),
     bitwise after one superstep each, then in turns; each
     graph's replay ms, kernels and capture s; P2g: the population with
     the config's gates and each member's learning rate, graphed against
     itself frame by frame, bitwise after each of 4 supersteps (the third
     the capture), ``whole_vs_frames``, K1–K3 once an update round in the
     traced replay; one population learner
     update card vs CPU; then the command line's ``hpo --population 4``,
     and two of its trials in process, graphed and eager, with each
     trial's captures;
 10. runs over ranks and rollouts, every rank graphed (``GraphedLearner``
     under a process group: the frame's graph, graph L1 of the update's
     local gradients, the all-reduce, graph L2 of its step on the mean):
     first the kernels at a rank's shapes (K1/K2 at B = 128, K3 at (64,
     8192, 128)) against their plain versions and timed; (a) world size 1
     on NCCL: ``DistributedTrainer`` equal bitwise to graphed ``Trainer``
     after each superstep, ``lunar_per`` at full width with the PER slot
     kernel cut in depth only (``DIST_SETS``: 2 supersteps of 32 vector
     steps, learning from 2048 stored transitions), no plain call;
     the evaluator's check on ``DistributedTrainer``'s evaluator;
     env-steps/s of ``Trainer`` and of the rank graphed and eager, in
     turns; steady 8-step supersteps traced: K1–K3 once per update on the
     device, the host's launches per vector step (at most
     ``RANK_HOST_LAUNCHES``) and the busy share; then the same through
     ``train --distributed`` with checkpoints and ``--resume`` in processes
     of their own; (b) two gloo ranks sharing the card (CUDA tensors), 64
     landers and a batch of 128 each, the graphed and the eager rank from
     one seed in turns: learners bitwise equal after every superstep on
     both ranks, the combined counters as in (a), env-steps/s of each, a
     traced steady superstep of each rank; (c) ``multihost_ddqn`` at full
     width (8192 landers) for 2 supersteps of 16 vector steps; (d)
     ``dryrun_multichip(2)`` on the card; (e) ``eval --rollout-dir
     --rollouts 2 --render gif`` of phase 6's checkpoint (a figure it
     cannot draw is reported, not written);
 11. the host-compatibility path and the bf16 trunk: K1/K2 at the host
     agent's shapes (B = 64, A = 4 and 2) against their plain versions and
     timed; (a) ``HostAgent`` with ``lunar_ref_parity`` and ``use_pallas``
     over ``TimeFractionHostWrapper(TorchHostEnv(rigid lander))`` for
     ``COMPAT_STEPS`` env steps, its update one CUDA graph replay, then the
     eager agent from the same seed: every loss and episode and the learner
     bitwise, env-steps/s of each; no plain call, the buffer holding every
     env step, a finite loss, ε decayed per episode, the online net
     trained; one update card vs CPU from the agent's state; an episode of
     each traced (host launches per env step, K1/K2 once per update on the
     device) and a greedy ``evaluate(1)``; (b) ``make_host_env("torch")``: CartPole-v1 with the
     learner on the card (K1/K2 at A = 2) and a few frames of the jointed
     default LunarLander-v2; (c) the jointed ``TorchHostEnv`` with its step
     and reset as CUDA graphs, bitwise the eager one over 16 steps, with
     the env-steps/s of each; gymnasium's Box2D lander with the learner on
     the card where gymnasium and Box2D import, else one line saying so;
     (d) ``lunar_per`` at full width with ``compute_dtype=bfloat16`` on
     phase 10's cut through ``Trainer``, timed in turns with the float32
     run: K1–K3 launched once per update round and no plain call, float32
     parameters and bf16 trunk activations, K1/K2 on a bf16-fed batch vs
     plain, one update card vs CPU at the bf16 tolerance; (e) a 2-member
     bf16 population, graphed: K1–K3 once per update round in the
     profiler's trace of its last superstep;
 12. the gymnasium harness and its examples (the card has no gymnasium):
     (a) two Box2D episodes recorded on a host that has it
     (``envs/gym_traces.json``: burn seed 6, nop seed 2) replayed through
     ``gym_compat._stepwise_lanes`` as two lanes of one jointed lander at
     gym's (180, 60) iterations (a CUDA graph of the frame, replayed),
     held to the gates of
     tests/test_gym_parity.py, and the same replay on the CPU (terminal and
     contact steps equal, flight error within 1e-5); (b) a live
     ``compare_lunar_stepwise`` where gymnasium imports, else one line
     saying so; (c) ``examples.engine_curve_compare --engine torch --env
     CartPole-v1`` in a process of its own, traced (K1/K2 once per update on
     the device, no plain call, the JSONL's lines), then ``examples.summarize_engine_curves``
     over its directory; (d) the rigid ``impact_sweep_torch`` (LAND, LAND,
     CRASH, CRASH); (c) and the CPU replay run beside (a);
 13. the reference-format scripts: (a) ``artifacts/lunar_ref_format`` (the
     pickle pair the JAX package wrote) loaded through the port's
     ``load_params_pickle`` onto the card, its Q-values of 256 observations
     held to the CPU's (within 1e-5 of the largest |Q|, TF32 off), and
     ``ops.fused_td_loss`` at (256, 4) held to the CPU; and
     ``examples.evaluate_checkpoint --episodes 10`` of it in a process of
     its own (finite returns); (b) ``examples.train_lunar_lander --preset
     lunar_per --rollouts 1`` at full width for 4 supersteps (two past
     ``training_start``): K1/K2 launched once per update, no plain call,
     and the pair it wrote read back with Q-values bitwise the trained
     network's; (a)'s process runs beside (b); one more superstep of (b)'s
     trainer, profiled, K1/K2 on the device once per update and no launch
     lost;
 14. run ``lunar_jointed_scaled(1024)`` with ``use_pallas_sampler=True`` at
     full width through ``Trainer`` (1,024 jointed landers at (120, 40)),
     cut in depth only (``JOINTED_SCALED_CUTS``): 4 supersteps of 128
     vector steps from 2048 stored transitions, the second capturing the
     steady superstep's graph (its cadence from the first on); K1–K3 once
     per update and no plain call (TD, sampler, solver or lander) and J1
     once per vector step and reset pool on the device, S1 not on its own
     and no launch lost (the profiled fourth superstep, one replay), the
     counters, a finite loss, the online net
     trained, peak memory under 1 GiB; env-steps/s of the third superstep
     and the frame's, the update's and the superstep's graph replays on
     the device;
Where every traced attempt of phase 13's or 14's profiled superstep lost
kernel records, that phase runs again, whole, in a process of its own
(``phase_anew``). Then print the kernels' record as one JSON line (K1,
K2, K3, S1, R1, J1, A1, C1 and M1, with each kernel's bound, ``bound_ms``; S1's
entries on the jointed paths count its own launches there, none, and
name J1, which runs its body, under ``inside``), then the result line.

It imports nothing of JAX or of the JAX package, and exits non-zero
without printing a result where CUDA is absent.
"""

import collections
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)  # loss and td: the kernel sums in another order
DQ_TOL = dict(rtol=1e-5, atol=1e-7)
TD_SOURCE = "deep_q_learning_tpu_torch/csrc/td_loss.cu"
PER_SOURCE = "deep_q_learning_tpu_torch/csrc/per_sample.cu"
TD_SHAPES = [(256, 4), (1024, 4), (4096, 4), (300, 4), (37, 2)]
# B of lunar_per and lunar_jointed_per, lunar_per_scaled(1024), lunar_per_scaled(4096)
TD_TIMED = (256, 1024, 4096)
TD_STABLE_B, TD_STABLE_CALLS = 4096, 100
# phase 4: warm-up, its end, the steady superstep frame by frame, its
# graph's capture, then one replay (profiled)
SUPERSTEPS = 5
FIRST_TRAIN_FRAME = 3  # the frame from which the trap check's learner runs
# F5's pair: epsilon_greedy with a float ε and with a device tensor over
# 2^20 draws at the ε of artifacts/flagship_parting/division.py
F5_DRAWS, F5_EPSILONS = 1 << 20, (0.9, 0.459, 0.01, 1 / 3)
SCALED_SUPERSTEPS = 4  # the fourth, profiled, one replay of the superstep's graph
TRACE_ATTEMPTS = 3  # a profiled superstep whose trace lost kernel records is run again
TRACE_PAD_GROWTH = 4  # each time with the profiling session idle this much longer around it
# (N, C, B): lunar_per_scaled(1024), lunar_per, lunar_per_scaled(4096) (C = 2^19 / 4096),
# then C % 4 != 0 on misaligned rows (the scalar path) and C past 1024 * 16 (the chunk loop)
SLOT_SHAPES = [(1024, 512, 1024), (128, 4096, 256), (4096, 128, 4096), (5, 37, 64), (3, 20000, 64)]
SLOT_TIMED = SLOT_SHAPES[:3]
SLOT_MISALIGNED = (5, 37, 64)
# the kernel's plan at each shape: threads per draw, values a thread, float4 loads, chunks
SLOT_PLANS = {
    (1024, 512, 1024): (32, 16, True, 1),
    (128, 4096, 256): (256, 16, True, 1),
    (4096, 128, 4096): (32, 4, True, 1),
    (5, 37, 64): (32, 4, False, 1),
    (3, 20000, 64): (1024, 16, True, 2),
}
SLOT_EDGE_C = (200, 37, 300, 4096, 20000)  # the edge cases on every path: V = 8, 4 scalar, 12, block, chunks
SLOT_STABLE_CALLS = 100
SLOT_ULPS = 8  # random priorities: a slot may differ only within 8 ulps of a prefix
SLOT_SHARE_DRAWS = 1024  # ... and in under 1 % of at least this many draws, in calls of B
REPO = Path(__file__).resolve().parent
SCALED_SETS = ["use_pallas_sampler=true"]  # the CLI's overrides of lunar_per_scaled
# lunar_jointed_per cut in depth only: the width and the solver iterations
# are the preset's (never below ~60 velocity iterations: the joints give way)
# (learning from 1792 stored transitions, vector step 14: the update's graph
# makes its eager call there and is captured at 15, so the second superstep,
# profiled, replays both graphs only)
JOINTED_CUTS = dict(steps_per_superstep=16, training_start=1792)
JOINTED_SUPERSTEPS = 2
JOINTED_EVAL_FRAMES = 4  # Trainer.evaluate's default runs max_steps_in_episode = 1000 frames
JOINTED_FRAMES = 8  # graphed frames held bitwise against eager frames
JOINTED_WHOLE_SUPERSTEPS = 4  # P2g: the warm-up's end, the steady frame by frame, capture, replay
# phase 14: lunar_jointed_scaled(1024) with use_pallas_sampler, cut in depth
# only: 3 supersteps of the preset's 128 vector steps (the first captures the
# step graph, the second is timed, the third profiled), the learner from
# 2048 stored transitions (vector step 2 of 1024 landers; the preset's
# 20,000 open at vector step 20)
JOINTED_SCALED_CUTS = dict(training_start=2048, use_pallas_sampler=True)
JOINTED_SCALED_SUPERSTEPS = 4
# the member axis of the TD kernels: (M, B, A), and (M, B) on misaligned rows
TD_MEMBER_SHAPES = [(8, 256, 4), (10, 256, 4), (8, 1024, 4)]
TD_MEMBER_MISALIGNED = (3, 37, 4)
TD_MEMBER_TIMED = (8, 256, 4)  # lunar_per, 8 members
TD_MEMBER_STABLE = (8, 1024, 4)  # 4 blocks a member: the ticket over the grid
# the PER slot kernel over every member's rows: M, N, C, B of lunar_per, 8 members
SLOT_MEMBERS = (8, 128, 4096, 256)
# phase 9: lunar_per, 8 members, cut in depth only: 3 supersteps of 32 vector
# steps, the learner from 2048 stored transitions a member (vector step 16),
# each frame as CUDA graph launches (GraphedPopulation): the first superstep
# makes each graph's eager call and capture, the second is timed, the third
# profiled.  Then the eager population restored from its checkpoint and both
# given mixed gates and learning rates (POP_HYPER: train_every 1-3, member 7
# learning from 14,336 stored, vector step 112 of the next superstep; new
# learning-rate tensors make the graphs start over): bitwise after one
# superstep each, then env-steps/s in turns
POP_MEMBERS = 8
POP_CUTS = dict(steps_per_superstep=32, training_start=2048, use_pallas_sampler=True)
POP_SUPERSTEPS = 3
POP_WHOLE_SUPERSTEPS = 4  # P2g: the warm-up's end, the steady frame by frame, capture, replay
POP_EVAL_ENVS, POP_EVAL_FRAMES = 16, 64
POP_HYPER = dict(train_every=[1, 2, 3, 1, 2, 3, 1, 1], training_start=[2048] * 7 + [14_336],
                 learning_rate=[1e-4 * (k + 1) for k in range(8)])
# the search's trials in process: 2 trials of 4 members, graphed and eager
POP_TRIALS = [{"learning_rate": lr} for lr in (1e-4, 3e-4, 6e-4, 1e-3)]
# the CLI's search: 8 trials in rounds of 4, 2 supersteps (32,768 env steps) a trial
HPO_ARGS = ["--preset", "lunar_per", "--space", "lunar", "--population", "4", "--trials", "8",
            "--steps-per-trial", "32768", "--set", "max_steps_in_episode=200"]
FRAME_ENVS, FRAME_FLIGHT = 64, 30
# one jointed frame, card vs CPU.  XLA, the CPU and the card round float32
# differently in the last ulp, and the solver's iterations carry that far on
# hard impacts; the CPU tests measure how far against a float64 evaluation
# (tests/test_torch_lander_solver.py).  So: the CPU tests' tight tolerances on
# at least 90 % of the lanes, and every lane within 4x the largest float32
# error measured there.
FRAME_TOL = {  # kind: (tight atol, tight rtol, every-lane atol)
    "position": (1e-5, 0.0, 1.2e-4),
    "velocity": (1e-4, 0.0, 3e-2),
    "accumulator": (1e-5, 1e-4, 2e-2),
    "obs": (1e-5, 0.0, 2e-3),
    "reward": (1e-4, 0.0, 5e-2),
}
FRAME_TIGHT_SHARE = 0.9
# phase 8, each preset at its full width, cut in depth only:
#   cartpole_vector: 4096 envs, 3 supersteps of 64 vector steps; the learner
#     starts at vector step 3 (training_start 10,000);
#   acrobot_vector: 128 envs, 4 supersteps of 128 vector steps; a random
#     policy's episode lasts the 500-step limit, so 512 steps end one per env;
#   mountain_car_vector: 128 envs, 2 supersteps of 128 vector steps, with
#     training_start cut to 16,384 (of 50,000) so that the learner runs.
#   lunar_dddqn_vector: 128 rigid landers, 2 supersteps of 128 vector steps;
#     the learner starts at vector step 157 (training_start 20,000).
# Each graphed, in turns with its eager learner from the same seed.
CLASSIC_RUNS = {  # preset: (supersteps, config cuts); the last captures the steady superstep
    "cartpole_vector": (3, {}),
    "acrobot_vector": (4, {}),
    "mountain_car_vector": (3, {"training_start": 16_384}),
    "lunar_dddqn_vector": (4, {}),
}
CLASSIC_HOST_LAUNCHES = 40  # at most, a vector step of a steady superstep frame by frame
# one vector step card vs CPU, as the CPU tests hold the port to JAX
# (tests/test_torch_envs_classic.py): CartPole and MountainCar 1e-6; Acrobot's
# four RK4 stages of trigonometry carry the ulps of sin/cos further
CLASSIC_TOL = {"CartPole-v1": 1e-6, "MountainCar-v0": 1e-6, "Acrobot-v1": 1e-5}


# S1, the jointed solver's step, against its plain version on the card:
# (N, velocity passes, position passes, vel_tol).  The presets' (120, 40) at
# the main path's N = 128 and lunar_jointed_scaled's 1024, gym's (180, 60) at
# the width of phase 12's trace replay (2), ragged counts of envs (3, 33, 37,
# 129: a warp, a block of 16 envs part-full), and the early-exit branch with
# its count of passes
SOLVER_SOURCE = "deep_q_learning_tpu_torch/csrc/lander_solver.cu"
SOLVER_CASES = [(128, 120, 40, 0.0), (1024, 120, 40, 0.0), (37, 120, 40, 0.0),
                (2, 180, 60, 0.0), (3, 120, 40, 0.0), (33, 120, 40, 0.0), (129, 120, 40, 0.0),
                (1024, 120, 40, 1e-3), (33, 120, 40, 1e-3)]
SOLVER_STABLE_CALLS = 100
# the states: pre-step states of 128 jointed landers along a flight from
# just above the ground (envs/heuristic.py::solver_inputs)
SOLVER_ENVS, SOLVER_FRAMES = 128, 120
# the gates of tests/test_torch_lander_solver.py: the tight tolerances on at
# least 99 % of the lanes (positions and angles atol 1e-5, velocities 1e-4,
# accumulators atol 1e-5 + rtol 1e-4); every lane within 4x the field's
# float32 conditioning gap (the largest gap between JAX's float32 frame and
# its float64 evaluation over that file's 9,030 rollout lanes, as
# tests/test_torch_solver_kernel.py prints it, rounded up) plus the tight
# atol; contact, hull-hit and limit flags exact; the sleep flag flipped only
# within the velocity tolerance of a threshold, on at most 1 % of the lanes
SOLVER_TIGHT = {"position": (1e-5, 0.0), "velocity": (1e-4, 0.0), "accumulator": (1e-5, 1e-4)}
SOLVER_TIGHT_SHARE = 0.99
SOLVER_CONDITIONING = {
    (120, 40): {
        "hull.cx": 1.4e-5, "hull.cy": 6.6e-6, "hull.a": 1.5e-5, "hull.vx": 5.5e-5,
        "hull.vy": 1.8e-4, "hull.w": 7.3e-4, "leg1.cx": 1.5e-5, "leg1.cy": 9.1e-6,
        "leg1.a": 1.4e-5, "leg1.vx": 5.3e-4, "leg1.vy": 6.7e-4, "leg1.w": 5.2e-3,
        "leg2.cx": 2.5e-5, "leg2.cy": 1.1e-5, "leg2.a": 2.9e-5, "leg2.vx": 5.0e-4,
        "leg2.vy": 1.5e-3, "leg2.w": 7.5e-3, "j1": 8.8e-4, "j2": 8.7e-4, "c1": 2.1e-3,
        "c2": 4.1e-3,
    },
    (180, 60): {
        "hull.cx": 2.4e-5, "hull.cy": 8.2e-6, "hull.a": 1.2e-5, "hull.vx": 3.8e-5,
        "hull.vy": 2.0e-4, "hull.w": 5.9e-4, "leg1.cx": 2.7e-5, "leg1.cy": 9.0e-6,
        "leg1.a": 1.3e-5, "leg1.vx": 6.0e-4, "leg1.vy": 5.5e-4, "leg1.w": 3.4e-3,
        "leg2.cx": 2.0e-5, "leg2.cy": 1.3e-5, "leg2.a": 3.3e-5, "leg2.vx": 5.0e-4,
        "leg2.vy": 5.8e-4, "leg2.w": 1.4e-3, "j1": 7.7e-4, "j2": 9.8e-4, "c1": 4.0e-3,
        "c2": 4.0e-3,
    },
}
SOLVER_KERNEL = "assembly_step_kernel"  # S1's name in the profiler's trace
# R1, the rigid lander's step, against its plain version on the card, at N of
# the host env (1), lunar_per (128), lunar_per_scaled(1024) and the 8-member
# population (1024), and multihost_ddqn (8192), the wind off (every preset)
# and on: on pre-step states of a flight of RIGID_ENVS landers over
# RIGID_FRAMES frames (envs/heuristic.py::lander_step_inputs, its episodes cut at
# RIGID_MAX_STEPS frames so that some states truncate), bit for bit on every
# lane, and on the reset frame likewise; its vector step (the step, the
# auto-reset from a pool and the time feature in one launch) against its
# plain composition at the same N, wind off and on, the feature off and on
RIGID_SOURCE = "deep_q_learning_tpu_torch/csrc/lander_rigid.cu"
RIGID_KERNEL = "rigid_step_kernel"  # R1's name in the profiler's trace
RIGID_NS = (1, 128, 1024, 8192)
RIGID_ENVS, RIGID_FRAMES, RIGID_MAX_STEPS = 1024, 300, 200
RIGID_STABLE_CALLS = 100
# the card's sinf, sincosf and tanhf, which R1 calls, against torch.sin,
# torch.cos and torch.tanh: angles, the wind pattern's sine arguments at
# every index a flight reaches and tanh's arguments
RIGID_MATH_ANGLES, RIGID_MATH_INDEX, RIGID_MATH_TANH = 1 << 21, 12_000, 1 << 20
# J1, the jointed lander's frame around S1, against its plain version on the
# card (step_env_reference and reset_env_reference, with the plain solver
# inside and again with S1), at N of the
# host env (1), a ragged count (37: a warp and a block of 16 envs
# part-full), lunar_jointed_per (128) and lunar_jointed_scaled(1024), the
# wind off (every preset) and on: on pre-step states of a flight of
# J1_ENVS landers over J1_FRAMES frames (envs/heuristic.py::lander_step_inputs
# with the jointed engine, its episodes cut at J1_MAX_STEPS frames so that
# some states truncate), bit for bit on every lane, and on the reset frame
# likewise
JOINTED_SOURCE = "deep_q_learning_tpu_torch/csrc/lander_jointed.cu"
JOINTED_KERNEL = "jointed_step_kernel"  # J1's name in the profiler's trace
J1_NS = (1, 37, 128, 1024)
J1_ENVS, J1_FRAMES, J1_MAX_STEPS = 1024, 300, 200
J1_STABLE_CALLS = 100
# A1, C1 and M1, the classic envs' kernels, against their plain versions on
# the card (step_env_reference, and VectorEnv._step's plain composition
# without a pool, the time feature off and on), at N of the host env (1),
# acrobot_vector and mountain_car_vector (128), cartpole_vector (4096) and
# 8192: on pre-step states of a flight (measure.classic_step_inputs: half
# the envs on an energy-pumping policy, half random, episodes cut at
# measure.CLASSIC_MAX_STEPS frames; up to half the lanes end their episode),
# bit for bit on every lane
CLASSIC_SOURCE = "deep_q_learning_tpu_torch/csrc/classic_envs.cu"
CLASSIC_NS = (1, 128, 4096, 8192)
CLASSIC_STABLE_CALLS = 100
# each kernel's name in the profiler's trace, the JAX step it replaces, and
# the N of the preset that runs it
CLASSIC_KERNELS = {
    "acrobot": ("acrobot_kernel", "deep_q_learning_tpu/envs/acrobot.py:121", 128),
    "cartpole": ("cartpole_kernel", "deep_q_learning_tpu/envs/cartpole.py:92", 4096),
    "mountain_car": ("mountain_car_kernel", "deep_q_learning_tpu/envs/mountain_car.py:70", 128),
}
# the jointed step graph's replay with the plain solver in it, 128 landers at
# (120, 40) (NVIDIA H100 80GB HBM3): every kernel the eager step launched
PLAIN_STEP_REPLAY_KERNELS = 55_935


def fresh_peak(torch) -> None:
    """Start the peak-memory count afresh, after collecting what earlier
    phases left in reference cycles (a ``VectorEnv`` and its graphs), whose
    device memory stays allocated until the collector's next full pass."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def td_inputs(torch, b, a, seed, reward_shift=0.0):
    """The TD kernels' inputs as the learner gives them: ``q_s`` and
    ``q_next_online`` are the two halves of one (2B, A) ``q_both``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    q_both = randn(2 * b, a)
    return [
        q_both[:b], q_both[b:], randn(b, a),
        torch.randint(0, a, (b,), generator=g, device="cuda", dtype=torch.int32),
        randn(b) + reward_shift,
        0.97 * (torch.rand(b, generator=g, device="cuda") > 0.3).float(),
        torch.rand(b, generator=g, device="cuda") + 0.1,
    ]


TIMED_CALLS = 2000


def time_ms(torch, fn, iters=TIMED_CALLS, warmup=50) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def misaligned(torch, t):
    """A contiguous copy of ``t`` whose rows are not 16-byte aligned."""
    flat = torch.empty(t.numel() + 1, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def check_td_case(torch, td_kernels, args, a, double, err):
    """K1 and K2 against their plain versions on ``args``; K2 writes the
    (2B, A) gradient of q_both, zero past row B."""
    b = args[0].shape[0]
    loss, td = td_kernels.td_loss_fwd(*args, 1.0, double)
    ref_loss, ref_td = td_kernels.td_loss_reference(*args, 1.0, double)
    torch.testing.assert_close(loss, ref_loss, **LOSS_TOL)
    torch.testing.assert_close(td, ref_td, **LOSS_TOL)
    g = torch.rand((), device=args[0].device) + 0.5
    dq = td_kernels.td_loss_bwd(td, args[3], args[6], g, a, 1.0, out_rows=2 * b)
    ref_dq = td_kernels.td_loss_backward_reference(td, args[3], args[6], g, a, 1.0, out_rows=2 * b)
    torch.testing.assert_close(dq, ref_dq, **DQ_TOL)
    assert dq.shape == (2 * b, a) and not dq[b:].any()
    err["td_loss_fwd"] = max(
        err["td_loss_fwd"], float((loss - ref_loss).abs()), float((td - ref_td).abs().max())
    )
    err["td_loss_bwd"] = max(err["td_loss_bwd"], float((dq - ref_dq).abs().max()))
    return td


def check_td_determinism(torch, td_kernels):
    """K1 at B = 4096 (16 blocks and the last block's sum): 100 calls give a
    bitwise identical loss and td, and after a CUDA-graph replay the ticket
    counter is back at 0 and the result is the same again."""
    args = td_inputs(torch, TD_STABLE_B, 4, seed=5)
    loss0, td0 = td_kernels.td_loss_fwd(*args, 1.0, True)
    for _ in range(TD_STABLE_CALLS):
        loss, td = td_kernels.td_loss_fwd(*args, 1.0, True)
        assert torch.equal(loss, loss0) and torch.equal(td, td0), "K1 is not bitwise stable"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        td_kernels.td_loss_fwd(*args, 1.0, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [td_kernels.td_loss_fwd(*args, 1.0, True) for _ in range(10)]
    graph.replay()
    torch.cuda.synchronize()
    _, ticket = td_kernels.fwd_scratch(args[0].device)
    assert int(ticket) == 0, int(ticket)
    assert all(torch.equal(lo, loss0) and torch.equal(t, td0) for lo, t in outs)
    print(f"  K1 B={TD_STABLE_B}: {TD_STABLE_CALLS} calls and a graph replay bitwise equal, "
          f"ticket counter 0")


def check_td_kernels(torch, td_kernels, per_superstep, card):
    """Phase 3: kernel vs plain on the card; returns per-kernel records."""
    from deep_q_learning_tpu_torch.measure import bound_text

    err = {"td_loss_fwd": 0.0, "td_loss_bwd": 0.0}
    cases = [((b, a), double, 0.0) for (b, a) in TD_SHAPES for double in (True, False)]
    cases += [((256, 4), True, 100.0), ((4096, 4), True, 100.0)]
    for i, ((b, a), double, shift) in enumerate(cases):
        args = td_inputs(torch, b, a, seed=i, reward_shift=shift)
        assert td_kernels.float4_rows(a, *args[:3]) == (a == 4)
        td = check_td_case(torch, td_kernels, args, a, double, err)
        if shift:
            assert float(td.abs().min()) > 1.0, "the clip case must be past delta"
        print(f"  kernel vs plain B={b} A={a} double={double} shift={shift}: ok")
    for b in (256, 4096):
        args = td_inputs(torch, b, 4, seed=b)
        args[:3] = [misaligned(torch, t) for t in args[:3]]
        assert not td_kernels.float4_rows(4, *args[:3])
        check_td_case(torch, td_kernels, args, 4, True, err)
        print(f"  kernel vs plain B={b} A=4, rows not 16-byte aligned (scalar path): ok")
    check_td_determinism(torch, td_kernels)
    torch.cuda.synchronize()

    times = {}
    for b in TD_TIMED:
        args = td_inputs(torch, b, 4, seed=99)
        loss, td = td_kernels.td_loss_fwd(*args, 1.0, True)
        g = torch.ones((), device="cuda")
        rows = 2 * b
        times[b] = {
            "td_loss_fwd": (
                time_ms(torch, lambda: td_kernels.td_loss_fwd(*args, 1.0, True)),
                time_ms(torch, lambda: td_kernels.td_loss_reference(*args, 1.0, True)),
                td_kernels.td_loss_fwd_work(b, 4),
            ),
            "td_loss_bwd": (
                time_ms(torch, lambda: td_kernels.td_loss_bwd(
                    td, args[3], args[6], g, 4, 1.0, out_rows=rows)),
                time_ms(torch, lambda: td_kernels.td_loss_backward_reference(
                    td, args[3], args[6], g, 4, 1.0, out_rows=rows)),
                td_kernels.td_loss_bwd_work(b, 4, rows),
            ),
        }
        for name, (k_ms, p_ms, work) in times[b].items():
            print(f"  {name} B={b} A=4: kernel {k_ms * 1e3:.2f} us/call, "
                  f"plain {p_ms * 1e3:.2f} us/call (CUDA events, {TIMED_CALLS} calls); "
                  f"{bound_text(work, k_ms * 1e3)}; launches per superstep "
                  f"{per_superstep[name]} [{card}]")
    return err, times


def solver_fields(out):
    """(name, kind, values) of every compared field of an assembly_step result."""
    for name, body in zip(("hull", "leg1", "leg2"), out[:3]):
        for f in ("cx", "cy", "a", "vx", "vy", "w"):
            yield f"{name}.{f}", "velocity" if f in ("vx", "vy", "w") else "position", getattr(body, f)
    for f in ("j1", "j2", "c1", "c2"):
        yield f, "accumulator", getattr(out[7], f)


def check_solver_case(torch, got, want, iters):
    """S1's result against the plain version's under the gates above;
    returns (largest gap, lanes past the tight tolerances, lanes bitwise
    equal in every bit of every field and flag)."""
    from deep_q_learning_tpu_torch.envs import lander_solver as ls

    n = want[3].shape[0]
    tight_bad = torch.zeros(n, dtype=torch.bool, device=want[3].device)
    same = torch.ones_like(tight_bad)
    largest = 0.0
    for (name, kind, g), (_, _, w) in zip(solver_fields(got), solver_fields(want)):
        atol, rtol = SOLVER_TIGHT[kind]
        gap = (g.double() - w.double()).abs().reshape(n, -1)
        tight_bad |= (gap > atol + rtol * w.double().abs().reshape(n, -1)).any(1)
        same &= (g.view(torch.int32) == w.view(torch.int32)).reshape(n, -1).all(1)
        bound = 4.0 * SOLVER_CONDITIONING[iters][name] + atol
        assert float(gap.max()) <= bound, (name, iters, float(gap.max()), bound)
        largest = max(largest, float(gap.max()))
    assert float(tight_bad.float().mean()) <= 1 - SOLVER_TIGHT_SHARE, (iters, int(tight_bad.sum()))
    for i, name in ((3, "touch1"), (4, "touch2"), (5, "hull_hit")):
        assert torch.equal(got[i], want[i]), name
    for f in ("s1", "s2"):
        same &= getattr(got[7], f) == getattr(want[7], f)
    for f in ("s1", "s2"):
        assert torch.equal(getattr(got[7], f), getattr(want[7], f)), f
    near = torch.zeros_like(tight_bad)
    for b in want[:3]:
        near |= ((torch.hypot(b.vx, b.vy) - ls.LIN_SLEEP_TOL).abs() < 1e-4) | (
            (b.w.abs() - ls.ANG_SLEEP_TOL).abs() < 1e-4)
    flipped = got[6] != want[6]
    assert not bool((flipped & ~near).any()) and float(flipped.float().mean()) <= 0.01
    same &= ~flipped
    return largest, int(tight_bad.sum()), int(same.sum())


def solver_args(torch, n, vel, pos, seed):
    """assembly_step inputs of ``n`` lanes on the card (its positional
    arguments, then ``acc``) from a flight of SOLVER_ENVS landers at (vel,
    pos) passes."""
    from deep_q_learning_tpu_torch.envs import LunarLander
    from deep_q_learning_tpu_torch.envs.heuristic import solver_inputs
    from deep_q_learning_tpu_torch.envs.lunar_lander import LunarLanderParams

    env, params = LunarLander(), LunarLanderParams(vel_iters=vel, pos_iters=pos)
    g = torch.Generator(device="cuda").manual_seed(seed)
    return solver_inputs(env, params, n, g, envs=SOLVER_ENVS, frames=SOLVER_FRAMES)


def check_solver_kernel(torch, solver_kernels, card):
    """Phase 3, S1: the branch-free sin/cos and reciprocal of S1's and J1's
    passes bitwise the card's sincosf and division on every float of their
    ranges (``solver_kernels.fast_math_mismatches``); the kernel against
    assembly_step_reference on the card
    at SOLVER_CASES under the gates of tests/test_torch_lander_solver.py,
    the share of lanes bitwise equal; the coverage of the states; bitwise
    stable over 100 calls and a graph replay; its device time beside the
    graphed plain version's and its bound; the plain version's kernel
    count at 128 landers (phase 7 holds a step's replay to it).  Returns
    (largest gap by N at (120, 40), times by measure.py's SOLVER_SHAPES, that
    count)."""
    from deep_q_learning_tpu_torch.envs import lander_solver as ls
    from deep_q_learning_tpu_torch.measure import SOLVER_SHAPES, solver_device_times, traced_kernels

    kernel = solver_kernels.assembly_step_kernel
    t0 = time.perf_counter()
    differ = solver_kernels.fast_math_mismatches()
    assert not any(differ.values()), ("the passes' math differs from the card's", differ)
    print(f"  S1 and J1's branch-free sin/cos and reciprocal against the card's sincosf and "
          f"1.0f / b on every float of their ranges ({solver_kernels.FAST_MATH_VALUES} values, "
          f"{time.perf_counter() - t0:.2f} s): {differ} differ in any bit [{card}]")
    inputs, err = {}, {}
    for n, vel, pos, tol in SOLVER_CASES:
        if (n, vel, pos) not in inputs:
            inputs[n, vel, pos] = solver_args(torch, n, vel, pos, seed=n + vel)
        *body, acc = inputs[n, vel, pos]
        kw = dict(acc=acc, vel_iters=vel, pos_iters=pos, vel_tol=tol, return_iters=tol > 0)
        solver_kernels.reset_counts()
        got = kernel(*body, **kw)
        assert solver_kernels.launches == {"assembly_step": 1}, solver_kernels.launches
        want = ls.assembly_step_reference(*body, **kw)
        torch.cuda.synchronize()
        largest, tight, same = check_solver_case(torch, got[:8], want[:8], (vel, pos))
        assert same == n, ("S1 differs from the plain version", n, vel, pos, tol, n - same)
        extra = ""
        if tol > 0:
            assert torch.equal(got[8], want[8]), "velocity passes"
            extra = (f", velocity passes {int(got[8].min())}-{int(got[8].max())} (mean "
                     f"{float(got[8].float().mean()):.1f}) equal to the plain version's")
        if (vel, pos, tol) == (120, 40, 0.0):
            err[n] = largest
        print(f"  S1 vs plain N={n} ({vel}, {pos}) vel_tol={tol}: largest gap {largest:.3g}, "
              f"{tight} lanes past the tight tolerances, {same} of {n} lanes bitwise equal "
              f"({100 * same / n:.1f} %){extra}")
    # what the 1024 states cover (the gates' premise), from the start-of-step pose
    hull, leg1, leg2, terrain, *_, acc = inputs[1024, 120, 40]
    c1, t1 = ls.collide_leg(terrain, leg1)
    _, t2 = ls.collide_leg(terrain, leg2)
    hit = ls.hull_touches(terrain, hull)
    both = c1.active1 & c1.active2
    cover = {"free flight": ~t1 & ~t2 & ~hit, "one leg down": t1 ^ t2, "two legs down": t1 & t2,
             "2-point block": both & c1.block, "sequential": c1.active1 & ~(both & c1.block),
             "joint limit": (acc.s1 != 0) | (acc.s2 != 0), "hull hit": hit}
    cover = {k: int(v.sum()) for k, v in cover.items()}
    assert all(v > 0 for v in cover.values()), cover
    print(f"  S1 states (N=1024 of a {SOLVER_FRAMES}-frame flight of {SOLVER_ENVS} landers): {cover}")

    *body, acc = inputs[1024, 120, 40]
    call = lambda: kernel(*body, acc=acc, vel_iters=120, pos_iters=40)  # noqa: E731
    first = call()
    for _ in range(SOLVER_STABLE_CALLS - 1):
        again = call()
        same_tree(torch, result_leaves(first), result_leaves(again), "S1 call")
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    same_tree(torch, result_leaves(first), result_leaves(captured), "S1 graph replay")
    print(f"  S1 N=1024 (120, 40): {SOLVER_STABLE_CALLS} calls and a CUDA-graph replay bitwise equal")

    times = {shape: (s1_us / 1e3, p_us / 1e3, work) for shape, (s1_us, p_us, work)
             in solver_device_times(card, {shape: inputs[shape] for shape in SOLVER_SHAPES}).items()}
    *body, acc = inputs[SOLVER_CASES[0][:3]]
    plain = traced_kernels(lambda: ls.assembly_step_reference(
        *body, acc=acc, vel_iters=120, pos_iters=40))
    print(f"  the plain solver alone at N=128 (120, 40): {plain.launches} kernel launches, "
          f"{plain.lost} of them with no kernel in the profiler's trace [{card}]")
    return err, times, plain.launches


def rigid_lanes(torch, got, want):
    """Per lane, whether every bit of every output of two rigid steps (or
    reset frames) is equal; and the largest gap of their float outputs."""
    from deep_q_learning_tpu_torch.envs.graphed import tree_leaves

    a, b = tree_leaves(list(got)), tree_leaves(list(want))
    assert len(a) == len(b), (len(a), len(b))
    n = a[0].shape[0]
    same = torch.ones(n, dtype=torch.bool, device=a[0].device)
    gap = 0.0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, (x.dtype, y.dtype, x.shape, y.shape)
        if x.is_floating_point():
            gap = max(gap, float((x.double() - y.double()).abs().max()))
            x, y = x.view(torch.int32), y.view(torch.int32)
        same &= (x == y).reshape(n, -1).all(1)
    return same, gap


def stable_lanes(torch, call, calls: int, label: str) -> None:
    """``call()`` (a lander step or reset frame) bitwise the same over
    ``calls`` calls and a CUDA-graph replay of it, on every lane."""
    first = call()
    for _ in range(calls - 1):
        assert bool(rigid_lanes(torch, first, call())[0].all()), (label, "call")
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    assert bool(rigid_lanes(torch, first, captured)[0].all()), (label, "graph replay")


def check_rigid_math(torch, lander_kernels, card) -> None:
    """The card's sinf, sincosf and tanhf (what R1 calls) bitwise
    torch.sin, torch.cos and torch.tanh on the card; cosf alone reported."""
    g = torch.Generator(device="cuda").manual_seed(11)
    idx = torch.arange(-RIGID_MATH_INDEX, RIGID_MATH_INDEX, device="cuda").to(torch.float32)
    x = torch.cat([(torch.rand(RIGID_MATH_ANGLES, generator=g, device="cuda") - 0.5) * 8.0,
                   idx * 0.02, idx * (math.pi * 0.01),
                   (torch.rand(RIGID_MATH_TANH, generator=g, device="cuda") - 0.5) * 6.0])
    out = lander_kernels.device_math(x)
    differ = {name: int((out[i].view(torch.int32) != ref.view(torch.int32)).sum())
              for i, (name, ref) in enumerate((("sinf", torch.sin(x)), ("cosf", torch.cos(x)),
                                               ("sincosf sine", torch.sin(x)),
                                               ("sincosf cosine", torch.cos(x)),
                                               ("tanhf", torch.tanh(x))))}
    used = {k: v for k, v in differ.items() if k != "cosf"}
    assert not any(used.values()), differ
    print(f"  R1's math on the card against torch's over {x.shape[0]} values: values that differ "
          f"in any bit {differ} [{card}]")


def check_rigid_kernel(torch, lander_kernels, card):
    """Phase 3, R1: the card's math functions (:func:`check_rigid_math`);
    the kernel through ``LunarLander.step_env`` and ``reset_env`` against
    ``step_env_reference`` and ``reset_env_reference`` on the card, and its
    vector step against the plain composition (:func:`rigid_vector_pair`,
    the time feature off and on), bit for bit on every lane at RIGID_NS
    with the wind off and on, one launch a call and no plain call; what the
    states cover; bitwise over 100 calls and a graph replay; the device
    times beside the plain versions' as CUDA graphs and the bounds
    (``measure.rigid_device_times``, ``rigid_vector_times``).  Returns
    (largest gap, ``{(n, kind): (kernel ms, plain ms, work)}``, kind
    ``"step"``, ``"reset"`` or ``"vector"``)."""
    from deep_q_learning_tpu_torch.envs import LunarLander
    from deep_q_learning_tpu_torch.envs.graphed import tree_map
    from deep_q_learning_tpu_torch.envs.heuristic import lander_step_inputs, rigid_cover
    from deep_q_learning_tpu_torch.envs.lunar_lander import sample_reset_draws
    from deep_q_learning_tpu_torch.measure import (
        rigid_device_times,
        rigid_params,
        rigid_vector_times,
    )

    check_rigid_math(torch, lander_kernels, card)
    env, largest, timing_inputs = LunarLander(), 0.0, {}
    for wind in (False, True):
        params = rigid_params(wind, RIGID_MAX_STEPS)
        g = torch.Generator(device="cuda").manual_seed(20 + wind)
        t0 = time.perf_counter()
        inputs = lander_step_inputs(env, params, max(RIGID_NS), g, envs=RIGID_ENVS,
                                    frames=RIGID_FRAMES)
        cover = {k: int(v.sum()) for k, v in rigid_cover(env, params, *inputs).items()}
        assert all(v > 0 for v in cover.values()), (wind, cover)
        print(f"  R1 states (wind {'on' if wind else 'off'}; N={max(RIGID_NS)} of a "
              f"{RIGID_FRAMES}-frame flight of {RIGID_ENVS} landers, made in "
              f"{time.perf_counter() - t0:.1f} s): {cover}")
        for n in RIGID_NS:
            state, action, draws = tree_map(lambda t: t[:n].contiguous(), inputs)
            rd = sample_reset_draws(g, n)
            lander_kernels.reset_counts()
            got = env.step_env(None, state, action, params, draws)
            got_reset = env.reset_env(None, n, params, rd)
            assert lander_kernels.launches == {"rigid_step": 2}, lander_kernels.launches
            assert lander_kernels.plain_calls == {"rigid_step": 0}, lander_kernels.plain_calls
            want = env.step_env_reference(None, state, action, params, draws)
            want_reset = env.reset_env_reference(None, n, params, rd)
            for kind, (g_, w_) in (("step", (got, want)), ("reset", (got_reset, want_reset))):
                same, gap = rigid_lanes(torch, g_, w_)
                assert bool(same.all()), ("R1 differs from the plain version", kind, n, wind,
                                          int((~same).sum()), gap)
                largest = max(largest, gap)
            resets = []
            for feature in (False, True):
                got, want, done = rigid_vector_pair(torch, lander_kernels, params, state, action,
                                                    draws, sample_reset_draws(g, n), feature)
                same, gap = rigid_lanes(torch, got, want)
                assert bool(same.all()), ("R1's vector step differs from the plain composition",
                                          n, wind, feature, int((~same).sum()), gap)
                assert got[0].shape == (n, 8 + feature), got[0].shape
                assert n < max(RIGID_NS) or (bool(done.any()) and not bool(done.all())), (
                    n, wind, feature)
                largest = max(largest, gap)
                resets.append(int(done.sum()))
            print(f"  R1 vs plain N={n} wind {'on' if wind else 'off'}: the step, the reset "
                  f"frame and the vector step (time feature off, on; {resets} lanes reset) "
                  f"bitwise equal on all {n} lanes")
            if not wind:
                timing_inputs[n] = (state, action, draws)

    params = rigid_params()
    state, action, draws = timing_inputs[1024]
    stable_lanes(torch, lambda: env.step_env(None, state, action, params, draws),
                 RIGID_STABLE_CALLS, "R1")
    pool_draws = sample_reset_draws(torch.Generator(device="cuda").manual_seed(9), 1024)
    stable_lanes(torch, lambda: rigid_vector_pair(torch, lander_kernels, params, state, action,
                                                  draws, pool_draws, True, plain=False)[0],
                 RIGID_STABLE_CALLS, "R1's vector step")
    print(f"  R1 N=1024: {RIGID_STABLE_CALLS} calls and a CUDA-graph replay bitwise equal, the "
          f"step and the vector step")
    times = {key: (k_us / 1e3, p_us / 1e3, work) for key, (k_us, p_us, work)
             in rigid_device_times(card, timing_inputs).items()}
    times.update({(n, "vector"): (k_us / 1e3, p_us / 1e3, work) for n, (k_us, p_us, work)
                  in rigid_vector_times(card, timing_inputs).items()})
    return largest, times


def rigid_vector_pair(torch, lander_kernels, params, state, action, draws, pool_draws,
                      feature: bool, plain: bool = True):
    """R1's vector step on the card: ``VectorEnv._step`` of the rigid lander
    (in ``TimeFractionObs`` with ``feature``) with a reset pool from
    ``pool_draws`` (R1's reset frame), one launch; and, with ``plain``, its
    plain composition on the same inputs (``measure.composed_rigid_lander``:
    ``step_env_reference``, ``done``, ``tree_where`` and ``_augment``).
    Returns (the kernel's outputs, the plain version's or None, done)."""
    from deep_q_learning_tpu_torch.envs import LunarLander, TimeFractionObs, VectorEnv
    from deep_q_learning_tpu_torch.measure import composed_rigid_lander

    n = state.x.shape[0]
    env = TimeFractionObs(LunarLander()) if feature else LunarLander()
    pool = env.reset_env(None, n, params, pool_draws)
    prev = torch.zeros_like(pool[0])

    def flat(out):
        out_obs, out_state, tr = out
        assert tr.obs is prev and tr.action is action
        return out_obs, out_state, tr.next_obs, tr.reward, tr.terminated, tr.truncated

    lander_kernels.reset_counts()
    got = flat(VectorEnv(env, n, graphed=False)._step(None, state, action, params, prev, pool,
                                                      draws))
    assert lander_kernels.launches == {"rigid_step": 1}, lander_kernels.launches
    assert lander_kernels.plain_calls == {"rigid_step": 0}, lander_kernels.plain_calls
    want = None
    if plain:
        venv = VectorEnv(composed_rigid_lander(time_feature=feature), n, graphed=False)
        want = flat(venv._step(None, state, action, params, prev, pool, draws))
        assert lander_kernels.launches == {"rigid_step": 1}, lander_kernels.launches
    return got, want, got[4] | got[5]


def classic_vector_pair(torch, classic_kernels, env, params, state, action, draws,
                        feature: bool, plain: bool = True):
    """A classic env's vector step on the card: ``VectorEnv._step`` (in
    ``TimeFractionObs`` with ``feature``) without a pool, the resets from
    ``draws``, one launch of its kernel; and, with ``plain``, its plain
    composition on the same inputs (``measure.composed_classic``:
    ``step_env_reference``, ``done``, ``reset_env``, ``tree_where`` and
    ``_augment``).  Returns (the kernel's outputs, the plain version's or
    None, done)."""
    from deep_q_learning_tpu_torch.envs import TimeFractionObs, VectorEnv
    from deep_q_learning_tpu_torch.measure import composed_classic

    n = action.shape[0]
    port_env = TimeFractionObs(env) if feature else env
    prev = torch.zeros((n, env.obs_shape(params)[0] + feature), device="cuda")
    one = {key: int(key == env.kernel) for key in classic_kernels.launches}

    def flat(out):
        out_obs, out_state, tr = out
        assert tr.obs is prev and tr.action is action
        return out_obs, out_state, tr.next_obs, tr.reward, tr.terminated, tr.truncated

    classic_kernels.reset_counts()
    got = flat(VectorEnv(port_env, n, graphed=False)._step(None, state, action, params, prev,
                                                           None, None, draws))
    assert classic_kernels.launches == one, classic_kernels.launches
    assert not any(classic_kernels.plain_calls.values()), classic_kernels.plain_calls
    want = None
    if plain:
        venv = VectorEnv(composed_classic(env, feature), n, graphed=False)
        want = flat(venv._step(None, state, action, params, prev, None, None, draws))
        assert classic_kernels.launches == one, classic_kernels.launches
    return got, want, got[4] | got[5]


def check_classic_kernel(torch, classic_kernels, card):
    """Phase 3, A1, C1 and M1: each classic env's kernel through
    ``step_env`` and through ``VectorEnv._step`` without a pool (the resets
    from their draws; the time feature off and on) against
    ``step_env_reference`` and the plain composition
    (:func:`classic_vector_pair`), bit for bit on every lane at
    CLASSIC_NS, one launch a call and no plain call, on states of a flight
    (``measure.classic_step_inputs``), what they cover counted; bitwise
    over 100 calls and a graph replay at N = 4096, the step and the vector
    step; the device times of the vector step against the plain
    composition's as CUDA graphs, beside the bounds
    (``measure.classic_device_times``).  Returns ``{env: (kernel ms, plain
    ms, work)}`` at the N of the preset that runs each."""
    from deep_q_learning_tpu_torch.envs import make_env
    from deep_q_learning_tpu_torch.envs.graphed import tree_map
    from deep_q_learning_tpu_torch.measure import (
        classic_device_times,
        classic_params,
        classic_step_inputs,
    )

    timing_inputs = {}
    for key, spec in classic_kernels.SPECS.items():
        env, _ = make_env(spec.env_id)
        params = classic_params(env)
        g = torch.Generator(device="cuda").manual_seed(30 + spec.index)
        t0 = time.perf_counter()
        states, actions, ends = classic_step_inputs(env, params, max(CLASSIC_NS), g)
        cover = {"terminated": int(ends[:, 0].sum()), "truncated": int(ends[:, 1].sum()),
                 "going on": int((~ends.any(1)).sum())}
        assert all(cover.values()), (key, cover)
        print(f"  {key} states (N={max(CLASSIC_NS)} of a flight, made in "
              f"{time.perf_counter() - t0:.1f} s): {cover}")
        one = {k: int(k == key) for k in classic_kernels.launches}
        for n in CLASSIC_NS:
            state, action = tree_map(lambda t: t[:n].contiguous(), (states, actions))
            draws = env.reset_draws(g, n)
            classic_kernels.reset_counts()
            got = env.step_env(None, state, action, params)
            assert classic_kernels.launches == one, classic_kernels.launches
            assert not any(classic_kernels.plain_calls.values()), classic_kernels.plain_calls
            same, gap = rigid_lanes(torch, got, env.step_env_reference(None, state, action,
                                                                       params))
            assert bool(same.all()), (f"{key}'s kernel differs from the plain step", n,
                                      int((~same).sum()), gap)
            resets = []
            for feature in (False, True):
                got, want, done = classic_vector_pair(torch, classic_kernels, env, params, state,
                                                      action, draws, feature)
                same, gap = rigid_lanes(torch, got, want)
                assert bool(same.all()), (f"{key}'s vector step differs from the plain "
                                          "composition", n, feature, int((~same).sum()), gap)
                assert n < 128 or (bool(done.any()) and not bool(done.all())), (key, n, feature)
                resets.append(int(done.sum()))
            print(f"  {key} vs plain N={n}: the step and the vector step (time feature off, on; "
                  f"{resets} lanes reset) bitwise equal on all {n} lanes")
            timing_inputs[key, n] = (state, action)
        state, action = timing_inputs[key, 4096]
        draws = env.reset_draws(g, 4096)
        stable_lanes(torch, lambda: env.step_env(None, state, action, params),
                     CLASSIC_STABLE_CALLS, f"{key}'s step")
        stable_lanes(torch, lambda: classic_vector_pair(torch, classic_kernels, env, params, state,
                                                        action, draws, True, plain=False)[0],
                     CLASSIC_STABLE_CALLS, f"{key}'s vector step")
        print(f"  {key} N=4096: {CLASSIC_STABLE_CALLS} calls and a CUDA-graph replay bitwise "
              f"equal, the step and the vector step")
    times = classic_device_times(card, timing_inputs)
    return {key: (times[key, n][0] / 1e3, times[key, n][1] / 1e3, times[key, n][2])
            for key, (_, _, n) in CLASSIC_KERNELS.items()}


def check_jointed_kernel(torch, jointed_kernels, solver_kernels, card):
    """Phase 3, J1: the kernel through ``LunarLander.step_env`` and
    ``reset_env`` against ``step_env_reference`` and ``reset_env_reference``
    on the card, with the plain solver (``assembly_step_reference``, no S1
    launch) inside them and again with S1 inside, bit for bit on every lane
    at J1_NS with the wind off and on, one launch a call and no plain call,
    S1 not launched; what the states cover; bitwise over 100 calls and a graph
    replay, the step and the reset frame; its device time beside the plain
    version's as CUDA graphs and its bound (``measure.jointed_device_times``).
    Returns (largest gap, ``{(n, kind): (kernel ms, plain ms, work)}``)."""
    from deep_q_learning_tpu_torch.envs import LunarLander
    from deep_q_learning_tpu_torch.envs.graphed import tree_map
    from deep_q_learning_tpu_torch.envs.heuristic import jointed_cover, lander_step_inputs
    from deep_q_learning_tpu_torch.envs.lander_solver import assembly_step_reference
    from deep_q_learning_tpu_torch.envs.lunar_lander import sample_reset_draws
    from deep_q_learning_tpu_torch.measure import (
        JOINTED_SHAPES,
        jointed_device_times,
        jointed_params,
    )

    env, largest, timing_inputs = LunarLander(), 0.0, {}
    for wind in (False, True):
        params = jointed_params(wind, J1_MAX_STEPS)
        g = torch.Generator(device="cuda").manual_seed(40 + wind)
        t0 = time.perf_counter()
        inputs = lander_step_inputs(env, params, max(J1_NS), g, envs=J1_ENVS, frames=J1_FRAMES)
        cover = {k: int(v.sum()) for k, v in jointed_cover(env, params, *inputs).items()}
        assert all(v > 0 for v in cover.values()), (wind, cover)
        print(f"  J1 states (wind {'on' if wind else 'off'}; N={max(J1_NS)} of a "
              f"{J1_FRAMES}-frame flight of {J1_ENVS} landers, made in "
              f"{time.perf_counter() - t0:.1f} s): {cover}")
        for n in J1_NS:
            state, action, draws = tree_map(lambda t: t[:n].contiguous(), inputs)
            rd = sample_reset_draws(g, n)
            jointed_kernels.reset_counts()
            solver_kernels.reset_counts()
            got = env.step_env(None, state, action, params, draws)
            got_reset = env.reset_env(None, n, params, rd)
            assert jointed_kernels.launches == {"jointed_step": 2}, jointed_kernels.launches
            assert jointed_kernels.plain_calls == {"jointed_step": 0}, jointed_kernels.plain_calls
            assert solver_kernels.launches == {"assembly_step": 0}, solver_kernels.launches
            wants = {}
            for inside, solve, s1 in (("plain solver", assembly_step_reference, 0),
                                      ("S1", None, 2)):
                wants[inside] = (
                    env.step_env_reference(None, state, action, params, draws, solve=solve),
                    env.reset_env_reference(None, n, params, rd, solve=solve))
                assert solver_kernels.launches == {"assembly_step": s1}, (
                    inside, solver_kernels.launches)
            for inside, (want, want_reset) in wants.items():
                for kind, g_, w_ in (("step", got, want), ("reset", got_reset, want_reset)):
                    same, gap = rigid_lanes(torch, g_, w_)
                    assert bool(same.all()), ("J1 differs from the plain version", inside, kind,
                                              n, wind, int((~same).sum()), gap)
                    largest = max(largest, gap)
            print(f"  J1 vs plain N={n} wind {'on' if wind else 'off'}: the step and the reset "
                  f"frame bitwise equal on all {n} lanes, with the plain solver inside the "
                  f"plain version and with S1")
            if n in JOINTED_SHAPES:
                timing_inputs[n, wind] = (state, action, draws)

    params = jointed_params()
    state, action, draws = timing_inputs[1024, False]
    rd = sample_reset_draws(torch.Generator(device="cuda").manual_seed(3), 1024)
    calls = {"step": lambda: env.step_env(None, state, action, params, draws),
             "reset": lambda: env.reset_env(None, 1024, params, rd)}
    for kind, call in calls.items():
        stable_lanes(torch, call, J1_STABLE_CALLS, f"J1 {kind}")
    print(f"  J1 N=1024: {J1_STABLE_CALLS} calls and a CUDA-graph replay bitwise equal, the "
          f"step and the reset frame")
    times = {key: (k_us / 1e3, p_us / 1e3, work) for key, (k_us, p_us, work)
             in jointed_device_times(card, timing_inputs).items()}
    return largest, times


def result_leaves(out):
    """An assembly_step result as a list of tensors."""
    from deep_q_learning_tpu_torch.envs.graphed import tree_leaves

    return tree_leaves(list(out))


def td_member_inputs(torch, m, b, a, seed):
    """The TD kernels' inputs with a member axis, as a population's learner
    gives them: ``q_s`` and ``q_next_online`` the halves of one (M, 2B, A)
    ``q_both``, read in place through the member stride."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    q_both = randn(m, 2 * b, a)
    return [
        q_both[:, :b], q_both[:, b:], randn(m, b, a),
        torch.randint(0, a, (m, b), generator=g, device="cuda", dtype=torch.int32),
        randn(m, b),
        0.97 * (torch.rand((m, b), generator=g, device="cuda") > 0.3).float(),
        torch.rand((m, b), generator=g, device="cuda") + 0.1,
    ]


def check_td_members(torch, td_kernels, err):
    """K1/K2 with a member axis against their plain versions, and each
    member bitwise equal to its own unbatched call; the unbatched shapes
    again as M = 1; K1 at M = 8 bitwise over 100 calls and its ticket 0
    after a CUDA-graph replay."""
    cases = [(shape, False) for shape in TD_MEMBER_SHAPES] + [(TD_MEMBER_MISALIGNED, True)]
    for i, ((m, b, a), skew) in enumerate(cases):
        args = td_member_inputs(torch, m, b, a, seed=100 + i)
        if skew:  # member rows off 16-byte alignment: the scalar path
            flat = torch.empty(m * 2 * b * a + 1, device="cuda")
            q_both = flat[1:].view(m, 2 * b, a)
            q_both.copy_(torch.cat([args[0], args[1]], dim=1))
            args[:2] = [q_both[:, :b], q_both[:, b:]]
            args[2] = misaligned(torch, args[2])
        assert td_kernels.float4_rows(a, *args[:3]) == (a == 4 and not skew)
        loss, td = td_kernels.td_loss_fwd(*args, 1.0, True)
        ref_loss, ref_td = td_kernels.td_loss_reference(*args, 1.0, True)
        torch.testing.assert_close(loss, ref_loss, **LOSS_TOL)
        torch.testing.assert_close(td, ref_td, **LOSS_TOL)
        g = torch.rand((m,), device="cuda") + 0.5
        dq = td_kernels.td_loss_bwd(td, args[3], args[6], g, a, 1.0, out_rows=2 * b)
        ref_dq = td_kernels.td_loss_backward_reference(td, args[3], args[6], g, a, 1.0, out_rows=2 * b)
        torch.testing.assert_close(dq, ref_dq, **DQ_TOL)
        assert dq.shape == (m, 2 * b, a) and not dq[:, b:].any()
        for k in range(m):  # a member's result does not depend on the others
            one_loss, one_td = td_kernels.td_loss_fwd(
                *[x[k].contiguous() for x in args], 1.0, True)
            one_dq = td_kernels.td_loss_bwd(one_td, args[3][k].contiguous(), args[6][k].contiguous(),
                                            g[k].contiguous(), a, 1.0, out_rows=2 * b)
            assert torch.equal(one_loss, loss[k]) and torch.equal(one_td, td[k]), (m, b, k)
            assert torch.equal(one_dq, dq[k]), (m, b, k)
        err["td_loss_fwd"] = max(err["td_loss_fwd"], float((loss - ref_loss).abs().max()),
                                 float((td - ref_td).abs().max()))
        err["td_loss_bwd"] = max(err["td_loss_bwd"], float((dq - ref_dq).abs().max()))
        print(f"  kernel vs plain (M, B, A)=({m}, {b}, {a}){' misaligned' if skew else ''}: ok, "
              f"each member bitwise its own call")
    for i, (b, a) in enumerate(TD_SHAPES):  # M = 1 of every unbatched shape
        args = td_inputs(torch, b, a, seed=200 + i)
        loss, td = td_kernels.td_loss_fwd(*args, 1.0, True)
        loss1, td1 = td_kernels.td_loss_fwd(*[x[None] for x in args], 1.0, True)
        g = torch.rand((), device="cuda") + 0.5
        dq = td_kernels.td_loss_bwd(td, args[3], args[6], g, a, 1.0, out_rows=2 * b)
        dq1 = td_kernels.td_loss_bwd(td1, args[3][None], args[6][None], g[None], a, 1.0, out_rows=2 * b)
        assert torch.equal(loss1[0], loss) and torch.equal(td1[0], td) and torch.equal(dq1[0], dq)
    print(f"  M = 1 at B, A = {TD_SHAPES}: bitwise the unbatched call")

    m, b, a = TD_MEMBER_STABLE
    args = td_member_inputs(torch, m, b, a, seed=5)
    loss0, td0 = td_kernels.td_loss_fwd(*args, 1.0, True)
    for _ in range(TD_STABLE_CALLS):
        loss, td = td_kernels.td_loss_fwd(*args, 1.0, True)
        assert torch.equal(loss, loss0) and torch.equal(td, td0), "K1 with members is not bitwise stable"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        td_kernels.td_loss_fwd(*args, 1.0, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [td_kernels.td_loss_fwd(*args, 1.0, True) for _ in range(10)]
    graph.replay()
    torch.cuda.synchronize()
    _, ticket = td_kernels.fwd_scratch(args[0].device)
    assert int(ticket) == 0, int(ticket)
    assert all(torch.equal(lo, loss0) and torch.equal(t, td0) for lo, t in outs)
    print(f"  K1 (M, B)=({m}, {b}): {TD_STABLE_CALLS} calls and a graph replay bitwise equal, "
          f"ticket counter 0")


def time_td_members(torch, td_kernels, card):
    """K1/K2 at a population's (M, B, A): kernel and plain times and work."""
    from deep_q_learning_tpu_torch.measure import bound_text

    m, b, a = TD_MEMBER_TIMED
    args = td_member_inputs(torch, m, b, a, seed=99)
    _, td = td_kernels.td_loss_fwd(*args, 1.0, True)
    g = torch.ones((m,), device="cuda")
    times = {
        "td_loss_fwd": (
            time_ms(torch, lambda: td_kernels.td_loss_fwd(*args, 1.0, True)),
            time_ms(torch, lambda: td_kernels.td_loss_reference(*args, 1.0, True)),
            td_kernels.td_loss_fwd_work(b, a, members=m),
        ),
        "td_loss_bwd": (
            time_ms(torch, lambda: td_kernels.td_loss_bwd(td, args[3], args[6], g, a, 1.0,
                                                          out_rows=2 * b)),
            time_ms(torch, lambda: td_kernels.td_loss_backward_reference(
                td, args[3], args[6], g, a, 1.0, out_rows=2 * b)),
            td_kernels.td_loss_bwd_work(b, a, 2 * b, members=m),
        ),
    }
    for name, (k_ms, p_ms, work) in times.items():
        print(f"  {name} (M, B, A)=({m}, {b}, {a}): kernel {k_ms * 1e3:.2f} us/call, "
              f"plain {p_ms * 1e3:.2f} us/call (CUDA events, {TIMED_CALLS} calls); "
              f"{bound_text(work, k_ms * 1e3)} [{card}]")
    return times


def check_slot_members(torch, sample_kernels, card):
    """K3 over every member's rows in one launch against M per-member calls
    (bitwise: each draw reads its own row) and the plain version (exact on
    dyadic priorities); its time beside its bound."""
    from deep_q_learning_tpu_torch.measure import bound_text

    m, n, c, b = SLOT_MEMBERS
    mismatches = 0
    for dyadic in (True, False):
        p, _, _ = slot_inputs(torch, m * n, c, 1, seed=11 + dyadic, dyadic=dyadic)
        g = torch.Generator(device="cuda").manual_seed(12)
        env = torch.randint(0, n, (m, b), generator=g, device="cuda")
        u = torch.rand((m, b), generator=g, device="cuda")
        sample_kernels.reset_counts()
        got = sample_kernels.slot_select_members(p, env, u)
        assert sample_kernels.launches == {"per_slot_sample": 1}, sample_kernels.launches
        each = torch.stack([sample_kernels.slot_select(p[k * n:(k + 1) * n].contiguous(), env[k],
                                                       u[k].contiguous()) for k in range(m)])
        assert torch.equal(got, each), "one launch over the members differs from per-member calls"
        want = sample_kernels.slot_select_reference(
            p, (env + torch.arange(m, device="cuda")[:, None] * n).reshape(-1), u.reshape(-1))
        if dyadic:
            assert torch.equal(got.reshape(-1), want), "K3 over the members vs plain, dyadic"
        else:
            mismatches = int((got.reshape(-1) != want).sum())
            assert mismatches < 0.01 * m * b, mismatches
    flat_env = (env + torch.arange(m, device="cuda")[:, None] * n).reshape(-1)
    flat_u = u.reshape(-1)
    times = (
        time_ms(torch, lambda: sample_kernels.slot_select_members(p, env, u)),
        time_ms(torch, lambda: sample_kernels.slot_select_reference(p, flat_env, flat_u)),
        sample_kernels.per_slot_sample_work(p, flat_env),
    )
    k_ms, p_ms, work = times
    print(f"  K3 over {m} members (M·N, C, M·B)=({m * n}, {c}, {m * b}): one launch equal to {m} "
          f"per-member calls; {mismatches} of {m * b} random draws differ from plain; kernel "
          f"{k_ms * 1e3:.2f} us/call, plain {p_ms * 1e3:.2f} us/call (CUDA events, {TIMED_CALLS} "
          f"calls); {bound_text(work, k_ms * 1e3)} [{card}]")
    return times


def slot_inputs(torch, n, c, b, seed, dyadic):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if dyadic:  # multiples of 1/64 with small totals: every sum is exact
        p = torch.randint(1, 257, (n, c), generator=g, device="cuda").float() / 64
        p = p * (torch.rand((n, c), generator=g, device="cuda") > 0.3)
        p[0] = 0.0  # an all-zero row
    else:
        p = torch.rand((n, c), generator=g, device="cuda") ** 3
    env = torch.randint(0, n, (b,), generator=g, device="cuda")
    u = torch.rand((b,), generator=g, device="cuda")
    return p.contiguous(), env, u


def slot_mismatches(torch, p, env, u, got, want, dyadic):
    """How many draws' slots differ; fails unless dyadic priorities match
    exactly and random ones differ only where every prefix between the two
    slots lies within 8 ulps of the row total of the draw."""
    n, c = p.shape
    b = env.shape[0]
    bad = (got != want).nonzero().flatten().tolist()
    if dyadic:
        assert not bad, f"K3 dyadic ({n}, {c}, {b}): {len(bad)} slots differ"
        return len(bad)
    rows = p[env].double()
    total = rows.sum(dim=1).float()
    draw = u.double() * total.double()
    cdf = torch.cumsum(rows, dim=1)
    ulp = (torch.nextafter(total, torch.full_like(total, math.inf)) - total).double()
    for i in bad:
        lo, hi = sorted((int(got[i]), int(want[i])))
        gap = float((cdf[i, lo:hi] - draw[i]).abs().max())
        assert gap <= SLOT_ULPS * float(ulp[i]), (n, c, b, i, gap)
    return len(bad)


def check_slot_edges(torch, sample_kernels, c):
    """The CPU tests' edge cases against the Pallas kernel, on the card
    against the plain version at C = ``c``: leading zero slots with u = 0,
    an all-zero row, u = 1.0 and 1.5, rows -1 and N."""
    g = torch.Generator().manual_seed(c)
    p = torch.randint(1, 257, (4, c), generator=g).float() / 64
    p[0, :17] = 0.0  # leading zero slots
    p[2] = 0.0  # an all-zero row
    p = p.cuda()
    env = torch.tensor([0, 0, 2, 2, 1, 3, 1, -1, 4, 3, 0], device="cuda")
    u = torch.tensor([0.0, 0.5, 0.0, 0.7, 1.5, 1.0, 0.999999, 0.3, 0.3, 1e-7, 0.25],
                     device="cuda")
    got = sample_kernels.slot_select(p, env, u).tolist()
    assert got == sample_kernels.slot_select_reference(p, env, u).tolist(), (c, got)
    assert got[0] == 0 and got[2] == got[3] == 0, got  # u = 0; the all-zero row
    assert got[4] == c - 1 and got[5] == c - 1, got  # past the total, at it: clamped
    assert got[7] == got[8] == 0, got  # no row


def check_slot_determinism(torch, sample_kernels, n, c, b):
    """100 calls give bitwise the same slots, and so do 10 calls replayed
    from a CUDA graph."""
    p, env, u = slot_inputs(torch, n, c, b, seed=3, dyadic=False)
    slots0 = sample_kernels.slot_select(p, env, u)
    for _ in range(SLOT_STABLE_CALLS):
        assert torch.equal(sample_kernels.slot_select(p, env, u), slots0), "K3 is not bitwise stable"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sample_kernels.slot_select(p, env, u)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [sample_kernels.slot_select(p, env, u) for _ in range(10)]
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, slots0) for o in outs), "K3 differs after a graph replay"


def check_slot_kernel(torch, sample_kernels, per_superstep, card):
    """Phase 3, K3: slot indices of the kernel against the plain version.
    Dyadic priorities must match exactly (their count of mismatches is the
    record's ``max_abs_err``); random ones may differ only where every
    prefix between the two slots lies within 8 ulps of the row total of
    the draw, and in under 1 % of at least 1024 draws (at B = 64 one draw
    would be 1.6 %).  Then the edge cases on every path, the slots' bitwise
    stability, and the times."""
    from deep_q_learning_tpu_torch.measure import bound_text

    dyadic_mismatches = 0
    for n, c, b in SLOT_SHAPES:
        for dyadic in (True, False):
            # random: the share of mismatches over at least SLOT_SHARE_DRAWS draws
            calls = 1 if dyadic else -(-SLOT_SHARE_DRAWS // b)
            differ = 0
            for k in range(calls):
                p, env, u = slot_inputs(torch, n, c, b, seed=n + c + k, dyadic=dyadic)
                if (n, c, b) == SLOT_MISALIGNED:
                    p = misaligned(torch, p)
                plan = sample_kernels.slot_plan(p)
                assert tuple(plan.values()) == SLOT_PLANS[(n, c, b)], ((n, c, b), plan)
                got = sample_kernels.slot_select(p, env, u)
                want = sample_kernels.slot_select_reference(p, env, u)
                torch.cuda.synchronize()
                differ += slot_mismatches(torch, p, env, u, got, want, dyadic)
            assert differ < 0.01 * calls * b, ((n, c, b), differ, calls * b)
            dyadic_mismatches += differ if dyadic else 0
            print(f"  K3 kernel vs plain (N, C, B)=({n}, {c}, {b}) "
                  f"{'dyadic' if dyadic else 'random'}, plan {plan}: {differ} of {calls * b} "
                  f"slots differ")
    for c in SLOT_EDGE_C:
        check_slot_edges(torch, sample_kernels, c)
    print(f"  K3 edge cases (u = 0, 1.0, 1.5, an all-zero row, rows -1 and N) at C = "
          f"{SLOT_EDGE_C}: equal to the plain version")
    for n, c, b in SLOT_TIMED:
        check_slot_determinism(torch, sample_kernels, n, c, b)
    print(f"  K3 at {SLOT_TIMED}: {SLOT_STABLE_CALLS} calls and a graph replay bitwise equal")
    times = {}
    for n, c, b in SLOT_TIMED:
        p, env, u = slot_inputs(torch, n, c, b, seed=7, dyadic=False)
        times[(n, c, b)] = (
            time_ms(torch, lambda: sample_kernels.slot_select(p, env, u)),
            time_ms(torch, lambda: sample_kernels.slot_select_reference(p, env, u)),
            sample_kernels.per_slot_sample_work(p, env),
        )
        k_ms, p_ms, work = times[(n, c, b)]
        print(f"  per_slot_sample (N, C, B)=({n}, {c}, {b}): kernel {k_ms * 1e3:.2f} us/call, "
              f"plain {p_ms * 1e3:.2f} us/call (CUDA events, {TIMED_CALLS} calls); "
              f"{bound_text(work, k_ms * 1e3)}; launches per superstep "
              f"{per_superstep['per_slot_sample']} [{card}]")
    return dyadic_mismatches, times


# the greedy evaluators, graphed against eager (phases 4, 7, 8, 9, 10): one
# seed, whole episodes of the trainer's eval envs (128 a trainer, 16 a
# member of phase 9's population), in turns graphed, eager, eager, graphed
EVAL_SEED = 0


def eval_pair(torch, label, evaluate, eval_venv, env_params, network, card, members=None,
              solver=False):
    """A greedy evaluation of ``network`` by a trainer's evaluator
    (``evaluate``: each eval step one CUDA graph) and by its eager form
    (``build_evaluator(..., graphed=False)`` on the same envs: the forward,
    argmax and accounting launched one by one around the env step's graph),
    in turns: returns, lengths and ``truncated`` bitwise equal; each
    evaluation's seconds; the step graph's replay on the device, and with
    ``solver`` J1 once in it (S1 not on its own: its body runs inside J1).
    Returns the seconds, graphed and eager."""
    from deep_q_learning_tpu_torch.algos.evaluate import build_evaluator
    from deep_q_learning_tpu_torch.measure import replay_ms, traced_kernels

    eager = build_evaluator(eval_venv, env_params, env_params.max_steps_in_episode,
                            members=members, graphed=False)
    assert eager.graph is None and evaluate.graph is not None, label
    results, seconds = [], {True: [], False: []}
    for graphed in (True, False, False, True):
        generator = torch.Generator(device="cuda").manual_seed(EVAL_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = (evaluate if graphed else eager)(network, generator)
        torch.cuda.synchronize()
        seconds[graphed].append(time.perf_counter() - t0)
        results.append([x.cpu() for x in ev])
    for other in results[1:]:
        for a, b in zip(results[0], other):
            assert a.dtype == b.dtype and torch.equal(a, b), label
    step = evaluate.graph
    assert step.graph is not None, f"{label}: the eval step was not captured"
    returns, lengths, truncated = results[0]
    assert torch.isfinite(returns).all() and not truncated.any(), label
    host_ms, device_ms, nodes = replay_ms(step)
    s1 = ""
    if solver:
        replay = traced_kernels(step.graph.replay)
        j1_count = replay.count(JOINTED_KERNEL)
        assert j1_count == 1 and replay.count(SOLVER_KERNEL) == 0, (j1_count, replay)
        s1 = ", J1 once in it"
    print(f"  eval {label}: {returns.numel()} greedy episodes, graphed bitwise eager (returns, "
          f"lengths, truncated); mean return {float(returns.mean()):.2f}, mean length "
          f"{float(lengths.float().mean()):.1f}, longest {int(lengths.max())}; seconds of one "
          f"evaluation graphed {[round(x, 4) for x in seconds[True]]} (a network's first "
          f"evaluation makes the step graph's eager call and capture), eager "
          f"{[round(x, 4) for x in seconds[False]]}; the "
          f"step's graph: replay {device_ms:.3f} ms on the device, {nodes} kernels{s1}, its "
          f"launch {host_ms:.3f} ms of host [{card}]")
    return seconds


def run_slice(torch, td_kernels, sample_kernels, lander_kernels, card):
    """Phase 4: lunar_per at full width through the Trainer, each frame as
    CUDA graph launches (``GraphedLearner``): the counters, a finite loss,
    the online net trained and the target following by Polyak averaging;
    in the last superstep, profiled, K1/K2 once per update and R1 once per
    vector step and reset pool on the device, no plain call, the host's
    launches per vector step and the device's busy share; peak memory
    under 1 GiB; a greedy evaluation; the eager learner restored from the
    graphed one's checkpoint, one superstep each bitwise, then env-steps/s
    in alternating pairs; graph L's replay on the device.  Returns R1's
    launches in the profiled superstep."""
    from deep_q_learning_tpu_torch.algos.superstep import GraphedLearner
    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.measure import learner_kernels, replay_ms
    from deep_q_learning_tpu_torch.train import Trainer

    cfg = lunar_per()
    workdir = tempfile.mkdtemp(dir=REPO / "build")
    trainer = Trainer(cfg, device="cuda", workdir=workdir).init(seed=0)
    assert isinstance(trainer._superstep, GraphedLearner)
    online0 = [p.detach().clone() for p in trainer.runner.train.online.parameters()]
    target0 = [p.detach().clone() for p in trainer.runner.train.target.parameters()]
    torch.cuda.synchronize()
    fresh_peak(torch)

    td_kernels.reset_counts()
    sample_kernels.reset_counts()
    lander_kernels.reset_counts()
    t0 = time.perf_counter()
    metrics = [trainer.step() for _ in range(SUPERSTEPS - 1)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # the last superstep under the profiler, every frame training: K1/K2 and
    # R1 on the device (a graph's replay passes none of the wrappers' counters)
    trace, _ = traced_superstep(lambda: metrics.append(trainer.step()), "phase 4")
    launches = learner_kernels(trace)
    steady = metrics[-1].loss_count
    assert steady == cfg.steps_per_superstep, steady
    assert launches == {"td_loss_fwd": steady, "td_loss_bwd": steady, "per_slot_sample": 0}, (
        launches, steady, collections.Counter(trace.per_graph_launch), trace.lost)
    rigid = trace.count(RIGID_KERNEL)
    assert rigid == cfg.steps_per_superstep + 1, (rigid, cfg.steps_per_superstep)
    assert lander_kernels.plain_calls == {"rigid_step": 0}, lander_kernels.plain_calls
    assert sample_kernels.launches == {"per_slot_sample": 0}  # off in lunar_per
    rigid_vector_graph(torch, cfg, card)
    assert td_kernels.plain_calls == {"td_loss_fwd": 0, "td_loss_bwd": 0}
    per_step = trace.host_launches / cfg.steps_per_superstep
    assert per_step <= WHOLE_HOST_LAUNCHES, (per_step, trace.launches, trace.copies)
    assert trainer._superstep.runs == {"frames": SUPERSTEPS - 2,
                                       "whole": len(metrics) - (SUPERSTEPS - 2)}, (
        trainer._superstep.runs)

    updates = sum(m.loss_count for m in metrics)
    loss_sum = sum(m.loss_sum for m in metrics)
    env_steps = metrics[-1].env_steps * cfg.num_envs
    assert env_steps == len(metrics) * cfg.steps_per_superstep * cfg.num_envs
    timed_steps = (SUPERSTEPS - 1) * cfg.steps_per_superstep * cfg.num_envs
    assert updates > 0, "no learner update ran"
    opt = trainer.runner.train.opt_state
    assert updates == trainer.runner.train.updates == opt.count == int(opt.device_count)
    assert math.isfinite(loss_sum), loss_sum
    online = [p.detach() for p in trainer.runner.train.online.parameters()]
    target = [p.detach() for p in trainer.runner.train.target.parameters()]
    moved_online = sum(float((p - p0).norm()) for p, p0 in zip(online, online0))
    moved_target = sum(float((t - t0_).norm()) for t, t0_ in zip(target, target0))
    gap = sum(float((t - p).norm()) for t, p in zip(target, online))
    assert moved_online > 0 and 0 < moved_target < moved_online and gap > 0, (
        moved_online, moved_target, gap)
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    assert peak_mib < 1024, peak_mib

    f5_pair(torch, trainer, metrics, card)
    ev = trainer.evaluate(seed=0)
    assert ev.returns.shape == (128,) and all(math.isfinite(x) for x in ev.returns)
    eval_pair(torch, "lunar_per", trainer._evaluate, trainer.eval_venv, trainer.env_params,
              trainer.runner.train.online, card)
    frame, learn = trainer._superstep.frame, trainer._superstep.learn
    print(f"  supersteps: {[(m.env_steps, m.loss_count, round(m.loss_sum / max(m.loss_count, 1), 5)) for m in metrics]}")
    print(f"  updates {updates}, episodes {metrics[-1].episodes}, window {metrics[-1].window_mean:.3f}, "
          f"eval mean {float(ev.returns.mean()):.3f} over {len(ev.returns)} episodes")
    print(f"  lunar_per x{cfg.num_envs} envs: {timed_steps} "
          f"env steps of the first {SUPERSTEPS - 1} supersteps in {seconds:.3f} s = "
          f"{timed_steps / seconds:.1f} env-steps/s (with "
          f"the graphs' eager calls and captures), peak memory {peak_mib:.1f} MiB [{card}]")
    print(f"  the last superstep, profiled: {steady} updates, K1/K2 on the device {launches}, R1 "
          f"{rigid} times ({cfg.steps_per_superstep} vector steps and the reset pool; the "
          f"wrapper {lander_kernels.launches['rigid_step']} launches in the eager calls and "
          f"captures), no plain call; {per_step:.1f} host launches per vector step "
          f"({trace.launches} kernels, "
          f"{len(trace.per_graph_launch)} graphs, {trace.copies} copies and fills in "
          f"{cfg.steps_per_superstep} vector steps, the superstep one replay; at most "
          f"{WHOLE_HOST_LAUNCHES}), device busy {100 * trace.device_us / trace.wall_us:.1f} % of "
          f"{trace.wall_us / 1e3:.1f} ms [{card}]")
    frames = Trainer(cfg, device="cuda").init(seed=0)
    frames._superstep.max_graphs = 0
    lockstep(torch, "lunar_per", {"frames": Learner(frames)}, len(metrics))
    same_tree(torch, runner_tree(frames), runner_tree(trainer), "lunar_per frames vs whole")
    whole = whole_vs_frames(torch, "lunar_per", Learner(trainer), Learner(frames),
                            cfg.steps_per_superstep, cfg.num_envs, card)
    del frames
    first_training_frames(torch, card)
    slice_pairs(torch, trainer, cfg, workdir, td_kernels, card)
    shutil.rmtree(workdir, ignore_errors=True)
    # last: a replay of the learner's graphs writes the runner again
    for name, g in (("frame (actor, env step, replay write)", frame), ("update (graph L)", learn)):
        host_ms, device_ms, nodes = replay_ms(g)
        print(f"  the graph of the {name}: replay {device_ms:.3f} ms on the device (CUDA events), "
              f"{nodes} kernels, its launch {host_ms:.3f} ms of host; captured in "
              f"{g.capture_s:.3f} s after a {g.warmup_s:.3f} s eager call [{card}]")
    superstep_replay_ms(torch, "lunar_per", whole["graph"], card)
    return rigid


def rigid_vector_graph(torch, cfg, card) -> None:
    """The preset's vector step with its reset pool as ``VectorEnv`` runs it
    in a CUDA graph (``measure.graphed_vector_step``): one kernel, R1's."""
    from deep_q_learning_tpu_torch.envs import make_env
    from deep_q_learning_tpu_torch.measure import graphed_vector_step

    env, params = make_env(cfg.env_id, cfg.time_fraction_obs, cfg.max_steps_in_episode,
                           param_overrides=cfg.env_param_overrides())
    g = torch.Generator(device="cuda").manual_seed(5)
    _, st = env.reset_env(g, cfg.num_envs, params)
    _, nodes, kernels = graphed_vector_step(env, params, cfg.num_envs, g, st, card)
    assert nodes == 1 and kernels["lander_rigid_step"] == 1, (nodes, kernels)


def f5_pair(torch, graphed, metrics, card):
    """Phase 4, F5 (CUDA divides by a Python float as a multiply by its
    float32 reciprocal, by a tensor as a true division): ``epsilon_greedy``
    with a float ε against the device scalar the graphed frame reads, over
    2^20 draws at each of F5_EPSILONS, the same actions; then the eager
    learner from the graphed one's seed through as many supersteps as it
    ran (``metrics``, 512 frames or more while ε explores): metrics and
    runners bitwise equal."""
    from deep_q_learning_tpu_torch.algos.dqn import epsilon_greedy
    from deep_q_learning_tpu_torch.algos.superstep import GraphedLearner
    from deep_q_learning_tpu_torch.train import Trainer

    g = torch.Generator(device="cuda").manual_seed(0)
    u = torch.rand((F5_DRAWS,), generator=g, device="cuda")
    q = torch.randn((F5_DRAWS, 4), generator=g, device="cuda")
    explored = []
    for eps in F5_EPSILONS:
        static = torch.zeros((), device="cuda")
        static.fill_(eps)
        assert torch.equal(epsilon_greedy(None, q, eps, u=u),
                           epsilon_greedy(None, q, static, u=u)), eps
        explored.append(int((u < static).sum()))
    cfg = graphed.cfg
    eager = Trainer(cfg, device="cuda", graphed_learner=False).init(seed=0)
    assert not isinstance(eager._superstep, GraphedLearner)
    assert [eager.step() for _ in metrics] == metrics
    same_tree(torch, runner_tree(graphed), runner_tree(eager), "F5 pair")
    frames = len(metrics) * cfg.steps_per_superstep
    assert frames >= 512 and metrics[-1].epsilon > 0.5, (frames, metrics[-1].epsilon)
    print(f"  F5: epsilon_greedy with a float ε equals it with the device scalar over "
          f"{F5_DRAWS} draws at ε {F5_EPSILONS} ({explored} explored); the eager learner from "
          f"seed 0 bitwise the graphed one after {frames} frames (ε "
          f"{metrics[0].epsilon:.3f} to {metrics[-1].epsilon:.3f}, {graphed.runner.train.updates} "
          f"updates) [{card}]")


def first_training_frames(torch, card):
    """Phase 4: the learner's graph makes its first call eagerly and
    captures on the second, so no frame applies its update twice: one
    ``lunar_per`` frame a superstep at full width through the graphed
    learner and the eager one from the same seed, learning from frame
    FIRST_TRAIN_FRAME; after every frame the Adam count is the number of
    updates (1 after the first training frame, an eager call; 2 after the
    capture and its replay) and the runners are bitwise equal."""
    import dataclasses

    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.train import Trainer

    cfg = dataclasses.replace(lunar_per(), steps_per_superstep=1,
                              training_start=FIRST_TRAIN_FRAME * 128)
    graphed = Trainer(cfg, device="cuda").init(seed=0)
    graphed._superstep.max_graphs = 0  # frame by frame: no one-frame superstep graph
    eager = Trainer(cfg, device="cuda", graphed_learner=False).init(seed=0)
    counts = []
    for frame in range(1, FIRST_TRAIN_FRAME + 4):
        assert graphed.step() == eager.step(), frame
        opt = graphed.runner.train.opt_state
        assert int(opt.device_count) == opt.count == max(frame - FIRST_TRAIN_FRAME + 1, 0), frame
        same_tree(torch, runner_tree(graphed), runner_tree(eager), f"frame {frame}")
        counts.append(opt.count)
    assert graphed._superstep.learn.graph is not None
    print(f"  the first training frames, one a superstep, graphed learner vs eager: Adam count "
          f"{counts} over frames 1-{len(counts)} (the first training frame an eager call, the "
          f"next the capture and its replay), runners bitwise equal after each [{card}]")


def slice_pairs(torch, trainer, cfg, workdir, td_kernels, card):
    """Phase 4: the graphed learner against the eager one (the frame eager
    around the env step's graph) restored from its checkpoint: one superstep
    each, runners bitwise equal, then env-steps/s in three alternating
    pairs; K1/K2 once per eager update by the wrappers' counters, which the
    graphed learner's replays never pass."""
    from deep_q_learning_tpu_torch.algos.superstep import GraphedLearner
    from deep_q_learning_tpu_torch.train import Trainer

    trainer.save(step=trainer.runner.env_step * cfg.num_envs)
    eager = Trainer(cfg, device="cuda", workdir=workdir, graphed_learner=False).restore()
    assert eager.venv.graphed and not isinstance(eager._superstep, GraphedLearner)
    rates = {"graphed": [], "eager": []}
    td_kernels.reset_counts()
    eager_updates = 0
    for i, name in enumerate(["graphed", "eager", "eager", "graphed", "graphed", "eager"]):
        t = trainer if name == "graphed" else eager
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = t.step()
        torch.cuda.synchronize()
        rates[name].append(cfg.steps_per_superstep * cfg.num_envs / (time.perf_counter() - t0))
        eager_updates += m.loss_count if name == "eager" else 0
        if i == 1:  # both from the same checkpoint, one superstep each
            same_tree(torch, runner_tree(trainer), runner_tree(eager))
    assert td_kernels.launches == {"td_loss_fwd": eager_updates, "td_loss_bwd": eager_updates}
    assert td_kernels.plain_calls == {"td_loss_fwd": 0, "td_loss_bwd": 0}
    print(f"  one superstep graphed and one with the eager learner from the same checkpoint: "
          f"runners bitwise equal (parameters, Adam moments and count, replay ring, priorities "
          f"and counters, env states)")
    print(f"  lunar_per x{cfg.num_envs} env-steps/s in turns, graphed learner "
          f"{', '.join(f'{x:.1f}' for x in rates['graphed'])}; eager learner "
          f"{', '.join(f'{x:.1f}' for x in rates['eager'])} [{card}]")


def run_scaled(torch, td_kernels, sample_kernels, lander_kernels, card):
    """Phase 5: lunar_per_scaled(1024) with the PER slot kernel, at full
    width through the Trainer's graphed learner: K1, K2 and K3 once per
    update and R1 once per vector step and reset pool on the device in the
    last superstep, profiled, one replay of the superstep's graph, and no
    plain call."""
    import dataclasses

    from deep_q_learning_tpu_torch.algos.superstep import GraphedLearner
    from deep_q_learning_tpu_torch.config import lunar_per_scaled
    from deep_q_learning_tpu_torch.measure import learner_kernels
    from deep_q_learning_tpu_torch.train import Trainer

    cfg = dataclasses.replace(lunar_per_scaled(1024), use_pallas_sampler=True)
    trainer = Trainer(cfg, device="cuda").init(seed=0)
    assert isinstance(trainer._superstep, GraphedLearner)
    per = trainer.runner.replay.priorities
    assert per.shape == (1024, 512) and cfg.batch_size == 1024, (per.shape, cfg.batch_size)
    torch.cuda.synchronize()
    fresh_peak(torch)

    td_kernels.reset_counts()
    sample_kernels.reset_counts()
    lander_kernels.reset_counts()
    t0 = time.perf_counter()
    metrics = [trainer.step() for _ in range(SCALED_SUPERSTEPS - 1)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # the last superstep under the profiler: the kernels on the device
    trace, _ = traced_superstep(lambda: metrics.append(trainer.step()), "phase 5")
    launches = learner_kernels(trace)
    rigid = trace.count(RIGID_KERNEL)
    assert rigid == cfg.steps_per_superstep + 1, (rigid, cfg.steps_per_superstep)
    plain = dict(td_kernels.plain_calls, **sample_kernels.plain_calls, **lander_kernels.plain_calls)
    rigid_vector_graph(torch, cfg, card)

    updates = sum(m.loss_count for m in metrics)
    steady = metrics[-1].loss_count
    loss_sum = sum(m.loss_sum for m in metrics)
    env_steps = metrics[-1].env_steps * cfg.num_envs
    assert env_steps == len(metrics) * cfg.steps_per_superstep * cfg.num_envs
    timed_steps = (SCALED_SUPERSTEPS - 1) * cfg.steps_per_superstep * cfg.num_envs
    assert updates > 0 and updates == trainer.runner.train.updates
    assert steady == cfg.steps_per_superstep // cfg.train_every, steady
    assert launches == dict.fromkeys(("td_loss_fwd", "td_loss_bwd", "per_slot_sample"), steady), (
        launches, steady)
    assert not any(plain.values()), plain
    assert math.isfinite(loss_sum), loss_sum
    assert float(trainer.runner.replay.max_priority) > 0
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    assert peak_mib < 1024, peak_mib
    per_step = trace.host_launches / cfg.steps_per_superstep
    assert per_step <= WHOLE_HOST_LAUNCHES, per_step
    runs = trainer._superstep.runs
    assert runs == {"frames": SCALED_SUPERSTEPS - 2,
                    "whole": len(metrics) - (SCALED_SUPERSTEPS - 2)}, runs
    graph = steady_graph(Learner(trainer))
    print(f"  supersteps: {[(m.env_steps, m.loss_count, round(m.loss_sum / max(m.loss_count, 1), 5)) for m in metrics]}")
    print(f"  updates {updates}; the last superstep, profiled, one replay of its graph "
          f"({graph.nodes} nodes, captured in {graph.capture_s:.3f} s, instantiated in "
          f"{graph.instantiate_s:.3f} s; supersteps run as one replay / frame by frame "
          f"{runs['whole']} / {runs['frames']}): {steady} updates, K1-K3 on the device "
          f"{launches}, R1 {rigid} times, no plain call, {per_step:.3f} host launches per vector "
          f"step, device busy "
          f"{100 * trace.device_us / trace.wall_us:.1f} %; episodes {metrics[-1].episodes}")
    print(f"  lunar_per_scaled x{cfg.num_envs} envs, use_pallas_sampler: "
          f"{timed_steps} env steps of the first {SCALED_SUPERSTEPS - 1} "
          f"supersteps (with the graphs' eager calls and captures) in {seconds:.3f} s = "
          f"{timed_steps / seconds:.1f} env-steps/s, "
          f"peak memory {peak_mib:.1f} MiB [{card}]")
    return launches


def run_cli(card, workdir):
    """Phase 6: train one superstep with a checkpoint, resume for one more,
    then evaluate the last checkpoint, each as ``python -m
    deep_q_learning_tpu_torch``; the checkpoints stay in ``workdir`` for
    phase 10."""
    per_superstep = 128 * 1024

    def cli(*args):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "deep_q_learning_tpu_torch", *args],
            cwd=REPO, capture_output=True, text=True, timeout=400,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"CLI {args[0]} exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"  {args[0]}{' --resume' if '--resume' in args else ''}: {out} "
              f"({time.perf_counter() - t0:.1f} s with start-up)")
        return out

    common = ["--preset", "lunar_per_scaled", "--workdir", workdir]
    for item in SCALED_SETS:
        common += ["--set", item]
    first = cli("train", *common, "--max-env-steps", str(per_superstep),
                "--checkpoint-every", "1", "--log-every", "1", "--quiet")
    assert first["env_steps"] == per_superstep and first["updates"] > 0, first
    resumed = cli("train", *common, "--resume", "--max-env-steps", str(2 * per_superstep),
                  "--checkpoint-every", "1", "--log-every", "1", "--quiet")
    assert resumed["env_steps"] == 2 * per_superstep, resumed
    assert resumed["updates"] > first["updates"] and resumed["episodes"] >= first["episodes"]
    report = cli("eval", *common)
    assert report["step"] == 2 * per_superstep and report["episodes"] == 128, report
    assert math.isfinite(report["return_mean"]) and report["length_mean"] > 0, report
    print(f"  CLI train -> resume -> eval on the card: ok [{card}]")


def runner_tree(trainer):
    from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

    return ckpt._to_tree(trainer.runner)


def same_tree(torch, a, b, where="runner") -> None:
    """Bitwise equality of two checkpoint trees (tensors, dicts, lists, numbers)."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            same_tree(torch, a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(torch, x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


class TraceLost(RuntimeError):
    """Raised by :func:`traced_superstep`: every attempt's trace lost
    kernel records."""


# a phase run again in a process of its own (phase_anew): the phase's
# function from this script, given torch, the kernel modules named, the
# card's line and the arguments after them, its result printed last as JSON
PHASE_ANEW = (
    "import importlib, json, sys, torch\n"
    "import chip_smoke\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "torch.backends.cudnn.allow_tf32 = False\n"
    "fn, modules, extra = json.loads(sys.argv[1])\n"
    "modules = [importlib.import_module('deep_q_learning_tpu_torch.ops.' + m) for m in modules]\n"
    "out = getattr(chip_smoke, fn)(torch, *modules, chip_smoke.card_line(), *extra)\n"
    "print(json.dumps(out))\n"
)


def phase_anew(lost: TraceLost, fn: str, modules: list, *extra):
    """The phase ``fn`` again, in a process of its own, where its profiled
    superstep lost kernel records in every attempt in this process: late
    in a run of this script the profiler can drop the same kernels' records
    (the superstep metrics' ``aten::fill_``) in every trace of a process,
    and it kept them in every young process.  The phase's checks all run
    again there; prints its lines and returns its result."""
    print(f"  {lost}: the phase again, in a process of its own")
    proc = subprocess.run([sys.executable, "-c", PHASE_ANEW, json.dumps([fn, modules, extra])],
                          cwd=REPO, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{fn} in a process of its own exited {proc.returncode}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    *lines, result = proc.stdout.strip().splitlines()
    for line in lines:
        print(f"  | {line}")
    return json.loads(result)


def traced_superstep(step, where: str):
    """``measure.traced_kernels(step)`` of a superstep whose trace the
    profiler kept whole, and the supersteps it took: a trace in which a
    kernel launch or a CUDA graph launch has no kernel (the profiler lost
    its records: phase 4's lost the kernels of up to 12 of its 257 graph
    launches in two of four whole runs of this script, and none in nine
    traces of the same superstep in processes of their own; late in this
    script the losses fall within a few ms of a session's start or end,
    and phase 13 (b) lost three lone replays' records in a row) is
    reported, and ``step`` runs and is traced again, up to TRACE_ATTEMPTS
    times, each time with the session idle TRACE_PAD_GROWTH times longer
    around the span."""
    from deep_q_learning_tpu_torch.measure import PAD_S, traced_kernels

    for attempt in range(1, TRACE_ATTEMPTS + 1):
        pad_s = PAD_S * TRACE_PAD_GROWTH ** (attempt - 1)
        trace = traced_kernels(step, pad_s=pad_s)
        empty = trace.per_graph_launch.count(0)
        if not trace.lost and not empty:
            return trace, attempt
        lost_ms = [round(t / 1e3, 2) for t in trace.lost_at_us]
        print(f"  {where}: the profiler lost records in superstep {attempt} of the trace "
              f"({trace.lost} of {trace.launches} kernel launches and {empty} of "
              f"{len(trace.per_graph_launch)} graph launches with no kernel, launched "
              f"{lost_ms[:3]}..{lost_ms[-3:]} ms into the span of {trace.wall_us / 1e3:.1f} ms, "
              f"the session idle {pad_s} s around it; lost {trace.lost_in[:4]}, kernels with "
              f"no host call {dict(trace.orphans)}); tracing the next")
    raise TraceLost(f"{where}: the profiler lost records in {TRACE_ATTEMPTS} supersteps")


class Learner:
    """A learner driven superstep by superstep: a ``Trainer``, or a
    population's runner and step."""

    def __init__(self, trainer=None, runner=None, step=None):
        self.trainer, self.population = trainer, (runner, step)

    @property
    def superstep(self):
        """The ``GraphedLearner`` (or ``GraphedPopulation``) that runs it."""
        return self.trainer._superstep if self.trainer is not None else self.population[1]

    @property
    def runner(self):
        return self.trainer.runner if self.trainer is not None else self.population[0]

    def step(self):
        """One superstep; its metrics."""
        if self.trainer is not None:
            return self.trainer.step()
        runner, step = self.population
        return step(runner)[1]


def same_metrics(a, b, where) -> None:
    """Bitwise equality of two ``SuperstepMetrics`` (a population's arrays too)."""
    import dataclasses

    import numpy as np

    for f in dataclasses.fields(a):
        x, y = np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))
        assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True), (where, f.name, x, y)


def lockstep(torch, label, learners: dict, supersteps: int) -> list:
    """``supersteps`` supersteps of each of ``learners`` (one seed) in
    turns: the metrics and runners of each equal bitwise to the first's after
    every superstep.  Returns the first's metrics."""
    from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

    (first, lead), *others = learners.items()
    metrics = []
    for i in range(supersteps):
        metrics.append(lead.step())
        for name, other in others:
            same_metrics(other.step(), metrics[-1], f"{label}: {name} superstep {i + 1}")
        tree = ckpt._to_tree(lead.runner)
        for name, other in others:
            same_tree(torch, ckpt._to_tree(other.runner), tree, f"{label}: {name} vs {first} "
                      f"after superstep {i + 1}")
    return metrics


def steady_graph(learner):
    """The superstep graph (a ``GraphedStep``) that ``learner``'s next
    superstep replays."""
    from deep_q_learning_tpu_torch.measure import superstep_graph

    graph = superstep_graph(learner.superstep, learner.runner)
    assert graph is not None, "the next superstep has no graph"
    return graph


# P2g: env-steps/s of the superstep as one graph and frame by frame, in turns
WHOLE_TURNS = ("whole", "frames", "frames", "whole", "whole", "frames")
# at most, the host's launches of a steady superstep that runs as one
# replay (the replay, the fills of the generators' seeds and offsets, the ε
# table's copy and the metrics' read), a superstep and, at lunar_per's 128
# frames, a vector step
WHOLE_SUPERSTEP_LAUNCHES = 32
WHOLE_HOST_LAUNCHES = 1.0


def whole_vs_frames(torch, label, whole, frames, frames_per, envs, card) -> dict:
    """P2g: ``whole``, a ``Learner`` whose steady supersteps replay the
    superstep's graph, against ``frames``, the same learner from the same
    seed frame by frame (``max_graphs = 0``), both past the capture and in
    step: env-steps/s in turns (WHOLE_TURNS), the two bitwise equal after
    each pair, then one steady superstep of each traced
    (``traced_superstep``: the host's launches a vector step, the kernels of
    the superstep's graph, the device's busy share), bitwise after it; the
    graph's nodes, capture and instantiation seconds, and the peak memory
    since the caller's ``fresh_peak`` (under 1 GiB).  ``frames_per`` vector steps of ``envs``
    envs a superstep.  Returns the numbers and the graph; a replay of the
    graph alone (``superstep_replay_ms``) is the caller's, last."""
    from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

    assert frames.superstep.max_graphs == 0 and whole.superstep.max_graphs > 0
    graph = steady_graph(whole)
    rates = {"whole": [], "frames": []}
    for i, name in enumerate(WHOLE_TURNS):  # before the traces: no profiler has run on them
        learner = whole if name == "whole" else frames
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learner.step()
        torch.cuda.synchronize()
        rates[name].append(frames_per * envs / (time.perf_counter() - t0))
        if i % 2:
            same_tree(torch, ckpt._to_tree(frames.runner), ckpt._to_tree(whole.runner),
                      f"{label}: frames vs whole in turns")
    runs = dict(whole.superstep.runs)
    traces, taken = {}, {}
    for name, learner in (("whole", whole), ("frames", frames)):
        traces[name], taken[name] = traced_superstep(learner.step, f"{label} ({name})")
    for name, learner in (("whole", whole), ("frames", frames)):  # back in step
        for _ in range(max(taken.values()) - taken[name]):
            learner.step()
    replays = whole.superstep.runs["whole"] - runs["whole"]
    assert replays == max(taken.values()), (label, replays, taken)
    assert len(traces["whole"].per_graph_launch) == 1, (label, traces["whole"].per_graph_launch)
    same_tree(torch, ckpt._to_tree(frames.runner), ckpt._to_tree(whole.runner),
              f"{label}: frames vs whole after the traced superstep")
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    assert peak_mib < 1024, (label, peak_mib)
    per_step = {name: t.host_launches / frames_per for name, t in traces.items()}
    t = traces["whole"]
    assert t.host_launches <= WHOLE_SUPERSTEP_LAUNCHES, (label, t.launches, t.copies)
    print(f"  {label}, P2g: a steady superstep as one replay of its graph ({graph.nodes} nodes, "
          f"{t.per_graph_launch[0]} kernels on the device, captured in {graph.capture_s:.3f} s, "
          f"instantiated in {graph.instantiate_s:.3f} s, its capture reserving "
          f"{graph.pool_bytes / 2**20:.1f} MiB), bitwise the same learner frame by "
          f"frame after every superstep; supersteps run as one replay / frame by frame "
          f"{whole.superstep.runs['whole']} / {whole.superstep.runs['frames']}; host launches a "
          f"vector step {per_step['whole']:.3f} ({t.launches} kernels, "
          f"{len(t.per_graph_launch)} graphs, {t.copies} copies and fills in {frames_per} "
          f"vector steps) against {per_step['frames']:.2f} frame by frame; device busy "
          f"{100 * t.device_us / t.wall_us:.1f} % of {t.wall_us / 1e3:.1f} ms against "
          f"{100 * traces['frames'].device_us / traces['frames'].wall_us:.1f} % of "
          f"{traces['frames'].wall_us / 1e3:.1f} ms (profiled); peak memory "
          f"{peak_mib:.1f} MiB [{card}]")
    print(f"  {label} env-steps/s in turns: one replay "
          f"{', '.join(f'{x:.1f}' for x in rates['whole'])}; frame by frame "
          f"{', '.join(f'{x:.1f}' for x in rates['frames'])} [{card}]")
    return {"graph": graph, "per_step": per_step, "rates": rates, "peak_mib": peak_mib,
            "trace": t}


def superstep_replay_ms(torch, label, graph, card, replays=2) -> float:
    """The device ms of a replay of a superstep's graph alone (CUDA events
    over ``replays`` back-to-back replays), and the host ms of its launch.
    Each applies a superstep to the runner past its host mirrors: the
    runner is not to be used after."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    host = 0.0
    for _ in range(replays):
        t0 = time.perf_counter()
        graph.graph.replay()
        host += time.perf_counter() - t0
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / replays
    print(f"  {label}: the superstep's graph replayed alone, {ms:.3f} ms on the device "
          f"(CUDA events over {replays} replays), its launch {1e3 * host / replays:.3f} ms of "
          f"host [{card}]")
    return ms


def run_jointed(torch, td_kernels, sample_kernels, solver_kernels, jointed_kernels, plain_launches,
                card):
    """Phase 7: lunar_jointed_per at full width through the Trainer, each
    frame as CUDA graphs (the frame with the jointed vector step, the
    learner update) and the reset pool as one: the counters, K1/K2 once per
    update, J1 once per vector step and per reset pool on the device (S1
    never on its own, its body inside J1, and no plain version), the
    captures timed apart from the replays,
    graphed frames bitwise eager frames and a replay's kernels equal to an
    eager step's, an eager trainer restored from the graphed one's
    checkpoint bitwise after a superstep each, and graphed against eager
    env-steps/s in alternating pairs.  Returns the launches of K1, K2, J1
    and S1 (its own, 0) in the second superstep (counted in the profiler's
    trace: inside a CUDA graph a wrapper's counter sees the eager call and
    the capture, not the replays)."""
    import dataclasses

    from deep_q_learning_tpu_torch.algos.superstep import GraphedLearner
    from deep_q_learning_tpu_torch.config import lunar_jointed_per
    from deep_q_learning_tpu_torch.measure import learner_kernels, traced_kernels
    from deep_q_learning_tpu_torch.train import Trainer

    cfg = dataclasses.replace(lunar_jointed_per(), **JOINTED_CUTS)
    assert (cfg.num_envs, cfg.hidden, cfg.batch_size, cfg.n_step, cfg.dueling) == (
        128, (256, 256), 256, 3, True), cfg
    assert (cfg.lander_engine, cfg.lander_vel_iters, cfg.lander_pos_iters) == ("jointed", 120, 40)
    assert cfg.use_pallas and not cfg.use_pallas_sampler
    workdir = tempfile.mkdtemp(dir=REPO / "build")
    torch.cuda.synchronize()
    fresh_peak(torch)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device="cuda", workdir=workdir).init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    assert trainer.venv.graphed and isinstance(trainer._superstep, GraphedLearner)
    assert trainer.runner.replay.priorities.shape == (128, 4096)
    assert trainer.runner.env_states.solver_acc.c1.shape == (128, 4, 2)
    online0 = [p.detach().clone() for p in trainer.runner.train.online.parameters()]
    target0 = [p.detach().clone() for p in trainer.runner.train.target.parameters()]

    td_kernels.reset_counts()
    sample_kernels.reset_counts()
    solver_kernels.reset_counts()
    jointed_kernels.reset_counts()
    walls = []
    metrics = []

    def superstep():
        t0 = time.perf_counter()
        metrics.append(trainer.step())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    # the first superstep captures the frame graph (and the update's, at its
    # last frame); in the second, under the profiler, J1 runs on the device
    # once a vector step (a replay of the frame graph) and once for the
    # reset pool, K1 and K2 once an update
    superstep()
    trace = traced_kernels(superstep)
    j1_events, s1_events = trace.count(JOINTED_KERNEL), trace.count(SOLVER_KERNEL)
    counted = learner_kernels(trace)
    plain = dict(td_kernels.plain_calls, **sample_kernels.plain_calls,
                 **solver_kernels.plain_calls, **jointed_kernels.plain_calls)
    assert sample_kernels.launches == {"per_slot_sample": 0}  # off in lunar_jointed_per

    updates = sum(m.loss_count for m in metrics)
    loss_sum = sum(m.loss_sum for m in metrics)
    vector_steps = JOINTED_SUPERSTEPS * cfg.steps_per_superstep
    assert [m.env_steps for m in metrics] == [
        cfg.steps_per_superstep * (i + 1) for i in range(JOINTED_SUPERSTEPS)]
    assert trainer.runner.replay.total_adds == vector_steps
    # learning starts once 2048 transitions are stored: at vector step 16
    first = cfg.training_start // cfg.num_envs
    assert updates == vector_steps - first + 1 == trainer.runner.train.updates, updates
    opt = trainer.runner.train.opt_state
    assert opt.count == updates == int(opt.device_count)
    assert metrics[-1].episodes == sum(m.episodes_delta for m in metrics)
    steady = metrics[-1].loss_count
    assert counted == {"td_loss_fwd": steady, "td_loss_bwd": steady, "per_slot_sample": 0}, (
        counted, steady)
    assert not any(plain.values()), plain
    assert JOINTED_SUPERSTEPS == 2 and j1_events == cfg.steps_per_superstep + 1, j1_events
    assert s1_events == 0, s1_events
    launches = {"td_loss_fwd": steady, "td_loss_bwd": steady, "lander_jointed_step": j1_events,
                "assembly_step": s1_events}
    assert math.isfinite(loss_sum), loss_sum
    online = [p.detach() for p in trainer.runner.train.online.parameters()]
    target = [p.detach() for p in trainer.runner.train.target.parameters()]
    moved_online = sum(float((p - p0).norm()) for p, p0 in zip(online, online0))
    moved_target = sum(float((t - t0_).norm()) for t, t0_ in zip(target, target0))
    gap = sum(float((t - p).norm()) for t, p in zip(target, online))
    assert moved_online > 0 and 0 < moved_target < moved_online and gap > 0, (
        moved_online, moved_target, gap)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    assert peak_mib < 1024, peak_mib
    graphs = trainer.venv._graphs
    # the vector step runs inside the learner's frame graph
    assert [kind for kind, *_ in graphs] == ["reset pool"], list(graphs)
    pool_g = next(iter(graphs.values()))
    step_g, learn_g = trainer._superstep.frame, trainer._superstep.learn
    assert step_g.graph is not None and learn_g.graph is not None
    print(f"  supersteps: {[(m.env_steps, m.loss_count, round(m.loss_sum / max(m.loss_count, 1), 5)) for m in metrics]}")
    print(f"  updates {updates}, launches {launches} (kernels in the trace of the second "
          f"superstep, profiled: {cfg.steps_per_superstep} vector steps + its reset pool, "
          f"{steady} updates; S1 none of its own, its body inside J1; {trace.lost} launches "
          f"lost), no plain call, {trace.host_launches / cfg.steps_per_superstep:.1f} "
          f"host launches per vector step, device busy "
          f"{100 * trace.device_us / trace.wall_us:.1f} %, episodes {metrics[-1].episodes}, peak "
          f"memory {peak_mib:.1f} MiB [{card}]")
    print(f"  graphs: reset pool warm-up {pool_g.warmup_s:.3f} s + capture {pool_g.capture_s:.3f} "
          f"s (in init, {init_s:.2f} s); frame (actor, vector step, replay write) eager call "
          f"{step_g.warmup_s:.3f} s + capture {step_g.capture_s:.3f} s, update eager call "
          f"{learn_g.warmup_s:.3f} s + capture {learn_g.capture_s:.3f} s (in superstep 1 and "
          f"2); supersteps of {cfg.steps_per_superstep} frames "
          f"{', '.join(f'{w:.3f}' for w in walls)} s (the second profiled) [{card}]")

    graphed_frames(torch, trainer, plain_launches, card)
    jointed_pairs(torch, trainer, cfg, workdir, td_kernels, sample_kernels, card)
    shutil.rmtree(workdir, ignore_errors=True)

    ev = trainer.evaluate(seed=0, max_steps=JOINTED_EVAL_FRAMES)
    assert ev.returns.shape == (128,) and all(math.isfinite(x) for x in ev.returns)
    assert (ev.lengths <= JOINTED_EVAL_FRAMES).all()
    print(f"  greedy eval over {JOINTED_EVAL_FRAMES} frames (graphed): mean "
          f"{float(ev.returns.mean()):.3f}")
    eval_pair(torch, "lunar_jointed_per", trainer._evaluate, trainer.eval_venv,
              trainer.env_params, trainer.runner.train.online, card, solver=True)
    return launches


def jointed_whole(torch, card):
    """Phase 7, P2g: ``lunar_jointed_per`` at JOINTED_CUTS from one seed,
    the graphed trainer against itself frame by frame (``max_graphs =
    0``): bitwise after each of JOINTED_WHOLE_SUPERSTEPS supersteps (the
    warm-up's end, the steady superstep frame by frame, its capture and a
    replay), then ``whole_vs_frames``: in the traced replay J1 once a
    vector step and once for the reset pool (S1 not on its own), K1/K2 once
    an update; the graph replayed alone."""
    import dataclasses

    from deep_q_learning_tpu_torch.config import lunar_jointed_per
    from deep_q_learning_tpu_torch.measure import learner_kernels
    from deep_q_learning_tpu_torch.train import Trainer

    cfg = dataclasses.replace(lunar_jointed_per(), **JOINTED_CUTS)
    fresh_peak(torch)
    whole, frames = (Trainer(cfg, device="cuda").init(seed=0) for _ in range(2))
    frames._superstep.max_graphs = 0
    lockstep(torch, "lunar_jointed_per", {"whole": Learner(whole), "frames": Learner(frames)},
             JOINTED_WHOLE_SUPERSTEPS)
    assert whole._superstep.runs == {"frames": 2, "whole": JOINTED_WHOLE_SUPERSTEPS - 2}, (
        whole._superstep.runs)
    out = whole_vs_frames(torch, "lunar_jointed_per", Learner(whole), Learner(frames),
                          cfg.steps_per_superstep, cfg.num_envs, card)
    j1, s1 = out["trace"].count(JOINTED_KERNEL), out["trace"].count(SOLVER_KERNEL)
    kernels = learner_kernels(out["trace"])
    f = cfg.steps_per_superstep
    assert j1 == f + 1 and s1 == 0 and kernels == {
        "td_loss_fwd": f, "td_loss_bwd": f, "per_slot_sample": 0}, (j1, s1, kernels)
    print(f"  lunar_jointed_per, P2g: in the traced replay J1 {j1} times ({f} vector steps and "
          f"the reset pool), S1 none of its own, K1/K2 {kernels['td_loss_fwd']} times [{card}]")
    superstep_replay_ms(torch, "lunar_jointed_per", out["graph"], card)


def population_whole(torch, card):
    """Phase 9, P2g: the lunar_per population of POP_MEMBERS at POP_CUTS,
    each member its own learning rate (the gates the config's, one pattern
    a steady superstep), graphed against itself frame by frame
    (``max_graphs = 0``) from one seed: bitwise after each of
    POP_WHOLE_SUPERSTEPS supersteps (the warm-up's end, the steady one
    frame by frame, its capture, a replay), then ``whole_vs_frames``: K1–K3
    once an update round in the traced replay; the graph replayed alone."""
    import dataclasses

    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.measure import learner_kernels
    from deep_q_learning_tpu_torch.parallel import build_population, set_population_hyper

    cfg = dataclasses.replace(lunar_per(), **POP_CUTS)
    fresh_peak(torch)
    learners = {}
    for name in ("whole", "frames"):
        init, step, _ = build_population(cfg, POP_MEMBERS, device="cuda")
        if name == "frames":
            step.max_graphs = 0
        runner = set_population_hyper(init(0), learning_rate=POP_HYPER["learning_rate"])
        learners[name] = Learner(runner=runner, step=step)
    lockstep(torch, "lunar_per population", learners, POP_WHOLE_SUPERSTEPS)
    whole = learners["whole"]
    assert whole.superstep.runs == {"frames": 2, "whole": POP_WHOLE_SUPERSTEPS - 2}, (
        whole.superstep.runs)
    label = f"lunar_per population of {POP_MEMBERS}"
    out = whole_vs_frames(torch, label, whole, learners["frames"], cfg.steps_per_superstep,
                          cfg.num_envs * POP_MEMBERS, card)
    kernels = learner_kernels(out["trace"])
    f = cfg.steps_per_superstep
    assert kernels == dict.fromkeys(("td_loss_fwd", "td_loss_bwd", "per_slot_sample"), f), kernels
    counts = whole.runner.train.opt_state.count
    assert counts == whole.runner.train.opt_state.device_count.tolist() and len(set(counts)) == 1
    print(f"  {label}, P2g: K1-K3 {kernels} in the traced replay ({f} update rounds of every "
          f"member), the members' Adam counts {counts[0]} [{card}]")
    superstep_replay_ms(torch, label, out["graph"], card)


def run_jointed_scaled(torch, td_kernels, sample_kernels, solver_kernels, jointed_kernels, card):
    """Phase 14: lunar_jointed_scaled(1024) at full width through the
    Trainer: 1,024 jointed landers at (120, 40), dueling (256, 256), PER
    (1024, 512), batch 1024, the three kernels once per update and no plain
    call, J1 once per vector step and reset pool on the device (S1 not on
    its own, no launch lost), the
    counters, a finite loss, the online net trained, peak memory under 1 GiB;
    env-steps/s of a superstep and the step graph's replay on the device."""
    import dataclasses

    from deep_q_learning_tpu_torch.config import lunar_jointed_scaled
    from deep_q_learning_tpu_torch.measure import learner_kernels, replay_ms
    from deep_q_learning_tpu_torch.train import Trainer

    cfg = dataclasses.replace(lunar_jointed_scaled(1024), **JOINTED_SCALED_CUTS)
    assert (cfg.num_envs, cfg.hidden, cfg.batch_size, cfg.dueling, cfg.steps_per_superstep) == (
        1024, (256, 256), 1024, True, 128), cfg
    assert (cfg.lander_engine, cfg.lander_vel_iters, cfg.lander_pos_iters) == ("jointed", 120, 40)
    assert cfg.use_pallas
    torch.cuda.synchronize()
    fresh_peak(torch)
    trainer = Trainer(cfg, device="cuda").init(seed=0)
    assert trainer.venv.graphed and trainer.runner.replay.priorities.shape == (1024, 512)
    online0 = [p.detach().clone() for p in trainer.runner.train.online.parameters()]
    for counts in (td_kernels, sample_kernels, solver_kernels, jointed_kernels):
        counts.reset_counts()
    metrics, walls = [], []

    def superstep():
        t0 = time.perf_counter()
        metrics.append(trainer.step())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    superstep()  # captures the frame's and the update's graphs
    superstep()  # the same cadence again: captures the superstep's graph
    superstep()  # timed, one replay
    trace, _ = traced_superstep(superstep, "phase 14")
    j1_events, s1_events = trace.count(JOINTED_KERNEL), trace.count(SOLVER_KERNEL)
    launches = learner_kernels(trace)
    plain = dict(td_kernels.plain_calls, **sample_kernels.plain_calls,
                 **solver_kernels.plain_calls, **jointed_kernels.plain_calls)
    updates = sum(m.loss_count for m in metrics)
    steady = metrics[-1].loss_count
    loss_sum = sum(m.loss_sum for m in metrics)
    vector_steps = len(metrics) * cfg.steps_per_superstep
    assert [m.env_steps for m in metrics] == [
        cfg.steps_per_superstep * (i + 1) for i in range(len(metrics))]
    assert trainer.runner.replay.total_adds == vector_steps
    assert updates > 0 and updates == trainer.runner.train.updates, updates
    assert steady == cfg.steps_per_superstep // cfg.train_every, steady
    assert launches == dict.fromkeys(("td_loss_fwd", "td_loss_bwd", "per_slot_sample"), steady), (
        launches, steady)
    assert not any(plain.values()), plain
    assert j1_events == cfg.steps_per_superstep + 1, j1_events
    assert s1_events == 0 and trace.lost == 0, (s1_events, trace.lost)
    assert math.isfinite(loss_sum), loss_sum
    moved = sum(float((p.detach() - p0).norm())
                for p, p0 in zip(trainer.runner.train.online.parameters(), online0))
    assert moved > 0, moved
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    assert peak_mib < 1024, peak_mib
    runs = trainer._superstep.runs
    assert runs == {"frames": 1, "whole": len(metrics) - 1}, runs
    per_step = trace.host_launches / cfg.steps_per_superstep
    assert trace.host_launches <= WHOLE_SUPERSTEP_LAUNCHES, (trace.launches, trace.copies)
    graph = steady_graph(Learner(trainer))
    rate = cfg.steps_per_superstep * cfg.num_envs / walls[2]
    print(f"  supersteps: {[(m.env_steps, m.loss_count, round(m.loss_sum / max(m.loss_count, 1), 5)) for m in metrics]}")
    print(f"  the superstep's graph (P2g; its cadence from the first superstep on): {graph.nodes} "
          f"nodes, captured in {graph.capture_s:.3f} s, instantiated in "
          f"{graph.instantiate_s:.3f} s; supersteps run as one replay / frame by frame "
          f"{runs['whole']} / {runs['frames']} [{card}]")
    print(f"  updates {updates}; the last superstep, profiled: K1-K3 {launches} on the device "
          f"({steady} updates), J1 {j1_events} times ({cfg.steps_per_superstep} vector steps + "
          f"its reset pool), S1 none of its own, no launch lost, no plain call, "
          f"{per_step:.3f} host launches per vector step, device "
          f"busy {100 * trace.device_us / trace.wall_us:.1f} %; episodes {metrics[-1].episodes}, "
          f"peak memory {peak_mib:.1f} MiB [{card}]")
    # last: a replay of the learner's graphs writes the runner again
    host_ms, device_ms, nodes = replay_ms(trainer._superstep.frame)
    learn_host, learn_device, learn_nodes = replay_ms(trainer._superstep.learn)
    superstep_replay_ms(torch, "lunar_jointed_scaled(1024)", graph, card)
    print(f"  lunar_jointed_scaled x{cfg.num_envs} envs, use_pallas_sampler: supersteps of "
          f"{cfg.steps_per_superstep} frames {', '.join(f'{w:.3f}' for w in walls)} s (frame "
          f"by frame, the superstep's capture, timed, profiled): {rate:.1f} env-steps/s in the "
          f"third, one replay; the frame graph's replay "
          f"(actor, vector step, replay write) {device_ms:.3f} ms on the device ({nodes} "
          f"kernels), its launch {host_ms:.3f} ms of host; the update's {learn_device:.3f} ms "
          f"({learn_nodes} kernels), its launch {learn_host:.3f} ms [{card}]")
    return dict(launches, lander_jointed_step=j1_events, assembly_step=s1_events)


def graphed_frames(torch, trainer, plain_launches, card):
    """Phase 7: JOINTED_FRAMES vector steps through a new graphed VectorEnv
    against the same steps through an eager one, from clones of the
    trainer's envs and generator: every output bitwise; the capture timed
    apart from the replays; the kernels of one graphed step (the replay's
    and the draws' the host launches) equal by name and count to those of
    one eager step (every launch matched to its kernel in the profiler's
    trace), J1 among them once, S1 not at all, and fewer in all than the
    plain solver alone launches (phase 3), so none of its kernels; J1 once
    in a replay of the reset pool."""
    from deep_q_learning_tpu_torch.envs import VectorEnv
    from deep_q_learning_tpu_torch.envs.graphed import tree_leaves, tree_map
    from deep_q_learning_tpu_torch.measure import replay_ms, traced_kernels

    r, n = trainer.runner, trainer.cfg.num_envs
    params = trainer.env_params
    venvs = {"graphed": VectorEnv(trainer.env, n),
             "eager": VectorEnv(trainer.env, n, graphed=False)}
    clone = lambda tree: tree_map(torch.clone, tree)  # noqa: E731
    runs = {}
    for name, venv in venvs.items():
        g = torch.Generator(device="cuda")
        g.set_state(r.generator.get_state())
        acts = torch.Generator(device="cuda").manual_seed(7)
        pool = venv.fresh_pool(g, params)
        kept = [clone(pool)]
        obs, states = clone(r.obs), clone(r.env_states)
        frame_s = []
        for _ in range(JOINTED_FRAMES):
            actions = torch.randint(0, 4, (n,), generator=acts, device="cuda", dtype=torch.int32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            obs, states, tr = venv.step(g, states, actions, params, prev_obs=obs, fresh=pool)
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
            kept.append(clone((obs, states, tr)))
        trace = traced_kernels(lambda: venv.step(
            g, states, actions, params, prev_obs=obs, fresh=pool))
        pool_trace = traced_kernels(lambda: venv.fresh_pool(g, params))
        pool_j1 = pool_trace.count(JOINTED_KERNEL)
        assert pool_j1 == 1 and pool_trace.count(SOLVER_KERNEL) == 0, (name, pool_j1)
        runs[name] = (kept, frame_s, trace, venv)
    (gk, gs, gt, gv), (ek, es, et, _) = runs["graphed"], runs["eager"]
    for i, (a, b) in enumerate(zip(tree_leaves(gk), tree_leaves(ek))):
        assert a.dtype == b.dtype and torch.equal(a, b), f"graphed vs eager, leaf {i}"
    done = sum(int((tr.terminated | tr.truncated).sum()) for _, _, tr in gk[1:])
    # the replay runs the eager step's kernels but the draws', which the host
    # launches on both paths: the same kernels by name and count
    g_kernels, g_launches = sum((gt.graphed + gt.launched).values()), gt.launches
    e_kernels, e_launches = sum(et.launched.values()), et.launches
    print(f"  replay vs eager: graphed {sum(gt.graphed.values())} kernels in the replay + "
          f"{sum(gt.launched.values())} of {g_launches} host launches, eager {e_kernels} of "
          f"{e_launches} host launches (kernels matched to their launches in the profiler's "
          f"trace)")
    assert gt.lost == et.lost == 0 and not et.graphed, (gt, et)
    assert gt.graphed + gt.launched == et.launched, (gt, et)
    assert g_kernels == e_launches and g_launches < 10, (g_kernels, e_launches, g_launches)
    g_j1, e_j1 = gt.count(JOINTED_KERNEL), et.count(JOINTED_KERNEL)
    assert g_j1 == e_j1 == 1 and g_kernels < plain_launches, (g_j1, e_j1, g_kernels)
    assert gt.count(SOLVER_KERNEL) == et.count(SOLVER_KERNEL) == 0, (gt, et)
    step_g = next(g for (kind, *_), g in gv._graphs.items() if kind == "step")
    frame_ms = 1e3 * sum(gs[1:]) / (len(gs) - 1)
    host_ms, device_ms, nodes = replay_ms(step_g)
    assert nodes == sum(gt.graphed.values()) and nodes < 2_000, (nodes, gt)
    print(f"  {JOINTED_FRAMES} graphed frames of {n} landers bitwise the eager frames "
          f"(pool, obs, states, transitions; {done} episodes ended): first call {gs[0]:.3f} s = "
          f"eager warm-up {step_g.warmup_s:.3f} s + capture {step_g.capture_s:.3f} s + replay; "
          f"later calls {frame_ms:.1f} ms a frame with draws, input copies and a sync, eager "
          f"{1e3 * sum(es) / len(es):.1f} ms; the replay alone {device_ms:.2f} ms on the device "
          f"(CUDA events, back to back), {nodes} kernels (with the plain solver: {PLAIN_STEP_REPLAY_KERNELS:,}), "
          f"its launch {host_ms:.2f} ms of host [{card}]")
    print(f"  kernels of one vector step with its draws: graphed {g_kernels} on the device "
          f"(with the plain solver: {PLAIN_STEP_REPLAY_KERNELS:,}), J1 once among them and S1 "
          f"not at all, from "
          f"{g_launches} host launches and one graph launch; eager {e_launches} host launches, "
          f"each kernel equal by name; the plain solver alone launches {plain_launches} "
          f"(phase 3), so none of its kernels ran; J1 once in a replay of the reset pool [{card}]")


def jointed_pairs(torch, trainer, cfg, workdir, td_kernels, sample_kernels, card):
    """Phase 7: the trainer against an eager one restored from its
    checkpoint: one superstep each from the same runner, bitwise equal (the
    learner and the env step), then env-steps/s of supersteps in three
    alternating pairs (graphed, eager, eager, graphed, graphed, eager), with
    the learner on every frame; K1/K2 once per update of the eager trainer
    by the wrappers' counters, which the graphed trainer's replays never
    pass."""
    from deep_q_learning_tpu_torch.train import Trainer

    trainer.save(step=trainer.runner.env_step * cfg.num_envs)
    eager = Trainer(cfg, device="cuda", workdir=workdir, graphed=False).restore()
    assert not eager.venv.graphed
    rates = {"graphed": [], "eager": []}
    sample_kernels.reset_counts()
    updates = eager_updates = 0
    eager_launches = dict.fromkeys(("td_loss_fwd", "td_loss_bwd"), 0)
    for i, name in enumerate(["graphed", "eager", "eager", "graphed", "graphed", "eager"]):
        t = trainer if name == "graphed" else eager
        td_kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = t.step()
        torch.cuda.synchronize()
        rates[name].append(cfg.steps_per_superstep * cfg.num_envs / (time.perf_counter() - t0))
        updates += m.loss_count
        if name == "eager":  # the graphed trainer's count its captures only
            eager_updates += m.loss_count
            for k in eager_launches:
                eager_launches[k] += td_kernels.launches[k]
        if i == 1:  # both from the same checkpoint, one superstep each
            same_tree(torch, runner_tree(trainer), runner_tree(eager))
    assert eager_launches == {"td_loss_fwd": eager_updates, "td_loss_bwd": eager_updates}, (
        eager_launches, eager_updates)
    assert not any(dict(td_kernels.plain_calls, **sample_kernels.plain_calls).values())
    print(f"  one superstep graphed and one eager from the same checkpoint: runners bitwise "
          f"equal (parameters, Adam moments and count, replay ring, priorities and counters, "
          f"env states)")
    print(f"  lunar_jointed_per x{cfg.num_envs} env-steps/s in turns, {cfg.steps_per_superstep} "
          f"frames a superstep, {updates} updates (K1/K2 once each, no plain call): graphed "
          f"{', '.join(f'{x:.1f}' for x in rates['graphed'])}; eager "
          f"{', '.join(f'{x:.1f}' for x in rates['eager'])} [{card}]")


def to_device(torch, obj, device):
    """A state dataclass (nested dataclasses, tensors, None) on ``device``."""
    import dataclasses

    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    return dataclasses.replace(obj, **{
        f.name: to_device(torch, getattr(obj, f.name), device) for f in dataclasses.fields(obj)
    })


def check_jointed_frame(torch, card):
    """Phase 7: one jointed frame on the card against the same frame on the
    CPU, from the same states, actions and dispersion draws."""
    from deep_q_learning_tpu_torch.config import lunar_jointed_per
    from deep_q_learning_tpu_torch.envs import make_env
    from deep_q_learning_tpu_torch.envs.heuristic import heuristic_action, touchdown_states

    cfg = lunar_jointed_per()
    env, params = make_env(cfg.env_id, cfg.time_fraction_obs, cfg.max_steps_in_episode,
                           param_overrides=cfg.env_param_overrides())
    assert params.jointed and (params.vel_iters, params.pos_iters) == (120, 40)
    g = torch.Generator().manual_seed(11)
    t0 = time.perf_counter()
    obs, st = touchdown_states(env, params, FRAME_ENVS, g, FRAME_FLIGHT)
    flight_s = time.perf_counter() - t0
    on_ground = st.leg1 | st.leg2
    assert on_ground.any() and (st.leg1 & st.leg2).any() and (~on_ground).any(), "coverage"
    random = torch.randint(0, 4, (FRAME_ENVS,), generator=g, dtype=torch.int32)
    actions = torch.where(torch.arange(FRAME_ENVS) % 2 == 0, heuristic_action(obs), random)
    draws = torch.rand((FRAME_ENVS, 2), generator=g) * 2.0 - 1.0
    cpu = env.step_env(None, st, actions, params, draws)
    gpu = env.step_env(None, to_device(torch, st, "cuda"), actions.cuda(), params, draws.cuda())
    torch.cuda.synchronize()
    gpu = [to_device(torch, x, "cpu") for x in gpu]

    c_st, g_st = cpu[1], gpu[1]
    fields = [("obs", cpu[0], gpu[0]), ("reward", cpu[2], gpu[2])]
    for name, kind in (("x", "position"), ("y", "position"), ("angle", "position"),
                       ("vx", "velocity"), ("vy", "velocity"), ("omega", "velocity")):
        fields.append((kind, getattr(c_st, name), getattr(g_st, name)))
    for leg in ("leg1_body", "leg2_body"):
        for name in ("cx", "cy", "a", "vx", "vy", "w"):
            kind = "position" if name in ("cx", "cy", "a") else "velocity"
            fields.append((kind, getattr(getattr(c_st, leg), name), getattr(getattr(g_st, leg), name)))
    for name in ("j1", "j2", "c1", "c2"):
        fields.append(("accumulator", getattr(c_st.solver_acc, name), getattr(g_st.solver_acc, name)))
    past_tight = torch.zeros(FRAME_ENVS, dtype=torch.bool)
    err = {}
    for kind, want, got in fields:
        tight, rtol, loose = FRAME_TOL[kind]
        gap = (got.double() - want.double()).abs().reshape(FRAME_ENVS, -1)
        err[kind] = max(err.get(kind, 0.0), float(gap.max()))
        assert float(gap.max()) <= loose, (kind, float(gap.max()), loose)
        past_tight |= (gap > tight + rtol * want.double().abs().reshape(FRAME_ENVS, -1)).any(1)
    assert float(past_tight.float().mean()) <= 1 - FRAME_TIGHT_SHARE, int(past_tight.sum())
    for name in ("leg1", "leg2", "wind_idx", "t"):
        assert torch.equal(getattr(c_st, name), getattr(g_st, name)), name
    for name in ("s1", "s2"):
        assert torch.equal(getattr(c_st.solver_acc, name), getattr(g_st.solver_acc, name)), name
    assert torch.equal(cpu[3], gpu[3]) and torch.equal(cpu[4], gpu[4]), "terminated, truncated"
    # the sleep counter follows the end-of-step speeds: a lane at a threshold may flip
    assert int((c_st.sleep != g_st.sleep).sum()) <= 1
    print(f"  one jointed frame of {FRAME_ENVS} landers ({int(on_ground.sum())} on the ground, "
          f"{int(cpu[3].sum())} finishing) after a {FRAME_FLIGHT}-frame flight on the CPU "
          f"({flight_s:.1f} s): card vs CPU largest gaps {err}, "
          f"{int(past_tight.sum())} lanes past the tight tolerances [{card}]")


def count_calls(obj, name: str, counts: dict) -> None:
    """Count the calls of ``obj.name`` in ``counts[name]``."""
    fn = getattr(obj, name)
    counts[name] = 0

    def counted(*args, **kwargs):
        counts[name] += 1
        return fn(*args, **kwargs)

    setattr(obj, name, counted)


LAUNCH_STEPS = 8  # the vector steps of the superstep whose launches are counted


def run_classic(torch, td_kernels, sample_kernels, preset, card):
    """Phase 8: one uniform-replay preset at full width through the Trainer,
    each frame as CUDA graph launches (``GraphedLearner``), superstep by
    superstep in turns with the eager learner (``graphed_learner=False``)
    from the same seed: metrics and runners bitwise equal after each, the
    counters exact, no TD or sampler kernel launched (``use_pallas=False``),
    the resets drawn as the env draws them (the classic envs' every frame,
    the lander's pool once a superstep), the host's launches per vector step
    of a steady superstep at most ``CLASSIC_HOST_LAUNCHES``; in the traced
    replay of the steady superstep the env's kernel once a vector step (a
    classic env's A1, C1 or M1; the lander's J1, and once for the pool)
    and no plain call of any env; a classic env's vector step alone one
    kernel in its CUDA graph; env-steps/s of both, and each graph's replay
    on the device.  Returns the trainer and the env kernel's launches in
    the traced superstep."""
    import dataclasses

    from deep_q_learning_tpu_torch.ops import classic_kernels, jointed_kernels, lander_kernels

    from deep_q_learning_tpu_torch.algos.superstep import GraphedLearner
    from deep_q_learning_tpu_torch.config import PRESETS
    from deep_q_learning_tpu_torch.measure import replay_ms
    from deep_q_learning_tpu_torch.train import Trainer

    supersteps, cuts = CLASSIC_RUNS[preset]
    cfg = dataclasses.replace(PRESETS[preset](), **cuts)
    assert cfg.replay == "uniform" and not cfg.use_pallas and not cfg.use_pallas_sampler
    fresh_peak(torch)
    trainer = Trainer(cfg, device="cuda").init(seed=0)
    frames = Trainer(cfg, device="cuda").init(seed=0)
    frames._superstep.max_graphs = 0
    eager = Trainer(cfg, device="cuda", graphed_learner=False).init(seed=0)
    assert isinstance(trainer._superstep, GraphedLearner) and trainer.venv.graphed
    assert not isinstance(eager._superstep, GraphedLearner) and eager.venv.graphed
    calls = {}
    count_calls(trainer.venv, "fresh_pool", calls)
    count_calls(trainer.env, "reset_draws", calls)
    online0 = [p.detach().clone() for p in trainer.runner.train.online.parameters()]
    torch.cuda.synchronize()

    env_modules = (classic_kernels, jointed_kernels, lander_kernels)
    for module in (td_kernels, sample_kernels, *env_modules):
        module.reset_counts()
    metrics, eager_metrics, rates = [], [], {"graphed": [], "eager": []}
    for i in range(supersteps):
        for name, t, out in (("graphed", trainer, metrics), ("eager", eager, eager_metrics)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append(t.step())
            torch.cuda.synchronize()
            rates[name].append(cfg.steps_per_superstep * cfg.num_envs / (time.perf_counter() - t0))
        assert metrics[-1] == eager_metrics[-1] == frames.step(), (preset, i)
        for other in (eager, frames):
            same_tree(torch, runner_tree(other), runner_tree(trainer), f"{preset} superstep {i + 1}")
    launches = dict(td_kernels.launches, **sample_kernels.launches)
    plain = dict(td_kernels.plain_calls, **sample_kernels.plain_calls)

    vector_steps = supersteps * cfg.steps_per_superstep
    assert [m.env_steps for m in metrics] == [
        cfg.steps_per_superstep * (i + 1) for i in range(supersteps)]
    r = trainer.runner
    assert r.replay.total_adds == int(r.replay.device_adds) == vector_steps
    assert r.replay.cursor == int(r.replay.device_cursor) == vector_steps % cfg.capacity_per_env
    first = -(-cfg.training_start // cfg.num_envs)  # the first vector step that trains
    updates = sum(m.loss_count for m in metrics)
    assert updates == (vector_steps - first + 1) * cfg.updates_per_step > 0, updates
    opt = r.train.opt_state
    assert updates == r.train.updates == opt.count == int(opt.device_count)
    assert not any(launches.values()) and not any(plain.values()), (launches, plain)
    assert all(math.isfinite(m.loss_sum) for m in metrics)
    assert metrics[-1].episodes > 0
    assert metrics[-1].episodes == sum(m.episodes_delta for m in metrics)
    # the last superstep the capture of the steady superstep's graph, which
    # draws inside it: its host calls made at the capture only
    assert trainer._superstep.runs == {"frames": supersteps - 1, "whole": 1}, (
        trainer._superstep.runs)
    if trainer.env.batch_reset_cheap:  # one reset draw a frame, before the frame's graph
        assert calls == {"fresh_pool": 0, "reset_draws": vector_steps}, calls
    else:  # the lander: one reset pool a superstep, the graph's inside it
        assert calls == {"fresh_pool": supersteps - 1, "reset_draws": supersteps}, calls
    online = [p.detach() for p in r.train.online.parameters()]
    assert sum(float((p - p0).norm()) for p, p0 in zip(online, online0)) > 0
    whole = whole_vs_frames(torch, preset, Learner(trainer), Learner(frames),
                            cfg.steps_per_superstep, cfg.num_envs, card)
    per_step = whole["per_step"]["frames"]
    assert per_step <= CLASSIC_HOST_LAUNCHES, (preset, per_step)
    # the env's kernel once a vector step in the traced replay (the lander's
    # once more, for the superstep's reset pool), and no env's plain call
    cheap = trainer.env.batch_reset_cheap
    env_kernel = (CLASSIC_KERNELS[trainer.env.kernel][0] if cheap
                  else JOINTED_KERNEL if cfg.lander_engine == "jointed" else RIGID_KERNEL)
    env_launches = whole["trace"].count(env_kernel)
    assert env_launches == cfg.steps_per_superstep + (0 if cheap else 1), (
        preset, env_kernel, env_launches)
    plain_env = [m.plain_calls for m in env_modules]
    assert not any(v for counts in plain_env for v in counts.values()), (preset, plain_env)
    if cheap:  # the vector step alone in its CUDA graph: one kernel, the env's
        from deep_q_learning_tpu_torch.measure import graphed_vector_step

        g = torch.Generator(device="cuda").manual_seed(5)
        _, st = trainer.env.reset_env(g, cfg.num_envs, trainer.env_params)
        _, nodes, kernels = graphed_vector_step(trainer.env, trainer.env_params, cfg.num_envs,
                                                g, st, card)
        assert nodes == 1 and kernels[f"{trainer.env.kernel}_step"] == 1, (nodes, kernels)
    print(f"  {preset}: in the traced replay of a steady superstep {env_kernel} "
          f"{env_launches} times ({cfg.steps_per_superstep} vector steps"
          f"{'' if cheap else ' and the reset pool'}), no plain call of any env [{card}]")
    print(f"  supersteps: {[(m.env_steps, m.loss_count, round(m.loss_sum / max(m.loss_count, 1), 5)) for m in metrics]}")
    print(f"  {preset} x{cfg.num_envs} envs: {vector_steps * cfg.num_envs} env steps a run, "
          f"{updates} updates, {metrics[-1].episodes} episodes, window "
          f"{metrics[-1].window_mean:.3f}; graphed learner and eager learner from one seed "
          f"bitwise equal after each of {supersteps} supersteps (runners and metrics), and the "
          f"graphed learner frame by frame; {per_step:.1f} host launches per vector step of a "
          f"steady superstep frame by frame (torch.profiler; at most {CLASSIC_HOST_LAUNCHES}), "
          f"{whole['per_step']['whole']:.3f} as one replay [{card}]")
    print(f"  {preset} env-steps/s by superstep in turns (the first graphed one with the "
          f"graphs' eager calls and captures): graphed "
          f"{', '.join(f'{x:.1f}' for x in rates['graphed'])}; eager learner "
          f"{', '.join(f'{x:.1f}' for x in rates['eager'])} [{card}]")
    frame, learn = trainer._superstep.frame, trainer._superstep.learn
    for name, g in (("frame", frame), ("update (graph L)", learn)):
        host_ms, device_ms, nodes = replay_ms(g)  # last: a replay writes the runner again
        print(f"  {preset}: the graph of the {name}: replay {device_ms:.3f} ms on the device, "
              f"{nodes} kernels, its launch {host_ms:.3f} ms of host; captured in "
              f"{g.capture_s:.3f} s after a {g.warmup_s:.3f} s eager call [{card}]")
    superstep_replay_ms(torch, preset, whole["graph"], card)
    return trainer, env_launches


def check_classic_step(torch, trainer, card):
    """Phase 8: one step of the trainer's env on the card (its kernel's step
    entry) against the same step on the CPU (the plain version), from the
    trainer's states and random actions."""
    env, params = trainer.env, trainer.env_params
    st = trainer.runner.env_states
    n = trainer.cfg.num_envs
    g = torch.Generator().manual_seed(5)
    actions = torch.randint(0, env.num_actions, (n,), generator=g, dtype=torch.int32)
    cpu = env.step_env(None, to_device(torch, st, "cpu"), actions, params)
    gpu = [to_device(torch, x, "cpu") for x in env.step_env(None, st, actions.cuda(), params)]
    tol = CLASSIC_TOL[trainer.cfg.env_id]
    import dataclasses

    gaps = {"obs": float((gpu[0] - cpu[0]).abs().max())}
    for f in dataclasses.fields(cpu[1]):
        want, got = getattr(cpu[1], f.name), getattr(gpu[1], f.name)
        if want.dtype == torch.int32:
            assert torch.equal(want, got), f.name
            continue
        if f.name.startswith("theta"):  # an angle next to ±pi may wrap either way
            want, got = torch.stack([want.cos(), want.sin()]), torch.stack([got.cos(), got.sin()])
        gaps[f.name] = float((got - want).abs().max())
    assert max(gaps.values()) <= tol, (gaps, tol)
    same = (gpu[3] == cpu[3]) & (gpu[4] == cpu[4])
    assert torch.equal(gpu[2][same], cpu[2][same]), "reward"
    flipped = int((~same).sum())
    assert flipped <= 1, flipped  # a lane at a threshold may flip
    print(f"  one vector step of {n} {trainer.cfg.env_id} envs card vs CPU: largest gaps {gaps} "
          f"(tolerance {tol}), {flipped} flags differ [{card}]")


def check_learner_vs_cpu(torch, td_kernels):
    """One learner update through the kernel on the card against the plain
    path on the CPU, from the same weights and batch (rtol 1e-4)."""
    from deep_q_learning_tpu_torch.algos import build_update_step, init_train_state, make_optimizer
    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.models import QNetwork
    from deep_q_learning_tpu_torch.replay.nstep import LearnBatch

    cfg = lunar_per()
    g = torch.Generator().manual_seed(7)
    b = cfg.batch_size
    batch = dict(
        obs=torch.randn((b, 9), generator=g), action=torch.randint(0, 4, (b,), generator=g, dtype=torch.int32),
        reward=torch.randn((b,), generator=g), next_obs=torch.randn((b, 9), generator=g),
        bootstrap=0.97 * (torch.rand((b,), generator=g) > 0.2).float(),
    )
    weights = torch.rand((b,), generator=g) + 0.1
    out = []
    for device in ("cpu", "cuda"):
        net = QNetwork(9, 4, hidden=cfg.hidden, generator=torch.Generator().manual_seed(0))
        opt = make_optimizer(cfg)
        ts = init_train_state(net.to(device), opt)
        lb = LearnBatch(**{k: v.to(device) for k, v in batch.items()})
        ts, loss, td = build_update_step(opt, cfg)(ts, lb, weights.to(device))
        out.append((loss.cpu(), td.cpu(), [p.detach().cpu() for p in ts.online.parameters()]))
    (lc, tdc, pc), (lg, tdg, pg) = out
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(tdg, tdc, rtol=1e-4, atol=1e-5)
    for a, c in zip(pg, pc):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-6)
    print("  learner update on the card vs the CPU plain path: ok")


def run_population(torch, td_kernels, sample_kernels, lander_kernels, card):
    """Phase 9: lunar_per, 8 members at full width, through PopulationTrainer,
    each frame as CUDA graph launches (``GraphedPopulation``): the counters,
    every member trained with a finite loss; in the third superstep,
    profiled, K1/K2/K3 once per update round and R1 once per vector step
    and reset pool (of all members' landers) on the device (a graph's
    replay passes no wrapper's counter: the wrappers count graph L's eager
    call and its capture only), the host's launches per vector step and
    the device's busy share; peak memory under 1 GiB; a greedy evaluation;
    then the eager population against it (:func:`population_pairs`), and
    each graph's replay.  Returns the kernels' launches in the profiled
    superstep."""
    import dataclasses

    import numpy as np

    from deep_q_learning_tpu_torch.algos.superstep import GraphedPopulation
    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.measure import learner_kernels, replay_ms
    from deep_q_learning_tpu_torch.parallel import PopulationTrainer

    cfg = dataclasses.replace(lunar_per(), **POP_CUTS)
    assert (cfg.num_envs, cfg.hidden, cfg.batch_size, cfg.dueling, cfg.capacity_per_env) == (
        128, (256, 256), 256, True, 4096), cfg
    assert cfg.use_pallas and cfg.replay == "prioritized" and cfg.train_every == 1
    m = POP_MEMBERS
    trainer = PopulationTrainer(cfg, m, eval_envs=POP_EVAL_ENVS, device="cuda")
    assert isinstance(trainer._step, GraphedPopulation)
    runner = trainer.init(seed=0)
    assert runner.replay.priorities.shape == (m * 128, 4096), runner.replay.priorities.shape
    assert runner.train.online.trunk[0].weight.shape == (m, 256, 9)
    online0 = [p.detach().clone() for p in runner.train.online.parameters()]
    torch.cuda.synchronize()
    fresh_peak(torch)

    td_kernels.reset_counts()
    sample_kernels.reset_counts()
    lander_kernels.reset_counts()
    metrics = [trainer.step(runner)[1]]  # each graph's eager call and capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics.append(trainer.step(runner)[1])  # the steady cadence, frame by frame
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    metrics.append(trainer.step(runner)[1])  # the steady cadence again: its graph's capture
    trace, _ = traced_superstep(lambda: metrics.append(trainer.step(runner)[1]), "phase 9")
    steady = cfg.steps_per_superstep
    launches = learner_kernels(trace)
    assert metrics[-1].loss_count.tolist() == [steady] * m, metrics[-1].loss_count
    assert launches == {"td_loss_fwd": steady, "td_loss_bwd": steady,
                        "per_slot_sample": steady}, (launches, steady)
    assert trainer._step.runs == {"frames": 2, "whole": len(metrics) - 2}, trainer._step.runs
    wrapped = dict(td_kernels.launches, **sample_kernels.launches)
    # graph L's eager call and capture, and the superstep graph's capture
    assert wrapped == dict.fromkeys(("td_loss_fwd", "td_loss_bwd", "per_slot_sample"),
                                    2 + steady), wrapped
    plain = dict(td_kernels.plain_calls, **sample_kernels.plain_calls, **lander_kernels.plain_calls)
    assert not any(plain.values()), plain
    launches["lander_rigid_step"] = trace.count(RIGID_KERNEL)
    assert launches["lander_rigid_step"] == steady + 1, launches
    per_step = trace.host_launches / steady
    assert trace.host_launches <= WHOLE_SUPERSTEP_LAUNCHES, (trace.launches, trace.copies)

    vector_steps = len(metrics) * steady
    rounds = vector_steps - cfg.training_start // cfg.num_envs + 1  # vector steps 16..128
    assert [mt.env_steps for mt in metrics] == [steady * (i + 1) for i in range(len(metrics))]
    assert runner.replay.total_adds == int(runner.replay.device_adds) == vector_steps
    counts = sum(mt.loss_count for mt in metrics)
    assert counts.tolist() == [rounds] * m, counts
    opt = runner.train.opt_state
    assert runner.train.updates == [rounds] * m == opt.count == opt.device_count.tolist()
    loss_sum = sum(mt.loss_sum for mt in metrics)
    assert np.isfinite(loss_sum).all(), loss_sum
    assert (metrics[-1].episodes == sum(mt.episodes_delta for mt in metrics)).all()
    assert (runner.replay.max_priority > 0).all()
    moved = [float((p.detach() - p0).flatten(1).norm(dim=1).min()) for p, p0 in
             zip(runner.train.online.parameters(), online0)]
    assert min(moved) > 0, moved  # every member's every layer trained
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    assert peak_mib < 1024, peak_mib
    env_steps = steady * cfg.num_envs * m

    ev = trainer.evaluate(runner, seed=0, max_steps=POP_EVAL_FRAMES)
    assert ev.returns.shape == (m, POP_EVAL_ENVS) and np.isfinite(ev.returns).all()
    eval_pair(torch, f"the {m}-member lunar_per population", trainer._evaluate,
              trainer.eval_venv, trainer._eval_env_params, runner.train.online, card, members=m)
    print(f"  supersteps: {[(mt.env_steps, mt.loss_count.tolist()) for mt in metrics]}")
    print(f"  {m} members: updates {runner.train.updates}, losses "
          f"{np.round(loss_sum / np.maximum(counts, 1), 5).tolist()}, episodes "
          f"{metrics[-1].episodes.tolist()}; greedy eval over {POP_EVAL_FRAMES} frames: means "
          f"{np.round(ev.returns.mean(axis=1), 2).tolist()}")
    print(f"  lunar_per population {m} x {cfg.num_envs} envs, graphed: the second superstep "
          f"{env_steps} env steps in {seconds:.3f} s = {env_steps / seconds:.1f} aggregate "
          f"env-steps/s; peak memory {peak_mib:.1f} MiB [{card}]")
    print(f"  the fourth superstep, profiled, one replay of its graph: {steady} update rounds, "
          f"K1/K2/K3 and R1 on the device {launches}, the wrappers {wrapped} (graph L's eager call "
          f"and capture, the superstep graph's capture), no plain call; {per_step:.3f} host "
          f"launches per vector step ({trace.launches} kernels, {len(trace.per_graph_launch)} "
          f"graphs, {trace.copies} copies and fills in {steady} vector steps; at most "
          f"{WHOLE_SUPERSTEP_LAUNCHES} a superstep), device busy "
          f"{100 * trace.device_us / trace.wall_us:.1f} % of {trace.wall_us / 1e3:.1f} ms "
          f"[{card}]")
    population_pairs(torch, trainer, runner, cfg, td_kernels, card)
    # last: a replay of the population's graphs writes the runner again
    step = trainer._step
    for name, g in (("frame (actor, env step, replay write)", step.frame),
                    ("update (graph L)", step.learn)):
        host_ms, device_ms, nodes = replay_ms(g)
        print(f"  the population's graph of the {name}: replay {device_ms:.3f} ms on the device "
              f"(CUDA events), {nodes} kernels, its launch {host_ms:.3f} ms of host; captured "
              f"in {g.capture_s:.3f} s after a {g.warmup_s:.3f} s eager call [{card}]")
    return launches


def population_pairs(torch, trainer, runner, cfg, td_kernels, card):
    """Phase 9: the eager population (the frame eager around the env step's
    graph) restored from the graphed one's checkpoint, both given mixed
    gates and learning rates (``POP_HYPER``; new learning-rate tensors, so
    the graphs start over with an eager call and a capture): runners and
    metrics bitwise equal after one superstep each, then env-steps/s in
    three alternating pairs; K1/K2 once per eager update round by the
    wrappers' counters, and once each for graph L's new eager call and
    capture; the eager population's launches per vector step and busy
    share from a profiled superstep."""
    import numpy as np

    from deep_q_learning_tpu_torch.algos.superstep import GraphedPopulation
    from deep_q_learning_tpu_torch.measure import traced_kernels
    from deep_q_learning_tpu_torch.parallel import PopulationTrainer, set_population_hyper
    from deep_q_learning_tpu_torch.utils import checkpoint as ckpt

    workdir = tempfile.mkdtemp(dir=REPO / "build")
    ckpt.save_checkpoint(workdir, runner, runner.env_step)
    eager = PopulationTrainer(cfg, trainer.num_members, eval_envs=1, device="cuda",
                              graphed_learner=False)
    assert not isinstance(eager._step, GraphedPopulation)
    eager_runner = ckpt.restore_checkpoint(workdir, eager.init(seed=1))
    shutil.rmtree(workdir, ignore_errors=True)
    same_tree(torch, ckpt._to_tree(runner), ckpt._to_tree(eager_runner), "restored")
    graphs = (trainer._step.frame.graph, trainer._step.learn.graph)
    for r in (runner, eager_runner):
        set_population_hyper(r, **POP_HYPER)
    rates = {"graphed": [], "eager": []}
    td_kernels.reset_counts()
    eager_rounds = 0
    frames = cfg.steps_per_superstep
    for i, name in enumerate(["graphed", "eager", "eager", "graphed", "graphed", "eager"]):
        t, r = (trainer, runner) if name == "graphed" else (eager, eager_runner)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, met = t.step(r)
        torch.cuda.synchronize()
        rates[name].append(frames * cfg.num_envs * trainer.num_members / (time.perf_counter() - t0))
        if name == "eager":  # member 0 trains every frame: one update round a frame
            assert met.loss_count[0] == frames, met.loss_count
            eager_rounds += frames
        if i == 0:
            graphed_metrics = met
        if i == 1:  # both from the same checkpoint and gates, one superstep each
            same_tree(torch, ckpt._to_tree(runner), ckpt._to_tree(eager_runner))
            for f in ("episodes", "loss_sum", "loss_count", "window_mean", "epsilon"):
                assert np.array_equal(getattr(met, f), getattr(graphed_metrics, f)), f
            gated = met.loss_count.tolist()
    assert len(set(gated)) > 1, gated  # the gates differ
    new = (trainer._step.frame.graph, trainer._step.learn.graph)
    assert all(g is not None and g is not old for g, old in zip(new, graphs)), "not re-captured"
    wrapped = eager_rounds + 2  # and graph L's new eager call and capture
    assert td_kernels.launches == {"td_loss_fwd": wrapped, "td_loss_bwd": wrapped}, (
        td_kernels.launches, eager_rounds)
    assert td_kernels.plain_calls == {"td_loss_fwd": 0, "td_loss_bwd": 0}
    trace = traced_kernels(lambda: eager.step(eager_runner))
    print(f"  graphed and eager population from the same checkpoint with mixed gates and "
          f"learning rates (updates "
          f"{gated} in the superstep): runners and metrics bitwise equal (parameters, Adam "
          f"moments and device counts, replay ring, priorities and counters, env states); the "
          f"graphs started over for the new hyperparameters (frame captured in "
          f"{trainer._step.frame.capture_s:.3f} s, graph L in {trainer._step.learn.capture_s:.3f} "
          f"s)")
    print(f"  lunar_per population {trainer.num_members} x {cfg.num_envs} aggregate env-steps/s in "
          f"turns, graphed {', '.join(f'{x:.1f}' for x in rates['graphed'])} (the first with the "
          f"graphs' eager calls and captures); eager "
          f"{', '.join(f'{x:.1f}' for x in rates['eager'])}; the eager population "
          f"{trace.host_launches / frames:.1f} host launches per vector step, device busy "
          f"{100 * trace.device_us / trace.wall_us:.1f} % (a profiled superstep) [{card}]")


def run_hpo_trials(torch, card):
    """Phase 9: the search's trials in process, as ``hpo --population 4``
    runs them (``HPO_ARGS``: 32,768 env steps a trial, episodes cut at 200
    frames): two trials of the same 4 candidates on one trainer, graphed
    then eager, with each trial's wall time, and the graphed population's
    eager calls and captures, made anew for each trial's runner."""
    import dataclasses

    import numpy as np

    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.parallel import PopulationTrainer, candidate_overrides

    cfg = dataclasses.replace(lunar_per(), max_steps_in_episode=200)
    steps = int(HPO_ARGS[HPO_ARGS.index("--steps-per-trial") + 1])
    overrides = candidate_overrides(POP_TRIALS)
    results = {}
    for graphed in (True, False):
        trainer = PopulationTrainer(cfg, len(POP_TRIALS), device="cuda", graphed_learner=graphed)
        walls, captures = [], []
        for seed in (0, 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = trainer.run(steps, hyper_overrides=overrides, seed=seed)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            assert np.isfinite(out["eval_mean"]).all(), out
            if graphed:
                captures.append(sum(g.warmup_s + g.capture_s
                                    for g in (trainer._step.frame, trainer._step.learn)))
        results[graphed] = out["eval_mean"]
        print(f"  {len(POP_TRIALS)}-member trials of {steps} env steps in process, "
              f"{'graphed' if graphed else 'eager'}: {', '.join(f'{w:.2f}' for w in walls)} s "
              f"of wall with the greedy evaluation"
              + (f"; the frame and graph L's eager calls and captures "
                 f"{', '.join(f'{c:.3f}' for c in captures)} s a trial" if graphed else "")
              + f" [{card}]")
    assert np.array_equal(results[True], results[False]), results


def check_population_update_vs_cpu(torch):
    """One population learner update (8 members, lunar_per's learner, the
    fused TD loss, a closed gate on member 5) on the card against the plain
    path on the CPU, from the same weights and batch: rtol 1e-4, each
    member's parameters atol a tenth of its learning rate (Adam's first
    step moves an element by lr · g / (|g| + 1e-8), which for |g| near 1e-8
    depends on the gradient's last bits, and the card sums in another
    order)."""
    from deep_q_learning_tpu_torch.algos import build_update_step, init_train_state, make_optimizer
    from deep_q_learning_tpu_torch.algos.dqn import MemberHyperParams
    from deep_q_learning_tpu_torch.config import lunar_per
    from deep_q_learning_tpu_torch.models import MemberQNetwork
    from deep_q_learning_tpu_torch.replay.nstep import LearnBatch

    cfg = lunar_per()
    m, b = POP_MEMBERS, cfg.batch_size
    g = torch.Generator().manual_seed(8)
    batch = dict(
        obs=torch.randn((m, b, 9), generator=g),
        action=torch.randint(0, 4, (m, b), generator=g, dtype=torch.int32),
        reward=torch.randn((m, b), generator=g), next_obs=torch.randn((m, b, 9), generator=g),
        bootstrap=0.97 * (torch.rand((m, b), generator=g) > 0.2).float(),
    )
    weights = torch.rand((m, b), generator=g) + 0.1
    mask = [k != 5 for k in range(m)]
    out = []
    for device in ("cpu", "cuda"):
        net = MemberQNetwork(m, 9, 4, hidden=cfg.hidden, generators=[
            torch.Generator().manual_seed(k) for k in range(m)])
        opt = make_optimizer(cfg)
        ts = init_train_state(net.to(device), opt)
        hyper = MemberHyperParams.from_config(cfg, m, device)
        hyper.learning_rate = torch.linspace(1e-4, 1e-3, m, device=device)
        lb = LearnBatch(**{k: v.to(device) for k, v in batch.items()})
        ts, loss, td = build_update_step(opt, cfg)(ts, lb, weights.to(device), hyper, mask)
        assert ts.opt_state.device_count.tolist() == ts.opt_state.count, device
        out.append((loss.cpu(), td.cpu(), [p.detach().cpu() for p in ts.online.parameters()],
                    [p.detach().cpu() for p in ts.target.parameters()], ts.opt_state.count))
    (lc, tdc, pc, tc, cc), (lg, tdg, pg, tg, cg) = out
    assert cc == cg == [int(k) for k in mask]
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(tdg, tdc, rtol=1e-4, atol=1e-5)
    lrs = torch.linspace(1e-4, 1e-3, m).tolist()
    for a, c in zip(pg + tg, pc + tc):
        for k, lr in enumerate(lrs):
            torch.testing.assert_close(a[k], c[k], rtol=1e-4, atol=lr / 10)
    init = MemberQNetwork(m, 9, 4, hidden=cfg.hidden, generators=[
        torch.Generator().manual_seed(k) for k in range(m)])
    assert all(torch.equal(p[5], q[5]) for p, q in zip(pg, init.parameters())), "closed gate moved"
    print(f"  population learner update ({m} members, member 5's gate closed) on the card vs the "
          f"CPU plain path: ok")


def run_hpo_cli(card):
    """Phase 9: ``python -m deep_q_learning_tpu_torch hpo --population 4`` on
    the card: 8 trials in two rounds, a history line each and the result."""
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        history = Path(tmp) / "hpo.jsonl"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "deep_q_learning_tpu_torch", "hpo", *HPO_ARGS,
             "--history-out", str(history), "--quiet"],
            cwd=REPO, capture_output=True, text=True, timeout=400,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"CLI hpo exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        lines = [json.loads(line) for line in open(history)]
    assert len(lines) == 8, lines
    assert all(math.isfinite(rec["objective"]) for rec in lines), lines
    assert set(result) == {"best_objective", "best_params"}, result
    assert result["best_objective"] == max(rec["objective"] for rec in lines), result
    print(f"  CLI hpo {' '.join(HPO_ARGS)}: {len(lines)} trials, objectives "
          f"{[round(rec['objective'], 2) for rec in lines]}, best {result['best_objective']:.2f} "
          f"({time.perf_counter() - t0:.1f} s with start-up) [{card}]")

# phase 10: runs over ranks and rollouts.  (a) and (b) run lunar_per at full
# width (128 landers, dueling (256, 256), PER (128, 4096), batch 256) with the
# PER slot kernel, cut in depth only: supersteps of 32 vector steps, learning
# from 2048 stored transitions (vector step 16), so vector steps 16..64 of two
# supersteps train
DIST_SETS = ["use_pallas_sampler=true", "steps_per_superstep=32", "training_start=2048"]
DIST_SUPERSTEPS = 2
DIST_ROUNDS = DIST_SUPERSTEPS * 32 - 2048 // 128 + 1
DIST_RANKS = 2  # (b): two gloo ranks that share the one card
# (b): a third superstep, so that each kind has two without captures
GLOO_SUPERSTEPS = DIST_SUPERSTEPS + 1
GLOO_ROUNDS = GLOO_SUPERSTEPS * 32 - 2048 // 128 + 1
RANK_HOST_LAUNCHES = 40  # at most, a vector step of a steady graphed rank (as phase 4)
# (c) multihost_ddqn at full width (8192 rigid landers, uniform replay 2^19);
# its training_start of 20,000 transitions opens at vector step 3
MULTIHOST_CUTS = dict(steps_per_superstep=16)
MULTIHOST_SUPERSTEPS = 2
ROLLOUTS = 2
# runs `python -m deep_q_learning_tpu_torch` in a process of its own and then
# prints that process's kernel launches and plain calls
CLI_COUNTS = (
    "import json, sys\n"
    "from deep_q_learning_tpu_torch.__main__ import main\n"
    "from deep_q_learning_tpu_torch.ops import sample_kernels, td_kernels\n"
    "rc = main(sys.argv[1:])\n"
    "print(json.dumps({'launches': {**td_kernels.launches, **sample_kernels.launches},\n"
    "                  'plain': {**td_kernels.plain_calls, **sample_kernels.plain_calls}}))\n"
    "sys.exit(rc)\n"
)


def dist_config():
    from deep_q_learning_tpu_torch.__main__ import build_config

    return build_config("lunar_per", DIST_SETS)


def learner_digest(train) -> str:
    """sha256 of the online and target weights, Adam's moments and count."""
    import hashlib

    h = hashlib.sha256()
    for t in [*train.online.parameters(), *train.target.parameters(), *train.opt_state.mu,
              *train.opt_state.nu]:
        h.update(t.detach().cpu().numpy().tobytes())
    h.update(str(train.opt_state.count).encode())
    return h.hexdigest()


def profile_steady(torch, trainer, steps):
    """The host's launches per vector step (kernels, CUDA graphs, copies and
    fills), the device's busy share of the wall and the host time of the
    ``grad_all_reduce`` span per update, from torch.profiler over one
    steady superstep of ``steps`` vector steps (after two to warm: the
    frame by frame graphs' eager calls and captures, then a single
    learner's capture of the superstep's graph)."""
    from deep_q_learning_tpu_torch.measure import host_launches

    for _ in range(2):
        trainer.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        m = trainer.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                  for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.key != "grad_all_reduce")
    launches = sum(host_launches(events).values())
    span = [e for e in events if e.key == "grad_all_reduce" and
            e.device_type == torch.autograd.DeviceType.CPU]
    span_us = span[0].cpu_time_total / max(m.loss_count, 1) if span else 0.0
    return {"launches_per_step": launches / steps, "busy": busy_us / 1e6 / wall,
            "all_reduce_us_per_update": span_us, "wall_per_update_us": wall * 1e6 / max(m.loss_count, 1),
            "updates": m.loss_count}


def all_reduce_us(torch, trainer, calls=200):
    """Host µs per call of a rank's gradient all-reduce (the collective
    between graphs L1 and L2: ``UpdateStep.all_reduce`` of the flat buffer
    of the learner's gradients and loss), the card synchronised once after
    ``calls`` calls: every rank calls it as often."""
    update = trainer._superstep.work.update
    train = trainer.runner.train
    for _ in range(10):
        update.all_reduce(train)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        update.all_reduce(train)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def rank_steady(torch, trainer, attempts, lockstep=False):
    """A steady superstep of LAUNCH_STEPS vector steps, each with an
    update, after two that make each graph's eager call and capture (a
    single learner's second captures its superstep's graph): supersteps
    traced (``measure.traced_kernels``) until one whose trace
    lost no record, at most ``attempts``; with ``lockstep`` (ranks of more
    than one process) every rank traces all ``attempts``, so that all take
    as many supersteps, and keeps the first clean one.  Returns the host's
    launches per vector step, K1–K3 on the device, this rank's updates in
    it, and the device's busy share."""
    from deep_q_learning_tpu_torch.measure import learner_kernels, traced_kernels

    for _ in range(2):
        trainer.step()
    kept = None
    for _ in range(attempts):
        before = trainer.runner.train.updates
        trace = traced_kernels(trainer.step)
        clean = not trace.lost and not trace.per_graph_launch.count(0)
        if kept is None and clean:
            kept = trace, trainer.runner.train.updates - before
        if kept is not None and not lockstep:
            break
    if kept is None:
        raise RuntimeError(f"the profiler lost records in {attempts} traced supersteps")
    trace, updates = kept
    return {"launches_per_step": trace.host_launches / LAUNCH_STEPS,
            "kernels": learner_kernels(trace), "updates": updates,
            "graphs": len(trace.per_graph_launch), "busy": trace.device_us / trace.wall_us}


def steady_text(s) -> str:
    return (f"{s['launches_per_step']:.1f} host launches per vector step ({s['graphs']} graph "
            f"launches in {LAUNCH_STEPS} vector steps), K1-K3 on the device {s['kernels']} for "
            f"{s['updates']} updates, device busy {100 * s['busy']:.1f} % of the wall")


def gloo_lunar_rank(shard, n, port):
    """Phase 10 (b): one of two gloo ranks that share the card, on lunar_per
    split in two (64 landers and a batch of 128 a rank): the graphed rank
    and the eager rank from one seed, superstep by superstep in turns, the
    learner's digest after each; then a steady graphed superstep traced."""
    import dataclasses

    import torch

    from deep_q_learning_tpu_torch.algos.superstep import GraphedLearner
    from deep_q_learning_tpu_torch.ops import sample_kernels, td_kernels
    from deep_q_learning_tpu_torch.parallel import distributed_init
    from deep_q_learning_tpu_torch.train import DistributedTrainer

    distributed_init(f"localhost:{port}", n, shard, backend="gloo", device="cuda")
    cfg = dist_config()
    ranks = {"graphed": DistributedTrainer(cfg, device="cuda").init(seed=0),
             "eager": DistributedTrainer(cfg, device="cuda", graphed_learner=False).init(seed=0)}
    assert isinstance(ranks["graphed"]._superstep, GraphedLearner)
    assert not isinstance(ranks["eager"]._superstep, GraphedLearner)
    assert ranks["graphed"].device == torch.device("cuda", 0), ranks["graphed"].device
    # each rank's replay holds buffer_capacity transitions over its own envs,
    # as a JAX shard's does: (64, 2^19 / 64) rows of priorities
    shape = ranks["graphed"].runner.replay.priorities.shape
    assert shape == RANK_SLOT[:2], shape
    torch.cuda.synchronize()
    fresh_peak(torch)
    out = {kind: {"metrics": [], "digests": [], "seconds": [],
                  "launches": dict.fromkeys(("td_loss_fwd", "td_loss_bwd", "per_slot_sample"), 0),
                  "plain": dict.fromkeys(("td_loss_fwd", "td_loss_bwd", "per_slot_sample"), 0)}
           for kind in ranks}
    for i in range(GLOO_SUPERSTEPS):
        for kind in (("graphed", "eager") if i % 2 == 0 else ("eager", "graphed")):
            tr, rec = ranks[kind], out[kind]
            td_kernels.reset_counts()
            sample_kernels.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.step()
            torch.cuda.synchronize()
            rec["seconds"].append(time.perf_counter() - t0)
            rec["metrics"].append(dataclasses.asdict(m))
            rec["digests"].append(learner_digest(tr.runner.train))
            for counts, into in ((dict(td_kernels.launches, **sample_kernels.launches), "launches"),
                                 (dict(td_kernels.plain_calls, **sample_kernels.plain_calls),
                                  "plain")):
                for k, v in counts.items():
                    rec[into][k] += v
    for kind, tr in ranks.items():
        out[kind]["updates"] = tr.runner.train.updates
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["all_reduce_us"] = all_reduce_us(torch, ranks["graphed"])
    short = dataclasses.replace(cfg, steps_per_superstep=LAUNCH_STEPS, training_start=0)
    out["steady"] = rank_steady(torch, DistributedTrainer(short, device="cuda").init(seed=1),
                                TRACE_ATTEMPTS, lockstep=True)
    return out


def run_cli_counts(*args):
    """``python -m deep_q_learning_tpu_torch`` in a process of its own: its
    JSON summary and its kernel launches and plain calls."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CLI_COUNTS, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=400)
    if proc.returncode != 0:
        raise RuntimeError(f"CLI {args[0]} exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    lines = proc.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1]), lines[:-2], time.perf_counter() - t0


def run_distributed(torch, td_kernels, sample_kernels, card, cli_workdir):
    """Phase 10: (a) world size 1 on NCCL, in this process and through the
    command line; (b) two gloo ranks sharing the card; (c) multihost_ddqn at
    full width; (d) dryrun_multichip(2); (e) eval --rollout-dir on phase 6's
    checkpoint.  Every rank runs graphed (``GraphedLearner``: graph L1, the
    all-reduce, graph L2), in turns with the eager rank where timed.  A
    kernel in a graph passes its wrapper's counter at the graph's eager
    call and capture only: the wrappers count 2 a kernel, and K1–K3 are
    counted on the device in the profiler's trace of a steady superstep.
    Returns (b)'s rank-0 kernels in that trace."""
    import dataclasses

    import torch.distributed as dist

    from deep_q_learning_tpu_torch.algos.superstep import GraphedLearner
    from deep_q_learning_tpu_torch.config import multihost_ddqn
    from deep_q_learning_tpu_torch.measure import replay_ms
    from deep_q_learning_tpu_torch.parallel import distributed_init, dryrun_multichip, spawn_ranks
    from deep_q_learning_tpu_torch.train import DistributedTrainer, Trainer

    cfg = dist_config()
    zero = {"td_loss_fwd": 0, "td_loss_bwd": 0, "per_slot_sample": 0}
    captured = dict.fromkeys(zero, 2)  # a graph's eager call and its capture

    # (a) in this process: world size 1 on NCCL, graphed, against graphed Trainer
    t_a = time.perf_counter()
    distributed_init(device="cuda")
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    single = Trainer(cfg, device="cuda").init(seed=0)
    ranked = DistributedTrainer(cfg, device="cuda").init(seed=0)
    assert isinstance(ranked._superstep, GraphedLearner) and ranked._superstep.group is not None
    torch.cuda.synchronize()
    fresh_peak(torch)
    td_kernels.reset_counts()
    sample_kernels.reset_counts()
    metrics = []
    for i in range(DIST_SUPERSTEPS):
        m_single, m_ranked = single.step(), ranked.step()
        assert m_single == m_ranked, (i, m_single, m_ranked)
        same_tree(torch, runner_tree(single), runner_tree(ranked), f"superstep {i}")
        metrics.append(m_ranked)
    launches = dict(td_kernels.launches, **sample_kernels.launches)
    plain = dict(td_kernels.plain_calls, **sample_kernels.plain_calls)
    env_steps = metrics[-1].env_steps * cfg.num_envs
    assert env_steps == DIST_SUPERSTEPS * cfg.steps_per_superstep * cfg.num_envs
    assert sum(m.loss_count for m in metrics) == ranked.runner.train.updates == DIST_ROUNDS
    # the single learner's graph L and the rank's graph L1 each: 2 + 2
    assert launches == {k: 2 * v for k, v in captured.items()} and plain == zero, (launches, plain)
    peak_a = torch.cuda.max_memory_allocated() / 2**20
    reduce_a = all_reduce_us(torch, ranked)
    eval_pair(torch, "DistributedTrainer's lunar_per (world 1)", ranked._evaluate,
              ranked.eval_venv, ranked.env_params, ranked.runner.train.online, card)
    # a replay of an in-place graph applies its work again: the rank is not used after
    step = ranked._superstep
    for name, g in (("frame", step.frame), ("update's local gradients (graph L1)", step.learn),
                    ("update's step on the mean (graph L2)", step.learn_mean)):
        host_ms, device_ms, nodes = replay_ms(g)
        print(f"  (a) the rank's graph of the {name}: replay {device_ms:.3f} ms on the device "
              f"(CUDA events), {nodes} kernels, its launch {host_ms:.3f} ms of host; captured in "
              f"{g.capture_s:.3f} s after a {g.warmup_s:.3f} s eager call [{card}]")
    print(f"  (a) world size 1 on NCCL, graphed: {DIST_SUPERSTEPS} supersteps of "
          f"{cfg.steps_per_superstep} vector steps ({DIST_ROUNDS} updates) bitwise graphed "
          f"Trainer's after each (metrics and the whole runner); each wrapper counted {launches} "
          f"(the two learners' graphs' eager calls and captures), no plain call; peak memory "
          f"{peak_a:.1f} MiB; the all-reduce alone {reduce_a:.1f} us a call [{card}]")
    # env-steps/s of Trainer and of the rank, graphed and eager, on the same cut, in turns
    turns = []
    for kind, graphed in ((Trainer, True), (DistributedTrainer, True), (DistributedTrainer, False),
                          (DistributedTrainer, False), (DistributedTrainer, True), (Trainer, True)):
        t = kind(cfg, device="cuda", graphed_learner=graphed).init(seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DIST_SUPERSTEPS):
            t.step()
        torch.cuda.synchronize()
        name = "Trainer" if kind is Trainer else f"rank {'graphed' if graphed else 'eager'}"
        turns.append((name, DIST_SUPERSTEPS * cfg.steps_per_superstep * cfg.num_envs
                      / (time.perf_counter() - t0)))
    print(f"  (a) env-steps/s in turns on the same cut ({DIST_SUPERSTEPS} supersteps each, the "
          f"graphs' eager calls and captures included): "
          f"{', '.join(f'{name} {rate:.1f}' for name, rate in turns)} [{card}]")
    short = dataclasses.replace(cfg, steps_per_superstep=LAUNCH_STEPS, training_start=0)
    steady_single = rank_steady(torch, Trainer(short, device="cuda").init(seed=1), TRACE_ATTEMPTS)
    steady_a = rank_steady(torch, DistributedTrainer(short, device="cuda").init(seed=1),
                           TRACE_ATTEMPTS)
    steady_eager = rank_steady(torch, DistributedTrainer(short, device="cuda",
                                                         graphed_learner=False).init(seed=1),
                               TRACE_ATTEMPTS)
    for s in (steady_single, steady_a, steady_eager):
        assert s["updates"] == LAUNCH_STEPS, s
        assert s["kernels"] == dict.fromkeys(zero, LAUNCH_STEPS), s
    assert steady_a["launches_per_step"] <= RANK_HOST_LAUNCHES, steady_a
    print(f"  (a) steady {LAUNCH_STEPS}-step supersteps on the same cut, traced: Trainer "
          f"{steady_text(steady_single)}; the graphed rank {steady_text(steady_a)} (at most "
          f"{RANK_HOST_LAUNCHES}); the eager rank {steady_text(steady_eager)} [{card}]")

    # (a) through the command line: train with checkpoints, then resume
    common = ["--preset", "lunar_per", "--distributed", "--quiet", "--log-every", "1"]
    for item in DIST_SETS:
        common += ["--set", item]
    per_superstep = cfg.steps_per_superstep * cfg.num_envs
    with tempfile.TemporaryDirectory(dir=REPO / "build") as wd:
        first, counts, _, took = run_cli_counts(
            "train", *common, "--workdir", wd, "--checkpoint-every", "1",
            "--max-env-steps", str(DIST_SUPERSTEPS * per_superstep))
        assert first["env_steps"] == env_steps and first["updates"] == DIST_ROUNDS, first
        assert first["world_size"] == 1, first
        assert counts == {"launches": captured, "plain": zero}, counts
        assert sorted(p.name for p in Path(wd).iterdir()) == [
            str(per_superstep), str(2 * per_superstep), "config.json"]
        print(f"  (a) CLI train --distributed: {first}, kernels {counts['launches']} (graph "
              f"L1's eager call and capture) ({took:.1f} s with start-up)")
        resumed, counts, _, took = run_cli_counts(
            "train", *common, "--workdir", wd, "--resume",
            "--max-env-steps", str((DIST_SUPERSTEPS + 1) * per_superstep))
        more = cfg.steps_per_superstep
        assert resumed["env_steps"] == env_steps + per_superstep, resumed
        assert resumed["updates"] == DIST_ROUNDS + more, resumed
        assert counts == {"launches": captured, "plain": zero}, counts
        print(f"  (a) CLI train --distributed --resume: {resumed}, kernels {counts['launches']} "
              f"({took:.1f} s with start-up)")
    print(f"  (a) took {time.perf_counter() - t_a:.1f} s")

    # (b) two gloo ranks on cuda:0, CUDA tensors, graphed and eager in turns
    t_b = time.perf_counter()
    ranks = spawn_ranks(gloo_lunar_rank, DIST_RANKS, timeout_s=300)
    for r in ranks:
        for kind in ("graphed", "eager"):
            rec = r[kind]
            assert rec["updates"] == GLOO_ROUNDS, (kind, rec["updates"])
            assert rec["plain"] == zero, (kind, rec["plain"])
            assert rec["metrics"] == ranks[0]["graphed"]["metrics"], kind
            assert rec["digests"] == ranks[0]["graphed"]["digests"], f"{kind} differs"
        assert r["graphed"]["launches"] == captured, r["graphed"]["launches"]
        assert r["eager"]["launches"] == dict.fromkeys(zero, GLOO_ROUNDS), r["eager"]["launches"]
        assert r["steady"]["updates"] == LAUNCH_STEPS, r["steady"]
        assert r["steady"]["kernels"] == dict.fromkeys(zero, LAUNCH_STEPS), r["steady"]
        assert r["steady"]["launches_per_step"] <= RANK_HOST_LAUNCHES, r["steady"]
    assert [m["env_steps"] for m in ranks[0]["graphed"]["metrics"][:DIST_SUPERSTEPS]] == [
        m.env_steps for m in metrics]
    assert [m["loss_count"] for m in ranks[0]["graphed"]["metrics"][:DIST_SUPERSTEPS]] == [
        DIST_RANKS * m.loss_count for m in metrics]
    rates = {kind: [round(cfg.steps_per_superstep * cfg.num_envs / max(
        r[kind]["seconds"][i] for r in ranks), 1) for i in range(GLOO_SUPERSTEPS)]
        for kind in ("graphed", "eager")}
    print(f"  (b) {DIST_RANKS} gloo ranks sharing the card, 64 landers and batch 128 a rank, "
          f"graphed and eager in turns from one seed: learners bitwise equal after every "
          f"superstep on both ranks ({GLOO_ROUNDS} update rounds); env-steps/s a superstep "
          f"(the slower rank's wall) graphed {rates['graphed']} (the first with the graphs' "
          f"eager calls and captures), eager {rates['eager']}; the graphed wrappers "
          f"{ranks[0]['graphed']['launches']}, the eager {ranks[0]['eager']['launches']}; peak "
          f"memory {[round(r['peak_mib'], 1) for r in ranks]} MiB; the all-reduce alone "
          f"{[round(r['all_reduce_us'], 1) for r in ranks]} us a call "
          f"({time.perf_counter() - t_b:.1f} s) [{card}]")
    print(f"  (b) rank 0's steady graphed superstep, traced: {steady_text(ranks[0]['steady'])}; "
          f"rank 1's {steady_text(ranks[1]['steady'])} (at most {RANK_HOST_LAUNCHES}) [{card}]")

    # (c) multihost_ddqn at full width, world size 1, graphed
    t_c = time.perf_counter()
    mh = dataclasses.replace(multihost_ddqn(), **MULTIHOST_CUTS)
    assert (mh.num_envs, mh.buffer_capacity, mh.hidden, mh.batch_size, mh.replay) == (
        8192, 1 << 19, (256, 256), 256, "uniform"), mh
    trainer = DistributedTrainer(mh, device="cuda").init(seed=0)
    assert isinstance(trainer._superstep, GraphedLearner)
    torch.cuda.synchronize()
    fresh_peak(torch)
    td_kernels.reset_counts()
    sample_kernels.reset_counts()
    t0 = time.perf_counter()
    metrics_c = [trainer.step() for _ in range(MULTIHOST_SUPERSTEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    steps_c = MULTIHOST_SUPERSTEPS * mh.steps_per_superstep
    rounds_c = steps_c - (-(-mh.training_start // mh.num_envs)) + 1
    assert metrics_c[-1].env_steps == steps_c
    assert sum(m.loss_count for m in metrics_c) == trainer.runner.train.updates == rounds_c
    assert dict(td_kernels.launches, **sample_kernels.launches) == zero  # use_pallas is off
    assert math.isfinite(sum(m.loss_sum for m in metrics_c))
    peak_c = torch.cuda.max_memory_allocated() / 2**20
    steady_c = rank_steady(torch, DistributedTrainer(dataclasses.replace(
        mh, steps_per_superstep=LAUNCH_STEPS, training_start=0), device="cuda").init(seed=1),
        TRACE_ATTEMPTS)
    assert steady_c["launches_per_step"] <= RANK_HOST_LAUNCHES, steady_c
    print(f"  (c) multihost_ddqn x{mh.num_envs}, world size 1 (NCCL), graphed: "
          f"{steps_c * mh.num_envs} env steps in {seconds:.3f} s = "
          f"{steps_c * mh.num_envs / seconds:.1f} env-steps/s (the graphs' eager calls and "
          f"captures included), {rounds_c} updates (the plain TD loss), peak memory "
          f"{peak_c:.1f} MiB; steady superstep: {steady_c['launches_per_step']:.1f} host "
          f"launches per vector step, device busy {100 * steady_c['busy']:.1f} % of the wall "
          f"({time.perf_counter() - t_c:.1f} s) [{card}]")
    dist.destroy_process_group()

    # (d) the flagship structure over two gloo ranks on the card
    t_d = time.perf_counter()
    reports = dryrun_multichip(DIST_RANKS, device="cuda")
    for r in reports:
        assert r["backend"] == "gloo" and r["device"] == "cuda:0" and r["graphed"], r
        assert r["launches"] == captured and r["updates"] > 2, r
        assert r["plain_calls"] == zero, r
    print(f"  (d) dryrun_multichip({DIST_RANKS}), graphed: {reports[0]['metrics']}, "
          f"{reports[0]['updates']} updates, each rank's wrappers {reports[0]['launches']}, "
          f"learners bitwise equal ({time.perf_counter() - t_d:.1f} s)")

    # (e) greedy rollouts of phase 6's checkpoint
    t_e = time.perf_counter()
    rollout_dir = Path(cli_workdir) / "rollouts"
    args = ["eval", "--preset", "lunar_per_scaled", "--workdir", cli_workdir, "--quiet",
            "--rollout-dir", str(rollout_dir), "--rollouts", str(ROLLOUTS), "--render", "gif"]
    for item in SCALED_SETS:
        args += ["--set", item]
    report, _, lines, took = run_cli_counts(*args)
    assert len(report["rollouts"]) == ROLLOUTS, report
    for i, roll in enumerate(report["rollouts"]):
        assert math.isfinite(roll["return"]) and roll["length"] > 0, roll
        assert (rollout_dir / f"rollout_{i}.npz").exists()
    for line in lines:
        print(f"  (e) {line}")
    print(f"  (e) eval --rollout-dir, {ROLLOUTS} rollouts: returns "
          f"{[round(r['return'], 2) for r in report['rollouts']]}, lengths "
          f"{[r['length'] for r in report['rollouts']]}, files "
          f"{sorted(p.name for p in rollout_dir.iterdir())} ({took:.1f} s with start-up)")
    print(f"  (e) took {time.perf_counter() - t_e:.1f} s")
    return ranks[0]["steady"]["kernels"]


def check_rank_shapes(torch, td_kernels, sample_kernels, card):
    """K1/K2 at B = 128 and K3 at (64, 8192, 128), the shapes of a rank of
    phase 10 (b): against their plain versions, then timed beside their
    bounds."""
    from deep_q_learning_tpu_torch.measure import bound_text

    err = {"td_loss_fwd": 0.0, "td_loss_bwd": 0.0}
    for double in (True, False):
        check_td_case(torch, td_kernels, td_inputs(torch, 128, 4, seed=128), 4, double, err)
    n, c, b = RANK_SLOT
    p, env, u = slot_inputs(torch, n, c, b, seed=64, dyadic=True)
    assert torch.equal(sample_kernels.slot_select(p, env, u),
                       sample_kernels.slot_select_reference(p, env, u)), "K3 differs (dyadic)"
    p, env, u = slot_inputs(torch, n, c, b, seed=65, dyadic=False)
    differ = slot_mismatches(torch, p, env, u, sample_kernels.slot_select(p, env, u),
                             sample_kernels.slot_select_reference(p, env, u), dyadic=False)
    err["per_slot_sample"] = 0  # dyadic priorities: exact
    args = td_inputs(torch, 128, 4, seed=99)
    _, td = td_kernels.td_loss_fwd(*args, 1.0, True)
    g = torch.ones((), device="cuda")
    p, env, u = slot_inputs(torch, n, c, b, seed=7, dyadic=False)
    times = {
        "td_loss_fwd": (time_ms(torch, lambda: td_kernels.td_loss_fwd(*args, 1.0, True)),
                        time_ms(torch, lambda: td_kernels.td_loss_reference(*args, 1.0, True)),
                        td_kernels.td_loss_fwd_work(128, 4)),
        "td_loss_bwd": (time_ms(torch, lambda: td_kernels.td_loss_bwd(
                            td, args[3], args[6], g, 4, 1.0, out_rows=256)),
                        time_ms(torch, lambda: td_kernels.td_loss_backward_reference(
                            td, args[3], args[6], g, 4, 1.0, out_rows=256)),
                        td_kernels.td_loss_bwd_work(128, 4, 256)),
        "per_slot_sample": (time_ms(torch, lambda: sample_kernels.slot_select(p, env, u)),
                            time_ms(torch, lambda: sample_kernels.slot_select_reference(p, env, u)),
                            sample_kernels.per_slot_sample_work(p, env)),
    }
    for name, (k_ms, p_ms, work) in times.items():
        print(f"  {name} at a rank's shape ({'B=128' if name != 'per_slot_sample' else RANK_SLOT}): "
              f"kernel {k_ms * 1e3:.2f} us/call, plain {p_ms * 1e3:.2f} us/call (CUDA events, "
              f"{TIMED_CALLS} calls); {bound_text(work, k_ms * 1e3)} [{card}]")
    print(f"  K1/K2 at B=128 vs plain: ok; K3 at {RANK_SLOT}: dyadic exact, random {differ} of "
          f"{b} slots differ")
    return err, times


RANK_SLOT = (64, 8192, 128)  # a rank of phase 10 (b): its PER rows and its batch


# phase 11: the host-compatibility path and the bf16 trunk.
# (a) HostAgent with lunar_ref_parity (dueling (32, 64), batch 64, adamw,
#     training_start 250, train_every 4) and use_pallas over the rigid
#     lander, cut in depth only: COMPAT_STEPS env steps, ~440 updates
COMPAT_STEPS = 2000
COMPAT_PROFILED_STEPS = 48  # one episode of the learning agent under torch.profiler
# K1/K2 on the compat path: lunar_ref_parity's batch at A = 4 (the lander)
# and A = 2 (CartPole)
COMPAT_SHAPES = [(64, 4), (64, 2)]
CURVE_SHAPE = COMPAT_SHAPES[1]  # phase 12 (c): CartPole through engine_curve_compare
# (b) CartPole-v1 through make_host_env("torch") with the learner on the card
# from 64 stored transitions; the jointed default LunarLander-v2 a few frames
CARTPOLE_COMPAT_STEPS = 300
JOINTED_HOST_FRAMES = 8
JOINTED_HOST_GRAPHED_STEPS = 16  # phase 11 (c): graphed against eager, one reset each
# (c) gymnasium's Box2D lander with the learner on the card, where it imports
BOX2D_COMPAT_STEPS = 400
# (d), (e) lunar_per at full width with a bf16 trunk, cut in depth as phase
# 10's DIST_SETS; the f32 run on the same cut is timed in turns with it
BF16_SETS = DIST_SETS + ["compute_dtype=bfloat16"]
BF16_MEMBERS = 2


def train_state_to(ts, device):
    """A copy of the train state ``ts`` on ``device``."""
    import copy

    out = copy.deepcopy(ts)
    out.online.to(device)
    out.target.to(device)
    out.opt_state.mu = [t.to(device) for t in out.opt_state.mu]
    out.opt_state.nu = [t.to(device) for t in out.opt_state.nu]
    if out.opt_state.device_count is not None:
        out.opt_state.device_count = out.opt_state.device_count.to(device)
    return out


def update_card_vs_cpu(torch, cfg, ts, batch, weights):
    """One learner update of ``cfg`` from a copy of ``ts`` and the same
    batch, on the card and on the CPU: ``(loss, [params])`` of each."""
    from deep_q_learning_tpu_torch.algos import build_update_step, make_optimizer
    from deep_q_learning_tpu_torch.replay.nstep import LearnBatch

    out = []
    for device in ("cpu", "cuda"):
        copy_ts = train_state_to(ts, device)
        lb = LearnBatch(**{k: v.to(device) for k, v in batch.items()})
        copy_ts, loss, _ = build_update_step(make_optimizer(cfg), cfg)(
            copy_ts, lb, weights.to(device))
        out.append((loss.cpu(), [p.detach().cpu() for p in copy_ts.online.parameters()]))
    return out


def profile_host_steps(torch, agent, steps):
    """What one episode of ``agent`` learning on, cut at ``steps`` env steps
    (its reset included), put on the card, from the profiler's trace
    (``measure.traced_kernels``): a :class:`KernelTrace`, its env steps, its
    updates and K1/K2 in it.  An episode whose trace lost a record of K1 or
    K2 or of a graph launch's kernels is reported, and the next episode is
    traced, up to TRACE_ATTEMPTS times."""
    from deep_q_learning_tpu_torch.measure import learner_kernels, traced_kernels

    for attempt in range(1, TRACE_ATTEMPTS + 1):
        done, updates = agent._global_steps, agent.train_state.updates
        trace = traced_kernels(lambda: agent.run_episode(steps))
        n, updates = agent._global_steps - done, agent.train_state.updates - updates
        kernels = learner_kernels(trace)
        whole = dict(td_loss_fwd=updates, td_loss_bwd=updates, per_slot_sample=0)
        if updates and kernels == whole and not trace.per_graph_launch.count(0):
            return trace, n, updates, kernels
        print(f"  the profiler lost records in episode {attempt} of the trace ({trace.lost} of "
              f"{trace.launches} kernel launches, K1/K2 {kernels} for {updates} updates); "
              f"tracing the next")
    raise RuntimeError(f"the profiler lost records in {TRACE_ATTEMPTS} episodes")


def check_compat_shapes(torch, td_kernels, card):
    """K1/K2 at the compat path's shapes against their plain versions, both
    targets; their times (CUDA events over Python calls, and device µs from
    a CUDA graph) beside their bound.  Errors and times by shape."""
    from deep_q_learning_tpu_torch.measure import bound_text, device_us

    err = {}
    for i, (b, a) in enumerate(COMPAT_SHAPES):
        err[b, a] = {"td_loss_fwd": 0.0, "td_loss_bwd": 0.0}
        for double in (True, False):
            check_td_case(torch, td_kernels, td_inputs(torch, b, a, seed=200 + i), a, double,
                          err[b, a])
    times = {}
    for b, a in COMPAT_SHAPES:
        args = td_inputs(torch, b, a, seed=210)
        loss, td = td_kernels.td_loss_fwd(*args, 1.0, True)
        g = torch.ones((), device="cuda")
        rows = 2 * b
        calls = {
            "td_loss_fwd": (lambda: td_kernels.td_loss_fwd(*args, 1.0, True),
                            lambda: td_kernels.td_loss_reference(*args, 1.0, True),
                            td_kernels.td_loss_fwd_work(b, a)),
            "td_loss_bwd": (lambda: td_kernels.td_loss_bwd(td, args[3], args[6], g, a, 1.0,
                                                           out_rows=rows),
                            lambda: td_kernels.td_loss_backward_reference(
                                td, args[3], args[6], g, a, 1.0, out_rows=rows),
                            td_kernels.td_loss_bwd_work(b, a, rows)),
        }
        for name, (kernel, plain, work) in calls.items():
            k_ms, p_ms = time_ms(torch, kernel), time_ms(torch, plain)
            k_us, p_us = device_us(kernel), device_us(plain)
            times.setdefault((b, a), {})[name] = (k_ms, p_ms, work)
            print(f"  {name} B={b} A={a}: kernel {k_ms * 1e3:.2f} us/call, plain "
                  f"{p_ms * 1e3:.2f} us/call (CUDA events, {TIMED_CALLS} calls); device "
                  f"{k_us:.2f} us kernel, {p_us:.2f} us plain (CUDA graph); "
                  f"{bound_text(work, k_us)} [{card}]")
    print(f"  K1/K2 at {COMPAT_SHAPES} vs plain, both targets: ok")
    return err, times


def compat_lander_agent(torch, cfg, graphed):
    """Phase 11 (a)'s agent on a rigid lander of its own, from seed 0."""
    import dataclasses

    from deep_q_learning_tpu_torch.compat.host_env import TimeFractionHostWrapper, TorchHostEnv
    from deep_q_learning_tpu_torch.compat.host_loop import HostAgent
    from deep_q_learning_tpu_torch.envs import LunarLander

    lander = LunarLander()
    params = dataclasses.replace(lander.default_params(), jointed=False,
                                 max_steps_in_episode=cfg.max_steps_in_episode)
    env = TimeFractionHostWrapper(TorchHostEnv(lander, params, seed=0, device="cuda"),
                                  cfg.max_steps_in_episode)
    agent = HostAgent(env, 9, 4, cfg, device="cuda", graphed=graphed)
    agent.losses = []
    step = agent._train_step

    def train_step():
        agent.losses.append(step())
        return agent.losses[-1]

    agent._train_step = train_step
    return agent


def run_compat_lander(torch, td_kernels, card):
    """Phase 11 (a): HostAgent over the rigid lander on the card, its update
    one CUDA graph replay, then the eager agent from the same seed: every
    loss, action and episode and the learner bitwise.  Returns K1/K2 on the
    device in the traced episode."""
    import dataclasses

    import numpy as np

    from deep_q_learning_tpu_torch.config import lunar_ref_parity

    cfg = dataclasses.replace(lunar_ref_parity(), use_pallas=True)
    assert (cfg.hidden, cfg.batch_size, cfg.training_start, cfg.train_every) == (
        (32, 64), 64, 250, 4), cfg
    agents, records, seconds, launches = {}, {}, {}, {}
    for graphed in (True, False):
        agent = agents[graphed] = compat_lander_agent(torch, cfg, graphed)
        online0 = [p.detach().clone() for p in agent.train_state.online.parameters()]
        records[graphed] = []
        td_kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agent.training(max_episodes=10**6, verbose=False, max_total_steps=COMPAT_STEPS,
                       on_episode=lambda *r, rec=records[graphed]: rec.append(r))
        torch.cuda.synchronize()
        seconds[graphed] = time.perf_counter() - t0
        launches[graphed] = dict(td_kernels.launches)
        assert td_kernels.plain_calls == {"td_loss_fwd": 0, "td_loss_bwd": 0}
        moved = sum(float((p.detach() - p0).norm()) for p, p0 in
                    zip(agent.train_state.online.parameters(), online0))
        assert moved > 0
    agent = agents[True]
    steps, updates = agent._global_steps, len(agent.losses)
    # a stored transition a step; an update every 4th step from 250 stored
    assert agent.buffer.size == steps >= COMPAT_STEPS, (agent.buffer.size, steps)
    assert updates == steps // 4 - 249 // 4 == agent.train_state.updates, (updates, steps)
    assert updates == agent.train_state.opt_state.count == int(agent.train_state.opt_state.device_count)
    assert launches == {True: {"td_loss_fwd": 2, "td_loss_bwd": 2},  # the graph's eager call, capture
                        False: {"td_loss_fwd": updates, "td_loss_bwd": updates}}, launches
    assert math.isfinite(agent._last_loss), agent._last_loss
    eps = [r[-1] for r in records[True]]
    want = []
    for _ in records[True]:
        want.append(max((want[-1] if want else cfg.eps_start) * cfg.eps_decay, cfg.eps_min))
    assert eps == want and eps[-1] < cfg.eps_start, eps
    eager = agents[False]
    assert agent.losses == eager.losses and records[True] == records[False]
    ts, te = agent.train_state, eager.train_state
    for a, b in zip([*ts.online.parameters(), *ts.target.parameters(), *ts.opt_state.mu,
                     *ts.opt_state.nu, ts.opt_state.device_count],
                    [*te.online.parameters(), *te.target.parameters(), *te.opt_state.mu,
                     *te.opt_state.nu, te.opt_state.device_count]):
        assert torch.equal(a, b)
    print(f"  (a) HostAgent lunar_ref_parity + use_pallas, rigid lander on the card, its update "
          f"one CUDA graph replay: {steps} env steps, {len(records[True])} episodes, {updates} "
          f"updates (the wrappers {launches[True]}: the graph's eager call and capture), no plain "
          f"call, last loss {agent._last_loss:.5f}, eps {eps[-1]:.4f}; then the eager agent from "
          f"the same seed: every loss, episode and the learner bitwise; env-steps/s graphed "
          f"{steps / seconds[True]:.1f}, eager {steps / seconds[False]:.1f} [{card}]")

    # one update on the card against the CPU, from the agent's own state
    obs, action, reward, next_obs, done = agent.buffer.sample(cfg.batch_size)
    batch = dict(obs=torch.from_numpy(obs), action=torch.from_numpy(action),
                 reward=torch.from_numpy(reward), next_obs=torch.from_numpy(next_obs),
                 bootstrap=torch.from_numpy(cfg.gamma * (1.0 - done.astype(np.float32))))
    (lc, pc), (lg, pg) = update_card_vs_cpu(torch, cfg, agent.train_state, batch,
                                            torch.ones((cfg.batch_size,)))
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-6)
    for a, c in zip(pg, pc):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-6)
    t0 = time.perf_counter()
    traced = {}
    for graphed in (True, False):
        traced[graphed] = profile_host_steps(torch, agents[graphed], COMPAT_PROFILED_STEPS)
    t1 = time.perf_counter()
    returns = agent.evaluate(1)
    assert len(returns) == 1 and math.isfinite(returns[0]), returns
    for graphed, (trace, n, episode_updates, kernels) in traced.items():
        print(f"  (a) the {'graphed' if graphed else 'eager'} agent over an episode of {n} "
              f"learning env steps and its reset, {episode_updates} updates (torch.profiler's "
              f"trace): {trace.host_launches / n:.1f} host launches per env step "
              f"({trace.launches / n:.1f} kernels, {len(trace.per_graph_launch) / n:.2f} graphs, "
              f"{trace.copies / n:.2f} copies and fills; {trace.lost} kernel launches with no "
              f"record), K1/K2 on the device {kernels['td_loss_fwd']}/{kernels['td_loss_bwd']}, "
              f"device busy "
              f"{100 * trace.device_us / trace.wall_us:.1f} % of the wall [{card}]")
    print(f"  (a) an update card vs CPU from the agent's state: ok; traced in "
          f"{t1 - t0:.1f} s; greedy evaluate(1) return {returns[0]:.2f} in "
          f"{time.perf_counter() - t1:.1f} s [{card}]")
    kernels = traced[True][3]
    return {k: kernels[k] for k in ("td_loss_fwd", "td_loss_bwd")}


def run_compat_engines(torch, td_kernels, card):
    """Phase 11 (b) and (c): make_host_env("torch") for CartPole-v1 (the
    learner on the card, K1/K2 at A = 2) and the jointed default lander; the
    Box2D engine where gymnasium and Box2D import."""
    import dataclasses
    import random

    import numpy as np

    from deep_q_learning_tpu_torch.compat.host_env import make_host_env
    from deep_q_learning_tpu_torch.compat.host_loop import HostAgent
    from deep_q_learning_tpu_torch.config import lunar_ref_parity

    cfg = dataclasses.replace(lunar_ref_parity(), env_id="CartPole-v1", max_steps_in_episode=500,
                              training_start=64, use_pallas=True)
    env, obs_dim, num_actions = make_host_env("torch", "CartPole-v1", max_steps=500, device="cuda")
    assert (obs_dim, num_actions) == (5, 2)
    agent = HostAgent(env, obs_dim, num_actions, cfg, device="cuda")
    td_kernels.reset_counts()
    t0 = time.perf_counter()
    _, episodes = agent.training(max_episodes=10**6, verbose=False,
                                 max_total_steps=CARTPOLE_COMPAT_STEPS)
    seconds = time.perf_counter() - t0
    updates = agent.train_state.updates
    assert updates == agent._global_steps // 4 - 63 // 4 > 2, updates
    # the update's graph: its eager call and capture
    assert td_kernels.launches == {"td_loss_fwd": 2, "td_loss_bwd": 2}
    assert td_kernels.plain_calls == {"td_loss_fwd": 0, "td_loss_bwd": 0}
    assert math.isfinite(agent._last_loss)
    print(f"  (b) make_host_env('torch', 'CartPole-v1'): {agent._global_steps} env steps, "
          f"{episodes} episodes, {updates} updates with K1/K2 at (64, 2), "
          f"{agent._global_steps / seconds:.1f} env-steps/s [{card}]")

    lander, obs_dim, num_actions = make_host_env("torch", "LunarLander-v2", device="cuda")
    assert lander.env.params.jointed and (obs_dim, num_actions) == (9, 4)
    rng = random.Random(0)
    t0 = time.perf_counter()
    obs, _ = lander.reset()
    frames = [obs]
    for _ in range(JOINTED_HOST_FRAMES):
        obs, reward, term, trunc, _ = lander.step(rng.randrange(4))
        frames.append(obs)
        assert math.isfinite(reward) and not trunc
        if term:
            break
    seconds = time.perf_counter() - t0
    frames = np.stack(frames)
    assert frames.shape[1] == 9 and np.isfinite(frames).all()
    assert (frames[:, -1] == (np.arange(len(frames)) / 1500).astype(np.float32)).all()
    print(f"  (b) make_host_env('torch', 'LunarLander-v2'), the jointed lander: a reset and "
          f"{len(frames) - 1} frames in {seconds:.2f} s ({(len(frames) - 1) / seconds:.2f} "
          f"env-steps/s with the reset) [{card}]")

    run_jointed_host_env(torch, card)
    try:
        import Box2D  # noqa: F401
        import gymnasium  # noqa: F401
    except ImportError as e:
        print(f"  (c) gymnasium's Box2D lander: not on this machine ({e}); it is a host-only "
              f"env, so nothing of the card is skipped")
        return
    cfg = dataclasses.replace(lunar_ref_parity(), training_start=64, use_pallas=True)
    env, obs_dim, num_actions = make_host_env("box2d", seed=0, device="cuda")
    agent = HostAgent(env, obs_dim, num_actions, cfg, device="cuda")
    td_kernels.reset_counts()
    t0 = time.perf_counter()
    agent.training(max_episodes=10**6, verbose=False, max_total_steps=BOX2D_COMPAT_STEPS)
    seconds = time.perf_counter() - t0
    updates = agent.train_state.updates
    assert updates > 2 and td_kernels.launches == {"td_loss_fwd": 2, "td_loss_bwd": 2}
    print(f"  (c) make_host_env('box2d'): {agent._global_steps} env steps on the host, {updates} "
          f"updates on the card, {agent._global_steps / seconds:.1f} env-steps/s [{card}]")


def run_jointed_host_env(torch, card):
    """Phase 11 (c): the jointed default lander through TorchHostEnv, its
    step and reset as CUDA graphs, against the eager TorchHostEnv: the same
    seed and actions give the same observations, rewards and flags bitwise;
    env-steps/s of each (a reset included)."""
    import random

    import numpy as np

    from deep_q_learning_tpu_torch.compat.host_env import TorchHostEnv
    from deep_q_learning_tpu_torch.envs import make_env

    env, params = make_env("LunarLander-v2", max_steps_in_episode=1500)
    assert params.jointed
    seqs, rates = {}, {}
    for graphed in (True, False):
        host = TorchHostEnv(env, params, seed=3, device="cuda", graphed=graphed)
        assert host.graphed == graphed
        rng = random.Random(1)
        t0 = time.perf_counter()
        seq = [host.reset()[0]]
        for _ in range(JOINTED_HOST_GRAPHED_STEPS):
            obs, reward, term, trunc, _ = host.step(rng.randrange(4))
            seq.append(np.concatenate([obs, [reward, term, trunc]]))
            if term or trunc:
                seq.append(host.reset()[0])
        rates[graphed] = JOINTED_HOST_GRAPHED_STEPS / (time.perf_counter() - t0)
        seqs[graphed] = seq
    assert len(seqs[True]) == len(seqs[False])
    for a, b in zip(seqs[True], seqs[False]):
        assert np.array_equal(a, b), (a, b)
    print(f"  (c) TorchHostEnv, the jointed lander at (180, 60): {JOINTED_HOST_GRAPHED_STEPS} "
          f"steps graphed bitwise eager; graphed {rates[True]:.2f} env-steps/s (with its two "
          f"captures), eager {rates[False]:.2f} [{card}]")


def check_bf16_update_vs_cpu(torch, cfg, ts):
    """One bf16 learner update from ``ts`` (a trained state) on the card
    against the CPU, from the same random batch: the loss rtol 1e-3, and
    each parameter within 2.1 lr, at most 1 % of them beyond lr / 10 (the
    trunk's bf16 products round in other places on the card: a gradient
    below the bf16 resolution may flip its sign)."""
    g = torch.Generator().manual_seed(9)
    b = cfg.batch_size
    batch = dict(
        obs=torch.randn((b, 9), generator=g),
        action=torch.randint(0, 4, (b,), generator=g, dtype=torch.int32),
        reward=torch.randn((b,), generator=g), next_obs=torch.randn((b, 9), generator=g),
        bootstrap=0.97 * (torch.rand((b,), generator=g) > 0.2).float(),
    )
    (lc, pc), (lg, pg) = update_card_vs_cpu(torch, cfg, ts, batch,
                                            torch.rand((b,), generator=g) + 0.1)
    torch.testing.assert_close(lg, lc, rtol=1e-3, atol=1e-6)
    lr = cfg.learning_rate
    far = sum(int(((a - c).abs() > lr / 10).sum()) for a, c in zip(pg, pc))
    total = sum(a.numel() for a in pg)
    for a, c in zip(pg, pc):
        torch.testing.assert_close(a, c, rtol=0, atol=2.1 * lr)
    assert far <= 0.01 * total, (far, total)
    return far, total, float((lg - lc).abs() / lc.abs())


def run_bf16(torch, td_kernels, sample_kernels, card):
    """Phase 11 (d): lunar_per with a bf16 trunk through Trainer, timed in
    turns with the f32 run on the same cut; (e) a 2-member bf16 population.
    Returns (d)'s kernel launches and K1/K2's error on its batch."""
    import dataclasses

    import numpy as np

    from deep_q_learning_tpu_torch.__main__ import build_config
    from deep_q_learning_tpu_torch.measure import learner_kernels, traced_kernels
    from deep_q_learning_tpu_torch.parallel import PopulationTrainer
    from deep_q_learning_tpu_torch.train import Trainer

    cfg = build_config("lunar_per", BF16_SETS)
    f32 = dist_config()
    assert cfg.compute_dtype == "bfloat16" and f32.compute_dtype == "float32"
    zero = {"td_loss_fwd": 0, "td_loss_bwd": 0, "per_slot_sample": 0}
    turns, peaks, steady = [], {}, {}
    for c in (f32, cfg, cfg, f32):
        t = Trainer(c, device="cuda").init(seed=0)
        torch.cuda.synchronize()
        fresh_peak(torch)
        t0 = time.perf_counter()
        for _ in range(DIST_SUPERSTEPS):
            t.step()
        torch.cuda.synchronize()
        turns.append((c.compute_dtype, DIST_SUPERSTEPS * c.steps_per_superstep * c.num_envs
                      / (time.perf_counter() - t0)))
        peaks[c.compute_dtype] = torch.cuda.max_memory_allocated() / 2**20
    for c in (f32, cfg):
        steady[c.compute_dtype] = profile_steady(torch, Trainer(dataclasses.replace(
            c, steps_per_superstep=LAUNCH_STEPS, training_start=0), device="cuda").init(seed=1),
            LAUNCH_STEPS)
    rates = ", ".join(f"{name} {rate:.1f}" for name, rate in turns)
    memory = ", ".join(f"{k} {v:.1f} MiB" for k, v in peaks.items())
    profiled = ", ".join(f"{k} {s['launches_per_step']:.1f} launches per vector step, device "
                         f"busy {100 * s['busy']:.1f} %" for k, s in steady.items())
    print(f"  (d) lunar_per x128 env-steps/s in turns on the same cut: {rates}; peak memory "
          f"{memory}; steady {LAUNCH_STEPS}-step superstep: {profiled} [{card}]")

    trainer = Trainer(cfg, device="cuda").init(seed=0)
    td_kernels.reset_counts()
    sample_kernels.reset_counts()
    metrics = [trainer.step() for _ in range(DIST_SUPERSTEPS - 1)]
    # the last superstep under the profiler: the kernels on the device
    launches = learner_kernels(traced_kernels(lambda: metrics.append(trainer.step())))
    torch.cuda.synchronize()
    plain = dict(td_kernels.plain_calls, **sample_kernels.plain_calls)
    steady = metrics[-1].loss_count
    assert sum(m.loss_count for m in metrics) == trainer.runner.train.updates == DIST_ROUNDS
    assert launches == dict.fromkeys(zero, steady) and plain == zero, (launches, plain)
    bf16_launches = launches
    loss = sum(m.loss_sum for m in metrics) / DIST_ROUNDS
    assert math.isfinite(loss), loss
    online = trainer.runner.train.online
    assert all(p.dtype == torch.float32 for p in online.parameters())
    assert all(t.dtype == torch.float32 for t in trainer.runner.train.opt_state.mu)
    with torch.no_grad():
        assert online.features(trainer.runner.obs).dtype == torch.bfloat16
        assert online(trainer.runner.obs).dtype == torch.float32
    # K1/K2 on a real bf16-fed batch from the replay: the same f32 shapes
    err = {"td_loss_fwd": 0.0, "td_loss_bwd": 0.0}
    r = trainer.runner
    batch, _, weights = trainer.replay.sample_with_info(
        r.replay, r.generator, cfg.batch_size, gamma=r.hyper.gamma, beta=r.hyper.per_beta)
    b = cfg.batch_size
    with torch.no_grad():
        q_both = online(torch.cat([batch.obs, batch.next_obs]))
        q_next_target = r.train.target(batch.next_obs)
    assert q_both.dtype == torch.float32 and q_both.shape == (2 * b, 4)
    check_td_case(torch, td_kernels, [q_both[:b], q_both[b:], q_next_target, batch.action,
                                      batch.reward, batch.bootstrap, weights], 4, True, err)
    far, total, loss_rel = check_bf16_update_vs_cpu(torch, cfg, trainer.runner.train)
    print(f"  (d) bf16 lunar_per x128: {DIST_ROUNDS} update rounds, launches {launches} on the "
          f"device in the last superstep (profiled, {steady} updates), no plain "
          f"call, loss {loss:.5f}; f32 parameters and Adam state, bf16 trunk activations; K1/K2 "
          f"on a bf16-fed batch vs plain: ok; an update card vs CPU: loss rel {loss_rel:.2e}, "
          f"{far} of {total} parameters beyond lr/10 [{card}]")

    m = BF16_MEMBERS
    pop = PopulationTrainer(cfg, m, eval_envs=4, device="cuda")
    runner = pop.init(seed=0)
    td_kernels.reset_counts()
    sample_kernels.reset_counts()
    t0 = time.perf_counter()
    for _ in range(DIST_SUPERSTEPS - 1):
        pop.step(runner)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # the last superstep under the profiler: graph L's kernels on the device
    # (the wrappers count its eager call and its capture only)
    mets = []
    pop_launches = learner_kernels(traced_kernels(lambda: mets.append(pop.step(runner)[1])))
    met = mets[-1]
    rounds = runner.train.updates
    assert rounds == [DIST_ROUNDS] * m, rounds
    last = met.loss_count.tolist()
    assert last == [cfg.steps_per_superstep] * m, last
    assert pop_launches == dict.fromkeys(zero, last[0]), pop_launches
    wrapped = dict(td_kernels.launches, **sample_kernels.launches)
    assert wrapped == dict.fromkeys(zero, 2), wrapped
    assert not any(dict(td_kernels.plain_calls, **sample_kernels.plain_calls).values())
    assert np.isfinite(met.loss_sum).all()
    with torch.no_grad():
        assert runner.train.online.features(runner.obs.view(m, cfg.num_envs, -1)).dtype == \
            torch.bfloat16
    env_steps = (DIST_SUPERSTEPS - 1) * cfg.steps_per_superstep * cfg.num_envs * m
    print(f"  (e) bf16 lunar_per population of {m}, graphed: {env_steps} env steps of the first "
          f"superstep in {seconds:.3f} s = {env_steps / seconds:.1f} aggregate env-steps/s (with "
          f"the graphs' eager calls and captures), {DIST_ROUNDS} update rounds each; the last "
          f"superstep, profiled: launches {pop_launches} on the device, the wrappers {wrapped} "
          f"[{card}]")
    return bf16_launches, err


# phase 12: the gymnasium harness and its examples.  The card has no
# gymnasium: (a) replays two Box2D episodes recorded on a host that has it
# (deep_q_learning_tpu_torch/envs/gym_traces.json) as two lanes of one
# jointed lander at gym's (180, 60) solver iterations, held to the gates of
# tests/test_gym_parity.py, and the same replay on the CPU (in a process of
# its own, beside the card's)
# (nop seed 2 is tests/test_gym_parity.py's contact-timing case; seed 0's
# flight carries a single-frame 8e-3 transient on the JAX engine too,
# artifacts/gym_parity.json)
REPLAY_TRACES = ("burn_s6", "nop_s2")
REPLAY_MAX_STEPS = 400
REPLAY_CPU = (
    "import json\n"
    "from deep_q_learning_tpu_torch.envs import gym_compat\n"
    f"print(json.dumps(gym_compat._replay({list(REPLAY_TRACES)}, {REPLAY_MAX_STEPS}, 'cpu')))\n"
)
# (c) engine_curve_compare --engine torch on phase 11 (b)'s cut (CartPole-v1,
# lunar_ref_parity, the learner from 64 stored transitions, K1/K2 at A = 2),
# in a process of its own that prints its kernel launches and plain calls
CURVE_SETS = ["training_start=64", "max_steps_in_episode=500", "use_pallas=true"]
CURVE_COUNTS = (
    "import json, sys\n"
    "from deep_q_learning_tpu_torch.examples.engine_curve_compare import main\n"
    "from deep_q_learning_tpu_torch.measure import learner_kernels, traced_kernels\n"
    "from deep_q_learning_tpu_torch.ops import td_kernels\n"
    "trace = traced_kernels(lambda: main(sys.argv[1:]))\n"
    "print(json.dumps({'launches': td_kernels.launches, 'plain': td_kernels.plain_calls,\n"
    "                  'device': learner_kernels(trace), 'lost': trace.lost}))\n"
)
# (d) the rigid impact sweep: artifacts/gym_parity.json's jax_rigid row at these speeds
IMPACT_SPEEDS = [1.0, 1.5, 2.5, 3.0]
IMPACT_WANT = {"1.0": "LAND", "1.5": "LAND", "2.5": "CRASH", "3.0": "CRASH"}


def replay_gates(burn, nop):
    """tests/test_gym_parity.py's gates on a replayed burn and nop trace."""
    for res in (burn, nop):
        assert res["init_state_err"] < 1e-5, res  # state injection is exact
    assert burn["term_step"]["gym"] == burn["term_step"]["torch"], burn
    assert burn["term_reward"]["gym"] == burn["term_reward"]["torch"], burn
    assert burn["flight_max_err"] < 5e-4, burn
    assert burn["obs_err_at"]["1"] < 2e-4, burn
    g, j = nop["first_contact"]["gym"], nop["first_contact"]["torch"]
    assert g is not None and j is not None and abs(g - j) <= 2, nop
    assert abs(nop["term_step"]["gym"] - nop["term_step"]["torch"]) <= 2, nop
    assert nop["flight_max_err"] < 1e-4, nop
    assert (nop["term_reward"]["gym"] > 0) == (nop["term_reward"]["torch"] > 0), nop


# phase 13: the pair the JAX package wrote, Q-values card vs CPU on observations in
# the lander's range, within rtol 1e-5 of the largest |Q| (TF32 off).  The dueling
# head adds and subtracts Q-values of up to ~330 here, so the float32 rounding of
# another summation order is relative to that scale, not to each Q-value: one near
# 0 differs by ~1.5e-5 between cuBLAS and the CPU
REF_FORMAT = REPO / "artifacts" / "lunar_ref_format"
REF_OBS = 256
REF_Q_RTOL = 1e-5
REF_EVAL_EPISODES = 10
# train_lunar_lander at lunar_per's width, logging every superstep: 4 supersteps
# of 128 vector steps, the learner from vector step 157 (20,000 stored over 128
# envs), so two whole supersteps past training_start, as phase 4
REF_TRAIN_SUPERSTEPS = 4


def ref_observations(torch):
    """REF_OBS lander observations from a seed: the 8 state values in
    [-1, 1], the legs' contact flags 0 or 1, the time fraction in [0, 1)."""
    import numpy as np

    rng = np.random.default_rng(13)
    obs = rng.uniform(-1.0, 1.0, (REF_OBS, 9)).astype(np.float32)
    obs[:, 6:8] = rng.integers(0, 2, (REF_OBS, 2))
    obs[:, 8] = rng.random(REF_OBS)
    return torch.from_numpy(obs)


def run_reference_format(torch, td_kernels, card, workdir):
    """Phase 13: the reference's pickle pair on the card and the two
    scripts.  Returns (b)'s kernel launches."""
    import numpy as np

    from deep_q_learning_tpu_torch.examples import train_lunar_lander
    from deep_q_learning_tpu_torch.measure import learner_kernels
    from deep_q_learning_tpu_torch.models import QNetwork
    from deep_q_learning_tpu_torch.utils.checkpoint import load_params_pickle

    # (a) the JAX package's pair: Q-values on the card against the CPU
    obs = ref_observations(torch)
    params, _ = load_params_pickle(str(REF_FORMAT))
    with torch.no_grad():
        q_card = QNetwork.from_flax_params(params, device="cuda")(obs.cuda()).cpu()
        q_cpu = QNetwork.from_flax_params(params)(obs)
    q_err, q_max = float((q_card - q_cpu).abs().max()), float(q_cpu.abs().max())
    assert q_err <= REF_Q_RTOL * q_max, (q_err, q_max)
    print(f"  (a) {REF_FORMAT.relative_to(REPO)} through load_params_pickle: Q-values of "
          f"{REF_OBS} observations, card vs CPU max abs err {q_err:.3g} against |Q| up to "
          f"{q_max:.1f} (rtol {REF_Q_RTOL} of it) [{card}]")
    # ops.fused_td_loss, the JAX package's signature, on the card against the CPU
    args = td_inputs(torch, 256, 4, seed=13)
    got = []
    for device in ("cuda", "cpu"):
        q_s, *rest = [x.detach().to(device) for x in args]
        q_s.requires_grad_(True)
        loss, td = td_kernels.fused_td_loss(q_s, *rest)
        loss.backward()
        got.append([x.detach().cpu() for x in (loss, td, q_s.grad)])
    (loss, td, dq), (ref_loss, ref_td, ref_dq) = got
    torch.testing.assert_close(loss, ref_loss, **LOSS_TOL)
    torch.testing.assert_close(td, ref_td, **LOSS_TOL)
    torch.testing.assert_close(dq, ref_dq, **DQ_TOL)
    print(f"  (a) ops.fused_td_loss at (256, 4) on the card vs the CPU: loss {float(loss):.6f}, "
          f"dQ max abs err {float((dq - ref_dq).abs().max()):.3g}")
    evaluate = subprocess.Popen(
        [sys.executable, "-m", "deep_q_learning_tpu_torch.examples.evaluate_checkpoint",
         "--ckpt", str(REF_FORMAT), "--episodes", str(REF_EVAL_EPISODES), "--device", "cuda",
         "--out", str(Path(workdir) / "eval")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # (b) train_lunar_lander at full width, in this process
        from deep_q_learning_tpu_torch.config import lunar_per

        cfg = lunar_per()
        steps = REF_TRAIN_SUPERSTEPS * cfg.steps_per_superstep * cfg.num_envs
        t0 = time.perf_counter()
        td_kernels.reset_counts()
        trainer = train_lunar_lander.main([
            "--preset", "lunar_per", "--device", "cuda", "--rollouts", "1",
            "--steps", str(steps), "--log-every", "1", "--workdir", str(workdir)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        plain = dict(td_kernels.plain_calls)
        updates = trainer.runner.train.updates
        assert trainer.history[-1]["env_steps"] == steps, trainer.history[-1]
        assert updates > 0, updates
        assert plain == {"td_loss_fwd": 0, "td_loss_bwd": 0}, plain
        assert math.isfinite(trainer.history[-1]["loss"]), trainer.history[-1]
        params, opt_state = load_params_pickle(str(Path(workdir) / "ref_format"))
        assert int(opt_state[1][0].count) == updates, opt_state[1][0].count
        with torch.no_grad():
            obs_card = obs.cuda()
            read_back = QNetwork.from_flax_params(params, device="cuda")(obs_card)
            trained = trainer.runner.train.online(obs_card)
        assert torch.equal(read_back, trained), float((read_back - trained).abs().max())
        rollout = np.load(Path(workdir) / "rollout_0.npz")
        assert math.isfinite(float(rollout["ret"])) and int(rollout["length"]) > 0
        # the evaluator's process is done before the profiler starts: no other
        # process is on the card while this one is traced
        stdout, stderr = evaluate.communicate(timeout=300)
        # one more superstep of the script's trainer under the profiler: K1/K2
        # on the device once per update (a graph's replay passes no counter)
        more = []
        trace, _ = traced_superstep(lambda: more.append(trainer.step()), "phase 13 (b)")
        launches = learner_kernels(trace)
        steady = more[-1].loss_count
        assert steady == cfg.steps_per_superstep and launches == {
            "td_loss_fwd": steady, "td_loss_bwd": steady, "per_slot_sample": 0}, (launches, steady)
        assert dict(td_kernels.plain_calls) == {"td_loss_fwd": 0, "td_loss_bwd": 0}
        print(f"  (b) examples.train_lunar_lander --preset lunar_per --rollouts 1: {steps} env "
              f"steps, {updates} updates, no plain call; one more superstep of its trainer, "
              f"profiled: K1/K2 on the device {launches} ({steady} updates); the "
              f"ref_format pair read back with Q-values bitwise the trained network's; "
              f"rollout return {float(rollout['ret']):.1f} over {int(rollout['length'])} "
              f"frames; {seconds:.1f} s [{card}]")
    finally:
        if evaluate.poll() is None:
            evaluate.kill()
            evaluate.wait()
    if evaluate.returncode != 0:
        raise RuntimeError(f"evaluate_checkpoint exited {evaluate.returncode}:\n{stdout}\n{stderr}")
    line = next(x for x in stdout.splitlines() if x.startswith("eval over"))
    stats = dict(kv.split("=") for kv in line.split(": ", 1)[1].split()[:3])
    assert all(math.isfinite(float(v)) for v in stats.values()), line
    print(f"  (a) examples.evaluate_checkpoint --episodes {REF_EVAL_EPISODES} in a process of "
          f"its own, beside (b): {line}; mean {float(stats['mean'])} [{card}]")
    for extra in stdout.splitlines():
        if extra != line:
            print(f"      {extra}")
    return launches


def run_gym_harness(torch, td_kernels, card, workdir):
    """Phase 12: (a) the recorded traces on the card and the CPU, (b) live
    gymnasium where it imports, (c) engine curves and their summary, (d)
    the rigid impact sweep.  Returns (c)'s kernel launches."""
    from deep_q_learning_tpu_torch.envs import gym_compat
    from deep_q_learning_tpu_torch.examples import summarize_engine_curves
    from deep_q_learning_tpu_torch.examples.gym_parity_report import impact_sweep_torch

    curve = Path(workdir) / "curve_torch_s0.jsonl"
    curve_args = ["--engine", "torch", "--env", "CartPole-v1", "--max-total-steps",
                  str(CARTPOLE_COMPAT_STEPS), "--eval-episodes", "2", "--out", str(curve),
                  "--device", "cuda"] + [a for kv in CURVE_SETS for a in ("--set", kv)]
    # (c) and the CPU replay run in processes of their own beside (a), one
    # thread each and at a lower priority: (a)'s frames are bound by this
    # process's host time
    def beside(*args):
        return subprocess.Popen([sys.executable, "-c", *args], cwd=REPO,
                                env=dict(os.environ, OMP_NUM_THREADS="1"),
                                preexec_fn=lambda: os.nice(10), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    t0 = time.perf_counter()
    procs = {"curves": beside(CURVE_COUNTS, *curve_args), "cpu": beside(REPLAY_CPU)}
    out = {}
    try:
        t1 = time.perf_counter()
        burn, nop = gym_compat._replay(REPLAY_TRACES, REPLAY_MAX_STEPS, "cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        frames = max(v for r in (burn, nop) for v in r["term_step"].values() if v is not None)
        replay_gates(burn, nop)
        print(f"  (a) Box2D traces {REPLAY_TRACES} replayed as 2 lanes of one jointed lander "
              f"(180, 60) on the card, one CUDA graph of the frame captured at the first: "
              f"{frames} frames in {seconds:.2f} s = {frames / seconds:.3f} frames/s; burn s6 term {burn['term_step']}, flight "
              f"{burn['flight_max_err']:.3g}, obs1 {burn['obs_err_at']['1']:.3g}; nop s2 contact "
              f"{nop['first_contact']}, term {nop['term_step']} {nop['term_reward']}, flight "
              f"{nop['flight_max_err']:.3g}: the gates of tests/test_gym_parity.py hold [{card}]")

        try:
            import Box2D  # noqa: F401
            import gymnasium  # noqa: F401
        except ImportError as e:
            print(f"  (b) live gymnasium: not on this machine ({e}); (a)'s recorded traces "
                  f"stand in for it")
        else:
            t1 = time.perf_counter()
            live = gym_compat.compare_lunar_stepwise("burn", seed=1, device="cuda")
            assert live["term_step"]["gym"] == live["term_step"]["torch"], live
            assert live["flight_max_err"] < 5e-4 and live["obs_err_at"]["1"] < 2e-4, live
            print(f"  (b) live gymnasium burn seed 1 on the card: term {live['term_step']}, "
                  f"flight {live['flight_max_err']:.3g} in {time.perf_counter() - t1:.1f} s")

        # (d) the rigid sweep, speeds as lanes
        t1 = time.perf_counter()
        sweep = impact_sweep_torch(IMPACT_SPEEDS, jointed=False, device="cuda")
        assert sweep == IMPACT_WANT, sweep
        print(f"  (d) rigid impact sweep on the card: {sweep} in "
              f"{time.perf_counter() - t1:.2f} s [{card}]")

        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"{name} exited {proc.returncode}:\n{stdout}\n{stderr}")
            out[name] = stdout.strip().splitlines()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    cpu_burn, cpu_nop = json.loads(out["cpu"][-1])
    for card_res, cpu_res in ((burn, cpu_burn), (nop, cpu_nop)):
        for key in ("term_step", "first_contact", "term_reward"):
            assert card_res[key]["torch"] == cpu_res[key]["torch"], (key, card_res, cpu_res)
        assert abs(card_res["flight_max_err"] - cpu_res["flight_max_err"]) <= 1e-5, (
            card_res, cpu_res)
    print(f"  (a) the same replay on the CPU: terminal and contact steps equal, flight "
          f"{cpu_burn['flight_max_err']:.3g} / {cpu_nop['flight_max_err']:.3g} against the "
          f"card's {burn['flight_max_err']:.3g} / {nop['flight_max_err']:.3g}")

    counts = json.loads(out["curves"][-1])
    lines = [json.loads(line) for line in curve.read_text().splitlines()]
    final = lines[-1]["final"]
    updates = final["global_steps"] // 4 - 63 // 4
    assert "meta" in lines[0] and lines[0]["meta"]["engine"] == "torch", lines[0]
    assert len(lines) == final["episodes"] + 2 and all("episode" in r for r in lines[1:-1])
    # the update's graph: the wrappers count its eager call and capture, the
    # profiler's trace every update on the device
    assert updates > 2 and counts["launches"] == {"td_loss_fwd": 2, "td_loss_bwd": 2}, (
        counts, final)
    assert counts["device"] == {
        "td_loss_fwd": updates, "td_loss_bwd": updates, "per_slot_sample": 0}, (counts, final)
    assert counts["plain"] == {"td_loss_fwd": 0, "td_loss_bwd": 0}, counts
    summary = summarize_engine_curves.main([
        "--curve-dir", str(workdir), "--out-json", str(Path(workdir) / "summary.json"),
        "--out-png", str(Path(workdir) / "summary.png")])
    assert json.loads((Path(workdir) / "summary.json").read_text()) == summary
    assert summary["overlay"]["torch"]["seeds"] == 1, summary["overlay"]
    print(f"  (c) engine_curve_compare --engine torch --env CartPole-v1 in a process of its "
          f"own: {final['global_steps']} env steps, {final['episodes']} episodes, {updates} "
          f"updates, K1/K2 on the device {counts['device']} (the wrappers {counts['launches']}: "
          f"the update graph's eager call and capture; {counts['lost']} kernel launches of the "
          f"process with no record in the trace), no plain call, eval mean "
          f"{final['eval_mean']}; summarize_engine_curves wrote its JSON "
          f"({time.perf_counter() - t0:.1f} s with (a), (b), (d) beside it) [{card}]")
    return {k: counts["device"][k] for k in ("td_loss_fwd", "td_loss_bwd")}


def main() -> int:
    started = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a GPU", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from deep_q_learning_tpu_torch import native
    from deep_q_learning_tpu_torch.ops import (
        build,
        classic_kernels,
        jointed_kernels,
        lander_kernels,
        sample_kernels,
        solver_kernels,
        td_kernels,
    )

    print("phase 2: build")
    t0 = time.perf_counter()
    # one nvcc per source and g++ for the host replay buffer, together
    with ThreadPoolExecutor(max_workers=7) as pool:
        futures = [pool.submit(td_kernels._lib), pool.submit(sample_kernels._lib),
                   pool.submit(solver_kernels._lib), pool.submit(lander_kernels._lib),
                   pool.submit(jointed_kernels._lib), pool.submit(classic_kernels._lib),
                   pool.submit(native.load_library)]
        for fut in futures:
            fut.result()
    print(f"  native/replay_buffer.cc: g++ into {native.build_library().relative_to(REPO)}")
    for source in ("td_loss.cu", "per_sample.cu", "lander_solver.cu", "lander_rigid.cu",
                   "lander_jointed.cu", "classic_envs.cu"):
        print(f"  {source}: nvcc {build.build_seconds.get(source, 0.0):.2f} s (0 = reused a build)")
        for kernel, use in build.ptxas_summary(build.ptxas_reports.get(source, "")).items():
            print(f"    {kernel}: {use['registers']} registers, {use['smem']} B shared, "
                  f"spills {use['spill_stores']} B stored, {use['spill_loads']} B loaded (ptxas)")
            assert use["spill_stores"] == use["spill_loads"] == 0, (kernel, use)
    print(f"  built and loaded in {time.perf_counter() - t0:.2f} s")

    print("phase 3: kernels vs plain on the card")
    from deep_q_learning_tpu_torch.measure import launches_per_superstep

    per_superstep = launches_per_superstep()
    err, times = check_td_kernels(torch, td_kernels, per_superstep, card)
    err["per_slot_sample"], slot_times = check_slot_kernel(
        torch, sample_kernels, per_superstep, card)
    member_err = {"td_loss_fwd": 0.0, "td_loss_bwd": 0.0}
    check_td_members(torch, td_kernels, member_err)
    member_times = time_td_members(torch, td_kernels, card)
    member_times["per_slot_sample"] = check_slot_members(torch, sample_kernels, card)
    member_err["per_slot_sample"] = 0  # dyadic priorities: exact
    solver_err, solver_times, plain_solver_launches = check_solver_kernel(
        torch, solver_kernels, card)
    rigid_err, rigid_times = check_rigid_kernel(torch, lander_kernels, card)
    jointed_err, jointed_times = check_jointed_kernel(torch, jointed_kernels, solver_kernels, card)
    classic_times = check_classic_kernel(torch, classic_kernels, card)

    print("phase 4: lunar_per slice")
    slice_rigid = run_slice(torch, td_kernels, sample_kernels, lander_kernels, card)
    check_learner_vs_cpu(torch, td_kernels)
    torch.cuda.synchronize()

    print("phase 5: lunar_per_scaled(1024) with use_pallas_sampler")
    launches = run_scaled(torch, td_kernels, sample_kernels, lander_kernels, card)

    print("phase 6: the command line on the card")
    (REPO / "build").mkdir(exist_ok=True)
    cli_workdir = tempfile.mkdtemp(dir=REPO / "build")
    run_cli(card, cli_workdir)

    print("phase 7: lunar_jointed_per, the jointed lander")
    t0 = time.perf_counter()
    jointed_launches = run_jointed(torch, td_kernels, sample_kernels, solver_kernels,
                                   jointed_kernels, plain_solver_launches, card)
    check_jointed_frame(torch, card)
    jointed_whole(torch, card)
    print(f"  phase 7 took {time.perf_counter() - t0:.1f} s")

    print("phase 8: the uniform replay and classic control on the card, graphed")
    t0 = time.perf_counter()
    classic_launches = {}
    for preset in CLASSIC_RUNS:
        t1 = time.perf_counter()
        trainer, env_launches = run_classic(torch, td_kernels, sample_kernels, preset, card)
        if trainer.env.batch_reset_cheap:
            classic_launches[f"{trainer.env.kernel}_step"] = env_launches
        if trainer.cfg.env_id in CLASSIC_TOL:  # the lander's step: phases 3, 4 and 7
            check_classic_step(torch, trainer, card)
        if preset == "cartpole_vector":
            eval_pair(torch, preset, trainer._evaluate, trainer.eval_venv, trainer.env_params,
                      trainer.runner.train.online, card)
        print(f"  {preset} took {time.perf_counter() - t1:.1f} s")
    print(f"  phase 8 took {time.perf_counter() - t0:.1f} s")

    print("phase 9: a lunar_per population of 8 members")
    t0 = time.perf_counter()
    population_launches_run = run_population(torch, td_kernels, sample_kernels, lander_kernels,
                                             card)
    population_whole(torch, card)
    check_population_update_vs_cpu(torch)
    run_hpo_cli(card)
    run_hpo_trials(torch, card)
    print(f"  phase 9 took {time.perf_counter() - t0:.1f} s")

    print("phase 10: runs over ranks and rollouts")
    t0 = time.perf_counter()
    rank_err, rank_times = check_rank_shapes(torch, td_kernels, sample_kernels, card)
    rank_launches = run_distributed(torch, td_kernels, sample_kernels, card, cli_workdir)
    shutil.rmtree(cli_workdir, ignore_errors=True)
    print(f"  phase 10 took {time.perf_counter() - t0:.1f} s")

    print("phase 11: the host-compatibility path and the bf16 trunk")
    t0 = time.perf_counter()
    compat_err, compat_times = check_compat_shapes(torch, td_kernels, card)
    compat_launches = run_compat_lander(torch, td_kernels, card)
    run_compat_engines(torch, td_kernels, card)
    bf16_launches, bf16_err = run_bf16(torch, td_kernels, sample_kernels, card)
    print(f"  phase 11 took {time.perf_counter() - t0:.1f} s")

    print("phase 12: the gymnasium harness and its examples")
    t0 = time.perf_counter()
    gym_workdir = tempfile.mkdtemp(dir=REPO / "build")
    curve_launches = run_gym_harness(torch, td_kernels, card, gym_workdir)
    shutil.rmtree(gym_workdir, ignore_errors=True)
    print(f"  phase 12 took {time.perf_counter() - t0:.1f} s")

    print("phase 13: the reference-format scripts")
    t0 = time.perf_counter()
    ref_workdir = tempfile.mkdtemp(dir=REPO / "build")
    try:
        examples_launches = run_reference_format(torch, td_kernels, card, ref_workdir)
    except TraceLost as lost:
        shutil.rmtree(ref_workdir, ignore_errors=True)
        ref_workdir = tempfile.mkdtemp(dir=REPO / "build")
        examples_launches = phase_anew(lost, "run_reference_format", ["td_kernels"],
                                       ref_workdir)
    shutil.rmtree(ref_workdir, ignore_errors=True)
    print(f"  phase 13 took {time.perf_counter() - t0:.1f} s")

    print("phase 14: lunar_jointed_scaled(1024), the jointed lander at bench scale")
    t0 = time.perf_counter()
    try:
        scaled_launches = run_jointed_scaled(torch, td_kernels, sample_kernels, solver_kernels,
                                             jointed_kernels, card)
    except TraceLost as lost:
        scaled_launches = phase_anew(lost, "run_jointed_scaled", [
            "td_kernels", "sample_kernels", "solver_kernels", "jointed_kernels"])
    print(f"  phase 14 took {time.perf_counter() - t0:.1f} s")

    # ms and bound at B=256 for the TD kernels (lunar_per, lunar_jointed_per)
    # and at (1024, 512, 1024) for the slot kernel (lunar_per_scaled);
    # launches of the TD kernels from phase 7, of the slot kernel from phase 5.
    # The same kernels with a member axis ("[members]"): ms and bound at
    # phase 9's shapes, (8, 256, 4) and (1024, 4096, 2048), launches in the
    # profiler's trace of phase 9's profiled superstep (graph L's replays).
    # No single PyTorch call computes any of the three: library_ms is null
    from deep_q_learning_tpu_torch.ops import bound_by, bound_us

    # J1: ms, bound and error at lunar_jointed_per's 128 landers (phase 3),
    # launches from phase 7's profiled superstep; "[jointed_scaled]": the
    # kernels on phase 14's path (K1/K2 at B = 1024, K3 at (1024, 512, 1024),
    # J1 at N = 1024 from phase 3), launches from phase 14.  S1: ms, bound and
    # error of its own kernel at the same N (phase 3); on these paths its body
    # runs inside J1 and it launches no kernel of its own: its "launches" are
    # the 0 that phases 7 and 14 count, and "inside" names J1, whose entry
    # counts the launches that ran S1's body.  No single PyTorch call
    # computes S1 or J1 either
    # R1: ms, bound and error of its vector step (the entry the main path
    # launches at every vector step; the reset pool's frame is the 129th
    # launch) at lunar_per's 128 landers with the time feature (phase 3),
    # launches from phase 4's profiled superstep; "[members]": at the
    # population's 8 x 128 landers, one call of 1024 (phase 3), launches
    # from phase 9's.  No single PyTorch call computes R1 either
    # A1, C1, M1: ms, bound and error of the vector entry (what the preset
    # launches at every vector step) at the preset's N (phase 3), launches
    # from phase 8's traced steady superstep of the preset.  No single
    # PyTorch call computes an env's step either
    timed = dict(times[256], per_slot_sample=slot_times[SLOT_SHAPES[0]],
                 assembly_step=solver_times[128, 120, 40],
                 lander_rigid_step=rigid_times[128, "vector"],
                 lander_jointed_step=jointed_times[128, "step"],
                 **{f"{key}_step": t for key, t in classic_times.items()})
    launches = dict(launches, **jointed_launches, lander_rigid_step=slice_rigid,
                    **classic_launches)
    for run_launches in (launches, scaled_launches):
        assert run_launches["assembly_step"] == 0, run_launches
    err["assembly_step"] = solver_err[128]
    err["lander_jointed_step"] = jointed_err
    err["lander_rigid_step"] = member_err["lander_rigid_step"] = rigid_err
    err.update({f"{key}_step": 0.0 for key in CLASSIC_KERNELS})  # bitwise at every N
    member_times["lander_rigid_step"] = rigid_times[1024, "vector"]
    scaled_timed = dict(times[1024], per_slot_sample=slot_times[SLOT_SHAPES[0]],
                        assembly_step=solver_times[1024, 120, 40],
                        lander_jointed_step=jointed_times[1024, "step"])
    scaled_err = dict(err, assembly_step=solver_err[1024])
    kernels = {
        "td_loss_fwd": (TD_SOURCE, "deep_q_learning_tpu/ops/td_kernels.py:48"),
        "td_loss_bwd": (TD_SOURCE, "deep_q_learning_tpu/ops/td_kernels.py:97"),
        "per_slot_sample": (PER_SOURCE, "deep_q_learning_tpu/ops/sample_kernels.py:52"),
        "assembly_step": (SOLVER_SOURCE, "deep_q_learning_tpu/envs/lander_solver.py:305"),
        "lander_rigid_step": (RIGID_SOURCE, "deep_q_learning_tpu/envs/lunar_lander.py:630"),
        "lander_jointed_step": (JOINTED_SOURCE, "deep_q_learning_tpu/envs/lunar_lander.py:521"),
        **{f"{key}_step": (CLASSIC_SOURCE, replaces)
           for key, (_, replaces, _) in CLASSIC_KERNELS.items()},
    }
    tpu_kernels = ("td_loss_fwd", "td_loss_bwd", "per_slot_sample")
    lander = ("td_loss_fwd", "td_loss_bwd", "per_slot_sample", "lander_rigid_step")
    # The kernels at a rank's shapes in phase 10 (b) ("[rank]": K1/K2 at
    # B = 128, K3 at (64, 8192, 128)): ms and bound at those shapes, launches
    # on the device in rank 0's traced steady superstep there (graph L1's
    # replays).
    # The TD kernels on phase 11's paths: "[compat]", the host agent's update
    # at (64, 4) (ms and bound there, launches on the device in (a)'s traced
    # episode: the update graph's replays); "[curves]", phase 12 (c)'s
    # engine_curve_compare on CartPole (ms, bound and error at (64, 2) from
    # phase 11, launches on the device in 12 (c)'s trace); "[bf16]", the bf16
    # learner's, which feeds them lunar_per's f32 shapes (ms and bound at
    # B = 256 from phase 3, launches and error of (d)); "[examples]", phase 13
    # (b)'s train_lunar_lander, lunar_per's learner (ms, bound and error at
    # B = 256 from phase 3, launches of (b)).
    td_only = ("td_loss_fwd", "td_loss_bwd")
    runs = [("", launches, err, timed, kernels), ("[members]", population_launches_run, member_err,
                                                  member_times, lander),
            ("[rank]", rank_launches, rank_err, rank_times, tpu_kernels),
            ("[compat]", compat_launches, compat_err[COMPAT_SHAPES[0]],
             compat_times[COMPAT_SHAPES[0]], td_only),
            ("[curves]", curve_launches, compat_err[CURVE_SHAPE], compat_times[CURVE_SHAPE],
             td_only),
            ("[bf16]", bf16_launches, bf16_err, times[256], td_only),
            ("[examples]", examples_launches, err, times[256], td_only),
            ("[jointed_scaled]", scaled_launches, scaled_err, scaled_timed, tpu_kernels + (
                "assembly_step", "lander_jointed_step"))]
    record = {"kernels": [
        {
            "name": name + suffix,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": run_launches[name],
            "max_abs_err": run_err[name],
            "ms": run_timed[name][0],
            "plain_ms": run_timed[name][1],
            "bound_ms": bound_us(run_timed[name][2]) / 1e3,
            "bound_by": bound_by(run_timed[name][2]),
            "library_ms": None,
            **({"inside": "lander_jointed_step"} if name == "assembly_step" else {}),
        }
        for suffix, run_launches, run_err, run_timed, names in runs
        for name, (source, replaces) in kernels.items() if name in names
    ]}
    print(f"chip_smoke: all phases passed in {time.perf_counter() - started:.1f} s [{card}]")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
