#!/usr/bin/env python3
"""Smoke run of ray_tpu_torch on one NVIDIA GPU: build, check, serve, train,
data, cluster, RLlib, Train, MoE, the compiled DAG, Tune, workflow, the
multi-node plane, the ray:// client, the optional planes (QoS, profile)
and the ops layer (state, dashboard, snapshot, jobs, the CLI), and the
perf sections (decode, the train step's time sinks, the serving and
head-bypass A/Bs, Data ingest), and sharded training across 4 rank
processes on the card (the ring, the train step, MoE, the pipeline).

    python3 chip_smoke.py            # one card; 0 only if every phase passed
    python3 chip_smoke.py --kernels  # build, device and every kernel's
                                     # checks and times; no ok line
    python3 chip_smoke.py --phase perf [ops multinode ...]
                                     # build, device and the named later
                                     # phases alone; no ok line

Phases, each printing one JSON line:

  1. build   — compile every CUDA kernel of the port from ray_tpu_torch/ops/csrc
               with nvcc (sm_90a), into ray_tpu_torch/_build/; then check
               that the bf16 kernels (kernel 2, kernels 3a-3c) are the
               wgmma + TMA design: HGMMA and UTMALDG in each instance's
               SASS, no spills, the registers setmaxnreg needs; and that
               kernel 1's split kernel copies its pages on the bulk-copy
               engine (UBLKCP in its SASS) and neither of its kernels
               spills (phase build_sm90).
  2. device  — the card as nvidia-smi reports it (name, power limit).
  3. kernel  — each kernel against its plain PyTorch version at its main
               path's shapes, with its time, the plain version's, one PyTorch
               library call's as a yardstick, and the least time the card could
               take (the bound). Paged attention (kernel 1, a split kernel
               and a merge kernel) at small shapes (group 1-8, page 8-32,
               lengths at the splits' edges, 16 and 7 pages per sequence,
               several pages per split) and at the serving shapes (64
               sequences, 8 query / 4 KV heads, head_dim 128, page 16, 16 pages
               per sequence, 1024 pages, bf16 and f32 pages): two launches
               bit-identical, the per-layer calls captured in a CUDA graph,
               device time from its replays; the three flash
               attention kernels (forward, dq, dk/dv) at the train shapes
               (batch 16, 16 heads, seq 2047, head_dim 128, causal, bf16) and
               once in f32 at batch 2, each of their outputs held to its own
               bound, element by element and as a whole, and two launches of
               each bf16 kernel on the same inputs bit-identical. Ring
               attention's
               block kernel (kernel 2) at the ring phase's shapes (q [1, 16,
               8192, 128], k/v [1, 8, 8192, 128], bf16) on its three kinds of
               block — the diagonal, one below it (every key visible) and one
               above it (no key visible, checked for exact zeros) — and at
               small ragged shapes with odd offsets, causal and not, GQA and
               MHA, in f32 and bf16; o, m and l each held to their bounds.
               Kernels 1 and 2 at the head widths between the built ones
               (ANY_WIDTHS, 8 to 200, each on its class's library): kernel
               1 over pages 4 and 16 and where a page's tile is not whole
               16-byte units (PAGED_ROWWISE), kernel 2 on the small blocks
               under each launch and on a ring's three kinds of block, also
               at RING_PADDED (3 and 99 in f32, 99 in bf16: rows not whole
               16-byte units, so the call's zero-padded copy), both dtypes, two bf16 launches bit for bit; at ANY_TIMED (80, 96,
               100, 112, 192) both timed at Phi-3-mini's path shapes, eager
               and by graph replay, beside SDPA and the bound at the true
               width (100: kernel 2 through its zero-padded copy).
               The scheduler (phase sched_kernel, ops/csrc/scheduler_tick.cu):
               the CUDA tick stepped from the start on each BASELINE graph at
               full size (1M-task fan-out, 64 waves of 1M tasks, map_reduce,
               pipeline, actor_heavy, ppo, fanout) and held tick by tick to
               the plain tick on the card, every output equal; assign with 64
               classes, masks and SPREAD classes, and the gang pack, equal to
               their plain versions and the numpy oracle. The build check
               asks each scheduler kernel for no spills.
  4. engine  — the serving engine at the full width of the serving model
               (vocab 32000, d_model 1024, 8 layers, 127M parameters, bf16,
               random weights from a seed): 64 requests x 128 new tokens, a warm
               round and a timed round. The launch counters are zeroed just
               before the timed round; every layer of every decode step must have
               launched the paged-attention kernel. A third round runs under
               torch.profiler: device time by kernel and the device's busy share.
               Then the same load on the default config (head_dim 64) and on
               Phi-3-mini-4k's published widths (PHI3_MINI: vocab 32064,
               d_model 3072, 32 layers, 32 / 32 heads of 96, d_ff 8192,
               3.72B parameters, kernel 1 on its 128 class), and the other
               widths' models at 8 x 32 tokens.
  5. parity  — the same width in f32 (TF32 off): the engine's greedy tokens must
               equal the full-context model's, re-run each step without the
               kernel; a mismatch passes only at a true near-tie (top-2 gap
               below 1e-3). Also the default config and Phi-3-mini's widths
               at 2 layers.
  6. train_parity — the model's flash branch against its einsum branch at
               the train width (below), batch 2, one forward and backward on
               the same params and tokens, in f32 and bf16: loss, gradient
               norm and the worst parameter's gradient within bounds, and
               every layer launched the three flash kernels.
  7. train   — the flagship train configuration at full width and depth
               (vocab 32768, d_model 2048, 8 layers, 16 query / 8 KV heads,
               d_ff 5632, ~445M parameters, bf16, remat "dots", AdamW; random
               weights and tokens [16, 2048] from seeds) through
               models.train_step's make_optimizer and make_train_step: two
               warm steps, then 5 timed steps with the flash launch counters
               zeroed just before; every loss finite, the last below the
               first, and every layer of every step launched the three flash
               kernels. One more step runs under torch.profiler. Then the
               same with its heads regrouped as 8 x 256 (TRAIN_D256), at
               the same batch, steps and profile.
  8. ring    — sequence parallelism: the train configuration's width and depth
               at 32768 tokens (batch 1, bf16, max_seq_len 32768) through
               models.train_step.make_forward under use_mesh with a seq=4
               mesh on [cuda:0] * 4 (8192 tokens per shard): a warm call, then
               a timed call with kernel 2's launch counter zeroed just before
               (8 layers x 16 blocks). Its logits against the same model's
               flash branch (no mesh), and in f32 at 4096 tokens against the
               einsum branch; the first three shards' logits bit-identical
               when the last shard's tokens change; a call under autograd
               raises (kernel 2 has no backward). One more call runs under
               torch.profiler. Then each other width's model through the
               same mesh against its einsum branch: the default config at
               8192 tokens, Phi-3-mini's widths at 8 layers and 4096 tokens
               (1024-token shards, kernel 2 on its 128 class, 8 x 16
               launches), the 16-, 32- and 256-wide models at 2048.
  9. north_star — the scheduler's main path: every BASELINE graph driven to
               completion through benchmarks.run_graph (one Drive, eager and
               then captured in a CUDA graph: device ms per replay, host ms
               to the fetched tick count) and a gang batch through
               pack_many_tiered, with the launch counters zeroed just before
               and checked just after; beforehand two drives bit-identical,
               the reference's tick counts, avail back at cap, and equal to
               the plain drive on the card. One line per graph, then the 1M
               fan-out's time against the north star's 10 ms.

 10. runtime — the port's runtime core on the scheduler's main path
               (phase_runtime): BASELINE.json's configs through
               ray_tpu_torch.init / remote / get with the TensorScheduler
               assigning on the card (kernels.assign on its own CUDA
               stream): the 2.5k fan-out under sched_backend cuda, numpy
               and auto, unbatched and through map_remote, assign's
               counter against the scheduler's device assigns; every
               snapshot of a checking fan-out replayed through the numpy
               oracle assign_np; the 5k map-reduce; 1k actors x 10
               calls in call order; an engine actor (num_gpus=1) at
               serve-127M whose greedy tokens equal a direct engine's,
               with assign's times alone and beside it; the GPU count in
               cluster_resources; and the numpy / cuda crossover of
               TensorScheduler._assign that sets sched_device_min_batch.
 11. process — process mode (phase_process): ray_tpu_torch.init with
               worker_mode "process", 8 exec'd workers, the TensorScheduler
               assigning on the card and leasing each batch to the workers:
               start-up; every worker loads no jax, flax or ray_tpu module
               and sees no card; the 2.5k fan-out unbatched and through
               map_remote, a 5k map-reduce, 16 actor processes x 100
               calls, each with tasks/s, assign's counter equal to the
               scheduler's device assigns and every snapshot equal to
               assign_np; a 64 MiB tensor put, reduced by a worker and read
               back by the driver as a view inside the arena that holds its
               pin; a CUDA tensor put back as an equal CPU tensor; 3 x 32
               MiB through a 64 MiB arena, spilled and restored exactly;
               and, under worker_gpu_access, an engine actor (num_gpus=1) at
               serve-127M in its own process: its greedy tokens equal a
               direct engine's, its own kernel-1 launches = 8 x its decode
               steps, its time alone and beside a 2.5k fan-out, its process
               in nvidia-smi, and after ray.kill and shutdown the process
               gone and the card's memory back.
 12. serve   — Serve on the runtime (phase_serve): ray_tpu_torch.init (8
               workers, scheduler "tensor"), the serving model at full width
               in bf16, its parameters shared by every replica. The mono app
               (build_llm_app, one replica) and the split pools
               (run_disagg_llm, one prefill and one decode replica): a warm
               round, then 64 concurrent streams x 128 tokens through the
               SSE driver path, with TTFT and latency per request, tokens/s,
               the engine's max_concurrent, and kernel 1's launches zeroed
               before each timed round: 8 layers x the decode engines'
               decode steps. A JSON and an SSE request through start_http;
               a profiled mono round (device busy share, kernel 1's share);
               16 follow-up turns on the sessions the decode replica's KV
               cache holds, each an affinity hit and a cached replay with
               kv_bytes unchanged; phase parity's prompts in f32 through
               both apps under phase parity's rule; after each
               serve.shutdown() no engine thread or object is left and the
               card's bytes are back.

 13. data    — Ray Data on the runtime (phase_data), the TensorScheduler
               assigning on the card: BASELINE config 3
               (perf.data_pipeline_throughput, cut from 100k to 5k blocks x
               10 rows, after a warm pass of 1k blocks) in thread mode with
               blocks/s, rows/s,
               the stages and the exact count; a checking run of 2k blocks
               whose rows are exact and whose every snapshot equals
               assign_np; the same in process mode at 2.5k blocks (the cut),
               no worker loading jax, flax or ray_tpu; random_shuffle(seed=0)
               over 20k rows in 200 blocks through the port's native
               exchange library, a permutation and the same order twice;
               iter_torch_batches(batch_size=4096, device="cuda") over a 1M-row
               int64 column, every batch on the card and the sum exact.
               kernels.assign's counter zeroed just before each timed run,
               equal to its device assigns and > 0.
 14. cluster — the local virtual cluster (phase_cluster): a Cluster head
               (2 CPUs, TensorScheduler on the card) and five process nodes
               of 4 CPUs and 2 workers: remove_node while 200 tasks of 50
               ms run (results exact, the node DEAD, every snapshot after
               the removal equal to assign_np with no task on the dead row);
               kill_worker_processes on another node (DEAD within the
               health check's budget, results exact); a soft-pinned actor
               restarting off a removed node; a 4-CPU placement-group
               bundle moving off one; the Autoscaler against a 1-CPU head
               (12 x 0.4 s tasks: an upscale, then a downscale once idle);
               after shutdown no worker process alive.
 15. rllib   — RLlib on the runtime (phase_rllib), 8 workers, the
               TensorScheduler assigning on the card: BASELINE config 5
               (perf.rl_rollout_throughput: IMPALA, 4 runners x 8 envs x
               64 steps, 8 updates an iteration, the V-trace learner on
               the card) with env-steps/s, learner ms an update and the
               return, kernels.assign's counter zeroed just before and
               equal to its device assigns, every snapshot equal to
               assign_np; PPO on CartPole (the reference's learning
               test) to 1.5 x max(first, 20) within 17 iterations, then
               a runner killed and one more iteration; one iteration each
               of config 5 and of that PPO under torch.profiler (the
               device's busy share); one PPO update on the card against
               the CPU (TF32 off) within 1e-5, both timed; process mode (8 workers): PPO's first batch
               bit-identical to thread mode's, no runner process with
               jax, flax or ray_tpu or a card, the learner on the card;
               IMPALA, APPO, DQN and SAC iterations with finite losses.
 16. train_lib — Train on the runtime (phase_train_lib): a Trainer whose
               loop trains the flagship configuration (445M, bf16, remat
               "dots"; the batch cut to [4, 2048]) 4 steps through
               make_optimizer / make_train_step, saving model and AdamW
               state with save_torch_checkpoint after step 1, failing at
               step 2 and resumed by FailureConfig(max_failures=1): the
               resumed losses within 1e-6 of an uninterrupted run, the
               checkpoint's bytes, save and load seconds, the flash
               launches (3 kernels x layers x steps) and assign's; then
               a 2-worker Trainer's get_dataset_shard over 10k rows,
               disjoint and whole.
 17. moe     — the Switch MoE at the flagship's width (phase_moe): phase
               train's configuration with moe=True (8 experts, capacity
               factor 1.25, ~1.64B parameters), bf16, remat "dots", the
               batch cut to [4, 2048] (dispatch grows as T²), through
               make_optimizer / make_train_step: one MoE layer at this
               shape in f32 on the card against the CPU (dispatch
               identical, max abs error within 1e-4); a warm step; a
               no-grad forward on the first timed step's params and batch,
               whose cross-entropy + 0.01 x its aux terms must equal that
               step's loss within 1e-5; 4 timed steps with the flash
               counters zeroed just before (64 / 32 / 32), losses finite
               and falling; step ms, tokens/s, peak memory, each layer's
               dropped share and the device's busy share (no MFU: 6·N
               would count all 8 experts).
 18. dag     — the compiled DAG (phase_dag): preprocess -> the serve-127M
               forward (bf16, [8, 512]) -> argmax, interpreted, compiled
               direct and compiled fused (one CUDA graph, replayed):
               tokens equal, logits within 1e-6 rel L2, flash_fwd's
               counter 8 an interpreted or direct execute, 16 for the
               fused first execute, 0 a replay; ms per execute each way; a
               diamond runs its shared model once; an actor holding the
               model runs the direct path; a node that syncs the host
               raises DAGCaptureError naming it.
 19. tune    — Tune on the card (phase_tune): trials train a 2-layer
               model (head_dim 128): ASHA over lr x seed (8 trials, 4 at
               a time, at least one stopped), PBT whose checkpoints hold
               CUDA tensors (an exploited trial's state bit-equal to its
               donor's checkpoint), Tuner.restore re-running only the
               trials whose results were lost; every trial's tensors on
               the card; the flash launches = the steps run x 2 layers.
 20. workflow — a workflow of steps on the card, interrupted and resumed
               (no journaled step runs again, the result equal to the
               direct computation), and 512 CUDA tensors through a
               util.queue.Queue from a producer task to a consumer task,
               in order (items/s).
 21. multinode — the multi-node plane (phase_multinode): a thread-mode
               head on the card's scheduler and three node daemons over
               localhost TCP (two CPU nodes, one GPU node): registration
               seconds with no torch, jax or CUDA in a daemon; a 2.5k
               fan-out; nested tasks admitted on their node (head-skip
               share >= 0.9); a 64 MiB object pulled node to node and to
               the head, both arenas freed after; locality on and off;
               p2p actor calls; the serve-127M engine actor on the GPU
               node (tokens equal to a direct engine's, kernel 1 = 8 x
               its decode steps in its process); a machine death and a
               link flap under load, every task once; a ray:// client
               process whose task runs the serve-127M forward on the
               head's card (flash_fwd 8, argmax equal to the driver's);
               assign's launches = device assigns and every snapshot
               equal to assign_np in every part.
 22. ops     — the optional planes and the ops layer (phase_ops, see OPS_*).
               qos: a process-mode head (2 workers, the card's scheduler,
               worker_gpu_access, GPU: 1) with qos (prod 3 : batch 1, grace
               0.3 s) and profile_hz, and one remote CPU node; a batch task
               (tier 0) trains phase tune's model on the card until a gate
               opens; a prod task (tier 5) preempts it, its lease coming
               from the kill (the killed process's memory back within 64
               MiB before the prod task touches the card), decodes phase
               multinode's prompts on serve-127M (tokens equal to a direct
               engine's, kernel 1 = 8 x its decode steps) and returns while
               the gate is closed; the retry's flash launches = 2 layers x
               its steps; one mark a key; the preemption in the plane's
               stats, state.list_tenants and the metrics. profile: a 2 s
               profile() window during the decode holds the prod task's
               label; list_utilization has both nodes on the head's clock.
               state: list_tasks (plain, detail), list_actors,
               list_objects, list_nodes, list_tenants, task_timeline and
               list_traces agree with what ran, and the dashboard's /api/*
               endpoints serve the same rows. fair: thread mode, one slot
               held by a gate, 2 tenants x 24 tasks at two tiers: the
               completion order equals the QoS plane's own. snapshot:
               num_gpus tasks pending at snapshot_cluster resolve under
               their ids after restore_cluster in a fresh init, equal to a
               direct run. cli: start --head, start --address, status,
               job (serve-127M's forward on the head's card over ray://,
               flash_fwd 8, tokens equal), timeline, trace and profile as
               subprocesses; after SIGTERM no process is left and the
               card's memory is back. assign launches = device assigns
               and every single-tier snapshot equal to assign_np.
 23. perf    — the rest of ray_tpu_torch/_private/perf.py (phase_perf, see
               PERF_*), each section through its public function with the
               launch counters zeroed just before and read just after:
               llm_decode_throughput at 64 and 128 slots (serve-127M, 128
               new tokens; tokens = slots x 128, kernel 1 = 8 x the decode
               steps, the reference's parameter count); model_time_sinks
               of the flagship step at batch 8 x 2048, top 5 and every op
               (the reference's form; the three flash kernels among the
               ops by their device names; flash 48 / 24 / 24 a call);
               serving_ab mono and split (the reference's tiny A/B model
               widened to head_dim 128 for kernel 1; equal tokens, 16
               streams, split affinity >= 0.8, kv_bytes > 0, no sheds,
               kernel 1 launched in each arm); head_bypass_ab on, off and
               default (every total 40 and n_submit 24; on: >= 35 calls
               peer to peer, no fallback, >= 24 dispatched on the node;
               off: none); data_ingest_overlap (rows exact, the streaming
               first batch sooner); the Arrow sections at the reference's
               defaults (256 MB map, 128 MB shuffle, 64 MB join), printed
               as skipped only where pyarrow is not installed.

 24. sharded — sharded training on torch.distributed (phase_sharded, see
               SHARDED_*): the parent computes phase ring's single-process
               logits, one process's first train loss and the pipeline's
               sequential run, then starts 4 rank processes on the card
               (init_multihost over a file:// rendezvous: gloo, since the
               ranks share one device), each with a deadline; a rank that
               dies or hangs fails the phase, and no rank may load jax,
               flax or ray_tpu. Each rank runs: the ring (make_forward at
               1 x 32768 tokens, the train configuration, bf16) under a
               rank mesh of seq=4 and of seq=2 x tensor=2, its logits
               against phase ring's within RING_PARITY_BOUNDS and kernel
               2's launches from zero = layers x its ring's size; the
               sharded train step (init_sharded + make_train_step on
               data=2 x tensor=2, tokens [4, 2048], 3 steps): losses
               finite, the first within 2e-3 of one process's, wq sharded
               on heads and the embedding on vocab over tensor and both
               kept by the steps, no flash launch (the reference's rule
               under a mesh); one MoE layer of phase moe's configuration
               at [4, 2048] tokens on expert=4, f32 with TF32 off, against
               the per-shard moe_ffn_reference within 1e-4; and
               pipeline_forward of 4 stages (one flagship Block each, f32)
               over M=4 microbatches of [2, 2048], its outputs and stage
               gradients against the sequential run. Each part's seconds
               and the bytes each collective moved and staged through the
               host.
 25. lint    — raylint and its runtime mirror (phase_lint): (a) python -m
               ray_tpu_torch lint --json over this checkout in a
               subprocess: ok, the eight passes, no stale suppression;
               each pass's seconds and the static lock graph's edge count.
               (b) the sanitizer armed before init, then the serving path
               through the runtime: the engine actor of phase runtime at
               serve-127M (bf16) answers LINT_PROMPTS requests, its tokens
               equal to a direct engine's, kernel 1's counter zeroed just
               before and > 0 just after; then one process-mode round of
               LINT_ARENA_PUTS arena-sized results (1.6 MB each). After
               each shutdown the report is clean: no lock inversion
               against the static graph, no wire frame off the schema
               compiled from the channel table, no leak, and the shm
               ledger filled and drained. The line lists the observed
               lock edges and the uncharted count.
Then the kernel table as one JSON line (kernel 1's launches: the Serve
path's, mono and split, with phase engine's beside them; kernel 2's with
phase sharded's ranks' beside them), the nvidia-smi line, and last
{"ok": true, "device": {...}}. Without a CUDA device, or without the
ray_tpu_torch package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, dense bf16
# tensor-core rate, f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

SERVE = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=8,
             n_kv_heads=4, d_ff=2816, max_seq_len=2048)
SLOTS, PAGE, MAX_PAGES, NUM_PAGES, NEW_TOKENS = 64, 16, 16, 1024, 128
# paged attention against its plain version: max abs error over the f32
# output (both accumulate in f32 from the same values; the kernel sums in
# another order and uses exp2 with the scale folded into q). The small
# shapes, both dtypes, 2 KV heads, 8 sequences: (group, page, pages per
# sequence), the latter 16 or 7 (which 2 and 3 pages per split do not
# divide); page 4 is the serving A/B's (phase perf). The serving shape's
# device time is also taken at each of PAGED_SPLITS pages per split
PAGED_TOL = 1e-4
PAGED_SWEEP = tuple((G, page, MP) for G in (1, 2, 4, 8)
                    for page in (4, 8, 16, 32) for MP in (16, 7))
PAGED_SPLITS = (1, 2, 4, 8, 16)

# the repo's training configuration (the defaults of model_mfu,
# ray_tpu/_private/perf.py)
TRAIN = dict(vocab_size=32768, d_model=2048, n_layers=8, n_heads=16,
             n_kv_heads=8, d_ff=5632)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = 16, 2048, 2, 5
# flash kernel checks: the train step's attention call ([B, S-1, H, D] in
# the model's layout, causal) in bf16, and in f32 at a smaller batch
FLASH_H, FLASH_S, FLASH_D = 16, TRAIN_SEQ - 1, 128
FLASH_BATCH = {"bfloat16": TRAIN_BATCH, "float32": 2}
# each output of each kernel against its plain version's, element by element,
# |kernel - plain| <= rtol * |plain| + atol * (rms of the plain output's row:
# its head_dim values, or for lse one head's values over the sequence; at
# least a tenth of the whole output's rms, as dq's row 0, which sees only
# its own key, is 0 up to rounding), and as a whole,
# ||kernel - plain|| / ||plain|| <= rel_l2: (rtol, atol, rel_l2).
# The plain versions keep f32 throughout. bf16: the kernels round P and dS
# to bf16 before their second products and round their outputs to bf16
# (2^-8 relative each); f32: the same values summed in another order. lse
# is f32 in both. PERF.md gives the readings of sound and of broken kernels.
FLASH_BOUNDS = {"bfloat16": (2 ** -6, 2 ** -6, 2 ** -7),
                "float32": (2e-5, 2e-5, 1e-5)}
LSE_BOUNDS = (1e-5, 1e-5, 1e-6)
# small ragged shapes, both dtypes, causal and not: (batch, heads, seq). 37
# is shorter than any tile; 333 ends inside a 64- and a 128-row tile
FLASH_SMALL = {"seq37": (2, 3, 37), "seq333": (1, 4, 333)}
FLASH_OUTPUTS = {"flash_fwd": ("o", "lse"), "flash_bwd_dq": ("dq",),
                 "flash_bwd_dkv": ("dk", "dv")}
# the model's flash branch against its einsum branch at the train width:
# one forward and backward at batch 2 (the einsum path's [B, H, S, S]
# scores fit), remat "dots", same params and tokens. Bounds on |loss
# difference|, the relative difference of the global gradient norm, and the
# largest relative L2 gradient difference of any one parameter
TRAIN_PARITY_BATCH = 2
TRAIN_PARITY_BOUNDS = {"float32": (1e-5, 1e-5, 1e-4),
                       "bfloat16": (1e-3, 2e-3, 6e-2)}
FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

# ring attention: the train configuration at 32768 tokens on a seq=4 mesh of
# one card, 8192 tokens per shard. The path's three kinds of block, as
# (q_offset, k_offset): shard 1 against its own keys, shard 2 against shard
# 0's (every key visible) and shard 0 against shard 3's (none visible)
RING_SEQ, RING_SHARDS = 32768, 4
RING_T = RING_SEQ // RING_SHARDS


def ring_blocks(T):
    """The three kinds of block of T-token shards, as (q_offset,
    k_offset): shard 1 against its own keys, shard 2 against shard 0's
    (every key visible) and shard 0 against shard 3's (none visible)."""
    return {"diagonal": (T, T), "full": (2 * T, 0), "masked": (0, 3 * T)}


RING_BLOCKS = ring_blocks(RING_T)
# small blocks, f32 and bf16: (heads, kv heads, Tq, Tk, q_offset, k_offset,
# causal). "late_keys": the first query tile sees no key at all, and row 64,
# the first of the second tile, sees none while the rest of its tile does
RING_SMALL = {"odd_gqa": (16, 8, 333, 200, 101, 37, True),
              "late_keys": (16, 8, 300, 129, 5, 70, True),
              "non_causal_mha": (8, 8, 257, 190, 3, 11, False)}
RING_SMALL_BATCH = 2
# kernel 2's and SDPA's calls captured in one CUDA graph to time them by
# replay; the kernels line's kernel-2 rows carry these of the full block
# beside the eager times
RING_GRAPH_CALLS = 20
RING_ROW_KEYS = ("graph_ms", "library_graph_ms", "splits", "blocks")
# kernel 2's o (f32, unnormalised) is held to FLASH_BOUNDS: in bf16 it rounds
# P to bf16 before P v, as the flash forward does. m and l are f32 in both
# dtypes, from scores whose bf16 products are exact in f32: the same sums in
# another order, so lse's bounds. Rows with no visible key must read exactly
# o = 0, m = -1e30, l = 0
RING_ML_BOUNDS = LSE_BOUNDS
# ring logits against the model's other branches, relative L2 over all
# logits: bf16 against the einsum branch, and at head_dim 128 also the flash
# branch (each rounds P and its attention output to bf16 at other points,
# then 8 layers of bf16 activations); f32 (TF32 off) against the einsum
# branch at RING_F32_SEQ tokens (the same values summed in another order)
RING_PARITY_BOUNDS = {"bfloat16": 2 ** -5, "float32": 1e-5}
RING_F32_SEQ = 4096
# the train configuration's bf16 ring logits are held to the einsum branch
# over their first RING_REF_SEQ tokens (causal: the same logits): shard 0
# and a quarter of shard 1, so the diagonal and the full kind of block.
# The einsum branch's f32 scores over all 32768 tokens would take 64 GB a
# buffer
RING_REF_SEQ = RING_T + RING_T // 4

# head widths (ray_tpu_torch/ops/head_dims.py): each kernel is held to its
# plain version at each of its widths in both dtypes, timed at each width
# (kernel 1 at the serving shape, kernel 2 on the three kinds of block of
# its ring path's shards, the flash kernels at the 8 x 256 train shape),
# and driven at each width on a path:
# - the default TransformerConfig() (vocab 32000, d_model 512, 4 layers,
#   8 / 4 heads: head_dim 64, bf16), served as SERVE is (SLOTS x
#   NEW_TOKENS, phase engine) with its f32 greedy parity (phase parity),
#   and its forward at DEFAULT_RING_SEQ tokens over RING_SHARDS (phase
#   ring) against the einsum path;
# - the flagship's train configuration with its heads regrouped as 8 x 256
#   (4 KV heads: the same parameters and memory), TRAIN_D256, trained
#   TRAIN_D256_STEPS steps at [TRAIN_D256_BATCH, TRAIN_SEQ] after
#   TRAIN_D256_WARMUP (phase train) and held flash branch against einsum
#   branch in f32 and bf16 (phase train_parity);
# - the widths no other path runs, each on a configuration of the repo
#   (width_models: the smoke decode model, 16; the smoke model, 32; the 8 x
#   256 model, 256): served, WIDTH_SLOTS x WIDTH_NEW tokens (phase engine),
#   and its ring forward at WIDTH_RING_SEQ tokens (phase ring). The
#   serving A/B of phase perf runs the reference's head_dim-16 model.
# Kernel 2 is timed at each width on the blocks its ring path gives it
# (ring_path_shapes)
DEFAULT_RING_SEQ = 8192
TRAIN_D256 = dict(TRAIN, n_heads=8, n_kv_heads=4)
TRAIN_D256_BATCH, TRAIN_D256_WARMUP, TRAIN_D256_STEPS = (
    TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS)
# the flash kernels at 256 (phase kernel): the train path's shape, and
# bf16 also at batch 8, where PERF.md's earlier times at 256 were taken
FLASH_D256_BATCH = {"bfloat16": TRAIN_D256_BATCH, "bfloat16@batch8": 8,
                    "float32": FLASH_BATCH["float32"]}
WIDTH_SLOTS, WIDTH_NEW, WIDTH_RING_SEQ = 8, 32, 2048
DEFAULT = {}   # TransformerConfig()'s own fields
# Phi-3-mini-4k's published widths (microsoft/Phi-3-mini-4k-instruct,
# config.json: vocab_size 32064, hidden_size 3072, num_hidden_layers 32,
# num_attention_heads 32, num_key_value_heads 32, intermediate_size 8192,
# max_position_embeddings 4096, rope_theta 10000, rms_norm_eps 1e-5)
# through the repo's own TransformerConfig, and nothing else of the model:
# head_dim 96 (kernels 1 and 2 on their 128 class), group 1, 3.72B
# parameters (the published 3.82B less the untied output head: the repo's
# model reads its logits off the embedding), seeded random weights.
# Served (phase engine) at SLOTS x NEW_TOKENS and all 32 layers; its f32
# greedy parity (phase parity) at PHI3_PARITY_LAYERS; its ring forward
# (phase ring) at PHI3_RING_SEQ tokens over RING_SHARDS (1024-token
# shards) at PHI3_RING_LAYERS
PHI3_MINI = dict(vocab_size=32064, d_model=3072, n_layers=32, n_heads=32,
                 n_kv_heads=32, d_ff=8192, max_seq_len=4096,
                 rope_theta=10000.0, norm_eps=1e-5)
PHI3_PARITY_LAYERS, PHI3_RING_LAYERS, PHI3_RING_SEQ = 2, 8, 4096
PHI3_HEAD_DIM = PHI3_MINI["d_model"] // PHI3_MINI["n_heads"]
# head widths below their class (ops/head_dims.py: kernels 1 and 2 take
# every head_dim from 1 to 256, each on the library of the smallest built
# width at or above it). Phases kernel and ring_kernel hold both kernels to
# their plain versions at ANY_WIDTHS in both dtypes: kernel 1 over
# PAGED_ANY_SWEEP (pages 4 and 16) and at PAGED_ROWWISE, the (head_dim,
# page) pairs whose K/V tiles are not whole 16-byte units (loaded value by
# value: 99 x 4 and 100 x 1 in bf16, 3 x 1 in both); kernel 2 on
# RING_SMALL's blocks under each launch and on a ring's three kinds of
# block of ANY_RING_SHAPE's shards, and the same at RING_PADDED's widths of
# each dtype, whose rows are not whole 16-byte units (the wrapper's
# zero-padded copy, counted in padded_calls); two bf16 launches bit for
# bit. At
# ANY_TIMED both are also timed, eager and by graph replay, beside SDPA
# and the bound at the true width (at 100 kernel 2's bf16 call goes
# through its zero-padded copy, whose cost PERF.md states), at
# Phi-3-mini's path shapes with their own width (ANY_PATH: 32 query and 32 KV heads; kernel 1 over SLOTS
# sequences of MAX_PAGES pages of PAGE, kernel 2 on PHI3_RING_SEQ /
# RING_SHARDS-token shards)
ANY_WIDTHS = (8, 24, 40, 48, 72, 80, 96, 100, 112, 160, 192, 200)
ANY_TIMED = (80, 96, 100, 112, 192)
# RING_PADDED: 3 and 99 in f32, 99 in bf16. Not 3 in bf16: there P rounded
# to bf16, which the kernel does by design, alone exceeds FLASH_BOUNDS'
# element-wise bound on o (a row's rms over 3 values is often far below
# the rounding error of its sums), while its rel L2 stays inside
# (tests/test_torch_chip_checks.py shows both on the CPU)
RING_PADDED = {"float32": (3, 99), "bfloat16": (99,)}
PAGED_ANY_SWEEP = ((1, 4, 7), (2, 16, 16), (4, 4, 16), (8, 16, 7))
PAGED_ROWWISE = ((99, 4), (100, 1), (3, 1))
ANY_PATH = (PHI3_MINI["n_heads"], PHI3_MINI["n_kv_heads"])
ANY_RING_SHAPE = (8, 4, 512)   # heads, kv heads, shard tokens

# the scheduler (phases sched_kernel and north_star): the BASELINE graphs of
# ray_tpu_torch/_private/benchmarks.py at their full sizes (64 nodes x 4
# resources; ppo 16 nodes), threshold 0.99, and the ticks the reference's
# jax_drive makes on each (its while_loop's count). The north star is the
# 1M-task fan-out's scheduling time against BASELINE.json's 10 ms
SCHED_THRESHOLD = 0.99
SCHED_TICKS = {"fanout": 1, "map_reduce": 2, "pipeline": 4, "actor_heavy": 2,
               "ppo": 20, "north_star": 1, "north_star_waves": 64}
NORTH_STAR_TARGET_MS = 10.0
SCHED_REPEATS = 20
# the gang pack: PACK_GANGS gangs of PACK_BUNDLES bundles (1-4 CPUs, 0-1
# accelerator each), three priority tiers, on 64 nodes of 4-16 CPUs and 0-2
# accelerators; held exactly to the numpy oracle pack_gangs_tiered_np
PACK_GANGS, PACK_BUNDLES, PACK_NODES = 256, 4, 64


# the runtime (phase runtime): BASELINE.json's configs through the port's
# public API (ray_tpu_torch.init / remote / get, thread mode, 8 workers)
# with the TensorScheduler assigning on the card through kernels.assign.
# Config 1 (10k no-op tasks, cut to 5k for phase sharded, then 2.5k) under each
# backend, unbatched and through map_remote; config 2
# (benchmarks.build_map_reduce's shape: reducers of 100 maps each, passed
# as ObjectRefs) cut to a quarter, 25k tasks (100k took 40.7 s on the
# H100's host; cut to make room for phase perf), then to 10k for phase
# sharded, then to 5k for the head widths; config 4 cut to RUNTIME_ACTORS
# actors x RUNTIME_CALLS calls.
# The crossover times TensorScheduler._assign at CROSSOVER_K ready tasks
# on 64 nodes, numpy against cuda, on made-up snapshots of 1 and of 64
# classes (crossover_snapshot). sched_device_min_batch's default is the
# smallest k from which cuda takes under half numpy's time (the
# calibration's own 2x margin) at every larger k, for some class count:
# that is the 64-class mix, as no measured workload has many classes.
# Under auto the calibration also waits for a numpy tick above 2 ms, so
# the one-class runtime traffic above never reaches the device path
RUNTIME_WORKERS = 8
PROFILED_ASSIGNS = 20   # assign calls in one profiler session
# config 1's 10k fan-out, cut to 5k to pay for phase sharded, then to 2.5k
# (and config 2's map-reduce from 10k to 5k) to pay for the head widths'
# checks and paths (phases kernel, engine, train, ring)
RUNTIME_FANOUT = 2_500
RUNTIME_BACKENDS = ("cuda", "numpy", "auto")
RUNTIME_TASKS, RUNTIME_FAN_IN = 5_000, 100
RUNTIME_ACTORS, RUNTIME_CALLS = 1000, 10
ENGINE_PROMPTS, ENGINE_NEW_TOKENS = 8, 32
LINT_PASSES = ("lock_order", "shared_state", "wire_protocol", "knobs",
               "registry", "ref_lifecycle", "closure_capture",
               "blocking_calls")
LINT_PROMPTS = 4
# tests/test_chaos.py's arena round: six results of 200k float64 (1.6 MB)
LINT_ARENA_PUTS, LINT_ARENA_ELEMS = 6, 200_000
# process mode (phase process): the runtime with worker_mode="process", 8
# exec'd workers, the TensorScheduler assigning on the card and leasing the
# batches to the workers. Cut from phase runtime's sizes because each
# worker and each actor is a process: map-reduce 10k tasks (thread mode
# took 42.6-49.6 s at 100k), then 5k for phase sharded, 16 actors x 100
# calls (not 1k actors).
PROCESS_TASKS, PROCESS_ACTORS, PROCESS_CALLS = 5_000, 16, 100
# the arena: a 64 MiB CPU tensor read zero-copy by a worker and the
# driver; a 16 MiB CUDA tensor through put/get; 3 x 32 MiB objects
# through a 64 MiB arena (spill and restore)
ARENA_TENSOR_BYTES, CUDA_PUT_BYTES = 64 << 20, 16 << 20
SPILL_ARENA_BYTES, SPILL_OBJECT_BYTES, SPILL_OBJECTS = 64 << 20, 32 << 20, 3
# the engine actor's process: nvidia-smi's memory.used may stay this far
# above its level before the actor once the actor is killed (a CUDA
# context alone holds ~500 MiB of the card)
PROCESS_MEM_SLACK_MIB = 64
REF_MODULES = ("jax", "flax", "ray_tpu")
# Data (phase data): BASELINE config 3 (data_pipeline_throughput: blocks of
# 10 rows, after a warm pass of 1k blocks) cut from its own 100k blocks to
# 50k (85.5-106.5 s at 100k on the H100: cut to keep the whole script
# under 850 s with phase perf), then to 10k (43.0-59.5 s at 50k: cut to
# pay for phase sharded), then to 5k (14.0 s at 10k: cut to pay for the
# head widths), a checking run of 2k blocks with every assignment
# replayed through assign_np, the same pipeline in process mode cut to
# 10k blocks (each block is a lease to another process, as phase process
# cut its map-reduce), then to 5k for phase sharded, then to 2.5k for the
# head widths, the PRP
# shuffle (cut from 100k rows in 1k
# blocks, 39.5-54.9 s a run on the H100's host, to 20k rows in 200 blocks,
# 100 rows a block as before: each reducer takes every block as an
# argument, so the cost grows as blocks squared) and torch batches on the
# card
DATA_WORKERS, DATA_ROWS_PER_BLOCK = 8, 10
DATA_BLOCKS, DATA_WARM_BLOCKS, DATA_CHECK_BLOCKS = 5_000, 1_000, 2_000
DATA_PROCESS_BLOCKS = 2_500
SHUFFLE_ROWS, SHUFFLE_BLOCKS = 20_000, 200
BATCH_ROWS, BATCH_SIZE = 1_000_000, 4096
# the local virtual cluster (phase cluster): a 2-CPU head and process
# nodes of 4 CPUs and 2 workers each; CLUSTER_TASKS 50 ms tasks with 5
# retries through remove_node, half as many through kill_worker_processes;
# then the autoscaler against a 1-CPU head (the reference's test case)
CLUSTER_HEAD = dict(num_cpus=2, num_workers=2, scheduler="tensor")
CLUSTER_NODE = dict(num_cpus=4, num_workers=2)
CLUSTER_TASKS, CLUSTER_TASK_S = 200, 0.05
AUTOSCALE_TASKS, AUTOSCALE_TASK_S = 12, 0.4
# RLlib (phase rllib): BASELINE config 5 through the port's RLlib
# (perf.rl_rollout_throughput at the reference's sizes: 4 runners x 8 envs
# x 64 steps, 8 updates an iteration, 8 workers) for RL_ITERS timed
# iterations after a warm one; PPO on CartPole at the reference's learning
# test (RL_PPO) to 1.5 x max(first, 20) within RL_PPO_ITERS iterations;
# one PPO update on the card against the CPU on a minibatch of PPO's own
# size (2 x 4 x 256 rows / 4), held to the CPU tests' f32 bound; process
# mode for RL_PROCESS_ITERS iterations, the first batch's RL_BATCH_KEYS
# bit-identical to thread mode's
RL_WORKERS, RL_ITERS = 8, 4
RL_PPO = dict(num_env_runners=2, num_envs_per_runner=4, rollout_len=256,
              seed=0)
RL_PPO_ITERS, RL_PROCESS_ITERS = 17, 2
RL_MINIBATCH, RL_UPDATE_REPEATS, RL_UPDATE_BOUND = 512, 50, 1e-5
RL_BATCH_KEYS = ("obs", "actions", "logp", "rewards", "dones")
# rl_rollout_throughput's IMPALA configuration (the reference's), built
# once more for one profiled iteration after a warm one
RL_CONFIG5 = dict(num_env_runners=4, num_envs_per_runner=8, rollout_len=64,
                  updates_per_iter=8, seed=0)
# Train (phase train_lib): the flagship train configuration (phase train's
# width and depth) in a Trainer's loop, the batch cut to TRAIN_LIB_BATCH
# rows; TRAIN_LIB_STEPS steps, a checkpoint after step FAIL_STEP - 1, a
# failure at FAIL_STEP; resumed losses within TRAIN_LIB_REL of an
# uninterrupted run; then TRAIN_LIB_ROWS rows split over 2 workers
TRAIN_LIB_BATCH, TRAIN_LIB_STEPS, TRAIN_LIB_FAIL_STEP = 4, 4, 2
TRAIN_LIB_REL, TRAIN_LIB_ROWS = 1e-6, 10_000
CROSSOVER_K = (64, 256, 1024, 4096, 16384, 65536)
CROSSOVER_CLASSES = (1, 64)
CROSSOVER_NODES = 64

# Serve (phase serve): ray_tpu_torch.serve on the runtime (thread mode, 8
# workers, scheduler "tensor") with the serve-127M model at full width in
# bf16 and phase engine's config (SLOTS slots, NEW_TOKENS new tokens). The
# mono app (one replica) and the split pools (one prefill, one decode
# replica): a warm round, then a timed round of SERVE_STREAMS concurrent
# streams (prompts [i+1]*4, one client thread each) through the SSE
# driver path; then SERVE_FOLLOWUPS follow-up turns on the sessions the
# decode replica's KV cache holds (serve_kv_cache_sessions), each a
# cached replay. Phase parity's prompts run in f32 through both.
SERVE_STREAMS, SERVE_FOLLOWUPS = SLOTS, 16
ENGINE_THREAD = "ray_tpu_torch_llm_engine"
# memory_allocated may stay this far above its level before a deployment
# once Serve has shut down and cuBLAS's per-thread workspaces are freed
# (an engine's pages are 268 MB)
SERVE_MEM_SLACK = 8 << 20
# phase parity's prompts, tokens and near-tie rule (a mismatch passes only
# where the reference's top-2 logits lie closer than this)
PARITY_PROMPTS = ([1, 2, 3, 4], [5] * 4, [17, 300, 9000, 31999, 12], [7])
PARITY_NEW, PARITY_TIE_GAP = 16, 1e-3
# MoE (phase moe): the flagship train configuration (phase train's widths
# and depth) with a Switch expert layer in each block, the reference's
# defaults (8 experts, capacity factor 1.25), bf16, remat "dots"; the batch
# cut to MOE_BATCH rows because the dense dispatch and combine tensors
# [T, E, C] grow as T² (T = MOE_BATCH x 2047 tokens; at phase train's 16
# rows dispatch alone would take ~5.4 GB a layer). MOE_WARMUP steps, then
# MOE_STEPS timed. The step's loss equals a no-grad forward's cross-entropy
# + 0.01 x the layers' aux terms within MOE_AUX_REL; one MoE layer at this
# shape in f32 (TF32 off) on the card equals the CPU's within MOE_LAYER_TOL
# with dispatch identical
MOE_EXPERTS, MOE_CF = 8, 1.25
MOE_BATCH, MOE_WARMUP, MOE_STEPS = 4, 1, 4
MOE_AUX_REL, MOE_LAYER_TOL = 1e-5, 1e-4
# the compiled DAG (phase dag): preprocess -> the serve-127M forward (bf16,
# DAG_BATCH x DAG_SEQ tokens) -> postprocess (argmax), interpreted,
# compiled direct and compiled fused (a CUDA-graph replay), DAG_REPEATS
# executes each; fused logits within DAG_REL_L2 of the direct path's
DAG_BATCH, DAG_SEQ, DAG_REPEATS, DAG_REL_L2 = 8, 512, 20, 1e-6
# Tune (phase tune): trials train a 2-layer dense model (head_dim 128, so
# flash runs; no remat: each step launches each flash kernel once a layer)
# for TUNE_STEPS steps on a fixed [TUNE_BATCH, TUNE_SEQ + 1] batch; ASHA
# over lr x seed (8 trials, 4 at a time), PBT over 4 trials whose
# checkpoints hold the model's and AdamW's CUDA tensors (an exploited
# trial then runs TUNE_STEPS more steps from its donor's), and a 4-trial
# sweep restored after losing its last two trials' results
TUNE_MODEL = dict(vocab_size=4096, d_model=256, n_layers=2, n_heads=2,
                  n_kv_heads=1, d_ff=704, max_seq_len=256)
TUNE_BATCH, TUNE_SEQ, TUNE_STEPS = 8, 256, 12
TUNE_LRS = (1e-4, 3e-4, 1e-3, 3e-3)
# the multi-node plane (phase multinode): a thread-mode head (2 CPUs,
# TensorScheduler on the card, worker_gpu_access) and three remote nodes,
# each a node-daemon process with an arena of its own reached over TCP on
# localhost: two CPU nodes of MN_CPU_NODE and one GPU node of MN_GPU_NODE.
# MN_FANOUT small tasks; a task on a CPU node submitting MN_ROUNDS rounds
# of MN_NESTED nested tasks (no-op, retry-carrying and node-resident-ref
# leaves, the reference's default-config mix; a round stays within the
# daemon's local_queue_depth, as the reference's test does); an
# MN_OBJECT_BYTES array
# made on one node, read on the other and by the head; MN_LOCALITY
# consumers of MN_LOCALITY_BYTES arguments with scheduler_locality on,
# then off; MN_P2P_CALLS actor calls between the CPU nodes; the
# serve-127M engine actor on the GPU node (phase process's prompts);
# machine death under MN_DEATH_TASKS tasks of MN_DEATH_TASK_S; a chaos
# node flap under MN_FLAP_TASKS tasks; a ray:// client process
MN_HEAD = dict(num_cpus=2, num_workers=2, scheduler="tensor",
               resources={"mn_head": 4.0})
MN_CPU_NODE = dict(num_cpus=4, num_workers=4)
MN_GPU_NODE = dict(num_cpus=2, num_workers=2, num_gpus=1)
# MN_FANOUT: cut from 10k to 5k to pay for phase sharded, then to 2.5k for
# the head widths
MN_FANOUT, MN_ROUNDS, MN_NESTED = 2_500, 8, 12
MN_HEAD_SKIP_BOUND = 0.9           # the reference's bound
MN_OBJECT_BYTES = 64 << 20
# (with perf.locality_ab's spillback depth: a consumer waits for the
# holder while it has fewer than 32 leases outstanding)
MN_LOCALITY, MN_LOCALITY_BYTES, MN_LOCALITY_SPILL_DEPTH = 8, 1 << 20, 32
MN_P2P_CALLS = 200
MN_DEATH_TASKS, MN_DEATH_TASK_S = 200, 0.05
MN_FLAP_TASKS, MN_FLAP_TASK_S = 40, 0.1
# the client: a 16 MiB put/get, MN_CLIENT_TASKS round trips, a named
# actor and serve-127M's forward at [CLIENT_BATCH, CLIENT_SEQ] on the
# head's card (tokens from seed CLIENT_SEED)
MN_CLIENT_PUT_BYTES, MN_CLIENT_TASKS = 16 << 20, 200
CLIENT_BATCH, CLIENT_SEQ, CLIENT_SEED = 8, 512, 3
# a node daemon must map none of these libraries (no torch, no jax, no
# CUDA context)
DAEMON_BANNED_LIBS = ("libtorch", "libcuda", "jaxlib", "xla_extension")
# the flash kernels at the shapes the moe, dag, tune and client paths give
# them
# ((batch, heads after the model repeats the KV heads, seq), bf16, causal),
# held to their plain versions by phase kernel on the same inputs
FLASH_PATHS = {"moe": (MOE_BATCH, TRAIN["n_heads"], TRAIN_SEQ - 1),
               "dag": (DAG_BATCH, SERVE["n_heads"], DAG_SEQ),
               "client": (CLIENT_BATCH, SERVE["n_heads"], CLIENT_SEQ),
               "tune": (TUNE_BATCH, TUNE_MODEL["n_heads"], TUNE_SEQ)}
# workflow and queue (phase workflow): WORKFLOW_N x WORKFLOW_N f32 steps on
# the card; QUEUE_ITEMS CUDA tensors of QUEUE_SHAPE through a util.queue
WORKFLOW_N, QUEUE_ITEMS, QUEUE_SHAPE = 2048, 512, (256, 256)

# the optional planes and the ops layer (phase ops). Part qos: a process-mode
# head (OPS_WORKERS workers, the card's scheduler, worker_gpu_access,
# offering GPU: 1) with the QoS plane (OPS_QUOTAS, grace OPS_GRACE_S) and
# the profile plane (OPS_PROFILE_HZ), and one remote CPU node; the batch
# task trains phase tune's model (flash 3a-3c at FLASH_PATHS "tune") until
# a gate opens, the retry at least OPS_BATCH_MIN_STEPS steps; the prod
# task decodes phase multinode's prompts on serve-127M. Part profile: an
# OPS_PROFILE_S window during the decode. Part fair: OPS_FAIR_TASKS tasks a
# tenant, half at tier 1 and half at tier 0, in a seeded order behind one
# held slot. Part snapshot: OPS_SNAP_TASKS num_gpus tasks of an
# [OPS_SNAP_N, OPS_SNAP_N] f32 product pending at the save, their restored
# results within OPS_SNAP_REL (relative max error) of a direct run: the
# same cuBLAS call on the same inputs, which may choose another algorithm
# on another thread. Part cli: the CLI's head gets its knobs through the
# config registry's environment overrides (OPS_CLI_ENV)
OPS_QUOTAS, OPS_GRACE_S, OPS_PROFILE_HZ = '{"prod": 3, "batch": 1}', 0.3, 50.0
OPS_WORKERS, OPS_BATCH_MIN_STEPS, OPS_PROFILE_S = 2, 2, 2.0
OPS_SYSTEM = {"worker_mode": "process", "worker_gpu_access": True,
              "qos": True, "tenant_quotas": OPS_QUOTAS,
              "preempt_grace_s": OPS_GRACE_S, "profile_hz": OPS_PROFILE_HZ,
              "utilization_interval_s": 0.5, "sched_backend": "cuda",
              "trace_sample_rate": 1.0}
OPS_FAIR_SYSTEM = {"qos": True, "tenant_quotas": OPS_QUOTAS,
                   "sched_backend": "cuda"}
OPS_FAIR_TASKS, OPS_FAIR_SEED = 24, 0
OPS_SNAP_TASKS, OPS_SNAP_N, OPS_SNAP_REL = 4, 1024, 1e-6
OPS_CLI_ENV = {"RAY_TPU_TORCH_WORKER_GPU_ACCESS": "1",
               "RAY_TPU_TORCH_SCHED_BACKEND": "cuda",
               "RAY_TPU_TORCH_PROFILE_HZ": "20",
               "RAY_TPU_TORCH_TRACE_SAMPLE_RATE": "1.0"}


# the perf sections (phase perf): ray_tpu_torch/_private/perf.py's sections
# at the reference's defaults on the card. Decode at 64 slots and at
# PERF_DECODE_SLOTS; the time sinks of the flagship step at batch 8 once for
# the record (the reference's top 5) and once with every op, where each
# flash kernel must show by its device name (PERF_FLASH_OPS) and the
# counters must read 2 x layers x the steps run for the forward (the remat
# recompute reruns it) and layers x the steps run for each backward
# kernel; a call runs PERF_SINK_STEPS steps (one warm, two profiled).
# serving_ab runs the reference's own model (head_dim 16, kernel 1's
# head_dim-16 library). The Arrow sections need pyarrow; where it is not
# installed they print PERF_ARROW_SKIP
PERF_DECODE_SLOTS, PERF_DECODE_NEW, PERF_DECODE_PARAMS = 128, 128, 127_157_248
PERF_SINK_STEPS, PERF_SINKS_ALL, PERF_SHOW_OPS = 3, 10_000, 12
PERF_FLASH_OPS = {"flash_fwd": ("attention_fwd_kernel", "FlashFwdOut"),
                  "flash_bwd_dq": ("attention_bwd_dq_kernel",),
                  "flash_bwd_dkv": ("attention_bwd_dkv_kernel",)}
PERF_SERVING = dict(sessions=8, turns=2, max_new=48)
# each serving stream's tokens teacher-forced through the plain model (f32,
# no kernel, the engines' bf16 weights, serving_ab's seed 0): at every step
# the oracle's top logit less the logit of the token the engine took stays
# within PERF_SERVING_TOL (the engines compute in bf16)
PERF_SERVING_SEED, PERF_SERVING_TOL = 0, 0.05
PERF_HEAD_BYPASS = dict(n_calls=40, n_submit=24)   # its defaults
PERF_INGEST_ROWS = 96 * 50    # data_ingest_overlap's default blocks x rows
PERF_ARROW = ("data_arrow_throughput", "data_shuffle_throughput",
              "data_join_throughput")
PERF_ARROW_SKIP = "pyarrow is not installed on this machine"

# the bf16 kernels are instances of the wgmma + TMA templates: the forward
# (kernel 2, kernel 3a: ops/csrc/attention_fwd_sm90.cuh) and the backward
# (kernels 3c, 3b: ops/csrc/attention_bwd_sm90.cuh), by library. Each moves
# registers by setmaxnreg from its producer warpgroup (24 each) to its two
# consumer warpgroups (240 each): the block must be built with at least
# the average, or a consumer would wait for registers forever
SM90_KERNELS = {
    "ring_attention": ("attention_fwd_kernel",),
    "flash_attention": ("attention_fwd_kernel", "attention_bwd_dq_kernel",
                        "attention_bwd_dkv_kernel")}
SM90_MIN_REGISTERS = (24 * 128 + 240 * 256) // 384
# kernel 2's split kernel (attention_fwd_sm90.cuh): 160 threads, no
# setmaxnreg, so no floor on its registers; HGMMA, UTMALDG, no spills
SPLIT_KERNEL = "attention_fwd_split_kernel"
# kernel 1 (ops/csrc/paged_attention.cu, both dtypes) has neither wgmma nor
# a tensor map: its split kernel must copy each page tile with one
# cp.async.bulk, which sm_90a's SASS names UBLKCP; neither of its kernels
# may spill. {library: {kernel: SASS ops each instance must hold}}
BULK_KERNELS = {"paged_attention": {"paged_decode_split_kernel": ("UBLKCP",),
                                    "paged_decode_merge_kernel": ()}}
# the scheduler's kernels (ops/csrc/scheduler_tick.cu) use neither wgmma
# nor TMA: each must exist and spill nothing
SCHED_KERNELS = {"scheduler_tick": {k: () for k in (
    "sched_ready_kernel", "sched_plan_kernel", "sched_assign_kernel",
    "sched_edge_kernel", "sched_pack_kernel")}}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sm90_instances(kernel, sass, ptxas, log, ops=("HGMMA", "UTMALDG"),
                   min_registers=SM90_MIN_REGISTERS):
    """The instances of one kernel (template) in a library: a row
    (instances, whether each SASS op of `ops` is in every one's SASS,
    ptxas's report, its wgmma and setmaxnreg warnings) and the problems
    found: instances without an op, spills, and fewer registers than
    min_registers (None: not checked). sass: cuobjdump -sass of the
    library; ptxas: {instance: report}; log: ptxas's output."""
    funcs = [f for f in sass.split("Function : ")[1:]
             if kernel in f.split("\n", 1)[0]]
    report = {n: info for n, info in ptxas.items() if kernel in n}
    row = {"instances": len(funcs),
           **{op.lower(): all(op in f for f in funcs) for op in ops},
           "ptxas": report,
           # e.g. wgmma serialised, or setmaxnreg ignored
           "ptxas_warnings": [
               line.strip() for line in log.splitlines()
               if "warning" in line and ("wgmma" in line
                                         or "setmaxnreg" in line)]}
    regs = [int(m.group(1)) for info in report.values()
            for m in [re.search(r"(\d+) registers", info)] if m]
    spills = sum(int(x) for info in report.values()
                 for x in re.findall(r"(\d+) bytes spill", info))
    problems = []
    if not funcs or not all(row[op.lower()] for op in ops):
        problems.append(f"{kernel}: " + (f"instances without {'/'.join(ops)}"
                                         if ops else "no instances"))
    if min_registers is not None and (len(regs) != len(funcs) or not regs
                                      or min(regs) < min_registers):
        problems.append(f"{kernel}: registers {regs} (need "
                        f"{min_registers})")
    if spills:
        problems.append(f"{kernel}: instances spill {spills} bytes")
    return row, problems


def width_build_checks():
    """The build checks of the head widths' libraries (ops/head_dims.py)
    beyond SM90_KERNELS' (the 128 libraries): each width of kernel 1 as
    BULK_KERNELS's, the sm90 instances of kernel 2 (the template's at 64
    and 256, the split kernel's at every width) and of the flash kernels
    at the widths that route bf16 through them. [(library, kernel, how)]"""
    from ray_tpu_torch.ops import head_dims as hd

    checks = [(hd.library("paged_attention", D), kernel,
               {"ops": ops, "min_registers": None})
              for D in hd.PAGED_ATTENTION if D != hd.DEFAULT_HEAD_DIM
              for kernel, ops in BULK_KERNELS["paged_attention"].items()]
    # kernel 2: the template's instances at the widths it takes (128's is
    # SM90_KERNELS'), and the split kernel's at every width
    for D in hd.BLOCK_ATTENTION:
        lib = hd.library("ring_attention", D)
        if D != hd.DEFAULT_HEAD_DIM and D % 64 == 0:
            checks.append((lib, "attention_fwd_kernel", {}))
        checks.append((lib, SPLIT_KERNEL, {"min_registers": None}))
    for D in hd.FLASH:
        if D == hd.DEFAULT_HEAD_DIM:
            continue
        kernels = [k for k, widths in (
            ("attention_fwd_kernel", hd.SM90_FORWARD),
            ("attention_bwd_dq_kernel", hd.SM90_BACKWARD),
            ("attention_bwd_dkv_kernel", hd.SM90_BACKWARD)) if D in widths]
        checks += [(hd.library("flash_attention", D), k, {}) for k in kernels]
    return checks


def sm90_build_check(build, libs):
    """Each instance of the sm90 templates: HGMMA (wgmma) and UTMALDG (TMA
    loads) in its SASS, no spills, and the registers setmaxnreg needs;
    each of BULK_KERNELS and SCHED_KERNELS: its SASS ops, no spills; the
    same of every head width's library (width_build_checks). Raises
    before any launch otherwise."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    checks = [(lib, kernel, {}) for lib, kernels in SM90_KERNELS.items()
              for kernel in kernels]
    checks += [(lib, kernel, {"ops": ops, "min_registers": None})
               for table in (BULK_KERNELS, SCHED_KERNELS)
               for lib, kernels in table.items()
               for kernel, ops in kernels.items()]
    checks += width_build_checks()
    # one cuobjdump a library, all at once, and one report each
    names = sorted({lib for lib, _kernel, _how in checks})
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        sass = dict(zip(names, pool.map(lambda lib: subprocess.run(
            [cuobjdump, "-sass", str(libs[lib])], capture_output=True,
            text=True, check=True, timeout=300).stdout, names)))
    reports = {lib: build.register_report(lib) for lib in names}
    rows, problems = {}, []
    for lib, kernel, how in checks:
        row, found = sm90_instances(kernel, sass[lib], reports[lib],
                                    build.build_log(lib), **how)
        rows[f"{lib}/{kernel}"] = row
        problems += [f"{lib}: {p}" for p in found]
    emit({"phase": "build_sm90", "kernels": rows, "ok": not problems})
    if problems:
        raise AssertionError(f"sm90 kernels: {problems}")


def cuda_ms(torch, fn, n_iter: int) -> float:
    """Mean device time of fn(i) over n_iter calls, by CUDA events."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n_iter):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def graph_ms(torch, calls, n_replay: int = 50):
    """The calls (functions of no argument) captured once, in order, in one
    CUDA graph after a warm-up on a side stream: (device time per call over
    n_replay replays, by CUDA events; the outputs of the captured calls,
    which every replay rewrites)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for fn in calls]
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_replay):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n_replay * len(calls)), outs


def profiled_ms(torch, fn, n_calls: int = 20):
    """fn() n_calls times under torch.profiler, after a warm call: (the
    device time per call of every kernel it launched, from the device's own
    kernel events, and {kernel name: device ms per call})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:80]
            by_name[name] = by_name.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / n_calls
    if not by_name:
        raise AssertionError("the profiler recorded no device activity")
    return sum(by_name.values()), by_name


def paged_lengths(page, pps, MP):
    """Lengths at the edges the split kernel cuts: empty, one token, a
    page and one past it, a split (pps pages) and one past it, the whole
    table and past its end."""
    return [0, 1, page, page + 1, pps * page, pps * page + 1, MP * page,
            MP * page + 5]


def paged_sweep(torch, dev, pa, D=128, sweep=PAGED_SWEEP):
    """The kernel against its plain version at small shapes, head_dim D:
    every (dtype, group, page, MP) of `sweep`, each with split_plan's
    pages per split and with 2, 3 and MP (one split) pages per split where
    a block's shared memory allows, lengths from paged_lengths; in bf16
    two launches bit for bit. Returns (cases checked, worst max abs error,
    failed cases)."""
    g = torch.Generator(device=dev).manual_seed(5)
    checked, worst, failed = 0, 0.0, []
    for dtype in (torch.bfloat16, torch.float32):
        for G, page, MP in sweep:
            KV = 2
            H, B = G * KV, len(paged_lengths(page, 1, MP))
            elt = torch.tensor([], dtype=dtype).element_size()
            plan = pa.split_plan(B, H, KV, MP, page, elt, D)
            for pps in sorted({plan[0], 2, 3, MP}):
                if pa.split_smem_bytes(pps, page, G, elt, D) > pa.MAX_SMEM:
                    continue
                lens = torch.tensor(paged_lengths(page, pps, MP),
                                    dtype=torch.int32, device=dev)
                P = B * MP
                table = torch.randperm(P, generator=g, device=dev).reshape(
                    B, MP).to(torch.int32).contiguous()
                q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
                kp, vp = (torch.randn((P, KV, page, D), generator=g,
                                      device=dev).to(dtype) for _ in range(2))
                ker = pa.paged_attention(q, kp, vp, table, lens,
                                         pages_per_split=pps)
                ref = pa.paged_attention_reference(q, kp, vp, table, lens)
                twice = dtype == torch.float32 or torch.equal(
                    ker, pa.paged_attention(q, kp, vp, table, lens,
                                            pages_per_split=pps))
                torch.cuda.synchronize()
                err = float((ker - ref).abs().max())
                checked += 1
                worst = max(worst, err)
                if not (bool(torch.isfinite(ker).all()) and err <= PAGED_TOL
                        and twice):
                    failed.append({"dtype": str(dtype), "head_dim": D,
                                   "group": G,
                                   "page": page, "max_pages": MP,
                                   "pages_per_split": pps, "err": err,
                                   "deterministic": twice})
    return checked, worst, failed


def phase_kernel(torch, dev, timed=True):
    """Paged attention at each head_dim it is built for: the kernel
    against its plain version on the small shapes of paged_sweep, then at
    the serving shapes (paged_serving); at each of ANY_WIDTHS and
    PAGED_ROWWISE on their sweeps, and at ANY_TIMED at the path shape of
    ANY_PATH's heads. Returns {head_dim: {dtype: row}}. Raises after
    every check has printed if any failed."""
    from ray_tpu_torch.ops import head_dims
    from ray_tpu_torch.ops import paged_attention as pa

    problems = []
    sweeps = ([(D, PAGED_SWEEP) for D in head_dims.PAGED_ATTENTION]
              + [(D, PAGED_ANY_SWEEP) for D in ANY_WIDTHS]
              + [(D, ((1, page, 7), (2, page, 16)))
                 for D, page in PAGED_ROWWISE])
    for D, sweep in sweeps:
        checked, worst, failed = paged_sweep(torch, dev, pa, D, sweep)
        emit({"phase": "kernel", "name": "paged_decode_attention",
              "shape": "sweep", "head_dim": D,
              "width_class": head_dims.width_class(D),
              "pages": sorted({page for _g, page, _m in sweep}),
              "cases": checked,
              "max_abs_err": worst, "tolerance": PAGED_TOL,
              "failed": failed, "ok": not failed})
        if failed:
            problems.append(f"sweep at head_dim {D}: {len(failed)} cases "
                            f"over {PAGED_TOL} or not deterministic")
    rows = {D: paged_serving(torch, dev, pa, D, timed, problems)
            for D in head_dims.PAGED_ATTENTION}
    rows.update({D: paged_serving(torch, dev, pa, D, timed, problems,
                                  *ANY_PATH) for D in ANY_TIMED})
    if problems:
        raise AssertionError(f"paged_attention kernel: {problems}")
    return rows


def paged_serving(torch, dev, pa, D, timed, problems, H=8, KV=4):
    """Kernel 1 at the serving shapes with head_dim D (H query over KV
    heads, SERVE's by default) over one cache per layer (8 x 16 MiB per K
    or V in bf16 at D = 128), cycled as the decode step does, so timings
    do not sit in L2: max abs error, two launches bit-identical, the 8
    per-layer calls captured in one CUDA graph giving the eager calls'
    bits. timed: the eager time (a loop of wrapper calls, host included),
    the device time (graph replays), the plain version's, the SDPA
    yardstick's both ways, and at D = 128 the device time at each
    pages-per-split of PAGED_SPLITS. Appends what failed to problems;
    returns {dtype: row}."""
    B, MP, P, L = SLOTS, MAX_PAGES, NUM_PAGES, 8
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randperm(P, generator=g, device=dev).reshape(B, MP).to(
        torch.int32).contiguous()
    lens = torch.cat([
        torch.tensor([0, 1, 16, 17, MP * PAGE], device=dev),
        torch.randint(0, MP * PAGE + 1, (B - 5,), generator=g, device=dev),
    ]).to(torch.int32)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
        kps = [torch.randn((P, KV, PAGE, D), generator=g, device=dev).to(dtype)
               for _ in range(L)]
        vps = [torch.randn((P, KV, PAGE, D), generator=g, device=dev).to(dtype)
               for _ in range(L)]
        layer = [lambda i=i: pa.paged_attention(q, kps[i], vps[i], table,
                                                lens) for i in range(L)]
        err, finite, eager = 0.0, True, []
        for i in range(L):
            ker = layer[i]()
            ref = pa.paged_attention_reference(q, kps[i], vps[i], table, lens)
            torch.cuda.synchronize()
            finite &= bool(torch.isfinite(ker).all())
            err = max(err, float((ker - ref).abs().max()))
            eager.append(ker)
        # both read the same values and accumulate in f32: only the order
        # of the sums (and exp2 for exp) differs
        twice = bool(torch.equal(layer[0](), layer[0]()))
        device_ms, graphed = graph_ms(torch, layer)
        captured = all(bool(torch.equal(a, b)) for a, b in zip(graphed,
                                                                eager))
        pps, splits = pa.split_plan(B, H, KV, MP, PAGE, q.element_size(), D)
        row = {"dtype": name, "head_dim": D, "heads": H, "kv_heads": KV,
               "max_abs_err": err, "tolerance": PAGED_TOL,
               "finite": finite, "deterministic": twice,
               "graph_bit_identical": captured, "pages_per_split": pps,
               "splits": splits}
        problems += [f"{what} ({name}, head_dim {D})" for what, bad in (
            (f"max abs err {err} > {PAGED_TOL}", err > PAGED_TOL),
            ("output not finite", not finite),
            ("two launches differ", not twice),
            ("graph replay differs from eager calls", not captured)) if bad]
        if timed:
            row["device_ms"] = device_ms
            row["ms"] = cuda_ms(torch, lambda i: layer[i % L](), 200)
            row["plain_ms"] = cuda_ms(
                torch, lambda i: pa.paged_attention_reference(
                    q, kps[i % L], vps[i % L], table, lens), 20)
            if D == FLASH_D:
                row["split_device_ms"] = {
                    n: graph_ms(torch, [
                        lambda i=i, n=n: pa.paged_attention(
                            q, kps[i], vps[i], table, lens,
                            pages_per_split=n)
                        for i in range(L)])[0]
                    for n in PAGED_SPLITS if pa.split_smem_bytes(
                        n, PAGE, H // KV, q.element_size(), D)
                    <= pa.MAX_SMEM}
            # yardstick only (the port never calls it): one SDPA call over
            # the KV already gathered per sequence and repeated to every
            # head
            T = MP * PAGE
            mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[
                :, None, None, :]
            gathered = []
            for i in range(L):
                kg, vg = (x[table.long()].permute(0, 2, 1, 3, 4).reshape(
                    B, KV, T, D).repeat_interleave(H // KV, 1)
                    for x in (kps[i], vps[i]))
                gathered.append((kg, vg))
            qs = q[:, :, None, :]
            F = torch.nn.functional
            sdpa = [lambda i=i: F.scaled_dot_product_attention(
                qs, *gathered[i], attn_mask=mask) for i in range(L)]
            row["library_ms"] = cuda_ms(torch, lambda i: sdpa[i % L](), 200)
            row["library_device_ms"] = graph_ms(torch, sdpa)[0]
            del gathered, sdpa
            valid = int(lens.clamp(max=T).sum())
            nbytes = (q.nbytes + B * H * D * 4 + table.nbytes + lens.nbytes
                      + 2 * valid * KV * D * q.element_size())
            flops = 4 * valid * H * D
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[name] * 1e3
            row.update(bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=nbytes, flops=flops)
        rows[name] = row
        emit({"phase": "kernel", "name": "paged_decode_attention",
              "shape": "serving", **row})
        del kps, vps, layer, eager, graphed
        torch.cuda.empty_cache()
    return rows


def _flash_work(name, B, elt, H=FLASH_H, D=FLASH_D):
    """(bytes, flops) the function needs at [B, H, S, D], causal: each input
    read once, each output written once; 2*D flops per visible (query, key)
    pair per product, S(S+1)/2 pairs per head."""
    S = FLASH_S
    mat, row = B * H * S * D * elt, B * H * S * 4
    pairs = B * H * S * (S + 1) // 2
    n_in, n_rows, n_out, products = {
        "flash_fwd": (3, 0, 1, 2), "flash_bwd_dq": (4, 2, 1, 3),
        "flash_bwd_dkv": (4, 2, 2, 4)}[name]
    lse_out = row if name == "flash_fwd" else 0
    return ((n_in + n_out) * mat + n_rows * row + lse_out,
            products * 2 * pairs * D)


def _reading(torch, output, got, want, bounds):
    """One output of a kernel against the plain version's."""
    rtol, atol, rel_l2 = bounds
    got, want = got.float(), want.float()
    err = (got - want).abs()
    row_rms = want.square().mean(-1, keepdim=True).sqrt()
    row_rms = row_rms.clamp(min=0.1 * float(want.square().mean().sqrt()))
    r = {"output": output, "max_abs_err": float(err.max()),
         "err_over_bound": float((err / (rtol * want.abs() + atol * row_rms))
                                 .max()),
         "rel_l2": float(torch.linalg.vector_norm(err)
                         / torch.linalg.vector_norm(want)),
         "rel_l2_bound": rel_l2, "finite": bool(torch.isfinite(got).all())}
    r["ok"] = (r["finite"] and r["err_over_bound"] <= 1
               and r["rel_l2"] <= rel_l2)
    return r


def flash_readings(torch, fl, q, k, v, do, causal):
    """Every output of the three kernels against the plain versions' on
    the same inputs (the backward kernels get the plain forward's lse and
    di). Returns ({kernel: [reading per output]}, lse, di)."""
    name = str(q.dtype).replace("torch.", "")
    o_ref, lse_ref = fl._flash_fwd_reference(q, k, v, causal)
    di = (o_ref.float() * do.float()).sum(-1).contiguous()
    pairs = {
        "flash_fwd": zip(fl.flash_fwd(q, k, v, causal), (o_ref, lse_ref)),
        "flash_bwd_dq": [(
            fl.flash_bwd_dq(q, k, v, do, lse_ref, di, causal),
            fl._flash_bwd_dq_reference(q, k, v, do, lse_ref, di, causal))],
        "flash_bwd_dkv": zip(
            fl.flash_bwd_dkv(q, k, v, do, lse_ref, di, causal),
            fl._flash_bwd_dkv_reference(q, k, v, do, lse_ref, di, causal)),
    }
    readings = {
        kname: [_reading(torch, out, got, want,
                         LSE_BOUNDS if out == "lse" else FLASH_BOUNDS[name])
                for out, (got, want) in zip(FLASH_OUTPUTS[kname], outs)]
        for kname, outs in pairs.items()}
    torch.cuda.synchronize()
    return readings, lse_ref, di


def phase_flash_kernel(torch, dev, timed=True):
    """The three flash attention kernels vs their plain versions on small
    ragged shapes (FLASH_SMALL) at each head_dim they are built for, at
    the moe, dag and tune paths' shapes (FLASH_PATHS, bf16, causal), then
    at the train steps' attention shapes (head_dim 128: TRAIN's; 256:
    TRAIN_D256's), on the same inputs, with their times (timed=False: the
    checks alone). The inputs are the model's [B, S, H, D] tensors seen as
    [B, H, S, D] views, as the train path passes them. The f32 pass also
    checks the non-causal kernels. Returns {head_dim: {kernel: {dtype:
    row}}}. Raises after every check has printed if any output is out of
    bounds."""
    from ray_tpu_torch.ops import flash as fl
    from ray_tpu_torch.ops import head_dims

    failed = []

    def check(kname, name, causal, readings):
        failed.extend(f"{kname}.{r['output']} ({name}, causal={causal})"
                      for r in readings if not r["ok"])
        return {"outputs": readings,
                "max_abs_err": max(r["max_abs_err"] for r in readings)}

    for D in head_dims.FLASH:
        g = torch.Generator(device=dev).manual_seed(4)
        for label, (B, H, S) in FLASH_SMALL.items():
            for dtype in (torch.bfloat16, torch.float32):
                name = str(dtype).replace("torch.", "")
                q, k, v, do = (torch.randn((B, S, H, D), generator=g,
                                           device=dev).to(dtype)
                               .transpose(1, 2) for _ in range(4))
                for causal in (True, False):
                    readings, _lse, _di = flash_readings(torch, fl, q, k, v,
                                                         do, causal)
                    for kname in FLASH_NAMES:
                        emit({"phase": "kernel", "name": kname,
                              "dtype": name, "shape": label, "batch": B,
                              "heads": H, "seq": S, "head_dim": D,
                              "causal": causal,
                              **check(kname, f"{name}, {label}, head_dim {D}",
                                      causal, readings[kname])})
    g = torch.Generator(device=dev).manual_seed(4)
    for label, (B, H, S) in FLASH_PATHS.items():
        q, k, v, do = (torch.randn((B, S, H, FLASH_D), generator=g,
                                   device=dev).to(torch.bfloat16)
                       .transpose(1, 2) for _ in range(4))
        readings, _lse, _di = flash_readings(torch, fl, q, k, v, do, True)
        for kname in FLASH_NAMES:
            emit({"phase": "kernel", "name": kname, "dtype": "bfloat16",
                  "shape": label, "batch": B, "heads": H, "seq": S,
                  "causal": True,
                  **check(kname, f"bfloat16, {label}", True,
                          readings[kname])})
        del q, k, v, do, readings, _lse, _di
    # the train steps' shapes: TRAIN's heads at head_dim 128 (batch
    # FLASH_BATCH), TRAIN_D256's at 256 (FLASH_D256_BATCH)
    shapes = {FLASH_D: (FLASH_H, FLASH_BATCH),
              256: (TRAIN_D256["n_heads"], FLASH_D256_BATCH)}
    rows = {D: flash_train_shape(torch, dev, fl, D, *shapes[D], timed,
                                 check, failed)
            for D in head_dims.FLASH}
    if failed:
        raise AssertionError(f"flash kernels vs plain out of bounds: {failed}")
    return rows


def flash_train_shape(torch, dev, fl, D, H, batches, timed, check, failed):
    """The three flash kernels at a train step's attention shape
    ([B, FLASH_S, H, D] views, causal; f32 also non-causal), each output
    against the plain version's; timed: two launches bit-identical, times,
    the SDPA yardstick and the bound. batches: {label: B}, a label being
    the dtype's name or the name and "@" and what the batch is for.
    Returns {kernel: {label: row}}."""
    F = torch.nn.functional
    rows = {}
    for label, B in batches.items():
        name = label.split("@")[0]
        dtype = getattr(torch, name)
        g = torch.Generator(device=dev).manual_seed(2)
        q, k, v, do = (torch.randn((B, FLASH_S, H, D),
                                   generator=g, device=dev).to(dtype)
                       .transpose(1, 2) for _ in range(4))
        if dtype == torch.float32:
            readings, _lse, _di = flash_readings(torch, fl, q, k, v, do,
                                                 False)
            for kname in FLASH_NAMES:
                emit({"phase": "kernel", "name": kname, "dtype": name,
                      "batch": B, "heads": H, "head_dim": D, "causal": False,
                      **check(kname, f"{name}, head_dim {D}", False,
                              readings[kname])})
            del readings, _lse, _di
        readings, lse_ref, di = flash_readings(torch, fl, q, k, v, do, True)
        if not timed:
            for kname in FLASH_NAMES:
                emit({"phase": "kernel", "name": kname, "dtype": name,
                      "batch": B, "heads": H, "head_dim": D, "causal": True,
                      **check(kname, f"{label}, head_dim {D}", True,
                              readings[kname])})
            continue
        # two launches on the same inputs give the same bits (the forward's
        # recompute under remat relies on it; the backward has no atomics)
        twice = {
            "flash_fwd": lambda: fl.flash_fwd(q, k, v),
            "flash_bwd_dq": lambda: (fl.flash_bwd_dq(q, k, v, do, lse_ref,
                                                     di),),
            "flash_bwd_dkv": lambda: fl.flash_bwd_dkv(q, k, v, do, lse_ref,
                                                      di)}
        deterministic = {}
        for kname, fn in twice.items():
            first, second = fn(), fn()
            torch.cuda.synchronize()
            deterministic[kname] = all(
                bool(torch.equal(a, b)) for a, b in zip(first, second))
            if not deterministic[kname]:
                failed.append(f"{kname}: two launches on the same inputs "
                              f"differ ({label}, head_dim {D})")
            del first, second
        # yardstick only (the port never calls it): SDPA forward, and its
        # backward alone (one call computing dq, dk and dv together)
        lq, lk, lv = (x.detach().clone().requires_grad_() for x in (q, k, v))
        lib_fwd = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
            lq, lk, lv, is_causal=True), 10)
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
        lib_bwd = cuda_ms(torch, lambda i: torch.autograd.grad(
            lo, (lq, lk, lv), do, retain_graph=True), 10)
        del lo, lq, lk, lv
        calls = {
            "flash_fwd": (lambda i: fl.flash_fwd(q, k, v),
                          lambda i: fl._flash_fwd_reference(q, k, v),
                          lib_fwd),
            "flash_bwd_dq": (
                lambda i: fl.flash_bwd_dq(q, k, v, do, lse_ref, di),
                lambda i: fl._flash_bwd_dq_reference(q, k, v, do, lse_ref,
                                                     di), lib_bwd),
            "flash_bwd_dkv": (
                lambda i: fl.flash_bwd_dkv(q, k, v, do, lse_ref, di),
                lambda i: fl._flash_bwd_dkv_reference(q, k, v, do, lse_ref,
                                                      di), lib_bwd),
        }
        for kname in FLASH_NAMES:
            kernel, plain, library_ms = calls[kname]
            nbytes, flops = _flash_work(kname, B, q.element_size(), H, D)
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[name] * 1e3
            row = {"dtype": name, "batch": B, "heads": H,
                   "seq": FLASH_S, "head_dim": D, "causal": True,
                   **check(kname, f"{label}, head_dim {D}", True,
                           readings[kname]),
                   "ms": cuda_ms(torch, kernel, 10),
                   "plain_ms": cuda_ms(torch, plain, 2),
                   "library_ms": library_ms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": nbytes, "flops": flops}
            row["deterministic"] = deterministic[kname]
            if label != name:
                row["shape"] = label
            rows.setdefault(kname, {})[label] = row
            emit({"phase": "kernel", "name": kname, **row})
        del q, k, v, do, lse_ref, di, readings, calls
        torch.cuda.empty_cache()
    return rows


def _ring_block_work(B, H, Hkv, Tq, Tk, q_offset, k_offset, causal, elt,
                     D=FLASH_D):
    """(bytes, flops) of one block: 2*D flops per visible (query, key) pair
    per product, two products; the inputs read once where any pair is
    visible, the outputs (o, m, l in f32) written once."""
    import numpy as np

    if causal:
        seen = np.clip(np.arange(Tq) + q_offset - k_offset + 1, 0, Tk)
        visible = int(seen.sum())
    else:
        visible = Tq * Tk
    nbytes = B * H * Tq * (D + 2) * 4
    if visible:
        nbytes += (B * H * Tq + 2 * B * Hkv * Tk) * D * elt
    return nbytes, 4 * D * B * H * visible


def ring_block_check(torch, name, got, want, neg_inf):
    """Kernel 2's (o, m, l) against the plain version's. Over the rows with
    a visible key: o to FLASH_BOUNDS, m and l to RING_ML_BOUNDS (m with the
    other rows set to 0 in both). The other rows must read exactly o = 0,
    m = -1e30, l = 0 in the kernel's output."""
    (o, m, l), (o_r, m_r, l_r) = got, want
    live = m_r > neg_inf / 2
    dead = ~live
    dead_exact = bool((m[dead] == neg_inf).all() and (l[dead] == 0).all()
                      and (o[dead] == 0).all())
    readings = []
    if bool(live.any()):
        readings = [
            _reading(torch, "o", o, o_r, FLASH_BOUNDS[name]),
            _reading(torch, "m", torch.where(live, m, 0.0),
                     torch.where(live, m_r, 0.0), RING_ML_BOUNDS),
            _reading(torch, "l", l, l_r, RING_ML_BOUNDS)]
    return {"outputs": readings, "dead_rows": int(dead.sum()),
            "dead_rows_exact": dead_exact,
            "max_abs_err": max([r["max_abs_err"] for r in readings]
                               + [0.0]),
            "ok": dead_exact and all(r["ok"] for r in readings)}


def phase_ring_kernel(torch, dev, timed=True):
    """Kernel 2 against its plain version at each head_dim it is built for:
    on small ragged blocks (f32, and bf16 under its launch plan and each
    launch of ring_launches), then on a ring path's three kinds of block
    (bf16, with times, bound and an SDPA yardstick; timed=False: the checks
    alone), at each width the shards and heads its ring path in phase ring
    gives it (ring_path_shapes); then the same at each of ANY_WIDTHS and
    RING_PADDED's widths of each dtype (where each call must go through its
    zero-padded copy exactly where a row is not whole 16-byte units), the
    three kinds of block at ANY_RING_SHAPE (bf16), or timed at Phi-3-mini's ring
    shards at ANY_TIMED (any_ring_shapes). The inputs are [B, T, H, D]
    tensors seen as [B, H, T, D] views, as the ring passes the model's.
    Returns {head_dim: {block: row}}. Raises after every check has printed
    if any is out of bounds."""
    from ray_tpu_torch.ops import head_dims
    from ray_tpu_torch.ops import ring_attention as ra

    failed = []

    def check(label, dtype, qkv, q_off, k_off, causal, splits=None):
        name = str(dtype).replace("torch.", "")
        got = ra.block_attention(*qkv, q_off, k_off, causal, splits)
        want = ra._block_attention_reference(*qkv, q_off, k_off, causal)
        torch.cuda.synchronize()
        result = ring_block_check(torch, name, got, want, ra.NEG_INF)
        if dtype == torch.bfloat16:
            result["splits"] = (ra.block_plan(*qkv[0].shape[:3],
                                              qkv[1].shape[2],
                                              head_dims.width_class(
                                                  qkv[0].shape[-1]))
                                if splits is None else splits)
        if not result["ok"]:
            failed.append(f"{label} ({name}, head_dim {qkv[0].shape[-1]}"
                          f"{', splits ' + str(splits) if splits is not None else ''})")
        return result

    rows = {}
    shapes = {**ring_path_shapes(), **any_ring_shapes()}
    for D in (*head_dims.BLOCK_ATTENTION, *ANY_WIDTHS, *ring_padded()):
        g = torch.Generator(device=dev).manual_seed(3)
        dtypes = [dt for dt in (torch.float32, torch.bfloat16)
                  if D not in ring_padded() or D in RING_PADDED[
                      str(dt).replace("torch.", "")]]
        for dtype in dtypes:
            name = str(dtype).replace("torch.", "")
            padded = ra.block_attention.padded_calls
            for label, (h, kv, tq, tk, q_off, k_off,
                        causal) in RING_SMALL.items():
                qkv = ring_inputs(torch, dev, g, RING_SMALL_BATCH, h, kv, tq,
                                  tk, D, dtype)
                plans = ([None] + list(ring_launches(D))
                         if dtype == torch.bfloat16 else [None])
                for splits in plans:
                    emit({"phase": "kernel", "name": "ring_block_attention",
                          "block": label, "dtype": name, "head_dim": D,
                          "batch": RING_SMALL_BATCH, "heads": h,
                          "kv_heads": kv, "tq": tq, "tk": tk,
                          "q_offset": q_off, "k_offset": k_off,
                          "causal": causal,
                          **check(label, dtype, qkv, q_off, k_off, causal,
                                  splits)})
            copies = ra.block_attention.padded_calls > padded
            if copies != (D % (16 // dtype.itemsize) != 0):
                failed.append(f"{name} at head_dim {D}: zero-padded copy "
                              f"{'made' if copies else 'not made'}")
        if torch.bfloat16 not in dtypes:
            continue
        H, KV, T = shapes[D]
        rows[D] = ring_path_blocks(
            torch, dev, ra, g, D, H, KV, T, ring_blocks(T),
            timed and (D in head_dims.BLOCK_ATTENTION or D in ANY_TIMED),
            check, failed)
    if failed:
        raise AssertionError(f"ring block kernel vs plain out of bounds: "
                             f"{failed}")
    return rows


def ring_launches(D):
    """The bf16 launches of kernel 2 that phase kernel checks beside its
    plan's: the 128-query template where head_dim's class takes it (0), and
    the split kernel at 1, 2, 4 and 8 splits."""
    from ray_tpu_torch.ops import head_dims

    template = head_dims.width_class(D) % 64 == 0
    return ((0,) if template else ()) + (1, 2, 4, 8)


def ring_blocks_launched(B, H, Tq, splits):
    """Blocks of a kernel-2 launch: B * H * 128-query tiles (splits 0), or
    B * H * 64-query tiles * splits."""
    if splits == 0:
        return B * H * -(-Tq // 128)
    return B * H * -(-Tq // 64) * splits


def ring_path_shapes():
    """{head_dim: (heads, kv heads, shard tokens)}: the blocks each width's
    ring forward in phase ring gives kernel 2 (RING_SHARDS shards of its
    sequence)."""
    from ray_tpu_torch.models.transformer import TransformerConfig

    default = TransformerConfig(**DEFAULT)
    shapes = {FLASH_D: (TRAIN["n_heads"], TRAIN["n_kv_heads"], RING_T),
              default.head_dim: (default.n_heads, default.n_kv_heads,
                                 DEFAULT_RING_SEQ // RING_SHARDS)}
    for D, f in width_models().items():
        shapes[D] = (f["n_heads"], f["n_kv_heads"],
                     WIDTH_RING_SEQ // RING_SHARDS)
    return shapes


def any_ring_shapes():
    """{head_dim: (heads, kv heads, shard tokens)} of ANY_WIDTHS and
    RING_PADDED: Phi-3-mini's ring path's shards and heads at ANY_TIMED,
    ANY_RING_SHAPE at the others."""
    return {D: ((*ANY_PATH, PHI3_RING_SEQ // RING_SHARDS) if D in ANY_TIMED
                else ANY_RING_SHAPE) for D in (*ANY_WIDTHS, *ring_padded())}


def ring_padded():
    """RING_PADDED's widths, each once, in order."""
    return tuple(sorted({D for ws in RING_PADDED.values() for D in ws}))


def ring_inputs(torch, dev, g, B, h, kv, tq, tk, D, dtype):
    """Seeded q [B, tq, h, D] and k, v [B, tk, kv, D] as [B, heads, T, D]
    views, as the ring passes the model's. Each lies in a buffer one token
    longer than itself: a TMA map that reads past a row's D columns (the
    map mutants of flash_mutants.py) then reads the next token's values,
    never memory past the allocation, where it would fault the card."""
    q = torch.randn((B, tq, h, D), generator=g, device=dev)
    k, v = (torch.randn((B, tk, kv, D), generator=g, device=dev)
            for _ in range(2))

    def placed(x):
        buf = torch.zeros((x.shape[0], x.shape[1] + 1, *x.shape[2:]),
                          dtype=dtype, device=dev)
        buf[:, :x.shape[1]] = x
        return buf[:, :x.shape[1]].transpose(1, 2)

    return tuple(placed(x) for x in (q, k, v))


def ring_path_blocks(torch, dev, ra, g, D, H, KV, T, blocks, timed, check,
                     failed):
    """Kernel 2 on a ring path's kinds of block ({label: (q_offset,
    k_offset)}) of T-token shards, bf16, causal: the check under the
    launch plan, two launches bit for bit, and where the plain version's
    scores fit (every width but the 32k ring's 128) the check under each
    launch of ring_launches; timed, the kernel's, the plain version's and
    SDPA's times and the bound, and on the full block the graph time of
    each launch. Returns {label: row}."""
    from ray_tpu_torch.ops import head_dims

    F = torch.nn.functional
    rows = {}
    q, k, v = ring_inputs(torch, dev, g, 1, H, KV, T, T, D, torch.bfloat16)
    width = head_dims.width_class(D)
    plan = ra.block_plan(1, H, T, T, width)
    sweep = [] if D == FLASH_D else [
        s for s in ring_launches(D)
        if s <= max(1, -(-T // ra.split_keys(width)))]
    for label, (q_off, k_off) in blocks.items():
        row = {"block": label, "dtype": "bfloat16", "head_dim": D,
               "batch": 1, "heads": H, "kv_heads": KV, "tq": T, "tk": T,
               "q_offset": q_off, "k_offset": k_off, "causal": True,
               "blocks": ring_blocks_launched(1, H, T, plan),
               **check(label, torch.bfloat16, (q, k, v), q_off, k_off, True)}
        first = ra.block_attention(q, k, v, q_off, k_off)
        again = ra.block_attention(q, k, v, q_off, k_off)
        row["deterministic"] = all(torch.equal(a, b)
                                   for a, b in zip(first, again))
        if not row["deterministic"]:
            failed.append(f"{label} (bfloat16, head_dim {D}): two launches "
                          f"differ")
        del first, again
        row["launches_checked"] = {
            s: check(label, torch.bfloat16, (q, k, v), q_off, k_off, True,
                     s)["ok"] for s in sweep}
        if not timed:
            emit({"phase": "kernel", "name": "ring_block_attention", **row})
            continue
        nbytes, flops = _ring_block_work(1, H, KV, T, T, q_off, k_off, True,
                                         q.element_size(), D)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3

        # each call three ways: eager (CUDA events around a loop of
        # wrapper calls, so host time where the host is the slower side),
        # by replays of RING_GRAPH_CALLS calls captured in one CUDA graph
        # (device time and the gaps between kernels), and at the built
        # widths by the profiler (the device time of the kernels alone, by
        # name)
        profiled = D in head_dims.BLOCK_ATTENTION

        def kernel(splits=None):
            return ra.block_attention(q, k, v, q_off, k_off, True, splits)

        row["ms"] = cuda_ms(torch, lambda i: kernel(), 10)
        row["graph_ms"] = graph_ms(torch, [kernel] * RING_GRAPH_CALLS)[0]
        if profiled:
            row["profiled_ms"], row["profiled_kernels"] = profiled_ms(
                torch, kernel)
        if label == "full" and D % 8:
            # a bf16 row that is not whole 16-byte units: the call's
            # zero-padded copy of q, k and v alone
            row["padded_copy_graph_ms"] = graph_ms(torch, [lambda: [
                F.pad(t, (0, -D % 8)) for t in (q, k, v)]]
                * RING_GRAPH_CALLS)[0]
        if label == "full":
            # the launch plan's choice against the other launches
            row["graph_ms_by_splits"] = {
                s: graph_ms(torch, [lambda s=s: kernel(s)]
                            * RING_GRAPH_CALLS)[0] for s in sweep}
        row["plain_ms"] = cuda_ms(torch, lambda i: (
            ra._block_attention_reference(q, k, v, q_off, k_off, True)), 2)
        # yardstick only (the port never calls it): one SDPA call on the
        # same block, GQA unrepeated, timed the same three ways. It returns
        # normalised o alone (no m, l), so it does slightly less; it has no
        # counterpart of a block that sees no key
        row["library_ms"] = None
        if label != "masked":
            def sdpa():
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=label == "diagonal", enable_gqa=True)

            row["library_ms"] = cuda_ms(torch, lambda i: sdpa(), 10)
            row["library_graph_ms"] = graph_ms(
                torch, [sdpa] * RING_GRAPH_CALLS)[0]
            if profiled:
                (row["library_profiled_ms"],
                 row["library_profiled_kernels"]) = profiled_ms(torch, sdpa)
        row.update(bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, flops=flops)
        rows[label] = row
        emit({"phase": "kernel", "name": "ring_block_attention", **row})
    del q, k, v
    torch.cuda.empty_cache()
    return rows


def sched_bytes(C, E, K, N, R, node_of=False):
    """Bytes a tick or a drive must move at least: each input read once
    (state 1 byte, indeg, cls and pin 4 bytes a task; src and dst 4 bytes
    and consumed 1 an edge; demands, avail and cap), each output written
    once (state, indeg, consumed, avail; node_of 4 bytes a task where the
    caller gets it)."""
    return (13 * C + 9 * E + 4 * (K * R + 2 * N * R)
            + 5 * C + E + 4 * N * R + (4 * C if node_of else 0))


def bound_row(nbytes):
    """The bound of byte-bound work, as the kernel table's keys."""
    return {"bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes}


def pack_batch(seed=0):
    """The gang batch of the pack checks: (demands [G, B, 4], tiers [G],
    cap [N, 4]) as numpy, from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cap = np.zeros((PACK_NODES, 4), dtype=np.float32)
    cap[:, 0] = rng.integers(4, 17, PACK_NODES)
    cap[:, 1] = rng.integers(0, 3, PACK_NODES)
    demands = np.zeros((PACK_GANGS, PACK_BUNDLES, 4), dtype=np.float32)
    demands[..., 0] = rng.integers(1, 5, (PACK_GANGS, PACK_BUNDLES))
    demands[..., 1] = rng.integers(0, 2, (PACK_GANGS, PACK_BUNDLES))
    return demands, rng.integers(0, 3, PACK_GANGS), cap


def pack_check(sk, dev, strict):
    """pack_many_tiered on ``dev`` (None: its default, the card) against
    the numpy oracle pack_gangs_tiered_np on pack_batch (every bundle
    demands a CPU, so the oracle's exemption of empty bundles from
    spreading never applies): node_of, ok and avail must be equal.
    Returns (equal, the result)."""
    import numpy as np

    demands, tiers, cap = pack_batch()
    want = sk.pack_gangs_tiered_np(demands, tiers, cap.copy(), cap,
                                   spread=np.full(PACK_GANGS, strict))
    got = sk.pack_many_tiered(demands, tiers, cap.copy(), cap,
                              strict_spread=strict, device=dev)
    got = tuple(x.cpu().numpy() for x in got)
    return all(np.array_equal(a, b) for a, b in zip(got, want)), got


def _sched_graphs():
    from ray_tpu_torch._private import benchmarks as B

    return {name: build() for name, build in B.CONFIGS.items()}


def phase_sched_kernel(torch, dev, timed=True):
    """The scheduler's kernels against their plain versions, on the card.
    For each BASELINE graph at full size, the CUDA tick (instant) is
    stepped from the start and held, tick by tick, to tick_reference on
    the same inputs: state, indeg, avail, node_of and consumed equal; one
    non-instant tick likewise. assign (64 classes, class masks, SPREAD
    classes) against the plain version. pack_many, untiered and tiered,
    against the plain version and the numpy oracle. timed: one instant
    tick of the 1M fan-out (device time from CUDA-graph replays of the
    wrapper call; eager; the plain version's) and the pack's times, each
    with its bound. Raises after every check has printed if any failed."""
    import numpy as np

    from ray_tpu_torch._private import benchmarks as B
    from ray_tpu_torch._private.scheduler import kernels as sk

    problems, rows, avail_err = [], {}, 0.0
    for name, g in _sched_graphs().items():
        st = B.device_state(g, dev)
        cur, ticks, bad = st, 0, None
        while ticks < g.max_ticks and bool((cur[0] == sk.WAITING).any()):
            got = sk.tick(*cur, threshold=SCHED_THRESHOLD,
                          instant_completion=True)
            want = sk.tick_reference(*cur, SCHED_THRESHOLD, True)
            avail_err = max(avail_err, float((got[2] - want[2]).abs().max()))
            same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
            if not all(same):
                bad = {"tick": ticks, "equal": dict(zip(
                    ("state", "indeg", "avail", "node_of", "consumed"),
                    same))}
                break
            cur = (got[0], got[1], *cur[2:5], got[2], *cur[6:9], got[4])
            ticks += 1
        once = [bool(torch.equal(a, b)) for a, b in zip(
            sk.tick(*st, threshold=SCHED_THRESHOLD),
            sk.tick_reference(*st, SCHED_THRESHOLD, False))]
        done = bool((cur[0] == sk.DONE).all())
        row = {"graph": name, "tasks": len(g.indeg), "edges": len(g.src),
               "ticks": ticks, "want_ticks": SCHED_TICKS[name],
               "tick_by_tick_equal": bad is None, "first_difference": bad,
               "non_instant_equal": all(once), "all_done": done}
        emit({"phase": "kernel", "name": "scheduler_tick", **row})
        problems += [f"{name}: {what}" for what, failed in (
            (f"tick {ticks} differs: {bad}", bad is not None),
            ("the non-instant tick differs", not all(once)),
            (f"{ticks} ticks, want {SCHED_TICKS[name]}",
             ticks != SCHED_TICKS[name]),
            ("not every task DONE", not done)) if failed]
        del st, cur

    rng = np.random.default_rng(7)
    K, C, N = 64, 4096, 64
    demands = np.zeros((K, 4), dtype=np.float32)
    demands[:, 0] = rng.integers(1, 4, K)
    demands[:, 1] = rng.choice([0.0, 0.25, 0.5], K)
    cls = rng.integers(0, K, C).astype(np.int32)
    cap = np.zeros((N, 4), dtype=np.float32)
    cap[:, 0] = rng.integers(16, 64, N)
    cap[:, 1] = rng.integers(0, 4, N)
    mask = rng.random((K, N)) < 0.8
    spread = rng.random(K) < 0.25
    got = sk.assign(cls, demands, cap.copy(), cap, 0.5, mask, spread,
                    device="cuda")
    want = sk.assign(cls, demands, cap.copy(), cap, 0.5, mask, spread,
                     device="cpu")
    same = all(np.array_equal(a, b) for a, b in zip(got, want))
    emit({"phase": "kernel", "name": "scheduler_assign", "classes": K,
          "tasks": C, "nodes": N, "assigned": int((got[0] >= 0).sum()),
          "equal": same})
    if not same:
        problems.append("assign differs from its plain version")

    for strict in (False, True):
        oracle_ok, _got = pack_check(sk, dev, strict)
        demands, _tiers, cap_np = pack_batch()
        args = [torch.as_tensor(x, device=dev) for x in (demands, cap_np,
                                                         cap_np)]
        plain = sk.pack_many_reference(*args, strict)
        kern = sk.pack_many(*args, strict_spread=strict)
        same = all(bool(torch.equal(a, b)) for a, b in zip(kern, plain))
        row = {"strict_spread": strict, "gangs": PACK_GANGS,
               "bundles": PACK_BUNDLES, "nodes": PACK_NODES,
               "placed": int(kern[1].sum()), "equal_plain": same,
               "equal_oracle": oracle_ok, "max_abs_err": float(
                   (kern[2] - plain[2]).abs().max())}
        if timed and not strict:
            row["ms"] = cuda_ms(torch, lambda i: sk.pack_many(
                *args, strict_spread=strict), 20)
            row["plain_ms"] = cuda_ms(torch, lambda i: sk.pack_many_reference(
                *args, strict), 1)
            row.update(bound_row(
                demands.nbytes + 3 * cap_np.nbytes + 4 * demands.shape[0]
                * demands.shape[1] + demands.shape[0]))
            rows["pack_many"] = row
        emit({"phase": "kernel", "name": "pack_many", **row})
        problems += [f"pack_many (strict_spread={strict}): {what}"
                     for what, failed in (
                         ("differs from its plain version", not same),
                         ("differs from pack_gangs_tiered_np",
                          not oracle_ok)) if failed]

    if timed:
        g = _sched_graphs()["north_star"]
        st = B.device_state(g, dev)
        (C, E), (N, R), K = (len(g.indeg), len(g.src)), g.cap.shape, \
            g.demands.shape[0]
        row = {"graph": "north_star", "tasks": C, "max_abs_err": avail_err,
               "ms": graph_ms(torch, [lambda: sk.tick(
                   *st, threshold=SCHED_THRESHOLD,
                   instant_completion=True)])[0],
               "eager_ms": cuda_ms(torch, lambda i: sk.tick(
                   *st, threshold=SCHED_THRESHOLD, instant_completion=True),
                   20),
               "plain_ms": cuda_ms(torch, lambda i: sk.tick_reference(
                   *st, SCHED_THRESHOLD, True), 5),
               **bound_row(sched_bytes(C, E, K, N, R, node_of=True))}
        rows["scheduler_tick"] = row
        emit({"phase": "kernel", "name": "scheduler_tick", **row})
    if problems:
        raise AssertionError(f"scheduler kernels: {problems}")
    return rows


def sched_table(sched_rows, star_rows, launches):
    """The scheduler's rows of the kernel table, from phase_sched_kernel's
    rows, phase_north_star's rows and its launch counters: the tick (one
    instant tick of the 1M fan-out), the drive (the north star) and the
    gang pack. They replace XLA device paths, not Pallas kernels; integer
    outputs are exact, so max_abs_err is avail's (f32). No one PyTorch
    call computes any of them."""
    source = "ray_tpu_torch/ops/csrc/scheduler_tick.cu"
    ref = "ray_tpu/_private/scheduler/kernels.py"
    tick, star, pack = (sched_rows["scheduler_tick"],
                        star_rows["north_star"], sched_rows["pack_many"])
    return [{"name": name, "route": "cuda", "source": source,
             "replaces": f"{ref}:{line} (XLA)", "launches": launches[key],
             "max_abs_err": row["max_abs_err"], "ms": row[ms],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": None}
            for name, line, row, key, ms in (
                ("scheduler_tick", 707, tick, "tick", "ms"),
                ("scheduler_drive", 738, star, "drive", "device_ms"),
                ("pack_many", 302, pack, "pack_many", "ms"))]


def drive_breakdown(torch, sk, st, g):
    """One CUDA-graph replay of g's drive (as run_graph captures it) under
    torch.profiler: device time by kernel and the device's busy time
    (profile_call)."""
    drv = sk.Drive(*st, threshold=SCHED_THRESHOLD, max_ticks=g.max_ticks)
    drv.launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        drv.launch()
    graph.replay()
    torch.cuda.synchronize()
    return profile_call(torch, graph.replay)


def phase_north_star(torch, dev):
    """The scheduler's main path: every BASELINE graph at full size driven
    to completion on the card through benchmarks.run_graph (one Drive run
    eagerly, captured in a CUDA graph, replayed), and the gang batch
    admitted through pack_many_tiered, with the launch counters zeroed
    just before and read just after. Beforehand, for each graph: two
    kernels.drive calls bit-identical, every task DONE, the table's
    ticks, avail back at cap, and equal to the plain drive on the card
    (timed three times by the host clock; plain_ms is their median); the
    device time with max_ticks cut to the ticks the graph needs
    (tight_ms: the rest of device_ms is the empty ticks'); for the two
    north-star graphs, one replay under torch.profiler. Prints one line
    per graph and the north star's line. Returns (the launch counters,
    the rows)."""
    from ray_tpu_torch._private import benchmarks as B
    from ray_tpu_torch._private.scheduler import kernels as sk

    graphs = _sched_graphs()
    problems, rows = [], {}
    for name, g in graphs.items():
        st = B.device_state(g, dev)
        first = sk.drive(*st, threshold=SCHED_THRESHOLD,
                         max_ticks=g.max_ticks)
        second = sk.drive(*st, threshold=SCHED_THRESHOLD,
                          max_ticks=g.max_ticks)
        plain_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = sk.drive_reference(*st, SCHED_THRESHOLD, g.max_ticks)
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - t0) * 1e3)
        ticks = int(first[4])
        (C, E), (N, R), K = (len(g.indeg), len(g.src)), g.cap.shape, \
            g.demands.shape[0]
        rows[name] = {
            "graph": name, "tasks": C, "edges": E, "classes": K, "nodes": N,
            "max_ticks": g.max_ticks, "ticks": ticks,
            "want_ticks": SCHED_TICKS[name],
            "plain_ms": sorted(plain_ms)[1], "plain_runs_ms": plain_ms,
            "max_abs_err": float((first[2] - plain[2]).abs().max()),
            "tight_ms": B.run_graph(
                dataclasses.replace(g, max_ticks=max(ticks, 1)),
                SCHED_THRESHOLD, device=dev,
                repeats=SCHED_REPEATS)["scheduling_ms"],
            **bound_row(sched_bytes(C, E, K, N, R))}
        if name.startswith("north_star"):
            rows[name]["profile"] = drive_breakdown(torch, sk, st, g)
        problems += [f"{name}: {what}" for what, failed in (
            (f"{ticks} ticks, want {SCHED_TICKS[name]}",
             ticks != SCHED_TICKS[name]),
            ("not every task DONE", not bool((first[0] == sk.DONE).all())),
            ("avail not back at cap", not bool(torch.equal(first[2], st[6]))),
            ("two drives differ", not all(bool(torch.equal(a, b))
                                          for a, b in zip(first, second))),
            ("differs from the plain drive", not all(
                bool(torch.equal(a, b)) for a, b in zip(first, plain))))
            if failed]
        del st, first, second, plain
    torch.cuda.empty_cache()

    counters = (sk.tick, sk.drive, sk.pack_many, sk.pack_many_tiered)
    # the main path: counters from zero, then every graph and the pack
    for fn in counters:
        fn.launches = 0
    results = {name: B.run_graph(g, SCHED_THRESHOLD, device=dev,
                                 repeats=SCHED_REPEATS)
               for name, g in graphs.items()}
    packed, _got = pack_check(sk, None, strict=False)   # the default card
    launches = {fn.__name__: fn.launches for fn in counters}
    runs = B.EAGER_RUNS + 1     # the eager launches and the capture
    want = {"tick": runs * sum(g.max_ticks for g in graphs.values()),
            "drive": runs * len(graphs), "pack_many": 1,
            "pack_many_tiered": 1}
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    if not packed:
        problems.append("pack_many_tiered differs from the oracle")
    for name, r in results.items():
        row = {**rows[name], "device_ms": r["scheduling_ms"],
               "host_ms": r["host_ms"], "eager_host_ms": r["eager_host_ms"],
               "tasks_per_sec": r["tasks_per_sec"], "device": r["device"]}
        row["empty_ticks_ms"] = row["device_ms"] - row["tight_ms"]
        row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
        rows[name] = row
        emit({"phase": "north_star", **row})
        if r["ticks"] != SCHED_TICKS[name]:
            problems.append(f"{name}: run_graph made {r['ticks']} ticks")
    star = rows["north_star"]
    emit({"phase": "north_star", "metric":
          "north_star_1M_fanout_scheduling_overhead",
          "value_ms": star["device_ms"], "host_ms": star["host_ms"],
          "target_ms": NORTH_STAR_TARGET_MS,
          "met": star["device_ms"] < NORTH_STAR_TARGET_MS,
          "waves_64_ms": rows["north_star_waves"]["device_ms"],
          "launches": launches, "nvidia_smi": nvidia_smi(),
          "ok": not problems})
    if problems:
        raise AssertionError(f"north_star phase: {problems}")
    return launches, rows


def phase_engine(torch):
    """The main path: the engine at full width, bf16: the serving model
    (SERVE, head_dim 128, profiled), the default TransformerConfig()
    (head_dim 64) and Phi-3-mini's widths at all 32 layers (PHI3_MINI,
    head_dim 96) at the same load, and each configuration of width_models
    at WIDTH_SLOTS x WIDTH_NEW. Returns kernel 1's launches of each timed
    round: {"serve": n, "default": n, head_dim: n}."""
    launches = {
        "serve": engine_run(torch, "serve", SERVE, SLOTS, NEW_TOKENS,
                            profile=True),
        "default": engine_run(torch, "default", DEFAULT, SLOTS, NEW_TOKENS),
        PHI3_HEAD_DIM: engine_run(torch, "phi3_mini", PHI3_MINI, SLOTS,
                                  NEW_TOKENS)}
    torch.cuda.empty_cache()
    for D, fields in width_models().items():
        launches[D] = engine_run(torch, f"head_dim_{D}", fields, WIDTH_SLOTS,
                                 WIDTH_NEW)
    return launches


def width_models():
    """{head_dim: TransformerConfig fields}: the repo's configurations at
    the widths no main path runs, each with max_seq_len WIDTH_RING_SEQ.
    16: the smoke decode model (perf.SMOKE_DECODE, the reference's); 32:
    the smoke model (perf.SMOKE_MODEL); 256: TRAIN_D256."""
    from ray_tpu_torch._private import perf

    keys = ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
            "d_ff")
    return {16: {**{k: perf.SMOKE_DECODE[k] for k in keys},
                 "max_seq_len": WIDTH_RING_SEQ},
            32: {**{k: perf.SMOKE_MODEL[k] for k in keys},
                 "max_seq_len": WIDTH_RING_SEQ},
            256: {**TRAIN_D256, "max_seq_len": WIDTH_RING_SEQ}}


def engine_run(torch, label, fields, slots, new_tokens, profile=False):
    """One configuration (TransformerConfig fields, bf16, seeded random
    params) through the serving engine: a warm round, then a timed round
    of `slots` requests x `new_tokens` with kernel 1's counter zeroed just
    before and read just after (every layer of every decode step must
    have launched it); profile: one more round under torch.profiler.
    Prints the phase line; returns the timed round's launches."""
    from ray_tpu_torch.models.inference import (InferenceConfig,
                                                InferenceEngine)
    from ray_tpu_torch.models.transformer import (TransformerConfig,
                                                  init_params, param_count)
    from ray_tpu_torch.ops import paged_attention as pa

    mcfg = TransformerConfig(dtype=torch.bfloat16, **fields)
    params = init_params(mcfg, torch.Generator(device="cuda").manual_seed(0))
    icfg = InferenceConfig(
        batch_size=slots, page_size=PAGE, max_pages_per_seq=MAX_PAGES,
        num_pages=NUM_PAGES * slots // SLOTS,
        prefill_buckets=(16,), max_new_tokens=new_tokens)
    engine = InferenceEngine(params, mcfg, icfg)
    prompts = [[i + 1] * 4 for i in range(slots)]
    breakdown = None
    try:
        for f in [engine.submit(p, new_tokens) for p in prompts]:
            f.result(timeout=600)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path: counters from zero, then one timed round
        pa.paged_attention.launches = 0
        steps0 = engine.decode_steps
        t0 = time.perf_counter()
        outs = [f.result(timeout=600)
                for f in [engine.submit(p, new_tokens) for p in prompts]]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = pa.paged_attention.launches
        steps = engine.decode_steps - steps0
        if profile:
            breakdown = profile_call(torch, lambda: [
                f.result(timeout=600)
                for f in [engine.submit(p, new_tokens) for p in prompts]])
    finally:
        engine.shutdown()
    if launches == 0 or launches != mcfg.n_layers * steps:
        raise AssertionError(f"{label}: paged_attention launches {launches} "
                             f"!= {mcfg.n_layers} layers x {steps} decode "
                             f"steps")
    bad = [o for o in outs if len(o) != new_tokens
           or not all(0 <= t < mcfg.vocab_size for t in o)]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} malformed generations")
    total = sum(len(o) for o in outs)
    row = {"phase": "engine", "model": label, "head_dim": mcfg.head_dim,
           "requests": slots, "new_tokens": new_tokens,
           "n_params": param_count(params), "tokens": total, "seconds": dt,
           "tokens_per_s": total / dt, "decode_steps": steps,
           "ms_per_decode_step": dt / steps * 1e3,
           "paged_attention_launches": launches,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "distinct_generations": len({tuple(o) for o in outs})}
    if breakdown is not None:
        # the profiled round does the timed round's work; its wall time is
        # inflated by the profiler, so the share uses the timed wall
        row.update(device_busy_share=breakdown["device_busy_us"] / (dt * 1e6),
                   profile=breakdown)
    emit(row)
    return launches


# device time grouped by kernel name (the rest is "other"); the sm90
# forwards are one template, told apart by their epilogue, and the sm90
# backward kernels are the flash backward's
KERNEL_GROUPS = (("flash attention", ("flash_", "FlashFwdOut",
                                      "attention_bwd_")),
                 ("ring attention", ("ring_block", "RingBlockOut")),
                 ("paged attention", ("paged_decode",)),
                 ("scheduler", ("sched_",)),
                 ("matrix products", ("nvjet", "gemm", "xmma", "cutlass")))


def kernel_group(name):
    """The KERNEL_GROUPS group of a device kernel's name, else "other"."""
    return next((g for g, keys in KERNEL_GROUPS
                 if any(k in name for k in keys)), "other")


def profile_call(torch, fn, allow_empty=False):
    """fn() once more under torch.profiler (one engine round, one train
    step): device time by kernel name and by group, from the device's own
    kernel and copy events (not the host ops that launched them), and the
    device's busy time, the union of those events' intervals. A session
    that recorded no device activity raises, or with allow_empty returns
    None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the wall time of fn() alone: the profiler's own start and stop
        # (trace collection) lie outside it
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        if allow_empty:
            return None
        raise AssertionError("the profiler recorded no device activity")
    busy, reach, by_name = 0.0, float("-inf"), {}
    for start, end, name in spans:
        if end > reach:
            busy += end - max(start, reach)
            reach = end
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + end - start, count + 1)
    groups = {}
    for name, (total, _count) in by_name.items():
        group = kernel_group(name)
        groups[group] = groups.get(group, 0.0) + total
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_us": wall_us, "device_busy_us": busy,
            "device_us_by_group": groups,
            "top": [{"name": name[:80], "device_us": total, "count": count}
                    for name, (total, count) in top]}


def greedy_parity(torch, logits_of, prompts, outs, n_new,
                  tie_gap=PARITY_TIE_GAP):
    """Each of outs against the greedy tokens of logits_of(tokens) (the
    last position's logits), re-run at every step. A mismatch passes only
    at a true near-tie (top-2 gap below tie_gap), after which the
    continuations diverge and that prompt's comparison stops. Returns
    (tokens compared, near ties); raises on any other mismatch."""
    compared, ties = 0, []
    for prompt, out in zip(prompts, outs):
        if len(out) != n_new:
            raise AssertionError(f"{len(out)} tokens for prompt {prompt}, "
                                 f"not {n_new}")
        toks = list(prompt)
        for step in range(n_new):
            logits = logits_of(toks)
            want = int(torch.argmax(logits))
            compared += 1
            if out[step] != want:
                top2 = torch.topk(logits, 2).values
                gap = float(top2[0] - top2[1])
                if gap >= tie_gap:
                    raise AssertionError(
                        f"greedy mismatch for prompt {prompt} at step "
                        f"{step}: got {out[step]}, model {want}, "
                        f"top-2 gap {gap}")
                ties.append({"prompt": prompt, "step": step, "gap": gap})
                break  # the continuations diverge after a near-tie
            toks.append(want)
    return compared, ties


def parity_setup(torch, fields=SERVE):
    """Phase parity's f32 model (TF32 off; TransformerConfig fields, SERVE
    unless given) with its seeded params (seed 1), its engine config
    (batch 4) and its oracle: the full-context model without a kernel
    ("auto" would route its attention through the flash kernel on the
    card), as logits_of for greedy_parity."""
    from ray_tpu_torch.models.inference import InferenceConfig
    from ray_tpu_torch.models.transformer import (TransformerConfig,
                                                  init_params,
                                                  model_from_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mcfg = TransformerConfig(dtype=torch.float32, **fields)
    params = init_params(mcfg, torch.Generator(device="cuda").manual_seed(1))
    icfg = InferenceConfig(batch_size=len(PARITY_PROMPTS), page_size=PAGE,
                           max_pages_per_seq=MAX_PAGES, num_pages=128,
                           prefill_buckets=(16,), max_new_tokens=PARITY_NEW)
    model = model_from_params(
        dataclasses.replace(mcfg, flash_attention="off"), params)

    @torch.no_grad()
    def logits_of(toks):
        return model(torch.tensor([toks], device="cuda"))[0, -1]

    return mcfg, params, icfg, logits_of


def phase_parity(torch):
    """f32 greedy parity: the engine (through the kernel) vs the
    full-context model (no kernel), re-run at every step, at the serving
    width (head_dim 128), the default TransformerConfig's (64) and
    Phi-3-mini's (96, at PHI3_PARITY_LAYERS layers)."""
    from ray_tpu_torch.models.inference import InferenceEngine

    for label, fields in (("serve", SERVE), ("default", DEFAULT),
                          ("phi3_mini", {**PHI3_MINI,
                                         "n_layers": PHI3_PARITY_LAYERS})):
        mcfg, params, icfg, logits_of = parity_setup(torch, fields)
        engine = InferenceEngine(params, mcfg, icfg)
        try:
            got = [f.result(timeout=600) for f in
                   [engine.submit(p, PARITY_NEW) for p in PARITY_PROMPTS]]
        finally:
            engine.shutdown()
        compared, ties = greedy_parity(torch, logits_of, PARITY_PROMPTS, got,
                                       PARITY_NEW)
        emit({"phase": "parity", "model": label, "head_dim": mcfg.head_dim,
              "dtype": "float32", "prompts": len(PARITY_PROMPTS),
              "tokens_compared": compared, "near_ties": ties})
        del params, logits_of
        torch.cuda.empty_cache()


def _train_setup(torch, dtype, batch, fields=TRAIN):
    """The flagship train configuration (TRAIN, or the given fields;
    remat "dots") with its seeded random params (seed 0) and tokens
    [batch, TRAIN_SEQ] (seed 1)."""
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params

    cfg = TransformerConfig(dtype=dtype, max_seq_len=TRAIN_SEQ, remat=True,
                            remat_policy="dots", **fields)
    gen = torch.Generator(device="cuda")
    params = init_params(cfg, gen.manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (batch, TRAIN_SEQ),
                           generator=gen.manual_seed(1), device="cuda")
    return cfg, params, tokens


def _flash_kernels():
    from ray_tpu_torch.ops import flash as fl

    return {n: getattr(fl, n) for n in FLASH_NAMES}


def phase_train_parity(torch):
    """The model's flash branch (transposed views, the GQA repeat, the
    autograd Function under selective checkpointing) against its einsum
    branch: one forward and backward at the train width, batch 2, on the
    same params and tokens, in f32 (TF32 off) and bf16, with TRAIN's heads
    (head_dim 128) and TRAIN_D256's (256). Raises after all have printed
    if a difference is out of bounds or the flash branch did not launch
    every kernel in every layer."""
    from ray_tpu_torch.models.train_step import _global_norm
    from ray_tpu_torch.models.transformer import (cross_entropy_loss,
                                                  model_from_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = _flash_kernels()
    layers, failed = TRAIN["n_layers"], []
    # forward and the recompute of each block in backward; dq, dk/dv once
    want = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers}
    for fields, dtype in itertools.product((TRAIN, TRAIN_D256),
                                           (torch.float32, torch.bfloat16)):
        name = str(dtype).replace("torch.", "")
        cfg, params, tokens = _train_setup(torch, dtype, TRAIN_PARITY_BATCH,
                                           fields)
        runs = {}
        for mode in ("auto", "off"):
            model = model_from_params(
                dataclasses.replace(cfg, flash_attention=mode), params)
            for kern in kernels.values():
                kern.launches = 0
            loss = cross_entropy_loss(model(tokens[:, :-1]), tokens[:, 1:])
            loss.backward()
            runs[mode] = (float(loss.detach()),
                          {k: p.grad.float() for k, p in
                           model.named_parameters()},
                          {n: k.launches for n, k in kernels.items()})
            del model, loss
        (loss_f, grads_f, launches_f), (loss_o, grads_o, launches_o) = (
            runs["auto"], runs["off"])
        norm_f = float(_global_norm(grads_f.values()))
        norm_o = float(_global_norm(grads_o.values()))
        leaf = {k: float(torch.linalg.vector_norm(grads_f[k] - g)
                         / torch.linalg.vector_norm(g))
                for k, g in grads_o.items()}
        worst = max(leaf, key=leaf.get)
        b_loss, b_norm, b_leaf = TRAIN_PARITY_BOUNDS[name]
        row = {"phase": "train_parity", "dtype": name,
               "head_dim": cfg.head_dim,
               "batch": TRAIN_PARITY_BATCH, "loss_flash": loss_f,
               "loss_einsum": loss_o, "loss_diff": abs(loss_f - loss_o),
               "grad_norm_flash": norm_f, "grad_norm_einsum": norm_o,
               "grad_norm_rel_diff": abs(norm_f - norm_o) / norm_o,
               "worst_leaf": worst, "worst_leaf_rel_l2": leaf[worst],
               "bounds": [b_loss, b_norm, b_leaf],
               "launches_flash": launches_f, "launches_einsum": launches_o}
        row["ok"] = (row["loss_diff"] <= b_loss
                     and row["grad_norm_rel_diff"] <= b_norm
                     and leaf[worst] <= b_leaf and launches_f == want
                     and not any(launches_o.values()))
        emit(row)
        if not row["ok"]:
            failed.append(f"{name}, head_dim {cfg.head_dim}")
        del params, tokens, runs, grads_f, grads_o
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"flash branch vs einsum branch out of bounds "
                             f"or not launched per layer: {failed}")


def phase_train(torch):
    """The train main path: the flagship configuration through the
    trainer's entry points (5 timed steps at [16, 2048], head_dim 128),
    then its heads regrouped as 8 x 256 (TRAIN_D256, the same depth), each
    profiled. Returns each flash kernel's launches in the timed steps:
    {head_dim: {kernel: launches}}."""
    return {FLASH_D: train_run(torch, TRAIN, TRAIN_BATCH, TRAIN_WARMUP,
                               TRAIN_STEPS, profile=True),
            256: train_run(torch, TRAIN_D256, TRAIN_D256_BATCH,
                           TRAIN_D256_WARMUP, TRAIN_D256_STEPS,
                           profile=True)}


def train_run(torch, fields, batch_size, warmup, steps, profile=False):
    """One train configuration (TransformerConfig fields at TRAIN_SEQ,
    bf16, remat "dots") through make_optimizer and make_train_step:
    `warmup` steps, then `steps` timed steps with the flash launch
    counters zeroed just before; profile: one more step under
    torch.profiler. Prints the phase line; returns each flash kernel's
    launches in the timed steps."""
    import math

    from ray_tpu_torch._private.perf import _peak_flops, flops_per_step
    from ray_tpu_torch.models import train_step as ts
    from ray_tpu_torch.models.transformer import Transformer, param_count

    kernels = _flash_kernels()
    cfg, params, tokens = _train_setup(torch, torch.bfloat16, batch_size,
                                       fields)
    n_params = param_count(params)
    model = Transformer(cfg).load_params(params)
    del params
    step = ts.make_train_step(model, ts.make_optimizer(model.parameters()))
    batch = {"tokens": tokens}
    for _ in range(warmup):
        step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counters from zero, then the timed steps
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    metrics = [step(batch) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    launches = {n: k.launches for n, k in kernels.items()}
    peak_mem = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    grad_norms = [float(m["grad_norm"]) for m in metrics]
    breakdown = profile_call(torch, lambda: step(batch)) if profile else None
    layers = cfg.n_layers
    # backward: each layer's attention runs dq and dk/dv once per step.
    # forward: remat "dots" saves only matrix-product outputs, and the flash
    # kernel launches through ctypes (no aten matmul), so its output is not
    # saved: each layer's forward kernel runs in the forward and again when
    # the block is recomputed for backward
    want = {"flash_fwd": 2 * layers * steps, "flash_bwd_dq": layers * steps,
            "flash_bwd_dkv": layers * steps}
    if launches != want:
        raise AssertionError(f"flash launches {launches} != {want} "
                             f"({layers} layers x {steps} steps, head_dim "
                             f"{cfg.head_dim})")
    if not all(math.isfinite(x) for x in losses + grad_norms):
        raise AssertionError(f"non-finite loss or grad norm: {losses} "
                             f"{grad_norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    model_flops = flops_per_step(n_params, batch_size, TRAIN_SEQ)
    peak = _peak_flops(torch.cuda.get_device_name())
    row = {"phase": "train", "device": torch.cuda.get_device_name(),
           "head_dim": cfg.head_dim, "heads": cfg.n_heads,
           "kv_heads": cfg.n_kv_heads,
           "n_params": n_params, "batch_size": batch_size,
           "seq_len": TRAIN_SEQ, "step_ms": dt * 1e3,
           "tokens_per_sec": batch_size * TRAIN_SEQ / dt,
           "mfu": model_flops / dt / peak if peak else None,
           "peak_flops": peak, "peak_mem_bytes": peak_mem, "losses": losses,
           "grad_norms": grad_norms, "remat_policy": "dots",
           "dtype": "bfloat16", "steps": steps, "warmup_steps": warmup,
           "launches": launches}
    if breakdown is not None:
        row.update(device_busy_share=breakdown["device_busy_us"] / (dt * 1e6),
                   profile=breakdown)
    emit(row)
    del model, step, batch, tokens
    torch.cuda.empty_cache()
    return launches


def _logit_diff(torch, got, want):
    """Relative L2 difference of two [B, S, V] logit tensors over every
    element, the largest absolute difference, and the share of positions
    whose argmax agrees; 1024 positions at a time, so no f32 copy of the
    whole tensor."""
    diff2 = ref2 = 0.0
    max_abs, agree = 0.0, 0
    for i in range(0, got.shape[1], 1024):
        a, b = got[:, i:i + 1024].float(), want[:, i:i + 1024].float()
        diff2 += float((a - b).square().sum())
        ref2 += float(b.square().sum())
        max_abs = max(max_abs, float((a - b).abs().max()))
        agree += int((a.argmax(-1) == b.argmax(-1)).sum())
    return {"rel_l2": (diff2 / ref2) ** 0.5, "max_abs_err": max_abs,
            "argmax_agree": agree / (got.shape[0] * got.shape[1])}


def phase_ring(torch, dev):
    """The ring main path, through ring_width_run at each width: the train
    configuration's forward at RING_SEQ tokens through make_forward under
    a seq=4 mesh on one card, with what only that run checks (ring_extras);
    then the default TransformerConfig() (head_dim 64) at DEFAULT_RING_SEQ,
    Phi-3-mini's widths (96) at PHI3_RING_LAYERS layers and PHI3_RING_SEQ
    tokens, and each configuration of width_models at WIDTH_RING_SEQ.
    Returns kernel 2's launches in each timed call: {head_dim: n}."""
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(seq=RING_SHARDS), [dev] * RING_SHARDS)
    out = {FLASH_D: ring_width_run(
        torch, dev, mesh, "train", TRAIN, RING_SEQ, f32_seq=RING_F32_SEQ,
        ref_seq=RING_REF_SEQ,
        extras=lambda *a: ring_extras(torch, mesh, *a)),
        64: ring_width_run(torch, dev, mesh, "default", DEFAULT,
                           DEFAULT_RING_SEQ, f32_seq=RING_F32_SEQ),
        PHI3_HEAD_DIM: ring_width_run(
            torch, dev, mesh, "phi3_mini",
            {**PHI3_MINI, "n_layers": PHI3_RING_LAYERS}, PHI3_RING_SEQ)}
    for D, fields in width_models().items():
        out[D] = ring_width_run(torch, dev, mesh, f"head_dim_{D}", fields,
                                WIDTH_RING_SEQ)
    return out


def ring_extras(torch, mesh, model, forward, tokens, logits):
    """What only the train configuration's ring run checks, after its
    timed call: the last shard's tokens replaced leave the earlier shards'
    logits bit-identical and change the last's; a call under autograd
    raises (kernel 2 has no backward); one call's profile; and its logits
    against the flash branch (no mesh) at full length, within
    RING_PARITY_BOUNDS["bfloat16"]. Returns (row fields, problems)."""
    from ray_tpu_torch.parallel.mesh import use_mesh

    vocab = logits.shape[-1]
    T = tokens.shape[1] // RING_SHARDS
    cut = (RING_SHARDS - 1) * T
    tokens2 = tokens.clone()
    tokens2[:, cut:] = torch.randint(
        0, vocab, (1, T), device=tokens.device,
        generator=torch.Generator(device=tokens.device).manual_seed(2))
    with use_mesh(mesh):
        logits2 = forward(tokens2)
        breakdown = profile_call(torch, lambda: forward(tokens))
        try:
            with torch.enable_grad():
                model(tokens[:, :RING_F32_SEQ])
            grad_raises = None
        except NotImplementedError as e:
            grad_raises = str(e)
    causal_exact = bool(torch.equal(logits[:, :cut], logits2[:, :cut]))
    last_changed = not torch.equal(logits[:, cut:], logits2[:, cut:])
    del logits2
    flash = _logit_diff(torch, logits, forward(tokens))   # no mesh: flash
    flash["bound"] = RING_PARITY_BOUNDS["bfloat16"]
    flash["ok"] = flash["rel_l2"] <= flash["bound"]
    row = {"earlier_shards_bit_identical": causal_exact,
           "last_shard_changed": last_changed, "grad_raises": grad_raises,
           "parity_flash": flash,
           # one call's reading: the profiled call's busy time over its own
           # wall time. The profiler's host cost per eager op can starve
           # the device in that call, so the profiled busy time over the
           # timed call's wall (a ratio of two calls doing the same work)
           # is given beside it, under its own name
           "device_busy_share": (breakdown["device_busy_us"]
                                 / breakdown["wall_us"]),
           "device_busy_us": breakdown["device_busy_us"],
           "profile": breakdown}
    problems = [what for what, bad in (
        ("earlier shards changed", not causal_exact),
        ("last shard unchanged", not last_changed),
        ("no raise under autograd", grad_raises is None),
        (f"flash parity {flash['rel_l2']} > {flash['bound']}",
         not flash["ok"])) if bad]
    return row, problems


def ring_width_run(torch, dev, mesh, label, fields, seq, f32_seq=None,
                   ref_seq=None, extras=None):
    """One configuration (TransformerConfig fields, max_seq_len seq, bf16,
    params seed 0, tokens seed 1) at `seq` tokens through make_forward
    under the seq mesh: a warm call, then a call with kernel 2's counter
    zeroed just before and read just after (layers x shards^2 launches)
    and its peak memory. Its logits over the first ref_seq tokens (default
    all) against the einsum branch of the same parameters (no mesh, no
    flash: no kernel 2 or 3a template behind it) on those tokens, within
    RING_PARITY_BOUNDS["bfloat16"]; f32_seq: also the f32 model (TF32 off)
    at f32_seq tokens against its einsum branch, within
    RING_PARITY_BOUNDS["float32"]. extras(model, forward, tokens, logits)
    -> (row fields, problems): more checks of this run. Prints the phase
    line; returns the launches."""
    from ray_tpu_torch.models.train_step import make_forward
    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  init_params, param_count)
    from ray_tpu_torch.ops import ring_attention as ra
    from ray_tpu_torch.parallel.mesh import use_mesh

    cfg = TransformerConfig(dtype=torch.bfloat16, ring_attention=True,
                            **{**fields, "max_seq_len": seq})
    gen = torch.Generator(device=dev)
    params = init_params(cfg, gen.manual_seed(0))
    n_params = param_count(params)
    model = Transformer(cfg, device=dev).load_params(params)
    forward = make_forward(model)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq),
                           generator=gen.manual_seed(1), device=dev)
    with use_mesh(mesh):
        forward(tokens)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ra.block_attention.launches = 0
        t0 = time.perf_counter()
        logits = forward(tokens)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = ra.block_attention.launches
        peak_mem = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    extra, problems = extras(model, forward, tokens, logits) if extras \
        else ({}, [])
    del model, forward
    ref_seq = ref_seq or seq
    einsum = make_forward(Transformer(
        dataclasses.replace(cfg, flash_attention="off"),
        device=dev).load_params(params))
    parity = {"bfloat16": _logit_diff(torch, logits[:, :ref_seq],
                                      einsum(tokens[:, :ref_seq]))}
    parity["bfloat16"]["seq"] = ref_seq
    del logits, einsum, params
    torch.cuda.empty_cache()
    if f32_seq:
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                    flash_attention="off")
        model32 = Transformer(cfg32, device=dev).load_params(
            init_params(cfg32, gen.manual_seed(0)))
        forward32 = make_forward(model32)
        short = tokens[:, :f32_seq]
        with use_mesh(mesh):
            ring32 = forward32(short)
        parity["float32"] = _logit_diff(torch, ring32, forward32(short))
        parity["float32"]["seq"] = f32_seq
        del model32, ring32
        torch.cuda.empty_cache()
    for name, reading in parity.items():
        reading["bound"] = RING_PARITY_BOUNDS[name]
        reading["ok"] = reading["rel_l2"] <= RING_PARITY_BOUNDS[name]
    want = cfg.n_layers * RING_SHARDS ** 2
    row = {"phase": "ring", "model": label, "head_dim": cfg.head_dim,
           "device": torch.cuda.get_device_name(), "n_params": n_params,
           "batch": 1, "seq_len": seq, "seq_shards": RING_SHARDS,
           "mesh": mesh.shape, "dtype": "bfloat16", "ms": dt * 1e3,
           "tokens_per_s": seq / dt, "block_launches": launches,
           "want_launches": want, "logits_shape": list(shape),
           "finite": finite, "peak_mem_bytes": peak_mem, "parity": parity,
           **extra}
    if "device_busy_us" in extra:
        # the profiled busy time over the timed call's wall (see
        # ring_extras)
        row["device_busy_over_timed_wall"] = (extra["device_busy_us"]
                                              / (dt * 1e6))
    emit(row)
    problems = [what for what, bad in (
        (f"launches {launches} != {want}", launches != want),
        ("logits not finite", not finite),
        (f"logits shape {shape}", shape != (1, seq, cfg.vocab_size)),
        *((f"{n} parity {r['rel_l2']} > {r['bound']}", not r["ok"])
          for n, r in parity.items())) if bad] + problems
    if problems:
        raise AssertionError(f"ring phase, {label}: {problems}")
    return launches


class AssignRecorder:
    """chip_smoke's own instrument on TensorScheduler and kernels._run (the
    package is not changed): while ``snapshots`` is a list, every snapshot
    _assign sees under sched_backend "cuda" is kept with its result; every
    _device_assign call adds (start, k, host seconds, stream span ms,
    kernel span ms) to ``calls``: the stream span between CUDA events
    recorded on the scheduler's stream around the whole call (uploads,
    the tick kernels, the fetch), the kernel span around the one launch
    of the tick kernels (kernels._run) alone. any_backend: keep, under any
    sched_backend, each snapshot that went through the device path; while
    ``schedulers`` is a dict, each scheduler that calls _device_assign is
    entered once with its device assigns before that call. remove()
    restores them."""

    def __init__(self, torch, TS, sk, config, any_backend=False):
        self.TS, self.sk, self.snapshots, self.calls = TS, sk, None, []
        self.schedulers = None
        self._assign, self._device_assign = TS._assign, TS._device_assign
        self._run, self._kernel_events = sk._run, []
        rec = self

        def _run(*args, **kwargs):
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
            events[0].record()          # the current stream: the caller's
            rec._run(*args, **kwargs)
            events[1].record()
            rec._kernel_events.append(events)

        def _assign(sched, snapshot):
            n0 = sched._num_device_assigns
            out = rec._assign(sched, snapshot)
            if rec.snapshots is not None and (
                    config.sched_backend == "cuda" or (
                        any_backend and sched._num_device_assigns > n0)):
                rec.snapshots.append((snapshot, out[1].copy(),
                                      out[2].copy()))
            return out

        def _device_assign(sched, ready_cls, *args):
            if rec.schedulers is not None:
                rec.schedulers.setdefault(sched, sched._num_device_assigns)
            stream, events = sched._stream, None
            if stream is not None:
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                events[0].record(stream)
            rec._kernel_events = []
            t0 = time.perf_counter()
            out = rec._device_assign(sched, ready_cls, *args)
            host_s = time.perf_counter() - t0
            span = kernel = None
            if events is not None:
                events[1].record(stream)
                events[1].synchronize()
                span = events[0].elapsed_time(events[1])
            if rec._kernel_events:
                k0, k1 = rec._kernel_events[0]
                kernel = k0.elapsed_time(k1)
            rec.calls.append((t0, len(ready_cls), host_s, span, kernel))
            return out

        TS._assign, TS._device_assign = _assign, _device_assign
        sk._run = _run

    def remove(self):
        self.TS._assign = self._assign
        self.TS._device_assign = self._device_assign
        self.sk._run = self._run


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def assign_timing(calls, lo=float("-inf"), hi=float("inf")):
    """Median host µs, stream span µs and kernel span µs of the recorded
    device assigns that started in [lo, hi), with their count and median
    batch size."""
    sel = [c for c in calls if lo <= c[0] < hi]
    spans = [c[3] for c in sel if c[3] is not None]
    kernels = [c[4] for c in sel if c[4] is not None]
    return {"assigns": len(sel), "median_k": _median([c[1] for c in sel]),
            "host_us": (_median([c[2] for c in sel]) * 1e6
                        if sel else None),
            "stream_us": _median(spans) * 1e3 if spans else None,
            "kernel_us": _median(kernels) * 1e3 if kernels else None}


def assign_agrees(got, want, ready_cls, spread):
    """The reference's contract between the device path and assign_np
    (tests/test_tensor_scheduler.py, TestManyClasses): avail equal, and
    node_of equal task for task, except in SPREAD classes, whose tasks
    are interchangeable and must land the same count on every node (the
    device path water-fills where assign_np deals round-robin)."""
    import numpy as np

    node_got, node_want = np.asarray(got[0]), np.asarray(want[0])
    if not np.array_equal(got[1], want[1]):
        return False
    spread_task = np.asarray(spread, dtype=bool)[ready_cls]
    if not np.array_equal(node_got[~spread_task], node_want[~spread_task]):
        return False
    n = len(got[1]) + 1
    for c in np.unique(ready_cls[spread_task]):
        sel = ready_cls == c
        if not np.array_equal(np.bincount(node_got[sel] + 1, minlength=n),
                              np.bincount(node_want[sel] + 1, minlength=n)):
            return False
    return True


def replay_oracle(sk, snapshots, threshold):
    """Each recorded snapshot through assign_np, given the full class table
    as _assign's numpy branch builds it: the number of snapshots whose
    node_of or avail the device path did not match (assign_agrees)."""
    import numpy as np

    bad = 0
    for snap, node_of, avail in snapshots:
        ready_idx, ready_cls, demands, avail0, cap, mask, spread = snap[:7]
        cls_full = np.zeros(int(ready_idx.max()) + 1, dtype=np.int32)
        cls_full[ready_idx] = ready_cls
        want = sk.assign_np(ready_idx, cls_full, demands, avail0, cap,
                            threshold, mask, spread)
        if snap[7] is not None:
            # a tick with a locality matrix ran assign_np on the host
            # (kernels.assign has no locality column): hold it to the same
            # call with that matrix
            from ray_tpu_torch._private.config import GLOBAL_CONFIG

            want = sk.assign_np(
                ready_idx, cls_full, demands, avail0, cap, threshold, mask,
                spread, locality=snap[7], outstanding=snap[8],
                spill_depth=GLOBAL_CONFIG.locality_spillback_queue_depth)
        bad += not assign_agrees((node_of, avail), want, ready_cls, spread)
    return bad


def runtime_fanout(ray, n):
    """n no-op tasks through .remote(), then get: (seconds, results)."""
    @ray.remote
    def _noop():
        return None

    t0 = time.perf_counter()
    out = ray.get([_noop.remote() for _ in range(n)], timeout=600)
    return time.perf_counter() - t0, out


def runtime_map_reduce(ray, n_tasks=RUNTIME_TASKS):
    """BASELINE config 2 through @remote, as build_map_reduce shapes it:
    map i returns i; reducer j sums maps [j * fan_in, (j + 1) * fan_in),
    passed as ObjectRef arguments; n_tasks maps and reducers in all.
    Returns (seconds, tasks, the reduced total, the expected total)."""
    @ray.remote
    def _map(i):
        return i

    @ray.remote
    def _reduce(*xs):
        return sum(xs)

    n_reduce = n_tasks // (RUNTIME_FAN_IN + 1)
    n_map = n_tasks - n_reduce
    t0 = time.perf_counter()
    maps = _map.map_remote([(i,) for i in range(n_map)])
    reds = [_reduce.remote(*maps[j * RUNTIME_FAN_IN:(j + 1) * RUNTIME_FAN_IN])
            for j in range(n_reduce)]
    total = sum(ray.get(reds, timeout=900))
    last = n_reduce * RUNTIME_FAN_IN
    return (time.perf_counter() - t0, n_map + n_reduce, total,
            last * (last - 1) // 2)


def runtime_actors(ray, n_actors=RUNTIME_ACTORS, n_calls=RUNTIME_CALLS):
    """BASELINE config 4, cut: n_actors actors, n_calls calls each from
    this caller. Returns (seconds, actors whose results are not
    1..n_calls in call order)."""
    @ray.remote
    class _Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    t0 = time.perf_counter()
    actors = [_Counter.remote() for _ in range(n_actors)]
    refs = [[a.inc.remote() for _ in range(n_calls)] for a in actors]
    got = ray.get([r for rs in refs for r in rs], timeout=900)
    dt = time.perf_counter() - t0
    want = list(range(1, n_calls + 1))
    bad = sum(got[i * n_calls:(i + 1) * n_calls] != want
              for i in range(n_actors))
    for a in actors:
        ray.kill(a)
    return dt, bad


def crossover_snapshot(k, n_classes, seed=0):
    """A TensorScheduler snapshot of k ready tasks over n_classes classes
    on CROSSOVER_NODES nodes: dyadic demands (1-2 CPUs, 0 / 0.25 / 0.5
    GPU), capacities 16-63 CPUs and 0-3 GPUs; with many classes a random
    80% class mask and a quarter of the classes SPREAD."""
    import numpy as np

    rng = np.random.default_rng(seed)
    N, K = CROSSOVER_NODES, n_classes
    demands = np.zeros((K, 4), dtype=np.float32)
    demands[:, 0] = rng.integers(1, 3, K)
    demands[:, 1] = rng.choice([0.0, 0.25, 0.5], K)
    cap = np.zeros((N, 4), dtype=np.float32)
    cap[:, 0] = rng.integers(16, 64, N)
    cap[:, 1] = rng.integers(0, 4, N)
    mask = (rng.random((K, N)) < 0.8) if K > 1 else np.ones((K, N), bool)
    spread = (rng.random(K) < 0.25) if K > 1 else np.zeros(K, bool)
    ready_idx = np.arange(k, dtype=np.int64)
    ready_cls = rng.integers(0, K, k).astype(np.int32)
    return (ready_idx, ready_cls, demands, cap.copy(), cap, mask, spread,
            None, None, None)


def phase_crossover(torch, sched, config):
    """TensorScheduler._assign on crossover snapshots: the median wall time
    of numpy's and cuda's (after two warm calls), and whether they agree
    (assign_agrees). Returns (rows, {class count: the smallest k from
    which cuda wins by 2x at every larger k, or None})."""
    import numpy as np

    rows, wins = [], {}
    for K in CROSSOVER_CLASSES:
        for k in CROSSOVER_K:
            snap = crossover_snapshot(k, K)
            times, outs = {}, {}
            for backend, reps in (("numpy", 5), ("cuda", 20)):
                config.set("sched_backend", backend)
                for _ in range(2):
                    outs[backend] = sched._assign(snap)
                ts = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    sched._assign(snap)
                    ts.append(time.perf_counter() - t0)
                times[backend] = _median(ts) * 1e3
            equal = assign_agrees(outs["cuda"][1:], outs["numpy"][1:],
                                  snap[1], snap[6])
            win = times["cuda"] < 0.5 * times["numpy"]
            wins.setdefault(k, []).append(win)
            rows.append({"k": k, "classes": K, "nodes": CROSSOVER_NODES,
                         "numpy_ms": times["numpy"], "cuda_ms": times["cuda"],
                         "cuda_wins_2x": win, "equal": equal})
    from_k = {}
    for i, K in enumerate(CROSSOVER_CLASSES):
        from_k[K] = None
        for k in reversed(CROSSOVER_K):
            if not wins[k][i]:
                break
            from_k[K] = k
    return rows, from_k


def assign_bytes(k, K, N, R=4):
    """Bytes assign must move at least: the batch's classes (4 a task),
    demands, avail and cap, the class mask and spread flags read once;
    node_of (4 a task) and avail written once."""
    return 4 * k + 4 * K * R + 2 * 4 * N * R + K * N + K + 4 * k + 4 * N * R


def phase_runtime(torch):
    """The runtime's main path on the card (see RUNTIME_*): ray_tpu_torch.init
    with scheduler="tensor", sched_device "cuda", 8 workers.

    - fan-out: e2e_task_throughput(2.5k), unbatched and through map_remote,
      under sched_backend cuda, numpy and auto; kernels.assign's counter
      zeroed just before each and read just after: equal to the
      scheduler's device assigns, > 0 under cuda and 0 under numpy.
    - oracle: a checking 2.5k fan-out under cuda with every snapshot
      _assign saw kept, each replayed through assign_np: node_of and
      avail equal.
    - map_reduce (config 2, cut to 10k) and actors (config 4, cut) under
      cuda:
      the reduced total, every actor's results in call order.
    - engine: an actor (num_gpus=1) holding InferenceEngine at serve-127M
      generates ENGINE_PROMPTS prompts one after another through
      .remote(); its greedy tokens equal a direct engine.generate on the
      same parameters, and paged_attention's counter advanced. Assign's
      host time, stream span and kernel span (AssignRecorder) from a 2.5k
      fan-out alone, then from one started while the actor decodes: the
      device path runs on the scheduler's own stream.
    - resources: cluster_resources()["GPU"] == torch.cuda.device_count().
    - crossover: phase_crossover's table and the k it gives.
    - stream: stream_check, the device assign beside a busy default
      stream.
    Returns (assign's launches on the cuda fan-out, the kernel table's row
    for kernels.assign)."""
    import ray_tpu_torch as ray
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.perf import e2e_task_throughput
    from ray_tpu_torch._private.scheduler import kernels as sk
    from ray_tpu_torch._private.scheduler.local import NodeState
    from ray_tpu_torch._private.scheduler.tensor import TensorScheduler

    smi = nvidia_smi()
    problems, fanout = [], {}
    main_launches = None
    for backend in RUNTIME_BACKENDS:
        for batched in (False, True):
            sk.assign.launches = 0      # the main path: counted from zero
            r = e2e_task_throughput(
                RUNTIME_FANOUT, num_workers=RUNTIME_WORKERS, batched=batched,
                system_config={"sched_backend": backend,
                               "sched_device": "cuda"})
            launches = sk.assign.launches
            key = f"{backend}{'_batched' if batched else ''}"
            fanout[key] = {**r, "assign_launches": launches}
            emit({"phase": "runtime", "part": "fanout", "backend": backend,
                  "batched": batched, "tasks_per_sec": r["tasks_per_sec"],
                  "seconds": r["seconds"], "budget_us": r["budget_us"],
                  "sched_ticks": r["sched_ticks"],
                  "tasks_per_tick": r["tasks_per_tick"],
                  "assign_launches": launches,
                  "device_assigns": r["device_assigns_total"],
                  "device_assign_errors": r["device_assign_errors"],
                  "nvidia_smi": smi})
            if backend == "cuda" and not batched:
                main_launches = launches
            problems += [f"fanout {key}: {what}" for what, failed in (
                ("assign launches != device assigns",
                 launches != r["device_assigns_total"]),
                ("no device assign", backend == "cuda" and launches == 0),
                ("a device assign under numpy",
                 backend == "numpy" and launches != 0),
                ("device assign errors", r["device_assign_errors"] != 0))
                if failed]

    rec = AssignRecorder(torch, TensorScheduler, sk, GLOBAL_CONFIG)
    try:
        ray.init(num_workers=RUNTIME_WORKERS, scheduler="tensor",
                 _system_config={"sched_backend": "cuda",
                                 "sched_device": "cuda"})
        try:
            gpus = ray.cluster_resources().get("GPU")
            if gpus != torch.cuda.device_count():
                problems.append(f"cluster_resources GPU {gpus}")
            # GPU detection in a fresh process leaves CUDA uninitialised
            fresh = subprocess.run(
                [sys.executable, "-c", "import torch; from ray_tpu_torch."
                 "_private.worker import _detect_gpu_count as d; n = d(); "
                 "print(n, torch.cuda.is_initialized())"],
                capture_output=True, text=True, timeout=120,
                cwd=Path(__file__).resolve().parent).stdout.split()
            emit({"phase": "runtime", "part": "resources", "gpu": gpus,
                  "fresh_process_detect": fresh})
            if fresh != [f"{float(torch.cuda.device_count())}", "False"]:
                problems.append(f"GPU detection in a fresh process: {fresh}")
            runtime_fanout(ray, 200)                     # warm
            rec.snapshots = []
            dt, out = runtime_fanout(ray, RUNTIME_FANOUT)
            snapshots, rec.snapshots = rec.snapshots, None
            bad = replay_oracle(sk, snapshots,
                                GLOBAL_CONFIG.sched_hybrid_threshold)
            ks = [len(s[0][0]) for s in snapshots]
            median_snap = sorted(snapshots, key=lambda s: len(s[0][0]))[
                len(snapshots) // 2][0] if snapshots else None
            emit({"phase": "runtime", "part": "oracle",
                  "snapshots": len(snapshots), "differ": bad,
                  "k_min": min(ks, default=None), "k_median": _median(ks),
                  "k_max": max(ks, default=None), "seconds": dt})
            if not snapshots or bad or out != [None] * RUNTIME_FANOUT:
                problems.append(f"oracle: {bad} of {len(snapshots)} "
                                "snapshots differ from assign_np")

            dt, tasks, total, want = runtime_map_reduce(ray)
            emit({"phase": "runtime", "part": "map_reduce", "tasks": tasks,
                  "seconds": dt, "tasks_per_sec": tasks / dt,
                  "total": total, "want": want,
                  "cut": f"{RUNTIME_TASKS} tasks, not 100k"})
            if total != want:
                problems.append(f"map_reduce total {total} != {want}")

            dt, bad = runtime_actors(ray)
            emit({"phase": "runtime", "part": "actors",
                  "actors": RUNTIME_ACTORS, "calls": RUNTIME_CALLS,
                  "seconds": dt,
                  "calls_per_sec": RUNTIME_ACTORS * RUNTIME_CALLS / dt,
                  "out_of_order_actors": bad,
                  "cut": f"{RUNTIME_CALLS} calls an actor, not 1000"})
            if bad:
                problems.append(f"actors: {bad} out of call order")

            problems += runtime_engine(torch, ray, rec, smi, "cuda")
            stats = ray._worker.get_worker().scheduler.stats()
            if stats["device_assign_errors"]:
                problems.append("device assign errors")
        finally:
            ray.shutdown()
        # the same actor beside a numpy-assigned fan-out: what the host
        # alone costs the decoding actor, without the device path
        ray.init(num_workers=RUNTIME_WORKERS, scheduler="tensor",
                 _system_config={"sched_backend": "numpy"})
        try:
            problems += runtime_engine(torch, ray, rec, smi, "numpy")
        finally:
            ray.shutdown()
    finally:
        rec.remove()

    sched = TensorScheduler([NodeState((8.0, 1.0, 1e18, 0.0))],
                            lambda task: None)
    try:
        rows, from_k = phase_crossover(torch, sched, GLOBAL_CONFIG)
        for row in rows:
            emit({"phase": "runtime", "part": "crossover", **row,
                  "nvidia_smi": smi})
        ks = [k for k in from_k.values() if k is not None]
        emit({"phase": "runtime", "part": "crossover_verdict",
              "cuda_wins_2x_from_k": {str(K): k for K, k in from_k.items()},
              "crossover_k": min(ks, default=None),
              "sched_device_min_batch": GLOBAL_CONFIG.sched_device_min_batch,
              "nvidia_smi": smi})
        problems += [f"crossover k={r['k']} K={r['classes']}: cuda "
                     "disagrees with numpy" for r in rows if not r["equal"]]
        snap = median_snap or crossover_snapshot(4096, 1)
        stream = stream_check(torch, sched, snap,
                              GLOBAL_CONFIG.sched_hybrid_threshold)
        emit({"phase": "runtime", "part": "stream", **stream,
              "nvidia_smi": smi})
        if not stream["independent"]:
            problems.append(f"the device assign waited on the default "
                            f"stream: {stream}")
        row = assign_row(torch, sk, median_snap, main_launches,
                         GLOBAL_CONFIG.sched_hybrid_threshold)
    finally:
        sched.shutdown()
        GLOBAL_CONFIG.reset()
    emit({"phase": "runtime", "part": "assign_kernel", **row,
          "ok": not problems, "nvidia_smi": smi})
    if problems:
        raise AssertionError(f"runtime phase: {problems}")
    return row


def engine_setup(torch):
    """serve-127M in bf16 with seeded parameters on the card, the engine's
    configuration and ENGINE_PROMPTS prompts: (mcfg, params, icfg,
    prompts)."""
    from ray_tpu_torch.models.inference import InferenceConfig
    from ray_tpu_torch.models.transformer import (TransformerConfig,
                                                  init_params)

    mcfg = TransformerConfig(dtype=torch.bfloat16, **SERVE)
    params = init_params(mcfg, torch.Generator(device="cuda").manual_seed(0))
    icfg = InferenceConfig(batch_size=SLOTS, page_size=PAGE,
                           max_pages_per_seq=MAX_PAGES, num_pages=NUM_PAGES,
                           prefill_buckets=(16,),
                           max_new_tokens=ENGINE_NEW_TOKENS)
    prompts = [[i + 1, 2 * i + 3, 7] for i in range(ENGINE_PROMPTS)]
    return mcfg, params, icfg, prompts


def engine_actor(ray):
    """The engine actor class (num_gpus=1) over an InferenceEngine."""
    from ray_tpu_torch.models.inference import InferenceEngine

    @ray.remote(num_gpus=1)
    class _Engine:
        def __init__(self, params, mcfg, icfg):
            self.engine = InferenceEngine(params, mcfg, icfg)

        def generate(self, prompts, n):
            # one after another: each prompt alone in the batch, as a
            # direct engine runs them; with the clock at the end (this
            # process's: the caller may read the result only after its
            # own fan-out)
            out = [self.engine.generate(p, n) for p in prompts]
            return out, time.perf_counter()

        def stop(self):
            self.engine.shutdown()

    return _Engine


def runtime_engine(torch, ray, rec, smi, backend):
    """The model through the runtime (initialised with sched_backend
    ``backend``): an engine actor at serve-127M, its tokens against a
    direct engine on the same parameters, the actor's time alone and
    beside a 2.5k fan-out, and (cuda) assign's times alone and beside the
    decoding actor. Returns the problems."""
    from ray_tpu_torch.models.inference import InferenceEngine
    from ray_tpu_torch.ops import paged_attention as pa

    mcfg, params, icfg, prompts = engine_setup(torch)
    problems = []
    actor = engine_actor(ray).remote(params, mcfg, icfg)
    try:
        ray.get(actor.generate.remote(prompts[:1], 4), timeout=600)  # warm
        t0 = time.perf_counter()
        ray.get(actor.generate.remote(prompts, ENGINE_NEW_TOKENS),
                timeout=600)
        actor_alone_s = time.perf_counter() - t0
        alone0 = time.perf_counter()
        runtime_fanout(ray, RUNTIME_FANOUT)
        fanout_alone_s = time.perf_counter() - alone0
        alone = assign_timing(rec.calls, alone0)
        launches0 = pa.paged_attention.launches
        t0 = time.perf_counter()
        ref = actor.generate.remote(prompts, ENGINE_NEW_TOKENS)
        dt_fan, _out = runtime_fanout(ray, RUNTIME_FANOUT)
        t_fan = time.perf_counter()
        got, t_end = ray.get(ref, timeout=600)
        t1 = time.perf_counter()
        beside = assign_timing(rec.calls, t0, min(t_fan, t_end))
        actor_launches = pa.paged_attention.launches - launches0
        ray.get(actor.stop.remote(), timeout=120)
    finally:
        ray.kill(actor)
    engine = InferenceEngine(params, mcfg, icfg)
    try:
        want = [engine.generate(p, ENGINE_NEW_TOKENS) for p in prompts]
    finally:
        engine.shutdown()
    emit({"phase": "runtime", "part": "engine", "backend": backend,
          "prompts": ENGINE_PROMPTS,
          "new_tokens": ENGINE_NEW_TOKENS,
          # to the actor's own end, and to the caller's get, which comes
          # only after the caller's fan-out
          "actor_seconds": t_end - t0, "actor_seconds_to_result": t1 - t0,
          "actor_seconds_alone": actor_alone_s,
          "fanout_seconds_alone": fanout_alone_s,
          "fanout_seconds_beside_actor": dt_fan,
          "fanout_ended_before_actor": t_fan < t_end,
          "tokens_equal_direct": got == want,
          "paged_attention_launches": actor_launches,
          "assign_alone": alone, "assign_beside_actor": beside,
          "nvidia_smi": smi})
    if got != want:
        problems.append("engine actor tokens != direct engine tokens")
    if actor_launches <= 0:
        problems.append("the engine actor launched no paged attention")
    if backend == "cuda" and not beside["assigns"]:
        problems.append("no device assign while the actor decoded")
    return problems


def runtime_fanout_batched(ray, n):
    """n no-op tasks through map_remote, then get: (seconds, results)."""
    @ray.remote
    def _noop():
        return None

    t0 = time.perf_counter()
    out = ray.get(_noop.map_remote([() for _ in range(n)]), timeout=600)
    return time.perf_counter() - t0, out


def compute_apps(text):
    """nvidia-smi --query-compute-apps=pid,used_memory --format=csv,
    noheader as [(pid, MiB)], one row a process holding a CUDA context."""
    rows = []
    for line in text.strip().splitlines():
        pid, mem = (f.strip() for f in line.split(","))
        rows.append((int(pid), int(mem.split()[0])))
    return rows


def smi_query(*args):
    return subprocess.run(["nvidia-smi", *args, "--format=csv,noheader"],
                          capture_output=True, text=True,
                          timeout=60).stdout


def card_state():
    """(compute-app rows, the card's memory.used in MiB)."""
    used = smi_query("--query-gpu=memory.used").strip().split()[0]
    return (compute_apps(smi_query("--query-compute-apps=pid,used_memory")),
            int(used))


def shows_process(rows_before, rows_with, pid):
    """Whether nvidia-smi shows the process pid started: its pid among
    the rows, or, where nvidia-smi reports every process under one pid
    of another pid namespace, one row more than before it started, all
    rows under that one pid. Returns (shown, by) with by "pid" or
    "row"."""
    pids = {p for p, _ in rows_with}
    if pid in pids:
        return True, "pid"
    if len(rows_with) == len(rows_before) + 1 and len(pids) == 1:
        return True, "row"
    return False, None


def released_rule(rows_before, used_before, rows_after, used_after,
                  alive, slack_mib=PROCESS_MEM_SLACK_MIB):
    """After ray.kill and shutdown: the actor's process is gone, nvidia-smi
    lists no more processes than before it started, and the card's
    memory.used is back within slack_mib of its level then. Returns
    the problem, or None."""
    if (not alive and len(rows_after) <= len(rows_before)
            and used_after <= used_before + slack_mib):
        return None
    return (f"engine actor not released: alive {alive}, compute apps "
            f"{rows_before} -> {rows_after}, memory.used {used_before} -> "
            f"{used_after} MiB")


def pid_alive(pid):
    """True while pid runs (a zombie counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def arena_holds(ptr, nbytes, base, size):
    """Whether [ptr, ptr + nbytes) lies inside the arena's mapping."""
    return base <= ptr and ptr + nbytes <= base + size


def wait_workers_ready(pool, timeout=300.0):
    """Seconds until every worker of pool has dialed back (its ready)."""
    t0 = time.perf_counter()
    while not all(h.ready for h in pool._handles):
        if time.perf_counter() - t0 > timeout:
            raise AssertionError("process workers never all came up")
        time.sleep(0.01)
    return time.perf_counter() - t0


def worker_modules(ray, n_workers):
    """One sleeping task a worker: {pid: (modules of REF_MODULES loaded,
    CUDA_VISIBLE_DEVICES)} over the workers that ran one."""
    @ray.remote
    def _modules():
        import os
        import sys
        import time as _time

        _time.sleep(0.3)              # hold this worker: one task each
        return (os.getpid(),
                sorted(m for m in sys.modules
                       if m.split(".")[0] in REF_MODULES),
                os.environ.get("CUDA_VISIBLE_DEVICES"))

    got = ray.get([_modules.remote() for _ in range(n_workers)],
                  timeout=300)
    return {pid: (mods, cvd) for pid, mods, cvd in got}


def process_arena(torch, ray, w):
    """The arena through the public API: a 64 MiB CPU tensor put, reduced
    by a worker, read back by the driver as a view inside the arena's
    mapping that holds the arena pin while it lives; a CUDA tensor put
    comes back as an equal CPU tensor. Returns (row, problems)."""
    import ctypes
    import gc

    @ray.remote
    def _total(t):
        return int(t.sum())

    n = ARENA_TENSOR_BYTES // 8
    t = torch.arange(n, dtype=torch.int64)
    want = n * (n - 1) // 2
    t0 = time.perf_counter()
    ref = ray.put(t)
    put_s = time.perf_counter() - t0
    worker_total = ray.get(_total.remote(ref), timeout=300)
    t0 = time.perf_counter()
    v = ray.get(ref, timeout=300)
    get_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    driver_total = int(v.sum())
    read_s = time.perf_counter() - t0
    arena = w.shm_store.arena
    base = ctypes.addressof(ctypes.c_char.from_buffer(arena._shm.buf))
    inside = arena_holds(v.data_ptr(), v.numel() * v.element_size(),
                         base, arena.size)
    oid = ref.object_id()
    pinned = w.shm_store._pins.get(oid, 0)
    # the driver's memory store memoizes the view too: once the ref and
    # the view die, the pin drops and the arena range frees
    del v, ref
    deadline = time.monotonic() + 30
    while True:
        w._drain_out_of_scope()     # as the API entry points do
        gc.collect()
        unpinned = (w.shm_store._pins.get(oid, 0) == 0
                    and not w.shm_store.contains(oid))
        if unpinned or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    g = torch.Generator(device="cuda").manual_seed(0)
    c = torch.randn(CUDA_PUT_BYTES // 4, device="cuda", generator=g)
    back = ray.get(ray.put(c), timeout=300)
    cuda_ok = back.device.type == "cpu" and torch.equal(back, c.cpu())
    row = {"bytes": ARENA_TENSOR_BYTES, "put_s": put_s,
           "put_bytes_per_s": ARENA_TENSOR_BYTES / put_s,
           "get_s": get_s, "read_s": read_s,
           "read_bytes_per_s": ARENA_TENSOR_BYTES / (get_s + read_s),
           "worker_total_equal": worker_total == want,
           "driver_total_equal": driver_total == want,
           "view_inside_arena": inside, "pins_while_view": pinned,
           "unpinned_and_freed_after": unpinned,
           "cuda_put_returns_equal_cpu_tensor": cuda_ok}
    problems = [f"arena: {k}" for k in (
        "worker_total_equal", "driver_total_equal", "view_inside_arena",
        "unpinned_and_freed_after", "cuda_put_returns_equal_cpu_tensor")
        if not row[k]]
    if not pinned:
        problems.append("arena: the view held no pin")
    return row, problems


def process_spill(torch, ray):
    """SPILL_OBJECTS tensors of SPILL_OBJECT_BYTES through an arena of
    SPILL_ARENA_BYTES (init'ed by the caller): some spill to disk, each
    restores with exact values, in the driver and as a worker's task
    argument. Returns (row, problems)."""
    @ray.remote
    def _total(t):
        return int(t.sum())

    w = ray._worker.get_worker()
    n = SPILL_OBJECT_BYTES // 8
    ts = [torch.arange(n, dtype=torch.int64) + i for i in
          range(SPILL_OBJECTS)]
    refs = [ray.put(t) for t in ts]
    spilled = w.shm_store.num_spilled_objects()
    worker_ok = ray.get([_total.remote(r) for r in refs], timeout=300) == [
        int(t.sum()) for t in ts]
    driver_ok = all(torch.equal(ray.get(r, timeout=300), t)
                    for r, t in zip(refs, ts))
    row = {"arena_bytes": SPILL_ARENA_BYTES,
           "objects": SPILL_OBJECTS, "object_bytes": SPILL_OBJECT_BYTES,
           "spilled": spilled, "restored": w.shm_store.num_restored,
           "worker_values_equal": worker_ok,
           "driver_values_equal": driver_ok}
    problems = [f"spill: {k}" for k in ("worker_values_equal",
                                        "driver_values_equal")
                if not row[k]]
    if spilled < 1:
        problems.append("spill: nothing spilled")
    return row, problems


def process_engine(torch, ray, rec, smi):
    """runtime_engine in process mode (init'ed by the caller with
    worker_gpu_access): the engine actor (num_gpus=1) in its own process
    builds serve-127M bf16 from the seeded generator there, generates
    ENGINE_PROMPTS prompts one after another, and returns its own kernel-1
    launches and decode steps. Its tokens against a direct engine in the
    driver on the same seeded parameters; its time alone and beside a
    process-mode 5k fan-out; nvidia-smi showing its process, and after
    ray.kill and shutdown the process gone and the card's memory back.
    Returns (row, problems, kernel-1 launches); shuts the runtime down."""
    import gc

    from ray_tpu_torch.models.inference import (InferenceConfig,
                                                InferenceEngine)
    from ray_tpu_torch.models.transformer import (TransformerConfig,
                                                  init_params)

    mcfg = TransformerConfig(dtype=torch.bfloat16, **SERVE)
    icfg = InferenceConfig(batch_size=SLOTS, page_size=PAGE,
                           max_pages_per_seq=MAX_PAGES, num_pages=NUM_PAGES,
                           prefill_buckets=(16,),
                           max_new_tokens=ENGINE_NEW_TOKENS)
    prompts = [[i + 1, 2 * i + 3, 7] for i in range(ENGINE_PROMPTS)]
    params = init_params(mcfg, torch.Generator(device="cuda").manual_seed(0))
    engine = InferenceEngine(params, mcfg, icfg)
    try:
        want = [engine.generate(p, ENGINE_NEW_TOKENS) for p in prompts]
    finally:
        engine.shutdown()
    del engine, params
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rows0, used0 = card_state()

    @ray.remote(num_gpus=1)
    class _ProcessEngine:
        def __init__(self, serve, icfg):
            import torch as _torch

            from ray_tpu_torch.models.inference import InferenceEngine as IE
            from ray_tpu_torch.models.transformer import (
                TransformerConfig as TC, init_params as ip)

            cfg = TC(dtype=_torch.bfloat16, **serve)
            self.n_layers = cfg.n_layers
            self.engine = IE(ip(cfg, _torch.Generator(
                device="cuda").manual_seed(0)), cfg, icfg)

        def generate(self, prompts, n):
            # one after another, each prompt alone in the batch; kernel
            # 1's launches, the decode steps, this process's CPU seconds
            # and the wall clock at the call's start and end, taken in
            # this process (the driver's counter never sees them)
            import time as _time

            from ray_tpu_torch.ops import paged_attention as pa

            l0, s0 = pa.paged_attention.launches, self.engine.decode_steps
            c0, w0 = _time.process_time(), _time.time()
            out = [self.engine.generate(p, n) for p in prompts]
            return {"tokens": out,
                    "launches": pa.paged_attention.launches - l0,
                    "decode_steps": self.engine.decode_steps - s0,
                    "cpu_s": _time.process_time() - c0,
                    "wall": (w0, _time.time())}

        def pid(self):
            import os

            return os.getpid()

        def stop(self):
            self.engine.shutdown()

    problems = []
    t_create = time.perf_counter()
    actor = _ProcessEngine.remote(SERVE, icfg)
    try:
        pid = ray.get(actor.pid.remote(), timeout=600)
        ray.get(actor.generate.remote(prompts[:1], 4), timeout=600)  # warm
        warm_s = time.perf_counter() - t_create
        rows1, used1 = card_state()
        w_alone = time.time()
        alone_run = ray.get(
            actor.generate.remote(prompts, ENGINE_NEW_TOKENS), timeout=600)
        actor_alone_s = alone_run["wall"][1] - w_alone
        got, launches, steps = (alone_run["tokens"], alone_run["launches"],
                                alone_run["decode_steps"])
        alone0 = time.perf_counter()
        runtime_fanout(ray, RUNTIME_FANOUT)
        fanout_alone_s = time.perf_counter() - alone0
        alone = assign_timing(rec.calls, alone0)
        t0, w_call = time.perf_counter(), time.time()
        ref = actor.generate.remote(prompts, ENGINE_NEW_TOKENS)
        dt_fan, _out = runtime_fanout(ray, RUNTIME_FANOUT)
        w_fan = time.time()
        beside_run = ray.get(ref, timeout=600)
        w_got = time.time()
        got_beside = beside_run["tokens"]
        actor_beside_s = beside_run["wall"][1] - w_call
        beside = assign_timing(rec.calls, t0,
                               t0 + min(actor_beside_s, w_fan - w_call))
        ray.get(actor.stop.remote(), timeout=120)
    finally:
        ray.kill(actor)
        ray.shutdown()
    deadline = time.monotonic() + 60
    while True:
        torch.cuda.empty_cache()
        rows2, used2 = card_state()
        alive = pid_alive(pid)
        problem = released_rule(rows0, used0, rows2, used2, alive)
        if problem is None or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    shown, shown_by = shows_process(rows0, rows1, pid)
    row = {"pid": pid, "prompts": ENGINE_PROMPTS,
           "new_tokens": ENGINE_NEW_TOKENS,
           "create_and_warm_seconds": warm_s,
           # from the call to the actor's own end, on the wall clock the
           # two processes share; the caller reads the result only after
           # its own fan-out (actor_seconds_to_result)
           "actor_seconds_alone": actor_alone_s,
           "actor_seconds_beside_fanout": actor_beside_s,
           "slowdown_beside_fanout": actor_beside_s / actor_alone_s,
           "actor_seconds_to_result": w_got - w_call,
           "actor_cpu_seconds_alone": alone_run["cpu_s"],
           "actor_cpu_seconds_beside_fanout": beside_run["cpu_s"],
           # where the time beside the fan-out went, on the wall clock the
           # two processes share: the call reaching the actor, its run
           # there, its result reaching the caller
           "beside_call_to_actor_start_s": beside_run["wall"][0] - w_call,
           "beside_actor_run_s": beside_run["wall"][1]
           - beside_run["wall"][0],
           "beside_actor_end_to_result_s": w_got - beside_run["wall"][1],
           "beside_fanout_end_to_result_s": w_got - w_fan,
           "fanout_seconds_alone": fanout_alone_s,
           "fanout_seconds_beside_actor": dt_fan,
           "fanout_ended_before_actor": w_fan < beside_run["wall"][1],
           "tokens_equal_direct": got == want and got_beside == want,
           "paged_attention_launches": launches, "decode_steps": steps,
           "compute_apps_before": rows0, "compute_apps_with_actor": rows1,
           "compute_apps_after": rows2,
           "memory_used_mib": [used0, used1, used2],
           "nvidia_smi_shows_actor": shown, "shown_by": shown_by,
           "process_alive_after": alive,
           "assign_alone": alone, "assign_beside_actor": beside,
           "nvidia_smi": smi}
    if got != want or got_beside != want:
        problems.append("process engine actor tokens != direct engine")
    problem = launch_rule(launches, mcfg.n_layers, steps)
    if problem:
        problems.append(f"process engine actor: {problem}")
    if not shown:
        problems.append(f"nvidia-smi does not show the actor: {rows0} -> "
                        f"{rows1}")
    if problem := released_rule(rows0, used0, rows2, used2, alive):
        problems.append(problem)
    if not beside["assigns"]:
        problems.append("no device assign while the actor decoded")
    return row, problems, launches


def phase_process(torch):
    """Process mode on the card (see PROCESS_*): ray_tpu_torch.init with
    worker_mode "process", 8 workers, scheduler "tensor", sched_backend
    "cuda": the TensorScheduler assigns each batch through
    scheduler_tick.cu on its own stream and leases it to exec'd workers.

    - startup: seconds until all 8 workers dialed back.
    - workers: each worker loads no jax, flax or ray_tpu module and sees
      no card (CUDA_VISIBLE_DEVICES ""); the head advertises no GPU.
    - fanout (5k, unbatched and through map_remote), map_reduce (5k),
      actors (16 processes x 100 calls): tasks/s; kernels.assign's
      counter zeroed just before each and read just after, equal to the
      scheduler's device assigns; every recorded snapshot equal to
      assign_np.
    - arena: process_arena; spill: process_spill in a 64 MiB arena.
    - engine: process_engine under worker_gpu_access.
    Returns (kernel 1's launches in the engine actor, assign's launches
    on the unbatched fan-out)."""
    import ray_tpu_torch as ray
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.scheduler import kernels as sk
    from ray_tpu_torch._private.scheduler.tensor import TensorScheduler

    smi = nvidia_smi()
    t_phase = time.perf_counter()
    cfg = {"worker_mode": "process", "sched_backend": "cuda",
           "sched_device": "cuda"}
    problems, snapshots, launches_fanout = [], [], None
    rec = AssignRecorder(torch, TensorScheduler, sk, GLOBAL_CONFIG)
    try:
        t0 = time.perf_counter()
        ray.init(num_workers=RUNTIME_WORKERS, scheduler="tensor",
                 _system_config=cfg)
        w = ray._worker.get_worker()
        try:
            init_s = time.perf_counter() - t0
            ready_s = wait_workers_ready(w.process_pool)
            emit({"phase": "process", "part": "startup",
                  "workers": RUNTIME_WORKERS, "init_seconds": init_s,
                  "all_ready_seconds": init_s + ready_s,
                  "nvidia_smi": smi})
            mods = worker_modules(ray, RUNTIME_WORKERS)
            gpus = ray.cluster_resources().get("GPU", 0.0)
            emit({"phase": "process", "part": "workers",
                  "pids": sorted(mods), "modules": {
                      str(p): m for p, (m, _c) in mods.items()},
                  "cuda_visible_devices": sorted(
                      {str(c) for _m, c in mods.values()}),
                  "head_gpu": gpus})
            if any(m for m, _c in mods.values()):
                problems.append(f"a worker loaded {REF_MODULES}: {mods}")
            if any(c != "" for _m, c in mods.values()):
                problems.append("a worker sees the card without "
                                "worker_gpu_access")
            if gpus:
                problems.append(f"head advertises {gpus} GPU without "
                                "worker_gpu_access")
            runtime_fanout(ray, 200)                     # warm
            parts = (
                ("fanout", lambda: runtime_fanout(ray, RUNTIME_FANOUT)),
                ("fanout_batched",
                 lambda: runtime_fanout_batched(ray, RUNTIME_FANOUT)),
                ("map_reduce",
                 lambda: runtime_map_reduce(ray, PROCESS_TASKS)),
                ("actors", lambda: runtime_actors(ray, PROCESS_ACTORS,
                                                  PROCESS_CALLS)))
            for part, run in parts:
                rec.snapshots = []
                a0 = w.scheduler.stats()["device_assigns"]
                sk.assign.launches = 0      # the main path, from zero
                out = run()
                launches = sk.assign.launches
                assigns = w.scheduler.stats()["device_assigns"] - a0
                snaps, rec.snapshots = rec.snapshots, None
                snapshots += snaps
                row = {"phase": "process", "part": part,
                       "seconds": out[0], "assign_launches": launches,
                       "device_assigns": assigns,
                       "snapshots": len(snaps), "nvidia_smi": smi}
                if part.startswith("fanout"):
                    row["tasks_per_sec"] = RUNTIME_FANOUT / out[0]
                    ok = out[1] == [None] * RUNTIME_FANOUT
                elif part == "map_reduce":
                    row.update(tasks=out[1], tasks_per_sec=out[1] / out[0],
                               total=out[2], want=out[3],
                               cut=f"{PROCESS_TASKS} tasks, not 100k")
                    ok = out[2] == out[3]
                else:
                    n = PROCESS_ACTORS * PROCESS_CALLS
                    row.update(actors=PROCESS_ACTORS, calls=PROCESS_CALLS,
                               calls_per_sec=n / out[0],
                               out_of_order_actors=out[1],
                               cut=f"{PROCESS_ACTORS} actor processes x "
                                   f"{PROCESS_CALLS} calls, not 1k actors")
                    ok = out[1] == 0
                emit(row)
                if part == "fanout":
                    launches_fanout = launches
                problems += [f"{part}: {what}" for what, failed in (
                    ("wrong results", not ok),
                    ("assign launches != device assigns",
                     launches != assigns),
                    ("no device assign", part != "actors"
                     and launches == 0)) if failed]
            bad = replay_oracle(sk, snapshots,
                                GLOBAL_CONFIG.sched_hybrid_threshold)
            ks = [len(s[0][0]) for s in snapshots]
            emit({"phase": "process", "part": "oracle",
                  "snapshots": len(snapshots), "differ": bad,
                  "k_min": min(ks, default=None), "k_median": _median(ks),
                  "k_max": max(ks, default=None)})
            if not snapshots or bad:
                problems.append(f"oracle: {bad} of {len(snapshots)} "
                                "snapshots differ from assign_np")
            row, found = process_arena(torch, ray, w)
            emit({"phase": "process", "part": "arena", **row,
                  "nvidia_smi": smi})
            problems += found
            if w.scheduler.stats()["device_assign_errors"]:
                problems.append("device assign errors")
        finally:
            ray.shutdown()

        ray.init(num_workers=2, scheduler="tensor", _system_config={
            **cfg, "object_store_memory": SPILL_ARENA_BYTES})
        try:
            row, found = process_spill(torch, ray)
            emit({"phase": "process", "part": "spill", **row})
            problems += found
        finally:
            ray.shutdown()

        ray.init(num_workers=RUNTIME_WORKERS, scheduler="tensor",
                 _system_config={**cfg, "worker_gpu_access": True})
        gpus = ray.cluster_resources().get("GPU")
        if gpus != torch.cuda.device_count():
            problems.append(f"with worker_gpu_access the head advertises "
                            f"{gpus} GPU")
        row, found, engine_launches = process_engine(torch, ray, rec, smi)
        emit({"phase": "process", "part": "engine", **row,
              "head_gpu": gpus})
        problems += found
    finally:
        rec.remove()
        ray.shutdown()
        GLOBAL_CONFIG.reset()
    emit({"phase": "process", "part": "done",
          "seconds": time.perf_counter() - t_phase, "ok": not problems,
          "nvidia_smi": smi})
    if problems:
        raise AssertionError(f"process phase: {problems}")
    return engine_launches, launches_fanout


def stream_check(torch, sched, snap, threshold, spin_ms=300.0):
    """The device path's own stream against the default stream: with a
    spin kernel of ~spin_ms queued on the default stream (as a model's
    work would be), one TensorScheduler._device_assign must return while
    the spin still runs, in a small part of its time."""
    args = (snap[1], snap[2], snap[3], snap[4], threshold, snap[5],
            snap[6])
    sched._device_assign(*args)       # warm; makes the scheduler's stream
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    end.synchronize()
    cycles = int(1_000_000 * spin_ms / start.elapsed_time(end))
    spun = torch.cuda.Event()
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)         # the default stream, busy
    spun.record()
    t1 = time.perf_counter()
    sched._device_assign(*args)
    t2 = time.perf_counter()
    spin_running = not spun.query()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    assign_ms = (t2 - t1) * 1e3
    return {"k": len(snap[1]), "spin_ms": (t3 - t0) * 1e3,
            "assign_ms_beside_spin": assign_ms,
            "spin_running_after_assign": spin_running,
            "independent": spin_running and assign_ms < spin_ms / 10}


def assign_row(torch, sk, snap, launches, threshold):
    """kernels.assign's row of the kernel table, at the runtime fan-out's
    median snapshot (a crossover snapshot if none was recorded): ms is the
    span of the tick kernels' one launch (kernels._run, CUDA events,
    median of 20 calls; the uploads and the fetch around it are in
    host_ms, the call's wall time), profiled_busy_ms the device's busy
    time a call over PROFILED_ASSIGNS more calls under torch.profiler (the
    profiler can miss a short session's kernels entirely: up to three
    sessions, and "not measured" when none recorded any),
    plain_ms scan_classes_reference on the same inputs on the card (what
    kernels.assign runs for CPU tensors), the bound bytes over 3.35 TB/s."""
    import numpy as np

    if snap is None:
        snap = crossover_snapshot(4096, 1)
    ready_idx, ready_cls, demands, avail, cap, mask, spread = snap[:7]
    uniq, inv = np.unique(ready_cls, return_inverse=True)
    args = (inv.astype(np.int32), demands[uniq], avail, cap, threshold,
            mask[uniq], spread[uniq])
    got = sk.assign(*args, device="cuda")
    k, K, N = len(inv), len(uniq), len(avail)
    t = [torch.as_tensor(np.asarray(x), device="cuda") for x in
         (args[0], args[1], args[2], args[3], args[5], args[6])]
    ready = torch.ones(k, dtype=torch.bool, device="cuda")
    thr = torch.tensor(threshold, dtype=torch.float32, device="cuda")

    def plain():
        return sk.scan_classes_reference(ready, t[0], t[1], t[2], t[3], thr,
                                         N, k, t[4], t[5])

    want = plain()
    host, spans, run = [], [], sk._run

    def timed_run(*a, **kw):       # the tick kernels' span, by events
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        run(*a, **kw)
        events[1].record()
        spans.append(events)

    sk._run = timed_run
    try:
        for _ in range(20):
            t0 = time.perf_counter()
            sk.assign(*args, device="cuda")
            host.append(time.perf_counter() - t0)
    finally:
        sk._run = run
    prof = None
    for _ in range(3):
        prof = profile_call(torch, lambda: [
            sk.assign(*args, device="cuda")
            for _ in range(PROFILED_ASSIGNS)], allow_empty=True)
        if prof is not None:
            break
    equal = (np.array_equal(got[0], want[0].cpu().numpy())
             and np.array_equal(got[1], want[2].cpu().numpy()))
    if not equal:
        raise AssertionError("assign differs from its plain version")
    return {"k": k, "classes": K, "nodes": N, "equal_plain": equal,
            "max_abs_err": float(np.abs(got[1] - want[2].cpu().numpy()).max()),
            "ms": _median([a.elapsed_time(b) for a, b in spans]),
            "host_ms": _median(host) * 1e3,
            "profiled_busy_ms": (prof["device_busy_us"] / 1e3
                                 / PROFILED_ASSIGNS if prof else None),
            "plain_ms": cuda_ms(torch, lambda i: plain(), 5),
            "launches": launches,
            **bound_row(assign_bytes(k, K, N)),
            "profile": prof or "not measured: the profiler recorded no "
                               "device activity"}


def quantiles(xs):
    """p50, p95 and max of xs, nearest rank (the rule by which Serve's
    TTFT window reads its quantiles: sorted[min(n - 1, int(q * n))])."""
    xs = sorted(xs)
    if not xs:
        raise AssertionError("no samples")
    n = len(xs)
    return {"p50": xs[min(n - 1, int(0.5 * n))],
            "p95": xs[min(n - 1, int(0.95 * n))], "max": xs[-1]}


def stream_record(frames, t0, clock=time.perf_counter):
    """Drain one stream's frames, opened at t0: (tokens, TTFT seconds to
    the first frame with tokens, latency seconds to the done frame)."""
    tokens, ttft = [], None
    for frame in frames:
        if frame.get("tokens") and ttft is None:
            ttft = clock() - t0
        tokens.extend(frame.get("tokens") or ())
        if frame.get("done"):
            if ttft is None:
                raise AssertionError("a stream ended without a token")
            return tokens, ttft, clock() - t0
    raise AssertionError("a stream ended without its done frame")


def serve_round(open_stream, prompts, timeout=600.0):
    """One client thread per prompt, released together: each opens its
    stream (open_stream(i, prompt) -> frames) and drains it with
    stream_record. Returns ([(tokens, ttft_s, latency_s)], wall seconds
    from the release to the last done frame); raises if any client failed
    or hung."""
    import threading

    n = len(prompts)
    results, errors = [None] * n, []
    go = threading.Event()

    def client(i):
        go.wait()
        try:
            t0 = time.perf_counter()
            results[i] = stream_record(open_stream(i, prompts[i]), t0)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(f"stream {i}: {e!r}")

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    go.set()
    for t in threads:
        t.join(timeout=max(0.0, t0 + timeout - time.perf_counter()))
    dt = time.perf_counter() - t0
    hung = sum(t.is_alive() for t in threads)
    if errors or hung:
        raise AssertionError(f"serve round: {hung} hung, {errors[:4]}")
    return results, dt


def round_summary(results, dt, n_new, vocab):
    """A round's end-to-end figures: TTFT and latency quantiles (s),
    tokens/s; raises on a stream of the wrong length or out of vocab."""
    bad = [i for i, (toks, _, _) in enumerate(results)
           if len(toks) != n_new or not all(0 <= t < vocab for t in toks)]
    if bad:
        raise AssertionError(f"{len(bad)} malformed streams: {bad[:8]}")
    tokens = sum(len(r[0]) for r in results)
    return {"requests": len(results), "tokens": tokens, "seconds": dt,
            "tokens_per_s": tokens / dt,
            "ttft_s": quantiles([r[1] for r in results]),
            "latency_s": quantiles([r[2] for r in results])}


def launch_rule(launches, n_layers, decode_steps):
    """Kernel 1 on the Serve path: a round's paged_attention launches must
    be n_layers x the decode steps summed over the decode engines, and
    > 0. Returns the problem, or None."""
    if launches > 0 and launches == n_layers * decode_steps:
        return None
    return (f"paged_attention launches {launches} != {n_layers} layers x "
            f"{decode_steps} decode steps")


def engine_params(torch, mcfg, seed):
    """init_params (seeded, f32) cast once to the engine's compute dtypes
    (norm scales f32, the rest mcfg.dtype), so that every engine's own
    cast is a no-op and the replicas share these tensors."""
    from ray_tpu_torch.models.transformer import init_params

    params = init_params(mcfg,
                         torch.Generator(device="cuda").manual_seed(seed))
    return {k: v if k.endswith("/scale") else v.to(mcfg.dtype)
            for k, v in params.items()}


def serve_released(torch, base, timeout=30.0):
    """After serve.shutdown(): wait until no engine loop thread is alive
    and the card's allocated bytes are back within SERVE_MEM_SLACK of base
    (a retired replica's threads exit, then its engine is collected), and
    no InferenceEngine object is left. cuBLAS keeps a 32 MiB workspace for
    each thread's handle, which a replica's actor threads leave behind:
    those are freed first and counted apart. Returns (readings, problem
    or None)."""
    import gc
    import threading

    from ray_tpu_torch.models.inference import InferenceEngine

    deadline = time.monotonic() + timeout
    while True:
        gc.collect()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        torch._C._cuda_clearCublasWorkspaces()
        above = torch.cuda.memory_allocated() - base
        threads = sum(t.name == ENGINE_THREAD for t in threading.enumerate())
        engines = sum(isinstance(o, InferenceEngine)
                      for o in gc.get_objects())
        if (not threads and not engines and above <= SERVE_MEM_SLACK
                or time.monotonic() > deadline):
            break
        time.sleep(0.1)
    readings = {"engine_threads": threads, "engines": engines,
                "bytes_above_base": above,
                "cublas_workspace_bytes": held - above}
    ok = not threads and not engines and above <= SERVE_MEM_SLACK
    return readings, None if ok else f"after serve.shutdown: {readings}"


def serve_http(port, n_new):
    """One JSON request (POST /llm) and one SSE request (POST /llm/stream)
    over loopback. The JSON route calls the deployment's __call__, which
    LLMDeployment does not define: the reference's ingress answers 500
    with that error. Returns the readings."""
    import http.client

    def post(path, body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        return conn, conn.getresponse()

    conn, resp = post("/llm", {"prompt": [1, 2, 3, 4]})
    reply = json.loads(resp.read())
    # the error's last line (the replica's traceback is above it)
    json_reply = (resp.status, {k: str(v).strip().splitlines()[-1]
                                for k, v in reply.items()})
    conn.close()
    conn, resp = post("/llm/stream", {"prompt": [1, 2, 3, 4],
                                      "max_new_tokens": n_new})
    sse = {"status": resp.status, "type": resp.getheader("Content-Type")}
    events = [json.loads(raw[len("data: "):]) for raw in
              resp.read().decode().split("\n\n") if raw]
    conn.close()
    sse.update(events=len(events),
               tokens=sum(len(e.get("tokens") or ()) for e in events),
               done=bool(events) and events[-1].get("done") is True,
               errors=[e["error"] for e in events if "error" in e])
    problems = []
    if json_reply[0] != 500 or "not callable" not in json_reply[1].get(
            "error", ""):
        problems.append(f"JSON route: {json_reply}")
    if (sse["status"] != 200 or sse["type"] != "text/event-stream"
            or sse["tokens"] != n_new or not sse["done"] or sse["errors"]):
        problems.append(f"SSE route: {sse}")
    return {"json_status": json_reply[0], "json_reply": json_reply[1],
            "sse": sse}, problems


def phase_serve(torch):
    """Serve on the card (see SERVE_*): ray_tpu_torch.init(8 workers,
    scheduler "tensor"), the serve-127M model in bf16 whose parameters
    every replica shares, and:

    - mono: serve.run(build_llm_app(...)), one replica; a warm round and
      a timed round of SERVE_STREAMS streams through core._frames_for
      ("llm"), the SSE route's driver (start_stream / next_tokens polls);
      TTFT and latency per request, the TTFT window's quantiles, the
      engine's max_concurrent and decode steps, kernel 1's launches
      (launch_rule); a JSON and an SSE request through start_http(0); one
      more round under torch.profiler (device busy share, kernel 1's).
    - disagg: run_disagg_llm(one prefill, one decode replica); the same
      rounds through handle.stream_frames with a session each, kv_bytes;
      then a follow-up turn of the SERVE_FOLLOWUPS sessions the decode
      replica's KV cache holds: every one an affinity hit and a cached
      replay, kv_bytes unchanged, its tokens the first turn's.
    - parity: phase parity's prompts in f32 through the mono app (batch 4)
      and the split pools, each held to greedy_parity.
    - after each serve.shutdown(): no engine thread, the card's bytes
      back (serve_released).
    Returns the row; raises on any problem."""
    import gc
    import threading

    import ray_tpu_torch as ray
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch.models.inference import InferenceConfig
    from ray_tpu_torch.models.transformer import (TransformerConfig,
                                                  param_count)
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.serve import core
    from ray_tpu_torch.serve.llm import build_llm_app, run_disagg_llm

    smi = nvidia_smi()
    mcfg = TransformerConfig(dtype=torch.bfloat16, **SERVE)
    params = engine_params(torch, mcfg, 0)
    param_bytes = sum(t.nbytes for t in params.values())
    icfg = InferenceConfig(batch_size=SLOTS, page_size=PAGE,
                           max_pages_per_seq=MAX_PAGES, num_pages=NUM_PAGES,
                           prefill_buckets=(16,), max_new_tokens=NEW_TOKENS)
    page_bytes = (2 * mcfg.n_layers * NUM_PAGES * mcfg.n_kv_heads * PAGE
                  * mcfg.head_dim * 2)
    prompts = [[i + 1] * 4 for i in range(SERVE_STREAMS)]
    L = mcfg.n_layers
    problems = []
    # what earlier phases leave in the process shares its GIL and heap
    row = {"phase": "serve", "model": "serve-127M", "dtype": "bfloat16",
           "n_params": param_count(params), "param_bytes": param_bytes,
           "engine_page_bytes": page_bytes, "streams": SERVE_STREAMS,
           "new_tokens": NEW_TOKENS, "replica_max_concurrency": 8,
           "threads_at_start": threading.active_count(),
           "python_objects_at_start": len(gc.get_objects()),
           "nvidia_smi": smi}

    def engine_stats(name):
        return ray.get(core.get_app_handle(name).engine_stats.remote(),
                       timeout=120)

    def added_bytes(base):
        """The bytes the deployment's replicas added: one engine's pages,
        and no second copy of the weights."""
        torch.cuda.synchronize()
        added = torch.cuda.memory_allocated() - base
        if added > page_bytes + param_bytes // 2:
            problems.append(f"the replicas added {added} bytes: a second "
                            "copy of the weights")
        return added

    t_phase = time.perf_counter()
    seconds = row["seconds_by_part"] = {}

    def lap(part, t0):
        seconds[part] = time.perf_counter() - t0
        return time.perf_counter()

    ray.init(num_workers=RUNTIME_WORKERS, scheduler="tensor")
    try:
        # -- mono -----------------------------------------------------
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        serve.run(build_llm_app(params, mcfg, icfg))
        mono = {"replica_bytes": added_bytes(base)}

        def mono_stream(_i, prompt):
            return core._frames_for("llm", prompt, NEW_TOKENS)

        serve_round(mono_stream, prompts)                          # warm
        s0 = engine_stats("llm")
        core.metrics.reset()
        pa.paged_attention.launches = 0      # the main path: from zero
        results, dt = serve_round(mono_stream, prompts)
        launches = pa.paged_attention.launches
        s1 = engine_stats("llm")
        steps = s1["decode_steps"] - s0["decode_steps"]
        problems.append(launch_rule(launches, L, steps))
        mono.update(round_summary(results, dt, NEW_TOKENS, mcfg.vocab_size),
                    decode_steps=steps, paged_attention_launches=launches,
                    max_concurrent=s1["max_concurrent"],
                    ms_per_decode_step=dt / steps * 1e3,
                    window_ttft_s={"p50": core.metrics.ttft_quantile(0.5),
                                   "p95": core.metrics.ttft_quantile(0.95)})
        mono["http"], http_problems = serve_http(serve.start_http(0),
                                                 NEW_TOKENS)
        problems += http_problems
        breakdown = profile_call(torch, lambda: serve_round(mono_stream,
                                                            prompts))
        paged_us = breakdown["device_us_by_group"].get("paged attention", 0)
        # the profiled round does the timed round's work; its wall time is
        # inflated by the profiler, so the share uses the timed wall
        mono.update(device_busy_share=breakdown["device_busy_us"]
                    / (dt * 1e6),
                    paged_share_of_busy=paged_us
                    / breakdown["device_busy_us"],
                    profile=breakdown)
        serve.shutdown()
        mono["released"], problem = serve_released(torch, base)
        problems.append(problem)
        row["mono"] = mono
        t0 = lap("mono", t0)

        # -- disaggregated ----------------------------------------------
        handle = run_disagg_llm(params, mcfg, icfg, prefill_replicas=1,
                                decode_replicas=1)
        disagg = {"replica_bytes": added_bytes(base)}
        dec_state = core.get_app_handle("llm_decode")._state()

        def split_stream(tag):
            return lambda i, prompt: handle.stream_frames(
                prompt, NEW_TOKENS, session_id=f"{tag}{i}")

        serve_round(split_stream("warm"), prompts)
        d0 = engine_stats("llm_decode")
        core.metrics.reset()
        pa.paged_attention.launches = 0
        results, dt = serve_round(split_stream("s"), prompts)
        launches = pa.paged_attention.launches
        d1 = engine_stats("llm_decode")
        p1 = engine_stats("llm_prefill")
        steps = d1["decode_steps"] - d0["decode_steps"]
        problems.append(launch_rule(launches, L, steps))
        snap = core.metrics.snapshot()
        # K and V of each prompt's tokens, every layer, bf16
        want_kv = sum(2 * L * len(p) * mcfg.n_kv_heads * mcfg.head_dim * 2
                      for p in prompts)
        if snap["kv_bytes"] != want_kv:
            problems.append(f"kv_bytes {snap['kv_bytes']} != {want_kv}")
        disagg.update(round_summary(results, dt, NEW_TOKENS,
                                    mcfg.vocab_size),
                      decode_steps=steps, paged_attention_launches=launches,
                      max_concurrent=d1["max_concurrent"],
                      prefill_decode_steps=p1["decode_steps"],
                      kv_bytes=snap["kv_bytes"],
                      window_ttft_s={"p50": core.metrics.ttft_quantile(0.5),
                                     "p95": core.metrics.ttft_quantile(0.95)})
        first = {f"s{i}": r[0] for i, r in enumerate(results)}

        # the follow-up turn: the sessions the decode replica's KV cache
        # holds, read from the replica through its generic call path
        held = list(ray.get(dec_state.submit(
            "__getattribute__", ("_kv_cache",), {}), timeout=60))
        if (len(held) != SERVE_FOLLOWUPS
                or GLOBAL_CONFIG.serve_kv_cache_sessions != SERVE_FOLLOWUPS
                or not set(held) <= set(first)):
            problems.append(f"decode KV cache holds {held}")
        snap0, c0 = core.metrics.snapshot(), d1["cached_replays"]
        results, dt_f = serve_round(
            lambda i, prompt: handle.stream_frames(
                prompt, NEW_TOKENS, session_id=held[i]),
            [prompts[int(sid[1:])] for sid in held])
        snap1 = core.metrics.snapshot()
        replays = engine_stats("llm_decode")["cached_replays"] - c0
        hits = snap1["affinity_hit"] - snap0["affinity_hit"]
        same = sum(r[0] == first[sid] for r, sid in zip(results, held))
        disagg["followup"] = {
            **round_summary(results, dt_f, NEW_TOKENS, mcfg.vocab_size),
            "sessions": len(held), "affinity_hits": hits,
            "affinity_misses": snap1["affinity_miss"]
            - snap0["affinity_miss"],
            "cached_replays": replays,
            "kv_bytes_added": snap1["kv_bytes"] - snap0["kv_bytes"],
            "tokens_equal_first_turn": same}
        if (hits != len(held) or replays != len(held)
                or snap1["kv_bytes"] != snap0["kv_bytes"]
                or same != len(held)):
            problems.append(f"follow-up turn: {disagg['followup']}")
        serve.shutdown()
        disagg["released"], problem = serve_released(torch, base)
        problems.append(problem)
        row["disagg"] = disagg
        t0 = lap("disagg", t0)

        # -- f32 greedy parity through both apps ---------------------------
        pcfg, pparams, picfg, logits_of = parity_setup(torch)
        serve.run(build_llm_app(pparams, pcfg, picfg))
        mono_outs, _ = serve_round(
            lambda _i, p: core._frames_for("llm", p, PARITY_NEW),
            PARITY_PROMPTS)
        serve.shutdown()
        handle = run_disagg_llm(pparams, pcfg, picfg, prefill_replicas=1,
                                decode_replicas=1)
        split_outs, _ = serve_round(
            lambda _i, p: handle.stream_frames(p, PARITY_NEW),
            PARITY_PROMPTS)
        serve.shutdown()
        row["parity"] = {}
        for name, outs in (("mono", mono_outs), ("disagg", split_outs)):
            compared, ties = greedy_parity(
                torch, logits_of, PARITY_PROMPTS, [o[0] for o in outs],
                PARITY_NEW)
            row["parity"][name] = {"tokens_compared": compared,
                                   "near_ties": ties}
        lap("parity", t0)
    finally:
        serve.shutdown()
        ray.shutdown()
    seconds["phase"] = time.perf_counter() - t_phase
    problems = [p for p in problems if p]
    row["ok"] = not problems
    emit(row)
    if problems:
        raise AssertionError(f"serve phase: {problems}")
    return row


def data_pipeline(data, blocks):
    """BASELINE config 3's pipeline (perf.data_pipeline_throughput's) at
    ``blocks`` blocks of DATA_ROWS_PER_BLOCK rows."""
    return data.range(blocks * DATA_ROWS_PER_BLOCK,
                      parallelism=blocks).map_batches(
        lambda b: [x * 2 for x in b])


def native_exchange(shuffle_mod, package_dir):
    """The path of the exchange library _shuffle loaded, and whether it
    is the port's own build (under ray_tpu_torch/_build/)."""
    lib = shuffle_mod._lib()
    path = getattr(lib, "_name", None)
    ok = path is not None and Path(path).parent == \
        Path(package_dir) / "_build" and \
        Path(path).name.startswith("native_exchange-")
    return path, ok


def data_shuffle(data, shuffle_mod, package_dir):
    """random_shuffle(seed=0) over SHUFFLE_ROWS rows in SHUFFLE_BLOCKS
    list blocks, twice: (row, problems)."""
    path, native = native_exchange(shuffle_mod, package_dir)
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        rows = data.range(SHUFFLE_ROWS, parallelism=SHUFFLE_BLOCKS) \
            .random_shuffle(seed=0).take_all()
        runs.append((time.perf_counter() - t0, rows))
    (dt, a), (dt2, b) = runs
    row = {"rows": SHUFFLE_ROWS, "blocks": SHUFFLE_BLOCKS,
           "seconds": [dt, dt2], "rows_per_sec": SHUFFLE_ROWS / dt2,
           "native_library": path, "native": native,
           "permutation": sorted(a) == list(range(SHUFFLE_ROWS)),
           "same_order": a == b, "moved": a != list(range(SHUFFLE_ROWS))}
    problems = [f"shuffle: {what}" for key, what in (
        ("native", "the native exchange library is not loaded"),
        ("permutation", "not a permutation"),
        ("same_order", "two runs with seed 0 differ"),
        ("moved", "the rows stayed in order")) if not row[key]]
    return row, problems


def data_batches(data, dev):
    """iter_torch_batches(batch_size=BATCH_SIZE, device=dev) over a
    BATCH_ROWS-row int64 numpy column: (row, problems)."""
    import numpy as np

    col = np.arange(BATCH_ROWS, dtype=np.int64)
    want = int(col.sum())
    t0 = time.perf_counter()
    total, devices, n = 0, set(), 0
    for b in data.from_numpy(col).iter_torch_batches(batch_size=BATCH_SIZE,
                                                     device=dev):
        devices.add(str(b.device))
        total += int(b.sum())
        n += 1
    dt = time.perf_counter() - t0
    row = {"rows": BATCH_ROWS, "batch_size": BATCH_SIZE, "batches": n,
           "seconds": dt, "rows_per_sec": BATCH_ROWS / dt,
           "devices": sorted(devices), "sum": total, "want": want}
    problems = [f"batches: {what}" for what, bad in (
        (f"on {sorted(devices)}, not {dev}", devices != {str(dev)}),
        (f"sum {total} != {want}", total != want)) if bad]
    return row, problems


def phase_data(torch, dev):
    """Ray Data on the runtime, the TensorScheduler assigning on ``dev``
    (sched_backend "cuda"), 8 workers (see DATA_*).

    - thread mode: BASELINE config 3, data_pipeline_throughput at 10k
      blocks x 10 rows (the cut) after a warm pass of 1k blocks: blocks/s,
      rows/s, the stages, the exact count; kernels.assign's counter zeroed just
      before and read just after, equal to the timed run's device
      assigns and > 0. A checking run of 2k blocks: take_all equal to
      [2 * i for i in range(20000)], every snapshot _assign saw replayed
      through assign_np with no mismatch. random_shuffle(seed=0) through
      the port's native exchange library; iter_torch_batches on dev.
    - process mode: the same at 5k blocks (the cut), with the same
      checks, and no worker loading jax, flax or ray_tpu.
    Returns assign's launches in the timed runs: {"thread": n,
    "process": n}."""
    import ray_tpu_torch as ray
    from ray_tpu_torch import data
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.perf import data_pipeline_throughput
    from ray_tpu_torch._private.scheduler import kernels as sk
    from ray_tpu_torch._private.scheduler.tensor import TensorScheduler
    from ray_tpu_torch.data import _shuffle

    smi = nvidia_smi()
    t_phase = time.perf_counter()
    package_dir = Path(ray.__file__).resolve().parent
    problems, launches = [], {}
    rec = AssignRecorder(torch, TensorScheduler, sk, GLOBAL_CONFIG)
    try:
        for mode, blocks in (("thread", DATA_BLOCKS),
                             ("process", DATA_PROCESS_BLOCKS)):
            ray.init(num_workers=DATA_WORKERS, scheduler="tensor",
                     _system_config={"sched_backend": "cuda",
                                     "sched_device": dev.type,
                                     "worker_mode": mode})
            try:
                w = ray._worker.get_worker()
                threshold = GLOBAL_CONFIG.sched_hybrid_threshold
                if mode == "process":
                    wait_workers_ready(w.process_pool)
                    mods = worker_modules(ray, DATA_WORKERS)
                    emit({"phase": "data", "part": "process_workers",
                          "pids": sorted(mods), "modules": {
                              str(p): m for p, (m, _c) in mods.items()}})
                    if any(m for m, _c in mods.values()):
                        problems.append(f"a worker loaded {REF_MODULES}")
                data_pipeline_throughput(DATA_WARM_BLOCKS,
                                         DATA_ROWS_PER_BLOCK,
                                         own_runtime=False)
                # process mode holds its timed run to the oracle too
                rec.snapshots = [] if mode == "process" else None
                sk.assign.launches = 0          # the main path, from zero
                t_lo = time.perf_counter()
                r = data_pipeline_throughput(blocks, DATA_ROWS_PER_BLOCK,
                                             own_runtime=False)
                n = sk.assign.launches
                # the assigns' host and kernel times (AssignRecorder), and
                # the kernel spans' share of the run: the card's busy time
                timing = assign_timing(rec.calls, t_lo, time.perf_counter())
                kernel_ms = sum(c[4] for c in rec.calls
                                if c[0] >= t_lo and c[4] is not None)
                snaps, rec.snapshots = rec.snapshots or [], None
                launches[mode] = n
                want = blocks * DATA_ROWS_PER_BLOCK
                emit({"phase": "data", "part": f"pipeline_{mode}",
                      **{k: r[k] for k in (
                          "mode", "num_blocks", "rows", "count", "seconds",
                          "blocks_per_sec", "rows_per_sec", "stages",
                          "device_assigns")},
                      "assign_launches": n, "assign": timing,
                      "kernel_busy_share": kernel_ms / 1e3 / r["seconds"],
                      "cut": f"{blocks} blocks, not 100k",
                      "nvidia_smi": smi})
                problems += [f"{mode} pipeline: {what}" for what, bad in (
                    (f"count {r['count']} != {want}", r["count"] != want),
                    (f"assign launches {n} != device assigns "
                     f"{r['device_assigns']}", n != r["device_assigns"]),
                    ("no device assign", n == 0)) if bad]

                rec.snapshots = []
                a0 = w.scheduler.stats()["device_assigns"]
                sk.assign.launches = 0
                t0 = time.perf_counter()
                out = data_pipeline(data, DATA_CHECK_BLOCKS).take_all()
                dt = time.perf_counter() - t0
                n = sk.assign.launches
                assigns = w.scheduler.stats()["device_assigns"] - a0
                snaps += rec.snapshots
                rec.snapshots = None
                bad = replay_oracle(sk, snaps, threshold)
                exact = out == [2 * i for i in
                                range(DATA_CHECK_BLOCKS * DATA_ROWS_PER_BLOCK)]
                emit({"phase": "data", "part": f"oracle_{mode}",
                      "blocks": DATA_CHECK_BLOCKS, "seconds": dt,
                      "exact": exact, "assign_launches": n,
                      "device_assigns": assigns, "snapshots": len(snaps),
                      "differ": bad})
                problems += [f"{mode} check: {what}" for what, failed in (
                    ("take_all not exact", not exact),
                    (f"assign launches {n} != device assigns {assigns}",
                     n != assigns), ("no device assign", n == 0),
                    (f"{bad} of {len(snaps)} snapshots differ from "
                     "assign_np", bad or not snaps)) if failed]

                if mode == "thread":
                    row, found = data_shuffle(data, _shuffle, package_dir)
                    emit({"phase": "data", "part": "shuffle", **row})
                    problems += found
                    row, found = data_batches(data, dev)
                    emit({"phase": "data", "part": "torch_batches", **row})
                    problems += found
                if w.scheduler.stats()["device_assign_errors"]:
                    problems.append(f"{mode}: device assign errors")
            finally:
                ray.shutdown()
    finally:
        rec.remove()
        ray.shutdown()
        GLOBAL_CONFIG.reset()
    emit({"phase": "data", "part": "done",
          "seconds": time.perf_counter() - t_phase, "ok": not problems,
          "nvidia_smi": smi})
    if problems:
        raise AssertionError(f"data phase: {problems}")
    return launches


def dead_row_check(sk, snapshots, dead_rows, threshold):
    """The snapshots taken after the rows in dead_rows were removed (their
    capacity is zero in the snapshot): (how many, how many put a task on
    a dead row, how many differ from assign_np)."""
    import numpy as np

    rows = sorted(dead_rows)
    after = [s for s in snapshots if s[0][4].shape[0] > max(rows)
             and not s[0][4][rows].any()]
    on_dead = sum(bool(np.isin(node_of, rows).any())
                  for _snap, node_of, _avail in after)
    return len(after), on_dead, replay_oracle(sk, after, threshold)


def wait_running_on(w, node_index, timeout=60.0):
    """Seconds until a task runs on scheduler row node_index. On timeout
    the error names the rows tasks ran on meanwhile, the task states
    left, each node's state and death reason, and the scheduler's device
    assigns and errors."""
    from collections import Counter

    t0 = time.perf_counter()
    ran = Counter()
    while True:
        table = w.scheduler.task_table()
        running = [r["node_index"] for r in table if r["state"] == "RUNNING"]
        if node_index in running:
            return time.perf_counter() - t0
        ran.update(set(running))
        if time.perf_counter() - t0 > timeout:
            stats = w.scheduler.stats()
            nodes = {e.index: (e.state, e.death_reason)
                     for e in w.gcs.node_table()}
            raise AssertionError(
                f"no task ever ran on row {node_index} in {timeout} s: "
                f"polls that saw a task running, by row {dict(ran)}; "
                f"states left {dict(Counter(r['state'] for r in table))}; "
                f"nodes {nodes}; device assigns "
                f"{stats.get('device_assigns')}, errors "
                f"{stats.get('device_assign_errors')}")
        time.sleep(0.005)


def detection_deadline(config):
    """The most seconds the GCS health check may take to mark a node whose
    workers were all killed DEAD: its failure budget plus 5 periods."""
    return config.health_check_timeout_s + 5 * config.health_check_period_s


def phase_cluster(torch, dev):
    """The local virtual cluster (see CLUSTER_*): a Cluster whose head runs
    the TensorScheduler assigning on ``dev`` (sched_backend "cuda"), and
    five process-backed nodes.

    - remove_node while CLUSTER_TASKS 50 ms tasks (max_retries=5) run:
      results exact, the node DEAD, every snapshot taken after the removal
      equal to assign_np's and giving the dead row no task; seconds.
    - kill_worker_processes on another node: the health check marks it
      DEAD within detection_deadline, its tasks finish exactly.
    - a max_restarts=2 actor soft-pinned to a node answers again from a
      survivor after remove_node; a 4-CPU placement-group bundle moves
      off its removed node.
    - the Autoscaler (VirtualNodeProvider) against a 1-CPU head: 12 x
      0.4 s tasks give an upscale, then a downscale once idle; both times.
    - after shutdown no worker process of any node is alive.
    In every part kernels.assign's counter is zeroed just before and read
    just after: equal to the scheduler's device assigns. Returns the
    launches over the parts."""
    import ray_tpu_torch as ray
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.scheduler import kernels as sk
    from ray_tpu_torch._private.scheduler.tensor import TensorScheduler
    from ray_tpu_torch.autoscaler import (Autoscaler, AutoscalerConfig,
                                          VirtualNodeProvider)
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util import (NodeAffinitySchedulingStrategy,
                                    placement_group, placement_group_table)

    smi = nvidia_smi()
    t_phase = time.perf_counter()
    system = {"sched_backend": "cuda", "sched_device": dev.type}
    problems, pids, total = [], set(), [0]
    rec = AssignRecorder(torch, TensorScheduler, sk, GLOBAL_CONFIG)

    def part(name, fn):
        """fn() with the counter zeroed just before and read just after,
        and every snapshot kept: (fn's result, snapshots)."""
        w = ray._worker.get_worker()
        rec.snapshots = []
        a0 = w.scheduler.stats()["device_assigns"]
        sk.assign.launches = 0
        out = fn()
        n = sk.assign.launches
        assigns = w.scheduler.stats()["device_assigns"] - a0
        snaps, rec.snapshots = rec.snapshots, None
        total[0] += n
        if n != assigns:
            problems.append(f"{name}: assign launches {n} != device "
                            f"assigns {assigns}")
        return out, snaps, {"assign_launches": n, "device_assigns": assigns}

    def removal_checks(name, snaps, rows):
        after, on_dead, differ = dead_row_check(
            sk, snaps, rows, GLOBAL_CONFIG.sched_hybrid_threshold)
        problems.extend(f"{name}: {what}" for what, bad in (
            ("no snapshot after the removal", after == 0),
            (f"{on_dead} snapshots put a task on the dead row", on_dead),
            (f"{differ} snapshots differ from assign_np", differ)) if bad)
        return {"snapshots_after": after, "on_dead_row": on_dead,
                "differ": differ}

    try:
        cluster = Cluster(initialize_head=True, head_node_args=dict(
            CLUSTER_HEAD, _system_config=system))
        try:
            w = ray._worker.get_worker()
            t0 = time.perf_counter()
            nodes = [cluster.add_node(**CLUSTER_NODE) for _ in range(5)]
            for node in nodes:
                wait_workers_ready(node._entry.pool)
                pids.update(node.worker_pids())
            emit({"phase": "cluster", "part": "startup", "nodes": len(nodes),
                  "node": CLUSTER_NODE, "head": CLUSTER_HEAD,
                  "all_ready_seconds": time.perf_counter() - t0,
                  "worker_pids": len(pids), "nvidia_smi": smi})

            @ray.remote(max_retries=5)
            def task(i):
                time.sleep(CLUSTER_TASK_S)
                return i

            victim = nodes[0]

            def run_remove():
                t0 = time.perf_counter()
                refs = [task.remote(i) for i in range(CLUSTER_TASKS)]
                wait_running_on(w, victim.index)
                t_rm = time.perf_counter()
                cluster.remove_node(victim)
                out = ray.get(refs, timeout=300)
                return (time.perf_counter() - t0,
                        time.perf_counter() - t_rm, out)

            (dt, after_s, out), snaps, counts = part("remove_node",
                                                     run_remove)
            row = {"tasks": CLUSTER_TASKS, "seconds": dt,
                   "seconds_after_removal": after_s,
                   "exact": out == list(range(CLUSTER_TASKS)),
                   "state": victim.state, "dead_row": victim.index,
                   **counts, **removal_checks("remove_node", snaps,
                                              {victim.index})}
            emit({"phase": "cluster", "part": "remove_node", **row})
            problems += [f"remove_node: {what}" for what, bad in (
                ("results not exact", not row["exact"]),
                (f"node {victim.state}", victim.state != "DEAD"),
                ("no device assign", counts["assign_launches"] == 0))
                if bad]

            victim = nodes[1]

            def run_kill():
                refs = [task.remote(i) for i in range(CLUSTER_TASKS // 2)]
                wait_running_on(w, victim.index)
                t0 = time.perf_counter()
                victim.kill_worker_processes()
                while victim.state != "DEAD" \
                        and time.perf_counter() - t0 < 60:
                    time.sleep(0.005)
                detect = time.perf_counter() - t0
                out = ray.get(refs, timeout=300)
                return detect, time.perf_counter() - t0, out

            (detect, dt, out), snaps, counts = part("kill", run_kill)
            deadline = detection_deadline(GLOBAL_CONFIG)
            row = {"tasks": CLUSTER_TASKS // 2, "detect_seconds": detect,
                   "deadline_seconds": deadline, "seconds": dt,
                   "exact": out == list(range(CLUSTER_TASKS // 2)),
                   "state": victim.state, "dead_row": victim.index,
                   **counts, **removal_checks("kill", snaps,
                                              {victim.index})}
            emit({"phase": "cluster", "part": "kill_worker_processes",
                  **row})
            problems += [f"kill: {what}" for what, bad in (
                ("results not exact", not row["exact"]),
                (f"node {victim.state}", victim.state != "DEAD"),
                (f"detected in {detect} s > {deadline} s",
                 detect > deadline)) if bad]

            victim = nodes[2]

            @ray.remote
            class Counter:
                def __init__(self):
                    self.n = 0

                def incr(self):
                    self.n += 1
                    return self.n

            def run_actor():
                a = Counter.options(
                    max_restarts=2, max_task_retries=2,
                    scheduling_strategy=NodeAffinitySchedulingStrategy(
                        node_id=victim.node_id, soft=True)).remote()
                first = ray.get(a.incr.remote(), timeout=120)
                on = w.actors[a._actor_id]._pool.node_index
                t0 = time.perf_counter()
                cluster.remove_node(victim)
                again = ray.get(a.incr.remote(), timeout=120)
                dt = time.perf_counter() - t0
                rt = w.actors[a._actor_id]
                out = (first, on, again, dt, rt._pool.node_index,
                       rt.state.name)
                ray.kill(a)
                return out

            (first, on, again, dt, now_on, state), _s, counts = part(
                "actor", run_actor)
            emit({"phase": "cluster", "part": "actor_restart",
                  "first": first, "on_row": on, "after_restart": again,
                  "restart_seconds": dt, "now_on_row": now_on,
                  "state": state, **counts})
            problems += [f"actor: {what}" for what, bad in (
                (f"first call gave {first}", first != 1),
                (f"created on row {on}, not {victim.index}",
                 on != victim.index),
                (f"after the restart gave {again}", again != 1),
                ("still on the dead row", now_on == victim.index),
                (f"state {state}", state != "ALIVE")) if bad]

            def run_pg():
                pg = placement_group([{"CPU": 4}], strategy="PACK")
                if not pg.wait(60):
                    raise AssertionError("the 4-CPU bundle never placed")
                states = w.scheduler._node_states
                parent = states[w.placement_groups.get(pg.id).rows[0]].parent
                dead = next(n for n in nodes if n.index == parent)
                t0 = time.perf_counter()
                cluster.remove_node(dead)
                while time.perf_counter() - t0 < 60:
                    if placement_group_table()[pg.id.hex()]["state"] \
                            == "CREATED" and states[w.placement_groups.get(
                                pg.id).rows[0]].parent != dead.index:
                        break
                    time.sleep(0.005)
                dt = time.perf_counter() - t0
                now = states[w.placement_groups.get(pg.id).rows[0]].parent
                return parent, now, dt, placement_group_table()[
                    pg.id.hex()]["state"]

            (before, now, dt, state), _s, counts = part("pg", run_pg)
            emit({"phase": "cluster", "part": "pg_reschedule",
                  "parent_before": before, "parent_after": now,
                  "seconds": dt, "state": state, **counts})
            if state != "CREATED" or now == before:
                problems.append(f"pg: bundle on row {now} ({state}) after "
                                f"row {before} died")
            for e in w.gcs.node_table():
                if e.pool is not None:
                    pids.update(e.pool.pids())
        finally:
            cluster.shutdown()

        ray.init(num_cpus=1, num_workers=2, scheduler="tensor",
                 _system_config=system)
        try:
            w = ray._worker.get_worker()
            scaler = Autoscaler(
                w, VirtualNodeProvider(w, num_cpus=4, num_workers=2),
                AutoscalerConfig(min_nodes=0, max_nodes=2, upscale_ticks=2,
                                 idle_timeout_s=0.6, poll_interval_s=0.1))
            scaler.start()

            @ray.remote
            def slow(i):
                time.sleep(AUTOSCALE_TASK_S)
                return i

            def run_scale():
                t0 = time.perf_counter()
                refs = [slow.remote(i) for i in range(AUTOSCALE_TASKS)]
                while scaler.num_upscales == 0 \
                        and time.perf_counter() - t0 < 60:
                    time.sleep(0.005)
                up = time.perf_counter() - t0
                out = ray.get(refs, timeout=300)
                t_idle = time.perf_counter()
                while scaler.num_downscales == 0 \
                        and time.perf_counter() - t_idle < 60:
                    time.sleep(0.005)
                down = time.perf_counter() - t_idle
                # the node table after the downscale still runs work
                after = ray.get([slow.remote(i) for i in range(4)],
                                timeout=120)
                return up, down, out, after

            (up, down, out, after), snaps, counts = part("autoscaler",
                                                         run_scale)
            scaler.stop()
            dead = {e.index for e in w.gcs.node_table()
                    if e.state == "DEAD"}
            for e in w.gcs.node_table():
                if e.pool is not None:
                    pids.update(e.pool.pids())
            row = {"tasks": AUTOSCALE_TASKS, "upscale_seconds": up,
                   "downscale_seconds_after_idle": down,
                   "upscales": scaler.num_upscales,
                   "downscales": scaler.num_downscales,
                   "exact": out == list(range(AUTOSCALE_TASKS))
                   and after == list(range(4)), **counts,
                   **(removal_checks("autoscaler", snaps, dead)
                      if dead else {})}
            emit({"phase": "cluster", "part": "autoscaler", **row})
            problems += [f"autoscaler: {what}" for what, bad in (
                ("no upscale", scaler.num_upscales < 1),
                ("no downscale", scaler.num_downscales < 1),
                ("results not exact", not row["exact"]),
                ("no device assign", counts["assign_launches"] == 0))
                if bad]
            if w.scheduler.stats()["device_assign_errors"]:
                problems.append("device assign errors")
        finally:
            ray.shutdown()
        t0 = time.perf_counter()
        while any(pid_alive(p) for p in pids) \
                and time.perf_counter() - t0 < 30:
            time.sleep(0.05)
        alive = sorted(p for p in pids if pid_alive(p))
        emit({"phase": "cluster", "part": "shutdown",
              "worker_pids": len(pids), "alive": alive,
              "seconds": time.perf_counter() - t0})
        if alive or not pids:
            problems.append(f"shutdown: worker processes alive {alive}")
    finally:
        rec.remove()
        ray.shutdown()
        GLOBAL_CONFIG.reset()
    emit({"phase": "cluster", "part": "done",
          "seconds": time.perf_counter() - t_phase, "ok": not problems,
          "launches": total[0], "nvidia_smi": smi})
    if problems:
        raise AssertionError(f"cluster phase: {problems}")
    return total[0]


def tree_on(tree, dev):
    """Whether every tensor of a parameter tree lies on dev."""
    from ray_tpu_torch.rllib.optim import tree_leaves

    return all(t.device == dev for t in tree_leaves(tree))


def rl_first_batches(algo):
    """Wrap algo._collect so that the batches of its first call are kept:
    the returned list holds them once train() has run."""
    kept, collect = [], algo._collect

    def _collect():
        out = collect()
        if not kept:
            kept.append(out)
        return out

    algo._collect = _collect
    return kept


def rl_recording_env_maker(out_dir):
    """CartPoleEnv(seed), and a file out_dir/<pid>.json a process naming
    the REF_MODULES it has loaded and its CUDA_VISIBLE_DEVICES."""
    def maker(seed):
        import json as _json
        import os as _os
        import sys as _sys

        from ray_tpu_torch.rllib.env import CartPoleEnv

        path = _os.path.join(out_dir, f"{_os.getpid()}.json")
        if not _os.path.exists(path):
            with open(path, "w") as f:
                _json.dump({"modules": sorted(
                    m for m in _sys.modules
                    if m.split(".")[0] in REF_MODULES),
                    "cuda_visible_devices": _os.environ.get(
                        "CUDA_VISIBLE_DEVICES")}, f)
        return CartPoleEnv(seed)

    return maker


def rl_update_parity(torch, module, cfg, params, opt_state, dev):
    """One PPO update (ppo._make_update at cfg's settings) on dev and on
    the CPU from the same params, optimizer state and a seeded minibatch
    of RL_MINIBATCH rows, TF32 off: loss, pre-clip grad norm and every
    updated parameter within RL_UPDATE_BOUND (relative L2 per leaf), and
    each side's time a call (RL_UPDATE_REPEATS calls, synchronised)."""
    import numpy as np

    from ray_tpu_torch.rllib.core import to_device
    from ray_tpu_torch.rllib.optim import tree_leaves
    from ray_tpu_torch.rllib.ppo import _make_update

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    n = RL_MINIBATCH
    host = (rng.normal(size=(n, 4)).astype(np.float32),
            rng.integers(0, 2, n).astype(np.int64),
            rng.normal(-0.7, 0.1, n).astype(np.float32),
            rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32))
    _opt, update = _make_update(cfg.lr, cfg.clip, cfg.vf_coeff,
                                cfg.ent_coeff, cfg.max_grad_norm, module)
    out, ms = {}, {}
    for where in (dev, torch.device("cpu")):
        p, s = to_device(params, where), to_device(opt_state, where)
        args = [torch.as_tensor(x, device=where) for x in host]
        out[where.type] = update(p, s, *args)
        sync = (lambda: torch.cuda.synchronize(where)) \
            if where.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        for _ in range(RL_UPDATE_REPEATS):
            r = update(p, s, *args)
        float(r[2])
        sync()
        ms[where.type] = (time.perf_counter() - t0) / RL_UPDATE_REPEATS * 1e3
    (pd, _sd, ld, ad), (pc, _sc, lc, ac) = out[dev.type], out["cpu"]
    leaf = max(float(torch.linalg.vector_norm(a.cpu() - b)
                     / torch.linalg.vector_norm(b))
               for a, b in zip(tree_leaves(pd), tree_leaves(pc)))
    row = {"loss_card": float(ld), "loss_cpu": float(lc),
           "loss_diff": abs(float(ld) - float(lc)),
           "grad_norm_card": float(ad[3]), "grad_norm_cpu": float(ac[3]),
           "grad_norm_rel_diff": abs(float(ad[3]) - float(ac[3]))
           / float(ac[3]),
           "worst_param_rel_l2": leaf, "bound": RL_UPDATE_BOUND,
           "minibatch": n, "ms_card": ms[dev.type], "ms_cpu": ms["cpu"],
           "faster": dev.type if ms[dev.type] < ms["cpu"] else "cpu"}
    row["ok"] = (row["loss_diff"] <= RL_UPDATE_BOUND * max(1.0, abs(float(lc)))
                 and row["grad_norm_rel_diff"] <= RL_UPDATE_BOUND
                 and leaf <= RL_UPDATE_BOUND)
    return row


def rl_profiled(torch, make):
    """One warm iteration of the algorithm make() builds, then one under
    torch.profiler (profile_call): wall, device busy time and share, the
    top kernels."""
    algo = make()
    try:
        algo.train()
        prof = profile_call(torch, algo.train)
    finally:
        algo.stop()
    return {**prof, "device_busy_share": prof["device_busy_us"]
            / prof["wall_us"]}


def rl_learns(R, dev, dev_arg):
    """PPO on CartPole (RL_PPO, the reference's learning test) until
    episode_return_mean > 1.5 x max(first, 20), at most RL_PPO_ITERS
    iterations; then ray.kill of one runner and one more iteration.
    (row, problems, the first iteration's batches, the algorithm)."""
    import ray_tpu_torch as ray

    algo = R.PPOConfig(**RL_PPO, device=dev_arg).build()
    first_batches = rl_first_batches(algo)
    problems, returns, learner_ms, steps = [], [], [], 0
    t0 = time.perf_counter()
    while len(returns) < RL_PPO_ITERS:
        m = algo.train()
        returns.append(m["episode_return_mean"])
        learner_ms.append(m["learner_ms"])
        steps += m["num_env_steps"]
        if len(returns) > 1 and returns[-1] > 1.5 * max(returns[0], 20):
            break
    dt = time.perf_counter() - t0
    reached = len(returns) > 1 and returns[-1] > 1.5 * max(returns[0], 20)
    ray.kill(algo._runners[0])
    it = algo.iteration
    after = algo.train()
    row = {"iterations": len(returns), "returns": returns,
           "threshold": 1.5 * max(returns[0], 20), "reached": reached,
           "env_steps_per_sec": steps / dt,
           "learner_ms_per_update": sum(learner_ms) / len(learner_ms),
           "learner_ms_by_iteration": learner_ms,
           "learner_device": str(algo.device),
           "after_kill": {k: after[k] for k in (
               "training_iteration", "num_env_steps",
               "episode_return_mean")}}
    problems += [f"ppo: {what}" for what, bad in (
        (f"no {row['threshold']} within {RL_PPO_ITERS} iterations: "
         f"{returns}", not reached),
        (f"learner on {algo.device}, not {dev}", algo.device != dev),
        ("params off the learner's device",
         not tree_on(algo.params, dev)),
        ("no training after a runner's kill",
         after["training_iteration"] != it + 1
         or after["num_env_steps"] <= 0)) if bad]
    return row, problems, first_batches, algo


def rl_other_algorithms(R, dev, dev_arg):
    """IMPALA and APPO one iteration each, DQN and SAC (Pendulum) two each,
    at their default configs: every loss of an iteration that updated
    finite, at least one update each, the params on dev after."""
    import math

    rows, problems = {}, []
    cases = (("IMPALA", R.IMPALAConfig(device=dev_arg), 1, "loss"),
             ("APPO", R.APPOConfig(device=dev_arg), 1, "loss"),
             ("DQN", R.DQNConfig(device=dev_arg), 2, "loss"),
             ("SAC", R.SACConfig(env_maker=lambda s: R.PendulumEnv(s),
                                 device=dev_arg), 2, "q_loss"))
    for name, cfg, iters, key in cases:
        algo = cfg.build()
        try:
            t0 = time.perf_counter()
            losses = [algo.train()[key] for _ in range(iters)]
            dt = time.perf_counter() - t0
            on_dev = tree_on(algo.params, dev)
        finally:
            algo.stop()
        ran = [x for x in losses if not math.isnan(x)]
        rows[name] = {"iterations": iters, key: losses, "seconds": dt,
                      "params_on": str(dev) if on_dev else "elsewhere"}
        problems += [f"{name}: {what}" for what, bad in (
            ("no update ran", not ran),
            (f"a loss not finite: {losses}",
             not all(math.isfinite(x) for x in ran)),
            (f"params not on {dev}", not on_dev)) if bad]
    return rows, problems


def phase_rllib(torch, dev):
    """BASELINE config 5 and RLlib on the card (see RL_*): the runtime
    with 8 workers, the TensorScheduler assigning on ``dev``.

    (a) perf.rl_rollout_throughput(iters=4) at the reference's sizes, the
        learner on dev: env-steps/s, learner ms an update, the return;
        kernels.assign's counter zeroed just before and read just after,
        equal to the device assigns and > 0, every snapshot equal to
        assign_np.
    (b) PPO on CartPole (the reference's learning test) to 1.5 x
        max(first, 20) within 17 iterations, the learner from
        ``device=None``; a runner killed, the next iteration trains.
        One iteration each of config 5's IMPALA and of this PPO, after a
        warm one, under torch.profiler: the device's busy share.
    (c) one PPO update on dev against the same update on the CPU (TF32
        off): loss, grad norm, every parameter within RL_UPDATE_BOUND;
        both timed.
    (d) process mode, 8 workers: PPO at (b)'s seed, 2 iterations; the
        first batch bit-identical to (b)'s; no runner process with jax,
        flax or ray_tpu, none seeing a card; the learner on dev; assign's
        counter as in (a).
    (e) IMPALA, APPO (1 iteration), DQN, SAC (2 iterations): losses
        finite, params on dev.
    Returns assign's launches: {"thread": (a)'s, "process": (d)'s}."""
    import os
    import tempfile

    import numpy as np

    import ray_tpu_torch as ray
    from ray_tpu_torch import rllib as R
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.perf import rl_rollout_throughput
    from ray_tpu_torch._private.scheduler import kernels as sk
    from ray_tpu_torch._private.scheduler.tensor import TensorScheduler
    from ray_tpu_torch.rllib.core import host_copy

    smi = nvidia_smi()
    t_phase = time.perf_counter()
    # None means the card: the entry points' own default, on the card
    dev_arg = None if dev.type == "cuda" else str(dev)
    system = {"sched_backend": "cuda", "sched_device": dev.type}
    problems, launches = [], {}
    rec = AssignRecorder(torch, TensorScheduler, sk, GLOBAL_CONFIG)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_rllib_")
    try:
        ray.init(num_workers=RL_WORKERS, scheduler="tensor",
                 _system_config=system)
        try:
            threshold = GLOBAL_CONFIG.sched_hybrid_threshold
            rec.snapshots = []
            sk.assign.launches = 0          # the main path, from zero
            r = rl_rollout_throughput(iters=RL_ITERS, device=dev_arg)
            n = sk.assign.launches
            snaps, rec.snapshots = rec.snapshots, None
            bad = replay_oracle(sk, snaps, threshold)
            launches["thread"] = n
            emit({"phase": "rllib", "part": "config5_impala",
                  "runners": 4, "envs_per_runner": 8, "rollout_len": 64,
                  "updates_per_iter": 8, "iters": RL_ITERS, **r,
                  "assign_launches": n, "snapshots": len(snaps),
                  "differ": bad, "nvidia_smi": smi})
            problems += [f"config 5: {what}" for what, failed in (
                (f"learner on {r['learner_device']}",
                 r["learner_device"] != str(dev)),
                (f"assign launches {n} != device assigns "
                 f"{r['device_assigns']}", n != r["device_assigns"]),
                ("no device assign", n == 0),
                (f"{bad} of {len(snaps)} snapshots differ from assign_np",
                 bad or not snaps)) if failed]

            if dev.type == "cuda":
                emit({"phase": "rllib", "part": "config5_profile",
                      **rl_profiled(torch, lambda: R.IMPALAConfig(
                          **RL_CONFIG5, device=dev_arg).build())})
            row, found, thread_batches, algo = rl_learns(R, dev, dev_arg)
            emit({"phase": "rllib", "part": "ppo_cartpole", **row,
                  "config": RL_PPO})
            if dev.type == "cuda":
                emit({"phase": "rllib", "part": "ppo_profile",
                      **rl_profiled(torch, lambda: R.PPOConfig(
                          **RL_PPO, device=dev_arg).build())})
            problems += found
            row = rl_update_parity(torch, algo.module, algo.config,
                                   host_copy(algo.params),
                                   algo.opt_state, dev)
            algo.stop()
            emit({"phase": "rllib", "part": "update_card_vs_cpu", **row})
            if not row["ok"]:
                problems.append("the card's PPO update is out of the f32 "
                                "bound of the CPU's")
            rows, found = rl_other_algorithms(R, dev, dev_arg)
            emit({"phase": "rllib", "part": "algorithms", **rows})
            problems += found
            if ray._worker.get_worker().scheduler.stats()[
                    "device_assign_errors"]:
                problems.append("thread: device assign errors")
        finally:
            ray.shutdown()

        ray.init(num_workers=RL_WORKERS, scheduler="tensor",
                 _system_config={**system, "worker_mode": "process"})
        try:
            w = ray._worker.get_worker()
            threshold = GLOBAL_CONFIG.sched_hybrid_threshold
            wait_workers_ready(w.process_pool)
            rec.snapshots = []
            a0 = w.scheduler.stats()["device_assigns"]
            sk.assign.launches = 0
            t0 = time.perf_counter()
            algo = R.PPOConfig(**RL_PPO, device=dev_arg,
                               env_maker=rl_recording_env_maker(out_dir)
                               ).build()
            try:
                batches = rl_first_batches(algo)
                its = [algo.train() for _ in range(RL_PROCESS_ITERS)]
                on_dev = algo.device == dev and tree_on(algo.params,
                                                        dev)
            finally:
                algo.stop()
            dt = time.perf_counter() - t0
            n = sk.assign.launches
            assigns = w.scheduler.stats()["device_assigns"] - a0
            snaps, rec.snapshots = rec.snapshots, None
            bad = replay_oracle(sk, snaps, threshold)
            launches["process"] = n
            same = [all(np.array_equal(p[k], t[k]) for k in RL_BATCH_KEYS)
                    for p, t in zip(batches[0], thread_batches[0])]
            procs = {}
            for name in os.listdir(out_dir):
                pid = int(name.split(".")[0])
                if pid != os.getpid():
                    with open(os.path.join(out_dir, name)) as f:
                        procs[pid] = json.load(f)
            emit({"phase": "rllib", "part": "process_mode",
                  "workers": RL_WORKERS, "iterations": RL_PROCESS_ITERS,
                  "seconds": dt, "returns": [m["episode_return_mean"]
                                             for m in its],
                  "first_batch_bit_identical": same,
                  "runner_processes": {str(p): v for p, v in procs.items()},
                  "learner_on": str(dev) if on_dev else "elsewhere",
                  "assign_launches": n, "device_assigns": assigns,
                  "snapshots": len(snaps), "differ": bad})
            problems += [f"process: {what}" for what, failed in (
                (f"first batch differs from thread mode's: {same}",
                 len(same) != RL_PPO["num_env_runners"] or not all(same)),
                (f"runner processes {sorted(procs)}",
                 len(procs) < RL_PPO["num_env_runners"]),
                (f"a runner loaded {REF_MODULES}",
                 any(v["modules"] for v in procs.values())),
                ("a runner sees a card", any(
                    v["cuda_visible_devices"] != "" for v in procs.values())),
                (f"learner not on {dev}", not on_dev),
                (f"assign launches {n} != device assigns {assigns}",
                 n != assigns), ("no device assign", n == 0),
                (f"{bad} of {len(snaps)} snapshots differ from assign_np",
                 bad or not snaps)) if failed]
        finally:
            ray.shutdown()
    finally:
        rec.remove()
        ray.shutdown()
        GLOBAL_CONFIG.reset()
        shutil.rmtree(out_dir, ignore_errors=True)
    emit({"phase": "rllib", "part": "done",
          "seconds": time.perf_counter() - t_phase, "ok": not problems,
          "nvidia_smi": smi})
    if problems:
        raise AssertionError(f"rllib phase: {problems}")
    return launches


def train_lib_loop(torch, dev, side):
    """Trainer's train_loop_per_worker for phase train_lib: the flagship
    model (_train_setup at TRAIN_LIB_BATCH) through make_optimizer /
    make_train_step on dev, TRAIN_LIB_STEPS steps from the checkpoint it
    is given, if any. With config["fail"], the model and AdamW state are
    saved after step 1 and the first attempt raises at
    TRAIN_LIB_FAIL_STEP. Times and bytes go to ``side``."""
    import os

    from ray_tpu_torch import train
    from ray_tpu_torch.models import train_step as ts
    from ray_tpu_torch.models.transformer import Transformer

    def loop(config):
        cfg, params, tokens = _train_setup(torch, torch.bfloat16,
                                           TRAIN_LIB_BATCH)
        model = Transformer(cfg, device=dev).load_params(params)
        del params
        opt = ts.make_optimizer(model.parameters())
        step = ts.make_train_step(model, opt)
        start, ckpt = 0, train.get_checkpoint()
        if ckpt is not None:
            t0 = time.perf_counter()
            state = train.load_torch_checkpoint(ckpt, map_location=dev)
            model.load_state_dict(state["model"])
            opt.load_state_dict(state["optim"])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            side["load_s"] = time.perf_counter() - t0
            start = state["step"] + 1
            del state
        for s in range(start, TRAIN_LIB_STEPS):
            if (config["fail"] and s == TRAIN_LIB_FAIL_STEP
                    and not os.path.exists(config["marker"])):
                open(config["marker"], "w").close()
                raise RuntimeError("injected worker failure")
            loss = float(step({"tokens": tokens})["loss"])
            side.setdefault("losses", {})[s] = loss
            saved = None
            if config["fail"] and s == TRAIN_LIB_FAIL_STEP - 1:
                t0 = time.perf_counter()
                saved = train.save_torch_checkpoint(
                    config["dir"], {"model": model.state_dict(),
                                    "optim": opt.state_dict(), "step": s})
                side["save_s"] = time.perf_counter() - t0
                side["bytes"] = sum(
                    os.path.getsize(os.path.join(saved.path, f))
                    for f in os.listdir(saved.path))
            train.report({"step": s, "loss": loss, "resumed_from": start},
                         checkpoint=saved)

    return loop


def phase_train_lib(torch, dev):
    """Train on the card (see TRAIN_LIB_*): the runtime with 8 workers,
    the TensorScheduler assigning on ``dev``.

    - a 1-worker Trainer whose loop trains the flagship model (phase
      train's width and depth, 445M parameters, bf16, remat "dots"; the
      batch cut to [4, 2048]) for 4 steps, saves model and AdamW state
      with save_torch_checkpoint after step 1 and raises at step 2 on
      its first attempt; FailureConfig(max_failures=1) restarts it from
      the checkpoint. The flash counters and kernels.assign's counter
      zeroed just before fit() and read just after: 3 kernels x layers
      x the steps run, and assign's launches equal to the device assigns
      and > 0. An uninterrupted run from the same seeds: the resumed
      losses of steps 2-3 within TRAIN_LIB_REL of it (and whether
      bit-equal); the checkpoint's bytes, save and load seconds.
    - a 2-worker Trainer on CPU loops over get_dataset_shard of a
      10k-row data.range: the shards disjoint, their union every row.
    Returns assign's launches in the flagship fit."""
    import math
    import os
    import tempfile

    import ray_tpu_torch as ray
    from ray_tpu_torch import data, train
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.scheduler import kernels as sk

    smi = nvidia_smi()
    t_phase = time.perf_counter()
    problems = []
    kernels = _flash_kernels()
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    ray.init(num_workers=RL_WORKERS, scheduler="tensor",
             _system_config={"sched_backend": "cuda",
                             "sched_device": dev.type})
    try:
        w = ray._worker.get_worker()
        side = {}
        a0 = w.scheduler.stats()["device_assigns"]
        for kern in kernels.values():
            kern.launches = 0
        sk.assign.launches = 0              # the main path, from zero
        t0 = time.perf_counter()
        resumed = train.Trainer(
            train_lib_loop(torch, dev, side),
            train_loop_config={"fail": True,
                               "dir": os.path.join(root, "ckpt"),
                               "marker": os.path.join(root, "failed")},
            scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(
                failure_config=train.FailureConfig(max_failures=1))).fit()
        dt = time.perf_counter() - t0
        n = sk.assign.launches
        assigns = w.scheduler.stats()["device_assigns"] - a0
        flash = {k: kern.launches for k, kern in kernels.items()}
        # steps 0 to FAIL_STEP - 1, then FAIL_STEP to STEPS - 1 resumed
        steps_run = TRAIN_LIB_STEPS
        layers = TRAIN["n_layers"]
        want = {"flash_fwd": 2 * layers * steps_run,
                "flash_bwd_dq": layers * steps_run,
                "flash_bwd_dkv": layers * steps_run}
        first_losses = dict(side["losses"])
        whole_side = {}
        torch.cuda.empty_cache()
        whole = train.Trainer(
            train_lib_loop(torch, dev, whole_side),
            train_loop_config={"fail": False},
            scaling_config=train.ScalingConfig(num_workers=1)).fit()
        got = {m["step"]: m["loss"] for m in resumed.metrics_history}
        ref = {m["step"]: m["loss"] for m in whole.metrics_history}
        resumed_steps = list(range(TRAIN_LIB_FAIL_STEP, TRAIN_LIB_STEPS))
        rel = {s: abs(got[s] - ref[s]) / abs(ref[s]) for s in resumed_steps
               if s in got and s in ref}
        emit({"phase": "train_lib", "part": "resume",
              "n_layers": layers, "dtype": "bfloat16",
              "remat_policy": "dots", "batch": [TRAIN_LIB_BATCH, TRAIN_SEQ],
              "cut": f"batch [{TRAIN_LIB_BATCH}, {TRAIN_SEQ}], not "
                     f"[{TRAIN_BATCH}, {TRAIN_SEQ}]",
              "steps": TRAIN_LIB_STEPS, "fail_step": TRAIN_LIB_FAIL_STEP,
              "losses_every_attempt": first_losses,
              "losses_resumed": got, "losses_uninterrupted": ref,
              "rel_diff": rel, "bound": TRAIN_LIB_REL,
              "bit_equal": all(got.get(s) == ref.get(s)
                               for s in resumed_steps),
              "resumed_from": resumed.metrics.get("resumed_from"),
              "checkpoint_bytes": side.get("bytes"),
              "save_s": side.get("save_s"), "load_s": side.get("load_s"),
              "fit_seconds": dt, "flash_launches": flash,
              "flash_want": want, "assign_launches": n,
              "device_assigns": assigns, "nvidia_smi": smi})
        problems += [f"resume: {what}" for what, bad in (
            (f"resumed from {resumed.metrics.get('resumed_from')}",
             resumed.metrics.get("resumed_from") != TRAIN_LIB_FAIL_STEP),
            (f"resumed losses {got} vs {ref} beyond {TRAIN_LIB_REL}",
             len(rel) != len(resumed_steps)
             or any(v > TRAIN_LIB_REL for v in rel.values())),
            ("a loss not finite", not all(
                math.isfinite(x) for x in list(got.values())
                + list(ref.values()))),
            (f"flash launches {flash} != {want}", flash != want),
            (f"assign launches {n} != device assigns {assigns}",
             n != assigns), ("no device assign", n == 0)) if bad]
        del resumed, whole
        torch.cuda.empty_cache()

        def shard_loop(config):
            rank = train.get_context().get_world_rank()
            rows = list(train.get_dataset_shard("train").iter_rows())
            with open(os.path.join(config["dir"], f"rank{rank}.json"),
                      "w") as f:
                json.dump(rows, f)
            train.report({"rows": len(rows)})

        t0 = time.perf_counter()
        train.Trainer(shard_loop, train_loop_config={"dir": root},
                      scaling_config=train.ScalingConfig(num_workers=2),
                      datasets={"train": data.range(
                          TRAIN_LIB_ROWS, parallelism=20)}).fit()
        parts = []
        for r in (0, 1):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                parts.append(json.load(f))
        disjoint = not set(parts[0]) & set(parts[1])
        union = sorted(parts[0] + parts[1]) == list(range(TRAIN_LIB_ROWS))
        emit({"phase": "train_lib", "part": "dataset_shards",
              "rows": TRAIN_LIB_ROWS, "per_rank": [len(p) for p in parts],
              "disjoint": disjoint, "union_is_every_row": union,
              "seconds": time.perf_counter() - t0})
        problems += [f"shards: {what}" for what, bad in (
            ("overlap", not disjoint), ("rows missing", not union)) if bad]
    finally:
        ray.shutdown()
        GLOBAL_CONFIG.reset()
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "train_lib", "part": "done",
          "seconds": time.perf_counter() - t_phase, "ok": not problems})
    if problems:
        raise AssertionError(f"train_lib phase: {problems}")
    return n


def moe_layer_check(torch, dev):
    """One MoE layer (moe_ffn_reference) at the main path's shape, f32 with
    TF32 off, on the card and on the CPU from the same seeded tensors: the
    max abs difference of the outputs, the aux terms, and whether the two
    dispatch tensors are identical. Also the card's ms for the layer."""
    import math

    from ray_tpu_torch.ops import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    T, D, Fd, E = MOE_BATCH * (TRAIN_SEQ - 1), TRAIN["d_model"], \
        TRAIN["d_ff"], MOE_EXPERTS
    gen = torch.Generator().manual_seed(2)
    host = {"x": torch.randn(T, D, generator=gen),
            "router": torch.randn(D, E, generator=gen) / math.sqrt(D),
            "w_in": torch.randn(E, D, Fd, generator=gen) / math.sqrt(D),
            "w_out": torch.randn(E, Fd, D, generator=gen) / math.sqrt(Fd)}
    card = {k: v.to(dev) for k, v in host.items()}
    cap = moe.capacity(T, E, MOE_CF)
    args = ("x", "router", "w_in", "w_out")
    y_cpu, aux_cpu = moe.moe_ffn_reference(*(host[k] for k in args), MOE_CF)
    d_cpu = moe.top1_dispatch(host["x"] @ host["router"], cap)[0]
    y_gpu, aux_gpu = moe.moe_ffn_reference(*(card[k] for k in args), MOE_CF)
    d_gpu = moe.top1_dispatch(card["x"] @ card["router"], cap)[0]
    same_dispatch = bool(torch.equal(d_gpu.cpu(), d_cpu))
    err = float((y_gpu.cpu() - y_cpu).abs().max())
    kept = float(d_cpu.sum())
    del d_cpu, d_gpu
    ms = cuda_ms(torch, lambda _i: moe.moe_ffn_reference(
        *(card[k] for k in args), MOE_CF), 3)
    return {"tokens": T, "capacity": cap, "max_abs_err": err,
            "bound": MOE_LAYER_TOL, "aux_cpu": float(aux_cpu),
            "aux_card": float(aux_gpu), "dispatch_identical": same_dispatch,
            "dropped_share": 1.0 - kept / T, "card_ms_f32": ms}


def moe_dropped_shares(torch, model, tokens):
    """The share of tokens each MoE layer drops in a no-grad forward of
    ``tokens``: 1 - the layer's dispatch sum / T, its routing rebuilt by
    ``top1_dispatch`` from the layer's input in a forward hook."""
    from ray_tpu_torch.ops import moe

    cfg = model.cfg
    shares = []

    def hook(layer, inputs, _output):
        x = inputs[0]
        flat = x.reshape(-1, x.shape[-1]).to(cfg.dtype)
        cap = moe.capacity(flat.shape[0], cfg.moe_num_experts,
                           cfg.moe_capacity_factor)
        dispatch = moe.top1_dispatch(flat @ layer.router.to(cfg.dtype),
                                     cap)[0]
        shares.append(1.0 - float(dispatch.sum()) / flat.shape[0])

    handles = [getattr(model, f"layer_{i}").MoEMLP_0.register_forward_hook(
        hook) for i in range(cfg.n_layers)]
    try:
        with torch.no_grad():
            model(tokens)
    finally:
        for h in handles:
            h.remove()
    return shares


def phase_moe(torch, dev):
    """The Switch MoE at the flagship's width on the card (see MOE_*),
    through make_optimizer / make_train_step: one MoE layer on the card
    against the CPU; a warm step; a no-grad forward on the next step's
    params and batch (cross-entropy and each layer's aux term, the dropped
    shares); the flash counters zeroed; MOE_STEPS timed steps; one more
    step under torch.profiler. Returns the flash launches of the timed
    steps."""
    import math

    from ray_tpu_torch.models import train_step as ts
    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  cross_entropy_loss,
                                                  init_params, param_count)

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    layer = moe_layer_check(torch, dev)
    emit({"phase": "moe", "part": "layer", **layer, "nvidia_smi": smi})
    problems = [f"layer: {what}" for what, bad in (
        (f"max abs err {layer['max_abs_err']} > {MOE_LAYER_TOL}",
         not layer["max_abs_err"] <= MOE_LAYER_TOL),
        ("dispatch differs from the CPU's", not layer["dispatch_identical"]),
        ("aux differs", abs(layer["aux_cpu"] - layer["aux_card"]) > 1e-6))
        if bad]
    torch.cuda.empty_cache()

    kernels = _flash_kernels()
    cfg = TransformerConfig(
        dtype=torch.bfloat16, max_seq_len=TRAIN_SEQ, remat=True,
        remat_policy="dots", moe=True, moe_num_experts=MOE_EXPERTS,
        moe_capacity_factor=MOE_CF, **TRAIN)
    gen = torch.Generator(device=dev)
    params = init_params(cfg, gen.manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (MOE_BATCH, TRAIN_SEQ),
                           generator=gen.manual_seed(1), device=dev)
    n_params = param_count(params)
    model = Transformer(cfg, device=dev).load_params(params)
    del params
    step = ts.make_train_step(model, ts.make_optimizer(model.parameters()))
    batch = {"tokens": tokens}
    for _ in range(MOE_WARMUP):
        step(batch)
    # the first timed step's loss from its own params and batch, no grad
    with torch.no_grad():
        logits, aux = model(tokens[:, :-1], return_aux=True)
        ce = float(cross_entropy_loss(logits, tokens[:, 1:]))
        aux_means = [float(a.mean()) for a in aux]
        del logits, aux
    dropped = moe_dropped_shares(torch, model, tokens[:, :-1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0                    # the main path, from zero
    t0 = time.perf_counter()
    metrics = [step(batch) for _ in range(MOE_STEPS)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / MOE_STEPS
    launches = {n: k.launches for n, k in kernels.items()}
    peak_mem = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    grad_norms = [float(m["grad_norm"]) for m in metrics]
    breakdown = profile_call(torch, lambda: step(batch))
    layers = TRAIN["n_layers"]
    want = {"flash_fwd": 2 * layers * MOE_STEPS,
            "flash_bwd_dq": layers * MOE_STEPS,
            "flash_bwd_dkv": layers * MOE_STEPS}
    expected = ce + 0.01 * sum(aux_means)
    aux_rel = abs(losses[0] - expected) / abs(expected)
    n_tokens = MOE_BATCH * (TRAIN_SEQ - 1)
    emit({"phase": "moe", "part": "train",
          "device": torch.cuda.get_device_name(dev), "n_params": n_params,
          "experts": MOE_EXPERTS, "capacity_factor": MOE_CF,
          "batch": [MOE_BATCH, TRAIN_SEQ],
          "cut": f"batch [{MOE_BATCH}, {TRAIN_SEQ}], not [{TRAIN_BATCH}, "
                 f"{TRAIN_SEQ}]: dispatch and combine grow as T^2",
          "dtype": "bfloat16", "remat_policy": "dots",
          "step_ms": dt * 1e3, "tokens_per_sec": n_tokens / dt,
          "peak_mem_bytes": peak_mem, "losses": losses,
          "grad_norms": grad_norms, "ce_first": ce, "aux_first": aux_means,
          "loss_vs_ce_plus_aux_rel": aux_rel, "aux_bound": MOE_AUX_REL,
          "dropped_share_by_layer": dropped, "launches": launches,
          "launches_want": want, "steps": MOE_STEPS,
          "device_busy_share": breakdown["device_busy_us"] / (dt * 1e6),
          "profile": breakdown, "nvidia_smi": smi})
    problems += [what for what, bad in (
        (f"flash launches {launches} != {want}", launches != want),
        (f"non-finite loss or grad norm {losses} {grad_norms}",
         not all(math.isfinite(x) for x in losses + grad_norms)),
        (f"loss did not fall: {losses}", not losses[-1] < losses[0]),
        (f"loss {losses[0]} != ce + 0.01 x aux {expected} (rel {aux_rel})",
         not aux_rel <= MOE_AUX_REL),
        (f"{len(aux_means)} aux terms for {layers} layers",
         len(aux_means) != layers)) if bad]
    del model, step, metrics
    torch.cuda.empty_cache()
    emit({"phase": "moe", "part": "done", "ok": not problems,
          "seconds": time.perf_counter() - t_phase})
    if problems:
        raise AssertionError(f"moe phase: {problems}")
    return launches


def phase_dag(torch, dev):
    """The compiled DAG around the serve-127M forward on the card (see
    DAG_*): preprocess -> forward -> postprocess (argmax), its outputs the
    next tokens and the logits (a MultiOutputNode). Interpreted
    (dag.execute, one task a node), compiled direct (fuse_jit "never") and
    compiled fused (a CUDA-graph replay): the fused outputs against the
    direct path's, flash_fwd's counter per execute (8 interpreted or
    direct, 16 for the fused path's first execute, 0 a replay), ms per
    execute for each; a diamond through the model runs it once; an actor
    holding the model takes the direct path under "auto"; a node that
    syncs the host raises DAGCaptureError naming it. Returns flash_fwd's
    launches over the phase's executes."""
    import ray_tpu_torch as ray
    from ray_tpu_torch import dag
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  init_params)
    from ray_tpu_torch.ops import flash

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    fwd_kernel = flash.flash_fwd
    layers = SERVE["n_layers"]
    cfg = TransformerConfig(dtype=torch.bfloat16, **SERVE)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    model = Transformer(cfg, device=dev).load_params(params)
    tokens = torch.randint(0, 1 << 20, (DAG_BATCH, DAG_SEQ), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1))
    problems, rows = [], {}

    @ray.remote
    def preprocess(t):
        return t.remainder(cfg.vocab_size)

    @ray.remote
    def forward(t):
        with torch.no_grad():
            return model(t)

    @ray.remote
    def postprocess(logits):
        return logits.argmax(-1)

    @ray.remote
    def halve(x):
        return x * 0.5

    @ray.remote
    def add(a, b):
        return a + b

    @ray.remote
    class Holder:
        def __init__(self, p):
            self.model = Transformer(cfg, device=dev).load_params(p)

        def forward(self, t):
            with torch.no_grad():
                return self.model(t)

    def count(fn):
        before = fwd_kernel.launches
        out = fn()
        torch.cuda.synchronize()
        return out, fwd_kernel.launches - before

    def timed(fn):
        t0 = time.perf_counter()
        for _ in range(DAG_REPEATS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / DAG_REPEATS * 1e3

    ray.init(num_workers=4, scheduler="tensor",
             _system_config={"sched_device": dev.type})
    try:
        fwd_kernel.launches = 0              # the main path, from zero
        with dag.InputNode() as inp:
            logits = forward.bind(preprocess.bind(inp))
            graph = dag.MultiOutputNode([postprocess.bind(logits), logits])
        direct = graph.experimental_compile(fuse_jit="never")
        fused = graph.experimental_compile()
        if direct.fuses((tokens,)) or not fused.fuses((tokens,)):
            problems.append("fuse decision")
        want, n_direct = count(lambda: direct.execute(tokens))
        got_i, n_interp = count(lambda: graph.execute(tokens))
        got_f, n_first = count(lambda: fused.execute(tokens))
        got_r, n_replay = count(lambda: fused.execute(tokens))
        diff = {way: _logit_diff(torch, out[1], want[1])
                for way, out in (("interpreted", got_i),
                                 ("fused_first", got_f),
                                 ("fused_replay", got_r))}
        same_tokens = {way: bool(torch.equal(out[0], want[0]))
                       for way, out in (("interpreted", got_i),
                                        ("fused_first", got_f),
                                        ("fused_replay", got_r))}
        del got_i, got_f, got_r
        ms = {"interpreted": timed(lambda: graph.execute(tokens)),
              "direct": timed(lambda: direct.execute(tokens)),
              "fused": timed(lambda: fused.execute(tokens))}
        replays, n_timed = count(lambda: [fused.execute(tokens)
                                          for _ in range(DAG_REPEATS)])
        rows["chain"] = {
            "flash_fwd_launches": {"direct": n_direct,
                                   "interpreted": n_interp,
                                   "fused_first": n_first,
                                   "fused_replay": n_replay,
                                   f"fused_{DAG_REPEATS}_replays": n_timed},
            "same_tokens": same_tokens,
            "logits_rel_l2": {k: v["rel_l2"] for k, v in diff.items()},
            "ms_per_execute": ms, "graphs": len(fused._graphs)}
        problems += [f"chain: {what}" for what, bad in (
            (f"launches direct {n_direct}, interpreted {n_interp} != "
             f"{layers}", n_direct != layers or n_interp != layers),
            (f"fused first execute {n_first} != {2 * layers}",
             n_first != 2 * layers),
            (f"replays launched {n_replay} + {n_timed}",
             n_replay or n_timed),
            (f"tokens differ {same_tokens}", not all(same_tokens.values())),
            (f"logits rel L2 {diff}",
             any(v["rel_l2"] > DAG_REL_L2 for v in diff.values()))) if bad]
        del replays, want

        with dag.InputNode() as inp:
            shared = forward.bind(preprocess.bind(inp))
            diamond = add.bind(halve.bind(shared), halve.bind(shared))
        d_out, n_diamond = count(lambda: diamond.execute(tokens))
        d_direct, n_diamond_direct = count(
            lambda: diamond.experimental_compile("never").execute(tokens))
        rows["diamond"] = {"flash_fwd_launches": {
            "interpreted": n_diamond, "direct": n_diamond_direct},
            "equal": bool(torch.equal(d_out, d_direct))}
        problems += [f"diamond: {what}" for what, bad in (
            (f"shared node ran {n_diamond} / {n_diamond_direct} launches",
             n_diamond != layers or n_diamond_direct != layers),
            ("outputs differ", not rows["diamond"]["equal"])) if bad]
        del d_out, d_direct

        holder = Holder.remote(params)
        with dag.InputNode() as inp:
            actor_graph = postprocess.bind(holder.forward.bind(
                preprocess.bind(inp)))
        compiled = actor_graph.experimental_compile()
        a_out, n_actor = count(lambda: compiled.execute(tokens))
        f_out = fused.execute(tokens)[0]
        rows["actor"] = {"fuses": compiled.fuses((tokens,)),
                         "flash_fwd_launches": n_actor,
                         "same_tokens": bool(torch.equal(a_out, f_out))}
        problems += [f"actor: {what}" for what, bad in (
            ("fused", rows["actor"]["fuses"]),
            (f"{n_actor} launches", n_actor != layers),
            ("tokens differ", not rows["actor"]["same_tokens"])) if bad]
        ray.kill(holder)

        @ray.remote
        def syncs_the_host(x):
            return x * float(x.sum())

        with dag.InputNode() as inp:
            bad_graph = syncs_the_host.bind(inp)
        try:
            bad_graph.experimental_compile().execute(tokens.float())
            raised = None
        except dag.DAGCaptureError as e:
            raised = str(e)
        rows["capture_error"] = {"raised": raised}
        if raised is None or "syncs_the_host" not in raised:
            problems.append(f"capture error: {raised!r}")
        total = fwd_kernel.launches
    finally:
        ray.shutdown()
        GLOBAL_CONFIG.reset()
    emit({"phase": "dag", **rows, "model": "serve-127M", "dtype": "bfloat16",
          "tokens": [DAG_BATCH, DAG_SEQ], "repeats": DAG_REPEATS,
          "flash_fwd_launches_total": total, "nvidia_smi": smi,
          "seconds": time.perf_counter() - t_phase, "ok": not problems})
    if problems:
        raise AssertionError(f"dag phase: {problems}")
    return total


def tune_trainable(torch, dev, log):
    """A Tune trainable for phase tune: the TUNE_MODEL model on ``dev``
    from config["seed"], AdamW at config["lr"], TUNE_STEPS steps on a
    fixed batch, each reported with its loss; with config["ckpt"] each
    report carries a checkpoint (clones of the model's and AdamW's
    tensors, on the card). A trial started from a checkpoint loads it
    and records whether its state then equals the checkpoint bit for bit.
    Every step and every placement goes into ``log``."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.models import train_step as ts
    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  init_params)

    from torch.utils import _pytree as pytree

    cfg = TransformerConfig(dtype=torch.bfloat16, **TUNE_MODEL)

    def clone(tree):
        return pytree.tree_map_only(torch.Tensor,
                                    lambda t: t.detach().clone(), tree)

    def leaves(tree):
        return [x for x in pytree.tree_leaves(tree)
                if isinstance(x, torch.Tensor)]

    def trainable(config):
        gen = torch.Generator(device=dev).manual_seed(config["seed"])
        model = Transformer(cfg, device=dev).load_params(
            init_params(cfg, gen))
        opt = ts.make_optimizer(model.parameters(),
                                learning_rate=config["lr"])
        step = ts.make_train_step(model, opt)
        tokens = torch.randint(0, cfg.vocab_size, (TUNE_BATCH, TUNE_SEQ + 1),
                               generator=gen, device=dev)
        done, ckpt = 0, tune.get_checkpoint()
        if ckpt is not None:
            model.load_state_dict(ckpt["model"])
            opt.load_state_dict(clone(ckpt["optim"]))
            for group in opt.param_groups:
                group["lr"] = config["lr"]
            done = ckpt["step"]
            now = {"model": model.state_dict(), "optim": opt.state_dict()}
            pairs = list(zip(leaves(now), leaves({k: ckpt[k] for k in now})))
            # AdamW keeps its step counts as 0-dim CPU tensors; every
            # other tensor of the checkpoint lies on the card
            log["restored"].append({
                "equal": len(pairs) > 0 and all(
                    a.shape == b.shape and bool(torch.equal(a, b))
                    for a, b in pairs),
                "tensors": len(pairs), "from_step": done,
                "on_cuda": all(b.is_cuda for _, b in pairs if b.dim()),
                "cpu_step_counts": sum(not b.is_cuda for _, b in pairs)})
        log["placed"].append(all(p.is_cuda for p in model.parameters())
                             and tokens.is_cuda)
        for s in range(done, done + TUNE_STEPS):
            loss = float(step({"tokens": tokens})["loss"])
            log["steps"].append(1)
            report = {"loss": loss, "step": s + 1}
            if config.get("ckpt"):
                tune.report(report, checkpoint=clone({
                    "model": model.state_dict(), "optim": opt.state_dict(),
                    "step": s + 1}))
            else:
                tune.report(report)

    return trainable


def phase_tune(torch, dev):
    """Tune sweeps whose trials train on the card (see TUNE_*), on the
    runtime (8 workers, the TensorScheduler assigning on the card): ASHA
    over lr x seed, PBT with CUDA checkpoints, and Tuner.restore of a
    sweep that lost its last two trials' results. The flash counters are
    zeroed just before the sweeps and read just after: each kernel once a
    layer a step, over every step the trials ran. Returns the launches."""
    import os
    import tempfile

    import ray_tpu_torch as ray
    from ray_tpu_torch import tune
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    kernels = _flash_kernels()
    log = {"steps": [], "placed": [], "restored": []}
    trainable = tune_trainable(torch, dev, log)
    root = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    problems, rows = [], {}
    ray.init(num_workers=8, scheduler="tensor",
             _system_config={"sched_device": dev.type})
    try:
        for kern in kernels.values():
            kern.launches = 0                # the main path, from zero
        t0 = time.perf_counter()
        asha = tune.Tuner(
            trainable,
            param_space={"lr": tune.grid_search(list(TUNE_LRS)),
                         "seed": tune.grid_search([0, 1])},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", max_concurrent_trials=4,
                scheduler=tune.ASHAScheduler(
                    metric="loss", mode="min", max_t=TUNE_STEPS,
                    grace_period=2, reduction_factor=2))).fit()
        best = asha.get_best_result("loss", "min")
        rows["asha"] = {"trials": len(asha),
                        "stopped": sum(r.terminated_early for r in asha),
                        "best_config": best.config,
                        "best_loss": best.metrics["loss"],
                        "seconds": time.perf_counter() - t0}

        t0 = time.perf_counter()
        pbt_sched = tune.PopulationBasedTraining(
            metric="loss", mode="min", perturbation_interval=3,
            hyperparam_mutations={"lr": tune.uniform(1e-4, 3e-3)},
            quantile_fraction=0.34, seed=0)
        pbt = tune.Tuner(
            trainable,
            param_space={"lr": tune.grid_search(list(TUNE_LRS)),
                         "seed": 0, "ckpt": True},
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        scheduler=pbt_sched,
                                        max_concurrent_trials=4)).fit()
        rows["pbt"] = {"trials": len(pbt),
                       "perturbations": pbt_sched.num_perturbations,
                       "restored": list(log["restored"]),
                       "best_loss": pbt.get_best_result(
                           "loss", "min").metrics["loss"],
                       "seconds": time.perf_counter() - t0}

        t0 = time.perf_counter()
        storage = os.path.join(root, "restore")
        space = {"lr": tune.grid_search(list(TUNE_LRS)), "seed": 2}
        first = tune.Tuner(trainable, param_space=space,
                           tune_config=tune.TuneConfig(
                               metric="loss", mode="min",
                               max_concurrent_trials=2),
                           storage_path=storage).fit()
        runs_first = len(log["placed"])
        # the sweep's directory as a crash after its first two trials
        # leaves it: the last two trials' results never written
        for tid in (2, 3):
            os.remove(os.path.join(storage, f"trial_{tid}.pkl"))
        again = tune.Tuner.restore(storage, trainable).fit()
        reran = len(log["placed"]) - runs_first
        kept = all(again[i].metrics == first[i].metrics for i in (0, 1))
        rows["restore"] = {"trials": len(again), "reran": reran,
                           "kept_first_results": kept,
                           "seconds": time.perf_counter() - t0}
        dt = time.perf_counter() - t_phase
        launches = {n: k.launches for n, k in kernels.items()}
        steps = len(log["steps"])
        layers = TUNE_MODEL["n_layers"]
        want = {n: layers * steps for n in kernels}
    finally:
        ray.shutdown()
        GLOBAL_CONFIG.reset()
        shutil.rmtree(root, ignore_errors=True)
    problems += [what for what, bad in (
        ("a trial's tensors off the card", not all(log["placed"])),
        ("ASHA stopped no trial", rows["asha"]["stopped"] == 0),
        ("PBT exploited no trial", not log["restored"]),
        (f"an exploited trial's state differs from its donor's checkpoint "
         f"{log['restored']}", not all(r["equal"] and r["on_cuda"]
                                       for r in log["restored"])),
        (f"restore re-ran {reran} trials, not 2", reran != 2),
        ("restore changed a completed trial's result", not kept),
        (f"flash launches {launches} != {want}", launches != want)) if bad]
    emit({"phase": "tune", **rows, "model": TUNE_MODEL, "dtype": "bfloat16",
          "steps_run": steps, "trial_runs": len(log["placed"]),
          "launches": launches, "launches_want": want,
          "sweep_seconds": dt, "nvidia_smi": smi, "problems": problems,
          "ok": not problems})
    if problems:
        raise AssertionError(f"tune phase: {problems}")
    return launches


def phase_workflow(torch, dev):
    """A workflow whose steps run on the card (WORKFLOW_N x WORKFLOW_N
    f32), interrupted at a gated step and resumed: no journaled step runs
    again, the result on the card and equal to the same work done
    directly. Then QUEUE_ITEMS CUDA tensors from a producer task to a
    consumer task through a util.queue.Queue, every item in order and
    equal; items/s."""
    import os
    import tempfile

    import ray_tpu_torch as ray
    from ray_tpu_torch import workflow
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch.util.queue import Queue

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    root = tempfile.mkdtemp(prefix="chip_smoke_workflow_")
    gate = os.path.join(root, "gate")
    ran_log = os.path.join(root, "ran.log")
    problems = []

    def ran(name):
        # a file, not a closure: resume() runs steps unpickled from the
        # journal, with copies of whatever they close over
        with open(ran_log, "a") as f:
            f.write(name + "\n")

    def runs():
        with open(ran_log) as f:
            names = f.read().split()
        return {n: names.count(n) for n in sorted(set(names))}

    @workflow.step
    def make(seed):
        ran("make")
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(WORKFLOW_N, WORKFLOW_N, device=dev, generator=g)

    @workflow.step
    def square(a):
        ran("square")
        return (a @ a) / WORKFLOW_N

    @workflow.step
    def gated(a, path):
        ran("gated")
        if not os.path.exists(path):
            raise RuntimeError("gate closed")
        return a + torch.tanh(a)

    @workflow.step
    def scale(a):
        ran("scale")
        return a * 0.5

    ray.init(num_workers=4, scheduler="tensor",
             _system_config={"sched_device": dev.type})
    try:
        node = scale.step(gated.step(square.step(make.step(0)), gate))
        t0 = time.perf_counter()
        try:
            node.run("wf_card", root)
            failed = False
        except Exception:  # noqa: BLE001 - the interruption under test
            failed = True
        before = runs()
        open(gate, "w").close()
        out = workflow.resume("wf_card", storage=root)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wf_s = time.perf_counter() - t0
        now = runs()
        after = {k: now[k] - before.get(k, 0) for k in now}
        g = torch.Generator(device=dev).manual_seed(0)
        a = torch.randn(WORKFLOW_N, WORKFLOW_N, device=dev, generator=g)
        a = (a @ a) / WORKFLOW_N
        want = (a + torch.tanh(a)) * 0.5
        status = workflow.get_status("wf_card", root)
        steps = workflow.list_steps("wf_card", root)
        row = {"interrupted": failed, "runs_first": before,
               "runs_on_resume": after, "status": status["status"],
               "cached_steps": status.get("cached_steps"),
               "journaled_steps": steps, "on_cuda": out.is_cuda,
               "equal_direct": bool(torch.equal(out, want)),
               "seconds": wf_s}
        problems += [f"workflow: {what}" for what, bad in (
            ("not interrupted", not failed),
            (f"first run {before}",
             before != {"make": 1, "square": 1, "gated": 1}),
            (f"resume ran {after}, not only the unjournaled steps",
             after != {"make": 0, "square": 0, "gated": 1, "scale": 1}),
            ("result off the card", not out.is_cuda),
            ("result differs from the direct computation",
             not row["equal_direct"]),
            (f"status {status}", status["status"] != "SUCCEEDED")) if bad]

        @ray.remote
        def producer(q, n):
            for i in range(n):
                q.put(torch.full(QUEUE_SHAPE, float(i), device=dev))
            return n

        @ray.remote
        def consumer(q, n):
            got = [q.get(timeout=60) for _ in range(n)]
            return ([int(t[0, 0]) for t in got],
                    all(t.is_cuda and bool((t == t[0, 0]).all())
                        for t in got))

        q = Queue(maxsize=64)
        t0 = time.perf_counter()
        got_ref = consumer.remote(q, QUEUE_ITEMS)
        sent = ray.get(producer.remote(q, QUEUE_ITEMS), timeout=300)
        order, whole = ray.get(got_ref, timeout=300)
        q_s = time.perf_counter() - t0
        q.shutdown()
        qrow = {"items": sent, "in_order": order == list(range(QUEUE_ITEMS)),
                "items_whole_on_cuda": whole, "seconds": q_s,
                "items_per_sec": QUEUE_ITEMS / q_s,
                "item_shape": list(QUEUE_SHAPE)}
        problems += [f"queue: {what}" for what, bad in (
            ("out of order", not qrow["in_order"]),
            ("an item changed or left the card", not whole)) if bad]
    finally:
        ray.shutdown()
        GLOBAL_CONFIG.reset()
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "workflow", "workflow": row, "queue": qrow,
          "nvidia_smi": smi, "seconds": time.perf_counter() - t_phase,
          "ok": not problems})
    if problems:
        raise AssertionError(f"workflow phase: {problems}")


def mapped_libs(pid):
    """Basenames of the shared objects process pid maps."""
    with open(f"/proc/{pid}/maps") as f:
        return sorted({line.split()[-1].rsplit("/", 1)[-1] for line in f
                       if "/" in line.split()[-1]})


def daemon_modules():
    """The modules a node daemon's import path loads, of torch and
    REF_MODULES: a fresh interpreter imports the daemon's module as
    ``python -m`` does."""
    code = ("import sys, ray_tpu_torch._private.runtime.node_daemon; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch',) + " + repr(REF_MODULES) + "))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(Path(__file__).resolve().parent))
    if out.returncode != 0:
        raise AssertionError(f"daemon import probe failed: {out.stderr}")
    return json.loads(out.stdout.strip().replace("'", '"'))


def mark_leaf(key, path, sleep_s, hold_pids=(), hold_s=120.0):
    """Sleep, then append key to the marks file (O_APPEND: atomic for a
    short write): a killed attempt leaves no mark, so the file counts
    completions. Returns key's sha256.

    An attempt in a process of ``hold_pids`` (the workers of a machine
    about to be killed) waits hold_s more before its mark, so the kill
    lands while it sleeps, as in the reference's node-loss drill. An
    attempt that marked just before the machine died could lose its
    completion with the machine, and the rerun elsewhere would mark
    again: at-least-once, which a count of marks cannot tell from a
    task the head ran twice."""
    import hashlib
    import os

    time.sleep(sleep_s)
    if os.getpid() in hold_pids:
        time.sleep(hold_s)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    try:
        os.write(fd, (key + "\n").encode())
    finally:
        os.close(fd)
    return hashlib.sha256(key.encode()).hexdigest()


def read_marks(path):
    try:
        with open(path) as f:
            return f.read().split()
    except FileNotFoundError:
        return []


def client_forward(serve, batch, seq, seed, device="cuda"):
    """serve-127M's forward (bf16, params from the seeded generator on
    the card) on seeded tokens [batch, seq]: the argmax tokens, on the
    host. The client's task runs this on the head; the driver runs it
    directly for the tokens to compare."""
    import torch

    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  init_params)

    cfg = TransformerConfig(dtype=torch.bfloat16, **serve)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    model = Transformer(cfg, device=device).load_params(params)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(seed))
    with torch.no_grad():
        logits = model(tokens)
    out = logits.argmax(-1).int().cpu().numpy()
    del model, params, logits
    return out


# the ray:// client process (phase multinode): argv[1] the connect string,
# argv[2] JSON {put_bytes, tasks, serve, batch, seq, seed}; prints one JSON
# line. It sees no card (CUDA_VISIBLE_DEVICES=""); the forward runs on the
# head as a task pinned to the head's resource
CLIENT_SRC = r'''
import json, sys, time
import numpy as np
import ray_tpu_torch as ray

address, p = sys.argv[1], json.loads(sys.argv[2])
t0 = time.perf_counter()
ray.init(address=address)
out = {"connect_s": time.perf_counter() - t0}
data = np.random.default_rng(0).integers(0, 255, p["put_bytes"],
                                         dtype=np.uint8)
t0 = time.perf_counter()
back = ray.get(ray.put(data), timeout=300)
out["put_get_s"] = time.perf_counter() - t0
out["put_get_equal"] = bool(np.array_equal(back, data))


@ray.remote
def inc(x):
    return x + 1


lat, exact = [], True
for i in range(p["tasks"]):
    t0 = time.perf_counter()
    exact &= ray.get(inc.remote(i), timeout=300) == i + 1
    lat.append(time.perf_counter() - t0)
lat.sort()
out.update(tasks=p["tasks"], tasks_exact=bool(exact),
           task_p50_ms=lat[len(lat) // 2] * 1e3,
           task_p99_ms=lat[int(len(lat) * 0.99)] * 1e3)


@ray.remote
class Named:
    def __init__(self):
        self.n = 0

    def bump(self):
        self.n += 1
        return self.n


a = Named.options(name="mn_client_named").remote()
ray.get(a.bump.remote(), timeout=300)
out["named_actor"] = ray.get(ray.get_actor("mn_client_named").bump.remote(),
                             timeout=300)
ray.kill(a)
forward = ray.remote(FORWARD).options(num_gpus=p["gpus"],
                                     resources={"mn_head": 1.0})
t0 = time.perf_counter()
tokens = ray.get(forward.remote(p["serve"], p["batch"], p["seq"], p["seed"],
                                p["device"]), timeout=600)
out["forward_s"] = time.perf_counter() - t0
out["tokens"] = np.asarray(tokens).tolist()
import torch

out["modules"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "flax", "ray_tpu"))
out["cuda"] = bool(torch.cuda.is_initialized() or torch.cuda.device_count())
ray.shutdown()
print(json.dumps(out), flush=True)
'''


def client_script():
    """CLIENT_SRC with client_forward's source as its FORWARD (defined in
    the client's __main__, so it travels to the head by value)."""
    import inspect

    return (inspect.getsource(client_forward)
            + "\n\nFORWARD = client_forward\n" + CLIENT_SRC)


def phase_multinode(torch, dev):
    """The multi-node plane and the ray:// client (see MN_*): a Cluster
    whose thread-mode head runs the TensorScheduler on ``dev``
    (sched_backend "cuda", worker_gpu_access) and three remote nodes
    through Cluster.add_node(remote=True), each a node daemon with its
    own arena over TCP: two CPU nodes and one GPU node.

    - start-up: each daemon's registration seconds; no daemon maps torch,
      jax or a CUDA library, none adds a CUDA context (nvidia-smi's
      rows), and the daemon's import path loads none of torch, jax,
      flax, ray_tpu.
    - fanout: MN_FANOUT small tasks: exact, a share on remote rows > 0;
      tasks/s.
    - two_level: nested submissions from tasks on a CPU node: the
      head-skip share (node-local admissions over them and the spills)
      >= MN_HEAD_SKIP_BOUND, exact.
    - objects: a 64 MiB array made on node A: the head holds a
      placeholder and no bytes crossed; a task on B reads it through a
      peer pull, equal; the head's get equal; once the ref dies both
      arenas' bytes come back; GB/s node to node and node to head.
    - locality: consumers of objects on B, scheduler_locality on then
      off: on, every consumer on B and fewer bytes pulled; sums equal;
      locality_host_assigns > 0 and equal to the ticks whose snapshot
      carried a locality matrix.
    - p2p: MN_P2P_CALLS calls from a task on A to an actor on B: order
      exact, >= 90% peer-to-peer, no head fallback; calls/s.
    - gpu_node: the serve-127M engine actor (num_gpus=1) on the GPU node:
      tokens equal a direct engine's on the head, kernel 1's launches in
      its process = 8 x its decode steps > 0, nvidia-smi shows its
      process, after ray.kill the process gone and the card's memory
      back; tokens/s.
    - machine_death: node A's daemon tree SIGKILLed under MN_DEATH_TASKS
      tasks with retries, the victim's attempts held before their marks:
      DEAD within the health check's budget, every result exact and
      marked once (the marks file), a sole-copy object
      rebuilt from lineage, every snapshot after the death equal to
      assign_np with no task on the dead row; seconds.
    - link_flap: a chaos node flap of B under load: exactly once, B
      ALIVE again; seconds.
    - client: enable_head_endpoint, a client process (no card) that
      connects through ray://: put/get 16 MiB, round trips, a named
      actor, serve-127M's forward on the head's card with argmax equal
      to the driver's and flash_fwd 8 launches; no jax or card in it.
    - shutdown: no daemon or worker process alive, the card's memory
      back.
    In every part kernels.assign's counter is zeroed just before and read
    just after: equal to the scheduler's device assigns; every snapshot
    equals assign_np. Returns {"assign": launches over the parts,
    "engine_actor": kernel 1 in the actor, "client_forward": flash_fwd}."""
    import gc
    import tempfile

    import numpy as np

    import ray_tpu_torch as ray
    from ray_tpu_torch import chaos
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.runtime.process_pool import RemotePlaceholder
    from ray_tpu_torch._private.scheduler import kernels as sk
    from ray_tpu_torch._private.scheduler.tensor import TensorScheduler
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.models.inference import InferenceConfig
    from ray_tpu_torch.ops import flash
    from ray_tpu_torch.util import NodeAffinitySchedulingStrategy

    smi = nvidia_smi()
    t_phase = time.perf_counter()
    system = {"sched_backend": "cuda", "sched_device": dev.type,
              "worker_gpu_access": True,
              # node death here is the daemon link's EOF; a long heartbeat
              # budget only keeps a busy host from false deaths
              "node_heartbeat_timeout_s": 20.0,
              "health_check_timeout_s": 5.0}
    problems, pids, total = [], set(), [0]
    out = {"engine_actor": 0, "client_forward": 0}
    rec = AssignRecorder(torch, TensorScheduler, sk, GLOBAL_CONFIG)
    marks_dir = tempfile.mkdtemp(prefix="chip_smoke_multinode_")

    def part(name, fn):
        """fn() with the counter zeroed just before and read just after,
        every snapshot kept and replayed through assign_np: (fn's result,
        snapshots, counts)."""
        w = ray._worker.get_worker()
        rec.snapshots = []
        st0 = w.scheduler.stats()
        sk.assign.launches = 0
        res = fn()
        n = sk.assign.launches
        st1 = w.scheduler.stats()
        snaps, rec.snapshots = rec.snapshots, None
        total[0] += n
        assigns = st1["device_assigns"] - st0["device_assigns"]
        counts = {"assign_launches": n, "device_assigns": assigns,
                  "locality_host_assigns": st1["locality_host_assigns"]
                  - st0["locality_host_assigns"],
                  "snapshots": len(snaps),
                  "snapshots_with_locality": sum(
                      s[0][7] is not None for s in snaps),
                  "snapshots_differ": replay_oracle(
                      sk, snaps, GLOBAL_CONFIG.sched_hybrid_threshold)}
        problems.extend(f"{name}: {what}" for what, bad in (
            (f"assign launches {n} != device assigns {assigns}",
             n != assigns),
            (f"{counts['snapshots_differ']} snapshots differ from "
             "assign_np", counts["snapshots_differ"])) if bad)
        return res, snaps, counts

    def two_level_delta(before):
        now = ray._worker.get_worker().two_level_stats
        return {k: now.get(k, 0) - before.get(k, 0)
                for k in ("local_dispatch", "spillback", "p2p",
                          "head_fallback", "local_retry", "node_deaths",
                          "orphan_retried")}

    # this process's own card work first (the direct engine, the driver's
    # forward), so the baseline holds its context and libraries and the
    # release check sees only what the cluster's processes leave
    engine_want = direct_engine_tokens(torch, dev)
    client_want = client_forward(SERVE, CLIENT_BATCH, CLIENT_SEQ,
                                 CLIENT_SEED, dev.type).tolist()
    release_card(torch, dev)
    rows0, used0 = card_state()
    cluster, daemons = None, {}
    try:
        cluster = Cluster(initialize_head=True, head_node_args=dict(
            MN_HEAD, _system_config=system))
        w = ray._worker.get_worker()
        # -- start-up -----------------------------------------------------
        nodes, reg = {}, {}
        for name, args in (("a", MN_CPU_NODE), ("b", MN_CPU_NODE),
                           ("gpu", MN_GPU_NODE)):
            t0 = time.perf_counter()
            nodes[name] = cluster.add_node(
                remote=True, resources={f"mn_{name}": 100.0, "mn_r": 100.0},
                **args)
            reg[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for node in nodes.values():
            wait_workers_ready(node._entry.pool)
            pids.update(node.worker_pids())
        ready_s = time.perf_counter() - t0
        daemons = {n: node._entry.pool._daemon_proc.pid
                   for n, node in nodes.items()}
        rows1, _used1 = card_state()
        banned = {n: [lib for lib in mapped_libs(pid)
                      if any(b in lib for b in DAEMON_BANNED_LIBS)]
                  for n, pid in daemons.items()}
        mods = daemon_modules()
        ctx = {n: any(p == pid for p, _ in rows1)
               for n, pid in daemons.items()}
        emit({"phase": "multinode", "part": "startup",
              "registration_seconds": reg, "workers_ready_seconds": ready_s,
              "daemon_pids": daemons, "worker_pids": len(pids),
              "daemon_banned_libraries": banned,
              "daemon_import_modules": mods,
              "compute_apps_before": rows0, "compute_apps_after": rows1,
              "daemon_in_compute_apps": ctx, "nvidia_smi": smi})
        problems += [f"startup: {what}" for what, bad in (
            (f"daemons map {banned}", any(banned.values())),
            (f"a daemon's import path loads {mods}", mods),
            (f"daemons hold a CUDA context: {ctx}, {rows0} -> {rows1}",
             any(ctx.values()) or len(rows1) > len(rows0))) if bad]
        remote_pids = {n: set(node.worker_pids())
                       for n, node in nodes.items()}
        all_remote = set().union(*remote_pids.values())

        # -- fan-out ------------------------------------------------------
        @ray.remote
        def square(i):
            import os
            return i * i, os.getpid()

        def run_fanout():
            t0 = time.perf_counter()
            res = ray.get([square.remote(i) for i in range(MN_FANOUT)],
                          timeout=300)
            return time.perf_counter() - t0, res

        (dt, res), _snaps, counts = part("fanout", run_fanout)
        exact = [r[0] for r in res] == [i * i for i in range(MN_FANOUT)]
        on_remote = sum(r[1] in all_remote for r in res) / MN_FANOUT
        emit({"phase": "multinode", "part": "fanout", "tasks": MN_FANOUT,
              "seconds": dt, "tasks_per_s": MN_FANOUT / dt,
              "remote_share": on_remote, "exact": exact, **counts})
        problems += [f"fanout: {what}" for what, bad in (
            ("results not exact", not exact),
            ("no task ran on a remote row", on_remote == 0),
            ("no device assign", counts["assign_launches"] == 0)) if bad]

        # -- two-level dispatch ------------------------------------------
        @ray.remote(max_retries=0)
        def nested_noop():
            return 1

        @ray.remote  # default task_max_retries: retry-carrying
        def nested_retry():
            return 1

        @ray.remote(max_retries=0)
        def nested_ref(blob):
            return 1 if blob else 0

        @ray.remote(resources={"mn_a": 1.0})
        def submitter(rounds, n):
            import ray_tpu_torch
            # over inline_object_max_bytes: sealed in node A's arena
            data = ray_tpu_torch.put(b"x" * (256 * 1024))
            out = []
            for _ in range(rounds):
                refs = [nested_ref.remote(data) if i % 3 == 2
                        else (nested_noop, nested_retry)[i % 3].remote()
                        for i in range(n)]
                out.append(sum(ray_tpu_torch.get(refs, timeout=300)))
            return out

        def run_two_level():
            before = dict(w.two_level_stats)
            t0 = time.perf_counter()
            got = ray.get(submitter.remote(MN_ROUNDS, MN_NESTED),
                          timeout=600)
            dt = time.perf_counter() - t0
            deadline = time.monotonic() + 30
            want = MN_ROUNDS * MN_NESTED
            while time.monotonic() < deadline:
                d = two_level_delta(before)
                if d["local_dispatch"] + d["spillback"] >= want:
                    break
                time.sleep(0.05)
            return got, dt, two_level_delta(before)

        (got, dt, d), _snaps, counts = part("two_level", run_two_level)
        ld, sb = d["local_dispatch"], d["spillback"]
        skip = ld / (ld + sb) if ld + sb else 0.0
        emit({"phase": "multinode", "part": "two_level",
              "rounds": MN_ROUNDS, "nested": MN_NESTED, "seconds": dt,
              "nested_per_s": MN_ROUNDS * MN_NESTED / dt,
              "head_skip": skip, "two_level": d,
              "spill_reasons": dict(nodes["a"]._entry.pool.spill_reasons),
              "exact": got == [MN_NESTED] * MN_ROUNDS, **counts})
        problems += [f"two_level: {what}" for what, bad in (
            ("results not exact", got != [MN_NESTED] * MN_ROUNDS),
            (f"head-skip share {skip} < {MN_HEAD_SKIP_BOUND}",
             skip < MN_HEAD_SKIP_BOUND)) if bad]

        # -- cross-node objects ------------------------------------------
        n_elem = MN_OBJECT_BYTES // 4

        @ray.remote(resources={"mn_a": 1.0})
        def make_array():
            import numpy as _np
            return _np.arange(n_elem, dtype=_np.float32)

        @ray.remote(resources={"mn_b": 1.0})
        def digest(x):
            import hashlib
            return hashlib.sha256(memoryview(x).cast("B")).hexdigest()

        def run_objects():
            import hashlib

            want = hashlib.sha256(memoryview(
                np.arange(n_elem, dtype=np.float32)).cast("B")).hexdigest()
            relayed0 = dict(w.transfer_stats)
            ref = make_array.remote()
            ray.wait([ref], timeout=300)
            entry = w.memory_store.get_entry(ref.object_id())
            placeholder = isinstance(entry.value, RemotePlaceholder)
            locs = w.gcs.object_locations(ref.object_id())
            crossed = {k: w.transfer_stats[k] - relayed0[k]
                       for k in ("head_relayed_bytes", "bytes_pulled")}
            t0 = time.perf_counter()
            on_b = ray.get(digest.remote(ref), timeout=300)
            n2n_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            val = ray.get(ref, timeout=300)
            n2h_s = time.perf_counter() - t0
            head_equal = hashlib.sha256(memoryview(val).cast(
                "B")).hexdigest() == want
            stats_with = {n: nodes[n]._entry.pool.store_stats()
                          for n in ("a", "b")}
            oid = ref.object_id()
            del ref, val, entry
            gc.collect()
            ray.get(ray.put(0))          # an API entry drains dying refs
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                stats = {n: nodes[n]._entry.pool.store_stats()
                         for n in ("a", "b")}
                if not w.gcs.object_locations(oid) and all(
                        s["used_bytes"] < MN_OBJECT_BYTES
                        for s in stats.values()):
                    break
                time.sleep(0.05)
            return {"placeholder": placeholder, "locations": locs,
                    "crossed_before_read": crossed,
                    "node_to_node_equal": on_b == want,
                    "head_equal": head_equal,
                    "node_to_node_seconds": n2n_s,
                    "node_to_node_gb_per_s": MN_OBJECT_BYTES / n2n_s / 1e9,
                    "node_to_head_seconds": n2h_s,
                    "node_to_head_gb_per_s": MN_OBJECT_BYTES / n2h_s / 1e9,
                    "store_stats_with": stats_with, "store_stats_after": stats,
                    "locations_after": w.gcs.object_locations(oid)}

        row, _snaps, counts = part("objects", run_objects)
        emit({"phase": "multinode", "part": "objects",
              "bytes": MN_OBJECT_BYTES, **row, **counts})
        freed = all(s["used_bytes"] < MN_OBJECT_BYTES
                    for s in row["store_stats_after"].values())
        problems += [f"objects: {what}" for what, bad in (
            ("the head holds no placeholder", not row["placeholder"]),
            (f"locations {row['locations']}",
             row["locations"] != [nodes["a"].index]),
            (f"bytes crossed before a read {row['crossed_before_read']}",
             any(row["crossed_before_read"].values())),
            ("node B's read differs", not row["node_to_node_equal"]),
            ("the head's get differs", not row["head_equal"]),
            (f"arena bytes not back {row['store_stats_after']}",
             not freed or row["locations_after"])) if bad]

        # -- locality -----------------------------------------------------
        n_loc = MN_LOCALITY_BYTES // 8

        @ray.remote(resources={"mn_b": 1.0})
        def produce(i):
            import numpy as _np
            return _np.full(n_loc, float(i))

        @ray.remote(resources={"mn_r": 1.0})
        def consume(x):
            import os
            return float(x[0]) * len(x), os.getpid()

        # the knobs are set on the live head for this part (init froze
        # them) and restored after it, the replay of its snapshots included
        locality_entry = GLOBAL_CONFIG.entry("scheduler_locality")
        depth_entry = GLOBAL_CONFIG.entry("locality_spillback_queue_depth")
        loc_rows = {}
        for on in (True, False):
            def run_locality():
                refs = [produce.remote(i) for i in range(MN_LOCALITY)]
                ray.wait(refs, num_returns=len(refs), timeout=300)
                p0 = w.transfer_stats["bytes_pulled"]
                got = ray.get([consume.remote(r) for r in refs],
                              timeout=300)
                return got, w.transfer_stats["bytes_pulled"] - p0

            locality_entry.value = on
            depth_entry.value = MN_LOCALITY_SPILL_DEPTH
            try:
                (got, pulled), _snaps, counts = part(f"locality_{on}",
                                                     run_locality)
            finally:
                locality_entry.value = locality_entry.default
                depth_entry.value = depth_entry.default
            on_b = sum(pid in remote_pids["b"] for _s, pid in got)
            loc_rows[on] = {"sum": sum(s for s, _pid in got),
                            "bytes_pulled": pulled,
                            "consumers_on_holder": on_b, **counts}
            emit({"phase": "multinode", "part": "locality",
                  "scheduler_locality": on, "consumers": MN_LOCALITY,
                  "arg_bytes": MN_LOCALITY_BYTES, **loc_rows[on]})
        on_row, off_row = loc_rows[True], loc_rows[False]
        problems += [f"locality: {what}" for what, bad in (
            ("sums differ", on_row["sum"] != off_row["sum"]),
            (f"{on_row['consumers_on_holder']} of {MN_LOCALITY} consumers "
             "on the holder", on_row["consumers_on_holder"] != MN_LOCALITY),
            (f"bytes pulled on {on_row['bytes_pulled']} not below off "
             f"{off_row['bytes_pulled']}",
             on_row["bytes_pulled"] >= off_row["bytes_pulled"]),
            ("no host assign with a locality matrix",
             on_row["locality_host_assigns"] == 0),
            (f"locality host assigns {on_row['locality_host_assigns']} != "
             f"snapshots with a matrix {on_row['snapshots_with_locality']}",
             on_row["locality_host_assigns"]
             != on_row["snapshots_with_locality"]),
            ("locality matrix with the knob off",
             off_row["snapshots_with_locality"])) if bad]

        # -- p2p actor calls ---------------------------------------------
        @ray.remote(resources={"mn_b": 1.0})
        class Acc:
            def __init__(self):
                self.total = 0

            def bump(self, x):
                self.total += x
                return self.total

        @ray.remote(resources={"mn_a": 1.0})
        def caller(h, n):
            import time as _t

            import ray_tpu_torch
            t0 = _t.perf_counter()
            seen = [ray_tpu_torch.get(h.bump.remote(1), timeout=120)
                    for _ in range(n)]
            return seen, _t.perf_counter() - t0

        def run_p2p():
            actor = Acc.remote()
            ray.get(actor.bump.remote(0), timeout=300)   # placed, live
            before = dict(w.two_level_stats)
            seen, dt = ray.get(caller.remote(actor, MN_P2P_CALLS),
                               timeout=600)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                d = two_level_delta(before)
                if d["p2p"] + d["head_fallback"] >= MN_P2P_CALLS - 1:
                    break
                time.sleep(0.05)
            ray.kill(actor)
            return seen, dt, two_level_delta(before)

        (seen, dt, d), _snaps, counts = part("p2p", run_p2p)
        emit({"phase": "multinode", "part": "p2p", "calls": MN_P2P_CALLS,
              "seconds": dt, "calls_per_s": MN_P2P_CALLS / dt,
              "two_level": d,
              "order_exact": seen == list(range(1, MN_P2P_CALLS + 1)),
              **counts})
        problems += [f"p2p: {what}" for what, bad in (
            ("calls out of order", seen != list(range(1, MN_P2P_CALLS + 1))),
            (f"{d['p2p']} of {MN_P2P_CALLS} calls peer-to-peer",
             d["p2p"] < 0.9 * MN_P2P_CALLS - 1),
            (f"{d['head_fallback']} head fallbacks",
             d["head_fallback"])) if bad]

        # -- the engine actor on the GPU node ------------------------------
        def run_gpu():
            return multinode_engine(torch, ray, dev, engine_want)

        (row, gpu_problems, launches), _snaps, counts = part("gpu_node",
                                                             run_gpu)
        out["engine_actor"] = launches
        emit({"phase": "multinode", "part": "gpu_node",
              "node": nodes["gpu"].index, **row, **counts})
        problems += [f"gpu_node: {p}" for p in gpu_problems]

        # -- machine death ------------------------------------------------
        victim = nodes["a"]
        marks = str(Path(marks_dir) / "death")
        leaf = ray.remote(mark_leaf).options(max_retries=3)

        @ray.remote(max_retries=2)
        def sole_copy():
            import numpy as _np
            return _np.full(MN_LOCALITY_BYTES // 8, 7.0)

        def run_death():
            lineage = sole_copy.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    victim.node_id, soft=True)).remote()
            ray.wait([lineage], timeout=300)
            lineage_locs = w.gcs.object_locations(lineage.object_id())
            keys = [f"death-{i}" for i in range(MN_DEATH_TASKS)]
            # the victim's attempts hold before their marks until the
            # kill (mark_leaf): each key must then be marked exactly
            # once, by the run the head took
            held = frozenset(victim.worker_pids())
            before = dict(w.two_level_stats)
            t0 = time.perf_counter()
            refs = [leaf.remote(k, marks, MN_DEATH_TASK_S, held)
                    for k in keys]
            wait_running_on(w, victim.index)
            t_kill = time.perf_counter()
            victim._entry.pool.simulate_machine_death()
            while victim.state != "DEAD" \
                    and time.perf_counter() - t_kill < 60:
                time.sleep(0.005)
            to_dead = time.perf_counter() - t_kill
            vals = ray.get(refs, timeout=600)
            to_last = time.perf_counter() - t_kill
            rebuilt = ray.get(lineage, timeout=300)
            return {"keys": keys, "vals": vals, "to_dead": to_dead,
                    "to_last": to_last, "seconds": time.perf_counter() - t0,
                    "held_workers": len(held),
                    "lineage_locations_before": lineage_locs,
                    "lineage_equal": bool(
                        len(rebuilt) == MN_LOCALITY_BYTES // 8
                        and (rebuilt == 7.0).all()),
                    "two_level": two_level_delta(before)}

        res, snaps, counts = part("machine_death", run_death)
        import hashlib

        keys = res.pop("keys")
        vals = res.pop("vals")
        exact = vals == [hashlib.sha256(k.encode()).hexdigest()
                         for k in keys]
        marked = read_marks(marks)
        once = sorted(marked) == sorted(keys)
        after, on_dead, differ = dead_row_check(
            sk, snaps, {victim.index}, GLOBAL_CONFIG.sched_hybrid_threshold)
        budget = 0.5 + detection_deadline(GLOBAL_CONFIG)
        emit({"phase": "multinode", "part": "machine_death",
              "tasks": MN_DEATH_TASKS, "task_s": MN_DEATH_TASK_S,
              "dead_row": victim.index, "state": victim.state,
              "seconds_to_dead": res["to_dead"], "budget_seconds": budget,
              "seconds_to_last_result": res["to_last"],
              "seconds": res["seconds"], "exact": exact,
              "exactly_once": once, "marks": len(marked),
              "held_workers": res["held_workers"],
              "lineage_locations_before": res["lineage_locations_before"],
              "lineage_rebuilt_equal": res["lineage_equal"],
              "two_level": res["two_level"], "snapshots_after": after,
              "on_dead_row": on_dead, "differ_after": differ, **counts})
        problems += [f"machine_death: {what}" for what, bad in (
            (f"node {victim.state}", victim.state != "DEAD"),
            (f"DEAD after {res['to_dead']} s > {budget}",
             res["to_dead"] > budget),
            ("results not exact", not exact),
            (f"{len(marked)} marks for {len(keys)} tasks", not once),
            ("no worker of the victim to hold", not res["held_workers"]),
            (f"sole copy not on the victim: "
             f"{res['lineage_locations_before']}",
             res["lineage_locations_before"] != [victim.index]),
            ("lineage rebuild differs", not res["lineage_equal"]),
            ("no snapshot after the death", after == 0),
            (f"{on_dead} snapshots put a task on the dead row", on_dead),
            (f"{differ} snapshots after the death differ", differ)) if bad]

        # -- link flap ----------------------------------------------------
        flapped = nodes["b"]
        marks = str(Path(marks_dir) / "flap")
        flap_leaf = ray.remote(mark_leaf).options(
            resources={"mn_b": 1.0}, max_retries=3)

        def run_flap():
            pool = flapped._entry.pool
            replayed0 = pool.outbox_replayed
            keys = [f"flap-{i}" for i in range(MN_FLAP_TASKS)]
            refs = [flap_leaf.remote(k, marks, MN_FLAP_TASK_S) for k in keys]
            wait_running_on(w, flapped.index)
            chaos.arm(chaos.FaultPlan(11, faults=[
                ("node", 1, "flap", {"node": flapped.index})]))
            t0 = time.perf_counter()
            fired, left_alive = None, None
            try:
                while time.perf_counter() - t0 < 60:
                    if fired is None and flapped.state != "ALIVE":
                        fired = time.perf_counter() - t0
                    if fired is not None and flapped.state == "ALIVE":
                        left_alive = time.perf_counter() - t0
                        break
                    time.sleep(0.002)
                vals = ray.get(refs, timeout=300)
                injected = chaos.counters()["injected"].get("node", 0)
            finally:
                chaos.disarm()
            return {"keys": keys, "vals": vals, "injected": injected,
                    "down_at": fired, "alive_at": left_alive,
                    "seconds": time.perf_counter() - t0,
                    "outbox_replayed": pool.outbox_replayed - replayed0}

        res, _snaps, counts = part("link_flap", run_flap)
        keys, vals = res.pop("keys"), res.pop("vals")
        marked = read_marks(marks)
        exact = vals == [hashlib.sha256(k.encode()).hexdigest()
                         for k in keys]
        once = sorted(marked) == sorted(keys)
        emit({"phase": "multinode", "part": "link_flap",
              "tasks": MN_FLAP_TASKS, "state": flapped.state,
              "exact": exact, "exactly_once": once, **res, **counts})
        problems += [f"link_flap: {what}" for what, bad in (
            ("no flap injected", not res["injected"]),
            (f"node {flapped.state} after the flap",
             flapped.state != "ALIVE"),
            ("results not exact", not exact),
            (f"{len(marked)} marks for {len(keys)} tasks", not once)) if bad]

        # -- the ray:// client --------------------------------------------
        def run_client():
            server = w.enable_head_endpoint()
            host, port = server.address
            address = f"ray://{host}:{port}?key={server.authkey.hex()}"
            env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                       PYTHONPATH=os.pathsep.join(
                           [str(Path(__file__).resolve().parent)]
                           + [p for p in sys.path if p]))
            params = {"put_bytes": MN_CLIENT_PUT_BYTES,
                      "tasks": MN_CLIENT_TASKS, "serve": SERVE,
                      "batch": CLIENT_BATCH, "seq": CLIENT_SEQ,
                      "seed": CLIENT_SEED, "device": dev.type,
                      "gpus": 1 if dev.type == "cuda" else 0}
            flash.flash_fwd.launches = 0
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", client_script(), address,
                 json.dumps(params)],
                capture_output=True, text=True, timeout=600, env=env)
            dt = time.perf_counter() - t0
            launches = flash.flash_fwd.launches
            if proc.returncode != 0:
                raise AssertionError(f"client process failed: "
                                     f"{proc.stderr[-3000:]}")
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            return got, client_want, launches, dt

        (got, want, launches, dt), _snaps, counts = part("client",
                                                         run_client)
        out["client_forward"] = launches
        tokens = got.pop("tokens")
        emit({"phase": "multinode", "part": "client", "seconds": dt,
              "forward_tokens_equal": tokens == want,
              "flash_fwd_launches": launches, **got, **counts})
        problems += [f"client: {what}" for what, bad in (
            ("put/get differs", not got["put_get_equal"]),
            ("task results not exact", not got["tasks_exact"]),
            (f"named actor answered {got['named_actor']}",
             got["named_actor"] != 2),
            ("forward tokens differ from the driver's", tokens != want),
            (f"flash_fwd launches {launches} != {SERVE['n_layers']}",
             launches != SERVE["n_layers"]),
            (f"client loaded {got['modules']}", got["modules"]),
            ("the client sees a card", got["cuda"])) if bad]
        errors = w.scheduler.stats()["device_assign_errors"]
        if errors:
            problems.append(f"{errors} device assign errors")
    finally:
        chaos.disarm()
        if cluster is not None:
            cluster.shutdown()
        ray.shutdown()
        rec.remove()
        GLOBAL_CONFIG.reset()
    # -- shutdown ---------------------------------------------------------
    t0 = time.perf_counter()
    watch = pids | set(daemons.values())
    while any(pid_alive(p) for p in watch) and time.perf_counter() - t0 < 30:
        time.sleep(0.05)
    alive = sorted(p for p in watch if pid_alive(p))
    deadline = time.monotonic() + 60
    while True:
        release_card(torch, dev)
        rows2, used2 = card_state()
        if (len(rows2) <= len(rows0)
                and used2 <= used0 + PROCESS_MEM_SLACK_MIB) \
                or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    emit({"phase": "multinode", "part": "shutdown",
          "processes": len(watch), "alive": alive,
          "compute_apps": [rows0, rows2], "memory_used_mib": [used0, used2],
          "seconds": time.perf_counter() - t0})
    if alive:
        problems.append(f"shutdown: processes alive {alive}")
    if len(rows2) > len(rows0) or used2 > used0 + PROCESS_MEM_SLACK_MIB:
        problems.append(f"shutdown: card not released: {rows0} -> {rows2}, "
                        f"{used0} -> {used2} MiB")
    shutil.rmtree(marks_dir, ignore_errors=True)
    emit({"phase": "multinode", "part": "done",
          "seconds": time.perf_counter() - t_phase, "ok": not problems,
          "assign_launches": total[0], **out, "nvidia_smi": smi})
    if problems:
        raise AssertionError(f"multinode phase: {problems}")
    out["assign"] = total[0]
    return out


def multinode_engine_config(torch):
    """(model config, engine config, prompts) of phase multinode's engine
    actor: serve-127M bf16, phase process's prompts."""
    from ray_tpu_torch.models.inference import InferenceConfig
    from ray_tpu_torch.models.transformer import TransformerConfig

    mcfg = TransformerConfig(dtype=torch.bfloat16, **SERVE)
    icfg = InferenceConfig(batch_size=SLOTS, page_size=PAGE,
                           max_pages_per_seq=MAX_PAGES, num_pages=NUM_PAGES,
                           prefill_buckets=(16,),
                           max_new_tokens=ENGINE_NEW_TOKENS)
    return mcfg, icfg, [[i + 1, 2 * i + 3, 7] for i in range(ENGINE_PROMPTS)]


def direct_engine_tokens(torch, dev):
    """The engine actor's tokens from an engine in this process on the
    same seeded parameters."""
    from ray_tpu_torch.models.inference import InferenceEngine
    from ray_tpu_torch.models.transformer import init_params

    mcfg, icfg, prompts = multinode_engine_config(torch)
    params = init_params(mcfg, torch.Generator(device=dev).manual_seed(0))
    engine = InferenceEngine(params, mcfg, icfg, device=dev.type)
    try:
        return [engine.generate(p, ENGINE_NEW_TOKENS) for p in prompts]
    finally:
        engine.shutdown()


def release_card(torch, dev):
    """Give back what this process cached on the card (allocator blocks,
    cuBLAS's per-thread workspaces) before nvidia-smi is read."""
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


def multinode_engine(torch, ray, dev, want):
    """The engine actor (num_gpus=1) on the remote GPU node: it builds
    serve-127M bf16 from the seeded generator in its own process (a
    worker of the GPU node's daemon) and generates ENGINE_PROMPTS prompts;
    its tokens against ``want``, a direct engine's on the head on the
    same seeded parameters; its kernel-1 launches and decode steps, read
    in its process; nvidia-smi shows its process; after ray.kill the
    process is gone and the card's memory back. Returns (row, problems,
    launches)."""
    mcfg, icfg, prompts = multinode_engine_config(torch)
    release_card(torch, dev)
    rows0, used0 = card_state()

    @ray.remote(num_gpus=1, resources={"mn_gpu": 1.0})
    class _RemoteEngine:
        def __init__(self, serve, icfg, device):
            import torch as _torch

            from ray_tpu_torch.models.inference import InferenceEngine as IE
            from ray_tpu_torch.models.transformer import (
                TransformerConfig as TC, init_params as ip)

            cfg = TC(dtype=_torch.bfloat16, **serve)
            self.engine = IE(ip(cfg, _torch.Generator(
                device=device).manual_seed(0)), cfg, icfg, device=device)

        def generate(self, prompts, n):
            # kernel 1's launches and the decode steps, in this process
            import time as _time

            from ray_tpu_torch.ops import paged_attention as pa

            l0, s0 = pa.paged_attention.launches, self.engine.decode_steps
            t0 = _time.perf_counter()
            out = [self.engine.generate(p, n) for p in prompts]
            return {"tokens": out, "seconds": _time.perf_counter() - t0,
                    "launches": pa.paged_attention.launches - l0,
                    "decode_steps": self.engine.decode_steps - s0}

        def where(self):
            import os

            return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

        def stop(self):
            self.engine.shutdown()

    problems = []
    t0 = time.perf_counter()
    actor = _RemoteEngine.remote(SERVE, icfg, dev.type)
    try:
        pid, cvd = ray.get(actor.where.remote(), timeout=600)
        ray.get(actor.generate.remote(prompts[:1], 4), timeout=600)  # warm
        warm_s = time.perf_counter() - t0
        rows1, used1 = card_state()
        run = ray.get(actor.generate.remote(prompts, ENGINE_NEW_TOKENS),
                      timeout=600)
        ray.get(actor.stop.remote(), timeout=120)
    finally:
        ray.kill(actor)
    deadline = time.monotonic() + 60
    while True:
        torch.cuda.empty_cache()
        rows2, used2 = card_state()
        alive = pid_alive(pid)
        problem = released_rule(rows0, used0, rows2, used2, alive)
        if problem is None or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    shown, shown_by = shows_process(rows0, rows1, pid)
    tokens = sum(len(t) for t in run["tokens"])
    row = {"pid": pid, "cuda_visible_devices": cvd,
           "prompts": ENGINE_PROMPTS, "new_tokens": ENGINE_NEW_TOKENS,
           "create_and_warm_seconds": warm_s, "seconds": run["seconds"],
           "tokens_per_s": tokens / run["seconds"],
           "tokens_equal_direct": run["tokens"] == want,
           "paged_attention_launches": run["launches"],
           "decode_steps": run["decode_steps"],
           "compute_apps": [rows0, rows1, rows2],
           "memory_used_mib": [used0, used1, used2],
           "nvidia_smi_shows_actor": shown, "shown_by": shown_by,
           "process_alive_after": alive}
    if run["tokens"] != want:
        problems.append("engine actor tokens != direct engine")
    if problem := launch_rule(run["launches"], mcfg.n_layers,
                              run["decode_steps"]):
        problems.append(problem)
    if not shown:
        problems.append(f"nvidia-smi does not show the actor: {rows0} -> "
                        f"{rows1}")
    if problem := released_rule(rows0, used0, rows2, used2, alive):
        problems.append(problem)
    return row, problems, run["launches"]


def ops_batch_train(model, batch, seq, gate, attempts, progress, marks,
                    min_steps, device="cuda"):
    """Phase ops's batch task (tenant "batch", tier 0, num_gpus=1): phase
    tune's model trained on ``device`` with AdamW until the gate file
    exists, at least ``min_steps`` steps; then its mark. The first
    attempt starts training at once; a later attempt (the retry of a
    preempted one: ``attempts`` holds a line per attempt) waits for the
    gate before it touches the card, so nothing of it holds the card
    while the prod task runs. Each step appends "attempt step" to
    ``progress``. Returns its attempt, steps, losses and the flash
    launches of this process over its steps."""
    import os
    import time as _time

    import torch as _torch

    from ray_tpu_torch.models import train_step as ts
    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  init_params)
    from ray_tpu_torch.ops import flash as fl

    with open(attempts, "a") as f:
        f.write(f"{os.getpid()}\n")
    with open(attempts) as f:
        attempt = len(f.read().split())
    if attempt > 1:
        while not os.path.exists(gate):
            _time.sleep(0.02)
    cfg = TransformerConfig(dtype=_torch.bfloat16, **model)
    gen = _torch.Generator(device=device).manual_seed(0)
    net = Transformer(cfg, device=device).load_params(init_params(cfg, gen))
    step = ts.make_train_step(net, ts.make_optimizer(net.parameters(),
                                                      learning_rate=3e-4))
    tokens = _torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                            generator=gen, device=device)
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    l0 = {n: getattr(fl, n).launches for n in names}
    losses = []
    while True:
        losses.append(float(step({"tokens": tokens})["loss"]))
        with open(progress, "a") as f:
            f.write(f"{attempt} {len(losses)}\n")
        if len(losses) >= min_steps and os.path.exists(gate):
            break
    launches = {n: getattr(fl, n).launches - l0[n] for n in names}
    fd = os.open(marks, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    try:
        os.write(fd, b"batch\n")
    finally:
        os.close(fd)
    return {"attempt": attempt, "pid": os.getpid(), "steps": len(losses),
            "losses": losses, "launches": launches,
            "n_layers": cfg.n_layers}


def ops_prod_decode(serve, icfg, prompts, n, files, device="cuda"):
    """Phase ops's prod task (tenant "prod", tier 5, num_gpus=1): the
    serving model (bf16, params from the seeded generator, as phase
    multinode's engine actor) built in this worker process, ``prompts``
    decoded ``n`` tokens each through InferenceEngine. Before it touches
    the card it creates ``files["leased"]`` and waits up to 120 s for
    ``files["go"]`` (the driver reads the card's memory in between, with
    no process but the head's on it); it creates ``files["started"]``
    once its engine is up (the profile window opens then) and, after
    decoding, waits up to 60 s for ``files["hold"]`` (the window has
    closed), so the window sees this task. Frees the engine and the
    allocator's cache before it returns its tokens, its kernel-1
    launches and decode steps, and its mark (in ``files["marks"]``)."""
    import gc
    import os
    import time as _time

    open(files["leased"], "w").close()
    deadline = _time.monotonic() + 120.0
    while not os.path.exists(files["go"]) and _time.monotonic() < deadline:
        _time.sleep(0.01)

    import torch as _torch

    from ray_tpu_torch.models.inference import InferenceEngine
    from ray_tpu_torch.models.transformer import (TransformerConfig,
                                                  init_params)
    from ray_tpu_torch.ops import paged_attention as pa

    t0 = _time.perf_counter()
    cfg = TransformerConfig(dtype=_torch.bfloat16, **serve)
    engine = InferenceEngine(init_params(cfg, _torch.Generator(
        device=device).manual_seed(0)), cfg, icfg, device=device)
    open(files["started"], "w").close()
    build_s = _time.perf_counter() - t0
    l0, s0 = pa.paged_attention.launches, engine.decode_steps
    t0 = _time.perf_counter()
    tokens = [engine.generate(p, n) for p in prompts]
    decode_s = _time.perf_counter() - t0
    launches = pa.paged_attention.launches - l0
    steps = engine.decode_steps - s0
    engine.shutdown()
    del engine
    gc.collect()
    if device == "cuda":
        _torch.cuda.empty_cache()
    deadline = _time.monotonic() + 60.0
    while not os.path.exists(files["hold"]) and _time.monotonic() < deadline:
        _time.sleep(0.02)
    fd = os.open(files["marks"], os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    try:
        os.write(fd, b"prod\n")
    finally:
        os.close(fd)
    return {"tokens": tokens, "launches": launches, "decode_steps": steps,
            "build_s": build_s, "decode_s": decode_s, "pid": os.getpid()}


def ops_mark(key, path):
    """Append key to the marks file (fair share's completion order)."""
    import os

    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    try:
        os.write(fd, (key + "\n").encode())
    finally:
        os.close(fd)
    return key


def ops_gate_hold(gate, timeout_s=300.0):
    """Hold this task's slot until the gate file exists."""
    import os
    import time as _time

    deadline = _time.monotonic() + timeout_s
    while not os.path.exists(gate) and _time.monotonic() < deadline:
        _time.sleep(0.01)
    return os.path.exists(gate)


def ops_card_compute(seed, n, device="cuda"):
    """Phase ops's snapshot task: a seeded [n, n] f32 matrix on the
    device, x @ x.T's row sums, on the host."""
    import torch as _torch

    g = _torch.Generator(device=device).manual_seed(seed)
    x = _torch.randn(n, n, generator=g, device=device)
    return (x @ x.T).sum(dim=1).cpu()


def ops_fair_keys(seed=OPS_FAIR_SEED, per_tenant=OPS_FAIR_TASKS):
    """The fair-share part's submissions in a seeded order: per tenant
    (prod, batch) half at tier 1 and half at tier 0, as
    [(key, tier, tenant)]."""
    import numpy as np

    keys = [(f"{tenant}-t{tier}-{i}", tier, tenant)
            for tenant in ("prod", "batch") for tier in (1, 0)
            for i in range(per_tenant // 2)]
    order = np.random.default_rng(seed).permutation(len(keys))
    return [keys[i] for i in order]


def ops_fair_order(plane_cls, keys, quotas=OPS_QUOTAS):
    """The completion order one slot gives ``keys`` under the QoS plane:
    each dispatch takes the head of the plane's order over what is still
    queued (strict tiers, then the weights' virtual time), as a tick
    with one free slot does."""
    plane = plane_cls(tenant_quotas=quotas)
    for key, tier, tenant in keys:
        plane.note_queued(key, tenant, tier)
    left, out = list(keys), []
    while left:
        first = left.pop(plane.order([(t, n) for _, t, n in left])[0])
        plane.note_dispatched(first[0])
        plane.note_done(first[0])
        out.append(first[0])
    return out


def ops_fair_check(done, want, keys):
    """The fair-share part's rules on the completion order ``done``:
    equal to the simulated order ``want``; every tier-1 key before any
    tier-0 key; and within each tier's first 16 completions prod served
    at least twice as often as batch (weights 3:1). Returns problems."""
    tier = {k: t for k, t, _ in keys}
    problems = []
    if done != want:
        problems.append(f"completion order differs from the plane's: "
                        f"{done} != {want}")
    seen0 = False
    for k in done:
        seen0 |= tier[k] == 0
        if seen0 and tier[k] == 1:
            problems.append(f"tier-1 {k} completed after a tier-0 key")
            break
    for t in (1, 0):
        head = [k for k in done if tier[k] == t][:16]
        n_prod = sum(k.startswith("prod") for k in head)
        if n_prod < 2 * (len(head) - n_prod):
            problems.append(f"tier {t}: prod {n_prod} of {len(head)} in "
                            "its first completions, below 3:1's 2x")
    return problems


def ops_state_rows(state, urlopen, port):
    """Every state verb phase ops reads, from the API and from the
    dashboard's endpoints: {verb: (api rows, dashboard rows)}."""
    pairs = {"list_tasks": ("/api/tasks", lambda: state.list_tasks()),
             "list_tasks_detail": ("/api/task_events",
                                   lambda: state.list_tasks(detail=True)),
             "list_actors": ("/api/actors", state.list_actors),
             "list_objects": ("/api/objects", state.list_objects),
             "list_nodes": ("/api/nodes", state.list_nodes),
             "list_tenants": ("/api/tenants", state.list_tenants),
             "task_timeline": ("/api/timeline", state.task_timeline),
             "list_traces": ("/api/traces", state.list_traces)}
    out = {}
    for verb, (path, fn) in pairs.items():
        api = fn()
        body = urlopen(f"http://127.0.0.1:{port}{path}", timeout=30).read()
        out[verb] = (api, json.loads(body))
    return out


def ops_state_check(rows, ran):
    """The state part's rules: each verb's rows agree with what the part
    ran (``ran``: the finished task names, the actor's name, the put's
    object id hex, the node count, the tenants, the trace roots), and
    the dashboard serves the same row identities. Returns problems."""
    problems = []
    key = {"list_tasks": "task_id", "list_tasks_detail": "task_id",
           "list_actors": "actor_id", "list_objects": "object_id",
           "list_nodes": "node_id", "list_tenants": "tenant",
           "list_traces": "trace_id"}
    for verb, k in key.items():
        api, dash = rows[verb]
        a = sorted(str(r.get(k)) for r in api)
        d = sorted(str(r.get(k)) for r in dash)
        # the dashboard reads later than the API: a row may have joined or
        # left meanwhile only among live tasks and objects
        if verb in ("list_actors", "list_nodes", "list_tenants") and a != d:
            problems.append(f"{verb}: dashboard rows {d} != api rows {a}")
    detail = rows["list_tasks_detail"][0]
    finished = {r.get("name") for r in detail if r.get("state") == "FINISHED"}
    missing = sorted(set(ran["task_names"]) - finished)
    if missing:
        problems.append(f"list_tasks(detail=True) lacks FINISHED rows of "
                        f"{missing}")
    actors = {r["name"]: r for r in rows["list_actors"][0]}
    if actors.get(ran["actor"], {}).get("state") != "ALIVE":
        problems.append(f"list_actors: {ran['actor']} not ALIVE: {actors}")
    objs = {r["object_id"] for r in rows["list_objects"][0]}
    if ran["object"] not in objs:
        problems.append("list_objects lacks the part's put")
    nodes = rows["list_nodes"][0]
    if (len(nodes) != ran["nodes"]
            or any(n["state"] != "ALIVE" for n in nodes)):
        problems.append(f"list_nodes: {[(n['index'], n['state']) for n in nodes]}")
    tenants = {r["tenant"] for r in rows["list_tenants"][0]}
    if not set(ran["tenants"]) <= tenants:
        problems.append(f"list_tenants: {sorted(tenants)}")
    names = {e.get("name") for e in rows["task_timeline"][0]}
    if not set(ran["task_names"]) <= names:
        problems.append(f"task_timeline lacks {sorted(set(ran['task_names']) - names)}")
    roots = {r.get("root") for r in rows["list_traces"][0]}
    if not rows["list_traces"][0] or not roots & set(ran["task_names"]):
        problems.append(f"list_traces: roots {sorted(map(str, roots))}")
    return problems


def ops_window_top(report):
    """Every task of a profile() window by samples, highest first: the
    report's top_tasks table without its 15-row cut, from the window's
    collapsed lines ("node<n>;<task>;<frames> <count>")."""
    from ray_tpu_torch._private import profile_plane

    rows = []
    for line in report["collapsed"].splitlines():
        head, count = line.rsplit(" ", 1)
        node, task, stack = head.split(";", 2)
        rows.append({"node": int(node[4:]), "task": task, "stack": stack,
                     "count": int(count)})
    return profile_plane.top_tasks(rows, limit=len(rows))


def ops_memory_rule(before, after, slack_mib=PROCESS_MEM_SLACK_MIB):
    """The card's memory.used back within slack_mib of ``before`` (MiB)."""
    if after <= before + slack_mib:
        return None
    return f"memory.used {before} -> {after} MiB (slack {slack_mib})"


def ops_qos(torch, dev, ray, part, problems, out):
    """Part qos (with parts profile and state on the same cluster): a
    process-mode head on the card's scheduler with worker_gpu_access, the
    QoS plane (OPS_QUOTAS, grace OPS_GRACE_S) and the profile plane
    (OPS_PROFILE_HZ), offering GPU: 1, and one remote CPU node. The batch
    task trains on the card; the prod task (tier 5) preempts it and
    decodes; the profile window runs during the decode. Returns the
    part's rows."""
    import math
    import tempfile
    import urllib.request

    from ray_tpu_torch import dashboard
    from ray_tpu_torch._private import metrics as metrics_mod
    from ray_tpu_torch.util import state

    mcfg, icfg, prompts = multinode_engine_config(torch)
    want = direct_engine_tokens(torch, dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ops_")
    files = {n: os.path.join(tmp, n) for n in (
        "gate", "attempts", "progress", "marks", "leased", "go", "started",
        "hold")}
    row = {}
    t0 = time.perf_counter()
    ray.init(num_workers=OPS_WORKERS, scheduler="tensor",
             _system_config=dict(OPS_SYSTEM, sched_device=dev.type))
    try:
        w = ray._worker.get_worker()
        node = w.add_remote_cluster_node(num_cpus=1, num_workers=1,
                                         resources={"ops_cpu": 4.0})
        wait_workers_ready(w.process_pool)
        wait_workers_ready(node.pool)
        row["startup_s"] = time.perf_counter() - t0
        row["gpus"] = ray.cluster_resources().get("GPU", 0)
        if row["gpus"] != 1:
            problems.append(f"qos: the head offers GPU {row['gpus']} != 1")
        # one task first, so this process's own card work (the assign
        # kernels' module, the scheduler's stream) is in the baseline:
        # the checks below see only what the workers hold
        ray.get(ray.remote(ops_mark).remote("warm", files["marks"] + ".warm"),
                timeout=300)
        release_card(torch, dev)
        rows_a, used_a = card_state()

        batch = ray.remote(ops_batch_train).options(
            tenant="batch", num_gpus=1, max_retries=2)
        prod = ray.remote(ops_prod_decode).options(
            priority=5, tenant="prod", num_gpus=1, max_retries=0)

        def run():
            b_ref = batch.remote(TUNE_MODEL, TUNE_BATCH, TUNE_SEQ,
                                 files["gate"], files["attempts"],
                                 files["progress"], files["marks"],
                                 OPS_BATCH_MIN_STEPS, dev.type)
            # the batch holds the card and has trained a few steps
            deadline = time.monotonic() + 300
            while len(read_marks(files["progress"])) < 2 * OPS_BATCH_MIN_STEPS:
                if time.monotonic() > deadline:
                    raise AssertionError("qos: the batch task never trained")
                time.sleep(0.05)
            rows_b, used_b = card_state()
            t_sub = time.perf_counter()
            p_ref = prod.remote(SERVE, icfg, prompts, ENGINE_NEW_TOKENS,
                                files, dev.type)
            # the prod lease came from the kill: before it touches the
            # card, the killed attempt's process has exited and its
            # memory is back (the head's context alone on the card)
            while not os.path.exists(files["leased"]):
                if time.perf_counter() - t_sub > 300:
                    raise AssertionError("qos: the prod task never leased")
                time.sleep(0.01)
            t_leased = time.perf_counter() - t_sub
            deadline = time.monotonic() + 60
            while True:
                rows_k, used_k = card_state()
                if (ops_memory_rule(used_a, used_k) is None
                        or time.monotonic() > deadline):
                    break
                time.sleep(0.05)
            t_back = time.perf_counter() - t_sub
            open(files["go"], "w").close()
            # part profile: the window opens once the prod engine is up
            while not os.path.exists(files["started"]):
                if time.perf_counter() - t_sub > 300:
                    raise AssertionError("qos: the prod task never started")
                time.sleep(0.01)
            t_started = time.perf_counter() - t_sub
            report = ray.profile(duration_s=OPS_PROFILE_S)
            open(files["hold"], "w").close()
            prod_out = ray.get(p_ref, timeout=300)
            t_prod = time.perf_counter() - t_sub
            gate_closed = not os.path.exists(files["gate"])
            marks_before_gate = read_marks(files["marks"])
            open(files["gate"], "w").close()
            batch_out = ray.get(b_ref, timeout=300)
            return dict(prod=prod_out, batch=batch_out, report=report,
                        t_started=t_started, t_prod=t_prod,
                        gate_closed=gate_closed,
                        marks_before_gate=marks_before_gate,
                        card=dict(used_a=used_a, rows_a=len(rows_a),
                                  used_b=used_b, rows_b=len(rows_b),
                                  used_killed=used_k, rows_killed=len(rows_k),
                                  leased_s=t_leased, back_s=t_back))

        res, _, counts = part("qos", run)
        prod_out, batch_out = res["prod"], res["batch"]
        marks = read_marks(files["marks"])
        st = w.qos_plane.stats()
        tenants = {r["tenant"]: r for r in state.list_tenants()}
        text = metrics_mod.render_all(w)
        n_layers = batch_out["n_layers"]
        row.update({
            "prompts": len(prompts), "new_tokens": ENGINE_NEW_TOKENS,
            "prod_result_s": res["t_prod"], "prod_started_s": res["t_started"],
            "prod_build_s": prod_out["build_s"],
            "prod_decode_s": prod_out["decode_s"],
            "prod_tokens_equal_direct": prod_out["tokens"] == want,
            "paged_attention_launches": prod_out["launches"],
            "decode_steps": prod_out["decode_steps"],
            "gate_closed_at_prod_result": res["gate_closed"],
            "marks_before_gate": res["marks_before_gate"], "marks": marks,
            "batch_attempt": batch_out["attempt"],
            "batch_retry_steps": batch_out["steps"],
            "batch_retry_flash": batch_out["launches"],
            "batch_losses_finite": all(
                math.isfinite(x) for x in batch_out["losses"]),
            "preemptions_total": st["preemptions_total"],
            "preempts_by_tier": st["preempts_by_tier"],
            "tenants": tenants, "card": res["card"], "assign": counts})
        out["ops_prod"] = prod_out["launches"]
        out["ops_batch"] = batch_out["launches"]
        problems.extend(f"qos: {what}" for what, bad in (
            ("the prod result came after the gate opened",
             not res["gate_closed"]),
            (f"marks before the gate {res['marks_before_gate']} != ['prod']",
             res["marks_before_gate"] != ["prod"]),
            ("prod tokens != a direct engine's", prod_out["tokens"] != want),
            (launch_rule(prod_out["launches"], mcfg.n_layers,
                         prod_out["decode_steps"]),
             launch_rule(prod_out["launches"], mcfg.n_layers,
                         prod_out["decode_steps"]) is not None),
            (f"marks {marks} != one prod and one batch",
             sorted(marks) != ["batch", "prod"]),
            ("the batch result is not a retry", batch_out["attempt"] < 2),
            (f"preemptions {st}", st["preemptions_total"] < 1
             or st["preempts_by_tier"].get(0, 0) < 1),
            (f"retry flash {batch_out['launches']} != "
             f"{batch_out['steps']} steps x {n_layers} layers",
             any(v != batch_out["steps"] * n_layers
                 for v in batch_out["launches"].values())),
            ("state.list_tenants shows no preemption",
             tenants.get("batch", {}).get("preempted", 0) < 1),
            ("no ray_tpu_sched_preemptions_total{tier=\"0\"} in the metrics",
             'ray_tpu_sched_preemptions_total{tier="0"}' not in text),
            (f"the killed attempt's card memory: {res['card']}",
             ops_memory_rule(used_a, res["card"]["used_killed"])
             is not None
             or res["card"]["rows_killed"] > res["card"]["rows_a"])) if bad)

        # -- part profile -------------------------------------------------
        report = res["report"]
        top = [r["task"] for r in ops_window_top(report)]
        util = state.list_utilization()
        node_ids = {n["index"] for n in state.list_nodes()}
        util_nodes = {r["node"] for r in util if r["points"]}
        now = time.time()
        stale = [r["node"] for r in util if r["points"] and not (
            now - 600 <= r["points"][-1][0] <= now + 1)]
        pp = w.profile_plane.summary()
        recorded = [ln for ln in text.splitlines()
                    if ln.startswith("ray_tpu_profile_samples_recorded_total")]
        prod_rank = next((i for i, t in enumerate(top)
                          if "ops_prod_decode" in t), None)
        prof = {"samples": report["samples"], "top_tasks": top[:8],
                "prod_rank": prod_rank,
                "util_nodes": sorted(util_nodes), "nodes": sorted(node_ids),
                "util_rows": len(util), "summary": pp,
                "recorded_metric": recorded}
        problems.extend(f"profile: {what}" for what, bad in (
            (f"no prod label among the window's tasks {top}",
             not any("ops_prod_decode" in t for t in top)),
            (f"utilization rows for nodes {sorted(util_nodes)} != "
             f"{sorted(node_ids)}", util_nodes != node_ids),
            (f"utilization off the head's clock on nodes {stale}", stale),
            (f"samples recorded {recorded}", not recorded
             or float(recorded[0].split()[-1]) <= 0)) if bad)

        # -- part state ---------------------------------------------------
        @ray.remote(resources={"ops_cpu": 1.0})
        class OpsCounter:
            def bump(self):
                return 1

        actor = OpsCounter.options(name="ops_counter").remote()
        ray.get(actor.bump.remote(), timeout=120)
        obj = ray.put(list(range(1000)))
        port = dashboard.start_dashboard()
        try:
            rows = ops_state_rows(state, urllib.request.urlopen, port)
        finally:
            dashboard.stop_dashboard()
        ran = {"task_names": ["ops_batch_train", "ops_prod_decode"],
               "actor": "ops_counter", "object": obj.object_id().hex(),
               "nodes": 2, "tenants": ["batch", "prod"]}
        problems.extend(f"state: {p}" for p in ops_state_check(rows, ran))
        st_row = {verb: [len(api), len(dash)]
                  for verb, (api, dash) in rows.items()}
        ray.kill(actor)
    finally:
        ray.shutdown()
    deadline = time.monotonic() + 60
    while True:
        release_card(torch, dev)
        rows_e, used_e = card_state()
        problem = ops_memory_rule(used_a, used_e)
        if problem is None or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    row["card_after_shutdown"] = [used_a, used_e]
    if problem:
        problems.append(f"qos: after shutdown {problem}")
    return row, prof, st_row


def ops_fair(torch, dev, ray, part, problems):
    """Part fair share: thread mode, one CPU and one worker, held by a
    gate; 2 tenants x OPS_FAIR_TASKS tasks in a seeded order, then the
    gate opens: the completion order against the plane's simulation
    (ops_fair_order), with the scheduler's snapshots replayed per tier
    run."""
    import tempfile

    from ray_tpu_torch._private.qos import QosPlane

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ops_fair_")
    gate, marks = os.path.join(tmp, "gate"), os.path.join(tmp, "marks")
    keys = ops_fair_keys()
    want = ops_fair_order(QosPlane, keys)
    ray.init(num_cpus=1, num_workers=1, scheduler="tensor",
             _system_config=dict(OPS_FAIR_SYSTEM, sched_device=dev.type))
    try:
        hold = ray.remote(ops_gate_hold).options(tenant="hold", priority=9)
        mark = ray.remote(ops_mark)

        def run():
            h = hold.remote(gate)
            deadline = time.monotonic() + 60
            while not any(r["state"] == "RUNNING"
                          for r in ray._worker.get_worker()
                          .scheduler.task_table()):
                if time.monotonic() > deadline:
                    raise AssertionError("fair: the holder never ran")
                time.sleep(0.01)
            refs = [mark.options(priority=tier, tenant=tenant).remote(
                key, marks) for key, tier, tenant in keys]
            time.sleep(0.2)               # every key queued behind it
            open(gate, "w").close()
            ray.get([h] + refs, timeout=300)

        _, snaps, counts = part("fair", run)
    finally:
        ray.shutdown()
    done = read_marks(marks)
    runs = [s for s in snaps if s[0][9] is None or len(set(s[0][9])) == 1]
    problems.extend(f"fair: {p}" for p in ops_fair_check(done, want, keys))
    if not runs:
        problems.append("fair: no tier run was recorded")
    return {"tasks": len(keys), "completions": len(done),
            "order_equal_plane": done == want, "first": done[:12],
            "tier_runs": len(runs), "assign": counts}


def ops_snapshot(torch, dev, ray, problems):
    """Part snapshot (thread mode, the card's scheduler): OPS_SNAP_TASKS
    num_gpus tasks pending behind a gate-held GPU task, a KV entry,
    snapshot_cluster, shutdown; a fresh init and restore_cluster: the
    tasks resolve under their original ids to the card computation's
    values (ops_card_compute run directly, relative max error within
    OPS_SNAP_REL), the KV entry comes back."""
    import tempfile

    from ray_tpu_torch import ObjectRef

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ops_snap_")
    gate, path = os.path.join(tmp, "gate"), os.path.join(tmp, "snap.bin")
    system = {"sched_backend": "cuda", "sched_device": dev.type}
    seeds = list(range(OPS_SNAP_TASKS))
    want = [ops_card_compute(s, OPS_SNAP_N, dev.type) for s in seeds]
    ray.init(num_workers=2, scheduler="tensor", _system_config=system)
    try:
        hold = ray.remote(ops_gate_hold).options(num_gpus=1)
        comp = ray.remote(ops_card_compute).options(num_gpus=1)
        h = hold.remote(gate)
        refs = [comp.remote(s, OPS_SNAP_N, dev.type) for s in seeds]
        ids = [r.object_id() for r in refs]
        time.sleep(0.3)
        ray._worker.get_worker().gcs.kv_put(b"ops_key", b"ops_value",
                                            namespace="ops")
        t0 = time.perf_counter()
        meta = ray.snapshot_cluster(path)
        save_s = time.perf_counter() - t0
        open(gate, "w").close()
        ray.get(h, timeout=120)
    finally:
        ray.shutdown()
    ray.init(num_workers=2, scheduler="tensor", _system_config=system)
    try:
        t0 = time.perf_counter()
        info = ray.restore_cluster(path)
        restore_s = time.perf_counter() - t0
        got = ray.get([ObjectRef(oid) for oid in ids], timeout=300)
        kv = ray._worker.get_worker().gcs.kv_get(b"ops_key", namespace="ops")
    finally:
        ray.shutdown()
    errs = [float((g - w_).abs().max() / w_.abs().max())
            for g, w_ in zip(got, want)]
    row = {"pending_saved": meta["pending_tasks"],
           "resubmitted": info["resubmitted_tasks"],
           "kv_restored": kv == b"ops_value", "save_s": save_s,
           "restore_s": restore_s, "max_rel_err": max(errs),
           "bound": OPS_SNAP_REL}
    problems.extend(f"snapshot: {what}" for what, bad in (
        (f"pending saved {meta['pending_tasks']} != {len(seeds)}",
         meta["pending_tasks"] != len(seeds)),
        (f"resubmitted {info['resubmitted_tasks']}",
         info["resubmitted_tasks"] != len(seeds)),
        ("the KV entry did not come back", kv != b"ops_value"),
        (f"results off by {max(errs)} > {OPS_SNAP_REL}",
         max(errs) > OPS_SNAP_REL)) if bad)
    return row


# the job's driver (part cli): argv[1] the connect string, argv[2] JSON
# {serve, batch, seq, seed, device}; connects over ray://, runs serve-127M's
# forward on the head's card as a task that also counts flash_fwd in its
# process, prints one JSON line
JOB_SRC = r'''
import json, sys
import ray_tpu_torch as ray


def forward_counted(serve, batch, seq, seed, device):
    from ray_tpu_torch.ops import flash
    n0 = flash.flash_fwd.launches
    tokens = FORWARD(serve, batch, seq, seed, device)
    return tokens, flash.flash_fwd.launches - n0


address, p = sys.argv[1], json.loads(sys.argv[2])
ray.init(address=address)
tokens, launches = ray.get(ray.remote(forward_counted).options(
    num_gpus=1).remote(p["serve"], p["batch"], p["seq"], p["seed"],
                       p["device"]),
    timeout=600)
ray.shutdown()
print("ops_job " + json.dumps({"tokens": tokens.tolist(),
                               "flash_fwd": launches}), flush=True)
'''


def ops_cli_run(args, env, timeout=300, cwd=None):
    """One CLI verb in a subprocess: (exit code, its output)."""
    r = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                       capture_output=True, text=True, env=env,
                       timeout=timeout, cwd=cwd)
    return r.returncode, r.stdout + r.stderr


def ops_group_alive(pgid):
    """Pids of live (not zombie) processes in process group pgid."""
    alive = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().split(")")[-1].split()
        except OSError:
            continue
        if fields[0] != "Z" and int(fields[2]) == pgid:
            alive.append(int(name))
    return alive


def ops_cli(torch, dev, problems, out):
    """Part cli: the operator's path, every step a subprocess of the CLI
    (python -m ray_tpu_torch): start --head (process mode, the card's
    scheduler, worker_gpu_access and both planes through the registry's
    environment overrides) and start --address (a node daemon joining);
    status --address lists both nodes ALIVE; job runs JOB_SRC, whose
    forward on the head's card must equal this process's
    (client_forward) with flash_fwd 8; timeline, trace and profile write
    their files; SIGTERM ends the head, its workers and the joined
    daemon, and the card's memory comes back."""
    import inspect
    import re as _re
    import signal
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ops_cli_")
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **OPS_CLI_ENV)
    want = client_forward(SERVE, CLIENT_BATCH, CLIENT_SEQ, CLIENT_SEED,
                          dev.type).tolist()
    release_card(torch, dev)
    rows0, used0 = card_state()
    row = {}
    head = node = None
    try:
        t0 = time.perf_counter()
        head = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "start", "--head",
             "--worker-mode", "process", "--num-workers", "2"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True, cwd=tmp)
        address = None
        for line in head.stdout:
            m = _re.search(r"address='(ray://[^']+)'", line)
            if m:
                address = m.group(1)
                break
        if address is None:
            raise AssertionError("cli: the head printed no connect string")
        row["head_start_s"] = time.perf_counter() - t0
        node = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "start",
             f"--address={address}", "--num-cpus", "2", "--num-workers",
             "1"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True,
            cwd=tmp)
        deadline = time.monotonic() + 120
        while True:
            rc, text = ops_cli_run(["status", "--address", address], env,
                                   cwd=tmp)
            alive = _re.findall(r"^\s+\[\d+\] \S+ ALIVE", text, _re.M)
            if (rc == 0 and len(alive) == 2) or time.monotonic() > deadline:
                break
            time.sleep(1.0)
        row["status"] = {"rc": rc, "alive_nodes": len(alive)}
        if rc != 0 or len(alive) != 2:
            problems.append(f"cli: status lists {len(alive)} ALIVE nodes "
                            f"(rc {rc}): {text[-800:]}")
        driver = os.path.join(tmp, "job_driver.py")
        with open(driver, "w") as f:
            f.write(inspect.getsource(client_forward)
                    + "\n\nFORWARD = client_forward\n" + JOB_SRC)
        t0 = time.perf_counter()
        rc, text = ops_cli_run(
            ["job", "--", sys.executable, driver, f"'{address}'",
             "'" + json.dumps({"serve": SERVE, "batch": CLIENT_BATCH,
                               "seq": CLIENT_SEQ, "seed": CLIENT_SEED,
                               "device": dev.type}) + "'"],
            env, timeout=600, cwd=tmp)
        row["job_s"] = time.perf_counter() - t0
        m = _re.search(r"^ops_job (.*)$", text, _re.M)
        job = json.loads(m.group(1)) if m else None
        row["job"] = {"rc": rc, "succeeded": "status: SUCCEEDED" in text,
                      "flash_fwd": job and job["flash_fwd"],
                      "tokens_equal": bool(job) and job["tokens"] == want}
        out["ops_job_forward"] = job["flash_fwd"] if job else 0
        problems.extend(f"cli: job {what}" for what, bad in (
            (f"did not succeed (rc {rc}): {text[-1500:]}",
             rc != 0 or "status: SUCCEEDED" not in text),
            ("logs lack the driver's line", job is None),
            ("tokens != this process's forward",
             job is not None and job["tokens"] != want),
            (f"flash_fwd {job and job['flash_fwd']} != "
             f"{SERVE['n_layers']}",
             job is not None and job["flash_fwd"] != SERVE["n_layers"]))
            if bad)
        files = {}
        for verb, args, path in (
                ("timeline", ["-o", "timeline.json"], "timeline.json"),
                ("trace", ["--latest", "-o", "trace.json"], "trace.json"),
                ("profile", ["-d", "1", "-o", "profile.json"],
                 "profile.json")):
            rc, text = ops_cli_run([verb, *args, "--address", address],
                                   env, cwd=tmp)
            full = os.path.join(tmp, path)
            size = os.path.getsize(full) if os.path.exists(full) else 0
            files[verb] = {"rc": rc, "bytes": size}
            if rc != 0 or size == 0:
                problems.append(f"cli: {verb} rc {rc}, {size} bytes: "
                                f"{text[-800:]}")
        row["files"] = files
    finally:
        t0 = time.perf_counter()
        for proc in (head, node):
            if proc is not None and proc.poll() is None and proc is head:
                proc.send_signal(signal.SIGTERM)
        groups = [p.pid for p in (head, node) if p is not None]
        deadline = time.monotonic() + 60
        while any(ops_group_alive(g) for g in groups) \
                and time.monotonic() < deadline:
            time.sleep(0.2)
        left = {g: ops_group_alive(g) for g in groups}
        for g, pids in left.items():
            if pids:
                os.killpg(g, signal.SIGKILL)
        row["sigterm_exit_s"] = time.perf_counter() - t0
        row["left_after_sigterm"] = {str(g): p for g, p in left.items()}
    if any(left.values()):
        problems.append(f"cli: processes left after SIGTERM: {left}")
    deadline = time.monotonic() + 60
    while True:
        release_card(torch, dev)
        rows_e, used_e = card_state()
        problem = ops_memory_rule(used0, used_e)
        if problem is None or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    row["card"] = [used0, used_e]
    if problem:
        problems.append(f"cli: after SIGTERM {problem}")
    return row


def phase_ops(torch, dev):
    """The optional planes and the ops layer (see OPS_*): parts qos (a
    prod inference task preempting batch training on the card), profile
    and state (on qos's cluster), fair share, snapshot and cli. Each
    part runs through the public entry points; the assign counter is
    zeroed just before each part on the card's scheduler and read just
    after. Returns {"ops_prod": kernel 1, "ops_batch": {flash kernel:
    launches}, "ops_job_forward": flash_fwd, "ops": assign}."""
    import ray_tpu_torch as ray
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.scheduler import kernels as sk
    from ray_tpu_torch._private.scheduler.tensor import TensorScheduler

    smi = nvidia_smi()
    t_phase = time.perf_counter()
    problems, total = [], [0]
    out = {"ops_prod": 0, "ops_batch": {n: 0 for n in FLASH_NAMES},
           "ops_job_forward": 0}
    rec = AssignRecorder(torch, TensorScheduler, sk, GLOBAL_CONFIG)

    def part(name, fn):
        """fn() with assign's counter zeroed just before and read just
        after, every snapshot kept and those of single-tier runs replayed
        through assign_np: (fn's result, snapshots, counts)."""
        w = ray._worker.get_worker()
        rec.snapshots = []
        st0 = w.scheduler.stats()
        sk.assign.launches = 0
        res = fn()
        n = sk.assign.launches
        st1 = w.scheduler.stats()
        snaps, rec.snapshots = rec.snapshots, None
        total[0] += n
        runs = [s for s in snaps
                if s[0][9] is None or len(set(s[0][9])) == 1]
        assigns = st1["device_assigns"] - st0["device_assigns"]
        counts = {"assign_launches": n, "device_assigns": assigns,
                  "snapshots": len(snaps), "tier_runs": len(runs),
                  "snapshots_differ": replay_oracle(
                      sk, runs, GLOBAL_CONFIG.sched_hybrid_threshold)}
        problems.extend(f"{name}: {what}" for what, bad in (
            (f"assign launches {n} != device assigns {assigns}",
             n != assigns),
            ("no device assign", n == 0),
            (f"{counts['snapshots_differ']} snapshots differ from "
             "assign_np", counts["snapshots_differ"])) if bad)
        return res, snaps, counts

    seconds = {}
    try:
        t0 = time.perf_counter()
        qos, prof, st = ops_qos(torch, dev, ray, part, problems, out)
        seconds["qos_profile_state"] = time.perf_counter() - t0
        emit({"phase": "ops", "part": "qos", "nvidia_smi": smi, **qos})
        emit({"phase": "ops", "part": "profile", "nvidia_smi": smi, **prof})
        emit({"phase": "ops", "part": "state", "nvidia_smi": smi,
              "rows_api_dashboard": st})
        t0 = time.perf_counter()
        fair = ops_fair(torch, dev, ray, part, problems)
        seconds["fair"] = time.perf_counter() - t0
        emit({"phase": "ops", "part": "fair", "nvidia_smi": smi, **fair})
        t0 = time.perf_counter()
        snap = ops_snapshot(torch, dev, ray, problems)
        seconds["snapshot"] = time.perf_counter() - t0
        emit({"phase": "ops", "part": "snapshot", "nvidia_smi": smi, **snap})
        t0 = time.perf_counter()
        cli = ops_cli(torch, dev, problems, out)
        seconds["cli"] = time.perf_counter() - t0
        emit({"phase": "ops", "part": "cli", "nvidia_smi": smi, **cli})
    finally:
        rec.remove()
        ray.shutdown()
    out["ops"] = total[0]
    emit({"phase": "ops", "nvidia_smi": smi, "seconds": seconds,
          "phase_seconds": time.perf_counter() - t_phase,
          "launches": out, "ok": not problems, "problems": problems})
    if problems:
        raise AssertionError(f"ops phase: {problems}")
    return out


def host_state():
    """What this process carries into a phase from the ones before it: its
    threads, its live child processes, the objects the garbage collector
    tracks and its resident memory (a host-bound reading can move with
    each)."""
    import gc
    import threading

    children = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().split(")")[-1].split()
        except OSError:
            continue
        if fields[0] != "Z" and int(fields[1]) == os.getpid():
            try:
                with open(f"/proc/{name}/cmdline", "rb") as f:
                    cmd = f.read().replace(b"\0", b" ").decode()[:200]
            except OSError:
                cmd = None
            children.append({"pid": int(name), "cmdline": cmd})
    with open("/proc/self/status") as f:
        rss = next((int(line.split()[1]) << 10 for line in f
                    if line.startswith("VmRSS:")), None)
    names = sorted(t.name for t in threading.enumerate())
    return {"threads": names,
            # how many threads carry each name (a pool's accept thread is
            # ray_tpu_pool_accept whichever pool it serves)
            "thread_counts": {n: names.count(n) for n in sorted(set(names))},
            "children": children, "gc_objects": len(gc.get_objects()),
            "rss_bytes": rss}


def sinks_form(rows, top_k):
    """The reference's form of model_time_sinks: at most top_k rows,
    descending, each share in (0, 100], summing to at most 100 (plus
    rounding). Returns the problems."""
    shares = [r["pct_of_device_time"] for r in rows]
    return [what for what, bad in (
        ("no rows", not rows),
        (f"{len(rows)} rows > top_k {top_k}", len(rows) > top_k),
        ("not descending", shares != sorted(shares, reverse=True)),
        ("a share outside (0, 100]", any(not 0 < x <= 100 for x in shares)),
        (f"shares sum to {sum(shares)}", sum(shares) > 100.05)) if bad]


def flash_ops(rows):
    """Each flash kernel's device name (PERF_FLASH_OPS) among the time
    sinks' ops, and its share: {kernel: (op, share) or None}."""
    return {name: next(((r["op"], r["pct_of_device_time"]) for r in rows
                        if all(k in r["op"] for k in keys)), None)
            for name, keys in PERF_FLASH_OPS.items()}


def serving_oracle(torch, dev):
    """serving_ab's model as its engines hold it (seed PERF_SERVING_SEED,
    weights in bf16, norm scales f32) run in f32 over the full context
    with no kernel: logits_all(tokens) -> [len(tokens), vocab]."""
    import dataclasses

    from ray_tpu_torch._private import perf
    from ray_tpu_torch.models.transformer import (TransformerConfig,
                                                  init_params,
                                                  model_from_params)

    mcfg = TransformerConfig(**perf.SERVING_AB_MODEL)
    params = init_params(mcfg, torch.Generator(device=dev).manual_seed(
        PERF_SERVING_SEED))
    params = {k: v if k.endswith("/scale") else v.to(mcfg.dtype).float()
              for k, v in params.items()}
    oracle = model_from_params(dataclasses.replace(
        mcfg, dtype=torch.float32, flash_attention="off"), params, device=dev)

    @torch.no_grad()
    def logits_all(tokens):
        return oracle(torch.tensor([tokens], device=dev))[0].float()

    return logits_all


def stream_deficits(torch, logits_all, streams, max_new, vocab):
    """Each stream's generated tokens teacher-forced through the oracle
    (logits_all): at each step the oracle's top logit less the logit of
    the token the stream took (0 where it took the argmax). Returns
    {"tokens": compared, "worst": the largest deficit, "off_argmax":
    steps that took another token than the argmax, "malformed": streams
    of the wrong length or out of vocab}."""
    compared, worst, off, malformed = 0, 0.0, 0, 0
    for s in streams:
        toks = s["tokens"]
        if len(toks) != max_new or not all(0 <= t < vocab for t in toks):
            malformed += 1
            continue
        p = len(s["prompt"])
        logits = logits_all(list(s["prompt"]) + toks[:-1])[p - 1:]
        took = logits.gather(1, torch.tensor(toks, device=logits.device)
                             .unsqueeze(1)).squeeze(1)
        deficit = logits.max(dim=1).values - took
        compared += len(toks)
        worst = max(worst, float(deficit.max()))
        off += int((deficit > 0).sum())
    return {"tokens": compared, "worst": worst, "off_argmax": off,
            "malformed": malformed}


def phase_perf(torch, dev):
    """The rest of ray_tpu_torch/_private/perf.py on the card (see PERF_*):
    decode at 64 and PERF_DECODE_SLOTS slots, the train step's time sinks
    (twice), the serving A/B's two arms, the head-bypass A/B's three arms,
    streaming ingest and the Arrow sections, each through its public
    function. The kernels' launch counters are zeroed just before each
    section and read just after. Each section prints one line; a failed
    check or a raising section fails the phase after the rest have run.
    kernels.assign's counter is held to the device assigns of the
    schedulers the sections start, and every snapshot that went through
    the card to assign_np. Returns the launches by section: {"decode_64",
    "decode_128", "serving_mono", "serving_disagg": kernel 1;
    "time_sinks": {flash kernel: launches over both calls}; "assign":
    kernels.assign over every section}."""
    import importlib.util
    import threading
    import traceback

    from ray_tpu_torch._private import perf
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.scheduler import kernels as sk
    from ray_tpu_torch._private.scheduler.tensor import TensorScheduler
    from ray_tpu_torch.ops import paged_attention as pa

    smi = nvidia_smi()
    kernels = {"paged_attention": pa.paged_attention, **_flash_kernels(),
               "scheduler_assign": sk.assign}
    layers = SERVE["n_layers"]
    problems, results, out = [], {}, {"assign": 0}
    t_phase = time.perf_counter()
    # the host's state as the earlier phases leave it: decode is host-bound
    emit({"phase": "perf", "section": "host", **host_state()})

    def assigns_after(rec):
        """The device assigns of each scheduler that assigned on the card
        since rec.schedulers was set (a calibration thread joined first),
        every snapshot that went through the card replayed through
        assign_np (single-tier runs, as phase ops): problems, counts."""
        for t in threading.enumerate():
            if t.name == "ray_tpu_sched_calib":
                t.join(timeout=10)
        n = sk.assign.launches
        assigns = sum(sch.stats()["device_assigns"] - n0
                      for sch, n0 in rec.schedulers.items())
        snaps, rec.snapshots, rec.schedulers = rec.snapshots, None, None
        runs = [x for x in snaps
                if x[0][9] is None or len(set(x[0][9])) == 1]
        counts = {"assign_launches": n, "device_assigns": assigns,
                  "snapshots": len(snaps), "tier_runs": len(runs),
                  "snapshots_differ": replay_oracle(
                      sk, runs, GLOBAL_CONFIG.sched_hybrid_threshold)}
        out["assign"] += n
        return [what for what, bad in (
            (f"assign launches {n} != device assigns {assigns}",
             n != assigns),
            (f"{counts['snapshots_differ']} snapshots differ from "
             "assign_np", counts["snapshots_differ"])) if bad], counts

    def section(key, fn, check):
        """fn() with every counter zeroed just before and read just after
        (kernels.assign's against the device assigns of the schedulers
        the section started); check(result, launches) -> problems. One
        line, whatever happens."""
        rec = AssignRecorder(torch, TensorScheduler, sk, GLOBAL_CONFIG,
                             any_backend=True)
        try:
            for k in kernels.values():
                k.launches = 0
            rec.snapshots, rec.schedulers = [], {}
            t0 = time.perf_counter()
            try:
                r = fn()
                error = None
            except Exception:
                r, error = None, traceback.format_exc(limit=8)
            seconds = time.perf_counter() - t0
            assign_bad, assign = assigns_after(rec)
        finally:
            rec.remove()
        launches = {n: k.launches for n, k in kernels.items()}
        bad = ([f"raised: {error.splitlines()[-1]}"] if error
               else check(r, launches)) + assign_bad
        problems.extend(f"{key}: {b}" for b in bad)
        results[key] = (r, launches)
        shown = r
        if isinstance(r, list):   # the time sinks: the line shows the top
            shown = {"ops": len(r), "top": [
                {"op": row["op"][:120], "pct": row["pct_of_device_time"]}
                for row in r[:PERF_SHOW_OPS]]}
        elif isinstance(r, dict) and "streams" in r:   # serving: counted
            shown = {**r, "streams": len(r["streams"])}
        emit({"phase": "perf", "section": key, "nvidia_smi": smi,
              "seconds": seconds, "launches": launches, "assign": assign,
              "result": shown, "ok": not bad, "problems": bad,
              "error": error})
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return r, launches

    # decode: the engine at the serving width; kernel 1 on every layer of
    # every decode step of the timed round (phase engine's rule)
    def decode_check(slots):
        def check(r, launches):
            rule = launch_rule(r["paged_attention_launches"], layers,
                               r["decode_steps"])
            return [what for what, bad in (
                (f"tokens {r['tokens']} != {slots} x {PERF_DECODE_NEW}",
                 r["tokens"] != slots * PERF_DECODE_NEW
                 or round(r["tokens_per_sec"] * r["seconds"]) != r["tokens"]),
                (f"batch_slots {r['batch_slots']}", r["batch_slots"] != slots),
                (f"n_params {r['n_params']} != the reference's "
                 f"{PERF_DECODE_PARAMS}", r["n_params"] != PERF_DECODE_PARAMS),
                (rule, rule is not None),
                (f"the counter read {launches['paged_attention']} < the "
                 "timed round's", launches["paged_attention"]
                 < r["paged_attention_launches"])) if bad]
        return check

    for slots in (64, PERF_DECODE_SLOTS):
        _r, launches = section(
            f"decode_{slots}",
            lambda s=slots: perf.llm_decode_throughput(
                batch_slots=None if s == 64 else s),
            decode_check(slots))
        out[f"decode_{slots}"] = launches["paged_attention"]

    # the flagship step's time sinks: the reference's top 5, then every op
    want_flash = {"flash_fwd": 2 * TRAIN["n_layers"] * PERF_SINK_STEPS,
                  "flash_bwd_dq": TRAIN["n_layers"] * PERF_SINK_STEPS,
                  "flash_bwd_dkv": TRAIN["n_layers"] * PERF_SINK_STEPS}

    def sinks_check(top_k):
        def check(rows, launches):
            bad = sinks_form(rows, top_k)
            bad += [f"{n} launches {launches[n]} != {w}"
                    for n, w in want_flash.items() if launches[n] != w]
            if top_k == PERF_SINKS_ALL:
                bad += [f"{n}'s kernel not among the ops"
                        for n, hit in flash_ops(rows).items() if hit is None]
            return bad
        return check

    _rows, top5 = section("time_sinks_top5", perf.model_time_sinks,
                          sinks_check(5))
    rows, launches = section(
        "time_sinks_all",
        lambda: perf.model_time_sinks(top_k=PERF_SINKS_ALL),
        sinks_check(PERF_SINKS_ALL))
    out["time_sinks"] = {n: top5[n] + launches[n] for n in FLASH_NAMES}
    found, by_group = flash_ops(rows or []), {}
    for row in rows or []:
        group = kernel_group(row["op"])
        by_group[group] = by_group.get(group, 0.0) + row["pct_of_device_time"]
    emit({"phase": "perf", "section": "time_sinks_flash", "nvidia_smi": smi,
          "flash_ops": found, "flash_share": sum(
              share for _op, share in filter(None, found.values())),
          "share_by_group": by_group})

    # serving A/B: the reference guard's correctness checks, and every
    # stream's tokens against the plain model (kernel 1 at page 4 on the
    # engines' path); TTFT and tokens/s are readings
    logits_all = serving_oracle(torch, dev)
    max_new, vocab = PERF_SERVING["max_new"], perf.SERVING_AB_MODEL[
        "vocab_size"]

    def serving_check(r, launches):
        d = stream_deficits(torch, logits_all, r["streams"], max_new, vocab)
        r["oracle"] = d
        return [what for what, bad in (
            (f"n_streams {r['n_streams']}", r["n_streams"]
             != PERF_SERVING["sessions"] * PERF_SERVING["turns"]
             or len(r["streams"]) != r["n_streams"]),
            (f"sheds {r['sheds']}", r["sheds"] != 0),
            ("kernel 1 not launched", launches["paged_attention"] == 0
             or r["paged_attention_launches"] == 0),
            (f"{d['malformed']} streams of the wrong length or out of "
             "vocab", d["malformed"]),
            (f"a token {d['worst']} below the plain model's top logit "
             f"(tolerance {PERF_SERVING_TOL})",
             d["worst"] > PERF_SERVING_TOL)) if bad]

    for disagg in (False, True):
        key = "serving_disagg" if disagg else "serving_mono"
        _r, launches = section(
            key, lambda d=disagg: perf.serving_ab(d, **PERF_SERVING),
            serving_check)
        out[key] = launches["paged_attention"]
    mono, split = (results[k][0] for k in ("serving_mono", "serving_disagg"))
    if mono and split:
        problems.extend(f"serving: {what}" for what, bad in (
            (f"total_tokens {split['total_tokens']} != mono's "
             f"{mono['total_tokens']}",
             split["total_tokens"] != mono["total_tokens"]),
            (f"affinity_hit_rate {split['affinity_hit_rate']} < 0.8",
             (split["affinity_hit_rate"] or 0) < 0.8),
            ("no kv_bytes in the split arm", split["kv_bytes"] <= 0))
            if bad)
        # a reading: streams whose tokens the two arms agree on (bf16
        # engines may part at a near-tie; the oracle check above decides)
        emit({"phase": "perf", "section": "serving_streams_equal",
              "equal": sum(a["tokens"] == b["tokens"] for a, b in zip(
                  mono["streams"], split["streams"])),
              "streams": len(mono["streams"])})

    # head bypass: the reference guard's correctness checks, every arm
    n_calls, n_submit = (PERF_HEAD_BYPASS[k] for k in ("n_calls",
                                                       "n_submit"))
    for p2p, arm in ((True, "on"), (False, "off"), (None, "default")):
        section(f"head_bypass_{arm}", lambda p=p2p: perf.head_bypass_ab(p),
                lambda r, _l, p=p2p: [what for what, bad in (
                    (f"total {r['total']} != {n_calls}",
                     r["total"] != n_calls),
                    (f"n_submit {r['n_submit']} != {n_submit}",
                     r["n_submit"] != n_submit),
                    (f"calls_p2p {r['calls_p2p']} < 0.9 x {n_calls} - 1",
                     p is True and r["calls_p2p"] < 0.9 * n_calls - 1),
                    (f"head_fallback {r['head_fallback']}",
                     p is True and r["head_fallback"] != 0),
                    (f"local_dispatch {r['local_dispatch']} < {n_submit}",
                     p is True and r["local_dispatch"] < n_submit),
                    ("the off arm bypassed the head", p is False and (
                        r["calls_p2p"] != 0 or r["local_dispatch"] != 0)))
                    if bad])

    # streaming ingest: rows exact, the first batch sooner than materialise
    section("ingest", perf.data_ingest_overlap,
            lambda r, _l: [what for what, bad in (
                (f"rows {r['rows']} != {PERF_INGEST_ROWS}",
                 r["rows"] != PERF_INGEST_ROWS),
                (f"ttfb streaming {r['ttfb_streaming_s']} >= materialize "
                 f"{r['ttfb_materialize_s']}",
                 r["ttfb_streaming_s"] >= r["ttfb_materialize_s"])) if bad])

    # the Arrow sections need pyarrow; skipped only where it is missing
    for name in PERF_ARROW:
        if importlib.util.find_spec("pyarrow") is None:
            emit({"phase": "perf", "section": name,
                  "skipped": PERF_ARROW_SKIP})
            continue
        section(name, getattr(perf, name),
                lambda r, _l: [f"total_mb {r['total_mb']}"]
                if not r["total_mb"] > 0 else [])
    if importlib.util.find_spec("pyarrow") is not None:
        import pyarrow
        emit({"phase": "perf", "section": "pyarrow",
              "version": pyarrow.__version__})
    emit({"phase": "perf", "nvidia_smi": smi,
          "phase_seconds": time.perf_counter() - t_phase,
          "launches": out, "ok": not problems, "problems": problems})
    if problems:
        raise AssertionError(f"perf phase: {problems}")
    return out


# phase sharded: sharded training on torch.distributed. SHARDED_RANKS rank
# processes share the card (gloo: NCCL refuses two ranks on one device),
# rendezvous through a file:// path, each with a deadline. Parts: the ring
# at the flagship's width under seq=4 and seq=2 x tensor=2 (logits against
# phase ring's single-process logits, RING_PARITY_BOUNDS), the sharded
# train step (data=2 x tensor=2, tokens [4, 2048], 3 steps; the first loss
# within the reference's rtol 2e-3 of one process's), one MoE layer of phase
# moe's configuration at [4, 2048] tokens on expert=4 (f32, TF32 off, within
# MOE_LAYER_TOL of the per-shard moe_ffn_reference) and the pipeline (4
# stages of one flagship Block each, f32, M=4 microbatches of [2, 2048]):
# outputs and the stacked stage gradients against running the stages in
# sequence, element by element |got - want| <= tol * (1 + |want|)
SHARDED_RANKS = 4
SHARDED_DEADLINE_S = 600
SHARDED_RING_MESHES = {"seq4": dict(seq=4), "seq2_tensor2": dict(seq=2,
                                                                 tensor=2)}
SHARDED_TRAIN_MESH = dict(data=2, tensor=2)
SHARDED_TRAIN_BATCH, SHARDED_TRAIN_STEPS = 4, 3
SHARDED_LOSS_RTOL = 2e-3                 # tests/test_models.py:119
SHARDED_MOE_TOKENS = 4 * TRAIN_SEQ
SHARDED_PIPE_STAGES, SHARDED_PIPE_M, SHARDED_PIPE_MB = 4, 4, 2
SHARDED_PIPE_TOL, SHARDED_PIPE_GRAD_TOL = 1e-5, 1e-4


def sharded_pipe_setup(torch, dev):
    """The pipeline part's stacked stage params (layer i of a 4-layer
    flagship-width draw, seed 4) and microbatches (seed 5), f32, and the
    block configuration (einsum attention: the sequential run has no mesh
    and must take the same path as the stages)."""
    from ray_tpu_torch.models.transformer import (TransformerConfig,
                                                  draw_params)

    cfg = TransformerConfig(dtype=torch.float32, max_seq_len=TRAIN_SEQ,
                            flash_attention="off",
                            **{**TRAIN, "n_layers": SHARDED_PIPE_STAGES})
    gen = torch.Generator(device=dev)
    layers = {}
    for name, t in draw_params(cfg, gen.manual_seed(4), dev):
        if name.startswith("layer_"):
            i, rest = name.split("/", 1)
            layers.setdefault(rest, []).append(t)
    stacked = {k: torch.stack(v) for k, v in layers.items()}
    xs = torch.randn((SHARDED_PIPE_M, SHARDED_PIPE_MB, TRAIN_SEQ,
                      TRAIN["d_model"]), generator=gen.manual_seed(5),
                     device=dev)
    return cfg, stacked, xs


def sharded_stage_fn(torch, cfg):
    """stage_fn(params, x): one Block with ``params`` (a layer's), the
    global positions of a [mb, TRAIN_SEQ] microbatch."""
    from ray_tpu_torch.models.transformer import Block

    block = Block(cfg, device="meta")
    positions = None

    def stage_fn(params, x):
        nonlocal positions
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None]
        out, _aux = torch.func.functional_call(
            block, {k.replace("/", "."): v for k, v in params.items()},
            (x, positions))
        return out

    return stage_fn


def sharded_pipe_loss(y):
    return y.pow(2).mean()


def sharded_references(torch, dev, tmp):
    """Phase ring's single-process logits (seq=4 on [dev] * 4), one
    process's first train loss on the sharded part's batch and params, and
    the pipeline's sequential outputs and stage gradients; saved under
    ``tmp`` for the ranks. Returns the seconds each took."""
    from ray_tpu_torch.models import train_step as ts
    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  cross_entropy_loss,
                                                  init_params)
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh, use_mesh

    secs = {}
    t0 = time.perf_counter()
    cfg = TransformerConfig(dtype=torch.bfloat16, max_seq_len=RING_SEQ,
                            ring_attention=True, **TRAIN)
    gen = torch.Generator(device=dev)
    model = Transformer(cfg, device=dev).load_params(
        init_params(cfg, gen.manual_seed(0)))
    tokens = torch.randint(0, cfg.vocab_size, (1, RING_SEQ),
                           generator=gen.manual_seed(1), device=dev)
    with use_mesh(make_mesh(MeshConfig(seq=RING_SHARDS), [dev] * RING_SHARDS)):
        logits = ts.make_forward(model)(tokens)
    torch.save(logits.cpu(), os.path.join(tmp, "ring_logits.pt"))
    del model, logits
    torch.cuda.empty_cache()
    secs["ring"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg, params, tokens = _train_setup(torch, torch.bfloat16,
                                       SHARDED_TRAIN_BATCH)
    model = Transformer(cfg, device=dev).load_params(params)
    del params
    with torch.no_grad():
        loss = float(cross_entropy_loss(model(tokens[:, :-1]),
                                        tokens[:, 1:]))
    del model
    torch.cuda.empty_cache()
    secs["train"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    pcfg, stacked, xs = sharded_pipe_setup(torch, dev)
    stage_fn = sharded_stage_fn(torch, pcfg)
    stacked = {k: v.requires_grad_() for k, v in stacked.items()}
    outs = []
    for m in range(SHARDED_PIPE_M):
        x = xs[m]
        for i in range(SHARDED_PIPE_STAGES):
            x = stage_fn({k: v[i] for k, v in stacked.items()}, x)
        # the loss is a mean over all microbatches' outputs
        (sharded_pipe_loss(x) / SHARDED_PIPE_M).backward()
        outs.append(x.detach())
    torch.save({"out": torch.stack(outs).cpu(),
                "grads": {k: v.grad.cpu() for k, v in stacked.items()}},
               os.path.join(tmp, "pipeline.pt"))
    del stacked, xs, outs
    torch.cuda.empty_cache()
    secs["pipeline"] = time.perf_counter() - t0
    return {"train_loss": loss, "seconds": secs}


def sharded_close(torch, got, want, tol):
    """(worst |got - want| / (1 + |want|), max abs error) over two tensors
    of one shape, in f32 chunks."""
    worst = max_abs = 0.0
    got, want = got.reshape(-1), want.reshape(-1)
    for i in range(0, got.numel(), 1 << 24):
        a, b = got[i:i + (1 << 24)].float(), want[i:i + (1 << 24)].float()
        d = (a - b).abs()
        worst = max(worst, float((d / (1 + b.abs())).max()))
        max_abs = max(max_abs, float(d.max()))
    return {"worst": worst, "max_abs_err": max_abs, "bound": tol,
            "ok": worst <= tol}


def sharded_rank(torch, rank, world, tmp):
    """One rank of phase sharded (``chip_smoke.py --rank r n dir``): join
    the group, run the four parts, write rank<r>.json into ``dir``."""
    from ray_tpu_torch.models import train_step as ts
    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  init_params)
    from ray_tpu_torch.ops import moe
    from ray_tpu_torch.ops import ring_attention as ra
    from ray_tpu_torch.ops.pipeline import pipeline_forward
    from ray_tpu_torch.parallel import collectives, distributed
    from ray_tpu_torch.parallel.mesh import MeshConfig

    t_start = time.perf_counter()
    distributed.init_multihost(f"file://{tmp}/rendezvous", world, rank,
                               timeout_s=SHARDED_DEADLINE_S)
    dev = distributed.device()
    out = {"rank": rank, "device": str(dev), "backend": distributed.backend(),
           "join_s": time.perf_counter() - t_start, "parts": {}}
    meshes = {}

    def mesh(cfg):
        key = tuple(sorted(cfg.items()))
        if key not in meshes:
            meshes[key] = distributed.global_mesh(MeshConfig(**cfg))
        return meshes[key]

    def part(name, fn):
        torch.cuda.synchronize()
        collectives.reset_stats()
        t0 = time.perf_counter()
        row = fn()
        torch.cuda.synchronize()
        row["seconds"] = time.perf_counter() - t0
        row["collectives"] = collectives.stats()
        out["parts"][name] = row
        torch.cuda.empty_cache()

    def ring():
        cfg = TransformerConfig(dtype=torch.bfloat16, max_seq_len=RING_SEQ,
                                ring_attention=True, **TRAIN)
        gen = torch.Generator(device=dev)
        model = Transformer(cfg, device=dev).load_params(
            init_params(cfg, gen.manual_seed(0)))
        tokens = torch.randint(0, cfg.vocab_size, (1, RING_SEQ),
                               generator=gen.manual_seed(1), device=dev)
        want = torch.load(os.path.join(tmp, "ring_logits.pt"),
                          mmap=True).to(dev)
        forward = ts.make_forward(model)
        rows = {}
        for name, cfg_mesh in SHARDED_RING_MESHES.items():
            from ray_tpu_torch.parallel.mesh import use_mesh

            m = mesh(cfg_mesh)
            with use_mesh(m):
                ra.block_attention.launches = 0
                t0 = time.perf_counter()
                logits = forward(tokens)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                launches = ra.block_attention.launches
            diff = _logit_diff(torch, logits, want)
            rows[name] = {"ms": dt * 1e3, "launches": launches,
                          "want_launches": TRAIN["n_layers"]
                          * m.shape["seq"],
                          "shape": list(logits.shape),
                          "finite": bool(torch.isfinite(logits).all()),
                          **diff, "bound": RING_PARITY_BOUNDS["bfloat16"]}
            del logits
        return rows

    def train():
        from ray_tpu_torch.ops import flash as fl

        cfg = TransformerConfig(dtype=torch.bfloat16, max_seq_len=TRAIN_SEQ,
                                remat=True, remat_policy="dots", **TRAIN)
        m = mesh(SHARDED_TRAIN_MESH)
        model, params, shardings = ts.init_sharded(cfg, m,
                                                   SHARDED_TRAIN_BATCH,
                                                   TRAIN_SEQ, seed=0)
        gen = torch.Generator(device=dev)
        tokens = torch.randint(0, cfg.vocab_size,
                               (SHARDED_TRAIN_BATCH, TRAIN_SEQ),
                               generator=gen.manual_seed(1), device=dev)
        layout = {n: [str(p) for p in params[n].placements]
                  for n in ("layer_0/Attention_0/wq", "embedding")}
        shard_shape = list(params["layer_0/Attention_0/wq"].to_local().shape)
        step = ts.make_train_step(model, ts.make_optimizer(
            model.parameters()), param_shardings=shardings)
        for name in FLASH_NAMES:
            getattr(fl, name).launches = 0
        losses, step_ms = [], []
        for _ in range(SHARDED_TRAIN_STEPS):
            t0 = time.perf_counter()
            metrics = step({"tokens": tokens})
            losses.append(float(metrics["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return {"losses": losses, "step_ms": step_ms,
                "grad_norm": float(metrics["grad_norm"]),
                "layout": layout, "wq_shard_shape": shard_shape,
                "layout_after": {n: [str(p) for p in params[n].placements]
                                 for n in layout},
                "flash_launches": {n: getattr(fl, n).launches
                                   for n in FLASH_NAMES},
                "peak_mem_bytes": torch.cuda.max_memory_allocated()}

    def moe_layer():
        import math

        torch.backends.cuda.matmul.allow_tf32 = False
        T, D, Fd, E = (SHARDED_MOE_TOKENS, TRAIN["d_model"], TRAIN["d_ff"],
                       MOE_EXPERTS)
        gen = torch.Generator(device=dev).manual_seed(2)
        x = torch.randn(T, D, generator=gen, device=dev)
        router = torch.randn(D, E, generator=gen, device=dev) / math.sqrt(D)
        w_in = torch.randn(E, D, Fd, generator=gen, device=dev) / math.sqrt(D)
        w_out = torch.randn(E, Fd, D, generator=gen,
                            device=dev) / math.sqrt(Fd)
        m = mesh(dict(expert=SHARDED_RANKS))
        t0 = time.perf_counter()
        y, aux = moe.moe_ffn_sharded(x, router, w_in, w_out, m, MOE_CF)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        refs = [moe.moe_ffn_reference(s, router, w_in, w_out, MOE_CF)
                for s in x.chunk(SHARDED_RANKS)]
        want = torch.cat([r[0] for r in refs])
        aux_want = float(torch.stack([r[1] for r in refs]).mean())
        return {"tokens": T, "ms": dt * 1e3,
                "max_abs_err": float((y - want).abs().max()),
                "aux_err": abs(float(aux) - aux_want),
                "bound": MOE_LAYER_TOL}

    def pipeline():
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg, stacked, xs = sharded_pipe_setup(torch, dev)
        stage_fn = sharded_stage_fn(torch, cfg)
        stacked = {k: v.requires_grad_() for k, v in stacked.items()}
        m = mesh(dict(pipe=SHARDED_PIPE_STAGES))
        t0 = time.perf_counter()
        y = pipeline_forward(stage_fn, stacked, xs, m)
        sharded_pipe_loss(y).backward()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ref = torch.load(os.path.join(tmp, "pipeline.pt"), mmap=True)
        row = {"ms": dt * 1e3,
               "out": sharded_close(torch, y.detach(), ref["out"].to(dev),
                                    SHARDED_PIPE_TOL)}
        grads = [sharded_close(torch, v.grad, ref["grads"][k].to(dev),
                               SHARDED_PIPE_GRAD_TOL)
                 for k, v in stacked.items()]
        row["grads"] = {"worst": max(g["worst"] for g in grads),
                        "max_abs_err": max(g["max_abs_err"] for g in grads),
                        "bound": SHARDED_PIPE_GRAD_TOL,
                        "ok": all(g["ok"] for g in grads),
                        "tensors": len(grads)}
        return row

    with torch.no_grad():
        part("ring", ring)
    part("train", train)
    part("moe", moe_layer)
    part("pipeline", pipeline)
    out["banned_modules"] = sorted(m for m in sys.modules
                                   if m.split(".")[0] in REF_MODULES)
    out["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.shutdown_multihost()
    return 0


def sharded_rank_command(rank, tmp):
    """The command that runs rank ``rank`` of phase sharded."""
    return [sys.executable, str(Path(__file__).resolve()), "--rank",
            str(rank), str(SHARDED_RANKS), tmp]


def phase_sharded(torch, dev, rank_command=sharded_rank_command):
    """Sharded training on torch.distributed: SHARDED_RANKS rank processes
    sharing the card (see SHARDED_*), each started by ``rank_command(rank,
    dir)``. Returns kernel 2's launches by rank for each ring mesh."""
    import math
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    t_phase = time.perf_counter()
    try:
        refs = sharded_references(torch, dev, tmp)
        torch.cuda.empty_cache()
        # what this process still holds of the card while the ranks run
        refs["parent_mem"] = {"allocated": torch.cuda.memory_allocated(),
                              "reserved": torch.cuda.memory_reserved()}
        t0 = time.perf_counter()
        procs = []
        for r in range(SHARDED_RANKS):
            log = open(os.path.join(tmp, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                rank_command(r, tmp), stdout=log, stderr=subprocess.STDOUT,
                cwd=str(Path(__file__).resolve().parent)), log))
        end = time.monotonic() + SHARDED_DEADLINE_S
        problems = []
        for r, (p, log) in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                problems.append(f"rank {r} missed the deadline")
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        ranks_s = time.perf_counter() - t0
        rows = []
        for r, (p, _log) in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.json")
            if p.returncode != 0 or not os.path.exists(path):
                tail = Path(tmp, f"rank{r}.log").read_text()[-3000:]
                problems.append(f"rank {r} exited {p.returncode}: {tail}")
                continue
            rows.append(json.loads(Path(path).read_text()))
        if problems:
            raise AssertionError(f"sharded phase: {problems}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for row in rows:
        r, parts = row["rank"], row["parts"]
        if row["banned_modules"]:
            problems.append(f"rank {r} loaded {row['banned_modules']}")
        if row["backend"] != "gloo" or row["device"] != str(dev):
            problems.append(f"rank {r} on {row['device']} over "
                            f"{row['backend']}")
        for name, ring in parts["ring"].items():
            if name in ("seconds", "collectives"):
                continue
            if ring["launches"] != ring["want_launches"]:
                problems.append(f"rank {r} {name}: kernel 2 launched "
                                f"{ring['launches']} != "
                                f"{ring['want_launches']}")
            if not ring["finite"] or ring["rel_l2"] > ring["bound"]:
                problems.append(f"rank {r} {name}: logits rel L2 "
                                f"{ring['rel_l2']} > {ring['bound']}")
        tr = parts["train"]
        if not all(math.isfinite(x) for x in tr["losses"]):
            problems.append(f"rank {r}: a loss is not finite")
        rel = abs(tr["losses"][0] - refs["train_loss"]) / abs(
            refs["train_loss"])
        tr["first_loss_rel"] = rel
        if rel > SHARDED_LOSS_RTOL:
            problems.append(f"rank {r}: first loss {tr['losses'][0]} vs one "
                            f"process's {refs['train_loss']} ({rel})")
        if (tr["layout"]["layer_0/Attention_0/wq"] != ["R", "S(1)"]
                or tr["layout"]["embedding"] != ["R", "S(0)"]
                or tr["layout_after"] != tr["layout"]):
            problems.append(f"rank {r}: layouts {tr['layout']} -> "
                            f"{tr['layout_after']}")
        if any(tr["flash_launches"].values()):
            problems.append(f"rank {r}: flash ran under the mesh "
                            f"{tr['flash_launches']}")
        mo = parts["moe"]
        if mo["max_abs_err"] > mo["bound"] or mo["aux_err"] > mo["bound"]:
            problems.append(f"rank {r}: moe {mo['max_abs_err']} "
                            f"aux {mo['aux_err']} > {mo['bound']}")
        pi = parts["pipeline"]
        if not (pi["out"]["ok"] and pi["grads"]["ok"]):
            problems.append(f"rank {r}: pipeline {pi['out']} {pi['grads']}")
    launches = {name: [row["parts"]["ring"][name]["launches"]
                       for row in rows] for name in SHARDED_RING_MESHES}
    emit({"phase": "sharded", "device": torch.cuda.get_device_name(),
          "ranks": SHARDED_RANKS, "reference_s": refs["seconds"],
          "reference_train_loss": refs["train_loss"],
          "parent_mem": refs["parent_mem"], "ranks_s": ranks_s,
          "seconds": time.perf_counter() - t_phase,
          "kernel2_launches_by_rank": launches, "rows": rows})
    if problems:
        raise AssertionError(f"sharded phase: {problems}")
    return launches


def lint_static():
    """python -m ray_tpu_torch lint --json over this checkout, in a
    subprocess: (row, problems)."""
    from ray_tpu_torch._private.analysis import PACKAGE_ROOT, lock_order

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "lint", "--json"],
        cwd=str(Path(__file__).resolve().parent), capture_output=True,
        text=True, timeout=600)
    seconds = time.perf_counter() - t0
    problems = []
    try:
        report = json.loads(proc.stdout)
    except ValueError:
        report = {}
        problems.append(f"lint printed no JSON (exit {proc.returncode}): "
                        f"{proc.stderr[-2000:]}")
    edges = lock_order.collect_edges(PACKAGE_ROOT)
    passes = report.get("durations_s", {})
    row = {"exit": proc.returncode, "ok": report.get("ok"),
           "seconds": seconds, "passes_s": passes,
           "new": [f["key"] for f in report.get("new", [])],
           "baselined": len(report.get("baselined", [])),
           "stale_suppressions": report.get("stale_suppressions"),
           "static_lock_edges": len(edges)}
    if proc.returncode != 0 or report.get("ok") is not True:
        problems.append(f"lint: exit {proc.returncode}, new {row['new']}")
    if tuple(passes) != LINT_PASSES:
        problems.append(f"lint ran the passes {list(passes)}")
    if report.get("stale_suppressions") != []:
        problems.append(f"stale suppressions {row['stale_suppressions']}")
    if not edges:
        problems.append("the static lock graph is empty")
    return row, problems


def lint_report(san, report):
    """The sanitizer's report as the phase's line keeps it, and its
    problems."""
    problems = []
    if report is None:
        return {"filed": False}, ["shutdown filed no sanitizer report"]
    for section in ("lock_inversions", "wire_violations", "shm_leaks",
                    "ref_leaks"):
        if report[section]:
            problems.append(f"{section}: {report[section][:5]}")
    if not san.clean(report):
        problems.append("the sanitizer report is not clean")
    return {"filed": True,
            **{k: report[k] for k in ("lock_inversions", "wire_violations",
                                      "shm_leaks", "ref_leaks")},
            "uncharted": len(report["lock_uncharted"])}, problems


def lint_arena(san, ray):
    """tests/test_chaos.py's arena round under the armed sanitizer:
    LINT_ARENA_PUTS results of 1.6 MB each in process mode must fill the
    shm ledger and drain it. (row, problems)."""
    import gc

    import numpy as np

    @ray.remote
    def big(i):
        return np.arange(LINT_ARENA_ELEMS, dtype=np.float64) * i

    refs = [big.remote(i) for i in range(LINT_ARENA_PUTS)]
    got = ray.get(refs, timeout=300)
    filled = san.ledger_size()
    exact = all(np.array_equal(
        a, np.arange(LINT_ARENA_ELEMS, dtype=np.float64) * i)
        for i, a in enumerate(got))
    del refs, got
    gc.collect()
    deadline = time.monotonic() + 30.0
    while san.ledger_size() and time.monotonic() < deadline:
        time.sleep(0.05)
    drained = san.ledger_size()
    problems = []
    if not exact:
        problems.append("arena round: wrong results")
    if filled < LINT_ARENA_PUTS:
        problems.append(f"the shm ledger held {filled} entries, "
                        f"< {LINT_ARENA_PUTS}")
    if drained:
        problems.append(f"the shm ledger kept {drained} entries")
    return {"ledger_filled": filled, "ledger_after": drained,
            "results_exact": exact}, problems


def phase_lint(torch, dev):
    """raylint's passes over the checkout, then the serving path and an
    arena round under the armed runtime sanitizer (docstring, phase 25)."""
    import ray_tpu_torch as ray
    from ray_tpu_torch._private.analysis import runtime_sanitizer as san
    from ray_tpu_torch.models.inference import InferenceEngine
    from ray_tpu_torch.ops import paged_attention as pa

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    static, problems = lint_static()
    emit({"phase": "lint", "part": "static", **static, "nvidia_smi": smi})

    mcfg, params, icfg, prompts = engine_setup(torch)
    prompts = prompts[:LINT_PROMPTS]
    ray.shutdown()
    san.arm()  # before init: the wrap_lock sites fire at setup
    try:
        t0 = time.perf_counter()
        ray.init(num_workers=4, scheduler="tensor")
        try:
            pa.paged_attention.launches = 0
            actor = engine_actor(ray).remote(params, mcfg, icfg)
            try:
                got, _ = ray.get(actor.generate.remote(
                    prompts, ENGINE_NEW_TOKENS), timeout=600)
                ray.get(actor.stop.remote(), timeout=120)
            finally:
                ray.kill(actor)
            launches = pa.paged_attention.launches
        finally:
            ray.shutdown()
        serve_s = time.perf_counter() - t0
        observed = sorted(f"{a} -> {b}" for a, b in san.observed_edges())
        serving, found = lint_report(san, san.last_report())
        problems += found
        engine = InferenceEngine(params, mcfg, icfg)
        try:
            want = [engine.generate(p, ENGINE_NEW_TOKENS) for p in prompts]
        finally:
            engine.shutdown()
        if got != want:
            problems.append("engine actor tokens != direct engine tokens")
        if launches <= 0:
            problems.append("the engine actor launched no paged attention")
        emit({"phase": "lint", "part": "serving", "seconds": serve_s,
              "prompts": len(prompts), "new_tokens": ENGINE_NEW_TOKENS,
              "tokens_equal_direct": got == want,
              "paged_attention_launches": launches,
              "observed_edges": observed, **serving})

        san.arm()
        t0 = time.perf_counter()
        ray.init(num_cpus=4, num_workers=2, scheduler="tensor",
                 _system_config={"worker_mode": "process",
                                 "object_store_memory": 32 * 1024 * 1024})
        try:
            arena, found = lint_arena(san, ray)
            problems += found
        finally:
            ray.shutdown()
        observed = sorted(f"{a} -> {b}" for a, b in san.observed_edges())
        row, found = lint_report(san, san.last_report())
        problems += found
        emit({"phase": "lint", "part": "arena",
              "seconds": time.perf_counter() - t0, **arena,
              "observed_edges": observed, **row})
    finally:
        san.disarm()
        ray.shutdown()
    emit({"phase": "lint", "part": "done",
          "seconds": time.perf_counter() - t_phase, "ok": not problems,
          "nvidia_smi": smi})
    if problems:
        raise AssertionError(f"lint phase: {problems}")
    return launches


def width_table(kernel_rows, flash_rows, ring_rows, engine, train, ring,
                perf):
    """The kernels line's rows of every head width but 128: each kernel at
    each width (named <kernel>_d<D>), its bf16 time at phase kernel's shape
    for that width, and its launches on the paths that ran the width."""
    from ray_tpu_torch.ops import head_dims as hd

    csrc = "ray_tpu_torch/ops/csrc/"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = []
    for D in hd.PAGED_ATTENTION:
        if D == hd.DEFAULT_HEAD_DIM:
            continue
        row = kernel_rows[D]["bfloat16"]
        paths = {"engine_default" if D == 64 else "engine": engine[
            "default" if D == 64 else D]}
        if D == 16:
            paths.update(perf_serving_mono=perf["serving_mono"],
                         perf_serving_disagg=perf["serving_disagg"])
        rows.append({
            "name": f"paged_decode_attention_d{D}", "route": "cuda",
            "head_dim": D,
            "source": csrc + "paged_attention.cu",
            "replaces": "ray_tpu/ops/paged_attention.py:76",
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": row["max_abs_err"], "ms": row["device_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_device_ms"]})
    # Phi-3-mini's width, on its 128 class (phase kernel's row at its path
    # shape, ANY_PATH)
    row = kernel_rows[PHI3_HEAD_DIM]["bfloat16"]
    rows.append({
        "name": f"paged_decode_attention_d{PHI3_HEAD_DIM}", "route": "cuda",
        "head_dim": PHI3_HEAD_DIM, "width_class": hd.width_class(
            PHI3_HEAD_DIM),
        "source": csrc + "paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:76",
        "launches": engine[PHI3_HEAD_DIM],
        "launches_by_path": {"engine_phi3_mini": engine[PHI3_HEAD_DIM]},
        "max_abs_err": row["max_abs_err"], "ms": row["device_ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_device_ms"]})
    for D in (*hd.BLOCK_ATTENTION, PHI3_HEAD_DIM):
        if D == hd.DEFAULT_HEAD_DIM:
            continue
        full = ring_rows[D]["full"]
        rows.append({
            "name": f"ring_block_attention_d{D}", "route": "cuda",
            "head_dim": D,
            "source": csrc + "attention_fwd_sm90.cuh",
            "replaces": "ray_tpu/ops/ring_attention.py:64",
            "launches": ring[D], "launches_by_path": {"ring": ring[D]},
            "max_abs_err": max(r["max_abs_err"]
                               for r in ring_rows[D].values()),
            **{k: full[k] for k in keys + RING_ROW_KEYS}})
    lines = {"flash_fwd": 758, "flash_bwd_dq": 1456, "flash_bwd_dkv": 1121}
    for D in hd.FLASH:
        if D == hd.DEFAULT_HEAD_DIM:
            continue
        for name in FLASH_NAMES:
            row = flash_rows[D][name]["bfloat16"]
            sm90 = (D in hd.SM90_FORWARD if name == "flash_fwd"
                    else D in hd.SM90_BACKWARD)
            rows.append({
                "name": f"{name}_d{D}", "route": "cuda", "head_dim": D,
                "source": csrc + (("attention_fwd_sm90.cuh"
                                   if name == "flash_fwd"
                                   else "attention_bwd_sm90.cuh") if sm90
                                  else "mma_tiles.cuh"),
                "replaces": f"ray_tpu/ops/flash.py:42 (library "
                            f"flash_attention.py:{lines[name]})",
                "launches": train[D][name],
                "launches_by_path": {"train": train[D][name]},
                **{k: row[k] for k in ("max_abs_err", *keys)}})
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if "--rank" in sys.argv[1:]:
        # one rank of phase sharded: --rank r n dir
        i = sys.argv.index("--rank")
        rank, world, tmp = sys.argv[i + 1:i + 4]
        return sharded_rank(torch, int(rank), int(world), tmp)
    from ray_tpu_torch.ops import _build

    # cold: no library of these sources was built before this run (each
    # head width's library is its own nvcc, all started at once)
    cold = not any(_build.target(n).exists() for n in _build.sources())
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "cold": cold, "nvcc_processes": len(libs),
          "libraries": {n: str(p.relative_to(Path(__file__).resolve().parent))
                        for n, p in libs.items()},
          "ptxas": {n: _build.register_report(n) for n in libs}})
    sm90_build_check(_build, libs)

    smi = nvidia_smi()
    dev = torch.device("cuda", torch.cuda.current_device())
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(dev),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if "--phase" in sys.argv[1:]:
        # named later phases alone (each needs no earlier one), no ok line:
        # python3 chip_smoke.py --phase perf [ops multinode ...]
        names = sys.argv[sys.argv.index("--phase") + 1:]
        for name in names:
            globals()[f"phase_{name}"](torch, dev)
        print(smi, flush=True)
        return 0
    if "--kernels" in sys.argv[1:]:
        # the attention kernels' checks and times alone, no ok line
        failed = []
        for phase in (phase_kernel, phase_flash_kernel, phase_ring_kernel,
                      phase_sched_kernel):
            try:
                phase(torch, dev)
            except AssertionError as e:
                failed.append(str(e))
        print(smi, flush=True)
        return 1 if failed else 0

    # each phase's wall seconds, printed in phase end's line
    seconds = {"build": time.perf_counter() - t0}

    def run(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__.removeprefix("phase_")] = (
            time.perf_counter() - t)
        return out

    kernel_rows = run(phase_kernel, torch, dev)
    flash_rows = run(phase_flash_kernel, torch, dev)
    ring_rows = run(phase_ring_kernel, torch, dev)
    sched_rows = run(phase_sched_kernel, torch, dev)
    launches = run(phase_engine, torch)
    run(phase_parity, torch)
    run(phase_train_parity, torch)
    train_launches = run(phase_train, torch)
    ring_launches = run(phase_ring, torch, dev)
    sched_launches, star_rows = run(phase_north_star, torch, dev)
    assign = run(phase_runtime, torch)
    process_launches, process_assigns = run(phase_process, torch)
    served = run(phase_serve, torch)
    data_launches = run(phase_data, torch, dev)
    cluster_launches = run(phase_cluster, torch, dev)
    rllib_launches = run(phase_rllib, torch, dev)
    train_lib_launches = run(phase_train_lib, torch, dev)
    moe_launches = run(phase_moe, torch, dev)
    dag_launches = run(phase_dag, torch, dev)
    tune_launches = run(phase_tune, torch, dev)
    run(phase_workflow, torch, dev)
    multinode = run(phase_multinode, torch, dev)
    ops = run(phase_ops, torch, dev)
    perf = run(phase_perf, torch, dev)
    sharded = run(phase_sharded, torch, dev)
    lint_launches = run(phase_lint, torch, dev)

    # kernel 1 and its yardstick by device time (graph replays): the eager
    # loop of wrapper calls times the host, not the kernels
    main_row = kernel_rows[FLASH_D]["bfloat16"]
    table = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:76",
        "launches": (served["mono"]["paged_attention_launches"]
                     + served["disagg"]["paged_attention_launches"]),
        "launches_by_path": {
            "engine": launches["serve"],
            "process_engine_actor": process_launches,
            "serve_mono": served["mono"]["paged_attention_launches"],
            "serve_disagg": served["disagg"]["paged_attention_launches"],
            "multinode_engine_actor": multinode["engine_actor"],
            "ops_prod": ops["ops_prod"],
            "lint_engine_actor": lint_launches,
            **{f"perf_{k}": perf[k] for k in (
                "decode_64", f"decode_{PERF_DECODE_SLOTS}", "serving_mono",
                "serving_disagg")}},
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["device_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_device_ms"]}]
    # ray_tpu/ops/flash.py:42 reaches three pallas_calls of the library's
    # flash attention (jax/experimental/pallas/ops/tpu/flash_attention.py)
    replaces = {name: f"ray_tpu/ops/flash.py:42 (library flash_attention.py"
                      f":{line}, {what})" for name, line, what in (
                          ("flash_fwd", 758, "forward"),
                          ("flash_bwd_dq", 1456, "backward dq"),
                          ("flash_bwd_dkv", 1121, "backward dkv"))}
    # the bf16 kernels are instances of the sm90 templates, each built from
    # its .cu (the forward with that file's epilogue)
    sm90_source = "ray_tpu_torch/ops/csrc/attention_fwd_sm90.cuh"
    for name in FLASH_NAMES:
        row = flash_rows[FLASH_D][name]["bfloat16"]
        table.append({
            "name": name, "route": "cuda",
            "source": (sm90_source if name == "flash_fwd" else
                       "ray_tpu_torch/ops/csrc/attention_bwd_sm90.cuh"),
            "replaces": replaces[name],
            "launches": train_launches[FLASH_D][name],
            "launches_by_path": {
                "train": train_launches[FLASH_D][name],
                "moe": moe_launches[name],
                "dag": dag_launches if name == "flash_fwd" else 0,
                "tune": tune_launches[name],
                "client_forward": (multinode["client_forward"]
                                   if name == "flash_fwd" else 0),
                "ops_batch": ops["ops_batch"][name],
                "ops_job_forward": (ops["ops_job_forward"]
                                    if name == "flash_fwd" else 0),
                "perf_time_sinks": perf["time_sinks"][name]},
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}})
    # times and bound of the block below the diagonal (every key visible,
    # the most work); the error is the worst of the path's three blocks
    full = ring_rows[FLASH_D]["full"]
    table.append({
        "name": "ring_block_attention", "route": "cuda",
        "source": sm90_source,
        "replaces": "ray_tpu/ops/ring_attention.py:64",
        "launches": ring_launches[FLASH_D],
        # phase sharded: the sum over its ranks, each rank's own count in
        # the phase's line
        "launches_by_path": {"ring": ring_launches[FLASH_D],
                             **{f"sharded_{name}": sum(by_rank)
                                for name, by_rank in sharded.items()}},
        "max_abs_err": max(r["max_abs_err"]
                           for r in ring_rows[FLASH_D].values()),
        **{k: full[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms") + RING_ROW_KEYS}})
    table += width_table(kernel_rows, flash_rows, ring_rows, launches,
                         train_launches, ring_launches, perf)
    table += sched_table(sched_rows, star_rows, sched_launches)
    # the runtime's batched assignment (jax_assign's counterpart): its
    # launches on the runtime's cuda fan-out, its time at the median batch
    table.append({"name": "scheduler_assign", "route": "cuda",
                  "source": "ray_tpu_torch/ops/csrc/scheduler_tick.cu",
                  "replaces": "ray_tpu/_private/scheduler/kernels.py:652 "
                              "(XLA)",
                  **{k: assign[k] for k in ("launches", "max_abs_err", "ms",
                                            "plain_ms", "bound_ms",
                                            "bound_by")},
                  "launches_by_path": {"runtime_fanout": assign["launches"],
                                       "process_fanout": process_assigns,
                                       "data_thread": data_launches["thread"],
                                       "data_process":
                                           data_launches["process"],
                                       "cluster": cluster_launches,
                                       "rllib_thread":
                                           rllib_launches["thread"],
                                       "rllib_process":
                                           rllib_launches["process"],
                                       "train": train_lib_launches,
                                       "multinode": multinode["assign"],
                                       "ops": ops["ops"],
                                       "perf": perf["assign"]},
                  "library_ms": None})
    emit({"phase": "end", "phase_seconds": seconds,
          "seconds": time.perf_counter() - t0, **host_state()})
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
