"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no final line):

1. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
             with nvcc for sm_90a; print the build time and the card.
2. kernels — every kernel against its plain PyTorch version on the card,
             at its path's shapes, with stated tolerances (the LLM
             kernels: ssd_chunk at mamba2-370m with b 4, S 2048 and the
             padded S 2000, kernel and plain version each against the
             same function in f64;
             local_attn at gemma-2b, B 2, S 2048 in bf16 (the tensor-core
             route, ``ops.launches_tc``) and f32 (split tf32,
             ``ops.launches_tf32``), at RecurrentGemma's window 2048, S
             4096, at glm4-9b's training shape in bf16 (ATTN_D128: B 2, H
             32, KV 2, S 2048, D 128) and at launch.train's shape in f32
             (LAUNCH_ATTN: B 2, H 4, KV 1, S 64, D 64), each also against
             the same function in f64 (ATTN_F64_FACTOR), timed on both
             routes at gemma-2b's shape beside SDPA in the same dtype, at
             glm4-9b's and at launch.train's);
             the LSTM step's
             autograd.Function gradients against autograd of the plain
             cell; the whole-sequence LSTM kernels (forward and reverse
             scan) at the main path's shapes (B 8: T 672 with I 10, T 96
             with I 9; also B 1, 7, 26) against their plain versions, the
             forward against the chained step kernel bit for bit, the
             backward run twice bit for bit, and ``LSTMSeqFn``'s gradients
             against an f64 evaluation; the fold by leaves against the
             stacked fold bit for bit, one launch up to 64 trees; the
             stacked fold at N 1-130 (one launch up to 64 sets), T odd and
             T % 4 == 0 (its 16-byte route), bit for bit against the fold
             by leaves;
             ``ewc_update``'s bits on two runs (T not a multiple of 4,
             views off 16-byte alignment) and one device kernel a call;
             ``dp_clip_noise``'s bits on two runs on both routes (a
             cluster at T 141,953, a cooperative grid at (1<<20)+3) and on
             a view off alignment, and one device kernel a call (for
             both: one call captured in a CUDA graph is that one kernel,
             and torch.profiler counts one a call over 20 calls where it
             records the whole window);
             ssd_chunk with per-group B and C at two groups, n 160, p 80
             (chunks of 16 and 256) against its plain version and f64;
             local_attn at head dims 80 (f32, bf16) and 192 (bf16),
             zero-padded to 128 and 256, against f64 too; the forecaster
             at hidden 6, 132
             and 384 (the step route: 768 step launches, no sequence
             launch) forward and gradient against the CPU route; times of
             kernel (back to back, and its own device time from
             torch.profiler), plain version and library call (cuDNN's
             ``torch.lstm`` for the sequence, forward and forward +
             backward), and the sequence's serial floor; the backward
             kernels of ssd_chunk (mamba2-370m's training shape b 2, S
             2048 and the padded S 2000, and SSD_SHAPES) and of local_attn
             (gemma-2b's training shape in bf16 and f32, glm4-9b's in
             bf16, launch.train's in f32, the window 2048 at S 4096, head
             dims 80 and 192;
             bf16 at D 64-256 on the tensor-core route,
             ``ops.launches_bwd_tc``, every other call on the split-tf32
             route, ``ops.launches_bwd_tf32``), each against its
             plain VJP and the VJP in f64 (BWD_F64_FACTOR) and twice for
             the bits, local_attn's timed at gemma-2b's shape on both
             routes (bf16 wgmma, f32 split tf32), at glm4-9b's in bf16 and
             at launch.train's in f32, beside SDPA's forward + backward in
             the same dtype.
3. main    — ``run_fedccl_solar`` at the full SolarLSTMConfig width
             (hidden 128) on CUDA with the launch counters reset before and
             read after: every kernel of the path must have launched, the
             LSTM only on the sequence route (two forward scans per
             forecaster forward, two reverse scans per SGD step, no step
             kernel), one ``ewc_update`` launch per anchored SGD step,
             and Table II must be finite and inside the system test's
             bounds.
4. profile — one anchored SGD step at the main path's width: host time with
             and without the backward, device kernels by name and the
             device's idle share (``torch.profiler``).
5. privacy — the same run with DP clipping and noise and pairwise-mask
             secure aggregation (the committed report's privacy settings),
             counters reset before and read after: one ``dp_clip_noise``
             launch per update, one fold per secure round, the LSTM's
             launches as on the main path, every client's
             epsilon equal to the closed form, the non-federated Table II
             columns inside the bounds.
6. threaded — the threaded runtime (``FedCCLConfig(runtime="threaded")``)
             at the main path's full width, fleet, rounds and epochs, twice,
             counters reset before each run: with batched aggregation (a
             server drain thread; every model's round and samples exact,
             no queue left, no drain timeout; one more round profiled) and
             with secure aggregation and DP (barrier rounds; secure rounds,
             DP releases = ``dp_clip_noise`` launches, epsilon the closed
             form); the LSTM on the sequence route only.
7. sharded — the thread-sharded server (``FedCCLConfig(server_shards=2)``)
             at the main path's full width, fleet, rounds and epochs,
             counters reset before each counted run: the sim runtime
             batched (max_coalesce 8) against the same run on the flat
             store (stats equal but for the shard fields, metas equal,
             params within 1e-5 x max(1, max|p|), fold launches equal to
             the N-way sums the recorded folds imply); the same sim at
             hidden 16 on the card against the CPU (the CPU half in a
             child process that runs beside phases 7-13; checked at the
             end); the threaded runtime
             batched (two per-shard drain workers and a global one; exact
             accounting, one more round profiled beside the flat run's) and
             secure + DP (as in phase 6); one two-level fold of forecaster
             trees (3 shards x 9 updates, max_width 4, resets) against its
             plain version on CPU copies within 1e-6; the store stress of
             ``benchmarks/sharded_store.py`` (8 writers x 150 cluster and
             global submits, 16 clusters, the forecaster's tree) through
             the flat and the 4-shard store with exact accounting,
             submits/s reported; and ``save_store`` of the sharded store,
             the same bytes from the card as from a CPU copy, loaded back
             to the card bit for bit.
8. process — the process and TCP server tiers
             (``FedCCLConfig(server_processes=2)``, ``server_hosts``) at
             the main path's full width, fleet, rounds and epochs,
             counters reset before each counted run (one pair of
             subprocess shard servers serves phases 8-10): the sim runtime
             batched on the in-process emulation (its workers fold in this
             process) against the thread-sharded store at 2 shards (stats
             equal but for the process fields, metas equal, params within
             1e-5 x max(1, max|p|), fold launches equal to what the
             recorded folds imply, the process store's global merge and
             its workers' partial reductions included); the threaded
             runtime on two spawned workers folding on the card (their
             cold starts, their pids listed by nvidia-smi as compute
             processes, exact accounting with 0 drain timeouts and 0
             respawns), batched and secure + DP (the cluster rounds fold
             in the workers, the global ones here); two subprocess shard
             servers (``python -m repro_torch.launch.shard_server --device
             cuda --port 0``) under ``server_hosts`` with
             ``fetch_from_workers`` (fetch counts by kind, no fallback,
             fetched bytes equal to the store's) and an ``owner|replica``
             pair read after an ordered barrier; two shard servers on
             threads of this process (fold launches = implied, secure
             rounds = fold launches); and ``benchmarks/multiproc_store.py``'s
             mixed storm with the forecaster's tree on the process and the
             TCP store (submits/s, fetches/s, coalesce factor, wire bytes).
9. telemetry — ``FedCCLConfig(telemetry=True)`` and the stores' sinks,
             counters set to 0 before each counted run: the main path's
             sim at full width, batched, with telemetry on and off (Table
             II, clusters and ``async_stats`` bit-equal), its deterministic
             histograms (staleness, coalesce batch, queue depth) equal to
             the same sim's at hidden 16 on the card and on the CPU (the
             child of phase 7, after its first job; checked at the end);
             the threaded batched run on and off (exact accounting, the JSON report's
             histograms with ``drain_fold_ns_cuda``, a Prometheus page that
             parses, a trace with flow chains, wall times); the
             reference's telemetry-parity schedule through the flat, the
             4-shard, the 2-spawned-worker and the 2-server TCP store (the
             same staleness histogram, one submit and one enqueue event
             an update, 3 sites for the worker tiers, a submit's trace
             chain reaching a worker's fold); and the flat store stress's
             submits/s with telemetry off, on, on and off.
10. scenario — the scenario engine (``repro_torch.scenario``) on the card:
             ``diurnal_churn(100_000, 24, seed=3)`` on single, sharded,
             process (2 spawned CUDA workers) and tcp (2 ``--device cuda``
             servers, shared with phase 9) within the reference acceptance
             test's SLO bounds, equal across topologies, fold launches =
             implied where the folds run here, the single run equal to the
             CPU's; ``drift_ewc(5_000, 32)`` at the forecaster's width
             (141,953), lambda 25 and 0 on single and sharded, the four
             runs on four threads (``ewc_update`` launches = the runs'
             kernel calls, the EWC runs nearer their season-A anchors),
             and at width 1,024 against the CPU; a flash crowd with DP
             whose epsilon equals the CPU's.
11. llm     — batched scoring (``build_eval_step``) at full width in the
             configs' bf16 of every family, counters reset before and read
             after each run: mamba2-370m (4 x 2048 tokens) and gemma-2b
             (2 x 2048), deepseek-moe-16b (2 x 2048), recurrentgemma-9b
             (2 x 4096, so its 2048 window binds), hubert-xlarge (2 x
             4096 frames, bidirectional), deepseek-v3-671b at depth 4 (its
             3 dense layers and one MoE layer, MTP included, 2 x 2048),
             internvl2-76b at depth 8 of 80 (2 x (256 patches + 2048
             text)), and the dense configs at D 128, deepseek-7b, glm4-9b
             and granite-8b (2 x 2048): exactly one ``ssd_chunk`` launch a
             layer / one ``local_attn`` launch an attention-bearing block
             (48 / 18, 28, 12, 48, 4 + 1, 8, 30, 40, 36), every local_attn
             launch on its tensor-core
             route (``ops.launches_tc``), each cross entropy finite and
             within 2 of ln V, wall time, peak memory and (``profile``)
             the device's kernels by name; then greedy serving at full
             width in the configs' bf16 of the eight decoders (``serve``;
             deepseek-v3-671b at depth 4): ``generate`` and
             ``generate_ragged`` (examples/serve_batched.py's mix), no
             kernel launched (ragged equality held in f32 in phase 12).
12. agree  — small runs on CUDA (kernels) and on the CPU (plain versions)
             from the same initial weights, without privacy, with DP and
             secure aggregation, and with DP alone (at a smaller clip, see
             AGREE_DP_CLIP): Table II must agree;
             DP alone at the privacy path's clip, where Table II is chaotic:
             every release of the CUDA run against the plain version on the
             same inputs;
             a secure run with dropouts on both, which must recover
             dropped clients and end with the same parameters;
             and the threaded runtime's secure run with DP clipping (noise
             0): Table II must agree, stats and budgets be equal.
             The LLM path: decode by replay against the kernel forward (f32,
             full width, depth 4, T 64; recurrentgemma-9b at depth 3 over
             T 2112, its 2048-slot rolling cache wrapping) for every decoder
             family, no kernel launched (MoE at a capacity that drops
             nothing, ``dropless``; every local_attn launch of the f32
             forward on the split-tf32 route); ragged equal to independent
             decoding in f32 at that depth (``ragged``); and the CUDA loss
             and gradients (one backward launch a layer or attention block,
             every local_attn launch both ways on split tf32)
             against the CPU child's from the same weights and batch (f32,
             full width or ``narrow``'s, at ``agree``'s depth; the
             CPU half in the child of phase 7), every leaf within
             LLM_GRAD_RTOL.
13. example — ``examples/solar_forecasting_torch.py --out <tmp>`` as a
             subprocess on the card: exit 0, Table II printed and, in its
             ``solar_report.json``, finite and inside the system test's
             bounds.

14. train — language-model training at full width and depth in the
             configs' bf16 (``build_train_step``, AdamW), counters set to 0
             just before each step and read just after: mamba2-370m and
             gemma-2b, 3 steps each at B 2 x S 2048 on one
             ``llm_batch(structure=1.0)``, exactly one forward and one
             backward launch of ssd_chunk / local_attn a layer (gemma's
             forwards and backwards on the tensor-core routes), the loss
             falling, wall time, tokens/s, peak memory and the device's
             kernels by name;
             one anchored step of mamba2 (``ewc=``): one ``ewc_update``
             launch, its penalty equal to the plain ``ewc_penalty``; and
             ``examples/federated_llm_torch.py``'s ``federate`` with
             mamba2-370m at full width, 12 of 48 layers (FED_LLM_DEPTH;
             4 organisations, 2 rounds): the
             eval loss falls, FED_LLM_UPDATES updates, fold launches equal
             to what the recorded folds imply, the global model moved.
             Then ("train families", its own ``[time]`` line) four more
             families and the three dense configs at D 128 (deepseek-7b,
             glm4-9b, granite-8b) at full width in bf16 under
             ``remat="full"``,
             AdamW with bf16 moments, at their scoring shapes and their
             depth cuts (REMAT_TRAIN; the allocator's segments
             expandable): 3 steps each, exactly ``step_launches``' counts
             (two tensor-core local_attn forwards a scanned attention
             block, one an unrolled block, one backward a block), the loss
             falling, the peak leaving TRAIN_SPARE_GIB of the card; and a
             remat witness a family (of the three dense configs, glm4-9b's
             alone): a step under "none" and one under
             "full" from one state, the loss bit-equal, grad_norm within
             REMAT_GNORM_RTOL, every parameter within one bf16 rounding
             step, and less memory added by the forward and backward
             under "full".
15. distribution — the mesh rules, ``ClusterParallel`` and the launchers
             (counters set to 0 just before each run, read just after):
             gemma-2b at full width in bf16 scored (2 x 2048) with its
             parameters and tokens distributed by their specs
             (``shardings_from_schema``) on ``make_host_mesh()``'s (1, 1)
             mesh over an nccl world of one, ``rules=make_rules(mesh)``:
             logits bit-equal to the plain forward's, one tensor-core
             local_attn launch a layer (18); ``ClusterParallel`` with two
             mamba2-370m cluster models at full width and depth in bf16
             (AdamW, f32 moments), 2 x 2048 tokens a cluster, one step: 96
             forward and 96 backward ssd_chunk launches, each cluster's
             loss and parameters bit-equal to an independent
             ``build_train_step`` step, ``global_params`` at counts (1, 3)
             within one bf16 rounding step (relative 2^-8) of
             ``multi_aggregate`` (the fedavg_agg kernel) and equal
             clusters after ``broadcast_global``; and
             ``launch.train.main`` (reduced gemma-2b, 3 steps of 2 x 64:
             the f32 local_attn forward and backward kernels, 12 and 6
             launches) and ``launch.serve.main`` in process on the card.
             The process group is destroyed at the phase's end.
16. quickstart — ``examples/quickstart_torch.py`` (counters set to 0 just
             before each in-process run, read just after): (a) the user's
             command, ``--topology tcp --metrics --trace-out
             <tmp>/spans.json``, as a subprocess in the background (exit
             0; the example and its two ``--device cuda`` servers listed
             by nvidia-smi; assignments, ``async_stats``, both cluster
             metas, ``transport=tcp respawns=0`` and the join printed; a
             trace whose flow chains reach a server); (b) ``quickstart``
             on single, sharded and process (the sim's in-process
             emulation, as in the reference) at the example's size from
             weights drawn on the CPU: the same assignments, stats on the
             sim's keys, metas and join on the three and as (a) printed
             (but tcp's stats, whose lazy mirror sync defers updates),
             exactly one split-tf32 ``local_attn`` forward and one
             backward a layer a step (96 steps a run), fold launches =
             implied; each run against the CPU child's run of its
             topology (everything but params equal; params within
             QUICKSTART_RTOL x max(1, max|p|) or QUICKSTART_WITNESS times
             the CPU run's move under one ulp of its initial weights), and
             (a) against the CPU's tcp run; (c) gemma-2b at full width, 3
             of 18 layers (QUICKSTART_FULL_DEPTH: memory) in bf16 on the
             sharded store: 16 updates, (b)'s assignments, one tensor-core
             ``local_attn`` forward and backward a layer a step, fold
             launches = implied, the global model moved, the join's params
             the Vienna cluster model's; wall time, peak memory and the
             folds' share.
17. chaos  — the reference's chaos scenario (``regional_outage(5_000, 16,
             n_clusters=8, seed=11)``, a cluster migration at tick 6),
             run after phase 10 on that phase's servers, counters set to 0
             before each run: sharded (2 shards; fold launches = implied;
             everything but timings equal to the CPU child's run, params
             within 1e-5), tcp (the destination worker's session dropped at
             tick 6, server 0 killed at tick 10, gone from nvidia-smi's
             list, respawned on its port with ``--device cuda`` and listed
             again), process with 2 spawned CUDA workers (the destination
             worker killed at tick 6, gone from the list, its successor
             listed) at the reference's width and at the forecaster's
             (141,953; both stores built at once so the four cold starts
             overlap): ``cluster_migrations`` >= 1, ``respawns`` >= 1
             where something was killed, 0 lost updates and 0
             effective-round regressions; wall time, cold starts and wire
             bytes.

Each phase's wall time is printed as a ``[time]`` line.  The script
re-executes itself once with ``PYTHONHASHSEED=0``: the solar
fleet's weather is seeded with ``hash(site_id)`` (``data/solar.py``, as in
the reference), so a fixed hash seed makes every call run the same data.

The second-to-last lines are the kernels JSON object and the card's name
and power limit; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet) for the least-time bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12     # dense bf16 on the tensor cores
TF32_TC_FLOP_PER_S = 495e12     # dense tf32 on the tensor cores

# examples/solar_forecasting.py's default run (3 epochs) at the full
# SolarLSTMConfig width; the privacy path adds the committed
# artifacts/solar_report.json's privacy settings (PRIVACY)
MAIN_PATH = dict(hidden=128, n_sites=6, n_days=40, rounds=2, epochs=3,
                 n_independent=2, seed=0)
PRIVACY = dict(dp_clip=5.0, dp_noise_multiplier=0.3, secure_agg=True)
# DP without secure aggregation leaves each update's noise (std m * clip per
# weight) unaveraged; at clip 5 the federated models are chaotic: the CPU
# run against itself with the noise moved by 1 ulp drifts by pp
# (tools/torch_privacy_probe.py --witness).  Clip 0.1 keeps the agree run's
# noise small and its clip binding; the clip-5 run is held release by
# release instead (check_dp_releases).
AGREE_DP_CLIP = 0.1
TARGET_DELTA = 1e-5
AGREE_RUN = dict(hidden=16, n_sites=4, n_days=14, rounds=1, epochs=2,
                 n_independent=1, seed=0)
AGREE_PP = 0.1          # Table II agreement, percentage points
DROPOUT_ATOL = 1e-4     # dropout check: parameters, CUDA against the CPU
SOLAR_PARAMS = 141_953  # parameters of the forecaster at hidden 128
# hidden sizes the sequence kernels have no launch shape for (the step route)
LSTM_STEP_HIDDEN = (6, 132, 384)

KERNEL_META = {
    "fedavg_agg": ("src/repro_torch/kernels/csrc/fedavg_agg.cu",
                   "src/repro/kernels/fedavg_agg/fedavg_agg.py:34"),
    # the solar paths run the whole-sequence kernels; lstm_cell.cu is the
    # single-step API (its numbers are the step_* keys)
    "lstm_cell": ("src/repro_torch/kernels/csrc/lstm_seq.cu",
                  "src/repro/kernels/lstm_cell/lstm_cell.py:43"),
    "ewc_update": ("src/repro_torch/kernels/csrc/ewc_update.cu",
                   "src/repro/kernels/ewc_update/ewc_update.py:39"),
    "dp_clip_noise": ("src/repro_torch/kernels/csrc/dp_clip_noise.cu",
                      "src/repro/kernels/dp_clip_noise/dp_clip_noise.py:47"),
    "ssd_chunk": ("src/repro_torch/kernels/csrc/ssd_chunk.cu",
                  "src/repro/kernels/ssd_chunk/ssd_chunk.py:59"),
    # the LLM path's bf16 calls take the tensor-core kernel; f32 and head
    # dims 16, 32 take the split-tf32 route (ROUTE_META)
    "local_attn": ("src/repro_torch/kernels/csrc/local_attn_tc.cu",
                   "src/repro/kernels/local_attn/local_attn.py:90"),
    # the training path's gradients of the two LLM kernels (the Pallas
    # kernels have none; these replace the gradient of the function)
    "ssd_chunk_bwd": ("src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
                      "src/repro/kernels/ssd_chunk/ssd_chunk.py:59"),
    # bf16 (the path) on the tensor cores; f32 and head dims 16, 32 take
    # the split-tf32 route (ROUTE_META)
    "local_attn_bwd": ("src/repro_torch/kernels/csrc/local_attn_bwd_tc.cu",
                       "src/repro/kernels/local_attn/local_attn.py:90"),
}
# routes of a kernel above with a source of their own, each a kernels-line
# entry: (kernel, the prefix of its keys in that kernel's phase-2 result,
# source); its launches are path_counts()' / route_counts()' entry of the
# same name
ROUTE_META = {
    # aggregate_flat: the stacked fold (0 launches on the paths)
    "fedavg_agg_stacked": ("fedavg_agg", "stacked_",
                           "src/repro_torch/kernels/csrc/fedavg_agg.cu"),
    # f32 and bf16 at D 16, 32: launch.train's and phase 12's path
    "local_attn_tf32": ("local_attn", "f32_",
                        "src/repro_torch/kernels/csrc/local_attn_tf32.cu"),
    "local_attn_bwd_tf32": (
        "local_attn_bwd", "f32_",
        "src/repro_torch/kernels/csrc/local_attn_bwd_tf32.cu"),
}
# each wrapper's own CUDA kernels, as torch.profiler names them
KERNEL_SYMBOLS = {
    "fedavg_agg": ("fedavg_agg_kernel", "fedavg_agg_vec4_kernel",
                   "fedavg_agg_leaves_kernel"),
    "lstm_cell": ("lstm_cell_kernel", "lstm_seq_fwd_kernel",
                  "lstm_seq_bwd_kernel"),
    "ewc_update": ("ewc_update_kernel",),
    "dp_clip_noise": ("dp_clip_noise_cluster_kernel",
                      "dp_clip_noise_wide_kernel"),
    "ssd_chunk": ("ssd_chunk_tf32_kernel",),
    "local_attn": ("local_attn_tc_kernel", "local_attn_tf32_kernel"),
    "ssd_chunk_bwd": ("ssd_chunk_bwd_kernel", "ssd_chunk_bwd_fold_kernel"),
    "local_attn_bwd": ("local_attn_bwd_tc_dq_kernel",
                       "local_attn_bwd_tc_dkdv_kernel",
                       "local_attn_bwd_tf32_dq_kernel",
                       "local_attn_bwd_tf32_dkdv_kernel",
                       "local_attn_bwd_fold_kernel"),
}

@dataclass(frozen=True)
class LLMRow:
    """What the smoke runs of one LLM config (one row of ``LLM``)."""

    score: tuple            # phase 11's scoring batch: (batch, S)
    agree: tuple            # phase 12's CUDA-against-CPU case: (depth, S)
    kernel: str = "local_attn"  # the path's kernel, one launch a layer
    depth: int | None = None    # the card's depth cut (the width never)
    profile: bool = False   # scoring's device profile
    serve: bool = False     # bf16 serving at full width (phase 11)
    decode: tuple | None = None     # decode by replay: (depth, T)
    dropless: bool = False  # decode by replay at a capacity dropping nothing
    ragged: bool = False    # ragged == independent in f32 at the decode depth
    narrow: dict | None = None      # the CUDA-against-CPU case's narrowing
    patches: int | None = None      # the CUDA-against-CPU case's patches


# The LLM path: batched scoring (build_eval_step) and greedy serving
# (ServeEngine) at the full width of each config, weights random from the
# seed; every family of the repo: SSM, dense, MoE, the RG-LRU hybrid,
# audio, MLA with MTP, VLM.  One row an architecture:
# - score: recurrentgemma's S 4096 so that its 2048 window binds, hubert's
#   frames, internvl's 256 patches + 2048 text tokens; the three dense
#   configs at D 128 (deepseek-7b MHA 32 / 32, glm4-9b GQA 32 / 2 with
#   biased q/k/v, granite-8b GQA 32 / 8 at RoPE theta 1e7) at 2 x 2048;
# - depth: deepseek-v3-671b keeps its 3 dense layers and one MoE layer
#   (29.4 GiB in bf16), internvl2-76b 8 of its 80 (16.7 GiB); every other
#   config runs all its layers;
# - profile: the two full-depth decoders of the MoE and hybrid families,
#   and glm4-9b, the dense config with both the bias and GQA 16 (the
#   smoke's time, PERF.md §2; mamba2's and gemma-2b's scoring profiles are
#   in PERF.md §5);
# - serve: every decoder, in its config's bf16.  Serving holds ragged
#   decoding to independent decoding token for token at f32 weights
#   (ragged); in bf16 the batch size changes cuBLAS's reduction order and
#   the logits' bf16 rounding, so greedy ties may flip: bf16 serving is
#   timed, not compared.  Full-width f32 serving and bf16 independent
#   decoding went for the smoke's time (deepseek-moe-16b alone would take
#   61 GiB in f32).  The reference holds ragged == independent for
#   deepseek-v3-671b (tests/test_serving.py:47), the CPU tests for the
#   others;
# - decode: phase 12's decode by replay against the kernel forward, f32,
#   full width at a cut depth: 4 (deepseek-v3: its 3 dense layers and one
#   MoE layer), 3 for recurrentgemma (one whole (rec, rec, local_attn)
#   group) over T 2112, so that its window-sized rolling cache (2048)
#   wraps 64 times;
# - dropless: MoE decodes by replay at a capacity that drops nothing
#   (capacity_factor E / top_k makes the capacity every token), as the
#   reference's parity test runs (its reduced config's factor 8): at the
#   configs' 1.25 the forward's experts drop entries that single-token
#   decode steps keep, a difference of semantics, not of arithmetic;
# - agree: depth 2, deepseek-v3 4 (3 dense layers and one MoE layer, +
#   MTP), recurrentgemma 3 (one whole group); mamba2's S 520 is 3 SSD
#   chunks;
# - narrow: the CUDA-against-CPU case runs at full width where the CPU
#   child can carry it; six keep their heads, head dims, MLA ranks,
#   window, vocab, qkv_bias and RoPE theta but narrow d_model, d_ff and
#   the experts (the CPU child's time and memory: deepseek-v3 at depth 4
#   is 63 GB in f32; the three dense configs at depth 2 are 0.84-1.65 B
#   parameters, embeddings included, which this process would hold as
#   drawn cases beside the child's gradients, ~30 GB more in f32, and the
#   child would take an estimated ~100 s more; narrowed to d_model 1024
#   and a quarter of d_ff, 0.14-0.35 B).
LLM = {
    "mamba2-370m": LLMRow(score=(4, 2048), agree=(2, 520), kernel="ssd_chunk",
                          serve=True, decode=(4, 64), ragged=True),
    "gemma-2b": LLMRow(score=(2, 2048), agree=(2, 256), serve=True,
                       decode=(4, 64), ragged=True),
    "deepseek-moe-16b": LLMRow(score=(2, 2048), agree=(2, 256), profile=True,
                               serve=True, decode=(4, 64), dropless=True,
                               ragged=True),
    "recurrentgemma-9b": LLMRow(
        score=(2, 4096), agree=(3, 256), profile=True, serve=True,
        decode=(3, 2048 + 64), ragged=True,
        narrow=dict(d_model=1024, d_ff=3072, rglru=dict(lru_width=1024))),
    "hubert-xlarge": LLMRow(score=(2, 4096), agree=(2, 256)),
    "deepseek-v3-671b": LLMRow(
        score=(2, 2048), agree=(4, 128), depth=4, serve=True, decode=(4, 64),
        dropless=True, ragged=True,
        narrow=dict(d_model=1024, d_ff=512, moe=dict(
            n_routed_experts=16, moe_d_ff=512, dense_d_ff=2048))),
    "internvl2-76b": LLMRow(score=(2, 256 + 2048), agree=(2, 32 + 128),
                            depth=8, decode=(4, 64), patches=32,
                            narrow=dict(d_model=2048, d_ff=7168)),
    "deepseek-7b": LLMRow(score=(2, 2048), agree=(2, 256), serve=True,
                          decode=(4, 64), ragged=True,
                          narrow=dict(d_model=1024, d_ff=2752)),
    "glm4-9b": LLMRow(score=(2, 2048), agree=(2, 256), profile=True,
                      serve=True, decode=(4, 64), ragged=True,
                      narrow=dict(d_model=1024, d_ff=3424)),
    "granite-8b": LLMRow(score=(2, 2048), agree=(2, 256), serve=True,
                         decode=(4, 64), ragged=True,
                         narrow=dict(d_model=1024, d_ff=3584)),
}
SERVE_PROMPTS, SERVE_NEW = (4, 12), 16          # examples/serve_batched.py
RAGGED_LENS = (5, 11, 23)
LLM_DECODE_RTOL = 2e-4
LLM_AGREE_LOSS = 1e-4
# examples/federated_llm_torch.py's run (4 organisations, 2 rounds): its
# update count, which tests/test_torch_train.py finds equal for the same
# specs and rounds against examples/federated_llm.py (the schedule does not
# depend on the width)
FED_LLM_UPDATES = 16
# that run's mamba2-370m at full width cut to 12 of its 48 layers (the
# smoke's time; the schedule, the folds and the updates do not depend on
# depth)
FED_LLM_DEPTH = 12
KERNEL_RTOL = 2e-5      # f32 kernel vs plain at path shapes, x max(1, |plain|)
# ssd_chunk is also held against the same function in f64: the kernel may
# sit at most SSD_F64_FACTOR times as far from it as its f32 plain version
# (dA_cum reaches ~200, where an f32 ulp is 1.5e-5, so the order of the
# in-chunk scan shows there), and the whole chunked scan within
# KERNEL_RTOL * max|f64| of the f64 scan (the plain oracle's own scan
# rounds in another order)
SSD_F64_FACTOR = 2.0
# ssd_chunk past the shapes PR 15's kernel took: b, c, l, h, p, g, n
SSD_SHAPES = ((2, 4, 16, 8, 80, 2, 160), (1, 2, 256, 8, 80, 2, 160))
# local_attn's forward routes are held the same way: the output at most
# ATTN_F64_FACTOR times as far from the f64 answer as the plain version's
# output in the same dtype (bf16 on the tensor-core route, f32 and bf16 at
# D 16/32 on split tf32)
ATTN_F64_FACTOR = 2.0
# the backward kernels against their plain versions (the explicit VJPs):
# f32 within BWD_RTOL x max(1, max|plain|) (cuBLAS sums in another order;
# d(dA) is a reverse cumsum of sums that cancel), bf16 outputs within
# BWD_BF16_RTOL x max(1, max|plain|); and each output at most
# BWD_F64_FACTOR times as far from the VJP evaluated in f64 as the plain
# version's
BWD_RTOL, BWD_BF16_RTOL, BWD_F64_FACTOR = 1e-4, 2e-2, 2.0
# launch.train's attention (phase 15): reduced gemma-2b in f32 (H 4, KV 1,
# D 64) at LAUNCH_TRAIN's batch 2 and seq 64, causal, no window: the f32
# forward and backward routes at their D=64 instantiation (B, H, KV, S, D)
LAUNCH_ATTN = (2, 4, 1, 64, 64)
# glm4-9b's training shape (LLM_TRAIN's batch, its heads): 16 query heads a
# kv head at D 128 on the tensor-core routes (B, H, KV, S, D), causal, bf16
ATTN_D128 = (2, 32, 2, 2048, 128)
ATTN_D128_SHAPE = ("B={}, H={}, KV={}, S={}, D={}, causal, bf16 (glm4-9b's "
                   "training shape)".format(*ATTN_D128))
# local_attn's backward: (B, H, KV, S, D, causal, window, dtype): gemma-2b's
# training shape in bf16 (the path) and f32, launch.train's shape in f32,
# RecurrentGemma's window 2048 at S 4096 (in bf16 its training's shape on
# the tensor-core route), head dims 80 and 192 (zero-padded to 128 and
# 256), and glm4-9b's training shape (ATTN_D128)
ATTN_BWD_CASES = ((2, 8, 1, 2048, 256, True, 0, "bfloat16"),
                  (*ATTN_D128, True, 0, "bfloat16"),
                  (2, 8, 1, 2048, 256, True, 0, "float32"),
                  (*LAUNCH_ATTN, True, 0, "float32"),
                  (1, 16, 1, 4096, 256, True, 2048, "float32"),
                  (1, 16, 1, 4096, 256, True, 2048, "bfloat16"),
                  (1, 16, 16, 1024, 80, False, 0, "float32"),
                  (1, 16, 16, 1024, 80, False, 0, "bfloat16"),
                  (1, 16, 16, 1024, 192, True, 0, "bfloat16"))
# phase 14: training at full width in the configs' bf16, three AdamW steps
# on one batch each (batch, S: the family's scoring shape); moments in bf16
# but mamba2's (the reference's moment_dtype, for the 80 GB: f32 moments,
# old and new, would be 40 GB beside gemma-2b's 2.5 B parameters and their
# f32 gradients and updates)
LLM_TRAIN = {"mamba2-370m": (2, 2048), "gemma-2b": (2, 2048),
             "deepseek-moe-16b": (2, 2048), "recurrentgemma-9b": (2, 4096),
             "hubert-xlarge": (2, 4096), "internvl2-76b": (2, 256 + 2048),
             "deepseek-7b": (2, 2048), "glm4-9b": (2, 2048),
             "granite-8b": (2, 2048)}
TRAIN_STEPS, TRAIN_LR = 3, 3e-4
TRAIN_MOMENTS = {arch: "float32" if arch == "mamba2-370m" else "bfloat16"
                 for arch in LLM_TRAIN}
# the MoE, hybrid, audio and VLM families and the three dense configs at
# D 128 train under remat "full" at the deepest depth whose step leaves
# TRAIN_SPARE_GIB of the card free, in whole repeated units (train_unit),
# hubert-xlarge at its full 48, the allocator's segments expandable
# (tools/train_memory.py measures the depths; AdamW's update holds ~20
# bytes a parameter at the step's peak, PERF.md §6): (depth, the remat
# witness's depth, where a step under "none" fits beside the parameters
# the witness keeps, or None: no witness, AdamW's rate).  remat has no
# code that depends on the family, so of the three dense configs glm4-9b
# alone (the bias and GQA 16) runs a witness (the smoke's time).  The
# rates: at
# 1e-5 each of the first three families' three losses fell at its depth in
# the probe (at 3e-4 deepseek-moe's and hubert's rose); internvl2's at
# 3e-6, the largest of the probe's rates at which they fell: AdamW's first
# step moves every weight by ~lr, and its q/k/v start at std
# 1/sqrt(8192 x 64) (the fan-in counts the head axis, as the reference's
# initializer does), so at 1e-5 its loss rose from 12.72 to 18.86.  The
# three dense configs at d_model 4096: 1e-6, the largest of the probe's
# rates (3e-4 to 3e-7) at which each one's three losses fell; at 3e-6 the
# second loss rose or the third did (deepseek-7b 12.28, 16.30, 9.38): a
# scanned stack's fan-in also counts its layer axis, so glm4-9b's q
# starts at std 1/sqrt(12 x 4096 x 32) at its depth 12
REMAT_TRAIN = {"deepseek-moe-16b": (6, 5, 1e-5),
               "recurrentgemma-9b": (6, 3, 1e-5),
               "hubert-xlarge": (48, 48, 1e-5),
               "internvl2-76b": (1, 1, 3e-6),
               "deepseek-7b": (14, None, 1e-6),
               "glm4-9b": (12, 11, 1e-6),
               "granite-8b": (15, None, 1e-6)}
TRAIN_SPARE_GIB = 4.0
# configs whose training needs more than one card: deepseek-v3-671b's
# smallest depth with a MoE layer is 15.8 B parameters (ROADMAP §1 item 6)
MULTI_CARD_TRAIN = frozenset({"deepseek-v3-671b"})
# the remat witness: one step under "full" against one under "none" from
# the same state, grad_norm within REMAT_GNORM_RTOL, every parameter within
# one bf16 rounding step (relative 2^-8 of the larger value)
REMAT_GNORM_RTOL = 1e-6
EWC_LAMBDA = 10.0
EWC_PENALTY_RTOL = 1e-5
# phase 12: the CUDA gradients of the depth-2 f32 models against the CPU's
# (the child's), every leaf within LLM_GRAD_RTOL x max(1, max|g_cpu|)
LLM_GRAD_RTOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean time of one call, back to back, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_events(fn, symbols, iters: int, warmup: int) -> tuple[list, int]:
    """torch.profiler's device events of the kernels named by ``symbols``
    over ``iters`` calls of ``fn``, and the count of all device events."""
    import torch
    from torch.autograd import DeviceType

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return [e for e in events if any(sym in e.name for sym in symbols)], \
        len(events)


def graph_nodes(fn) -> list[str]:
    """What one call of ``fn`` puts on the card, without a profiler: the
    call captured in a CUDA graph, one entry a node of it, each the text
    CUDA's debug dump gives the node (its kind, a kernel's symbol)."""
    import re
    import tempfile
    import warnings

    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()            # scratch a wrapper keeps per stream, made uncaptured
    stream.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)   # the dump reads it
    graph.enable_debug_mode()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "call.dot")
        with warnings.catch_warnings():     # torch announces the dump
            warnings.simplefilter("ignore")
            graph.debug_dump(path)
        require(os.path.exists(path), "CUDA graph debug dump wrote nothing")
        text = Path(path).read_text()
    graph.reset()
    # a node is declared as "graph_<g>_node_<n>"[...]; an edge has "->"
    starts = [m.start() for m in
              re.finditer(r'"graph_\d+_node_\d+"\s*\[', text)]
    return [text[a:b] for a, b in zip(starts, starts[1:] + [len(text)])]


def require_one_kernel_a_call(name, fn, calls: int = 20,
                              windows: int = 4) -> float:
    """Hold that a call of ``fn`` is one device kernel of ``name``'s own
    and nothing else: one call captured in a CUDA graph is one node, that
    kernel; and torch.profiler's device events over ``calls`` calls are
    ``calls`` events, each that kernel.  A profiler window that records
    fewer events than calls has missed records (CUPTI can drop a window's
    kernels; the calls ran, their outputs are held above): the window is
    taken again, up to ``windows`` times, and the graph carries the
    proof if no window is whole.  Returns the kernels a call: the whole
    window's, else the graph's."""
    symbols = KERNEL_SYMBOLS[name]
    nodes = graph_nodes(fn)
    require(len(nodes) == 1 and any(s in nodes[0] for s in symbols),
            f"{name}: one call captured in a CUDA graph is {len(nodes)} "
            f"nodes, expected one kernel of {symbols}: "
            f"{[n[:160] for n in nodes]}")
    for window in range(1, windows + 1):
        own, events = device_events(fn, symbols, iters=calls, warmup=1)
        print(f"[kernels] {name}: one call is one graph node, its kernel; "
              f"profiler window {window}: {len(own)} kernel launches in "
              f"{calls} calls ({events} device events in all)")
        if events >= calls:
            require(len(own) == calls and events == calls,
                    f"{name}: {len(own)} of its kernels and {events} device "
                    f"events in {calls} calls, expected one each")
            return len(own) / calls
    print(f"[kernels] {name}: the profiler missed records in {windows} "
          "windows; the graph capture holds the one kernel a call")
    return float(len(nodes))


def device_ms(name, fn, iters: int = 50, warmup: int = 3,
              symbols=None) -> float | None:
    """The device time of one call's own kernels (``symbols``, by default
    ``KERNEL_SYMBOLS[name]``), from torch.profiler's device events over
    ``iters`` calls; None (and a line saying so) when the profiler records
    no device time."""
    symbols = symbols or KERNEL_SYMBOLS[name]
    own, n_events = device_events(fn, symbols, iters, warmup)
    if not own:
        print(f"[kernels] {name}: the profiler recorded no device time of "
              f"{symbols} ({n_events} device events)")
        return None
    return sum(e.time_range.elapsed_us() for e in own) / iters / 1e3


def bound(nbytes: float, flops: float,
          flop_rate: float = F32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 1
def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    path = build.build()
    build.library()
    print(f"[build] {path.name} ready in {time.perf_counter() - t0:.1f} s")
    log = build.BUILD_DIR / "build.log"
    if log.is_file():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                print(f"[build] {line.strip()}")
    print(f"[build] card: {card_line()}")


# ------------------------------------------------------------------ phase 2
def check_fedavg(dev, gen):
    """The stacked fold (``aggregate_flat``: one launch up to 64 sets,
    ordered chunks past them) at N 1-130 and T 141,953 (odd: the scalar
    loop) and 141,952 (T % 4 == 0: the 16-byte route): within 1e-6 of
    ``agg_ref``, bit for bit the fold by leaves of the same rows (the same
    FMAs in set order, chunks as ``fold_chunks``), zero-weight padding
    exact; timed at N 2 on both T beside ``w @ stacked``."""
    import torch
    from repro_torch.core.aggregation import _pad_pow2
    from repro_torch.kernels.fedavg_agg import ops
    from repro_torch.kernels.fedavg_agg.ref import agg_ref

    err = 0.0
    for t in (SOLAR_PARAMS, SOLAR_PARAMS - 1):
        for n in (1, 2, 3, 4, 32, 64, 65, 128, 130):
            x = torch.randn(n, t, generator=gen, device=dev)
            w = torch.rand(n, generator=gen, device=dev)
            ws = (w / w.sum()).tolist()
            before = ops.launches_stacked
            got = ops.aggregate_flat(x, ws)
            launches = ops.launches_stacked - before
            require(launches == 1 + max(0, -(-(n - ops.MAX_N)
                                             // (ops.MAX_N - 1))),
                    f"fedavg_agg stacked N={n}: {launches} launches")
            require(torch.equal(got, ops.aggregate_leaves(
                [[row] for row in x], ws)), f"fedavg_agg stacked N={n} "
                f"T={t}: other bits than the fold by leaves")
            err = max(err, (got - agg_ref(x, ws)).abs().max().item())
            if n in (2, 3, 32):
                # zero-weight power-of-two padding must not move the result
                rows, pws = _pad_pow2(list(x), ws)
                require(torch.equal(ops.aggregate_flat(torch.stack(rows),
                                                       pws), got),
                        f"fedavg_agg stacked N={n}: padding moved the fold")
    require(err <= 1e-6, f"fedavg_agg max abs err {err} > 1e-6")
    print(f"[kernels] fedavg_agg stacked: N 1-130 at T {SOLAR_PARAMS} and "
          f"{SOLAR_PARAMS - 1} bit for bit the fold by leaves, max abs err "
          f"{err:.3e} against agg_ref (limit 1e-6)")
    out = {}
    for t, key in ((SOLAR_PARAMS, ""), (SOLAR_PARAMS - 1, "t4_")):
        x = torch.randn(2, t, generator=gen, device=dev)
        ws = [0.375, 0.625]
        w_row = torch.tensor([ws], device=dev)
        symbol = "fedavg_agg_vec4_kernel" if key else "fedavg_agg_kernel"
        out.update({
            f"{key}ms": cuda_ms(lambda: ops.aggregate_flat(x, ws)),
            f"{key}device_ms": device_ms(
                "fedavg_agg", lambda: ops.aggregate_flat(x, ws),
                symbols=(symbol,)),
            f"{key}library_ms": cuda_ms(lambda: torch.matmul(w_row, x))})
    t = SOLAR_PARAMS
    nbytes, flops = (2 * t + t) * 4, 2 * 2 * t
    bms, by = bound(nbytes, flops)
    x = torch.randn(2, t, generator=gen, device=dev)
    return {"max_abs_err": err, "shape": f"N=2, T={t} (t4_ keys: T={t - 1})",
            **out, "plain_ms": cuda_ms(lambda: agg_ref(x, [0.375, 0.625])),
            "bound_ms": bms, "bound_by": by}


def lstm_inputs(dev, gen, b, i, h):
    import torch

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale
    return (r(b, i), r(b, h), r(b, h), r(i, 4 * h, scale=0.1),
            r(h, 4 * h, scale=0.1), r(4 * h, scale=0.1))


def check_lstm(dev, gen):
    import torch
    from repro_torch.kernels.lstm_cell import ops
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref

    hid = 128
    err = 0.0
    for b in (1, 7, 8, 26):
        for i in (9, 10):
            args = lstm_inputs(dev, gen, b, i, hid)
            hk, ck = ops.lstm_step(*args)
            hr, cr = lstm_cell_ref(*args)
            err = max(err, (hk - hr).abs().max().item(),
                      (ck - cr).abs().max().item())
    require(err <= 1e-5, f"lstm_cell max abs err {err} > 1e-5")

    # the autograd.Function on CUDA against autograd of the plain cell
    args = [a.requires_grad_() for a in lstm_inputs(dev, gen, 8, 10, hid)]
    wts = (torch.randn(8, hid, generator=gen, device=dev),
           torch.randn(8, hid, generator=gen, device=dev))
    hk, ck = ops.LSTMCellFn.apply(*args)
    gk = torch.autograd.grad((hk * wts[0]).sum() + (ck * wts[1]).sum(), args)
    hr, cr = lstm_cell_ref(*args)
    gr = torch.autograd.grad((hr * wts[0]).sum() + (cr * wts[1]).sum(), args)
    gerr = max(((a - b).abs() - 1e-4 * b.abs()).max().item()
               for a, b in zip(gk, gr, strict=True))
    require(gerr <= 1e-5, f"LSTMCellFn gradients off by {gerr} beyond "
                          "rtol 1e-4")
    print(f"[kernels] LSTMCellFn grads vs autograd of the plain cell: "
          f"max(|d| - 1e-4*|ref|) = {gerr:.3e} (limit 1e-5)")

    b, i = 8, 10
    x, h, c, wx, wh, bias = lstm_inputs(dev, gen, b, i, hid)
    w_ih, w_hh = wx.T.contiguous(), wh.T.contiguous()
    b_ih = bias.clone()
    b_ih[hid:2 * hid] += 1.0          # the reference's +1 forget-gate bias
    b_hh = torch.zeros_like(bias)
    hl, cl = torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)
    hk, ck = ops.lstm_step(x, h, c, wx, wh, bias)
    require(max((hl - hk).abs().max().item(), (cl - ck).abs().max().item())
            <= 1e-5, "torch.lstm_cell yardstick computes another function")
    nbytes = 4 * (b * i + 2 * b * hid + (i + hid) * 4 * hid + 4 * hid
                  + 2 * b * hid)
    flops = 2 * b * (i + hid) * 4 * hid
    bms, by = bound(nbytes, flops)
    return {"max_abs_err": err, "shape": f"B={b}, I={i}, H={hid}",
            "ms": cuda_ms(lambda: ops.lstm_step(x, h, c, wx, wh, bias)),
            "device_ms": device_ms(
                "lstm_cell", lambda: ops.lstm_step(x, h, c, wx, wh, bias),
                symbols=("lstm_cell_kernel",)),
            "plain_ms": cuda_ms(lambda: lstm_cell_ref(x, h, c, wx, wh, bias)),
            "library_ms": cuda_ms(
                lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)),
            "bound_ms": bms, "bound_by": by}


def check_fedavg_leaves(dev, gen):
    """The fold by leaves, as ``aggregate_pytrees`` runs it on the solar
    paths: forecaster trees at hidden 128 (8 leaves, 141,953 parameters)."""
    import torch
    from repro_torch.configs.solar_lstm import SolarLSTMConfig
    from repro_torch.kernels.fedavg_agg import ops
    from repro_torch.kernels.fedavg_agg.ref import agg_leaves_ref
    from repro_torch.models.lstm import SolarForecaster
    from repro_torch.utils.tree import (
        flatten_params,
        tree_leaves,
        unflatten_params,
    )

    fc = SolarForecaster(SolarLSTMConfig(hidden_size=MAIN_PATH["hidden"]))

    def trees(n):
        return [fc.init(gen, dev) for _ in range(n)]
    err = 0.0
    for n in (2, 3, 8, 64, 70, 128):
        ts = trees(n)
        w = torch.rand(n, generator=gen, device=dev)
        ws = (w / w.sum()).tolist()
        before = ops.launches_leaves
        got = flatten_params(ops.aggregate_pytrees(ts, ws))
        want = 1 + max(0, -(-(n - ops.MAX_N) // (ops.MAX_N - 1)))
        require(ops.launches_leaves - before == want, f"fedavg_agg by "
                f"leaves at N={n}: {ops.launches_leaves - before} launches, "
                f"expected {want}")
        stacked = torch.stack([flatten_params(t) for t in ts])
        require(torch.equal(got, ops.aggregate_flat(stacked, ws)),
                f"fedavg_agg by leaves at N={n} differs from the stacked "
                "fold")
        err = max(err, (got - agg_leaves_ref([tree_leaves(t) for t in ts],
                                              ws)).abs().max().item())
        del ts, stacked
    require(err <= 1e-6, f"fedavg_agg by leaves: max abs err {err} > 1e-6")
    print("[kernels] fedavg_agg by leaves at N 2, 3, 8, 64, 70, 128: equal "
          "to the stacked fold bit for bit; one launch up to 64 trees")
    ts = trees(2)
    ws = [0.375, 0.625]
    w_row = torch.tensor([ws], device=dev)
    t = SOLAR_PARAMS
    stacked = torch.stack([flatten_params(x) for x in ts])
    bms, by = bound((2 * t + t) * 4, 2 * 2 * t)
    return {"max_abs_err": err, "shape": f"N=2 trees, T={t}, 8 leaves",
            "ms": cuda_ms(lambda: ops.aggregate_pytrees(ts, ws)),
            "device_ms": device_ms(
                "fedavg_agg", lambda: ops.aggregate_pytrees(ts, ws),
                symbols=("fedavg_agg_leaves_kernel",)),
            "plain_ms": cuda_ms(lambda: agg_leaves_ref(
                [tree_leaves(x) for x in ts], ws)),
            # the library route from the same trees: flatten, stack, GEMV
            "library_ms": cuda_ms(lambda: w_row @ torch.stack(
                [flatten_params(x) for x in ts])),
            "stacked_library_ms": cuda_ms(lambda: w_row @ stacked),
            # PR 14's aggregate_pytrees: flatten, stack, fold, unflatten
            "stacked_trees_ms": cuda_ms(lambda: unflatten_params(
                ops.aggregate_flat(torch.stack(
                    [flatten_params(x) for x in ts]), ws), ts[0])),
            "bound_ms": bms, "bound_by": by}


def seq_inputs(dev, gen, b, i, t, h):
    import torch

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale
    return (r(t, b, i), r(b, h, scale=0.5), r(b, h, scale=0.5),
            r(i, 4 * h, scale=0.1), r(h, 4 * h, scale=0.1),
            r(4 * h, scale=0.1))


def cudnn_lstm(args):
    """``torch.nn.LSTM`` (cuDNN) holding the same weights: w_ih = Wxᵀ,
    w_hh = Whᵀ, the reference's +1 on the forget quarter of b_ih.  Returns
    (module, call) with call() -> (ys, hT, cT)."""
    import torch

    xs, h0, c0, wx, wh, b = args
    hid = h0.shape[1]
    lstm = torch.nn.LSTM(wx.shape[0], hid).to(xs.device)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(wx.T)
        lstm.weight_hh_l0.copy_(wh.T)
        b_ih = b.clone()
        b_ih[hid:2 * hid] += 1.0
        lstm.bias_ih_l0.copy_(b_ih)
        lstm.bias_hh_l0.zero_()
    lstm.flatten_parameters()

    def call():
        ys, (h, c) = lstm(xs, (h0[None], c0[None]))
        return ys, h[0], c[0]
    return lstm, call


def seq_bounds(t, b, i, h) -> dict:
    """Least times of the sequence forward and backward (bytes: each input
    read once, each output written once; operations: the gate products, f32
    on the CUDA cores)."""
    fwd_bytes = 4 * (t * b * i + 2 * b * h + (i + h) * 4 * h + 4 * h
                     + 2 * t * b * h + t * b * 4 * h + 2 * b * h)
    fwd_flops = 2 * t * b * (i + h) * 4 * h
    bwd_bytes = 4 * (t * b * h + 2 * b * h + t * b * 4 * h + t * b * h
                     + b * h + h * 4 * h + t * b * 4 * h + 2 * b * h)
    bwd_flops = 2 * t * b * 4 * h * h
    return {"fwd": bound(fwd_bytes, fwd_flops),
            "bwd": bound(bwd_bytes, bwd_flops)}


def serial_floor_ms(t, i, h) -> tuple[float, float]:
    """(floor, per-step exchange) of a T-step scan at input I, width H:
    T x (one step's exchange of h, wait and gate arithmetic, measured as
    the time a step takes in a scan whose products are nearly empty: B 1,
    I 1, H 32 on the same cluster size as H (its chain is 33 FMAs long);
    plus the rest of the step's chain of I + H dependent FMAs at 4 cycles
    each and the card's top SM clock)."""
    import torch
    from repro_torch.kernels.lstm_cell import ops

    require(ops.seq_cluster(32, 1) == ops.seq_cluster(h, i),
            "the serial floor's probe runs on another cluster size")
    gen = torch.Generator(device="cuda").manual_seed(9)
    tiny = seq_inputs("cuda", gen, 1, 1, t, 32)
    per_step = cuda_ms(lambda: ops.lstm_seq_fwd(*tiny, save=False),
                       iters=20) / t
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    chain_ms = (i + h - 33) * 4 / clock_hz * 1e3
    return t * (per_step + chain_ms), per_step


def check_lstm_seq(dev, gen):
    import torch
    from repro_torch.kernels.lstm_cell import ops
    from repro_torch.kernels.lstm_cell.ref import lstm_seq_bwd_ref, lstm_seq_ref

    hid = 128
    err = 0.0
    for b in (1, 7, 8, 26):
        for i, t in ((10, 672), (9, 96)):       # encoder, decoder
            args = seq_inputs(dev, gen, b, i, t, hid)
            fwd = ops.lstm_seq_fwd(*args)
            for what, got, want in zip(("ys", "c", "gates", "hT", "cT"), fwd,
                                       lstm_seq_ref(*args), strict=True):
                e, lim = rel_err(got, want)
                require(e <= lim, f"lstm_seq forward B={b} T={t} {what}: "
                                  f"max abs err {e} > {lim}")
                err = max(err, e)
            h, c = args[1], args[2]
            for step in range(t):               # the chained step kernel
                h, c = ops.lstm_step(args[0][step], h, c, *args[3:])
                require(torch.equal(fwd[0][step], h), f"lstm_seq forward "
                        f"B={b} T={t}: step {step} differs from the step "
                        "kernel")
            require(torch.equal(fwd[3], h) and torch.equal(fwd[4], c),
                    f"lstm_seq forward B={b} T={t}: final state differs")
            # the decoder's ys reach the loss, the encoder's do not
            dys = (torch.randn(t, b, hid, generator=gen, device=dev)
                   if i == 9 else None)
            dh, dc = (torch.randn(b, hid, generator=gen, device=dev)
                      for _ in range(2))
            bargs = (dys, dh, dc, fwd[2], fwd[1], args[2], args[4])
            got = ops.lstm_seq_bwd(*bargs)
            for what, g, w in zip(("da", "dh0", "dc0"), got,
                                  lstm_seq_bwd_ref(*bargs), strict=True):
                e, lim = rel_err(g, w)
                require(e <= lim, f"lstm_seq backward B={b} T={t} {what}: "
                                  f"max abs err {e} > {lim}")
                err = max(err, e)
            require(all(torch.equal(x, y) for x, y in
                        zip(got, ops.lstm_seq_bwd(*bargs), strict=True)),
                    f"lstm_seq backward B={b} T={t}: two runs differ")
    print(f"[kernels] lstm_seq at B 1, 7, 8, 26 (T 672 I 10, T 96 I 9, H "
          f"128): forward and backward within {KERNEL_RTOL} x max(1, "
          f"|plain|) of their plain versions (max abs err {err:.3e}); the "
          "forward equal to the chained step kernel bit for bit; two "
          "backward runs equal bit for bit")

    # LSTMSeqFn's gradients against the same function in f64
    b, i, t = 8, 10, 672
    args = [a.requires_grad_() for a in seq_inputs(dev, gen, b, i, t, hid)]
    wy, wh_, wc_ = (torch.randn(*s, generator=gen, device=dev)
                    for s in ((t, b, hid), (b, hid), (b, hid)))

    def loss(ys, h, c):
        return (ys * wy).sum() + (h * wh_).sum() + (c * wc_).sum()
    gk = torch.autograd.grad(loss(*ops.LSTMSeqFn.apply(*args)), args)
    ys, _, _, h, c = lstm_seq_ref(*args)
    gr = torch.autograd.grad(loss(ys, h, c), args)
    a64 = [a.detach().double().requires_grad_() for a in args]
    ys, _, _, h, c = lstm_seq_ref(*a64)
    ge = torch.autograd.grad(loss(ys, h, c), a64)
    # the whole gradient against f64 as the whole SSD scan is held: within
    # KERNEL_RTOL x max|f64| (two f32 orders of the weight gradients' 5,376
    # products differ by more than a fixed atol)
    for name, k, p, e in zip(("xs", "h0", "c0", "wx", "wh", "b"), gk, gr, ge,
                             strict=True):
        dk, dp = f64_distance(k, e), f64_distance(p, e)
        print(f"[kernels] LSTMSeqFn d{name} (B 8, T 672): distance to f64 "
              f"(x max|f64|) kernels {dk:.3e}, plain f32 autograd {dp:.3e} "
              f"(limit {KERNEL_RTOL})")
        require(dk <= KERNEL_RTOL, f"LSTMSeqFn d{name}: {dk} x max|f64| "
                                   "from f64")

    # times at the main path's shapes
    enc = [a.detach() for a in args]
    dec = seq_inputs(dev, gen, b, 9, 96, hid)
    fwd = ops.lstm_seq_fwd(*enc)
    dh, dc = (torch.randn(b, hid, generator=gen, device=dev)
              for _ in range(2))
    bargs = (None, dh, dc, fwd[2], fwd[1], enc[2], enc[4])
    _, cudnn = cudnn_lstm(enc)
    lib = cudnn()
    lib_err = max((x - y).abs().max().item()
                  for x, y in zip(lib, (fwd[0], fwd[3], fwd[4]), strict=True))
    require(lib_err <= 1e-4, f"the cuDNN yardstick computes another "
                             f"function ({lib_err})")
    live = [a.detach().requires_grad_() for a in enc]

    def kernel_fwd_bwd():
        ys, h, c = ops.LSTMSeqFn.apply(*live)
        torch.autograd.grad(loss(ys, h, c), live)

    mod, call = cudnn_lstm(live)

    def cudnn_fwd_bwd():
        ys, h, c = call()
        torch.autograd.grad(loss(ys, h, c), [*live[:3], *mod.parameters()])
    bounds = seq_bounds(t, b, i, hid)
    floor, per_step = serial_floor_ms(t, i, hid)
    print(f"[kernels] lstm_seq serial floor at T {t}: {floor:.5f} ms ({t} x "
          f"({per_step * 1e3:.4f} us a step measured at B 1, I 1, H 32 + "
          f"{i + hid - 33} more FMAs of the {i + hid}-FMA chain)); card: "
          f"{card_line()}")
    dec_ms = cuda_ms(lambda: ops.lstm_seq_fwd(*dec), iters=50)
    return {"max_abs_err": err, "shape": f"B={b}, T={t}, I={i}, H={hid} "
                                         "(forward, saving for the backward)",
            "ms": cuda_ms(lambda: ops.lstm_seq_fwd(*enc), iters=50),
            "device_ms": device_ms("lstm_cell",
                                   lambda: ops.lstm_seq_fwd(*enc), iters=20,
                                   symbols=("lstm_seq_fwd_kernel",)),
            "plain_ms": cuda_ms(lambda: lstm_seq_ref(*enc), iters=3,
                                warmup=1),
            "library_ms": cuda_ms(cudnn, iters=20, warmup=3),
            "bound_ms": bounds["fwd"][0], "bound_by": bounds["fwd"][1],
            "serial_floor_ms": floor, "step_exchange_us": per_step * 1e3,
            "decoder_ms": dec_ms,
            "bwd_ms": cuda_ms(lambda: ops.lstm_seq_bwd(*bargs), iters=50),
            "bwd_device_ms": device_ms("lstm_cell",
                                       lambda: ops.lstm_seq_bwd(*bargs),
                                       iters=20,
                                       symbols=("lstm_seq_bwd_kernel",)),
            "bwd_plain_ms": cuda_ms(lambda: lstm_seq_bwd_ref(*bargs),
                                    iters=3, warmup=1),
            "bwd_bound_ms": bounds["bwd"][0], "bwd_bound_by": bounds["bwd"][1],
            "fwd_bwd_ms": cuda_ms(kernel_fwd_bwd, iters=20, warmup=3),
            "fwd_bwd_library_ms": cuda_ms(cudnn_fwd_bwd, iters=20, warmup=3)}


def check_ewc(dev, gen):
    import torch
    from repro_torch.kernels.ewc_update import ops
    from repro_torch.kernels.ewc_update.ref import ewc_ref

    t = SOLAR_PARAMS
    lam = 0.05
    err = 0.0
    # the path's T (float4 rows), T not a multiple of 4, and views whose
    # offset breaks 16-byte alignment (the scalar route); each with and
    # without a Fisher diagonal, run twice: the same bits
    for n, offset in ((t, 0), (t + 2, 0), (t, 1), (1027, 3)):
        g, p, a, f = (torch.randn(n + offset, generator=gen,
                                  device=dev)[offset:] for _ in range(4))
        for fisher in (None, f.abs()):
            go, loss = ops.ewc_penalty_grad_flat(lam, g, p, a, fisher)
            go2, loss2 = ops.ewc_penalty_grad_flat(lam, g, p, a, fisher)
            require(torch.equal(go, go2) and torch.equal(loss, loss2),
                    f"ewc_update T={n} offset {offset}: two runs differ")
            gr, lr = ewc_ref(lam, g, p, a, fisher)
            torch.testing.assert_close(go, gr, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(loss, lr, rtol=1e-4, atol=0.0)
            err = max(err, (go - gr).abs().max().item())
    print("[kernels] ewc_update: two runs bit-equal at T 141,953 and "
          "141,955, on views 4 and 12 bytes past 16-byte alignment, with "
          "and without a Fisher diagonal")
    g, p, a = (torch.randn(t, generator=gen, device=dev) for _ in range(3))
    per_call = require_one_kernel_a_call(
        "ewc_update", lambda: ops.ewc_penalty_grad_flat(lam, g, p, a))
    nbytes, flops = 4 * (3 * t + t), 5 * t
    bms, by = bound(nbytes, flops)
    return {"max_abs_err": err, "shape": f"T={t}, F=None",
            "ms": cuda_ms(lambda: ops.ewc_penalty_grad_flat(lam, g, p, a)),
            "device_ms": device_ms(
                "ewc_update", lambda: ops.ewc_penalty_grad_flat(lam, g, p, a)),
            "plain_ms": cuda_ms(lambda: ewc_ref(lam, g, p, a)),
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "launches_a_call": per_call}


def check_dp(dev, gen):
    import torch
    from repro_torch.kernels.dp_clip_noise import ops
    from repro_torch.kernels.dp_clip_noise.ref import dp_clip_noise_ref

    err = 0.0
    for t in (1, 5, 8192, SOLAR_PARAMS, (1 << 20) + 3):
        noise = torch.randn(t, generator=gen, device=dev)
        d = torch.randn(t, generator=gen, device=dev)
        for delta in (d * (3.0 / d.norm()), d * (0.25 / d.norm()),
                      torch.zeros_like(d)):     # clip 1.0 binds, not, zero
            for m in (0.0, 1.1):
                out = ops.privatize_flat(delta, noise, 1.0, m)
                err = max(err, (out - dp_clip_noise_ref(delta, noise, 1.0, m))
                          .abs().max().item())
        d[t // 2] = float("nan")        # one NaN: every output NaN, as in JAX
        require(ops.privatize_flat(d, noise, 1.0, 0.5).isnan().all().item(),
                "dp_clip_noise drops a NaN of the delta")
    # two runs give the same bits on both routes (the summation order is a
    # function of T alone), also on a view 4 bytes past 16-byte alignment
    for t, offset in ((SOLAR_PARAMS, 0), ((1 << 20) + 3, 0),
                      (SOLAR_PARAMS, 1)):
        d = torch.randn(t + offset, generator=gen, device=dev)[offset:]
        noise = torch.randn(t + offset, generator=gen, device=dev)[offset:]
        first = ops.privatize_flat(d, noise, 5.0, 0.3)
        again = ops.privatize_flat(d, noise, 5.0, 0.3)
        require(torch.equal(first, again), f"dp_clip_noise T={t} offset "
                                           f"{offset}: two runs differ")
        err = max(err, (first - dp_clip_noise_ref(d, noise, 5.0, 0.3))
                  .abs().max().item())
    print("[kernels] dp_clip_noise: two runs bit-equal at T 141,953 "
          f"(route {ops.route(SOLAR_PARAMS)}, cluster of "
          f"{ops.cluster_shape(SOLAR_PARAMS)[0]} CTAs, "
          f"{ops.cluster_shape(SOLAR_PARAMS)[1]} values a thread) and "
          f"{(1 << 20) + 3} (route {ops.route((1 << 20) + 3)}), and on a "
          "view 4 bytes past 16-byte alignment")
    require(err <= 1e-5, f"dp_clip_noise max abs err {err} > 1e-5")
    t = SOLAR_PARAMS
    d = torch.randn(t, generator=gen, device=dev) * 0.05
    noise = torch.randn(t, generator=gen, device=dev)
    per_call = require_one_kernel_a_call(
        "dp_clip_noise", lambda: ops.privatize_flat(d, noise, 5.0, 0.3))
    wide = (1 << 20) + 3
    dw = torch.randn(wide, generator=gen, device=dev) * 0.05
    nw = torch.randn(wide, generator=gen, device=dev)
    # the function reads d and the noise once and writes out once; 2T ops
    # for the norm, 3T for the output
    bms, by = bound(12 * t, 5 * t)
    return {"max_abs_err": err, "shape": f"T={t}, clip 5.0, m 0.3",
            "kernel_route": ops.route(t),
            "ms": cuda_ms(lambda: ops.privatize_flat(d, noise, 5.0, 0.3)),
            "device_ms": device_ms(
                "dp_clip_noise",
                lambda: ops.privatize_flat(d, noise, 5.0, 0.3)),
            "plain_ms": cuda_ms(lambda: dp_clip_noise_ref(d, noise, 5.0, 0.3)),
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "launches_a_call": per_call,
            "wide_shape": f"T={wide}", "wide_route": ops.route(wide),
            "wide_ms": cuda_ms(lambda: ops.privatize_flat(dw, nw, 5.0, 0.3)),
            "wide_device_ms": device_ms(
                "dp_clip_noise", lambda: ops.privatize_flat(dw, nw, 5.0, 0.3)),
            "wide_bound_ms": bound(12 * wide, 5 * wide)[0]}


def rel_err(got, want, rtol=KERNEL_RTOL) -> tuple[float, float]:
    """(max abs err, the f32 path-shape limit rtol * max(1, |want|))."""
    err = (got.float() - want.float()).abs().max().item()
    return err, rtol * max(1.0, want.float().abs().max().item())


def spy_args(module, name: str, run):
    """The positional arguments of the first call of ``module.name`` while
    ``run()`` runs: a kernel's inputs as its caller builds them."""
    seen = []
    orig = getattr(module, name)

    def spy(*args, **kw):
        seen.append(args)
        return orig(*args, **kw)

    setattr(module, name, spy)
    try:
        run()
    finally:
        setattr(module, name, orig)
    return seen[0]


def ssd_scan_inputs(gen, b, s):
    """mamba2-370m's SSD inputs for ``b`` x ``s`` tokens, drawn as the mixer
    makes them: x, dt = softplus(.), A = -exp(.), one group of B and C."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.ssm import _dims

    cfg = get_config("mamba2-370m")
    _, h = _dims(cfg)
    p, n, g = cfg.ssm.head_dim, cfg.ssm.d_state, cfg.ssm.n_groups

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=gen.device) * scale
    return (r(b, s, h, p), torch.nn.functional.softplus(r(b, s, h)),
            -torch.exp(r(h, scale=0.5)), r(b, s, g, n), r(b, s, g, n))


def f64_distance(got, exact) -> float:
    """max|got - exact| / max|exact|: a route's distance to the answer."""
    return ((got.double() - exact).abs().max() / exact.abs().max()).item()


def f64_distances(tag, kernel, plain, exact) -> list[tuple[float, float]]:
    """(kernel route, f32 plain version) distances to the f64 answer of
    each output, printed."""
    out = []
    for what, k, p, e in zip(("y", "states"), kernel, plain, exact,
                             strict=True):
        dk, dp = f64_distance(k, e), f64_distance(p, e)
        print(f"[kernels] {tag} {what}: distance to f64 (x max|f64|) kernel "
              f"{dk:.3e}, plain f32 {dp:.3e}")
        out.append((dk, dp))
    return out


def ssd_kernel_inputs(gen, b, c, l, h, p, g, n):
    """Kernel inputs drawn as the mixer makes them (``ssd_scan_inputs``),
    cut into chunks of l, with B and C once per group."""
    import torch

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=gen.device) * scale
    x, dt = r(b, c * l, h, p), torch.nn.functional.softplus(r(b, c * l, h))
    A = -torch.exp(r(h, scale=0.5))
    return ((x * dt[..., None]).reshape(b, c, l, h, p),
            (dt * A).reshape(b, c, l, h),
            r(b, c * l, g, n).reshape(b, c, l, g, n),
            r(b, c * l, g, n).reshape(b, c, l, g, n))


def check_ssd_against_plain_and_f64(tag, args) -> float:
    """The kernel within KERNEL_RTOL of its plain version and at most
    SSD_F64_FACTOR times as far from the f64 answer; returns the error."""
    from repro_torch.kernels.ssd_chunk import ops
    from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_ref

    (y, st), (yr, sr) = ops.ssd_intra_chunk(*args), ssd_intra_chunk_ref(*args)
    e, lim = rel_err(y, yr)
    e2, lim2 = rel_err(st, sr)
    print(f"[kernels] {tag}: y_diag err {e:.3e} (limit {lim:.3e}), states "
          f"err {e2:.3e} (limit {lim2:.3e})")
    require(e <= lim and e2 <= lim2, f"{tag}: y_diag err {e} (limit {lim}), "
            f"states err {e2} (limit {lim2})")
    exact = ssd_intra_chunk_ref(*(a.double() for a in args))
    for dk, dp in f64_distances(tag, (y, st), (yr, sr), exact):
        require(dk <= SSD_F64_FACTOR * dp, f"{tag}: the kernel is {dk} from "
                f"f64, its plain version {dp} (limit x{SSD_F64_FACTOR})")
    return max(e, e2)


def check_ssd(dev, gen):
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_chunk import ops
    from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_ref
    from repro_torch.models.ssm import ssd_chunked

    ssm = get_config("mamba2-370m").ssm
    chunk = ssm.chunk_size
    b, s = LLM["mamba2-370m"].score
    err, worst, path = 0.0, 0.0, None
    for seq in (s, 2000):                       # 2000: the padding path
        scan = ssd_scan_inputs(gen, b, seq)
        args = spy_args(ops, "ssd_intra_chunk",
                        lambda: ops.ssd_chunked_fused(*scan, chunk))
        require(args[2].shape[3] == ssm.n_groups, f"ssd_chunk is given "
                f"{args[2].shape[3]} copies of B, not {ssm.n_groups} group")
        err = max(err, check_ssd_against_plain_and_f64(
            f"ssd_chunk S={seq}", args))
        # the whole scan around the kernel against the same scan in f64
        exact = ssd_chunked(*(a.double() for a in scan), chunk)
        for dk, _ in f64_distances(f"ssd_chunked_fused S={seq}",
                                   ops.ssd_chunked_fused(*scan, chunk),
                                   ssd_chunked(*scan, chunk), exact):
            require(dk <= KERNEL_RTOL, f"ssd_chunked_fused at S={seq}: {dk} "
                                       f"x max|f64| from f64")
            worst = max(worst, dk)
        if seq == s:
            path = args
    print(f"[kernels] ssd_chunked_fused: worst distance to f64 {worst:.3e} x "
          f"max|f64| (limit {KERNEL_RTOL}); kernel vs f64 at most "
          f"x{SSD_F64_FACTOR} its plain version's distance")
    # shapes past the old caps: two groups, n 160, p 80, short chunks and a
    # full one
    for shape in SSD_SHAPES:
        err = max(err, check_ssd_against_plain_and_f64(
            f"ssd_chunk b,c,l,h,p,g,n={shape}",
            ssd_kernel_inputs(gen, *shape)))
    xdt, dA, B, C = path
    nb, nc, l, h, p = xdt.shape
    g, n = B.shape[3], B.shape[4]
    # each input read once, each output written once; C Bᵀ once per group,
    # the other two products once per head
    nbytes = 4 * (xdt.numel() + dA.numel() + B.numel() + C.numel()
                  + xdt.numel() + nb * nc * h * n * p)
    tri = l * (l + 1) // 2                      # useful pairs, i >= j
    flops = nb * nc * (g * 2 * tri * n
                       + h * (tri + 2 * tri * p + l * p + 2 * l * n * p))
    bms, by = bound(nbytes, flops)
    # PR 15's bound, from the per-head copies of B and C its wrapper made
    copies = nb * nc * (h - g)
    hbms, _ = bound(nbytes + 4 * 2 * copies * l * n,
                    flops + copies * 2 * tri * n)
    print(f"[kernels] ssd_chunk bound from per-group B and C (g={g}): "
          f"{bms:.6f} ms ({by}); from per-head copies: {hbms:.6f} ms")
    return {"max_abs_err": err, "shape": f"b={nb}, c={nc}, l={l}, h={h}, "
                                         f"p={p}, g={g}, n={n} (S={s})",
            "ms": cuda_ms(lambda: ops.ssd_intra_chunk(*path), iters=50),
            "device_ms": device_ms("ssd_chunk",
                                   lambda: ops.ssd_intra_chunk(*path),
                                   iters=20),
            "plain_ms": cuda_ms(lambda: ssd_intra_chunk_ref(*path), iters=10,
                                warmup=2),
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "head_copies_bound_ms": hbms, "gflop": flops / 1e9,
            "gbytes": nbytes / 1e9}


def check_local_attn(dev, gen):
    """local_attn's forward kernels at the path's shapes: gemma-2b (B 2, H
    8, KV 1, S 2048, D 256) in bf16 (the tensor-core route) and f32 (split
    tf32), glm4-9b's training shape (ATTN_D128) in bf16, RecurrentGemma's
    window 2048 at S 4096 in f32, the padded head dims 80 (f32, bf16) and
    192 (bf16) and launch.train's shape in f32, each on its route's
    counter, within its tolerance of the plain version and at most
    ATTN_F64_FACTOR times as far from the f64 answer as it; timed at
    gemma-2b's shape on both routes (the main keys bf16, the ``f32_`` keys
    the split-tf32 route), at glm4-9b's (the ``d128_`` keys) and at
    launch.train's in f32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.local_attn import ops
    from repro_torch.kernels.local_attn.ref import local_attention_ref

    def qkv(b, h, kv, s, d, dtype):
        return tuple(torch.randn(b, m, s, d, generator=gen, device=dev)
                     .to(dtype) for m in (h, kv, kv))

    def hold(tag, q, k, v, kw):
        """One call on its route, against the plain version and f64;
        returns its max abs err."""
        tc = ops.route(q.dtype, q.shape[-1]) == "tc"
        before = (ops.launches_tc, ops.launches_tf32)
        got = ops.local_flash_attention(q, k, v, **kw)
        require((ops.launches_tc - before[0], ops.launches_tf32 - before[1])
                == ((1, 0) if tc else (0, 1)), f"{tag}: took the wrong route")
        want = local_attention_ref(q, k, v, **kw)
        e, lim = rel_err(got, want)
        if q.dtype == torch.bfloat16:
            lim = 2e-2
        require(got.shape == q.shape and e <= lim,
                f"{tag}: max abs err {e} > {lim}")
        exact = local_attention_ref(q.double(), k.double(), v.double(),
                                    **kw)
        dk, dp = f64_distance(got, exact), f64_distance(want, exact)
        print(f"[kernels] {tag} ({ops.route(q.dtype, q.shape[-1])} route): "
              f"max abs err {e:.3e} (limit {lim:.3e}); distance to f64 (x "
              f"max|f64|) kernel {dk:.3e}, plain {dp:.3e} (limit "
              f"x{ATTN_F64_FACTOR})")
        require(dk <= ATTN_F64_FACTOR * dp, f"{tag}: the kernel is {dk} "
                f"from f64, its plain version {dp}")
        del exact
        torch.cuda.empty_cache()
        return e

    d = 256
    scale = d ** -0.5
    b, s = LLM["gemma-2b"].score
    err = err_f32 = 0.0
    # gemma-2b (H 8, KV 1) in bf16 and f32; RecurrentGemma's local window;
    # head dims between the instantiations (hubert-xlarge's 80, an encoder;
    # MLA's qk 192), zero-padded to the next one at the caller's scale;
    # launch.train's shape, the f32 route at D 64 with GQA 4:1; glm4-9b's
    # training shape, 16 query heads a kv head at D 128
    lb, lh, lkv, ls, ld = LAUNCH_ATTN
    gb, gh, gkv, gs, gd = ATTN_D128
    for h, kv, seq, dh, window, causal, dtype, nb in (
            (8, 1, s, d, 0, True, torch.bfloat16, b),
            (gh, gkv, gs, gd, 0, True, torch.bfloat16, gb),
            (8, 1, s, d, 0, True, torch.float32, b),
            (16, 1, 4096, d, 2048, True, torch.float32, 1),
            (16, 16, 1024, 80, 0, False, torch.float32, 1),
            (16, 16, 1024, 80, 0, False, torch.bfloat16, 1),
            (16, 16, 1024, 192, 0, True, torch.bfloat16, 1),
            (lh, lkv, ls, ld, 0, True, torch.float32, lb)):
        q, k, v = qkv(nb, h, kv, seq, dh, dtype)
        padded = (f" (padded to {ops.padded_head_dim(dh)})"
                  if ops.padded_head_dim(dh) != dh else "")
        e = hold(f"local_attn B={nb} H={h} KV={kv} S={seq} D={dh}{padded} "
                 f"window={window} causal {causal} {dtype}", q, k, v,
                 dict(causal=causal, window=window, scale=dh ** -0.5))
        err = max(err, e)
        if dtype == torch.float32:
            err_f32 = max(err_f32, e)
        del q, k, v
    lq, lk, lv = qkv(lb, lh, lkv, ls, ld, torch.float32)
    lkw = dict(causal=True, window=0, scale=ld ** -0.5)
    lpairs = lb * lh * ls * (ls + 1) // 2
    lbytes = 4 * (2 * lq.numel() + lk.numel() + lv.numel())
    lflops = lpairs * 4 * ld
    lcore = bound(lbytes, lflops)
    lbms, lby = min(lcore, bound(lbytes, lflops * ops.TF32_PRODUCTS,
                                 TF32_TC_FLOP_PER_S))

    def lkernel():
        return ops.local_flash_attention(lq, lk, lv, **lkw)
    launch = {"launch_shape": f"B={lb}, H={lh}, KV={lkv}, S={ls}, D={ld}, "
                              "causal, f32 (launch.train)",
              "launch_f32_ms": cuda_ms(lkernel, iters=100, warmup=10),
              "launch_f32_plain_ms": cuda_ms(lambda: local_attention_ref(
                  lq, lk, lv, **lkw), iters=100, warmup=10),
              "launch_f32_library_ms": cuda_ms(
                  lambda: F.scaled_dot_product_attention(
                      lq, lk, lv, is_causal=True, scale=lkw["scale"],
                      enable_gqa=True), iters=100, warmup=10),
              "launch_f32_bound_ms": lbms, "launch_f32_bound_by": lby,
              "launch_f32_cuda_core_bound_ms": lcore[0]}
    d128 = d128_forward(dev, gen)
    q, k, v = qkv(b, 8, 1, s, d, torch.bfloat16)
    # the same inputs as the model hands them over: (b, s, heads, D) views
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]

    def library(*args):
        return lambda: F.scaled_dot_product_attention(
            *args, is_causal=True, scale=scale, enable_gqa=True)
    lib_err = (library(q, k, v)().float() - ops.local_flash_attention(
        q, k, v, causal=True, scale=scale).float()).abs().max().item()
    require(lib_err <= 2e-2, f"the SDPA yardstick computes another function "
                             f"({lib_err})")
    require(torch.equal(ops.local_flash_attention(*views, causal=True,
                                                  scale=scale),
                        ops.local_flash_attention(q, k, v, causal=True,
                                                  scale=scale)),
            "local_attn: strided views give another answer")
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    pairs = b * 8 * s * (s + 1) // 2            # the causal half
    flops = pairs * 4 * d
    bms, by = bound(nbytes, flops, BF16_TC_FLOP_PER_S)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    views32 = [t.float() for t in views]
    require(torch.equal(ops.local_flash_attention(*views32, causal=True,
                                                  scale=scale),
                        ops.local_flash_attention(q32, k32, v32, causal=True,
                                                  scale=scale)),
            "local_attn f32: strided views give another answer")
    lib32_err = (library(q32, k32, v32)() - ops.local_flash_attention(
        q32, k32, v32, causal=True, scale=scale)).abs().max().item()
    require(lib32_err <= 2e-2, f"the f32 SDPA yardstick computes another "
                               f"function ({lib32_err})")
    # the split-tf32 route's products run on the tf32 tensor cores, three
    # partial products each; the f32 CUDA cores' bound is kept beside it
    core32 = bound(2 * nbytes, flops)
    bms32, by32 = min(core32, bound(2 * nbytes, flops * ops.TF32_PRODUCTS,
                                    TF32_TC_FLOP_PER_S))

    def kernel(*args):
        return lambda: ops.local_flash_attention(*args, causal=True,
                                                 scale=scale)
    return {"max_abs_err": err, "shape": f"B={b}, H=8, KV=1, S={s}, D={d}, "
                                         "causal, bf16 (f32_ keys: f32)",
            "ms": cuda_ms(kernel(q, k, v), iters=20, warmup=3),
            "device_ms": device_ms("local_attn", kernel(q, k, v), iters=20),
            "views_ms": cuda_ms(kernel(*views), iters=20, warmup=3),
            "plain_ms": cuda_ms(lambda: local_attention_ref(
                q, k, v, causal=True, window=0, scale=scale), iters=10,
                warmup=2),
            "library_ms": cuda_ms(library(q, k, v), iters=20, warmup=3),
            "bound_ms": bms, "bound_by": by,
            "f32_max_abs_err": err_f32,
            "f32_ms": cuda_ms(kernel(q32, k32, v32), iters=20, warmup=3),
            "f32_device_ms": device_ms("local_attn", kernel(q32, k32, v32),
                                       iters=20),
            "f32_views_ms": cuda_ms(kernel(*views32), iters=20, warmup=3),
            "f32_plain_ms": cuda_ms(lambda: local_attention_ref(
                q32, k32, v32, causal=True, window=0, scale=scale),
                iters=10, warmup=2),
            "f32_library_ms": cuda_ms(library(q32, k32, v32), iters=10,
                                      warmup=2),
            "f32_bound_ms": bms32, "f32_bound_by": by32,
            "f32_cuda_core_bound_ms": core32[0],
            "f32_products": ops.TF32_PRODUCTS, **launch, **d128,
            "gflop": flops / 1e9, "gbytes": nbytes / 1e9}


def d128_forward(dev, gen) -> dict:
    """The tensor-core forward at ATTN_D128 (glm4-9b's training shape),
    timed back to back and by its own device time beside the plain version
    and SDPA on the same inputs, with its bound; the ``d128_`` keys of
    ``check_local_attn`` (held against plain and f64 there)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.local_attn import ops
    from repro_torch.kernels.local_attn.ref import local_attention_ref

    b, h, kv, s, d = ATTN_D128
    q = torch.randn(b, h, s, d, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, kv, s, d, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    kw = dict(causal=True, window=0, scale=d ** -0.5)

    def kernel():
        return ops.local_flash_attention(q, k, v, **kw)

    def library():
        return F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=kw["scale"], enable_gqa=True)
    gap = (library().float() - kernel().float()).abs().max().item()
    require(gap <= 2e-2, f"the D 128 SDPA yardstick computes another "
                         f"function ({gap})")
    # as the model hands them over: (b, s, heads, D) views
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]
    require(torch.equal(ops.local_flash_attention(*views, **kw), kernel()),
            "local_attn at D 128: strided views give another answer")
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    flops = b * h * s * (s + 1) // 2 * 4 * d
    bms, by = bound(nbytes, flops, BF16_TC_FLOP_PER_S)
    out = {"d128_shape": ATTN_D128_SHAPE,
           "d128_ms": cuda_ms(kernel, iters=20, warmup=3),
           "d128_device_ms": device_ms("local_attn", kernel, iters=20),
           "d128_plain_ms": cuda_ms(lambda: local_attention_ref(q, k, v, **kw),
                                    iters=10, warmup=2),
           "d128_library_ms": cuda_ms(library, iters=20, warmup=3),
           "d128_bound_ms": bms, "d128_bound_by": by,
           "d128_gflop": flops / 1e9, "d128_gbytes": nbytes / 1e9}
    print(f"[kernels] local_attn at {out['d128_shape']}: "
          f"{json.dumps({k: v for k, v in out.items() if k != 'd128_shape'})}")
    return out


def hold_bwd(tag, names, got, again, plain, exact, rtol) -> float:
    """A backward kernel's outputs: the same bits on a second run, within
    ``rtol`` x max(1, max|plain|) of the plain VJP and at most
    BWD_F64_FACTOR times as far from the f64 VJP as the plain version;
    returns the largest error against the plain version."""
    import torch

    require(all(torch.equal(a, b) for a, b in zip(got, again, strict=True)),
            f"{tag}: two runs give different bits")
    worst = 0.0
    for name, g, pl, ex in zip(names, got, plain, exact, strict=True):
        require(g.shape == pl.shape and g.dtype == pl.dtype,
                f"{tag} {name}: {tuple(g.shape)} {g.dtype}, plain "
                f"{tuple(pl.shape)} {pl.dtype}")
        e, lim = rel_err(g, pl, rtol)
        dk, dp = f64_distance(g, ex), f64_distance(pl, ex)
        print(f"[kernels] {tag} {name}: max abs err {e:.3e} (limit "
              f"{lim:.3e}); distance to f64 (x max|f64|) kernel {dk:.3e}, "
              f"plain {dp:.3e} (limit x{BWD_F64_FACTOR})")
        require(e <= lim, f"{tag} {name}: max abs err {e} > {lim}")
        require(dk <= BWD_F64_FACTOR * dp, f"{tag} {name}: the kernel is "
                f"{dk} from f64, its plain version {dp}")
        worst = max(worst, e)
    return worst


def check_ssd_bwd(dev, gen):
    """ssd_chunk's backward kernel at the training path's shapes (mamba2:
    b 2, S 2048, and the padded S 2000, the inputs as the mixer makes
    them) and SSD_SHAPES' per-group ones, against the plain VJP and the
    f64 VJP, twice for the bits; timed at b 2, S 2048."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_chunk import ops
    from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_bwd_ref

    chunk = get_config("mamba2-370m").ssm.chunk_size
    b, s = LLM_TRAIN["mamba2-370m"]
    cases = []
    for seq in (s, 2000):
        scan = ssd_scan_inputs(gen, b, seq)
        cases.append((f"S={seq}", spy_args(
            ops, "ssd_intra_chunk",
            lambda scan=scan: ops.ssd_chunked_fused(*scan, chunk))))
    cases += [(f"b,c,l,h,p,g,n={shape}", ssd_kernel_inputs(gen, *shape))
              for shape in SSD_SHAPES]
    err, path = 0.0, None
    for tag, (xdt, dA, B, C) in cases:
        nb, nc, _, h, p = xdt.shape
        dy = torch.randn(xdt.shape, generator=gen, device=dev)
        dst = torch.randn((nb, nc, h, B.shape[4], p), generator=gen,
                          device=dev)
        args = (xdt, dA, B, C, dy, dst)
        err = max(err, hold_bwd(
            f"ssd_chunk backward {tag}", ("dxdt", "d(dA)", "dB", "dC"),
            ops.ssd_intra_chunk_bwd(*args), ops.ssd_intra_chunk_bwd(*args),
            ssd_intra_chunk_bwd_ref(*args),
            ssd_intra_chunk_bwd_ref(*(a.double() for a in args)), BWD_RTOL))
        if path is None:
            path = args
    xdt, dA, B, C, dy, dst = path
    nb, nc, l, h, p = xdt.shape
    g, n = B.shape[3], B.shape[4]
    # each input read once, each output written once; C Bᵀ once a group;
    # per head the i >= j half of D = dy xdtᵀ, (L G)ᵀ dy, (L D) B,
    # (L D)ᵀ C and the two decay products
    nbytes = 4 * 2 * (xdt.numel() + dA.numel() + B.numel() + C.numel()) \
        + 4 * (dy.numel() + dst.numel())
    tri = l * (l + 1) // 2
    flops = nb * nc * (g * 2 * tri * n + h * (
        2 * tri * p + 2 * tri * p + 2 * tri * n + 2 * tri * n
        + 2 * 2 * l * n * p + 4 * tri))
    bms, by = bound(nbytes, flops)
    return {"max_abs_err": err,
            "shape": f"b={nb}, c={nc}, l={l}, h={h}, p={p}, g={g}, n={n} "
                     f"(S={s})",
            "ms": cuda_ms(lambda: ops.ssd_intra_chunk_bwd(*path), iters=20,
                          warmup=3),
            "device_ms": device_ms("ssd_chunk_bwd",
                                   lambda: ops.ssd_intra_chunk_bwd(*path),
                                   iters=10),
            "plain_ms": cuda_ms(lambda: ssd_intra_chunk_bwd_ref(*path),
                                iters=5, warmup=1),
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "gflop": flops / 1e9, "gbytes": nbytes / 1e9}


def check_local_attn_bwd(dev, gen):
    """local_attn's backward kernels through the autograd Function at
    gemma-2b's training shape (B 2, H 8, KV 1, S 2048, D 256) in bf16 and
    f32, glm4-9b's (ATTN_D128) in bf16, launch.train's (LAUNCH_ATTN) in
    f32, RecurrentGemma's window 2048 at S 4096 and the padded head dims 80
    and 192, against the plain VJP and the f64 VJP, twice for the bits,
    bf16 at D 64-256 on the tensor-core route, the rest on split tf32;
    timed at gemma-2b's shape on both routes, at
    launch.train's in f32 and at glm4-9b's in bf16, each beside SDPA's
    forward + backward in its dtype (the main keys bf16, the ``f32_`` keys
    the split-tf32 route, the ``launch_f32_`` keys launch.train's shape,
    the ``d128_`` keys glm4-9b's)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.local_attn import ops
    from repro_torch.kernels.local_attn.ref import local_attention_bwd_ref

    def grads(q, k, v, dout, kw):
        live = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ops.local_flash_attention(*live, **kw)
        return torch.autograd.grad(out, live, dout)

    b, s = LLM_TRAIN["gemma-2b"]
    err = err_tf32 = 0.0
    for (nb, h, kv, seq, d, causal, window, dtype) in ATTN_BWD_CASES:
        dtype = getattr(torch, dtype)
        q, dout = (torch.randn(nb, h, seq, d, generator=gen, device=dev)
                   .to(dtype) for _ in range(2))
        k, v = (torch.randn(nb, kv, seq, d, generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        kw = dict(causal=causal, window=window, scale=d ** -0.5)
        before = (ops.launches_bwd, ops.launches_bwd_tc,
                  ops.launches_bwd_tf32)
        got = grads(q, k, v, dout, kw)
        tc = ops.route(dtype, d) == "tc"    # else split tf32
        require((ops.launches_bwd, ops.launches_bwd_tc,
                 ops.launches_bwd_tf32) == (
            before[0] + 1, before[1] + tc, before[2] + (not tc)),
            f"local_attn backward: {ops.launches_bwd - before[0]} launches "
            f"for one gradient, {ops.launches_bwd_tc - before[1]} on wgmma, "
            f"{ops.launches_bwd_tf32 - before[2]} on split tf32")
        tag = (f"local_attn backward B={nb} H={h} KV={kv} S={seq} D={d} "
               f"window={window} {dtype} ({ops.route(dtype, d)} route)")
        e = hold_bwd(
            tag, ("dq", "dk", "dv"), got, grads(q, k, v, dout, kw),
            local_attention_bwd_ref(q, k, v, dout, **kw),
            local_attention_bwd_ref(q.double(), k.double(), v.double(),
                                    dout.double(), **kw),
            BWD_RTOL if dtype == torch.float32 else BWD_BF16_RTOL)
        err = max(err, e)
        if not tc:
            err_tf32 = max(err_tf32, e)
        del got
        torch.cuda.empty_cache()
    out = {}
    lb, lh, lkv, ls, ld = LAUNCH_ATTN
    for dtype, key, (nb, h, kv, seq, d) in (
            (torch.bfloat16, "", (b, 8, 1, s, 256)),
            (torch.float32, "f32_", (b, 8, 1, s, 256)),
            (torch.float32, "launch_f32_", LAUNCH_ATTN),
            (torch.bfloat16, "d128_", ATTN_D128)):
        scale = d ** -0.5
        kw = dict(causal=True, window=0, scale=scale)
        q, dout = (torch.randn(nb, h, seq, d, generator=gen, device=dev)
                   .to(dtype) for _ in range(2))
        k, v = (torch.randn(nb, kv, seq, d, generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        _, lse = ops._forward_cuda(q, k, v, True, 0, scale, True)

        def kernel():
            return ops.local_attention_bwd(q, k, v, lse, dout, **kw)

        def fwd_bwd():
            return grads(q, k, v, dout, kw)

        def library():
            live = [t.clone().requires_grad_() for t in (q, k, v)]
            o = F.scaled_dot_product_attention(*live, is_causal=True,
                                               scale=scale, enable_gqa=True)
            return torch.autograd.grad(o, live, dout)

        gaps = [rel_err(a, w, BWD_BF16_RTOL)
                for a, w in zip(library(), fwd_bwd(), strict=True)]
        require(all(e <= lim for e, lim in gaps), "the SDPA yardstick's "
                f"{dtype} gradient is another function: {gaps}")
        before = (ops.launches_bwd_tc, ops.launches_bwd_tf32)
        kernel()
        require((ops.launches_bwd_tc - before[0],
                 ops.launches_bwd_tf32 - before[1]) == (
                     (1, 0) if dtype == torch.bfloat16 else (0, 1)),
                f"local_attn backward {dtype} took the wrong route")
        small = key == "launch_f32_"
        out.update({
            f"{key}ms": cuda_ms(kernel, iters=100 if small else 10,
                                warmup=10 if small else 2),
            f"{key}fwd_bwd_ms": cuda_ms(fwd_bwd, iters=10, warmup=2),
            f"{key}plain_ms": cuda_ms(lambda: local_attention_bwd_ref(
                q, k, v, dout, **kw), iters=5, warmup=1),
            f"{key}library_ms": cuda_ms(library, iters=10, warmup=2)})
        if not small:
            out[f"{key}device_ms"] = device_ms("local_attn_bwd", kernel,
                                               iters=10)
        # each input read once (q, k, v, dout, lse), each output written
        # once; S, dP, dq, dk, dv over the causal half
        nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel()
                                     + 2 * v.numel() + q.numel()) \
            + 4 * lse.numel()
        flops = nb * h * seq * (seq + 1) // 2 * 10 * d
        if dtype == torch.bfloat16:
            out[f"{key}bound_ms"], out[f"{key}bound_by"] = bound(
                nbytes, flops, BF16_TC_FLOP_PER_S)
            out[f"{key}gflop"], out[f"{key}gbytes"] = flops / 1e9, nbytes / 1e9
        else:
            # the route's products run on the tf32 tensor cores, each as
            # ops.TF32_PRODUCTS partial products; the f32 CUDA cores'
            # bound for the same products is kept beside it
            cuda_core = bound(nbytes, flops)
            out[f"{key}bound_ms"], out[f"{key}bound_by"] = min(
                cuda_core, bound(nbytes, flops * ops.TF32_PRODUCTS,
                                 TF32_TC_FLOP_PER_S))
            out[f"{key}cuda_core_bound_ms"] = cuda_core[0]
            out[f"{key}products"] = ops.TF32_PRODUCTS
        del q, k, v, dout, lse
        torch.cuda.empty_cache()
    print(f"[kernels] local_attn backward at {ATTN_D128_SHAPE}: "
          + json.dumps({k: v for k, v in out.items()
                        if k.startswith("d128_")}))
    return {"max_abs_err": err, "f32_max_abs_err": err_tf32,
            "shape": f"B={b}, H=8, KV=1, S={s}, D=256, causal, bf16 "
                     "(f32_ keys: f32)",
            "launch_shape": f"B={lb}, H={lh}, KV={lkv}, S={ls}, D={ld}, "
                            "causal, f32 (launch.train)",
            "d128_shape": ATTN_D128_SHAPE,
            **out, "library_is": "SDPA forward + backward"}


def check_lstm_step_route(dev) -> dict:
    """The forecaster at hidden sizes the sequence kernels have no launch
    shape for: the chained step kernel, forward and loss gradient on the
    card against the CPU route; returns the step launches of each."""
    import torch
    from repro_torch.configs.solar_lstm import SolarLSTMConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.lstm_cell import ops as lstm_ops
    from repro_torch.models.lstm import SolarForecaster
    from repro_torch.training.losses import solar_loss
    from repro_torch.utils.tree import tree_leaves, tree_map

    out = {}
    for hidden in LSTM_STEP_HIDDEN:
        fc = SolarForecaster(SolarLSTMConfig(hidden_size=hidden))
        cfg = fc.cfg
        require(lstm_ops.seq_fits(hidden, cfg.history_channels) is None,
                f"hidden {hidden}: the sequence kernels take it")
        params = fc.init(torch.Generator().manual_seed(hidden), "cpu")
        gen = torch.Generator().manual_seed(3)
        batch = {"history": torch.rand(3, cfg.history_steps,
                                       cfg.history_channels, generator=gen),
                 "forecast": torch.rand(3, cfg.horizon_steps,
                                        cfg.forecast_channels, generator=gen),
                 "target": torch.rand(3, cfg.horizon_steps, generator=gen)}
        live = tree_map(lambda x: x.to(dev).requires_grad_(), params)
        torch.cuda.synchronize()
        reset_launch_counts()
        loss, _ = solar_loss(fc, live, {k: v.to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, tree_leaves(live))
        torch.cuda.synchronize()
        steps = launch_counts()["lstm_cell"] - lstm_ops.launches_seq_fwd - \
            lstm_ops.launches_seq_bwd
        want_steps = cfg.history_steps + cfg.horizon_steps
        require(steps == want_steps and lstm_ops.launches_seq_fwd == 0,
                f"hidden {hidden}: {steps} step launches, "
                f"{lstm_ops.launches_seq_fwd} sequence forwards")
        with torch.no_grad():
            fwd = fc.forward(tree_map(lambda x: x.to(dev), params),
                             batch["history"].to(dev),
                             batch["forecast"].to(dev))
        want_fwd = fc.forward(params, batch["history"], batch["forecast"])
        ferr = (fwd.cpu() - want_fwd).abs().max().item()
        require(ferr <= 1e-5, f"hidden {hidden}: forecast off the CPU route "
                              f"by {ferr}")
        cpu_live = tree_map(lambda x: x.clone().requires_grad_(), params)
        cpu_loss, _ = solar_loss(fc, cpu_live, batch)
        cpu_grads = torch.autograd.grad(cpu_loss, tree_leaves(cpu_live))
        for a, w in zip(grads, cpu_grads, strict=True):
            torch.testing.assert_close(a.cpu(), w, rtol=1e-4, atol=1e-5)
        gerr = max((a.cpu() - w).abs().max().item()
                   for a, w in zip(grads, cpu_grads, strict=True))
        print(f"[kernels] forecaster at hidden {hidden} (step route): "
              f"{steps} step launches a forward + gradient, no sequence "
              f"launch; forecast vs CPU max abs err {ferr:.3e} (limit 1e-5), "
              f"gradient {gerr:.3e} (rtol 1e-4, atol 1e-5)")
        out[str(hidden)] = steps
    return out


def phase_kernels(dev) -> dict:
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    # the paths' routes first; the stacked fold and the single step stand
    # beside them as stacked_* and step_* keys
    for name, check, extra in (
            ("fedavg_agg", check_fedavg_leaves, ("stacked", check_fedavg)),
            ("lstm_cell", check_lstm_seq, ("step", check_lstm)),
            ("ewc_update", check_ewc, None), ("dp_clip_noise", check_dp, None),
            ("ssd_chunk", check_ssd, None),
            ("local_attn", check_local_attn, None),
            ("ssd_chunk_bwd", check_ssd_bwd, None),
            ("local_attn_bwd", check_local_attn_bwd, None)):
        res = check(dev, gen)
        torch.cuda.synchronize()
        print(f"[kernels] {name} ({res['shape']}): max_abs_err "
              f"{res['max_abs_err']:.3e}, kernel {res['ms']:.5f} ms back to "
              f"back, {res['device_ms']} ms its own device time, plain "
              f"{res['plain_ms']:.5f} ms, library {res['library_ms']} ms, "
              f"bound {res['bound_ms']:.6f} ms ({res['bound_by']})")
        if extra:
            tag, second = extra
            more = second(dev, gen)
            torch.cuda.synchronize()
            print(f"[kernels] {name}, {tag} route ({more['shape']}): "
                  f"max_abs_err {more['max_abs_err']:.3e}, kernel "
                  f"{more['ms']:.5f} ms back to back, {more['device_ms']} ms "
                  f"its own device time, plain {more['plain_ms']:.5f} ms, "
                  f"library {more['library_ms']} ms, bound "
                  f"{more['bound_ms']:.6f} ms ({more['bound_by']})")
            res.update({f"{tag}_{k}": v for k, v in more.items()})
            res["max_abs_err"] = max(res["max_abs_err"], more["max_abs_err"])
        results[name] = res
    results["lstm_cell"]["step_route_launches"] = check_lstm_step_route(dev)
    extras = {k: v for k, v in results["lstm_cell"].items()
              if k.startswith(("bwd", "fwd_bwd", "decoder", "serial",
                               "step_exchange"))}
    print(f"[kernels] lstm_seq at B 8, T 672, I 10, H 128: {json.dumps(extras)}"
          f"; card: {card_line()}")
    return results


# ------------------------------------------------------------------ phase 3
def check_table(report, what):
    for name, row in report["table2"].items():
        require(all(math.isfinite(v) for v in row.values()),
                f"{what}: non-finite Table II row {name}")
        require(row["mean_error_power"] < 30.0,
                f"{what}: {name} power error {row['mean_error_power']}")
        require(row["mean_error_energy"] < 40.0,
                f"{what}: {name} energy error {row['mean_error_energy']}")
    for name, row in report["independent"].items():
        require(all(math.isfinite(v) for v in row.values()),
                f"{what}: non-finite §IV.E row {name}")


def print_report(report, tag="main"):
    for name, row in report["table2"].items():
        print(f"[{tag}] table2 {name:22s} power "
              f"{row['mean_error_power']:.4f}% energy "
              f"{row['mean_error_energy']:.4f}% day-power "
              f"{row['mean_error_day_power']:.4f}%")
    for name, row in report["independent"].items():
        deg = row["mean_error_power"] - \
            report["table2"][name]["mean_error_power"]
        print(f"[{tag}] §IV.E  {name:22s} power "
              f"{row['mean_error_power']:.4f}% (degradation {deg:+.4f} pp)")
    print(f"[{tag}] async_stats {json.dumps(report['async_stats'])}")


class counting_calls:
    """Count the solar path's own calls while the block runs: forecaster
    forwards, SGD steps (``solar_loss`` calls, each one backward) and
    anchored steps (``ewc_adjusted_gradient`` calls), under a lock, since
    the threaded runtime makes them from several threads at once."""

    def __enter__(self):
        import threading
        import repro_torch.training.fed_solar as fed_solar
        from repro_torch.models.lstm import SolarForecaster

        self.calls = {"forwards": 0, "sgd_steps": 0, "anchored_steps": 0}
        lock = threading.Lock()
        self._saved = (SolarForecaster.forward, fed_solar.solar_loss,
                       fed_solar.ewc_adjusted_gradient)
        forward, loss, anchored = self._saved

        def counted(key, fn):
            def call(*a, **kw):
                with lock:
                    self.calls[key] += 1
                return fn(*a, **kw)
            return call

        SolarForecaster.forward = counted("forwards", forward)
        fed_solar.solar_loss = counted("sgd_steps", loss)
        fed_solar.ewc_adjusted_gradient = counted("anchored_steps", anchored)
        return self.calls

    def __exit__(self, *exc):
        import repro_torch.training.fed_solar as fed_solar
        from repro_torch.models.lstm import SolarForecaster

        (SolarForecaster.forward, fed_solar.solar_loss,
         fed_solar.ewc_adjusted_gradient) = self._saved
        return False


def route_counts(calls) -> dict:
    """The route counters (sequence forwards and reverse scans, folds by
    leaves) beside the path's own calls."""
    from repro_torch.kernels.fedavg_agg import ops as agg_ops
    from repro_torch.kernels.lstm_cell import ops as lstm_ops

    return {"lstm_seq_fwd": lstm_ops.launches_seq_fwd,
            "lstm_seq_bwd": lstm_ops.launches_seq_bwd,
            "fedavg_agg_leaves": agg_ops.launches_leaves,
            "fedavg_agg_stacked": agg_ops.launches_stacked, **calls}


def counted_run(dev, cfg):
    """``run_fedccl_solar(**cfg)`` on ``dev`` with the launch counters set
    to 0 just before and read just after; returns (report, counts, routes,
    wall).  ``routes`` holds the route counters and the path's own calls
    (``counting_calls``)."""
    import torch
    import repro_torch.training.fed_solar as fed_solar
    from repro_torch.kernels import launch_counts, reset_launch_counts

    with counting_calls() as calls:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        report = fed_solar.run_fedccl_solar(device=dev, **cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return report, launch_counts(), route_counts(calls), wall


def require_sequence_route(counts, routes, what):
    """The LSTM ran only as sequence scans: two forwards per forecaster
    forward (encoder, decoder), two reverse scans per SGD step, no step
    kernel; every fold by leaves; one ewc_update launch per anchored SGD
    step."""
    steps = counts["lstm_cell"] - routes["lstm_seq_fwd"] - \
        routes["lstm_seq_bwd"]
    require(steps == 0, f"{what}: {steps} lstm_cell step launches")
    require(routes["forwards"] > 0 and routes["lstm_seq_fwd"]
            == 2 * routes["forwards"], f"{what}: {routes['lstm_seq_fwd']} "
            f"sequence forwards for {routes['forwards']} forecaster forwards")
    require(routes["sgd_steps"] > 0 and routes["lstm_seq_bwd"]
            == 2 * routes["sgd_steps"], f"{what}: {routes['lstm_seq_bwd']} "
            f"reverse scans for {routes['sgd_steps']} SGD steps")
    require(counts["fedavg_agg"] == routes["fedavg_agg_leaves"],
            f"{what}: {counts['fedavg_agg']} folds, "
            f"{routes['fedavg_agg_leaves']} by leaves")
    require(routes["anchored_steps"] > 0 and counts["ewc_update"]
            == routes["anchored_steps"], f"{what}: {counts['ewc_update']} "
            f"ewc_update launches for {routes['anchored_steps']} anchored "
            "SGD steps")


MAIN_KERNELS = ("fedavg_agg", "lstm_cell", "ewc_update")
PRIVACY_KERNELS = MAIN_KERNELS + ("dp_clip_noise",)


def phase_main(dev) -> dict:
    report, counts, routes, wall = counted_run(dev, MAIN_PATH)
    print(f"[main] run_fedccl_solar({MAIN_PATH}) on {dev}: {wall:.1f} s; "
          f"card: {card_line()}")
    print_report(report)
    print(f"[main] launches {json.dumps(counts)}; routes and calls "
          f"{json.dumps(routes)}")
    for name in MAIN_KERNELS:
        require(counts[name] > 0, f"kernel {name} never launched on the "
                                  "main path")
    require_sequence_route(counts, routes, "main path")
    check_table(report, "main path")
    return counts, routes


# ------------------------------------------------------------------ phase 4
def device_profile(tag, fn, top=8):
    """Device kernels by name and the device's idle share of one call;
    returns the idle share (None when the profiler saw no device time)."""
    import torch
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"[{tag}] the profiler recorded no device time")
        return None
    by_name: dict[str, list] = {}
    for e in kernels:
        slot = by_name.setdefault(e.name, [0, 0.0])
        slot[0] += 1
        slot[1] += e.time_range.elapsed_us()
    busy_us = sum(v[1] for v in by_name.values())
    idle = 1.0 - busy_us / wall_us
    print(f"[{tag}] profiled call: {wall_us / 1e3:.2f} ms wall, "
          f"{len(kernels)} device kernels, {busy_us / 1e3:.3f} ms device "
          f"busy, idle share {idle:.4f}")
    for name, (n, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:top]:
        print(f"[{tag}]   {us / 1e3:9.3f} ms {n:6d}x  {name[:90]}")
    return idle


def phase_profile(dev):
    """Where one anchored SGD step of the main path spends its time: host
    clock per step (with and without the backward), and the device's
    kernels by name from ``torch.profiler``, with the device's busy share
    of the profiled window."""
    import torch
    from repro_torch.configs.solar_lstm import SolarLSTMConfig
    from repro_torch.core.continual import EWCState
    from repro_torch.models.lstm import SolarForecaster
    from repro_torch.training.fed_solar import make_solar_fns
    from repro_torch.utils.tree import flatten_params

    cfg = SolarLSTMConfig(hidden_size=MAIN_PATH["hidden"])
    fc = SolarForecaster(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = fc.init(torch.Generator().manual_seed(0), dev)
    batch = {"history": torch.rand(8, cfg.history_steps, cfg.history_channels,
                                   generator=gen, device=dev),
             "forecast": torch.rand(8, cfg.horizon_steps,
                                    cfg.forecast_channels, generator=gen,
                                    device=dev),
             "target": torch.rand(8, cfg.horizon_steps, generator=gen,
                                  device=dev)}
    anchor = EWCState(flatten_params(params), None, 0.05)
    sgd_step, predict = make_solar_fns(fc, lr=1e-2)

    def host_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    step_ms = host_ms(lambda: sgd_step(params, batch, anchor))
    fwd_ms = host_ms(lambda: predict(params, batch["history"],
                                     batch["forecast"]))
    print(f"[profile] anchored SGD step (B=8, H={cfg.hidden_size}): "
          f"{step_ms:.2f} ms on the host clock; forward alone {fwd_ms:.2f} ms")

    device_profile("profile", lambda: sgd_step(params, batch, anchor), top=12)
    print(f"[profile] card: {card_line()}")


# ------------------------------------------------------------------ phase 5
def closed_form_epsilon(steps: int, sigma: float, delta: float) -> float:
    """(epsilon, delta) of ``steps`` Gaussian releases of noise multiplier
    ``sigma``, over the accountant's order grid."""
    from repro_torch.privacy.accountant import DEFAULT_ORDERS

    return min(steps * a / (2.0 * sigma ** 2) + math.log(1.0 / delta)
               / (a - 1.0) for a in DEFAULT_ORDERS if a > 1.0)


def phase_privacy(dev) -> dict:
    cfg = dict(MAIN_PATH, **PRIVACY)
    report, counts, routes, wall = counted_run(dev, cfg)
    print(f"[privacy] run_fedccl_solar({cfg}) on {dev}: {wall:.1f} s")
    print(f"[privacy] card: {card_line()}")
    print_report(report, "privacy")
    print(f"[privacy] launches {json.dumps(counts)}; routes and calls "
          f"{json.dumps(routes)}")
    for name in PRIVACY_KERNELS:
        require(counts[name] > 0, f"kernel {name} never launched on the "
                                  "privacy path")
    require_sequence_route(counts, routes, "privacy path")
    stats = report["async_stats"]
    require(stats["secure_rounds"] > 0, "no secure round folded")
    require(stats["secure_recoveries"] == 0,
            "the solar run has no dropout, yet a client was recovered")
    require(counts["dp_clip_noise"] == stats["updates"],
            f"{counts['dp_clip_noise']} DP releases for {stats['updates']} "
            "updates")
    require(counts["fedavg_agg"] == stats["secure_rounds"],
            f"{counts['fedavg_agg']} folds for {stats['secure_rounds']} "
            "secure rounds")
    priv = report["privacy"]
    require(priv["secure_agg"]["rounds"] == stats["secure_rounds"],
            "privacy report and async_stats count other secure rounds")
    sigma = PRIVACY["dp_noise_multiplier"]
    for cid, row in priv["per_client"].items():
        want = closed_form_epsilon(row["steps"], sigma, TARGET_DELTA)
        require(math.isclose(row["epsilon"], want, rel_tol=1e-12),
                f"client {cid}: epsilon {row['epsilon']} != {want}")
    eps = sorted({(r["steps"], r["epsilon"])
                  for r in priv["per_client"].values()})
    print(f"[privacy] per-client (steps, epsilon) at delta {TARGET_DELTA}: "
          f"{eps} (closed form held)")
    for name in ("CentralizedAll", "CentralizedContinual", "FederatedLocal"):
        row = report["table2"][name]
        require(all(math.isfinite(v) for v in row.values()),
                f"privacy path: non-finite Table II row {name}")
        require(row["mean_error_power"] < 30.0,
                f"privacy path: {name} power error {row['mean_error_power']}")
        require(row["mean_error_energy"] < 40.0,
                f"privacy path: {name} energy error "
                f"{row['mean_error_energy']}")
    return counts, routes


# ------------------------------------------------------------------ phase 6
def threaded_fed(dev, hidden, runtime="threaded", **extra):
    """``FedCCL(FedCCLConfig(runtime=runtime, ...))`` (the threaded runtime
    unless asked for the sim) over the example's default fleet (MAIN_PATH:
    6 sites of a fleet of 6 + 2, 40 days, 3 epochs) with
    ``run_fedccl_solar``'s clustering spaces, train_fn and site speeds, at
    hidden ``hidden``; the initial weights come from a CPU generator, so
    they are the same on every device."""
    import numpy as np
    import torch
    from repro_torch.configs.solar_lstm import SolarLSTMConfig
    from repro_torch.core.fedccl import FedCCL, FedCCLConfig
    from repro_torch.core.protocol import ClientSpec
    from repro_torch.data.solar import generate_fleet
    from repro_torch.data.windows import make_windows, split_windows
    from repro_torch.models.lstm import SolarForecaster
    from repro_torch.training.fed_solar import (
        SOLAR_SPACES,
        make_solar_fns,
        make_train_fn,
    )

    seed = MAIN_PATH["seed"]
    rng = np.random.default_rng(seed)
    fleet = generate_fleet(
        n_sites=MAIN_PATH["n_sites"] + MAIN_PATH["n_independent"],
        n_days=MAIN_PATH["n_days"], seed=seed)[:MAIN_PATH["n_sites"]]
    fc = SolarForecaster(SolarLSTMConfig(hidden_size=hidden))
    init = fc.init(torch.Generator().manual_seed(seed), dev)
    train_fn = make_train_fn(make_solar_fns(fc, lr=1e-2)[0],
                             epochs=MAIN_PATH["epochs"])
    fed = FedCCL(FedCCLConfig(spaces=SOLAR_SPACES, ewc_lambda=0.05,
                              seed=seed, runtime=runtime, **extra),
                 init, train_fn, device=dev)
    fed.setup([ClientSpec(s.site_id, s.static_features,
                          split_windows(make_windows(d), train_frac=0.8)[0],
                          speed=float(rng.uniform(0.5, 2.0)))
               for s, d in fleet])
    return fed


def counted_fed(fed, rounds):
    """``fed.run(rounds)`` with the launch counters set to 0 just before and
    read just after; returns (stats, counts, routes, wall)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    with counting_calls() as calls:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        stats = fed.run(rounds=rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return stats, launch_counts(), route_counts(calls), wall


def require_exact_accounting(fed, stats, rounds, what):
    """Every client's updates folded once: ``updates`` = clients x rounds x
    (its clusters + 1); each model's round and samples_learned the sums
    over its members' updates; no queue left, no drain timed out."""
    epochs = MAIN_PATH["epochs"]
    want = {("global", None): [0, 0]}
    for c in fed.clients:
        n = len(c.spec.dataset["target"]) * epochs      # train_fn's samples
        for key in [None, *c.cluster_keys]:
            slot = want.setdefault(("global" if key is None else "cluster",
                                    key), [0, 0])
            slot[0] += rounds
            slot[1] += rounds * n
    updates = sum(r for r, _ in want.values())
    require(stats["updates"] == updates, f"{what}: {stats['updates']} "
                                         f"updates, expected {updates}")
    require(stats["drain_timeouts"] == 0, f"{what}: a drain timed out")
    for (level, key), (r, n) in want.items():
        meta = fed.store.meta(level, key)
        require((meta.round, meta.samples_learned) == (r, n),
                f"{what}: {level} {key} round {meta.round} samples "
                f"{meta.samples_learned}, expected {r} and {n}")
        require(fed.store.pending_depth(level, key) == 0,
                f"{what}: {level} {key} has queued updates left")
    return updates


def sum_counts(*runs) -> tuple[dict, dict]:
    """Launches and routes of several counted runs, summed."""
    counts, routes = {}, {}
    for c, r in runs:
        for name, n in c.items():
            counts[name] = counts.get(name, 0) + n
        for name, n in r.items():
            routes[name] = routes.get(name, 0) + n
    return counts, routes


def threaded_batched(dev, tag, **extra):
    """The threaded runtime with batched aggregation (max_coalesce 8) at
    full width, counters set to 0 before the run: exact accounting, the
    LSTM on the sequence route, then one more round profiled.  Returns
    (counts, routes, idle share of that round)."""
    rounds, hidden = MAIN_PATH["rounds"], MAIN_PATH["hidden"]
    fed = threaded_fed(dev, hidden, batch_aggregation=True, max_coalesce=8,
                       **extra)
    stats, counts, routes, wall = counted_fed(fed, rounds)
    workers = [t.name for t in fed._runtime.drain_workers]
    opts = "".join(f", {k} {v}" for k, v in extra.items())
    print(f"[{tag}] batched (max_coalesce 8{opts}), "
          f"{len(fed.clients)} client threads, drain workers {workers}, "
          f"hidden {hidden}, {rounds} rounds of {MAIN_PATH['epochs']} epochs: "
          f"{wall:.1f} s ({wall:.4f} s); agg_stats {json.dumps(stats)}; "
          f"coalesce_factor {stats['coalesce_factor']}")
    print(f"[{tag}] batched: launches {json.dumps(counts)}; routes and calls "
          f"{json.dumps(routes)}")
    updates = require_exact_accounting(fed, stats, rounds, f"{tag} batched")
    require_sequence_route(counts, routes, f"{tag} batched")
    print(f"[{tag}] batched: {updates} updates, every model's round and "
          "samples exact, no queue left, 0 drain timeouts")
    idle = device_profile(f"{tag} batched, one more round",
                          lambda: fed.run(rounds=1))
    return counts, routes, idle


def threaded_secure(dev, tag, workers_fold=False, **extra):
    """The threaded runtime with secure aggregation and DP at full width,
    counters set to 0 before the run: exact accounting, secure rounds =
    rounds x (1 + clusters) = fold launches, DP releases = dp_clip_noise
    launches = updates, epsilon the closed form.  ``workers_fold``: the
    cluster models' rounds fold in worker processes, whose launches this
    process does not count; its own fold launches are then the global
    model's rounds.  Returns (counts, routes)."""
    rounds, hidden = MAIN_PATH["rounds"], MAIN_PATH["hidden"]
    fed = threaded_fed(dev, hidden, **PRIVACY, **extra)
    stats, counts, routes, wall = counted_fed(fed, rounds)
    fed.shutdown()
    print(f"[{tag}] secure + DP ({json.dumps(dict(PRIVACY, **extra))}): "
          f"{wall:.1f} s ({wall:.4f} s); agg_stats {json.dumps(stats)}")
    print(f"[{tag}] secure + DP: launches {json.dumps(counts)}; routes and "
          f"calls {json.dumps(routes)}")
    require_exact_accounting(fed, stats, rounds, f"{tag} secure")
    require_sequence_route(counts, routes, f"{tag} secure")
    want_rounds = rounds * (1 + len(fed.store.keys()))
    require(stats["secure_rounds"] == want_rounds,
            f"{tag} secure: {stats['secure_rounds']} secure rounds, "
            f"expected {want_rounds}")
    here = rounds if workers_fold else stats["secure_rounds"]
    require(counts["fedavg_agg"] == here,
            f"{tag} secure: {counts['fedavg_agg']} folds in this process for "
            f"{stats['secure_rounds']} secure rounds, expected {here}")
    if workers_fold:
        print(f"[{tag}] secure + DP: {here} global rounds folded here, "
              f"{stats['secure_rounds'] - here} cluster rounds folded in "
              f"the workers (one sdrained reply each); respawns "
              f"{stats['respawns']}")
        require(stats["respawns"] == 0, f"{tag} secure: a worker respawned")
    priv = fed.privacy_report()
    releases = sum(r["steps"] for r in priv["per_client"].values())
    require(counts["dp_clip_noise"] == releases == stats["updates"],
            f"{tag} secure: {counts['dp_clip_noise']} dp_clip_noise "
            f"launches, {releases} DP releases, {stats['updates']} updates")
    sigma = PRIVACY["dp_noise_multiplier"]
    for cid, row in priv["per_client"].items():
        want = closed_form_epsilon(row["steps"], sigma, TARGET_DELTA)
        require(math.isclose(row["epsilon"], want, rel_tol=1e-12),
                f"{tag} secure: client {cid} epsilon {row['epsilon']} != "
                f"{want}")
    print(f"[{tag}] secure + DP: {want_rounds} secure rounds, "
          f"{releases} DP releases = dp_clip_noise launches, epsilon the "
          f"closed form; card: {card_line()}")
    return counts, routes


def phase_threaded(dev) -> tuple[dict, dict, float | None]:
    """The threaded runtime at full width, twice, counters set to 0 before
    each run: batched aggregation (a server drain thread), then secure
    aggregation with DP (barrier rounds).  Returns the two runs' launches
    and routes summed, and the batched round's idle share."""
    c1, r1, idle = threaded_batched(dev, "threaded")
    counts, routes = sum_counts((c1, r1), threaded_secure(dev, "threaded"))
    return counts, routes, idle


# ------------------------------------------------------------------ phase 7
# the thread-sharded server: 2 shards, batched at the threaded runs'
# max_coalesce; the store stress at the reference benchmark's shape
# (benchmarks/sharded_store.py, BENCH_sharded.json)
SHARDED = dict(server_shards=2, batch_aggregation=True, max_coalesce=8)
# the sim's stats keys only a sharded store reports
SHARD_FIELDS = ("shards", "global_drains", "shard_enqueued")
STRESS = dict(writers=8, per_writer=150, clusters=16, shards=4,
              max_coalesce=16, pool=8)
TWO_LEVEL = dict(shards=3, per_shard=9, max_width=4)


class recording_folds:
    """Record the scalar half of every fold the stores and shard workers of
    this process make while the block runs (base meta, the batch's metas
    and deltas, by shard for the two-level fold; for the process tier's
    global merge the plan's metas, and each worker's ``greduce`` weights),
    from which ``implied_launches`` counts the N-way sums on the CPU.
    ``merge_width`` is the process store's ``max_coalesce``, which bounds
    its merge and its workers' partial reductions.  ``timed`` adds each
    fold's wall time, synchronised, to ``seconds``."""

    def __init__(self, merge_width: int = 0, timed: bool = False):
        self.merge_width = merge_width
        self.timed = timed
        self.seconds = 0.0

    def _clocked(self, fn):
        if not self.timed:
            return fn
        import torch

        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
        return run

    def __enter__(self):
        import repro_torch.core.server_proc as server_proc
        import repro_torch.core.store as store

        self.folds = []
        self._saved = (store.coalesced_aggregate,
                       store.two_level_coalesced_aggregate,
                       server_proc.coalesced_aggregate, store.plan_coalesce,
                       server_proc.ShardWorker._greduce,
                       store.aggregate_models)
        flat, two, worker_flat, plan, greduce, pair = self._saved
        flat, two, worker_flat, greduce, pair = map(
            self._clocked, (flat, two, worker_flat, greduce, pair))

        def rec_pair(base_params, base_meta, updated_params, updated_meta,
                     delta, cfg):
            self.folds.append(("pair", base_meta, [(updated_meta, delta)],
                               cfg, 0))
            return pair(base_params, base_meta, updated_params, updated_meta,
                        delta, cfg)

        def rec_flat(base_params, base_meta, updates, cfg):
            updates = list(updates)
            self.folds.append(("flat", base_meta,
                               [(m, d) for _, m, d in updates], None, 0))
            return flat(base_params, base_meta, updates, cfg)

        def rec_worker_flat(base_params, base_meta, updates, cfg):
            updates = list(updates)
            self.folds.append(("flat", base_meta,
                               [(m, d) for _, m, d in updates], None, 0))
            return worker_flat(base_params, base_meta, updates, cfg)

        def rec_two(base_params, base_meta, batches, cfg, *, seqs=None,
                    max_width=0):
            self.folds.append(("two", base_meta,
                               [[(m, d) for _, m, d in b] for b in batches],
                               seqs, max_width))
            return two(base_params, base_meta, batches, cfg, seqs=seqs,
                       max_width=max_width)

        def rec_plan(base_meta, meta_deltas, cfg):
            # only the process store's global merge plans in the store
            # module; the other folds plan inside aggregation.py
            meta_deltas = list(meta_deltas)
            self.folds.append(("merge", base_meta, meta_deltas, None,
                               self.merge_width))
            return plan(base_meta, meta_deltas, cfg)

        def rec_greduce(worker, pairs):
            self.folds.append(("greduce", None,
                               sum(float(w) != 0.0 for _, w in pairs), None,
                               worker.max_coalesce))
            return greduce(worker, pairs)

        store.coalesced_aggregate = rec_flat
        store.two_level_coalesced_aggregate = rec_two
        server_proc.coalesced_aggregate = rec_worker_flat
        store.plan_coalesce = rec_plan
        server_proc.ShardWorker._greduce = rec_greduce
        store.aggregate_models = rec_pair
        return self.folds

    def __exit__(self, *exc):
        import repro_torch.core.server_proc as server_proc
        import repro_torch.core.store as store

        (store.coalesced_aggregate, store.two_level_coalesced_aggregate,
         server_proc.coalesced_aggregate, store.plan_coalesce,
         server_proc.ShardWorker._greduce,
         store.aggregate_models) = self._saved
        return False


def chunk_sums(n: int, width: int) -> tuple[int, int]:
    """(entries left, N-way sums made) when ``chunked_convex_reduce``
    folds ``n`` entries of nonzero mass ``width`` at a time; a chunk of
    one entry passes through without a sum."""
    sums = 0
    while width > 0 and n > width:
        full, rest = divmod(n, width)
        sums += full + (rest > 1)
        n = full + (rest > 0)
    return n, sums


def reduce_sums(n: int, width: int) -> int:
    """N-way sums of one partial reduction of ``n`` entries of nonzero
    mass (a worker's ``greduce``, the process store's merge): the chunks
    of ``chunked_convex_reduce``, then one sum if more than one entry is
    left."""
    left, sums = chunk_sums(n, max(width, 2) if width > 0 else 0)
    return sums + (left > 1)


def implied_launches(folds, cfg=None) -> int:
    """The fold kernel launches the recorded folds imply, from their
    metadata alone (planned under ``cfg``, the stores' config; default
    ``AggregationConfig()``): a flat fold with more than one surviving set is one
    sum; a two-level fold makes one sum per per-shard chunk of more than
    one member and one per merge of more than one entry (none for a lone
    survivor); the process store's global drain makes each worker's
    reduction of its nonzero-weight members and the parent's merge of the
    base (when its weight is nonzero) with the nonempty partials.  Each
    sum here has at most 64 sets: one launch.  An inline fold
    (``aggregate_models``, recorded with its own config) is one sum unless
    it takes the sequential fast path or has no sample mass."""
    from repro_torch.core.aggregation import AggregationConfig, plan_coalesce

    cfg = AggregationConfig() if cfg is None else cfg
    total = 0
    merge = None          # the open process-tier global drain
    for kind, base, batches, seqs, max_width in folds:
        if kind == "pair":
            ((meta, _),) = batches
            total += not ((seqs.sequential_fast_path
                           and meta.round == base.round + 1)
                          or base.samples_learned
                          + meta.samples_learned <= 0)
            continue
        if kind == "greduce":
            total += reduce_sums(batches, max_width)
            merge["partials"] += batches > 0
            continue
        if merge is not None:
            total += reduce_sums(merge["base"] + merge["partials"],
                                 merge["width"])
            merge = None
        if kind == "merge":
            plan = plan_coalesce(base, batches, cfg)
            merge = {"base": int(plan.weights[0] != 0.0), "partials": 0,
                     "width": max_width}
            continue
        if kind == "flat":
            plan = plan_coalesce(base, batches, cfg)
            total += sum(w != 0.0 for w in plan.weights) > 1
            continue
        order = sorted((seqs[k][j] if seqs is not None else (k, j), k, m, d)
                       for k, b in enumerate(batches)
                       for j, (m, d) in enumerate(b))
        plan = plan_coalesce(base, [(m, d) for _, _, m, d in order], cfg)
        survivors = {}
        for (_, k, _, _), w in zip(order, plan.weights[1:], strict=True):
            if w != 0.0:
                survivors[k] = survivors.get(k, 0) + 1
        base_live = plan.weights[0] != 0.0
        if not survivors or (not base_live and sum(survivors.values()) == 1):
            continue
        width = max(max_width, 2) if max_width > 0 else 0
        entries = int(base_live)
        for n in survivors.values():
            left, sums = chunk_sums(n, width)
            entries += left
            total += sums
        while entries > 1:
            if width <= 0 or entries <= width:
                total, entries = total + 1, 1
            else:
                entries, sums = chunk_sums(entries, width)
                total += sums
    if merge is not None:
        total += reduce_sums(merge["base"] + merge["partials"],
                             merge["width"])
    return total


def to_cpu(tree):
    from repro_torch.utils.tree import tree_map

    return tree_map(lambda x: x.cpu(), tree)


def model_keys(store) -> list:
    return [("global", None)] + [("cluster", k) for k in store.keys()]


def params_gap(a, b) -> tuple[float, float]:
    """(max abs difference over every model of two stores, max |p| of
    the first)."""
    from repro_torch.utils.tree import tree_leaves

    gap, top = 0.0, 0.0
    for level, key in model_keys(a):
        for x, y in zip(tree_leaves(a.params(level, key)),
                        tree_leaves(b.params(level, key)), strict=True):
            gap = max(gap, (x.cpu() - y.cpu()).abs().max().item())
            top = max(top, x.abs().max().item())
    return gap, top


def require_same_metas(a, b, what):
    require(sorted(a.keys()) == sorted(b.keys()),
            f"{what}: cluster keys differ")
    for level, key in model_keys(a):
        require(a.meta(level, key) == b.meta(level, key),
                f"{what}: {level} {key} meta {a.meta(level, key)} != "
                f"{b.meta(level, key)}")


def sharded_sim(dev):
    """The sim runtime at full width with the sharded store, then with the
    flat one: stats equal but for the shard fields, metas equal, params
    within 1e-5 x max(1, max|p|), and each run's fold launches equal to
    what its recorded folds imply.  Returns the sharded run's counts,
    routes and FedCCL."""
    rounds, hidden = MAIN_PATH["rounds"], MAIN_PATH["hidden"]
    runs = {}
    for name, extra in (("sharded", SHARDED),
                        ("flat", {k: v for k, v in SHARDED.items()
                                  if k != "server_shards"})):
        fed = threaded_fed(dev, hidden, runtime="sim", **extra)
        with recording_folds() as folds:
            stats, counts, routes, wall = counted_fed(fed, rounds)
        implied = implied_launches(folds)
        print(f"[sharded] sim, {name} store ({json.dumps(extra)}), hidden "
              f"{hidden}: {wall:.1f} s ({wall:.4f} s); stats "
              f"{json.dumps(stats)}; launches {json.dumps(counts)}; "
              f"{len(folds)} folds recorded, {implied} N-way sums implied")
        require_sequence_route(counts, routes, f"sharded sim ({name})")
        require(counts["fedavg_agg"] == implied,
                f"sharded sim ({name}): {counts['fedavg_agg']} fold launches"
                f", the two-level structure implies {implied}")
        runs[name] = (fed, stats, counts, routes)
    fed, stats, counts, routes = runs["sharded"]
    flat, fstats = runs["flat"][:2]
    agg = fed.store.agg_stats()
    require({k: v for k, v in stats.items() if k not in SHARD_FIELDS}
            == fstats, f"sharded sim: stats differ from the flat run's: "
            f"{stats} {fstats}")
    require_same_metas(fed.store, flat.store, "sharded sim")
    gap, top = params_gap(fed.store, flat.store)
    print(f"[sharded] sim: stats equal to the flat run's but for "
          f"{SHARD_FIELDS}, metas equal; params max abs diff {gap:.3e} "
          f"(limit {1e-5 * max(1.0, top):.3e}); global_drains "
          f"{agg['global_drains']}, global_partials {agg['global_partials']}"
          f", shard_enqueued {agg['shard_enqueued']}; fold launches "
          f"{counts['fedavg_agg']} = implied; card: {card_line()}")
    require(gap <= 1e-5 * max(1.0, top), f"sharded sim: params differ from "
            f"the flat run's by {gap}")
    return counts, routes, fed


def store_state(store) -> dict:
    """Every model's meta and params of a store, as JSON: ``{"level:key":
    [[samples, epochs, round], [leaf values, ...]]}``."""
    from repro_torch.utils.tree import tree_leaves

    out = {}
    for level, key in model_keys(store):
        m = store.meta(level, key)
        out[f"{level}:{key}"] = [
            [m.samples_learned, m.epochs_learned, m.round],
            [x.detach().cpu().reshape(-1).tolist()
             for x in tree_leaves(store.params(level, key))]]
    return out


def sharded_sim16(dev) -> dict:
    """The sharded sim at hidden 16 on ``dev``: its stats, models and wall
    time (phase 7's card half; the CPU child runs the CPU half)."""
    fed = threaded_fed(dev, 16, runtime="sim", **SHARDED)
    t0 = time.perf_counter()
    stats = fed.run(rounds=MAIN_PATH["rounds"])
    return {"stats": stats, "models": store_state(fed.store),
            "wall_s": time.perf_counter() - t0}


def check_sharded_cpu(card, cpu):
    """The sharded sim at hidden 16, card against CPU from one init: stats
    and metas equal, params within DROPOUT_ATOL."""
    require(card["stats"] == cpu["stats"], f"sharded sim at hidden 16: "
            f"stats differ {card['stats']} {cpu['stats']}")
    require(sorted(card["models"]) == sorted(cpu["models"]),
            "sharded CUDA vs CPU: models differ")
    gap = 0.0
    for name, (meta, leaves) in card["models"].items():
        cmeta, cleaves = cpu["models"][name]
        require(meta == cmeta, f"sharded CUDA vs CPU: {name} meta {meta} != "
                               f"{cmeta}")
        for x, y in zip(leaves, cleaves, strict=True):
            gap = max([gap] + [abs(a - b) for a, b in zip(x, y, strict=True)])
    print(f"[sharded] sim at hidden 16, CUDA vs CPU ({card['wall_s']:.1f} s "
          f"and {cpu['wall_s']:.1f} s, the CPU half in the child process): "
          f"stats and metas equal, params max abs diff {gap:.3e} (limit "
          f"{DROPOUT_ATOL}); card: {card_line()}")
    require(gap <= DROPOUT_ATOL, f"sharded sim: CUDA and CPU params differ "
            f"by {gap}")


def check_two_level_fold(dev):
    """One two-level fold over forecaster trees made from the seed (3
    shards x 9 updates, max_width 4, fast-path and zero-sample resets) on
    the card against the same fold of CPU copies (``ref.agg_leaves_ref``),
    and its launches against what its structure implies.  Comparison
    launches: kept out of every path's counts."""
    import numpy as np
    import torch
    from repro_torch.configs.solar_lstm import SolarLSTMConfig
    from repro_torch.core.aggregation import (
        ModelMeta,
        UpdateDelta,
        two_level_coalesced_aggregate,
    )
    from repro_torch.kernels.fedavg_agg import ops
    from repro_torch.models.lstm import SolarForecaster
    from repro_torch.utils.tree import flatten_params

    k, per, width = (TWO_LEVEL[x] for x in ("shards", "per_shard",
                                             "max_width"))
    fc = SolarForecaster(SolarLSTMConfig(hidden_size=MAIN_PATH["hidden"]))
    gen = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.default_rng(3)
    base, base_meta = fc.init(gen, dev), ModelMeta(500, 3, 4)
    batches, seqs = [[] for _ in range(k)], [[] for _ in range(k)]
    for seq in range(k * per):
        s = 0 if seq in (7, 19) else int(rng.integers(20, 300))
        # seq 4 lands on the fast path (round = base round + rounds before
        # it + 1); seqs 7 and 19 are zero-sample resets
        rnd = 9 if seq == 4 else int(rng.integers(1, 5))
        batches[seq % k].append((fc.init(gen, dev), ModelMeta(s, 3, rnd),
                                 UpdateDelta(s, 3, 1)))
        seqs[seq % k].append(seq)

    def fold(b, bs):
        return two_level_coalesced_aggregate(b, base_meta, bs, seqs=seqs,
                                             max_width=width)
    before = ops.launches_leaves
    got = fold(base, batches)
    torch.cuda.synchronize()
    launched = ops.launches_leaves - before
    want = fold(to_cpu(base), [[(to_cpu(p), m, d) for p, m, d in b]
                               for b in batches])
    implied = implied_launches([("two", base_meta,
                                 [[(m, d) for _, m, d in b] for b in batches],
                                 seqs, width)])
    err = (flatten_params(got.params).cpu()
           - flatten_params(want.params)).abs().max().item()
    ms = cuda_ms(lambda: fold(base, batches), iters=20, warmup=2)
    print(f"[sharded] two_level_coalesced_aggregate, {k} shards x {per} "
          f"updates at T {SOLAR_PARAMS}, max_width {width}: "
          f"{got.n_fast_path} fast-path resets, {got.n_param_sets} sets "
          f"into the merge, {got.n_partials} partials, {launched} "
          f"leaf-kernel launches ({implied} implied); CUDA vs CPU plain "
          f"max abs err {err:.3e} (limit 1e-6); {ms:.5f} ms a fold back to "
          f"back; card: {card_line()}")
    require(launched == implied, f"two-level fold: {launched} launches, "
            f"{implied} implied")
    require(err <= 1e-6, f"two-level fold: CUDA vs CPU err {err}")
    require(got.meta == want.meta and got.n_partials == want.n_partials,
            "two-level fold: CUDA and CPU plans differ")


def stress_draws(n_writers, per_writer, n_clusters):
    """Each writer's (cluster key, samples) draws, as
    ``benchmarks/sharded_store.py``'s writers make them, and the per-model
    (rounds, samples) they add up to (key None: the global model)."""
    import numpy as np

    draws, want = [], {}
    for idx in range(n_writers):
        wrng = np.random.default_rng(10_000 + idx)
        mine = []
        for _ in range(per_writer):
            s = int(wrng.integers(20, 200))
            key = f"c{int(wrng.integers(n_clusters))}"
            mine.append((key, s))
            for k in (key, None):
                r, n = want.get(k, (0, 0))
                want[k] = (r + 1, n + s)
        draws.append(mine)
    return draws, want


def stress_store(name, store, pools, draws, want, fetchers=(0, 0),
                 tag="sharded"):
    """One writer thread a pool, each submitting a cluster and a global
    update per draw, against the store's drain workers
    (``AsyncThreadedRuntime``), beside ``fetchers`` = (threads, fetches
    each) serving ``request_model`` + ``packb`` as
    ``benchmarks/multiproc_store.py``'s fetchers do; the clock stops after
    the workers' final sweeps.  Exact accounting; returns the row it
    prints."""
    import threading
    import numpy as np
    import torch
    from repro_torch.checkpoint.msgpack_ckpt import packb
    from repro_torch.core.aggregation import ModelMeta, UpdateDelta
    from repro_torch.core.runtime_threaded import AsyncThreadedRuntime
    from repro_torch.kernels.fedavg_agg import ops

    n_fetchers, per_fetcher = fetchers
    keys = sorted({k for d in draws for k, _ in d})

    def fetcher(idx):
        frng = np.random.default_rng(20_000 + idx)
        for _ in range(per_fetcher):
            if frng.random() < 0.5:
                params, _ = store.request_model("global")
            else:
                params, _ = store.request_model(
                    "cluster", keys[int(frng.integers(len(keys)))])
            packb(params)        # wire-serialize the served snapshot

    def writer(idx):
        pool = pools[idx]
        for i, (key, s) in enumerate(draws[idx]):
            tree = pool[i % len(pool)]
            store.handle_model_update("cluster", key, tree,
                                      ModelMeta(s, 1, 1), UpdateDelta(s, 1, 1))
            store.handle_model_update("global", None, tree,
                                      ModelMeta(s, 1, 1), UpdateDelta(s, 1, 1))

    rt = AsyncThreadedRuntime([], store, drain_poll=1e-4, join_timeout=60.0)
    stop = threading.Event()
    threads = [threading.Thread(target=writer, args=(i,))
               for i in range(len(pools))] + \
        [threading.Thread(target=fetcher, args=(i,))
         for i in range(n_fetchers)]
    torch.cuda.synchronize()
    before = ops.launches_leaves
    t0 = time.perf_counter()
    rt._start_drain_workers(stop)
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rt._join_drain_workers(stop)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(not rt.errors, f"stress {name}: {rt.errors[:1]}")
    stats = store.agg_stats()
    submits = sum(len(d) for d in draws) * 2
    require(stats["updates"] == stats["enqueued"] == submits
            and stats["drain_timeouts"] == 0,
            f"stress {name}: {stats['updates']} updates, "
            f"{stats['enqueued']} enqueued, {submits} submitted")
    for key, (r, n) in want.items():
        level = "global" if key is None else "cluster"
        meta = store.meta(level, key)
        require((meta.round, meta.samples_learned) == (r, n)
                and store.pending_depth(level, key) == 0,
                f"stress {name}: {level} {key} round {meta.round} samples "
                f"{meta.samples_learned}, expected {r} and {n}")
    row = {"store": name, "shards": getattr(store, "n_shards", 0),
           "drain_workers": [t.name for t in rt.drain_workers],
           "submits": submits, "wall_s": wall,
           "submits_per_s": submits / wall,
           "coalesce_factor": stats["coalesce_factor"],
           "max_queue_depth": stats["max_queue_depth"],
           "fold_launches": ops.launches_leaves - before}
    if n_fetchers:
        row["fetches"] = n_fetchers * per_fetcher
        row["fetches_per_s"] = row["fetches"] / wall
    for k in ("global_drains", "global_partials", "transport", "respawns",
              "wire_tx_bytes", "wire_rx_bytes"):
        if k in stats:
            row[k] = stats[k]
    require(stats.get("respawns", 0) == 0, f"stress {name}: a worker "
                                           "respawned")
    print(f"[{tag}] stress {json.dumps(row)}; every model's round and "
          f"samples exact, no queue left; card: {card_line()}")
    return row


def sharded_stress(dev):
    """The reference benchmark's store stress (8 writers x 150 submits of
    a cluster and a global update, 16 clusters, max_coalesce 16) with the
    forecaster's tree at hidden 128 on the card: the flat batched store,
    then the sharded store at 4 shards.  A measurement: no rate is
    held."""
    import torch
    from repro_torch.configs.solar_lstm import SolarLSTMConfig
    from repro_torch.core.store import ModelStore, ShardedModelStore
    from repro_torch.models.lstm import SolarForecaster

    n_w, per, n_c = (STRESS[x] for x in ("writers", "per_writer",
                                          "clusters"))
    fc = SolarForecaster(SolarLSTMConfig(hidden_size=MAIN_PATH["hidden"]))
    gen = torch.Generator(device=dev).manual_seed(100)
    pools = [[fc.init(gen, dev) for _ in range(STRESS["pool"])]
             for _ in range(n_w)]
    init = fc.init(gen, dev)
    keys = [f"c{i}" for i in range(n_c)]
    draws, want = stress_draws(n_w, per, n_c)
    kw = dict(batch_aggregation=True, max_coalesce=STRESS["max_coalesce"])
    # a short run on a throwaway store first, so neither timed run pays
    # the allocator's first requests
    stress_store("warm-up", ShardedModelStore(init, keys, n_shards=2, **kw),
                 pools[:2], *stress_draws(2, 8, n_c))
    stress_store("flat_batched", ModelStore(init, keys, **kw), pools, draws,
                 want)
    stress_store(f"sharded_{STRESS['shards']}",
                 ShardedModelStore(init, keys, n_shards=STRESS["shards"],
                                   **kw), pools, draws, want)


def check_checkpoint(dev, store):
    """``save_store`` of the sharded run's store writes the same bytes from
    the card as from a CPU copy; ``load_store(..., device=dev)`` gives the
    params bit for bit and the metas."""
    import tempfile
    import torch
    from repro_torch.checkpoint.msgpack_ckpt import load_store, save_store
    from repro_torch.core.store import GLOBAL_KEY, ShardedModelStore
    from repro_torch.utils.tree import tree_leaves

    copy = ShardedModelStore(to_cpu(store.params("global")), store.keys(),
                             n_shards=store.n_shards)
    for key in [GLOBAL_KEY] + store.keys():
        params, meta = store._records[key].snapshot()
        copy._records[key].swap(to_cpu(params), meta)
    with tempfile.TemporaryDirectory() as tmp:
        card, host = Path(tmp) / "card.msgpack", Path(tmp) / "cpu.msgpack"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_store(card, store)
        save_ms = (time.perf_counter() - t0) * 1e3
        save_store(host, copy)
        raw = card.read_bytes()
        require(raw == host.read_bytes(),
                "checkpoint: the card's bytes differ from the CPU copy's")
        t0 = time.perf_counter()
        back = load_store(card, device=dev)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
    require_same_metas(back, store, "checkpoint")
    for level, key in model_keys(store):
        for x, y in zip(tree_leaves(back.params(level, key)),
                        tree_leaves(store.params(level, key)), strict=True):
            require(x.device == y.device and torch.equal(x, y),
                    f"checkpoint: {level} {key} params differ")
    print(f"[sharded] checkpoint of the sharded sim's store "
          f"({len(model_keys(store))} models): {len(raw)} bytes, the same "
          f"from the card as from a CPU copy; save {save_ms:.2f} ms, load "
          f"to {dev} {load_ms:.2f} ms; params bit for bit, metas equal; "
          f"card: {card_line()}")


def phase_sharded(dev, flat_idle) -> tuple[dict, dict, dict]:
    """The thread-sharded server (``FedCCLConfig(server_shards=2)``) at the
    main path's full width: the sim against the flat store, the sim at
    hidden 16 on the card (its CPU half runs in the CPU child), the
    threaded runtime batched (per-shard drain workers) and secure + DP,
    the two-level fold against its plain version, the store stress and
    the checkpoint.  Returns the launches and routes of the sim and the
    two threaded runs summed (counters set to 0 before each), and the
    hidden-16 sim's result for ``check_sharded_cpu``."""
    sim_counts, sim_routes, sim = sharded_sim(dev)
    card16 = sharded_sim16(dev)
    c2, r2, idle = threaded_batched(dev, "sharded", server_shards=2)
    print(f"[sharded] idle share of one more threaded batched round: "
          f"sharded {idle}, flat {flat_idle} (phase threaded); card: "
          f"{card_line()}")
    counts, routes = sum_counts(
        (sim_counts, sim_routes), (c2, r2),
        threaded_secure(dev, "sharded", server_shards=2))
    for name in PRIVACY_KERNELS:
        require(counts[name] > 0, f"kernel {name} never launched on the "
                                  "sharded path")
    check_two_level_fold(dev)
    sharded_stress(dev)
    check_checkpoint(dev, sim.store)
    return counts, routes, card16


# ------------------------------------------------------------------ phase 8
# the process and TCP server tiers: 2 workers, batched at the threaded
# runs' max_coalesce; the store stress at benchmarks/multiproc_store.py's
# shape (4 writers, 4 fetchers, 16 clusters, max_coalesce 16) with a
# quarter of its counts (25 submits a writer, 1,250 fetches a fetcher: the
# full counts took 84-86 s of the smoke at 18-20 submits/s, which phase 14
# needed; the rates are measured, not held)
PROCESS = dict(server_processes=2, batch_aggregation=True, max_coalesce=8)
# the sim's stats keys only a process-sharded store reports
PROC_FIELDS = ("processes", "respawns", "drain_timeouts")
MP_STRESS = dict(writers=4, per_writer=25, fetchers=4, per_fetcher=1250,
                 clusters=16, shards=2, max_coalesce=16, pool=8)


def compute_apps() -> list:
    """The card's compute processes as ``nvidia-smi --query-compute-apps``
    lists them: ``[(pid, used memory), ...]``.  Inside the chip's
    container it lists every process under pid 1, so a process is shown
    by the count of entries, not by its pid."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return [tuple(x.strip() for x in line.split(",", 1))
            for line in out.stdout.strip().splitlines() if "," in line]


def require_on_card(pids, before, what) -> list:
    """The processes ``pids`` hold a CUDA context: nvidia-smi lists each
    pid among the compute processes or, where it cannot see them (a
    container's pid namespace), lists one more entry for each of them
    than ``before`` they started."""
    apps = compute_apps()
    listed = {p for p, _ in apps}
    seen = [pid for pid in pids if str(pid) in listed]
    print(f"[process] {what}: pids {pids}; nvidia-smi compute apps before "
          f"{before}, now {apps}")
    if seen:
        require(len(seen) == len(pids), f"{what}: pids "
                f"{sorted(set(pids) - set(seen))} not listed by nvidia-smi")
    else:
        require(len(apps) - len(before) >= len(pids),
                f"{what}: {len(apps) - len(before)} new compute processes "
                f"on the card for {len(pids)} pids")
    return apps


class ThreadShardServers:
    """N shard servers (``repro_torch.launch.shard_server.serve``) on
    threads of this process, on port 0 and ``dev``, so their folds count
    in this process's launch counters; ``close`` sends each a
    ``shutdown``."""

    def __init__(self, n, dev):
        import threading
        from repro_torch.launch import shard_server

        self.ports, self.threads = [], []
        for _ in range(n):
            ready = threading.Event()
            port = []

            def announce(line, flush=True, port=port, ready=ready):
                port.append(int(line.rsplit("port=", 1)[1]))
                ready.set()
            t = threading.Thread(target=shard_server.serve,
                                 args=("127.0.0.1", 0, announce, str(dev)),
                                 daemon=True)
            t.start()
            require(ready.wait(60.0), "a thread-hosted shard server did not "
                                      "announce")
            self.ports.append(port[0])
            self.threads.append(t)

    @property
    def hosts(self):
        return [f"127.0.0.1:{p}" for p in self.ports]

    def close(self):
        import socket
        from repro_torch.checkpoint.msgpack_ckpt import packb
        from repro_torch.core.transport import recv_frame, send_frame

        for port, t in zip(self.ports, self.threads, strict=True):
            with socket.create_connection(("127.0.0.1", port), 10.0) as c:
                send_frame(c, packb(["shutdown"]))
                recv_frame(c)
            t.join(10.0)
            require(not t.is_alive(), "a shard server thread did not stop")


def process_sim(dev):
    """The sim runtime at full width with ``server_processes=2`` (the
    in-process emulation: the workers fold in this process) beside the
    thread-sharded store at 2 shards: stats equal but for the process
    fields, metas equal, params within 1e-5 x max(1, max|p|), each run's
    fold launches equal to what its recorded folds imply.  Returns the
    process run's counts and routes."""
    rounds, hidden = MAIN_PATH["rounds"], MAIN_PATH["hidden"]
    runs = {}
    for name, extra in (("process", PROCESS), ("sharded", SHARDED)):
        fed = threaded_fed(dev, hidden, runtime="sim", **extra)
        with recording_folds(extra["max_coalesce"]) as folds:
            stats, counts, routes, wall = counted_fed(fed, rounds)
        implied = implied_launches(folds)
        print(f"[process] sim, {name} store ({json.dumps(extra)}), hidden "
              f"{hidden}: {wall:.1f} s ({wall:.4f} s); stats "
              f"{json.dumps(stats)}; launches {json.dumps(counts)}; "
              f"{len(folds)} folds recorded, {implied} N-way sums implied")
        require_sequence_route(counts, routes, f"process sim ({name})")
        require(counts["fedavg_agg"] == implied,
                f"process sim ({name}): {counts['fedavg_agg']} fold "
                f"launches, the recorded folds imply {implied}")
        runs[name] = (fed, stats, counts, routes)
    fed, stats, counts, routes = runs["process"]
    sharded, sstats = runs["sharded"][:2]
    require(stats["processes"] == 0 and stats["respawns"] == 0
            and stats["drain_timeouts"] == 0,
            f"process sim: {stats['respawns']} respawns, "
            f"{stats['drain_timeouts']} drain timeouts")
    require({k: v for k, v in stats.items() if k not in PROC_FIELDS}
            == sstats, f"process sim: stats differ from the thread-sharded "
            f"run's: {stats} {sstats}")
    require_same_metas(fed.store, sharded.store, "process sim")
    gap, top = params_gap(fed.store, sharded.store)
    agg = fed.store.agg_stats()
    print(f"[process] sim: stats equal to the thread-sharded run's but for "
          f"{PROC_FIELDS}, metas equal; params max abs diff {gap:.3e} "
          f"({'bit-equal' if gap == 0.0 else 'not bit-equal'}; limit "
          f"{1e-5 * max(1.0, top):.3e}); wire bytes tx {agg['wire_tx_bytes']}"
          f" rx {agg['wire_rx_bytes']}; fold launches {counts['fedavg_agg']}"
          f" = implied; card: {card_line()}")
    require(gap <= 1e-5 * max(1.0, top), f"process sim: params differ from "
            f"the thread-sharded run's by {gap}")
    fed.shutdown()
    return counts, routes


def process_threaded(dev):
    """The threaded runtime with ``server_processes=2``: spawned workers
    folding on the card.  Batched: construction (the workers' cold
    starts), the workers listed by nvidia-smi, exact accounting with 0
    drain timeouts and 0 respawns, wall time.  Then secure + DP, whose
    cluster rounds fold in the workers.  Returns the two runs' launches
    and routes in this process."""
    rounds, hidden = MAIN_PATH["rounds"], MAIN_PATH["hidden"]
    before = compute_apps()
    t0 = time.perf_counter()
    fed = threaded_fed(dev, hidden, **PROCESS)
    built = time.perf_counter() - t0
    handles = [sh.handle for sh in fed.store._proc_shards]
    pids = [h.proc.pid for h in handles]
    require_on_card(pids, before, "spawned workers")
    stats, counts, routes, wall = counted_fed(fed, rounds)
    workers = [t.name for t in fed._runtime.drain_workers]
    print(f"[process] threaded, spawned workers ({json.dumps(PROCESS)}), "
          f"pumps {workers}, hidden {hidden}, {rounds} rounds of "
          f"{MAIN_PATH['epochs']} epochs: {wall:.1f} s ({wall:.4f} s); "
          f"FedCCL built in {built:.2f} s, worker cold starts (spawn to "
          f"ready: interpreter, torch, CUDA context, kernel library) "
          f"{[round(h.cold_start_s, 3) for h in handles]} s; agg_stats "
          f"{json.dumps(stats)}; launches here {json.dumps(counts)}")
    require(workers == ["process-pump"], f"process threaded: pumps {workers}")
    require_exact_accounting(fed, stats, rounds, "process threaded")
    require(stats["respawns"] == 0 and fed.store.worker_spawns() == [1, 1],
            f"process threaded: {stats['respawns']} respawns")
    require_sequence_route(counts, routes, "process threaded")
    fed.shutdown()
    print(f"[process] threaded batched: exact accounting, 0 drain "
          f"timeouts, 0 respawns; card: {card_line()}")
    secure = threaded_secure(dev, "process", workers_fold=True,
                             server_processes=2)
    return sum_counts((counts, routes), secure)


def fetch_pass(fed) -> int:
    """``model_for`` of every client at its cluster and the global level
    (served through the read tier); returns the fetches made."""
    n = 0
    for c in fed.clients:
        for level in (["cluster"] if c.cluster_keys else []) + ["global"]:
            fed.model_for(c.spec.client_id, level)
            n += 1
    return n


def process_tcp(dev, srv):
    """``server_hosts`` on two subprocess shard servers folding on the
    card (``--device cuda``), the threaded runtime with
    ``fetch_from_workers``: exact accounting, the servers listed by
    nvidia-smi, fetch counts by kind with no fallback while the servers
    are up, and fetched bytes equal to the store's; then an
    ``owner|replica`` pair: a fetch from the replica after an ordered
    barrier equals the store.  Returns the run's counts and routes."""
    import torch
    from repro_torch.checkpoint.msgpack_ckpt import packb
    from repro_torch.configs.solar_lstm import SolarLSTMConfig
    from repro_torch.core.aggregation import ModelMeta, UpdateDelta
    from repro_torch.core.fetch import FetchClient
    from repro_torch.core.store import ProcessShardedModelStore
    from repro_torch.models.lstm import SolarForecaster

    rounds, hidden = MAIN_PATH["rounds"], MAIN_PATH["hidden"]
    extra = dict(server_hosts=tuple(srv.hosts), fetch_from_workers=True,
                 batch_aggregation=True, max_coalesce=8)
    fed = threaded_fed(dev, hidden, **extra)
    stats, counts, routes, wall = counted_fed(fed, rounds)
    print(f"[process] threaded over TCP (2 servers --device cuda, started "
          f"in {[round(t, 3) for t in srv.startup_s]} s), hidden {hidden}: "
          f"{wall:.1f} s ({wall:.4f} s); agg_stats {json.dumps(stats)}; "
          f"launches here {json.dumps(counts)}")
    require_exact_accounting(fed, stats, rounds, "tcp threaded")
    require(stats["respawns"] == 0, "tcp threaded: a server was reconnected")
    require_sequence_route(counts, routes, "tcp threaded")
    t0 = time.perf_counter()
    n = fetch_pass(fed)                 # full
    fed.run(rounds=1)
    n += fetch_pass(fed)                # delta or full
    n += fetch_pass(fed)                # not modified
    fetch_s = time.perf_counter() - t0
    fc = fed.fetcher
    print(f"[process] read tier: {n} fetches around one more round "
          f"({fetch_s:.3f} s with the round), counts {json.dumps(fc.counts)}"
          f", tx {fc.tx_bytes} rx {fc.rx_bytes} bytes")
    require(fc.counts["fallback"] == 0, "read tier: fetches fell back to "
                                        "the parent")
    require(sum(fc.counts[k] for k in ("full", "not_modified", "delta"))
            == n and fc.counts["not_modified"] > 0,
            f"read tier: counts {fc.counts} for {n} fetches")
    for level, key in model_keys(fed.store):
        got, meta = fc.fetch(level, key)
        want, wmeta = fed.store.request_model(level, key)
        require(meta == wmeta and packb(got) == packb(want),
                f"read tier: {level} {key} differs from the store")
    fed.shutdown()
    # owner|replica: one shard, the second server mirrors the first
    fc_model = SolarForecaster(SolarLSTMConfig(hidden_size=hidden))
    gen = torch.Generator(device=dev).manual_seed(7)
    store = ProcessShardedModelStore(
        fc_model.init(gen, dev), ["c0"], device=dev,
        server_hosts=[f"{srv.hosts[0]}|{srv.hosts[1]}"])
    for r in range(4):
        store.handle_model_update("cluster", "c0", fc_model.init(gen, dev),
                                  ModelMeta(5 + r, 1, 1),
                                  UpdateDelta(5 + r, 1, 1))
    store.drain_all()
    # ordered barrier: mirror pushes are puts on the replica's command
    # session, so a replying command on that session returns after them
    for h in store._proc_shards[0].replicas:
        h.rpc(packb(["ping"]), 30.0)
    with FetchClient(store, conditional=False, device=dev) as reader:
        for _ in range(2):              # round-robin: replica, then owner
            got, meta = reader.fetch("cluster", "c0")
            want, wmeta = store.request_model("cluster", "c0")
            require(meta == wmeta and packb(got) == packb(want),
                    "replica: fetched params differ from the store")
        require(len(reader._conns) == 2 and reader.counts["fallback"] == 0,
                f"replica: {len(reader._conns)} endpoints served, "
                f"{reader.counts['fallback']} fallbacks")
    rstats = store.agg_stats()
    store.close()
    print(f"[process] owner|replica: {rstats['replica_pushes']} mirror "
          f"pushes; after a ping on the replica's command session, the "
          f"replica's and the owner's fetches equal the store byte for "
          f"byte; card: {card_line()}")
    return counts, routes


def process_thread_hosted(dev):
    """Two shard servers on threads of this process, on the card: the
    threaded runtime batched (fold launches = what the recorded folds
    imply) and secure + DP (fold launches = secure rounds).  Returns the
    runs' counts and routes."""
    rounds, hidden = MAIN_PATH["rounds"], MAIN_PATH["hidden"]
    servers = ThreadShardServers(2, dev)
    try:
        extra = dict(server_hosts=tuple(servers.hosts),
                     batch_aggregation=True, max_coalesce=8)
        fed = threaded_fed(dev, hidden, **extra)
        with recording_folds(extra["max_coalesce"]) as folds:
            stats, counts, routes, wall = counted_fed(fed, rounds)
        fed.shutdown()
        implied = implied_launches(folds)
        print(f"[process] threaded over TCP, servers on threads of this "
              f"process: {wall:.1f} s ({wall:.4f} s); agg_stats "
              f"{json.dumps(stats)}; launches {json.dumps(counts)}; "
              f"{len(folds)} folds recorded, {implied} N-way sums implied")
        require_exact_accounting(fed, stats, rounds, "thread-hosted tcp")
        require_sequence_route(counts, routes, "thread-hosted tcp")
        require(counts["fedavg_agg"] == implied,
                f"thread-hosted tcp: {counts['fedavg_agg']} fold launches, "
                f"the recorded folds imply {implied}")
        secure = threaded_secure(dev, "process",
                                 server_hosts=tuple(servers.hosts))
    finally:
        servers.close()
    return sum_counts((counts, routes), secure)


def process_stress(dev, srv):
    """``benchmarks/multiproc_store.py``'s mixed storm (4 writers x 25
    cluster and global submits, 4 fetchers x 1,250 ``request_model`` +
    ``packb``: a quarter of its counts; 16 clusters, max_coalesce 16) with
    the forecaster's tree on the card: the process store (2 spawned
    workers) and the TCP store (the 2 subprocess servers).  A measurement:
    no rate is held."""
    import torch
    from repro_torch.configs.solar_lstm import SolarLSTMConfig
    from repro_torch.core.store import ProcessShardedModelStore
    from repro_torch.models.lstm import SolarForecaster

    n_w, per, n_c = (MP_STRESS[x] for x in ("writers", "per_writer",
                                             "clusters"))
    fc = SolarForecaster(SolarLSTMConfig(hidden_size=MAIN_PATH["hidden"]))
    gen = torch.Generator(device=dev).manual_seed(100)
    pools = [[fc.init(gen, dev) for _ in range(MP_STRESS["pool"])]
             for _ in range(n_w)]
    init = fc.init(gen, dev)
    keys = [f"c{i}" for i in range(n_c)]
    draws, want = stress_draws(n_w, per, n_c)
    fetchers = (MP_STRESS["fetchers"], MP_STRESS["per_fetcher"])
    kw = dict(batch_aggregation=True, max_coalesce=MP_STRESS["max_coalesce"],
              device=dev)
    for name, extra in (
            (f"process_{MP_STRESS['shards']}",
             dict(n_shards=MP_STRESS["shards"])),
            (f"tcp_{MP_STRESS['shards']}", dict(server_hosts=srv.hosts))):
        with ProcessShardedModelStore(init, keys, **extra, **kw) as store:
            stress_store(name, store, pools, draws, want, fetchers,
                         tag="process")


@contextlib.contextmanager
def shard_servers(dev):
    """Two ``--device cuda`` subprocess shard servers, listed on the card,
    shared by phases 8-10 (one cold start)."""
    from repro_torch.core.transport import LoopbackShardServers

    before = compute_apps()
    with LoopbackShardServers(2, device=str(dev)) as srv:
        require_on_card(srv.pids, before, "subprocess shard servers")
        yield srv


def phase_process(dev, srv) -> tuple[dict, dict]:
    """The process and TCP server tiers at the main path's full width: the
    sim on the in-process emulation against the thread-sharded store, the
    threaded runtime on spawned workers (batched, secure + DP), on the two
    subprocess shard servers ``srv`` with the read tier and a replica, on
    two thread-hosted servers (launches counted here), and the mixed store
    stress.  Returns the launches and routes of the runs in this process,
    summed (counters set to 0 before each)."""
    runs = [process_sim(dev), process_threaded(dev),
            process_tcp(dev, srv), process_thread_hosted(dev)]
    process_stress(dev, srv)
    counts, routes = sum_counts(*runs)
    for name in PRIVACY_KERNELS:
        require(counts[name] > 0, f"kernel {name} never launched on the "
                                  "process path")
    return counts, routes


# ------------------------------------------------------------------ phase 9
# telemetry: the main path's sim batched at the threaded runs' max_coalesce
# (the flat store; its histograms are those of a queue), the reference's
# telemetry-parity schedule (tests/test_store_equivalence.py: 40 updates,
# 5 cluster keys, max_coalesce 5), and the flat store stress of phase 7
TELEMETRY_SIM = dict(batch_aggregation=True, max_coalesce=8)
# histograms that do not depend on time: equal across devices, widths
# (the sim's schedule does not depend on hidden) and topologies
DETERMINISTIC_HISTS = ("staleness_at_fold", "coalesce_batch", "queue_depth",
                       "submit_batch")
REPORT_HISTS = ("submit_latency_ns", "queue_depth", "staleness_at_fold",
                "coalesce_batch")
PARITY = dict(n_updates=40, n_keys=5, max_coalesce=5, seed=42)


class patched_solar:
    """``run_fedccl_solar`` with extra ``FedCCLConfig`` fields; records the
    ``FedCCL`` it builds (the block yields the list)."""

    def __init__(self, **extra):
        self.extra = extra

    def __enter__(self):
        import functools
        import repro_torch.training.fed_solar as fed_solar

        self._saved = (fed_solar.FedCCLConfig, fed_solar.FedCCL)
        cfg_cls, fed_cls = self._saved
        self.feds = []

        def make(*a, **kw):
            self.feds.append(fed_cls(*a, **kw))
            return self.feds[-1]

        fed_solar.FedCCLConfig = functools.partial(cfg_cls, **self.extra)
        fed_solar.FedCCL = make
        return self.feds

    def __exit__(self, *exc):
        import repro_torch.training.fed_solar as fed_solar

        fed_solar.FedCCLConfig, fed_solar.FedCCL = self._saved
        return False


def deterministic_hists(histograms) -> dict:
    return {name: histograms.get(name) for name in DETERMINISTIC_HISTS}


def merged_hists(dump) -> dict:
    from repro_torch.obs.export import merged_metrics

    return merged_metrics(dump)["histograms"]


def cpu_child(out_dir):
    """The CPU child's job (``CpuChild``): the CPU halves of five
    card-against-CPU checks, one after the other, in the order the main
    process needs them, each result written to ``out_dir`` whole (a
    temporary name, then a rename): phase 12's LLM gradients
    (``grads_<arch>.pt``: the loss and every leaf's gradient, the plain
    VJPs), then phase 16's quickstart runs on the four topologies
    (``quickstart.pt``) and phase 17's sharded chaos run
    (``chaos.json``), phase 7's sharded sim at hidden 16
    (``sharded.json``) and phase 9's telemetry sim at hidden 16
    (``telemetry.json``: its stats and deterministic histograms), all
    checked at the end."""
    import torch

    sys.path.insert(0, str(REPO / "src"))
    torch.set_num_threads(2)
    out_dir = Path(out_dir)

    def publish(name, write):
        part = out_dir / f"{name}.part"
        write(part)
        os.replace(part, out_dir / name)

    for arch in LLM:
        t0 = time.perf_counter()
        cfg, model, params, batch = llm_agree_case(arch)
        loss, grads = llm_loss_grads(model, cfg, params, batch)
        result = {"loss": loss, "grads": grads,
                  "wall_s": time.perf_counter() - t0}
        publish(f"grads_{arch}.pt", lambda f: torch.save(result, f))
    quick = {topology: {"info": json.dumps(run["info"]),
                        "params": run["params"]}
             for topology, run in quickstart_cpu().items()}
    publish("quickstart.pt", lambda f: torch.save(quick, f))
    chaos = json.dumps(chaos_cpu())
    publish("chaos.json", lambda f: f.write_text(chaos))
    sharded = json.dumps(sharded_sim16("cpu"))
    publish("sharded.json", lambda f: f.write_text(sharded))
    t0 = time.perf_counter()
    fed = threaded_fed("cpu", 16, runtime="sim", telemetry=True,
                       **TELEMETRY_SIM)
    stats = fed.run(rounds=MAIN_PATH["rounds"])
    hists = deterministic_hists(merged_hists(fed.store.telemetry_dump()))
    telemetry = json.dumps({"stats": stats, "hists": hists,
                            "wall_s": time.perf_counter() - t0})
    publish("telemetry.json", lambda f: f.write_text(telemetry))


CHILD_WAIT_S = 900


class CpuChild:
    """``cpu_child`` in a process of its own (two CPU threads, no card),
    started before phase 7, so its minutes on the CPU overlap the phases
    on the card; ``result(name)`` and ``tensors(name)`` wait for one
    result (up to CHILD_WAIT_S from the call) and read it."""

    def __init__(self):
        import tempfile

        self._dir = tempfile.TemporaryDirectory()
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONHASHSEED="0",
                   PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                               str(REPO)]))
        self._err = open(Path(self._dir.name) / "stderr", "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.cpu_child({self._dir.name!r})"],
            cwd=str(REPO), env=env, stdout=subprocess.DEVNULL,
            stderr=self._err)

    def _done(self, path: Path) -> Path:
        deadline = time.monotonic() + CHILD_WAIT_S
        while not path.exists() and self.proc.poll() is None:
            if time.monotonic() > deadline:     # stopped; its stderr kept
                self.proc.kill()
                self.proc.wait(10.0)
                break
            time.sleep(0.5)
        require(path.exists() and self.proc.returncode in (None, 0),
                f"the CPU child failed (exit {self.proc.returncode}, "
                f"{path.name} {'written' if path.exists() else 'missing'}): "
                f"{(Path(self._dir.name) / 'stderr').read_text()[-2000:]}")
        return path

    def result(self, name: str) -> dict:
        return json.loads(self._done(
            Path(self._dir.name) / f"{name}.json").read_text())

    def tensors(self, name: str) -> dict:
        import torch

        return torch.load(self._done(Path(self._dir.name) / f"{name}.pt"))

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(10.0)
        self._err.close()
        self._dir.cleanup()


def telemetry_sim(dev):
    """The main path at full width under the sim, batched, telemetry on and
    off, counters set to 0 before each: Table II, §IV.E, clusters and
    ``async_stats`` bit-equal; then the same sim at hidden 16 on the card,
    whose deterministic histograms must equal the full-width run's.
    Returns (counts, routes, hidden-16 stats and histograms)."""
    runs = {}
    for on in (True, False):
        with patched_solar(telemetry=on, **TELEMETRY_SIM) as feds:
            report, counts, routes, wall = counted_run(dev, MAIN_PATH)
        runs[on] = (report, counts, routes, feds[0])
        print(f"[telemetry] sim, main path batched "
              f"({json.dumps(TELEMETRY_SIM)}), telemetry {on}: {wall:.1f} s "
              f"({wall:.4f} s); launches {json.dumps(counts)}")
        require_sequence_route(counts, routes, f"telemetry sim ({on})")
        check_table(report, f"telemetry sim ({on})")
    (on, c_on, r_on, fed), (off, c_off, r_off, _) = runs[True], runs[False]
    for key in ("clusters", "table2", "independent", "async_stats"):
        require(on[key] == off[key], f"telemetry sim: {key} changes with "
                f"telemetry on: {on[key]} {off[key]}")
    dump = fed.store.telemetry_dump()
    hists = deterministic_hists(merged_hists(dump))
    require(hists["staleness_at_fold"] is not None
            and hists["staleness_at_fold"]["count"]
            == on["async_stats"]["updates"],
            f"telemetry sim: staleness observed {hists['staleness_at_fold']}"
            f" for {on['async_stats']['updates']} updates")
    fed16 = threaded_fed(dev, 16, runtime="sim", telemetry=True,
                         **TELEMETRY_SIM)
    t0 = time.perf_counter()
    stats16 = fed16.run(rounds=MAIN_PATH["rounds"])
    wall16 = time.perf_counter() - t0
    hists16 = deterministic_hists(merged_hists(fed16.store.telemetry_dump()))
    print(f"[telemetry] sim: Table II, §IV.E, clusters and async_stats "
          f"bit-equal with telemetry on and off; {len(dump['sites'][0]['events'])}"
          f" events, dropped {dump['sites'][0]['dropped']}; deterministic "
          f"histograms (count, sum, max) "
          f"{json.dumps({k: v and [v['count'], v['sum'], v['max']] for k, v in hists.items()})}"
          f"; the sim at hidden 16 on the card: {wall16:.1f} s; card: "
          f"{card_line()}")
    require(hists16 == hists, "telemetry sim: the hidden-16 run's "
            "deterministic histograms differ from the full-width run's")
    require(stats16 == on["async_stats"], f"telemetry sim: hidden-16 stats "
            f"{stats16} differ from the full width's {on['async_stats']}")
    counts, routes = sum_counts((c_on, r_on), (c_off, r_off))
    return counts, routes, stats16, hists16


def check_telemetry_cpu(got, stats16, hists16):
    """The CPU child's stats and deterministic histograms equal the card's
    at hidden 16 (equal width, two devices)."""
    print(f"[telemetry] sim at hidden 16 on the CPU (a child process, two "
          f"threads): {got['wall_s']:.1f} s; stats and deterministic "
          f"histograms equal to the card's: "
          f"{got['stats'] == stats16 and got['hists'] == hists16}")
    require(got["stats"] == stats16, f"telemetry: CPU stats {got['stats']} "
            f"differ from the card's {stats16}")
    require(got["hists"] == hists16, "telemetry: the CPU run's "
            "deterministic histograms differ from the card's")


def telemetry_threaded(dev):
    """The threaded batched run at full width with telemetry on and off,
    counters set to 0 before each: exact accounting; the JSON report holds
    the store's histograms (the fold's on the CUDA route), the Prometheus
    page parses line by line, and the trace loads as JSON with at least
    one flow chain.  Returns (counts, routes)."""
    import tempfile

    rounds, hidden = MAIN_PATH["rounds"], MAIN_PATH["hidden"]
    # the fold's route: the kernel on the card (the plain version elsewhere)
    fold_hist = "drain_fold_ns_" + ("cuda" if dev.type == "cuda" else "host")
    runs, walls = [], {}
    for on in (True, False):
        fed = threaded_fed(dev, hidden, telemetry=on, **TELEMETRY_SIM)
        stats, counts, routes, wall = counted_fed(fed, rounds)
        walls[on] = wall
        require_exact_accounting(fed, stats, rounds, f"telemetry threaded "
                                                     f"({on})")
        require_sequence_route(counts, routes, f"telemetry threaded ({on})")
        runs.append((counts, routes))
        if on:
            rep = fed.metrics_report("json")
            missing = [h for h in (*REPORT_HISTS, fold_hist)
                       if h not in rep["histograms"]]
            require(not missing, f"telemetry threaded: the report lacks "
                                 f"{missing}")
            page = fed.metrics_report("prometheus").splitlines()
            for line in page:
                require(line.startswith("# TYPE fedccl_") or (
                    line.startswith("fedccl_") and len(line.split(" ")) == 2
                    and math.isfinite(float(line.split(" ")[1]))),
                    f"telemetry threaded: bad Prometheus line {line!r}")
            dump = fed.store.telemetry_dump()
            with tempfile.TemporaryDirectory() as tmp:
                path = Path(tmp) / "trace.json"
                fed.write_trace(path)
                trace = json.loads(path.read_text())
            flows = {e["id"] for e in trace["traceEvents"]
                     if e["ph"] in ("s", "t", "f")}
            n_events = sum(len(s["events"]) for s in dump["sites"])
            fold = rep["histograms"][fold_hist]
            print(f"[telemetry] threaded batched, telemetry on: "
                  f"{n_events} events, dropped {rep['dropped_events']}, "
                  f"{len(flows)} flow chains, {len(page)} Prometheus lines;"
                  f" {fold_hist} (host time of the call) count "
                  f"{fold['count']} p50 {fold['p50']} p95 {fold['p95']}; "
                  f"submit_latency_ns p95 "
                  f"{rep['histograms']['submit_latency_ns']['p95']}")
            require(flows, "telemetry threaded: the trace has no flow chain")
        fed.shutdown()
    print(f"[telemetry] threaded batched wall: telemetry on "
          f"{walls[True]:.4f} s, off {walls[False]:.4f} s; card: "
          f"{card_line()}")
    return sum_counts(*runs)


def parity_events(dev):
    """The reference's telemetry-parity schedule (``make_schedule`` of
    ``tests/test_store_equivalence.py``: 40 updates over the global model
    and 5 cluster keys, a fifth fresh) with its trees on ``dev``."""
    import numpy as np
    import torch
    from repro_torch.core.aggregation import ModelMeta, UpdateDelta
    from repro_torch.core.store import GLOBAL_KEY

    rng = np.random.default_rng(PARITY["seed"])

    def tree():
        return {"a": torch.from_numpy(rng.standard_normal((4, 3)).astype(
                    np.float32)).to(dev),
                "b": torch.from_numpy(rng.standard_normal(5).astype(
                    np.float32)).to(dev)}

    init = tree()
    keys = [f"loc:{i}" for i in range(PARITY["n_keys"])]
    models = [GLOBAL_KEY] + keys
    counts = {m: 0 for m in models}
    events = []
    for _ in range(PARITY["n_updates"]):
        m = models[int(rng.integers(len(models)))]
        s = int(rng.integers(1, 300))
        fresh = rng.random() < 0.2
        events.append((m, tree(), ModelMeta(s, 1, counts[m] + 1 if fresh
                                            else 1), UpdateDelta(s, 1, 1)))
        counts[m] += 1
    return init, keys, events


def replay_parity(store, events, seed):
    """The reference's ``replay_through_store``: drains at seeded random
    points, then one ``drain_all``."""
    import numpy as np
    from repro_torch.core.store import GLOBAL_KEY

    rng = np.random.default_rng(seed)
    for m, p, meta, delta in events:
        level, key = ("global", None) if m == GLOBAL_KEY else ("cluster", m)
        store.handle_model_update(level, key, p, meta, delta)
        if rng.random() < 0.3:
            if rng.random() < 0.5:
                store.drain(level, key)
            else:
                store.drain_all()
    store.drain_all()


def chain_ids(events) -> set:
    """The flow-chain ids of a site's events, as ``perfetto_trace`` joins
    them: the trace id and each wire seq + 1."""
    out = set()
    for _, _, _, trace, _, args in events:
        seqs = list((args or {}).get("seqs") or ())
        if (args or {}).get("seq") is not None:
            seqs.append(args["seq"])
        out |= {trace, *(int(s) + 1 for s in seqs)}
    return out - {0}


def telemetry_parity(dev, srv):
    """The parity schedule through the flat store, the sharded store at 4
    shards, ``ProcessShardedModelStore`` on 2 spawned CUDA workers and on
    the two ``--device cuda`` subprocess servers: the same
    ``staleness_at_fold`` histogram, one submit and one enqueue event per
    update; 3 sites for the process and TCP stores, and a trace id of the
    parent's site in a worker's site (its ``worker.fold`` consumes the
    sampled submit's wire seq).  Returns (counts, routes)."""
    import torch
    from repro_torch.core.aggregation import AggregationConfig
    from repro_torch.core.store import (
        ModelStore,
        ProcessShardedModelStore,
        ShardedModelStore,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs.export import perfetto_trace
    from repro_torch.obs.record import Telemetry

    init, keys, events = parity_events(dev)
    nofast = AggregationConfig(sequential_fast_path=False)
    kw = dict(agg_cfg=nofast,
              batch_aggregation=True, max_coalesce=PARITY["max_coalesce"])
    builds = {
        "flat": lambda tel: ModelStore(init, keys, telemetry=tel, **kw),
        "sharded": lambda tel: ShardedModelStore(init, keys, n_shards=4,
                                                 telemetry=tel, **kw),
        "process": lambda tel: ProcessShardedModelStore(
            init, keys, n_shards=2, device=dev, telemetry=tel, **kw),
        "tcp": lambda tel: ProcessShardedModelStore(
            init, keys, server_hosts=srv.hosts, device=dev,
            drain_timeout_s=60.0, telemetry=tel, **kw)}
    runs, ref = [], None
    for i, (name, build) in enumerate(builds.items()):
        store = build(Telemetry())
        with recording_folds(PARITY["max_coalesce"]) as folds:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            replay_parity(store, events, 10 + i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
        dump = store.telemetry_dump()       # obsdump needs live workers
        if hasattr(store, "close"):
            store.close()
        runs.append((counts, route_counts({})))
        stale = merged_hists(dump)["staleness_at_fold"]
        names = [ev[2] for site in dump["sites"] for ev in site["events"]]
        sites = [s["site"] for s in dump["sites"]]
        print(f"[telemetry] parity schedule, {name}: {wall:.4f} s; sites "
              f"{sites}; submits {names.count('submit')}, enqueues "
              f"{names.count('enqueue')}, worker folds "
              f"{names.count('worker.fold')}; staleness_at_fold count "
              f"{stale['count']} sum {stale['sum']} max {stale['max']}; "
              f"fold launches here {counts['fedavg_agg']}")
        n = PARITY["n_updates"]
        require(names.count("submit") == names.count("enqueue") == n,
                f"parity {name}: {names.count('submit')} submits, "
                f"{names.count('enqueue')} enqueues for {n} updates")
        require(stale["count"] == n, f"parity {name}: staleness observed "
                                     f"{stale['count']} times")
        if ref is None:
            ref = stale
        require(stale == ref, f"parity {name}: staleness histogram differs "
                              f"from the flat store's")
        if name in ("flat", "sharded"):
            implied = implied_launches(folds, nofast)
            require(counts["fedavg_agg"] == implied, f"parity {name}: "
                    f"{counts['fedavg_agg']} fold launches, implied "
                    f"{implied}")
            require(sites == ["parent"], f"parity {name}: sites {sites}")
            continue
        require(sites == ["parent", "shard-0", "shard-1"],
                f"parity {name}: sites {sites}")
        parent = chain_ids(ev for ev in dump["sites"][0]["events"]
                           if ev[2] == "submit")
        workers = set().union(*(chain_ids(s["events"])
                                for s in dump["sites"][1:]))
        flows = {(e["id"], e["pid"]) for e in perfetto_trace(
            dump)["traceEvents"] if e["ph"] in ("s", "t", "f")}
        crossing = {i for i, p in flows if p == 0} & \
            {i for i, p in flows if p > 0}
        print(f"[telemetry] parity {name}: {len(parent & workers)} sampled "
              f"submits' trace ids reach a worker's fold; {len(crossing)} "
              f"flow chains cross from the parent to a worker")
        require(parent & workers and crossing, f"parity {name}: no trace "
                "chain spans the parent and a worker")
    return sum_counts(*runs)


def telemetry_overhead(dev):
    """The flat store stress of phase 7 (8 writers x 150 cluster and global
    submits, the forecaster's tree) with telemetry off, on, on and off:
    exact accounting, submits/s of each.  Returns (counts, routes).  (Once
    in turns: the three rounds PR 20 ran left the cost unresolved, the
    spread of one setting wider than the difference; the smoke's time
    went to phase 14.)"""
    import torch
    from repro_torch.configs.solar_lstm import SolarLSTMConfig
    from repro_torch.core.store import ModelStore
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.lstm import SolarForecaster
    from repro_torch.obs.record import Telemetry

    n_w, per, n_c = (STRESS[x] for x in ("writers", "per_writer",
                                          "clusters"))
    fc = SolarForecaster(SolarLSTMConfig(hidden_size=MAIN_PATH["hidden"]))
    gen = torch.Generator(device=dev).manual_seed(100)
    pools = [[fc.init(gen, dev) for _ in range(STRESS["pool"])]
             for _ in range(n_w)]
    init = fc.init(gen, dev)
    keys = [f"c{i}" for i in range(n_c)]
    draws, want = stress_draws(n_w, per, n_c)
    kw = dict(batch_aggregation=True, max_coalesce=STRESS["max_coalesce"])
    rates, runs = {True: [], False: []}, []
    for on in (False, True, True, False):       # in turns
        torch.cuda.synchronize()
        reset_launch_counts()
        row = stress_store(
            f"flat_batched telemetry {'on' if on else 'off'}",
            ModelStore(init, keys, telemetry=Telemetry() if on else None,
                       **kw), pools, draws, want, tag="telemetry")
        rates[on].append(row["submits_per_s"])
        runs.append((launch_counts(), route_counts({})))
    med = {on: sorted(r)[len(r) // 2] for on, r in rates.items()}
    print(f"[telemetry] overhead: store stress submits/s in turns (off, on, "
          f"on, off): telemetry on {rates[True]}, off {rates[False]}; "
          f"upper medians on {med[True]:.1f}, off {med[False]:.1f}; card: "
          f"{card_line()}")
    return sum_counts(*runs)


def phase_telemetry(dev, srv) -> tuple[dict, dict, tuple]:
    """Telemetry on the port's paths: the main path's sim and the threaded
    run at full width (on and off), the parity schedule through every
    store tier, the store stress's overhead.  Returns the launches and
    routes of its runs summed (counters set to 0 before each) and the
    hidden-16 sim's (stats, histograms) for the CPU child's check."""
    c1, r1, stats16, hists16 = telemetry_sim(dev)
    counts, routes = sum_counts((c1, r1), telemetry_threaded(dev),
                                telemetry_parity(dev, srv),
                                telemetry_overhead(dev))
    for name in MAIN_KERNELS:
        require(counts[name] > 0, f"kernel {name} never launched on the "
                                  "telemetry path")
    return counts, routes, (stats16, hists16)


# ----------------------------------------------------------------- phase 10
# scenarios: the reference acceptance run (tests/test_scenarios.py:30-46)
# on every topology; the drift preset at the forecaster's width, its four
# runs on four threads (the client noise is ~1.4e9 numpy normals a run,
# drawn with the interpreter lock released); a DP flash crowd
DIURNAL = dict(n_clients=100_000, n_ticks=24, seed=3)
DIURNAL_SLO = dict(lost_updates=0, effective_round_regressions=0,
                   drain_timeouts=0, staleness_p95=4096)
DRIFT = dict(n_clients=5_000, n_ticks=32, period=32, seed=13)
DRIFT_LAMBDA = 25.0
DRIFT_AGREE_DIM = 1_024
FLASH_DP = dict(n_clients=1_000, n_ticks=6, n_clusters=4, seed=7,
                dp_noise_multiplier=1.2)
TIMING_SLOS = ("submit_p95_ns", "fetch_p95_ns", "drain_p95_ns")


def report_fields(rep) -> dict:
    """Everything of a ScenarioReport that is not a timing (params aside)."""
    return {"submitted": rep.submitted, "fetched": rep.fetched,
            "population_peak": rep.population_peak, "ticks": rep.ticks,
            "stats": rep.stats,
            "slo": {k: v for k, v in rep.slo.items() if k not in TIMING_SLOS},
            "hists": deterministic_hists(rep.metrics["histograms"]),
            "ewc": {k: rep.ewc[k] for k in ("kernel_calls", "season")}}


def final_gap(a, b) -> tuple[float, float]:
    """(max abs difference of two reports' final params and anchors, max
    |p| of the first)."""
    gap = top = 0.0
    for part in ("final_params", "anchors"):
        require(sorted(a.ewc[part]) == sorted(b.ewc[part]),
                f"scenario: {part} keys differ")
        for k, v in a.ewc[part].items():
            gap = max(gap, float(abs(v - b.ewc[part][k]).max()))
            top = max(top, float(abs(v).max()))
    return gap, top


def scenario_run(scen, dev, **kw):
    """``run_scenario`` with the counters set to 0 just before and read
    just after and the folds recorded; returns (report, counts, routes,
    wall, folds)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.scenario import run_scenario

    with recording_folds(kw.get("max_coalesce", 16)) as folds:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        rep = run_scenario(scen, device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    return rep, counts, route_counts({}), wall, folds


def print_scenario(rep, counts, wall, tag):
    launches = ("launches counted for the four runs together" if counts is
                None else f"fold launches {counts['fedavg_agg']}, "
                          f"ewc_update launches {counts['ewc_update']}")
    print(f"[scenario] {tag}: {wall:.2f} s ({wall:.4f} s; run_scenario's "
          f"own clock {rep.wall_s:.4f} s), {rep.submitted} submits "
          f"({rep.submitted / wall:.1f}/s), {rep.fetched} fetches, "
          f"population peak {rep.population_peak}; {launches}; slo "
          f"{json.dumps(rep.slo)}")


def scenario_diurnal(dev, srv):
    """``diurnal_churn(100_000, 24, seed=3)`` on single, sharded (4),
    process (2 spawned CUDA workers) and tcp (the two subprocess servers):
    the reference acceptance test's SLO bounds; submitted, fetched,
    population peak and staleness histogram equal across the four; fold
    launches = implied on the in-process topologies; the single run equal
    to the port's CPU run in every field but timings, params within 1e-5.
    Returns (counts, routes)."""
    from repro_torch.scenario import diurnal_churn, run_scenario

    make = lambda: diurnal_churn(DIURNAL["n_clients"], DIURNAL["n_ticks"],
                                 seed=DIURNAL["seed"])
    runs, reps = [], {}
    for topology, kw in (("single", {}), ("sharded", dict(n_shards=4)),
                         ("process", dict(n_shards=2)),
                         ("tcp", dict(hosts=srv.hosts))):
        rep, counts, routes, wall, folds = scenario_run(
            make(), dev, topology=topology, **kw)
        print_scenario(rep, counts, wall, f"diurnal_churn {topology}")
        rep.assert_slo(**DIURNAL_SLO)
        require(rep.population_peak == DIURNAL["n_clients"]
                and rep.slo["staleness_p95"] > 0,
                f"diurnal {topology}: peak {rep.population_peak}")
        if topology in ("single", "sharded"):
            implied = implied_launches(folds)
            require(counts["fedavg_agg"] == implied, f"diurnal {topology}: "
                    f"{counts['fedavg_agg']} fold launches, the drain "
                    f"batches imply {implied}")
        else:
            require(rep.stats["respawns"] == 0, f"diurnal {topology}: "
                                                "respawns")
        runs.append((counts, routes))
        reps[topology] = rep
    first = reps["single"]
    for topology, rep in reps.items():
        for f in ("submitted", "fetched", "population_peak"):
            require(getattr(rep, f) == getattr(first, f),
                    f"diurnal {topology}: {f} differs from single's")
        require(rep.metrics["histograms"]["staleness_at_fold"]
                == first.metrics["histograms"]["staleness_at_fold"],
                f"diurnal {topology}: staleness histogram differs")
    t0 = time.perf_counter()
    cpu = run_scenario(make(), topology="single", device="cpu")
    cpu_wall = time.perf_counter() - t0
    gap, top = final_gap(first, cpu)
    print(f"[scenario] diurnal_churn: submitted, fetched, population peak "
          f"and staleness histogram equal on the four topologies; single "
          f"on the card against the CPU ({cpu_wall:.2f} s): fields "
          f"{'equal' if report_fields(first) == report_fields(cpu) else 'DIFFER'}"
          f", final params max abs diff {gap:.3e}; card: {card_line()}")
    require(report_fields(first) == report_fields(cpu),
            "diurnal: the card's single run differs from the CPU's")
    require(gap <= 1e-5, f"diurnal: params differ from the CPU's by {gap}")
    return sum_counts(*runs)


def scenario_drift(dev):
    """``drift_ewc(5_000, 32, period=32, seed=13)`` at the forecaster's
    width (141,953), lambda 25 and 0, single and sharded, the four on four
    threads: ``ewc_update`` launches = the runs' kernel calls > 0, fold
    launches = implied, penalty > 0, the season boundary crossed, each
    EWC run nearer its season-A anchors than its lambda 0 run; then lambda
    25 at width 1,024 on the card against the CPU: every field but
    timings equal, params within 1e-5 x max(1, max|p|).  Returns (counts,
    routes)."""
    import threading
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.scenario import drift_ewc, run_scenario

    def make(lam, dim):
        return drift_ewc(DRIFT["n_clients"], DRIFT["n_ticks"],
                         period=DRIFT["period"], seed=DRIFT["seed"],
                         ewc_lambda=lam, param_dim=dim)

    jobs = [(topo, lam) for topo in ("single", "sharded")
            for lam in (DRIFT_LAMBDA, 0.0)]
    reps, walls, errors = {}, {}, []

    def job(topo, lam):
        try:
            t0 = time.perf_counter()
            reps[topo, lam] = run_scenario(make(lam, SOLAR_PARAMS),
                                           topology=topo, device=dev)
            walls[topo, lam] = time.perf_counter() - t0
        except BaseException as e:       # raised below, on this thread
            errors.append(e)

    with recording_folds(16) as folds:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=job, args=j) for j in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    if errors:
        raise errors[0]
    routes = route_counts({})
    calls = sum(r.ewc["kernel_calls"] for r in reps.values())
    implied = implied_launches(folds)
    for (topo, lam), rep in reps.items():
        print_scenario(rep, None, walls[topo, lam], f"drift_ewc {topo} "
                       f"lambda {lam} at {SOLAR_PARAMS} (one of four "
                       "threads)")
        print(f"[scenario] drift_ewc {topo} lambda {lam}: kernel calls "
              f"{rep.ewc['kernel_calls']}, penalty_last "
              f"{rep.ewc['penalty_last']}, season {rep.ewc['season']}")
        rep.assert_slo(lost_updates=0, effective_round_regressions=0,
                       drain_timeouts=0)
    print(f"[scenario] drift_ewc at {SOLAR_PARAMS}, four runs on four "
          f"threads: {wall:.2f} s; ewc_update launches "
          f"{counts['ewc_update']} = kernel calls {calls}; fold launches "
          f"{counts['fedavg_agg']}, implied {implied}; card: {card_line()}")
    require(calls > 0 and counts["ewc_update"] == calls,
            f"drift: {counts['ewc_update']} ewc_update launches for {calls} "
            "kernel calls")
    require(counts["fedavg_agg"] == implied, f"drift: "
            f"{counts['fedavg_agg']} fold launches, implied {implied}")
    for topo in ("single", "sharded"):
        ewc, base = reps[topo, DRIFT_LAMBDA], reps[topo, 0.0]
        require(ewc.ewc["penalty_last"] > 0.0 and ewc.ewc["season"] == 1
                and base.ewc["kernel_calls"] == 0,
                f"drift {topo}: penalty {ewc.ewc['penalty_last']}, season "
                f"{ewc.ewc['season']}")
        d_ewc = sum(float(np.linalg.norm(ewc.ewc["final_params"][k] - a))
                    for k, a in ewc.ewc["anchors"].items())
        d_base = sum(float(np.linalg.norm(base.ewc["final_params"][k] - a))
                     for k, a in ewc.ewc["anchors"].items())
        print(f"[scenario] drift {topo}: distance to the season-A anchors "
              f"with EWC {d_ewc:.4f}, without {d_base:.4f}")
        require(d_ewc < d_base, f"drift {topo}: the EWC run ends farther "
                                f"from its anchors ({d_ewc} >= {d_base})")
    runs = [(counts, routes)]
    for topo in ("single", "sharded"):
        rep, c, r, w, _ = scenario_run(make(DRIFT_LAMBDA, DRIFT_AGREE_DIM),
                                       dev, topology=topo)
        runs.append((c, r))
        cpu = run_scenario(make(DRIFT_LAMBDA, DRIFT_AGREE_DIM),
                           topology=topo, device="cpu")
        gap, top = final_gap(rep, cpu)
        same = report_fields(rep) == report_fields(cpu)
        print(f"[scenario] drift_ewc {topo} lambda {DRIFT_LAMBDA} at "
              f"{DRIFT_AGREE_DIM}, card ({w:.2f} s) against the CPU: fields "
              f"{'equal' if same else 'DIFFER'}, final params and anchors "
              f"max abs diff {gap:.3e} (limit {1e-5 * max(1.0, top):.3e}); "
              f"ewc_update launches {c['ewc_update']} = kernel calls "
              f"{rep.ewc['kernel_calls']}")
        require(same, f"drift {topo}: the card's run differs from the CPU's")
        require(c["ewc_update"] == rep.ewc["kernel_calls"],
                f"drift {topo} at {DRIFT_AGREE_DIM}: launches")
        require(gap <= 1e-5 * max(1.0, top), f"drift {topo}: params differ "
                                              f"from the CPU's by {gap}")
    return sum_counts(*runs)


def scenario_dp(dev):
    """The flash crowd with ``dp_noise_multiplier`` 1.2: epsilon equal to
    the CPU run's, exactly.  Returns (counts, routes)."""
    from repro_torch.scenario import flash_crowd_burst, run_scenario

    make = lambda: flash_crowd_burst(
        FLASH_DP["n_clients"], FLASH_DP["n_ticks"],
        n_clusters=FLASH_DP["n_clusters"], seed=FLASH_DP["seed"],
        dp_noise_multiplier=FLASH_DP["dp_noise_multiplier"])
    rep, counts, routes, wall, _ = scenario_run(make(), dev,
                                                topology="single")
    print_scenario(rep, counts, wall, "flash_crowd DP 1.2 single")
    cpu = run_scenario(make(), topology="single", device="cpu")
    print(f"[scenario] flash_crowd DP: epsilon {rep.slo['epsilon']!r} on "
          f"the card, {cpu.slo['epsilon']!r} on the CPU")
    require(rep.slo["epsilon"] is not None and rep.slo["epsilon"] > 0
            and rep.slo["epsilon"] == cpu.slo["epsilon"],
            "flash crowd DP: epsilon differs from the CPU's")
    rep.assert_slo(lost_updates=0, epsilon=50.0)
    return counts, routes


def phase_scenario(dev, srv) -> tuple[dict, dict]:
    """The scenario engine on the card: the acceptance run on every
    topology, the drift preset at the forecaster's width, a DP flash
    crowd.  Returns the launches and routes of its runs summed (counters
    set to 0 before each)."""
    counts, routes = sum_counts(scenario_diurnal(dev, srv),
                                scenario_drift(dev), scenario_dp(dev))
    for name in ("fedavg_agg", "ewc_update"):
        require(counts[name] > 0, f"kernel {name} never launched on the "
                                  "scenario path")
    return counts, routes


def phase_telemetry_scenario(dev, srv) -> tuple[dict, tuple]:
    """Phases 9 and 10 on the two ``--device cuda`` subprocess shard
    servers ``srv`` (phase 8's).  Returns ({path: (counts, routes)}, the
    hidden-16 sim's (stats, histograms) for ``check_telemetry_cpu``)."""
    tel_counts, tel_routes, want = phase_telemetry(dev, srv)
    out = {"telemetry": (tel_counts, tel_routes),
           "scenario": phase_scenario(dev, srv)}
    return out, want


# ----------------------------------------------------------------- phase 11
def llm_config(arch, dtype=None, depth=None, narrow=None):
    """``arch``'s config at full width, its depth cut to ``depth`` (or
    its row's cut in ``LLM``, or none), in ``dtype``, narrowed by ``narrow`` (fields,
    sub-configs as dicts)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    depth = depth or LLM[arch].depth
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    if depth is not None:
        cfg = cfg.replace(n_layers=depth)
    for key, val in (narrow or {}).items():
        if isinstance(val, dict):
            val = dataclasses.replace(getattr(cfg, key), **val)
        cfg = cfg.replace(**{key: val})
    return cfg


def llm_model(arch, dev, dtype=None, depth=None, generator=None, narrow=None):
    """(cfg, model, params) of ``arch`` (``llm_config``), weights random
    from the seed: drawn on the card (a CUDA generator) unless
    ``generator``."""
    import torch
    from repro_torch.models.model import build_model

    cfg = llm_config(arch, dtype, depth, narrow)
    model = build_model(cfg)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    return cfg, model, model.init(gen, dev)


def llm_batch(cfg, rng, b, seq, n_patch=None, structure=0.5):
    """A numpy batch of the family's kind, ``seq`` positions a row: tokens
    (``lm_batch`` with its copy pattern in ``structure`` of the rows),
    audio frames (``audio_batch``) or ``n_patch`` patches (the config's
    own count unless given) then text tokens (``vlm_batch``)."""
    from repro_torch.data.lm_synth import audio_batch, lm_batch, vlm_batch

    if cfg.family == "audio":
        return audio_batch(rng, b, seq, cfg.frontend.embed_dim,
                           cfg.vocab_size)
    if cfg.family == "vlm":
        return vlm_batch(rng, b, seq, n_patch or cfg.frontend.tokens_per_sample,
                         cfg.frontend.embed_dim, cfg.vocab_size)
    return lm_batch(rng, b, seq, cfg.vocab_size, structure)


def kernel_blocks(cfg) -> int:
    """Launches of the path's kernel in one forward (one backward likewise):
    one ``ssd_chunk`` a layer, one ``local_attn`` an attention-bearing
    block walked, the MTP block's included."""
    from repro_torch.models.blocks import attention_blocks

    if cfg.family == "ssm":
        return cfg.n_layers
    return attention_blocks(cfg) + cfg.mtp_depth


def ce_metrics(metrics) -> dict:
    """The cross entropies a family's loss reports (``ce``, ``mtp_ce``)."""
    return {k: metrics[k].item() for k in ("ce", "mtp_ce") if k in metrics}


def score(dev, arch) -> dict:
    """``build_eval_step`` at full width in the config's own dtype, counters
    set to 0 just before each run and read just after."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.local_attn import ops as attn_ops
    from repro_torch.training.train_step import build_eval_step

    t0 = time.perf_counter()
    cfg, model, params = llm_model(arch, dev)
    torch.cuda.synchronize()
    print(f"[llm] {arch} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}) initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    b, seq = LLM[arch].score
    batch = llm_batch(cfg, np.random.default_rng(0), b, seq)
    eval_step = build_eval_step(model, cfg)
    want = {name: 0 for name in launch_counts()}
    want[LLM[arch].kernel] = kernel_blocks(cfg)
    # every local_attn launch of bf16 scoring on the tensor-core route
    want_tc = want["local_attn"]
    first = None
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = eval_step(params, batch)
        loss = out["loss"].item()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        tc = attn_ops.launches_tc
        peak = torch.cuda.max_memory_allocated() / 2**30
        ces = ce_metrics(out)
        print(f"[llm] score {arch} batch {b} x {seq} ({run}): loss {loss:.6f} "
              f"{json.dumps(ces)} (ln V = {math.log(cfg.vocab_size):.6f}), "
              f"{wall * 1e3:.1f} ms wall, {b * seq / wall:.0f} tokens/s, "
              f"peak memory {peak:.2f} GiB, launches {json.dumps(counts)}, "
              f"local_attn on the tensor cores {tc}")
        require(counts == want, f"{arch} scoring launched {counts}, expected "
                                f"{want}")
        require(tc == want_tc, f"{arch} scoring: {tc} local_attn launches on "
                               f"the tensor-core route, expected {want_tc}")
        # each cross entropy within 2 of ln V; the loss adds MoE's aux loss
        # and 0.3 x the MTP term
        require(math.isfinite(loss) and all(
            abs(v - math.log(cfg.vocab_size)) < 2.0 for v in ces.values()),
            f"{arch} loss {loss}, {ces}: a cross entropy is not within 2 "
            "of ln V")
        first = first or dict(counts, local_attn_tc=tc)
    if LLM[arch].profile:
        device_profile(f"llm {arch}", lambda: eval_step(params, batch))
    return first


def serve(dev, arch):
    """Greedy ``ServeEngine.generate`` and ``generate_ragged`` at full width
    in the config's bf16 (its depth cut as in ``LLM``), no kernel
    launched (ragged equality is held in f32 at the decode depth, phase
    12)."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.engine import ServeEngine

    cfg, model, params = llm_model(arch, dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, SERVE_PROMPTS).astype(np.int32)
    reqs = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in RAGGED_LENS]
    eng = ServeEngine(model, params, max_len=96)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, SERVE_NEW)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ragged = eng.generate_ragged(reqs, SERVE_NEW)
    t_rag = time.perf_counter() - t0
    counts = launch_counts()
    require(out.shape == (SERVE_PROMPTS[0], SERVE_NEW) and ((out >= 0) & (
        out < cfg.vocab_size)).all(), f"{arch}: generate gave {out.shape}")
    require(ragged.shape == (len(RAGGED_LENS), SERVE_NEW) and (
        (ragged >= 0) & (ragged < cfg.vocab_size)).all(),
        f"{arch}: generate_ragged gave {ragged.shape}")
    require(all(n == 0 for n in counts.values()),
            f"{arch}: serving launched kernels {counts}; the reference's "
            "decode reaches neither")
    print(f"[llm] serve {arch} ({cfg.n_layers} layers, {cfg.dtype}): "
          f"generate {out.shape[0]}x{SERVE_PROMPTS[1]} prompts -> "
          f"{SERVE_NEW} new in {t_gen:.3f} s ({out.size / t_gen:.1f} new "
          f"tokens/s, prefill by replay included); ragged "
          f"{list(RAGGED_LENS)} -> {SERVE_NEW} new in {t_rag:.3f} s "
          f"({ragged.size / t_rag:.1f} new tokens/s); launches "
          f"{json.dumps(counts)}; sample {out[0, :8].tolist()}")


def phase_llm(dev) -> dict:
    import torch

    counts = {}
    for arch in LLM:
        for name, n in score(dev, arch).items():
            counts[name] = counts.get(name, 0) + n
        torch.cuda.empty_cache()
    print(f"[llm] card: {card_line()}")
    for arch in (a for a, row in LLM.items() if row.serve):
        serve(dev, arch)
        torch.cuda.empty_cache()
    return counts


def decode_by_replay(dev, arch):
    """Decode by replay (no kernel) against the kernel forward on the card,
    f32 at full width and the decode depth; then, where ``ragged``, ragged
    against independent decoding on the same weights."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.utils.tree import tree_leaves

    row = LLM[arch]
    depth, T = row.decode
    moe = llm_config(arch).moe
    narrow = ({"moe": {"capacity_factor": moe.n_routed_experts / moe.top_k}}
              if row.dropless else None)
    cfg, model, params = llm_model(arch, dev, dtype="float32", depth=depth,
                                   narrow=narrow)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, T)), device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        reset_launch_counts()
        full, _ = model.forward(params, tokens=toks)
        fwd = path_counts()
        require(fwd["local_attn_tf32"] == fwd["local_attn"] and (
            fwd["local_attn"] > 0) == (row.kernel == "local_attn"),
            f"{arch}: the f32 forward launched {fwd}, not every local_attn "
            "on the split-tf32 route")
        caches = model.init_caches(2, T, torch.float32, dev)
        reset_launch_counts()
        err = torch.zeros((), device=dev)
        for t in range(T):
            lg, caches = model.decode_step(params, caches,
                                           toks[:, t:t + 1], t)
            err = torch.maximum(err, (lg[:, 0] - full[:, t]).abs().max())
        err = err.item()
    counts = launch_counts()
    lim = LLM_DECODE_RTOL * max(1.0, full.abs().max().item())
    leaves = sorted({tuple(c.shape) for c in tree_leaves(caches)})
    dropless = (f", capacity_factor {cfg.moe.capacity_factor:g}"
                if narrow else "")
    print(f"[agree] {arch} f32, depth {depth}{dropless}, T {T}: decode by "
          f"replay vs the kernel forward, max abs err {err:.3e} (limit "
          f"{lim:.3e}), "
          f"{time.perf_counter() - t0:.1f} s; cache leaves {leaves}")
    require(err <= lim, f"{arch}: decode and forward differ by {err}")
    require(all(n == 0 for n in counts.values()),
            f"{arch}: decode launched kernels {counts}")
    if not row.ragged:
        return
    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in RAGGED_LENS]
    eng = ServeEngine(model, params, max_len=96)
    t0 = time.perf_counter()
    ragged = eng.generate_ragged(reqs, SERVE_NEW)
    differ = [i for i, r in enumerate(reqs)
              if not (ragged[i] == eng.generate(r[None], SERVE_NEW)[0]).all()]
    print(f"[agree] {arch} f32, depth {depth}: ragged {list(RAGGED_LENS)} -> "
          f"{SERVE_NEW} new, independent decoding "
          f"{'equal' if not differ else f'different in requests {differ}'}, "
          f"{time.perf_counter() - t0:.1f} s")
    require(not differ, f"{arch}: ragged requests {differ} differ from "
                        "independent decoding in f32")


class AgreeCases:
    """Phase 12's CUDA-against-CPU cases, made in a thread of its own
    started before phase 11, so that they overlap the phases on the card:
    for every ``LLM`` row, ``llm_agree_case`` drawn on the CPU (seconds
    a billion parameters) and the CPU child's loss and gradients read back
    (gigabytes); ``get(arch)`` waits for one.  ``drawn_s``, ``read_s``
    and ``waited_s`` are the seconds the thread drew, the seconds it read
    (waits for the child included) and the seconds ``get`` waited: done in
    the phase instead, the cases would cost it about drawn_s + read_s."""

    def __init__(self, child):
        import threading

        self._child = child
        self._cases, self._error = {}, None
        self.drawn_s = self.read_s = self.waited_s = 0.0
        self._ready = threading.Condition()
        self._thread = threading.Thread(target=self._make, daemon=True)
        self._thread.start()

    def _make(self):
        try:
            for arch in LLM:
                t0 = time.perf_counter()
                case = llm_agree_case(arch)
                t1 = time.perf_counter()
                case = (*case, self._child.tensors(f"grads_{arch}"))
                self.drawn_s += t1 - t0
                self.read_s += time.perf_counter() - t1
                with self._ready:
                    self._cases[arch] = case
                    self._ready.notify_all()
        except Exception as exc:        # handed to the waiting phase
            with self._ready:
                self._error = exc
                self._ready.notify_all()

    def get(self, arch):
        """(cfg, model, CPU params, batch, the child's result) of ``arch``."""
        t0 = time.perf_counter()
        with self._ready:
            self._ready.wait_for(lambda: arch in self._cases or self._error)
            self.waited_s += time.perf_counter() - t0
            if arch not in self._cases:
                raise self._error
            return self._cases.pop(arch)


def phase_llm_agree(dev, cases):
    """Decode by replay against the kernel forward, and ragged decoding
    (``decode_by_replay``); the CUDA loss and gradients against the CPU
    child's from the same weights (``cases``, an ``AgreeCases``; the plain
    versions in the child)."""
    import torch
    from repro_torch.utils.tree import tree_map

    for arch in (a for a, row in LLM.items() if row.decode):
        decode_by_replay(dev, arch)
        torch.cuda.empty_cache()
    for arch in LLM:
        cfg, model, cpu_params, batch, cpu = cases.get(arch)
        gpu_params = tree_map(lambda x: x.to(dev), cpu_params)
        del cpu_params
        check_llm_grads(dev, arch, model, cfg, gpu_params, batch, cpu)
        del gpu_params, cpu
        torch.cuda.empty_cache()
    print(f"[agree] the CUDA-against-CPU cases, made in a thread beside "
          f"phases 11-12: drawn in {cases.drawn_s:.1f} s, the child's "
          f"results read in {cases.read_s:.1f} s (its waits included); this "
          f"phase waited {cases.waited_s:.1f} s for them")


def llm_agree_case(arch):
    """The CUDA-against-CPU case of phase 12: f32 parameters at full width
    (or the row's ``narrow``) and the row's ``agree`` depth drawn on the CPU
    from seed 3, and the batch (2 x its ``agree`` S); the same in this
    process and the CPU child."""
    import numpy as np
    import torch

    row = LLM[arch]
    depth, seq = row.agree
    cfg, model, params = llm_model(
        arch, "cpu", dtype="float32", depth=depth,
        generator=torch.Generator().manual_seed(3), narrow=row.narrow)
    batch = llm_batch(cfg, np.random.default_rng(2), 2, seq,
                      n_patch=row.patches)
    return cfg, model, params, batch


def llm_loss_grads(model, cfg, params, batch):
    """(loss, the gradient of every leaf in JAX's order)."""
    import torch
    from repro_torch.training.losses import loss_for_batch
    from repro_torch.utils.tree import tree_leaves, tree_map

    live = tree_map(lambda x: x.detach().requires_grad_(), params)
    loss, _ = loss_for_batch(model, cfg, live, batch)
    return loss.item(), list(torch.autograd.grad(
        loss, tree_leaves(live), allow_unused=True, materialize_grads=True))


def check_llm_grads(dev, arch, model, cfg, params, batch, cpu):
    """The CUDA loss and gradients (the backward kernels, one launch a
    layer or attention block) against the CPU child's (the plain VJPs)
    from the same weights and batch: the loss within LLM_AGREE_LOSS, every
    leaf within LLM_GRAD_RTOL x max(1, max|g_cpu|)."""
    import torch
    from repro_torch.kernels import reset_launch_counts

    kernel = LLM[arch].kernel
    torch.cuda.synchronize()
    reset_launch_counts()
    loss, grads = llm_loss_grads(model, cfg, params, batch)
    torch.cuda.synchronize()
    bwd = path_counts()[f"{kernel}_bwd"]
    gap = abs(loss - cpu["loss"])
    row = LLM[arch]
    narrow = f", narrowed {json.dumps(row.narrow)}" if row.narrow else ""
    print(f"[agree] {arch} f32, depth {cfg.n_layers}{narrow}, batch 2 x "
          f"{row.agree[1]}: loss CUDA {loss:.7f} vs CPU "
          f"{cpu['loss']:.7f}, gap {gap:.3e} (limit {LLM_AGREE_LOSS})")
    require(gap <= LLM_AGREE_LOSS, f"{arch}: CUDA and CPU losses differ by "
                                   f"{gap}")
    require(bwd == kernel_blocks(cfg), f"{arch}: {bwd} {kernel} backward "
                                       f"launches, expected "
                                       f"{kernel_blocks(cfg)}")
    if kernel == "local_attn":      # f32: every launch on split tf32
        counts = path_counts()
        fwd = counts["local_attn"] - bwd
        require((counts["local_attn_tf32"], counts["local_attn_bwd_tf32"])
                == (fwd, bwd), f"{arch}: {counts['local_attn_tf32']} of "
                f"{fwd} local_attn forwards and "
                f"{counts['local_attn_bwd_tf32']} of {bwd} backwards on the "
                "split-tf32 route")
    require(len(grads) == len(cpu["grads"]), f"{arch}: {len(grads)} leaves "
            f"on the card, {len(cpu['grads'])} on the CPU")
    worst = 0.0
    for i, (g, w) in enumerate(zip(grads, cpu["grads"], strict=True)):
        w = w.to(g.device)             # f32 on either side: the same sums
        err = (g - w).abs().max().item()
        lim = LLM_GRAD_RTOL * max(1.0, w.abs().max().item())
        require(err <= lim, f"{arch}: leaf {i} of the gradient, CUDA vs CPU "
                            f"max abs err {err} > {lim}")
        worst = max(worst, err / lim)
    print(f"[agree] {arch} f32, depth {cfg.n_layers}: gradients CUDA vs CPU "
          f"(the child's plain VJPs), {len(grads)} leaves, worst max abs "
          f"err {worst:.3f} of its limit (LLM_GRAD_RTOL {LLM_GRAD_RTOL} x "
          f"max(1, max|g_cpu|)); {bwd} {kernel} backward launches; the CPU "
          f"child's case took {cpu['wall_s']:.1f} s")


# ----------------------------------------------------------------- phase 12
def table_gap(a, b, same_nan=True) -> float:
    """Largest Table II / §IV.E gap in pp over the entries that are NaN in
    neither run; with ``same_nan`` NaN must sit in the same places."""
    gap = 0.0
    for tab in ("table2", "independent"):
        require(a[tab].keys() == b[tab].keys(), f"{tab} columns differ")
        for col in a[tab]:
            for k, v in a[tab][col].items():
                w = b[tab][col][k]
                require(not same_nan or math.isnan(v) == math.isnan(w),
                        f"NaN in one run only: {tab} {col} {k}")
                if not (math.isnan(v) or math.isnan(w)):
                    gap = max(gap, abs(v - w))
    return gap


def dropout_feds(devices):
    """The solar ``train_fn`` under secure aggregation with dropouts and DP
    clipping, one ``FedCCL`` per device from the same initial weights."""
    import numpy as np
    import torch
    from repro_torch.configs.solar_lstm import SolarLSTMConfig
    from repro_torch.core.fedccl import ClusterSpaceConfig, FedCCL, FedCCLConfig
    from repro_torch.core.protocol import ClientSpec
    from repro_torch.data.solar import generate_fleet
    from repro_torch.data.windows import make_windows, split_windows
    from repro_torch.models.lstm import SolarForecaster
    from repro_torch.training.fed_solar import make_solar_fns, make_train_fn

    fleet = generate_fleet(n_sites=6, n_days=9, seed=0)
    fc = SolarForecaster(SolarLSTMConfig(hidden_size=16))
    init = fc.init(torch.Generator().manual_seed(2), "cpu")
    train_fn = make_train_fn(make_solar_fns(fc, lr=1e-2)[0], epochs=1)
    cfg = FedCCLConfig(
        spaces=(ClusterSpaceConfig("loc", eps=120.0, min_samples=2,
                                   metric="haversine"),),
        ewc_lambda=0.05, seed=3, secure_agg=True, dropout_prob=0.4,
        dp_clip=1.0, dp_noise_multiplier=0.0)
    rng = np.random.default_rng(0)
    specs = [ClientSpec(s.site_id, s.static_features,
                        split_windows(make_windows(d), train_frac=0.8)[0],
                        speed=float(rng.uniform(0.5, 2.0)))
             for s, d in fleet]
    feds = []
    for dev in devices:
        fed = FedCCL(cfg, init, train_fn, device=dev)
        fed.setup(specs)
        feds.append(fed)
    return feds


def check_dropout(dev):
    from repro_torch.utils.tree import tree_leaves

    gpu, cpu = dropout_feds([dev, "cpu"])
    stats, cstats = gpu.run(rounds=3), cpu.run(rounds=3)
    require(stats == cstats, f"dropout run: async_stats differ {stats} "
                             f"{cstats}")
    require(stats["secure_recoveries"] > 0, "no dropped client recovered")
    require(gpu.privacy_report() == cpu.privacy_report(),
            "dropout run: privacy reports differ")
    err = 0.0
    for level, key in [("global", None)] + [("cluster", k)
                                            for k in gpu.store.keys()]:
        for g, c in zip(tree_leaves(gpu.store.params(level, key)),
                        tree_leaves(cpu.store.params(level, key)),
                        strict=True):
            err = max(err, (g.cpu() - c).abs().max().item())
    print(f"[agree] secure run with dropout 0.4 (6 sites, hidden 16, 3 "
          f"rounds): {stats['secure_rounds']} secure rounds, "
          f"{stats['secure_recoveries']} clients recovered; global and "
          f"cluster parameters CUDA vs CPU max abs diff {err:.3e} (limit "
          f"{DROPOUT_ATOL})")
    require(err <= DROPOUT_ATOL, f"dropout run: parameters differ by {err}")


def check_dp_releases(dev, init):
    """DP alone at the privacy path's clip and noise: the CUDA run's every
    release against the plain version on the same inputs (no recurrence in
    between), and the schedule, clusters and budgets equal to the CPU
    run's.  Table II is printed, not bounded: the run is chaotic."""
    import torch
    import repro_torch.privacy.dp as dp
    from repro_torch.kernels.dp_clip_noise.ref import dp_clip_noise_ref
    from repro_torch.training.fed_solar import run_fedccl_solar

    cfg = dict(AGREE_RUN, dp_clip=PRIVACY["dp_clip"],
               dp_noise_multiplier=PRIVACY["dp_noise_multiplier"])
    releases = []
    launch = dp.privatize_flat

    def recorded(delta, noise, clip, m):
        out = launch(delta, noise, clip, m)
        releases.append((delta.cpu(), noise.cpu(), clip, m, out.cpu()))
        return out

    dp.privatize_flat = recorded
    try:
        gpu = run_fedccl_solar(device=dev, init_params=init, **cfg)
    finally:
        dp.privatize_flat = launch
    cpu = run_fedccl_solar(device="cpu", init_params=init, **cfg)
    for part in ("clusters", "async_stats", "privacy"):
        require(gpu[part] == cpu[part], f"DP alone at clip "
                                        f"{cfg['dp_clip']}: {part} differ")
    require(len(releases) == gpu["async_stats"]["updates"],
            f"{len(releases)} releases for "
            f"{gpu['async_stats']['updates']} updates")
    err, binding = 0.0, 0
    for delta, noise, clip, m, out in releases:
        want = dp_clip_noise_ref(delta, noise, clip, m)
        require(torch.equal(out.isnan(), want.isnan()),
                "a release is NaN where its plain version is not")
        ok = ~want.isnan()
        err = max(err, (out[ok] - want[ok]).abs().max().item()
                  if ok.any() else 0.0)
        binding += int(delta.norm().item() > clip)
    print(f"[agree] {cfg}: {len(releases)} CUDA releases ({binding} with "
          f"the clip binding) against the plain version on their inputs: "
          f"max abs err {err:.3e} (limit 1e-5); Table II / §IV.E gap to "
          f"the CPU run {table_gap(gpu, cpu, same_nan=False):.3e} pp "
          f"(chaotic, not bounded)")
    require(err <= 1e-5, f"DP releases off their plain version by {err}")


def phase_agree(dev):
    import torch
    from repro_torch.configs.solar_lstm import SolarLSTMConfig
    from repro_torch.models.lstm import SolarForecaster
    from repro_torch.training.fed_solar import run_fedccl_solar
    from repro_torch.utils.tree import params_to_numpy

    fc = SolarForecaster(SolarLSTMConfig(hidden_size=AGREE_RUN["hidden"]))
    init = params_to_numpy(fc.init(torch.Generator().manual_seed(1), "cpu"))
    sigma = PRIVACY["dp_noise_multiplier"]
    for extra in ({}, PRIVACY,
                  dict(dp_clip=AGREE_DP_CLIP, dp_noise_multiplier=sigma)):
        cfg = dict(AGREE_RUN, **extra)
        gpu = run_fedccl_solar(device=dev, init_params=init, **cfg)
        cpu = run_fedccl_solar(device="cpu", init_params=init, **cfg)
        for part in ("clusters", "async_stats", "privacy"):
            require(gpu[part] == cpu[part], f"{extra}: {part} differ")
        gap = table_gap(gpu, cpu)
        n_nan = sum(math.isnan(v) for tab in ("table2", "independent")
                    for row in gpu[tab].values() for v in row.values())
        print(f"[agree] {cfg}: CUDA kernels vs CPU plain versions, max "
              f"Table II / §IV.E gap {gap:.3e} pp (limit {AGREE_PP}); "
              f"{n_nan} NaN entries in both")
        require(gap <= AGREE_PP, f"CUDA and CPU runs differ by {gap} pp")
    check_dp_releases(dev, init)
    check_dropout(dev)
    check_threaded_secure(dev, init)


def without_worst_client(privacy) -> dict:
    """The privacy report without per_model's ``worst_client``: every
    client makes the same releases into a model, so the epsilons tie, and
    the accountant names the client whose release it recorded last, which
    the threads' order decides."""
    out = dict(privacy)
    out["per_model"] = {k: {f: v for f, v in row.items()
                            if f != "worst_client"}
                        for k, row in privacy.get("per_model", {}).items()}
    return out


def check_threaded_secure(dev, init):
    """The threaded runtime's secure run with DP clipping (noise 0) at
    AGREE_RUN's size, on CUDA and on the CPU from one init.  A secure round
    folds a fixed member set, so the runs differ only in summation order."""
    from repro_torch.training.fed_solar import run_fedccl_solar

    cfg = dict(AGREE_RUN, dp_clip=PRIVACY["dp_clip"], dp_noise_multiplier=0.0,
               secure_agg=True)
    gpu = run_fedccl_solar(device=dev, init_params=init, runtime="threaded",
                           **cfg)
    cpu = run_fedccl_solar(device="cpu", init_params=init,
                           runtime="threaded", **cfg)
    for part in ("clusters", "async_stats"):
        require(gpu[part] == cpu[part], f"threaded secure: {part} differ")
    require(without_worst_client(gpu["privacy"])
            == without_worst_client(cpu["privacy"]),
            "threaded secure: privacy reports differ")
    require(gpu["async_stats"]["secure_rounds"] > 0,
            "threaded secure: no secure round folded")
    gap = table_gap(gpu, cpu)
    print(f"[agree] threaded {cfg}: CUDA vs CPU, max Table II / §IV.E gap "
          f"{gap:.3e} pp (limit {AGREE_PP}); agg_stats "
          f"{json.dumps(gpu['async_stats'])} equal")
    require(gap <= AGREE_PP, f"threaded secure: CUDA and CPU runs differ by "
                             f"{gap} pp")


# ----------------------------------------------------------------- phase 13
def phase_example():
    """``examples/solar_forecasting_torch.py`` as a user runs it, on the
    card: it must exit 0, print Table II and write a report whose Table II
    is finite and inside the system test's bounds."""
    import tempfile

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src"), *filter(None, [env.get("PYTHONPATH")])])
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(REPO / "examples" /
                                 "solar_forecasting_torch.py"),
             "--out", out], capture_output=True, text=True, env=env,
            timeout=600)
        wall = time.perf_counter() - t0
        require(proc.returncode == 0, "examples/solar_forecasting_torch.py "
                f"exited {proc.returncode}: {proc.stderr[-2000:]}")
        require("=== Table II analog ===" in proc.stdout,
                "the example printed no Table II")
        report = json.loads((Path(out) / "solar_report.json").read_text())
    for line in proc.stdout.splitlines():
        if "power" in line:
            print(f"[example] {line}")
    check_table({"table2": report["table2"], "independent": {}}, "example")
    print(f"[example] examples/solar_forecasting_torch.py --out <tmp> on the "
          f"card: exit 0 in {wall:.1f} s (process start included), "
          f"config {json.dumps(report['config'])}, Table II inside the "
          "bounds")


# ----------------------------------------------------------------- phase 14
def path_counts() -> dict:
    """Every wrapper's ``launches``, the backward kernels' own
    (``launches_bwd``, as ``<kernel>_bwd``), local_attn's routes
    (``local_attn_tc``, ``local_attn_tf32``, ``local_attn_bwd_tc``,
    ``local_attn_bwd_tf32``) and the stacked fold's
    (``fedavg_agg_stacked``)."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.fedavg_agg import ops as agg_ops
    from repro_torch.kernels.local_attn import ops as attn_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops

    return {**launch_counts(), "ssd_chunk_bwd": ssd_ops.launches_bwd,
            "local_attn_bwd": attn_ops.launches_bwd,
            "local_attn_bwd_tc": attn_ops.launches_bwd_tc,
            "local_attn_bwd_tf32": attn_ops.launches_bwd_tf32,
            "local_attn_tc": attn_ops.launches_tc,
            "local_attn_tf32": attn_ops.launches_tf32,
            "fedavg_agg_stacked": agg_ops.launches_stacked}


def add_counts(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + more.get(k, 0) for k in {*total, *more}}


def train_unit(arch) -> tuple[int, int]:
    """(the depth's step, its smallest value) of ``arch``'s training cuts:
    recurrentgemma's whole (rec, rec, attn) groups, deepseek-moe's dense
    first layer and at least one MoE layer, one layer otherwise."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if cfg.family == "hybrid":
        unit = len(cfg.rglru.block_pattern)
        return unit, unit
    if cfg.is_moe:
        return 1, cfg.moe.first_k_dense + 1
    return 1, 1


def step_launches(cfg) -> dict:
    """Every counter of ``path_counts`` a training step of ``cfg`` moves:
    one forward and one backward of the path's kernel a block walked,
    gemma-2b's and the remat families' all on the tensor-core routes; under
    a remat, a second forward of each attention block in a "scan"
    segment (its recompute in the backward)."""
    from repro_torch.models.blocks import ATTN_KINDS, stack_layout

    want = {name: 0 for name in path_counts()}
    blocks = kernel_blocks(cfg)
    if cfg.family == "ssm":
        again = 0 if cfg.remat == "none" else cfg.n_layers
        want.update(ssd_chunk=2 * blocks + again, ssd_chunk_bwd=blocks)
        return want
    again = 0 if cfg.remat == "none" else sum(
        repeat * sum(k in ATTN_KINDS for k in kinds)
        for mode, kinds, repeat in stack_layout(cfg) if mode == "scan")
    want.update(local_attn=2 * blocks + again, local_attn_bwd=blocks,
                local_attn_tc=blocks + again, local_attn_bwd_tc=blocks)
    return want


def train_steps(dev, arch, depth=None, remat="none", lr=TRAIN_LR,
                keep_init=False):
    """TRAIN_STEPS AdamW steps of ``arch`` at rate ``lr``, full width in the
    config's bf16, cut to ``depth`` layers, under ``remat``, on one
    ``llm_batch`` (text rows all with the copy pattern), counters set to 0
    just before each step and read just after: ``step_launches`` and no
    other kernel; the loss must fall and the peak leave TRAIN_SPARE_GIB of
    the card free.
    Returns (counts summed over the steps, the initial parameters if
    ``keep_init``, the state after the steps, the batch)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.training.train_step import TrainState, build_train_step

    cfg, _, params = llm_model(arch, dev, depth=depth)
    cfg = cfg.replace(remat=remat)
    b, seq = LLM_TRAIN[arch]
    batch = llm_batch(cfg, np.random.default_rng(4), b, seq, structure=1.0)
    opt = adamw(lr, moment_dtype=getattr(torch, TRAIN_MOMENTS[arch]))
    step = build_train_step(build_model(cfg), cfg, opt)
    state = TrainState(params, opt.init(params))
    init = params if keep_init else None
    del params
    want = step_launches(cfg)
    full = get_config(arch).n_layers
    room = (torch.cuda.get_device_properties(dev).total_memory / 2**30
            - TRAIN_SPARE_GIB)
    total, losses = {}, []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = metrics["loss"].item()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = path_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[train] {arch} ({cfg.n_layers} of {full} layers, "
              f"{cfg.dtype}, remat "
              f"{remat}, AdamW lr {lr}, {TRAIN_MOMENTS[arch]} moments)"
              f" step {i + 1}, batch {b} x {seq}: loss {loss:.6f}, ce "
              f"{metrics['ce'].item():.6f}, grad_norm "
              f"{metrics['grad_norm'].item():.4f}, {wall * 1e3:.1f} ms wall, "
              f"{b * seq / wall:.0f} tokens/s, peak memory {peak:.2f} GiB, "
              f"launches {json.dumps(counts)}")
        require(math.isfinite(loss), f"{arch}: step {i + 1} loss {loss}")
        require(counts == want, f"{arch} step {i + 1} launched {counts}, "
                                f"expected {want}")
        require(peak <= room, f"{arch}: peak {peak:.2f} GiB leaves less "
                              f"than {TRAIN_SPARE_GIB} GiB of the card")
        total = add_counts(total, counts)
        losses.append(loss)
    require(losses[-1] < losses[0], f"{arch}: the loss did not fall over "
                                    f"{TRAIN_STEPS} steps: {losses}")
    device_profile(f"train {arch}", lambda: step(state, batch))
    return total, init, state, batch


class expandable_segments:
    """The caching allocator's expandable segments, on inside the block:
    training steps at full width allocate and free tensors of GiBs
    (recurrentgemma's f32 logits over a 256,000 vocabulary are 8 GiB each),
    and fixed segments fragmented under them: recurrentgemma ran out of
    memory in the backward of a step that had fit twice, 23.6 GiB
    allocated, and gemma-2b's profiled step after the smoke's earlier
    phases with 35.25 GiB reserved but unallocated (PERF.md §6)."""

    def __enter__(self):
        import torch

        torch.cuda.empty_cache()
        self.set = getattr(torch._C, "_accelerator_setAllocatorSettings",
                           torch.cuda.memory._set_allocator_settings)
        self.set("expandable_segments:True")
        return self

    def __exit__(self, *exc):
        import torch

        self.set("expandable_segments:False")
        torch.cuda.empty_cache()


class step_parts:
    """Which part of ``build_train_step``'s step runs (``part``: the loss's
    forward, its gradient, or the update from the clip on) and the peak
    memory when the update starts (``grad_peak``, bytes: the forward's and
    the backward's, activations included), by wrapping the train-step
    module's ``loss_for_batch`` and ``clip_by_global_norm``."""

    def __init__(self):
        import torch
        import repro_torch.training.train_step as ts

        self.mod, self.part, self.grad_peak = ts, None, None
        self.orig = (ts.loss_for_batch, ts.clip_by_global_norm)

        def forward(*a, **kw):
            self.part = "forward"
            out = self.orig[0](*a, **kw)
            self.part = "backward"
            return out

        def update(*a, **kw):
            self.part = "update"
            self.grad_peak = torch.cuda.max_memory_allocated()
            return self.orig[1](*a, **kw)

        ts.loss_for_batch, ts.clip_by_global_norm = forward, update

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.mod.loss_for_batch, self.mod.clip_by_global_norm = self.orig


def remat_witness(dev, arch, depth, lr) -> dict:
    """One AdamW step of ``arch`` (rate ``lr``, full width, bf16, ``depth``
    layers) under "none" and one under "full" from the same state and
    batch, counters set to 0 just before each and read just
    after: the loss bit-equal, grad_norm within REMAT_GNORM_RTOL, every
    parameter within one bf16 rounding step, and the memory the forward
    and backward add to what the step starts with (the second step starts
    with the first one's parameters kept) under "full" strictly below the
    one under "none" (the whole step's beside them: AdamW's update may set
    both).  Returns the launches of both steps."""
    import numpy as np
    import torch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.training.train_step import TrainState, build_train_step
    from repro_torch.utils.tree import tree_leaves

    cfg, _, params = llm_model(arch, dev, depth=depth)
    b, seq = LLM_TRAIN[arch]
    batch = llm_batch(cfg, np.random.default_rng(4), b, seq, structure=1.0)
    opt = adamw(lr, moment_dtype=getattr(torch, TRAIN_MOMENTS[arch]))
    state = TrainState(params, opt.init(params))
    del params
    got, total = {}, {}
    for remat in ("none", "full"):
        c = cfg.replace(remat=remat)
        step = build_train_step(build_model(c), c, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launch_counts()
        with step_parts() as parts:
            new, metrics = step(state, batch)
        torch.cuda.synchronize()
        counts = path_counts()
        got[remat] = (new.params, metrics["loss"].item(),
                      metrics["grad_norm"].item(),
                      (parts.grad_peak - base) / 2**30,
                      (torch.cuda.max_memory_allocated() - base) / 2**30)
        del new
        require(counts == step_launches(c), f"{arch} witness under {remat} "
                f"launched {counts}, expected {step_launches(c)}")
        total = add_counts(total, counts)
    (p_none, l_none, g_none, a_none, m_none), \
        (p_full, l_full, g_full, a_full, m_full) = got["none"], got["full"]
    worst, differ = 0.0, 0
    for a, r in zip(tree_leaves(p_full), tree_leaves(p_none), strict=True):
        differ += not torch.equal(a, r)
        a, r = a.to(torch.float32), r.to(torch.float32)
        lim = torch.maximum(a.abs(), r.abs()) * 2.0 ** -8
        worst = max(worst, ((a - r).abs() / lim.clamp_min(1e-30)).max().item())
    gap = abs(g_full - g_none) / max(abs(g_none), 1e-30)
    print(f"[train] {arch} remat witness ({cfg.n_layers} layers, batch {b} x"
          f" {seq}): loss {l_full!r} (full) vs {l_none!r} (none); grad_norm "
          f"{g_full!r} vs {g_none!r} (relative gap {gap:.3e}, limit "
          f"{REMAT_GNORM_RTOL}); parameters: {differ} of "
          f"{len(tree_leaves(p_none))} leaves not bit-equal, worst |diff| / "
          f"(2^-8 x value) {worst:.3f}; memory added to the step's start "
          f"at the peak of the forward and backward {a_full:.4f} GiB (full)"
          f" vs {a_none:.4f} GiB (none), of the step {m_full:.4f} vs "
          f"{m_none:.4f} GiB")
    require(l_full == l_none, f"{arch}: remat changed the loss")
    require(gap <= REMAT_GNORM_RTOL, f"{arch}: remat moved grad_norm by "
                                     f"{gap:.3e}")
    require(worst <= 1.0, f"{arch}: remat moved a parameter by {worst:.3f} "
                          "x 2^-8 of its value")
    require(a_full < a_none, f"{arch}: the forward and backward added "
                             f"{a_full:.4f} GiB under remat, {a_none:.4f} "
                             "without")
    return total


def anchored_step(dev, init, state, batch):
    """One AdamW step of mamba2-370m at full width with ``ewc=`` (anchored
    at the initial parameters, lambda EWC_LAMBDA): exactly one
    ``ewc_update`` launch beside the SSD's, and the penalty the kernel
    returns equal to the plain ``ewc_penalty`` of the same parameters."""
    import torch
    import repro_torch.training.train_step as train_step_mod
    from repro_torch.configs import get_config
    from repro_torch.core.continual import EWCState, ewc_penalty
    from repro_torch.models.model import build_model
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.optim import adamw

    arch = "mamba2-370m"
    cfg = get_config(arch)
    model = build_model(cfg)
    ewc = EWCState(init, None, EWC_LAMBDA)
    opt = adamw(TRAIN_LR)
    step = train_step_mod.build_train_step(model, cfg, opt, ewc=ewc)
    want = {name: 0 for name in path_counts()}
    want.update(ssd_chunk=2 * cfg.n_layers, ssd_chunk_bwd=cfg.n_layers,
                ewc_update=1)
    penalties = []
    orig = train_step_mod.ewc_adjusted_gradient

    def spy(*args):
        out = orig(*args)
        penalties.append(out[1])
        return out

    train_step_mod.ewc_adjusted_gradient = spy
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        new_state, metrics = step(state, batch)
        loss = metrics["loss"].item()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = path_counts()
    finally:
        train_step_mod.ewc_adjusted_gradient = orig
    got = penalties[0].item()
    plain = ewc_penalty(state.params, ewc).item()
    gap = abs(got - plain) / max(abs(plain), 1e-30)
    print(f"[train] {arch} anchored step (lambda {EWC_LAMBDA}): loss "
          f"{loss:.6f} = ce {metrics['ce'].item():.6f} + penalty {got:.6f} "
          f"(plain ewc_penalty {plain:.6f}, relative gap {gap:.3e}, limit "
          f"{EWC_PENALTY_RTOL}), {wall * 1e3:.1f} ms wall, launches "
          f"{json.dumps(counts)}")
    require(counts == want, f"the anchored step launched {counts}, "
                            f"expected {want}")
    require(plain > 0 and gap <= EWC_PENALTY_RTOL, f"the kernel's penalty "
            f"{got} against the plain {plain}")
    del new_state
    return counts


def federated_llm(dev) -> dict:
    """``examples/federated_llm_torch.py``'s ``federate`` with mamba2-370m
    at full width and FED_LLM_DEPTH (4 organisations, 2 rounds), counters
    set to 0 just before and read just after, its folds recorded: the eval
    loss falls, the update count is FED_LLM_UPDATES, the fold launches are
    the ones the recorded folds imply, and the global model left its
    init."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.utils.tree import tree_leaves

    example = load_example("federated_llm_torch")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with recording_folds() as folds:
        out = example.federate(
            "mamba2-370m", device=dev,
            cfg=get_config("mamba2-370m").replace(n_layers=FED_LLM_DEPTH))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts()
    stats = out["stats"]
    implied = implied_launches(folds)
    moved = any(bool(torch.any(a != b)) for a, b in zip(
        tree_leaves(out["fed"].store.params("global")),
        tree_leaves(out["init_params"]), strict=True))
    print(f"[train] federated mamba2-370m at full width, {FED_LLM_DEPTH} of "
          f"48 layers, 4 organisations, 2 rounds: {wall:.1f} s, eval loss {out['loss0']:.6f} -> "
          f"{out['loss1']:.6f}, stats {json.dumps(stats)}, {len(folds)} "
          f"folds recorded, fold launches {counts['fedavg_agg']} (implied "
          f"{implied}), global model moved {moved}, launches "
          f"{json.dumps(counts)}")
    require(out["loss1"] < out["loss0"], "the federated eval loss did not "
                                         "fall")
    require(stats["updates"] == FED_LLM_UPDATES, f"{stats['updates']} "
            f"updates, expected {FED_LLM_UPDATES}")
    require(counts["fedavg_agg"] == implied and implied > 0,
            f"{counts['fedavg_agg']} fold launches, the folds imply "
            f"{implied}")
    require(counts["ssd_chunk_bwd"] > 0, "no SSD backward launch")
    require(moved, "the global model equals its init")
    return counts


def phase_train(dev) -> tuple[dict, dict]:
    """Phase 14: training at full width (see the module docstring).
    Returns the launches of the "train" path (the counted steps and the
    anchored step) and of the "fed_llm" path (the federated round)."""
    import torch

    t0 = time.perf_counter()
    with expandable_segments():
        counts, init, state, batch = train_steps(dev, "mamba2-370m",
                                                 keep_init=True)
        counts = add_counts(counts, anchored_step(dev, init, state, batch))
        del init, state, batch
        torch.cuda.empty_cache()
        more = train_steps(dev, "gemma-2b")[0]
        counts = add_counts(counts, more)
        torch.cuda.empty_cache()
        fed = federated_llm(dev)
        torch.cuda.empty_cache()
    print(f"[train] phase wall {time.perf_counter() - t0:.1f} s; card: "
          f"{card_line()}")
    return counts, fed


def phase_train_families(dev) -> tuple[dict, dict]:
    """Phase 14b: the configs of REMAT_TRAIN at full width under remat
    "full", each at its depth cut, and each remat witness.
    Returns the launches of the "train_remat" path (the counted steps) and
    of the "remat_witness" path."""
    import gc

    import torch

    t0 = time.perf_counter()
    counts, witness = {}, {}
    with expandable_segments():
        for arch, (depth, witness_depth, lr) in REMAT_TRAIN.items():
            if witness_depth is not None:
                witness = add_counts(witness, remat_witness(
                    dev, arch, witness_depth, lr))
                gc.collect()
                torch.cuda.empty_cache()
            more = train_steps(dev, arch, depth=depth, remat="full",
                               lr=lr)[0]
            counts = add_counts(counts, more)
            gc.collect()
            torch.cuda.empty_cache()
    print(f"[train] families phase wall {time.perf_counter() - t0:.1f} s; "
          f"card: {card_line()}")
    return counts, witness


# ----------------------------------------------------------------- phase 15
CP_ARCH, CP_CLUSTERS, CP_COUNTS = "mamba2-370m", 2, (1, 3)
LAUNCH_TRAIN = ["--arch", "gemma-2b", "--steps", "3", "--batch", "2",
                "--seq", "64"]


def placed_scoring(dev) -> dict:
    """gemma-2b at full width in bf16 scored (2 x 2048) with its parameters
    distributed by ``shardings_from_schema`` and its tokens by their specs
    on ``make_host_mesh()``'s (1, 1) mesh over an nccl world of one, under
    ``rules=make_rules(mesh)``: the logits equal the plain-tensor forward's
    bit for bit, with one tensor-core local_attn launch a layer.  Returns
    the mesh run's launches."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch.mesh import host_world
    from repro_torch.sharding.logical import (
        distribute,
        logical_to_spec,
        make_rules,
        mesh_sizes,
        on_mesh,
        placements,
        shardings_from_schema,
    )

    arch = "gemma-2b"
    cfg, model, params = llm_model(arch, dev)
    b, seq = LLM[arch].score
    toks = torch.as_tensor(llm_batch(cfg, np.random.default_rng(0), b,
                                     seq)["tokens"], device=dev)
    with torch.no_grad():
        plain, _ = model.forward(params, tokens=toks)
    want = {name: 0 for name in path_counts()}
    want["local_attn"] = want["local_attn_tc"] = cfg.n_layers
    with host_world(dev) as mesh:
        rules = make_rules(mesh)
        placed = distribute(params, mesh,
                            shardings_from_schema(model.schema(), mesh, rules))
        dtoks = distribute_tensor(toks, mesh, placements(logical_to_spec(
            ("batch", "seq"), rules, tuple(toks.shape)), mesh),
            src_data_rank=None)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad(), on_mesh():
            out, _ = model.forward(placed, tokens=dtoks, rules=rules)
        local = out.to_local()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = path_counts()
        print(f"[distribution] {arch} scored on the mesh "
              f"{mesh_sizes(mesh)} ({dist.get_backend()}), logits {type(out).__name__} "
              f"{tuple(out.placements)}: {wall * 1e3:.1f} ms wall, launches "
              f"{json.dumps(counts)}, bit-equal to the plain forward: "
              f"{torch.equal(local, plain)}")
    require(counts == want, f"placed scoring launched {counts}, expected "
                            f"{want}")
    require(torch.equal(local, plain), "placed scoring: the logits differ "
            "from the plain forward's")
    return counts


def cluster_parallel_round(dev) -> dict:
    """``ClusterParallel`` with CP_CLUSTERS mamba2-370m cluster models at
    full width and depth in bf16 (AdamW, f32 moments, as phase 14), one
    ``lm_batch(structure=1.0)`` of 2 x 2048 each, one step: one forward and
    one backward ssd_chunk launch a layer a cluster; each cluster's loss
    and parameters equal to an independent ``build_train_step`` step on
    the same state and batch bit for bit; ``global_params`` at CP_COUNTS
    within one bf16 rounding step (relative 2^-8) of each value of
    ``multi_aggregate`` over the
    clusters (the fedavg_agg kernel); equal clusters after
    ``broadcast_global``.  Returns the round's launches (the step's and
    the global tier's)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.aggregation import multi_aggregate
    from repro_torch.core.cluster_parallel import ClusterParallel
    from repro_torch.data.lm_synth import lm_batch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.training.train_step import TrainState, build_train_step
    from repro_torch.utils.tree import tree_leaves, tree_map

    K = CP_CLUSTERS
    cfg = get_config(CP_ARCH)
    model = build_model(cfg)
    opt = adamw(TRAIN_LR, moment_dtype=getattr(torch, TRAIN_MOMENTS[CP_ARCH]))
    cp = ClusterParallel(model, cfg, opt, K)
    state = cp.init(torch.Generator(device=dev).manual_seed(0), dev)
    b, seq = LLM_TRAIN[CP_ARCH]
    batches = [lm_batch(np.random.default_rng(10 + k), b, seq,
                        cfg.vocab_size, structure=1.0) for k in range(K)]
    stacked = {key: torch.as_tensor(np.stack([bt[key] for bt in batches]),
                                    device=dev) for key in batches[0]}
    want = {name: 0 for name in path_counts()}
    want["ssd_chunk"] = 2 * K * cfg.n_layers
    want["ssd_chunk_bwd"] = K * cfg.n_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    new_state, metrics = cp.step(state, stacked)
    losses = metrics["loss"].tolist()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[distribution] ClusterParallel {CP_ARCH} x {K} ({cfg.n_layers} "
          f"layers, {cfg.dtype}, AdamW {TRAIN_MOMENTS[CP_ARCH]} moments), "
          f"batch {b} x {seq} a cluster: losses {losses}, {wall * 1e3:.1f} ms "
          f"wall, peak memory {peak:.2f} GiB, launches {json.dumps(counts)}; "
          f"card: {card_line()}")
    require(counts == want, f"ClusterParallel launched {counts}, expected "
                            f"{want}")
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")

    inner = build_train_step(model, cfg, opt)
    take = lambda tree, k: tree_map(lambda x: x[k], tree)
    for k in range(K):
        ref, ref_m = inner(TrainState(take(state.params, k),
                                      take(state.opt_state, k)),
                           {key: v[k] for key, v in stacked.items()})
        same = all(torch.equal(a, r) for a, r in zip(
            tree_leaves(take(new_state.params, k)), tree_leaves(ref.params),
            strict=True))
        print(f"[distribution] cluster {k}: loss {losses[k]!r} vs an "
              f"independent step's {ref_m['loss'].item()!r}; parameters "
              f"bit-equal {same}")
        require(losses[k] == ref_m["loss"].item() and same,
                f"cluster {k} differs from an independent step")
        del ref, ref_m
    torch.cuda.empty_cache()

    reset_launch_counts()
    g = cp.global_params(new_state, list(CP_COUNTS))
    fold = multi_aggregate([take(new_state.params, k) for k in range(K)],
                           list(CP_COUNTS))
    torch.cuda.synchronize()
    counts = add_counts(counts, path_counts())
    worst = 0.0
    for a, r in zip(tree_leaves(g), tree_leaves(fold), strict=True):
        a, r = a.to(torch.float32), r.to(torch.float32)
        # one bf16 rounding step: relative 2^-8 of the larger value
        lim = torch.maximum(a.abs(), r.abs()) * 2.0 ** -8
        worst = max(worst, ((a - r).abs() / lim.clamp_min(1e-30)).max().item())
    print(f"[distribution] global_params at counts {CP_COUNTS} vs "
          f"multi_aggregate (fedavg_agg launches "
          f"{counts['fedavg_agg']}): worst |diff| / (2^-8 x value) "
          f"{worst:.3f}")
    require(worst <= 1.0, f"global_params differs from multi_aggregate by "
                          f"{worst:.3f} x 2^-8 of the value")
    require(counts["fedavg_agg"] >= 1, "multi_aggregate launched no fold")
    synced = cp.broadcast_global(new_state, g)
    require(all(torch.equal(x[0], x[k]) for x in tree_leaves(synced.params)
                for k in range(1, K)), "clusters differ after "
            "broadcast_global")
    return counts


def launchers(dev) -> dict:
    """``launch.train.main`` (reduced gemma-2b, f32: the f32 local_attn
    forward and the split-tf32 backward) and ``launch.serve.main`` at its
    defaults, in process on the card: finite losses, one f32 forward and
    one split-tf32 backward local_attn launch a layer a step, tokens
    within the vocabulary.  Returns the two runs' launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import serve, train

    cfg = reduced_for_smoke(get_config("gemma-2b"))
    flag = lambda name: int(LAUNCH_TRAIN[LAUNCH_TRAIN.index(name) + 1])
    steps = flag("--steps")
    require((flag("--batch"), cfg.n_heads, cfg.n_kv_heads, flag("--seq"),
             cfg.head_dim) == LAUNCH_ATTN, "launch.train's attention shape "
            f"is not LAUNCH_ATTN {LAUNCH_ATTN}, at which phase 2 checks it")
    want = {name: 0 for name in path_counts()}
    want["local_attn"] = 2 * steps * cfg.n_layers
    want["local_attn_bwd"] = steps * cfg.n_layers
    # f32: both directions on split tf32
    want["local_attn_tf32"] = want["local_attn_bwd_tf32"] = steps * cfg.n_layers
    torch.cuda.synchronize()
    reset_launch_counts()
    _, losses = train.main([*LAUNCH_TRAIN, "--device", dev.type])
    torch.cuda.synchronize()
    counts = path_counts()
    print(f"[distribution] launch.train {' '.join(LAUNCH_TRAIN)}: losses "
          f"{losses}, launches {json.dumps(counts)}")
    require(all(math.isfinite(x) for x in losses), f"launch.train losses "
                                                   f"{losses}")
    require(counts == want, f"launch.train launched {counts}, expected {want}")
    reset_launch_counts()
    out = serve.main(["--device", dev.type])
    torch.cuda.synchronize()
    more = path_counts()
    print(f"[distribution] launch.serve: tokens {np.asarray(out).shape}, "
          f"range [{int(np.min(out))}, {int(np.max(out))}], launches "
          f"{json.dumps(more)}")
    require(((out >= 0) & (out < cfg.vocab_size)).all(),
            "launch.serve: a token outside the vocabulary")
    return add_counts(counts, more)


def phase_distribution(dev) -> tuple[dict, dict]:
    """Phase 15 (see the module docstring).  Returns the launches of the
    "distribution" path (placed scoring and the cluster-parallel round)
    and of the "launch" path (the launchers)."""
    import torch

    t0 = time.perf_counter()
    counts = placed_scoring(dev)
    torch.cuda.empty_cache()
    counts = add_counts(counts, cluster_parallel_round(dev))
    torch.cuda.empty_cache()
    launched = launchers(dev)
    print(f"[distribution] phase wall {time.perf_counter() - t0:.1f} s; "
          f"card: {card_line()}")
    return counts, launched


# ----------------------------------------------------------------- phase 16
# examples/quickstart_torch.py: the user's command (tcp, a subprocess),
# the three other topologies at the example's size in this process (from
# CPU-drawn weights, so the CPU child's runs start from the same ones),
# and gemma-2b at full width and depth in bf16 on the sharded store
QUICKSTART_TOPOLOGIES = ("single", "sharded", "process")
QUICKSTART_RTOL = 1e-4      # params, card against CPU, x max(1, max|p|)
# ... or this many times the CPU run's own move under one ulp of its
# initial weights (about 9e-5: the run's 96 AdamW steps amplify
# rounding, m / sqrt(v) flipping where gradients are near zero)
QUICKSTART_WITNESS = 4.0
QUICKSTART_FULL = "gemma-2b"
# (c)'s depth: the run holds about 75 bytes a parameter at its peak (the
# example's AdamW keeps f32 moments, old and new at the update, beside f32
# clipped gradients and updates; the store's models, four clients' local
# models, queued updates and the sim's in-flight snapshots stay alive):
# alone on the 80 GB card 4 of 18 layers (965 M parameters) peak at 67.3
# GiB and 6 run out of memory in the AdamW update
# (tools/quickstart_memory.py); after (b), beside (a)'s processes, 4 ran
# out too, so 3 (855 M parameters)
QUICKSTART_FULL_DEPTH = 3
QUICKSTART_UPDATES = 16
# the sim's store tiers' own stats keys (sharded: SHARD_FIELDS and the
# queue's; process: PROC_FIELDS too)
QUICKSTART_TIER_FIELDS = ("coalesce_factor", "max_queue_depth",
                          *SHARD_FIELDS, *PROC_FIELDS)


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quickstart_init():
    """The reduced config's weights drawn from seed 0 on the CPU: the
    card's runs and the CPU child's start from the same tensors."""
    import torch
    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.models.model import build_model

    cfg = reduced_for_smoke(get_config(QUICKSTART_FULL))
    return build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")


def as_json(obj):
    """``obj`` as it comes back from JSON (tuples as lists, keys as
    strings): how the CPU child's results arrive."""
    return json.loads(json.dumps(obj))


def quickstart_summary(out) -> dict:
    """What the card's run and the CPU's are held to: ``info`` (the
    assignments, stats, each cluster's round and samples and the join's
    keys, as JSON) and every model's leaves on the CPU."""
    from repro_torch.utils.tree import tree_leaves

    store = out["fed"].store
    return {"info": as_json({
                "assignments": out["assignments"], "stats": out["stats"],
                "metas": {k: [m.round, m.samples_learned]
                          for k, m in out["metas"].items()},
                "join": out["join"][0]}),
            "params": {f"{level}:{key}": [x.cpu() for x in tree_leaves(
                store.params(level, key))] for level, key in
                model_keys(store)}}


def quickstart_cpu() -> dict:
    """The CPU child's job: the example on the four topologies from
    ``quickstart_init``'s weights (tcp on two CPU shard servers), and, as
    the witness of its rounding sensitivity, single, sharded and process
    again from those weights scaled by 1 + 2^-23 (``<topology>_ulp``:
    their params only)."""
    import io

    from repro_torch.utils.tree import tree_map

    example, init = load_example("quickstart_torch"), quickstart_init()
    nudged = tree_map(lambda x: x * (1 + 2.0**-23), init)
    out = {}
    for topology, weights, tag in (
            *((t, init, t) for t in (*QUICKSTART_TOPOLOGIES, "tcp")),
            *((t, nudged, f"{t}_ulp") for t in QUICKSTART_TOPOLOGIES)):
        with contextlib.redirect_stdout(io.StringIO()):
            run = example.quickstart(topology, init_params=weights,
                                     device="cpu")
        out[tag] = quickstart_summary(run)
    return out


def quickstart_counted(dev, topology, cfg=None, init=None,
                       timed: bool = False):
    """``quickstart(topology)`` on the card, its printed lines kept, the
    counters set to 0 just before and read just after, its folds recorded
    and its AdamW steps counted.  Returns (out, counts, steps, implied
    launches, wall, fold seconds, the printed text)."""
    import io

    import torch
    from repro_torch.kernels import reset_launch_counts

    example = load_example("quickstart_torch")
    steps = [0]
    build_step = example.build_train_step

    def counted(*a, **kw):
        step = build_step(*a, **kw)

        def run(*s):
            steps[0] += 1
            return step(*s)
        return run

    example.build_train_step = counted
    text = io.StringIO()
    recorder = recording_folds(16, timed=timed)
    with recorder as folds:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            out = example.quickstart(topology, cfg=cfg, init_params=init,
                                     device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = path_counts()
    return (out, counts, steps[0], implied_launches(folds), wall,
            recorder.seconds if timed else None, text.getvalue())


def require_attention_launches(counts, layers, steps, route, what):
    """One ``local_attn`` forward and one backward launch a layer a step,
    all on ``route`` ("tf32": the split-tf32 pair, "tc": the tensor-core
    pair)."""
    other = "tc" if route == "tf32" else "tf32"
    want = layers * steps
    require(counts[f"local_attn_{route}"] == want
            and counts[f"local_attn_bwd_{route}"] == want
            and counts["local_attn"] == 2 * want
            and counts[f"local_attn_{other}"] == 0
            and counts[f"local_attn_bwd_{other}"] == 0,
            f"{what}: local_attn launches {counts['local_attn']} (forward "
            f"{counts[f'local_attn_{route}']}, backward "
            f"{counts[f'local_attn_bwd_{route}']} on {route}), expected "
            f"{want} each ({layers} layers x {steps} steps)")


def parsed_line(text: str, prefix: str):
    """The Python literal after ``prefix`` on the first line holding it."""
    import ast

    for line in text.splitlines():
        if prefix in line:
            return ast.literal_eval(line.split(prefix, 1)[1].strip())
    raise SmokeFailure(f"no line with {prefix!r} in: {text[-2000:]}")


class QuickstartCommand:
    """``examples/quickstart_torch.py --topology tcp --metrics --trace-out
    <tmp>/spans.json`` as a user runs it, in the background: a thread reads
    its lines and, when the servers announce, counts the card's compute
    processes (the example's own and its two ``--device cuda``
    servers)."""

    def __init__(self):
        import tempfile
        import threading

        self._dir = tempfile.TemporaryDirectory()
        self.trace = Path(self._dir.name) / "spans.json"
        self._err = open(Path(self._dir.name) / "stderr", "w+")
        self.before = compute_apps()
        self.apps = self.t_end = None
        self.lines = []
        env = dict(os.environ, PYTHONUNBUFFERED="1")
        env["PYTHONPATH"] = os.pathsep.join(
            [str(REPO / "src"), *filter(None, [env.get("PYTHONPATH")])])
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, str(REPO / "examples" / "quickstart_torch.py"),
             "--topology", "tcp", "--metrics", "--trace-out",
             str(self.trace)], stdout=subprocess.PIPE, stderr=self._err,
            text=True, env=env, start_new_session=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)
            if line.startswith("loopback shard servers:"):
                self.apps = compute_apps()
        self.t_end = time.perf_counter()

    def result(self) -> dict:
        """Wait for the command (up to 600 s) and check what it printed
        and wrote; returns its assignments, stats and metas."""
        try:
            self.proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            self.close()
        self._reader.join(10.0)
        wall = time.perf_counter() - self.t0
        text = "".join(self.lines)
        self._err.seek(0)
        require(self.proc.returncode == 0, f"examples/quickstart_torch.py "
                f"--topology tcp exited {self.proc.returncode}: "
                f"{self._err.read()[-2000:]}")
        require(self.apps is not None, "the example announced no servers")
        print(f"[quickstart] (a) servers up: nvidia-smi compute apps before "
              f"{len(self.before)}, with the example and its two servers "
              f"{len(self.apps)}")
        require(len(self.apps) - len(self.before) >= 3,
                f"(a) {len(self.apps) - len(self.before)} new compute "
                "processes for the example and its two --device cuda "
                "servers")
        trace = json.loads(self.trace.read_text())
        flows = {(e["id"], e["pid"]) for e in trace["traceEvents"]
                 if e["ph"] in ("s", "t", "f")}
        crossing = ({i for i, p in flows if p == 0}
                    & {i for i, p in flows if p > 0})
        out = {"assignments": parsed_line(text, "cluster assignments:"),
               "stats": parsed_line(text, "async stats:"),
               "metas": {}}
        for line in text.splitlines():
            if line.startswith("  cluster ") and "round=" in line:
                key, rest = line.split("cluster ", 1)[1].split(": ", 1)
                fields = dict(f.split("=") for f in rest.split())
                out["metas"][key] = [int(fields["round"]),
                                     int(fields["samples"])]
        for line in text.splitlines():
            if line.startswith(("topology ", "async stats:", "  cluster ",
                                "  transport=", "new org assigned",
                                "telemetry sites:")):
                print(f"[quickstart] (a) {line.strip()}")
        require("  transport=tcp respawns=0 " in text,
                "(a) no 'transport=tcp respawns=0' line")
        require("new org assigned to ['loc:0']" in text, "(a) no join line")
        require("telemetry sites: ['parent', 'shard-0', 'shard-1']" in text,
                "(a) the metrics summary lacks the servers' sites")
        require(len(out["metas"]) == 2, f"(a) cluster metas {out['metas']}")
        print(f"[quickstart] (a) examples/quickstart_torch.py --topology tcp "
              f"--metrics --trace-out <tmp>/spans.json: exit 0 in "
              f"{wall:.1f} s (process start included); trace "
              f"{len(trace['traceEvents'])} events, {len(crossing)} flow "
              f"chains from the parent to a server")
        require(crossing, "(a) no flow chain of the trace reaches a server")
        return out

    def close(self):
        """Stop the command if it still runs, its servers with it (one
        process group)."""
        import signal

        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        self._reader.join(10.0)
        self._err.close()
        self._dir.cleanup()


def quickstart_reduced(dev, init) -> tuple[dict, dict]:
    """(b): single, sharded and process at the example's size from
    ``init`` (the process topology is the sim's in-process emulation, as
    in the reference: its workers fold in this process).  Returns each
    run's summary and the launches of the three runs."""
    from repro_torch.configs import get_config, reduced_for_smoke

    layers = reduced_for_smoke(get_config(QUICKSTART_FULL)).n_layers
    runs, total = {}, {}
    for topology in QUICKSTART_TOPOLOGIES:
        out, counts, steps, implied, wall, _, _ = quickstart_counted(
            dev, topology, init=init)
        print(f"[quickstart] (b) {topology}: {wall:.2f} s ({wall:.4f} s), "
              f"{steps} AdamW steps, stats {json.dumps(out['stats'])}, fold "
              f"launches {counts['fedavg_agg']} (implied {implied}), "
              f"local_attn forward {counts['local_attn_tf32']} and backward "
              f"{counts['local_attn_bwd_tf32']} on split tf32")
        require_attention_launches(counts, layers, steps, "tf32",
                                   f"quickstart {topology}")
        require(counts["fedavg_agg"] == implied and implied > 0,
                f"quickstart {topology}: {counts['fedavg_agg']} fold "
                f"launches, the recorded folds imply {implied}")
        runs[topology] = quickstart_summary(out)
        total = add_counts(total, counts)
    first = runs["single"]["info"]
    for topology, run in runs.items():
        info = run["info"]
        require(info["assignments"] == first["assignments"]
                and sim_stats(info["stats"]) == first["stats"]
                and info["metas"] == first["metas"]
                and info["join"] == first["join"],
                f"quickstart {topology}: assignments, stats, metas or join "
                "differ from single's")
    return runs, total


def sim_stats(stats) -> dict:
    """A run's stats without the store tier's own keys."""
    return {k: v for k, v in stats.items()
            if k not in QUICKSTART_TIER_FIELDS}


def quickstart_full(dev, reduced: dict) -> dict:
    """(c): gemma-2b at full width and QUICKSTART_FULL_DEPTH in its own
    bf16 on the sharded store: QUICKSTART_UPDATES updates, the reduced run's
    assignments, one tensor-core local_attn forward and backward a layer a
    step, fold launches = implied, the global model moved, the join's
    params the Vienna cluster model's.  Wall time, peak memory and the
    fold's share printed.  Returns the launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config(QUICKSTART_FULL)
    cfg = cfg.replace(n_layers=QUICKSTART_FULL_DEPTH)
    init = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                 dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, counts, steps, implied, wall, fold_s, _ = quickstart_counted(
        dev, "sharded", cfg=cfg, init=init, timed=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    store = out["fed"].store
    moved = any(bool(torch.any(a != b)) for a, b in zip(
        tree_leaves(store.params("global")), tree_leaves(init), strict=True))
    keys, params = out["join"]
    joined = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(params), tree_leaves(store.params("cluster", keys[0])),
        strict=True))
    n_params = sum(x.numel() for x in tree_leaves(init))
    print(f"[quickstart] (c) {QUICKSTART_FULL} at full width, "
          f"{cfg.n_layers} of {get_config(QUICKSTART_FULL).n_layers} layers "
          f"(d_model {cfg.d_model}, head_dim "
          f"{cfg.head_dim}, vocab {cfg.vocab_size}, {cfg.dtype}, "
          f"{n_params:,} parameters) on the sharded store: {wall:.1f} s "
          f"({wall:.4f} s) for {steps} AdamW steps, peak memory "
          f"{peak:.2f} GiB, folds {fold_s:.2f} s ({fold_s / wall:.4f} of "
          f"the run), stats {json.dumps(out['stats'])}, fold launches "
          f"{counts['fedavg_agg']} (implied {implied}), local_attn forward "
          f"{counts['local_attn_tc']} and backward "
          f"{counts['local_attn_bwd_tc']} on the tensor cores, global model "
          f"moved {moved}, join {keys} equal to its cluster model {joined}; "
          f"card: {card_line()}")
    require(out["stats"]["updates"] == QUICKSTART_UPDATES,
            f"quickstart full: {out['stats']['updates']} updates")
    require(as_json(out["assignments"]) == reduced["assignments"]
            and keys == reduced["join"],
            "quickstart full: assignments or join differ from the reduced "
            "run's")
    require_attention_launches(counts, cfg.n_layers, steps, "tc",
                               "quickstart full")
    require(counts["fedavg_agg"] == implied and implied > 0,
            f"quickstart full: {counts['fedavg_agg']} fold launches, the "
            f"recorded folds imply {implied}")
    require(moved, "quickstart full: the global model equals its init")
    require(joined, "quickstart full: the join's params are not its "
                    "cluster model's")
    return counts


def models_gap(a: dict, b: dict) -> tuple[float, float]:
    """(max abs difference over every model's leaves, max |p| of ``b``)."""
    gap = top = 0.0
    for name, leaves in a.items():
        for x, y in zip(leaves, b[name], strict=True):
            gap = max(gap, (x - y).abs().max().item())
            top = max(top, y.abs().max().item())
    return gap, top


def check_quickstart_cpu(card: dict, tcp: dict, cpu: dict):
    """The card's runs against the CPU child's: (b) each topology's
    assignments, stats, metas and join equal, and every model within
    QUICKSTART_RTOL x max(1, max|p|) or, where 96 AdamW steps amplify
    rounding past that, within QUICKSTART_WITNESS times what one ulp of
    the initial weights moves the CPU run (``<topology>_ulp``); (a)'s
    printed assignments, stats and metas equal to the CPU's tcp run."""
    for topology, run in card.items():
        want = cpu[topology]
        gap, top = models_gap(run["params"], want["params"])
        witness = models_gap(cpu[f"{topology}_ulp"]["params"],
                             want["params"])[0]
        rtol = QUICKSTART_RTOL * max(1.0, top)
        limit = max(rtol, QUICKSTART_WITNESS * witness)
        same = run["info"] == json.loads(want["info"])
        print(f"[quickstart] (b) {topology} against the CPU: assignments, "
              f"stats, metas and join {'equal' if same else 'DIFFER'}; "
              f"params max abs diff {gap:.3e} ({QUICKSTART_RTOL:g} x "
              f"max(1, max|p|) = {rtol:.3e} "
              f"{'met' if gap <= rtol else 'missed'}; the CPU run moved "
              f"{witness:.3e} by one ulp of its initial weights; limit "
              f"{limit:.3e})")
        require(same, f"quickstart {topology}: the card's run differs from "
                      "the CPU's")
        require(gap <= limit, f"quickstart {topology}: params differ from "
                              f"the CPU's by {gap}")
    want = json.loads(cpu["tcp"]["info"])
    same = all(tcp[k] == want[k] for k in ("assignments", "stats", "metas"))
    print(f"[quickstart] (a) tcp against the CPU's tcp run: assignments, "
          f"stats and metas {'equal' if same else 'DIFFER'}")
    require(same, f"quickstart tcp: printed {tcp} differs from the CPU's "
                  f"{want}")


def phase_quickstart(dev) -> tuple[dict, dict, dict]:
    """Phase 16 (see the module docstring): (a) runs in the background
    while (b) and (c) run here (neither starts a process).  Returns the
    launches of (b) and (c), (b)'s summaries and (a)'s printed run."""
    import torch

    t0 = time.perf_counter()
    command = QuickstartCommand()
    try:
        runs, counts = quickstart_reduced(dev, quickstart_init())
        torch.cuda.empty_cache()
        t_full = time.perf_counter()
        counts = add_counts(counts, quickstart_full(
            dev, runs["single"]["info"]))
        torch.cuda.empty_cache()
        tcp = command.result()
    finally:
        command.close()
    print(f"[quickstart] (a) ran beside (c) for "
          f"{max(0.0, command.t_end - t_full):.1f} s")
    first = runs["single"]["info"]
    same = (tcp["assignments"] == first["assignments"]
            and tcp["metas"] == first["metas"])
    print(f"[quickstart] (a) against (b): assignments and metas "
          f"{'equal' if same else 'DIFFER'}; stats on the sim's keys "
          f"{json.dumps(sim_stats(tcp['stats']))} against "
          f"{json.dumps(first['stats'])} (tcp's lazy mirror sync, every 4 "
          f"drains, leaves the updates of folds not yet synced out of the "
          f"run's stats, as in the reference; held to the CPU's tcp run)")
    require(same, "quickstart: (a)'s assignments or metas differ from (b)'s")
    print(f"[quickstart] phase wall {time.perf_counter() - t0:.1f} s; "
          f"card: {card_line()}")
    return counts, runs, tcp


# ----------------------------------------------------------------- phase 17
# the reference's chaos scenario (tests/test_scenarios.py,
# test_chaos_outage_migration_worker_kill) on the card
CHAOS = dict(n_clients=5_000, n_ticks=16, n_clusters=8, seed=11)
CHAOS_SLO = dict(lost_updates=0, effective_round_regressions=0)
CHAOS_GONE_S = 15.0         # a killed process leaves nvidia-smi's list


def chaos_inject(store, rep, *, kill: bool):
    """Mid-storm rebalance (+ optional crash): migrate the hottest
    cluster to the next shard, then sever the destination worker."""
    dst = (store.shard_of("c0") + 1) % store.n_shards
    store.migrate_cluster("c0", dst)
    if kill:
        store._debug_kill_worker(dst)


def chaos_scenario(param_dim: int = 16):
    """The reference's chaos scenario; ``param_dim`` 16 is its default."""
    from repro_torch.scenario import regional_outage

    return regional_outage(**CHAOS, param_dim=param_dim)


def chaos_cpu() -> dict:
    """The CPU child's job: the sharded chaos run's fields and final
    params and anchors, as JSON."""
    from repro_torch.scenario import run_scenario

    rep = run_scenario(chaos_scenario(), topology="sharded", n_shards=2,
                       inject={6: lambda s, r: chaos_inject(s, r,
                                                            kill=False)},
                       device="cpu")
    return {"fields": as_json(report_fields(rep)),
            "ewc": {part: {k: v.tolist() for k, v in rep.ewc[part].items()}
                    for part in ("final_params", "anchors")}}


def await_departure(n: int, what: str):
    """Wait until nvidia-smi lists ``n`` compute processes (a killed one
    has left the card)."""
    deadline = time.monotonic() + CHAOS_GONE_S
    while len(compute_apps()) != n:
        require(time.monotonic() < deadline, f"{what}: nvidia-smi still "
                f"lists {len(compute_apps())} compute processes, not {n}, "
                f"{CHAOS_GONE_S} s after the kill")
        time.sleep(0.2)


def chaos_stores(dev, widths) -> tuple[list, list]:
    """One process store (2 spawned CUDA workers) a width, built on
    threads of their own so that every worker's cold start overlaps;
    returns the stores and the compute processes listed before them."""
    import threading

    from repro_torch.obs.record import Telemetry
    from repro_torch.scenario.engine import make_store

    before = compute_apps()
    stores, errors = [None] * len(widths), []

    def build(i, width):
        try:
            stores[i] = make_store(
                "process", cluster_keys=[f"c{j}" for j in
                                         range(CHAOS["n_clusters"])],
                n_shards=2, telemetry=Telemetry(sample_n=64, site="parent"),
                max_coalesce=16, param_dim=width, device=dev)
        except BaseException as e:      # raised below, on this thread
            errors.append(e)

    threads = [threading.Thread(target=build, args=(i, w))
               for i, w in enumerate(widths)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        for store in stores:
            if store is not None:
                store.close()
        raise errors[0]
    require_on_card([sh.handle.proc.pid for st in stores
                     for sh in st._proc_shards], before,
                    "chaos process: spawned workers")
    return stores, before


def chaos_process(dev, store, live: int, tag: str):
    """The chaos run on ``store`` (process topology, 2 spawned CUDA
    workers; ``live`` compute processes listed as it starts), the
    destination worker killed at tick 6 after the migration: the SLOs, a
    respawn, the killed worker gone from the card and its successor on it.
    Closes the store.  Returns (report, counts, routes)."""
    scen = chaos_scenario(store.params("global")["w"].numel())
    try:
        handles = [sh.handle for sh in store._proc_shards]
        killed, first = [], [h.cold_start_s for h in handles]

        def inject(s, r):
            chaos_inject(s, r, kill=True)
            killed.extend(h for h in handles if not h.alive())
            await_departure(live - 1, tag)

        rep, counts, routes, wall, _ = scenario_run(
            scen, dev, topology="process", store=store, inject={6: inject})
        apps = compute_apps()
        spawns = store.worker_spawns()
        print_scenario(rep, counts, wall, tag)
        print(f"[chaos] {tag}: migrations {rep.stats['cluster_migrations']},"
              f" respawns {rep.stats['respawns']}, spawns {spawns}, killed "
              f"worker {[h.idx for h in killed]}, cold starts "
              f"{[round(t, 3) for t in first]} s, the respawn's "
              f"{[round(h.cold_start_s, 3) for h in killed]} s, wire bytes "
              f"tx {rep.stats['wire_tx_bytes']} rx "
              f"{rep.stats['wire_rx_bytes']}, nvidia-smi compute apps at the "
              f"start {live}, after the kill {live - 1}, at the end "
              f"{len(apps)}, devices {[h.device for h in handles]}")
        require(len(killed) == 1, f"{tag}: {len(killed)} workers dead after "
                                  "the kill")
        require_chaos(rep, tag, respawned=True)
        require(sum(spawns) == len(spawns) + rep.stats["respawns"]
                and len(apps) == live
                and all(h.alive() and h.device.startswith("cuda")
                        for h in handles),
                f"{tag}: the respawned worker is not on the card (spawns "
                f"{spawns}, {len(apps)} compute apps, {live} at the start)")
    finally:
        store.close()
    return rep, counts, routes


def require_chaos(rep, tag, respawned: bool):
    """The reference test's assertions."""
    rep.assert_slo(**CHAOS_SLO)
    require(rep.stats["cluster_migrations"] >= 1,
            f"{tag}: no cluster migration")
    if respawned:
        require(rep.stats["respawns"] >= 1, f"{tag}: no respawn")


def chaos_tcp(dev, srv):
    """The tcp topology on the shared ``--device cuda`` servers ``srv``:
    the worker killed at tick 6 (its session dropped), server 0 killed at
    tick 10 (gone from the card) and respawned on its port with the same
    device (on the card again).  Returns (report, counts, routes)."""
    scen = chaos_scenario()
    before = compute_apps()
    respawned = {}

    def kill_server(store, rep):
        srv.kill(0)
        await_departure(len(before) - 1, "chaos tcp")
        srv.respawn(0)
        respawned.update(apps=compute_apps(), cold_s=srv.startup_s[0],
                         pid=srv.pids[0])

    inject = {6: lambda s, r: chaos_inject(s, r, kill=True),
              10: kill_server}
    rep, counts, routes, wall, _ = scenario_run(
        scen, dev, topology="tcp", hosts=srv.hosts, inject=inject)
    print_scenario(rep, counts, wall, "chaos tcp")
    print(f"[chaos] tcp: migrations {rep.stats['cluster_migrations']}, "
          f"respawns {rep.stats['respawns']}, server 0 respawned in "
          f"{respawned.get('cold_s', float('nan')):.3f} s on --device "
          f"{srv.device}; nvidia-smi compute apps before {len(before)}, "
          f"after the kill {len(before) - 1}, after the respawn "
          f"{len(respawned.get('apps', ()))}; wire bytes tx "
          f"{rep.stats['wire_tx_bytes']} rx {rep.stats['wire_rx_bytes']}")
    require_chaos(rep, "chaos tcp", respawned=True)
    require(respawned and len(respawned["apps"]) == len(before)
            and srv.device.startswith("cuda"),
            "chaos tcp: the respawned server is not on the card")
    return rep, counts, routes


def phase_chaos(dev, srv) -> tuple[dict, dict, dict]:
    """Phase 17 (see the module docstring).  Returns the launches and
    routes of the runs in this process, summed, and the sharded run's
    report for the CPU check."""
    t0 = time.perf_counter()
    kill6 = {6: lambda s, r: chaos_inject(s, r, kill=False)}
    rep, counts, routes, wall, folds = scenario_run(
        chaos_scenario(), dev, topology="sharded", n_shards=2, inject=kill6)
    print_scenario(rep, counts, wall, "chaos sharded")
    require_chaos(rep, "chaos sharded", respawned=False)
    implied = implied_launches(folds)
    require(counts["fedavg_agg"] == implied and implied > 0,
            f"chaos sharded: {counts['fedavg_agg']} fold launches, the "
            f"drain batches imply {implied}")
    runs = [(counts, routes), chaos_tcp(dev, srv)[1:]]
    sharded = rep
    (narrow, wide), before = chaos_stores(dev, (16, SOLAR_PARAMS))
    runs.append(chaos_process(dev, narrow, len(before) + 4,
                              "chaos process")[1:])
    runs.append(chaos_process(dev, wide, len(before) + 2,
                              f"chaos process at width {SOLAR_PARAMS:,}")[1:])
    counts, routes = sum_counts(*runs)
    require(counts["fedavg_agg"] > 0, "chaos: no fold launched in this "
                                      "process")
    print(f"[chaos] phase wall {time.perf_counter() - t0:.1f} s; card: "
          f"{card_line()}")
    return counts, routes, sharded


def check_chaos_cpu(card, cpu: dict):
    """The sharded chaos run on the card against the CPU child's: every
    field but timings equal, final params and anchors within 1e-5."""
    import types

    import numpy as np

    gap, top = final_gap(card, types.SimpleNamespace(ewc={
        part: {k: np.asarray(v, dtype=np.float32) for k, v in arrays.items()}
        for part, arrays in cpu["ewc"].items()}))
    same = as_json(report_fields(card)) == cpu["fields"]
    print(f"[chaos] sharded on the card against the CPU: fields "
          f"{'equal' if same else 'DIFFER'}, final params max abs diff "
          f"{gap:.3e} (limit {1e-5 * max(1.0, top):.3e})")
    require(same, "chaos: the card's sharded run differs from the CPU's")
    require(gap <= 1e-5 * max(1.0, top),
            f"chaos: params differ from the CPU's by {gap}")


def main() -> int:
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, __file__, *sys.argv[1:]],
                  dict(os.environ, PYTHONHASHSEED="0"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    child = None
    marks = [("start", time.perf_counter())]

    def mark(name):                     # each phase's wall time, printed
        marks.append((name, time.perf_counter()))
        print(f"[time] {name}: {marks[-1][1] - marks[-2][1]:.1f} s")

    try:
        phase_build()
        mark("build")
        results = phase_kernels(dev)
        mark("kernels")
        for name, res in results.items():       # the kernels line's own keys
            require(not {"name", "route", "source", "replaces",
                         "launches"} & set(res),
                    f"{name}: a check's result names a key of the kernels "
                    "line")
        counts, routes = {}, {}
        counts["main"], routes["main"] = phase_main(dev)
        mark("main")
        phase_profile(dev)
        mark("profile")
        counts["privacy"], routes["privacy"] = phase_privacy(dev)
        mark("privacy")
        counts["threaded"], routes["threaded"], idle = phase_threaded(dev)
        mark("threaded")
        # the CPU halves of three checks run in a child beside phases 7-14
        child = CpuChild()
        counts["sharded"], routes["sharded"], card16 = \
            phase_sharded(dev, idle)
        mark("sharded")
        # one pair of --device cuda shard servers for phases 8-10
        with shard_servers(dev) as srv:
            counts["process"], routes["process"] = phase_process(dev, srv)
            mark("process")
            paths, telemetry16 = phase_telemetry_scenario(dev, srv)
            for path, (c, r) in paths.items():
                counts[path], routes[path] = c, r
            mark("telemetry and scenario")
            counts["chaos"], routes["chaos"], chaos = phase_chaos(dev, srv)
        mark("chaos")
        # phase 12's CPU weights and the child's gradients, made beside
        # phases 11 and 12
        cases = AgreeCases(child)
        counts["llm"] = phase_llm(dev)
        mark("llm")
        phase_agree(dev)
        mark("agree")
        phase_llm_agree(dev, cases)
        mark("llm agree")
        phase_example()
        mark("example")
        counts["train"], counts["fed_llm"] = phase_train(dev)
        mark("train")
        counts["train_remat"], counts["remat_witness"] = \
            phase_train_families(dev)
        mark("train families")
        counts["distribution"], counts["launch"] = phase_distribution(dev)
        mark("distribution")
        counts["quickstart"], quick, quick_tcp = phase_quickstart(dev)
        mark("quickstart")
        check_quickstart_cpu(quick, quick_tcp, child.tensors("quickstart"))
        check_chaos_cpu(chaos, child.result("chaos"))
        check_sharded_cpu(card16, child.result("sharded"))
        check_telemetry_cpu(child.result("telemetry"), *telemetry16)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        if child is not None:
            child.close()
    # launches: each path's run, counters set to 0 just before it; a
    # backward entry counts its wrapper's launches_bwd
    main_keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms")
    route_keys = {"lstm_cell": ("lstm_seq_fwd", "lstm_seq_bwd"),
                  "fedavg_agg": ("fedavg_agg_leaves",)}
    route_extra = {"local_attn_tf32": ("cuda_core_bound_ms", "products"),
                   "local_attn_bwd_tf32": ("cuda_core_bound_ms",
                                           "products")}
    count_keys = {"ssd_chunk": ("ssd_chunk_bwd",),
                  "local_attn": ("local_attn_tc", "local_attn_tf32",
                                 "local_attn_bwd"),
                  "local_attn_bwd": ("local_attn_bwd_tc",
                                     "local_attn_bwd_tf32")}
    by_path = {name: {p: c.get(name, 0) for p, c in counts.items()}
               for name in (*KERNEL_META, "local_attn_tc", "local_attn_tf32",
                            "local_attn_bwd_tc", "local_attn_bwd_tf32")}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces,
                "launches": sum(by_path[name].values()),
                "launches_by_path": by_path[name],
                **{f"launches_{r}": {p: rt[r] for p, rt in routes.items()}
                   for r in route_keys.get(name, ())},
                **{f"launches_{r}": by_path[r]
                   for r in count_keys.get(name, ())},
                **{k: results[name][k] for k in main_keys},
                **{k: v for k, v in results[name].items()
                   if k not in main_keys}}
               for name, (src, replaces) in KERNEL_META.items()]
    for name, (parent, prefix, src) in ROUTE_META.items():
        by = {p: c.get(name, routes.get(p, {}).get(name, 0))
              for p, c in counts.items()}
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": KERNEL_META[parent][1],
                        "launches": sum(by.values()), "launches_by_path": by,
                        **{k: results[parent][prefix + k]
                           for k in main_keys},
                        **{k: results[parent][prefix + k]
                           for k in route_extra.get(name, ())}})
    print(f"[done] {time.perf_counter() - t0:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
