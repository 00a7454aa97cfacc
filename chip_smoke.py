#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one
``nvcc`` per source, all at once), holds each against its plain PyTorch
version on the card at the paper's 256 MB table (``paper_config``) — the
bitset step for rsbf, bsbf, bsbfsd and rlbsbf (hashing its keys in the
kernel), the counter step for sbf, sbf at Max 1, swbf, cms and hh (sbf at
Max 1 at 128 MB: its one plane of 2^31 cells would overflow the int32
sentinel), hashmix (both layouts, k up to 64, the seeds past 32 rows read
from device memory), bloom_probe, fused_probe and scatter_delta — and
reproduces the reference's seven pinned digests on CUDA. Then it drives
three paths over one 3 x 2^21-record stream (cut from 2^24 to 2^23 to
make room for the "moe" phase, then to 3 x 2^21, the least the
checkpoint resume below needs, for the "graph_recsys" phase) at the
paper's 60% distinct fraction, batch 8192, each
with the launch counts set to 0 just before and read just after:

* rlbsbf on the 256 MB table (k = 2, s = 2^30 bits per row) on the plane
  layout: the bitset step, which hashes its keys itself (no hashmix
  launch);
* sbf, the paper's baseline, on the 256 MB table (k = 3, Max 3, 2^30
  two-bit cells) on the plane layout: hashmix and the counter step, then
  one ``estimate`` and one ``top_cells``;
* a classic Bloom filter through ``kernels/ops.py`` on the rlbsbf table's
  shape, over the stream's first 2^21 records: fused_probe (one launch per
  batch) and scatter_delta, then a pass that checks every key is held
  with ``hash_positions`` (hashmix) and ``probe`` (bloom_probe).

The two 256 MB plane paths checkpoint on the way: at record 2^22 the live
state is saved with the port's ``CheckpointManager`` (``layout_meta``
stamped, 256 MB of npz in a temporary directory removed after the dense8
phase), and the live run goes on. After it, the checkpoint is restored
into a fresh ``Dedup``'s ``init()`` on the card and continued over the next
2^21 records: its reports must equal the live run's there, bit for bit,
and its leaves the live run's at record 2^22 + 2^21.

Then the reference's default path, "dense8": ``DedupPipeline`` over
``paper_config(v, 256)`` with the default layout, which is dense8 (one
byte per bit, per cell for sbf): rlbsbf (a (2, 2^30) uint8 state, 2 GiB)
and sbf (2^30 cells, 1 GiB) over the stream's first 2^22 records (the
depth cut for the run's time limit), one hashmix launch per step
and no step kernel, their FPR / FNR from ``StreamMetrics.summary()``,
their dup reports equal bit for bit to the plane paths' on that prefix,
and each final state migrated to the plane layout on the card
(``migrate_filter_state``) equal leaf for leaf to the plane path's
checkpoint at the same record; and the sbf oracle, ``run_stream_oracle``
at the 256 MB table over 512 keys (cut from 4096 to make room for the
"train" phase, then from 1024 for the "graph_recsys" phase), equal to
the batch-size-1 engine.

Then the tenant fleets (DESIGN §4.6): 32 tenants of 8 MB each (the paper's
smallest table per tenant, 256 MiB stacked). Its "fleet" phase holds both
step kernels over their tenant grid axis against their plain versions
(the bitset step for the four variants; the params-aware counter step for
sbf with per-tenant Max 3 / 2, swbf with per-tenant windows, cms with
per-tenant thresholds, and hh), and two paths run ``FleetDedup.run_stream``
over the stream's first 2^21 records (cut from 2^23 to 2^22 to make room
for the dense8 phase, and to 2^21 for the checkpoint resumes and the serve
phase) with tenant ids drawn uniformly from a seeded generator
(capacity 512 per tenant and step):

* fleet-rlbsbf-32x8MB: rlbsbf, k = 2, s = 2^25 per row (no hashmix);
* fleet-sbf-32x8MB-hetero: sbf on planes, d = 2, per-tenant Max 3 and 2.

Then the "shard" phase: the sharded service (``ShardedDedup``) at one
NCCL rank (the card is one GPU; NCCL refuses two ranks on one device), the
group initialised from a file store in a temporary directory and kept
until the "mesh" phase has ended, every exchange through NCCL, over the
stream's first
2^20 records (2^21 until the "graph_recsys" phase came) at batch 8192:

* shard-static-rlbsbf-256MB-1rank: static hash routing, rlbsbf on the 256
  MB plane table, capacity_factor 2 (step width 16384), pipelined and
  serial — equal bit for bit in verdicts, overflow and the gathered state;
  overflow 0; one bitset step per batch;
* shard-elastic-rlbsbf-256MB-32b-1rank: 32 buckets of 8 MB, the monitor on
  (threshold 1.25, never firing at one rank), bucket width 512 — equal bit
  for bit to ``FleetDedup`` of 32 x 8 MB tenants over ``range_bucket(key,
  32)`` (verdicts, overflow, bits, load, position, rng); one bitset step
  per batch over the bucket axis;
* shard-elastic-sbf-256MB-32b-1rank: sbf (d = 2 planes) over 32 buckets,
  the first 2^19 records, pipelined equal to serial; one hashmix and one
  counter step per batch;

then the three pinned sharded digests (the reference's verdicts on 1, 4
and 2 devices, reproduced at this one rank). It prints each cell's
elements/s, host ms per step, launches per step and overflow, the NCCL
init time and a profiled 4-batch stream of each cell (device busy, NCCL
and idle shares).

Then the "serve" phase: ``ServeFrontend`` (buckets (64, 256, 1024), four
batches in flight, 2 ms flush timer, the serving example's ``2 * key``
scorer) answers 256 closed-loop clients over the stream's first 2^16
records, for ``paper_config("rlbsbf", 256)`` on its default layout
(dense8, 2 GiB) and for the fleet-rlbsbf-32x8MB config (tenant ids from a
seeded generator): every answer must be ``2 * key``, the live verdict
digest must equal ``replay_schedule`` through a fresh engine on the card,
at most one step width per bucket, and one hashmix launch (dense8) or one
bitset-step launch (fleet) per micro-batch and per replayed batch. It
prints requests/s, fill, shed and cache-hit rates, client-side p50 / p99
latency and the idle share of a micro-batch step at bucket 256.

Then the "lm" phase: the port's dense LM (``repro_torch.models``) at
qwen3-8b's published width (36 layers, d 4096, 32 / 8 heads, vocab
151936, bf16), weights from the port's seeded init on the card. It checks
the parameter count (8190735360, the reference's ``param_count()``);
teacher-forced ``decode_step`` over positions 0 - 63 against ``prefill``
of B = 4, S = 256 (max |diff| under 2% of max |logit|, bf16); an fp32
2-layer copy at full width on the card against the same weights on the
CPU (1e-3 of max |logit|, TF32 off); then serves: ``ServeFrontend``
(buckets (64, 256, 1024), 4 in flight, 2 ms flush) with the port's LM
scorer (``make_lm_scorer`` here, the serving benchmark's ``transformer``
scorer) in front of the benchmark's dedup config (rlbsbf, 2^20 bits,
dense8), 64 closed-loop clients over 2^11 requests (2^12 until the
"graph_recsys" phase came) of its mix (70% zipf,
30% fresh), after an untimed warm-up front end: every request answered,
the digest equal to ``replay_schedule`` both on the card and on the CPU
(where the engine runs hashmix's plain version), hashmix at each
micro-batch width of the run (k = 2, s = 2^19) exactly equal to its plain
version, every answer bit for bit a value its key was scored to (the
cache), every value bit for bit equal to rescoring its key in a batch of
32, one hashmix launch per micro-batch.
It prints requests/s, p50 / p99, the hit rate, the scorer's time at each
padded width (device time and idle share at the widths served) with its
peak memory, and greedy decode at B = 8 (B = 64 cut to make room for
the "moe" phase) over a 1024-slot cache (ms per step, tokens/s, device
busy and its costliest kernels) beside the weight-read bound.

Then the "moe" phase: the MoE LMs at their published widths (bf16,
seeded), one model on the card at a time — mixtral-8x7b (8 experts
top-2, SWA) at 16 of 32 layers (23482470400 parameters) and
deepseek-v2-236b (MLA with a 512-wide latent, 160 routed experts top-6
and 2 shared, a dense first layer) at 8 of 60 (29191377920), their full
depths counted on the meta device (46702792704 and 235741434880, active
12879925248 and 21375800320). For each, in fp32 at full width on 2
layers with TF32 off: the card's prefill (B 2, S 64) against the CPU's;
teacher-forced ``decode_step`` against ``prefill`` at capacity factor
n_experts / top_k (no pair can drop, so the two route alike; at the
published factor a prefill of 1024 tokens drops pairs a decode of 2
keeps); deepseek's absorbed against its naive decode; one MoE layer's
einsum dispatch against its sort dispatch at T = 256 — each within 1e-3
of the max |value|. In bf16 at the cut depth: a prefill of B 4, S 256
(finite, its shape; the (token, slot) pairs dropped per MoE layer at the
published capacity and the call's time printed), decode against it
printed, not gated (in bf16 a near tie in the router, or absorbed MLA's
rounding, moves the logits), and greedy decode at B = 8 for 32 tokens
over a 1024-slot cache (ms per step, device busy, aten ops per step)
beside the weight-read bound (the sort dispatch's grouped einsum reads
every expert each step). Then deepseek serves behind ``ServeFrontend``
(``lm_front_end``: 16 closed-loop clients over 2^10 requests, the lm
phase's checks but the rescoring one, which an MoE scorer would rightly
fail: its capacity counts its batch mates).

Then the "train" phase: dedup-gated LM training
(``repro_torch.launch.train``). ``build("100m", steps=14, dup_frac=0.3,
fault_at=11)`` — the reference's deployment training config at its full
width and depth (10 layers, d 640, vocab 32000, seq 1024, batch 32, fp32,
106.5M parameters) on the card, each batch of the reference's
``lm_batches`` through ``DedupPipeline(rlbsbf, 2^20 bits, mode="drop")``
(dense8: one hashmix launch per call) before AdamW — runs with its
injected fault: 14 steps, the latest checkpoint at 14, finite losses, one
restore (to step 10), the dedup weights equal bit for bit to a CPU replay
of the same calls (hashmix's plain version), FPR / FNR against the
corpus's own replay truth, one hashmix launch per dedup call. It prints
the corpus init and per-batch draw seconds, step ms, checkpoint save and
restore seconds, and a profiled step's device busy time, idle share and
aten ops. Then hashmix at the trainer's shape (B = 32, k = 2, s = 2^19)
against its plain version; a 2-layer copy of the config stepped 2 times
(3 until the "graph_recsys" phase came)
in lockstep from the CPU's fp32 state, in fp32 (TF32 off) and in float64
on the card and on the CPU (``train_card_vs_cpu``: the fp32 losses within
1e-4, the float64 card's gradients within 1e-8 of the float64 CPU
referee's, the fp32 card's within 4x the run's fp32 noise of it, its
updates within 1e-4 of the lr of float64 AdamW on its own gradients); the
same check once more at deepseek-v2-236b's smoke config (MLA, routed and
shared experts, the dense first layer; B 4, S 40, accumulation 2), whose
four runs must route every token to the same experts in the same order,
layer by layer, before any gradient is compared (a difference is printed
with its token and the router's top-k gap, and fails the run);
qwen3-8b's
``train_4k`` step at its published width (bf16, remat "full", 4
microbatches of 1 x 4096), its depth cut to 8 of 36 layers so at least 10
GB of the card stay free, 1 step (cut from 2 for time) with weights from the
same dedup stage
over ``seq_keys`` (a replayed document dropped): finite loss and grad
norm, step ms, peak memory, device busy time and idle share. Then the
MoE LMs at their published widths, each batch cut from the trainer's
corpus (its sequences laid end to end, one row a replay of the previous
cut's) and weighted by that dedup stage (one hashmix launch per call,
counted): mixtral-8x7b's ``train_4k`` (sort dispatch, capacity factor
1.25, 4 microbatches of 1 x 4096) at 2 of 32 layers (3164688384
parameters, 50.6 GB of training state at 16 B each; 3 layers would hold
73.9 GB), 2 steps and a profiled third: finite loss and grad norm, at
least 10 GB of the card free, step ms beside its bf16 matmul bound, the
(token, slot) pairs dropped per layer and microbatch, device busy time
and idle share (its host ops not recorded, for time);
deepseek-v2-236b, whose whole AdamW step at a
routed depth (2 layers: 85.7 GB of training state) does not fit one
card, in two parts: at 2 layers (the dense first layer and one routed
layer) one microbatch of 4 x 4096 = 16384 tokens through ``forward`` and
autograd in bf16 with remat "full", no optimizer (the routed layer
routes in 2 groups of its ``moe_group_size`` 8192; the loss and every
gradient finite; ms beside its bf16 matmul bound, peak memory, grad
norm, the pairs dropped per group and a profiled one's device busy time
printed), and at 1 layer (its dense MLA layer, 1386562560 parameters) 2
whole ``LMArch.step("train_4k")`` steps at accumulation 8 (finite loss
and grad norm; ms, bound, peak memory and a profiled step's device busy
time printed).

Then the "mesh" phase: the model sharding (``repro_torch.launch.mesh``,
``distributed.sharding``, ``train.jit_sharded``) on the card. The
("data", "model") mesh of ``make_local_mesh()`` over the one-rank NCCL
group the "shard" phase brought up (kept until this phase ends; (1, 1)
on one card), the ``100m`` trainer's step at full width placed on it by
the registry's specs (``LMArch.param_specs`` / ``opt_specs``, the
transformer batch specs): 2 steps through ``jit_sharded`` and 2 of the
plain step from the same seeded state, fp32 with TF32 off, on batches
drawn from the "train" phase's corpus and weighted by its dedup stage
(one hashmix launch per call, counted). The losses and every parameter
after the 2 steps equal within 1e-5 of their max |value|; then one more
sharded step profiled (device busy, idle share) and one under
``launch.analysis.analyze_step`` (its collective counts, flops and
memory), and ``compressed_psum`` of the 100m gradients over the mesh's
"data" group equal bit for bit to the one-rank form of the reference's
formula (quantize, then dequantize), its error state finite. Last, on
this machine's CPU by design (the card is not used; its torch is the one
the checks are for), ``repro_torch.launch.meshcheck``'s six parts as
six processes at once: the (2, 2) gloo steps of the smoke configs
(qwen3-8b, qwen3-8b at accumulation 2, qwen3-8b with one KV head — its
queries regrouped —, mixtral-8x7b, deepseek-v2-236b routed in groups,
MeshGraphNet, DLRM-RM2) and the sequence-split decode, each sharded
within 1e-5 of its plain step's max |value| with no ``index_add`` /
``index_put`` passed on to DTensor's own dispatch; the fake-world traces
of molecule-meshgraphnet (multi), dlrm-rm2 train_batch (single) and
serve_p99 (multi), mixtral-8x7b long_500k (multi, its flops within 1%
of the same cell's on the single mesh, ``meshcheck.TRACE_SAME_FLOPS``),
and qwen3-8b's decode_32k, its flops within 1% of the count of its
shapes and its temp within 10% of ``MESH_DECODE_TEMP``; the smoke MoE
train steps on a fake (4, 1) mesh, their flops a 4x split of (1, 1)'s
within 2%; the GQA analogs (8 query heads, 2 KV heads) of mixtral-8x7b
and qwen3-8b on a fake (1, 4) mesh, their attention split 4x with
nothing of the queries gathered (``meshcheck.attention_sublayer_ok``)
and their steps' flops within 5% of the reference's plan; the
per-layer count of three smoke cells equal to their full-depth traces
(every additive term, temp within 5%); and the smoke head check
(qwen3-8b's smoke step at one layer, vocab 4096 and 512, on fake (1, 1),
(1, 4), (2, 2) and (4, 1) meshes: no mesh holds more than 1.1x the
copies of each rank's fp32 logits that one rank holds,
``meshcheck.head_temp_ok``).

Then the "graph_recsys" phase: GNN and recsys (``repro_torch.models.gnn``
and ``.recsys``), fp32 with TF32 off, weights from the port's seeded init.
First MeshGraphNet's and the four rankers' smoke configs on the card
against the CPU, two AdamW steps in lockstep (``model_card_vs_cpu``:
forward and loss within 1e-5 of the max |value|, each gradient within
1e-4 of its max |g|, each param after the step within 1e-5 of its max
|value| plus 1e-2 x the lr). Then MeshGraphNet at its published width (15
layers, d 128, remat "full"): minibatch_lg, 3 steps (and a profiled
fourth) on ``NeighborSampler`` samples (1024 seeds, fanout (15, 10), 602
features) of a host CSR graph of the reference's 232965 nodes and
114615892 edges, padded to 172032 nodes and edges (the real edge count
within 1% of 168960); full_graph_sm (2708 nodes, 10556 edges, 1433
features) and molecule (128 graphs of 30 nodes and 64 edges) one step
each. Then the four rankers at full width, one model on the card at a
time, at train_batch (B 65536; DLRM-RM2's 26 tables 12.07 GB, wide-deep's
40 9.24 GB, xDeepFM's 39 2.85 GB, DCN-v2's 26 3.02 GB): xDeepFM's bytes
reckoned before it runs from its CIN's shapes (``cin_reckon``: every
layer's (B, H, 39, 10) fp32 outer product saved, the largest one's
gradient and its product with a factor, 16 B a parameter, against the
card's memory); each other ranker, and xDeepFM where that fits, 4 AdamW
steps (DLRM; 3 for the others) and a profiled extra one, each batch a
``CTRStream`` draw (10% replayed
clicks) through ``DedupPipeline(paper_config("rlbsbf", 256,
batch_size=65536), mode="drop")`` keyed on the stream's ``key``, whose
weights are the loss weights: finite loss and grad norm, weights 0
exactly where ``dup``, FPR <= 0.01 and FNR <= 0.05 against the keys'
exact repeats, one hashmix launch per batch and hashmix at the path's
shape equal to its plain version; where xDeepFM's does not fit, the
reckoning is printed. Then each ranker's serve_p99 (B 512), serve_bulk
(B 262144; xDeepFM's reckoned first: two consecutive layers' outer
products at once over its params) and retrieval_cand (1 query x 10^6 candidates): finite logits, the top 100
equal to a stable descending sort of the card's own scores, and DLRM's
``dedup_gather`` equal to the plain gather within 1e-6 of the max
|logit|. Each cell prints its step or call ms, a profiled step's device
busy time, idle share and aten ops, its peak memory and its bound.

Then the "examples" phase: the port's eight examples
(``examples/*_torch.py``) through their ``main``, each on the card at the
reference's size — but quickstart's stream, cut from 2M to 2^19 records,
the serving example, cut from 6000 to 3000 requests and its per-request
loop to 128 synchronous calls, and the training example, cut from 200 to
20 steps, for the phase's time — with the hashmix, bitset-step and
counter-step launches
counted from 0 and held to each example's design (added to the kernels
line); then each at a cut size (2^16 records, its own size where
smaller, 16 training steps, the sharded one at one rank) on the card and
with ``--device cpu``: their checks (dups, flags, estimates, load
history, the trainer's dedup state) equal bit for bit, and the serving
example's recorded schedule replayed on the CPU to the card's digest.
Then ``python -m repro_torch.launch.hillclimb --overlap-worker`` once
on the card in a subprocess (the dedup-overlap sweep's baseline): exit 0
and a positive elems/s.

Then it times each kernel beside its bound and the card's latency floor
(an empty launch, and 1 - 3 dependent scattered loads per thread; each
kernel's time, scatter_delta's zero fill included, averaged over the
launches the profiler kept), and profiles a step of each engine and fleet
path and of the two dense8 steps (over 8 steps; 16 until the
"graph_recsys" phase came). Last the "lint" phase: the hot-path
linter (``repro_torch.analysis``) on the card — each kernel's registers,
spills and shared memory per block from its ``ptxas -v`` report, then
``run_lint(device="cuda")`` over the linter's whole entry matrix (each
step traced, and run again under ``set_sync_debug_mode("error")``) and
over one full-width step of the 256 MB rlbsbf and sbf plane paths and of
the two dense8 ``DedupPipeline`` paths, on the states those phases left;
a finding outside ``src/repro_torch/analysis/lint_baseline.json`` fails
it. Every phase fails the run; the last line of standard output is
``{"ok": true, "device": {...}}`` only when all of them passed. Without a
CUDA device, or without the ``src/repro_torch`` package beside this file,
it exits non-zero and prints no result.

    python3 chip_smoke.py --parent DIR

also builds an earlier design of hashmix, bloom_probe, the bitset step and
the counter step from ``DIR``'s ``hashmix.cu``, ``bloom_probe.cu``,
``bitset_step.cu`` and ``counter_step.cu`` (with ``DIR``'s own headers, if
it has any; the C interfaces of the commit before the seeds could come
from device memory) and times them against the current ones on the same
inputs, through the same wrappers, in turns (earlier, current, current,
earlier, twice over), the L2 flushed before each: the bitset and counter
steps for one filter and for the fleet, hashmix and fused_probe.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import dataclasses
import functools
import hashlib
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
MEMORY_MB = 256                  # the paper's 256 MB table (PAPER_MEMORIES_MB)
BATCH = 8192                     # DedupConfig.batch_size
STREAM_N = 3 << 21               # the paper's 695M-1B records, cut for time
OPS_N = 1 << 21                  # the ops path's prefix of the stream
FLEET_T = 32                     # tenants of a fleet path
FLEET_MB = 8                     # per tenant (PAPER_MEMORIES_MB[0])
FLEET_N = 1 << 21                # the fleet paths' prefix of the stream
DENSE8_N = 1 << 22               # the dense8 pipelines' prefix of the stream
CKPT_AT = DENSE8_N               # the plane paths' checkpoint record
RESUME_N = 1 << 21               # records a restored checkpoint continues over
SERVE_N = 1 << 16                # the serve phase's prefix of the stream
SERVE_CLIENTS = 256              # its closed-loop clients
SERVE_PROFILE_WIDTH = 256        # the micro-batch bucket it profiles
ORACLE_N = 512                   # keys of the sbf oracle on the card (cut
                                 # from 4096, then 1024, for time)
FLEET_CAPACITY = 512             # FleetDedup's default: ceil(2·8192 / 32)
DISTINCT_FRAC = 0.60             # the paper's 60% distinct (Section 6)
try:                             # the card's rates (main() reports a
    from repro_torch.launch.hw import HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_FP32
except ImportError:              # missing package)
    HBM_BW = PEAK_FLOPS_BF16 = PEAK_FLOPS_FP32 = None
PINNED_DIGESTS = {               # tests/test_sketch_template.py (reference)
    "bsbf": "4e3f72a324d1eb32",
    "bsbfsd": "9936da3ee28dfb25",
    "rlbsbf": "2fa66ecae9583e86",
    "rsbf": "6371d978a8821296",
    "sbf": "be5220c6e677d339",
    "sbf_d1": "b5702a4fbe9dc5c0",
    "swbf": "4580749bdb028080",
}
SHARD_N = 1 << 20                # the shard phase's rlbsbf cells' prefix
SHARD_SBF_N = 1 << 19            # its sbf cell's prefix
SHARD_BUCKETS = 32               # elastic buckets: 32 x 8 MB
SHARD_THRESHOLD = 1.25           # the elastic monitor's max / mean trigger
SHARD_PROFILE_BATCHES = 4        # batches of each shard cell's profile
PROFILE_STEPS = 8                # steps of each path's profile (16 until
                                 # the graph_recsys phase came)
# the reference's sharded verdicts at a small size, SHA-256 of the dup
# array under JAX's partitionable threefry layout; the elastic one on 4
# devices, which one rank must reproduce (elastic verdicts do not depend on
# the device count). tests/test_torch_rebalance.py recomputes them.
SHARD_DIGEST_CASES = {
    "static-rlbsbf-1dev": dict(
        devices=1, variant="rlbsbf", factor=2.0, stream="uniform",
        kw=dict(memory_bits=1 << 15, batch_size=512)),
    "elastic-swbf-4dev": dict(
        devices=4, variant="swbf", factor=8.0, stream="uniform",
        kw=dict(memory_bits=1 << 15, batch_size=512, window=3, packed=True,
                rebalance_buckets=8, rebalance_threshold=1.3)),
    "tenants-sbf-planes-2dev": dict(
        devices=2, variant="sbf", factor=64.0, stream="tenants",
        kw=dict(memory_bits=1 << 15, batch_size=64, k=4, layout="planes",
                n_tenants=8, rebalance_buckets=8, seed=11)),
}
SHARD_DIGESTS = {
    "static-rlbsbf-1dev":
        "f750f370ffe4189bbc51d87a2af6b72c84c85bc788c822dd5646c333b2475eab",
    "elastic-swbf-4dev":
        "a60304f4016c2d55e76bb6e57fb341bc0f02902c5e4061e0bf88e81887c40f1f",
    "tenants-sbf-planes-2dev":
        "954adf4b627fe14f6738e1a9d42d6545b3b45792d3c85af9e6f9646680019830",
}
# the "lm" phase: qwen3-8b at its published width (lm_archs.py), seeded
LM_ARCH = "qwen3-8b"
LM_PARAMS = 8_190_735_360        # the reference's param_count()
LM_PREFILL = (4, 256)            # B, S of the prefill the decode replays
LM_TEACHER = 64                  # positions teacher-forced through decode
LM_CPU = (2, 64)                 # B, S of the fp32 2-layer card-vs-CPU run
LM_REL_TOL = 0.02                # bf16: |diff| <= 2% of max |logit|
LM_FP32_TOL = 1e-3               # fp32 card vs CPU, relative to max |logit|
LM_SERVE_N = 1 << 11             # requests of the LM-scored front end
LM_CLIENTS = 64                  # its closed-loop clients
LM_RESCORE = 32                  # the batch the served values are rescored in
LM_SEQ_LEN = 16                  # the LM scorer's context, as the benchmark's
LM_MIN_WIDTH = 32                # the scorer's smallest padded miss-batch
LM_WIDTHS = (32, 64, 128, 256, 512, 1024)   # the scorer's padded widths
LM_DECODE_B = (8,)               # decode batches timed (64 cut for time)
LM_DECODE_SEQ = 1024             # their cache length
LM_DECODE_TOKENS = 64            # greedy tokens per batch (128 cut for time)
# the "moe" phase: mixtral-8x7b and deepseek-v2-236b at their published
# widths, bf16, seeded, depth cut (the reference's param_count() of each
# cut, of the full depth and its active_param_count())
MOE_ARCHS = {
    "mixtral-8x7b": dict(layers=16, params=23_482_470_400,
                         full=46_702_792_704, active=12_879_925_248,
                         fp32_layers=2, fp32_params=3_164_688_384),
    # its dense first layer and 7 MoE layers; fp32: the dense layer and 1
    "deepseek-v2-236b": dict(layers=8, params=29_191_377_920,
                             full=235_741_434_880, active=21_375_800_320,
                             fp32_layers=2, fp32_params=5_358_679_040),
}
MOE_PREFILL = (4, 256)           # B, S of the bf16 prefill
MOE_TEACHER = 32                 # its positions teacher-forced through decode
MOE_CPU = (2, 64)                # B, S of the fp32 2-layer checks
MOE_DISPATCH_T = 256             # tokens of the einsum-vs-sort check
MOE_DECODE = (8, 32, 1024)       # greedy decode: B, tokens, cache slots
MOE_SERVE_ARCH = "deepseek-v2-236b"
MOE_SERVE_N = 1 << 10            # requests of its LM-scored front end
MOE_CLIENTS = 16                 # its closed-loop clients
MOE_WARM = 64                    # requests of the untimed warm-up front end
# the "train" phase: dedup-gated LM training (repro_torch.launch.train)
TRAIN_PRESET = "100m"            # the reference's deployment training config
TRAIN_STEPS = 14                 # the reference test's schedule ...
TRAIN_FAULT_AT = 11              # ... and its injected fault
TRAIN_DUP_FRAC = 0.3
TRAIN_CPU = (4, 128)             # B, S of the fp32 2-layer card-vs-CPU steps
TRAIN_CPU_STEPS = 2
TRAIN_TOL = 1e-4                 # fp32 card vs CPU: loss, update (x lr)
TRAIN_REFEREE_FACTOR = 4         # card vs a float64 referee, x fp32 noise
TRAIN_FP64_TOL = 1e-8            # the float64 card vs the float64 referee
TRAIN_NOISE = 1e4                # an update is held where |g| > this x noise
QWEN_TRAIN_LAYERS = 8            # qwen3-8b train_4k: the depth cut (of 36)
QWEN_TRAIN = (4, 4096)           # its batch (4 microbatches of 1) and seq
QWEN_TRAIN_STEPS = 1             # (cut from 2 for the script's time)
FREE_BYTES = 10 * 10**9          # the card left free by the cut depth
STATE_BYTES = 16                 # training state per parameter: bf16 param
                                 # and gradient, fp32 accumulation, m and v
MIXTRAL_TRAIN_LAYERS = 2         # mixtral-8x7b train_4k: the depth cut (of 32)
MOE_TRAIN = (4, 4096)            # its batch (4 microbatches of 1) and seq
MOE_TRAIN_STEPS = 2              # its steps timed (one more profiled)
DEEPSEEK_GRAD = (2, 4, 4096)     # layers, B, S of deepseek's one-microbatch
                                 # backward: 16384 tokens, 2 groups of 8192
DEEPSEEK_STEP = (1, 8, 4096)     # layers, B (8 microbatches of 1), S of its
DEEPSEEK_STEPS = 2               # whole train_4k steps
MOE_LOCKSTEP = ("deepseek-v2-236b", 4, 40, 2)   # the MoE card-vs-CPU check:
                                 # smoke config, B, S (past its 32-wide
                                 # attention blocks), accumulation
# the "mesh" phase: the 100m step through jit_sharded on the (1, 1) mesh
MESH_STEPS = 2                   # steps of each form from one state
MESH_TOL = 1e-5                  # sharded vs plain, of max |value|
MESH_CHECK_TIMEOUT = 600         # s, each part of repro_torch.launch.meshcheck
MESH_CHECK_PARTS = ("steps", "traces", "moe", "attention", "depth",
                    "memory")
MESH_DECODE_TEMP = 69683264      # qwen3-8b decode_32k temp bytes per device
                                 # under torch 2.13 (PERF.md, section 6)
MESH_DECODE_TEMP_TOL = 0.10
# the "graph_recsys" phase: MeshGraphNet and the four recsys rankers at
# their published widths (gnn_archs.py, recsys_archs.py), fp32, seeded
GNN_ARCH = "meshgraphnet"
GNN_LG_STEPS = 3                 # minibatch_lg steps timed (one more profiled)
REC_ARCHS = ("wide-deep", "xdeepfm", "dlrm-rm2", "dcn-v2")
DLRM_ARCH = "dlrm-rm2"
REC_TRAIN = {"dlrm-rm2": 4, "wide-deep": 3, "xdeepfm": 3, "dcn-v2": 3}
                                 # train_batch steps timed (one more profiled)
CTR_DUP_FRAC = 0.1               # CTRStream's replayed (fraud) records
REC_SERVE_CALLS = 20             # calls per serving cell timed
GR_CPU_STEPS = 2                 # card-vs-CPU AdamW steps at smoke configs
GR_FWD_TOL = 1e-5                # card vs CPU: forward and loss, of max |v|
GR_GRAD_TOL = 1e-4               # card vs CPU: each gradient, of max |g|
GR_UPDATE_LR = 1e-2              # ... params after AdamW: + this x lr
GR_GATHER_TOL = 1e-6             # dedup_gather vs plain, of max |logit|
EXAMPLE_CUT = 1 << 16            # records of the card-vs-CPU example runs
EXAMPLE_QUICKSTART_N = 1 << 19   # quickstart's card run (2M cut for time)
EXAMPLE_SERVE_N = 3000           # serving_frontend's requests (6000 cut)
EXAMPLE_LOOP_N = 128             # its per-request loop (of all: 14 ms a
#                                  synchronous call on the card)
EXAMPLE_TRAIN_STEPS = 20         # dedup_training's card run (200 cut)
EXAMPLE_TRAIN_CUT = 16           # dedup_training's steps on both devices
OVERLAP_TIMEOUT = 300            # s, the hillclimb overlap worker
BITSET = ("rsbf", "bsbf", "bsbfsd", "rlbsbf")
COUNTER = ("sbf", "sbf_d1", "swbf", "cms", "hh")
# each step kernel's device kernels, as the profiler names them
BITSET_KERNELS = ("probe_decide", "apply_deletes", "apply_inserts")
COUNTER_KERNELS = ("counter_probe_partition", "counter_merge_apply")
# scatter_delta's call: the wrapper's zero fill of the (k, W) delta
# (PyTorch's fill kernel) and the scatter
SCATTER_KERNELS = ("FillFunctor<int>", "scatter_delta_kernel")
PARENT_SOURCES = ("hashmix", "bloom_probe", "bitset_step", "counter_step")


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def stamp(phase: str) -> None:
    """The seconds since the script started, at the end of a phase."""
    log(f"[elapsed] {phase} done at {time.perf_counter() - T0:.1f} s")


def config(name, mb=None, **kw):
    """The port's config for a variant name of the digest grid: the bitset
    variants and sbf on the plane layout, sbf_d1 = sbf at Max 1. With
    ``mb`` it is the paper's table of that many MB (``paper_config``),
    else ``DedupConfig.for_variant`` at ``kw``'s memory_bits."""
    from repro_torch.configs import paper_config
    from repro_torch.core import DedupConfig
    variant = "sbf" if name == "sbf_d1" else name
    if name in BITSET:
        kw["packed"] = True
    elif variant == "sbf":
        kw["layout"] = "planes"
        if name == "sbf_d1":
            kw["sbf_max"] = 1
    if mb is not None:
        return paper_config(variant, mb, **kw)
    return DedupConfig.for_variant(variant, **kw)


def abs_err(a, b) -> int:
    """Largest absolute difference of two tensors taken as uint32 values."""
    from repro_torch.core import u32
    return int((u32.to_u64(a) - u32.to_u64(b)).abs().max())


def step_inputs(cfg, state, keys, valid, partitionable=True):
    """The bitset step's operands for one batch as its plain version takes
    them (pos, rnd, valid, seen, i_t), the key the step leaves behind, and
    the keys, which the kernel takes in place of ``pos``."""
    import torch
    from repro_torch.core import batched, hashing, u32
    from repro_torch.kernels.hashmix import hashmix_plain
    dev = state.bits.device
    seeds = u32.from_numpy_u32(hashing.derive_seeds(cfg.seed, cfg.k), dev)
    kw = u32.from_numpy_u32(keys, dev)
    valid = torch.as_tensor(valid, device=dev)
    pos = hashmix_plain(kw, seeds, cfg.s)
    seen = batched.intra_batch_seen(kw, valid)
    i_t = state.position + torch.arange(len(keys), dtype=torch.int32,
                                        device=dev)
    rng, rnd = batched.draw_randomness(cfg, state.rng, len(keys),
                                       partitionable)
    return rng, (pos, rnd, valid, seen, i_t), kw


@functools.lru_cache(maxsize=None)
def host_seeds(cfg):
    """A config's probe and block seeds, as its steps hold them (on the
    host), made once."""
    from repro_torch.core import batched
    return batched._seeds(cfg)


def hashed(step_cfg, words, kw, args, load):
    """The bitset step on ``step_inputs``' operands, as the engine runs it:
    the kernel hashes ``kw`` itself (``args`` lose their positions)."""
    from repro_torch.kernels.fused_template import bitset_step
    seeds, bseeds = host_seeds(step_cfg)
    return bitset_step(step_cfg, words, kw, *args[1:], load, seeds=seeds,
                       block_seeds=bseeds)


def random_state(cfg, rng, position: int):
    """A filter at ~50% density with its exact load, handed to the port
    through ``state_from_numpy`` at stream ``position``."""
    import torch
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import packed
    words = rng.integers(0, 2 ** 32, (cfg.k, cfg.s_words), dtype=np.uint32)
    tail = cfg.s - 32 * (cfg.s_words - 1)        # bits past s stay clear
    if tail < 32:
        words[:, -1] &= np.uint32((1 << tail) - 1)
    load = packed.popcount(torch.from_numpy(words.view(np.int32)).cuda())
    leaves = {"bits": words, "position": np.int32(position),
              "load": load.cpu().numpy(),
              "rng": np.array([0, cfg.seed], np.uint32)}
    return state_from_numpy(leaves, cfg, "cuda")


def random_counter_state(cfg, rng, position: int):
    """A counter state with random cells, half of them zero, its exact
    nonzero-cell load, and for swbf a ring of random sorted slots, handed
    to the port through ``state_from_numpy`` at stream ``position``. Every
    d-bit value is a valid cell: the grid's caps are all 2^d - 1."""
    import torch
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import packed, u32
    d, w = cfg.n_planes, cfg.s_words
    planes = rng.integers(0, 2 ** 32, (d, w), dtype=np.uint32)
    planes &= rng.integers(0, 2 ** 32, w, dtype=np.uint32)[None]
    tail = cfg.s - 32 * (w - 1)                  # cells past s stay zero
    if tail < 32:
        planes[:, -1] &= np.uint32((1 << tail) - 1)
    nz = packed.planes_nonzero(u32.from_numpy_u32(planes, "cuda"))
    leaves = {"bits": planes[:, None, :] if d > 1 else planes,
              "position": np.int32(position),
              "load": packed.popcount(nz[None]).cpu().numpy(),
              "rng": np.array([0, cfg.seed], np.uint32)}
    if cfg.variant == "swbf":
        e = cfg.batch_size * cfg.k
        ev = rng.integers(0, cfg.s, (cfg.window, e))
        ev[rng.random((cfg.window, e)) < 0.3] = 32 * w
        leaves["ring_events"] = np.sort(ev, axis=1).astype(np.int32)
        leaves["ring_slot"] = np.int32(3)
    del planes, nz
    torch.cuda.empty_cache()
    return state_from_numpy(leaves, cfg, "cuda")


def counter_inputs(cfg, spec, state, keys, valid):
    """What the engine's counter step hands the kernel for one batch (the
    events with their delta planes, which only the plain version reads),
    and the key the step leaves behind."""
    import torch
    from repro_torch.core import batched, hashing, u32
    dev = state.bits.device
    seeds, _ = host_seeds(cfg)
    kw = u32.from_numpy_u32(keys, dev)
    v = torch.as_tensor(valid, device=dev)
    pos = hashing.hash_positions(kw, seeds, cfg.s)
    seen = batched.intra_batch_seen(kw, v) if spec.uses_seen else None
    rng, rnd = (spec.draw(cfg, state.rng, len(keys)) if spec.draw
                else (state.rng, None))
    ev = spec.make_events(cfg)(state, pos, v, rnd)
    return rng, (pos, v, seen, state.load, ev)


def phase_counter(rng):
    """The counter step against its plain version for the five counter
    configs at 256 MB (sbf_d1 at 128 MB), both values of
    ``kernel_accumulate``, over a repeated-key, a ragged and a fresh batch
    each."""
    import dataclasses
    import torch
    from repro_torch.core import batched, packed
    from repro_torch.core.sketch import get_spec
    from repro_torch.kernels.fused_template import (counter_step,
                                                    counter_step_plain)
    worst = 0
    valid_all = np.ones(BATCH, bool)
    ragged = np.arange(BATCH) < 5000
    for name in COUNTER:
        # sbf at Max 1 has one plane: 256 MB would be 2^31 cells, whose
        # sentinel 32·W = 2^31 overflows int32 (in the reference too), so it
        # runs at 128 MB
        mb = MEMORY_MB // 2 if name == "sbf_d1" else MEMORY_MB
        base = config(name, mb, batch_size=BATCH)
        spec = get_spec(base.variant)
        start = random_counter_state(base, rng, 5000)
        batches = [
            ("repeated keys", rng.integers(0, 300, BATCH), valid_all),
            ("ragged valid", rng.integers(0, 2 ** 32, BATCH), ragged),
            ("fresh keys", rng.integers(0, 2 ** 32, BATCH), valid_all),
        ]
        for accumulate in (False, True):
            cfg = dataclasses.replace(base, kernel_accumulate=accumulate)
            state = start
            for label, keys, valid in batches:
                rng_next, args = counter_inputs(cfg, spec, state,
                                                keys.astype(np.uint32), valid)
                pos, v, seen, load_in, ev = args
                planes = batched.sbf_planes_3d(state.bits)[:, 0, :]
                got = planes.clone()
                dup, load = counter_step(cfg, spec, got, *args)
                new, dup_p, load_p = counter_step_plain(cfg, spec, planes,
                                                        *args)
                torch.cuda.synchronize()
                diff = (got != new).sum().item()
                worst = max(worst, abs_err(got, new), abs_err(dup, dup_p),
                            abs_err(load, load_p))
                nz = packed.popcount(packed.planes_nonzero(got)[None])
                ok = (diff == 0 and torch.equal(dup, dup_p)
                      and torch.equal(load, load_p) and torch.equal(load, nz))
                log(f"[counter] {name} d={cfg.n_planes} k={cfg.k} "
                    f"s={cfg.s} accumulate={accumulate} {label}: "
                    f"dup={int(dup.sum())} load={load.tolist()} words "
                    f"differing={diff} -> "
                    f"{'exactly equal' if ok else 'MISMATCH'}")
                if not ok:
                    raise AssertionError(f"counter step != plain: {name} "
                                         f"accumulate={accumulate} {label}")
                ring = (batched.ring_push(state.ring, ev.ring_payload,
                                          cfg.window)
                        if ev.ring_payload is not None else state.ring)
                state = state._replace(
                    bits=got[:, None, :] if got.shape[0] > 1 else got,
                    load=load, rng=rng_next, ring=ring,
                    position=state.position + int(v.sum()))
                del planes, new, ev, args
        del start, state, got
        torch.cuda.empty_cache()
    return worst


def phase_ops(rng):
    """bloom_probe, scatter_delta (OR and AND-NOT; disabled lanes as -1
    and as >= W) and fused_probe against their plain versions at k = 2,
    W = 2^25, B = 8192; -> the largest differences (probe, scatter,
    fused_probe)."""
    import torch
    from repro_torch.core import hashing, packed, u32
    from repro_torch.kernels import ops
    from repro_torch.kernels.bloom_probe import (bloom_probe_plain,
                                                 fused_probe_plain)
    from repro_torch.kernels.hashmix import hashmix_plain
    from repro_torch.kernels.scatter_delta import scatter_delta_plain
    k, w = 2, 1 << 25
    words = u32.from_numpy_u32(rng.integers(0, 2 ** 32, (k, w),
                                            dtype=np.uint32), "cuda")
    idx = torch.from_numpy(rng.integers(0, w, (BATCH, k)).astype(np.int32)
                           ).cuda()
    mask = u32.to_i32(1 << torch.from_numpy(rng.integers(0, 32, (BATCH, k)))
                      .cuda())
    hits = ops.probe(words, idx, mask)
    want = bloom_probe_plain(words, idx, mask)
    torch.cuda.synchronize()
    probe_err, scatter_err = abs_err(hits, want), 0
    if not torch.equal(hits, want):
        raise AssertionError("bloom_probe != plain")
    log(f"[ops] bloom_probe k={k} W={w} B={BATCH}: hits={int(hits.sum())}, "
        f"exactly equal to the plain version")
    # fused_probe on the same filter, its keys half of them planted: a
    # probed key's bits set in both rows
    seeds = u32.from_numpy_u32(hashing.derive_seeds(SEED, k), "cpu")
    s = 32 * w
    keys = u32.from_numpy_u32(rng.integers(0, 2 ** 32, BATCH,
                                           dtype=np.uint64), "cuda")
    pw, pm = packed.split_pos(hashmix_plain(keys[:BATCH // 2],
                                            seeds.cuda(), s))
    fwords = ops.scatter_or(words, pw, pm)
    got = ops.fused_probe(keys, fwords, seeds, s)
    want = fused_probe_plain(keys, fwords, seeds.cuda(), s)
    torch.cuda.synchronize()
    fused_err = max(abs_err(x, y) for x, y in zip(got, want))
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError("fused_probe != plain chain")
    log(f"[ops] fused_probe k={k} s={s} B={BATCH}: dup={int(got[0].sum())} "
        f"(the first {BATCH // 2} keys planted), exactly equal to the "
        f"plain chain (hashmix, split, bloom_probe, AND)")
    off = torch.from_numpy(rng.random((BATCH, k)) < 0.2).cuda()
    for disabled in (-1, w, w + 12345):
        di = torch.where(off, disabled, idx).to(torch.int32).contiguous()
        delta = scatter_delta_plain(di, mask, w)
        got_or = ops.scatter_or(words, di, mask)
        got_andnot = ops.scatter_andnot(words, di, mask)
        torch.cuda.synchronize()
        scatter_err = max(scatter_err, abs_err(got_or, words | delta),
                          abs_err(got_andnot, words & ~delta))
        if not (torch.equal(got_or, words | delta)
                and torch.equal(got_andnot, words & ~delta)):
            raise AssertionError(f"scatter_delta != plain, disabled lanes "
                                 f"{disabled}")
        log(f"[ops] scatter_or / scatter_andnot k={k} W={w} B={BATCH}, "
            f"disabled lanes as {disabled}: "
            f"{int((got_or != words).sum())} / "
            f"{int((got_andnot != words).sum())} words changed, exactly "
            f"equal to the plain version")
    return probe_err, scatter_err, fused_err


def phase_hashmix(rng):
    """hashmix against its plain version at B = 8192: the sbf path's k and
    s at 256 MB (the shape that path feeds it), rlbsbf's and rsbf's (mask
    and mod), k = 4 and 8, and the blocked layout in one launch against the
    formula of two plain calls."""
    import torch
    from repro_torch.core import DedupConfig, hashing, u32
    from repro_torch.kernels.hashmix import (hashmix, hashmix_plain,
                                             positions_plain)
    worst = 0
    keys = u32.from_numpy_u32(
        rng.integers(0, 2 ** 32, BATCH, dtype=np.uint64), "cuda")
    sbf_cfg = config("sbf", MEMORY_MB)
    cases = [(sbf_cfg.k, sbf_cfg.s, sbf_cfg.block_bits)]
    for variant in ("rlbsbf", "rsbf"):
        cfg = config(variant, MEMORY_MB)
        cases.append((cfg.k, cfg.s, 0))
    # past 32 rows the seeds come from device memory
    cases += [(4, 1 << 30, 0), (8, 715827882, 0), (3, 1 << 30, 9),
              (2, 715827882, 5), (33, 1 << 30, 0), (64, 715827882, 9)]
    for k, s, block_bits in cases:
        seeds = u32.from_numpy_u32(hashing.derive_seeds(SEED, k, 0), "cpu")
        bseeds = u32.from_numpy_u32(hashing.derive_seeds(SEED, k, 1), "cpu")
        before = hashmix.launches
        got = hashmix(keys, seeds, s=s, block_bits=block_bits,
                      block_seeds=bseeds)
        if hashmix.launches != before + 1:
            raise AssertionError("hashmix: expected one launch per call")
        if block_bits:
            bsize = 1 << block_bits
            want = u32.to_i32(
                hashmix_plain(keys, bseeds.cuda(), max(1, s // bsize)).long()
                * bsize + hashmix_plain(keys, seeds.cuda(), bsize))
        else:
            want = hashmix_plain(keys, seeds.cuda(), s)
        torch.cuda.synchronize()
        worst = max(worst, abs_err(got, want))
        if not (torch.equal(got, want) and torch.equal(
                want, positions_plain(keys, seeds.cuda(), s, block_bits,
                                      bseeds.cuda()))):
            raise AssertionError(f"hashmix != plain for k={k} s={s} "
                                 f"block_bits={block_bits}")
        layout = (f"blocked, 2^{block_bits}-bit blocks" if block_bits else
                  "mask" if s & (s - 1) == 0 else "mod")
        log(f"[hashmix] k={k} s={s} ({layout}) B={BATCH}: one launch, "
            f"exactly equal to the plain version")
    return worst


def phase_bitset(rng):
    """The bitset step, hashing its keys in the kernel, against the plain
    hashmix feeding its plain version, for the four variants at 256 MB
    over a repeated-key, a ragged and a fresh batch each."""
    import torch
    from repro_torch.core import packed
    from repro_torch.kernels.fused_template import bitset_step_plain
    worst = 0
    for variant in BITSET:
        cfg = config(variant, MEMORY_MB)
        # position s - 4000 puts rsbf's phase-1 -> phase-2 boundary inside
        # the batches
        state = random_state(cfg, rng, cfg.s - 4000)
        valid_all = np.ones(BATCH, bool)
        ragged = np.arange(BATCH) < 5000
        batches = [
            ("repeated keys", rng.integers(0, 300, BATCH), valid_all),
            ("ragged valid", rng.integers(0, 2 ** 32, BATCH), ragged),
            ("fresh keys", rng.integers(0, 2 ** 32, BATCH), valid_all),
        ]
        for label, keys, valid in batches:
            keys = keys.astype(np.uint32)
            rng_next, args, kw = step_inputs(cfg, state, keys, valid)
            pos, rnd, v, seen, i_t = args
            words = state.bits.clone()
            dup, ins, load = hashed(cfg, words, kw, args, state.load)
            new, dup_p, ins_p, load_p = bitset_step_plain(
                cfg, state.bits, pos, rnd, v, seen, i_t, state.load)
            torch.cuda.synchronize()
            diff = (words != new).sum().item()
            worst = max(worst, abs_err(words, new), abs_err(dup, dup_p),
                        abs_err(ins, ins_p), abs_err(load, load_p))
            ok = (diff == 0 and torch.equal(dup, dup_p)
                  and torch.equal(ins, ins_p) and torch.equal(load, load_p)
                  and torch.equal(load, packed.popcount(words)))
            n_ins = int(ins.sum())
            log(f"[bitset] {variant} k={cfg.k} s={cfg.s} {label}: "
                f"dup={int(dup.sum())} inserted={n_ins} "
                f"load={load.tolist()} words differing={diff}; hashed in "
                f"the kernel -> {'exactly equal' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"bitset step != plain: {variant} "
                                     f"{label}")
            n_valid = int(v.sum())
            state = state._replace(bits=words, load=load, rng=rng_next,
                                   position=state.position + n_valid)
        del state, words, new
        torch.cuda.empty_cache()
    return worst


def phase_digests():
    from repro_torch.convert import state_to_numpy
    from repro_torch.core import Dedup
    for name, want in PINNED_DIGESTS.items():
        cfg = config(name, memory_bits=1 << 14, batch_size=256,
                     **({"window": 4} if name == "swbf" else {}))
        # the digests were captured under JAX's original threefry layout
        eng = Dedup(cfg, "cuda", partitionable=False)
        state = eng.init()
        keys = np.random.RandomState(7).randint(0, 400, size=1024) \
            .astype(np.uint32)
        b = cfg.batch_size
        h = hashlib.sha256()
        for i in range(0, len(keys), b):
            valid = np.ones((b,), bool)
            if i + b >= len(keys):
                valid[b // 2:] = False
            state, res = eng.process(state, keys[i:i + b], valid)
            h.update(res.dup.cpu().numpy().tobytes())
            h.update(res.inserted.cpu().numpy().tobytes())
        leaves = state_to_numpy(state)
        for key in ("bits", "load", "position", "rng", "ring_events",
                    "ring_slot"):
            if key in leaves:
                h.update(leaves[key].tobytes())
        got = h.hexdigest()[:16]
        log(f"[digest] {name}: {got} (pinned {want})")
        if got != want:
            raise AssertionError(f"pinned digest mismatch for {name}")


def shard_digest_inputs(case):
    """A digest case's keys (uint32) and tenant ids (None off the tenant
    stream), made with numpy from a fixed seed: uniform cases draw 4096
    keys from a universe of 1024 spread over uint32 (range buckets
    balanced), the tenant case 512 (key, tenant) pairs whose second half
    replays the first."""
    rng = np.random.default_rng(7)
    if case["stream"] == "tenants":
        keys = rng.integers(0, 1 << 20, 512).astype(np.uint32)
        tens = rng.integers(0, 8, 512).astype(np.int32)
        keys[256:], tens[256:] = keys[:256], tens[:256]
        return keys, tens
    universe = rng.integers(0, 1 << 32, 1024, dtype=np.uint64)
    return universe[rng.integers(0, 1024, 4096)].astype(np.uint32), None


def shard_digest(case, device):
    """The port's verdict digest of a digest case, at the current process
    group's size: (SHA-256 of the dup array, overflow)."""
    from repro_torch.core import DedupConfig
    from repro_torch.dedup import ShardedDedup, ShardedDedupConfig
    cfg = DedupConfig.for_variant(case["variant"], **case["kw"])
    sd = ShardedDedup(ShardedDedupConfig(base=cfg,
                                         capacity_factor=case["factor"]),
                      device=device, partitionable=True)
    keys, tens = shard_digest_inputs(case)
    state = sd.init(cfg.seed)
    if tens is None:
        state, dup, ovf = sd.run_stream(state, keys)
    else:
        state, dup, ovf = sd.run_tenant_stream(state, keys, tens)
    return (hashlib.sha256(dup.cpu().numpy().tobytes()).hexdigest(),
            int(ovf.sum()))


def make_stream():
    """The STREAM_N-record stream every path reads, made once on the
    host."""
    from repro_torch.data.streams import controlled_distinct_stream
    t0 = time.perf_counter()
    keys, truth = controlled_distinct_stream(STREAM_N, DISTINCT_FRAC,
                                             seed=SEED)
    log(f"[stream] {STREAM_N} records ({DISTINCT_FRAC:.0%} distinct) made in "
        f"{time.perf_counter() - t0:.1f} s on the host")
    return keys, truth


def run_with_checkpoint(tag, eng, state, keys, ckpt_dir):
    """``eng.run_stream`` over ``keys`` as one run in three legs, cut at
    CKPT_AT and CKPT_AT + RESUME_N (batch boundaries, so the legs step as
    the whole stream does): at the first cut the state is saved with the
    port's ``CheckpointManager`` (``layout_meta`` stamped) under
    ``ckpt_dir/tag``, at the second a copy of it is kept. Neither is inside
    the timed legs. -> (state, dup (N,), seconds of the legs, the copy)"""
    import torch
    from repro_torch.checkpoint import CheckpointManager, layout_meta
    cuts = (0, CKPT_AT, CKPT_AT + RESUME_N, len(keys))
    dups, secs, copy = [], 0.0, None
    for leg, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
        t0 = time.perf_counter()
        state, dup = eng.run_stream(state, keys[lo:hi])
        torch.cuda.synchronize()
        secs += time.perf_counter() - t0
        dups.append(dup)
        if leg == 0:
            t0 = time.perf_counter()
            path = CheckpointManager(os.path.join(ckpt_dir, tag)).save(
                CKPT_AT, {"filter": state}, extra_meta=layout_meta(eng.cfg))
            nbytes = os.path.getsize(os.path.join(path, "arrays.npz"))
            log(f"[checkpoint] {tag}: saved the live state at record "
                f"{CKPT_AT} ({nbytes} bytes of npz) in "
                f"{time.perf_counter() - t0:.3f} s (host clock)")
        elif leg == 1:
            copy = type(state)(*(x.clone() for x in state))
    return state, torch.cat(dups), secs, copy


def check_resume(tag, cfg, keys, live_dup, live_copy, ckpt_dir, want):
    """The checkpoint of ``run_with_checkpoint`` restored into a fresh
    ``Dedup``'s ``init()`` on the card and continued over the RESUME_N
    records after CKPT_AT: its reports must equal the live run's there and
    its leaves the live run's copy, bit for bit; its launches must be
    ``want`` per step."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import Dedup
    from repro_torch.kernels.fused_template import bitset_step, counter_step
    from repro_torch.kernels.hashmix import hashmix
    counters = (hashmix, bitset_step, counter_step)
    eng = Dedup(cfg)
    mgr = CheckpointManager(os.path.join(ckpt_dir, tag))
    meta = mgr.load_meta(CKPT_AT)
    template = {"filter": eng.init()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = mgr.restore(CKPT_AT, template)["filter"]
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    on_card = all(x.device.type == "cuda" for x in state)
    for c in counters:
        c.launches = 0
    state, dup = eng.run_stream(state, keys[CKPT_AT:CKPT_AT + RESUME_N])
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    n_steps = RESUME_N // BATCH
    same = {"dups": torch.equal(dup, live_dup[CKPT_AT:CKPT_AT + RESUME_N]),
            **{f: torch.equal(a, b) for f, a, b in zip(
                ("bits", "position", "load", "rng"), state, live_copy)}}
    log(f"[checkpoint] {tag}: restored (layout {meta['filter_layout']}) "
        f"into a fresh engine's init() on the card in {t_restore:.3f} s "
        f"(host clock); leaves on the card: {on_card}; continued over "
        f"records {CKPT_AT} - {CKPT_AT + RESUME_N}: equal to the live run: "
        f"{same}; kernel launches {launches}")
    if not (all(same.values()) and on_card
            and meta["filter_layout"] == cfg.effective_layout):
        raise AssertionError(f"{tag}: the resumed checkpoint differs from "
                             f"the live run")
    expect = {c.__name__: n_steps * want.get(c.__name__, 0)
              for c in counters}
    if launches != expect:
        raise AssertionError(f"{tag} resume: expected launches {expect}, "
                             f"got {launches}")


def phase_main_path(keys, truth, ckpt_dir):
    import torch
    from repro_torch.core import Dedup, packed
    from repro_torch.dedup.metrics import fpr_fnr
    from repro_torch.kernels.fused_template import bitset_step
    from repro_torch.kernels.hashmix import hashmix
    cfg = config("rlbsbf", MEMORY_MB, batch_size=BATCH)
    eng = Dedup(cfg)
    state = eng.init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hashmix.launches = 0
    bitset_step.launches = 0
    state, dup, secs, live_copy = run_with_checkpoint("rlbsbf", eng, state,
                                                      keys, ckpt_dir)
    launches = {"hashmix": hashmix.launches,
                "bitset_step": bitset_step.launches}
    peak = torch.cuda.max_memory_allocated()
    fpr, fnr = fpr_fnr(dup, truth)
    load = state.load.tolist()
    exact = torch.equal(state.load, packed.popcount(state.bits))
    log(f"[main] rlbsbf 256 MB k={cfg.k} s={cfg.s} batch={BATCH}: "
        f"{STREAM_N} elements in {secs:.4f} s = {STREAM_N / secs:.1f} "
        f"elements/s (host clock, ends in synchronize)")
    log(f"[main] FPR={fpr:.6g} FNR={fnr:.6g} load={load} "
        f"(fraction {sum(load) / (cfg.k * cfg.s):.6g}) "
        f"position={int(state.position)} load==popcount: {exact}")
    log(f"[main] kernel launches: {launches}; peak memory allocated "
        f"{peak / 2 ** 20:.1f} MiB")
    if not (dup.shape == (STREAM_N,) and exact
            and int(state.position) == STREAM_N + 1
            and 0.0 <= fpr < 0.05 and 0.0 <= fnr < 0.5):
        raise AssertionError("main path result out of bounds")
    # the bitset kernel hashes its keys itself: one launch per step, and
    # no hashmix
    n_steps = -(-STREAM_N // BATCH)
    if launches != {"hashmix": 0, "bitset_step": n_steps}:
        raise AssertionError(f"main path: expected no hashmix and one "
                             f"bitset_step per step ({n_steps}), got "
                             f"{launches}")
    check_resume("rlbsbf", cfg, keys, dup, live_copy, ckpt_dir,
                 {"bitset_step": 1})
    return cfg, state, launches, dup[:DENSE8_N].clone()


def phase_sbf_path(keys, truth, ckpt_dir):
    """sbf, the paper's baseline, on the 256 MB table over the same stream;
    its checkpoint at record CKPT_AT resumed as ``check_resume`` says; then
    the counter read-outs on its final state."""
    import torch
    from repro_torch.core import Dedup, packed
    from repro_torch.dedup.metrics import fpr_fnr
    from repro_torch.kernels.fused_template import counter_step
    from repro_torch.kernels.hashmix import hashmix
    cfg = config("sbf", MEMORY_MB, batch_size=BATCH)
    eng = Dedup(cfg)
    state = eng.init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hashmix.launches = 0
    counter_step.launches = 0
    state, dup, secs, live_copy = run_with_checkpoint("sbf", eng, state,
                                                      keys, ckpt_dir)
    launches = {"hashmix": hashmix.launches,
                "counter_step": counter_step.launches}
    peak = torch.cuda.max_memory_allocated()
    fpr, fnr = fpr_fnr(dup, truth)
    nz = packed.popcount(packed.planes_nonzero(state.bits[:, 0, :])[None])
    exact = torch.equal(state.load, nz)
    load = int(state.load[0])
    log(f"[sbf] sbf 256 MB k={cfg.k} Max={cfg.sbf_max} "
        f"P={cfg.sbf_p_effective} d={cfg.n_planes} s={cfg.s} cells "
        f"batch={BATCH}: {STREAM_N} elements in {secs:.4f} s = "
        f"{STREAM_N / secs:.1f} elements/s (host clock, ends in "
        f"synchronize)")
    log(f"[sbf] FPR={fpr:.6g} FNR={fnr:.6g} load={load} nonzero cells "
        f"(fraction {load / cfg.s:.6g}) position={int(state.position)} "
        f"load==nonzero popcount: {exact}")
    log(f"[sbf] kernel launches: {launches}; peak memory allocated "
        f"{peak / 2 ** 20:.1f} MiB")
    if not (dup.shape == (STREAM_N,) and exact
            and int(state.position) == STREAM_N + 1
            and 0.0 <= fpr < 0.05 and 0.0 <= fnr < 0.5):
        raise AssertionError("sbf path result out of bounds")
    n_steps = -(-STREAM_N // BATCH)
    if launches != {"hashmix": n_steps, "counter_step": n_steps}:
        raise AssertionError(f"sbf path: expected one hashmix and one "
                             f"counter_step per step ({n_steps}), got "
                             f"{launches}")
    check_resume("sbf", cfg, keys, dup, live_copy, ckpt_dir,
                 {"hashmix": 1, "counter_step": 1})
    est = eng.estimate(state, keys[-BATCH:])
    cells, counts = eng.top_cells(state, 16)
    torch.cuda.synchronize()
    hist = torch.bincount(est.long(), minlength=cfg.sbf_max + 1).tolist()
    log(f"[sbf] estimate over the stream's last {BATCH} keys: counts of "
        f"values 0..{cfg.sbf_max} = {hist}")
    log(f"[sbf] top_cells(16): cells={cells.tolist()} "
        f"counts={counts.tolist()}; peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB")
    if not (est.shape == (BATCH,) and int(est.max()) <= cfg.sbf_max
            and int(counts[0]) == cfg.sbf_max
            and bool((counts[:-1] >= counts[1:]).all())):
        raise AssertionError("sbf read-outs out of bounds")
    return cfg, state, launches, dup[:DENSE8_N].clone()


def phase_ops_path(keys, truth):
    """A classic Bloom filter through ``kernels/ops.py``, as a user of
    those entry points builds one: k = 2 rows of 2^30 bits (the rlbsbf
    table's shape), each batch probed with ``fused_probe`` (one launch)
    and its unreported keys set with ``scatter_or`` (-1 disables a lane).
    Afterwards every key of the prefix must probe present, checked with
    ``hash_positions`` and ``probe`` (hashmix and bloom_probe): a Bloom
    filter has no false negatives for what it holds."""
    import torch
    from repro_torch.core import hashing, packed, u32
    from repro_torch.dedup.metrics import fpr_fnr, truth_from_stream
    from repro_torch.kernels import ops
    from repro_torch.kernels.bloom_probe import bloom_probe, fused_probe
    from repro_torch.kernels.hashmix import hashmix
    from repro_torch.kernels.scatter_delta import scatter_delta
    cfg = config("rlbsbf", MEMORY_MB)
    seeds = u32.from_numpy_u32(hashing.derive_seeds(cfg.seed, cfg.k), "cpu")
    kw = u32.from_numpy_u32(keys[:OPS_N], "cuda")
    words = torch.zeros((cfg.k, cfg.s_words), dtype=torch.int32,
                        device="cuda")
    dups = torch.empty((OPS_N,), dtype=torch.bool, device="cuda")
    counters = (fused_probe, scatter_delta, hashmix, bloom_probe)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    for i in range(0, OPS_N, BATCH):
        dup, _, pos = ops.fused_probe(kw[i:i + BATCH], words, seeds, cfg.s)
        w_idx, mask = packed.split_pos(pos)
        w_idx = torch.where(dup[:, None], -1, w_idx).to(torch.int32)
        words = ops.scatter_or(words, w_idx.contiguous(), mask)
        dups[i:i + BATCH] = dup
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    held = torch.ones((), dtype=torch.bool, device="cuda")
    for i in range(0, OPS_N, BATCH):
        w_idx, mask = packed.split_pos(ops.hash_positions(
            kw[i:i + BATCH], seeds, cfg.s))
        held &= (ops.probe(words, w_idx, mask) == 1).all()
    held = bool(held)
    launches = {c.__name__: c.launches for c in counters}
    fpr, fnr = fpr_fnr(dups, truth_from_stream(keys[:OPS_N]))
    log(f"[ops path] Bloom filter k={cfg.k} s={cfg.s} batch={BATCH} over "
        f"{OPS_N} records: {OPS_N / secs:.1f} elements/s (host clock); "
        f"FPR={fpr:.6g} FNR={fnr:.6g} (a key repeated inside its own batch "
        f"is not caught: both copies probe before the insert); set bits "
        f"{packed.popcount(words).tolist()}; every key held afterwards: "
        f"{held}; kernel launches: {launches}")
    if not (held and 0.0 <= fpr < 0.05):
        raise AssertionError("ops path result out of bounds")
    n_batches = OPS_N // BATCH
    if launches != dict.fromkeys(launches, n_batches):
        raise AssertionError(f"ops path: expected one launch of each kernel "
                             f"per batch ({n_batches}), got {launches}")
    return launches


def phase_dense8(keys, truth, planes_dups, ckpt_dir):
    """The reference's default path on the card: ``DedupPipeline`` over
    ``paper_config(v, 256)`` with the config's default layout, which is
    dense8 (one byte per bit, per cell for sbf), for rlbsbf (k = 2, a (2,
    2^30) uint8 state, 2 GiB) and sbf (k = 3, Max 3, P = 13, 2^30 cells, 1
    GiB), batch 8192, over the stream's first DENSE8_N records: the FPR
    and FNR of ``StreamMetrics.summary()`` under the other paths' sanity
    bounds; exactly one hashmix launch per step and no step kernel; the
    dup reports equal to the plane paths' on the same prefix, bit for bit
    (the reference makes both layouts bit-identical); the load equal to a
    recount; the final state migrated to the plane layout on the card
    (``migrate_filter_state``, dense8 -> planes) equal leaf for leaf to the
    plane path's checkpoint at the same record (CKPT_AT = DENSE8_N). Then the oracle on the card: ``run_stream_oracle`` for sbf at
    the 256 MB table over ORACLE_N keys, equal to the batch-size-1 engine in
    reports, cells, load, position and key. -> {variant: (cfg, pipeline
    holding its final state)}."""
    import torch
    from repro_torch.checkpoint import CheckpointManager, migrate_filter_state
    from repro_torch.configs import paper_config
    from repro_torch.core import Dedup, state_memory_bytes
    from repro_torch.dedup import DedupPipeline
    from repro_torch.kernels.fused_template import bitset_step, counter_step
    from repro_torch.kernels.hashmix import hashmix
    counters = (hashmix, bitset_step, counter_step)
    kw = torch.from_numpy(keys[:DENSE8_N].view(np.int32)).cuda()
    tw = torch.from_numpy(truth[:DENSE8_N]).cuda()
    n_steps = -(-DENSE8_N // BATCH)
    out = {}
    for variant in ("rlbsbf", "sbf"):
        cfg = paper_config(variant, MEMORY_MB, batch_size=BATCH)
        if cfg.effective_layout != "dense8":
            raise AssertionError(f"{variant}'s default layout is "
                                 f"{cfg.effective_layout}, not dense8")
        pipe = DedupPipeline(cfg, mode="flag")
        nbytes = state_memory_bytes(pipe.state)
        dups = torch.empty((DENSE8_N,), dtype=torch.bool, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        for i in range(0, DENSE8_N, BATCH):
            dups[i:i + BATCH] = pipe.process({"key": kw[i:i + BATCH]},
                                             tw[i:i + BATCH]).dup
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        summary = pipe.metrics.summary()
        st = pipe.state
        recount = (st.bits > 0).sum(dim=-1, dtype=torch.int32)
        exact = torch.equal(st.load, recount)
        same = torch.equal(dups, planes_dups[variant])
        log(f"[dense8] {variant} 256 MB paper_config (layout "
            f"{cfg.effective_layout}) k={cfg.k} s={cfg.s} batch={BATCH} "
            f"through DedupPipeline: {DENSE8_N} elements in {secs:.4f} s = "
            f"{DENSE8_N / secs:.1f} elements/s (host clock, ends in "
            f"synchronize); state {nbytes} bytes "
            f"({tuple(st.bits.shape)} {st.bits.dtype}); peak memory "
            f"allocated {torch.cuda.max_memory_allocated() / 2 ** 20:.1f} "
            f"MiB")
        log(f"[dense8] {variant} StreamMetrics.summary(): FPR="
            f"{summary['fpr']:.6g} FNR={summary['fnr']:.6g} final_load="
            f"{summary['final_load']:.6g} n={summary['n']} "
            f"convergence_batch={summary['convergence_batch']}; load "
            f"{st.load.tolist()} == recount: {exact}; dup reports equal "
            f"to the planes path's on the same {DENSE8_N} records: {same}; "
            f"kernel launches: {launches}")
        if not (exact and same and summary["n"] == DENSE8_N
                and int(st.position) == DENSE8_N + 1
                and 0.0 <= summary["fpr"] < 0.05
                and 0.0 <= summary["fnr"] < 0.5):
            raise AssertionError(f"dense8 {variant} path result out of "
                                 f"bounds")
        if launches != {"hashmix": n_steps, "bitset_step": 0,
                        "counter_step": 0}:
            raise AssertionError(f"dense8 {variant}: expected one hashmix "
                                 f"per step ({n_steps}) and no step "
                                 f"kernel, got {launches}")
        # dense8 -> planes on the card, against the plane path's checkpoint
        pcfg = config(variant, MEMORY_MB, batch_size=BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        moved = migrate_filter_state(st, cfg, pcfg)
        torch.cuda.synchronize()
        t_move = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        saved = CheckpointManager(os.path.join(ckpt_dir, variant)).restore(
            CKPT_AT, {"filter": moved})["filter"]
        same = {f: torch.equal(a, b) for f, a, b in zip(
            ("bits", "position", "load", "rng"), moved, saved)}
        log(f"[dense8] {variant}: migrate_filter_state dense8 -> planes on "
            f"the card in {t_move:.3f} s (host clock; peak memory "
            f"allocated during it {peak / 2 ** 20:.1f} MiB, the dense8 "
            f"state {nbytes / 2 ** 20:.1f} MiB): "
            f"{tuple(st.bits.shape)} {st.bits.dtype} -> "
            f"{tuple(moved.bits.shape)} {moved.bits.dtype}; equal to the "
            f"plane path's checkpoint at record {CKPT_AT}: {same}")
        if not all(same.values()):
            raise AssertionError(f"dense8 {variant}: the migrated state "
                                 f"differs from the plane path's "
                                 f"checkpoint")
        del moved, saved
        out[variant] = (cfg, pipe)
        del dups
    del kw, tw
    # the oracle against the batched engine at B = 1, at the 256 MB table
    cfg = paper_config("sbf", MEMORY_MB, batch_size=1)
    eng = Dedup(cfg)
    ok = eng.init()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    so, do = eng.run_stream_oracle(ok, keys[:ORACLE_N])
    torch.cuda.synchronize()
    t_oracle = time.perf_counter() - t0
    t0 = time.perf_counter()
    sb, db = eng.run_stream(ok, keys[:ORACLE_N])
    torch.cuda.synchronize()
    t_engine = time.perf_counter() - t0
    same = {"dups": torch.equal(do, db), "cells": torch.equal(so.bits,
                                                              sb.bits),
            "load": torch.equal(so.load, sb.load),
            "position": torch.equal(so.position, sb.position),
            "rng": torch.equal(so.rng, sb.rng)}
    log(f"[dense8] sbf oracle on the card, 256 MB, {ORACLE_N} keys: "
        f"{t_oracle:.1f} s; the batched engine at B = 1: {t_engine:.1f} s; "
        f"equal: {same}; reported dups {int(do.sum())}, load "
        f"{so.load.tolist()}")
    if not all(same.values()):
        raise AssertionError("sbf oracle != the B = 1 engine on the card")
    del so, sb, ok
    torch.cuda.empty_cache()
    return out


def serve_score(batch):
    """The serving example's scorer (``examples/serving_frontend.py``)."""
    return np.asarray(batch["key"], np.float64) * 2.0


def serve_clients(cfg, keys, tenants, score=serve_score,
                  clients=SERVE_CLIENTS):
    """``ServeFrontend`` under ``clients`` closed-loop clients: client c
    submits records c, c + clients, ... one at a time, each after the
    previous one's answer, as the serving example's clients do. -> (front
    end, wall seconds, per-request latencies in seconds, results)"""
    import asyncio
    from repro_torch.serve import DEFAULT_BUCKETS, ServeFrontend
    fe = ServeFrontend(cfg, score, buckets=DEFAULT_BUCKETS,
                       max_live_batches=4, flush_timeout=2e-3,
                       record_schedule=True)
    lat = np.zeros(len(keys))
    results = [None] * len(keys)

    async def client(c):
        for i in range(c, len(keys), clients):
            t0 = time.perf_counter()
            results[i] = await fe.submit(int(keys[i]),
                                         tenant=int(tenants[i]))
            lat[i] = time.perf_counter() - t0

    async def drive():
        async with fe:
            t0 = time.perf_counter()
            await asyncio.gather(*(client(c) for c in range(clients)))
            return time.perf_counter() - t0

    secs = asyncio.run(drive())
    return fe, secs, lat, results


def profile_serve_step(ex, keys, card, tag):
    """Host wall and device busy time of ``ex.dedup_chunk`` at bucket
    SERVE_PROFILE_WIDTH (8 micro-batches of that many requests, after the
    digest check: they step the executor's filter on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    n_b, w = 8, SERVE_PROFILE_WIDTH
    ten = np.random.default_rng(SEED + 8).integers(
        0, max(ex.n_tenants, 1), n_b * w).astype(np.int32)
    chunks = [(keys[i * w:(i + 1) * w], ten[i * w:(i + 1) * w])
              for i in range(n_b)]
    ex.dedup_chunk(*chunks[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k, t in chunks:
        ex.dedup_chunk(k, t)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n_b * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k, t in chunks:
            ex.dedup_chunk(k, t)
        torch.cuda.synchronize()
    dev = [r for r in prof.key_averages()
           if str(getattr(r, "device_type", "")).endswith("CUDA")
           and getattr(r, "self_device_time_total", 0) > 0]
    if not dev:
        log(f"[serve] {tag}: micro-batch step at bucket {w}: host wall "
            f"{wall:.4f} ms unprofiled; the profiler recorded no device "
            f"time: idle share not measured ({card})")
        return
    busy = sum(r.self_device_time_total for r in dev) / 1e3 / n_b
    log(f"[serve] {tag}: micro-batch step at bucket {w}: host wall "
        f"{wall:.4f} ms unprofiled (the verdicts' copy to the host "
        f"included), device busy {busy:.4f} ms in "
        f"{sum(r.count for r in dev) / n_b:.1f} kernels, idle share "
        f"{max(0.0, 1 - busy / wall):.4f} ({card})")


def phase_serve(keys, card):
    """The serving path on the card: ``ServeFrontend`` under
    SERVE_CLIENTS closed-loop clients over the stream's first SERVE_N
    records, for the reference's default rlbsbf 256 MB config (dense8) and
    for the 32 x 8 MB rlbsbf fleet (tenant ids uniform from a seeded
    generator). Each must answer every request with ``2 * key``, give the
    live verdict digest that ``replay_schedule`` gives through a fresh
    engine on the card, step at most one width per bucket, and launch its
    path's kernel once per micro-batch and once per replayed batch: hashmix
    on dense8, the bitset step on the fleet's planes."""
    import torch
    from repro_torch.configs import paper_config
    from repro_torch.kernels.fused_template import bitset_step, counter_step
    from repro_torch.kernels.hashmix import hashmix
    from repro_torch.serve import DEFAULT_BUCKETS, replay_schedule
    counters = (hashmix, bitset_step, counter_step)
    keys = keys[:SERVE_N]
    tenants = np.random.default_rng(SEED + 7).integers(
        0, FLEET_T, SERVE_N).astype(np.int32)
    for tag, cfg, ten, kernel in (
            ("rlbsbf-256MB-dense8", paper_config("rlbsbf", MEMORY_MB,
                                                 batch_size=BATCH),
             np.zeros(SERVE_N, np.int32), "hashmix"),
            ("fleet-rlbsbf-32x8MB", fleet_config("rlbsbf"), tenants,
             "bitset_step")):
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        fe, secs, lat, results = serve_clients(cfg, keys, ten)
        launches = {c.__name__: c.launches for c in counters}
        ex = fe.executor
        st = fe.stats()
        ok = [r is not None and r.verdict == "ok" for r in results]
        exact = all(ok) and all(float(r.value) == 2.0 * float(k)
                                for r, k in zip(results, keys))
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        replayed = replay_schedule(cfg, ex.schedule)
        t_replay = time.perf_counter() - t0
        replay_launches = {c.__name__: c.launches for c in counters}
        same = replayed == ex.digest()
        p50, p99 = np.percentile(lat, [50, 99]) * 1e3
        log(f"[serve] {tag} ({cfg.effective_layout}, k={cfg.k}, "
            f"s={cfg.s} per row, {cfg.n_tenants} tenant(s)), buckets "
            f"{DEFAULT_BUCKETS}, {SERVE_CLIENTS} closed-loop clients over "
            f"{SERVE_N} records: {st['completed'] / secs:.1f} requests/s "
            f"served (host clock); p50 {p50:.4f} ms, p99 {p99:.4f} ms per "
            f"request from submit to result, in the clients; "
            f"{st['batches']} micro-batches, mean fill "
            f"{st['mean_fill']:.2f}; shed rate {st['shed_rate']:.6g}; cache "
            f"hit rate {st['cache_hit_rate']:.6g}; dup rate "
            f"{st['dup_rate']:.6g}; step widths {ex.process_cache_size()} "
            f"({card})")
        log(f"[serve] {tag}: every answer 2 * key: {exact}; live digest "
            f"{ex.digest()[:16]} == replay_schedule on the card "
            f"{replayed[:16]}: {same} (replay of {len(ex.schedule)} "
            f"batches in {t_replay:.2f} s); kernel launches: front end "
            f"{launches}, replay {replay_launches}")
        if not (exact and same and ex.process_cache_size() <= 3
                and st["completed"] == SERVE_N):
            raise AssertionError(f"serve {tag}: result out of bounds")
        for got, n in ((launches, ex.n_batches),
                       (replay_launches, len(ex.schedule))):
            want = {c.__name__: n if c.__name__ == kernel else 0
                    for c in counters}
            if got != want:
                raise AssertionError(f"serve {tag}: expected launches "
                                     f"{want}, got {got}")
        profile_serve_step(ex, keys, card, tag)
        del fe, ex
        torch.cuda.empty_cache()


def request_mix(n: int, seed: int) -> np.ndarray:
    """The serving benchmark's traffic (``benchmarks/serving_qps.py``):
    (n,) uint32 keys, 70% zipf (a = 1.2) over max(64, n // 8) keys
    blended with fresh uniform keys, shuffled."""
    from repro_torch.data.streams import zipf_stream
    rng = np.random.default_rng(seed)
    n_z = int(n * 0.7)
    zk, _ = zipf_stream(n_z, universe=max(64, n // 8), a=1.2, seed=seed)
    uk = rng.integers(0, 1 << 32, size=n - n_z, dtype=np.uint64
                      ).astype(np.uint32)
    keys = np.concatenate([zk, uk])
    return keys[rng.permutation(n)]


def lm_rel_err(got, want) -> float:
    """max |got - want| over max |want|, in fp32."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def lm_scorer_tokens(keys, width: int, vocab: int) -> np.ndarray:
    """(width, LM_SEQ_LEN) int32 pseudo-tokens of request keys, the rows
    past ``len(keys)`` padding (key 0): key * (j + 1) * 0x9E3779B97F4A7C15
    mod 2^64, its high word, mod ``vocab`` (``benchmarks/serving_qps.py``'s
    mapping)."""
    mults = (np.arange(1, LM_SEQ_LEN + 1, dtype=np.uint64)
             * np.uint64(0x9E3779B97F4A7C15))
    keys_p = np.pad(np.asarray(keys, np.uint64), (0, width - len(keys)))
    return ((keys_p[:, None] * mults[None, :]) >> np.uint64(32)
            ).astype(np.int32) % vocab


def make_lm_scorer(cfg, params):
    """The serving benchmark's ``transformer`` scorer over the port's model
    on the card: a miss-batch of m keys padded to ``max(32,
    next_pow2(m))`` rows of pseudo-tokens, prefilled; -> the mean of the
    last position's first 8 logits, (m,) float32 on the host. It runs in
    the front end's pool thread and takes no lock the dedup step needs."""
    import torch
    from repro_torch.core.engine import next_pow2
    from repro_torch.serve import make_prefill_step
    prefill_step = make_prefill_step(cfg)
    device = params["embed"].device

    def scorer(batch: dict) -> np.ndarray:
        keys = np.asarray(batch["key"], np.uint64)
        m = keys.shape[0]
        width = max(LM_MIN_WIDTH, next_pow2(m))
        tokens = torch.from_numpy(lm_scorer_tokens(keys, width, cfg.vocab))
        with torch.cuda.device(device):
            logits = prefill_step(params, tokens.to(device))
            return logits[:, -1, :8].mean(-1).float().cpu().numpy()[:m]

    return scorer


def lm_front_end(tag, cfg, params, n, clients, card, warm):
    """``ServeFrontend`` (buckets (64, 256, 1024), 4 in flight, 2 ms flush)
    with the LM scorer over ``params`` in front of the serving benchmark's
    dedup config (rlbsbf, 2^20 bits, dense8, batch 64): an untimed warm-up
    front end of its own over ``warm`` other keys (the reference's warm-up:
    it takes the first-use costs of the dedup step and of the scorer's
    widths out of the timed run), then ``clients`` closed-loop clients
    over ``n`` requests of the benchmark's mix, the launch counts set to 0
    just before and read just after. Fails unless every request is
    answered, the digest equals ``replay_schedule`` on the card and on the
    CPU (where the engine runs hashmix's plain version), hashmix at each
    recorded micro-batch width equals its plain version, every answer is
    bit for bit a value its key was scored to, and hashmix launched once
    per micro-batch (no step kernel). -> dict(launches, hash_err, scorer,
    scored: {key: the values it was scored to}, widths: the scorer's
    padded width per call)"""
    import torch
    from repro_torch.core import DedupConfig, hashing, u32
    from repro_torch.core.engine import next_pow2
    from repro_torch.kernels.fused_template import bitset_step, counter_step
    from repro_torch.kernels.hashmix import hashmix, hashmix_plain
    from repro_torch.serve import replay_schedule
    dcfg = DedupConfig.for_variant("rlbsbf", memory_bits=1 << 20,
                                   batch_size=64)
    scorer = make_lm_scorer(cfg, params)
    widths = []

    def score(batch):
        widths.append(max(LM_MIN_WIDTH, next_pow2(len(batch["key"]))))
        return scorer(batch)

    serve_clients(dcfg, request_mix(warm, seed=11), np.zeros(warm, np.int32),
                  score, clients)
    widths.clear()
    keys = request_mix(n, seed=7)
    counters = (hashmix, bitset_step, counter_step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    fe, secs, lat, results = serve_clients(
        dcfg, keys, np.zeros(n, np.int32), score, clients)
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()
    ex = fe.executor
    st = fe.stats()
    # the replays: on the card through the same kernel, and on the CPU,
    # where the engine runs hashmix's plain version
    replayed = replay_schedule(dcfg, ex.schedule)
    replayed_cpu = replay_schedule(dcfg, ex.schedule, device="cpu")
    # hashmix at the shapes this path gave it (dcfg's k and s, each
    # recorded micro-batch width) against its plain version; these launches
    # come after the path's counts were read
    seeds = u32.from_numpy_u32(hashing.derive_seeds(dcfg.seed, dcfg.k, 0),
                               "cpu")
    hash_err, hash_eq = 0, dcfg.block_bits == 0
    for w in sorted({w for w, _ in ex.schedule}):
        first = next(k for ww, k in ex.schedule if ww == w)
        hk = u32.from_numpy_u32(np.pad(first, (0, w - first.size)), "cuda")
        got_h = hashmix(hk, seeds, s=dcfg.s)
        want_h = hashmix_plain(hk, seeds.cuda(), dcfg.s)
        hash_err = max(hash_err, abs_err(got_h, want_h))
        hash_eq = hash_eq and torch.equal(got_h, want_h)
        log(f"[{tag}] hashmix at this path's shape (B={w}, k={dcfg.k}, "
            f"s={dcfg.s}): exactly equal to the plain version "
            f"{torch.equal(got_h, want_h)}")
    ok = all(r is not None and r.verdict == "ok" for r in results)
    # the cache: every answer is bit for bit a value the scorer gave its
    # key, so a key the scorer answered one way is answered identically
    # every time; two micro-batches in flight together may both miss the
    # cache on one key and score it twice (counted, as the reference's
    # front end does the same)
    scored = {}
    for k, r in zip(keys.tolist(), results):
        if not r.cached:
            scored.setdefault(k, set()).add(float(r.value))
    cache_ok = all(float(r.value) in scored.get(k, ()) for k, r in
                   zip(keys.tolist(), results))
    twice = sum(len(v) > 1 for v in scored.values())
    p50, p99 = np.percentile(lat, [50, 99]) * 1e3
    hist = {w: widths.count(w) for w in sorted(set(widths))}
    log(f"[{tag}] serve-lm-{cfg.name}-dense8-rlbsbf-1M: ServeFrontend("
        f"buckets (64, 256, 1024), 4 in flight, 2 ms flush) over "
        f"{dcfg.effective_layout} rlbsbf (k={dcfg.k}, s={dcfg.s}), "
        f"{clients} closed-loop clients, {n} requests of the serving "
        f"benchmark's mix: {st['completed'] / secs:.1f} requests/s (host "
        f"clock); p50 {p50:.4f} ms, p99 {p99:.4f} ms per request; "
        f"{st['batches']} micro-batches, mean fill {st['mean_fill']:.2f}; "
        f"cache hit rate {st['cache_hit_rate']:.6g}, dup rate "
        f"{st['dup_rate']:.6g}, {st['scored']} scored; scorer calls by "
        f"padded width {hist}; peak device memory {peak / 2**30:.3f} GiB "
        f"({card})")
    log(f"[{tag}] served: all answered {ok}; live digest "
        f"{ex.digest()[:16]} == replay_schedule on the card "
        f"{replayed[:16]}: {replayed == ex.digest()}, == on the CPU "
        f"(hashmix's plain version) {replayed_cpu[:16]}: "
        f"{replayed_cpu == ex.digest()}; every answer bit for bit a value "
        f"its key was scored to: {cache_ok} ({len(scored)} keys, {twice} "
        f"of them scored to two values by micro-batches in flight "
        f"together); launches {launches} for {ex.n_batches} micro-batches")
    want_l = {c.__name__: ex.n_batches if c is hashmix else 0
              for c in counters}
    if not (ok and cache_ok and hash_eq
            and replayed == replayed_cpu == ex.digest()
            and st["completed"] == n and launches == want_l):
        raise AssertionError(f"{tag}: the LM-scored front end is out of "
                             f"bounds")
    return dict(launches=launches, hash_err=hash_err, scorer=scorer,
                scored=scored, widths=list(widths))


def lm_decode_profile(step, params, cache, tok, b, n=2):
    """Device busy ms per decode step and its five costliest kernels (ms
    per step, launches per step), from torch.profiler over n steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(params, cache, tok, torch.full(
                (b,), LM_DECODE_TOKENS + i, dtype=torch.int32,
                device="cuda"))
        torch.cuda.synchronize()
    rows = [r for r in prof.key_averages()
            if str(getattr(r, "device_type", "")).endswith("CUDA")
            and r.self_device_time_total > 0]
    if not rows:
        return None, None
    rows.sort(key=lambda r: -r.self_device_time_total)
    top = [(r.key[:60], round(r.self_device_time_total / 1e3 / n, 4),
            r.count / n) for r in rows[:5]]
    return sum(r.self_device_time_total for r in rows) / 1e3 / n, top


def phase_lm(card):
    """The dense LM on the card at qwen3-8b's published width: the seeded
    bf16 model (its parameter count), decode against prefill, an fp32
    2-layer copy against the CPU, the LM scorer behind ``ServeFrontend`` in
    front of the serving benchmark's dedup config, and greedy decode timed
    beside its weight-read bound. -> (the front end's kernel launches,
    hashmix's largest difference from its plain version at the front end's
    shapes)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import make_decode_step, make_prefill_step
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 is fp32 (step 3)
    cfg = get_arch(LM_ARCH).cfg
    rng = np.random.default_rng(SEED + 20)
    laps = [time.perf_counter()]

    def lap(what):
        laps.append(time.perf_counter())
        log(f"[lm] {what}: {laps[-1] - laps[-2]:.1f} s")

    # 1. the model on the card, and its size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tfm.init(cfg, SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"[lm] {LM_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads, hd {cfg.hd}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, qk-norm {cfg.qk_norm}, rope "
        f"theta {cfg.rope_theta:g}, {cfg.dtype}: {n_params} parameters "
        f"({w_bytes / 1e9:.4f} GB) on {params['embed'].device}, seeded init "
        f"in {time.perf_counter() - t0:.2f} s")
    if not (n_params == cfg.param_count() == LM_PARAMS
            and params["embed"].device.type == "cuda"):
        raise AssertionError(f"lm: {n_params} parameters, expected "
                             f"{LM_PARAMS} on cuda")
    lap("build")

    # 2. decode against prefill (the reference's test_decode_matches_prefill)
    B, S = LM_PREFILL
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
        np.int32)).cuda()
    full = make_prefill_step(cfg)(params, toks)
    step = make_decode_step(cfg)
    cache = tfm.init_cache(cfg, B, S)
    worst = 0.0
    for t in range(LM_TEACHER):
        lg, cache = step(params, cache, toks[:, t],
                         torch.full((B,), t, dtype=torch.int32,
                                    device="cuda"))
        worst = max(worst, lm_rel_err(lg, full[:, t]))
    max_logit = float(full[:, :LM_TEACHER].float().abs().max())
    finite = bool(torch.isfinite(full).all())
    log(f"[lm] decode == prefill (B {B}, S {S}, positions 0 - "
        f"{LM_TEACHER - 1} teacher-forced from an empty cache): max |diff| / "
        f"max |logit| = {worst:.6g} (max |logit| {max_logit:.4f}; bf16 "
        f"tolerance {LM_REL_TOL}); prefill logits {tuple(full.shape)} "
        f"{full.dtype}, finite {finite}")
    if not (finite and worst <= LM_REL_TOL
            and tuple(full.shape) == (B, S, cfg.vocab)):
        raise AssertionError("lm: decode disagrees with prefill")
    del full, cache, lg
    lap("decode against prefill")

    # 3. the card against the CPU, fp32, full width at 2 layers
    c32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    t0 = time.perf_counter()
    gpu = tfm.init(c32, SEED)
    cpu = copy.deepcopy(gpu).cpu()
    t_copy = time.perf_counter() - t0
    b2, s2 = LM_CPU
    toks2 = torch.from_numpy(rng.integers(0, cfg.vocab, (b2, s2)).astype(
        np.int32))
    t0 = time.perf_counter()
    want = tfm.prefill(c32, cpu, toks2)
    t_cpu = time.perf_counter() - t0
    got = tfm.prefill(c32, gpu, toks2.cuda()).cpu()
    err32 = lm_rel_err(got, want)
    log(f"[lm] fp32 card == CPU ({c32.n_layers} layers at full width, "
        f"{c32.param_count()} parameters, prefill B {b2}, S {s2}, TF32 "
        f"off): max |diff| / max |logit| = {err32:.6g} (tolerance "
        f"{LM_FP32_TOL}; max |logit| {float(want.abs().max()):.4f}); "
        f"init on the card and copy to the host {t_copy:.1f} s, CPU "
        f"prefill {t_cpu:.1f} s")
    if not err32 <= LM_FP32_TOL:
        raise AssertionError("lm: the card's fp32 logits disagree with the "
                             "CPU's")
    del cpu, gpu, want, got
    torch.cuda.empty_cache()
    lap("fp32 card against the CPU")

    # 4. the LM scorer behind the front end
    fe = lm_front_end("lm", cfg, params, LM_SERVE_N, LM_CLIENTS, card,
                      warm=max(512, LM_SERVE_N // 16))
    launches, hash_err, scorer, scored = (fe["launches"], fe["hash_err"],
                                          fe["scorer"], fe["scored"])
    hist = {w: fe["widths"].count(w) for w in sorted(set(fe["widths"]))}
    distinct = np.fromiter(scored, np.uint32, len(scored))
    again = np.concatenate([scorer({"key": distinct[i:i + LM_RESCORE]})
                            for i in range(0, distinct.size, LM_RESCORE)])
    rescore = max(abs(float(v) - float(a))
                  for k, a in zip(distinct.tolist(), again)
                  for v in scored[k])
    log(f"[lm] served values rescored in batches of {LM_RESCORE}: max "
        f"|diff| {rescore:.6g} (must be 0: the same scorer, the same bits)")
    if rescore != 0.0:
        raise AssertionError("lm: a served value differs from rescoring "
                             "its key")
    del fe
    lap("serving")
    prefill = make_prefill_step(cfg)
    for w in LM_WIDTHS:
        tw = torch.from_numpy(lm_scorer_tokens(
            rng.integers(0, 1 << 32, w, dtype=np.uint64), w,
            cfg.vocab)).cuda()
        prefill(params, tw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        wall = wall_ms(lambda i: prefill(params, tw), 2)
        extra = (torch.cuda.max_memory_allocated() - base) / 2**30
        busy = ""
        if w in hist:     # profiling ~3000 eager ops costs seconds: the
            dev = device_ms(lambda i: prefill(params, tw), 1)  # served only
            busy = (", device time not measured (none in the trace)"
                    if dev is None else f", device {dev:.4f} ms, idle "
                    f"share {max(0.0, 1 - dev / wall):.4f}")
        flops = 2.0 * w * 16 * (n_params - cfg.vocab * cfg.d_model)
        log(f"[lm] scorer prefill at width {w} ({w * 16} tokens, logits "
            f"{w * 16 * cfg.vocab * 2 / 2**30:.3f} GiB): {wall:.4f} ms per "
            f"call by CUDA events{busy}; matmul bound "
            f"{flops / PEAK_FLOPS_BF16 * 1e3:.4f} ms (bf16 at "
            f"{PEAK_FLOPS_BF16 / 1e12:g} TFLOP/s); peak memory "
            f"above the weights {extra:.3f} GiB ({card})")
        del tw
        torch.cuda.empty_cache()
    lap("scorer widths")

    # 5. greedy decode timed against the weight-read bound
    bound = w_bytes / HBM_BW * 1e3
    for b in LM_DECODE_B:
        cache = tfm.init_cache(cfg, b, LM_DECODE_SEQ)
        c_bytes = sum(c.numel() * c.element_size() for c in cache.values())
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, b).astype(
            np.int32)).cuda()
        step(params, cache, tok, torch.zeros(b, dtype=torch.int32,
                                             device="cuda"))
        cache["kpos"].fill_(-1)                 # the warm step, forgotten
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(LM_DECODE_TOKENS):
            lg, cache = step(params, cache, tok,
                             torch.full((b,), t, dtype=torch.int32,
                                        device="cuda"))
            tok = lg.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / LM_DECODE_TOKENS * 1e3
        dev, top = lm_decode_profile(step, params, cache, tok, b, n=1)
        busy = ("not measured" if dev is None else
                f"{dev:.4f} ms (idle share {max(0.0, 1 - dev / ms):.4f}); "
                f"its kernels by device time {top}")
        log(f"[lm] decode-{LM_ARCH}-b{b}: greedy over a {LM_DECODE_SEQ}-slot "
            f"cache ({c_bytes / 1e9:.4f} GB), {LM_DECODE_TOKENS} tokens: "
            f"{ms:.4f} ms per step, {b * 1e3 / ms:.1f} tokens/s; device busy "
            f"per step {busy}; weight-read bound {bound:.4f} ms "
            f"({w_bytes / 1e9:.4f} GB at 3.35 TB/s), with the cache read "
            f"{(w_bytes + c_bytes) / HBM_BW * 1e3:.4f} ms; "
            f"{bound / ms:.4f} of the weight-read bound ({card})")
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"lm: decode at B {b} is not finite")
        del cache, lg
        torch.cuda.empty_cache()
    lap("decode timing")
    del params, scorer      # the scorer holds the params
    torch.cuda.empty_cache()
    return launches, hash_err


@contextlib.contextmanager
def recorded_routes():
    """Records the expert ids of every MoE dispatch inside the block: one
    (ids (n_groups, T, k) on the card, capacity, n_experts) per call, by
    wrapping ``models.moe._route`` for the block's length (no host
    read)."""
    from repro_torch.models import moe
    calls, route = [], moe._route

    def recording(params, x, cfg):
        ids, w = route(params, x, cfg)
        calls.append((ids, moe._capacity(x.shape[-2], cfg), cfg.n_experts))
        return ids, w

    moe._route = recording
    try:
        yield calls
    finally:
        moe._route = route


def group_drops(ids, cap: int, n_experts: int) -> list:
    """The (token, slot) pairs past their expert's capacity in each group
    of one recorded dispatch."""
    import torch
    flat = ids.reshape(ids.shape[0], -1)
    load = torch.zeros((flat.shape[0], n_experts), dtype=torch.int64,
                       device=flat.device).scatter_add_(
        1, flat, torch.ones_like(flat))
    return (load - cap).clamp(min=0).sum(1).tolist()


def dropped_pairs(calls) -> list:
    """The (token, slot) pairs past their expert's capacity, per recorded
    dispatch."""
    return [sum(group_drops(*c)) for c in calls]


@contextlib.contextmanager
def route_log():
    """Records every MoE dispatch inside the block for the card-vs-CPU
    train check: one (ids (n_groups, T, k), gaps (n_groups, T)) per call,
    both on the host, ``gaps`` each token's least difference between
    adjacent router probabilities among its k + 1 largest (its top-k
    gap: a near tie shows as a gap near 0)."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.layers import _wide
    calls, route = [], moe._route

    def recording(params, x, cfg):
        ids, w = route(params, x, cfg)
        probs = torch.softmax(_wide(x) @ _wide(params["router"]), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True).values[
            ..., :cfg.top_k + 1]
        gaps = (top[..., :-1] - top[..., 1:]).amin(-1)
        calls.append((ids.detach().cpu(), gaps.detach().double().cpu()))
        return ids, w

    moe._route = recording
    try:
        yield calls
    finally:
        moe._route = route


def route_differences(cfg, logs: dict, accum: int, step: int) -> list:
    """Where the route ids of a train step's runs differ from the float64
    CPU referee's (``logs``: run name -> ``route_log`` calls, the referee
    "ref"), layer by layer: one line per differing run and layer, naming
    the first differing token (row and position in its microbatch), both
    runs' ids there and the referee's top-k gap. The calls of a step are
    its microbatches' MoE layers in order (remat "none")."""
    n_moe = cfg.n_layers - cfg.first_dense_layers
    ref, out = logs["ref"], []
    for name, calls in logs.items():
        if name == "ref":
            continue
        if len(calls) != len(ref):
            out.append(f"run {name} step {step}: {len(calls)} dispatches, "
                       f"the referee {len(ref)}")
            continue
        for i, ((ids, _), (want, gaps)) in enumerate(zip(calls, ref)):
            bad = (ids != want).any(-1)
            if not bad.any():
                continue
            g, t = (int(v) for v in bad.nonzero()[0])
            out.append(
                f"run {name} step {step} microbatch {i // n_moe} of {accum}"
                f" layer {cfg.first_dense_layers + i % n_moe}: token "
                f"{g * ids.shape[1] + t} of {ids.shape[0] * ids.shape[1]} "
                f"({int(bad.sum())} differ): ids {ids[g, t].tolist()}, the "
                f"float64 CPU referee's {want[g, t].tolist()}, its top-k gap"
                f" {float(gaps[g, t]):.6g} (its least over the microbatch "
                f"{float(gaps.min()):.6g})")
    return out


def host_available_gb() -> float:
    """The host's available memory in GB (``MemAvailable``)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def moe_fp32_checks(arch_id, cfg, spec, rng, card):
    """fp32 at full width, ``fp32_layers`` layers, TF32 off: the card's
    prefill against the CPU's on the same weights; on the card
    teacher-forced ``decode_step`` against ``prefill`` at capacity factor
    n_experts / top_k (no pair can drop at any T, so the two route alike),
    both MLA decode forms against each other; one MoE layer's einsum
    dispatch against its sort dispatch at T = MOE_DISPATCH_T, nothing
    dropped. Each within LM_FP32_TOL of the max |value|."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    c32 = dataclasses.replace(cfg, n_layers=spec["fp32_layers"],
                              dtype=torch.float32)
    log(f"[moe] {arch_id} fp32: host memory available "
        f"{host_available_gb():.1f} GB before a "
        f"{spec['fp32_params'] * 4 / 1e9:.1f} GB copy to the host")
    t0 = time.perf_counter()
    gpu = tfm.init(c32, SEED)
    n32 = sum(p.numel() for p in gpu.parameters())
    cpu = copy.deepcopy(gpu).cpu()
    t_copy = time.perf_counter() - t0
    b, s = MOE_CPU
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(
        np.int32))
    t0 = time.perf_counter()
    want = tfm.prefill(c32, cpu, toks)
    t_cpu = time.perf_counter() - t0
    del cpu
    tc = toks.cuda()
    err_cpu = lm_rel_err(tfm.prefill(c32, gpu, tc).cpu(), want)
    del want
    lossless = dataclasses.replace(
        c32, capacity_factor=cfg.n_experts / cfg.moe_top_k)
    full = tfm.prefill(lossless, gpu, tc)
    forms = (True, False) if cfg.use_mla else (cfg.mla_absorb,)
    caches = {a: tfm.init_cache(lossless, b, s) for a in forms}
    err_dec = dict.fromkeys(forms, 0.0)
    err_forms = 0.0
    for t in range(s):
        pos = torch.full((b,), t, dtype=torch.int32, device="cuda")
        lg = {}
        for a in forms:
            lg[a], _ = tfm.decode_step(
                dataclasses.replace(lossless, mla_absorb=a), gpu, caches[a],
                tc[:, t], pos)
            err_dec[a] = max(err_dec[a], lm_rel_err(lg[a], full[:, t]))
        if len(forms) == 2:
            err_forms = max(err_forms, lm_rel_err(lg[False], lg[True]))
    del full, caches, lg
    mcfg = lossless.moe_cfg
    x = torch.from_numpy(rng.standard_normal(
        (MOE_DISPATCH_T, cfg.d_model)).astype(np.float32)).cuda()
    with torch.inference_mode(), recorded_routes() as calls:
        layer = gpu["layers"][0]["moe"]
        by_einsum = moe.moe_apply(layer, x, mcfg._replace(dispatch="einsum"))
        by_sort = moe.moe_apply(layer, x, mcfg._replace(dispatch="sort"))
    drops = dropped_pairs(calls)
    err_disp = lm_rel_err(by_einsum, by_sort)
    forms_txt = (f"; absorbed == naive decode {err_forms:.6g}"
                 if len(forms) == 2 else "")
    log(f"[moe] {arch_id} fp32 at full width, {c32.n_layers} layers "
        f"({n32} parameters; {c32.first_dense_layers} dense), TF32 off, "
        f"max |diff| / max |value|: card == CPU prefill (B {b}, S {s}) "
        f"{err_cpu:.6g}; decode == prefill at capacity factor "
        f"{lossless.capacity_factor:g} "
        + ", ".join(f"({'absorbed' if a else 'naive'}) {err_dec[a]:.6g}"
                    for a in forms)
        + f"{forms_txt}; einsum == sort dispatch (T {MOE_DISPATCH_T}, "
        f"capacity {moe._capacity(MOE_DISPATCH_T, mcfg)}, pairs dropped "
        f"{drops}) {err_disp:.6g}; tolerance {LM_FP32_TOL}; init and copy "
        f"to the host {t_copy:.1f} s, CPU prefill {t_cpu:.1f} s ({card})")
    if not (n32 == spec["fp32_params"] and max(
            err_cpu, err_disp, err_forms, *err_dec.values()) <= LM_FP32_TOL
            and drops == [0, 0]):
        raise AssertionError(f"moe: {arch_id}'s fp32 checks are out of "
                             f"bounds")
    del gpu, by_einsum, by_sort, x
    torch.cuda.empty_cache()


def phase_moe(card):
    """The MoE LMs on the card at their published widths, bf16, seeded,
    depth cut (``MOE_ARCHS``), one model on the card at a time: the
    parameter counts (the cut ones on the card, full depth on the meta
    device); the fp32 checks (``moe_fp32_checks``); a prefill of B 4, S 256
    (finite, its shape, the pairs dropped per MoE layer at the published
    capacity), decode against it (printed, not gated: in bf16 a near tie
    in the router may pick other experts on either path), and greedy
    decode timed beside its weight-read bound; then deepseek behind
    ``ServeFrontend`` (``lm_front_end``). -> (the front end's kernel
    launches, hashmix's largest difference from its plain version at the
    front end's shapes)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import make_decode_step, make_prefill_step
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 is fp32
    rng = np.random.default_rng(SEED + 22)
    served = None
    held = torch.cuda.memory_allocated()
    for arch_id, spec in MOE_ARCHS.items():
        t_arch = time.perf_counter()
        cfg = get_arch(arch_id).cfg
        moe_fp32_checks(arch_id, cfg, spec, rng, card)
        t_fp32 = time.perf_counter() - t_arch
        cut = dataclasses.replace(cfg, n_layers=spec["layers"])
        counts = (cfg.param_count(), cfg.active_param_count(),
                  cut.param_count())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = tfm.init(cut, SEED)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(p.numel() for p in params.parameters())
        w_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
        attn = (f"MLA latent {cfg.kv_lora_rank}" if cfg.use_mla
                else f"GQA {cfg.n_kv_heads} KV heads")
        log(f"[moe] {arch_id}: {cut.n_layers} of {cfg.n_layers} layers "
            f"({cut.first_dense_layers} dense), d {cfg.d_model}, "
            f"{cfg.n_heads} heads, {cfg.n_experts} experts top-"
            f"{cfg.moe_top_k} (+{cfg.n_shared_experts} shared) of d_ff "
            f"{cfg.d_ff_expert}, {attn}, "
            f"{cfg.attention}, {cfg.moe_dispatch} dispatch, vocab "
            f"{cfg.vocab}, {cut.dtype}: {n_params} parameters "
            f"({w_bytes / 1e9:.4f} GB) on {params['embed'].device}, seeded "
            f"init {t_init:.2f} s; full depth on the meta device "
            f"{counts[0]} parameters, {counts[1]} active")
        if not (n_params == counts[2] == spec["params"]
                and counts[:2] == (spec["full"], spec["active"])
                and params["embed"].device.type == "cuda"):
            raise AssertionError(f"moe: {arch_id}'s parameter counts")

        B, S = MOE_PREFILL
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
            np.int32)).cuda()
        prefill = make_prefill_step(cut)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with recorded_routes() as calls:
            full = prefill(params, toks)
        drops = dropped_pairs(calls)
        peak = torch.cuda.max_memory_allocated()
        pre_ms = wall_ms(lambda i: prefill(params, toks), 2)
        finite = bool(torch.isfinite(full).all())
        step = make_decode_step(cut)
        cache = tfm.init_cache(cut, B, S)
        worst = 0.0
        for t in range(MOE_TEACHER):
            lg, _ = step(params, cache, toks[:, t], torch.full(
                (B,), t, dtype=torch.int32, device="cuda"))
            worst = max(worst, lm_rel_err(lg, full[:, t]))
        pairs = B * S * cfg.moe_top_k
        log(f"[moe] {arch_id} prefill (B {B}, S {S}): logits "
            f"{tuple(full.shape)} {full.dtype}, finite {finite}; "
            f"{pre_ms:.4f} ms per call by CUDA events; peak device memory "
            f"{peak / 2**30:.3f} GiB; (token, slot) pairs dropped per MoE "
            f"layer at capacity factor {cfg.capacity_factor:g} (capacity "
            f"{calls[0][1]} of {pairs} pairs over {cfg.n_experts} experts):"
            f" {drops}, {sum(drops) / (pairs * len(drops)):.6f} of all; "
            f"bf16 decode vs prefill over positions 0 - {MOE_TEACHER - 1} "
            f"(printed, not gated): max |diff| / max |logit| {worst:.6g} "
            f"({card})")
        if not (finite and tuple(full.shape) == (B, S, cfg.vocab)
                and len(drops) == cut.n_layers - cut.first_dense_layers):
            raise AssertionError(f"moe: {arch_id}'s bf16 prefill")
        del full, cache, lg

        b, n_tok, slots = MOE_DECODE
        cache = tfm.init_cache(cut, b, slots)
        c_bytes = sum(c.numel() * c.element_size() for c in cache.values())
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, b).astype(
            np.int32)).cuda()
        step(params, cache, tok, torch.zeros(b, dtype=torch.int32,
                                             device="cuda"))
        cache["kpos"].fill_(-1)                 # the warm step, forgotten
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(n_tok):
            lg, _ = step(params, cache, tok, torch.full(
                (b,), t, dtype=torch.int32, device="cuda"))
            tok = lg.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n_tok * 1e3
        busy, n_ops, n_kern, top = profile_train_step(lambda: step(
            params, cache, tok, torch.full((b,), n_tok, dtype=torch.int32,
                                           device="cuda")))
        bound = w_bytes / HBM_BW * 1e3
        dev = ("not measured" if busy is None else
               f"{busy:.4f} ms (idle share {max(0.0, 1 - busy / ms):.4f}; "
               f"{n_kern} kernels; the costliest {top})")
        log(f"[moe] decode-{arch_id}-{cut.n_layers}L-b{b}: greedy over a "
            f"{slots}-slot cache ({c_bytes / 1e9:.4f} GB), {n_tok} tokens: "
            f"{ms:.4f} ms per step, {b * 1e3 / ms:.1f} tokens/s; device "
            f"busy per step {dev}; {n_ops} aten ops per step; weight-read "
            f"bound {bound:.4f} ms ({w_bytes / 1e9:.4f} GB at 3.35 TB/s: "
            f"the sort dispatch's grouped einsum reads every expert), "
            f"{bound / ms:.4f} of it ({card})")
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"moe: {arch_id}'s decode is not finite")
        del cache, lg
        torch.cuda.empty_cache()
        if arch_id == MOE_SERVE_ARCH:
            log(f"[moe] {arch_id} served: no rescoring check: an MoE "
                f"layer's capacity counts the tokens routed together, so a "
                f"key's score depends on its batch mates, as in the "
                f"reference")
            fe = lm_front_end("moe", cut, params, MOE_SERVE_N, MOE_CLIENTS,
                              card, warm=MOE_WARM)
            served = fe["launches"], fe["hash_err"]
            del fe                  # its scorer holds the params
        del params
        torch.cuda.empty_cache()
        log(f"[moe] {arch_id}: {time.perf_counter() - t_arch:.1f} s "
            f"(fp32 checks {t_fp32:.1f} s); device memory allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB, "
            f"{held / 2**30:.3f} GiB before the phase")
    # the models are gone: the next phase has the card the phase found
    if torch.cuda.memory_allocated() > held + 2**30:
        raise AssertionError("moe: a model outlived the phase")
    return served


class TrainProbe:
    """What the "train" phase reads off a ``Trainer`` as it runs: each
    data draw's seconds and record keys, each dedup call's keys and weights
    (left on the card until the run ends), each checkpoint save and
    restore with its seconds, in the order they happened."""

    def __init__(self, trainer):
        self.draws, self.events, self.saves = [], [], []
        data, process = trainer.data, trainer.dedup.process
        save, restore = trainer.ckpt.save, trainer.try_restore

        def timed_data():
            while True:
                t0 = time.perf_counter()
                batch = next(data)
                self.draws.append(time.perf_counter() - t0)
                yield batch

        def recorded(batch, *a):
            out = process(batch, *a)
            self.events.append(("process", batch["key"].copy(),
                                out.weights))
            return out

        def timed_save(*a, **kw):
            t0 = time.perf_counter()
            out = save(*a, **kw)
            self.saves.append(time.perf_counter() - t0)
            return out

        def timed_restore():
            t0 = time.perf_counter()
            ok = restore()
            self.events.append(("restore", trainer.step, ok,
                                time.perf_counter() - t0))
            return ok

        trainer.data = timed_data()
        trainer.dedup.process = recorded
        trainer.ckpt.save = timed_save
        trainer.try_restore = timed_restore

    def lineage(self):
        """[(keys, weights on the host, truth)] of every dedup call, the
        truth per record: its key seen earlier in the filter's own lineage
        (a restore to step s forgets what the calls after the s-th saw) or
        earlier in its batch."""
        out, seen = [], []                 # seen: one key set per step
        for ev in self.events:
            if ev[0] == "restore":
                del seen[ev[1]:]
                continue
            _, keys, w = ev
            before = set().union(*seen) if seen else set()
            truth, mine = np.zeros(keys.size, bool), set()
            for i, k in enumerate(keys.tolist()):
                truth[i] = k in before or k in mine
                mine.add(k)
            seen.append(mine)
            out.append((keys, w.cpu().numpy(), truth))
        return out


def replay_dedup_on_cpu(cfg, events):
    """The dedup calls of a run replayed through a CPU ``DedupPipeline``
    (where the engine runs hashmix's plain version), restoring the state
    the filter had after the s-th call of its lineage where the run
    restored step s. -> the weights of each call."""
    from repro_torch.dedup import DedupPipeline
    pipe = DedupPipeline(cfg, mode="drop", device="cpu")
    snaps, out = [], []
    for ev in events:
        if ev[0] == "restore":
            del snaps[ev[1]:]
            pipe.load_state_dict(snaps[-1])
            continue
        out.append(pipe.process({"key": ev[1]}).weights)
        snaps.append(pipe.state_dict())
    return [w.numpy() for w in out]


def profile_train_step(step_fn, host_ops: bool = True):
    """(device busy ms, aten ops or None, kernels, the costliest kernels)
    of one call of ``step_fn`` (a whole train step ending in a host read),
    from torch.profiler; busy None when the trace holds no device time.
    ``host_ops=False`` traces the card alone (a step of ~300000 eager ops
    costs tens of seconds to record on the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops
                                      else [])
    with profile(activities=acts) as prof:
        step_fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    dev = [r for r in rows if str(getattr(r, "device_type", "")).endswith(
        "CUDA") and getattr(r, "self_device_time_total", 0) > 0]
    n_ops = (sum(r.count for r in rows if r.key.startswith("aten::"))
             if host_ops else None)
    busy = sum(r.self_device_time_total for r in dev) / 1e3 if dev else None
    top = [(r.key[:50], round(r.self_device_time_total / 1e3, 4), r.count)
           for r in sorted(dev, key=lambda r: -r.self_device_time_total)[:4]]
    return busy, n_ops, sum(r.count for r in dev), top


def train_bound_ms(cfg, batch: int, seq: int, peak: float) -> float:
    """The least time of one train step at ``peak`` operations/s: its
    matmuls, 6 x (parameters outside the embedding that a token meets: an
    MoE layer's top-k experts of its routed ones) x tokens, and
    attention's two products, forward and backward, over the full (S, S)
    blocks the blocked attention computes (12 x B x layers x heads x S^2 x
    head_dim); no recompute counted, nor the slots a dispatch pads."""
    n = cfg.active_param_count() - cfg.vocab * cfg.d_model
    attn = 12 * batch * cfg.n_layers * cfg.n_heads * seq * seq * cfg.hd
    return (6 * n * batch * seq + attn) / peak * 1e3


def _train_leaves(params, state) -> dict:
    """{the reference's leaf path: (param, m, v)} of a train state, each
    stacked as the reference stacks it, float64 on the host."""
    import torch
    from repro_torch.models.layers import module_leaves
    out = {}
    for lf in module_leaves(params):
        moments = []
        for tree in (state.m, state.v):
            for k in lf.path:
                tree = tree[k]
            moments.append(tree.detach().double().cpu())
        p = torch.stack(lf.tensors) if lf.stacked else lf.tensors[0]
        key = "/".join(map(str, lf.path))    # dense_layers/0/...
        out[key] = (p.detach().double().cpu(), *moments)
    return out


def _tree_to(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device, dtype) for v in tree]
    return tree.to(device, dtype, copy=True)


def train_card_vs_cpu(cfg, batches, accum: int = 1) -> dict:
    """``make_train_step`` with the training driver's AdamW from one
    seeded init over ``batches`` [(tokens (B, S+1), weights (B,))], in
    lockstep: every step starts each run from the state the CPU's fp32 run
    has reached, and takes one step on the card and on the CPU in fp32
    (TF32 off) and in float64 on both (the same code on a float64 copy of
    ``cfg``: its norms, softmax, cross entropy, accumulation buffer and
    optimizer then run in float64; the CPU's is the referee). Each run's
    gradients are the ones its step built, after accumulation and
    clipping, read back from its first moment: g = (m_t - b1 m_{t-1}) /
    (1 - b1), m_{t-1} being the common start. Before any gradient is
    compared, an MoE config's route ids of the four runs are held equal,
    layer by layer (``route_differences``): a difference is logged with
    its token and the referee's top-k gap and raises AssertionError.
    -> {"loss": max |card - CPU| / |CPU| of the fp32 losses;
    "fp64": max over the steps and leaves of the float64 card's gradient
    distance to the referee (|diff| / |referee| in the 2-norm);
    "grad_norm", "grad/<leaf>": (card's, CPU's) fp32 distance to the
    referee, the worst step's; "update": the largest |card's param update
    - referee's| in units of TRAIN_TOL x lr + 2^-22 |param| (fp32's
    rounding of the param) where |g_referee| exceeds TRAIN_NOISE times the
    leaf's largest CPU gradient error, with "masked" the share of elements
    held so; "adam": the same unit for the card's update against the
    float64 AdamW of the card's own gradients, every element; "routes":
    the MoE dispatches whose ids were held equal on all four runs}."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import OptimizerConfig, OptState, init_opt_state
    from repro_torch.train import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = OptimizerConfig(kind="adamw", lr=1e-3, warmup_steps=20,
                          total_steps=len(batches))
    b1, b2 = opt.betas
    runs = (("card", "cuda", torch.float32), ("card64", "cuda", torch.float64),
            ("ref", "cpu", torch.float64), ("cpu", "cpu", torch.float32))
    steps = {}
    for name, _, dt in runs:
        c = dataclasses.replace(cfg, dtype=dt)
        steps[name] = make_train_step(
            lambda prm, b, w, c=c: tfm.forward(c, prm, b, w)[0], opt, accum,
            torch.float64 if dt == torch.float64 else None)
    params = tfm.init(dataclasses.replace(cfg, dtype=torch.float32), SEED,
                      "cpu")
    state = init_opt_state(opt, params)
    out = {"loss": 0.0, "fp64": 0.0, "update": 0.0, "adam": 0.0,
           "masked": [0, 0], "routes": 0}

    def dist(got, want):
        return float((got - want).norm() / want.norm().clamp_min(1e-300))

    def worst(key, pair):
        old = out.get(key, (0.0, 0.0))
        out[key] = pair if pair[0] > old[0] else old

    for toks, w in batches:
        start = _train_leaves(params, state)
        got, routes = {}, {}
        for name, dev, dt in runs:             # the CPU's fp32 run last
            p, s = params, state
            if name != "cpu":
                p = copy.deepcopy(params).to(dev, dt)
                s = OptState(state.step.clone(), _tree_to(state.m, dev, dt),
                             _tree_to(state.v, dev, dt))
            with route_log() as routes[name]:
                p, s, met = steps[name](p, s, torch.from_numpy(toks).to(dev),
                                      torch.from_numpy(w).to(dev, dt))
            got[name] = (float(met["loss"]), float(met["grad_norm"]),
                         _train_leaves(p, s))
            if name == "cpu":
                params, state = p, s
        # the routes first: a token routed otherwise is a different step
        differ = route_differences(cfg, routes, accum, int(state.step))
        for line in differ:
            log(f"[train] routes differ: {line}")
        if differ:
            raise AssertionError(f"train: the runs route differently "
                                 f"({len(differ)} run and layer pairs)")
        out["routes"] += len(routes["ref"])
        lr = float(met["lr"])
        t = int(state.step)
        bc1 = float(1 - torch.pow(torch.tensor(b1, dtype=torch.float32), t))
        bc2 = float(1 - torch.pow(torch.tensor(b2, dtype=torch.float32), t))
        (l_card, gn_card, card), (_, _, card64) = got["card"], got["card64"]
        (l_ref, gn_ref, ref), (l_cpu, gn_cpu, cpu) = got["ref"], got["cpu"]
        out["loss"] = max(out["loss"], abs(l_card - l_cpu) / abs(l_cpu))
        worst("grad_norm", (abs(gn_card - gn_ref) / gn_ref,
                            abs(gn_cpu - gn_ref) / gn_ref))
        for key, (p0, m0, v0) in start.items():
            g = {n: (run[key][1] - b1 * m0) / (1 - b1)
                 for n, run in (("card", card), ("card64", card64),
                                ("ref", ref), ("cpu", cpu))}
            out["fp64"] = max(out["fp64"], dist(g["card64"], g["ref"]))
            worst("grad/" + key, (dist(g["card"], g["ref"]),
                                  dist(g["cpu"], g["ref"])))
            unit = TRAIN_TOL * lr + 2.0 ** -22 * p0.abs()
            step_card = card[key][0] - p0
            held = g["ref"].abs() > TRAIN_NOISE * (g["cpu"] - g["ref"]
                                                   ).abs().max()
            if held.any():
                err = (step_card - (ref[key][0] - p0)).abs() / unit
                out["update"] = max(out["update"], float(err[held].max()))
            out["masked"][0] += int(held.sum())
            out["masked"][1] += held.numel()
            # the float64 AdamW of the card's own gradients
            gc = g["card"]
            m1 = b1 * m0 + (1 - b1) * gc
            v1 = b2 * v0 + (1 - b2) * gc * gc
            delta = (m1 / bc1) / (torch.sqrt(v1 / bc2) + opt.eps)
            if p0.ndim >= 2:
                delta = delta + opt.weight_decay * p0
            out["adam"] = max(out["adam"], float(
                ((step_card + lr * delta).abs() / unit).max()))
    out["masked"] = out["masked"][0] / out["masked"][1]
    return out


def train_fp32_noise(res: dict) -> float:
    """The fp32 noise of this run's gradients: the CPU's largest distance
    to the referee over the leaves and the grad norm. One leaf's CPU
    distance is one draw of the rounding, not a bound on it: where
    attention saturates (the 100m config's init) the fp32 forward itself
    is ~1e-4 off float64 on either device, and a leaf's or the norm's
    error lands anywhere up to that noise (a grad norm's errors may cancel
    on one device and not on the other)."""
    return max(v[1] for key, v in res.items()
               if key == "grad_norm" or key.startswith("grad/"))


def train_parity_ok(res: dict) -> bool:
    """The card's train steps agree with the CPU's: the fp32 losses within
    TRAIN_TOL; in float64 the card's gradients meet the referee's within
    TRAIN_FP64_TOL (the card computes the referee's function); in fp32 its
    gradients (each leaf) and grad norms no further from the referee than
    TRAIN_REFEREE_FACTOR times the run's fp32 noise (``train_fp32_noise``;
    or TRAIN_TOL, whichever is larger); its param updates within TRAIN_TOL
    of the lr (plus fp32's rounding of the param) of the referee's
    wherever the referee's gradient stands above the fp32 noise, and of
    the float64 AdamW of its own gradients everywhere."""
    bound = max(TRAIN_TOL, TRAIN_REFEREE_FACTOR * train_fp32_noise(res))
    return (res["loss"] <= TRAIN_TOL and res["fp64"] <= TRAIN_FP64_TOL
            and res["update"] <= 1.0 and res["adam"] <= 1.0 and all(
                v[0] <= bound for key, v in res.items()
                if key == "grad_norm" or key.startswith("grad/")))


def train_parity_text(res: dict) -> str:
    pairs = [(k, v) for k, v in res.items() if k.startswith("grad/")]
    worst = max(pairs, key=lambda kv: kv[1][0] / max(kv[1][1], TRAIN_TOL))
    return (f"loss max |card - CPU| / |CPU| {res['loss']:.6g} (tolerance "
            f"{TRAIN_TOL}); float64 card against the float64 CPU referee: "
            f"gradients {res['fp64']:.6g} (tolerance {TRAIN_FP64_TOL}); fp32 "
            f"against the referee, 2-norm (card, CPU): grad_norm "
            f"({res['grad_norm'][0]:.6g}, {res['grad_norm'][1]:.6g}), "
            f"gradients: the card's worst leaf against its CPU's {worst[0]} "
            f"({worst[1][0]:.6g}, {worst[1][1]:.6g}), the largest card "
            f"distance {max(v[0] for _, v in pairs):.6g}, CPU "
            f"{max(v[1] for _, v in pairs):.6g} (bound: {TRAIN_REFEREE_FACTOR}"
            f" x the fp32 noise {train_fp32_noise(res):.6g}, at least "
            f"{TRAIN_TOL}); param updates (in units of "
            f"{TRAIN_TOL} x lr + 2^-22 |param|, <= 1): against the "
            f"referee's {res['update']:.6g} on the {res['masked']:.4f} of "
            f"elements whose gradient stands above {TRAIN_NOISE} x the "
            f"CPU's error, against AdamW of the card's own gradients "
            f"{res['adam']:.6g}; MoE dispatches routed alike on all four "
            f"runs: {res['routes']}; within bounds: {train_parity_ok(res)}")

def phase_train(card):
    """Dedup-gated LM training on the card (``repro_torch.launch.train``):
    the ``100m`` trainer at full width and depth with an injected fault,
    its dedup weights against a CPU replay and against the corpus's replay
    truth, hashmix at its shape against the plain version, an fp32 2-layer
    copy of its config and deepseek's smoke config stepped on the card
    and on the CPU, qwen3-8b's and mixtral-8x7b's train_4k steps at full
    width and a cut depth, deepseek-v2-236b's routed backward at 2 layers
    and its train_4k step at 1. -> (the trainer's and the MoE parts'
    kernel launches, hashmix's largest difference from its plain version,
    the trainer's data, dedup stage and step for the "mesh" phase)."""
    import torch
    from repro_torch.configs import LMArch, get_arch
    from repro_torch.core import DedupConfig, hashing, u32
    from repro_torch.data.lm import seq_keys
    from repro_torch.dedup import DedupPipeline
    from repro_torch.dedup.metrics import fpr_fnr
    from repro_torch.kernels.fused_template import bitset_step, counter_step
    from repro_torch.kernels.hashmix import hashmix, hashmix_plain
    from repro_torch.launch.train import PRESETS, build, preset_config
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import global_norm, init_opt_state
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 is fp32
    laps = [time.perf_counter()]

    def lap(what):
        laps.append(time.perf_counter())
        log(f"[train] {what}: {laps[-1] - laps[-2]:.1f} s")

    # 1. the 100m trainer, the reference test's schedule at full width
    p = PRESETS[TRAIN_PRESET]
    counters = (hashmix, bitset_step, counter_step)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as ckpt:
        trainer = build(TRAIN_PRESET, TRAIN_STEPS, TRAIN_DUP_FRAC, ckpt,
                        fault_at=TRAIN_FAULT_AT, seed=SEED)
        probe = TrainProbe(trainer)
        n_params = sum(x.numel() for x in trainer.params.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        summary = trainer.run()
        t_run = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated()
        latest = trainer.ckpt.latest_step()
        n_calls = sum(ev[0] == "process" for ev in probe.events)
        # one more step, profiled (its launches come after the count)
        batch = next(trainer.data)
        busy, n_ops, n_k, top = profile_train_step(
            lambda: float(trainer._one_step(batch)["loss"]))
    dcfg = trainer.dedup.cfg
    restores = [ev for ev in probe.events if ev[0] == "restore"]
    calls = [ev for ev in probe.events if ev[0] == "process"]
    losses = [h["loss"] for h in trainer.history]
    steps_ms = sorted(h["dt"] * 1e3 for h in trainer.history)
    step_ms = steps_ms[len(steps_ms) // 2]
    draws = probe.draws
    init_s = draws[0] - float(np.median(draws[1:]))
    log(f"[train] train-{TRAIN_PRESET}-dedup-rlbsbf-1M: {n_params} "
        f"parameters ({p['n_layers']} layers, d {p['d_model']}, "
        f"{p['n_heads']} heads, d_ff {p['d_ff']}, vocab {p['vocab']}, seq "
        f"{p['seq']}, batch {p['batch']}, fp32, TF32 off), AdamW; dedup "
        f"{dcfg.variant} {dcfg.effective_layout} (k={dcfg.k}, s={dcfg.s}) "
        f"mode drop: {summary['steps']} steps in {t_run:.1f} s with a fault "
        f"at step index {TRAIN_FAULT_AT}; latest checkpoint {latest}; "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"{summary['stragglers']} stragglers flagged; kernel launches "
        f"{launches} for {n_calls} dedup calls; peak device memory "
        f"{peak / 2**30:.3f} GiB ({card})")
    tokens = p["batch"] * p["seq"]
    log(f"[train] step ms (host clock ending in the loss read, so in "
        f"torch.cuda.synchronize's place): median {step_ms:.4f}, min "
        f"{steps_ms[0]:.4f}, max {steps_ms[-1]:.4f} over "
        f"{len(steps_ms)} steps; {tokens * 1e3 / step_ms:.1f} tokens/s in "
        f"the step, {tokens / (step_ms / 1e3 + float(np.median(draws[1:]))):.1f}"
        f" with the data draw; matmul bound "
        f"{train_bound_ms(preset_config(TRAIN_PRESET), p['batch'], p['seq'], PEAK_FLOPS_FP32):.4f}"
        f" ms (fp32 at 67 TFLOP/s, TF32 off) ({card})")
    log(f"[train] data (host, numpy; the reference's BigramCorpus over vocab "
        f"{p['vocab']}): corpus init {init_s:.2f} s (first draw "
        f"{draws[0]:.2f} s minus the median draw); "
        f"{float(np.median(draws[1:])):.4f} s per batch of {p['batch']} x "
        f"{p['seq'] + 1} tokens (median of {len(draws) - 1})")
    log(f"[train] checkpoints: saves {[round(s, 3) for s in probe.saves]} s; "
        f"restores {[(ev[1], ev[2], round(ev[3], 3)) for ev in restores]} "
        f"(step, restored, s)")
    if busy is None:
        log("[train] the profiler recorded no device time: device busy "
            "share of a step not measured")
    else:
        log(f"[train] one step profiled: device busy {busy:.4f} ms in {n_k} "
            f"kernels, idle share {max(0.0, 1 - busy / step_ms):.4f} of the "
            f"median unprofiled step; {n_ops} aten ops on the host; "
            f"costliest kernels (ms, launches) {top} ({card})")
    # the dedup stage: a CPU replay, and the corpus's own replay truth
    lineage = probe.lineage()
    cpu_w = replay_dedup_on_cpu(dcfg, probe.events)
    w_equal = len(cpu_w) == len(lineage) and all(
        np.array_equal(a, w) for a, (_, w, _) in zip(cpu_w, lineage))
    rep = np.concatenate([w == 0 for _, w, _ in lineage])
    truth = np.concatenate([t for _, _, t in lineage])
    fpr, fnr = fpr_fnr(rep, truth)
    log(f"[train] dedup: {int(rep.sum())} of {rep.size} records dropped "
        f"(weight 0) in {len(lineage)} calls, {int(truth.sum())} true "
        f"replays in the filter's lineage; FPR {fpr:.6g}, FNR {fnr:.6g}; "
        f"weights equal to the CPU replay (hashmix's plain version) bit for "
        f"bit: {w_equal}")
    ok = (summary["steps"] == TRAIN_STEPS and latest == TRAIN_STEPS
          and all(np.isfinite(losses)) and len(restores) == 1
          and restores[0][2] and restores[0][1] == 10 and w_equal
          and rep.sum() > 0 and fpr <= 0.01 and fnr <= 0.05
          and launches == {"hashmix": n_calls, "bitset_step": 0,
                           "counter_step": 0})
    if not ok:
        raise AssertionError("train: the 100m trainer is out of bounds")
    lap("the 100m trainer")

    # 2. hashmix at the trainer's shape against its plain version
    seeds = u32.from_numpy_u32(hashing.derive_seeds(dcfg.seed, dcfg.k, 0),
                               "cpu")
    hk = u32.from_numpy_u32(calls[0][1], "cuda")
    got_h = hashmix(hk, seeds, s=dcfg.s)
    want_h = hashmix_plain(hk, seeds.cuda(), dcfg.s)
    hash_err = abs_err(got_h, want_h)
    log(f"[train] hashmix at this path's shape (B={hk.shape[0]}, "
        f"k={dcfg.k}, s={dcfg.s}): exactly equal to the plain version "
        f"{torch.equal(got_h, want_h)}")
    if not torch.equal(got_h, want_h) or hk.shape[0] != p["batch"]:
        raise AssertionError("train: hashmix disagrees with its plain "
                             "version")
    keep = (trainer.data, trainer.dedup, trainer.train_step)
    del trainer, probe
    torch.cuda.empty_cache()

    # 3. the card against the CPU: a 2-layer copy of the config in lockstep
    c2 = dataclasses.replace(preset_config(TRAIN_PRESET), n_layers=2)
    rng = np.random.default_rng(SEED + 21)
    b2, s2 = TRAIN_CPU
    batches = [(rng.integers(0, c2.vocab, (b2, s2 + 1)).astype(np.int32),
                np.array([1.0, 0.0] + [1.0] * (b2 - 2), np.float32))
               for _ in range(TRAIN_CPU_STEPS)]
    t0 = time.perf_counter()
    res = train_card_vs_cpu(c2, batches)
    log(f"[train] card == CPU ({c2.n_layers} layers of the "
        f"{TRAIN_PRESET} config at full width, {c2.param_count()} "
        f"parameters, {TRAIN_CPU_STEPS} AdamW steps of B {b2}, S {s2} in "
        f"lockstep, one record weighted 0, fp32 with TF32 off and float64;"
        f" {time.perf_counter() - t0:.1f} s): "
        f"{train_parity_text(res)}")
    if not train_parity_ok(res):
        raise AssertionError("train: the card's train steps disagree "
                             "with the CPU's")
    # the same check at an MoE smoke config, the routes held equal first
    aid, bm, sm, accum = MOE_LOCKSTEP
    mcfg = get_arch(aid).smoke()
    batches = [(rng.integers(0, mcfg.vocab, (bm, sm + 1)).astype(np.int32),
                np.array([1.0, 0.0] + [1.0] * (bm - 2), np.float32))
               for _ in range(TRAIN_CPU_STEPS)]
    t0 = time.perf_counter()
    res = train_card_vs_cpu(mcfg, batches, accum)
    n_moe = mcfg.n_layers - mcfg.first_dense_layers
    log(f"[train] card == CPU ({aid} smoke config: MLA, {mcfg.n_experts} "
        f"routed experts top-{mcfg.moe_top_k}, {mcfg.n_shared_experts} "
        f"shared, {mcfg.first_dense_layers} dense first layer, "
        f"{mcfg.param_count()} parameters; {TRAIN_CPU_STEPS} AdamW steps of"
        f" B {bm}, S {sm} at accumulation {accum} in lockstep, one record "
        f"weighted 0, fp32 with TF32 off and float64; "
        f"{time.perf_counter() - t0:.1f} s): {train_parity_text(res)}")
    if not (train_parity_ok(res)
            and res["routes"] == TRAIN_CPU_STEPS * accum * n_moe):
        raise AssertionError(f"train: the card's {aid} train steps "
                             f"disagree with the CPU's")
    torch.cuda.empty_cache()
    lap("fp32 card against the CPU")

    # 4. qwen3-8b's train_4k step at full width, the depth cut
    arch = get_arch(LM_ARCH)
    qcfg = dataclasses.replace(arch.cfg, n_layers=QWEN_TRAIN_LAYERS)
    lm = LMArch(LM_ARCH, qcfg, accum=arch.accum)
    bq, sq = QWEN_TRAIN
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    qparams = tfm.init(qcfg, SEED)
    qstate = init_opt_state(lm.opt_config(), qparams)
    qstep = lm.step("train_4k")
    n_q = sum(x.numel() for x in qparams.parameters())
    pipe = DedupPipeline(DedupConfig.for_variant(
        "rlbsbf", memory_bits=1 << 20, batch_size=bq), mode="drop")
    rng = np.random.default_rng(SEED + 22)
    prev, q_ms, q_loss, q_gn, dropped = None, [], [], [], 0
    for i in range(QWEN_TRAIN_STEPS + 1):
        toks = rng.integers(0, qcfg.vocab, (bq, sq + 1)).astype(np.int32)
        if prev is not None:
            toks[2] = prev[0]                 # a replayed document
        prev = toks
        w = pipe.process({"key": seq_keys(toks)}).weights
        dropped += int((w == 0).sum())
        tt = torch.from_numpy(toks).cuda()
        if i == QWEN_TRAIN_STEPS:            # the profiled extra step
            break
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qparams, qstate, m = qstep(qparams, qstate, tt, w)
        q_loss.append(float(m["loss"]))
        q_gn.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        q_ms.append((time.perf_counter() - t0) * 1e3)
    peak_q = torch.cuda.max_memory_reserved()
    total = torch.cuda.get_device_properties(0).total_memory
    qbusy, _, q_k, q_top = profile_train_step(
        lambda: float(qstep(qparams, qstate, tt, w)[2]["loss"]),
        host_ops=False)
    accum = arch.accum["train_4k"]
    log(f"[train] train_4k-{LM_ARCH}-{QWEN_TRAIN_LAYERS}L: d "
        f"{qcfg.d_model}, {qcfg.n_heads} / {qcfg.n_kv_heads} heads, hd "
        f"{qcfg.hd}, d_ff {qcfg.d_ff}, vocab {qcfg.vocab}, {qcfg.dtype}, "
        f"remat {qcfg.remat}, {QWEN_TRAIN_LAYERS} of {arch.cfg.n_layers} "
        f"layers ({n_q} parameters), batch {bq} of seq {sq} in {accum} "
        f"microbatches; weights from DedupPipeline(rlbsbf 2^20, drop) over "
        f"seq_keys, {dropped} replayed record(s) dropped: losses "
        f"{[round(x, 4) for x in q_loss]}, grad norms "
        f"{[round(x, 4) for x in q_gn]}; step ms {[round(x, 1) for x in q_ms]}"
        f" (host clock ending in torch.cuda.synchronize), "
        f"{bq * sq * 1e3 / q_ms[-1]:.1f} tokens/s; matmul bound "
        f"{train_bound_ms(qcfg, bq, sq, PEAK_FLOPS_BF16):.4f} ms (bf16 at "
        f"{PEAK_FLOPS_BF16 / 1e12:g} TFLOP/s); peak device "
        f"memory reserved {peak_q / 2**30:.3f} GiB of "
        f"{total / 2**30:.3f} GiB ({card})")
    if qbusy is None:
        log("[train] qwen3-8b step: device busy share not measured")
    else:
        log(f"[train] qwen3-8b step profiled: device busy {qbusy:.4f} ms in "
            f"{q_k} kernels, idle share {max(0.0, 1 - qbusy / q_ms[-1]):.4f}"
            f" of the last unprofiled step; costliest kernels (ms, "
            f"launches) {q_top} ({card})")
    if not (all(np.isfinite(q_loss)) and all(np.isfinite(q_gn))
            and dropped >= 1 and total - peak_q >= FREE_BYTES):
        raise AssertionError("train: qwen3-8b train_4k is out of bounds")
    del qparams, qstate, qstep
    torch.cuda.empty_cache()
    lap("qwen3-8b train_4k")

    # 5. - 6. the MoE LMs at full width: batches cut from the phase's
    # corpus, weights from the dedup stage (one hashmix launch per call)
    data, last, n_dedup = keep[0], None, 0
    for c in counters:
        c.launches = 0

    def corpus_batch(b, s):
        """(b, s + 1) tokens on the card, cut from the corpus's next batch
        (its sequences laid end to end; row 2 a replay of the previous
        cut's row 0), and their dedup weights."""
        nonlocal last, n_dedup
        flat = next(data)["tokens"].reshape(-1)
        if flat.size < b * (s + 1):
            raise AssertionError("train: a corpus batch is too short")
        toks = flat[:b * (s + 1)].reshape(b, s + 1).copy()
        if last is not None:
            toks[2] = last
        last = toks[0].copy()
        n_dedup += 1
        w = pipe.process({"key": seq_keys(toks)}).weights
        return torch.from_numpy(toks).cuda(), w

    # 5. mixtral-8x7b's train_4k step, the depth cut
    arch = get_arch("mixtral-8x7b")
    n_l = MIXTRAL_TRAIN_LAYERS
    mcfg = dataclasses.replace(arch.cfg, n_layers=n_l)
    n_m = mcfg.param_count()
    n_next = dataclasses.replace(arch.cfg, n_layers=n_l + 1).param_count()
    log(f"[train] mixtral-8x7b depth: {n_l} of {arch.cfg.n_layers} layers, "
        f"{n_m} parameters x {STATE_BYTES} B (bf16 param and gradient, fp32"
        f" accumulation buffer, m and v) = {n_m * STATE_BYTES / 1e9:.1f} GB "
        f"of training state of the card's {total / 1e9:.1f} GB; {n_l + 1} "
        f"layers would hold {n_next * STATE_BYTES / 1e9:.1f} GB, leaving "
        f"{(total - n_next * STATE_BYTES) / 1e9:.1f} GB for activations, "
        f"AdamW's temporaries and the {FREE_BYTES / 1e9:.0f} GB kept free")
    lm = LMArch("mixtral-8x7b", mcfg, accum=arch.accum)
    bm, sm = MOE_TRAIN
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mparams = tfm.init(mcfg, SEED)
    mstate = init_opt_state(lm.opt_config(), mparams)
    mstep = lm.step("train_4k")
    m_ms, m_loss, m_gn = [], [], []
    for i in range(MOE_TRAIN_STEPS + 1):
        tt, w = corpus_batch(bm, sm)
        if i == MOE_TRAIN_STEPS:              # the profiled extra step
            break
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded_routes() as calls:
            mparams, mstate, m = mstep(mparams, mstate, tt, w)
            m_loss.append(float(m["loss"]))
        if i == 0:
            first = calls
        m_gn.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        m_ms.append((time.perf_counter() - t0) * 1e3)
    peak_m = torch.cuda.max_memory_reserved()
    # the card alone: recording the step's ~88000 host ops took time the
    # "examples" phase needed
    mbusy, _, m_k, m_top = profile_train_step(
        lambda: float(mstep(mparams, mstate, tt, w)[2]["loss"]),
        host_ops=False)
    accum = arch.accum["train_4k"]
    # per microbatch each MoE layer routes once forward and once more
    # where remat "full" recomputes it in the backward
    per_mb = n_l * (2 if mcfg.remat == "full" else 1)
    fwd = [c for i, c in enumerate(first) if i % per_mb < n_l]
    drops = [[sum(group_drops(*fwd[mb * n_l + j])) for mb in range(accum)]
             for j in range(n_l)]
    pairs = (bm // accum) * sm * mcfg.moe_top_k
    log(f"[train] train_4k-mixtral-8x7b-{n_l}L: d {mcfg.d_model}, "
        f"{mcfg.n_heads} / {mcfg.n_kv_heads} heads, {mcfg.n_experts} "
        f"experts top-{mcfg.moe_top_k} of d_ff {mcfg.d_ff_expert}, "
        f"{mcfg.moe_dispatch} dispatch at capacity factor "
        f"{mcfg.capacity_factor}, vocab {mcfg.vocab}, {mcfg.dtype}, remat "
        f"{mcfg.remat}, {n_l} of {arch.cfg.n_layers} layers ({n_m} "
        f"parameters), batch {bm} of seq {sm} in {accum} microbatches; "
        f"weights from the dedup stage: losses "
        f"{[round(x, 4) for x in m_loss]}, grad norms "
        f"{[round(x, 4) for x in m_gn]}; step ms "
        f"{[round(x, 1) for x in m_ms]} (host clock ending in "
        f"torch.cuda.synchronize), {bm * sm * 1e3 / m_ms[-1]:.1f} tokens/s;"
        f" matmul bound {train_bound_ms(mcfg, bm, sm, PEAK_FLOPS_BF16):.4f}"
        f" ms (bf16 at {PEAK_FLOPS_BF16 / 1e12:g} TFLOP/s, the top-"
        f"{mcfg.moe_top_k} experts per token); (token, slot) pairs dropped "
        f"in the first step per MoE layer and microbatch {drops} of {pairs}"
        f" each; peak device memory reserved {peak_m / 2**30:.3f} GiB of "
        f"{total / 2**30:.3f} GiB ({card})")
    if mbusy is None:
        log("[train] mixtral-8x7b step: device busy share not measured")
    else:
        log(f"[train] mixtral-8x7b step profiled: device busy {mbusy:.4f} ms"
            f" in {m_k} kernels, idle share "
            f"{max(0.0, 1 - mbusy / m_ms[-1]):.4f} of the last unprofiled "
            f"step; costliest kernels (ms, launches) "
            f"{m_top} ({card})")
    if not (all(np.isfinite(m_loss)) and all(np.isfinite(m_gn))
            and total - peak_m >= FREE_BYTES and len(fwd) == accum * n_l):
        raise AssertionError("train: mixtral-8x7b train_4k is out of "
                             "bounds")
    del mparams, mstate, mstep, calls, first, fwd, m
    torch.cuda.empty_cache()
    lap("mixtral-8x7b train_4k")

    # 6a. deepseek-v2-236b: one microbatch's loss and gradients through a
    # routed layer, two groups of its moe_group_size
    arch = get_arch("deepseek-v2-236b")
    n_l, bd, sd = DEEPSEEK_GRAD
    dcfg2 = dataclasses.replace(arch.cfg, n_layers=n_l)
    n_d2 = dcfg2.param_count()
    n_d1 = dataclasses.replace(arch.cfg,
                               n_layers=DEEPSEEK_STEP[0]).param_count()
    log(f"[train] deepseek-v2-236b depth: at {n_l} layers (its dense first "
        f"layer and one routed layer) {n_d2} parameters x {STATE_BYTES} B "
        f"= {n_d2 * STATE_BYTES / 1e9:.1f} GB of training state, "
        f"{'more than' if n_d2 * STATE_BYTES > total else 'within'} the "
        f"card's {total / 1e9:.1f} GB, so the whole AdamW step at a routed "
        f"depth waits for more than one card; that depth's forward "
        f"and backward hold its bf16 parameters and gradients, "
        f"{n_d2 * 4 / 1e9:.1f} GB; at {DEEPSEEK_STEP[0]} layer (the dense "
        f"MLA layer) the whole step holds {n_d1} x {STATE_BYTES} B = "
        f"{n_d1 * STATE_BYTES / 1e9:.1f} GB")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dparams = tfm.init(dcfg2, SEED)
    tt, w = corpus_batch(bd, sd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_routes() as calls:
        loss = tfm.forward(dcfg2, dparams, tt, w)[0]
        grads = torch.autograd.grad(loss, list(dparams.parameters()))
    d_gn = float(global_norm(list(grads)))
    d_ms = (time.perf_counter() - t0) * 1e3
    d_finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]
                                ).all()) and bool(torch.isfinite(loss))
    d_loss = float(loss)
    peak_d = torch.cuda.max_memory_reserved()
    ids, cap, n_e = calls[0]
    g_drops = group_drops(ids, cap, n_e)
    del loss, grads                       # the profiled one makes its own

    def backward():
        out = torch.autograd.grad(tfm.forward(dcfg2, dparams, tt, w)[0],
                                  list(dparams.parameters()))
        return float(out[0].float().norm())

    dbusy, _, d_k, _ = profile_train_step(backward, host_ops=False)
    d_busy, d_idle = ("not measured",) * 2 if dbusy is None else (
        f"{dbusy:.4f} ms", f"{max(0.0, 1 - dbusy / d_ms):.4f}")
    log(f"[train] train_4k-deepseek-v2-236b-{n_l}L backward: d "
        f"{dcfg2.d_model}, MLA (q_lora {dcfg2.q_lora_rank}, kv_lora "
        f"{dcfg2.kv_lora_rank}), {dcfg2.n_experts} routed experts top-"
        f"{dcfg2.moe_top_k} of d_ff {dcfg2.d_ff_expert} and "
        f"{dcfg2.n_shared_experts} shared, capacity factor "
        f"{dcfg2.capacity_factor}, moe_group_size {dcfg2.moe_group_size}, "
        f"{dcfg2.dtype}, remat {dcfg2.remat} ({n_d2} parameters); one "
        f"microbatch of {bd} x {sd} = {bd * sd} tokens through tfm.forward "
        f"and autograd, no optimizer: loss {d_loss:.4f}, grad norm "
        f"{d_gn:.4f}, loss and every gradient finite: {d_finite}; the "
        f"routed layer in {ids.shape[0]} groups of {ids.shape[1]} tokens, "
        f"capacity {cap}, (token, slot) pairs dropped per group {g_drops} "
        f"of {ids.shape[1] * ids.shape[2]} each; {d_ms:.1f} ms (host clock "
        f"ending in the grad norm read); matmul bound (forward and "
        f"backward) {train_bound_ms(dcfg2, bd, sd, PEAK_FLOPS_BF16):.4f} ms;"
        f" one more profiled: device busy {d_busy} in {d_k} kernels, idle "
        f"share {d_idle}; peak device memory reserved "
        f"{peak_d / 2**30:.3f} GiB ({card})")
    if not (d_finite and np.isfinite(d_gn) and ids.shape[0] == 2
            and len(calls) == (2 if dcfg2.remat == "full" else 1)):
        raise AssertionError("train: deepseek-v2-236b's routed backward is "
                             "out of bounds")
    del dparams, calls, ids
    torch.cuda.empty_cache()
    lap("deepseek-v2-236b routed backward")

    # 6b. its whole train_4k step at the depth of its dense MLA layer
    n_l, bd, sd = DEEPSEEK_STEP
    dcfg1 = dataclasses.replace(arch.cfg, n_layers=n_l)
    lm = LMArch("deepseek-v2-236b", dcfg1, accum=arch.accum)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dparams = tfm.init(dcfg1, SEED)
    dstate = init_opt_state(lm.opt_config(), dparams)
    dstep = lm.step("train_4k")
    d_ms, d_loss, d_gn = [], [], []
    for _ in range(DEEPSEEK_STEPS):
        tt, w = corpus_batch(bd, sd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dparams, dstate, m = dstep(dparams, dstate, tt, w)
        d_loss.append(float(m["loss"]))
        d_gn.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        d_ms.append((time.perf_counter() - t0) * 1e3)
    peak_d = torch.cuda.max_memory_reserved()
    launches_moe = {c.__name__: c.launches for c in counters}
    dbusy, _, d_k, _ = profile_train_step(
        lambda: float(dstep(dparams, dstate, tt, w)[2]["loss"]),
        host_ops=False)
    d_busy, d_idle = ("not measured",) * 2 if dbusy is None else (
        f"{dbusy:.4f} ms", f"{max(0.0, 1 - dbusy / d_ms[-1]):.4f}")
    log(f"[train] train_4k-deepseek-v2-236b-{n_l}L: {n_l} layer (the dense "
        f"MLA layer, d_ff {dcfg1.d_ff}), {dcfg1.param_count()} parameters, "
        f"AdamW on its unstacked dense_layers leaves, batch {bd} of seq "
        f"{sd} in {arch.accum['train_4k']} microbatches; weights from the "
        f"dedup stage: losses {[round(x, 4) for x in d_loss]}, grad norms "
        f"{[round(x, 4) for x in d_gn]}; step ms "
        f"{[round(x, 1) for x in d_ms]} (host clock ending in "
        f"torch.cuda.synchronize); matmul bound "
        f"{train_bound_ms(dcfg1, bd, sd, PEAK_FLOPS_BF16):.4f} ms; one "
        f"more step profiled: device busy {d_busy} in {d_k} kernels, idle "
        f"share {d_idle} of the last; peak device memory reserved "
        f"{peak_d / 2**30:.3f} GiB; kernel launches "
        f"of the MoE parts {launches_moe} for {n_dedup} dedup calls "
        f"({card})")
    if not (all(np.isfinite(d_loss)) and all(np.isfinite(d_gn))
            and launches_moe == {"hashmix": n_dedup, "bitset_step": 0,
                                 "counter_step": 0}):
        raise AssertionError("train: deepseek-v2-236b train_4k is out of "
                             "bounds")
    del dparams, dstate, dstep, m, pipe
    torch.cuda.empty_cache()
    lap("deepseek-v2-236b train_4k")
    launches = {k: v + launches_moe[k] for k, v in launches.items()}
    return launches, hash_err, keep


def phase_mesh(card, kept):
    """The 100m trainer's step placed on the local mesh over the live
    one-rank NCCL group, against the plain step; ``compressed_psum`` of
    its gradients; see the module's docstring. ``kept``: the "train"
    phase's (data, dedup stage, step). -> the kernel launches of its dedup
    calls."""
    import torch
    from repro_torch.configs import LMArch
    from repro_torch.distributed import sharding as shr
    from repro_torch.distributed.collectives import (compressed_psum,
                                                     dequantize_int8,
                                                     quantize_int8)
    from repro_torch.kernels.fused_template import bitset_step, counter_step
    from repro_torch.kernels.hashmix import hashmix
    from repro_torch.launch.analysis import analyze_step
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import preset_config
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import init_opt_state
    from repro_torch.train import jit_sharded
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 is fp32
    data, dedup, step = kept
    t_phase = time.perf_counter()
    mesh = make_local_mesh()
    cfg = preset_config(TRAIN_PRESET)
    arch = LMArch(cfg.name, cfg)
    bs = shr.transformer_batch_specs(mesh)
    specs = (arch.param_specs(mesh), arch.opt_specs(mesh), bs["tokens"],
             bs["weights"])
    log(f"[mesh] {mesh} over the NCCL group of {mesh.size()} rank(s); "
        f"specs of {cfg.name} ({cfg.param_count()} parameters): tokens "
        f"{bs['tokens']}, weights {bs['weights']}, every parameter and "
        f"moment replicated on a (1, 1) mesh")
    counters = (hashmix, bitset_step, counter_step)
    for c in counters:
        c.launches = 0
    batches = []
    for _ in range(MESH_STEPS):
        db = dedup.process(next(data))
        batches.append((torch.from_numpy(db.data["tokens"]).cuda(),
                        db.weights))
    launches = {c.__name__: c.launches for c in counters}
    if launches != {"hashmix": MESH_STEPS, "bitset_step": 0,
                    "counter_step": 0}:
        raise AssertionError(f"mesh: the dedup stage launched {launches} "
                             f"for {MESH_STEPS} calls")
    params = tfm.init(cfg, SEED + 31)
    forms = {}
    for form in ("plain", "sharded"):
        p = copy.deepcopy(params)
        o = init_opt_state(arch.opt_config(), p)
        fn = step if form == "plain" else jit_sharded(step, mesh, specs)
        losses, ms = [], []
        for t, w in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, m = fn(p, o, t, w)
            loss = m["loss"]
            losses.append(float(loss.full_tensor() if form == "sharded"
                                else loss))
            ms.append((time.perf_counter() - t0) * 1e3)
        forms[form] = (p, o, fn, losses, ms)
    del params
    (pp, _, _, l_plain, ms_plain), (ps, os_, fs, l_shard, ms_shard) = (
        forms["plain"], forms["sharded"])
    dist_p = 0.0
    for (name, a), (_, b) in zip(pp.named_parameters(),
                                 ps.named_parameters()):
        b = b.full_tensor() if hasattr(b, "full_tensor") else b
        d = float((a - b).detach().abs().max()) / max(
            float(a.detach().abs().max()), 1e-30)
        dist_p = max(dist_p, d)
    dist_l = max(abs(a - b) / abs(a) for a, b in zip(l_plain, l_shard))
    log(f"[mesh] train-{TRAIN_PRESET}-jit_sharded-1x1: {MESH_STEPS} steps "
        f"from one seeded state, fp32, TF32 off; losses plain {l_plain}, "
        f"sharded {l_shard}; step ms plain {[round(x, 1) for x in ms_plain]},"
        f" sharded {[round(x, 1) for x in ms_shard]} (host clock ending in "
        f"the loss read); largest distance of a loss {dist_l:.3g}, of a "
        f"parameter {dist_p:.3g} of its max |value| (gate 1e-5); hashmix "
        f"launches {launches['hashmix']} for {MESH_STEPS} dedup calls "
        f"({card})")
    if not (dist_l <= MESH_TOL and dist_p <= MESH_TOL
            and all(np.isfinite(l_shard))):
        raise AssertionError("mesh: the sharded step disagrees with the "
                             "plain one")
    del forms, pp
    t, w = batches[-1]
    busy, _, n_k, top = profile_train_step(
        lambda: float(fs(ps, os_, t, w)[2]["loss"].full_tensor()),
        host_ops=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    float(fs(ps, os_, t, w)[2]["loss"].full_tensor())
    one_ms = (time.perf_counter() - t0) * 1e3
    if busy is None:
        log("[mesh] the profiler recorded no device time: the sharded "
            "step's idle share not measured")
    else:
        log(f"[mesh] one sharded step profiled: device busy {busy:.4f} ms "
            f"in {n_k} kernels, idle share {max(0.0, 1 - busy / one_ms):.4f}"
            f" of an unprofiled sharded step of {one_ms:.1f} ms; costliest "
            f"kernels (ms, launches) {top} ({card})")
    res = analyze_step(fs.placed, fs.place(ps, os_, t, w))
    log(f"[mesh] analyze_step on the sharded step: collectives_counts "
        f"{res['collectives_counts']}, collectives_bytes "
        f"{res['collectives_bytes']}, flops {res['cost']['flops']:.4g}, "
        f"bytes_accessed {res['cost']['bytes_accessed']:.4g}, memory "
        f"{res['memory']}, {res['run_s']:.1f} s under the counters "
        f"({card})")
    del res
    # compressed_psum over the mesh's "data" group of one rank
    p = tfm.init(cfg, SEED + 31)
    names = [n for n, _ in p.named_parameters()]
    loss, _ = tfm.forward(cfg, p, t, w)
    grads = dict(zip(names, torch.autograd.grad(loss, list(p.parameters()))))
    synced, err = compressed_psum(grads, mesh.get_group("data"))
    exact = all(torch.equal(synced[n], dequantize_int8(*quantize_int8(g)))
                for n, g in grads.items())
    finite = all(bool(torch.isfinite(e).all()) for e in err.values())
    n_values = sum(g.numel() for g in grads.values())
    log(f"[mesh] compressed_psum of the {TRAIN_PRESET} gradients "
        f"({len(grads)} leaves, {n_values} values, all-reduced as int32 "
        f"accumulators and one fp32 max per leaf) over the mesh's "
        f"\"data\" group of {mesh.size(0)}: equal bit for bit to quantize "
        f"then dequantize {exact}, error state finite {finite} "
        f"({time.perf_counter() - t_phase:.1f} s in the phase; {card})")
    if not (exact and finite):
        raise AssertionError("mesh: compressed_psum is not the one-rank "
                             "form of the reference's formula")
    del p, grads, synced, err, loss, ps, os_, fs, batches
    torch.cuda.empty_cache()
    mesh_checks_on_cpu()
    log(f"[mesh] the phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return launches


def mesh_checks_on_cpu() -> dict:
    """``repro_torch.launch.meshcheck``'s six parts, each a process of
    its own (the steps' four gloo ranks and the head check's four traces
    theirs), all at once on this
    machine's CPU with no card visible: the sharding checks run under
    this machine's torch, port against port. Fails on any miss."""
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    procs = {part: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.meshcheck", "--part",
         part], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for part in MESH_CHECK_PARTS}
    res, errs = {}, {}
    try:
        for part, p in procs.items():
            out, err = p.communicate(timeout=MESH_CHECK_TIMEOUT)
            lines = out.strip().splitlines()
            if p.returncode or not lines:
                errs[part] = f"exit {p.returncode}: {err[-3000:]}"
            res[part] = json.loads(lines[-1])[part] if lines else {}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    steps, traces, moe, attn, depth, memory = (res.get(p, {})
                                               for p in MESH_CHECK_PARTS)
    import torch
    log(f"[mesh] on this machine's CPU, by design (torch {torch.__version__}"
        f"; no card): the (2, 2) gloo steps, sharded vs plain, largest "
        f"distances of max |value| {steps.get('distances')}; index ops "
        f"passed on to DTensor's dispatch {steps.get('unhandled')} "
        f"({steps.get('s')} s)")
    dec = traces.get("decode", {})
    temp = dec.get("temp_bytes", 0)
    log(f"[mesh] fake-world traces on the CPU: {traces.get('cells')}; "
        f"qwen3-8b decode_32k flops {dec.get('flops')} against the shape "
        f"count {dec.get('shape_count')} (ratio {dec.get('ratio')}), temp "
        f"{temp} B against {MESH_DECODE_TEMP} ({traces.get('s')} s)")
    log(f"[mesh] the smoke MoE train steps, fake (1, 1) -> (4, 1): "
        f"{ {a: moe[a] for a in moe if a not in ('ok', 's')} } "
        f"({moe.get('s')} s)")
    log(f"[mesh] the GQA analogs on a fake (1, 4) mesh (attention flops "
        f"plain and split, its all-gather against K and V's bytes, the "
        f"step's flops against the reference's plan): "
        f"{ {a: attn[a] for a in attn if a not in ('ok', 's')} } "
        f"({attn.get('s')} s)")
    log(f"[mesh] the per-layer count against full-depth traces of the "
        f"smoke cells (terms that differ; temp ratio): "
        f"{ {c: depth[c] for c in depth if c not in ('ok', 's')} } "
        f"({depth.get('s')} s)")
    log(f"[mesh] the smoke head check (copies of each rank's fp32 logits "
        f"the step holds, by fake mesh): "
        f"{ {m: r.get('copies') for m, r in memory.get('meshes', {}).items()} }"
        f" ({memory.get('s')} s); the six parts at once "
        f"{time.perf_counter() - t0:.1f} s")
    temp_ok = abs(temp / MESH_DECODE_TEMP - 1) <= MESH_DECODE_TEMP_TOL
    if errs or not (all(r.get("ok") for r in (steps, traces, moe, attn,
                                               depth, memory)) and temp_ok):
        raise AssertionError(f"mesh: the CPU sharding checks failed: "
                             f"{errs or 'a check missed'}")
    return res


def host_graph(n_nodes: int, n_edges: int, d_feat: int, d_out: int, seed):
    """A random graph in host CSR (``CSRGraph``): each edge's target and
    source uniform over the nodes, random normal features and targets —
    the CSR that ``CSRGraph.from_edges`` makes of ``random_graph``'s edges,
    built from the targets' counts rather than a stable sort of 10^8
    edges (a node's sources are uniform draws either way)."""
    from repro_torch.data.graphs import CSRGraph
    rng = np.random.default_rng(seed)
    counts = np.bincount(rng.integers(0, n_nodes, n_edges, dtype=np.int32),
                         minlength=n_nodes)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return CSRGraph(
        indptr=indptr,
        indices=rng.integers(0, n_nodes, n_edges, dtype=np.int32),
        feats=rng.standard_normal((n_nodes, d_feat), dtype=np.float32),
        targets=rng.standard_normal((n_nodes, d_out), dtype=np.float32))


def gnn_step_flops(cfg, n: int, e: int) -> float:
    """fp32 operations of one MeshGraphNet train step over N nodes and E
    edges: its matmuls (2 per multiply-add) forward, the blocks' forward
    again where remat is "full", and two products per matmul backward."""
    d, h = cfg.d_hidden, cfg.mlp_layers

    def mlp(d_in, d_out):        # [d_in] + [d] * h + [d_out]
        return d_in * d + (h - 1) * d * d + d * d_out

    block = e * mlp(3 * d, d) + n * mlp(2 * d, d)
    fwd = (n * mlp(cfg.d_node_in, d) + e * mlp(cfg.d_edge_in, d)
           + cfg.n_layers * block + n * mlp(d, cfg.d_out))
    remat = cfg.n_layers * block if cfg.remat == "full" else 0
    return 2.0 * (3 * fwd + remat)


def rec_forward_flops(cfg, b: int) -> float:
    """fp32 operations of one recsys forward at batch ``b``: its MLPs and
    its interaction (CIN's outer products and contractions, DLRM's
    (F+1)^2 dots, DCN-v2's cross layers), 2 per multiply-add."""
    def mlp(dims):
        return sum(a * c for a, c in zip(dims[:-1], dims[1:]))

    f, d = cfg.n_sparse, cfg.embed_dim
    d0 = cfg.d_sparse + cfg.n_dense
    if cfg.interaction == "concat":
        macs = mlp([d0, *cfg.mlp_dims, 1])
    elif cfg.interaction == "cin":
        dims = [f, *cfg.cin_dims]
        macs = mlp([d0, *cfg.mlp_dims, 1]) + sum(
            h * f * d + o * h * f * d for h, o in zip(dims[:-1], dims[1:]))
    elif cfg.interaction == "dot":
        n_f = f + 1
        macs = (mlp([cfg.n_dense, *cfg.bot_mlp_dims]) + n_f * n_f * d
                + mlp([n_f * (n_f - 1) // 2 + cfg.bot_mlp_dims[-1],
                       *cfg.mlp_dims]))
    else:
        macs = (cfg.n_cross_layers * d0 * d0 + mlp([d0, *cfg.mlp_dims])
                + d0 + cfg.mlp_dims[-1])
    return 2.0 * b * macs


def rec_serve_bytes(cfg, params, b: int) -> float:
    """Bytes one recsys forward at batch ``b`` must move: its ids and
    dense features read, one embedding row read per id, every weight
    outside the tables (and the wide tower's one column per cross) read
    once, the logits written."""
    ids = b * cfg.n_sparse * cfg.multi_hot
    dense = sum(p.numel() for n, p in params.named_parameters()
                if not n.startswith("tables.") and n != "wide")
    wide = b * (cfg.n_sparse - 1) if cfg.interaction == "concat" else 0
    return 4.0 * (ids + b * cfg.n_dense + ids * cfg.embed_dim + dense
                  + wide + b)


def cin_reckon(cfg, b: int, n_params: int, train: bool) -> tuple:
    """The least an xDeepFM cell at batch ``b`` holds at once, counted from
    its CIN's shapes before it runs. Each CIN layer materialises its outer
    product (B, H, F, D) in fp32. A train step saves every layer's for the
    backward and, at the last layer, holds that product's gradient and the
    gradient's product with one factor beside them, over 16 B per
    parameter (param, gradient, m, v). A
    forward holds two consecutive layers' (the loop's ``z`` keeps layer l's
    while l + 1's is made) over its params. -> (bytes, the count as text)."""
    dims = [cfg.n_sparse, *cfg.cin_dims]
    z = [4.0 * b * h * cfg.n_sparse * cfg.embed_dim for h in dims[:-1]]
    if train:
        state, acts = 16.0 * n_params, sum(z) + 2 * max(z)
        what = ("every layer's saved, plus the largest one's gradient and "
                "that gradient times a factor")
    else:
        state = 4.0 * n_params
        acts = max([*z, *(x + y for x, y in zip(z, z[1:]))])
        what = "two consecutive layers' at once"
    gb = [round(x / 1e9, 2) for x in z]
    return state + acts, (
        f"each CIN layer's outer product (B, H, {cfg.n_sparse}, "
        f"{cfg.embed_dim}) in fp32 at B {b}: {gb} GB; {what}: "
        f"{acts / 1e9:.2f} GB over {state / 1e9:.2f} GB of "
        f"{'params, gradients, m and v' if train else 'params'}: "
        f"{(state + acts) / 1e9:.2f} GB")


def model_card_vs_cpu(family: str, cfg, batches) -> dict:
    """A MeshGraphNet (``family`` "gnn") or recsys ("recsys") model at
    ``cfg`` from one seeded CPU init, stepped over ``batches`` [(numpy
    batch, weights (B,) or None)] on the card and on the CPU in lockstep:
    each step starts both from the CPU's state, fp32 with TF32 off, with
    the archs' AdamW (lr 1e-3, weight_decay 0). -> {"forward", "loss":
    the largest max |card - CPU| / max |CPU| over the steps; "grad": the
    same for the worst parameter's gradient, named in "grad_at"; "update":
    the largest max |card - CPU| of a parameter after the step, in units
    of GR_FWD_TOL x max |CPU param| + GR_UPDATE_LR x lr}."""
    import torch
    from repro_torch.models import gnn, recsys
    from repro_torch.models.layers import tensor_batch
    from repro_torch.optim import (OptimizerConfig, OptState, apply_updates,
                                   init_opt_state)
    torch.backends.cuda.matmul.allow_tf32 = False
    mod = gnn if family == "gnn" else recsys
    opt = OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.0)
    params = mod.init(cfg, SEED, "cpu")
    state = init_opt_state(opt, params)
    out = {"forward": 0.0, "loss": 0.0, "grad": 0.0, "grad_at": "",
           "update": 0.0}

    def rel(got, want):
        want = want.detach().cpu()
        return float((got.detach().cpu() - want).abs().max()
                     / want.abs().max().clamp_min(1e-30))

    for batch, w in batches:
        got = {}
        for dev in ("cuda", "cpu"):          # the CPU's run last: it goes on
            p, s = params, state
            if dev == "cuda":
                p = copy.deepcopy(params).to(dev)
                s = OptState(state.step.clone(),
                             _tree_to(state.m, dev, torch.float32),
                             _tree_to(state.v, dev, torch.float32))
            tb = tensor_batch(batch, dev)
            tw = None if w is None else torch.from_numpy(w).to(dev)
            with torch.no_grad():
                fwd = mod.forward(cfg, p, tb)
            loss = mod.loss_fn(cfg, p, tb, tw)
            names = [n for n, _ in p.named_parameters()]
            grads = dict(zip(names, torch.autograd.grad(
                loss, list(p.parameters()))))
            p, s, met = apply_updates(opt, p, grads, s)
            got[dev] = (fwd, loss, grads, dict(p.named_parameters()),
                        float(met["lr"]))
            if dev == "cpu":
                params, state = p, s
        (f_g, l_g, g_g, p_g, _), (f_c, l_c, g_c, p_c, lr) = (got["cuda"],
                                                            got["cpu"])
        out["forward"] = max(out["forward"], rel(f_g, f_c))
        out["loss"] = max(out["loss"], rel(l_g, l_c))
        for name, want in g_c.items():
            err = rel(g_g[name], want)
            if err >= out["grad"]:
                out["grad"], out["grad_at"] = err, name
            unit = GR_FWD_TOL * float(p_c[name].detach().abs().max()) \
                + GR_UPDATE_LR * lr
            out["update"] = max(out["update"], float(
                (p_g[name].detach().cpu() - p_c[name].detach()).abs().max())
                / unit)
    return out


def model_parity_ok(res: dict) -> bool:
    """The card agrees with the CPU: forward and loss within GR_FWD_TOL of
    the max |value|, each parameter's gradient within GR_GRAD_TOL of its
    max |g|, and each parameter after the AdamW step within GR_FWD_TOL of
    its max |value| plus GR_UPDATE_LR x the lr (where a gradient is near
    AdamW's eps, g / (|g| + eps) turns on its last digits)."""
    return (res["forward"] <= GR_FWD_TOL and res["loss"] <= GR_FWD_TOL
            and res["grad"] <= GR_GRAD_TOL and res["update"] <= 1.0)


def model_parity_text(res: dict) -> str:
    return (f"forward {res['forward']:.6g}, loss {res['loss']:.6g} (of max "
            f"|value|, tolerance {GR_FWD_TOL}); gradients {res['grad']:.6g} "
            f"at {res['grad_at']} (tolerance {GR_GRAD_TOL}); params after "
            f"AdamW {res['update']:.6g} (in units of {GR_FWD_TOL} x max "
            f"|param| + {GR_UPDATE_LR} x lr, <= 1); within bounds: "
            f"{model_parity_ok(res)}")


def smoke_batches(family: str, cfg, n: int = GR_CPU_STEPS) -> list:
    """``n`` seeded small batches of a smoke config, each with the dedup
    stage's weights (the second record dropped): MeshGraphNet's a
    ``random_graph`` and then ``NeighborSampler`` subgraphs, recsys' a
    ``CTRStream`` batch of 64 with replays."""
    from repro_torch.data import graphs, recsys_data
    out = []
    if family == "gnn":
        g = graphs.random_graph(300, 3000, cfg.d_node_in, seed=SEED + 30)
        csr = graphs.CSRGraph.from_edges(300, g["src"], g["dst"],
                                         g["nodes"], g["targets"])
        samp = graphs.NeighborSampler(csr, (5, 3), 8, seed=SEED + 31)
        for i in range(n):
            b = (graphs.random_graph(40, 120, cfg.d_node_in, seed=SEED + i)
                 if i == 0 else samp.sample())
            w = np.ones(b["nodes"].shape[0], np.float32)
            w[1] = 0.0
            out.append((b, w))
        return out
    stream = recsys_data.CTRStream(cfg.n_dense, cfg.vocab_sizes,
                                   multi_hot=cfg.multi_hot, dup_frac=0.25,
                                   seed=SEED + 32)
    for _ in range(n):
        b = stream.batch(64)
        w = np.ones(64, np.float32)
        w[1] = 0.0
        out.append(({k: b[k] for k in ("dense", "sparse_ids", "labels")},
                    w))
    return out


# ------------------------------------------------------------ examples //
def example_module(name: str):
    """``examples/<name>_torch.py`` of this checkout as a module."""
    path = os.path.join(ROOT, "examples", f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same_check(a, b) -> bool:
    """Bit-for-bit equality of two examples' check records (dicts, lists,
    arrays, numbers, strings)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_check(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            same_check(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and \
            a.tobytes() == b.tobytes()
    return a == b


def _batches(n: int, b: int) -> int:
    return -(-n // b)


# name -> (the card run's arguments past --device: the reference's size
# unless a cut is listed; the cut runs' arguments; the kernel launches the
# card run must make, from its result: "n" its records)
EXAMPLES = {
    "quickstart": (
        ["--n", EXAMPLE_QUICKSTART_N], ["--n", EXAMPLE_CUT],
        # five dense8 engines: one hashmix launch per batch of 8192
        lambda out: {"hashmix": 5 * _batches(out["n"], 8192)}),
    "click_fraud_stream": (
        [], ["--n", EXAMPLE_CUT],
        # the flag pipeline's whole batches of 4096, then one serve call
        # of 1024 per 1024 of the first 65536 keys (dense8)
        lambda out: {"hashmix": out["n"] // 4096
                     + _batches(min(64 * 1024, out["n"]), 1024)}),
    "sbf_vs_rlbsbf": (
        [], ["--n", EXAMPLE_CUT],
        # on the card a first and a timed run of each: sbf hashmix and the
        # counter step per batch, rlbsbf the bitset step per batch (planes)
        lambda out: dict.fromkeys(("hashmix", "counter_step",
                                   "bitset_step"),
                                  2 * _batches(out["n"], 8192))),
    "sliding_window_dedup": (
        [], ["--n", EXAMPLE_CUT],
        # swbf on planes, a first and a timed run of batches of 4096
        lambda out: dict.fromkeys(("hashmix", "counter_step"),
                                  2 * _batches(out["n"], 4096))),
    "count_min_heavy_hitters": (
        [], ["--n", EXAMPLE_CUT],
        # cms and hh over batches of 4096 (hashmix and the counter step
        # each), and cms's estimate of 8 keys (one hashmix)
        lambda out: {"hashmix": 2 * _batches(out["n"], 4096) + 1,
                     "counter_step": 2 * _batches(out["n"], 4096)}),
    "serving_frontend": (
        ["--n", EXAMPLE_SERVE_N, "--loop-n", EXAMPLE_LOOP_N],
        ["--n", EXAMPLE_SERVE_N, "--loop-n", EXAMPLE_LOOP_N],
        # dense8: one hashmix per micro-batch, per recorded batch replayed
        # and per synchronous serve call
        lambda out: {"hashmix": out["stats"]["batches"]
                     + len(out["schedule"]) + out["loop_n"]}),
    "dedup_training": (
        ["--steps", EXAMPLE_TRAIN_STEPS], ["--steps", EXAMPLE_TRAIN_CUT],
        # the dedup stage (dense8): one hashmix launch per step
        lambda out: {"hashmix": out["summary"]["steps"]}),
    "sharded_dedup_multidevice": (
        ["--ranks", 1], ["--n", EXAMPLE_CUT, "--ranks", 1],
        # one NCCL rank, in this process: the static dense8 step's hashmix
        # per batch, then the one-filter row's
        lambda out: {"hashmix": 2 * _batches(out["n"], 8192)}),
}


def run_example(mod, name: str, argv: list) -> tuple:
    """``main(argv)`` of an example, its printout logged line by line;
    -> (its result, seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main([str(a) for a in argv])
    dt = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        log(f"[examples] {name}: {line}")
    return out, dt


def overlap_baseline(card) -> float:
    """``hillclimb --overlap-worker`` once on the card in a subprocess
    (the dedup-overlap sweep's F0: the pipelined swbf ingest at one NCCL
    rank, best of 3); -> elems/s."""
    src = os.path.join(ROOT, "src")
    env = {**os.environ, "PYTHONPATH": src + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else "")}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.hillclimb",
         "--overlap-worker"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=OVERLAP_TIMEOUT)
    if proc.returncode != 0:
        raise RuntimeError(f"overlap worker exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    if not (rec["elems_per_s"] > 0 and math.isfinite(rec["elems_per_s"])):
        raise AssertionError(f"overlap worker: {rec}")
    log(f"[examples] hillclimb --overlap-worker (F0, the pipelined swbf "
        f"ingest, window 8, 2^20 bits, batch 16384, {rec['n']} records, "
        f"{rec['ranks']} {rec['backend']} rank(s), best of 3): "
        f"{rec['elems_per_s']:.1f} elems/s, {rec['dups']} dups; the "
        f"subprocess {time.perf_counter() - t0:.1f} s | {card}")
    return rec["elems_per_s"]


def phase_examples(card):
    """The eight examples of the port (``examples/*_torch.py``) through
    their ``main``: each on the card at the reference's size (for the
    phase's time quickstart's stream cut to ``EXAMPLE_QUICKSTART_N``
    records, the serving example to ``EXAMPLE_SERVE_N`` requests and its
    per-request loop to ``EXAMPLE_LOOP_N``, the training to
    ``EXAMPLE_TRAIN_STEPS`` steps) with its
    kernel launches counted from 0 and held to their design, then at
    a cut size (``EXAMPLE_CUT`` records, its own size where smaller; 16
    steps of training; the sharded one at one rank) on the card and with
    ``--device cpu``, whose checks must be equal bit for bit (the served
    digest: the card's recorded schedule replayed on the CPU). Then the
    hillclimb overlap worker once. -> the card runs' launches."""
    from repro_torch.kernels.fused_template import bitset_step, counter_step
    from repro_torch.kernels.hashmix import hashmix
    from repro_torch.serve import replay_schedule
    counters = (hashmix, bitset_step, counter_step)
    total = {c.__name__: 0 for c in counters}
    for name, (full_args, cut_args, want) in EXAMPLES.items():
        mod = example_module(name)
        t0 = time.perf_counter()
        for c in counters:
            c.launches = 0
        out, dt_full = run_example(mod, name, ["--device", "cuda",
                                               *full_args])
        launches = {c.__name__: c.launches for c in counters}
        expect = {**dict.fromkeys(total, 0), **want(out)}
        if launches != expect:
            raise AssertionError(f"{name}: launches {launches}, by design "
                                 f"{expect}")
        if out.get("match") is not None and not all(
                (out["match"].values() if isinstance(out["match"], dict)
                 else [out["match"]])):
            raise AssertionError(f"{name}: the card diverged from the CPU "
                                 f"in the example's own check: "
                                 f"{out['match']}")
        for k, v in launches.items():
            total[k] += v
        cut = out if cut_args == full_args else run_example(
            mod, name, ["--device", "cuda", *cut_args])[0]
        cpu, _ = run_example(mod, name, ["--device", "cpu", *cut_args])
        if not same_check(cut["check"], cpu["check"]):
            raise AssertionError(f"{name}: the card's check differs from "
                                 f"the CPU's at the cut size")
        what = ", ".join(sorted(cut["check"]))
        if name == "serving_frontend":
            replayed = replay_schedule(cut["cfg"], cut["schedule"],
                                       device="cpu")
            if replayed != cut["digest"]:
                raise AssertionError("serving_frontend: the card's digest "
                                     "differs from its schedule's replay "
                                     "on the CPU")
            what += ", the served digest (the card's schedule on the CPU)"
        log(f"[examples] {name}: the card run {dt_full:.2f} s at "
            f"{' '.join(map(str, full_args)) or 'the reference size'}; "
            f"launches {launches} as designed; card == CPU bit for bit at "
            f"{' '.join(map(str, cut_args))}: {what}; "
            f"{time.perf_counter() - t0:.1f} s in all | {card}")
    overlap_baseline(card)
    log(f"[examples] launches of the card runs: {total} | {card}")
    return total


def phase_graph_recsys(card):
    """GNN and recsys on the card: the card against the CPU at the five
    smoke configs; MeshGraphNet's minibatch_lg, full_graph_sm and
    molecule train steps at full width; the four rankers' train_batch
    steps behind the click-fraud dedup stage (xDeepFM's CIN reckoned
    first: it does not fit); each ranker's serve_p99, serve_bulk
    (xDeepFM's reckoned first) and retrieval_cand; fails unless every
    cell but xDeepFM's two ran. -> (the dedup stages' kernel
    launches, hashmix's largest difference from its plain version)."""
    import torch
    from repro_torch.configs import get_arch, pad_graph, paper_config
    from repro_torch.core import hashing, u32
    from repro_torch.data.graphs import NeighborSampler, molecule_batch, \
        random_graph
    from repro_torch.data.recsys_data import CTRStream, candidates_matrix
    from repro_torch.dedup import DedupPipeline
    from repro_torch.dedup.metrics import fpr_fnr
    from repro_torch.kernels.fused_template import bitset_step, counter_step
    from repro_torch.kernels.hashmix import hashmix, hashmix_plain
    from repro_torch.models import recsys
    from repro_torch.models.layers import tensor_batch
    from repro_torch.optim import init_opt_state
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 is fp32
    laps = [time.perf_counter()]

    def lap(what):
        laps.append(time.perf_counter())
        log(f"[graph_recsys] {what}: {laps[-1] - laps[-2]:.1f} s")

    def profiled(tag, fn, ms):
        busy, n_ops, n_k, top = profile_train_step(fn)
        if busy is None:
            log(f"[graph_recsys] {tag}: the profiler recorded no device "
                f"time: device busy share not measured")
        else:
            log(f"[graph_recsys] {tag} profiled: device busy {busy:.4f} ms "
                f"in {n_k} kernels, idle share {max(0.0, 1 - busy / ms):.4f}"
                f" of {ms:.4f} ms; {n_ops} aten ops; costliest kernels (ms,"
                f" launches) {top} ({card})")

    # 1. the card against the CPU at the smoke configs, in lockstep
    for aid in (GNN_ARCH,) + REC_ARCHS:
        arch = get_arch(aid)
        cfg = arch.smoke()
        res = model_card_vs_cpu(arch.family, cfg,
                                smoke_batches(arch.family, cfg))
        log(f"[graph_recsys] card == CPU, {aid} smoke config, "
            f"{GR_CPU_STEPS} AdamW steps in lockstep (fp32, TF32 off): "
            f"{model_parity_text(res)}")
        if not model_parity_ok(res):
            raise AssertionError(f"graph_recsys: {aid} on the card "
                                 f"disagrees with the CPU")
    lap("card against the CPU")

    # 2. MeshGraphNet at full width
    garch = get_arch(GNN_ARCH)
    gd = garch.shapes["minibatch_lg"].dims
    t0 = time.perf_counter()
    host = host_graph(gd["graph_nodes"], gd["graph_edges"], gd["d_feat"],
                      garch.base_cfg.d_out, SEED + 40)
    t_graph = time.perf_counter() - t0
    sampler = NeighborSampler(host, gd["fanout"], gd["batch_nodes"],
                              seed=SEED + 41)
    cells = {
        "minibatch_lg": (GNN_LG_STEPS, None),
        "full_graph_sm": (1, lambda: random_graph(2708, 10556, 1433,
                                                  seed=SEED + 42)),
        "molecule": (1, lambda: molecule_batch(128, 30, 64, 16,
                                               seed=SEED + 43)),
    }
    samples = []
    for shape, (n_steps, make) in cells.items():
        cfg = garch.cfg_for(shape)
        n, e = garch.padded(shape)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params = garch.params(shape, SEED)
        state = init_opt_state(garch.opt_config(), params)
        step = garch.step(shape)
        n_params = sum(p.numel() for p in params.parameters())
        ms, losses, gns, real = [], [], [], []
        for i in range(n_steps + 1):            # the last one profiled
            t0 = time.perf_counter()
            raw = sampler.sample() if make is None else make()
            if make is None:
                samples.append(time.perf_counter() - t0)
            real.append((int(raw["edge_mask"].sum()),
                         int(raw["src"].shape[0])))
            batch = tensor_batch(pad_graph(raw, n, e))
            if i == n_steps:
                break
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            gns.append(float(m["grad_norm"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        bound = gnn_step_flops(cfg, n, e) / PEAK_FLOPS_FP32 * 1e3
        log(f"[graph_recsys] {shape}-{GNN_ARCH}: {cfg.n_layers} layers, d "
            f"{cfg.d_hidden}, mlp_layers {cfg.mlp_layers}, d_feat "
            f"{cfg.d_node_in}, remat {cfg.remat}, fp32 ({n_params} "
            f"parameters); padded to {n} nodes and {e} edges, real edges "
            f"{[r[0] for r in real]}; losses {[round(x, 6) for x in losses]}"
            f", grad norms {[round(x, 6) for x in gns]}; step ms "
            f"{[round(x, 4) for x in ms]} (host clock ending in the loss "
            f"read); matmul bound {bound:.4f} ms (fp32 at 67 TFLOP/s, TF32 "
            f"off, remat counted); peak device memory {peak / 2**30:.3f} "
            f"GiB ({card})")
        profiled(f"{shape}-{GNN_ARCH} step",
                 lambda: float(step(params, state, batch)[2]["loss"]),
                 float(np.median(ms)))
        if not (all(np.isfinite(losses)) and all(np.isfinite(gns))):
            raise AssertionError(f"graph_recsys: {shape} is out of bounds")
        if make is None:
            want = gd["batch_nodes"] * sum(int(np.prod(gd["fanout"][:i + 1]))
                                           for i in range(len(gd["fanout"])))
            if not all(abs(r[0] - want) <= 0.01 * want for r in real):
                raise AssertionError("graph_recsys: the sampler's edges "
                                     "are off their bound")
        del params, state, step, batch
        torch.cuda.empty_cache()
    log(f"[graph_recsys] minibatch_lg host graph: {gd['graph_nodes']} nodes"
        f", {gd['graph_edges']} edges, {gd['d_feat']} features, built in "
        f"{t_graph:.2f} s; NeighborSampler (1024 seeds, fanout "
        f"{gd['fanout']}) {[round(x, 3) for x in samples]} s per sample")
    del host, sampler
    lap("MeshGraphNet")

    # 3. train_batch behind the click-fraud dedup stage, one model on the
    # card at a time; xDeepFM's CIN bytes reckoned before it runs
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    counters = (hashmix, bitset_step, counter_step)
    launches = {c.__name__: 0 for c in counters}
    hash_err = 0
    trained, served = [], []
    for aid, n_steps in REC_TRAIN.items():
        rarch = get_arch(aid)
        cfg = rarch.cfg
        bsz = rarch.shapes["train_batch"].dims["batch"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params = recsys.init(cfg, SEED)
        n_params = sum(p.numel() for p in params.parameters())
        if cfg.interaction == "cin":
            need, text = cin_reckon(cfg, bsz, n_params, train=True)
            log(f"[graph_recsys] train_batch-{aid} reckoned before it runs "
                f"({n_params} parameters, fp32, AdamW): {text} against the "
                f"card's {card_bytes / 1e9:.2f} GB: "
                + ("runs" if need <= card_bytes else "does not fit, not run")
                + f" ({card})")
            if need > card_bytes:
                del params
                torch.cuda.empty_cache()
                continue
        state = init_opt_state(rarch.opt_config(), params)
        step = rarch.step("train_batch")
        stream = CTRStream(cfg.n_dense, cfg.vocab_sizes,
                           dup_frac=CTR_DUP_FRAC, seed=SEED + 50)
        dcfg = paper_config("rlbsbf", MEMORY_MB, batch_size=bsz)
        pipe = DedupPipeline(dcfg, mode="drop")
        for c in counters:
            c.launches = 0
        draws, ms, losses, gns, keys, reps, w_ok = ([], [], [], [], [], [],
                                                    True)
        for i in range(n_steps + 1):            # the last one profiled
            t0 = time.perf_counter()
            raw = stream.batch(bsz)
            draws.append(time.perf_counter() - t0)
            res = pipe.process({"key": raw["key"]})
            dup = res.dup.cpu().numpy()
            w_ok &= bool(torch.equal(res.weights == 0, res.dup))
            keys.append(raw["key"])
            reps.append(dup)
            batch = tensor_batch({k: raw[k] for k in ("dense", "sparse_ids",
                                                      "labels")})
            if i == n_steps:
                break
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch, res.weights)
            losses.append(float(m["loss"]))
            gns.append(float(m["grad_norm"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        cell = {c.__name__: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated()
        all_keys = np.concatenate(keys)
        truth = np.ones(all_keys.size, bool)
        truth[np.unique(all_keys, return_index=True)[1]] = False
        rep = np.concatenate(reps)
        fpr, fnr = fpr_fnr(rep, truth)
        # every gathered table's gradient (``tables``, the wide tower's
        # ``wide``) is dense: filled with zeros before its rows are added
        n_tab = sum(p.numel() for n, p in params.named_parameters()
                    if n.startswith("tables.") or n == "wide")
        # AdamW reads p, g, m, v and writes p, m, v
        nbytes = 4.0 * (7 * n_params + n_tab)
        flops = 3 * rec_forward_flops(cfg, bsz)
        bound = max(nbytes / HBM_BW, flops / PEAK_FLOPS_FP32) * 1e3
        log(f"[graph_recsys] train_batch-{aid}-dedup-rlbsbf-256MB: "
            f"{n_params} parameters ({n_tab} in gathered tables, "
            f"{cfg.n_sparse} fields of {cfg.embed_dim}, fp32), AdamW, batch "
            f"{bsz}; CTRStream (dup_frac {CTR_DUP_FRAC}) through "
            f"DedupPipeline({dcfg.variant} {dcfg.effective_layout}, "
            f"k={dcfg.k}, s={dcfg.s}, drop): {int(rep.sum())} of {rep.size}"
            f" records dropped, {int(truth.sum())} repeated keys; FPR "
            f"{fpr:.6g}, FNR {fnr:.6g}; weights 0 exactly where dup: {w_ok};"
            f" kernel launches {cell} for {len(keys)} batches; losses "
            f"{[round(x, 6) for x in losses]}, grad norms "
            f"{[round(x, 6) for x in gns]}; step ms "
            f"{[round(x, 4) for x in ms]} (host clock ending in the loss "
            f"read); bound {bound:.4f} ms ({nbytes / 1e9:.2f} GB of AdamW "
            f"and the gradients' fill at 3.35 TB/s; {flops / 1e12:.4f} "
            f"TFLOP at 67 TFLOP/s); CTR draw {[round(x, 4) for x in draws]}"
            f" s per batch (host); peak device memory {peak / 2**30:.3f} "
            f"GiB ({card})")
        profiled(f"train_batch-{aid} step",
                 lambda: float(step(params, state, batch, res.weights)[2][
                     "loss"]), float(np.median(ms)))
        seeds = u32.from_numpy_u32(hashing.derive_seeds(dcfg.seed, dcfg.k,
                                                        0), "cpu")
        hk = u32.from_numpy_u32(keys[0], "cuda")
        got_h = hashmix(hk, seeds, s=dcfg.s)
        want_h = hashmix_plain(hk, seeds.cuda(), dcfg.s)
        hash_err = max(hash_err, abs_err(got_h, want_h))
        log(f"[graph_recsys] hashmix at this path's shape (B={hk.shape[0]},"
            f" k={dcfg.k}, s={dcfg.s}): exactly equal to the plain version "
            f"{torch.equal(got_h, want_h)}")
        if not (all(np.isfinite(losses)) and all(np.isfinite(gns)) and w_ok
                and rep.sum() > 0 and fpr <= 0.01 and fnr <= 0.05
                and cell == {"hashmix": len(keys), "bitset_step": 0,
                             "counter_step": 0}
                and torch.equal(got_h, want_h)):
            raise AssertionError(f"graph_recsys: {aid}'s gated training is "
                                 f"out of bounds")
        launches = {k: v + cell[k] for k, v in launches.items()}
        trained.append(aid)
        del params, state, step, pipe, batch, res, m, got_h, want_h, hk
        torch.cuda.empty_cache()
        lap(f"{aid} train_batch")

    # 4. serving: each ranker's serve_p99 and serve_bulk (reckoned before
    # it runs) and retrieval_cand, one model on the card at a time
    for aid in REC_ARCHS:
        arch = get_arch(aid)
        cfg = arch.cfg
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params = recsys.init(cfg, SEED)
        stream = CTRStream(cfg.n_dense, cfg.vocab_sizes, seed=SEED + 60)
        for shape in ("serve_p99", "serve_bulk"):
            b = arch.shapes[shape].dims["batch"]
            infer = arch.step(shape)
            if shape == "serve_bulk" and cfg.interaction == "cin":
                need, text = cin_reckon(cfg, b, sum(
                    p.numel() for p in params.parameters()), train=False)
                log(f"[graph_recsys] {shape}-{aid} reckoned before it runs,"
                    f" a forward: {text} against the card's "
                    f"{card_bytes / 1e9:.2f} GB: "
                    + ("runs" if need <= card_bytes
                       else "does not fit, not run") + f" ({card})")
                if need > card_bytes:
                    continue
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            raw = stream.batch(b)
            t_draw = time.perf_counter() - t0
            batch = tensor_batch({k: raw[k] for k in ("dense",
                                                      "sparse_ids")})
            out = infer(params, batch)
            torch.cuda.synchronize()
            call_ms = wall_ms(lambda i: infer(params, batch), REC_SERVE_CALLS)
            bound = max(rec_serve_bytes(cfg, params, b) / HBM_BW,
                        rec_forward_flops(cfg, b) / PEAK_FLOPS_FP32) * 1e3
            ok = out.shape == (b,) and bool(torch.isfinite(out).all())
            log(f"[graph_recsys] {shape}-{aid}: batch {b}, "
                f"{sum(p.numel() for p in params.parameters())} parameters "
                f"(fp32); logits finite of shape ({b},): {ok}; "
                f"{call_ms:.4f} ms per call (CUDA events over "
                f"{REC_SERVE_CALLS} calls); bound {bound:.4f} ms; CTR draw "
                f"{t_draw:.4f} s (host); peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
                f"({card})")
            profiled(f"{shape}-{aid} call", lambda: infer(params, batch),
                     call_ms)
            if not ok:
                raise AssertionError(f"graph_recsys: {shape}-{aid} is out "
                                     f"of bounds")
            if aid == DLRM_ARCH and shape == "serve_p99":
                with torch.inference_mode():
                    dd = recsys.forward(dataclasses.replace(
                        cfg, dedup_gather=True), params, batch)
                gerr = float((dd - out).abs().max() / out.abs().max())
                log(f"[graph_recsys] {shape}-{aid}: dedup_gather against "
                    f"the plain gather, max |diff| / max |logit| {gerr:.6g}"
                    f" (tolerance {GR_GATHER_TOL})")
                if not gerr <= GR_GATHER_TOL:
                    raise AssertionError("graph_recsys: dedup_gather "
                                         "disagrees with the plain gather")
            served.append(f"{shape}-{aid}")
            del batch, out
        d = arch.shapes["retrieval_cand"].dims
        t0 = time.perf_counter()
        cands = torch.from_numpy(candidates_matrix(
            d["n_cand"], cfg.embed_dim, seed=SEED + 61)).cuda()
        t_draw = time.perf_counter() - t0
        raw = stream.batch(d["batch"])
        batch = tensor_batch({"dense": raw["dense"],
                              "sparse_ids": raw["sparse_ids"]})
        batch["candidates"] = cands
        ret = arch.step("retrieval_cand")
        scores, top_s, top_i = ret(params, batch)
        order = torch.sort(scores, descending=True,
                           stable=True).indices[:top_i.shape[0]]
        same = bool(torch.equal(order, top_i)
                    and torch.equal(scores[order], top_s))
        call_ms = wall_ms(lambda i: ret(params, batch), REC_SERVE_CALLS)
        nbytes = 4.0 * (d["n_cand"] * cfg.embed_dim + d["n_cand"])
        bound = nbytes / HBM_BW * 1e3
        log(f"[graph_recsys] retrieval_cand-{aid}: 1 query x "
            f"{d['n_cand']} candidates of {cfg.embed_dim}, top "
            f"{top_i.shape[0]}: equal to a stable descending sort of "
            f"the card's scores: {same}; {call_ms:.4f} ms per call "
            f"(CUDA events over {REC_SERVE_CALLS} calls); bound "
            f"{bound:.4f} ms (the candidates read, the scores written);"
            f" candidates drawn in {t_draw:.2f} s (host) ({card})")
        profiled(f"retrieval_cand-{aid} call",
                 lambda: ret(params, batch), call_ms)
        if not same or not bool(torch.isfinite(scores).all()):
            raise AssertionError(f"graph_recsys: {aid} retrieval's top-k is"
                                 f" not the stable descending order")
        del cands, scores, top_s, top_i, order, params, batch
        torch.cuda.empty_cache()
    lap("serving")
    # only a CIN cell may be reckoned out; every other cell ran
    cin = {a for a in REC_ARCHS if get_arch(a).cfg.interaction == "cin"}
    must_serve = {f"{s}-{a}" for a in REC_ARCHS for s in ("serve_p99",
                                                          "serve_bulk")}
    log(f"[graph_recsys] cells run: train_batch {trained}; serving "
        f"{served}")
    if not (set(REC_TRAIN) - cin <= set(trained)
            and {f"serve_bulk-{a}" for a in cin} | set(served) >= must_serve
            and launches["hashmix"] == sum(REC_TRAIN[a] + 1
                                           for a in trained)):
        raise AssertionError("graph_recsys: a cell that must run did not")
    return launches, hash_err


def shard_run(scfg, keys, counters):
    """A ``ShardedDedup`` of ``scfg`` through ``run_stream`` over ``keys``
    from a fresh ``init()``, the launch counts set to 0 just before and
    read just after. -> dict(sd, state, dup, ovf, secs (host clock ending
    in synchronize), launches)."""
    import torch
    from repro_torch.dedup import ShardedDedup
    sd = ShardedDedup(scfg)
    state = sd.init()
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    state, dup, ovf = sd.run_stream(state, keys)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return dict(sd=sd, state=state, dup=dup, ovf=ovf, secs=secs,
                launches={c.__name__: c.launches for c in counters})


def same_state(a, b) -> bool:
    """Every leaf of two states equal, on the card."""
    import torch
    from repro_torch.distributed.sharding import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def shard_profile(run, keys, tag, card):
    """Where a sharded step's time goes: torch.profiler over a
    SHARD_PROFILE_BATCHES-batch stream continuing the run's state, for the
    device's busy time, its kernel count and the NCCL kernels' share; the
    idle share is taken against the run's own unprofiled host ms per
    step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    n_b = SHARD_PROFILE_BATCHES
    wall_ms = run["secs"] / (run["dup"].shape[0] // BATCH) * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run["sd"].run_stream(run["state"], keys[:n_b * BATCH])
        torch.cuda.synchronize()
    rows = [r for r in prof.key_averages() if str(getattr(
        r, "device_type", "")).endswith("CUDA")
        and getattr(r, "self_device_time_total", 0) > 0]
    if not rows:
        log(f"[profile] {tag}: the profiler recorded no device time: "
            f"device busy share not measured")
        return
    busy = sum(r.self_device_time_total for r in rows) / 1e3 / n_b
    nccl = sum(r.self_device_time_total for r in rows
               if "nccl" in r.key.lower()) / 1e3 / n_b
    n_kernels = sum(r.count for r in rows) / n_b
    log(f"[profile] {tag}: device busy {busy:.4f} ms per step in "
        f"{n_kernels:.1f} kernels (NCCL {nccl:.4f} ms) over {n_b} steps; "
        f"idle share {max(0.0, 1 - busy / wall_ms):.4f} of the cell's "
        f"unprofiled {wall_ms:.4f} ms per step | {card}")


def shard_cell(tag, runs, truth, card, want, extra, checks):
    """Log a shard cell (``runs``: pipelined, then serial if given) and
    fail it unless its overflow is 0, its FPR / FNR are in bounds, every
    run launched ``want`` per step and every ``checks`` value holds."""
    from repro_torch.dedup.metrics import fpr_fnr
    run = runs[0]
    n = run["dup"].shape[0]
    n_steps = n // BATCH
    fpr, fnr = fpr_fnr(run["dup"], truth[:n])
    overflow = int(run["ovf"].sum())
    per = {k: v / n_steps for k, v in run["launches"].items() if v}
    serial = ""
    if len(runs) > 1:
        secs = runs[1]["secs"]
        serial = (f"; serial {n / secs:.1f} elements/s, "
                  f"{secs / n_steps * 1e3:.4f} ms per step")
    log(f"[{tag}] {n} elements in {run['secs']:.4f} s = "
        f"{n / run['secs']:.1f} elements/s (host clock, ends in "
        f"synchronize); {n_steps} steps, {run['secs'] / n_steps * 1e3:.4f} "
        f"ms per step (host); launches per step {per}; overflow "
        f"{overflow}; FPR={fpr:.6g} FNR={fnr:.6g}{extra}{serial}; {checks} "
        f"| {card}")
    want = {k: n_steps * v for k, v in want.items()}
    got = [r["launches"] for r in runs]
    if not (all(checks.values()) and overflow == 0 and 0.0 <= fpr < 0.05
            and 0.0 <= fnr < 0.5 and all(g == want for g in got)):
        raise AssertionError(f"{tag} out of bounds (launches {got}, want "
                             f"{want})")


@contextlib.contextmanager
def nccl_group(card):
    """A one-rank NCCL process group on the card (world size 1: every
    collective still runs through NCCL) for the "shard" to "mesh" phases,
    destroyed when they end."""
    import inspect
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    kw = ({"device_id": torch.device("cuda", 0)} if "device_id" in
          inspect.signature(dist.init_process_group).parameters else {})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        t0 = time.perf_counter()
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1, **kw)
        try:
            probe = torch.ones(1, device="cuda")
            dist.all_reduce(probe)
            torch.cuda.synchronize()
            log(f"[shard] NCCL group of 1 rank (backend "
                f"{dist.get_backend()}) initialised, with a first "
                f"all_reduce, in {time.perf_counter() - t0:.3f} s (host "
                f"clock) | {card}")
            if int(probe.item()) != 1:
                raise AssertionError("NCCL all_reduce at 1 rank")
            yield
        finally:
            dist.destroy_process_group()


def phase_shard(keys, truth, card):
    """The sharded service (``ShardedDedup``) at one NCCL rank, over the
    group ``nccl_group`` holds: the card has one GPU, so the group is world
    size 1, and every exchange (``all_to_all_single``, ``all_reduce``,
    ``all_gather``) still runs through NCCL. Three 256 MB cells and the
    pinned digests; see the module's docstring."""
    from repro_torch.kernels.fused_template import bitset_step, counter_step
    from repro_torch.kernels.hashmix import hashmix
    shard_cells(keys, truth, card, (hashmix, bitset_step, counter_step))


def shard_cells(keys, truth, card, counters):
    """The shard phase's three cells and its pinned digests, each checked
    as the module's docstring says."""
    import torch
    from repro_torch.core import u32
    from repro_torch.core.fleet import FleetDedup
    from repro_torch.core.hashing import range_bucket
    from repro_torch.dedup import ShardedDedupConfig
    keys_d = u32.as_words(keys, "cuda")

    def pair(base, n):
        """Pipelined and serial runs of one config over the first n keys,
        and whether they agree bit for bit (the gathered states too)."""
        runs = [shard_run(ShardedDedupConfig(base=base, capacity_factor=2.0,
                                             pipeline=pipe), keys_d[:n],
                          counters) for pipe in (True, False)]
        p, q = runs
        same = {"dups": torch.equal(p["dup"], q["dup"]),
                "overflow": torch.equal(p["ovf"], q["ovf"]),
                "state": same_state(p["sd"].gather_state(p["state"]),
                                    q["sd"].gather_state(q["state"]))}
        return runs, {f"pipelined == serial {k}": v for k, v in same.items()}

    def done(tag, run):
        shard_profile(run, keys_d, tag, card)
        log(f"[elapsed] {tag} done at {time.perf_counter() - T0:.1f} s")

    bitset = {"hashmix": 0, "bitset_step": 1, "counter_step": 0}
    cfg = config("rlbsbf", MEMORY_MB, batch_size=BATCH)
    tag = "shard-static-rlbsbf-256MB-1rank"
    runs, same = pair(cfg, SHARD_N)
    sd = runs[0]["sd"]
    width = sd.n_shards * sd.scfg.capacity(BATCH, sd.n_shards)
    shard_cell(tag, runs, truth, card, bitset, f"; step width {width}",
               {**same, "width 2 x batch": width == 2 * BATCH})
    done(tag, runs[0])
    del runs

    # 32 buckets at one rank against its fleet oracle over range buckets
    tag = "shard-elastic-rlbsbf-256MB-32b-1rank"
    run = shard_run(ShardedDedupConfig(base=dataclasses.replace(
        cfg, rebalance_buckets=SHARD_BUCKETS,
        rebalance_threshold=SHARD_THRESHOLD), capacity_factor=2.0),
        keys_d[:SHARD_N], counters)
    g = run["sd"].gather_state(run["state"])
    cap = run["sd"].scfg.bucket_capacity(BATCH, 1)
    fleet = FleetDedup(dataclasses.replace(
        cfg, memory_bits=cfg.memory_bits // SHARD_BUCKETS,
        n_tenants=SHARD_BUCKETS), capacity=cap)
    k = keys_d[:SHARD_N]
    fst, fdup, fovf = fleet.run_stream(fleet.init(), k,
                                       range_bucket(k, SHARD_BUCKETS))
    checks = {"== FleetDedup dups": torch.equal(run["dup"], fdup),
              "overflow": torch.equal(run["ovf"][:, 0], fovf),
              **{f: torch.equal(getattr(g, f)[0], getattr(fst, f))
                 for f in ("bits", "load", "position", "rng")},
              "n_rebalances 0": int(g.router.n_rebalances) == 0,
              "bucket width": cap == -(-2 * BATCH // SHARD_BUCKETS)}
    shard_cell(tag, [run], truth, card, bitset,
               f"; {SHARD_BUCKETS} buckets of 8 MB, bucket width {cap}",
               checks)
    del g, fst, fleet
    done(tag, run)
    del run

    tag = "shard-elastic-sbf-256MB-32b-1rank"
    scfg = dataclasses.replace(config("sbf", MEMORY_MB, batch_size=BATCH),
                               rebalance_buckets=SHARD_BUCKETS,
                               rebalance_threshold=SHARD_THRESHOLD)
    runs, same = pair(scfg, SHARD_SBF_N)
    shard_cell(tag, runs, truth, card,
               {"hashmix": 1, "bitset_step": 0, "counter_step": 1},
               f"; d={scfg.n_planes} planes, {SHARD_BUCKETS} buckets", same)
    done(tag, runs[0])
    del runs

    # the pinned sharded digests, at this one rank
    for name, case in SHARD_DIGEST_CASES.items():
        got, overflow = shard_digest(case, "cuda")
        log(f"[shard-digest] {name}: {got[:16]} (pinned "
            f"{SHARD_DIGESTS[name][:16]}), overflow {overflow}")
        if (got, overflow) != (SHARD_DIGESTS[name], 0):
            raise AssertionError(f"pinned shard digest mismatch for {name}")


def fleet_config(name, **kw):
    """A fleet of FLEET_T tenants of 8 MB each for a digest-grid name."""
    cfg = config(name, FLEET_MB, batch_size=BATCH, **kw)
    return dataclasses.replace(cfg, n_tenants=FLEET_T).validate()


def fleet_knobs(cfg):
    """Heterogeneous per-tenant rows on the card: sbf Max alternating 3 and
    2 (one bit_length, so one plane count), cms/hh thresholds 1, 2, 3, 2,
    ..., swbf windows cycling through 1..window."""
    import torch
    t = np.arange(cfg.n_tenants)
    low = max(1 << (cfg.sbf_max.bit_length() - 1), cfg.sbf_max - 1)
    rows = {"max_value": np.where(t % 2 == 0, cfg.sbf_max, low),
            "threshold": np.array([1, 2, 3, 2])[t % 4],
            "window": 1 + t % max(cfg.window, 1)}
    return {n: torch.from_numpy(v.astype(np.int32)).cuda()
            for n, v in rows.items()}


def fleet_slots(rng, hi, frac):
    """(T, C) slot keys from [0, hi) with a fraction ``frac`` valid; the
    last tenant's row is empty, as a tenant without traffic has."""
    keys = rng.integers(0, hi, (FLEET_T, FLEET_CAPACITY), dtype=np.uint64)
    valid = rng.random((FLEET_T, FLEET_CAPACITY)) < frac
    valid[-1] = False
    return keys.astype(np.uint32), valid


def fleet_kernel_inputs(cfg, spec, state, slot_keys, slot_valid):
    """What the fleet step hands its kernel for one (T, C) slot grid, the
    keys the step leaves behind, and the slot keys: the bitset step's
    operands as its plain version takes them (positions from the plain
    hashmix; the kernel takes the keys instead) or the counter step's
    operands, built by the port's own functions."""
    import torch
    from repro_torch.core import batched, hashing, u32
    from repro_torch.kernels.hashmix import hashmix_plain
    seeds, _ = batched._seeds(cfg)
    kw = u32.as_words(slot_keys, "cuda")
    v = torch.as_tensor(slot_valid, device="cuda")
    c = v.shape[1]
    if spec.family == "bitset":
        pos = hashmix_plain(kw.reshape(-1), seeds.cuda(), cfg.s).view(
            *kw.shape, cfg.k)
        seen = batched.intra_batch_seen(kw, v)
        i_t = state.position[:, None] + torch.arange(c, dtype=torch.int32,
                                                     device="cuda")
        rng, rnd = batched.draw_randomness(cfg, state.rng, c)
        return rng, (pos, rnd, v, seen, i_t), kw
    pos = hashing.hash_positions(kw, seeds, cfg.s)
    seen = batched.intra_batch_seen(kw, v) if spec.uses_seen else None
    rng, rnd = (spec.draw(cfg, state.rng, c) if spec.draw
                else (state.rng, None))
    return rng, (pos, v, seen, state.load,
                 spec.make_events(cfg)(state, pos, v, rnd)), kw


def random_fleet_state(cfg, rng, position: int):
    """A stacked fleet state at ~50% density per tenant (random words, or
    random d-bit cells half of them zero), its exact per-tenant load, the
    tenant-folded keys, and for swbf a ring of random sorted slots whose
    current slot differs by tenant."""
    import torch
    from repro_torch.core import packed, u32
    from repro_torch.core.fleet import init_fleet_state
    from repro_torch.core.state import FilterState, WindowRing
    t, w = cfg.n_tenants, cfg.s_words
    base = init_fleet_state(cfg, event_capacity=FLEET_CAPACITY)
    tail = cfg.s - 32 * (w - 1)
    if not cfg.is_counter:
        words = rng.integers(0, 2 ** 32, (t, cfg.k, w), dtype=np.uint32)
        if tail < 32:
            words[..., -1] &= np.uint32((1 << tail) - 1)
        bits = u32.from_numpy_u32(words, "cuda")
        del words
        return FilterState(bits, base.position + position - 1,
                           packed.popcount(bits), base.rng)
    d = cfg.n_planes
    planes = rng.integers(0, 2 ** 32, (t, d, w), dtype=np.uint32)
    planes &= rng.integers(0, 2 ** 32, (t, 1, w), dtype=np.uint32)
    if tail < 32:
        planes[..., -1] &= np.uint32((1 << tail) - 1)
    planes = u32.from_numpy_u32(planes, "cuda")
    load = packed.popcount(packed.planes_nonzero(planes.transpose(0, 1)))
    ring = None
    if base.ring is not None:
        e = base.ring.events.shape[-1]
        ev = rng.integers(0, cfg.s, (t, cfg.window, e))
        ev[rng.random(ev.shape) < 0.3] = 32 * w
        ring = WindowRing(
            torch.from_numpy(np.sort(ev, axis=-1).astype(np.int32)).cuda(),
            torch.from_numpy((np.arange(t) % cfg.window).astype(np.int32))
            .cuda())
    bits = planes[:, :, None, :] if d > 1 else planes
    return FilterState(bits, base.position + position - 1, load[:, None],
                       base.rng, ring)


def phase_fleet(rng):
    """Both step kernels over their tenant grid axis against their plain
    versions at T = 32 x 8 MB: the bitset step for the four variants, the
    params-aware counter step for sbf (Max 3 / 2), swbf (windows
    1..window), cms (thresholds 1, 2, 3, 2, ...) and hh; over a
    repeated-key, a ragged and a fresh slot grid each, the last tenant's
    row empty. -> the largest differences (bitset, counter)."""
    import torch
    from repro_torch.core import batched, packed
    from repro_torch.core.sketch import get_spec
    from repro_torch.kernels.fused_template import (
        bitset_step_plain, counter_step, counter_step_plain)
    grids = [("repeated keys", 300, 0.9), ("ragged valid", 2 ** 32, 0.6),
             ("fresh keys", 2 ** 32, 1.0)]
    worst_b = worst_c = 0
    for variant in BITSET:
        cfg = fleet_config(variant)
        spec = get_spec(variant)
        state = random_fleet_state(cfg, rng, cfg.s - 4000)
        for label, hi, frac in grids:
            rng_next, args, kw = fleet_kernel_inputs(
                cfg, spec, state, *fleet_slots(rng, hi, frac))
            words = state.bits.clone()
            dup, ins, load = hashed(cfg, words, kw, args, state.load)
            new, dup_p, ins_p, load_p = bitset_step_plain(
                cfg, state.bits, *args, state.load)
            torch.cuda.synchronize()
            diff = (words != new).sum().item()
            worst_b = max(worst_b, abs_err(words, new), abs_err(dup, dup_p),
                          abs_err(ins, ins_p), abs_err(load, load_p))
            ok = (diff == 0 and torch.equal(dup, dup_p)
                  and torch.equal(ins, ins_p) and torch.equal(load, load_p)
                  and torch.equal(load, packed.popcount(words))
                  and torch.equal(words[-1], state.bits[-1]))
            log(f"[fleet] bitset {variant} T={FLEET_T} k={cfg.k} "
                f"s={cfg.s} C={FLEET_CAPACITY} {label}: dup={int(dup.sum())} "
                f"inserted={int(ins.sum())} words differing={diff} -> "
                f"{'exactly equal' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"fleet bitset step != plain: "
                                     f"{variant} {label}")
            state = state._replace(
                bits=words, load=load, rng=rng_next,
                position=state.position + args[2].sum(1, dtype=torch.int32))
        del state, words, new
        torch.cuda.empty_cache()
    for name in ("sbf", "swbf", "cms", "hh"):
        cfg = fleet_config(name)
        spec = get_spec(cfg.variant)
        knobs = fleet_knobs(cfg)
        state = random_fleet_state(cfg, rng, 5000)
        for label, hi, frac in grids:
            rng_next, args, _ = fleet_kernel_inputs(
                cfg, spec, state, *fleet_slots(rng, hi, frac))
            pos, v, seen, load_in, ev = args
            planes = batched.fleet_planes(state.bits)
            got = planes.clone()
            dup, load = counter_step(cfg, spec, got, *args,
                                     threshold=knobs["threshold"],
                                     max_value=knobs["max_value"])
            new, dup_p, load_p = counter_step_plain(
                cfg, spec, planes, *args, knobs["threshold"],
                knobs["max_value"])
            torch.cuda.synchronize()
            diff = (got != new).sum().item()
            worst_c = max(worst_c, abs_err(got, new), abs_err(dup, dup_p),
                          abs_err(load, load_p))
            nz = packed.popcount(packed.planes_nonzero(got.transpose(0, 1)))
            ok = (diff == 0 and torch.equal(dup, dup_p)
                  and torch.equal(load, load_p)
                  and torch.equal(load[:, 0], nz))
            log(f"[fleet] counter {name} T={FLEET_T} d={cfg.n_planes} "
                f"k={cfg.k} s={cfg.s} C={FLEET_CAPACITY} {label}: "
                f"dup={int(dup.sum())} words differing={diff} -> "
                f"{'exactly equal' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"fleet counter step != plain: {name} "
                                     f"{label}")
            ring = (batched.ring_push(state.ring, ev.ring_payload,
                                      knobs["window"])
                    if ev.ring_payload is not None else state.ring)
            state = state._replace(
                bits=got[:, :, None, :] if got.shape[1] > 1 else got,
                load=load, rng=rng_next, ring=ring,
                position=state.position + v.sum(1, dtype=torch.int32))
            del planes, new, ev, args
        del state, got
        torch.cuda.empty_cache()
    return worst_b, worst_c


def fleet_stream(keys):
    """The fleet paths' mixed stream: the stream's first FLEET_N keys, each
    with a tenant id drawn uniformly from a seeded generator, and the exact
    ground truth per (tenant, key) pair — a repeat in another tenant is
    distinct by the isolation contract."""
    from repro_torch.dedup.metrics import truth_from_stream
    keys = keys[:FLEET_N]
    tenants = np.random.default_rng(SEED + 3).integers(
        0, FLEET_T, FLEET_N).astype(np.int32)
    pairs = (tenants.astype(np.uint64) << np.uint64(32)) | keys
    return keys, tenants, truth_from_stream(pairs)


def phase_fleet_path(name, keys, tenants, truth):
    """A 32 x 8 MB fleet over the mixed stream through
    ``FleetDedup.run_stream``: one step launch per fleet step (and one
    hashmix on the counter path; the bitset kernel hashes itself),
    overflow 0, FPR and FNR per (tenant, key), each tenant's load
    equal to its popcount and its position to its lane count."""
    import torch
    from repro_torch.core import batched, packed
    from repro_torch.core.fleet import FleetDedup, default_tenant_params
    from repro_torch.dedup.metrics import fpr_fnr
    from repro_torch.kernels.fused_template import bitset_step, counter_step
    from repro_torch.kernels.hashmix import hashmix
    cfg = fleet_config(name)
    params = default_tenant_params(cfg, FLEET_CAPACITY)
    hetero = cfg.is_counter
    if hetero:
        params = params._replace(max_value=fleet_knobs(cfg)["max_value"])
    fleet = FleetDedup(cfg, params=params)
    if fleet.capacity != FLEET_CAPACITY:
        raise AssertionError(f"fleet capacity {fleet.capacity}")
    step = counter_step if cfg.is_counter else bitset_step
    step_name = "counter_step" if cfg.is_counter else "bitset_step"
    state = fleet.init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hashmix.launches = 0
    step.launches = 0
    t0 = time.perf_counter()
    state, dup, ovf = fleet.run_stream(state, keys, tenants)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"hashmix": hashmix.launches, step_name: step.launches}
    peak = torch.cuda.max_memory_allocated()
    n_steps = -(-FLEET_N // BATCH)
    fpr, fnr = fpr_fnr(dup, truth)
    overflow = int(ovf.sum())
    if cfg.is_counter:
        nz = packed.popcount(packed.planes_nonzero(
            batched.fleet_planes(state.bits).transpose(0, 1)))[:, None]
    else:
        nz = packed.popcount(state.bits)
    exact = torch.equal(state.load, nz)
    lanes = np.bincount(tenants, minlength=FLEET_T) + 1
    placed = np.array_equal(state.position.cpu().numpy(), lanes)
    tag = (f"fleet-{name}-{FLEET_T}x8MB" + ("-hetero" if hetero else ""))
    knobs = (f" Max per tenant {params.max_value.tolist()[:4]}..."
             if hetero else "")
    log(f"[{tag}] {FLEET_T} tenants x 8 MB, k={cfg.k} s={cfg.s} per row, "
        f"C={fleet.capacity}{knobs}, batch {BATCH}: {FLEET_N} elements in "
        f"{secs:.4f} s = {FLEET_N / secs:.1f} elements/s (host clock, ends "
        f"in synchronize); {n_steps} fleet steps, "
        f"{secs / n_steps * 1e3:.4f} ms per step")
    log(f"[{tag}] FPR={fpr:.6g} FNR={fnr:.6g} per (tenant, key); overflow "
        f"{overflow}; load==popcount per tenant: {exact}; position==lanes "
        f"per tenant: {placed}; load (tenants 0-3) "
        f"{state.load[:4].tolist()}")
    log(f"[{tag}] kernel launches: {launches}; peak memory allocated "
        f"{peak / 2 ** 20:.1f} MiB")
    if not (dup.shape == (FLEET_N,) and exact and placed and overflow == 0
            and 0.0 <= fpr < 0.05 and 0.0 <= fnr < 0.5):
        raise AssertionError(f"{tag} result out of bounds")
    want = {"hashmix": n_steps if cfg.is_counter else 0, step_name: n_steps}
    if launches != want:
        raise AssertionError(f"{tag}: expected launches {want} (one step "
                             f"per fleet step), got {launches}")
    return fleet, state, launches


def bitset_step_bytes(cfg, words, pos, rnd, v, seen, i_t, load) -> int:
    """The bytes one bitset step must move on these inputs: each input it
    needs read once, each output written once, each filter word it must
    probe or update read once and each word it updates written once. What
    it needs depends on the data, so the decisions come from the plain
    decide at the positions ``pos``: the key only for valid lanes, the
    variant's draws only where the decide reads them, del_pos only for
    enabled deletes. A fleet's operands (leading tenant axis) sum over its
    tenants, whose words are disjoint."""
    import torch
    from repro_torch.core import batched, packed
    if words.dim() == 3:
        return sum(bitset_step_bytes(
            cfg, words[t], pos[t], batched.BatchRandomness(
                *(x[t] for x in rnd)), v[t], seen[t], i_t[t], load[t])
            for t in range(words.shape[0]))
    b, k = pos.shape
    decide = batched.make_decision_fn(cfg)
    _, ins, del_mask = decide(packed.probe_packed(words, pos), v, seen, i_t,
                              load, rnd)
    n_valid, n_ins = int(v.sum()), int(ins.sum())
    rows = torch.arange(k, device=pos.device)[None, :] * cfg.s_words
    probe_w = (rows + (pos.long() >> 5))[v].reshape(-1)
    del_w = (rows + (rnd.del_pos.long() >> 5))[del_mask]
    ins_w = (rows + (pos.long() >> 5))[ins].reshape(-1)
    # inserted words are probed words, so the probes and deletes cover reads
    n_read = torch.unique(torch.cat([probe_w, del_w])).numel()
    n_written = torch.unique(torch.cat([del_w, ins_w])).numel()
    draws = {"rsbf": 8 * n_valid,           # i_t and u_bern
             "bsbf": 0,
             "bsbfsd": 4 * n_ins,           # which
             "rlbsbf": 4 * k * n_ins}[cfg.variant]   # u_aux
    inputs = 4 * n_valid + 2 * b + 4 * k + 4 * int(del_mask.sum())
    outputs = 2 * b + 4 * k                 # dup, inserted, load
    return inputs + draws + outputs + 4 * (n_read + n_written)


def counter_step_bytes(cfg, spec, pos, v, seen, load, ev):
    """(bytes, operations) one counter step must spend on these inputs:
    positions of valid lanes, the valid and seen flags, the run heads of
    both event lists (cell, and count where one is needed), each distinct
    plane word it must probe or update read once and each word it updates
    written once, and the outputs (dup, load). A fleet's operands (leading
    tenant axis) sum over its tenants, each adding its threshold and
    set-to-Max value."""
    import torch
    from repro_torch.kernels.fused_template import _tenant_events
    if pos.dim() == 3:
        per = [counter_step_bytes(cfg, spec, pos[t], v[t],
                                  None if seen is None else seen[t], load[t],
                                  _tenant_events(ev, t))
               for t in range(pos.shape[0])]
        return (sum(x[0] for x in per) + 8 * pos.shape[0],
                sum(x[1] for x in per))
    d, w, k = cfg.n_planes, cfg.s_words, cfg.k
    b = pos.shape[0]
    sentinel = 32 * w

    def heads(events, head):
        return events[head & (events < sentinel)]

    ins = heads(ev.ins_events, ev.ins_heads)
    sub = heads(ev.sub_events, ev.sub_heads) if spec.has_sub else ins[:0]
    touched = torch.unique(torch.cat([ins >> 5, sub >> 5]))
    probe_w = (pos.long() >> 5)[v].reshape(-1)
    n_read = d * torch.unique(torch.cat([probe_w, touched])).numel()
    n_written = d * touched.numel()
    inputs = (4 * k * int(v.sum()) + b * (2 if spec.uses_seen else 1) + 4
              + 8 * sub.numel()
              + (4 if spec.combine == "set" else 8) * ins.numel())
    outputs = b + 4                                  # dup, load
    # ~d + 4 operations per probed cell, per event and per plane of an
    # updated word a handful more (masks, chains, popcounts)
    ops = (b * k * (d + 4) + (sub.numel() + ins.numel()) * (d + 4)
           + touched.numel() * 8 * d)
    return inputs + outputs + 4 * (n_read + n_written), ops


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the float32 rate outside the tensor cores."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / PEAK_FLOPS_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the card's latency floor: an empty launch, and chains of dependent
# scattered loads (the next address taken from the loaded value) over a
# 256 MiB buffer, one thread per element — measurement code, not part of
# the package
LATENCY_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

__global__ void chase_kernel(const uint32_t* __restrict__ buf, uint32_t mask,
                             uint32_t* __restrict__ out, int n, int depth,
                             uint32_t salt) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x = (static_cast<uint32_t>(i) ^ salt) * 0x9E3779B1u;
  for (int d = 0; d < depth; ++d) {
    x ^= x >> 15;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x += buf[x & mask];
  }
  out[i] = x;
}

extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chase_launch(const void* buf, uint32_t mask, void* out, int n,
                            int depth, uint32_t salt, void* stream) {
  chase_kernel<<<(n + 255) / 256, 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(buf), mask, static_cast<uint32_t*>(out),
      n, depth, salt);
  return static_cast<int>(cudaGetLastError());
}
"""
# (launches, dependent DRAM round trips on the longest chain) per call of
# each timed kernel, read from its source: hashmix the key load; the
# probes the operand (or key) load, then the gathers; the bitset step's
# probe (key, then word), deletes (row mask, position, atomicAnd) and
# inserts (flag and key together, then atomicOr); the counter step's first launch the partition's three search
# rounds, its second the tile start, the staged lists and the owners'
# plane words; scatter_delta the zero fill, then operands and atomicOr
FLOOR_DEPTH = {"hashmix": (1, 1), "bloom_probe": (1, 2),
               "fused_probe": (1, 2), "bitset_step": (3, 7),
               "bitset_step_fleet": (3, 7), "counter_step": (2, 6),
               "counter_step_params_aware": (2, 6),
               "scatter_delta": (2, 2)}


def start_nvcc(src: str, so: str, include: str):
    """One ``nvcc`` of ``src`` into ``so`` with the port's flags, started
    (not waited for)."""
    from repro_torch.kernels import build
    os.makedirs(os.path.dirname(so), exist_ok=True)
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", include, "-o", so, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_nvcc(proc, so: str, what: str) -> ctypes.CDLL:
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {what}:\n{text}")
    return ctypes.CDLL(so)


def start_extra_builds(parent_dir):
    """The latency-floor kernels, and with ``parent_dir`` the earlier
    hashmix, bloom_probe, bitset step and counter step (each with
    ``parent_dir``'s own headers, if it has any), all compiled at once
    into ``build/``."""
    out = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "latency_floor.cu")
    with open(src, "w") as f:
        f.write(LATENCY_SRC)
    jobs = {"latency_floor": (start_nvcc(src, os.path.join(
        out, "latency_floor.so"), out), os.path.join(out,
                                                      "latency_floor.so"))}
    for name in PARENT_SOURCES if parent_dir else ():
        so = os.path.join(out, f"parent_{name}.so")
        jobs[name] = start_nvcc(os.path.join(parent_dir, f"{name}.cu"), so,
                                parent_dir), so
    return jobs


def finish_extra_builds(jobs) -> tuple:
    """-> (the latency-floor library, {entry name: the earlier C entry
    point with its signature set} or None). The earlier interfaces are
    those before the seeds could come from device memory: each current one
    without its device-seed pointer."""
    libs = {name: finish_nvcc(proc, so, name)
            for name, (proc, so) in jobs.items()}
    floor = libs.pop("latency_floor")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    floor.empty_launch.argtypes = [i, i, p]
    floor.chase_launch.argtypes = [p, ctypes.c_uint32, p, i, i,
                                   ctypes.c_uint32, p]
    if not libs:
        return floor, None
    argtypes = {
        "hashmix": [p, p, i, p, p, i, ctypes.c_uint32, i, p],
        "fused_probe": [p, p, p, p, p, i, ll, p, i, ctypes.c_uint32, p],
        "bitset_step": [p, ll, i, i, i, p, p, p, i] + [p] * 12
                       + [i, i, ctypes.c_float, ctypes.c_float, p],
        "counter_step": [p, ll, i, i, i, i, p, p, p, i, p, p, p, p, i, i,
                         p, i, i, i, p, p, p]}
    entries = {}
    for name, lib in (("hashmix", libs["hashmix"]),
                      ("fused_probe", libs["bloom_probe"]),
                      ("bitset_step", libs["bitset_step"]),
                      ("counter_step", libs["counter_step"])):
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes, fn.restype = argtypes[name], ctypes.c_int
        entries[name] = fn
    log(f"[parent] built the earlier {', '.join(PARENT_SOURCES)} from "
        f"{len(libs)} sources")
    return floor, entries


@contextlib.contextmanager
def parent_kernels(parent):
    """Inside, the port's wrappers launch the earlier kernels: each
    wrapper's C entry point is swapped for the earlier one, the device-seed
    pointer dropped from its arguments (k <= 32 here, so it is null)."""
    import importlib
    from repro_torch.kernels import fused_template
    # the modules: the package's names hashmix and bloom_probe are the
    # wrappers, as the reference's package exports them
    bloom_probe = importlib.import_module("repro_torch.kernels.bloom_probe")
    hashmix = importlib.import_module("repro_torch.kernels.hashmix")

    def drop(fn, at):
        return lambda *a: fn(*a[:at], *a[at + 1:])

    saved = (hashmix._entry, bloom_probe._entry, fused_template._entry,
             fused_template._counter_entry)
    hashmix._entry = lambda: drop(parent["hashmix"], 5)
    bloom_probe._entry = (lambda name: drop(parent["fused_probe"], 8)
                          if name == "fused_probe" else saved[1](name))
    fused_template._entry = lambda: drop(parent["bitset_step"], 8)
    fused_template._counter_entry = lambda: parent["counter_step"]
    try:
        yield
    finally:
        (hashmix._entry, bloom_probe._entry, fused_template._entry,
         fused_template._counter_entry) = saved


def earlier(parent, make):
    """A timed-run factory like ``make`` whose calls go through the
    earlier kernels."""
    def mk():
        fn = make()

        def run(i):
            with parent_kernels(parent):
                return fn(i)
        return run
    return mk


_FLUSH = []


def flush_l2() -> None:
    """Evict the card's 50 MB L2 by writing a 128 MiB buffer, so a timed
    run finds the filter words cold, as a stream's fresh batches do (the
    timing batches are replayed once per timed run)."""
    import torch
    if not _FLUSH:
        _FLUSH.append(torch.empty(128 << 20, dtype=torch.uint8,
                                  device="cuda"))
    _FLUSH[0].zero_()
    torch.cuda.synchronize()


def device_split(fn, n: int, names=None) -> dict:
    """Device ms per call of ``fn(i)`` for i < n, from torch.profiler, by
    kernel name: each of ``names`` (the kernels whose names hold it, each
    launched once per call), or every device kernel under "all" when
    ``names`` is None. Empty when the profiler recorded none of them. The
    chip's torch 2.11 profiler does not always hold ``n`` launches of a
    named kernel: it loses some (11 – 15 of 16 kept), and a trace with
    more than ``n`` would read its mean low (a run that took any trace
    with at least ``n`` read scatter_delta's zero fill and scatter at
    0.071625 ms, under the 0.0801691 ms it takes HBM3 to write the 256
    MiB delta; the next run, under this rule, 0.083443 ms). The run is
    timed again, up to four times, until
    every named kernel shows exactly ``n`` launches; failing that, the last
    trace that holds none over ``n``. A named kernel's time is its mean
    over the launches that trace kept; "all" divides by ``n``. Every retry
    is logged with its counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    chosen = None
    for attempt in range(4):
        flush_l2()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
        rows = [r for r in prof.key_averages()
                if str(getattr(r, "device_type", "")).endswith("CUDA")
                and r.self_device_time_total > 0]
        if names is None:
            split = {"all": sum(r.self_device_time_total for r in rows)}
            return {x: us / 1e3 / n for x, us in split.items() if us > 0}
        split, count = {}, {}
        for r in rows:
            for x in names:
                if x in r.key:
                    split[x] = split.get(x, 0) + r.self_device_time_total
                    count[x] = count.get(x, 0) + r.count
                    break
        if all(count.get(x, 0) <= n for x in names) or chosen is None:
            chosen = (split, count)
        if all(count.get(x, 0) == n for x in names):
            break
        log(f"[time] the profiler kept {count} of {n} launches of "
            f"{names}: timing the run again")
    split, count = chosen
    return {x: us / 1e3 / count[x] for x, us in split.items() if us > 0}


def device_ms(fn, n: int, names=None):
    """Device time per call of ``fn(i)`` for i < n, from torch.profiler:
    the kernels whose names hold one of ``names``, or every device kernel
    when ``names`` is None. None when the profiler recorded none."""
    split = device_split(fn, n, names)
    return sum(split.values()) if split else None


def wall_ms(fn, n: int) -> float:
    """Per call of ``fn(i)`` for i < n issued back to back, by CUDA events:
    the device time where the device is the bottleneck, the host's issue
    time (the Python wrapper included) where it is not."""
    import torch
    flush_l2()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def timed(make_run, n: int, names=None):
    """(ms per call, how it was measured): the profiler's device time, or,
    where the profiler saw no such kernel, CUDA events around calls issued
    back to back."""
    ms = device_ms(make_run(), n, names)   # retries a trace that lost rows
    if ms is not None:
        return ms, "device time, torch.profiler"
    return (wall_ms(make_run(), n), "CUDA events, host issue included: "
            "the profiler saw no such kernel")


def chained(step, state_words, load):
    """A run of ``step(words, i, load) -> (words, load)`` over the batches,
    each call on the filter and load the one before it left."""
    cur = [state_words, load]

    def one(i):
        cur[0], cur[1] = step(cur[0], i, cur[1])
    return one


def fleet_batches(fleet, state, more, tenants):
    """The 16 timing batches as a fleet's kernel operands (the bitset
    step's with their slot keys), each built on the state the step before
    it left, with their summed (bytes, ops)."""
    import torch
    from repro_torch.core import batched, u32
    from repro_torch.core.sketch import get_spec
    from repro_torch.kernels.fused_template import counter_step
    cfg = fleet.cfg
    spec = get_spec(cfg.variant)
    p = fleet.params
    st = state._replace(bits=state.bits.clone())
    inputs, nbytes, nops = [], 0, 0
    v = torch.ones(BATCH, dtype=torch.bool, device="cuda")
    for i in range(len(more) // BATCH):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        slot_keys, slot_valid, *_ = fleet.route(
            u32.from_numpy_u32(more[sl], "cuda"),
            torch.from_numpy(tenants[sl]).cuda(), v)
        rng, args, kw = fleet_kernel_inputs(cfg, spec, st, slot_keys,
                                            slot_valid)
        if spec.family == "bitset":
            nbytes += bitset_step_bytes(cfg, st.bits, *args, st.load)
            nops += FLEET_T * FLEET_CAPACITY * (18 * cfg.k + 10)
            _, _, load = hashed(cfg, st.bits, kw, args, st.load)
            inputs.append((args, kw))
        else:
            nb, no = counter_step_bytes(cfg, spec, *args)
            nbytes, nops = nbytes + nb, nops + no
            _, load = counter_step(cfg, spec, batched.fleet_planes(st.bits),
                                   *args,
                                   threshold=p.threshold,
                                   max_value=p.max_value)
            inputs.append(args[:3] + args[4:])         # the load chains
        st = st._replace(rng=rng, load=load, position=st.position
                         + slot_valid.sum(1, dtype=torch.int32))
    del st
    return inputs, nbytes, nops


def latency_floor(lib, card, n_b: int) -> dict:
    """The card's latency floor, by the kernels' own method (torch.profiler
    device time over ``n_b`` calls, the L2 flushed first): an empty kernel
    at 64 blocks of 256 threads (the launch floor), and one thread per
    element (B·k = 16,384) doing 1, 2 and 3 dependent scattered loads over
    a 256 MiB buffer; a DRAM round trip is the slope over the depth."""
    import torch
    words = 1 << 26
    buf = torch.randint(-2 ** 31, 2 ** 31, (words,), dtype=torch.int32,
                        device="cuda")
    n = 2 * BATCH
    out = torch.empty((n,), dtype=torch.int32, device="cuda")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def empty():
        return lambda i: lib.empty_launch(64, 256, stream())

    def chase(depth):
        return lambda: lambda i: lib.chase_launch(
            buf.data_ptr(), words - 1, out.data_ptr(), n, depth,
            7919 * i + depth, stream())

    launch, how = timed(empty, n_b, ("empty_kernel",))
    chain = [timed(chase(d), n_b, ("chase_kernel",))[0] for d in (1, 2, 3)]
    trip = (chain[2] - chain[0]) / 2
    log(f"[floor] empty kernel (64 x 256 threads): {launch:.6f} ms ({how}); "
        f"{n} threads, 1 / 2 / 3 dependent scattered loads over 256 MiB: "
        + " / ".join(f"{x:.6f}" for x in chain)
        + f" ms; one DRAM round trip {trip:.6f} ms ({card})")
    del buf, out
    return {"launch": launch, "trip": trip, "chain": chain}


def phase_timings(cfg, state, sbf_cfg, sbf_state, card, fleets, floor_lib,
                  parent=None):
    """Per-kernel device times on 16 fresh batches past the main stream,
    each step launch on the filter the one before it left, as the stream
    runs: the kernels' own rows of a torch.profiler trace, the plain
    versions' device kernels on the same inputs, the bound from what these
    batches need, and the latency floor of each kernel's launches and
    dependent round trips (``FLOOR_DEPTH``). Each kernel runs at the
    shapes of the path that carries it: hashmix and the counter step at the
    sbf table's (k = 3, s = 2^30), the bitset step at the rlbsbf table's
    and bloom_probe, fused_probe and scatter_delta at the ops path's (both
    k = 2, W = 2^25); the fleet forms at the fleet paths' 32 x 8 MB, each
    batch routed by the fleet (``fleets``: the two paths' fleets and final
    states). With ``parent`` (the earlier entry points) also, in turns: the
    earlier hashmix plus bitset step against the step that hashes, for one
    filter and for the fleet, the earlier fused_probe chain against the one launch, and the
    standalone hashmix and bloom_probe. Each part's seconds are logged as
    it ends."""
    import torch
    from repro_torch.core import batched, packed, u32
    from repro_torch.core.sketch import get_spec
    from repro_torch.data.streams import controlled_distinct_stream
    from repro_torch.kernels.bloom_probe import (bloom_probe,
                                                 bloom_probe_plain,
                                                 fused_probe,
                                                 fused_probe_plain)
    from repro_torch.kernels.fused_template import (
        bitset_step_plain, counter_step, counter_step_plain)
    from repro_torch.kernels.hashmix import hashmix, hashmix_plain
    from repro_torch.kernels.scatter_delta import (scatter_delta,
                                                   scatter_delta_plain)
    laps = [time.perf_counter()]

    def lap(label):
        laps.append(time.perf_counter())
        log(f"[time] part {label}: {laps[-1] - laps[-2]:.1f} s")

    n_b, k, w = 16, cfg.k, cfg.s_words
    more, _ = controlled_distinct_stream(n_b * BATCH, DISTINCT_FRAC,
                                         seed=SEED + 1)
    batches = [more[i * BATCH:(i + 1) * BATCH] for i in range(n_b)]
    valid = np.ones(BATCH, bool)
    seeds, _ = batched._seeds(cfg)
    seeds_dev = seeds.cuda()
    sbf_seeds, _ = batched._seeds(sbf_cfg)
    sbf_seeds_dev, sbf_k = sbf_seeds.cuda(), sbf_cfg.k
    keys = [u32.from_numpy_u32(x, "cuda") for x in batches]
    inputs, nbytes = [], 0
    st = state._replace(bits=state.bits.clone())
    for x in batches:
        rng, args, kw = step_inputs(cfg, st, x, valid)
        nbytes += bitset_step_bytes(cfg, st.bits, *args, st.load)
        inputs.append(args)
        _, _, load = hashed(cfg, st.bits, kw, args, st.load)
        st = st._replace(position=st.position + BATCH, rng=rng, load=load)
    del st
    lap("bitset inputs and bytes")
    spec = get_spec("sbf")
    c_inputs, c_bytes, c_ops = [], 0, 0
    st = sbf_state._replace(bits=sbf_state.bits.clone())
    for x in batches:
        rng, args = counter_inputs(sbf_cfg, spec, st, x, valid)
        nb, no = counter_step_bytes(sbf_cfg, spec, *args)
        c_bytes, c_ops = c_bytes + nb, c_ops + no
        c_inputs.append(args[:3] + args[4:])           # the load chains
        _, load = counter_step(sbf_cfg, spec, st.bits[:, 0, :], *args)
        st = st._replace(position=st.position + BATCH, rng=rng, load=load)
    del st
    lap("counter inputs and bytes")
    # the ops functions on the rlbsbf filter: probe every key, scatter the
    # keys the probe did not find
    pos = [hashmix_plain(x, seeds_dev, cfg.s) for x in keys]
    idx = [packed.split_pos(p) for p in pos]
    hits = [bloom_probe_plain(state.bits, i, m) for i, m in idx]
    sc_idx = [torch.where(h.all(dim=1)[:, None] != 0, -1, i).to(torch.int32)
              .contiguous() for h, (i, _) in zip(hits, idx)]
    probed = torch.cat([(torch.arange(k, device="cuda") * w + i.long())
                        .reshape(-1) for i, _ in idx])
    n_probed = torch.unique(probed).numel()

    def bitset(words, i, load):
        return words, hashed(cfg, words, keys[i], inputs[i], load)[2]

    def bitset_plain(words, i, load):
        new, _, _, load = bitset_step_plain(cfg, words, *inputs[i], load)
        return new, load

    def counter(planes, i, load):
        pos_, v_, seen_, ev_ = c_inputs[i]
        return planes, counter_step(sbf_cfg, spec, planes, pos_, v_, seen_,
                                    load, ev_)[1]

    def counter_plain(planes, i, load):
        pos_, v_, seen_, ev_ = c_inputs[i]
        new, _, load = counter_step_plain(sbf_cfg, spec, planes, pos_, v_,
                                          seen_, load, ev_)
        return new, load

    sbf_planes = sbf_state.bits[:, 0, :]
    (fb, fb_state), (fc, fc_state) = fleets
    f_ten = np.random.default_rng(SEED + 4).integers(
        0, FLEET_T, n_b * BATCH).astype(np.int32)
    lap("ops inputs")
    fb_in, fb_bytes, fb_ops = fleet_batches(fb, fb_state, more, f_ten)
    lap("fleet bitset inputs and bytes")
    fc_in, fc_bytes, fc_ops = fleet_batches(fc, fc_state, more, f_ten)
    lap("fleet counter inputs and bytes")
    fcp = fc.params

    def fleet_bitset(words, i, load):
        args, kw = fb_in[i]
        return words, hashed(fb.cfg, words, kw, args, load)[2]

    def fleet_bitset_plain(words, i, load):
        new, _, _, load = bitset_step_plain(fb.cfg, words, *fb_in[i][0],
                                            load)
        return new, load

    def fleet_counter(planes, i, load):
        pos_, v_, seen_, ev_ = fc_in[i]
        return planes, counter_step(fc.cfg, spec, planes, pos_, v_, seen_,
                                    load, ev_, threshold=fcp.threshold,
                                    max_value=fcp.max_value)[1]

    def fleet_counter_plain(planes, i, load):
        pos_, v_, seen_, ev_ = fc_in[i]
        new, _, load = counter_step_plain(fc.cfg, spec, planes, pos_, v_,
                                          seen_, load, ev_, fcp.threshold,
                                          fcp.max_value)
        return new, load

    fc_planes = batched.fleet_planes(fc_state.bits)
    runs = {
        # the sbf path's shape: the keys of its batches, its k and s
        "hashmix": (lambda: lambda i: hashmix(keys[i], sbf_seeds,
                                              s=sbf_cfg.s),
                    lambda: lambda i: hashmix_plain(
                        keys[i], sbf_seeds_dev, sbf_cfg.s),
                    ("hashmix_kernel",),
                    # 4 B per key in, 4 per position out; ~10 integer
                    # operations per (key, row)
                    (4 * BATCH + 4 * BATCH * sbf_k, 10 * BATCH * sbf_k)),
        "bitset_step": (
            lambda: chained(bitset, state.bits.clone(), state.load),
            lambda: chained(bitset_plain, state.bits, state.load),
            BITSET_KERNELS,
            # ~10 operations per hash, ~4 per probe, ~10 for the decision,
            # ~4 per update
            (nbytes / n_b, BATCH * (18 * k + 10))),
        "counter_step": (
            lambda: chained(counter, sbf_planes.clone(), sbf_state.load),
            lambda: chained(counter_plain, sbf_planes, sbf_state.load),
            COUNTER_KERNELS,
            (c_bytes / n_b, c_ops / n_b)),
        "bloom_probe": (
            lambda: lambda i: bloom_probe(state.bits, *idx[i]),
            lambda: lambda i: bloom_probe_plain(state.bits, *idx[i]),
            ("bloom_probe_kernel",),
            # index and mask in, each distinct word gathered once, hits out
            ((9 * BATCH * k + 4 * n_probed / n_b), 3 * BATCH * k)),
        "fused_probe": (
            lambda: lambda i: fused_probe(keys[i], state.bits, seeds, cfg.s),
            lambda: lambda i: fused_probe_plain(keys[i], state.bits,
                                                seeds_dev, cfg.s),
            ("fused_probe_kernel",),
            # keys in, each distinct word gathered once, hits, positions
            # and dup out
            (4 * BATCH + 4 * n_probed / n_b + 5 * BATCH * k + BATCH,
             13 * BATCH * k)),
        # the wrapper's zero fill is part of the function: its (k, W) delta
        # must be written whole; the fill kernel and the scatter, each
        # averaged over the launches the trace kept
        "scatter_delta": (
            lambda: lambda i: scatter_delta(sc_idx[i], idx[i][1], w=w),
            lambda: lambda i: scatter_delta_plain(sc_idx[i], idx[i][1], w),
            SCATTER_KERNELS,
            (8 * BATCH * k + 4 * k * w, 2 * BATCH * k)),
        # the fleet forms: one launch for the 32 tenants' (T, C) grid
        "bitset_step_fleet": (
            lambda: chained(fleet_bitset, fb_state.bits.clone(),
                            fb_state.load),
            lambda: chained(fleet_bitset_plain, fb_state.bits, fb_state.load),
            BITSET_KERNELS,
            (fb_bytes / n_b, fb_ops / n_b)),
        "counter_step_params_aware": (
            lambda: chained(fleet_counter, fc_planes.clone(), fc_state.load),
            lambda: chained(fleet_counter_plain, fc_planes, fc_state.load),
            COUNTER_KERNELS,
            (fc_bytes / n_b, fc_ops / n_b)),
    }
    floor = latency_floor(floor_lib, card, n_b)
    lap("latency floor")
    out = {}
    for name, (run, plain_run, kernels, work) in runs.items():
        run()(0)                                       # warm
        ms, how = timed(run, n_b, kernels)
        lap(f"{name} kernel")
        # a plain fleet step is ~1300 eager ops (a loop over the tenants):
        # under the profiler each call costs seconds, so two calls time it
        plain_ms, plain_how = timed(
            plain_run, 2 if name.endswith(("_fleet", "_params_aware"))
            else n_b)
        lap(f"{name} plain version")
        through_wrapper = wall_ms(run(), n_b)
        bound_ms, bound_by = bound(*work)
        n_launch, depth = FLOOR_DEPTH[name]
        floor_ms = n_launch * floor["launch"] + depth * floor["trip"]
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        log(f"[time] {name}: kernel {ms:.6f} ms per call ({how}); plain "
            f"version {plain_ms:.6f} ms per call ({plain_how}; all its "
            f"device kernels, divided by calls, reads low); bound "
            f"{bound_ms:.7f} ms by {bound_by} ({work[0]:.0f} bytes, "
            f"{work[1]:.0f} operations); latency floor {floor_ms:.6f} ms "
            f"({n_launch} launches + {depth} round trips); through its "
            f"wrapper, calls back to back: {through_wrapper:.6f} ms per call "
            f"(CUDA events; {card})")

    def steps(fn, x0, load0):
        return lambda: chained(fn, x0.clone(), load0)

    if parent is None:
        return out

    # name -> [(label, run factory, kernel names)], timed in turns: the
    # earlier kernels through the same wrappers, on the same inputs
    current = {
        "bitset_step": (steps(bitset, state.bits, state.load),
                        BITSET_KERNELS),
        "bitset_step_fleet": (steps(fleet_bitset, fb_state.bits,
                                    fb_state.load), BITSET_KERNELS),
        "counter_step": (steps(counter, sbf_planes, sbf_state.load),
                         COUNTER_KERNELS),
        "counter_step_params_aware": (steps(fleet_counter, fc_planes,
                                            fc_state.load),
                                      COUNTER_KERNELS),
        # at the sbf path's shape, as the hashmix row
        "hashmix": (lambda: lambda i: hashmix(keys[i], sbf_seeds,
                                              s=sbf_cfg.s),
                    ("hashmix_kernel",)),
        "fused_probe": (lambda: lambda i: fused_probe(
            keys[i], state.bits, seeds, cfg.s), ("fused_probe_kernel",)),
    }
    versions = {name: [("earlier", earlier(parent, make), names),
                       ("current", make, names)]
                for name, (make, names) in current.items()}
    for name, vs in versions.items():
        got = {label: [] for label, _, _ in vs}
        for label, make, names in vs:
            make()(0)                                    # warm
        for label, make, names in (vs + vs[::-1]) * 2:   # in turns
            split = device_split(make(), n_b, names)
            wrap = wall_ms(make(), n_b)
            got[label].append((split, wrap))
        for label, turns in got.items():
            names = sorted({x for split, _ in turns for x in split})
            per = {x: sum(split.get(x, 0.0) for split, _ in turns)
                   / len(turns) for x in names}
            log(f"[compare] {name} {label}: device "
                f"{sum(per.values()):.6f} ms per call ("
                + ", ".join(f"{x} {v:.6f}" for x, v in per.items())
                + f"; turns {[round(sum(sp.values()), 6) for sp, _ in turns]})"
                f"; through its wrapper, calls back to back "
                f"{sum(wr for _, wr in turns) / len(turns):.6f} ms "
                f"(turns {[round(wr, 6) for _, wr in turns]}; {card})")
        lap(f"{name} in turns")
    return out


def bitset_pieces(cfg, st, kw, v):
    """The plain-PyTorch pieces of a bitset step, for the host clock."""
    from repro_torch.core import batched
    return {
        "intra_batch_seen (sort join)":
            lambda: batched.intra_batch_seen(kw, v),
        "draw_randomness (threefry)":
            lambda: batched.draw_randomness(cfg, st.rng, BATCH),
    }


def sbf_pieces(cfg, st, kw, v):
    """The plain-PyTorch pieces of an sbf step, for the host clock."""
    from repro_torch.core import batched, hashing
    seeds, _ = host_seeds(cfg)
    pos = hashing.hash_positions(kw, seeds, cfg.s)
    _, start = batched.draw_sbf_randomness(cfg, st.rng, BATCH)
    return {
        "draw_sbf_randomness (threefry)":
            lambda: batched.draw_sbf_randomness(cfg, st.rng, BATCH),
        "sbf_event_deltas (the two event sorts, no planes)":
            lambda: batched.sbf_event_deltas(cfg, pos, start, v,
                                             build_planes=False),
    }


def fleet_pieces(fleet, tenants):
    """The plain-PyTorch pieces of a fleet step, for the host clock: the
    routing, and the step's draws over the (T, 2) keys; sbf's event sorts
    over the (T, C) grid."""
    def make(cfg, st, kw, v):
        import torch
        from repro_torch.core import batched, hashing
        ten = torch.from_numpy(tenants[:BATCH]).cuda()
        slot_keys, slot_valid, *_ = fleet.route(kw, ten, v)
        c = slot_keys.shape[1]
        pieces = {"route (tenant_rank, slot scatter)":
                  lambda: fleet.route(kw, ten, v)}
        if cfg.variant != "sbf":
            pieces["draw_randomness over (32, 2) keys (threefry)"] = \
                lambda: batched.draw_randomness(cfg, st.rng, c)
            return pieces
        seeds, _ = host_seeds(cfg)
        pos = hashing.hash_positions(slot_keys, seeds, cfg.s)
        _, start = batched.draw_sbf_randomness(cfg, st.rng, c)
        pieces["draw_sbf_randomness over (32, 2) keys (threefry)"] = \
            lambda: batched.draw_sbf_randomness(cfg, st.rng, c)
        pieces["sbf_event_deltas over (32, C) (the two event sorts)"] = \
            lambda: batched.sbf_event_deltas(cfg, pos, start, slot_valid,
                                             build_planes=False)
        return pieces
    return make


def phase_profile(cfg, state, card, make_pieces, kernels, fleet=None,
                  tenants=None):
    """Where a step's time goes on the path of ``cfg`` (of ``fleet`` when
    given, its mixed batches' tenant ids from ``tenants``): the host clock
    per call of the step's plain-PyTorch pieces (each call synchronised;
    the kernels' times are the "time" phase's), then torch.profiler over
    PROFILE_STEPS steps for the device's busy time, its kernel count and
    idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import Dedup, u32
    from repro_torch.data.streams import controlled_distinct_stream
    n_b = PROFILE_STEPS
    keys, _ = controlled_distinct_stream(n_b * BATCH, DISTINCT_FRAC,
                                         seed=SEED + 2)
    if fleet is None:
        eng = Dedup(cfg)
        tag = (f"{cfg.variant} 256 MB {cfg.effective_layout}, batch "
               f"{BATCH}")

        def run(st, x):
            return eng.run_stream(st, x)[0]
    else:
        tag = (f"{cfg.variant} fleet {FLEET_T} x 8 MB, batch {BATCH}, "
               f"C={fleet.capacity}")

        def run(st, x):
            return fleet.run_stream(st, x, tenants[:len(x)])[0]
    st = state._replace(bits=state.bits.clone())
    kw = u32.from_numpy_u32(keys[:BATCH], "cuda")
    v = torch.ones(BATCH, dtype=torch.bool, device="cuda")
    for name, fn in make_pieces(cfg, st, kw, v).items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_b):
            fn()
            torch.cuda.synchronize()
        log(f"[profile] {tag}: piece {name}: "
            f"{(time.perf_counter() - t0) / n_b * 1e3:.4f} ms per call "
            f"(host clock, synchronised; {card})")
    st = run(st, keys[:BATCH])                        # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(st, keys)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n_b * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st = run(st, keys)
        torch.cuda.synchronize()
    rows = prof.key_averages()
    dev_rows = [r for r in rows if str(getattr(r, "device_type", "")).endswith(
        "CUDA") and getattr(r, "self_device_time_total", 0) > 0]
    busy = sum(r.self_device_time_total for r in dev_rows) / 1e3 / n_b
    n_kernels = sum(r.count for r in dev_rows) / n_b
    n_ops = sum(r.count for r in rows if r.key.startswith("aten::")) / n_b
    log(f"[profile] step ({tag}): host wall {wall:.4f} ms per step "
        f"unprofiled; {n_ops:.1f} aten ops per step on the host ({card})")
    if dev_rows:
        log(f"[profile] {tag}: device busy {busy:.4f} ms per step in "
            f"{n_kernels:.1f} kernels; idle share "
            f"{max(0.0, 1 - busy / wall):.4f} of the unprofiled wall")
        ours = []
        for x in ("hashmix_kernel",) + kernels:
            us = sum(r.self_device_time_total for r in dev_rows if x in r.key)
            ours.append(f"{x} {us / 1e3 / n_b:.6f} ms")
        log(f"[profile] {tag}: the port's kernels per step in this "
            f"trace: {', '.join(ours)}")
        for r in sorted(dev_rows, key=lambda r: -r.self_device_time_total
                        )[:12]:
            log(f"[profile]   {r.self_device_time_total / 1e3 / n_b:9.4f} ms"
                f" /step  x{r.count / n_b:6.1f}  {r.key[:90]}")
    else:
        log("[profile] the profiler recorded no device time: device busy "
            "share not measured")


def phase_lint(card, planes, pipes):
    """The hot-path linter on the card (``repro_torch.analysis``): first
    each kernel's registers, spills and shared memory per block from its
    ``ptxas -v`` report; then ``run_lint(device="cuda")`` over the whole
    entry matrix — the dispatch-trace rules, every step a second time
    under ``torch.cuda.set_sync_debug_mode("error")``, the kernels'
    resource budget and the source rules — and over one full-width step of
    each path in ``planes`` (name -> (config, 256 MB plane state), one
    ``run_stream`` batch) and ``pipes`` (name -> the dense8
    ``DedupPipeline``, one ``process``), each on the state its phase left
    (nothing new is allocated). Any finding outside
    ``analysis/lint_baseline.json``, or a stale suppression, fails the
    run."""
    import torch
    from repro_torch.analysis import (adopt_entry, load_baseline, render,
                                      run_lint)
    from repro_torch.analysis.__main__ import DEFAULT_BASELINE
    from repro_torch.analysis.entrypoints import leaf_list
    from repro_torch.analysis.trace_lint import parse_ptxas
    from repro_torch.core import Dedup, u32
    from repro_torch.data.streams import controlled_distinct_stream
    from repro_torch.kernels import build
    from repro_torch.kernels.common import KERNELS
    t0 = time.perf_counter()
    for source in KERNELS:
        for r in parse_ptxas(build.build_log(source)):
            log(f"[lint] {source}.cu {r.name}: {r.registers} registers, "
                f"spill stores {r.spill_stores} B, spill loads "
                f"{r.spill_loads} B, shared memory {r.shared} B per block")
    raw, _ = controlled_distinct_stream(BATCH, DISTINCT_FRAC,
                                        seed=SEED + 6)
    keys = u32.from_numpy_u32(raw, "cuda")
    truth = torch.zeros((BATCH,), dtype=torch.bool, device="cuda")
    extras = []
    for name, (cfg, state) in planes.items():
        eng, box = Dedup(cfg, "cuda"), [state]

        def run(eng=eng, box=box):
            box[0], _ = eng.run_stream(box[0], keys)
        extras.append(adopt_entry(f"full/{name}/cuda", cfg, "cuda", run,
                                  lambda box=box: leaf_list(box[0]),
                                  tags=("stream",)))
    for name, pipe in pipes.items():
        extras.append(adopt_entry(
            f"full/{name}/cuda", pipe.cfg, "cuda",
            lambda pipe=pipe: pipe.process({"key": keys}, truth),
            lambda pipe=pipe: leaf_list(pipe.state), tags=("stream",)))
    report = run_lint(device="cuda", baseline=load_baseline(DEFAULT_BASELINE),
                      extra_entries=extras)
    torch.cuda.synchronize()
    for line in render(report).splitlines():
        log(f"[lint] {line}")
    log(f"[lint] phase {time.perf_counter() - t0:.1f} s (host clock, the "
        f"kernels' reports included; {card})")
    if not report.ok:
        raise AssertionError("the hot-path linter found a violation outside "
                             "its baseline on the card")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="a directory holding an earlier hashmix.cu, "
                         "bloom_probe.cu, bitset_step.cu and "
                         "counter_step.cu to time against the current "
                         "ones")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is missing ({exc})",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {card} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {kind}")
    t0 = time.perf_counter()
    extra = start_extra_builds(args.parent)
    logs = build.build_all()
    floor_lib, parent = finish_extra_builds(extra)
    log(f"[build] {len(logs)} kernels (and the latency-floor kernels"
        f"{', the earlier sources' if parent else ''}) built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.strip().splitlines():
            log(f"[build] {name}: {line}")
    rng = np.random.default_rng(SEED)
    err = {"hashmix": phase_hashmix(rng), "bitset_step": phase_bitset(rng),
           "counter_step": phase_counter(rng)}
    err["bloom_probe"], err["scatter_delta"], err["fused_probe"] = \
        phase_ops(rng)
    stamp("kernels against plain")
    err["bitset_step_fleet"], err["counter_step_params_aware"] = \
        phase_fleet(rng)
    stamp("fleet")
    phase_digests()
    keys, truth = make_stream()
    # the plane paths' checkpoints live until the dense8 phase has read them
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        cfg, state, launches, rl_dups = phase_main_path(keys, truth,
                                                        ckpt_dir)
        sbf_cfg, sbf_state, sbf_launches, sbf_dups = phase_sbf_path(
            keys, truth, ckpt_dir)
        ops_launches = phase_ops_path(keys, truth)
        stamp("digests, stream and the three paths")
        dense8 = phase_dense8(keys, truth, {"rlbsbf": rl_dups,
                                            "sbf": sbf_dups}, ckpt_dir)
    del rl_dups, sbf_dups
    stamp("dense8")
    serve_keys = keys[:SERVE_N].copy()
    shard_keys, shard_truth = keys[:SHARD_N].copy(), truth[:SHARD_N].copy()
    f_keys, f_tenants, f_truth = fleet_stream(keys)
    del keys, truth
    fb, fb_state, fb_launches = phase_fleet_path("rlbsbf", f_keys, f_tenants,
                                                 f_truth)
    fc, fc_state, fc_launches = phase_fleet_path("sbf", f_keys, f_tenants,
                                                 f_truth)
    del f_keys, f_tenants, f_truth
    stamp("fleet paths")
    with nccl_group(card):         # the shard phase's, kept for "mesh"
        phase_shard(shard_keys, shard_truth, card)
        del shard_keys, shard_truth
        stamp("shard")
        phase_serve(serve_keys, card)
        stamp("serve")
        lm_launches, lm_hash_err = phase_lm(card)
        err["hashmix"] = max(err["hashmix"], lm_hash_err)
        stamp("lm")
        moe_launches, moe_hash_err = phase_moe(card)
        err["hashmix"] = max(err["hashmix"], moe_hash_err)
        stamp("moe")
        train_launches, train_hash_err, kept = phase_train(card)
        err["hashmix"] = max(err["hashmix"], train_hash_err)
        stamp("train")
        mesh_launches = phase_mesh(card, kept)
        del kept
        stamp("mesh")
    gr_launches, gr_hash_err = phase_graph_recsys(card)
    err["hashmix"] = max(err["hashmix"], gr_hash_err)
    stamp("graph_recsys")
    ex_launches = phase_examples(card)
    stamp("examples")
    times = phase_timings(cfg, state, sbf_cfg, sbf_state, card,
                          ((fb, fb_state), (fc, fc_state)), floor_lib,
                          parent)
    stamp("time")
    phase_profile(cfg, state, card, bitset_pieces, BITSET_KERNELS)
    phase_profile(sbf_cfg, sbf_state, card, sbf_pieces, COUNTER_KERNELS)
    # the dense8 steps launch hashmix and no step kernel
    for (d8_cfg, d8_pipe), pieces in zip(dense8.values(),
                                         (bitset_pieces, sbf_pieces)):
        phase_profile(d8_cfg, d8_pipe.state, card, pieces, ())
    p_tenants = np.random.default_rng(SEED + 5).integers(
        0, FLEET_T, 16 * BATCH).astype(np.int32)
    for fleet, st, kern in ((fb, fb_state, BITSET_KERNELS),
                            (fc, fc_state, COUNTER_KERNELS)):
        phase_profile(fleet.cfg, st, card, fleet_pieces(fleet, p_tenants),
                      kern, fleet=fleet, tenants=p_tenants)
    stamp("profile")
    phase_lint(card, {"rlbsbf-256MB-planes": (cfg, state),
                      "sbf-256MB-planes": (sbf_cfg, sbf_state)},
               {f"dense8-{v}-256MB": pipe for v, (_, pipe) in dense8.items()})
    del dense8
    stamp("lint")
    # each kernel's launches, like its timed shapes, are those of the path
    # that carries it: the standalone hashmix is the sbf path's (the rlbsbf
    # path's bitset step hashes its keys itself), fused_probe and the
    # standalone bloom_probe the ops path's
    # hashmix: the sbf path's launches, the two LM-scored front ends', the
    # trainer's dedup stage's and the MoE train parts' (the "train" and
    # "mesh" phases'), the rankers' click-fraud stages' and the examples'
    hashmix_launches = {"hashmix": sbf_launches["hashmix"]
                        + lm_launches["hashmix"]
                        + moe_launches["hashmix"]
                        + train_launches["hashmix"]
                        + mesh_launches["hashmix"]
                        + gr_launches["hashmix"]
                        + ex_launches["hashmix"]}
    # the step kernels: their paths' launches and the examples' card runs'
    bitset_launches = {"bitset_step": launches["bitset_step"]
                       + ex_launches["bitset_step"]}
    counter_launches = {"counter_step": sbf_launches["counter_step"]
                        + ex_launches["counter_step"]}
    rows = [
        ("hashmix", "hashmix.cu", "hashmix.py:46", hashmix_launches,
         "hashmix"),
        ("bitset_step", "bitset_step.cu", "fused_template.py:349",
         bitset_launches, "bitset_step"),
        ("counter_step", "counter_step.cu", "fused_template.py:131",
         counter_launches, "counter_step"),
        ("bloom_probe", "bloom_probe.cu", "bloom_probe.py:42", ops_launches,
         "bloom_probe"),
        # hashmix, the split, bloom_probe and the AND in one launch
        ("fused_probe", "bloom_probe.cu", "bloom_probe.py:42", ops_launches,
         "fused_probe"),
        ("scatter_delta", "scatter_delta.cu", "scatter_delta.py:54",
         ops_launches, "scatter_delta"),
        # the tenant-grid forms on the fleet paths; the counter step's is
        # the TPU kernel's params_aware=True form
        ("bitset_step_fleet", "bitset_step.cu", "fused_template.py:349",
         fb_launches, "bitset_step"),
        ("counter_step_params_aware", "counter_step.cu",
         "fused_template.py:131", fc_launches, "counter_step"),
    ]
    kernels = [dict(name=name, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{src}",
                    replaces=f"src/repro/kernels/{tpu}",
                    launches=path[key], max_abs_err=err[name],
                    library_ms=None, **times[name])
               for name, src, tpu, path, key in rows]
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
