#!/usr/bin/env python3
"""Drive the PyTorch port (``tensorflowonspark_torch``) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one NVIDIA card (built for ``sm_90a``: an H100), the CUDA toolkit
(``nvcc``) and nothing of JAX.  Phases, each of which fails the run:

1. Print the card's name and power limit, and whether its Python can be
   embedded (``Python.h`` and a shared ``libpython``, which the native
   inference shim builds against; printed, not gated); build every kernel
   from ``tensorflowonspark_torch/csrc`` (timed).
2. Kernel phase: ``group_norm_act`` against its plain PyTorch twin at every
   (shape, mode) the ResNet-50 forward gives it, in bf16, at batch 32 (the
   serving slice's), 64 (the training slice's) and 256 (where the device
   is the limit), on the one-pass cluster path; then one oversize case
   (a 224² sample of 64 channels) on the two-pass path.  Each case: the
   path it took, max abs error against the stated tolerance, the same bits
   from two runs, then the kernel's, the plain twin's (batches 32 and 64)
   and one PyTorch call's (``F.group_norm`` → add →
   ReLU, a yardstick the port never calls) times with CUDA events, beside
   the least time the card could take (``bound_ms``); and the wrapper's
   host time per call.
3. Model phase: full ``Config()`` ResNet-50 at 224², bf16, seeded weights.
   Kernel path against the plain path and against an f32 forward (TF32
   off), exactly 53 one-pass and no two-pass launches per forward,
   images/s at batch 256 and its device time by kernel family.
4. Serving slice, the first slice's main path: export the weights, then
   ``TFModel.transform`` on a local-substrate DataFrame (127 rows, 3 ragged
   partitions, ``local[1]``) on the card, checking the scores against an
   in-process forward, the executor's kernel launches and the shape
   signatures it saw.  rows/s.
5. Backward-kernel phase: the backward of ``group_norm_act`` against its
   plain twin (``group_norm_act_backward_plain``) at every (shape, mode)
   of the forward, at batches 32, 64 and 256, on the one-pass cluster
   path (its cluster and whether x stays in shared memory printed per
   case); then the oversize case on the four-launch path.  Each case: the
   training forward's output and (mean, rstd) against the plain twin's;
   dx and d_residual within 2 bf16 ulps, dγ and dβ within a relative L2,
   the same bits twice, one wrapper call counted on its planned path a
   call; the kernel's, the plain twin's (batches 32 and 64) and one
   PyTorch call's times (autograd of bf16 ``F.group_norm`` → add → ReLU,
   a yardstick the port never calls) beside ``bound_ms``; the four-launch
   kernels forced at the same shape, checked the same way and timed in
   turns with the one pass; and the backward wrapper's host time per call.
6. Training-model phase: full ``Config()`` ResNet-50 at 224².  One step's
   gradients on the kernel path against the plain path (both bf16) and an
   f32 plain model (TF32 off); the backward alone (kernel forward under
   the kernel and under the plain backward), with two planted faults that
   its gate must catch; every gradient finite and nonzero; exactly 53
   forward and 53 backward launches a step; 8 AdamW steps on one batch,
   kernel against plain, with a falling loss; train-step images/s at batch
   256 (CUDA events), peak memory, and the step's device time by family.
7. Training slice, the ResNet main path: ``TFCluster.run`` (one
   executor, ``InputMode.SPARK``) → ``cluster.train`` over 192 rows of 224²
   images in 3 partitions → ``DataFeed.next_batch(device_put=
   trainer.shard)`` → 3 ``Trainer.step``s at batch 64 (eager, capture, at
   least one replay) → ``shutdown``.  The final loss against an in-process
   ``Trainer`` on the same batches, the executor's forward and backward
   launches, and the cluster's images/s.
8. Table-kernel phase: the table path of ``embedding`` on the full
   ``widedeep.Config()`` tables (2.6 M rows; deep rows of 32 f32, wide rows
   scalar) at batch 1024 (26,624 ids), both modes, every case from the same
   seeded tables: the step's deep and wide pair in one launch
   (``sparse_adagrad_update_tables``) for uniform, Zipf(1.1), int64,
   8-rank all-gathered Zipf (212,992 ids) and all-equal ids, and deep and
   wide alone (``sparse_adagrad_update``) for uniform and Zipf ids.  Each
   case: the grouping kernel against ``sort_ids`` bit for bit; the update
   bit for bit the plain version run on the CPU (on the touched rows, ids
   remapped onto them) and within ``TABLE_TOL_REL`` of the plain version
   on the card (its atomic order printed, not gated, where one row takes
   every occurrence); untouched rows bit-identical, the same bits twice,
   one grouping and one update launch a call.  Times: the grouping's,
   ``torch.sort``'s (the library call) and the plain grouping's, the
   update's, the whole path's (CUDA events) and each kernel's device time
   (CUPTI), the plain version's and the literal dense path's, beside
   ``bound_ms``; the path's host time a call.
9. Training-model phase, wide&deep: ``Trainer("wide_deep", Config())`` at
   batch 1024 on a device-resident batch, both ``table_update`` modes.  One
   step's MLP gradients and tables bit for bit the same step with the
   plain table update run on the CPU (which adds each row's occurrences in
   batch order, as the kernel does); 20 steps on ``synth_criteo`` rows
   with a falling loss and one grouping and one update launch a step;
   steps/s (CUDA events), peak memory and the step's device time by family
   (the grouping, the update and any sort named apart).
10. Wide&deep slice, this slice's main path, once per mode: ``TFEstimator(
   criteo_train_fn).fit(df)`` (a port of ``examples/criteo/
   criteo_pipeline.py::train_fun``; one executor on the card, 4,096 rows in
   2 partitions, batch 1024) → ``TFCluster.run`` → ``cluster.train`` →
   ``DataFeed.next_batch(device_put=...)`` → 4 ``Trainer.step``s →
   ``trainer.export``; then ``TFModel.transform`` of the export (its
   serialized forward) and, by ``setModelName("wide_deep")``, of the same
   weights exported weights-only (the zoo's forward).  The executor's
   table launches (one grouping and one update a step), its losses against
   an in-process replay, both transforms' scores against an in-process
   forward of the exported weights, and steps/s by ``cluster.metrics()``.
11. ResNet-50 in ``InputMode.TENSORFLOW``, the way ``examples/imagenet/
   resnet_spark.py`` launches: 512 synthetic 224² TFRecords in 4 part files
   (``resnet.write_synthetic_tfrecords`` through the native codec, timed),
   then ``TFCluster.run(tensorflowonspark_torch/examples/resnet_spark.py::
   map_fun, InputMode.TENSORFLOW, master_node="chief")`` on one executor:
   ``shard_files`` → ``tfrecord_batches(batch 64, one reader, a seeded
   shuffle buffer, prefetch 2, device_put=trainer.shard)`` → 8
   ``Trainer.step``s.  Gates: the executor on the card, every loss finite,
   53 one-pass forward and 53 backward launches a step, the final loss
   against an in-process replay of the same shard through the same
   reader.  images/s by ``cluster.metrics()`` and over the loop's wall
   time, beside phase 7's and phase 6's.  The job checkpoints at its
   last step, 8 (``--ckpt_dir``, asynchronously), and its chief writes
   the self-describing export (``--model_dir``): phase 13 goes on from
   both.
   The same job runs again with neither (PR 7's phase 11): its losses
   must be the first job's, and its images/s are printed beside.
12. Wide&deep in ``InputMode.TENSORFLOW`` over Parquet, the way
   ``examples/criteo/criteo_pipeline.py --input parquet`` launches, in
   phase 11's local application (its executor carries over): 4,096 Zipf
   rows saved by ``dfutil.saveAsParquet`` in 2 part files, then
   ``TFCluster.run(tensorflowonspark_torch/examples/criteo_pipeline.py::
   parquet_train_fun)``: ``parquet_batches`` → the example's stager (f32
   dense, i32 ids and labels, ``trainer.shard``) → 4 ``Trainer.step``s at
   batch 1024 (full ``Config()``, the combine update).  Gates: the executor
   on the card, one grouping and one update launch a step, every loss
   within 1e-5 of an in-process replay over the same batches, and those
   batches equal to the DataFrame's rows.  steps/s beside phase 10's.
13. Persistence, in phase 11's application: (a) a second ``TFCluster.run``
   of the example restores phase 11's newest checkpoint
   (``restore_latest()`` must give 8) and takes 4 more steps on the next
   records: 53 + 53 launches a step, its losses within 1e-5 of steps
   9-12 of phase 11's replay (12 uninterrupted steps through the same
   reader), and its step-12 checkpoint (params, AdamW moments, steps)
   within 1e-4 of the replay's state; the reader of a restart at step
   500 is timed.  (b) In process, ResNet-50 at batch 64: a
   device-side clone of the state when an asynchronous cadence save
   fires, two more steps at once while the writer is held back, then
   ``finish_checkpoints``: the checkpoint equals the clone bit for bit
   (params, AdamW moments, steps), so does the trainer after restoring
   it, and a planted fault (the writer reading the live tensors) must be
   caught.  (c) Wide&deep ``Config()``
   at batch 1024, combine: a checkpoint at step 4 restored into a trainer
   of another seed, 4 steps on each: every tensor bit-identical, one
   grouping and one update launch a step after the restore.  (d)
   ``TFModel`` with no ``model_name`` and no ``predict_fn`` serves phase
   4's 127 rows from phase 11's export (written on the card) and from the
   same weights exported in a spawned CPU process: scores within phase
   4's tolerance of the weights in process (whether the bits match is
   printed), 53 ``gn_one_pass`` launches a batch that calls the wrapper
   on the executor (each bucket eager at its first sighting, captured at
   its second; at least one batch a graph replay, which calls none), the
   program's bytes beside the weights'; then (c)'s wide&deep export.  (e)
   A re-export with new weights to phase 11's path is served fresh.
   Printed: checkpoint bytes, the cadence save's cost on the step path
   against the background write, restore, export (trace and writes) and
   model-load seconds, and the host µs of ``torch.ops.tfos.
   group_norm_act`` against ``group_norm_act``.

14. The rest of the model zoo.  (a) Both GroupNorm kernels at every
   distinct site of Inception-v3 (canonical and SAME), MobileNet-v1 and
   the CIFAR CNN at full width, bf16, batch 64, GN+ReLU: against the plain
   twins, on the path each plan takes (the card's cluster capacity tables
   printed first; the Inception stem's 147²×64, 71²×192, 150²×64 and
   75²×192 samples on the one pass over a non-portable cluster of 9–16
   blocks, each beside its forced two-pass forward and four-launch
   backward twin), timed against ``bound_ms`` and the library call;
   totals a training step per model.  (b) Inception-v3 canonical at
   299²: one step's gradients (its loss with the aux head's 0.4·CE) on the
   kernel path against the plain path and f32, 96 + 96 launches a step on
   their planned paths; 8 AdamW steps kernel against plain; the train-step
   rate at batch 128 with its profile; the forward at batch 256.  (c) and
   (d) ``resnet_spark --arch inception_v3`` (256 records of 299²) and
   ``--arch mobilenet_v1`` (224²) as phase 11 runs ResNet-50, 4 steps,
   against in-process replays, 94 + 94 and 27 + 27 launches a step.  (e) ``TFModel`` serves
   (c)'s export: its serialized forward (94 launches a batch that calls
   the wrapper, at least one graph replay, the eager
   forward's bits) and the weights by name.  (f) ``mnist_spark``'s
   ``map_fun`` on one executor in ``InputMode.SPARK`` against an in-process
   replay, and its self-describing export served.  (g) ``cifar10_spark``
   with its defaults (2 reader threads): every record trained each epoch,
   a falling loss, 6 + 6 launches a step.  (c)-(g) run in phase 11's
   application.  The sub-phases' failures are gathered and fail the run
   at the end; phase 14 prints its seconds.
15. BERT-base SQuAD (``bert.Config()``: 12 layers, hidden 768, 12 heads,
   MLP 3072, vocabulary 30,522; seeded weights, no depth cut) at the BERT
   paper's SQuAD v1.1 recipe, sequence 384, batch 32, lr 5e-5, on
   ``synth_squad`` rows (padding tails).  BERT reaches none of the port's
   kernels: its attention is SDPA with an additive mask.  (a) One
   step's gradients at batch 4: the card's path against f32 (plain
   attention, TF32 off) and against the plain path run on the card, each
   by its distance from f32, over all leaves and leaf by leaf; a planted
   fault (the mask dropped) must read above the gate.  (b) 8 AdamW steps
   (weight decay 0.01) on one batch of 8, bf16 against f32, with a
   falling loss.  (c) The device-resident train step at 32 with and
   without remat: sequences/s and tokens/s, peak memory, the profile by
   family (GEMMs, attention and its SDPA backend, LayerNorm with the
   residual adds and casts, GELU, the embeddings, AdamW, other), the idle
   share and the share of the bf16 dense peak from the counted FLOPs.
   (d) The forward at 64.  (e) ``tensorflowonspark_torch/examples/
   bert_squad.py``'s ``map_fun`` (``Config(remat=True)``) on one executor
   in ``InputMode.SPARK`` over a DataFrame of 256 rows in 4 partitions,
   every loss against an in-process replay, sequences/s by
   ``cluster.metrics()``, the export written.  (f) ``TFModel.transform``
   serves 67 rows (one all padding) from that export: both columns the
   eager forward's bits.  The GroupNorm and table kernels' launches are
   counted in every process of the phase and must be 0.  Phase 15 runs in
   phase 11's application and prints its seconds.
16. The compiled step (``parallel.train.compile_step``: each batch
   signature's step captured into one CUDA graph at its second sighting,
   replayed after; every ``Trainer`` of phases 1-15 steps through it too).
   (a) For ResNet-50 ``Config()`` at 8, Inception-v3 canonical at 4,
   MobileNet-v1 at 8, the CIFAR CNN at 64, the MNIST MLP at 128,
   wide&deep ``Config()`` at 1024 in both modes and BERT-base at 8 x 384
   with remat on and off: 8 steps through ``Trainer`` against 8 eager steps
   (the step swapped for ``make_train_step`` / ``make_sharded_train_step``)
   of the same seed, weights, optimizer and batches: every loss, parameter,
   optimizer state, table and accumulator bit for bit (BERT: phase 15's
   gate, the first loss bit for bit, the rest within 3e-3).  (b) The
   planned launches (ResNet 53 + 53, Inception 96 + 96, MobileNet 27 + 27,
   CIFAR 6 + 6, a grouping and a segment walk a wide&deep step, none for
   MNIST and BERT) counted by the wrappers in every eager step and in the
   capture, none in a replay (which calls no wrapper), and counted by
   kernel name in a profiler trace of step 8, a replay in the graph run
   and an eager step in the other.  (c) A planted fault, replays whose static inputs
   keep the capture's batch, must fail (a).  (d) ResNet's step-4
   checkpoint restored into the trainer that captured, then steps 5-8:
   bit for bit the uninterrupted run.  (e) Eager beside captured on the
   same trainer: rate, device busy ms and idle share, ``Trainer.step``'s
   host µs (captured: ``graph.replay()`` alone, the batch's copy into the
   static inputs and the rest), the capture's seconds, peak memory allocated and reserved, for
   wide&deep at 1024 (both modes), Inception canonical at 128, BERT-base at
   32 x 384 (remat on, off) and ResNet-50 at 64 and 256; the ``foreach``
   AdamW captured beside the default, ``fused=True``.  (f) The compile
   cache: a subprocess builds the three libraries into an empty
   ``_build`` through ``TFOS_COMPILE_CACHE_DIR``; a second, with no
   ``nvcc``, loads all three from the cache and launches each against its
   plain twin; a third, on a copy with one entry corrupted, rejects it and
   rebuilds it.  Phase 16 prints its seconds beside its budget; ``python3
   chip_smoke.py --phase 16`` runs the build and this phase alone.
17. The generative decode tier (``decode.DecodeEngine`` over
   ``models/tinylm.py`` at ``Config()``, full width, seeded weights; 8
   slots, pages of 16, 128 positions, prompts up to 64).  (a) The paged
   kernels (``tfos_kv_append``, ``tfos_paged_attention``) against their
   plain twins run on the card, at the engine's decode step (8 rows, one
   position), at each chunk rung (16 and 32 positions), at the verify
   steps of speculation (8 rows of k + 1 = 2, 3 and 5 positions), at the
   draft model's geometry (``Config.draft_for``: 1 layer, 2 heads of 16;
   8 rows of 1 and of 32 positions), at 16 decode rows
   over up to 1,024 positions (64 pages of 16 a row) and at 256 rows of
   128 positions over 2,049 pages; rows inactive, crossing a page, sharing
   another's pages and ending at max_len - 1: the append bit for bit
   outside page 0, the attention within ``ATTN_TOL`` and the same bits
   twice; ms a call of each, its twin and the library yardstick
   (``index_put_``; ``index_select`` gathers + SDPA) beside ``bound_ms``,
   and the append's µs a launch under CUPTI (``cupti_ms`` in the kernels
   line): at the engine's shapes the events time is the wrapper's host.
   (b) 32 greedy requests at once (a third extend registered prefixes,
   some diverging mid-page): every stream equals the same engine's one at
   a time, the full forward's greedy choice (``apply_tokens``, near-ties
   within ``DECODE_TIE_GAP`` counted) and a legacy-prefill engine's; COW
   copies and prefix hits; after ``stop()`` no used page, the pool's law
   and the pools unmoved; ``warmup()`` captured one CUDA graph a signature
   and serving captured and ran eagerly nothing after; the wrappers'
   launches are the warmup's; a planted off-by-one causal bound (a
   ``-DTFOS_PLANTED_CAUSAL_OFF_BY_ONE`` build) and replays on stale static
   inputs must change the streams, and an append writing the slot after p
   (``-DTFOS_PLANTED_APPEND_OFF_BY_ONE``) must fail (a)'s append gate.
   (c) Aggregate and one-at-a-time tokens/s, TTFT and ITL p50/p99, and
   on an idle engine the decode and
   chunk steps captured against eager (host µs a step, busy ms, idle
   share) with their launches counted by the wrappers and by a traced
   replay.  (d) ``DecodeHTTPServer`` streams one generation over ``POST
   /v1/generate``, equal to the engine's.  (e) Speculation
   (``spec_tokens=4``, the ladder 1, 2, 4) on (b)'s 32 requests: the
   n-gram drafter, a model drafter with the target's own config and
   weights ("perfect") and one with ``Config.draft_for`` and seeded
   weights at ten times the init's scale (``COLD_DRAFT_SCALE``: "cold"):
   each engine's streams equal (b)'s greedy ones, a
   difference allowed only where its first position is a near-tie within
   ``DECODE_TIE_GAP`` (counted), and every token is the full forward's
   greedy choice by (b)'s rule; ``warmup()`` captured one graph a
   signature (the verify rungs and the drafter's ``draft_`` set) and
   serving captured and ran eagerly nothing; replays; the perfect
   drafter's acceptance 1.0, the cold one's controller shifted; the
   wrappers' launches the warmup's (both models' layers); two fresh
   engines serve a seeded sampled workload (temperature 0.8, top-p 0.9)
   to equal streams and ``top_k=1`` gives the greedy streams; the planted
   off-by-one causal bound on the verify path and a token choice that
   accepts every draft must change the streams; tokens/s, acceptance and
   final k, and the captured verify step at k = 4 on an idle engine (host
   µs, busy ms by family).  Phase 17 prints its seconds beside its budget,
   and (e) its own; ``python3 chip_smoke.py --phase 17`` runs the build
   and this phase alone.

18. BatchNorm training (``norm="batch"``: flax's ``momentum=0.9``, ε
   1e-5, through torch's fused ``native_batch_norm``; no hand-written
   kernel) for ResNet-50 ``Config(norm="batch")`` at 224² and
   Inception-v3 ``Config(canonical=True, norm="batch")`` at 299², bf16
   compute, f32 params, seeded.  (a) ResNet-50 at 8 rows: one f32 step's
   gradients on the card against the same step on the host
   (``BN_GRADS_F32_VS_HOST``); the bf16 step's loss against its f32
   twin's (``BN_BF16_LOSS_REL``) and each of its BatchNorm sites, output
   and input gradient, against f64 on that site's own inputs
   (``BN_BF16_SITE``), with planted faults that must read above; every
   gradient finite and nonzero; after
   one ``Trainer.step`` the running statistics against flax's rule
   recomputed on the host in f64 from the norms' inputs (the batch's mean
   and biased variance), within ``BN_STATS_TOL``, and a planted fault
   (torch's ``batch_norm``, whose running variance is the unbiased one)
   must read above it.  (b) 8 captured steps bit for bit 8 eager ones
   (losses, parameters, AdamW state and running statistics) for ResNet-50
   at 32 and Inception-v3 at 16, no hand-written kernel counted or traced;
   then rate, busy ms and idle share, host µs, capture s, peak memory
   allocated and reserved at 256 (ResNet) and 128 (Inception), eager beside
   captured, and the eager step's busy ms by family (convs, BatchNorm
   statistics, BatchNorm apply and backward, casts/pads/pool, AdamW,
   other).
   (c) After (b)'s steps one row's logits are the same bits alone, in its
   batch and in another batch; a planted train-mode forward at eval must
   break that.  (d) The graph run checkpoints at its step 8
   (``Trainer.checkpoint``); a trainer of another seed ``restore_latest()``
   s it: every tensor, ``batch_stats`` included, the run's bits, and one
   more step on each gives the same loss and state.  (e) ResNet's
   ``Trainer.export`` → ``TFModel.transform`` of 35 rows by the serialized
   forward and by name: the bits of ``Trainer.predict``; then
   ``TFCluster.run`` → ``DataFeed`` → ``Trainer.step`` at 32 on 64 rows in
   2 partitions (``InputMode.SPARK``): the final loss against an in-process
   replay, at least one graph replay.  (f) No hand-written kernel launches
   in the phase's processes.  Phase 18 runs in phase 11's application
   after phase 16, and prints its seconds beside ``PHASE18_BUDGET_S``;
   ``python3 chip_smoke.py --phase 18`` runs the build and this phase
   alone.

19. The online serving tier (``online.OnlineServer``, its HTTP front end
   and ``infer_embed``), in a process of its own (``--phase 19``: its
   card-health probe and signature counters start there).  Two tenants,
   seeded, warmed on load, so ``add_tenant`` captures every bucket's
   forward into one CUDA graph: ``resnet`` (ResNet-50 ``Config()``, its
   self-describing export, batch 32, buckets 8 and 32) and ``ctr``
   (wide&deep ``Config()`` by ``model_name``, batch 256, buckets 64, 128
   and 256, ``flush_ms`` 5).  (a) Closed-loop clients (16 × 8 single rows
   on ``resnet``, 32 × 16 on ``ctr``, both at once) through ``submit``:
   every reply equals its row scored alone by the eager forward at the
   bucket it rode, bit for bit; a scatter that swaps a batch's first two
   requests must read above.  (b) Each captured bucket's replay is the
   eager forward's bits on the same staged batch, and ``_RunModel``'s
   one-batch-behind emit of 96 rows at 32 too; reading a replay's static
   outputs (``CapturedForward.hold`` planted away) must fail it.  (c)
   ``gn_one_pass`` launches on the online path: 53 a ResNet forward,
   an eager call and a capture a bucket, none in a replay (a traced
   replay shows its 53), no plain-twin GroupNorm on the card.  (d)
   ``OnlineHTTPServer``: ``POST /v1/predict`` replies equal ``submit``'s,
   ``/healthz``'s ``compile_cache.warm_ratio`` 1.0, ``/metrics`` names
   ``online_requests_total`` and ``online_coalesce_size``, a shed is a 429
   with ``Retry-After``.  (e) ``infer_embed`` serves the ResNet export on
   the card with the eager forward's bits.  (f) Printed, from timed
   windows of ``ONLINE_WINDOW_S`` at (a)'s client counts: rows/s and
   p50/p99 per tenant against the same clients calling the captured
   forward one request a forward, the coalesce sizes and the
   ``"online"`` flight plane over the window, the card's idle share from
   a profiler trace of a second such window (its rates printed beside);
   a batch's host µs and busy ms on an idle card, capture seconds a
   bucket.  (g) The probe ran once there and passed.  Phase 19
   prints its seconds beside ``PHASE19_BUDGET_S``.

The last lines are the card line, one JSON line listing each kernel (the
one-pass and two-pass forwards of ``group_norm_act`` and its one-pass and
four-launch backwards, times at the training slice's batch and under
``_b32``/``_b256`` at the others; the table path's id grouping, and its
update in each mode, times of a training step's pair on Zipf ids, the
other cases suffixed; ``launches_tf_mode`` counts phases 11-12's,
``launches_phase13`` phase 13's, ``launches_phase14`` the executors' of
phase 14(c)-(g), ``phase14_*`` the zoo's sites on each GroupNorm
path, ``launches_phase15`` phase 15's and ``launches_phase16`` phase 16's
(a)-(d), ``replay_launches_phase16`` the kernels its traced replays ran,
``launches_phase18`` phase 18's (none), ``launches_phase19`` phase 19's
main path (GroupNorm only: its warm-ups and captures);
then the two paged kernels, times of the decode step's case and the others
suffixed, ``launches_phase17`` the main path's (the warmup's eager calls
and captures), ``launches_phase17e`` those of 17(e)'s three speculating
engines and ``replay_launches_phase17`` a traced decode and chunk
replay's).
Every count is a wrapper's where it launches, a CUDA graph's capture
included; a replay calls no wrapper, so the gates of phases 6-15 plan
their counts for the steps less those a replay ran alone
(``parallel.train.replayed_steps``, published by each job), and 16(b)
counts replays from traces.  Then
``{"ok": true, "device": {...}}``.
Without a card it exits 1 and prints no result.
"""

from __future__ import annotations

import collections
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
L2_BYTES = 50e6
KERNEL_BATCH = 32
MODEL_BATCH = 256
SLICE_ROWS = 127
SLICE_BATCH = 32
OVERSIZE_SHAPE = (2, 64, 224, 224)  # 6.4 MB a sample: beyond 8 blocks

# stated tolerances
KERNEL_TOL_ULPS = 2  # |kernel - plain| <= 2 bf16 ulps of max(1, max|plain|)
LOGITS_KERNEL_VS_PLAIN = 1e-2  # rel L2, bf16 both: rounding flips only
LOGITS_BF16_VS_F32 = 3e-2  # rel L2, bf16 vs f32 forward (CPU measured 7e-3)
SLICE_VS_IN_PROCESS = 1e-3  # rel L2, same kernels, weights and batches
BWD_PARAM_REL_L2 = 1e-3  # dγ, dβ: f32 sums over N·H·W in another order
# the training forward's (mean, rstd) against the plain twin's, abs, of
# max(1, |plain|): f32 sums over H·W·C/G in another order
STATS_TOL = 1e-4
# one step's gradients, rel L2 over all parameters.  Measured on the CPU at
# full width, 64², batch 4 (tests/test_torch_train.py, the full-width
# test): bf16 vs f32 0.46, the rounding of 53 bf16 layers amplified
# through a random-init network.  On the card (224², batch 8) the kernel
# path and the plain path, both bf16, differ by 0.146 and each from f32 by
# about 0.2: two bf16 paths are held to each other, and the kernel path to
# f32, as closely as the plain bf16 path is to f32
GRADS_BF16_VS_F32 = 0.75
GRADS_VS_F32_OVER_PLAIN = 1.25  # <= this x plain-vs-f32 + 0.02
# the backward alone: one step's gradients with the kernel forward and the
# kernel backward against the kernel forward and the plain backward.  The
# ReLU masks, pool choices and statistics are the same, so the gap is the
# bf16 rounding of dx at every site (ResNet-50's 53, Inception-v3's 96)
# carried linearly down the net, and cuDNN's nondeterministic weight
# gradients: predicted ~1e-2 before the first card run of each.  Each
# planted fault (a centering term of dx dropped at every site) must read
# above it.
GRADS_SAME_FORWARD = 5e-2
# 8 AdamW steps (lr 1e-4) on one batch: |kernel - plain| <= this x the
# first loss at every step (CPU, 64², batch 4, the same test: 7.0e-4), and
# the last loss below half the first
TRAJECTORY_TOL = 0.02
TRAIN_STEPS = 8
TRAIN_LR = 1e-4
TRAIN_GRAD_BATCH = 8
# phase 7 runs 192 rows in 3 partitions (256 in 4 before phase 17 was
# added; a depth cut): three steps at 64, the eager one, the capture and a
# replay, the steady state a DataFeed batch copied into the captured
# graph's static inputs
SLICE_TRAIN_ROWS = 192
SLICE_TRAIN_PARTITIONS = 3
SLICE_TRAIN_BATCH = 64
SLICE_TRAIN_VS_IN_PROCESS = 1e-2  # rel, final loss: cuDNN weight grads
# (batch, (kernel, plain, library) timed calls): the serving slice's batch,
# the training slice's (the main path: the JSON line's unsuffixed numbers)
# and the rate's
FWD_BATCH_CALLS = ((KERNEL_BATCH, (50, 20, 20)),
                   (SLICE_TRAIN_BATCH, (30, 10, 10)),
                   (MODEL_BATCH, (20, 0, 5)))
BWD_BATCH_CALLS = ((KERNEL_BATCH, (30, 10, 10)),
                   (SLICE_TRAIN_BATCH, (20, 5, 5)),
                   (MODEL_BATCH, (10, 0, 3)))

# wide&deep (phases 8-10)
WD_BATCH = 1024
WD_ZIPF = 1.1  # Criteo's categorical features are heavy-tailed
WD_LR = 1e-3  # AdamW on the MLP; the tables take 10x (Config's table_lr)
WD_STEPS = 20
# phases 10 and 12 run 4,096 rows in 2 partitions of 2 batches (8,192 in 4
# before phase 17 was added; a depth cut, their gates unchanged)
WD_SLICE_ROWS = 4096
WD_SLICE_PARTITIONS = 2
WD_MODES = (("dense", "combine"), ("sparse", "sparse"))  # table_update, path
# InputMode.TENSORFLOW slices (phases 11-12)
TF_RECORDS = 512  # ResNet: 224² TFRecords, ≈ 77 MB in all
TF_PARTS = 4
TF_SHUFFLE = 256  # seeded shuffle buffer of records; one reader thread
# phase 14(c)-(d)'s records (512, TF_RECORDS, before phase 17 was added;
# a depth cut, the gates unchanged: 4 steps at batch 64)
ZOO_TF_RECORDS = 256
# persistence (phase 13)
# each job of phases 11 and 13(a) checkpoints once, at its last step: the
# save's host call then falls after the last step's time, outside the
# windowed rate, and the write runs while the job winds down.  Phase
# 13(b) times a save and its write against the steps around them
RESUME_STEPS = 4  # the resumed job's steps after the restored step 8
# the resumed job against the uninterrupted replay, the same kernels on
# the same records: the losses rel, and at step 12 each tensor of the
# state by max |Δ| / max |replay|.  The losses read rel 0 in every run so
# far; a restore that dropped the AdamW moments or the step moves those
# tensors by half their size or more
RESUME_LOSS_REL = 1e-5
RESUME_STATE_REL = 1e-4
# the step a restart's reader is timed at (phase 13(a)): 500 batches of
# 64 are 62.5 passes over phase 11's records, dropped unparsed
RESTART_AT_STEP = 500
WD_CKPT_STEPS = 4  # wide&deep: checkpoint at 4, then 4 steps on each side
PHASE13_BUDGET_S = 60
# |kernel - plain| <= this x max|plain| over the touched rows, table and
# accumulator: f32, and only the order of the duplicates' sums differs
# (the plain version's index_add_ adds them with atomics) besides
# torch.rsqrt's <= 2 ulps against the kernel's rn(1/rn(sqrt)).  The plain
# version run on the CPU adds in batch order, as the kernels do: against
# it every case is held bit for bit.  Where one row takes all 26,624
# occurrences, an f32 sum in any order sits about sqrt(n) * 2^-24 = 1e-5
# of the sum from the exact one (2e-5 of its square, the accumulator), so
# there the atomic order's distance is printed, not gated
TABLE_TOL_REL = 1e-5
# the design the table path replaced (a stable torch.sort of the ids, then
# one launch a table walking the sorted ids): device ms on an H100 80GB
# HBM3 at 700 W, from this script's phase 8 before the redesign
REPLACED_MS = {"sort": 0.044, "deep_uniform": 0.0078,
               "wide_uniform": 0.0029, "deep_zipf": 0.0296,
               "wide_zipf": 0.0237}
# one step's MLP gradients and params, kernel path against plain table
# update, rel L2: the table update does not reach them in the step, so
# only cuBLAS could differ
WD_MLP_REL = 1e-6
# the 20-step mean of the last 5 losses against the first loss
WD_FALL = 0.97
WD_SLICE_VS_REPLAY = 1e-5  # rel, every loss: same kernels and batches
WD_SCORES_VS_FORWARD = 1e-5  # max abs, probabilities


def launch_counts(**counts) -> dict:
    """A full ``launches_by_path`` dictionary: ``counts``, 0 elsewhere."""
    from tensorflowonspark_torch.kernels import group_norm

    return {**dict.fromkeys(group_norm.launches_by_path, 0), **counts}


def python_embed_line() -> str:
    """Whether this Python can embed into a C program: its headers
    (``Python.h`` under sysconfig's include dir) and its shared
    ``libpython`` (under ``LIBDIR``), which the native inference shim
    builds against.  Printed, not gated."""
    import sysconfig

    include = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ldlib = sysconfig.get_config_var("LDLIBRARY") or ""
    shared = bool(sysconfig.get_config_var("Py_ENABLE_SHARED"))
    return (f"python embedding: Python.h "
            f"{os.path.exists(os.path.join(include, 'Python.h'))} "
            f"({include}); shared libpython {shared} and "
            f"{os.path.exists(os.path.join(libdir, ldlib))} "
            f"({os.path.join(libdir, ldlib)})")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, calls: int) -> float:
    """Mean ms of ``fn()`` over ``calls`` launches, CUDA events, warmed."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def rel_err(a, b) -> float:
    import torch

    return float(torch.linalg.norm((a - b).float())
                 / torch.linalg.norm(b.float()))


def record_sites(model, image_size: int) -> list[tuple]:
    """(C, H, W, groups, residual?, relu) of every norm call of one forward,
    in order, from the real model (run with the plain twin)."""
    import torch

    from tensorflowonspark_torch.kernels import group_norm

    sites = []

    def recorder(x, gamma, beta, groups, eps, residual=None, relu=True):
        sites.append((*x.shape[1:], groups, residual is not None, relu))
        return group_norm.group_norm_act_plain(x, gamma, beta, groups, eps,
                                               residual, relu)

    model.norm_act = recorder
    try:
        with torch.inference_mode():
            model(torch.zeros(1, image_size, image_size, 3, device="cuda"))
    finally:
        model.norm_act = group_norm.group_norm_act
    return sites


def draw_case(shape, res: bool, seed: int, copies: int):
    """Seeded bf16 ``channels_last`` inputs: ``copies`` x (and residual)
    tensors, and f32 gamma/beta."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1]

    def draw():
        return (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5
                ).to(torch.bfloat16).contiguous(
                    memory_format=torch.channels_last)

    gamma = 1 + 0.5 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.5 * torch.randn(c, generator=gen, device="cuda")
    xs = [draw() for _ in range(copies)]
    rs = [draw() if res else None for _ in range(copies)]
    return xs, rs, gamma, beta


def measure_case(shape, groups: int, res: bool, relu: bool, seed: int,
                 path: str, kernel_calls: int, plain_calls: int,
                 library_calls: int) -> dict:
    """One (shape, mode) of ``group_norm_act``: checks it took ``path``,
    agrees with its plain twin within ``KERNEL_TOL_ULPS`` and gives the same
    bits twice, then times kernel, plain twin (if ``plain_calls``) and
    library call with CUDA events beside the bound.  Where the plan is a
    one pass over more than 8 blocks, the two passes, forced at the same
    shape, pass the same check against the plain twin and are timed in
    turns with it (one pass, two, two, one pass)."""
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_torch.kernels import group_norm

    n, c, h, w = shape
    plan = group_norm._plan(n, h, w, c, groups, group_norm._capacity(
        "forward", torch.cuda.current_device()))
    act_bytes = n * c * h * w * 2
    call_bytes = act_bytes * (3 if res else 2) + 2 * c * 4
    # rotate over copies so the working set is 4x L2: each launch
    # reads its inputs from device memory, as after a large conv
    copies = min(64, max(2, math.ceil(4 * L2_BYTES / call_bytes)))
    xs, rs, gamma, beta = draw_case(shape, res, seed, copies)
    ref = group_norm.group_norm_act_plain(xs[0], gamma, beta, groups, 1e-6,
                                          rs[0], relu)
    before = dict(group_norm.launches_by_path)
    out = group_norm.group_norm_act(xs[0], gamma, beta, groups, 1e-6, rs[0],
                                    relu)
    again = group_norm.group_norm_act(xs[0], gamma, beta, groups, 1e-6,
                                      rs[0], relu)
    torch.cuda.synchronize()
    took = {k: v - before[k] for k, v in group_norm.launches_by_path.items()}
    err = float((out.float() - ref.float()).abs().max())
    tol = KERNEL_TOL_ULPS * 2.0 ** -7 * max(1.0, float(ref.abs().max()))
    identical = bool(torch.equal(out, again))
    two = two_err = None
    if plan.cluster > group_norm._CLUSTER_MAX:  # the two passes' twin
        two = group_norm._two_pass_plan(n, h, w, c)
        twin = group_norm._launch(xs[0], gamma, beta, groups, 1e-6, rs[0],
                                  relu, plan=two)
        two_err = float((twin.float() - ref.float()).abs().max())
        del twin
    ok = (err <= tol and identical and took[path] == 2
          and sum(took.values()) == 2 and plan.path == path
          and (two_err is None or two_err <= tol)
          and out.is_contiguous(memory_format=torch.channels_last))
    del ref, again

    turn = [0]

    def cycle(fn):
        def call():
            k = turn[0] = (turn[0] + 1) % copies
            return fn(xs[k], rs[k])
        return call

    def timed(plan_):
        return time_ms(cycle(lambda x, r: group_norm._launch(
            x, gamma, beta, groups, 1e-6, r, relu, plan=plan_)),
            kernel_calls)

    kernel_ms = time_ms(cycle(lambda x, r: group_norm.group_norm_act(
        x, gamma, beta, groups, 1e-6, r, relu)), kernel_calls)
    two_ms = None
    if two is not None:
        two_ms = (timed(two) + timed(two)) / 2
        kernel_ms = (kernel_ms + timed(None)) / 2
    plain_ms = time_ms(cycle(lambda x, r: group_norm.group_norm_act_plain(
        x, gamma, beta, groups, 1e-6, r, relu)), plain_calls) if plain_calls \
        else None
    g16, b16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)

    def library(x, r):
        y = F.group_norm(x, groups, g16, b16, 1e-6)
        if r is not None:
            y = y + r
        return torch.relu(y) if relu else y

    library_ms = time_ms(cycle(library), library_calls)
    ops = n * c * h * w * (6 + int(res) + int(relu))
    bytes_ms = call_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    mode = "GN" + ("+add" if res else "") + ("+ReLU" if relu else "")
    case = {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "path": plan.path, "cluster": plan.cluster}
    if two_ms is not None:
        case["two_pass_ms"] = two_ms
    plain = "-" if plain_ms is None else f"{plain_ms:.4f}"
    two_s = ("" if two_ms is None else f"two_pass_ms={two_ms:.4f} "
             f"(max_abs_err {two_err:.3e}) ")
    print(f"kernel group_norm_act {n}x{h}x{w}x{c} G={groups} {mode:11s} "
          f"{path} cluster={plan.cluster} took={took} max_abs_err={err:.3e} "
          f"(tol {tol:.3e}) "
          f"same_bits_twice={identical} kernel_ms={kernel_ms:.4f} "
          f"plain_ms={plain} library_ms={library_ms:.4f} {two_s}"
          f"bound_ms={case['bound_ms']:.4f} "
          f"kernel/bound={kernel_ms / case['bound_ms']:.2f} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"group_norm_act at {shape} {mode}: path {took} "
                         f"(want 2 on {path}), error {err} (tol {tol}), "
                         f"two-pass twin's {two_err}, same bits twice "
                         f"{identical}")
    return case


def host_us(call, calls: int = 400) -> float:
    """Host time per ``call()`` (a wrapper's checks, plan, allocation and
    launch), from the host clock around ``calls`` calls, without waiting
    for the device."""
    import torch

    for _ in range(10):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def wrapper_host_us(shape, groups: int) -> float:
    """Host µs per ``group_norm_act`` call at a small shape."""
    from tensorflowonspark_torch.kernels import group_norm

    xs, _, gamma, beta = draw_case(shape, False, 0, 1)
    return host_us(lambda: group_norm.group_norm_act(xs[0], gamma, beta,
                                                     groups, 1e-6))


def _by_batch(totals: dict) -> dict:
    """The totals at the main path's batch, and the others under keys
    suffixed ``_b<batch>``."""
    return {**totals[SLICE_TRAIN_BATCH],
            **{f"{k}_b{b}": v for b, tot in totals.items()
               if b != SLICE_TRAIN_BATCH for k, v in tot.items()}}


def kernel_phase(sites: list[tuple]) -> dict:
    """Every (shape, mode) of the forward at the batches of the serving
    slice, the training slice and the rate (one-pass path), then the
    oversize two-pass case."""
    counts = collections.Counter(sites)
    totals = {b: collections.Counter() for b, _ in FWD_BATCH_CALLS}
    cases = []
    for i, ((c, h, w, groups, res, relu), per_fwd) in enumerate(
            counts.items()):
        for batch, calls in FWD_BATCH_CALLS:
            case = measure_case((batch, c, h, w), groups, res, relu, i,
                                "one_pass", *calls)
            case["per_fwd"] = per_fwd
            cases.append(case)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                if case[key] is not None:
                    totals[batch][key] += per_fwd * case[key]
    for batch, tot in totals.items():
        print(f"kernel group_norm_act one_pass per ResNet-50 forward at batch "
              f"{batch} ({len(sites)} calls, {len(counts)} shapes): "
              + " ".join(f"{k}={v:.4f}" for k, v in tot.items())
              + f" kernel/bound={tot['ms'] / tot['bound_ms']:.2f}",
              flush=True)
    host_us = wrapper_host_us((KERNEL_BATCH, 512, 7, 7), 32)
    print(f"kernel group_norm_act wrapper host time per call "
          f"({KERNEL_BATCH}x7x7x512): {host_us:.1f} us", flush=True)
    oversize = measure_case(OVERSIZE_SHAPE, 32, True, True, 99, "two_pass",
                            20, 5, 5)
    bound_by = collections.Counter(c["bound_by"] for c in cases)
    return {"one_pass": {
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        **_by_batch(totals), "bound_by": bound_by.most_common(1)[0][0],
        "wrapper_host_us": host_us},
        "two_pass": oversize}


def model_phase(model, f32_model) -> dict:
    import numpy as np
    import torch

    from tensorflowonspark_torch.kernels import group_norm

    images = torch.from_numpy(np.random.RandomState(0).rand(
        8, 224, 224, 3).astype(np.float32)).cuda()
    with torch.inference_mode():
        group_norm.reset_launches()
        kernel_logits = model(images)
        torch.cuda.synchronize()
        per_forward = dict(group_norm.launches_by_path)
        model.norm_act = group_norm.group_norm_act_plain
        try:
            plain_logits = model(images)
        finally:
            model.norm_act = group_norm.group_norm_act
        f32_logits = f32_model(images)
    vs_plain = rel_err(kernel_logits, plain_logits)
    vs_f32 = rel_err(kernel_logits, f32_logits)
    finite = bool(torch.isfinite(kernel_logits).all())
    top1 = float((kernel_logits.argmax(1) == f32_logits.argmax(1))
                 .float().mean())
    print(f"model resnet50 224x224 bf16 GroupNorm: logits "
          f"{tuple(kernel_logits.shape)} {kernel_logits.dtype} finite={finite}"
          f" rel_err kernel-vs-plain={vs_plain:.3e} (tol "
          f"{LOGITS_KERNEL_VS_PLAIN}) kernel-vs-f32={vs_f32:.3e} (tol "
          f"{LOGITS_BF16_VS_F32}) top1_agree_f32={top1:.3f} "
          f"launches/forward={per_forward}", flush=True)
    if (kernel_logits.shape != (8, 1000) or kernel_logits.dtype != torch.float32
            or not finite or vs_plain > LOGITS_KERNEL_VS_PLAIN
            or vs_f32 > LOGITS_BF16_VS_F32
            or per_forward != launch_counts(one_pass=53)):
        raise SystemExit("model phase failed")

    batch = torch.rand(MODEL_BATCH, 224, 224, 3, device="cuda")
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(batch), 10)
    ips = MODEL_BATCH / fwd_ms * 1e3
    print(f"model resnet50 forward batch {MODEL_BATCH}: {fwd_ms:.3f} ms, "
          f"{ips:.1f} images/s", flush=True)
    profile_forward(model, batch, fwd_ms)
    return {"images_per_s": ips, "forward_ms": fwd_ms}


#: a ``record_function`` name (``Optimizer.step#AdamW.step``); kernel names
#: hold ``#`` only inside C++ lambdas (``{lambda(int)#1}``), with spaces
_ANNOTATION = re.compile(r"^[\w.]+#[\w.]+$")


def device_kernels(prof, calls: int):
    """``(name, ms per call)`` of every kernel ``prof`` (a torch.profiler
    run over ``calls`` calls) saw on the card.  The GPU spans of user
    annotations (``Optimizer.step#AdamW.step``) are CUDA events too, but
    cover kernels already counted: they are left out."""
    import torch

    for e in prof.events():
        if (getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or _ANNOTATION.match(e.name)):
            continue  # a host-side op, or an annotation's span
        yield e.name, e.time_range.elapsed_us() / 1e3 / calls


def cupti_us(fn, calls: int, kernel: str,
             sessions: int = 3) -> float | None:
    """Mean µs a launch of the kernels whose name holds ``kernel`` over
    ``calls`` back-to-back calls of ``fn`` under torch.profiler (CUPTI),
    after three warm calls and ``TRACE_WARMUP_LAUNCHES`` spin kernels (a
    session drops its first device records, now and then all of them: a
    session that saw no such launch is run again, up to ``sessions``);
    None when no session saw one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_WARMUP_LAUNCHES):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ms = [t for name, t in device_kernels(prof, 1) if kernel in name]
        if ms:
            return sum(ms) / len(ms) * 1e3
    return None


def traced_kernels(fn, calls: int, complete, sessions: int = 3) -> list:
    """``(name, ms per call)`` of the kernels (spin kernels left out) of
    ``calls`` back-to-back calls of ``fn`` under torch.profiler (CUPTI),
    after ``TRACE_WARMUP_LAUNCHES`` spin kernels.  A session can drop
    device records past the spin kernels, now and then most of them (a
    phase-17 trace once kept 2 of a replay's 10 paged launches), and a
    dropped record only ever lowers a count: a session for which
    ``complete(kernels)`` is false is run again, up to ``sessions``, and
    the last one is returned when none is (on the CPU, in the tests'
    rehearsals, every session sees no kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU]
                     + [ProfilerActivity.CUDA] * card) as prof:
            for _ in range(TRACE_WARMUP_LAUNCHES * card):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [(name, ms) for name, ms in device_kernels(prof, calls)
                   if "spin" not in name.lower()
                   and "sleep" not in name.lower()]
        if complete(kernels):
            break
    return kernels


def profile_forward(model, batch, fwd_ms: float, forwards: int = 3,
                    label: str = "resnet50") -> dict:
    """Device time per forward by kernel family (torch.profiler, CUPTI):
    the fused norm's kernels, convolutions, everything else, and the
    device's idle share against the event-timed forward."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(forwards):
            model(batch)
        torch.cuda.synchronize()
    fams, others = collections.Counter(), collections.Counter()
    for kernel, ms in device_kernels(prof, forwards):
        name = kernel.lower()
        fam = next((k for k in ("gn_one_pass", "gn_stats", "gn_finalize",
                                "gn_apply")
                    if k in name), None)
        if fam is None:
            fam = "conv" if any(k in name for k in (
                "conv", "fprop", "xmma", "gemm", "cudnn", "implicit",
                "cutlass")) else "other"
        fams[fam] += ms
        if fam == "other":
            others[kernel[:60]] += ms
    busy = sum(fams.values())
    if busy == 0:
        print("profile: the profiler recorded no device time (not measured)",
              flush=True)
        return {}
    parts = " ".join(f"{k}={v:.3f}ms({v / busy:.1%})"
                     for k, v in fams.most_common())
    idle = max(0.0, 1 - busy / fwd_ms)
    print(f"profile {label} forward batch {len(batch)}, device ms per "
          f"forward: busy={busy:.3f} of {fwd_ms:.3f} "
          f"(idle share {idle:.1%}); {parts}", flush=True)
    print("profile largest 'other' kernels: " + "; ".join(
        f"{name}={ms:.3f}ms" for name, ms in others.most_common(6)),
        flush=True)
    return {"idle_share": idle}


def _reset_launches(_):
    from tensorflowonspark_torch.kernels import group_norm
    from tensorflowonspark_torch.parallel import train

    group_norm.reset_launches()
    train.replayed_forwards = 0
    return [0]


def _forward_replays(_):
    """The executor's serving forwards that a graph replay ran alone since
    :func:`_reset_launches` (their kernels count in no wrapper)."""
    from tensorflowonspark_torch.parallel import train

    return [train.replayed_forwards]


def _reset_table_launches(_):
    from tensorflowonspark_torch.kernels import sparse_adagrad

    sparse_adagrad.reset_launches()
    return [0]


def _table_launches(_):
    from tensorflowonspark_torch.kernels import sparse_adagrad

    return [dict(sparse_adagrad.launches_by_path)]


def _executor_state(_):
    from tensorflowonspark_torch import serving
    from tensorflowonspark_torch.kernels import group_norm

    return [(dict(group_norm.launches_by_path),
             {k: sorted(v) for k, v in serving._SEEN_SHAPES.items()})]


def slice_phase(model) -> dict:
    import numpy as np
    import torch

    from tensorflowonspark_torch import compat, pipeline, shapes, sparkapi
    from tensorflowonspark_torch.kernels import group_norm
    from tensorflowonspark_torch.models import resnet

    export_dir = tempfile.mkdtemp(prefix="tfos_torch_smoke_")
    compat.export_saved_model(resnet.state_of(model), export_dir)
    images = np.random.RandomState(1).rand(
        SLICE_ROWS, 224, 224, 3).astype(np.float32)
    sc = sparkapi.LocalSparkContext("local[1]")
    try:
        spark = sparkapi.LocalSparkSession(sc)
        df = spark.createDataFrame(
            [{"id": i, "image": images[i]} for i in range(SLICE_ROWS)]
        ).repartition(3)
        sizes = [len(p) for p in df.rdd._partitions]
        tfmodel = (pipeline.TFModel(device="cuda").setModelName("resnet50")
                   .setExportDir(export_dir).setBatchSize(SLICE_BATCH)
                   .setBucketSizes([SLICE_BATCH])
                   .setInputMapping({"image": "image"}))
        sc.parallelize([0], 1).mapPartitions(_reset_launches).collect()
        group_norm.reset_launches()
        t0 = time.perf_counter()
        out = tfmodel.transform(df).collect()
        seconds = time.perf_counter() - t0
        driver_launches = dict(group_norm.launches_by_path)
        [(exec_launches, seen)] = sc.parallelize([0], 1).mapPartitions(
            _executor_state).collect()
        # again, with the model loaded and the kernel built on both sides
        t0 = time.perf_counter()
        warm_rows = len(tfmodel.transform(df).collect())
        warm_seconds = time.perf_counter() - t0
    finally:
        sc.stop()
        shutil.rmtree(export_dir, ignore_errors=True)

    # collect() returns rows in partition order on the local substrate, so
    # row i scores image id i; the reference forward batches like the
    # executor (32-row chunks of each partition, padded to the bucket)
    scores = torch.tensor([r.prediction for r in out])
    ref, start = [], 0
    with torch.inference_mode():
        for size in sizes:
            for lo in range(start, start + size, SLICE_BATCH):
                n = min(SLICE_BATCH, start + size - lo)
                chunk = np.zeros((SLICE_BATCH, 224, 224, 3), np.float32)
                chunk[:n] = images[lo:lo + n]
                ref.append(model(torch.from_numpy(chunk).cuda())[:n].cpu())
            start += size
    ref = torch.cat(ref)
    err = rel_err(scores, ref)
    want = {tuple(shapes.enumerate_signatures(
        {"image": ((224, 224, 3), np.float32)}, [SLICE_BATCH]))}
    got = {tuple(v) for v in seen.values()}
    rows_per_s = SLICE_ROWS / seconds
    warm_rows_per_s = SLICE_ROWS / warm_seconds
    print(f"slice TFModel.transform resnet50 on cuda: {len(out)} rows in "
          f"partitions {sizes}, {seconds:.3f} s, {rows_per_s:.2f} rows/s "
          f"(first, with the executor's load); again {warm_seconds:.3f} s, "
          f"{warm_rows_per_s:.2f} rows/s; "
          f"scores rel_err vs in-process={err:.3e} (tol {SLICE_VS_IN_PROCESS})"
          f"; executor launches={exec_launches} driver launches="
          f"{driver_launches}; executor signatures={len(seen)} model(s), "
          f"{[len(v) for v in seen.values()]} signature(s)", flush=True)
    if (len(out) != SLICE_ROWS or warm_rows != SLICE_ROWS
            or scores.shape != (SLICE_ROWS, 1000)
            or err > SLICE_VS_IN_PROCESS or exec_launches["one_pass"] <= 0
            or exec_launches["two_pass"] or driver_launches["two_pass"]
            or got != want or len(seen) != 1):
        raise SystemExit("slice phase failed")
    return {"launches": {k: exec_launches[k] + driver_launches[k]
                         for k in exec_launches},
            "rows_per_s": rows_per_s}


def measure_backward_case(shape, groups: int, res: bool, relu: bool,
                          seed: int, path: str, kernel_calls: int,
                          plain_calls: int, library_calls: int) -> dict:
    """The backward of one (shape, mode) of ``group_norm_act``: the
    training forward's output and ``(mean, rstd)`` against the plain twin's
    (within ``KERNEL_TOL_ULPS`` and ``STATS_TOL``); the plan takes
    ``path`` and each wrapper call counts once on it, dx and d_residual
    within ``KERNEL_TOL_ULPS`` of the plain twin, dγ and dβ within
    ``BWD_PARAM_REL_L2``, the same bits twice; then the kernel's, the plain
    twin's (if ``plain_calls``) and the library backward's times beside the
    bound.  On the one-pass path the four launches, forced at the same
    shape, pass the same checks against the plain twin and are timed in
    turns with it (one pass, four, four, one pass)."""
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_torch.kernels import group_norm

    n, c, h, w = shape
    act_bytes = n * c * h * w * 2
    # read x, dy (and y, the ReLU mask); write dx (and d_residual)
    call_bytes = act_bytes * (2 + int(relu) + 1 + int(res)) + 4 * c * 4
    copies = min(64, max(2, math.ceil(4 * L2_BYTES / call_bytes)))
    xs, rs, gamma, beta = draw_case(shape, res, seed, copies)
    dys = draw_case(shape, False, seed + 1000, copies)[0]
    fwd = [group_norm._launch(xs[k], gamma, beta, groups, 1e-6, rs[k], relu,
                              keep_stats=True) for k in range(copies)]
    ys, stats = [f[0] for f in fwd], [f[1] for f in fwd]
    del fwd
    y_ref, stats_ref = group_norm._plain_forward(xs[0], gamma, beta, groups,
                                                 1e-6, rs[0], relu)
    y_err = float((ys[0].float() - y_ref.float()).abs().max())
    y_tol = KERNEL_TOL_ULPS * 2.0 ** -7 * max(1.0, float(y_ref.abs().max()))
    stats_err = float(((stats[0] - stats_ref).abs()
                       / stats_ref.abs().clamp(min=1.0)).max())
    del y_ref, stats_ref
    ref = group_norm.group_norm_act_backward_plain(
        dys[0], xs[0], ys[0], gamma, stats[0], groups, res, relu)
    plan = group_norm._plan_backward(n, h, w, c, groups, group_norm._capacity(
        "backward", torch.cuda.current_device()))
    before = dict(group_norm.launches_by_path)
    out = group_norm._launch_backward(dys[0], xs[0], ys[0], gamma, stats[0],
                                      groups, res, relu)
    again = group_norm._launch_backward(dys[0], xs[0], ys[0], gamma,
                                        stats[0], groups, res, relu)
    torch.cuda.synchronize()
    took = {k: v - before[k] for k, v in group_norm.launches_by_path.items()}
    errs, tols, param_rels = [], [], []

    def check(got):
        for g, want in zip(got[:2], ref[:2]):
            if want is not None:
                errs.append(float((g.float() - want.float()).abs().max()))
                tols.append(KERNEL_TOL_ULPS * 2.0 ** -7
                            * max(1.0, float(want.float().abs().max())))
        param_rels.extend(
            float(torch.linalg.norm(g - w_) / torch.linalg.norm(w_))
            for g, w_ in zip(got[2:], ref[2:]))

    check(out)
    kernel_err = max(errs)
    identical = all(torch.equal(a, b) for a, b in zip(out, again)
                    if a is not None)
    four = None
    if path == "one_pass":  # the four launches' twin
        four = group_norm._four_launch_plan(n, h, w, c)
        check(group_norm._launch_backward(dys[0], xs[0], ys[0], gamma,
                                          stats[0], groups, res, relu, four))
    param_rel = max(param_rels)
    ok = (all(e <= t for e, t in zip(errs, tols))
          and y_err <= y_tol and stats_err <= STATS_TOL
          and param_rel <= BWD_PARAM_REL_L2 and identical
          and (out[1] is not None) == res
          and plan.path == path
          and took == launch_counts(**{"backward_" + path: 2})
          and out[0].is_contiguous(memory_format=torch.channels_last))
    del ref, out, again

    turn = [0]

    def cycle(fn):
        def call():
            k = turn[0] = (turn[0] + 1) % copies
            return fn(k)
        return call

    def timed(plan_):
        return time_ms(cycle(lambda k: group_norm._launch_backward(
            dys[k], xs[k], ys[k], gamma, stats[k], groups, res, relu,
            plan_)), kernel_calls)

    kernel_ms = timed(None)
    four_ms = None
    if four is not None:
        four_ms = (timed(four) + timed(four)) / 2
        kernel_ms = (kernel_ms + timed(None)) / 2
    plain_ms = time_ms(cycle(lambda k: group_norm.group_norm_act_backward_plain(
        dys[k], xs[k], ys[k], gamma, stats[k], groups, res, relu)),
        plain_calls) if plain_calls else None

    # the yardstick: autograd of bf16 F.group_norm -> add -> ReLU, one
    # retained graph a copy
    graphs = []
    for k in range(copies):
        x = xs[k].detach().requires_grad_()
        r = rs[k].detach().requires_grad_() if res else None
        g16 = gamma.to(torch.bfloat16).requires_grad_()
        b16 = beta.to(torch.bfloat16).requires_grad_()
        y = F.group_norm(x, groups, g16, b16, 1e-6)
        if res:
            y = y + r
        if relu:
            y = torch.relu(y)
        graphs.append((y, [t for t in (x, r, g16, b16) if t is not None]))
    library_ms = time_ms(cycle(lambda k: torch.autograd.grad(
        graphs[k][0], graphs[k][1], dys[k], retain_graph=True)),
        library_calls)
    del graphs
    bytes_ms = call_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n * c * h * w * (14 + 2 * int(res) + int(relu)) \
        / F32_OPS_PER_S * 1e3
    mode = "GN" + ("+add" if res else "") + ("+ReLU" if relu else "")
    case = {"max_abs_err": kernel_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "path": "backward_" + plan.path, "cluster": plan.cluster}
    if four_ms is not None:
        case["four_launch_ms"] = four_ms
    plain = "-" if plain_ms is None else f"{plain_ms:.4f}"
    four_s = "" if four_ms is None else f"four_launch_ms={four_ms:.4f} "
    print(f"backward group_norm_act {n}x{h}x{w}x{c} G={groups} {mode:11s} "
          f"path={plan.path} cluster={plan.cluster} "
          f"x_resident={plan.x_resident} forward y_err={y_err:.3e} "
          f"(tol {y_tol:.3e}) stats_err={stats_err:.2e} (tol {STATS_TOL}) "
          f"took={took} max_abs_err={kernel_err:.3e} (tol {min(tols):.3e}) "
          f"dgamma/dbeta rel_l2={param_rel:.2e} (tol {BWD_PARAM_REL_L2}) "
          f"same_bits_twice={identical} kernel_ms={kernel_ms:.4f} "
          f"plain_ms={plain} library_ms={library_ms:.4f} {four_s}"
          f"bound_ms={case['bound_ms']:.4f} "
          f"kernel/bound={kernel_ms / case['bound_ms']:.2f} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"group_norm_act backward at {shape} {mode}: "
                         f"forward y {y_err} (tol {y_tol}), stats "
                         f"{stats_err}, "
                         f"launches {took}, errors {errs} (tol {tols}), "
                         f"dgamma/dbeta {param_rel}, same bits {identical}")
    return case


def backward_wrapper_host_us(shape, groups: int) -> float:
    """Host µs per backward wrapper call at a small shape, GN+add+ReLU."""
    from tensorflowonspark_torch.kernels import group_norm

    xs, rs, gamma, beta = draw_case(shape, True, 0, 1)
    dy = draw_case(shape, False, 1, 1)[0][0]
    y, stats = group_norm._launch(xs[0], gamma, beta, groups, 1e-6, rs[0],
                                  True, keep_stats=True)
    return host_us(lambda: group_norm._launch_backward(
        dy, xs[0], y, gamma, stats, groups, True, True))


def backward_phase(sites: list[tuple]) -> dict:
    """The backward at every (shape, mode) of the forward, at the batches
    of the kernel phase (one-pass path); totals per training step; the
    wrapper's host time; then the oversize four-launch case."""
    counts = collections.Counter(sites)
    totals = {b: collections.Counter() for b, _ in BWD_BATCH_CALLS}
    errs = []
    for i, ((c, h, w, groups, res, relu), per_step) in enumerate(
            counts.items()):
        for batch, calls in BWD_BATCH_CALLS:
            case = measure_backward_case((batch, c, h, w), groups, res, relu,
                                         i, "one_pass", *calls)
            errs.append(case["max_abs_err"])
            for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "four_launch_ms"):
                if case.get(key) is not None:
                    totals[batch][key] += per_step * case[key]
    for batch, tot in totals.items():
        print(f"backward group_norm_act one_pass per ResNet-50 training step "
              f"at batch {batch} ({len(sites)} calls, {len(counts)} shapes): "
              + " ".join(f"{k}={v:.4f}" for k, v in tot.items())
              + f" kernel/bound={tot['ms'] / tot['bound_ms']:.2f}",
              flush=True)
    host_us = backward_wrapper_host_us((KERNEL_BATCH, 512, 7, 7), 32)
    print(f"backward group_norm_act wrapper host time per call "
          f"({KERNEL_BATCH}x7x7x512): {host_us:.1f} us", flush=True)
    oversize = measure_backward_case(OVERSIZE_SHAPE, 32, True, True, 99,
                                     "four_launch", 20, 5, 5)
    return {"backward_one_pass": {
        "max_abs_err": max(errs), **_by_batch(totals), "bound_by": "bytes",
        "wrapper_host_us": host_us},
        "backward_four_launch": oversize}


def _grads(model, loss_fn, batch, norm_act, backward=None):
    """One backward's gradients (f32 copies), the loss and the kernel
    launches it made.  ``backward``, if given, stands in for the backward
    kernel's wrapper for this one step."""
    import torch

    from tensorflowonspark_torch.kernels import group_norm

    model.norm_act = norm_act
    model.zero_grad(set_to_none=True)
    kernel_backward = group_norm._launch_backward
    group_norm._launch_backward = backward or kernel_backward
    try:
        group_norm.reset_launches()
        loss = loss_fn(model, batch)
        loss.backward()
        if loss.is_cuda:
            torch.cuda.synchronize()
    finally:
        group_norm._launch_backward = kernel_backward
    launches = dict(group_norm.launches_by_path)
    grads = {k: p.grad.detach().float().clone()
             for k, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    model.norm_act = group_norm.group_norm_act
    return grads, float(loss.detach()), launches


def _planted_fault(drop: str):
    """The backward kernel's wrapper with a fault planted in its dx: the
    centering term ``x̂·mean_M(dz·γ·x̂)`` (``drop="projection"``) or both
    centering terms (``drop="centering"``, as if the per-group
    coefficients were zero) of ``dx = rstd·(dz·γ − mean_M(dz·γ) −
    x̂·mean_M(dz·γ·x̂))`` added back, in f32, at every site."""
    from tensorflowonspark_torch.kernels import group_norm

    kernel_backward = group_norm._launch_backward

    def backward(dy, x, y, gamma, stats, groups, residual, relu):
        dx, *rest = kernel_backward(dy, x, y, gamma, stats, groups,
                                    residual, relu)
        n, c, h, w = x.shape
        dz = dy.permute(0, 2, 3, 1).float()
        if relu:
            dz = dz * (y.permute(0, 2, 3, 1) > 0)
        dz = dz.reshape(n, h * w, groups, c // groups)
        mean = stats[..., 0].reshape(n, 1, groups, 1)
        rstd = stats[..., 1].reshape(n, 1, groups, 1)
        xh = (x.permute(0, 2, 3, 1).float().reshape(dz.shape) - mean) * rstd
        dxh = dz * gamma.float().reshape(1, 1, groups, -1)
        add = rstd * xh * (dxh * xh).mean(dim=(1, 3), keepdim=True)
        if drop == "centering":
            add = add + rstd * dxh.mean(dim=(1, 3), keepdim=True)
        dx = (dx.permute(0, 2, 3, 1).float() + add.reshape(n, h, w, c))
        return (dx.to(x.dtype).permute(0, 3, 1, 2), *rest)

    return backward


def _rel_l2(a: dict, b: dict) -> float:
    num = sum(float(((a[k] - b[k]).double() ** 2).sum()) for k in b)
    den = sum(float((b[k].double() ** 2).sum()) for k in b)
    return math.sqrt(num / den)


def train_model_phase() -> dict:
    import dataclasses

    import numpy as np
    import torch

    from tensorflowonspark_torch.kernels import group_norm
    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.trainer import Trainer

    config = resnet.Config()
    rng = np.random.RandomState(3)

    def device_batch(n):
        return {"image": torch.from_numpy(rng.rand(
                    n, 224, 224, 3).astype(np.float32)).cuda(),
                "label": torch.from_numpy(rng.randint(
                    0, 1000, size=n)).cuda()}

    # one step's gradients: kernel path, plain path, f32 plain model
    model = resnet.make_model(config, seed=0).cuda()
    f32_model = resnet.load_state(
        resnet.make_model(dataclasses.replace(config, dtype="float32")),
        resnet.state_of(model)).cuda()
    batch = device_batch(TRAIN_GRAD_BATCH)
    loss_fn = resnet.make_loss_fn(model, config)
    g_kernel, loss_kernel, launches = _grads(model, loss_fn, batch,
                                             group_norm.group_norm_act)
    g_plain, loss_plain, plain_launches = _grads(
        model, loss_fn, batch, group_norm.group_norm_act_plain)
    g_f32, loss_f32, _ = _grads(f32_model, loss_fn, batch,
                                group_norm.group_norm_act_plain)
    # the backward alone: the kernel forward under the plain backward, and
    # under the kernel backward with a fault planted
    g_same, _, same_launches = _grads(
        model, loss_fn, batch, group_norm.group_norm_act,
        group_norm.group_norm_act_backward_plain)
    g_faults = {drop: _grads(model, loss_fn, batch, group_norm.group_norm_act,
                             _planted_fault(drop))[0]
                for drop in ("projection", "centering")}
    names = [k for k, _ in model.named_parameters()]
    del model, f32_model
    complete = sorted(g_kernel) == sorted(names)
    finite = all(bool(torch.isfinite(g).all()) for g in g_kernel.values())
    nonzero = [k for k, g in g_kernel.items() if float(g.abs().max()) > 0]
    vs_plain = _rel_l2(g_kernel, g_plain)
    vs_f32 = _rel_l2(g_kernel, g_f32)
    plain_vs_f32 = _rel_l2(g_plain, g_f32)
    loose_tol = GRADS_VS_F32_OVER_PLAIN * plain_vs_f32 + 0.02
    same_forward = _rel_l2(g_kernel, g_same)
    faults = {drop: (_rel_l2(g, g_same),
                     max(_rel_l2(g, g_plain), _rel_l2(g, g_f32)))
              for drop, g in g_faults.items()}
    print(f"train resnet50 224x224 bf16 one step at batch {TRAIN_GRAD_BATCH}:"
          f" loss kernel={loss_kernel:.5f} plain={loss_plain:.5f} "
          f"f32={loss_f32:.5f}; grads of {len(g_kernel)}/{len(names)} params,"
          f" finite={finite}, nonzero={len(nonzero)}; rel_l2 kernel-vs-plain="
          f"{vs_plain:.3e} kernel-vs-f32={vs_f32:.3e} plain-vs-f32="
          f"{plain_vs_f32:.3e} (tol: both <= {GRADS_VS_F32_OVER_PLAIN} x "
          f"plain-vs-f32 + 0.02, kernel-vs-f32 <= {GRADS_BF16_VS_F32}); "
          f"launches a step={launches} (plain path {plain_launches})",
          flush=True)
    print(f"train resnet50 backward alone: rel_l2 kernel-bwd-vs-plain-bwd "
          f"(kernel forward both)={same_forward:.3e} (tol "
          f"{GRADS_SAME_FORWARD}); launches {same_launches}; planted faults "
          + "; ".join(f"{drop} term dropped: vs plain-bwd={a:.3e} "
                      f"({'caught' if a > GRADS_SAME_FORWARD else 'MISSED'}),"
                      f" vs plain/f32={b:.3e} against the gate above "
                      f"{loose_tol:.3e} "
                      f"({'caught' if b > loose_tol else 'missed'})"
                      for drop, (a, b) in faults.items()), flush=True)
    del g_kernel, g_plain, g_f32, g_same, g_faults
    if (not complete or not finite or len(nonzero) != len(names)
            or vs_f32 > GRADS_BF16_VS_F32
            or max(vs_plain, vs_f32) > loose_tol
            or launches != launch_counts(one_pass=53, backward_one_pass=53)
            or sum(plain_launches.values())
            or same_forward > GRADS_SAME_FORWARD
            or same_launches != launch_counts(one_pass=53)
            or min(a for a, _ in faults.values()) <= GRADS_SAME_FORWARD):
        raise SystemExit("training-model phase failed (gradients)")

    # 8 AdamW steps on one batch, kernel path against plain path
    batch = device_batch(TRAIN_GRAD_BATCH)
    traj = {}
    for name, norm_act in (("kernel", group_norm.group_norm_act),
                           ("plain", group_norm.group_norm_act_plain)):
        t = Trainer("resnet50", config=config, learning_rate=TRAIN_LR,
                    seed=0, device="cuda")
        t.model.norm_act = norm_act
        traj[name] = [float(t.step(batch)) for _ in range(TRAIN_STEPS)]
        del t
    gap = max(abs(a - b) for a, b in zip(traj["kernel"], traj["plain"]))
    falls = traj["kernel"][-1] < 0.5 * traj["kernel"][0]
    print(f"train resnet50 {TRAIN_STEPS} AdamW steps (lr {TRAIN_LR}) on one "
          f"batch: kernel losses {[round(v, 5) for v in traj['kernel']]}; "
          f"plain {[round(v, 5) for v in traj['plain']]}; max gap "
          f"{gap:.3e} (tol {TRAJECTORY_TOL} x {traj['plain'][0]:.4f}); "
          f"falls={falls}", flush=True)
    if gap > TRAJECTORY_TOL * traj["plain"][0] or not falls:
        raise SystemExit("training-model phase failed (trajectory)")

    # train-step rate at batch 256, device-resident batch
    torch.cuda.empty_cache()
    t = Trainer("resnet50", config=config, learning_rate=TRAIN_LR, seed=0,
                device="cuda")
    batch = device_batch(MODEL_BATCH)
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: t.step(batch), 10)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ips = MODEL_BATCH / step_ms * 1e3
    print(f"train resnet50 step batch {MODEL_BATCH}: {step_ms:.3f} ms, "
          f"{ips:.1f} images/s, peak memory {peak_gb:.2f} GB", flush=True)
    profile_train_step(t, batch, step_ms)
    del t, batch
    torch.cuda.empty_cache()
    return {"images_per_s": ips, "step_ms": step_ms}


def profile_train_step(trainer, batch, step_ms: float, steps: int = 3,
                       label: str = "resnet50") -> dict:
    """Device time per training step by family (torch.profiler, CUPTI):
    forward norm, backward norm, convolutions (forward and backward), the
    optimizer, everything else, and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.step(batch)
        torch.cuda.synchronize()
    fams, others = collections.Counter(), collections.Counter()
    for kernel, ms in device_kernels(prof, steps):
        name = kernel.lower()
        if "gn_bwd" in name:
            fam = "norm backward"
        elif name.startswith("gn_") or "gn_one_pass" in name or any(
                k in name for k in ("gn_stats", "gn_apply", "gn_finalize")):
            fam = "norm forward"
        elif any(k in name for k in ("conv", "fprop", "dgrad", "wgrad",
                                     "xmma", "gemm", "cudnn", "implicit",
                                     "cutlass", "nvjet", "sm90_")):
            fam = "conv fwd+bwd"
        elif any(k in name for k in ("adam", "multi_tensor", "foreach")):
            fam = "optimizer"
        else:
            fam = "other"
        fams[fam] += ms
        if fam == "other":
            others[kernel[:60]] += ms
    busy = sum(fams.values())
    if busy == 0:
        print("profile: the profiler recorded no device time (not measured)",
              flush=True)
        return {}
    parts = " ".join(f"{k}={v:.3f}ms({v / busy:.1%})"
                     for k, v in fams.most_common())
    idle = max(0.0, 1 - busy / step_ms)
    print(f"profile {label} train step batch {len(batch['image'])}, device "
          f"ms per step: busy={busy:.3f} of {step_ms:.3f} (idle share "
          f"{idle:.1%}); {parts}", flush=True)
    print("profile largest 'other' kernels of the step: " + "; ".join(
        f"{name}={ms:.3f}ms" for name, ms in others.most_common(6)),
        flush=True)
    return {"idle_share": idle}


def replayed_steps() -> int:
    """``parallel.train.replayed_steps`` of this process: the steps a CUDA
    graph replay ran alone, whose kernels no wrapper counted.  A job
    publishes how many of its steps these were (``replays``), and a gate
    plans its wrapper counts for the other steps."""
    from tensorflowonspark_torch.parallel import train as train_lib

    return train_lib.replayed_steps


def train_map_fun(args, ctx):
    """The training slice's ``map_fun``: a ``Trainer`` on the node's card
    fed by ``DataFeed`` (prefetching, staged by ``trainer.shard``),
    publishing its metrics every step; then the losses and the kernel
    launches of its steps on the node's kv blackboard."""
    from tensorflowonspark_torch import metrics
    from tensorflowonspark_torch.kernels import group_norm
    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.trainer import Trainer

    trainer = Trainer("resnet50", config=resnet.Config(),
                      learning_rate=args["lr"], seed=args["seed"])
    trainer.add_step_callback(metrics.MetricsReporter(ctx, interval=1))
    feed = ctx.get_data_feed(train_mode=True,
                             input_mapping=["image", "label"], prefetch=2)
    ctx.mgr.set("ready", True)
    group_norm.reset_launches()
    replays = replayed_steps()
    losses = []
    while not feed.should_stop():
        batch = feed.next_batch(args["batch"], device_put=trainer.shard)
        if not batch or batch["image"].shape[0] == 0:
            continue
        losses.append(trainer.step(batch))
    ctx.mgr.set("launches", dict(group_norm.launches_by_path))
    ctx.mgr.set("replays", replayed_steps() - replays)
    ctx.mgr.set("losses", [float(v) for v in losses])
    ctx.mgr.set("device", str(trainer.device))


def train_slice_phase() -> dict:
    import numpy as np
    import torch

    from tensorflowonspark_torch import TFCluster, TFManager, sparkapi
    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.trainer import Trainer

    rng = np.random.RandomState(2)
    images = rng.rand(SLICE_TRAIN_ROWS, 224, 224, 3).astype(np.float32)
    labels = rng.randint(0, 1000, size=SLICE_TRAIN_ROWS)
    rows = [(images[i], int(labels[i])) for i in range(SLICE_TRAIN_ROWS)]
    args = {"batch": SLICE_TRAIN_BATCH, "lr": TRAIN_LR, "seed": 0}
    sc = sparkapi.LocalSparkContext("local[1]")
    try:
        t0 = time.perf_counter()
        cluster = TFCluster.run(sc, train_map_fun, args, num_executors=1,
                                input_mode=TFCluster.InputMode.SPARK)
        authkey = bytes.fromhex(cluster.cluster_meta["authkey_hex"])
        [meta] = cluster.cluster_info
        mgr = TFManager.connect(tuple(meta["addr"]), authkey)
        deadline = time.monotonic() + 600
        while not mgr.get("ready") and time.monotonic() < deadline:
            if mgr.get("state") == "failed":
                break  # train() below raises the trainer's error
            time.sleep(0.2)
        ready_s = time.perf_counter() - t0
        rdd = sc.parallelize(rows, SLICE_TRAIN_PARTITIONS)
        t1 = time.perf_counter()
        cluster.train(rdd, feed_timeout=600)
        train_s = time.perf_counter() - t1
        cluster.shutdown(grace_secs=120)
        state = mgr.get("state")
        losses = mgr.get("losses") or []
        launches = mgr.get("launches") or {}
        replays = mgr.get("replays") or 0
        device = mgr.get("device")
        agg = cluster.metrics()
    finally:
        sc.stop()

    # the same batches, in partition order, in this process
    t = Trainer("resnet50", config=resnet.Config(), learning_rate=TRAIN_LR,
                seed=0, device="cuda")
    replay = []
    for lo in range(0, SLICE_TRAIN_ROWS, SLICE_TRAIN_BATCH):
        replay.append(float(t.step({
            "image": images[lo:lo + SLICE_TRAIN_BATCH],
            "label": labels[lo:lo + SLICE_TRAIN_BATCH]})))
    del t
    torch.cuda.empty_cache()
    steps = SLICE_TRAIN_ROWS // SLICE_TRAIN_BATCH
    rel = (abs(losses[-1] - replay[-1]) / abs(replay[-1]) if losses
           else float("inf"))
    ips = agg.get("total_examples_per_sec")
    wall_ips = SLICE_TRAIN_ROWS / train_s
    print(f"train slice TFCluster.run -> cluster.train -> DataFeed -> "
          f"Trainer.step, resnet50 on {device}: state {state}, "
          f"{len(losses)} steps, losses {[round(v, 5) for v in losses]}; "
          f"in-process replay {[round(v, 5) for v in replay]}; final loss "
          f"rel={rel:.3e} (tol {SLICE_TRAIN_VS_IN_PROCESS}); executor "
          f"launches={launches} ({replays} steps replayed alone); "
          f"cluster.metrics() images/s={ips}; "
          f"cluster.train {train_s:.3f} s for {SLICE_TRAIN_ROWS} rows = "
          f"{wall_ips:.2f} images/s (after {ready_s:.1f} s to a ready "
          f"trainer)", flush=True)
    if (state != "finished" or len(losses) != steps or replays < 1
            or not all(math.isfinite(v) for v in losses)
            or rel > SLICE_TRAIN_VS_IN_PROCESS or not str(device).startswith(
                "cuda")
            or launches != launch_counts(
                one_pass=53 * (steps - replays),
                backward_one_pass=53 * (steps - replays))
            or not ips):
        raise SystemExit("training slice phase failed")
    return {"launches": launches, "images_per_s": ips,
            "wall_images_per_s": wall_ips}


# ---------------------------------------------------------------------------
# Wide&deep: the table kernel, the training model, the estimator slice
# ---------------------------------------------------------------------------


def synth_criteo(n: int, buckets: int, seed: int = 0, zipf: float = 0.0):
    """Criteo-shaped rows ``(dense[13], cat[26], label)`` with a learnable
    click signal (``examples/criteo/criteo_pipeline.py::synth_criteo``);
    with ``zipf`` the bucket ids are Zipf-distributed, else uniform."""
    import numpy as np

    from tensorflowonspark_torch.models.widedeep import NUM_CAT, NUM_DENSE

    rng = np.random.RandomState(seed)
    dense = rng.rand(n, NUM_DENSE)
    cat = (criteo_ids(rng, n, buckets, zipf) if zipf
           else rng.randint(0, buckets, size=(n, NUM_CAT)))
    # clicks driven by dense[0] and one categorical bucket parity
    logit = 3.0 * (dense[:, 0] - 0.5) + (cat[:, 0] % 2) - 0.5
    label = (1 / (1 + np.exp(-logit)) > rng.rand(n)).astype(int)
    return [(dense[i].tolist(), cat[i].tolist(), int(label[i]))
            for i in range(n)]


def criteo_ids(rng, n: int, buckets: int, zipf: float = 0.0):
    """(n, 26) per-feature bucket ids: uniform, or Zipf(``zipf``) folded
    into the buckets (the most frequent value is bucket 0)."""
    from tensorflowonspark_torch.models.widedeep import NUM_CAT

    if not zipf:
        return rng.randint(0, buckets, size=(n, NUM_CAT))
    return (rng.zipf(zipf, size=(n, NUM_CAT)) - 1) % buckets


def rows_to_batch(rows) -> dict:
    """Rows of :func:`synth_criteo` as the train step's batch, with the
    casts ``criteo_train_fn``'s stager applies."""
    import numpy as np

    return {"dense": np.asarray([r[0] for r in rows], np.float32),
            "cat": np.asarray([r[1] for r in rows], np.int32),
            "label": np.asarray([r[2] for r in rows], np.int32)}


def table_bound_ms(n: int, id_bytes: int, dim: int, unique: int) -> dict:
    """The least time of one table update on the card: the ids and the row
    gradients read once, each touched row of the table and the
    accumulator read and written once (bytes), against a few f32
    operations an element (operations)."""
    nbytes = n * id_bytes + n * dim * 4 + unique * dim * 4 * 4
    ops = n * dim * 6 + unique * dim * 4
    return _bound(nbytes / HBM_BYTES_PER_S * 1e3,
                  ops / F32_OPS_PER_S * 1e3, bytes=nbytes)


def step_bound_ms(n: int, id_bytes: int, dims, unique: int) -> dict:
    """The least time of a step's table path: :func:`table_bound_ms` of
    each table whose ids are the same ``n`` ids, bytes and operations each
    summed, the ids counted once.  The grouping lives inside it."""
    parts = [table_bound_ms(n, id_bytes if i == 0 else 0, d, unique)
             for i, d in enumerate(dims)]
    return _bound(sum(b["bytes_ms"] for b in parts),
                  sum(b["ops_ms"] for b in parts),
                  bytes=sum(b["bytes"] for b in parts))


def group_bound_ms(n: int, id_bytes: int, segments: int) -> dict:
    """The least time of the id grouping: the ids read once, the grouped
    keys and positions (int32), the segment starts and the two counts
    written once (bytes), against a digit extraction and a count an id a
    radix pass at the f32 rate (operations; int32 runs no faster)."""
    nbytes = n * id_bytes + n * 8 + (segments + 1) * 4 + 8
    return _bound(nbytes / HBM_BYTES_PER_S * 1e3,
                  n * 3 * 2 / F32_OPS_PER_S * 1e3, bytes=nbytes)


def _bound(bytes_ms: float, ops_ms: float, **extra) -> dict:
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            **extra}


def _table_diff(got, want, touched) -> tuple[float, float, bool]:
    """(max |got - want| over touched rows, max |want| there, whether any
    untouched row of ``got`` differs from ``want``) for (vocab, ...)
    tensors."""
    import torch

    rows = got.shape[0]
    diff = (got - want).abs().reshape(rows, -1)[touched]
    scale = want.abs().reshape(rows, -1)[touched]
    moved = (got != want).reshape(rows, -1).any(dim=1) & ~touched
    return float(diff.max()), float(scale.max()), bool(moved.any())


def grouping_matches(grouping, ids, vocab: int) -> bool:
    """The grouping kernel's outputs against ``embedding.group_ids_plain``
    (``sort_ids`` of the same ids on the same device), bit for bit: the
    in-range occurrences' wrapped ids and positions, the dropped tail, the
    segment starts and rows, and the two counts."""
    import torch

    from tensorflowonspark_torch import embedding

    want = embedding.group_ids_plain(ids, vocab)
    count = int(want.meta[0])
    return (grouping.n == want.n and grouping.vocab == vocab
            and grouping.keys.dtype == torch.int32
            and torch.equal(grouping.keys, want.keys)
            and torch.equal(grouping.pos, want.pos)
            and torch.equal(grouping.meta, want.meta)
            and torch.equal(grouping.seg_start, want.seg_start)
            and torch.equal(grouping.seg_row[:count], want.seg_row[:count]))


def plain_on_cpu_rows(tables, ids, grads, lr: float, combine: bool):
    """The plain update run on the CPU, whose ``index_add_`` adds a row's
    occurrences in batch order, on copies of the touched rows only, the ids
    remapped onto them (rows are independent, so the bits are those of the
    whole tables).  Returns ``(touched rows, [(table rows, acc rows)])``."""
    import torch

    from tensorflowonspark_torch import embedding

    vocab = tables[0][0].shape[0]
    flat = embedding.wrap_ids(ids.reshape(-1).long(), vocab)
    keep = (flat >= 0) & (flat < vocab)
    rows, inverse = torch.unique(flat[keep], return_inverse=True)
    out = []
    for (table, acc), g in zip(tables, grads):
        g = g.reshape(flat.shape[0], *table.shape[1:])[keep].cpu()
        t, a = table[rows].cpu(), acc[rows].cpu()
        embedding.sparse_adagrad_update_plain(t, a, inverse.cpu(), g, lr,
                                              combine=combine)
        out.append((t, a))
    return rows, out


def f64_rows(tables, ids, grads, lr: float, combine: bool, eps=1e-10):
    """The update evaluated in float64 on the card, on the touched rows (as
    :func:`plain_on_cpu_rows`): an f32 result's distance from it is its
    rounding.  Returns ``(touched rows, [(table rows, acc rows)])``."""
    import torch

    from tensorflowonspark_torch import embedding

    vocab = tables[0][0].shape[0]
    flat = embedding.wrap_ids(ids.reshape(-1).long(), vocab)
    keep = (flat >= 0) & (flat < vocab)
    rows, inverse = torch.unique(flat[keep], return_inverse=True)
    out = []
    for (table, acc), g in zip(tables, grads):
        g = g.reshape(flat.shape[0], *table.shape[1:])[keep].double()
        t, a = table[rows].double(), acc[rows].double()
        if combine:
            s = torch.zeros_like(a).index_add_(0, inverse, g)
            a += s * s
            t += -lr * s * torch.rsqrt(a + eps)
        else:
            a.index_add_(0, inverse, g * g)
            t.index_add_(0, inverse, -lr * g * torch.rsqrt(a[inverse] + eps))
        out.append((t, a))
    return rows, out


def table_family(kernel: str) -> str | None:
    """The table path's family of a profiled kernel name: the grouping
    kernel, the update kernel, or ``None`` (the sort's kernels are CUB's,
    named apart by the callers)."""
    if "tfos_id_grouping" in kernel:
        return "id grouping"
    if "tfos_adagrad_segment_walk" in kernel:
        return "table update"
    return None


def table_device_ms(call, calls: int = 20) -> dict:
    """Device ms per ``call()`` (torch.profiler, CUPTI) by family: the
    grouping kernel, the update kernel, everything else."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    fams = dict.fromkeys(("id grouping", "table update", "other"), 0.0)
    for name, ms in device_kernels(prof, calls):
        fams[table_family(name) or "other"] += ms
    return fams


def measure_table_case(tables, ids, grads, combine: bool, label: str,
                       atomic_gate: bool = True,
                       replaced_ms: float | None = None) -> dict:
    """One case of phase 8: ``tables`` (one or two ``(table, acc)`` pairs
    sharing ``ids``; the deep and wide pair is a training step's) in one
    mode.  Gates and times (see the module docstring); the tables are left
    as they were: every call works on clones.  ``atomic_gate=False`` prints
    the distance to the card's plain version without gating it: where one
    row takes every occurrence, the atomic sum's own order moves it past
    ``TABLE_TOL_REL`` (see :data:`TABLE_TOL_REL`).  ``replaced_ms``: the
    replaced design's update time for the case, printed beside."""
    import torch

    from tensorflowonspark_torch import embedding
    from tensorflowonspark_torch.kernels import sparse_adagrad

    lr = 0.01
    path = "combine" if combine else "sparse"
    vocab = tables[0][0].shape[0]
    flat = ids.reshape(-1)
    wrapped = embedding.wrap_ids(flat, vocab)
    inside = wrapped[(wrapped >= 0) & (wrapped < vocab)].long()
    touched = torch.zeros(vocab, dtype=torch.bool, device="cuda")
    touched[inside] = True
    unique = int(touched.sum())

    def entry(pairs):
        if len(pairs) == 1:
            embedding.sparse_adagrad_update(*pairs[0], ids, grads[0], lr,
                                            combine=combine)
        else:
            embedding.sparse_adagrad_update_tables(pairs, ids, grads, lr,
                                                   combine=combine)

    groupings = [embedding.group_ids(flat, vocab) for _ in range(2)]
    torch.cuda.synchronize()
    grouped = all(grouping_matches(g, flat, vocab) for g in groupings)
    segments = int(groupings[0].meta[0])
    outs = []
    for _ in range(2):  # the path twice on fresh copies
        pairs = [(t.clone(), a.clone()) for t, a in tables]
        before = dict(sparse_adagrad.launches_by_path)
        entry(pairs)
        torch.cuda.synchronize()
        outs.append((pairs, {k: v - before[k] for k, v in
                             sparse_adagrad.launches_by_path.items()}))
    (got, took1), (again, took2) = outs
    same = all(torch.equal(x, y) for p, q in zip(got, again)
               for x, y in zip(p, q))
    launches_ok = all(took == {**dict.fromkeys(took, 0), "group": 1, path: 1}
                      for took in (took1, took2))
    rows, cpu = plain_on_cpu_rows(tables, ids, grads, lr, combine)
    bit_identical = all(torch.equal(x[rows].cpu(), y)
                        for p, q in zip(got, cpu) for x, y in zip(p, q))
    err, worst, moved = 0.0, 0.0, False
    f64 = {"kernel": 0.0, "card plain": 0.0}  # worst |x - f64| / max|f64|
    _, exact = f64_rows(tables, ids, grads, lr, combine)
    for (t, a), (t0, a0), g, pair64 in zip(got, tables, grads, exact):
        tp, ap = t0.clone(), a0.clone()
        embedding.sparse_adagrad_update_plain(tp, ap, ids, g, lr,
                                              combine=combine)
        for x, want, orig, x64 in ((t, tp, t0, pair64[0]),
                                   (a, ap, a0, pair64[1])):
            e, scale, _ = _table_diff(x, want, touched)
            err, worst = max(err, e), max(worst, e / max(scale, 1e-30))
            moved |= _table_diff(x, orig, touched)[2]
            for k, y in (("kernel", x), ("card plain", want)):
                d = (y[rows].double() - x64).abs().max()
                f64[k] = max(f64[k], float(d / x64.abs().max().clamp_min(
                    1e-300)))
        del tp, ap
    del exact
    tol_ok = worst <= TABLE_TOL_REL or not atomic_gate
    ok = (grouped and same and launches_ok and bit_identical and tol_ok
          and not moved)
    del outs, got, again, cpu

    work = [(t.clone(), a.clone()) for t, a in tables]  # timed calls update
    grouping = groupings[0]
    rows3 = [(t, a, g.reshape(flat.numel(), *t.shape[1:]))
             for (t, a), g in zip(work, grads)]
    ms = time_ms(lambda: entry(work), 200)
    group_ms = time_ms(lambda: sparse_adagrad.group(flat, vocab), 200)
    sort_ms = time_ms(lambda: torch.sort(wrapped, stable=True), 200)
    group_plain_ms = time_ms(lambda: embedding.group_ids_plain(flat, vocab),
                             20)
    update_ms = time_ms(lambda: sparse_adagrad.update(
        rows3, grouping, lr, 1e-10, combine), 200)
    plain_ms = time_ms(lambda: [embedding.sparse_adagrad_update_plain(
        t, a, ids, g, lr, combine=combine)
        for (t, a), g in zip(work, grads)], 50)
    dense_ms = plain_ms if combine else time_ms(lambda: [
        embedding.sparse_adagrad_update_plain(t, a, ids, g, lr, combine=True)
        for (t, a), g in zip(work, grads)], 20)
    host = host_us(lambda: entry(work))
    # one profiler session for the path and the library sort, told apart by
    # name: the path launches no kernel but its two (its other ops are
    # views, no-op casts and an empty allocation), so "other" is the sort's
    device = table_device_ms(lambda: (entry(work),
                                      torch.sort(wrapped, stable=True)))
    sort_device = device["other"]
    del work, rows3
    dims = [t[0].numel() for t, _ in tables]
    bound = step_bound_ms(ids.numel(), ids.element_size(), dims, unique)
    gbound = group_bound_ms(ids.numel(), ids.element_size(), segments)
    case = {"max_abs_err": err, "ms": update_ms, "path_ms": ms,
            "device_ms": device["table update"],
            "group_ms": group_ms, "group_device_ms": device["id grouping"],
            "sort_ms": sort_ms, "sort_device_ms": sort_device,
            "group_plain_ms": group_plain_ms, "plain_ms": plain_ms,
            "dense_path_ms": dense_ms, "host_us": host, "unique": unique,
            "segments": segments, "group_bound_ms": gbound["bound_ms"],
            **bound}
    print(f"table {label} {path}: {ids.numel()} {ids.dtype} ids, {unique} "
          f"rows touched, rows {dims} f32; grouping = sort_ids bit for bit "
          f"{grouped}, update = plain on the CPU bit for bit "
          f"{bit_identical}, vs plain on the card err {err:.3e}, worst "
          f"err/max {worst:.3e} (tol {TABLE_TOL_REL}"
          f"{'' if atomic_gate else ', not gated'}) {tol_ok}, vs float64 "
          f"worst err/max: kernel {f64['kernel']:.3e} card plain "
          f"{f64['card plain']:.3e}, untouched moved {moved}, "
          f"same bits twice {same}, launches {took1} {took2}; device ms: "
          f"grouping={device['id grouping']:.4f} update="
          f"{device['table update']:.4f} torch.sort={sort_device:.4f} "
          f"(replaced design: sort {REPLACED_MS['sort']}, update "
          f"{replaced_ms if replaced_ms is not None else '-'}); "
          f"event ms: path={ms:.4f} "
          f"grouping={group_ms:.4f} torch.sort={sort_ms:.4f} "
          f"grouping_plain={group_plain_ms:.4f} update={update_ms:.4f} "
          f"plain={plain_ms:.4f} dense_path="
          f"{'plain' if combine else f'{dense_ms:.4f}'}; bound_ms="
          f"{bound['bound_ms']:.5f} ({bound['bytes']} B), grouping bound "
          f"{gbound['bound_ms']:.5f}; host_us={host:.1f} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"table kernels {label} {path} failed")
    return case


def table_kernel_phase() -> dict:
    """Phase 8: both modes, on the full tables at batch 1024: the step's
    deep and wide pair in one launch for uniform, Zipf, int64, 8-rank
    all-gathered Zipf and all-equal ids; deep and wide alone for uniform
    and Zipf ids.  Returns, per mode, the pair's Zipf case (the slice's
    ids) with the others beside it."""
    import numpy as np
    import torch

    from tensorflowonspark_torch.models import widedeep

    config = widedeep.Config()
    gen = torch.Generator(device="cuda").manual_seed(5)
    vocab, dim = config.total_buckets, config.embed_dim
    tables = {
        "deep": (0.01 * torch.randn(vocab, dim, generator=gen,
                                    device="cuda"),
                 1e-6 * torch.rand(vocab, dim, generator=gen, device="cuda")),
        "wide": (0.01 * torch.randn(vocab, generator=gen, device="cuda"),
                 1e-6 * torch.rand(vocab, generator=gen, device="cuda"))}
    rng = np.random.RandomState(6)

    def draw(n, zipf):
        cat = torch.from_numpy(criteo_ids(rng, n, config.hash_buckets,
                                          zipf).astype(np.int32)).cuda()
        return widedeep.fold_ids(cat, config)

    draws = {"uniform": draw(WD_BATCH, 0.0), "zipf": draw(WD_BATCH, WD_ZIPF)}
    draws["int64"] = draws["uniform"].long()
    draws["ranks8_zipf"] = draw(8 * WD_BATCH, WD_ZIPF)
    draws["same_id"] = torch.full_like(draws["uniform"], 7 * 100_000 + 3)
    result = {}
    for combine in (True, False):
        path = "combine" if combine else "sparse"
        cases = {}
        for name, ids in draws.items():
            grads = [1e-4 * torch.randn(*ids.shape, *t.shape[1:],
                                        generator=gen, device="cuda")
                     for t, _ in tables.values()]
            replaced = {k: REPLACED_MS.get(f"{k}_{name}") for k in tables}
            cases[f"pair_{name}"] = measure_table_case(
                list(tables.values()), ids, grads, combine, f"pair {name}",
                atomic_gate=name != "same_id",
                replaced_ms=(sum(replaced.values())
                             if None not in replaced.values() else None))
            if name in ("uniform", "zipf"):
                for i, label in enumerate(tables):
                    cases[f"{label}_{name}"] = measure_table_case(
                        [tables[label]], ids, grads[i:i + 1], combine,
                        f"{label} {name}", replaced_ms=replaced[label])
        main = cases["pair_zipf"]
        print(f"table {path} per training step (deep + wide in one launch, "
              f"Zipf ids): " + " ".join(
                  f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                  for k, v in main.items()), flush=True)
        result[path] = {
            **{k: main[k] for k in (
                "ms", "path_ms", "device_ms", "plain_ms", "bound_ms",
                "bytes_ms", "ops_ms", "bound_by", "host_us", "group_ms",
                "group_device_ms", "sort_ms", "sort_device_ms",
                "group_plain_ms", "group_bound_ms", "segments")},
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "library_ms": main["plain_ms"] if combine else None,
            **({} if combine else {"dense_path_ms": main["dense_path_ms"]}),
            **{f"{k}_{m}": c[m] for k, c in cases.items() if k != "pair_zipf"
               for m in ("ms", "device_ms", "group_device_ms", "bound_ms")}}
    del tables
    torch.cuda.empty_cache()
    return result


def _wd_trainer(table_update: str, seed: int = 0):
    import dataclasses

    from tensorflowonspark_torch.models import widedeep
    from tensorflowonspark_torch.trainer import Trainer

    config = dataclasses.replace(widedeep.Config(), table_update=table_update)
    return Trainer("wide_deep", config=config, learning_rate=WD_LR, seed=seed,
                   device="cuda")


def _plain_tables_update(tables, ids, grads, lr, eps=1e-10, combine=False):
    """``embedding.sparse_adagrad_update_tables`` with the plain version,
    run on the CPU, whose ``index_add_`` adds a row's occurrences in batch
    order as the kernel does (on the card it adds them with atomics, in no
    fixed order): the step's twin the kernel path is held against."""
    from tensorflowonspark_torch import embedding

    for (table, acc), g in zip(tables, grads):
        t, a = table.cpu(), acc.cpu()
        embedding.sparse_adagrad_update_plain(t, a, ids.cpu(), g.cpu(), lr,
                                              eps, combine)
        table.copy_(t)
        acc.copy_(a)
    return tables


def wd_train_model_phase() -> dict:
    """Phase 9 (see the module docstring)."""
    import numpy as np
    import torch

    from tensorflowonspark_torch import embedding
    from tensorflowonspark_torch.kernels import sparse_adagrad
    from tensorflowonspark_torch.models import widedeep

    buckets = widedeep.Config().hash_buckets

    def device_batch(rows):
        return {k: torch.from_numpy(v).cuda()
                for k, v in rows_to_batch(rows).items()}

    out = {}
    for table_update, path in WD_MODES:
        # one step, kernel path against the plain table update
        batch = device_batch(synth_criteo(WD_BATCH, buckets, seed=7,
                                          zipf=WD_ZIPF))
        kernel_t, plain_t = _wd_trainer(table_update), _wd_trainer(
            table_update)
        before = {k: v.clone() for k, v in
                  kernel_t.model.collections()["embedding"].items()}
        sparse_adagrad.reset_launches()
        loss_k = float(kernel_t.step(batch))
        torch.cuda.synchronize()
        step_launches = dict(sparse_adagrad.launches_by_path)
        kernel_update = embedding.sparse_adagrad_update_tables
        embedding.sparse_adagrad_update_tables = _plain_tables_update
        try:
            loss_p = float(plain_t.step(batch))
        finally:
            embedding.sparse_adagrad_update_tables = kernel_update
        plain_launches = sparse_adagrad.launches - sum(step_launches.values())

        def mlp(t, grad):
            return {k: (p.grad if grad else p).detach()
                    for k, p in t.model.named_parameters()}

        grads = _rel_l2(mlp(kernel_t, True), mlp(plain_t, True))
        params = _rel_l2(mlp(kernel_t, False), mlp(plain_t, False))
        ids = widedeep.fold_ids(batch["cat"], kernel_t.config).reshape(-1)
        touched = torch.zeros(kernel_t.config.total_buckets, dtype=torch.bool,
                              device="cuda")
        touched[ids.long()] = True
        table_ok, worst, identical = True, 0.0, True
        for group, leaves in kernel_t.model.collections().items():
            for k, got in leaves.items():
                want = plain_t.model.collections()[group][k]
                err, scale, _ = _table_diff(got, want, touched)
                worst = max(worst, err / max(scale, 1e-30))
                identical &= torch.equal(got, want)
                table_ok &= err <= TABLE_TOL_REL * scale and identical
                if k in before:
                    table_ok &= not _table_diff(got, before[k], touched)[2]
        del plain_t, before
        print(f"train wide_deep {table_update} one step at batch {WD_BATCH} "
              f"(Zipf ids): loss kernel={loss_k:.6f} plain-table={loss_p:.6f}"
              f"; MLP grads rel_l2={grads:.3e} params after={params:.3e} "
              f"(tol {WD_MLP_REL}); tables+accumulators against the plain "
              f"update on the CPU: worst err/max={worst:.3e} (tol "
              f"{TABLE_TOL_REL}), bit-identical={identical}, untouched rows "
              f"kept; "
              f"table launches {step_launches} (plain path {plain_launches})",
              flush=True)
        if (grads > WD_MLP_REL or params > WD_MLP_REL or not table_ok
                or loss_k != loss_p or plain_launches
                or step_launches != {**dict.fromkeys(step_launches, 0),
                                     "group": 1, path: 1}):
            raise SystemExit(f"wide&deep training-model phase failed "
                             f"({table_update}, one step)")

        # 20 steps on synth_criteo rows: the loss falls, a grouping and an
        # update launch a step
        rows = synth_criteo(WD_BATCH * WD_STEPS, buckets, seed=8)
        sparse_adagrad.reset_launches()
        replays = replayed_steps()
        losses = [kernel_t.step(device_batch(
            rows[i * WD_BATCH:(i + 1) * WD_BATCH])) for i in range(WD_STEPS)]
        losses = [float(v) for v in losses]
        launches = dict(sparse_adagrad.launches_by_path)
        counted = WD_STEPS - (replayed_steps() - replays)
        falls = np.mean(losses[-5:]) < WD_FALL * losses[0]
        print(f"train wide_deep {table_update} {WD_STEPS} steps: losses "
              f"{[round(v, 5) for v in losses]}; last-5 mean / first = "
              f"{np.mean(losses[-5:]) / losses[0]:.4f} (falls below "
              f"{WD_FALL}: {falls}); table launches {launches} (the "
              f"{WD_STEPS - counted} steps a replay ran alone not counted)",
              flush=True)
        if (not falls or not all(math.isfinite(v) for v in losses)
                or launches != {**dict.fromkeys(launches, 0),
                                "group": counted, path: counted}):
            raise SystemExit(f"wide&deep training-model phase failed "
                             f"({table_update}, trajectory)")

        # steps/s on one device-resident batch
        del kernel_t
        torch.cuda.empty_cache()
        t = _wd_trainer(table_update)
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(lambda: t.step(batch), 50)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"train wide_deep {table_update} step batch {WD_BATCH}: "
              f"{step_ms:.4f} ms, {1e3 / step_ms:.1f} steps/s, "
              f"{WD_BATCH * 1e3 / step_ms:.0f} examples/s, peak memory "
              f"{peak_gb:.2f} GB", flush=True)
        profile_wd_step(t, batch, step_ms, table_update)
        del t
        torch.cuda.empty_cache()
        out[table_update] = {"steps_per_s": 1e3 / step_ms,
                             "step_ms": step_ms, "peak_gb": peak_gb}
    return out


def wd_step_family(kernel: str) -> str:
    """The family of a kernel of the wide&deep step, by name: the table
    path's two kernels by theirs (:func:`table_family`), then GEMMs, the
    gather, any id sort (CUB's radix sort), AdamW, other."""
    name = kernel.lower()
    fam = table_family(kernel)
    if fam is not None:
        return fam
    for fam, keys in (("GEMMs", ("gemm", "cutlass", "nvjet", "sm90_", "xmma",
                                 "cublas")),
                      ("gather", ("index", "gather")),
                      ("id sort", ("sort", "radix", "cub::")),
                      ("AdamW", ("adam", "multi_tensor", "foreach"))):
        if any(k in name for k in keys):
            return fam
    return "other"


def profile_wd_step(trainer, batch, step_ms: float, label: str,
                    steps: int = 5) -> None:
    """Device time per wide&deep step by family (torch.profiler, CUPTI):
    GEMMs, the gather, the id grouping kernel, the table update kernel, any
    id sort, AdamW, other."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.step(batch)
        torch.cuda.synchronize()
    fams, kernels = collections.Counter(), collections.Counter()
    for kernel, ms in device_kernels(prof, steps):
        fam = wd_step_family(kernel)
        fams[fam] += ms
        kernels[f"[{fam}] {kernel[:50]}"] += ms
    busy = sum(fams.values())
    if busy == 0:
        print("profile: the profiler recorded no device time (not measured)",
              flush=True)
        return
    parts = " ".join(f"{k}={v:.4f}ms({v / busy:.1%})"
                     for k, v in fams.most_common())
    print(f"profile wide_deep {label} step batch {WD_BATCH}, device ms per "
          f"step: busy={busy:.4f} of {step_ms:.4f} (idle share "
          f"{max(0.0, 1 - busy / step_ms):.1%}); {parts}", flush=True)
    print(f"profile wide_deep {label} largest kernels of the step: "
          + "; ".join(f"{name}={ms:.4f}ms"
                      for name, ms in kernels.most_common(8)), flush=True)


def criteo_train_fn(args, ctx):
    """Port of ``examples/criteo/criteo_pipeline.py::train_fun``: a
    wide&deep ``Trainer`` on the node's device fed by the DataFrame's
    partitions (``DataFeed``, prefetching, staged by ``trainer.shard`` with
    the reference's dtype casts), publishing its metrics every step; the
    chief exports.  Then the losses and the table launches of its steps on
    the node's kv blackboard."""
    import dataclasses

    import numpy as np

    from tensorflowonspark_torch import metrics
    from tensorflowonspark_torch.kernels import sparse_adagrad
    from tensorflowonspark_torch.models import widedeep
    from tensorflowonspark_torch.trainer import Trainer

    config = widedeep.Config.tiny() if args.tiny else widedeep.Config()
    # --lr drives both towers of the CTR recipe: AdaGrad on the tables at
    # 10x, AdamW on the MLP through the Trainer's default optimizer
    config = dataclasses.replace(config, table_lr=args.lr * 10.0,
                                 table_update=args.table_update)
    trainer = Trainer("wide_deep", config=config, learning_rate=args.lr)
    trainer.add_step_callback(metrics.MetricsReporter(ctx, interval=1))
    feed = ctx.get_data_feed(train_mode=True,
                             input_mapping=["dense", "cat", "label"],
                             prefetch=2)

    def stage(batch):
        # short tail batches stay on the host: the loop drops them
        if batch["dense"].shape[0] != args.batch_size:
            return batch
        return trainer.shard({
            "dense": batch["dense"].astype(np.float32),
            "cat": batch["cat"].astype(np.int32),
            "label": batch["label"].astype(np.int32),
        })

    sparse_adagrad.reset_launches()
    replays = replayed_steps()
    losses = []
    while not feed.should_stop():
        batch = feed.next_batch(args.batch_size, device_put=stage)
        if not batch or batch["dense"].shape[0] != args.batch_size:
            continue
        losses.append(trainer.step(batch))
    ctx.mgr.set("launches", dict(sparse_adagrad.launches_by_path))
    ctx.mgr.set("replays", replayed_steps() - replays)
    ctx.mgr.set("losses", [float(v) for v in losses])
    ctx.mgr.set("device", str(trainer.device))
    if ctx.job_name == "chief":
        trainer.export(ctx.absolute_path(args.export_dir))


def fit_and_score(sc, df, args: dict, batch_size: int, cluster_size: int,
                  export_dir: str):
    """``TFEstimator(criteo_train_fn).fit(df)`` then ``TFModel.transform``
    of the export (scores named ``ctr``).  Returns ``(the cluster, what each
    node published, the scored rows)``; the cluster is the one
    ``TFEstimator.fit`` ran, caught on its way through ``TFCluster.run``,
    so its managers can be read after the fit."""
    from tensorflowonspark_torch import TFCluster, TFManager, pipeline

    clusters = []
    run = TFCluster.run

    def catching_run(*a, **k):
        clusters.append(run(*a, **k))
        return clusters[-1]

    TFCluster.run = catching_run
    t0 = time.perf_counter()
    try:
        est = (pipeline.TFEstimator(criteo_train_fn, tf_args=args)
               .setClusterSize(cluster_size).setBatchSize(batch_size)
               .setEpochs(1).setExportDir(export_dir)
               .setModelName("wide_deep").setGraceSecs(120))
        model = est.fit(df)
    finally:
        TFCluster.run = run
    [cluster] = clusters
    authkey = bytes.fromhex(cluster.cluster_meta["authkey_hex"])
    published = []
    for meta in cluster.cluster_info:
        mgr = TFManager.connect(tuple(meta["addr"]), authkey)
        published.append({k: mgr.get(k) for k in ("state", "losses",
                                                  "launches", "replays",
                                                  "device")})
    t1 = time.perf_counter()
    scored = (model.setBatchSize(batch_size)
              .setInputMapping({"dense": "dense", "cat": "cat"})
              .setOutputMapping({"prediction": "ctr"})
              .transform(df.select("dense", "cat"))).collect()
    print(f"fit_and_score: TFEstimator.fit {t1 - t0:.1f} s, "
          f"TFModel.transform {time.perf_counter() - t1:.1f} s", flush=True)
    return cluster, published, scored


def wd_slice_phase() -> dict:
    """Phase 10 (see the module docstring), once per ``table_update``."""
    import numpy as np
    import torch

    from tensorflowonspark_torch import ckpt, compat, pipeline, sparkapi
    from tensorflowonspark_torch.models import widedeep

    buckets = widedeep.Config().hash_buckets
    rows = synth_criteo(WD_SLICE_ROWS, buckets, seed=9, zipf=WD_ZIPF)
    steps = WD_SLICE_ROWS // WD_BATCH
    out = {}
    for table_update, path in WD_MODES:
        export_dir = tempfile.mkdtemp(prefix="tfos_torch_wd_")
        sc = sparkapi.LocalSparkContext("local[1]")
        try:
            df = sparkapi.LocalSparkSession(sc).createDataFrame(
                rows, ["dense", "cat", "label"]).repartition(
                    WD_SLICE_PARTITIONS)
            t0 = time.perf_counter()
            cluster, [node], scored = fit_and_score(
                sc, df, {"lr": WD_LR, "tiny": False,
                         "table_update": table_update},
                WD_BATCH, 1, export_dir)
            seconds = time.perf_counter() - t0
            agg = cluster.metrics()
            state = ckpt.load_pytree(os.path.join(export_dir, "model"))
            # the export serves its serialized forward; the zoo's forward
            # by name serves the same weights exported weights-only
            weights_only = os.path.join(export_dir, "weights_only")
            compat.export_saved_model(state, weights_only)
            by_name = (pipeline.TFModel(device="cuda")
                       .setExportDir(weights_only).setModelName("wide_deep")
                       .setBatchSize(WD_BATCH)
                       .setInputMapping({"dense": "dense", "cat": "cat"})
                       .setOutputMapping({"prediction": "ctr"})
                       .transform(df.select("dense", "cat"))).collect()
        finally:
            sc.stop()
            shutil.rmtree(export_dir, ignore_errors=True)
        # the same batches, in partition order, in this process
        t = _wd_trainer(table_update)
        replay = [float(t.step(rows_to_batch(
            rows[i * WD_BATCH:(i + 1) * WD_BATCH]))) for i in range(steps)]
        del t
        served = widedeep.load_state(widedeep.make_model(
            widedeep.config_from_state(state)), state).cuda().eval()
        forward = widedeep.make_forward_fn(served, served.config)
        want = torch.cat([forward(served, {
            k: torch.from_numpy(v).cuda() for k, v in rows_to_batch(
                rows[i * WD_BATCH:(i + 1) * WD_BATCH]).items()}).cpu()
            for i in range(steps)])
        del served
        torch.cuda.empty_cache()
        def score_err(rows_scored):
            got = torch.tensor([r.ctr for r in rows_scored])
            return (float((got - want).abs().max())
                    if got.shape == want.shape else float("inf"))

        losses = node["losses"] or []
        rel = max((abs(a - b) / abs(b) for a, b in zip(losses, replay)),
                  default=float("inf"))
        serialized_err, by_name_err = score_err(scored), score_err(by_name)
        ex_per_s = agg.get("total_examples_per_sec")
        steps_per_s = ex_per_s / WD_BATCH if ex_per_s else None
        launches = node["launches"] or {}
        counted = steps - (node["replays"] or 0)
        print(f"slice wide_deep {table_update}: TFEstimator.fit -> "
              f"TFCluster.run -> DataFeed -> Trainer.step on {node['device']}"
              f": state {node['state']}, {len(losses)} steps, losses "
              f"{[round(v, 6) for v in losses]}; in-process replay "
              f"{[round(v, 6) for v in replay]}; max rel {rel:.3e} (tol "
              f"{WD_SLICE_VS_REPLAY}); executor table launches {launches} "
              f"({steps - counted} steps replayed alone); "
              f"TFModel.transform {len(scored)} rows from the export's "
              f"serialized forward, max |score - in-process forward| "
              f"{serialized_err:.3e}, by model name from a weights-only "
              f"export {by_name_err:.3e} (tol {WD_SCORES_VS_FORWARD}); "
              f"cluster.metrics() steps/s="
              f"{steps_per_s} ({ex_per_s} examples/s); fit + transform "
              f"{seconds:.1f} s", flush=True)
        if (node["state"] != "finished" or len(losses) != steps
                or not all(math.isfinite(v) for v in losses)
                or rel > WD_SLICE_VS_REPLAY
                or not str(node["device"]).startswith("cuda")
                or launches != {**dict.fromkeys(launches, 0),
                                "group": counted, path: counted}
                or len(scored) != WD_SLICE_ROWS
                or not serialized_err <= WD_SCORES_VS_FORWARD
                or not by_name_err <= WD_SCORES_VS_FORWARD
                or not steps_per_s):
            raise SystemExit(f"wide&deep slice phase failed ({table_update})")
        out[path] = {"launches": launches[path],
                     "group_launches": launches["group"],
                     "steps_per_s": steps_per_s}
    return out


# ---------------------------------------------------------------------------
# InputMode.TENSORFLOW: each node reads its own files (phases 11-12)
# ---------------------------------------------------------------------------


def tf_resnet_args(data_dir: str, tiny: bool = False,
                   ckpt_dir: str | None = None,
                   model_dir: str | None = None):
    """The port example's arguments for phase 11: batch 64, one reader (the
    record order is then the same in every run, so a replay can follow
    it), a seeded shuffle buffer, one epoch; with ``ckpt_dir`` the
    chief's checkpoint at the job's last step (``ckpt_every_steps``, which
    :func:`tf_resnet_map_fun` hands the example), with ``model_dir`` its
    self-describing export (phase 13 reads both)."""
    from tensorflowonspark_torch.examples import resnet_spark

    args = resnet_spark.parse_args(
        ["--batch_size", str(SLICE_TRAIN_BATCH), "--readers", "1",
         "--shuffle_buffer", str(TF_SHUFFLE), "--lr", str(TRAIN_LR),
         "--epochs", "1", "--data_dir", data_dir]
        + (["--tiny"] if tiny else [])
        + (["--ckpt_dir", ckpt_dir] if ckpt_dir else [])
        + (["--model_dir", model_dir] if model_dir else []))
    args.ckpt_every_steps = TF_RECORDS // SLICE_TRAIN_BATCH
    return args


def tf_resnet_resume_args(args):
    """Phase 13's second job: phase 11's arguments over two epochs of the
    same records, stopping ``RESUME_STEPS`` after the first epoch's end,
    with no export.  The reader's first epoch is phase 11's, record for
    record (one reader, the shuffle's generator carried across epochs)."""
    import argparse

    steps = TF_RECORDS // args.batch_size
    return argparse.Namespace(**{**vars(args), "epochs": 2,
                                 "max_steps": steps + RESUME_STEPS,
                                 "model_dir": None,
                                 "ckpt_every_steps": RESUME_STEPS})


def compile_seconds() -> float:
    """The process's goodput ``compile`` seconds: on the card, the walls
    of the steps that captured a CUDA graph."""
    from tensorflowonspark_torch import obs

    c = obs.get_registry().peek("goodput_seconds_total", {"phase": "compile"})
    return float(c.value) if c is not None else 0.0


def run_counted(map_fun, args, ctx):
    """``map_fun(args, ctx)`` with the node's GroupNorm launch counts set to
    0 before it and published after it (``launches``), the table kernels'
    launches it made (``table_launches``; their counts are not reset, so a
    phase can count an executor's launches across its jobs) and its steps
    a graph replay ran alone (``replays``).
    A job runs ``functools.partial(run_counted, map_fun)``."""
    from tensorflowonspark_torch.kernels import group_norm, sparse_adagrad

    ctx.mgr.set("map_fun_start", time.time())
    group_norm.reset_launches()
    tables = dict(sparse_adagrad.launches_by_path)
    compile_s, replays = compile_seconds(), replayed_steps()
    map_fun(args, ctx)
    ctx.mgr.set("compile_s", compile_seconds() - compile_s)
    ctx.mgr.set("replays", replayed_steps() - replays)
    ctx.mgr.set("launches", dict(group_norm.launches_by_path))
    ctx.mgr.set("table_launches", {
        k: v - tables[k] for k, v in sparse_adagrad.launches_by_path.items()})
    ctx.mgr.set("map_fun_end", time.time())


def tf_resnet_map_fun(args, ctx):
    """``tensorflowonspark_torch/examples/resnet_spark.py::map_fun``,
    counted (:func:`run_counted`), with ``TFOS_CKPT_EVERY_STEPS`` (the
    example's checkpoint cadence) set to ``args.ckpt_every_steps`` in the
    executor's environment while it runs."""
    from tensorflowonspark_torch.examples import resnet_spark

    cadence = os.environ.get("TFOS_CKPT_EVERY_STEPS")
    os.environ["TFOS_CKPT_EVERY_STEPS"] = str(args.ckpt_every_steps)
    try:
        run_counted(resnet_spark.map_fun, args, ctx)
    finally:
        if cadence is None:
            os.environ.pop("TFOS_CKPT_EVERY_STEPS")
        else:
            os.environ["TFOS_CKPT_EVERY_STEPS"] = cadence


def tf_resnet_replay(args, device: str, with_state: bool = False):
    """Phase 11's (and 14's) in-process replay: the one node's shard read
    with the same arguments through the port's ``tfrecord_batches`` (the
    example's ``train_batches``) into a fresh seeded ``Trainer`` of
    ``args.arch`` on ``device``.
    Returns the losses; with ``with_state`` also the trainer's state at
    the end (:func:`flat_state`)."""
    from tensorflowonspark_torch import models as model_zoo
    from tensorflowonspark_torch import readers
    from tensorflowonspark_torch.examples import resnet_spark
    from tensorflowonspark_torch.trainer import Trainer

    shard = readers.shard_files(os.path.join(args.data_dir, "part-*"), 0, 1)
    lib = model_zoo.get_model(args.arch)
    config = lib.Config.tiny() if args.tiny else lib.Config()
    t = Trainer(args.arch, config=config, learning_rate=args.lr,
                device=device)
    from tensorflowonspark_torch.parallel import train as train_lib

    losses = [float(t.step(b)) for b in resnet_spark.steps_of(
        args, resnet_spark.train_batches(args, shard, 0, t.shard))]
    if not with_state:
        return losses
    return losses, flat_state(train_lib.state_tree(t.state))


def tf_wd_args(work_dir: str, tiny: bool = False):
    """The port example's arguments for phase 12: full ``widedeep.Config()``
    (the combine table update), batch 1024, one epoch."""
    from tensorflowonspark_torch.examples import criteo_pipeline

    return criteo_pipeline.parse_args(
        ["--batch_size", str(WD_BATCH), "--lr", str(WD_LR), "--epochs", "1",
         "--input", "parquet",
         "--parquet_dir", os.path.join(work_dir, "parquet"),
         "--export_dir", os.path.join(work_dir, "export")]
        + ([] if tiny else ["--full"]))


def tf_wd_train_fun(args, ctx):
    """``tensorflowonspark_torch/examples/criteo_pipeline.py::
    parquet_train_fun`` with the node's table launch counts set to 0
    before it and published after it."""
    from tensorflowonspark_torch.examples import criteo_pipeline
    from tensorflowonspark_torch.kernels import sparse_adagrad

    ctx.mgr.set("map_fun_start", time.time())
    sparse_adagrad.reset_launches()
    compile_s, replays = compile_seconds(), replayed_steps()
    criteo_pipeline.parquet_train_fun(args, ctx)
    ctx.mgr.set("compile_s", compile_seconds() - compile_s)
    ctx.mgr.set("replays", replayed_steps() - replays)
    ctx.mgr.set("launches", dict(sparse_adagrad.launches_by_path))
    ctx.mgr.set("map_fun_end", time.time())


def tf_wd_replay(args, device: str) -> tuple[list, dict]:
    """Phase 12's in-process replay: the one node's Parquet shard read with
    the same arguments through the port's ``parquet_batches`` and the
    example's stager into a fresh ``Trainer`` on ``device``.  Returns the
    losses and the staged batches' columns as the steps took them,
    concatenated on the host."""
    import numpy as np

    from tensorflowonspark_torch.examples import criteo_pipeline

    t = criteo_pipeline.make_trainer(args, device=device)
    stage = criteo_pipeline.stage_fn(t)
    shard = criteo_pipeline.parquet_shard(args, 0, 1)
    losses, seen = [], collections.defaultdict(list)

    def keep_and_stage(batch):
        staged = stage(batch)
        for k, v in staged.items():
            seen[k].append(v.cpu().numpy())
        return staged

    for b in criteo_pipeline.parquet_batches(args, shard, keep_and_stage):
        losses.append(float(t.step(b)))
    return losses, {k: np.concatenate(v) for k, v in seen.items()}


def node_managers(cluster) -> list:
    """The kv blackboard of each node of ``cluster``, in executor order."""
    from tensorflowonspark_torch import TFManager

    authkey = bytes.fromhex(cluster.cluster_meta["authkey_hex"])
    return [TFManager.connect(tuple(meta["addr"]), authkey)
            for meta in sorted(cluster.cluster_info,
                               key=lambda m: m["executor_id"])]


def node_published(cluster, keys) -> list:
    """What each node put on its kv blackboard under ``keys`` (read after
    ``cluster.shutdown``), in executor order."""
    return [{k: mgr.get(k) for k in keys} for mgr in node_managers(cluster)]


def loss_rel(losses, replay, final_only: bool) -> float:
    """Relative distance of the slice's losses from the replay's: of the
    final loss, or the largest over the steps; ``inf`` when the step
    counts differ."""
    if not losses or len(losses) != len(replay):
        return float("inf")
    pairs = list(zip(losses, replay))[-1:] if final_only else zip(losses,
                                                                   replay)
    return max(abs(a - b) / abs(b) for a, b in pairs)


def slice_failures(node: dict, replay: list, *, steps: int, per_step:
                   dict, tol: float, final_only: bool,
                   device: str = "cuda") -> list:
    """Every gate a TENSORFLOW-mode slice breaks (empty when it passes):
    the node finished on ``device``, took ``steps`` steps with finite
    losses within ``tol`` of the replay, and its wrappers counted exactly
    ``per_step`` launches a step for each step but those a graph replay
    ran alone (the node's ``replays``)."""
    losses = node.get("losses") or []
    failures = []
    if node.get("state") != "finished":
        failures.append(f"state {node.get('state')}")
    if not str(node.get("device")).startswith(device):
        failures.append(f"device {node.get('device')} (want {device})")
    if len(losses) != steps:
        failures.append(f"{len(losses)} steps (want {steps})")
    if not all(math.isfinite(v) for v in losses):
        failures.append("a loss is not finite")
    rel = loss_rel(losses, replay, final_only)
    if not rel <= tol:
        failures.append(f"loss rel {rel:.3e} > {tol}")
    counted = steps - (node.get("replays") or 0)
    want = {k: v * counted for k, v in per_step.items()}
    if node.get("launches") != want:
        failures.append(f"launches {node.get('launches')} (want {want}: "
                        f"{counted} steps counted)")
    return failures


def slice_rates(agg: dict, unit: int) -> dict:
    """A one-node cluster's rates from ``cluster.metrics()``: the windowed
    examples/s of its metrics hook over ``unit`` (1: images/s, the batch:
    steps/s), and the wall rate of its loop (every example over the time
    from the hook's start to its last publication)."""
    [snap] = agg["nodes"].values()
    ex_per_s = agg.get("total_examples_per_sec")
    wall = (snap["total_examples"] / snap["elapsed_sec"]
            if snap.get("elapsed_sec") else None)
    return {"rate": ex_per_s / unit if ex_per_s else None,
            "wall_rate": wall / unit if wall else None,
            "steps": snap.get("step")}


def job_timeline(t_run: float, t_formed: float, t_done: float, node: dict,
                 loop_s: float | None) -> str:
    """Where a TENSORFLOW-mode job's wall time went: the cluster's forming
    (``TFCluster.run`` returning), the node's ``map_fun`` until its loop
    started (the trainer's build), the loop (the metrics hook's own
    clock) and the rest up to ``cluster.shutdown`` returning; wall clock
    seconds, driver and executor on one host."""
    start, end = node.get("map_fun_start"), node.get("map_fun_end")
    if start is None or end is None or loop_s is None:
        return "timeline not published"
    capture = node.get("compile_s")
    return (f"formed {t_formed - t_run:.1f} s, map_fun started at "
            f"{start - t_run:.1f} s, trainer build "
            f"{end - start - loop_s:.1f} s, loop {loop_s:.1f} s"
            + ("" if capture is None else
               f" (the capturing step {capture:.2f} s)")
            + f", after the loop {t_done - end:.1f} s")


def run_tf_job(sc, map_fun, args, keys=()) -> tuple:
    """``TFCluster.run(map_fun, InputMode.TENSORFLOW, master_node="chief")``
    on one executor of ``sc``, to ``cluster.shutdown``.  Returns what the
    node published (state, losses, launches, device and ``keys``),
    ``cluster.metrics()``, the job's seconds and where they went."""
    from tensorflowonspark_torch import TFCluster

    t0, w0 = time.perf_counter(), time.time()
    cluster = TFCluster.run(sc, map_fun, args, num_executors=1,
                            input_mode=TFCluster.InputMode.TENSORFLOW,
                            master_node="chief")
    w_formed = time.time()
    cluster.shutdown(grace_secs=600)
    job_s, w_done = time.perf_counter() - t0, time.time()
    [node] = node_published(cluster, ("state", "losses", "launches",
                                      "replays", "device", "map_fun_start",
                                      "map_fun_end", "compile_s", *keys))
    agg = cluster.metrics()
    [snap] = agg["nodes"].values()
    return node, agg, job_s, job_timeline(w0, w_formed, w_done, node,
                                          snap.get("elapsed_sec"))


def feed_alone(batches) -> dict:
    """Time a batch iterator consumed with no step: the reader, its parse,
    its staging (a copy to the card) and nothing else.  Returns the batch
    count, the wall seconds from the first request to the last batch on
    the card, and those after the first batch (the reader's start left
    out)."""
    import torch

    t0 = time.perf_counter()
    t_first, n = None, 0
    for _ in batches:
        n += 1
        if t_first is None:
            torch.cuda.synchronize()
            t_first = time.perf_counter()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    return {"batches": n, "seconds": t_end - t0,
            "seconds_after_first": t_end - t_first if n else 0.0}


def tf_resnet_slice_phase(sc, work: str) -> dict:
    """Phase 11 (see the module docstring), on ``sc``, its records,
    checkpoints and export under ``work`` (phase 13 goes on from them)."""
    import torch

    from tensorflowonspark_torch import tfrecord
    from tensorflowonspark_torch.examples import resnet_spark
    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.trainer import Trainer

    data_dir = os.path.join(work, "records")
    t0 = time.perf_counter()
    files = resnet.write_synthetic_tfrecords(data_dir, TF_RECORDS, TF_PARTS,
                                             224, seed=3)
    write_s = time.perf_counter() - t0
    native = tfrecord._native()
    codec = (f"native ({os.path.basename(native.library_path())}, g++)"
             if native is not None else "python (google_crc32c)")
    mb = sum(os.path.getsize(f) for f in files) / 1e6
    args = tf_resnet_args(data_dir, ckpt_dir=os.path.join(work, "ckpt"),
                          model_dir=os.path.join(work, "export"))
    node, agg, job_s, timeline = run_tf_job(sc, tf_resnet_map_fun, args)
    # the same job with no checkpoint and no export: PR 7's phase 11, and
    # what the saves cost the loop end to end
    plain, plain_agg, plain_s, plain_timeline = run_tf_job(
        sc, tf_resnet_map_fun, tf_resnet_args(data_dir))
    t2 = time.perf_counter()
    # the replay goes on past phase 11's steps: phase 13's resumed job is
    # held to the rest, and to its state at the end
    replay, replay_state = tf_resnet_replay(tf_resnet_resume_args(args),
                                            "cuda", with_state=True)
    replay_s = time.perf_counter() - t2
    # what sets the loop's rate: the feed alone (the same reader and
    # copies, no step) and the step alone at the same batch
    feed = feed_alone(resnet_spark.train_batches(args, files, 0, True))
    t = Trainer("resnet50", config=resnet.Config(),
                learning_rate=TRAIN_LR, device="cuda")
    batch = t.shard(resnet.example_batch(resnet.Config(),
                                         SLICE_TRAIN_BATCH))
    step_ms = time_ms(lambda: t.step(batch), 10)
    del t, batch
    torch.cuda.empty_cache()
    feed_ips = ((feed["batches"] - 1) * SLICE_TRAIN_BATCH
                / feed["seconds_after_first"])
    step_ips = SLICE_TRAIN_BATCH / step_ms * 1e3
    steps = TF_RECORDS // SLICE_TRAIN_BATCH
    want = launch_counts(one_pass=53, backward_one_pass=53)
    failures = slice_failures(node, replay[:steps], steps=steps,
                              per_step=want,
                              tol=SLICE_TRAIN_VS_IN_PROCESS, final_only=True)
    failures += [f"the job with no checkpoint: {f}" for f in slice_failures(
        plain, node["losses"] or [], steps=steps, per_step=want,
        tol=0.0, final_only=False)]
    rates = slice_rates(agg, 1)
    plain_rates = slice_rates(plain_agg, 1)
    print(f"tf-mode slice resnet50: write_synthetic_tfrecords {TF_RECORDS} "
          f"records 224² in {len(files)} files, {mb:.1f} MB in {write_s:.2f} s"
          f" by the {codec} codec; TFCluster.run(InputMode.TENSORFLOW) -> "
          f"shard_files -> tfrecord_batches(readers=1, shuffle_buffer="
          f"{TF_SHUFFLE}, prefetch=2, device_put=trainer.shard) -> "
          f"Trainer.step on {node['device']}: state {node['state']}, "
          f"losses {[round(v, 5) for v in node['losses'] or []]}; in-process"
          f" replay {[round(v, 5) for v in replay[:steps]]}; final loss rel "
          f"{loss_rel(node['losses'], replay[:steps], True):.3e} (tol "
          f"{SLICE_TRAIN_VS_IN_PROCESS}); executor launches "
          f"{node['launches']}; cluster.metrics() images/s={rates['rate']}; "
          f"loop wall images/s={rates['wall_rate']}; job {job_s:.1f} s ("
          f"{timeline}); the job again with no checkpoint and no export "
          f"(its losses the same: {plain['losses'] == node['losses']}): "
          f"cluster.metrics() images/s={plain_rates['rate']}, loop wall "
          f"images/s={plain_rates['wall_rate']}, job {plain_s:.1f} s "
          f"({plain_timeline}); "
          f"replay {replay_s:.1f} s; the feed alone (tfrecord_batches + "
          f"copies, no step) {feed['batches']} batches in "
          f"{feed['seconds']:.3f} s, {feed_ips:.1f} images/s after its first "
          f"batch; Trainer.step alone at batch {SLICE_TRAIN_BATCH} "
          f"{step_ms:.3f} ms = {step_ips:.1f} images/s", flush=True)
    if failures:
        raise SystemExit("tf-mode resnet50 slice phase failed: "
                         + "; ".join(failures))
    return {"launches": node["launches"], "images_per_s": rates["rate"],
            "wall_images_per_s": rates["wall_rate"], "seconds": job_s,
            "no_ckpt_images_per_s": plain_rates["rate"],
            "feed_images_per_s": feed_ips, "step_images_per_s": step_ips,
            "args": args, "replay": replay, "replay_state": replay_state,
            "feed_ms_per_batch": SLICE_TRAIN_BATCH / feed_ips * 1e3}


def tf_wd_slice_phase(sc) -> dict:
    """Phase 12 (see the module docstring), on ``sc``."""
    import numpy as np
    import torch

    from tensorflowonspark_torch import dfutil, readers, sparkapi
    from tensorflowonspark_torch.examples import criteo_pipeline
    from tensorflowonspark_torch.models import widedeep

    rows = synth_criteo(WD_SLICE_ROWS, widedeep.Config().hash_buckets,
                        seed=9, zipf=WD_ZIPF)
    work = tempfile.mkdtemp(prefix="tfos_torch_pq_")
    try:
        args = tf_wd_args(work)
        df = sparkapi.LocalSparkSession(sc).createDataFrame(
            rows, ["dense", "cat", "label"]).repartition(WD_SLICE_PARTITIONS)
        t0 = time.perf_counter()
        dfutil.saveAsParquet(df, args.parquet_dir)
        save_s = time.perf_counter() - t0
        node, agg, job_s, timeline = run_tf_job(sc, tf_wd_train_fun, args,
                                                ("shard_files",))
        replay, seen = tf_wd_replay(args, "cuda")
        # the feed alone: the same reader and stager (casts, copies to the
        # card as trainer.shard makes them), no step
        feed = feed_alone(criteo_pipeline.parquet_batches(
            args, criteo_pipeline.parquet_shard(args, 0, 1),
            criteo_pipeline.stage_fn(types.SimpleNamespace(
                shard=readers._stager(True)))))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    feed_steps = (feed["batches"] - 1) / feed["seconds_after_first"]
    steps = WD_SLICE_ROWS // WD_BATCH
    want = {**dict.fromkeys(node["launches"] or {}, 0), "group": 1,
            "combine": 1}
    failures = slice_failures(node, replay, steps=steps, per_step=want,
                              tol=WD_SLICE_VS_REPLAY, final_only=False)
    # what the Parquet files gave back is the rows, in partition order,
    # with the stager's dtypes
    batch = rows_to_batch(rows)
    rows_ok = all(seen[k].dtype == batch[k].dtype
                  and np.array_equal(seen[k], batch[k]) for k in batch)
    if not rows_ok:
        failures.append("the Parquet batches are not the DataFrame's rows")
    rates = slice_rates(agg, WD_BATCH)
    print(f"tf-mode slice wide_deep combine: dfutil.saveAsParquet "
          f"{WD_SLICE_ROWS} rows in {node['shard_files']} files in "
          f"{save_s:.2f} s; TFCluster.run(InputMode.TENSORFLOW) -> "
          f"parquet_batches(prefetch=2, device_put=stage) -> Trainer.step on "
          f"{node['device']}: state {node['state']}, losses "
          f"{[round(v, 6) for v in node['losses'] or []]}; in-process replay "
          f"{[round(v, 6) for v in replay]}; max rel "
          f"{loss_rel(node['losses'], replay, False):.3e} (tol "
          f"{WD_SLICE_VS_REPLAY}); the batches are the rows: {rows_ok}; "
          f"executor table launches {node['launches']}; cluster.metrics() "
          f"steps/s={rates['rate']}; loop wall steps/s={rates['wall_rate']}; "
          f"job {job_s:.1f} s ({timeline}); "
          f"the feed alone (parquet_batches + stager, no "
          f"step) {feed['batches']} batches in {feed['seconds']:.3f} s, "
          f"{feed_steps:.1f} batches/s after its first", flush=True)
    if failures:
        raise SystemExit("tf-mode wide&deep slice phase failed: "
                         + "; ".join(failures))
    return {"launches": node["launches"], "steps_per_s": rates["rate"],
            "wall_steps_per_s": rates["wall_rate"], "seconds": job_s,
            "feed_steps_per_s": feed_steps}


# ---------------------------------------------------------------------------
# Persistence (phase 13): checkpoints, restart, the self-describing export
# ---------------------------------------------------------------------------

#: a script that writes the self-describing export of a weights export in
#: a CPU process (no card visible): argv is the repository, the weights'
#: export and the new export's directory
CPU_EXPORT_SCRIPT = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
from tensorflowonspark_torch import ckpt, compat, saved_model
from tensorflowonspark_torch.models import resnet
t0 = time.perf_counter()
state = ckpt.load_pytree(sys.argv[2] + "/model")
config = resnet.config_from_state(state)
compat.export_saved_model(
    state, sys.argv[3], forward_fn=saved_model.wrap_state_forward(
        resnet.serving_forward, resnet.make_serving_model(config)),
    example_batch={"image": np.zeros((2, config.image_size,
                                      config.image_size, 3), np.float32)},
    model_name="resnet50")
print(f"cpu export {time.perf_counter() - t0:.1f} s")
"""


def start_cpu_export(weights_export: str, out_dir: str):
    """Start :data:`CPU_EXPORT_SCRIPT` in a process that sees no card
    (``TFOS_TORCH_DEVICE=cpu``, ``CUDA_VISIBLE_DEVICES`` empty)."""
    env = {**os.environ, "TFOS_TORCH_DEVICE": "cpu",
           "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.Popen(
        [sys.executable, "-c", CPU_EXPORT_SCRIPT,
         os.path.dirname(os.path.abspath(__file__)), weights_export,
         out_dir], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def host_flat(flat: dict) -> dict:
    """``{key path: leaf}`` with every leaf a numpy array on the host."""
    import numpy as np
    import torch

    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in flat.items()}


def flat_state(tree) -> dict:
    """A train-state tree (``parallel.train.state_tree``) as ``{key path:
    numpy array}``, tensors copied to the host."""
    from tensorflowonspark_torch import ckpt

    return host_flat(ckpt._flatten(tree))


def state_rel(got: dict, want: dict) -> tuple:
    """``(key, rel)`` of the tensor of two flat states furthest apart, by
    max |got - want| / max |want| (inf where a key or shape is missing on
    one side, or ``want`` is all zero and ``got`` is not)."""
    import numpy as np

    worst = (None, 0.0)
    for k in sorted(set(got) | set(want)):
        if (k not in got or k not in want
                or np.shape(got[k]) != np.shape(want[k])):
            return k, float("inf")
        a = np.asarray(got[k], np.float64)
        b = np.asarray(want[k], np.float64)
        diff = float(np.abs(a - b).max()) if a.size else 0.0
        scale = float(np.abs(b).max()) if b.size else 0.0
        rel = (diff / scale if scale else
               0.0 if diff == 0 else float("inf"))
        if rel > worst[1]:
            worst = (k, rel)
    return worst


def restart_reader_s(args, skip: int) -> float:
    """Seconds from opening the example's reader for a restart at step
    ``skip`` (``train_batches(..., skip)``: the trained batches dropped
    as raw records) to its first batch on the card."""
    import argparse

    import torch

    from tensorflowonspark_torch import readers
    from tensorflowonspark_torch.examples import resnet_spark

    per_epoch = TF_RECORDS // args.batch_size
    longer = argparse.Namespace(**{**vars(args),
                                   "epochs": skip // per_epoch + 1})
    shard = readers.shard_files(os.path.join(args.data_dir, "part-*"), 0, 1)
    t0 = time.perf_counter()
    batches = resnet_spark.train_batches(longer, shard, 0, True, skip)
    next(batches)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    batches.close()
    return seconds


def state_diff(got: dict, want: dict) -> list:
    """The key paths where two flat states differ in a bit (or exist in
    only one)."""
    import numpy as np

    keys = set(got) | set(want)
    return sorted(k for k in keys if k not in got or k not in want
                  or got[k].dtype != want[k].dtype
                  or not np.array_equal(got[k], want[k]))


class _LiveSnapshot:
    """The planted fault of phase 13(b): a "snapshot" that keeps the live
    tensors and reads them when the writer runs, as a save without a
    snapshot would."""

    block = None  # nothing on the card to stage

    def take(self, flat):
        self.flat = dict(flat)
        return self

    def arrays(self, staging):
        return host_flat(self.flat)


def snapshot_run(trainer, batch, directory: str, planted: bool) -> dict:
    """Phase 13(b), once: 4 steps with no checkpoint on, then the trainer's
    cadence save fires at its second step (a device-side clone of the
    state taken at that moment), two more steps run at once while the
    writer's file write is held back, then 4 steps while it writes, then
    ``finish_checkpoints``.  Returns the key paths where the committed
    checkpoint differs from the clone, the checkpoint's bytes, the save
    call's host ms, the ms a step (synchronized walls) with no checkpoint,
    in the pair with the save (the check's own clone included), in the
    pair after it (the writer copies the snapshot to the host meanwhile)
    and while the file is written, the write's seconds, the seconds of
    ``Trainer.checkpoint`` (which reserves the buffers), and the clone
    (host arrays)."""
    import threading

    import torch

    from tensorflowonspark_torch import ckpt
    from tensorflowonspark_torch.parallel import train as train_lib

    gate, timing = threading.Event(), {}
    write = ckpt._write

    def held_write(flat, path):
        gate.wait(120)
        t0 = time.perf_counter()
        write(flat, path)
        timing["write_s"] = time.perf_counter() - t0

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):  # steps with no checkpoint on: the baseline
        trainer.step(batch)
    torch.cuda.synchronize()
    timing["step_plain_ms"] = (time.perf_counter() - t0) * 1e3 / 4
    snapshot_cls = ckpt._Snapshot
    if planted:  # before the manager reserves its snapshots
        ckpt._Snapshot = _LiveSnapshot
    try:
        t0 = time.perf_counter()
        mgr = trainer.checkpoint(directory, every_steps=2, async_save=True)
        timing["checkpoint_s"] = time.perf_counter() - t0
    finally:
        ckpt._Snapshot = snapshot_cls
    save, captured = mgr.save, {}

    def cloning_save(step, tree):
        captured["step"] = step
        captured["clone"] = {k: (v.detach().clone()
                                 if isinstance(v, torch.Tensor) else v)
                             for k, v in ckpt._flatten(tree).items()}
        t0 = time.perf_counter()
        save(step, tree)
        captured["save_ms"] = (time.perf_counter() - t0) * 1e3
        trainer._ckpt_every = 0  # one save a run

    mgr.save = cloning_save
    ckpt._write = held_write
    try:
        trainer._steps_done = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(batch)
        trainer.step(batch)  # the save fires here
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.step(batch)
        trainer.step(batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        gate.set()
        for _ in range(4):  # steps while the file is written
            trainer.step(batch)
        torch.cuda.synchronize()
        timing["step_during_write_ms"] = (time.perf_counter() - t2) * 1e3 / 4
        trainer.finish_checkpoints()
        if not planted:
            # a later save of the same manager: its buffers reused
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            save(captured["step"] + 1, train_lib.state_tree(trainer.state))
            timing["warm_save_ms"] = (time.perf_counter() - t3) * 1e3
            torch.cuda.synchronize()
            timing["warm_save_synced_ms"] = (time.perf_counter() - t3) * 1e3
            mgr.wait_until_finished()
    finally:
        gate.set()
        ckpt._write = write
    step = captured["step"]
    got = flat_state(mgr.restore(step))
    want = host_flat(captured["clone"])
    return {"diff": state_diff(got, want), "step": step, "clone": want,
            "leaves": len(want),
            "bytes": dir_bytes(os.path.join(directory, str(step))),
            "save_ms": captured["save_ms"],
            "step_with_save_ms": (t1 - t0) * 1e3 / 2,
            "step_after_ms": (t2 - t1) * 1e3 / 2,
            "step_plain_ms": timing["step_plain_ms"],
            "step_during_write_ms": timing["step_during_write_ms"],
            "write_s": timing.get("write_s"),
            "checkpoint_s": timing["checkpoint_s"],
            "warm_save_ms": timing.get("warm_save_ms"),
            "warm_save_synced_ms": timing.get("warm_save_synced_ms")}


def scores_in_process(model, images, sizes, batch: int):
    """``model``'s scores of ``images`` chunked as the executor chunks
    them: ``batch`` rows of each partition, padded to ``batch``."""
    import numpy as np
    import torch

    ref, start = [], 0
    with torch.inference_mode():
        for size in sizes:
            for lo in range(start, start + size, batch):
                n = min(batch, start + size - lo)
                chunk = np.zeros((batch, *images.shape[1:]), np.float32)
                chunk[:n] = images[lo:lo + n]
                ref.append(model(torch.from_numpy(chunk).cuda())[:n].cpu())
            start += size
    return torch.cat(ref)


def serve_export(sc, df, export_dir: str, batch: int, in_map: dict,
                 out_col: str, model_name: str | None = None) -> dict:
    """``TFModel`` with no ``predict_fn`` over ``df`` on the card (with no
    ``model_name``: the export's serialized forward): the scores, the
    seconds, the GroupNorm launches of the executor and of the driver
    (its schema sample), each counted from 0, and the executor's forwards
    that a graph replay ran alone (``replays``: each bucket's forward is
    eager at its first sighting, captured at its second)."""
    import torch

    from tensorflowonspark_torch import pipeline
    from tensorflowonspark_torch.kernels import group_norm

    tfmodel = (pipeline.TFModel(device="cuda").setExportDir(export_dir)
               .setBatchSize(batch).setBucketSizes([batch])
               .setInputMapping(in_map)
               .setOutputMapping({"prediction": out_col}))
    if model_name:
        tfmodel = tfmodel.setModelName(model_name)
    sc.parallelize([0], 1).mapPartitions(_reset_launches).collect()
    group_norm.reset_launches()
    t0 = time.perf_counter()
    out = tfmodel.transform(df).collect()
    seconds = time.perf_counter() - t0
    driver = dict(group_norm.launches_by_path)
    [(executor, _)] = sc.parallelize([0], 1).mapPartitions(
        _executor_state).collect()
    [replays] = sc.parallelize([0], 1).mapPartitions(
        _forward_replays).collect()
    return {"scores": torch.tensor([getattr(r, out_col) for r in out]),
            "rows": len(out), "seconds": seconds, "executor": executor,
            "driver": driver, "replays": replays}


def _time_loads(exports):
    """An executor job: the seconds of ``_RunModel._load`` (a cache miss:
    the weights read, the forward built or deserialized, the state placed
    on the card) for each ``(export_dir, model_name)``."""

    def load(_):
        import torch

        from tensorflowonspark_torch import pipeline

        out = []
        for export_dir, name in exports:
            run = pipeline._RunModel(export_dir, name, None, SLICE_BATCH,
                                     {"image": "image"}, None, ["image"],
                                     device="cuda")
            pipeline._MODEL_CACHE.pop(pipeline.model_cache_key(export_dir,
                                                               name), None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run._load()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return [out]

    return load


def export_timed(trainer, export_dir: str) -> dict:
    """``trainer.export`` with its seconds split into the trace
    (``torch.export.export``) and the rest (the weights' and the
    program's writes)."""
    import torch

    trace, export = [], torch.export.export

    def timed_export(*a, **k):
        t0 = time.perf_counter()
        try:
            return export(*a, **k)
        finally:
            trace.append(time.perf_counter() - t0)

    torch.export.export = timed_export
    try:
        t0 = time.perf_counter()
        trainer.export(export_dir)
        total = time.perf_counter() - t0
    finally:
        torch.export.export = export
    return {"seconds": total, "trace_s": sum(trace),
            "write_s": total - sum(trace)}


def op_host_us() -> dict:
    """Host µs a call of ``torch.ops.tfos.group_norm_act`` against
    ``group_norm_act`` at a small shape (the dispatcher's cost)."""
    import torch

    from tensorflowonspark_torch.kernels import group_norm

    xs, _, gamma, beta = draw_case((2, 64, 8, 8), False, 0, 1)
    return {"op_us": host_us(lambda: torch.ops.tfos.group_norm_act(
        xs[0], gamma, beta, 32, 1e-6, None, True)),
        "wrapper_us": host_us(lambda: group_norm.group_norm_act(
            xs[0], gamma, beta, 32, 1e-6))}


def persistence_phase(sc, work: str, tf_resnet: dict) -> dict:
    """Phase 13 (see the module docstring), on phase 11's application and
    work directory."""
    import numpy as np
    import torch

    from tensorflowonspark_torch import ckpt, sparkapi
    from tensorflowonspark_torch.kernels import sparse_adagrad
    from tensorflowonspark_torch.models import resnet, widedeep
    from tensorflowonspark_torch.parallel import train as train_lib
    from tensorflowonspark_torch.trainer import Trainer

    t_start = time.perf_counter()
    failures, launches = [], collections.Counter()
    args = tf_resnet["args"]
    export_a = args.model_dir
    cpu_export = os.path.join(work, "export_cpu")
    cpu_proc = start_cpu_export(export_a, cpu_export)

    # (a) the second job restores step 8 and takes 4 more steps
    steps = TF_RECORDS // args.batch_size
    args2 = tf_resnet_resume_args(args)
    node, agg, job_s, timeline = run_tf_job(sc, tf_resnet_map_fun, args2,
                                            ("restored_step",))
    want = launch_counts(one_pass=53, backward_one_pass=53)
    resumed = slice_failures(node, tf_resnet["replay"][steps:],
                             steps=RESUME_STEPS, per_step=want,
                             tol=RESUME_LOSS_REL, final_only=False)
    if node.get("restored_step") != steps:
        resumed.append(f"restored step {node.get('restored_step')} (want "
                       f"{steps})")
    ckpt_dir = args.ckpt_dir
    mgr = ckpt.CheckpointManager(ckpt_dir)
    # the resumed job's last checkpoint against the replay's state there:
    # params, AdamW moments and steps
    end = steps + RESUME_STEPS
    if end in mgr.all_steps():
        end_state = host_flat(ckpt._flatten(mgr.restore(end)))
        state_key, state_err = state_rel(end_state,
                                         tf_resnet["replay_state"])
        state_bits = not state_diff(end_state, tf_resnet["replay_state"])
        del end_state
    else:
        state_key, state_err, state_bits = None, float("inf"), False
    if not state_err <= RESUME_STATE_REL:
        resumed.append(f"step {end}'s state is {state_err:.3e} from the "
                       f"replay's at {state_key} (tol {RESUME_STATE_REL})")
    failures += [f"(a) {f}" for f in resumed]
    launches.update(node.get("launches") or {})
    rates = slice_rates(agg, 1)
    rel = loss_rel(node.get("losses"), tf_resnet["replay"][steps:], False)
    restart_s = restart_reader_s(args, RESTART_AT_STEP)
    print(f"persistence (a) resnet50 resumed: TFCluster.run(InputMode."
          f"TENSORFLOW) -> Trainer.checkpoint + restore_latest() = "
          f"{node.get('restored_step')} -> {RESUME_STEPS} steps on "
          f"{node.get('device')}: losses "
          f"{[round(v, 5) for v in node.get('losses') or []]}; the "
          f"uninterrupted replay's steps {steps + 1}-{end} "
          f"{[round(v, 5) for v in tf_resnet['replay'][steps:]]}; max rel "
          f"{rel:.3e} (tol {RESUME_LOSS_REL}); the job's step-{end} "
          f"checkpoint against the replay's state: max rel {state_err:.3e} "
          f"at {state_key} (tol {RESUME_STATE_REL}), the same bits "
          f"{state_bits}; executor launches {node.get('launches')}; "
          f"committed steps {mgr.all_steps()}, step {steps} "
          f"{dir_bytes(os.path.join(ckpt_dir, str(steps)))} bytes; "
          f"cluster.metrics() images/s={rates['rate']}; job {job_s:.1f} s "
          f"({timeline}); a restart at step {RESTART_AT_STEP}: the reader's "
          f"first batch after {restart_s:.3f} s "
          f"({restart_s / RESTART_AT_STEP * 1e3:.3f} ms a dropped batch; "
          f"read, parsed and staged as phase 11's feed "
          f"{tf_resnet['feed_ms_per_batch']:.3f} ms a batch)", flush=True)

    # (b) the asynchronous snapshot, and the planted fault it must catch
    t = Trainer("resnet50", config=resnet.Config(), learning_rate=TRAIN_LR,
                device="cuda")
    batch = t.shard(resnet.example_batch(resnet.Config(), SLICE_TRAIN_BATCH))
    t.step(batch)
    t.step(batch)
    good = snapshot_run(t, batch, os.path.join(work, "snap"), planted=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.restore(os.path.join(work, "snap", str(good["step"])))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    # the live trainer after the restore: params, AdamW moments, steps
    restored_diff = state_diff(flat_state(train_lib.state_tree(t.state)),
                               good.pop("clone"))
    planted = snapshot_run(t, batch, os.path.join(work, "snap_fault"),
                           planted=True)
    if good["diff"]:
        failures.append(f"(b) the checkpoint is not the snapshot at "
                        f"{good['diff'][:3]}")
    if restored_diff:
        failures.append(f"(b) the restored trainer is not the snapshot at "
                        f"{restored_diff[:3]}")
    if not planted["diff"]:
        failures.append("(b) the planted fault (the writer reading the live "
                        "tensors) went unseen")
    print(f"persistence (b) async snapshot, resnet50 batch "
          f"{SLICE_TRAIN_BATCH}: checkpoint step {good['step']}, "
          f"{good['leaves']} leaves, {good['bytes']} bytes; bit for bit the "
          f"device clone taken when the save fired: {not good['diff']}; "
          f"planted fault (writer reads the live tensors) caught: "
          f"{bool(planted['diff'])} ({len(planted['diff'])} leaves differ); "
          f"Trainer.checkpoint {good['checkpoint_s']:.3f} s (reserves the "
          f"clones' device buffers and the writer's pinned block); the "
          f"cadence save's call {good['save_ms']:.3f} ms on the host; a "
          f"later save of the same manager {good['warm_save_ms']:.3f} ms on"
          f" the host, "
          f"{good['warm_save_synced_ms']:.3f} ms to the clone's end; "
          f"ms a step (synchronized): with no checkpoint "
          f"{good['step_plain_ms']:.3f}, in the pair with the save (the "
          f"check's clone included) {good['step_with_save_ms']:.3f}, in "
          f"the pair after it (the writer's copy to the host meanwhile) "
          f"{good['step_after_ms']:.3f}, while the file is written "
          f"{good['step_during_write_ms']:.3f}; "
          f"background write {good['write_s']:.3f} s; restore "
          f"{restore_s:.3f} s, after it the trainer bit for bit the clone: "
          f"{not restored_diff}", flush=True)
    del t, batch

    # (c) wide&deep: restore into a trainer of another seed, 4 steps each
    rows = synth_criteo(WD_BATCH * 2 * WD_CKPT_STEPS,
                        widedeep.Config().hash_buckets, seed=13,
                        zipf=WD_ZIPF)
    batches = [rows_to_batch(rows[i * WD_BATCH:(i + 1) * WD_BATCH])
               for i in range(2 * WD_CKPT_STEPS)]
    wd = _wd_trainer("dense", seed=0)
    wd_dir = os.path.join(work, "wd_ckpt")
    wd.checkpoint(wd_dir, every_steps=WD_CKPT_STEPS, async_save=True)
    for b in batches[:WD_CKPT_STEPS]:
        wd.step(wd.shard(b))
    wd.finish_checkpoints()
    wd2 = _wd_trainer("dense", seed=1)
    wd2.checkpoint(wd_dir, every_steps=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = wd2.restore_latest()
    torch.cuda.synchronize()
    wd_restore_s = time.perf_counter() - t0
    sparse_adagrad.reset_launches()
    replays = replayed_steps()
    for b in batches[WD_CKPT_STEPS:]:
        wd2.step(wd2.shard(b))
    wd_launches = dict(sparse_adagrad.launches_by_path)
    counted = WD_CKPT_STEPS - (replayed_steps() - replays)
    launches.update(wd_launches)
    for b in batches[WD_CKPT_STEPS:]:
        wd.step(wd.shard(b))
    wd_diff = state_diff(flat_state(train_lib.state_tree(wd2.state)),
                         flat_state(train_lib.state_tree(wd.state)))
    want_wd = {**dict.fromkeys(wd_launches, 0), "group": counted,
               "combine": counted}
    if restored != WD_CKPT_STEPS:
        failures.append(f"(c) restored step {restored}")
    if wd_diff:
        failures.append(f"(c) the restored trainer differs at "
                        f"{wd_diff[:3]}")
    if wd_launches != want_wd:
        failures.append(f"(c) table launches {wd_launches} (want "
                        f"{want_wd})")
    wd_export = os.path.join(work, "wd_export")
    wd_export_t = export_timed(wd2, wd_export)
    print(f"persistence (c) wide_deep Config() batch {WD_BATCH} combine: "
          f"checkpoint step {WD_CKPT_STEPS} "
          f"{dir_bytes(os.path.join(wd_dir, str(WD_CKPT_STEPS)))} bytes, "
          f"restore_latest() = {restored} into a trainer of seed 1 in "
          f"{wd_restore_s:.3f} s; after {WD_CKPT_STEPS} more steps each, "
          f"tables, accumulators, MLP and AdamW state bit-identical: "
          f"{not wd_diff}; table launches after the restore {wd_launches}; "
          f"export {wd_export_t['seconds']:.2f} s (trace "
          f"{wd_export_t['trace_s']:.2f}, writes {wd_export_t['write_s']:.2f}"
          f"), model/ {dir_bytes(os.path.join(wd_export, 'model'))} bytes, "
          f"forward.pt2 {dir_bytes(os.path.join(wd_export, 'saved_forward'))}"
          f" bytes", flush=True)

    # (d) serving the serialized forwards on the card
    cpu_out, _ = cpu_proc.communicate(timeout=300)
    if cpu_proc.returncode != 0:
        failures.append(f"(d) the CPU export failed: {cpu_out[-2000:]}")
    state_a = ckpt.load_pytree(os.path.join(export_a, "model"))
    weights_only = os.path.join(work, "export_weights_only")
    from tensorflowonspark_torch import compat

    compat.export_saved_model(state_a, weights_only)
    model_a = resnet.load_state(resnet.make_model(resnet.Config()),
                                state_a).cuda().eval()
    images = np.random.RandomState(1).rand(
        SLICE_ROWS, 224, 224, 3).astype(np.float32)
    spark = sparkapi.LocalSparkSession(sc)
    df = spark.createDataFrame(
        [{"id": i, "image": images[i]} for i in range(SLICE_ROWS)]
    ).repartition(3)
    sizes = [len(p) for p in df.rdd._partitions]
    n_batches = sum(-(-n // SLICE_BATCH) for n in sizes)
    ref = scores_in_process(model_a, images, sizes, SLICE_BATCH)
    served = {}
    for label, export_dir in (("card", export_a), ("cpu", cpu_export)):
        if label == "cpu" and cpu_proc.returncode != 0:
            continue
        got = serve_export(sc, df, export_dir, SLICE_BATCH,
                           {"image": "image"}, "logits")
        got["err"] = (rel_err(got["scores"], ref)
                      if got["scores"].shape == ref.shape else float("inf"))
        got["bits"] = bool(torch.equal(got["scores"], ref))
        served[label] = got
        launches.update(got["executor"])
        launches.update(got["driver"])
        called = n_batches - got["replays"]
        if (got["rows"] != SLICE_ROWS or got["err"] > SLICE_VS_IN_PROCESS
                or got["executor"] != launch_counts(one_pass=53 * called)
                or got["replays"] < 1):
            failures.append(f"(d) the {label}-written export: rows "
                            f"{got['rows']}, rel {got['err']:.3e}, executor "
                            f"launches {got['executor']} (want "
                            f"{53 * called} one_pass: {n_batches} batches, "
                            f"{got['replays']} replayed)")
    [loads] = sc.parallelize([0], 1).mapPartitions(_time_loads(
        [(export_a, None), (weights_only, "resnet50")])).collect()
    for label, got in served.items():
        print(f"persistence (d) TFModel (no model_name, no predict_fn) "
              f"serves the {label}-written serialized forward of resnet50 on"
              f" cuda: {got['rows']} rows in partitions {sizes}, "
              f"{got['seconds']:.3f} s, {SLICE_ROWS / got['seconds']:.2f} "
              f"rows/s (first, with the loads); scores rel vs the weights in "
              f"process {got['err']:.3e} (tol {SLICE_VS_IN_PROCESS}), the "
              f"same bits {got['bits']}; executor launches "
              f"{got['executor']['one_pass']} one_pass for {n_batches} "
              f"batches, {got['replays']} of them graph replays (53 a "
              f"batch that calls the wrapper), driver "
              f"{got['driver']['one_pass']}", flush=True)
    if {"card", "cpu"} <= set(served):
        alike = bool(torch.equal(served["card"]["scores"],
                                 served["cpu"]["scores"]))
        program_bytes = dir_bytes(os.path.join(export_a, "saved_forward"))
        print(f"persistence (d) the two exports score alike bit for bit: "
              f"{alike}; saved_forward/ {program_bytes} bytes (card) / "
              f"{dir_bytes(os.path.join(cpu_export, 'saved_forward'))} (cpu), "
              f"model/ {dir_bytes(os.path.join(export_a, 'model'))} bytes; "
              f"executor model load: serialized {loads[0]:.3f} s, "
              f"weights-only {loads[1]:.3f} s", flush=True)
    del model_a

    # (d) wide&deep's export from (c), served the same way
    wd_rows = rows[:2 * WD_BATCH]
    wd_df = spark.createDataFrame(wd_rows, ["dense", "cat", "label"]
                                  ).repartition(2)
    wd_sizes = [len(p) for p in wd_df.rdd._partitions]
    wd_served = serve_export(sc, wd_df.select("dense", "cat"), wd_export,
                             WD_BATCH, {"dense": "dense", "cat": "cat"},
                             "ctr")
    start, want_ctr = 0, []
    for size in wd_sizes:
        part = wd_rows[start:start + size]
        want_ctr.append(wd2.predict({k: v for k, v in rows_to_batch(
            part).items() if k != "label"}).cpu())
        start += size
    want_ctr = torch.cat(want_ctr)
    wd_err = (float((wd_served["scores"] - want_ctr).abs().max())
              if wd_served["scores"].shape == want_ctr.shape
              else float("inf"))
    if wd_served["rows"] != len(wd_rows) or wd_err > WD_SCORES_VS_FORWARD:
        failures.append(f"(d) wide_deep: rows {wd_served['rows']}, max "
                        f"|diff| {wd_err:.3e}")
    print(f"persistence (d) TFModel serves the wide_deep serialized forward "
          f"on cuda: {wd_served['rows']} rows in {wd_sizes}, "
          f"{wd_served['seconds']:.3f} s; max |score - in-process forward| "
          f"{wd_err:.3e} (tol {WD_SCORES_VS_FORWARD})", flush=True)
    del wd, wd2

    # (e) a re-export to phase 11's path with new weights is served fresh
    fresh = Trainer("resnet50", config=resnet.Config(), seed=5,
                    learning_rate=TRAIN_LR, device="cuda")
    export_t = export_timed(fresh, export_a)
    ref_e = scores_in_process(fresh.model.eval(), images, sizes, SLICE_BATCH)
    again = serve_export(sc, df, export_a, SLICE_BATCH, {"image": "image"},
                         "logits")
    err_e = (rel_err(again["scores"], ref_e)
             if again["scores"].shape == ref_e.shape else float("inf"))
    err_old = (rel_err(again["scores"], ref)
               if again["scores"].shape == ref.shape else float("inf"))
    launches.update(again["executor"])
    launches.update(again["driver"])
    if err_e > SLICE_VS_IN_PROCESS or err_old <= SLICE_VS_IN_PROCESS:
        failures.append(f"(e) the re-export was not served fresh: rel "
                        f"{err_e:.3e} to the new weights, {err_old:.3e} to "
                        "the old")
    print(f"persistence (e) re-export to the same path (Trainer.export on "
          f"cuda, {export_t['seconds']:.2f} s: trace "
          f"{export_t['trace_s']:.2f}, writes {export_t['write_s']:.2f}): the "
          f"next transform's scores rel {err_e:.3e} to the new weights, "
          f"{err_old:.3e} to the old", flush=True)
    del fresh
    torch.cuda.empty_cache()
    host = op_host_us()
    seconds = time.perf_counter() - t_start
    print(f"persistence host µs a call at 2x64x8x8: torch.ops.tfos."
          f"group_norm_act {host['op_us']:.1f}, group_norm_act "
          f"{host['wrapper_us']:.1f}; phase 13 {seconds:.1f} s (budget "
          f"{PHASE13_BUDGET_S} s)", flush=True)
    if seconds > PHASE13_BUDGET_S:
        print(f"persistence: phase 13 took {seconds:.1f} s, past its "
              f"{PHASE13_BUDGET_S} s budget", flush=True)
    if failures:
        raise SystemExit("persistence phase failed: " + "; ".join(failures))
    return {"launches": dict(launches), "seconds": seconds,
            "op_host_us": host["op_us"],
            "wrapper_host_us": host["wrapper_us"]}


# ---------------------------------------------------------------------------
# The rest of the model zoo (phase 14): Inception-v3, MobileNet-v1, the
# CIFAR-10 CNN and the MNIST MLP
# ---------------------------------------------------------------------------

ZOO_BATCH = 64  # the kernel sites' batch: the TENSORFLOW-mode slices'
INCEPTION_GRAD_BATCH = 4
INCEPTION_STEP_BATCH = 128
INCEPTION_FWD_BATCH = 256
ZOO_SERVE_ROWS = 67  # Inception 299² rows served, 3 ragged partitions
MNIST_ROWS = 2048
MNIST_PARTITIONS = 4  # 512 rows each: 4 whole batches of 128
MNIST_BATCH = 128
MNIST_LOSS_VS_REPLAY = 1e-3  # rel, final loss: the same ops on one card
PHASE14_BUDGET_S = 120


def meta_sites(lib, config, size: int, **forward_kwargs) -> list:
    """``(C, H, W, groups)`` of every norm call of one forward of ``lib``'s
    model at ``size``², on the ``meta`` device (no FLOPs)."""
    import torch

    with torch.device("meta"):
        model = lib.make_model(config)
    sites = []

    def recorder(x, gamma, beta, groups, eps, residual=None, relu=True):
        sites.append((*x.shape[1:], groups))
        return torch.zeros_like(x)

    model.norm_act = recorder
    model(torch.zeros(1, size, size, 3, device="meta"), **forward_kwargs)
    return sites


def zoo_site_tables() -> dict:
    """Each zoo model's GroupNorm sites in a training step (a Counter of
    ``(C, H, W, groups)``): Inception-v3 canonical (96, the aux head's
    included) and its default SAME variant (94) at 299², MobileNet-v1 at
    224² (27), the CIFAR CNN at 32² (6)."""
    from tensorflowonspark_torch.models import cifar, inception, mobilenet

    return {name: collections.Counter(meta_sites(lib, config, size, **kw))
            for name, lib, config, size, kw in (
                ("inception_v3 canonical", inception,
                 inception.Config(canonical=True), 299, {"train": True}),
                ("inception_v3", inception, inception.Config(), 299,
                 {"train": True}),
                ("mobilenet_v1", mobilenet, mobilenet.Config(), 224, {}),
                ("cifar10_cnn", cifar, cifar.Config(), 32, {}))}


def step_launches(sites, steps: int = 1, backward: bool = True) -> dict:
    """The launches by path that ``steps`` training steps (forwards alone
    without ``backward``) over the norm ``sites`` make: each site on the
    path its plan takes."""
    from tensorflowonspark_torch.kernels import group_norm

    want = collections.Counter()
    for (c, h, w, groups), n in collections.Counter(sites).items():
        want[group_norm._plan(1, h, w, c, groups).path] += n * steps
        if backward:
            want["backward_" + group_norm._plan_backward(
                1, h, w, c, groups).path] += n * steps
    return launch_counts(**want)


def zoo_kernel_phase(tables: dict) -> dict:
    """Phase 14(a): both kernels at every distinct site of the zoo's
    models at batch ``ZOO_BATCH``, on the path each plan takes (the plan
    from the card's cluster capacity tables, printed first), against the
    plain twins (GN+ReLU, as every zoo norm calls it) and timed against
    ``bound_ms`` and the library call, a one pass over more than 8 blocks
    also against its forced two-pass or four-launch twin; totals a
    training step per model."""
    import torch

    from tensorflowonspark_torch.kernels import group_norm

    device = torch.cuda.current_device()
    capacity = {kind: group_norm._capacity(kind, device)
                for kind in ("forward", "backward")}
    print("zoo kernel sites: the card's cluster capacity (clusters of k "
          "blocks at once, one block an SM; k x clusters SMs busy): "
          + "; ".join(f"{kind} " + ", ".join(
              f"k={k}: {n} ({k * n})" for k, n in table)
              for kind, table in capacity.items()), flush=True)
    distinct = sorted(set().union(*tables.values()))
    fwd, bwd = {}, {}
    for i, (c, h, w, groups) in enumerate(distinct):
        shape = (ZOO_BATCH, c, h, w)
        fwd[(c, h, w, groups)] = measure_case(
            shape, groups, False, True, 300 + i,
            group_norm._plan(ZOO_BATCH, h, w, c, groups,
                             capacity["forward"]).path, 10, 0, 3)
        bwd[(c, h, w, groups)] = measure_backward_case(
            shape, groups, False, True, 300 + i,
            group_norm._plan_backward(ZOO_BATCH, h, w, c, groups,
                                      capacity["backward"]).path, 5, 0, 2)
    for name, sites in tables.items():
        tot = {}
        for kind, cases in (("forward", fwd), ("backward", bwd)):
            for key in ("ms", "bound_ms", "library_ms"):
                tot[f"{kind}_{key}"] = sum(n * cases[s][key]
                                           for s, n in sites.items())
        print(f"zoo kernel sites {name}: {sum(sites.values())} norms a "
              f"training step, {len(sites)} shapes, at batch {ZOO_BATCH}: "
              + " ".join(f"{k}={v:.4f}" for k, v in tot.items())
              + f" forward kernel/bound="
              f"{tot['forward_ms'] / tot['forward_bound_ms']:.2f} backward "
              f"kernel/bound={tot['backward_ms'] / tot['backward_bound_ms']:.2f}",
              flush=True)
    return {"forward": fwd, "backward": bwd}


def inception_model_phase(sites) -> dict:
    """Phase 14(b): Inception-v3 canonical at 299², full width, bf16, seeded
    weights.  One step's gradients on the kernel path against the plain
    path and an f32 plain model, and its launches; the backward alone
    against the plain backward under the kernel forward, with two planted
    faults that must read beyond its limit; 8 AdamW steps on one
    batch, kernel against plain; the train-step rate at batch 128 with its
    profile; the forward's rate at batch 256."""
    import dataclasses

    import numpy as np
    import torch

    from tensorflowonspark_torch.kernels import group_norm
    from tensorflowonspark_torch.models import inception
    from tensorflowonspark_torch.trainer import Trainer

    config = inception.Config(canonical=True)
    rng = np.random.RandomState(14)

    def device_batch(n):
        return {"image": torch.from_numpy(rng.rand(
                    n, 299, 299, 3).astype(np.float32)).cuda(),
                "label": torch.from_numpy(rng.randint(
                    0, 1000, size=n)).cuda()}

    failures = []
    model = inception.make_model(config, seed=0).cuda()
    f32_model = inception.load_state(
        inception.make_model(dataclasses.replace(config, dtype="float32")),
        inception.state_of(model)).cuda()
    batch = device_batch(INCEPTION_GRAD_BATCH)
    loss_fn = inception.make_loss_fn(model, config)
    g_kernel, loss_kernel, launches = _grads(model, loss_fn, batch,
                                             group_norm.group_norm_act)
    g_plain, loss_plain, plain_launches = _grads(
        model, loss_fn, batch, group_norm.group_norm_act_plain)
    g_f32, loss_f32, _ = _grads(f32_model, loss_fn, batch,
                                group_norm.group_norm_act_plain)
    # the backward alone, as phase 6 holds ResNet's: the kernel forward
    # under the plain backward, and under the kernel backward with a fault
    # planted.  The loose gate below reads above 1 (an all-zero gradient's
    # distance) at this depth; this one holds the backward
    g_same, _, same_launches = _grads(
        model, loss_fn, batch, group_norm.group_norm_act,
        group_norm.group_norm_act_backward_plain)
    g_faults = {drop: _grads(model, loss_fn, batch, group_norm.group_norm_act,
                             _planted_fault(drop))[0]
                for drop in ("projection", "centering")}
    names = [k for k, _ in model.named_parameters()]
    del model, f32_model
    finite = all(bool(torch.isfinite(g).all()) for g in g_kernel.values())
    nonzero = [k for k, g in g_kernel.items() if float(g.abs().max()) > 0]
    vs_plain, vs_f32 = _rel_l2(g_kernel, g_plain), _rel_l2(g_kernel, g_f32)
    plain_vs_f32 = _rel_l2(g_plain, g_f32)
    tol = GRADS_VS_F32_OVER_PLAIN * plain_vs_f32 + 0.02
    same_forward = _rel_l2(g_kernel, g_same)
    faults = {drop: _rel_l2(g, g_same) for drop, g in g_faults.items()}
    want = step_launches(sites)
    print(f"zoo inception_v3 canonical 299x299 bf16 one step at batch "
          f"{INCEPTION_GRAD_BATCH}: loss (CE + 0.4 aux CE) kernel="
          f"{loss_kernel:.5f} plain={loss_plain:.5f} f32={loss_f32:.5f}; "
          f"grads of {len(g_kernel)}/{len(names)} params, finite={finite}, "
          f"nonzero={len(nonzero)}; rel_l2 kernel-vs-plain={vs_plain:.3e} "
          f"kernel-vs-f32={vs_f32:.3e} plain-vs-f32={plain_vs_f32:.3e} (tol:"
          f" both <= {tol:.3e}); launches a step={launches} (want {want}; "
          f"plain path {plain_launches})", flush=True)
    print(f"zoo inception_v3 canonical backward alone: rel_l2 "
          f"kernel-bwd-vs-plain-bwd (kernel forward both)={same_forward:.3e} "
          f"(tol {GRADS_SAME_FORWARD}); launches {same_launches}; planted "
          f"faults " + "; ".join(
              f"{drop} term dropped: vs plain-bwd={a:.3e} "
              f"({'caught' if a > GRADS_SAME_FORWARD else 'MISSED'})"
              for drop, a in faults.items()), flush=True)
    del g_kernel, g_plain, g_f32, g_same, g_faults
    if (sorted(nonzero) != sorted(names) or not finite
            or max(vs_plain, vs_f32) > tol or launches != want
            or sum(plain_launches.values())):
        failures.append("(b) gradients")
    if (same_forward > GRADS_SAME_FORWARD
            or same_launches != step_launches(sites, backward=False)
            or min(faults.values()) <= GRADS_SAME_FORWARD):
        failures.append(f"(b) the backward alone: {same_forward:.3e}, "
                        f"launches {same_launches}, planted faults {faults}")

    batch = device_batch(INCEPTION_GRAD_BATCH)
    traj = {}
    for name, norm_act in (("kernel", group_norm.group_norm_act),
                           ("plain", group_norm.group_norm_act_plain)):
        t = Trainer("inception_v3", config=config, learning_rate=TRAIN_LR,
                    seed=0, device="cuda")
        t.model.norm_act = norm_act
        traj[name] = [float(t.step(batch)) for _ in range(TRAIN_STEPS)]
        del t
    gap = max(abs(a - b) for a, b in zip(traj["kernel"], traj["plain"]))
    fall = traj["kernel"][-1] / traj["kernel"][0]
    print(f"zoo inception_v3 canonical {TRAIN_STEPS} AdamW steps (lr "
          f"{TRAIN_LR}) on one batch: kernel losses "
          f"{[round(v, 5) for v in traj['kernel']]}; plain "
          f"{[round(v, 5) for v in traj['plain']]}; max gap {gap:.3e} (tol "
          f"{TRAJECTORY_TOL} x {traj['plain'][0]:.4f}); last/first "
          f"{fall:.3f} (must fall)", flush=True)
    if gap > TRAJECTORY_TOL * traj["plain"][0] or not fall < 1:
        failures.append("(b) trajectory")

    torch.cuda.empty_cache()
    t = Trainer("inception_v3", config=config, learning_rate=TRAIN_LR,
                seed=0, device="cuda")
    batch = device_batch(INCEPTION_STEP_BATCH)
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: t.step(batch), 10)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ips = INCEPTION_STEP_BATCH / step_ms * 1e3
    print(f"zoo inception_v3 canonical train step batch "
          f"{INCEPTION_STEP_BATCH}: {step_ms:.3f} ms, {step_ips:.1f} "
          f"images/s, peak memory {peak_gb:.2f} GB", flush=True)
    step_profile = profile_train_step(t, batch, step_ms,
                                      label="inception_v3 canonical")
    model = t.model.eval()
    del t, batch
    torch.cuda.empty_cache()
    images = torch.rand(INCEPTION_FWD_BATCH, 299, 299, 3, device="cuda")
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(images), 10)
    fwd_ips = INCEPTION_FWD_BATCH / fwd_ms * 1e3
    print(f"zoo inception_v3 canonical forward batch {INCEPTION_FWD_BATCH}: "
          f"{fwd_ms:.3f} ms, {fwd_ips:.1f} images/s", flush=True)
    fwd_profile = profile_forward(model, images, fwd_ms,
                                  label="inception_v3 canonical")
    del model, images
    torch.cuda.empty_cache()
    return {"failures": failures, "step_images_per_s": step_ips,
            "forward_images_per_s": fwd_ips,
            "step_idle_share": step_profile.get("idle_share"),
            "forward_idle_share": fwd_profile.get("idle_share")}


def zoo_tf_slice(sc, work: str, arch: str, side: int, sites,
                 model_dir: str | None = None) -> dict:
    """Phase 14(c)/(d): ``examples/resnet_spark.py --arch <arch>`` (the
    default ``Config()``) on one executor from ``ZOO_TF_RECORDS`` synthetic
    ``side``² TFRecords at batch 64, one reader: the executor on the card,
    the launches of its steps, the final loss against an in-process
    replay, images/s."""
    from tensorflowonspark_torch import models as model_zoo
    from tensorflowonspark_torch.examples import resnet_spark
    from tensorflowonspark_torch.models import resnet

    config = model_zoo.get_model(arch).Config()
    data_dir = os.path.join(work, f"{arch}_records")
    t0 = time.perf_counter()
    files = resnet.write_synthetic_tfrecords(
        data_dir, ZOO_TF_RECORDS, TF_PARTS, side, seed=4,
        num_classes=config.num_classes)
    write_s = time.perf_counter() - t0
    args = resnet_spark.parse_args(
        ["--arch", arch, "--batch_size", str(SLICE_TRAIN_BATCH),
         "--readers", "1", "--shuffle_buffer", str(TF_SHUFFLE), "--lr",
         str(TRAIN_LR), "--epochs", "1", "--data_dir", data_dir]
        + (["--model_dir", model_dir] if model_dir else []))
    args.ckpt_every_steps = 0
    node, agg, job_s, timeline = run_tf_job(sc, tf_resnet_map_fun, args)
    replay = tf_resnet_replay(args, "cuda")
    steps = ZOO_TF_RECORDS // SLICE_TRAIN_BATCH
    failures = slice_failures(node, replay, steps=steps,
                              per_step=step_launches(sites),
                              tol=SLICE_TRAIN_VS_IN_PROCESS, final_only=True)
    rates = slice_rates(agg, 1)
    mb = sum(os.path.getsize(f) for f in files) / 1e6
    print(f"zoo tf-mode slice resnet_spark --arch {arch}: {ZOO_TF_RECORDS} "
          f"records {side}² ({mb:.1f} MB) written in {write_s:.2f} s; "
          f"Trainer.step on {node['device']}: state {node['state']}, losses "
          f"{[round(v, 5) for v in node['losses'] or []]}; in-process replay "
          f"{[round(v, 5) for v in replay]}; final loss rel "
          f"{loss_rel(node['losses'], replay, True):.3e} (tol "
          f"{SLICE_TRAIN_VS_IN_PROCESS}); executor launches "
          f"{node['launches']}; cluster.metrics() images/s={rates['rate']}; "
          f"loop wall images/s={rates['wall_rate']}; job {job_s:.1f} s "
          f"({timeline})", flush=True)
    return {"failures": [f"({arch} slice) {f}" for f in failures],
            "launches": node["launches"] or {}, "images_per_s": rates["rate"]}


def zoo_serving(sc, export_dir: str, sites) -> dict:
    """Phase 14(e): ``TFModel.transform`` of the Inception export of (c):
    its serialized forward (``torch.ops.tfos.group_norm_act`` at every
    norm), and the same weights exported weights-only, served by name."""
    import numpy as np
    import torch

    from tensorflowonspark_torch import ckpt, compat, sparkapi
    from tensorflowonspark_torch.models import inception

    state = ckpt.load_pytree(os.path.join(export_dir, "model"))
    weights_only = export_dir + "_weights_only"
    compat.export_saved_model(state, weights_only)
    model = inception.load_state(inception.make_model(
        inception.config_from_state(state)), state).cuda().eval()
    images = np.random.RandomState(6).rand(
        ZOO_SERVE_ROWS, 299, 299, 3).astype(np.float32)
    df = sparkapi.LocalSparkSession(sc).createDataFrame(
        [{"id": i, "image": images[i]} for i in range(ZOO_SERVE_ROWS)]
    ).repartition(3)
    sizes = [len(p) for p in df.rdd._partitions]
    n_batches = sum(-(-n // SLICE_BATCH) for n in sizes)
    ref = scores_in_process(model, images, sizes, SLICE_BATCH)
    del model
    failures, launches, out = [], collections.Counter(), {}
    for label, name, d in (("serialized", None, export_dir),
                           ("by name", "inception_v3", weights_only)):
        got = serve_export(sc, df, d, SLICE_BATCH, {"image": "image"},
                           "logits", model_name=name)
        # a graph replay calls no wrapper
        want = step_launches(sites, n_batches - got["replays"],
                             backward=False)
        err = (rel_err(got["scores"], ref)
               if got["scores"].shape == ref.shape else float("inf"))
        bits = bool(torch.equal(got["scores"], ref))
        launches.update(got["executor"])
        out[label] = got["rows"] / got["seconds"]
        print(f"zoo serving inception_v3 ({label}) on cuda: {got['rows']} "
              f"rows in {sizes}, {got['seconds']:.3f} s, "
              f"{out[label]:.2f} rows/s (first, with the load); scores rel "
              f"vs the eager forward in process {err:.3e} (tol "
              f"{SLICE_VS_IN_PROCESS}), the same bits {bits}; executor "
              f"launches {got['executor']} for {n_batches} batches, "
              f"{got['replays']} of them graph replays (want {want})",
              flush=True)
        if (got["rows"] != ZOO_SERVE_ROWS or err > SLICE_VS_IN_PROCESS
                or got["executor"] != want or got["replays"] < 1
                or (name is None and not bits)):
            failures.append(f"(e) {label}: rows {got['rows']}, rel "
                            f"{err:.3e}, bits {bits}, launches "
                            f"{got['executor']}")
    return {"failures": failures, "launches": dict(launches),
            "rows_per_s": out}


def zoo_mnist(sc, work: str) -> dict:
    """Phase 14(f): ``examples/mnist_spark.py``'s ``map_fun`` on one
    executor in ``InputMode.SPARK`` over ``MNIST_ROWS`` synthetic rows,
    then ``TFModel.transform`` of its self-describing export: the same
    bits as ``serve()`` here on the executor's batches."""
    import torch

    from tensorflowonspark_torch import TFCluster, ckpt, sparkapi
    from tensorflowonspark_torch.examples import mnist_spark

    export = os.path.join(work, "mnist_export")
    x, y = mnist_spark.synth_mnist(MNIST_ROWS)
    args = mnist_spark.parse_args(["--batch_size", str(MNIST_BATCH),
                                   "--epochs", "1", "--model_dir", export])
    t0 = time.perf_counter()
    cluster = TFCluster.run(
        sc, functools.partial(run_counted, mnist_spark.map_fun), args,
        num_executors=1, input_mode=TFCluster.InputMode.SPARK,
        master_node="chief")
    cluster.train(sc.parallelize([(x[i], int(y[i])) for i in range(
        MNIST_ROWS)], MNIST_PARTITIONS), num_epochs=1, feed_timeout=600)
    cluster.shutdown(grace_secs=120)
    job_s = time.perf_counter() - t0
    [node] = node_published(cluster, ("state", "final_loss",
                                      "examples_seen", "device", "launches",
                                      "table_launches"))
    # the same batches in partition order, in this process
    params = {k: torch.tensor(v, device="cuda", requires_grad=True)
              for k, v in mnist_spark.init_params(args.hidden, 0).items()}
    mom = {k: torch.zeros_like(v) for k, v in params.items()}
    for lo in range(0, MNIST_ROWS, MNIST_BATCH):
        loss = mnist_spark.train_batch(params, mom, {
            "image": torch.from_numpy(x[lo:lo + MNIST_BATCH]).cuda(),
            "label": torch.from_numpy(y[lo:lo + MNIST_BATCH]).cuda()},
            MNIST_BATCH, args.lr)
    replay = float(loss)
    final = node["final_loss"]
    rel = abs(final - replay) / replay if final is not None else float("inf")
    rows = 1000
    df = sparkapi.LocalSparkSession(sc).createDataFrame(
        [{"image": x[i]} for i in range(rows)]).repartition(3)
    served = serve_export(sc, df, export, MNIST_BATCH, {"image": "image"},
                          "logits")
    state = {k: torch.from_numpy(v).cuda() for k, v in ckpt.load_pytree(
        os.path.join(export, "model")).items()}
    # chunked and padded as the executor batches: the program's GEMMs then
    # have this process's shapes, and give its bits
    want = scores_in_process(
        lambda images: mnist_spark.serve(state, {"image": images}),
        x[:rows], [len(p) for p in df.rdd._partitions], MNIST_BATCH)
    err, max_abs = ((rel_err(served["scores"], want),
                     float((served["scores"] - want).abs().max()))
                    if served["scores"].shape == want.shape
                    else (float("inf"), float("inf")))
    bits = bool(torch.equal(served["scores"], want))
    print(f"zoo mnist_spark (InputMode.SPARK, one executor) on "
          f"{node['device']}: state {node['state']}, {node['examples_seen']} "
          f"rows seen, final loss {final} (in-process replay {replay:.6f}, "
          f"rel {rel:.3e}, tol {MNIST_LOSS_VS_REPLAY}); job {job_s:.1f} s; "
          f"TFModel.transform of its self-describing export: "
          f"{served['rows']} rows in {served['seconds']:.3f} s, scores rel "
          f"vs serve() in process {err:.3e}, max |diff| {max_abs:.3e}, the "
          f"same bits {bits}; GroupNorm launches: trainer "
          f"{node['launches']}, serving executor {served['executor']}",
          flush=True)
    failures = []
    if (node["state"] != "finished" or not str(node["device"]).startswith(
            "cuda") or node["examples_seen"] != MNIST_ROWS
            or not rel <= MNIST_LOSS_VS_REPLAY
            or not replay < math.log(10) or served["rows"] != rows
            or not bits):
        failures.append(f"(f) mnist: node {node}, loss rel {rel}, served "
                        f"{served['rows']} rows, scores rel {err}, the same "
                        f"bits {bits}")
    launches = collections.Counter(node["launches"] or {})
    launches.update(served["executor"])
    # SPARK mode trains in a process the executor spawns: its table
    # launches are its own
    return {"failures": failures, "launches": dict(launches),
            "trainer_table_launches": node["table_launches"] or {}}


def zoo_cifar(sc, work: str, sites) -> dict:
    """Phase 14(g): ``examples/cifar10_spark.py`` with its defaults (full
    CNN at 32², batch 64, 2 epochs of 2,048 records, 2 reader threads) on
    one executor."""
    from tensorflowonspark_torch import sparkapi
    from tensorflowonspark_torch.examples import cifar10_spark

    args = cifar10_spark.parse_args(
        ["--cluster_size", "1", "--data_dir", os.path.join(work, "cifar")])
    t0 = time.perf_counter()
    cifar10_spark.prep_tfrecords(sparkapi.LocalSparkSession(sc),
                                 args.data_dir, args.num_samples, 2, 32)
    write_s = time.perf_counter() - t0
    node, agg, job_s, timeline = run_tf_job(
        sc, functools.partial(run_counted, cifar10_spark.map_fun), args)
    losses = node["losses"] or []
    steps = args.num_samples // args.batch_size * args.epochs
    k = 8
    falls = (len(losses) >= 2 * k
             and sum(losses[-k:]) < sum(losses[:k]))
    # the wrappers count the steps a graph replay did not run alone
    want = step_launches(sites, steps - (node["replays"] or 0))
    rates = slice_rates(agg, 1)
    print(f"zoo cifar10_spark defaults ({args.readers} readers, batch "
          f"{args.batch_size}, {args.epochs} epochs of {args.num_samples} "
          f"records written in {write_s:.2f} s) on {node['device']}: state "
          f"{node['state']}, {len(losses)} steps = "
          f"{len(losses) * args.batch_size} rows trained (records x epochs "
          f"{args.num_samples * args.epochs}); mean loss of the first {k} "
          f"{sum(losses[:k]) / k if losses else float('nan'):.4f}, of the "
          f"last {k} {sum(losses[-k:]) / k if losses else float('nan'):.4f}"
          f"; executor launches {node['launches']} (want {want}); "
          f"cluster.metrics() images/s={rates['rate']}; job {job_s:.1f} s "
          f"({timeline})", flush=True)
    failures = []
    if (node["state"] != "finished" or len(losses) != steps
            or not str(node["device"]).startswith("cuda")
            or not all(math.isfinite(v) for v in losses) or not falls
            or node["launches"] != want):
        failures.append(f"(g) cifar: state {node['state']}, {len(losses)} "
                        f"steps (want {steps}), falls {falls}, launches "
                        f"{node['launches']}")
    return {"failures": failures, "launches": node["launches"] or {},
            "images_per_s": rates["rate"]}


def zoo_phase(sc, work: str) -> dict:
    """Phase 14 (see the module docstring), in phase 11's application
    (its executor carries over) under ``work``: every sub-phase runs; the
    failures are gathered and fail the run at the end."""
    import torch

    from tensorflowonspark_torch.kernels import sparse_adagrad

    t0 = time.perf_counter()
    # the table kernels' launches in every process of the phase, from 0
    sparse_adagrad.reset_launches()
    sc.parallelize([0], 1).mapPartitions(_reset_table_launches).collect()
    tables = zoo_site_tables()
    kern = zoo_kernel_phase(tables)
    t_kern = time.perf_counter()
    model = inception_model_phase(tables["inception_v3 canonical"])
    t_model = time.perf_counter()
    failures = list(model["failures"])
    launches = collections.Counter()
    work = os.path.join(work, "zoo")
    os.makedirs(work)
    seconds, parts = {}, []
    t = time.perf_counter()
    export = os.path.join(work, "inception_export")
    parts.append(("c", zoo_tf_slice(sc, work, "inception_v3", 299,
                                    tables["inception_v3"], export)))
    parts.append(("d", zoo_tf_slice(sc, work, "mobilenet_v1", 224,
                                    tables["mobilenet_v1"])))
    parts.append(("e", zoo_serving(sc, export, tables["inception_v3"])))
    seconds["c-e"] = time.perf_counter() - t
    t = time.perf_counter()
    parts.append(("f", zoo_mnist(sc, work)))
    seconds["f"] = time.perf_counter() - t
    t = time.perf_counter()
    parts.append(("g", zoo_cifar(sc, work, tables["cifar10_cnn"])))
    seconds["g"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    results = dict(parts)
    for _, part in parts:
        failures += part["failures"]
        launches.update(part.get("launches", {}))
    [executor] = sc.parallelize([0], 1).mapPartitions(
        _table_launches).collect()
    table_launches = {k: v + executor[k] + results["f"][
        "trainer_table_launches"].get(k, 0)
        for k, v in sparse_adagrad.launches_by_path.items()}
    print(f"zoo table kernel launches (driver, executor and the SPARK-mode "
          f"trainer; no zoo model reaches them): {table_launches}",
          flush=True)
    if any(table_launches.values()):
        failures.append(f"table kernels launched {table_launches}")
    total = time.perf_counter() - t0
    print(f"zoo rates (images/s): inception_v3 canonical Trainer.step batch "
          f"{INCEPTION_STEP_BATCH} {model['step_images_per_s']:.1f} (idle "
          f"share {model['step_idle_share']}), forward batch "
          f"{INCEPTION_FWD_BATCH} {model['forward_images_per_s']:.1f} (idle "
          f"share {model['forward_idle_share']}); "
          f"TENSORFLOW-mode slices at batch {SLICE_TRAIN_BATCH}: "
          f"inception_v3 {results['c']['images_per_s']}, mobilenet_v1 "
          f"{results['d']['images_per_s']}, cifar10_cnn "
          f"{results['g']['images_per_s']}; served inception_v3 rows/s "
          f"{results['e']['rows_per_s']}", flush=True)
    print(f"zoo phase 14 seconds: kernel sites {t_kern - t0:.1f}, inception "
          f"model {t_model - t_kern:.1f}, slices and serving "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"; phase 14 {total:.1f} (budget {PHASE14_BUDGET_S})", flush=True)
    if failures:
        raise SystemExit("zoo phase 14 failed: " + "; ".join(failures))
    return {"kernels": kern, "launches": dict(launches),
            "table_launches": table_launches}


def phase14_entry(kern: dict, path: str) -> dict:
    """A GroupNorm kernel's phase 14(a) numbers on ``path``: the largest
    error over the zoo's sites that took it, the sum over those sites (one
    call each, batch ``ZOO_BATCH``) of its ms, bound and library ms, and
    each site's that ran over more than 8 blocks (with its cluster and its
    forced twin's ms) or off the one pass."""
    from tensorflowonspark_torch.kernels import group_norm

    cases = kern["backward" if path.startswith("backward_") else "forward"]
    mine = {f"{ZOO_BATCH}x{h}x{w}x{c}/G{groups}": case
            for (c, h, w, groups), case in cases.items()
            if case["path"] == path}
    if not mine:
        return {}
    out = {"phase14_sites": len(mine),
           "phase14_max_abs_err": max(c["max_abs_err"] for c in mine.values())}
    for key in ("ms", "bound_ms", "library_ms"):
        out[f"phase14_{key}"] = sum(c[key] for c in mine.values())
    by_site = {
        site: {k: c[k] for k in ("ms", "bound_ms", "library_ms",
                                 "max_abs_err", "cluster", "two_pass_ms",
                                 "four_launch_ms") if k in c}
        for site, c in mine.items()
        if c["cluster"] > group_norm._CLUSTER_MAX or not c["cluster"]}
    if by_site:
        out["phase14_by_site"] = by_site
    return out


# ---------------------------------------------------------------------------
# BERT-base SQuAD fine-tuning (phase 15)
# ---------------------------------------------------------------------------

# the BERT paper's SQuAD v1.1 recipe: max_seq_length 384, batch 32, lr 5e-5
BERT_SEQ = 384
BERT_STEP_BATCH = 32
BERT_LR = 5e-5
BERT_GRAD_BATCH = 4
BERT_TRAJ_BATCH = 8
BERT_FWD_BATCH = 64
BERT_STEPS = 8
BERT_SLICE_ROWS = 256
BERT_SLICE_PARTITIONS = 4
BERT_SERVE_ROWS = 67  # an odd tail; one row all padding
BF16_DENSE_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
# one step's gradients, rel L2: the card's path (SDPA) against f32 and
# against the plain path run on the card, each no further than this x the
# plain path's distance from f32 + BERT_GRADS_SLACK, over all leaves and
# leaf by leaf.  Measured on the CPU (BERT-base widths cut to 6 layers,
# batch 4 x 128; the CPU's SDPA): plain-vs-f32 9.3e-3, SDPA-vs-f32 9.3e-3,
# a dropped mask 0.12; the largest leaf 5.8e-2.  Leaves whose true
# gradient is 0 (BERT_ZERO_GRAD_LEAVES) are left out of the per-leaf gate
BERT_GRADS_OVER_PLAIN = 1.25
BERT_GRADS_SLACK = 5e-3
BERT_GRADS_BF16_VS_F32 = 0.1  # rel L2 over all leaves, the card's path
# 8 AdamW steps on one batch: |bf16 - f32| <= this x the first f32 loss at
# every step (CPU, 6 layers, batch 8 x 128: 3.6e-3 of 4.60), and the last
# loss below half the first
BERT_TRAJ_TOL = 5e-3
# the slice's losses against the in-process replay: the first (the same
# weights and batch, before any update) bit for bit, every one within this
# rel.  cuDNN's SDPA backward accumulates dQ with atomics, and AdamW's
# first steps move every weight by about lr whatever its gradient's size,
# so the loss spreads: rel 3.4e-4 and 4.8e-4 at the worst step in the
# first two runs on the card (its batches' losses differ by 1e-3 to 2e-2)
BERT_SLICE_VS_REPLAY = 3e-3
PHASE15_BUDGET_S = 120


def bert_zero_grad_leaves(config) -> tuple:
    """Parameters whose true gradient is 0 in the SQuAD loss: the span
    head's bias and the last LayerNorm's (the start and end softmax
    gradients sum to 0 over the positions)."""
    return ("span.bias", f"layers.{config.layers - 1}.ln_mlp.bias")


def bert_flops(config, batch: int, seq: int, train: bool) -> float:
    """Model FLOPs of one forward (``train=False``) or training step (3×
    the forward; remat's recompute not counted): 2 × the dense weights
    (qkv, out, MLP, the span head) a token, and 4 × S × H a token and
    layer for the scores and PV."""
    h, m, layers = config.hidden, config.mlp_dim, config.layers
    dense = layers * (4 * h * h + 2 * h * m) + 2 * h
    tokens = batch * seq
    forward = 2 * dense * tokens + 4 * layers * seq * h * tokens
    return 3 * forward if train else forward


def bert_batch(rows) -> dict:
    """``synth_squad`` rows as the example's int32 batch."""
    import numpy as np

    from tensorflowonspark_torch.examples import bert_squad

    cols = list(zip(*rows))
    return {c: np.asarray(cols[i], np.int32)
            for i, c in enumerate(bert_squad.COLUMNS)}


def bert_device_batch(config, n: int, seed: int, device="cuda") -> dict:
    """``n`` ``synth_squad`` rows at ``config``'s vocabulary and
    ``BERT_SEQ`` (lengths 192-384: padding tails), as tensors on
    ``device``."""
    import torch

    from tensorflowonspark_torch.examples import bert_squad

    rows = bert_squad.synth_squad(n, config.vocab_size, BERT_SEQ, seed=seed)
    return {k: torch.from_numpy(v).to(device)
            for k, v in bert_batch(rows).items()}


def bert_family(kernel: str) -> str:
    """The training step's family of a kernel, by its name."""
    name = kernel.lower()
    if any(k in name for k in ("fmha", "flash", "sdpa", "attention",
                               "cudnn")) or (
            "softmax" in name and "logsoftmax" not in name):
        return "attention"
    if any(k in name for k in ("layer_norm", "layernorm", "gammabeta",
                               "cudafunctor_add", "copy_kernel")):
        return "layernorm+add+cast"
    if "gelu" in name:
        return "gelu"
    if any(k in name for k in ("gemm", "nvjet", "xmma", "cutlass",
                               "splitk")):
        return "gemm"
    if any(k in name for k in ("indexselect", "index_select", "embedding",
                               "radixsort", "krn_partial",
                               "compute_grad_weight", "sum_and_scatter")):
        return "embedding"
    if any(k in name for k in ("adam", "multi_tensor", "foreach")):
        return "adamw"
    return "other"


def norm_part(kernel: str) -> str:
    """Which part of the ``layernorm+add+cast`` family a kernel is."""
    name = kernel.lower()
    if "copy_kernel" in name:
        return "cast"
    return "add" if "cudafunctor_add" in name else "layernorm"


def sdpa_backend(kernels) -> str:
    """Which SDPA backend the kernel names show."""
    names = " ".join(k.lower() for k in kernels)
    for key, backend in (("fmha_cutlass", "memory-efficient"),
                         ("cudnn", "cudnn"), ("flash", "flash")):
        if key in names:
            return backend
    return "math" if "softmax" in names else "none"


def bert_profile(fn, calls: int, wall_ms: float, label: str) -> dict:
    """Device time per call of ``fn`` by :func:`bert_family`
    (torch.profiler, CUPTI), the idle share against ``wall_ms`` and the
    SDPA backend."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    fams, others, parts = (collections.Counter(), collections.Counter(),
                           collections.Counter())
    seen = set()
    for kernel, ms in device_kernels(prof, calls):
        fam = bert_family(kernel)
        fams[fam] += ms
        seen.add(kernel)
        if fam == "other":
            others[kernel[:60]] += ms
        elif fam == "layernorm+add+cast":
            parts[norm_part(kernel)] += ms
    busy = sum(fams.values())
    if busy == 0:
        print(f"profile {label}: the profiler recorded no device time (not "
              "measured)", flush=True)
        return {"idle_share": None, "sdpa_backend": "not measured"}
    idle = max(0.0, 1 - busy / wall_ms)
    backend = sdpa_backend(k for k in seen if bert_family(k) == "attention")
    print(f"profile {label}, device ms per call: busy={busy:.3f} of "
          f"{wall_ms:.3f} (idle share {idle:.1%}); " + " ".join(
              f"{k}={v:.3f}ms({v / busy:.1%})"
              for k, v in fams.most_common())
          + " (layernorm+add+cast: " + ", ".join(
              f"{k} {v:.3f}" for k, v in parts.most_common())
          + f"); SDPA backend {backend}", flush=True)
    print(f"profile {label} largest 'other' kernels: " + "; ".join(
        f"{name}={ms:.3f}ms" for name, ms in others.most_common(6)),
        flush=True)
    return {"idle_share": idle, "sdpa_backend": backend,
            "families": dict(fams), "norm_parts": dict(parts)}


def bert_grads(model, batch, attention) -> tuple:
    """One backward's gradients (f32 copies) and the loss, with
    ``attention`` in every block."""
    from tensorflowonspark_torch.models import bert

    model.attention = attention
    model.zero_grad(set_to_none=True)
    loss = bert.make_loss_fn(model, None)(model, batch)
    loss.backward()
    grads = {k: p.grad.detach().float().clone()
             for k, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    model.attention = bert.attention
    return grads, float(loss.detach())


def dropped_mask(attention):
    """A planted fault: ``attention`` with the key-padding mask dropped."""
    import torch

    def faulty(q, k, v, bias):
        return attention(q, k, v, torch.zeros_like(bias))

    return faulty


def bert_grad_gates(card: dict, plain: dict, f32: dict, fault: dict,
                    skip=()) -> tuple[dict, list]:
    """Phase 15(a)'s gates on four gradient sets of one batch: the card's
    path (``card``), the plain path (both bf16), f32 and the card's path
    with a planted fault.  Returns the distances and the failures (empty
    when every gate holds and the fault is caught)."""
    import torch

    names = sorted(f32)
    if sorted(card) != names or not all(
            bool(torch.isfinite(g).all()) for g in card.values()):
        return {}, ["a gradient is missing or not finite"]
    d = {"card_f32": _rel_l2(card, f32), "plain_f32": _rel_l2(plain, f32),
         "card_plain": _rel_l2(card, plain),
         "fault_f32": _rel_l2(fault, f32)}
    gate = BERT_GRADS_OVER_PLAIN * d["plain_f32"] + BERT_GRADS_SLACK
    leaves = [k for k in names if k not in skip]
    worst = max(leaves, key=lambda k: _rel_l2({k: card[k]}, {k: f32[k]})
                - BERT_GRADS_OVER_PLAIN * _rel_l2({k: plain[k]},
                                                  {k: f32[k]}))
    d["worst_leaf"] = worst
    for key, got in (("card", card), ("fault", fault)):
        d[f"{key}_leaf_f32"] = _rel_l2({worst: got[worst]},
                                       {worst: f32[worst]})
    d["plain_leaf_f32"] = _rel_l2({worst: plain[worst]},
                                  {worst: f32[worst]})
    failures = []
    if d["card_f32"] > BERT_GRADS_BF16_VS_F32:
        failures.append(f"card vs f32 {d['card_f32']:.3e} > "
                        f"{BERT_GRADS_BF16_VS_F32}")
    if max(d["card_f32"], d["card_plain"]) > gate:
        failures.append(f"card vs f32 / plain {d['card_f32']:.3e} / "
                        f"{d['card_plain']:.3e} > {gate:.3e}")
    if d["card_leaf_f32"] > (BERT_GRADS_OVER_PLAIN * d["plain_leaf_f32"]
                             + BERT_GRADS_SLACK):
        failures.append(f"leaf {worst}: card vs f32 "
                        f"{d['card_leaf_f32']:.3e}, plain "
                        f"{d['plain_leaf_f32']:.3e}")
    if not d["fault_f32"] > gate:
        failures.append(f"planted fault missed: {d['fault_f32']:.3e} <= "
                        f"{gate:.3e}")
    d["gate"] = gate
    return d, failures


def bert_trajectory(config, batch, steps: int, device: str,
                    attention=None) -> list:
    """``steps`` AdamW steps (the example's optimizer, ``BERT_LR``) of a
    fresh ``Trainer`` on one batch: the losses.  ``attention``, if given,
    replaces the model's."""
    from tensorflowonspark_torch.examples import bert_squad
    from tensorflowonspark_torch.trainer import Trainer

    t = Trainer("bert", config=config, seed=0, device=device,
                optimizer=bert_squad.make_optimizer(BERT_LR))
    if attention is not None:
        t.model.attention = attention
    return [float(t.step(batch)) for _ in range(steps)]


def bert_replay(args, partitions, device: str) -> list:
    """The example's trainer (``bert_squad.make_trainer``) stepping the
    batches its ``DataFeed`` gives in ``InputMode.SPARK``: each
    partition's rows in order, ``args.batch_size`` at a time, the short
    tail of each partition dropped.  The losses."""
    from tensorflowonspark_torch.examples import bert_squad

    t = bert_squad.make_trainer(args, device)
    losses, n = [], args.batch_size
    for rows in partitions:
        for lo in range(0, len(rows) - n + 1, n):
            losses.append(t.step(bert_batch(rows[lo:lo + n])))
    return [float(v) for v in losses]


def bert_model_phase() -> dict:
    """Phase 15(a)-(d): gradients, the trajectory, the step and the
    forward of ``bert.Config()`` on the card."""
    import dataclasses

    import torch

    from tensorflowonspark_torch.examples import bert_squad
    from tensorflowonspark_torch.models import bert
    from tensorflowonspark_torch.trainer import Trainer

    config = bert.Config()
    failures, out = [], {}

    # (a) one step's gradients: the card's path, the plain path, f32
    model = bert.make_model(config, seed=0).cuda()
    f32_model = bert.load_state(bert.make_model(dataclasses.replace(
        config, dtype="float32")), bert.state_of(model)).cuda()
    batch = bert_device_batch(config, BERT_GRAD_BATCH, seed=1)
    lengths = batch["attention_mask"].sum(1).tolist()
    g_card, loss_card = bert_grads(model, batch, bert.attention)
    g_plain, loss_plain = bert_grads(model, batch, bert.attention_plain)
    g_f32, loss_f32 = bert_grads(f32_model, batch, bert.attention_plain)
    g_fault, _ = bert_grads(model, batch, dropped_mask(bert.attention))
    del model, f32_model
    d, grad_failures = bert_grad_gates(g_card, g_plain, g_f32, g_fault,
                                       bert_zero_grad_leaves(config))
    del g_card, g_plain, g_f32, g_fault
    if d:  # empty when a gradient is missing
        caught = "caught" if d["fault_f32"] > d["gate"] else "MISSED"
        print(f"bert-base (a) one step's gradients at batch "
              f"{BERT_GRAD_BATCH} x {BERT_SEQ} (lengths {lengths}): loss "
              f"card={loss_card:.5f} plain={loss_plain:.5f} "
              f"f32={loss_f32:.5f}; rel_l2 card-vs-f32={d['card_f32']:.3e} "
              f"plain-vs-f32={d['plain_f32']:.3e} card-vs-plain="
              f"{d['card_plain']:.3e} (tol: card-vs-f32 and card-vs-plain "
              f"<= {d['gate']:.3e}, card-vs-f32 <= "
              f"{BERT_GRADS_BF16_VS_F32}); the leaf furthest past the "
              f"plain path, {d['worst_leaf']}: card "
              f"{d['card_leaf_f32']:.3e}, plain {d['plain_leaf_f32']:.3e}; "
              f"planted fault (mask dropped): vs f32 {d['fault_f32']:.3e} "
              f"({caught}), its leaf {d['fault_leaf_f32']:.3e}", flush=True)
    failures += [f"(a) {f}" for f in grad_failures]

    # (b) 8 AdamW steps on one batch, bf16 (the card's path) against f32
    batch = bert_device_batch(config, BERT_TRAJ_BATCH, seed=2)
    traj = {"bf16": bert_trajectory(config, batch, BERT_STEPS, "cuda"),
            "f32": bert_trajectory(dataclasses.replace(
                config, dtype="float32"), batch, BERT_STEPS, "cuda",
                bert.attention_plain)}
    gap = max(abs(a - b) for a, b in zip(traj["bf16"], traj["f32"]))
    falls = traj["bf16"][-1] < 0.5 * traj["bf16"][0]
    print(f"bert-base (b) {BERT_STEPS} AdamW steps (lr {BERT_LR}, weight "
          f"decay {bert_squad.WEIGHT_DECAY}) at batch {BERT_TRAJ_BATCH} x "
          f"{BERT_SEQ}: bf16 {[round(v, 5) for v in traj['bf16']]}; f32 "
          f"{[round(v, 5) for v in traj['f32']]}; max gap {gap:.3e} (tol "
          f"{BERT_TRAJ_TOL} x {traj['f32'][0]:.4f}); falls={falls}",
          flush=True)
    if gap > BERT_TRAJ_TOL * traj["f32"][0] or not falls:
        failures.append(f"(b) trajectory gap {gap:.3e}, falls {falls}")
    torch.cuda.empty_cache()

    # (c) the device-resident train step at the recipe's batch
    batch = bert_device_batch(config, BERT_STEP_BATCH, seed=3)
    flops = bert_flops(config, BERT_STEP_BATCH, BERT_SEQ, train=True)
    for remat in (False, True):
        held = torch.cuda.memory_allocated()  # earlier phases' tensors
        t = Trainer("bert", config=dataclasses.replace(config, remat=remat),
                    seed=0, device="cuda",
                    optimizer=bert_squad.make_optimizer(BERT_LR))
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(lambda: t.step(batch), 10)
        peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        label = f"bert-base train step remat={remat}"
        prof = bert_profile(lambda: t.step(batch), 3, step_ms,
                            f"{label} batch {BERT_STEP_BATCH}")
        rate = BERT_STEP_BATCH / step_ms * 1e3
        share = flops / (step_ms / 1e3) / BF16_DENSE_OPS_PER_S
        print(f"bert-base (c) {label} at batch {BERT_STEP_BATCH} x "
              f"{BERT_SEQ}: {step_ms:.3f} ms, {rate:.1f} sequences/s, "
              f"{rate * BERT_SEQ:.0f} tokens/s, peak memory {peak_gb:.2f} "
              f"GB (above the {held / 1e9:.2f} GB held before the trainer); "
              f"{flops / 1e12:.3f} TFLOP counted a step = "
              f"{flops / step_ms / 1e9:.1f} TFLOP/s, {share:.1%} of the "
              f"bf16 dense peak", flush=True)
        out[f"step_remat_{remat}"] = {
            "ms": step_ms, "sequences_per_s": rate, "peak_gb": peak_gb,
            "peak_share": share, **prof}
        del t
        torch.cuda.empty_cache()

    # (d) the forward
    model = bert.make_model(config, seed=0).cuda().eval()
    batch = bert_device_batch(config, BERT_FWD_BATCH, seed=4)

    def forward():
        with torch.inference_mode():
            return bert.outputs(model, batch)

    fwd_ms = time_ms(forward, 10)
    prof = bert_profile(forward, 3, fwd_ms,
                        f"bert-base forward batch {BERT_FWD_BATCH}")
    rate = BERT_FWD_BATCH / fwd_ms * 1e3
    share = (bert_flops(config, BERT_FWD_BATCH, BERT_SEQ, train=False)
             / (fwd_ms / 1e3) / BF16_DENSE_OPS_PER_S)
    print(f"bert-base (d) forward at batch {BERT_FWD_BATCH} x {BERT_SEQ}: "
          f"{fwd_ms:.3f} ms, {rate:.1f} sequences/s, {share:.1%} of the "
          f"bf16 dense peak", flush=True)
    out["forward"] = {"ms": fwd_ms, "sequences_per_s": rate, **prof}
    del model
    torch.cuda.empty_cache()
    out["failures"] = failures
    return out


def bert_slice(sc, work: str, device: str = "cuda",
               tiny: bool = False) -> dict:
    """Phase 15(e): ``tensorflowonspark_torch/examples/bert_squad.py``'s
    ``map_fun`` (``Config(remat=True)``; ``--tiny`` with ``tiny``) on one
    executor in ``InputMode.SPARK`` over a DataFrame of ``synth_squad``
    rows, against an in-process replay on ``device``; its chief writes
    the export (f) serves."""
    from tensorflowonspark_torch import TFCluster, sparkapi
    from tensorflowonspark_torch.examples import bert_squad
    from tensorflowonspark_torch.models import bert

    config = bert.Config.tiny() if tiny else bert.Config()
    seq = min(config.max_len, BERT_SEQ)  # the export's traced length
    export = os.path.join(work, "bert_export")
    args = bert_squad.parse_args([
        "--cluster_size", "1", "--epochs", "1", "--batch_size",
        str(BERT_STEP_BATCH), "--seq_len", str(seq), "--model_dir",
        export] + (["--tiny"] if tiny else []))
    rows = bert_squad.synth_squad(BERT_SLICE_ROWS, config.vocab_size, seq)
    df = sparkapi.LocalSparkSession(sc).createDataFrame(
        rows, bert_squad.COLUMNS).repartition(BERT_SLICE_PARTITIONS)
    partitions = [[list(r) for r in p] for p in df.rdd._partitions]
    t0 = time.perf_counter()
    cluster = TFCluster.run(
        sc, functools.partial(run_counted, bert_squad.map_fun), args,
        num_executors=1, input_mode=TFCluster.InputMode.SPARK,
        master_node="chief")
    cluster.train(df.rdd.map(list), num_epochs=1, feed_timeout=600)
    cluster.shutdown(grace_secs=300)
    job_s = time.perf_counter() - t0
    [node] = node_published(cluster, (
        "state", "losses", "steps", "final_loss", "device", "launches",
        "table_launches", "sequences_per_sec"))
    rates = slice_rates(cluster.metrics(), 1)
    replay = bert_replay(args, partitions, device)
    steps = sum(len(p) // BERT_STEP_BATCH for p in partitions)
    failures = slice_failures(node, replay, steps=steps,
                              per_step=launch_counts(),
                              tol=BERT_SLICE_VS_REPLAY, final_only=False,
                              device=device)
    losses = node["losses"] or []
    if losses[:1] != replay[:1]:
        failures.append(f"first loss {losses[:1]} (replay {replay[:1]})")
    if node["steps"] != steps or node["final_loss"] != (losses or [None])[-1]:
        failures.append(f"published steps {node['steps']}, final loss "
                        f"{node['final_loss']}")
    print(f"bert (e) bert_squad map_fun (InputMode.SPARK, one executor, "
          f"{'tiny' if tiny else 'Config(remat=True)'}, batch "
          f"{BERT_STEP_BATCH} x {seq}, "
          f"{BERT_SLICE_ROWS} rows in {[len(p) for p in partitions]}) on "
          f"{node['device']}: state {node['state']}, {len(losses)} steps, "
          f"losses {[round(v, 5) for v in losses]}; in-process replay "
          f"{[round(v, 5) for v in replay]}; rel "
          f"{loss_rel(losses, replay, False):.3e} (tol "
          f"{BERT_SLICE_VS_REPLAY}, the first loss bit for bit), the same "
          f"bits {losses == replay}; "
          f"cluster.metrics() sequences/s={rates['rate']} (the loop's "
          f"{node['sequences_per_sec']}); job {job_s:.1f} s", flush=True)
    return {"failures": [f"(e) {f}" for f in failures], "export": export,
            "sequences_per_s": rates["rate"],
            "launches": {**(node["launches"] or {}),
                         **(node["table_launches"] or {})}}


def bert_serving(sc, export_dir: str, device: str = "cuda") -> dict:
    """Phase 15(f): ``TFModel.transform`` of (e)'s export on ``device``
    over ``BERT_SERVE_ROWS`` rows in 3 partitions, one of them all
    padding: both output columns against the eager forward, chunked and
    padded as the executor batches, bit for bit."""
    import torch

    from tensorflowonspark_torch import ckpt, pipeline, sparkapi
    from tensorflowonspark_torch.examples import bert_squad
    from tensorflowonspark_torch.models import bert

    state = ckpt.load_pytree(os.path.join(export_dir, "model"))
    config = bert.config_from_state(state)
    seq = min(config.max_len, BERT_SEQ)  # the export's traced length
    rows = bert_squad.synth_squad(BERT_SERVE_ROWS, config.vocab_size, seq,
                                  seed=7)
    rows[BERT_SERVE_ROWS // 2] = ([0] * seq,) * 3 + (0, 0)
    cols = bert_squad.COLUMNS[:3]
    df = sparkapi.LocalSparkSession(sc).createDataFrame(
        [dict(zip(cols, r[:3])) for r in rows]).repartition(3)
    sizes = [len(p) for p in df.rdd._partitions]
    tfmodel = (pipeline.TFModel(device=device).setExportDir(export_dir)
               .setBatchSize(BERT_STEP_BATCH)
               .setBucketSizes([BERT_STEP_BATCH])
               .setInputMapping({c: c for c in cols}))
    t0 = time.perf_counter()
    out = tfmodel.transform(df).collect()
    seconds = time.perf_counter() - t0
    got = [torch.tensor([getattr(r, f"output_{i}") for r in out])
           for i in (0, 1)]
    model = bert.load_state(bert.make_model(config), state).to(
        device).eval()
    batch = bert_batch(rows)
    want, start = [[], []], 0
    with torch.inference_mode():
        for size in sizes:
            for lo in range(start, start + size, BERT_STEP_BATCH):
                n = min(BERT_STEP_BATCH, start + size - lo)
                chunk = {c: torch.zeros(BERT_STEP_BATCH, seq,
                                        dtype=torch.int32) for c in cols}
                for c in cols:
                    chunk[c][:n] = torch.from_numpy(batch[c][lo:lo + n])
                for i, o in enumerate(bert.outputs(model, {
                        c: v.to(device) for c, v in chunk.items()})):
                    want[i].append(o[:n].cpu())
            start += size
    want = [torch.cat(w) for w in want]
    del model
    bits = [g.shape == w.shape and bool(torch.equal(g, w))
            for g, w in zip(got, want)]
    err = [float((g - w).abs().max()) if g.shape == w.shape else float("inf")
           for g, w in zip(got, want)]
    pad = BERT_SERVE_ROWS // 2
    pad_ok = bool((got[0][pad] == bert.MASKED).all()) if bits[0] else False
    print(f"bert (f) TFModel.transform of the export (its serialized "
          f"forward, torch.ops.tfos.bert_attention) on {device}: "
          f"{len(out)} rows "
          f"in {sizes}, {seconds:.3f} s ({len(out) / seconds:.2f} rows/s, "
          f"with the load); columns {sorted(out[0].asDict())}; against the "
          f"eager bf16 forward: the same bits {bits}, max |diff| {err}; "
          f"the all-padding row all -1e30 {pad_ok}", flush=True)
    failures = []
    if len(out) != BERT_SERVE_ROWS or not all(bits) or not pad_ok:
        failures.append(f"(f) rows {len(out)}, the same bits {bits}, "
                        f"padding row {pad_ok}")
    return {"failures": failures, "rows_per_s": len(out) / seconds}


def bert_phase(sc, work: str) -> dict:
    """Phase 15 (see the module docstring), in phase 11's application:
    every sub-phase runs; the failures are gathered and fail the run at
    the end.  The GroupNorm and table kernels' launches are counted from
    0 in every process of the phase: BERT reaches none of them."""
    from tensorflowonspark_torch.kernels import group_norm, sparse_adagrad

    t0 = time.perf_counter()
    group_norm.reset_launches()
    sparse_adagrad.reset_launches()
    for reset in (_reset_launches, _reset_table_launches):
        sc.parallelize([0], 1).mapPartitions(reset).collect()
    model = bert_model_phase()
    t_model = time.perf_counter()
    sliced = bert_slice(sc, work)
    t_slice = time.perf_counter()
    served = bert_serving(sc, sliced["export"])
    [(executor, _)] = sc.parallelize([0], 1).mapPartitions(
        _executor_state).collect()
    [tables] = sc.parallelize([0], 1).mapPartitions(_table_launches).collect()
    executor.update(tables)
    launches = {k: v + executor[k] + sliced["launches"].get(k, 0)
                for k, v in {**group_norm.launches_by_path,
                             **sparse_adagrad.launches_by_path}.items()}
    failures = model["failures"] + sliced["failures"] + served["failures"]
    if any(launches.values()):
        failures.append(f"GroupNorm or table kernels launched {launches}")
    total = time.perf_counter() - t0
    print(f"bert-base phase 15: GroupNorm and table kernel launches "
          f"(driver, executor, the SPARK-mode trainer) {launches}; "
          f"sequences/s train step at {BERT_STEP_BATCH} "
          f"{model['step_remat_False']['sequences_per_s']:.1f} (remat "
          f"{model['step_remat_True']['sequences_per_s']:.1f}), forward at "
          f"{BERT_FWD_BATCH} {model['forward']['sequences_per_s']:.1f}, "
          f"slice {sliced['sequences_per_s']}; served rows/s "
          f"{served['rows_per_s']:.2f}", flush=True)
    print(f"bert-base phase 15 seconds: model {t_model - t0:.1f}, slice "
          f"{t_slice - t_model:.1f}, serving {total - (t_slice - t0):.1f}; "
          f"phase 15 {total:.1f} (budget {PHASE15_BUDGET_S})", flush=True)
    print(json.dumps({"bert_base": {
        k: {kk: vv for kk, vv in v.items() if kk != "failures"}
        for k, v in model.items() if k != "failures"} | {
        "slice_sequences_per_s": sliced["sequences_per_s"],
        "served_rows_per_s": served["rows_per_s"]}}), flush=True)
    if failures:
        raise SystemExit("bert phase 15 failed: " + "; ".join(failures))
    return {"launches": launches}


# ---------------------------------------------------------------------------
# Phase 16: the compiled step (one CUDA graph per batch signature)
# ---------------------------------------------------------------------------

GRAPH_STEPS = 8
GRAPH_RESTORE_AT = 4  # (d): the checkpoint step restored after capture
#: (b): the step (0-based) traced by the profiler in each run: a replay in
#: the graph run, an eager step in the eager one
GRAPH_TRACED_STEP = GRAPH_STEPS - 1
# 10 before phase 17 was added (a depth cut: 5 steps a timed loop)
GRAPH_TIMED_STEPS = 5
GRAPH_PROFILED_STEPS = 3
#: BERT's graph-against-eager gate is phase 15's slice gate: the first loss
#: bit for bit, later losses within this rel (cuDNN's attention backward
#: adds with atomics, so two runs of the same step differ from step 2)
GRAPH_BERT_LOSS_REL = BERT_SLICE_VS_REPLAY
PHASE16_BUDGET_S = 120
#: phase 16(f)'s subprocess: build or load the kernel libraries in an
#: empty ``_build`` through the cache at ``TFOS_COMPILE_CACHE_DIR``
#: (argv: the build dir, whether nvcc may be used, whether to launch each
#: kernel against its plain twin), printing one JSON line
CACHE_PROCESS_SCRIPT = r"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
t0 = time.perf_counter()
from tensorflowonspark_torch import compile_cache
from tensorflowonspark_torch.kernels import _build
build_dir, nvcc, launch = sys.argv[1], sys.argv[2] == "1", sys.argv[3] == "1"
_build.BUILD_DIR = build_dir
if not nvcc:
    def _no_nvcc():
        raise RuntimeError("nvcc is off for this process")
    _build.find_nvcc = _no_nvcc
t1 = time.perf_counter()
compile_cache.ensure()  # the namespace reads the card's name
t2 = time.perf_counter()
paths = _build.build_all()
t3 = time.perf_counter()
out = {"import_s": t1 - t0, "configure_s": t2 - t1,
       "build_or_load_s": t3 - t2,
       "libraries": sorted(os.path.basename(p) for p in paths)}
if launch:
    import chip_smoke
    out["twins"] = chip_smoke.cache_twin_checks()
out.update(compile_cache.stats())
print(json.dumps(out))
"""


def cache_twin_checks() -> dict:
    """One launch of each kernel library (forward and backward GroupNorm,
    the grouping and the table update, the paged append and attention)
    against its plain twin, at small shapes: ``{kernel: max abs error}``;
    raises on a mismatch."""
    import torch

    from tensorflowonspark_torch import embedding
    from tensorflowonspark_torch.kernels import group_norm, sparse_adagrad

    gen = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn(4, 64, 14, 14, generator=gen, device="cuda").to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    gamma = 1 + 0.1 * torch.randn(64, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(64, generator=gen, device="cuda")
    out = {}
    y, stats = group_norm._launch(x, gamma, beta, 32, 1e-6, None, True,
                                  keep_stats=True)
    plain = group_norm.group_norm_act_plain(x, gamma, beta, 32, 1e-6, None,
                                            True)
    out["group_norm"] = float((y.float() - plain.float()).abs().max())
    dy = torch.randn_like(x)
    got = group_norm._launch_backward(dy, x, y, gamma, stats, 32, False,
                                      True)
    want = group_norm.group_norm_act_backward_plain(dy, x, y, gamma, stats,
                                                    32, False, True)
    out["group_norm_bwd"] = float((got[0].float() - want[0].float())
                                  .abs().max())
    ids = torch.randint(0, 1000, (512,), generator=gen, device="cuda",
                        dtype=torch.int32)
    grouping = sparse_adagrad.group(ids, 1000)
    out["sparse_adagrad group"] = (0.0 if grouping_matches(grouping, ids, 1000)
                                   else 1.0)
    table = torch.randn(1000, 8, generator=gen, device="cuda")
    acc = torch.rand(1000, 8, generator=gen, device="cuda")
    g = torch.randn(512, 8, generator=gen, device="cuda")
    t2, a2 = table.clone(), acc.clone()
    sparse_adagrad.update([(table, acc, g)], grouping, 0.1, 1e-10, False)
    embedding.sparse_adagrad_update_plain(t2, a2, ids, g, 0.1, 1e-10, False)
    out["sparse_adagrad update"] = float((table - t2).abs().max())
    case = paged_case(paged_case_rows("decode", 1), 1, 65, 16)
    res = paged_kernel_case("cache", case, calls=1)
    out["paged_attention"] = res["paged_attention"]["max_abs_err"]
    out["kv_append"] = 0.0 if res["kv_append"]["bits"] else 1.0
    torch.cuda.synchronize()
    tol = {"group_norm": 2 * 2.0 ** -7 * 8, "group_norm_bwd": 2 * 2.0 ** -7
           * 8, "sparse_adagrad group": 0.0, "sparse_adagrad update": 1e-5,
           "paged_attention": ATTN_TOL, "kv_append": 0.0}
    bad = {k: v for k, v in out.items() if not v <= tol[k]}
    if bad:
        raise SystemExit(f"kernels loaded from the cache disagree with "
                         f"their plain twins: {bad}")
    return out


def flat_counts() -> dict:
    """Every counted wrapper's launches by path in one dictionary:
    GroupNorm's paths, then the table kernels'."""
    from tensorflowonspark_torch.kernels import group_norm, sparse_adagrad

    return {**group_norm.launches_by_path, **sparse_adagrad.launches_by_path}


#: The counted path of each hand-written kernel, by the name a profiler
#: trace gives it.  A graph replay calls no wrapper, so 16(b) counts a
#: replay's launches from its trace, an eager step's too (the check that
#: the names count what the wrappers count).
TRACED_KERNELS = {
    "gn_one_pass": "one_pass", "gn_stats": "two_pass",
    "gn_finalize": "two_pass", "gn_apply": "two_pass",
    "gn_bwd_one_pass": "backward_one_pass",
    "gn_bwd_reduce": "backward_four_launch",
    "gn_bwd_finalize": "backward_four_launch",
    "gn_bwd_apply": "backward_four_launch",
    "gn_bwd_params": "backward_four_launch",
    "tfos_id_grouping": "group",
    # one kernel for both modes (``combine`` is an argument)
    "tfos_adagrad_segment_walk": "table update",
    "tfos_kv_append": "kv_append", "tfos_paged_attention": "paged_attention"}
_KERNEL_TOKEN = re.compile(r"\b(gn_[a-z_]+|tfos_[a-z_]+)\b")


def traced_launches(names) -> dict:
    """``{counted path: kernels}`` of the hand-written kernels among
    ``names`` (a profiler trace's kernel names, one per launch)."""
    out = collections.Counter()
    for name in names:
        m = _KERNEL_TOKEN.search(name)
        if m and m.group(1) in TRACED_KERNELS:
            out[TRACED_KERNELS[m.group(1)]] += 1
    return dict(out)


def traced_plan(planned: dict) -> dict:
    """What :func:`traced_launches` reads of one step launching
    ``planned`` (by counted path): each one-kernel path's count, the two
    table update modes together.  The multi-kernel paths are planned
    nowhere in phase 16."""
    if planned.get("two_pass") or planned.get("backward_four_launch"):
        raise ValueError(f"no trace plan for a multi-kernel path: {planned}")
    out = {k: v for k, v in planned.items()
           if v and k not in ("sparse", "combine")}
    update = planned.get("sparse", 0) + planned.get("combine", 0)
    if update:
        out["table update"] = update
    return out


#: spin kernels launched, then waited for, in a trace before the traced
#: step: a torch.profiler trace drops its first few dozen device records
#: on an H100 (with none, the first ≈ 8 GroupNorm forwards of a traced
#: ResNet step, eager or replayed, were missing and every backward there;
#: with 16 spin kernels, all 16 and 3-4 forwards; with 512, 0-45 spins)
TRACE_WARMUP_LAUNCHES = 512


def traced_step(trainer, batch) -> tuple:
    """One ``trainer.step(batch)`` under torch.profiler (CUPTI, which
    records a graph replay's kernels as it does an eager step's), after
    ``TRACE_WARMUP_LAUNCHES`` spin kernels and a wait: the loss,
    :func:`traced_launches` of what ran and how many of the spin kernels
    the trace holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_WARMUP_LAUNCHES):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        loss = trainer.step(batch)
        torch.cuda.synchronize()
    names = [name for name, _ in device_kernels(prof, 1)]
    return (loss, traced_launches(names),
            sum("spin" in name.lower() or "sleep" in name.lower()
                for name in names))


def planned_launches(tables: dict) -> dict:
    """Each phase-16(a) model's kernel launches a training step on their
    planned paths (GroupNorm's and the table kernels' in one dict)."""
    from tensorflowonspark_torch.kernels import sparse_adagrad

    none = dict.fromkeys(sparse_adagrad.launches_by_path, 0)
    gn = {"resnet50": launch_counts(one_pass=53, backward_one_pass=53),
          "inception_v3": step_launches(tables["inception_v3 canonical"]),
          "mobilenet_v1": step_launches(tables["mobilenet_v1"]),
          "cifar10_cnn": step_launches(tables["cifar10_cnn"])}
    zero = launch_counts()
    out = {k: {**v, **none} for k, v in gn.items()}
    out["mnist_mlp"] = out["bert"] = {**zero, **none}
    for mode, path in WD_MODES:
        out[f"wide_deep {mode}"] = {**zero, **none, "group": 1, path: 1}
    return out


def graph_cases() -> list:
    """Phase 16(a)'s models: ``(label, zoo name, config, batch size, lr,
    optimizer factory or None, batch maker (step index -> device batch))``,
    each at its published widths."""
    import dataclasses

    import torch

    from tensorflowonspark_torch.examples import bert_squad
    from tensorflowonspark_torch.models import (bert, cifar, inception,
                                                mnist, mobilenet, resnet,
                                                widedeep)

    def zoo(lib, config, n):
        return lambda i: {k: torch.from_numpy(v).cuda() for k, v in
                          lib.example_batch(config, n, seed=16 + i).items()}

    cases = [
        ("resnet50", "resnet50", resnet.Config(), 8, TRAIN_LR, None),
        ("inception_v3", "inception_v3", inception.Config(canonical=True), 4,
         TRAIN_LR, None),
        ("mobilenet_v1", "mobilenet_v1", mobilenet.Config(), 8, TRAIN_LR,
         None),
        ("cifar10_cnn", "cifar10_cnn", cifar.Config(), 64, TRAIN_LR, None),
        ("mnist_mlp", "mnist_mlp", mnist.Config(), MNIST_BATCH, TRAIN_LR,
         None)]
    libs = {"resnet50": resnet, "inception_v3": inception,
            "mobilenet_v1": mobilenet, "cifar10_cnn": cifar,
            "mnist_mlp": mnist}
    out = [(label, name, config, n, lr, opt, zoo(libs[name], config, n))
           for label, name, config, n, lr, opt in cases]
    for mode, _ in WD_MODES:
        config = dataclasses.replace(widedeep.Config(), table_update=mode)
        out.append((f"wide_deep {mode}", "wide_deep", config, WD_BATCH,
                    WD_LR, None, zoo(widedeep, config, WD_BATCH)))
    for remat in (True, False):
        config = bert.Config(remat=remat)
        out.append((f"bert remat={remat}", "bert", config, BERT_TRAJ_BATCH,
                    BERT_LR, bert_squad.make_optimizer(BERT_LR),
                    lambda i, c=config: bert_device_batch(
                        c, BERT_TRAJ_BATCH, seed=16 + i)))
    return out


def state_tensors(trainer) -> dict:
    """Clones of everything a step updates: parameters, the optimizer's
    state, the model's buffers (wide&deep's tables and accumulators)."""
    out = {f"param/{k}": v.detach().clone()
           for k, v in trainer.model.named_parameters()}
    out.update({f"buffer/{k}": v.clone()
                for k, v in trainer.model.named_buffers()})
    for k, p in trainer.model.named_parameters():
        for name, v in trainer.optimizer.state.get(p, {}).items():
            if hasattr(v, "clone"):
                out[f"opt/{k}/{name}"] = v.clone()
    return out


def state_gap(got: dict, want: dict) -> tuple:
    """``(tensors whose bits differ, the largest rel max-abs gap)``."""
    differ, worst = 0, 0.0
    for k, w in want.items():
        g = got[k]
        if not (g.shape == w.shape and g.dtype == w.dtype
                and bool((g == w).all())):
            differ += 1
            scale = float(w.float().abs().max()) or 1.0
            worst = max(worst, float((g.float() - w.float()).abs().max())
                        / scale)
    return differ, worst


def run_trajectory(name, config, lr, optimizer, batches, mode: str,
                   save_to: str | None = None,
                   checkpoint_dir: str | None = None,
                   keep: bool = False) -> dict:
    """``GRAPH_STEPS`` steps of a fresh seed-0 ``Trainer`` on ``batches``:
    ``mode`` ``graph`` (its compiled step), ``eager`` (the step swapped for
    the eager one, ``make_train_step``'s or ``make_sharded_train_step``'s)
    or ``stale`` (the planted fault: replays whose static inputs keep the
    capture's batch).  The losses, each step's launches counted by the
    wrappers, the kernels a profiler trace counts in step
    ``GRAPH_TRACED_STEP`` (not in a stale run), what the compiled step
    did, and the final state; ``save_to`` checkpoints the step
    ``GRAPH_RESTORE_AT`` state there, and then (d) restores it after the
    run and steps again.  ``checkpoint_dir`` makes the trainer checkpoint
    there at its last step (``Trainer.checkpoint``'s cadence), and
    ``keep`` returns the trainer (``trainer``)."""
    import torch

    from tensorflowonspark_torch.trainer import Trainer

    t = Trainer(name, config=config, learning_rate=lr, seed=0,
                device="cuda", optimizer=optimizer)
    if checkpoint_dir:
        t.checkpoint(checkpoint_dir, every_steps=len(batches))
    if mode == "eager":
        t.train_step = eager_step(t)
    elif mode == "stale":
        t.train_step = StaleInputsStep(t.train_step.step, t.shard)
    losses, launches, actions, traced, warm = [], [], [], None, None
    for i, batch in enumerate(batches):
        before = flat_counts()
        if i == GRAPH_TRACED_STEP and mode != "stale":
            loss, traced, warm = traced_step(t, batch)
        else:
            loss = t.step(batch)
        losses.append(loss)
        torch.cuda.synchronize()
        launches.append({k: v - before[k] for k, v in flat_counts().items()})
        actions.append(getattr(t.train_step, "last", "eager"))
        if save_to and i + 1 == GRAPH_RESTORE_AT:
            t.save(save_to)
    out = {"losses": [float(v) for v in losses], "launches": launches,
           "traced": traced, "warmup_traced": warm, "actions": actions,
           "state": state_tensors(t)}
    if save_to:
        t.restore(save_to)
        again, actions = [], []
        for b in batches[GRAPH_RESTORE_AT:]:
            again.append(t.step(b))
            actions.append(t.train_step.last)
        out["restored"] = {"losses": [float(v) for v in again],
                           "state": state_tensors(t),
                           "step": int(t.state.step), "actions": actions}
    if keep:
        out["trainer"] = t
    return out


def eager_step(trainer):
    """``trainer``'s eager step (``make_train_step``'s or a zoo module's
    own) in place of its compiled one, on the batch ``trainer.shard``
    stages."""
    step = trainer.train_step.step
    return lambda state, batch: step(state, trainer.shard(batch))


class StaleInputsStep:
    """The planted fault of 16(c): a compiled step whose replays never
    refresh their static inputs, so each trains on the capture's batch.
    Built lazily as a ``CompiledStep`` subclass (the module imports no
    torch at its top)."""

    def __new__(cls, step, shard=None):
        from tensorflowonspark_torch.parallel import train as train_lib

        class _Stale(train_lib.CompiledStep):
            def _refresh(self, static_leaves, leaves):
                # only the capture's own fill: not yet a captured graph's
                if not any(c.static_leaves is static_leaves
                           for c in self._cache.captured.values()):
                    super()._refresh(static_leaves, leaves)

        return _Stale(step, shard=shard)


def trajectory_gate(label: str, graph: dict, eager: dict,
                    planned: dict) -> list:
    """Phase 16(a)-(b)'s gates for one model: the graph run's losses and
    final state bit for bit the eager run's (BERT: the first loss bit for
    bit, the rest within ``GRAPH_BERT_LOSS_REL``); the graph run eager,
    captured, then replayed; the wrappers counting the planned launches in
    every eager step and in the capture, none in a replay (which calls no
    wrapper); and the profiler's trace of a replay and of an eager step
    each counting the planned kernels (:func:`traced_plan`)."""
    failures = []
    bert = label.startswith("bert")
    g, e = graph["losses"], eager["losses"]
    rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(g, e))
    if bert:
        if g[0] != e[0] or rel > GRAPH_BERT_LOSS_REL:
            failures.append(f"{label} (a) losses: first equal {g[0] == e[0]},"
                            f" max rel {rel:.3e}")
    elif g != e:
        failures.append(f"{label} (a) losses differ (max rel {rel:.3e})")
    differ, worst = state_gap(graph["state"], eager["state"])
    if differ and not bert:
        failures.append(f"{label} (a) {differ} state tensors differ "
                        f"(worst rel {worst:.3e})")
    want_actions = ["eager", "capture"] + ["replay"] * (len(g) - 2)
    if graph["actions"] != want_actions:
        failures.append(f"{label} (a) actions {graph['actions']}")
    none = dict.fromkeys(planned, 0)
    wants = {"graph": [planned, planned] + [none] * (len(g) - 2),
             "eager": [planned] * len(e)}
    for run, name in ((graph, "graph"), (eager, "eager")):
        bad = [i + 1 for i, (d, w) in enumerate(zip(run["launches"],
                                                    wants[name])) if d != w]
        if bad:
            failures.append(f"{label} (b) {name} steps {bad} counted "
                            f"{run['launches'][bad[0] - 1]}, want "
                            f"{wants[name][bad[0] - 1]}")
    traced = traced_plan(planned)
    for run, name in ((graph, "graph"), (eager, "eager")):
        if run["traced"] != traced:
            failures.append(f"{label} (b) the trace of {name} step "
                            f"{GRAPH_TRACED_STEP + 1} ran {run['traced']}, "
                            f"planned {traced}")
    print(f"compiled step (a)-(b) {label}: losses graph "
          f"{[round(v, 5) for v in g]}; eager {[round(v, 5) for v in e]}; "
          f"max rel {rel:.3e}; state tensors differing {differ} of "
          f"{len(eager['state'])} (worst rel {worst:.3e}); planned a step "
          f"{ {k: v for k, v in planned.items() if v} or 'none'}: counted "
          f"by the wrappers in every eager step and the capture, none in a "
          f"replay, and traced in step {GRAPH_TRACED_STEP + 1} (replay "
          f"{graph['traced'] or 'none'}, eager {eager['traced'] or 'none'};"
          f" spin kernels before them in the traces "
          f"{graph.get('warmup_traced')} and {eager.get('warmup_traced')} of "
          f"{TRACE_WARMUP_LAUNCHES}): {not any('(b)' in f for f in failures)}"
          f"; "
          f"steps {graph['actions']}"
          + (" (gate: first loss bit for bit, the rest within "
             f"{GRAPH_BERT_LOSS_REL})" if bert else " (gate: bit for bit)"),
          flush=True)
    return failures


def graph_numbers(label: str, make_trainer, batch, unit: str, per_step: int,
                  modes=("eager", "captured"), timed: int = GRAPH_TIMED_STEPS,
                  profiled: int = GRAPH_PROFILED_STEPS) -> dict:
    """Phase 16(e) for one trainer, each mode on the same process and card:
    rate (CUDA events over ``timed`` steps), device busy ms a
    step and the idle share (torch.profiler), the host µs of
    ``Trainer.step`` (median wall of calls made on an idle card, and in the
    timed loop, where a long graph's launch waits for room in the device's
    queue), captured: split into ``graph.replay()`` alone on an idle card,
    the batch's copy into the static inputs and the rest, the capture's
    seconds, and peak memory allocated and reserved."""
    import statistics

    import torch

    t = make_trainer()
    compiled = t.train_step
    eager = eager_step(t)
    out = {}
    for mode in modes:
        t.train_step = eager if mode == "eager" else compiled
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        capture_s = None
        t.step(batch)  # eager: warm-up; captured: the first sighting
        if mode != "eager":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.step(batch)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            if compiled.last != "capture":
                raise SystemExit(f"{label}: the second step did not capture "
                                 f"({compiled.last})")
        t.step(batch)
        walls = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(timed):
            w0 = time.perf_counter()
            t.step(batch)
            walls.append(time.perf_counter() - w0)
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / timed
        # the host's own cost a step: each call on an idle card, so that
        # no launch waits for room in the device's queue
        host, inputs = [], []
        for _ in range(timed):
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            t.step(batch)
            host.append(time.perf_counter() - w0)
            inputs.append(getattr(t.train_step, "input_s", 0.0))
        split = {}
        if mode != "eager":
            # graph.replay() alone: the same graph, on an idle card (it
            # trains one more step each; nothing after reads the state)
            graph, replays = compiled.graph_of(batch).graph, []
            for _ in range(timed):
                torch.cuda.synchronize()
                w0 = time.perf_counter()
                graph.replay()
                replays.append(time.perf_counter() - w0)
            split = {"replay_us": statistics.median(replays) * 1e6,
                     "input_us": statistics.median(inputs) * 1e6}
            split["rest_us"] = (statistics.median(host) * 1e6
                                - split["replay_us"] - split["input_us"])
        busy = profiled_busy_ms(lambda: t.step(batch), profiled)
        out[mode] = {**split,
            "step_ms": step_ms, "rate": per_step * 1e3 / step_ms,
            "busy_ms": busy,
            "idle_share": None if busy is None else max(0.0,
                                                        1 - busy / step_ms),
            "host_us": statistics.median(host) * 1e6,
            "loop_host_us": statistics.median(walls) * 1e6,
            "capture_s": capture_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}
    parts = []
    for mode, m in out.items():
        idle = ("not measured" if m["idle_share"] is None
                else f"{m['idle_share']:.1%}")
        busy = ("not measured" if m["busy_ms"] is None
                else f"{m['busy_ms']:.3f}")
        split = (f" = graph.replay() alone {m['replay_us']:.1f} + the batch "
                 f"into the static inputs {m['input_us']:.1f} + the rest "
                 f"{m['rest_us']:.1f}" if "replay_us" in m else "")
        parts.append(
            f"{mode} {m['step_ms']:.4f} ms = {m['rate']:.1f} {unit}/s, busy "
            f"{busy} ms (idle {idle}), host {m['host_us']:.1f} us a step "
            f"on an idle card{split} ({m['loop_host_us']:.1f} in the timed "
            f"loop), "
            + (f"capture {m['capture_s']:.3f} s, "
               if m["capture_s"] is not None else "")
            + f"peak {m['peak_gb']:.2f} GB allocated / "
              f"{m['peak_reserved_gb']:.2f} GB reserved")
    print(f"compiled step (e) {label}: " + "; ".join(parts), flush=True)
    # a Trainer and its compiled step form a reference cycle (the step's
    # shard closure holds the trainer): collect it, or its graph pool stays
    # on the card for the next phase
    del t, compiled, eager
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profiled_busy_ms(fn, calls: int) -> float | None:
    """Device busy ms per call of ``fn`` (torch.profiler, CUPTI), or None
    when the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy = sum(ms for _, ms in device_kernels(prof, calls))
    return busy or None


def graph_number_cases() -> list:
    """Phase 16(e)'s configurations: ``(label, trainer factory, batch, unit,
    units a step, modes)``; the ``foreach`` AdamW (capturable) captured
    beside the default, ``fused=True``."""
    import dataclasses

    import torch

    from tensorflowonspark_torch import trainer as trainer_mod
    from tensorflowonspark_torch.examples import bert_squad
    from tensorflowonspark_torch.models import (bert, inception, resnet,
                                                widedeep)
    from tensorflowonspark_torch.trainer import Trainer

    def foreach(lr, weight_decay=trainer_mod.ADAMW_WEIGHT_DECAY):
        def optimizer(params):
            return torch.optim.AdamW(
                list(params), lr=lr, betas=trainer_mod.ADAMW_BETAS,
                eps=trainer_mod.ADAMW_EPS, weight_decay=weight_decay,
                foreach=True, capturable=True)
        return optimizer

    def zoo_batch(lib, config, n, seed=16):
        return {k: torch.from_numpy(v).cuda()
                for k, v in lib.example_batch(config, n, seed=seed).items()}

    cases = []
    for mode, _ in WD_MODES:
        config = dataclasses.replace(widedeep.Config(), table_update=mode)
        cases.append((f"wide_deep {mode} batch {WD_BATCH}",
                      lambda c=config: Trainer("wide_deep", config=c,
                                               learning_rate=WD_LR,
                                               device="cuda"),
                      zoo_batch(widedeep, config, WD_BATCH), "steps", 1,
                      ("eager", "captured")))
    config = dataclasses.replace(widedeep.Config(), table_update="dense")
    cases.append((f"wide_deep dense batch {WD_BATCH} foreach AdamW",
                  lambda c=config: Trainer("wide_deep", config=c,
                                           device="cuda",
                                           optimizer=foreach(WD_LR)),
                  zoo_batch(widedeep, config, WD_BATCH), "steps", 1,
                  ("captured",)))
    config = inception.Config(canonical=True)
    cases.append((f"inception_v3 canonical batch {INCEPTION_STEP_BATCH}",
                  lambda c=config: Trainer("inception_v3", config=c,
                                           learning_rate=TRAIN_LR,
                                           device="cuda"),
                  zoo_batch(inception, config, INCEPTION_STEP_BATCH),
                  "images", INCEPTION_STEP_BATCH, ("eager", "captured")))
    for remat in (True, False):
        c = bert.Config(remat=remat)
        cases.append((f"bert-base remat={remat} batch {BERT_STEP_BATCH} x "
                      f"{BERT_SEQ}",
                      lambda c=c: Trainer(
                          "bert", config=c, device="cuda",
                          optimizer=bert_squad.make_optimizer(BERT_LR)),
                      bert_device_batch(c, BERT_STEP_BATCH, seed=16),
                      "sequences", BERT_STEP_BATCH, ("eager", "captured")))
    c = bert.Config()
    cases.append((f"bert-base remat=False batch {BERT_STEP_BATCH} x "
                  f"{BERT_SEQ} foreach AdamW",
                  lambda c=c: Trainer("bert", config=c, device="cuda",
                                      optimizer=foreach(
                                          BERT_LR, bert_squad.WEIGHT_DECAY)),
                  bert_device_batch(c, BERT_STEP_BATCH, seed=16),
                  "sequences", BERT_STEP_BATCH, ("captured",)))
    config = resnet.Config()
    for n in (SLICE_TRAIN_BATCH, MODEL_BATCH):
        cases.append((f"resnet50 batch {n}",
                      lambda c=config: Trainer("resnet50", config=c,
                                               learning_rate=TRAIN_LR,
                                               device="cuda"),
                      zoo_batch(resnet, config, n), "images", n,
                      ("eager", "captured")))
    cases.append((f"resnet50 batch {MODEL_BATCH} foreach AdamW",
                  lambda c=config: Trainer("resnet50", config=c,
                                           device="cuda",
                                           optimizer=foreach(TRAIN_LR)),
                  zoo_batch(resnet, config, MODEL_BATCH), "images",
                  MODEL_BATCH, ("captured",)))
    return cases


def start_cache_process(build_dir: str, cache_dir: str, nvcc: bool,
                        launch: bool):
    """Phase 16(f)'s subprocess (``CACHE_PROCESS_SCRIPT``), started from
    the repository root with ``TFOS_COMPILE_CACHE_DIR=cache_dir``."""
    env = {**os.environ, "TFOS_COMPILE_CACHE_DIR": cache_dir}
    env.pop("TFOS_COMPILE_CACHE", None)
    return subprocess.Popen(
        [sys.executable, "-c", CACHE_PROCESS_SCRIPT, build_dir,
         "1" if nvcc else "0", "1" if launch else "0"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_cache_process(proc, label: str) -> dict:
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"compiled step (f) {label} process failed (exit "
                         f"{proc.returncode}):\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def corrupt_entry(cache_dir: str, name: str) -> str:
    """Flip bytes in the middle of the stored library ``name`` (a prefix of
    its file name) under ``cache_dir``'s one namespace; returns its path."""
    (namespace,) = [os.path.join(cache_dir, d) for d in os.listdir(cache_dir)]
    (entry,) = [os.path.join(namespace, f) for f in os.listdir(namespace)
                if f.startswith(name + "-") and f.endswith(".so")]
    with open(entry, "r+b") as f:
        f.seek(os.path.getsize(entry) // 2)
        f.write(b"\x5a" * 32)
    return entry


def cache_gates(first: dict, second: dict, third: dict) -> list:
    """Phase 16(f)'s gates: the first process built and wrote all three
    libraries; the second, with no nvcc, loaded all three from the cache
    and its kernels match their twins; the third found the corrupted entry,
    rejected it and rebuilt (and wrote) that one, and loaded the rest."""
    n = len(first["libraries"])
    failures = []
    if (first["disk_writes"], first["disk_hits"]) != (n, 0):
        failures.append(f"(f) build process wrote {first['disk_writes']} and"
                        f" hit {first['disk_hits']} of {n}")
    if (second["disk_hits"], second["disk_writes"],
            second["disk_corrupt"]) != (n, 0, 0):
        failures.append(f"(f) nvcc-less process: hits {second['disk_hits']}, "
                        f"writes {second['disk_writes']}, corrupt "
                        f"{second['disk_corrupt']} (want {n}, 0, 0)")
    if second["libraries"] != first["libraries"] or not second.get("twins"):
        failures.append("(f) nvcc-less process: libraries or launches")
    if (third["disk_corrupt"], third["disk_writes"],
            third["disk_hits"]) != (1, 1, n - 1):
        failures.append(f"(f) corrupted entry: corrupt "
                        f"{third['disk_corrupt']}, writes "
                        f"{third['disk_writes']}, hits {third['disk_hits']} "
                        f"(want 1, 1, {n - 1})")
    return failures


def compiled_step_phase(work: str) -> dict:
    """Phase 16 (see the module docstring)."""
    import torch

    t16 = time.perf_counter()
    failures, seconds = [], {}
    # (f)'s first process builds while (a)-(e) run on the card
    cache_dir = os.path.join(work, "compile_cache")
    first_proc = start_cache_process(os.path.join(work, "build_first"),
                                     cache_dir, nvcc=True, launch=False)
    planned = planned_launches(zoo_site_tables())
    counts0 = flat_counts()
    replay_traced = collections.Counter()  # (b)'s traced replays, by path

    # (a)-(d): trajectories, launches, the planted fault, restore
    t0 = time.perf_counter()
    eager_wd = None
    for label, name, config, _, lr, opt, make_batch in graph_cases():
        batches = [make_batch(i) for i in range(GRAPH_STEPS)]
        save_to = (os.path.join(work, "graph_restore")
                   if label == "resnet50" else None)
        graph = run_trajectory(name, config, lr, opt, batches, "graph",
                               save_to)
        torch.cuda.empty_cache()
        eager = run_trajectory(name, config, lr, opt, batches, "eager")
        torch.cuda.empty_cache()
        plan = planned[label.split(" remat")[0]]
        failures += trajectory_gate(label, graph, eager, plan)
        for path, n in (graph["traced"] or {}).items():
            if path == "table update":
                path = "combine" if plan["combine"] else "sparse"
            replay_traced[path] += n
        if save_to:
            r = graph["restored"]
            want = graph["losses"][GRAPH_RESTORE_AT:]
            differ, worst = state_gap(r["state"], graph["state"])
            ok = (r["losses"] == want and not differ
                  and r["step"] == len(batches)
                  and r["actions"] == ["eager", "capture", "replay",
                                       "replay"])
            print(f"compiled step (d) {label}: the step-{GRAPH_RESTORE_AT} "
                  f"checkpoint restored into the trainer that had captured "
                  f"(its graphs dropped), then steps "
                  f"{GRAPH_RESTORE_AT + 1}-{len(batches)}: losses "
                  f"{[round(v, 5) for v in r['losses']]} against the "
                  f"uninterrupted {[round(v, 5) for v in want]}; state "
                  f"tensors differing {differ} (worst rel {worst:.3e}); "
                  f"steps {r['actions']}; bit for bit: {ok}", flush=True)
            if not ok:
                failures.append(f"{label} (d) restore after capture")
        if label == "wide_deep dense":
            eager_wd = (name, config, lr, opt, batches, eager)
        del graph, eager, batches
        torch.cuda.empty_cache()
    # (c) the planted fault: replays that keep the capture's batch
    name, config, lr, opt, batches, eager = eager_wd
    stale = run_trajectory(name, config, lr, opt, batches, "stale")
    caught = stale["losses"] != eager["losses"]
    print(f"compiled step (c) planted fault (wide_deep dense: replays whose "
          f"static inputs are not refreshed): losses "
          f"{[round(v, 5) for v in stale['losses']]} against eager "
          f"{[round(v, 5) for v in eager['losses']]}: "
          f"{'caught' if caught else 'MISSED'} by gate (a)", flush=True)
    if not caught:
        failures.append("(c) the planted stale-input fault was not caught")
    del stale, eager_wd, eager, batches
    torch.cuda.empty_cache()
    seconds["a-d"] = time.perf_counter() - t0
    launches = {k: v - counts0[k] for k, v in flat_counts().items()}

    # (e) eager beside captured
    t0 = time.perf_counter()
    numbers = {}
    for label, make, batch, unit, per_step, modes in graph_number_cases():
        numbers[label] = graph_numbers(label, make, batch, unit, per_step,
                                       modes)
        del batch
    seconds["e"] = time.perf_counter() - t0

    # (f) the compile cache
    t0 = time.perf_counter()
    first = finish_cache_process(first_proc, "build")
    spare = os.path.join(work, "compile_cache_corrupted")
    shutil.copytree(cache_dir, spare)
    corrupted = corrupt_entry(spare, "group_norm")
    second_proc = start_cache_process(os.path.join(work, "build_second"),
                                      cache_dir, nvcc=False, launch=True)
    third_proc = start_cache_process(os.path.join(work, "build_third"),
                                     spare, nvcc=True, launch=False)
    second = finish_cache_process(second_proc, "nvcc-less load")
    third = finish_cache_process(third_proc, "corrupted entry")
    cache_failures = cache_gates(first, second, third)
    print(f"compiled step (f) compile cache at {cache_dir}: build process "
          f"{first['build_or_load_s']:.2f} s for {first['libraries']} "
          f"(hits {first['disk_hits']}, writes {first['disk_writes']}, "
          f"corrupt {first['disk_corrupt']}); process without nvcc loaded "
          f"them in {second['build_or_load_s']:.3f} s after "
          f"{second['configure_s']:.2f} s configuring the cache (hits "
          f"{second['disk_hits']}, writes {second['disk_writes']}, corrupt "
          f"{second['disk_corrupt']}), each kernel against its plain twin "
          f"{second.get('twins')}; a copy with "
          f"{os.path.basename(corrupted)} corrupted: "
          f"{third['build_or_load_s']:.2f} s (corrupt "
          f"{third['disk_corrupt']}, rebuilt and written "
          f"{third['disk_writes']}, hits {third['disk_hits']}); namespace "
          f"{second['namespace']}", flush=True)
    failures += cache_failures
    seconds["f"] = time.perf_counter() - t0
    total = time.perf_counter() - t16
    print(f"compiled step phase 16 seconds: (a)-(d) {seconds['a-d']:.1f}, "
          f"(e) {seconds['e']:.1f}, (f) {seconds['f']:.1f}; phase 16 "
          f"{total:.1f} (budget {PHASE16_BUDGET_S} s)", flush=True)
    if failures:
        raise SystemExit("compiled-step phase failed: " + "; ".join(failures))
    return {"launches": launches, "replay_traced": dict(replay_traced),
            "numbers": numbers,
            "cache": {"first": first, "second": second, "third": third},
            "seconds": total}


# ---------------------------------------------------------------------------
# Phase 17: the generative decode tier
# ---------------------------------------------------------------------------

PHASE17_BUDGET_S = 60
#: the decode engine of 17(b)-(d), over ``tinylm.Config()`` at full width
DECODE_ENGINE = {"max_seqs": 8, "page_size": 16, "max_len": 128,
                 "max_prompt_len": 64}
DECODE_SEED = 17
DECODE_REQUESTS = 32
#: requests each planted-fault engine serves (17(b))
DECODE_PLANTED_REQUESTS = 8
#: |kernel - plain twin| of the attention, f32: the softmax and the dot
#: products are summed in another order (measured ≈ 3e-7)
ATTN_TOL = 1e-5
#: a paged-path token may differ from the full forward's argmax only where
#: the full forward's logit of that token lies within this of its maximum
#: (a near-tie: the two paths sum the same f32 products in other orders)
DECODE_TIE_GAP = 1e-5
#: 17(a)'s larger case: 256 rows of 128 positions over 2,049 pages
SYNTH_ROWS, SYNTH_POSITIONS = 256, 128
#: 17(a)'s long decode case: 16 rows of one query over up to 1,024
#: positions (64 pages of 16 a row)
LONG_ROWS, LONG_PAGES, LONG_MAX_LEN = 16, 64, 1024
DECODE_TIMED_CALLS = 50
#: the paged kernels by the name a profiler trace gives them
PAGED_KERNELS = {k: v for k, v in TRACED_KERNELS.items()
                 if k in ("tfos_kv_append", "tfos_paged_attention")}
PLANTED_OFF_BY_ONE = ("TFOS_PLANTED_CAUSAL_OFF_BY_ONE",)
#: a build whose append writes offset (p + 1) % page_size of p's page
PLANTED_APPEND = ("TFOS_PLANTED_APPEND_OFF_BY_ONE",)
#: 17(e): the speculating engines' draft length (the ladder 1, 2, 4), its
#: budget (printed, not enforced), the sampled workload's policy
SPEC_TOKENS = 4
SPEC_BUDGET_S = 30
SPEC_SAMPLING = {"temperature": 0.8, "top_p": 0.9}
#: the cold drafter's weights: ``init_params``' draw times this (N(0, 0.2)
#: for the kernels and embeddings).  At the init's own scale both models
#: mostly repeat the last token (each one's logits are led by its own
#: embedding's self-similarity), and such a drafter agreed with the target
#: 71% of the time on the card: not cold
COLD_DRAFT_SCALE = 10.0


def paged_case_rows(label: str, L: int) -> list:
    """17(a)'s rows at the engine's geometry (8 pages of 16 a row, 128
    positions), or ``"long"``'s (:data:`LONG_ROWS` decode rows of
    :data:`LONG_PAGES` pages, up to :data:`LONG_MAX_LEN` positions):
    ``(start, valid length or None, pages)``, ``pages`` the table's
    entries as ``("own", i)`` (the row's i-th private page) or ``("of",
    r, i)`` (row r's i-th page, shared, never written here).  The rows:
    active mid-page, from a page boundary, inactive (an all-zero table),
    ending at max_len - 1, sharing another row's first two pages, and
    short ones."""
    if label == "long":
        own = [("own", i) for i in range(LONG_PAGES)]
        shared = [("of", 3, i) for i in range(8)] + own[8:]
        starts = (517, 256, 0, LONG_MAX_LEN - 1, 200, 1000, 63, 15, 640,
                  128, 900, 333, 768, 47, 1022, 700)
        return [(s, None, [] if r == 2 else shared if r == 4 else own)
                for r, s in enumerate(starts[:LONG_ROWS])]
    own = [("own", i) for i in range(8)]
    shared = [("of", 3, 0), ("of", 3, 1)] + own[2:]
    if label.startswith("verify"):  # L = k + 1 and step lengths 0..L
        return [(36, L, own), (16, 1, own), (0, 0, []), (128 - L, L, own),
                (40, L, shared), (63, L, own), (100, max(1, L - 1), own),
                (15, L, own)]
    if label == "decode":  # L = 1: every position valid (lens None)
        return [(36, None, own), (16, None, own), (0, None, []),
                (127, None, own), (40, None, shared), (63, None, own),
                (100, None, own), (15, None, own)]
    return [(0, L, own), (16, L - 3, own), (0, 0, []),
            (128 - L, L, own), (32, L, shared), (8, 5, own),
            (48, L // 2, own), (0, 1, own)]


def paged_case(rows: list, L: int, num_pages: int, seed: int,
               heads: int = 4, head_dim: int = 32, layers: int = 2,
               page_size: int = 16, width: int = 8):
    """The tensors of one 17(a) case on the card: random pools of pages of
    ``page_size``, q/k/v, the tables (``width`` entries a row; each row's
    private pages drawn without replacement from pages 1..), start and
    lens."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    R = len(rows)
    pages = rng.permutation(np.arange(1, num_pages))
    tables = np.zeros((R, width), np.int32)
    used = 0
    for r, (_, _, entries) in enumerate(rows):
        for i, e in enumerate(entries):
            if e[0] == "own":
                tables[r, i] = pages[used]
                used += 1
    for r, (_, _, entries) in enumerate(rows):
        for i, e in enumerate(entries):
            if e[0] == "of":
                tables[r, i] = tables[e[1], e[2]]
    start = np.array([s for s, _, _ in rows], np.int32)
    lens = (None if rows[0][1] is None
            else np.array([n for _, n, _ in rows], np.int32))
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    shape = (layers, num_pages, page_size, heads, head_dim)
    return {"k_pool": randn(*shape), "v_pool": randn(*shape),
            "q": randn(R, L, heads, head_dim),
            "k": randn(R, L, heads, head_dim),
            "v": randn(R, L, heads, head_dim),
            "tables": torch.from_numpy(tables).cuda(),
            "start": torch.from_numpy(start).cuda(),
            "lens": None if lens is None else torch.from_numpy(lens).cuda(),
            "tables_np": tables, "start_np": start, "lens_np": lens}


def paged_bounds(case: dict, max_len: int) -> dict:
    """The least time of each paged kernel on this case's data, each
    input read once and each output written once (bytes), against its f32
    operations (at the f32 rate outside the tensor cores):
    ``{"kv_append": ..., "paged_attention": ...}``.  The append reads k
    and v and writes them into the pools; the attention reads q, the K/V
    of the distinct pool positions its rows see (a page two rows share
    counts once) and the tables, and writes o, with 4 operations a head
    element for each (query, position) pair (the score's multiply-add, the
    output's)."""
    import numpy as np

    tables, start = case["tables_np"], case["start_np"]
    R, L, H, K = case["q"].shape
    ps = case["k_pool"].shape[2]
    elems = R * L * H * K
    idx = R * (tables.shape[1] + 2) * 4
    append_bytes = 4 * elems * 4 + idx
    seen, pairs = set(), 0
    for r in range(R):
        for t in range(L):
            p = min(max(int(start[r]) + t, 0), max_len - 1)
            pairs += p + 1
        last = min(max(int(start[r]) + L - 1, 0), max_len - 1)
        for j in range(last + 1):
            seen.add((int(tables[r, j // ps]), j % ps))
    attn_bytes = 2 * elems * 4 + len(seen) * H * K * 4 * 2 + idx
    return {
        "kv_append": _bound(append_bytes / HBM_BYTES_PER_S * 1e3, 0.0,
                            bytes=append_bytes),
        "paged_attention": _bound(
            attn_bytes / HBM_BYTES_PER_S * 1e3,
            pairs * H * K * 4 / F32_OPS_PER_S * 1e3, bytes=attn_bytes)}


def paged_library_call(case: dict, layer: int, max_len: int):
    """One PyTorch expression of the attention, the yardstick the port
    never calls: K and V gathered through the tables by ``index_select``
    (the two gathers), then ``scaled_dot_product_attention`` under a
    boolean mask of each query's positions."""
    import torch
    import torch.nn.functional as F

    q, tables, start = case["q"], case["tables"], case["start"]
    R, L, H, K = q.shape
    ps = case["k_pool"].shape[2]
    ctx = tables.shape[1] * ps
    idx = tables.reshape(-1).long()
    pos = (start.long()[:, None] + torch.arange(L, device=q.device)).clamp(
        0, max_len - 1)
    mask = (torch.arange(ctx, device=q.device)[None, None, :]
            <= pos[:, :, None])[:, None]
    qt = q.transpose(1, 2)

    def call():
        kg = case["k_pool"][layer].index_select(0, idx).reshape(R, ctx, H, K)
        vg = case["v_pool"][layer].index_select(0, idx).reshape(R, ctx, H, K)
        return F.scaled_dot_product_attention(
            qt, kg.transpose(1, 2), vg.transpose(1, 2), attn_mask=mask)

    return call


def append_against_twin(case: dict, max_len: int, layer: int = 1):
    """17(a)'s append gate: ``kv_append`` into copies of the case's pools
    against ``kv_append_plain`` into others, compared outside page 0:
    ``(the same bits, max |kernel - twin|, the kernel's pools, the
    twin's)``."""
    import torch

    from tensorflowonspark_torch.kernels import paged_attention as pa

    args = (case["tables"], case["start"], case["lens"])
    kc, vc = case["k_pool"].clone(), case["v_pool"].clone()
    kt, vt = case["k_pool"].clone(), case["v_pool"].clone()
    pa.kv_append(kc, vc, layer, case["k"], case["v"], *args,
                 max_len=max_len)
    pa.kv_append_plain(kt, vt, layer, case["k"], case["v"], *args,
                       max_len=max_len)
    torch.cuda.synchronize()
    bits = (torch.equal(kc[:, 1:], kt[:, 1:])
            and torch.equal(vc[:, 1:], vt[:, 1:]))
    err = max(float((kc[:, 1:] - kt[:, 1:]).abs().max()),
              float((vc[:, 1:] - vt[:, 1:]).abs().max()))
    return bits, err, (kc, vc), (kt, vt)


def paged_kernel_case(label: str, case: dict, max_len: int = 128,
                      layer: int = 1, calls: int = 50) -> dict:
    """17(a) for one case: the append bit for bit its plain twin's outside
    page 0 (run on the card), the attention within ``ATTN_TOL`` of its
    twin on the same pools and the same bits twice; ms a call of each
    kernel, its twin and the library yardstick (CUDA events), beside
    ``bound_ms``, and the append's µs a launch under CUPTI (back to back:
    at the engine's shapes the events time is the wrapper's host)."""
    import torch

    from tensorflowonspark_torch.kernels import paged_attention as pa

    args = (case["tables"], case["start"], case["lens"])
    append_bits, append_err, (kc, vc), (kt, vt) = append_against_twin(
        case, max_len, layer)
    o = pa.paged_attention(case["q"], kc, vc, layer, case["tables"],
                           case["start"], max_len=max_len)
    o2 = pa.paged_attention(case["q"], kc, vc, layer, case["tables"],
                            case["start"], max_len=max_len)
    ot = pa.paged_attention_plain(case["q"], kc, vc, layer, case["tables"],
                                  case["start"], max_len=max_len)
    torch.cuda.synchronize()
    attn_err = float((o - ot).abs().max())
    same = torch.equal(o, o2)
    case = dict(case, k_pool=kc, v_pool=vc)
    library = paged_library_call(case, layer, max_len)
    lib_err = float((library().transpose(1, 2) - ot).abs().max())
    plain_index = _append_indices(case, max_len)

    def append():
        pa.kv_append(kc, vc, layer, case["k"], case["v"], *args,
                     max_len=max_len)

    times = {
        "kv_append": (
            time_ms(append, calls),
            time_ms(lambda: pa.kv_append_plain(
                kt, vt, layer, case["k"], case["v"], *args,
                max_len=max_len), calls),
            time_ms(lambda: (kt[layer].index_put_(plain_index, case["k"]),
                             vt[layer].index_put_(plain_index, case["v"])),
                    calls)),
        "paged_attention": (
            time_ms(lambda: pa.paged_attention(
                case["q"], kc, vc, layer, case["tables"], case["start"],
                max_len=max_len), calls),
            time_ms(lambda: pa.paged_attention_plain(
                case["q"], kc, vc, layer, case["tables"], case["start"],
                max_len=max_len), calls),
            time_ms(library, calls))}
    append_us = cupti_us(append, 20, "tfos_kv_append")
    bounds = paged_bounds(case, max_len)
    out = {
        "kv_append": {"max_abs_err": append_err, "bits": append_bits,
                      "cupti_ms": (None if append_us is None
                                   else append_us / 1e3)},
        "paged_attention": {"max_abs_err": attn_err, "bits": same,
                            "library_err": lib_err}}
    for name, (ms, plain_ms, library_ms) in times.items():
        out[name].update({"ms": ms, "plain_ms": plain_ms,
                          "library_ms": library_ms, **bounds[name]})
    R, L = case["q"].shape[:2]
    us = "not measured" if append_us is None else f"{append_us:.3f}"
    print(f"paged kernels (a) {label} ({R} rows x {L} positions, "
          f"{case['k_pool'].shape[1]} pages): kv_append bit for bit its "
          f"twin outside page 0: {append_bits}; paged_attention max |kernel"
          f" - twin| {attn_err:.3e} (tol {ATTN_TOL}), the same bits twice: "
          f"{same}, the library's {lib_err:.3e}; ms a call (bound; plain; "
          f"library): " + "; ".join(
              f"{n} {v['ms']:.4f} ({v['bound_ms']:.6f} by {v['bound_by']}; "
              f"{v['plain_ms']:.4f}; {v['library_ms']:.4f})"
              for n, v in out.items())
          + f"; kv_append {us} us a launch (CUPTI, back to back)",
          flush=True)
    return out


def _append_indices(case: dict, max_len: int):
    """The ``(pages, offsets)`` of the append, for the library yardstick
    (``index_put_`` with its indices made beforehand)."""
    import torch

    R, L = case["k"].shape[:2]
    ps = case["k_pool"].shape[2]
    pos = (case["start"].long()[:, None]
           + torch.arange(L, device="cuda")).clamp(0, max_len - 1)
    pages = torch.gather(case["tables"].long(), 1, pos // ps)
    if case["lens"] is not None:
        pages = torch.where(torch.arange(L, device="cuda")[None]
                            < case["lens"].long()[:, None], pages, 0)
    return pages, pos % ps


def paged_kernel_phase(rungs, ladder=(), draft=None) -> tuple[dict, list]:
    """17(a): the cases at the engine's geometry (decode, each chunk rung,
    each verify rung of ``ladder``), the draft model's (``draft``, a
    ``tinylm.Config``: its decode step and top chunk rung over its own
    one-layer pools), the long decode case and the larger synthetic one;
    returns ``({case: result}, failures)``."""
    import torch

    results, failures = {}, []
    cases = ([("decode", 1)] + [(f"chunk{L}", L) for L in rungs]
             + [(f"verify{k + 1}", k + 1) for k in ladder])
    for i, (label, L) in enumerate(cases):
        rows = paged_case_rows(label, L)
        results[label] = paged_kernel_case(
            label, paged_case(rows, L, 1 + 8 * len(rows), 170 + i))
    if draft is not None:
        for i, (label, L) in enumerate((("decode", 1),
                                        (f"chunk{rungs[-1]}", rungs[-1]))):
            rows = paged_case_rows(label, L)
            results[f"draft_{label}"] = paged_kernel_case(
                f"draft_{label}", paged_case(
                    rows, L, 1 + 8 * len(rows), 190 + i,
                    heads=draft.n_heads, head_dim=draft.head_dim,
                    layers=draft.n_layers), layer=draft.n_layers - 1)
    rows = paged_case_rows("long", 1)
    results["long"] = paged_kernel_case(
        "long", paged_case(rows, 1, 1 + LONG_PAGES * len(rows), 178,
                           width=LONG_PAGES), max_len=LONG_MAX_LEN)
    synth = [(0, SYNTH_POSITIONS, [("own", j) for j in range(8)])
             for _ in range(SYNTH_ROWS)]
    results["synthetic"] = paged_kernel_case(
        "synthetic", paged_case(synth, SYNTH_POSITIONS,
                                1 + 8 * SYNTH_ROWS, 179), calls=10)
    torch.cuda.empty_cache()
    for label, res in results.items():
        if not res["kv_append"]["bits"]:
            failures.append(f"(a) {label}: kv_append differs from its twin")
        if res["kv_append"]["cupti_ms"] is None:
            failures.append(f"(a) {label}: no kv_append launch in the "
                            f"trace")
        attn = res["paged_attention"]
        if not (attn["max_abs_err"] <= ATTN_TOL and attn["bits"]):
            failures.append(f"(a) {label}: paged_attention "
                            f"{attn['max_abs_err']:.3e} from its twin or "
                            f"not the same bits twice")
    return results, failures


def decode_workload(seed: int = DECODE_SEED, vocab: int = 256,
                    n: int = DECODE_REQUESTS) -> list:
    """17(b)'s requests, ``(prompt int32, max_new_tokens)``: three 48-token
    prompts first (their three full pages register as prefixes), then
    singletons, then eight that extend a registered prefix, cut at a page
    boundary (16, 32) or mid-page (20, 24, 28, 33, 40, 44: a COW copy),
    with tails; prompts of 4-64 tokens, 16-64 new tokens, within 128
    positions."""
    import numpy as np

    rng = np.random.RandomState(seed)
    bases = [rng.randint(0, vocab, size=(48,)) for _ in range(3)]
    family = []
    for i, cut in enumerate((32, 24, 40, 20, 44, 33, 16, 28)):
        tail = rng.randint(0, vocab, size=(rng.randint(1, 64 - cut + 1),))
        family.append(np.concatenate([bases[i % 3][:cut], tail]))
    singles = [rng.randint(0, vocab, size=(rng.randint(4, 65),))
               for _ in range(n - len(bases) - len(family))]
    out = []
    for p in bases + singles + family:
        p = p.astype(np.int32)
        out.append((p, int(rng.randint(16, min(64, 128 - len(p)) + 1))))
    return out


def serve_all(engine, requests, concurrent: bool,
              sampling=None) -> tuple[list, float]:
    """Every request's token stream from ``engine`` (started), submitted
    all at once from as many threads or one after another, and the wall
    seconds; ``sampling``: request i's ``SamplingParams`` or None."""
    import threading

    out = [None] * len(requests)

    def run(i):
        prompt, n = requests[i]
        out[i] = engine.submit(
            prompt, max_new_tokens=n,
            sampling=None if sampling is None else sampling[i]).result(
                timeout=300)

    t0 = time.perf_counter()
    if concurrent:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    else:
        for i in range(len(requests)):
            run(i)
    return out, time.perf_counter() - t0


def greedy_gaps(params, config, requests, streams) -> tuple[int, int]:
    """Hold each stream to the full forward (``tinylm.apply_tokens``, plain
    PyTorch, no kernel) over the prompt and the stream itself: the logits
    at each position are those of the forward recomputed in full on the
    tokens before it (causal), so a stream is the greedy continuation when
    each of its tokens is that position's argmax.  Returns ``(tokens that
    are not the argmax, of which near-ties within DECODE_TIE_GAP)``."""
    import torch

    from tensorflowonspark_torch.models import tinylm

    off = ties = 0
    device = next(iter(params.values())).device
    with torch.no_grad():
        for (prompt, _), stream in zip(requests, streams):
            seq = torch.tensor([list(prompt) + list(stream)], device=device)
            logits = tinylm.apply_tokens(params, seq, config)[0]
            rows = logits[len(prompt) - 1: len(prompt) - 1 + len(stream)]
            want = torch.tensor(stream, device=device)
            best = rows.max(dim=-1).values
            got = rows.gather(1, want[:, None])[:, 0]
            wrong = rows.argmax(dim=-1) != want
            off += int(wrong.sum())
            ties += int((wrong & (best - got <= DECODE_TIE_GAP)).sum())
    return off, ties


def engine_contract(engine, pool_bytes: int, ptrs: tuple) -> list:
    """After ``stop()``: no used page, the pool's conservation law, the
    pools' bytes and storage unchanged since construction."""
    failures = []
    inv = engine.pool.invariant()
    if engine.pool.used_pages or not inv["ok"]:
        failures.append(f"pool after stop: {inv}")
    if (engine.kv_pool_bytes != pool_bytes
            or (engine._kp.data_ptr(), engine._vp.data_ptr()) != ptrs):
        failures.append("the KV pools moved or grew")
    return failures


def hist_quantiles(name: str, before: dict) -> dict:
    """p50/p99 (bucket upper bounds, ms) of the observations ``name`` (a
    decode histogram) took since ``before`` (its ``cumulative()``)."""
    from tensorflowonspark_torch import obs

    hist = obs.get_registry().peek(name)
    now = dict(hist.cumulative())
    delta = [(le, now[le] - before.get(le, 0)) for le in sorted(now)]
    total = delta[-1][1] if delta else 0
    out = {}
    for q in (0.5, 0.99):
        le = next((le for le, n in delta if total and n >= q * total), None)
        out[f"p{int(q * 100)}_ms"] = (None if le is None
                                      else le * 1e3 if le != float("inf")
                                      else float("inf"))
    out["n"] = total
    return out


def decode_step_numbers(engine, kind: str, batch: dict,
                        modes=("eager", "captured")) -> dict:
    """17(c) for one step kind of an idle engine: the wrappers' launches
    of one eager step; for each of ``modes``, the captured step (copy in,
    ``graph.replay()``, copy out) or the eager one: host µs a step on an
    idle card (median wall, the step's own sync included), device busy ms
    by family and the idle share (torch.profiler, after
    ``TRACE_WARMUP_LAUNCHES`` spin kernels); and the kernels a traced
    replay ran, a step."""
    import statistics

    import torch

    from tensorflowonspark_torch import decode, shapes
    from tensorflowonspark_torch.kernels import paged_attention as pa

    prog = engine._programs.captured[shapes.signature(batch)]
    calls = 5

    def eager():
        prog.staged.refresh(batch)
        return decode._fetch(engine._call(kind, prog.staged.views))

    def captured():
        return engine._run(kind, batch)[0]

    before = dict(pa.launches_by_kernel)
    eager()
    torch.cuda.synchronize()
    wrapper = {k: v - before[k] for k, v in pa.launches_by_kernel.items()}
    out = {"wrapper_launches": wrapper}

    def complete(kernels):  # every paged launch of every call in the trace
        traced = traced_launches(n for n, _ in kernels)
        return all(traced.get(k, 0) == wrapper.get(k, 0) * calls
                   for k in PAGED_KERNELS.values())

    for mode in modes:  # "captured" among them: its trace counts
        fn = eager if mode == "eager" else captured
        walls = []
        for _ in range(DECODE_TIMED_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        host_us = statistics.median(walls) * 1e6
        names, families = [], collections.Counter()
        for name, ms in traced_kernels(fn, calls, complete):
            names.append(name)
            families[decode_family(name)] += ms
        busy = sum(families.values()) or None
        out[mode] = {"host_us": host_us, "busy_ms": busy,
                     "families_ms": dict(families),
                     "idle_share": (None if busy is None else
                                    max(0.0, 1 - busy * 1e3 / host_us))}
        if mode == "captured":  # a whole count a step, unless one dropped
            out["traced_launches"] = {
                k: v // calls if v % calls == 0 else v / calls
                for k, v in traced_launches(names).items()
                if k in PAGED_KERNELS.values()}
    return out


def decode_family(kernel: str) -> str:
    """The family of one kernel of a decode or chunk step: either paged
    kernel by name, the GEMMs (cuBLAS), the host-to-card and card-to-host
    copies, or the rest (elementwise, norms, gathers, argmax)."""
    m = _KERNEL_TOKEN.search(kernel)
    if m and m.group(1) in PAGED_KERNELS:
        return PAGED_KERNELS[m.group(1)]
    low = kernel.lower()
    if "gemm" in low or "xmma" in low or "cutlass" in low:
        return "GEMMs"
    if "memcpy" in low:
        return "copies"
    return "other"


def idle_step_batches(engine, seed: int) -> tuple[dict, list]:
    """A decode-step batch and a chunk-step batch of the engine's largest
    rung, every slot live at random lengths, over pages allocated from the
    idle engine's pool (returned, to free after)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    S, P = engine.max_seqs, engine.pages_per_seq
    pages = engine.pool.alloc(S * P)
    tables = np.array(pages, np.int32).reshape(S, P)
    vocab = engine.config.vocab_size
    L = engine.prefill_chunks[-1]
    decode_batch = {
        "tokens": rng.randint(0, vocab, size=(S,)).astype(np.int32),
        "seq_lens": rng.randint(16, engine.max_len - 1,
                                size=(S,)).astype(np.int32),
        "page_tables": tables}
    chunk_batch = {
        "tokens": rng.randint(0, vocab, size=(S, L)).astype(np.int32),
        "start_lens": (rng.randint(0, 3, size=(S,)) * L).astype(np.int32),
        "chunk_lens": np.full((S,), L, np.int32),
        "page_tables": tables}
    return {"decode": decode_batch, "chunk": chunk_batch}, pages


def http_generation(engine, prompt, max_new: int) -> list:
    """One streamed generation over ``POST /v1/generate`` of a
    ``DecodeHTTPServer`` on ``engine``: the streamed tokens (the done
    line's must equal them)."""
    import http.client

    from tensorflowonspark_torch import decode

    srv = decode.DecodeHTTPServer(engine)
    try:
        host, port = srv.start()
        conn = http.client.HTTPConnection(host, port, timeout=60)
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"prompt": [int(t) for t in prompt],
             "max_new_tokens": max_new}).encode())
        resp = conn.getresponse()
        lines = [json.loads(ln) for ln in
                 resp.read().decode().strip().splitlines()]
    finally:
        srv.stop()
    streamed = [d["token"] for d in lines[:-1]]
    if resp.status != 200 or lines[-1].get("tokens") != streamed:
        raise SystemExit(f"decode (d): HTTP {resp.status}, {lines[-1]}")
    return streamed


def first_differences(params, config, requests, want, got) -> list:
    """Where a stream ``got[i]`` differs from ``want[i]``: ``(request,
    first position, gap)``, the gap between the full forward's logits
    (``tinylm.apply_tokens`` on the prompt and the common prefix) of the
    two tokens there; a stream of another length has gap inf."""
    import torch

    from tensorflowonspark_torch.models import tinylm

    out = []
    device = next(iter(params.values())).device
    with torch.no_grad():
        for i, ((prompt, _), a, b) in enumerate(zip(requests, want, got)):
            if a == b:
                continue
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if j is None:
                out.append((i, min(len(a), len(b)), float("inf")))
                continue
            seq = torch.tensor([list(prompt) + list(a[:j])], device=device)
            row = tinylm.apply_tokens(params, seq, config)[0, -1]
            out.append((i, j, abs(float(row[a[j]] - row[b[j]]))))
    return out


def spec_engine_run(label: str, config, params, requests, greedy,
                    rungs, **spec) -> tuple[dict, list, object]:
    """One 17(e) engine, counted from construction: built with ``spec``
    (``spec_tokens``, ``spec_drafter``, the draft's config and weights),
    warmed up, serving ``requests`` at once; its streams held to the
    greedy ones (``greedy``: (b)'s) and to the full forward, its captures,
    replays and the wrappers' launches to the plan of the warmup's
    signatures (one eager call and one capture each, every layer of the
    model that runs them).  Returns ``(numbers, failures, engine)`` with
    the engine still serving."""
    from tensorflowonspark_torch import decode
    from tensorflowonspark_torch.kernels import paged_attention as pa

    failures = []
    pa.reset_launches()
    engine = decode.DecodeEngine(config, params, spec_tokens=SPEC_TOKENS,
                                 **spec, **DECODE_ENGINE)
    contract = (engine.kv_pool_bytes,
                (engine._kp.data_ptr(), engine._vp.data_ptr()))
    engine.warmup()
    sigs = len(engine.enumerate_signatures())
    warm = (engine.captures, engine.eager_calls)
    engine.start()
    p0 = int(engine._spec_proposed_total.value)
    a0 = int(engine._spec_accepted_total.value)
    streams, wall = serve_all(engine, requests, concurrent=True)
    launches = dict(pa.launches_by_kernel)
    after = (engine.captures, engine.eager_calls)
    proposed = int(engine._spec_proposed_total.value) - p0
    accepted = int(engine._spec_accepted_total.value) - a0
    sp = engine.stats()["engine"]["spec"]
    diffs = first_differences(engine._params, config, requests, greedy,
                              streams)
    off, ties = greedy_gaps(engine._params, config, requests, streams)
    tied = [d for d in diffs if d[2] <= DECODE_TIE_GAP]
    drafter = engine._drafter
    planned = (len(rungs) + len(engine.spec_ladder)) * config.n_layers * 2
    if isinstance(drafter, decode._ModelDrafter):
        planned += (len(rungs) + 1) * drafter.config.n_layers * 2
    tokens = sum(len(t) for t in streams)
    out = {"streams": streams, "tokens_per_s": tokens / wall, "wall": wall,
           "proposed": proposed, "accepted": accepted,
           "acceptance": accepted / proposed if proposed else None,
           "k": sp["k"], "shifts": sp["shifts"], "launches": launches,
           "planned": planned, "signatures": sigs, "warm": warm,
           "after": after, "replays": engine.replays, "diffs": diffs,
           "draft_steps": getattr(drafter, "steps", 0),
           "contract": contract}
    acc = ("none" if out["acceptance"] is None
           else f"{out['acceptance']:.4f}")
    print(f"decode (e) {label}: {len(requests)} requests at once "
          f"{out['tokens_per_s']:.1f} tokens/s ({wall:.3f} s); streams "
          f"== (b)'s greedy: {streams == greedy} (first differences "
          f"(request, position, |logit gap|): {diffs}; near-ties within "
          f"{DECODE_TIE_GAP}: {len(tied)}); tokens not the full forward's "
          f"argmax {off} (near-ties {ties}); acceptance {acc} ({accepted} "
          f"of {proposed} drafts), final k {sp['k']} after {sp['shifts']} "
          f"shifts, {out['draft_steps']} draft steps; warmup captured "
          f"{warm[0]} of {sigs} signatures ({warm[1]} eager calls), after "
          f"serving {after[0]} and {after[1]}, {engine.replays} replays; "
          f"wrapper launches {launches} (planned {planned} each)",
          flush=True)
    if len(tied) != len(diffs):
        failures.append(f"(e) {label}: streams differ from the greedy "
                        f"engine's beyond a near-tie: {diffs}")
    if off != ties:
        failures.append(f"(e) {label}: {off - ties} tokens are not the "
                        f"full forward's greedy choice")
    if not (warm == (sigs, sigs) and after == warm and engine.replays > 0):
        failures.append(f"(e) {label}: captures {warm} -> {after}, "
                        f"signatures {sigs}, replays {engine.replays}")
    if launches != dict.fromkeys(PAGED_KERNELS.values(), planned):
        failures.append(f"(e) {label}: wrapper launches {launches}, "
                        f"planned {planned}")
    return out, failures, engine


def speculation_phase(config, params, requests, greedy, greedy_tps,
                      rungs) -> dict:
    """17(e) (see the module docstring): ``greedy`` and ``greedy_tps``
    are (b)'s streams and tokens/s.  Returns its numbers and failures."""
    import numpy as np

    from tensorflowonspark_torch import decode
    from tensorflowonspark_torch.kernels import _build
    from tensorflowonspark_torch.kernels import paged_attention as pa
    from tensorflowonspark_torch.models import tinylm

    t0 = time.perf_counter()
    failures, runs = [], {}
    draft_cfg = tinylm.Config.draft_for(config)
    engines = {
        "ngram": {"spec_drafter": "ngram"},
        "perfect model drafter": {"spec_drafter": "model",
                                  "draft_config": config,
                                  "draft_params": params},
        "cold model drafter": {
            "spec_drafter": "model", "draft_config": draft_cfg,
            "draft_params": {
                name: w if name.startswith("ln") else w * COLD_DRAFT_SCALE
                for name, w in tinylm.init_params(
                    draft_cfg, seed=DECODE_SEED + 1).items()}}}
    for label, spec in engines.items():
        out, fails, engine = spec_engine_run(label, config, params,
                                             requests, greedy, rungs,
                                             **spec)
        failures += fails
        runs[label] = out
        if label == "ngram":
            ngram = engine
            continue
        engine.stop()
        failures += [f"(e) {label}: {f}"
                     for f in engine_contract(engine, *out["contract"])]
    perfect, cold = runs["perfect model drafter"], runs["cold model drafter"]
    if not (perfect["proposed"] > 0 and perfect["acceptance"] == 1.0):
        failures.append(f"(e) the perfect drafter's acceptance "
                        f"{perfect['acceptance']} ({perfect['accepted']} of "
                        f"{perfect['proposed']})")
    if cold["shifts"] < 1:
        failures.append("(e) the cold drafter never moved the controller")

    # on the n-gram engine: top_k=1 (a point mass) is its greedy stream;
    # the verify step at k = 4 on the idle engine; a token choice that
    # accepts every draft must change the streams
    n_plant = DECODE_PLANTED_REQUESTS
    top1, _ = serve_all(ngram, requests, concurrent=True, sampling=[
        decode.SamplingParams(temperature=0.8, top_k=1, seed=i)
        for i in range(len(requests))])
    ngram._registry.clear()
    batches, pages = idle_step_batches(ngram, DECODE_SEED)
    rng = np.random.RandomState(DECODE_SEED)
    S, k = ngram.max_seqs, SPEC_TOKENS
    verify_batch = {
        "tokens": rng.randint(0, config.vocab_size,
                              size=(S, k + 1)).astype(np.int32),
        "seq_lens": rng.randint(16, ngram.max_len - k - 1,
                                size=(S,)).astype(np.int32),
        "step_lens": np.full((S,), k + 1, np.int32),
        "page_tables": batches["decode"]["page_tables"]}
    step = decode_step_numbers(ngram, "verify", verify_batch, ("captured",))
    ngram.pool.free(pages)
    per_kernel = dict.fromkeys(PAGED_KERNELS.values(), config.n_layers)
    if not (step["wrapper_launches"] == step["traced_launches"]
            == per_kernel):
        failures.append(f"(e) verify step launches: wrappers "
                        f"{step['wrapper_launches']}, traced replay "
                        f"{step['traced_launches']}")
    p0 = int(ngram._spec_proposed_total.value)
    ngram._choose_token = (lambda req, row, pos, draft=None: int(
        np.argmax(row)) if draft is None else int(draft))
    accept_all = serve_all(ngram, requests[:n_plant], concurrent=False)[0]
    planted_proposed = int(ngram._spec_proposed_total.value) - p0
    ngram.stop()
    failures += [f"(e) ngram: {f}"
                 for f in engine_contract(ngram, *runs["ngram"]["contract"])]

    # seeded sampling: two fresh engines, one sampled workload
    sampled = []
    policy = [decode.SamplingParams(seed=i, **SPEC_SAMPLING)
              for i in range(len(requests))]
    for _ in range(2):
        engine = decode.DecodeEngine(config, params, spec_tokens=SPEC_TOKENS,
                                     spec_drafter="ngram", **DECODE_ENGINE)
        engine.warmup()
        engine.start()
        sampled.append(serve_all(engine, requests, concurrent=True,
                                 sampling=policy)[0])
        engine.stop()

    # the planted off-by-one causal bound, on the verify path
    saved = pa._LIB
    try:
        pa._LIB = pa._bind(_build.load("paged_attention",
                                       PLANTED_OFF_BY_ONE))
        faulty = decode.DecodeEngine(config, params, spec_tokens=SPEC_TOKENS,
                                     spec_drafter="ngram", **DECODE_ENGINE)
        faulty.warmup()
        faulty.start()
        off_by_one = serve_all(faulty, requests[:n_plant],
                               concurrent=False)[0]
        faulty.stop()
    finally:
        pa._LIB = saved
    want = greedy[:n_plant]
    ngram_streams = runs["ngram"]["streams"]
    checks = {
        "seeded sampling the same on two engines":
            sampled[0] == sampled[1],
        "sampling not greedy": sampled[0] != ngram_streams,
        "top_k=1 the greedy streams": top1 == ngram_streams}
    caught = {"causal j < p on the verify path": off_by_one != want,
              "every draft accepted": (accept_all != want
                                       and planted_proposed > 0)}
    seconds = time.perf_counter() - t0
    print(f"decode (e) sampling (temperature 0.8, top-p 0.9, seed = "
          f"request): {checks}; planted faults caught: {caught}",
          flush=True)
    busy = step["captured"]["busy_ms"]
    busy = "not measured" if busy is None else format(busy, ".4f")
    print(f"decode (e) verify step, k = {k} ({S} x {k + 1} positions), "
          f"{S} live slots on an idle engine: launches a step by the "
          f"wrappers {step['wrapper_launches']}, by a traced replay "
          f"{step['traced_launches']}; captured "
          f"{step['captured']['host_us']:.1f} us a step (copy in, step, "
          f"copy out), busy {busy} ms (" + ", ".join(
              f"{n} {v:.4f}" for n, v in sorted(
                  step["captured"]["families_ms"].items(),
                  key=lambda kv: -kv[1])) + ")", flush=True)
    print(f"decode (e) tokens/s, 32 requests at once: (b) greedy "
          f"{greedy_tps:.1f}; " + "; ".join(
              f"{label} {r['tokens_per_s']:.1f} (acceptance "
              f"{r['acceptance']}, final k {r['k']})"
              for label, r in runs.items())
          + f"; (e) {seconds:.1f} s (budget {SPEC_BUDGET_S} s)", flush=True)
    failures += [f"(e) not: {name}" for name, ok in checks.items()
                 if not ok]
    failures += [f"(e) planted {name} not caught"
                 for name, ok in caught.items() if not ok]
    return {"runs": runs, "verify_step": step, "seconds": seconds,
            "failures": failures,
            "launches": {name: sum(r["launches"][name]
                                   for r in runs.values())
                         for name in PAGED_KERNELS.values()}}


def decode_phase() -> dict:
    """Phase 17 (see the module docstring)."""
    import numpy as np
    import torch

    from tensorflowonspark_torch import decode, obs, shapes
    from tensorflowonspark_torch.kernels import _build
    from tensorflowonspark_torch.kernels import paged_attention as pa
    from tensorflowonspark_torch.models import tinylm

    t17 = time.perf_counter()
    failures, seconds = [], {}
    planted = {d: (None if _build._cached("paged_attention", d)
                   else _build._start("paged_attention", _build.find_nvcc(),
                                      d))
               for d in (PLANTED_OFF_BY_ONE, PLANTED_APPEND)}
    config = tinylm.Config()
    params = tinylm.init_params(config, seed=DECODE_SEED)
    requests = decode_workload()
    tokens_out = sum(n for _, n in requests)

    # (a) the kernels against their plain twins
    t0 = time.perf_counter()
    rungs = shapes.prefill_chunks(
        DECODE_ENGINE["max_prompt_len"], DECODE_ENGINE["page_size"],
        max_chunk=decode.DEFAULT_PREFILL_CHUNK_PAGES
        * DECODE_ENGINE["page_size"])
    kern, kern_failures = paged_kernel_phase(
        rungs, shapes.spec_ladder(SPEC_TOKENS),
        tinylm.Config.draft_for(config))
    failures += kern_failures
    seconds["a"] = time.perf_counter() - t0

    # (b) the engine, greedy: the main path, counted from construction
    t0 = time.perf_counter()
    pa.reset_launches()
    engine = decode.DecodeEngine(config, params, **DECODE_ENGINE)
    contract = (engine.kv_pool_bytes,
                (engine._kp.data_ptr(), engine._vp.data_ptr()))
    w0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - w0
    sigs = len(engine.enumerate_signatures())
    warm = (engine.captures, engine.eager_calls)
    engine.start()
    hists = {n: dict(obs.get_registry().peek(n).cumulative())
             for n in ("decode_ttft_seconds", "decode_itl_seconds")}
    conc, conc_s = serve_all(engine, requests, concurrent=True)
    latency = {"ttft": hist_quantiles("decode_ttft_seconds",
                                      hists["decode_ttft_seconds"]),
               "itl": hist_quantiles("decode_itl_seconds",
                                     hists["decode_itl_seconds"]),
               "window": engine.slo_snapshot()}
    seq, seq_s = serve_all(engine, requests, concurrent=False)
    main_launches = dict(pa.launches_by_kernel)
    after = (engine.captures, engine.eager_calls)
    kv = engine.stats()["admission"]["kv"]
    off, ties = greedy_gaps(engine._params, config, requests, conc)
    legacy = decode.DecodeEngine(config, params, prefill_chunk=0,
                                 **DECODE_ENGINE)
    legacy_contract = (legacy.kv_pool_bytes,
                       (legacy._kp.data_ptr(), legacy._vp.data_ptr()))
    legacy.warmup()
    legacy.start()
    legacy_out, legacy_s = serve_all(legacy, requests, concurrent=True)
    legacy.stop()
    failures += engine_contract(legacy, *legacy_contract)
    # each signature's eager call and capture launch each kernel a layer
    planned = (len(rungs) + 1) * config.n_layers * 2
    lengths_ok = all(len(s) == n for s, (_, n) in zip(conc, requests))
    print(f"decode (b) tinylm.Config() {engine.max_seqs} slots x "
          f"{engine.pages_per_seq} pages of {engine.page_size}, "
          f"{len(requests)} greedy requests (prompts "
          f"{min(len(p) for p, _ in requests)}-"
          f"{max(len(p) for p, _ in requests)}, {tokens_out} tokens) on "
          f"{engine.device}: concurrent streams == one at a time: "
          f"{conc == seq}; == a legacy-prefill engine's: "
          f"{conc == legacy_out}; tokens not the full forward's argmax "
          f"{off} (near-ties within {DECODE_TIE_GAP}: {ties}); prefix hits "
          f"{kv['prefix_hits_total']}, shared pages "
          f"{kv['shared_pages_total']}, COW copies {kv['cow_copies_total']};"
          f" warmup {warmup_s:.2f} s captured {warm[0]} of {sigs} "
          f"signatures ({warm[1]} eager calls), after serving "
          f"{after[0]} captures and {after[1]} eager calls, "
          f"{engine.replays} replays; wrapper launches {main_launches} "
          f"(planned {planned} each: the warmup's eager calls and "
          f"captures)", flush=True)
    if not (lengths_ok and conc == seq == legacy_out):
        failures.append("(b) streams differ: concurrent, sequential, "
                        "legacy or lengths")
    if off != ties:
        failures.append(f"(b) {off - ties} tokens are not the full "
                        f"forward's greedy choice")
    if not (kv["cow_copies_total"] > 0 and kv["prefix_hits_total"] > 0):
        failures.append("(b) no COW copy or no prefix hit")
    if not (warm[0] == sigs and after == warm and engine.replays > 0):
        failures.append(f"(b) captures {warm} -> {after}, signatures {sigs}")
    if main_launches != dict.fromkeys(PAGED_KERNELS.values(), planned):
        failures.append(f"(b) wrapper launches {main_launches}")

    # (b) planted faults: an off-by-one causal bound, stale static inputs;
    # and (a)'s append gate on a build writing the slot after p
    saved = pa._LIB
    try:
        for job in planted.values():
            if job is not None:
                _build._finish("paged_attention", job)
        pa._LIB = pa._bind(_build.load("paged_attention", PLANTED_APPEND))
        append_caught = not any(
            append_against_twin(paged_case(paged_case_rows(label, L), L, 65,
                                           180 + L), 128)[0]
            for label, L in (("decode", 1), (f"chunk{rungs[-1]}",
                                             rungs[-1])))
        pa._LIB = pa._bind(_build.load("paged_attention",
                                       PLANTED_OFF_BY_ONE))
        faulty = decode.DecodeEngine(config, params, **DECODE_ENGINE)
        faulty.warmup()
        faulty.start()
        off_by_one = serve_all(faulty, requests[:DECODE_PLANTED_REQUESTS],
                               concurrent=False)[0]
        faulty.stop()
    finally:
        pa._LIB = saved
    stale_engine = decode.DecodeEngine(config, params, **DECODE_ENGINE)
    stale_engine.warmup()
    stale_engine._refresh = lambda staged, arrays: None
    stale_engine.start()
    stale = serve_all(stale_engine, requests[:DECODE_PLANTED_REQUESTS],
                      concurrent=False)[0]
    stale_engine.stop()
    want = conc[:DECODE_PLANTED_REQUESTS]
    caught = {"causal j < p": off_by_one != want,
              "stale static inputs": stale != want,
              "append at p + 1": append_caught}
    print(f"decode (b) planted faults caught (the stream gate; the append's"
          f" by (a)'s bit-for-bit gate): {caught}", flush=True)
    failures += [f"(b) planted {k} not caught" for k, v in caught.items()
                 if not v]
    seconds["b"] = time.perf_counter() - t0

    # (c) timing on an idle engine; the registry's pinned pages released,
    # so that the timed steps' tables take every page
    t0 = time.perf_counter()
    engine._registry.clear()
    batches, pages = idle_step_batches(engine, DECODE_SEED)
    steps = {kind: decode_step_numbers(
        engine, kind, batch,
        ("eager", "captured") if kind == "decode" else ("captured",))
        for kind, batch in batches.items()}
    engine.pool.free(pages)
    per_kernel = dict.fromkeys(PAGED_KERNELS.values(), config.n_layers)
    for kind, s in steps.items():
        if not (s["wrapper_launches"] == s["traced_launches"]
                == per_kernel):
            failures.append(f"(c) {kind} step launches: wrappers "
                            f"{s['wrapper_launches']}, traced replay "
                            f"{s['traced_launches']}")
    card = torch.cuda.get_device_name(0)

    def fmt(v, spec):
        return "not measured" if v is None else format(v, spec)

    print(f"decode (c) on {card}: aggregate {tokens_out / conc_s:.1f} "
          f"tokens/s ({len(requests)} requests at once, {conc_s:.3f} s), "
          f"one at a time {tokens_out / seq_s:.1f} tokens/s ({seq_s:.3f} "
          f"s), legacy-prefill engine at once {tokens_out / legacy_s:.1f};"
          f" TTFT p50/p99 {latency['ttft']['p50_ms']}/"
          f"{latency['ttft']['p99_ms']} ms and ITL p50/p99 "
          f"{latency['itl']['p50_ms']}/{latency['itl']['p99_ms']} ms "
          f"(histogram bucket bounds; window p99s "
          f"{latency['window']['ttft_p99_ms']}/"
          f"{latency['window']['itl_p99_ms']} ms)", flush=True)
    for kind, s in steps.items():
        print(f"decode (c) {kind} step on an idle engine, "
              f"{engine.max_seqs} live slots: launches a step by the "
              f"wrappers {s['wrapper_launches']}, by a traced replay "
              f"{s['traced_launches']}; " + "; ".join(
                  f"{mode} {s[mode]['host_us']:.1f} us a step (copy in, "
                  f"step, copy out), busy {fmt(s[mode]['busy_ms'], '.4f')}"
                  f" ms (" + ", ".join(
                      f"{k} {v:.4f}" for k, v in sorted(
                          s[mode]["families_ms"].items(),
                          key=lambda kv: -kv[1]))
                  + f"), idle {fmt(s[mode]['idle_share'], '.1%')}"
                  for mode in ("eager", "captured") if mode in s),
              flush=True)
    seconds["c"] = time.perf_counter() - t0

    # (d) one streamed generation over HTTP
    t0 = time.perf_counter()
    prompt, n = requests[3]
    streamed = http_generation(engine, prompt, n)
    http_ok = streamed == conc[3]
    print(f"decode (d) POST /v1/generate streamed {len(streamed)} tokens; "
          f"equal to the engine's: {http_ok}", flush=True)
    if not http_ok:
        failures.append("(d) the HTTP stream differs from the engine's")
    replays = engine.replays
    engine.stop()
    failures += engine_contract(engine, *contract)
    seconds["d"] = time.perf_counter() - t0

    # (e) speculation and seeded sampling on (b)'s requests
    spec = speculation_phase(config, params, requests, conc,
                             tokens_out / conc_s, rungs)
    failures += spec["failures"]
    seconds["e"] = spec["seconds"]
    total = time.perf_counter() - t17
    print(f"decode phase 17 seconds: (a) {seconds['a']:.1f}, (b) "
          f"{seconds['b']:.1f}, (c) {seconds['c']:.1f}, (d) "
          f"{seconds['d']:.1f}, (e) {seconds['e']:.1f} (budget "
          f"{SPEC_BUDGET_S} s); phase 17 {total:.1f} (budget "
          f"{PHASE17_BUDGET_S} s)", flush=True)
    if failures:
        raise SystemExit("decode phase 17 failed: " + "; ".join(failures))
    for name in PAGED_KERNELS.values():  # the profiler's ms a launch
        for label, kind in (("decode", "decode"),
                            (f"chunk{rungs[-1]}", "chunk")):
            kern[label][name]["device_ms"] = (
                steps[kind]["captured"]["families_ms"].get(name, 0.0)
                / config.n_layers)
    return {"kernels": kern, "launches": main_launches,
            "replay_traced": {k: steps["decode"]["traced_launches"].get(k, 0)
                              + steps["chunk"]["traced_launches"].get(k, 0)
                              for k in PAGED_KERNELS.values()},
            "steps": steps, "replays": replays, "seconds": total,
            "spec_launches": spec["launches"],
            "tokens_per_s": tokens_out / conc_s,
            "sequential_tokens_per_s": tokens_out / seq_s}


def phase17_entries(decode_result: dict) -> list:
    """The kernels line's entries of the two paged kernels: the decode
    step's case (the main path's shape) and the others suffixed."""
    sources = "tensorflowonspark_torch/csrc/paged_attention.cu"
    replaces = {"kv_append": "tensorflowonspark_tpu/models/tinylm.py:318",
                "paged_attention": "tensorflowonspark_tpu/models/tinylm.py:320"}
    out = []
    for name in PAGED_KERNELS.values():
        kern = {label: res[name]
                for label, res in decode_result["kernels"].items()}
        main = kern["decode"]
        entry = {"name": f"tfos_{name}", "route": "cuda", "source": sources,
                 "replaces": replaces[name],
                 "launches": decode_result["launches"][name],
                 "launches_phase17": decode_result["launches"][name],
                 "launches_phase17e":
                     decode_result.get("spec_launches", {}).get(name),
                 "replay_launches_phase17":
                     decode_result["replay_traced"][name],
                 **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms", "device_ms",
                                         "cupti_ms") if k in main}}
        for label, res in kern.items():
            if label != "decode":
                entry.update({f"{k}_{label}": res[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "library_ms", "device_ms", "cupti_ms") if k in res})
        out.append(entry)
    return out


# ---------------------------------------------------------------------------
# Phase 18: BatchNorm training (ResNet-50 and Inception-v3, norm="batch")
# ---------------------------------------------------------------------------

PHASE18_BUDGET_S = 60
BN_GRAD_BATCH = 8
#: (b): 8 captured steps against 8 eager ones at these batches (halved
#: from 64 and 32 to pay for phase 19: the gate is bit for bit at any
#: batch); the rates at the larger ones, eager beside captured, over
#: ``BN_TIMED_STEPS`` timed steps a mode (phase 16's 5) and
#: ``BN_PROFILED_STEPS`` profiled ones (phase 16's 3)
BN_STEP_BATCH = {"resnet50": 32, "inception_v3": 16}
BN_RATE_BATCH = {"resnet50": 256, "inception_v3": 128}
BN_TIMED_STEPS = 3
BN_PROFILED_STEPS = 1
#: (a): the running statistics after one step against flax's rule
#: recomputed on the host in f64 from that batch's norm inputs, max |Δ|
#: over max |host| of each site's mean and var.  Only the f32 sums over
#: N·H·W differ in order (≈ 1e-6); an unbiased running variance (torch's
#: ``batch_norm``) moves the last stage's (392 values a channel at 8 rows)
#: by 0.1/391 of its variance, ≈ 2.6e-4 of the statistic
BN_STATS_TOL = 2e-5
#: (a): one step's gradients at 8 rows, rel L2 over all parameters.  A
#: BatchNorm ResNet-50 at init is ill-conditioned: measured on the CPU at
#: 224², batch 8, seed 3 (f32), a 1e-7 relative change of the images moves
#: the gradients by 2.55e-2, bf16 sits 1.33 from f32 (the early convs'
#: gradients, 10² larger than GroupNorm's, are noise-dominated), and
#: statistics detached from autograd (a classic BatchNorm fault) 1.47.  So
#: the card's f32 twin is held to the same step run on the host CPU in
#: f32, where the planted fault must read above the gate
BN_GRADS_F32_VS_HOST = 0.1
#: (a): the bf16 step where an uncorrelated result would fail.  Its
#: gradients are not held to f32: at init the bf16 step's sit 1.2-1.35
#: from f32 below the head (an uncorrelated one reads 1.41), and its
#: logits 0.119 and head gradients 0.115 (measured on an H100): the head's
#: zero-mean weights cancel the features' common mean, and each
#: BatchNorm backward subtracts from the bf16 dy its batch mean and its
#: projection on x̂, so rounding grows through the net.  Instead each of
#: the step's 53 BatchNorm sites, recorded in the step, is held to flax's
#: BatchNorm(+add)(+ReLU) in f64 on that site's own bf16 inputs, output
#: and input gradient (rel L2): bf16 rounds each by ≈ 2⁻⁹, so predicted
#: 2e-3-5e-3 a site before the first card run (CPU, tiny config: worst
#: 2.2e-3 and 1.7e-3; the statistics cut from autograd 0.34).  A halved
#: dx reads 0.5, an uncorrelated one √2.  The loss, which the net
#: conditions well, is held to the f32 twin's (2.2e-3 apart there); a
#: forward that lost ``train`` must read above that
BN_BF16_SITE = 2e-2
BN_BF16_LOSS_REL = 2e-2
#: (e): rows served (67 before phase 19: still 3 ragged partitions and an
#: odd tail) and the SPARK slice's rows, partitions and batch (128 at 64
#: before: 2 steps either way, the second a capture and its replay)
BN_SERVE_ROWS = 35
BN_SLICE_ROWS = 64
BN_SLICE_PARTITIONS = 2
BN_SLICE_BATCH = 32
BN_FAMILIES = ("convs", "BatchNorm statistics",
               "BatchNorm apply and backward", "GroupNorm kernels",
               "casts/pads/pool", "AdamW", "other")
#: forward ops and autograd nodes of the casts, pads and pools around the
#: norms (the family phase 6 calls casts/pads/pool)
_CAST_POOL = ("aten::to", "aten::_to_copy", "aten::copy_", "aten::clone",
              "aten::contiguous", "aten::constant_pad_nd", "aten::pad",
              "aten::max_pool2d", "aten::max_pool2d_with_indices",
              "aten::avg_pool2d", "aten::permute", "ToCopyBackward",
              "ConstantPadNdBackward", "MaxPool2DWithIndicesBackward",
              "AvgPool2DBackward", "CloneBackward", "PermuteBackward")
_CONV_KERNELS = ("conv", "fprop", "dgrad", "wgrad", "xmma", "gemm",
                 "cudnn", "implicit", "cutlass", "nvjet", "sm90_")
_EVALUATE = "autograd::engine::evaluate_function: "


def bn_configs() -> dict:
    """Phase 18's models at their published widths: ``{zoo name: (module,
    config)}``."""
    from tensorflowonspark_torch.models import inception, resnet

    return {"resnet50": (resnet, resnet.Config(norm="batch")),
            "inception_v3": (inception, inception.Config(canonical=True,
                                                         norm="batch"))}


def bn_sites(model) -> list:
    """The module names of ``model``'s BatchNorms (each owns a ``mean`` and
    a ``var`` buffer), in forward order."""
    return [name.rsplit(".", 1)[0] for name, _ in model.named_buffers()
            if name.endswith(".mean")]


def bn_norm_inputs(model, sites):
    """Forward pre-hooks that keep each BatchNorm's first input
    (``{site: x}``) and the handles that remove them."""
    inputs, handles = {}, []
    modules = dict(model.named_modules())
    for site in sites:
        def hook(_m, args, site=site):
            inputs.setdefault(site, args[0].detach().clone())
        handles.append(modules[site].register_forward_pre_hook(hook))
    return inputs, handles


def bn_running_expected(inputs: dict, before: dict) -> dict:
    """flax's running update recomputed on the host in f64: for each site
    ``momentum·r + (1 − momentum)·s`` with ``s`` the batch's mean and
    BIASED variance of the norm's input over N, H and W."""
    from tensorflowonspark_torch.models import _common

    m = _common.BATCH_NORM_MOMENTUM
    out = {}
    for site, x in inputs.items():
        x = x.double().cpu()
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean.view(1, -1, 1, 1)) ** 2).mean(dim=(0, 2, 3))
        for key, stat in (("mean", mean), ("var", var)):
            out[f"{site}.{key}"] = (m * before[f"{site}.{key}"].double().cpu()
                                    + (1 - m) * stat)
    return out


def bn_stats_gap(got: dict, want: dict) -> tuple:
    """``(worst, its buffer)``: the largest max |got − want| / max |want|
    over the running statistics."""
    worst, where = 0.0, None
    for k, w in want.items():
        g = got[k].double().cpu()
        gap = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-12)
        if gap > worst:
            worst, where = gap, k
    return worst, where


class swapped:
    """While active, ``module.<name>`` is ``make(the original)``."""

    def __init__(self, module, name: str, make):
        self.module, self.name, self.make = module, name, make

    def __enter__(self):
        self.saved = getattr(self.module, self.name)
        setattr(self.module, self.name, self.make(self.saved))
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def detached_statistics(plain):
    """The planted fault of 18(a)'s gradient gates, ``make`` for
    :class:`swapped` over ``_common.batch_norm`` (``plain``): in training,
    the batch's mean and biased variance cut from autograd (the backward
    loses its centering terms); the running update and the rest as
    ``plain``."""
    import torch

    from tensorflowonspark_torch.models import _common

    def batch_norm(x, scale, bias, running_mean, running_var, train,
                   residual=None, relu=True):
        if not train:
            return plain(x, scale, bias, running_mean, running_var, False,
                         residual, relu)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       unbiased=False)
        _common.update_running_(running_mean, running_var, mean, torch.rsqrt(
            var + _common.BATCH_NORM_EPS))
        return plain(x, scale, bias, mean, var, False, residual, relu)

    return batch_norm


def recording(records: list):
    """``make`` for :class:`swapped` over ``_common.batch_norm``: each
    training call of the original appends ``{x, scale, bias, residual,
    relu, y}`` to ``records`` and, once the backward has run, the
    gradients of its output (``dy``) and of its input (``dx``: the conv's
    output feeds nothing else)."""
    def make(plain):
        def batch_norm(x, scale, bias, running_mean, running_var, train,
                       residual=None, relu=True):
            y = plain(x, scale, bias, running_mean, running_var, train,
                      residual, relu)
            if train:
                rec = {"x": x.detach().clone(),
                       "scale": scale.detach().clone(),
                       "bias": bias.detach().clone(),
                       "residual": None if residual is None
                       else residual.detach().clone(),
                       "relu": relu, "y": y.detach().clone()}
                x.register_hook(lambda g: rec.__setitem__("dx", g.clone()))
                y.register_hook(lambda g: rec.__setitem__("dy", g.clone()))
                records.append(rec)
            return y

        return batch_norm

    return make


def site_reference(rec: dict) -> tuple:
    """flax's BatchNorm(+add)(+ReLU) in f64 on one recorded site's own
    inputs: ``(y, dx)``, normalised by the batch's mean and biased
    variance over N, H and W, ``dx`` by autograd from the site's ``dy``;
    the ReLU's mask is the recorded output's (a discrete choice at values
    that round to 0)."""
    import torch

    from tensorflowonspark_torch.models import _common

    x = rec["x"].double().requires_grad_()
    shape = (1, -1, 1, 1)
    mean = x.mean(dim=(0, 2, 3))
    var = ((x - mean.view(shape)) ** 2).mean(dim=(0, 2, 3))
    y = ((x - mean.view(shape))
         * torch.rsqrt(var + _common.BATCH_NORM_EPS).view(shape)
         * rec["scale"].double().view(shape)
         + rec["bias"].double().view(shape))
    if rec["residual"] is not None:
        y = y + rec["residual"].double()
    if rec["relu"]:
        y = y * (rec["y"] > 0)
    y.backward(rec["dy"].double())
    return y.detach(), x.grad


def bn_site_gaps(model, loss_fn, batch, make=None) -> dict:
    """18(a)'s bf16 site gate: one step of ``model`` (its BatchNorm
    through ``make`` of the plain one if given, for a planted fault) with
    every BatchNorm recorded (:func:`recording`), then each site's output
    and input gradient against :func:`site_reference` on that site's own
    inputs, rel L2: ``{"y": worst, "dx": worst, "sites": n, "at": the
    worst dx's site}``, and the same dx readings of the recorded
    gradients halved and permuted within each tensor (uncorrelated, the
    same norm).  The model's running statistics move."""
    import contextlib

    import torch

    from tensorflowonspark_torch.kernels import group_norm
    from tensorflowonspark_torch.models import _common

    records = []
    with contextlib.ExitStack() as stack:
        if make is not None:
            stack.enter_context(swapped(_common, "batch_norm", make))
        stack.enter_context(swapped(_common, "batch_norm",
                                    recording(records)))
        loss = float(_grads(model, loss_fn, batch,
                            group_norm.group_norm_act_plain)[1])
    gen = torch.Generator().manual_seed(0)
    out = {"loss": loss, "sites": len(records), "y": 0.0, "dx": 0.0,
           "at": None, "dx halved": 0.0, "dx uncorrelated": 0.0}
    for i, rec in enumerate(records):
        y, dx = site_reference(rec)
        got = rec["dx"].double()
        perm = torch.randperm(got.numel(), generator=gen).to(got.device)
        gaps = {"y": _rel_l2({0: rec["y"]}, {0: y}),
                "dx": _rel_l2({0: got}, {0: dx}),
                "dx halved": _rel_l2({0: 0.5 * got}, {0: dx}),
                "dx uncorrelated": _rel_l2(
                    {0: got.flatten()[perm].view_as(got)}, {0: dx})}
        if gaps["dx"] >= out["dx"]:
            out["at"] = i
        for k, v in gaps.items():
            out[k] = max(out[k], v) if k in ("y", "dx") else (
                min(out[k], v) if i else v)
        del rec, y, dx, got
    return out


def bf16_gate(loss32: float, good: dict, faults: dict) -> list:
    """The breaches of 18(a)'s bf16 readings: the loss off its f32 twin's
    by more than ``BN_BF16_LOSS_REL``; a site's output or input gradient
    off f64 on its own inputs by more than ``BN_BF16_SITE``; or a planted
    fault that reads at or below the gate it must break (``faults``:
    :func:`bn_site_gaps` of the step with its statistics cut from
    autograd, and of a forward that lost ``train``, which normalises by
    the running statistics)."""
    def loss_gap(r):
        return abs(r["loss"] - loss32) / abs(loss32)

    out = [f"bf16 {k} {good[k]:.3e}" for k in ("y", "dx")
           if good[k] > BN_BF16_SITE]
    if loss_gap(good) > BN_BF16_LOSS_REL:
        out.append(f"bf16 loss {loss_gap(good):.3e}")
    if not good["sites"]:
        out.append("no BatchNorm site recorded")
    misses = {"dx halved": good["dx halved"] <= BN_BF16_SITE,
              "dx uncorrelated": good["dx uncorrelated"] <= BN_BF16_SITE,
              "detached statistics dx":
                  faults["detached statistics"]["dx"] <= BN_BF16_SITE,
              "lost train loss":
                  loss_gap(faults["lost train"]) <= BN_BF16_LOSS_REL}
    return out + [f"planted {k} MISSED" for k, v in misses.items() if v]


def lost_train(plain):
    """A planted fault of 18(a), ``make`` for :class:`swapped` over
    ``_common.batch_norm``: training normalises by the running statistics
    (the ``train`` flag lost on its way down)."""
    def batch_norm(x, scale, bias, running_mean, running_var, train,
                   residual=None, relu=True):
        return plain(x, scale, bias, running_mean, running_var, False,
                     residual, relu)

    return batch_norm


def torch_batch_norm(x, scale, bias, running_mean, running_var, train,
                     residual=None, relu=True):
    """The planted fault of 18(a): ``F.batch_norm`` with torch's running
    update (its momentum 0.1 is flax's 0.9, but its running variance is the
    UNBIASED one) in ``_common.batch_norm``'s place."""
    import torch
    import torch.nn.functional as F

    y = F.batch_norm(x.float(), running_mean, running_var, scale, bias,
                     training=train, momentum=0.1,
                     eps=1e-5).to(x.dtype)
    if residual is not None:
        y = residual + y
    return torch.relu(y) if relu else y


def bn_stats_case(name: str, config, batch: dict, device: str = "cuda",
                  planted: bool = False) -> tuple:
    """One ``Trainer.step`` of a fresh BatchNorm trainer on ``batch``: the
    running statistics against :func:`bn_running_expected` of the norms'
    inputs (:func:`bn_stats_gap`): ``(worst, its buffer, every site seen,
    sites)``; ``planted`` runs the step with :func:`torch_batch_norm`
    swapped in."""
    from tensorflowonspark_torch.models import _common
    from tensorflowonspark_torch.trainer import Trainer

    t = Trainer(name, config=config, learning_rate=TRAIN_LR, seed=0,
                device=device)
    sites = bn_sites(t.model)
    before = {k: v.clone() for k, v in t.model.named_buffers()}
    inputs, handles = bn_norm_inputs(t.model, sites)
    plain = _common.batch_norm
    if planted:
        _common.batch_norm = torch_batch_norm
    try:
        t.step(batch)
    finally:
        _common.batch_norm = plain
        for h in handles:
            h.remove()
    want = bn_running_expected(inputs, before)
    got = dict(t.model.named_buffers())
    complete = sorted(want) == sorted(got) and len(sites) == len(inputs)
    return (*bn_stats_gap(got, want), complete, len(sites))


def eval_bits(predict, images, row: int) -> dict:
    """18(c): row ``row`` of ``images`` scored by ``predict`` inside
    ``images``, inside another batch (the other rows replaced by their
    reverse) and alone (the other rows zero, as the serving plane pads a
    short batch), at the same shape: whether the logits are the same bits
    each time, and the largest gap."""
    import torch

    other = images.flip(0).clone()
    other[row] = images[row]
    alone = torch.zeros_like(images)
    alone[row] = images[row]
    got = [predict(x)[row].float() for x in (images, other, alone)]
    same = all(bool(torch.equal(got[0], g)) for g in got[1:])
    gap = max(float((got[0] - g).abs().max()) for g in got[1:])
    return {"same_bits": same, "max_gap": gap}


def train_mode_predict(trainer):
    """The planted fault of 18(c): a predict that runs the train-mode
    forward (batch statistics) without autograd; it puts the running
    statistics back after each call."""
    import torch

    def predict(images):
        buffers = {k: v.clone() for k, v in trainer.model.named_buffers()}
        with torch.no_grad():
            out = trainer.model(images, train=True)
            for k, v in trainer.model.named_buffers():
                v.copy_(buffers[k])
        return out[0] if isinstance(out, tuple) else out

    return predict


def _in_range(name: str):
    """``make`` for :class:`swapped`: the original, run inside the
    profiler range ``name``."""
    from torch.profiler import record_function

    def make(plain):
        def fn(*args, **kwargs):
            with record_function(name):
                return plain(*args, **kwargs)

        return fn

    return make


def bn_annotated():
    """While active, ``_common.batch_norm`` runs inside a
    ``tfos::batch_norm`` profiler range and its running update inside
    ``tfos::bn_stats``: the ranges
    :func:`step_families` reads.  Only the profiled steps carry them."""
    import contextlib

    from tensorflowonspark_torch.models import _common

    stack = contextlib.ExitStack()
    for attr, name in (("batch_norm", "tfos::batch_norm"),
                       ("update_running_", "tfos::bn_stats")):
        stack.enter_context(swapped(_common, attr, _in_range(name)))
    return stack


def _bn_sequence_numbers(events) -> set:
    """The autograd sequence numbers of the forward ops inside a
    ``tfos::batch_norm`` range: their backward nodes carry the same."""
    out = set()
    for e in events:
        if getattr(e, "sequence_nr", -1) < 0:
            continue
        node = e.cpu_parent
        while node is not None:
            if node.name == "tfos::batch_norm":
                out.add(e.sequence_nr)
                break
            node = node.cpu_parent
    return out


def event_family(event, kernel: str, bn_seq: set) -> str:
    """The family of a device kernel named ``kernel`` launched by the host
    op ``event``: the hand-written and library kernels by name (the fused
    BatchNorm's statistics kernels too), the rest by
    the op's ancestry (a ``tfos::`` range; a backward node whose forward
    op ran inside ``tfos::batch_norm``; a cast, pad or pool op or its
    backward)."""
    name = kernel.lower()
    if "gn_" in name:
        return "GroupNorm kernels"
    if "batch_norm_collect_statistics" in name:
        return "BatchNorm statistics"
    if any(k in name for k in ("adam", "multi_tensor", "foreach")):
        return "AdamW"
    if any(k in name for k in _CONV_KERNELS):
        return "convs"
    node, cast = event, False
    while node is not None:
        op = node.name
        if op == "tfos::bn_stats":
            return "BatchNorm statistics"
        if op == "tfos::batch_norm":
            return "BatchNorm apply and backward"
        if op.startswith(_EVALUATE):
            if node.sequence_nr in bn_seq:
                return "BatchNorm apply and backward"
            cast = cast or op[len(_EVALUATE):].startswith(_CAST_POOL)
            break
        if "Adam" in op:
            return "AdamW"
        cast = cast or op.startswith(_CAST_POOL)
        node = node.cpu_parent
    return "casts/pads/pool" if cast else "other"


def step_families(events, launches) -> dict:
    """ms by :data:`BN_FAMILIES` of ``launches`` (``(host op, kernel name,
    ms)``), the sequence numbers read from the host ops ``events``."""
    bn_seq = _bn_sequence_numbers(list(events))
    fams = dict.fromkeys(BN_FAMILIES, 0.0)
    for op, kernel, ms in launches:
        fams[event_family(op, kernel, bn_seq)] += ms
    return fams


def _depth(event) -> int:
    n = 0
    while event.cpu_parent is not None:
        event, n = event.cpu_parent, n + 1
    return n


def kernels_by_op(events, calls: int = 1):
    """``(host op, kernel name, ms per call)`` of each device kernel
    torch.profiler attached to a host op, once.  The profiler attaches a
    kernel to every host event of its correlation id, and the ids of ops
    and of its own bookkeeping events ("Activity Buffer Request") can
    collide: within a group of one id the kernels count once, on the op
    (a ``::`` name that is no user annotation, the deepest)."""
    groups: dict = {}
    for e in events:
        if launched_kernels(e):
            groups.setdefault(e.id, []).append(e)
    for group in groups.values():
        op = max(group, key=lambda e: (
            not getattr(e, "is_user_annotation", False), "::" in e.name,
            _depth(e)))
        for name, ms in launched_kernels(op, calls):
            yield op, name, ms


def launched_kernels(event, calls: int = 1) -> list:
    """``(name, ms per call)`` of the device kernels torch.profiler
    attached to the host op ``event``, less the device span of a user
    annotation (a ``record_function`` range or an optimizer's
    ``Optimizer.step#...``), which the profiler attaches to its range
    like a kernel and which covers kernels counted already."""
    return [(k.name, k.duration / 1e3 / calls)
            for k in getattr(event, "kernels", ())
            if k.name != event.name and not _ANNOTATION.match(k.name)]


def profile_step_families(trainer, batch, steps: int = 3) -> dict:
    """Device ms a step by family (:func:`step_families` over the kernels
    torch.profiler attaches to their host ops) of ``steps`` eager steps
    (a replay has no host ops to attribute), with every kernel's sum
    beside (``busy``): what no op claimed reads as ``unattributed``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step = trainer.train_step
    trainer.train_step = eager_step(trainer)
    trainer.step(batch)
    try:
        with bn_annotated(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                trainer.step(batch)
            torch.cuda.synchronize()
    finally:
        trainer.train_step = step
    events = prof.events()
    fams = step_families(events, kernels_by_op(events, steps))
    busy = sum(ms for _, ms in device_kernels(prof, steps))
    fams["unattributed"] = busy - sum(fams.values())
    fams["busy"] = busy
    return fams


def bn_train_map_fun(args, ctx):
    """18(e)'s SPARK-mode ``map_fun``: a BatchNorm ResNet-50 ``Trainer``
    fed by ``DataFeed``; publishes its losses, the GroupNorm launches of
    its steps, its graph replays (the capture's included) and its
    device."""
    from tensorflowonspark_torch import metrics
    from tensorflowonspark_torch.kernels import group_norm
    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.trainer import Trainer

    trainer = Trainer("resnet50", config=resnet.Config(**args["config"]),
                      learning_rate=args["lr"], seed=args["seed"])
    trainer.add_step_callback(metrics.MetricsReporter(ctx, interval=1))
    feed = ctx.get_data_feed(train_mode=True,
                             input_mapping=["image", "label"], prefetch=2)
    ctx.mgr.set("ready", True)
    group_norm.reset_launches()
    losses = []
    while not feed.should_stop():
        batch = feed.next_batch(args["batch"], device_put=trainer.shard)
        if not batch or batch["image"].shape[0] == 0:
            continue
        losses.append(trainer.step(batch))
    ctx.mgr.set("launches", dict(group_norm.launches_by_path))
    ctx.mgr.set("graph_replays", trainer.train_step.replays)
    ctx.mgr.set("losses", [float(v) for v in losses])
    ctx.mgr.set("device", str(trainer.device))


def bn_slice(sc, config) -> dict:
    """18(e)'s SPARK-mode slice of a ResNet ``config`` (``norm="batch"``):
    ``TFCluster.run`` → ``cluster.train`` over ``BN_SLICE_ROWS`` rows in
    ``BN_SLICE_PARTITIONS`` partitions →
    ``DataFeed`` → ``Trainer.step`` at ``BN_SLICE_BATCH``, against the same
    batches stepped in this process."""
    import dataclasses

    import numpy as np
    import torch

    from tensorflowonspark_torch import TFCluster
    from tensorflowonspark_torch.trainer import Trainer

    side = config.image_size
    rng = np.random.RandomState(18)
    images = rng.rand(BN_SLICE_ROWS, side, side, 3).astype(np.float32)
    labels = rng.randint(0, config.num_classes, size=BN_SLICE_ROWS)
    args = {"batch": BN_SLICE_BATCH, "lr": TRAIN_LR, "seed": 0,
            "config": dataclasses.asdict(config)}
    t0 = time.perf_counter()
    cluster = TFCluster.run(sc, bn_train_map_fun, args, num_executors=1,
                            input_mode=TFCluster.InputMode.SPARK)
    [mgr] = node_managers(cluster)
    deadline = time.monotonic() + 600
    while not mgr.get("ready") and time.monotonic() < deadline:
        if mgr.get("state") == "failed":
            break
        time.sleep(0.2)
    cluster.train(sc.parallelize([(images[i], int(labels[i]))
                                  for i in range(BN_SLICE_ROWS)],
                                 BN_SLICE_PARTITIONS), feed_timeout=600)
    cluster.shutdown(grace_secs=120)
    job_s = time.perf_counter() - t0
    node = {k: mgr.get(k) for k in ("state", "losses", "launches",
                                    "graph_replays", "device")}
    t = Trainer("resnet50", config=config, learning_rate=TRAIN_LR, seed=0,
                device="cuda")
    replay = [float(t.step({"image": images[lo:lo + BN_SLICE_BATCH],
                            "label": labels[lo:lo + BN_SLICE_BATCH]}))
              for lo in range(0, BN_SLICE_ROWS, BN_SLICE_BATCH)]
    del t
    torch.cuda.empty_cache()
    losses = node["losses"] or []
    rel = (abs(losses[-1] - replay[-1]) / abs(replay[-1]) if losses
           else float("inf"))
    steps = BN_SLICE_ROWS // BN_SLICE_BATCH
    print(f"batch norm (e) SPARK slice TFCluster.run -> DataFeed -> "
          f"Trainer.step, resnet50 norm=batch on {node['device']}: state "
          f"{node['state']}, losses {[round(v, 5) for v in losses]}; "
          f"in-process {[round(v, 5) for v in replay]}; final rel "
          f"{rel:.3e} (tol {SLICE_TRAIN_VS_IN_PROCESS}); graph replays "
          f"{node['graph_replays']} (the capture's included); GroupNorm "
          f"launches {node['launches']}; job {job_s:.1f} s", flush=True)
    failures = []
    if (node["state"] != "finished" or len(losses) != steps
            or not all(math.isfinite(v) for v in losses)
            or rel > SLICE_TRAIN_VS_IN_PROCESS
            or (node["graph_replays"] or 0) < 1
            or not str(node["device"]).startswith("cuda")
            or any((node["launches"] or {"?": 1}).values())):
        failures.append(f"(e) slice: {node}, rel {rel:.3e}")
    return {"failures": failures, "launches": node["launches"] or {}}


def bn_serving(sc, trainer, work: str, name: str = "resnet50") -> dict:
    """18(e): ``trainer.export`` → ``TFModel.transform`` of
    ``BN_SERVE_ROWS`` rows in 3 partitions, by the serialized forward and
    by name (the same weights exported weights-only): each the bits of
    ``trainer.predict`` on the executor's padded batches."""
    import numpy as np
    import torch

    from tensorflowonspark_torch import ckpt, compat, sparkapi

    export = os.path.join(work, "bn_export")
    trainer.export(export)
    weights_only = export + "_weights_only"
    compat.export_saved_model(ckpt.load_pytree(os.path.join(export, "model")),
                              weights_only)
    side = trainer.config.image_size
    images = np.random.RandomState(19).rand(
        BN_SERVE_ROWS, side, side, 3).astype(np.float32)
    df = sparkapi.LocalSparkSession(sc).createDataFrame(
        [{"id": i, "image": images[i]} for i in range(BN_SERVE_ROWS)]
    ).repartition(3)
    sizes = [len(p) for p in df.rdd._partitions]
    want = scores_in_process(lambda x: trainer.predict({"image": x}),
                             images, sizes, SLICE_BATCH)
    failures, launches = [], collections.Counter()
    for label, model_name, d in (("serialized", None, export),
                                 ("by name", name, weights_only)):
        got = serve_export(sc, df, d, SLICE_BATCH, {"image": "image"},
                           "logits", model_name=model_name)
        bits = bool(torch.equal(got["scores"], want))
        err = (rel_err(got["scores"], want)
               if got["scores"].shape == want.shape else float("inf"))
        launches.update(got["executor"])
        print(f"batch norm (e) TFModel.transform ({label}) of the "
              f"{name} norm=batch export: {got['rows']} rows in {sizes}, "
              f"{got['seconds']:.3f} s; scores the bits of "
              f"Trainer.predict: {bits} (rel {err:.3e}); executor launches "
              f"{got['executor']}", flush=True)
        if got["rows"] != BN_SERVE_ROWS or not bits or any(
                got["executor"].values()):
            failures.append(f"(e) {label}: rows {got['rows']}, bits {bits}"
                            f", rel {err:.3e}")
    return {"failures": failures, "launches": dict(launches)}


def bn_rates(lib, config, name: str, n: int) -> dict:
    """18(b)'s numbers at ``n`` rows: :func:`graph_numbers` (rate, busy and
    idle, host, capture, peak memory allocated and reserved, eager beside
    captured) and the eager step's busy ms by family."""
    import torch

    from tensorflowonspark_torch.trainer import Trainer

    batch = {k: torch.from_numpy(v).cuda()
             for k, v in lib.example_batch(config, n, seed=18).items()}

    def make():
        return Trainer(name, config=config, learning_rate=TRAIN_LR,
                       device="cuda")

    out = graph_numbers(f"batch norm {name} batch {n}", make, batch,
                        "images", n, timed=BN_TIMED_STEPS,
                        profiled=BN_PROFILED_STEPS)
    t = make()
    out["families"] = profile_step_families(t, batch, BN_PROFILED_STEPS)
    del t
    gc.collect()
    torch.cuda.empty_cache()
    return out


def print_families(label: str, fams: dict) -> None:
    busy = fams.get("busy") or 0.0
    if not busy:
        print(f"batch norm families {label}: the profiler recorded no "
              f"device time (not measured)", flush=True)
        return
    print(f"batch norm families {label}, device ms a step (eager): busy "
          f"{busy:.3f}; " + ", ".join(
              f"{k} {v:.3f} ({v / busy:.1%})" for k, v in fams.items()
              if k != "busy" and v)
          + (" (NEGATIVE unattributed: a kernel counted twice)"
             if fams["unattributed"] < -1e-3 else ""), flush=True)


def batch_norm_phase(sc, work: str) -> dict:
    """Phase 18 (see the module docstring), in ``sc``'s application under
    ``work``: every sub-phase runs; the failures are gathered and fail the
    run at the end."""
    import dataclasses

    import torch

    from tensorflowonspark_torch.kernels import group_norm
    from tensorflowonspark_torch.models import _common
    from tensorflowonspark_torch.trainer import Trainer

    t_start = time.perf_counter()
    # the trainers and graph pools of earlier phases, held by reference
    # cycles, leave the card before the steps at 256
    gc.collect()
    torch.cuda.empty_cache()
    group_norm.reset_launches()
    before = flat_counts()
    failures = []
    configs = bn_configs()
    rlib, rconfig = configs["resnet50"]

    # (a) gradients against the f32 twin; the running statistics
    def device_batch(lib, config, n, seed):
        return {k: torch.from_numpy(v).cuda()
                for k, v in lib.example_batch(config, n, seed=seed).items()}

    batch = device_batch(rlib, rconfig, BN_GRAD_BATCH, 3)
    host_batch = {k: v.cpu() for k, v in batch.items()}
    model = rlib.make_model(rconfig, seed=0).cuda()
    state = rlib.state_of(model)
    f32_config = dataclasses.replace(rconfig, dtype="float32")
    f32 = rlib.load_state(rlib.make_model(f32_config), state).cuda()
    host = rlib.load_state(rlib.make_model(f32_config), state)
    loss_fn = rlib.make_loss_fn(model, rconfig)
    g16, loss16, l16 = _grads(model, loss_fn, batch,
                              group_norm.group_norm_act)
    g32, loss32, l32 = _grads(f32, loss_fn, batch,
                              group_norm.group_norm_act_plain)
    with swapped(_common, "batch_norm", detached_statistics):
        g_fault = _grads(f32, loss_fn, batch,
                         group_norm.group_norm_act_plain)[0]
    bf16 = bn_site_gaps(model, loss_fn, batch)
    bf16_faults = {"detached statistics": bn_site_gaps(
                       model, loss_fn, batch, detached_statistics),
                   "lost train": bn_site_gaps(model, loss_fn, batch,
                                              lost_train)}
    g_host, loss_host, _ = _grads(host, loss_fn, host_batch,
                                  group_norm.group_norm_act_plain)
    names = [k for k, _ in model.named_parameters()]
    del model, f32, host

    def on_host(g):
        return {k: v.cpu() for k, v in g.items()}

    vs_host = _rel_l2(on_host(g32), g_host)
    planted = _rel_l2(on_host(g_fault), g_host)
    complete = sorted(g16) == sorted(names)
    finite = all(bool(torch.isfinite(g).all()) for g in g16.values())
    nonzero = sum(float(g.abs().max()) > 0 for g in g16.values())
    del g16, g32, g_fault, g_host
    good = bn_stats_case("resnet50", rconfig, batch)
    fault = bn_stats_case("resnet50", rconfig, batch, planted=True)
    print(f"batch norm (a) resnet50 norm=batch {rconfig.image_size}² one "
          f"step at batch {BN_GRAD_BATCH}: loss bf16 {loss16:.5f}, f32 "
          f"{loss32:.5f}, f32 "
          f"on the host {loss_host:.5f}; bf16 grads of {len(names)} params "
          f"complete={complete}, finite={finite}, nonzero={nonzero}; rel_l2"
          f" f32 card-vs-host {vs_host:.3e} (tol {BN_GRADS_F32_VS_HOST}; "
          f"planted statistics detached from autograd {planted:.3e}, "
          f"{'caught' if planted > BN_GRADS_F32_VS_HOST else 'MISSED'}), "
          f"bf16 step at its {bf16['sites']} BatchNorm sites against f64 "
          f"on each site's inputs (tol {BN_BF16_SITE}): worst y "
          f"{bf16['y']:.3e}, dx {bf16['dx']:.3e} (site {bf16['at']}); "
          f"planted: dx halved {bf16['dx halved']:.3e}, uncorrelated "
          f"{bf16['dx uncorrelated']:.3e}, statistics cut from autograd "
          + ", ".join(f"{k} {bf16_faults['detached statistics'][k]:.3e}"
                      for k in ("y", "dx"))
          + f"; bf16 loss off f32 {abs(bf16['loss'] - loss32) / loss32:.3e}"
          f" (tol {BN_BF16_LOSS_REL}), lost train "
          f"{abs(bf16_faults['lost train']['loss'] - loss32) / loss32:.3e};"
          f" breaches {bf16_gate(loss32, bf16, bf16_faults) or 'none'}; "
          f"running statistics after one Trainer.step against flax's rule "
          f"on the host (f64) at {good[3]} sites: worst {good[0]:.3e} at "
          f"{good[1]} (tol {BN_STATS_TOL}); planted unbiased running "
          f"variance (torch's batch_norm): {fault[0]:.3e} at {fault[1]} "
          f"({'caught' if fault[0] > BN_STATS_TOL else 'MISSED'})",
          flush=True)
    if (not complete or len(names) != nonzero or not finite
            or vs_host > BN_GRADS_F32_VS_HOST
            or planted <= BN_GRADS_F32_VS_HOST
            or bf16_gate(loss32, bf16, bf16_faults)
            or good[0] > BN_STATS_TOL or not good[2]
            or fault[0] <= BN_STATS_TOL or any(l16.values())
            or any(l32.values())):
        failures.append(f"(a): grads card-vs-host {vs_host:.3e}, planted "
                        f"{planted:.3e}, bf16 "
                        f"{bf16_gate(loss32, bf16, bf16_faults)}, finite "
                        f"{finite}, nonzero {nonzero}/{len(names)}, stats "
                        f"{good}, planted {fault}")

    ends = [("(a)", time.perf_counter())]

    # (b) captured against eager, (d) the checkpoint, (c) eval bits
    none = dict.fromkeys(flat_counts(), 0)
    kept = {}
    for name, (lib, config) in configs.items():
        n = BN_STEP_BATCH[name]
        batches = [device_batch(lib, config, n, 180 + i)
                   for i in range(GRAPH_STEPS)]
        ckpt_dir = os.path.join(work, f"bn_ckpt_{name}")
        graph = run_trajectory(name, config, TRAIN_LR, None, batches,
                               "graph", checkpoint_dir=ckpt_dir, keep=True)
        eager = run_trajectory(name, config, TRAIN_LR, None, batches,
                               "eager")
        failures += [f"(b) {f}" for f in trajectory_gate(
            f"batch norm {name} at {n}", graph, eager, none)]
        t = graph.pop("trainer")
        t.finish_checkpoints()
        resumed = Trainer(name, config=config, learning_rate=TRAIN_LR,
                          seed=1, device="cuda")
        resumed.checkpoint(ckpt_dir)
        step = resumed.restore_latest()
        host = {k: v.cpu() for k, v in graph["state"].items()}
        differ, worst = state_gap(
            {k: v.cpu() for k, v in state_tensors(resumed).items()}, host)
        extra = device_batch(lib, config, n, 190)
        la, lb = float(t.step(extra)), float(resumed.step(extra))
        after, _ = state_gap(
            {k: v.cpu() for k, v in state_tensors(resumed).items()},
            {k: v.cpu() for k, v in state_tensors(t).items()})
        del resumed
        print(f"batch norm (d) {name}: restore_latest() -> {step}; state "
              f"tensors differing from the run's {differ} of {len(host)} "
              f"(batch_stats included, worst rel {worst:.3e}); one more "
              f"step each: losses {la:.6f} / {lb:.6f}, tensors differing "
              f"{after}", flush=True)
        if step != GRAPH_STEPS or differ or la != lb or after:
            failures.append(f"(d) {name}: step {step}, differ {differ}, "
                            f"losses {la} {lb}, after {after}")
        images = batches[0]["image"]
        bits = eval_bits(lambda x, t=t: t.predict({"image": x}), images, 3)
        planted = eval_bits(train_mode_predict(t), images, 3)
        print(f"batch norm (c) {name}: row 3's logits alone, in its batch "
              f"and in another batch the same bits: {bits['same_bits']} "
              f"(max gap {bits['max_gap']:.3e}); planted train-mode "
              f"forward at eval: same bits {planted['same_bits']} (gap "
              f"{planted['max_gap']:.3e}, "
              f"{'caught' if not planted['same_bits'] else 'MISSED'})",
              flush=True)
        if not bits["same_bits"] or planted["same_bits"]:
            failures.append(f"(c) {name}: {bits}, planted {planted}")
        kept[name] = t
        gc.collect()
        torch.cuda.empty_cache()

    ends.append(("(b)-(d)", time.perf_counter()))

    # (e) the export served, then the SPARK-mode slice
    kept.pop("inception_v3")
    serving = bn_serving(sc, kept.pop("resnet50"), work)
    gc.collect()
    torch.cuda.empty_cache()
    failures += serving["failures"]
    ends.append(("(e) serving", time.perf_counter()))
    spark = bn_slice(sc, rconfig)
    failures += spark["failures"]
    ends.append(("(e) slice", time.perf_counter()))

    # (b) rates, memory and busy ms by family
    rates = {name: bn_rates(lib, config, name, BN_RATE_BATCH[name])
             for name, (lib, config) in configs.items()}
    for name, r in rates.items():
        print_families(f"{name} norm=batch at {BN_RATE_BATCH[name]}",
                       r["families"])
    ends.append(("(b) rates", time.perf_counter()))

    # (f) no hand-written kernel in the BatchNorm runs above
    launches = {k: v - before[k] for k, v in flat_counts().items()}
    executors = collections.Counter(serving["launches"])
    executors.update(spark["launches"])
    counted = {k: v for k, v in launches.items() if v} or "none"
    on_executors = dict(executors) if any(executors.values()) else "none"
    print(f"batch norm (f) kernel launches in phase 18's BatchNorm runs: "
          f"this process {counted}, executors {on_executors} (and none in "
          f"the traced steps of (b) above)", flush=True)
    if any(launches.values()) or any(executors.values()):
        failures.append(f"(f) launches {launches}, executors "
                        f"{dict(executors)}")

    seconds = time.perf_counter() - t_start
    print(f"phase 18 {seconds:.1f} s (budget {PHASE18_BUDGET_S} s): "
          + ", ".join(f"{label} {end - start:.1f}" for (label, end), start
                      in zip(ends, [t_start] + [e for _, e in ends])),
          flush=True)
    if failures:
        raise SystemExit("batch norm phase failed: " + "; ".join(failures))
    total = collections.Counter(launches)
    total.update(executors)
    return {"launches": dict(total), "rates": rates, "seconds": seconds}


# ---------------------------------------------------------------------------
# Phase 19: the online serving tier
# ---------------------------------------------------------------------------

PHASE19_BUDGET_S = 60
#: the tenants (``OnlineServer.add_tenant`` arguments less the export):
#: ResNet-50 ``Config()`` by its self-describing export; wide&deep
#: ``Config()`` by name, README's online example
ONLINE_TENANTS = {
    "resnet": {"input_mapping": {"image": "image"}, "batch_size": 32,
               "bucket_sizes": [8, 32]},
    "ctr": {"model_name": "wide_deep",
            "input_mapping": {"dense": "dense", "cat": "cat"},
            "batch_size": 256, "bucket_sizes": [64, 128, 256],
            "flush_ms": 5.0}}
#: closed-loop clients and single-row requests a client, per tenant
ONLINE_CLIENTS = {"resnet": (16, 8), "ctr": (32, 16)}
ONLINE_PLANTED_CLIENTS = 8  # 19(a)'s swapped scatter: 8 clients x 3 rows
ONLINE_BEHIND_ROWS = 96  # 19(b)'s one-batch-behind emit: 3 batches of 32
#: ``gn_one_pass`` launches a tenant's forward (ResNet-50's 53 GroupNorms)
ONLINE_GN_LAUNCHES = {"resnet": 53}
#: seconds of each of 19(f)'s timed windows (coalesced, coalesced under
#: the trace, the one-request-a-forward clients)
ONLINE_WINDOW_S = 3.0
#: max abs gap of a reply from its row scored alone by the eager forward
#: at the bucket it rode (f32 of the outputs): bit for bit
ONLINE_SCATTER_TOL = 0.0


class swapped_static:
    """While active, ``cls.<name>`` is the static method ``make(the
    original function)``."""

    def __init__(self, cls, name: str, make):
        self.cls, self.name, self.make = cls, name, make

    def __enter__(self):
        self.saved = self.cls.__dict__[self.name]
        setattr(self.cls, self.name,
                staticmethod(self.make(self.saved.__func__)))
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.saved)


def online_exports(work: str) -> dict:
    """The tenants' exports, seeded: ResNet-50 ``Config()`` self-describing
    (its forward a ``torch.export`` program, GroupNorm as
    ``torch.ops.tfos.group_norm_act``), wide&deep ``Config()`` weights
    only (served by ``model_name``)."""
    from tensorflowonspark_torch import compat, saved_model, shapes
    from tensorflowonspark_torch.models import resnet, widedeep

    config = resnet.Config()
    example = {k: v for k, v in resnet.example_batch(config, 2).items()
               if k not in shapes.LABEL_KEYS}
    compat.export_saved_model(
        resnet.state_of(resnet.make_model(config, seed=0)),
        os.path.join(work, "resnet"),
        forward_fn=saved_model.wrap_state_forward(
            resnet.serving_forward, resnet.make_serving_model(config)),
        example_batch=example)
    state = widedeep.state_of(widedeep.make_model(widedeep.Config(), seed=0))
    state["collections"] = {k: v for k, v in state["collections"].items()
                            if not k.endswith("_opt")}
    compat.export_saved_model(state, os.path.join(work, "ctr"))
    return {"resnet": os.path.join(work, "resnet"),
            "ctr": os.path.join(work, "ctr")}


def online_rows() -> dict:
    """Each tenant's request rows, seeded, in the dtypes of its specs."""
    import numpy as np

    from tensorflowonspark_torch.models import resnet, widedeep

    side = resnet.Config().image_size
    n = max(ONLINE_CLIENTS["resnet"][0] * ONLINE_CLIENTS["resnet"][1],
            ONLINE_BEHIND_ROWS)
    images = np.random.RandomState(19).rand(n, side, side, 3).astype(
        np.float32)
    n = ONLINE_CLIENTS["ctr"][0] * ONLINE_CLIENTS["ctr"][1]
    ctr = {k: v for k, v in widedeep.example_batch(
        widedeep.Config(), n, seed=19).items() if k != "label"}
    return {"resnet": {"image": images}, "ctr": ctr}


def row_key(cols: dict) -> bytes:
    """One request's identity: its columns' bytes, in name order."""
    return b"".join(cols[k].tobytes() for k in sorted(cols))


def run_clients(jobs: dict, seconds: float | None = None) -> dict:
    """Closed-loop clients, every tenant's at once: ``jobs`` maps a tenant
    to ``(call, clients, requests)``; client c of a tenant sends rows c·r
    … c·r + r − 1 one at a time, each after the last reply.  With
    ``seconds`` each client goes round its rows until that window ends
    and keeps no replies.  Returns per tenant the replies by row, the
    latencies and the wall from the start to its last reply."""
    import threading

    starts = threading.Barrier(sum(c for _, c, _ in jobs.values()) + 1)
    out = {t: {"replies": {}, "latencies": [], "end": 0.0, "errors": []}
           for t in jobs}
    lock = threading.Lock()

    def rows_of(lo, n):
        if seconds is None:
            yield from range(lo, lo + n)
            return
        while time.perf_counter() < deadline:
            yield from range(lo, lo + n)

    def client(tenant, call, lo, n):
        starts.wait()
        for j in rows_of(lo, n):
            if seconds is not None and time.perf_counter() >= deadline:
                break
            t0 = time.perf_counter()
            try:
                reply = call(j)
            except Exception as e:  # gathered: fails the phase
                with lock:
                    out[tenant]["errors"].append(repr(e))
                continue
            t1 = time.perf_counter()
            with lock:
                rec = out[tenant]
                if seconds is None:
                    rec["replies"][j] = reply
                rec["latencies"].append(t1 - t0)
                rec["end"] = max(rec["end"], t1)

    threads = [threading.Thread(target=client, args=(t, call, c * r, r),
                                daemon=True)
               for t, (call, clients, r) in jobs.items()
               for c in range(clients)]
    for th in threads:
        th.start()
    deadline = float("inf")
    if seconds is not None:
        deadline = time.perf_counter() + seconds
    starts.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join(timeout=600)
    for rec in out.values():
        rec["wall"] = rec["end"] - t0
    return out


def quantiles_ms(latencies) -> tuple:
    import numpy as np

    a = np.asarray(latencies) * 1e3
    return (float(np.percentile(a, 50)), float(np.percentile(a, 99))) \
        if len(a) else (float("nan"), float("nan"))


def eager_reply(group, cols: dict, bucket: int) -> dict:
    """``cols`` (one row) scored alone by the eager forward (the loaded
    forward itself, no graph) at ``bucket`` rows: the row's outputs, f32
    on the host."""
    from tensorflowonspark_torch import pipeline, serving

    fwd = group.forward
    batch = group.stage(serving.pad_columns(cols, bucket))
    named = pipeline._name_outputs(fwd.fn(fwd.params, batch),
                                   group.out_map)
    return {c: serving._host(a)[:1] for c, a in named.items()}


def reply_gap(reply: dict, want: dict) -> float:
    import numpy as np

    if sorted(reply) != sorted(want):
        return float("inf")
    return max(float(np.abs(np.asarray(reply[c], np.float32)
                            - np.asarray(want[c], np.float32)).max())
               for c in want)


def scatter_gaps(srv, rows: dict, result: dict, served: dict) -> dict:
    """19(a): each tenant's worst gap of a reply from its row scored alone
    by the eager forward at the bucket it was served in, and the buckets
    the replies rode."""
    out = {}
    for tenant, rec in result.items():
        group = srv._tenants[tenant].group
        worst, buckets = 0.0, collections.Counter()
        for j, reply in rec["replies"].items():
            cols = {k: v[j:j + 1] for k, v in rows[tenant].items()}
            bucket = served.get(row_key(cols))
            if bucket is None:
                worst = float("inf")
                continue
            buckets[bucket] += 1
            worst = max(worst, reply_gap(reply,
                                         eager_reply(group, cols, bucket)))
        out[tenant] = {"worst": worst, "buckets": dict(sorted(
            buckets.items()))}
    return out


def online_traffic(srv, rows: dict, clients: dict) -> tuple:
    """The closed loop through ``srv.submit``, both tenants at once, with
    each served batch's bucket recorded by request around the server's
    scatter."""
    from tensorflowonspark_torch import online

    served = {}

    def recording(scatter):
        def rec(reqs, arrays):
            bucket = len(next(iter(arrays.values())))
            for r in reqs:
                served[row_key(r.cols)] = bucket
            return scatter(reqs, arrays)
        return rec

    with swapped_static(online.OnlineServer, "_scatter", recording):
        result = run_clients({t: (submitter(srv, rows, t), *clients[t])
                              for t in clients})
    return result, served


def submitter(srv, rows: dict, tenant: str):
    """``call(j)``: row j of ``tenant`` through ``srv.submit``, alone."""
    return lambda j: srv.submit(
        tenant, {k: v[j:j + 1] for k, v in rows[tenant].items()},
        timeout=120.0)


def online_window(srv, rows: dict, seconds: float) -> dict:
    """19(f)'s window: the closed-loop clients of :data:`ONLINE_CLIENTS`
    through ``srv.submit``, both tenants at once, for ``seconds``; with
    the batches it served by (tenant, bucket), the coalesce-size
    histogram's and the ``"online"`` flight plane's growth over it."""
    from tensorflowonspark_torch import online
    from tensorflowonspark_torch.obs import flight

    batches = collections.Counter()

    def counting(scatter):
        def rec(reqs, arrays):
            batches[(reqs[0].tenant.name,
                      len(next(iter(arrays.values()))))] += 1
            return scatter(reqs, arrays)
        return rec

    plane = flight.recorder("online")
    hist0, stages0 = srv._coalesce_size.export(), plane.snapshot()
    with swapped_static(online.OnlineServer, "_scatter", counting):
        result = run_clients(
            {t: (submitter(srv, rows, t), *ONLINE_CLIENTS[t])
             for t in ONLINE_CLIENTS}, seconds=seconds)
    hist1, stages1 = srv._coalesce_size.export(), plane.snapshot()
    sizes, prev = {}, 0
    for (le, c1), (_, c0) in zip(hist1["buckets"], hist0["buckets"]):
        if c1 - c0 - prev:
            sizes[le] = c1 - c0 - prev
        prev = c1 - c0
    return {"result": result, "batches": batches, "sizes": sizes,
            "batches_total": stages1["batches"] - stages0["batches"],
            "stages": {k: round(v - stages0["stages_s"].get(k, 0.0), 4)
                       for k, v in stages1["stages_s"].items()},
            "overlapped": {
                k: round(v - stages0["overlapped_stages_s"].get(k, 0.0), 4)
                for k, v in stages1["overlapped_stages_s"].items()}}


def traced_busy(fn) -> tuple:
    """``(fn(), kernel ms, copy ms)``: ``fn`` run under torch.profiler
    (CUPTI, device activity only), the card's kernels' busy time (their
    intervals' union) and its copies' and sets' time over the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA
                             if torch.cuda.is_available()
                             else ProfilerActivity.CPU]) as prof:
        out = fn()
    spans, copy_us = [], 0.0
    for e in prof.events():
        if getattr(e, "device_type", None) is None \
                or e.device_type.name != "CUDA" \
                or getattr(e, "is_user_annotation", False) \
                or _ANNOTATION.match(e.name):
            continue
        if e.name.startswith(("Memcpy", "Memset")):
            copy_us += e.time_range.elapsed_us()
        else:
            spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return out, busy / 1e3, copy_us / 1e3


def planted_scatter_check(srv, rows: dict) -> dict:
    """19(a)'s planted fault: the scatter hands a batch's first two
    requests each other's rows; the replies must read above the
    tolerance."""
    from tensorflowonspark_torch import online

    swaps = [0]

    def swapping(scatter):
        def bad(reqs, arrays):
            if len(reqs) >= 2:
                swaps[0] += 1
                reqs = [reqs[1], reqs[0], *reqs[2:]]
            return scatter(reqs, arrays)
        return bad

    with swapped_static(online.OnlineServer, "_scatter", swapping):
        result, served = online_traffic(
            srv, rows, {"resnet": (ONLINE_PLANTED_CLIENTS, 3)})
    gaps = scatter_gaps(srv, rows, result, served)
    return {"swapped_batches": swaps[0], "worst": gaps["resnet"]["worst"],
            "errors": result["resnet"]["errors"]}


def captured_vs_eager(srv) -> list:
    """19(b): every captured bucket of every tenant, replayed on a staged
    batch of seeded rows, against the eager forward on the same staged
    batch: ``(tenant, bucket, what the call did, same bits)``."""
    import numpy as np
    import torch

    from tensorflowonspark_torch import pipeline, shapes

    out = []
    for name, ts in srv._tenants.items():
        group = ts.group
        fwd = group.forward
        for b in group.buckets:
            rng = np.random.RandomState(b)
            batch = {}
            for feat, (tail, dtype) in group.specs.items():
                if np.dtype(dtype).kind == "f":
                    batch[feat] = rng.rand(b, *tail).astype(dtype)
                else:
                    # ids valid in any config (tiny wide&deep has 50
                    # buckets a feature)
                    batch[feat] = rng.randint(0, 50, (b, *tail)).astype(
                        dtype)
            staged = group.stage(batch)
            got = pipeline._name_outputs(fwd(staged), group.out_map)
            action = fwd.last
            want = pipeline._name_outputs(fwd.fn(fwd.params, staged),
                                          group.out_map)
            same = sorted(got) == sorted(want) and all(
                torch.equal(got[c], want[c]) for c in want)
            out.append((name, b, action, same,
                        shapes.signature(staged) in fwd.capture_seconds))
    return out


def behind_emit_check(export: str, images) -> dict:
    """19(b)'s one-batch-behind emit: ``_RunModel`` scores
    ``ONLINE_BEHIND_ROWS`` rows at batch 32 (the resnet tenant's forward
    and graphs: the same model key) against the eager forward on each
    batch, then again with ``CapturedForward.hold`` planted to hand back
    the static outputs, which the next replay overwrites."""
    import numpy as np

    from tensorflowonspark_torch import pipeline, serving
    from tensorflowonspark_torch.parallel import train as train_lib

    n = ONLINE_BEHIND_ROWS
    run = pipeline._RunModel(
        export, None, None, ONLINE_TENANTS["resnet"]["batch_size"],
        {"image": "image"}, None, ["image"],
        bucket_sizes=ONLINE_TENANTS["resnet"]["bucket_sizes"])

    def score():
        return np.asarray([r.prediction for r in run(
            iter([{"image": images[i]} for i in range(n)]))], np.float32)

    got = score()
    fn, params = run._load()
    stage = serving.stager(run._device)
    b = run.batch_size
    want = np.concatenate([serving._host(fn(params, stage(
        {"image": images[lo:lo + b]}))) for lo in range(0, n, b)])
    with swapped_static(train_lib.CapturedForward, "hold",
                        lambda hold: lambda outputs: outputs):
        planted = score()
    fwd = serving.captured(run._cache_key, fn, params)
    return {"same_bits": got.shape == want.shape
            and bool(np.array_equal(got, want)),
            "planted_gap": (float(np.abs(planted - want).max())
                            if planted.shape == want.shape
                            else float("inf")),
            "last": fwd.last}


def http_checks(srv, rows: dict) -> tuple:
    """19(d): ``OnlineHTTPServer`` over ``srv``: replies against
    ``submit``'s, ``/healthz``'s warm ratio, ``/metrics``' families, then
    a shed tenant's 429.  Returns ``(report, failures)``."""
    import json
    import threading
    import urllib.error
    import urllib.request

    import numpy as np

    from tensorflowonspark_torch import compat, online

    http = online.OnlineHTTPServer(srv)
    http.start()
    failures, report = [], {}

    def post(doc, timeout=120.0):
        req = urllib.request.Request(
            http.url("/v1/predict"), data=json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read().decode())

    try:
        gaps = []
        for tenant in ("resnet", "ctr"):
            for j in (0, 1):
                cols = {k: v[j:j + 1] for k, v in rows[tenant].items()}
                doc = post({"tenant": tenant, "inputs": {
                    k: v.tolist() for k, v in cols.items()}})
                sub = srv.submit(tenant, cols, timeout=120.0)
                gaps.append(reply_gap(
                    {c: np.asarray(v, np.float32)
                     for c, v in doc["outputs"].items()}, sub))
        report["http_vs_submit"] = max(gaps)
        with urllib.request.urlopen(http.url("/healthz"), timeout=30) as r:
            health = json.loads(r.read().decode())
        report["compile_cache"] = health["compile_cache"]
        with urllib.request.urlopen(http.url("/metrics"), timeout=30) as r:
            text = r.read().decode()
        report["metrics"] = {k: k in text for k in (
            "online_requests_total", "online_coalesce_size")}
        if report["http_vs_submit"] != 0.0:
            failures.append(f"(d) POST replies off submit's by "
                            f"{report['http_vs_submit']}")
        if health["compile_cache"]["warm_ratio"] != 1.0:
            failures.append(f"(d) warm_ratio {health['compile_cache']}")
        if not all(report["metrics"].values()):
            failures.append(f"(d) /metrics {report['metrics']}")

        # a shed: a gated forward holds the first batch while a flood
        # fills a tenant's byte bound
        gate = threading.Event()
        toy = os.path.join(tempfile.mkdtemp(prefix="tfos_torch_shed_"),
                           "toy")
        compat.export_saved_model(
            {"params": {"w": np.ones((4, 1), np.float32)}}, toy)

        def gated(params, batch):
            gate.wait(timeout=60.0)
            return {"score": batch["features"].sum(dim=1)}

        srv.add_tenant("shed", export_dir=toy, predict_fn=gated,
                       batch_size=8, bucket_sizes=[8], flush_ms=1.0,
                       warmup=False, input_mapping={"features": "features"},
                       max_pending_mb=3 * 16 / (1 << 20))
        row = {"tenant": "shed", "inputs": {"features": [[1.0] * 4]}}

        def fire():
            try:
                post(row)
            except urllib.error.HTTPError:
                pass

        flood = [threading.Thread(target=fire, daemon=True)
                 for _ in range(10)]
        for th in flood:
            th.start()
            time.sleep(0.02)
        status = retry = None
        try:
            post({**row, "timeout_s": 1.0})
        except urllib.error.HTTPError as e:
            status, retry = e.code, e.headers.get("Retry-After")
        gate.set()
        for th in flood:
            th.join(timeout=60)
        srv.remove_tenant("shed")
        report["shed"] = (status, retry)
        if status != 429 or not retry or float(retry) <= 0:
            failures.append(f"(d) shed gave {status}, Retry-After {retry}")
    finally:
        http.stop()
    return report, failures


def infer_embed_check(export: str, images) -> dict:
    """19(e): the ResNet export through ``infer_embed``'s handle protocol
    on the card, twice (an eager first call, then a capture), against the
    eager forward's bits."""
    import numpy as np

    from tensorflowonspark_torch import infer_embed, pipeline, serving

    x = np.ascontiguousarray(images[:3])
    h = infer_embed.load(export)
    try:
        runs = []
        for _ in range(2):
            infer_embed.set_input(h, "image", x.tobytes(), x.shape, 0)
            infer_embed.run(h)
            runs.append(np.frombuffer(infer_embed.get_output(h),
                                      np.float32).reshape(
                infer_embed.output_shape(h)))
        fwd = infer_embed._HANDLES[h]["forward"]
        last = fwd.last
    finally:
        infer_embed.close(h)
    key = pipeline.model_cache_key(export)
    fn, params = pipeline._MODEL_CACHE[key][:2]
    want = serving._host(fn(params, serving.stager(
        pipeline.single_node_env())({"image": x})))
    return {"same_bits": all(np.array_equal(r, want) for r in runs),
            "last": last, "shape": tuple(runs[0].shape)}


def batch_profile(fwd, staged, gn_launches: int, calls: int = 50) -> dict:
    """The median host µs of one captured call (copy in, replay) made on
    an idle card, so that no launch waits for room in the
    device's queue, and its busy ms and ``gn_one_pass`` launches from a
    profiler trace of one replay (:func:`traced_kernels`, complete when it
    holds ``gn_launches``)."""
    import statistics

    import torch

    walls = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd(staged)
        walls.append(time.perf_counter() - t0)
    host = statistics.median(walls) * 1e6
    torch.cuda.synchronize()
    kernels = traced_kernels(
        lambda: fwd(staged), 1, lambda ks: traced_launches(
            n for n, _ in ks).get("one_pass", 0) == gn_launches)
    return {"host_us": host,
            "busy_ms": sum(ms for _, ms in kernels) or None,
            "gn_one_pass": traced_launches(
                n for n, _ in kernels).get("one_pass", 0)}


def online_phase(work: str, card: str) -> dict:
    """Phase 19 (see the module docstring), in its own process: every
    sub-phase runs; the failures are gathered and fail the run at the
    end."""
    from tensorflowonspark_torch import health, online, pipeline
    from tensorflowonspark_torch.kernels import group_norm

    t_start = time.perf_counter()
    failures = []
    ends = []
    probes = [0, 0.0]  # runs, seconds
    probe = health.probe_chip_health

    def counted_probe(*a, **kw):
        probes[0] += 1
        t0 = time.perf_counter()
        try:
            return probe(*a, **kw)
        finally:
            probes[1] += time.perf_counter() - t0

    health.probe_chip_health = counted_probe
    plain_on_card = [0]
    plain = group_norm.group_norm_act_plain

    def counted_plain(x, *a, **kw):
        if x.is_cuda:
            plain_on_card[0] += 1
        return plain(x, *a, **kw)

    group_norm.group_norm_act_plain = counted_plain
    exports = online_exports(work)
    rows = online_rows()
    ends.append(("exports", time.perf_counter()))

    # the main path: warm on load (capture), then the closed loop
    group_norm.reset_launches()
    before = flat_counts()
    srv = online.OnlineServer()
    loaded = {}
    for name, kw in ONLINE_TENANTS.items():
        t0 = time.perf_counter()
        srv.add_tenant(name, export_dir=exports[name], warmup=True, **kw)
        loaded[name] = time.perf_counter() - t0
    srv.start()
    ends.append(("add_tenant", time.perf_counter()))
    result, served = online_traffic(srv, rows, ONLINE_CLIENTS)
    launches = {k: v - before[k] for k, v in flat_counts().items()}
    ends.append(("traffic", time.perf_counter()))

    # (c) the kernel on the online path
    buckets = len(ONLINE_TENANTS["resnet"]["bucket_sizes"])
    want_launches = launch_counts(
        one_pass=ONLINE_GN_LAUNCHES["resnet"] * 2 * buckets)
    want_launches = {k: want_launches.get(k, 0) for k in launches}
    fwd = {t: srv._tenants[t].group.forward for t in ONLINE_TENANTS}
    served_n = sum(len(r["replies"]) for r in result.values())
    print(f"online (c) launches on the online path (add_tenant's warm "
          f"and capture, then {served_n} requests): {launches} (want "
          f"{want_launches}: 53 a ResNet forward, {buckets} buckets, an "
          f"eager call and a capture each; a replay calls no wrapper); "
          f"captures {({t: f.captures for t, f in fwd.items()})}, replays "
          f"{({t: f.replays for t, f in fwd.items()})}, eager calls "
          f"{({t: f.eager_calls for t, f in fwd.items()})}", flush=True)
    if (launches != want_launches or launches["one_pass"] <= 0
            or any(f.eager_calls != len(srv._tenants[t].group.buckets)
                   for t, f in fwd.items())):
        failures.append(f"(c) launches {launches}, want {want_launches}")

    # (a) every reply against its row scored alone at its bucket
    errors = {t: r["errors"] for t, r in result.items() if r["errors"]}
    gaps = scatter_gaps(srv, rows, result, served)
    planted = planted_scatter_check(srv, rows)
    counts = {t: len(r["replies"]) for t, r in result.items()}
    print(f"online (a) closed-loop single-row clients {ONLINE_CLIENTS} "
          f"(clients, requests each), both tenants at once: replies "
          f"{counts}, errors {errors or 'none'}; worst gap of a reply from "
          f"its row scored alone by the eager forward at its bucket "
          + ", ".join(f"{t} {g['worst']:.3e} (buckets {g['buckets']})"
                      for t, g in gaps.items())
          + f" (tol {ONLINE_SCATTER_TOL}: bit for bit); planted swapped "
          f"scatter: {planted['swapped_batches']} batches swapped, worst "
          f"{planted['worst']:.3e} "
          f"({'caught' if planted['worst'] > ONLINE_SCATTER_TOL and planted['swapped_batches'] else 'MISSED'})",
          flush=True)
    for t, (c, r) in ONLINE_CLIENTS.items():
        if counts[t] != c * r or gaps[t]["worst"] > ONLINE_SCATTER_TOL:
            failures.append(f"(a) {t}: replies {counts[t]}, worst "
                            f"{gaps[t]['worst']}")
    if errors:
        failures.append(f"(a) client errors {errors}")
    if (planted["worst"] <= ONLINE_SCATTER_TOL
            or not planted["swapped_batches"] or planted["errors"]):
        failures.append(f"(a) planted swap {planted}")
    ends.append(("(a)", time.perf_counter()))

    # (b) each captured bucket against the eager forward; the behind emit
    replays = captured_vs_eager(srv)
    behind = behind_emit_check(exports["resnet"], rows["resnet"]["image"])
    print(f"online (b) each captured bucket's replay against the eager "
          f"forward on the same staged batch: "
          + ", ".join(f"{t} {b}: {act}, same bits {same}"
                      for t, b, act, same, _ in replays)
          + f"; _RunModel over {ONLINE_BEHIND_ROWS} rows at batch 32 (one "
          f"batch behind): the eager forward's bits {behind['same_bits']} "
          f"(last call {behind['last']}); planted emit reading the static "
          f"outputs: gap {behind['planted_gap']:.3e} "
          f"({'caught' if behind['planted_gap'] > 0 else 'MISSED'})",
          flush=True)
    if not all(same and act == "replay" and cap
               for _, _, act, same, cap in replays):
        failures.append(f"(b) {replays}")
    if (not behind["same_bits"] or behind["last"] != "replay"
            or not behind["planted_gap"] > 0):
        failures.append(f"(b) behind emit {behind}")
    ends.append(("(b)", time.perf_counter()))

    # (d) HTTP
    http, http_failures = http_checks(srv, rows)
    failures += http_failures
    print(f"online (d) OnlineHTTPServer: POST /v1/predict against submit "
          f"max gap {http['http_vs_submit']:.3e}; /healthz compile_cache "
          f"{http['compile_cache']}; /metrics {http['metrics']}; a shed: "
          f"HTTP {http['shed'][0]}, Retry-After {http['shed'][1]}",
          flush=True)
    ends.append(("(d)", time.perf_counter()))

    # (e) infer_embed
    emb = infer_embed_check(exports["resnet"], rows["resnet"]["image"])
    print(f"online (e) infer_embed load/set_input/run/get_output of the "
          f"resnet export on the card: output {emb['shape']} f32, the "
          f"eager forward's bits in both runs {emb['same_bits']} (last "
          f"call {emb['last']})", flush=True)
    if not emb["same_bits"] or emb["last"] != "capture":
        failures.append(f"(e) {emb}")
    ends.append(("(e)", time.perf_counter()))

    # (f) numbers (printed, not gated): timed windows at the same client
    # counts; a batch's host and busy time on an idle card
    profiles = {}
    for t, ts in srv._tenants.items():
        group = ts.group
        for b in group.buckets:
            staged = group.stage(shapes_zero(group.specs, b))
            profiles[(t, b)] = batch_profile(
                group.forward, staged, ONLINE_GN_LAUNCHES.get(t, 0))
    capture_s = {t: {sig_rows(sig): round(s, 4) for sig, s in
                     f.capture_seconds.items()
                     if sig_rows(sig) in srv._tenants[t].group.buckets}
                 for t, f in fwd.items()}

    def direct(tenant):
        from tensorflowonspark_torch import pipeline as pl, serving

        group = srv._tenants[tenant].group
        b = group.buckets[0]

        def call(j):
            cols = {k: v[j:j + 1] for k, v in rows[tenant].items()}
            out = group.forward(group.stage(serving.pad_columns(cols, b)),
                                take=serving.to_host)
            return {c: a[:1] for c, a in
                    pl._name_outputs(out, group.out_map).items()}
        return call

    win = online_window(srv, rows, ONLINE_WINDOW_S)
    traced, busy_ms, copy_ms = traced_busy(
        lambda: online_window(srv, rows, ONLINE_WINDOW_S))
    base = run_clients({t: (direct(t), *ONLINE_CLIENTS[t])
                        for t in ONLINE_CLIENTS}, seconds=ONLINE_WINDOW_S)

    def rate(rec):
        return len(rec["latencies"]) / rec["wall"]

    for t in ONLINE_CLIENTS:
        w, tr, bs = (win["result"][t], traced["result"][t], base[t])
        p50, p99 = quantiles_ms(w["latencies"])
        t50, t99 = quantiles_ms(tr["latencies"])
        b50, b99 = quantiles_ms(bs["latencies"])
        by_bucket = {b: n for (tt, b), n in sorted(win["batches"].items())
                     if tt == t}
        print(f"online (f) {t}, {ONLINE_CLIENTS[t][0]} closed-loop "
              f"single-row clients for {ONLINE_WINDOW_S} s: coalesced "
              f"{rate(w):.1f} rows/s ({len(w['latencies'])} requests), "
              f"p50 {p50:.3f} ms, p99 {p99:.3f} ms (under the trace "
              f"{rate(tr):.1f} rows/s, p50 {t50:.3f}, p99 {t99:.3f}); the "
              f"same clients calling the captured forward directly (one "
              f"request a forward at bucket "
              f"{srv._tenants[t].group.buckets[0]}) {rate(bs):.1f} rows/s "
              f"({len(bs['latencies'])} requests), p50 {b50:.3f} ms, p99 "
              f"{b99:.3f} ms; batches by bucket {by_bucket}; capture s by bucket {capture_s[t]} ({card})", flush=True)
    wall = max(r["wall"] for r in traced["result"].values())
    print(f"online (f) the untraced window: coalesced batches "
          f"{win['batches_total']}, real rows a batch by histogram bucket "
          f"(le: batches) {win['sizes']}; the 'online' flight plane, s: "
          f"compute thread {win['stages']}, coalescer thread (overlapped) "
          f"{win['overlapped']}; the traced window: idle share of the card "
          f"{1 - busy_ms / (wall * 1e3):.1%} (kernels busy {busy_ms:.1f} of "
          f"{wall * 1e3:.1f} ms, their intervals' union; copies and sets "
          f"{copy_ms:.1f} ms); a batch by (tenant, bucket) on an idle card: "
          + ", ".join(f"{t} {b}: host {p['host_us']:.1f} µs, busy "
                      f"{p['busy_ms'] if p['busy_ms'] is None else round(p['busy_ms'], 4)}"
                      f" ms, gn_one_pass in the replay {p['gn_one_pass']}"
                      for (t, b), p in profiles.items())
          + f"; add_tenant s {({t: round(s, 3) for t, s in loaded.items()})}"
          f" ({card})", flush=True)
    for (t, b), p in profiles.items():
        want = ONLINE_GN_LAUNCHES.get(t, 0)
        if want and p["busy_ms"] and p["gn_one_pass"] != want:
            failures.append(f"(c) a traced {t} replay at {b} ran "
                            f"{p['gn_one_pass']} gn_one_pass, want {want}")
    for name, w in (("window", win), ("traced window", traced)):
        errs = {t: r["errors"][:3] for t, r in w["result"].items()
                if r["errors"]}
        if errs:
            failures.append(f"(f) {name} client errors {errs}")
    ends.append(("(f)", time.perf_counter()))

    srv.stop()
    # (g) the probe, once in this process
    print(f"online (g) card health probe: {probes[0]} run in this process "
          f"(pipeline.single_node_env, {probes[1]:.2f} s), verdict "
          f"{pipeline._SERVING_PROBE_ERROR or 'healthy'}; plain-twin "
          f"GroupNorm calls on the card {plain_on_card[0]}", flush=True)
    if (probes[0] != 1 or pipeline._SERVING_PROBE_ERROR
            or not pipeline._SERVING_PROBED):
        failures.append(f"(g) probes {probes[0]}, "
                        f"{pipeline._SERVING_PROBE_ERROR}")
    if plain_on_card[0]:
        failures.append(f"(c) plain GroupNorm on the card "
                        f"{plain_on_card[0]} times")
    health.probe_chip_health = probe
    group_norm.group_norm_act_plain = plain
    seconds = time.perf_counter() - t_start
    print(f"phase 19 {seconds:.1f} s (budget {PHASE19_BUDGET_S} s): "
          + ", ".join(f"{label} {end - start:.1f}" for (label, end), start
                      in zip(ends, [t_start] + [e for _, e in ends])),
          flush=True)
    if failures:
        raise SystemExit("online phase failed: " + "; ".join(failures))
    return {"launches": launches, "seconds": seconds}


def shapes_zero(specs: dict, rows: int) -> dict:
    from tensorflowonspark_torch import shapes

    return shapes.zero_batch(specs, rows)


def sig_rows(sig) -> int:
    """A signature's batch rows (its first leaf's leading dimension)."""
    return sig[0][1][0]


def phase19_alone(card: str, result_path: str | None) -> int:
    """``--phase 19``: phase 19 in this process (its own: the serving
    probe and the signature counters start fresh), then the card line;
    ``--result`` writes its launches and seconds there as JSON."""
    work = tempfile.mkdtemp(prefix="tfos_torch_online_")
    try:
        result = online_phase(work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if result_path:
        with open(result_path, "w") as f:
            json.dump(result, f)
    print(card)
    return 0


def run_phase19() -> dict:
    """Phase 19 of the whole script: ``--phase 19`` in a child process
    (its output goes to this one's), its result read back."""
    fd, path = tempfile.mkstemp(prefix="tfos_torch_phase19_",
                                suffix=".json")
    os.close(fd)
    try:
        sys.stdout.flush()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--phase", "19",
             "--result", path], timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"phase 19 failed (exit {proc.returncode})")
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def phase18_alone(card: str) -> int:
    """``--phase 18``: phase 18 alone (after the build) in its own
    application, then the card line."""
    from tensorflowonspark_torch import sparkapi

    sc = sparkapi.LocalSparkContext("local[1]")
    work = tempfile.mkdtemp(prefix="tfos_torch_bn_")
    try:
        batch_norm_phase(sc, work)
    finally:
        sc.stop()
        shutil.rmtree(work, ignore_errors=True)
    print(card)
    return 0


def phase16_alone(card: str) -> int:
    """``--phase 16``: phase 16 in a scratch directory, then the card
    line."""
    work = tempfile.mkdtemp(prefix="tfos_torch_graph_")
    try:
        compiled_step_phase(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(card)
    return 0


def phase17_alone(card: str) -> int:
    """``--phase 17``: phase 17 alone (after the build), then its kernels
    line and the card line."""
    result = decode_phase()
    print(card)
    print(json.dumps({"kernels": phase17_entries(result)}))
    return 0


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(
        description="Drive the PyTorch port on one CUDA card (every phase "
                    "with no arguments).")
    parser.add_argument("--phase", type=int, choices=(16, 17, 18, 19),
                        help="run the build and this phase alone")
    parser.add_argument("--result", help="with --phase 19: write the "
                        "phase's launches and seconds here as JSON")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dataclasses

    from tensorflowonspark_torch.kernels import _build, group_norm
    from tensorflowonspark_torch.models import resnet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(python_embed_line(), flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'}"
          f" in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.phase == 16:
        return phase16_alone(card)
    if args.phase == 17:
        return phase17_alone(card)
    if args.phase == 18:
        return phase18_alone(card)
    if args.phase == 19:
        return phase19_alone(card, args.result)
    ends = [time.perf_counter()]  # each phase's end, from phase 1 (build)

    config = resnet.Config()
    model = resnet.make_model(config, seed=0).cuda().eval()
    f32_model = resnet.load_state(
        resnet.make_model(dataclasses.replace(config, dtype="float32")),
        resnet.state_of(model)).cuda().eval()
    f32_model.norm_act = group_norm.group_norm_act_plain  # bf16-only kernel
    sites = record_sites(model, config.image_size)
    if len(sites) != 53:
        raise SystemExit(f"expected 53 norm calls per forward, got "
                         f"{len(sites)}")
    kern = kernel_phase(sites)
    ends.append(time.perf_counter())
    model_phase(model, f32_model)
    del f32_model
    ends.append(time.perf_counter())
    serving = slice_phase(model)
    del model
    torch.cuda.empty_cache()
    ends.append(time.perf_counter())
    kern.update(backward_phase(sites))
    ends.append(time.perf_counter())
    train_model = train_model_phase()
    ends.append(time.perf_counter())
    main_path = train_slice_phase()
    ends.append(time.perf_counter())
    tables = table_kernel_phase()
    ends.append(time.perf_counter())
    wd_train = wd_train_model_phase()
    ends.append(time.perf_counter())
    wd_slice = wd_slice_phase()
    ends.append(time.perf_counter())
    print("wide_deep steps/s at batch 1024: " + "; ".join(
        f"{mode}: Trainer.step {wd_train[mode]['steps_per_s']:.1f}, slice "
        f"{wd_slice[path]['steps_per_s']}" for mode, path in WD_MODES),
        flush=True)
    print("seconds: " + ", ".join(
        f"phase {i + 1} {end - start:.1f}"
        for i, (start, end) in enumerate(zip([t_start] + ends, ends))),
        flush=True)
    # one application for phases 11-14: its executor carries over from one
    # job to the next, as a Spark application's executors do
    from tensorflowonspark_torch import sparkapi

    t11 = time.perf_counter()
    sc = sparkapi.LocalSparkContext("local[1]")
    work = tempfile.mkdtemp(prefix="tfos_torch_tf_")
    try:
        tf_resnet = tf_resnet_slice_phase(sc, work)
        t12 = time.perf_counter()
        tf_wd = tf_wd_slice_phase(sc)
        t13 = time.perf_counter()
        persistence = persistence_phase(sc, work, tf_resnet)
        t14 = time.perf_counter()
        zoo = zoo_phase(sc, work)
        t15 = time.perf_counter()
        bert_base = bert_phase(sc, work)
        t16 = time.perf_counter()
        compiled = compiled_step_phase(work)
        t_end = time.perf_counter()
        batch_norm = batch_norm_phase(sc, work)
        t18 = time.perf_counter()
    finally:
        sc.stop()
        shutil.rmtree(work, ignore_errors=True)
    t17 = time.perf_counter()
    decoded = decode_phase()
    t19 = time.perf_counter()
    online_served = run_phase19()
    t_done = time.perf_counter()
    print(f"resnet50 images/s at batch {SLICE_TRAIN_BATCH}: TENSORFLOW-mode "
          f"slice {tf_resnet['images_per_s']} by cluster.metrics() "
          f"(a checkpoint at its last step; "
          f"{tf_resnet['no_ckpt_images_per_s']} with no checkpoint), "
          f"{tf_resnet['wall_images_per_s']} loop wall; SPARK-mode slice "
          f"{main_path['images_per_s']} by cluster.metrics(), "
          f"{main_path['wall_images_per_s']:.2f} cluster.train wall; "
          f"the TFRecord feed alone {tf_resnet['feed_images_per_s']:.1f}; "
          f"Trainer.step at batch {SLICE_TRAIN_BATCH} "
          f"{tf_resnet['step_images_per_s']:.1f}, at batch {MODEL_BATCH} "
          f"{train_model['images_per_s']:.1f}", flush=True)
    print(f"wide_deep combine steps/s at batch {WD_BATCH}: TENSORFLOW-mode "
          f"Parquet slice {tf_wd['steps_per_s']} by cluster.metrics(), "
          f"{tf_wd['wall_steps_per_s']} loop wall; estimator slice "
          f"{wd_slice['combine']['steps_per_s']}; the Parquet feed alone "
          f"{tf_wd['feed_steps_per_s']:.1f}; Trainer.step "
          f"{wd_train['dense']['steps_per_s']:.1f}", flush=True)
    print(f"tinylm Config() greedy decode on the card: "
          f"{decoded['tokens_per_s']:.1f} tokens/s with "
          f"{DECODE_REQUESTS} requests at once, "
          f"{decoded['sequential_tokens_per_s']:.1f} one at a time",
          flush=True)
    print(f"seconds: phase 11 {t12 - t11:.1f}, phase 12 {t13 - t12:.1f}, "
          f"phase 13 {t14 - t13:.1f}, phase 14 {t15 - t14:.1f}, phase 15 "
          f"{t16 - t15:.1f}, phase 16 {t_end - t16:.1f}, phase 18 "
          f"{t18 - t_end:.1f}, phase 17 {t19 - t17:.1f}, phase 19 "
          f"{t_done - t19:.1f} (in its process: "
          f"{online_served['seconds']:.1f}); all phases "
          f"{t_done - t_start:.1f}",
          flush=True)

    print(card)  # as nvidia-smi gives it: name, power limit
    names = {"one_pass": "group_norm_act (one_pass)",
             "two_pass": "group_norm_act (two_pass)",
             "backward_one_pass": "group_norm_act backward (one_pass)",
             "backward_four_launch": "group_norm_act backward (four_launch)"}
    kernels = [{
        "name": names[path], "route": "cuda",
        "source": "tensorflowonspark_torch/csrc/group_norm"
                  + ("_bwd.cu" if path.startswith("backward") else ".cu"),
        "replaces": ("tensorflowonspark_tpu/parallel/train.py:416"
                     if path.startswith("backward")
                     else "tensorflowonspark_tpu/models/resnet.py:59"),
        "launches": main_path["launches"][path],
        "launches_serving": serving["launches"].get(path, 0),
        "launches_tf_mode": tf_resnet["launches"][path],
        "launches_phase13": persistence["launches"].get(path, 0),
        "launches_phase14": zoo["launches"].get(path, 0),
        "launches_phase15": bert_base["launches"][path],
        "launches_phase16": compiled["launches"][path],
        "replay_launches_phase16": compiled["replay_traced"].get(path, 0),
        "launches_phase18": batch_norm["launches"].get(path, 0),
        "launches_phase19": online_served["launches"].get(path, 0),
        **kern[path], **phase14_entry(zoo["kernels"], path)}
        for path in names]
    grouping = tables["combine"]
    kernels.append({
        "name": "sparse_adagrad id grouping", "route": "cuda",
        "source": "tensorflowonspark_torch/csrc/sparse_adagrad.cu",
        "replaces": "tensorflowonspark_tpu/embedding.py:54",
        "launches": sum(wd_slice[p]["group_launches"] for _, p in WD_MODES),
        "launches_tf_mode": tf_wd["launches"]["group"],
        "launches_phase13": persistence["launches"].get("group", 0),
        "launches_phase14": zoo["table_launches"]["group"],
        "launches_phase15": bert_base["launches"]["group"],
        "launches_phase16": compiled["launches"]["group"],
        "replay_launches_phase16": compiled["replay_traced"].get("group", 0),
        "launches_phase18": batch_norm["launches"].get("group", 0),
        "max_abs_err": 0.0, "ms": grouping["group_ms"],
        "device_ms": grouping["group_device_ms"],
        "plain_ms": grouping["group_plain_ms"],
        **group_bound_ms(WD_BATCH * 26, 4, grouping["segments"]),
        "library_ms": grouping["sort_ms"],
        "library_device_ms": grouping["sort_device_ms"]})
    kernels += [{
        "name": f"sparse_adagrad ({path})", "route": "cuda",
        "source": "tensorflowonspark_torch/csrc/sparse_adagrad.cu",
        "replaces": ("tensorflowonspark_tpu/models/widedeep.py:283"
                     if path == "combine"
                     else "tensorflowonspark_tpu/embedding.py:36"),
        "launches": wd_slice[path]["launches"],
        "launches_tf_mode": tf_wd["launches"].get(path, 0),
        "launches_phase13": persistence["launches"].get(path, 0),
        "launches_phase14": zoo["table_launches"][path],
        "launches_phase15": bert_base["launches"][path],
        "launches_phase16": compiled["launches"][path],
        "replay_launches_phase16": compiled["replay_traced"].get(path, 0),
        "launches_phase18": batch_norm["launches"].get(path, 0),
        **tables[path]}
        for _, path in WD_MODES]
    kernels += phase17_entries(decoded)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
