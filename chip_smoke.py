#!/usr/bin/env python3
"""On-card smoke run of lightgbm_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one CUDA GPU and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored, except
that a device time the profiler does not see is printed as null, not
measured):

1. card: the GPU's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: the ten Hopper kernels are compiled from lightgbm_tpu_torch/csrc
   by nvcc into one library (ops/cuda_lib.py), and the build time printed;
3. kernels: each kernel's wrapper runs on the card at the main paths'
   shapes and is held against its plain PyTorch version on the same
   inputs: integer outputs and histograms exactly, leaf sums' counts
   exactly and g, h within 1e-6 of the row mass, two launches of a leaf
   sum bit for bit. The fused path's kernels at N = 10.5M rows, F = 28,
   B = 64, L = 255 (grad_quant_hist0 with 3 and 2 channels, its two
   launches split by device time, and at its packed cells' worst case:
   every row kept, in bin 0, at |gq| = |hq| = 127; leaf_sums_grad on
   uniform and on skewed leaf ids, leaf k drawn with probability
   proportional to 1 / (k + 1); the level pass, given
   the row-major bins, at a first level, S = 1, at S = 32 and 127 slots
   and on a skewed S = 127 level, with 2 and 3 channels); the unfused
   path's at B = 256: route_level at S = 32 and 127 (slot, new leaf id and
   per-slot counts, the counts also against the bincount of its slots),
   leaf_sums at L = 255 on the two leaf-id distributions, and the two
   slot histograms, hist_q8 (2 and 3
   channels) and hist_f32 (f32 rows; counts exactly, g and h within 2^-15
   of the cell's absolute mass), at S = 1 (no slot vector), at S = 32 and
   127 fed the slots and the counts route_level gives (NA bins, leaves
   that do not split, about half the rows in dropped slots; each also
   without the counts, against the same yardstick), on a skewed level
   (S = 127, about half the kept rows in one slot) and on two
   lossguide-shaped passes (S = 1, about 5% and 0.5% of the rows kept),
   hist_f32 also at B = 64 and S = 127; hist_q8 at path (i)'s width,
   F = 700, B = 64 (three feature groups a slot block), 473,134 rows,
   at the root and at S = 32, with and without the counts; and the level
   pass (S = 1, 32, 127) and route_level (S = 32, 127) with categorical
   membership at path (k)'s shape, F = 8, B = 256 (six features of
   skewed categories, route tables mixing numerical and categorical
   leaves, an is_cat row and each leaf's bitset; each also timed on the
   same tables read numerically, without the bitset), and those three
   levels (S = 1, 32, 127) replayed in one hist_routed_fused_multi call
   (B2's multi-level replay), exactly against its plain version and the
   three hist_routed_fused launches; route_level with
   EFB bundle bitsets and hist_q8 fed its slots and counts at path (l)'s
   shape, F = 16, B = 256 (six single columns, ten bundle columns of 127
   one-hot members; bundle leaves sending a member's range prefix and
   every bin outside the range left, or only the bins outside it), at
   S = 32 and 127; hist_q8 and hist_f32 on a feature tile read in place
   at path (n)'s shape (the whole row-major bins [473,134, 700], B = 64,
   bins_T's rows [lo, hi) and a column offset: the lean grower's tile
   [172, 344) at S = 254 fed route_level's slots and counts, the same
   tile at the root, and the unaligned tile [5, 177) at S = 254), each
   also on a contiguous copy of the tile. Each kernel
   is timed
   (median of CUDA-event timings), beside its plain version, the least
   time the card could take (bytes over memory rate or operations over
   peak rate, counting only what the data needs) and one PyTorch call
   computing the same function where one exists (for the slot histograms
   an index_add_ over flat cell indices, int32 for hist_q8, checked
   against the plain version; index_select for take_small; index_add_ of
   the rows for the leaf sums); take_small, its index_select, route_level,
   the level pass at S = 127 and the leaf sums also by the device time of
   their kernels alone (torch.profiler), without the host
   time that event timings include;
4. main paths: a HIGGS-shaped 10.5M x 28 table (bench.py's generator,
   copied) through lightgbm_tpu_torch.Dataset and train(), one constructed
   Dataset a bin count: a binary model (num_leaves=255, learning_rate=0.1,
   min_data_in_leaf=20) and an L2 model on a continuous target, (a) at
   max_bin=63 (B = 64, F * B = 1792: the fused quantized path), (b) at the
   default max_bin=255 (B = 256, F * B = 7168: the unfused quantized
   path), (c) at 255 with use_quantized_grad=false (the depthwise grower
   on f32 histograms) and (d) at 255 with grow_policy=lossguide (the
   leaf-wise grower, never quantized); binary for 5 iterations on (a)-(c)
   and 3 on (d), L2 for 2 on each. The launch counters are zeroed before
   each path and read after; on (a) they must equal one grad_quant_hist0 /
   leaf_sums_grad / take_small per tree and one hist_routed_fused per
   level pass, on (b) one hist_q8 per tree and per level pass, one
   route_level per level pass and one leaf_sums / take_small per tree, on
   (c) one hist_f32 per tree and per level pass, one route_level per level
   pass and one take_small per tree, on (d) one hist_f32 per tree and per
   split and one take_small per tree, and zero for every other kernel. On
   each path: train AUC on 1M rows > 0.7, the L2 model's squared error
   below the label variance, the saved model text loads back and predicts
   identically; the peak device memory of its training is printed;
   B2's multi-level replay on (a)'s data: the route tables of the first
   three level passes of one tree of (a)'s binary model (3 channels) and
   of its L2 model (2), recorded from the live hist_routed_fused calls of
   one update of the serial grower with capture off, each level at its
   own slot width (the slots its tables fill), replayed in one
   hist_routed_fused_multi launch from the root's leaf ids, equal to the
   live passes and to the plain version bit for bit and timed beside the
   three D = 1 launches and its bound; then the path that runs it,
   scripts/torch_profile_level.py's shallow megapass at (a)'s width:
   levels 1-5 of one tree in two launches (grad_quant_hist0,
   hist_routed_fused_multi; the counts zeroed before and read after),
   bit-identical to five sequential level passes;
   then (e) "sampled": max_bin=63 with bagging_fraction 0.8 every
   iteration, feature_fraction 0.8 and feature_fraction_bynode 0.8, a
   500,000-row synth_higgs valid set (seed 1), early stopping after 3
   rounds, binary for up to 10 iterations (valid AUC) and L2 for up to 3
   (valid l2): the fused front's launch counts (take_small twice a tree,
   train and valid score), an in-bag share of 0.8 +- 0.001, 22 of 28
   features a tree, best_iteration, and a saved model that holds the
   best_iteration trees and predicts as the booster does; the bag draw
   timed on the card; and (f) "goss": boosting=goss (top_rate 0.2,
   other_rate 0.1) at max_bin=255, binary 5 and L2 2 iterations, on the
   unfused front with the hessian channel kept (hist_q8 / route_level /
   leaf_sums counts, none of the fused kernels), weights 0, 1 and 8, and
   the top-k and the weight draw timed; (g) "multiclass": num_class=5
   (the quintiles of the generator's latent score, its logit plus the
   logistic noise of its label draw) at max_bin=255, objective=multiclass
   for 3 iterations (15 trees) and multiclassova for 1, on a Dataset that
   takes (b)'s bin mappers: one hist_q8 / leaf_sums / take_small a class
   tree, hist_q8 and route_level once a level pass, nothing else;
   multi_logloss on 1M rows below ln 5 and falling each iteration, softmax
   rows summing to 1 within 1e-6, [1M, 5] predictions, the model text
   round trip, the peak device memory and the softmax gradients' time;
   (h) "weighted": row weights uniform on [0.5, 2) (RandomState(2)) at
   max_bin=63, a binary model for 3 iterations and a quantile model
   (alpha 0.9) on the L2 target for 2: the unfused front at F * B <= 2048
   (one hist_q8 root, one hist_routed_fused a level pass, one leaf_sums and
   one take_small a tree, none of B1 / B3), weighted train AUC on 1M rows
   > 0.7, the quantile model's weighted pinball loss below its init
   score's, the model text round trips, and the leaf renewal (a stable
   sort of 10.5M f32 keys) timed; (i) "ranking": a Yahoo-LTR-shaped set
   (scripts/parity_bench.py's synth_ranking, copied: 700 features, 40
   relevant, graded labels 0-4, queries of about 25 docs, seed 0), the
   whole queries in the first 473,134 rows for training and the next
   ones, about 50,000 rows, as the valid set, at max_bin=63 (F * B =
   44,800: the unfused front), objective=lambdarank, metric ndcg at
   eval_at 10, 3 iterations, then rank_xendcg for 2 on the same Dataset:
   one hist_q8 a tree and a level pass, one route_level a level pass, one
   leaf_sums and two take_small (train and valid score) a tree, nothing
   else; valid NDCG@10 above the constant score's, the model text round
   trip, the peak device memory, the gradients' time (CUDA events)
   beside s/iteration and each model's iteration by part
   (torch.profiler, the pair grid on its own line); (j) "boosters" on
   (a)'s Dataset, binary: DART (defaults, 6 iterations; its drop lists,
   one more take_small for each drop and rescale, the train score against
   the saved model's raw prediction within 1e-5 of the largest, one
   tree's replay timed), RF (bagging 0.8 every iteration,
   feature_fraction 0.8, 3 iterations on the weighted path's front; AUC,
   average_output in the model text, its round trip), a 2-iteration model
   continued for 2 from its file with the 500,000-row valid set (the
   valid score after the replay against the old model's prediction
   within 1e-6 of the largest, old plus continued predictions against the
   train score), the same continuation through Dataset(init_score=) (the
   first new tree's structure equal) and a refit on 1M rows (no kernel,
   finite leaves, AUC); (k) "categorical": an airline-shaped set
   (synth_airline: the ASA Data Expo 2009 on-time data as benchm-ml trains
   it, 10M rows, 8 columns of which Month, DayofMonth, DayOfWeek,
   UniqueCarrier, Origin and Dest are categorical, label
   dep_delayed_15min, about 19% positive) at max_bin=255 (F * B = 2048,
   the fused front, as the reference's gate says), binary for 5
   iterations with a 100,000-row valid set of another seed holding
   unseen categories and NaN: one grad_quant_hist0 / leaf_sums_grad a
   tree, one hist_routed_fused a level pass, two take_small a tree,
   nothing else; valid AUC above 0.7, a categorical node in the first
   tree, the model text round trip with its cat_threshold, predictions
   from raw values against the train and valid scores, the construct
   seconds and the iteration by part; (k') the same Dataset unquantized
   for 3 iterations (hist_f32 a tree and a level pass, route_level a
   level pass, take_small a tree); and for information the valid AUC
   with the six columns numerical; (l) "bundled": the same rows one-hot
   encoded (airline_onehot: a 10M x 674 CSR matrix, DepTime and Distance
   numeric, 8 stored values a row, the LightGBM paper's Flight Delay
   shape) at max_bin=255 with the default enable_bundle, binary for 5
   iterations with the valid set in the train's column layout: at least
   one bundle and fewer columns than 674, the launch contract of the
   front the bundled width F_b * B gives (above 2048 cells: hist_q8 a
   tree and a level pass, route_level a level pass, leaf_sums a tree;
   two take_small a tree, train and valid score), the recorded valid
   AUC equal to the AUC of Booster.predict on the sparse valid rows
   within 1e-4 and above 0.7, a
   node of the first tree on a bundle column, the model text round trip
   naming the original features only, predictions from raw values
   against the train and valid scores; the construct's seconds by phase,
   F_b, its peak host RSS, the card's bins against the unbundled bytes,
   s/iteration and the iteration by part printed; (l') the same Dataset
   with grow_policy=lossguide for 3 iterations (hist_f32 a tree and a
   split, take_small a tree); (m) "constrained" on (a)'s Dataset: binary
   5 iterations with monotone_constraints the signs of the generator's
   weights on features 0-7, feature_contri 0.5 on the noise features
   11-27 and extra_trees (the fused front's launch contract); (m') its
   own Dataset with forced bins (feature 0 at [-1, 0, 1], 1 at [0]),
   5 iterations with forced splits (the root on 0 at 0.0, its left child
   on 1 at 0.0) and CEGB (CONSTRAINED_CEGB: hist_q8 a tree for the root,
   hist_routed_fused a level pass, leaf_sums and take_small a tree);
   (m'') lossguide 2 iterations on (a)'s Dataset with (m)'s constraints
   off the forced features, extra_trees and (m')'s forced splits
   (hist_f32 a tree and a split, take_small a tree); gates: the raw
   predictions of (m) and (m'') ordered in each constraint's direction on
   1,000 rows swept over 32 values of each constrained feature (no
   tolerance; (a)'s violations printed), every (m') tree forced at its
   root and left child in the reloaded model text, no (m') node on 20-27
   and a first-tree node on 8-10, AUC on 1M rows above 0.7; the lazy
   CEGB plane timed and the iteration by part of (m) and (a) printed;
   (n) "lean": (i)'s Dataset and valid set with histogram_pool_size=32,
   lambdarank 3 iterations on the lean depthwise grower (feature tiles
   of 172 columns: hist_q8 a tile at the root and after each level's
   route_level, leaf_sums twice and take_small twice a tree); (n') the
   same unquantized, 2 (hist_f32 a tile and pass, leaf_sums once); gates:
   the live tile within the budget, valid NDCG@10 within 0.01 of (i)'s
   lambdarank at each iteration and above the constant score's, the
   peak device memory of one tree's growth below the default grower's on
   the same gradients; the trees equal to (i)'s printed; (n'') "pooled":
   (d) with histogram_pool_size=8 (97 of 255 leaf histograms cached),
   binary 2 iterations: hist_f32 a tree, a split and a rebuild of an
   evicted parent, take_small a tree, at least one rebuild a tree, AUC on
   1M rows within 0.005 of (d)'s at 2 iterations; (o) "api" on (a)'s
   data: LGBMClassifier(n_estimators=3, num_leaves=255, max_bin=63) on
   the numpy rows, its model text equal to train's under the parameters
   it passes; cv on the first 1M rows (3 stratified folds, 3 rounds, AUC
   above 0.7 on every fold); save_binary / load_binary of 1M rows training
   the same model text; rollback_one_iter from 3 iterations leaving train
   and valid scores within 1e-6 of the largest of a 2-iteration run's; a
   pickled Booster predicting identically; (q) "telemetry" on (a)'s
   Dataset, binary with (a)'s parameters: 6 iterations with telemetry,
   metrics_out, xla_trace_out, snapshot_freq 2 and faults=tree_update@5,
   resumed from its snapshot at 4 to 6 with telemetry on, and the same 6
   with telemetry off: the resumed model text equal to the telemetry-off
   one, events.jsonl's train_iter, snapshot_write, fault_injected and
   resume events those of the run, metrics.json's train_iterations and
   device 0's peak memory (above the bins' bytes), metrics.prom parsed,
   the Chrome trace naming B1-B4's CUDA kernels and each traced
   iteration's boosting range, the launch counts the fused front's over
   the 13 trees; s/iteration with telemetry on and off in 5 interleaved
   pairs, the trace's size and write time printed; (p) "cli": synth_higgs rows as
   tab-separated text with the label first (2M train rows, the next
   500,000 of the same draw as valid), path (a)'s parameters with
   bagging 0.8 every iteration and feature_fraction 0.8: `python -m
   lightgbm_tpu_torch config=train.conf` trains 8 iterations with a
   snapshot every 2 (snapshot_keep 3), parsed by the native parser (it
   fails if the Python parser ran), valid AUC above 0.7; engine.train on
   the same parsed rows, killed by faults=tree_update@5 and resumed from
   its snapshot, must end with the CLI model's text byte for byte (fused
   front B1-B4; else it prints the first differing tree and leaf);
   task=predict's result file equal to Booster.predict exactly;
   task=convert_model compiled by g++ within rtol 2e-5, atol 1e-6 of
   predict's raw scores on 10,000 rows; pred_contrib on 200 rows summing
   to the raw score within 1e-9 relative; the C API library built and a
   pure-C host (gcc) training 2 iterations from a config file and
   predicting 1,000 rows ("%.17g") equal to Booster.predict of its model;
   a custom objective NaN on 1,000 rows at iteration 2 of 5 (B5 root, B2
   levels, B7, B4) under nonfinite_policy fatal (raises), warn_skip_tree
   (4 trees) and clip (5 trees, finite scores), and an L2 run on labels
   near 1e38 at learning_rate 1e38 (the fused front) raising under fatal;
   each step's seconds printed beside the card's name and power limit;
   then (r) "cold start and serve" on (a)'s rows: the ingest pipeline in
   6 chunks and in one, an OOM drill, two cold-start processes, 100
   iterations under the fused front's contract, the serving engine, a
   PredictServer under load, its transports and a 2-replica fleet with
   a shadow rollback and a canary promotion (``serve_path``); then (s)
   "online" on (a)'s rows: b1 trained on the first 10M, the next 500,000
   fed into a write-ahead-logged OnlineTrainer attached to a
   PredictServer under 8 closed-loop clients, one boost cycle under the
   fused front's launch contract (B1-B4, B4 also for b1's 20 replayed
   trees) byte for byte the offline append + train(init_model=) + merge,
   a refit cycle, a kill-and-replay drill across two processes
   (scripts/torch_online_drill.py), and the !learn / capture / !label
   lines, task=online and the C host's LGBMTPU_Online* entries
   (scripts/torch_online_host.c), each against the Python API
   (``online_path``); then (t) "mesh" on (a)'s rows over 4 virtual copies
   of the card (``mesh_path``): the data-parallel learner on exact sums
   byte for byte serial (B8, B6, B4 per shard), the fused quantized path
   on 4 shards (B1-B4 per shard; s/iteration and the bytes a level sums
   beside serial's, the valid AUC within 0.002, a 4,000-row model equal
   to the CPU's), the feature-parallel learner on 7-feature tiles, the
   voting learner (every feature elected: byte for byte; top_k=5 fused and
   at max_bin=255 through B5, B6, B7 at up to 254 slots), the 2-D mesh,
   the mesh faults (a retried hist_allreduce, device_put_oom's reshard and
   fallback_single rungs, a kill on 4 shards resumed on 2) and the real
   device count; then (u) "pod" on (a)'s rows over 2 rank processes
   (``pod_path``, scripts/torch_pod_worker.py: a torch.distributed
   group, gloo on one card and NCCL when each rank has its own, each rank
   reading its half of one .npy on 2 virtual copies of its card, so
   (t)'s 4-shard grid): (t1)'s lattice model (B8, B6, B4 a rank) with the
   merged-sketch mappers equal to serial bins and the model byte for byte
   (t1)'s, one cross-rank sum at S 127 timed, the fused binary path (B1-B4)
   with the valid AUC within 1e-4 of (t2)'s 4 shards, voting at
   max_bin=255 (B5, B6, B7, B4), a rank at another learning_rate failing
   the consistency fence on both ranks, and both ranks killed at
   iteration 2 and rank 0's snapshots resumed in this process, byte for
   byte (t1); then, in a second pair of rank processes, (u6) (u1)'s
   lattice model with lazy CEGB on 8 features and a snapshot every 2
   iterations (whose lazy bitset the snapshot gathers from both ranks,
   ROADMAP C18), killed at iteration 3, each rank under
   POD_RANK_TIMEOUT_S, and resumed in this process on 4 virtual shards,
   byte for byte the unkilled 4-shard model; then (v)
   "analysis" (``analysis_path``): (v1) the port's lint
   (lightgbm_tpu_torch.analysis, pure AST) over its tree, clean against
   its empty baseline, with the inventory of host syncs in the level, step
   and iteration loops by file:line and its host seconds; (v2) the
   nonfinite-policy-smoke rule trained on the card (fatal raises,
   warn_skip_tree keeps 2 trees, clip 5 with finite predictions); (v3)
   scripts/torch_lockwatch_drill.py in a fresh process: the port's
   lockwatch installed before the port is imported, (a)'s parameters 5
   iterations (B1-B4) on (a)'s first 10M rows, a PredictServer under 8
   closed-loop clients for 2 s and through an OnlineTrainer boost cycle
   on the next 500,000 rows, then a 2-replica fleet promoting a clean
   canary: every answer its version's bit for bit and no lock-order
   inversion, the lock sites and edges counted;
5. agreement, at max_bin=63 and at 255 (the 4000-row table has more than
   128 bins a feature, so the unfused path, which is asserted): the first
   tree of a 4000-row L2 model trained on the card has the structure of
   the same tree trained through the plain versions on the CPU, and leaf
   values within 1e-6 of its largest leaf value in magnitude (the one
   difference is the f64 order of the leaf sums; later trees inherit it,
   so only the first is compared exactly). Paths (c) and (d) at both bin
   counts on exact-sum data (labels on a 1/8 grid in [0, 4), no init
   score, so the first tree's gradients are -label and h = 1, and every
   histogram sum is exact in any order): the first tree equals the
   CPU-trained one bit for bit, leaf values included. With sampling, on
   4000 rows: (e)'s settings, GOSS, and f32 and lossguide with bagging and
   feature_fraction_bynode give the card the CPU run's bag and feature
   masks and first-tree structure, leaf values within 1e-6 of the largest
   leaf; an early-stopped L2 run (a valid label the model moves away
   from) stops at the CPU run's iteration with its best_iteration; a K = 3
   multiclass model's first three trees, a weighted quantile model's first
   tree (its renewed leaf values bit for bit) and an fobj model's first
   tree (the L2 gradient as a custom function) have the CPU run's
   structure, leaf values within 1e-6 of the largest; a lambdarank model
   on about 160 queries (first tree), on exact-sum labels a DART model
   (drop lists and all four trees) and an RF model (bag mask and first
   tree), and a refit of a card-trained binary model agree with the CPU
   the same way; a 4000-row airline model with its six categorical
   columns on exact-sum labels has the CPU's first tree (structure and
   categories) on the fused quantized path (leaf values within 1e-6 of
   the largest) and unquantized and lossguide (bit for bit); the same
   4000 airline rows one-hot (bundled) on the same three paths from the
   CSR matrix and from the dense array (whose model text must equal the
   CSR one's); three 4000-row trees of (m), (m') and (m'') on exact-sum
   labels have the CPU's structure, leaf values within 1e-6 of the
   largest (lossguide's first tree bit for bit, its later trees, whose f32
   histograms sum off-grid gradients with atomics, within 2^-17), and
   (m)'s extra_trees
   draws are the CPU's bit for bit; three 4000-row trees of (n), (n') and
   (n'') (lean tiles of 5 columns, a pool of 4 leaves) on the same labels
   likewise (quantized within 1e-6; unquantized the first tree bit for
   bit, later ones within 2^-17); and the threefry replica's uniforms
   at N rows are the CPU's bit for bit.

The line before the last is the JSON kernel table; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""
# Every file this run writes (rank specs, text rows for the CLI, logs, C
# hosts) is a transient input or record of this run under its own work
# directory, read back within the run: atomic writes buy nothing here.
# tpu-lint: disable-file=non-atomic-artifact-write
import dataclasses
import json
import os
import pickle
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N, F, B, L = 10_500_000, 28, 64, 255
BW = 256              # the bin axis of the default max_bin=255
FUSED = ("grad_quant_hist0", "hist_routed_fused", "leaf_sums_grad")
UNFUSED = ("hist_q8", "route_level", "leaf_sums")
# the main paths of phase 4: (max_bin, extra parameters, binary iterations)
PATHS = {"fused": (63, {}, 5), "unfused": (255, {}, 5),
         "f32": (255, {"use_quantized_grad": "false"}, 5),
         "lossguide": (255, {"grow_policy": "lossguide"}, 3)}
# path (e)'s sampling: bagging, feature_fraction, feature_fraction_bynode
SAMPLED = {"bagging_fraction": 0.8, "bagging_freq": 1,
           "feature_fraction": 0.8, "feature_fraction_bynode": 0.8}
GOSS = {"boosting": "goss", "top_rate": 0.2, "other_rate": 0.1}
N_VALID = 500_000
# path (i): Yahoo LTR set 1's train rows and a valid set of the next queries
N_RANK, F_RANK, N_RANK_VALID = 473_134, 700, 50_000
# path (j)'s RF sampling
RF = {"boosting": "rf", "bagging_fraction": 0.8, "bagging_freq": 1,
      "feature_fraction": 0.8}
# the saved model goes beside the kernel library (ignored by git)
OUT_DIR = os.path.join(HERE, "lightgbm_tpu_torch", "_build")
# path (p) "cli": HIGGS rows as the reference's binary.train text (label
# first, tab-separated), 2M train and the next 500,000 rows of the same
# draw as valid, through the command line with path (a)'s parameters and
# every RNG stream on
N_CLI, N_CLI_VALID = 2_000_000, 500_000
CLI_PARAMS = {"objective": "binary", "max_bin": 63, "num_leaves": L,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "metric": "auc",
              "bagging_fraction": 0.8, "bagging_freq": 1,
              "feature_fraction": 0.8}
# the non-finite policies' custom objective turns these rows NaN at its
# third call
NF_ROWS = 1000


# path (m')'s CEGB: a split penalty, a coupled penalty far above any gain
# on features 20-27, a lazy one on 8-10 small enough that the first tree
# still splits on one of them (at 0.005 a row it did not, at 10.5M rows)
CONSTRAINED_CEGB = {"cegb_penalty_split": 1e-4,
                    "cegb_penalty_feature_coupled": [0.0] * 20 + [1e9] * 8,
                    "cegb_penalty_feature_lazy": [0.0] * 8 + [0.0005] * 3
                    + [0.0] * 17}


def constrained_params(w):
    """Path (m)'s settings: monotone constraints of the signs of the
    generator's weights on features 0-7, feature_contri 0.5 on the noise
    features 11-27, extra_trees."""
    return {"monotone_constraints": [int(np.sign(v)) for v in w[:8]]
            + [0] * 20,
            "feature_contri": [1.0] * 11 + [0.5] * 17, "extra_trees": True}


def lossguide_monotone(mono):
    """Path (m'')'s monotone constraints: (m)'s, but none on the forced
    features 0 and 1. The basic monotone method pins the midpoint of a
    split on a constrained feature as a bound on both subtrees; a forced
    root on a weak constrained feature pins the root's mean, and each half
    of the tree can then move only one way (AUC 0.646 after 2 iterations
    at 10.5M rows, against 0.80 without the forced splits)."""
    return [0, 0] + list(mono["monotone_constraints"][2:])


def constrained_files():
    """(forced splits, forced bins) JSON files of paths (m'), (m'') in the
    ignored build directory."""
    os.makedirs(OUT_DIR, exist_ok=True)
    forced = os.path.join(OUT_DIR, "forced_splits.json")
    with open(forced, "w") as fh:
        json.dump({"feature": 0, "threshold": 0.0,
                   "left": {"feature": 1, "threshold": 0.0}}, fh)
    fbins = os.path.join(OUT_DIR, "forced_bins.json")
    with open(fbins, "w") as fh:
        json.dump([{"feature": 0, "bin_upper_bound": [-1.0, 0.0, 1.0]},
                   {"feature": 1, "bin_upper_bound": [0.0]}], fh)
    return forced, fbins


def constrained_parity_cases(Xs, w):
    """Phase 5's 4000-row models of paths (m), (m') and (m''): the
    exact-sum labels (the generator's logit on a 1/8 grid, no init score)
    and, a path each, (name, training parameters, Dataset parameters, the
    kernels it must launch). Here (m'') keeps (m)'s monotone constraints
    on the forced features 0 and 1, which its full-size run leaves off,
    so the card runs a forced split on a constrained feature.
    scripts/torch_constrained_parity.py measures the same models."""
    forced, fbins = constrained_files()
    mono = constrained_params(w)
    ym8 = np.clip(np.floor((Xs[:, :8] @ w * 0.7 - 0.4 * Xs[:, 10] ** 2)
                           * 8) / 8, -6.0, 5.875).astype(np.float32)
    base = {"objective": "regression", "num_leaves": 31, "max_bin": 63,
            "min_data_in_leaf": 20, "verbosity": -1,
            "boost_from_average": False}
    return ym8, (
        ("constrained (m)", dict(base, **mono), {}, FUSED),
        ("constrained (m')", dict(base, forcedsplits_filename=forced,
                                  **CONSTRAINED_CEGB),
         {"forcedbins_filename": fbins},
         ("hist_q8", "hist_routed_fused", "leaf_sums")),
        ("constrained (m'')", dict(
            base, grow_policy="lossguide", extra_trees=True,
            monotone_constraints=mono["monotone_constraints"],
            forcedsplits_filename=forced), {}, ("hist_f32",)))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def synth_higgs(n_rows: int, n_feat: int = 28, seed: int = 0,
                latent: bool = False, weights: bool = False):
    """HIGGS-shaped binary problem (a copy of bench.py synth_higgs). With
    latent, also the latent score behind each label: the logit plus the
    logistic noise of the uniform draw u that makes it, logit - logit(u),
    so y = latent > 0 (path (g) cuts its classes from it). With weights,
    last, the generator's weights w of features 0-7, which enter the logit
    linearly (path (m) constrains them by their signs)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n_rows, n_feat).astype(np.float32)
    w = rng.randn(8)
    logits = (X[:, :8] @ w) * 0.7 + 0.5 * np.abs(X[:, 8]) * X[:, 9] \
        - 0.4 * (X[:, 10] ** 2) + 0.3
    p = 1.0 / (1.0 + np.exp(-logits))
    u = rng.rand(n_rows)
    y = (u < p).astype(np.float32)
    out = [X, y]
    if latent:
        with np.errstate(divide="ignore"):
            out.append((logits - np.log(u / (1.0 - u))).astype(np.float32))
    if weights:
        out.append(w)
    return tuple(out)


def synth_ranking(n_rows, n_feat=700, n_rel_feat=40, seed=0,
                  mean_docs=25):
    """Yahoo-LTR-shaped synthetic ranking set (a copy of
    scripts/parity_bench.py synth_ranking): graded relevance 0-4, a noisy
    monotone function of a sparse linear score over the first n_rel_feat
    features; query sizes geometric around mean_docs. Returns (X, y,
    group)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n_rows, n_feat).astype(np.float32)
    w = np.zeros(n_feat)
    w[:n_rel_feat] = rng.randn(n_rel_feat)
    score = X @ w / np.sqrt(n_rel_feat) + 0.7 * rng.randn(n_rows)
    qtl = np.quantile(score, [0.55, 0.8, 0.93, 0.985])
    y = np.digitize(score, qtl).astype(np.float32)
    sizes = []
    total = 0
    while total < n_rows:
        sz = max(2, int(rng.geometric(1.0 / mean_docs)))
        sz = min(sz, n_rows - total)
        sizes.append(sz)
        total += sz
    if sizes[-1] < 2 and len(sizes) > 1:
        sizes[-2] += sizes[-1]
        sizes.pop()
    return X, y, np.asarray(sizes, dtype=np.int64)


# path (k): the airline data's categorical columns (Month, DayofMonth,
# DayOfWeek, UniqueCarrier, Origin, Dest), its train and valid rows
AIRLINE_CATS = [0, 1, 2, 4, 5, 6]
N_AIR, N_AIR_VALID = 10_000_000, 100_000


def synth_airline(n_rows: int, seed: int = 0, latent: bool = False):
    """Airline-shaped binary problem: the ASA Data Expo 2009 on-time data
    as benchm-ml trains it, 8 columns (Month 1-12, DayofMonth 1-31,
    DayOfWeek 1-7, DepTime as hhmm 1-2400, UniqueCarrier 22 codes, Origin
    and Dest about 300 airport codes each, Zipf-skewed, Distance 30-4,960
    miles) and the label dep_delayed_15min (about 19% positive). The label
    follows a latent score of random per-category effects that are not
    monotone in the codes (only subset splits separate them), a later
    departure and the distance, with logistic noise; the effects come from
    a fixed seed, so every seed's rows follow one rule. With latent, also
    that score before its noise."""
    rng = np.random.RandomState(seed)
    fx = np.random.RandomState(20090)
    n_air = 300
    pop = 1.0 / np.arange(1, n_air + 1) ** 1.1
    code_of_rank = fx.permutation(n_air)
    car = 1.0 / np.arange(1, 23) ** 0.8
    eff = {k: fx.randn(v) for k, v in (("month", 13), ("dom", 32),
                                       ("dow", 8), ("car", 22),
                                       ("org", n_air), ("dst", n_air))}
    X = np.empty((n_rows, 8), np.float32)
    month = rng.randint(1, 13, n_rows)
    dom = rng.randint(1, 32, n_rows)
    dow = rng.randint(1, 8, n_rows)
    minute = np.clip(rng.normal(810, 270, n_rows), 1, 1439).astype(np.int64)
    dep = (minute // 60) * 100 + minute % 60
    carrier = rng.choice(22, n_rows, p=car / car.sum())
    org = code_of_rank[rng.choice(n_air, n_rows, p=pop / pop.sum())]
    dst = code_of_rank[rng.choice(n_air, n_rows, p=pop / pop.sum())]
    dist = np.clip(np.exp(rng.normal(6.4, 0.7, n_rows)), 30, 4960).round()
    for j, col in enumerate((month, dom, dow, dep, carrier, org, dst, dist)):
        X[:, j] = col
    score = (0.5 * eff["month"][month] + 0.2 * eff["dom"][dom]
             + 0.3 * eff["dow"][dow] + 0.002 * (minute - 720)
             + 0.7 * eff["car"][carrier] + 0.9 * eff["org"][org]
             + 0.8 * eff["dst"][dst] + 0.1 * np.log(dist))
    u = rng.rand(n_rows)
    with np.errstate(divide="ignore"):
        noisy = score + np.log(u / (1.0 - u))
    # the cut at the rule's 81st percentile (fixed, so seeds agree)
    y = (noisy > 3.33).astype(np.float32)
    if not latent:
        return X, y
    return X, y, score.astype(np.float32)


def airline_valid(n_rows: int, seed: int = 1):
    """synth_airline rows of another seed with a few unseen categories
    (Origin and Dest codes past the 300 seen, carrier 22) and NaN in the
    categorical and numeric columns; they route right."""
    X, y = synth_airline(n_rows, seed)
    rng = np.random.RandomState(seed + 100)
    X[rng.rand(n_rows) < 0.01, 5] = 300 + rng.randint(0, 10)
    X[rng.rand(n_rows) < 0.01, 6] = 305
    X[rng.rand(n_rows) < 0.005, 4] = 22
    for j in (3, 5, 7):
        X[rng.rand(n_rows) < 0.01, j] = np.nan
    return X, y


# path (l): synth_airline's categorical columns one-hot encoded, each
# (column of X, first code, codes): Month, DayofMonth, DayOfWeek,
# UniqueCarrier, Origin, Dest; DepTime and Distance stay numeric
ONE_HOT = ((0, 1, 12), (1, 1, 31), (2, 1, 7), (4, 0, 22), (5, 0, 300),
           (6, 0, 300))


def airline_onehot(X):
    """synth_airline rows as the LightGBM paper's Flight Delay data feeds
    EFB: a scipy CSR matrix of 2 + 672 = 674 columns, DepTime and Distance
    in columns 0 and 1, then one column a code of Month, DayofMonth,
    DayOfWeek, UniqueCarrier, Origin and Dest (a 1.0 in the row's code);
    8 stored values a row, and an all-zero block where a code lies outside
    the training codes or is NaN."""
    import scipy.sparse as sps
    n = X.shape[0]
    cols = [np.zeros(n, np.int32), np.ones(n, np.int32)]
    vals = [X[:, 3], X[:, 7]]
    keep = [np.ones(n, bool), np.ones(n, bool)]
    base = 2
    for j, first, k in ONE_HOT:
        code = X[:, j]
        ok = np.isfinite(code) & (code >= first) & (code < first + k)
        cols.append((base + np.where(ok, code - first, 0)).astype(np.int32))
        vals.append(np.ones(n, np.float32))
        keep.append(ok)
        base += k
    keep = np.stack(keep, 1)
    indptr = np.concatenate([[0], np.cumsum(keep.sum(1))]).astype(np.int64)
    return sps.csr_matrix((np.stack(vals, 1)[keep], np.stack(cols, 1)[keep],
                           indptr), shape=(n, base))


def peak_rss(fn):
    """(fn's result, the resident set of this process before fn, and its
    peak while fn ran, in bytes: /proc/self/statm read every 20 ms by a
    thread)."""
    import threading
    page = os.sysconf("SC_PAGE_SIZE")

    def rss():
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * page
    before = rss()
    peak = [before]
    done = threading.Event()

    def watch():
        while not done.wait(0.02):
            peak[0] = max(peak[0], rss())
    th = threading.Thread(target=watch, daemon=True)
    th.start()
    try:
        out = fn()
    finally:
        done.set()
        th.join()
    return out, before, max(peak[0], rss())


def split_queries(X, y, group, n_train):
    """The whole queries within the first n_train rows, and the rest, as
    parity_bench.py run_ranking splits them: (train, valid), each (X, y,
    group)."""
    bounds = np.cumsum(group)
    q_train = int(np.searchsorted(bounds, n_train))
    cut = int(bounds[q_train - 1])
    return ((X[:cut], y[:cut], group[:q_train]),
            (X[cut:], y[cut:], group[q_train:]))


def _write_rows(path, rows):
    np.savetxt(path, rows, fmt="%.9g", delimiter="\t")


def write_tsv(path: str, X, y, workers: int = 8) -> None:
    """X with the label first, tab-separated, "%.9g" (exact for f32), as
    the reference's examples/binary_classification/binary.train: parts
    written by spawned processes, then joined."""
    import concurrent.futures as cf
    import multiprocessing as mp
    rows = np.column_stack([y, X]).astype(np.float32)
    parts = [f"{path}.part{i}" for i in range(workers)]
    with cf.ProcessPoolExecutor(workers,
                                mp_context=mp.get_context("spawn")) as ex:
        list(ex.map(_write_rows, parts, np.array_split(rows, workers)))
    with open(path, "wb") as out:
        for part in parts:
            with open(part, "rb") as fh:
                while True:
                    block = fh.read(64 << 20)
                    if not block:
                        break
                    out.write(block)
            os.remove(part)


def cli_path(launches_all, card: str) -> dict:
    """(p) "cli": the command line, snapshots, the C++ codegen, TreeSHAP,
    the C API and the non-finite guard on the card. Returns its seconds
    by step."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import metrics
    from lightgbm_tpu_torch.io import parser
    from lightgbm_tpu_torch.native.build_capi import build_capi
    from lightgbm_tpu_torch.ops import hist_kernels as hk
    from lightgbm_tpu_torch.utils.faults import FaultInjected

    import shutil
    tag = "[cli (p), max_bin=63]"
    # the CLI and the C host are processes of their own on the same card
    torch.cuda.empty_cache()
    work = os.path.join(OUT_DIR, "cli_path")
    if os.path.isdir(work):
        shutil.rmtree(work)
    os.makedirs(work)
    sec = {}
    t0 = time.perf_counter()
    # the valid rows are held out of the same draw: another seed draws
    # another generator's weights (a valid AUC near 0.5)
    X, y = synth_higgs(N_CLI + N_CLI_VALID, F, seed=0)
    X, Xv, y, yv = X[:N_CLI], X[N_CLI:], y[:N_CLI], y[N_CLI:]
    train_f = os.path.join(work, "higgs.train")
    valid_f = os.path.join(work, "higgs.test")
    write_tsv(train_f, X, y)
    write_tsv(valid_f, Xv, yv)
    sec["write_text_s"] = time.perf_counter() - t0
    print(f"{tag} text files: {os.path.getsize(train_f)} + "
          f"{os.path.getsize(valid_f)} bytes, written in "
          f"{sec['write_text_s']:.3f} s; card: {card}")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([HERE] + [p for p in sys.path
                                                    if p]))

    def run(cmd, what, timeout=600):
        t = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=work, timeout=timeout)
        dt = time.perf_counter() - t
        if r.returncode != 0:
            fail(f"{what}: exit {r.returncode}\n{r.stderr[-3000:]}")
        return r, dt

    def conf_file(name, extra):
        path = os.path.join(work, name)
        with open(path, "w") as fh:
            for k, v in {**CLI_PARAMS, **extra}.items():
                fh.write(f"{k}={v}\n")
        return path

    # 1. python -m lightgbm_tpu_torch config=train.conf
    snaps = os.path.join(work, "snaps")
    model_f = os.path.join(work, "model.txt")
    conf = conf_file("train.conf", {
        "task": "train", "data": train_f, "valid": valid_f,
        "num_iterations": 8, "snapshot_freq": 2, "snapshot_dir": snaps,
        "snapshot_keep": 3, "output_model": model_f, "verbosity": 1})
    r, dt = run([sys.executable, "-m", "lightgbm_tpu_torch",
                 f"config={conf}"], "CLI train")
    sec["cli_train_s"] = dt
    log_ = r.stderr
    m_load = re.search(r"Finished loading data in ([0-9.]+) seconds "
                       r"\(parser: (\w+)\)", log_)
    m_iter = re.search(r"Finished training (\d+) iterations in ([0-9.]+) "
                       r"seconds \(([0-9.]+) s/iteration\)", log_)
    aucs = re.findall(r"higgs.test's auc: ([0-9.]+)", log_)
    if not (m_load and m_iter and aucs):
        fail(f"CLI train: unexpected log\n{log_[-3000:]}")
    if m_load.group(2) != "native":
        fail(f"CLI train: the {m_load.group(2)} parser ran, not the "
             "native one")
    left = sorted(os.listdir(snaps))
    print(f"{tag} CLI train ({dt:.3f} s with the process start): parse + "
          f"construct {m_load.group(1)} s (native parser), "
          f"{m_iter.group(3)} s/iteration over {m_iter.group(1)} "
          f"iterations, valid AUC {aucs[-1]}; snapshot files left {left}")
    if int(m_iter.group(1)) != 8 or not float(aucs[-1]) > 0.7 or left != [
            "snapshot_iter_4.state.npz", "snapshot_iter_4.txt",
            "snapshot_iter_6.state.npz", "snapshot_iter_6.txt",
            "snapshot_iter_8.state.npz", "snapshot_iter_8.txt",
            "snapshot_manifest.json"]:
        fail(f"CLI train: iterations, valid AUC or snapshots wrong")
    with open(model_f) as fh:
        cli_text = fh.read()

    # 2. kill and resume on the card, through engine.train
    t = time.perf_counter()
    pf = parser.load_file(train_f)
    pv = parser.load_file(valid_f)
    sec["parse_in_process_s"] = time.perf_counter() - t
    print(f"{tag} in-process parse of both files: "
          f"{sec['parse_in_process_s']:.3f} s ({parser.LAST_PARSE_PATH})")
    if parser.LAST_PARSE_PATH != "native" or pf.X.shape != (N_CLI, F):
        fail(f"parser: {parser.LAST_PARSE_PATH}, shape {pf.X.shape}")
    params = dict(CLI_PARAMS, verbosity=-1)
    ds = lt.Dataset(pf.X, label=pf.label, params=params, free_raw_data=False)
    vs = lt.Dataset(pv.X, label=pv.label, reference=ds)
    kill_dir = os.path.join(work, "kill")
    hk.reset_launches()
    t = time.perf_counter()
    try:
        lt.train({**params, "snapshot_freq": 2, "snapshot_dir": kill_dir,
                  "faults": "tree_update@5"}, ds, 8, valid_sets=[vs],
                 verbose_eval=False)
        fail("kill and resume: faults=tree_update@5 did not raise")
    except FaultInjected as e:
        print(f"{tag} killed: {e}")
    from lightgbm_tpu_torch.utils import faults
    faults.reset()
    resumed = lt.train({**params, "snapshot_freq": 2,
                        "snapshot_dir": kill_dir}, ds, 8, valid_sets=[vs],
                       verbose_eval=False, resume_from_snapshot=kill_dir)
    torch.cuda.synchronize()
    sec["kill_and_resume_s"] = time.perf_counter() - t
    launches = dict(hk.LAUNCHES)

    def body(text):
        return text.split("\nparameters:\n")[0]
    same = body(resumed.model_to_string()) == body(cli_text)
    print(f"{tag} killed at iteration 6, resumed from iteration 4 to "
          f"{resumed.current_iteration}: model text equal to the CLI "
          f"run's: {same} ({sec['kill_and_resume_s']:.3f} s); launches "
          f"{launches}")
    if not same:
        ta = lt.Booster(model_str=cli_text,
                        params={"device_type": "cpu"})._host_trees()
        tb = resumed._host_trees()
        for i, (a, b) in enumerate(zip(ta, tb)):
            for f_ in ("split_feature", "threshold_bin", "leaf_value",
                       "leaf_count"):
                d_ = np.flatnonzero(getattr(a, f_) != getattr(b, f_))
                if len(d_):
                    print(f"{tag} first difference: tree {i}, {f_}[{d_[0]}]"
                          f" {getattr(a, f_)[d_[0]]} (CLI) against "
                          f"{getattr(b, f_)[d_[0]]} (resumed)")
                    break
        fail("kill and resume: the resumed model text differs from the "
             "uninterrupted CLI run's")
    if resumed.current_iteration != 8:
        fail(f"kill and resume ended at {resumed.current_iteration}")
    own = ("grad_quant_hist0", "hist_routed_fused", "leaf_sums_grad",
           "take_small", "split_search")
    if min(launches[k] for k in own) <= 0 or any(
            v for k, v in launches.items() if k not in own):
        fail(f"kill and resume: launches {launches} off the fused front")
    for k, v in launches.items():
        launches_all[k] += v

    # 3. task=predict on the valid file
    out_f = os.path.join(work, "pred.txt")
    # the train config with key=value overrides on the command line
    r, dt = run([sys.executable, "-m", "lightgbm_tpu_torch", f"config={conf}",
                 "task=predict", f"data={valid_f}", f"input_model={model_f}",
                 f"output_result={out_f}"], "CLI predict")
    m_rate = re.search(r"Predicted (\d+) rows in ([0-9.]+)s \(([0-9,]+) "
                       r"rows/s\)", r.stderr)
    cli_pred = np.loadtxt(out_f)
    bst = lt.Booster(model_file=model_f)
    t = time.perf_counter()
    own_pred = bst.predict(pv.X)
    torch.cuda.synchronize()
    dt_in = time.perf_counter() - t
    same = np.array_equal(cli_pred, own_pred)
    auc = float(metrics.auc(torch.as_tensor(pv.label),
                            torch.as_tensor(own_pred)))
    print(f"{tag} CLI predict of {N_CLI_VALID} rows ({dt:.3f} s with the "
          f"process start and parse): "
          f"{m_rate.group(3) if m_rate else '?'} rows/s in the CLI, "
          f"Booster.predict {N_CLI_VALID / dt_in:,.0f} rows/s (its first "
          f"call, {bst.num_trees()} trees); result file "
          f"equal to Booster.predict: {same}; AUC {auc:.6f}")
    if not same or not m_rate:
        fail("CLI predict: the result file differs from Booster.predict")
    sec["predict_rows_per_s"] = N_CLI_VALID / dt_in

    # 4. task=convert_model, compiled by g++, against predict()
    cpp_f = os.path.join(work, "model.cpp")
    run([sys.executable, "-m", "lightgbm_tpu_torch", f"config={conf}",
         "task=convert_model", f"input_model={model_f}",
         f"convert_model={cpp_f}"], "CLI convert_model")
    main_f = os.path.join(work, "main.cpp")
    with open(main_f, "w") as fh:
        fh.write(f"""#include <cstdio>
void Predict(const double* features, double* output);
int main(int argc, char** argv) {{
  double row[{F}];
  double out[1];
  FILE* f = fopen(argv[1], "rb");
  while (fread(row, sizeof(double), {F}, f) == {F}) {{
    Predict(row, out);
    printf("%.17g\\n", out[0]);
  }}
  return 0;
}}
""")
    exe = os.path.join(work, "model_cpp")
    t = time.perf_counter()
    run(["g++", "-O1", "-o", exe, cpp_f, main_f], "g++ of the generated C++")
    sec["codegen_compile_s"] = time.perf_counter() - t
    n_cpp = 10_000
    rows_f = os.path.join(work, "rows.bin")
    np.ascontiguousarray(pv.X[:n_cpp], np.float64).tofile(rows_f)
    r, _ = run([exe, rows_f], "the generated C++")
    cpp_pred = np.array([float(v) for v in r.stdout.split()])
    raw = bst.predict(pv.X[:n_cpp], raw_score=True)
    err = float(np.max(np.abs(cpp_pred - raw) / (np.abs(raw) + 1e-30)))
    print(f"{tag} convert_model: g++ {sec['codegen_compile_s']:.3f} s, "
          f"{len(cpp_pred)} rows, largest relative difference to predict "
          f"{err:.3e}")
    if cpp_pred.shape != raw.shape or not np.allclose(cpp_pred, raw,
                                                      rtol=2e-5, atol=1e-6):
        fail("convert_model: the C++ code predicts differently")

    # 5. TreeSHAP on 200 valid rows
    t = time.perf_counter()
    contrib = bst.predict(pv.X[:200], pred_contrib=True)
    sec["shap_200_rows_s"] = time.perf_counter() - t
    raw = bst.predict(pv.X[:200], raw_score=True)
    rel = float(np.max(np.abs(contrib.sum(axis=1) - raw)
                       / np.maximum(np.abs(raw), 1e-300)))
    print(f"{tag} pred_contrib of 200 rows: {sec['shap_200_rows_s']:.3f} s "
          f"(numpy on the host), shape {contrib.shape}, largest relative "
          f"gap of a row's sum to its raw score {rel:.3e}")
    if contrib.shape != (200, F + 1) or not rel <= 1e-9:
        fail("pred_contrib: contributions do not sum to the raw score")

    # 6. the C API from a pure-C host
    t = time.perf_counter()
    so = build_capi()
    if so is None:
        fail("the C API library did not build")
    host_c = os.path.join(work, "host.c")
    with open(host_c, "w") as fh:
        fh.write(r'''#include <stdio.h>
#include <stdlib.h>
extern const char* LGBMTPU_GetLastError(void);
extern int LGBMTPU_TrainFromConfig(const char*);
extern int LGBMTPU_BoosterCreateFromModelfile(const char*, void**);
extern int LGBMTPU_BoosterPredictForMat(void*, const double*, long long,
    int, int, int, double*, long long, long long*);
int main(int argc, char** argv) {
  long long nrow = atoll(argv[4]), n;
  int ncol = atoi(argv[5]);
  void* h;
  if (LGBMTPU_TrainFromConfig(argv[1])) {
    fprintf(stderr, "%s\n", LGBMTPU_GetLastError()); return 1; }
  if (LGBMTPU_BoosterCreateFromModelfile(argv[2], &h)) {
    fprintf(stderr, "%s\n", LGBMTPU_GetLastError()); return 2; }
  double* x = malloc(nrow * ncol * sizeof(double));
  double* out = malloc(nrow * sizeof(double));
  FILE* f = fopen(argv[3], "rb");
  if (fread(x, sizeof(double), nrow * ncol, f) != (size_t)(nrow * ncol))
    return 3;
  fclose(f);
  if (LGBMTPU_BoosterPredictForMat(h, x, nrow, ncol, 0, 0, out, nrow, &n)) {
    fprintf(stderr, "%s\n", LGBMTPU_GetLastError()); return 4; }
  for (long long i = 0; i < n; ++i) printf("%.17g\n", out[i]);
  return 0;
}
''')
    host = os.path.join(work, "host")
    run(["gcc", host_c, so, "-o", host,
         f"-Wl,-rpath,{os.path.dirname(so)}"], "gcc of the C host")
    c_model = os.path.join(work, "capi_model.txt")
    c_conf = conf_file("capi.conf", {
        "task": "train", "data": train_f, "num_iterations": 2,
        "output_model": c_model, "verbosity": -1})
    n_c = 1000
    np.ascontiguousarray(pv.X[:n_c], np.float64).tofile(rows_f)
    r, dt = run([host, c_conf, c_model, rows_f, str(n_c), str(F)],
                "the C host")
    sec["capi_host_s"] = time.perf_counter() - t
    c_pred = np.array([float(v) for v in r.stdout.split()])
    want = lt.Booster(model_file=c_model).predict(pv.X[:n_c])
    same = np.array_equal(c_pred, want)
    print(f"{tag} C API: a pure-C host trained 2 iterations from "
          f"{os.path.basename(c_conf)} and predicted {len(c_pred)} rows "
          f"({dt:.3f} s), equal to Booster.predict of its model: {same}")
    if not same:
        fail("C API: the C host's predictions differ from Booster.predict")

    # 7. the non-finite policies on the card: a custom objective whose
    # third call returns NaN on NF_ROWS rows (B5 root, B2 levels, B7,
    # B4), then an overflowing L2 run on the fused front
    def nan_fobj():
        calls = [0]

        def fobj(score, data):
            calls[0] += 1
            p = 1.0 / (1.0 + np.exp(-score.astype(np.float64)))
            lab = data.get_label()
            g, h = p - lab, p * (1.0 - p)
            if calls[0] == 3:
                g[:NF_ROWS] = np.nan
            return g, h
        return fobj
    hk.reset_launches()
    t = time.perf_counter()
    counts = {}
    for policy in ("fatal", "warn_skip_tree", "clip"):
        p_ = {**params, "nonfinite_policy": policy}
        try:
            b_ = lt.train(p_, ds, 5, fobj=nan_fobj(), verbose_eval=False)
        except lt.LightGBMError as e:
            counts[policy] = f"raised: {e}"
            continue
        sc = b_._gbdt.train_score
        counts[policy] = (b_.num_trees(), bool(torch.isfinite(sc).all()))
    torch.cuda.synchronize()
    launches = dict(hk.LAUNCHES)
    own = ("hist_q8", "hist_routed_fused", "leaf_sums", "take_small",
           "split_search")
    print(f"{tag} non-finite policies, a custom objective NaN on {NF_ROWS} "
          f"rows at iteration 2 of 5: {counts}; launches {launches}")
    if not str(counts["fatal"]).startswith("raised: custom objective "
                                           "produced non-finite gradients "
                                           "at iteration 2"):
        fail(f"nonfinite_policy=fatal: {counts['fatal']}")
    if counts["warn_skip_tree"] != (4, True) or counts["clip"] != (5, True):
        fail(f"nonfinite_policy warn_skip_tree / clip: {counts}")
    if min(launches[k] for k in own) <= 0 or any(
            v for k, v in launches.items() if k not in own):
        fail(f"non-finite policies: launches {launches} off the fobj path")
    for k, v in launches.items():
        launches_all[k] += v
    y_big = (1e38 + 1e37 * np.random.RandomState(3).rand(N_CLI)).astype(
        np.float32)
    p_ = {"objective": "regression", "max_bin": 63, "num_leaves": L,
          "learning_rate": 1e38, "verbosity": -1}
    hk.reset_launches()
    try:
        lt.train(p_, lt.Dataset(pf.X, label=y_big, params=p_), 3)
        fail("nonfinite_policy=fatal: the overflowing L2 run did not raise")
    except lt.LightGBMError as e:
        msg = str(e)
    launches = dict(hk.LAUNCHES)
    sec["nonfinite_s"] = time.perf_counter() - t
    print(f"{tag} overflowing L2 run (labels near 1e38, learning_rate "
          f"1e38) under fatal: {msg[:80]}...; launches {launches}")
    if not msg.startswith("non-finite scores detected at iteration 0"):
        fail(f"the overflowing run raised {msg}")
    # its first tree is a stump (every gradient is inf), so no level pass
    if min(launches[k] for k in ("grad_quant_hist0", "leaf_sums_grad",
                                 "take_small")) <= 0 or launches["hist_q8"]:
        fail(f"the overflowing run left the fused front: {launches}")
    for k, v in launches.items():
        launches_all[k] += v
    shutil.rmtree(work)
    print(f"{tag} seconds by step: {json.dumps(sec)}; card: {card}")
    return sec


def telemetry_path(ds, launches_all, card: str) -> dict:
    """(q) "telemetry" on (a)'s Dataset ``ds`` (max_bin=63, the fused front
    B1-B4), binary with (a)'s parameters: 6 iterations with telemetry,
    metrics_out, xla_trace_out, snapshot_freq=2 and faults=tree_update@5
    (killed at the top of iteration 6); resume_from_snapshot to 6 with
    telemetry on; the same 6 with telemetry off and no fault. Gates: the
    resumed model text equals the telemetry-off one (up to the parameters
    echo); events.jsonl holds a train_iter for each iteration run (1-5,
    then 5-6), snapshot_write at 2, 4 and 6, fault_injected at tree_update
    and resume at 4; metrics.json counts 7 train_iterations and device 0's
    peak_bytes_in_use covers the bins on the card; metrics.prom parses;
    the Chrome trace names the CUDA kernels of B1-B4 by their source
    names and has the boosting range of the 5 iterations traced; the
    launch counts are the fused front's contract over the 13 trees
    trained. Prints s/iteration with telemetry on (no trace) and off in 5
    interleaved pairs of 6-iteration runs (per iteration, and the run's
    wall with its set-up and export), the trace's size and write time.
    Returns its seconds."""
    import shutil
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.obs import tracing
    from lightgbm_tpu_torch.obs.metrics import parse_prometheus
    from lightgbm_tpu_torch.ops import hist_kernels as hk
    from lightgbm_tpu_torch.utils import faults
    from lightgbm_tpu_torch.utils.faults import FaultInjected
    tag = "[telemetry (q), max_bin=63]"
    root = os.path.join(OUT_DIR, "telemetry_q")
    shutil.rmtree(root, ignore_errors=True)
    mdir, tdir, sdir = (os.path.join(root, d) for d in ("metrics", "trace",
                                                        "snaps"))
    base = {"objective": "binary", "num_leaves": L, "max_bin": 63,
            "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1}
    tele = {**base, "telemetry": True, "metrics_out": mdir,
            "snapshot_freq": 2, "snapshot_dir": sdir}
    sec = {}
    obs.reset()
    hk.reset_launches()
    t0 = time.perf_counter()
    try:
        lt.train({**tele, "xla_trace_out": tdir, "faults": "tree_update@5"},
                 ds, num_boost_round=6)
        fail(f"{tag} the run was not killed at iteration 6")
    except FaultInjected:
        pass
    faults.reset()
    torch.cuda.synchronize()
    sec["killed_run"] = time.perf_counter() - t0
    trace = dict(tracing.LAST_TRACE)
    t0 = time.perf_counter()
    resumed = lt.train(tele, ds, num_boost_round=6, resume_from_snapshot=sdir)
    torch.cuda.synchronize()
    sec["resumed_run"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    off = lt.train(base, ds, num_boost_round=6)
    torch.cuda.synchronize()
    sec["off_run"] = time.perf_counter() - t0
    launches = dict(hk.LAUNCHES)

    def text(b):
        return b.model_to_string().split("\nparameters:\n")[0]
    same = text(resumed) == text(off)
    print(f"{tag} killed at 6 and resumed from 4 with telemetry: the model "
          f"text equals the telemetry-off run's: {same}")
    if not same or resumed.num_trees() != 6:
        fail(f"{tag}: the resumed model text differs from the run without "
             "telemetry")
    # launches: the killed run trained trees 1-5 and the resumed one 5-6 of
    # the same model (its text is the off run's, so are its level passes)
    passes = off._gbdt.hist_passes
    if len(passes) != 6 or resumed._gbdt.hist_passes != passes[4:]:
        fail(f"{tag}: level passes {resumed._gbdt.hist_passes} against the "
             f"off run's {passes}")
    trees = 5 + 2 + 6
    gp = off._gbdt.gp
    leaves = [t.num_leaves for t in off._gbdt.models_dev]

    def searches(lo, hi):
        return tree_searches(passes[lo:hi], leaves[lo:hi], gp.num_leaves,
                             gp.max_depth)
    expected = {k: 0 for k in hk.KERNELS}
    expected.update(grad_quant_hist0=trees, leaf_sums_grad=trees,
                    take_small=trees,
                    hist_routed_fused=sum(passes[:5]) + sum(passes[4:])
                    + sum(passes),
                    split_search=searches(0, 5) + searches(4, 6)
                    + searches(0, 6))
    print(f"{tag} launches {launches} expected {expected}")
    if launches != expected:
        fail(f"{tag}: launch counts {launches} != expected {expected}")
    for k, v in launches.items():
        launches_all[k] += v

    with open(os.path.join(mdir, "events.jsonl")) as fh:
        events = [json.loads(line) for line in fh]
    with open(os.path.join(mdir, "metrics.json")) as fh:
        metrics_ = json.load(fh)
    with open(os.path.join(mdir, "metrics.prom")) as fh:
        prom = parse_prometheus(fh.read())

    def its(kind):
        return [e.get("iteration") for e in events if e["type"] == kind]
    faulted = [e["point"] for e in events if e["type"] == "fault_injected"]
    print(f"{tag} events: {len(events)}, by type "
          f"{metrics_['events_by_type']['series']}; train_iter "
          f"{its('train_iter')}, snapshot_write {its('snapshot_write')}, "
          f"resume {its('resume')}, fault_injected {faulted}")
    if (its("train_iter") != [1, 2, 3, 4, 5, 5, 6]
            or its("snapshot_write") != [2, 4, 6] or its("resume") != [4]
            or faulted != ["tree_update"]):
        fail(f"{tag}: the event stream is not the run's")
    iters = metrics_["train_iterations"]["series"]["{}"]
    peak = metrics_["device_memory_bytes"]["series"].get(
        '{device="0",stat="peak_bytes_in_use"}', 0)
    print(f"{tag} metrics.json: train_iterations {iters}, device 0 peak "
          f"bytes in use {peak} (bins on the card {N * F}); metrics.prom: "
          f"{sum(len(v) for v in prom.values())} samples parsed")
    if iters != 7 or not peak >= N * F:
        fail(f"{tag}: train_iterations {iters} != 7 or device memory "
             f"{peak} below the bins' {N * F} bytes")

    if not trace or not os.path.exists(trace.get("path", "")):
        fail(f"{tag}: no Chrome trace was written into {tdir}")
    with open(trace["path"]) as fh:
        events_t = json.load(fh)["traceEvents"]
    names = set()
    for e in events_t:
        if e.get("cat") == "kernel":
            m_ = re.search(r"(\w+)\(", e.get("name", ""))
            names.add(m_.group(1) if m_ else e.get("name"))
    seen = {k: sorted(n for n in names if KERNEL_PARTS.get(n) == k)
            for k in ("grad_quant_hist0", "hist_routed_fused",
                      "leaf_sums_grad", "take_small")}
    # record_function's range on the host timeline (the card's copy of it,
    # gpu_user_annotation, is not counted)
    boosting = sum(e.get("name") == "boosting"
                   and e.get("cat") == "user_annotation" for e in events_t)
    print(f"{tag} trace {trace['path']}: {trace['bytes']} bytes, written "
          f"in {trace['seconds']:.3f} s, {len(events_t)} events; kernels "
          f"{seen}; boosting ranges {boosting}")
    if not all(seen.values()) or boosting != 5:
        fail(f"{tag}: the trace lacks a kernel of B1-B4 ({seen}) or the "
             f"boosting range of each traced iteration ({boosting})")

    # telemetry's cost: 5 interleaved pairs of 6-iteration runs, each
    # timed per iteration (the median of the 5 intervals between the ends
    # of consecutive iterations, read by a callback after a synchronize:
    # the iteration with its telemetry, without set-up and export) and as
    # a whole (train's wall / 6, the Booster's set-up and the export of
    # the three files included)
    times = {(on, w): [] for on in (True, False) for w in ("iter", "run")}
    for k in range(5):
        for on in ((True, False) if k % 2 == 0 else (False, True)):
            obs.reset()
            p = {**base, "telemetry": on,
                 "metrics_out": os.path.join(root, "pairs") if on else ""}
            ends = []

            def mark(env, ends=ends):
                torch.cuda.synchronize()
                ends.append(time.perf_counter())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lt.train(p, ds, num_boost_round=6, callbacks=[mark])
            torch.cuda.synchronize()
            times[on, "run"].append((time.perf_counter() - t0) / 6)
            times[on, "iter"].append(statistics.median(
                b - a for a, b in zip(ends, ends[1:])))
    cost = {f"{'on' if on else 'off'}_{w}": dict(
        median=statistics.median(v), min=min(v), max=max(v), runs=v)
        for (on, w), v in times.items()}
    print(f"{tag} s/iteration, telemetry on (no trace) and off, 5 "
          f"interleaved pairs of 6-iteration runs (iter: the median "
          f"interval between iteration ends; run: train's wall / 6 with "
          f"set-up and export): {json.dumps(cost)}; on / off medians: "
          f"iter {cost['on_iter']['median'] / cost['off_iter']['median']:.4f}"
          f", run {cost['on_run']['median'] / cost['off_run']['median']:.4f}")
    obs.reset()
    obs.configure(enabled=False, metrics_out="")
    shutil.rmtree(root, ignore_errors=True)
    print(f"{tag} seconds by step: {json.dumps(sec)}; card: {card}")
    return dict(seconds=sec, overhead=cost, trace_bytes=trace["bytes"],
                trace_write_s=trace["seconds"])


N_SERVE = 500_000       # the engine's rows (synth_higgs, seed 1)
SERVE_CHUNK = 2_000_000  # (r)'s ingest chunk: 6 chunks of (a)'s rows
SERVE_CANARY = {"canary_fraction": 0.5, "canary_min_samples": 200,
                "canary_cmp_window": 512, "canary_psi_max": 0.25,
                "canary_window_s": 600.0}

_C_SERVE_HOST = r"""
#include <stdio.h>
#include <stdlib.h>
int LGBMTPU_ServerCreate(const char*, const char*, void**);
int LGBMTPU_ServerPredict(void*, const double*, long long, int, int, int,
                          double*, long long, long long*);
int LGBMTPU_ServerStatsJSON(void*, char*, long long, long long*);
int LGBMTPU_ServerClose(void*);
const char* LGBMTPU_GetLastError(void);
int main(int argc, char** argv) {
  int n = atoi(argv[3]), f = atoi(argv[4]);
  double* x = (double*)malloc(sizeof(double) * n * f);
  FILE* fh = fopen(argv[2], "rb");
  if (fread(x, sizeof(double), (size_t)n * f, fh) != (size_t)n * f) return 2;
  fclose(fh);
  void* s = 0;
  if (LGBMTPU_ServerCreate(argv[1], "verbosity=-1", &s)) {
    fprintf(stderr, "%s\n", LGBMTPU_GetLastError());
    return 1;
  }
  double out[1];
  long long got = 0;
  for (int i = 0; i < n; ++i) {
    if (LGBMTPU_ServerPredict(s, x + (size_t)i * f, 1, f, 0, 0, out, 1,
                              &got) || got != 1) {
      fprintf(stderr, "%s\n", LGBMTPU_GetLastError());
      return 3;
    }
    printf("%.17g\n", out[0]);
  }
  char buf[1 << 16];
  if (LGBMTPU_ServerStatsJSON(s, buf, sizeof(buf), &got)) return 4;
  printf("%s\n", buf);
  return LGBMTPU_ServerClose(s) ? 5 : 0;
}
"""


_SAVED_ROWS = {}


def saved_rows(X, y):
    """(a)'s rows and labels as .npy files under OUT_DIR, written once for
    the paths that hand them to other processes ((r), (s)); main removes
    them at its end."""
    if not _SAVED_ROWS:
        os.makedirs(OUT_DIR, exist_ok=True)
        for name, a in (("rows", X), ("labels", y)):
            _SAVED_ROWS[name] = os.path.join(OUT_DIR, f"{name}.npy")
            np.save(_SAVED_ROWS[name], a)
    return _SAVED_ROWS["rows"], _SAVED_ROWS["labels"]


def serve_path(X, y, launches_all, card: str) -> dict:
    """(r) "cold start and serve" at (a)'s width (synth_higgs 10.5M x 28,
    seed 0, max_bin=63, num_leaves=255, binary). 1. construct through the
    ingest pipeline at ingest_chunk_rows=2,000,000 (6 chunks, 6
    ingest_chunk events) and as one chunk: the bins equal bit for bit, and
    equal to the plain column-at-a-time encode, each timed, the phases and
    overlap_efficiency printed;
    2. faults=device_put_oom:1: one halving, one device_fault, the same
    bins; 3. two fresh processes (scripts/torch_cold_start.py) on the same
    rows saved once as .npy, prewarm=1 and prewarm=0, the library already
    built: seconds from process start to the first tree, the library's
    load seconds, the aot_prewarm events; 4. 100 iterations on the
    pipeline's Dataset under the fused front's launch contract (B1-B4),
    the prewarm's launches counted apart, AUC on 1M rows above 0.7;
    5. the engine on 500,000 synth_higgs seed-1 rows equal to the plain
    walk (ops/predict.predict_raw) bit for bit, rows/s; 6. a PredictServer:
    closed-loop single-row clients (1, 8, 64; 2 s each: qps, p50, p99,
    p999, coalesce factor), a hot swap to the 50-iteration prefix under
    load (no error, each answer its version's bit for bit), an overload
    drill (sheds, the queue bounded, every admitted request answered);
    7. serve_tcp on an ephemeral port (100 lines), `python -m
    lightgbm_tpu_torch task=serve` over stdin (100 lines) and a pure-C host
    through the server entries (100 rows), each bit for bit; 8. a 2-replica
    FleetServer on the card (every replica bit for bit), a perturbed shadow
    candidate rolled back on PSI, a clean canary promoted by handing its
    engine over. Returns its seconds by step."""
    import shutil
    import socket
    import threading
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import ingest, metrics, obs
    from lightgbm_tpu_torch.binning import bin_data
    from lightgbm_tpu_torch.fleet.rollout import canary_name
    from lightgbm_tpu_torch.fleet.service import FleetServer
    from lightgbm_tpu_torch.native.build_capi import build_capi
    from lightgbm_tpu_torch.ops import hist_kernels as hk
    from lightgbm_tpu_torch.ops import predict as P
    from lightgbm_tpu_torch.server import (MicroBatcher, PredictServer,
                                           ServeOverload, serve_tcp)
    from lightgbm_tpu_torch.utils import faults

    tag = "[serve (r), max_bin=63]"
    dev = torch.device("cuda", 0)
    work = os.path.join(OUT_DIR, "serve_path")
    if os.path.isdir(work):
        shutil.rmtree(work)
    os.makedirs(work)
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([HERE] + [p for p in sys.path
                                                    if p]))
    params = {"objective": "binary", "num_leaves": L, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1}
    sec = {}
    torch.cuda.empty_cache()

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def events(kind):
        return [e for e in obs.EVENTS.snapshot() if e["type"] == kind]

    # 1. construct: 6 chunks, then one, then the plain encode (the
    # host-binned encode: scripts/torch_host_encode.py)
    obs.reset()
    obs.configure(enabled=True)
    ds, sec["construct_6_chunks_s"] = timed(lambda: lt.Dataset(
        X, label=y, params={**params, "ingest_chunk_rows": SERVE_CHUNK}
    ).construct())
    st6 = ingest.last_stats()
    n_chunk_ev = len(events("ingest_chunk"))
    obs.configure(enabled=False)
    if st6["chunks"] != 6 or n_chunk_ev != 6:
        fail(f"(r): {st6['chunks']} chunks, {n_chunk_ev} ingest_chunk "
             "events, not 6")
    one, sec["construct_1_chunk_s"] = timed(lambda: lt.Dataset(
        X, label=y, params={**params, "ingest_chunk_rows": 10 ** 9,
                            "prewarm": 0}).construct())
    st1 = ingest.last_stats()
    if not torch.equal(ds.bins, one.bins):
        fail("(r): the 6-chunk bins differ from the one-chunk bins")
    del one
    cols = list(ds.feature_map)
    plain, sec["column_encode_s"] = timed(
        lambda: bin_data(X, ds.mappers, cols, dev))
    if not torch.equal(plain, ds.bins):
        fail("(r): the pipeline's bins differ from the column-at-a-time "
             "encode's")
    del plain
    torch.cuda.empty_cache()
    print(f"{tag} construct {X.shape[0]} x {X.shape[1]}: 6 chunks "
          f"{sec['construct_6_chunks_s']:.3f} s (phases "
          f"{json.dumps(ds.construct_phases)}; pipeline {json.dumps(st6)}), "
          f"1 chunk {sec['construct_1_chunk_s']:.3f} s (pipeline "
          f"{json.dumps(st1)}); bins equal bit for bit; {n_chunk_ev} "
          f"ingest_chunk events; card: {card}")
    print(f"{tag} encode alone: the pipeline {st6['wall_s']:.3f} s (6 "
          f"chunks), {st1['wall_s']:.3f} s (1 chunk), the column-at-a-time "
          f"plain version {sec['column_encode_s']:.3f} s; all equal bit for "
          f"bit; card: {card}")

    # 2. the OOM drill
    obs.reset()
    obs.configure(enabled=True)
    faults.configure("device_put_oom:1")
    try:
        dd, sec["oom_drill_s"] = timed(lambda: lt.Dataset(
            X, label=y, params={**params, "ingest_chunk_rows": SERVE_CHUNK,
                                "prewarm": 0}).construct())
    finally:
        faults.reset()
    df = events("device_fault")
    obs.configure(enabled=False)
    sto = ingest.last_stats()
    if (len(df) != 1 or df[0]["action"] != "halve_chunk"
            or sto["chunk_rows"] != SERVE_CHUNK // 2
            or not torch.equal(dd.bins, ds.bins)):
        fail(f"(r): the OOM drill gave {df} and {sto}")
    del dd
    torch.cuda.empty_cache()
    print(f"{tag} device_put_oom:1: one halving to {sto['chunk_rows']} rows "
          f"({sto['chunks']} chunks), one device_fault, the same bins, "
          f"{sec['oom_drill_s']:.3f} s; card: {card}")

    # 3. cold start in two fresh processes, the library already built
    rows_f, labels_f = saved_rows(X, y)
    cold = {}
    for pw in (1, 0):
        t_spawn = time.time()
        r = subprocess.run(
            [sys.executable, os.path.join(HERE, "scripts",
                                          "torch_cold_start.py"),
             rows_f, labels_f, "--prewarm", str(pw)],
            capture_output=True, text=True, env=env, cwd=HERE, timeout=300)
        if r.returncode != 0:
            fail(f"(r) cold start prewarm={pw}: exit {r.returncode}\n"
                 f"{r.stderr[-3000:]}")
        js = json.loads(r.stdout.strip().splitlines()[-1])
        js["to_first_tree_s"] = js["t_first_tree"] - t_spawn
        cold[pw] = js
        sec[f"cold_start_prewarm{pw}_s"] = js["to_first_tree_s"]
        print(f"{tag} cold start prewarm={pw}: {js['to_first_tree_s']:.3f} s "
              f"from process start to the first tree (construct "
              f"{js['construct_s']:.3f} s, phases "
              f"{json.dumps(js['construct_phases'])}, first tree "
              f"{js['first_tree_s']:.3f} s), library load "
              f"{js['load_s']} s, aot_prewarm {json.dumps(js['aot_prewarm'])}"
              f", warm-up launches {js['warm_launches']}, adopted "
              f"{js['adopted']}; card: {card}")
    if not cold[1]["adopted"] or cold[0]["warm_launches"]:
        fail(f"(r): the prewarm process did not adopt ({cold})")

    # 4. 100 iterations on the pipeline's Dataset: the fused front
    hk.reset_launches()
    warm0 = dict(hk.WARM_LAUNCHES)
    bst, sec["train_100_s"] = timed(lambda: lt.train(params, ds, 100))
    launches = dict(hk.LAUNCHES)
    passes = bst._gbdt.hist_passes
    expected = {k: 0 for k in hk.KERNELS}
    expected.update(grad_quant_hist0=len(passes),
                    leaf_sums_grad=len(passes),
                    hist_routed_fused=sum(passes),
                    take_small=bst.num_trees(),
                    split_search=split_searches(bst))
    print(f"{tag} train 100 iterations: {sec['train_100_s']:.3f} s "
          f"({sec['train_100_s'] / 100:.4f} s/iter), prewarm adopted "
          f"{bst._gbdt.prewarm_adopted}, launches {launches} expected "
          f"{expected}; the prewarm's launches, counted apart: "
          f"{ {k: v for k, v in hk.WARM_LAUNCHES.items() if v} } "
          f"(this Dataset's: {ds._prewarm.result.get('warmed')}); card: "
          f"{card}")
    if launches != expected or not bst._gbdt.prewarm_adopted:
        fail(f"(r): launch counts {launches} != expected {expected}")
    if dict(hk.WARM_LAUNCHES) != warm0:
        fail("(r): the training moved the prewarm's launch counts")
    for k, v in launches.items():
        launches_all[k] += v
    m = min(1_000_000, X.shape[0])
    auc = float(metrics.auc(torch.as_tensor(y[:m]),
                            bst._gbdt.train_score[:m].cpu()))
    print(f"{tag} train AUC on {m} rows (train score): {auc:.4f}")
    if not auc > 0.7:
        fail(f"(r): AUC {auc} <= 0.7")

    # 5. the engine against the plain walk
    Xs, _ = synth_higgs(N_SERVE, F, seed=1)
    trees = bst._host_trees()
    want, sec["plain_walk_s"] = timed(lambda: P.predict_raw(
        trees, torch.as_tensor(Xs, device=dev).to(torch.float64),
        1).cpu().numpy())
    bst._predict_engine = None
    got, sec["engine_first_call_s"] = timed(
        lambda: bst.predict(Xs, raw_score=True))
    if not np.array_equal(got, want):
        fail("(r): the engine's raw scores differ from predict_raw's")
    reps = []
    for _ in range(3):
        reps.append(timed(lambda: bst.predict(Xs, raw_score=True))[1])
    eng_s = statistics.median(reps)
    leaf = bst.predict(Xs[:10_000], pred_leaf=True)
    if not np.array_equal(leaf, P.predict_leaf(
            trees, torch.as_tensor(Xs[:10_000], device=dev).to(
                torch.float64)).cpu().numpy()):
        fail("(r): the engine's leaf indices differ from predict_leaf's")
    eng = bst._predict_engine
    print(f"{tag} engine on {N_SERVE} rows, 100 trees ({eng.max_steps} "
          f"steps, {eng.stats['chunks']} chunks so far): raw scores equal "
          f"predict_raw bit for bit, leaf indices on 10000 rows equal; "
          f"Booster.predict {N_SERVE / eng_s:.0f} rows/s (median of 3, "
          f"{eng_s:.4f} s; the first call with its upload "
          f"{sec['engine_first_call_s']:.4f} s; the plain walk "
          f"{sec['plain_walk_s']:.4f} s, {N_SERVE / sec['plain_walk_s']:.0f} "
          f"rows/s; Booster.predict on the plain walk before the engine, on "
          f"(p)'s model of 8 trees, PERF.md: 8,597,021 rows/s); card: "
          f"{card}")
    sec["engine_rows_per_s"] = N_SERVE / eng_s

    # 6. the PredictServer
    Xq = np.ascontiguousarray(Xs[:4096], dtype=np.float64)
    want_q = bst.predict(Xq)
    srv = PredictServer({"verbosity": -1, "serve_max_batch_rows": 1024},
                        model=bst)
    errs = []

    def load_point(clients, seconds=2.0):
        lat = [[] for _ in range(clients)]
        snap0 = srv.batcher.snapshot()
        t_end = time.perf_counter() + seconds

        def client(c):
            i = c
            try:
                while time.perf_counter() < t_end:
                    q = i % len(Xq)
                    t = time.perf_counter()
                    out = srv.predict(Xq[q])
                    lat[c].append(time.perf_counter() - t)
                    if out[0] != want_q[q]:
                        raise AssertionError(f"row {q}: {out[0]} != "
                                             f"{want_q[q]}")
                    i += clients
            except Exception as e:
                errs.append(e)
        t0 = time.perf_counter()
        ths = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
        [t.start() for t in ths]
        [t.join() for t in ths]
        wall = time.perf_counter() - t0
        snap1 = srv.batcher.snapshot()
        all_lat = np.sort(np.concatenate([np.asarray(v) for v in lat]))
        flushes = snap1["flushes"] - snap0["flushes"]
        return {"clients": clients, "requests": int(all_lat.size),
                "qps": all_lat.size / wall,
                "p50_ms": float(np.quantile(all_lat, 0.5) * 1e3),
                "p99_ms": float(np.quantile(all_lat, 0.99) * 1e3),
                "p999_ms": float(np.quantile(all_lat, 0.999) * 1e3),
                "coalesce_factor": ((snap1["flushed_rows"]
                                     - snap0["flushed_rows"]) / flushes
                                    if flushes else 0.0)}

    points = []
    for clients in (1, 8, 64):
        pt = load_point(clients)
        points.append(pt)
        print(f"{tag} PredictServer, {clients} closed-loop single-row "
              f"clients for 2 s: {json.dumps(pt)}; card: {card}")
    if errs:
        fail(f"(r): the closed-loop clients saw {errs[:3]}")
    sec["load_points"] = points
    # a hot swap to the 50-iteration prefix under load
    v50 = lt.Booster(model_str=bst.model_to_string(num_iteration=50))
    want_by_v = {1: want_q, 2: v50.predict(Xq)}
    results, stop = [], threading.Event()
    res_lock = threading.Lock()

    def swapper(c):
        j = c
        try:
            while not stop.is_set():
                q = j % len(Xq)
                r_ = srv.batcher.submit_async(Xq[q])
                out = r_.result(timeout=30)
                with res_lock:
                    results.append((q, r_.version, out[0]))
                j += 8
        except Exception as e:
            errs.append(e)
    ths = [threading.Thread(target=swapper, args=(c,)) for c in range(8)]
    [t.start() for t in ths]
    while len(results) < 2000 and not errs:
        time.sleep(0.01)
    t0 = time.perf_counter()
    if srv.publish(v50) != 2:
        fail("(r): the hot swap did not publish version 2")
    sec["publish_s"] = time.perf_counter() - t0
    n_swap = len(results)
    while len(results) < n_swap + 2000 and not errs:
        time.sleep(0.01)
    stop.set()
    [t.join() for t in ths]
    bad = [(q, v) for q, v, o in results if o != want_by_v[v][q]]
    versions = sorted({v for _, v, _ in results})
    if errs or bad or versions != [1, 2]:
        fail(f"(r): hot swap: errors {errs[:3]}, {len(bad)} wrong answers, "
             f"versions {versions}")
    print(f"{tag} hot swap to the 50-iteration prefix under 8 clients: "
          f"{len(results)} answers, 0 errors, each its version's bit for "
          f"bit, versions {versions}; publish (engine upload + warm-up) "
          f"{sec['publish_s']:.3f} s; card: {card}")
    # the overload drill: a 64-request queue, 16 threads submitting
    mb = MicroBatcher(srv.registry, queue_max=64, max_batch_rows=1024)
    admitted, shed = [], [0]
    adm_lock = threading.Lock()

    def flood(c):
        for k in range(300):
            q = (c * 300 + k) % len(Xq)
            try:
                r_ = mb.submit_async(Xq[q])
                with adm_lock:
                    admitted.append((q, r_))
            except ServeOverload:
                with adm_lock:
                    shed[0] += 1
    ths = [threading.Thread(target=flood, args=(c,)) for c in range(16)]
    [t.start() for t in ths]
    [t.join() for t in ths]
    wrong = sum(r_.result(timeout=60)[0] != want_by_v[2][q]
                for q, r_ in admitted)
    snap = mb.snapshot()
    mb.close()
    print(f"{tag} overload drill, 16 threads x 300 requests into a 64-"
          f"request queue: {len(admitted)} admitted and answered ({wrong} "
          f"wrong), {shed[0]} shed, max queue depth "
          f"{snap['max_queue_depth']}, coalesce factor "
          f"{snap['coalesce_factor']}; card: {card}")
    if (wrong or shed[0] == 0 or snap["max_queue_depth"] > 64
            or len(admitted) + shed[0] != 16 * 300):
        fail("(r): the overload drill failed")

    # 7. transports: TCP, task=serve over stdin, the C host
    ready = threading.Event()
    th = threading.Thread(target=serve_tcp, args=(srv, "127.0.0.1", 0,
                                                  ready), daemon=True)
    th.start()
    if not ready.wait(30):
        fail("(r): serve_tcp did not start")
    host_, port = ready.addr
    lines = [",".join("%.17g" % v for v in Xq[i]) for i in range(100)]
    tcp_out = {}

    def tcp_client(c):
        with socket.create_connection((host_, port), timeout=30) as sck:
            f = sck.makefile("rw")
            for i in range(c, 100, 4):
                f.write(lines[i] + "\n")
                f.flush()
                tcp_out[i] = f.readline().strip()
    t0 = time.perf_counter()
    ths = [threading.Thread(target=tcp_client, args=(c,)) for c in range(4)]
    [t.start() for t in ths]
    [t.join() for t in ths]
    sec["tcp_100_lines_s"] = time.perf_counter() - t0
    with socket.create_connection((host_, port), timeout=30) as sck:
        sck.sendall(b"!quit\n")
    th.join(30)
    srv.close()
    if th.is_alive() or any(tcp_out.get(i) != f"2\t{want_by_v[2][i]:.17g}"
                            for i in range(100)):
        fail("(r): serve_tcp answers differ from the direct predict")
    model_f = os.path.join(work, "model.txt")
    bst.save_model(model_f)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                        "task=serve", f"input_model={model_f}",
                        "verbosity=-1"],
                       input="\n".join(lines) + "\n!quit\n",
                       capture_output=True, text=True, env=env, cwd=work,
                       timeout=300)
    sec["stdio_100_lines_s"] = time.perf_counter() - t0
    out = r.stdout.strip().splitlines()
    if r.returncode != 0 or out != [f"1\t{want_q[i]:.17g}"
                                    for i in range(100)]:
        fail(f"(r): task=serve over stdin: exit {r.returncode}, "
             f"{out[:3]}\n{r.stderr[-2000:]}")
    so = build_capi()
    if so is None:
        fail("(r): the C API library did not build")
    src = os.path.join(work, "serve_host.c")
    with open(src, "w") as fh:
        fh.write(_C_SERVE_HOST)
    exe = os.path.join(work, "serve_host")
    subprocess.run(["gcc", src, so, "-o", exe,
                    f"-Wl,-rpath,{os.path.dirname(so)}"], check=True,
                   capture_output=True, timeout=120)
    xb = os.path.join(work, "rows.bin")
    Xq[:100].tofile(xb)
    t0 = time.perf_counter()
    r = subprocess.run([exe, model_f, xb, "100", str(F)],
                       capture_output=True, text=True, env=env, cwd=work,
                       timeout=300)
    sec["c_host_100_rows_s"] = time.perf_counter() - t0
    out = r.stdout.strip().splitlines()
    if r.returncode != 0 or [float(v) for v in out[:100]] != \
            [float(v) for v in want_q[:100]] or '"flushes"' not in out[100]:
        fail(f"(r): the C host: exit {r.returncode}\n{r.stderr[-2000:]}")
    print(f"{tag} transports, 100 lines each: serve_tcp (4 connections) "
          f"{sec['tcp_100_lines_s']:.3f} s, task=serve over stdin "
          f"{sec['stdio_100_lines_s']:.3f} s (the process included), the "
          f"C host's server_* {sec['c_host_100_rows_s']:.3f} s (the process "
          f"included); every answer equal to Booster.predict bit for bit; "
          f"card: {card}")

    # 8. a 2-replica fleet on the one card, a shadow rollback, a promote
    text = bst.model_to_string()
    fs = FleetServer({"verbosity": -1, "fleet_replicas": 2,
                      "serve_max_batch_rows": 1024, **SERVE_CANARY},
                     model=bst)
    try:
        devs = [str(r_.registry.device) for r_ in fs.pool.replicas]
        for r_ in fs.pool.replicas:
            if not np.array_equal(r_.submit_async(Xq[:512]).result(60),
                                  want_q[:512]):
                fail(f"(r): fleet replica {r_.rid} differs")
        pert = lt.Booster(model_str=text)
        pert._host_trees()[0].leaf_value += 3.0   # a shifted candidate
        ro = fs.ensure_rollout()
        ro.start(pert, shadow=True)
        i, t_end = 0, time.monotonic() + 30
        while ro.active and time.monotonic() < t_end:
            q = i % len(Xq)
            o, v = fs.predict_versioned(Xq[q])
            if v != 1 or o[0] != want_q[q]:
                fail("(r): a shadow rollout exposed the candidate")
            i += 1
            if i % 64 == 0:
                ro.tick()
        hist = list(ro.history)
        if ro.active or not hist or hist[-1]["event"] != "rollback":
            fail(f"(r): the perturbed shadow did not roll back: {hist}")
        print(f"{tag} fleet of 2 replicas on {devs}: each bit for bit; a "
              f"perturbed shadow candidate rolled back after {i} requests "
              f"({hist[-1]}); card: {card}")
        clock = [1000.0]
        ro.clock = lambda: clock[0]
        ro.start(lt.Booster(model_str=text))
        cname = canary_name("default")
        cands = [r_.registry.current(cname).engine
                 for r_ in fs.pool.replicas]
        i = 0
        while min(*ro.comparator.counts()) < ro.min_samples:
            q = (i // 2) % len(Xq)   # both sides see query q
            if fs.predict(Xq[q])[0] != want_q[q]:
                fail("(r): a clean canary answered differently")
            i += 1
            if i > 20_000:
                fail("(r): the canary's comparator never filled")
        time.sleep(0.1)
        state1 = ro.tick()
        clock[0] += ro.window_s + 1.0
        state2 = ro.tick()
        live = [r_.registry.current("default") for r_ in fs.pool.replicas]
        if (state1, state2) != ("canary", "idle") or any(
                sm.version != 2 or sm.engine is not e
                for sm, e in zip(live, cands)):
            fail(f"(r): the clean canary did not promote by handoff "
                 f"({state1}, {state2}, {ro.history[-1:]})")
        o, v = fs.predict_versioned(Xq[7])
        if v != 2 or o[0] != want_q[7]:
            fail("(r): the promoted version answers differently")
        print(f"{tag} a clean canary promoted after {i} requests by handing "
              f"its warmed engines over (version 2 on every replica, bit "
              f"for bit); card: {card}")
    finally:
        fs.close()
    del ds, bst
    torch.cuda.empty_cache()
    return sec


# path (s) "online": (a)'s rows [0, ONLINE_BASE) train the initial model,
# the next four batches of ONLINE_BATCH rows feed one boost cycle under
# live serving; the CLI's task=online runs on the first ONLINE_CLI_BASE
# rows with a feed file of ONLINE_CLI_FEED rows, the C host on the first
# ONLINE_C_BASE with ONLINE_C_FEED rows
ONLINE_BATCH = 125_000
ONLINE_BASE = N - 4 * ONLINE_BATCH
ONLINE_CLI_BASE, ONLINE_CLI_FEED = 1_000_000, 20_000
ONLINE_C_BASE, ONLINE_C_FEED = 200_000, 1_000


def online_path(X, y, launches_all, card: str,
                device_type: str = "cuda") -> dict:
    """(s) "online" at (a)'s width (synth_higgs 10.5M x 28, seed 0,
    max_bin=63, num_leaves=255, learning_rate 0.1, min_data_in_leaf 20,
    binary). 1. a Dataset of rows [0, 10M) and 20 iterations: b1;
    2. PredictServer(model=b1) with an OnlineTrainer attached (online_wal
    in a directory of its own, online_refit_rows 500,000,
    online_boost_rounds 4, online_max_rows 10M) while 8 closed-loop
    single-row clients run: rows [10M, 10.5M) fed in four batches of
    125,000 with batch ids, the fourth triggering one cycle (trigger rows,
    mode boost, 500,000 rows, version 2, the Dataset back at 10M rows, the
    fused front's launches: B1 and B3 4, B2 one per level pass, B4 for the
    4 new trees and b1's 20 replayed); the merged model text byte for byte
    the offline continuation (a Dataset of rows [500,000, 10.5M) with
    reference= the first, train(init_model=b1) 4, merge_boosters), its bins
    the appended bins bit for bit; every client answer its version's
    predict bit for bit, nothing shed; qps and p99 during the cycle against
    a window without one; the cycle's seconds by part, the WAL's bytes and
    fsync seconds; 3. a refit cycle (online_boost_rounds 0): 125,000 rows
    of seed 1 fed and flushed publish version 3, equal to Booster.refit on
    the same rows; 4. scripts/torch_online_drill.py in two processes over
    one new WAL: the first feeds the 500,000 rows under
    faults=online_publish:1 and dies, the second recovers, trains the
    batches once and commits them, deduplicates their re-send, and ends
    with step 2's model text byte for byte (the recovery's seconds);
    5. serve_tcp: 100 !learn lines, 100 "<rid>|" captures and their
    !label lines counted in the stats' online section; `python -m
    lightgbm_tpu_torch task=online` on a 20,000-row feed file over the
    first 1M rows (a save_binary Dataset) and the C host
    (scripts/torch_online_host.c: LGBMTPU_DatasetAppend, LGBMTPU_Online*)
    on 1,000 rows over the first 200,000, each model text equal to the
    same feed through the Python API. Returns its seconds by step."""
    import shutil
    import socket
    import threading
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.native.build_capi import build_capi
    from lightgbm_tpu_torch.online import (OnlineTrainer, last_cycle_stats,
                                           merge_boosters, tail_source)
    from lightgbm_tpu_torch.ops import hist_kernels as hk
    from lightgbm_tpu_torch.server import PredictServer, serve_tcp

    tag = "[online (s), max_bin=63]"
    cuda = device_type == "cuda"
    work = os.path.join(OUT_DIR, "online_path")
    if os.path.isdir(work):
        shutil.rmtree(work)
    os.makedirs(work)
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([HERE] + [p for p in sys.path
                                                    if p]))
    n0, nb = ONLINE_BASE, ONLINE_BATCH
    params = {"objective": "binary", "num_leaves": L, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1, "device_type": device_type}
    cycle = {"online_refit_rows": 4 * nb, "online_boost_rounds": 4,
             "online_max_rows": n0}
    sec = {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t

    def first_diff(a, b):
        for i, (la, lb) in enumerate(zip(a.splitlines(), b.splitlines())):
            if la != lb:
                return f"line {i}: {la[:120]!r} != {lb[:120]!r}"
        return f"lengths {len(a)} != {len(b)}"

    # 1. the initial model
    ds, sec["construct_s"] = timed(lambda: lt.Dataset(
        X[:n0], label=y[:n0], params=params).construct())
    b1, sec["train_20_s"] = timed(lambda: lt.train(params, ds, 20))
    b1_file = os.path.join(work, "b1.txt")
    b1.save_model(b1_file)
    print(f"{tag} initial model b1: construct {n0} x {X.shape[1]} "
          f"{sec['construct_s']:.3f} s, 20 iterations "
          f"{sec['train_20_s']:.3f} s; card: {card}")

    # 2. the boost cycle under live serving
    online = {**params, **cycle, "online_wal": True,
              "online_wal_dir": os.path.join(work, "wal")}
    srv = PredictServer({"verbosity": -1, "serve_max_batch_rows": 1024,
                         "device_type": device_type}, model=b1)
    tr = OnlineTrainer(online, ds, booster=b1, server=srv)
    srv.attach_online(tr)
    if tr.version != 1:
        fail(f"(s): the trainer sees version {tr.version}, not 1")
    Xq = np.ascontiguousarray(synth_higgs(4096, F, seed=3)[0])
    want = {1: b1.predict(Xq)}
    log, errs, stop = [], [], threading.Event()
    log_lock = threading.Lock()

    def client(c):
        i = c
        try:
            while not stop.is_set():
                q = i % len(Xq)
                t0 = time.perf_counter()
                out, v = srv.predict_versioned(Xq[q])
                t1 = time.perf_counter()
                with log_lock:
                    log.append((t0, t1, q, v, out[0]))
                i += 8
        except Exception as e:
            errs.append(e)

    def window(t_a, t_b):
        """qps and latency of the requests that completed in [t_a, t_b]."""
        with log_lock:
            lat = np.sort([t1 - t0 for t0, t1, *_ in log if t_a <= t1 <= t_b])
        if lat.size == 0:
            return {"seconds": t_b - t_a, "requests": 0, "qps": 0.0}
        return {"seconds": t_b - t_a, "requests": int(lat.size),
                "qps": lat.size / (t_b - t_a),
                "p50_ms": float(np.quantile(lat, 0.5) * 1e3),
                "p99_ms": float(np.quantile(lat, 0.99) * 1e3),
                "max_ms": float(lat[-1] * 1e3)}

    ths = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    [t.start() for t in ths]
    try:
        time.sleep(0.5)
        t_a = time.perf_counter()
        time.sleep(2.0)
        idle = window(t_a, time.perf_counter())
        hk.reset_launches()
        feeds = []
        for i in range(4):
            lo = n0 + i * nb
            t0 = time.perf_counter()
            v = tr.feed(X[lo:lo + nb], y[lo:lo + nb], batch_id=f"b{i}")
            feeds.append((t0, time.perf_counter(), v))
        launches = dict(hk.LAUNCHES)
        busy = window(feeds[3][0], feeds[3][1])
        time.sleep(1.0)
    finally:
        stop.set()
        [t.join() for t in ths]
    shed = srv.stats()["scheduler"]["shed"]
    st = last_cycle_stats()
    wal_st = tr.wal.stats()
    v2_text = tr.booster.model_to_string()
    want[2] = tr.booster.predict(Xq)
    bad = sum(1 for _, _, q, v, o in log if o != want[v][q])
    versions = sorted({e[3] for e in log})
    if errs or shed or bad or versions != [1, 2]:
        fail(f"(s): clients: errors {errs[:3]}, {shed} shed, {bad} answers "
             f"not their version's, versions {versions}")
    if ([f[2] for f in feeds] != [None, None, None, 2]
            or (st["trigger"], st["mode"], st["rows"], st["version"])
            != ("rows", "boost", 4 * nb, 2) or ds.num_data != n0):
        fail(f"(s): the cycle: feeds {[f[2] for f in feeds]}, stats {st}, "
             f"{ds.num_data} rows")
    sec["cycle"] = {k: st[k] for k in ("duration_s", "append_s", "train_s",
                                       "merge_s", "publish_s", "lag_s")}
    sec["feed_s"] = [f[1] - f[0] for f in feeds]
    print(f"{tag} boost cycle under 8 clients: trigger {st['trigger']}, "
          f"mode {st['mode']}, {st['rows']} rows, version {st['version']}, "
          f"{ds.num_data} rows kept; {st['duration_s']:.3f} s (append "
          f"{st['append_s']:.3f}, train {st['train_s']:.3f}, merge "
          f"{st['merge_s']:.3f}, publish {st['publish_s']:.3f}); the four "
          f"feeds {[round(s, 4) for s in sec['feed_s']]} s; card: {card}")
    print(f"{tag} feed log: {wal_st['bytes']} bytes on disk, "
          f"{wal_st['bytes_appended']} appended, fsync "
          f"{wal_st['fsync_s']:.4f} s over {wal_st['appends']} batches and "
          f"{wal_st['commits']} commits; card: {card}")
    print(f"{tag} 8 closed-loop single-row clients: without a cycle "
          f"{json.dumps(idle)}; during the cycle {json.dumps(busy)}; "
          f"{len(log)} answers, each its version's bit for bit, versions "
          f"{versions}, 0 shed; card: {card}")
    sec["serving_idle"], sec["serving_cycle"] = idle, busy
    # the offline continuation of the same window
    win = slice(4 * nb, n0 + 4 * nb)
    off, sec["offline_construct_s"] = timed(lambda: lt.Dataset(
        X[win], label=y[win], reference=ds, params=params).construct())
    if not (torch.equal(off.bins, ds.bins) and torch.equal(off.label,
                                                           ds.label)):
        fail("(s): the appended bins differ from the window's construct")
    delta, sec["offline_train_s"] = timed(
        lambda: lt.train(online, off, 4, init_model=b1))
    off_text = merge_boosters(b1, delta).model_to_string()
    if off_text != v2_text:
        fail(f"(s): the cycle's model differs from the offline "
             f"continuation: {first_diff(v2_text, off_text)}")
    passes = delta._gbdt.hist_passes
    expected = {k: 0 for k in hk.KERNELS}
    expected.update(grad_quant_hist0=4, leaf_sums_grad=4,
                    hist_routed_fused=sum(passes),
                    take_small=4 + b1.num_trees(),
                    split_search=split_searches(delta))
    print(f"{tag} the cycle's model text equals the offline continuation "
          f"byte for byte ({len(v2_text)} bytes, {tr.booster.num_trees()} "
          f"trees), the appended bins the window's construct bit for bit; "
          f"launches {launches}, expected {expected} (level passes "
          f"{passes}); card: {card}")
    if launches != expected:
        fail(f"(s): launch counts {launches} != expected {expected}")
    for k, v in launches.items():
        launches_all[k] += v
    del off, delta
    tr.close()

    # 3. a refit cycle
    X3, y3 = synth_higgs(nb, F, seed=1)
    want3 = tr.booster.refit(X3, y3)
    tr3 = OnlineTrainer({**params, **cycle, "online_boost_rounds": 0}, ds,
                        booster=tr.booster, server=srv)
    srv.attach_online(tr3)
    hk.reset_launches()
    if tr3.feed(X3, y3) is not None:
        fail("(s): 125,000 rows triggered the refit cycle early")
    v3, sec["refit_flush_s"] = timed(tr3.flush)
    st3 = last_cycle_stats()
    t3, w3 = tr3.booster.model_to_string(), want3.model_to_string()
    if v3 != 3 or st3["mode"] != "refit" or ds.num_data != n0 or t3 != w3:
        fail(f"(s): the refit cycle: version {v3}, {st3}, "
             f"{first_diff(t3, w3)}")
    want[3] = tr3.booster.predict(Xq)
    print(f"{tag} refit cycle: {nb} rows of seed 1 flushed, version 3, "
          f"leaves equal Booster.refit on the same rows; {json.dumps(st3)}; "
          f"launches {({k: v for k, v in hk.LAUNCHES.items() if v})}; "
          f"card: {card}")

    # 4. kill and replay across processes
    rows_f, labels_f = saved_rows(X, y)
    drill = [sys.executable, os.path.join(HERE, "scripts",
                                          "torch_online_drill.py"),
             rows_f, labels_f, b1_file, os.path.join(work, "wal_drill"),
             json.dumps({k: v for k, v in {**params, **cycle}.items()
                         if k != "device_type"}),
             "--base-rows", str(n0), "--batch-rows", str(nb), "--batches",
             "4", "--device", device_type]
    r = subprocess.run(drill + ["--crash"], capture_output=True, text=True,
                       env=env, cwd=HERE, timeout=600)
    crash = json.loads((r.stdout.strip().splitlines() or ["{}"])[-1])
    if (r.returncode != 3 or crash.get("died_at") != "online_publish"
            or (crash["last_seq"], crash["committed_seq"]) != (4, 0)):
        fail(f"(s): the crashing process: exit {r.returncode}, {crash}\n"
             f"{r.stderr[-3000:]}")
    rec_f = os.path.join(work, "recovered.txt")
    r = subprocess.run(drill + ["--recover", "--out", rec_f],
                       capture_output=True, text=True, env=env, cwd=HERE,
                       timeout=600)
    if r.returncode != 0:
        fail(f"(s): the recovering process: exit {r.returncode}\n"
             f"{r.stderr[-3000:]}")
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    art = os.path.join(work, "wal_drill", "model_00000004.txt")
    rec_text = open(rec_f).read()
    if (rec_text != v2_text or open(art).read() != v2_text
            or rec["batch_seqs"] != [1, 2, 3, 4]
            or rec["batch_seqs_after_resend"] != [1, 2, 3, 4]
            or rec["committed_seq"] != 4 or rec["last_seq"] != 4
            or not rec["resend_deduped"] or rec["num_data"] != n0
            or rec["recovery"]["replayed"] != 4 or rec["cycles"] != 1):
        fail(f"(s): the recovery: {rec}; "
             f"{first_diff(v2_text, rec_text)}")
    if {k: rec["launches"].get(k, 0) for k in expected} != expected:
        fail(f"(s): the replayed cycle launched {rec['launches']}")
    sec["recover_s"] = rec["recover_s"]
    sec["recovery"] = rec["recovery"]
    print(f"{tag} kill and replay across processes: the first died at "
          f"{crash['died_at']} with seqs 1-{crash['last_seq']} logged "
          f"({crash['wal_bytes']} bytes, fsync {crash['fsync_s']:.4f} s; "
          f"{crash['seconds']:.1f} s in the process); the second recovered "
          f"in {rec['recover_s']:.3f} s ({json.dumps(rec['recovery'])}; "
          f"{rec['seconds']:.1f} s in the process), trained each batch "
          f"once, committed through seq {rec['committed_seq']}, dropped "
          f"the four re-sent batches by id, its model text and the "
          f"committed artifact equal to step 2's byte for byte, launches "
          f"{rec['launches']}; card: {card}")

    # 5. the protocols: TCP, task=online, the C host
    ready = threading.Event()
    th = threading.Thread(target=serve_tcp, args=(srv, "127.0.0.1", 0,
                                                  ready), daemon=True)
    th.start()
    if not ready.wait(30):
        fail("(s): serve_tcp did not start")
    XL, yL = synth_higgs(200, F, seed=5)
    rows_txt = [",".join("%.17g" % v for v in XL[i]) for i in range(200)]
    lines = ([f"!learn {yL[i]:.17g},{rows_txt[i]}" for i in range(100)]
             + [f"c{i}|{rows_txt[100 + i]}" for i in range(100)]
             + [f"!label c{i} {yL[100 + i]:.17g}" for i in range(100)])
    t0 = time.perf_counter()
    with socket.create_connection(ready.addr, timeout=60) as sck:
        f = sck.makefile("rw")
        replies = []
        for ln in lines + ["!stats"]:
            f.write(ln + "\n")
            f.flush()
            replies.append(f.readline().strip())
        f.write("!quit\n")
        f.flush()
    sec["tcp_300_lines_s"] = time.perf_counter() - t0
    th.join(30)
    stats = json.loads(replies[-1])
    want_cap = tr3.booster.predict(XL[100:])
    ok = (all(replies[i] == f"ok pending={i + 1}" for i in range(100))
          and all(replies[100 + i] == f"3\t{want_cap[i]:.17g}"
                  for i in range(100))
          and all(replies[200 + i] == f"ok pending={99 - i} joined={i + 1}"
                  for i in range(100)))
    on = stats.get("online", {})
    if (not ok or on.get("pending_rows") != 200
            or on["join"]["captured"] != 100 or on["join"]["joined"] != 100):
        fail(f"(s): the protocol lines: {replies[:2]} {replies[100:102]} "
             f"{replies[200:202]}; online stats {on}")
    print(f"{tag} serve_tcp: 100 !learn lines, 100 captures (each answered "
          f"by version 3 bit for bit) and their !label lines in "
          f"{sec['tcp_300_lines_s']:.3f} s; the stats' online section: "
          f"pending_rows {on['pending_rows']}, join {json.dumps(on['join'])}"
          f"; card: {card}")
    tr3.close()
    srv.close()
    del ds
    if cuda:
        torch.cuda.empty_cache()
    small = lt.Dataset(X[:ONLINE_CLI_BASE], label=y[:ONLINE_CLI_BASE],
                       params=params).construct()
    bin_f = os.path.join(work, "base.bin")
    small.save_binary(bin_f)
    del small
    XF, yF = synth_higgs(ONLINE_CLI_FEED, F, seed=6)
    feed_f = os.path.join(work, "feed.csv")
    np.savetxt(feed_f, np.column_stack([yF, XF]), delimiter=",",
               fmt="%.17g")
    cli = {**params, "online_refit_rows": ONLINE_CLI_FEED // 2,
           "online_boost_rounds": 4}
    cli_out = os.path.join(work, "cli_model.txt")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                        "task=online", f"data={bin_f}",
                        f"input_model={b1_file}", f"online_feed={feed_f}",
                        f"output_model={cli_out}"]
                       + [f"{k}={v}" for k, v in cli.items()],
                       capture_output=True, text=True, env=env, cwd=work,
                       timeout=600)
    sec["cli_s"] = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"(s): task=online: exit {r.returncode}\n{r.stderr[-3000:]}")
    api = OnlineTrainer(cli, lt.Dataset.load_binary(bin_f, params=cli),
                        booster=lt.Booster(model_file=b1_file, params=cli))
    fed = api.run(tail_source(feed_f, follow=False))
    api.close()
    cli_text = open(cli_out).read()
    api_text = api.booster.model_to_string()
    if fed != ONLINE_CLI_FEED or cli_text != api_text:
        fail(f"(s): task=online's model differs from the Python API's: "
             f"{first_diff(cli_text, api_text)}")
    print(f"{tag} python -m lightgbm_tpu_torch task=online: "
          f"{ONLINE_CLI_FEED} feed rows over a {ONLINE_CLI_BASE}-row binary "
          f"Dataset in {sec['cli_s']:.3f} s (the process included), "
          f"{api.cycles} cycle(s), the model text equal to the Python "
          f"API's byte for byte; card: {card}")
    so = build_capi()
    if so is None:
        fail("(s): the C API library did not build")
    exe = os.path.join(work, "online_host")
    subprocess.run(["gcc", os.path.join(HERE, "scripts",
                                        "torch_online_host.c"), so, "-o",
                    exe, f"-Wl,-rpath,{os.path.dirname(so)}"], check=True,
                   capture_output=True, timeout=120)
    bx, by = X[:ONLINE_C_BASE], y[:ONLINE_C_BASE]
    fx, fy = synth_higgs(ONLINE_C_FEED, F, seed=7)
    for name, a in (("bx", bx), ("by", by), ("fx", fx), ("fy", fy)):
        np.ascontiguousarray(a, dtype=np.float64).tofile(
            os.path.join(work, f"{name}.bin"))
    c_keys = {**params, "online_refit_rows": ONLINE_C_FEED // 5,
              "online_boost_rounds": 2, "online_wal": True}
    pstr = " ".join(f"{k}={v}" for k, v in c_keys.items()) + \
        f" online_wal_dir={os.path.join(work, 'cwal')}"
    t0 = time.perf_counter()
    r = subprocess.run([exe, b1_file, os.path.join(work, "bx.bin"),
                        os.path.join(work, "by.bin"), str(ONLINE_C_BASE),
                        str(F), os.path.join(work, "fx.bin"),
                        os.path.join(work, "fy.bin"), str(ONLINE_C_FEED),
                        pstr], capture_output=True, text=True, env=env,
                       cwd=work, timeout=600)
    sec["c_host_s"] = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"(s): the C host: exit {r.returncode}\n{r.stderr[-3000:]}")
    out = r.stdout.strip().splitlines()
    q = ONLINE_C_FEED // 4
    c_js = json.loads(out[-2])
    ds_c = lt.Dataset(bx, label=by, params=c_keys)
    ds_c.append(fx[:q], label=fy[:q])
    tr_c = OnlineTrainer({**c_keys, "online_wal_dir":
                          os.path.join(work, "pwal")}, ds_c,
                         booster=lt.Booster(model_file=b1_file,
                                            params=c_keys))
    for i in range(q, 2 * q, 50):
        tr_c.feed(fx[i:min(i + 50, 2 * q)], fy[i:min(i + 50, 2 * q)])
    for i in range(2 * q, ONLINE_C_FEED):
        tr_c.feed_features(f"r{i}", fx[i:i + 1])
    for i in range(2 * q, ONLINE_C_FEED):
        tr_c.feed_label(f"r{i}", float(fy[i]))
    tr_c.feed_label("ghost", 1.0)
    js = tr_c.join_stats()
    v_c = tr_c.flush()
    tr_c.close()
    arts = [fn for fn in os.listdir(os.path.join(work, "cwal"))
            if fn.startswith("model_")]
    c_text = open(os.path.join(work, "cwal", arts[-1])).read() \
        if len(arts) == 1 else ""
    if (c_text != tr_c.booster.model_to_string()
            or out[-1] != f"flush: version {v_c or 0}"
            or any(c_js[k] != js[k] for k in ("captured", "joined",
                                              "unmatched", "pending"))):
        fail(f"(s): the C host's model or counters differ from the Python "
             f"API's: {out[-3:]} {js} {arts}; "
             f"{first_diff(c_text, tr_c.booster.model_to_string())}")
    print(f"{tag} the C host (LGBMTPU_DatasetAppend, LGBMTPU_Online*): "
          f"{ONLINE_C_FEED} rows over {ONLINE_C_BASE} in {sec['c_host_s']:.3f}"
          f" s (the process included): {out[0]}; {out[-3]}; join "
          f"{json.dumps(c_js)}; the committed model equal to the Python "
          f"API's byte for byte (version {v_c}, {tr_c.cycles} cycles); "
          f"card: {card}")
    if cuda:
        torch.cuda.empty_cache()
    return sec


MESH_SHARDS = 4
MESH_PARAMS = {"num_leaves": L, "max_bin": 63, "learning_rate": 0.1,
               "min_data_in_leaf": 20, "verbosity": -1, "prewarm": 0}


def mesh_path(X, y, launches_all, card: str,
              device_type: str = "cuda") -> dict:
    """(t) "mesh": (a)'s rows (synth_higgs 10.5M x 28, max_bin=63,
    num_leaves=255) on a mesh of MESH_SHARDS virtual copies of the card
    (parallel/mesh.virtual_devices), through Dataset(num_shards=...) and
    train():

    (t1) use_quantized_grad=false with a custom objective of integer
    gradients in {-1, 0, 1} and hessian 0.25 (``lattice_fobj``: every sum
    exact in f32 at 10.5M rows), 3 iterations on 4 shards, byte for byte
    the serial card run (hist_f32 + route_level + take_small per shard);
    (t2) the fused quantized binary path, 5 iterations on 4 shards and
    serially (B1, B3, B4 4 a tree, B2 4 a level pass; s/iteration of
    each, the bytes each level sums), the 500,000-row valid AUC within
    0.002 of the serial model's, and a 4,000-row 4-shard model on L2
    labels on a 1/8 grid equal to the same run on the CPU under
    virtual_devices(4, "cpu") byte for byte; (t3) tree_learner=feature on
    the 4 devices (7-feature tiles), (t1)'s objective, 2 iterations, byte
    for byte serial; (t4) tree_learner=voting, 3 iterations: top_k=28 on
    (t1)'s objective byte for byte (t1)'s data-parallel model (the pass
    width printed), top_k=5 on the quantized binary objective (AUC and the
    bytes a level against (t2)'s), and (t4') top_k=5 at max_bin=255 (the
    unfused front: B5 root and level passes at up to 254 slots, B6, B7,
    B4), 2 iterations; (t5) num_shards=2 with feature_shards=2 byte for
    byte num_shards=2 (fused binary, 2 iterations); (t6) faults:
    hist_allreduce:1 retried, byte for byte a clean run; device_put_oom
    under a 2-shard plan, resharded to 4 shards and then dropped
    (fallback_single), the bins bit for bit; a kill at iteration 2 on 4
    shards resumed on 2, byte for byte (t1)'s model; (t7) the real device
    count, and (t1) over the real devices where there is more than one.
    The launch counts are zeroed before each run and read after it;
    each run's expected counts are per shard. Returns its seconds by
    part."""
    import shutil
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import metrics
    from lightgbm_tpu_torch.ops import grow as G
    from lightgbm_tpu_torch.ops import hist_kernels as hk
    from lightgbm_tpu_torch.ops import histogram as Hmod
    from lightgbm_tpu_torch.parallel.mesh import virtual_devices
    from lightgbm_tpu_torch.utils import faults
    from lightgbm_tpu_torch.utils.faults import FaultInjected

    tag = "[mesh (t), max_bin=63]"
    k = MESH_SHARDS
    cuda = device_type == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    work = os.path.join(OUT_DIR, "mesh_path")
    if os.path.isdir(work):
        shutil.rmtree(work)
    os.makedirs(work)
    base = {**MESH_PARAMS, "device_type": device_type}
    quant_bin = {**base, "objective": "binary"}
    lattice = {**base, "objective": "none", "use_quantized_grad": False}
    sec = {}
    t_path = time.perf_counter()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # integer gradients in {-1, 0, 1}, hessian 0.25; (u)'s ranks take the
    # same function
    lattice_fobj = pod_worker().int_fobj

    def head(bst, num_iteration=None):
        """The model text without its parameter echo."""
        return bst.model_to_string(num_iteration=num_iteration).split(
            "\nparameters:\n")[0]

    def run(what, fn, expect):
        """fn() with the launch counts zeroed before it and read after,
        held to expect (kernel -> launches) and zero elsewhere."""
        hk.reset_launches()
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        dt = time.perf_counter() - t
        got = dict(hk.LAUNCHES)
        want = {n: 0 for n in hk.KERNELS}
        want.update(split_search=split_searches(out), **expect(out))
        if cuda and got != want:
            fail(f"{what}: launch counts {got} != expected {want}")
        for n, v in got.items():
            launches_all[n] += v
        return out, dt, got

    def passes(bst):
        return sum(bst._gbdt.hist_passes)

    def same(what, a, b):
        if a != b:
            la, lb = a.splitlines(), b.splitlines()
            i = next((i for i, (p, q) in enumerate(zip(la, lb)) if p != q),
                     min(len(la), len(lb)))
            fail(f"{what}: model texts differ at line {i}: "
                 f"{(la[i] if i < len(la) else '')[:100]!r} != "
                 f"{(lb[i] if i < len(lb) else '')[:100]!r}")

    def construct(params, rows=None):
        sync()
        t = time.perf_counter()
        ds = lt.Dataset(X if rows is None else X[:rows],
                        label=y if rows is None else y[:rows],
                        params=params).construct()
        sync()
        return ds, time.perf_counter() - t

    def mesh_ids(bst):
        plan = bst._gbdt._shard_plan
        return None if plan is None else plan.num_shards

    with virtual_devices(k, dev):
        # ---- (t1) exact sums: 4 shards byte for byte serial ----
        ds1, sec["construct_serial_s"] = construct(lattice)
        ds4, sec["construct_4_shards_s"] = construct({**lattice,
                                                      "num_shards": k})
        if ds4.shard_plan is None or ds4.shard_plan.num_shards != k or \
                ds1.shard_plan is not None:
            fail(f"(t1): plans {ds1.shard_plan} / {ds4.shard_plan}")
        if not torch.equal(ds4.bins, ds1.bins):
            fail("(t1): the sharded ingest's bins differ from the serial")
        print(f"{tag} construct: serial {sec['construct_serial_s']:.3f} s, "
              f"{k} shards x {ds4.shard_plan.rows_per_shard} rows "
              f"{sec['construct_4_shards_s']:.3f} s (pad "
              f"{ds4.shard_plan.pad_rows}), bins bit for bit; card: {card}")
        serial1, t_s1, _ = run(
            "(t1) serial", lambda: lt.train(lattice, ds1, 3,
                                            fobj=lattice_fobj),
            lambda b: dict(hist_f32=3 + passes(b), route_level=passes(b),
                           take_small=3))
        G.reset_allreduce()
        shard1, t_k1, got1 = run(
            "(t1) 4 shards", lambda: lt.train({**lattice, "num_shards": k},
                                              ds4, 3, fobj=lattice_fobj),
            lambda b: dict(hist_f32=k * (3 + passes(b)),
                           route_level=k * passes(b), take_small=k * 3))
        if mesh_ids(shard1) != k:
            fail(f"(t1): the trainer has {mesh_ids(shard1)} shards")
        same("(t1) 4 shards vs serial", head(shard1), head(serial1))
        sec["t1_serial_s_per_iter"] = t_s1 / 3
        sec["t1_sharded_s_per_iter"] = t_k1 / 3
        print(f"{tag} (t1) integer gradients, h 0.25, unquantized, 3 "
              f"iterations: 4 shards byte for byte serial ({len(head(shard1))}"
              f" bytes, level passes {shard1._gbdt.hist_passes}); launches "
              f"{ {n: v for n, v in got1.items() if v} } ({k} a shard a "
              f"tree / level pass); s/iteration serial {t_s1 / 3:.4f}, "
              f"4 shards {t_k1 / 3:.4f}; shard sums {dict(G.ALLREDUCE)}")

        # ---- (t2) the fused quantized path ----
        serial2, t_s2, _ = run(
            "(t2) serial", lambda: lt.train(quant_bin, ds1, 5),
            lambda b: dict(grad_quant_hist0=5, hist_routed_fused=passes(b),
                           leaf_sums_grad=5, take_small=5))
        G.reset_allreduce()
        shard2, t_k2, got2 = run(
            "(t2) 4 shards", lambda: lt.train({**quant_bin,
                                               "num_shards": k}, ds4, 5),
            lambda b: dict(grad_quant_hist0=k * 5,
                           hist_routed_fused=k * passes(b),
                           leaf_sums_grad=k * 5, take_small=k * 5))
        red2 = dict(G.ALLREDUCE)
        levels2 = passes(shard2) + 5
        level_bytes2 = red2["hist_bytes"] / max(1, red2["hist_calls"])
        # one level's shard sum at its widest, S 127: 4 [127, 3, 28, 64]
        # f32 histograms (2.73 MB each) summed in shard order
        gen = torch.Generator(device=dev).manual_seed(5)
        hparts = [torch.randn((L // 2, 3, F, 64), generator=gen, device=dev)
                  for _ in range(k)]
        gp_k = shard2._gbdt.gp
        sum_ms = (time_ms(lambda: G._hist_allreduce(hparts, gp_k, 2))
                  if cuda else None)
        G.reset_allreduce()
        del hparts
        sec["t2_shard_sum_ms_s127"] = sum_ms
        Xv, yv = synth_higgs(N_VALID, F, seed=1)
        aucs = [float(metrics.auc(torch.as_tensor(yv), torch.as_tensor(
            b.predict(Xv).astype(np.float64)))) for b in (serial2, shard2)]
        sec["t2_serial_s_per_iter"] = t_s2 / 5
        sec["t2_sharded_s_per_iter"] = t_k2 / 5
        sec["t2_level_sum_bytes"] = level_bytes2
        print(f"{tag} (t2) fused quantized binary, 5 iterations: s/iteration "
              f"serial {t_s2 / 5:.4f}, {k} shards {t_k2 / 5:.4f}; launches "
              f"{ {n: v for n, v in got2.items() if v} } ({k} a shard a "
              f"tree / level pass, level passes {shard2._gbdt.hist_passes});"
              f" shard sums {red2} over {levels2} histograms, "
              f"{level_bytes2:.0f} bytes a sum ({level_bytes2 / k:.0f} a "
              f"shard), a sum at S 127 {sum_ms} ms (CUDA events); valid "
              f"AUC (500,000 rows of seed 1) serial {aucs[0]:.6f}, "
              f"{k} shards {aucs[1]:.6f}; card: {card}")
        if abs(aucs[0] - aucs[1]) > 0.002:
            fail(f"(t2): 4-shard valid AUC {aucs[1]} vs serial {aucs[0]}")
        MESH_REF.update(
            t1_head=head(shard1), serial_head=head(serial1), ds4=ds4,
            mappers63=pod_worker().mapper_digest(ds1.mappers),
            t2_auc4=aucs[1], t2_level_bytes=level_bytes2,
            t2_sum_ms=sum_ms, lattice=lattice, quant_bin=quant_bin,
            s_per_iter={"t1_serial": t_s1 / 3, "t1_4_shards": t_k1 / 3,
                        "t2_serial": t_s2 / 5, "t2_4_shards": t_k2 / 5})
        del Xv, yv
        # a 4,000-row 4-shard model: the card and the CPU byte for byte
        ys = (np.round(y[:4000] * 2.0 + X[:4000, 0] * 2.0) / 8.0).astype(
            np.float32)
        small = {**base, "objective": "regression", "num_leaves": 31,
                 "boost_from_average": False, "num_shards": k}
        texts = {}
        for d_ in (device_type, "cpu"):
            with virtual_devices(k, d_ if d_ == "cpu" else dev):
                p_ = {**small, "device_type": d_}
                b_ = lt.train(p_, lt.Dataset(X[:4000], label=ys, params=p_),
                              3)
                if mesh_ids(b_) != k or not b_._gbdt.path.fused:
                    fail(f"(t2) 4,000 rows on {d_}: not the fused 4-shard "
                         "path")
                texts[d_] = head(b_)
        same("(t2) 4,000 rows card vs CPU", texts[device_type], texts["cpu"])
        print(f"{tag} (t2) 4,000 rows, 4 shards, fused L2 on a 1/8 grid, 3 "
              "iterations: the card's model text equals the CPU's "
              "(virtual_devices(4, 'cpu')) byte for byte")

        # ---- (t3) feature-parallel: 7-feature tiles ----
        fp, t_fp, got3 = run(
            "(t3) feature", lambda: lt.train({**lattice,
                                              "tree_learner": "feature"},
                                             ds1, 2, fobj=lattice_fobj),
            lambda b: dict(hist_f32=k * (2 + passes(b)),
                           route_level=passes(b), take_small=2))
        tiles = [(t.lo, t.hi) for t in fp._gbdt._fp_tiles.tiles]
        if not fp._gbdt._fp or tiles != [(7 * i, 7 * i + 7)
                                         for i in range(k)]:
            fail(f"(t3): feature-parallel {fp._gbdt._fp}, tiles {tiles}")
        same("(t3) feature vs serial", head(fp), head(serial1, 2))
        print(f"{tag} (t3) tree_learner=feature, tiles {tiles}, 2 "
              f"iterations: byte for byte serial; launches "
              f"{ {n: v for n, v in got3.items() if v} } (hist_f32 a tile, "
              f"route_level once a level pass); s/iteration {t_fp / 2:.4f}")

        # ---- (t4) voting ----
        widths = []
        real_routed = Hmod.hist_routed
        real_b2, real_b5 = hk.hist_routed_fused, hk.hist_q8
        wide = {}

        def routed(*a, **kw):
            widths.append(int(a[4]))
            return real_routed(*a, **kw)

        def b2_wide(bins_T_, gq, hq, cq, lid, tab, na, s_, nb, bins=None,
                    catbits=None):
            """B2; its first pass wider than 128 slots also against its
            plain version (which launches nothing)."""
            out = real_b2(bins_T_, gq, hq, cq, lid, tab, na, s_, nb,
                          bins=bins, catbits=catbits)
            if s_ > 128 and "hist_routed_fused" not in wide:
                ref = hk.hist_routed_fused_plain(bins_T_, gq, hq, cq, lid,
                                                 tab, na, s_, nb, catbits)
                if not (torch.equal(out[0], ref[0])
                        and torch.equal(out[1], ref[1])):
                    fail(f"(t4): hist_routed_fused at {s_} slots differs "
                         "from its plain version")
                wide["hist_routed_fused"] = s_
            return out

        def b5_wide(bins_T_, gq, hq, cq, slot, s_, nb, bins=None,
                    counts=None, col0=0):
            out = real_b5(bins_T_, gq, hq, cq, slot, s_, nb, bins, counts,
                          col0)
            if s_ > 128 and "hist_q8" not in wide:
                if not torch.equal(out, hk.hist_q8_plain(
                        bins_T_, gq, hq, cq, slot, s_, nb)):
                    fail(f"(t4'): hist_q8 at {s_} slots differs from its "
                         "plain version")
                wide["hist_q8"] = s_
            return out

        Hmod.hist_routed = routed
        try:
            vote, t_v, got4 = run(
                "(t4) voting top_k=28", lambda: lt.train(
                    {**lattice, "num_shards": k, "tree_learner": "voting",
                     "top_k": 28}, ds4, 3, fobj=lattice_fobj),
                lambda b: dict(hist_f32=k * (3 + passes(b)),
                               route_level=k * passes(b), take_small=k * 3))
            w28 = max(widths)
            same("(t4) voting top_k=28 vs (t1) data-parallel", head(vote),
                 head(shard1))
            widths.clear()
            G.reset_allreduce()
            hk.hist_routed_fused = b2_wide
            vote5, t_v5, got5 = run(
                "(t4) voting top_k=5", lambda: lt.train(
                    {**quant_bin, "num_shards": k, "tree_learner": "voting",
                     "top_k": 5}, ds4, 3),
                lambda b: dict(grad_quant_hist0=k * 3,
                               hist_routed_fused=k * passes(b),
                               leaf_sums_grad=k * 3, take_small=k * 3))
            red5 = dict(G.ALLREDUCE)
            w5 = max(widths)
        finally:
            Hmod.hist_routed = real_routed
            hk.hist_routed_fused = real_b2
        auc5 = float(metrics.auc(torch.as_tensor(y[:1_000_000]),
                                 torch.as_tensor(vote5.predict(
                                     X[:1_000_000]).astype(np.float64))))
        auc2 = float(metrics.auc(torch.as_tensor(y[:1_000_000]),
                                 torch.as_tensor(shard2.predict(
                                     X[:1_000_000]).astype(np.float64))))
        level_bytes5 = red5["hist_bytes"] / max(1, red5["hist_calls"])
        sec["t4_voting5_level_sum_bytes"] = level_bytes5
        print(f"{tag} (t4) voting top_k=28, 3 iterations: byte for byte "
              f"(t1)'s data-parallel model, widest pass {w28} slots (B8 "
              f"and B6), launches {({n: v for n, v in got4.items() if v})};"
              f" top_k=5 on the quantized binary objective: train AUC (1M "
              f"rows) {auc5:.6f} against (t2)'s {auc2:.6f} (5 "
              f"iterations), widest pass {w5} slots (B2), bytes a level's "
              f"histogram sum {level_bytes5:.0f} against (t2)'s "
              f"{level_bytes2:.0f}, s/iteration {t_v5 / 3:.4f}, launches "
              f"{ {n: v for n, v in got5.items() if v} }; card: {card}")
        del vote, vote5
        ds255, sec["construct_255_s"] = construct({**quant_bin, "max_bin": 255,
                                                   "num_shards": k})
        MESH_REF["mappers255"] = pod_worker().mapper_digest(ds255.mappers)
        widths.clear()
        Hmod.hist_routed = routed
        hk.hist_q8 = b5_wide
        try:
            vote255, t_v255, got6 = run(
                "(t4') voting top_k=5 at max_bin=255", lambda: lt.train(
                    {**quant_bin, "max_bin": 255, "num_shards": k,
                     "tree_learner": "voting", "top_k": 5}, ds255, 2),
                lambda b: dict(hist_q8=k * (2 + passes(b)),
                               route_level=k * passes(b), leaf_sums=k * 2,
                               take_small=k * 2))
        finally:
            Hmod.hist_routed = real_routed
            hk.hist_q8 = real_b5
        for nm, w_ in (("hist_routed_fused", w5), ("hist_q8", max(widths))):
            if w_ > 128 and nm not in wide:
                fail(f"(t4): {nm}'s {w_}-slot pass was not checked")
        MESH_REF["t4_255_s_per_iter"] = t_v255 / 2
        print(f"{tag} (t4') voting top_k=5 at max_bin=255 (F * B = 7168, the "
              f"unfused front), 2 iterations: widest pass {max(widths)} "
              f"slots (B5 after B6); B2 and B5 equal their plain versions "
              f"at {wide} slots; launches "
              f"{ {n: v for n, v in got6.items() if v} }, s/iteration "
              f"{t_v255 / 2:.4f}")
        del ds255, vote255

        # ---- (t5) the 2-D mesh ----
        ds2, _ = construct({**quant_bin, "num_shards": 2})
        ds22, _ = construct({**quant_bin, "num_shards": 2,
                             "feature_shards": 2})
        if ds22.shard_plan.feature_shards != 2:
            fail(f"(t5): feature_shards {ds22.shard_plan.feature_shards}")
        exp2 = (lambda b: dict(grad_quant_hist0=4,
                               hist_routed_fused=2 * passes(b),
                               leaf_sums_grad=4, take_small=4))
        b2, _, _ = run("(t5) 2 shards", lambda: lt.train(
            {**quant_bin, "num_shards": 2}, ds2, 2), exp2)
        b22, _, _ = run("(t5) 2 x 2", lambda: lt.train(
            {**quant_bin, "num_shards": 2, "feature_shards": 2}, ds22, 2),
            exp2)
        same("(t5) 2 x 2 vs 2 shards", head(b22), head(b2))
        print(f"{tag} (t5) num_shards=2, feature_shards=2 (each level's sum "
              "in two feature blocks of 14), 2 iterations: byte for byte "
              "num_shards=2")
        del ds22, b2, b22

        # ---- (t6) faults ----
        faults.configure("hist_allreduce:1")
        try:
            fb, _, _ = run(
                "(t6) hist_allreduce:1", lambda: lt.train(
                    {**lattice, "num_shards": k}, ds4, 2, fobj=lattice_fobj),
                lambda b: dict(hist_f32=k * (2 + passes(b)),
                               route_level=k * passes(b), take_small=k * 2))
            hits = faults.hits("hist_allreduce")
        finally:
            faults.reset()
        same("(t6) hist_allreduce retry vs clean", head(fb), head(shard1, 2))
        if hits != 3:
            fail(f"(t6): hist_allreduce hit {hits} times, expected 3")
        plans = {}
        for policy in ("reshard", "fallback_single"):
            faults.configure("device_put_oom:4")
            try:
                ds_f, t_f = construct({**quant_bin, "num_shards": 2,
                                       "on_device_fault": policy})
            finally:
                faults.reset()
            plans[policy] = (ds_f.shard_plan.num_shards
                             if ds_f.shard_plan is not None else None)
            if not torch.equal(ds_f.bins, ds1.bins):
                fail(f"(t6) device_put_oom, {policy}: bins differ")
            del ds_f
        if plans != {"reshard": 4, "fallback_single": None}:
            fail(f"(t6): device_put_oom left plans {plans}")
        snaps = os.path.join(work, "snaps")
        try:
            lt.train({**lattice, "num_shards": k, "snapshot_freq": 1,
                      "snapshot_dir": snaps, "faults": "tree_update@2"},
                     ds4, 3, fobj=lattice_fobj)
            fail("(t6): the kill at iteration 2 did not happen")
        except FaultInjected:
            pass
        finally:
            faults.reset()
        resumed = lt.train({**lattice, "num_shards": 2, "snapshot_freq": 1,
                            "snapshot_dir": snaps}, ds2, 3,
                           fobj=lattice_fobj, resume_from_snapshot=snaps)
        if mesh_ids(resumed) != 2:
            fail(f"(t6): resumed on {mesh_ids(resumed)} shards")
        same("(t6) kill on 4 shards, resume on 2", head(resumed),
             head(serial1))
        print(f"{tag} (t6) hist_allreduce:1 retried (3 hits), byte for byte "
              f"a clean run; device_put_oom:4 under a 2-shard plan: reshard "
              f"-> {plans['reshard']} shards, fallback_single -> no plan, "
              "bins bit for bit; killed at iteration 2 on 4 shards, resumed "
              "on 2: byte for byte (t1)'s model")
        del ds2, resumed, fb

    # ---- (t7) the real devices ----
    count = torch.cuda.device_count() if cuda else 1
    if count > 1:
        dsr, _ = construct({**lattice, "num_shards": count})
        real, _, _ = run(
            "(t7) real devices", lambda: lt.train(
                {**lattice, "num_shards": count}, dsr, 3,
                fobj=lattice_fobj),
            lambda b: dict(hist_f32=count * (3 + passes(b)),
                           route_level=count * passes(b),
                           take_small=count * 3))
        same("(t7) real devices vs serial", head(real), head(serial1))
        print(f"{tag} (t7) torch.cuda.device_count() = {count}: (t1) over "
              f"{count} real devices byte for byte serial")
        del dsr, real
    else:
        print(f"{tag} (t7) torch.cuda.device_count() = {count}: one real "
              "device, the distinct-card path (each shard on its own card, "
              "the sums' copies between them) not run")
    del ds1, ds4, serial1, shard1, serial2, shard2, fp
    shutil.rmtree(work)
    if cuda:
        torch.cuda.empty_cache()
    sec["total_s"] = time.perf_counter() - t_path
    return sec


# (t)'s models, digests, Dataset and times, which (u) holds its ranks to
MESH_REF = {}
POD_RANKS = 2
POD_RANK_TIMEOUT_S = 300


def tree_searches(passes, leaves, num_leaves: int, max_depth: int) -> int:
    """The split searches of depthwise trees of these level passes and leaf
    counts: each tree's root search and one a level pass, but the pass
    that spends the leaf budget or the last level (it searches no
    more)."""
    from lightgbm_tpu_torch.ops.grow_depthwise import level_widths
    levels = len(level_widths(num_leaves, max_depth if max_depth > 0
                              else max(1, num_leaves - 1)))
    return sum(1 + p - (p > 0 and (n == num_leaves or p == levels))
               for p, n in zip(passes, leaves))


def split_searches(*boosters) -> int:
    """LAUNCHES["split_search"] of these boosters' grown trees: on the card
    a numerical-only search without a CEGB penalty (ops/split.py
    best_split) launches S1 once; the default depthwise grower searches as
    ``tree_searches`` counts, the leaf-wise one its root and the children
    of every split. The lean grower (once a feature tile) is counted where
    it runs."""
    from lightgbm_tpu_torch.ops import split as S
    n = 0
    for b in boosters:
        gb = b._gbdt
        gp, passes = gb.gp, gb.hist_passes
        if (not S.numerical_only(gp.split, 1 << 30)
                or (gb.depthwise and gb.cegb is not None)):
            continue
        if not gb.depthwise:
            n += len(passes) + sum(passes)
            continue
        if gp.lean_ft:
            raise ValueError("split_searches: the lean grower searches once "
                             "a feature tile; count it where it runs")
        trees = gb.models_dev[len(gb.models_dev) - len(passes):]
        if len(trees) != len(passes):
            fail(f"split_searches: {len(passes)} trees grown, "
                 f"{len(trees)} kept")
        n += tree_searches(passes, [t.num_leaves for t in trees],
                           gp.num_leaves, gp.max_depth)
    return n


def pod_worker():
    """scripts/torch_pod_worker.py as a module (its objectives and
    digests)."""
    scripts = os.path.join(HERE, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import torch_pod_worker
    return torch_pod_worker


def pod_path(X, y, launches_all, card: str,
             device_type: str = "cuda") -> dict:
    """(u) "pod": (a)'s rows over POD_RANKS rank processes
    (scripts/torch_pod_worker.py, a torch.distributed group: both ranks on
    the one card over gloo, or rank r on card r over NCCL when there are
    as many cards), each reading only its contiguous half of the rows from
    one .npy file (multihost.load_file_shard) and holding 2 virtual copies
    of its card, so the grid is (t)'s 4 shards. In one pair of processes:

    (u1) (t1)'s lattice objective, unquantized, 3 iterations (B8, B6, B4
    on each rank's 2 shards): the merged-sketch mappers equal serial
    find_bin_mappers over all rows ((t)'s serial Dataset), and both ranks'
    model texts are (t1)'s 4-shard and serial models byte for byte; then
    one cross-rank sum of a level's histograms at S 127 timed; (u2) the
    fused binary path, 5 iterations (B1-B4): the ranks agree and the valid
    AUC on (t2)'s 500,000 rows is within 1e-4 of (t2)'s 4-shard run (the
    cross-rank sum's order, ROADMAP C16); (u3) tree_learner=voting, top_k
    5 at max_bin=255, 2 iterations (B5, B6, B7, B4): the ranks agree; (u5)
    rank 1 at another learning_rate: the consistency fence raises on both
    ranks naming config.learning_rate, no kernel launched; (u4) (u1) with
    a snapshot an iteration, both ranks killed at iteration 2 (exit 17):
    rank 0's snapshots resumed in this process on 4 virtual shards give
    (t1)'s model byte for byte. Launches are counted a rank and added to
    the run's. Then (u6) (``pod_cegb_snapshots``). Returns its seconds by
    part."""
    import shutil
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import hist_kernels as hk
    from lightgbm_tpu_torch.parallel.mesh import virtual_devices

    tag = "[pod (u), 2 processes x 2 virtual shards]"
    w = pod_worker()
    cuda = device_type == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    work = os.path.join(OUT_DIR, "pod_path")
    if os.path.isdir(work):
        shutil.rmtree(work)
    os.makedirs(os.path.join(work, "valid"))
    sec = {}
    t_path = time.perf_counter()
    np.save(os.path.join(work, "X.npy"), X)
    np.save(os.path.join(work, "y.npy"), y)
    Xv, yv = synth_higgs(N_VALID, F, seed=1)
    np.save(os.path.join(work, "valid", "X.npy"), Xv)
    np.save(os.path.join(work, "valid", "y.npy"), yv)
    del Xv, yv
    sec["write_rows_s"] = time.perf_counter() - t_path
    lattice = {**MESH_REF["lattice"], "num_shards": 4}
    quant = {**MESH_REF["quant_bin"], "num_shards": 4}
    snaps = os.path.join(work, "snaps")
    jobs = [
        {"name": "u1", "data": work, "params": lattice, "rounds": 3,
         "fobj": "int"},
        {"name": "probe", "probe_shape": [L // 2, 3, F, B], "reps": 5},
        {"name": "u2", "data": work, "params": quant, "rounds": 5,
         "valid": os.path.join(work, "valid")},
        {"name": "u3", "data": work, "rounds": 2,
         "params": {**quant, "max_bin": 255, "tree_learner": "voting",
                    "top_k": 5}},
        {"name": "u5", "data": work, "params": lattice, "rounds": 3,
         "fobj": "int", "rank_params": {"1": {"learning_rate": 0.2}},
         "expect_error": "config.learning_rate"},
        {"name": "u4", "data": work, "rounds": 3, "fobj": "int",
         "params": {**lattice, "snapshot_freq": 1, "snapshot_dir": snaps},
         "faults": "tree_update@2"}]
    t0 = time.perf_counter()
    res = spawn_pod(work, "spec.json", jobs, device_type, 17,
                    "(u) after (u4)'s kill")
    sec["ranks_s"] = time.perf_counter() - t0
    for r, got in enumerate(res):
        if sorted(got) != sorted(j["name"] for j in jobs[:-1]):
            fail(f"(u): rank {r} reported {sorted(got)}")
    backend = res[0]["u1"]["backend"]
    if backend != ("nccl" if cuda and torch.cuda.device_count()
                   >= POD_RANKS else "gloo"):
        fail(f"(u): backend {backend} with {torch.cuda.device_count()} "
             "card(s)")

    def passes(j):
        return sum(j["passes"])

    def searches(j):
        return tree_searches(j["passes"], j["leaves"], j["num_leaves"],
                             j["max_depth"])

    expect = {
        "u1": lambda j: dict(hist_f32=2 * (3 + passes(j)),
                             route_level=2 * passes(j), take_small=2 * 3,
                             split_search=searches(j)),
        "u2": lambda j: dict(grad_quant_hist0=2 * 5,
                             hist_routed_fused=2 * passes(j),
                             leaf_sums_grad=2 * 5, take_small=2 * 5,
                             split_search=searches(j)),
        "u3": lambda j: dict(hist_q8=2 * (2 + passes(j)),
                             route_level=2 * passes(j), leaf_sums=2 * 2,
                             take_small=2 * 2, split_search=searches(j))}
    for name, want_of in expect.items():
        js = [got[name] for got in res]
        if len({j["tree"] for j in js}) != 1 or not all(
                j["ranks_agree"] for j in js):
            fail(f"({name}): the ranks' models differ")
        for r, j in enumerate(js):
            want = {n: 0 for n in hk.KERNELS}
            want.update(want_of(j))
            if cuda and j["launches"] != want:
                fail(f"({name}) rank {r}: launches {j['launches']} != "
                     f"expected {want}")
            for n, v in j["launches"].items():
                launches_all[n] += v
    u1, u2, u3 = (res[0][n] for n in ("u1", "u2", "u3"))
    if u1["mappers"] != MESH_REF["mappers63"] or \
            u3["mappers"] != MESH_REF["mappers255"]:
        fail("(u1)/(u3): the merged-sketch mappers differ from serial "
             "find_bin_mappers over all rows")
    t1_digest = w.tree_digest(MESH_REF["t1_head"])
    if u1["tree"] != t1_digest or \
            w.tree_digest(MESH_REF["serial_head"]) != t1_digest:
        fail("(u1): the ranks' model differs from (t1)'s 4-shard and "
             "serial models")
    if abs(u2["valid_auc"] - MESH_REF["t2_auc4"]) > 1e-4:
        fail(f"(u2): valid AUC {u2['valid_auc']} vs (t2)'s 4 shards "
             f"{MESH_REF['t2_auc4']}")
    for r, got in enumerate(res):
        e = got["u5"]
        if "config.learning_rate" not in e.get("error", "") or \
                any(e["launches"].values()):
            fail(f"(u5) rank {r}: {e.get('error')!r}, launches "
                 f"{e['launches']}")
    probe = [got["probe"]["probe_ms"] for got in res]
    sec["probe_ms_s127"] = statistics.median(probe[0])
    t = time.perf_counter()
    with virtual_devices(4, dev):
        resumed = lt.train({**lattice, "device_type": device_type,
                            "snapshot_dir": snaps}, MESH_REF["ds4"], 3,
                           fobj=w.int_fobj, resume_from_snapshot=snaps)
    sec["u4_resume_s"] = time.perf_counter() - t
    if resumed._gbdt._shard_plan.num_shards != 4 or w.tree_digest(
            resumed.model_to_string()) != t1_digest:
        fail("(u4): the resumed model differs from (t1)'s")
    sec["u6"] = pod_cegb_snapshots(work, lattice, launches_all, card,
                                   device_type)
    x = u2["allreduce"]
    lvl = x["x_hist_bytes"] / max(1, x["x_hist_calls"])
    ref_s = MESH_REF["s_per_iter"]
    print(f"{tag} backend {backend} ({'card' if cuda else 'CPU'} "
          f"{[got['u1']['card'] for got in res]}); s/iteration a rank: "
          f"(u1) {[round(got['u1']['s_per_iter'], 4) for got in res]} vs "
          f"(t1) 4 shards {ref_s['t1_4_shards']:.4f}, serial "
          f"{ref_s['t1_serial']:.4f}; (u2) "
          f"{[round(got['u2']['s_per_iter'], 4) for got in res]} vs (t2) "
          f"4 shards {ref_s['t2_4_shards']:.4f}, serial "
          f"{ref_s['t2_serial']:.4f}; (u3) "
          f"{[round(got['u3']['s_per_iter'], 4) for got in res]} vs "
          f"(t4') {MESH_REF['t4_255_s_per_iter']:.4f}; card: {card}")
    print(f"{tag} cross-rank sums: (u2) {x['x_hist_calls']} histogram sums"
          f" of {lvl:.0f} bytes a level a rank ({x['x_calls']} sums, "
          f"{x['x_bytes']} bytes in all), host copies {u2['xfer']}; one "
          f"cross-rank sum of [{L // 2}, 3, {F}, {B}] f32 "
          f"({res[0]['probe']['probe_bytes']} bytes) over {backend}: "
          f"{probe} ms a rank (median {sec['probe_ms_s127']:.3f}); (t2)'s "
          f"in-process 4-shard sum at S 127 {MESH_REF['t2_sum_ms']} ms")
    for name in ("u1", "u2", "u3"):
        used = [{n: v for n, v in got[name]["launches"].items() if v}
                for got in res]
        cons = [round(got[name]["construct_s"], 3) for got in res]
        print(f"{tag} ({name}) launches a rank {used}; construct s {cons}, "
              f"phases rank 0 {json.dumps(res[0][name]['phases'])}")
    print(f"{tag} (u1) mappers = serial find_bin_mappers over all {len(X)} "
          f"rows, model byte for byte (t1)'s 4-shard and serial; (u2) "
          f"valid AUC {u2['valid_auc']:.6f} vs (t2) 4 shards "
          f"{MESH_REF['t2_auc4']:.6f}; (u3) ranks agree; (u5) the fence "
          f"raised on both ranks: {res[0]['u5']['error'].splitlines()[-1]}"
          f"; (u4) killed at iteration 2, rank 0's snapshots resumed on "
          f"4 virtual shards in one process: byte for byte (t1); ranks "
          f"{sec['ranks_s']:.1f} s, path {time.perf_counter() - t_path:.1f}"
          " s")
    MESH_REF.clear()
    shutil.rmtree(work)
    if cuda:
        torch.cuda.empty_cache()
    sec["total_s"] = time.perf_counter() - t_path
    return sec


def free_port() -> int:
    """A free localhost port for a torch.distributed group."""
    import socket
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        return so.getsockname()[1]


def spawn_pod(work, spec_name, jobs, device_type, expect_rc, tag):
    """Run ``jobs`` on POD_RANKS rank processes (scripts/torch_pod_worker.py,
    2 virtual shards a rank), each under POD_RANK_TIMEOUT_S; returns each
    rank's {job name: result} after checking its exit code (17 and its
    POD_KILLED line for a job list that ends in a kill)."""
    port = free_port()
    spec = os.path.join(work, spec_name)
    with open(spec, "w") as fh:
        json.dump({"world": POD_RANKS, "port": port, "devices": 2,
                   "device_type": device_type, "out": work, "jobs": jobs},
                  fh)
    threads = str(max(1, (os.cpu_count() or 2) // POD_RANKS))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "scripts",
                                      "torch_pod_worker.py"), spec],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, RANK=str(r),
                            OMP_NUM_THREADS=threads))
        for r in range(POD_RANKS)]
    outs = []
    try:
        for q in procs:
            outs.append(q.communicate(timeout=POD_RANK_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
            q.communicate()
        fail(f"{tag}: a rank ran past {POD_RANK_TIMEOUT_S} s")
    with open(os.path.join(work, spec_name + ".log"), "w") as fh:
        fh.write("\n\n".join(outs))
    for r, (q, o) in enumerate(zip(procs, outs)):
        if q.returncode != expect_rc or (
                expect_rc == 17 and f"POD_KILLED rank={r}" not in o):
            fail(f"{tag}: rank {r} exited {q.returncode} ({expect_rc} "
                 f"expected):\n{o[-3000:]}")
    return [{j["name"]: j for j in (json.loads(ln[11:])
                                    for ln in o.splitlines()
                                    if ln.startswith("POD_RESULT "))}
            for o in outs]


def pod_cegb_snapshots(work, lattice, launches_all, card: str,
                       device_type: str = "cuda") -> dict:
    """(u6), ROADMAP C18 on the card: (u1)'s lattice model with
    cegb_penalty_feature_lazy on features 0-7 and snapshot_freq=2 on the
    two ranks, killed at iteration 3. The snapshot of iteration 2 gathers
    the lazy bitset across the ranks, the collective the non-writer rank
    once skipped (both ranks then hung to their timeout); rank 0's
    snapshot resumed in this process on 4 virtual shards is the unkilled
    4-shard model (the ranks' grid, byte for byte serial as (u1) shows)
    byte for byte. Returns its seconds."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import hist_kernels as hk
    from lightgbm_tpu_torch.parallel.mesh import virtual_devices

    tag = "(u6)"
    w = pod_worker()
    cuda = device_type == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    cegb = {**lattice, "cegb_penalty_feature_lazy": [1e-3] * 8
            + [0.0] * (F - 8), "snapshot_freq": 2}
    snaps = os.path.join(work, "snaps6")
    t0 = time.perf_counter()
    spawn_pod(work, "spec6.json", [
        {"name": "u6", "data": work, "rounds": 4, "fobj": "int",
         "params": {**cegb, "snapshot_dir": snaps},
         "faults": "tree_update@3"}], device_type, 17, tag)
    sec = {"ranks_s": time.perf_counter() - t0}
    kept = sorted(f for f in os.listdir(snaps) if f.endswith(".txt"))
    if kept != ["snapshot_iter_2.txt"]:
        fail(f"{tag}: snapshots {kept}")
    hk.reset_launches()
    t = time.perf_counter()
    with virtual_devices(4, dev):
        resumed = lt.train({**cegb, "device_type": device_type,
                            "snapshot_dir": snaps}, MESH_REF["ds4"], 4,
                           fobj=w.int_fobj, resume_from_snapshot=snaps)
        sec["resume_s"] = time.perf_counter() - t
        t = time.perf_counter()
        clean = lt.train({**cegb, "device_type": device_type,
                          "snapshot_freq": 0}, MESH_REF["ds4"], 4,
                         fobj=w.int_fobj)
        sec["unkilled_s"] = time.perf_counter() - t
    used = {k: v for k, v in hk.LAUNCHES.items() if v}
    if cuda and sorted(used) != ["hist_f32", "route_level", "take_small"]:
        fail(f"{tag}: launches {used}")
    for k, v in hk.LAUNCHES.items():
        launches_all[k] += v
    if resumed._gbdt._shard_plan.num_shards != 4 or \
            resumed.num_trees() != 4 or w.tree_digest(
                resumed.model_to_string()) != w.tree_digest(
                    clean.model_to_string()):
        fail(f"{tag}: the resumed model differs from the unkilled one")
    print(f"[pod (u6), 2 processes x 2 virtual shards] lazy CEGB on 8 "
          f"features, a snapshot every 2 iterations, both ranks killed at "
          f"iteration 3 ({sec['ranks_s']:.1f} s under a "
          f"{POD_RANK_TIMEOUT_S} s timeout each): rank 0's snapshot of "
          f"iteration 2 resumed in this process on 4 virtual shards "
          f"({sec['resume_s']:.1f} s) is the unkilled 4-shard model byte "
          f"for byte ({sec['unkilled_s']:.1f} s); launches of both "
          f"{used}; card: {card}")
    return sec


# (v3): the rows of (a) appended in the drill's online cycle
LOCKWATCH_APPEND_ROWS = 500_000


def analysis_path(X, y, launches_all, card: str,
                  device_type: str = "cuda") -> dict:
    """(v) "analysis": the port's static and runtime checks on the card's
    machine. (v1) the lint over the port's tree, clean against the empty
    baseline, and its inventory of the host syncs the level, step and
    iteration loops reach; (v2) the nonfinite-policy-smoke rule on the
    device; (v3) scripts/torch_lockwatch_drill.py in a fresh process (the
    watchdog must patch threading before any port lock exists, and stays
    out of this process's serving numbers) on (a)'s rows. Returns its
    seconds by part."""
    from lightgbm_tpu_torch import analysis as lint
    from lightgbm_tpu_torch.analysis.rules.host_sync import loop_sync_sites
    from lightgbm_tpu_torch.ops import hist_kernels as hk

    tag = "[analysis (v)]"
    sec = {}
    # (v1) the lint
    t0 = time.perf_counter()
    res = lint.analyze_paths()
    sec["lint_s"] = time.perf_counter() - t0
    if res.failed:
        fail(f"(v1): the port's lint failed:\n{lint.render_human(res)}")
    inventory = []
    for rel in ("ops/grow_depthwise.py", "ops/grow.py", "engine.py",
                "models/gbdt.py"):
        path = os.path.join(HERE, "lightgbm_tpu_torch", rel)
        with open(path) as fh:
            ctx = lint.ModuleContext("lightgbm_tpu_torch/" + rel, fh.read())
        for line, kind, where in loop_sync_sites(ctx):
            inventory.append(f"{rel}:{line} {kind} ({where.split(',')[0]})")
    print(f"{tag} (v1) lint: {res.files} files, {len(res.findings)} "
          f"findings, {len(res.suppressed)} suppressed with their reasons, "
          f"{len(res.baselined)} baselined, {sec['lint_s']:.3f} s on the "
          f"host; card: {card}")
    print(f"{tag} (v1) host syncs the hot loops reach ({len(inventory)}, "
          f"each suppressed with its reason): {json.dumps(inventory)}")
    # (v2) the non-finite smoke on the device
    hk.reset_launches()
    t0 = time.perf_counter()
    bad = lint.all_rules()["nonfinite-policy-smoke"].run_dynamic(
        device=device_type)
    sec["nonfinite_s"] = time.perf_counter() - t0
    used = {k: v for k, v in hk.LAUNCHES.items() if v}
    if bad or (device_type == "cuda" and not used):
        fail(f"(v2): {[f.render() for f in bad]}; launches {used}")
    for k, v in hk.LAUNCHES.items():
        launches_all[k] += v
    print(f"{tag} (v2) nonfinite-policy-smoke on {device_type}: fatal "
          f"raised, warn_skip_tree kept 2 trees, clip 5 with finite "
          f"predictions ({sec['nonfinite_s']:.2f} s); launches {used}; "
          f"card: {card}")
    # (v3) lockwatch under real concurrency, in a fresh process
    rows, labels = saved_rows(X, y)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "scripts",
                                      "torch_lockwatch_drill.py"),
         rows, labels, "--device", device_type, "--work", OUT_DIR,
         "--append-rows", str(LOCKWATCH_APPEND_ROWS)],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    sec["lockwatch_s"] = time.perf_counter() - t0
    out = [ln for ln in proc.stdout.splitlines()
           if ln.startswith("LOCKWATCH_RESULT ")]
    if proc.returncode != 0 or not out:
        fail(f"(v3): rc {proc.returncode}\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-3000:]}")
    r = json.loads(out[-1][len("LOCKWATCH_RESULT "):])
    front = ("grad_quant_hist0", "hist_routed_fused", "leaf_sums_grad",
             "take_small")
    if device_type == "cuda" and not all(r["launches_train"][k] > 0
                                         for k in front):
        fail(f"(v3): the drill's training launched {r['launches_train']}")
    for k, v in r["launches_train"].items():
        launches_all[k] += v
    sec["lockwatch_parts_s"] = r["seconds"]
    print(f"{tag} (v3) lockwatch drill ({r['total_s']:.1f} s in the "
          f"process, {sec['lockwatch_s']:.1f} s with its start): "
          f"{len(r['sites'])} lock sites, {len(r['edges'])} order edges, "
          f"0 inversions over {r['requests']} answers (serving and an "
          f"online cycle {r['cycle']}, then a 2-replica fleet promoting a "
          f"clean canary); parts {json.dumps(r['seconds'])}; launches of "
          f"its training {r['launches_train']}; card: {card}")
    print(f"{tag} (v3) edges: {json.dumps(r['edges'])}")
    return sec


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    """(memory bytes/s, f32 operations/s) of the card from NVIDIA's data
    sheets: H100 SXM 3.35 TB/s and 67 TFLOP/s, PCIe 2.0 TB/s and 51, NVL
    3.9 TB/s and 60."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    if "NVL" in name:
        return 3.9e12, 60e12
    return 3.35e12, 67e12


def time_ms(fn, reps=7):
    """Median of reps CUDA-event timings of one call of fn, after a warm-up
    call. Shared with scripts/torch_*.py."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def skewed_leaves(n: int, l: int, rand):
    """[n] int32 leaf ids over [0, l), leaf k drawn with probability
    proportional to 1 / (k + 1) (the few large leaves at the end of a
    depthwise tree; at l = 255 the largest holds about 16% of the rows),
    by the inverse CDF of rand(n), uniform on [0, 1) on the device. Shared
    with scripts/torch_*.py."""
    import torch
    u = rand(n).double()
    w = 1.0 / torch.arange(1, l + 1, dtype=torch.float64, device=u.device)
    cdf = torch.cumsum(w, 0) / w.sum()
    return torch.searchsorted(cdf, u, right=True).clamp_(max=l - 1).to(
        torch.int32)


def device_split(fn, reps=10, tries=3):
    """Device ms a call of fn by CUDA kernel (torch.profiler over reps calls,
    after a warm-up call): the time of the call's CUDA kernels alone,
    without the host time before and between launches that CUDA-event
    timings include. CUPTI's trace sometimes comes back without device
    events: the profile is taken again, up to tries sessions, and None
    (device time not measured) is returned when none of them saw any.
    Shared with scripts/torch_*.py."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        split = {}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0.0)
            if ev.device_type.name == "CUDA" and t > 0:
                m = re.search(r"(\w+)\(", ev.key)   # the function's name
                key = m.group(1) if m else ev.key
                split[key] = split.get(key, 0.0) + t / reps / 1e3
        if split:
            return split
    print(f"chip_smoke: the profiler saw no device time in {tries} "
          "sessions; device time not measured", file=sys.stderr)
    return None


# each kernel's CUDA functions (the slot histograms' compaction passes and
# the leaf sums' final pass count as their kernel's time), as
# gbdt_bench/hw.py groups them
KERNEL_PARTS = {
    **dict.fromkeys(("max_kernel", "quant_hist_kernel"), "grad_quant_hist0"),
    **dict.fromkeys(("hist_routed_count_kernel", "hist_routed_scan_kernel",
                     "hist_routed_scatter_kernel", "hist_routed_kernel"),
                    "hist_routed_fused"),
    **dict.fromkeys(("leaf_sums_grad_rows_kernel",
                     "leaf_sums_grad_final_kernel",
                     "leaf_sums_grad_global_kernel"), "leaf_sums_grad"),
    "take_kernel": "take_small",
    **dict.fromkeys(("hist_q8_count_kernel", "hist_q8_scan_kernel",
                     "hist_q8_scatter_kernel", "hist_q8_kernel"), "hist_q8"),
    "route_level_kernel": "route_level",
    **dict.fromkeys(("leaf_sums_rows_kernel", "leaf_sums_final_kernel",
                     "leaf_sums_global_kernel"), "leaf_sums"),
    **dict.fromkeys(("hist_f32_count_kernel", "hist_f32_scan_kernel",
                     "hist_f32_scatter_kernel", "hist_f32_kernel"),
                    "hist_f32"),
    **dict.fromkeys(("hist_routed_multi_count_kernel",
                     "hist_routed_multi_scan_kernel",
                     "hist_routed_multi_scatter_kernel",
                     "hist_routed_multi_kernel"), "hist_routed_fused_multi")}


def iteration_parts(booster, carved=None, reps=2):
    """Device ms of one boosting iteration by part (torch.profiler over
    reps iterations after a warm-up one): each kernel, the parts of
    ``carved`` (name: a function whose device time, measured alone, is
    taken out of the rest), and "other" (split search, partition, glue);
    with the iteration's wall ms (CUDA events) and the device busy share.
    None where the profiler saw no device time. The iterations add trees
    to the booster."""
    split = device_split(booster.update, reps=reps)
    if split is None:
        return None
    parts = {}
    for fn_, ms_ in split.items():
        key = KERNEL_PARTS.get(fn_, "other")
        parts[key] = parts.get(key, 0.0) + ms_
    for name_, fn_ in (carved or {}).items():
        ms_ = device_ms(fn_, reps=3)
        if ms_ is not None:
            parts[name_] = ms_
            parts["other"] = parts.get("other", 0.0) - ms_
    wall = time_ms(booster.update, reps=3)
    return {"device_ms": parts, "wall_ms": wall,
            "busy_share": sum(parts.values()) / wall}


def device_ms(fn, reps=10):
    """Sum of device_split's kernel times, or None when not measured."""
    split = device_split(fn, reps)
    return None if split is None else sum(split.values())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "lightgbm_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(lightgbm_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import metrics
    from lightgbm_tpu_torch.models.gbdt import padded_bins
    from lightgbm_tpu_torch.ops import cuda_lib
    from lightgbm_tpu_torch.ops import hist_kernels as hk
    from lightgbm_tpu_torch.ops.histogram import ACC_ROWS_MAX

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    bw, flops = peaks(name)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}"
          f" count {torch.cuda.device_count()}; peaks {bw / 1e12} TB/s, "
          f"{flops / 1e12} TFLOP/s f32")

    # ---- 2. build ----
    t0 = time.perf_counter()
    cuda_lib.load()
    print(f"build: {time.perf_counter() - t0:.3f} s "
          f"(nvcc {cuda_lib.BUILD_INFO.get('seconds', 0.0):.3f} s, "
          f"built={cuda_lib.BUILD_INFO.get('built')})")
    for line in str(cuda_lib.BUILD_INFO.get("log", "")).splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  ptxas: {line.strip()}")

    def bound(nbytes, nops):
        t_b, t_o = nbytes / bw * 1e3, nops / flops * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    def exact(name_, a, b):
        """Max abs difference of kernel and plain outputs; fails unless 0."""
        if a is None and b is None:
            return 0.0
        diff = (a.to(torch.float64) - b.to(torch.float64)).abs()
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"{name_}: kernel != plain (max abs diff {diff.max()}, "
                 f"{int((diff > 0).sum())} elements)")
        return float(diff.max()) if diff.numel() else 0.0

    def multi_variant(tag, bins_T_, bins_rm, chans, lid0, tabs, na, widths,
                      nb, catbits=None):
        """B2's multi-level replay hist_routed_fused_multi of the levels
        ``tabs`` (each its own slot width) from the leaf ids ``lid0``:
        exactly against its plain version and against the levels' D
        sequential hist_routed_fused launches, timed (CUDA events) beside
        those launches, its plain version and its bound (what the data
        needs: each row's leaf id in and out, the split bin of each level
        whose leaf splits, the F bins and channels of each row kept at some
        level, the D bands, the tables). Returns (variant, hist, lid)."""
        d_ = len(tabs)
        catbits = list(catbits or [None] * d_)
        f_, n_ = bins_T_.shape
        nch = 2 if chans[1] is None else 3
        args = (bins_T_, *chans, lid0, tabs, na, widths, nb)
        kh, kl = hk.hist_routed_fused_multi(*args, bins=bins_rm,
                                            catbits=catbits)
        ph, pl_ = hk.hist_routed_fused_multi_plain(*args, catbits=catbits)
        err = max(exact(f"{tag}.hist", kh, ph), exact(f"{tag}.lid", kl, pl_))
        del ph, pl_

        def sequential():
            lid_, hs = lid0, []
            for t, c, s_ in zip(tabs, catbits, widths):
                h_, lid_ = hk.hist_routed_fused(bins_T_, *chans, lid_, t, na,
                                                s_, nb, bins=bins_rm,
                                                catbits=c)
                hs.append(h_)
            return hs, lid_
        hs, ls = sequential()
        for dd, h_ in enumerate(hs):
            if not torch.equal(kh[dd, :widths[dd]], h_) or bool(
                    kh[dd, widths[dd]:].any()):
                fail(f"{tag}: level {dd} differs from its hist_routed_fused "
                     "launch")
        if not torch.equal(kl, ls):
            fail(f"{tag}: final leaf ids differ from the sequential launches")
        del hs, ls
        lid_, routed, kept, kept_any = lid0, [], [], None
        for t, c, s_ in zip(tabs, catbits, widths):
            l_ = t.shape[1]
            lc = lid_.long()
            ok = (lc >= 0) & (lc < l_)
            feat = t[0].long()[lc.clamp(0, l_ - 1)]
            routed.append(int((ok & (feat >= 0) & (feat < f_)).sum()))
            slot, lid_, _ = hk.route_plain(bins_T_, lid_, t, na, s_, c)
            keep = (slot >= 0) & (slot < s_)
            kept.append(int(keep.sum()))
            kept_any = keep if kept_any is None else kept_any | keep
        n_kept = int(kept_any.sum())
        tab_bytes = sum(t.numel() * 4 for t in tabs) + sum(
            c.numel() * 4 for c in catbits if c is not None)
        bms, by = bound(8 * n_ + sum(routed) + n_kept * (f_ + nch)
                        + d_ * max(widths) * nch * f_ * nb * 4 + tab_bytes
                        + f_ * 4, sum(kept) * f_ * nch + 10 * n_ * d_)
        return dict(
            variant=tag, F=f_, B=nb, D=d_, widths=list(widths), nch=nch,
            categorical_levels=sum(c is not None for c in catbits),
            routed_by_level=routed, kept_by_level=kept,
            kept_at_some_level=n_kept, max_abs_err=err,
            ms=time_ms(lambda: hk.hist_routed_fused_multi(
                *args, bins=bins_rm, catbits=catbits)),
            sequential_ms=time_ms(sequential),
            plain_ms=time_ms(lambda: hk.hist_routed_fused_multi_plain(
                *args, catbits=catbits), reps=3),
            bound_ms=bms, bound_by=by), kh, kl

    multi_variants = []

    # ---- 3. kernels against their plain versions ----
    g = torch.Generator(device=dev).manual_seed(0)
    bins_T = torch.randint(0, 63, (F, N), generator=g, device=dev,
                           dtype=torch.int64).to(torch.uint8)
    score = torch.randn(N, generator=g, device=dev) * 0.5
    label_pos = (torch.rand(N, generator=g, device=dev) < 0.5).float()
    label_reg = torch.randn(N, generator=g, device=dev)
    bag = (torch.rand(N, generator=g, device=dev) < 0.9).float()
    logloss = ("logloss", 1.0, 1.0, 1.0)
    kernels = {}

    # B1 grad_quant_hist0: logloss (3 channels) and l2 const-hess (2), each
    # split by device time into its max pass and its quantize + histogram
    # pass; then the packed cells' worst case: every row kept and in bin 0
    # of every feature with gq = hq = 127 (score 0: logloss g = 0.5 and
    # h = 0.25 with label 0, L2 g = 1 with label -1, each at its scale), so
    # that each block's cell (j, 0) holds its whole range of rows at the
    # fields' largest sums
    variants = []
    zeros_T = torch.zeros_like(bins_T)
    ones = torch.ones(N, device=dev)
    for spec, aux, ch, worst in (
            (logloss, label_pos, False, False),
            (("l2",), label_reg, True, False),
            (logloss, torch.zeros(N, device=dev), False, True),
            (("l2",), -ones, True, True)):
        args = ((zeros_T, torch.zeros(N, device=dev), aux, ones) if worst
                else (bins_T, score, aux, bag)) + (7, spec, B, ch)
        k = hk.grad_quant_hist0(*args)
        p = hk.grad_quant_hist0_plain(*args)
        tag = f"grad_quant_hist0[{spec[0]}{', worst' if worst else ''}]"
        err = max(exact(f"{tag}.{nm}", a, b)
                  for nm, a, b in zip(("gq", "hq", "cq", "scales", "hist"),
                                      k, p))
        nch = 2 if ch else 3
        if worst:
            if int(k[0].min()) != 127 or int(k[4][0, :, 0].min()) != 127 * N:
                fail(f"{tag}: not the fields' worst case")
            variants.append(dict(spec=spec[0], nch=nch, worst_case=True,
                                 max_abs_err=err))
            continue
        ms = time_ms(lambda: hk.grad_quant_hist0(*args))
        split = device_split(lambda: hk.grad_quant_hist0(*args))
        plain_ms = time_ms(lambda: hk.grad_quant_hist0_plain(*args), reps=3)
        bms, by = bound(N * (F + 12 + nch) + nch * F * B * 4,
                        N * (40 + F * nch))
        variants.append(dict(spec=spec[0], nch=nch, max_abs_err=err, ms=ms,
                             device_ms_by_kernel=split, plain_ms=plain_ms,
                             bound_ms=bms, bound_by=by))
        if spec[0] == "logloss":
            quant3 = k
        else:
            quant2 = k
    del zeros_T, ones
    main_v = variants[0]
    kernels["grad_quant_hist0"] = dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/grad_quant_hist0.cu",
        replaces="lightgbm_tpu/ops/pallas_hist.py:918",
        max_abs_err=max(v["max_abs_err"] for v in variants),
        ms=main_v["ms"], device_ms_by_kernel=main_v["device_ms_by_kernel"],
        plain_ms=main_v["plain_ms"], bound_ms=main_v["bound_ms"],
        bound_by=main_v["bound_by"], library_ms=None, variants=variants)
    print(f"grad_quant_hist0: exact; {variants}")

    # B2 hist_routed_fused, given the row-major bins as the growers give
    # it, on four levels: a first level (every row in leaf 0, S = 1), S = 32
    # and 127 (leaf ids over [0, 2S), leaves < S split, one child of each
    # kept: about a quarter of the rows), and S = 127 skewed (half the rows
    # moved into leaf 0, whose left child is kept); nch in {3, 2}. Bounds
    # count what the data needs: leaf ids in and out, the split bin of each
    # routed row, the kept rows' bins and channels, the histogram, tables
    na_bin = torch.full((F,), 256, dtype=torch.int32, device=dev)
    na_bin[:10] = 62
    rowmajor = bins_T.t().contiguous()      # the Dataset's bins [N, F]
    variants = []
    for name_, s, skew in (("S1", 1, False), ("S32", 32, False),
                           ("S127", 127, False), ("skew127", 127, True)):
        lid = torch.randint(0, min(L, 2 * s), (N,), generator=g, device=dev,
                            dtype=torch.int64)
        if s == 1:
            lid = torch.zeros_like(lid)
        if skew:
            lid = torch.where(torch.rand(N, generator=g, device=dev) < 0.5,
                              0, lid)
        lid = lid.to(torch.int32)
        k_ = torch.arange(L, device=dev)
        split = k_ < s
        small_left = (torch.rand(L, generator=g, device=dev) < 0.5) \
            | (k_ == 0)
        tab = torch.stack([
            torch.where(split, torch.randint(0, F, (L,), generator=g,
                                             device=dev), -1),
            torch.randint(0, 62, (L,), generator=g, device=dev),
            torch.randint(0, 2, (L,), generator=g, device=dev),
            s + k_,
            torch.where(split & small_left, k_, s),
            torch.where(split & ~small_left, k_, s)]).to(torch.int32) \
            .contiguous()
        routed = int((lid < s).sum())
        kept = int(hk.route_plain(bins_T, lid, tab, na_bin, s)[0].lt(s)
                   .sum())
        for nch, (gq, hq, cq) in ((3, quant3[:3]), (2, (quant2[0], None,
                                                        quant2[2]))):
            args = (bins_T, gq, hq, cq, lid, tab, na_bin, s, B)
            tag = f"hist_routed_fused[{name_},nch={nch}]"
            kh, kl = hk.hist_routed_fused(*args, bins=rowmajor)
            ph, pl_ = hk.hist_routed_fused_plain(*args)
            err = max(exact(f"{tag}.hist", kh, ph),
                      exact(f"{tag}.lid2", kl, pl_))
            del kh, kl, ph, pl_
            ms = time_ms(lambda: hk.hist_routed_fused(*args, bins=rowmajor))
            plain_ms = time_ms(lambda: hk.hist_routed_fused_plain(*args),
                               reps=3)
            bms, by = bound(8 * N + routed + kept * (F + nch)
                            + s * nch * F * B * 4 + 6 * L * 4 + F * 4,
                            kept * F * nch + N * 10)
            variants.append(dict(variant=name_, S=s, nch=nch, kept=kept,
                                 max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bms, bound_by=by))
            if name_ == "S127" and nch == 3:
                b2_device_ms = device_ms(
                    lambda: hk.hist_routed_fused(*args, bins=rowmajor))
    main_v = next(v for v in variants if v["variant"] == "S127"
                  and v["nch"] == 3)
    kernels["hist_routed_fused"] = dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/hist_routed_fused.cu",
        replaces="lightgbm_tpu/ops/pallas_hist.py:676",
        max_abs_err=max(v["max_abs_err"] for v in variants),
        ms=main_v["ms"], device_ms=b2_device_ms, plain_ms=main_v["plain_ms"],
        bound_ms=main_v["bound_ms"], bound_by=main_v["bound_by"],
        library_ms=None, variants=variants)
    print(f"hist_routed_fused: exact; {variants}")
    del rowmajor, lid, tab

    # B3 leaf_sums_grad and B7 leaf_sums on uniform and on skewed leaf ids
    # (their own generator, so the other phases' inputs stay as they were):
    # counts exactly, g and h within 1e-6 * sum|x| of the leaf's rows (both
    # sum the same f32 rows in f64, in different orders), two launches bit
    # for bit; timed by events and by the device time of their kernels
    # alone, beside an index_add_ of the rows
    gen_leaves = torch.Generator(device=dev).manual_seed(7)

    def leaf_sums_phase(nm, fn, plain, make_args, ghc, lid_uniform, ops_row,
                        replaces):
        variants = []
        skewed = skewed_leaves(N, L, lambda n: torch.rand(
            n, generator=gen_leaves, device=dev))
        for leaves, lid in (("uniform", lid_uniform), ("skewed", skewed)):
            args = make_args(lid)
            ks, ks2, ps = fn(*args), fn(*args), plain(*args)
            if not torch.equal(ks.view(torch.int32), ks2.view(torch.int32)):
                fail(f"{nm}[{leaves}]: two launches differ in their bits")
            lid_l = lid.long()
            mass = torch.zeros(3, L, dtype=torch.float64, device=dev) \
                .index_add_(1, lid_l, ghc.abs().double())
            err = (ks.double() - ps.double()).abs()
            if bool((err > 1e-6 * mass + 1e-30).any()) or not torch.equal(
                    ks[2], ps[2]):
                fail(f"{nm}[{leaves}]: kernel vs plain error "
                     f"{float(err.max())} exceeds 1e-6 of the leaf's row "
                     "mass (or the counts differ)")
            split = device_split(lambda: fn(*args))
            bms, by = bound(16 * N + 3 * L * 4, ops_row * N)
            variants.append(dict(
                leaves=leaves, largest_leaf_share=float(
                    torch.bincount(lid_l, minlength=L).max()) / N,
                max_abs_err=float(err.max()), ms=time_ms(lambda: fn(*args)),
                device_ms=None if split is None else sum(split.values()),
                device_ms_by_kernel=split,
                plain_ms=time_ms(lambda: plain(*args)), bound_ms=bms,
                bound_by=by, library_ms=time_ms(
                    lambda: torch.zeros(3, L, device=dev).index_add_(
                        1, lid_l, ghc))))
        v = variants[0]
        kernels[nm] = dict(
            route="cuda", source=f"lightgbm_tpu_torch/csrc/{nm}.cu",
            replaces=replaces,
            max_abs_err=max(x["max_abs_err"] for x in variants),
            **{k: v[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
            variants=variants)
        print(f"{nm}: counts exact, two launches bit-identical; {variants}")

    grad, hess = hk.grad_rows(logloss, score, label_pos)
    ghc = torch.stack([grad * bag, hess * bag, (bag > 0).float()])
    lid = torch.randint(0, L, (N,), generator=g, device=dev,
                        dtype=torch.int64).to(torch.int32)
    leaf_sums_phase(
        "leaf_sums_grad", hk.leaf_sums_grad, hk.leaf_sums_grad_plain,
        lambda lid_: (score, label_pos, bag, lid_, logloss, L), ghc, lid, 45,
        "lightgbm_tpu/ops/pallas_hist.py:1036")

    # B4 take_small, with out-of-range indices
    table = torch.randn(L, generator=g, device=dev)
    idx = torch.randint(-2, L + 3, (N,), generator=g, device=dev,
                        dtype=torch.int64).to(torch.int32)
    err = exact("take_small", hk.take_small(table, idx),
                hk.take_small_plain(table, idx))
    padded = torch.cat([table, torch.zeros(1, device=dev)])
    idx_in = torch.where((idx >= 0) & (idx < L), idx, L).to(torch.int32)
    bms, by = bound(8 * N + 4 * L, 0)
    kernels["take_small"] = dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/take_small.cu",
        replaces="lightgbm_tpu/ops/pallas_hist.py:1213", max_abs_err=err,
        ms=time_ms(lambda: hk.take_small(table, idx)),
        device_ms=device_ms(lambda: hk.take_small(table, idx)),
        plain_ms=time_ms(lambda: hk.take_small_plain(table, idx)),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: padded.index_select(0, idx_in)),
        library_device_ms=device_ms(lambda: padded.index_select(0,
                                                                idx_in)))
    print(f"take_small: exact; {kernels['take_small']}")
    del bins_T, idx, idx_in
    torch.cuda.empty_cache()

    # S1 split_search at the cells' shapes (yahoo_ltr.bin63's F 700 at
    # B 64, higgs.bin255's F 28 at B 256, higgs.bin63's at B 64): 255
    # leaves of random histograms, features below the padded axis, missing
    # bins on a fifth of them, the parents from feature 0: every field bit
    # for bit against best_split's planes, timed beside its bound (each
    # histogram read once, one row a leaf again) and the planes
    from lightgbm_tpu_torch.ops import split as S
    variants = []
    for f_, nb_ in ((700, 64), (28, 256), (28, 64)):
        cnt = torch.randint(0, 12, (L, f_, nb_), generator=g, device=dev,
                            dtype=torch.int64).float()
        nbins = torch.full((f_,), nb_, dtype=torch.int32, device=dev)
        nbins[1::3] = nb_ - 5
        cnt[:, 1::3, nb_ - 5:] = 0.0
        na_ = torch.full((f_,), 256, dtype=torch.int32, device=dev)
        na_[1::5] = nbins[1::5] - 1
        hist = torch.stack([
            torch.randn((L, f_, nb_), generator=g, device=dev) * cnt,
            (0.1 + 0.2 * torch.rand((L, f_, nb_), generator=g, device=dev))
            * cnt, cnt], dim=1).contiguous()
        pg_, ph_, pc_ = (hist[:, c, 0].sum(-1) for c in range(3))
        fm_ = torch.ones(f_, dtype=torch.bool, device=dev)
        allow_ = torch.ones(L, dtype=torch.bool, device=dev)
        sp = S.SplitParams(min_data_in_leaf=1, min_sum_hessian_in_leaf=5.0)
        args = (hist, nbins, na_, pg_, ph_, pc_, fm_, allow_, sp)
        got = hk.split_search(*args)
        want = S.best_split_planes(hist, nbins, na_, pg_, ph_, pc_, fm_, sp,
                                   allow_)
        for nm_, a, b in zip(S.SplitResult._fields, got, want):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                fail(f"split_search [{L}, 3, {f_}, {nb_}]: {nm_} differs "
                     "from best_split's planes")
        split = device_split(lambda: hk.split_search(*args))
        bms, by = bound(L * 3 * f_ * nb_ * 4 + L * 3 * nb_ * 4,
                        20 * 2 * L * f_ * nb_)
        variants.append(dict(
            shape=[L, 3, f_, nb_], max_abs_err=0.0,
            ms=time_ms(lambda: hk.split_search(*args)),
            device_ms=None if split is None else sum(split.values()),
            device_ms_by_kernel=split,
            plain_ms=time_ms(lambda: S.best_split_planes(
                hist, nbins, na_, pg_, ph_, pc_, fm_, sp, allow_), reps=3),
            bound_ms=bms, bound_by=by))
        del cnt, hist, got, want
    v = variants[0]
    kernels["split_search"] = dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/split_search.cu",
        replaces="none (lightgbm_tpu/ops/split.py:218 best_split is plain "
                 "JAX)", max_abs_err=0.0,
        **{k: v[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                             "bound_by")},
        variants=variants)
    print(f"split_search: every field of the records bit for bit the "
          f"planes'; {variants}")
    torch.cuda.empty_cache()

    # B5 / B6 at B = 256: route_level gives hist_q8 its slot vector, as on
    # the main path. Route tables: leaves 0 .. S-1 split (NA bins on ten
    # features, both missing directions), the others do not; leaf ids in
    # [0, 2S), so about half the rows sit in dropped slots or leaves that
    # do not split.
    bins_w = torch.randint(0, BW, (F, N), generator=g, device=dev,
                           dtype=torch.int64).to(torch.uint8)
    na_w = torch.full((F,), 256, dtype=torch.int32, device=dev)
    na_w[:5] = 0
    na_w[5:10] = BW - 1
    rvariants, slots, route_counts = [], {}, {}
    for s in (32, 127):
        lid = torch.randint(0, min(L, 2 * s), (N,), generator=g, device=dev,
                            dtype=torch.int64).to(torch.int32)
        k_ = torch.arange(L, device=dev)
        split = k_ < s
        small_left = torch.rand(L, generator=g, device=dev) < 0.5
        tab = torch.stack([
            torch.where(split, torch.randint(0, F, (L,), generator=g,
                                             device=dev), -1),
            torch.randint(0, BW - 1, (L,), generator=g, device=dev),
            torch.randint(0, 2, (L,), generator=g, device=dev),
            s + k_,
            torch.where(split & small_left, k_, s),
            torch.where(split & ~small_left, k_, s)]).to(torch.int32) \
            .contiguous()
        args = (bins_w, lid, tab, na_w, s)
        ks, kl, kc = hk.route_level(*args)
        ps_, pl_, pc_ = hk.route_plain(*args)
        err = max(exact(f"route_level[S={s}].slot", ks, ps_),
                  exact(f"route_level[S={s}].lid2", kl, pl_),
                  exact(f"route_level[S={s}].counts", kc, pc_))
        kept = ks[(ks >= 0) & (ks < s)].long()
        exact(f"route_level[S={s}].counts vs bincount", kc,
              torch.bincount(kept, minlength=s).to(torch.int32))
        routed = int((lid < s).sum())
        ms = time_ms(lambda: hk.route_level(*args))
        plain_ms = time_ms(lambda: hk.route_plain(*args), reps=3)
        # lid in, slot and lid2 out, one bin byte a routed row, the counts,
        # tables (PERF.md states beside it the split-bin gather's practical
        # floor, a 32-byte sector of bins_T a routed row)
        bms, by = bound(12 * N + routed + 4 * s + 6 * L * 4 + F * 4, 8 * N)
        rvariants.append(dict(
            S=s, routed=routed, kept=int(kept.numel()), max_abs_err=err,
            ms=ms, device_ms=device_ms(lambda: hk.route_level(*args)),
            plain_ms=plain_ms, bound_ms=bms, bound_by=by))
        slots[s], route_counts[s] = ks, kc
        del lid, ps_, pl_, pc_, kl, kept
    main_v = rvariants[-1]
    kernels["route_level"] = dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/route_level.cu",
        replaces="lightgbm_tpu/ops/pallas_hist.py:1138",
        max_abs_err=max(v["max_abs_err"] for v in rvariants),
        ms=main_v["ms"], device_ms=main_v["device_ms"],
        plain_ms=main_v["plain_ms"], bound_ms=main_v["bound_ms"],
        bound_by=main_v["bound_by"], library_ms=None, variants=rvariants)
    print(f"route_level: exact; {rvariants}")

    # B2 and B6 with categorical membership at the airline shape of path
    # (k): F = 8, B = 256 (F * B = 2048, the fused pass's cap; the first
    # time B2 runs at B = 256), six categorical features whose bins are
    # skewed (bin k drawn with probability proportional to 1 / (k + 1),
    # bin 0 the missing / other bin) and two numerical ones; route tables
    # whose splitting leaves mix numerical and categorical splits (the
    # is_cat row and each leaf's [8]-word bitset of random member bins).
    # B2 at S = 1, 32 and 127 (3 channels), B6 at S = 32 and 127, exactly
    # against hist_routed_fused_plain and route_plain given the same bitset;
    # their own generator, so the other phases' inputs stay as they were
    gen_cat = torch.Generator(device=dev).manual_seed(11)
    fc = len(AIRLINE_CATS) + 2
    is_cat_feat = torch.zeros(fc, dtype=torch.bool, device=dev)
    is_cat_feat[AIRLINE_CATS] = True
    bins_c = torch.stack([
        skewed_leaves(N, BW - 1, lambda n: torch.rand(
            n, generator=gen_cat, device=dev)).to(torch.uint8)
        if j in AIRLINE_CATS else
        torch.randint(0, BW, (N,), generator=gen_cat, device=dev,
                      dtype=torch.int64).to(torch.uint8)
        for j in range(fc)]).contiguous()
    rowmajor_c = bins_c.t().contiguous()
    na_c = torch.full((fc,), 256, dtype=torch.int32, device=dev)
    na_c[AIRLINE_CATS] = 0
    chans_c = (torch.randint(-127, 128, (N,), generator=gen_cat, device=dev,
                             dtype=torch.int64).to(torch.int8),
               torch.randint(0, 128, (N,), generator=gen_cat, device=dev,
                             dtype=torch.int64).to(torch.int8),
               (torch.rand(N, generator=gen_cat, device=dev) < 0.9).to(
                   torch.int8))
    cat_b2, cat_b6, cat_levels = [], [], []
    for s in (1, 32, 127):
        lid = torch.randint(0, min(L, 2 * s), (N,), generator=gen_cat,
                            device=dev, dtype=torch.int64).to(torch.int32)
        if s == 1:
            lid = torch.zeros_like(lid)
        k_ = torch.arange(L, device=dev)
        split = k_ < s
        small_left = (torch.rand(L, generator=gen_cat, device=dev) < 0.5) \
            | (k_ == 0)
        feat = torch.where(split, torch.randint(0, fc, (L,), generator=gen_cat,
                                                device=dev), -1)
        is_cat = (split & is_cat_feat[feat.clamp(min=0)]
                  & (torch.rand(L, generator=gen_cat, device=dev) < 0.8))
        if s == 1:
            # a first level: the root splits on Origin's categories
            feat[0], is_cat[0] = AIRLINE_CATS[4], True
        tab = torch.stack([
            feat, torch.randint(0, BW - 1, (L,), generator=gen_cat,
                                device=dev),
            torch.randint(0, 2, (L,), generator=gen_cat, device=dev), s + k_,
            torch.where(split & small_left, k_, s),
            torch.where(split & ~small_left, k_, s), is_cat]).to(
                torch.int32).contiguous()
        member = torch.rand((L, BW), generator=gen_cat, device=dev) \
            < torch.rand((L, 1), generator=gen_cat, device=dev)
        member[:, 0] = False
        bits = hk.member_bitset(member)
        words = bits.shape[1]
        cat_levels.append((tab, bits, s))
        routed = int((lid < s).sum())
        kept = int(hk.route_plain(bins_c, lid, tab, na_c, s, bits)[0].lt(s)
                   .sum())
        args = (bins_c, *chans_c, lid, tab, na_c, s, BW)
        tag = f"hist_routed_fused[categorical S{s}, F={fc}, B={BW}]"
        kh, kl = hk.hist_routed_fused(*args, bins=rowmajor_c, catbits=bits)
        ph, pl_ = hk.hist_routed_fused_plain(*args, catbits=bits)
        err = max(exact(f"{tag}.hist", kh, ph), exact(f"{tag}.lid2", kl, pl_))
        del kh, kl, ph, pl_
        bms, by = bound(8 * N + routed + kept * (fc + 3)
                        + s * 3 * fc * BW * 4 + (7 + words) * L * 4 + fc * 4,
                        kept * fc * 3 + N * 10)
        cat_b2.append(dict(
            variant=f"categorical_S{s}", categorical=True, F=fc, B=BW, S=s,
            nch=3, kept=kept, categorical_leaves=int(is_cat.sum()),
            max_abs_err=err,
            ms=time_ms(lambda: hk.hist_routed_fused(*args, bins=rowmajor_c,
                                                    catbits=bits)),
            device_ms=device_ms(lambda: hk.hist_routed_fused(
                *args, bins=rowmajor_c, catbits=bits)),
            plain_ms=time_ms(lambda: hk.hist_routed_fused_plain(
                *args, catbits=bits), reps=3),
            # the same level read numerically: no is_cat row, no bitset
            numerical_tables_ms=time_ms(lambda: hk.hist_routed_fused(
                *args[:5], tab[:6].contiguous(), *args[6:], bins=rowmajor_c)),
            bound_ms=bms, bound_by=by))
        if s == 1:
            continue
        rargs = (bins_c, lid, tab, na_c, s)
        tag = f"route_level[categorical S{s}, F={fc}, B={BW}]"
        ks, kl, kc = hk.route_level(*rargs, catbits=bits)
        ps_, pl_, pc_ = hk.route_plain(*rargs, catbits=bits)
        err = max(exact(f"{tag}.slot", ks, ps_), exact(f"{tag}.lid2", kl, pl_),
                  exact(f"{tag}.counts", kc, pc_))
        del ks, kl, kc, ps_, pl_, pc_
        bms, by = bound(12 * N + routed + 4 * s + (7 + words) * L * 4
                        + fc * 4, 8 * N)
        cat_b6.append(dict(
            variant=f"categorical_S{s}", categorical=True, F=fc, B=BW, S=s,
            routed=routed, categorical_leaves=int(is_cat.sum()),
            max_abs_err=err,
            ms=time_ms(lambda: hk.route_level(*rargs, catbits=bits)),
            device_ms=device_ms(lambda: hk.route_level(*rargs, catbits=bits)),
            plain_ms=time_ms(lambda: hk.route_plain(*rargs, catbits=bits),
                             reps=3),
            numerical_tables_ms=time_ms(lambda: hk.route_level(
                bins_c, lid, tab[:6].contiguous(), na_c, s)),
            bound_ms=bms, bound_by=by))
    for nm, extra in (("hist_routed_fused", cat_b2), ("route_level", cat_b6)):
        kernels[nm]["variants"] += extra
        kernels[nm]["max_abs_err"] = max(v["max_abs_err"]
                                         for v in kernels[nm]["variants"])
    print(f"hist_routed_fused with categorical membership: exact; {cat_b2}")
    print(f"route_level with categorical membership: exact; {cat_b6}")
    # B2's multi-level replay at the same shape: the three levels above
    # (S = 1, 32 and 127, each its own width; numerical and categorical
    # leaves, each level its bitset) in one call from the first level's
    # leaf ids (every row in leaf 0)
    v, _, _ = multi_variant(
        f"categorical_replay, F={fc}, B={BW}", bins_c, rowmajor_c, chans_c,
        torch.zeros(N, dtype=torch.int32, device=dev),
        [t for t, _, _ in cat_levels], na_c, [s_ for _, _, s_ in cat_levels],
        BW, [b_ for _, b_, _ in cat_levels])
    multi_variants.append(v)
    print(f"hist_routed_fused_multi with categorical membership: exact; {v}")
    del bins_c, rowmajor_c, chans_c, lid, tab, member, bits, cat_levels

    # B5 hist_q8 and B8 hist_f32 over shared slot vectors at B = 256: the
    # root (S = 1, no slot vector), the slots route_level gave at S = 32
    # and 127 (about half the rows dropped), a skewed level (S = 127, about
    # half the kept rows moved into slot 0) and two lossguide-shaped passes
    # (S = 1 over a slot vector keeping about 5% and 0.5% of the rows); B8
    # also at B = 64, S = 127. hist_q8 (3 and 2 channels) exactly; hist_f32
    # on the logloss rows (g, h, count): counts exactly (integers below 2^24
    # are exact in any f32 order), g and h within 2^-15 of the cell's
    # absolute mass against the plain version's f64 sums. The yardstick of
    # each is one index_add_ of the kept rows' channels (widened to int32
    # for hist_q8) into a [nch, S * F * B] table over flat cell indices
    # precomputed for the kept rows: the same sums, channel-first. Bounds
    # count the bytes this data needs: the slot vector, and the bins and
    # channels of the kept rows only
    # S = 32 and 127 are handed route_level's counts, as on the main path,
    # and each is held against the same call without them (its own count
    # pass): hist_q8 exactly, hist_f32 within 2^-15 of the cell's mass
    u = torch.rand(N, generator=g, device=dev)
    slot_vars = {
        "root": (None, 1), "S32": (slots[32], 32), "S127": (slots[127], 127),
        "skew127": (torch.where((slots[127] < 127) & (u < 0.5), 0,
                                slots[127]).to(torch.int32), 127),
        "lossguide5%": ((u >= 0.05).to(torch.int32), 1),
        "lossguide0.5%": ((u >= 0.005).to(torch.int32), 1)}
    del u
    rows = tuple(x.contiguous() for x in ghc)
    abs_rows = (rows[0].abs(), rows[1].abs(), rows[2])
    qvariants, fvariants = [], []

    def cells(bins_s, slot, s, b_):
        """The kept rows of a slot vector and their flat cell indices into
        [S, F, B], feature-major."""
        f = bins_s.shape[0]
        keep = (torch.ones(bins_s.shape[1], dtype=torch.bool, device=dev)
                if slot is None else (slot >= 0) & (slot < s))
        ridx = keep.nonzero().squeeze(1)
        sl = (torch.zeros_like(ridx) if slot is None else slot[ridx].long())
        flat = ((sl[None, :] * f + torch.arange(f, device=dev)[:, None])
                * b_ + bins_s[:, ridx].long()).reshape(-1)
        return ridx, flat

    def yardstick(chans, dtype, ridx, flat, s, b_):
        """One index_add_ of the kept rows' channels into [nch, S * F * B]
        and its time; the sums returned as [S, nch, F, B]."""
        f = flat.numel() // max(ridx.numel(), 1)
        src = torch.stack(chans)[:, ridx].to(dtype)[:, None, :].expand(
            len(chans), f, ridx.numel()).reshape(len(chans), -1)

        def call():
            return torch.zeros(len(chans), s * f * b_, dtype=dtype,
                               device=dev).index_add_(1, flat, src)
        out = call().view(len(chans), s, f, b_).transpose(0, 1)
        return out, time_ms(call)

    def tile_variants(bins_r, rowmajor_r, q_r):
        """B5 hist_q8 and B8 hist_f32 on a feature tile of path (n)'s
        shape, read in place: the whole row-major bins [N_RANK, 700],
        bins_T's rows [lo, hi) and col0 = lo. The lean grower's second
        tile [172, 344) at S = 254, fed the slots and counts route_level
        gives for a level of 127 splits (both children measured), the
        same tile at the root (no slot vector), and an unaligned tile
        [5, 177) at S = 254 (the byte path of the compaction); hist_q8
        exactly, hist_f32 counts exactly and g, h within 2^-15 of the
        cell's absolute mass. Each timed beside the same call on a
        contiguous copy of the tile's bins (the copy the lean grower does
        not make) and beside the index_add_ yardstick."""
        k_ = torch.arange(L, device=dev)
        split_t = k_ < 127
        tab_t = torch.stack([
            torch.where(split_t, torch.randint(0, F_RANK, (L,), generator=g,
                                               device=dev), -1),
            torch.randint(0, B - 1, (L,), generator=g, device=dev),
            torch.randint(0, 2, (L,), generator=g, device=dev), 127 + k_,
            torch.where(split_t, 2 * k_, 254),
            torch.where(split_t, 2 * k_ + 1, 254)]).to(torch.int32)
        lid_t = torch.randint(0, 127, (N_RANK,), generator=g, device=dev,
                              dtype=torch.int64).to(torch.int32)
        na_r = torch.full((F_RANK,), 256, dtype=torch.int32, device=dev)
        slot_t, _, counts_t = hk.route_level(bins_r, lid_t,
                                             tab_t.contiguous(), na_r, 254)
        f_rows = (torch.randn(N_RANK, generator=g, device=dev),
                  torch.rand(N_RANK, generator=g, device=dev),
                  (torch.rand(N_RANK, generator=g, device=dev)
                   < 0.9).float())
        abs_f = (f_rows[0].abs(), f_rows[1], f_rows[2])
        for name_, lo, hi, slot, s, counts in (
                ("tile172_S254", 172, 344, slot_t, 254, counts_t),
                ("tile172_root", 172, 344, None, 1, None),
                ("tile5_S254", 5, 177, slot_t, 254, counts_t)):
            ft = hi - lo
            tile = bins_r[lo:hi]
            copy_rm = rowmajor_r[:, lo:hi].contiguous()
            ridx, flat = cells(tile, slot, s, B)
            kept = int(ridx.numel())
            slot_bytes = 0 if slot is None else 4 * N_RANK
            base = dict(variant=name_, S=s, B=B, F=ft, col0=lo,
                        tile_of=F_RANK, kept=kept,
                        counts_given=counts is not None)
            args = (tile, *q_r, slot, s, B)
            tag = f"hist_q8[{name_}]"
            ph_ = hk.hist_q8_plain(*args)
            err = exact(tag, hk.hist_q8(*args, bins=rowmajor_r,
                                        counts=counts, col0=lo), ph_)
            exact(f"{tag} on a copy", hk.hist_q8(*args, bins=copy_rm,
                                                 counts=counts), ph_)
            lib, lib_ms = yardstick(list(q_r), torch.int32, ridx, flat, s, B)
            exact(f"{tag} index_add_ yardstick", lib.contiguous(), ph_)
            del lib, ph_
            bms, by = bound(slot_bytes + kept * (ft + 3)
                            + s * 3 * ft * B * 4, kept * ft * 3)
            qvariants.append(dict(
                base, nch=3, max_abs_err=err,
                ms=time_ms(lambda: hk.hist_q8(*args, bins=rowmajor_r,
                                              counts=counts, col0=lo)),
                copy_ms=time_ms(lambda: hk.hist_q8(*args, bins=copy_rm,
                                                   counts=counts)),
                plain_ms=time_ms(lambda: hk.hist_q8_plain(*args), reps=3),
                bound_ms=bms, bound_by=by, library_ms=lib_ms))
            args = (tile, *f_rows, slot, s, B)
            tag = f"hist_f32[{name_}]"
            ph_ = hk.hist_f32_plain(*args)
            mass = hk.hist_f32_plain(tile, *abs_f, slot, s, B).double()
            errs = []
            for bins_, col0 in ((rowmajor_r, lo), (copy_rm, 0)):
                kh = hk.hist_f32(*args, bins=bins_, counts=counts, col0=col0)
                e_ = (kh.double() - ph_.double()).abs()
                if not torch.equal(kh[:, 2], ph_[:, 2]):
                    fail(f"{tag}: counts differ from the plain version")
                if bool((e_[:, :2] > 2.0 ** -15 * mass[:, :2]).any()):
                    fail(f"{tag}: kernel vs plain error {float(e_.max())} "
                         "exceeds 2^-15 of the cell's absolute mass")
                errs.append(float(e_.max()))
                del kh, e_
            lib, lib_ms = yardstick(list(f_rows), torch.float32, ridx, flat,
                                    s, B)
            lib_err = (lib.double() - ph_.double()).abs()
            if bool((lib_err[:, :2] > 2.0 ** -15 * mass[:, :2]).any()):
                fail(f"{tag}: the index_add_ yardstick computes another "
                     "function")
            del lib, lib_err, ph_, mass
            bms, by = bound(slot_bytes + kept * (ft + 12)
                            + s * 3 * ft * B * 4, kept * ft * 3)
            fvariants.append(dict(
                base, max_abs_err=errs[0],
                ms=time_ms(lambda: hk.hist_f32(*args, bins=rowmajor_r,
                                               counts=counts, col0=lo)),
                copy_ms=time_ms(lambda: hk.hist_f32(*args, bins=copy_rm,
                                                    counts=counts)),
                plain_ms=time_ms(lambda: hk.hist_f32_plain(*args), reps=3),
                bound_ms=bms, bound_by=by, library_ms=lib_ms))
            del ridx, flat, copy_rm
            torch.cuda.empty_cache()
        tiles = [v for v in qvariants + fvariants if "col0" in v]
        print("hist_q8 / hist_f32 on a feature tile read in place: exact / "
              f"within 2^-15; {tiles}")

    for name_, (slot, s), b_ in [(k, v, BW) for k, v in slot_vars.items()] \
            + [("S127", slot_vars["S127"], B)]:
        bins_s = bins_w if b_ == BW else (bins_w & (b_ - 1))
        rowmajor = bins_s.t().contiguous()    # the Dataset's bins [N, F]
        ridx, flat = cells(bins_s, slot, s, b_)
        kept = int(ridx.numel())
        slot_bytes = 0 if slot is None else 4 * N
        base = dict(variant=name_, S=s, B=b_, kept=kept)
        counts = route_counts.get(s) if name_ in ("S32", "S127") else None

        for nch, (gq, hq, cq) in (((3, quant3[:3]), (2, (quant2[0], None,
                                                          quant2[2])))
                                  if b_ == BW else ()):
            args = (bins_s, gq, hq, cq, slot, s, b_)
            tag = f"hist_q8[{name_},nch={nch}]"
            ph_ = hk.hist_q8_plain(*args)
            err = exact(tag, hk.hist_q8(*args, bins=rowmajor, counts=counts),
                        ph_)
            extra = {}
            if counts is not None:
                exact(f"{tag} without counts",
                      hk.hist_q8(*args, bins=rowmajor), ph_)
                extra["ms_without_counts"] = time_ms(
                    lambda: hk.hist_q8(*args, bins=rowmajor))
            lib, lib_ms = yardstick([x for x in (gq, hq, cq)
                                     if x is not None], torch.int32,
                                    ridx, flat, s, b_)
            exact(f"{tag} index_add_ yardstick", lib.contiguous(), ph_)
            bms, by = bound(slot_bytes + kept * (F + nch)
                            + s * nch * F * b_ * 4, kept * F * nch)
            qvariants.append(dict(
                base, nch=nch, max_abs_err=err,
                counts_given=counts is not None,
                ms=time_ms(lambda: hk.hist_q8(*args, bins=rowmajor,
                                              counts=counts)),
                **extra,
                plain_ms=time_ms(lambda: hk.hist_q8_plain(*args), reps=3),
                bound_ms=bms, bound_by=by, library_ms=lib_ms))
            del ph_, lib

        args = (bins_s, *rows, slot, s, b_)
        tag = f"hist_f32[{name_},B={b_}]"
        ph_ = hk.hist_f32_plain(*args)
        mass = hk.hist_f32_plain(bins_s, *abs_rows, slot, s, b_).double()
        extra, errs = {}, []
        for kw in ({"counts": counts},) + (({},) if counts is not None
                                           else ()):
            kh = hk.hist_f32(*args, bins=rowmajor, **kw)
            err = (kh.double() - ph_.double()).abs()
            if not torch.equal(kh[:, 2], ph_[:, 2]):
                fail(f"{tag}: counts differ from the plain version")
            if bool((err[:, :2] > 2.0 ** -15 * mass[:, :2]).any()):
                fail(f"{tag}: kernel vs plain error {float(err.max())} "
                     "exceeds 2^-15 of the cell's absolute mass")
            errs.append(float(err.max()))
        if counts is not None:
            extra["ms_without_counts"] = time_ms(
                lambda: hk.hist_f32(*args, bins=rowmajor))
        lib, lib_ms = yardstick(list(rows), torch.float32, ridx, flat, s, b_)
        lib_err = (lib.double() - ph_.double()).abs()
        if bool((lib_err[:, :2] > 2.0 ** -15 * mass[:, :2]).any()):
            fail(f"{tag}: the index_add_ yardstick computes another function")
        bms, by = bound(slot_bytes + kept * (F + 12) + s * 3 * F * b_ * 4,
                        kept * F * 3)
        fvariants.append(dict(
            base, max_abs_err=errs[0], counts_given=counts is not None,
            ms=time_ms(lambda: hk.hist_f32(*args, bins=rowmajor,
                                           counts=counts)), **extra,
            plain_ms=time_ms(lambda: hk.hist_f32_plain(*args), reps=3),
            bound_ms=bms, bound_by=by, library_ms=lib_ms))
        del kh, ph_, mass, err, lib, lib_err, ridx, flat, rowmajor
        torch.cuda.empty_cache()
    # hist_q8 at path (i)'s width: F = 700, B = 64 (three feature groups a
    # slot histogram block), N_RANK rows, 3 channels: the root and S = 32
    # (slots over [0, 32], slot 32 and about half the rows dropped), with
    # and without the slot counts, exactly, and timed against the same
    # index_add_ yardstick as the F = 28 variants
    bins_r = torch.randint(0, B - 1, (F_RANK, N_RANK), generator=g,
                           device=dev, dtype=torch.int64).to(torch.uint8)
    rowmajor_r = bins_r.t().contiguous()
    q_r = tuple(x[:N_RANK].contiguous() for x in quant3[:3])
    slot_r = torch.randint(0, 64, (N_RANK,), generator=g, device=dev,
                           dtype=torch.int64).clamp_(max=32).to(torch.int32)
    counts_r = torch.bincount(slot_r[slot_r < 32].long(),
                              minlength=32).to(torch.int32)
    for name_, slot, s, counts in (("F700root", None, 1, None),
                                   ("F700S32", slot_r, 32, counts_r)):
        args = (bins_r, *q_r, slot, s, B)
        tag = f"hist_q8[{name_},nch=3]"
        ph_ = hk.hist_q8_plain(*args)
        err = exact(tag, hk.hist_q8(*args, bins=rowmajor_r, counts=counts),
                    ph_)
        if counts is not None:
            exact(f"{tag} without counts", hk.hist_q8(*args, bins=rowmajor_r),
                  ph_)
        ridx, flat = cells(bins_r, slot, s, B)
        kept = int(ridx.numel())
        lib, lib_ms = yardstick(list(q_r), torch.int32, ridx, flat, s, B)
        exact(f"{tag} index_add_ yardstick", lib.contiguous(), ph_)
        del lib, ridx, flat
        bms, by = bound((0 if slot is None else 4 * N_RANK)
                        + kept * (F_RANK + 3) + s * 3 * F_RANK * B * 4,
                        kept * F_RANK * 3)
        qvariants.append(dict(
            variant=name_, S=s, B=B, F=F_RANK, kept=kept, nch=3,
            max_abs_err=err, counts_given=counts is not None,
            ms=time_ms(lambda: hk.hist_q8(*args, bins=rowmajor_r,
                                          counts=counts)),
            plain_ms=time_ms(lambda: hk.hist_q8_plain(*args), reps=3),
            bound_ms=bms, bound_by=by, library_ms=lib_ms))
        del ph_
        torch.cuda.empty_cache()
    tile_variants(bins_r, rowmajor_r, q_r)
    del bins_r, rowmajor_r, q_r, slot_r, counts_r
    torch.cuda.empty_cache()
    # B6 with EFB bundle bitsets, and B5 fed B6's counts, at path (l)'s
    # shape: F = 16, B = 256 (F * B = 4096, the unfused front), N rows; six
    # single columns (bins uniform on [0, 256)) and ten bundle columns of
    # 127 one-hot members each (bin 0, every member at its default, on a
    # third of the rows; else member k's non-default position 2k + 2, k
    # skewed as the leaves of skewed_leaves). Route tables whose splitting
    # leaves mix numerical splits on the single columns with bundle splits
    # (the is_cat row) whose bitsets are what a bundle split sends left: a
    # member's first position and every bin outside its range, or every
    # bin outside it ("t == default", the empty prefix). Exactly against
    # route_plain and hist_q8_plain (3 channels), at S = 32 and 127; their
    # own generator, so the other phases' inputs stay as they were
    gen_b = torch.Generator(device=dev).manual_seed(12)
    fb_, singles = 16, 6
    bins_b = torch.stack([
        torch.randint(0, BW, (N,), generator=gen_b, device=dev,
                      dtype=torch.int64).to(torch.uint8) if j < singles else
        torch.where(torch.rand(N, generator=gen_b, device=dev) < 1 / 3, 0,
                    2 * skewed_leaves(N, 127, lambda n: torch.rand(
                        n, generator=gen_b, device=dev)).long() + 2).to(
                            torch.uint8)
        for j in range(fb_)]).contiguous()
    rowmajor_b = bins_b.t().contiguous()
    na_b = torch.full((fb_,), 256, dtype=torch.int32, device=dev)
    q_b = tuple(x.contiguous() for x in quant3[:3])
    iota_b = torch.arange(BW, device=dev)[None, :]
    bun_b6 = []
    for s in (32, 127):
        lid = torch.randint(0, min(L, 2 * s), (N,), generator=gen_b,
                            device=dev, dtype=torch.int64).to(torch.int32)
        k_ = torch.arange(L, device=dev)
        split = k_ < s
        small_left = (torch.rand(L, generator=gen_b, device=dev) < 0.5) \
            | (k_ == 0)
        feat = torch.where(split, torch.randint(0, fb_, (L,), generator=gen_b,
                                                device=dev), -1)
        is_cat = split & (feat >= singles)
        off = 1 + 2 * torch.randint(0, 127, (L,), generator=gen_b,
                                    device=dev)[:, None]
        first = torch.rand(L, generator=gen_b, device=dev)[:, None] < 0.5
        member = ((iota_b < off) | (iota_b > off + 1)
                  | (first & (iota_b == off)))
        bits = hk.member_bitset(member)
        words = bits.shape[1]
        tab = torch.stack([
            feat, torch.randint(0, BW - 1, (L,), generator=gen_b, device=dev),
            torch.zeros_like(k_), s + k_,
            torch.where(split & small_left, k_, s),
            torch.where(split & ~small_left, k_, s), is_cat]).to(
                torch.int32).contiguous()
        rargs = (bins_b, lid, tab, na_b, s)
        tag = f"route_level[bundle S{s}, F={fb_}, B={BW}]"
        ks, kl, kc = hk.route_level(*rargs, catbits=bits)
        ps_, pl_, pc_ = hk.route_plain(*rargs, catbits=bits)
        err = max(exact(f"{tag}.slot", ks, ps_), exact(f"{tag}.lid2", kl, pl_),
                  exact(f"{tag}.counts", kc, pc_))
        del ps_, pl_, pc_
        routed = int((lid < s).sum())
        bms, by = bound(12 * N + routed + 4 * s + (7 + words) * L * 4
                        + fb_ * 4, 8 * N)
        bun_b6.append(dict(
            variant=f"bundle_S{s}", bundle=True, F=fb_, B=BW, S=s,
            routed=routed, bundle_leaves=int(is_cat.sum()), max_abs_err=err,
            ms=time_ms(lambda: hk.route_level(*rargs, catbits=bits)),
            device_ms=device_ms(lambda: hk.route_level(*rargs,
                                                        catbits=bits)),
            plain_ms=time_ms(lambda: hk.route_plain(*rargs, catbits=bits),
                             reps=3),
            numerical_tables_ms=time_ms(lambda: hk.route_level(
                bins_b, lid, tab[:6].contiguous(), na_b, s)),
            bound_ms=bms, bound_by=by))
        args = (bins_b, *q_b, ks, s, BW)
        tag = f"hist_q8[bundle S{s} with route_level's counts, F={fb_}]"
        ph_ = hk.hist_q8_plain(*args)
        err = exact(tag, hk.hist_q8(*args, bins=rowmajor_b, counts=kc), ph_)
        ridx, flat = cells(bins_b, ks, s, BW)
        kept = int(ridx.numel())
        lib, lib_ms = yardstick(list(q_b), torch.int32, ridx, flat, s, BW)
        exact(f"{tag} index_add_ yardstick", lib.contiguous(), ph_)
        del lib, ridx, flat, ph_
        bms, by = bound(4 * N + kept * (fb_ + 3) + s * 3 * fb_ * BW * 4,
                        kept * fb_ * 3)
        qvariants.append(dict(
            variant=f"bundle_S{s}", S=s, B=BW, F=fb_, kept=kept, nch=3,
            max_abs_err=err, counts_given=True,
            ms=time_ms(lambda: hk.hist_q8(*args, bins=rowmajor_b,
                                          counts=kc)),
            device_ms=device_ms(lambda: hk.hist_q8(*args, bins=rowmajor_b,
                                                   counts=kc)),
            plain_ms=time_ms(lambda: hk.hist_q8_plain(*args), reps=3),
            bound_ms=bms, bound_by=by, library_ms=lib_ms))
        del ks, kl, kc
        torch.cuda.empty_cache()
    kernels["route_level"]["variants"] += bun_b6
    kernels["route_level"]["max_abs_err"] = max(
        v["max_abs_err"] for v in kernels["route_level"]["variants"])
    print(f"route_level with bundle bitsets: exact; {bun_b6}")
    print(f"hist_q8 fed route_level's counts on bundle columns: exact; "
          f"{[v for v in qvariants if v['variant'].startswith('bundle')]}")
    del bins_b, rowmajor_b, q_b, lid, tab, member, bits
    torch.cuda.empty_cache()
    for nm, variants, extra in (
            ("hist_q8", qvariants, dict(source="lightgbm_tpu_torch/csrc/"
                                        "hist_q8.cu", replaces="lightgbm_tpu/"
                                        "ops/pallas_hist.py:372")),
            ("hist_f32", fvariants, dict(source="lightgbm_tpu_torch/csrc/"
                                         "hist_f32.cu", replaces="lightgbm_"
                                         "tpu/ops/pallas_hist.py:114"))):
        main_v = next(v for v in variants if v["variant"] == "S127"
                      and v["B"] == BW and v.get("nch", 3) == 3)
        kernels[nm] = dict(
            route="cuda", **extra,
            max_abs_err=max(v["max_abs_err"] for v in variants),
            ms=main_v["ms"], plain_ms=main_v["plain_ms"],
            bound_ms=main_v["bound_ms"], bound_by=main_v["bound_by"],
            library_ms=main_v["library_ms"], variants=variants)
        print(f"{nm}: {'exact' if nm == 'hist_q8' else 'counts exact'}; "
              f"{variants}")
    del bins_w, slots, route_counts, counts, slot_vars, slot, bins_s, rows
    del abs_rows, args
    torch.cuda.empty_cache()

    # B7 leaf_sums on the same rows materialized (see B3)
    lid = torch.randint(0, L, (N,), generator=g, device=dev,
                        dtype=torch.int64).to(torch.int32)
    rows = (ghc[0].contiguous(), ghc[1].contiguous(), ghc[2].contiguous())
    leaf_sums_phase("leaf_sums", hk.leaf_sums, hk.leaf_sums_plain,
                    lambda lid_: rows + (lid_, L), ghc, lid, 3,
                    "lightgbm_tpu/ops/pallas_hist.py:718")
    del score, label_pos, label_reg, bag, lid, ghc, rows
    del quant2, quant3
    torch.cuda.empty_cache()

    # ---- 4. main paths through the public entry points ----
    t0 = time.perf_counter()
    X, y, latent, w_gen = synth_higgs(N, F, seed=0, latent=True,
                                      weights=True)
    rng = np.random.RandomState(1)
    y_reg = (X[:, :4] @ np.array([1.0, -0.5, 0.25, 2.0]) + 0.5 * X[:, 4] ** 2
             + 0.1 * rng.randn(N)).astype(np.float32)
    print(f"data: {time.perf_counter() - t0:.3f} s")
    m = min(1_000_000, N)
    launches_all = {k: 0 for k in hk.KERNELS}

    datasets = {}

    def dataset(max_bin: int):
        """The (binary, L2) Datasets of one bin count, constructed once and
        shared by the paths at that bin count."""
        if max_bin not in datasets:
            params = {"max_bin": max_bin, "verbosity": -1}
            t0 = time.perf_counter()
            ds = lt.Dataset(X, label=y, params=params, free_raw_data=False)
            ds.construct()
            torch.cuda.synchronize()
            construct_s = time.perf_counter() - t0
            ds_reg = lt.Dataset(X, label=y_reg, params=params)
            ds_reg.construct()
            torch.cuda.synchronize()
            print(f"[max_bin={max_bin}] construct: {construct_s:.3f} s ({N} x "
                  f"{F}, {ds.num_features} used features, max bins "
                  f"{ds.max_num_bins})")
            datasets[max_bin] = (ds, ds_reg)
        return datasets[max_bin]

    def expected_launches(path: str, trees: int, n_pass: int, added: int,
                          searches: int):
        """(launch count of every kernel, the path's own kernels);
        ``searches`` S1's (split_searches)."""
        if path == "fused":
            exp = {"grad_quant_hist0": trees, "leaf_sums_grad": trees,
                   "hist_routed_fused": n_pass}
        elif path == "unfused":
            exp = {"hist_q8": trees + n_pass, "route_level": n_pass,
                   "leaf_sums": trees}
        elif path == "f32":
            exp = {"hist_f32": trees + n_pass, "route_level": n_pass}
        elif path == "weighted":
            # materialized weighted rows at F * B <= 2048: the root through
            # hist_q8, each level through the fused level pass
            exp = {"hist_q8": trees, "hist_routed_fused": n_pass,
                   "leaf_sums": trees}
        else:
            exp = {"hist_f32": trees + n_pass}
        exp["take_small"] = added
        out = {k: exp.get(k, 0) for k in hk.KERNELS}
        out["split_search"] = searches
        return out, tuple(exp)

    def main_path(path: str) -> None:
        max_bin, extra, iters = PATHS[path]
        params = {"objective": "binary", "num_leaves": L, "max_bin": max_bin,
                  "learning_rate": 0.1, "min_data_in_leaf": 20,
                  "verbosity": -1, **extra}
        reg_params = dict(params, objective="regression")
        ds, ds_reg = dataset(max_bin)
        tag = f"[{path}, max_bin={max_bin}]"

        hk.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        bst = lt.train(params, ds, num_boost_round=iters)
        torch.cuda.synchronize()
        bin_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        reg = lt.train(reg_params, ds_reg, num_boost_round=2)
        torch.cuda.synchronize()
        reg_s = time.perf_counter() - t0
        launches = dict(hk.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        passes = bst._gbdt.hist_passes + reg._gbdt.hist_passes
        trees, n_pass = len(passes), sum(passes)
        added = bst.num_trees() + reg.num_trees()
        expected, own = expected_launches(path, trees, n_pass, added,
                                          split_searches(bst, reg))
        what = "splits" if path == "lossguide" else "level passes"
        print(f"{tag} train binary: {bin_s:.3f} s for {iters} iterations "
              f"({bin_s / iters:.3f} s/iter), {what} a tree "
              f"{bst._gbdt.hist_passes}; L2: {reg_s:.3f} s for 2 "
              f"({reg_s / 2:.3f} s/iter), {what} {reg._gbdt.hist_passes}")
        if path == "lossguide":
            # one host sync a split step, plus the step that finds no
            # split when a tree stops short of num_leaves
            syncs = [p + (p < L - 1) for p in passes]
            print(f"{tag} host syncs a tree (split steps): {syncs}")
        print(f"{tag} launches {launches} expected {expected}")
        print(f"{tag} peak device memory in training: {peak} bytes "
              f"({peak / 2 ** 30:.3f} GiB; torch.cuda.max_memory_allocated, "
              "both Datasets of the bin count resident)")
        if launches != expected or min(launches[k] for k in own) <= 0:
            fail(f"{path}: launch counts {launches} != expected {expected}")
        for k, v in launches.items():
            launches_all[k] += v
        gp = bst._gbdt.gp
        want = {"fused": (True, True), "unfused": (True, False),
                "f32": (False, False), "lossguide": (False, False)}[path]
        if (gp.quant, gp.fused_obj is not None) != want or (
                not gp.quant and reg._gbdt.gp.const_hess):
            fail(f"{path}: the booster took the wrong front (quant "
                 f"{gp.quant}, fused {gp.fused_obj})")

        prob = bst.predict(X[:m])
        if prob.shape != (m,) or not np.isfinite(prob).all():
            fail(f"{path}: binary predictions are not finite [1M] values")
        auc = float(metrics.auc(torch.as_tensor(y[:m]),
                                torch.as_tensor(prob)))
        print(f"{tag} train AUC on 1M rows: {auc:.6f}")
        if not auc > 0.7:
            fail(f"{path}: train AUC {auc} <= 0.7")
        if path == "lossguide":
            # (n'') trains 2 iterations of this model with a pool
            path_auc[path] = float(metrics.auc(torch.as_tensor(y[:m]),
                                               torch.as_tensor(bst.predict(
                                                   X[:m], num_iteration=2))))
            path_trees[path] = bst._host_trees()[:2]
        reg_pred = reg.predict(X[:m])
        mse0 = float(np.mean((y_reg[:m] - y_reg.mean()) ** 2))
        mse = float(np.mean((y_reg[:m] - reg_pred) ** 2))
        print(f"{tag} L2 model: train mse {mse:.6f} vs label variance "
              f"{mse0:.6f}")
        if not (np.isfinite(reg_pred).all() and mse < mse0):
            fail(f"{path}: L2 model did not reduce the squared error")
        os.makedirs(OUT_DIR, exist_ok=True)
        fname = os.path.join(OUT_DIR, f"chip_smoke_model_{path}.txt")
        bst.save_model(fname)
        loaded = lt.Booster(model_file=fname)
        if not np.array_equal(loaded.predict(X[:m], raw_score=True),
                              bst.predict(X[:m], raw_score=True)):
            fail(f"{path}: saved and loaded model predict differently")
        print(f"{tag} model text round trip: predictions identical")

    def pooled_path() -> None:
        """(n''): (d) with histogram_pool_size=8: the leaf-wise grower
        caches 8 MiB // (3 * 28 * 256 * 4 B) = 97 of 255 leaf histograms,
        and an evicted parent is rebuilt by one more hist_f32 pass; binary
        for 2 iterations on (d)'s Dataset."""
        ds, _ = dataset(255)
        params = {"objective": "binary", "num_leaves": L, "max_bin": 255,
                  "learning_rate": 0.1, "min_data_in_leaf": 20,
                  "verbosity": -1, "grow_policy": "lossguide",
                  "histogram_pool_size": 8}
        tag = "[pooled (n''), max_bin=255]"
        hk.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = lt.train(params, ds, num_boost_round=2)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        gb = bst._gbdt
        per_leaf = 3 * ds.num_features * BW * 4
        want_pool = max(2, (8 << 20) // per_leaf)
        print(f"{tag} {sec:.3f} s for 2 iterations ({sec / 2:.3f} s/iter); "
              f"pool {gb.gp.hist_pool} of {L} leaves ({per_leaf} B a leaf), "
              f"splits a tree {gb.hist_passes}, rebuilds a tree "
              f"{gb.hist_rebuilds}; peak device memory {peak} bytes")
        if gb.gp.hist_pool != want_pool or not want_pool < L:
            fail(f"{tag}: pool of {gb.gp.hist_pool}, expected {want_pool}")
        if min(gb.hist_rebuilds) < 1:
            fail(f"{tag}: a tree without a rebuild ({gb.hist_rebuilds})")
        launches = dict(hk.LAUNCHES)
        trees = len(gb.hist_passes)
        expected = {k: 0 for k in hk.KERNELS}
        expected["hist_f32"] = (trees + sum(gb.hist_passes)
                                + sum(gb.hist_rebuilds))
        expected["take_small"] = bst.num_trees()
        expected["split_search"] = split_searches(bst)
        print(f"{tag} launches {launches} expected {expected}")
        if launches != expected or trees != bst.num_trees():
            fail(f"{tag}: launch counts {launches} != expected {expected}")
        for k, v in launches.items():
            launches_all[k] += v
        prob = bst.predict(X[:m])
        auc = float(metrics.auc(torch.as_tensor(y[:m]),
                                torch.as_tensor(prob)))
        same = sum(all(np.array_equal(getattr(a, f_), getattr(b, f_))
                       for f_ in ("split_feature", "threshold_bin",
                                  "left_child", "right_child"))
                   for a, b in zip(bst._host_trees(),
                                   path_trees["lossguide"]))
        print(f"{tag} train AUC on 1M rows {auc:.6f}, (d)'s at 2 iterations "
              f"{path_auc['lossguide']:.6f}; trees with (d)'s structure: "
              f"{same} of 2")
        if not (np.isfinite(prob).all()
                and abs(auc - path_auc["lossguide"]) <= 0.005):
            fail(f"{tag}: AUC {auc} not within 0.005 of (d)'s "
                 f"{path_auc['lossguide']}")
        print(f"{tag} one iteration by part (torch.profiler): "
              f"{json.dumps(iteration_parts(bst, reps=1))}")

    def multi_level_path() -> None:
        """B2's multi-level replay (hist_routed_fused_multi) on path (a)'s
        data: the route tables of the first three level passes of one tree
        of (a)'s binary model (3 channels) and of its L2 model (2, the
        const-hessian front), recorded from the live hist_routed_fused
        calls of one update of the serial grower with capture off (each
        pass at the schedule's width, its slots past the level's count
        empty), replayed in one launch from the root's leaf ids with each
        level's own slot width, the slots its tables fill: each band
        equals its live pass, the final leaf ids the third pass's, and
        everything the plain version (multi_variant). Then the path that
        runs it, scripts/torch_profile_level.py's shallow megapass at
        (a)'s width on its bins: levels 1..5 of one tree in two launches
        (grad_quant_hist0 and hist_routed_fused_multi), its launch counts
        zeroed just before and read just after them, bit-identical to five
        sequential level passes."""
        sys.path.insert(0, os.path.join(HERE, "scripts"))
        import torch_profile_level as tpl
        ds, ds_reg = dataset(63)
        orig_routed, orig_front = hk.hist_routed_fused, hk.grad_quant_hist0
        for nm, d_, obj in (("binary", ds, "binary"),
                            ("l2", ds_reg, "regression")):
            live, front = [], []

            def routed(bins_T_, gq, hq, cq, leaf_id, tables, na_bin,
                       num_slots, num_bins, bins=None, catbits=None):
                out = orig_routed(bins_T_, gq, hq, cq, leaf_id, tables,
                                  na_bin, num_slots, num_bins, bins, catbits)
                if len(live) < 3:
                    # the level's own width: the slots of its splits
                    s_ = int((tables[0] >= 0).sum())
                    if out[0][s_:].any():
                        fail(f"multi-level replay [{nm}]: a live pass "
                             "filled a slot past its level's count")
                    live.append((leaf_id.clone(), tables.clone(), s_,
                                 num_bins, catbits, (out[0][:s_], out[1])))
                return out

            def recorded_front(*a, **kw):
                out = orig_front(*a, **kw)
                front.append(out)
                return out
            hk.hist_routed_fused, hk.grad_quant_hist0 = routed, recorded_front
            try:
                bst_ = lt.Booster(params={"objective": obj, "num_leaves": L,
                                          "max_bin": 63, "learning_rate": 0.1,
                                          "min_data_in_leaf": 20,
                                          "verbosity": -1}, train_set=d_)
                # capture off: the passes run eagerly, each one recorded
                bst_._gbdt._level_graphs = None
                bst_.update()
                torch.cuda.synchronize()
            finally:
                hk.hist_routed_fused = orig_routed
                hk.grad_quant_hist0 = orig_front
            if len(live) < 3 or len(front) != 1 or bool(live[0][0].any()) \
                    or any(c is not None for *_, c, _ in live):
                fail(f"multi-level replay [{nm}]: the first tree did not "
                     "take three numerical fused level passes from the root")
            widths = [s_ for _, _, s_, _, _, _ in live]
            nb = live[0][3]
            tag = f"replay of (a)'s {nm} tree, levels 1-3"
            v, kh, kl = multi_variant(
                tag, d_.bins_T, d_.bins, front[0][:3], live[0][0],
                [t for _, t, _, _, _, _ in live], d_.na_bin_dev, widths, nb)
            for dd, (*_, (h_, l_)) in enumerate(live):
                if not torch.equal(kh[dd, :widths[dd]], h_):
                    fail(f"{tag}: level {dd + 1} differs from the live pass")
            if not torch.equal(kl, live[2][5][1]):
                fail(f"{tag}: final leaf ids differ from the live passes")
            if nm == "binary":
                split = device_split(lambda: hk.hist_routed_fused_multi(
                    d_.bins_T, *front[0][:3], live[0][0],
                    [t for _, t, _, _, _, _ in live], d_.na_bin_dev, widths,
                    nb, bins=d_.bins))
                v["device_ms_by_kernel"] = split
                v["device_ms"] = (None if split is None
                                  else sum(split.values()))
            # the replays first, then phase 3's categorical one
            multi_variants.insert(0 if nm == "binary" else 1, v)
            print(f"[{tag}] equal to the live passes and the plain version "
                  f"bit for bit; {json.dumps(v)}")
            del live, front, kh, kl

        case = tpl.megapass_case(N, F, padded_bins(ds.max_num_bins), L, dev,
                                 bins=ds.bins)
        sh = tpl.shallow_megapass(case)
        own = {"grad_quant_hist0": 1, "hist_routed_fused_multi": 1}
        print(f"[shallow megapass (scripts/torch_profile_level.py), levels "
              f"{sh['levels']}, S = {sh['slot_width']}] {json.dumps(sh)}")
        if sh["launches_by_wrapper"] != own or \
                not sh["bit_identical_vs_sequential"]:
            fail(f"shallow megapass: launches {sh['launches_by_wrapper']} != "
                 f"{own} or not bit-identical to the sequential passes")
        for k, v_ in own.items():
            launches_all[k] += v_
        del case
        main_v = multi_variants[0]
        kernels["hist_routed_fused_multi"] = dict(
            route="cuda",
            source="lightgbm_tpu_torch/csrc/hist_routed_fused_multi.cu",
            replaces="lightgbm_tpu/ops/pallas_hist.py:574",
            max_abs_err=max(v["max_abs_err"] for v in multi_variants),
            ms=main_v["ms"], device_ms=main_v["device_ms"],
            sequential_ms=main_v["sequential_ms"],
            plain_ms=main_v["plain_ms"], bound_ms=main_v["bound_ms"],
            bound_by=main_v["bound_by"], library_ms=None,
            variants=multi_variants, shallow_megapass=sh)
        torch.cuda.empty_cache()

    path_auc, path_trees = {}, {}
    for path in PATHS:
        main_path(path)
    pooled_path()
    t0 = time.perf_counter()
    multi_level_path()
    print(f"the multi-level replay and the shallow megapass: "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"elapsed after paths (a)-(d), (n''), the multi-level replay: "
          f"{time.perf_counter() - t_start:.1f} s")

    # ---- 4b. (e) sampled and (f) GOSS, through the public entry points ----
    from lightgbm_tpu_torch.utils import threefry
    Xv, yv = synth_higgs(N_VALID, F, seed=1)
    yv_reg = (Xv[:, :4] @ np.array([1.0, -0.5, 0.25, 2.0])
              + 0.5 * Xv[:, 4] ** 2
              + 0.1 * np.random.RandomState(2).randn(N_VALID)).astype(
                  np.float32)

    def count_launches(tag, path, boosters, n_valid):
        """Check the launch counts of boosters trained since the last
        reset, each with n_valid valid sets (a take_small a tree each)."""
        launches = dict(hk.LAUNCHES)
        passes = [p for b in boosters for p in b._gbdt.hist_passes]
        added = sum(b.num_trees() for b in boosters)
        expected, own = expected_launches(path, len(passes), sum(passes),
                                          added * (1 + n_valid),
                                          split_searches(*boosters))
        if len(passes) != added:
            fail(f"{tag}: {len(passes)} trees grown, {added} kept")
        print(f"{tag} launches {launches} expected {expected}")
        if launches != expected or min(launches[k] for k in own) <= 0:
            fail(f"{tag}: launch counts {launches} != expected {expected}")
        for k, v in launches.items():
            launches_all[k] += v

    def check_auc(tag, bst):
        prob = bst.predict(X[:m])
        if prob.shape != (m,) or not np.isfinite(prob).all():
            fail(f"{tag}: binary predictions are not finite [1M] values")
        auc = float(metrics.auc(torch.as_tensor(y[:m]),
                                torch.as_tensor(prob)))
        print(f"{tag} train AUC on 1M rows: {auc:.6f}")
        if not auc > 0.7:
            fail(f"{tag}: train AUC {auc} <= 0.7")

    def sampled_path() -> None:
        """(e): max_bin=63 (the fused front) with bagging 0.8 every
        iteration, feature_fraction 0.8 and feature_fraction_bynode 0.8; a
        500,000-row valid set, early stopping after 3 rounds; binary for
        10 iterations (valid AUC), then L2 for 3 (valid l2)."""
        ds, ds_reg = dataset(63)
        tag = "[sampled, max_bin=63]"
        boosters = []
        hk.reset_launches()
        for objective, train_ds, yval, iters, metric in (
                ("binary", ds, yv, 10, "auc"),
                ("regression", ds_reg, yv_reg, 3, "l2")):
            params = {"objective": objective, "num_leaves": L, "max_bin": 63,
                      "learning_rate": 0.1, "min_data_in_leaf": 20,
                      "verbosity": -1, "metric": metric, **SAMPLED}
            valid = lt.Dataset(Xv, label=yval, reference=train_ds)
            valid.construct()
            evals = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bst = lt.train(params, train_ds, num_boost_round=iters,
                           valid_sets=[valid], valid_names=["valid"],
                           evals_result=evals, early_stopping_rounds=3,
                           verbose_eval=False)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            boosters.append(bst)
            gb = bst._gbdt
            ran = len(evals["valid"][metric])
            share = float(gb._bag.mean())
            n_feat = int(gb._fmask.sum())
            print(f"{tag} {objective}: {sec:.3f} s for {ran} iterations "
                  f"({sec / ran:.3f} s/iter), "
                  f"level passes a tree {gb.hist_passes}; fused front "
                  f"{gb.gp.fused_obj is not None}; in-bag share of rows "
                  f"{share:.6f}; features a tree {n_feat} of {F}")
            print(f"{tag} {objective}: valid {metric} by iteration "
                  f"{evals['valid'][metric]}; best_iteration "
                  f"{bst.best_iteration}, best_score {bst.best_score}")
            if gb.gp.fused_obj is None or not gb.gp.quant:
                fail(f"{tag} {objective}: the booster left the fused front")
            if abs(share - 0.8) > 1e-3:
                fail(f"{tag} {objective}: in-bag share {share} not 0.8 +- "
                     "0.001")
            if n_feat != round(0.8 * F):
                fail(f"{tag} {objective}: {n_feat} features a tree")
            if not 0 < bst.best_iteration <= ran:
                fail(f"{tag} {objective}: best_iteration "
                     f"{bst.best_iteration} after {ran} iterations")
            fname = os.path.join(OUT_DIR, f"chip_smoke_model_sampled_"
                                 f"{objective}.txt")
            bst.save_model(fname)
            loaded = lt.Booster(model_file=fname)
            if loaded.num_trees() != bst.best_iteration or not np.array_equal(
                    loaded.predict(X[:m], raw_score=True),
                    bst.predict(X[:m], raw_score=True)):
                fail(f"{tag} {objective}: the saved model does not hold the "
                     "best_iteration trees that predict() uses")
            print(f"{tag} {objective}: model text round trip holds "
                  f"{loaded.num_trees()} trees (best_iteration), predictions "
                  "identical")
        count_launches(tag, "fused", boosters, 1)
        check_auc(tag, boosters[0])
        gb = boosters[0]._gbdt
        key = threefry.prng_key(3)
        draw = dict(
            uniform_ms=time_ms(lambda: threefry.uniform(key, (N,), dev)),
            bag_mask_ms=time_ms(lambda: gb._update_bag(0, None, None)),
            bag_mask_device_ms=device_ms(lambda: gb._update_bag(0, None,
                                                                None)))
        print(f"{tag} bag draw at N = {N} (CUDA events; the replica's "
              f"uniforms alone, then split + uniform + compare): {draw}")
        sampling["bag_draw"] = draw

    def goss_path() -> None:
        """(f): boosting=goss (top_rate 0.2, other_rate 0.1) at max_bin=255,
        binary for 5 iterations and L2 for 2: materialized gradients, so
        hist_q8 / route_level / leaf_sums with the hessian channel."""
        ds, ds_reg = dataset(255)
        tag = "[goss, max_bin=255]"
        hk.reset_launches()
        boosters = []
        for objective, train_ds, iters in (("binary", ds, 5),
                                           ("regression", ds_reg, 2)):
            params = {"objective": objective, "num_leaves": L,
                      "max_bin": 255, "learning_rate": 0.1,
                      "min_data_in_leaf": 20, "verbosity": -1, **GOSS}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bst = lt.train(params, train_ds, num_boost_round=iters)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            boosters.append(bst)
            gb = bst._gbdt
            w = gb._bag
            print(f"{tag} {objective}: {sec:.3f} s for {iters} iterations "
                  f"({sec / iters:.3f} s/iter), level passes a tree "
                  f"{gb.hist_passes}; rows kept at weight 1: "
                  f"{int((w == 1).sum())}, up-weighted: "
                  f"{int((w > 1).sum())} (x{float(w.max()):g})")
            if gb.gp.fused_obj is not None or gb.gp.const_hess \
                    or not gb.gp.quant:
                fail(f"{tag} {objective}: GOSS must take the unfused front "
                     "with all three channels")
            kinds = set(torch.unique(w).tolist())
            if not kinds <= {0.0, 1.0, 8.0} or 8.0 not in kinds:
                fail(f"{tag} {objective}: GOSS weights {kinds}, expected "
                     "0, 1 and (1 - 0.2) / 0.1 = 8")
        count_launches(tag, "unfused", boosters, 0)
        check_auc(tag, boosters[0])
        gb = boosters[0]._gbdt
        grad, hess = gb.objective.get_gradients(gb.train_score)
        score = (grad * hess).abs()
        sampling["goss_draw"] = dict(
            topk_ms=time_ms(lambda: torch.topk(score, int(N * 0.2),
                                               sorted=False)),
            weights_ms=time_ms(lambda: gb._update_bag(0, grad, hess)),
            weights_device_ms=device_ms(lambda: gb._update_bag(0, grad,
                                                               hess)))
        print(f"{tag} GOSS draw at N = {N} (CUDA events; torch.topk of "
              f"|g * h| alone, then the whole weight draw): "
              f"{sampling['goss_draw']}")

    sampling = {}
    sampled_path()
    goss_path()
    print(f"elapsed after paths (e)-(f): "
          f"{time.perf_counter() - t_start:.1f} s")

    # ---- 4c. (g) multiclass and (h) weighted, through the entry points ----
    q = np.quantile(latent, [0.2, 0.4, 0.6, 0.8])
    y5 = np.digitize(latent, q).astype(np.float32)
    w_rows = np.random.RandomState(2).uniform(0.5, 2.0, N).astype(np.float32)
    slice_ms = {}

    def multiclass_path() -> None:
        """(g): objective=multiclass, num_class=5 (the quintiles of the
        generator's latent score) at max_bin=255 for 3 iterations, 15
        trees; then one multiclassova iteration on the same Dataset."""
        ds255, _ = dataset(255)
        ds5 = lt.Dataset(X, label=y5, reference=ds255)
        ds5.construct()
        tag = "[multiclass, max_bin=255]"
        boosters = []
        hk.reset_launches()
        for objective, iters in (("multiclass", 3), ("multiclassova", 1)):
            params = {"objective": objective, "num_class": 5,
                      "num_leaves": L, "max_bin": 255, "learning_rate": 0.1,
                      "min_data_in_leaf": 20, "verbosity": -1,
                      "metric": "multi_logloss,multi_error"}
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bst = lt.train(params, ds5, num_boost_round=iters)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            boosters.append(bst)
            gb = bst._gbdt
            print(f"{tag} {objective}: {sec:.3f} s for {iters} iterations "
                  f"({sec / iters:.3f} s/iter, {bst.num_trees()} trees), "
                  f"level passes a tree {gb.hist_passes}; peak device "
                  f"memory {peak} bytes ({peak / 2 ** 30:.3f} GiB, both "
                  "Datasets of max_bin=255 and this one resident)")
            if (gb.gp.fused_obj is not None or gb.gp.const_hess
                    or bst.num_trees() != 5 * iters
                    or tuple(gb.train_score.shape) != (N, 5)):
                fail(f"{tag} {objective}: not K = 5 trees an iteration on "
                     "the unfused front with three channels")
            prob = bst.predict(X[:m])
            if prob.shape != (m, 5) or not np.isfinite(prob).all():
                fail(f"{tag} {objective}: predictions are not finite "
                     "[1M, 5] values")
            fname = os.path.join(OUT_DIR, f"chip_smoke_model_{objective}.txt")
            bst.save_model(fname)
            loaded = lt.Booster(model_file=fname)
            if not np.array_equal(loaded.predict(X[:m]), prob):
                fail(f"{tag} {objective}: saved and loaded model predict "
                     "differently")
            if objective == "multiclassova":
                continue
            if np.abs(prob.sum(axis=1) - 1.0).max() > 1e-6:
                fail(f"{tag}: softmax rows do not sum to 1 within 1e-6")
            mlog = metrics.create_metrics(["multi_logloss", "multi_error"])
            lab = torch.as_tensor(y5[:m])
            losses = []
            for it in range(1, iters + 1):
                p_it = torch.as_tensor(bst.predict(X[:m], num_iteration=it))
                losses.append([mm(lab, p_it) for mm in mlog])
            print(f"{tag} (multi_logloss, multi_error) on 1M rows by "
                  f"iteration: {losses} (ln 5 = {np.log(5):.6f}); model "
                  "text round trip: [1M, 5] predictions identical")
            ll = [v[0] for v in losses]
            if not (ll[0] < np.log(5) and all(
                    b_ < a_ for a_, b_ in zip(ll, ll[1:]))):
                fail(f"{tag}: multi_logloss {ll} not below ln 5 and "
                     "falling")
            # the softmax gradients of one iteration, alone
            slice_ms["softmax_gradients_ms"] = time_ms(
                lambda: gb.objective.get_gradients(gb.train_score))
        count_launches(tag, "unfused", boosters, 0)
        print(f"{tag} softmax + gradients at [{N}, 5] (CUDA events): "
              f"{slice_ms['softmax_gradients_ms']:.4f} ms")

    def weighted_path() -> None:
        """(h): row weights from RandomState(2).uniform(0.5, 2.0) at
        max_bin=63: a binary model for 3 iterations (weighted auc) and a
        quantile (alpha 0.9) model on the L2 target for 2, whose leaves are
        renewed from the weighted 0.9-percentile of their residuals."""
        ds63, ds63_reg = dataset(63)
        tag = "[weighted, max_bin=63]"
        hk.reset_launches()
        boosters = []
        wt = torch.as_tensor(w_rows[:m])
        for objective, label, ref_ds, iters in (
                ("binary", y, ds63, 3), ("quantile", y_reg, ds63_reg, 2)):
            params = {"objective": objective, "alpha": 0.9, "num_leaves": L,
                      "max_bin": 63, "learning_rate": 0.1,
                      "min_data_in_leaf": 20, "verbosity": -1}
            dsw = lt.Dataset(X, label=label, weight=w_rows,
                             reference=ref_ds)
            dsw.construct()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bst = lt.train(params, dsw, num_boost_round=iters)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            boosters.append(bst)
            gb = bst._gbdt
            print(f"{tag} {objective}: {sec:.3f} s for {iters} iterations "
                  f"({sec / iters:.3f} s/iter), level passes a tree "
                  f"{gb.hist_passes}")
            if gb.gp.fused_obj is not None or gb.gp.const_hess \
                    or not gb.gp.quant:
                fail(f"{tag} {objective}: weights must take the unfused "
                     "front with all three channels")
            fname = os.path.join(OUT_DIR, f"chip_smoke_model_w_{objective}"
                                 ".txt")
            bst.save_model(fname)
            loaded = lt.Booster(model_file=fname)
            pred = bst.predict(X[:m])
            if not np.isfinite(pred).all() or not np.array_equal(
                    loaded.predict(X[:m]), pred):
                fail(f"{tag} {objective}: predictions not finite, or the "
                     "saved model predicts differently")
            if objective == "binary":
                auc = float(metrics.auc(torch.as_tensor(y[:m]),
                                        torch.as_tensor(pred), wt))
                print(f"{tag} weighted train AUC on 1M rows: {auc:.6f}")
                if not auc > 0.7:
                    fail(f"{tag}: weighted train AUC {auc} <= 0.7")
                continue
            pinball = metrics.create_metrics(
                ["quantile"], lt.Config({"alpha": 0.9}))[0]
            lab = torch.as_tensor(y_reg[:m])
            init = gb.init_scores[0]
            before = pinball(lab, torch.full_like(lab, init), wt)
            after = pinball(lab, torch.as_tensor(pred), wt)
            print(f"{tag} quantile: weighted pinball loss on 1M rows "
                  f"{after:.6f}, at the init score {init:.6f}: {before:.6f}"
                  "; model text round trip: predictions identical")
            if not after < before:
                fail(f"{tag}: the quantile model's pinball loss {after} is "
                     f"not below its init score's {before}")
            # the renewal of the last tree: the stable sort of 10.5M f32
            # keys, the f64 cumulative weights and the per-leaf pick
            from lightgbm_tpu_torch.ops.predict import route_bins
            leaf = route_bins(gb.models_dev[-1], dsw.bins,
                              dsw.na_bin_dev).to(torch.int32)
            slice_ms["leaf_renewal_ms"] = time_ms(
                lambda: gb.objective.renew_leaf_values(gb.train_score, leaf,
                                                       L))
            print(f"{tag} leaf renewal at N = {N}, L = {L} (CUDA events): "
                  f"{slice_ms['leaf_renewal_ms']:.4f} ms")
        count_launches(tag, "weighted", boosters, 0)

    # ---- 4d. (i) ranking and (j) the other boosters, through the entry
    # points ----
    def ranking_path() -> None:
        """(i): synth_ranking's Yahoo-LTR-shaped set, the whole queries in
        the first N_RANK rows for training and the next ones, about
        N_RANK_VALID rows, as the valid set, at max_bin=63 (B = 64, F * B
        = 44,800: the unfused front): lambdarank for 3 iterations, then
        rank_xendcg for 2 on the same Dataset, each with the valid set."""
        t0 = time.perf_counter()
        (Xt, yt, gt), (Xq, yq, gq) = split_queries(
            *synth_ranking(N_RANK + N_RANK_VALID, F_RANK), N_RANK)
        data_s = time.perf_counter() - t0
        params = {"objective": "lambdarank", "num_leaves": L, "max_bin": 63,
                  "learning_rate": 0.1, "min_data_in_leaf": 20,
                  "verbosity": -1, "metric": "ndcg", "eval_at": [10]}
        t0 = time.perf_counter()
        ds = lt.Dataset(Xt, label=yt, group=gt, params=params)
        ds.construct()
        vs = lt.Dataset(Xq, label=yq, group=gq, reference=ds)
        vs.construct()
        torch.cuda.synchronize()
        tag = "[ranking, max_bin=63]"
        construct_s = time.perf_counter() - t0
        print(f"{tag} data {data_s:.3f} s, construct {construct_s:.3f} s: "
              f"train {len(yt)} rows in {len(gt)} queries (longest "
              f"{int(gt.max())}), valid {len(yq)} rows in {len(gq)} queries; "
              f"{ds.num_features} used features, max bins {ds.max_num_bins}")
        const = float(metrics.ndcg(yq, np.zeros(len(yq), np.float32), None,
                                   gq, 10))
        hk.reset_launches()
        boosters, ndcg_of = [], {}
        for objective, iters in (("lambdarank", 3), ("rank_xendcg", 2)):
            evals = {}
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bst = lt.train(dict(params, objective=objective), ds,
                           num_boost_round=iters, valid_sets=[vs],
                           valid_names=["valid"], evals_result=evals,
                           verbose_eval=False)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            boosters.append(bst)
            gb = bst._gbdt
            ndcg = ndcg_of[objective] = evals["valid"]["ndcg@10"]
            print(f"{tag} {objective}: {sec:.3f} s for {iters} iterations "
                  f"({sec / iters:.3f} s/iter), level passes a tree "
                  f"{gb.hist_passes}; valid ndcg@10 by iteration {ndcg} "
                  f"(constant score: {const:.6f}); peak device memory {peak} "
                  f"bytes ({peak / 2 ** 30:.3f} GiB)")
            if gb.gp.fused_obj is not None or not gb.gp.quant \
                    or gb.gp.const_hess:
                fail(f"{tag} {objective}: not the quantized unfused front "
                     "with three channels")
            if not ndcg[-1] > const:
                fail(f"{tag} {objective}: valid ndcg@10 {ndcg[-1]} not above "
                     f"the constant score's {const}")
            t_grad = time_ms(lambda: gb.objective.get_gradients(
                gb.train_score))
            slice_ms[f"{objective}_gradients_ms"] = t_grad
            share = t_grad / (sec / iters * 1e3)
            print(f"{tag} {objective} gradients at {len(yt)} rows (CUDA "
                  f"events): {t_grad:.4f} ms, {100 * share:.2f}% of the "
                  "s/iteration")
            fname = os.path.join(OUT_DIR, f"chip_smoke_model_{objective}.txt")
            bst.save_model(fname)
            pred = bst.predict(Xq)
            if not np.isfinite(pred).all() or not np.array_equal(
                    lt.Booster(model_file=fname).predict(Xq), pred):
                fail(f"{tag} {objective}: predictions not finite, or the "
                     "saved model predicts differently")
            print(f"{tag} {objective}: model text round trip: valid "
                  "predictions identical")
        count_launches(tag, "unfused", boosters, 1)
        rank = dict(ds=ds, vs=vs, const=const, params=params,
                    ndcg=ndcg_of["lambdarank"],
                    trees=boosters[0]._host_trees())
        for bst in boosters:
            obj = bst._gbdt.objective
            parts = iteration_parts(bst, {"gradients": lambda: (
                obj.get_gradients(bst._gbdt.train_score))})
            print(f"{tag} {obj.name} one iteration by part (torch.profiler;"
                  f" \"gradients\" is the pair grid or the softmax): "
                  f"{json.dumps(parts)}")
        return rank

    def lean_paths(rank) -> None:
        """(n) and (n'): (i)'s ranking Dataset and valid set with
        histogram_pool_size=32, lambdarank: the lean depthwise grower
        (feature tiles of width 32 MiB // (254 * 3 * 64 * 4 B) = 172, the
        second to fifth at column offsets 172, 344, 516 and 688),
        quantized for 3 iterations (n), then unquantized for 2 (n')."""
        from lightgbm_tpu_torch.ops.grow_depthwise import (
            grow_tree_depthwise, grow_tree_depthwise_lean, lean_tiles)
        ds, vs = rank["ds"], rank["vs"]
        budget = 32 << 20
        for path, extra, iters in (("n", {}, 3),
                                   ("n'", {"use_quantized_grad": False}, 2)):
            tag = f"[lean ({path}), max_bin=63]"
            params = dict(rank["params"], histogram_pool_size=32, **extra)
            evals = {}
            hk.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bst = lt.train(params, ds, num_boost_round=iters,
                           valid_sets=[vs], valid_names=["valid"],
                           evals_result=evals, verbose_eval=False)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            gb = bst._gbdt
            gp = gb.gp
            tiles = lean_tiles(ds.num_features, gp.lean_ft)
            live = 2 * (L // 2) * 3 * gp.lean_ft * B * 4
            ndcg = evals["valid"]["ndcg@10"]
            print(f"{tag} {sec:.3f} s for {iters} iterations "
                  f"({sec / iters:.3f} s/iter); lean_ft {gp.lean_ft} of "
                  f"{ds.num_features} used features, tiles {tiles}, live "
                  f"tile histogram {live} B (budget {budget} B); level "
                  f"passes a tree {gb.hist_passes}; valid ndcg@10 {ndcg} "
                  f"((i)'s {rank['ndcg'][:iters]}, constant "
                  f"{rank['const']:.6f})")
            if gp.lean_ft <= 0 or gp.fused_obj is not None \
                    or gp.quant != (path == "n") or live > budget:
                fail(f"{tag}: not the lean grower within the budget "
                     f"(lean_ft {gp.lean_ft}, quant {gp.quant})")
            trees, n_pass = len(gb.hist_passes), sum(gb.hist_passes)
            hist = "hist_q8" if gp.quant else "hist_f32"
            expected = {k: 0 for k in hk.KERNELS}
            expected.update({hist: len(tiles) * (trees + n_pass),
                             "route_level": n_pass,
                             "leaf_sums": trees * (2 if gp.quant else 1),
                             "take_small": 2 * bst.num_trees(),
                             "split_search": len(tiles) * (trees + n_pass)})
            launches = dict(hk.LAUNCHES)
            print(f"{tag} launches {launches} expected {expected}")
            if launches != expected or trees != bst.num_trees():
                fail(f"{tag}: launch counts {launches} != expected "
                     f"{expected}")
            for k, v in launches.items():
                launches_all[k] += v
            # (n) is held to (i)'s quantized default grower; (n') only
            # above the constant score
            if not ndcg[-1] > rank["const"] or (path == "n" and any(
                    abs(a - b) > 0.01 for a, b in zip(ndcg, rank["ndcg"]))):
                fail(f"{tag}: valid ndcg@10 {ndcg} not within 0.01 of (i)'s "
                     f"{rank['ndcg']} or not above the constant score's")
            same = sum(all(np.array_equal(getattr(a, f_), getattr(b, f_))
                           for f_ in ("split_feature", "threshold_bin",
                                      "left_child", "right_child"))
                       for a, b in zip(bst._host_trees(), rank["trees"]))
            print(f"{tag} trees with the default grower's structure ((i)'s "
                  f"lambdarank): {same} of {bst.num_trees()}")
            if path != "n":
                continue
            obj = gb.objective
            parts = iteration_parts(bst, {"gradients": lambda: (
                obj.get_gradients(gb.train_score))})
            print(f"{tag} one iteration by part (torch.profiler): "
                  f"{json.dumps(parts)}")
            # one tree's growth on the same gradients, the default grower
            # against the lean one: peak device memory above what was
            # allocated before, and the time
            g_, h_ = gb.objective.get_gradients(gb.train_score)
            rows = (g_, h_, torch.ones_like(g_))
            growers = {
                "default": lambda: grow_tree_depthwise(
                    ds.bins_T, *rows, ds.num_bins_dev, ds.na_bin_dev,
                    gb._fmask, dataclasses.replace(gp, lean_ft=0), qseed=0,
                    bins=ds.bins),
                "lean": lambda: grow_tree_depthwise_lean(
                    ds.bins_T, *rows, ds.num_bins_dev, ds.na_bin_dev,
                    gb._fmask, gp, qseed=0, bins=ds.bins)}
            peak, grow_s = {}, {}
            for nm, fn in growers.items():
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                grow_s[nm] = time.perf_counter() - t0
                peak[nm] = torch.cuda.max_memory_allocated() - base
            print(f"{tag} one tree's growth on the same gradients: peak "
                  f"device memory above the resident {peak} bytes, seconds "
                  f"{grow_s}")
            slice_ms["lean_tree_s"] = grow_s["lean"]
            slice_ms["default_tree_s"] = grow_s["default"]
            if not peak["lean"] < peak["default"]:
                fail(f"{tag}: the lean grower's peak memory {peak['lean']} "
                     f"is not below the default grower's {peak['default']}")

    def boosters_path() -> None:
        """(j): on (a)'s max_bin=63 Dataset, binary: DART (defaults, 6
        iterations), RF (bagging 0.8 every iteration, feature_fraction
        0.8, 3), a 2-iteration model continued for 2 from its file with
        the 500,000-row valid set, the same continuation through an init
        score, and a refit of the 2-iteration model on 1M rows."""
        ds, _ = dataset(63)
        base = {"objective": "binary", "num_leaves": L, "max_bin": 63,
                "learning_rate": 0.1, "min_data_in_leaf": 20,
                "verbosity": -1}
        tag = "[dart, max_bin=63]"
        hk.reset_launches()
        bst = lt.Booster(params=dict(base, boosting="dart"), train_set=ds)
        drops = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(6):
            bst.update()
            drops.append(list(bst._gbdt.drop_idx))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        gb = bst._gbdt
        print(f"{tag} {sec:.3f} s for 6 iterations ({sec / 6:.3f} s/iter), "
              f"drop lists {drops}, tree weights {gb.tree_weights}")
        # a drop takes its tree out of the score and puts it back scaled;
        # the new tree leaves and re-enters scaled: one take_small each
        extra = sum(2 * len(d) + 2 for d in drops if d)
        launches = dict(hk.LAUNCHES)
        expected, own = expected_launches("fused", len(gb.hist_passes),
                                          sum(gb.hist_passes),
                                          bst.num_trees() + extra,
                                          split_searches(bst))
        print(f"{tag} launches {launches} expected {expected}")
        if launches != expected or min(launches[k] for k in own) <= 0:
            fail(f"{tag}: launch counts {launches} != expected {expected}")
        for k, v in launches.items():
            launches_all[k] += v
        fname = os.path.join(OUT_DIR, "chip_smoke_model_dart.txt")
        bst.save_model(fname)
        got = lt.Booster(model_file=fname).predict(X[:m], raw_score=True)
        want = gb.train_score[:m].cpu().numpy()
        diff = float(np.abs(got - want).max())
        print(f"{tag} saved model's raw prediction vs the train score on 1M"
              f" rows: max diff {diff:.3e} (largest {np.abs(want).max():.3e})")
        if not diff <= 1e-5 * np.abs(want).max():
            fail(f"{tag}: the rescaled trees and the train score disagree")
        check_auc(tag, bst)
        from lightgbm_tpu_torch.models.gbdt import tree_delta
        tree0 = gb.models_dev[0]
        replay = device_ms(lambda: tree_delta(tree0, ds))
        slice_ms["dart_tree_replay_ms"] = time_ms(lambda: tree_delta(tree0,
                                                                     ds))
        print(f"{tag} one tree's replay (route_bins + take_small, {N} rows):"
              f" {slice_ms['dart_tree_replay_ms']:.4f} ms (CUDA events), "
              f"device {replay}; 2 d + 2 replays an iteration of d drops; "
              f"one iteration by part: {json.dumps(iteration_parts(bst))}")

        tag = "[rf, max_bin=63]"
        hk.reset_launches()
        t0 = time.perf_counter()
        bst = lt.train(dict(base, **RF), ds, num_boost_round=3)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        print(f"{tag} {sec:.3f} s for 3 iterations ({sec / 3:.3f} s/iter), "
              f"level passes a tree {bst._gbdt.hist_passes}, in-bag share "
              f"{float(bst._gbdt._bag.mean()):.6f}")
        # constant gradients handed to the step: the weighted path's front
        count_launches(tag, "weighted", [bst], 0)
        check_auc(tag, bst)
        fname = os.path.join(OUT_DIR, "chip_smoke_model_rf.txt")
        bst.save_model(fname)
        with open(fname) as fh:
            if "\naverage_output\n" not in fh.read().split("\nTree=")[0]:
                fail(f"{tag}: no average_output line in the model text")
        if not np.array_equal(lt.Booster(model_file=fname).predict(X[:m]),
                              bst.predict(X[:m])):
            fail(f"{tag}: saved and loaded model predict differently")
        print(f"{tag} model text: average_output, round trip identical")
        rf_gb = bst._gbdt
        print(f"{tag} one iteration by part: " + json.dumps(iteration_parts(
            bst, {"bag draw": lambda: rf_gb._update_bag(0, None, None)})))

        tag = "[init_model, max_bin=63]"
        valid = lt.Dataset(Xv, label=yv, reference=ds)
        valid.construct()
        hk.reset_launches()
        first = lt.train(base, ds, num_boost_round=2)
        fname = os.path.join(OUT_DIR, "chip_smoke_model_first.txt")
        first.save_model(fname)
        seen = {}

        def at_start(env):
            if env.iteration == env.begin_iteration:
                g_ = env.model._gbdt
                seen["train"] = g_.train_score.cpu().numpy().copy()
                seen["valid"] = g_.valid_scores[0].cpu().numpy().copy()
        at_start.before_iteration = True
        t0 = time.perf_counter()
        cont = lt.train(base, ds, num_boost_round=2, init_model=fname,
                        valid_sets=[valid], callbacks=[at_start],
                        verbose_eval=False)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        old = lt.Booster(model_file=fname)
        # take_small: the first model's 2 trees, their replay on the train
        # and the valid bins (2 each), the continued trees on both
        launches = dict(hk.LAUNCHES)
        passes = first._gbdt.hist_passes + cont._gbdt.hist_passes
        expected, own = expected_launches(
            "fused", len(passes), sum(passes),
            first.num_trees() + 2 * old.num_trees() + 2 * cont.num_trees(),
            split_searches(first, cont))
        print(f"{tag} continued 2 iterations in {sec:.3f} s; launches "
              f"{launches} expected {expected}")
        if launches != expected or min(launches[k] for k in own) <= 0:
            fail(f"{tag}: launch counts {launches} != expected {expected}")
        for k, v in launches.items():
            launches_all[k] += v
        vold = old.predict(Xv, raw_score=True)
        vdiff = float(np.abs(seen["valid"] - vold).max())
        tsum = old.predict(X[:m], raw_score=True) \
            + cont.predict(X[:m], raw_score=True)
        tscore = cont._gbdt.train_score[:m].cpu().numpy()
        tdiff = float(np.abs(tsum - tscore).max())
        print(f"{tag} valid score after the replay vs the first model's raw "
              f"prediction: max diff {vdiff:.3e} (largest "
              f"{np.abs(vold).max():.3e}); first + continued predictions vs "
              f"the train score on 1M rows: max diff {tdiff:.3e}")
        if not vdiff <= 1e-6 * np.abs(vold).max():
            fail(f"{tag}: the valid set's replay of the init model disagrees")
        if not tdiff <= 1e-5 * np.abs(tscore).max():
            fail(f"{tag}: the continued model is not the old trees plus the "
                 "new ones")

        tag = "[init_score, max_bin=63]"
        raw = old.predict(X, raw_score=True)
        d_is = lt.Dataset(X, label=y, init_score=raw, reference=ds)
        d_is.construct()
        moved = int((d_is.init_score.cpu().numpy() != seen["train"]).sum())
        print(f"{tag} the f32 init score differs from the warm start's "
              f"score in {moved} rows")
        hk.reset_launches()
        b_is = lt.train(base, d_is, num_boost_round=2)
        count_launches(tag, "fused", [b_is], 0)
        a_, b_ = cont._host_trees()[0], b_is._host_trees()[0]
        for f_ in ("split_feature", "threshold_bin", "default_left",
                   "left_child", "right_child"):
            if not np.array_equal(getattr(a_, f_), getattr(b_, f_)):
                fail(f"{tag}: the first new tree differs from the init_model"
                     f" run's in {f_}")
        print(f"{tag} first new tree ({b_.num_leaves} leaves) has the "
              "init_model run's structure")
        del d_is, raw

        tag = "[refit, max_bin=63]"
        hk.reset_launches()
        t0 = time.perf_counter()
        ref_b = first.refit(X[:m], y[:m], decay_rate=0.9)
        sec = time.perf_counter() - t0
        if any(hk.LAUNCHES.values()):
            fail(f"{tag}: refit launched kernels {dict(hk.LAUNCHES)}")
        if not all(np.isfinite(t.leaf_value).all()
                   for t in ref_b._host_trees()):
            fail(f"{tag}: non-finite leaf values")
        auc = float(metrics.auc(torch.as_tensor(y[:m]),
                                torch.as_tensor(ref_b.predict(X[:m]))))
        print(f"{tag} refit on 1M rows in {sec:.3f} s (no kernel: leaves by "
              f"the raw-feature walk, sums on the host); leaf values finite; "
              f"AUC on those rows {auc:.6f}")

    def categorical_path() -> None:
        """(k) "categorical": the airline data (synth_airline, 10M rows,
        six categorical columns of eight) at max_bin=255, binary with a
        100,000-row valid set of another seed (unseen categories and NaN)
        for 5 iterations on the fused front, with categorical membership
        in B2; (k') the same Dataset unquantized for 3 (B8 and B6, with
        membership in B6). For information: the AUC of the same 5
        iterations with the six columns numerical."""
        t0 = time.perf_counter()
        Xa, ya, lat = synth_airline(N_AIR, seed=0, latent=True)
        Xav, yav = airline_valid(N_AIR_VALID)
        print(f"[categorical] data: {time.perf_counter() - t0:.3f} s "
              f"({N_AIR} x {Xa.shape[1]}, positive share {ya.mean():.4f})")
        params = {"objective": "binary", "num_leaves": L, "max_bin": 255,
                  "learning_rate": 0.1, "min_data_in_leaf": 20,
                  "verbosity": -1, "metric": "auc"}
        sets = {}
        for kind, cats in (("categorical", AIRLINE_CATS), ("numerical", [])):
            t0 = time.perf_counter()
            ds = lt.Dataset(Xa, label=ya, categorical_feature=cats,
                            params={"max_bin": 255, "verbosity": -1})
            ds.construct()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            valid = lt.Dataset(Xav, label=yav, reference=ds)
            valid.construct()
            slice_ms[f"airline_{kind}_construct_s"] = sec
            print(f"[categorical] {kind} Dataset construct: {sec:.3f} s "
                  f"(max bins {ds.max_num_bins}, categorical columns "
                  f"{sum(m.bin_type == 1 for m in ds.mappers)})")
            sets[kind] = (ds, valid)
        ds, valid = sets["categorical"]
        # the reference's fused-front gate (models/gbdt.py _fused_front):
        # one model an iteration of a fused objective on the quantized
        # depthwise grower with an F * B root histogram of at most 2048
        # cells; categorical features do not enter it
        fb = ds.num_features * padded_bins(ds.max_num_bins)
        print(f"[categorical] F * B = {fb}: "
              f"{'fused' if fb <= ACC_ROWS_MAX else 'unfused'} front")
        if fb > ACC_ROWS_MAX:
            fail(f"[categorical]: F * B = {fb} > {ACC_ROWS_MAX}")

        tag = "[categorical, max_bin=255]"
        hk.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        evals = {}
        t0 = time.perf_counter()
        bst = lt.train(params, ds, num_boost_round=5, valid_sets=[valid],
                       evals_result=evals, verbose_eval=False)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        print(f"{tag} train: {sec:.3f} s for 5 iterations ({sec / 5:.3f} "
              f"s/iter), level passes a tree {bst._gbdt.hist_passes}; peak "
              f"device memory {torch.cuda.max_memory_allocated()} bytes")
        count_launches(tag, "fused", [bst], 1)
        if bst._gbdt.gp.fused_obj is None:
            fail(f"{tag}: the booster did not take the fused front")
        auc_v = evals["valid_0"]["auc"]
        print(f"{tag} valid AUC by iteration: {auc_v}")
        if not auc_v[-1] > 0.7:
            fail(f"{tag}: valid AUC {auc_v[-1]} <= 0.7")
        trees = bst._host_trees()
        n_cat = [int(t.is_cat_node.sum()) for t in trees]
        print(f"{tag} categorical nodes a tree: {n_cat} of "
              f"{[t.num_leaves - 1 for t in trees]}")
        if not n_cat[0]:
            fail(f"{tag}: no categorical node in the first tree")
        fname = os.path.join(OUT_DIR, "chip_smoke_model_categorical.txt")
        bst.save_model(fname)
        loaded = lt.Booster(model_file=fname)

        def cat_lines(text):
            return [ln for ln in text.splitlines()
                    if ln.startswith(("cat_threshold=", "cat_boundaries="))]
        if not cat_lines(bst.model_to_string()) or cat_lines(
                loaded.model_to_string()) != cat_lines(bst.model_to_string()):
            fail(f"{tag}: the loaded model's cat_threshold differs")
        if not np.array_equal(loaded.predict(Xav, raw_score=True),
                              bst.predict(Xav, raw_score=True)):
            fail(f"{tag}: saved and loaded model predict differently")
        raw = bst.predict(Xa[:m], raw_score=True)
        tscore = bst._gbdt.train_score[:m].cpu().numpy()
        vscore = bst._gbdt.valid_scores[0].cpu().numpy()
        tdiff = float(np.abs(raw - tscore).max())
        vdiff = float(np.abs(bst.predict(Xav, raw_score=True)
                             - vscore).max())
        print(f"{tag} model text round trip: cat_threshold and predictions "
              f"identical; raw-value predictions vs the train score on 1M "
              f"rows: max diff {tdiff:.3e}, vs the valid score: {vdiff:.3e} "
              f"(largest {np.abs(tscore).max():.3e})")
        if max(tdiff, vdiff) > 1e-5 * max(1.0, np.abs(tscore).max()):
            fail(f"{tag}: predictions from raw values disagree with the "
                 "training scores")
        print(f"{tag} one iteration by part: " + json.dumps(
            iteration_parts(bst)))

        tag = "[categorical unquantized, max_bin=255]"
        hk.reset_launches()
        t0 = time.perf_counter()
        b32 = lt.train(dict(params, use_quantized_grad="false"), ds,
                       num_boost_round=3)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        print(f"{tag} train: {sec:.3f} s for 3 iterations ({sec / 3:.3f} "
              f"s/iter), level passes a tree {b32._gbdt.hist_passes}")
        count_launches(tag, "f32", [b32], 0)
        auc32 = float(metrics.auc(torch.as_tensor(yav),
                                  torch.as_tensor(b32.predict(Xav))))
        n_cat = [int(t.is_cat_node.sum()) for t in b32._host_trees()]
        print(f"{tag} valid AUC {auc32:.6f}; categorical nodes a tree "
              f"{n_cat}")
        if not (auc32 > 0.7 and n_cat[0]):
            fail(f"{tag}: valid AUC {auc32} or no categorical node")
        print(f"{tag} one iteration by part: " + json.dumps(
            iteration_parts(b32)))

        tag = "[airline as numerical, max_bin=255]"
        ds_n, valid_n = sets["numerical"]
        hk.reset_launches()
        ev_n = {}
        bn = lt.train(params, ds_n, num_boost_round=5, valid_sets=[valid_n],
                      evals_result=ev_n, verbose_eval=False)
        count_launches(tag, "fused" if bn._gbdt.gp.fused_obj is not None
                       else "unfused", [bn], 1)
        print(f"{tag} (information) valid AUC by iteration: "
              f"{ev_n['valid_0']['auc']}, against {auc_v} with the six "
              "columns categorical")
        print(f"{tag} one iteration by part: " + json.dumps(
            iteration_parts(bn)))
        airline_small.update(X=Xa[:4000], latent=lat[:4000])
        airline.update(X=Xa, y=ya, Xv=Xav, yv=yav)

    def bundled_path() -> None:
        """(l) "bundled": (k)'s airline rows one-hot encoded
        (airline_onehot: a 10M x 674 CSR matrix, 8 stored values a row)
        at max_bin=255 with the default enable_bundle, binary with the
        100,000-row valid set in the train's column layout for 5
        iterations; the front follows from the bundled width F_b * B, as
        the reference's gate says; (l') the same Dataset with
        grow_policy=lossguide for 3, without a valid set."""
        t0 = time.perf_counter()
        csr = airline_onehot(airline["X"])
        vcsr = airline_onehot(airline["Xv"])
        ya, yav = airline["y"], airline["yv"]
        airline.clear()
        print(f"[bundled] data: {time.perf_counter() - t0:.3f} s "
              f"(CSR {csr.shape[0]} x {csr.shape[1]}, {csr.nnz} stored "
              f"values, {csr.nnz / csr.shape[0]:.3f} a row)")
        params = {"objective": "binary", "num_leaves": L, "max_bin": 255,
                  "learning_rate": 0.1, "min_data_in_leaf": 20,
                  "verbosity": -1, "metric": "auc"}
        t0 = time.perf_counter()
        ds = lt.Dataset(csr, label=ya, params={"max_bin": 255,
                                               "verbosity": -1})
        _, rss0, rss = peak_rss(ds.construct)
        sec = time.perf_counter() - t0
        valid = lt.Dataset(vcsr, label=yav, reference=ds)
        valid.construct()
        slice_ms["bundled_construct_s"] = sec
        meta = ds.bundle_meta
        fb = ds.num_features
        if meta is None or not meta.is_bundle.any() or fb >= csr.shape[1]:
            fail(f"[bundled]: no bundle ({fb} columns of {csr.shape[1]})")
        sizes = [len(mem) for mem in meta.members if len(mem) > 1]
        print(f"[bundled] construct: {sec:.3f} s by phase "
              f"{json.dumps(ds.construct_phases)}; {len(ds.mappers)} used "
              f"features in F_b = {fb} columns ({len(sizes)} bundles of "
              f"{sizes} members, max bins {ds.max_num_bins}); host RSS "
              f"{rss0} bytes before construct, peak {rss} in it (+"
              f"{(rss - rss0) / 2 ** 30:.3f} GiB); bins on "
              f"the card {ds.bins.numel()} bytes against {csr.shape[0]} x "
              f"{csr.shape[1]} = {csr.shape[0] * csr.shape[1]} unbundled")
        # the reference's fused-front gate on the bundled width
        front = ("fused" if fb * padded_bins(ds.max_num_bins) <= ACC_ROWS_MAX
                 else "unfused")
        print(f"[bundled] F_b * B = {fb * padded_bins(ds.max_num_bins)}: "
              f"{front} front")

        tag = "[bundled, max_bin=255]"
        hk.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        evals = {}
        t0 = time.perf_counter()
        bst = lt.train(params, ds, num_boost_round=5, valid_sets=[valid],
                       evals_result=evals, verbose_eval=False)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        print(f"{tag} train: {sec:.3f} s for 5 iterations ({sec / 5:.3f} "
              f"s/iter), level passes a tree {bst._gbdt.hist_passes}; peak "
              f"device memory {torch.cuda.max_memory_allocated()} bytes")
        count_launches(tag, front, [bst], 1)
        auc_v = evals["valid_0"]["auc"]
        pv = bst.predict(vcsr, raw_score=True)
        auc_p = float(metrics.auc(torch.as_tensor(yav), torch.as_tensor(pv)))
        print(f"{tag} valid AUC by iteration (recorded): {auc_v}; AUC of "
              f"Booster.predict on the sparse valid rows: {auc_p:.7f}")
        if abs(auc_v[-1] - auc_p) > 1e-4 or not auc_v[-1] > 0.7:
            fail(f"{tag}: recorded valid AUC {auc_v[-1]} against the "
                 f"predictions' {auc_p}, or not above 0.7")
        first = bst._gbdt.models_dev[0]
        nodes = first.num_leaves - 1
        on_bundle = int((first.is_cat[:nodes] & torch.as_tensor(
            meta.is_bundle, device=dev)[first.split_feature[:nodes].long()])
            .sum())
        print(f"{tag} first tree: {on_bundle} of {nodes} nodes split a "
              "bundle column")
        if not on_bundle:
            fail(f"{tag}: no node of the first tree splits a bundle column")
        fname = os.path.join(OUT_DIR, "chip_smoke_model_bundled.txt")
        bst.save_model(fname)
        loaded = lt.Booster(model_file=fname)
        text = bst.model_to_string()
        names = [ln for ln in text.splitlines()
                 if ln.startswith("feature_names=")]
        if (loaded.model_to_string() != text
                or names != ["feature_names=" + " ".join(
                    f"Column_{j}" for j in range(csr.shape[1]))]
                or max(int(t.split_feature.max())
                       for t in loaded._host_trees()) >= csr.shape[1]
                or not np.array_equal(loaded.predict(vcsr, raw_score=True),
                                      pv)):
            fail(f"{tag}: the model text does not round-trip, or names "
                 "other than the original features")
        m_ = 200_000
        raw = bst.predict(csr[:m_], raw_score=True)
        tscore = bst._gbdt.train_score[:m_].cpu().numpy()
        vscore = bst._gbdt.valid_scores[0].cpu().numpy()
        tdiff = float(np.abs(raw - tscore).max())
        vdiff = float(np.abs(pv - vscore).max())
        print(f"{tag} model text round trip identical, original features "
              f"only; raw-value predictions vs the train score on {m_} rows:"
              f" max diff {tdiff:.3e}, vs the valid score: {vdiff:.3e} "
              f"(largest {np.abs(tscore).max():.3e})")
        if max(tdiff, vdiff) > 1e-5 * max(1.0, np.abs(tscore).max()):
            fail(f"{tag}: predictions from raw values disagree with the "
                 "training scores")
        print(f"{tag} one iteration by part: " + json.dumps(
            iteration_parts(bst)))

        tag = "[bundled lossguide, max_bin=255]"
        hk.reset_launches()
        t0 = time.perf_counter()
        blg = lt.train(dict(params, grow_policy="lossguide"), ds,
                       num_boost_round=3)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        print(f"{tag} train: {sec:.3f} s for 3 iterations ({sec / 3:.3f} "
              f"s/iter), splits a tree {blg._gbdt.hist_passes}")
        count_launches(tag, "lossguide", [blg], 0)
        auc_lg = float(metrics.auc(torch.as_tensor(yav), torch.as_tensor(
            blg.predict(vcsr))))
        print(f"{tag} valid AUC of its predictions {auc_lg:.6f}")
        if not auc_lg > 0.7:
            fail(f"{tag}: valid AUC {auc_lg} <= 0.7")

    def constrained_path() -> None:
        """(m) "constrained": on (a)'s Dataset, binary 5 iterations with
        monotone constraints (the signs of the generator's weights on
        features 0-7), feature_contri 0.5 on the noise features 11-27 and
        extra_trees (the fused front); (m') on its own Dataset with forced
        bins (feature 0 at [-1, 0, 1], feature 1 at [0]), 5 iterations
        with forced splits (the root on feature 0 at 0.0, its left child on
        feature 1 at 0.0) and CEGB (CONSTRAINED_CEGB; the unfused front);
        (m'') lossguide 2 iterations on (a)'s Dataset with (m)'s monotone
        constraints and extra_trees and (m')'s forced splits. Gates: the
        launch contracts, the monotone sweep exact on (m) and (m''), every
        (m') tree forced and none on features 20-27, AUC on 1M rows above
        0.7; (a)'s sweep violations and AUC printed beside."""
        from lightgbm_tpu_torch.ops.grow import RowShard, ShardedRows
        from lightgbm_tpu_torch.ops.grow_depthwise import cegb_penalty
        ds, _ = dataset(63)
        base = {"objective": "binary", "num_leaves": L, "max_bin": 63,
                "learning_rate": 0.1, "min_data_in_leaf": 20,
                "verbosity": -1}
        forced, fbins = constrained_files()
        mono = constrained_params(w_gen)
        tag = "[constrained (m), max_bin=63]"
        hk.reset_launches()
        t0 = time.perf_counter()
        bm = lt.train(dict(base, **mono), ds, num_boost_round=5)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        slice_ms["constrained_s_per_iter"] = sec / 5
        print(f"{tag} train: {sec:.3f} s for 5 iterations ({sec / 5:.4f} "
              f"s/iter), level passes a tree {bm._gbdt.hist_passes}")
        count_launches(tag, "fused", [bm], 0)

        tag2 = "[constrained (m''), lossguide, max_bin=63]"
        hk.reset_launches()
        t0 = time.perf_counter()
        blg = lt.train(dict(base, grow_policy="lossguide",
                            monotone_constraints=lossguide_monotone(mono),
                            extra_trees=True, forcedsplits_filename=forced),
                       ds, num_boost_round=2)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        print(f"{tag2} train: {sec:.3f} s for 2 iterations ({sec / 2:.3f} "
              f"s/iter), splits a tree {blg._gbdt.hist_passes}")
        count_launches(tag2, "lossguide", [blg], 0)
        ba = lt.train(base, ds, num_boost_round=5)

        # the monotone sweep: 1,000 training rows, each constrained
        # feature over 32 values spanning its bin bounds, the others held
        rows0 = X[:1000].astype(np.float64)
        viol = {}
        for name_, b_, signs in (
                ("m", bm, mono["monotone_constraints"][:8]),
                ("m''", blg, lossguide_monotone(mono)[:8]),
                ("a", ba, mono["monotone_constraints"][:8])):
            n_bad = 0
            for j, sgn in enumerate(signs):
                if not sgn:
                    continue
                ub = ds.mappers[j].upper_bounds[:-1]
                vals = np.linspace(ub.min() - 0.1, ub.max() + 0.1, 32)
                rows = np.repeat(rows0, 32, axis=0)
                rows[:, j] = np.tile(vals, len(rows0))
                pred = b_.predict(rows, raw_score=True).reshape(-1, 32)
                n_bad += int((sgn * np.diff(pred, axis=1) < 0).sum())
            viol[name_] = n_bad
        print(f"[constrained] monotone sweep (1,000 rows x the constrained "
              f"features x 32 values): violations {viol} ((a) "
              "unconstrained, on (m)'s features, for information)")
        if viol["m"] or viol["m''"]:
            fail(f"[constrained]: monotone sweep violated {viol}")

        tag3 = "[constrained (m'), forced + CEGB, max_bin=63]"
        t0 = time.perf_counter()
        dsf = lt.Dataset(X, label=y, params={"max_bin": 63, "verbosity": -1,
                                             "forcedbins_filename": fbins})
        dsf.construct()
        torch.cuda.synchronize()
        print(f"{tag3} construct: {time.perf_counter() - t0:.3f} s; "
              f"feature 0 bounds {dsf.mappers[0].upper_bounds.tolist()}, "
              f"feature 1 {dsf.mappers[1].upper_bounds.tolist()}")
        hk.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        bf = lt.train(dict(base, forcedsplits_filename=forced,
                           **CONSTRAINED_CEGB), dsf, num_boost_round=5)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        print(f"{tag3} train: {sec:.3f} s for 5 iterations ({sec / 5:.4f} "
              f"s/iter), level passes a tree {bf._gbdt.hist_passes}; peak "
              f"device memory {torch.cuda.max_memory_allocated()} bytes")
        count_launches(tag3, "weighted", [bf], 0)
        fname = os.path.join(OUT_DIR, "chip_smoke_model_forced.txt")
        bf.save_model(fname)
        loaded = lt.Booster(model_file=fname)
        if loaded.model_to_string() != bf.model_to_string():
            fail(f"{tag3}: the model text does not reload identically")
        trees = loaded._host_trees()
        for i, t in enumerate(trees):
            lc = int(t.left_child[0])
            if not (t.split_feature[0] == 0 and t.threshold_real[0] == 0.0
                    and lc >= 0 and t.split_feature[lc] == 1
                    and t.threshold_real[lc] == 0.0):
                fail(f"{tag3}: tree {i} is not forced at its root and left "
                     f"child ({t.split_feature[:3]}, {t.threshold_real[:3]})")
        used = np.concatenate([t.split_feature[:t.num_leaves - 1]
                               for t in trees])
        lazy_first = int(np.isin(trees[0].split_feature[
            :trees[0].num_leaves - 1], [8, 9, 10]).sum())
        print(f"{tag3} every tree forced at its root (feature 0 at 0.0) and "
              f"left child (feature 1 at 0.0); nodes on 20-27: "
              f"{int((used >= 20).sum())}; first tree nodes on the lazy "
              f"features 8-10: {lazy_first}; leaves a tree "
              f"{[t.num_leaves for t in trees]}")
        if (used >= 20).any():
            fail(f"{tag3}: a node splits a feature the coupled penalty "
                 "blocks")
        if not lazy_first:
            fail(f"{tag3}: the first tree has no node on the lazy features")
        aucs = {}
        for name_, b_ in (("m", bm), ("m'", bf), ("m''", blg), ("a", ba)):
            prob = b_.predict(X[:m])
            if prob.shape != (m,) or not np.isfinite(prob).all():
                fail(f"[constrained] {name_}: predictions are not finite "
                     "[1M] values")
            aucs[name_] = float(metrics.auc(torch.as_tensor(y[:m]),
                                            torch.as_tensor(prob)))
        print(f"[constrained] train AUC on 1M rows: {aucs} ((a) for "
              "information)")
        if not all(aucs[k] > 0.7 for k in ("m", "m'", "m''")):
            fail(f"[constrained]: AUC {aucs} not above 0.7")

        # the lazy CEGB plane of one level at full size, and the split
        # search's share of an iteration against (a)'s
        gb = bf._gbdt
        g_ = torch.Generator(device=dev).manual_seed(5)
        leaf_id = torch.randint(0, L, (N,), generator=g_, device=dev,
                                dtype=torch.int32)
        leaf_c = torch.bincount(leaf_id.long(), minlength=L).float()
        rows = ShardedRows([RowShard(gb.train_set.bins_T,
                                     c=torch.ones(N, device=dev),
                                     data_used=gb.cegb.data_used)])
        plane = time_ms(lambda: cegb_penalty(gb.gp.split, gb.cegb, leaf_c,
                                             rows, [leaf_id], gb.gp))
        lv = statistics.mean(gb.hist_passes) + 1
        slice_ms["cegb_lazy_plane_ms"] = plane
        print(f"{tag3} lazy CEGB plane ([N, 3] over the lazy columns, then "
              f"its index_add_ by leaf): {plane:.4f} ms a level, "
              f"{plane * lv:.3f} ms a tree ({lv:.1f} searches a tree); "
              f"data_used {gb.cegb.data_used.numel()} bytes")
        for name_, b_ in (("m", bm), ("a", ba)):
            parts = iteration_parts(b_)
            print(f"[constrained] ({name_}) one iteration by part: "
                  + json.dumps(parts))
            if parts is not None:
                slice_ms[f"split_search_other_ms_{name_}"] = \
                    parts["device_ms"].get("other")

    def api_path() -> None:
        """(o): the entry points of A15a on (a)'s data: LGBMClassifier on
        the numpy rows against train under the parameters it passes; cv on
        the first 1M rows (3 stratified folds, 3 rounds, AUC); a Dataset
        saved with save_binary and loaded with load_binary; a rollback to
        2 iterations against a 2-iteration run; a pickled Booster."""
        tag = "[api (o), max_bin=63]"
        hk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clf = lt.LGBMClassifier(n_estimators=3, num_leaves=L,
                                max_bin=63).fit(X, y)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        count_launches(f"{tag} LGBMClassifier", "fused", [clf.booster_], 0)
        params = clf._make_train_params()
        direct = lt.train(params, lt.Dataset(X, label=y, params=params), 3,
                          verbose_eval=False)
        same_text = clf.booster_.model_to_string() == \
            direct.model_to_string()
        proba = clf.predict_proba(X[:m])
        auc = float(metrics.auc(torch.as_tensor(y[:m]),
                                torch.as_tensor(proba[:, 1])))
        print(f"{tag} LGBMClassifier fit {fit_s:.3f} s (construct included)"
              f", classes {clf.classes_.tolist()}, model text equal to "
              f"train's: {same_text}, AUC on 1M rows {auc:.6f}")
        if not same_text or proba.shape != (m, 2) or not np.allclose(
                proba.sum(axis=1), 1.0) or not auc > 0.7:
            fail(f"{tag}: the estimator's model or predictions are wrong")

        m_cv = min(1_000_000, N)
        hk.reset_launches()
        cv_params = {"objective": "binary", "num_leaves": L, "max_bin": 63,
                     "verbosity": -1}
        t0 = time.perf_counter()
        res = lt.cv(cv_params, lt.Dataset(X[:m_cv], label=y[:m_cv],
                                          params=cv_params), 3, nfold=3,
                    metrics="auc", return_cvbooster=True)
        torch.cuda.synchronize()
        cv_s = time.perf_counter() - t0
        folds = res.pop("cvbooster")
        count_launches(f"{tag} cv", "fused", folds, 1)
        fold_auc = [b.eval_valid()[0][2] for b in folds]
        print(f"{tag} cv on {m_cv} rows: {cv_s:.3f} s, {res}, each fold's "
              f"valid AUC {fold_auc}")
        if len(folds) != 3 or not all(a > 0.7 for a in fold_auc) \
                or len(res["auc-mean"]) != 3:
            fail(f"{tag}: cv folds' AUC {fold_auc}")

        hk.reset_launches()
        ds, _ = dataset(63)
        p2 = {"objective": "binary", "num_leaves": L, "max_bin": 63,
              "verbosity": -1}
        sub = ds.subset(np.arange(m))
        fname = os.path.join(OUT_DIR, "chip_smoke_dataset.bin")
        sub.save_binary(fname)
        loaded = lt.Dataset.load_binary(fname)
        os.remove(fname)
        same_bin = lt.train(p2, sub, 2).model_to_string() == \
            lt.train(p2, loaded, 2).model_to_string()
        print(f"{tag} save_binary / load_binary of {m} rows: the same "
              f"2-iteration model text: {same_bin}")
        if not same_bin:
            fail(f"{tag}: the loaded Dataset trains another model")

        vs = lt.Dataset(Xv, label=yv, reference=ds)
        b3 = lt.train(p2, ds, 3, valid_sets=[vs])
        b3.rollback_one_iter()
        b2 = lt.train(p2, ds, 2, valid_sets=[vs])
        diffs = []
        for a_, b_ in ((b3._gbdt.train_score, b2._gbdt.train_score),
                       (b3._gbdt.valid_scores[0], b2._gbdt.valid_scores[0])):
            diffs.append(float((a_ - b_).abs().max()
                               / b_.abs().max().clamp(min=1e-30)))
        print(f"{tag} rollback_one_iter from 3 to 2 iterations: train and "
              f"valid scores against a 2-iteration run, largest difference "
              f"over the largest score {diffs}")
        if b3.num_trees() != 2 or max(diffs) > 1e-6:
            fail(f"{tag}: the rolled-back scores differ by {diffs}")
        pb = pickle.loads(pickle.dumps(b2))
        if not np.array_equal(pb.predict(X[:m]), b2.predict(X[:m])):
            fail(f"{tag}: the pickled Booster predicts differently")
        print(f"{tag} pickled Booster: predictions identical")
        for k, v in hk.LAUNCHES.items():
            launches_all[k] += v

    airline_small = {}
    airline = {}
    multiclass_path()
    weighted_path()
    lean_paths(ranking_path())
    boosters_path()
    constrained_path()
    api_path()
    t0 = time.perf_counter()
    slice_ms["telemetry"] = telemetry_path(dataset(63)[0], launches_all,
                                           card)
    print(f"path (q) telemetry: {time.perf_counter() - t0:.1f} s")
    print(f"elapsed after paths (m), (o), (q): "
          f"{time.perf_counter() - t_start:.1f} s")
    del datasets, Xv, yv, yv_reg
    categorical_path()
    print(f"elapsed after path (k): {time.perf_counter() - t_start:.1f} s")
    bundled_path()
    slice_ms["cli"] = cli_path(launches_all, card)
    t0 = time.perf_counter()
    slice_ms["serve"] = serve_path(X, y, launches_all, card)
    print(f"path (r) cold start and serve: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    slice_ms["online"] = online_path(X, y, launches_all, card)
    print(f"path (s) online: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    slice_ms["mesh"] = mesh_path(X, y, launches_all, card)
    print(f"path (t) mesh: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    slice_ms["pod"] = pod_path(X, y, launches_all, card)
    print(f"path (u) pod: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    slice_ms["analysis"] = analysis_path(X, y, launches_all, card)
    print(f"path (v) analysis: {time.perf_counter() - t0:.1f} s")
    for f_ in _SAVED_ROWS.values():
        os.remove(f_)
    for nm in kernels:
        kernels[nm]["launches"] = launches_all[nm]
    print(f"elapsed after paths (g)-(l): "
          f"{time.perf_counter() - t_start:.1f} s")

    # ---- 5. card vs plain versions on a small input ----
    Xs, ys = X[:4000], y_reg[:4000]
    for max_bin, fused in ((63, True), (255, False)):
        small = {"objective": "regression", "num_leaves": 31,
                 "max_bin": max_bin, "min_data_in_leaf": 20,
                 "verbosity": -1}
        hk.reset_launches()
        gpu = lt.train(small, lt.Dataset(Xs, label=ys, params=small), 1)
        took = [k for k in (FUSED if fused else UNFUSED)
                if hk.LAUNCHES[k] > 0]
        if (gpu._gbdt.gp.fused_obj is None) == fused or len(took) != 3:
            fail(f"max_bin={max_bin}: the 4000-row model did not take the "
                 f"{'fused' if fused else 'two-pass'} path "
                 f"({dict(hk.LAUNCHES)})")
        cpu_p = dict(small, device_type="cpu")
        cpu = lt.train(cpu_p, lt.Dataset(Xs, label=ys, params=cpu_p), 1)
        (a,), (b,) = gpu._host_trees(), cpu._host_trees()
        for f_ in ("split_feature", "threshold_bin", "default_left",
                   "left_child", "right_child"):
            if not np.array_equal(getattr(a, f_), getattr(b, f_)):
                fail(f"max_bin={max_bin}: card and CPU trees differ in {f_}")
        # absolute bound on the tree's scale: a leaf whose value nearly
        # cancels against the init bias would inflate a 1-ulp sum
        # difference relative
        diff = float(np.abs(a.leaf_value - b.leaf_value).max())
        scale = float(np.abs(b.leaf_value).max())
        print(f"[max_bin={max_bin}] card vs CPU (4000 rows, max bins "
              f"{gpu.train_set.max_num_bins}, first tree, {a.num_leaves} "
              f"leaves): structure identical, max leaf-value diff "
              f"{diff:.3e} (largest leaf {scale:.3e})")
        if diff > 1e-6 * scale:
            fail(f"max_bin={max_bin}: card and CPU leaf values differ by "
                 "more than 1e-6 of the largest leaf value")

    # paths (c) and (d) on exact-sum data: labels on a 1/8 grid in [0, 4)
    # and no init score, so the first tree's gradients are -label and
    # h = 1; every histogram sum is exact in any order, and the first tree
    # must equal the CPU's bit for bit
    y8 = np.clip(np.floor((Xs[:, 0] + 2.0) * 8) / 8, 0, 3.875).astype(
        np.float32)
    for path in ("f32", "lossguide"):
        for max_bin in (63, 255):
            small = {"objective": "regression", "num_leaves": 31,
                     "max_bin": max_bin, "min_data_in_leaf": 20,
                     "verbosity": -1, "boost_from_average": False,
                     **PATHS[path][1]}
            hk.reset_launches()
            gpu = lt.train(small, lt.Dataset(Xs, label=y8, params=small), 1)
            other = sum(v for k, v in hk.LAUNCHES.items()
                        if k not in ("hist_f32", "route_level", "take_small",
                                     "split_search"))
            if hk.LAUNCHES["hist_f32"] < 2 or other:
                fail(f"{path}, max_bin={max_bin}: the 4000-row model did "
                     f"not take its path ({dict(hk.LAUNCHES)})")
            cpu_p = dict(small, device_type="cpu")
            cpu = lt.train(cpu_p, lt.Dataset(Xs, label=y8, params=cpu_p), 1)
            (a,), (b,) = gpu._host_trees(), cpu._host_trees()
            for f_ in ("split_feature", "threshold_bin", "default_left",
                       "left_child", "right_child", "leaf_value",
                       "leaf_weight", "leaf_count"):
                if not np.array_equal(getattr(a, f_), getattr(b, f_)):
                    fail(f"{path}, max_bin={max_bin}: card and CPU first "
                         f"trees differ in {f_} on exact-sum data")
            print(f"[{path}, max_bin={max_bin}] card vs CPU on exact-sum "
                  f"data (4000 rows, max bins {gpu.train_set.max_num_bins},"
                  f" first tree, {a.num_leaves} leaves): identical, leaf "
                  "values included")

    # (e), GOSS, and f32 and lossguide with bagging and bynode, card vs CPU
    # on 4000 rows: the bag and feature masks equal, the first tree's
    # structure equal, leaf values within 1e-6 of the largest leaf (the
    # unquantized and GOSS ones on the exact-sum labels, where a leaf's
    # gradients are -label times its weight and both devices see the same
    # rows); then an early-stopped L2 run whose valid label is the negated
    # target, which training moves away from, stops at the same iteration
    for name_, extra, labels in (
            ("sampled", {"max_bin": 63, **SAMPLED}, ys),
            ("goss", {"max_bin": 255, **GOSS, "boost_from_average": False},
             y8),
            ("f32 sampled", {"max_bin": 255, "use_quantized_grad": "false",
                             "boost_from_average": False, **SAMPLED}, y8),
            ("lossguide sampled", {"max_bin": 255, "grow_policy": "lossguide",
                                   "boost_from_average": False, **SAMPLED},
             y8)):
        small = {"objective": "regression", "num_leaves": 31,
                 "min_data_in_leaf": 20, "verbosity": -1, **extra}
        runs = []
        for kw in ({}, {"device_type": "cpu"}):
            p_ = dict(small, **kw)
            runs.append(lt.train(p_, lt.Dataset(Xs, label=labels, params=p_),
                                 1))
        gpu, cpu = runs
        ga, ca = gpu._gbdt, cpu._gbdt
        for what, a_, b_ in (("bag mask", ga._bag, ca._bag),
                             ("feature mask", ga._fmask, ca._fmask)):
            if not torch.equal(a_.cpu(), b_):
                fail(f"{name_}: card and CPU {what}s differ")
        (a,), (b,) = gpu._host_trees(), cpu._host_trees()
        for f_ in ("split_feature", "threshold_bin", "default_left",
                   "left_child", "right_child"):
            if not np.array_equal(getattr(a, f_), getattr(b, f_)):
                fail(f"{name_}: card and CPU first trees differ in {f_}")
        diff = float(np.abs(a.leaf_value - b.leaf_value).max())
        scale = float(np.abs(b.leaf_value).max())
        print(f"[{name_}] card vs CPU (4000 rows, first tree, {a.num_leaves}"
              f" leaves, in-bag weight {float(ca._bag.sum()):g}, features "
              f"{int(ca._fmask.sum())}): masks and structure identical, max "
              f"leaf-value diff {diff:.3e} (largest leaf {scale:.3e})")
        if diff > 1e-6 * scale:
            fail(f"{name_}: card and CPU leaf values differ by more than "
                 "1e-6 of the largest leaf value")
    stops = []
    for kw in ({}, {"device_type": "cpu"}):
        p_ = {"objective": "regression", "num_leaves": 31, "max_bin": 63,
              "min_data_in_leaf": 20, "verbosity": -1, "metric": "l2",
              **SAMPLED, **kw}
        ds_s = lt.Dataset(Xs, label=ys, params=p_)
        valid = lt.Dataset(Xs[:1000], label=-ys[:1000], reference=ds_s)
        evals = {}
        bst = lt.train(p_, ds_s, num_boost_round=20, valid_sets=[valid],
                       evals_result=evals, early_stopping_rounds=3,
                       verbose_eval=False)
        stops.append((len(evals["valid_0"]["l2"]), bst.best_iteration,
                      bst.num_trees()))
    print(f"early stopping card vs CPU (iterations run, best_iteration, "
          f"trees): {stops}")
    if stops[0] != stops[1] or not stops[0][0] < 20:
        fail(f"early stopping: card {stops[0]} vs CPU {stops[1]}")

    # (g), (h) and a custom objective, card vs CPU on 4000 rows: a K = 3
    # multiclass model (its first iteration's three trees), a weighted
    # quantile model (its first tree, the renewed leaf values bit for bit:
    # residuals picked by order, not sums) and an fobj run (the L2
    # gradient as a custom function; its first tree)
    y3 = np.digitize(latent[:4000], np.quantile(latent[:4000],
                                                [1 / 3, 2 / 3])).astype(
        np.float32)

    def l2_fobj(score, ds_):
        return score - ds_.get_label(), np.ones_like(score)

    for name_, extra, labels, wts, fobj, k, took in (
            ("multiclass", {"objective": "multiclass", "num_class": 3,
                            "max_bin": 255}, y3, None, None, 3, UNFUSED),
            ("weighted quantile", {"objective": "quantile", "alpha": 0.9,
                                   "max_bin": 63}, ys, w_rows[:4000], None,
             1, ("hist_q8", "hist_routed_fused", "leaf_sums")),
            ("fobj", {"objective": "regression", "max_bin": 63}, ys, None,
             l2_fobj, 1, ("hist_q8", "hist_routed_fused", "leaf_sums"))):
        small = {"num_leaves": 31, "min_data_in_leaf": 20, "verbosity": -1,
                 **extra}
        runs = []
        for kw in ({}, {"device_type": "cpu"}):
            p_ = dict(small, **kw)
            hk.reset_launches()
            runs.append(lt.train(p_, lt.Dataset(Xs, label=labels,
                                                weight=wts, params=p_),
                                 1, fobj=fobj))
            if not kw and (min(hk.LAUNCHES[k_] for k_ in took) <= 0
                           or hk.LAUNCHES["take_small"] != k):
                fail(f"{name_}: the 4000-row model did not take its path "
                     f"({dict(hk.LAUNCHES)})")
        gpu, cpu = runs
        diff = scale = 0.0
        for a, b in zip(gpu._host_trees(), cpu._host_trees()):
            for f_ in ("split_feature", "threshold_bin", "default_left",
                       "left_child", "right_child"):
                if not np.array_equal(getattr(a, f_), getattr(b, f_)):
                    fail(f"{name_}: card and CPU first trees differ in {f_}")
            diff = max(diff, float(np.abs(a.leaf_value - b.leaf_value).max()))
            scale = max(scale, float(np.abs(b.leaf_value).max()))
        if len(gpu._host_trees()) != k:
            fail(f"{name_}: {len(gpu._host_trees())} trees, expected {k}")
        if name_ == "weighted quantile":
            (a,), (b,) = gpu._host_trees(), cpu._host_trees()
            if not np.array_equal(a.leaf_value.view(np.int64),
                                  b.leaf_value.view(np.int64)):
                fail("weighted quantile: card and CPU renewed leaf values "
                     "differ")
        print(f"[{name_}] card vs CPU (4000 rows, first iteration, {k} "
              f"tree(s), {[t.num_leaves for t in gpu._host_trees()]} "
              f"leaves): structure identical, max leaf-value diff "
              f"{diff:.3e} (largest leaf {scale:.3e})")
        if diff > 1e-6 * scale:
            fail(f"{name_}: card and CPU leaf values differ by more than "
                 "1e-6 of the largest leaf value")

    # (i) and (j), card vs CPU on about 4000 rows: a lambdarank model on
    # synth_ranking's first queries (its first tree: structure, leaf values
    # within 1e-6 of the largest); on exact-sum labels (the 1/8 grid, no
    # init score) a DART model (the same drop lists, every tree's
    # structure for 4 iterations) and an RF model (the same bag masks and
    # first tree); a refit of a card-trained binary model, on the card and
    # on the CPU, leaf values within 1e-6 of the largest
    (Xr4, yr4, gr4), _ = split_queries(*synth_ranking(4400, F_RANK, seed=3),
                                       4000)

    def same_trees(name_, ta, tb, tol=1e-6):
        diff = scale = 0.0
        if len(ta) != len(tb):
            fail(f"{name_}: {len(ta)} trees on the card, {len(tb)} on the CPU")
        for a, b in zip(ta, tb):
            for f_ in ("split_feature", "threshold_bin", "default_left",
                       "left_child", "right_child"):
                if not np.array_equal(getattr(a, f_), getattr(b, f_)):
                    fail(f"{name_}: card and CPU trees differ in {f_}")
            diff = max(diff, float(np.abs(a.leaf_value - b.leaf_value).max()))
            scale = max(scale, float(np.abs(b.leaf_value).max()))
        if diff > tol * scale:
            fail(f"{name_}: card and CPU leaf values differ by {diff:.3e}, "
                 f"more than {tol:g} of the largest leaf value {scale:.3e}")
        return diff, scale

    for name_, extra, data_, rounds, check_all in (
            ("lambdarank", {"objective": "lambdarank", "max_bin": 63},
             (Xr4, yr4, gr4), 1, True),
            ("dart", {"objective": "regression", "max_bin": 63,
                      "boosting": "dart", "skip_drop": 0.0,
                      "boost_from_average": False}, (Xs, y8, None), 4, True),
            ("rf", {"objective": "regression", "max_bin": 63, **RF},
             (Xs, y8, None), 2, False)):
        small = {"num_leaves": 31, "min_data_in_leaf": 20, "verbosity": -1,
                 **extra}
        runs, drop_lists = [], []
        for kw in ({}, {"device_type": "cpu"}):
            p_ = dict(small, **kw)
            Xd, yd, gd = data_
            b_ = lt.Booster(params=p_, train_set=lt.Dataset(
                Xd, label=yd, group=gd, params=p_))
            dl = []
            for _ in range(rounds):
                b_.update()
                dl.append(list(getattr(b_._gbdt, "drop_idx", [])))
            runs.append(b_)
            drop_lists.append(dl)
        gpu, cpu = runs
        if drop_lists[0] != drop_lists[1]:
            fail(f"{name_}: card drop lists {drop_lists[0]} != CPU "
                 f"{drop_lists[1]}")
        if name_ == "rf" and not torch.equal(gpu._gbdt._bag.cpu(),
                                             cpu._gbdt._bag):
            fail("rf: card and CPU bag masks differ")
        ta, tb = gpu._host_trees(), cpu._host_trees()
        diff, scale = same_trees(name_, ta if check_all else ta[:1],
                                 tb if check_all else tb[:1])
        print(f"[{name_}] card vs CPU ({len(yd)} rows, {rounds} iteration(s),"
              f" drop lists {drop_lists[0]}, trees compared "
              f"{len(ta) if check_all else 1}, leaves "
              f"{[t.num_leaves for t in ta]}): structure identical, max "
              f"leaf-value diff {diff:.3e} (largest leaf {scale:.3e})")
    ys8 = (ys > np.median(ys)).astype(np.float32)
    small = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
             "min_data_in_leaf": 20, "verbosity": -1}
    model = lt.train(small, lt.Dataset(Xs, label=ys8, params=small), 2)
    r_gpu = model.refit(Xs, ys8, decay_rate=0.9)
    r_cpu = lt.Booster(model_str=model.model_to_string(),
                       params=dict(small, device_type="cpu")).refit(
                           Xs, ys8, decay_rate=0.9)
    diff, scale = same_trees("refit", r_gpu._host_trees(),
                             r_cpu._host_trees())
    print(f"[refit] card vs CPU (4000 rows, 2 trees): max leaf-value diff "
          f"{diff:.3e} (largest leaf {scale:.3e})")

    # (k), card vs CPU on 4000 airline rows with its six categorical
    # columns: an L2 model on exact-sum labels (the latent score on a 1/8
    # grid, no init score) on the fused quantized path (F * B = 2048), the
    # unquantized depthwise grower and lossguide; the first tree's
    # structure and categories equal, leaf values within 1e-6 of the
    # largest (quantized) or bit for bit
    xa4 = airline_small["X"]
    ya8 = np.clip(np.floor(airline_small["latent"] * 8) / 8, -4.0,
                  3.875).astype(np.float32)
    for name_, extra, own in (
            ("categorical quantized", {}, FUSED),
            ("categorical f32", {"use_quantized_grad": "false"},
             ("hist_f32", "route_level")),
            ("categorical lossguide", {"grow_policy": "lossguide"},
             ("hist_f32",))):
        small = {"objective": "regression", "num_leaves": 31,
                 "max_bin": 255, "min_data_in_leaf": 20, "verbosity": -1,
                 "boost_from_average": False, **extra}
        runs = []
        for kw in ({}, {"device_type": "cpu"}):
            p_ = dict(small, **kw)
            hk.reset_launches()
            runs.append(lt.train(p_, lt.Dataset(
                xa4, label=ya8, categorical_feature=AIRLINE_CATS,
                params=p_), 1))
            if not kw and min(hk.LAUNCHES[k_] for k_ in own) <= 0:
                fail(f"{name_}: the 4000-row model did not take its path "
                     f"({dict(hk.LAUNCHES)})")
        gpu, cpu = runs
        (a,), (b,) = gpu._host_trees(), cpu._host_trees()
        for f_ in ("split_feature", "threshold_bin", "default_left",
                   "left_child", "right_child", "is_cat_node"):
            if not np.array_equal(getattr(a, f_), getattr(b, f_)):
                fail(f"{name_}: card and CPU first trees differ in {f_}")
        if not all(np.array_equal(x_, y_)
                   for x_, y_ in zip(a.cat_sets, b.cat_sets)):
            fail(f"{name_}: card and CPU first trees' categories differ")
        if not b.is_cat_node.any():
            fail(f"{name_}: no categorical node in the first tree")
        diff = float(np.abs(a.leaf_value - b.leaf_value).max())
        scale = float(np.abs(b.leaf_value).max())
        if (diff > 1e-6 * scale if gpu._gbdt.gp.quant else diff != 0.0):
            fail(f"{name_}: card and CPU leaf values differ by {diff}")
        print(f"[{name_}] card vs CPU (4000 rows, first tree, {a.num_leaves}"
              f" leaves, {int(a.is_cat_node.sum())} categorical nodes): "
              f"structure and categories identical, max leaf-value diff "
              f"{diff:.3e} (largest leaf {scale:.3e})")

    # (l), card vs CPU on the same 4000 airline rows one-hot encoded (a CSR
    # matrix, and the same rows as a dense array, which bundle alike): an
    # L2 model on the exact-sum labels above on the quantized depthwise
    # path (its front from F_b * B), unquantized and lossguide; the first
    # tree's structure equal to the CPU run's on the CSR rows, leaf values
    # within 1e-6 of the largest (quantized) or bit for bit; the dense
    # rows' model text equal to the CSR rows' on the card
    csr4 = airline_onehot(xa4)
    for name_, extra in (("bundled quantized", {}),
                         ("bundled f32", {"use_quantized_grad": "false"}),
                         ("bundled lossguide", {"grow_policy": "lossguide"})):
        small = {"objective": "regression", "num_leaves": 31,
                 "max_bin": 255, "min_data_in_leaf": 20, "verbosity": -1,
                 "boost_from_average": False, **extra}
        runs = {}
        for what, data, kw in (("card", csr4, {}),
                               ("card dense", csr4.toarray(), {}),
                               ("cpu", csr4, {"device_type": "cpu"})):
            p_ = dict(small, **kw)
            runs[what] = lt.train(p_, lt.Dataset(data, label=ya8, params=p_),
                                  1)
        gpu, cpu = runs["card"], runs["cpu"]
        ts_ = gpu.train_set
        if ts_.bundle_meta is None:
            fail(f"{name_}: the 4000 one-hot rows did not bundle")
        if runs["card dense"].model_to_string() != gpu.model_to_string():
            fail(f"{name_}: dense and CSR rows train different models")
        (a,), (b,) = gpu._host_trees(), cpu._host_trees()
        for f_ in ("split_feature", "threshold_bin", "default_left",
                   "left_child", "right_child", "is_cat_node"):
            if not np.array_equal(getattr(a, f_), getattr(b, f_)):
                fail(f"{name_}: card and CPU first trees differ in {f_}")
        diff = float(np.abs(a.leaf_value - b.leaf_value).max())
        scale = float(np.abs(b.leaf_value).max())
        if (diff > 1e-6 * scale if gpu._gbdt.gp.quant else diff != 0.0):
            fail(f"{name_}: card and CPU leaf values differ by {diff}")
        fb4 = ts_.num_features * padded_bins(ts_.max_num_bins)
        print(f"[{name_}] card vs CPU (4000 rows, F_b {ts_.num_features}, "
              f"F_b * B {fb4}, first tree {a.num_leaves} leaves): structure "
              f"identical, max leaf-value diff {diff:.3e} (largest leaf "
              f"{scale:.3e}); dense rows train the CSR rows' model")

    # (m), (m'), (m''), card vs CPU on 4000 rows of exact-sum labels (the
    # generator's logit on a 1/8 grid, no init score): three trees each
    # with the CPU run's structure, leaf values within 1e-6 of the largest
    # (lossguide: the first tree bit for bit, the later ones within 2^-17),
    # each path's own kernels launched; and
    # the extra_trees draws of (m)'s levels equal the CPU's bit for bit
    from lightgbm_tpu_torch.ops.grow import extra_trees_key
    ym8, cases = constrained_parity_cases(Xs, w_gen)
    for name_, small, ds_extra, own in cases:
        runs = []
        for kw in ({}, {"device_type": "cpu"}):
            p_ = dict(small, **kw)
            hk.reset_launches()
            runs.append(lt.train(p_, lt.Dataset(
                Xs, label=ym8, params=dict(p_, **ds_extra)), 3))
            if not kw and min(hk.LAUNCHES[k_] for k_ in own) <= 0:
                fail(f"{name_}: the 4000-row model did not take its path "
                     f"({dict(hk.LAUNCHES)})")
        gpu, cpu = runs
        if name_ == "constrained (m)":
            sp_m = gpu._gbdt.gp.split
        ta, tb = gpu._host_trees(), cpu._host_trees()
        # unquantized, the first tree's sums are exact; later gradients
        # are off the grid, and the f32 histograms' atomics add them in
        # another order on each launch. scripts/torch_constrained_parity.py
        # reads the card's spread on this model at up to 1.08e-6 of the
        # largest leaf, and one row left out of an unclamped leaf moves
        # that leaf by at least 1.95e-5 of it: 2^-17 (7.6e-6) lies between
        quant = gpu._gbdt.gp.quant
        diff, scale = same_trees(name_, ta, tb, 1e-6 if quant else 2 ** -17)
        if not quant and not np.array_equal(ta[0].leaf_value,
                                            tb[0].leaf_value):
            fail(f"{name_}: card and CPU first-tree leaf values differ")
        print(f"[{name_}] card vs CPU (4000 rows, 3 trees, leaves "
              f"{[t.num_leaves for t in ta]}): structure identical, max "
              f"leaf-value diff {diff:.3e} (largest leaf {scale:.3e})")
    # (n), (n'), (n''), card vs CPU on the same 4000 rows of exact-sum
    # labels: the lean grower (tiles of 5 of 28 columns, so offsets 5 to
    # 25) quantized and not, and the pooled leaf-wise grower (4 of 31
    # leaves cached); three trees each with the CPU run's structure, leaf
    # values within 1e-6 of the largest (quantized) or the first tree bit
    # for bit and the later ones within 2^-17, each path's kernels launched
    lean_mb = (5 * 30 * 3 * B * 4 + 1) / 2.0 ** 20
    pool_mb = (4 * 3 * F * B * 4 + 1) / 2.0 ** 20
    for name_, extra, own in (
            ("lean (n)", {"histogram_pool_size": lean_mb},
             ("hist_q8", "route_level", "leaf_sums")),
            ("lean f32 (n')", {"histogram_pool_size": lean_mb,
                               "use_quantized_grad": False},
             ("hist_f32", "route_level", "leaf_sums")),
            ("pooled (n'')", {"histogram_pool_size": pool_mb,
                              "grow_policy": "lossguide"}, ("hist_f32",))):
        runs = []
        for kw in ({}, {"device_type": "cpu"}):
            p_ = {"objective": "regression", "num_leaves": 31,
                  "max_bin": 63, "min_data_in_leaf": 20, "verbosity": -1,
                  "boost_from_average": False, **extra, **kw}
            hk.reset_launches()
            runs.append(lt.train(p_, lt.Dataset(Xs, label=ym8, params=p_),
                                 3))
            if not kw and (min(hk.LAUNCHES[k_] for k_ in own) <= 0
                           or hk.LAUNCHES["hist_routed_fused"]):
                fail(f"{name_}: the 4000-row model did not take its path "
                     f"({dict(hk.LAUNCHES)})")
        gpu, cpu = runs
        gp_ = gpu._gbdt.gp
        if (gp_.lean_ft, gp_.hist_pool) != ((0, 4) if "pooled" in name_
                                            else (5, 0)):
            fail(f"{name_}: lean_ft {gp_.lean_ft}, pool {gp_.hist_pool}")
        ta, tb = gpu._host_trees(), cpu._host_trees()
        diff, scale = same_trees(name_, ta, tb,
                                 1e-6 if gp_.quant else 2 ** -17)
        if not gp_.quant and not np.array_equal(ta[0].leaf_value,
                                                tb[0].leaf_value):
            fail(f"{name_}: card and CPU first-tree leaf values differ")
        print(f"[{name_}] card vs CPU (4000 rows, 3 trees, leaves "
              f"{[t.num_leaves for t in ta]}, rebuilds "
              f"{gpu._gbdt.hist_rebuilds}): structure identical, max "
              f"leaf-value diff {diff:.3e} (largest leaf {scale:.3e})")
    for q_ in range(5):
        for lvl in range(10):
            key = extra_trees_key(sp_m, q_, lvl)
            a_ = threefry.uniform(key, (L, F), dev).cpu()
            b_ = threefry.uniform(key, (L, F), "cpu")
            if not torch.equal(a_.view(torch.int32), b_.view(torch.int32)):
                fail(f"extra_trees draws of tree {q_}, level {lvl} differ "
                     "on the card and the CPU")
    print(f"extra_trees draws ([{L}, {F}] uniforms of 5 trees x 10 levels): "
          "card and CPU identical")

    # the replica's uniforms: card and CPU bit for bit at N rows
    key = threefry.fold_in(threefry.prng_key(3), 1)
    u_card = threefry.uniform(key, (N,), dev).cpu()
    u_host = threefry.uniform(key, (N,), "cpu")
    if not torch.equal(u_card.view(torch.int32), u_host.view(torch.int32)):
        fail("threefry: card and CPU uniforms differ")
    print(f"threefry: card and CPU uniforms identical at N = {N} "
          f"(mean {float(u_card.mean()):.6f})")
    print(f"sampling draws (CUDA events, ms): {sampling}")
    print(f"slice times (CUDA events, ms): {slice_ms}")
    print(f"elapsed: {time.perf_counter() - t_start:.1f} s")

    print(f"card: {card}")
    print(json.dumps({"kernels": [dict(name=nm, **v)
                                  for nm, v in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
